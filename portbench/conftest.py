"""The tiny root's cut of `pm25sub-m100`, beside the accepted ones of
`portbench/tests/conftest.TINY_CONFIG`: one batch an epoch (the CPU check
steps need it), six outputs of unequal lengths.  pytest loads this file
before any test module under `portbench/`, so every run, of one test file
or of the whole directory, makes its tiny root with the cut."""

from portbench.tests import conftest

conftest.TINY_CONFIG.setdefault("pm25sub-m100", dict(
    M=6, B=60, data={"generator": "sine", "lengths": [13, 9, 11, 9, 9, 9], "period": 3.0,
                     "x_max": 60.0}))

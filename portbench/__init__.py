"""The benchmark of the PyTorch/CUDA port on one NVIDIA H100.

One command runs one cell (a configuration under a traffic mix) once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the repository root names the cells, their metrics and
their bounds; every configuration, traffic mix and per-layer metric is a
file of its own here, found by its name.  Nothing in this package imports
JAX or the JAX package; `reference/` imports nothing of the port either.
"""

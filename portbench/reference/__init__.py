"""Plain references the benchmark holds the port's outputs against.

Plain PyTorch written from the model's equations (the reference study's
`code/nmgp_dsvi.py` and `code/SIM_code/logpos.py`): no kernel, no cache,
no import of the port or of JAX.  They run in float64 on the card after a
run's measured window, and take only what the benchmark itself made: the
data, the starting weights and the draws.
"""

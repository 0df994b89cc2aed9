"""Seconds this process spent capturing the DSVI trainer's CUDA graphs, its
warmup steps included: the port's counter `dsvi.capture_s` (None where
nothing was captured, as on the CPU)."""

from portbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "dsvi_train":
        return None
    return spans.counter("dsvi.capture_s")

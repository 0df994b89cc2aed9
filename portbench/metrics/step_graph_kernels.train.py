"""Kernels a DSVI step launches, from the port's own counters: the kernel
nodes of the trainer's step graph (`dsvi.step_graph_kernels`, added at each
capture) over the captures (`dsvi.captures`).  None where nothing was
captured (the CPU) or the port keeps no such counter."""

from portbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "dsvi_train":
        return None
    kernels, captures = spans.counter("dsvi.step_graph_kernels"), spans.counter("dsvi.captures")
    if not kernels or not captures:
        return None
    return kernels / captures

"""Host time a DSVI step in the traced slice, from the port's own spans: the
mean duration of `dsvi.step` (one replay of the step's CUDA graph and its
launch count; an eager step off the card)."""

from portbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "dsvi_train":
        return None
    return spans.mean_ms(ctx, "dsvi.step")

"""Host time a chunk of draws in the traced slice, from the port's own
spans: the mean duration of `predict.chunk` (the host's time to draw the
noise of `draws_per_chunk` draws and enqueue their work)."""

from portbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "dsvi_serve":
        return None
    return spans.mean_ms(ctx, "predict.chunk")

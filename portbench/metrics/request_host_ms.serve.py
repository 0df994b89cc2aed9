"""Host time a request in the traced slice, from the port's own spans: the
mean duration of `predict.request` (a `predict_Y` or `sample_Y` call, from
the call to its return, the result still on the card)."""

from portbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "dsvi_serve":
        return None
    return spans.mean_ms(ctx, "predict.request")

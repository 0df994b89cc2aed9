"""Host time a request in the traced slice: the slice's wall time less the
device's busy time, over the requests it served."""


def read(ctx):
    if ctx["traffic"]["kind"] != "dsvi_serve" or not ctx["units"]:
        return None
    sl = ctx["slice"]
    return 1e3 * (sl.window_s - sl.busy_s) / len(ctx["units"])

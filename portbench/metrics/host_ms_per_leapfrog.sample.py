"""Host time a leapfrog in the traced slice: the slice's wall time less the
device's busy time, over the leapfrogs the sampler ran in it."""


def read(ctx):
    leapfrogs = sum(u.get("leapfrogs", 0) for u in ctx["units"])
    if ctx["traffic"]["kind"] != "chees_sample" or not leapfrogs:
        return None
    sl = ctx["slice"]
    return 1e3 * (sl.window_s - sl.busy_s) / leapfrogs

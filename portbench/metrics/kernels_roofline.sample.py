"""The log-density gradient's kernels against their roofline: the least
time of a gradient's kernel calls (`work.svc_gradient` at the cell's
chains), times the leapfrogs of the traced slice, over the device's busy
time in the slice."""

from portbench import work


def read(ctx):
    leapfrogs = sum(u.get("leapfrogs", 0) for u in ctx["units"])
    if ctx["traffic"]["kind"] != "chees_sample" or not leapfrogs or not ctx["slice"].busy_s:
        return None
    c = ctx["config"]
    _, least = work.total(work.svc_gradient(ctx["traffic"]["chains"], c["N"], c["outputs"]))
    return 100.0 * least * leapfrogs / ctx["slice"].busy_s

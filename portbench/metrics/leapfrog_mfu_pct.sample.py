"""Share of the dense TF32 peak that the log-density gradients' kernel work
reaches over the traced slice: the operations of `work.svc_gradient` at the
cell's chains, times the leapfrogs of the slice, over its wall time."""

from portbench import work


def read(ctx):
    leapfrogs = sum(u.get("leapfrogs", 0) for u in ctx["units"])
    if ctx["traffic"]["kind"] != "chees_sample" or not leapfrogs:
        return None
    c = ctx["config"]
    ops, _ = work.total(work.svc_gradient(ctx["traffic"]["chains"], c["N"], c["outputs"]))
    return 100.0 * ops * leapfrogs / ctx["slice"].window_s / work.PEAK_TF32_PER_S

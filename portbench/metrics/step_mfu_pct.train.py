"""Share of the dense TF32 peak that a DSVI step's kernel work reaches over
the traced slice: the operations of `work.dsvi_step` at the configuration's
widths, times the steps the slice completed, over the slice's wall time."""

from portbench import work


def read(ctx):
    steps = sum(u.get("steps", 0) for u in ctx["units"])
    if ctx["traffic"]["kind"] != "dsvi_train" or not steps:
        return None
    c = ctx["config"]
    ops, _ = work.total(work.dsvi_step(c["D"], c["M"], c["B"]))
    return 100.0 * ops * steps / ctx["slice"].window_s / work.PEAK_TF32_PER_S

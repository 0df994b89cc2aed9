"""The DSVI step's kernels against their roofline: the least time of the
step's kernel calls (`work.dsvi_step`, each the larger of its bytes over the
HBM rate and its operations over the dense TF32 rate), times the steps the
traced slice completed, over the device's busy time in the slice."""

from portbench import work


def read(ctx):
    steps = sum(u.get("steps", 0) for u in ctx["units"])
    if ctx["traffic"]["kind"] != "dsvi_train" or not steps or not ctx["slice"].busy_s:
        return None
    c = ctx["config"]
    _, least = work.total(work.dsvi_step(c["D"], c["M"], c["B"]))
    return 100.0 * least * steps / ctx["slice"].busy_s

"""The served requests' kernels against their roofline: the least time of
each request's kernel calls (`work.request`, each call the larger of its
bytes over the HBM rate and its operations over the dense TF32 rate),
summed over the traced slice's requests, over the device's busy time in
the slice."""

from portbench import work


def read(ctx):
    if ctx["traffic"]["kind"] != "dsvi_serve" or not ctx["units"] or not ctx["slice"].busy_s:
        return None
    least = sum(work.request(ctx["config"], ctx["traffic"], u)[1] for u in ctx["units"])
    return 100.0 * least / ctx["slice"].busy_s

"""The quadform backward against its roofline: the least time of a DSVI
step's backward at its three group sets (offdiagonal, diagonal, latent
functions), times the steps the traced slice completed, over the device
time of whichever backward kernels ran, found by name among the slice's top
device operations: the fused `quadform_diag_bwd*` kernels, or the pair
`quadform_diag_dw*` and `quadform_diag_da*`.  So it reads the same work
whatever implements it.  None where no such kernel is among them.

The least work is that of the function, not of one way to split it: C once
(`work.quadform_dw` and `work.quadform_da` each count it), then the
products of dW and dA; A, vbar and W's triangle read once, dA and dW's
triangle written once.  A backward kernel outside the slice's top
operations (the fused kernel's summing pass where N takes several clusters
a group) is not in the device time, which overstates the share by that
kernel's part."""

from portbench import work

KERNELS = ("quadform_diag_bwd", "quadform_diag_dw", "quadform_diag_da")


def backward(G, M, N):
    """(operations, bytes) of the backward of one quadform call."""
    c_once = G * N * M * (M + 1)
    ops = work.quadform_dw(G, M, N)[0] + work.quadform_da(G, M, N)[0] - c_once
    return ops, work.F32 * (2 * M * N + G * N + G * M * (M + 1))


def read(ctx):
    steps = sum(u.get("steps", 0) for u in ctx["units"])
    if ctx["traffic"]["kind"] != "dsvi_train" or not steps:
        return None
    busy = sum(s for name, s in ctx["slice"].device_ops if any(k in name for k in KERNELS))
    if not busy:
        return None
    c = ctx["config"]
    D, M, B = c["D"], c["M"], c["B"]
    groups = (*work._groups(D), D)  # as work.dsvi_step lists them
    return 100.0 * work.total([backward(G, M, B) for G in groups])[1] * steps / busy

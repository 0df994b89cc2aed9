"""Host time a leapfrog in the traced slice, from the port's own spans: the
mean duration of `hmc.leapfrog` (half kick, drift, gradient, half kick)."""

from portbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "chees_sample":
        return None
    return spans.mean_ms(ctx, "hmc.leapfrog")

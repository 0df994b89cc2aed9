"""Share of the dense TF32 peak that the served requests' kernel work
reaches over the traced slice: each request's operations (`work.request`:
`work.posterior_mean` for `predict_Y`, `work.predictive_draw` times the
draws for `sample_Y`, at its B) summed over the slice's requests, over its
wall time."""

from portbench import work


def read(ctx):
    if ctx["traffic"]["kind"] != "dsvi_serve" or not ctx["units"]:
        return None
    ops = sum(work.request(ctx["config"], ctx["traffic"], u)[0] for u in ctx["units"])
    return 100.0 * ops / ctx["slice"].window_s / work.PEAK_TF32_PER_S

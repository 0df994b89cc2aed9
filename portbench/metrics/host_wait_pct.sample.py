"""Share of the traced slice the sampler's host waits for the card, from the
port's own spans: the summed durations of `chees.steps_read` (each
iteration's host read of its step count) over the slice's length."""

from portbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "chees_sample" or not ctx["slice"].window_s:
        return None
    found = spans.slice_spans(ctx, "chees.steps_read")
    if not found:
        return None
    return 100.0 * 1e-9 * sum(s.duration_ns for s in found) / ctx["slice"].window_s

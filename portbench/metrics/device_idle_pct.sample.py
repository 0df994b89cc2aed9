"""Share of the traced slice of ChEES iterations in which no operation ran on the card."""


def read(ctx):
    if ctx["traffic"]["kind"] != "chees_sample" or not ctx["slice"].window_s:
        return None
    return 100.0 * (1.0 - ctx["slice"].busy_s / ctx["slice"].window_s)

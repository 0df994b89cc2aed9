"""Share of the traced slice of DSVI epochs in which no operation ran on the card."""


def read(ctx):
    if ctx["traffic"]["kind"] != "dsvi_train" or not ctx["slice"].window_s:
        return None
    return 100.0 * (1.0 - ctx["slice"].busy_s / ctx["slice"].window_s)

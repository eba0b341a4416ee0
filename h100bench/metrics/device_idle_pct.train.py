"""Share of the traced window in which no operation ran on the device."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

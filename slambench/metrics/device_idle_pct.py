"""Share of the traced sub-window in which no operation ran on the card:
one minus the union of the device operations' intervals over the
sub-window's length."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

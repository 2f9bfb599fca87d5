"""The device's idle share of the traced window of query batches: 100 x (1 -
the union of its busy intervals / the window)."""


def read(ctx):
    if ctx.profile is None or ctx.traffic["driver"] != "closed_batches":
        return None
    return 100.0 * (1.0 - ctx.profile["busy_us"] / ctx.profile["window_us"])

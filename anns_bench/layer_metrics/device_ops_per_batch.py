"""Device operations (kernels, copies, fills) in the traced window over its
batches: the host's dispatch load a batch."""


def read(ctx):
    if ctx.profile is None or ctx.traffic["driver"] != "closed_batches":
        return None
    return len(ctx.profile["device"]) / ctx.window["units"]

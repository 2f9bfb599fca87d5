"""Real (unpadded) queries answered in the window over its seconds."""


def read(ctx):
    if ctx.traffic["driver"] != "closed_batches":
        return None
    return ctx.window["work"] / ctx.window["seconds"]

"""``torch.cuda.max_memory_allocated()`` over the set-up's build and the
window, in GiB; the peak is reset once the corpus and queries are drawn."""


def read(ctx):
    peak = ctx.window.get("peak_bytes")
    return None if peak is None else peak / float(1 << 30)

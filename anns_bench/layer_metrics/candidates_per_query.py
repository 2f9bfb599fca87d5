"""The mean ``candidate_count`` the searcher returned over the real rows of
the window's batches: the work the query-aware threshold admits."""


def read(ctx):
    if ctx.traffic["driver"] != "closed_batches" or "cand_total" not in ctx.window:
        return None
    return ctx.window["cand_total"] / ctx.window["work"]

"""The sort activation kernel's share of its roofline in the traced window
(:func:`anns_bench.rooflines.share`); nothing where the trace holds none of
its functions (a program whose activation is not that kernel)."""
from anns_bench.rooflines import share


def read(ctx):
    return share(ctx, "activation")

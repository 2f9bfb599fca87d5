"""``schist``'s share of its roofline in the traced window
(:func:`anns_bench.rooflines.share`)."""
from anns_bench.rooflines import share


def read(ctx):
    return share(ctx, "schist")

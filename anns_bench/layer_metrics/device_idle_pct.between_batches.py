"""The device's idle share of the traced window that falls between batches:
100 x the idle gaps that begin while the host is in ``searcher.to_host`` or
in no ``searcher.batch``, over the window (:func:`anns_bench.stages.
between_batches_us`). A part of ``device_idle_pct.query``."""
from anns_bench.stages import between_batches_us


def read(ctx):
    if ctx.profile is None or ctx.traffic["driver"] != "closed_batches":
        return None
    idle_us = between_batches_us(ctx.profile)
    if idle_us is None:
        return None
    return 100.0 * idle_us / ctx.profile["window_us"]

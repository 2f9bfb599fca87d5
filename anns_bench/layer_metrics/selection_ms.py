"""Device milliseconds a batch in the selection: the SC-level histogram and
Alg. 5's threshold, and on gather the compaction
(``taco_stage_seconds_total{stage="taco.select"}`` over
``taco_stage_batches_total``; :func:`anns_bench.stages.stage_ms`)."""
from anns_bench.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "taco.select")

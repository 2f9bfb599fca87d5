"""Device milliseconds a batch in the sort activation: the program's
``taco_stage_seconds_total{stage="taco.activation"}`` over its
``taco_stage_batches_total`` (:func:`anns_bench.stages.stage_ms`)."""
from anns_bench.stages import stage_ms


def read(ctx):
    return stage_ms(ctx, "taco.activation")

"""The serving import path of the bucket helpers (mirrors
``repro.serving.batching``): they live in :mod:`repro_torch.batching`, which
the searcher imports without loading the serving package. The LM side's
``LM_PROMPT_BUCKETS`` comes with the LM port."""
from repro_torch.batching import ANN_BATCH_BUCKETS, bucket_size, pad_rows

__all__ = ["ANN_BATCH_BUCKETS", "bucket_size", "pad_rows"]

"""Serving of the port (mirrors ``repro.serving``): the request paths over
this repo's two workloads.

:class:`ServingEngine` (:mod:`repro_torch.serving.engine`) serves LM
decode: slot-based continuous batching over a fixed pool of decode slots;
each prompt is prefilled on its own (causal self-attention through the
flash kernel on the card) and finished slots refill from the queue.

:class:`AnnServingEngine` (:mod:`repro_torch.serving.ann_engine`) serves
TaCo k-ANNS (paper Alg. 6): it micro-batches a stream of
:class:`AnnRequest`\\ s into padded shape buckets, one cached query
function per ``(bucket, k, cfg)``; per-request ``k``/``beta``/``rerank``
overrides; an optional LRU result cache; telemetry (p50/p99 latency, QPS,
truncation rate, compile counts, cache hits/misses). Execution goes through
an :class:`AnnBackend`, a thin adapter over a
:class:`repro_torch.ann.Searcher`. Live-index lifecycle: ``swap_index()``
atomically replaces the served index under a monotonic
``index_generation``; ``recall_probe_every=N`` reports live recall@k; a
:class:`repro_torch.ann.MutableAnnIndex` plugs in for insert/delete/
compaction churn. ``submit()`` returns an :class:`AnnFuture`,
``async_mode=True`` runs a background drain worker with deadline-aware
batch close and admission control (:class:`AdmissionError`), and
maintenance work (compaction, recall probes, the write-ahead log's group
commit) runs on a shared :class:`WorkerPool`
(:mod:`repro_torch.serving.scheduler`).
"""
from repro_torch.serving.ann_engine import (
    AdmissionError,
    AnnBackend,
    AnnBatchResult,
    AnnFuture,
    AnnRequest,
    AnnResult,
    AnnServingEngine,
    ShardedAnnBackend,
    SingleDeviceAnnBackend,
)
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.scheduler import WorkerPool, WorkTask, get_shared_pool

__all__ = [
    "AdmissionError",
    "AnnBackend",
    "AnnBatchResult",
    "AnnFuture",
    "AnnRequest",
    "AnnResult",
    "AnnServingEngine",
    "Request",
    "ServingEngine",
    "ShardedAnnBackend",
    "SingleDeviceAnnBackend",
    "WorkTask",
    "WorkerPool",
    "get_shared_pool",
]

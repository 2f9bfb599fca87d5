"""Serving of the port: for now only the shared background
:class:`WorkerPool` (:mod:`repro_torch.serving.scheduler`) that the
write-ahead log's group commit and background compaction run on. The
serving engine is the next slice of the port (``ROADMAP.md``).
"""
from repro_torch.serving.scheduler import WorkerPool, WorkTask, get_shared_pool

__all__ = ["WorkTask", "WorkerPool", "get_shared_pool"]

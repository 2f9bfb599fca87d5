"""repro_torch.ann — the ANN lifecycle facade of the port (mirrors
``repro.ann``)::

    index = AnnIndex.build(data, cfg)      # on the card by default
    index.save(path); AnnIndex.load(path)  # the reference's directory format
    index.searcher()                       # owns the (bucket, k, cfg) cache
    index.searcher("sharded", shards=4)    # single | sharded | auto
    index.engine(...)                      # AnnServingEngine over a Searcher

Mutation rides the same facade (:mod:`repro_torch.ann.mutable` /
:mod:`repro_torch.ann.compaction`)::

    mutable = index.mutable()              # delta segment + tombstones
    ids = mutable.insert(vectors); mutable.delete(ids[:2])
    mutable.maybe_compact(engine=engine)   # policy-driven rebuild + atomic
                                           #   swap on a live engine
    mutable.save(path)                     # ONE-commit base+delta+tombstones

Durability (:mod:`repro_torch.ann.wal`)::

    mutable = index.mutable(durability="sync", wal_dir=wal)  # crash-safe
    MutableAnnIndex.load(path, wal_dir=wal)  # snapshot + WAL replay
"""
from repro_torch.ann.index import AnnIndex
from repro_torch.ann.persistence import (
    load_index,
    load_mutable_index,
    save_index,
    save_mutable_index,
)
from repro_torch.ann.searcher import (
    AnnBatchResult,
    Searcher,
    ShardedSearcher,
    SingleDeviceSearcher,
    make_searcher,
)
from repro_torch.ann.compaction import CompactionPolicy, CompactionReport
from repro_torch.ann.mutable import MutableAnnIndex, MutableSearcher
from repro_torch.ann.wal import FaultInjectingFile, WalRecord, WriteAheadLog, read_wal

__all__ = [
    "AnnBatchResult",
    "AnnIndex",
    "CompactionPolicy",
    "CompactionReport",
    "FaultInjectingFile",
    "MutableAnnIndex",
    "MutableSearcher",
    "Searcher",
    "ShardedSearcher",
    "SingleDeviceSearcher",
    "WalRecord",
    "WriteAheadLog",
    "load_index",
    "load_mutable_index",
    "make_searcher",
    "read_wal",
    "save_index",
    "save_mutable_index",
]

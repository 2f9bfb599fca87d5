"""Index persistence: ``SCIndex`` + ``SCConfig`` in the on-disk format of
``repro.ann.persistence``, so an index saved by either package loads in the
other bit for bit.

Layout of ``save_index(index, cfg, path)``::

    path/
      step_0/          # the index's leaves (repro_torch.checkpoint)
        arrays.npz     #   transform, dim_perm, IMI subspaces, data,
        manifest.json  #   data_norms; path/dtype/shape-checked on load.
                       #   "extra" carries the meta: format tag, version,
                       #   SCConfig and the structure (n, d, sub_dims and
                       #   which optional leaves exist), so config and
                       #   arrays commit in one atomic rename.
      ann_index.json   # human-readable mirror of that meta, never read

The leaf order and path strings are those JAX gives the reference's
``SCIndex`` pytree (field number, then tuple position or field number):
``transform`` is field 0 (``mean``, ``basis``, ``eigvals``), ``dim_perm``
field 1, the ``subspaces`` tuple field 2, ``data`` field 3 and
``data_norms`` field 4. An absent optional leaf is skipped and keeps its
number free.

A mutable index (:func:`save_mutable_index`) is one checkpoint in the
reference's ``MUTABLE_FORMAT``: the leaves of the reference's dict pytree
in its sorted key order — the base index's leaves under ``['base']`` (when
there is a base), then ``['base_ids']``, ``['delta']``, ``['delta_ids']``,
``['delta_live']`` and ``['tombstones']`` — with the config, id counters,
structure and the write-ahead log's (segment, LSN) watermark in the
manifest, so the whole mid-churn state commits in one rename and either
package loads the other's saves.
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch

from repro_torch.checkpoint import read_manifest, restore_leaves, save_leaves
from repro_torch.core.config import SCConfig
from repro_torch.core.imi import IMISubspace, split_halves
from repro_torch.core.taco import SCIndex
from repro_torch.core.transform import SubspaceTransform
from repro_torch.utils import resolve_device

#: the index is stored as checkpoint step 0 (an index has no training step)
INDEX_STEP = 0
FORMAT = "taco-ann-index"
FORMAT_VERSION = 1
#: a mutable index save: base SCIndex + delta segment + tombstones + id maps
#: as ONE checkpoint, so the whole mid-churn state commits in one rename
MUTABLE_FORMAT = "taco-ann-mutable-index"
MUTABLE_FORMAT_VERSION = 1
#: the reference's dict keys of a mutable save, in their (sorted) leaf order
_MUTABLE_KEYS = ("base_ids", "delta", "delta_ids", "delta_live", "tombstones")

_IMI_FIELDS = ("centroids1", "centroids2", "assign1", "assign2", "cell_sizes")
_TRANSFORM_FIELDS = ("mean", "basis", "eigvals")


def _field(i: int) -> str:
    """JAX's ``keystr`` of field ``i`` of an unkeyed pytree node (a tuple
    position prints as plain ``[i]``)."""
    return f"[<flat index {i}>]"


def _meta_path(path: str) -> str:
    return os.path.join(path, "ann_index.json")


def _index_struct(index: SCIndex) -> dict:
    return {
        "n": int(index.n),
        "d": int(index.data.shape[1]),
        "sub_dims": [int(s) for s in index.sub_dims],
        "has_transform": index.transform is not None,
        "has_dim_perm": index.dim_perm is not None,
        "has_data_norms": index.data_norms is not None,
    }


def _leaf_spec(meta: dict, cfg: SCConfig) -> list[tuple[str, str, tuple[int, ...]]]:
    """(path, dtype, shape) of every leaf of the saved structure, in order."""
    n, d = meta["n"], meta["d"]
    f32, i32 = "float32", "int32"
    spec = []
    if meta["has_transform"]:
        m = cfg.n_subspaces * cfg.subspace_dim
        shapes = ((d,), (d, m), (m,))
        spec += [(_field(0) + _field(j), f32, shapes[j]) for j in range(3)]
    if meta["has_dim_perm"]:
        spec.append((_field(1), i32, (d,)))
    k = cfg.sqrt_k
    for i, s in enumerate(meta["sub_dims"]):
        s1, s2 = split_halves(int(s))
        shapes = (((k, s1), f32), ((k, s2), f32), ((n,), i32), ((n,), i32), ((k, k), i32))
        spec += [(f"{_field(2)}[{i}]{_field(j)}", dt, shape)
                 for j, (shape, dt) in enumerate(shapes)]
    spec.append((_field(3), f32, (n, d)))
    if meta["has_data_norms"]:
        spec.append((_field(4), f32, (n,)))
    return spec


def leaves_of(index: SCIndex) -> list[torch.Tensor]:
    """The index's tensors in the order the format stores them."""
    out = []
    if index.transform is not None:
        out += [getattr(index.transform, name) for name in _TRANSFORM_FIELDS]
    if index.dim_perm is not None:
        out.append(index.dim_perm)
    for sub in index.subspaces:
        out += [getattr(sub, name) for name in _IMI_FIELDS]
    out.append(index.data)
    if index.data_norms is not None:
        out.append(index.data_norms)
    return out


def save_index(index: SCIndex, cfg: SCConfig, path: str) -> str:
    """Persist ``(index, cfg)`` under directory ``path``; returns ``path``."""
    meta = {
        "format": FORMAT,
        "version": FORMAT_VERSION,
        "config": dataclasses.asdict(cfg),
        **_index_struct(index),
    }
    spec = _leaf_spec(meta, cfg)
    leaves = [(p, t.detach().cpu().numpy()) for (p, _dt, _s), t in zip(spec, leaves_of(index))]
    save_leaves(leaves, path, INDEX_STEP, extra_meta=meta)
    tmp = _meta_path(path) + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, _meta_path(path))
    return path


def _read_format_meta(path: str, want_format: str = FORMAT,
                      want_version: int = FORMAT_VERSION) -> dict:
    """The manifest's ``extra`` meta, validated as ``want_format``."""
    try:
        meta = read_manifest(path, INDEX_STEP).get("extra")
    except FileNotFoundError:
        raise FileNotFoundError(
            f"{path}: not a saved ANN index (no step_{INDEX_STEP} checkpoint)") from None
    got = meta.get("format") if isinstance(meta, dict) else None
    if got != want_format:
        hint = ""
        if got == MUTABLE_FORMAT:
            hint = " (this is a MUTABLE index save — use MutableAnnIndex.load)"
        elif got == FORMAT:
            hint = " (this is an immutable index save — use AnnIndex.load)"
        raise ValueError(f"{path}: checkpoint format {got!r} != {want_format!r}{hint}")
    if int(meta.get("version", -1)) > want_version:
        raise ValueError(
            f"{path}: index format version {meta['version']} is newer than this "
            f"code understands (<= {want_version})")
    return meta


def _config_of(meta: dict, path: str) -> SCConfig:
    known = {f.name for f in dataclasses.fields(SCConfig)}
    unknown = set(meta["config"]) - known
    if unknown:
        raise ValueError(f"{path}: config carries unknown SCConfig fields {sorted(unknown)}")
    return SCConfig(**meta["config"])


def load_index(path: str, *, device: str | torch.device = "cuda") -> tuple[SCIndex, SCConfig]:
    """Load ``(index, cfg)`` saved by :func:`save_index` (or by
    ``repro.ann.persistence.save_index``) onto ``device``."""
    dev = resolve_device(device)
    meta = _read_format_meta(path)
    cfg = _config_of(meta, path)
    arrays = restore_leaves(path, INDEX_STEP, _leaf_spec(meta, cfg))
    return _index_of(meta, cfg, arrays, dev), cfg


def _index_of(meta: dict, cfg: SCConfig, arrays: list, dev: torch.device) -> SCIndex:
    """An :class:`SCIndex` on ``dev`` from its leaves in format order."""
    it = iter(torch.from_numpy(a).to(dev) for a in arrays)
    sub_dims = tuple(int(s) for s in meta["sub_dims"])
    transform = None
    if meta["has_transform"]:
        transform = SubspaceTransform(
            **{name: next(it) for name in _TRANSFORM_FIELDS},
            n_subspaces=cfg.n_subspaces, subspace_dim=cfg.subspace_dim)
    dim_perm = next(it) if meta["has_dim_perm"] else None
    subspaces = tuple(IMISubspace(**{name: next(it) for name in _IMI_FIELDS})
                      for _ in sub_dims)
    data = next(it)
    data_norms = next(it) if meta["has_data_norms"] else None
    return SCIndex(transform=transform, dim_perm=dim_perm, subspaces=subspaces, data=data,
                   sub_dims=sub_dims, data_norms=data_norms)


# ---------------------------------------------------------------- mutable --
def _mutable_spec(meta: dict, cfg: SCConfig) -> list[tuple[str, str, tuple[int, ...]]]:
    """(path, dtype, shape) of every leaf of a mutable save, in order."""
    d, n_base, m = int(meta["d"]), int(meta["n_base"]), int(meta["n_delta_rows"])
    spec = []
    if meta["base"] is not None:
        spec += [("['base']" + p, dt, shape) for p, dt, shape in _leaf_spec(meta["base"], cfg)]
    shapes = {"base_ids": ("int32", (n_base,)), "delta": ("float32", (m, d)),
              "delta_ids": ("int32", (m,)), "delta_live": ("bool", (m,)),
              "tombstones": ("bool", (n_base,))}
    return spec + [(f"['{key}']", *shapes[key]) for key in _MUTABLE_KEYS]


def save_mutable_index(mutable, path: str) -> str:
    """Persist a :class:`~repro_torch.ann.mutable.MutableAnnIndex` mid-churn
    in the reference's ``MUTABLE_FORMAT``.

    The state snapshot, the id counters and the WAL watermark are read under
    the index's lock, so the watermark names exactly the mutation history
    the snapshot reflects. The snapshot is immutable, so its arrays are
    copied to the host (the base may be hundreds of MB on the card) only
    after the lock is released: writers never wait for the copy. Everything
    commits in one atomic rename; with a WAL attached the log then
    checkpoints (rotates and retires the segments the snapshot covers).
    """
    with mutable._lock:
        if mutable._log is not None:
            raise RuntimeError("cannot save while a compaction is in progress")
        st = mutable._state
        meta = {
            "format": MUTABLE_FORMAT,
            "version": MUTABLE_FORMAT_VERSION,
            "config": dataclasses.asdict(mutable.cfg),
            "d": int(mutable.d),
            "next_id": int(mutable._next_id),
            "generation": int(mutable.generation),
            "compactions": int(mutable._compactions),
            "n_delta_rows": int(st.n_delta_rows),
            "n_base": int(st.n_base),
            "durability": mutable.durability,
            "base": None if st.base is None else _index_struct(st.base.sc_index),
        }
        if mutable._wal is not None:
            seg, lsn = mutable._wal.position()
            meta["wal"] = {"segment": int(seg), "lsn": int(lsn)}
    arrays = []
    if st.base is not None:
        arrays += [t.detach().cpu().numpy() for t in leaves_of(st.base.sc_index)]
    arrays += [getattr(st, key) for key in _MUTABLE_KEYS]
    spec = _mutable_spec(meta, mutable.cfg)
    save_leaves([(p, a) for (p, _dt, _s), a in zip(spec, arrays)], path, INDEX_STEP,
                extra_meta=meta)
    tmp = _meta_path(path) + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:  # human-readable mirror, never load-bearing
        json.dump(meta, f, indent=1)
    os.replace(tmp, _meta_path(path))
    mutable._checkpoint_path = path
    if mutable._wal is not None:
        mutable._wal.checkpoint(meta["wal"]["lsn"])
    return path


def load_mutable_index(path: str, *, policy=None, wal_dir=None, durability=None,
                       device: str | torch.device = "cuda"):
    """Load a :func:`save_mutable_index` directory (or the reference's)
    back into a :class:`~repro_torch.ann.mutable.MutableAnnIndex` on
    ``device`` — bitwise state, including an uncompacted delta and live
    tombstones.

    Crash recovery: with ``wal_dir``, the WAL there is opened (its torn
    tail, if any, truncated at the last good record), every record past the
    snapshot's (segment, LSN) watermark is replayed onto the loaded state in
    LSN order, and the returned index keeps logging to the same directory
    (``durability`` defaults to what the snapshot recorded, else
    ``"async"``). Replay applies whole records only, so the result is
    exactly the pre-crash state up to the last durable record."""
    from repro_torch.ann.index import AnnIndex
    from repro_torch.ann.mutable import MutableAnnIndex, _state_delete, _state_insert
    from repro_torch.ann.wal import KIND_DELETE, KIND_INSERT, WriteAheadLog

    dev = resolve_device(device)
    meta = _read_format_meta(path, MUTABLE_FORMAT, MUTABLE_FORMAT_VERSION)
    cfg = _config_of(meta, path)
    d = int(meta["d"])
    arrays = restore_leaves(path, INDEX_STEP, _mutable_spec(meta, cfg))
    tree = dict(zip(_MUTABLE_KEYS, arrays[len(arrays) - len(_MUTABLE_KEYS):]))
    base = None
    if meta["base"] is not None:
        base_leaves = arrays[:len(arrays) - len(_MUTABLE_KEYS)]
        base = AnnIndex(sc_index=_index_of(meta["base"], cfg, base_leaves, dev), cfg=cfg)
    wal = None
    if wal_dir is not None:
        if durability is None:
            durability = meta.get("durability") or "async"
            if durability == "none":
                durability = "async"
        wal = WriteAheadLog(wal_dir)  # scans + truncates any torn tail
    elif durability not in (None, "none"):
        raise ValueError(f"durability={durability!r} requires wal_dir")
    mutable = MutableAnnIndex(
        cfg=cfg, dim=d, policy=policy, wal=wal,
        durability=durability if wal is not None else "none", device=dev,
    )
    st = mutable._new_state(base=base, **tree)
    mutable._next_id = int(meta["next_id"])
    mutable.generation = int(meta["generation"])
    mutable._compactions = int(meta["compactions"])
    if wal is not None:
        watermark = int(meta.get("wal", {}).get("lsn", -1))
        replayed = 0
        expected = watermark + 1
        for rec in wal.take_recovered():
            if rec.lsn <= watermark:
                continue
            if rec.lsn != expected:
                # a hole between the snapshot watermark and the log: records
                # past it are untrusted, the snapshot alone is consistent
                break
            expected += 1
            if rec.kind == KIND_INSERT:
                st = _state_insert(st, rec.vectors, rec.ids)
                mutable._next_id = max(mutable._next_id, int(rec.ids.max()) + 1)
            elif rec.kind == KIND_DELETE:
                st = _state_delete(st, rec.ids)
            # compact markers are layout events, not corpus events: the
            # replayed state carries the same live corpus either way
            mutable.generation = max(mutable.generation, int(rec.generation))
            replayed += 1
        wal.records_replayed = replayed
        mutable._mutations = replayed
    mutable._state = st
    mutable._checkpoint_path = path
    return mutable

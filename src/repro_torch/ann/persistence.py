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
number free. Saving and loading a mutable index are not ported yet.
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
#: the reference's mutable-index save, recognised only to reject it
MUTABLE_FORMAT = "taco-ann-mutable-index"

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


def _read_format_meta(path: str) -> dict:
    """The manifest's ``extra`` meta, validated as an immutable index."""
    try:
        meta = read_manifest(path, INDEX_STEP).get("extra")
    except FileNotFoundError:
        raise FileNotFoundError(
            f"{path}: not a saved ANN index (no step_{INDEX_STEP} checkpoint)") from None
    got = meta.get("format") if isinstance(meta, dict) else None
    if got != FORMAT:
        hint = ""
        if got == MUTABLE_FORMAT:
            hint = (" (this is a MUTABLE index save — use MutableAnnIndex.load, which "
                    "repro_torch does not have yet)")
        raise ValueError(f"{path}: checkpoint format {got!r} != {FORMAT!r}{hint}")
    if int(meta.get("version", -1)) > FORMAT_VERSION:
        raise ValueError(
            f"{path}: index format version {meta['version']} is newer than this "
            f"code understands (<= {FORMAT_VERSION})")
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
    index = SCIndex(transform=transform, dim_perm=dim_perm, subspaces=subspaces, data=data,
                    sub_dims=sub_dims, data_norms=data_norms)
    return index, cfg

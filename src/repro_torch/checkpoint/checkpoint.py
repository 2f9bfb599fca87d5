"""Atomic step-directory checkpoints, in the layout of
``repro.checkpoint.checkpoint`` so either package reads the other's files.

``<directory>/step_<n>/`` holds ``arrays.npz`` (leaves ``leaf_0``,
``leaf_1``, ... in order) and ``manifest.json`` (``step``, ``paths``,
``dtypes``, ``shapes`` and an optional ``extra``). The reference names each
leaf by the JAX key path of its pytree; the port has no pytrees, so its
callers hand over the (path, array) pairs in the reference's leaf order and
with the reference's path strings.

Atomicity: a save writes into ``tmp.<step>.<pid>``, fsyncs the manifest,
moves any old ``step_<n>`` aside and renames the new one into place, so a
crash never leaves a half-written checkpoint under the final name. Only
what an index save needs is here; the training side's manager is not
ported.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
from typing import Any

import numpy as np

#: the dtypes a leaf may have: numpy's own, so no extension-dtype package is
#: needed to read them back (an index has no other)
DTYPES = ("float32", "int32")


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}")


def save_leaves(leaves: list[tuple[str, np.ndarray]], directory: str, step: int, *,
                extra_meta: Any = None) -> str:
    """Atomically save ``(path, array)`` leaves as ``<directory>/step_<step>``.

    ``extra_meta`` (JSON-serializable) rides in the manifest under
    ``"extra"``, so it commits in the same rename as the arrays."""
    arrays, paths = {}, []
    for i, (path, x) in enumerate(leaves):
        a = np.ascontiguousarray(x)
        if str(a.dtype) not in DTYPES:
            raise ValueError(f"leaf {path}: dtype {a.dtype} not in {DTYPES}")
        arrays[f"leaf_{i}"] = a
        paths.append(path)
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = _step_dir(directory, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "paths": paths,
        "dtypes": [str(a.dtype) for a in arrays.values()],
        "shapes": [list(a.shape) for a in arrays.values()],
    }
    if extra_meta is not None:
        manifest["extra"] = extra_meta
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # rename aside, not delete-then-rename: a crash between the two renames
    # leaves the old checkpoint on disk (step_<n>.old.*)
    if os.path.exists(final):
        old = f"{final}.old.{os.getpid()}"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(final, old)
    os.rename(tmp, final)  # atomic on POSIX
    for stale in glob.glob(f"{final}.old.*"):
        shutil.rmtree(stale, ignore_errors=True)
    return final


def restore_leaves(directory: str, step: int,
                   spec: list[tuple[str, str, tuple[int, ...]]]) -> list[np.ndarray]:
    """The arrays of ``<directory>/step_<step>``, checked leaf by leaf
    against ``spec``: the expected ``(path, dtype, shape)`` of each leaf, in
    order."""
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if len(spec) != len(manifest["paths"]):
        raise ValueError(
            f"checkpoint has {len(manifest['paths'])} leaves, expected {len(spec)}")
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (want_path, want_dtype, want_shape) in enumerate(spec):
            if manifest["paths"][i] != want_path:
                raise ValueError(f"leaf {i}: path {manifest['paths'][i]} != {want_path}")
            arr = data[f"leaf_{i}"]
            if manifest["dtypes"][i] != want_dtype or str(arr.dtype) != want_dtype:
                raise ValueError(
                    f"leaf {want_path}: dtype {manifest['dtypes'][i]} != {want_dtype}")
            if list(arr.shape) != list(want_shape):
                raise ValueError(
                    f"leaf {want_path}: shape {arr.shape} != {tuple(want_shape)}")
            out.append(arr)
    return out


def read_manifest(directory: str, step: int) -> dict:
    """The manifest of a completed checkpoint (including any ``extra``)."""
    with open(os.path.join(_step_dir(directory, step), "manifest.json")) as f:
        return json.load(f)

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
crash never leaves a half-written checkpoint under the final name.

Training state (a tree of nested dicts and dataclasses of tensors) is
flattened by :func:`repro_torch.utils.tree_flatten_with_paths`, as JAX
flattens the reference's pytree of the same shape: dict keys sorted,
``['key']`` path segments, a dataclass's fields in order as
``[<flat index i>]``. So :class:`CheckpointManager` reads a checkpoint the
reference's ``CheckpointManager`` wrote, and the reference reads the
port's.
"""
from __future__ import annotations

import glob
import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.utils import tree_flatten_with_paths

#: the dtypes a leaf may have: numpy's own, so no extension-dtype package is
#: needed to read them back (an index has no other; a mutable index adds its
#: tombstone and live masks)
DTYPES = ("float32", "int32", "bool")


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}")


def save_leaves(leaves: list[tuple[str, np.ndarray]], directory: str, step: int, *,
                extra_meta: Any = None) -> str:
    """Atomically save ``(path, array)`` leaves as ``<directory>/step_<step>``.

    ``extra_meta`` (JSON-serializable) rides in the manifest under
    ``"extra"``, so it commits in the same rename as the arrays."""
    arrays, paths = {}, []
    for i, (path, x) in enumerate(leaves):
        a = np.asarray(x)  # not ascontiguousarray: it makes a 0-d leaf (1,)
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


def _host(x) -> np.ndarray:
    """A host copy of a leaf that later in-place updates do not reach."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def restore_tree(template, directory: str, step: int):
    """``template``'s structure with the leaves of ``<directory>/step_<step>``,
    each checked against the template leaf's path, dtype and shape and put
    on that leaf's device."""
    paths, leaves, rebuild = tree_flatten_with_paths(template)
    spec = [(path, str(leaf.dtype).removeprefix("torch."), tuple(leaf.shape))
            for path, leaf in zip(paths, leaves)]
    arrays = restore_leaves(directory, step, spec)
    return rebuild([torch.from_numpy(a).to(leaf.device) for a, leaf in zip(arrays, leaves)])


def _steps(directory: str) -> list[int]:
    return sorted(int(m.group(1)) for name in os.listdir(directory)
                  if (m := re.fullmatch(r"step_(\d+)", name)))


def latest_step(directory: str) -> int | None:
    """The newest completed checkpoint's step, or None."""
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


class CheckpointManager:
    """Periodic checkpoints of a training state with retention GC (mirrors
    ``repro.checkpoint.CheckpointManager``). The snapshot to the host is
    synchronous (the parameters are updated in place by the next step);
    with ``async_saves`` the write and the GC run on a thread of their own,
    one at a time. A failed write is raised by the next :meth:`wait`."""

    def __init__(self, directory: str, *, every: int = 100, keep_last: int = 3,
                 async_saves: bool = True):
        self.directory = directory
        self.every = every
        self.keep_last = keep_last
        self.async_saves = async_saves
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def maybe_save(self, tree: Any, step: int, force: bool = False) -> bool:
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        leaves = [(path, _host(x)) for path, x in zip(*tree_flatten_with_paths(tree)[:2])]
        if self.async_saves:
            self.wait()
            self._thread = threading.Thread(target=self._save_in_thread, args=(leaves, step),
                                            name="checkpoint-writer", daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(leaves, step)
        return True

    def _save_and_gc(self, leaves, step: int) -> None:
        save_leaves(leaves, self.directory, step)
        for old in _steps(self.directory)[: -self.keep_last]:
            shutil.rmtree(_step_dir(self.directory, old), ignore_errors=True)

    def _save_in_thread(self, leaves, step: int) -> None:
        try:
            self._save_and_gc(leaves, step)
        except Exception as e:  # the writer thread's boundary: wait() raises it
            self._error = e

    def wait(self) -> None:
        """Join the write in flight; raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write to {self.directory} failed") from err

    def restore_latest(self, template: Any):
        """(state restored into ``template``'s structure and devices, step),
        or (None, None) when the directory holds no checkpoint."""
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return restore_tree(template, self.directory, step), step

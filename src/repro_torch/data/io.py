"""fvecs/bvecs/ivecs readers and writers (the TEXMEX / big-ann-benchmarks
formats), a numpy copy of ``repro.data.io``, so that real corpora (SIFT,
GIST, DEEP) are read when they are present. Each vector is stored as
<int32 dim><dim * element>, little-endian. Nothing is downloaded."""
from __future__ import annotations

import numpy as np

_DTYPES = {"fvecs": np.float32, "bvecs": np.uint8, "ivecs": np.int32}


def read_vecs(path: str, max_count: int | None = None) -> np.ndarray:
    """The (n, dim) vectors of ``path`` (its suffix names the element
    type), at most ``max_count`` of them."""
    kind = path.rsplit(".", 1)[-1]
    dt = _DTYPES[kind]
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size == 0:
        return np.zeros((0, 0), dt)
    dim = int(np.frombuffer(raw[:4].tobytes(), dtype=np.int32)[0])
    row_bytes = 4 + dim * np.dtype(dt).itemsize
    n = raw.size // row_bytes
    if max_count is not None:
        n = min(n, max_count)
    rows = raw[: n * row_bytes].reshape(n, row_bytes)
    body = rows[:, 4:].copy()
    return body.view(dt).reshape(n, dim)


def write_vecs(path: str, data: np.ndarray) -> None:
    """Write (n, dim) ``data`` to ``path`` in the format its suffix names."""
    kind = path.rsplit(".", 1)[-1]
    dt = _DTYPES[kind]
    data = np.ascontiguousarray(data, dtype=dt)
    n, dim = data.shape
    dims = np.full((n, 1), dim, np.int32)
    out = np.concatenate([dims.view(np.uint8).reshape(n, 4),
                          data.view(np.uint8).reshape(n, -1)], axis=1)
    out.tofile(path)

#!/usr/bin/env python3
"""Whether each kernel's fast path still earns its place beside its wide
path, measured on the card.

    python3 scripts/kernel_fork_times.py

Three kernels keep two paths: a fast one for the shapes they always took
and a wide one for every other shape (N_s above 16 or a collision table
past shared memory; rows wider than 128 floats). The wide paths take the
fast paths' shapes too, so this script runs each wide path at the main
path's shapes and times it against the fast one (``scscore`` had such a
pair too; its wide kernel took the fast one's time, and is now its only
kernel):

- ``masked_rerank``: a variant of the source, built under ``build/``,
  whose dispatch sends N_s <= 16 with the table and heaps in shared memory
  to the wide kernel (``rerank_chunk_kernel<5, true>``);
- ``schist``: the library's own wide kernel, asked for with the wide
  geometry (one tile a block, the table in shared memory);
- ``kmeans_assign``: a variant that sends w = 128 to the wide tiled path
  (points streamed in chunks of 64 features) instead of the
  resident-points tiled path, at IVF's 10^6 x 128 against 1024 lists.

Each wide result must equal the fast one bit for bit. Shapes: N_s 6, K
1024, n 10^6, d 128, at Q 1000 and at the engine's bucket of 64;
masked_rerank at k 10 and 100 with SC >= 2 (about 3 % of the points pass).
Times in turns (fast, wide, wide, fast), CUDA events. The variants are
measurements only: the port never builds or calls them. Needs a CUDA card
and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (source, substitutions) of each variant: the fast branch never taken
VARIANTS = {
    "masked_rerank": (("  if (n_sub <= kMaxSub && table_in && heaps_in) return",
                       "  if (false && n_sub <= kMaxSub && table_in && heaps_in) return"),),
    "kmeans_assign": (("  if (w > tiled::MAX_WP)\n    return wide::launch",
                       "  if (w >= tiled::MAX_WP)\n    return wide::launch"),),
}


def build_variant(cuda, name: str) -> ctypes.CDLL:
    src = (cuda.CSRC / f"{name}.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: the source changed near {old[:40]!r}")
        src = src.replace(old, new)
    out_dir = ROOT / "build" / "kernel_fork_times"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}.cu").write_text(src)
    lib = out_dir / f"{name}.so"
    proc = subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-o", str(lib),
                           str(out_dir / f"{name}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    err = getattr(dll, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return dll


@contextmanager
def swapped(cuda, name: str, lib):
    """Kernel library ``name`` replaced by ``lib`` for the block."""
    real = cuda.library(name)
    cuda._libs[name] = lib
    try:
        yield
    finally:
        cuda._libs[name] = real


def through(cuda, name: str, lib, fn):
    """``fn`` with kernel library ``name`` replaced by ``lib`` for each call."""
    def call():
        with swapped(cuda, name, lib):
            return fn()
    return call


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels import cuda
    from repro_torch.kernels import kmeans_assign as KA
    from repro_torch.kernels import masked_rerank as MR
    from repro_torch.kernels import schist as S

    if not torch.cuda.is_available():
        print("kernel_fork_times: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"device: {chip_smoke.card_line()}", flush=True)
    cuda.build_all()
    libs = {name: build_variant(cuda, name) for name in VARIANTS}
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n_s, k2, n, d = 6, 1024, 10 ** 6, 128
    cells = torch.as_tensor(rng.integers(0, k2, (n_s, n)), dtype=torch.int32, device=dev)
    data = torch.as_tensor(rng.standard_normal((n, d), dtype=np.float32), device=dev)
    norms = (data * data).sum(1)
    rows, ok = [], True

    def compare(kernel, shape, fast, wide, same):
        nonlocal ok
        ok &= same
        ms = [chip_smoke.timed(torch, fast, 20)]
        ms += [chip_smoke.timed(torch, wide, 20) for _ in range(2)]
        ms.append(chip_smoke.timed(torch, fast, 20))
        row = dict(kernel=kernel, shape=shape, fast_ms=[ms[0], ms[3]], wide_ms=ms[1:3],
                   wide_over_fast=(ms[1] + ms[2]) / (ms[0] + ms[3]), equal=same)
        print(json.dumps(row), flush=True)
        rows.append(row)

    def schist_wide_geometry(q, n_sub, kk, blocks=None):
        counts = (n_sub + 1) * 32 * 4
        return S.SchistGeometry(1, 8, counts + n_sub * kk * 4, (q + 31) // 32, "shared", True)

    for q in (chip_smoke.QUERIES, 64):
        table = torch.as_tensor(rng.random((n_s, q, k2)) < 0.05, device=dev)
        bits = S.collision_bits(table)
        shape = f"Q {q}, N_s {n_s}, K {k2}, n {n}"
        real_geometry = S.schist_geometry

        def schist_wide():
            S.schist_geometry = schist_wide_geometry
            try:
                return S.schist_cuda(bits, cells, n_s + 1, q=q)
            finally:
                S.schist_geometry = real_geometry

        compare("schist", shape, lambda: S.schist_cuda(bits, cells, n_s + 1, q=q), schist_wide,
                bool(torch.equal(S.schist_cuda(bits, cells, n_s + 1, q=q), schist_wide())))
        queries = torch.as_tensor(rng.standard_normal((q, d), dtype=np.float32), device=dev)
        thresh = torch.full((q,), 2, dtype=torch.int32, device=dev)
        for k in (10, 100):
            args = (bits, cells, thresh, queries, data, norms, k)
            rerank = lambda: MR.masked_rerank_cuda(*args)  # noqa: E731
            rerank_wide = through(cuda, "masked_rerank", libs["masked_rerank"], rerank)
            (fd, fi), (wd, wi) = rerank(), rerank_wide()
            compare("masked_rerank", f"{shape}, d {d}, k {k}, SC >= 2", rerank, rerank_wide,
                    bool(torch.equal(fi, wi) and torch.equal(fd, wd)))
    # kmeans_assign at IVF's shape: the resident-points tiled path against
    # the wide path at w = 128 (its scratch laid out for the wide path)
    c = data[torch.as_tensor(rng.choice(n, 1024, replace=False), device=dev)].contiguous()
    fast = KA.kmeans_assign_cuda(data, c)
    real_dim = KA.MAX_ONE_TILE_DIM

    def kmeans_wide():
        KA.MAX_ONE_TILE_DIM = d - 1
        try:
            with swapped(cuda, "kmeans_assign", libs["kmeans_assign"]):
                return KA.kmeans_assign_cuda(data, c)
        finally:
            KA.MAX_ONE_TILE_DIM = real_dim

    wide = kmeans_wide()
    same = bool(torch.equal(fast[0], wide[0]) and torch.equal(fast[1], wide[1]))
    compare("kmeans_assign", f"x ({n}, {d}), c (1024, {d})",
            lambda: KA.kmeans_assign_cuda(data, c), kmeans_wide, same)
    out = ROOT / "chiprun_out" / "kernel_fork_times.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": chip_smoke.card_line(), "rows": rows}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

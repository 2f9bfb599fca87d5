"""Build, load and launch the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use (never at import: the CPU tests import every module), one
``nvcc`` per source, all started together, into
``build/repro_torch_kernels/`` at the checkout's root. A library's file name
carries a hash of its source, the shared ``*.cuh`` headers and the flags,
so an edited source rebuilds and an unchanged one loads as it is.

Every C entry point takes device pointers, sizes and a ``cudaStream_t``,
launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`launch` raises on a nonzero code and adds one
to the kernel's launch count.

The serving engine's drain worker, a background compaction and the caller
can launch kernels from several threads at once, so the build, the load
and the launch counts sit under one module lock: a library that several
threads first use is built by one ``nvcc`` and loaded once, and no launch is
lost from the counts.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

KERNELS = ("l2dist", "kmeans_assign", "schist", "masked_rerank", "scscore", "flash_attention",
           "activation")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: kernel name -> launches since the last :func:`reset_launch_counts`
launch_counts: dict[str, int] = {name: 0 for name in KERNELS}
#: kernel name -> the (bq, bn) tiles of its last launch since the last
#: :func:`reset_launch_counts`, for the kernels that take them (else None)
launch_blocks: dict[str, tuple[int, int] | None] = {name: None for name in KERNELS}
#: kernel name -> {layout: launches} since the last :func:`reset_launch_counts`:
#: where the wrapper put the launch's data (e.g. ``"table=global"`` where a
#: collision table is read from global memory), for the kernels that say
launch_layouts: dict[str, dict[str, int]] = {name: {} for name in KERNELS}

_libs: dict[str, ctypes.CDLL] = {}
#: guards the build, the load and the launch counts (module docstring)
_lock = threading.RLock()


def reset_launch_counts() -> None:
    with _lock:
        for name in KERNELS:
            launch_counts[name] = 0
            launch_blocks[name] = None
            launch_layouts[name] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def library_path(name: str) -> Path:
    """The library's path, tagged with a hash of its source, the shared
    headers and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile every library that is not built yet, in parallel. Returns
    each kernel's ``-Xptxas -v`` report (registers, shared memory, spills)
    from this build, or '' where the library was already built."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ), tmp, out)
        reports = {name: "" for name in names}
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            reports[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:  # the first use: one thread builds and loads, the rest wait
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(name: str, symbol: str, argtypes, *args, blocks=None, layout: str | None = None) -> None:
    """Call ``symbol`` of kernel library ``name``; raise on a CUDA error.
    ``blocks`` is the launch's (bq, bn), kept in :data:`launch_blocks`;
    ``layout`` where its data lives, counted in :data:`launch_layouts`."""
    lib = library(name)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    rc = fn(*args)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {rc} ({msg})")
    with _lock:
        launch_counts[name] += 1
        if blocks is not None:
            launch_blocks[name] = blocks
        if layout is not None:
            launch_layouts[name][layout] = launch_layouts[name].get(layout, 0) + 1


def check_cuda(name: str, *tensors: torch.Tensor, dtypes) -> None:
    """Shared wrapper checks: every tensor on one CUDA device, contiguous,
    with the expected dtype."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if t.dtype != dt:
            raise ValueError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")

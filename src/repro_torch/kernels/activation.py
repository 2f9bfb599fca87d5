"""Sort activation of a whole query batch: the CUDA kernel
(``csrc/activation.cu``).

Its plain version is :func:`repro_torch.kernels.ref.sort_activation_ref`
with the sizes broadcast over the queries; :func:`repro_torch.kernels.ops.
sort_activation` picks between the two. The kernel returns the plain
version's tau and retrieved count bit for bit wherever a subspace's total
size is below 2^24 (where the plain version's f32 sums are exact).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda

_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 2
         + [ctypes.c_int] * 3 + [ctypes.c_void_p])
#: the kernel's routes, by the code its ``sort_activation_route`` returns
ROUTES = ("registers", "shared", "global")
MAX_SUBSPACES = 65535


def check_inputs(d1s, d2s, sizes) -> None:
    """Raise ValueError unless d1s, d2s are (N_s, Q, sqrt_k) float32 and
    sizes (N_s, sqrt_k, sqrt_k) int32."""
    if d1s.dim() != 3 or d2s.shape != d1s.shape:
        raise ValueError(f"activation: d1s {tuple(d1s.shape)} and d2s {tuple(d2s.shape)} "
                         f"must be one (N_s, Q, sqrt_k) shape")
    n_sub, _q, sqrt_k = d1s.shape
    if sizes.shape != (n_sub, sqrt_k, sqrt_k):
        raise ValueError(f"activation: sizes {tuple(sizes.shape)} must be "
                         f"{(n_sub, sqrt_k, sqrt_k)}")
    if sqrt_k < 1 or n_sub > MAX_SUBSPACES:
        raise ValueError(f"activation: sqrt_k {sqrt_k} < 1 or N_s {n_sub} > {MAX_SUBSPACES}")
    for name, t, dt in (("d1s", d1s, torch.float32), ("d2s", d2s, torch.float32),
                        ("sizes", sizes, torch.int32)):
        if t.dtype != dt:
            raise ValueError(f"activation: {name} must be {dt}, got {t.dtype}")


def cells_layout(sqrt_k: int) -> str:
    """Where the kernel keeps a problem's cells, as its C entry decides:
    ``"registers"``, ``"shared"`` (memory), or ``"global"`` (memory, the
    stream kernel). Needs the built library."""
    fn = cuda.library("activation").sort_activation_route
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return ROUTES[fn(sqrt_k)]


def sort_activation_cuda(d1s, d2s, sizes, alpha_n):
    """Kernel launch: (taus (N_s, Q), retrieved (N_s, Q)) float32 for every
    (subspace, query) problem of d1s, d2s (N_s, Q, sqrt_k) float32 and the
    subspaces' sizes (N_s, sqrt_k, sqrt_k) int32, contiguous, on the card.
    ``alpha_n`` is rounded to float32 here, as the plain version's
    ``torch.tensor(alpha_n, dtype=float32)`` rounds it, and passed by value:
    nothing is copied to the card. One launch, counted under
    ``cells=<place>`` (:func:`cells_layout`) in :data:`cuda.launch_layouts`."""
    check_inputs(d1s, d2s, sizes)
    cuda.check_cuda("activation", d1s, d2s, sizes,
                    dtypes=(torch.float32, torch.float32, torch.int32))
    n_sub, q, sqrt_k = d1s.shape
    taus = torch.empty((n_sub, q), dtype=torch.float32, device=d1s.device)
    retrieved = torch.empty_like(taus)
    if taus.numel():
        alpha = torch.tensor(alpha_n, dtype=torch.float32).item()
        cuda.launch("activation", "sort_activation_f32", _ARGS, cuda.ptr(d1s), cuda.ptr(d2s),
                    cuda.ptr(sizes), alpha, cuda.ptr(taus), cuda.ptr(retrieved), n_sub, q,
                    sqrt_k, cuda.stream(d1s.device), layout=f"cells={cells_layout(sqrt_k)}")
    return taus, retrieved

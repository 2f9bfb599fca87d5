"""Full SC-score matrix (the gather query's collision count): the CUDA kernel
(``csrc/scscore.cu``) and its plain version.

Both take the packed collision table of :func:`repro_torch.kernels.schist.
collision_bits` and the per-index cell ids, the inputs ``schist`` takes, and
return SC (Q, n) int32: the number of subspaces in which each point's IMI
cell is activated for each query.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.schist import block_sc, unpack_collision_bits

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
MAX_SUBSPACES = 16
MAX_SMEM = 232448
#: points per block of the kernel's grid
CHUNK = 8192


def scscore_plain(bits, cells, *, q: int, block: int = 32768) -> torch.Tensor:
    """(q, n) int32 SC-scores: the per-subspace gather of the unpacked table
    and the sum over subspaces, in point blocks."""
    table = unpack_collision_bits(bits, q)
    n = cells.shape[1]
    out = torch.empty((q, n), dtype=torch.int32, device=bits.device)
    for lo in range(0, n, block):
        out[:, lo:lo + block] = block_sc(table, cells[:, lo:lo + block])
    return out


def scscore_cuda(bits, cells, *, q: int) -> torch.Tensor:
    """Kernel launch: (q, n) int32 SC-scores. The 32-query tile of the
    collision table must fit in a block's shared memory."""
    cuda.check_cuda("scscore", bits, cells, dtypes=(torch.int32, torch.int32))
    qt, n_sub, k2 = bits.shape
    n = cells.shape[1]
    if cells.shape[0] != n_sub or qt != (q + 31) // 32:
        raise ValueError(
            f"scscore: bits {tuple(bits.shape)}, cells {tuple(cells.shape)}, q {q} disagree")
    if n_sub > MAX_SUBSPACES:
        raise ValueError(f"scscore: at most {MAX_SUBSPACES} subspaces, got {n_sub}")
    if n_sub * k2 * 4 > MAX_SMEM:
        raise ValueError(f"scscore: a {n_sub} x {k2} collision table exceeds shared memory")
    out = torch.empty((q, n), dtype=torch.int32, device=bits.device)
    cuda.launch("scscore", "scscore_i32", _ARGS, cuda.ptr(bits), cuda.ptr(cells),
                cuda.ptr(out), q, n, n_sub, k2, min(CHUNK, max(n, 1)),
                cuda.stream(bits.device))
    return out

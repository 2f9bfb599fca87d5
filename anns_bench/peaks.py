"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit), and the roofline bound they give.

Each kind of work is priced at the highest rate at which an exact
implementation could do it: distance products at the TF32 tensor rate (a TF32
screen with exact float32 rechecks returns the exact answer), 32-bit integer
and bit work at the CUDA cores' 32-bit rate (67e12: two operations a lane a
clock, which no integer instruction beats, so the bound stays a bound)."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
RATES = {
    "tf32_tensor": 495e12,
    "bf16_tensor": 989e12,
    "int8_tensor": 1979e12,
    "cuda_core_32bit": 67e12,
}


def bound_seconds(work: dict) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory's rate and, for each kind of operation, its count over its rate."""
    t = work["bytes"] / HBM_BYTES_PER_S
    for kind, ops in work["ops"].items():
        t = max(t, ops / RATES[kind])
    return t


def int_bytes(largest: int) -> int:
    """Bytes of the smallest whole-byte unsigned integer that holds ``largest``."""
    for size in (1, 2, 4, 8):
        if largest < 1 << (8 * size):
            return size
    raise ValueError(f"{largest} does not fit 8 bytes")

"""Optimizers, gradient clipping, learning-rate schedules and the
int8-compressed gradient sum of the data-parallel step (mirrors
``repro.optim``)."""
from repro_torch.optim.adafactor import AdafactorState, adafactor
from repro_torch.optim.adamw import AdamWState, adamw
from repro_torch.optim.clip import clip_by_global_norm, clip_scale, global_norm
from repro_torch.optim.compression import (
    compressed_psum,
    dequantize_int8,
    payload_bytes,
    quantize_int8,
)
from repro_torch.optim.schedule import constant_lr, warmup_cosine

__all__ = [
    "AdafactorState",
    "AdamWState",
    "adafactor",
    "adamw",
    "clip_by_global_norm",
    "clip_scale",
    "compressed_psum",
    "constant_lr",
    "dequantize_int8",
    "global_norm",
    "payload_bytes",
    "quantize_int8",
    "warmup_cosine",
]

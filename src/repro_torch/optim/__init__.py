"""Optimizers, gradient clipping and learning-rate schedules (mirrors
``repro.optim``). ``compression.py`` (the int8-compressed psum over a mesh)
is not ported: it serves the shard_map training step, which waits with the
mesh tools."""
from repro_torch.optim.adafactor import AdafactorState, adafactor
from repro_torch.optim.adamw import AdamWState, adamw
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.schedule import constant_lr, warmup_cosine

__all__ = [
    "AdafactorState",
    "AdamWState",
    "adafactor",
    "adamw",
    "clip_by_global_norm",
    "constant_lr",
    "global_norm",
    "warmup_cosine",
]

"""The four input shapes an architecture is dry-run at (mirrors
``repro.configs.shapes``), and their inputs as ``meta`` tensors.

  train_4k     seq 4,096   global_batch 256   -> train step
  prefill_32k  seq 32,768  global_batch 32    -> prefill
  decode_32k   seq 32,768  global_batch 128   -> decode step (1 new token)
  long_500k    seq 524,288 global_batch 1     -> decode step, TaCo retrieval
                                                 attention for attention
                                                 archs; native for SSM/hybrid

Skips (the reference's):
  * whisper-medium x long_500k — pure full-attention enc-dec with bounded
    decode length; every other arch runs all four shapes (attention archs run
    long_500k via the paper's technique).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.model import ArchConfig, init_cache


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int
    taco_attention: bool = False


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1, taco_attention=True),
}


def skip_reason(arch: ArchConfig, shape: ShapeSpec) -> str | None:
    """Return a reason string if this (arch, shape) cell is skipped."""
    if shape.name == "long_500k" and arch.family == "audio":
        return (
            "whisper-medium is a pure full-attention enc-dec with an "
            "architecturally bounded decode length; long_500k skipped "
            "(DESIGN.md §Arch-applicability)"
        )
    return None


def resolve_arch_for_shape(arch: ArchConfig, shape: ShapeSpec) -> ArchConfig:
    """Per-cell config adjustments: long-context decode uses TaCo retrieval
    attention for archs that have attention layers (the paper's technique);
    SSM archs keep their native O(1) state."""
    if shape.taco_attention and arch.mixer in ("attn", "hybrid"):
        return dataclasses.replace(arch, attention_kind="taco")
    return arch


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: ArchConfig, shape: ShapeSpec, batch_override: int | None = None):
    """``meta`` stand-ins for every model input of this cell (shapes and
    dtypes as the reference's ``ShapeDtypeStruct`` s): nothing is
    allocated. Decode's cache is :func:`init_cache` on meta."""
    b = batch_override or shape.global_batch
    arch = resolve_arch_for_shape(arch, shape)
    if shape.kind in ("train", "prefill"):
        s = shape.seq_len
        text = s - (arch.frontend_len if arch.frontend == "vlm" else 0)
        batch = {"tokens": _meta((b, text), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = _meta((b, text), torch.int32)
        if arch.frontend == "audio":
            batch["frames"] = _meta((b, arch.frontend_len, arch.d_model), torch.float32)
        if arch.frontend == "vlm":
            batch["patch_embeds"] = _meta((b, arch.frontend_len, arch.d_model), torch.float32)
        return batch
    if shape.kind == "decode":
        cache = init_cache(arch, b, shape.seq_len, taco=arch.attention_kind == "taco",
                           device="meta")
        return {
            "tokens": _meta((b, 1), torch.int32),
            "pos": _meta((), torch.int32),
            "cache": cache,
        }
    raise ValueError(shape.kind)

"""Architecture registry: --arch <id> resolution for launchers/benchmarks."""
from __future__ import annotations

from repro_torch.configs import (
    arctic_480b,
    codeqwen15_7b,
    granite_3_2b,
    granite_moe_3b_a800m,
    jamba_15_large_398b,
    llava_next_mistral_7b,
    qwen15_4b,
    rwkv6_7b,
    starcoder2_3b,
    whisper_medium,
)

_MODULES = {
    "starcoder2-3b": starcoder2_3b,
    "granite-3-2b": granite_3_2b,
    "codeqwen1.5-7b": codeqwen15_7b,
    "qwen1.5-4b": qwen15_4b,
    "arctic-480b": arctic_480b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "whisper-medium": whisper_medium,
    "rwkv6-7b": rwkv6_7b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "jamba-1.5-large-398b": jamba_15_large_398b,
}

ARCHS = tuple(_MODULES)


def get_arch(name: str):
    return _MODULES[name].CONFIG


def get_smoke(name: str):
    return _MODULES[name].SMOKE

"""The dry runs' shapes (``repro_torch.configs.shapes``) and the meta
parameter tree (``models.model.meta_params``) against ``repro``.

For every architecture and shape: ``SHAPES``, ``skip_reason`` and
``resolve_arch_for_shape`` equal the reference's, and the leaves of
``input_specs`` (meta tensors) have the shapes and dtypes of the
reference's ``ShapeDtypeStruct`` s, the decode cache's compared through the
port's tree (its keys and the ``RetrievalState`` fields). For every smoke
config the meta parameter tree equals ``init_params``'s in shape and dtype.
All checks are exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.configs import shapes as RS
from repro_torch.configs import ARCHS, SHAPES, get_arch, get_smoke, input_specs, skip_reason
from repro_torch.configs import shapes as TS
from repro_torch.models import init_params, meta_params
from repro_torch.models.model import tree_leaves
from repro_torch.models.taco_attention import RetrievalState


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts and RetrievalState-like dataclasses."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(_flat(getattr(tree, f.name), f"{prefix}.{f.name}"))
        return out
    return {prefix: tree}


def test_shape_table_is_the_reference_s():
    assert list(SHAPES) == list(RS.SHAPES)
    for name, spec in SHAPES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(RS.SHAPES[name])


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_inputs_match_the_reference(arch, shape):
    """skip_reason, the resolved attention kind and every input leaf's
    shape and dtype, the decode cache's included; all meta, nothing
    allocated."""
    port, ref = get_arch(arch), ref_arch(arch)
    assert skip_reason(port, SHAPES[shape]) == RS.skip_reason(ref, RS.SHAPES[shape])
    resolved = TS.resolve_arch_for_shape(port, SHAPES[shape])
    assert resolved.attention_kind == RS.resolve_arch_for_shape(ref, RS.SHAPES[shape]).attention_kind
    got = _flat(input_specs(port, SHAPES[shape]))
    want = _flat(RS.input_specs(ref, RS.SHAPES[shape]))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert leaf.device.type == "meta", path
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert _dtype_name(leaf.dtype) == _dtype_name(want[path].dtype), path
    if SHAPES[shape].kind == "decode":
        states = [x for x in _walk(input_specs(port, SHAPES[shape])["cache"])
                  if isinstance(x, RetrievalState)]
        assert bool(states) == (resolved.attention_kind == "taco")


def _walk(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_params_are_init_params_by_shape_and_dtype(arch):
    cfg = get_smoke(arch)
    want = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    got = meta_params(cfg)
    got_flat, want_flat = _flat(got), _flat(want)
    assert sorted(got_flat) == sorted(want_flat)
    for path, leaf in got_flat.items():
        assert leaf.is_meta, path
        assert leaf.shape == want_flat[path].shape and leaf.dtype == want_flat[path].dtype, path
    bf16 = meta_params(dataclasses.replace(cfg, param_dtype="bfloat16"))
    assert {t.dtype for t in tree_leaves(bf16)} <= {torch.bfloat16, torch.float32}

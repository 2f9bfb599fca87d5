"""The port's partition-spec rule table (``repro_torch.launch.sharding``) and
its placement helpers (``repro_torch.mesh``: ``P``, ``local_shape``,
``block``) against ``repro.launch.sharding`` on the CPU, exactly.

* For every arch of the registry, on the 16x16 and 2x16x16 production
  meshes: ``param_pspecs`` and ``sanitize_specs``, ``train_state_pspecs``
  (AdamW, and Adafactor where the dry run picks it: arctic and jamba),
  ``batch_pspecs`` at train_4k and prefill_32k, and ``cache_pspecs`` at
  decode_32k and long_500k, entry by entry. The reference reads only
  ``mesh.shape``, so its trees are built in process over a stand-in whose
  ``shape`` is the mesh's axis sizes (no forced devices).
* ``position_bytes`` of each cell's arguments (the reference dry run's:
  the train state and batch; the parameters and batch; the parameters,
  cache, tokens and position) equals the per-device bytes of the
  reference's specs over its shapes, for all 39 cells on both meshes.
* ``block`` tiles a tensor as ``NamedSharding`` does, on a forced 8-device
  mesh in a subprocess (``run_reference``).
"""
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as ref_arch
from repro.configs import input_specs as ref_input_specs
from repro.configs.shapes import resolve_arch_for_shape as ref_resolve
from repro.launch import sharding as RSH
from repro.models.model import init_params as ref_init
from repro.optim import adafactor as ref_adafactor
from repro.optim import adamw as ref_adamw
from repro.train.loop import TrainState as RefTrainState
from repro_torch.configs import ARCHS, SHAPES, get_arch, input_specs, skip_reason
from repro_torch.configs.shapes import resolve_arch_for_shape
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.mesh import P, block, local_shape, make_mesh
from repro_torch.models.model import meta_params
from repro_torch.optim import adafactor, adamw
from repro_torch.train import TrainState
from repro_torch.utils import tree_flatten
from tests.test_torch_data_parallel import run_reference

MESHES = (False, True)


def stub(multi_pod: bool):
    """What the reference's rules read of a mesh: its axis sizes."""
    return types.SimpleNamespace(shape=dict(make_production_mesh(
        multi_pod=multi_pod, devices=["meta"] * (512 if multi_pod else 256)).shape))


def port_mesh(multi_pod: bool):
    return make_production_mesh(multi_pod=multi_pod,
                                devices=["meta"] * (512 if multi_pod else 256))


def ref_leaves(tree) -> list:
    return [tuple(s) for s in jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, JP))]


def port_leaves(tree) -> list:
    leaves = tree_flatten(tree)[0]
    assert all(isinstance(s, P) for s in leaves)
    return [tuple(s) for s in leaves]


def uses_adafactor(arch) -> bool:
    """The dry runs' ``pick_optimizer``."""
    return arch.n_layers * arch.d_model * arch.d_ff * 3 * max(arch.n_experts, 1) > 1e11


@pytest.fixture(scope="module")
def shapes():
    """Per arch: (reference parameter shapes, port meta parameters), both in
    the registry's dtypes."""
    out = {}
    for name in ARCHS:
        rp = jax.eval_shape(lambda cfg=ref_arch(name): ref_init(jax.random.PRNGKey(0), cfg))
        out[name] = (rp, meta_params(get_arch(name)))
    return out


def test_p_is_a_partition_spec():
    """Entries as jax normalizes them: a one-name tuple is the name, an
    empty one None; trailing dimensions unsplit."""
    for entries in [(None, ("data",), "model"), (("pod", "data"), None), ((),), ()]:
        assert tuple(P(*entries)) == tuple(JP(*entries))
    assert P("model") == ("model",) and repr(P(None, "model")) == "P(None, 'model')"
    mesh = make_mesh((2, 3), ("data", "model"), ["meta"] * 6)
    assert local_shape((4, 9, 5), P(None, "model"), mesh) == (4, 3, 5)
    assert local_shape((4, 9), P(("data", "model")), mesh) == (1, 9)


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_train_state_specs_are_the_reference(shapes, arch, multi_pod):
    """param_pspecs, sanitized and not, and the train state's specs (the
    dry run's optimizer), sanitized, entry by entry."""
    rp, tp = shapes[arch]
    ref_mesh, mesh, dp = stub(multi_pod), port_mesh(multi_pod), dp_axes(multi_pod)
    assert port_leaves(SH.param_pspecs(tp)) == ref_leaves(RSH.param_pspecs(rp))
    assert (port_leaves(SH.sanitize_specs(tp, SH.param_pspecs(tp), mesh))
            == ref_leaves(RSH.sanitize_specs(rp, RSH.param_pspecs(rp), ref_mesh)))
    adafactor_ = uses_adafactor(get_arch(arch))
    ropt, topt = (ref_adafactor(), adafactor()) if adafactor_ else (ref_adamw(), adamw())
    rstate = RefTrainState(params=rp, opt_state=jax.eval_shape(ropt[0], rp),
                           step=jax.ShapeDtypeStruct((), jnp.int32))
    tstate = TrainState(params=tp, opt_state=topt[0](tp), step=torch.zeros((), dtype=torch.int32))
    want = RSH.sanitize_specs(rstate, RSH.train_state_pspecs(rstate, dp, ref_mesh), ref_mesh)
    got = SH.sanitize_specs(tstate, SH.train_state_pspecs(tstate, dp, mesh), mesh)
    assert port_leaves(got) == ref_leaves(want)
    # ZeRO-1 splits a moment over the data axes somewhere
    if not adafactor_:
        assert any(dp == e or dp == (e,) for s in port_leaves(got.opt_state.m) for e in s)


def _cell(arch_name, shape_name, multi_pod):
    """(reference arguments and specs, port arguments and specs) of one dry-run
    cell, as ``repro.launch.dryrun.lower_cell`` builds them."""
    shape = SHAPES[shape_name]
    ref_mesh, mesh, dp = stub(multi_pod), port_mesh(multi_pod), dp_axes(multi_pod)
    rarch = ref_resolve(ref_arch(arch_name), shape)
    tarch = resolve_arch_for_shape(get_arch(arch_name), shape)
    if shape.kind in ("decode", "prefill"):
        rarch = dataclasses.replace(rarch, param_dtype="bfloat16")
        tarch = dataclasses.replace(tarch, param_dtype="bfloat16")
    rp = jax.eval_shape(lambda: ref_init(jax.random.PRNGKey(0), rarch))
    tp = meta_params(tarch)
    rin, tin = ref_input_specs(rarch, shape), input_specs(tarch, shape)
    rps = RSH.sanitize_specs(rp, RSH.param_pspecs(rp), ref_mesh)
    tps = SH.sanitize_specs(tp, SH.param_pspecs(tp), mesh)
    if shape.kind == "train":
        adafactor_ = uses_adafactor(tarch)
        ropt, topt = (ref_adafactor(), adafactor()) if adafactor_ else (ref_adamw(), adamw())
        rstate = RefTrainState(params=rp, opt_state=jax.eval_shape(ropt[0], rp),
                               step=jax.ShapeDtypeStruct((), jnp.int32))
        tstate = TrainState(params=tp, opt_state=topt[0](tp),
                            step=torch.zeros((), dtype=torch.int32))
        ref = [(rstate, RSH.sanitize_specs(
                   rstate, RSH.train_state_pspecs(rstate, dp, ref_mesh), ref_mesh)),
               (rin, RSH.sanitize_specs(rin, RSH.batch_pspecs(rin, dp), ref_mesh))]
        port = [(tstate, SH.sanitize_specs(tstate, SH.train_state_pspecs(tstate, dp, mesh),
                                           mesh)),
                (tin, SH.sanitize_specs(tin, SH.batch_pspecs(tin, dp), mesh))]
    elif shape.kind == "prefill":
        ref = [(rp, rps), (rin, RSH.sanitize_specs(rin, RSH.batch_pspecs(rin, dp), ref_mesh))]
        port = [(tp, tps), (tin, SH.sanitize_specs(tin, SH.batch_pspecs(tin, dp), mesh))]
    else:
        rc, tc = rin["cache"], tin["cache"]
        ref = [(rp, rps), (rc, RSH.sanitize_specs(rc, RSH.cache_pspecs(rc, dp), ref_mesh)),
               (rin["tokens"], RSH.sanitize_specs(rin["tokens"], JP(dp, None), ref_mesh)),
               (rin["pos"], JP())]
        port = [(tp, tps), (tc, SH.sanitize_specs(tc, SH.cache_pspecs(tc, dp), mesh)),
                (tin["tokens"], SH.sanitize_specs(tin["tokens"], P(dp, None), mesh)),
                (tin["pos"], P())]
    return ref, port, ref_mesh, mesh


def ref_device_bytes(tree, specs, ref_mesh) -> int:
    """Per-device bytes of a reference tree under its specs: each leaf's
    dimensions divided (rounded up) by the sizes of the axes its entry
    names, times the item size."""
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        spec = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        n = 1
        for size, e in zip(leaf.shape, spec):
            axes = () if e is None else (e,) if isinstance(e, str) else tuple(e)
            n *= -(-size // math.prod(ref_mesh.shape[a] for a in axes))
        total += n * np.dtype(leaf.dtype).itemsize
    return total


CELLS = [(a, s) for a in ARCHS for s in SHAPES
         if not skip_reason(get_arch(a), SHAPES[s])]


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_batch_and_cache_specs_and_position_bytes_are_the_reference(shape_name, multi_pod):
    """Every arch at one shape: the batch's or the cache's specs entry by
    entry, and position_bytes of the cell's arguments equal to the
    reference's per-device bytes (39 cells on each mesh in all)."""
    cells = [a for a, s in CELLS if s == shape_name]
    assert len(cells) == (9 if shape_name == "long_500k" else 10)
    for arch_name in cells:
        ref, port, ref_mesh, mesh = _cell(arch_name, shape_name, multi_pod)
        for (rt, rs), (tt, ts) in zip(ref, port):
            if not isinstance(rs, JP):
                assert port_leaves(ts) == ref_leaves(rs), (arch_name, shape_name)
            else:
                assert tuple(ts) == tuple(rs)
        want = sum(ref_device_bytes(t, s, ref_mesh) for t, s in ref)
        got = sum(SH.position_bytes(t, s, mesh) for t, s in port)
        assert got == want, (arch_name, shape_name, got, want)
    assert len(CELLS) == 39


def test_cache_specs_before_sanitizing():
    """cache_pspecs unsanitized at decode_32k (sequence over 'model') and
    long_500k (B = 1: context parallel over the data axes and 'model'),
    for an attention, an RWKV and a hybrid config."""
    for multi_pod in MESHES:
        dp = dp_axes(multi_pod)
        for name in ("granite-3-2b", "rwkv6-7b", "jamba-1.5-large-398b"):
            for shape_name in ("decode_32k", "long_500k"):
                shape = SHAPES[shape_name]
                rc = ref_input_specs(ref_resolve(ref_arch(name), shape), shape)["cache"]
                tc = input_specs(resolve_arch_for_shape(get_arch(name), shape), shape)["cache"]
                assert port_leaves(SH.cache_pspecs(tc, dp)) == ref_leaves(
                    RSH.cache_pspecs(rc, dp)), (name, shape_name)


BLOCK_REFERENCE = r"""
import sys
import numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh
from tests.test_torch_sharding import BLOCK_CASES

out = sys.argv[1]
assert len(jax.devices()) == 8
res = {}
for i, (shape, spec) in enumerate(BLOCK_CASES):
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=jax.devices())
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    arr = jax.device_put(x, NamedSharding(mesh, P(*spec)))
    ids = {d.id: tuple(int(c) for c in np.argwhere(mesh.devices == d)[0]) for d in jax.devices()}
    for shard in arr.addressable_shards:
        res[f"{i}/" + "_".join(map(str, ids[shard.device.id]))] = np.asarray(shard.data)
np.savez(out, **res)
print("REFERENCE_OK")
"""
#: (shape, spec) over a (pod 2, data 2, model 2) mesh: splits over one axis,
#: a tuple of axes in both orders, several dimensions, none
BLOCK_CASES = [((8, 6), (None, "model")), ((8, 6), ("model", None)),
               ((8, 6, 4), (("pod", "data"), "model")), ((8, 6, 4), (("data", "pod"), None, "model")),
               ((16, 4), (("pod", "data", "model"),)), ((4, 2), ()),
               ((4, 8, 2), (None, ("model", "pod"), "data"))]


def test_block_tiles_as_named_sharding(tmp_path):
    run_reference(BLOCK_REFERENCE, tmp_path / "blocks.npz")
    want = dict(np.load(tmp_path / "blocks.npz"))
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), ["cpu"] * 8)
    for i, (shape, spec) in enumerate(BLOCK_CASES):
        x = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
        for coords in np.ndindex(2, 2, 2):
            got = block(x, P(*spec), mesh, dict(zip(mesh.axis_names, coords)))
            ref = want[f"{i}/" + "_".join(map(str, coords))]
            assert tuple(got.shape) == ref.shape == local_shape(shape, P(*spec), mesh)
            np.testing.assert_array_equal(got.numpy(), ref)

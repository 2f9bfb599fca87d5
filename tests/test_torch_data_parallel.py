"""Data parallelism in the port (``repro_torch.mesh``, ``launch.mesh``,
``launch.elastic``, ``optim.compression``, ``train.make_shardmap_train_step``)
against ``repro`` on the CPU.

The reference's sharded results need forced host devices, and ``XLA_FLAGS``
must be set before jax starts, so they are computed once for this module in
a subprocess with 8 devices (``run_reference``, as in
tests/test_torch_distributed.py) and compared here; the production mesh's
512 positions need a second, small one.

Tolerances, each stated beside its check:
  * ``compressed_psum`` at S = 2, 4, 8 bit for bit against the reference's
    under ``shard_map`` (the int32 payload sum is exact), on f32 and bf16
    leaves, an all-zero leaf (the 1e-12 floor) and a leaf of exact
    half-quantum ties (round half to even); the plain sum within the f32
    (bf16) roundings of its partial sums; ``quantize_int8``/``dequantize_int8`` bit
    for bit;
  * the shard_map step, three steps from the reference's parameters: loss,
    grad norm, lr and shard 0's aux loss within 1e-4 relative (as
    tests/test_torch_train.py), every parameter within 1e-5 (compressed:
    with the step's int8 payloads pinned to the reference's rounding at the
    near-ties where the two round apart, GRAD_GAP_QUANTA, MAX_FLIPS);
  * the port's uncompressed S-shard step equal to its own
    ``make_train_step(microbatches=S)`` bit for bit at S = 2, 4.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.data.tokens import SyntheticTokenStream as JStream
from repro.launch import elastic as jelastic
from repro.models import model as RM
from repro.optim import dequantize_int8 as j_dequantize
from repro.optim import quantize_int8 as j_quantize
from repro_torch.ann import make_searcher
from repro_torch.configs import get_smoke
from repro_torch.core import taco
from repro_torch.core.config import taco_config
from repro_torch.data import gmm_dataset
from repro_torch.launch import elastic
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.mesh import axis_size, current_mesh, make_mesh, set_mesh
from repro_torch.models import params_from_arrays
from repro_torch.optim import (
    adafactor,
    adamw,
    compressed_psum,
    dequantize_int8,
    payload_bytes,
    quantize_int8,
    warmup_cosine,
)
from repro_torch.optim.compression import shared_scale
from repro_torch.train import TrainState, make_shardmap_train_step, make_train_step
from repro_torch.train import loop as loop_module
from repro_torch.utils import tree_flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SHARDS = (2, 4, 8)
LEAVES = ("f32", "bf16", "zero", "ties")
#: (arch, S, compress, optimizer): every S, both settings of the compression
#: and both optimizers on each smoke config (a reference step compiles in
#: 2-3 s, so not their full product of 24)
TRAIN_CASES = [
    ("granite-3-2b", 1, True, "adamw"), ("granite-3-2b", 2, True, "adamw"),
    ("granite-3-2b", 2, False, "adamw"), ("granite-3-2b", 4, True, "adamw"),
    ("granite-3-2b", 4, False, "adafactor"), ("granite-3-2b", 2, True, "adafactor"),
    ("granite-moe-3b-a800m", 1, False, "adamw"), ("granite-moe-3b-a800m", 2, True, "adamw"),
    ("granite-moe-3b-a800m", 2, False, "adafactor"), ("granite-moe-3b-a800m", 4, True, "adamw"),
    ("granite-moe-3b-a800m", 4, False, "adamw"),
]
STEPS = 3


def case_key(arch, shards, compress, opt) -> str:
    return f"{arch}/{shards}/{int(compress)}/{opt}"


REFERENCE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.configs import get_smoke
from repro.data.tokens import SyntheticTokenStream
from repro.models import model as RM
from repro.optim import adafactor, adamw, compressed_psum, warmup_cosine
from repro.train import loop
from tests.test_torch_data_parallel import LEAVES, SHARDS, STEPS, TRAIN_CASES, case_key

inputs, out = sys.argv[1:3]
assert len(jax.devices()) == 8, jax.devices()
arr = dict(np.load(inputs))
res = {}
for S in SHARDS:
    mesh = make_mesh((S,), ("d",), devices=jax.devices()[:S])
    tree = {n: jnp.asarray(arr[f"{S}/{n}"]) for n in LEAVES}
    tree["bf16"] = tree["bf16"].astype(jnp.bfloat16)
    for enabled in (True, False):
        fn = shard_map(lambda t: compressed_psum(jax.tree.map(lambda x: x[0], t), ("d",),
                                                 enabled=enabled),
                       mesh=mesh, in_specs=(P("d"),), out_specs=P(), check_vma=False)
        got = jax.jit(fn)(tree)
        for n in LEAVES:
            res[f"psum/{S}/{int(enabled)}/{n}"] = np.asarray(got[n].astype(jnp.float32))
# each compressed step's per-shard gradients, as the step's compressed_psum
# receives them (a host callback on each shard)
current = {}
real_psum = loop.compressed_psum


def record(shard, leaves):
    for i, g in enumerate(leaves):
        res[f"{current['key']}/{current['step']}/g/{int(shard)}/{i}"] = np.asarray(g, np.float32)


def spy_psum(tree, axis_name, *, enabled=True):
    if enabled:
        (axis,) = axis_name
        jax.debug.callback(record, jax.lax.axis_index(axis), jax.tree_util.tree_leaves(tree))
    return real_psum(tree, axis_name, enabled=enabled)


loop.compressed_psum = spy_psum
for arch, S, compress, opt_name in TRAIN_CASES:
    cfg = get_smoke(arch)
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    opt = adamw() if opt_name == "adamw" else adafactor()
    mesh = make_mesh((S,), ("data",), devices=jax.devices()[:S])
    step = loop.make_shardmap_train_step(cfg, opt, warmup_cosine(3e-4, 2, 10), mesh,
                                         compress_grads=compress)
    state = loop.TrainState(params=params, opt_state=opt[0](params), step=jnp.int32(0))
    # replicated on the mesh from the start, as the step returns it: one compile
    state = jax.device_put(state, NamedSharding(mesh, P()))
    stream = SyntheticTokenStream(cfg.vocab_size, 16, 4, seed=0)
    key = case_key(arch, S, compress, opt_name)
    for s in range(STEPS):
        current.update(key=key, step=s)
        state, m = step(state, jax.tree.map(jnp.asarray, stream.batch(s)))
        jax.effects_barrier()
        for name, v in m.items():
            res[f"{key}/{s}/{name}"] = np.asarray(v)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(state.params)):
        res[f"{key}/param/{i}"] = np.asarray(leaf)
np.savez(out, **res)
print("REFERENCE_OK")
"""

MESH_REFERENCE = r"""
import jax
from repro.launch.mesh import make_production_mesh
assert len(jax.devices()) == 512, len(jax.devices())
for multi_pod in (False, True):
    m = make_production_mesh(multi_pod=multi_pod)
    print("MESH", multi_pod, tuple(m.axis_names), dict(m.shape))
print("REFERENCE_OK")
"""


def run_reference(script: str, *args, devices: int = 8) -> str:
    """Run ``script`` with ``devices`` forced host devices (fresh jax) from
    the repo root; fail with its output unless it printed ``REFERENCE_OK``."""
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), ROOT, env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", script, *map(str, args)], env=env,
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0 and "REFERENCE_OK" in proc.stdout, (
        f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")
    return proc.stdout


def psum_inputs(rng) -> dict:
    """Per-shard leaves (S, ...) for each S: f32 normals at mixed scales, a
    leaf that bf16 holds exactly, an all-zero leaf, and a leaf whose largest
    |g| is 127 (scale exactly 1) around exact half-integers."""
    out = {}
    for S in SHARDS:
        f32 = rng.standard_normal((S, 33, 17)).astype(np.float32)
        f32 *= np.float32(10.0) ** rng.integers(-3, 2, (S, 1, 17)).astype(np.float32)
        bf16 = torch.from_numpy(rng.standard_normal((S, 40)).astype(np.float32)).to(
            torch.bfloat16).float().numpy()
        ties = (rng.integers(-126, 126, (S, 6, 7)) + 0.5).astype(np.float32)
        ties[0, 0, 0] = 127.0
        out.update({f"{S}/f32": f32, f"{S}/bf16": bf16, f"{S}/zero": np.zeros((S, 5), np.float32),
                    f"{S}/ties": ties})
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(inputs, the reference's results)."""
    tmp = tmp_path_factory.mktemp("data_parallel")
    inputs = psum_inputs(np.random.default_rng(11))
    np.savez(tmp / "inputs.npz", **inputs)
    run_reference(REFERENCE, tmp / "inputs.npz", tmp / "ref.npz")
    return inputs, dict(np.load(tmp / "ref.npz"))


def shard_trees(inputs, S) -> list:
    trees = []
    for s in range(S):
        tree = {n: torch.from_numpy(inputs[f"{S}/{n}"][s].copy()) for n in LEAVES}
        tree["bf16"] = tree["bf16"].to(torch.bfloat16)
        trees.append(tree)
    return trees


@pytest.mark.parametrize("S", SHARDS)
def test_compressed_psum_is_the_reference_bit_for_bit(ref, S):
    """The int8-compressed sum equals the reference's bit for bit at every
    leaf (zeros stay zero under the 1e-12 floor; the ties round half to
    even), and each element is within scale/2 of the uncompressed mean once
    divided by S (up to the f32 rounding of g/scale and of the rescale, 2^-14
    of a quantum). The plain sum (enabled=False) is within the roundings of
    the partial sums (S - 1 of them, each half an ulp of at most sum |g|) of
    the reference's."""
    inputs, want = ref
    trees = shard_trees(inputs, S)
    got = compressed_psum(trees)
    plain = compressed_psum(trees, enabled=False)
    for n in LEAVES:
        assert got[n].dtype == trees[0][n].dtype and plain[n].dtype == trees[0][n].dtype
        np.testing.assert_array_equal(got[n].float().numpy(), want[f"psum/{S}/1/{n}"])
        gs = [t[n] for t in trees]
        exact = torch.stack([g.double() for g in gs]).sum(0)
        # S - 1 roundings, each at most half an ulp of a partial sum
        tol = (S - 1) * 2.0 ** (-8 if n == "bf16" else -24) * torch.stack(
            [g.double().abs() for g in gs]).sum(0)
        assert ((plain[n].double() - torch.from_numpy(want[f"psum/{S}/0/{n}"]).double()).abs()
                <= 2 * tol).all(), n
        scale = float(shared_scale(gs))
        err = (got[n].double() - exact).abs().max() / S
        assert err <= scale * (0.5 + 2.0 ** -14), (n, float(err), scale)
    assert not got["zero"].any()
    # ties: scale is 1, so each shard's payload is its values rounded half to even
    want_ties = np.sum(np.round(inputs[f"{S}/ties"]), axis=0)
    np.testing.assert_array_equal(got["ties"].numpy(), want_ties)


def test_quantize_and_payload_bytes():
    """quantize_int8/dequantize_int8 bit for bit against the reference's on
    normals, ties and zeros; payload_bytes counts int32 and a float32 max a
    leaf when compressed, the leaf's dtype when not."""
    rng = np.random.default_rng(3)
    for x in (rng.standard_normal((17, 9)).astype(np.float32) * 3,
              (rng.integers(-126, 126, 40) + 0.5).astype(np.float32),
              np.zeros(6, np.float32)):
        if np.abs(x).max() > 100:
            x[0] = 127.0
        jq, js = j_quantize(jnp.asarray(x))
        q, s = quantize_int8(torch.from_numpy(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                      np.asarray(j_dequantize(jq, js)))
    tree = {"a": torch.zeros(10, 3), "b": {"c": torch.zeros(7, dtype=torch.bfloat16)}}
    assert payload_bytes(tree) == 4 * 30 + 4 + 4 * 7 + 4
    assert payload_bytes(tree, enabled=False) == 4 * 30 + 2 * 7


def carried(cfg, jcfg):
    return params_from_arrays(jax.tree.map(np.asarray, RM.init_params(jax.random.PRNGKey(0),
                                                                       jcfg)), cfg, device=CPU)


def fresh_state(cfg, jcfg, opt) -> TrainState:
    params = carried(cfg, jcfg)
    return TrainState(params=params, opt_state=opt[0](params),
                      step=torch.zeros((), dtype=torch.int32))


#: the largest gap, in quanta of a leaf's shared scale, between a shard's
#: g / scale in the port and in the reference: measured on these cases at
#: every step, shard and element, <= 3.0e-4 quanta (the rounding pinned as
#: pinning_spy pins it; without the pinning, step 3 starts from parameters
#: up to 2e-5 apart and the gap reaches 7.2e-4)
GRAD_GAP_QUANTA = 5e-4
#: int8 payload elements that round apart from the reference's in one case
#: (three steps, all shards): 0-6 seen
MAX_FLIPS = 8


def pinning_spy(monkeypatch, want: dict, key: str, shards: int, n_leaves: int,
                seen: dict):
    """Wrap the step's compressed_psum. Its own result must equal the int8
    payloads recomputed from the shards' gradients (as the reference
    quantises them), summed and rescaled; it is then returned with the
    reference's rounding taken at each element where a shard's payload and
    the reference's (from the reference's gradients of that shard, step and
    leaf) differ. Each such flip must be a near-tie: its g / scale within
    GRAD_GAP_QUANTA of a half-integer, and every element's g / scale within
    GRAD_GAP_QUANTA of the reference's. ``seen`` gets the flips and the
    largest gap."""
    real = loop_module.compressed_psum
    seen.update(calls=0, flips=0, gap=0.0)

    def quantize(x):
        return torch.clamp(torch.round(x), -127, 127).to(torch.int32)

    def spy(gs, *, enabled=True):
        out = real(gs, enabled=enabled)
        if not enabled:
            return out
        s, i = divmod(seen["calls"], n_leaves)
        seen["calls"] += 1
        theirs = [torch.from_numpy(want[f"{key}/{s}/g/{r}/{i}"]) for r in range(shards)]
        scale, their_scale = shared_scale(gs), shared_scale(theirs)
        own = pinned = torch.zeros(gs[0].shape, dtype=torch.int32)
        for g, h in zip(gs, theirs):
            x, y = g.detach().float() / scale, h / their_scale
            seen["gap"] = max(seen["gap"], float((x - y).abs().max()))
            q, q_ref = quantize(x), quantize(y)
            flip = q != q_ref
            assert ((x[flip] - x[flip].floor() - 0.5).abs() <= GRAD_GAP_QUANTA).all(), (s, i)
            seen["flips"] += int(flip.sum())
            own, pinned = own + q, pinned + torch.where(flip, q_ref, q)
        assert torch.equal(out, (own.float() * scale).to(out.dtype)), (s, i)
        return (pinned.float() * scale).to(out.dtype)

    monkeypatch.setattr(loop_module, "compressed_psum", spy)


@pytest.mark.parametrize("arch,S,compress,opt_name", TRAIN_CASES,
                         ids=[case_key(*c) for c in TRAIN_CASES])
def test_shardmap_train_step_matches_the_reference(ref, monkeypatch, arch, S, compress,
                                                   opt_name):
    """Three steps of make_shardmap_train_step over a 1-D data mesh of S CPU
    positions against the reference's over S forced host devices, from the
    same parameters and batches: loss (the shard losses' mean), grad norm,
    lr and aux loss (shard 0's, unreduced as in the reference) within 1e-4
    relative at every step; every parameter within 1e-5 after the third.

    Compressed, the int8 rounding is a step function of the gradient: an
    element whose g / scale sits within the two packages' gradient gap
    (GRAD_GAP_QUANTA, measured) of a half-integer may take the other
    integer in the reference, one quantum apart. The step's compressed sum
    is checked against its own payloads and then pinned to the reference's
    rounding at those flips (pinning_spy), each a near-tie and at most
    MAX_FLIPS in the three steps, so that every parameter is held to
    1e-5."""
    _, want = ref
    cfg, jcfg = get_smoke(arch), ref_smoke(arch)
    opt = adamw() if opt_name == "adamw" else adafactor()
    state = fresh_state(cfg, jcfg, opt)
    leaves = tree_flatten(state.params)[0]
    key = case_key(arch, S, compress, opt_name)
    seen: dict = {}
    pinning_spy(monkeypatch, want, key, S, len(leaves), seen)
    step = make_shardmap_train_step(cfg, opt, warmup_cosine(3e-4, 2, 10),
                                    make_mesh((S,), ("data",), devices=[CPU] * S),
                                    compress_grads=compress)
    stream = JStream(jcfg.vocab_size, 16, 4, seed=0)
    for s in range(STEPS):
        state, m = step(state, stream.batch(s))
        for name in ("loss", "grad_norm", "lr", "aux_loss"):
            np.testing.assert_allclose(float(m[name]), want[f"{key}/{s}/{name}"], rtol=1e-4,
                                       atol=1e-12, err_msg=f"step {s} {name}")
    assert int(state.step) == STEPS
    assert seen["calls"] == (STEPS * len(leaves) if compress else 0)
    assert seen["gap"] <= GRAD_GAP_QUANTA and seen["flips"] <= MAX_FLIPS, seen
    for i, leaf in enumerate(tree_flatten(state.params)[0]):
        np.testing.assert_allclose(leaf.detach().numpy(), want[f"{key}/param/{i}"], rtol=0,
                                   atol=1e-5, err_msg=f"leaf {i}")


def shard0_aux(cfg, params, batch, S):
    from repro_torch.train import loss_fn

    part = {k: torch.as_tensor(v[:v.shape[0] // S]) for k, v in batch.items()}
    with torch.no_grad():
        return float(loss_fn(params, cfg, part)[1])


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("S", [2, 4])
def test_uncompressed_step_is_the_microbatched_step(arch, S):
    """The uncompressed S-shard step on one device equals make_train_step
    with S microbatches bit for bit (the same per-block gradients summed in
    the same order; / S and * (1/S) give the same bits for S = 2, 4): loss,
    grad norm and every parameter, three steps. aux_loss is shard 0's, not
    the microbatches' mean."""
    cfg, jcfg = get_smoke(arch), ref_smoke(arch)
    for _ in range(3):
        g = torch.randn(1000) * 10.0 ** torch.randint(-30, 30, (1000,))
        assert torch.equal(g / S, g * (1.0 / S))
    opt = adamw()
    lr = warmup_cosine(3e-4, 2, 10)
    dp, mb = fresh_state(cfg, jcfg, opt), fresh_state(cfg, jcfg, opt)
    dp_step = make_shardmap_train_step(cfg, opt, lr, make_mesh((S,), ("data",), [CPU] * S),
                                       compress_grads=False)
    mb_step = make_train_step(cfg, opt, lr, microbatches=S)
    stream = JStream(jcfg.vocab_size, 16, 4, seed=0)
    for s in range(STEPS):
        batch = stream.batch(s)
        aux = shard0_aux(cfg, dp.params, batch, S)
        dp, got = dp_step(dp, batch)
        mb, want = mb_step(mb, batch)
        for name in ("loss", "grad_norm", "lr"):
            assert torch.equal(got[name], want[name]), (s, name, got[name], want[name])
        assert float(got["aux_loss"]) == aux
    for a, b in zip(tree_flatten(dp.params)[0], tree_flatten(mb.params)[0]):
        assert torch.equal(a, b)


def test_shardmap_step_refuses_a_batch_that_does_not_split():
    cfg, jcfg = get_smoke("granite-3-2b"), ref_smoke("granite-3-2b")
    opt = adamw()
    step = make_shardmap_train_step(cfg, opt, warmup_cosine(3e-4, 2, 10),
                                    make_mesh((3,), ("data",), [CPU] * 3))
    with pytest.raises(ValueError, match="does not split"):
        step(fresh_state(cfg, jcfg, opt), JStream(jcfg.vocab_size, 16, 4, seed=0).batch(0))


def test_device_mesh():
    """make_mesh takes the first prod(shape) devices row-major and raises on
    fewer (as jax.make_mesh); a device may repeat; shape is name -> size;
    a 1-D mesh iterates as its devices, a 2-D one refuses; grid() groups
    axes and takes position 0 of the others; set_mesh nests and restores;
    axis_size multiplies a tuple of axes."""
    devs = [torch.device("cpu", i) for i in range(10)]
    m = make_mesh((2, 4), ("data", "model"), devices=devs)
    assert m.shape == {"data": 2, "model": 4} and m.size == 8 and m.axis_names == ("data",
                                                                                  "model")
    assert m.devices[1, 2] == devs[6]
    with pytest.raises(ValueError, match="must be >="):
        make_mesh((2, 4), ("data", "model"), devices=devs[:7])
    with pytest.raises(ValueError):
        make_mesh((2, 4), ("data", "data"), devices=devs)
    with pytest.raises(ValueError, match="not a list"):
        list(m)
    assert list(make_mesh((3,), ("data",), devices=["cpu"] * 3)) == [CPU] * 3
    assert m.grid("model").tolist() == devs[:4]
    assert m.grid("model", "data").tolist() == [[devs[0], devs[4]], [devs[1], devs[5]],
                                                [devs[2], devs[6]], [devs[3], devs[7]]]
    assert m.grid(("data", "model")).tolist() == devs[:8]
    with pytest.raises(ValueError):
        m.grid("pod")
    assert axis_size(m, "model") == 4 and axis_size(m, ("data", "model")) == 8
    assert current_mesh() is None
    other = make_mesh((1,), ("data",), devices=["cpu"])
    with set_mesh(m):
        assert current_mesh() is m
        with set_mesh(other):
            assert current_mesh() is other
        assert current_mesh() is m
    assert current_mesh() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh((2,), ("data",))


def test_a_1d_mesh_places_a_sharded_searcher():
    """A 1-D DeviceMesh is accepted where the sharded searcher takes a list
    of shard devices, and places it the same."""
    data = gmm_dataset(2048, 24, seed=3)
    cfg = taco_config(n_subspaces=3, subspace_dim=6, n_clusters=16, k=5)
    index = taco.build(data, cfg, device="cpu")
    queries = torch.from_numpy(data[:16])
    a = make_searcher(index, cfg, "sharded", mesh=make_mesh((4,), ("data",), ["cpu"] * 4))
    b = make_searcher(index, cfg, "sharded", mesh=[CPU] * 4)
    assert a.shards == b.shards == 4
    ra, rb = a.run_padded(16, 5, cfg, queries), b.run_padded(16, 5, cfg, queries)
    np.testing.assert_array_equal(ra.ids, rb.ids)
    np.testing.assert_array_equal(ra.dists, rb.dists)


@pytest.mark.parametrize("survivors,model_shards,target_dp,pods", [
    (256, 16, 16, 1), (248, 16, 16, 1), (511, 16, 16, 2), (512, 16, 16, 2), (300, 16, 16, 2),
    (16, 16, 16, 1), (100, 8, 8, 1), (97, 4, 32, 4), (1000, 16, 32, 2), (64, 64, 16, 1),
    (7, 16, 16, 1), (15, 16, 16, 2)])
def test_replan_mesh_is_the_reference(survivors, model_shards, target_dp, pods):
    """replan_mesh equals the reference's plan field for field, and raises
    where it does (fewer survivors than model shards)."""
    kw = dict(model_shards=model_shards, target_dp=target_dp, pods=pods)
    try:
        want = jelastic.replan_mesh(survivors, **kw)
    except RuntimeError:
        with pytest.raises(RuntimeError, match="cannot re-mesh"):
            elastic.replan_mesh(survivors, **kw)
        return
    got = elastic.replan_mesh(survivors, **kw)
    assert (got.mesh_shape, got.axis_names, got.grad_accum_factor, got.dropped_devices) == (
        want.mesh_shape, want.axis_names, want.grad_accum_factor, want.dropped_devices)
    mesh = elastic.build_mesh(got, devices=[CPU] * 512)
    assert tuple(mesh.devices.shape) == got.mesh_shape and mesh.axis_names == got.axis_names


def test_build_mesh_over_the_visible_cards(monkeypatch):
    """Without devices build_mesh lays a plan over the visible cards, one a
    position: one card holds a one-device plan and refuses any larger, as
    the reference does with jax.devices()."""
    plan = elastic.ElasticPlan(mesh_shape=(1, 1), axis_names=("data", "model"),
                               grad_accum_factor=16, dropped_devices=0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    mesh = elastic.build_mesh(plan)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.devices[0, 0] == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="need 256 devices, have 1"):
        elastic.build_mesh(elastic.replan_mesh(256))


def test_production_mesh_is_the_reference():
    """make_production_mesh over 256 and 512 CPU positions has the
    reference's axis names and shape (its mesh over 512 forced host
    devices); fewer devices than it needs raise; repeats are allowed."""
    out = run_reference(MESH_REFERENCE, devices=512)
    want = {line.split(" ", 2)[1]: line.split(" ", 2)[2]
            for line in out.splitlines() if line.startswith("MESH")}
    for multi_pod, n in ((False, 256), (True, 512)):
        m = make_production_mesh(multi_pod=multi_pod, devices=[CPU] * n)
        assert f"{m.axis_names} {m.shape}" == want[str(multi_pod)]
        assert dp_axes(multi_pod) == (("pod", "data") if multi_pod else ("data",))
        with pytest.raises(ValueError, match="must be >="):
            make_production_mesh(multi_pod=multi_pod, devices=[CPU] * (n - 1))

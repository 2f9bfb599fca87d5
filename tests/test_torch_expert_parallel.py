"""Expert parallelism in the port (``repro_torch.models.moe``:
``moe_apply(dispatch_chunks=)``, ``moe_apply_manual``; ``moe_impl`` in
``models.model``) against ``repro`` on the CPU.

``moe_apply_manual`` and a forward with ``moe_impl="manual"`` are
``shard_map``s in the reference and need forced host devices, so they run
once for this module in a subprocess with 8 devices (``run_reference`` of
tests/test_torch_data_parallel.py) and are compared here; the reference's
chunked ``moe_apply`` runs on one device, in process.

Tolerances, each stated beside its check: the kept set (which (token,
choice) pairs reach their expert under capacity) bit for bit, against the
reference's own lines for it (transcribed per chunk and per grid position,
as tests/test_torch_families.py does for one chunk); ``moe_apply``'s output
and aux within 1e-6; ``moe_apply_manual``'s output within 1e-5 (the
reference's own test holds it to its GSPMD twin at rtol 2e-4) and aux within
1e-6; logits within 1e-4 (as tests/test_torch_lm.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.models import model as RM
from repro.models import moe as RMOE
from repro_torch.configs import get_smoke
from repro_torch.mesh import make_mesh, set_mesh
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import params_from_arrays
from tests.test_torch_data_parallel import run_reference

CPU = torch.device("cpu")
E, K, D, F = 8, 2, 16, 32
GRIDS = ((2, 4), (1, 8), (4, 2))
CAPACITIES = (1.25, 8.0)
ARCH = "granite-moe-3b-a800m"
FWD_GRID = (2, 4)
PROMPT, DECODE = 12, 3
#: the multi-pod layout in small: (pod, data, model), the batch over the
#: (pod, data) group as the reference's act_spec P(("pod", "data"), ...) puts it
POD_GRID = (2, 2, 2)
POD_AXES = ("pod", "data", "model")

REFERENCE = r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs import get_smoke
from repro.models import model as RM
from repro.models.moe import moe_apply_manual
from jax.sharding import PartitionSpec as P
from tests.test_torch_expert_parallel import (
    ARCH, CAPACITIES, DECODE, E, FWD_GRID, GRIDS, K, POD_AXES, POD_GRID, PROMPT)

inputs, out = sys.argv[1:3]
assert len(jax.devices()) == 8, jax.devices()
arr = dict(np.load(inputs))
p = {n: jnp.asarray(arr[n]) for n in ("router", "gate", "up", "down")}
x = jnp.asarray(arr["x"])
res = {}
for grid in GRIDS:
    mesh = make_mesh(grid, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:8])
    for cf in CAPACITIES:
        with set_mesh(mesh):
            o, aux = jax.jit(lambda pp, xx: moe_apply_manual(
                pp, xx, n_experts=E, experts_per_token=K, capacity_factor=cf))(p, x)
        res[f"manual/{grid}/{cf}/out"], res[f"manual/{grid}/{cf}/aux"] = o, aux
pod_mesh = make_mesh(POD_GRID, POD_AXES, axis_types=(AxisType.Auto,) * 3,
                     devices=jax.devices()[:8])
for cf in CAPACITIES:
    with set_mesh(pod_mesh):
        o, aux = jax.jit(lambda pp, xx: moe_apply_manual(
            pp, xx, n_experts=E, experts_per_token=K, capacity_factor=cf,
            dp_axes=("pod", "data")))(p, x)
    res[f"pod/{cf}/out"], res[f"pod/{cf}/aux"] = o, aux
mesh = make_mesh(FWD_GRID, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                 devices=jax.devices()[:8])
params = RM.init_params(jax.random.PRNGKey(0), get_smoke(ARCH))
tokens = jnp.asarray(arr["tokens"])
for impl in ("manual", "gspmd"):
    cfg = dataclasses.replace(get_smoke(ARCH), moe_impl=impl, moe_dispatch_chunks=FWD_GRID[0])
    with set_mesh(mesh):
        logits, aux = jax.jit(lambda pp, b: RM.forward(pp, cfg, b))(params, {"tokens": tokens})
        res[f"forward/{impl}/logits"], res[f"forward/{impl}/aux"] = logits, aux
        if impl == "manual":
            for rows in (2, 1):  # decode at one slot falls back to moe_apply
                t = tokens[:rows]
                step_logits, cache = RM.prefill(params, cfg, {"tokens": t[:, :PROMPT]},
                                                PROMPT + DECODE)
                res[f"decode/{rows}/{PROMPT - 1}"] = step_logits[:, 0]
                for s in range(PROMPT, PROMPT + DECODE - 1):
                    step_logits, cache = RM.decode_step(params, cfg, cache, t[:, s:s + 1], s)
                    res[f"decode/{rows}/{s}"] = step_logits[:, 0]
pod_cfg = dataclasses.replace(get_smoke(ARCH), moe_impl="manual", moe_dispatch_chunks=4,
                              act_spec=P(("pod", "data"), None, None))
with set_mesh(pod_mesh):
    logits, aux = jax.jit(lambda pp, b: RM.forward(pp, pod_cfg, b))(
        params, {"tokens": jnp.asarray(arr["pod_tokens"])})
res["pod/forward/logits"], res["pod/forward/aux"] = logits, aux
np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
print("REFERENCE_OK")
"""


def leaning_inputs(rng):
    """The reference's moe_init weights (8 experts of 16 -> 32) and tokens
    (4, 8, 16) leaning toward expert 0, so that capacity 1.25 drops."""
    p = RMOE.moe_init(jax.random.PRNGKey(0), D, F, E)
    lean = np.asarray(p["router"][:, 0] / jnp.linalg.norm(p["router"][:, 0]))
    x = (rng.standard_normal((4, 8, D)) + 2.0 * lean).astype(np.float32)
    return {n: np.asarray(v) for n, v in p.items()}, x


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(numpy weights, tokens x, model tokens, the reference's results and
    the multi-pod forward's tokens)."""
    tmp = tmp_path_factory.mktemp("expert_parallel")
    rng = np.random.default_rng(4)
    p, x = leaning_inputs(rng)
    tokens = rng.integers(0, ref_smoke(ARCH).vocab_size, (2, 16)).astype(np.int32)
    pod_tokens = rng.integers(0, ref_smoke(ARCH).vocab_size, (4, 16)).astype(np.int32)
    np.savez(tmp / "inputs.npz", x=x, tokens=tokens, pod_tokens=pod_tokens, **p)
    run_reference(REFERENCE, tmp / "inputs.npz", tmp / "ref.npz")
    return p, x, tokens, dict(np.load(tmp / "ref.npz"), pod_tokens=pod_tokens)


def ref_probs(p, x2):
    return jax.nn.softmax((x2 @ p["router"]).astype(jnp.float32), axis=-1)


def ref_kept_chunked(p, x, cf, tc):
    """The reference's kept set under dispatch_chunks=tc, as its lines
    compute it (repro/models/moe.py:142-164): (tc·k·T/tc,), chunk-major,
    each chunk's entries slot-major."""
    b, s, d = x.shape
    t = b * s
    tc = tc if t % tc == 0 else 1
    tl = t // tc
    cap = max(1, int(tl * K * cf / E))
    _, exp_idx = jax.lax.top_k(ref_probs(p, jnp.asarray(x).reshape(tc, tl, d)), K)
    fe = exp_idx.transpose(0, 2, 1).reshape(tc, K * tl)
    oh = jax.nn.one_hot(fe, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(oh, axis=1) - 1) * oh, axis=2)
    return np.asarray(pos < cap).reshape(-1)


def ref_kept_manual(p, x, cf, dp, ep):
    """The reference's kept set at each grid position (i, j), as its
    shard_map body computes it (repro/models/moe.py:51-69): {(i, j): (k·T_loc,)}."""
    b, s, d = x.shape
    t_loc, e_loc = b // dp * s, E // ep
    cap = max(1, int(t_loc * K * cf / E))
    kept = {}
    for i in range(dp):
        x2 = jnp.asarray(x[i * (b // dp):(i + 1) * (b // dp)]).reshape(t_loc, d)
        _, exp_idx = jax.lax.top_k(ref_probs(p, x2), K)
        fe = exp_idx.T.reshape(-1)
        for j in range(ep):
            le = fe - j * e_loc
            in_local = (le >= 0) & (le < e_loc)
            oh = jnp.where(in_local[:, None],
                           jax.nn.one_hot(jnp.clip(le, 0, e_loc - 1), e_loc, dtype=jnp.int32), 0)
            pos = jnp.sum((jnp.cumsum(oh, axis=0) - 1) * oh, axis=1)
            kept[i, j] = np.asarray(in_local & (pos < cap))
    return kept


def spy_routes(monkeypatch, seen: list):
    route = TMOE.route

    def spy(*a):
        out = route(*a)
        seen.append(out)
        return out

    monkeypatch.setattr(TMOE, "route", spy)


def torch_params(p):
    return {n: torch.from_numpy(v.copy()) for n, v in p.items()}


@pytest.mark.parametrize("cf", CAPACITIES)
@pytest.mark.parametrize("tc", [1, 2, 4, 3])
def test_moe_apply_dispatch_chunks_matches_reference(ref, monkeypatch, tc, cf):
    """moe_apply(dispatch_chunks=tc) against the reference's on one device:
    the kept set bit for bit (chunk-local capacity and positions; 32 tokens
    do not split into 3 chunks, which falls back to one), the output and
    aux within 1e-6. At capacity 1.25 the leaning tokens drop."""
    p, x, _, _ = ref
    want, want_aux = RMOE.moe_apply({n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x),
                                    n_experts=E, experts_per_token=K, capacity_factor=cf,
                                    dispatch_chunks=tc)
    seen: list = []
    spy_routes(monkeypatch, seen)
    got, aux = TMOE.moe_apply(torch_params(p), torch.from_numpy(x), n_experts=E,
                              experts_per_token=K, capacity_factor=cf, dispatch_chunks=tc)
    assert len(seen) == (tc if 32 % tc == 0 else 1)
    keep = torch.cat([route[4] for route in seen]).numpy()
    np.testing.assert_array_equal(keep, ref_kept_chunked(p, x, cf, tc))
    assert (not keep.all()) == (cf == 1.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cf", CAPACITIES)
@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_moe_apply_manual_matches_reference(ref, monkeypatch, grid, cf):
    """moe_apply_manual over a (data, model) grid of CPU positions against
    the reference's shard_map over the same grid of host devices: the kept
    set at every position bit for bit, the output within 1e-5, aux (the
    mean of the data blocks' Switch products) within 1e-6. Each data block
    is routed once; position (i, j) keeps its local experts' entries."""
    p, x, _, want = ref
    dp, ep = grid
    seen: list = []
    spy_routes(monkeypatch, seen)
    got, aux = TMOE.moe_apply_manual(torch_params(p), torch.from_numpy(x), n_experts=E,
                                     experts_per_token=K, capacity_factor=cf,
                                     mesh=make_mesh(grid, ("data", "model"), [CPU] * 8))
    assert len(seen) == dp
    kept = ref_kept_manual(p, x, cf, dp, ep)
    for i, (_, _, fe, _, keep) in enumerate(seen):
        for j in range(ep):
            local = (fe >= j * (E // ep)) & (fe < (j + 1) * (E // ep))
            np.testing.assert_array_equal((keep & local).numpy(), kept[i, j])
    assert (not torch.cat([r[4] for r in seen]).all()) == (cf == 1.25)
    np.testing.assert_allclose(got.numpy(), want[f"manual/{grid}/{cf}/out"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want[f"manual/{grid}/{cf}/aux"]), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("cf", CAPACITIES)
@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_manual_keeps_what_chunked_dispatch_keeps(ref, monkeypatch, grid, cf):
    """The port's manual MoE keeps the same (token, choice) pairs as its own
    moe_apply with dispatch_chunks = dp (one chunk a data block: the same
    capacity, the same positions), bit for bit; the outputs within 1e-6."""
    p, x, _, _ = ref
    dp = grid[0]
    routes: dict = {"manual": [], "chunked": []}
    tp, tx = torch_params(p), torch.from_numpy(x)
    spy_routes(monkeypatch, routes["manual"])
    got, _ = TMOE.moe_apply_manual(tp, tx, n_experts=E, experts_per_token=K,
                                   capacity_factor=cf,
                                   mesh=make_mesh(grid, ("data", "model"), [CPU] * 8))
    monkeypatch.undo()
    spy_routes(monkeypatch, routes["chunked"])
    want, _ = TMOE.moe_apply(tp, tx, n_experts=E, experts_per_token=K, capacity_factor=cf,
                             dispatch_chunks=dp)
    assert len(routes["manual"]) == len(routes["chunked"]) == dp
    for a, b in zip(routes["manual"], routes["chunked"]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[4], b[4])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cf", CAPACITIES)
def test_manual_over_a_pod_and_data_group_matches_reference(ref, monkeypatch, cf):
    """moe_apply_manual with dp_axes=("pod", "data") on a (pod 2, data 2,
    model 2) grid of CPU positions against the reference's shard_map over
    the same grid of host devices: the group is one batch axis of 4
    blocks (not data's 2), the kept set at every position bit for bit, the
    output within 1e-5, aux within 1e-6."""
    p, x, _, want = ref
    seen: list = []
    spy_routes(monkeypatch, seen)
    got, aux = TMOE.moe_apply_manual(torch_params(p), torch.from_numpy(x), n_experts=E,
                                     experts_per_token=K, capacity_factor=cf,
                                     mesh=make_mesh(POD_GRID, POD_AXES, [CPU] * 8),
                                     dp_axes=("pod", "data"))
    dp, ep = POD_GRID[0] * POD_GRID[1], POD_GRID[2]
    assert len(seen) == dp
    kept = ref_kept_manual(p, x, cf, dp, ep)
    for i, (_, _, fe, _, keep) in enumerate(seen):
        for j in range(ep):
            local = (fe >= j * (E // ep)) & (fe < (j + 1) * (E // ep))
            np.testing.assert_array_equal((keep & local).numpy(), kept[i, j])
    assert (not torch.cat([r[4] for r in seen]).all()) == (cf == 1.25)
    np.testing.assert_allclose(got.numpy(), want[f"pod/{cf}/out"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want[f"pod/{cf}/aux"]), rtol=0, atol=1e-6)


def test_forward_splits_the_batch_over_moe_dp_axes(ref, model, monkeypatch):
    """forward of granite-moe's smoke config with moe_impl="manual" and
    ``moe_dp_axes=("pod", "data")`` under a (pod 2, data 2, model 2) mesh,
    against the reference's with act_spec P(("pod", "data"), None, None):
    every MoE layer routes 4 blocks of one row (the default ("data",) would
    route 2), logits within 1e-4, the summed aux within 1e-6."""
    _, _, _, want = ref
    _, tp = model
    seen: list = []
    spy_routes(monkeypatch, seen)
    cfg = dataclasses.replace(get_smoke(ARCH), moe_impl="manual", moe_dispatch_chunks=4,
                              moe_dp_axes=("pod", "data"))
    with set_mesh(make_mesh(POD_GRID, POD_AXES, [CPU] * 8)):
        logits, aux = TM.forward(tp, cfg, {"tokens": torch.from_numpy(want["pod_tokens"])})
    assert len(seen) == 4 * cfg.n_layers
    np.testing.assert_allclose(logits.numpy(), want["pod/forward/logits"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want["pod/forward/aux"]), rtol=0, atol=1e-6)


def test_manual_refuses_what_does_not_split():
    p, x = leaning_inputs(np.random.default_rng(0))
    for grid, rows in (((2, 3), 4), ((3, 2), 4)):
        with pytest.raises(ValueError, match="divide evenly"):
            TMOE.moe_apply_manual(torch_params(p), torch.from_numpy(x[:rows]), n_experts=E,
                                  experts_per_token=K,
                                  mesh=make_mesh(grid, ("data", "model"), [CPU] * 6))


@pytest.fixture(scope="module")
def model(ref):
    """(reference params, port params) of granite-moe's smoke config."""
    rp = RM.init_params(jax.random.PRNGKey(0), ref_smoke(ARCH))
    return rp, params_from_arrays(jax.tree.map(np.asarray, rp), get_smoke(ARCH), device=CPU)


def port_cfg(impl):
    return dataclasses.replace(get_smoke(ARCH), moe_impl=impl, moe_dispatch_chunks=FWD_GRID[0])


@pytest.mark.parametrize("impl", ["manual", "gspmd"])
def test_forward_with_moe_impl_matches_reference(ref, model, monkeypatch, impl):
    """forward of granite-moe's smoke config with moe_impl="manual" under
    set_mesh (a (data 2, model 4) grid) and with "gspmd" at
    moe_dispatch_chunks=2, against the reference's under its set_mesh:
    logits within 1e-4, the summed aux within 1e-6. Manual takes
    moe_apply_manual in every layer."""
    _, _, tokens, want = ref
    _, tp = model
    calls = {"manual": 0, "gspmd": 0}
    for name, attr in (("manual", "moe_apply_manual"), ("gspmd", "moe_apply")):
        real = getattr(TMOE, attr)
        monkeypatch.setattr(TMOE, attr, lambda *a, _f=real, _n=name, **kw: (
            calls.__setitem__(_n, calls[_n] + 1), _f(*a, **kw))[1])
    cfg = port_cfg(impl)
    with set_mesh(make_mesh(FWD_GRID, ("data", "model"), [CPU] * 8)):
        logits, aux = TM.forward(tp, cfg, {"tokens": torch.from_numpy(tokens)})
    assert calls[impl] == cfg.n_layers and sum(calls.values()) == cfg.n_layers
    np.testing.assert_allclose(logits.numpy(), want[f"forward/{impl}/logits"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want[f"forward/{impl}/aux"]), rtol=0, atol=1e-6)


def test_manual_prefill_and_decode_match_reference(ref, model):
    """prefill + decode with moe_impl="manual": at 2 rows every MoE call is
    manual (2 % 2 == 0); at 1 row the switch falls back to moe_apply, the
    prompt in 2 chunks and a decode step's one token in one, as the
    reference's does; each step's logits within 1e-4
    of the reference's. Without a mesh, manual raises and names set_mesh."""
    _, _, tokens, want = ref
    _, tp = model
    cfg = port_cfg("manual")
    with set_mesh(make_mesh(FWD_GRID, ("data", "model"), [CPU] * 8)):
        for rows in (2, 1):
            t = torch.from_numpy(tokens[:rows]).long()
            logits, cache = TM.prefill(tp, cfg, {"tokens": t[:, :PROMPT]}, PROMPT + DECODE)
            got = {PROMPT - 1: logits[:, 0]}
            for s in range(PROMPT, PROMPT + DECODE - 1):
                logits, cache = TM.decode_step(tp, cfg, cache, t[:, s:s + 1], s)
                got[s] = logits[:, 0]
            for s, g in got.items():
                np.testing.assert_allclose(g.numpy(), want[f"decode/{rows}/{s}"], rtol=1e-4,
                                           atol=1e-4, err_msg=f"rows {rows} position {s}")
    with pytest.raises(ValueError, match="set_mesh"):
        TM.forward(tp, cfg, {"tokens": torch.from_numpy(tokens)})


def _arctic16(**kw):
    """arctic's smoke config with 16 experts, the manual MoE (the dense
    residual MLP beside it)."""
    return dataclasses.replace(get_smoke("arctic-480b"), n_experts=16, moe_impl="manual", **kw)


def _spy_calls(monkeypatch, calls: dict):
    """Record each moe_apply_manual call's (mesh, x, result) and count the
    moe_apply calls."""
    manual, chunked = TMOE.moe_apply_manual, TMOE.moe_apply

    def spy_manual(p, x, **kw):
        out = manual(p, x, **kw)
        calls["manual"].append((kw["mesh"], x.detach().clone(),
                                {k: v.detach().clone() for k, v in p.items()}, kw, out))
        return out

    def spy_chunked(*a, **kw):
        calls["chunked"] += 1
        return chunked(*a, **kw)

    monkeypatch.setattr(TMOE, "moe_apply_manual", spy_manual)
    monkeypatch.setattr(TMOE, "moe_apply", spy_chunked)


def test_shardmap_step_runs_each_shards_moe_over_its_own_slice(monkeypatch):
    """make_shardmap_train_step over a CPU (pod 2, data 2, model 2) mesh,
    the batch over ("pod", "data") (4 shards of 2 rows) and
    moe_dispatch_chunks 4 (which the shard's 2 rows do not divide): every
    MoE call is moe_apply_manual over the shard's (1, 2) slice of the grid
    at its own (pod, data) coordinates (never moe_apply), and its kept sets
    and aux equal, bit for bit, those of moe_apply_manual run on the same
    rows over that slice. The step equals make_train_step(microbatches=4)
    (each microbatch's MoE one chunk over a (1, 2) slice) within 1e-6 on
    the loss and every parameter."""
    from repro_torch.mesh import position_slice
    from repro_torch.optim import adamw, constant_lr
    from repro_torch.train import TrainState, make_shardmap_train_step, make_train_step
    from repro_torch.utils import tree_flatten

    cfg = _arctic16(moe_dispatch_chunks=4, moe_dp_axes=("pod", "data"))
    mesh = make_mesh(POD_GRID, POD_AXES, [CPU] * 8)
    opt = adamw()
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (8, 8)) for k in ("tokens", "labels")}

    def fresh():
        params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        return TrainState(params=params, opt_state=opt[0](params),
                          step=torch.zeros((), dtype=torch.int32))

    calls, routes = {"manual": [], "chunked": 0}, []
    spy_routes(monkeypatch, routes)
    _spy_calls(monkeypatch, calls)
    state, got = make_shardmap_train_step(cfg, opt, constant_lr(1e-3), mesh,
                                          data_axes=("pod", "data"),
                                          compress_grads=False)(fresh(), batch)
    # a layer's MoE runs twice a shard (forward and remat's recompute), and
    # routes once a call: the slice holds one block of the shard's rows
    calls_a_shard = 2 * cfg.n_layers
    assert calls["chunked"] == 0 and len(calls["manual"]) == len(routes) == 4 * calls_a_shard
    monkeypatch.undo()
    again: list = []
    spy_routes(monkeypatch, again)
    for n, (m, x, p, kw, (out, aux)) in enumerate(calls["manual"]):
        assert m.devices.shape == (1, 1, 2) and x.shape[0] == 2
        here = mesh.coords([("pod", "data")], [n // calls_a_shard])
        ref_out, ref_aux = TMOE.moe_apply_manual(
            p, x, **dict(kw, mesh=position_slice(mesh, ("pod", "data"), here)))
        for a, b in zip(routes[n], again[n]):
            assert torch.equal(a, b)
        assert torch.equal(ref_aux, aux.detach()) and torch.equal(ref_out, out.detach())
    monkeypatch.undo()
    micro = make_train_step(dataclasses.replace(cfg, moe_dispatch_chunks=1), opt,
                            constant_lr(1e-3), microbatches=4)
    with set_mesh(position_slice(mesh, ("pod", "data"))):
        plain, want = micro(fresh(), dict(batch))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)
    for a, b in zip(tree_flatten(state.params)[0], tree_flatten(plain.params)[0]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-6)


def test_shardmap_step_has_no_moe_apply_fallback_on_the_multi_pod_mesh(monkeypatch):
    """The production multi-pod mesh (2 x 16 x 16) on meta positions, the
    batch over ("pod", "data"): 256 rows are 8 a shard against the
    reference's 32 dispatch chunks, where the manual MoE used to fall back
    to moe_apply. The step's MoE is moe_apply_manual over the shard's
    (1, 1, 16) slice in every layer, with no fallback (one shard traced,
    the others represented)."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.optim import adamw, constant_lr
    from repro_torch.train import TrainState, make_shardmap_train_step

    cfg = _arctic16(moe_dispatch_chunks=32, moe_dp_axes=("pod", "data"))
    mesh = make_production_mesh(multi_pod=True, devices=["meta"] * 512)
    params = TM.meta_params(cfg)
    opt = adamw()
    state = TrainState(params=params, opt_state=opt[0](params),
                       step=torch.zeros((), dtype=torch.int32))
    calls = {"manual": [], "chunked": 0}
    _spy_calls(monkeypatch, calls)
    toks = torch.empty((256, 8), dtype=torch.long, device="meta")
    step = make_shardmap_train_step(cfg, opt, constant_lr(1e-3), mesh, data_axes=("pod", "data"),
                                    compress_grads=False, impl="torch")
    with OpCounter(mesh, represent=True) as counter:
        step(state, {"tokens": toks, "labels": toks})
    assert calls["chunked"] == 0 and len(calls["manual"]) == 2 * cfg.n_layers  # and remat's
    assert all(m.devices.shape == (1, 1, 16) and x.shape[0] == 8
               for m, x, *_ in calls["manual"])
    assert counter.represented == 31

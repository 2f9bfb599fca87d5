"""Expert parallelism over 'model' in the port (``repro_torch.models.sharded``'s
MoE sub-layer, ``train.make_sharded_train_step`` with AdamW or Adafactor)
against the reference's GSPMD runs on the CPU.

The reference runs once for this module in a subprocess with 8 forced host
devices (``run_reference``): for each case, its own
``repro.launch.dryrun.sharded_arch(..., dp_shards=|data|)`` of the config
(``moe_impl``, ``ep_spec``, one dispatch chunk a data shard), ``jax.jit``
of ``make_train_step(..., jit_compile=False)`` over a state placed by the
sanitized ``train_state_pspecs`` (2 steps), then ``forward``, ``prefill``
and 4 ``decode_step`` s over parameters placed by ``param_pspecs`` and a
cache by ``cache_pspecs``. The port starts from the same parameters
(``params_from_arrays``) and runs the same batches over a (data, model)
grid of CPU positions, its config from ``repro_torch.launch.dryrun.sharded_arch``.

Cases: smoke granite-moe with 6 experts on (data 2, model 4) (6 do not
divide 4: gate/up split over the expert FFN width, down over its output
columns; the "gspmd" aux over the whole batch; AdamW), smoke granite-moe
(4 experts) on (2, 2) (whole experts, gspmd, AdamW) and smoke arctic with
16 experts on (2, 4) (whole experts, "manual": the mean of the blocks'
aux, the dense residual MLP; Adafactor, whose lm_head column factor is
kept whole while the head's columns are split). Tolerances, float32
throughout: loss, grad norm, lr and aux_loss within 1e-4 relative; every
parameter and moment within 1e-5; the forward's, the prefill's and each
decode step's logits within 1e-5.

The payloads of one tiny MoE layer are checked by hand for each split, and
the sharded step's counts on meta tensors equal its counts on CPU tensors
for each split.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.mesh import P, make_mesh
from repro_torch.models import model as TM
from repro_torch.models import params_from_arrays
from repro_torch.models import sharded as SHD
from repro_torch.optim import adafactor, adamw, warmup_cosine
from repro_torch.train import TrainState, make_sharded_train_step
from repro_torch.utils import tree_flatten
from tests.test_torch_data_parallel import run_reference

#: case -> (arch, experts, (data, model), optimizer)
CASES = {"granite-moe6/2x4": ("granite-moe-3b-a800m", 6, (2, 4), "adamw"),
         "granite-moe4/2x2": ("granite-moe-3b-a800m", 4, (2, 2), "adamw"),
         "arctic16/2x4": ("arctic-480b", 16, (2, 4), "adafactor")}
STEPS = 2
BATCH, SEQ = 4, 16  # train batch: 2 rows a data block
PROMPT, MAX_SEQ, DECODE = 12, 32, 4
LR = (3e-4, 2, 10)  # warmup_cosine: the data-parallel tests' schedule


def config(arch, experts, smoke):
    return dataclasses.replace(smoke(arch), n_experts=experts)


def train_batch(cfg, step: int) -> dict:
    rng = np.random.default_rng(100 + step)
    return {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)}


def prompt_batch(cfg) -> dict:
    rng = np.random.default_rng(7)
    return {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)}


def decode_tokens(cfg, t: int) -> np.ndarray:
    return np.random.default_rng(50 + t).integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32)


REFERENCE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs import get_smoke
assert len(jax.devices()) == 8, jax.devices()
from repro.launch import sharding as SH
from repro.launch.dryrun import sharded_arch
from repro.models import model as RM
from repro.optim import adafactor, adamw, warmup_cosine
from repro.train import loop
from tests.test_torch_expert_sharding import (CASES, DECODE, LR, MAX_SEQ, PROMPT, STEPS, config,
                                              decode_tokens, prompt_batch, train_batch)

out = sys.argv[1]
res = {}
dp = ("data",)


def put(tree, specs, mesh):
    return jax.device_put(tree, SH.to_named(specs, mesh))


for key, (arch, experts, grid, opt_name) in CASES.items():
    cfg = sharded_arch(config(arch, experts, get_smoke), False, dp_shards=grid[0])
    res[f"{key}/moe_impl"] = np.asarray(cfg.moe_impl)
    mesh = make_mesh(grid, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:grid[0] * grid[1]])
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        res[f"{key}/init/{i}"] = np.asarray(leaf)
    opt = adamw() if opt_name == "adamw" else adafactor()
    state = loop.TrainState(params=params, opt_state=opt[0](params), step=jnp.int32(0))
    specs = SH.sanitize_specs(state, SH.train_state_pspecs(state, dp, mesh), mesh)
    step = jax.jit(loop.make_train_step(cfg, opt, warmup_cosine(*LR), jit_compile=False),
                   out_shardings=(SH.to_named(specs, mesh), None))
    with set_mesh(mesh):
        state = put(state, specs, mesh)
        for s in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in train_batch(cfg, s).items()}
            batch = put(batch, SH.sanitize_specs(batch, SH.batch_pspecs(batch, dp), mesh), mesh)
            state, m = step(state, batch)
            for name, v in m.items():
                res[f"{key}/{s}/{name}"] = np.asarray(v)
        moments = ("m", "v") if opt_name == "adamw" else ("vr", "vc")
        for part in ("params",) + moments:
            tree = state.params if part == "params" else getattr(state.opt_state, part)
            for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
                res[f"{key}/{part}/{i}"] = np.asarray(leaf)
        pspecs = SH.sanitize_specs(params, SH.param_pspecs(params), mesh)
        pp = put(params, pspecs, mesh)
        fwd = {"tokens": jnp.asarray(train_batch(cfg, 0)["tokens"])}
        fwd = put(fwd, SH.sanitize_specs(fwd, SH.batch_pspecs(fwd, dp), mesh), mesh)
        logits, aux = jax.jit(lambda p, b: RM.forward(p, cfg, b))(pp, fwd)
        res[f"{key}/forward"], res[f"{key}/forward_aux"] = np.asarray(logits), np.asarray(aux)
        prompt = {k: jnp.asarray(v) for k, v in prompt_batch(cfg).items()}
        prompt = put(prompt, SH.sanitize_specs(prompt, SH.batch_pspecs(prompt, dp), mesh), mesh)
        logits, cache = jax.jit(lambda p, b: RM.prefill(p, cfg, b, MAX_SEQ))(pp, prompt)
        res[f"{key}/prefill"] = np.asarray(logits)
        cache = put(cache, SH.sanitize_specs(cache, SH.cache_pspecs(cache, dp), mesh), mesh)
        dec = jax.jit(lambda p, c, t, pos: RM.decode_step(p, cfg, c, t, pos))
        for t in range(DECODE):
            logits, cache = dec(pp, cache, jnp.asarray(decode_tokens(cfg, t)),
                                jnp.int32(PROMPT + t))
            res[f"{key}/decode/{t}"] = np.asarray(logits)
np.savez(out, **res)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("expert_sharding") / "ref.npz"
    run_reference(REFERENCE, out)
    return dict(np.load(out))


def port_config(key):
    arch, experts, grid, _ = CASES[key]
    return dryrun.sharded_arch(config(arch, experts, get_smoke), False)


def init_tree(want: dict, key: str, cfg):
    """The reference's initial parameters of a case as the port's tree."""
    leaves, rebuild = tree_flatten(TM.meta_params(cfg))
    arrays = rebuild([want[f"{key}/init/{i}"] for i in range(len(leaves))])
    return params_from_arrays(arrays, cfg, device="cpu")


def cpu_mesh(grid):
    return make_mesh(grid, ("data", "model"), ["cpu"] * (grid[0] * grid[1]))


def optimizer(name):
    return adamw() if name == "adamw" else adafactor()


@pytest.mark.parametrize("key", list(CASES))
def test_expert_sharded_train_step_matches_the_reference(ref, key):
    """Two steps of make_sharded_train_step from the reference's parameters
    over the case's grid, the port's moe_impl the reference's: loss, grad
    norm, lr and aux_loss within 1e-4 relative at each step; every
    parameter and both moments (AdamW's m and v, Adafactor's vr and vc)
    within 1e-5 after the second."""
    _arch, _experts, grid, opt_name = CASES[key]
    cfg = port_config(key)
    assert cfg.moe_impl == str(ref[f"{key}/moe_impl"])
    params = init_tree(ref, key, cfg)
    opt = optimizer(opt_name)
    state = TrainState(params=params, opt_state=opt[0](params),
                       step=torch.zeros((), dtype=torch.int32))
    mesh = cpu_mesh(grid)
    placed = SHD.place_train_state(state, mesh)
    step = make_sharded_train_step(cfg, opt, warmup_cosine(*LR), mesh)
    for s in range(STEPS):
        placed, m = step(placed, train_batch(cfg, s))
        for name in ("loss", "grad_norm", "lr", "aux_loss"):
            np.testing.assert_allclose(float(m[name]), ref[f"{key}/{s}/{name}"], rtol=1e-4,
                                       atol=1e-12, err_msg=f"step {s} {name}")
    back = SHD.unplace_train_state(placed)
    assert int(back.step) == STEPS and int(back.opt_state.step) == STEPS
    moments = ("m", "v") if opt_name == "adamw" else ("vr", "vc")
    for part in ("params",) + moments:
        tree = back.params if part == "params" else getattr(back.opt_state, part)
        for i, leaf in enumerate(tree_flatten(tree)[0]):
            np.testing.assert_allclose(leaf.detach().numpy(), ref[f"{key}/{part}/{i}"], rtol=0,
                                       atol=1e-5, err_msg=f"{part} {i}")


@pytest.mark.parametrize("key", list(CASES))
def test_expert_sharded_forward_matches_the_reference(ref, key):
    """sharded_forward of the first train batch's tokens over the case's
    grid: the logits, gathered over 'model', within 1e-5 of the
    reference's forward under the same specs; the aux (the whole batch's
    for gspmd, the blocks' mean for manual) within 1e-4 relative."""
    grid = CASES[key][2]
    cfg = port_config(key)
    params = init_tree(ref, key, cfg)
    mesh = cpu_mesh(grid)
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    batch = {"tokens": torch.from_numpy(train_batch(cfg, 0)["tokens"])}
    logits, aux = SHD.sharded_forward(placed, cfg, batch, mesh)
    want = ref[f"{key}/forward"]
    assert logits.shape == want.shape
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), ref[f"{key}/forward_aux"], rtol=1e-4)


@pytest.mark.parametrize("key", list(CASES))
def test_expert_sharded_prefill_and_decode_match_the_reference(ref, key):
    """sharded_prefill of the prompt and 4 sharded_decode_step s: each
    step's logits within 1e-5 of the reference's GSPMD run."""
    grid = CASES[key][2]
    cfg = port_config(key)
    params = init_tree(ref, key, cfg)
    mesh = cpu_mesh(grid)
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    prompt = {k: torch.from_numpy(v) for k, v in prompt_batch(cfg).items()}
    logits, cache = SHD.sharded_prefill(placed, cfg, prompt, MAX_SEQ, mesh)
    np.testing.assert_allclose(logits.numpy(), ref[f"{key}/prefill"], rtol=1e-5, atol=1e-5)
    for t in range(DECODE):
        toks = torch.from_numpy(decode_tokens(cfg, t))
        logits, cache = SHD.sharded_decode_step(placed, cfg, cache, toks, PROMPT + t, mesh)
        np.testing.assert_allclose(logits.numpy(), ref[f"{key}/decode/{t}"], rtol=1e-5,
                                   atol=1e-5, err_msg=f"decode step {t}")


@pytest.mark.parametrize("arch, grid, split", [
    ("granite-moe-3b-a800m", (1, 16), "width"), ("granite-moe-3b-a800m", (2, 4), "experts"),
    ("arctic-480b", (16, 16), "experts"), ("granite-moe-3b-a800m", (1, 1), "experts")])
def test_the_split_is_read_from_the_placed_leaves(arch, grid, split):
    """The full configs' expert weights placed on meta by the sanitized
    specs: granite-moe's 40 experts over 16 positions split the expert FFN
    width, over 4 whole experts (10 a position), whatever moe_impl says;
    arctic's 128 over 16 are whole experts; one position holds them whole."""
    cfg = dataclasses.replace(get_arch(arch), n_layers=1)
    params = TM.meta_params(cfg)
    mesh = make_mesh(grid, ("data", "model"), ["meta"] * (grid[0] * grid[1]))
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    moe = SHD._groups(placed["blocks"], cfg.n_groups)[0]["l0"]["moe"]
    row = SHD._Row(cfg, mesh, {"data": 0}, "torch")
    assert SHD._expert_split(row, moe) == split


def test_an_expert_split_it_does_not_implement_raises():
    """gate/up/down split over the model width (their input rows) is
    neither whole experts nor the FFN width: the MoE sub-layer raises."""
    cfg = port_config("granite-moe4/2x2")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    mesh = cpu_mesh((1, 2))
    specs = SHD.param_specs(params, mesh)
    for name in ("gate", "up", "down"):
        specs["blocks"]["l0"]["moe"][name] = P(None, None, "model", None)
    placed = SHD.place(params, specs, mesh)
    with pytest.raises(NotImplementedError, match="moe"):
        SHD.sharded_forward(placed, cfg, {"tokens": torch.zeros((2, 4), dtype=torch.long)},
                            mesh)


def _moe_layer_payloads(cfg, grid):
    """One MoE sub-layer (the first group's l0) of one data block of 2 x 8
    tokens over a (data, model) CPU grid, forward and backward, counted:
    (collective bytes, counts, tokens, capacity)."""
    mesh = cpu_mesh(grid)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    moe = SHD._groups(placed["blocks"], cfg.n_groups)[0]["l0"]["moe"]
    h = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    t = 16
    cap = max(1, int(t * cfg.experts_per_token * cfg.capacity_factor / cfg.n_experts))
    with OpCounter(mesh) as counter:
        row = SHD._Row(cfg, mesh, {"data": 0}, "torch")
        y, stats = SHD._moe(row, moe, h)
        (y.sum() + stats[1].sum()).backward()
    an = counter.analysis()
    return an["collective_bytes"], an["collective_counts"], t, cap


def test_payloads_of_one_moe_layer_by_hand():
    """float32, T = 16 tokens of D = 64, k = 2. Whole experts (4 over 2):
    the partial outputs' sum, one all-reduce of (T, D); its backward
    all-reduces the gradients of the tokens (T, D) and of the gates (k T)
    that every position read. The FFN width (6 experts over 4 positions,
    F = 32): forward all-gathers of the hidden columns (E, cap, F) and of
    the output columns (T, D); backward their reduce-scatters (a position's
    (E, cap, F/4) and (T, D/4)) and the all-reduces of the buffer's
    gradient (E, cap, D) and the gates'."""
    cfg = port_config("granite-moe4/2x2")
    got, counts, t, _cap = _moe_layer_payloads(cfg, (1, 2))
    d, k = cfg.d_model, cfg.experts_per_token
    assert counts["all-reduce"] == 3 and counts["all-gather"] == counts["reduce-scatter"] == 0
    assert got["all-reduce"] == 2 * t * d * 4 + k * t * 4
    cfg = port_config("granite-moe6/2x4")
    got, counts, t, cap = _moe_layer_payloads(cfg, (1, 4))
    e, f = cfg.n_experts, cfg.d_ff
    assert counts["all-gather"] == 2 and counts["reduce-scatter"] == 2
    assert got["all-gather"] == e * cap * f * 4 + t * d * 4
    assert got["reduce-scatter"] == e * cap * f // 4 * 4 + t * d // 4 * 4
    assert counts["all-reduce"] == 2
    assert got["all-reduce"] == e * cap * d * 4 + k * t * 4


def _count_step(key, device):
    _arch, _experts, grid, opt_name = CASES[key]
    cfg = dataclasses.replace(port_config(key), n_layers=1)
    mesh = make_mesh(grid, ("data", "model"), [device] * (grid[0] * grid[1]))
    params = (TM.meta_params(cfg) if device == "meta" else
              TM.init_params(torch.Generator().manual_seed(0), cfg, device=device))
    opt = optimizer(opt_name)
    placed = SHD.place_train_state(TrainState(params=params, opt_state=opt[0](params),
                                              step=torch.zeros((), dtype=torch.int32)), mesh)
    step = make_sharded_train_step(cfg, opt, warmup_cosine(*LR), mesh, impl="torch")
    toks = torch.zeros((BATCH, SEQ), dtype=torch.long, device=device)
    with OpCounter(mesh, represent=device == "meta") as c:
        step(placed, {"tokens": toks, "labels": toks})
    return c


@pytest.mark.parametrize("key", ["granite-moe6/2x4", "arctic16/2x4"])
def test_expert_sharded_step_counts_on_meta_equal_the_cpu_counts(key):
    """The sharded train step of one layer traced on CPU tensors (every
    position) and on meta tensors (representatives where they apply):
    flops, bytes, payloads and counts equal, for each split (the FFN width
    under gspmd's whole-batch aux and AdamW; whole experts under manual's
    blockwise aux and Adafactor)."""
    got = []
    for device in ("cpu", "meta"):
        h = _count_step(key, device).analysis()
        got.append((h["flops"], h["bytes"], h["collective_bytes"], h["collective_counts"]))
    assert got[0] == got[1]
    assert got[0][0] > 0 and got[0][3]["all-reduce"] > 0

"""Tensor parallelism over 'model' for the RWKV6 and Mamba mixers in the port
(``repro_torch.models.sharded``'s RWKV time mix and channel mix, its Mamba
mixer with the ``in_proj`` x/z re-split, the hybrid stack with attention
and the MoE; ``train.make_sharded_train_step`` with AdamW or Adafactor)
against the reference's GSPMD runs on the CPU.

The reference runs once for this module, in one subprocess a case (the
three at once) with 8 forced host devices (``run_reference``): for each
case, its own
``repro.launch.dryrun.sharded_arch(..., dp_shards=|data|)`` of the config,
``jax.jit`` of ``make_train_step(..., jit_compile=False)`` over a state
placed by the sanitized ``train_state_pspecs`` (2 steps), then ``forward``,
``prefill`` and 4 ``decode_step`` s over parameters placed by
``param_pspecs`` and a cache by ``cache_pspecs``. The port starts from the
same parameters (``params_from_arrays``) and runs the same batches over a
(data, model) grid of CPU positions.

Cases: smoke rwkv6-7b on (data 2, model 4) (one head a position; AdamW
with ZeRO-1; ``rwkv_chunk`` 8, so the 16-token train batch takes the
chunked WKV and the 12-token prompt the sequential one), smoke jamba with
16 experts on (2, 4) (the manual MoE with whole experts, the ``in_proj``
x/z re-split, 2 KV heads over 4 positions gathered, Adafactor) and smoke
jamba with 4 experts on (2, 2) (gspmd, AdamW). Tolerances, float32
throughout: loss, grad norm, lr and aux_loss within 1e-4 relative; every
parameter and moment within 1e-5; the forward's, the prefill's and each
decode step's logits within 1e-5 for rwkv6 and within 1e-4 for jamba
(``LOGITS_TOL``: the port's own one-device forward, prefill and decode of
these jamba weights differ from the reference by up to 4.4e-5, so 1e-5
cannot tell the sharding's rounding from the two frameworks'; 1e-4 is
what ``tests/test_torch_families.py`` holds the one-device port to).

The payloads of one RWKV layer and one Mamba layer are checked by hand, the
sharded step's counts on meta tensors equal its counts on CPU tensors for
both mixers, and a time mix split inside a head raises.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.mesh import make_mesh
from repro_torch.models import model as TM
from repro_torch.models import params_from_arrays
from repro_torch.models import sharded as SHD
from repro_torch.optim import adafactor, adamw, warmup_cosine
from repro_torch.train import TrainState, make_sharded_train_step
from repro_torch.utils import tree_flatten
from tests.test_torch_data_parallel import run_reference

#: case -> (arch, experts (None: the config's), (data, model), optimizer)
CASES = {"rwkv6/2x4": ("rwkv6-7b", None, (2, 4), "adamw"),
         "jamba16/2x4": ("jamba-1.5-large-398b", 16, (2, 4), "adafactor"),
         "jamba4/2x2": ("jamba-1.5-large-398b", 4, (2, 2), "adamw")}
RWKV_CHUNK = 8  # the train batch's 16 tokens chunked, the 12-token prompt sequential
STEPS = 2
BATCH, SEQ = 4, 16  # train batch: 2 rows a data block
PROMPT, MAX_SEQ, DECODE = 12, 32, 4
LR = (3e-4, 2, 10)  # warmup_cosine: the data-parallel tests' schedule
#: the logits' tolerance (rtol = atol) by arch: jamba's eight f32 layers of
#: Mamba scans, attention and MoE round apart from the reference's by up to
#: 4.4e-5 on one device already (the module's docstring)
LOGITS_TOL = {"rwkv6-7b": 1e-5, "jamba-1.5-large-398b": 1e-4}


def config(arch, experts, smoke):
    cfg = smoke(arch)
    if experts is not None:
        cfg = dataclasses.replace(cfg, n_experts=experts)
    if cfg.mixer == "rwkv":
        cfg = dataclasses.replace(cfg, rwkv_chunk=RWKV_CHUNK)
    return cfg


def train_batch(cfg, step: int) -> dict:
    rng = np.random.default_rng(200 + step)
    return {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)}


def prompt_batch(cfg) -> dict:
    rng = np.random.default_rng(17)
    return {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)}


def decode_tokens(cfg, t: int) -> np.ndarray:
    return np.random.default_rng(60 + t).integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32)


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
from tests.test_torch_ssm_sharding import (CASES, DECODE, LR, MAX_SEQ, PROMPT, STEPS, config,
                                           decode_tokens, prompt_batch, train_batch)

out = sys.argv[1]
res = {}
dp = ("data",)
keys = sys.argv[2:] or list(CASES)


def put(tree, specs, mesh):
    return jax.device_put(tree, SH.to_named(specs, mesh))


for key in keys:
    arch, experts, grid, opt_name = CASES[key]
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
    """The reference's runs of every case: one subprocess a case, all at
    once (each compiles its own train step, forward, prefill and decode)."""
    base = tmp_path_factory.mktemp("ssm_sharding")
    outs = {key: base / f"ref{i}.npz" for i, key in enumerate(CASES)}
    with ThreadPoolExecutor(len(CASES)) as pool:
        list(pool.map(lambda key: run_reference(REFERENCE, outs[key], key), CASES))
    res = {}
    for out in outs.values():
        res.update(np.load(out))
    return res


def port_config(key):
    arch, experts, _grid, _ = CASES[key]
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
def test_ssm_sharded_train_step_matches_the_reference(ref, key):
    """Two steps of make_sharded_train_step from the reference's parameters
    over the case's grid: loss, grad norm, lr and aux_loss within 1e-4
    relative at each step; every parameter and both moments (AdamW's m and
    v, Adafactor's vr and vc) within 1e-5 after the second."""
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
def test_ssm_sharded_forward_matches_the_reference(ref, key):
    """sharded_forward of the first train batch's tokens over the case's
    grid: the logits, gathered over 'model', within LOGITS_TOL of the
    reference's forward under the same specs; the aux within 1e-4
    relative (0 for rwkv6)."""
    grid = CASES[key][2]
    cfg = port_config(key)
    params = init_tree(ref, key, cfg)
    mesh = cpu_mesh(grid)
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    batch = {"tokens": torch.from_numpy(train_batch(cfg, 0)["tokens"])}
    logits, aux = SHD.sharded_forward(placed, cfg, batch, mesh)
    want = ref[f"{key}/forward"]
    assert logits.shape == want.shape
    tol = LOGITS_TOL[CASES[key][0]]
    np.testing.assert_allclose(logits.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(float(aux), ref[f"{key}/forward_aux"], rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("key", list(CASES))
def test_ssm_sharded_prefill_and_decode_match_the_reference(ref, key):
    """sharded_prefill of the prompt (its WKV states over the heads, Mamba's
    conv windows and h over the inner channels, the token shifts
    replicated) and 4 sharded_decode_step s: each step's logits within
    LOGITS_TOL of the reference's GSPMD run."""
    grid = CASES[key][2]
    cfg = port_config(key)
    params = init_tree(ref, key, cfg)
    mesh = cpu_mesh(grid)
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    prompt = {k: torch.from_numpy(v) for k, v in prompt_batch(cfg).items()}
    tol = LOGITS_TOL[CASES[key][0]]
    logits, cache = SHD.sharded_prefill(placed, cfg, prompt, MAX_SEQ, mesh)
    np.testing.assert_allclose(logits.numpy(), ref[f"{key}/prefill"], rtol=tol, atol=tol)
    for t in range(DECODE):
        toks = torch.from_numpy(decode_tokens(cfg, t))
        logits, cache = SHD.sharded_decode_step(placed, cfg, cache, toks, PROMPT + t, mesh)
        np.testing.assert_allclose(logits.numpy(), ref[f"{key}/decode/{t}"], rtol=tol,
                                   atol=tol, err_msg=f"decode step {t}")


@pytest.mark.parametrize("key", list(CASES))
def test_the_decode_state_is_split_as_cache_pspecs_says(key):
    """The prefilled cache's blocks, whole again, equal prefill's cache on one
    device (within LOGITS_TOL), and each block has cache_pspecs' shape: the
    WKV state (B, H, hd, hd) over the heads, Mamba's conv window and h over
    the inner channels, the token shifts replicated over 'model'."""
    grid = CASES[key][2]
    cfg = port_config(key)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    mesh = cpu_mesh(grid)
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    prompt = {k: torch.from_numpy(v) for k, v in prompt_batch(cfg).items()}
    _, cache = SHD.sharded_prefill(placed, cfg, prompt, MAX_SEQ, mesh)
    one = dataclasses.replace(cfg, moe_impl="gspmd", moe_dispatch_chunks=grid[0])
    _, want = TM.prefill(params, one, prompt, MAX_SEQ, impl="torch")
    whole = SHD.unplace(cache)
    n, tol = grid[1], LOGITS_TOL[CASES[key][0]]
    for layer, c in cache.items():
        for name, pl in c.items():
            if name in ("k", "v"):
                continue
            block = next(iter(pl.blocks.values()))
            split = {"wkv": 2, "h": 2, "conv": 3}.get(name)
            full = list(pl.shape)
            full[1] //= grid[0]
            if split is not None:
                full[split] //= n
            assert list(block.shape) == full, (layer, name)
            np.testing.assert_allclose(whole[layer][name].numpy(), want[layer][name].numpy(),
                                       rtol=tol, atol=tol, err_msg=f"{layer} {name}")


def test_a_time_mix_split_inside_a_head_raises():
    """The smoke rwkv6's 4 heads over 8 'model' positions: the sanitized
    specs move u's split onto head_dim (the column blocks of wr/wk/wv/wg
    are half heads), and the time mix raises rather than split a head."""
    cfg = port_config("rwkv6/2x4")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    mesh = cpu_mesh((1, 8))
    specs = SHD.param_specs(params, mesh)
    assert tuple(specs["blocks"]["l0"]["rwkv"]["u"]) == (None, None, "model")
    placed = SHD.place(params, specs, mesh)
    with pytest.raises(NotImplementedError, match="inside a head"):
        SHD.sharded_forward(placed, cfg, {"tokens": torch.zeros((2, 4), dtype=torch.long)},
                            mesh)


def _layer_payloads(cfg, grid, mixer: str, s: int = 8, step: bool = False):
    """One mixer sub-layer (the first group's l0 for rwkv, l0 for Mamba;
    with ``step`` one token from a zero cache, no gradient) of one data
    block of 2 rows over a (data, model) CPU grid, forward and backward
    (the parameters' blocks as leaves that take gradients, as the train
    step reads them), counted: (collective bytes, counts)."""
    mesh = cpu_mesh(grid)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    for pl in tree_flatten(placed)[0]:
        for b in pl.blocks.values():
            b.requires_grad_(not step)
    layer = SHD._groups(placed["blocks"], cfg.n_groups)[0]["l0"][mixer]
    h = torch.randn((2, 1 if step else s, cfg.d_model),
                    generator=torch.Generator().manual_seed(1), requires_grad=not step)
    row = SHD._Row(cfg, mesh, {"data": 0}, "torch")
    fn = SHD._rwkv if mixer == "rwkv" else SHD._mamba
    cache = None
    if step:
        full = SHD.sharded_init_cache(cfg, 2, 16, mesh)
        cache = SHD._groups(SHD._row_view(full, row), cfg.n_groups)[0]["l0"]
    with OpCounter(mesh) as counter:
        y = fn(row, layer, h, cache, step=step)
        if not step:
            y.sum().backward()
    an = counter.analysis()
    return an["collective_bytes"], an["collective_counts"]


def test_payloads_of_one_rwkv_layer_by_hand():
    """float32, 2 x 8 tokens of D = 64 over 4 'model' positions, T = 16.
    Forward: the sum of squares for ln_x, one all-reduce of (T, 1), and
    wo's partial sums, one of (T, D). Backward: the all-reduces of the
    gradients of the four mixes and of the LoRA's first product that every
    position read (4 of (T, D), one of (T, 64)) and of the mean square (T,
    1); the all-gathers of the gradients of the replicated leaves each
    position reads a slice of (w0 (D), w_lora_b (64, D), ln_x's scale
    (D)). One decode step moves the same forward payloads for T = 2."""
    cfg = port_config("rwkv6/2x4")
    d, t, rank = cfg.d_model, 16, 64
    got, counts = _layer_payloads(cfg, (1, 4), "rwkv")
    assert counts["all-reduce"] == 2 + 5 + 1
    assert got["all-reduce"] == (t + t * d) * 4 + (4 * t * d + t * rank) * 4 + t * 4
    assert counts["all-gather"] == 3
    assert got["all-gather"] == (d + rank * d + d) * 4
    assert counts["reduce-scatter"] == counts["all-to-all"] == 0
    got, counts = _layer_payloads(cfg, (1, 4), "rwkv", step=True)
    assert counts["all-reduce"] == 2 and got["all-reduce"] == (2 + 2 * d) * 4
    assert sum(counts.values()) == 2


def test_payloads_of_one_mamba_layer_by_hand():
    """float32, 2 x 8 tokens of D = 64 (din = 128, dt_rank 4, N = 16) over 4
    'model' positions, T = 16. Forward: the x/z re-split, one all-to-all
    of a position's block of in_proj's product (T, 2 din / 4); x_proj's
    partial sums (T, dt_rank + 2N) and out_proj's (T, D), two all-reduces.
    Backward: the reverse all-to-all, and the all-reduces of the
    gradients of h and of the summed projection that every position read.
    One decode step moves the forward payloads for T = 2."""
    cfg = port_config("jamba4/2x2")
    d, t = cfg.d_model, 16
    din, proj = cfg.mamba_expand * d, max(1, d // 16) + 2 * cfg.mamba_d_state
    got, counts = _layer_payloads(cfg, (1, 4), "mamba")
    assert counts["all-to-all"] == 2 and got["all-to-all"] == 2 * t * (2 * din // 4) * 4
    assert counts["all-reduce"] == 2 + 2
    assert got["all-reduce"] == (t * proj + t * d) * 4 + (t * d + t * proj) * 4
    assert counts["all-gather"] == counts["reduce-scatter"] == 0
    got, counts = _layer_payloads(cfg, (1, 4), "mamba", step=True)
    assert counts["all-to-all"] == 1 and got["all-to-all"] == 2 * (2 * din // 4) * 4
    assert counts["all-reduce"] == 2 and got["all-reduce"] == (2 * proj + 2 * d) * 4


def _count_step(key, device):
    _arch, _experts, grid, opt_name = CASES[key]
    cfg = port_config(key)
    if cfg.mixer == "rwkv":
        cfg = dataclasses.replace(cfg, n_layers=1)
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


@pytest.mark.parametrize("key", ["rwkv6/2x4", "jamba16/2x4"])
def test_ssm_sharded_step_counts_on_meta_equal_the_cpu_counts(key):
    """The sharded train step (rwkv6 at one layer, chunked WKV; jamba's one
    group of 8 layers: Mamba scans under gradients, attention with the KV
    heads gathered, the manual MoE, Adafactor) traced on CPU tensors (every
    position and scan step) and on meta tensors (representatives where
    they apply): flops, bytes, payloads and counts equal."""
    got = []
    for device in ("cpu", "meta"):
        h = _count_step(key, device).analysis()
        got.append((h["flops"], h["bytes"], h["collective_bytes"], h["collective_counts"]))
    assert got[0] == got[1]
    assert got[0][0] > 0 and got[0][3]["all-reduce"] > 0

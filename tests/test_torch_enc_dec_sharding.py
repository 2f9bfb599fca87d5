"""Tensor parallelism over 'model' for whisper's encoder-decoder in the port
(``repro_torch.models.sharded``'s encoder, cross-attention and cross cache;
``train.make_sharded_train_step`` with AdamW and ZeRO-1) against the
reference's GSPMD runs on the CPU.

The reference runs once for this module, in one subprocess with 8 forced
host devices (``run_reference``), both cases one after the other: its own
``repro.launch.dryrun.sharded_arch(..., dp_shards=|data|)`` of the config,
``jax.jit`` of ``make_train_step(..., jit_compile=False)`` over a state
placed by the sanitized ``train_state_pspecs`` (2 steps), then ``forward``,
``prefill`` and 4 ``decode_step`` s over parameters placed by
``param_pspecs`` and a cache by ``cache_pspecs``. The port starts from the
same parameters (``params_from_arrays``) and runs the same batches (tokens
and frame embeddings) over a (data, model) grid of CPU positions.

Cases: smoke whisper-medium on (data 2, model 4) with 16 encoder frames
(4 divides 16: the cross cache split along the frames, decode merging the
positions' partial softmax sums by log-sum-exp) and on (2, 2) with 15 frames
(2 does not divide 15: the sanitized specs move 'model' onto head_dim, and
decode sums the positions' partial q·kᵀ). Tolerances, float32 throughout:
loss, grad norm and lr within 1e-4 relative; every parameter within 1e-5
but the K projections' biases (``K_BIASES``), whose true gradient is zero
(a bias on the keys adds one constant to a query's scores, which the
softmax cancels): their gradient is rounding noise, which AdamW turns into
steps of up to lr a step in both frameworks alike, so they are held to
2 lr x steps; the forward's, the prefill's and each decode step's logits
within 1e-5.

The sharded step's, prefill's and decode's counts on meta tensors equal
their counts on CPU tensors, each position's heads go through one
attention call an encoder, decoder and cross layer, and a cross cache split
along its heads raises.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.mesh import P, make_mesh
from repro_torch.models import attention as A
from repro_torch.models import model as TM
from repro_torch.models import params_from_arrays
from repro_torch.models import sharded as SHD
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import TrainState, make_sharded_train_step
from repro_torch.utils import tree_flatten, tree_flatten_with_paths
from tests.test_torch_data_parallel import run_reference

#: case -> ((data, model), encoder frames)
CASES = {"frames/2x4": ((2, 4), 16), "head_dim/2x2": ((2, 2), 15)}
STEPS = 2
BATCH, SEQ = 4, 16  # train batch: 2 rows a data block
PROMPT, MAX_SEQ, DECODE = 12, 32, 4
LR = (3e-4, 2, 10)  # warmup_cosine: the data-parallel tests' schedule
#: the leaves whose gradient is zero but for rounding (the module's docstring)
K_BIASES = ("['wk']['b']",)


def config(frames, smoke):
    return dataclasses.replace(smoke("whisper-medium"), frontend_len=frames)


def train_batch(cfg, step: int) -> dict:
    rng = np.random.default_rng(300 + step)
    return {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32),
            "frames": rng.standard_normal((BATCH, cfg.frontend_len, cfg.d_model)).astype(
                np.float32)}


def prompt_batch(cfg) -> dict:
    rng = np.random.default_rng(27)
    return {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32),
            "frames": rng.standard_normal((BATCH, cfg.frontend_len, cfg.d_model)).astype(
                np.float32)}


def decode_tokens(cfg, t: int) -> np.ndarray:
    return np.random.default_rng(70 + t).integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32)


REFERENCE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.compat import AxisType, make_mesh, set_mesh
from repro.configs import get_smoke
assert len(jax.devices()) == 8, jax.devices()
from repro.launch import sharding as SH
from repro.launch.dryrun import sharded_arch
from repro.models import model as RM
from repro.optim import adamw, warmup_cosine
from repro.train import loop
from tests.test_torch_enc_dec_sharding import (CASES, DECODE, LR, MAX_SEQ, PROMPT, STEPS, config,
                                               decode_tokens, prompt_batch, train_batch)

out = sys.argv[1]
res = {}
dp = ("data",)


def put(tree, specs, mesh):
    return jax.device_put(tree, SH.to_named(specs, mesh))


def placed_batch(batch, mesh):
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    return put(batch, SH.sanitize_specs(batch, SH.batch_pspecs(batch, dp), mesh), mesh)


for key, (grid, frames) in CASES.items():
    cfg = sharded_arch(config(frames, get_smoke), False, dp_shards=grid[0])
    mesh = make_mesh(grid, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:grid[0] * grid[1]])
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
        res[f"{key}/init/{i}"] = np.asarray(leaf)
    opt = adamw()
    state = loop.TrainState(params=params, opt_state=opt[0](params), step=jnp.int32(0))
    specs = SH.sanitize_specs(state, SH.train_state_pspecs(state, dp, mesh), mesh)
    step = jax.jit(loop.make_train_step(cfg, opt, warmup_cosine(*LR), jit_compile=False),
                   out_shardings=(SH.to_named(specs, mesh), None))
    with set_mesh(mesh):
        state = put(state, specs, mesh)
        for s in range(STEPS):
            state, m = step(state, placed_batch(train_batch(cfg, s), mesh))
            for name, v in m.items():
                res[f"{key}/{s}/{name}"] = np.asarray(v)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(state.params)):
            res[f"{key}/params/{i}"] = np.asarray(leaf)
        pspecs = SH.sanitize_specs(params, SH.param_pspecs(params), mesh)
        pp = put(params, pspecs, mesh)
        fwd = train_batch(cfg, 0)
        fwd = placed_batch({"tokens": fwd["tokens"], "frames": fwd["frames"]}, mesh)
        logits, _aux = jax.jit(lambda p, b: RM.forward(p, cfg, b))(pp, fwd)
        res[f"{key}/forward"] = np.asarray(logits)
        prompt = placed_batch(prompt_batch(cfg), mesh)
        logits, cache = jax.jit(lambda p, b: RM.prefill(p, cfg, b, MAX_SEQ))(pp, prompt)
        res[f"{key}/prefill"] = np.asarray(logits)
        cspecs = SH.sanitize_specs(cache, SH.cache_pspecs(cache, dp), mesh)
        res[f"{key}/cross_spec"] = np.asarray(str(cspecs["l0"]["cross_k"]))
        cache = put(cache, cspecs, mesh)
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
    """The reference's runs of both cases, in one subprocess."""
    out = tmp_path_factory.mktemp("enc_dec_sharding") / "ref.npz"
    run_reference(REFERENCE, out)
    return dict(np.load(out))


def port_config(key):
    return dryrun.sharded_arch(config(CASES[key][1], get_smoke), False)


def init_tree(want: dict, key: str, cfg):
    """The reference's initial parameters of a case as the port's tree."""
    leaves, rebuild = tree_flatten(TM.meta_params(cfg))
    arrays = rebuild([want[f"{key}/init/{i}"] for i in range(len(leaves))])
    return params_from_arrays(arrays, cfg, device="cpu")


def cpu_mesh(grid):
    return make_mesh(grid, ("data", "model"), ["cpu"] * (grid[0] * grid[1]))


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("key", list(CASES))
def test_enc_dec_sharded_train_step_matches_the_reference(ref, key):
    """Two steps of make_sharded_train_step (AdamW, ZeRO-1 over 'data') from
    the reference's parameters over the case's grid: loss, grad norm and lr
    within 1e-4 relative at each step; every parameter within 1e-5 after
    the second, the K biases within 2 lr x steps (the module's
    docstring)."""
    grid = CASES[key][0]
    cfg = port_config(key)
    params = init_tree(ref, key, cfg)
    opt = adamw()
    state = TrainState(params=params, opt_state=opt[0](params),
                       step=torch.zeros((), dtype=torch.int32))
    mesh = cpu_mesh(grid)
    placed = SHD.place_train_state(state, mesh)
    step = make_sharded_train_step(cfg, opt, warmup_cosine(*LR), mesh)
    for s in range(STEPS):
        placed, m = step(placed, tensors(train_batch(cfg, s)))
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[name]), ref[f"{key}/{s}/{name}"], rtol=1e-4,
                                       atol=1e-12, err_msg=f"step {s} {name}")
    back = SHD.unplace_train_state(placed)
    paths, leaves, _ = tree_flatten_with_paths(back.params)
    biases = 0
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        noise = path.endswith(K_BIASES)
        biases += noise
        np.testing.assert_allclose(leaf.detach().numpy(), ref[f"{key}/params/{i}"], rtol=0,
                                   atol=2 * LR[0] * STEPS if noise else 1e-5, err_msg=path)
    assert biases == 3  # the encoder's, the decoder's self- and cross-attention's


@pytest.mark.parametrize("key", list(CASES))
def test_enc_dec_sharded_forward_matches_the_reference(ref, key):
    """sharded_forward of the first train batch's tokens and frames over the
    case's grid: the logits, gathered over 'model', within 1e-5 of the
    reference's forward under the same specs."""
    grid = CASES[key][0]
    cfg = port_config(key)
    params = init_tree(ref, key, cfg)
    mesh = cpu_mesh(grid)
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    batch = train_batch(cfg, 0)
    logits, aux = SHD.sharded_forward(placed, cfg, tensors(
        {"tokens": batch["tokens"], "frames": batch["frames"]}), mesh)
    want = ref[f"{key}/forward"]
    assert logits.shape == want.shape and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", list(CASES))
def test_enc_dec_sharded_prefill_and_decode_match_the_reference(ref, key):
    """sharded_prefill of the prompt over its frames (the cross cache in
    the sanitized layout the reference's own specs name: along the frames
    on (2, 4), along head_dim on (2, 2)) and 4 sharded_decode_step s: each
    step's logits within 1e-5 of the reference's GSPMD run."""
    grid, frames = CASES[key]
    cfg = port_config(key)
    params = init_tree(ref, key, cfg)
    mesh = cpu_mesh(grid)
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    logits, cache = SHD.sharded_prefill(placed, cfg, tensors(prompt_batch(cfg)), MAX_SEQ, mesh)
    spec = cache["l0"]["cross_k"].spec
    assert str(ref[f"{key}/cross_spec"]) == "PartitionSpec" + repr(spec)[1:]
    assert spec == (P(None, "data", "model", None, None) if frames % grid[1] == 0 else
                    P(None, "data", None, None, "model"))
    np.testing.assert_allclose(logits.numpy(), ref[f"{key}/prefill"], rtol=1e-5, atol=1e-5)
    for t in range(DECODE):
        toks = torch.from_numpy(decode_tokens(cfg, t))
        logits, cache = SHD.sharded_decode_step(placed, cfg, cache, toks, PROMPT + t, mesh)
        np.testing.assert_allclose(logits.numpy(), ref[f"{key}/decode/{t}"], rtol=1e-5,
                                   atol=1e-5, err_msg=f"decode step {t}")


@pytest.mark.parametrize("key", list(CASES))
def test_the_cross_cache_is_split_as_cache_pspecs_says(key):
    """The prefilled cross cache's blocks, whole again, equal prefill's on
    one device (within 1e-5), and each block is a data block's rows with
    the frames or head_dim divided by |model|."""
    grid, frames = CASES[key]
    cfg = port_config(key)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    mesh = cpu_mesh(grid)
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    prompt = tensors(prompt_batch(cfg))
    _, cache = SHD.sharded_prefill(placed, cfg, prompt, MAX_SEQ, mesh)
    _, want = TM.prefill(params, cfg, prompt, MAX_SEQ, impl="torch")
    whole = SHD.unplace(cache)
    along = 2 if frames % grid[1] == 0 else 4
    for name in ("cross_k", "cross_v"):
        pl = cache["l0"][name]
        shape = list(pl.shape)
        shape[1] //= grid[0]
        shape[along] //= grid[1]
        assert all(list(b.shape) == shape for b in pl.blocks.values()), name
        np.testing.assert_allclose(whole["l0"][name].numpy(), want["l0"][name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_each_position_runs_its_heads_once_a_layer(monkeypatch):
    """A prefill of one data block per position over (1, 4): each of the 4
    'model' positions (one head each) runs one non-causal self-attention an
    encoder layer, one causal one and one cross-attention (its queries over
    the 16 frames) a decoder layer; decode runs none of them."""
    calls = []

    def spy(name):
        real = getattr(A, name)

        def call(q, k, v, **kw):
            calls.append((name, kw.get("causal"), q.shape[1], k.shape[1]))
            return real(q, k, v, **kw)
        return call

    for name in ("self_attention", "cross_attention"):
        monkeypatch.setattr(A, name, spy(name))
    cfg = port_config("frames/2x4")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    mesh = cpu_mesh((1, 4))
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    _, cache = SHD.sharded_prefill(placed, cfg, tensors(prompt_batch(cfg)), MAX_SEQ, mesh)
    f = cfg.frontend_len
    want = ([("self_attention", False, f, f)] * cfg.encoder_layers * 4
            + [("self_attention", True, PROMPT, PROMPT), ("cross_attention", None, PROMPT, f)]
            * cfg.n_layers * 4)
    assert sorted(calls, key=str) == sorted(want, key=str)
    calls.clear()
    SHD.sharded_decode_step(placed, cfg, cache, torch.from_numpy(decode_tokens(cfg, 0)), PROMPT,
                            mesh)
    assert calls == []


def test_a_cross_cache_split_along_its_heads_raises():
    """A cross cache placed over 'model' along its KV heads is neither of
    the sanitized layouts: decode raises rather than read it."""
    cfg = port_config("frames/2x4")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    mesh = cpu_mesh((1, 2))
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    prompt = tensors(prompt_batch(cfg))
    _, cache = TM.prefill(params, cfg, prompt, MAX_SEQ, impl="torch")
    specs = SHD.cache_specs(cache, mesh, ("data",))
    for layer in specs.values():
        for name in ("cross_k", "cross_v"):
            layer[name] = P(None, "data", None, "model", None)
    cache = SHD.place(cache, specs, mesh)
    with pytest.raises(NotImplementedError, match="cross cache split"):
        SHD.sharded_decode_step(placed, cfg, cache, torch.from_numpy(decode_tokens(cfg, 0)),
                                PROMPT, mesh)


def _count(kind: str, grid, frames: int, device: str):
    """One sharded train step, prefill or decode step of the smoke whisper
    with ``frames`` encoder frames on a (data, model) grid of ``device``
    positions, counted (representatives on meta)."""
    cfg = dataclasses.replace(config(frames, get_smoke), n_layers=1, encoder_layers=1)
    mesh = make_mesh(grid, ("data", "model"), [device] * (grid[0] * grid[1]))
    params = (TM.meta_params(cfg) if device == "meta" else
              TM.init_params(torch.Generator().manual_seed(0), cfg, device=device))
    toks = torch.zeros((BATCH, 8), dtype=torch.long, device=device)
    feats = torch.zeros((BATCH, frames, cfg.d_model), device=device)
    represent = device == "meta"
    if kind == "train":
        opt = adamw()
        state = SHD.place_train_state(TrainState(params=params, opt_state=opt[0](params),
                                                 step=torch.zeros((), dtype=torch.int32)), mesh)
        step = make_sharded_train_step(cfg, opt, warmup_cosine(*LR), mesh, impl="torch")
        with OpCounter(mesh, represent=represent) as c:
            step(state, {"tokens": toks, "labels": toks, "frames": feats})
        return c
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    if kind == "prefill":
        with OpCounter(mesh, represent=represent) as c:
            SHD.sharded_prefill(placed, cfg, {"tokens": toks, "frames": feats}, MAX_SEQ, mesh,
                                impl="torch")
        return c
    cache = SHD.sharded_init_cache(cfg, BATCH, MAX_SEQ, mesh, enc_len=frames,
                                   device="meta" if represent else None)
    with OpCounter(mesh, represent=represent) as c:
        SHD.sharded_decode_step(placed, cfg, cache, toks[:, :1], 5, mesh)
    return c


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("key", list(CASES))
def test_enc_dec_counts_on_meta_equal_the_cpu_counts(kind, key):
    """The sharded train step, prefill and decode step (one encoder and one
    decoder layer) traced on CPU tensors (every position) and on meta
    tensors (representatives where they apply): flops, bytes, payloads and
    counts equal, for the cross cache along the frames and along
    head_dim."""
    grid, frames = CASES[key]
    got = []
    for device in ("cpu", "meta"):
        h = _count(kind, grid, frames, device).analysis()
        got.append((h["flops"], h["bytes"], h["collective_bytes"], h["collective_counts"]))
    assert got[0] == got[1]
    assert got[0][0] > 0 and got[0][3]["all-reduce"] > 0

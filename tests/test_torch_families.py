"""The port's moe, ssm, hybrid, audio and vlm families (``repro_torch.models``:
``moe``, ``ssm`` and the branches of ``model``) against ``repro``'s on the
same weights (``params_from_arrays``) and the same seeded inputs (tokens,
whisper's stub frames, llava's patch embeddings), at the smoke configs in
float32.

Tolerances, each stated beside its check: logits within 1e-4 (as
tests/test_torch_lm.py), the MoE aux loss within 1e-6; greedy tokens equal;
the MoE kept set (which (token, choice) pairs reach their expert under
capacity) bit for bit; the mixers within 1e-5 of the reference, the chunked
WKV held as the reference holds it (tests/test_models.py:206-232); the loss
within 1e-5 relative and the gradients within 1e-4 relative plus 1e-6 of a
leaf's largest (as tests/test_torch_train.py). Nothing is held bit for bit
in bf16 here: the MoE combine sums k gated expert outputs, which XLA's
reduce and torch's sum may add in different orders.

The kernel route on the card is held in ``chip_smoke.py``'s ``families``
phase; here the flash op is swapped for its plain version to check which
calls reach it with which shapes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_arch
from repro.configs import get_smoke as ref_smoke
from repro.data.tokens import SyntheticTokenStream as JStream
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.models import ssm as RS
from repro.models import taco_attention as RT
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro.train import loop as jloop
from repro_torch.configs import get_arch, get_smoke
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import params_from_arrays
from repro_torch.models import ssm as TS
from repro_torch.models import taco_attention as TT
from repro_torch.serving import Request, ServingEngine
from repro_torch.train import loss_fn
from repro_torch.utils import tree_flatten

TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ["granite-moe-3b-a800m", "arctic-480b", "rwkv6-7b", "jamba-1.5-large-398b",
            "whisper-medium", "llava-next-mistral-7b"]
#: one config of each family the slot engine serves (a frontend cannot be)
SERVED = ["granite-moe-3b-a800m", "rwkv6-7b", "jamba-1.5-large-398b"]


@pytest.fixture(scope="module")
def models():
    """arch -> (reference cfg, port cfg, reference params, port params), one
    model per arch (and per config change) for the file."""
    cache = {}

    def get(arch, **kw):
        key = (arch, tuple(sorted(kw.items())))
        if key not in cache:
            ref_cfg = dataclasses.replace(ref_smoke(arch), **kw)
            port_kw = dict(kw)
            if "retrieval" in kw:
                port_kw["retrieval"] = TT.RetrievalConfig(**dataclasses.asdict(kw["retrieval"]))
            port_cfg = dataclasses.replace(get_smoke(arch), **port_kw)
            rp = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
            tp = params_from_arrays(jax.tree.map(np.asarray, rp), port_cfg, device="cpu")
            cache[key] = ref_cfg, port_cfg, rp, tp
        return cache[key]

    return get


def _batch(cfg, seed=0, shape=(2, 12)) -> dict:
    """Seeded numpy inputs: tokens, and the frontend's stub embeddings."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape)}
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal((shape[0], cfg.frontend_len, cfg.d_model)) * 0.1
    if cfg.frontend == "vlm":
        batch["patch_embeds"] = rng.standard_normal((shape[0], cfg.frontend_len,
                                                     cfg.d_model)) * 0.1
    return {k: v.astype(np.float32) if k != "tokens" else v for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
            for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_reference(models, arch):
    """Logits within 1e-4 of the jitted reference, the summed MoE aux loss
    within 1e-6 (0 without experts)."""
    ref_cfg, port_cfg, rp, tp = models(arch)
    batch = _batch(ref_cfg)
    want, want_aux = jax.jit(lambda p, b: RM.forward(p, ref_cfg, b))(rp, _jax(batch))
    got, aux = TM.forward(tp, port_cfg, _torch(batch))
    assert got.dtype == torch.float32 and got.shape == (2, 12, port_cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0, atol=1e-6)
    assert (float(aux) > 0) == bool(port_cfg.n_experts)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_matches_reference(models, arch):
    """Prefill 8 tokens (behind llava's patches, after whisper's encoder),
    teacher-force 4: each step's logits within 1e-4 of the reference's
    chain and its greedy token equal. The MoE configs keep their capacity
    (a batch of 2 drops tokens in both packages alike)."""
    ref_cfg, port_cfg, rp, tp = models(arch)
    batch = _batch(ref_cfg, seed=1)
    pre = dict(batch, tokens=batch["tokens"][:, :8])
    offset = ref_cfg.frontend_len if ref_cfg.frontend == "vlm" else 0
    max_seq = 32 + offset
    rlogits, rcache = jax.jit(lambda p, b: RM.prefill(p, ref_cfg, b, max_seq))(rp, _jax(pre))
    rstep = jax.jit(lambda p, c, t, pos: RM.decode_step(p, ref_cfg, c, t, pos))
    logits, cache = TM.prefill(tp, port_cfg, _torch(pre), max_seq)
    tokens = batch["tokens"]
    for t in range(8, 12):
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL,
                                   err_msg=f"before step {t}")
        np.testing.assert_array_equal(logits.argmax(-1).numpy(), np.asarray(rlogits).argmax(-1))
        step = tokens[:, t:t + 1]
        logits, cache = TM.decode_step(tp, port_cfg, cache, torch.from_numpy(step), t + offset)
        rlogits, rcache = rstep(rp, rcache, jnp.asarray(step, jnp.int32), t + offset)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_matches_reference_at_full_width(arch):
    """The port's parameter layout of every full config (keys, shapes,
    dtypes: a_log float32 under jamba's bf16 parameters) equals the
    reference's ``init_params`` traced abstractly (nothing is allocated)."""
    want = jax.eval_shape(lambda k: RM.init_params(k, ref_arch(arch)), jax.random.PRNGKey(0))
    cfg = get_arch(arch)
    got = TM.map_tree(lambda leaf: (tuple(leaf.shape), str(
        getattr(torch, leaf.dtype) if leaf.dtype else cfg.pdtype).removeprefix("torch.")),
        TM.param_layout(cfg))
    assert got == _shapes(want)


def test_init_draws_follow_the_reference():
    """init_params draws each leaf as the reference's init does: RWKV's
    mixes uniform on [0, 1), w0 the constant -2 (so the decay exp(-exp(w0 +
    lora)) sits near 0.87, inside the chunked WKV's bound), u ~ 0.1;
    Mamba's a_log = log(1..N) in float32, d ones, conv_b zeros; whisper's
    positions ~ 0.02."""
    gen = torch.Generator().manual_seed(0)
    rwkv = TM.init_params(gen, get_smoke("rwkv6-7b"), device="cpu")["blocks"]["l0"]
    mix = rwkv["rwkv"]["mu"]
    assert float(mix.min()) >= 0 and float(mix.max()) < 1 and float(mix.std()) > 0.2
    assert rwkv["rwkv"]["w0"].eq(-2).all() and rwkv["ffn"]["mu"].max() < 1
    assert 0.07 < float(rwkv["rwkv"]["u"].std()) < 0.13
    jamba = dataclasses.replace(get_smoke("jamba-1.5-large-398b"), param_dtype="bfloat16")
    mamba = TM.init_params(gen, jamba, device="cpu")["blocks"]["l0"]["mamba"]
    assert mamba["a_log"].dtype == torch.float32 and mamba["d"].dtype == torch.bfloat16
    want = torch.log(torch.arange(1, jamba.mamba_d_state + 1, dtype=torch.float32))
    assert torch.equal(mamba["a_log"][0], want.expand(128, -1))
    assert mamba["d"].eq(1).all() and mamba["conv_b"].eq(0).all()
    whisper = TM.init_params(gen, get_smoke("whisper-medium"), device="cpu")
    assert 0.015 < float(whisper["encoder"]["pos"].std()) < 0.025
    assert 0.015 < float(whisper["dec_pos"].std()) < 0.025


def _ref_kept(p, x, n_experts, k, capacity_factor):
    """The reference's routing (repro/models/moe.py:142-161, one chunk), as
    its own lines compute it: (expert ids (T, k), kept (k·T,))."""
    t = x.shape[0] * x.shape[1]
    cap = max(1, int(t * k * capacity_factor / n_experts))
    logits = (x.reshape(t, -1) @ p["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, exp_idx = jax.lax.top_k(probs, k)
    fe = exp_idx.T.reshape(-1)
    oh = jax.nn.one_hot(fe, n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(oh, axis=0) - 1) * oh, axis=1)
    return np.asarray(exp_idx), np.asarray(pos < cap)


def _dense_topk(p, x, k):
    """The MoE without capacity: each token's k experts' FFNs, gated."""
    x2 = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(x2 @ p["router"], -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :k] / vals[:, :k].sum(-1, keepdim=True)
    out = torch.zeros_like(x2)
    for j in range(k):
        e = idx[:, j]
        gate = torch.einsum("td,tdf->tf", x2, p["gate"][e])
        up = torch.einsum("td,tdf->tf", x2, p["up"][e])
        y = torch.einsum("tf,tfd->td", gate * torch.sigmoid(gate) * up, p["down"][e])
        out = out + gates[:, j, None] * y
    return out.reshape(x.shape)


@pytest.mark.parametrize("capacity", ["1.25", "n_experts"])
def test_moe_apply_matches_reference(capacity):
    """moe_apply against the reference's on the same weights and tokens
    (tests/test_models.py:235's shapes: 4 experts, top 2, 32 tokens): the
    kept set bit for bit, the output within 1e-5, the aux loss within 1e-6.
    The tokens lean toward expert 0 (31 of the 64 choices), so at capacity
    1.25 (20 a expert) it drops 11; at capacity_factor = n_experts none is
    dropped, and the output is the dense top-k mixture (within 1e-5)."""
    e, k = 4, 2
    cf = 1.25 if capacity == "1.25" else float(e)
    rp = RMOE.moe_init(jax.random.PRNGKey(0), 16, 32, e)
    lean = rp["router"][:, 0] / jnp.linalg.norm(rp["router"][:, 0])
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 16)) + 2.0 * lean
    want, want_aux = RMOE.moe_apply(rp, x, n_experts=e, experts_per_token=k,
                                    capacity_factor=cf)
    tp = {n: torch.from_numpy(np.array(v)) for n, v in rp.items()}
    tx = torch.from_numpy(np.array(x))
    seen = []
    route = TMOE.route

    def spy(*a):
        out = route(*a)
        seen.append(out)
        return out

    TMOE.route = spy
    try:
        got, aux = TMOE.moe_apply(tp, tx, n_experts=e, experts_per_token=k, capacity_factor=cf)
    finally:
        TMOE.route = route
    ref_idx, ref_keep = _ref_kept(rp, x, e, k, cf)
    exp_idx, _gates, _fe, _pos, keep = seen[0]
    np.testing.assert_array_equal(exp_idx.numpy(), ref_idx)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    assert int((~keep).sum()) == (11 if capacity == "1.25" else 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0, atol=1e-6)
    if capacity == "n_experts":
        np.testing.assert_allclose(got.numpy(), _dense_topk(tp, tx, k).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_route_takes_the_lowest_expert_first_on_ties():
    """Exact ties in the router's probabilities go to the lowest expert id,
    as jax.lax.top_k orders them; positions count slot-major."""
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                          [0.4, 0.1, 0.4, 0.1], [0.3, 0.2, 0.3, 0.2]])
    exp_idx, gates, fe, pos, keep = TMOE.route(probs, 2, 2)
    _, want = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(exp_idx.numpy(), np.asarray(want))
    assert exp_idx.tolist() == [[0, 1], [1, 3], [0, 2], [0, 2]]
    assert fe.tolist() == [0, 1, 0, 0, 1, 3, 2, 2]
    assert pos.tolist() == [0, 0, 1, 2, 1, 0, 0, 1]
    assert keep.tolist() == [True, True, True, False, True, True, True, True]
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.fixture(scope="module")
def rwkv_weights():
    """RWKV6 time-mix weights (d 64, head 16) in both packages, and an
    input of 96 steps."""
    rp = RS.rwkv6_init(jax.random.PRNGKey(0), 64, 16)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 96, 64))
    return rp, {n: _to_torch(v) for n, v in rp.items()}, x, _to_torch(x)


def _to_torch(v):
    if isinstance(v, dict):
        return {n: _to_torch(w) for n, w in v.items()}
    return torch.from_numpy(np.array(v))


@pytest.mark.parametrize("path", ["sequential", "chunked", "step"])
def test_rwkv6_matches_reference(rwkv_weights, path):
    """The WKV time mix along each path against the reference's same path
    on the same weights and input, with its decode state (return_state):
    output and float32 state within 1e-5; chunked also against the port's
    sequential path as tests/test_models.py:206 holds the reference's
    (2e-4 relative, 2e-5 absolute); a chain of steps from the zero state
    against the reference's steps and the port's sequential output."""
    rp, tp, x, tx = rwkv_weights
    if path == "sequential":
        want, (wxp, wst) = RS.rwkv6_time_mix_seq(rp, x, 16, return_state=True)
        got, (xp, st) = TS.rwkv6_time_mix_seq(tp, tx, 16, return_state=True)
    elif path == "chunked":
        want, (wxp, wst) = RS.rwkv6_time_mix_seq_chunked(rp, x, 16, 32, return_state=True)
        got, (xp, st) = TS.rwkv6_time_mix_seq_chunked(tp, tx, 16, 32, return_state=True)
        seq, (_, seq_st) = TS.rwkv6_time_mix_seq(tp, tx, 16, return_state=True)
        np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(st.numpy(), seq_st.numpy(), rtol=2e-4, atol=2e-5)
    else:
        wstate = (jnp.zeros((2, 64)), jnp.zeros((2, 4, 16, 16)))
        state = (torch.zeros((2, 64)), torch.zeros((2, 4, 16, 16)))
        want, got = [], []
        for t in range(x.shape[1]):
            y, wstate = RS.rwkv6_time_mix_step(rp, x[:, t], wstate, 16)
            want.append(np.asarray(y))
            y, state = TS.rwkv6_time_mix_step(tp, tx[:, t], state, 16)
            got.append(y)
        want, got = np.stack(want, 1), torch.stack(got, 1)
        (wxp, wst), (xp, st) = wstate, state
        seq = TS.rwkv6_time_mix_seq(tp, tx, 16)
        np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-5, atol=1e-5)
    assert st.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(wst), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(wxp))


def test_rwkv6_chunked_fast_decay_within_the_validity_bound():
    """tests/test_models.py:225 through both packages: w0 = 0.5 (log w in
    about [-4.5, -0.6]) at chunk 4 stays within the +30 clamp; the port's
    chunked path is finite and within 1e-3 / 1e-4 of the sequential one (the
    reference's tolerance), and within 1e-5 of the reference's chunked
    path."""
    rp = dict(RS.rwkv6_init(jax.random.PRNGKey(2), 32, 8), w0=jnp.full((32,), 0.5))
    x = jax.random.normal(jax.random.PRNGKey(3), (1, 64, 32))
    tp, tx = {n: _to_torch(v) for n, v in rp.items()}, _to_torch(x)
    got = TS.rwkv6_time_mix_seq_chunked(tp, tx, 8, chunk=4)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), TS.rwkv6_time_mix_seq(tp, tx, 8).numpy(),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(RS.rwkv6_time_mix_seq_chunked(rp, x, 8, chunk=4)),
                               rtol=1e-5, atol=1e-5)


def test_rwkv6_channel_mix_matches_reference():
    rp = RS.rwkv6_channel_mix_init(jax.random.PRNGKey(4), 64, 128)
    x = jax.random.normal(jax.random.PRNGKey(5), (2, 10, 64))
    xp = jax.random.normal(jax.random.PRNGKey(6), (2, 10, 64))
    got = TS.rwkv6_channel_mix(_to_torch(rp), _to_torch(x), _to_torch(xp))
    np.testing.assert_allclose(got.numpy(), np.asarray(RS.rwkv6_channel_mix(rp, x, xp)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("path", ["sequence", "steps"])
def test_mamba_matches_reference(path):
    """mamba_seq (causal conv + the sequential selective scan) with its
    decode state, and a chain of mamba_step from the zero state, against
    the reference's on the same weights (d 32, N 16, d_conv 4): outputs,
    the conv window and the float32 h within 1e-5; the steps' outputs
    also within 1e-5 of the port's sequence."""
    rp = RS.mamba_init(jax.random.PRNGKey(7), 32, 16, 4, 2)
    x = jax.random.normal(jax.random.PRNGKey(8), (2, 20, 32))
    tp, tx = _to_torch(rp), _to_torch(x)
    if path == "sequence":
        want, (wconv, wh) = RS.mamba_seq(rp, x, return_state=True)
        got, (conv, h) = TS.mamba_seq(tp, tx, return_state=True)
    else:
        wstate = (jnp.zeros((2, 3, 64)), jnp.zeros((2, 64, 16)))
        state = (torch.zeros((2, 3, 64)), torch.zeros((2, 64, 16)))
        want, got = [], []
        for t in range(x.shape[1]):
            y, wstate = RS.mamba_step(rp, x[:, t], wstate)
            want.append(np.asarray(y))
            y, state = TS.mamba_step(tp, tx[:, t], state)
            got.append(y)
        want, got = np.stack(want, 1), torch.stack(got, 1)
        (wconv, wh), (conv, h) = wstate, state
        np.testing.assert_allclose(got.numpy(), TS.mamba_seq(tp, tx).numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert h.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(conv.numpy(), np.asarray(wconv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), rtol=1e-5, atol=1e-5)


def test_hybrid_taco_decode_matches_reference(models):
    """jamba's smoke group (attention at position 4, Mamba elsewhere, MoE
    every other layer) with TaCo retrieval attention on its attention
    sub-layer (tests/test_models.py:74's retrieval config): the TaCo state
    lives only there, and prefill + 4 teacher-forced steps stay within 1e-4
    of the reference's chain with equal greedy tokens."""
    rc = RT.RetrievalConfig(n_subspaces=2, subspace_dim=4, sqrt_k=4, alpha=0.5,
                            n_retrieve=32, recent_window=4, kmeans_iters=2)
    ref_cfg, port_cfg, rp, tp = models("jamba-1.5-large-398b", attention_kind="taco",
                                       retrieval=rc)
    tokens = _batch(ref_cfg, seed=2)["tokens"]
    logits, cache = TM.prefill(tp, port_cfg, {"tokens": torch.from_numpy(tokens[:, :8])}, 32)
    assert [i for i in range(8) if "taco" in cache[f"l{i}"]] == [4]
    rlogits, rcache = jax.jit(lambda p, t: RM.prefill(p, ref_cfg, {"tokens": t}, 32))(
        rp, jnp.asarray(tokens[:, :8], jnp.int32))
    rstep = jax.jit(lambda p, c, t, pos: RM.decode_step(p, ref_cfg, c, t, pos))
    for t in range(8, 12):
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)
        np.testing.assert_array_equal(logits.argmax(-1).numpy(), np.asarray(rlogits).argmax(-1))
        step = tokens[:, t:t + 1]
        logits, cache = TM.decode_step(tp, port_cfg, cache, torch.from_numpy(step), t)
        rlogits, rcache = rstep(rp, rcache, jnp.asarray(step, jnp.int32), t)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)


#: a gradient's allowance beyond 1e-4 relative, as a share of its leaf's
#: largest: 1e-6 as tests/test_torch_train.py for the MoE; 5e-5 for the
#: hybrid, whose forward already moves 2e-5 from the reference's (XLA's and
#: torch's exp and log1p differ in the last bits, and the Mamba scan
#: compounds them over 16 steps and 7 layers), so its gradients differ by up
#: to 1.6e-5 of a leaf's largest, in every leaf alike
GRAD_FLOOR = {"granite-moe-3b-a800m": 1e-6, "jamba-1.5-large-398b": 5e-5}


@pytest.mark.parametrize("arch", list(GRAD_FLOOR))
def test_loss_and_gradients_match_jax_value_and_grad(models, arch):
    """loss_fn (aux_weight 0.01, remat on) and its gradients against
    jax.value_and_grad of the reference's: loss within 1e-5 relative, aux
    within 1e-6, every gradient within 1e-4 relative plus GRAD_FLOOR of its
    leaf's largest, the leaves in the same (sorted-key) order."""
    ref_cfg, port_cfg, rp, tp = models(arch)
    batch = JStream(ref_cfg.vocab_size, 16, 4, seed=0).batch(0)
    (jloss, jaux), jgrads = jax.value_and_grad(jloop.loss_fn, has_aux=True)(
        rp, ref_cfg, jax.tree.map(jnp.asarray, batch), 0.01)
    params = TM.map_tree(lambda t: t.clone(), tp)
    leaves, rebuild = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = loss_fn(rebuild(leaves), port_cfg,
                        {k: torch.as_tensor(v) for k, v in batch.items()}, 0.01)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=0, atol=1e-6)
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=GRAD_FLOOR[arch] * float(np.abs(w).max()))


def _route_calls(monkeypatch):
    calls = []

    def fake_cuda(q, k, v, causal):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return flash_attention_plain(q, k, v, causal)

    monkeypatch.setattr(ops, "flash_attention_cuda", fake_cuda)
    return calls


def test_whisper_kernel_route_layout(models, monkeypatch):
    """impl="kernel" with the CUDA launch swapped for the plain flash
    version: the encoder's self-attention (causal False, S = T = the
    frames), then a layer at a time the decoder's self-attention (causal,
    S = T = the prompt) and cross-attention (causal False, S the prompt, T
    the frames), each over (B·H, ·, hd); 3 calls a layer in forward and in
    prefill (72 at whisper-medium's 24 + 24 layers), and the plain path's
    logits within 1e-5."""
    _, cfg, _, tp = models("whisper-medium")
    calls = _route_calls(monkeypatch)
    batch = _torch(_batch(cfg, seed=3))
    bh, hd, t_enc = 2 * cfg.n_heads, cfg.hd, cfg.frontend_len
    enc = [((bh, t_enc, hd), (bh, t_enc, hd), False)] * cfg.encoder_layers
    dec = [((bh, 12, hd), (bh, 12, hd), True), ((bh, 12, hd), (bh, t_enc, hd), False)]
    got = TM.forward(tp, cfg, batch, impl="kernel")[0]
    assert calls == enc + dec * cfg.n_layers
    np.testing.assert_allclose(got.numpy(), TM.forward(tp, cfg, batch)[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    calls.clear()
    logits, cache = TM.prefill(tp, cfg, batch, 16, impl="kernel")
    assert calls == enc + dec * cfg.n_layers
    assert cache["l0"]["cross_k"].shape == (cfg.n_layers, 2, t_enc, cfg.n_kv_heads, hd)
    np.testing.assert_allclose(logits[:, 0].numpy(), got[:, -1].numpy(), rtol=1e-5, atol=1e-5)


def test_llava_kernel_route_covers_the_patch_prefix(models, monkeypatch):
    """llava's causal prefill runs over the patches and the prompt (S = P +
    12) in one launch a layer, with K/V expanded to the query heads; the
    logits sliced after the patches."""
    _, cfg, _, tp = models("llava-next-mistral-7b")
    calls = _route_calls(monkeypatch)
    batch = _torch(_batch(cfg, seed=4))
    s = cfg.frontend_len + 12
    got = TM.forward(tp, cfg, batch, impl="kernel")[0]
    assert calls == [((2 * cfg.n_heads, s, cfg.hd), (2 * cfg.n_heads, s, cfg.hd), True)] \
        * cfg.n_layers
    assert got.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), TM.forward(tp, cfg, batch)[0].numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
def test_frontend_configs_refuse_token_only_inputs(models, arch):
    """A token-only batch (what the engine's Request carries) raises
    ValueError naming the missing input, in forward, prefill, the engine
    and the launcher (the reference's prefill fails with a KeyError)."""
    _, cfg, _, tp = models(arch)
    key = "frames" if arch == "whisper-medium" else "patch_embeds"
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match=key):
        TM.forward(tp, cfg, {"tokens": tokens})
    with pytest.raises(ValueError, match=key):
        TM.prefill(tp, cfg, {"tokens": tokens}, 16)
    with pytest.raises(ValueError, match="token-only"):
        ServingEngine(tp, cfg, max_seq=16, batch_slots=1, device="cpu").generate(
            [Request(prompt=[1, 2, 3], max_new_tokens=2)])
    with pytest.raises(ValueError, match=key):
        serve_launcher.main(["--device", "cpu", "--smoke", "--arch", arch, "--requests", "1",
                             "--max-new", "2"])


@pytest.mark.parametrize("arch", SERVED)
def test_engine_matches_reference_engine(models, arch):
    """The slot engine over a moe, an ssm and a hybrid config: the same
    greedy tokens as the reference's engine on the same weights and
    prompts (5 requests, 2 slots: slots at different depths share a batch,
    and a MoE decode step routes them together in both packages)."""
    ref_cfg, port_cfg, rp, tp = models(arch)
    rng = np.random.default_rng(5)
    reqs = [dict(prompt=rng.integers(0, port_cfg.vocab_size, n).tolist(), max_new_tokens=5)
            for n in (5, 9, 7, 6, 8)]
    port = ServingEngine(tp, port_cfg, max_seq=32, batch_slots=2, device="cpu").generate(
        [Request(**r) for r in reqs])
    ref = RefEngine(rp, ref_cfg, max_seq=32, batch_slots=2).generate(
        [RefRequest(**r) for r in reqs])
    assert [len(o) for o in port] == [5] * 5
    assert port == ref


@pytest.mark.parametrize("arch", SERVED)
def test_serve_launcher_on_the_cpu(arch, capsys):
    outs = serve_launcher.main(["--device", "cpu", "--smoke", "--arch", arch, "--requests", "3",
                                "--max-new", "4", "--slots", "2", "--max-seq", "64"])
    assert [len(o) for o in outs] == [4, 4, 4]
    assert capsys.readouterr().out.startswith("served 3 requests, 12 tokens in")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_trains_every_arch(arch, capsys):
    """launch.train at each smoke config (a frontend dropped, as the
    reference's launcher drops it): 3 steps with finite losses; whisper's
    encoder, which the token-only loss does not read, gets zero gradients
    rather than an error."""
    losses = train_launcher.main(["--device", "cpu", "--smoke", "--arch", arch, "--steps", "3",
                                  "--batch-size", "2", "--seq-len", "16", "--log-every", "1"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert capsys.readouterr().out.splitlines()[-1].startswith("final loss")

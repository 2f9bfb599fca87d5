"""The port's dense LMs (``repro_torch.models``) against ``repro``'s on the
same weights (``params_from_arrays``) and the same seeded tokens, at the
smoke configs in float32: forward logits within 1e-4 for every dense
config; prefill + teacher-forced decode against forward and against the
reference's chain; GQA against the same model written as MHA; the plain
path query-chunked; bf16 logits bit for bit against the reference run op
by op; the
kernel route's head layout (the flash op swapped for its plain version on
the CPU); ``params_from_arrays`` refusing a wrong tree. The other families
(moe, ssm, hybrid, audio, and llava with its patch frontend) are held in
tests/test_torch_families.py. The kernel route on the card is held in
tests/test_torch_cuda_kernels.py (``test_lm_forward_through_the_kernel``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.models import model as RM
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models import params_from_arrays

TOL = dict(rtol=1e-4, atol=1e-4)
#: the dense family (llava-next-mistral-7b without its vision frontend, as
#: examples/retrieval_attention_serve.py runs it; with the frontend it is
#: held in tests/test_torch_families.py)
DENSE = ["granite-3-2b", "qwen1.5-4b", "codeqwen1.5-7b", "starcoder2-3b",
         "llava-next-mistral-7b"]


def _cfgs(arch: str, **kw):
    ref, port = ref_smoke(arch), get_smoke(arch)
    if ref.frontend is not None:
        kw = dict(kw, frontend=None)
    return dataclasses.replace(ref, **kw), dataclasses.replace(port, **kw)


@pytest.fixture(scope="module")
def models():
    """arch -> (reference cfg, port cfg, reference params, port params), one
    model per arch for the file."""
    cache = {}

    def get(arch):
        if arch not in cache:
            ref_cfg, port_cfg = _cfgs(arch)
            rp = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
            tp = params_from_arrays(jax.tree.map(np.asarray, rp), port_cfg, device="cpu")
            cache[arch] = ref_cfg, port_cfg, rp, tp
        return cache[arch]

    return get


def _tokens(cfg, seed=0, shape=(2, 12)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _ref_forward(params, cfg, tokens):
    fn = jax.jit(lambda p, t: RM.forward(p, cfg, {"tokens": t})[0])
    return np.asarray(fn(params, jnp.asarray(tokens, jnp.int32)))


def _port_forward(params, cfg, tokens, **kw):
    return TM.forward(params, cfg, {"tokens": torch.from_numpy(tokens)}, **kw)[0]


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(models, arch):
    ref_cfg, port_cfg, rp, tp = models(arch)
    tokens = _tokens(ref_cfg)
    got = _port_forward(tp, port_cfg, tokens)
    assert got.dtype == torch.float32 and got.shape == (2, 12, port_cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), _ref_forward(rp, ref_cfg, tokens), **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_matches_forward(models, arch):
    """Prefill 8 tokens, teacher-force 4: each step's logits equal the
    forward's at that position, and the reference's chain."""
    ref_cfg, port_cfg, rp, tp = models(arch)
    tokens = _tokens(ref_cfg, seed=1)
    full = _port_forward(tp, port_cfg, tokens).numpy()
    logits, cache = TM.prefill(tp, port_cfg, {"tokens": torch.from_numpy(tokens[:, :8])}, 32)
    rpre = jax.jit(lambda p, t: RM.prefill(p, ref_cfg, {"tokens": t}, 32))
    rstep = jax.jit(lambda p, c, t, pos: RM.decode_step(p, ref_cfg, c, t, pos))
    rlogits, rcache = rpre(rp, jnp.asarray(tokens[:, :8], jnp.int32))
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, 7], **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)
    for t in range(8, 12):
        logits, cache = TM.decode_step(tp, port_cfg, cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        rlogits, rcache = rstep(rp, rcache, jnp.asarray(tokens[:, t:t + 1], jnp.int32), t)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t], **TOL, err_msg=f"step {t}")
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)


def test_per_sequence_positions_decode(models):
    """Two sequences at different depths in one decode batch (a (B,) pos):
    each row equals its own single-sequence decode."""
    _, cfg, _, tp = models("granite-3-2b")
    tokens = torch.from_numpy(_tokens(cfg, seed=2, shape=(2, 10)))
    cache = TM.init_cache(cfg, 2, 32, device="cpu")
    want = []
    for row, plen in enumerate((5, 8)):
        _, pc = TM.prefill(tp, cfg, {"tokens": tokens[row:row + 1, :plen]}, 32)
        for bc, sc in zip(TM.tree_leaves(cache), TM.tree_leaves(pc)):
            bc[:, row] = sc[:, 0]
        logits, _ = TM.decode_step(tp, cfg, pc, tokens[row:row + 1, plen:plen + 1], plen)
        want.append(logits[0])
    step = torch.stack([tokens[0, 5:6], tokens[1, 8:9]])
    logits, _ = TM.decode_step(tp, cfg, cache, step, torch.tensor([5, 8]))
    np.testing.assert_allclose(logits.numpy(), torch.stack(want).numpy(), rtol=1e-5, atol=1e-5)


def _as_mha(params, cfg):
    """The same model with each KV head's weights repeated for its G query
    heads (head h reads KV head h // G)."""
    g = cfg.n_heads // cfg.n_kv_heads
    out = TM.map_tree(lambda t: t.clone(), params)
    attn = out["blocks"]["l0"]["attn"]
    for name in ("wk", "wv"):
        for leaf, t in attn[name].items():
            split = t.reshape(*t.shape[:-1], cfg.n_kv_heads, cfg.hd)
            attn[name][leaf] = split.repeat_interleave(g, dim=-2).reshape(
                *t.shape[:-1], cfg.n_heads * cfg.hd)
    return out, dataclasses.replace(cfg, n_kv_heads=cfg.n_heads)


@pytest.mark.parametrize("arch", ["granite-3-2b", "starcoder2-3b"])
def test_gqa_matches_mha(models, arch):
    """GQA (granite 2 of 4 KV heads; starcoder2 with biases) equals the MHA
    model with repeated KV weights, in forward and in decode."""
    _, cfg, _, tp = models(arch)
    mha, mha_cfg = _as_mha(tp, cfg)
    tokens = _tokens(cfg, seed=3)
    np.testing.assert_allclose(_port_forward(tp, cfg, tokens).numpy(),
                               _port_forward(mha, mha_cfg, tokens).numpy(), rtol=1e-5, atol=1e-5)
    got = []
    for params, c in ((tp, cfg), (mha, mha_cfg)):
        _, cache = TM.prefill(params, c, {"tokens": torch.from_numpy(tokens[:, :10])}, 16)
        got.append(TM.decode_step(params, c, cache, torch.from_numpy(tokens[:, 10:11]), 10)[0])
    np.testing.assert_allclose(got[0].numpy(), got[1].numpy(), rtol=1e-5, atol=1e-5)


def test_chunked_attention_matches_reference(models):
    """attn_q_chunk = 4 over 12 tokens: the plain path's chunks (the
    reference's scan) equal the unchunked logits and the reference's
    chunked ones."""
    ref_cfg, port_cfg, rp, tp = models("granite-3-2b")
    ref_c = dataclasses.replace(ref_cfg, attn_q_chunk=4)
    port_c = dataclasses.replace(port_cfg, attn_q_chunk=4)
    tokens = _tokens(ref_cfg, seed=4)
    got = _port_forward(tp, port_c, tokens).numpy()
    np.testing.assert_allclose(got, _port_forward(tp, port_cfg, tokens).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _ref_forward(rp, ref_c, tokens), **TOL)
    logits, _ = TM.prefill(tp, port_c, {"tokens": torch.from_numpy(tokens)}, 16)
    np.testing.assert_allclose(logits[:, 0].numpy(), got[:, -1], **TOL)


def test_bf16_matches_the_reference_op_for_op(models):
    """compute_dtype bfloat16 (the full configs' own): forward and prefill
    logits equal the reference's run op by op (``jax.disable_jit``) bit for
    bit. Under jit, XLA fuses bf16 chains with excess precision, so the
    jitted reference moves from its own op-by-op run by more than its 2e-2
    (tests/test_models.py:59) on these inputs; the port rounds each op where
    the reference's code does, and is held to the op-by-op run."""
    ref_cfg, port_cfg, rp, tp = models("granite-3-2b")
    ref_b = dataclasses.replace(ref_cfg, compute_dtype="bfloat16")
    port_b = dataclasses.replace(port_cfg, compute_dtype="bfloat16")
    tokens = _tokens(ref_cfg, seed=5, shape=(2, 8))
    with jax.disable_jit():
        want = np.asarray(RM.forward(rp, ref_b, {"tokens": jnp.asarray(tokens, jnp.int32)})[0])
    got = _port_forward(tp, port_b, tokens).numpy()
    np.testing.assert_array_equal(got, want)
    logits, cache = TM.prefill(tp, port_b, {"tokens": torch.from_numpy(tokens)}, 16)
    assert cache["l0"]["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(logits[:, 0].numpy(), got[:, -1])


def test_kernel_route_layout(models, monkeypatch):
    """impl="kernel" with the CUDA launch swapped for the plain flash
    version: one call a layer over (B*H, S, hd) with K/V expanded to the
    query heads (head h reads KV head h // G), and the plain path's logits.
    The bf16 route is held on the card (the ``cuda`` test, chip_smoke.py)."""
    _, cfg, _, tp = models("granite-3-2b")
    calls = []

    def fake_cuda(q, k, v, causal):
        calls.append((tuple(q.shape), tuple(k.shape), causal, q.is_contiguous()))
        return flash_attention_plain(q, k, v, causal)

    monkeypatch.setattr(ops, "flash_attention_cuda", fake_cuda)
    tokens = _tokens(cfg, seed=6)
    before = TA.kv_expansions
    got = _port_forward(tp, cfg, tokens, impl="kernel")
    assert calls == [((2 * 4, 12, 16), (2 * 4, 12, 16), True, True)] * cfg.n_layers
    assert TA.kv_expansions - before == cfg.n_layers
    np.testing.assert_allclose(got.numpy(), _port_forward(tp, cfg, tokens).numpy(), **TOL)
    calls.clear()
    logits, _ = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(tokens)}, 16, impl="kernel")
    assert len(calls) == cfg.n_layers
    np.testing.assert_allclose(logits[:, 0].numpy(), got[:, -1].numpy(), rtol=1e-5, atol=1e-5)


def test_kernel_impl_on_cpu_raises(models):
    """No fallback: asking for the kernel on CPU tensors raises."""
    _, cfg, _, tp = models("granite-3-2b")
    with pytest.raises(ValueError, match="CUDA"):
        _port_forward(tp, cfg, _tokens(cfg), impl="kernel")


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "leaf"])
def test_params_from_arrays_rejects_a_wrong_tree(models, fault):
    ref_cfg, port_cfg, rp, _ = models("granite-3-2b")
    tree = jax.tree.map(np.asarray, rp)
    attn = tree["blocks"]["l0"]["attn"]
    if fault == "missing":
        del attn["wk"]["w"]
    elif fault == "extra":
        attn["wq"]["b"] = np.zeros((2, 64), np.float32)  # granite has no QKV bias
    elif fault == "shape":
        attn["wo"]["w"] = attn["wo"]["w"][:, :-1]
    else:
        tree["final_norm"] = np.ones(64, np.float32)
    with pytest.raises(ValueError, match="params_from_arrays"):
        params_from_arrays(tree, port_cfg, device="cpu")


def test_param_count_and_layout(models):
    ref_cfg, port_cfg, rp, tp = models("codeqwen1.5-7b")
    assert TM.param_count(tp) == RM.param_count(rp)
    fresh = TM.init_params(torch.Generator().manual_seed(0), port_cfg, device="cpu")
    assert TM.map_tree(lambda t: tuple(t.shape), fresh) == TM.map_tree(lambda t: tuple(t.shape), tp)
    assert fresh["blocks"]["l0"]["attn"]["wq"]["b"].abs().sum() == 0
    assert fresh["blocks"]["l0"]["ln1"]["scale"].eq(1).all()

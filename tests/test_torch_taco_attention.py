"""The port's TaCo retrieval attention (``repro_torch.models.taco_attention``)
against ``repro``'s on the same keys and weights: the snake allocation, the
retrieval-state build (cells and cell sizes equal; centroids equal up to the
eigenvector signs each package takes; Lloyd bit for bit on the same
projected data), one decode step fed the reference's state (the same top-C
slots, the output within 1e-4), and the reference's end-to-end properties
(tests/test_models.py: retrieve-all equals full decode, sparse retrieval
stays close) run through both packages. A per-slot (B,) ``pos`` raises, as
the reference's decode cannot take one either."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_smoke
from repro.models import model as RM
from repro.models import taco_attention as RT
from repro_torch.configs import get_smoke
from repro_torch.models import model as TM
from repro_torch.models import params_from_arrays
from repro_torch.models import taco_attention as TT

TOL = dict(rtol=1e-4, atol=1e-4)
#: tests/test_models.py:74 (retrieve-all) and :101 (sparse)
EXACT = dict(n_subspaces=2, subspace_dim=4, sqrt_k=4, alpha=0.5, n_retrieve=32,
             recent_window=4, kmeans_iters=2)
SPARSE = dict(n_subspaces=2, subspace_dim=4, sqrt_k=4, alpha=0.3, n_retrieve=24,
              recent_window=8, kmeans_iters=2)


def _cfgs(attention_kind="full", **rc):
    """(reference cfg, port cfg): granite-3-2b smoke (4 heads, 2 KV heads)."""
    ref = dataclasses.replace(ref_smoke("granite-3-2b"), attention_kind=attention_kind,
                              retrieval=RT.RetrievalConfig(**rc))
    port = dataclasses.replace(get_smoke("granite-3-2b"), attention_kind=attention_kind,
                               retrieval=TT.RetrievalConfig(**rc))
    return ref, port


@pytest.fixture(scope="module")
def weights():
    """One model for the file: the reference's parameters and the port's copy."""
    ref_cfg, port_cfg = _cfgs()
    rp = RM.init_params(jax.random.PRNGKey(3), ref_cfg)
    return rp, params_from_arrays(jax.tree.map(np.asarray, rp), port_cfg, device="cpu")


def _state_to_torch(st) -> TT.RetrievalState:
    return TT.RetrievalState(**{f.name: torch.from_numpy(np.array(getattr(st, f.name)))
                                for f in dataclasses.fields(TT.RetrievalState)})


@pytest.mark.parametrize("m,n_sub", [(8, 2), (16, 2), (12, 3), (16, 4)])
def test_snake_allocation_equal(m, n_sub):
    want = np.asarray(RT.snake_allocation(m, n_sub))
    np.testing.assert_array_equal(TT.snake_allocation(m, n_sub).numpy(), want)


def _build_both(keys, rc, jit=True):
    build = jax.jit(RT.build_retrieval_state, static_argnums=1) if jit else \
        RT.build_retrieval_state
    ref = build(jnp.asarray(keys), RT.RetrievalConfig(**rc))
    port = TT.build_retrieval_state(torch.from_numpy(keys), TT.RetrievalConfig(**rc))
    return ref, port


def _signs(ref, port):
    """+-1 per (kv head, basis column) aligning the port's basis with the
    reference's."""
    return np.sign(np.sum(np.asarray(ref.basis) * port.basis.numpy(), axis=1))


@pytest.mark.parametrize("rc", [EXACT, SPARSE], ids=["exact", "sparse"])
def test_build_equals_reference_on_model_keys(weights, rc):
    """Keys from the reference's own prefill (36 tokens, two layers): cells
    and cell sizes equal, centroids equal once the basis signs are
    aligned."""
    rp, _ = weights
    ref_cfg, _ = _cfgs("full")
    tokens = np.random.default_rng(4).integers(0, ref_cfg.vocab_size, (1, 36))
    _, cache = jax.jit(lambda p, t: RM.prefill(p, ref_cfg, {"tokens": t}, 36))(
        rp, jnp.asarray(tokens, jnp.int32))
    for g in range(ref_cfg.n_groups):
        keys = np.array(cache["l0"]["k"][g], np.float32)
        ref, port = _build_both(keys, rc)
        np.testing.assert_array_equal(port.cells.numpy(), np.asarray(ref.cells))
        np.testing.assert_array_equal(port.cell_sizes.numpy(), np.asarray(ref.cell_sizes))
        sign = _signs(ref, port)  # (Kv, m)
        np.testing.assert_allclose(port.basis.numpy() * sign[:, None], np.asarray(ref.basis),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(port.mean.numpy(), np.asarray(ref.mean), rtol=1e-6, atol=1e-6)
        half = rc["subspace_dim"] // 2
        csign = sign.reshape(sign.shape[0], rc["n_subspaces"], 2, 1, half)
        np.testing.assert_allclose(port.centroids.numpy() * csign, np.asarray(ref.centroids),
                                   rtol=1e-4, atol=1e-4)


def test_lloyd_bit_for_bit_on_the_same_data():
    """The default config's K-means (64 centroids a half, 5 iterations) over
    the same projected keys: every centroid bit for bit (the CPU sums add
    rows in order, as ``segment_sum`` does)."""
    rc = TT.RetrievalConfig()
    data = np.random.default_rng(5).standard_normal((6, 600, rc.subspace_dim // 2))
    data = data.astype(np.float32)
    want = jax.vmap(lambda d: RT._lloyd_fixed(d, rc.sqrt_k, rc.kmeans_iters))(jnp.asarray(data))
    got = TT._lloyd_fixed(torch.from_numpy(data), rc.sqrt_k, rc.kmeans_iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_build_at_the_default_config_agrees():
    """The default config on 2 x 300 random keys against the reference run
    op by op: the two eigensolvers' last bits move a near-tied key to a
    neighbouring cell (1 of 3600 here; at most 0.1 % allowed); every cell
    size still sums to the key count."""
    keys = np.random.default_rng(0).standard_normal((2, 300, 3, 32)).astype(np.float32)
    rc = dict(dataclasses.asdict(TT.RetrievalConfig()))
    ref, port = _build_both(keys, rc, jit=False)
    assert np.mean(port.cells.numpy() == np.asarray(ref.cells)) >= 0.999
    assert (port.cell_sizes.sum(dim=(-2, -1)) == 300).all()
    sign = _signs(ref, port)
    np.testing.assert_allclose(port.basis.numpy() * sign[:, None], np.asarray(ref.basis),
                               rtol=1e-4, atol=1e-4)


def test_decode_step_fed_the_reference_state(weights, monkeypatch):
    """One decode step of layer 0 on the reference's prefilled cache and
    retrieval state: the same top-C slots (captured at each package's
    top-k) and the attention output within 1e-4."""
    rp, tp = weights
    ref_cfg, port_cfg = _cfgs("taco", **SPARSE)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, ref_cfg.vocab_size, (2, 36))
    _, cache = jax.jit(lambda p, t: RM.prefill(p, ref_cfg, {"tokens": t}, 64))(
        rp, jnp.asarray(tokens, jnp.int32))
    c0 = jax.tree.map(lambda a: a[0], cache["l0"])
    p_ref = jax.tree.map(lambda a: a[0], rp["blocks"]["l0"]["attn"])
    p_port = {k: {n: t[0] for n, t in v.items()} for k, v in tp["blocks"]["l0"]["attn"].items()}
    x = rng.standard_normal((2, 1, ref_cfg.d_model)).astype(np.float32)
    kw = dict(n_heads=ref_cfg.n_heads, n_kv=ref_cfg.n_kv_heads, head_dim=ref_cfg.hd,
              rope_theta=ref_cfg.rope_theta)

    picked = {}
    top_k = jax.lax.top_k

    def ref_top_k(key, c):  # runs under jit: the slots reach the host by a callback
        vals, idx = top_k(key, c)
        jax.debug.callback(lambda i: picked.__setitem__("ref", np.asarray(i)), idx)
        return vals, idx

    port_top_c = TT._top_c

    def port_top(key, c):
        picked["port"] = port_top_c(key, c).numpy()
        return torch.from_numpy(picked["port"])

    monkeypatch.setattr(jax.lax, "top_k", ref_top_k)
    monkeypatch.setattr(TT, "_top_c", port_top)
    step = jax.jit(lambda p, xx, c: RT.taco_decode_attention(
        p, xx, c["k"], c["v"], c["taco"], 36, ref_cfg.retrieval, **kw))
    want, _, _, ref_state = step(p_ref, jnp.asarray(x), c0)
    jax.effects_barrier()
    state = _state_to_torch(c0["taco"])
    ck, cv = (torch.from_numpy(np.array(c0[n])) for n in ("k", "v"))
    got, ck, cv, state = TT.taco_decode_attention(p_port, torch.from_numpy(x), ck, cv, state,
                                                  36, port_cfg.retrieval, **kw)
    np.testing.assert_array_equal(picked["port"], picked["ref"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the streaming insert: slot 36 holds the new key's cell, counted once more
    np.testing.assert_array_equal(state.cells.numpy(), np.asarray(ref_state.cells))
    np.testing.assert_array_equal(state.cell_sizes.numpy(), np.asarray(ref_state.cell_sizes))


def _chain(prefill, decode_step, params, tokens, n_prefill, to_tokens):
    """Prefill n_prefill tokens, then teacher-force the rest: each step's
    logits as numpy."""
    logits, cache = prefill(params, to_tokens(tokens[:, :n_prefill]))
    steps = [np.asarray(logits)]
    for t in range(n_prefill, tokens.shape[1]):
        logits, cache = decode_step(params, cache, to_tokens(tokens[:, t:t + 1]), t)
        steps.append(np.asarray(logits))
    return steps


def _ref_chain(params, cfg, tokens, n_prefill, max_seq):
    pre = jax.jit(lambda p, t: RM.prefill(p, cfg, {"tokens": t}, max_seq))
    step = jax.jit(lambda p, c, t, pos: RM.decode_step(p, cfg, c, t, pos))
    return _chain(pre, step, params, tokens, n_prefill, lambda a: jnp.asarray(a, jnp.int32))


def _port_chain(params, cfg, tokens, n_prefill, max_seq):
    return _chain(lambda p, t: TM.prefill(p, cfg, {"tokens": t}, max_seq),
                  lambda p, c, t, pos: TM.decode_step(p, cfg, c, t, pos),
                  params, tokens, n_prefill, torch.from_numpy)


@pytest.mark.parametrize("case", ["exact", "sparse"])
def test_end_to_end_against_reference(weights, case):
    """tests/test_models.py:70 and :97 through both packages: the port's TaCo
    chain equals the reference's TaCo chain within 1e-4 at every step, and
    holds the reference's own property against the port's full chain
    (retrieve-all within 5e-3 of full decode; sparse: TVD < 0.3)."""
    rp, tp = weights
    rc, n_pre, n_tot, max_seq = ((EXACT, 8, 12, 32) if case == "exact"
                                 else (SPARSE, 36, 40, 64))
    ref_taco, port_taco = _cfgs("taco", **rc)
    _, port_full = _cfgs("full", **rc)
    tokens = np.random.default_rng(7).integers(0, ref_taco.vocab_size, (1, n_tot))
    want = _ref_chain(rp, ref_taco, tokens, n_pre, max_seq)
    got = _port_chain(tp, port_taco, tokens, n_pre, max_seq)
    full = _port_chain(tp, port_full, tokens, n_pre, max_seq)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"step {step}")
    if case == "exact":
        for step, (g, f) in enumerate(zip(got, full)):
            np.testing.assert_allclose(g, f, rtol=5e-3, atol=5e-3, err_msg=f"step {step}")
    else:
        pf = torch.softmax(torch.from_numpy(full[-1][:, 0]), -1)
        pt = torch.softmax(torch.from_numpy(got[-1][:, 0]), -1)
        assert float(0.5 * torch.sum(torch.abs(pf - pt))) < 0.3


def test_per_slot_pos_raises(weights):
    """A (B,) pos (the slot engine's) raises, in the attention and through
    decode_step; a 0-d tensor is one scalar position and runs."""
    _, tp = weights
    _, cfg = _cfgs("taco", **EXACT)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 9)))
    _, cache = TM.prefill(tp, cfg, {"tokens": tokens[:, :8]}, 32)
    with pytest.raises(ValueError, match="per-slot"):
        TM.decode_step(tp, cfg, cache, tokens[:, 8:], torch.tensor([8, 8]))
    logits, _ = TM.decode_step(tp, cfg, cache, tokens[:, 8:], torch.tensor(8))
    assert logits.shape == (2, 1, cfg.vocab_size)

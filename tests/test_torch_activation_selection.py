"""Activation and candidate selection of the port against the reference,
bit for bit: tau and the retrieved count of every activation (ties
included), the batched min-heaps, the Alg. 5 threshold (also against the
literal sequential oracle), the fixed-budget threshold, the gather path's
histogram, rank cut and compaction, and the configuration constructors."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.core.activation import activation_taus as j_activation_taus
from repro.core.activation import sort_activation as j_sort_activation
from repro.core.heap import heap_make as j_heap_make
from repro.core.heap import heap_pop as j_heap_pop
from repro.core.heap import heap_push as j_heap_push
from repro.core.selection import (
    _alg5_threshold_reference,
)
from repro.core.selection import compact_above_threshold as j_compact
from repro.core.selection import fixed_budget as j_fixed_budget
from repro.core.selection import fixed_threshold as j_fixed_threshold
from repro.core.selection import fixed_threshold_from_hist as j_fixed_from_hist
from repro.core.selection import query_aware_threshold as j_query_aware
from repro.core.selection import sc_histogram as j_sc_histogram
from repro.core.selection import select_candidates as j_select_candidates
from repro_torch.core import config, heap
from repro_torch.core import selection as sel
from repro_torch.core.activation import activation_taus, sort_activation
from repro_torch.core.selection import (
    fixed_budget,
    fixed_threshold_from_hist,
    query_aware_threshold,
)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("sqrt_k,alpha_n,seed", [
    (4, 3.0, 0), (8, 50.0, 1), (16, 0.5, 2), (32, 1e9, 3), (32, 777.0, 4),
])
def test_sort_activation_bitwise(sqrt_k, alpha_n, seed):
    rng = np.random.default_rng(seed)
    d1 = rng.uniform(0, 10, sqrt_k).astype(np.float32)
    d2 = rng.uniform(0, 10, sqrt_k).astype(np.float32)
    sizes = rng.integers(0, 20, (sqrt_k, sqrt_k)).astype(np.int32)
    tau, ret = sort_activation(*[torch.from_numpy(a) for a in (d1, d2, sizes)], alpha_n)
    wt, wr = j_sort_activation(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(sizes), alpha_n)
    assert _bits(tau.numpy()) == _bits(np.asarray(wt))
    assert _bits(ret.numpy()) == _bits(np.asarray(wr))


@pytest.mark.parametrize("seed", range(4))
def test_sort_activation_bitwise_on_ties(seed):
    """Integer-valued distances make many equal cell sums: the tie group is
    replayed in index order exactly as the reference's stable sort."""
    rng = np.random.default_rng(seed)
    sqrt_k = 12
    d1 = rng.integers(0, 4, sqrt_k).astype(np.float32)
    d2 = rng.integers(0, 4, sqrt_k).astype(np.float32)
    sizes = rng.integers(0, 5, (sqrt_k, sqrt_k)).astype(np.int32)
    for alpha_n in (1.0, 7.0, 40.0, 150.0, 10_000.0):
        tau, ret = sort_activation(*[torch.from_numpy(a) for a in (d1, d2, sizes)], alpha_n)
        wt, wr = j_sort_activation(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(sizes), alpha_n)
        assert _bits(tau.numpy()) == _bits(np.asarray(wt))
        assert _bits(ret.numpy()) == _bits(np.asarray(wr))


def test_sort_activation_negative_and_zero_sums():
    d1 = np.array([-1.5, 0.0, -0.0, 2.0], np.float32)
    d2 = np.array([0.25, -3.0, 1.0, -0.0], np.float32)
    sizes = np.arange(16, dtype=np.int32).reshape(4, 4)
    for alpha_n in (0.0, 1.0, 30.0, 119.0, 120.0):
        tau, ret = sort_activation(*[torch.from_numpy(a) for a in (d1, d2, sizes)], alpha_n)
        wt, wr = j_sort_activation(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(sizes), alpha_n)
        assert _bits(tau.numpy()) == _bits(np.asarray(wt))
        assert _bits(ret.numpy()) == _bits(np.asarray(wr))


@pytest.mark.parametrize("n_sub,q,sqrt_k", [(1, 1, 4), (3, 7, 8), (6, 16, 32)])
def test_activation_taus_batched_bitwise(n_sub, q, sqrt_k):
    rng = np.random.default_rng(n_sub * q)
    d1s = rng.uniform(0, 5, (n_sub, q, sqrt_k)).astype(np.float32)
    d2s = rng.integers(0, 5, (n_sub, q, sqrt_k)).astype(np.float32)
    sizes = rng.integers(0, 9, (n_sub, sqrt_k, sqrt_k)).astype(np.int32)
    alpha_n = 0.05 * float(sizes.sum() / n_sub)
    taus, ret = activation_taus(*[torch.from_numpy(a) for a in (d1s, d2s, sizes)], alpha_n)
    for s in range(n_sub):
        wt, wr = j_activation_taus(jnp.asarray(d1s[s]), jnp.asarray(d2s[s]),
                                   jnp.asarray(sizes[s]), alpha_n)
        np.testing.assert_array_equal(_bits(taus[s].numpy()), _bits(np.asarray(wt)))
        np.testing.assert_array_equal(_bits(ret[s].numpy()), _bits(np.asarray(wr)))


def _activation_case(seed, integer: bool):
    rng = np.random.default_rng(seed)
    n_sub, q, sqrt_k = 3, 7, (4, 8, 12, 16)[seed % 4]
    if integer:  # many equal cell sums
        d1s = rng.integers(0, 4, (n_sub, q, sqrt_k)).astype(np.float32)
        d2s = rng.integers(0, 4, (n_sub, q, sqrt_k)).astype(np.float32)
    else:
        d1s = rng.uniform(0, 5, (n_sub, q, sqrt_k)).astype(np.float32)
        d2s = rng.uniform(0, 5, (n_sub, q, sqrt_k)).astype(np.float32)
    return d1s, d2s, rng.integers(0, 6, (n_sub, sqrt_k, sqrt_k)).astype(np.int32)


def _check_activation(method, d1s, d2s, sizes, alpha_ns):
    for alpha_n in alpha_ns:
        taus, ret = activation_taus(*[torch.from_numpy(a) for a in (d1s, d2s, sizes)],
                                    alpha_n, method=method)
        for s in range(d1s.shape[0]):
            wt, wr = j_activation_taus(jnp.asarray(d1s[s]), jnp.asarray(d2s[s]),
                                       jnp.asarray(sizes[s]), alpha_n, method=method)
            np.testing.assert_array_equal(_bits(taus[s].numpy()), _bits(np.asarray(wt)))
            np.testing.assert_array_equal(_bits(ret[s].numpy()), _bits(np.asarray(wr)))


@pytest.mark.parametrize("method", ["heap", "linear"])
def test_unported_activations_raise(method):
    """Once a gap, now a gate: heap and linear activation run, bitwise
    equal to the reference on float and on tied integer distances."""
    for seed in range(4):
        d1s, d2s, sizes = _activation_case(seed, integer=bool(seed % 2))
        _check_activation(method, d1s, d2s, sizes, (0.0, 1.0, 40.0, 150.0, 1e6))


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("method", ["heap", "linear", "sort_lax", "sort"])
def test_activations_bitwise(method, integer):
    for seed in range(4, 10):
        d1s, d2s, sizes = _activation_case(seed, integer)
        _check_activation(method, d1s, d2s, sizes, (7.0, 77.0, 300.0))


def test_activation_rejects_an_unknown_method():
    d = torch.zeros((1, 1, 2))
    with pytest.raises(ValueError):
        activation_taus(d, d, torch.ones((1, 2, 2), dtype=torch.int32), 1.0, method="bogus")


_J_PUSH, _J_POP = jax.jit(j_heap_push), jax.jit(j_heap_pop)


@pytest.mark.parametrize("seed", range(3))
def test_min_heaps_follow_the_reference(seed):
    """Pushes and pops on a batch of heaps, with equal keys and per-row
    masks, leave every slot as the reference's heap does."""
    rng = np.random.default_rng(seed)
    batch, cap = 5, 9
    ours = heap.heap_make(batch, cap)
    theirs = [j_heap_make(cap) for _ in range(batch)]
    for _step in range(40):
        push = rng.random() < 0.6
        room = ours.size.numpy() < cap if push else ours.size.numpy() > 0
        on = (rng.random(batch) < 0.8) & room
        key = rng.integers(0, 5, batch).astype(np.float32)
        val = rng.integers(0, 100, batch).astype(np.int32)
        if push:
            heap.heap_push(ours, torch.from_numpy(key), torch.from_numpy(val), torch.from_numpy(on))
        else:
            heap.heap_pop(ours, torch.from_numpy(on))
        for b in np.flatnonzero(on):
            theirs[b] = (_J_PUSH(theirs[b], jnp.float32(key[b]), jnp.int32(val[b]))
                         if push else _J_POP(theirs[b]))
        top_k, top_v = heap.heap_top(ours)
        for b in range(batch):
            np.testing.assert_array_equal(ours.keys[b].numpy(), np.asarray(theirs[b].keys))
            np.testing.assert_array_equal(ours.vals[b].numpy(), np.asarray(theirs[b].vals))
            assert int(ours.size[b]) == int(theirs[b].size)
            assert top_k[b] == ours.keys[b, 0] and top_v[b] == ours.vals[b, 0]


def _sc_matrix(rng, q, n, n_s):
    sc = rng.integers(0, n_s + 1, (q, n)).astype(np.int32)
    sc[: q // 2] = np.minimum(sc[: q // 2], 2)  # rows with few high scores
    return sc


@pytest.mark.parametrize("q,n,n_s,seed", [(8, 300, 6, 0), (5, 1000, 3, 1), (3, 50, 1, 2)])
def test_sc_histogram_bitwise(q, n, n_s, seed):
    sc = _sc_matrix(np.random.default_rng(seed), q, n, n_s)
    got = sel.sc_histogram(torch.from_numpy(sc), n_s)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_sc_histogram(jnp.asarray(sc), n_s)))


@pytest.mark.parametrize("beta_n", [0.3, 10.0, 47.5, 5000.0])
def test_fixed_threshold_bitwise(beta_n):
    sc = _sc_matrix(np.random.default_rng(5), 9, 400, 6)
    th, cnt = sel.fixed_threshold(torch.from_numpy(sc), beta_n, 6)
    wth, wcnt = j_fixed_threshold(jnp.asarray(sc), beta_n, 6)
    np.testing.assert_array_equal(th.numpy(), np.asarray(wth))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    hist_th, _ = fixed_threshold_from_hist(sel.sc_histogram(torch.from_numpy(sc), 6), beta_n, 400)
    np.testing.assert_array_equal(th.numpy(), hist_th.numpy())


@pytest.mark.parametrize("cap", [1, 17, 120, 400])
def test_compact_above_threshold_bitwise(cap):
    rng = np.random.default_rng(cap)
    sc = _sc_matrix(rng, 7, 400, 6)
    thresh = rng.integers(0, 7, 7).astype(np.int32)
    got = sel.compact_above_threshold(torch.from_numpy(sc), torch.from_numpy(thresh), cap)
    want = j_compact(jnp.asarray(sc), jnp.asarray(thresh), cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["query_aware", "fixed"])
@pytest.mark.parametrize("cap", [5, 40, 300])
def test_select_candidates_bitwise(mode, cap):
    sc = _sc_matrix(np.random.default_rng(cap), 6, 300, 4)
    got = sel.select_candidates(torch.from_numpy(sc), 12.0, 4, cap, mode)
    want = j_select_candidates(jnp.asarray(sc), 12.0, 4, cap, mode=mode)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        sel.select_candidates(torch.from_numpy(sc), 12.0, 4, cap, "bogus")


def _random_hists(rng, q, n_s, hi):
    return rng.integers(0, hi, (q, n_s + 1)).astype(np.int32)


@pytest.mark.parametrize("n_s,beta_n,seed", [
    (1, 3.0, 0), (4, 10.5, 1), (6, 50.0, 2), (6, 0.1, 3), (8, 1e6, 4), (6, 5000.0, 5),
])
def test_query_aware_threshold_bitwise(n_s, beta_n, seed):
    rng = np.random.default_rng(seed)
    hist = _random_hists(rng, 64, n_s, 40)
    hist[:8] = rng.integers(0, 3, (8, n_s + 1))  # sparse rows
    th, cnt = query_aware_threshold(torch.from_numpy(hist), beta_n, n_s)
    wth, wcnt = j_query_aware(jnp.asarray(hist), beta_n, n_s)
    np.testing.assert_array_equal(th.numpy(), np.asarray(wth))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    assert th.dtype == torch.int32 and cnt.dtype == torch.int32
    for row, t in zip(hist, th.numpy()):
        assert t == _alg5_threshold_reference(row, beta_n, n_s)
        assert t == sel._alg5_threshold_reference(row, beta_n, n_s)


def test_query_aware_threshold_f32_rounding():
    """beta_n - new_cand is computed in float32, as in the reference: a
    budget that is not exact in f32 must round the same way."""
    hist = np.array([[0, 16777215, 1], [3, 2, 16777216]], np.int32)
    for beta_n in (16777217.0, 16777218.5, 33554431.0):
        th, cnt = query_aware_threshold(torch.from_numpy(hist), beta_n, 2)
        wth, wcnt = j_query_aware(jnp.asarray(hist), beta_n, 2)
        np.testing.assert_array_equal(th.numpy(), np.asarray(wth))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))


@pytest.mark.parametrize("n_s,n,beta_n,seed", [
    (3, 500, 10.0, 0), (6, 4000, 20.5, 1), (6, 100, 1000.0, 2), (1, 50, 0.3, 3),
])
def test_fixed_threshold_from_hist_bitwise(n_s, n, beta_n, seed):
    rng = np.random.default_rng(seed)
    hist = np.stack([np.bincount(rng.integers(0, n_s + 1, n), minlength=n_s + 1)
                     for _ in range(32)]).astype(np.int32)
    th, dem = fixed_threshold_from_hist(torch.from_numpy(hist), beta_n, n)
    wth, wdem = j_fixed_from_hist(jnp.asarray(hist), beta_n, n)
    np.testing.assert_array_equal(th.numpy(), np.asarray(wth))
    np.testing.assert_array_equal(dem.numpy(), np.asarray(wdem))
    assert fixed_budget(beta_n, n) == j_fixed_budget(beta_n, n)


def test_config_matches_reference():
    ours = {f.name: f.default for f in dataclasses.fields(config.SCConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jconfig.SCConfig)}
    assert ours == theirs
    assert set(config.ABLATIONS) == set(jconfig.ABLATIONS)
    for name, make in config.ABLATIONS.items():
        assert dataclasses.asdict(make(k=7)) == dataclasses.asdict(jconfig.ABLATIONS[name](k=7))
    cfg = config.taco_config(n_clusters=1024, beta=0.01, k=20)
    assert cfg.sqrt_k == 32 and cfg.cap_for(10_000) == jconfig.taco_config(
        n_clusters=1024, beta=0.01, k=20).cap_for(10_000)
    for mode in ("auto", "gather", "masked_full"):
        for dist in (False, True):
            assert config.resolve_rerank(config.taco_config(rerank=mode), distributed=dist) == \
                jconfig.resolve_rerank(jconfig.taco_config(rerank=mode), distributed=dist)
    with pytest.raises(ValueError):
        config.resolve_rerank(config.taco_config(rerank="bogus"))
    with pytest.raises(ValueError):
        config.SCConfig(precision="fp8")
    with pytest.raises(ValueError):
        _ = config.SCConfig(n_clusters=1000).sqrt_k

"""Plain PyTorch versions of the port's kernels against the reference's
oracles (``repro.kernels.ref`` / ``ops`` with impl="jnp") on seeded numpy
inputs. Integer-valued inputs match bit for bit; SC scores and histograms
match bit for bit on any input; float l2dist is allclose at 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.masked_rerank import finalize_topk as j_finalize
from repro_torch.kernels import ops, ref
from repro_torch.kernels.masked_rerank import finalize_topk, masked_rerank_plain
from repro_torch.kernels.schist import (
    cell_ids,
    collision_bits,
    collision_table,
    schist_plain,
    unpack_collision_bits,
)

# ragged shapes of tests/test_masked_rerank.py
SCHIST_CASES = [(2, 3, 5, 50), (6, 8, 16, 512), (4, 16, 32, 1030), (1, 1, 128, 100),
                (6, 40, 32, 700)]
RERANK_CASES = [(2, 3, 5, 50, 5), (6, 8, 16, 512, 10), (4, 5, 32, 1030, 17),
                (3, 1, 8, 40, 40), (6, 35, 16, 300, 64)]


def _case(rng, n_sub, q, sqrt_k, n, d=16):
    """The reference's masked-rerank test inputs (numpy)."""
    d1s = rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32)
    d2s = rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32)
    a1s = rng.integers(0, sqrt_k, (n_sub, n)).astype(np.int32)
    a2s = rng.integers(0, sqrt_k, (n_sub, n)).astype(np.int32)
    taus = rng.uniform(1, 5, (n_sub, q)).astype(np.float32)
    data = rng.integers(-8, 9, (n, d)).astype(np.float32)
    queries = rng.integers(-8, 9, (q, d)).astype(np.float32)
    norms = np.sum(data * data, axis=1)
    thresh = rng.integers(0, n_sub + 1, (q,)).astype(np.int32)
    return d1s, d2s, a1s, a2s, taus, thresh, data, norms, queries


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("m,n,d", [(5, 7, 3), (37, 29, 5), (64, 32, 4), (16, 100, 32)])
def test_l2dist_float(m, n, d):
    rng = np.random.default_rng(m * 31 + n)
    x = rng.standard_normal((m, d)).astype(np.float32)
    y = rng.standard_normal((n, d)).astype(np.float32)
    got = ops.l2dist(*_t(x, y)).numpy()
    want = np.asarray(jref.l2dist_ref(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m,n,d", [(5, 7, 3), (37, 29, 5), (1000, 32, 4)])
def test_l2dist_integer_bitwise(m, n, d):
    rng = np.random.default_rng(m + n + d)
    x = rng.integers(-20, 21, (m, d)).astype(np.float32)
    y = rng.integers(-20, 21, (n, d)).astype(np.float32)
    got = ops.l2dist(*_t(x, y), impl="torch").numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.l2dist_ref(jnp.asarray(x), jnp.asarray(y))))


@pytest.mark.parametrize("n,k,d", [(1003, 13, 3), (4096, 32, 4), (300, 64, 8)])
def test_kmeans_assign_integer_bitwise(n, k, d):
    rng = np.random.default_rng(n + k)
    x = rng.integers(-6, 7, (n, d)).astype(np.float32)  # many exact ties
    c = rng.integers(-6, 7, (k, d)).astype(np.float32)
    ga, gd = ops.kmeans_assign(*_t(x, c))
    wa, wd = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c), impl="jnp")
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_kmeans_assign_plain_chunks_match_whole():
    rng = np.random.default_rng(3)
    x, c = _t(rng.integers(-6, 7, (5000, 4)).astype(np.float32),
              rng.integers(-6, 7, (32, 4)).astype(np.float32))
    from repro_torch.kernels.kmeans_assign import kmeans_assign_plain

    whole = kmeans_assign_plain(x, c, chunk=10**6)
    parts = kmeans_assign_plain(x, c, chunk=999)
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[1], parts[1])


@pytest.mark.parametrize("n_sub,q,sqrt_k,n", SCHIST_CASES)
def test_scscore_and_schist_ref(n_sub, q, sqrt_k, n):
    rng = np.random.default_rng(n_sub * 100 + q)
    d1s, d2s, a1s, a2s, taus, *_ = _case(rng, n_sub, q, sqrt_k, n)
    jargs = [jnp.asarray(a) for a in (d1s, d2s, a1s, a2s, taus)]
    targs = _t(d1s, d2s, a1s, a2s, taus)
    np.testing.assert_array_equal(ref.scscore_ref(*targs).numpy(),
                                  np.asarray(jref.scscore_ref(*jargs)))
    np.testing.assert_array_equal(ref.schist_ref(*targs, n_sub + 1).numpy(),
                                  np.asarray(jref.schist_ref(*jargs, n_sub + 1)))


@pytest.mark.parametrize("n_sub,q,sqrt_k,n", SCHIST_CASES)
def test_schist_plain_matches_reference(n_sub, q, sqrt_k, n):
    rng = np.random.default_rng(n_sub * 100 + q + 1)
    d1s, d2s, a1s, a2s, taus, *_ = _case(rng, n_sub, q, sqrt_k, n)
    td1, td2, ta1, ta2, ttau = _t(d1s, d2s, a1s, a2s, taus)
    bits = collision_bits(collision_table(td1, td2, ttau))
    got = ops.schist(bits, cell_ids(ta1, ta2, sqrt_k), n_sub + 1, q=q, impl="torch")
    want = jops.schist(*[jnp.asarray(a) for a in (d1s, d2s, a1s, a2s, taus)], impl="jnp")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy().sum(1), n)


@pytest.mark.parametrize("n_sub,q,k2", [(1, 1, 4), (3, 31, 25), (6, 33, 1024), (2, 64, 7)])
def test_collision_bits_roundtrip(n_sub, q, k2):
    rng = np.random.default_rng(q * k2)
    table = torch.from_numpy(rng.random((n_sub, q, k2)) < 0.3)
    bits = collision_bits(table)
    assert bits.dtype == torch.int32 and bits.shape == ((q + 31) // 32, n_sub, k2)
    assert torch.equal(unpack_collision_bits(bits, q), table)


@pytest.mark.parametrize("n_sub,q,sqrt_k,n,k", RERANK_CASES)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_masked_rerank_plain_matches_reference(n_sub, q, sqrt_k, n, k, precision):
    rng = np.random.default_rng(n_sub * 1000 + n)
    d1s, d2s, a1s, a2s, taus, thresh, data, norms, queries = _case(rng, n_sub, q, sqrt_k, n)
    td1, td2, ta1, ta2, ttau, tth, tdata, tnorms, tq = _t(
        d1s, d2s, a1s, a2s, taus, thresh, data, norms, queries)
    bits = collision_bits(collision_table(td1, td2, ttau))
    gi, gd = ops.masked_rerank(bits, cell_ids(ta1, ta2, sqrt_k), tth, tdata, tnorms, tq, k,
                               impl="torch", precision=precision)
    wi, wd = jops.masked_rerank(*[jnp.asarray(a) for a in (d1s, d2s, a1s, a2s, taus, thresh,
                                                             data, norms, queries)],
                                k, impl="jnp", precision=precision)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    if precision == "f32":
        oi, od = ref.masked_rerank_ref(td1, td2, ta1, ta2, ttau, tth, tq, tdata, tnorms, k)
        np.testing.assert_array_equal(oi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(od.numpy(), np.asarray(wd))


def test_schist_plain_block_size_invariant():
    rng = np.random.default_rng(6)
    d1s, d2s, a1s, a2s, taus, *_ = _t(*_case(rng, 4, 9, 8, 777))
    bits = collision_bits(collision_table(d1s, d2s, taus))
    cells = cell_ids(a1s, a2s, 8)
    a = schist_plain(bits, cells, 5, q=9, block=4096)
    assert torch.equal(a, schist_plain(bits, cells, 5, q=9, block=50))


def test_masked_rerank_plain_block_size_invariant():
    rng = np.random.default_rng(5)
    d1s, d2s, a1s, a2s, taus, thresh, data, norms, queries = _t(*_case(rng, 4, 9, 8, 777))
    bits = collision_bits(collision_table(d1s, d2s, taus))
    cells = cell_ids(a1s, a2s, 8)
    a = masked_rerank_plain(bits, cells, thresh, queries, data, norms, 12, block=4096)
    b = masked_rerank_plain(bits, cells, thresh, queries, data, norms, 12, block=50)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_finalize_topk_matches_reference(seed):
    rng = np.random.default_rng(seed)
    q, kp, k, n, d = 6, 16, 10, 50, 8
    data = rng.integers(-4, 5, (n, d)).astype(np.float32)
    queries = rng.integers(-4, 5, (q, d)).astype(np.float32)
    best_i = np.stack([rng.permutation(n)[:kp] for _ in range(q)]).astype(np.int32)
    best_d = rng.integers(0, 4, (q, kp)).astype(np.float32)  # heavy ties
    best_d[rng.random((q, kp)) < 0.3] = np.inf
    best_i[np.isinf(best_d) & (rng.random((q, kp)) < 0.5)] = -1
    gi, gd = finalize_topk(*_t(best_d, best_i, data, queries), k)
    wi, wd = j_finalize(*[jnp.asarray(a) for a in (best_d, best_i, data, queries)], k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))

"""The shapes past the port's former kernel limits, held against ``repro``
on the CPU: IVF-Flat over a corpus wider than 128 dims (the width that
takes ``kmeans_assign``'s wide tiled path on the card) and a TaCo index of
20 subspaces (past the 16 of the fast collision kernels), queried through
both pipelines and, on the masked-full one, at k = 1100 (past the 1024
``masked_rerank`` once took).

On integer-valued inputs (integer corpus and queries, centroids rounded
after every Lloyd update or after the build) every float32 sum is exact in
any order, so centroids, lists, ids, distances and the query statistics
must be bit for bit the reference's. The card runs the same shapes through
the kernels in ``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``'s
``wide`` phase.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.clustering import kmeans_assign as j_kmeans_assign
from repro.clustering import lloyd_step as j_lloyd_step
from repro.core import ivf as jivf
from repro.core import taco as jtaco
from repro.core.config import taco_config as j_taco_config
from repro_torch.clustering import kmeans_assign, lloyd_step
from repro_torch.core import ivf_query, taco
from repro_torch.core.config import taco_config
from repro_torch.core.ivf import IVFIndex, ivf_lists
from repro_torch.kernels.kmeans_assign import tiled
from repro_torch.kernels.masked_rerank import rerank_geometry
from repro_torch.kernels.schist import schist_geometry
from tests.test_torch_query import integer_valued, reference_arrays

IVF_N, IVF_D, IVF_LISTS, IVF_ITERS = 4000, 160, 16, 4


@pytest.fixture(scope="module")
def wide_ivf():
    """An IVF-Flat build over an integer 4000 x 160 corpus on both sides
    from the same first 16 rows, each Lloyd update's means rounded, then
    each side's index: (reference index, port index, queries, both sides'
    centroids and assignments)."""
    rng = np.random.default_rng(160)
    data = rng.integers(-6, 7, (IVF_N, IVF_D)).astype(np.float32)
    queries = rng.integers(-6, 7, (23, IVF_D)).astype(np.float32)
    c_ref = jnp.asarray(data[:IVF_LISTS])
    c_port = torch.from_numpy(data[:IVF_LISTS].copy())
    x = torch.from_numpy(data)
    for _ in range(IVF_ITERS):
        c_ref = jnp.round(j_lloyd_step(jnp.asarray(data), c_ref)[0])
        c_port = torch.round(lloyd_step(x, c_port)[0])
    a_ref = np.asarray(j_kmeans_assign(jnp.asarray(data), c_ref)[0])
    a_port, _ = kmeans_assign(x, c_port)
    # the reference's own list build (repro.core.ivf.build_ivf's loop)
    counts = np.bincount(a_ref, minlength=IVF_LISTS)
    lists = np.full((IVF_LISTS, int(counts.max())), -1, np.int32)
    cursor = np.zeros(IVF_LISTS, np.int64)
    for i, a in enumerate(a_ref):
        lists[a, cursor[a]] = i
        cursor[a] += 1
    ref = jivf.IVFIndex(centroids=c_ref, lists=jnp.asarray(lists), data=jnp.asarray(data))
    port = IVFIndex(centroids=c_port, lists=ivf_lists(a_port, IVF_LISTS), data=x)
    return ref, port, queries, (np.asarray(c_ref), c_port, a_ref, a_port)


def test_wide_ivf_build_bitwise(wide_ivf):
    """The 160-dim build takes the wide tiled path on the card (every k
    past 128 dims does); on the CPU its plain twin's centroids, assignments
    and lists equal the reference's bit for bit."""
    ref, port, _q, (c_ref, c_port, a_ref, a_port) = wide_ivf
    assert tiled(IVF_LISTS, IVF_D)
    np.testing.assert_array_equal(c_port.numpy().view(np.uint32), c_ref.view(np.uint32))
    np.testing.assert_array_equal(a_port.numpy(), a_ref)
    np.testing.assert_array_equal(port.lists.numpy(), np.asarray(ref.lists))


@pytest.mark.parametrize("nprobe,k", [(1, 10), (4, 50), (16, 100)])
def test_wide_ivf_query_bitwise(wide_ivf, nprobe, k):
    """Ids and distances of ivf_query over the 160-dim index bit for bit."""
    ref, port, queries, _ = wide_ivf
    want_i, want_d = jivf.ivf_query(ref, jnp.asarray(queries), nprobe, k)
    got_i, got_d = ivf_query(port, queries, nprobe, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy().view(np.uint32),
                                  np.asarray(want_d).view(np.uint32))


#: N_s = 20 subspaces of 8 dims (d = 160), K = 64 cells (sqrt_k 8)
CFG = dict(n_subspaces=20, subspace_dim=8, n_clusters=64, alpha=0.05, beta=0.02)


@pytest.fixture(scope="module", params=["entropy", "none"])
def wide_taco(request):
    """A reference TaCo index at N_s = 20 over an integer 4000 x 160 corpus,
    made integer-valued, and the same arrays as a port index."""
    rng = np.random.default_rng(20)
    data = rng.integers(-10, 11, (IVF_N, 160)).astype(np.float32)
    queries = rng.integers(-10, 11, (12, 160)).astype(np.float32)
    ref = integer_valued(jtaco.build(data, j_taco_config(**CFG, transform=request.param)))
    port = taco.index_from_arrays(reference_arrays(ref), ref.sub_dims, device="cpu")
    return request.param, ref, port, queries


def _both(wide_taco, k, **kw):
    transform, ref, port, queries = wide_taco
    cfg = dict(CFG, transform=transform, **kw)
    want = jtaco.query_with_stats(ref, jnp.asarray(queries), j_taco_config(**cfg), k=k)
    got = taco.query_with_stats(port, torch.from_numpy(queries), taco_config(**cfg), k=k)
    return got, want


def _assert_same(got, want, keys):
    gi, gd, gs = got
    wi, wd, ws = want
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    for key in keys:
        np.testing.assert_array_equal(gs[key].numpy(), np.asarray(ws[key]), err_msg=key)
    for key in ("taus", "retrieved"):
        np.testing.assert_array_equal(gs[key].numpy().view(np.uint32),
                                      np.asarray(ws[key]).view(np.uint32), err_msg=key)


@pytest.mark.parametrize("rerank", ["masked_full", "gather"])
@pytest.mark.parametrize("selection", ["query_aware", "fixed"])
@pytest.mark.parametrize("k", [10, 50])
def test_wide_taco_query_bitwise(wide_taco, rerank, selection, k):
    """N_s = 20 takes the wide collision kernels on the card; on the CPU
    both pipelines equal the reference bit for bit."""
    assert schist_geometry(12, 20, 64).wide
    keys = ("sc_threshold", "candidate_count", "candidate_demand", "truncated")
    if rerank == "gather":
        keys = ("sc",) + keys
    _assert_same(*_both(wide_taco, k, rerank=rerank, selection=selection), keys)


@pytest.mark.parametrize("selection", ["query_aware", "fixed"])
def test_wide_taco_masked_full_past_k_1024(wide_taco, selection):
    """A masked-full query at k = 1100 (16 lanes a block on the card, past
    the 1024 the kernel once took), with a budget wide enough to fill it:
    ids, distances and statistics bit for bit."""
    assert rerank_geometry(IVF_N, 1100, 20, 64, 160).lanes == 16
    got, want = _both(wide_taco, 1100, rerank="masked_full", selection=selection, beta=0.4)
    _assert_same(got, want, ("sc_threshold", "candidate_count", "candidate_demand", "truncated"))
    assert (got[0].numpy() >= 0).mean() > 0.9


@pytest.mark.parametrize("selection", ["query_aware", "fixed"])
def test_wide_taco_gather_in_query_chunks(wide_taco, selection, monkeypatch):
    """The gather re-rank past its byte budget (at 960 dims a 1000-query
    batch would gather 73 GiB of candidate rows) runs in query chunks: one
    query a chunk gives the reference's answer bit for bit."""
    monkeypatch.setattr(taco, "RERANK_CHUNK_BYTES", 1)
    got, want = _both(wide_taco, 10, rerank="gather", selection=selection)
    _assert_same(got, want, ("sc", "sc_threshold", "candidate_count", "candidate_demand",
                             "truncated"))


@pytest.mark.parametrize("n_pairs,n,w", [(1, 10 ** 6, 960), (1, 10 ** 7, 960), (1, 4000, 160),
                                         (12, 10 ** 6, 512), (65535, 10 ** 6, 4096)])
def test_wide_scratch_is_bounded(n_pairs, n, w):
    """The wide path's scratch holds a run of row blocks, not the corpus:
    its points' part stays within WIDE_RUN_BYTES (one row block where not
    even one wave fits), a run is whole waves of 132 blocks where it splits
    the points, and a corpus that fits is one run."""
    from repro_torch.kernels import kmeans_assign as K

    blocks = K.wide_run_blocks(n_pairs, n, w)
    total = -(-n // K.TILE_POINTS)
    wp = -(-w // K.WIDE_CHUNK) * K.WIDE_CHUNK
    per_block = 4 * n_pairs * K.TILE_POINTS * (wp + 2)
    assert 1 <= blocks <= total
    assert blocks * per_block <= max(K.WIDE_RUN_BYTES, per_block)
    if blocks < total and blocks * per_block >= 132 * per_block:
        assert blocks % 132 == 0
    if total * per_block <= K.WIDE_RUN_BYTES:
        assert blocks == total
    centroids = K.tiled_scratch_floats(n_pairs, 1024, w)
    assert K.tiled_scratch_floats(n_pairs, 1024, w, n) - centroids == \
        n_pairs * blocks * K.TILE_POINTS * (wp + 2)

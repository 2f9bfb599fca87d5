"""The paper's baselines in the port against ``repro``: the vector-file
readers (``data.io``), IVF-Flat (``core.ivf``) and SC-Linear
(``core.sclinear``), plus the plain twin of ``kmeans_assign`` past shared
memory, the shape IVF's k-means gives the kernel.

On integer-valued inputs every float32 sum is exact whatever its order, so
lists, ids, distances and SC-scores must be bit for bit the reference's.
The port draws its k-means from a torch generator, not a JAX key, so a
build of its own is held to the reference build's recall instead.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.clustering import kmeans as j_kmeans
from repro.core import ivf as jivf
from repro.core import sclinear as jsclinear
from repro.core.config import suco_config as j_suco_config
from repro.data import io as jio
from repro.kernels import ops as jops
from repro.utils import exact_knn, recall_at_k
from repro_torch.core import SCLinear, build_ivf, ivf, ivf_query, sclinear
from repro_torch.core.config import suco_config
from repro_torch.core.ivf import ivf_index_from_arrays, ivf_lists
from repro_torch.core.sclinear import sclinear_sc_scores
from repro_torch.data import gmm_dataset, io, make_queries
from repro_torch.kernels.kmeans_assign import MAX_SMEM, kmeans_assign_plain, tiled


# ---------------------------------------------------------------- data.io --
_DRAW = {"fvecs": lambda rng, s: rng.standard_normal(s).astype(np.float32),
         "bvecs": lambda rng, s: rng.integers(0, 256, s).astype(np.uint8),
         "ivecs": lambda rng, s: rng.integers(-2**31, 2**31, s).astype(np.int32)}


@pytest.mark.parametrize("kind", sorted(_DRAW))
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_vecs_round_trip_across_the_packages(tmp_path, kind, writer):
    """What one package writes the other reads back exactly, byte for byte
    the same file, with ``max_count`` and an empty file as the reference
    reads them."""
    data = _DRAW[kind](np.random.default_rng(len(kind)), (37, 13))
    mine, theirs = (io, jio) if writer == "port" else (jio, io)
    path = str(tmp_path / f"a.{kind}")
    mine.write_vecs(path, data)
    got = theirs.read_vecs(path)
    assert got.dtype == data.dtype
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(theirs.read_vecs(path, max_count=5), data[:5])
    other = str(tmp_path / f"b.{kind}")
    theirs.write_vecs(other, data)
    assert open(path, "rb").read() == open(other, "rb").read()
    empty = str(tmp_path / f"e.{kind}")
    open(empty, "wb").close()
    assert io.read_vecs(empty).shape == jio.read_vecs(empty).shape == (0, 0)


# ------------------------------------------------------------------- IVF --
@pytest.fixture(scope="module")
def int_ivf():
    """A reference IVF index over an integer corpus, its centroids rounded
    (every distance then exact), and the same arrays as a port index."""
    rng = np.random.default_rng(3)
    data = rng.integers(-6, 7, (1500, 16)).astype(np.float32)
    queries = rng.integers(-6, 7, (23, 16)).astype(np.float32)
    ref = jivf.build_ivf(data, n_lists=24, kmeans_iters=4, seed=1)
    ref = dataclasses.replace(ref, centroids=jnp.round(ref.centroids))
    port = ivf_index_from_arrays(np.asarray(ref.centroids), np.asarray(ref.lists),
                                 np.asarray(ref.data), device="cpu")
    return ref, port, data, queries


def test_ivf_lists_equal_the_references_from_its_assignments(int_ivf):
    """The stable-sort lists from the reference k-means' assignments are the
    reference loop's lists, bit for bit (padding and Lmax included)."""
    ref, _port, data, _q = int_ivf
    _c, assign = j_kmeans(jax.random.PRNGKey(1), jnp.asarray(data), 24, 4)
    got = ivf_lists(torch.as_tensor(np.array(assign)), 24)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.lists))


@pytest.mark.parametrize("nprobe,k", [(1, 1), (1, "lmax"), (3, 10), (8, 50), (24, 100)])
def test_ivf_query_bitwise_on_an_integer_index(int_ivf, nprobe, k, monkeypatch):
    """Ids and distances bit for bit, ties (many, on a small integer range)
    to the lowest position, unfilled slots -1 / +inf; one query a chunk
    gives the unchunked answer."""
    ref, port, _data, queries = int_ivf
    k = port.lists.shape[1] if k == "lmax" else k
    want_i, want_d = jivf.ivf_query(ref, jnp.asarray(queries), nprobe, k)
    got_i, got_d = ivf_query(port, queries, nprobe, k)
    assert got_i.dtype == torch.int32 and got_d.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy().view(np.uint32),
                                  np.asarray(want_d).view(np.uint32))
    monkeypatch.setattr(ivf, "CHUNK_BYTES", 1)
    one_i, one_d = ivf_query(port, queries, nprobe, k)
    assert torch.equal(one_i, got_i) and torch.equal(one_d, got_d)
    if k == port.lists.shape[1]:
        assert bool((got_i == -1).any())  # a list shorter than Lmax


def test_ivf_index_bytes_and_refusals(int_ivf):
    ref, port, _d, queries = int_ivf
    assert port.index_bytes == (np.asarray(ref.centroids).nbytes + np.asarray(ref.lists).nbytes)
    for nprobe, k in ((0, 1), (25, 1), (1, 0), (1, port.lists.shape[1] + 1)):
        with pytest.raises(ValueError):
            ivf_query(port, queries, nprobe, k)


def test_ivf_build_of_its_own_reaches_the_reference_recall():
    """On a float gmm corpus, each package's own build (its own k-means
    draws) at 32 lists and nprobe 4: the port's recall@10 against exact
    search within 0.03 of the reference's, the lists a partition of the
    points in increasing id order."""
    full = gmm_dataset(3000 + 50, 32, seed=5)
    data, queries = make_queries(full, 50)
    gt = np.asarray(exact_knn(jnp.asarray(data), jnp.asarray(queries), 10)[0])
    ref = jivf.build_ivf(data, n_lists=32, kmeans_iters=8, seed=0)
    want = recall_at_k(np.asarray(jivf.ivf_query(ref, jnp.asarray(queries), 4, 10)[0]), gt, 10)
    port = build_ivf(data, n_lists=32, kmeans_iters=8, seed=0, device="cpu")
    got = recall_at_k(ivf_query(port, queries, 4, 10)[0].numpy(), gt, 10)
    assert got >= want - 0.03, (got, want)
    lists = port.lists.numpy()
    ids = lists[lists >= 0]
    np.testing.assert_array_equal(np.sort(ids), np.arange(data.shape[0]))
    for row in lists:
        filled = row[row >= 0]
        assert (np.diff(filled) > 0).all() and (row[len(filled):] == -1).all()


# ------------------------------------------------------------- SC-Linear --
@pytest.fixture(scope="module")
def int_corpus():
    rng = np.random.default_rng(9)
    data = rng.integers(-5, 6, (1200, 20)).astype(np.float32)
    queries = rng.integers(-5, 6, (17, 20)).astype(np.float32)
    return data, queries


@pytest.mark.parametrize("alpha", [0.001, 0.05, 0.3])
def test_sclinear_sc_scores_bitwise(int_corpus, alpha):
    data, queries = int_corpus
    cfg = j_suco_config(n_subspaces=3, alpha=alpha)
    ref = jsclinear.SCLinear(data, cfg)
    want = jsclinear.sclinear_sc_scores(ref.data, jnp.asarray(queries), ref.sub_dims,
                                        ref.dim_perm, alpha)
    got = sclinear_sc_scores(torch.as_tensor(data), torch.as_tensor(queries), ref.sub_dims,
                             np.asarray(ref.dim_perm), alpha)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("selection", ["query_aware", "fixed"])
@pytest.mark.parametrize("k", [1, 10])
def test_sclinear_query_bitwise(int_corpus, selection, k, monkeypatch):
    """Ids and distances bit for bit, the dimension partition drawn the
    same way; one query a chunk gives the unchunked answer."""
    data, queries = int_corpus
    kw = dict(n_subspaces=4, alpha=0.05, beta=0.02, k=k, selection=selection)
    want_i, want_d = jsclinear.SCLinear(data, j_suco_config(**kw)).query(queries)
    port = SCLinear(data, suco_config(**kw), device="cpu")
    got_i, got_d = port.query(queries)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy().view(np.uint32),
                                  np.asarray(want_d).view(np.uint32))
    monkeypatch.setattr(sclinear, "CHUNK_BYTES", 1)
    one_i, one_d = port.query(queries)
    assert torch.equal(one_i, got_i) and torch.equal(one_d, got_d)


# ------------------------------------------ kmeans_assign past shared memory --
@pytest.mark.parametrize("w,k", [(64, 1000), (128, 1024), (5, 12000)])
def test_kmeans_assign_plain_twin_past_shared_memory(w, k):
    """At k (w + 1) floats above 227 KB (the card's tiled path) the plain
    twin equals ``repro``'s kmeans_assign, plain and Pallas (interpret), on
    integer inputs with many ties (the first index wins)."""
    assert tiled(k, w) and k * (w + 1) * 4 > MAX_SMEM
    rng = np.random.default_rng(w + k)
    x = rng.integers(-3, 4, (300, w)).astype(np.float32)
    c = rng.integers(-3, 4, (k, w)).astype(np.float32)
    ga, gd = kmeans_assign_plain(torch.as_tensor(x), torch.as_tensor(c))
    for impl in ("jnp", "pallas"):
        wa, wd = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c), impl=impl)
        np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))

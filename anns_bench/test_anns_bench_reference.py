"""The plain reference held to the program at small sizes on the CPU.

Build: the same corpus through ``repro_torch``'s build (its plain path on the
CPU) and through the reference: the same transform and the same IMI
assignments. Query: the program's query run over the reference's own index
(handed over as arrays) gives the reference's activation thresholds, Alg. 5
levels, candidate counts and answers, on both pipelines. And the control,
the reference in (emulated) TF32, reads apart from it."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from anns_bench.data import gmm
from anns_bench.reference import precision, taco_ref

TACO = {"n_subspaces": 4, "subspace_dim": 8, "n_clusters": 64, "kmeans_iters": 4,
        "alpha": 0.05, "beta": 0.02, "transform": "entropy", "activation": "sort",
        "selection": "query_aware", "kmeans_init": "random", "seed": 0,
        "use_kernels": True, "precision": "f32"}
MIX = {"n_clusters": 16, "cluster_std": 0.15, "rank_frac": 0.4, "noise_decay": 1.0,
       "query_noise": 0.01}


@pytest.fixture(scope="module")
def corpus():
    return gmm.corpus_and_queries(MIX, 3000, 32, 48, 5, "cpu")


@pytest.fixture(scope="module")
def ref(corpus):
    return taco_ref.build(corpus[0], TACO)


def program_index(ref):
    """The program's SCIndex over the reference's arrays."""
    from repro_torch.core.taco import index_from_arrays

    arrays = {"transform.mean": ref.mean.numpy(), "transform.basis": ref.basis.numpy(),
              "transform.eigvals": ref.eigvals.numpy(), "data": ref.data.numpy(),
              "data_norms": torch.sum(ref.data * ref.data, dim=1).numpy()}
    k = ref.sqrt_k
    for s in range(TACO["n_subspaces"]):
        a1, a2 = ref.assign[2 * s], ref.assign[2 * s + 1]
        arrays.update({
            f"subspaces.{s}.centroids1": ref.centroids[2 * s, :, :ref.dims[2 * s]].numpy(),
            f"subspaces.{s}.centroids2": ref.centroids[2 * s + 1, :, :ref.dims[2 * s + 1]].numpy(),
            f"subspaces.{s}.assign1": a1.numpy(), f"subspaces.{s}.assign2": a2.numpy(),
            f"subspaces.{s}.cell_sizes": torch.bincount(a1 * k + a2, minlength=k * k)
            .reshape(k, k).numpy()})
    return index_from_arrays(arrays, (TACO["subspace_dim"],) * TACO["n_subspaces"], device="cpu")


def test_build_matches_the_program(corpus, ref):
    from repro_torch.ann import AnnIndex
    from repro_torch.core.config import SCConfig

    idx = AnnIndex.build(corpus[0], SCConfig(**TACO), device="cpu").sc_index
    assert torch.allclose(idx.transform.mean, ref.mean, rtol=0, atol=1e-7)
    assert torch.allclose(idx.transform.basis, ref.basis, rtol=0, atol=1e-6)
    assert torch.allclose(idx.transform.eigvals, ref.eigvals, rtol=1e-6, atol=0)
    a1s, a2s = idx.assignments
    prog = torch.stack([a1s, a2s], dim=1).reshape(-1, a1s.shape[1]).long()
    assert float((prog == ref.assign).double().mean()) >= 0.999
    for s, sub in enumerate(idx.subspaces):
        c = ref.centroids[2 * s, :, :ref.dims[2 * s]]
        assert torch.allclose(sub.centroids1, c, rtol=0, atol=1e-5)


def test_build_repeats_bit_for_bit(corpus, ref):
    again = taco_ref.build(corpus[0], TACO)
    assert torch.equal(again.assign, ref.assign) and torch.equal(again.centroids, ref.centroids)


@pytest.mark.parametrize("rerank", ["masked_full", "gather"])
def test_query_matches_the_program_on_one_index(corpus, ref, rerank):
    from repro_torch.core.config import SCConfig
    from repro_torch.core.taco import query_with_stats

    queries = corpus[1]
    cfg = SCConfig(**TACO, k=10, rerank=rerank)
    ids, dists, stats = query_with_stats(program_index(ref), queries, cfg)
    got = taco_ref.query(ref, queries, TACO, k=10, rerank=rerank)
    assert torch.equal(stats["taus"], got["taus"])
    assert torch.equal(stats["sc_threshold"].long(), got["thresh"])
    assert torch.equal(stats["candidate_count"].long(), got["count"])
    assert float((ids.long() == got["ids"]).double().mean()) >= 0.99
    assert torch.equal(got["exact_ids"][:, :10], got["exact_ids"])
    # the reference's exact answers are the exact top-k of its candidates
    hit = (got["exact_ids"][:, :, None] == ids.long()[:, None, :]).any(2)
    assert float(hit.double().mean()) >= 0.99
    fin = torch.isfinite(dists)
    assert torch.allclose(dists[fin], got["dists"][fin], rtol=1e-5, atol=1e-6)


def test_alg5_against_the_literal_loop():
    rng = np.random.default_rng(3)
    hist = torch.as_tensor(rng.integers(0, 400, size=(200, 7)))
    beta_n, n_sub = 900.0, 6
    got = taco_ref.alg5_threshold(hist, beta_n, n_sub)
    for row, level in zip(hist.tolist(), got.tolist()):
        last, cand = n_sub, 0
        for j in range(n_sub, -1, -1):
            cand += row[j]
            if row[j] <= beta_n - cand:
                last -= 1
            else:
                break
        assert level == last


def test_gather_cap():
    assert taco_ref.gather_cap({"beta": 0.005}, 10 ** 6, 10) == 20_000
    assert taco_ref.gather_cap({"beta": 0.005}, 1000, 10) == 40
    assert taco_ref.gather_cap({"beta": 0.5}, 100, 10) == 100
    assert taco_ref.gather_cap({"beta": 0.0}, 1000, 300) == 1000


def test_tf32_truncation():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, -3.0 - 2.0 ** -20])
    assert precision.tf32_truncate(x).tolist() == [1.0 + 2.0 ** -10, 1.0, -3.0]
    a, b = torch.randn(64, 96), torch.randn(96, 32)
    exact = a.double() @ b.double()
    f32 = (precision.matmul(a, b, "f32").double() - exact).abs().max()
    tf32 = (precision.matmul(a, b, "tf32").double() - exact).abs().max()
    assert tf32 > 100 * f32
    with pytest.raises(ValueError):
        precision.matmul(a, b, "bf16")


def test_exact_topk_orders_by_distance_then_id():
    data = torch.tensor([[0.0], [1.0], [-1.0], [2.0]])
    q = torch.tensor([[0.0]])
    approx = torch.tensor([[0.0, 1.0, 1.0, math.inf]])
    ids, d = taco_ref.exact_topk(data, q, approx, 4)
    assert ids.tolist() == [[0, 1, 2, -1]]
    assert d[0, :3].tolist() == [0.0, 1.0, 1.0]

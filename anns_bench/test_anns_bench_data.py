"""The benchmark's corpus and queries: shapes, the same seed gives the same
draws, another seed other draws, and the queries are no corpus points. CPU
here; the card's draws in the ``cuda`` test, which skips without a card."""
from __future__ import annotations

import pytest
import torch

from anns_bench.data import gmm

PARAMS = {"n_clusters": 16, "cluster_std": 0.15, "rank_frac": 0.4, "noise_decay": 1.0,
          "query_noise": 0.01}


def draw(seed, device="cpu", n=3000, d=24, q=50):
    return gmm.corpus_and_queries(PARAMS, n, d, q, seed, device)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_shapes_and_dtype():
    corpus, queries = draw(7)
    assert corpus.shape == (3000, 24) and queries.shape == (50, 24)
    assert corpus.dtype == queries.dtype == torch.float32
    assert corpus.is_contiguous() and queries.is_contiguous()


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5, 2**40 + 3])
def test_same_seed_same_draws(seed):
    a, qa = draw(seed)
    b, qb = draw(seed)
    assert torch.equal(a, b) and torch.equal(qa, qb)


def test_other_seed_other_draws():
    a, qa = draw(1)
    b, qb = draw(2)
    assert not torch.equal(a, b) and not torch.equal(qa, qb)


def test_queries_are_not_corpus_points():
    corpus, queries = draw(3)
    assert float(torch.cdist(queries.double(), corpus.double()).min()) > 0.0
    # each query sits near its held-out source, at the noise's scale, not on it
    noise = 0.01 * gmm.global_std(torch.cat([corpus, queries]))
    assert float(torch.cdist(queries, corpus).min(dim=1).values.median()) > noise


def test_the_mixture_is_clustered_and_unit_scale():
    corpus, _ = draw(4, n=4000)
    norms = torch.linalg.vector_norm(corpus, dim=1)
    assert 0.8 < float(norms.median()) < 1.6  # unit centres plus 0.15-scale noise
    assert abs(gmm.global_std(corpus) - float(corpus.double().std(unbiased=False))) < 1e-9


def test_global_std_matches_numpy_rule():
    x = torch.randn(1000, 7) * 3 + 1
    want = float(x.double().std(unbiased=False))
    assert abs(gmm.global_std(x) - want) < 1e-12


@pytest.mark.cuda
def test_card_draws_repeat(card):
    a, qa = draw(11, device=card, n=100_000, d=128, q=1000)
    b, qb = draw(11, device=card, n=100_000, d=128, q=1000)
    assert a.is_cuda and a.shape == (100_000, 128) and qa.shape == (1000, 128)
    assert torch.equal(a, b) and torch.equal(qa, qb)
    assert float(torch.cdist(qa, a).min()) > 0.0

"""The batched centroid distances (``ops.l2dist_pairs``, one launch per
batch on the card) against the per-pair path and against ``repro``.

On the CPU the batched op is the per-pair plain version stacked, so it
must equal the per-pair path bit for bit. Against the reference's
``_centroid_distances`` (``ops.l2dist`` through its ``ref`` on the CPU, and
the Pallas kernel in interpret mode) it is bitwise on an integer-valued
index, where every f32 sum is exact whatever its order, and within 1e-5 on
a float index (as ``tests/test_torch_query.py``'s gmm gate). A TaCo index
has even halves (4/4); a SuCo index over 65 dims has subspaces of 21 and 23
dims, so halves of 10/11 and 11/12 go through the same launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import taco as jtaco
from repro.core.config import suco_config as j_suco_config
from repro.core.config import taco_config as j_taco_config
from repro.kernels import ops as jops
from repro_torch.core import taco
from repro_torch.core.imi import split_halves
from repro_torch.kernels import ops
from repro_torch.kernels.l2dist import l2dist_pairs_plain, l2dist_plain
from repro_torch.utils import round_bf16
from tests.test_torch_query import integer_valued, reference_arrays

CONFIGS = {
    "taco": (j_taco_config, dict(n_subspaces=3, subspace_dim=8, n_clusters=64), 24),
    "suco": (j_suco_config, dict(n_subspaces=3, n_clusters=64), 65),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def indexes(request):
    """(name, {"int": (ref, port), "float": (ref, port)}, int queries, float
    queries) for one config."""
    make_cfg, kw, d = CONFIGS[request.param]
    rng = np.random.default_rng(5)
    out = {}
    for kind in ("int", "float"):
        if kind == "int":
            data = rng.integers(-10, 11, (1500, d)).astype(np.float32)
        else:
            data = rng.standard_normal((1500, d)).astype(np.float32)
        ref = jtaco.build(data, make_cfg(**kw, alpha=0.05, beta=0.02))
        if kind == "int":
            ref = integer_valued(ref)
        out[kind] = (ref, taco.index_from_arrays(reference_arrays(ref), ref.sub_dims,
                                                 device="cpu"))
    q_int = rng.integers(-10, 11, (37, d)).astype(np.float32)
    q_float = rng.standard_normal((37, d)).astype(np.float32)
    return request.param, out, q_int, q_float


def per_pair(index, queries, precision):
    """The per-pair path the batched op replaces: one ``ops.l2dist`` per
    (subspace, half), each half's centroids rounded per batch under bf16."""
    pq = taco._project(index, queries)
    if precision == "bf16":
        pq = round_bf16(pq)
    d1s, d2s = [], []
    for (lo, hi), sub in zip(taco._sub_slices(index.sub_dims), index.subspaces):
        s1, _ = split_halves(hi - lo)
        c1, c2 = sub.centroids1, sub.centroids2
        if precision == "bf16":
            c1, c2 = round_bf16(c1), round_bf16(c2)
        d1s.append(ops.l2dist(pq[:, lo:lo + s1], c1))
        d2s.append(ops.l2dist(pq[:, lo + s1:hi], c2))
    return torch.stack(d1s), torch.stack(d2s)


def test_half_slices_cover_uneven_halves(indexes):
    name, idx, _qi, _qf = indexes
    port = idx["int"][1]
    slices = taco._half_slices(port.sub_dims)
    want = {"taco": ((0, 4), (8, 4), (16, 4), (4, 4), (12, 4), (20, 4)),
            "suco": ((0, 10), (21, 10), (42, 11), (10, 11), (31, 11), (53, 12))}[name]
    assert slices == want
    cents = port.stacked_centroids
    assert cents.shape == (6, 8, max(w for _c, w in want))
    for p, (_col, w) in enumerate(slices):
        sub = port.subspaces[p % 3]
        half = sub.centroids1 if p < 3 else sub.centroids2
        assert torch.equal(cents[p, :, :w], half)
        assert not cents[p, :, w:].any()
    assert torch.equal(port.stacked_centroids_bf16, round_bf16(cents))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_batched_equals_per_pair_bitwise(indexes, kind, precision):
    """``_centroid_distances(use_kernels=True)`` on the CPU and the
    batched plain op equal the per-pair path bit for bit."""
    _name, idx, q_int, q_float = indexes
    port = idx[kind][1]
    q = torch.from_numpy(q_int if kind == "int" else q_float)
    w1, w2 = per_pair(port, q, precision)
    g1, g2 = taco._centroid_distances(port, q, True, precision)
    assert torch.equal(g1, w1) and torch.equal(g2, w2)
    # the use_kernels=False path computes the same
    p1, p2 = taco._centroid_distances(port, q, False, precision)
    assert torch.equal(p1, w1) and torch.equal(p2, w2)
    pq = taco._project(port, q)
    if precision == "bf16":
        pq = round_bf16(pq)
    cents = port.stacked_centroids_bf16 if precision == "bf16" else port.stacked_centroids
    slices = taco._half_slices(port.sub_dims)
    got = ops.l2dist_pairs(pq, slices, cents, impl="torch")
    assert torch.equal(got, torch.cat([w1, w2]))
    assert torch.equal(got, l2dist_pairs_plain(pq, slices, cents))


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_against_reference_integer_bitwise(indexes, precision, use_kernels):
    _name, idx, q_int, _qf = indexes
    ref, port = idx["int"]
    w1, w2 = jtaco._centroid_distances(ref, jnp.asarray(q_int), use_kernels, precision)
    g1, g2 = taco._centroid_distances(port, torch.from_numpy(q_int), True, precision)
    np.testing.assert_array_equal(g1.numpy(), np.asarray(w1))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(w2))


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_against_reference_float(indexes, precision, use_kernels):
    _name, idx, _qi, q_float = indexes
    ref, port = idx["float"]
    w1, w2 = jtaco._centroid_distances(ref, jnp.asarray(q_float), use_kernels, precision)
    g1, g2 = taco._centroid_distances(port, torch.from_numpy(q_float), True, precision)
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g2.numpy(), np.asarray(w2), rtol=1e-5, atol=1e-5)


def test_against_pallas_interpret_integer_bitwise(indexes):
    """Each pair of the batched op against the reference's Pallas
    ``l2dist`` run in interpret mode (padded to 128, as on the TPU)."""
    _name, idx, q_int, _qf = indexes
    port = idx["int"][1]
    pq = taco._project(port, torch.from_numpy(q_int))
    slices = taco._half_slices(port.sub_dims)
    got = ops.l2dist_pairs(pq, slices, port.stacked_centroids)
    for p, (col, w) in enumerate(slices):
        want = jops.l2dist(jnp.asarray(pq[:, col:col + w].numpy()),
                           jnp.asarray(port.stacked_centroids[p, :, :w].numpy()),
                           impl="pallas")
        np.testing.assert_array_equal(got[p].numpy(), np.asarray(want))


def test_centroid_stacks_are_not_index_bytes(indexes):
    _name, idx, _qi, _qf = indexes
    port = idx["int"][1]
    before = port.index_bytes
    assert port.stacked_centroids.numel() and port.stacked_centroids_bf16.numel()
    assert port.index_bytes == before


def test_pairs_plain_rejects_bad_slices():
    x, y = torch.zeros((3, 8)), torch.zeros((2, 5, 4))
    with pytest.raises(ValueError):
        l2dist_pairs_plain(x, ((0, 4),), y)  # one slice for two pairs
    with pytest.raises(ValueError):
        l2dist_pairs_plain(x, ((0, 4), (6, 4)), y)  # past x's columns
    with pytest.raises(ValueError):
        l2dist_pairs_plain(x, ((0, 5), (0, 4)), y)  # wider than y
    assert torch.equal(l2dist_pairs_plain(x, ((0, 4), (4, 2)), y)[1],
                       l2dist_plain(x[:, 4:6], y[1, :, :2]))

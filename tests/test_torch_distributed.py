"""The port's corpus-sharded query and build statistics
(``repro_torch.core.distributed``, ``ShardedSearcher``) on the CPU.

The reference's sharded results need 8 forced host devices, and
``XLA_FLAGS`` must be set before jax starts, so they are computed once for
this module in a subprocess (as ``tests/test_distributed.py`` runs its
script) and compared here:

  * on an integer-valued index (built by ``repro``, carried across with
    ``index_from_arrays``) every f32 sum of the query path is exact, so at
    S = 2, 4, 8 shards, both pipelines, both selections and k = 5, 10 the
    port's ids, dists, ``shard_candidates``, ``shard_truncated``,
    ``truncated`` and ``candidate_count`` equal the reference sharded
    searcher's bit for bit;
  * the distributed covariance, Lloyd step and cell sizes equal the
    reference's bit for bit on an integer corpus; on a float corpus the
    Lloyd assignments are bitwise, the centroids within rtol = atol = 1e-5,
    and the moments within the reference test's tolerances.

Against the port's own single-device search, at S = 1, 2, 4, 8: bitwise
wherever no shard truncates (masked-full, both selections; query-aware
gather), the summed ``shard_candidates`` equal to the single-device demand;
on a float gmm corpus ids >= 99.9 % equal, dists within rtol 1e-6 and the
same recall.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.ann import AnnIndex as JAnnIndex
from repro.core import taco as jtaco
from repro.core.config import taco_config as j_taco_config
from repro_torch.ann import AnnIndex, ShardedSearcher, make_searcher
from repro_torch.core import distributed, taco
from repro_torch.core.config import taco_config
from repro_torch.data import gmm_dataset, make_queries
from repro_torch.utils import recall_at_k
from tests.test_torch_query import integer_valued, reference_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(n_subspaces=3, subspace_dim=6, n_clusters=64, alpha=0.05, beta=0.02, k=10)
SHARDS = (2, 4, 8)
PIPELINES = [(r, s) for r in ("gather", "masked_full") for s in ("query_aware", "fixed")]
#: the (pipeline, selection) pairs whose sharded result is the single-device
#: one when no shard truncates (fixed gather splits the budget per shard)
EXACT = [("masked_full", "query_aware"), ("masked_full", "fixed"), ("gather", "query_aware")]
BUCKET = 16  # 12 queries pad to this bucket in both packages
FIELDS = ("ids", "dists", "truncated", "candidate_count", "shard_candidates",
          "shard_truncated")
STAT_S = 4  # shards of the build statistics, as in tests/test_distributed.py

REFERENCE = r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.ann import AnnIndex
from repro.ann.searcher import make_searcher
from repro.batching import pad_rows
from repro.core.distributed import (
    make_distributed_cell_sizes, make_distributed_cov, make_distributed_lloyd)

index_dir, inputs, out = sys.argv[1:4]
assert len(jax.devices()) == 8, jax.devices()
index = AnnIndex.load(index_dir)
arr = dict(np.load(inputs))
queries = pad_rows(arr["queries"], int(arr["bucket"]))
res = {}
for S in (2, 4, 8):
    searcher = make_searcher(index.sc_index, index.cfg, "sharded", shards=S)
    for rerank in ("gather", "masked_full"):
        for sel in ("query_aware", "fixed"):
            cfg = dataclasses.replace(index.cfg, rerank=rerank, selection=sel)
            for k in (5, 10):
                r = searcher.run_padded(len(queries), k, cfg, queries)
                for f in ("ids", "dists", "truncated", "candidate_count",
                          "shard_candidates", "shard_truncated"):
                    res[f"{S}/{rerank}/{sel}/{k}/{f}"] = np.asarray(getattr(r, f))
mesh = jax.make_mesh((4,), ("data",))
for kind in ("int", "float"):
    x = jnp.asarray(arr[f"{kind}_corpus"])
    xs = jax.device_put(x, NamedSharding(mesh, P("data", None)))
    mean, cov = make_distributed_cov(mesh, x.shape[0])(xs)
    c1, assign = make_distributed_lloyd(mesh)(xs, x[:16])
    res.update({f"{kind}/mean": mean, f"{kind}/cov": cov, f"{kind}/centroids": c1,
                f"{kind}/assign": assign})
a1, a2 = (jax.device_put(jnp.asarray(arr[a]), NamedSharding(mesh, P("data")))
          for a in ("a1", "a2"))
res["cell_sizes"] = make_distributed_cell_sizes(mesh, 16)(a1, a2)
np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
print("REFERENCE_OK")
"""


def run_reference(script: str, *args) -> str:
    """Run ``script`` with 8 forced host devices (fresh jax) from the repo
    root; fail with its output unless it printed ``REFERENCE_OK``."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), ROOT, env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", script, *map(str, args)], env=env,
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0 and "REFERENCE_OK" in proc.stdout, (
        f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")
    return proc.stdout


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(port index on the CPU, its cfg, queries, reference results, inputs):
    an integer-valued 2048 x 24 TaCo index built by ``repro``, 12 integer
    queries, and the build statistics' corpora."""
    tmp = tmp_path_factory.mktemp("distributed")
    rng = np.random.default_rng(5)
    data = rng.integers(-10, 11, (2048, 24)).astype(np.float32)
    queries = rng.integers(-10, 11, (12, 24)).astype(np.float32)
    jcfg = j_taco_config(**CFG)
    ref = integer_valued(jtaco.build(data, jcfg))
    JAnnIndex(sc_index=ref, cfg=jcfg).save(str(tmp / "index"))
    inputs = dict(queries=queries, bucket=BUCKET,
                  int_corpus=rng.integers(-10, 11, (4096, 24)).astype(np.float32),
                  float_corpus=gmm_dataset(4096, 32, seed=7),
                  a1=rng.integers(0, 16, 4096).astype(np.int32),
                  a2=rng.integers(0, 16, 4096).astype(np.int32))
    np.savez(tmp / "inputs.npz", **inputs)
    run_reference(REFERENCE, tmp / "index", tmp / "inputs.npz", tmp / "ref.npz")
    port = taco.index_from_arrays(reference_arrays(ref), ref.sub_dims, device="cpu")
    return port, taco_config(**CFG), queries, dict(np.load(tmp / "ref.npz")), inputs


def padded(queries) -> torch.Tensor:
    return torch.from_numpy(np.concatenate(
        [queries, np.repeat(queries[-1:], BUCKET - len(queries), axis=0)]))


# ------------------------------------------------------ against the reference --
@pytest.mark.parametrize("k", [5, 10])
@pytest.mark.parametrize("rerank, selection", PIPELINES)
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_search_bitwise_equals_the_reference(case, shards, rerank, selection, k):
    port, cfg, queries, ref, _inputs = case
    cfg = dataclasses.replace(cfg, rerank=rerank, selection=selection)
    searcher = make_searcher(port, cfg, "sharded", shards=shards)
    assert isinstance(searcher, ShardedSearcher) and searcher.shards == shards
    got = searcher.run_padded(BUCKET, k, cfg, padded(queries))
    for field in FIELDS:
        want = ref[f"{shards}/{rerank}/{selection}/{k}/{field}"]
        value = getattr(got, field)
        assert value.dtype == want.dtype, field
        if field == "dists":
            value, want = value.view(np.uint32), want.view(np.uint32)
        np.testing.assert_array_equal(value, want, err_msg=field)
    assert got.shard_candidates.shape == (BUCKET, shards)


@pytest.mark.parametrize("stat", ["cov", "lloyd"])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_build_statistics_equal_the_reference(case, kind, stat):
    _port, _cfg, _queries, ref, inputs = case
    x = torch.from_numpy(inputs[f"{kind}_corpus"])
    mesh = ["cpu"] * STAT_S
    xs = distributed.shard_rows(x, mesh)
    assert all(s.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
               for s in xs)  # row views, not copies
    if stat == "cov":
        mean, cov = distributed.make_distributed_cov(mesh, x.shape[0])(xs)
        if kind == "int":
            np.testing.assert_array_equal(mean.numpy(), ref["int/mean"])
            np.testing.assert_array_equal(cov.numpy(), ref["int/cov"])
        else:  # tests/test_distributed.py's tolerances
            np.testing.assert_allclose(mean.numpy(), ref["float/mean"], rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(cov.numpy(), ref["float/cov"], rtol=2e-2, atol=2e-4)
        return
    c1, assign = distributed.make_distributed_lloyd(mesh)(xs, x[:16])
    np.testing.assert_array_equal(assign.numpy(), ref[f"{kind}/assign"])
    if kind == "int":
        np.testing.assert_array_equal(c1.numpy(), ref["int/centroids"])
    else:
        np.testing.assert_allclose(c1.numpy(), ref["float/centroids"], rtol=1e-5, atol=1e-5)
    # the one-device Lloyd step gives the same step
    from repro_torch.clustering.kmeans import lloyd_step

    c_one, a_one = lloyd_step(x, x[:16])
    np.testing.assert_array_equal(assign.numpy(), a_one.numpy())
    np.testing.assert_allclose(c1.numpy(), c_one.numpy(), rtol=1e-5, atol=1e-5)


def test_cell_sizes_equal_the_reference_and_bincount(case):
    _port, _cfg, _queries, ref, inputs = case
    mesh = ["cpu"] * STAT_S
    a1s = distributed.shard_rows(torch.from_numpy(inputs["a1"]), mesh)
    a2s = distributed.shard_rows(torch.from_numpy(inputs["a2"]), mesh)
    got = distributed.make_distributed_cell_sizes(mesh, 16)(a1s, a2s)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref["cell_sizes"])
    want = np.zeros((16, 16), np.int64)
    np.add.at(want, (inputs["a1"], inputs["a2"]), 1)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="mesh"):
        distributed.make_distributed_cell_sizes(["cpu"] * 2, 16)(a1s, a2s)


# ------------------------------------------ against the port's single device --
def _single_and_sharded(index, cfg, queries, shards, k=None):
    single = make_searcher(index, cfg, "single").run_padded_device(
        BUCKET, cfg.k if k is None else k, cfg, padded(queries))
    views, n = distributed.shard_views(index, shards)
    sharded = distributed.make_distributed_query_with_stats(views, cfg, index, n, k=k)
    return single, sharded(padded(queries))


@pytest.mark.parametrize("rerank, selection", EXACT)
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_sharded_bitwise_equals_single_device_where_no_shard_truncates(
        case, shards, rerank, selection):
    port, cfg, queries, _ref, _inputs = case
    cfg = dataclasses.replace(cfg, rerank=rerank, selection=selection)
    (si, sd, _st, _sc), (gi, gd, stats) = _single_and_sharded(port, cfg, queries, shards)
    whole = ~stats["shard_truncated"].any(dim=1)
    # masked-full never truncates; on the gather pipeline the integer
    # corpus's many SC ties truncate some queries, on every placement alike
    assert whole.all() if rerank == "masked_full" else whole.sum() >= BUCKET // 3
    assert torch.equal(stats["shard_truncated"].any(dim=1), _st)
    assert torch.equal(gi[whole], si[whole])
    assert torch.equal(gd[whole].view(torch.int32), sd[whole].view(torch.int32))
    # the summed per-shard candidates are the single-device demand
    _i, _d, want = taco.query_with_stats(port, padded(queries), cfg)
    demand = stats["shard_candidates"].sum(dim=1)
    if selection == "query_aware" or rerank == "masked_full":
        assert torch.equal(demand.to(torch.int32), want["candidate_demand"])


@pytest.fixture(scope="module")
def float_index():
    data, queries = make_queries(gmm_dataset(8192 + 16, 64, seed=0), 16)
    cfg = taco_config(n_subspaces=4, subspace_dim=8, n_clusters=256, alpha=0.05, beta=0.02,
                      k=10)
    index = AnnIndex.build(data, cfg, device="cpu").sc_index
    d = torch.cdist(torch.from_numpy(queries).double(), torch.from_numpy(data).double())
    return index, cfg, queries, torch.topk(d, 10, largest=False).indices.numpy()


@pytest.mark.parametrize("rerank, selection", EXACT)
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_float_corpus_sharded_matches_single_device(float_index, shards, rerank, selection):
    index, cfg, queries, gt = float_index
    cfg = dataclasses.replace(cfg, rerank=rerank, selection=selection)
    (si, sd, _st, _sc), (gi, gd, stats) = _single_and_sharded(index, cfg, queries, shards)
    assert not stats["shard_truncated"].any()
    assert float((gi == si).double().mean()) >= 0.999
    torch.testing.assert_close(gd, sd, rtol=1e-6, atol=0.0)
    assert recall_at_k(gi[:16], gt, 10) == recall_at_k(si[:16], gt, 10)


# -------------------------------------------------------------- placement --
def test_shard_views_are_row_views_and_cells_are_made_once(case):
    port, _cfg, _queries, _ref, _inputs = case
    views, n = distributed.shard_views(port, 4)
    assert n == port.n == 2048 and [v.offset for v in views] == [0, 512, 1024, 1536]
    for v in views:
        assert v.n == 512
        assert v.data.untyped_storage().data_ptr() == port.data.untyped_storage().data_ptr()
        assert v.data_norms.untyped_storage().data_ptr() == (
            port.data_norms.untyped_storage().data_ptr())
        assert v.cells.is_contiguous()
        assert torch.equal(v.cells, port.cells[:, v.offset:v.offset + v.n])
        assert torch.equal(v.data, port.data[v.offset:v.offset + v.n])
    searcher = make_searcher(port, taco_config(**CFG), "sharded", shards=4)
    cells = [v.cells.data_ptr() for v in searcher.views]
    searcher.search(np.zeros((3, 24), np.float32))
    assert [v.cells.data_ptr() for v in searcher.views] == cells
    with pytest.raises(ValueError, match="divisible"):
        distributed.shard_views(port, 3)
    with pytest.raises(ValueError, match="devices"):
        distributed.shard_views(port, 2, ["cpu"])


def test_k_beyond_a_shard_raises_and_precision_is_not_read(case):
    port, cfg, queries, _ref, _inputs = case
    views, n = distributed.shard_views(port, 8)
    with pytest.raises(ValueError, match="shard"):
        distributed.make_distributed_query_with_stats(views, cfg, port, n, k=257)
    fn = distributed.make_distributed_query_with_stats(views, cfg, port, n, k=256)
    assert fn(queries)[0].shape == (12, 256)
    # the reference's sharded query is f32 whatever cfg.precision says
    for rerank in ("gather", "masked_full"):
        f32 = dataclasses.replace(cfg, rerank=rerank)
        bf16 = dataclasses.replace(f32, precision="bf16")
        a = distributed.make_distributed_query_with_stats(views, f32, port, n)(queries)
        b = distributed.make_distributed_query_with_stats(views, bf16, port, n)(queries)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    ids, dists = distributed.make_distributed_query(views, cfg, port, n)(queries)
    want = distributed.make_distributed_query_with_stats(views, cfg, port, n)(queries)
    assert torch.equal(ids, want[0]) and torch.equal(dists, want[1])


def test_per_shard_cap_is_the_references():
    from repro.core.config import SCConfig as JSCConfig
    from repro.core.distributed import per_shard_cap as j_per_shard_cap

    for kw, n_local, k in ((dict(beta=0.02), 512, 10), (dict(beta=0.0001), 512, 10),
                           (dict(beta=0.5), 100, 10), (dict(candidate_cap=7), 512, 10),
                           (dict(candidate_cap=7), 512, 3)):
        got = distributed.per_shard_cap(taco_config(**kw), n_local, k)
        assert got == j_per_shard_cap(JSCConfig(**kw), n_local, k)

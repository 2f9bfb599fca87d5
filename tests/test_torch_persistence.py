"""The port's on-disk index format, single-device searcher and facade
contract, against ``repro``.

An index saved by ``repro`` loads in the port and one saved by the port
loads in ``repro``: every array, the manifest's leaf paths, dtypes and
shapes, and the search results are bitwise equal both ways, on the
integer-valued indexes of ``tests/test_torch_query.py`` (every float32 sum
exact). The searcher's cache and bucket padding, and ``AnnIndex.search``'s
return contract, are held to ``repro.ann``'s.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import AnnIndex as JAnnIndex
from repro.ann.persistence import load_index as j_load_index
from repro.ann.persistence import save_index as j_save_index
from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.core import taco as jtaco
from repro.core.config import ABLATIONS as J_ABLATIONS
from repro_torch.ann import AnnIndex
from repro_torch.ann.persistence import load_index, save_index
from repro_torch.ann.searcher import SingleDeviceSearcher
from repro_torch.batching import ANN_BATCH_BUCKETS, bucket_size, pad_rows
from repro_torch.core import taco
from repro_torch.core.config import ABLATIONS
from tests.test_torch_query import integer_valued, reference_arrays

CFG = dict(n_subspaces=3, subspace_dim=6, n_clusters=64, alpha=0.05, beta=0.02, k=10)


@pytest.fixture(scope="module", params=["taco", "suco"])
def pair(request):
    """(name, reference AnnIndex, port AnnIndex, queries): the same
    integer-valued index in both packages (TaCo: a transform and no
    dim_perm; SuCo: a dim_perm and no transform)."""
    rng = np.random.default_rng(11)
    data = rng.integers(-10, 11, (2000, 24)).astype(np.float32)
    queries = rng.integers(-10, 11, (12, 24)).astype(np.float32)
    jcfg = J_ABLATIONS[request.param](**CFG)
    ref = integer_valued(jtaco.build(data, jcfg))
    port = taco.index_from_arrays(reference_arrays(ref), ref.sub_dims, device="cpu")
    return (request.param, JAnnIndex(sc_index=ref, cfg=jcfg),
            AnnIndex(sc_index=port, cfg=ABLATIONS[request.param](**CFG)), queries)


def _port_leaves(index) -> list[np.ndarray]:
    sc = index.sc_index
    out = []
    if sc.transform is not None:
        out += [sc.transform.mean, sc.transform.basis, sc.transform.eigvals]
    if sc.dim_perm is not None:
        out.append(sc.dim_perm)
    for sub in sc.subspaces:
        out += [sub.centroids1, sub.centroids2, sub.assign1, sub.assign2, sub.cell_sizes]
    out.append(sc.data)
    if sc.data_norms is not None:
        out.append(sc.data_norms)
    return [t.numpy() for t in out]


def _assert_same_leaves(port_index, ref_index):
    got = _port_leaves(port_index)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref_index.sc_index)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


def _assert_same_search(port_index, ref_index, queries):
    for rerank in ("gather", "masked_full"):
        gi, gd, gs = port_index.search_with_stats(queries, rerank=rerank)
        wi, wd, ws = ref_index.search_with_stats(queries, rerank=rerank)
        np.testing.assert_array_equal(gi, np.asarray(wi))
        np.testing.assert_array_equal(gd.view(np.uint32), np.asarray(wd).view(np.uint32))
        for key in ("truncated", "candidate_count"):
            np.testing.assert_array_equal(gs[key], np.asarray(ws[key]), err_msg=key)


def test_reference_saved_index_loads_in_the_port(pair, tmp_path):
    _name, ref, port, queries = pair
    ref.save(str(tmp_path / "idx"))
    loaded = AnnIndex.load(str(tmp_path / "idx"), device="cpu")
    assert loaded.cfg == port.cfg and loaded.index_bytes == ref.index_bytes
    _assert_same_leaves(loaded, ref)
    _assert_same_search(loaded, ref, queries)


def test_port_saved_index_loads_in_the_reference(pair, tmp_path):
    _name, ref, port, queries = pair
    port.save(str(tmp_path / "idx"))
    loaded = JAnnIndex.load(str(tmp_path / "idx"))
    assert dataclasses.asdict(loaded.cfg) == dataclasses.asdict(port.cfg)
    _assert_same_leaves(port, loaded)
    _assert_same_search(port, loaded, queries)


def test_port_round_trip_is_bitwise(pair, tmp_path):
    name, _ref, port, queries = pair
    port.save(str(tmp_path / "idx"))
    loaded = AnnIndex.load(str(tmp_path / "idx"), device="cpu")
    assert (loaded.sc_index.transform is None) == (name == "suco")
    assert (loaded.sc_index.dim_perm is None) == (name == "taco")
    for a, b in zip(_port_leaves(loaded), _port_leaves(port)):
        assert torch.equal(torch.from_numpy(a), torch.from_numpy(b))
    for rerank in ("gather", "masked_full"):
        for got, want in zip(loaded.search(queries, rerank=rerank),
                             port.search(queries, rerank=rerank)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("norms", [True, False], ids=["norms", "no_norms"])
def test_manifest_equals_the_reference(pair, tmp_path, norms):
    """Leaf paths, dtypes, shapes and the meta, for TaCo, SuCo and an index
    without data_norms; the paths are the JAX key paths of the pytree."""
    _name, ref, port, _queries = pair
    ref_sc, port_sc = ref.sc_index, port.sc_index
    if not norms:
        ref_sc = dataclasses.replace(ref_sc, data_norms=None)
        port_sc = dataclasses.replace(port_sc, data_norms=None)
    j_save_index(ref_sc, ref.cfg, str(tmp_path / "ref"))
    save_index(port_sc, port.cfg, str(tmp_path / "port"))
    manifests = []
    for side in ("ref", "port"):
        with open(tmp_path / side / "step_0" / "manifest.json") as f:
            manifests.append(json.load(f))
    want, got = manifests
    assert got == want
    assert got["paths"] == _flatten_with_paths(ref_sc)[1]
    assert got["extra"]["has_data_norms"] is norms
    with open(tmp_path / "port" / "ann_index.json") as f:
        assert json.load(f) == got["extra"]
    with np.load(tmp_path / "ref" / "step_0" / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "step_0" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name].view(np.uint32), b[name].view(np.uint32))


def test_index_without_data_norms(pair, tmp_path):
    """data_norms=None round-trips as absent in both directions and queries
    through the derived norms."""
    _name, ref, port, queries = pair
    port_sc = dataclasses.replace(port.sc_index, data_norms=None)
    save_index(port_sc, port.cfg, str(tmp_path / "idx"))
    loaded, cfg = load_index(str(tmp_path / "idx"), device="cpu")
    ref_loaded, ref_cfg = j_load_index(str(tmp_path / "idx"))
    assert loaded.data_norms is None and ref_loaded.data_norms is None
    q = torch.from_numpy(queries)
    gi, gd, _ = taco.query_with_stats(loaded, q, cfg)
    wi, wd, _ = jtaco.query_with_stats(ref_loaded, jnp.asarray(queries), ref_cfg)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


# ---------------------------------------------------------------- rejects --
@pytest.fixture
def saved(pair, tmp_path):
    path = str(tmp_path / "idx")
    pair[2].save(path)
    return path


def _edit_manifest(path, edit):
    manifest_path = os.path.join(path, "step_0", "manifest.json")
    with open(manifest_path) as f:
        manifest = json.load(f)
    edit(manifest)
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)


def test_load_rejects_a_non_index_dir(tmp_path):
    with pytest.raises(FileNotFoundError, match="not a saved ANN index"):
        AnnIndex.load(str(tmp_path / "nope"), device="cpu")


def test_load_rejects_unknown_config_field(saved):
    _edit_manifest(saved, lambda m: m["extra"]["config"].update(warp_drive=True))
    with pytest.raises(ValueError, match="warp_drive"):
        AnnIndex.load(saved, device="cpu")


def test_load_rejects_a_newer_version(saved):
    _edit_manifest(saved, lambda m: m["extra"].update(version=2))
    with pytest.raises(ValueError, match="newer"):
        AnnIndex.load(saved, device="cpu")


def test_load_rejects_a_mutable_save(saved):
    _edit_manifest(saved, lambda m: m["extra"].update(format="taco-ann-mutable-index"))
    with pytest.raises(ValueError, match="MUTABLE index save"):
        AnnIndex.load(saved, device="cpu")


def test_load_rejects_a_foreign_dtype(saved):
    _edit_manifest(saved, lambda m: m["dtypes"].__setitem__(0, "bfloat16"))
    with pytest.raises(ValueError, match="dtype"):
        AnnIndex.load(saved, device="cpu")


def test_mirror_is_never_read(pair, saved):
    """Config and arrays commit in the manifest: a rewritten ann_index.json
    does not change what loads."""
    with open(os.path.join(saved, "ann_index.json"), "w") as f:
        f.write('{"format": "corrupted-mirror"}')
    loaded = AnnIndex.load(saved, device="cpu")
    assert loaded.cfg == pair[2].cfg
    pair[2].save(saved)  # a re-save replaces step_0 and leaves no aside copy
    assert sorted(os.listdir(saved)) == ["ann_index.json", "step_0"]


# --------------------------------------------------------------- searcher --
def test_bucket_ladder_matches_the_reference():
    from repro.batching import ANN_BATCH_BUCKETS as J_BUCKETS
    from repro.batching import bucket_size as j_bucket_size

    assert ANN_BATCH_BUCKETS == J_BUCKETS
    for n in (1, 3, 8, 200, 256, 257, 1000):
        assert bucket_size(n) == j_bucket_size(n, J_BUCKETS)
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(pad_rows(x, 5)[3:], np.repeat(x[-1:], 2, axis=0))
    with pytest.raises(ValueError):
        pad_rows(x, 2)


def test_searcher_owns_the_function_cache(pair):
    _name, _ref, port, queries = pair
    searcher = port.searcher("single")
    searcher.search(queries[:8])
    searcher.search(queries[4:12])  # same bucket -> cache hit
    assert sum(searcher.compile_counts.values()) == 1
    searcher.search(queries[:8], k=5)  # new k -> one more entry
    assert sum(searcher.compile_counts.values()) == 2
    small = port.searcher(max_cached_fns=1)
    small.search(queries[:8])
    small.search(queries[:8], k=5)  # evicts the first key
    small.search(queries[:8])
    assert list(small.compile_counts.values()) == [2, 1]
    assert searcher.dim == 24 and searcher.max_k == 2000
    data, ids = searcher.probe_corpus()
    assert data.shape == (2000, 24) and ids[-1] == 1999


def test_searcher_rejects_misplaced_arguments(pair):
    _name, _ref, port, _queries = pair
    with pytest.raises(ValueError):
        port.searcher("bogus")
    with pytest.raises(NotImplementedError, match="not ported"):
        port.searcher("sharded")
    with pytest.raises(ValueError, match="SCConfig"):
        SingleDeviceSearcher(port.sc_index).search(np.zeros((1, 24), np.float32))


def test_padding_does_not_change_real_rows(pair):
    """5 queries pad to the 8 bucket: each real row equals the same query
    run alone (bucket 1) and run through query_with_stats unpadded."""
    _name, _ref, shared, queries = pair
    port = AnnIndex(sc_index=shared.sc_index, cfg=shared.cfg)  # a fresh searcher cache
    for rerank in ("gather", "masked_full"):
        ids, dists, stats = port.search_with_stats(queries[:5], rerank=rerank)
        cfg = dataclasses.replace(port.cfg, rerank=rerank)
        wi, wd, ws = taco.query_with_stats(port.sc_index, torch.from_numpy(queries[:5]), cfg)
        np.testing.assert_array_equal(ids, wi.numpy())
        np.testing.assert_array_equal(dists.view(np.uint32), wd.numpy().view(np.uint32))
        np.testing.assert_array_equal(stats["candidate_count"], ws["candidate_count"].numpy())
        t_ids, t_dists, _ = port.search_with_stats(torch.from_numpy(queries[:5]), rerank=rerank)
        np.testing.assert_array_equal(t_ids, ids)  # a tensor is padded on its device
        np.testing.assert_array_equal(t_dists.view(np.uint32), dists.view(np.uint32))
        for i in range(5):
            one_ids, one_d, one_stats = port.search_with_stats(queries[i], rerank=rerank)
            np.testing.assert_array_equal(one_ids, ids[i])
            np.testing.assert_array_equal(one_d.view(np.uint32), dists[i].view(np.uint32))
            assert one_stats["candidate_count"] == stats["candidate_count"][i]
    assert {key[0] for key in port._default_searcher().compile_counts} == {1, 8}


def test_facade_returns_what_the_reference_returns(pair):
    _name, ref, port, queries = pair
    for q in (queries, queries[:5], queries[0], torch.from_numpy(queries)):
        gi, gd, gs = port.search_with_stats(q, k=7)
        wi, wd, ws = ref.search_with_stats(np.asarray(q), k=7)
        assert isinstance(gi, np.ndarray) and isinstance(gd, np.ndarray)
        assert gi.dtype == np.int32 and gd.dtype == np.float32
        assert gi.shape == np.shape(wi) and gd.shape == np.shape(wd)
        assert set(gs) == set(ws) == {"truncated", "candidate_count"}
        for key in gs:
            assert np.asarray(gs[key]).dtype == np.asarray(ws[key]).dtype, key
            assert np.shape(gs[key]) == np.shape(ws[key]), key
            np.testing.assert_array_equal(gs[key], np.asarray(ws[key]), err_msg=key)
        np.testing.assert_array_equal(gi, np.asarray(wi))
        np.testing.assert_array_equal(gd, np.asarray(wd))
    ids, dists = port.search(queries)
    np.testing.assert_array_equal(ids, np.asarray(ref.search(queries)[0]))

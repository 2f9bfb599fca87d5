"""The ANN dry run of the port (``repro_torch.launch.dryrun_ann``) beside the
reference's (``repro.launch.dryrun_ann``, run in a subprocess: it forces
512 host devices) at n = 10^6 on the 16x16 mesh.

Exact: ``build_cov``'s per-device flops (one x^T x a shard, 2 n_loc d^2),
its payload (the all-reduce of the sum and of the outer product) and its
argument bytes (one row block); ``build_lloyd``'s argument bytes (one row
block and the replicated centroids); the query's payload. Recorded beside
the reference, not equal by design: the query's and the Lloyd step's bytes
(the port's plain ops against XLA's fused ones; the port's Lloyd sums by
one-hot products on the card's path, so its flops are twice the
reference's). Every job of both pipelines has flops > 0 and bytes > 0.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun_ann

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = ("query", "build_cov", "build_lloyd")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{(package, rerank): artifact} at n = 10^6 on the 16x16 mesh."""
    tmp = tmp_path_factory.mktemp("dryrun_ann")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-m", "repro.launch.dryrun_ann", "--n", "1e6",
                           "--out", str(tmp / "ref")], env=env, capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = {("ref", "gather"): json.loads(
        (tmp / "ref" / "ann_taco__n999936__16_16.json").read_text())}
    for rerank in ("gather", "masked_full"):
        assert dryrun_ann.main(["--n", "1e6", "--rerank", rerank,
                                "--out", str(tmp / rerank)]) == 0
        tag = "ann_taco__n999936__16_16" + ("" if rerank == "gather" else "__masked_full")
        out["port", rerank] = json.loads((tmp / rerank / f"{tag}.json").read_text())
    return out


def test_build_statistics_equal_the_reference(artifacts):
    got, want = artifacts["port", "gather"], artifacts["ref", "gather"]
    for key in ("kind", "mesh", "n", "d", "n_devices", "rerank"):
        assert got[key] == want[key], key
    cov, ref_cov = got["build_cov"], want["build_cov"]
    assert cov["flops"] == ref_cov["flops"] == 2 * 3906 * 128**2
    assert cov["collective_total"] == ref_cov["collective_total"] == (128**2 + 128) * 4
    assert (cov["memory_analysis"]["argument_size_in_bytes"]
            == ref_cov["memory_analysis"]["argument_size_in_bytes"] == 3906 * 128 * 4)
    lloyd, ref_lloyd = got["build_lloyd"], want["build_lloyd"]
    assert (lloyd["memory_analysis"]["argument_size_in_bytes"]
            == ref_lloyd["memory_analysis"]["argument_size_in_bytes"])
    assert lloyd["collective_total"] == ref_lloyd["collective_total"] == (256 * 4 + 256) * 4
    assert got["query"]["collective_total"] == want["query"]["collective_total"]


@pytest.mark.parametrize("rerank", ["gather", "masked_full"])
def test_every_job_counts_work(artifacts, rerank):
    art = artifacts["port", rerank]
    assert art["rerank"] == rerank and art["n_devices"] == 256
    for job in JOBS:
        assert art[job]["flops"] > 0 and art[job]["bytes"] > 0, job
        assert art[job]["fits_one_card"], job
        assert art[job]["memory_analysis"]["argument_size_in_bytes"] > 0, job
    # the queries' top-k: S x (Q, k) (id, distance) pairs gathered
    assert art["query"]["collective_bytes"]["all-gather"] == 256 * 32 * 50 * 8

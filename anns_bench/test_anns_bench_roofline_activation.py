"""The sort activation kernel's roofline count (``roofline/activation.py``)
pinned against hand arithmetic at the three cells' shapes, and its share
(``layer_metrics/activation_roofline.py``) read from a trace that holds the
kernel, and from one that does not: a program whose activation is eager
torch reads nothing."""
from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from anns_bench import peaks, rooflines, spec, trace

ROOT = Path(__file__).resolve().parents[1]


def ctx(n_sub, s, clusters, d, batch, units=1):
    return SimpleNamespace(
        root=ROOT, taco={"n_subspaces": n_sub, "subspace_dim": s, "n_clusters": clusters},
        config={"dataset": {"n": 10 ** 6, "d": d}}, traffic={"batch": batch, "k": 10},
        window={"units": units}, checked={})


def work(c):
    return spec.load_module(ROOT / "anns_bench" / "roofline" / "activation.py").work(
        c, rooflines.shapes(c))


# (cell, its shapes, ops, bytes) a batch: N_s Q K cell sums; both halves'
# f32 distances 2 N_s Q sqrt_k 4, the sizes in 4 bytes (n = 10^6 > 65,535)
# N_s K 4, the two f32 outputs 2 N_s Q 4
CELLS = [
    ("sift1m-masked-q10k", (6, 8, 1024, 128, 10000), 6 * 10000 * 1024,
     15_360_000 + 24_576 + 480_000),
    ("gist1m-masked-q1k", (20, 48, 4096, 960, 1000), 20 * 1000 * 4096,
     10_240_000 + 327_680 + 160_000),
    ("sift1m-gather-q1k", (6, 8, 1024, 128, 1000), 6 * 1000 * 1024,
     1_536_000 + 24_576 + 48_000),
]


@pytest.mark.parametrize("cell,shape,ops,nbytes", CELLS, ids=[c[0] for c in CELLS])
def test_activation_count(cell, shape, ops, nbytes):
    w = work(ctx(*shape, units=3))
    assert w["ops"] == {"cuda_core_32bit": 3 * ops}
    assert w["bytes"] == 3 * nbytes
    # the bytes bound it: a few microseconds a batch
    assert peaks.bound_seconds(w) == pytest.approx(3 * nbytes / 3.35e12)


def test_activation_share_reads_the_kernel_and_nothing_without_it():
    c = ctx(*CELLS[0][1])
    window = ("bench.window", 0.0, 1000.0, "host")
    kernel = ("void (anonymous namespace)::sort_activation_kernel<32>(float const*, float "
              "const*, int const*, float, float*, float*, int, int)", 100.0, 500.0, "device")
    eager = ("void at::native::elementwise_kernel<128, 2>(int)", 100.0, 900.0, "device")
    c.profile = trace.summarize([window, kernel, eager])
    got = spec.reader(ROOT, "layer_metrics", "activation_roofline")(c)
    assert got == pytest.approx(100 * (CELLS[0][3] / 3.35e12) / 400e-6)
    c.profile = trace.summarize([window, eager])  # the eager activation: no kernel
    assert spec.reader(ROOT, "layer_metrics", "activation_roofline")(c) is None
    c.profile = None
    assert spec.reader(ROOT, "layer_metrics", "activation_roofline")(c) is None

"""The sort activation's kernel route (``ops.sort_activation``,
``activation_taus(impl=...)``, ``kernels.activation``) on the CPU: the route
on a CPU tensor is the plain version bit for bit, the kernel route refuses a
CPU tensor, the wrapper refuses mismatched shapes and dtypes, the launch
counts carry the kernel, and the query paths pass their ``impl``. A numpy
transcription of the kernel's arithmetic (``csrc/activation.cu``: integer
weights, the bisection that stops once lo == hi, the tie replay in flat index
order) is held to the plain version bit for bit, ties, signed zeros and edge
targets included; the card tests hold the kernel itself. The plain version is
the kernel layer's spec (``kernels.ref``), so ``kernels`` imports nothing of
``core``."""
import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import activation, distributed, taco
from repro_torch.core.activation import activation_taus, sort_activation
from repro_torch.core.config import taco_config
from repro_torch.kernels import cuda, ops, ref
from repro_torch.kernels.activation import check_inputs, sort_activation_cuda


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _case(seed, n_sub=3, q=5, sqrt_k=8, kind="float"):
    rng = np.random.default_rng(seed)
    shape = (n_sub, q, sqrt_k)
    if kind == "float":
        d1s, d2s = (rng.uniform(0, 5, shape).astype(np.float32) for _ in range(2))
    elif kind == "int":  # many equal cell sums
        d1s, d2s = (rng.integers(0, 4, shape).astype(np.float32) for _ in range(2))
    else:  # negative sums, -0.0 + -0.0 = -0.0 and x + -x = +0.0
        vals = np.array([-2.0, -1.0, -0.0, 0.0, 1.0, 2.0], np.float32)
        d1s, d2s = (rng.choice(vals, shape) for _ in range(2))
    sizes = rng.integers(0, 6, (n_sub, sqrt_k, sqrt_k)).astype(np.int32)
    return [torch.from_numpy(a) for a in (d1s, d2s, sizes)]


def _sort_key(x):
    b = x.view(np.uint32).astype(np.int64)
    return np.where(b >= 0x80000000, 0xFFFFFFFF - b, b | 0x80000000)


def _from_key(key: int) -> np.float32:
    b = key - 0x80000000 if key >= 0x80000000 else 0xFFFFFFFF - key
    return np.array([b & 0xFFFFFFFF], np.uint32).view(np.float32)[0]


def kernel_model(d1, d2, sizes, alpha_n):
    """One problem as ``csrc/activation.cu``'s on-chip route computes it:
    d1, d2 (sqrt_k,) float32, sizes (sqrt_k, sqrt_k) integers. Returns
    (tau, retrieved)."""
    sums = (d1[:, None] + d2[None, :]).astype(np.float32).ravel()
    keys = _sort_key(sums)
    sz = sizes.ravel().astype(np.int64)
    alpha = np.float32(alpha_n)
    total = np.float32(int(sz.sum()))
    target = alpha if np.isnan(alpha) else min(alpha, total)
    lo, hi = int(keys.min()), int(keys.max())
    for _ in range(32):
        if lo == hi and not np.isnan(target):
            break
        mid = lo + ((hi - lo) >> 1)
        if np.float32(int(sz[keys <= mid].sum())) >= target:
            hi = mid
        else:
            lo = mid + 1
    tau = _from_key(lo)
    below = int(sz[sums < tau].sum())
    tie = sums == tau
    ret = below + (int(sz[0]) if tie[0] else 0)
    run = below
    for c in np.flatnonzero(tie):
        run += int(sz[c])
        if np.float32(run) >= target:
            ret = run
            break
    return tau, np.float32(ret)


def _targets(sizes_s):
    """alpha_n values for one subspace: 0, one cell's weight, a cumulative
    weight in flat order, the total, past the total, and fractions."""
    flat = sizes_s.flatten().to(torch.int64)
    total = int(flat.sum())
    return [0.0, float(flat.max()), float(flat[: flat.numel() // 3].sum()), float(total),
            total + 7.5, 0.3 * total, 2.5]


@pytest.mark.parametrize("kind", ["float", "int", "signed_zero"])
@pytest.mark.parametrize("sqrt_k", [1, 4, 5, 12, 32])
def test_kernel_model_matches_the_plain_version(sqrt_k, kind):
    d1s, d2s, sizes = _case(sqrt_k * 7 + len(kind), n_sub=2, q=6, sqrt_k=sqrt_k, kind=kind)
    for s in range(2):
        for alpha_n in _targets(sizes[s]) + [float("nan"), -3.0]:
            tau, ret = sort_activation(d1s[s], d2s[s], sizes[s], alpha_n)
            for qi in range(d1s.shape[1]):
                mt, mr = kernel_model(d1s[s, qi].numpy(), d2s[s, qi].numpy(),
                                      sizes[s].numpy(), alpha_n)
                assert _bits(mt) == _bits(tau[qi].numpy()), (s, qi, alpha_n)
                assert _bits(mr) == _bits(ret[qi].numpy()), (s, qi, alpha_n)


@pytest.mark.parametrize("impl", ["auto", "torch"])
@pytest.mark.parametrize("kind", ["float", "int", "signed_zero"])
def test_cpu_routes_are_the_plain_version(kind, impl):
    """On a CPU tensor "auto" and "torch" both run the plain version:
    activation_taus and ops.sort_activation equal sort_activation with the
    sizes broadcast over the queries, bit for bit."""
    d1s, d2s, sizes = _case(11 + len(kind), n_sub=3, q=9, sqrt_k=12, kind=kind)
    for alpha_n in (0.0, 40.0, 1e9):
        want_t, want_r = sort_activation(d1s, d2s, sizes[:, None], alpha_n)
        for got_t, got_r in (activation_taus(d1s, d2s, sizes, alpha_n, impl=impl),
                             ops.sort_activation(d1s, d2s, sizes, alpha_n, impl=impl)):
            assert got_t.shape == (3, 9) and got_r.shape == (3, 9)
            np.testing.assert_array_equal(_bits(got_t.numpy()), _bits(want_t.numpy()))
            np.testing.assert_array_equal(_bits(got_r.numpy()), _bits(want_r.numpy()))


@pytest.mark.parametrize("call", ["activation_taus", "ops", "wrapper"])
def test_kernel_route_refuses_a_cpu_tensor(call):
    d1s, d2s, sizes = _case(0)
    with pytest.raises(ValueError, match="CUDA"):
        if call == "activation_taus":
            activation_taus(d1s, d2s, sizes, 10.0, impl="kernel")
        elif call == "ops":
            ops.sort_activation(d1s, d2s, sizes, 10.0, impl="kernel")
        else:
            sort_activation_cuda(d1s, d2s, sizes, 10.0)


def test_an_unknown_impl_is_refused():
    d1s, d2s, sizes = _case(0)
    with pytest.raises(ValueError, match="impl"):
        activation_taus(d1s, d2s, sizes, 10.0, impl="bogus")


@pytest.mark.parametrize("bad", [
    "d2s_shape", "d1s_rank", "sizes_shape", "sizes_subspaces", "d1s_dtype", "d2s_dtype",
    "sizes_dtype", "sizes_float", "empty_sqrt_k",
])
def test_wrapper_refuses_mismatched_shapes_and_dtypes(bad):
    d1s, d2s, sizes = _case(1, n_sub=2, q=3, sqrt_k=4)
    if bad == "d2s_shape":
        d2s = d2s[:, :2]
    elif bad == "d1s_rank":
        d1s, d2s = d1s[0], d2s[0]
    elif bad == "sizes_shape":
        sizes = sizes[:, :3]
    elif bad == "sizes_subspaces":
        sizes = sizes[:1]
    elif bad == "d1s_dtype":
        d1s = d1s.double()
    elif bad == "d2s_dtype":
        d2s = d2s.half()
    elif bad == "sizes_dtype":
        sizes = sizes.long()
    elif bad == "sizes_float":
        sizes = sizes.float()
    else:
        d1s, d2s, sizes = d1s[..., :0], d2s[..., :0], sizes[:, :0, :0]
    with pytest.raises(ValueError, match="activation"):
        check_inputs(d1s, d2s, sizes)
    with pytest.raises(ValueError, match="activation"):
        sort_activation_cuda(d1s, d2s, sizes, 5.0)
    check_inputs(*_case(1, n_sub=2, q=3, sqrt_k=4))  # the well-formed case passes


def test_launch_counts_carry_the_kernel():
    assert "activation" in cuda.KERNELS
    assert (cuda.CSRC / "activation.cu").exists()
    cuda.reset_launch_counts()
    assert cuda.launch_counts["activation"] == 0
    assert cuda.launch_layouts["activation"] == {} and cuda.launch_blocks["activation"] is None
    assert cuda.library_path("activation").name.startswith("activation-")


@pytest.mark.parametrize("method", ["heap", "linear", "sort_lax"])
def test_ablations_stay_on_torch_whatever_impl(method, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the ablations do not take the kernel route")

    monkeypatch.setattr(ops, "sort_activation", refuse)
    d1s, d2s, sizes = _case(3, sqrt_k=4)
    want = activation_taus(d1s, d2s, sizes, 9.0, method=method, impl="torch")
    got = activation_taus(d1s, d2s, sizes, 9.0, method=method, impl="kernel")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _spy(monkeypatch, module):
    seen = []
    real = module.activation_taus

    def spy(*args, impl="auto", **kwargs):
        seen.append(impl)
        return real(*args, impl=impl, **kwargs)

    monkeypatch.setattr(module, "activation_taus", spy)
    return seen


@pytest.mark.parametrize("rerank", ["gather", "masked_full"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_query_paths_pass_their_impl(rerank, use_kernels, monkeypatch):
    """``_collision_inputs`` (both pipelines) and the sharded searcher route
    the activation as every other kernel: "auto" with ``use_kernels``, else
    "torch"; on the CPU both give the same answers."""
    rng = np.random.default_rng(2)
    data = rng.integers(-10, 11, (600, 12)).astype(np.float32)
    queries = torch.as_tensor(rng.integers(-10, 11, (9, 12)).astype(np.float32))
    cfg = taco_config(n_subspaces=2, subspace_dim=6, n_clusters=16, alpha=0.1, beta=0.05,
                      transform="none", rerank=rerank, k=5)
    index = taco.build(data, cfg, device="cpu")
    seen = _spy(monkeypatch, taco)
    run = dataclasses.replace(cfg, use_kernels=use_kernels)
    ids, dists, stats = taco.query_with_stats(index, queries, run)
    want = "auto" if use_kernels else "torch"
    assert seen == [want]
    base_ids, base_dists, base_stats = taco.query_with_stats(
        index, queries, dataclasses.replace(cfg, use_kernels=not use_kernels))
    assert torch.equal(ids, base_ids) and torch.equal(dists, base_dists)
    for key in ("taus", "retrieved"):
        assert torch.equal(stats[key], base_stats[key]), key
    seen_sharded = _spy(monkeypatch, distributed)
    views, n = distributed.shard_views(index, 2)
    distributed.make_distributed_query_with_stats(views, run, index, n)(queries)
    assert seen_sharded == [want]


def test_activation_module_routes_sort_through_ops():
    assert activation.ops is ops


def test_the_plain_version_is_the_kernel_layers_spec():
    """``core.activation.sort_activation`` is ``kernels.ref``'s spec, and
    importing the kernel layer's ``ops`` loads nothing of ``core``."""
    import subprocess
    import sys

    assert activation.sort_activation is ref.sort_activation_ref
    assert activation._ACT["sort"] is ref.sort_activation_ref
    code = ("import sys, repro_torch.kernels.ops; "
            "print(sorted(m for m in sys.modules if m.startswith('repro_torch.core')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_chip_smoke_counts_and_requires_the_kernel():
    """``chip_smoke.py`` sums every kernel's launches under ``SOURCES`` (a
    kernel missing there fails its summary) and requires the activation
    launch on every TaCo query path, the ones that launch ``l2dist``; SuCo's
    linear activation stays on torch under a path of its own."""
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert set(chip_smoke.SOURCES) == set(cuda.KERNELS)
    for source, _replaces in chip_smoke.SOURCES.values():
        assert (root / source).exists(), source
    for name, kernels in chip_smoke.PATHS.items():
        wants = "l2dist" in kernels and name != "suco_gather"
        assert ("activation" in kernels) == wants, name

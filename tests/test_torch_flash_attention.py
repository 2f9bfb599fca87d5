"""The port's flash attention (``repro_torch.kernels.ops.flash_attention``)
against ``repro``'s: the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it, and ``ref.flash_attention_ref``, on the
reference tests' shapes and at their tolerances (2e-5 for float32, 5e-2
for bfloat16). On the CPU the op takes the plain version; the CUDA kernel
is held to it in ``tests/test_torch_cuda_kernels.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import cuda, ops
from repro_torch.kernels.flash_attention import flash_attention_cuda

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _inputs(seed, bh, s, t, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, n, hd)).astype(np.float32) for n in (s, t, t)]


def _check(arrays, causal, dtype=np.float32):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    tol = BF16 if dtype == "bf16" else F32
    jargs = [jnp.asarray(a, jdt) for a in arrays]
    targs = [torch.from_numpy(a).to(tdt) for a in arrays]
    got = ops.flash_attention(*targs, causal=causal, impl="torch")
    assert got.dtype == tdt and tuple(got.shape) == arrays[0].shape
    got = got.float().numpy()
    pallas = np.asarray(jops.flash_attention(*jargs, causal=causal, impl="pallas"), np.float32)
    oracle = np.asarray(jref.flash_attention_ref(*jargs, causal), np.float32)
    np.testing.assert_allclose(got, pallas, **tol)
    np.testing.assert_allclose(got, oracle, **tol)


@pytest.mark.parametrize("bh,s,hd,causal", [
    (2, 16, 8, True), (3, 32, 16, False), (1, 128, 32, True), (2, 256, 64, True),
])
def test_matches_reference(bh, s, hd, causal):
    _check(_inputs(s, bh, s, s, hd), causal)


def test_bf16():
    _check(_inputs(7, 2, 32, 32, 16), True, "bf16")


def test_padded_causal_tail():
    _check(_inputs(9, 1, 150, 150, 16), True)


@pytest.mark.parametrize("s,t", [(130, 130), (64, 130), (100, 257)])
def test_ragged_noncausal_keys(s, t):
    _check(_inputs(s + t, 2, s, t, 16), False)


def test_causal_with_more_queries_than_keys():
    """Top-left aligned causal mask with S > T: rows past T see every key."""
    _check(_inputs(3, 2, 40, 24, 8), True)


def test_cpu_tensor_takes_the_plain_version_and_the_kernel_never_falls_back():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 8, 8, 8))
    before = dict(cuda.launch_counts)
    torch.testing.assert_close(ops.flash_attention(q, k, v), ops.flash_attention(q, k, v,
                                                                                  impl="torch"))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    assert dict(cuda.launch_counts) == before


def _emulate_bf16_kernel(q, k, v, causal, split_p):
    """The bf16 kernel's arithmetic in plain torch, without its tiling: f32
    scores of bf16 inputs, exp against the row max, P.V with P as one bf16
    rounding (``split_p=False``) or as bf16 hi + lo (``split_p=True``), f32
    sums, the output rounded once to bf16."""
    s = torch.einsum("bsd,btd->bst", q.float(), k.float()) * q.shape[-1] ** -0.5
    if causal:
        keep = torch.arange(k.shape[1])[None, :] <= torch.arange(q.shape[1])[:, None]
        s = torch.where(keep, s, -torch.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.to(torch.bfloat16).float()
    out = torch.einsum("bst,btd->bsd", hi, v.float())
    if split_p:
        out = out + torch.einsum("bst,btd->bsd", (p - hi).to(torch.bfloat16).float(), v.float())
    return (out / p.sum(-1, keepdim=True)).to(torch.bfloat16)


def test_bf16_p_needs_the_hi_lo_split():
    """Why the kernel's P.V takes P as hi + lo: against the f32 oracle at
    the card check's 2^-7 |x| + 4e-5 per element, one bf16 rounding of P
    uses many times the allowance (a row's output sums hundreds of rounded
    weights, and outputs near 0 meet only the 4e-5 floor), the split well
    under it."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(14, 2, 512, 512, 64))
    want = ops.flash_attention(q.float(), k.float(), v.float(), impl="torch")
    allowed = 4e-5 + 2.0 ** -7 * want.abs()

    def share(split_p):
        got = _emulate_bf16_kernel(q, k, v, True, split_p).float()
        return float(((got - want).abs() / allowed).max())

    assert share(True) <= 0.6
    assert share(False) > 1.0

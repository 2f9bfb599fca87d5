"""The tiled kmeans_assign's TF32 screen and its window rule, emulated on
the CPU (the kernel itself runs only on the card).

The emulation follows ``csrc/kmeans_assign.cu``'s tiled path: both sides
centred on the centroid mean, both operands truncated to TF32 (the low 13
mantissa bits cleared, as the tensor core reads an f32), the product in f32,
the per-(row, tile) bound E with the module's window at the row width
(``screen_window(w)``: G, EPS, KAPPA), the running upper bound U over tiles of TILE_CENTROIDS in
index order (the kernel's blocks start at different tiles; the answer does
not depend on the order), a queue of every column with screened <= U + E,
and at the end a recheck of the queued columns whose lower bound
screened - E still reaches U. The recheck is the plain
arithmetic (``kernels/ref.py``'s ``l2dist_ref``), so the emulated answer
must equal ``kmeans_assign_plain`` bit for bit: a miss of any minimiser
would show. Each case also holds the screened distance to the exact one
within the derived per-pair bound, and counts the rechecks a point."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.kmeans_assign import (
    TILE_CENTROIDS,
    kmeans_assign_plain,
    screen_window,
)
from repro_torch.kernels.ref import l2dist_ref

N_POINTS, N_CENTROIDS = 2000, 200  # 4 tiles of 64, the last ragged


def tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 truncated to TF32: the low 13 of the 23 mantissa bits cleared."""
    return (t.contiguous().view(torch.int32) & -8192).view(torch.float32)


def screened_assign(x: torch.Tensor, c: torch.Tensor, centre: bool = True):
    """(assignments, min dists, rechecks a point, largest |screened - exact|
    / per-pair bound) by the kernel's screen and window rule."""
    gamma, eps, kappa = screen_window(x.shape[1])
    mu = c.mean(0) if centre else torch.zeros(c.shape[1])
    xb, cb = x - mu, c - mu
    xb2, cb2 = (xb * xb).sum(1), (cb * cb).sum(1)
    screened = torch.clamp_min((xb2[:, None] + cb2[None, :]) - 2.0 * (tf32(xb) @ tf32(cb).T), 0.0)
    a, b = xb2.sqrt() * kappa, cb2.sqrt() * kappa
    p, q = (x * x).sum(1).sqrt() * kappa, (c * c).sum(1).sqrt() * kappa
    exact = l2dist_ref(x, c)  # what kmeans_assign_plain takes its argmin of
    pair_bound = 2 * gamma * a[:, None] * b[None, :] + eps * (
        (a[:, None] + b[None, :]) ** 2 + (p[:, None] + q[None, :]) ** 2)
    n, k = exact.shape
    upper = torch.full((n,), torch.inf)
    queued = torch.zeros((n, k), dtype=torch.bool)
    lower = torch.full((n, k), torch.inf)
    for j0 in range(0, k, TILE_CENTROIDS):
        cols = slice(j0, j0 + TILE_CENTROIDS)
        bt, qt = b[cols].max(), q[cols].max()
        e = 2 * gamma * a * bt + eps * ((a + bt) ** 2 + (p + qt) ** 2)
        d = screened[:, cols]
        upper = torch.minimum(upper, d.min(1).values + e)
        queued[:, cols] = d <= (upper + e)[:, None]
        lower[:, cols] = d - e[:, None]
    # the queue at the end: recheck what still reaches the row's bound
    cand = queued & (lower <= upper[:, None])
    rechecks = int(cand.sum()) / n
    dd = torch.where(cand, exact, torch.inf)
    best_j = dd.argmin(1)  # the first index on ties, as the kernel's key
    best_d = dd.gather(1, best_j[:, None])[:, 0]
    worst = float(((screened - exact).abs() / pair_bound).max())
    return best_j.to(torch.int32), best_d, rechecks, worst


def _case(name: str, w: int):
    rng = np.random.default_rng(w * 10 + len(name))
    n, k = N_POINTS, N_CENTROIDS
    if name == "gaussian":
        x, c = rng.standard_normal((n, w)), rng.standard_normal((k, w))
    elif name == "integer":  # many exact ties
        x, c = rng.integers(-3, 4, (n, w)), rng.integers(-3, 4, (k, w))
    elif name == "offset":  # 10^3 per coordinate, spread 10^2
        x = 1e3 + 100 * rng.standard_normal((n, w))
        c = 1e3 + 100 * rng.standard_normal((k, w))
    elif name == "offset_narrow":  # 10^3 per coordinate, unit spread
        x, c = 1e3 + rng.standard_normal((n, w)), 1e3 + rng.standard_normal((k, w))
    else:  # midway: each point halfway between two centroids
        c = rng.standard_normal((k, w))
        x = (c[rng.integers(0, k, n)] + c[rng.integers(0, k, n)]) / 2
    return (torch.as_tensor(np.asarray(x, np.float32)),
            torch.as_tensor(np.asarray(c, np.float32)))


@pytest.mark.parametrize("w", [4, 13, 64, 128, 129, 960])
@pytest.mark.parametrize("name", ["gaussian", "integer", "offset", "offset_narrow", "midway"])
def test_screen_window_keeps_the_exact_answer(name, w):
    """The screened answer equals the plain version bit for bit, and every
    screened distance lies within the derived bound of the exact one, at
    the widths of the one-tile-sized tiled path (up to 128) and of the wide
    path (129, and GIST's 960, with the window re-derived for the width).
    The window stays small (at most three rechecks a point) except where
    the exact chain's own rounding, EPS (p + q)^2, is of the order of the
    distance gaps: on the narrow offset corpus (~10^3 at |x| ~ 10^3
    sqrt(w), against gaps of ~1) every centroid is rechecked, and on the
    offset corpus at 960 dims (~2e5 at |x| ~ 3e4, a quarter of the
    distances' spread) up to eight a point; the answer is still exact."""
    x, c = _case(name, w)
    got_j, got_d, per_point, worst = screened_assign(x, c)
    want_j, want_d = kmeans_assign_plain(x, c)
    assert torch.equal(got_j, want_j)
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))
    assert worst <= 1.0, worst
    assert per_point >= 1.0  # every point rechecks at least its screened best
    if name != "offset_narrow":
        assert per_point <= (8.0 if (name, w) == ("offset", 960) else 3.0), per_point


@pytest.mark.parametrize("w", [4, 128])
def test_centring_narrows_the_window_on_offset_data(w):
    """On the offset corpus, screening the raw rows (no centring) widens the
    window more than tenfold; the answer stays exact either way."""
    x, c = _case("offset", w)
    centred = screened_assign(x, c)
    raw = screened_assign(x, c, centre=False)
    want_j, _ = kmeans_assign_plain(x, c)
    assert torch.equal(centred[0], want_j) and torch.equal(raw[0], want_j)
    assert raw[2] > 10 * centred[2], (raw[2], centred[2])

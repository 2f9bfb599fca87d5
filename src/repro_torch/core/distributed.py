"""Corpus-sharded TaCo: the sharded query and the build statistics
(mirrors ``repro.core.distributed``).

The reference shards the corpus over a JAX mesh and runs ``shard_map``. The
port keeps its arithmetic in one process over a list of devices, one per
data shard (the counterpart of a 1-D data mesh):

  placement  :func:`shard_views` cuts the index into S row blocks. On the
             index's device a shard's ``data`` and ``data_norms`` are row
             slices (views) of the index's tensors, not copies; its IMI
             cell ids, the column block of the stacked ``cells`` (the
             combined assignments), are made contiguous once, here, since
             the kernels read them contiguous. Centroids, the transform
             and the GLOBAL cell sizes stay the index's, shared by every
             shard.
  query      the centroid distances, the activation thresholds tau (with a
             GLOBAL alpha*n) and the packed collision table are computed
             once a batch, on the index's device, and the table is moved to
             each shard's device. Each shard counts its own points. The
             reference's psum of the per-shard SC histograms becomes their
             sum in shard order, so every shard cuts at the SAME threshold,
             read off the summed histogram against the GLOBAL beta*n
             budget; its all-gather of the per-shard top-k becomes a
             shard-major concatenation of the S (Q, k) (id, dist) pairs on
             the first shard's device, followed by one stable top-k (ties
             to the lowest position, so to the lowest global id). Nothing
             else crosses between shards. Where no shard truncates the
             sharded result is the single-device one: bit for bit on the
             gather pipeline (each candidate's distance is the same either
             way), and on masked-full wherever the kernel's norm-form
             distance and the exact one order the points alike (always on
             an integer-valued index; each shard keeps its top-k by the
             former, the combine orders by the latter, as in the
             reference, so a near-tie on a float corpus may differ).
  build      the covariance, one Lloyd step and the IMI cell sizes from
             row shards: per-shard sums added in shard order.

No ``torch.distributed`` process group is used. Shards on several cards
take the same path (a list of distinct devices); that placement is
unverified: the port has been run on one H100 only.

Each shard's work runs at its position (:func:`repro_torch.mesh.walk`:
shard s at ``{axis: s}``, the axis of a 1-D mesh or ``"shard"``), and each
cross-shard sum and the combine's gather report their payloads
(:func:`repro_torch.mesh.tally`), so that
:class:`repro_torch.launch.op_analysis.OpCounter` counts per shard; neither
changes a result.

The sharded query computes the reference's sharded function, which is
float32 whatever ``cfg.precision`` says (the reference never reads it
there). ``cfg.use_kernels`` routes each shard's work through the CUDA
kernels when the shard is on the card, as on the single-device path: a
masked-full batch launches ``l2dist`` once and ``schist`` and
``masked_rerank`` once a shard; a gather batch ``l2dist`` once and
``scscore`` once a shard.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.clustering.kmeans import cluster_sums, new_means
from repro_torch.core.activation import activation_taus
from repro_torch.core.config import SCConfig, resolve_rerank
from repro_torch.core.selection import (
    compact_above_threshold,
    fixed_threshold_from_hist,
    query_aware_threshold,
    sc_histogram,
    select_candidates,
)
from repro_torch.core.taco import SCIndex, _centroid_distances, data_norms_of, rerank
from repro_torch.kernels import ops
from repro_torch.kernels.schist import collision_bits, collision_table
from repro_torch.mesh import one_pass, tally, tensor_bytes, walk
from repro_torch.utils import topk_smallest


@dataclasses.dataclass(frozen=True, eq=False)
class ShardView:
    """One data shard of an :class:`SCIndex`: the rows ``[offset, offset +
    n)`` of the corpus on one device. Not an index: it holds no centroids
    and no cell sizes, so it cannot be passed to the single-device helpers,
    which would read its local ``n`` as the corpus size."""

    data: torch.Tensor  # (n_local, d) float32
    data_norms: torch.Tensor  # (n_local,) float32
    cells: torch.Tensor  # (N_s, n_local) int32 combined IMI cell ids, contiguous
    offset: int  # global id of the shard's first row

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device


def per_shard_cap(cfg: SCConfig, n_local: int, k: int) -> int:
    """Static per-shard candidate cap for the gather re-rank: the shard's
    share of the global budget (4*beta*n_local, the same 4x headroom as
    ``cfg.cap_for``) floored at the runtime k each shard needs to emit its
    local top-k; an explicit ``candidate_cap`` is a per-shard cap (as in
    the billion-scale dry-run config). One definition shared by the sharded
    query below and host-side stats consumers
    (:class:`repro_torch.ann.searcher.ShardedSearcher`)."""
    base = (
        cfg.candidate_cap
        if cfg.candidate_cap is not None
        else math.ceil(4 * cfg.beta * n_local)
    )
    return min(n_local, max(base, k))


def shard_rows(x: torch.Tensor, mesh) -> tuple[torch.Tensor, ...]:
    """The S = ``len(mesh)`` equal row blocks of ``x``, block s on device
    ``mesh[s]`` (the counterpart of placing an array with a data-sharded
    ``PartitionSpec``): a view where the block is already there, a copy
    where it is not."""
    devices = [torch.device(d) for d in mesh]
    if not devices or x.shape[0] % len(devices):
        raise ValueError(f"{x.shape[0]} rows do not split evenly over {len(devices)} shards")
    n_local = x.shape[0] // len(devices)
    return tuple(x[s * n_local:(s + 1) * n_local].to(dev) for s, dev in enumerate(devices))


def shard_views(index: SCIndex, shards: int, devices=None) -> tuple[tuple[ShardView, ...], int]:
    """(S shard views, global n): the index cut into ``shards`` row blocks,
    block s on ``devices[s]`` (default: every block on the index's device).
    The port's counterpart of ``repro.core.distributed.index_pspecs``."""
    shards = int(shards)
    devices = [index.device] * shards if devices is None else list(devices)
    if shards < 1 or len(devices) != shards:
        raise ValueError(f"{shards} shards need as many devices, got {len(devices)}")
    n = index.n
    if n % shards:
        raise ValueError(f"corpus size {n} not divisible by {shards} shards")
    norms = data_norms_of(index)
    cells = index.cells
    n_local = n // shards
    views = []
    for s, (data, dn) in enumerate(zip(shard_rows(index.data, devices),
                                       shard_rows(norms, devices))):
        lo = s * n_local
        views.append(ShardView(
            data=data, data_norms=dn,
            cells=cells[:, lo:lo + n_local].to(devices[s]).contiguous(), offset=lo))
    return tuple(views), n


def _summed(parts, home):
    """The reference's psum over the data axes: the parts added in shard
    order on ``home`` (the first shard's device). Counted as the collective
    it stands for: an all-reduce of one part's bytes, each position reading
    its part and writing the sum once."""
    tally("all-reduce", tensor_bytes(parts[0]))
    with one_pass() as moves:
        total = parts[0].to(home)
        for p in parts[1:]:
            total = total + p.to(home)
        moves(parts[0], total)
    return total


def shard_coords(shards):
    """Shard s's coordinates for :func:`repro_torch.mesh.walk`, as a
    function of s: ``{axis: s}`` over the axis of a 1-D
    :class:`~repro_torch.mesh.DeviceMesh`, ``{"shard": s}`` over a plain
    list or tuple."""
    names = getattr(shards, "axis_names", ("shard",))
    if len(names) != 1:
        raise ValueError(f"shards over a {len(names)}-axis mesh; pass a 1-D mesh or a list")
    return lambda s: {names[0]: s}


def make_distributed_query_with_stats(views, cfg: SCConfig, index: SCIndex, n_global: int,
                                      k: int | None = None):
    """``fn(queries) -> (ids (Q, k), sq_dists (Q, k), stats)`` over the
    shard ``views`` of ``index`` (:func:`shard_views`); ``k`` overrides
    ``cfg.k`` per closure, as the reference's does.

    ``stats`` (each (Q, S), shard-major, on the first shard's device):

      * ``shard_candidates``: each shard's pre-clamp candidate demand. For
        query-aware selection it sums over the shards to the single-device
        demand (every shard cuts at the threshold read off the summed
        histogram). Masked-full counts the shard's points at or above the
        global threshold.
      * ``shard_truncated``: the shard's demand exceeded its static gather
        cap (:func:`per_shard_cap`); any truncation voids the sharded ==
        single-device guarantee. Masked-full re-ranks every point at or
        above the threshold, so it is always False there.

    Fixed selection on the gather pipeline ranks by LOCAL score order with
    an even split of the budget (beta*n / S a shard), as the reference
    does: its result is the reference's sharded one, not the single-device
    one. ``resolve_rerank`` keeps ``"auto"`` on the gather pipeline."""
    views = tuple(views)
    k = cfg.k if k is None else int(k)
    n_shards = len(views)
    if k > n_global // n_shards:
        raise ValueError(
            f"k={k} exceeds the {n_global // n_shards}-point shard: every "
            f"shard must hold at least k points to emit its local top-k")
    if cfg.selection not in ("query_aware", "fixed"):
        raise ValueError(f"unknown selection mode {cfg.selection!r}")
    rerank_mode = resolve_rerank(cfg, distributed=True)
    impl = "auto" if cfg.use_kernels else "torch"
    alpha_n = cfg.alpha * n_global
    beta_n = float(cfg.beta * n_global)
    n_levels = cfg.n_subspaces + 1
    cap = per_shard_cap(cfg, views[0].n, k)
    home = views[0].device
    coords = shard_coords(views)

    def shard_inputs(bits):
        return lambda s: (bits[s], views[s].cells, views[s].data, views[s].data_norms)

    def threshold(hist):
        if cfg.selection == "query_aware":
            return query_aware_threshold(hist, beta_n, cfg.n_subspaces)[0]
        return fixed_threshold_from_hist(hist, beta_n, n_global)[0]

    def masked_full(bits, queries):
        q = queries[0].shape[0]
        hists = walk(n_shards, coords,
                     lambda s: ops.schist(bits[s], views[s].cells, n_levels, q=q, impl=impl),
                     shard_inputs(bits))
        thresh = threshold(_summed(hists, home))
        levels = torch.arange(n_levels, device=home)[None, :]

        def shard(s):
            v = views[s]
            t = thresh.to(v.device)
            ids, dists = ops.masked_rerank(bits[s], v.cells, t, v.data, v.data_norms,
                                           queries[s], k, impl=impl)
            count = torch.sum(torch.where(levels >= thresh[:, None], hists[s].to(home), 0),
                              dim=1).to(torch.int32)
            return ids, dists, count, torch.zeros_like(count, dtype=torch.bool)

        return walk(n_shards, coords, shard, shard_inputs(bits))

    def gather(bits, queries):
        q = queries[0].shape[0]
        if cfg.selection == "fixed":
            # each shard alone, so one (Q, n_local) SC matrix lives at a time
            def fixed_shard(s):
                v = views[s]
                sc = ops.scscore(bits[s], v.cells, q=q, impl=impl)
                cand, valid, _t, count = select_candidates(
                    sc, beta_n / n_shards, cfg.n_subspaces, cap, mode="fixed")
                del sc
                ids, dists = rerank(v.data, queries[s], cand, valid, k, v.data_norms)
                return ids, dists, count, count > cap

            return walk(n_shards, coords, fixed_shard, shard_inputs(bits))
        # query-aware: the summed histogram first, then each shard compacts
        # at the common threshold and re-ranks; each SC matrix is freed
        # after its shard's compaction
        scs = walk(n_shards, coords,
                   lambda s: ops.scscore(bits[s], views[s].cells, q=q, impl=impl),
                   shard_inputs(bits))
        hists = walk(n_shards, coords, lambda s: sc_histogram(scs[s], cfg.n_subspaces),
                     shard_inputs(bits))
        thresh = threshold(_summed(hists, home))

        def compact_shard(s):
            v = views[s]
            cand, valid, count = compact_above_threshold(scs[s], thresh.to(v.device), cap)
            scs[s] = None
            ids, dists = rerank(v.data, queries[s], cand, valid, k, v.data_norms)
            return ids, dists, count, count > cap

        return walk(n_shards, coords, compact_shard, shard_inputs(bits))

    def fn(queries):
        queries = torch.as_tensor(queries, dtype=torch.float32).to(index.device)
        d1s, d2s = _centroid_distances(index, queries, cfg.use_kernels)
        taus, _retrieved = activation_taus(d1s, d2s, index.cell_sizes, alpha_n,
                                           method=cfg.activation, impl=impl)
        table_bits = collision_bits(collision_table(d1s, d2s, taus))
        bits = [table_bits.to(v.device) for v in views]
        qs = [queries.to(v.device) for v in views]
        run = masked_full if rerank_mode == "masked_full" else gather
        per_shard = run(bits, qs)
        # globalize the ids and combine: shard-major (the reference's
        # all-gather of the (Q, k) pairs), then one stable top-k
        glob = walk(n_shards, coords,
                    lambda s: torch.where(per_shard[s][0] >= 0,
                                          per_shard[s][0] + views[s].offset, -1),
                    lambda s: per_shard[s][:2])
        all_ids = torch.cat([ids.to(home) for ids in glob], dim=1)
        all_d = torch.cat([d.to(home) for _i, d, _c, _t in per_shard], dim=1)
        tally("all-gather", tensor_bytes(all_ids, all_d))
        top_d, pos = topk_smallest(all_d, k)
        stats = {
            "shard_candidates": torch.stack([c.to(home) for _i, _d, c, _t in per_shard], 1),
            "shard_truncated": torch.stack([t.to(home) for _i, _d, _c, t in per_shard], 1),
        }
        return torch.gather(all_ids, 1, pos), top_d, stats

    return fn


def make_distributed_query(views, cfg: SCConfig, index: SCIndex, n_global: int):
    """Stats-free ``fn(queries) -> (ids, sq_dists)``; see
    :func:`make_distributed_query_with_stats`."""
    stats_fn = make_distributed_query_with_stats(views, cfg, index, n_global)

    def fn(queries):
        ids, dists, _stats = stats_fn(queries)
        return ids, dists

    return fn


# ---------------------------------------------------------------------------
# The build statistics from row shards (:func:`shard_rows`)
# ---------------------------------------------------------------------------


def _home(mesh, parts) -> torch.device:
    devices = [torch.device(d) for d in mesh]
    got = [p.device for p in parts]
    if len(got) != len(devices) or any(
            g.type != d.type or (d.index is not None and g.index != d.index)
            for g, d in zip(got, devices)):
        raise ValueError(f"shards on {got} do not match the mesh {devices}")
    return got[0]


def make_distributed_cov(mesh, n_global: int):
    """``fn(xs) -> (mean (d,), cov (d, d))``: the global mean and covariance
    of the row shards ``xs`` from the sum of their local moments."""

    def fn(xs):
        home = _home(mesh, xs)
        moments = walk(len(xs), shard_coords(mesh),
                       lambda i: (torch.sum(xs[i], dim=0), xs[i].T @ xs[i]),
                       lambda i: (xs[i],))
        s = _summed([m[0] for m in moments], home)
        outer = _summed([m[1] for m in moments], home)
        # multiplications by the reciprocals: XLA folds the reference's
        # divisions by these constants so, and the results then agree bit
        # for bit where the moments are exact
        mean = s * (1.0 / n_global)
        cov = (outer - n_global * torch.outer(mean, mean)) * (1.0 / (n_global - 1))
        return mean, cov

    return fn


def make_distributed_lloyd(mesh):
    """``fn(xs, centroids) -> (new centroids (k, d), assignments (n,)
    int32)``: one Lloyd step over the row shards ``xs`` (projected data).
    Each shard assigns through ``kernels.ops.kmeans_assign`` and sums its
    clusters deterministically (no atomics on the card); the per-shard sums
    are added in shard order, so a step on the card repeats bit for bit.
    The assignments come back as one tensor on the first shard's device."""

    def fn(xs, centroids):
        home = _home(mesh, xs)
        k = centroids.shape[0]

        def shard(i):
            x = xs[i]
            a, _d = ops.kmeans_assign(x, centroids.to(x.device))
            sm, ct = cluster_sums(x[None], a[None], k)
            return sm[0], ct[0], a

        parts = walk(len(xs), shard_coords(mesh), shard, lambda i: (xs[i],))
        new_c = new_means(_summed([p[0] for p in parts], home),
                          _summed([p[1] for p in parts], home), centroids.to(home))
        return new_c, torch.cat([p[2].to(home) for p in parts])

    return fn


def make_distributed_cell_sizes(mesh, sqrt_k: int):
    """``fn(a1s, a2s) -> (sqrt_k, sqrt_k) int32``: the global IMI cell
    populations from row shards of the two half assignments."""

    def fn(a1s, a2s):
        home = _home(mesh, a1s)
        local = walk(len(a1s), shard_coords(mesh),
                     lambda i: torch.bincount(a1s[i].long() * sqrt_k + a2s[i].long(),
                                              minlength=sqrt_k * sqrt_k))
        return _summed(local, home).to(torch.int32).reshape(sqrt_k, sqrt_k)

    return fn

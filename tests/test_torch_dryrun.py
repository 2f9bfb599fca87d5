"""The port's counter (``repro_torch.launch.op_analysis``), its position
hooks (``repro_torch.mesh``: ``position``, ``walk``, ``scan``, ``tally``,
``one_pass``) and the LM dry run (``repro_torch.launch.dryrun``), on the
CPU.

* A hand-checked tiny case: one ``x.T @ x`` counts 2 n d^2 flops and its
  operands and output once (the transpose is a view, free), a reshape is
  free, work outside any position counts at every position, work inside
  one only where the coordinates agree, a payload by kind.
* Counts on meta tensors equal counts of the same code on CPU tensors of
  the same shapes, exactly, for the distributed build covariance and both
  query pipelines (the card's check in ``chip_smoke.py`` does the same on
  the H100). The Lloyd step is left out: on meta it counts the card's
  one-hot sums, which the CPU does not run.
* Tracing one representative position (and one step of a Mamba scan
  without gradients) gives the counts of tracing them all, exactly.
* The LM cells (``dryrun.count_cell``) at tiny shapes: the manual MoE's
  and jamba's (both expert-parallel) train and prefill steps, and a
  manual-MoE decode step, counted on CPU tensors and on meta tensors with
  representatives equal exactly; a manual-MoE decode cell holds and runs
  one position's block, in the expert-parallel layout and (the moe
  family's layout choice narrowed to granite-moe and arctic) in the
  replicated one.
* The tensor-parallel cells (the dense stack at train_4k, prefill_32k,
  decode_32k) and the expert-parallel ones (the moe family's, gspmd's
  whole-batch aux and both expert splits) at tiny shapes, counted on CPU
  tensors and on meta tensors with representatives: equal exactly. The
  moe family's six cells, rwkv6's and jamba's (rwkv6 tensor-parallel,
  jamba expert-parallel), whisper's three (tensor-parallel, the cross
  cache along the frames or head_dim) and every long_500k (context
  parallel) on both production meshes: argument bytes pinned, every one
  fitting a card; no production cell is replicated. Smoke train cells on
  a small meta mesh, their payloads pinned: the dense stack's, rwkv6's and
  whisper's tensor-parallel ones, jamba's expert-parallel one, and the
  replicated layout's on whisper and on jamba (each family's layout choice
  narrowed for the test).
* granite-3-2b x decode_32k beside the reference's dry run in a subprocess
  (``param_count``, ``step_kind``, ``n_devices``; the argument bytes equal,
  the flops within 0.8-1.25x), and a smoke config's tensor-parallel train
  cell on a small meta mesh with its payloads pinned.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import taco_config
from repro_torch.launch import dryrun, dryrun_ann
from repro_torch.launch import sharding as SH
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.mesh import (
    entry_axes,
    make_mesh,
    position,
    scan,
    set_mesh,
    tally,
    tensor_bytes,
    walk,
)
from repro_torch.models import model as TM
from repro_torch.models import sharded as SHD
from repro_torch.optim import adamw, constant_lr
from repro_torch.train.loop import TrainState, make_shardmap_train_step
from repro_torch.utils import tree_flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_counter_on_a_hand_checked_case():
    n, d = 6, 4
    mesh = make_mesh((2, 3), ("data", "model"), ["meta"] * 6)
    x = torch.empty((n, d), device="meta")
    with OpCounter(mesh) as c:
        x.T @ x  # a view, then one product: 2 n d^2, x read twice, d x d written
    h = c.analysis()
    assert h["flops"] == 2 * n * d * d
    assert h["bytes"] == 2 * n * d * 4 + d * d * 4
    with OpCounter(mesh) as c:
        x.reshape(d, n).T.view(n, d)[1:]  # views only
    assert c.analysis()["bytes"] == 0 and c.analysis()["flops"] == 0
    with OpCounter(mesh) as c:
        x + 1  # everywhere: n d read, n d written
        with position(data=1):
            x * 2  # only on the data=1 row of the mesh
            tally("all-reduce", 100)
    totals = {tuple(here.values()): t for here, t in c.position_totals()}
    assert totals[(0, 2)]["bytes"] == 2 * n * d * 4
    assert totals[(1, 0)]["bytes"] == 4 * n * d * 4
    assert totals[(0, 0)]["collective_bytes"] == {}
    h = c.analysis()
    assert h["bytes"] == 4 * n * d * 4 and h["collective_total"] == 100
    assert h["collective_counts"]["all-reduce"] == 1 and h["positions"] == 6


def test_counter_keeps_fill_values_of_each_type_apart():
    """The counter reuses a meta op's output metadata by signature; 0, 0.0
    and False are equal in Python but give ``full`` three dtypes."""
    mesh = make_mesh((2,), ("data",), ["meta"] * 2)
    with OpCounter(mesh):
        got = [torch.full((3,), v, device="meta").dtype for v in (0, 0.0, False, 0)]
    assert got == [torch.int64, torch.float32, torch.bool, torch.int64]


def test_walk_builds_coordinates_only_under_a_counter():
    def coords(i):
        raise AssertionError("coordinates built without a counter")

    assert walk(3, coords, lambda i: i * i) == [0, 1, 4]
    mesh = make_mesh((3,), ("data",), ["meta"] * 3)
    with OpCounter(mesh) as c:
        walk(3, lambda i: {"data": i}, lambda i: torch.empty((i + 1,), device="meta") + 1)
    assert [t["bytes"] for _here, t in c.position_totals()] == [8, 16, 24]


def _small_ann(device, rerank):
    """The ANN jobs at n = 4 x 2048 over 4 shards on ``device``, a small
    config (1024 cells), the inputs drawn where the device holds values."""
    cfg = taco_config(n_subspaces=6, subspace_dim=8, n_clusters=1024, alpha=0.05, beta=0.005,
                      k=10, candidate_cap=64, rerank=rerank)
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    n, d = 4 * 2048, 32
    index = dryrun_ann.make_index(n, d, cfg, device=device, generator=gen)

    def draw(*shape):
        if gen is None:
            return torch.empty(shape, device=device)
        return torch.randn(shape, generator=gen)

    shards = make_mesh((4,), ("shard",), [device] * 4)
    return shards, dryrun_ann.ann_jobs(shards, index, cfg, draw(8, d), draw(n, d), draw(n, 4),
                                       draw(cfg.sqrt_k, 4))


@pytest.mark.parametrize("job, rerank", [("build_cov", "gather"), ("query", "gather"),
                                         ("query", "masked_full")])
def test_meta_counts_equal_the_counts_on_real_tensors(job, rerank):
    """The same code on CPU tensors (drawn values) and on meta tensors of
    the same shapes, every shard traced and one representative shard:
    flops, bytes, payloads and argument bytes equal."""
    results = []
    for device, represent in (("cpu", False), ("meta", False), ("meta", True)):
        shards, jobs = _small_ann(device, rerank)
        fn, arg_bytes = jobs[job]
        h, _secs = dryrun_ann.count_job(shards, fn, represent=represent)
        results.append((h["flops"], h["bytes"], h["collective_bytes"], arg_bytes))
        assert (h["represented_positions"] > 0) == (device == "meta" and represent)
    assert results[0] == results[1] == results[2]
    assert results[0][0] > 0 and results[0][1] > 0 and sum(results[0][2].values()) > 0


def test_a_representative_position_counts_as_tracing_them_all():
    """make_shardmap_train_step over a (data 2, model 2) meta mesh with the
    smoke granite-moe's manual MoE nested in each data shard, a jamba smoke
    prefill without gradients and a jamba smoke train step (its Mamba
    scans with and without gradients, remat): representing walks and scan
    steps gives every count of the full trace."""
    mesh = make_mesh((2, 2), ("data", "model"), ["meta"] * 4)
    cfg = dataclasses.replace(get_smoke("granite-moe-3b-a800m"), moe_impl="manual",
                              moe_dispatch_chunks=2)
    opt = adamw()
    tokens = torch.empty((4, 16), dtype=torch.int32, device="meta")
    jamba = get_smoke("jamba-1.5-large-398b")
    jamba_params = TM.meta_params(jamba)
    analyses = []
    for represent in (False, True):
        params = TM.meta_params(cfg)
        state = TrainState(params=params, opt_state=opt[0](params),
                           step=torch.zeros((), dtype=torch.int32))
        step = make_shardmap_train_step(cfg, opt, constant_lr(1e-3), mesh, compress_grads=False,
                                        impl="torch")
        with set_mesh(mesh), OpCounter(mesh, represent=represent) as c:
            step(state, {"tokens": tokens, "labels": tokens})
        with OpCounter(mesh, represent=represent) as s, torch.no_grad():
            TM.prefill(jamba_params, jamba, {"tokens": tokens[:1]}, 16, impl="torch")
        jstate = TrainState(params=jamba_params, opt_state=opt[0](jamba_params),
                            step=torch.zeros((), dtype=torch.int32))
        jstep = make_shardmap_train_step(jamba, opt, constant_lr(1e-3), mesh,
                                         compress_grads=False, impl="torch")
        with OpCounter(mesh, represent=represent) as g:
            jstep(jstate, {"tokens": tokens, "labels": tokens})
        analyses.append((c.analysis(), c.represented, s.analysis(), s.represented_steps,
                         g.analysis(), g.represented_steps))
    (full, none, full_scan, no_steps, full_grad, no_grad_steps), \
        (rep, some, rep_scan, steps, rep_grad, grad_steps) = analyses
    assert none == 0 and some > 0 and no_steps == 0 and steps > 0
    assert no_grad_steps == 0 and grad_steps > 0
    for key in ("flops", "bytes", "collective_bytes", "collective_counts", "collective_total"):
        assert rep[key] == full[key], key
        assert rep_scan[key] == full_scan[key], key
        assert rep_grad[key] == full_grad[key], key
    assert full["collective_bytes"]["all-reduce"] > 0


@pytest.mark.parametrize("final_carry", [False, True])
def test_a_represented_scan_counts_as_the_written_loop(final_carry):
    """mesh.scan under gradients, one node on meta with representatives,
    against the loop as written (meta without representatives, and CPU
    tensors): the same flops and bytes, whether the loss reads only the
    steps' outputs or also the final carry (its gradient entering at the
    last step)."""
    def core(x, h, a):
        h = h * torch.exp(a) + x
        return h.sum(-1), h

    got = []
    for device, represent in (("cpu", False), ("meta", False), ("meta", True)):
        mesh = make_mesh((1,), ("data",), [device])
        xs = torch.ones((2, 7, 5), device=device, requires_grad=True)
        a = torch.ones((5,), device=device, requires_grad=True)
        with OpCounter(mesh, represent=represent) as c:
            ys, h = scan(core, 7, torch.zeros((2, 5), device=device), (xs,), (a,))
            loss = torch.stack(ys, 1).sum() + (h.sum() if final_carry else 0)
            torch.autograd.grad(loss, [xs, a])
        got.append((c.analysis()["flops"], c.analysis()["bytes"], c.represented_steps))
    assert got[0][:2] == got[1][:2] == got[2][:2] and got[0][1] > 0
    assert got[1][2] == 0 and got[2][2] == 6


#: tiny stand-ins for the cells' shapes: the same kinds, 4 sequences of 16
TINY = {"train_4k": ShapeSpec("train_4k", "train", 16, 4),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill", 16, 4),
        "decode_32k": ShapeSpec("decode_32k", "decode", 16, 4)}


def _manual(arch_name):
    """The smoke config with 16 experts, so that the dry run's
    ``sharded_arch`` takes the manual MoE (the smoke configs have 4)."""
    return dataclasses.replace(get_smoke(arch_name), n_experts=16)


@pytest.mark.parametrize("arch_name, shape_name", [
    ("granite-moe-3b-a800m", "train_4k"), ("granite-moe-3b-a800m", "prefill_32k"),
    ("jamba-1.5-large-398b", "train_4k"), ("jamba-1.5-large-398b", "prefill_32k"),
    ("jamba-1.5-large-398b", "decode_32k"), ("arctic-480b", "decode_32k")])
def test_lm_meta_counts_equal_the_counts_on_real_tensors(monkeypatch, arch_name, shape_name):
    """count_cell at a tiny shape over a (data 2, model 2) grid, on CPU
    tensors (seeded weights, zero inputs; every position and scan step
    traced) and on meta tensors with representative positions and scan
    steps: flops, bytes, payloads and argument bytes equal exactly. The
    CPU side runs on one thread: its ops are tiny, and a pool of threads
    a worker makes jamba's train step ten times slower beside other
    workers."""
    monkeypatch.setitem(dryrun.SHAPES, shape_name, TINY[shape_name])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got, traced = _count_cpu_and_meta(arch_name, shape_name)
    finally:
        torch.set_num_threads(threads)
    assert got[0] == got[1]
    assert got[0][0] > 0 and got[0][2]["all-reduce"] > 0
    assert traced[0] == 0 and (traced[1] > 0 or shape_name == "decode_32k")


def _count_cpu_and_meta(arch_name, shape_name):
    got, traced = [], []
    for device in ("cpu", "meta"):
        mesh = make_mesh((2, 2), ("data", "model"), [device] * 4)
        h, meta = dryrun.count_cell(arch_name, shape_name, False, mesh=mesh,
                                    arch=_manual(arch_name), device=device)
        assert meta["moe_impl"] == "manual" and meta["rows_per_position"] == 2
        got.append((h["flops"], h["bytes"], h["collective_bytes"], h["collective_counts"],
                    meta["argument_size_in_bytes"]))
        traced.append(meta["represented_positions"] + meta["represented_steps"])
    return got, traced


def test_a_manual_moe_decode_cell_runs_one_positions_block():
    """arctic's smoke config with 16 experts at decode_32k (B 128) over
    (data 4, model 2) and (data 2, model 2) meta grids, in the
    expert-parallel layout: a position holds and runs B / |data| sequences
    over its row of 'model' positions. Its argument bytes are the bf16
    weights, its cache, its tokens and the position under the sanitized
    specs (8 experts a position). Per layer the step all-reduces the
    decode attention's partial softmax sums and its out projection's, the
    experts' partial outputs and the dense residual MLP's (and the
    embedding's once), and gathers q, k, v (and the last logits once):
    activations of the block's rows, so twice the rows move twice the
    payload."""
    arch = _manual("arctic-480b")
    rows, payload = {}, {}
    for data in (4, 2):
        mesh = make_mesh((data, 2), ("data", "model"), ["meta"] * (2 * data))
        h, meta = dryrun.count_cell("arctic-480b", "decode_32k", False, mesh=mesh, arch=arch)
        block = 128 // data
        bf16 = dataclasses.replace(arch, param_dtype="bfloat16")
        params = TM.meta_params(bf16)
        cache = TM.init_cache(bf16, 128, 32768, device="meta")
        tokens = torch.empty((128, 1), dtype=torch.int32, device="meta")
        want = (SH.position_bytes(params, SHD.param_specs(params, mesh), mesh)
                + SH.position_bytes(cache, SHD.cache_specs(cache, mesh, ("data",)), mesh)
                + SH.position_bytes(tokens, SH.sanitize_specs(
                    tokens, SH.P(("data",), None), mesh), mesh) + 4)
        moe = params["blocks"]["l0"]["moe"]
        placed = SHD.place(moe, SHD.param_specs(params, mesh)["blocks"]["l0"]["moe"], mesh)
        assert placed["gate"].blocks[(0,)].shape[1] == 8
        assert meta["layout_name"] == "expert_parallel" and meta["moe_impl"] == "manual"
        assert meta["experts"] == "whole experts, 8 a position"
        assert meta["rows_per_position"] == block
        assert meta["argument_size_in_bytes"] == want
        assert h["collective_counts"]["all-reduce"] == 1 + 4 * arch.n_layers
        assert h["collective_counts"]["all-gather"] == 1 + 3 * arch.n_layers
        rows[data], payload[data] = meta["rows_per_position"], h["collective_bytes"]
    assert rows == {4: 32, 2: 64}
    assert all(payload[2][k] == 2 * payload[4][k] for k in payload[4])


def test_a_replicated_manual_moe_decode_cell_runs_one_positions_block(monkeypatch):
    """jamba's smoke config with 16 experts at decode_32k (B 128) in the
    replicated layout (jamba's cells are expert-parallel now, so the
    layout choice is narrowed to the moe family, EP_FAMILIES, for this
    test: no production LM cell runs the replicated manual MoE at
    decode_32k any more), over (data 4, model 2) and (data 2, model 2)
    meta grids: a position holds and runs B / |data| sequences. Its
    argument bytes are the bf16 weights with the experts halved, one token
    and the position of each of its sequences, and their caches; its MoE
    is one block a MoE layer, whose sum over the expert blocks is one
    all-reduce of the block's activations."""
    monkeypatch.setattr(dryrun, "EP_FAMILIES", ("moe",))
    arch = _manual("jamba-1.5-large-398b")
    moe_layers = arch.n_layers // arch.moe_every
    rows, payload = {}, {}
    for data in (4, 2):
        mesh = make_mesh((data, 2), ("data", "model"), ["meta"] * (2 * data))
        h, meta = dryrun.count_cell("jamba-1.5-large-398b", "decode_32k", False, mesh=mesh,
                                    arch=arch)
        block = 128 // data
        bf16 = dataclasses.replace(arch, param_dtype="bfloat16")
        params = TM.meta_params(bf16)
        experts = sum(tensor_bytes(layer["moe"][n]) for layer in params["blocks"].values()
                      if "moe" in layer for n in ("gate", "up", "down"))
        cache = TM.init_cache(bf16, block, 32768, device="meta")
        want = (sum(tensor_bytes(t) for t in TM.tree_leaves(params)) - experts // 2
                + 4 * block + 4 + sum(tensor_bytes(t) for t in TM.tree_leaves(cache)))
        assert meta["layout_name"] == "replicated" and meta["moe_impl"] == "manual"
        assert meta["rows_per_position"] == block
        assert meta["argument_size_in_bytes"] == want
        assert h["collective_counts"]["all-reduce"] == moe_layers == 4
        rows[data], payload[data] = meta["rows_per_position"], h["collective_bytes"]["all-reduce"]
    assert rows == {4: 32, 2: 64} and payload[2] == 2 * payload[4]


def test_smoke_train_cell_on_a_small_meta_mesh():
    """count_cell at train_4k with the smoke granite-3-2b over a (data 4,
    model 2) meta mesh, the tensor-parallel layout: a position runs 256 / 4
    rows. Per position: a reduce-scatter of each leaf's gradient into its
    ZeRO-1 slice (float32; every leaf has a dimension that divides by 4)
    and an all-gather of the updated slices into the leaf's 'model' block;
    the all-reduces of tensor parallelism over the block's activations
    (64 x 4096 x 64 float32): the embedding's sum, each layer's attention
    and MLP sums twice (forward and remat's recompute) and the gradients of
    the attention's, the MLP's and the head's replicated inputs; the
    loss's max and its sums (64 x 4096, and 2 of them), and the global
    norm's 4 bytes. The counter represents the data blocks past the first
    (3), and of each leaf's walks all but the first position: its
    reduce-scatter's over its 'model' blocks, its norm's and its update's
    over its moment's blocks."""
    mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
    cfg = get_smoke("granite-3-2b")
    h, meta = dryrun.count_cell("granite-3-2b", "train_4k", False, mesh=mesh, arch=cfg)
    params = TM.meta_params(cfg)
    leaves = tree_flatten(params)[0]
    specs = SHD.param_specs(params, mesh)
    blocks = sum(tensor_bytes(t) // (2 if "model" in s else 1)
                 for t, s in zip(leaves, tree_flatten(specs)[0]))
    assert meta["step_kind"] == "train_step" and meta["rows_per_position"] == 64
    assert meta["layout_name"] == "tensor_parallel" and meta["layout"] == dryrun.LAYOUTS[
        "tensor_parallel"]
    assert meta["param_count"] == sum(t.numel() for t in leaves)
    assert h["collective_counts"]["reduce-scatter"] == len(leaves)
    assert h["collective_bytes"]["reduce-scatter"] == blocks // 4
    assert h["collective_counts"]["all-gather"] == len(leaves)
    assert h["collective_bytes"]["all-gather"] == blocks
    act, row = 64 * 4096 * cfg.d_model * 4, 64 * 4096 * 4
    layers = cfg.n_layers
    assert h["collective_counts"]["all-reduce"] == 1 + 6 * layers + 1 + 2 + 1
    assert h["collective_bytes"]["all-reduce"] == (1 + 6 * layers + 1) * act + 3 * row + 4
    assert h["flops"] > 0 and h["bytes"] > 0 and meta["fits_one_card"]
    state = TrainState(params=params, opt_state=adamw()[0](params),
                       step=torch.zeros((), dtype=torch.int32))
    sspecs = SH.sanitize_specs(state, SH.train_state_pspecs(state, ("data",), mesh), mesh)

    def n_blocks(spec):
        return math.prod(mesh.shape[a] for e in spec for a in entry_axes(e))

    walks = sum((n_blocks(p) - 1) + 2 * (n_blocks(m) - 1)
                for p, m in zip(tree_flatten(sspecs.params)[0],
                                tree_flatten(sspecs.opt_state.m)[0]))
    # 9 leaves in 2 'model' blocks and 8 moment blocks; the 3 norms whole,
    # their moments in 4 blocks over 'data'
    assert walks == 9 * (1 + 2 * 7) + 3 * (0 + 2 * 3)
    assert meta["represented_positions"] == 3 + walks == 156


def test_smoke_replicated_train_cell_on_a_small_meta_mesh(monkeypatch):
    """count_cell at train_4k with the smoke whisper-medium in the
    replicated layout (the enc-dec stack is tensor-parallel now, so the
    layout choice is narrowed to the other families, TP_FAMILIES, for this
    test) over the same (data 4, model 2) meta mesh: a position holds 256 /
    4 rows and the whole model, the gradient sum is one all-reduce of each
    leaf's bytes (uncompressed f32), three data shards are represented by
    the first, and the artifact's fields are filled."""
    monkeypatch.setattr(dryrun, "TP_FAMILIES", ("dense", "vlm", "ssm"))
    mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
    cfg = get_smoke("whisper-medium")
    h, meta = dryrun.count_cell("whisper-medium", "train_4k", False, mesh=mesh, arch=cfg)
    leaves = TM.tree_leaves(TM.meta_params(cfg))
    assert meta["step_kind"] == "train_step" and meta["rows_per_position"] == 64
    assert meta["layout_name"] == "replicated" and meta["layout"] == dryrun.LAYOUTS[
        "replicated"]
    assert meta["param_count"] == sum(t.numel() for t in leaves)
    assert h["collective_bytes"]["all-reduce"] == sum(4 * t.numel() for t in leaves)
    assert h["collective_counts"]["all-reduce"] == len(leaves)
    assert h["collective_counts"]["reduce-scatter"] == h["collective_counts"]["all-gather"] == 0
    assert h["flops"] > 0 and h["bytes"] > 0 and meta["fits_one_card"]
    assert meta["represented_positions"] == 3


def test_smoke_enc_dec_train_cell_on_a_small_meta_mesh():
    """count_cell at train_4k with the smoke whisper-medium over the (data
    4, model 2) meta mesh, the tensor-parallel layout: a position runs 256 /
    4 rows of 4096 tokens over 16 frames. Per position: a reduce-scatter of
    each leaf's gradient into its ZeRO-1 slice and an all-gather of the
    updated slices; the all-reduces of tensor parallelism: the embedding's
    sum; each decoder layer's self-attention, cross-attention and MLP sums
    twice (forward and remat's recompute) and the gradients of their
    replicated inputs (the normed h of each, and the encoder's output that
    cross-attention reads: 4); each encoder layer's attention and MLP sums
    twice and their inputs' gradients (2); the head's input gradient, the
    loss's max and its sums, and the global norm's 4 bytes."""
    mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
    cfg = get_smoke("whisper-medium")
    h, meta = dryrun.count_cell("whisper-medium", "train_4k", False, mesh=mesh, arch=cfg)
    params = TM.meta_params(cfg)
    leaves = tree_flatten(params)[0]
    specs = SHD.param_specs(params, mesh)
    state = TrainState(params=params, opt_state=adamw()[0](params),
                       step=torch.zeros((), dtype=torch.int32))
    moments = tree_flatten(SH.sanitize_specs(state, SH.train_state_pspecs(
        state, ("data",), mesh), mesh).opt_state.m)[0]
    # the biases split over 'model' (qkv's) have no free dimension that
    # divides by 4: their gradient sum is an all-reduce of their block
    zero = [any("data" in entry_axes(e) for e in m) for m in moments]
    sizes = [tensor_bytes(t) // (2 if "model" in s else 1)
             for t, s in zip(leaves, tree_flatten(specs)[0])]
    whole = sum(b for b, z in zip(sizes, zero) if not z)
    assert meta["step_kind"] == "train_step" and meta["rows_per_position"] == 64
    assert meta["layout_name"] == "tensor_parallel" and meta["layout"] == dryrun.LAYOUTS[
        "tensor_parallel"]
    assert meta["optimizer"] == "adamw" and meta["heads"] == "heads split"
    assert sum(zero) == len(leaves) - 11
    assert h["collective_counts"]["reduce-scatter"] == sum(zero)
    assert h["collective_bytes"]["reduce-scatter"] == (sum(sizes) - whole) // 4
    assert h["collective_counts"]["all-gather"] == sum(zero)
    assert h["collective_bytes"]["all-gather"] == sum(sizes) - whole
    dec, enc = cfg.n_layers, cfg.encoder_layers
    act, row = 64 * 4096 * cfg.d_model * 4, 64 * 4096 * 4
    frames = 64 * cfg.frontend_len * cfg.d_model * 4
    assert h["collective_counts"]["all-reduce"] == (1 + 10 * dec + 6 * enc + 1 + 2 + 1
                                                    + len(leaves) - sum(zero))
    assert h["collective_bytes"]["all-reduce"] == ((1 + 9 * dec + 1) * act
                                                   + (dec + 6 * enc) * frames + 3 * row + 4
                                                   + whole)
    assert h["flops"] > 0 and h["bytes"] > 0 and meta["fits_one_card"]


def test_smoke_replicated_moe_train_cell_on_a_small_meta_mesh(monkeypatch):
    """count_cell at train_4k (its 256 sequences cut to 128 tokens: the
    Mamba scans' length moves none of the pins) with the smoke
    jamba-1.5-large-398b (an MoE every second layer) in the replicated
    layout (every MoE train cell is expert-parallel now, so the layout
    choice is narrowed to the moe family, EP_FAMILIES, for this test) over
    the same (data 4, model 2) meta mesh: a position holds 256 / 4 rows
    and the whole model, the gradient sum is one all-reduce of each leaf's
    bytes (uncompressed f32), three data shards are represented by the
    first, and the artifact's fields are filled."""
    monkeypatch.setattr(dryrun, "EP_FAMILIES", ("moe",))
    monkeypatch.setitem(dryrun.SHAPES, "train_4k", ShapeSpec("train_4k", "train", 128, 256))
    mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
    cfg = get_smoke("jamba-1.5-large-398b")
    h, meta = dryrun.count_cell("jamba-1.5-large-398b", "train_4k", False, mesh=mesh, arch=cfg)
    leaves = TM.tree_leaves(TM.meta_params(cfg))
    assert meta["step_kind"] == "train_step" and meta["rows_per_position"] == 64
    assert meta["layout_name"] == "replicated" and meta["layout"] == dryrun.LAYOUTS[
        "replicated"]
    assert meta["moe_impl"] == "gspmd"
    assert meta["param_count"] == sum(t.numel() for t in leaves)
    assert h["collective_bytes"]["all-reduce"] == sum(4 * t.numel() for t in leaves)
    assert h["collective_counts"]["all-reduce"] == len(leaves)
    assert h["collective_counts"]["reduce-scatter"] == h["collective_counts"]["all-gather"] == 0
    assert h["flops"] > 0 and h["bytes"] > 0 and meta["fits_one_card"]
    assert meta["represented_positions"] == 3


def _sharded_blocks(params, mesh) -> tuple[list, int]:
    """(the leaves, the bytes of one position's 'model' blocks of them)."""
    leaves = tree_flatten(params)[0]
    specs = SHD.param_specs(params, mesh)
    return leaves, sum(tensor_bytes(t) // (mesh.shape["model"] if "model" in [
        a for e in sp for a in entry_axes(e)] else 1) for t, sp in zip(
        leaves, tree_flatten(specs)[0]))


def test_smoke_tensor_parallel_rwkv_train_cell_on_a_small_meta_mesh():
    """count_cell at train_4k with the smoke rwkv6-7b (4 heads of 16, 2
    layers) over a (data 4, model 2) meta mesh, the tensor-parallel layout:
    a position runs 256 / 4 rows (4096 tokens, the chunked WKV) over its
    two heads. Per position: a reduce-scatter of each leaf's gradient into
    its ZeRO-1 slice and an all-gather of the updated slices (as the dense
    stack's); each layer's channel mix gathers r's column blocks (forward
    and remat's recompute; its backward a reduce-scatter) and its
    backward all-gathers the gradients of the replicated leaves a position
    reads a slice of (w0, w_lora_b, ln_x's scale); the all-reduces over the
    block's activations (64 x 4096 x 64 float32; the LoRA's rank is 64 as
    well): the embedding's sum, each layer's ln_x mean square (a row of 64 x
    4096), wo's and the channel mix's v sums twice (forward and recompute),
    the gradients of the five inputs of the time mix's positions and of
    the mean square, and of the channel mix's two; the head's, the loss's
    max and sums, and the global norm's 4 bytes."""
    mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
    cfg = get_smoke("rwkv6-7b")
    h, meta = dryrun.count_cell("rwkv6-7b", "train_4k", False, mesh=mesh, arch=cfg)
    params = TM.meta_params(cfg)
    leaves, blocks = _sharded_blocks(params, mesh)
    layers, d = cfg.n_layers, cfg.d_model
    assert meta["step_kind"] == "train_step" and meta["rows_per_position"] == 64
    assert meta["layout_name"] == "tensor_parallel" and meta["layout"] == dryrun.LAYOUTS[
        "tensor_parallel"]
    assert meta["heads"] == "heads split" and meta["optimizer"] == "adamw"
    assert meta["param_count"] == sum(t.numel() for t in leaves)
    act, row = 64 * 4096 * d * 4, 64 * 4096 * 4
    assert h["collective_counts"]["reduce-scatter"] == len(leaves) + layers
    assert h["collective_bytes"]["reduce-scatter"] == blocks // 4 + layers * act // 2
    assert h["collective_counts"]["all-gather"] == len(leaves) + 5 * layers
    assert h["collective_bytes"]["all-gather"] == blocks + layers * (
        2 * act + (d + 64 * d + d) * 4)
    assert h["collective_counts"]["all-reduce"] == 1 + 14 * layers + 1 + 2 + 1
    assert h["collective_bytes"]["all-reduce"] == (
        (1 + 11 * layers + 1) * act + (3 * layers + 3) * row + 4)
    assert h["collective_counts"]["all-to-all"] == 0
    assert h["flops"] > 0 and h["bytes"] > 0 and meta["fits_one_card"]


def test_smoke_expert_parallel_jamba_train_cell_on_a_small_meta_mesh(monkeypatch):
    """count_cell at train_4k (its 256 sequences cut to 128 tokens, as the
    replicated twin's) with the smoke jamba-1.5-large-398b (4 experts, so
    gspmd; 7 Mamba layers, one attention layer with 2 KV heads, 4 MoE
    layers) over the same (data 4, model 2) meta mesh, the expert-parallel
    layout: a position runs 64 rows over its half of the heads (2 KV heads
    over 2: none gathered), the inner channels and the experts (2 whole).
    Per position: each leaf's gradient reduce-scattered into its ZeRO-1
    slice and the slices all-gathered, but for each Mamba layer's conv_b,
    d and dt_proj's bias ((1, 128), split over 'model': no free dimension
    divides by 4, so their gradients are all-reduced whole and nothing is
    gathered); each Mamba layer's x/z re-split, an all-to-all of a
    position's block of in_proj's product (64 x 128 x 128 float32) in the
    forward, remat's recompute and the backward."""
    monkeypatch.setitem(dryrun.SHAPES, "train_4k", ShapeSpec("train_4k", "train", 128, 256))
    mesh = make_mesh((4, 2), ("data", "model"), ["meta"] * 8)
    cfg = get_smoke("jamba-1.5-large-398b")
    h, meta = dryrun.count_cell("jamba-1.5-large-398b", "train_4k", False, mesh=mesh, arch=cfg)
    params = TM.meta_params(cfg)
    leaves, blocks = _sharded_blocks(params, mesh)
    mamba = sum(s["mixer"] == "mamba" for s in cfg.layer_specs()) * cfg.n_groups
    din = cfg.mamba_expand * cfg.d_model
    assert meta["step_kind"] == "train_step" and meta["rows_per_position"] == 64
    assert meta["layout_name"] == "expert_parallel" and meta["layout"] == dryrun.LAYOUTS[
        "expert_parallel"]
    assert meta["moe_impl"] == "gspmd" and meta["experts"] == "whole experts, 2 a position"
    assert meta["heads"] == "heads split" and meta["optimizer"] == "adamw"
    assert meta["param_count"] == sum(t.numel() for t in leaves)
    whole = 3 * mamba  # conv_b, d, dt_proj's bias: 64 float32 a position each
    assert h["collective_counts"]["reduce-scatter"] == len(leaves) - whole
    assert h["collective_bytes"]["reduce-scatter"] == (blocks - whole * 64 * 4) // 4
    assert h["collective_counts"]["all-gather"] == len(leaves) - whole
    assert h["collective_bytes"]["all-gather"] == blocks - whole * 64 * 4
    assert h["collective_counts"]["all-to-all"] == 3 * mamba == 21
    assert h["collective_bytes"]["all-to-all"] == 3 * mamba * 64 * 128 * (2 * din // 2) * 4
    assert h["collective_counts"]["all-reduce"] > 0
    assert h["flops"] > 0 and h["bytes"] > 0 and meta["fits_one_card"]


@pytest.mark.parametrize("arch_name, shape_name, data", [
    ("granite-3-2b", "train_4k", 2), ("granite-3-2b", "decode_32k", 2),
    ("llava-next-mistral-7b", "prefill_32k", 2), ("starcoder2-3b", "decode_32k", 2),
    ("granite-3-2b", "prefill_32k", 4), ("rwkv6-7b", "train_4k", 2),
    ("rwkv6-7b", "prefill_32k", 2), ("rwkv6-7b", "decode_32k", 2)])
def test_tensor_parallel_meta_counts_equal_the_counts_on_real_tensors(monkeypatch, arch_name,
                                                                      shape_name, data):
    """The tensor-parallel layout's sharded train step, prefill and decode
    step (the dense stack's, and rwkv6's: the WKV over its heads, the
    channel mix, the recurrent states) at a tiny shape (4 sequences) over a
    (data, model 2) grid, on CPU
    tensors (every position traced) and on meta tensors (representatives):
    flops, bytes, payloads and argument bytes equal exactly. At data 4 a
    position prefills one sequence, whose cache the rule table splits as
    a one-row batch's (the sequence over the data axes and 'model', the
    data axes of size 1 in the position's row), as the multi-pod mesh's
    prefill_32k does."""
    monkeypatch.setitem(dryrun.SHAPES, shape_name, TINY[shape_name])
    got = []
    for device in ("cpu", "meta"):
        mesh = make_mesh((data, 2), ("data", "model"), [device] * (2 * data))
        h, meta = dryrun.count_cell(arch_name, shape_name, False, mesh=mesh,
                                    arch=get_smoke(arch_name), device=device)
        assert meta["layout_name"] == "tensor_parallel"
        assert meta["rows_per_position"] == 4 // data
        got.append((h["flops"], h["bytes"], h["collective_bytes"], h["collective_counts"],
                    meta["argument_size_in_bytes"]))
    assert got[0] == got[1]
    assert got[0][0] > 0 and got[0][2]["all-reduce"] > 0


@pytest.mark.parametrize("experts, data, shape_name", [
    (4, 2, "train_4k"), (6, 2, "train_4k"), (6, 2, "prefill_32k"), (4, 2, "decode_32k"),
    (6, 1, "decode_32k")])
def test_expert_parallel_meta_counts_equal_the_counts_on_real_tensors(monkeypatch, experts,
                                                                      data, shape_name):
    """The expert-parallel layout with the gspmd MoE (granite-moe's smoke
    config; 4 experts split whole over 'model' 2, 6 over 4 positions split
    the expert FFN width) at a tiny shape over a (data, model) grid, on CPU
    tensors and on meta tensors with representatives: flops, bytes,
    payloads and argument bytes equal exactly. The train step's aux needs
    every block's routing, so its data blocks all run."""
    monkeypatch.setitem(dryrun.SHAPES, shape_name, TINY[shape_name])
    cfg = dataclasses.replace(get_smoke("granite-moe-3b-a800m"), n_experts=experts)
    model = 2 if experts == 4 else 4
    got = []
    for device in ("cpu", "meta"):
        mesh = make_mesh((data, model), ("data", "model"), [device] * (data * model))
        h, meta = dryrun.count_cell("granite-moe-3b-a800m", shape_name, False, mesh=mesh,
                                    arch=cfg, device=device)
        assert meta["layout_name"] == "expert_parallel" and meta["moe_impl"] == "gspmd"
        assert meta["experts"].startswith("whole" if experts == 4 else "the expert FFN width")
        got.append((h["flops"], h["bytes"], h["collective_bytes"], h["collective_counts"],
                    meta["argument_size_in_bytes"]))
    assert got[0] == got[1]
    assert got[0][0] > 0 and got[0][2]["all-reduce"] > 0


#: the moe family's cells: (argument bytes a position on 16x16, on 2x16x16),
#: the reference's arguments under its sanitized specs
EXPERT_PARALLEL_BYTES = {
    ("granite-moe-3b-a800m", "train_4k"): (958_479_112, 904_997_256),
    ("granite-moe-3b-a800m", "prefill_32k"): (426_019_840, 425_888_768),
    ("granite-moe-3b-a800m", "decode_32k"): (1_499_499_556, 962_628_628),
    ("arctic-480b", "train_4k"): (60_608_372_836, 60_608_110_692),
    ("arctic-480b", "prefill_32k"): (60_558_837_760, 60_558_706_688),
    ("arctic-480b", "decode_32k"): (62_907_385_892, 61_732_980_756)}


@pytest.mark.parametrize("cell", list(EXPERT_PARALLEL_BYTES), ids="/".join)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_moe_cells_run_the_expert_parallel_layout(cell, multi_pod):
    """granite-moe's and arctic's train_4k, prefill_32k and decode_32k on
    both production meshes (the step built on meta, not counted): the
    expert_parallel layout, its argument bytes the reference's arguments
    under the sanitized specs, every one fitting a card (arctic fitted in no
    cell replicated); granite-moe's 40 experts split the FFN width over 16,
    arctic's 128 are whole, 8 a position; arctic's train cell runs
    Adafactor, granite-moe's AdamW, as the reference's pick_optimizer."""
    arch_name, shape_name = cell
    meta = dryrun.build_cell(arch_name, shape_name, multi_pod).meta
    assert meta["layout_name"] == "expert_parallel"
    assert meta["layout"] == dryrun.LAYOUTS["expert_parallel"]
    assert meta["argument_size_in_bytes"] == EXPERT_PARALLEL_BYTES[cell][multi_pod]
    assert meta["fits_one_card"]
    if shape_name == "train_4k":
        assert meta["optimizer"] == ("adafactor" if arch_name == "arctic-480b" else "adamw")
    assert meta["experts"] == ("whole experts, 8 a position" if arch_name == "arctic-480b"
                               else "the expert FFN width: gate/up columns, down output "
                                    "columns")
    assert meta["moe_impl"] == ("manual" if arch_name == "arctic-480b" else "gspmd")


def test_granite_moe_decode_artifact_is_expert_parallel(tmp_path):
    """granite-moe-3b-a800m x decode_32k through the dry run's command line:
    the artifact's layout is expert_parallel, its argument bytes
    1,499,499,556 equal position_bytes of the bf16 weights, the cache, the
    tokens and the position under the sanitized specs, and it fits a
    card."""
    assert dryrun.main(["--arch", "granite-moe-3b-a800m", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    got = json.loads((tmp_path / "granite-moe-3b-a800m__decode_32k__16_16.json").read_text())
    arch = dataclasses.replace(dryrun.get_arch("granite-moe-3b-a800m"), param_dtype="bfloat16")
    params = TM.meta_params(arch)
    mesh = make_mesh((16, 16), ("data", "model"), ["meta"] * 256)
    cache = TM.init_cache(arch, 128, 32768, device="meta")
    tokens = torch.empty((128, 1), dtype=torch.int32, device="meta")
    want = (SH.position_bytes(params, SHD.param_specs(params, mesh), mesh)
            + SH.position_bytes(cache, SHD.cache_specs(cache, mesh, ("data",)), mesh)
            + SH.position_bytes(tokens, SH.sanitize_specs(tokens, SH.P(("data",), None), mesh),
                                mesh) + 4)
    assert got["layout_name"] == "expert_parallel" and got["fits_one_card"]
    assert got["argument_size_in_bytes"] == want == 1_499_499_556
    assert got["rows_per_position"] == 8 and got["op_analysis"]["flops"] > 0


#: rwkv6's and jamba's cells at train_4k, prefill_32k and decode_32k: (argument
#: bytes a position on 16x16, on 2x16x16), the reference's arguments under its
#: sanitized specs; replicated they were 90.4 GB (rwkv6's train_4k) and
#: 144.8-155.1 GB (jamba's three), and fitted no card
SSM_PARALLEL_BYTES = {
    ("rwkv6-7b", "train_4k"): (2_196_494_344, 2_074_233_864),
    ("rwkv6-7b", "prefill_32k"): (976_248_832, 976_117_760),
    ("rwkv6-7b", "decode_32k"): (996_958_244, 986_472_468),
    ("jamba-1.5-large-398b", "train_4k"): (49_862_298_480, 49_862_036_336),
    ("jamba-1.5-large-398b", "prefill_32k"): (49_832_790_016, 49_832_658_944),
    ("jamba-1.5-large-398b", "decode_32k"): (50_472_634_404, 50_152_581_140)}


@pytest.mark.parametrize("cell", list(SSM_PARALLEL_BYTES), ids="/".join)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_rwkv_and_jamba_cells_run_the_sharded_layouts(cell, multi_pod):
    """rwkv6's and jamba's train_4k, prefill_32k and decode_32k on both
    production meshes (the step built on meta, not counted): rwkv6 in the
    tensor_parallel layout (its 64 heads split, 4 a position), jamba in the
    expert_parallel one (its 16 experts whole, 1 a position, the manual
    MoE; its 8 KV heads gathered over 16 positions); the argument bytes the
    reference's arguments under the sanitized specs, every one fitting a
    card; the train cells' optimizers the reference's pick_optimizer's
    (AdamW for rwkv6, Adafactor for jamba)."""
    arch_name, shape_name = cell
    meta = dryrun.build_cell(arch_name, shape_name, multi_pod).meta
    rwkv = arch_name == "rwkv6-7b"
    layout = "tensor_parallel" if rwkv else "expert_parallel"
    assert meta["layout_name"] == layout and meta["layout"] == dryrun.LAYOUTS[layout]
    assert meta["argument_size_in_bytes"] == SSM_PARALLEL_BYTES[cell][multi_pod]
    assert meta["fits_one_card"]
    assert meta["heads"] == ("heads split" if rwkv else "query heads split, K/V gathered")
    if shape_name == "train_4k":
        assert meta["optimizer"] == ("adamw" if rwkv else "adafactor")
    if not rwkv:
        assert meta["experts"] == "whole experts, 1 a position" and meta["moe_impl"] == "manual"


#: whisper's cells and every long_500k: (argument bytes a position on 16x16,
#: on 2x16x16), the reference's arguments under its sanitized specs;
#: replicated they were 1.7-295.6 GB, and codeqwen's, qwen's, arctic's,
#: jamba's and llava's long_500k fitted no card
SHARDED_BYTES = {
    ("whisper-medium", "train_4k"): (486_840_328, 415_887_368),
    ("whisper-medium", "prefill_32k"): (184_912_896, 178_637_824),
    ("whisper-medium", "decode_32k"): (1_856_703_524, 1_014_533_140),
    ("starcoder2-3b", "long_500k"): (715_305_992, 683_824_712),
    ("granite-3-2b", "long_500k"): (1_850_319_880, 1_766_349_320),
    ("codeqwen1.5-7b", "long_500k"): (6_427_968_520, 5_890_688_008),
    ("qwen1.5-4b", "long_500k"): (4_715_904_008, 4_296_153_608),
    ("arctic-480b", "long_500k"): (62_035_981_064, 61_889_068_424),
    ("granite-moe-3b-a800m", "long_500k"): (1_642_241_032, 1_575_064_584),
    ("rwkv6-7b", "long_500k"): (978_608_136, 978_608_136),
    ("llava-next-mistral-7b", "long_500k"): (2_256_486_408, 2_122_166_280),
    ("jamba-1.5-large-398b", "long_500k"): (50_216_947_976, 50_179_170_440)}


@pytest.mark.parametrize("cell", list(SHARDED_BYTES), ids="/".join)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_whisper_and_long_500k_cells_run_the_sharded_layouts(cell, multi_pod):
    """whisper's train_4k, prefill_32k and decode_32k and every long_500k
    on both production meshes (the step built on meta, not counted): the
    family's layout (expert_parallel for the moe family and jamba, else
    tensor_parallel), its argument bytes pinned, every one fitting a card.
    whisper's cross cache is split along head_dim (1500 frames over 16)
    and its layout text says so; a long_500k cell's one row runs on every
    position, its text names context parallelism, and its argument bytes
    are position_bytes of the bf16 weights, the cache, the token and the
    position under the sanitized specs."""
    arch_name, shape_name = cell
    meta = dryrun.build_cell(arch_name, shape_name, multi_pod).meta
    moe = arch_name in ("arctic-480b", "granite-moe-3b-a800m", "jamba-1.5-large-398b")
    layout = "expert_parallel" if moe else "tensor_parallel"
    assert meta["layout_name"] == layout and meta["layout"].startswith(dryrun.LAYOUTS[layout])
    assert meta["argument_size_in_bytes"] == SHARDED_BYTES[cell][multi_pod]
    assert meta["fits_one_card"]
    if arch_name == "whisper-medium":
        if shape_name == "train_4k":
            assert meta["optimizer"] == "adamw" and meta["layout"] == dryrun.LAYOUTS[layout]
        else:
            assert meta["layout"].endswith(dryrun.CACHE_LAYOUTS["cross_head_dim"])
        return
    assert meta["layout"].endswith(dryrun.CACHE_LAYOUTS["context_parallel"])
    assert meta["rows_per_position"] == 1 and meta["attention_kind"] == (
        "full" if arch_name == "rwkv6-7b" else "taco")
    mesh = make_mesh((2, 16, 16) if multi_pod else (16, 16),
                     ("pod", "data", "model") if multi_pod else ("data", "model"),
                     ["meta"] * (512 if multi_pod else 256))
    dp = ("pod", "data") if multi_pod else ("data",)
    arch = dataclasses.replace(dryrun.resolve_arch_for_shape(dryrun.get_arch(arch_name),
                                                             dryrun.SHAPES[shape_name]),
                               param_dtype="bfloat16")
    params = TM.meta_params(arch)
    cache = TM.init_cache(arch, 1, 524288, device="meta")
    want = (SH.position_bytes(params, SHD.param_specs(params, mesh), mesh)
            + SH.position_bytes(cache, SHD.cache_specs(cache, mesh, dp), mesh) + 4 + 4)
    assert meta["argument_size_in_bytes"] == want


@pytest.mark.parametrize("multi_pod", [False, True])
def test_the_other_cells_stay_replicated(multi_pod):
    """No production cell is left replicated any more: every cell of every
    arch runs the tensor_parallel or the expert_parallel layout, and
    whisper's long_500k stays skipped, for the reference's reason."""
    for arch_name in dryrun.ARCHS:
        for shape_name, shape in dryrun.SHAPES.items():
            arch = dryrun.get_arch(arch_name)
            if dryrun.skip_reason(arch, shape):
                assert (arch_name, shape_name) == ("whisper-medium", "long_500k")
                continue
            layout = dryrun.cell_layout(dryrun.resolve_arch_for_shape(arch, shape), shape)
            assert layout in ("tensor_parallel", "expert_parallel"), (arch_name, shape_name)
    meta = dryrun.build_cell("whisper-medium", "long_500k", multi_pod).meta
    assert "skipped" in meta


REF_DRYRUN = ["-m", "repro.launch.dryrun", "--arch", "granite-3-2b", "--shape", "decode_32k"]


def test_decode_cell_beside_the_reference(tmp_path):
    """granite-3-2b x decode_32k: the port's artifact beside the reference's
    (run in a subprocess, as it forces 512 host devices): the same
    param_count, step_kind and n_devices. Under the tensor-parallel layout
    a position holds what a reference device holds, so the argument bytes
    are XLA's exactly (1,671,893,028: the bf16 weights, the cache, the
    tokens and the position, each split by the sanitized specs), and the
    flops, one position's 8 sequences over its sixteenth of the weights and
    of the cache's sequence, are within 0.8-1.25x of the reference's
    per-device flops (the replicated layout's were 14-18x)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, *REF_DRYRUN, "--out", str(tmp_path / "ref")],
                          env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads((tmp_path / "ref" / "granite-3-2b__decode_32k__16_16.json").read_text())
    assert dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                        "--out", str(tmp_path / "port")]) == 0
    got = json.loads((tmp_path / "port" / "granite-3-2b__decode_32k__16_16.json").read_text())
    for key in ("param_count", "step_kind", "n_devices", "arch", "shape", "mesh"):
        assert got[key] == want[key], key
    assert got["param_count"] == 2_635_237_376
    assert got["rows_per_position"] == 8 and got["fits_one_card"]
    assert got["layout_name"] == "tensor_parallel"
    assert (got["argument_size_in_bytes"] == want["memory_analysis"]["argument_size_in_bytes"]
            == 1_671_893_028)
    ratio = got["op_analysis"]["flops"] / want["hlo_analysis"]["flops"]
    assert 0.8 < ratio < 1.25, ratio

"""Dry run of the LM cells (mirrors ``repro.launch.dryrun``): every (arch x
shape) cell's step on ``meta`` tensors over the production mesh, counted per
position by :mod:`repro_torch.launch.op_analysis`, with the bytes a
position holds, written to a JSON artifact.

    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k \\
        [--multi-pod] [--out artifacts/torch_dryrun]
    python -m repro_torch.launch.dryrun --all [--multi-pod]   # every cell

Nothing is allocated and nothing runs on a card. Three layouts, which each
artifact names (``layout_name``, and ``layout`` states it):

  tensor_parallel  the dense decoder stack (starcoder2-3b, granite-3-2b,
           codeqwen1.5-7b, qwen1.5-4b, llava-next-mistral-7b's text stack),
           rwkv6-7b and whisper-medium's encoder-decoder, and
           ``expert_parallel`` the moe family (granite-moe-3b-a800m,
           arctic-480b) and jamba-1.5-large-398b, at every shape (whisper's
           long_500k is skipped, as the reference skips it): the parameters split
           by :mod:`repro_torch.launch.sharding`'s rule table over 'model'
           (Megatron tensor parallelism), AdamW's moments also over the data
           axes (ZeRO-1), the decode cache over 'model' along the sequence;
           the step is :mod:`repro_torch.models.sharded`'s, and the argument
           bytes are :func:`~repro_torch.launch.sharding.position_bytes` of
           the reference's arguments under the sanitized specs.

  train    ``make_sharded_train_step`` over the whole mesh (every data
           block; the float32 reduce-scatter, ZeRO-1 AdamW, the gather);
  prefill  ``sharded_prefill`` of one position's block of rows over its
           row of 'model' positions, without gradients;
  decode   ``sharded_decode_step`` of one position's block of rows on its
           cache, over its row of 'model' positions, without gradients;
           long_500k's one row over every position, its K/V sequence split
           over the data axes and 'model' (context parallelism: each
           position's block of 2,048 or 1,024 slots, the TaCo slot
           selection over the whole sequence repeated at every position,
           the partial softmax sums merged over all of them).

  replicated  no production cell (kept for tests): a position holds its block of the batch,
           B / |dp| rows over the data axes (the whole batch where it does
           not divide, as the reference replicates it), with the whole
           model; the exception is the manual MoE's experts, split over
           ``model``. Every step's MoE takes a position's block as one
           dispatch chunk, and the manual MoE walks the position's (1,
           |model|) slice of the grid (the count's ambient mesh), so flops,
           bytes and argument bytes all describe that one block.

  train    ``make_shardmap_train_step`` over the data axes, uncompressed
           (the reference's GSPMD step sums in float32);
  prefill  ``prefill`` of one position's block, without gradients;
  decode   ``decode_step`` of one position's block on its cache, without
           gradients.

Prefill and decode have no position loop of their own: they run one
position's block, placed at data index 0. Each step's walks trace one
representative position of each class of equal ones
(``represented_positions`` counts the others; see
:func:`repro_torch.mesh.walk`), and a Mamba scan traces its first step
(with gradients, also each signature's backward once;
``represented_steps``, :func:`repro_torch.mesh.scan`). A kernel's work is
counted as its plain version's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Callable

import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch, input_specs, skip_reason
from repro_torch.configs.shapes import resolve_arch_for_shape
from repro_torch.launch import sharding as SH
from repro_torch.launch.dryrun_ann import CARD_BYTES
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.mesh import P, DeviceMesh, axis_size, position_slice, set_mesh, tensor_bytes
from repro_torch.models import sharded as SHD
from repro_torch.models.model import (
    decode_step,
    init_params,
    map_tree,
    meta_params,
    prefill,
    tree_leaves,
)
from repro_torch.optim import adafactor, adamw, warmup_cosine
from repro_torch.train.loop import TrainState, make_sharded_train_step, make_shardmap_train_step
from repro_torch.utils import tree_flatten

LAYOUTS = {
    "replicated": (
        "a position holds B/|dp| rows of the batch over the data axes (all B where they do "
        "not divide) and the whole model, the manual MoE's experts split over 'model'; each "
        "step's MoE takes a position's block as one dispatch chunk, the manual MoE over the "
        "position's (1, |model|) slice of the grid; no parameter split, no ZeRO-1; kernels "
        "counted as their plain versions"),
    "tensor_parallel": (
        "parameters split over 'model' by launch.sharding's rule table (column-parallel "
        "wq/wk/wv/gate/up/fc, row-parallel wo/down/proj, the embedding over its vocabulary, "
        "lm_head over its columns; norms replicated), AdamW's moments also over the data "
        "axes (ZeRO-1); the train step runs every data block (B/|dp| rows) over its row of "
        "'model' positions, its vocab-parallel loss never gathering the logits, the "
        "gradients reduce-scattered in float32, AdamW on each slice, the slices gathered; "
        "prefill and decode run one position's block of rows over its row of 'model' "
        "positions, the cache split over 'model' along the sequence (decode gathers q, "
        "attends over its block of the sequence for every head and merges by log-sum-exp); "
        "row-parallel partial sums added in float32 and cast once; where the heads do not "
        "divide |model|, whole heads gathered before the attention core and the output "
        "gathered again for wo; RWKV6's time mix over whole heads (wr/wk/wv/wg column "
        "blocks, u over its heads, each position's columns of the decay from its slice of "
        "w0 and w_lora_b, the WKV over its heads, ln_x's sum of squares all-reduced over "
        "'model' before each position scales its block, wo row blocks) and its channel mix "
        "(wk columns, wv rows, r's column blocks gathered), the WKV state split over the "
        "heads and the token shifts replicated; whisper's encoder layers split as the "
        "decoder's (non-causal), its output replicated over 'model' (the gradient summed), "
        "cross-attention's wq columns over the decoder's h and wk/wv columns over the "
        "encoder's output, wo row blocks; kernels counted as their plain versions"),
}
#: what a cell's ``layout`` text adds where its cache is not split along the
#: sequence over 'model' alone
CACHE_LAYOUTS = {
    "cross_frames": (
        "; the cross cache split over 'model' along the encoder's frames (prefill writes it "
        "by an all-to-all from the head split; decode merges the positions' partial softmax "
        "sums over their frames by log-sum-exp)"),
    "cross_head_dim": (
        "; the cross cache split over 'model' along head_dim, where |model| does not divide "
        "the encoder's frames (prefill writes it by an all-to-all from the head split; "
        "decode sums the positions' partial q.k over their head_dim slices in float32 into "
        "the whole scores, takes the softmax once and gathers each position's head_dim "
        "slice of probs.v)"),
    "context_parallel": (
        "; context parallelism: the one row's K/V sequence split over the data axes and "
        "'model', every position serving the row (the projections over 'model' once for all "
        "data positions; TaCo's mean, basis and centroids gathered whole, its cells "
        "replicated and the slot selection over the whole sequence done at every position; "
        "each position attends over the selected slots in its block, one holding none "
        "adding nothing, and the partial softmax sums merged over all positions)"),
}
LAYOUTS["expert_parallel"] = (
    "the tensor_parallel layout for the attention, a dense residual MLP, the embedding and "
    "the head, and the experts over 'model' as the sanitized specs split them: whole "
    "experts where the count divides |model| (gate/up/down over their expert axis; each "
    "position dispatches its block's tokens to its E/|model| experts at the global count's "
    "capacity, the partial outputs summed), else the expert FFN width (gate/up over their "
    "columns, down over its output columns; the (E, cap, D) buffer built once a block, the "
    "hidden columns gathered, each position's output columns combined by the gates and "
    "gathered); the router replicated, a data block's routing computed once and one "
    "dispatch chunk; the aux loss over the whole batch for moe_impl 'gspmd' (the blocks' "
    "token counts and router probability sums all-reduced over the data axes) or the mean "
    "of the blocks' for 'manual'; Adafactor's factored moments split as their parameter "
    "(vr without its last entry, vc without its second-to-last; no ZeRO-1), its row, "
    "column and RMS means' partial sums all-reduced over 'model'; the hybrid stack's Mamba "
    "mixers over their inner channels (in_proj's contiguous column blocks re-split to each "
    "position's x and z channels by an all-to-all, the causal conv and the selective scan "
    "local, x_proj's row-parallel partial sums all-reduced so that every position has the "
    "whole dt, B and C, dt_proj columns, out_proj rows; the conv window and h split over "
    "the inner channels); kernels counted as their plain versions")
#: the cells the tensor-parallel layout covers (the dense stack's, RWKV6's
#: and the enc-dec stack's) and the expert-parallel one (the moe family's
#: and the hybrid Mamba stack's)
TP_FAMILIES = ("dense", "vlm", "ssm", "audio")
EP_FAMILIES = ("moe", "hybrid")
TP_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def pick_optimizer(arch):
    n_approx = arch.n_layers * arch.d_model * arch.d_ff * (
        3 * max(arch.n_experts, 1)
    )
    return (adafactor(), "adafactor") if n_approx > 1e11 else (adamw(), "adamw")


def sharded_arch(arch, multi_pod: bool):
    """The reference's ``sharded_arch`` (dryrun.py:73-91) in the port's
    fields: the manual MoE where the expert count divides by 16, its batch
    split over the data axes. The reference dispatches the global batch in
    one chunk a DP shard; a step here runs one shard's block, so that block
    is one chunk."""
    manual = bool(arch.n_experts) and arch.n_experts % 16 == 0
    return dataclasses.replace(
        arch,
        moe_dispatch_chunks=1,
        moe_impl="manual" if manual else "gspmd",
        moe_dp_axes=dp_axes(multi_pod),
    )


def _param_bytes(tree, arch, ep: int, experts: bool = False) -> int:
    """Parameter bytes at one position: every leaf whole, the manual MoE's
    expert weights (gate, up, down under each ``moe``) an ``ep``-th."""
    if not isinstance(tree, dict):
        return tensor_bytes(tree)
    total = 0
    for key, sub in tree.items():
        if experts and key in ("gate", "up", "down"):
            total += tensor_bytes(sub) // ep
        else:
            total += _param_bytes(sub, arch, ep, key == "moe" and arch.moe_impl == "manual")
    return total


def _placed(tree, device):
    """A tree of meta tensors as zeros on ``device`` (itself on meta)."""
    if torch.device(device).type == "meta":
        return tree
    return map_tree(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), tree)


@dataclasses.dataclass
class Cell:
    """One cell's step, built and not run: ``run()`` runs it once over
    ``mesh`` (data axes ``dp``); ``meta`` holds the layout, the optimizer,
    the rows a position runs and the argument bytes. ``run`` is None where
    the cell is skipped (``meta["skipped"]`` says why)."""
    run: Callable[[], object] | None
    mesh: DeviceMesh | None
    dp: tuple
    meta: dict


def count_cell(arch_name: str, shape_name: str, multi_pod: bool, *, mesh=None, arch=None,
               device="meta"):
    """(per-position analysis, meta) of one cell (:func:`build_cell`), or
    (None, {"skipped": why})."""
    cell = build_cell(arch_name, shape_name, multi_pod, mesh=mesh, arch=arch, device=device)
    if cell.run is None:
        return None, cell.meta
    # the ambient mesh, which the manual MoE walks: a position's slice; in
    # the train step each data shard's walk places it at the shard's
    # coordinates (repro_torch.mesh.position: the enclosing axes win)
    with (set_mesh(position_slice(cell.mesh, cell.dp)),
          OpCounter(cell.mesh, represent=True) as counter):
        cell.run()
    cell.meta["represented_positions"] = counter.represented
    cell.meta["represented_steps"] = counter.represented_steps
    return counter.analysis(), cell.meta


def build_cell(arch_name: str, shape_name: str, multi_pod: bool, *, mesh=None, arch=None,
               device="meta") -> Cell:
    """One cell's step and its meta, not run. ``mesh`` defaults to the
    production mesh of ``device`` positions (meta: nothing allocated),
    ``arch`` to the registry's config of ``arch_name``. On another device
    the same step runs on seeded parameters and zero inputs of the same
    shapes, for a count to hold the meta one against."""
    n_dev = 512 if multi_pod else 256
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, devices=[device] * n_dev)
    dp = dp_axes(multi_pod)
    n_dp, ep = axis_size(mesh, dp), axis_size(mesh, "model")
    shape = SHAPES[shape_name]
    arch = get_arch(arch_name) if arch is None else arch
    reason = skip_reason(arch, shape)
    if reason:
        return Cell(None, None, dp, {"skipped": reason})
    arch = sharded_arch(resolve_arch_for_shape(arch, shape), multi_pod)
    if shape.kind in ("decode", "prefill"):
        # inference serves bf16 weights, as the reference's dry run does
        arch = dataclasses.replace(arch, param_dtype="bfloat16")
    params = (meta_params(arch) if torch.device(device).type == "meta" else
              init_params(torch.Generator(device).manual_seed(0), arch, device=device))
    layout = cell_layout(arch, shape)
    meta = {
        "arch": arch_name, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "n_devices": mesh.size,
        "param_count": int(sum(t.numel() for t in tree_leaves(params))),
        "attention_kind": arch.attention_kind, "moe_impl": arch.moe_impl if arch.n_experts
        else None, "layout_name": layout, "layout": LAYOUTS[layout],
        "counter": f"repro_torch.launch.op_analysis ({torch.device(device).type} tensors)",
    }
    if layout != "replicated":
        meta["heads"] = SHD.HeadPlan(ep, arch.n_heads, arch.n_kv_heads).describe()
        cache = cache_layout(arch, shape, mesh, dp)
        if cache:
            meta["layout"] += CACHE_LAYOUTS[cache]
        if arch.n_experts:
            meta["experts"] = (f"whole experts, {arch.n_experts // ep} a position"
                               if arch.n_experts % ep == 0 else
                               "the expert FFN width: gate/up columns, down output columns")
        run, arg_bytes, block = _tensor_parallel_step(arch, shape, params, mesh, dp, device,
                                                      meta)
        return _built(run, mesh, dp, meta, arg_bytes, block)
    arg_bytes = _param_bytes(params, arch, ep)
    # the step's inputs are made before the counter starts: what it counts
    # is the step alone, as the reference lowers the step over given inputs
    if shape.kind == "train":
        opt, opt_name = pick_optimizer(arch)
        state = TrainState(params=params, opt_state=opt[0](params),
                           step=torch.zeros((), dtype=torch.int32))
        batch = _placed(input_specs(arch, shape), device)
        block = shape.global_batch // n_dp
        arg_bytes += sum(tensor_bytes(t) for t in tree_flatten(state.opt_state)[0])
        arg_bytes += sum(tensor_bytes(t[:block]) for t in batch.values())
        meta.update(optimizer=opt_name, step_kind="train_step")
        step = make_shardmap_train_step(arch, opt, warmup_cosine(3e-4, 100, 10000), mesh,
                                        data_axes=dp, compress_grads=False, impl="torch")

        def run():
            step(state, batch)
    else:
        b = shape.global_batch
        block = b // n_dp if b % n_dp == 0 else b
        specs = _placed(input_specs(arch, shape, batch_override=block), device)
        if shape.kind == "prefill":
            meta["step_kind"] = "prefill"
            arg_bytes += sum(tensor_bytes(t) for t in specs.values())

            def run():
                with torch.no_grad():
                    prefill(params, arch, specs, shape.seq_len, impl="torch")
        else:
            meta["step_kind"] = "serve_step"
            arg_bytes += tensor_bytes(specs["tokens"], specs["pos"])
            arg_bytes += sum(tensor_bytes(t) for t in tree_leaves(specs["cache"]))

            def run():
                with torch.no_grad():
                    decode_step(params, arch, specs["cache"], specs["tokens"],
                                shape.seq_len - 1)
    return _built(run, mesh, dp, meta, arg_bytes, block)


def _built(run, mesh, dp, meta: dict, arg_bytes: int, block: int) -> Cell:
    meta["rows_per_position"] = block
    meta["argument_size_in_bytes"] = arg_bytes
    meta["fits_one_card"] = arg_bytes <= CARD_BYTES
    return Cell(run, mesh, dp, meta)


def cell_layout(arch, shape) -> str:
    """The cell's layout: ``tensor_parallel`` for the dense stack, RWKV6
    and the enc-dec stack, ``expert_parallel`` for the moe family and the
    hybrid Mamba stack (jamba), at every shape; ``replicated`` for none of
    the registry's cells (tests narrow these tables to reach it)."""
    if shape.name in TP_SHAPES and arch.family in TP_FAMILIES:
        return "tensor_parallel"
    if shape.name in TP_SHAPES and arch.family in EP_FAMILIES:
        return "expert_parallel"
    return "replicated"


def cache_layout(arch, shape, mesh: DeviceMesh, dp) -> str | None:
    """Which of :data:`CACHE_LAYOUTS` a tensor- or expert-parallel cell's
    cache has (None: K/V along the sequence over 'model' alone, or no
    cache): a one-row decode the data positions cannot split is context
    parallel; an enc-dec config's cross cache is split along the frames
    where |model| divides them, else along head_dim."""
    if shape.kind == "decode" and shape.global_batch < axis_size(mesh, dp):
        return "context_parallel"
    if arch.encoder_layers and shape.kind != "train":
        return ("cross_frames" if (arch.frontend_len or 1500) % axis_size(mesh, "model") == 0
                else "cross_head_dim")
    return None


def _tensor_parallel_step(arch, shape, params, mesh: DeviceMesh, dp, device, meta: dict):
    """(run, argument bytes, rows a position runs) of a tensor- or
    expert-parallel cell. The argument bytes are the reference's arguments
    (its train state, under the optimizer ``pick_optimizer`` picks, and
    batch; or its parameters and batch; or its parameters, cache, tokens
    and position) at one position under the sanitized specs."""
    n_dp = axis_size(mesh, dp)
    inputs = input_specs(arch, shape)
    pspecs = SH.sanitize_specs(params, SH.param_pspecs(params), mesh)
    if shape.kind == "train":
        opt, opt_name = pick_optimizer(arch)
        state = TrainState(params=params, opt_state=opt[0](params),
                           step=torch.zeros((), dtype=torch.int32))
        specs = SH.sanitize_specs(state, SH.train_state_pspecs(state, dp, mesh), mesh)
        bspecs = SH.sanitize_specs(inputs, SH.batch_pspecs(inputs, dp), mesh)
        arg_bytes = (SH.position_bytes(state, specs, mesh)
                     + SH.position_bytes(inputs, bspecs, mesh))
        placed = SHD.place_train_state(state, mesh, dp)
        del state
        batch = _placed(inputs, device)
        meta.update(optimizer=opt_name, step_kind="train_step")
        step = make_sharded_train_step(arch, opt, warmup_cosine(3e-4, 100, 10000), mesh,
                                       data_axes=dp, impl="torch")
        return (lambda: step(placed, batch)), arg_bytes, shape.global_batch // n_dp
    # inference: one position's block of rows over its row of 'model' positions
    row = position_slice(mesh, dp)
    placed = SHD.place(params, pspecs, mesh)
    block = shape.global_batch // n_dp
    specs = input_specs(arch, shape, batch_override=block)
    if shape.kind == "prefill":
        specs = _placed(specs, device)
        meta["step_kind"] = "prefill"
        bspecs = SH.sanitize_specs(inputs, SH.batch_pspecs(inputs, dp), mesh)
        arg_bytes = (SH.position_bytes(params, pspecs, mesh)
                     + SH.position_bytes(inputs, bspecs, mesh))

        def run():
            SHD.sharded_prefill(placed, arch, specs, shape.seq_len, row, data_axes=dp,
                                impl="torch")
        return run, arg_bytes, block
    meta["step_kind"] = "serve_step"
    if shape.global_batch < n_dp:
        # a one-row batch: every position serves it, its K/V over the data
        # axes and 'model' (context parallelism)
        row, block = mesh, shape.global_batch
    cspecs = SH.sanitize_specs(inputs["cache"], SH.cache_pspecs(inputs["cache"], dp), mesh)
    tspec = SH.sanitize_specs(inputs["tokens"], P(dp, None), mesh)
    arg_bytes = (SH.position_bytes(params, pspecs, mesh)
                 + SH.position_bytes(inputs["cache"], cspecs, mesh)
                 + SH.position_bytes(inputs["tokens"], tspec, mesh)
                 + tensor_bytes(inputs["pos"]))
    cache = SHD.sharded_init_cache(arch, block, shape.seq_len, row, data_axes=dp,
                                   device="meta" if torch.device(device).type == "meta"
                                   else None)
    specs = {"tokens": _placed(input_specs(arch, shape, batch_override=block)["tokens"],
                               device)}

    def run():
        SHD.sharded_decode_step(placed, arch, cache, specs["tokens"], shape.seq_len - 1, row,
                                data_axes=dp)
    return run, arg_bytes, block


def run_cell(arch_name: str, shape_name: str, multi_pod: bool, out_dir: str) -> dict:
    t0 = time.perf_counter()
    mesh_name = "2x16x16" if multi_pod else "16x16"
    try:
        h, meta = count_cell(arch_name, shape_name, multi_pod)
    except Exception as e:  # recorded in the artifact, as the reference records its errors
        return {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
                "error": f"count: {type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}
    if h is None:
        return meta | {"arch": arch_name, "shape": shape_name, "mesh": mesh_name}
    meta["compile_s"] = round(time.perf_counter() - t0, 2)
    meta["memory_analysis"] = {"argument_size_in_bytes": meta["argument_size_in_bytes"]}
    meta["cost_analysis"] = {"flops": float(h["flops"]), "bytes accessed": float(h["bytes"])}
    meta["op_analysis"] = h
    meta["collectives"] = {**h["collective_bytes"], "counts": h["collective_counts"],
                           "total": h["collective_total"]}
    print(f"[{arch_name} x {shape_name} x {mesh_name}] memory_analysis:",
          meta["memory_analysis"], "fits_one_card:", meta["fits_one_card"])
    print(f"[{arch_name} x {shape_name} x {mesh_name}] cost_analysis:", meta["cost_analysis"])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch_name}__{shape_name}__{mesh_name.replace('x', '_')}"
        with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
            json.dump(meta, f, indent=1)
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/torch_dryrun")
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")

    cells = ([(a, s) for a in ARCHS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    failures = 0
    for arch_name, shape_name in cells:
        r = run_cell(arch_name, shape_name, args.multi_pod, args.out)
        status = ("SKIP: " + r["skipped"][:60]) if "skipped" in r else (
            "FAIL: " + r["error"][:120] if "error" in r else
            f"ok meta={r['compile_s']}s flops={r['op_analysis']['flops']:.3e} "
            f"bytes={r['op_analysis']['bytes']:.3e} coll={r['collectives']['total']:.3e}B "
            f"args={r['argument_size_in_bytes']:.3e}B fits_one_card={r['fits_one_card']}"
        )
        print(f"{arch_name:24s} {shape_name:12s} {r.get('mesh', '')}  {status}", flush=True)
        failures += 1 if "error" in r else 0
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of TaCo on one NVIDIA card.

    python3 chip_smoke.py            # full size: 10^6 x 128 corpus, 1000 queries

Phases, in order; any failure exits nonzero:
  1. device  — require CUDA, print the card's name and power limit;
  2. build   — compile the seven kernels (one nvcc per source, in parallel);
  3. kernels — hold each ANN kernel against its plain PyTorch version on the
               card at the main path's shapes and at a ragged shape, on
               integer inputs (bitwise) and float inputs (stated tolerances),
               and time kernel, plain version and one library call beside the
               bound; the batched l2dist (a batch's 12 (subspace, half)
               pairs in one launch) must equal one single-pair launch per
               pair bit for bit on float inputs, and is timed beside those
               12 launches; so is the batched kmeans_assign (a build's 12
               pairs in one launch) at TaCo's halves of 4 and SuCo's of
               10/11, 11/12 padded to 12, also bitwise against its plain
               version on integer inputs; schist is also held against its
               plain version on the card tests' shapes, and its launch
               geometry (tiles a block) is kept in chip_smoke.json;
               masked_rerank's launch geometry and resident warps per SM
               are printed at k = 10 and 100, and its ptxas report (kept in
               chip_smoke.json) must show no spills; masked_rerank with a
               tombstone bitmap (10 % excluded, integer inputs, bitwise; 1 %
               at the main path's shapes, timed beside the kernel without
               one) must equal its plain version and return no excluded
               point; l2dist, schist, scscore and masked_rerank (k = 10 and
               100) are also held against their plain versions at every
               bucket the serving engine pads a batch to (1 to 256 queries)
               over the 10^6 points, and timed at the bucket of 64; the
               sort activation kernel at the benchmark's batches (N_s, Q,
               sqrt_k) = (6, 10240, 32), (6, 1024, 32) and (20, 1024, 64),
               tau and retrieved bit for bit against its plain version;
  3b. autotune — the kernel autotuner (repro_torch.kernels.autotune) on
               the card: schist and masked_rerank searched over their eight
               (bq, bn) candidates each (about 10 s of budget an op) on the
               reference's synthetic problem over 10^6 x 128 points, N_s 6,
               K 1024, at 1000 queries (schist; masked_rerank at k = 100,
               then k = 10, which owns the entry: the key has no k) and at
               the engine's bucket of 64 (k = 10); each trial table printed
               with its launch geometry; every candidate's output bit for
               bit the default's (the search raises otherwise), the winner's
               against the plain version; the winners saved with
               save_cache to a temporary file; after the masked phase, the
               masked-full batch through searchers warm-loaded from that
               file (autotune_entries_loaded = the file's entries, the last
               launches' (bq, bn) the winners, ids and dists bit for bit the
               untuned searchers', both timed, median of 3), and in the
               serve phase the launcher's recovery once more with
               --autotune-cache (MATCH, the entries in its report, its last
               launches at the bucket-64 winners);
  4. flash   — ops.flash_attention at the attention widths of granite-3-2b
               (32 heads of 64, causal, bf16 and f32) and qwen1.5-4b (20
               heads of 128, causal, bf16 and f32), S = T = 4096, plus a
               ragged non-causal case; each held against the plain version
               (bf16 also against the plain version in f32) and timed beside
               its bound and scaled_dot_product_attention; the kernel's
               ptxas report (kept in chip_smoke.json) must show no spills;
  5. masked  — build a TaCo index over a SIFT1M-shaped corpus on the card with
               use_kernels=True (its k-means in lockstep over all 12 (subspace,
               half) pairs) under torch.profiler (host clock, device busy
               time, top device and host operations), time one more build
               without it, and answer 1000 queries (padded to the 1024
               bucket by the searcher) at k = 10 and 100 in both selection
               modes with rerank="masked_full"; recall@10 is checked against
               brute force and against the plain path on the same index; a
               SuCo index over an integer-valued 10^5 x 128 corpus must equal
               one k-means per (subspace, half) on the card bit for bit;
  6. gather  — the same index with the default rerank="gather" at k = 10 and
               100 in both selection modes, and a SuCo index (linear
               activation, fixed selection) built at full width; each run is
               held against the plain path, the query-aware runs also against
               masked-full; heap and linear activation against sort on the
               first 100 queries;
  6b. baselines — the paper's baselines on the same corpus, queries and
               ground truth: IVF-Flat built on the card (1024 lists, 10 Lloyd
               iterations: 11 kmeans_assign launches through its tiled path;
               build seconds, Lmax, index_bytes), queried at nprobe 16 and 64
               (QPS median of 3, recall@10 rising with nprobe), SC-Linear at
               the SuCo config (QPS, recall@10 beside TaCo's and SuCo's), and
               an integer-valued IVF build (10^5 x 128, 1024 lists, means
               rounded each update) bit for bit against the plain path; the
               kernels phase also holds kmeans_assign at IVF's shape (10^6 x
               128 against 1024 centroids: the TF32 screen and exact
               rechecks, rechecks a point printed) against its plain version;
  6c. wide  — every shape past the kernels' former limits, at full size:
               a 960-dim corpus (gmm_dataset(10^6 + 1000, 960), GIST1M's
               width, split as the main corpus; the exact top-10 on the
               card): IVF-Flat at 1024 lists (the build's 11 kmeans_assign
               launches all through the wide tiled path, queries at nprobe
               16 and 64, one assignment against the plain version: >= 99.9
               % equal, distances allclose, rechecks a point, timed beside
               cdist and three bounds; an integer 10^5 x 960 build bit for
               bit against the plain path); TaCo over all 960 dims (N_s 20,
               s 48, K 4096: a tile's table 320 KB, past shared memory),
               masked-full and gather at k = 10 in both selection modes
               against the plain path (recall@10 within 0.005, ids >= 99.9
               %), schist, scscore and masked_rerank launched with the table
               in global memory and held against their plain versions on
               the path's own batch; the collision kernels at N_s = 127 (K
               1024, 10^6 points, 1000 queries; bits and cells from the
               seed), schist and scscore bit for bit, masked_rerank ids >=
               99.9 %; masked_rerank at k = 1025, 2048 and 8192 on the main
               index (beta 0.01) in both selections against the plain path,
               and at k = 8192 with a 1 % tombstone bitmap; each kernel's ms
               beside its plain version and bound ("wide ..." and "kernel
               ... wide" lines; the kernels line lists these shapes under
               each kernel's "shapes");
  7. persist — AnnIndex.save of the TaCo and the SuCo index to a temporary
               directory, AnnIndex.load on the card: every array bitwise equal,
               and masked-full and gather ids and dists of one batch bitwise
               equal to the in-memory index's; a repeated batch hits the
               searcher's cache;
  8. mutable — the TaCo index as the base of a MutableAnnIndex: delete
               10,000 base ids (among them the exact top-10 of the first 100
               queries), insert 4,000 rows (50 exact copies of live base
               rows), delete 1,000 of them (rows/s of each); 1000 queries at
               k = 10 and 100, query-aware, masked-full (the tombstones
               excluded in masked_rerank) and gather (the reference's
               over-fetch), each batch held against the plain path on the
               same state (ids >= 99.9 %, recall@10 against brute force over
               the live corpus within 0.005, no deleted id returned) and
               timed beside the immutable index; the delta scan's device ms;
               durability="sync": fsync'd append latency, checkpoint(), more
               mutations, MutableAnnIndex.load(path, wal_dir=...) bitwise
               equal in state and results; compact() (a 10^6-row rebuild on
               the card) against a rebuild oracle (every array bit for bit,
               ids >= 99.9 %, recall within 0.005), and bit for bit in
               arrays and results on an integer-valued 10^5 x 128 SuCo
               corpus;
  9. engine  — the same index served through index.engine (default gather,
               every third request k = 5, every third beta x 2, every fourth
               masked-full, one request a held-out query): synchronous at
               max_batch 64 and 256 (ids against a direct search of each
               request's group >= 99.9 %, recall@10 within 0.005 of it, every
               request answered once, one l2dist a batch, one schist and one
               masked_rerank a masked-full batch, one scscore a gather batch,
               batches and compiles per bucket as the groups predict); the
               stream again through the result cache (every request a hit,
               no kernel launched); async with four producers and a 50 ms
               deadline (ids against the sync run >= 99.9 %, none lost or
               duplicated), then admission control (AdmissionErrors seen =
               telemetry's shed); a MutableAnnIndex served async while churn
               waves and two background compactions swap into the engine (a
               batch after the swap equals mutable.search bit for bit, no
               deleted id, probe recall within 0.01 of brute force over the
               live corpus); one engine batch of 64 of each pipeline under
               torch.profiler; host seconds of each step are printed;
 10. sharded — the same index placed as 4 shard views on the card
               (index.searcher("sharded", shards=4)): each shard's data and
               norms share the index's storage, the placement's memory
               growth is printed; schist, scscore and masked_rerank (k = 10
               and 100) held against their plain versions on one shard
               (250,000 points) at the main path's inputs; 1000 queries at k
               = 10 and 100, both selections, both pipelines, beside the
               single-device searcher in the same call (median of 3 each):
               no shard truncated on masked-full, query-aware gather bit
               for bit where neither placement truncates (the one-device
               cap truncates ~4 % too), masked-full ids >= 99.9 %
               and dists within masked_rerank's tolerance (its shards pick
               by the norm-form distance, the combine orders by the exact
               one), recall@10 within 0.005 where not bitwise, the
               query-aware shards' candidates summing to the single-device
               demand, exact launches a batch (l2dist once; schist and
               masked_rerank, or scscore, once a shard), one profiled batch
               of each pipeline on each placement; the engine phase's stream
               through index.engine("sharded", shards=4) at max_batch 64
               beside a single-device engine (untruncated requests: ids
               >= 99.9 %, dists within masked_rerank's tolerance, the share
               bit for bit recorded; shards and combine pairs in the
               telemetry); serve_ann --shards 4 in process on a save (256
               mixed gather requests);
               the distributed covariance, one Lloyd step and the cell sizes
               over 4 row shards against single-device;
 11. serve   — python -m repro_torch.launch.serve_ann in a child process at
               10^6 x 128: async, four producers, a 50 ms deadline, churn
               with a durable WAL and compactions swapped into the engine,
               recall probes, masked-full, a mutable save; then a restart
               from the save that replays the WAL and verifies recovery
               (post-compaction bitwise MATCH); then the engine phase's index
               saved with use_kernels off (the default config), which the
               launcher must serve through the gather path's kernels; each
               must exit 0, print its telemetry and launch the path's
               kernels in its process;
 12. lm      — the LM side at granite-3-2b's full width (40 layers, d_model
               2048, 32 heads of 64, 8 KV heads, vocab 49155; ~2.6 B float32
               parameters from a seeded generator on the card), once the ANN
               index is freed: python -m repro_torch.launch.serve's main in
               process (8 requests, 16 new tokens, 4 slots, max_seq 256,
               bf16; served tokens, tok/s, one flash launch a layer a
               prefill, prefill and decode-step ms from CUDA events);
               forward over 4096 tokens through the flash kernel in float32
               and bf16 against the plain path (impl="torch") on the same
               weights (float32 within 1e-3, top-1 on >= 99 % of positions;
               bf16 top-1 >= 95 %), the first layer's kernel call against
               the plain flash version (bf16 also within 2^-7|x| + 4e-5 of
               it in f32), timed beside the plain path and beside
               scaled_dot_product_attention put in the kernel's place; TaCo
               retrieval decode with the default RetrievalConfig, 16
               teacher-forced steps after a 4096-token prefill beside full
               attention (mean TVD, argmax agreement, step ms), the
               retrieval build's ms for one layer, and float32 decode
               retrieving every slot within 1e-3 of full decode;
 13. train   — LM training once the lm phase's parameters are freed:
               granite-3-2b at full width (f32 parameters, bf16 compute, remat,
               AdamW, warmup_cosine, batch 8 x 128) for 4 steps (finite loss
               and grad norm, step ms from CUDA events, tok/s, peak memory,
               flash launched exactly twice a layer a step: forward and the
               remat recompute; one profiled step by kind of kernel); one
               step's gradients at 2 layers in f32 through the kernel
               against the plain path, every attention weight with a
               gradient; the smoke config through launch.train.main: 60
               steps with 2 microbatches (the loss falls), 6 straight against
               3 + checkpoint + --resume 3 (1e-4), one Adafactor step;
 14. families — the moe, ssm, hybrid, audio and vlm configs at full width,
               one at a time, weights from a seeded generator on the card:
               granite-moe-3b-a800m (launch.serve.main in process, 8 x 16
               tokens on 4 slots; a 2048-token forward in f32 and bf16
               through the kernel against the plain path under the lm
               gates, the f32 one allowing for tokens a router near-tie
               sends elsewhere; the share of assignments capacity drops at
               that prefill and at a 4-slot decode step, cap 1 there; one
               layer's dispatch and expert products timed apart);
               rwkv6-7b (served the same way, no flash; a 2048-token
               prefill on the chunked WKV path against the sequential one
               in f32, logits within 1e-3 and each layer's state within
               1e-3 of its largest entry; one layer's time mix on each path
               timed); whisper-medium (B 2 over 1500 stub frames, a 16-token
               prompt, 16 teacher-forced steps; exactly 72 flash launches a
               prefill; f32 forward against the plain path and decode
               against forward within 1e-3; in bf16 the encoder's,
               decoder's and cross-attention's first calls held against the
               plain flash version and timed beside it and SDPA);
               llava-next-mistral-7b (576 patch embeddings before a 64-token
               prompt, 8 steps, held as whisper); arctic-480b cut to 1
               layer and jamba-1.5-large-398b cut to one group of 8 layers
               and 4 of its 16 experts (each cut printed on a ``families:
               cut:`` line; bf16 forward over 512 tokens against the plain
               path, top-1 >= 95 %; prefill + 4 steps; drop shares; jamba's
               Mamba layer and its sequential scan timed);
 15. parallel — data and expert parallelism over named grids of views of
               the card (repro_torch.mesh), once the families are freed:
               make_shardmap_train_step at granite-3-2b's full width and
               depth over 2 data shards (batch 8 x 128, AdamW, remat), 3
               steps uncompressed held against make_train_step with 2
               microbatches from the same seeded state (bitwise where the
               card's gradients repeat, else loss, grad norm and each
               leaf's update within 1e-4), 3 steps int8-compressed with
               every gradient element within half a quantum of the
               uncompressed mean and the parameters' drift printed, one
               single-device step, step ms of each, the payload bytes of
               a step's sum; granite-moe-3b-a800m at full width over a
               (data 2, model 4) grid with moe_impl="manual" and 2
               dispatch chunks against moe_impl="gspmd" at 2 chunks, the
               manual run's routing pinned to the gspmd run's: forward over
               2 x 1024 tokens and prefill + 4 decode steps at 2 slots in
               f32 (logits within 1e-4, >= 99.9 % of the token-layers
               routed alike on their own) and bf16 (the lm phase's top-1
               and distance gates), a 1-row prefill + decode that falls
               back to moe_apply in every call, one MoE layer on one input
               (the kept sets bit for bit in f32 and bf16) timed under each
               implementation, drop share, both aux losses, the combine's
               bytes; the production mesh's
               (16, 16) and (2, 16, 16) grids over repeats of the card
               (shape and dp axes only);
 16. dryrun  — the dry runs (repro_torch.launch.dryrun_ann, dryrun) held to
               the card: launch.op_analysis counts the distributed build
               covariance and both query pipelines at 2^22 x 128 f32 over a
               (4, 4) grid of the card, four decode_32k steps at one
               position's block (8 sequences, a 32,768 cache, bf16
               weights): granite-3-2b's in the tensor-parallel
               layout (the sharded decode step over the position's row of
               16 'model' positions, each its sixteenth of the weights and
               of the cache's sequence), granite-moe-3b-a800m's in the
               expert-parallel layout (its 40 experts' FFN width split over
               16), rwkv6-7b's in the tensor-parallel layout (its 64
               heads split, 4 a position, the WKV state over the heads) and
               whisper-medium's in the tensor-parallel layout (its cross
               cache along head_dim), and granite-3-2b's long_500k TaCo
               decode step context-parallel (one row over all 256
               positions of the 16 x 16 mesh, each its block of 2,048 of
               the 524,288 slots), on the card and on meta tensors of the same shapes
               by the same code, the plain path on both sides: flops, bytes,
               payloads and argument bytes equal exactly; then the dry runs
               in child processes at once (dryrun_ann at n = 10^9 on both
               meshes, gather and masked_full; dryrun at granite-3-2b's
               train_4k, prefill_32k and decode_32k on the single-pod mesh
               and arctic-480b's decode_32k on the multi-pod mesh, whose
               manual MoE splits the batch over ("pod", "data")), each
               exiting 0 with its artifact (chiprun_out/dryrun/), per job
               flops, bytes, payload, argument bytes, fits_one_card and
               seconds printed; no kernel is launched;
 17. tensor_parallel — granite-3-2b at full width and depth over a (data
               2, model 4) grid of views of the card (repro_torch.models.
               sharded: Megatron splits over 'model', ZeRO-1 AdamW over
               'data'): make_sharded_train_step, batch 8 x 128, bf16
               compute, 3 steps timed with CUDA events beside
               make_train_step's in the same call, peak memory, the first
               step's payload bytes by kind (equal to the same step's count
               on meta tensors); the same step at 4 layers in
               float32 against make_train_step for 2 steps (loss and grad
               norm within 1e-4 relative, every parameter within 1e-5 of its
               norm); sharded_prefill of 2 x 4096 tokens, one sequence a
               data block, and 16 sharded decode steps on the sequence-split
               cache against prefill and decode_step on one device, in
               float32 (within 1e-3, top-1 >= 99 %) and bf16 (the lm phase's
               top-1 and distance gates), timed beside them; each new flash
               shape's first call held against the plain version;
 18. expert_parallel — the moe family over grids of views of the card
               (repro_torch.models.sharded's MoE sub-layer): granite-moe-
               3b-a800m's bf16 weights at full width, 16 of 32 layers (the
               script's time since phase 20), prefill of
               2 x 1024 and 8 decode steps over (data 1, model 16) (the
               expert FFN width split) and (2, 4) (whole experts, 10 a
               position) against one device's bf16 and f32-compute runs
               (top-1 and distance gates of the lm phase); its sharded
               train step at 16 of 32 layers over (2, 4), 2 steps beside
               make_train_step's, the first step's payloads equal to the
               meta count; the f32 held check at 4 layers with the one
               device's routing pinned to the sharded run's (loss, grad
               norm, aux within 1e-4 relative, every parameter within 1e-5
               of its norm); arctic-480b at full width, 1 layer, over (2, 4)
               (32 experts a position, the manual MoE): prefill of 2 x 512
               and 4 decode steps against one device, then one Adafactor
               train step and its peak memory; exactly one flash launch a
               layer a data block a position with heads a prefill and two a
               train step; each new flash shape's first call held against
               the plain version;
 19. ssm_parallel — RWKV6 and the hybrid Mamba stack over grids of views
               of the card (repro_torch.models.sharded's time mix over
               whole heads, channel mix and Mamba mixer over its inner
               channels): rwkv6-7b's bf16 weights at full width, 16 of 32
               layers (the script's time since phase 20),
               the forward and the prefill of 2 x 512 (the chunked WKV) and
               8 decode steps over (2, 4) and (1, 16) against one device's
               f32-compute and bf16 runs (float32 within 1e-3, top-1 >= 99
               %; the bf16 forward's top-1 with the f32 run at least one
               device's less 3 binomial standard deviations, mean distance
               at most 1.1x one device's; the first decode step's WKV states
               within 1e-3 of their largest entries); its sharded train step at 8 of
               32 layers over (2, 4) (AdamW, ZeRO-1) beside make_train_step's,
               the first step's payloads equal to the meta count; the f32
               held check at 4 layers; jamba-1.5-large-398b at the families
               phase's cut (8 layers, 4 experts, bf16) over (2, 4) (one whole
               expert a position, the manual MoE, the KV heads gathered): the
               phase-18 gates with the routing pinned to one device's, the
               first decode step's Mamba states of the layers before the
               first MoE layer after a 64-token prompt, one Mamba layer's ms
               sharded and on one device; one Adafactor train step of the
               same jamba cut over (2, 4) at 4 x 64 tokens and its peak
               memory; each new flash shape's first
               call held against the plain version;
 20. enc_dec_context_parallel — whisper-medium's encoder-decoder over
               'model' and TaCo decode context-parallel, on grids of views
               of the card (repro_torch.models.sharded's encoder, cross-
               attention and context-parallel TaCo step): whisper-medium's
               bf16 weights at full width and depth (24 + 24 layers),
               prefill of 8 x 256 tokens over 1500 seeded frames and 16
               decode steps over (2, 4) (the cross cache along the frames)
               and (1, 16) (along head_dim) against one device's float32
               (within 1e-3, top-1 >= 99 %) and bf16 runs (the lm phase's
               top-1 and distance gates, with phases 18-19's binomial top-1
               slack); its sharded train step at full
               depth over (2, 4) (AdamW, ZeRO-1, 8 x 128 tokens) beside
               make_train_step's, the first step's payloads equal to the
               meta count; the f32 held check at 4 + 4 layers (its K
               biases, whose true gradient is zero, held to 2 lr x steps);
               granite-3-2b at full width and depth with TaCo attention
               (C = 1024, 128 recent slots), one row: prefill of 32,704
               tokens into a 32,768-slot cache on one device, the cache
               placed context-parallel over (2, 4) and (1, 16) (4,096 and
               2,048 slots a position), 16 decode steps against one
               device's TaCo decode pinned to the sharded run's slots
               (float32 within 1e-3, top-1 >= 99 %; bf16 the lm phase's
               gates), >= 99 % of each retrieved slot set shared with the
               one one device selects on its own (the share of equal sets
               printed),
               at least half of the positions holding a selected slot, a
               decode step's ms beside one device's;
 21. summary — the card's nvidia-smi line, one JSON line with every kernel's
               numbers, and the final {"ok": true, ...} line.

Each path's kernels must be launched in its own run: the launch counts are
set to 0 just before the path is driven and read just after (build:
kmeans_assign; flash: flash_attention; masked: l2dist, schist,
masked_rerank; gather: l2dist, scscore; persist: l2dist, schist,
masked_rerank, scscore; mutable: l2dist, schist and masked_rerank exactly
once a masked-full batch, l2dist and scscore once a gather batch; compact:
kmeans_assign; engine: l2dist, schist, masked_rerank, scscore, exactly as
the sync runs' batches predict; sharded: l2dist once a batch, schist and
masked_rerank 4 times a masked-full batch, scscore 4 times a gather batch,
in the searcher, the engine and serve_ann --shards 4, and kmeans_assign 4
times a sharded Lloyd step; serve: l2dist, schist, masked_rerank,
kmeans_assign, and for the default-config save l2dist and scscore, counted
in the launcher's own process; lm: flash_attention exactly once a layer a
prefill, in the engine, in forward and in prefill; ivf_build: kmeans_assign
exactly 11 times; train: flash_attention exactly twice a layer a step, at
full width and in the 2-layer gradient check, and in the smoke runs;
families: flash_attention exactly once an attention layer a prefill, twice
with cross-attention, once more an encoder layer: 72 for whisper-medium;
none for rwkv6-7b; parallel: flash_attention exactly twice a layer a shard a
step in the sharded and microbatched steps, once a layer a prefill or
forward under either MoE implementation; dryrun: none; tensor_parallel:
flash_attention exactly twice a layer a position a step in the sharded
steps, once a layer a prefill position, none in decode; expert_parallel:
flash_attention exactly once a layer a data block a position with heads a
prefill, twice a step in the sharded steps, none in decode; ssm_parallel:
none for rwkv6-7b, once jamba's attention layer a data block a position
with heads a prefill, twice a step; enc_dec_context_parallel: once an
encoder, decoder and cross layer a data block a position with heads a
prefill, twice a step in the sharded steps, none in decode, once a layer
in the TaCo prefill on one device; wide: kmeans_assign exactly 11 times an
IVF build and kmeans_iters + 1 times the TaCo build, l2dist exactly once a
query batch, schist, masked_rerank and scscore on their paths), l2dist exactly once a
query batch and kmeans_assign exactly kmeans_iters + 1 times a build. Each phase's host
seconds are printed (``phase ...:`` lines). The full result is also
written to chiprun_out/chip_smoke.json.

It imports nothing of the JAX package; the corpus comes from the port's own
seeded gmm_dataset.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and float32
#: non-tensor FLOP/s. Integer collision tests are counted at the same
#: 32-bit non-tensor rate.
HBM_BPS = 3.35e12
F32_OPS = 67e12
#: dense bf16 and TF32 tensor-core FLOP/s (same data sheet)
BF16_TENSOR_OPS = 989e12
TF32_TENSOR_OPS = 495e12
QUERIES = 1000
SOURCES = {
    "l2dist": ("src/repro_torch/csrc/l2dist.cu", "src/repro/kernels/l2dist.py:61"),
    "kmeans_assign": ("src/repro_torch/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign.py:44"),
    "schist": ("src/repro_torch/csrc/schist.cu", "src/repro/kernels/schist.py:125"),
    "masked_rerank": ("src/repro_torch/csrc/masked_rerank.cu",
                      "src/repro/kernels/masked_rerank.py:234"),
    "scscore": ("src/repro_torch/csrc/scscore.cu", "src/repro/kernels/scscore.py:63"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:99"),
    "activation": ("src/repro_torch/csrc/activation.cu", "src/repro/core/activation.py:57"),
}
#: the kernels each path must launch in its own run
PATHS = {
    "build": ("kmeans_assign",),
    "masked": ("l2dist", "schist", "masked_rerank", "activation"),
    "autotune_search": ("l2dist", "schist", "masked_rerank", "activation"),
    "gather": ("l2dist", "scscore", "activation"),
    # SuCo's linear activation stays on torch
    "suco_gather": ("l2dist", "scscore"),
    "flash": ("flash_attention",),
    "persist": ("l2dist", "schist", "masked_rerank", "scscore", "activation"),
    "mutable": ("l2dist", "schist", "masked_rerank", "activation"),
    "mutable_gather": ("l2dist", "scscore", "activation"),
    "compact": ("kmeans_assign",),
    "engine": ("l2dist", "schist", "masked_rerank", "scscore", "activation"),
    "serve": ("l2dist", "schist", "masked_rerank", "kmeans_assign", "activation"),
    "serve_load": ("l2dist", "scscore", "activation"),
    "sharded": ("l2dist", "schist", "masked_rerank", "scscore", "activation"),
    "sharded_engine": ("l2dist", "schist", "masked_rerank", "scscore", "activation"),
    "sharded_serve": ("l2dist", "scscore", "activation"),
    "sharded_build": ("kmeans_assign",),
    "lm_serve": ("flash_attention",),
    "lm_prefill": ("flash_attention",),
    "lm_taco": ("flash_attention",),
    "ivf_build": ("kmeans_assign",),
    "wide_ivf_build": ("kmeans_assign",),
    "wide_build": ("kmeans_assign",),
    "wide_masked": ("l2dist", "schist", "masked_rerank", "activation"),
    "wide_gather": ("l2dist", "scscore", "activation"),
    "wide_big_k": ("l2dist", "schist", "masked_rerank", "activation"),
    "train": ("flash_attention",),
    "train_grads": ("flash_attention",),
    "train_smoke": ("flash_attention",),
    "families_moe_serve": ("flash_attention",),
    "families_moe_prefill": ("flash_attention",),
    "families_rwkv_serve": (),
    "families_rwkv": (),
    "families_whisper": ("flash_attention",),
    "families_llava": ("flash_attention",),
    "families_arctic": ("flash_attention",),
    "families_jamba": ("flash_attention",),
    "parallel_dp": ("flash_attention",),
    "parallel_dp_compressed": ("flash_attention",),
    "parallel_ep": ("flash_attention",),
    "dryrun": (),
    "tensor_parallel_train": ("flash_attention",),
    "tensor_parallel_single": ("flash_attention",),
    "tensor_parallel_held": ("flash_attention",),
    "tensor_parallel_prefill": ("flash_attention",),
    "tensor_parallel_decode": (),
    "expert_parallel_prefill": ("flash_attention",),
    "expert_parallel_single": ("flash_attention",),
    "expert_parallel_train": ("flash_attention",),
    "expert_parallel_held": ("flash_attention",),
    "expert_parallel_arctic": ("flash_attention",),
    "ssm_parallel_rwkv": (),
    "ssm_parallel_rwkv_train": (),
    "ssm_parallel_rwkv_held": (),
    "ssm_parallel_jamba": ("flash_attention",),
    "ssm_parallel_jamba_single": ("flash_attention",),
    "ssm_parallel_jamba_train": ("flash_attention",),
    "enc_dec_single": ("flash_attention",),
    "enc_dec_single_decode": (),
    "enc_dec_prefill": ("flash_attention",),
    "enc_dec_prefill_decode": (),
    "enc_dec_train": ("flash_attention",),
    "enc_dec_held": ("flash_attention",),
    "context_parallel_prefill": ("flash_attention",),
    "context_parallel_decode": (),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float, rate: float = F32_OPS) -> tuple[float, str]:
    tb, to = nbytes / HBM_BPS * 1e3, ops / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def kernel_device_ms(torch, fn, kernel: str, reps: int = 20) -> float | None:
    """Mean device time of one launch of the CUDA kernel whose name holds
    ``kernel``, from torch.profiler's kernel durations over ``reps`` calls
    of ``fn`` after one warm-up (None where the trace has no such kernel):
    the kernel alone, without the launch path a CUDA-event window holds."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for us, n, key in profile_rows(prof.key_averages())[0]:
        if kernel in key:
            total += us
            count += n
    return total / count / 1e3 if count else None


def profile_rows(averages) -> tuple[list, list]:
    """(device, host) rows ``(us, count, key)`` of a profiler's
    ``key_averages()``, those with some time. A device row is an event on
    the card's timeline that is no user annotation, by its own device time:
    the profiler copies each ``record_function`` range (the port's query
    stages) onto that timeline, and such a row's time is the range's whole
    length, not work of the card. A host row is a host event by its own
    (self) CPU time."""
    from torch.autograd import DeviceType

    device, host = [], []
    for evt in averages:
        if evt.device_type == DeviceType.CUDA:
            if evt.is_user_annotation:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0)
            rows = device
        else:
            us, rows = evt.self_cpu_time_total, host
        if us > 0:
            rows.append((us, evt.count, evt.key))
    return device, host


def timed(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device ms per call, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: schist against its plain version, as in the card tests: (N_s, Q, K, n,
#: table fill). n below one 2048-point chunk, not a multiple of it, 10^6.
SCHIST_CASES = (
    (1, 1, 1024, 1000, "random"), (3, 33, 25, 5003, "random"),
    (6, 37, 1024, 20017, "random"), (6, 1000, 1024, 10 ** 6, "random"),
    (3, 1, 64, 10 ** 6, "random"), (8, 1000, 512, 20017, "random"),
    (16, 33, 256, 4099, "random"), (16, 1025, 2048, 20017, "random"),
    (16, 37, 2048, 1000, "random"), (6, 1025, 1024, 10 ** 6, "ones"),
    (6, 1000, 1024, 2100, "zeros"), (16, 1025, 2048, 5003, "ones"),
)


def kmeans_pairs_case(torch, label: str, n: int, k: int, dims, ints, floats,
                      scale_atol) -> dict:
    """The batched kmeans_assign at P = len(dims) pairs of n points and k
    centroids, pair p of width dims[p], zero-padded to a multiple of 4:
    integer inputs bit for bit against the plain version; float inputs bit
    for bit against one single-pair launch per pair at its own width, and
    against the plain version (argmin where the two nearest are clearly
    apart, the min within the l2dist tolerance). Timed beside the 12 single
    launches, the plain version, ``torch.cdist(xs, cs).min(-1)`` on the
    stack and the bound."""
    from repro_torch.kernels.kmeans_assign import (
        kmeans_assign_cuda,
        kmeans_assign_pairs_cuda,
        kmeans_assign_pairs_plain,
    )
    from repro_torch.kernels.l2dist import l2dist_plain

    n_pairs, w = len(dims), -(-max(dims) // 4) * 4

    def stack(draw):
        xs = torch.zeros((n_pairs, n, w), device="cuda")
        cs = torch.zeros((n_pairs, k, w), device="cuda")
        for p, d in enumerate(dims):
            xs[p, :, :d], cs[p, :, :d] = draw((n, d)), draw((k, d))
        return xs, cs

    xs, cs = stack(ints)
    ga, gd = kmeans_assign_pairs_cuda(xs, cs, dims)
    wa, wd = kmeans_assign_pairs_plain(xs, cs, dims)
    check(torch.equal(ga, wa) and torch.equal(gd, wd), f"kmeans_assign pairs int {label}")
    xs, cs = stack(floats)
    ga, gd = kmeans_assign_pairs_cuda(xs, cs, dims)
    halves = [(xs[p, :, :d].contiguous(), cs[p, :, :d].contiguous()) for p, d in enumerate(dims)]
    for p, (x, c) in enumerate(halves):
        sa, sdm = kmeans_assign_cuda(x, c)
        check(torch.equal(ga[p], sa) and torch.equal(gd[p].view(torch.int32),
                                                     sdm.view(torch.int32)),
              f"kmeans_assign pairs vs single launch {label} pair {p}")
    wa, wd = kmeans_assign_pairs_plain(xs, cs, dims)
    agree = 0.0
    for p, (x, c) in enumerate(halves):
        two = torch.topk(l2dist_plain(x, c), 2, dim=1, largest=False).values
        clear = (two[:, 1] - two[:, 0]) > 1e-5 * two[:, 0].clamp_min(1e-30)
        check(bool(torch.equal(ga[p][clear], wa[p][clear])),
              f"kmeans_assign pairs float argmin {label} pair {p}")
        check(torch.allclose(gd[p], wd[p], rtol=1e-5, atol=scale_atol(x, c)),
              f"kmeans_assign pairs float min {label} pair {p}")
        agree += float((ga[p] == wa[p]).float().mean()) / n_pairs
        del two, clear
    b, by = bound_ms(4 * (n_pairs * n * w + n_pairs * k * w + 2 * n_pairs * n),
                     sum(n * k * (2 * d + 3) + 2 * d * (n + k) for d in dims))
    row = dict(
        max_abs_err=float((gd - wd).abs().max()),
        ms=timed(torch, lambda: kmeans_assign_pairs_cuda(xs, cs, dims), 50),
        single_launches_ms=timed(torch, lambda: [kmeans_assign_cuda(x, c) for x, c in halves], 50),
        plain_ms=timed(torch, lambda: kmeans_assign_pairs_plain(xs, cs, dims), 3),
        bound_ms=b, bound_by=by,
        library_ms=timed(torch, lambda: torch.cdist(xs, cs).min(dim=-1), 3),
        argmin_agree=agree,
        shape=f"{n_pairs} pairs, x ({n}, {w}) (widths {dims}), c ({k}, {w})")
    print(f"kernel kmeans_assign {label}: {json.dumps(row)}", flush=True)
    return row


#: IVF's lists: ~sqrt(n) at 10^6 points (SIFT1M is usually served as IVF1024/IVF4096)
IVF_LISTS = 1024
#: a kmeans_assign answer that differs from the plain version's must be a
#: near-tie: its distance (plain arithmetic) within this of the plain minimum,
#: relative to the point's |x|^2 + |c|^2 (the cancellation of the norm form)
IVF_NEAR_TIE = 1e-5
IVF_AGREE = 0.9999


def ivf_assign_case(torch, corpus, ints, rng) -> dict:
    """kmeans_assign at IVF's shape, the corpus (10^6, 128) against 1024
    centroids (1024 corpus rows): k (w + 1) floats past shared memory, so
    the tiled path. Integer inputs at the same shape bit for bit against
    the plain version; on the corpus the assignments equal the plain
    version's on >= 99.99 % of the points and every other one is a
    near-tie, the distances allclose. Timed beside the plain version,
    ``torch.cdist(x, c).min(-1)`` (TF32 off) and its bound: the larger of
    the bytes and the screen's products at the TF32 tensor-core rate
    (``bound_ms``; the kernel computes every distance on the tensor cores),
    beside the same operations at the CUDA-core f32 rate
    (``cuda_core_bound_ms``, no lower bound for this kernel) and the bytes
    alone. Also kept: the launch's rechecks a point, the tile geometry, and
    the screen's and pre-pass's device times."""
    from repro_torch.kernels.kmeans_assign import (
        TILE_CENTROIDS,
        TILE_POINTS,
        kmeans_assign_cuda,
        kmeans_assign_plain,
        last_tiled,
        tiled,
    )

    n, w = corpus.shape
    k = IVF_LISTS
    check(tiled(k, w), f"kmeans_assign ivf: {k} x {w} fits in shared memory")
    x, c = ints((n, w)), ints((k, w))
    ga, gd = kmeans_assign_cuda(x, c)
    wa, wd = kmeans_assign_plain(x, c)
    check(torch.equal(ga, wa) and torch.equal(gd, wd), "kmeans_assign ivf int")
    del x, ga, gd, wa, wd
    c = corpus[torch.as_tensor(rng.choice(n, k, replace=False), device=corpus.device)]
    ga, gd = kmeans_assign_cuda(corpus, c)
    rechecks = int(last_tiled["rechecks"].item())
    check(last_tiled["points"] == n and n <= rechecks <= n * k,
          f"kmeans_assign ivf: {rechecks} rechecks for {n} points")
    wa, wd = kmeans_assign_plain(corpus, c)
    differ = torch.nonzero(ga != wa)[:, 0]
    agree = 1.0 - differ.numel() / n
    check(agree >= IVF_AGREE, f"kmeans_assign ivf: assignments agree on {agree} < {IVF_AGREE}")
    if differ.numel():
        xd = corpus[differ]
        scale = (xd * xd).sum(1) + (c * c).sum(1).max()
        picked = ((xd - c[ga[differ].long()]) ** 2).sum(1)
        check(bool((picked - wd[differ] <= IVF_NEAR_TIE * scale).all()),
              "kmeans_assign ivf: a differing assignment is not a near-tie")
    atol = 1e-5 * float((corpus * corpus).sum(1).max() + (c * c).sum(1).max())
    check(torch.allclose(gd, wd, rtol=1e-5, atol=atol), "kmeans_assign ivf: distances")
    nbytes = 4 * (n * w + k * w + 2 * n)
    b, by = bound_ms(nbytes, 2 * n * k * w, TF32_TENSOR_OPS)
    core_b, _ = bound_ms(nbytes, n * k * (2 * w + 3) + 2 * w * (n + k))
    row = dict(max_abs_err=float((gd - wd).abs().max()), assign_agree=agree,
               differing=int(differ.numel()),
               ms=timed(torch, lambda: kmeans_assign_cuda(corpus, c), 10),
               plain_ms=timed(torch, lambda: kmeans_assign_plain(corpus, c), 3),
               bound_ms=b, bound_by=by, cuda_core_bound_ms=core_b,
               bytes_bound_ms=nbytes / HBM_BPS * 1e3,
               library_ms=timed(torch, lambda: torch.cdist(corpus, c).min(dim=-1), 3),
               rechecks_per_point=rechecks / n, tile_points=TILE_POINTS,
               tile_centroids=TILE_CENTROIDS,
               screen_device_ms=kernel_device_ms(
                   torch, lambda: kmeans_assign_cuda(corpus, c), "screen_kernel", 5),
               prep_device_ms=kernel_device_ms(
                   torch, lambda: kmeans_assign_cuda(corpus, c), "prep_kernel", 5),
               shape=f"x ({n}, {w}), c ({k}, {w}), tiled")
    print(f"kernel kmeans_assign ivf: {json.dumps(row)}", flush=True)
    return row


def engine_buckets(torch, res, timings, floats, collision_case, rerank_case, compare_rerank,
                   corpus, queries, scale_atol) -> None:
    """The serving engine pads each batch up the bucket ladder, so each
    kernel of its path runs at every bucket over the 10^6 points: each is
    held there against its plain version on the same inputs, as at the main
    path's Q above. ``schist`` and ``scscore`` bit for bit (and every
    histogram row sums to n); the batched ``l2dist`` bit for bit against one
    launch a pair and within the float tolerance of the plain version;
    ``masked_rerank`` at k 10 and 100: the filled slots and the dists at
    every bucket, its ids >= 99.9 % equal at each bucket from 64 up and
    over the buckets below 64 together (one near-tie swap there is already
    more than 0.1 % of a bucket). Each kernel is then timed at 64,
    ``max_batch``'s default. Recorded under each kernel's ``buckets``
    (max_abs_err by bucket) and ``bucket64_ms``."""
    from repro_torch.batching import ANN_BATCH_BUCKETS
    from repro_torch.core.taco import _half_slices
    from repro_torch.kernels.l2dist import l2dist_cuda, l2dist_pairs_cuda, l2dist_pairs_plain
    from repro_torch.kernels.masked_rerank import masked_rerank_cuda
    from repro_torch.kernels.schist import schist_cuda, schist_geometry, schist_plain
    from repro_torch.kernels.scscore import scscore_cuda, scscore_plain

    n_sub, sqrt_k, sd, n = 6, 32, 4, corpus.shape[0]
    slices = _half_slices((2 * sd,) * n_sub)
    y = floats((2 * n_sub, sqrt_k, sd))
    for name in ("l2dist", "schist", "scscore"):
        res[name]["buckets"] = {}
    for k in (10, 100):
        timings[k]["buckets"] = {}
    small = {10: [0, 0], 100: [0, 0]}  # ids equal, ids compared in buckets below 64
    for b in ANN_BATCH_BUCKETS:
        x = floats((b, 2 * sd * n_sub))
        got = l2dist_pairs_cuda(x, slices, y)
        singles = torch.stack([l2dist_cuda(x[:, c:c + w].contiguous(), y[p])
                               for p, (c, w) in enumerate(slices)])
        check(torch.equal(got, singles), f"l2dist pairs vs single launches, bucket {b}")
        want = l2dist_pairs_plain(x, slices, y)
        check(torch.allclose(got, want, rtol=1e-5, atol=scale_atol(x, y.flatten(0, 1))),
              f"l2dist pairs float, bucket {b}")
        res["l2dist"]["buckets"][b] = float((got - want).abs().max())
        bits, cells = collision_case(n_sub, b, sqrt_k, n)
        hist = schist_cuda(bits, cells, n_sub + 1, q=b)
        check(torch.equal(hist, schist_plain(bits, cells, n_sub + 1, q=b)), f"schist, bucket {b}")
        check(bool((hist.sum(1) == n).all()), f"schist counts, bucket {b}")
        res["schist"]["buckets"][b] = 0.0
        sc = scscore_cuda(bits, cells, q=b)
        check(torch.equal(sc, scscore_plain(bits, cells, q=b)), f"scscore, bucket {b}")
        res["scscore"]["buckets"][b] = 0.0
        del sc
        if b == 64:
            res["l2dist"]["bucket64_ms"] = timed(torch, lambda: l2dist_pairs_cuda(x, slices, y),
                                                 200)
            res["l2dist"]["bucket64_device_ms"] = kernel_device_ms(
                torch, lambda: l2dist_pairs_cuda(x, slices, y), "l2dist_pairs_kernel")
            res["schist"]["bucket64_ms"] = timed(
                torch, lambda: schist_cuda(bits, cells, n_sub + 1, q=b), 10)
            res["schist"]["bucket64_geometry"] = dict(zip(
                ("tiles", "warps", "smem_bytes", "tile_groups"),
                schist_geometry(b, n_sub, sqrt_k ** 2)))
            res["scscore"]["bucket64_ms"] = timed(torch, lambda: scscore_cuda(bits, cells, q=b),
                                                  10)
        for k in (10, 100):
            args_, _ = rerank_case((n_sub, b, sqrt_k, n), corpus, queries[:b], k)
            gd, gi, wd, wi = compare_rerank(args_, k, False, f"bucket {b} k={k}",
                                            min_agree=0.999 if b >= 64 else 0.0)
            fin = torch.isfinite(wd)
            same = int((gi == wi).sum())
            timings[k]["buckets"][b] = dict(
                max_abs_err=float((gd[fin] - wd[fin]).abs().max()) if fin.any() else 0.0,
                ids_agree=same / gi.numel())
            if b < 64:
                small[k][0] += same
                small[k][1] += gi.numel()
            if b == 64:
                timings[k]["bucket64_ms"] = timed(torch, lambda: masked_rerank_cuda(*args_, k), 5)
            del gd, gi, wd, wi
    for k, (same, total) in small.items():
        check(same >= 0.999 * total,
              f"masked_rerank ids agree {same / total:.5f} < 0.999 over buckets below 64, k={k}")
    torch.cuda.empty_cache()


def phase_kernels(torch, corpus, queries, rng) -> dict:
    """Phase 3: every ANN kernel against its plain version on the card."""
    import numpy as np

    from repro_torch.core.activation import activation_taus
    from repro_torch.core.selection import query_aware_threshold
    from repro_torch.kernels.activation import sort_activation_cuda
    from repro_torch.kernels.kmeans_assign import kmeans_assign_cuda, kmeans_assign_plain
    from repro_torch.core.taco import _half_slices
    from repro_torch.kernels.l2dist import (
        l2dist_cuda,
        l2dist_pairs_cuda,
        l2dist_pairs_plain,
        l2dist_plain,
    )
    from repro_torch.kernels.masked_rerank import (
        masked_rerank_cuda,
        masked_rerank_plain,
        pack_exclusion,
        rerank_geometry,
        rerank_resident_warps,
    )
    from repro_torch.kernels.schist import (
        collision_bits,
        collision_table,
        schist_cuda,
        schist_geometry,
        schist_plain,
        unpack_collision_bits,
    )
    from repro_torch.kernels.ref import sort_activation_ref
    from repro_torch.kernels.scscore import scscore_cuda, scscore_plain

    dev = torch.device("cuda")
    res = {}

    def T(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)

    def ints(shape, lo=-8, hi=9):
        return T(rng.integers(lo, hi, shape).astype(np.float32))

    def floats(shape):
        return T(rng.standard_normal(shape).astype(np.float32))

    def scale_atol(x, y):  # cancellation floor of the |x|^2+|y|^2-2x.y form
        return 1e-5 * float((x * x).sum(1).max() + (y * y).sum(1).max())

    # ---------------------------------------------------------- l2dist --
    q, n_sub, sqrt_k, sd = QUERIES, 6, 32, 4
    for shape in ((q, sqrt_k, sd), (37, 29, 5)):
        x, y = ints(shape[::2]), ints(shape[1:])
        check(torch.equal(l2dist_cuda(x, y), l2dist_plain(x, y)), f"l2dist int {shape}")
        x, y = floats(shape[::2]), floats(shape[1:])
        got, want = l2dist_cuda(x, y), l2dist_plain(x, y)
        check(torch.allclose(got, want, rtol=1e-5, atol=scale_atol(x, y)),
              f"l2dist float {shape}")
    # the main path's batch: 2 N_s = 12 (subspace, half) pairs of half-dim 4
    # in one launch, bitwise equal to one single-pair launch per pair
    slices = _half_slices((2 * sd,) * n_sub)
    for x_sh, y_sh, sl in (((q, 2 * sd * n_sub), (2 * n_sub, sqrt_k, sd), slices),
                           ((37, 65), (6, 29, 12), _half_slices((21, 21, 23)))):
        x, y = floats(x_sh), floats(y_sh)
        for p, (_c, w) in enumerate(sl):
            y[p, :, w:] = 0
        got = l2dist_pairs_cuda(x, sl, y)
        singles = torch.stack([l2dist_cuda(x[:, c:c + w].contiguous(), y[p, :, :w].contiguous())
                               for p, (c, w) in enumerate(sl)])
        check(torch.equal(got, singles), f"l2dist pairs vs single launches {x_sh} {y_sh}")
        want = l2dist_pairs_plain(x, sl, y)
        check(torch.allclose(got, want, rtol=1e-5, atol=scale_atol(x, y.flatten(0, 1))),
              f"l2dist pairs float {x_sh} {y_sh}")
    x, y = floats((q, 2 * sd * n_sub)), floats((2 * n_sub, sqrt_k, sd))
    xb = torch.stack([x[:, c:c + w] for c, w in slices])
    got, want = l2dist_pairs_cuda(x, slices, y), l2dist_pairs_plain(x, slices, y)
    pairs = len(slices)
    b, by = bound_ms(4 * (q * 2 * sd * n_sub + pairs * sqrt_k * sd + pairs * q * sqrt_k),
                     pairs * (q * sqrt_k * (2 * sd + 3) + 2 * sd * (q + sqrt_k)))
    res["l2dist"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=timed(torch, lambda: l2dist_pairs_cuda(x, slices, y), 200),
        # the parent's path: a contiguous copy of each slice, one launch a pair
        single_launches_ms=timed(torch, lambda: [l2dist_cuda(x[:, c:c + w].contiguous(), y[p])
                                                 for p, (c, w) in enumerate(slices)], 200),
        plain_ms=timed(torch, lambda: l2dist_pairs_plain(x, slices, y), 200),
        bound_ms=b, bound_by=by,
        library_ms=timed(torch, lambda: torch.cdist(xb, y) ** 2, 200),
        # the kernel alone, by the profiler, beside the CUDA-event ms above
        device_ms=kernel_device_ms(torch, lambda: l2dist_pairs_cuda(x, slices, y),
                                   "l2dist_pairs_kernel"),
        shape=f"{pairs} pairs, x ({q}, {2 * sd * n_sub}), half-dim {sd}, sqrt_k {sqrt_k}")

    # --------------------------------------------------- kmeans_assign --
    # the single-pair entry: the main path's half and a ragged shape
    n = corpus.shape[0]
    for shape in ((n, sqrt_k, sd), (1003, 13, 3)):
        x, c = ints(shape[::2]), ints(shape[1:])
        ga, gd = kmeans_assign_cuda(x, c)
        wa, wd = kmeans_assign_plain(x, c)
        check(torch.equal(ga, wa) and torch.equal(gd, wd), f"kmeans_assign int {shape}")
        x, c = floats(shape[::2]), floats(shape[1:])
        ga, gd = kmeans_assign_cuda(x, c)
        wa, wd = kmeans_assign_plain(x, c)
        two = torch.topk(l2dist_plain(x, c), 2, dim=1, largest=False).values
        clear = (two[:, 1] - two[:, 0]) > 1e-5 * two[:, 0].clamp_min(1e-30)
        check(bool(torch.equal(ga[clear], wa[clear])), f"kmeans_assign float argmin {shape}")
        check(torch.allclose(gd, wd, rtol=1e-5, atol=scale_atol(x, c)),
              f"kmeans_assign float min {shape}")
    x, c = floats((n, sd)), floats((sqrt_k, sd))
    one_pair_ms = timed(torch, lambda: kmeans_assign_cuda(x, c), 50)
    # the build's launch: its 2 N_s = 12 (subspace, half) pairs, TaCo's
    # halves of 4 and SuCo's (128 dims over 6 subspaces) of 10/11 and 11/12
    # zero-padded to 12, and a ragged case
    rows = {label: kmeans_pairs_case(torch, label, n_, k_, dims, ints, floats, scale_atol)
            for label, n_, k_, dims in (("taco", n, sqrt_k, [sd] * 2 * n_sub),
                                        ("suco", n, sqrt_k, [10, 11] * 5 + [11, 12]),
                                        ("ragged", 1003, 13, [3, 5, 7]))}
    res["kmeans_assign"] = dict(rows["taco"], one_pair_ms=one_pair_ms,
                                one_pair_shape=f"x ({n}, {sd}), c ({sqrt_k}, {sd})",
                                suco=rows["suco"], ragged=rows["ragged"],
                                ivf=ivf_assign_case(torch, corpus, ints, rng))
    del x, c
    torch.cuda.empty_cache()

    # ------------------------------------------------------ activation --
    # the benchmark's batches: SIFT1M's masked (6, 10240, 32) and gather
    # (6, 1024, 32), GIST1M's (20, 1024, 64); sizes of n points, alpha 0.05
    def activation_case(n_sub, q, sqrt_k):
        k2 = sqrt_k * sqrt_k
        cells = T(rng.integers(0, k2, (n_sub, n)))
        sizes = torch.stack([torch.bincount(c, minlength=k2) for c in cells])
        sizes = sizes.to(torch.int32).reshape(n_sub, sqrt_k, sqrt_k)
        d1s = T(rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32))
        d2s = T(rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32))
        alpha_n = 0.05 * n
        got = sort_activation_cuda(d1s, d2s, sizes, alpha_n)
        want = sort_activation_ref(d1s, d2s, sizes[:, None], alpha_n)
        for g, w, what in zip(got, want, ("tau", "retrieved")):
            check(torch.equal(g.view(torch.int32), w.view(torch.int32)),
                  f"activation {what} {(n_sub, q, sqrt_k)}")
        # N_s Q K cell sums; both halves' f32 distances, int32 sizes, two f32 outputs
        b, by = bound_ms(4 * (2 * n_sub * q * sqrt_k + n_sub * k2 + 2 * n_sub * q),
                         n_sub * q * k2)
        return dict(
            max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, want)),
            ms=timed(torch, lambda: sort_activation_cuda(d1s, d2s, sizes, alpha_n), 20),
            plain_ms=timed(torch, lambda: sort_activation_ref(d1s, d2s, sizes[:, None], alpha_n),
                           2),
            bound_ms=b, bound_by=by, library_ms=None, shape=f"N_s {n_sub}, Q {q}, K {k2}")

    res["activation"] = dict(activation_case(n_sub, 10240, sqrt_k),
                             shapes=[activation_case(n_sub, 1024, sqrt_k),
                                     activation_case(20, 1024, 64)])
    torch.cuda.empty_cache()

    # ------------------------------------------- schist + masked_rerank --
    def collision_case(n_sub, q, sqrt_k, n, alpha=0.05):
        cells = T(rng.integers(0, sqrt_k * sqrt_k, (n_sub, n)), torch.int32)
        sizes = torch.stack([torch.bincount(cells[s].long(), minlength=sqrt_k ** 2)
                             for s in range(n_sub)]).to(torch.int32).reshape(n_sub, sqrt_k, sqrt_k)
        d1s = T(rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32))
        d2s = T(rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32))
        taus, _ = activation_taus(d1s, d2s, sizes, alpha * n)
        return collision_bits(collision_table(d1s, d2s, taus)), cells

    big = (n_sub, q, sqrt_k, n)
    for shape in (big, (3, 37, 5, 1003)):
        bits, cells = collision_case(*shape)
        got = schist_cuda(bits, cells, shape[0] + 1, q=shape[1])
        want = schist_plain(bits, cells, shape[0] + 1, q=shape[1])
        check(torch.equal(got, want), f"schist {shape}")
        check(bool((got.sum(1) == shape[3]).all()), f"schist counts {shape}")
    # the card tests' shapes: packed words drawn at random (padding bits
    # set too), all ones and all zeros; N_s 16 at K 2048 holds one tile
    for n_s, q_, k2, n_, fill in SCHIST_CASES:
        qt = (q_ + 31) // 32
        if fill == "random":
            words = T(rng.integers(-2 ** 31, 2 ** 31, (qt, n_s, k2)), torch.int32)
        else:
            words = torch.full((qt, n_s, k2), -1 if fill == "ones" else 0, dtype=torch.int32,
                               device=dev)
        cells = T(rng.integers(0, k2, (n_s, n_)), torch.int32)
        got = schist_cuda(words, cells, n_s + 1, q=q_)
        check(torch.equal(got, schist_plain(words, cells, n_s + 1, q=q_)),
              f"schist {(n_s, q_, k2, n_, fill)}")
        check(bool((got.sum(1) == n_).all()), f"schist counts {(n_s, q_, k2, n_, fill)}")
    bits, cells = collision_case(*big)
    hist = schist_cuda(bits, cells, n_sub + 1, q=q)
    nbits = bits.numel() * 4
    b, by = bound_ms(4 * n_sub * n + nbits + 4 * q * (n_sub + 1), q * n * n_sub)
    res["schist"] = dict(
        max_abs_err=float((hist - schist_plain(bits, cells, n_sub + 1, q=q)).abs().max()),
        ms=timed(torch, lambda: schist_cuda(bits, cells, n_sub + 1, q=q), 10),
        plain_ms=timed(torch, lambda: schist_plain(bits, cells, n_sub + 1, q=q), 2),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"Q {q}, N_s {n_sub}, K {sqrt_k ** 2}, n {n}",
        geometry=dict(zip(("tiles", "warps", "smem_bytes", "tile_groups"),
                          schist_geometry(q, n_sub, sqrt_k ** 2))))

    # --------------------------------------------------------- scscore --
    # the ragged shapes: Q not a multiple of 32, n not a multiple of the chunk
    for shape in (big, (n_sub, 100, sqrt_k, 20000), (3, 37, 5, 1003)):
        bits, cells = collision_case(*shape)
        got = scscore_cuda(bits, cells, q=shape[1])
        check(torch.equal(got, scscore_plain(bits, cells, q=shape[1])), f"scscore {shape}")
        del got
    bits, cells = collision_case(*big)
    sc = scscore_cuda(bits, cells, q=q)
    b, by = bound_ms(4 * q * n + 4 * n_sub * n + nbits, q * n * n_sub)
    res["scscore"] = dict(
        max_abs_err=float((sc - scscore_plain(bits, cells, q=q)).abs().max()),
        ms=timed(torch, lambda: scscore_cuda(bits, cells, q=q), 10),
        plain_ms=timed(torch, lambda: scscore_plain(bits, cells, q=q), 2),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"Q {q}, N_s {n_sub}, K {sqrt_k ** 2}, n {n}")
    del sc
    torch.cuda.empty_cache()

    def rerank_case(shape, data, qs, k):
        n_sub_, q_, sqrt_k_, n_ = shape
        bits, cells = collision_case(*shape)
        hist = schist_plain(bits, cells, n_sub_ + 1, q=q_)
        thresh, demand = query_aware_threshold(hist, 0.005 * n_, n_sub_)
        norms = (data * data).sum(1)
        return (bits, cells, thresh, qs, data, norms), demand

    def compare_rerank(args_, k, exact: bool, what: str, exclude=None, min_agree=0.999):
        gd, gi = masked_rerank_cuda(*args_, k, exclude)
        wd, wi = masked_rerank_plain(*args_, k, exclude)
        if exact:
            check(torch.equal(gi, wi) and torch.equal(gd, wd), f"masked_rerank int {what}")
            return gd, gi, wd, wi
        agree = float((gi == wi).float().mean())
        fin = torch.isfinite(wd)
        check(torch.equal(fin, torch.isfinite(gd)), f"masked_rerank filled slots {what}")
        atol = scale_atol(args_[3], args_[4])
        check(torch.allclose(gd[fin], wd[fin], rtol=1e-5, atol=atol), f"masked_rerank dists {what}")
        check(agree >= min_agree, f"masked_rerank ids agree {agree:.5f} < {min_agree} {what}")
        return gd, gi, wd, wi

    for shape, d, k in (((n_sub, q, sqrt_k, 65536), 128, 10),
                        ((n_sub, q, sqrt_k, 65536), 128, 100),
                        ((3, 37, 5, 1003), 20, 17)):
        args_, _ = rerank_case(shape, ints((shape[3], d)), ints((shape[1], d)), k)
        compare_rerank(args_, k, True, f"{shape} k={k}")
        # a tombstone bitmap over 10 % of the points, bitwise too
        words = pack_exclusion(rng.random(shape[3]) < 0.1).to(dev)
        compare_rerank(args_, k, True, f"{shape} k={k} exclusion", words)
    timings = {}
    for k in (10, 100):
        args_, demand = rerank_case(big, corpus, queries, k)
        gd, gi, wd, wi = compare_rerank(args_, k, False, f"{big} k={k}")
        fin = torch.isfinite(wd)
        total = float(demand.sum())
        d = corpus.shape[1]
        b, by = bound_ms(
            4 * n_sub * n + nbits + 4 * q + 4 * q * d + 4 * d * min(n, total) + 4 * n + 8 * q * k,
            q * n * n_sub + total * (2 * d + 3))
        mask_sc = None

        def library():
            nonlocal mask_sc
            if mask_sc is None:
                table = unpack_collision_bits(args_[0], q)
                sc = torch.zeros((q, n), dtype=torch.uint8, device=dev)
                for s in range(n_sub):
                    sc += table[s][:, args_[1][s].long()]
                mask_sc = sc >= args_[2][:, None].to(torch.uint8)
            qn = (args_[3] * args_[3]).sum(1, keepdim=True)
            dist = torch.addmm(args_[5][None, :], args_[3], args_[4].T, alpha=-2.0) + qn
            return torch.topk(torch.where(mask_sc, dist, torch.inf), k, dim=1, largest=False)

        library()
        timings[k] = dict(
            max_abs_err=float((gd[fin] - wd[fin]).abs().max()) if fin.any() else 0.0,
            ms=timed(torch, lambda: masked_rerank_cuda(*args_, k), 5),
            plain_ms=timed(torch, lambda: masked_rerank_plain(*args_, k), 1),
            bound_ms=b, bound_by=by,
            library_ms=timed(torch, library, 3),
            ids_agree=float((gi == wi).float().mean()),
            mean_candidates=total / q,
            shape=f"Q {q}, n {n}, d {d}, k {k}",
            geometry=dict(zip(("lanes", "warps", "chunk", "n_chunks", "smem_bytes"),
                              rerank_geometry(n, k, n_sub, sqrt_k ** 2, d))),
            resident_warps_per_sm=rerank_resident_warps(n, k, n_sub, sqrt_k ** 2, d))
        del mask_sc
        # the mutable index's tombstones: 1 % of the points excluded
        excluded = rng.random(n) < 0.01
        words = pack_exclusion(excluded).to(dev)
        xd, xi, xwd, xwi = compare_rerank(args_, k, False, f"{big} k={k} exclusion", words)
        returned = xi[xi >= 0].cpu().numpy()
        check(not excluded[returned].any(), f"masked_rerank returned an excluded point k={k}")
        xfin = torch.isfinite(xwd)
        timings[k]["exclusion"] = dict(
            excluded=int(excluded.sum()),
            max_abs_err=float((xd[xfin] - xwd[xfin]).abs().max()) if xfin.any() else 0.0,
            ids_agree=float((xi == xwi).float().mean()),
            ms=timed(torch, lambda: masked_rerank_cuda(*args_, k, words), 5),
            ms_without=timed(torch, lambda: masked_rerank_cuda(*args_, k), 5),
            plain_ms=timed(torch, lambda: masked_rerank_plain(*args_, k, words), 1),
            bitmap_bytes=words.numel() * 4,
            bound_ms=bound_ms(4 * n_sub * n + nbits + 4 * q + 4 * q * d + 4 * d * min(n, total)
                              + 4 * n + 8 * q * k + words.numel() * 4,
                              q * n * n_sub + total * (2 * d + 3))[0])
        del xd, xi, xwd, xwi
    res["masked_rerank"] = timings[10]
    engine_buckets(torch, res, timings, floats, collision_case, rerank_case, compare_rerank,
                   corpus, queries, scale_atol)
    for k in (10, 100):
        print(f"kernel masked_rerank k={k}: {json.dumps(timings[k])}", flush=True)
    for name in ("l2dist", "kmeans_assign", "schist", "scscore"):
        print(f"kernel {name}: {json.dumps(res[name])}", flush=True)
    torch.cuda.empty_cache()
    return res


#: the autotune phase's searches, in order: (op, queries, k). The key has
#: no k (the reference's format), so masked_rerank's k = 10 search, run
#: after k = 100, owns the 1000-query bucket's entry.
TUNE_RUNS = (("schist", QUERIES, 10), ("schist", 64, 10), ("masked_rerank", QUERIES, 100),
             ("masked_rerank", QUERIES, 10), ("masked_rerank", 64, 10))
TUNE_BUDGET_S = 10.0
#: the synthetic problem's shape besides Q and n: (d, N_s, sqrt_k), the main path's
TUNE_SHAPE = (128, 6, 32)


def tune_geometry(op: str, q: int, n: int, k: int, blocks) -> dict:
    """The launch geometry a (bq, bn) gives at this shape."""
    from repro_torch.kernels.masked_rerank import rerank_geometry
    from repro_torch.kernels.schist import schist_chunk, schist_geometry

    d, n_sub, sqrt_k = TUNE_SHAPE
    if op == "schist":
        tiles, warps, smem, groups, *_ = schist_geometry(q, n_sub, sqrt_k ** 2, blocks)
        return dict(tiles=tiles, warps=warps, chunk=schist_chunk(warps, blocks),
                    smem_bytes=smem, tile_groups=groups)
    return dict(zip(("lanes", "warps", "chunk", "n_chunks", "smem_bytes"),
                    rerank_geometry(n, k, n_sub, sqrt_k ** 2, d, blocks)))


def tune_against_plain(torch, op: str, q: int, n: int, k: int, winner) -> dict:
    """The winner's output on the search's inputs against the plain
    version: schist bit for bit; masked_rerank's ids >= 99.9 % equal, the
    filled slots equal and the dists within the float tolerance (its norm
    form sums in another order than the plain version's), with the
    candidates a query that its thresholds pass."""
    from repro_torch.kernels import autotune, ops

    d, n_sub, sqrt_k = TUNE_SHAPE
    args, kwargs = autotune.synthetic_problem(op, q, n, d, n_sub, sqrt_k, k, 0, "cuda")
    if op == "schist":
        got = ops.schist(*args, impl="kernel", blocks=winner, **kwargs)
        check(torch.equal(got, ops.schist(*args, impl="torch", **kwargs)),
              f"autotune: schist q={q} winner {winner} vs plain")
        return dict(max_abs_err=0.0)
    bits, cells, thresh = args[:3]
    hist = ops.schist(bits, cells, n_sub + 1, q=q, impl="kernel")
    levels = torch.arange(n_sub + 1, device=hist.device)[None, :]
    candidates = float(torch.where(levels >= thresh[:, None], hist, 0).sum(1).float().mean())
    gi, gd = ops.masked_rerank(*args, impl="kernel", blocks=winner)
    wi, wd = ops.masked_rerank(*args, impl="torch")
    fin = torch.isfinite(wd)
    data, queries = args[3], args[5]
    atol = 1e-5 * float((queries * queries).sum(1).max() + (data * data).sum(1).max())
    agree = float((gi == wi).float().mean())
    check(torch.equal(fin, torch.isfinite(gd)), f"autotune: masked_rerank q={q} k={k} slots")
    check(torch.allclose(gd[fin], wd[fin], rtol=1e-5, atol=atol),
          f"autotune: masked_rerank q={q} k={k} winner {winner} dists vs plain")
    check(agree >= 0.999, f"autotune: masked_rerank q={q} k={k} ids agree {agree} < 0.999")
    return dict(max_abs_err=float((gd[fin] - wd[fin]).abs().max()) if fin.any() else 0.0,
                ids_agree=agree, mean_candidates=candidates)


def phase_autotune(torch, n: int, cache_path: str) -> dict:
    """Phase 3b: the autotuner on the card (TUNE_RUNS), every candidate
    tried within the budget and bit for bit the default (``autotune``
    raises otherwise), each winner against the plain version; the winners
    saved to ``cache_path`` and the process's cache emptied, so the phases
    after this one launch the untuned geometry until a searcher loads it."""
    from repro_torch.kernels import autotune

    autotune.clear_cache()
    d, n_sub, sqrt_k = TUNE_SHAPE
    results = []
    for op, q, k in TUNE_RUNS:
        t0 = time.perf_counter()
        res = autotune.autotune(op, q=q, n=n, d=d, n_sub=n_sub, sqrt_k=sqrt_k, k=k,
                                budget_s=TUNE_BUDGET_S, impl="kernel", device="cuda")
        res["search_s"] = time.perf_counter() - t0
        check(len(res["trials"]) == len(autotune.CANDIDATES[op]),
              f"autotune {op} q={q} k={k}: {len(res['trials'])} candidates in the budget")
        for trial in res["trials"]:
            trial["geometry"] = tune_geometry(op, q, n, k, trial["blocks"])
        res.update(q=q, n=n, k=k, winner_geometry=tune_geometry(op, q, n, k, res["winner"]),
                   plain=tune_against_plain(torch, op, q, n, k, tuple(res["winner"])))
        print(f"autotune {op} q={q} k={k}: {json.dumps(res)}", flush=True)
        results.append(res)
    autotune.save_cache(cache_path)
    cache = json.loads(Path(cache_path).read_text())
    autotune.clear_cache()
    print(f"autotune: saved {len(cache)} entries: {json.dumps(cache)}", flush=True)
    return {"results": results, "cache": cache}


def tuned_kernels_on_the_path(torch, index, queries, tuned: dict) -> dict:
    """Both kernels on the masked-full path's own inputs for this batch
    (query-aware threshold), at the default and at the tuned (bq, bn) from
    the synthetic search, timed in turns (default, tuned, tuned, default;
    CUDA events); the outputs equal bit for bit."""
    from repro_torch.core import taco
    from repro_torch.core.selection import query_aware_threshold
    from repro_torch.kernels.autotune import DEFAULT_BLOCKS
    from repro_torch.kernels.masked_rerank import masked_rerank_cuda
    from repro_torch.kernels.schist import collision_bits, collision_table, schist_cuda

    sc, cfg = index.sc_index, index.cfg
    q, levels = queries.shape[0], cfg.n_subspaces + 1
    d1s, d2s, cells, taus, _ = taco._collision_inputs(sc, queries, cfg)
    bits = collision_bits(collision_table(d1s, d2s, taus))
    cells, data = cells.contiguous(), sc.data.to(torch.float32).contiguous()
    hist = schist_cuda(bits, cells, levels, q=q)
    thresh, demand = query_aware_threshold(hist, cfg.beta * sc.n, cfg.n_subspaces)
    thresh = thresh.to(torch.int32).contiguous()
    norms = taco.data_norms_of(sc).to(torch.float32).contiguous()
    calls = {("schist", None): lambda b: schist_cuda(bits, cells, levels, q=q, blocks=b)}
    for k in (10, 100):
        calls[("masked_rerank", k)] = (lambda b, k=k: masked_rerank_cuda(
            bits, cells, thresh, queries, data, norms, k, blocks=b))
    out = {"mean_candidates": float(demand.float().mean())}
    for (op, k), call in calls.items():
        default, best = DEFAULT_BLOCKS[op], tuned[op]
        got, want = call(best), call(default)
        same = (torch.equal(got, want) if op == "schist"
                else torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        check(same, f"autotune: {op} k={k} at the tuned {best} differs from the default")
        reps = 20 if op == "schist" else 5
        d1, t1, t2, d2 = (timed(torch, lambda b=b: call(b), reps)
                          for b in (default, best, best, default))
        out[op if k is None else f"{op}_k{k}"] = dict(
            default=list(default), tuned=list(best), default_ms=(d1 + d2) / 2,
            tuned_ms=(t1 + t2) / 2, turns_ms=[d1, t1, t2, d2])
    return out


def phase_autotune_search(torch, index, queries, masked_runs, cache_path: str,
                          cache: dict) -> dict:
    """The masked-full batch (SETTINGS) through searchers warm-loaded from
    the saved winners, beside untuned searchers in the same call: every
    tuned searcher loads the file's entries, the tuned run's last launches
    carry the 1000-query bucket's winners (the untuned run's the defaults),
    and ids and dists equal the untuned run's and the masked phase's bit
    for bit."""
    import numpy as np

    from repro_torch.kernels import autotune, cuda

    n = index.n
    q_bucket = autotune._bucket(queries.shape[0])
    backend = queries.device.type
    want = {op: tuple(cache[f"{op}|{backend}|f32|{q_bucket}|{autotune._bucket(n)}"])
            for op in autotune.OPS}
    autotune.clear_cache()
    cuda.reset_launch_counts()
    untuned = search_runs(torch, index, queries, SETTINGS)
    defaults = {op: cuda.launch_blocks[op] for op in autotune.OPS}
    check(defaults == autotune.DEFAULT_BLOCKS,
          f"autotune: the untuned searchers launched {defaults}")
    loaded = []

    def tuned_searcher(view):
        s = view.searcher("single", autotune_cache=cache_path)
        loaded.append(s.autotune_entries_loaded)
        return s

    tuned, launches = run_path(
        torch, "autotune_search",
        lambda: search_runs(torch, index, queries, SETTINGS, tuned_searcher),
        expect={"l2dist": 3 * len(SETTINGS)})
    got = {op: cuda.launch_blocks[op] for op in autotune.OPS}
    autotune.clear_cache()
    check(loaded == [len(cache)] * len(SETTINGS),
          f"autotune: searchers loaded {loaded} entries, the file has {len(cache)}")
    check(got == want, f"autotune: the tuned searchers launched {got}, the winners are {want}")
    kernels = tuned_kernels_on_the_path(torch, index, queries, want)
    rows = []
    for setting in SETTINGS:
        t, u, m = tuned[setting], untuned[setting], masked_runs[setting]
        for label, other in (("untuned", u), ("masked phase", m)):
            check(np.array_equal(t["ids"], other["ids"])
                  and np.array_equal(t["dists"].view(np.uint32), other["dists"].view(np.uint32)),
                  f"autotune: tuned masked-full {setting} differs from the {label} run")
        rows.append(dict(k=setting[0], selection=setting[1], tuned_s=t["seconds"],
                         untuned_s=u["seconds"]))
    out = {"entries_loaded": loaded, "launch_blocks": {op: list(b) for op, b in got.items()},
           "searches": rows, "kernels": kernels, "launches": launches}
    print(f"autotune search: {json.dumps(out)}", flush=True)
    return out


#: (label, BH, KV heads, S, T, hd, causal, dtype): granite-3-2b (32 query
#: heads of 2048/32 = 64; its 8 KV heads repeated to 32 by the caller, as
#: the op takes equal BH) and qwen1.5-4b (MHA, 20 heads of 128) at
#: S = T = 4096, and a ragged non-causal case. Both head dims run in f32 and
#: bf16. The first row is the one in the kernels line.
FLASH_CASES = (
    ("granite-3-2b bf16", 32, 8, 4096, 4096, 64, True, "bfloat16"),
    ("granite-3-2b f32", 32, 8, 4096, 4096, 64, True, "float32"),
    ("qwen1.5-4b bf16", 20, 20, 4096, 4096, 128, True, "bfloat16"),
    ("qwen1.5-4b f32", 20, 20, 4096, 4096, 128, True, "float32"),
    ("ragged non-causal bf16", 32, 32, 4000, 4097, 64, False, "bfloat16"),
)
#: rtol = atol against the plain version in the same dtype. f32 keeps the
#: reference tests' 2e-5 (tests/test_kernels.py:136). bf16 is tighter than
#: their 5e-2, which was set at 32 keys: at 4096 keys a late row's output is
#: about 0.03, so 1e-2 sits above one bf16 rounding flip of an output below
#: 1 (<= 0.0039) and below a typical late value.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
#: bf16 is also held against the plain version run in f32 on the same
#: (upcast) inputs: the kernel accumulates in f32 and rounds once, so it may
#: differ by one bf16 rounding (half an ulp, at most 2^-8 relative; 2^-7 is
#: allowed) plus the f32 tolerance twice over. This holds every row, late
#: ones too, to about one percent of its value.
FLASH_BF16_VS_F32 = (2.0 ** -7, 4e-5)


def phase_flash(torch) -> dict:
    """Phase 4: ops.flash_attention on every case (the path run), then each
    case against the plain version, timed beside its bound and SDPA."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = []
    for label, bh, kv_heads, s, t, hd, causal, dtype in FLASH_CASES:
        dt = getattr(torch, dtype)
        q = torch.randn((bh, s, hd), generator=gen, device="cuda").to(dt)
        k, v = (torch.randn((kv_heads, t, hd), generator=gen, device="cuda").to(dt)
                .repeat_interleave(bh // kv_heads, dim=0) for _ in range(2))
        inputs.append((q, k, v, causal))
    copies = fa.aligned_copies
    outs, launches = run_path(torch, "flash",
                              lambda: [ops.flash_attention(*a) for a in inputs])
    copies = fa.aligned_copies - copies
    check(copies == 0, f"flash: {copies} aligned copies on the path's shapes")
    rows = []
    for (label, bh, _kv, s, t, hd, causal, dtype), (q, k, v, _c), got in zip(
            FLASH_CASES, inputs, outs):
        want = flash_attention_plain(q, k, v, causal)
        err = float((got.float() - want.float()).abs().max())
        tol = FLASH_TOL[dtype]
        check(tuple(got.shape) == (bh, s, hd) and got.dtype == q.dtype, f"flash {label} shape")
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"flash {label}: max abs err {err} above {tol}")
        err_f32 = used = None
        if dtype == "bfloat16":
            want = flash_attention_plain(q.float(), k.float(), v.float(), causal)
            diff = (got.float() - want).abs()
            rtol, atol = FLASH_BF16_VS_F32
            err_f32 = float(diff.max())
            # worst share of the allowed error any element uses (<= 1 passes)
            used = float((diff / (atol + rtol * want.abs())).max())
            check(used <= 1.0, f"flash {label}: {used} of the allowed error against "
                               f"the f32 plain version (max abs err {err_f32})")
            del diff
        del want
        torch.cuda.empty_cache()
        # unmasked (query, key) pairs: top-left causal keeps min(q + 1, T) keys
        pairs = bh * (sum(min(i + 1, t) for i in range(s)) if causal else s * t)
        flops = 4 * hd * pairs
        nbytes = q.element_size() * bh * hd * (2 * s + 2 * t)
        b32, by32 = bound_ms(nbytes, flops, F32_OPS)
        b16, by16 = bound_ms(nbytes, flops, BF16_TENSOR_OPS)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row = dict(case=label, shape=f"BH {bh}, S {s}, T {t}, hd {hd}, causal {causal}, {dtype}",
                   max_abs_err=err, tolerance=tol, max_abs_err_vs_f32=err_f32,
                   share_of_allowed_vs_f32=used,
                   ms=timed(torch, lambda: flash_attention_cuda(q, k, v, causal), 5),
                   plain_ms=timed(torch, lambda: flash_attention_plain(q, k, v, causal), 2),
                   library_ms=timed(torch, lambda: sdpa(q[None], k[None], v[None],
                                                        is_causal=causal), 10),
                   gflop=flops / 1e9, bound_f32_ms=b32, bound_f32_by=by32,
                   bound_bf16_tensor_ms=b16, bound_bf16_tensor_by=by16)
        # the least time for the work at its input type's peak rate: f32 on
        # the CUDA cores, bf16 on the tensor cores
        row["bound_ms"], row["bound_by"] = (b32, by32) if dtype == "float32" else (b16, by16)
        if dtype == "bfloat16":
            # the kernel's own work: P.V twice (P as bf16 hi + lo), 6 hd a pair
            row["bound_split_ms"] = bound_ms(nbytes, 6 * hd * pairs, BF16_TENSOR_OPS)[0]
        row["tflops"] = flops / row["ms"] / 1e9
        row["vs_library"] = row["ms"] / row["library_ms"]
        print(f"flash: {json.dumps(row)}", flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    return {"cases": rows, "launches": launches, "aligned_copies": copies}


def profile_search(torch, view, queries, label: str) -> dict:
    """Device time by kernel over one k=10 search of ``view`` (an index
    with the pipeline to profile); see :func:`profile_call`."""
    return profile_call(torch, lambda: view.search_with_stats(queries, k=10), label)


def profile_call(torch, fn, label: str) -> dict:
    """Device time by kernel over one call of ``fn``, from torch.profiler,
    and the device's busy share of the window. Only device-side events
    count: a host-side op (``aten::...``) also reports the device time of
    the kernels it launched, and summing both would count that time twice;
    nor do the stage spans the profiler copies onto the card's timeline
    (:func:`profile_rows`). Also kept: every kernel's time and count (``device_ops``, for sums by
    kind), the number of kernels, and the top host operations by their own
    (self) CPU time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, host = profile_rows(prof.key_averages())
    rows.sort(reverse=True)
    host.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if total == 0:
        print(f"profile {label}: no device time in the trace (not measured)", flush=True)
        return {"wall_us": wall_us, "device_busy_us": None}
    kernels = sum(r[1] for r in rows)
    print(f"profile {label}: window {wall_us:.0f} us (profiled), device busy {total:.0f} us "
          f"({100 * total / wall_us:.1f}%), {kernels} kernels", flush=True)
    for dev_us, count, key in rows[:12]:
        print(f"profile {label}: {dev_us:10.0f} us {100 * dev_us / total:5.1f}% x{count:<5d} "
              f"{key[:90]}", flush=True)
    for us, count, key in host[:5]:
        print(f"profile {label}: host {us:10.0f} us x{count:<6d} {key[:80]}", flush=True)
    return {"wall_us": wall_us, "device_busy_us": total, "kernels": kernels,
            "top_device": [dict(us=us, count=c, op=key) for us, c, key in rows[:12]],
            "device_ops": [[us, c, key[:120]] for us, c, key in rows],
            "top_host": [dict(us=us, count=c, op=key) for us, c, key in host[:10]]}


def profile_build(torch, corpus_np, cfg, label: str):
    """(index, build seconds, profile): AnnIndex.build from host memory under
    torch.profiler. The profile holds the host clock of the window, the
    device's busy time (device-side events only, as in
    :func:`profile_search`), the top device operations, and the top host
    operations by their own (self) CPU time, which shows the host-side work
    outside the device's: the CPU generator's ``randperm``s, the pageable
    host-to-device copy of the corpus, ``eigh``'s solver, one-time set-up
    in the process's first build, and the waits on the device."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.ann import AnnIndex

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        index = AnnIndex.build(corpus_np, cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    wall_us = build_s * 1e6
    print(f"{label}: build {build_s:.3f} s (profiled), index_bytes {index.index_bytes}",
          flush=True)
    device, host = profile_rows(prof.key_averages())
    device.sort(reverse=True)
    host.sort(reverse=True)
    busy = sum(r[0] for r in device)
    out = dict(wall_us=wall_us, device_busy_us=busy, host_self_us=sum(r[0] for r in host),
               top_device=[dict(us=us, count=c, op=key) for us, c, key in device[:12]],
               top_host=[dict(us=us, count=c, op=key) for us, c, key in host[:15]])
    if busy == 0:
        print("profile build: no device time in the trace (not measured)", flush=True)
    print(f"profile build: window {wall_us:.0f} us (profiled), device busy {busy:.0f} us "
          f"({100 * busy / wall_us:.1f}%), host ops' self time {out['host_self_us']:.0f} us",
          flush=True)
    for us, count, key in device[:12]:
        print(f"profile build: device {us:10.0f} us {100 * us / wall_us:5.1f}% x{count:<5d} "
              f"{key[:90]}", flush=True)
    for us, count, key in host[:15]:
        print(f"profile build: host   {us:10.0f} us {100 * us / wall_us:5.1f}% x{count:<5d} "
              f"{key[:90]}", flush=True)
    return index, build_s, out


def integer_build_check(torch) -> dict:
    """A SuCo index over an integer-valued 10^5 x 128 corpus (values in
    [-20, 20]) built on the card, the halves of 10/11 and 11/12 dims in one
    lockstep k-means padded to 12, against one k-means per (subspace, half)
    run on the card in this call: every array bit for bit. Float32 sums of
    integers below 2^24 are exact in any order, so the Lloyd sums of 12
    pairs and of one cannot differ; the distances to the non-integer means
    then agree only if the batched kernel's arithmetic is the single-pair
    one."""
    import numpy as np

    from repro_torch.clustering import kmeans
    from repro_torch.core import imi, taco
    from repro_torch.core.config import suco_config

    data = np.random.default_rng(7).integers(-20, 21, (100_000, 128)).astype(np.float32)
    cfg = suco_config(n_subspaces=6, n_clusters=1024, alpha=0.05, beta=0.005, k=10,
                      use_kernels=True)
    index = taco.build(data, cfg)
    projected = taco._project(index, torch.as_tensor(data, device="cuda"))
    gen = torch.Generator().manual_seed(cfg.seed)
    for s, ((lo, hi), sub) in enumerate(zip(taco._sub_slices(index.sub_dims), index.subspaces)):
        s1, _s2 = imi.split_halves(hi - lo)
        c1, a1 = kmeans(projected[:, lo:lo + s1], cfg.sqrt_k, cfg.kmeans_iters, cfg.kmeans_init,
                        generator=gen)
        c2, a2 = kmeans(projected[:, lo + s1:hi], cfg.sqrt_k, cfg.kmeans_iters, cfg.kmeans_init,
                        generator=gen)
        same = (torch.equal(sub.centroids1, c1) and torch.equal(sub.centroids2, c2)
                and torch.equal(sub.assign1, a1) and torch.equal(sub.assign2, a2)
                and torch.equal(sub.cell_sizes, imi.cell_sizes(a1, a2, cfg.sqrt_k)))
        check(same, f"integer SuCo build: subspace {s} differs from the per-pair k-means")
    row = dict(n=data.shape[0], sub_dims=list(index.sub_dims), subspaces=len(index.subspaces),
               bitwise=True)
    print(f"build: integer SuCo index equals the per-pair k-means: {json.dumps(row)}", flush=True)
    return row


def run_path(torch, name: str, fn, expect: dict | None = None):
    """Run ``fn`` with every launch count set to 0 just before it; return
    its result and the counts read just after. Fails if a kernel of the
    path was launched no time, or if a kernel named in ``expect`` was not
    launched exactly that many times (``l2dist`` once a query batch,
    ``kmeans_assign`` once a Lloyd iteration and once more a build)."""
    from repro_torch.kernels import cuda

    cuda.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(cuda.launch_counts)
    print(f"{name}: launches {json.dumps(launches)}", flush=True)
    for kernel in PATHS[name]:
        check(launches[kernel] > 0, f"kernel {kernel} was not launched on the {name} path")
    for kernel, count in (expect or {}).items():
        check(launches[kernel] == count,
              f"{name}: {kernel} launched {launches[kernel]} times, expected {count}")
    return out, launches


def build_index(torch, corpus_np, cfg, label: str):
    """(index, build seconds): AnnIndex.build on the card, synchronized."""
    from repro_torch.ann import AnnIndex

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = AnnIndex.build(corpus_np, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"{label}: build {build_s:.3f} s, index_bytes {index.index_bytes}", flush=True)
    return index, build_s


def search_runs(torch, index, queries, settings, searcher_of=None) -> dict:
    """For each (k, selection): seconds (median of 3 synchronized host-clock
    runs of the whole batch through the facade, which pads it to its
    bucket and returns numpy, or through ``searcher_of(view)``), ids,
    dists, stats and the peak bytes allocated."""
    runs = {}
    for k, sel in settings:
        view = index.replace_cfg(selection=sel)
        if searcher_of is not None:
            view = searcher_of(view)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _rep in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, dists, stats = view.search_with_stats(queries, k=k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        runs[(k, sel)] = dict(seconds=sorted(times)[1], ids=ids, dists=dists, stats=stats,
                              peak_bytes=torch.cuda.max_memory_allocated())
    return runs


def against_plain(torch, index, queries, gt, run, k: int, sel: str, label: str) -> dict:
    """The run's row: QPS, recall@10, and the plain path (use_kernels=False)
    on the same index, held to the stated limits."""
    import numpy as np

    from repro_torch.utils import recall_at_k

    ids, dists, stats = run["ids"], run["dists"], run["stats"]
    check(tuple(ids.shape) == (queries.shape[0], k), f"{label} ids shape k={k}")
    check(bool(np.isfinite(dists[:, :10]).all()), f"{label} finite top-10 dists k={k} {sel}")
    rec = recall_at_k(ids, gt, 10)
    plain = index.replace_cfg(selection=sel, use_kernels=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pids, _pd, _ps = plain.search_with_stats(queries, k=k)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del _ps
    prec = recall_at_k(pids, gt, 10)
    same = float(np.mean(pids == ids))
    secs = run["seconds"]
    row = dict(k=k, selection=sel, seconds=secs, qps=queries.shape[0] / secs,
               recall_at_10=rec, plain_recall_at_10=prec, plain_seconds=plain_s,
               ids_same_as_plain=same,
               mean_candidate_count=float(stats["candidate_count"].mean()),
               truncated_share=float(stats["truncated"].mean()),
               peak_gib=run["peak_bytes"] / 2**30)
    check(abs(rec - prec) <= 0.005, f"{label} recall kernel {rec} vs plain {prec} k={k} {sel}")
    check(same >= 0.999, f"{label} ids same as plain {same} < 0.999 k={k} {sel}")
    return row


SETTINGS = [(k, sel) for k in (10, 100) for sel in ("query_aware", "fixed")]


def phase_masked(torch, corpus_np, queries, gt) -> tuple:
    """Phase 5: build the TaCo index and answer the batch with the
    masked-full pipeline through AnnIndex. Returns (index, summary, runs)."""
    from repro_torch.core.config import taco_config

    cfg = taco_config(n_subspaces=6, subspace_dim=8, n_clusters=1024, alpha=0.05,
                      beta=0.005, k=10, rerank="masked_full", use_kernels=True)
    # the process's first build, profiled; then one more, unprofiled
    (index, build_s, build_profile), build_launches = run_path(
        torch, "build", lambda: profile_build(torch, corpus_np, cfg, "masked"),
        expect={"kmeans_assign": cfg.kmeans_iters + 1})
    warm_build_s = build_index(torch, corpus_np, cfg, "masked again")[1]
    integer_build = integer_build_check(torch)
    index.search(queries[:8])  # warm-up: caches the per-index cell ids
    runs, launches = run_path(torch, "masked", lambda: search_runs(torch, index, queries, SETTINGS),
                              expect={"l2dist": 3 * len(SETTINGS)})
    profile_search(torch, index, queries, "masked")
    summary = {"build_s": build_s, "warm_build_s": warm_build_s,
               "index_bytes": index.index_bytes, "searches": [],
               "build_launches": build_launches, "build_profile": build_profile,
               "integer_build": integer_build, "launches": launches}
    for (k, sel), run in runs.items():
        row = against_plain(torch, index, queries, gt, run, k, sel, "masked")
        print(f"masked: search {json.dumps(row)}", flush=True)
        summary["searches"].append(row)
    return index, summary, runs


def phase_gather(torch, taco_index, corpus_np, queries, gt, masked_runs) -> tuple:
    """Phase 6: the default gather pipeline on the TaCo index, then on a
    SuCo index built at full width, each run held against the plain path
    (and the query-aware runs against masked-full); the heap and linear
    activations against sort on the first 100 queries. Returns (summary,
    the SuCo index)."""
    import dataclasses

    import numpy as np

    from repro_torch.core.config import suco_config
    from repro_torch.core.taco import query_with_stats

    summary = {"searches": []}
    gather = taco_index.replace_cfg(rerank="gather")
    gather.search(queries[:8])  # warm-up
    runs, launches = run_path(torch, "gather",
                              lambda: search_runs(torch, gather, queries, SETTINGS),
                              expect={"l2dist": 3 * len(SETTINGS)})
    summary["launches"] = launches
    profile_search(torch, gather, queries, "gather")
    for (k, sel), run in runs.items():
        row = against_plain(torch, gather, queries, gt, run, k, sel, "gather")
        if sel == "query_aware":
            kept = ~run["stats"]["truncated"]
            masked_ids = masked_runs[(k, sel)]["ids"]
            same = float(np.mean(run["ids"][kept] == masked_ids[kept]))
            row["ids_same_as_masked_full"] = same
            check(same >= 0.999, f"gather ids same as masked-full {same} < 0.999 k={k}")
        row["config"] = "taco"
        print(f"gather: search {json.dumps(row)}", flush=True)
        summary["searches"].append(row)
    del runs
    torch.cuda.empty_cache()

    cfg = suco_config(n_subspaces=6, n_clusters=1024, alpha=0.05, beta=0.005, k=10,
                      use_kernels=True)
    (suco, build_s), build_launches = run_path(
        torch, "build", lambda: build_index(torch, corpus_np, cfg, "gather suco"),
        expect={"kmeans_assign": cfg.kmeans_iters + 1})
    summary.update(suco_build_s=build_s, suco_build_launches=build_launches)
    suco.search(queries[:8])
    settings = [(k, "fixed") for k in (10, 100)]
    runs, launches = run_path(torch, "suco_gather",
                              lambda: search_runs(torch, suco, queries, settings),
                              expect={"l2dist": 3 * len(settings)})
    summary["suco_launches"] = launches
    for (k, sel), run in runs.items():
        row = against_plain(torch, suco, queries, gt, run, k, sel, "gather suco")
        row["config"] = "suco"
        print(f"gather: search {json.dumps(row)}", flush=True)
        summary["searches"].append(row)
    del runs
    torch.cuda.empty_cache()

    # activations: heap and linear must find sort's tau on the card; tau and
    # the retrieved counts are internal stats, so read from query_with_stats
    head = queries[:100]
    _ids, _d, want = query_with_stats(gather.sc_index, head, gather.cfg, k=10)
    summary["activations"] = {}
    for method in ("heap", "linear"):
        cfg = dataclasses.replace(gather.cfg, activation=method)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _ids, _d, got = query_with_stats(gather.sc_index, head, cfg, k=10)
        torch.cuda.synchronize()
        row = dict(seconds=time.perf_counter() - t0,
                   taus_equal=bool(torch.equal(got["taus"], want["taus"])),
                   retrieved_differ=int((got["retrieved"] != want["retrieved"]).sum()),
                   problems=int(want["taus"].numel()))
        print(f"gather: activation {method} vs sort, first 100 queries: {json.dumps(row)}",
              flush=True)
        check(row["taus_equal"], f"activation {method}: tau differs from sort")
        summary["activations"][method] = row
    return summary, suco


IVF_NPROBES = (16, 64)


def integer_ivf_check(torch, d: int = 128, n: int = 100_000, label: str = "baselines") -> dict:
    """IVF's k-means over an integer-valued n x d corpus (values in
    [-20, 20]) at 1024 lists, through the kernel (the tiled path; past 128
    dims the wide one) and through the plain version on the card, from the
    same draw, each Lloyd update's means rounded to integers so that every
    distance is exact: centroids, assignments, lists and the ids and
    distances of ivf_query bit for bit."""
    import numpy as np

    from repro_torch.clustering import kmeans_assign, lloyd_step
    from repro_torch.core.ivf import IVFIndex, ivf_lists, ivf_query

    data = torch.as_tensor(np.random.default_rng(8).integers(-20, 21, (n, d))
                           .astype(np.float32), device="cuda")
    queries = data[:100] + 1.0
    init = data[torch.randperm(data.shape[0], generator=torch.Generator().manual_seed(0))
                [:IVF_LISTS].to(data.device)]
    out = {}
    for impl in ("kernel", "torch"):
        c = init
        for _ in range(10):
            c, _a = lloyd_step(data, c, impl=impl)
            c = torch.round(c)
        assign, dmin = kmeans_assign(data, c, impl=impl)
        index = IVFIndex(centroids=c, lists=ivf_lists(assign, IVF_LISTS), data=data)
        out[impl] = (c, assign, dmin, index.lists, *ivf_query(index, queries, 16, 10))
    same = all(torch.equal(a, b) for a, b in zip(out["kernel"], out["torch"]))
    check(same, f"{label}: integer IVF build: the kernel path differs from the plain path")
    row = dict(n=data.shape[0], d=d, lists=IVF_LISTS, lmax=int(out["kernel"][3].shape[1]),
               bitwise=True)
    print(f"{label}: integer IVF build equals the plain path: {json.dumps(row)}", flush=True)
    return row


def phase_baselines(torch, corpus_np, queries, gt, gather) -> dict:
    """The paper's baselines on the masked phase's corpus, queries and
    ground truth: IVF-Flat (1024 lists, 10 Lloyd iterations, nprobe 16 and
    64) and SC-Linear at the SuCo config, each at k = 10 with QPS (median of
    3) and recall@10, SC-Linear's beside TaCo's and SuCo's from the gather
    phase; then the integer IVF build against the plain path."""
    from repro_torch.core import SCLinear, build_ivf, ivf_query
    from repro_torch.core.config import suco_config
    from repro_torch.utils import recall_at_k

    q = queries.shape[0]

    def build():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = build_ivf(corpus_np, IVF_LISTS, kmeans_iters=10, seed=0)
        torch.cuda.synchronize()
        return index, time.perf_counter() - t0

    (index, build_s), build_launches = run_path(torch, "ivf_build", build,
                                                expect={"kmeans_assign": 11})
    lists = index.lists
    counts = (lists >= 0).sum(1)
    ivf = dict(build_s=build_s, lists=IVF_LISTS, lmax=int(lists.shape[1]),
               mean_list=float(counts.float().mean()), empty_lists=int((counts == 0).sum()),
               index_bytes=index.index_bytes, searches=[])
    check(int(counts.sum()) == corpus_np.shape[0], "ivf: the lists do not hold every point")
    print(f"baselines: ivf build {json.dumps(ivf)}", flush=True)
    for nprobe in IVF_NPROBES:
        ivf_query(index, queries[:8], nprobe, 10)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        secs, (ids, dists) = _median_s(torch, lambda: ivf_query(index, queries, nprobe, 10))
        check(tuple(ids.shape) == (q, 10) and bool(torch.isfinite(dists).all()),
              f"ivf nprobe {nprobe}: shape or non-finite distances")
        row = dict(nprobe=nprobe, k=10, seconds=secs, qps=q / secs,
                   recall_at_10=recall_at_k(ids, gt, 10),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        print(f"baselines: ivf search {json.dumps(row)}", flush=True)
        ivf["searches"].append(row)
    check(ivf["searches"][1]["recall_at_10"] > ivf["searches"][0]["recall_at_10"],
          "ivf: recall does not rise from nprobe 16 to 64")
    del index, lists
    torch.cuda.empty_cache()

    cfg = suco_config(n_subspaces=6, n_clusters=1024, alpha=0.05, beta=0.005, k=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lin = SCLinear(corpus_np, cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    lin.query(queries[:8])  # warm-up
    torch.cuda.reset_peak_memory_stats()
    secs, (ids, dists) = _median_s(torch, lambda: lin.query(queries))
    check(tuple(ids.shape) == (q, 10) and bool(torch.isfinite(dists).all()),
          "sclinear: shape or non-finite distances")
    taco_row = next(r for r in gather["searches"]
                    if r["config"] == "taco" and r["k"] == 10 and r["selection"] == "query_aware")
    suco_row = next(r for r in gather["searches"] if r["config"] == "suco" and r["k"] == 10)
    sclinear = dict(setup_s=setup_s, seconds=secs, qps=q / secs,
                    recall_at_10=recall_at_k(ids, gt, 10),
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    taco_recall_at_10=taco_row["recall_at_10"], taco_qps=taco_row["qps"],
                    suco_recall_at_10=suco_row["recall_at_10"], suco_qps=suco_row["qps"])
    print(f"baselines: sclinear {json.dumps(sclinear)}", flush=True)
    del lin, ids, dists
    torch.cuda.empty_cache()
    return {"ivf": ivf, "sclinear": sclinear, "integer_ivf": integer_ivf_check(torch),
            "launches": build_launches}


#: the wide phase's corpus width: GIST1M's 960 dims (the paper's
#: "high-dimensional" setting), 10^6 points and 1000 held-out queries
WIDE_D = 960
#: TaCo over every dimension of the wide corpus (N_s x s = 20 x 48 = 960),
#: K = 4096 cells: a 32-query tile's collision table is 20 x 4096 words
#: (320 KB), past shared memory, and N_s is past the fast kernels' 16
WIDE_TACO = dict(n_subspaces=20, subspace_dim=48, n_clusters=4096, alpha=0.05, beta=0.005)
WIDE_SETTINGS = [(10, "query_aware"), (10, "fixed")]
#: the collision kernels' cases at the reference's most subspaces (N_s + 1
#: = 128 histogram levels): (N_s, sqrt_k); K = 1024, n and Q the main path's
WIDE_N_SUB, WIDE_SQRT_K = 127, 32
#: masked_rerank's k past the 1024 it once took, on the main index, at a
#: budget (beta) whose candidates fill k = 8192
WIDE_KS = (1025, 2048, 8192)
WIDE_KS_BETA = 0.01
#: the integer 960-dim IVF build's corpus size
WIDE_INT_N = 100_000


def wide_assign_case(torch, corpus, c) -> dict:
    """kmeans_assign at IVF-Flat's wide shape, the corpus (10^6, 960)
    against the build's 1024 centroids: the wide tiled path. Assignments
    against the plain version (>= 99.9 % equal, every other one a
    near-tie) and distances allclose; timed beside the plain version,
    ``torch.cdist(x, c).min(-1)`` (TF32 off: the float32 matmul default)
    and its bound, as in ivf_assign_case: the screen's products at the TF32
    tensor-core rate or the bytes (``bound_ms``), the CUDA-core f32 figure
    beside it (``cuda_core_bound_ms``). Also kept: rechecks a point, the
    launch's runs of row blocks and the device times, a call, of the screen
    and of the two pre-passes."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels.kmeans_assign import (
        TILE_POINTS,
        kmeans_assign_cuda,
        kmeans_assign_plain,
        last_tiled,
        wide_run_blocks,
    )

    n, w = corpus.shape
    k = c.shape[0]
    # the launch's runs of row blocks: each runs the points' pre-pass and
    # the screen once, and the profiler times each such kernel a run
    sms = torch.cuda.get_device_properties(corpus.device).multi_processor_count
    run_blocks = wide_run_blocks(1, n, w, sms)
    blocks = -(-n // TILE_POINTS)
    runs = -(-blocks // run_blocks)

    def per_call(kernel):
        ms = kernel_device_ms(torch, lambda: kmeans_assign_cuda(corpus, c), kernel, 3)
        return None if ms is None else runs * ms

    cuda.reset_launch_counts()
    ga, gd = kmeans_assign_cuda(corpus, c)
    check(cuda.launch_layouts["kmeans_assign"] == {"tiled_wide": 1},
          f"wide kmeans_assign: launched {cuda.launch_layouts['kmeans_assign']}")
    rechecks = int(last_tiled["rechecks"].item())
    check(last_tiled["points"] == n and n <= rechecks <= n * k,
          f"wide kmeans_assign: {rechecks} rechecks for {n} points")
    wa, wd = kmeans_assign_plain(corpus, c)
    differ = torch.nonzero(ga != wa)[:, 0]
    agree = 1.0 - differ.numel() / n
    check(agree >= 0.999, f"wide kmeans_assign: assignments agree on {agree} < 0.999")
    if differ.numel():
        xd = corpus[differ]
        scale = (xd * xd).sum(1) + (c * c).sum(1).max()
        picked = ((xd - c[ga[differ].long()]) ** 2).sum(1)
        check(bool((picked - wd[differ] <= IVF_NEAR_TIE * scale).all()),
              "wide kmeans_assign: a differing assignment is not a near-tie")
    atol = 1e-5 * float((corpus * corpus).sum(1).max() + (c * c).sum(1).max())
    check(torch.allclose(gd, wd, rtol=1e-5, atol=atol), "wide kmeans_assign: distances")
    nbytes = 4 * (n * w + k * w + 2 * n)
    b, by = bound_ms(nbytes, 2 * n * k * w, TF32_TENSOR_OPS)
    core_b, _ = bound_ms(nbytes, n * k * (2 * w + 3) + 2 * w * (n + k))
    row = dict(max_abs_err=float((gd - wd).abs().max()), assign_agree=agree,
               differing=int(differ.numel()),
               ms=timed(torch, lambda: kmeans_assign_cuda(corpus, c), 5),
               plain_ms=timed(torch, lambda: kmeans_assign_plain(corpus, c), 1),
               bound_ms=b, bound_by=by, cuda_core_bound_ms=core_b,
               bytes_bound_ms=nbytes / HBM_BPS * 1e3,
               library_ms=timed(torch, lambda: torch.cdist(corpus, c).min(dim=-1), 2),
               rechecks_per_point=rechecks / n,
               runs=runs, run_blocks=run_blocks,
               screen_device_ms=per_call("wide::wide_kernel"),
               points_prep_device_ms=per_call("prep_points_kernel"),
               centroid_prep_device_ms=kernel_device_ms(
                   torch, lambda: kmeans_assign_cuda(corpus, c), "prep_wide_kernel", 3),
               shape=f"x ({n}, {w}), c ({k}, {w}), tiled_wide")
    print(f"kernel kmeans_assign wide: {json.dumps(row)}", flush=True)
    return row


def wide_ivf(torch, corpus, queries, gt) -> dict:
    """IVF-Flat over the wide corpus (1024 lists, 10 Lloyd iterations): the
    build's 11 kmeans_assign launches all through the wide tiled path,
    queries at nprobe 16 and 64 (QPS median of 3, recall@10 rising), one
    assignment against the plain version (wide_assign_case) and an
    integer-valued 960-dim build bit for bit against the plain path."""
    from repro_torch.core import build_ivf, ivf_query
    from repro_torch.kernels import cuda
    from repro_torch.utils import recall_at_k

    q = queries.shape[0]

    def build():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = build_ivf(corpus, IVF_LISTS, kmeans_iters=10, seed=0)
        torch.cuda.synchronize()
        return index, time.perf_counter() - t0

    (index, build_s), launches = run_path(torch, "wide_ivf_build", build,
                                          expect={"kmeans_assign": 11})
    layouts = dict(cuda.launch_layouts["kmeans_assign"])
    check(layouts == {"tiled_wide": 11}, f"wide ivf build: kmeans_assign launched {layouts}")
    counts = (index.lists >= 0).sum(1)
    check(int(counts.sum()) == corpus.shape[0], "wide ivf: the lists do not hold every point")
    out = dict(build_s=build_s, lists=IVF_LISTS, lmax=int(index.lists.shape[1]),
               empty_lists=int((counts == 0).sum()), index_bytes=index.index_bytes,
               layouts=layouts, searches=[], launches=launches)
    print(f"wide: ivf build {json.dumps({k: v for k, v in out.items() if k != 'searches'})}",
          flush=True)
    for nprobe in IVF_NPROBES:
        ivf_query(index, queries[:8], nprobe, 10)  # warm-up
        secs, (ids, dists) = _median_s(torch, lambda: ivf_query(index, queries, nprobe, 10))
        check(tuple(ids.shape) == (q, 10) and bool(torch.isfinite(dists).all()),
              f"wide ivf nprobe {nprobe}: shape or non-finite distances")
        row = dict(nprobe=nprobe, k=10, seconds=secs, qps=q / secs,
                   recall_at_10=recall_at_k(ids, gt, 10))
        print(f"wide: ivf search {json.dumps(row)}", flush=True)
        out["searches"].append(row)
    check(out["searches"][1]["recall_at_10"] > out["searches"][0]["recall_at_10"],
          "wide ivf: recall does not rise from nprobe 16 to 64")
    out["assign"] = wide_assign_case(torch, corpus, index.centroids)
    del index
    torch.cuda.empty_cache()
    out["integer"] = integer_ivf_check(torch, WIDE_D, WIDE_INT_N, "wide")
    return out


def wide_kernel_rows(torch, label, bits, cells, data, queries, k, n_sub, k2) -> dict:
    """schist and scscore bit for bit against their plain versions on these
    inputs, masked_rerank's ids (>= 99.9 %) and filled distances against
    its plain version (at ``k``, the query-aware threshold at beta 0.005
    off the histogram), each launch counted where its table lived; each
    timed beside its plain version and bound, in rows for the kernels
    line."""
    from repro_torch.core.selection import query_aware_threshold
    from repro_torch.kernels import cuda
    from repro_torch.kernels.masked_rerank import (
        masked_rerank_cuda,
        masked_rerank_plain,
        rerank_geometry,
    )
    from repro_torch.kernels.schist import schist_cuda, schist_geometry, schist_plain
    from repro_torch.kernels.scscore import scscore_cuda, scscore_plain, scscore_table

    q, n = queries.shape[0], cells.shape[1]
    d = data.shape[1]
    nbits = bits.numel() * 4
    cuda.reset_launch_counts()
    hist = schist_cuda(bits, cells, n_sub + 1, q=q)
    sc = scscore_cuda(bits, cells, q=q)
    layouts = {name: dict(cuda.launch_layouts[name]) for name in ("schist", "scscore")}
    check(torch.equal(hist, schist_plain(bits, cells, n_sub + 1, q=q)), f"{label}: schist")
    check(torch.equal(sc, scscore_plain(bits, cells, q=q)), f"{label}: scscore")
    del sc
    torch.cuda.empty_cache()
    rows = {}
    g = schist_geometry(q, n_sub, k2)
    b, by = bound_ms(4 * n_sub * n + nbits + 4 * q * (n_sub + 1), q * n * n_sub)
    rows["schist"] = dict(
        max_abs_err=0.0, ms=timed(torch, lambda: schist_cuda(bits, cells, n_sub + 1, q=q), 3),
        plain_ms=timed(torch, lambda: schist_plain(bits, cells, n_sub + 1, q=q), 1),
        bound_ms=b, bound_by=by, library_ms=None, layout=layouts["schist"],
        geometry=g._asdict(), shape=f"Q {q}, N_s {n_sub}, K {k2}, n {n}")
    b, by = bound_ms(4 * q * n + 4 * n_sub * n + nbits, q * n * n_sub)
    rows["scscore"] = dict(
        max_abs_err=0.0, ms=timed(torch, lambda: scscore_cuda(bits, cells, q=q), 3),
        plain_ms=timed(torch, lambda: scscore_plain(bits, cells, q=q), 1),
        bound_ms=b, bound_by=by, library_ms=None, layout=layouts["scscore"],
        table=scscore_table(n_sub, k2), shape=f"Q {q}, N_s {n_sub}, K {k2}, n {n}")
    torch.cuda.empty_cache()
    thresh, demand = query_aware_threshold(hist, 0.005 * n, n_sub)
    total = float(demand.sum())
    norms = (data * data).sum(1)
    args = (bits, cells, thresh, queries, data, norms)
    cuda.reset_launch_counts()
    gd, gi = masked_rerank_cuda(*args, k)
    layouts["masked_rerank"] = dict(cuda.launch_layouts["masked_rerank"])
    wd, wi = masked_rerank_plain(*args, k)
    agree = float((gi == wi).float().mean())
    fin = torch.isfinite(wd)
    check(torch.equal(fin, torch.isfinite(gd)), f"{label}: masked_rerank filled slots")
    atol = 1e-5 * float((queries * queries).sum(1).max() + norms.max())
    check(torch.allclose(gd[fin], wd[fin], rtol=1e-5, atol=atol),
          f"{label}: masked_rerank distances")
    check(agree >= 0.999, f"{label}: masked_rerank ids agree {agree} < 0.999")
    b, by = bound_ms(
        4 * n_sub * n + nbits + 4 * q + 4 * q * d + 4 * d * min(n, total) + 4 * n + 8 * q * k,
        q * n * n_sub + total * (2 * d + 3))
    rows["masked_rerank"] = dict(
        max_abs_err=float((gd[fin] - wd[fin]).abs().max()) if fin.any() else 0.0,
        ms=timed(torch, lambda: masked_rerank_cuda(*args, k), 3),
        plain_ms=timed(torch, lambda: masked_rerank_plain(*args, k), 1),
        bound_ms=b, bound_by=by, library_ms=None, ids_agree=agree,
        mean_candidates=total / q, layout=layouts["masked_rerank"],
        geometry=rerank_geometry(n, k, n_sub, k2, d)._asdict(),
        shape=f"Q {q}, N_s {n_sub}, K {k2}, n {n}, d {d}, k {k}")
    for name, row in rows.items():
        print(f"kernel {name} {label}: {json.dumps(row)}", flush=True)
    return rows


def wide_taco(torch, corpus_np, queries, gt) -> dict:
    """TaCo over the wide corpus at WIDE_TACO: the build, masked-full and
    gather at k = 10 under both selections, each against the plain path on
    the same index (recall@10 within 0.005, ids >= 99.9 %), every collision
    kernel launched with its table in global memory and l2dist twice a
    batch (40 pairs, 32 a launch); then the kernels on the path's own batch
    (wide_kernel_rows)."""
    from repro_torch.core import taco
    from repro_torch.core.config import taco_config
    from repro_torch.kernels import cuda
    from repro_torch.kernels.l2dist import MAX_PAIRS
    from repro_torch.kernels.schist import collision_bits, collision_table

    cfg = taco_config(**WIDE_TACO, k=10, rerank="masked_full", use_kernels=True)
    # l2dist launches a batch: its 2 N_s (subspace, half) pairs, up to
    # MAX_PAIRS a launch
    per_batch = -(-2 * cfg.n_subspaces // MAX_PAIRS)
    (index, build_s), build_launches = run_path(
        torch, "wide_build", lambda: build_index(torch, corpus_np, cfg, "wide taco"),
        expect={"kmeans_assign": cfg.kmeans_iters + 1})
    index.search(queries[:8])  # warm-up: caches the per-index cell ids
    out = dict(build_s=build_s, index_bytes=index.index_bytes, searches=[],
               launches=[build_launches])
    n_runs = len(WIDE_SETTINGS)
    for rerank, path, kernels in (("masked_full", "wide_masked", ("schist", "masked_rerank")),
                                  ("gather", "wide_gather", ("scscore",))):
        view = index.replace_cfg(rerank=rerank)
        runs, launches = run_path(torch, path,
                                  lambda: search_runs(torch, view, queries, WIDE_SETTINGS),
                                  expect={"l2dist": 3 * n_runs * per_batch})
        layouts = {name: dict(cuda.launch_layouts[name]) for name in kernels}
        want = {"schist": "table=global", "scscore": "table=global",
                "masked_rerank": "table=global,heaps=shared"}
        for name in kernels:
            check(set(layouts[name]) == {want[name]}, f"{path}: {name} launched {layouts[name]}")
        out["launches"].append(launches)
        for (k, sel), run in runs.items():
            row = against_plain(torch, view, queries, gt, run, k, sel, path)
            row.update(rerank=rerank, layouts=layouts)
            print(f"wide: search {json.dumps(row)}", flush=True)
            out["searches"].append(row)
        del runs
    q = torch.as_tensor(queries).cuda()
    d1s, d2s, cells, taus, _ = taco._collision_inputs(index.sc_index, q, cfg)
    bits = collision_bits(collision_table(d1s, d2s, taus))
    out["kernels"] = wide_kernel_rows(torch, "wide taco", bits, cells, index.sc_index.data, q,
                                      10, cfg.n_subspaces, cfg.sqrt_k ** 2)
    del index, bits, cells
    torch.cuda.empty_cache()
    return out


def wide_collisions(torch, data, queries) -> dict:
    """The collision kernels at N_s = 127 (K = 1024, the main path's n and
    Q): bits and cells drawn from the seed (activation at alpha 0.05, as
    the kernels phase draws them), schist and scscore bit for bit and
    masked_rerank (k = 10, the query-aware threshold at beta 0.005) against
    their plain versions on the main corpus and queries."""
    import numpy as np

    from repro_torch.core.activation import activation_taus
    from repro_torch.kernels.schist import collision_bits, collision_table

    rng = np.random.default_rng(127)
    n_sub, sqrt_k, n, q = WIDE_N_SUB, WIDE_SQRT_K, data.shape[0], queries.shape[0]
    cells = torch.as_tensor(rng.integers(0, sqrt_k ** 2, (n_sub, n), dtype=np.int32)).cuda()
    sizes = torch.stack([torch.bincount(cells[s].long(), minlength=sqrt_k ** 2)
                         for s in range(n_sub)]).to(torch.int32).reshape(n_sub, sqrt_k, sqrt_k)
    d1s, d2s = (torch.as_tensor(rng.uniform(0, 4, (n_sub, q, sqrt_k)).astype(np.float32)).cuda()
                for _ in range(2))
    taus, _ = activation_taus(d1s, d2s, sizes, 0.05 * n)
    bits = collision_bits(collision_table(d1s, d2s, taus))
    rows = wide_kernel_rows(torch, "n_sub 127", bits, cells, data, queries, 10, n_sub,
                            sqrt_k ** 2)
    del cells, bits
    torch.cuda.empty_cache()
    return rows


def topk_agreement(torch, ids, dists, pids, pdists) -> dict:
    """Two (Q, k) top-k lists, the kernel's (ids, dists) and the plain
    version's (pids, pdists): ``ids_same``, the share of positions that
    hold the same id; ``ids_in_both``, the share of the plain version's ids
    that the kernel's row holds too; the distance error ``tol``, the larger
    of the largest position-wise gap between the two sorted distance lists
    and the largest gap between the two distances of one (query, id) both
    return; and ``unexplained``, the ids that only one list holds and whose
    distance lies more than 2 tol inside that row's k-th distance. Two
    sound top-k lists whose distances differ by at most tol can differ only
    there: a point one path ranks in and the other out lies within 2 tol
    of the k-th distance. Computed on the card where there is one."""
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    ids, dists, pids, pdists = (torch.as_tensor(a).to(dev) for a in (ids, dists, pids, pdists))
    q = ids.shape[0]
    fin, pfin = torch.isfinite(dists), torch.isfinite(pdists)
    both = fin & pfin
    err_sorted = float((dists[both] - pdists[both]).abs().max()) if bool(both.any()) else 0.0
    span = int(max(int(ids.max()), int(pids.max()))) + 1
    rows = torch.arange(q, device=dev, dtype=torch.int64)[:, None] * span
    keys, pkeys = (rows + ids.long())[fin], (rows + pids.long())[pfin]
    kd, pd = dists[fin], pdists[pfin]

    def find(a, b):
        """For each key of a: whether b holds it, and where in sorted b."""
        sb, order = torch.sort(b)
        pos = torch.searchsorted(sb, a).clamp_max(max(b.numel() - 1, 0))
        hit = sb[pos] == a if b.numel() else torch.zeros_like(a, dtype=torch.bool)
        return hit, order[pos]

    hit, at = find(keys, pkeys)
    common = int(hit.sum())
    err_common = float((kd[hit] - pd[at[hit]]).abs().max()) if common else 0.0
    tol = max(err_sorted, err_common)
    unexplained = 0
    for own, d, rows_d, f, other in ((keys, kd, dists, fin, pkeys),
                                     (pkeys, pd, pdists, pfin, keys)):
        kth = torch.where(f[:, -1], rows_d[:, -1], torch.inf)
        only = ~find(own, other)[0]
        unexplained += int((d[only] < kth[own[only] // span] - 2 * tol).sum())
    return dict(ids_same=float((ids == pids).float().mean()),
                ids_in_both=common / max(pkeys.numel(), 1), tol=tol,
                err_sorted=err_sorted, err_common=err_common,
                fill_equal=bool(torch.equal(fin, pfin)), unexplained=unexplained)


def wide_big_k(torch, index, queries, gt) -> dict:
    """masked_rerank past k = 1024 on the main 10^6 x 128 index (a view at
    beta WIDE_KS_BETA, whose candidates fill k = 8192): the masked-full
    batch at each of WIDE_KS under both selections against the plain path
    (topk_agreement: >= 99.9 % of the plain path's ids in the kernel path's
    rows, and recall@10 within 0.005; the two paths' centroid distances
    differ in the last bit, which moves a few cells' activation and so a
    few candidates of a long list, so no tie test applies there); then the
    kernel on the batch's own inputs (one collision table; the thresholds
    of both selections) at each k beside its plain version and bound: the
    same filled slots, the distance error within the norm form's rounding
    bound (IVF_NEAR_TIE of |q|^2 + the largest |x|^2), >= 99.9 % of the
    ids in both and no id in one list only unless within twice the
    measured error of the k-th distance; and at k = 8192 with a 1 %
    tombstone bitmap (the same gates, no excluded point returned)."""
    import numpy as np

    from repro_torch.utils import recall_at_k

    from repro_torch.core import taco
    from repro_torch.core.selection import fixed_threshold_from_hist, query_aware_threshold
    from repro_torch.kernels import cuda
    from repro_torch.kernels.masked_rerank import (
        masked_rerank_cuda,
        masked_rerank_plain,
        pack_exclusion,
        rerank_geometry,
    )
    from repro_torch.kernels.schist import collision_bits, collision_table, schist_cuda

    view = index.replace_cfg(beta=WIDE_KS_BETA, rerank="masked_full")
    settings = [(k, sel) for k in WIDE_KS for sel in ("query_aware", "fixed")]
    runs, launches = run_path(torch, "wide_big_k",
                              lambda: search_runs(torch, view, queries, settings),
                              expect={"l2dist": 3 * len(settings)})
    out = dict(searches=[], launches=launches,
               layouts=dict(cuda.launch_layouts["masked_rerank"]))
    data_norms = taco.data_norms_of(view.sc_index)
    scale = ((queries * queries).sum(1) + data_norms.max()).cpu().numpy()
    # the norm form's rounding bound on one distance's two computations
    rounding = float(IVF_NEAR_TIE * scale.min())
    for (k, sel), run in runs.items():
        ids, dists = run["ids"], run["dists"]
        check(tuple(ids.shape) == (queries.shape[0], k), f"wide big k: ids shape k={k}")
        check(bool(np.isfinite(dists[:, :10]).all()), f"wide big k: top-10 dists k={k} {sel}")
        plain = view.replace_cfg(selection=sel, use_kernels=False)
        pids, pdists, _ = plain.search_with_stats(queries, k=k)
        row = dict(k=k, selection=sel, seconds=run["seconds"],
                   qps=queries.shape[0] / run["seconds"], recall_at_10=recall_at_k(ids, gt, 10),
                   plain_recall_at_10=recall_at_k(pids, gt, 10),
                   mean_candidate_count=float(run["stats"]["candidate_count"].mean()),
                   filled=float((ids >= 0).mean()),
                   **topk_agreement(torch, ids, dists, pids, pdists),
                   geometry=rerank_geometry(index.n, k, view.cfg.n_subspaces,
                                            view.cfg.sqrt_k ** 2, index.d)._asdict())
        print(f"wide: big k search {json.dumps(row)}", flush=True)
        check(abs(row["recall_at_10"] - row["plain_recall_at_10"]) <= 0.005,
              f"wide big k: recall k={k} {sel}")
        check(row["ids_in_both"] >= 0.999,
              f"wide big k: ids in both {row['ids_in_both']} < 0.999 k={k} {sel}")
        out["searches"].append(row)
    del runs
    cfg, sc_index = view.cfg, view.sc_index
    d1s, d2s, cells, taus, _ = taco._collision_inputs(sc_index, queries, cfg)
    bits = collision_bits(collision_table(d1s, d2s, taus))
    n_sub, n, q = cfg.n_subspaces, sc_index.n, queries.shape[0]
    hist = schist_cuda(bits, cells, n_sub + 1, q=q)
    thresholds = {"query_aware": query_aware_threshold(hist, cfg.beta * n, n_sub),
                  "fixed": fixed_threshold_from_hist(hist, cfg.beta * n, n)}
    data, norms = sc_index.data, taco.data_norms_of(sc_index)
    d = data.shape[1]
    nbits = bits.numel() * 4

    def held(label, gd, gi, wd, wi):
        agree = topk_agreement(torch, gi, gd, wi, wd)
        check(agree["fill_equal"] and agree["tol"] <= rounding and agree["unexplained"] == 0
              and agree["ids_in_both"] >= 0.999, f"wide big k: masked_rerank {label} {agree}")
        return agree

    out["kernels"] = {}
    for k in WIDE_KS:
        for sel, (thresh, demand) in thresholds.items():
            args = (bits, cells, thresh, queries, data, norms)
            total = float(demand.sum())
            gd, gi = masked_rerank_cuda(*args, k)
            wd, wi = masked_rerank_plain(*args, k)
            agree = held(f"k={k} {sel}", gd, gi, wd, wi)
            fin = torch.isfinite(wd)
            b, by = bound_ms(
                4 * n_sub * n + nbits + 4 * q + 4 * q * d + 4 * d * min(n, total) + 4 * n
                + 8 * q * k, q * n * n_sub + total * (2 * d + 3))
            row = dict(selection=sel,
                       max_abs_err=float((gd[fin] - wd[fin]).abs().max()) if fin.any() else 0.0,
                       ms=timed(torch, lambda: masked_rerank_cuda(*args, k), 3),
                       plain_ms=timed(torch, lambda: masked_rerank_plain(*args, k), 1, 0),
                       bound_ms=b, bound_by=by, library_ms=None, **agree,
                       rounding_bound=rounding, mean_candidates=total / q,
                       geometry=rerank_geometry(n, k, n_sub, cfg.sqrt_k ** 2, d)._asdict(),
                       shape=f"Q {q}, N_s {n_sub}, n {n}, d {d}, k {k}, {sel}")
            print(f"kernel masked_rerank k={k} {sel}: {json.dumps(row)}", flush=True)
            out["kernels"][f"{k} {sel}"] = row
    excluded = np.random.default_rng(8192).random(n) < 0.01
    words = pack_exclusion(excluded).cuda()
    k = WIDE_KS[-1]
    args = (bits, cells, thresholds["query_aware"][0], queries, data, norms)
    gd, gi = masked_rerank_cuda(*args, k, words)
    wd, wi = masked_rerank_plain(*args, k, words)
    agree = held(f"k={k} exclusion", gd, gi, wd, wi)
    returned = gi[gi >= 0].cpu().numpy()
    check(not excluded[returned].any(), f"wide big k: k={k} returned an excluded point")
    row = out["kernels"][f"{k} query_aware"]
    row["exclusion"] = dict(excluded=int(excluded.sum()), **agree,
                            ms=timed(torch, lambda: masked_rerank_cuda(*args, k, words), 3))
    print(f"wide: big k exclusion {json.dumps(row['exclusion'])}", flush=True)
    del bits, cells, args
    torch.cuda.empty_cache()
    return out


def phase_wide(torch, n: int, index, main_queries, main_gt) -> dict:
    """Phase 6c: every shape past the kernels' former limits at full size.
    A 960-dim corpus (gmm_dataset(n + 1000, 960), split as the main corpus
    is; the exact top-10 on the card): IVF-Flat (wide_ivf) and TaCo over
    every dimension (wide_taco); then the collision kernels at N_s = 127
    (wide_collisions, on the main index's corpus and queries) and
    masked_rerank at k = 1025, 2048, 8192 on the main index (wide_big_k)."""
    from repro_torch.data import gmm_dataset, make_queries

    t0 = time.perf_counter()
    full = gmm_dataset(n + QUERIES, WIDE_D, seed=0)
    corpus_np, queries_np = make_queries(full, QUERIES)
    del full
    corpus = torch.as_tensor(corpus_np).cuda()
    queries = torch.as_tensor(queries_np).cuda()
    gt = brute_force_top10(torch, corpus, queries)
    out = dict(data_s=time.perf_counter() - t0, shape=list(corpus_np.shape))
    print(f"wide: data {corpus_np.shape} in {out['data_s']:.1f} s", flush=True)
    out["ivf"] = wide_ivf(torch, corpus, queries, gt)
    del corpus
    torch.cuda.empty_cache()
    out["taco"] = wide_taco(torch, corpus_np, queries_np, gt)
    del corpus_np, queries, gt
    torch.cuda.empty_cache()
    out["n_sub_127"] = wide_collisions(torch, index.sc_index.data, main_queries)
    out["big_k"] = wide_big_k(torch, index, main_queries, main_gt)
    out["launches"] = [out["ivf"]["launches"], *out["taco"]["launches"],
                       out["big_k"]["launches"]]
    return out


def save_and_load(torch, index, label: str) -> tuple:
    """(loaded index, row): AnnIndex.save to a temporary directory and
    AnnIndex.load on the card, host clock, every array checked bitwise."""
    from repro_torch.ann import AnnIndex
    from repro_torch.ann.persistence import leaves_of

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "index")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t0
        disk = sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())
        t0 = time.perf_counter()
        loaded = AnnIndex.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    got, want = leaves_of(loaded.sc_index), leaves_of(index.sc_index)
    check(len(got) == len(want), f"persist {label}: leaf count")
    check(all(g.device == w.device and torch.equal(g, w) for g, w in zip(got, want)),
          f"persist {label}: a reloaded array differs")
    check(loaded.cfg == index.cfg, f"persist {label}: config differs")
    row = dict(save_s=save_s, load_s=load_s, bytes_on_disk=disk, leaves=len(got))
    print(f"persist {label}: {json.dumps(row)}", flush=True)
    return loaded, row


def phase_persist(torch, taco_index, suco_index, queries) -> dict:
    """Phase 7: save and reload the TaCo index (and the SuCo index, which
    carries a dim_perm); one batch of masked-full and one of gather, k = 10,
    query-aware, on the reloaded index must equal the in-memory index's bit
    for bit, and a repeated batch must hit the searcher's cache."""
    import numpy as np

    summary = {}
    loaded, summary["taco"] = save_and_load(torch, taco_index, "taco")
    reruns = ("masked_full", "gather")
    view = loaded.replace_cfg(selection="query_aware")
    results, launches = run_path(
        torch, "persist", lambda: [view.search(queries, k=10, rerank=r) for r in reruns],
        expect={"l2dist": len(reruns)})
    summary["launches"] = launches
    for rerank, (ids, dists) in zip(reruns, results):
        want_ids, want_d = taco_index.replace_cfg(selection="query_aware").search(
            queries, k=10, rerank=rerank)
        check(np.array_equal(ids, want_ids) and
              np.array_equal(dists.view(np.uint32), want_d.view(np.uint32)),
              f"persist: reloaded {rerank} results differ from the built index")
    searcher = view._default_searcher()
    before = dict(searcher.compile_counts)
    view.search(queries, k=10, rerank="masked_full")
    check(searcher.compile_counts == before and set(before.values()) == {1},
          "persist: a repeated batch shape missed the searcher's cache")
    summary["compile_counts"] = {f"bucket {b}, k {k}, rerank {c.rerank}": n
                                 for (b, k, c), n in before.items()}
    print(f"persist: compile_counts {json.dumps(summary['compile_counts'])}", flush=True)

    suco, summary["suco"] = save_and_load(torch, suco_index, "suco")
    check(suco.sc_index.transform is None and suco.sc_index.dim_perm is not None,
          "persist suco: dim_perm / transform structure")
    for got, want in zip(suco.search(queries, k=10), suco_index.search(queries, k=10)):
        check(np.array_equal(got.view(np.uint32), want.view(np.uint32)),
              "persist suco: reloaded results differ")
    return summary


def _median_s(torch, fn, reps: int = 3):
    """(median host seconds of ``reps`` synchronized calls, last result)."""
    times, out = [], None
    for _rep in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], out


def churn(torch, m, corpus_np, gt, rng) -> dict:
    """The mutable phase's churn on ``m``: delete 10,000 base ids (the exact
    top-10 of the first 100 queries among them), insert 4,000 rows of the
    port's gmm_dataset under another seed (50 of them exact copies of live
    base rows), delete 1,000 of the inserted rows; batches of 100 inserts
    and of 1,000 / 100 deletes, host clock. Returns the row and the deleted
    ids."""
    import numpy as np

    from repro_torch.data import gmm_dataset

    n = corpus_np.shape[0]
    top = np.unique(gt[:100, :10])
    rest = np.setdiff1d(rng.choice(n, 12_000, replace=False), top)[:10_000 - top.size]
    base_kill = rng.permutation(np.concatenate([top, rest]))
    check(base_kill.size == 10_000, "mutable: 10,000 distinct base ids to delete")
    fresh = gmm_dataset(4_000, corpus_np.shape[1], seed=1)
    live_base = np.setdiff1d(np.arange(n), base_kill)
    fresh[rng.choice(4_000, 50, replace=False)] = corpus_np[rng.choice(live_base, 50,
                                                                       replace=False)]
    t0 = time.perf_counter()
    for lo in range(0, 10_000, 1_000):
        m.delete(base_kill[lo:lo + 1_000])
    base_delete_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    new_ids = np.concatenate([m.insert(fresh[lo:lo + 100]) for lo in range(0, 4_000, 100)])
    insert_s = time.perf_counter() - t0
    delta_kill = rng.choice(new_ids, 1_000, replace=False)
    t0 = time.perf_counter()
    for lo in range(0, 1_000, 100):
        m.delete(delta_kill[lo:lo + 100])
    delta_delete_s = time.perf_counter() - t0
    row = dict(insert_rows_per_s=4_000 / insert_s, insert_batch=100,
               base_delete_rows_per_s=10_000 / base_delete_s, base_delete_batch=1_000,
               delta_delete_rows_per_s=1_000 / delta_delete_s, delta_delete_batch=100,
               top10_of_first_100_deleted=int(top.size), stats=m.stats())
    print(f"mutable: churn {json.dumps(row)}", flush=True)
    check(m.maybe_compact() is None, "mutable: the churn crossed a default compaction trigger")
    return row, np.concatenate([base_kill, delta_kill])


def live_top10(torch, m, queries):
    """Brute-force top-10 over the live corpus, as external ids."""
    vecs, ids = m.live_corpus()
    return ids[brute_force_top10(torch, torch.as_tensor(vecs).cuda(), queries)]


def mutable_searches(torch, m, index, queries, gt_live, dead) -> list:
    """1000 queries at k = 10 and 100, query-aware, both pipelines, on the
    churned index: the launch counts of each batch (one l2dist, one schist
    and one masked_rerank a masked-full batch; one l2dist and one scscore a
    gather batch), the plain path on the same state, recall against brute
    force over the live corpus, no deleted id returned, and the immutable
    index's batch seconds in the same call."""
    import dataclasses

    import numpy as np

    from repro_torch.ann.mutable import MutableSearcher, base_fetch_k
    from repro_torch.utils import recall_at_k

    plain = MutableSearcher(m)
    plain.cfg = dataclasses.replace(m.cfg, use_kernels=False)
    kernels = {"masked_full": {"l2dist": 1, "schist": 1, "masked_rerank": 1, "scscore": 0},
               "gather": {"l2dist": 1, "scscore": 1, "schist": 0, "masked_rerank": 0}}
    st = m._state
    rows = []
    for rerank in ("masked_full", "gather"):
        m.search(queries[:8], k=10, rerank=rerank)  # warm-up
        for k in (10, 100):
            cfg = dataclasses.replace(m.cfg, selection="query_aware", rerank=rerank)
            (secs, (ids, dists, stats)), launches = run_path(
                torch, "mutable" if rerank == "masked_full" else "mutable_gather",
                lambda: _median_s(torch, lambda: m.search_with_stats(
                    queries, k=k, beta=None, rerank=rerank)),
                expect={name: 3 * c for name, c in kernels[rerank].items()})
            imm_s, _ = _median_s(torch, lambda: index.search(queries, k=k, rerank=rerank))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pids, _pd, _ps = plain.search_with_stats(queries, k=k, rerank=rerank)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            rec, prec = recall_at_k(ids, gt_live, 10), recall_at_k(pids, gt_live, 10)
            same = float(np.mean(pids == ids))
            row = dict(rerank=rerank, k=k, selection="query_aware", seconds=secs,
                       immutable_seconds=imm_s, plain_seconds=plain_s,
                       qps=queries.shape[0] / secs, recall_at_10=rec,
                       plain_recall_at_10=prec, ids_same_as_plain=same,
                       base_k=base_fetch_k(st, k, cfg),
                       gather_cap=min(st.n_base, max(cfg.cap_for(st.n_base),
                                                     base_fetch_k(st, k, cfg))),
                       mean_candidate_count=float(stats["candidate_count"].mean()),
                       launches=launches)
            print(f"mutable: search {json.dumps(row)}", flush=True)
            check(tuple(ids.shape) == (queries.shape[0], k), f"mutable ids shape {rerank} k={k}")
            check(bool(np.isfinite(dists[:, :10]).all()), f"mutable finite top-10 {rerank} k={k}")
            check(not np.isin(ids, dead).any() and not np.isin(pids, dead).any(),
                  f"mutable: a deleted id was returned ({rerank} k={k})")
            check(abs(rec - prec) <= 0.005, f"mutable recall {rec} vs plain {prec} {rerank} k={k}")
            check(same >= 0.999, f"mutable ids same as plain {same} < 0.999 {rerank} k={k}")
            rows.append(row)
    return rows


def delta_scan_ms(torch, m, queries) -> dict:
    """Device ms of the delta segment's exact scan (one (Q, m_pad) product,
    mask, stable top-k) at the churned state's delta, Q = 1024."""
    from repro_torch.ann.mutable import _delta_topk
    from repro_torch.ann.searcher import _padded_on

    st = m._state
    rows, norms, live, _ids = st.delta_padded()
    qp = _padded_on(queries, 1024, torch.device("cuda"))
    out = {"delta_rows": st.n_delta_rows, "delta_live": st.n_delta_live,
           "m_pad": int(rows.shape[0])}
    for k in (10, 100):
        out[f"k{k}_ms"] = timed(torch, lambda: _delta_topk(qp, rows, norms, live, k), 20)
    print(f"mutable: delta scan {json.dumps(out)}", flush=True)
    return out


def durability(torch, index, queries) -> dict:
    """durability="sync" over the same base: per-call latency of fsync'd
    appends (inserts of 10 rows, deletes of 10 ids), then checkpoint(),
    more mutations and MutableAnnIndex.load(path, wal_dir=...): the state,
    the base's arrays and search ids and dists bitwise equal, replay
    seconds recorded."""
    import numpy as np

    from repro_torch.ann import MutableAnnIndex
    from repro_torch.ann.persistence import leaves_of

    rng = np.random.default_rng(3)
    d = index.d
    with tempfile.TemporaryDirectory() as tmp:
        wal_dir, snap = str(Path(tmp) / "wal"), str(Path(tmp) / "snap")
        m = index.mutable(durability="sync", wal_dir=wal_dir)
        lat = {"insert": [], "delete": []}
        kill = rng.choice(index.n, 2_000, replace=False)
        for i in range(100):
            t0 = time.perf_counter()
            m.insert(rng.standard_normal((10, d)).astype(np.float32))
            lat["insert"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            m.delete(kill[10 * i:10 * i + 10])
            lat["delete"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        m.checkpoint(snap)
        checkpoint_s = time.perf_counter() - t0
        for i in range(100, 120):
            m.insert(rng.standard_normal((10, d)).astype(np.float32))
            m.delete(kill[10 * i:10 * i + 10])
        want = {r: m.search(queries, k=10, rerank=r) for r in ("masked_full", "gather")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = MutableAnnIndex.load(snap, wal_dir=wal_dir)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        replayed = loaded._wal.records_replayed
        a, b = loaded._state, m._state
        check(all(np.array_equal(getattr(a, f), getattr(b, f))
                  for f in ("base_ids", "tombstones", "delta", "delta_ids", "delta_live")),
              "durability: the replayed state differs")
        check(all(torch.equal(x, y) for x, y in zip(leaves_of(a.base.sc_index),
                                                    leaves_of(b.base.sc_index))),
              "durability: a reloaded base array differs")
        check(loaded.stats()["next_id"] == m.stats()["next_id"]
              and loaded.generation == m.generation, "durability: counters differ")
        for r, (wi, wd) in want.items():
            gi, gd = loaded.search(queries, k=10, rerank=r)
            check(np.array_equal(gi, wi) and np.array_equal(gd.view(np.uint32),
                                                            wd.view(np.uint32)),
                  f"durability: reloaded {r} results differ")
        loaded.close()
        m.close()
    ms = {kind: np.asarray(v) * 1e3 for kind, v in lat.items()}
    row = {f"sync_{kind}_ms_p50": float(np.percentile(v, 50)) for kind, v in ms.items()}
    row.update({f"sync_{kind}_ms_p99": float(np.percentile(v, 99)) for kind, v in ms.items()})
    row.update(checkpoint_s=checkpoint_s, load_with_replay_s=load_s, records_replayed=replayed)
    check(replayed == 40, f"durability: {replayed} records replayed, expected 40")
    print(f"mutable: durability {json.dumps(row)}", flush=True)
    return row


def integer_compaction_check(torch) -> dict:
    """Compaction on an integer-valued 10^5 x 128 SuCo corpus after churn,
    on the card: the installed base equals a rebuild over the live corpus
    (``rebuild_oracle``) in every array, and search ids and dists equal bit
    for bit."""
    import numpy as np

    from repro_torch.ann import MutableAnnIndex
    from repro_torch.ann.persistence import leaves_of
    from repro_torch.core.config import suco_config

    rng = np.random.default_rng(11)
    data = rng.integers(-20, 21, (100_000, 128)).astype(np.float32)
    cfg = suco_config(n_subspaces=6, n_clusters=1024, alpha=0.05, beta=0.005, k=10,
                      use_kernels=True)
    m = MutableAnnIndex.build(data, cfg)
    m.delete(rng.choice(100_000, 1_000, replace=False))
    fresh = rng.integers(-20, 21, (500, 128)).astype(np.float32)
    fresh[:20] = data[rng.choice(100_000, 20, replace=False)]
    m.delete(m.insert(fresh)[::5])
    m.compact()
    oracle, id_map = m.rebuild_oracle()
    same = all(torch.equal(x, y) for x, y in zip(leaves_of(m._state.base.sc_index),
                                                  leaves_of(oracle.sc_index)))
    check(same, "integer compaction: the installed base differs from the rebuild oracle")
    queries = data[:64] + 1
    for rerank in ("masked_full", "gather"):
        gi, gd = m.search(queries, k=10, rerank=rerank)
        oi, od = oracle.search(queries, k=10, rerank=rerank)
        check(np.array_equal(gi, np.where(oi >= 0, id_map[np.maximum(oi, 0)], -1))
              and np.array_equal(gd.view(np.uint32), od.view(np.uint32)),
              f"integer compaction: {rerank} results differ from the rebuild oracle")
    row = dict(n=100_000, n_live=m.n_live, bitwise=True)
    print(f"mutable: integer SuCo compaction equals the rebuild oracle: {json.dumps(row)}",
          flush=True)
    return row


def phase_mutable(torch, index, corpus_np, queries, gt) -> dict:
    """Phase 8: the persist phase's TaCo index (use_kernels=True) as the
    base of a MutableAnnIndex: churn, search against the plain path and
    brute force over the live corpus, the delta scan, sync durability with
    crash-style replay, and compaction against a rebuild oracle."""
    import numpy as np

    from repro_torch.utils import recall_at_k

    rng = np.random.default_rng(5)
    m = index.mutable()
    summary = {}
    summary["churn"], dead = churn(torch, m, corpus_np, gt, rng)
    st = m._state
    gt_live = live_top10(torch, m, queries)
    summary["searches"] = mutable_searches(torch, m, index, queries, gt_live, dead)
    summary["delta_scan"] = delta_scan_ms(torch, m, queries)
    summary["durability"] = durability(torch, index, queries)

    n_live = st.n_live
    (report, launches) = run_path(torch, "compact", lambda: _median_s(torch, m.compact, 1),
                                  expect={"kmeans_assign": index.cfg.kmeans_iters + 1})
    compact_s, report = report
    check(not report.delta_only and report.n_live == n_live and not m.dirty,
          "compaction: report or state")
    oracle, id_map = m.rebuild_oracle()
    # builds on the card repeat bit for bit, so compaction IS the oracle
    from repro_torch.ann.persistence import leaves_of

    check(all(torch.equal(x, y) for x, y in zip(leaves_of(m._state.base.sc_index),
                                                 leaves_of(oracle.sc_index))),
          "compaction: the installed base differs from the rebuild oracle")
    rows = []
    for rerank in ("masked_full", "gather"):
        ids, _d = m.search(queries, k=10, rerank=rerank)
        oi, _od = oracle.search(queries, k=10, rerank=rerank)
        oids = np.where(oi >= 0, id_map[np.maximum(oi, 0)], -1)
        same = float(np.mean(ids == oids))
        rec, orec = recall_at_k(ids, gt_live, 10), recall_at_k(oids, gt_live, 10)
        check(same >= 0.999, f"compaction: ids same as the rebuild oracle {same} < 0.999")
        check(abs(rec - orec) <= 0.005, f"compaction: recall {rec} vs oracle {orec}")
        check(not np.isin(ids, dead).any(), f"compaction: a deleted id was returned ({rerank})")
        rows.append(dict(rerank=rerank, ids_same_as_oracle=same, recall_at_10=rec,
                         oracle_recall_at_10=orec))
    summary["compaction"] = dict(seconds=compact_s, reclaimed=report.reclaimed,
                                 n_live=report.n_live, launches=launches,
                                 arrays_equal_oracle=True, against_oracle=rows)
    print(f"mutable: compaction {json.dumps(summary['compaction'])}", flush=True)
    del oracle
    summary["integer_compaction"] = integer_compaction_check(torch)
    summary["launches"] = [r["launches"] for r in summary["searches"]] + [launches]
    torch.cuda.empty_cache()
    return summary


#: the engine phase's stream on an engine whose default is gather: every
#: third request k = 5, every third beta x 2, every fourth masked-full
ENGINE_MASKED_EVERY = 4


def engine_stream(cfg, queries_np) -> list:
    """The engine phase's request fields, one request a held-out query."""
    return [dict(query=q, k=5 if i % 3 == 1 else None,
                 beta=cfg.beta * 2 if i % 3 == 2 else None,
                 rerank="masked_full" if i % ENGINE_MASKED_EVERY == 0 else None)
            for i, q in enumerate(queries_np)]


def sync_batches(cfg, stream, max_batch: int):
    """What one synchronous ``engine.search`` of the whole stream executes:
    ceil(n / max_batch) batches a (k, cfg) group. Returns (masked-full
    batches, gather batches, query functions made per bucket)."""
    from repro_torch.ann.searcher import effective_query_params
    from repro_torch.batching import ANN_BATCH_BUCKETS, bucket_size
    from repro_torch.core.config import resolve_rerank

    groups: dict = {}
    for r in stream:
        key = effective_query_params(cfg, r["k"], r["beta"], r["rerank"])
        groups[key] = groups.get(key, 0) + 1
    buckets = tuple(b for b in ANN_BATCH_BUCKETS if b <= max_batch)
    masked = gather = 0
    per_bucket: dict = {}
    for (_k, c), n in groups.items():
        sizes = [max_batch] * (n // max_batch) + ([n % max_batch] if n % max_batch else [])
        if resolve_rerank(c) == "masked_full":
            masked += len(sizes)
        else:
            gather += len(sizes)
        for b in {bucket_size(x, buckets) for x in sizes}:
            per_bucket[b] = per_bucket.get(b, 0) + 1
    return masked, gather, per_bucket


def direct_ids(view, stream):
    """Each request's ids from a direct ``search_with_stats`` of its group
    (same k, beta, rerank) as one batch through the facade."""
    import numpy as np

    groups: dict = {}
    for i, r in enumerate(stream):
        groups.setdefault((r["k"], r["beta"], r["rerank"]), []).append(i)
    out = [None] * len(stream)
    for (k, beta, rerank), idx in groups.items():
        q = np.stack([stream[i]["query"] for i in idx])
        ids, _d, _s = view.search_with_stats(q, k=k, beta=beta, rerank=rerank)
        for row, i in enumerate(idx):
            out[i] = ids[row]
    return out


def same_share(got, want) -> float:
    """The share of requests whose ids equal."""
    import numpy as np

    return float(np.mean([np.array_equal(g, w) for g, w in zip(got, want)]))


def produce(engine, reqs, producers: int = 4):
    """``producers`` threads submit slices of ``reqs`` to an async engine and
    wait on their futures. Returns (seconds, results by request index (None
    where shed), AdmissionErrors seen, request ids handed out, seconds until
    the last producer's last ``submit()`` had returned)."""
    import threading

    from repro_torch.serving import AdmissionError

    results = [None] * len(reqs)
    shed = [0] * producers
    submitted = [0.0] * producers
    rids: list = []
    errors: list = []

    def producer(p):
        try:
            futures = []
            for j in range(p, len(reqs), producers):
                try:
                    futures.append((j, engine.submit(reqs[j])))
                except AdmissionError:
                    shed[p] += 1
            submitted[p] = time.perf_counter() - t0
            for j, f in futures:
                results[j] = f.result(timeout=120.0)
                rids.append(f.request_id)
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(p,)) for p in range(producers)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(300.0)
    secs = time.perf_counter() - t0
    check(not errors and all(not th.is_alive() for th in threads), f"engine producers: {errors}")
    return secs, results, sum(shed), rids, max(submitted)


def engine_row(t: dict, secs: float, n: int) -> dict:
    """The telemetry numbers an engine run is recorded by."""
    return dict(seconds=secs, qps=n / secs, telemetry_qps=t["queries_per_sec"],
                p50_ms=t["latency_p50_s"] * 1e3, p99_ms=t["latency_p99_s"] * 1e3,
                batches=t["batches"], served=t["requests_served"],
                compiles_per_bucket=t["compiles_per_bucket"],
                early_closes=t["batches_closed_early"], deadline_misses=t["deadline_misses"],
                queue_peak=t["queue_depth_peak"], shed=t["shed"],
                cache_hits=t["result_cache_hits"])


def engine_mutable(torch, view, reqs, queries_np) -> dict:
    """The mutable engine: churn waves with background compactions swapped
    into a live async engine while four producers submit; then a batch
    after the swap against ``mutable.search`` bit for bit, no deleted id,
    and the recall probes against brute force over the live corpus."""
    import threading

    import numpy as np

    from repro_torch.ann import CompactionPolicy
    from repro_torch.ann.mutable import churn_wave
    from repro_torch.serving import AnnRequest
    from repro_torch.utils import recall_at_k

    m = view.mutable(policy=CompactionPolicy(max_delta_rows=1024))
    engine = m.engine(max_batch=64, recall_probe_every=50, async_mode=True)
    engine.search(reqs[:64], timeout=120.0)  # warm-up
    engine.reset_telemetry()
    gen0, n0 = engine.index_generation, m.stats()["next_id"]
    rng = np.random.default_rng(9)
    live_ids: list = []
    handles: list = []

    def churn():
        for _wave in range(8):  # 256 inserts a wave: a compaction every fourth
            h = churn_wave(m, rng, live_ids, 256, engine=engine, background=True)
            if h is not None:
                handles.append(h)
                h.result(timeout=300.0)

    def run():
        th = threading.Thread(target=churn)
        th.start()
        out = produce(engine, reqs)
        th.join(300.0)
        check(not th.is_alive(), "mutable engine: the churn did not finish")
        return out

    (secs, results, _shed, _rids, submit_s), launches = run_path(torch, "engine", run)
    t = engine.telemetry()
    check(all(r is not None for r in results), "mutable engine: a request was lost")
    check(len(handles) == 2 and all(h.error is None for h in handles),
          f"mutable engine: {len(handles)} compactions, expected 2")
    check(t["index_swaps"] == len(handles) and t["index_generation"] > gen0,
          "mutable engine: the compaction did not swap into the engine")
    check(launches["kmeans_assign"] == len(handles) * (view.cfg.kmeans_iters + 1)
          and launches["l2dist"] == t["batches"],
          f"mutable engine: launches {launches} vs {t['batches']} batches")
    row = dict(engine_row(t, secs, len(reqs)), submit_s=submit_s, compactions=len(handles),
               compaction_s=[h.report.duration_s for h in handles],
               generation=t["index_generation"], swaps=t["index_swaps"],
               probes=t["recall_probe_count"], probes_skipped=t["recall_probe_skipped"],
               launches=launches)
    # after the swap: a batch of 64 equals mutable.search at the same bucket
    q64 = queries_np[:64]
    post = engine.search([AnnRequest(query=q) for q in q64], timeout=120.0)
    want_i, want_d = m.search(q64)
    got_i, got_d = np.stack([r.ids for r in post]), np.stack([r.dists for r in post])
    check(np.array_equal(got_i, want_i) and np.array_equal(got_d.view(np.uint32),
                                                           want_d.view(np.uint32)),
          "mutable engine: a batch after the swap differs from mutable.search")
    deleted = np.setdiff1d(np.arange(n0, m.stats()["next_id"]), np.asarray(live_ids))
    check(deleted.size > 0 and not np.isin(got_i, deleted).any(),
          "mutable engine: a deleted id was returned")
    # the probes: one group, one submitter, so the probed requests are every
    # 50th in submission order; their brute-force recall over the live corpus
    engine.reset_telemetry()
    pq = queries_np[:500]
    futures = [engine.submit(AnnRequest(query=q)) for q in pq]
    served = np.stack([f.result(timeout=120.0).ids for f in futures])
    t = engine.telemetry()
    engine.close()
    probed = np.arange(49, len(pq), 50)
    gt_live = live_top10(torch, m, torch.as_tensor(pq[probed]).cuda())
    bf = recall_at_k(served[probed], gt_live, 10)
    check(t["recall_probe_count"] == len(probed) and t["recall_probe_skipped"] == 0,
          f"mutable engine: {t['recall_probe_count']} probes counted")
    check(abs(t["live_recall_at_k"] - bf) <= 0.01,
          f"mutable engine: probe recall {t['live_recall_at_k']} vs brute force {bf}")
    row.update(post_swap_bitwise=True, deleted=int(deleted.size),
               live_recall_at_k=t["live_recall_at_k"], brute_force_recall_at_10=bf)
    print(f"engine: mutable {json.dumps(row)}", flush=True)
    return row


def phase_engine(torch, index, queries_np, gt) -> dict:
    """Phase 9: the TaCo index served through ``index.engine`` (gather by
    default, every fourth request masked-full): sync at max_batch 64 and
    256 against direct searches with exact launch counts, the result
    cache's pass (no kernel launched), async with four producers, admission
    control, the mutable engine across a compaction, and one profiled
    engine batch of 64 of each pipeline."""
    import numpy as np

    from repro_torch.kernels import cuda
    from repro_torch.serving import AnnRequest
    from repro_torch.utils import recall_at_k

    t0 = time.perf_counter()
    view = index.replace_cfg(rerank="gather")
    stream = engine_stream(view.cfg, queries_np)
    reqs = [AnnRequest(**r) for r in stream]
    n = len(reqs)
    direct = direct_ids(view, stream)
    k10 = [i for i, r in enumerate(stream) if r["k"] is None]
    direct_rec = recall_at_k(np.stack([direct[i][:10] for i in k10]), gt[k10], 10)
    summary = {"requests": n, "launches": [], "sync": {}, "step_seconds": {}}
    steps = summary["step_seconds"]

    def step(name):  # host seconds of each step, its warm-up and checks included
        nonlocal t0
        steps[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    step("direct")
    sync64 = None
    for max_batch in (64, 256):
        engine = view.engine(max_batch=max_batch)
        engine.search(reqs)  # warm-up: every (bucket, k, cfg) key once
        engine.reset_telemetry()
        masked_b, gather_b, per_bucket = sync_batches(view.cfg, stream, max_batch)
        (secs, results), launches = run_path(
            torch, "engine", lambda: _median_s(torch, lambda: engine.search(reqs), 1),
            expect={"l2dist": masked_b + gather_b, "schist": masked_b,
                    "masked_rerank": masked_b, "scscore": gather_b, "kmeans_assign": 0})
        summary["launches"].append(launches)
        t = engine.telemetry()
        check(len(results) == n and t["requests_served"] == n and not engine._undelivered,
              f"engine sync {max_batch}: not every request answered once")
        check(t["batches"] == masked_b + gather_b and t["compiles_per_bucket"] == per_bucket,
              f"engine sync {max_batch}: batches {t['batches']} / compiles "
              f"{t['compiles_per_bucket']} vs {masked_b + gather_b} / {per_bucket}")
        ids = [r.ids for r in results]
        same = same_share(ids, direct)
        rec = recall_at_k(np.stack([ids[i][:10] for i in k10]), gt[k10], 10)
        check(same >= 0.999, f"engine sync {max_batch}: ids same as direct {same} < 0.999")
        check(abs(rec - direct_rec) <= 0.005,
              f"engine sync {max_batch}: recall@10 {rec} vs direct {direct_rec}")
        row = dict(engine_row(t, secs, n), masked_batches=masked_b, gather_batches=gather_b,
                   ids_same_as_direct=same, recall_at_10=rec, direct_recall_at_10=direct_rec,
                   launches=launches)
        print(f"engine: sync max_batch {max_batch} {json.dumps(row)}", flush=True)
        summary["sync"][max_batch] = row
        if max_batch == 64:
            sync64 = ids
        step(f"sync{max_batch}")

    # the result cache: the same stream again, every request a hit
    engine = view.engine(max_batch=64, result_cache_size=2 * n)
    engine.search(reqs)
    engine.reset_telemetry()
    cuda.reset_launch_counts()
    secs, cached = _median_s(torch, lambda: engine.search(reqs), 1)
    launches = dict(cuda.launch_counts)
    t = engine.telemetry()
    check(set(launches.values()) == {0}, f"engine cached pass launched kernels: {launches}")
    check(t["result_cache_hits"] == n and all(r.cached for r in cached),
          f"engine cached pass: {t['result_cache_hits']} hits of {n}")
    check(same_share([r.ids for r in cached], sync64) >= 0.999, "engine cached pass: ids")
    summary["cached"] = dict(engine_row(t, secs, n), launches=launches)
    print(f"engine: cached {json.dumps(summary['cached'])}", flush=True)
    step("cached")

    # async: four producers, a 50 ms deadline
    engine = view.engine(max_batch=64, async_mode=True, default_deadline_s=0.05)
    engine.search(reqs, timeout=120.0)  # warm-up
    engine.reset_telemetry()
    (secs, results, shed, rids, submit_s), launches = run_path(torch, "engine",
                                                               lambda: produce(engine, reqs))
    t = engine.telemetry()
    engine.close()
    summary["launches"].append(launches)
    check(shed == 0 and all(r is not None for r in results) and len(set(rids)) == n
          and t["requests_served"] == n, "engine async: a request was lost or duplicated")
    check(launches["l2dist"] == t["batches"]
          and launches["schist"] == launches["masked_rerank"]
          and launches["schist"] + launches["scscore"] == t["batches"],
          f"engine async: launches {launches} vs {t['batches']} batches")
    same = same_share([r.ids for r in results], sync64)
    check(same >= 0.999, f"engine async: ids same as sync {same} < 0.999")
    summary["async"] = dict(engine_row(t, secs, n), submit_s=submit_s, ids_same_as_sync=same,
                            launches=launches)
    print(f"engine: async {json.dumps(summary['async'])}", flush=True)
    step("async")

    # admission control: reject past a queue of 128
    engine = view.engine(max_batch=64, async_mode=True, default_deadline_s=0.05,
                         max_queue_depth=128, admission_policy="reject")
    secs, results, shed, _rids, submit_s = produce(engine, reqs)
    t = engine.telemetry()
    engine.close()
    served = sum(r is not None for r in results)
    check(shed == t["shed"] and served + shed == n and t["requests_served"] == served,
          f"engine admission: producers saw {shed} AdmissionErrors, telemetry {t['shed']}")
    summary["admission"] = dict(engine_row(t, secs, served), submit_s=submit_s, shed_seen=shed)
    print(f"engine: admission reject {json.dumps(summary['admission'])}", flush=True)
    step("admission")

    summary["mutable"] = engine_mutable(torch, view, reqs, queries_np)
    summary["launches"].append(summary["mutable"]["launches"])
    step("mutable")

    # one engine batch of 64 of each pipeline: host clock beside the
    # searcher's own batch of 64, then under the profiler
    engine = view.engine(max_batch=64)
    summary["batch64"] = {}
    q64 = queries_np[:64]
    for rerank in ("masked_full", "gather"):
        batch = [AnnRequest(query=q, rerank=rerank) for q in q64]
        engine.search(batch)
        engine_s, _ = _median_s(torch, lambda: engine.search(batch), 5)
        searcher_s, _ = _median_s(torch, lambda: view.search_with_stats(q64, rerank=rerank), 5)
        row = dict(engine_ms=engine_s * 1e3, searcher_ms=searcher_s * 1e3)
        print(f"engine: batch of 64 {rerank} {json.dumps(row)}", flush=True)
        row["profile"] = profile_call(torch, lambda: engine.search(batch), f"engine {rerank} 64")
        summary["batch64"][rerank] = row
    step("batch64")
    print(f"engine: step seconds {json.dumps(steps)}", flush=True)
    torch.cuda.empty_cache()
    return summary


#: data shards of the sharded phase, every one on the card
SHARDS = 4


def sharded_kernels(torch, index, views, queries) -> dict:
    """``schist``, ``scscore`` and ``masked_rerank`` (k 10 and 100) on one
    shard (n_local = n / SHARDS points) at the main path's inputs: the
    collision bits of the 1000 queries (tau from the GLOBAL alpha n), the
    shard's cell ids and the threshold read off the summed histogram. Each
    is held against its plain version with the kernels phase's gates
    (``schist`` and ``scscore`` bit for bit; ``masked_rerank``'s filled
    slots equal, dists within rtol 1e-5 and the cancellation floor, ids >=
    99.9 % equal) and timed beside it."""
    from repro_torch.core.activation import activation_taus
    from repro_torch.core.selection import query_aware_threshold
    from repro_torch.core.taco import _centroid_distances
    from repro_torch.kernels.masked_rerank import masked_rerank_cuda, masked_rerank_plain
    from repro_torch.kernels.schist import (
        collision_bits,
        collision_table,
        schist_cuda,
        schist_plain,
    )
    from repro_torch.kernels.scscore import scscore_cuda, scscore_plain

    cfg, idx = index.cfg, index.sc_index
    q = queries.shape[0]
    d1s, d2s = _centroid_distances(idx, queries, True)
    taus, _ = activation_taus(d1s, d2s, idx.cell_sizes, cfg.alpha * idx.n, method=cfg.activation)
    bits = collision_bits(collision_table(d1s, d2s, taus))
    levels = cfg.n_subspaces + 1
    hists = [schist_cuda(bits, v.cells, levels, q=q) for v in views]
    thresh, _demand = query_aware_threshold(sum(hists), cfg.beta * idx.n, cfg.n_subspaces)
    v = views[0]
    out = {"n_local": v.n}
    want = schist_plain(bits, v.cells, levels, q=q)
    check(torch.equal(hists[0], want) and bool((want.sum(1) == v.n).all()),
          f"sharded: schist at the shard shape (n_local {v.n})")
    out["schist"] = dict(max_abs_err=0.0,
                         ms=timed(torch, lambda: schist_cuda(bits, v.cells, levels, q=q), 10),
                         plain_ms=timed(torch, lambda: schist_plain(bits, v.cells, levels, q=q), 1))
    sc = scscore_cuda(bits, v.cells, q=q)
    check(torch.equal(sc, scscore_plain(bits, v.cells, q=q)),
          f"sharded: scscore at the shard shape (n_local {v.n})")
    del sc
    out["scscore"] = dict(max_abs_err=0.0,
                          ms=timed(torch, lambda: scscore_cuda(bits, v.cells, q=q), 10),
                          plain_ms=timed(torch, lambda: scscore_plain(bits, v.cells, q=q), 1))
    args_ = (bits, v.cells, thresh, queries, v.data, v.data_norms)
    atol = 1e-5 * float((queries * queries).sum(1).max() + v.data_norms.max())
    for k in (10, 100):
        gd, gi = masked_rerank_cuda(*args_, k)
        wd, wi = masked_rerank_plain(*args_, k)
        fin = torch.isfinite(wd)
        agree = float((gi == wi).float().mean())
        check(torch.equal(fin, torch.isfinite(gd)), f"sharded: masked_rerank filled slots k={k}")
        check(torch.allclose(gd[fin], wd[fin], rtol=1e-5, atol=atol),
              f"sharded: masked_rerank dists k={k}")
        check(agree >= 0.999, f"sharded: masked_rerank ids agree {agree:.5f} < 0.999 k={k}")
        out[f"masked_rerank_k{k}"] = dict(
            max_abs_err=float((gd[fin] - wd[fin]).abs().max()) if fin.any() else 0.0,
            ids_agree=agree, ms=timed(torch, lambda: masked_rerank_cuda(*args_, k), 5),
            plain_ms=timed(torch, lambda: masked_rerank_plain(*args_, k), 1))
        del gd, gi, wd, wi
    print(f"sharded: kernels at the shard shape {json.dumps(out)}", flush=True)
    return out


def sharded_searches(torch, index, queries_np, queries, gt) -> dict:
    """The 1000 queries through ``index.searcher("sharded", shards=SHARDS)``
    at k 10 and 100, both selections, both pipelines, beside the
    single-device searcher in the same call. No shard may truncate on
    masked-full; query-aware gather must equal single-device bit for bit
    on the queries neither placement truncated (at least 90 %: the
    one-device cap truncates a few of this corpus); masked-full, whose
    shards pick their top-k
    by the norm-form distance while the combine orders by the exact one,
    ids >= 99.9 % and dists within masked_rerank's tolerance; masked-full
    and fixed gather (an even split of the budget) hold recall@10 within
    0.005 of single-device's; the query-aware shards' candidates sum to the
    single-device demand. Seconds a batch are medians of 3 of
    ``search_with_stats`` (synchronized host clock). The sharded calls run
    under ``run_path`` with their exact launches a batch."""
    import dataclasses

    import numpy as np

    from repro_torch.batching import pad_rows
    from repro_torch.core.distributed import shard_views
    from repro_torch.core.taco import query_with_stats
    from repro_torch.utils import recall_at_k

    idx = index.sc_index
    # placement: shard views of the index; only the cell ids are new
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    views, _n = shard_views(idx, SHARDS)
    torch.cuda.synchronize()
    placement = dict(
        allocated_growth_bytes=torch.cuda.memory_allocated() - before,
        peak_growth_bytes=torch.cuda.max_memory_allocated() - before,
        cells_bytes=sum(v.cells.numel() * 4 for v in views),
        data_bytes=idx.data.numel() * 4)
    for v in views:
        check(v.data.untyped_storage().data_ptr() == idx.data.untyped_storage().data_ptr()
              and v.data_norms.untyped_storage().data_ptr()
              == idx.data_norms.untyped_storage().data_ptr(),
              "sharded: a shard's data or norms is a copy, not a view of the index's")
    print(f"sharded: placement {json.dumps(placement)}", flush=True)
    del views

    settings = [(k, sel, rerank) for sel in ("query_aware", "fixed")
                for rerank in ("masked_full", "gather") for k in (10, 100)]
    searchers = {sel: index.replace_cfg(selection=sel).searcher("sharded", shards=SHARDS)
                 for sel in ("query_aware", "fixed")}
    single = {}
    for k, sel, rerank in settings:
        view = index.replace_cfg(selection=sel, rerank=rerank)
        secs, (ids, dists, stats) = _median_s(
            torch, lambda: view.search_with_stats(queries_np, k=k), 3)
        _i, _d, st = query_with_stats(idx, queries, view.cfg, k=k)
        single[(k, sel, rerank)] = dict(seconds=secs, ids=ids, dists=dists,
                                       truncated=stats["truncated"],
                                       demand=st["candidate_demand"].cpu().numpy())
        del _i, _d, st

    padded = torch.as_tensor(pad_rows(queries_np, 1024)).cuda()

    def run_sharded():
        out = {}
        for k, sel, rerank in settings:
            searcher = searchers[sel]
            secs, (ids, dists, _st) = _median_s(
                torch, lambda: searcher.search_with_stats(queries_np, k=k, rerank=rerank), 3)
            cfg = dataclasses.replace(searcher.cfg, rerank=rerank)
            res = searcher.run_padded(1024, k, cfg, padded)
            out[(k, sel, rerank)] = dict(seconds=secs, ids=ids, dists=dists, res=res)
        return out

    masked_runs = sum(r == "masked_full" for _k, _s, r in settings) * 4
    gather_runs = sum(r == "gather" for _k, _s, r in settings) * 4
    sharded, launches = run_path(
        torch, "sharded", run_sharded,
        expect={"l2dist": masked_runs + gather_runs, "schist": SHARDS * masked_runs,
                "masked_rerank": SHARDS * masked_runs, "scscore": SHARDS * gather_runs,
                "kmeans_assign": 0})
    rows = []
    for key in settings:
        k, sel, rerank = key
        one, sh = single[key], sharded[key]
        res = sh["res"]
        check(np.array_equal(res.ids[:QUERIES], sh["ids"]), f"sharded: run_padded vs search {key}")
        truncated = res.shard_truncated[:QUERIES].any(axis=1)
        trunc, trunc1 = float(truncated.mean()), float(one["truncated"].mean())
        whole = ~(truncated | one["truncated"])  # rows no placement truncated
        rec, rec1 = recall_at_k(sh["ids"], gt, 10), recall_at_k(one["ids"], gt, 10)
        same = float(np.mean(sh["ids"] == one["ids"]))
        bitwise = (np.array_equal(sh["ids"][whole], one["ids"][whole])
                   and np.array_equal(sh["dists"][whole].view(np.uint32),
                                      one["dists"][whole].view(np.uint32)))
        if rerank == "masked_full":
            check(trunc == 0.0, f"sharded: {trunc} of the queries truncated on a shard {key}")
        if rerank == "gather" and sel == "query_aware":
            # the one-device cap (4 beta n) truncates a few queries of this
            # corpus too; the rest must be bit for bit
            check(bitwise and whole.mean() >= 0.9,
                  f"sharded: ids/dists differ from single-device where neither truncates "
                  f"{key} (compared {whole.mean()}, same {same})")
        elif rerank == "masked_full":
            # each shard keeps its top-k by the kernel's norm-form distance
            # and the combine orders by the exact ones (the reference's
            # design), so a near-tie the two forms order differently may
            # differ from the one-device top-k: held as masked_rerank is
            # held to its plain version
            fin = np.isfinite(one["dists"])
            atol = 1e-5 * float(2 * (queries_np ** 2).sum(1).max()
                                 + index.sc_index.data_norms.max())
            check(same >= 0.999 and np.array_equal(fin, np.isfinite(sh["dists"]))
                  and np.allclose(sh["dists"][fin], one["dists"][fin], rtol=1e-5, atol=atol),
                  f"sharded: ids same {same} < 0.999 or dists differ from single-device {key}")
        if rerank == "masked_full" or sel == "fixed":
            check(abs(rec - rec1) <= 0.005, f"sharded: recall@10 {rec} vs single {rec1} {key}")
        if sel == "query_aware":
            check(np.array_equal(res.shard_candidates[:QUERIES].sum(axis=1), one["demand"]),
                  f"sharded: shard candidates do not sum to the single demand {key}")
        row = dict(k=k, selection=sel, rerank=rerank, seconds=sh["seconds"],
                   single_seconds=one["seconds"], qps=QUERIES / sh["seconds"],
                   single_qps=QUERIES / one["seconds"], recall_at_10=rec,
                   single_recall_at_10=rec1, ids_same=same, bitwise=bitwise,
                   truncated_share=trunc, single_truncated_share=trunc1,
                   compared_share=float(whole.mean()),
                   shard_candidates_mean=res.shard_candidates[:QUERIES].mean(axis=0).tolist())
        print(f"sharded: search {json.dumps(row)}", flush=True)
        rows.append(row)
    profiles = {rerank: {"sharded": profile_call(
                            torch, lambda: searchers["query_aware"].search_with_stats(
                                queries_np, k=10, rerank=rerank), f"sharded {rerank}"),
                         "single": profile_call(
                            torch, lambda: index.replace_cfg(rerank=rerank).search_with_stats(
                                queries_np, k=10), f"single {rerank}")}
                for rerank in ("masked_full", "gather")}
    return {"placement": placement, "searches": rows, "launches": launches,
            "profiles": profiles}


def sharded_engine(torch, index, queries_np) -> dict:
    """The engine phase's 1000-request stream through ``index.engine("sharded",
    shards=SHARDS)`` at max_batch 64 beside a single-device engine: of the
    requests neither placement truncated (at least 90 %), >= 99.9 % of the
    ids equal and the dists within masked_rerank's tolerance (the share bit
    for bit is recorded); ``shards`` and the combine's pairs a query in the
    telemetry, launches exact a batch."""
    import numpy as np

    from repro_torch.serving import AnnRequest

    view = index.replace_cfg(rerank="gather")
    stream = engine_stream(view.cfg, queries_np)
    reqs = [AnnRequest(**r) for r in stream]
    n = len(reqs)
    out, results = {}, {}
    masked_b, gather_b, _per_bucket = sync_batches(view.cfg, stream, 64)
    for placement in ("single", "sharded"):
        engine = view.engine(placement, shards=SHARDS if placement == "sharded" else None,
                             max_batch=64)
        engine.search(reqs)  # warm-up
        engine.reset_telemetry()
        per = SHARDS if placement == "sharded" else 1
        (secs, res), launches = run_path(
            torch, "sharded_engine", lambda: _median_s(torch, lambda: engine.search(reqs), 1),
            expect={"l2dist": masked_b + gather_b, "schist": per * masked_b,
                    "masked_rerank": per * masked_b, "scscore": per * gather_b,
                    "kmeans_assign": 0})
        t = engine.telemetry()
        check(len(res) == n and t["requests_served"] == n, f"sharded engine: {placement} served")
        results[placement] = res
        out[placement] = dict(engine_row(t, secs, n), launches=launches)
        if placement == "sharded":
            pairs = float(np.mean([SHARDS * (10 if r["k"] is None else r["k"]) for r in stream]))
            check(t["shards"] == SHARDS and t["backend"] == "ShardedAnnBackend",
                  f"sharded engine: telemetry shards {t['shards']} backend {t['backend']}")
            check(abs(t["combine_pairs_per_query"] - pairs) < 1e-9,
                  f"sharded engine: combine pairs {t['combine_pairs_per_query']} vs {pairs}")
            out[placement].update(combine_pairs_per_query=t["combine_pairs_per_query"],
                                  shard_candidates_mean=t["shard_candidates_mean"],
                                  shard_truncation_rate=t["shard_truncation_rate"])
    # the requests no placement truncated. At the engine's batch of 64 the
    # gather re-rank's batched product may round a candidate's distance in
    # another last bit on a shard's (64, cap / 4) shape than on the one
    # device's, so all are held as the masked-full searches above
    pairs = [(a, b) for a, b in zip(results["single"], results["sharded"])
             if not (a.truncated or b.truncated)]
    same = same_share([b.ids for _a, b in pairs], [a.ids for a, _b in pairs])
    want_d, got_d = (np.concatenate([p[i].dists for p in pairs]) for i in (0, 1))
    fin = np.isfinite(want_d)
    atol = 1e-5 * float(2 * (queries_np ** 2).sum(1).max() + index.sc_index.data_norms.max())
    close = (np.array_equal(fin, np.isfinite(got_d))
             and np.allclose(got_d[fin], want_d[fin], rtol=1e-5, atol=atol))
    check(len(pairs) >= 0.9 * n and same >= 0.999 and close,
          f"sharded engine: {len(pairs)} of {n} untruncated, ids same {same}, dists close {close}")
    out.update(compared=len(pairs), ids_same=same, bitwise_share=float(np.mean(
        [np.array_equal(a.ids, b.ids) and np.array_equal(a.dists.view(np.uint32),
                                                         b.dists.view(np.uint32))
         for a, b in pairs])))
    print(f"sharded: engine {json.dumps(out)}", flush=True)
    return out


def sharded_serve(torch, index) -> dict:
    """``serve_ann --shards SHARDS`` in this process on a save of the index
    (gather, 256 mixed requests): it must serve every request through the
    sharded backend and the gather path's kernels."""
    import contextlib
    import io

    from repro_torch.launch import serve_ann

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "index")
        index.replace_cfg(rerank="gather").save(path)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            results, launches = run_path(
                torch, "sharded_serve", lambda: serve_ann.main(
                    ["--load-index", path, "--requests", "256", "--pressure", "64", "--mixed",
                     "--shards", str(SHARDS)]),
                expect={"schist": 0, "masked_rerank": 0, "kmeans_assign": 0})
        secs = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    for ln in lines:
        print(f"sharded serve: {ln}", flush=True)
    row = served_telemetry(lines, "sharded")
    check(len(results) == row["served"] == 256
          and any(f"[ShardedAnnBackend, {SHARDS} shard(s)]" in ln for ln in lines),
          "sharded serve: not every request served through the sharded backend")
    return dict(seconds=secs, **row, launches=launches, stdout=lines)


def sharded_build_stats(torch, index) -> dict:
    """The distributed covariance, one Lloyd step on one projected half and
    the cell sizes over SHARDS row shards of the corpus on the card,
    against single-device: the moments within tests/test_distributed.py's
    tolerances of a float64 computation, the Lloyd assignments and the cell
    sizes bit for bit, the centroids within its rtol 1e-3 / atol 1e-4 of
    the one-device step, and two sharded steps bit for bit."""
    from repro_torch.clustering.kmeans import lloyd_step
    from repro_torch.core import distributed
    from repro_torch.core.transform import apply_transform

    idx = index.sc_index
    mesh = [idx.device] * SHARDS
    x = idx.data
    xs = distributed.shard_rows(x, mesh)
    mean, cov = distributed.make_distributed_cov(mesh, idx.n)(xs)
    x64 = x.double()
    mean64 = x64.mean(0)
    cov64 = (x64 - mean64).T @ (x64 - mean64) / (idx.n - 1)
    del x64
    check(torch.allclose(mean.double(), mean64, rtol=2e-4, atol=2e-4), "sharded build: mean")
    check(torch.allclose(cov.double(), cov64, rtol=2e-2, atol=2e-4), "sharded build: covariance")
    sub = idx.subspaces[0]
    half = apply_transform(idx.transform, x)[:, :sub.centroids1.shape[1]].contiguous()
    lloyd = distributed.make_distributed_lloyd(mesh)
    halves = distributed.shard_rows(half, mesh)
    (c1, a1), launches = run_path(torch, "sharded_build", lambda: lloyd(halves, sub.centroids1),
                                  expect={"kmeans_assign": SHARDS})
    c2, a2 = lloyd(halves, sub.centroids1)
    c_one, a_one = lloyd_step(half, sub.centroids1)
    check(torch.equal(a1, a_one), "sharded build: Lloyd assignments differ from one device's")
    check(torch.allclose(c1, c_one, rtol=1e-3, atol=1e-4), "sharded build: Lloyd centroids")
    check(torch.equal(c1, c2) and torch.equal(a1, a2), "sharded build: two steps differ")
    sizes = distributed.make_distributed_cell_sizes(mesh, sub.sqrt_k)(
        distributed.shard_rows(sub.assign1, mesh), distributed.shard_rows(sub.assign2, mesh))
    check(torch.equal(sizes, sub.cell_sizes), "sharded build: cell sizes")
    row = dict(mean_max_abs_err=float((mean.double() - mean64).abs().max()),
               cov_max_abs_err=float((cov.double() - cov64).abs().max()),
               centroids_max_abs_err=float((c1 - c_one).abs().max()), launches=launches)
    print(f"sharded: build statistics {json.dumps(row)}", flush=True)
    return row


def phase_sharded(torch, index, queries_np, queries, gt) -> dict:
    """Phase 10: the TaCo index placed as SHARDS shard views on the card,
    searched, served and its build statistics computed corpus-sharded."""
    out = {"kernels": sharded_kernels(torch, index, index.searcher(
        "sharded", shards=SHARDS).views, queries)}
    out.update(sharded_searches(torch, index, queries_np, queries, gt))
    out["engine"] = sharded_engine(torch, index, queries_np)
    out["serve"] = sharded_serve(torch, index)
    out["build"] = sharded_build_stats(torch, index)
    torch.cuda.empty_cache()
    return out


#: ``python -m repro_torch.launch.serve_ann`` as run by the serve phase, with
#: the kernels' launch counts printed by the same process when it ends, and
#: its seconds from the parent's spawn to the end of the imports and from
#: there to the end of the run
SERVE_WRAPPER = (
    "import json, os, runpy, time\n"
    "from repro_torch.kernels import cuda\n"
    "t1 = time.time()\n"
    "cuda.reset_launch_counts()\n"
    "try:\n"
    "    runpy.run_module('repro_torch.launch.serve_ann', run_name='__main__', alter_sys=True)\n"
    "finally:\n"
    "    print('launches ' + json.dumps(cuda.launch_counts), flush=True)\n"
    "    print('blocks ' + json.dumps(cuda.launch_blocks), flush=True)\n"
    "    print('timing ' + json.dumps({'start_s': t1 - float(os.environ['SERVE_T0']),\n"
    "                                  'run_s': time.time() - t1}), flush=True)\n"
)


def serve_run(root, args, label: str) -> dict:
    """One run of the launcher in a child process (its own CUDA context):
    exit code 0, its printed telemetry, and the launches of the serve
    path's kernels in that process."""
    import os

    env = dict(os.environ, PYTHONPATH=str(root / "src"), SERVE_T0=repr(time.time()))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", SERVE_WRAPPER, *map(str, args)], cwd=root,
                          env=env, capture_output=True, text=True, timeout=500)
    secs = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    for ln in lines:
        print(f"serve {label}: {ln}", flush=True)
    check(proc.returncode == 0, f"serve {label}: exit {proc.returncode}: {proc.stderr[-3000:]}")
    launches = json.loads(next(ln for ln in lines if ln.startswith("launches "))[9:])
    blocks = json.loads(next(ln for ln in lines if ln.startswith("blocks "))[7:])
    timing = json.loads(next(ln for ln in lines if ln.startswith("timing "))[7:])
    for kernel in PATHS["serve"]:
        check(launches[kernel] > 0, f"kernel {kernel} was not launched on the serve path ({label})")
    return dict(seconds=secs, **served_telemetry(lines, label), launches=launches,
                launch_blocks=blocks, **timing, stdout=lines)


def served_telemetry(lines, label: str) -> dict:
    """The launcher's printed served count, batches, p50/p99 and QPS."""
    import re

    text = "\n".join(lines)
    served = re.search(r"served (\d+) requests in (\d+) batches", text)
    lat = re.search(r"p50 latency ([\d.]+) ms\s+p99 ([\d.]+) ms\s+(\d+) queries/s", text)
    check(served is not None and lat is not None, f"serve {label}: no telemetry printed")
    return dict(served=int(served.group(1)), batches=int(served.group(2)),
                p50_ms=float(lat.group(1)), p99_ms=float(lat.group(2)), qps=float(lat.group(3)))


#: the launcher's corpus in the serve phase
SERVE_N = 1_000_000


def phase_serve(torch, root, index, tune: dict) -> dict:
    """Phase 10: the launcher at full width: an async churned server with a
    durable WAL and recall probes that saves its snapshot, then a restart
    from it that replays the WAL and verifies recovery bit for bit, once as
    it is and once with ``--autotune-cache`` (``tune``: the autotune
    phase's file and entries) in batches of 64, whose last launches carry
    the bucket-64 winners; then the engine phase's index saved with
    ``use_kernels`` off (as the default config saves it), which the
    launcher must serve through the gather path's kernels on the card."""
    import shutil

    from repro_torch.kernels import autotune

    with tempfile.TemporaryDirectory() as tmp:
        wal, snap = Path(tmp) / "wal", Path(tmp) / "snap"
        first = serve_run(root, ["--n", SERVE_N, "--d", 128, "--requests", 1000,
                                 "--pressure", 64, "--async", "--producers", 4,
                                 "--deadline-ms", 50, "--churn", 256, "--wal-dir", wal,
                                 "--durability", "async", "--recall-probe-every", 50,
                                 "--rerank", "masked_full", "--save-index", snap], "first")
        check(first["served"] == 1000 and "engine swaps" in "\n".join(first["stdout"]),
              f"serve first: served {first['served']}")
        # the tuned restart recovers the same snapshot and log: the first
        # restart's compaction moves the log on
        snap_copy, wal_copy = Path(tmp) / "snap_tuned", Path(tmp) / "wal_tuned"
        shutil.copytree(snap, snap_copy)
        shutil.copytree(wal, wal_copy)
        second = serve_run(root, ["--load-index", snap, "--wal-dir", wal, "--verify-recovery",
                                  "--requests", 256], "recovery")
        check(second["served"] == 256
              and any("post-compaction bitwise MATCH" in ln for ln in second["stdout"]),
              "serve recovery: no bitwise MATCH")
        check({op: second["launch_blocks"][op] for op in autotune.OPS}
              == {op: list(b) for op, b in autotune.DEFAULT_BLOCKS.items()},
              f"serve recovery: launched {second['launch_blocks']} without a cache")
        tuned = serve_run(root, ["--load-index", snap_copy, "--wal-dir", wal_copy,
                                 "--verify-recovery", "--requests", 256, "--pressure", 64,
                                 "--autotune-cache", tune["path"]], "recovery tuned")
        replays = [next(ln for ln in run["stdout"] if "WAL records" in ln).split("replayed ")[1]
                   for run in (second, tuned)]
        check(replays[0] == replays[1], f"serve recovery tuned: replayed {replays}")
        loaded = f"autotune: {len(tune['cache'])} (bq, bn) entries warm-loaded"
        check(tuned["served"] == 256
              and any("post-compaction bitwise MATCH" in ln for ln in tuned["stdout"])
              and any(loaded in ln for ln in tuned["stdout"]),
              "serve recovery tuned: no bitwise MATCH or no warm-load reported")
        # the churned base keeps 10^6's bucket (~2,000 rows more); a run cut
        # by --n tuned another bucket, so the launcher runs the defaults
        want = {op: tune["cache"].get(f"{op}|cuda|f32|64|{autotune._bucket(SERVE_N)}",
                                      list(autotune.DEFAULT_BLOCKS[op]))
                for op in autotune.OPS}
        check({op: tuned["launch_blocks"][op] for op in autotune.OPS} == want,
              f"serve recovery tuned: launched {tuned['launch_blocks']}, the winners are {want}")
        plain = Path(tmp) / "plain"
        index.replace_cfg(use_kernels=False, rerank="gather").save(str(plain))
        third = serve_in_process(torch, ["--load-index", str(plain), "--requests", "256",
                                         "--pressure", "64", "--mixed"])
    # no kernel refuses a config, so no load is served through the plain
    # path (serve_ann.kernels_on_card): the launcher must not say it was
    for label, run in (("recovery", second), ("recovery tuned", tuned),
                       ("default config", third)):
        run["plain_path"] = plain_route(run["stdout"])
        print(f"serve {label}: load through the plain path: {run['plain_path']}", flush=True)
        check(run["plain_path"] is None, f"serve {label}: served through the plain path")
    return {"first": first, "recovery": second, "recovery_tuned": tuned,
            "default_config": third}


def plain_route(lines) -> str | None:
    """The launcher's line saying that it serves a loaded config through
    the plain PyTorch path, and why; None where it printed none."""
    return next((ln for ln in lines if "through the plain PyTorch path" in ln), None)


def serve_in_process(torch, args) -> dict:
    """The launcher's ``main`` in this process (a child would add its own
    start) on a save whose config has ``use_kernels`` off: it must say it
    serves through the kernels, and launch the gather path's."""
    import contextlib
    import io

    from repro_torch.launch import serve_ann

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results, launches = run_path(torch, "serve_load", lambda: serve_ann.main(args))
    secs = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    for ln in lines:
        print(f"serve default config: {ln}", flush=True)
    row = served_telemetry(lines, "default config")
    check(len(results) == row["served"] == 256 and launches["schist"] == 0
          and launches["masked_rerank"] == 0
          and any("through the CUDA kernels" in ln for ln in lines),
          "serve default config: not served through the gather path's kernels")
    return dict(seconds=secs, **row, launches=launches, stdout=lines)


#: the lm phase: granite-3-2b at full width (40 layers, d_model 2048, 32
#: heads of 64, 8 KV heads, vocab 49155; ~2.6 B parameters, float32), its
#: weights from a seeded generator on the card
LM_ARCH = "granite-3-2b"
LM_SERVE_ARGS = ["--arch", LM_ARCH, "--requests", "8", "--max-new", "16", "--slots", "4",
                 "--max-seq", "256"]
LM_PREFILL = 4096
LM_DECODE_STEPS = 16
#: the kernel path's logits against the plain path's (impl="torch", the
#: reference's rounding points) on the same weights. float32: rtol = atol
#: and the share of the 4096 positions whose top-1 token agrees. bf16: the
#: plain path rounds scores and probabilities to bf16 where the kernel keeps
#: float32, so the top-1 share is gated, and the kernel path's mean
#: |logits - f32 plain logits| may be at most LM_BF16_MEAN_SLACK times the
#: plain bf16 path's (slack for the two paths' own output roundings)
LM_F32_TOL, LM_F32_TOP1 = 1e-3, 0.99
LM_BF16_TOP1 = 0.95
LM_BF16_MEAN_SLACK = 1.1
#: TaCo decode retrieving every slot against full decode, float32
LM_TACO_EXACT_TOL = 1e-3
LM_TACO_EXACT_STEPS = 4


def cuda_timed_calls(torch, module, names, timings: dict):
    """Wrap ``module.<name>`` for each name so that every call records a
    pair of CUDA events around it in ``timings[name]``; returns a function
    that puts the originals back."""
    originals = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            timings.setdefault(name, []).append((start, end))
            return out
        return call

    for name, fn in originals.items():
        setattr(module, name, wrap(name, fn))
    return lambda: [setattr(module, n, f) for n, f in originals.items()]


def hold_flash_call(torch, label: str, q, k, v, causal, got):
    """One flash kernel call of a path against flash_attention_plain on the
    same inputs at FLASH_TOL[dtype]; a bf16 call also against the f32 plain
    version on the upcast inputs at FLASH_BF16_VS_F32. Returns the largest
    error and the share of the f32 allowance used (None for an f32 call)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    dtype = str(q.dtype).removeprefix("torch.")
    tol = FLASH_TOL[dtype]
    want = flash_attention_plain(q, k, v, causal).float()
    err = float((got.float() - want).abs().max())
    check(tuple(got.shape) == tuple(q.shape) and got.dtype == q.dtype,
          f"{label}: flash output {tuple(got.shape)} {got.dtype}")
    check(torch.allclose(got.float(), want, rtol=tol, atol=tol),
          f"{label}: flash max abs err {err} above {tol}")
    share = None
    if dtype == "bfloat16":
        rtol, atol = FLASH_BF16_VS_F32
        want = flash_attention_plain(q.float(), k.float(), v.float(), causal)
        share = float(((got.float() - want).abs() / (atol + rtol * want.abs())).max())
        check(share <= 1.0, f"{label}: flash uses {share} of the allowed error against the "
                            "f32 plain version")
    return err, share


def capture_shapes(ops, seen: dict):
    """Wrap ops.flash_attention_cuda so that the first call of each (q
    shape, k shape, causal) lands in ``seen`` (inputs and output cloned);
    returns a function that puts the original back. Launches still go
    through the wrapper, so they count."""
    launch = ops.flash_attention_cuda

    def capture(q, k, v, causal):
        out = launch(q, k, v, causal)
        key = (tuple(q.shape), tuple(k.shape), bool(causal))
        if key not in seen:
            seen[key] = tuple(x.detach().clone() for x in (q, k, v)) + (causal, out.clone())
        return out

    ops.flash_attention_cuda = capture
    return lambda: setattr(ops, "flash_attention_cuda", launch)


def event_ms(torch, timings: dict) -> dict:
    torch.cuda.synchronize()
    return {name: [s.elapsed_time(e) for s, e in pairs] for name, pairs in timings.items()}


def attention_layers(cfg) -> int:
    """Flash launches a prefill: one a decoder attention layer (two with
    cross-attention) and one an encoder layer."""
    n_attn = cfg.n_groups * sum(spec["mixer"] == "attn" for spec in cfg.layer_specs())
    return n_attn * (2 if cfg.encoder_layers else 1) + cfg.encoder_layers


def lm_serve(torch, cfg, args=None, path: str = "lm_serve", label: str = "lm serve") -> dict:
    """python -m repro_torch.launch.serve's main in process at full width:
    8 requests, 16 new tokens each, 4 slots, max_seq 256, bf16 compute. One
    flash launch an attention layer a prefill (none for RWKV), each
    prefill's first-layer call held against the plain flash version (bf16,
    and f32 on the upcast inputs); prefill and decode-step ms from CUDA
    events around the engine's calls."""
    import contextlib
    import io
    import re

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving import engine as lm_engine

    timings: dict = {}
    firsts: list = []  # each prefill's first-layer kernel call
    calls = [0]
    launch = ops.flash_attention_cuda
    n_attn = attention_layers(cfg)

    def capture(q, k, v, causal):
        out = launch(q, k, v, causal)
        if calls[0] % n_attn == 0:
            firsts.append((q, k, v, causal, out))
        calls[0] += 1
        return out

    restore = cuda_timed_calls(torch, lm_engine, ("prefill", "decode_step"), timings)
    out = io.StringIO()
    t0 = time.perf_counter()
    ops.flash_attention_cuda = capture
    try:
        with contextlib.redirect_stdout(out):
            outs, launches = run_path(torch, path, lambda: serve.main(args or LM_SERVE_ARGS))
    finally:
        ops.flash_attention_cuda = launch
        restore()
    secs = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    for ln in lines:
        print(f"{label}: {ln}", flush=True)
    ms = event_ms(torch, timings)
    served = re.search(r"served (\d+) requests, (\d+) tokens in ([\d.]+)s \(([\d.]+) tok/s\)",
                       out.getvalue())
    check(served is not None, f"{label}: no served line printed")
    requests, tokens = int(served.group(1)), int(served.group(2))
    prefills = len(ms["prefill"])
    check(requests == 8 and tokens == 8 * 16 == sum(map(len, outs)) and prefills == 8,
          f"{label}: {requests} requests, {tokens} tokens, {prefills} prefills")
    check(launches["flash_attention"] == n_attn * prefills,
          f"{label}: {launches['flash_attention']} flash launches for {prefills} prefills "
          f"of {n_attn} attention layers")
    # the kernel at the served shapes (prompts shorter than one tile)
    check(len(firsts) == (prefills if n_attn else 0),
          f"{label}: {len(firsts)} first-layer calls captured")
    kernel_err, used, lengths = 0.0, 0.0, []
    for q, k, v, causal, got in firsts:
        check(q.dtype == torch.bfloat16 and tuple(q.shape[::2]) == (cfg.n_heads, cfg.hd),
              f"{label}: kernel input {tuple(q.shape)} {q.dtype}")
        lengths.append(q.shape[1])
        err, share = hold_flash_call(torch, f"{label}: S {q.shape[1]} layer 0", q, k, v,
                                     causal, got)
        kernel_err, used = max(kernel_err, err), max(used, share)
    if not firsts:  # an attention-free model launches no kernel
        kernel_err = used = None
    del firsts
    decode = sorted(ms["decode_step"])
    row = dict(requests=requests, tokens=tokens, seconds_printed=float(served.group(3)),
               tok_per_s=float(served.group(4)), seconds=secs, prefills=prefills,
               flash_launches=launches["flash_attention"], prompt_lengths=lengths,
               layer0_flash_max_abs_err=kernel_err, layer0_share_of_allowed_vs_f32=used,
               prefill_ms=ms["prefill"], decode_steps=len(decode),
               decode_step_ms_median=decode[len(decode) // 2])
    print(f"{label}: {json.dumps(row)}", flush=True)
    row["launches"] = launches
    return row


def routing_spy(moe_module, seen: list, replay=None, probs_seen: list | None = None):
    """Wrap the MoE's ``route`` (no host sync); returns a function that puts
    the original back. Without ``replay`` each call's output lands in
    ``seen``; with ``probs_seen`` each call's router probabilities land
    there too. With ``replay`` (the outputs of an earlier run, in call
    order) each call takes that run's decisions (expert ids, dispatch
    order, positions, kept set), its gates renormalised from its own
    probabilities, and ``seen`` gets, token by token, whether its own
    top-k and kept set were the same: the routing is pinned, so that two
    paths that differ before the router by rounding are compared on the
    same experts."""
    route = moe_module.route
    calls = iter(replay or ())

    def spy(probs, k, cap):
        out = route(probs, k, cap)
        if probs_seen is not None:
            probs_seen.append(probs)
        if replay is None:
            seen.append(out)
            return out
        exp_idx, _, fe, pos, keep = next(calls)
        t = probs.shape[0]
        seen.append((out[0] == exp_idx).all(-1) & (out[4].view(k, t) == keep.view(k, t)).all(0))
        gates = probs.gather(1, exp_idx)
        return exp_idx, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), fe, pos, keep

    moe_module.route = spy
    return lambda: setattr(moe_module, "route", route)


def lm_prefill(torch, params, cfg, tokens, path: str = "lm_prefill") -> dict:
    """forward over the tokens (4096 at granite-3-2b) through the flash
    kernel, in float32 and in the config's bf16, against the plain path
    (impl="torch") on the same weights; the first layer's kernel call held
    against the plain flash version; the kernel path timed beside the plain
    path and beside scaled_dot_product_attention routed the same way. With
    experts the plain path's routing is pinned to the kernel path's
    (routing_spy's replay): a router near-tie would otherwise send a token
    to other experts on rounding alone (the paths differ by ~1e-6 before
    the router in f32), which moves it by design; the share of tokens whose
    own routing was the same in every layer is recorded."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import attention as lm_attention
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    n = tokens.shape[1]
    rows = {}
    top1_f32 = None  # the float32 kernel path's top-1 tokens
    exact = None  # the float32 plain path's logits
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        batch = {"tokens": tokens}
        seen: dict = {}
        copies, expansions = fa.aligned_copies, lm_attention.kv_expansions
        routes, alike = [], []
        restore = capture_shapes(ops, seen)
        unspy = routing_spy(MOE, routes)
        try:
            got, launches = run_path(torch, path, lambda: M.forward(params, c, batch)[0],
                                     expect={"flash_attention": cfg.n_layers})
        finally:
            restore()
            unspy()
        copies = fa.aligned_copies - copies
        expansions = lm_attention.kv_expansions - expansions
        check(copies == 0 and expansions == cfg.n_layers,
              f"lm prefill {dtype}: {copies} aligned copies, {expansions} K/V expansions")
        # the kernel at the path's first call, against its plain version
        q, k, v, causal, out = next(iter(seen.values()))
        check(tuple(q.shape) == (cfg.n_heads, n, cfg.hd) and q.dtype == c.cdtype,
              f"lm prefill {dtype}: kernel input {tuple(q.shape)} {q.dtype}")
        kernel_err, used = hold_flash_call(torch, f"lm prefill {dtype}: layer 0", q, k, v,
                                           causal, out)
        del seen, q, k, v, out
        unspy = routing_spy(MOE, alike, replay=routes)
        try:
            plain = M.forward(params, c, batch, impl="torch")[0]
        finally:
            unspy()
        routed_alike = (float(torch.stack(alike).all(0).float().mean()) if alike else None)
        del routes, alike
        err = float((got - plain).abs().max())
        top1 = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
        if top1_f32 is None:
            top1_f32 = got.argmax(-1)
        # which bf16 path keeps the float32 result's top-1 token more often
        vs_f32 = {path: float((x.argmax(-1) == top1_f32).float().mean())
                  for path, x in (("kernel", got), ("plain", plain))}
        finite = bool(torch.isfinite(got).all())
        check(finite and tuple(got.shape) == (1, n, cfg.vocab_size),
              f"lm prefill {dtype}: logits {tuple(got.shape)}, finite {finite}")
        mean_vs_f32 = None
        if dtype == "float32":
            check(torch.allclose(got, plain, rtol=LM_F32_TOL, atol=LM_F32_TOL)
                  and top1 >= LM_F32_TOP1,
                  f"lm prefill f32: max abs err {err}, top-1 agreement {top1}")
            exact = plain
        else:
            check(top1 >= LM_BF16_TOP1, f"lm prefill bf16: top-1 agreement {top1}")
            # the kernel keeps scores and probabilities in f32 where the plain
            # bf16 path rounds them: it must be no further from the f32 logits
            mean_vs_f32 = {path: float((x - exact).abs().mean())
                           for path, x in (("kernel", got), ("plain", plain))}
            check(mean_vs_f32["kernel"] <= LM_BF16_MEAN_SLACK * mean_vs_f32["plain"],
                  f"lm prefill bf16: mean |logits - f32 logits| {mean_vs_f32}")
            del exact
        del got, plain
        torch.cuda.empty_cache()
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def sdpa_launch(q, k, v, causal):  # the library call in the kernel's place
            return sdpa(q[None], k[None], v[None], is_causal=causal)[0]

        ms = timed(torch, lambda: M.forward(params, c, batch), 2)
        plain_ms = timed(torch, lambda: M.forward(params, c, batch, impl="torch"), 2)
        launch = ops.flash_attention_cuda
        ops.flash_attention_cuda = sdpa_launch
        try:
            sdpa_ms = timed(torch, lambda: M.forward(params, c, batch), 2)
        finally:
            ops.flash_attention_cuda = launch
        profiled = profile_call(torch, lambda: M.forward(params, c, batch), f"lm prefill {dtype}")
        rows[dtype] = dict(max_abs_err=err, tokens_routed_alike=routed_alike,
                           top1_agreement=top1, top1_vs_f32_kernel=vs_f32,
                           mean_abs_vs_f32_plain=mean_vs_f32, ms=ms, plain_ms=plain_ms,
                           sdpa_routed_ms=sdpa_ms, layer0_flash_max_abs_err=kernel_err,
                           layer0_share_of_allowed_vs_f32=used)
        print(f"lm prefill {dtype}: {json.dumps(rows[dtype])}", flush=True)
        rows[dtype]["launches"], rows[dtype]["profile"] = launches, profiled
        torch.cuda.empty_cache()
    return rows


def lm_decode_profile(torch, params, cfg) -> dict:
    """One decode step at the served shape (4 slots at positions 5-20 of a
    256-slot cache, bf16) under the profiler, after one unprofiled step."""
    from repro_torch.models import model as M

    cache = M.init_cache(cfg, 4, 256)
    step = torch.zeros((4, 1), dtype=torch.long, device="cuda")
    pos = torch.tensor([5, 10, 15, 20], device="cuda")
    M.decode_step(params, cfg, cache, step, pos)
    return profile_call(torch, lambda: M.decode_step(params, cfg, cache, step, pos + 1),
                        "lm serve decode step")


def lm_teacher_forced(torch, params, cfg, tokens, steps: int, label: str,
                      profile: bool = False) -> tuple:
    """Prefill all but the last ``steps`` tokens (counted as a path run),
    then teacher-force them; (per-step logits, decode-step ms, prefill
    launches, the cache, the profile). With ``profile`` the last step runs
    under the profiler and is left out of the step times."""
    from repro_torch.models import model as M

    n = tokens.shape[1] - steps
    (_, cache), launches = run_path(
        torch, "lm_taco", lambda: M.prefill(params, cfg, {"tokens": tokens[:, :n]},
                                            tokens.shape[1]),
        expect={"flash_attention": cfg.n_layers})
    logits, step_ms, profiled = [], [], None
    for t in range(n, tokens.shape[1]):
        if profile and t == tokens.shape[1] - 1:
            box = []
            profiled = profile_call(torch, lambda: box.append(M.decode_step(
                params, cfg, cache, tokens[:, t:t + 1], t)), f"lm {label} decode step")
            logits.append(box[0][0][:, 0])
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, cache = M.decode_step(params, cfg, cache, tokens[:, t:t + 1], t)
        end.record()
        logits.append(out[:, 0])
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    check(all(bool(torch.isfinite(x).all()) for x in logits), f"lm taco {label}: non-finite logits")
    return logits, step_ms, launches, cache, profiled


def lm_taco(torch, params, cfg, tokens) -> dict:
    """TaCo retrieval decode at full width, as
    examples/retrieval_attention_serve.py reports it: prefill 4096 tokens
    with the default RetrievalConfig, 16 teacher-forced steps beside full
    attention (mean TVD, argmax agreement; random weights are its worst
    case); the exactness gate at float32 with n_retrieve >= the cache
    length; the retrieval build's ms for one layer; decode-step ms."""
    import dataclasses

    from repro_torch.models import taco_attention as TA

    steps = LM_DECODE_STEPS
    full, full_ms, l_full, _, full_prof = lm_teacher_forced(
        torch, params, dataclasses.replace(cfg, attention_kind="full"), tokens, steps, "full",
        profile=True)
    taco, taco_ms, l_taco, cache, taco_prof = lm_teacher_forced(
        torch, params, dataclasses.replace(cfg, attention_kind="taco"), tokens, steps, "taco",
        profile=True)
    tvd = [float(0.5 * (torch.softmax(f, -1) - torch.softmax(t, -1)).abs().sum())
           for f, t in zip(full, taco)]
    agree = sum(int(torch.argmax(f) == torch.argmax(t)) for f, t in zip(full, taco))
    del full, taco
    # the build alone, on the first layer's 4096 prefilled keys
    keys = cache["l0"]["k"][0][:, :LM_PREFILL].float()
    build_ms = timed(torch, lambda: TA.build_retrieval_state(keys, cfg.retrieval), 3)
    del cache, keys
    # exactness: retrieve every slot, float32
    exact_tokens = tokens[:, :LM_PREFILL + LM_TACO_EXACT_STEPS]
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    every = dataclasses.replace(cfg.retrieval, n_retrieve=exact_tokens.shape[1])
    want, _, l_f32, _, _ = lm_teacher_forced(
        torch, params, dataclasses.replace(f32, attention_kind="full"), exact_tokens,
        LM_TACO_EXACT_STEPS, "exact full")
    got, _, l_exact, _, _ = lm_teacher_forced(
        torch, params, dataclasses.replace(f32, attention_kind="taco", retrieval=every),
        exact_tokens, LM_TACO_EXACT_STEPS, "exact taco")
    exact_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(all(torch.allclose(g, w, rtol=LM_TACO_EXACT_TOL, atol=LM_TACO_EXACT_TOL)
              for g, w in zip(got, want)),
          f"lm taco: retrieving every slot, max abs err {exact_err} against full decode")
    torch.cuda.empty_cache()
    row = dict(retrieval=dataclasses.asdict(cfg.retrieval), prefill_tokens=LM_PREFILL,
               steps=steps, mean_tvd=sum(tvd) / len(tvd), tvd=tvd, argmax_agree=agree,
               build_ms_per_layer=build_ms,
               taco_step_ms_median=sorted(taco_ms)[len(taco_ms) // 2],
               full_step_ms_median=sorted(full_ms)[len(full_ms) // 2],
               taco_step_ms=taco_ms, full_step_ms=full_ms,
               exact_max_abs_err=exact_err, exact_steps=LM_TACO_EXACT_STEPS)
    print(f"lm taco: {json.dumps(row)}", flush=True)
    row["launches"] = [l_full, l_taco, l_f32, l_exact]
    row["full_profile"], row["taco_profile"] = full_prof, taco_prof
    return row


def phase_lm(torch) -> dict:
    """Phase 12: the LM side at granite-3-2b's full width: the slot engine
    through the launcher, prefill at 4096 tokens through the flash kernel
    against the plain path, TaCo retrieval decode beside full attention."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, param_count

    cfg = get_arch(LM_ARCH)
    check(not torch.backends.cuda.matmul.allow_tf32, "lm: TF32 matmuls are on")
    serve = lm_serve(torch, cfg)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, LM_PREFILL + LM_DECODE_STEPS),
                           generator=gen, device="cuda")
    print(f"lm: {cfg.name} {param_count(params)} parameters drawn in {init_s:.2f} s", flush=True)
    prefill = lm_prefill(torch, params, cfg, tokens[:, :LM_PREFILL])
    serve["decode_profile"] = lm_decode_profile(torch, params, cfg)
    taco = lm_taco(torch, params, cfg, tokens)
    del params
    torch.cuda.empty_cache()
    launches = [serve["launches"], prefill["float32"]["launches"],
                prefill["bfloat16"]["launches"], *taco["launches"]]
    return {"arch": cfg.name, "init_s": init_s, "serve": serve, "prefill": prefill,
            "taco": taco, "launches": launches}


TRAIN_STEPS = 4
#: the kernel path's gradients against the plain path's (impl="torch"),
#: float32 at granite's width and 2 layers: the kernel's forward sums in
#: another order than the einsum softmax, its gradient is the plain one's,
#: so each leaf may differ by that order's rounding: ||g - g_plain|| at most
#: this share of ||g_plain||
TRAIN_GRAD_RTOL = 1e-4
#: device kernels of a profiled train step, grouped by name
TRAIN_KINDS = (("flash", ("flash",)), ("products", ("gemm", "nvjet", "xmma", "cutlass")),
               ("copies and casts", ("copy",)), ("reductions", ("reduce",)))


def profile_kinds(prof_row: dict) -> dict:
    """Device microseconds of a :func:`profile_call` row's kernels by kind
    (:data:`TRAIN_KINDS`, the rest "other elementwise")."""
    kinds: dict = {}
    for us, _count, op in prof_row.get("device_ops", []):
        name = op.lower()
        kind = next((k for k, keys in TRAIN_KINDS if any(x in name for x in keys)),
                    "other elementwise")
        kinds[kind] = kinds.get(kind, 0.0) + us
    return kinds


def train_full_width(torch, cfg) -> dict:
    """make_train_step at granite-3-2b's full width: seeded float32
    parameters, AdamW, warmup_cosine, launch.train's batch 8 x 128, bf16
    compute, remat on; TRAIN_STEPS steps with CUDA events around each, the
    flash launches counted exactly (one a layer forward, one in the remat
    recompute), the first layer's first kernel call held against the plain
    flash version, one more step under torch.profiler, the peak memory."""
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import make_train_step, train_state_init
    from repro_torch.utils import tree_flatten

    check(cfg.remat, "train: remat is off")
    opt = adamw()
    step_fn = make_train_step(cfg, opt, warmup_cosine(3e-4, 20, TRAIN_STEPS + 1))
    stream = SyntheticTokenStream(cfg.vocab_size, 128, 8, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_state_init(torch.Generator(device="cuda").manual_seed(0), cfg, opt[0])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    steps = []

    def run():
        nonlocal state
        for s in range(TRAIN_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            state, m = step_fn(state, stream.batch(s))
            end.record()
            torch.cuda.synchronize()
            steps.append(dict(host_s=time.perf_counter() - t0, ms=start.elapsed_time(end),
                              loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                              lr=float(m["lr"])))

    alloc_keys = ("num_alloc_retries", "num_device_alloc", "num_device_free")
    before = {k: torch.cuda.memory_stats().get(k, 0) for k in alloc_keys}
    seen: dict = {}
    restore = capture_shapes(ops, seen)
    try:
        _, launches = run_path(torch, "train", run,
                               expect={"flash_attention": 2 * cfg.n_layers * TRAIN_STEPS})
    finally:
        restore()
    allocator = {k: torch.cuda.memory_stats().get(k, 0) - before[k] for k in alloc_keys}
    # the kernel at the training shape: (B*H, S, hd) = (8*32, 128, 64), bf16, causal
    q, k, v, causal, got = next(iter(seen.values()))
    check(tuple(q.shape) == (8 * cfg.n_heads, 128, cfg.hd) and q.dtype == cfg.cdtype
          and causal, f"train: kernel input {tuple(q.shape)} {q.dtype} causal {causal}")
    flash_err, flash_share = hold_flash_call(torch, "train: step 0 layer 0", q, k, v, causal,
                                             got)
    del seen, q, k, v, got
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in steps),
          f"train: a non-finite loss or grad norm {steps}")
    peak = torch.cuda.max_memory_allocated()
    prof = profile_call(torch, lambda: step_fn(state, stream.batch(TRAIN_STEPS)), "train step")
    steady = sorted(r["ms"] for r in steps[1:])
    tokens = 8 * 128
    row = dict(arch=cfg.name, params=sum(p.numel() for p in tree_flatten(state.params)[0]),
               init_s=init_s, steps=steps, step_ms_median=steady[len(steady) // 2],
               tok_per_s=tokens / (steady[len(steady) // 2] / 1e3),
               flash_launches=launches["flash_attention"], layer0_flash_max_abs_err=flash_err,
               layer0_share_of_allowed_vs_f32=flash_share, peak_gib=peak / 2**30,
               allocator_during_steps=allocator, profile_kinds_us=profile_kinds(prof))
    print(f"train: {json.dumps(row)}", flush=True)
    row["profile"], row["launches"] = prof, launches
    del state
    torch.cuda.empty_cache()
    return row


def train_grads_vs_plain(torch, cfg) -> dict:
    """One step's gradients at granite's full width, 2 layers, float32
    compute, on the kernel path (flash through its autograd Function)
    against the plain-attention path (impl="torch"): every leaf within
    TRAIN_GRAD_RTOL, every attention weight's gradient non-zero."""
    import dataclasses

    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.models import init_params
    from repro_torch.train import loss_fn
    from repro_torch.utils import tree_flatten, tree_flatten_with_paths

    small = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    batch = {k: torch.as_tensor(v, device="cuda").long()
             for k, v in SyntheticTokenStream(cfg.vocab_size, 128, 8, seed=1).batch(0).items()}
    params = init_params(torch.Generator(device="cuda").manual_seed(2), small)
    leaves, rebuild = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    grads = {}

    def grad(impl):
        loss, _aux = loss_fn(rebuild(leaves), small, batch, impl=impl)
        return rebuild(list(torch.autograd.grad(loss, leaves)))

    grads["kernel"], launches = run_path(torch, "train_grads", lambda: grad("kernel"),
                                         expect={"flash_attention": 2 * small.n_layers})
    grads["torch"] = grad("torch")
    worst = 0.0
    for path, g, w in zip(*tree_flatten_with_paths(grads["kernel"])[:2],
                          tree_flatten(grads["torch"])[0]):
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        worst = max(worst, rel)
        check(rel <= TRAIN_GRAD_RTOL, f"train grads: {path} kernel vs plain {rel}")
    attn = grads["kernel"]["blocks"]["l0"]["attn"]
    norms = {name: float(attn[name]["w"].norm()) for name in ("wq", "wk", "wv", "wo")}
    check(all(v > 0 for v in norms.values()), f"train grads: an attention weight has none {norms}")
    row = dict(layers=small.n_layers, worst_rel_err=worst, attention_grad_norms=norms)
    print(f"train grads: {json.dumps(row)}", flush=True)
    del params, leaves, grads
    torch.cuda.empty_cache()
    row["launches"] = launches
    return row


def train_smoke(torch) -> dict:
    """launch.train.main on the card at the smoke config: 60 steps with two
    microbatches (the loss must fall, as examples/train_lm.py asserts); 6
    straight steps against 3 + a checkpoint + --resume 3 (final loss within
    1e-4 relative, as tests/test_checkpoint.py holds it); one Adafactor
    step. The first kernel call (smoke width, float32) is held against the
    plain flash version."""
    import contextlib
    import io

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    base = ["--arch", LM_ARCH, "--smoke"]
    out = io.StringIO()

    def run():
        with contextlib.redirect_stdout(out), tempfile.TemporaryDirectory() as tmp:
            falls = train.main(base + ["--steps", "60", "--microbatches", "2", "--lr", "1e-3",
                                       "--log-every", "59"])
            straight = train.main(base + ["--steps", "6", "--log-every", "1"])
            train.main(base + ["--steps", "3", "--ckpt-dir", tmp, "--ckpt-every", "1"])
            resumed = train.main(base + ["--steps", "6", "--ckpt-dir", tmp, "--ckpt-every", "1",
                                         "--resume", "--log-every", "1"])
            adafactor = train.main(base + ["--steps", "1", "--optimizer", "adafactor"])
        return falls, straight, resumed, adafactor

    t0 = time.perf_counter()
    seen: dict = {}
    restore = capture_shapes(ops, seen)
    try:
        (falls, straight, resumed, adafactor), launches = run_path(torch, "train_smoke", run)
    finally:
        restore()
    secs = time.perf_counter() - t0
    q, k, v, causal, got = next(iter(seen.values()))
    flash_err, _ = hold_flash_call(torch, f"train smoke: first call {tuple(q.shape)} {q.dtype}",
                                   q, k, v, causal, got)
    check(falls[-1] < falls[0], f"train smoke: the loss did not fall {falls}")
    check("resumed from step 3" in out.getvalue(), "train smoke: no resume")
    rel = abs(resumed[-1] - straight[-1]) / abs(straight[-1])
    check(rel <= 1e-4, f"train smoke: resumed {resumed[-1]} vs straight {straight[-1]}")
    check(all(v == v for v in adafactor), f"train smoke: adafactor loss {adafactor}")
    row = dict(seconds=secs, loss_first=falls[0], loss_last=falls[-1],
               straight_final=straight[-1], resumed_final=resumed[-1], resume_rel_err=rel,
               adafactor_loss=adafactor[-1], first_flash_shape=list(q.shape),
               first_flash_max_abs_err=flash_err)
    print(f"train smoke: {json.dumps(row)}", flush=True)
    row["launches"] = launches
    return row


def phase_train(torch) -> dict:
    """LM training: granite-3-2b at full width for TRAIN_STEPS AdamW steps,
    the kernel path's gradients against the plain path's, and the smoke
    config through the launcher."""
    from repro_torch.configs import get_arch

    cfg = get_arch(LM_ARCH)
    check(not torch.backends.cuda.matmul.allow_tf32, "train: TF32 matmuls are on")
    full = train_full_width(torch, cfg)
    grads = train_grads_vs_plain(torch, cfg)
    smoke = train_smoke(torch)
    return {"full": full, "grads": grads, "smoke": smoke,
            "launches": [full["launches"], grads["launches"], smoke["launches"]]}


#: the families phase: the moe, ssm, hybrid, audio and vlm configs at full
#: width (arctic cut to 1 layer, jamba to one group of 8 layers and 4 of its
#: 16 experts, so that each fits one card), weights from a seeded generator
#: on the card, each model freed before the next
FAM_SERVE_ARGS = ["--requests", "8", "--max-new", "16", "--slots", "4", "--max-seq", "256"]
FAM_MOE_PREFILL = 2048  # granite-moe's forward in f32 and bf16 under the lm phase's gates
FAM_RWKV_PREFILL = 2048  # rwkv6's chunked prefill against the sequential one
FAM_WHISPER = (2, 16, 16)  # batch, decoder prompt, teacher-forced steps (over 1500 frames)
FAM_LLAVA = (64, 8)  # prompt behind the 576 patches, teacher-forced steps
FAM_CUT_PREFILL = 512  # arctic's and jamba's prompt
FAM_CUT_STEPS = 4
#: the chunked WKV against the sequential one over rwkv6's 32 layers in
#: float32: the last logits within LM_F32_TOL, every layer's WKV state
#: within this share of its largest entry (the reference holds one layer
#: at 2e-4, tests/test_models.py:206)
FAM_WKV_TOL = 1e-3


def fam_flash_shapes(torch, seen: dict, label: str) -> list:
    """Each new flash shape's first call on a path held against the plain
    version (hold_flash_call: FLASH_TOL, and bf16 also against the f32
    plain version), then the kernel timed beside the plain version and
    scaled_dot_product_attention on the same inputs, and its bound counted
    as phase_flash counts it (unmasked pairs, each input read once and the
    output written once, at the input type's peak rate)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for (qs, ks, causal), (q, k, v, _, got) in seen.items():
        err, share = hold_flash_call(torch, f"{label}: flash q {qs} k {ks} causal {causal}",
                                     q, k, v, causal, got)
        ms = timed(torch, lambda: ops.flash_attention_cuda(q, k, v, causal), 10)
        plain_ms = timed(torch, lambda: flash_attention_plain(q, k, v, causal), 3)
        sdpa_ms = timed(torch, lambda: sdpa(q[None], k[None], v[None], is_causal=causal), 10)
        (bh, n_q, hd), n_k = qs, ks[1]
        pairs = bh * (sum(min(i + 1, n_k) for i in range(n_q)) if causal else n_q * n_k)
        bound, by = bound_ms(q.element_size() * bh * hd * (2 * n_q + 2 * n_k), 4 * hd * pairs,
                             BF16_TENSOR_OPS if q.dtype == torch.bfloat16 else F32_OPS)
        rows.append(dict(q=list(qs), k=list(ks), causal=causal,
                         dtype=str(q.dtype).removeprefix("torch."), max_abs_err=err,
                         share_of_allowed_vs_f32=share, ms=ms, plain_ms=plain_ms,
                         sdpa_ms=sdpa_ms, bound_ms=bound, bound_by=by))
        print(f"{label}: flash {json.dumps(rows[-1])}", flush=True)
    return rows


def drop_share(routes) -> float:
    """The share of (token, choice) assignments that capacity dropped over
    the MoE calls ``routing_spy`` saw."""
    kept = sum(int(route[4].sum()) for route in routes)
    return 1 - kept / sum(route[4].numel() for route in routes)


def top_expert_share(routes) -> float:
    """The busiest expert's share of first choices, averaged over the MoE
    calls ``routing_spy`` saw (1 / n_experts when the router spreads tokens
    evenly)."""
    shares = [int(route[0][:, 0].bincount().max()) / route[0].shape[0] for route in routes]
    return sum(shares) / len(shares)


def fam_cut(cfg, **cuts):
    """The config with ``cuts`` applied, each printed on a line of its own."""
    import dataclasses

    for name, value in cuts.items():
        print(f"families: cut: {cfg.name}: {name} {getattr(cfg, name)} -> {value}", flush=True)
    return dataclasses.replace(cfg, **cuts)


def fam_params(torch, cfg, label: str):
    from repro_torch.models import init_params, param_count

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    count = param_count(params)
    print(f"{label}: {cfg.name} {count} parameters ({cfg.param_dtype}) drawn in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return params, count


def fam_teacher_forced(torch, params, cfg, batch, prompt: int, steps: int, path: str,
                       offset: int = 0) -> tuple:
    """Prefill the first ``prompt`` tokens (behind a vlm's ``offset``
    patches, after an audio config's encoder), counted as a path run with
    exactly attention_layers(cfg) flash launches, then ``steps``
    teacher-forced decode steps; (per-position logits (B, V): the
    prefill's, then one a step; prefill seconds on the host clock, decode
    ms from CUDA events, launches)."""
    from repro_torch.models import model as M

    tokens = batch["tokens"]
    pre = dict(batch, tokens=tokens[:, :prompt])
    t0 = time.perf_counter()
    (logits, cache), launches = run_path(
        torch, path, lambda: M.prefill(params, cfg, pre, offset + prompt + steps),
        expect={"flash_attention": attention_layers(cfg)})
    prefill_s = time.perf_counter() - t0
    out, step_ms = [logits[:, 0]], []
    for t in range(prompt, prompt + steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = M.decode_step(params, cfg, cache, tokens[:, t:t + 1], offset + t)
        end.record()
        out.append(logits[:, 0])
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    check(all(bool(torch.isfinite(x).all()) for x in out), f"{path}: non-finite logits")
    return out, prefill_s, step_ms, launches


def fam_f32_hold(torch, params, cfg, batch, prompt: int, steps: int, path: str, label: str,
                 offset: int = 0) -> dict:
    """In float32: forward through the kernel against the plain path
    (within LM_F32_TOL, top-1 on LM_F32_TOP1 of the positions), and prefill
    + teacher-forced decode against that forward at the same positions
    (within LM_F32_TOL: the caches, cross K/V and positions carried right)."""
    import dataclasses

    from repro_torch.models import model as M

    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    got, l_fwd = run_path(torch, path, lambda: M.forward(params, c32, batch)[0],
                          expect={"flash_attention": attention_layers(cfg)})
    plain = M.forward(params, c32, batch, impl="torch")[0]
    err = float((got - plain).abs().max())
    top1 = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
    check(bool(torch.isfinite(got).all()) and torch.allclose(got, plain, rtol=LM_F32_TOL,
                                                            atol=LM_F32_TOL)
          and top1 >= LM_F32_TOP1, f"{label} f32: kernel against plain max abs err {err}, "
                                   f"top-1 {top1}")
    del plain
    chain, _, _, l_chain = fam_teacher_forced(torch, params, c32, batch, prompt, steps, path,
                                              offset)
    want = [got[:, prompt - 1 + i] for i in range(len(chain))]
    chain_err = max(float((x - w).abs().max()) for x, w in zip(chain, want))
    check(all(torch.allclose(x, w, rtol=LM_F32_TOL, atol=LM_F32_TOL) for x, w in zip(chain, want)),
          f"{label} f32: teacher-forced decode {chain_err} from forward")
    row = dict(forward_max_abs_err=err, top1_agreement=top1, decode_vs_forward=chain_err,
               positions=got.shape[1])
    print(f"{label} f32: {json.dumps(row)}", flush=True)
    row["launches"] = [l_fwd, l_chain]
    return row


def fam_bf16_run(torch, params, cfg, batch, prompt: int, steps: int, path: str, label: str,
                 offset: int = 0, shapes: int = 1) -> dict:
    """In the config's bf16: prefill + teacher-forced decode through the
    kernel (prefill seconds, decode-step ms), each new flash shape's first
    call held against the plain version and timed (``shapes`` of them)."""
    from repro_torch.kernels import ops

    seen: dict = {}
    restore = capture_shapes(ops, seen)
    try:
        _, prefill_s, step_ms, launches = fam_teacher_forced(torch, params, cfg, batch, prompt,
                                                             steps, path, offset)
    finally:
        restore()
    check(len(seen) == shapes, f"{label}: flash shapes {sorted(seen)}")
    flash = fam_flash_shapes(torch, seen, label)
    del seen
    steady = sorted(step_ms[1:] or step_ms)
    row = dict(prefill_s=prefill_s, decode_step_ms=step_ms,
               decode_step_ms_median=steady[len(steady) // 2], flash=flash)
    print(f"{label} bf16: {json.dumps({k: v for k, v in row.items() if k != 'flash'})}",
          flush=True)
    row["launches"] = [launches]
    return row


def fam_moe(torch) -> dict:
    """granite-moe-3b-a800m at full width (32 layers, d_model 1536, 40
    experts top-8 of 512 wide, ~3.37 B float32 parameters): the launcher in
    process (8 requests x 16 tokens, 4 slots), forward over FAM_MOE_PREFILL
    tokens in f32 and bf16 through the kernel against the plain path (the
    lm phase's gates), the share of (token, choice) assignments capacity
    dropped at that prefill and at one 4-slot decode step (cap 1 there:
    drops by design), and one layer's MoE timed apart from its expert
    products."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import silu

    cfg = get_arch("granite-moe-3b-a800m")
    serve = lm_serve(torch, cfg, ["--arch", cfg.name, *FAM_SERVE_ARGS], "families_moe_serve",
                     "families moe serve")
    torch.cuda.empty_cache()
    params, count = fam_params(torch, cfg, "families moe")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, FAM_MOE_PREFILL), generator=gen,
                           device="cuda")
    prefill = lm_prefill(torch, params, cfg, tokens, "families_moe_prefill")
    routes: list = []
    unspy = routing_spy(MOE, routes)
    try:
        _, l_pre = run_path(torch, "families_moe_prefill",
                            lambda: M.prefill(params, cfg, {"tokens": tokens}, FAM_MOE_PREFILL),
                            expect={"flash_attention": cfg.n_layers})
        prefill_drop = drop_share(routes)
        drop_by_layer = [drop_share([route]) for route in routes]
        top_share = top_expert_share(routes)
        routes.clear()
        cache = M.init_cache(cfg, 4, 256)
        M.decode_step(params, cfg, cache, tokens[0, :4, None],
                      torch.tensor([5, 10, 15, 20], device="cuda"))
        decode_drop = drop_share(routes)
    finally:
        unspy()
    del routes, cache
    k, e, cf = cfg.experts_per_token, cfg.n_experts, cfg.capacity_factor
    caps = {n: max(1, int(n * k * cf / e)) for n in (FAM_MOE_PREFILL, 4)}
    check(0 <= prefill_drop < 1 and (caps[4] > 1 or decode_drop > 0),
          f"families moe: dropped {prefill_drop} at prefill (cap {caps[FAM_MOE_PREFILL]}), "
          f"{decode_drop} at a 4-slot decode step (cap {caps[4]})")
    # one layer's MoE at the prefill's shape, bf16: the whole, and the expert
    # products alone (with their weight casts) on a buffer of the same shape
    layer = M._at(params["blocks"], 0)["l0"]["moe"]
    x = torch.randn((1, FAM_MOE_PREFILL, cfg.d_model), generator=gen, device="cuda").to(
        cfg.cdtype)
    moe_ms = timed(torch, lambda: MOE.moe_apply(layer, x, n_experts=e, experts_per_token=k,
                                                capacity_factor=cf), 5)
    buf = torch.randn((e, caps[FAM_MOE_PREFILL], cfg.d_model), generator=gen,
                      device="cuda").to(cfg.cdtype)

    def products():
        h = silu(torch.bmm(buf, layer["gate"].to(buf.dtype))) * torch.bmm(
            buf, layer["up"].to(buf.dtype))
        return torch.bmm(h, layer["down"].to(buf.dtype))

    products_ms = timed(torch, products, 5)
    row = dict(arch=cfg.name, params=count, prefill_tokens=FAM_MOE_PREFILL,
               capacity=caps[FAM_MOE_PREFILL], decode_capacity=caps[4],
               prefill_drop_share=prefill_drop, prefill_drop_by_layer=drop_by_layer,
               prefill_top_expert_share=top_share,
               decode_drop_share=decode_drop, moe_layer_ms=moe_ms, expert_products_ms=products_ms,
               dispatch_ms=moe_ms - products_ms)
    print(f"families moe: {json.dumps(row)}", flush=True)
    row.update(serve=serve, prefill=prefill,
               launches=[serve["launches"], prefill["float32"]["launches"],
                         prefill["bfloat16"]["launches"], l_pre])
    return row


def fam_rwkv(torch) -> dict:
    """rwkv6-7b at full width (32 layers, d_model 4096, 64 heads of 64,
    ~7.5 B float32 parameters): the launcher in process (no flash: no
    attention), a FAM_RWKV_PREFILL-token prefill on the chunked WKV path
    against the sequential path on the card in float32, the bf16 prefill's
    ms, and one layer's time mix on each path timed."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    from repro_torch.models import ssm as S

    cfg = get_arch("rwkv6-7b")
    serve = lm_serve(torch, cfg, ["--arch", cfg.name, *FAM_SERVE_ARGS], "families_rwkv_serve",
                     "families rwkv serve")
    torch.cuda.empty_cache()
    params, count = fam_params(torch, cfg, "families rwkv")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, FAM_RWKV_PREFILL), generator=gen,
                           device="cuda")
    batch, n = {"tokens": tokens}, FAM_RWKV_PREFILL
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    check(n % cfg.rwkv_chunk == 0, "families rwkv: the prefill takes the sequential path")
    t0 = time.perf_counter()
    (chunked, cache_c), l_pre = run_path(torch, "families_rwkv",
                                         lambda: M.prefill(params, c32, batch, n),
                                         expect={"flash_attention": 0})
    chunked_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq, cache_s = M.prefill(params, dataclasses.replace(c32, rwkv_chunk=0), batch, n)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    err = float((chunked - seq).abs().max())
    wkv_c, wkv_s = cache_c["l0"]["wkv"], cache_s["l0"]["wkv"]
    wkv_err = max(float((wkv_c[g] - wkv_s[g]).abs().max() / wkv_s[g].abs().max())
                  for g in range(cfg.n_groups))
    check(bool(torch.isfinite(chunked).all())
          and torch.allclose(chunked, seq, rtol=LM_F32_TOL, atol=LM_F32_TOL)
          and wkv_err <= FAM_WKV_TOL,
          f"families rwkv: chunked against sequential: logits {err}, WKV state {wkv_err}")
    del cache_c, cache_s, chunked, seq
    bf16_ms = timed(torch, lambda: M.prefill(params, cfg, batch, n), 2)
    p0 = M._at(params["blocks"], 0)["l0"]["rwkv"]
    x = torch.randn((1, n, cfg.d_model), generator=gen, device="cuda").to(cfg.cdtype)
    hd = cfg.rwkv_head_dim
    seq_ms = timed(torch, lambda: S.rwkv6_time_mix_seq(p0, x, hd), 1)
    chunk_ms = timed(torch, lambda: S.rwkv6_time_mix_seq_chunked(p0, x, hd, cfg.rwkv_chunk), 3)
    row = dict(arch=cfg.name, params=count, prefill_tokens=n, f32_logits_max_abs_err=err,
               f32_wkv_state_rel_err=wkv_err, f32_chunked_prefill_s=chunked_s,
               f32_sequential_prefill_s=seq_s, bf16_prefill_ms=bf16_ms,
               time_mix_sequential_ms=seq_ms, time_mix_chunked_ms=chunk_ms)
    print(f"families rwkv: {json.dumps(row)}", flush=True)
    row.update(serve=serve, launches=[serve["launches"], l_pre])
    return row


def fam_whisper(torch) -> dict:
    """whisper-medium at full width (24 encoder + 24 decoder layers, d_model
    1024, 16 heads of 64; ~0.85 B parameters): B 2 over 1500 seeded stub
    frames, a 16-token prompt, 16 teacher-forced steps. Exactly 72 flash
    launches a prefill (24 encoder self-attention, 24 decoder
    self-attention, 24 cross-attention); f32 held against the plain path
    and decode against forward; bf16 the config's, each of the three new
    shapes' first call held against the plain version and timed."""
    from repro_torch.configs import get_arch

    cfg = get_arch("whisper-medium")
    b, prompt, steps = FAM_WHISPER
    check(attention_layers(cfg) == cfg.encoder_layers + 2 * cfg.n_layers,
          f"families whisper: {attention_layers(cfg)} flash launches a prefill")
    params, count = fam_params(torch, cfg, "families whisper")
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, prompt + steps), generator=gen,
                                     device="cuda"),
             "frames": torch.randn((b, cfg.frontend_len, cfg.d_model), generator=gen,
                                   device="cuda") * 0.1}
    f32 = fam_f32_hold(torch, params, cfg, batch, prompt, steps, "families_whisper",
                       "families whisper")
    bf16 = fam_bf16_run(torch, params, cfg, batch, prompt, steps, "families_whisper",
                        "families whisper", shapes=3)
    return dict(arch=cfg.name, params=count, batch=b, frames=cfg.frontend_len, prompt=prompt,
                steps=steps, flash_a_prefill=attention_layers(cfg), f32=f32, bf16=bf16,
                launches=f32["launches"] + bf16["launches"])


def fam_llava(torch) -> dict:
    """llava-next-mistral-7b at full width with its 576 patch embeddings
    (32 layers, d_model 4096, 32 heads of 128, 8 KV heads; ~7.2 B float32
    parameters): a 64-token prompt behind the patches (one causal flash
    launch a layer over 640 positions), 8 teacher-forced steps, f32 held
    against the plain path and decode against forward, bf16 timed."""
    from repro_torch.configs import get_arch

    cfg = get_arch("llava-next-mistral-7b")
    prompt, steps = FAM_LLAVA
    params, count = fam_params(torch, cfg, "families llava")
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, prompt + steps), generator=gen,
                                     device="cuda"),
             "patch_embeds": torch.randn((1, cfg.frontend_len, cfg.d_model), generator=gen,
                                         device="cuda") * 0.1}
    f32 = fam_f32_hold(torch, params, cfg, batch, prompt, steps, "families_llava",
                       "families llava", offset=cfg.frontend_len)
    bf16 = fam_bf16_run(torch, params, cfg, batch, prompt, steps, "families_llava",
                        "families llava", offset=cfg.frontend_len)
    return dict(arch=cfg.name, params=count, patches=cfg.frontend_len, prompt=prompt,
                steps=steps, f32=f32, bf16=bf16, launches=f32["launches"] + bf16["launches"])


def fam_cut_model(torch, cfg, path: str, label: str) -> tuple:
    """A cut config in its bf16: forward over FAM_CUT_PREFILL tokens through
    the kernel against the plain path with the kernel path's routing pinned
    (routing_spy's replay; top-1 on LM_BF16_TOP1 of the positions, the share
    of tokens the plain path would have routed alike recorded), prefill +
    FAM_CUT_STEPS teacher-forced steps, the MoE drop shares at that prefill
    and at a decode step of one sequence; (row, params)."""
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    params, count = fam_params(torch, cfg, label)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, FAM_CUT_PREFILL + FAM_CUT_STEPS),
                           generator=gen, device="cuda")
    fwd = {"tokens": tokens[:, :FAM_CUT_PREFILL]}
    routes, alike = [], []
    unspy = routing_spy(MOE, routes)
    try:
        got, l_fwd = run_path(torch, path, lambda: M.forward(params, cfg, fwd)[0],
                              expect={"flash_attention": attention_layers(cfg)})
    finally:
        unspy()
    unspy = routing_spy(MOE, alike, replay=routes)
    try:
        plain = M.forward(params, cfg, fwd, impl="torch")[0]
    finally:
        unspy()
    routed_alike = float(torch.stack(alike).all(0).float().mean())
    del routes, alike
    top1 = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
    err = float((got - plain).abs().max())
    check(bool(torch.isfinite(got).all()) and top1 >= LM_BF16_TOP1,
          f"{label}: kernel against plain top-1 {top1}, max abs err {err}")
    del got, plain
    routes: list = []
    unspy = routing_spy(MOE, routes)
    try:
        bf16 = fam_bf16_run(torch, params, cfg, {"tokens": tokens}, FAM_CUT_PREFILL,
                            FAM_CUT_STEPS, path, label)
    finally:
        unspy()
    per_call = len(routes) // (FAM_CUT_STEPS + 1)  # MoE layers: a prefill, then a step each
    row = dict(arch=cfg.name, params=count, n_layers=cfg.n_layers, n_experts=cfg.n_experts,
               prompt=FAM_CUT_PREFILL, steps=FAM_CUT_STEPS, top1_agreement=top1,
               tokens_routed_alike=routed_alike,
               max_abs_err=err, prefill_drop_share=drop_share(routes[:per_call]),
               prefill_top_expert_share=top_expert_share(routes[:per_call]),
               decode_drop_share=drop_share(routes[per_call:]), bf16=bf16)
    del routes
    print(f"{label}: {json.dumps({k: v for k, v in row.items() if k != 'bf16'})}", flush=True)
    row["launches"] = [l_fwd] + bf16["launches"]
    return row, params


def fam_arctic(torch) -> dict:
    """arctic-480b at full width (d_model 7168, 56 heads of 128, 128 experts
    top-2 of 4864 wide beside a 14336-wide dense MLP, bf16 parameters), its
    depth cut from 35 layers to 1 (~14.3 B parameters, ~28.6 GB)."""
    from repro_torch.configs import get_arch

    cfg = fam_cut(get_arch("arctic-480b"), n_layers=1)
    row, params = fam_cut_model(torch, cfg, "families_arctic", "families arctic")
    del params
    return row


def fam_jamba(torch) -> dict:
    """jamba-1.5-large-398b at full width (d_model 8192, 64 heads of 128, 8 KV
    heads, Mamba d_state 16 over 16384 inner channels, bf16 parameters), cut
    to one group of 8 layers (attention at 4, Mamba elsewhere, MoE on the
    odd ones) and 4 of its 16 experts (~16 B parameters, ~33 GB: one group
    with all 16 is ~90 GB); one Mamba layer and its sequential selective
    scan alone timed at FAM_CUT_PREFILL tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    from repro_torch.models import ssm as S

    cfg = fam_cut(get_arch("jamba-1.5-large-398b"), n_layers=8, n_experts=4)
    row, params = fam_cut_model(torch, cfg, "families_jamba", "families jamba")
    p0 = M._at(params["blocks"], 0)["l0"]["mamba"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    n, din, ns = FAM_CUT_PREFILL, cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
    x = torch.randn((1, n, cfg.d_model), generator=gen, device="cuda").to(cfg.cdtype)
    layer_ms = timed(torch, lambda: S.mamba_seq(p0, x, d_state=ns, d_conv=cfg.mamba_d_conv,
                                                expand=cfg.mamba_expand), 2)
    xi = torch.randn((1, n, din), generator=gen, device="cuda").to(cfg.cdtype)
    dt = S.softplus(torch.randn((1, n, din), generator=gen, device="cuda"))
    bm, cm = (torch.randn((1, n, ns), generator=gen, device="cuda") for _ in range(2))

    def scan():
        h = torch.zeros((1, din, ns), device="cuda")
        for t in range(n):
            _, h = S._mamba_step_core(p0, xi[:, t], dt[:, t], bm[:, t], cm[:, t], h)
        return h

    scan_ms = timed(torch, scan, 2)
    del params
    row.update(mamba_layer_ms=layer_ms, mamba_scan_ms=scan_ms)
    print(f"families jamba: mamba layer {layer_ms:.3f} ms, sequential scan {scan_ms:.3f} ms "
          f"over {n} tokens", flush=True)
    return row


def phase_families(torch) -> dict:
    """Phase 14: the moe, ssm, hybrid, audio and vlm families at full width
    (arctic and jamba cut to fit), each freed before the next."""
    check(not torch.backends.cuda.matmul.allow_tf32, "families: TF32 matmuls are on")
    rows = {}
    for name, fn in (("moe", fam_moe), ("rwkv", fam_rwkv), ("whisper", fam_whisper),
                     ("llava", fam_llava), ("arctic", fam_arctic), ("jamba", fam_jamba)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows[name] = fn(torch)
        torch.cuda.empty_cache()
        rows[name]["seconds"] = time.perf_counter() - t0
        rows[name]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"families {name}: {rows[name]['seconds']:.2f} s, peak "
              f"{rows[name]['peak_gib']:.2f} GiB", flush=True)
    rows["launches"] = [counts for row in rows.values() for counts in row["launches"]]
    return rows


#: the parallel phase: data and expert parallelism over named grids of
#: views of the card (repro_torch.mesh), each model freed before the next
PAR_DP_SHARDS = 2
PAR_DP_STEPS = 3
PAR_EP_ARCH = "granite-moe-3b-a800m"
PAR_EP_GRID = (2, 4)  # (data, model)
PAR_EP_TOKENS = (2, 1024)  # rows x prompt of the prefills, one row a data block
PAR_EP_DECODE = 4  # teacher-forced decode steps after each prefill (2 slots: manual)
PAR_EP_FALLBACK = (128, 2)  # a 1-row prompt and decode steps: every MoE call falls back
#: a compressed gradient element against the uncompressed mean: within half
#: a quantum, plus the f32 rounding of g / scale and of the rescale (2^-14 of
#: a quantum; g / scale is at most 127)
PAR_QUANTUM_SLACK = 2.0 ** -14
#: expert parallelism against chunked dispatch on the same routing, float32:
#: every logit within this (rtol = atol), as tests/test_torch_families.py
PAR_EP_F32_TOL = 1e-4
#: through the 32 layers manual and chunked dispatch differ by rounding (the
#: expert products' shapes, the partial outputs summed over the expert
#: blocks; f32 logits ~1e-5 apart at the end), so a router near-tie may
#: route a token apart (one or two token-layers in 65,536 on an H100). Each
#: token-layer whose own float32 top-k under manual is not the gspmd one
#: must be such a tie: two of gspmd's k + 1 largest probabilities within
#: this of each other. A token whose top-k is the same but whose kept set
#: differs must be one of the <= 2k entries a flipped token moves in its
#: chunk (each of its k entries frees a place in one expert and takes one in
#: another). On one layer's same input the kept sets are bit for bit.
PAR_EP_TIE = 1e-5


def par_bound_spy(torch, loop, rows: list):
    """Wrap the train step's compressed_psum: for each compressed leaf,
    append (the largest |compressed - exact sum| / S, in quanta of its
    shared scale) as a 0-d tensor on the card, the exact sum taken in
    float64 from the shards' own gradients. Returns a function that puts
    the original back."""
    from repro_torch.optim.compression import shared_scale

    real = loop.compressed_psum

    def spy(gs, *, enabled=True):
        out = real(gs, enabled=enabled)
        if enabled:
            exact = gs[0].double()
            for g in gs[1:]:
                exact = exact + g.double()
            err = (out.double() - exact).abs().max() / len(gs)
            rows.append(err / shared_scale(gs).double())
        return out

    loop.compressed_psum = spy
    return lambda: setattr(loop, "compressed_psum", real)


def par_train_run(torch, cfg, step_fn, stream, path: str, flash: int, steps: int,
                  seen: dict | None = None) -> tuple:
    """A fresh seeded AdamW state (the train phase's), ``steps`` steps of
    ``step_fn`` as one path run with exactly ``flash`` flash launches: (state,
    per-step rows: ms from CUDA events, loss, grad norm). With ``seen`` the
    first flash call of each shape lands there (capture_shapes)."""
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.train import train_state_init

    state = train_state_init(torch.Generator(device="cuda").manual_seed(0), cfg, adamw()[0])
    rows = []

    def run():
        nonlocal state
        for s in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step_fn(state, stream.batch(s))
            end.record()
            torch.cuda.synchronize()
            rows.append(dict(ms=start.elapsed_time(end), loss=float(m["loss"]),
                             grad_norm=float(m["grad_norm"]), aux_loss=float(m["aux_loss"])))

    restore = capture_shapes(ops, seen) if seen is not None else lambda: None
    try:
        _, launches = run_path(torch, path, run, expect={"flash_attention": flash})
    finally:
        restore()
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows),
          f"{path}: a non-finite loss or grad norm {rows}")
    return state, rows, launches


def par_steady_ms(rows) -> float:
    steady = sorted(r["ms"] for r in rows[1:] or rows)
    return steady[len(steady) // 2]


def par_dp(torch) -> dict:
    """make_shardmap_train_step at granite-3-2b's full width and depth over a
    1-D data mesh of PAR_DP_SHARDS views of the card, batch 8 x 128 (the
    train phase's), AdamW, warmup_cosine, bf16 compute, remat:
    PAR_DP_STEPS steps uncompressed, held against make_train_step with as
    many microbatches from the same seeded state and batches (bitwise where
    the card's gradients repeat; else loss and grad norm within
    TRAIN_GRAD_RTOL relative and each leaf's parameter difference within
    TRAIN_GRAD_RTOL of the microbatched update's norm), the first flash call
    at the shard's shape held against the plain version (fam_flash_shapes);
    PAR_DP_STEPS steps compressed, timed, and the parameters' drift from the
    uncompressed run; the same PAR_DP_STEPS compressed steps again from the
    same state with every gradient element checked within half a quantum of
    the exact mean (PAR_QUANTUM_SLACK; par_bound_spy, whose float64 sums run
    inside the step and so stay out of the timed run); one single-device
    step (make_train_step, no microbatches); step ms of each, the payload
    bytes a step's sum would move, peak memory."""
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.optim import adamw, payload_bytes, warmup_cosine
    from repro_torch.train import loop, make_shardmap_train_step, make_train_step
    from repro_torch.utils import tree_flatten

    cfg = get_arch(LM_ARCH)
    check(cfg.remat, "parallel dp: remat is off")
    S, steps = PAR_DP_SHARDS, PAR_DP_STEPS
    mesh = make_mesh((S,), ("data",))
    opt, lr = adamw(), warmup_cosine(3e-4, 20, TRAIN_STEPS + 1)
    stream = SyntheticTokenStream(cfg.vocab_size, 128, 8, seed=0)
    flash = 2 * cfg.n_layers * S * steps  # forward and remat recompute, a layer a shard
    torch.cuda.reset_peak_memory_stats()
    seen: dict = {}
    state, plain_rows, l_plain = par_train_run(
        torch, cfg, make_shardmap_train_step(cfg, opt, lr, mesh, compress_grads=False), stream,
        "parallel_dp", flash, steps, seen)
    peak_dp = torch.cuda.max_memory_allocated()
    leaves = [p.detach() for p in tree_flatten(state.params)[0]]
    n_params = sum(p.numel() for p in leaves)
    payload = {"compressed": payload_bytes(state.params),
               "uncompressed": payload_bytes(state.params, enabled=False)}
    host_plain = [p.detach().cpu() for p in leaves]
    del state, leaves
    torch.cuda.empty_cache()
    # the shard's training attention: (B/S · H, 128, hd), bf16, causal
    check(len(seen) == 1, f"parallel dp: flash shapes {sorted(seen)}")
    flash_rows = fam_flash_shapes(torch, seen, "parallel dp")
    del seen

    state, mb_rows, l_mb = par_train_run(
        torch, cfg, make_train_step(cfg, opt, lr, microbatches=S), stream, "parallel_dp",
        flash, steps)
    leaves = [p.detach() for p in tree_flatten(state.params)[0]]
    bitwise = all(torch.equal(p, h.to(p.device)) for p, h in zip(leaves, host_plain)) and all(
        a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        for a, b in zip(plain_rows, mb_rows))
    worst_update = 0.0
    if not bitwise:
        for a, b in zip(plain_rows, mb_rows):
            for key in ("loss", "grad_norm"):
                check(abs(a[key] - b[key]) <= TRAIN_GRAD_RTOL * abs(b[key]),
                      f"parallel dp: {key} {a[key]} sharded against {b[key]} microbatched")
        start = tree_flatten(init_params(torch.Generator(device="cuda").manual_seed(0), cfg))[0]
        for p, h, p0 in zip(leaves, host_plain, start):
            update = (p - p0).norm()
            rel = float((h.to(p.device) - p).norm() / update.clamp_min(1e-30))
            worst_update = max(worst_update, rel)
            check(rel <= TRAIN_GRAD_RTOL, f"parallel dp: a leaf {rel} of its update apart")
        del start
    print(f"parallel dp: sharded S={S} uncompressed against {S} microbatches: bitwise "
          f"{bitwise}, worst leaf {worst_update} of its update apart", flush=True)
    # the single-device step: one more step on the microbatched run's state
    single = make_train_step(cfg, opt, lr)
    single_rows = []

    def one():
        nonlocal state
        for s in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = single(state, stream.batch(steps + s))
            end.record()
            torch.cuda.synchronize()
            single_rows.append(dict(ms=start.elapsed_time(end)))

    _, l_single = run_path(torch, "parallel_dp", one,
                           expect={"flash_attention": 2 * cfg.n_layers * 2})
    del state, leaves
    torch.cuda.empty_cache()

    state, comp_rows, l_comp = par_train_run(
        torch, cfg, make_shardmap_train_step(cfg, opt, lr, mesh), stream,
        "parallel_dp_compressed", flash, steps)
    drift_abs = drift_sq = norm_sq = 0.0
    for p, h in zip(tree_flatten(state.params)[0], host_plain):
        d = p.detach() - h.to(p.device)
        drift_abs = max(drift_abs, float(d.abs().max()))
        drift_sq += float((d.double() ** 2).sum())
        norm_sq += float((h.double() ** 2).sum())
    n_leaves = len(host_plain)
    del state, host_plain
    torch.cuda.empty_cache()

    ratios: list = []
    restore = par_bound_spy(torch, loop, ratios)
    try:
        state, checked_rows, l_checked = par_train_run(
            torch, cfg, make_shardmap_train_step(cfg, opt, lr, mesh), stream,
            "parallel_dp_compressed", flash, steps)
    finally:
        restore()
    del state
    torch.cuda.empty_cache()
    check(len(ratios) == n_leaves * steps, f"parallel dp: {len(ratios)} compressed sums")
    worst_quanta = float(torch.stack(ratios).max())
    check(worst_quanta <= 0.5 + PAR_QUANTUM_SLACK,
          f"parallel dp: a compressed gradient {worst_quanta} quanta from the exact mean")
    repeats = all(a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
                  for a, b in zip(comp_rows, checked_rows))
    row = dict(arch=cfg.name, params=n_params, shards=S, steps=steps, batch=[8, 128],
               uncompressed=plain_rows, microbatched=mb_rows, compressed=comp_rows,
               bitwise_vs_microbatched=bitwise, worst_leaf_vs_update=worst_update,
               step_ms_uncompressed=par_steady_ms(plain_rows),
               step_ms_compressed=par_steady_ms(comp_rows),
               step_ms_compressed_checked=par_steady_ms(checked_rows),
               checked_run_repeats_the_timed_one=repeats,
               step_ms_microbatched=par_steady_ms(mb_rows),
               step_ms_single_device=par_steady_ms(single_rows),
               worst_share_of_half_quantum=worst_quanta / 0.5,
               drift_max_abs=drift_abs, drift_rel_norm=math.sqrt(drift_sq / norm_sq),
               payload_bytes=payload, peak_gib_uncompressed=peak_dp / 2**30,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, flash=flash_rows)
    print(f"parallel dp: {json.dumps({k: v for k, v in row.items() if k not in ('uncompressed', 'microbatched', 'compressed')})}",
          flush=True)
    row["launches"] = [l_plain, l_mb, l_single, l_comp, l_checked]
    return row


def par_counting(moe_module, calls: dict):
    """Count the MoE calls of each implementation (moe_apply_manual,
    moe_apply); returns a function that puts the originals back."""
    originals = {name: getattr(moe_module, name) for name in ("moe_apply_manual", "moe_apply")}

    def wrap(name, fn):
        def call(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return call

    for name, fn in originals.items():
        setattr(moe_module, name, wrap(name, fn))
    return lambda: [setattr(moe_module, n, f) for n, f in originals.items()]


def par_ep_pair(torch, params, cfgs, mesh, fn, path: str, label: str, seen: dict) -> dict:
    """``fn(cfg)`` under moe_impl="gspmd" (dispatch_chunks = dp) with its
    routing recorded, then under "manual" over ``mesh`` with that routing
    pinned (routing_spy's replay); each one path run with exactly one flash
    launch a layer a prefill, the first flash call of each shape landing in
    ``seen``. Returns both outputs, the share of tokens whose own routing
    under manual was the gspmd one in every call, the ties behind those
    that were not (par_ties), the routes, and the calls of each MoE
    implementation."""
    from repro_torch.kernels import ops
    from repro_torch.mesh import set_mesh
    from repro_torch.models import moe as MOE

    routes, alike, calls = [], [], {"gspmd": {}, "manual": {}}
    probs: dict = {"gspmd": [], "manual": []}
    flash = {"flash_attention": attention_layers(cfgs["gspmd"])}
    restore = capture_shapes(ops, seen)
    try:
        unspy = routing_spy(MOE, routes, probs_seen=probs["gspmd"])
        uncount = par_counting(MOE, calls["gspmd"])
        try:
            want, l_g = run_path(torch, path, lambda: fn(cfgs["gspmd"]), expect=flash)
        finally:
            unspy()
            uncount()
        unspy = routing_spy(MOE, alike, replay=routes, probs_seen=probs["manual"])
        uncount = par_counting(MOE, calls["manual"])
        try:
            with set_mesh(mesh):
                got, l_m = run_path(torch, path, lambda: fn(cfgs["manual"]), expect=flash)
        finally:
            unspy()
            uncount()
    finally:
        restore()
    check(len(alike) == len(routes), f"{label}: {len(alike)} manual routings against "
                                     f"{len(routes)}")
    same = float(torch.cat([a.reshape(-1) for a in alike]).float().mean())
    ties = par_ties(torch, probs, alike, cfgs["gspmd"].experts_per_token)
    return dict(want=want, got=got, routed_alike=same, ties=ties, routes=routes, calls=calls,
                launches=[l_g, l_m])


def par_ties(torch, probs: dict, alike: list, k: int) -> dict:
    """Why tokens routed apart under manual: for each routing call, the
    tokens whose own top-k (stable descending order, as route) differs from
    gspmd's ("flips"), the smallest gap between consecutive ones of gspmd's
    k + 1 largest probabilities at each flip, and the tokens whose top-k is
    the same but whose kept set is not ("kept only"; unexplained where a
    call has more than 2k of them a flip). Counts, the largest tie gap at a
    flip and the largest |manual - gspmd| probability."""
    flips = kept_only = unexplained = 0
    worst_gap = prob_diff = 0.0
    for p_g, p_m, same in zip(probs["gspmd"], probs["manual"], alike):
        top_g = torch.sort(p_g, dim=-1, descending=True, stable=True)
        top_m = torch.sort(p_m, dim=-1, descending=True, stable=True).indices[:, :k]
        flip = (top_m != top_g.indices[:, :k]).any(-1)
        vals = top_g.values[:, :k + 1]
        gap = (vals[:, :-1] - vals[:, 1:]).min(-1).values
        n_flip, n_kept = int(flip.sum()), int((~same & ~flip).sum())
        flips, kept_only = flips + n_flip, kept_only + n_kept
        unexplained += max(0, n_kept - 2 * k * n_flip)
        if n_flip:
            worst_gap = max(worst_gap, float(gap[flip].max()))
        prob_diff = max(prob_diff, float((p_m - p_g).abs().max()))
    return dict(flips=flips, kept_only=kept_only, kept_only_unexplained=unexplained,
                worst_tie_gap=worst_gap, max_prob_diff=prob_diff)


def par_ep(torch) -> dict:
    """granite-moe-3b-a800m at full width over a (data 2, model 4) grid of 8
    views of the card, moe_impl="manual", moe_dispatch_chunks=2, against
    moe_impl="gspmd" at dispatch_chunks=2 (the same chunk-local capacity),
    the manual run's routing pinned to the gspmd run's: forward over 2 x
    1024 tokens and prefill + PAR_EP_DECODE teacher-forced steps at 2
    slots, float32 (logits within PAR_EP_F32_TOL, each token-layer whose own
    routing was not gspmd's a near-tie, PAR_EP_TIE) and bf16 (top-1 on
    LM_BF16_TOP1 of the positions, mean distance from the f32 logits within
    LM_BF16_MEAN_SLACK of gspmd's); a 1-row prefill + decode where every MoE
    call falls back to moe_apply; the first flash call of each new shape
    (f32 and bf16 at 2 x 1024, the 1-row prompt) held against the plain
    version (fam_flash_shapes); one MoE layer on one input under each
    implementation, the kept sets bit for bit in f32 and bf16, then timed;
    the drop share, both aux losses, the combine's bytes."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    base = get_arch(PAR_EP_ARCH)
    dp, ep = PAR_EP_GRID
    mesh = make_mesh(PAR_EP_GRID, ("data", "model"))
    params, count = fam_params(torch, base, "parallel ep")
    rows, prompt = PAR_EP_TOKENS
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, base.vocab_size, (rows, prompt + PAR_EP_DECODE), generator=gen,
                           device="cuda")
    out, launches, flash_rows = {}, [], []
    f32_logits = None
    for dtype in ("float32", "bfloat16"):
        cfgs = {impl: dataclasses.replace(base, compute_dtype=dtype, moe_impl=impl,
                                          moe_dispatch_chunks=dp)
                for impl in ("gspmd", "manual")}
        seen: dict = {}
        fwd = par_ep_pair(torch, params, cfgs, mesh,
                          lambda c: M.forward(params, c, {"tokens": tokens[:, :prompt]}),
                          "parallel_ep", f"parallel ep {dtype} forward", seen)
        (want, want_aux), (got, got_aux) = fwd["want"], fwd["got"]
        check(fwd["calls"]["manual"] == {"moe_apply_manual": base.n_layers}
              and fwd["calls"]["gspmd"] == {"moe_apply": base.n_layers},
              f"parallel ep {dtype}: MoE calls {fwd['calls']}")
        drop = drop_share(fwd["routes"])
        err = float((got - want).abs().max())
        top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        finite = bool(torch.isfinite(got).all())
        check(finite and tuple(got.shape) == (rows, prompt, base.vocab_size),
              f"parallel ep {dtype}: logits {tuple(got.shape)}, finite {finite}")

        def chain(c):
            logits, cache = M.prefill(params, c, {"tokens": tokens[:, :prompt]},
                                      prompt + PAR_EP_DECODE)
            steps = [logits[:, 0]]
            for t in range(prompt, prompt + PAR_EP_DECODE - 1):
                logits, cache = M.decode_step(params, c, cache, tokens[:, t:t + 1], t)
                steps.append(logits[:, 0])
            return torch.stack(steps, 1)

        dec = par_ep_pair(torch, params, cfgs, mesh, chain, "parallel_ep",
                          f"parallel ep {dtype} prefill", seen)
        check(len(seen) == 1, f"parallel ep {dtype}: flash shapes {sorted(seen)}")
        flash_rows += fam_flash_shapes(torch, seen, f"parallel ep {dtype}")
        del seen
        check(dec["calls"]["manual"] == {"moe_apply_manual": base.n_layers * PAR_EP_DECODE},
              f"parallel ep {dtype}: decode MoE calls {dec['calls']['manual']}")
        dec_err = float((dec["got"] - dec["want"]).abs().max())
        row = dict(forward_max_abs_err=err, top1_agreement=top1,
                   tokens_routed_alike=fwd["routed_alike"],
                   decode_tokens_routed_alike=dec["routed_alike"], ties=fwd["ties"],
                   decode_ties=dec["ties"], prefill_drop_share=drop,
                   aux_gspmd=float(want_aux), aux_manual=float(got_aux),
                   decode_max_abs_err=dec_err)
        if dtype == "float32":
            for ties in (fwd["ties"], dec["ties"]):
                check(ties["worst_tie_gap"] <= PAR_EP_TIE
                      and ties["kept_only_unexplained"] == 0,
                      f"parallel ep f32: token-layers routed apart beyond a near-tie {ties}")
            check(torch.allclose(got, want, rtol=PAR_EP_F32_TOL, atol=PAR_EP_F32_TOL)
                  and torch.allclose(dec["got"], dec["want"], rtol=PAR_EP_F32_TOL,
                                     atol=PAR_EP_F32_TOL),
                  f"parallel ep f32: manual against gspmd {err}, decode {dec_err}")
            f32_logits = want
        else:
            check(top1 >= LM_BF16_TOP1, f"parallel ep bf16: top-1 agreement {top1}")
            mean_vs_f32 = {impl: float((x.float() - f32_logits).abs().mean())
                           for impl, x in (("manual", got), ("gspmd", want))}
            check(mean_vs_f32["manual"] <= LM_BF16_MEAN_SLACK * mean_vs_f32["gspmd"],
                  f"parallel ep bf16: mean |logits - f32 logits| {mean_vs_f32}")
            row["mean_abs_vs_f32"] = mean_vs_f32
            del f32_logits
        print(f"parallel ep {dtype}: {json.dumps(row)}", flush=True)
        out[dtype] = row
        launches += fwd["launches"] + dec["launches"]
        del fwd, dec, want, got
        torch.cuda.empty_cache()

    # one row: every MoE call falls back to moe_apply (1 % 2 != 0)
    from repro_torch.mesh import set_mesh

    fb_prompt, fb_steps = PAR_EP_FALLBACK
    cfg = dataclasses.replace(base, moe_impl="manual", moe_dispatch_chunks=dp)
    from repro_torch.kernels import ops

    calls, seen = {}, {}
    uncount, restore = par_counting(MOE, calls), capture_shapes(ops, seen)
    try:
        with set_mesh(mesh):
            _, _, _, l_fb = fam_teacher_forced(torch, params, cfg, {"tokens": tokens[:1]},
                                               fb_prompt, fb_steps, "parallel_ep")
    finally:
        uncount()
        restore()
    check(calls == {"moe_apply": base.n_layers * (1 + fb_steps)},
          f"parallel ep: one row's MoE calls {calls}")
    check(len(seen) == 1, f"parallel ep: one row's flash shapes {sorted(seen)}")
    flash_rows += fam_flash_shapes(torch, seen, "parallel ep one row")
    del seen
    launches.append(l_fb)

    # one MoE layer at the prefill's shape on the same input: the kept sets
    # of the two implementations bit for bit in f32 and bf16, then each timed
    layer = M._at(params["blocks"], 0)["l0"]["moe"]
    x32 = torch.randn((rows, prompt, base.d_model), generator=gen, device="cuda")
    kw = dict(n_experts=base.n_experts, experts_per_token=base.experts_per_token,
              capacity_factor=base.capacity_factor)
    layer_rows = {}
    for x in (x32, x32.to(torch.bfloat16)):
        kept: dict = {"manual": [], "gspmd": []}
        unspy = routing_spy(MOE, kept["manual"])
        try:
            y_m, aux_m = MOE.moe_apply_manual(layer, x, mesh=mesh, **kw)
        finally:
            unspy()
        unspy = routing_spy(MOE, kept["gspmd"])
        try:
            y_g, aux_g = MOE.moe_apply(layer, x, dispatch_chunks=dp, **kw)
        finally:
            unspy()
        same = len(kept["manual"]) == len(kept["gspmd"]) == dp and all(
            torch.equal(a[0], b[0]) and torch.equal(a[4], b[4])
            for a, b in zip(kept["manual"], kept["gspmd"]))
        dtype = str(x.dtype).removeprefix("torch.")
        check(same, f"parallel ep: one {dtype} layer's kept sets differ between manual and "
                    "chunked dispatch")
        layer_rows[dtype] = dict(kept_bitwise=same, aux_manual=float(aux_m),
                                 aux_gspmd=float(aux_g),
                                 max_abs_diff=float((y_m.float() - y_g.float()).abs().max()),
                                 drop_share=drop_share(kept["gspmd"]))
    del kept, y_m, y_g
    manual_ms = timed(torch, lambda: MOE.moe_apply_manual(layer, x, mesh=mesh, **kw), 5)
    gspmd_ms = timed(torch, lambda: MOE.moe_apply(layer, x, dispatch_chunks=dp, **kw), 5)
    one_chunk_ms = timed(torch, lambda: MOE.moe_apply(layer, x, **kw), 5)
    t_loc = rows * prompt // dp
    combine = t_loc * base.d_model * x.element_size()
    row = dict(arch=base.name, params=count, grid=list(PAR_EP_GRID), tokens=[rows, prompt],
               decode_steps=PAR_EP_DECODE, fallback_calls=calls,
               layer_ms_manual=manual_ms, layer_ms_gspmd_chunked=gspmd_ms,
               layer_ms_gspmd_one_chunk=one_chunk_ms, layer=layer_rows, flash=flash_rows,
               combine_bytes_a_position=combine, combine_bytes_a_layer=dp * ep * combine,
               capacity=max(1, int(t_loc * base.experts_per_token * base.capacity_factor
                                   / base.n_experts)))
    print(f"parallel ep: {json.dumps(row)}", flush=True)
    row.update(out, launches=launches)
    del params, layer, x, x32
    torch.cuda.empty_cache()
    return row


def par_production_mesh() -> dict:
    """make_production_mesh over 256 (and, multi-pod, 512) repeats of the
    card: shape and dp axes; nothing runs on it."""
    from repro_torch.launch.mesh import dp_axes, make_production_mesh

    rows = {}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rows["multi_pod" if multi_pod else "pod"] = dict(
            shape=mesh.shape, positions=mesh.size, dp_axes=list(dp_axes(multi_pod)),
            devices=sorted({str(d) for d in mesh.devices.flat}))
    print(f"parallel mesh: {json.dumps(rows)}", flush=True)
    return rows


def phase_parallel(torch) -> dict:
    """Phase 15: data parallelism (granite-3-2b's shard_map train step) and
    expert parallelism (granite-moe's manual MoE) over named grids of views
    of the card, then the production mesh's grid; each model freed before
    the next."""
    check(not torch.backends.cuda.matmul.allow_tf32, "parallel: TF32 matmuls are on")
    rows = {}
    for name, fn in (("dp", par_dp), ("ep", par_ep)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows[name] = fn(torch)
        torch.cuda.empty_cache()
        rows[name]["seconds"] = time.perf_counter() - t0
        rows[name]["peak_gib_phase"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"parallel {name}: {rows[name]['seconds']:.2f} s, peak "
              f"{rows[name]['peak_gib_phase']:.2f} GiB", flush=True)
    rows["mesh"] = par_production_mesh()
    rows["launches"] = rows["dp"]["launches"] + rows["ep"]["launches"]
    return rows


#: the dry-run phase: the card-identity shapes (2^22 x 128 f32 over a
#: (4, 4) grid of the card, the billion-scale query config; granite-3-2b's
#: decode_32k step at one position's block of 8 sequences in the
#: tensor-parallel layout, granite-moe-3b-a800m's in the expert-parallel
#: one, rwkv6-7b's in the tensor-parallel one, whisper-medium's in the
#: replicated one), then the dry runs themselves in child processes, on meta
#: tensors
DRY_N = 1 << 22
DRY_GRID = (4, 4)
DRY_ANN_JOBS = (("build_cov", "gather"), ("query", "gather"), ("query", "masked_full"))
#: (arch, shape, the layout launch.dryrun must give the cell, the rows a
#: position runs)
DRY_CELLS = (("granite-3-2b", "decode_32k", "tensor_parallel", 8),
             ("granite-moe-3b-a800m", "decode_32k", "expert_parallel", 8),
             ("rwkv6-7b", "decode_32k", "tensor_parallel", 8),
             ("whisper-medium", "decode_32k", "tensor_parallel", 8),
             ("granite-3-2b", "long_500k", "tensor_parallel", 1))
DRY_CHILDREN = tuple(
    [("repro_torch.launch.dryrun_ann", (*mp, "--rerank", r))
     for mp in ((), ("--multi-pod",)) for r in ("gather", "masked_full")]
    + [("repro_torch.launch.dryrun", ("--arch", "granite-3-2b", "--shape", s))
       for s in ("train_4k", "prefill_32k", "decode_32k")]
    + [("repro_torch.launch.dryrun", ("--arch", "arctic-480b", "--shape", "decode_32k",
                                      "--multi-pod"))])


def dry_numbers(h: dict, arg_bytes: int) -> dict:
    return {"flops": h["flops"], "bytes": h["bytes"], "payload": h["collective_bytes"],
            "argument_bytes": arg_bytes}


def dry_ann_identity(torch) -> dict:
    """The distributed build covariance and both query pipelines counted
    (launch.op_analysis) on the card and on meta tensors by the same code
    (launch.dryrun_ann's make_index, ann_jobs, count_job) at DRY_N x 128
    over a DRY_GRID grid of the card; every count equal."""
    from repro_torch.launch import dryrun_ann
    from repro_torch.mesh import make_mesh

    card = torch.device("cuda", torch.cuda.current_device())
    shards = math.prod(DRY_GRID)
    got = {}
    for device in (card, torch.device("meta")):
        gen = torch.Generator(device=card).manual_seed(0) if device == card else None
        index = dryrun_ann.make_index(DRY_N, 128, dryrun_ann.ann_config(), device=device,
                                      generator=gen)
        queries = (torch.randn((32, 128), generator=gen, device=device) if gen is not None
                   else torch.empty((32, 128), device=device))
        mesh = make_mesh((shards,), ("shard",), [device] * shards)
        for job, rerank in DRY_ANN_JOBS:
            cfg = dryrun_ann.ann_config(rerank)
            fn, arg_bytes = dryrun_ann.ann_jobs(
                mesh, index, cfg, queries, index.data, index.data[:, :4].contiguous(),
                index.subspaces[0].centroids1[:, :4].contiguous())[job]
            h, secs = dryrun_ann.count_job(mesh, fn)
            torch.cuda.synchronize()
            side = "card" if device == card else "meta"
            got[side, job, rerank] = dict(dry_numbers(h, arg_bytes), seconds=secs)
        del index
        torch.cuda.empty_cache()
    rows = {}
    for job, rerank in DRY_ANN_JOBS:
        a, b = got["card", job, rerank], got["meta", job, rerank]
        same = all(a[key] == b[key] for key in ("flops", "bytes", "payload", "argument_bytes"))
        print(f"dryrun identity {job} ({rerank}): card {json.dumps(a)} meta {json.dumps(b)} "
              f"equal {same}", flush=True)
        check(same, f"dryrun: {job} ({rerank}) counted on the card differs from meta")
        check(a["flops"] > 0 and a["bytes"] > 0, f"dryrun: {job} counted no work")
        rows[f"{job}/{rerank}"] = {"card": a, "meta": b}
    return rows


def dry_decode_identity(torch) -> dict:
    """Each of DRY_CELLS' decode steps through launch.dryrun.count_cell on
    the card (seeded bf16 weights, zero inputs) and on meta, in the layout
    the dry run gives it: the decode_32k cells at one position's block (8
    sequences, a 32,768 cache), the long_500k one context-parallel (the one
    row over all 256 positions, each its block of 2,048 of the 524,288
    slots): every count equal."""
    from repro_torch.launch import dryrun

    card = torch.device("cuda", torch.cuda.current_device())
    rows = {}
    for arch, shape, layout, rows_n in DRY_CELLS:
        got = {}
        torch.cuda.reset_peak_memory_stats()
        for device in (card, torch.device("meta")):
            t0 = time.perf_counter()
            h, meta = dryrun.count_cell(arch, shape, False, device=device)
            torch.cuda.synchronize()
            side = "card" if device == card else "meta"
            got[side] = dict(dry_numbers(h, meta["argument_size_in_bytes"]),
                             rows=meta["rows_per_position"], layout=meta["layout_name"],
                             seconds=time.perf_counter() - t0)
            if device == card:
                got["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            del h, meta
            torch.cuda.empty_cache()
        a, b = got["card"], got["meta"]
        same = all(a[key] == b[key] for key in ("flops", "bytes", "payload", "argument_bytes"))
        print(f"dryrun identity {arch} x {shape} ({a['layout']}): card {json.dumps(a)} meta "
              f"{json.dumps(b)} equal {same}; the card's peak {got['peak_gib']:.2f} GiB",
              flush=True)
        check(same, f"dryrun: {arch} x {shape} counted on the card differs from meta")
        check(a["layout"] == b["layout"] == layout,
              f"dryrun: {arch} x {shape} ran the {a['layout']} layout, not {layout}")
        check(a["rows"] == rows_n and a["flops"] > 0,
              f"dryrun: {arch} x {shape} ran {a['rows']} rows")
        rows[f"{arch} x {shape}"] = got
    return rows


def dry_children(root) -> dict:
    """The dry runs themselves (meta tensors, no card) in child processes,
    all at once: each must exit 0 and write its artifact, whose per-job
    numbers are printed."""
    import os

    out = root / "chiprun_out" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = []
    for module, args in DRY_CHILDREN:
        procs.append((module, args, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", module, *args, "--out", str(out)], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    rows = []
    for module, args, t0, proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        secs = time.perf_counter() - t0
        label = f"{module.rsplit('.', 1)[1]} {' '.join(args)}"
        check(proc.returncode == 0, f"dryrun: {label}: exit {proc.returncode}: {stderr[-3000:]}")
        rows.append({"run": label, "seconds": secs, "stdout": stdout.splitlines()})
        print(f"dryrun child {label}: exit 0 in {secs:.2f} s", flush=True)
    for path in sorted(out.glob("*.json")):
        art = json.loads(path.read_text())
        jobs = ({j: art[j] for j in ("query", "build_cov", "build_lloyd")} if "query" in art
                else {art["step_kind"]: art})
        for job, r in jobs.items():
            h = r.get("op_analysis", r)
            print(f"dryrun {path.stem} {job}: flops {h['flops']:.6e} bytes {h['bytes']:.6e} "
                  f"payload {h['collective_total']:.6e} argument bytes "
                  f"{r['memory_analysis']['argument_size_in_bytes']} fits_one_card "
                  f"{r['fits_one_card']} seconds {r['compile_s']}", flush=True)
    return {"children": rows, "artifacts": sorted(p.name for p in out.glob("*.json"))}


def phase_dryrun(torch, root) -> dict:
    """Phase 16: the dry runs' counts held to the card (launch.op_analysis on
    the card's tensors equals it on meta tensors of the same shapes, the
    plain path on both sides), then the dry runs in child processes. The
    plain path launches no kernel."""
    rows, launches = run_path(torch, "dryrun", lambda: {
        "ann": dry_ann_identity(torch), "decode": dry_decode_identity(torch)})
    check(not any(launches.values()), f"dryrun: the plain path launched {launches}")
    rows["children"] = dry_children(root)
    rows["launches"] = launches
    return rows


#: the tensor-parallel phase: granite-3-2b at full width and depth over a
#: (data 2, model 4) grid of views of the card (repro_torch.models.sharded):
#: the train step with ZeRO-1, an f32 held check at TP_HELD_LAYERS layers,
#: prefill and decode on the sequence-split cache
TP_GRID = (2, 4)
TP_STEPS = 3
TP_HELD_LAYERS, TP_HELD_STEPS = 4, 2
TP_PREFILL = (2, 4096)  # rows x prompt: one sequence a data block
TP_DECODE = 16
#: the held check against make_train_step, float32: loss and grad norm
#: relative, and each parameter's distance relative to its norm
TP_METRIC_RTOL, TP_PARAM_RTOL = 1e-4, 1e-5
#: the held check's peak learning rate, and the bound (in lr x steps) on a
#: leaf whose true gradient is zero (whisper's K biases: a bias on the keys
#: adds one constant to a query's scores, which the softmax cancels)
HELD_LR, HELD_NOISE_LRS = 3e-4, 2


def tp_mesh():
    from repro_torch.mesh import make_mesh

    return make_mesh(TP_GRID, ("data", "model"))


def tp_payloads(torch, mesh, fn):
    """``fn()`` with the collectives' payloads tallied (a counter active
    for the walks' positions and tallies, not tracing any op): the bytes
    one position moves by kind and the counts, the largest over the grid."""
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.mesh import counting

    counter = OpCounter(mesh)
    with counting(counter):
        out = fn()
    h = counter.analysis()
    return out, {"bytes": h["collective_bytes"], "counts": h["collective_counts"]}


def tp_meta_payloads(torch, cfg, opt, lr, batch) -> dict:
    """The payloads of the same sharded step counted on meta tensors over a
    TP_GRID grid of meta positions (launch.op_analysis, one data block
    represented), as the dry run counts it."""
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharded as SHD
    from repro_torch.train import TrainState, make_sharded_train_step

    mesh = make_mesh(TP_GRID, ("data", "model"), ["meta"] * math.prod(TP_GRID))
    params = M.meta_params(cfg)
    state = SHD.place_train_state(TrainState(params=params, opt_state=opt[0](params),
                                             step=torch.zeros((), dtype=torch.int32)), mesh)
    step = make_sharded_train_step(cfg, opt, lr, mesh, impl="torch")
    meta_batch = {k: torch.empty(v.shape, dtype=torch.long, device="meta")
                  for k, v in batch.items()}
    with OpCounter(mesh, represent=True) as counter:
        step(state, meta_batch)
    h = counter.analysis()
    return {"bytes": h["collective_bytes"], "counts": h["collective_counts"]}


def tp_train(torch) -> dict:
    """make_sharded_train_step at granite-3-2b's full width and depth over
    TP_GRID (batch 8 x 128, f32 parameters, bf16 compute, remat, AdamW,
    warmup_cosine): TP_STEPS steps timed with CUDA events, exactly 2 flash
    launches a layer a position a step (forward and recompute), the first
    step's payloads by kind tallied on the card and equal to the same
    step's meta count (tp_meta_payloads), peak memory; make_train_step on
    one device for as many steps in the same call; each new flash shape's
    first call held against the plain version (fam_flash_shapes)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.kernels import ops
    from repro_torch.models import sharded as SHD
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import make_sharded_train_step, make_train_step, train_state_init

    cfg = get_arch(LM_ARCH)
    check(cfg.remat and cfg.compute_dtype == "bfloat16", "tensor parallel: the config moved")
    mesh = tp_mesh()
    positions = math.prod(TP_GRID)
    opt, lr = adamw(), warmup_cosine(3e-4, 20, TRAIN_STEPS + 1)
    stream = SyntheticTokenStream(cfg.vocab_size, 128, 8, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_state_init(torch.Generator(device="cuda").manual_seed(0), cfg, opt[0])
    placed = SHD.place_train_state(state, mesh)
    del state
    torch.cuda.empty_cache()
    place_s = time.perf_counter() - t0
    step = make_sharded_train_step(cfg, opt, lr, mesh)
    rows, payload, seen = [], {}, {}

    def run():
        nonlocal placed
        for s in range(TP_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            if s == 0:
                (placed, m), tallied = tp_payloads(torch, mesh,
                                                   lambda: step(placed, stream.batch(s)))
                payload.update(tallied)
            else:
                placed, m = step(placed, stream.batch(s))
            end.record()
            torch.cuda.synchronize()
            rows.append(dict(ms=start.elapsed_time(end), loss=float(m["loss"]),
                             grad_norm=float(m["grad_norm"])))

    flash = 2 * cfg.n_layers * positions
    restore = capture_shapes(ops, seen)
    try:
        _, l_tp = run_path(torch, "tensor_parallel_train", run,
                           expect={"flash_attention": flash * TP_STEPS})
    finally:
        restore()
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows),
          f"tensor parallel: a non-finite loss or grad norm {rows}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del placed
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    meta_payload = tp_meta_payloads(torch, cfg, opt, lr, stream.batch(0))
    meta_s = time.perf_counter() - t0
    check(meta_payload == payload, f"tensor parallel: the card's payloads {payload} against "
                                   f"the meta count's {meta_payload}")
    check(len(seen) == 1, f"tensor parallel: flash shapes {sorted(seen)}")
    flash_rows = fam_flash_shapes(torch, seen, "tensor parallel train")
    del seen
    torch.cuda.reset_peak_memory_stats()
    state, single_rows, l_single = par_train_run(
        torch, cfg, make_train_step(cfg, opt, lr), stream, "tensor_parallel_single",
        2 * cfg.n_layers * TP_STEPS, TP_STEPS)
    single_peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    torch.cuda.empty_cache()
    row = dict(arch=cfg.name, grid=list(TP_GRID), steps=TP_STEPS, batch=[8, 128],
               sharded=rows, single_device=single_rows, place_s=place_s,
               step_ms_sharded=par_steady_ms(rows), step_ms_single=par_steady_ms(single_rows),
               flash_per_step=flash, payload_first_step=payload,
               meta_count_s=meta_s, peak_gib=peak,
               peak_gib_single=single_peak, flash=flash_rows)
    print(f"tensor parallel train: {json.dumps({k: v for k, v in row.items() if k not in ('sharded', 'single_device')})}",
          flush=True)
    row["launches"] = [l_tp, l_single]
    return row


def tp_held(torch) -> dict:
    """granite-3-2b at full width, TP_HELD_LAYERS layers, float32, over
    TP_GRID against make_train_step (held_check)."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(LM_ARCH), n_layers=TP_HELD_LAYERS,
                              compute_dtype="float32")
    print(f"tensor parallel: cut: the held check at {TP_HELD_LAYERS} of 40 layers, float32",
          flush=True)
    return held_check(torch, cfg, TP_GRID, TP_HELD_STEPS, "tensor_parallel_held",
                      "tensor parallel held")


def held_check(torch, cfg, grid, steps: int, path: str, label: str, stream=None,
               shapes: int = 1, noise: tuple = ()) -> dict:
    """The sharded step against make_train_step at ``cfg``'s width and depth
    in float32 compute over ``grid``, ``steps`` AdamW steps from one seeded
    state on the same batches (``stream``'s, default 8 x 128 synthetic
    tokens): loss and grad norm within TP_METRIC_RTOL relative, every
    parameter within TP_PARAM_RTOL of its norm (its distance from the plain
    step's, relative to its update, printed); exactly two flash launches an
    attention layer a step a data block a position with heads (one device:
    a step), and the training flash shapes, where there are (``shapes`` of
    them), held against the plain version. The leaves whose key path ends
    with one of ``noise`` have a zero true gradient (rounding noise, which
    AdamW turns into steps of up to lr): they are held to
    HELD_NOISE_LRS x lr x steps, absolute, instead."""
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.kernels import ops
    from repro_torch.models import sharded as SHD
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import make_sharded_train_step, make_train_step, train_state_init
    from repro_torch.utils import tree_flatten, tree_flatten_with_paths

    mesh = ep_mesh(grid)
    opt, lr = adamw(), warmup_cosine(HELD_LR, 2, 10)
    stream = stream or SyntheticTokenStream(cfg.vocab_size, 128, 8, seed=1)
    state = train_state_init(torch.Generator(device="cuda").manual_seed(0), cfg, opt[0])
    start = [p.detach().clone() for p in tree_flatten(state.params)[0]]
    placed = SHD.place_train_state(state, mesh)
    sharded, plain = make_sharded_train_step(cfg, opt, lr, mesh), make_train_step(cfg, opt, lr)
    flash = 2 * attention_layers(cfg) * steps
    metrics, want, seen = [], [], {}

    def run_sharded():
        nonlocal placed
        for s in range(steps):
            placed, m = sharded(placed, stream.batch(s))
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})

    def run_plain():
        nonlocal state
        for s in range(steps):
            state, m = plain(state, stream.batch(s))
            want.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})

    restore = capture_shapes(ops, seen)
    try:
        _, l_sharded = run_path(torch, path, run_sharded, expect={
            "flash_attention": flash * grid[0] * ep_active(cfg, grid[1])})
    finally:
        restore()
    _, l_plain = run_path(torch, path, run_plain, expect={"flash_attention": flash})
    for a, b in zip(metrics, want):
        for key in ("loss", "grad_norm", "lr"):
            check(abs(a[key] - b[key]) <= TP_METRIC_RTOL * abs(b[key]),
                  f"{label}: {key} {a[key]} sharded against {b[key]}")
    back = SHD.unplace_train_state(placed)
    paths, leaves, _ = tree_flatten_with_paths(back.params)
    worst_norm = worst_update = worst_noise = 0.0
    worst_leaf = None
    for key, p, q, p0 in zip(paths, leaves, tree_flatten(state.params)[0], start):
        if noise and key.endswith(noise):
            worst_noise = max(worst_noise, float((p - q.detach()).abs().max()))
            continue
        d = float((p - q.detach()).norm())
        rel = d / max(float(q.detach().norm()), 1e-30)
        if rel > worst_norm:
            worst_norm, worst_leaf = rel, key
        worst_update = max(worst_update, d / max(float((q.detach() - p0).norm()), 1e-30))
    check(worst_norm <= TP_PARAM_RTOL, f"{label}: a parameter {worst_norm} of its norm from "
                                       f"make_train_step's ({worst_leaf})")
    check(worst_noise <= HELD_NOISE_LRS * HELD_LR * steps,
          f"{label}: a zero-gradient leaf {worst_noise} from make_train_step's")
    del back, placed, state, start
    torch.cuda.empty_cache()
    row = dict(layers=cfg.n_layers, grid=list(grid), steps=steps, sharded=metrics, single=want,
               worst_param_vs_norm=worst_norm, worst_leaf=worst_leaf,
               worst_param_vs_update=worst_update)
    if noise:
        row["worst_zero_gradient_leaf_abs"] = worst_noise
    if flash:
        check(len(seen) == shapes, f"{label}: flash shapes {sorted(seen)}")
        row["flash"] = fam_flash_shapes(torch, seen, label)
    print(f"{label}: {json.dumps({k: v for k, v in row.items() if k != 'flash'})}", flush=True)
    row["launches"] = [l_sharded, l_plain]
    return row


def tp_inference(torch) -> dict:
    """sharded_prefill of TP_PREFILL tokens (one sequence a data block;
    exactly one flash launch a layer a position) and TP_DECODE sharded
    decode steps on the sequence-split cache, in float32 and bf16 compute
    on the same f32 weights, against prefill and decode_step on one device
    (the last prompt position's logits and each step's): float32 within
    LM_F32_TOL with top-1 agreement >= LM_F32_TOP1; bf16 top-1 >=
    LM_BF16_TOP1 and mean |logits - f32 unsharded logits| at most
    LM_BF16_MEAN_SLACK times the unsharded bf16 run's. Prefill and decode
    timed with CUDA events beside the unsharded ones; each new flash shape
    held against the plain version."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import sharded as SHD

    cfg = get_arch(LM_ARCH)
    mesh = tp_mesh()
    rows_n, n = TP_PREFILL
    max_seq = n + TP_DECODE
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (rows_n, max_seq), generator=g, device="cuda")
    out, f32_logits, flash_rows = {}, None, []
    positions = math.prod(TP_GRID)

    def timed_call(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        return res, start.elapsed_time(end)

    launches = []
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        prompt = {"tokens": tokens[:, :n]}
        seen: dict = {}
        restore = capture_shapes(ops, seen)
        try:
            ((got0, cache), ms_tp), l_tp = run_path(
                torch, "tensor_parallel_prefill",
                lambda: timed_call(lambda: SHD.sharded_prefill(placed, c, prompt, max_seq, mesh)),
                expect={"flash_attention": c.n_layers * positions})
        finally:
            restore()
        ((want0, wcache), ms_one), l_one = run_path(
            torch, "tensor_parallel_prefill",
            lambda: timed_call(lambda: M.prefill(params, c, prompt, max_seq)),
            expect={"flash_attention": c.n_layers})
        got, want, step_ms, one_ms = [got0[:, 0]], [want0[:, 0]], [], []

        def decode():
            nonlocal cache, wcache
            for t in range(n, max_seq):
                tok = tokens[:, t:t + 1]
                (lg, cache), ms = timed_call(
                    lambda: SHD.sharded_decode_step(placed, c, cache, tok, t, mesh))
                (lw, wcache), ms1 = timed_call(lambda: M.decode_step(params, c, wcache, tok, t))
                got.append(lg[:, 0])
                want.append(lw[:, 0])
                step_ms.append(ms)
                one_ms.append(ms1)

        _, l_dec = run_path(torch, "tensor_parallel_decode", decode,
                            expect={"flash_attention": 0})
        launches += [l_tp, l_one, l_dec]
        got, want = torch.stack(got), torch.stack(want)
        check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (
            TP_DECODE + 1, rows_n, cfg.vocab_size), f"tensor parallel {dtype}: logits "
                                                    f"{tuple(got.shape)}")
        err = float((got - want).abs().max())
        top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        row = dict(max_abs_err=err, top1_agreement=top1, prefill_ms=ms_tp,
                   prefill_ms_single=ms_one, decode_step_ms=sorted(step_ms)[len(step_ms) // 2],
                   decode_step_ms_single=sorted(one_ms)[len(one_ms) // 2])
        if dtype == "float32":
            check(torch.allclose(got, want, rtol=LM_F32_TOL, atol=LM_F32_TOL)
                  and top1 >= LM_F32_TOP1,
                  f"tensor parallel f32: max abs err {err}, top-1 agreement {top1}")
            f32_logits = want
        else:
            mean = {"sharded": float((got - f32_logits).abs().mean()),
                    "single": float((want - f32_logits).abs().mean())}
            check(top1 >= LM_BF16_TOP1
                  and mean["sharded"] <= LM_BF16_MEAN_SLACK * mean["single"],
                  f"tensor parallel bf16: top-1 agreement {top1}, mean |logits - f32| {mean}")
            row["mean_abs_vs_f32"] = mean
        check(len(seen) == 1, f"tensor parallel prefill {dtype}: flash shapes {sorted(seen)}")
        flash_rows += fam_flash_shapes(torch, seen, f"tensor parallel prefill {dtype}")
        del seen
        out[dtype] = row
        print(f"tensor parallel {dtype}: prefill {rows_n} x {n} and {TP_DECODE} decode steps: "
              f"{json.dumps(row)}", flush=True)
        del cache, wcache, got, want
        torch.cuda.empty_cache()
    del placed, params
    torch.cuda.empty_cache()
    out["flash"] = flash_rows
    out["launches"] = launches
    return out


def phase_tensor_parallel(torch) -> dict:
    """Phase 17: granite-3-2b's tensor parallelism over 'model' and ZeRO-1
    over 'data' on a (2, 4) grid of views of the card: the train step
    beside make_train_step, the f32 held check, prefill and decode on the
    sequence-split cache; each model freed before the next."""
    check(not torch.backends.cuda.matmul.allow_tf32, "tensor parallel: TF32 matmuls are on")
    rows = {}
    for name, fn in (("train", tp_train), ("held", tp_held), ("inference", tp_inference)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows[name] = fn(torch)
        torch.cuda.empty_cache()
        rows[name]["seconds"] = time.perf_counter() - t0
        rows[name]["peak_gib_phase"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"tensor parallel {name}: {rows[name]['seconds']:.2f} s, peak "
              f"{rows[name]['peak_gib_phase']:.2f} GiB", flush=True)
    rows["launches"] = [c for r in ("train", "held", "inference") for c in rows[r]["launches"]]
    return rows


#: the expert-parallel phase: the moe family over (data, model) grids of
#: views of the card (repro_torch.models.sharded's MoE sub-layer).
#: granite-moe-3b-a800m at full width: its 40 experts over 16 positions
#: split the expert FFN width, over (2, 4) whole experts (10 a position)
EP_ARCH = "granite-moe-3b-a800m"
EP_GRIDS = ((1, 16), (2, 4))
#: the layers of granite-moe's inference runs: 16 of 32, cut since phase 20
#: joined the script (the runs are host-bound, their time linear in depth)
EP_INFER_LAYERS = 16
EP_PREFILL = (2, 1024)  # rows x prompt of the bf16 prefills
EP_DECODE = 8
#: the train step over (2, 4): 16 of 32 layers (the f32 state of all 32,
#: 54 GB, and its placement would not leave room for the gradients)
EP_TRAIN_GRID = (2, 4)
EP_TRAIN_LAYERS, EP_TRAIN_STEPS = 16, 2
EP_TRAIN_BATCH = (8, 128)
EP_HELD_LAYERS, EP_HELD_STEPS = 4, 2
#: arctic-480b at full width, 1 layer (14,273,631,232 bf16 parameters)
#: over (2, 4): 32 experts a position, the manual MoE, Adafactor
EP_ARCTIC = "arctic-480b"
EP_ARCTIC_GRID = (2, 4)
EP_ARCTIC_PREFILL = (2, 512)
EP_ARCTIC_DECODE = 4
EP_ARCTIC_BATCH = (4, 128)
#: bf16 top-1: the sharded run's agreement with the f32 run (the same
#: routing) at least the one-device bf16 run's less this share of the
#: positions. Two bf16 runs of these random-weight models part on near-ties
#: of the logits (0.947-0.965 between sharded and one device, PR 28), so
#: the lm phase's absolute 95 % does not measure the sharding; each run's
#: agreement with the same truth does. The slack is this many standard
#: deviations of the difference of two shares of N positions near the one
#: device's share p (top1_slack: 3 sqrt(2 p (1 - p) / N)), so that a sound
#: run passes whatever the seed and the size
EP_BF16_TOP1_SIGMAS = 3
#: float32 compute: the least share of the routing decisions (a token's
#: top-k and kept set, call by call) that a sharded run makes as one
#: device's run does, each with its own routing. A near-tie flips a token's
#: experts on rounding alone and moves that token's later layers; a fault in
#: the capacity, the slot order or the dispatch chunk moves most tokens
EP_ROUTED_ALIKE = 0.99


def top1_slack(p: float, n: int) -> float:
    """How far a bf16 run's top-1 share with the f32 run over ``n``
    positions may fall below one device's share ``p``: EP_BF16_TOP1_SIGMAS
    binomial standard deviations of the difference of two such shares."""
    return EP_BF16_TOP1_SIGMAS * math.sqrt(2 * p * (1 - p) / n)


def moe_layers(cfg) -> int:
    """The MoE sub-layers of the stack (every layer for the moe family, every
    second one for jamba)."""
    return cfg.n_groups * sum(spec["ffn"] in ("moe", "moe_dense") for spec in cfg.layer_specs())


def ep_active(cfg, n: int) -> int:
    """The 'model' positions that run attention heads (HeadPlan)."""
    from repro_torch.models.sharded import HeadPlan

    plan = HeadPlan(n, cfg.n_heads, cfg.n_kv_heads)
    return sum(plan.q_range(m)[1] > plan.q_range(m)[0] for m in range(n))


def ep_timed(torch, fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def ep_generate(torch, prefill, decode, tokens, n: int, steps: int, snap=None):
    """The last prompt position's logits and each teacher-forced decode
    step's, stacked (steps + 1, B, V), with the prefill's and the median
    decode step's ms, and ``snap(cache)`` taken after the first decode step
    (None without ``snap``)."""
    (logits, cache), prefill_ms = ep_timed(torch, lambda: prefill({"tokens": tokens[:, :n]}))
    out, step_ms, first = [logits[:, 0]], [], None
    for t in range(n, n + steps):
        (logits, cache), ms = ep_timed(torch, lambda: decode(cache, tokens[:, t:t + 1], t))
        out.append(logits[:, 0])
        step_ms.append(ms)
        if snap is not None and t == n:
            first = snap(cache)
    return torch.stack(out), prefill_ms, sorted(step_ms)[len(step_ms) // 2], first


def ep_gates(torch, label: str, got, want: dict, key: str) -> dict:
    """``got`` against the one-device runs of ``key`` (the same routing):
    top-1 agreement with the f32-compute run and with the bf16 run, and
    mean |logits - f32| beside the one-device bf16 run's; the top-1 slack
    (top1_slack) at one device's share over ``got``'s positions."""
    bf16, f32 = want[key], want[key + "_f32"]
    check(bool(torch.isfinite(got).all()) and tuple(got.shape) == tuple(bf16.shape),
          f"{label}: logits {tuple(got.shape)}")

    def top1(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())

    single = top1(bf16, f32)
    return {"top1_vs_f32": {"sharded": top1(got, f32), "single": single,
                            "slack": top1_slack(single, f32.numel() // f32.shape[-1])},
            "top1_vs_single": top1(got, bf16),
            "mean_abs_vs_f32": {"sharded": float((got - f32).abs().mean()),
                                "single": float((bf16 - f32).abs().mean())}}


def ep_inference(torch, cfg, params, grid, rows_n: int, n: int, steps: int, label: str,
                 want: dict, path: str = "expert_parallel_prefill") -> dict:
    """sharded_forward of the prompt, and sharded_prefill with ``steps``
    sharded decode steps, of the bf16 weights ``params`` over ``grid``,
    against ``want`` (ep_single: one device's bf16 runs and its f32-compute
    runs on the same weights and the same routing, each data block one
    dispatch chunk). Each sharded run's routing is pinned to the one
    device's bf16 run's (the runs differ by rounding before each router,
    and a near-tie would send a token to other experts; unpinned, the bf16
    forward's numbers are reported). bf16, the f32-compute run as the
    truth: for the forward and for prefill and decode, mean |logits - f32|
    at most LM_BF16_MEAN_SLACK times the one device's bf16 run's (the lm
    phase's distance gate); the forward's top-1 agreement with the truth
    over the rows x n positions at least the one device's bf16 run's less
    top1_slack (agreement with the one-device bf16 run, and prefill
    and decode's top-1 over rows x (steps + 1) positions, reported). float32
    compute against one device's on its routing: within LM_F32_TOL, top-1
    >= LM_F32_TOP1. The float32 forward unpinned, each with its own
    routing: at least EP_ROUTED_ALIKE of the routing decisions alike (its
    logits' distance and top-1, and the first MoE layer's share, reported).
    Exactly one flash launch a layer a data block a position with heads a
    forward and a prefill. Each run is a run of ``path``."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models import moe as MOE
    from repro_torch.models import sharded as SHD

    mesh = ep_mesh(grid)
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    split = SHD._expert_split(SHD._Row(cfg, mesh, {"data": 0}, "auto"), next(
        layer["moe"] for layer in SHD._groups(placed["blocks"], cfg.n_groups)[0].values()
        if "moe" in layer))
    seen: dict = {}
    flash = attention_layers(cfg) * grid[0] * ep_active(cfg, grid[1])
    # the cache's sequence splits over 'model' only where it divides
    max_seq = -(-(n + steps) // grid[1]) * grid[1]
    prompt = {"tokens": want["tokens"][:, :n]}

    def forward(c):
        return lambda: ep_timed(torch, lambda: SHD.sharded_forward(placed, c, prompt, mesh)[0])

    def generate():
        return ep_generate(
            torch, lambda b: SHD.sharded_prefill(placed, cfg, b, max_seq, mesh),
            lambda c, tok, t: SHD.sharded_decode_step(placed, cfg, c, tok, t, mesh),
            want["tokens"], n, steps)

    restore = capture_shapes(ops, seen)
    try:
        (fwd, forward_ms), _, l_fwd = ep_pinned(torch, path, None,
                                                forward(cfg), flash)
    finally:
        restore()
    unpinned = ep_gates(torch, label, fwd, want, "fwd")
    row = dict(grid=list(grid), experts=split, unpinned={
        "top1_vs_single": unpinned["top1_vs_single"], "mean_abs_vs_f32": {
            "sharded": float((fwd - want["fwd_f32_own"]).abs().mean()),
            "single": float((want["fwd"] - want["fwd_f32_own"]).abs().mean())}})
    (fwd, _), alike, l_pin = ep_pinned(torch, path, want["routes"],
                                       forward(cfg), flash)
    row["forward"] = dict(ep_gates(torch, label, fwd, want, "fwd"), routed_alike=alike)
    (got, prefill_ms, step_ms, _), alike, l_gen = ep_pinned(
        torch, path, want["routes_gen"], generate, flash)
    row["generate"] = dict(ep_gates(torch, label, got, want, "gen"), routed_alike=alike)
    del fwd, got
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    (f32, _), alike, l_f32 = ep_pinned(torch, path, want["routes"],
                                       forward(c32), flash)
    row["f32"] = {"max_abs_err": float((f32 - want["fwd_f32"]).abs().max()),
                  "top1": float((f32.argmax(-1) == want["fwd_f32"].argmax(-1)).float().mean()),
                  "routed_alike": alike}
    f32_close = torch.allclose(f32, want["fwd_f32"], rtol=LM_F32_TOL, atol=LM_F32_TOL)
    del f32
    routes, probs = [], []
    unroute = routing_spy(MOE, routes, probs_seen=probs)
    try:
        (own, _), _, l_own = ep_pinned(torch, path, None, forward(c32),
                                       flash)
    finally:
        unroute()
    alike = ep_alike(list(zip(probs, routes)), want["routes_f32_own"])
    per = len(alike) // moe_layers(cfg)  # route calls a MoE layer: one a data block
    ref = want["fwd_f32_own"]
    row["f32_unpinned"] = {
        "routed_alike": sum(alike) / len(alike), "routed_alike_min": min(alike),
        "first_layer_routed_alike": sum(alike[:per]) / per,
        "max_abs_err": float((own - ref).abs().max()),
        "top1": float((own.argmax(-1) == ref.argmax(-1)).float().mean())}
    del own, ref, routes, probs
    row.update(forward_ms=forward_ms, forward_ms_single=want["forward_ms"],
               prefill_ms=prefill_ms, decode_step_ms=step_ms,
               prefill_ms_single=want["prefill_ms"], decode_step_ms_single=want["step_ms"],
               flash_per_prefill=flash)
    print(f"{label}: {json.dumps(row)}", flush=True)
    top1 = row["forward"]["top1_vs_f32"]
    check(top1["sharded"] >= top1["single"] - top1["slack"],
          f"{label}: bf16 top-1 agreement with f32 {top1}")
    check(f32_close and row["f32"]["top1"] >= LM_F32_TOP1, f"{label}: float32 {row['f32']}")
    check(row["f32_unpinned"]["routed_alike"] >= EP_ROUTED_ALIKE,
          f"{label}: float32 unpinned {row['f32_unpinned']}")
    for what in ("forward", "generate"):
        r = row[what]["mean_abs_vs_f32"]
        check(r["sharded"] <= LM_BF16_MEAN_SLACK * r["single"], f"{label}: {what} {r}")
    check(len(seen) == 1, f"{label}: flash shapes {sorted(seen)}")
    row["flash"] = fam_flash_shapes(torch, seen, label)
    row["launches"] = [l_fwd, l_pin, l_gen, l_f32, l_own]
    del placed
    torch.cuda.empty_cache()
    return row


def ep_pinned(torch, path: str, routes, fn, flash: int) -> tuple:
    """``fn()`` without gradients as one path run with exactly ``flash``
    flash launches, its routing pinned to ``routes`` (ep_pinned_routes;
    unpinned where None): (result, the share of tokens its own routing sent
    alike, launches)."""
    from repro_torch.models import moe as MOE

    agree: list = []
    unroute = ep_pinned_routes(MOE, routes, agree) if routes is not None else lambda: None
    try:
        with torch.no_grad():
            out, launches = run_path(torch, path, fn, expect={"flash_attention": flash})
    finally:
        unroute()
    return out, (sum(agree) / len(agree) if agree else None), launches


def ep_mesh(grid):
    from repro_torch.mesh import make_mesh

    return make_mesh(grid, ("data", "model"))


def ep_single(torch, cfg, params, n_dp: int, tokens, n: int, steps: int,
              path: str = "expert_parallel_single") -> dict:
    """The one-device runs the sharded ones are held to, with ``n_dp``
    dispatch chunks (a data block each): forward of the prompt, then
    prefill and decode_step, in bf16, their routing recorded (``routes``,
    ``routes_gen``: (router probabilities, decisions) a call); the same in
    f32 compute with the routing pinned to the bf16 runs' (``fwd_f32``,
    ``gen_f32``: the truth the bf16 runs are measured against), and the f32
    forward with its own routing (``fwd_f32_own``), recorded
    (``routes_f32_own``). Each run is a run of ``path``."""
    import dataclasses

    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    out, launches = {"tokens": tokens}, []

    def runs(c):
        return (lambda: ep_timed(torch, lambda: M.forward(params, c, {"tokens": tokens[:, :n]})[0]),
                lambda: ep_generate(torch, lambda b: M.prefill(params, c, b, n + steps),
                                    lambda ca, tok, t: M.decode_step(params, c, ca, tok, t),
                                    tokens, n, steps))

    def recorded(key, fn):
        routes, probs = [], []
        unroute = routing_spy(MOE, routes, probs_seen=probs)
        try:
            res, _, l_run = ep_pinned(torch, path, None, fn, attention_layers(cfg))
        finally:
            unroute()
        out[key] = list(zip(probs, routes))
        launches.append(l_run)
        return res

    chunked = dataclasses.replace(cfg, moe_impl="gspmd", moe_dispatch_chunks=n_dp)
    bf16, f32 = (dataclasses.replace(chunked, compute_dtype=d) for d in ("bfloat16", "float32"))
    forward, generate = runs(bf16)
    out["fwd"], out["forward_ms"] = recorded("routes", forward)
    out["gen"], out["prefill_ms"], out["step_ms"], _ = recorded("routes_gen", generate)
    forward, generate = runs(f32)
    for key, routes, fn in (("fwd_f32", out["routes"], forward),
                            ("gen_f32", out["routes_gen"], generate)):
        res, _, l_run = ep_pinned(torch, path, routes, fn, attention_layers(cfg))
        out[key] = res[0]
        launches.append(l_run)
    out["fwd_f32_own"] = recorded("routes_f32_own", forward)[0]
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def ep_granite_inference(torch) -> dict:
    """granite-moe-3b-a800m's bf16 weights at full width, EP_INFER_LAYERS
    of 32 layers, prefill EP_PREFILL and EP_DECODE decode steps over each
    of EP_GRIDS against one device in the same call."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_arch(EP_ARCH), param_dtype="bfloat16",
                              n_layers=EP_INFER_LAYERS)
    print(f"expert parallel: cut: the inference runs at {EP_INFER_LAYERS} of 32 layers",
          flush=True)
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    rows_n, n = EP_PREFILL
    g = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (rows_n, n + EP_DECODE), generator=g,
                           device="cuda")
    out, launches = {}, []
    for grid in EP_GRIDS:
        want = ep_single(torch, cfg, params, grid[0], tokens, n, EP_DECODE)
        launches += want.pop("launches")
        row = ep_inference(torch, cfg, params, grid, rows_n, n, EP_DECODE,
                           f"expert parallel {EP_ARCH} {grid[0]}x{grid[1]}", want)
        launches += row.pop("launches")
        out[f"{grid[0]}x{grid[1]}"] = row
        del want
        torch.cuda.empty_cache()
    check(out["1x16"]["experts"] == "width" and out["2x4"]["experts"] == "experts",
          f"expert parallel: splits {out['1x16']['experts']}, {out['2x4']['experts']}")
    del params
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def ep_meta_payloads(torch, cfg, opt, lr, batch, grid) -> dict:
    """The payloads of the same sharded step counted on meta tensors over
    a ``grid`` of meta positions (launch.op_analysis), as the dry run
    counts it."""
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharded as SHD
    from repro_torch.train import TrainState, make_sharded_train_step

    mesh = make_mesh(grid, ("data", "model"), ["meta"] * math.prod(grid))
    params = M.meta_params(cfg)
    state = SHD.place_train_state(TrainState(params=params, opt_state=opt[0](params),
                                             step=torch.zeros((), dtype=torch.int32)), mesh)
    step = make_sharded_train_step(cfg, opt, lr, mesh, impl="torch")
    meta_batch = {k: torch.empty(v.shape, dtype=torch.float32 if k == "frames" else torch.long,
                                 device="meta") for k, v in batch.items()}
    with OpCounter(mesh, represent=True) as counter:
        step(state, meta_batch)
    h = counter.analysis()
    return {"bytes": h["collective_bytes"], "counts": h["collective_counts"]}


def ep_train_steps(torch, step, placed, stream, steps: int, mesh, path: str, flash: int,
                   seen: dict, payload: dict | None = None) -> tuple:
    """``steps`` sharded steps as one path run (CUDA events a step; the
    first step's payloads tallied into ``payload``): (state, rows)."""
    from repro_torch.kernels import ops

    rows = []

    def run():
        nonlocal placed
        for s in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            if s == 0 and payload is not None:
                (placed, m), tallied = tp_payloads(torch, mesh,
                                                   lambda: step(placed, stream.batch(s)))
                payload.update(tallied)
            else:
                placed, m = step(placed, stream.batch(s))
            end.record()
            torch.cuda.synchronize()
            rows.append(dict(ms=start.elapsed_time(end), loss=float(m["loss"]),
                             grad_norm=float(m["grad_norm"]), aux_loss=float(m["aux_loss"])))

    restore = capture_shapes(ops, seen)
    try:
        _, launches = run_path(torch, path, run, expect={"flash_attention": flash * steps})
    finally:
        restore()
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
              and math.isfinite(r["aux_loss"]) for r in rows),
          f"{path}: a non-finite loss, grad norm or aux {rows}")
    return placed, rows, launches


def ep_train(torch) -> dict:
    """make_sharded_train_step at granite-moe's full width, EP_TRAIN_LAYERS
    layers, over EP_TRAIN_GRID (whole experts, gspmd's whole-batch aux;
    batch EP_TRAIN_BATCH, f32 parameters, bf16 compute, remat, AdamW):
    EP_TRAIN_STEPS steps timed, exactly 2 flash launches a layer a data
    block a position a step, the first step's payloads tallied on the card
    and equal to the same step's meta count, peak memory; make_train_step
    at the same depth beside it (its MoE in a chunk a data block)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.models import sharded as SHD
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import make_sharded_train_step, make_train_step, train_state_init

    cfg = dataclasses.replace(get_arch(EP_ARCH), n_layers=EP_TRAIN_LAYERS)
    print(f"expert parallel: cut: the train step at {EP_TRAIN_LAYERS} of 32 layers", flush=True)
    mesh = ep_mesh(EP_TRAIN_GRID)
    opt, lr = adamw(), warmup_cosine(3e-4, 20, EP_TRAIN_STEPS + 1)
    stream = SyntheticTokenStream(cfg.vocab_size, EP_TRAIN_BATCH[1], EP_TRAIN_BATCH[0], seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_state_init(torch.Generator(device="cuda").manual_seed(0), cfg, opt[0])
    placed = SHD.place_train_state(state, mesh)
    del state
    torch.cuda.empty_cache()
    place_s = time.perf_counter() - t0
    step = make_sharded_train_step(cfg, opt, lr, mesh)
    flash = (1 + cfg.remat) * cfg.n_layers * EP_TRAIN_GRID[0] * ep_active(cfg, EP_TRAIN_GRID[1])
    payload, seen = {}, {}
    placed, rows, l_ep = ep_train_steps(torch, step, placed, stream, EP_TRAIN_STEPS, mesh,
                                        "expert_parallel_train", flash, seen, payload)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del placed
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    meta_payload = ep_meta_payloads(torch, cfg, opt, lr, stream.batch(0), EP_TRAIN_GRID)
    meta_s = time.perf_counter() - t0
    check(meta_payload == payload, f"expert parallel: the card's payloads {payload} against "
                                   f"the meta count's {meta_payload}")
    check(len(seen) == 1, f"expert parallel train: flash shapes {sorted(seen)}")
    flash_rows = fam_flash_shapes(torch, seen, "expert parallel train")
    del seen
    torch.cuda.reset_peak_memory_stats()
    single_cfg = dataclasses.replace(cfg, moe_dispatch_chunks=EP_TRAIN_GRID[0])
    state, single_rows, l_single = par_train_run(
        torch, single_cfg, make_train_step(single_cfg, opt, lr), stream,
        "expert_parallel_single", (1 + cfg.remat) * cfg.n_layers * EP_TRAIN_STEPS,
        EP_TRAIN_STEPS)
    single_peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    torch.cuda.empty_cache()
    row = dict(arch=cfg.name, layers=cfg.n_layers, grid=list(EP_TRAIN_GRID),
               steps=EP_TRAIN_STEPS, batch=list(EP_TRAIN_BATCH), sharded=rows,
               single_device=single_rows, place_s=place_s,
               step_ms_sharded=par_steady_ms(rows), step_ms_single=par_steady_ms(single_rows),
               flash_per_step=flash, payload_first_step=payload, meta_count_s=meta_s,
               peak_gib=peak, peak_gib_single=single_peak, flash=flash_rows)
    print(f"expert parallel train: {json.dumps({k: v for k, v in row.items() if k != 'flash'})}",
          flush=True)
    row["launches"] = [l_ep, l_single]
    return row


def ep_pinned_routes(moe_module, recorded: list, agree: list):
    """Wrap the MoE's ``route`` so that each call takes the decisions
    (expert ids, dispatch order, positions, kept set) of the recorded call
    whose router probabilities are nearest its own (the same tokens routed
    by the other path), its gates renormalised from its own probabilities;
    ``agree`` gets, call by call, the share of tokens whose own top-k and
    kept set were the same. Returns a function that puts the original
    back."""
    route = moe_module.route

    def spy(probs, k, cap):
        own = route(probs, k, cap)
        near = ep_nearest(recorded, probs)
        exp_idx, _, fe, pos, keep = near[1]
        agree.append(float(ep_routed_alike(own, near[1]).float().mean()))
        gates = probs.gather(1, exp_idx)
        return exp_idx, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), fe, pos, keep

    moe_module.route = spy
    return lambda: setattr(moe_module, "route", route)


def ep_nearest(recorded: list, probs):
    """The recorded (router probabilities, decisions) call whose
    probabilities are nearest ``probs``: the same tokens routed by the
    other path."""
    return min((r for r in recorded if r[0].shape == probs.shape),
               key=lambda r: float((r[0] - probs.detach()).abs().max()))


def ep_routed_alike(own, other):
    """Token by token, whether two route calls' decisions (expert ids,
    dispatch order, positions, kept set) give the same top-k and kept set."""
    k, t = own[0].shape[1], own[0].shape[0]
    return (own[0] == other[0]).all(-1) & (own[4].view(k, t) == other[4].view(k, t)).all(0)


def ep_alike(mine: list, theirs: list) -> list:
    """For each recorded call of ``mine``, the share of its tokens that the
    nearest call of ``theirs`` routed alike."""
    return [float(ep_routed_alike(own, ep_nearest(theirs, probs)[1]).float().mean())
            for probs, own in mine]


def ep_held(torch) -> dict:
    """The sharded step against make_train_step at granite-moe's full
    width, EP_HELD_LAYERS layers, float32 compute, EP_HELD_STEPS steps over
    EP_TRAIN_GRID from one seeded state on the same batches, the
    one-device run's routing pinned to the sharded run's (the two differ by
    rounding before the router, and a near-tie would send a token to other
    experts): loss, grad norm and aux within TP_METRIC_RTOL relative, every
    parameter within TP_PARAM_RTOL of its norm; at least EP_ROUTED_ALIKE of
    the one device's own routing decisions the sharded run's."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.models import moe as MOE
    from repro_torch.models import sharded as SHD
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import make_sharded_train_step, make_train_step, train_state_init
    from repro_torch.utils import tree_flatten

    cfg = dataclasses.replace(get_arch(EP_ARCH), n_layers=EP_HELD_LAYERS,
                              compute_dtype="float32")
    print(f"expert parallel: cut: the held check at {EP_HELD_LAYERS} of 32 layers, float32",
          flush=True)
    mesh = ep_mesh(EP_TRAIN_GRID)
    opt, lr = adamw(), warmup_cosine(3e-4, 2, 10)
    stream = SyntheticTokenStream(cfg.vocab_size, EP_TRAIN_BATCH[1], EP_TRAIN_BATCH[0], seed=1)
    state = train_state_init(torch.Generator(device="cuda").manual_seed(0), cfg, opt[0])
    start = [p.detach().clone() for p in tree_flatten(state.params)[0]]
    placed = SHD.place_train_state(state, mesh)
    sharded = make_sharded_train_step(cfg, opt, lr, mesh)
    single_cfg = dataclasses.replace(cfg, moe_dispatch_chunks=EP_TRAIN_GRID[0])
    plain = make_train_step(single_cfg, opt, lr)
    flash = 2 * cfg.n_layers * EP_TRAIN_GRID[0] * ep_active(cfg, EP_TRAIN_GRID[1])
    routes, probs = [], []
    restore = routing_spy(MOE, routes, probs_seen=probs)
    try:
        placed, metrics, l_sharded = ep_train_steps(torch, sharded, placed, stream,
                                                    EP_HELD_STEPS, mesh, "expert_parallel_held",
                                                    flash, {})
    finally:
        restore()
    probs = [p.detach() for p in probs]
    agree, want, launches = [], [], [l_sharded]
    for s in range(EP_HELD_STEPS):
        # each step pinned to its own step's routes (the weights moved)
        per = len(routes) // EP_HELD_STEPS
        recorded = list(zip(probs[s * per:(s + 1) * per], routes[s * per:(s + 1) * per]))
        restore = ep_pinned_routes(MOE, recorded, agree)
        try:
            (state, m), l_plain = run_path(
                torch, "expert_parallel_held", lambda: plain(state, stream.batch(s)),
                expect={"flash_attention": 2 * cfg.n_layers})
        finally:
            restore()
        launches.append(l_plain)
        want.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr", "aux_loss")})
    del routes, probs
    for a, b in zip(metrics, want):
        for key in ("loss", "grad_norm", "aux_loss"):
            check(abs(a[key] - b[key]) <= TP_METRIC_RTOL * abs(b[key]),
                  f"expert parallel held: {key} {a[key]} sharded against {b[key]}")
    alike = sum(agree) / len(agree)
    check(alike >= EP_ROUTED_ALIKE,
          f"expert parallel held: {alike} of tokens routed alike, call by call {agree}")
    back = SHD.unplace_train_state(placed)
    worst_norm = worst_update = 0.0
    for p, q, p0 in zip(tree_flatten(back.params)[0], tree_flatten(state.params)[0], start):
        d = float((p - q.detach()).norm())
        worst_norm = max(worst_norm, d / max(float(q.detach().norm()), 1e-30))
        worst_update = max(worst_update, d / max(float((q.detach() - p0).norm()), 1e-30))
    check(worst_norm <= TP_PARAM_RTOL, f"expert parallel held: a parameter {worst_norm} of "
                                       "its norm from make_train_step's")
    del back, placed, state, start
    torch.cuda.empty_cache()
    row = dict(layers=EP_HELD_LAYERS, steps=EP_HELD_STEPS, sharded=metrics, single=want,
               routed_alike=alike, routed_alike_min=min(agree), worst_param_vs_norm=worst_norm,
               worst_param_vs_update=worst_update)
    print(f"expert parallel held: {json.dumps(row)}", flush=True)
    row["launches"] = launches
    return row


def ep_arctic(torch) -> dict:
    """arctic-480b at full width, 1 layer (bf16 weights, 28.5 GB) over
    EP_ARCTIC_GRID (32 experts a position, the manual MoE): the one-device
    f32-compute and bf16 prefill EP_ARCTIC_PREFILL and EP_ARCTIC_DECODE
    decode steps first, then the sharded ones held to them (ep_inference);
    then one Adafactor train step of the placed state (batch
    EP_ARCTIC_BATCH), its peak memory, exactly 2 flash launches a data
    block a position."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.models import model as M
    from repro_torch.models import sharded as SHD
    from repro_torch.optim import adafactor, warmup_cosine
    from repro_torch.train import TrainState, make_sharded_train_step

    cfg = dataclasses.replace(get_arch(EP_ARCTIC), n_layers=1)
    print("expert parallel: cut: arctic-480b to 1 of 35 layers", flush=True)
    check(cfg.param_dtype == "bfloat16" and cfg.moe_dense_residual, "arctic: the config moved")
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    rows_n, n = EP_ARCTIC_PREFILL
    g = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (rows_n, n + EP_ARCTIC_DECODE), generator=g,
                           device="cuda")
    want = ep_single(torch, cfg, params, EP_ARCTIC_GRID[0], tokens, n, EP_ARCTIC_DECODE)
    launches = want.pop("launches")
    manual = dataclasses.replace(cfg, moe_impl="manual")
    row = ep_inference(torch, manual, params, EP_ARCTIC_GRID, rows_n, n, EP_ARCTIC_DECODE,
                       f"expert parallel {EP_ARCTIC} {EP_ARCTIC_GRID[0]}x{EP_ARCTIC_GRID[1]}",
                       want)
    launches += row.pop("launches")
    check(row["experts"] == "experts", f"arctic: split {row['experts']}")
    del want
    inference_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    mesh = ep_mesh(EP_ARCTIC_GRID)
    opt, lr = adafactor(), warmup_cosine(3e-4, 2, 10)
    placed = SHD.place_train_state(TrainState(params=params, opt_state=opt[0](params),
                                              step=torch.zeros((), dtype=torch.int32)), mesh)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stream = SyntheticTokenStream(cfg.vocab_size, EP_ARCTIC_BATCH[1], EP_ARCTIC_BATCH[0], seed=2)
    step = make_sharded_train_step(manual, opt, lr, mesh)
    flash = (1 + cfg.remat) * EP_ARCTIC_GRID[0] * ep_active(cfg, EP_ARCTIC_GRID[1])
    seen = {}
    placed, rows, l_train = ep_train_steps(torch, step, placed, stream, 1, mesh,
                                           "expert_parallel_arctic", flash, seen)
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    del placed
    torch.cuda.empty_cache()
    row.update(train=rows, train_peak_gib=train_peak, inference_peak_gib=inference_peak,
               train_flash=fam_flash_shapes(torch, seen, "expert parallel arctic train"))
    print(f"expert parallel arctic train: {json.dumps(rows)}; peak {train_peak:.2f} GiB "
          f"(inference {inference_peak:.2f})", flush=True)
    row["launches"] = launches + [l_train]
    return row


def phase_expert_parallel(torch) -> dict:
    """Phase 18: the moe family's expert parallelism over 'model' on grids
    of views of the card: granite-moe's bf16 prefill and decode at full
    width and depth in both expert splits, its sharded train step beside
    make_train_step, the f32 held check, and arctic at full width (1 layer)
    with Adafactor; each model freed before the next."""
    check(not torch.backends.cuda.matmul.allow_tf32, "expert parallel: TF32 matmuls are on")
    rows = {}
    for name, fn in (("inference", ep_granite_inference), ("train", ep_train),
                     ("held", ep_held), ("arctic", ep_arctic)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows[name] = fn(torch)
        torch.cuda.empty_cache()
        rows[name]["seconds"] = time.perf_counter() - t0
        rows[name]["peak_gib_phase"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"expert parallel {name}: {rows[name]['seconds']:.2f} s, peak "
              f"{rows[name]['peak_gib_phase']:.2f} GiB", flush=True)
    rows["launches"] = [c for r in ("inference", "train", "held", "arctic")
                        for c in rows[r]["launches"]]
    return rows


#: the ssm_parallel phase: RWKV6 and the hybrid Mamba stack over 'model' on
#: grids of views of the card (repro_torch.models.sharded's time mix over
#: whole heads, channel mix, and Mamba mixer over its inner channels).
#: rwkv6-7b at full width and depth in bf16 weights over each grid
SSM_RWKV = "rwkv6-7b"
SSM_GRIDS = ((2, 4), (1, 16))
#: the layers of rwkv6's inference runs: 16 of 32, cut since phase 20
#: joined the script (host-bound, linear in depth)
SSM_INFER_LAYERS = 16
SSM_PREFILL = (2, 512)  # rows x prompt: a multiple of rwkv_chunk (the chunked WKV)
SSM_DECODE = 8
#: its train step over (2, 4) with AdamW and ZeRO-1: 8 of 32 layers (the f32
#: state with AdamW's moments is 27 GB at 8 layers, twice that while the
#: placement copies it; at 16 layers the copy would not fit)
SSM_TRAIN_GRID = (2, 4)
SSM_TRAIN_LAYERS, SSM_TRAIN_STEPS = 8, 2
SSM_TRAIN_BATCH = (8, 128)
SSM_HELD_LAYERS, SSM_HELD_STEPS = 4, 2
#: jamba-1.5-large-398b at the families phase's cut (one group of 8 layers, 4
#: of 16 experts, bf16) over (2, 4): one whole expert a position, the manual
#: MoE; its Adafactor train step (batch SSM_JAMBA_BATCH) at the same cut, the
#: largest that fits beside its placed state (30.3 GiB placed on an H100
#: 80GB, 73.3 GiB at its peak with 4 x 128 tokens). The Mamba layers' host
#: time grows with the tokens a sequence (each position's scan launches its
#: steps one by one), so the train step takes 64 tokens and the first decode
#: step's states follow a prompt of SSM_JAMBA_STATE_PROMPT, to keep the
#: phase near 150 s
SSM_JAMBA = "jamba-1.5-large-398b"
SSM_JAMBA_CUT = dict(n_layers=8, n_experts=4)
SSM_JAMBA_GRID = (2, 4)
SSM_JAMBA_PREFILL = (2, 512)
SSM_JAMBA_DECODE = 8
SSM_JAMBA_BATCH = (4, 64)
SSM_JAMBA_STATE_PROMPT = 64
#: the first decode step's recurrent states (the WKV state; Mamba's h and
#: conv window) against one device's, float32: within this share of each
#: layer's largest entry (FAM_WKV_TOL)
SSM_STATE_TOL = FAM_WKV_TOL


def ssm_state_err(got: dict, want: dict) -> float:
    """The largest distance between two snapshots' states, each layer group's
    relative to its largest entry (one device's)."""
    worst = 0.0
    for key, w in want.items():
        g = got[key].to(w.device)
        for i in range(w.shape[0]):
            scale = max(float(w[i].abs().max()), 1e-30)
            worst = max(worst, float((g[i] - w[i]).abs().max()) / scale)
    return worst


def ssm_gates(torch, label: str, got: dict, want: dict, err_state: float) -> dict:
    """The sharded runs against one device's on the same weights, each of
    ``got`` and ``want`` holding the forward of the prompt (``fwd``: every
    position) and the prefill's and decode steps' logits (``gen``) in
    float32 (``_f32``) and bf16 compute: float32 within LM_F32_TOL with
    top-1 >= LM_F32_TOP1; bf16, the one device's f32 run as the truth: the
    forward's top-1 share at least one device's less top1_slack, mean
    |logits - f32| at most LM_BF16_MEAN_SLACK times one device's for the
    forward and for prefill and decode; the first decode step's states
    within SSM_STATE_TOL."""
    row = {"first_step_state_rel_err": err_state}
    for key in ("fwd", "gen"):
        f32, one = got[key + "_f32"], want[key + "_f32"]
        check(bool(torch.isfinite(f32).all()) and tuple(f32.shape) == tuple(one.shape),
              f"{label}: {key} f32 logits {tuple(f32.shape)}")
        row[key] = {"f32": {"max_abs_err": float((f32 - one).abs().max()),
                            "top1": float((f32.argmax(-1) == one.argmax(-1)).float().mean())},
                    "bf16": ep_gates(torch, label, got[key], want, key)}
        check(torch.allclose(f32, one, rtol=LM_F32_TOL, atol=LM_F32_TOL)
              and row[key]["f32"]["top1"] >= LM_F32_TOP1, f"{label}: {key} float32 {row[key]}")
        mean = row[key]["bf16"]["mean_abs_vs_f32"]
        check(mean["sharded"] <= LM_BF16_MEAN_SLACK * mean["single"],
              f"{label}: {key} bf16 {row[key]['bf16']}")
    t1 = row["fwd"]["bf16"]["top1_vs_f32"]
    check(t1["sharded"] >= t1["single"] - t1["slack"], f"{label}: forward bf16 top-1 {t1}")
    check(err_state <= SSM_STATE_TOL, f"{label}: the first decode step's states {err_state} of "
                                      "their largest entries from one device's")
    return row


def ssm_rwkv_inference(torch) -> dict:
    """rwkv6-7b's bf16 weights at full width, SSM_INFER_LAYERS of 32 layers
    (64 heads of 64): the forward of the prompt SSM_PREFILL (the chunked
    WKV), its prefill and SSM_DECODE decode steps on one device in float32
    and bf16 compute, then over each of SSM_GRIDS (the 64 heads split, 16
    and 4 a position) held to them (ssm_gates: the first decode step's WKV
    state of every layer too); forward, prefill and decode-step ms, peak
    memory. No flash: no attention."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    from repro_torch.models import sharded as SHD

    cfg = dataclasses.replace(get_arch(SSM_RWKV), param_dtype="bfloat16",
                              n_layers=SSM_INFER_LAYERS)
    print(f"ssm parallel: cut: the rwkv6 inference runs at {SSM_INFER_LAYERS} of 32 layers",
          flush=True)
    rows_n, n = SSM_PREFILL
    check(n % cfg.rwkv_chunk == 0, "ssm parallel rwkv: the prefill takes the sequential WKV")
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    g = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (rows_n, n + SSM_DECODE), generator=g,
                           device="cuda")
    max_seq = n + SSM_DECODE
    layers = [f"l{i}" for i in range(len(cfg.layer_specs()))]
    prompt = {"tokens": tokens[:, :n]}
    want, single, launches = {}, {}, []

    def runs(forward, prefill, decode, snap):
        (fwd, fwd_ms) = ep_timed(torch, lambda: forward(prompt)[0])
        gen, pre_ms, step_ms, first = ep_generate(torch, prefill, decode, tokens, n,
                                                  SSM_DECODE, snap)
        return fwd, gen, dict(forward_ms=fwd_ms, prefill_ms=pre_ms, decode_step_ms=step_ms,
                              state=first)

    for dtype, tag in (("float32", "_f32"), ("bfloat16", "")):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        with torch.no_grad():
            (want["fwd" + tag], want["gen" + tag], single[dtype]), l_one = run_path(
                torch, "ssm_parallel_rwkv", lambda: runs(
                    lambda b: M.forward(params, c, b), lambda b: M.prefill(params, c, b, max_seq),
                    lambda ca, tok, t: M.decode_step(params, c, ca, tok, t),
                    lambda ca: {k: ca[k]["wkv"].clone() for k in layers}),
                expect={"flash_attention": 0})
        launches.append(l_one)
    out = {}
    for grid in SSM_GRIDS:
        mesh = ep_mesh(grid)
        torch.cuda.reset_peak_memory_stats()
        placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
        got, ms = {}, {}
        for dtype, tag in (("float32", "_f32"), ("bfloat16", "")):
            c = dataclasses.replace(cfg, compute_dtype=dtype)
            with torch.no_grad():
                (got["fwd" + tag], got["gen" + tag], ms[dtype]), l_tp = run_path(
                    torch, "ssm_parallel_rwkv", lambda: runs(
                        lambda b: SHD.sharded_forward(placed, c, b, mesh),
                        lambda b: SHD.sharded_prefill(placed, c, b, max_seq, mesh),
                        lambda ca, tok, t: SHD.sharded_decode_step(placed, c, ca, tok, t, mesh),
                        lambda ca: SHD.unplace({k: ca[k]["wkv"] for k in layers})),
                    expect={"flash_attention": 0})
            launches.append(l_tp)
        err = ssm_state_err(ms["float32"]["state"], single["float32"]["state"])
        label = f"ssm parallel {SSM_RWKV} {grid[0]}x{grid[1]}"
        row = ssm_gates(torch, label, got, want, err)
        row.update(grid=list(grid), heads_a_position=cfg.n_heads // grid[1],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   **{f"{k}_{d}": ms[d][k] for d in ms
                      for k in ("forward_ms", "prefill_ms", "decode_step_ms")},
                   **{f"{k}_{d}_single": single[d][k] for d in single
                      for k in ("forward_ms", "prefill_ms", "decode_step_ms")})
        print(f"{label}: forward and prefill {rows_n} x {n}, {SSM_DECODE} decode steps: "
              f"{json.dumps(row)}", flush=True)
        out[f"{grid[0]}x{grid[1]}"] = row
        del placed, got, ms
        torch.cuda.empty_cache()
    del params, want, single
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def ssm_rwkv_train(torch) -> dict:
    """make_sharded_train_step at rwkv6-7b's full width, SSM_TRAIN_LAYERS
    layers, over SSM_TRAIN_GRID (AdamW, ZeRO-1 over 'data'; batch
    SSM_TRAIN_BATCH, f32 parameters, bf16 compute, remat, the chunked WKV):
    SSM_TRAIN_STEPS steps timed, the first step's payloads tallied on the
    card and equal to the same step's meta count, peak memory;
    make_train_step at the same depth beside it. No flash."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.models import sharded as SHD
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import make_sharded_train_step, make_train_step, train_state_init

    cfg = dataclasses.replace(get_arch(SSM_RWKV), n_layers=SSM_TRAIN_LAYERS)
    print(f"ssm parallel: cut: the rwkv6 train step at {SSM_TRAIN_LAYERS} of 32 layers",
          flush=True)
    mesh = ep_mesh(SSM_TRAIN_GRID)
    opt, lr = adamw(), warmup_cosine(3e-4, 20, SSM_TRAIN_STEPS + 1)
    stream = SyntheticTokenStream(cfg.vocab_size, SSM_TRAIN_BATCH[1], SSM_TRAIN_BATCH[0], seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_state_init(torch.Generator(device="cuda").manual_seed(0), cfg, opt[0])
    placed = SHD.place_train_state(state, mesh)
    del state
    torch.cuda.empty_cache()
    place_s = time.perf_counter() - t0
    step = make_sharded_train_step(cfg, opt, lr, mesh)
    payload = {}
    placed, rows, l_tp = ep_train_steps(torch, step, placed, stream, SSM_TRAIN_STEPS, mesh,
                                        "ssm_parallel_rwkv_train", 0, {}, payload)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del placed
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    meta_payload = ep_meta_payloads(torch, cfg, opt, lr, stream.batch(0), SSM_TRAIN_GRID)
    meta_s = time.perf_counter() - t0
    check(meta_payload == payload, f"ssm parallel rwkv train: the card's payloads {payload} "
                                   f"against the meta count's {meta_payload}")
    torch.cuda.reset_peak_memory_stats()
    state, single_rows, l_single = par_train_run(
        torch, cfg, make_train_step(cfg, opt, lr), stream, "ssm_parallel_rwkv_train", 0,
        SSM_TRAIN_STEPS)
    single_peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    torch.cuda.empty_cache()
    row = dict(arch=cfg.name, layers=cfg.n_layers, grid=list(SSM_TRAIN_GRID),
               steps=SSM_TRAIN_STEPS, batch=list(SSM_TRAIN_BATCH), sharded=rows,
               single_device=single_rows, place_s=place_s,
               step_ms_sharded=par_steady_ms(rows), step_ms_single=par_steady_ms(single_rows),
               payload_first_step=payload, meta_count_s=meta_s, peak_gib=peak,
               peak_gib_single=single_peak)
    print(f"ssm parallel rwkv train: {json.dumps(row)}", flush=True)
    row["launches"] = [l_tp, l_single]
    return row


def ssm_rwkv_held(torch) -> dict:
    """rwkv6-7b at full width, SSM_HELD_LAYERS layers, float32, over
    SSM_TRAIN_GRID against make_train_step (held_check)."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(SSM_RWKV), n_layers=SSM_HELD_LAYERS,
                              compute_dtype="float32")
    print(f"ssm parallel: cut: the rwkv6 held check at {SSM_HELD_LAYERS} of 32 layers, float32",
          flush=True)
    return held_check(torch, cfg, SSM_TRAIN_GRID, SSM_HELD_STEPS, "ssm_parallel_rwkv_held",
                      "ssm parallel rwkv held")


def ssm_mamba_layer_ms(torch, cfg, params, grid) -> dict:
    """One Mamba layer (group 0's l0) over 1 x SSM_JAMBA_PREFILL[1] tokens in
    bf16: sharded over ``grid``'s row of 'model' positions beside one
    device's mamba_seq on the same input, CUDA events."""
    from repro_torch.models import model as M
    from repro_torch.models import sharded as SHD
    from repro_torch.models import ssm as S

    mesh = ep_mesh(grid)
    p0 = M._at(params["blocks"], 0)["l0"]["mamba"]
    placed = SHD.place({"mamba": p0}, SHD.param_specs({"mamba": p0}, mesh), mesh)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((1, SSM_JAMBA_PREFILL[1], cfg.d_model), generator=gen,
                    device="cuda").to(cfg.cdtype)
    row = SHD._Row(cfg, mesh, {"data": 0}, "auto")
    with torch.no_grad():
        sharded_ms = timed(torch, lambda: SHD._mamba(row, placed["mamba"], x), 2)
        single_ms = timed(torch, lambda: S.mamba_seq(
            p0, x, d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv,
            expand=cfg.mamba_expand), 2)
    del placed
    return {"tokens": SSM_JAMBA_PREFILL[1], "sharded_ms": sharded_ms,
            "single_ms": single_ms, "positions": grid[1]}


def ssm_jamba(torch) -> dict:
    """jamba-1.5-large-398b at full width cut to one group of 8 layers and 4
    experts (bf16, ~33 GB), the manual MoE over SSM_JAMBA_GRID: the
    one-device bf16 and f32-compute runs first, then the sharded forward,
    prefill SSM_JAMBA_PREFILL and SSM_JAMBA_DECODE decode steps held to them
    (ep_inference: the routing pinned to one device's, the phase-18 gates;
    exactly one flash launch the attention layer a data block a position
    with heads; each new flash shape's first call held against the plain
    version); the first decode step's Mamba states (h and the conv window)
    of l0 and l1, which no MoE layer reaches, after a prompt of
    SSM_JAMBA_STATE_PROMPT, against one device's in float32 (the flash
    shapes of those prefills held against the plain version too); one
    Mamba layer's ms sharded and on one device."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import sharded as SHD

    cfg = fam_cut(get_arch(SSM_JAMBA), **SSM_JAMBA_CUT)
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    rows_n, n = SSM_JAMBA_PREFILL
    grid = SSM_JAMBA_GRID
    g = torch.Generator(device="cuda").manual_seed(8)
    tokens = torch.randint(0, cfg.vocab_size, (rows_n, n + SSM_JAMBA_DECODE), generator=g,
                           device="cuda")
    want = ep_single(torch, cfg, params, grid[0], tokens, n, SSM_JAMBA_DECODE,
                     "ssm_parallel_jamba_single")
    launches = want.pop("launches")
    manual = dataclasses.replace(cfg, moe_impl="manual")
    label = f"ssm parallel {SSM_JAMBA} {grid[0]}x{grid[1]}"
    row = ep_inference(torch, manual, params, grid, rows_n, n, SSM_JAMBA_DECODE, label, want,
                       "ssm_parallel_jamba")
    launches += row.pop("launches")
    check(row["experts"] == "experts", f"{label}: split {row['experts']}")
    del want
    # the first decode step's states of the layers before the first MoE layer
    c32 = dataclasses.replace(manual, compute_dtype="float32")
    mesh = ep_mesh(grid)
    placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
    n_state = SSM_JAMBA_STATE_PROMPT
    max_seq = -(-(n_state + 1) // grid[1]) * grid[1]
    early = ("l0", "l1")
    flash = attention_layers(cfg)

    def states(prefill, decode, snap):
        return ep_generate(torch, prefill, decode, tokens, n_state, 1, snap)[3]

    chunked = dataclasses.replace(c32, moe_impl="gspmd", moe_dispatch_chunks=grid[0])
    seen: dict = {}
    restore = capture_shapes(ops, seen)
    try:
        with torch.no_grad():
            one, l_one = run_path(torch, "ssm_parallel_jamba_single", lambda: states(
                lambda b: M.prefill(params, chunked, b, max_seq),
                lambda ca, tok, t: M.decode_step(params, chunked, ca, tok, t),
                lambda ca: {f"{k}/{s}": ca[k][s].clone() for k in early for s in ("h", "conv")}),
                expect={"flash_attention": flash})
            mine, l_tp = run_path(torch, "ssm_parallel_jamba", lambda: states(
                lambda b: SHD.sharded_prefill(placed, c32, b, max_seq, mesh),
                lambda ca, tok, t: SHD.sharded_decode_step(placed, c32, ca, tok, t, mesh),
                lambda ca: {f"{k}/{s}": v for k in early for s, v in SHD.unplace(
                    {s: ca[k][s] for s in ("h", "conv")}).items()}),
                expect={"flash_attention": flash * grid[0] * ep_active(cfg, grid[1])})
    finally:
        restore()
    launches += [l_one, l_tp]
    row["flash_states"] = fam_flash_shapes(torch, seen, f"{label} states")
    err = ssm_state_err(mine, one)
    check(err <= SSM_STATE_TOL, f"{label}: the first decode step's Mamba states {err} of "
                                "their largest entries from one device's")
    del placed, one, mine
    torch.cuda.empty_cache()
    row["first_step_state_rel_err"] = err
    row["mamba_layer"] = ssm_mamba_layer_ms(torch, cfg, params, grid)
    row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label}: first decode step's Mamba states {err:.3e} of their largest; one Mamba "
          f"layer {json.dumps(row['mamba_layer'])}", flush=True)
    del params
    torch.cuda.empty_cache()
    row["launches"] = launches
    return row


def ssm_jamba_train(torch) -> dict:
    """One Adafactor step of make_sharded_train_step at jamba's full width
    and SSM_JAMBA_CUT over SSM_JAMBA_GRID (one whole expert a position, the
    manual MoE; batch SSM_JAMBA_BATCH, bf16 weights and compute, remat):
    its ms, loss, grad norm and aux, exactly two flash launches a data
    block a position with heads (forward and recompute), peak memory; the
    step's flash shape held against the plain version."""
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.models import model as M
    from repro_torch.models import sharded as SHD
    from repro_torch.optim import adafactor, warmup_cosine
    from repro_torch.train import TrainState, make_sharded_train_step

    grid, (rows_n, seq) = SSM_JAMBA_GRID, SSM_JAMBA_BATCH
    cfg = fam_cut(get_arch(SSM_JAMBA), **SSM_JAMBA_CUT, moe_impl="manual")
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    count = sum(t.numel() for t in M.tree_leaves(params))
    mesh = ep_mesh(grid)
    opt, lr = adafactor(), warmup_cosine(3e-4, 2, 10)
    placed = SHD.place_train_state(TrainState(params=params, opt_state=opt[0](params),
                                              step=torch.zeros((), dtype=torch.int32)), mesh)
    del params
    torch.cuda.empty_cache()
    placed_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    stream = SyntheticTokenStream(cfg.vocab_size, seq, rows_n, seed=3)
    step = make_sharded_train_step(cfg, opt, lr, mesh)
    flash = (1 + cfg.remat) * attention_layers(cfg) * grid[0] * ep_active(cfg, grid[1])
    seen = {}
    placed, rows, l_train = ep_train_steps(torch, step, placed, stream, 1, mesh,
                                           "ssm_parallel_jamba_train", flash, seen)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del placed
    torch.cuda.empty_cache()
    row = dict(arch=cfg.name, layers=cfg.n_layers, experts=cfg.n_experts, params=count,
               grid=list(grid), batch=[rows_n, seq], train=rows, placed_gib=placed_gib,
               peak_gib=peak, flash_per_step=flash,
               flash=fam_flash_shapes(torch, seen, "ssm parallel jamba train"))
    print(f"ssm parallel jamba train: {json.dumps({k: v for k, v in row.items() if k != 'flash'})}",
          flush=True)
    row["launches"] = [l_train]
    return row


def phase_ssm_parallel(torch) -> dict:
    """Phase 19: RWKV6 and the hybrid Mamba stack over 'model' on grids of
    views of the card: rwkv6-7b's bf16 prefill and decode at full width and
    depth over (2, 4) and (1, 16), its sharded train step (8 layers, AdamW,
    ZeRO-1) beside make_train_step with the payloads held to the meta
    count, the f32 held check at 4 layers; jamba at the families phase's
    cut over (2, 4) (Mamba, attention and the manual MoE together) and its
    Adafactor train step; each model freed before the next."""
    check(not torch.backends.cuda.matmul.allow_tf32, "ssm parallel: TF32 matmuls are on")
    rows = {}
    for name, fn in (("rwkv", ssm_rwkv_inference), ("rwkv_train", ssm_rwkv_train),
                     ("rwkv_held", ssm_rwkv_held), ("jamba", ssm_jamba),
                     ("jamba_train", ssm_jamba_train)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows[name] = fn(torch)
        torch.cuda.empty_cache()
        rows[name]["seconds"] = time.perf_counter() - t0
        rows[name]["peak_gib_phase"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"ssm parallel {name}: {rows[name]['seconds']:.2f} s, peak "
              f"{rows[name]['peak_gib_phase']:.2f} GiB", flush=True)
    rows["launches"] = [c for r in ("rwkv", "rwkv_train", "rwkv_held", "jamba", "jamba_train")
                        for c in rows[r]["launches"]]
    return rows


#: the enc-dec and context-parallel phase: whisper-medium over 'model' on
#: grids of views of the card, its cross cache along the frames where
#: |model| divides the 1500 frames ((2, 4)) and along head_dim where it does
#: not ((1, 16)); granite-3-2b's TaCo decode of one row over every position
#: of a grid, its K/V sequence over the data axes and 'model'
ED_ARCH = "whisper-medium"
ED_GRIDS = ((2, 4), (1, 16))
ED_PREFILL = (8, 256)  # rows x decoder prompt, over the 1500 frames
ED_DECODE = 16
ED_FRAMES_SCALE = 0.1  # the seeded stub frames' scale, as the families phase draws them
#: its train step over (2, 4) with AdamW and ZeRO-1 at full depth, f32
#: parameters, bf16 compute, remat
ED_TRAIN_GRID = (2, 4)
ED_TRAIN_STEPS = 2
ED_TRAIN_BATCH = (8, 128)
ED_HELD_LAYERS, ED_HELD_STEPS = 4, 2  # 4 encoder + 4 decoder layers, float32
CP_ARCH = "granite-3-2b"
CP_GRIDS = ((2, 4), (1, 16))
CP_PROMPT, CP_SLOTS = 32704, 32768
CP_DECODE = 16
#: the share of the positions that must hold a selected slot, on average
#: over the TaCo layers and steps
CP_HOLDING = 0.5
#: the share of each retrieved slot set (C slots a layer, step and head) the
#: sharded float32 run must share with one device's
CP_SLOT_OVERLAP = 0.99


class ED_Stream:
    """A token stream whose batches carry seeded stub frames (rows, frames,
    d_model) float32, ED_FRAMES_SCALE, for an audio config."""

    def __init__(self, cfg, rows: int, seq: int, seed: int):
        import numpy as np

        from repro_torch.data.tokens import SyntheticTokenStream

        self.np, self.cfg, self.seed = np, cfg, seed
        self.tokens = SyntheticTokenStream(cfg.vocab_size, seq, rows, seed=seed)

    def batch(self, step: int) -> dict:
        out = self.tokens.batch(step)
        rng = self.np.random.default_rng(1000 * self.seed + step)
        out["frames"] = (rng.standard_normal((out["tokens"].shape[0], self.cfg.frontend_len,
                                              self.cfg.d_model)) * ED_FRAMES_SCALE).astype(
            self.np.float32)
        return out


def ed_generate(torch, prefill, decode, batch: dict, n: int, steps: int, path: str,
                prefill_flash: int, seen: dict | None = None):
    """Prefill of ``batch`` (its first n tokens and its frames) as one path
    run with exactly ``prefill_flash`` flash launches (with ``seen``, the
    first call of each flash shape captured), then ``steps``
    teacher-forced decode steps as another with none: (the last prompt
    position's logits and each step's, stacked (steps + 1, B, V); the
    cache; prefill ms; the median decode-step ms; the launches)."""
    from repro_torch.kernels import ops

    tokens = batch["tokens"]
    restore = capture_shapes(ops, seen) if seen is not None else lambda: None
    try:
        ((logits, cache), pre_ms), l_pre = run_path(
            torch, path, lambda: ep_timed(torch, lambda: prefill(
                {"tokens": tokens[:, :n], "frames": batch["frames"]})),
            expect={"flash_attention": prefill_flash})
    finally:
        restore()
    out, step_ms = [logits[:, 0]], []

    def run():
        nonlocal cache
        for t in range(n, n + steps):
            (lg, cache), ms = ep_timed(torch, lambda: decode(cache, tokens[:, t:t + 1], t))
            out.append(lg[:, 0])
            step_ms.append(ms)

    _, l_dec = run_path(torch, path + "_decode", run, expect={"flash_attention": 0})
    return (torch.stack(out), cache, pre_ms, sorted(step_ms)[len(step_ms) // 2],
            [l_pre, l_dec])


def ed_gates(torch, label: str, got: dict, want: dict) -> dict:
    """The sharded runs' logits against one device's: float32 within
    LM_F32_TOL with top-1 >= LM_F32_TOP1; bf16, the lm phase's top-1 and
    distance gates as phases 18 and 19 hold them (ep_gates): the top-1
    share with one device's f32 run at least one device's bf16 share less
    top1_slack, and mean |logits - one device's f32 logits| at most
    LM_BF16_MEAN_SLACK times one device's bf16 run's."""
    f32, one = got["float32"], want["float32"]
    check(bool(torch.isfinite(f32).all()) and tuple(f32.shape) == tuple(one.shape),
          f"{label}: f32 logits {tuple(f32.shape)}")
    row = {"f32": {"max_abs_err": float((f32 - one).abs().max()),
                   "top1": float((f32.argmax(-1) == one.argmax(-1)).float().mean())}}
    check(torch.allclose(f32, one, rtol=LM_F32_TOL, atol=LM_F32_TOL)
          and row["f32"]["top1"] >= LM_F32_TOP1, f"{label}: float32 {row['f32']}")
    row["bf16"] = ep_gates(torch, label, got["bfloat16"],
                           {"gen": want["bfloat16"], "gen_f32": one}, "gen")
    t1, mean = row["bf16"]["top1_vs_f32"], row["bf16"]["mean_abs_vs_f32"]
    check(t1["sharded"] >= t1["single"] - t1["slack"]
          and mean["sharded"] <= LM_BF16_MEAN_SLACK * mean["single"], f"{label}: bf16 "
                                                                       f"{row['bf16']}")
    return row


def ed_inference(torch) -> dict:
    """whisper-medium's bf16 weights at full width and depth (24 + 24
    layers): prefill of ED_PREFILL tokens over 1500 seeded frames and
    ED_DECODE teacher-forced decode steps on one device in float32 and bf16
    compute, then over each of ED_GRIDS held to them (ed_gates); the cross
    cache placed along the frames over (2, 4) and along head_dim over (1,
    16); exactly one flash launch an encoder, decoder and cross layer a
    data block a position with heads a prefill and none in decode; each new
    flash shape's first call held against the plain version; prefill and
    decode-step ms beside one device's."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.mesh import P
    from repro_torch.models import model as M
    from repro_torch.models import sharded as SHD

    cfg = dataclasses.replace(get_arch(ED_ARCH), param_dtype="bfloat16")
    rows_n, n = ED_PREFILL
    max_seq = n + ED_DECODE
    params, count = fam_params(torch, cfg, "enc dec")
    g = torch.Generator(device="cuda").manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows_n, max_seq), generator=g,
                                     device="cuda"),
             "frames": torch.randn((rows_n, cfg.frontend_len, cfg.d_model), generator=g,
                                   device="cuda") * ED_FRAMES_SCALE}
    layers = attention_layers(cfg)
    want, single, launches = {}, {}, []
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        with torch.no_grad():
            want[dtype], _, pre_ms, step_ms, ls = ed_generate(
                torch, lambda b: M.prefill(params, c, b, max_seq),
                lambda ca, tok, t: M.decode_step(params, c, ca, tok, t), batch, n, ED_DECODE,
                "enc_dec_single", layers)
        single[dtype] = dict(prefill_ms=pre_ms, decode_step_ms=step_ms)
        launches += ls
    out, flash_rows = {}, []
    for grid in ED_GRIDS:
        mesh = ep_mesh(grid)
        torch.cuda.reset_peak_memory_stats()
        placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
        along = "frames" if cfg.frontend_len % grid[1] == 0 else "head_dim"
        label = f"enc dec {ED_ARCH} {grid[0]}x{grid[1]}"
        got, ms = {}, {}
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, compute_dtype=dtype)
            seen = {}
            with torch.no_grad():
                got[dtype], cache, pre_ms, step_ms, ls = ed_generate(
                    torch, lambda b: SHD.sharded_prefill(placed, c, b, max_seq, mesh),
                    lambda ca, tok, t: SHD.sharded_decode_step(placed, c, ca, tok, t, mesh),
                    batch, n, ED_DECODE, "enc_dec_prefill",
                    layers * grid[0] * ep_active(cfg, grid[1]), seen)
            spec = cache["l0"]["cross_k"].spec
            check(spec == (P(None, "data", "model", None, None) if along == "frames" else
                           P(None, "data", None, None, "model")),
                  f"{label}: the cross cache placed {spec}, not along the {along}")
            ms[dtype] = dict(prefill_ms=pre_ms, decode_step_ms=step_ms)
            launches += ls
            del cache
            check(len(seen) == 3, f"{label} {dtype}: flash shapes {sorted(seen)}")
            flash_rows += fam_flash_shapes(torch, seen, f"{label} {dtype}")
            del seen
        row = ed_gates(torch, label, got, want)
        row.update(grid=list(grid), cross_cache_along=along,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   **{f"{k}_{d}": ms[d][k] for d in ms for k in ("prefill_ms", "decode_step_ms")},
                   **{f"{k}_{d}_single": single[d][k] for d in single
                      for k in ("prefill_ms", "decode_step_ms")})
        print(f"{label}: prefill {rows_n} x {n} over {cfg.frontend_len} frames, {ED_DECODE} "
              f"decode steps: {json.dumps(row)}", flush=True)
        out[f"{grid[0]}x{grid[1]}"] = row
        del placed, got
        torch.cuda.empty_cache()
    del params, want
    torch.cuda.empty_cache()
    out.update(params=count, flash=flash_rows, launches=launches)
    return out


def ed_train(torch) -> dict:
    """make_sharded_train_step at whisper-medium's full width and depth
    over ED_TRAIN_GRID (AdamW, ZeRO-1 over 'data'; batch ED_TRAIN_BATCH
    over 1500 frames, f32 parameters, bf16 compute, remat): ED_TRAIN_STEPS
    steps timed, exactly two flash launches an encoder, decoder and cross
    layer a data block a position a step, the first step's payloads tallied
    on the card and equal to the same step's meta count, peak memory;
    make_train_step beside it; each new flash shape's first call held
    against the plain version."""
    from repro_torch.configs import get_arch
    from repro_torch.models import sharded as SHD
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import make_sharded_train_step, make_train_step, train_state_init

    cfg = get_arch(ED_ARCH)
    check(cfg.remat and cfg.compute_dtype == "bfloat16", "enc dec: the config moved")
    mesh = ep_mesh(ED_TRAIN_GRID)
    opt, lr = adamw(), warmup_cosine(3e-4, 20, ED_TRAIN_STEPS + 1)
    stream = ED_Stream(cfg, *ED_TRAIN_BATCH, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_state_init(torch.Generator(device="cuda").manual_seed(0), cfg, opt[0])
    placed = SHD.place_train_state(state, mesh)
    del state
    torch.cuda.empty_cache()
    place_s = time.perf_counter() - t0
    step = make_sharded_train_step(cfg, opt, lr, mesh)
    flash = 2 * attention_layers(cfg) * ED_TRAIN_GRID[0] * ep_active(cfg, ED_TRAIN_GRID[1])
    payload, seen = {}, {}
    placed, rows, l_tp = ep_train_steps(torch, step, placed, stream, ED_TRAIN_STEPS, mesh,
                                        "enc_dec_train", flash, seen, payload)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del placed
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    meta_payload = ep_meta_payloads(torch, cfg, opt, lr, stream.batch(0), ED_TRAIN_GRID)
    meta_s = time.perf_counter() - t0
    check(meta_payload == payload, f"enc dec train: the card's payloads {payload} against the "
                                   f"meta count's {meta_payload}")
    check(len(seen) == 3, f"enc dec train: flash shapes {sorted(seen)}")
    flash_rows = fam_flash_shapes(torch, seen, "enc dec train")
    del seen
    torch.cuda.reset_peak_memory_stats()
    state, single_rows, l_single = par_train_run(
        torch, cfg, make_train_step(cfg, opt, lr), stream, "enc_dec_train",
        2 * attention_layers(cfg) * ED_TRAIN_STEPS, ED_TRAIN_STEPS)
    single_peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    torch.cuda.empty_cache()
    row = dict(arch=cfg.name, grid=list(ED_TRAIN_GRID), steps=ED_TRAIN_STEPS,
               batch=list(ED_TRAIN_BATCH), frames=cfg.frontend_len, sharded=rows,
               single_device=single_rows, place_s=place_s,
               step_ms_sharded=par_steady_ms(rows), step_ms_single=par_steady_ms(single_rows),
               flash_per_step=flash, payload_first_step=payload, meta_count_s=meta_s,
               peak_gib=peak, peak_gib_single=single_peak, flash=flash_rows)
    print(f"enc dec train: {json.dumps({k: v for k, v in row.items() if k != 'flash'})}",
          flush=True)
    row["launches"] = [l_tp, l_single]
    return row


def ed_held(torch) -> dict:
    """whisper-medium at full width, ED_HELD_LAYERS encoder and decoder
    layers, float32, over ED_TRAIN_GRID against make_train_step (held_check,
    batches with seeded frames)."""
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(get_arch(ED_ARCH), n_layers=ED_HELD_LAYERS,
                              encoder_layers=ED_HELD_LAYERS, compute_dtype="float32")
    print(f"enc dec: cut: the held check at {ED_HELD_LAYERS} + {ED_HELD_LAYERS} of 24 + 24 "
          "layers, float32", flush=True)
    return held_check(torch, cfg, ED_TRAIN_GRID, ED_HELD_STEPS, "enc_dec_held", "enc dec held",
                      stream=ED_Stream(cfg, 8, 128, seed=1), shapes=3,
                      noise=("['wk']['b']",))


def cp_selections(TA, seen: dict):
    """Wrap taco_attention.select_slots so that each call's own selection
    lands under ``seen["run"]``; while ``seen["replay"]`` holds a list of
    selections, each call returns the next of them instead (a one-device
    run pinned to the sharded run's slots, as routing_spy pins the MoE's
    routing). Returns a function that puts the original back."""
    import torch

    real = TA.select_slots

    def spy(q, state, pos, rc, s_max):
        out = real(q, state, pos, rc, s_max)
        seen.setdefault(seen["run"], []).append(out[0])
        if seen.get("replay"):
            top = seen["replay"].pop(0).to(out[0].device)
            return top, (torch.arange(s_max, device=top.device) <= pos)[top]
        return out

    TA.select_slots = spy
    return lambda: setattr(TA, "select_slots", real)


def cp_compare(torch, mine: list, theirs: list, size: int, positions: int) -> dict:
    """Two runs' retrieved slot sets (one (B, Kv, G, C) tensor a TaCo layer
    and step each): the share of sets equal, the share of each set's slots
    the other holds too, and the share of the ``positions`` blocks of
    ``size`` slots that hold a selected slot (mean and least over the
    calls)."""
    a = torch.stack([s.sort(-1).values for s in mine]).flatten(0, -2)
    b = torch.stack([s.sort(-1).values for s in theirs]).flatten(0, -2)
    at = torch.searchsorted(b, a).clamp_max(b.shape[-1] - 1)
    holding = [len(torch.unique(s // size)) / positions for s in mine]
    return dict(slot_sets_equal=float((a == b).all(-1).float().mean()),
                slots_shared=float((b.gather(-1, at) == a).float().mean()),
                positions_holding_mean=sum(holding) / len(holding),
                positions_holding_min=min(holding))


def cp_inference(torch) -> dict:
    """granite-3-2b at full width and depth with TaCo retrieval attention
    (the default RetrievalConfig), one row: prefill of CP_PROMPT tokens into
    a CP_SLOTS-slot cache on one device in float32 and bf16 compute, the
    cache placed context-parallel (the K/V sequence over ('data', 'model'):
    4,096 slots a position over (2, 4), 2,048 over (1, 16)) and CP_DECODE
    teacher-forced TaCo decode steps sharded; then one device's decode from
    the same cache with its slot selection pinned to the sharded run's
    (cp_selections: the two runs' queries differ by rounding, and a
    near-tie at rank C selects another slot). float32 within LM_F32_TOL
    with top-1 >= LM_F32_TOP1 against the pinned run; each retrieved slot
    set against the one the pinned run selects on its own: at least
    CP_SLOT_OVERLAP of its slots shared (the share of sets equal printed);
    bf16, the lm phase's top-1 and distance gates (ed_gates) against the
    pinned runs; at least CP_HOLDING of the positions holding a selected
    slot; decode-step ms beside one device's (its first pinned run: the
    pinned run also makes its own selection)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    from repro_torch.models import sharded as SHD
    from repro_torch.models import taco_attention as TA

    cfg = dataclasses.replace(get_arch(CP_ARCH), attention_kind="taco")
    rc = cfg.retrieval
    params, count = fam_params(torch, cfg, "context parallel")
    g = torch.Generator(device="cuda").manual_seed(9)
    tokens = torch.randint(0, cfg.vocab_size, (1, CP_PROMPT + CP_DECODE), generator=g,
                           device="cuda")
    first, single, caches, launches = {}, {}, {}, []
    seen = {"run": None}
    restore = cp_selections(TA, seen)

    def one_device(c, replay):
        """One device's decode from a copy of the prefilled cache pinned to
        ``replay``'s slots: (logits, median step ms, its own selections)."""
        dtype = c.compute_dtype
        cache = M.map_tree(lambda t: t.clone(), caches[dtype])
        seen["run"], seen["replay"] = "one", list(replay)
        with torch.no_grad():
            (gen, ms), l_dec = run_path(
                torch, "context_parallel_decode", lambda: cp_decode(
                    torch, lambda ca, tok, t: M.decode_step(params, c, ca, tok, t), cache,
                    tokens, first[dtype]), expect={"flash_attention": 0})
        check(not seen["replay"], "context parallel: the pinned run left selections unused")
        launches.append(l_dec)
        return gen, ms, seen.pop("one")

    try:
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, compute_dtype=dtype)
            with torch.no_grad():
                ((first[dtype], caches[dtype]), pre_ms), l_pre = run_path(
                    torch, "context_parallel_prefill", lambda: ep_timed(torch, lambda: M.prefill(
                        params, c, {"tokens": tokens[:, :CP_PROMPT]}, CP_SLOTS)),
                    expect={"flash_attention": c.n_layers})
            launches.append(l_pre)
            single[dtype] = dict(prefill_ms=pre_ms)
        out = {}
        for grid in CP_GRIDS:
            mesh = ep_mesh(grid)
            positions = grid[0] * grid[1]
            size = CP_SLOTS // positions
            torch.cuda.reset_peak_memory_stats()
            placed = SHD.place(params, SHD.param_specs(params, mesh), mesh)
            label = f"context parallel {CP_ARCH} {grid[0]}x{grid[1]}"
            got, want, ms, row = {}, {}, {}, {}
            for dtype in ("float32", "bfloat16"):
                c = dataclasses.replace(cfg, compute_dtype=dtype)
                cache = SHD.place(caches[dtype], SHD.cache_specs(caches[dtype], mesh, ("data",)),
                                  mesh)
                k = cache["l0"]["k"]
                check(k.spec[2] == ("data", "model") and len(k.blocks) == positions,
                      f"{label}: the K/V placed {k.spec} in {len(k.blocks)} blocks")
                seen["run"], seen["replay"] = "sharded", None
                with torch.no_grad():
                    (got[dtype], ms[dtype]), l_dec = run_path(
                        torch, "context_parallel_decode", lambda: cp_decode(
                            torch, lambda ca, tok, t: SHD.sharded_decode_step(
                                placed, c, ca, tok, t, mesh), cache, tokens, first[dtype]),
                        expect={"flash_attention": 0})
                launches.append(l_dec)
                del cache
                mine = seen.pop("sharded")
                want[dtype], one_ms, own = one_device(c, replay=mine)
                single[dtype].setdefault("decode_step_ms", one_ms)
                check(len(mine) == len(own) == c.n_layers * CP_DECODE
                      and mine[0].shape[-1] == rc.n_retrieve,
                      f"{label}: {len(mine)} slot selections of {tuple(mine[0].shape)}")
                row[dtype] = cp_compare(torch, mine, own, size, positions)
                check(row[dtype]["positions_holding_mean"] >= CP_HOLDING,
                      f"{label} {dtype}: positions holding a selected slot {row[dtype]}")
                if dtype == "float32":
                    check(row[dtype]["slots_shared"] >= CP_SLOT_OVERLAP,
                          f"{label}: the retrieved slots against one device's {row[dtype]}")
                del mine, own
            row.update(ed_gates(torch, label, got, want), grid=list(grid),
                       slots_a_position=size,
                       decode_step_ms_float32=ms["float32"],
                       decode_step_ms_bfloat16=ms["bfloat16"],
                       decode_step_ms_float32_single=single["float32"]["decode_step_ms"],
                       decode_step_ms_bfloat16_single=single["bfloat16"]["decode_step_ms"],
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            print(f"{label}: one row, {CP_PROMPT} prompt tokens prefilled on one device into "
                  f"{CP_SLOTS} slots, {CP_DECODE} TaCo decode steps (C = {rc.n_retrieve}, "
                  f"{rc.recent_window} recent): {json.dumps(row)}", flush=True)
            out[f"{grid[0]}x{grid[1]}"] = row
            del placed, got, want
            torch.cuda.empty_cache()
    finally:
        restore()
    del params, caches
    torch.cuda.empty_cache()
    out.update(params=count, prefill_ms_single={d: single[d]["prefill_ms"] for d in single},
               retrieval=dataclasses.asdict(rc), launches=launches)
    return out


def cp_decode(torch, decode, cache, tokens, first):
    """CP_DECODE teacher-forced decode steps from ``cache`` after the
    CP_PROMPT-token prompt: (``first``, the prefill's last logits, and each
    step's, stacked (steps + 1, 1, V); the median step ms)."""
    out, step_ms = [first[:, 0]], []
    for t in range(CP_PROMPT, CP_PROMPT + CP_DECODE):
        (lg, cache), ms = ep_timed(torch, lambda: decode(cache, tokens[:, t:t + 1], t))
        out.append(lg[:, 0])
        step_ms.append(ms)
    return torch.stack(out), sorted(step_ms)[len(step_ms) // 2]


def phase_enc_dec_context_parallel(torch) -> dict:
    """Phase 20: whisper-medium's encoder-decoder over 'model' (prefill and
    decode over (2, 4) and (1, 16), the train step over (2, 4) beside
    make_train_step, the f32 held check at 4 + 4 layers) and granite-3-2b's
    context-parallel TaCo decode of one row over (2, 4) and (1, 16); each
    model freed before the next."""
    check(not torch.backends.cuda.matmul.allow_tf32, "enc dec: TF32 matmuls are on")
    rows = {}
    for name, fn in (("whisper", ed_inference), ("whisper_train", ed_train),
                     ("whisper_held", ed_held), ("taco", cp_inference)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows[name] = fn(torch)
        torch.cuda.empty_cache()
        rows[name]["seconds"] = time.perf_counter() - t0
        rows[name]["peak_gib_phase"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"enc dec context parallel {name}: {rows[name]['seconds']:.2f} s, peak "
              f"{rows[name]['peak_gib_phase']:.2f} GiB", flush=True)
    rows["launches"] = [c for r in ("whisper", "whisper_train", "whisper_held", "taco")
                        for c in rows[r]["launches"]]
    return rows


def brute_force_top10(torch, corpus, queries):
    from repro_torch.utils import pairwise_sq_dists

    gt = []
    for lo in range(0, queries.shape[0], 100):
        d = pairwise_sq_dists(queries[lo:lo + 100], corpus)
        gt.append(torch.topk(d, 10, dim=1, largest=False).indices)
    return torch.cat(gt).cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="corpus size (cut it for a quick first check of a new kernel)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root / "src"))
    import numpy as np

    from repro_torch.data import gmm_dataset, make_queries
    from repro_torch.kernels import cuda

    # 1. device
    line = card_line()
    print(f"device: {line}", flush=True)
    # 2. build
    t0 = time.perf_counter()
    reports = cuda.build_all()
    build_kernels_s = time.perf_counter() - t0
    print(f"build: kernels in {build_kernels_s:.2f} s", flush=True)
    ptxas = {}
    for name, log in reports.items():
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln or "wgmma" in ln
                       or "Compiling entry" in ln]
        for ln in ptxas[name]:
            print(f"build: {name}: {ln}", flush=True)

    t0 = time.perf_counter()
    full = gmm_dataset(args.n + QUERIES, 128, seed=0)
    corpus_np, queries_np = make_queries(full, QUERIES)
    del full
    print(f"data: {corpus_np.shape} corpus, {queries_np.shape} queries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    corpus = torch.as_tensor(corpus_np).cuda()
    queries = torch.as_tensor(queries_np).cuda()
    gt = brute_force_top10(torch, corpus, queries)

    phase_seconds = {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {phase_seconds[name]:.2f} s", flush=True)
        return out

    # 3. ANN kernels against plain versions, 3b. the autotuner, 4. flash attention
    kernels = phase("kernels", phase_kernels, torch, corpus, queries, rng)
    del corpus
    torch.cuda.empty_cache()
    tune_dir = tempfile.TemporaryDirectory()
    tune = phase("autotune", phase_autotune, torch, corpus_np.shape[0],
                 str(Path(tune_dir.name) / "winners.json"))
    tune["path"] = str(Path(tune_dir.name) / "winners.json")
    torch.cuda.empty_cache()
    flash = phase("flash", phase_flash, torch)
    flash["ptxas"] = ptxas["flash_attention"]
    kernels["masked_rerank"]["ptxas"] = ptxas["masked_rerank"]
    for name in ("flash_attention", "masked_rerank"):
        check(all("0 bytes spill stores, 0 bytes spill loads" in ln
                  for ln in ptxas[name] if "spill" in ln), f"{name}: ptxas reports spills")
    kernels["flash_attention"] = flash["cases"][0]
    # 5. masked-full path, 6. gather path, 7. save / load
    index, masked, masked_runs = phase("masked", phase_masked, torch, corpus_np, queries, gt)
    tune["search"] = phase("autotune_search", phase_autotune_search, torch, index, queries,
                           masked_runs, tune["path"], tune["cache"])
    gather, suco = phase("gather", phase_gather, torch, index, corpus_np, queries, gt,
                         masked_runs)
    del masked_runs
    baselines = phase("baselines", phase_baselines, torch, corpus_np, queries, gt, gather)
    # 6c. every shape past the kernels' former limits: a 960-dim corpus,
    # N_s = 127, k past 1024
    wide = phase("wide", phase_wide, torch, args.n, index, queries, gt)
    torch.cuda.empty_cache()
    persist = phase("persist", phase_persist, torch, index, suco, queries)
    del suco
    torch.cuda.empty_cache()
    # 8. the mutable index over the same base
    mutable = phase("mutable", phase_mutable, torch, index, corpus_np, queries, gt)
    # 9. the serving engine over the same index
    engine = phase("engine", phase_engine, torch, index, queries_np, gt)
    torch.cuda.empty_cache()
    # 10. the same index corpus-sharded over SHARDS views on the card, 11. the launcher
    sharded = phase("sharded", phase_sharded, torch, index, queries_np, queries, gt)
    serve = phase("serve", phase_serve, torch, root, index, tune)
    tune_dir.cleanup()
    del index
    torch.cuda.empty_cache()
    # 12. the LM side at granite-3-2b's full width, once the ANN index is freed
    lm = phase("lm", phase_lm, torch)
    torch.cuda.empty_cache()
    # 13. LM training, once the lm phase's parameters are freed
    train = phase("train", phase_train, torch)
    torch.cuda.empty_cache()
    # 14. the other model families, one at a time
    families = phase("families", phase_families, torch)
    torch.cuda.empty_cache()
    # 15. data and expert parallelism over grids of views of the card
    parallel = phase("parallel", phase_parallel, torch)
    torch.cuda.empty_cache()
    # 16. the dry runs: their counts held to the card, then the runs themselves
    dry = phase("dryrun", phase_dryrun, torch, root)
    torch.cuda.empty_cache()
    # 17. tensor parallelism and ZeRO-1 over a (data, model) grid of the card
    tp = phase("tensor_parallel", phase_tensor_parallel, torch)
    torch.cuda.empty_cache()
    # 18. the moe family's expert parallelism over 'model'
    ep = phase("expert_parallel", phase_expert_parallel, torch)
    torch.cuda.empty_cache()
    # 19. RWKV6 and the hybrid Mamba stack over 'model'
    ssm = phase("ssm_parallel", phase_ssm_parallel, torch)
    torch.cuda.empty_cache()
    # 20. whisper's encoder-decoder over 'model', TaCo decode context-parallel
    cp = phase("enc_dec_context_parallel", phase_enc_dec_context_parallel, torch)

    # 21. summary: each kernel's launches over every path run above
    launches = {name: 0 for name in SOURCES}
    for counts in (flash["launches"], masked["build_launches"], masked["launches"],
                   tune["search"]["launches"], gather["launches"], gather["suco_build_launches"], gather["suco_launches"],
                   persist["launches"], *mutable["launches"], *engine["launches"],
                   sharded["launches"], sharded["engine"]["single"]["launches"],
                   sharded["engine"]["sharded"]["launches"],
                   sharded["serve"]["launches"], sharded["build"]["launches"],
                   *(run["launches"] for run in serve.values()), *lm["launches"],
                   baselines["launches"], *wide["launches"], *train["launches"],
                   *families["launches"],
                   *parallel["launches"], dry["launches"], *tp["launches"],
                   *ep["launches"], *ssm["launches"], *cp["launches"]):
        for name, count in counts.items():
            launches[name] += count
    # the tiled and wide phases' shapes, beside each kernel's main-path one
    wide_shapes = {
        "activation": kernels["activation"]["shapes"],
        "kmeans_assign": [kernels["kmeans_assign"]["ivf"], wide["ivf"]["assign"]],
        "schist": [wide["taco"]["kernels"]["schist"], wide["n_sub_127"]["schist"]],
        "scscore": [wide["taco"]["kernels"]["scscore"], wide["n_sub_127"]["scscore"]],
        "masked_rerank": [wide["taco"]["kernels"]["masked_rerank"],
                          wide["n_sub_127"]["masked_rerank"], *wide["big_k"]["kernels"].values()],
    }
    keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for name, (src, replaces) in SOURCES.items():
        r = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     "shapes": [{key: w[key] for key in keys} for w in wide_shapes.get(name, [])]})
    out = root / "chiprun_out" / "chip_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": line, "build_kernels_s": build_kernels_s,
                               "kernels": kernels, "autotune": tune, "flash": flash,
                               "masked": masked,
                               "gather": gather, "persist": persist,
                               "wide": wide,
                               "mutable": mutable, "engine": engine, "sharded": sharded,
                               "serve": serve, "lm": lm, "baselines": baselines,
                               "train": train, "families": families,
                               "parallel": parallel, "dryrun": dry,
                               "tensor_parallel": tp, "expert_parallel": ep,
                               "ssm_parallel": ssm, "enc_dec_context_parallel": cp,
                               "phase_seconds": phase_seconds},
                              indent=1))
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)

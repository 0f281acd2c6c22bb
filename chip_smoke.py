"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda). Phases, in
order; any failure exits non-zero:

1. device — the card's name and power limit;
2. build — compile the kernels from src/repro_torch/csrc with nvcc;
3. kernels — each kernel against its plain PyTorch version on the card at
   its path's shapes, with its median CUDA-event time (L2 flushed before
   each run), its bound, the plain version's time and, where one exists, a
   PyTorch library call's. kg_scan (one-pass look-back scan) in each of
   its forms: scan_hits with a pattern (with its prefix sum, and the hit
   mask alone as the expand path calls it), scan_hits over a mask (its
   prefix sum; torch.cumsum beside it) and scan_select (the compaction
   without a prefix sum, with and without the hit mask; the route without
   it, the prefix sum then join_ranges over it, beside it), bit-identical
   to the plain versions on a ragged sweep (N 1, 9, 1,000, 4,096 and
   around the 8,192-row tile; 1, 3, 24 and 192 instances as (requests,
   shards) with the triples broadcast over the requests, the mask dense or
   expanded; an all-false and an all-true instance; caps 1, below, at and
   above an instance's count, N, N + 7; five leading dims, folded by a
   copy; three larger N that take 2, 4 and 8 loads a thread), at the main
   path's shapes (scan_select over bucket 4's pair masks, 24 x 201,326,592
   and 24 x 33,554,432 at k 32,768, and its first scan, 24 x 36,800 at k
   1,024) and over 100
   back-to-back launches each at 24 x 201,326,592, 3 x 201,326,592 (the
   prefix mode) and 192 x 36,800 rows, every output equal to the first
   launch's; the prefix and select modes also at one request's 3 x
   201,326,592 rows. The
   query kernels and Jaccard (at a production
   workload of 16,380 LUBM query instances: 8,256 tiles of the triangle,
   4,864 packed columns; and on a ragged sweep of Q 1, 127, 129, 257 x F 1,
   15, 17, 4,859 with empty and duplicated rows) are bit-identical and
   Jaccard exactly symmetric, gather_rows is exact, the CIN layer is within
   atol=5e-4, rtol=1e-4 of the plain layer (and on its ragged sweep of the
   plain version of its split bf16 arithmetic too), timed over the xDeepFM
   forward's three layers at serve_p99 and at serve_bulk (each a record,
   its plan asserted: blocks of 128 rows by 72 columns at serve_p99, by
   200 at serve_bulk), with the bf16 and int8 wgmma instructions of the
   cin and jaccard libraries counted (cuobjdump); kg_join's range search
   (a tree of each key block in shared memory, or its top levels past the
   budget) and its select epilogue join_select (the merge join's pair
   compaction) bit-identical on a ragged sweep
   (C 1, 9, 1,000, around the 16,384-key budget and 65,536; S_b 1 and 3;
   R 77 to 4,097; keys broadcast over the requests or every instance;
   fan-out caps 1, 3, 64; caps 1, around an instance's total, R, R S_b K)
   and at bucket 4's step-3 and step-2 shapes, 100 launches of join_select
   at step 3 each equal to the first, join_ranges timed against two
   torch.searchsorted calls in alternation over 5 rounds and join_select
   beside the mask route it replaces, each with its device time by
   torch.profiler; kg_join's compat kernels (csrc/kg_compat.cu):
   compat_matrix and compat_select (the expand join's selection without
   the matrix) bit-identical on a ragged sweep (R off the 32-row tiles, C
   off the 256-column segments and past 64 of them, V 1 to 6, caps 0, 1,
   around an instance's total, R, R C and past, one, 3 and the engine's
   broadcast 8 x 3 instances) and at the expand path's shape (24 x 256 x
   768, cap 256) and a larger one (6 x 4,096 x 8,192, cap 4,096), 100
   launches of compat_select at the first equal to the first launch, each
   timed with its device time beside the route compat_select replaces
   (compat_matrix, scan_select, .any); flash_attention
   is within atol=2e-5 in float32 and atol=1e-4 + 2**-7 |plain| (one
   bfloat16 step) in bfloat16, on a ragged sweep (G 1, 4, 48; causal or
   not; q_start 0, T - S and mid-tile; strided cache views), on each route
   (the split route forced at small T, also against its plain version;
   the tensor-core route at d 100 and ragged T), with the count of
   tensor-core instructions in its library (cuobjdump), and at the LM
   paths' prefill (1 x 32 heads x 8,192 over 8 KV heads; route "wgmma") and
   decode (8 x 32 heads over a 32,768-slot cache at q_start 32,760; route
   "split") shapes, and qwen2-moe-a2.7b's (16 heads over 16 KV heads; a
   decode step of 4 sequences), each timed in bfloat16 and listed as a
   kernel record of its own; the split route with its log-sum-exp
   (return_lse) on a sweep (G 1, 4, 48 in groups of 16 rows, S up to 4,
   one chunk or many, head dims 7 and 100; output within FLASH_TOL, lse
   within 1e-4 of attention_lse_ref) and at the split decode's rank
   shape (4 x 32 heads over a rank's 8,192 slots; its own record, whose
   launches are phase 11b's); bag_sum
   (an op no path calls) within atol 1e-5 on a ragged sweep and over the
   full xDeepFM table (26.4M x 10) at 262,144 bags of 39 (two launches
   bit-identical; device time, F.embedding_bag's, and the bound of the
   32-byte sectors its distinct rows span), its launches those of these
   checks; segment_spmm within tests/test_kernels.py's
   1e-4 (float32) and 0.15 (bfloat16) on a ragged sweep (E and N off the
   TPU's blocks, D from 1 to 6,272 across the narrow and wide mappings,
   10% and all edges masked, no edges, a hub of half the edges, every edge
   on one node, nodes of 1, 3 and 40 PIECEs and of PIECE and PIECE + 1
   edges, receivers given sorted, one segment plan for two value tensors
   of different D; hubs at atol 1e-4 x max |plain|), two calls on the
   same inputs bit-identical, and at the two GNN paths' shapes, GCN layer
   2 at ogbn-products (E 64,308,169, D 47, N 2,449,029) and Equiformer-v2's
   values on the molecule batch (E 8,192, D 6,272), each a kernel record of
   its own with the plan's time, the op's with the plan built and without,
   and the kernel's alone; gather_rows also exact on a ragged sweep (D 1, 3, 10,
   16, 33; negative and out-of-range ids; the table in place and one row
   into a larger one);
4. main path — LUBM(1) at scale 1.0, WawPart over 3 shards taken from the
   Jaccard kernel's distances (the same partition as the numpy distances),
   served by WorkloadServer(join_impl="sorted") with the kernels: every
   result equals the oracle, no overflow flag is set, jaccard_distance,
   scan_select, join_ranges and join_select launched, join_ranges +
   join_select once per merge join and join_select once per merge join
   that expands without verifying a second column (no pair mask there);
   serve() is submit + drain on the continuous-batching pipeline;
4b. pipeline — on phase 4's store, partition and engines (answer cache
   off, max_batch 14, deadline 25 ms, max_inflight 2): a FakeClock
   schedule of four passes over the 14 templates with full, deadline and
   drain flushes each > 0; a real-clock replay_paced of 140 requests at
   1 ms arrivals (latency percentiles per bucket, flush counters, how many
   batches _retire completed on a fired CUDA event against how many a
   later completion found ready or blocked on, peak memory, and the
   device-busy share of a profiled replay); migrate() to
   incremental_repartition(part, queries, two_phase_weights(queries)[1],
   budget_frac=0.15) with 14 requests queued, every ticket then on epoch
   1; shutdown(grace_s=0) with requests queued, each resolved with
   ShutdownError while the batches in flight complete. Every answer
   equals evaluate_bgp; scan_select and join_select launched;
4c. faults, replication, adaptive — on phase 4's store, partition and
   engines (answer cache off): two passes of the 14 templates under
   FaultPlan(seed=5, dispatch_fail_rate=0.5) with RetryPolicy(
   max_attempts=8) (failures injected and retried, none shed, the kernel
   launches equal to the same fault-free passes'), then with no policy
   (every failed cut resolved with InjectedDispatchError); a FakeClock
   shard-down window for shard 1 (shed templates = uncovered_templates,
   the covered ones exact, the restore builds no engine, the peak memory
   while degraded); replicate_hot() (collectives before and after, the
   engines it builds, serve() ms before and after), then
   mark_shard_down(1) with the 14 templates queued (uncovered ones
   typed at once, covered ones drained exact, degraded_served) and
   mark_shard_up(); the adaptive controller (window 64, checks every 32)
   over a two-phase drifting stream of 192 requests, 32 a serve() (its
   events, migrations and each migrate()'s ms), then the same under
   FaultPlan(abort_migrations=99) (epoch stays 0, migration_aborts =
   injected). Every delivered answer equals evaluate_bgp; scan_select,
   join_ranges and join_select launched;
4d. mesh — on phase 4's LUBM(1) store: the multi-device path on
   torch.distributed, one gloo rank (process) per shard, every rank on
   the one card. 3 ranks over phase 4's WawPart partition and a random
   one (seed 0): every bucket (all its members, one call) through
   make_sharded_batched_engine with both joins (the expand join under
   the random placement, and over 8 shards, with gather_cap 65,535: its
   gathered matches would pass compat_select's 2^31 pairs an instance),
   each rank's outputs equal
   to the single-device engine's on the card (SHA-1 of the bytes), its
   counted all_gathers equal to bucket_collectives, its launches equal to
   the single-device call's (WawPart sorted: phase 4's scan_select,
   join_ranges, join_select); run_sharded of the 14 templates (WawPart
   both joins, random sorted, and centralized on a mesh of one in this
   process; max_per_row 1,024), every answer equal to evaluate_bgp, its
   gathers n_gathers; the mesh-routed server (rank 0
   serves, the others run serve_worker): two passes of the 14 templates,
   every answer equal to evaluate_bgp, serve() ms beside phase 4's, the
   first pass with the answer cache off timed 5 times, the gathers a pass
   equal to the cuts, then replicate_hot() and the gathers after it
   (fewer). Then 8 ranks over an 8-shard WawPart partition, both joins,
   the same checks. Prints gathers and gathered bytes per bucket and per
   template under WawPart against random, each rank's device and peak
   memory;
5. expand path — LUBM at scale 0.1 under join_impl="expand": the same
   checks, compat_select launched once per expand join (11), scan_hits
   and scan_select launched, compat_matrix, join_ranges and join_select
   not;
6. per-query engine — the paper's execution path (engine/federated
   make_engine over engine/local, one plan a call, the shards a leading
   dim) through run_vmapped with the kernels: LUBM(1) at scale 1.0 under
   phase 4's WawPart partition with the expand and the sorted join, then
   under the random and centralized placements with the sorted join, and
   BSBM at 1,000 products (configs/bsbm.full()) under WawPart with both
   joins. The sorted join's max_per_row starts at 256 and doubles while a
   template flags an overflow. Every answer equals evaluate_bgp, and the
   bucket engine's for WawPart, with no overflow; every template's whole
   table, mask and overflow flag from the kernels equal the plain
   primitives' on the card (WawPart, both joins, both datasets); the
   launches of each run equal what the plans' steps give (a scan_select a
   step, a compat_select an expand join, a join_select a merge step on
   one shared column, a join_ranges and a scan_select one that verifies a
   second; compat_matrix 0); each template's median ms a call, their sum
   (the workload time of Figs. 5/6), n_gathers and the peak memory per
   run;
7. clustering — the production workload's distances through
   jaccard_distance_matrix(use_kernel=True), linkage_torch on the card over
   its first 4,096 instances, and over its first 1,024 on the card and on
   the CPU for the three linkages (single and complete identical, average
   with the same merges and distances within 1e-6);
8. xDeepFM — the full config (39 sparse fields, D = 10, CIN 200-200-200,
   MLP 400-400, 26.4M embedding rows, random weights from a seed) served
   at batch 512 and 262,144 with the kernels: logits match the plain
   forward within atol=1e-3, rtol=1e-4, each CIN layer (on the embeddings
   scaled to unit variance) matches the plain layer within atol=5e-4,
   rtol=1e-4, gather_rows launched once and cin_layer three times per
   forward;
9. LM serving — granite-3-8b and granite-20b at full width and 4 layers
   in float32: prefill logits with the kernel within 1e-4 x max |logit| of
   the plain attention path, a decode step within 1e-3 of forward's
   logits; then granite-3-8b at full width and depth in bfloat16 (random
   weights from seed 0, 16.7 GB): a prefill of 1 x 8,192 prompt tokens and
   8 greedy decode steps of 8 sequences over a 32,768-slot cache (42.9 GB)
   from position 32,760, every logit finite, flash_attention launched 40
   times in the prefill (all on the wgmma route) and 40 per step (all on
   the split route), each profiled;
9b. LM serving, MoE and MLA — float32 checks: qwen2-moe-a2.7b at full
   width and 2 layers (prefill logits with flash_attention within 1e-4 x
   max |logit| of the plain path, two calls bit-identical, and at a
   capacity factor with no drops a decode step within 1e-3 of forward's
   logits) and deepseek-v3-671b at full width and its 3 dense MLA layers
   (the absorbed decode step within 1e-3 of forward's logits); then in
   bfloat16 with random weights from seed 0, qwen2-moe-a2.7b at full width
   and depth (14.3B parameters): a prefill of 1 x 8,192 and 8 greedy
   decode steps of 4 sequences over 32,768 slots from position 32,760
   (flash_attention 24 times a call, route "wgmma" at the prefill and
   "split" at decode), and deepseek-v3-671b's widths at 4 layers (3 dense
   MLA layers, 1 MoE layer of 256 experts; 15.8B parameters): a prefill of
   1 x 4,096 and 8 steps of 8 sequences over its latent cache (no
   flash_attention): every logit finite, the pairs each MoE layer drops,
   seconds, ms a step, peak memory, profiles, and the first MoE layer's
   routing, dispatch, experts' products, combine and shared expert timed
   at both shapes;
10. GNN serving — GCN (gcn_cora.full("ogb_products"): 2 layers, d_in 100,
   hidden 16, 47 classes) on the full ogbn-products batch (2,449,029
   nodes, 64,308,169 edges with self loops, built in numpy from seed 0),
   then EGNN, NequIP and Equiformer-v2 at full() on the molecule batch
   (128 molecules, 3,840 nodes, 8,192 edges), random weights from seed 0:
   each forward through segment_spmm within rtol 1e-4 and atol 1e-4 x
   max |plain| of the same forward on the plain index_add_ path, every
   output finite, segment_spmm launched 2, 8, 5 and 12 times and one
   segment plan built per forward, ms per forward (CUDA events), peak
   memory (GCN's beside its peak with a sorted copy of the messages per
   call) and a profiled breakdown;
   Equiformer-v2's energies unchanged within 1e-4 relative under a random
   rotation and translation;
11. training — through the port's runtime (runtime/trainer.Trainer, AdamW,
   the cosine schedule, checkpoints, the prefetcher): gather_rows,
   bag_sum, cin_layer, flash_attention and jaccard_distance raise on the
   card under autograd (and run under no_grad), segment_spmm's gradient
   equals its plain version's; GCN (phase 10's ogbn-products batch) and
   EGNN, NequIP, Equiformer-v2 full() (the molecule batch) for 3 steps
   each, every aggregate through segment_spmm (2, 8, 5 and 12 launches a
   step), one step's gradients against use_kernel=False within 1e-4 of
   each leaf's largest |plain| (2e-3 for Equiformer-v2, whose leaky_relu
   attention scores can take the other slope under float32 order noise);
   xDeepFM full() through
   launch/train.build_task: two probe steps (2,048, 8,192) predict the
   step's peak, the batch is 65,536 halved while that passes 70 GB, 30
   steps (ms a step, peak, a profiled step, the loss of the last 5 steps
   below the first 5's, no kernel launched: the training lookup and CIN
   are the plain path), two steps at batch 256 on the card against the
   CPU, a run failed at step 4 and resumed from its step-3 checkpoint
   under build/ against two clean runs (the gaps printed; bit-identical
   if the clean runs are), and --compress (int8 EF) through the CLI;
   granite-3-8b's widths at 2 layers in float32, batch 2 x 4,096, 12
   steps (ms a step, peak, the loss falls, flash_attention not launched);
   through launch/train.build_task, qwen2-moe-a2.7b's widths at 2 layers,
   batch 2 x 4,096, 8 steps, and deepseek-v3-671b's widths with the MTP
   head at 1 to 3 dense MLA layers (as many as a probe step at 1 predicts
   under 70 GB), batch 1 x 2,048, 8 steps on DeepSeek-V3's warmup (ms a
   step, peak, the loss and the MTP term fall, flash_attention not
   launched);
11b. mesh models — the model-parallel mesh with gloo ranks (processes)
   sharing the one card, each piece against the one-device path on the
   card: deepseek-v3-671b's MoE layer (256 experts of (7,168, 2,048),
   bf16, 5.6 GB of them a rank) expert-parallel on 1 x 4 over a 1 x
   4,096 prefill, and qwen2-moe-a2.7b's over 2 x 4,096 tokens on 2 x 4
   (EP, the data dim re-gathered) and on 1 x 8 (expert-TP: 60 % 8 != 0),
   at a capacity factor with no drops, each within 3e-2 of max |out| of
   the one-device layer run on the same data blocks, the model columns
   bit-identical, one all_reduce a layer (its bytes printed); the GQA
   split-KV decode at granite-3-8b's widths (2 layers, 8 sequences over
   32,768 slots from 32,760) on 2 x 4 in float32 (logits within
   CHECK_LOGIT_SHARE of max |logit| of the one-device flash decode) and
   bf16 (within 3e-2), batch 8 and 1, every rank launching flash's
   split route with its lse once a layer a step, ms a step and the bytes
   reduced; the MLA split decode at deepseek-v3's widths (2 dense
   layers, bf16, wkv_b held a block over "model" and gathered) on 2 x 2;
   the Trainer at granite-3-8b's widths (2 layers, float32, batch 4 x
   1,024, lm_rules(fsdp=True)) for one FSDP step on 2 x 2 (each layer's
   blocks gathered inside the layer, the gradients reduce-scattered as
   the backward leaves it) against the one-device Trainer (losses within
   1e-3 relative), checkpointed (rank 0 writes the one-device layout),
   restored onto 4 x 1 for a second step; each rank's peak memory over
   the run (beside the whole-leaf route's) and over the steps alone, its
   gathers and reduce-scatters; tensor-parallel serving, each rank
   serving from its lm_rules blocks (column/row-parallel layers,
   vocabulary-parallel embedding and head): a prefill into 8,192 slots
   then 5 decode steps from the cache it leaves, at granite-3-8b's widths
   (2 layers, 2 x 4,096 on 2 x 4, bf16 and float32; also over whole
   leaves on the mesh, the peak beside it), granite-20b's (MQA, 1 x 4,096
   on 1 x 4) and deepseek-v3's 2 dense MLA layers (lm_rules(fsdp=True),
   2 x 2,048 on 2 x 2), the ranks' logit blocks within 3e-2 of max
   |logit| of the one-device path (float32: CHECK_LOGIT_SHARE), each GQA
   rank launching flash on route "wgmma" once a layer at the prefill and
   its split route with lse once a layer a step (where its slots begin
   at or before the position), the collectives, ms and peak a rank;
12. minibatch_lg and the dry run — (a) the neighbour sampler's batch at
   full size (1,024 seeds at fan-outs 15, 10 over the synthetic 232,965-
   node, 114,615,892-edge graph; its host build timed), GCN
   (gcn_cora.full("minibatch_lg")), EGNN, NequIP and Equiformer-v2 (at
   the depth whose forward the dry run predicts under 70 GB) forwards
   through segment_spmm against the plain path as in phase 10, GCN
   trained 3 steps through the Trainer (2 launches a step, finite
   losses, one step's gradients against the plain path), and
   segment_spmm's record at GCN layer 2's shape there; (b) the dry run on
   the meta device (repro_torch.launch.dryrun.run_cell, one process a
   core): one shape an architecture on 16 x 16 and one cell a family on
   2 x 16 x 16, then the other cells while 60 s last, and the engine
   rows; no error record, each written to build/dryrun.jsonl; (c) the
   dry run against the card on a 1 x 1 mesh for GCN minibatch_lg
   (train), gcn-cora molecule (train) and xDeepFM serve_p99 (forward):
   the same step run for real, its FLOPs (FlopCounterMode) equal to the
   meta run's, each kernel's meta calls equal to its launches, and the
   meta peak above the held bytes within 10% of max_memory_allocated's;
   then an FSDP train cell (granite-3-8b's widths, 2 layers, bf16, accum
   2) on 2 x 2 gloo ranks sharing the card, each rank's MetaMesh run
   against its real one: FLOPs and collectives equal, the peak above the
   held bytes within 10%; then a tensor-parallel prefill cell (4 x 2,048)
   and decode cell (4 sequences over 8,192 slots) at the same widths on
   2 x 2, held the same way, flash's meta calls equal to its launches;
   then Equiformer-v2 and EGNN train cells at full width on the molecule
   batch on 2 x 2, each rank on its node block and edge block
   (graph_batch_specs), segment_spmm over its block-local receivers: the
   loss and every leaf's gradient as AdamW takes it within 1e-4 (relative
   L2) of one device's over the whole batch, FLOPs, collectives and
   segment_spmm calls equal to the MetaMesh rank's, the peak above the
   held bytes within 10%, max_memory_allocated a rank beside the same
   step's over the whole batch on every rank; phase 3 holds segment_spmm
   at a rank's edge block of that cell (each rank's receivers, the
   receiver mask) and records rank 0's;
   the card's total_memory equals the dry run's H100 constant (phase 1);
13. summary — every kernel's launches on its path.

The last three lines are the card's name and power limit, a JSON line of
per-kernel numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false; this run needs a "
          "CUDA card", file=sys.stderr)
    sys.exit(2)

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import egnn as egnn_configs  # noqa: E402
from repro_torch.configs import equiformer_v2 as eq_configs  # noqa: E402
from repro_torch.configs import gcn_cora  # noqa: E402
from repro_torch.configs import granite_3_8b, granite_20b  # noqa: E402
from repro_torch.configs import deepseek_v3_671b  # noqa: E402
from repro_torch.configs import qwen2_moe_a2_7b  # noqa: E402
from repro_torch.configs import nequip as nequip_configs  # noqa: E402
from repro_torch.configs import xdeepfm as xdeepfm_configs  # noqa: E402
from repro_torch.configs import bsbm as bsbm_config  # noqa: E402
from repro_torch.configs import lubm as lubm_config  # noqa: E402
from repro_torch.core.distance import (feature_matrix,  # noqa: E402
                                       jaccard_distance_matrix)
from repro_torch.core.hac import LINKAGES, linkage_torch  # noqa: E402
from repro_torch.core.partitioner import (  # noqa: E402
    centralized_partition, random_partition, wawpart_partition)
from repro_torch.data.graphs import make_graph_batch  # noqa: E402
from repro_torch.data.recsys import click_batches  # noqa: E402
from repro_torch.data.tokens import token_batches  # noqa: E402
from repro_torch.engine.federated import (ShardedKG,  # noqa: E402
                                          make_engine, run_vmapped)
from repro_torch.engine.oracle import evaluate_bgp  # noqa: E402
from repro_torch.engine.planner import make_plan  # noqa: E402
from repro_torch.kernels.cin import kernel as cin_kernel  # noqa: E402
from repro_torch.kernels.cin import ops as cin_ops  # noqa: E402
from repro_torch.kernels.cin.ref import (cin_layer_ref,  # noqa: E402
                                         cin_layer_split_ref)
from repro_torch.kernels.embedding_bag import \
    kernel as emb_kernel  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as emb_ops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import (bag_sum_ref,  # noqa: E402
                                                  gather_rows_ref)
from repro_torch.kernels.flash_attention import \
    kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_lse_ref, attention_ref, attention_split_ref)
from repro_torch.kernels.jaccard import kernel as jac_kernel  # noqa: E402
from repro_torch.kernels.jaccard import ops as jac_ops  # noqa: E402
from repro_torch.kernels.jaccard.ref import jaccard_distance_ref  # noqa: E402
from repro_torch.kernels.kg_join import kernel as join_kernel  # noqa: E402
from repro_torch.kernels.kg_join import ops as join_ops  # noqa: E402
from repro_torch.kernels.kg_join.ref import (compat_matrix_ref,  # noqa: E402
                                             compat_select_ref,
                                             join_ranges_ref,
                                             join_select_ref)
from repro_torch.engine import batch as engine_batch  # noqa: E402
from repro_torch.engine.primitives import pair_mask  # noqa: E402
from repro_torch.kernels.kg_scan import kernel as scan_kernel  # noqa: E402
from repro_torch.kernels.kg_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.kg_scan.ref import (scan_hits_ref,  # noqa: E402
                                             scan_select_ref)
from repro_torch.kernels.segment_spmm import ops as seg_ops  # noqa: E402
from repro_torch.kernels.segment_spmm.kernel import (  # noqa: E402
    PIECE, segment_spmm_kernel)
from repro_torch.kernels.segment_spmm.ref import \
    segment_spmm_ref  # noqa: E402
from repro_torch.kg.generator import (generate_bsbm,  # noqa: E402
                                      generate_lubm)
from repro_torch.kg.workloads import bsbm_queries, lubm_queries  # noqa: E402
from repro_torch.adaptive.controller import AdaptiveConfig  # noqa: E402
from repro_torch.adaptive.repartition import \
    incremental_repartition  # noqa: E402
from repro_torch.faults import (FaultPlan,  # noqa: E402
                                InjectedDispatchError, RetryPolicy,
                                ShardDownError, ShutdownError,
                                degraded_placement, uncovered_templates)
from repro_torch.engine.batch import (bucket_collectives,  # noqa: E402
                                      shard_perms)
from repro_torch.engine.federated import run_sharded  # noqa: E402
from repro_torch.launch.mesh import make_engine_mesh, spawn  # noqa: E402
from repro_torch.launch.serve import (PipelineConfig,  # noqa: E402
                                      WorkloadServer, drifting_stream,
                                      replay_paced, request_stream,
                                      serve_worker, stop_workers,
                                      two_phase_weights)
from repro_torch.sharding.rules import (Blocks, P,  # noqa: E402
                                        kg_local, lm_rules, local_slice,
                                        make_param_specs)
from repro_torch.obs import Telemetry  # noqa: E402
from repro_torch.models.gnn.egnn import EGNN  # noqa: E402
from repro_torch.models.gnn.equiformer_v2 import EquiformerV2  # noqa: E402
from repro_torch.models.gnn.gcn import GCN  # noqa: E402
from repro_torch.models.gnn.nequip import NequIP  # noqa: E402
from repro_torch.models.recsys.xdeepfm import (XDeepFM,  # noqa: E402
                                               field_offsets)
from repro_torch.models import transformer as lm_mod  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.models.transformer import \
    loss_fn as lm_loss_fn  # noqa: E402
from repro_torch.models.gnn import egnn as egnn_mod  # noqa: E402
from repro_torch.models.gnn import equiformer_v2 as eq_mod  # noqa: E402
from repro_torch.models.gnn import gcn as gcn_mod  # noqa: E402
from repro_torch.models.gnn import nequip as nequip_mod  # noqa: E402
from repro_torch.data import Prefetcher  # noqa: E402
from repro_torch.launch.train import build_task  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainTask  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import cells as dry_cells  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (MetaMesh,  # noqa: E402
                                     make_device_mesh,
                                     make_production_mesh)
from repro_torch.models import meta_generator  # noqa: E402
from repro_torch.models.gnn.common import (GraphBatch,  # noqa: E402
                                           MeshGraph)
from repro_torch.tree import leaves_with_path  # noqa: E402

DEV = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
OPS_PER_S = 67e12            # H100 SXM float32 rate outside the tensor
#                              cores; integer ALU ops are counted against it
INT8_TC_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate: exact
#                              for products of 0/1 operands
BF16_TC_OPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core rate
INT32_OPS_PER_S = 16.7e12    # H100 SXM int32 rate: 64 INT32 lanes an SM
#                              (half its 128 float32 lanes) x 132 SMs x
#                              1.98 GHz, one compare a lane a cycle
REPS = 25
# kg_scan: the pattern and gate of instance b are row b % 4; bucket 4's
# pair masks per (request, shard) instance at LUBM(1) over its 8 padded
# requests x 3 shards, R x S_b x K pairs of which its compaction keeps R:
# step 3 gathers the 3 shards' matches (32,768 x 3 x 2,048), step 2 takes
# its own shard's (32,768 x 1 x 1,024); the ragged sweep's instance
# counts, as (requests, shards), and the stress runs' launches
SCAN_PATS = np.array([[5, -1, 7], [-1, -1, -1], [-2, 3, -1], [4, -1, -1]],
                     np.int32)
SCAN_GATES = np.array([[0, 0, 0], [1, 0, 0], [0, 0, 0], [0, 1, 1]], bool)
PAIR_LEAD, PAIR_K = (8, 3), 32768
PAIR_ROWS, PAIR_ROWS_STEP2 = 32768 * 3 * 2048, 32768 * 1 * 1024
SCAN_LEADS = ((1, 1), (1, 3), (8, 3), (64, 3))
SCAN_STRESS = 100
# kg_join: the LUBM(1) main path's merge steps that expand through
# join_select, name: ((requests, shards), S_b, C, R, K). Bucket 4 (8 padded
# requests x 3 shards, C 16,384 keys a block, R 32,768 table rows): step 3
# searches the 3 gathered shards' blocks with a fan-out cap K of 2,048, step
# 2 its own shard's with 1,024; bucket 2's step 1 is one request's. The row
# keys miss most blocks, as the main path's do (an instance keeps at most R
# pairs; keys drawn from 12 C values), with a few hubs of fan-out 64. The
# search's record is at step 3's shape (JOIN_C, JOIN_R).
JOIN_C, JOIN_R = 16384, 32768
JOIN_STEPS = {"bucket 4 step 3": (PAIR_LEAD, 3, JOIN_C, JOIN_R, 2048),
              "bucket 4 step 2": (PAIR_LEAD, 1, JOIN_C, JOIN_R, 1024),
              "bucket 2 step 1": ((1, 3), 1, 512, 512, 32)}
# kg_join's compat kernels: the expand path's largest call at LUBM 0.1
# (bucket 4: 8 requests x 3 shards, R = 256 table rows of 4 vars against 3
# gathered blocks of 256 matches, cap R) and a larger one, (instances, R,
# V, C, cap)
COMPAT_SHAPES = {"expand path": (24, 256, 4, 768, 256),
                 "large": (6, 4096, 6, 8192, 4096)}
RNG = np.random.default_rng(0)
BATCH = 14                   # requests per serve(): one per LUBM template
EXPAND_JOINS = 11            # expand joins of phase 5's two passes
# phase 6, the per-query engine: timed calls per template after a warm
# one; the sorted join's max_per_row starts at benchmarks/harness.py's 256
# and doubles while a template overflows, up to the limit; BSBM at
# configs/bsbm.full(), generate_bsbm(1000) as the CLI's
# build_dataset("bsbm", 1.0) builds it
PQ_REPS = 5
PQ_FANOUT, PQ_FANOUT_LIMIT = 256, 1 << 14
BSBM_PRODUCTS = 1000
# the production clustering workload: every (university, department)
# instance of the 14 LUBM templates, 78 x 15 x 14 = 16,380 queries
UNIVERSITIES, DEPARTMENTS = 78, 15
LINKAGE_N, LINKAGE_CHECK_N = 4096, 1024
CIN_TOL = dict(atol=5e-4, rtol=1e-4)       # tests/test_kernels.py's
LOGIT_TOL = dict(atol=1e-3, rtol=1e-4)     # tests/test_models_recsys.py's
XDEEPFM_REPS = {"serve_p99": 20, "serve_bulk": 3}
PLAIN_CHUNK = 8192           # plain forward's batch chunk at serve_bulk
# cin_layer's plan (rows, columns per block) at the forward's layers:
# serve_p99 splits K = 200 into three column tiles of 72 (43 row tiles of
# 12 examples: 129 blocks for 132 SMs), serve_bulk keeps one of 200
CIN_PLANS = {"serve_p99": (128, 72), "serve_bulk": (128, 200)}
# flash_attention against attention_ref: float32 at tests/test_kernels.py's
# 2e-5; bfloat16 at one bfloat16 step of the plain output (2**-7 of |out|),
# since both round float32 results that differ only in summation order,
# plus 1e-4 for outputs near 0
FLASH_TOL = {torch.float32: dict(atol=2e-5),
             torch.bfloat16: dict(atol=1e-4, rtol=2 ** -7)}
# LM serving: granite-3-8b prefill of 1 x 8,192 tokens (the reference's
# prefill_32k is 32 x 32,768), decode of 8 sequences for 8 steps over a
# 32,768-slot cache from position 32,760 (decode_32k's length; its batch of
# 128 would need 687 GB of cache)
PREFILL_S = 8192
DECODE_B, DECODE_T, DECODE_CUR, DECODE_STEPS = 8, 32768, 32760, 8
# float32 checks at full width and 4 layers: B x S prompt tokens into a
# cache of S + 8 slots, then one decode step at position S
CHECK_LAYERS, CHECK_B, CHECK_S = 4, 2, 1024
CHECK_LOGIT_SHARE = 1e-4     # kernel vs plain prefill logits: atol as a
#                              share of the plain run's largest |logit|
CHECK_DECODE_ERR = 1e-3      # decode vs forward, tests/test_models_lm.py's
# LM serving, MoE and MLA (phase 9b): qwen2-moe-a2.7b at full width and
# depth (24 layers), prefill 1 x PREFILL_S, then DECODE_STEPS steps of
# MOE_DECODE_B sequences over DECODE_T slots from DECODE_CUR (cache 25.8
# GB); deepseek-v3-671b's widths cut to DS_LAYERS layers, its 3 dense MLA
# layers and 1 MoE layer of 256 experts (its 61 layers' 671.7B parameters
# do not fit one card), prefill 1 x DS_PREFILL_S, then DECODE_STEPS steps of
# DS_DECODE_B sequences over its latent cache of DECODE_T slots. float32
# checks: qwen2-moe at MOE_CHECK_LAYERS layers, deepseek-v3 at its
# DS_CHECK_LAYERS dense MLA layers, CHECK_B x CHECK_S prompt tokens
MOE_DECODE_B = 4
DS_LAYERS, DS_PREFILL_S, DS_DECODE_B = 4, 4096, 8
MOE_CHECK_LAYERS, DS_CHECK_LAYERS = 2, 3
# segment_spmm against its plain version (index_add_ in float32): on the
# ragged sweep tests/test_kernels.py's 1e-4 (float32) and 0.15 (bfloat16);
# at the GNN paths' shapes, and for the GNN forwards, rtol 1e-4 and atol
# 1e-4 x max |plain|: the kernel sums a node's edges in edge order, the
# plain version with atomics in an order that changes from run to run, and
# the error of a float32 sum grows with its range (hubs of up to 459,110
# edges at ogbn-products) and its partial sums, not with its result
SPMM_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=0.15, rtol=0.15)}
GNN_SHARE = 1e-4
# segment_spmm's kernels (the profiles' share)
SPMM_KERNELS = ("segment_sum_", "segment_combine")
# bag_sum: tests/test_kernels.py's atol 1e-5 in float32; a bfloat16 table
# one bfloat16 step (both round the same float32 sum once, in other orders)
BAG_TOL = {torch.float32: dict(atol=1e-5),
           torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7)}
# segment_spmm launches per forward: one aggregate per GCN layer, two per
# EGNN layer (coordinate mean, message sum), one per NequIP and
# Equiformer-v2 layer
GNN_LAUNCHES = {"gcn": 2, "egnn": 8, "nequip": 5, "equiformer_v2": 12}
GNN_REPS = {"gcn": 5, "egnn": 20, "nequip": 20, "equiformer_v2": 10}
# GCN's forward peak on the ogbn-products batch when the op sorted a copy
# of the messages on every call (this script on an NVIDIA H100 80GB HBM3 at
# 700 W): 28.08 GB, 12.1 GB of it the sorted copy of layer 2's messages
GCN_PEAK_SORTED_COPY = 28_075_147_776


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def dev(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEV)


_FLUSH = None


def time_ms(fn, reps: int = REPS, warm: int = 3) -> float:
    """Median milliseconds of fn() over ``reps`` CUDA-event-timed runs
    after ``warm`` untimed ones, each after a 256 MiB write that evicts the
    50 MB L2."""
    global _FLUSH
    if _FLUSH is None:
        with torch.inference_mode(False):    # written in place on every run
            _FLUSH = torch.empty(64 << 20, dtype=torch.int32, device=DEV)
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(outs, refs) -> int:
    """Largest |kernel - plain| over every output; fails unless 0."""
    err = 0
    for o, r in zip(outs, refs):
        if o.shape != r.shape or o.dtype != r.dtype:
            raise AssertionError(f"kernel output {tuple(o.shape)} {o.dtype} "
                                 f"!= plain {tuple(r.shape)} {r.dtype}")
        err = max(err, int((o.to(torch.int64) - r.to(torch.int64))
                           .abs().max().item()) if o.numel() else 0)
    if err != 0:
        raise AssertionError(f"kernel differs from its plain version by "
                             f"{err}")
    return err


def float_err(out, ref, *, exact: bool = False, atol: float = 0.0,
              rtol: float = 0.0) -> float:
    """Largest |kernel - plain| of a float output; fails unless the two are
    bit-identical (``exact``, NaN where the other has NaN) or within
    atol + rtol * |plain|."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"kernel output {tuple(out.shape)} {out.dtype} "
                             f"!= plain {tuple(ref.shape)} {ref.dtype}")
    if out.numel() == 0:
        return 0.0
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(out), nan):
        raise AssertionError("kernel and plain version differ in NaNs")
    diff = (out - ref).abs().masked_fill(nan, 0)
    err = float(diff.max().item())
    ok = (torch.equal(out.masked_fill(nan, 0).view(torch.int32),
                      ref.masked_fill(nan, 0).view(torch.int32)) if exact
          else bool((diff <= atol + rtol * ref.abs().masked_fill(nan, 0))
                    .all().item()))
    if not ok:
        raise AssertionError(
            f"kernel differs from its plain version: max |diff| {err} "
            + ("(bits differ)" if exact else f"(atol {atol}, rtol {rtol})"))
    return err


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_ms(fn, reps: int = REPS) -> float:
    """Device milliseconds of fn()'s kernels and memsets per call, summed
    over ``reps`` back-to-back calls under torch.profiler: the card's own
    time, without the host's time to issue a call or an idle card between
    calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    on_device = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == on_device) / reps / 1e3


def device_breakdown(fn, share_of: tuple[str, ...] = ()) -> str:
    """One run of fn() under torch.profiler: the device-busy share of its
    wall and the kernels with the most device time (and the share of the
    device time spent in kernels whose name holds one of ``share_of``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    on_device = torch.autograd.DeviceType.CUDA
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == on_device and not e.is_user_annotation),
                  key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    if not busy_us:
        # a short run can show no device time (the profiler saw no
        # kernel): nothing to divide by
        return (f"no device time reported over {wall_us / 1e3:.3f} ms of "
                f"profiled wall")
    top = "; ".join(f"{e.key[:70]} x{e.count} "
                    f"{e.self_device_time_total / 1e3:.3f} ms"
                    for e in rows[:6])
    mine = [e for e in rows if any(k in e.key for k in share_of)]
    share = "" if not share_of else (
        f"; {' + '.join(share_of)} "
        f"{sum(e.self_device_time_total for e in mine) / 1e3:.3f} ms, "
        f"{sum(e.self_device_time_total for e in mine) / busy_us:.1%}"
        " of device time")
    return (f"device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
            f"profiled wall ({busy_us / wall_us:.1%}); {top}{share}")


def production_queries():
    return [q for u in range(UNIVERSITIES) for d in range(DEPARTMENTS)
            for q in lubm_queries(u, d)]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def scan_args(lead: tuple[int, int], n: int, *, mask_only: bool = False,
              gates: bool = True, expand_valid: bool = False,
              p_valid: float = 0.8):
    """kg_scan's arguments over (requests, shards) instances as the engine
    passes them: triples (S, N, 3) broadcast over the requests, spo and eq
    (B, 1, 3) broadcast over the shards; valid (B, S, N), or (S, N)
    expanded over the requests. The first instance's mask is all false and
    the last one's all true."""
    b, s = lead
    va = RNG.uniform(size=(s if expand_valid else b * s, n)) < p_valid
    va[0] = False
    if va.shape[0] > 1:
        va[-1] = True
    va = dev(va)
    va = (va[None].expand(b, s, n) if expand_valid else va.reshape(b, s, n))
    if mask_only:
        return (None, va, None, None)
    tr = dev(RNG.integers(-1, 30, (s, n, 3)).astype(np.int32))
    spo = dev(SCAN_PATS[np.arange(b) % 4][:, None])
    eq = dev(SCAN_GATES[np.arange(b) % 4][:, None]) if gates else None
    return (tr, va, spo, eq)


def random_mask(lead: tuple[int, int], n: int,
                p_valid: float = 0.8) -> torch.Tensor:
    """A (requests, shards, n) bool mask made on the card from seed 0 (one
    instance at a time), the first instance all false and the last all
    true, as scan_args makes its masks."""
    g = torch.Generator(device=DEV)
    g.manual_seed(0)
    mask = torch.empty((*lead, n), dtype=torch.bool, device=DEV)
    flat = mask.view(-1, n)
    for i in range(flat.shape[0]):
        flat[i] = torch.rand(n, generator=g, device=DEV) < p_valid
    flat[0] = False
    flat[-1] = True
    return mask


def scan_bytes(args, k: int | None = None, *, cum: bool = True,
               hit: bool = True) -> float:
    """Bytes the op must move: each input read once (a broadcast input's
    storage once), each output written once (hit only when ``hit`` and the
    triples are given; cum only when ``cum`` and k is None)."""
    tr, va, spo, eq = args
    rows = va.numel()
    lead = va.numel() // va.shape[-1]
    n_bytes = va.untyped_storage().nbytes() if va.stride(0) == 0 else rows
    if tr is not None:
        n_bytes += tr.numel() * 4 + spo.numel() * 4 + (rows if hit else 0)
        n_bytes += 0 if eq is None else eq.numel()
    if k is None:
        return n_bytes + (rows * 4 if cum else 0)
    return n_bytes + lead * (k * 5 + 4)                       # idx, sel, total


def same_outputs(out, ref) -> int:
    """max_err over the outputs that kg_scan and its plain version give;
    fails unless both give the same ones (None alike)."""
    if [x is None for x in out] != [x is None for x in ref]:
        raise AssertionError("kg_scan gives other outputs than its plain "
                             "version")
    return max_err([x for x in out if x is not None],
                   [x for x in ref if x is not None])


def scan_check(args, caps=()) -> int:
    """scan_hits (with the triples also its hit-mask-only form) and
    scan_select at each cap (with the triples also without the hit mask)
    against their plain versions, bit for bit; returns the number of calls
    checked."""
    forms = [(dict(), dict())]
    if args[0] is not None:
        forms.append((dict(with_cum=False), dict(with_hit=False)))
    calls = 0
    for hits_kw, _ in forms:
        out = scan_ops.scan_hits(*args, **hits_kw)
        torch.cuda.synchronize()
        same_outputs(out, scan_hits_ref(*args, **hits_kw))
        calls += 1
    for cap in caps:
        for _, sel_kw in forms:
            o = scan_ops.scan_select(args[0], args[1], cap, *args[2:],
                                     **sel_kw)
            torch.cuda.synchronize()
            same_outputs(o, scan_select_ref(args[0], args[1], cap, *args[2:],
                                            **sel_kw))
            calls += 1
    return calls


def cum_route(mask, k: int):
    """The compaction of ``mask`` as the port's engine made it before
    scan_select: the prefix sum (scan_hits), then join_ranges over it for
    1..k (the first row whose count reaches j), clamped."""
    n = mask.shape[-1]
    cum = scan_ops.scan_hits(None, mask)[1]
    want = torch.arange(1, k + 1, dtype=torch.int32, device=mask.device)
    idx = join_ops.join_ranges(cum, want.expand(*mask.shape[:-1], k))[0]
    total = cum[..., -1]
    return (idx.clamp(0, n - 1),
            torch.arange(k, device=mask.device) < total[..., None], total)


def scan_sweep() -> int:
    """The ragged sweep: N around the plan's tile, 1 to 192 instances,
    broadcast and expanded leading dims, all-false and all-true masks,
    caps below, at and above an instance's hit count."""
    tile = scan_kernel.plan(36800, 24).tile_rows
    if tile != 8192:
        raise AssertionError(f"kg_scan's tile at 36,800 rows is {tile}")
    variants = (dict(), dict(gates=False, expand_valid=True),
                dict(mask_only=True), dict(mask_only=True, expand_valid=True))
    # ragged N at every instance count; then instances large enough that
    # the plan takes 2, 4 and 8 loads a thread
    cases = [(n, lead, kw)
             for n in (1, 9, 1000, 4096, tile - 1, tile, tile + 1,
                       3 * tile + 5)
             for lead in SCAN_LEADS for kw in variants]
    cases += [(n, (64, 3), kw) for n in (100003, 300007, 700001)
              for kw in variants[1:3]]
    vecs = {scan_kernel.plan(n, b * s).rows_per_thread // 16
            for n, (b, s), _ in cases}
    if vecs != {1, 2, 4, 8}:
        raise AssertionError(f"the kg_scan sweep takes {sorted(vecs)} loads "
                             f"a thread, not 1, 2, 4 and 8")
    checks = 0
    for n, lead, kw in cases:
        args = scan_args(lead, n, **kw)
        if lead == (8, 3) and n in (1000, tile + 1):
            # five leading dims: folded into one by a copy
            tr, va, spo, eq = args
            args = (tr, va.reshape(2, 2, 2, 1, 3, n),
                    None if spo is None else spo.reshape(2, 2, 2, 1, 1, 3),
                    None if eq is None else eq.reshape(2, 2, 2, 1, 1, 3))
        totals = scan_hits_ref(*args)[1][..., -1].reshape(-1)
        t = int(totals[totals.numel() // 2].item())
        checks += scan_check(args, sorted({1, max(t - 1, 1), max(t, 1),
                                           t + 1, n, n + 7}))
    return checks


def stress(fn, what: str) -> None:
    """SCAN_STRESS launches of fn back to back, each output equal to the
    first launch's: a race in a look-back would show as a difference."""
    first = [x for x in fn() if x is not None]
    diff = torch.zeros((), dtype=torch.int64, device=DEV)
    for _ in range(SCAN_STRESS - 1):
        for a, b in zip([x for x in fn() if x is not None], first):
            diff += (a != b).sum()
    if int(diff.item()) != 0:
        raise AssertionError(f"{what}: {int(diff.item())} values differ "
                             f"between {SCAN_STRESS} launches")
    log(f"  stress, {what}: {SCAN_STRESS} launches, each equal to the "
        f"first")


def scan_records() -> dict:
    """kg_scan's checks and timings: the sweep, the stress runs, each form
    at its path's shapes, and the earlier records' shapes for comparison."""
    t0 = time.perf_counter()
    checks = scan_sweep()
    log(f"  kg_scan ragged sweep: {checks} calls of scan_hits and "
        f"scan_select bit-identical to their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    rec = {}
    # the expand path's scans (phase 5, LUBM scale 0.1): the hit mask
    # alone, as the step's cap covers the shard, over 8 padded requests x
    # 3 shards of 512 rows
    args = scan_args((8, 3), 512)
    err = same_outputs(scan_ops.scan_hits(*args, with_cum=False),
                       scan_hits_ref(*args, with_cum=False))
    b_ms, b_by = bound(scan_bytes(args, cum=False), args[1].numel() * 20)
    rec["scan_hits"] = dict(
        name="kg_scan.scan_hits", route="cuda",
        source="src/repro_torch/csrc/kg_scan.cu",
        replaces="src/repro/kernels/kg_scan/kernel.py:51",
        max_abs_err=err,
        ms=time_ms(lambda: scan_ops.scan_hits(*args, with_cum=False)),
        plain_ms=time_ms(lambda: scan_hits_ref(*args, with_cum=False)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  kg_scan.scan_hits, hit mask only (24 x 512 rows): "
        f"{rec['scan_hits']}")
    # predicate mode with its prefix sum at bucket 4's first scan at
    # LUBM(1), the earlier records' shape: 8 padded requests x 3 shards of
    # 36,800 rows
    args = scan_args((8, 3), 36800)
    err = same_outputs(scan_ops.scan_hits(*args), scan_hits_ref(*args))
    log(f"  kg_scan.scan_hits predicate mode (24 x 36800 rows): err={err} "
        f"ms={time_ms(lambda: scan_ops.scan_hits(*args)):.4f} "
        f"plain_ms={time_ms(lambda: scan_hits_ref(*args)):.4f} "
        f"bound_ms="
        f"{bound(scan_bytes(args), args[1].numel() * 20)[0]:.4f}")
    # the main path's select there, at the step's cap, without the hit mask
    k = 1024
    tr, va, spo, eq = args
    err = same_outputs(
        scan_ops.scan_select(tr, va, k, spo, eq, with_hit=False),
        scan_select_ref(tr, va, k, spo, eq, with_hit=False))
    sel_ms = time_ms(lambda: scan_ops.scan_select(tr, va, k, spo, eq,
                                                  with_hit=False))
    plain_ms = time_ms(lambda: scan_select_ref(tr, va, k, spo, eq,
                                               with_hit=False))
    b_ms, _ = bound(scan_bytes(args, k, hit=False), va.numel() * 20)
    log(f"  kg_scan.scan_select (24 x 36800 rows, k {k}, no hit mask): "
        f"err={err} ms={sel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={b_ms:.4f}")
    big = scan_args((64, 3), 36800)
    stress(lambda: scan_ops.scan_hits(*big),
           "kg_scan scan_hits, predicate mode, 192 x 36800")
    stress(lambda: scan_ops.scan_select(big[0], big[1], 16384, *big[2:]),
           "kg_scan scan_select, predicate mode, 192 x 36800, k 16384")
    del big

    # bucket 4's pair masks as the main path compacts them: 8 padded
    # requests x 3 shards, R = 32,768 kept of each; beside it the route the
    # engine took before (the prefix sum, then join_ranges over it)
    mask = random_mask(PAIR_LEAD, PAIR_ROWS)
    args = (None, mask, None, None)
    out = scan_ops.scan_select(None, mask, PAIR_K)
    torch.cuda.synchronize()
    err = same_outputs(out, scan_select_ref(None, mask, PAIR_K))
    max_err(cum_route(mask, PAIR_K), out[1:])
    del out
    b_ms, b_by = bound(scan_bytes(args, PAIR_K), mask.numel() * 2)
    rec["scan_select"] = dict(
        name="kg_scan.scan_select", route="cuda",
        source="src/repro_torch/csrc/kg_scan.cu",
        replaces="src/repro/kernels/kg_scan/kernel.py:51",
        max_abs_err=err,
        ms=time_ms(lambda: scan_ops.scan_select(None, mask, PAIR_K)),
        plain_ms=time_ms(lambda: scan_select_ref(None, mask, PAIR_K),
                         reps=2, warm=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  kg_scan.scan_select ({PAIR_LEAD[0] * PAIR_LEAD[1]} x "
        f"{PAIR_ROWS}, k {PAIR_K}): {rec['scan_select']}")
    cum_route_ms = time_ms(lambda: cum_route(mask, PAIR_K), reps=10)
    log(f"  the cum route at the same shape (scan_hits prefix mode, then "
        f"join_ranges over cum for 1..k; equal to scan_select): "
        f"ms={cum_route_ms:.4f}; scan_select / cum route "
        f"{rec['scan_select']['ms'] / cum_route_ms:.3f}")
    stress(lambda: scan_ops.scan_select(None, mask, PAIR_K),
           f"kg_scan scan_select, mask, {PAIR_LEAD[0] * PAIR_LEAD[1]} x "
           f"{PAIR_ROWS}, k {PAIR_K}")
    # bucket 4's other pair mask (step 2): checked and timed
    step2 = random_mask(PAIR_LEAD, PAIR_ROWS_STEP2)
    err = same_outputs(scan_ops.scan_select(None, step2, PAIR_K),
                       scan_select_ref(None, step2, PAIR_K))
    ms = time_ms(lambda: scan_ops.scan_select(None, step2, PAIR_K))
    b_ms, _ = bound(scan_bytes((None, step2, None, None), PAIR_K),
                    step2.numel() * 2)
    log(f"  kg_scan.scan_select ({PAIR_LEAD[0] * PAIR_LEAD[1]} x "
        f"{PAIR_ROWS_STEP2}, k {PAIR_K}): err={err} ms={ms:.4f} "
        f"bound_ms={b_ms:.4f}")
    del step2

    # the prefix mode over one request's pair masks (the earlier records')
    one = mask[:1]
    args = (None, one, None, None)
    err = same_outputs(scan_ops.scan_hits(*args), scan_hits_ref(*args))
    b_ms, _ = bound(scan_bytes(args), one.numel() * 2)
    ms = time_ms(lambda: scan_ops.scan_hits(*args))
    plain_ms = time_ms(lambda: scan_hits_ref(*args), reps=5, warm=1)
    lib_ms = time_ms(lambda: torch.cumsum(one, -1, dtype=torch.int32),
                     reps=5, warm=1)
    log(f"  kg_scan.scan_hits prefix mode (3 x {PAIR_ROWS}): err={err} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} torch.cumsum_ms={lib_ms:.4f} "
        f"bound_ms={b_ms:.4f}")
    stress(lambda: scan_ops.scan_hits(*args),
           f"kg_scan scan_hits, prefix mode, 3 x {PAIR_ROWS}")
    # the select mode there too, beside the route without it
    err = same_outputs(scan_ops.scan_select(None, one, PAIR_K),
                       scan_select_ref(None, one, PAIR_K))
    ms = time_ms(lambda: scan_ops.scan_select(None, one, PAIR_K))
    route_ms = time_ms(lambda: cum_route(one, PAIR_K), reps=10)
    b_ms, _ = bound(scan_bytes(args, PAIR_K), one.numel() * 2)
    log(f"  kg_scan.scan_select (3 x {PAIR_ROWS}, k {PAIR_K}): err={err} "
        f"ms={ms:.4f} bound_ms={b_ms:.4f}; the cum route ms={route_ms:.4f}")
    del mask, one, args
    torch.cuda.empty_cache()
    return rec


def sorted_keys(shape, hi_key: int, hubs: int = 0) -> torch.Tensor:
    """Match keys (…, C) drawn from [-1, hi_key), 20% INT_MAX padding,
    sorted per block on the card; ``hubs`` keys of each block set to 7 (a
    row key of 7 then has that fan-out there)."""
    keys = RNG.integers(-1, hi_key, shape).astype(np.int32)
    if hubs:
        keys[..., :hubs] = 7
    keys = np.where(RNG.uniform(size=shape) < 0.2, 2**31 - 1, keys)
    return torch.sort(dev(keys.astype(np.int32)), dim=-1)[0]


def join_args(lead, keys_lead, sb: int, c: int, r: int, hi_key: int,
              hubs: int = 0):
    """join_select's arguments as the engine passes them: keys
    (*keys_lead, sb, c) broadcast to ``lead`` (requests, shards), rkey and
    tmask (*lead, r) with -1 among the row keys. The first instance's rows
    are all dead and the last one's all live."""
    keys = sorted_keys((*keys_lead, sb, c), hi_key, hubs)
    rkey = RNG.integers(-1, hi_key + 3, (*lead, r)).astype(np.int32)
    rkey.reshape(-1)[::997] = 7
    tmask = RNG.uniform(size=(*lead, r)) < 0.7
    tmask.reshape(-1, r)[0] = False
    tmask.reshape(-1, r)[-1] = True
    return keys, dev(rkey), dev(tmask)


def join_check(keys, rkey, tmask, fans) -> int:
    """join_ranges (also as (…, C) keys for one block) and join_select,
    at each fan-out cap and at caps 1, around an
    instance's total, R and R * S_b * K, bit for bit against their plain
    versions; returns the number of calls checked."""
    sb, r = keys.shape[-2], rkey.shape[-1]
    # join_ranges tells (…, S_b, C) keys by their rank: a stride-0 view
    full = keys.expand(*rkey.shape[:-1], *keys.shape[-2:])
    out = join_ops.join_ranges(full, rkey)
    torch.cuda.synchronize()
    max_err(out, join_ranges_ref(full, rkey))
    calls = 1
    if sb == 1:
        k1 = full[..., 0, :]
        max_err(join_ops.join_ranges(k1, rkey), join_ranges_ref(k1, rkey))
        calls += 1
    for fan in fans:
        n = r * sb * fan
        totals = join_select_ref(keys, rkey, tmask, fan, n)[4].reshape(-1)
        t = int(totals[totals.numel() // 2].item())
        for cap in sorted({1, max(t - 1, 1), max(t, 1), t + 1, r, n}):
            ref = join_select_ref(keys, rkey, tmask, fan, cap)
            o = join_ops.join_select(keys, rkey, tmask, fan, cap)
            torch.cuda.synchronize()
            max_err(o, ref)
            calls += 1
    return calls


def join_sweep() -> int:
    """The ragged sweep: C from 1 to past the shared-memory budget (the
    splitter route), S_b 1 and 3, R off the tiles, keys broadcast over the
    requests or over every instance, fan-out caps 1, 3 and 64."""
    budget = join_kernel.KEY_BUDGET
    routes, calls = set(), 0
    for c in (1, 9, 1000, budget - 1, budget, budget + 1, 65536):
        for sb in (1, 3):
            for lead, keys_lead, r in (((1, 3), (1, 3), 77),
                                       ((8, 3), (1, 3), 1000),
                                       ((8, 3), (3,), 257),
                                       ((2, 3), (2, 3), 4097)):
                n_inst = lead[0] * lead[1]
                routes.add(join_kernel.plan(n_inst, sb, c, r).route)
                args = join_args(lead, keys_lead, sb, c, r,
                                 hi_key=max(c // 4, 4), hubs=min(c // 2, 64))
                calls += join_check(*args, fans=(1, 3, 64))
    if routes != {"shared", "splitter"}:
        raise AssertionError(f"the kg_join sweep takes routes {routes}")
    return calls


def ranges_case(n_inst: int, sb: int, c: int, r: int):
    keys = sorted_keys((n_inst, sb, c), 4000)
    rkey = dev(RNG.integers(-1, 4100, (n_inst, r)).astype(np.int32))
    out = join_ops.join_ranges(keys, rkey)
    torch.cuda.synchronize()
    err = max_err(out, join_ranges_ref(keys, rkey))
    searches = n_inst * sb * r
    n_bytes = n_inst * sb * c * 4 + n_inst * r * 4 + 2 * searches * 4
    n_ops = searches * 2 * int(np.ceil(np.log2(c + 1))) * 3
    return (keys, rkey), err, bound(n_bytes, n_ops)


def mask_route(keys, rkey, tmask, fan: int, cap: int):
    """The merge join's expansion and semijoin as the engine made them
    before join_select: join_ranges, the counts, the (row, block, slot)
    pair mask, scan_select of it and its .any."""
    lo, hi = join_ops.join_ranges(keys, rkey)
    counts = torch.where(tmask[..., None, :], hi - lo, 0)
    pair = pair_mask(counts, fan)
    sel = scan_ops.scan_select(None, pair.reshape(*pair.shape[:-2], -1), cap)
    return lo, counts, sel, pair.any(dim=-1)


def join_records() -> dict:
    """kg_join's sweep, its search at the merge steps' shapes (the earlier
    records' data), and join_select at bucket 4's steps 3 and 2: checked,
    timed beside its plain version and the mask route it replaces; 100
    launches at step 3 each equal to the first."""
    t0 = time.perf_counter()
    calls = join_sweep()
    log(f"  kg_join ragged sweep: {calls} calls of join_ranges and "
        f"join_select bit-identical to their plain "
        f"versions ({time.perf_counter() - t0:.1f} s)")
    rec = {}
    n_inst = PAIR_LEAD[0] * PAIR_LEAD[1]
    (keys, rkey), err, (b_ms, b_by) = ranges_case(n_inst, 3, JOIN_C, JOIN_R)
    rk = rkey[:, None, :].expand(n_inst, 3, JOIN_R).contiguous()

    def library():
        return (torch.searchsorted(keys, rk, side="left", out_int32=True),
                torch.searchsorted(keys, rk, side="right", out_int32=True))

    p = join_kernel.plan(n_inst, 3, JOIN_C, JOIN_R)
    rec["join_ranges"] = dict(
        name="kg_join.join_ranges", route="cuda",
        source="src/repro_torch/csrc/kg_join.cu",
        replaces="src/repro/kernels/kg_join/kernel.py:62",
        max_abs_err=err,
        ms=time_ms(lambda: join_ops.join_ranges(keys, rkey)),
        plain_ms=time_ms(lambda: join_ranges_ref(keys, rkey)),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library),
        kernel_ms=kernel_ms(lambda: join_ops.join_ranges(keys, rkey)))
    log(f"  kg_join.join_ranges ({n_inst} x 3 x {JOIN_C} keys, {JOIN_R} "
        f"rows; route {p.route}, {join_kernel.THREADS} threads x "
        f"{p.ranges.rows_per_thread} rows, {p.ranges.blocks} blocks): "
        f"{rec['join_ranges']}")
    # spread: the kernel and the two searchsorted calls in alternation,
    # 5 rounds of 25 calls each
    spread = {"join_ranges": [], "searchsorted x2": []}
    for _ in range(5):
        spread["join_ranges"].append(
            time_ms(lambda: join_ops.join_ranges(keys, rkey)))
        spread["searchsorted x2"].append(time_ms(library))
    log("  join_ranges spread over 5 rounds of 25 calls, in alternation: "
        + "; ".join(f"{name} median {np.median(v):.4f} ms, rounds "
                    f"{[round(x, 4) for x in v]}, spread (max - min) / median "
                    f"{(max(v) - min(v)) / np.median(v):.1%}"
                    for name, v in spread.items())
        + "; kernel / library "
        f"{np.median(spread['join_ranges']) / np.median(spread['searchsorted x2']):.3f}")
    del rk
    # the PPN-local merge steps (one key block), and bucket 4's step 5,
    # whose 65,536 keys a block take the splitter route
    for sb, c in ((1, JOIN_C), (3, 65536)):
        (k1, r1), err, (b1, _) = ranges_case(n_inst, sb, c, JOIN_R)
        log(f"  kg_join.join_ranges ({n_inst} x {sb} x {c} keys, {JOIN_R} "
            f"rows; route {join_kernel.plan(n_inst, sb, c, JOIN_R).route}): "
            f"err={err} ms={time_ms(lambda: join_ops.join_ranges(k1, r1)):.4f}"
            f" bound_ms={b1:.4f}")

    for step, (lead, sb, c, r, fan) in JOIN_STEPS.items():
        keys, rkey, tmask = join_args(lead, lead, sb, c, r, hi_key=12 * c,
                                      hubs=min(c // 2, 64))
        n_inst = lead[0] * lead[1]
        ref = join_select_ref(keys, rkey, tmask, fan, r)
        out = join_ops.join_select(keys, rkey, tmask, fan, r)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        route = mask_route(keys, rkey, tmask, fan, r)
        max_err(route[:2] + route[2][1:], ref)
        totals = ref[4]
        del ref, out, route
        searches = n_inst * sb * r
        n_bytes = (keys.numel() * 4 + rkey.numel() * 4 + tmask.numel()
                   + 2 * searches * 4 + n_inst * (r * 5 + 4))
        b_ms, b_by = bound(n_bytes,
                           searches * 2 * int(np.ceil(np.log2(c + 1))) * 3)

        def call():
            return join_ops.join_select(keys, rkey, tmask, fan, r)

        rec_step = dict(
            name="kg_join.join_select", route="cuda",
            source="src/repro_torch/csrc/kg_join.cu",
            replaces="src/repro/kernels/kg_join/kernel.py:62",
            max_abs_err=err, ms=time_ms(call),
            plain_ms=time_ms(lambda: join_select_ref(keys, rkey, tmask, fan,
                                                     r), reps=3, warm=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            kernel_ms=kernel_ms(call))
        route_ms = time_ms(lambda: mask_route(keys, rkey, tmask, fan, r),
                           reps=10)
        log(f"  kg_join.join_select at {step} ({n_inst} x {sb} x {c} keys, "
            f"{r} rows, K {fan}, cap {r}; totals {int(totals.min())}-"
            f"{int(totals.max())}): {rec_step}; the route it replaces "
            f"(join_ranges, pair mask, scan_select, .any) ms={route_ms:.4f}")
        if step == "bucket 4 step 3":
            rec["join_select"] = rec_step
            stress(call, f"kg_join join_select at {step}")
        del keys, rkey, tmask
    torch.cuda.empty_cache()
    return rec


def compat_args(lead, r: int, v: int, c: int, *, hi: int = 20,
                engine: bool = False):
    """compat_matrix's arguments over ``lead`` instances: values from
    [-1, hi), 70% live masks, kind from {0, 1, 2}, col from [-1, V + 1).
    With ``engine`` (lead (requests, shards)) the matches are shared by the
    requests and kind and col by the shards, as the engine passes them. The
    first instance has no live row."""
    lm = (1, lead[1]) if engine else lead
    lk = (lead[0], 1) if engine else lead
    tmask = RNG.uniform(size=(*lead, r)) < 0.7
    tmask.reshape(-1, r)[0] = False
    return (dev(RNG.integers(-1, hi, (*lead, r, v)).astype(np.int32)),
            dev(tmask),
            dev(RNG.integers(-1, hi, (*lm, c, 3)).astype(np.int32)),
            dev(RNG.uniform(size=(*lm, c)) < 0.7),
            dev(RNG.integers(0, 3, (*lk, 3)).astype(np.int32)),
            dev(RNG.integers(-1, v + 1, (*lk, 3)).astype(np.int32)))


def compat_bound(args, cap: int, *, matrix: bool) -> tuple[float, str]:
    """The compat launch's bound on this run's inputs: bytes (the inputs
    read once; the R x C matrix, or keep, the k slots and total written)
    against its pair tests, one integer compare a used position of a live
    pair (at least one a pair) at the card's int32 rate."""
    table, tmask, matches, mmask, kind, _ = args
    lead = torch.broadcast_shapes(table.shape[:-2], matches.shape[:-2],
                                  kind.shape[:-1])
    r, c = table.shape[-2], matches.shape[-2]
    n_inst = int(np.prod(lead))
    n_in = sum(t.numel() * t.element_size() for t in args)
    n_out = (n_inst * r * c if matrix
             else n_inst * (r + min(cap, r * c) * 5 + 4))
    used = (kind.expand(*lead, 3) == 1).sum(-1).clamp(min=1)
    live = (tmask.expand(*lead, r).sum(-1)
            * mmask.expand(*lead, c).sum(-1))
    n_ops = int((used.to(torch.int64) * live.to(torch.int64)).sum().item())
    return bound(n_in + n_out, n_ops, INT32_OPS_PER_S)


def compat_check(args, caps) -> int:
    """compat_matrix and compat_select at each cap, bit for bit against
    their plain versions; returns the number of calls checked."""
    out = join_ops.compat_matrix(*args)
    torch.cuda.synchronize()
    max_err([out], [compat_matrix_ref(*args)])
    for cap in caps:
        o = join_ops.compat_select(*args, cap)
        torch.cuda.synchronize()
        max_err(o, compat_select_ref(*args, cap))
    return 1 + len(caps)


def compat_caps(args) -> list[int]:
    """Caps 0, 1, around the middle instance's total, R, R * C and past."""
    r, c = args[0].shape[-2], args[2].shape[-2]
    totals = compat_select_ref(*args, 1)[3].reshape(-1)
    t = int(totals[totals.numel() // 2].item())
    return sorted({0, 1, max(t - 1, 1), max(t, 1), t + 1, r, r * c,
                   r * c + 7})


def compat_sweep() -> int:
    """The ragged sweep: R off the 32-row tiles, C off the 256-column
    segments (past 8 and 64 of them), V 1 to 6, dense and sparse pairs,
    one instance, (3,) and the engine's broadcast (8, 3), at every plan
    shape of blocks and segments the sweep reaches."""
    calls, shapes = 0, set()
    for lead, engine in (((1,), False), ((3,), False), ((8, 3), True)):
        for r, v, c in ((1, 1, 1), (33, 4, 64), (200, 1, 17), (77, 3, 255),
                        (513, 6, 257), (40, 2, 1000), (65, 5, 3000),
                        (2100, 4, 2600), (7, 3, 20000)):
            for hi in (3, 40):
                args = compat_args(lead, r, v, c, hi=hi, engine=engine)
                n_inst = int(np.prod(lead))
                p = join_kernel.compat_plan(n_inst, r, c, v)
                shapes.add((p.tiles_per_block, p.chunk_segments))
                calls += compat_check(args, compat_caps(args))
    if len(shapes) < 5:
        raise AssertionError(f"the compat sweep takes plan shapes {shapes}")
    return calls


def parent_route(args, cap: int):
    """The expand join's selection as the engine made it before
    compat_select: compat_matrix, scan_select of the flattened matrix, and
    the semijoin's .any."""
    m = join_ops.compat_matrix(*args)
    r, c = m.shape[-2:]
    sel = scan_ops.scan_select(None, m.reshape(*m.shape[:-2], r * c), cap)
    return args[1] & m.any(dim=-1), sel


def compat_records() -> dict:
    """compat_matrix and compat_select: the ragged sweep, then both shapes
    of COMPAT_SHAPES with caps below and above the totals, 100 launches of
    compat_select at the expand path's shape each equal to the first; each
    timed (events and device time) beside its plain version, and
    compat_select beside the route it replaces."""
    join_ops.compat_matrix.launches = 0
    t0 = time.perf_counter()
    calls = compat_sweep()
    log(f"  kg_join compat ragged sweep: {calls} calls of compat_matrix and "
        f"compat_select bit-identical to their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")
    rec = {}
    for name, (n_inst, r, v, c, cap) in COMPAT_SHAPES.items():
        args = compat_args((n_inst,), r, v, c)
        p = join_kernel.compat_plan(n_inst, r, c, v)
        checked = compat_check(args, compat_caps(args) + [cap])
        totals = compat_select_ref(*args, cap)[3]
        m_by = compat_bound(args, cap, matrix=True)
        s_by = compat_bound(args, cap, matrix=False)
        mrec = dict(
            name="kg_join.compat_matrix", route="cuda",
            source="src/repro_torch/csrc/kg_compat.cu",
            replaces="src/repro/kernels/kg_join/kernel.py:111",
            max_abs_err=0,
            ms=time_ms(lambda: join_ops.compat_matrix(*args)),
            plain_ms=time_ms(lambda: compat_matrix_ref(*args), reps=5),
            bound_ms=m_by[0], bound_by=m_by[1], library_ms=None,
            kernel_ms=kernel_ms(lambda: join_ops.compat_matrix(*args)))

        def call():
            return join_ops.compat_select(*args, cap)

        srec = dict(
            name="kg_join.compat_select", route="cuda",
            source="src/repro_torch/csrc/kg_compat.cu",
            replaces="src/repro/kernels/kg_join/kernel.py:111",
            max_abs_err=0, ms=time_ms(call),
            plain_ms=time_ms(lambda: compat_select_ref(*args, cap), reps=5),
            bound_ms=s_by[0], bound_by=s_by[1], library_ms=None,
            kernel_ms=kernel_ms(call))
        route_ms = time_ms(lambda: parent_route(args, cap))
        route_kms = kernel_ms(lambda: parent_route(args, cap))
        log(f"  compat_select's launches at the {name} shape, one call "
            f"profiled: {device_breakdown(call)}")
        log(f"  kg_join compat at the {name} shape ({n_inst} x {r} rows x "
            f"{c} columns, V {v}, cap {cap}; plan {p.tiles_per_block} tiles "
            f"x {p.chunk_segments} segments a block, {p.blocks} blocks; "
            f"totals {int(totals.min())}-{int(totals.max())}; {checked} "
            f"calls bit-identical): compat_matrix {mrec}; compat_select "
            f"{srec}; the route it replaces (compat_matrix, scan_select, "
            f".any) ms={route_ms:.4f} kernel_ms={route_kms:.4f}")
        if name == "expand path":
            rec["compat_matrix"], rec["compat_select"] = mrec, srec
            # compat_matrix has no path (phase 5 asserts it): its launches
            # are those of these checks, read before the timing
            mrec["launches"] = join_ops.compat_matrix.launches
            stress(call, f"kg_join compat_select at the {name} shape")
        del args
    torch.cuda.empty_cache()
    return rec


def jaccard_case(m_np: np.ndarray):
    m = dev(m_np)
    out = jac_ops.jaccard_distance(m)
    torch.cuda.synchronize()
    err = float_err(out, jaccard_distance_ref(m), exact=True)
    if not torch.equal(out, out.T):
        raise AssertionError("jaccard_distance is not exactly symmetric")
    q, f = m.shape
    # Q x F read, Q x Q written; the product of 0/1 operands is exact on
    # int8 tensor cores and its output symmetric: Q (Q + 1) / 2 dot
    # products of F multiply-adds
    return m, err, bound(4 * q * f + 4 * q * q, q * (q + 1) * f,
                         INT8_TC_OPS_PER_S)


def gather_case(table: torch.Tensor, ids_np: np.ndarray):
    ids = dev(ids_np.astype(np.int32))
    out = emb_ops.gather_rows(table, ids)
    torch.cuda.synchronize()
    err = float_err(out, gather_rows_ref(table, ids), exact=True)
    n, d = ids.shape[0], table.shape[1]
    # the ids, the distinct rows they name, the output
    rows = torch.unique(ids).numel()
    return ids, err, bound(4 * n + 4 * rows * d + 4 * n * d, 0)


def cin_plain(xk, x0, w, layer=cin_layer_ref) -> torch.Tensor:
    """A plain CIN layer over batch chunks of PLAIN_CHUNK, as plain_forward
    runs it: the plain version materializes (chunk, H, F, D)."""
    return torch.cat([layer(xk[i:i + PLAIN_CHUNK], x0[i:i + PLAIN_CHUNK], w)
                      for i in range(0, xk.shape[0], PLAIN_CHUNK)])


def cin_inputs(b: int, h: int, f: int, d: int, k: int):
    """xk (b, h, d), x0 (b, f, d) normal, w (k, h, f) normal / sqrt(h f):
    from the numpy RNG, or made on the card (seed 3) past 10^7 values."""
    if b * h * d <= 10**7:
        return (dev(RNG.normal(size=(b, h, d)).astype(np.float32)),
                dev(RNG.normal(size=(b, f, d)).astype(np.float32)),
                dev((RNG.normal(size=(k, h, f))
                     / np.sqrt(h * f)).astype(np.float32)))
    gen = torch.Generator(device=DEV).manual_seed(3)
    return (torch.randn((b, h, d), generator=gen, device=DEV),
            torch.randn((b, f, d), generator=gen, device=DEV),
            torch.randn((k, h, f), generator=gen, device=DEV)
            / math.sqrt(h * f))


def cin_case(b: int, h: int, f: int, d: int, k: int, split: bool = False):
    """One CIN layer on random inputs against its plain version (chunked)
    at CIN_TOL, and with ``split`` also against the plain version of the
    kernel's split arithmetic. The bound: three bf16 products of
    2 B K D H F operations each at the bf16 tensor-core rate (the least
    float32-accurate work at this tolerance), or the bytes."""
    xk, x0, w = cin_inputs(b, h, f, d, k)
    out = cin_ops.cin_layer(xk, x0, w)
    torch.cuda.synchronize()
    err = float_err(out, cin_plain(xk, x0, w), **CIN_TOL)
    if split:
        float_err(out, cin_layer_split_ref(xk, x0, w), **CIN_TOL)
    n_bytes = 4 * (b * h * d + b * f * d + k * h * f + b * k * d)
    return (xk, x0, w), err, bound(n_bytes, 3 * 2 * b * k * d * h * f,
                                   BF16_TC_OPS_PER_S)


def cin_record(shape: str) -> dict:
    """cin_layer at the xDeepFM forward's three layers at one served batch:
    each checked (cin_case), its plan asserted (CIN_PLANS), and timed
    against the plain layer and one einsum, both over PLAIN_CHUNK-row
    chunks; returns the three layers summed."""
    cfg = xdeepfm_configs.full()
    b, d = xdeepfm_configs.SERVE_BATCH[shape], cfg.embed_dim
    reps, plain_reps = (REPS, REPS) if shape == "serve_p99" else (5, 3)

    def einsum(xk, x0, w):
        return torch.einsum("bhd,khf,bfd->bkd", xk, w, x0)

    layers, h_prev = [], cfg.n_sparse
    for k in cfg.cin_layers:
        f = cfg.n_sparse
        p = cin_kernel.plan(b, h_prev, f, d, k)
        if (p.rows, p.cols) != CIN_PLANS[shape]:
            raise AssertionError(f"cin at {shape} layer {len(layers) + 1} "
                                 f"took {p}, not {CIN_PLANS[shape]}")
        (xk, x0, w), err, (b_ms, b_by) = cin_case(b, h_prev, f, d, k)
        layer = dict(
            err=err, ms=time_ms(lambda: cin_ops.cin_layer(xk, x0, w), reps),
            plain_ms=time_ms(lambda: cin_plain(xk, x0, w), plain_reps),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: cin_plain(xk, x0, w, einsum),
                               plain_reps),
            float32_bound_ms=2 * b * k * d * h_prev * f / OPS_PER_S * 1e3)
        log(f"  cin.cin_layer {shape} layer {len(layers) + 1} (B {b:,}, H "
            f"{h_prev}, F {f}, D {d}, K {k}; rows {p.rows}, cols {p.cols}, "
            f"{p.blocks:,} blocks, {p.stages} stages): {layer}")
        layers.append(layer)
        h_prev = k
        del xk, x0, w
    by = {la["bound_by"] for la in layers}
    rec = dict(
        name=f"cin.cin_layer[{shape}]", route="cuda",
        source="src/repro_torch/csrc/cin.cu",
        replaces="src/repro/kernels/cin/kernel.py:42",
        max_abs_err=max(la["err"] for la in layers),
        **{key: sum(la[key] for la in layers)
           for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                       "float32_bound_ms")},
        bound_by=by.pop() if len(by) == 1 else "operations")
    log(f"  cin.cin_layer, {shape}'s three layers summed (bound: three bf16 "
        f"products at 989 TFLOP/s; float32_bound_ms: one product at the "
        f"float32 CUDA-core rate): {rec}")
    torch.cuda.empty_cache()
    return rec


def flash_bound(q, k, q_start: int, causal: bool = True):
    """The least time of one attention call: its operations (QK^T and PV,
    2 multiply-adds, 4 d operations per visible (row, key) pair, counted
    for the keys each row sees) at the dtype's tensor-core rate (float32 at
    its CUDA-core rate: TF32 would not meet the tolerance), or its bytes
    (q and out once, the K and V rows the rows see once)."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if causal:
        pairs = int(np.minimum(t, q_start + np.arange(s) + 1).sum())
        kv_rows = min(t, q_start + s)
    else:
        pairs, kv_rows = s * t, t
    n_bytes = q.element_size() * (2 * b * h * s * d + 2 * b * hkv * kv_rows * d)
    rate = BF16_TC_OPS_PER_S if q.dtype == torch.bfloat16 else OPS_PER_S
    return bound(n_bytes, 4 * b * h * d * pairs, rate)


def flash_case(b, hkv, g, s, t, d, dt, causal: bool, q_start: int, *,
               cache_layout: bool = False, chunk: int | None = None,
               route: str | None = None) -> float:
    """Max |diff| of q (b, hkv g, s, d) over k/v (b, hkv, t, d) against
    the plain version; fails beyond FLASH_TOL. ``cache_layout`` hands the
    kernel what the model does: q from (b, s, h, d) storage and k/v from a
    (b, t, hkv, d) cache, both transposed views. A ``chunk`` forces the
    split route with chunks of that many keys (launched through the
    kernel's wrapper, not the op), also held against the split path's
    plain version; a ``route`` must be the one the plan picks."""
    def randn(*shape):
        return torch.randn(shape, device=DEV).to(dt)
    if cache_layout:
        q = randn(b, s, hkv * g, d).transpose(1, 2)
        k = randn(b, t, hkv, d).transpose(1, 2)
        v = randn(b, t, hkv, d).transpose(1, 2)
    else:
        q, k, v = randn(b, hkv * g, s, d), randn(b, hkv, t, d), \
            randn(b, hkv, t, d)
    plan = fa_kernel.plan(q, k, v, causal=causal, q_start=q_start,
                          chunk=chunk)
    if route is not None and plan.route != route:
        raise AssertionError(f"flash_attention {(b, hkv, g, s, t, d)} "
                             f"{dt} took {plan}, not route {route}")
    if chunk is None:
        out = fa_ops.flash_attention(q, k, v, causal=causal, q_start=q_start)
    else:
        out = fa_kernel.flash_attention_kernel(
            q, k, v, causal=causal, scale=1.0 / math.sqrt(d),
            q_start=q_start, route=plan)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, causal=causal, q_start=q_start)
    if chunk is not None:
        float_err(out.float(), attention_split_ref(
            q, k, v, chunk=chunk, causal=causal, q_start=q_start).float(),
            **FLASH_TOL[dt])
    if out.dtype != ref.dtype:
        raise AssertionError(f"flash_attention returned {out.dtype}, plain "
                             f"{ref.dtype}")
    return float_err(out.float(), ref.float(), **FLASH_TOL[dt])


def flash_sweep() -> dict:
    """Ragged shapes: S and T off the 64-row tiles, G = H / Hkv in
    {1, 4, 48}, causal and not, float32 and bfloat16, q_start at 0, T - S
    and a value mid-tile, head dims the 8-byte copies cannot take (6, 7:
    element loads), and the model's strided cache layout. Returns the
    largest |diff| per dtype."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    shapes = [(1, 2, 1, 64, 64, 16), (2, 2, 4, 96, 200, 32),
              (1, 1, 48, 33, 70, 16), (1, 4, 1, 40, 40, 8),
              (2, 3, 4, 70, 133, 128), (1, 1, 48, 1, 200, 128),
              (3, 2, 4, 1, 77, 128), (1, 2, 48, 5, 300, 64),
              (1, 1, 1, 1, 1, 128), (2, 2, 4, 130, 130, 100),
              (1, 2, 4, 50, 90, 6), (1, 1, 4, 17, 31, 7)]
    n = 0
    for (b, hkv, g, s, t, d) in shapes:
        for dt in worst:
            starts = sorted({0, t - s, (t - s) // 2 + 3})
            for causal, q_start in [(True, q) for q in starts if q >= 0] \
                    + [(False, 0)]:
                for layout in (False, True):
                    err = flash_case(b, hkv, g, s, t, d, dt, causal,
                                     q_start, cache_layout=layout)
                    worst[dt] = max(worst[dt], err)
                    n += 1
    log(f"  flash_attention ragged sweep: {n} cases within the plain "
        f"version's float32 atol 2e-5 and bfloat16 atol 1e-4 + 2**-7 |plain| "
        f"(max |diff| float32 {worst[torch.float32]:.3g}, "
        f"bfloat16 {worst[torch.bfloat16]:.3g})")
    return worst


def flash_route_cases() -> None:
    """Each route beyond the ragged sweep. The split route forced at small
    T: several chunks, the last one ragged (down to 1 key), chunks wholly
    past the limit of a causal row, d 100 and 7 (8-byte and element
    copies). The tensor-core routes: "wgmma" at T off the 64-key tile,
    d 64, G 48 and the q heads of a tensor-parallel prefill rank (G 12
    and 3 over one KV head), "mma" at d 100 (zero-filled to 112, 8-byte
    copies) and at T under one tile."""
    split = [(2, 2, 4, 1, 300, 128, True, 290, 64),
             (1, 2, 1, 16, 200, 64, True, 50, 64),
             (2, 1, 4, 3, 257, 100, False, 0, 64),
             (1, 1, 16, 1, 130, 7, True, 129, 32),
             (1, 3, 2, 8, 1000, 128, True, 500, 256)]
    tc = [(2, 2, 4, 130, 200, 100, True, 70, "mma"),
          (1, 2, 4, 40, 50, 128, True, 10, "mma"),
          (1, 1, 2, 300, 333, 128, True, 33, "wgmma"),
          (1, 2, 4, 77, 77, 128, False, 0, "wgmma"),
          (1, 1, 48, 5, 300, 64, True, 295, "wgmma"),
          (2, 2, 1, 200, 200, 128, True, 0, "wgmma"),
          # a tensor-parallel prefill rank's heads: granite-20b's 12 q
          # heads over its one KV head on 4 model ranks, nemotron-4-15b's
          # 3 over one of its 8 KV heads on 16
          (1, 1, 12, 300, 300, 128, True, 0, "wgmma"),
          (2, 1, 3, 200, 200, 128, True, 0, "wgmma")]
    worst = {}
    for (b, hkv, g, s, t, d, causal, q_start, chunk) in split:
        for dt in (torch.float32, torch.bfloat16):
            for layout in (False, True):
                err = flash_case(b, hkv, g, s, t, d, dt, causal, q_start,
                                 cache_layout=layout, chunk=chunk)
                worst[("split", dt)] = max(worst.get(("split", dt), 0.0),
                                           err)
    for (b, hkv, g, s, t, d, causal, q_start, route) in tc:
        for layout in (False, True):
            err = flash_case(b, hkv, g, s, t, d, torch.bfloat16, causal,
                             q_start, cache_layout=layout, route=route)
            worst[route] = max(worst.get(route, 0.0), err)
    log(f"  flash_attention route cases: {4 * len(split)} forced split "
        f"(float32 max |diff| {worst[('split', torch.float32)]:.3g}, "
        f"bfloat16 {worst[('split', torch.bfloat16)]:.3g}, also against "
        f"the split path's plain version), {2 * len(tc)} tensor-core (bf16 "
        f"max |diff| wgmma {worst['wgmma']:.3g}, mma {worst['mma']:.3g}), "
        f"within FLASH_TOL")


def sass_counts(source: str) -> dict | None:
    """Tensor-core instructions in one library's SASS (cuobjdump, where the
    toolkit has it): HMMA is bf16 mma.sync, HGMMA bf16 wgmma, IGMMA int8
    wgmma. None without cuobjdump."""
    tool = Path(kernels._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run(
        [str(tool), "-sass", str(kernels._lib_path(source))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    lines = sass.splitlines()
    return {"HMMA": sum("HMMA" in ln and "HGMMA" not in ln for ln in lines),
            "HGMMA": sum("HGMMA" in ln for ln in lines),
            "IGMMA": sum("IGMMA" in ln for ln in lines)}


def flash_sass() -> str:
    c = sass_counts("flash_attention.cu")
    if c is None:
        return "cuobjdump not found: tensor-core instructions not counted"
    if c["HMMA"] + c["HGMMA"] == 0:
        raise AssertionError("the flash library has no tensor-core "
                             "instruction")
    return (f"flash library SASS: {c['HMMA']} HMMA (mma.sync) and "
            f"{c['HGMMA']} HGMMA (wgmma) instructions")


def wgmma_sass() -> str:
    """The cin library's bf16 wgmma (HGMMA) and the jaccard library's int8
    wgmma (IGMMA) instructions; fails if either has none."""
    out = []
    for source, kind in (("cin.cu", "HGMMA"), ("jaccard.cu", "IGMMA")):
        c = sass_counts(source)
        if c is None:
            return "cuobjdump not found: tensor-core instructions not counted"
        if c[kind] == 0:
            raise AssertionError(f"the {source} library has no {kind}")
        out.append(f"{source} {c[kind]} {kind} ({c})")
    return "wgmma SASS: " + "; ".join(out)


def flash_record() -> dict:
    """flash_attention at the LM paths' shapes: granite-3-8b's prefill of
    1 x 8,192 tokens (32 heads over 8 KV heads; q_start 0 over the prompt's
    own keys) and its decode step of 8 sequences over the 32,768-slot cache
    at q_start 32,760; qwen2-moe-a2.7b's (16 heads over 16 KV heads) at the
    same prefill and a decode step of 4 sequences. Each shape is checked in
    float32 and in bfloat16 against the plain version and timed in
    bfloat16, the models' dtype; returns one record per shape."""
    gen = torch.Generator(device=DEV).manual_seed(2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    live = DECODE_CUR + 1
    # name: (batch, heads, KV heads), prefill or decode by the name
    shapes = {"prefill": (1, 32, 8), "decode": (DECODE_B, 32, 8),
              "moe_prefill": (1, 16, 16), "moe_decode": (MOE_DECODE_B, 16, 16)}

    def inputs(name, dt):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=DEV).to(dt)
        b, h, hkv = shapes[name]
        if name.endswith("prefill"):
            return (randn(b, h, PREFILL_S, 128), randn(b, hkv, PREFILL_S, 128),
                    randn(b, hkv, PREFILL_S, 128), 0)
        ck, cv = randn(b, DECODE_T, hkv, 128), randn(b, DECODE_T, hkv, 128)
        return (randn(b, h, 1, 128), ck.transpose(1, 2), cv.transpose(1, 2),
                DECODE_CUR)

    rec = {}
    for name in shapes:
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, q_start = inputs(name, dt)
            out = fa_ops.flash_attention(q, k, v, q_start=q_start)
            torch.cuda.synchronize()
            errs[dt] = float_err(out.float(), attention_ref(
                q, k, v, q_start=q_start).float(), **FLASH_TOL[dt])
            del out
        # q, k, v are the bfloat16 inputs from here on
        plan = fa_kernel.plan(q, k, v, causal=True, q_start=q_start)
        log(f"  flash_attention {name} shape, bf16: route {plan.route} "
            f"({plan})")
        if name.endswith("prefill"):
            def library():
                return sdpa(q, k, v, is_causal=True, enable_gqa=True)
        else:
            def library():
                return sdpa(q, k[:, :, :live], v[:, :, :live],
                            enable_gqa=True)
        b_ms, b_by = flash_bound(q, k, q_start)
        rec[name] = dict(
            name=f"flash_attention.flash_attention[{name}]", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:75",
            max_abs_err=errs[torch.bfloat16],
            ms=time_ms(lambda: fa_ops.flash_attention(q, k, v,
                                                      q_start=q_start)),
            plain_ms=time_ms(lambda: attention_ref(q, k, v, q_start=q_start),
                             reps=5),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library),
            q=list(q.shape), kv=list(k.shape), q_start=q_start,
            flash_route=plan.route,
            max_abs_err_float32=errs[torch.float32])
        log(f"  flash_attention.flash_attention {name}: {rec[name]}")
        del q, k, v, library
        torch.cuda.empty_cache()
    return rec


_GRAPHS: dict = {}
# batches whose numpy build runs on the host in a process of its own from
# the start (`start_graph_build`): shape -> (process, file)
GRAPH_BUILDS: dict = {}
# the ogb_products batch's build (80-165 s of one host core) overlaps the
# earlier phases' device work from here
OGB_NPZ = Path(__file__).resolve().parent / "build" / "ogb_products.npz"


def gnn_graph(shape: str):
    """The GNN paths' batch for ``shape`` at full size on the card
    (ogb_products: 2,449,029 nodes, 64,308,169 edges with self loops;
    molecule: 128 molecules, 3,840 nodes, 8,192 edges), built once from
    seed 0, or taken from its build started in GRAPH_BUILDS. Returns
    (batch, seconds to build it, seconds waited for it)."""
    if shape not in _GRAPHS:
        t0 = time.perf_counter()
        if shape in GRAPH_BUILDS:
            _GRAPHS[shape] = load_graph(GRAPH_BUILDS.pop(shape))
        else:
            g = make_graph_batch(shape, **gcn_cora.SHAPE_DIMS[shape],
                                 seed=0, device=DEV)
            torch.cuda.synchronize()
            _GRAPHS[shape] = (g, time.perf_counter() - t0,
                              time.perf_counter() - t0)
    return _GRAPHS[shape]


def spmm_check(vals, recv, mask, n: int, *, plan=None,
               hub: bool = False, assume_sorted: bool = False) -> float:
    """segment_spmm (with ``plan``, or building its own) against its plain
    version within SPMM_TOL of the values' dtype, with ``hub`` at atol
    GNN_SHARE x max |plain|. Float32 values are held to the plain sums
    taken in float64: the plain version's float32 ``index_add_`` adds a
    node's edges in atomic order, which differs from call to call, and at
    a node of thousands of edges two of its own calls can differ by more
    than the tolerance. Returns max |diff|."""
    out = seg_ops.segment_spmm(vals, recv, mask, n, plan=plan,
                               assume_sorted=assume_sorted)
    torch.cuda.synchronize()
    ref = segment_spmm_ref(vals, recv, mask, n)
    if out.dtype != ref.dtype:
        raise AssertionError(f"segment_spmm returned {out.dtype}, plain "
                             f"{ref.dtype}")
    if vals.dtype == torch.float32:
        live = mask & (recv >= 0) & (recv < n)
        ref = torch.zeros((n + 1, vals.shape[1]), dtype=torch.float64,
                          device=vals.device).index_add_(
            0, torch.where(live, recv.to(torch.int64), n),
            vals.double())[:n].float()
    tol = dict(SPMM_TOL[vals.dtype])
    if hub:
        tol["atol"] = GNN_SHARE * ref.abs().max().item()
    return float_err(out.float(), ref.float(), **tol)


def spmm_inputs(e: int, d: int, n: int, dt=torch.float32, live: float = 0.9,
                *, hub: float = 0.0, node_edges: tuple[int, int] = (0, 0),
                assume_sorted: bool = False):
    """Random (E, d) messages to n nodes: ``hub`` sends that share of the
    edges to node 3; ``node_edges`` = (v, k) gives node v exactly k live
    edges among the others (and some masked ones); ``assume_sorted`` sorts
    the receivers."""
    recv = RNG.integers(0, n, e).astype(np.int32)
    recv[RNG.uniform(size=e) < hub] = 3
    mask = RNG.uniform(size=e) < live
    v, k = node_edges
    if k:
        recv = np.concatenate([np.where(recv == v, (v + 1) % n, recv),
                               np.full(k + 5, v, np.int32)])
        mask = np.concatenate([mask, np.ones(k + 5, bool)])
        mask[np.flatnonzero(recv == v)[:5]] = False
        perm = RNG.permutation(recv.shape[0])
        recv, mask = recv[perm], mask[perm]
    if assume_sorted:
        recv = np.sort(recv)
    vals = torch.randn((recv.shape[0], d), device=DEV).to(dt)
    return vals, dev(recv), dev(mask)


def spmm_case(e: int, d: int, n: int, dt=torch.float32, live: float = 0.9,
              *, hub: float = 0.0, node_edges: tuple[int, int] = (0, 0),
              assume_sorted: bool = False) -> float:
    """`spmm_check` on `spmm_inputs`; a hub or a node of more than PIECE
    edges is held at the GNN paths' tolerance. Returns max |diff|."""
    vals, recv, mask = spmm_inputs(e, d, n, dt, live, hub=hub,
                                   node_edges=node_edges,
                                   assume_sorted=assume_sorted)
    return spmm_check(vals, recv, mask, n, assume_sorted=assume_sorted,
                      hub=bool(hub) or node_edges[1] > PIECE)


def spmm_sweep() -> None:
    """E off the TPU's 512-edge blocks and N off its 128-node blocks, D = 7
    and Equiformer-v2's 6,272, 10% and 100% masked edges, no edges, a hub
    of half the edges, every edge on one node, nodes of 1, 3 and 40
    PIECEs and of PIECE and PIECE + 1 edges, receivers given sorted, one
    plan for two value tensors of different D, float32 and bfloat16; then
    two calls on the same inputs give the same bits."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [(100, 16, 50), (1000, 64, 300), (64, 7, 10), (515, 7, 131),
             (4097, 47, 1000), (3000, 6272, 1000), (0, 8, 5), (7, 33, 1),
             (3000, 3, 500), (5000, 1, 64), (2000, 288, 300),
             (3001, 129, 200), (2000, 1001, 90)]
    n = 0
    for e, d, nn in cases:
        for dt in worst:
            worst[dt] = max(worst[dt], spmm_case(e, d, nn, dt))
            n += 1
    for dt in worst:
        worst[dt] = max(
            worst[dt], spmm_case(300, 12, 40, dt, live=0.0),
            spmm_case(200_000, 47, 1000, dt, hub=0.5),
            spmm_case(20_000, 16, 1, dt, live=1.0),
            spmm_case(5000, 40, 700, dt, assume_sorted=True),
            *(spmm_case(3000, d, 300, dt, node_edges=(5, k))
              for k in (PIECE, PIECE + 1, 3 * PIECE, 40 * PIECE)
              for d in (16, 47, 6272 if k < 40 * PIECE else 300)))
        n += 4 + 12
        vals, recv, mask = spmm_inputs(4000, 16, 200, dt,
                                       node_edges=(7, 3 * PIECE + 1))
        plan = seg_ops.segment_plan(recv, mask, 200)
        worst[dt] = max(worst[dt], spmm_check(vals, recv, mask, 200,
                                              plan=plan, hub=True))
        worst[dt] = max(worst[dt], spmm_check(
            torch.randn((vals.shape[0], 300), device=DEV).to(dt), recv,
            mask, 200, plan=plan, hub=True))
        n += 2
    log(f"  segment_spmm ragged sweep: {n} cases within float32 atol=rtol "
        f"1e-4 and bfloat16 atol=rtol 0.15 of the plain version (hubs and "
        f"nodes of more than PIECE = {PIECE} edges at atol {GNN_SHARE} x "
        f"max |plain|; max |diff| float32 "
        f"{worst[torch.float32]:.3g}, bfloat16 {worst[torch.bfloat16]:.3g})")
    # two calls on the same inputs: the same bits (no atomics, pieces added
    # in piece order)
    same = 0
    for d, k in ((47, 40 * PIECE), (6272, 3 * PIECE), (3, 40 * PIECE)):
        vals, recv, mask = spmm_inputs(5000, d, 300,
                                       node_edges=(5, k))
        a = seg_ops.segment_spmm(vals, recv, mask, 300)
        b = seg_ops.segment_spmm(vals, recv, mask, 300)
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"segment_spmm is not deterministic at D "
                                 f"{d}")
        same += 1
    log(f"  segment_spmm determinism: {same} pairs of calls bit-identical "
        f"(hubs of 40 and 3 PIECEs, D 47, 6,272 and 3)")


def spmm_record(shape: str, d: int, g=None) -> dict:
    """segment_spmm at a GNN path's shape: random float32 (E, d) messages
    over the path's own receivers and edge mask (``g``, or the phase's
    batch of ``shape``), checked against the plain version, twice through
    one plan (the two must be bit-identical).
    Timed: the op given the plan built (as the forward calls it, ``ms``),
    the op that builds its own plan (``ms_with_plan``), the plan alone,
    the kernel alone through the plan's order (on the path's receivers and
    on as many uniformly drawn ones, which have no hub), the plain version
    and one index_add_ call."""
    if g is None:
        g = gnn_graph(shape)[0]
    recv, mask = g.receivers, g.edge_mask
    e, n = recv.shape[0], g.node_mask.shape[0]
    # the live edges lead (a padded batch masks its tail): the library
    # call sums them alone
    live = int(mask.sum().item())
    if not bool(mask[:live].all()):
        raise AssertionError(f"{shape}: the live edges do not lead")
    gen = torch.Generator(device=DEV).manual_seed(3)
    vals = torch.randn((e, d), generator=gen, device=DEV)
    plan = seg_ops.segment_plan(recv, mask, n)
    out = seg_ops.segment_spmm(vals, recv, mask, n, plan=plan)
    again = seg_ops.segment_spmm(vals, recv, mask, n, plan=plan)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"{shape}: two calls differ")
    del again
    ref = segment_spmm_ref(vals, recv, mask, n)
    err = float_err(out, ref, atol=GNN_SHARE * ref.abs().max().item(),
                    rtol=GNN_SHARE)
    del out, ref
    # the function's own inputs: the live messages, receivers and mask,
    # the output
    n_bytes = 4 * live * d + 4 * e + e + 4 * n * d
    b_ms, b_by = bound(n_bytes, live * d)
    rec = dict(
        name=f"segment_spmm.segment_spmm[{shape}]", route="cuda",
        source="src/repro_torch/csrc/segment_spmm.cu",
        replaces="src/repro/kernels/segment_spmm/kernel.py:51",
        max_abs_err=err,
        ms=time_ms(lambda: seg_ops.segment_spmm(vals, recv, mask, n,
                                                plan=plan), reps=10),
        ms_with_plan=time_ms(lambda: seg_ops.segment_spmm(vals, recv, mask,
                                                          n), reps=10),
        plan_ms=time_ms(lambda: seg_ops.segment_plan(recv, mask, n),
                        reps=10),
        kernel_only_ms=time_ms(lambda: segment_spmm_kernel(vals, plan, n),
                               reps=10),
        plain_ms=time_ms(lambda: segment_spmm_ref(vals, recv, mask, n),
                         reps=10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.zeros(
            (n, d), device=DEV).index_add_(0, recv[:live], vals[:live]),
            reps=10),
        shape=[e, d, n], piece=PIECE, n_pieces=plan.n_pieces,
        n_split=plan.n_split)
    # the same E, D and N over uniformly drawn receivers: no hub
    uniform = seg_ops.segment_plan(
        torch.randint(0, n, (e,), generator=gen, device=DEV,
                      dtype=torch.int32), mask, n)
    rec["kernel_uniform_ms"] = time_ms(
        lambda: segment_spmm_kernel(vals, uniform, n), reps=10)
    del uniform
    deg = torch.bincount(recv.long(), minlength=n)
    log(f"  segment_spmm.segment_spmm {shape} (E {e:,}, D {d}, N {n:,}, "
        f"float32, largest in-degree {int(deg.max()):,}; within rtol "
        f"{GNN_SHARE} and atol {GNN_SHARE} x max |plain|; two calls "
        f"bit-identical): {rec}")
    del vals, plan, deg
    torch.cuda.empty_cache()
    return rec


def molecule_block(rank: int):
    """Rank ``rank``'s block of the molecule batch on a GNN_MESH mesh
    (`graph_batch_specs`' layout) and its MeshGraph over the edge mask:
    the block-local receivers, the receiver mask and the plan a forward
    builds."""
    mesh = MetaMesh(GNN_MESH, ("data", "model"), rank=rank)
    _, specs = dry_cells.graph_batch_specs("molecule", mesh)
    block = dry_cells.graph_block(gnn_graph("molecule")[0], specs, mesh)
    return block, MeshGraph(block, block.edge_mask)


def block_spmm_record(d: int) -> dict:
    """segment_spmm at one rank's edge block of phase 12c's GNN cells:
    every rank's random (E / 2, d) messages over its block-local receivers
    and receiver mask into its N / 2 rows, through the plan, against the
    plain version (`spmm_check`); then rank 0's block recorded as
    `spmm_record` records a path (its edges reordered live first, which
    changes no sum, for the library call over the live edges)."""
    worst = 0.0
    for rank in range(math.prod(GNN_MESH)):
        block, mg = molecule_block(rank)
        vals = torch.randn((block.senders.shape[0], d), device=DEV)
        worst = max(worst, spmm_check(vals, mg.receivers, mg.edge_mask,
                                      mg.n_loc, plan=mg.plan))
    block, mg = molecule_block(0)
    log(f"  segment_spmm at each rank's edge block of the {GNN_MESH[0]} x "
        f"{GNN_MESH[1]} molecule cell (E {block.senders.shape[0]:,}, D {d:,}"
        f", N {mg.n_loc:,}; live edges of rank 0: "
        f"{int(mg.edge_mask.sum()):,}): within float32 atol=rtol 1e-4 of "
        f"the plain sums, max |diff| {worst:.3g}")
    order = torch.argsort((~mg.edge_mask).to(torch.int8), stable=True)
    return spmm_record("molecule_block", d, types.SimpleNamespace(
        receivers=mg.receivers[order], edge_mask=mg.edge_mask[order],
        node_mask=block.node_mask))


def bag_case(v: int, d: int, b: int, bag: int, dt=torch.float32,
             weighted: bool = True, ids_np=None):
    table = torch.randn((v, d), device=DEV).to(dt)
    ids = dev((RNG.integers(0, v, (b, bag)) if ids_np is None
               else ids_np).astype(np.int32))
    w = dev(RNG.normal(size=ids.shape).astype(np.float32)) if weighted \
        else None
    out = emb_ops.bag_sum(table, ids, w)
    torch.cuda.synchronize()
    return float_err(out.float(), bag_sum_ref(table, ids, w).float(),
                     **BAG_TOL[dt])


def bag_record() -> dict:
    """bag_sum, an op with no path: the ragged sweep, then the full
    xDeepFM table (26,367,531 x 10 float32) under serve_bulk's 262,144
    requests, each request's 39 field rows one bag with seeded normal
    weights. Its launches are those of these checks (counts reset before,
    read before the timing)."""
    emb_ops.bag_sum.launches = 0
    worst = 0.0
    for v, d, b, bag in ((500, 10, 16, 4), (200, 32, 8, 7),
                         (300, 17, 5, 39), (1000, 300, 33, 3)):
        for dt in (torch.float32, torch.bfloat16):
            for weighted in (True, False):
                worst = max(worst, bag_case(v, d, b, bag, dt, weighted))
    # jnp.take's semantics: negative ids wrap, ids out of range give NaN
    bag_case(50, 6, 3, 3, ids_np=np.array([[0, 49, -1], [-50, 7, 7],
                                           [3, 50, 1]]))
    log(f"  bag_sum ragged sweep: float32 within atol 1e-5, bfloat16 "
        f"within one bfloat16 step, NaN where jnp.take fills (max |diff| "
        f"{worst:.3g})")
    cfg = xdeepfm_configs.full()
    bsz = xdeepfm_configs.SERVE_BATCH["serve_bulk"]
    batch = next(click_batches(cfg.vocab_sizes, cfg.n_dense, bsz, seed=0))
    ids = dev((batch["sparse"] + field_offsets(cfg)[None, :])
              .astype(np.int32))
    gen = torch.Generator(device=DEV).manual_seed(4)
    table = torch.randn((cfg.total_vocab, cfg.embed_dim), generator=gen,
                        device=DEV) * 0.01
    w = torch.randn(ids.shape, generator=gen, device=DEV)
    out = emb_ops.bag_sum(table, ids, w)
    torch.cuda.synchronize()
    err = float_err(out, bag_sum_ref(table, ids, w),
                    **BAG_TOL[torch.float32])
    again = emb_ops.bag_sum(table, ids, w)
    if not torch.equal(again.view(torch.int32), out.view(torch.int32)):
        raise AssertionError("bag_sum: two launches differ")
    launches = emb_ops.bag_sum.launches
    b, bag = ids.shape
    d = cfg.embed_dim
    distinct = torch.unique(ids)
    rows = distinct.numel()
    b_ms, b_by = bound(4 * b * bag * 2 + 4 * rows * d + 4 * b * d,
                       2 * b * bag * d)
    # the 32-byte sectors the distinct rows span (a 40-byte row spans two)
    first = distinct.to(torch.int64) * (4 * d)
    sectors = int(((first + 4 * d - 1) // 32 - first // 32 + 1).sum().item())
    sector_ms = (4 * b * bag * 2 + 32 * sectors + 4 * b * d) \
        / HBM_BYTES_PER_S * 1e3

    def call():
        return emb_ops.bag_sum(table, ids, w)

    def library():
        return torch.nn.functional.embedding_bag(ids, table,
                                                 per_sample_weights=w,
                                                 mode="sum")

    rec = dict(
        name="embedding_bag.bag_sum", route="cuda",
        source="src/repro_torch/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/kernel.py:61",
        launches=launches, max_abs_err=err, ms=time_ms(call),
        plain_ms=time_ms(lambda: bag_sum_ref(table, ids, w)),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library),
        kernel_ms=kernel_ms(call), path=None)
    p = emb_kernel.bag_plan(d, bag, table.dtype)
    log(f"  embedding_bag.bag_sum ({b:,} bags of {bag} into "
        f"{cfg.total_vocab:,} x {d}, {rows:,} distinct rows; atol 1e-5; "
        f"two launches bit-identical; plan {p}): {rec}; library "
        f"kernel_ms={kernel_ms(library):.4f}; sector bound "
        f"{sector_ms:.4f} ms ({sectors:,} sectors of the distinct rows)")
    del table, ids, w, out
    torch.cuda.empty_cache()
    return rec


def phase_kernels() -> dict:
    """Check every kernel on the ragged sweep shapes and the main path's
    shapes; time each at its main-path shape. Returns per-kernel records."""
    for q, f in ((3, 5), (14, 23), (130, 257), (1000, 77)):
        jaccard_case((RNG.uniform(size=(q, f)) < 0.3).astype(np.float32))
    # ragged sweep of the triangle's tiles and the packed width: Q off the
    # 128-row tiles, F off the 16-byte rows and the 128-feature stages,
    # empty rows (distance 0 to each other) and duplicated rows
    n_jac = 0
    for q in (1, 127, 129, 257):
        for f in (1, 15, 17, 4859):
            m_np = (RNG.uniform(size=(q, f)) < 0.3).astype(np.float32)
            m_np[::5] = 0.0
            if q > 2:
                m_np[1::7] = m_np[2]
                m_np[-1] = m_np[0]
            jaccard_case(m_np)
            n_jac += 1
    small = dev(RNG.normal(size=(1000, 17)).astype(np.float32))
    for v, d, n in ((500, 10, 64), (128, 128, 16), (1000, 17, 200)):
        gather_case(dev(RNG.normal(size=(v, d)).astype(np.float32)),
                    RNG.integers(0, v, n))
    # jnp.take's semantics: negative ids wrap, ids out of range give NaN
    gather_case(small, np.array([0, 999, -1, -1000, 1000, -1001, 7]))
    # ragged sweep: D 1, 3, 10, 16, 33 (1-, 2- and 4-float vectors); full
    # and partial 32-row tiles; negative and
    # out-of-range ids among the others; the table in place and one row
    # into a larger one (its start then aligned to 4 d bytes only)
    n_gather = 0
    for d in (1, 3, 10, 16, 33):
        big = dev(RNG.normal(size=(778, d)).astype(np.float32))
        for table in (big[:777], big[1:]):
            v = table.shape[0]
            ids = np.concatenate([RNG.integers(0, v, 1000),
                                  [-1, -v, v, -v - 1, 3 * v],
                                  RNG.integers(-v, 0, 20),
                                  RNG.integers(v, 2 * v, 20)])
            gather_case(table, RNG.permutation(ids))
            n_gather += 1
    # cin: ragged B, H, F, D, K (H odd, F off 8, D past a row tile, K past
    # a column tile, H + F too large for a 128-row tile), against the plain
    # layer and the split arithmetic's plain version
    cin_shapes = ((12, 20, 39, 10, 50), (8, 39, 39, 10, 200),
                  (16, 7, 13, 8, 20), (3, 1, 1, 1, 1), (33, 200, 39, 10, 200),
                  (9, 13, 1, 3, 7), (2, 1, 7, 5, 3), (7, 5, 17, 3, 260),
                  (5, 3, 4, 300, 9), (1, 39, 39, 10, 200),
                  (6, 300, 120, 10, 210))
    if {cin_kernel.plan(*shape).rows for shape in cin_shapes} != {64, 128}:
        raise AssertionError("the cin sweep misses a row tile")
    for shape in cin_shapes:
        cin_case(*shape, split=True)
    log(f"  ragged sweep shapes: the query kernels and jaccard "
        f"bit-identical (jaccard also at Q 1, 127, 129, 257 x F 1, 15, 17, "
        f"4,859 with empty and duplicated rows, {n_jac} cases, each exactly "
        f"symmetric), gather_rows exact (NaN where jnp.take fills; "
        f"{n_gather} cases of D 1, 3, 10, 16, 33 with negative and "
        f"out-of-range ids), cin within {CIN_TOL} of the plain layer and of "
        f"the split arithmetic's plain version ({len(cin_shapes)} shapes)")
    log("  " + wgmma_sass())

    rec = scan_records()

    rec.update(join_records())

    rec.update(compat_records())

    m_np, _ = feature_matrix(production_queries())
    m, err, (b_ms, b_by) = jaccard_case(m_np)
    q, f = m.shape
    tiles = jac_kernel.n_tiles(q)
    if tiles != 128 * 129 // 2 or jac_kernel.packed_width(f) != 4864:
        raise AssertionError(f"jaccard at {q} x {f}: {tiles} tiles, packed "
                             f"width {jac_kernel.packed_width(f)}")
    log(f"  jaccard at {q} x {f}: {tiles} tiles of 128 x 128 (the upper "
        f"triangle of 128 x 128), packed to {jac_kernel.packed_width(f)} "
        f"int8 columns")
    rec["jaccard_distance"] = dict(
        name="jaccard.jaccard_distance", route="cuda",
        source="src/repro_torch/csrc/jaccard.cu",
        replaces="src/repro/kernels/jaccard/kernel.py:48", max_abs_err=err,
        ms=time_ms(lambda: jac_ops.jaccard_distance(m), reps=10),
        plain_ms=time_ms(lambda: jaccard_distance_ref(m), reps=10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  jaccard.jaccard_distance ({q} x {f}, {int(m_np.sum()):,} ones; "
        f"bit-identical): {rec['jaccard_distance']}; byte bound "
        f"{(4 * q * f + 4 * q * q) / HBM_BYTES_PER_S * 1e3:.4f} ms, the "
        f"symmetric product on int8 tensor cores "
        f"{q * (q + 1) * f / INT8_TC_OPS_PER_S * 1e3:.4f} ms, the full "
        f"dense product at the float32 rate "
        f"{2 * q * q * f / OPS_PER_S * 1e3:.4f} ms")
    del m

    cfg = xdeepfm_configs.full()
    bsz = xdeepfm_configs.SERVE_BATCH["serve_bulk"]
    batch = next(click_batches(cfg.vocab_sizes, cfg.n_dense, bsz, seed=0))
    rows = (batch["sparse"] + field_offsets(cfg)[None, :]).reshape(-1)
    gen = torch.Generator(device=DEV).manual_seed(1)
    table = torch.randn((cfg.total_vocab, cfg.embed_dim), generator=gen,
                        device=DEV) * 0.01
    ids, err, (b_ms, b_by) = gather_case(table, rows)
    rec["gather_rows"] = dict(
        name="embedding_bag.gather_rows", route="cuda",
        source="src/repro_torch/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/kernel.py:26",
        max_abs_err=err,
        ms=time_ms(lambda: emb_ops.gather_rows(table, ids)),
        plain_ms=time_ms(lambda: gather_rows_ref(table, ids)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.index_select(table, 0, ids)))
    log(f"  embedding_bag.gather_rows ({ids.shape[0]:,} ids of serve_bulk "
        f"into {cfg.total_vocab:,} x {cfg.embed_dim}, "
        f"{torch.unique(ids).numel():,} distinct; exact): "
        f"{rec['gather_rows']}")
    del table, ids

    rec["cin_layer"] = cin_record("serve_p99")
    rec["cin_layer[serve_bulk]"] = cin_record("serve_bulk")

    fa_ops.flash_attention.routes.clear()
    flash_sweep()
    log(f"  ragged sweep routes: {dict(fa_ops.flash_attention.routes)}")
    flash_route_cases()
    log("  " + flash_sass())
    for name, r in flash_record().items():
        rec[f"flash_attention[{name}]"] = r
    rec["flash_attention[decode_lse]"] = flash_lse_record()

    rec["bag_sum"] = bag_record()
    spmm_sweep()
    t0 = time.perf_counter()
    g, build_s, waited = gnn_graph("ogb_products")
    log(f"  ogb_products batch: {g.node_mask.shape[0]:,} nodes, "
        f"{g.receivers.shape[0]:,} edges with self loops, built from seed "
        f"0 in {build_s:.2f} s (numpy on the host, in a process of its own "
        f"from the start; waited {waited:.2f} s, then copied to the card)")
    # GCN layer 2's messages: (E, n_classes)
    rec["segment_spmm[ogb_products]"] = spmm_record(
        "ogb_products", gcn_cora.SHAPE_DIMS["ogb_products"]["n_classes"])
    # Equiformer-v2's values: (E, (l_max + 1)^2 x d_hidden)
    eq = eq_configs.full()
    rec["segment_spmm[molecule]"] = spmm_record(
        "molecule", (eq.l_max + 1) ** 2 * eq.d_hidden)
    rec["segment_spmm[molecule_block]"] = block_spmm_record(
        (eq.l_max + 1) ** 2 * eq.d_hidden)
    log(f"  segment_spmm records: {time.perf_counter() - t0:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phases 4 and 5: serve the workload through the port's entry points
# ---------------------------------------------------------------------------

OPS = {"scan_hits": scan_ops.scan_hits,
       "scan_select": scan_ops.scan_select,
       "join_ranges": join_ops.join_ranges,
       "join_select": join_ops.join_select,
       "compat_matrix": join_ops.compat_matrix,
       "compat_select": join_ops.compat_select,
       "jaccard_distance": jac_ops.jaccard_distance,
       "gather_rows": emb_ops.gather_rows,
       "cin_layer": cin_ops.cin_layer,
       "flash_attention": fa_ops.flash_attention,
       "segment_spmm": seg_ops.segment_spmm,
       "bag_sum": emb_ops.bag_sum}


def reset_counts():
    for op in OPS.values():
        op.launches = 0
    fa_ops.flash_attention.routes.clear()
    seg_ops.segment_plan.builds = 0


def counts() -> dict:
    return {name: op.launches for name, op in OPS.items()}


def serve_path(scale: float, join_impl: str, passes: int = 2, *,
               kernel_partition: bool = False) -> tuple[dict, dict]:
    """Build, partition and serve a round-robin stream over every LUBM
    template (``passes`` passes of BATCH requests); check every result
    against the oracle. With ``kernel_partition`` the partition comes from
    the Jaccard kernel's distances and must equal the numpy one. Returns
    the launch counts of the served run (and of the partition step), and
    the store, partition, oracle and the served answers by template."""
    t0 = time.perf_counter()
    store = generate_lubm(1, scale=scale, seed=0)
    queries = lubm_queries()
    part = wawpart_partition(store, queries, n_shards=3)
    jaccard_launches = 0
    if kernel_partition:
        reset_counts()
        kpart = wawpart_partition(
            store, queries, n_shards=3, dist_matrix=jaccard_distance_matrix(
                queries, use_kernel=True, device=DEV))
        jaccard_launches = counts()["jaccard_distance"]
        if (kpart.unit_shard != part.unit_shard
                or kpart.meta["labels"] != part.meta["labels"]):
            raise AssertionError("the partition from the kernel's distances "
                                 "differs from the numpy one")
        log(f"  WawPart from jaccard_distance_matrix(use_kernel=True): "
            f"labels {kpart.meta['labels']}, equal to the numpy partition "
            f"({jaccard_launches} jaccard launch)")
        part = kpart
    server = WorkloadServer(queries, part, join_impl=join_impl,
                            backend="cuda", device=DEV)
    log(f"  LUBM scale {scale}: {len(store):,} triples -> shards "
        f"{part.shard_sizes.tolist()}, kg {tuple(server.kg.triples.shape)}, "
        f"{server.n_buckets} buckets, cuts {server.collective_counts()} "
        f"({time.perf_counter() - t0:.1f} s to build and plan)")
    stream = request_stream(queries, BATCH * passes)
    chunks = [stream[i:i + BATCH] for i in range(0, len(stream), BATCH)]
    t0 = time.perf_counter()
    server.warmup(chunks[0])
    torch.cuda.synchronize()
    log(f"  warmup: {time.perf_counter() - t0:.3f} s")
    # the planner's join order: in query order some LUBM(1) templates pass
    # through cartesian intermediates far larger than host memory; the
    # solution set does not depend on the order
    oracle = {q.name: evaluate_bgp(store, q,
                                   order=server.plans[q.name].meta["order"])
              for q in queries}

    # each merge join makes one join_ranges or join_select call: count the
    # engine's, and those that expand without verifying a second column
    # (the join_select ones: new_mode, the 8th argument, not "none")
    merge_join, merges = engine_batch._join_merge, [0, 0]

    def counted_merge(*a, **kw):
        merges[0] += 1
        merges[1] += not any(kw["verify_mask"]) and a[7] != "none"
        return merge_join(*a, **kw)

    # each expand join makes one compat_select; those that expand (new_mode,
    # the 7th argument, not "none") made one scan_select of their matrix
    # before it
    data_join, datas = engine_batch._join_data, [0, 0]

    def counted_data(*a, **kw):
        datas[0] += 1
        datas[1] += a[6] != "none"
        return data_join(*a, **kw)

    server.reset_stats()
    torch.cuda.reset_peak_memory_stats(DEV)
    reset_counts()
    engine_batch._join_merge = counted_merge
    engine_batch._join_data = counted_data
    try:
        t_all = time.perf_counter()
        results, per_call = [], []
        for chunk in chunks:
            t0 = time.perf_counter()
            results += server.serve(chunk)
            torch.cuda.synchronize()
            per_call.append(time.perf_counter() - t0)
        dt = time.perf_counter() - t_all
    finally:
        engine_batch._join_merge = merge_join
        engine_batch._join_data = data_join
    launched = counts()
    launched["merge_joins"], launched["select_joins"] = merges
    launched["expand_joins"], launched["expanding_joins"] = datas
    launched["jaccard_distance"] = jaccard_launches
    peak = torch.cuda.max_memory_allocated(DEV)

    for (name, _), (rows, n, ovf) in zip(stream, results):
        if ovf:
            raise AssertionError(f"{name}: overflow flag set")
        if not np.array_equal(rows, oracle[name]) or n != len(oracle[name]):
            raise AssertionError(f"{name}: result differs from the oracle")
    log(f"  served {len(stream)} requests in {dt:.4f} s "
        f"({len(stream) / dt:.2f} queries/s; per serve() call "
        f"{[round(t, 4) for t in per_call]} s; first pass "
        f"{BATCH / per_call[0]:.2f} queries/s)")
    log(f"  stats {server.stats}; launches {launched}; "
        f"max_memory_allocated {peak:,} bytes")
    log(f"  every result equals evaluate_bgp; no overflow "
        f"({sum(len(oracle[n]) for n, _ in stream):,} solutions)")
    answers = {name: rows for (name, _), (rows, _, _) in zip(stream, results)}
    return launched, {"store": store, "part": part, "oracle": oracle,
                      "answers": answers, "queries": queries,
                      "cache": server.cache, "per_call": per_call}


# ---------------------------------------------------------------------------
# phase 4b: the continuous-batching pipeline on phase 4's store
# ---------------------------------------------------------------------------

PIPE_DEADLINE_MS = 25.0      # deadline budget of the pipeline phase
PIPE_REPLAY = 140            # paced requests, one every PIPE_ARRIVAL_MS
PIPE_ARRIVAL_MS = 1.0


class FakeClock:
    """A clock the schedule advances by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def pipe_server(main_path: dict, *, clock=None, trace: bool = False,
                deadline_ms: float | None = PIPE_DEADLINE_MS):
    """A pipelined server on phase 4's store and partition, sharing its
    engine cache; answer cache off, so every request dispatches."""
    cfg = PipelineConfig(deadline_ms=deadline_ms, max_batch=BATCH,
                         max_inflight=2,
                         **({} if clock is None else {"clock": clock}))
    return WorkloadServer(main_path["queries"], main_path["part"],
                          join_impl="sorted", backend="cuda", device=DEV,
                          cache=main_path["cache"], answer_cache=False,
                          pipeline=cfg, telemetry=Telemetry(trace=trace))


def check_tickets(tickets, oracle, what: str) -> None:
    for t in tickets:
        if t.error is not None or not t.done:
            raise AssertionError(f"{what}: {t.name} not answered ({t.error})")
        rows, n, ovf = t.result
        if ovf or not np.array_equal(rows, oracle[t.name]) \
                or n != len(oracle[t.name]):
            raise AssertionError(f"{what}: {t.name} differs from the oracle")


def count_completions(server) -> dict:
    """Wrap the server's _retire and _complete (instance attributes; the
    package is unchanged): a batch completed inside _retire is one whose
    CUDA event had fired; any other completion (backpressure, drain) finds
    its event fired or blocks on it."""
    tally = {"retired_on_event": 0, "completed_ready": 0,
             "completed_blocked": 0}
    retire, complete = server._retire, server._complete
    inside = [False]

    def counted_retire():
        inside[0] = True
        try:
            return retire()
        finally:
            inside[0] = False

    def counted_complete(rec):
        key = ("retired_on_event" if inside[0] else "completed_ready"
               if rec.out.ready() else "completed_blocked")
        tally[key] += 1
        return complete(rec)

    server._retire, server._complete = counted_retire, counted_complete
    return tally


def flushes(server) -> dict:
    st = server.stats
    return {k: st[k] for k in ("flush_full", "flush_deadline",
                               "flush_drain")}


def phase_pipeline(main_path: dict, card: str) -> dict:
    """The pipeline's four checks on phase 4's store and partition; returns
    the kernel launches of the phase."""
    queries, oracle = main_path["queries"], main_path["oracle"]
    one_pass = request_stream(queries, len(queries))
    t_phase = time.perf_counter()
    reset_counts()

    # 1. FakeClock schedule. The largest bucket holds 5 of the 14
    # templates, so a queue of BATCH fills on the third pass: three passes
    # queue with the clock still (two "full" flushes), the clock passes the
    # deadline ("deadline" flushes of every bucket), a fourth pass goes out
    # at drain() ("drain" flushes)
    clock = FakeClock()
    server = pipe_server(main_path, clock=clock, trace=True)
    tally = count_completions(server)
    t0 = time.perf_counter()
    tickets = [server.submit(n, p) for _ in range(3) for n, p in one_pass]
    clock.t += 2 * PIPE_DEADLINE_MS / 1e3
    server.pump()
    tickets += [server.submit(n, p, _pump=False) for n, p in one_pass]
    server.drain()                   # raises if the invariants break
    dt = time.perf_counter() - t0
    check_tickets(tickets, oracle, "FakeClock schedule")
    fl = flushes(server)
    if not all(fl.values()) or server.queue_depth() or server.n_inflight:
        raise AssertionError(f"FakeClock schedule: flushes {fl}, queue "
                             f"{server.queue_depth()}, in flight "
                             f"{server.n_inflight}")
    log(f"  FakeClock schedule: {len(tickets)} requests (4 passes), every "
        f"answer equals evaluate_bgp; flushes {fl}; completions {tally}; "
        f"{len(server.telemetry.trace)} trace events; queue 0, in flight 0;"
        f" {dt * 1e3:.3f} ms of host wall [{card}]")

    # 2. real-clock paced replay
    server = pipe_server(main_path)
    stream = request_stream(queries, PIPE_REPLAY)
    for n in (1, 2, 4, 8):                    # the partial batches' shapes
        server.warmup(stream[:n])
    torch.cuda.synchronize()
    server.reset_stats()
    tally = count_completions(server)
    torch.cuda.reset_peak_memory_stats(DEV)
    wall, tickets = replay_paced(server, stream, PIPE_ARRIVAL_MS / 1e3)
    peak = torch.cuda.max_memory_allocated(DEV)
    check_tickets(tickets, oracle, "paced replay")
    lat = server.latency_stats(per_bucket=True)
    per_bucket = lat.pop("per_bucket")
    log(f"  paced replay: {PIPE_REPLAY} requests at {PIPE_ARRIVAL_MS} ms "
        f"arrivals, deadline {PIPE_DEADLINE_MS} ms, max_batch {BATCH}, "
        f"max_inflight 2: {wall * 1e3:.3f} ms wall, every answer equals "
        f"evaluate_bgp [{card}]")
    log(f"  latency {json.dumps(lat)} [{card}]")
    for bi, row in per_bucket.items():
        log(f"    bucket {bi}: {json.dumps(row)} [{card}]")
    log(f"  flushes {flushes(server)}; completions {tally}; stats "
        f"{server.stats}; max_memory_allocated {peak:,} bytes [{card}]")
    replay = pipe_server(main_path)

    def profiled():
        replay_paced(replay, stream, PIPE_ARRIVAL_MS / 1e3)

    log(f"  profiled replay: {device_breakdown(profiled)} [{card}]")

    # 3. migration with the queue full
    server = pipe_server(main_path, deadline_ms=None)
    tickets = [server.submit(n, p, _pump=False) for n, p in one_pass]
    weights = two_phase_weights(queries)[1]
    res = incremental_repartition(main_path["part"], queries, weights,
                                  budget_frac=0.15)
    report = server.migrate(res.part)
    server.drain()
    check_tickets(tickets, oracle, "migration")
    if any(t.epoch != 1 for t in tickets) or server.epoch != 1:
        raise AssertionError("migration: a queued ticket ran on epoch "
                             f"{sorted({t.epoch for t in tickets})}")
    log(f"  migration with {len(tickets)} queued ({res.mode}, "
        f"{res.moved_triples} triples moved): {report}; every ticket ran on"
        f" epoch 1 and equals evaluate_bgp; cuts "
        f"{server.collective_counts()} [{card}]")

    # 4. shutdown(grace_s=0) with three passes submitted: the full flushes
    # are in flight or done, the rest queued
    server = pipe_server(main_path, deadline_ms=None)
    tickets = [server.submit(n, p) for _ in range(3) for n, p in one_pass]
    queued = [t for t in tickets if t.t_flush is None]
    flushed = [t for t in tickets if t.t_flush is not None]
    in_flight, served = server.n_inflight, server.stats["served"]
    out = server.shutdown(grace_s=0)
    if (not queued or not flushed or out["shed"] != len(queued)
            or any(not isinstance(t.error, ShutdownError)
                   or t.result is not None for t in queued)
            or served + out["drained"] + out["shed"] != len(tickets)
            or server.queue_depth() or server.n_inflight):
        raise AssertionError(f"shutdown: {out} for {len(queued)} queued, "
                             f"{len(flushed)} flushed, {served} served "
                             "before")
    check_tickets(flushed, oracle, "shutdown's in-flight batches")
    log(f"  shutdown(grace_s=0): {out} ({len(queued)} queued resolved with "
        f"ShutdownError; {len(flushed)} flushed, {in_flight} batches in "
        f"flight at the call, all completed and equal to evaluate_bgp) "
        f"[{card}]")
    launched = counts()
    for k in ("scan_select", "join_select"):
        if launched[k] <= 0:
            raise AssertionError(f"pipeline phase never launched {k}")
    log(f"  pipeline phase launches {launched}; "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return launched


# ---------------------------------------------------------------------------
# phase 4c: the fault layer, hot-edge replication and the adaptive
# controller on phase 4's store
# ---------------------------------------------------------------------------

CHAOS_SEED, CHAOS_RATE, CHAOS_ATTEMPTS = 5, 0.5, 8
DOWN_SHARD = 1
SERVE_REPS = 5               # timed serve() calls before and after replication
ADAPT_CONFIG = dict(window=64, check_every=32, min_requests=32)
ADAPT_PHASE, ADAPT_CHUNK = 96, 32


def fault_server(main_path: dict, **kw):
    """A server on phase 4's store, partition and engine cache (sorted join,
    backend cuda, answer cache off), deadline flushes off."""
    pipe = {"clock": kw.pop("clock")} if "clock" in kw else {}
    return WorkloadServer(main_path["queries"], main_path["part"],
                          join_impl="sorted", backend="cuda", device=DEV,
                          cache=main_path["cache"], answer_cache=False,
                          pipeline=PipelineConfig(deadline_ms=None, **pipe),
                          **kw)


def check_results(stream, results, oracle, what: str, shed=frozenset()):
    """Every answer of ``stream`` equals the oracle; a template in
    ``shed`` was rejected (None) instead."""
    for (name, _), res in zip(stream, results):
        if name in shed:
            if res is not None:
                raise AssertionError(f"{what}: {name} answered while shed")
            continue
        if res is None:
            raise AssertionError(f"{what}: {name} not answered")
        rows, n, ovf = res
        if ovf or not np.array_equal(rows, oracle[name]) \
                or n != len(oracle[name]):
            raise AssertionError(f"{what}: {name} differs from the oracle")


def serve_passes(server, passes) -> list:
    out = []
    for p in passes:
        out += server.serve(p)
    torch.cuda.synchronize()
    return out


def path_launches() -> dict:
    c = counts()
    return {k: c[k] for k in ("scan_select", "join_ranges", "join_select")}


def timed_serves(server, one_pass, reps: int) -> list[float]:
    """ms of ``reps`` serve() calls of one pass each, synchronised."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.serve(one_pass)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_faults(main_path: dict, card: str) -> dict:
    """The five checks of phase 4c; returns the kernel launches of the
    phase."""
    queries, oracle, part = (main_path["queries"], main_path["oracle"],
                             main_path["part"])
    cache = main_path["cache"]
    one_pass = request_stream(queries, len(queries))
    passes = [one_pass, one_pass]
    stream = one_pass * 2
    t_phase = time.perf_counter()
    launched = {k: 0 for k in OPS}
    reset_counts()

    def restart():
        """Add the launches since the last restart to the phase's, and set
        the counts to 0."""
        for k, v in counts().items():
            launched[k] += v
        reset_counts()

    # 1. chaos with retry: an injected failure fires before the batch is
    # staged, so the retried passes launch what the fault-free ones do
    plain = serve_passes(fault_server(main_path), passes)
    check_results(stream, plain, oracle, "fault-free passes")
    want = path_launches()
    restart()
    server = fault_server(
        main_path, faults=FaultPlan(seed=CHAOS_SEED,
                                    dispatch_fail_rate=CHAOS_RATE),
        retry=RetryPolicy(max_attempts=CHAOS_ATTEMPTS))
    results = serve_passes(server, passes)
    got = path_launches()
    check_results(stream, results, oracle, "chaos with retry")
    server.telemetry.check_invariants()
    st, inj = server.stats, server.faults.injected
    if not (inj["dispatch"] > 0 and st["retries"] > 0 and st["shed"] == 0):
        raise AssertionError(f"chaos with retry: injected {inj}, stats {st}")
    if got != want:
        raise AssertionError(f"chaos with retry launched {got}, the "
                             f"fault-free passes {want}")
    log(f"  chaos with retry (seed {CHAOS_SEED}, rate {CHAOS_RATE}, "
        f"max_attempts {CHAOS_ATTEMPTS}): injected {inj}, retries "
        f"{st['retries']}, shed 0, flushes {flushes(server)}; launches "
        f"{got} equal the fault-free passes'; every answer equals "
        f"evaluate_bgp [{card}]")

    # 2. chaos without retry: every failed cut resolves typed
    restart()
    server = fault_server(
        main_path, faults=FaultPlan(seed=CHAOS_SEED,
                                    dispatch_fail_rate=CHAOS_RATE))
    tickets = [server.submit(n, p, _pump=False) for n, p in one_pass]
    server.drain()
    tickets += [server.submit(n, p, _pump=False) for n, p in one_pass]
    server.drain()
    failed = [t for t in tickets if t.error is not None]
    if not failed or any(not isinstance(t.error, InjectedDispatchError)
                         or t.result is not None for t in failed):
        raise AssertionError("chaos without retry: failed tickets "
                             f"{[(t.name, t.error) for t in failed]}")
    check_tickets([t for t in tickets if t.error is None], oracle,
                  "chaos without retry")
    st = server.stats
    if st["served"] != len(tickets) or st["shed"] != len(failed):
        raise AssertionError(f"chaos without retry: stats {st}")
    server.telemetry.check_invariants()
    log(f"  chaos without retry: {len(failed)} of {len(tickets)} resolved "
        f"with InjectedDispatchError (injected {server.faults.injected}), "
        f"the rest equal evaluate_bgp; served {st['served']} [{card}]")

    # 3. a shard-down window on a FakeClock: healthy, inside, after
    restart()
    clock = FakeClock()
    server = fault_server(main_path, clock=clock, faults=FaultPlan(
        shard_down=((DOWN_SHARD, 1.0, 2.0),)))
    torch.cuda.reset_peak_memory_stats(DEV)
    base_healthy = torch.cuda.memory_allocated(DEV)
    healthy = serve_passes(server, [one_pass])
    peak_healthy = torch.cuda.max_memory_allocated(DEV)
    check_results(one_pass, healthy, oracle, "before the window")
    clock.t += 1.5
    lost = uncovered_templates(queries, *degraded_placement(part,
                                                            DOWN_SHARD))
    misses = cache.misses
    torch.cuda.reset_peak_memory_stats(DEV)
    base = torch.cuda.memory_allocated(DEV)
    inside = serve_passes(server, [one_pass])
    peak = torch.cuda.max_memory_allocated(DEV)
    built_down = cache.misses - misses
    if server.degraded != DOWN_SHARD or server.shed_templates != lost:
        raise AssertionError(f"shard-down window: degraded "
                             f"{server.degraded}, shed "
                             f"{sorted(server.shed_templates)}, uncovered "
                             f"{sorted(lost)}")
    check_results(one_pass, inside, oracle, "inside the window", shed=lost)
    clock.t += 1.0
    misses = cache.misses
    after = serve_passes(server, [one_pass])
    built_up = cache.misses - misses
    check_results(one_pass, after, oracle, "after the window")
    st = server.stats
    if server.degraded is not None or built_up:
        raise AssertionError(f"restore: degraded {server.degraded}, "
                             f"{built_up} engines built")
    log(f"  shard {DOWN_SHARD} down for [1.0, 2.0) s: shed "
        f"{sorted(lost)} (= uncovered_templates) with ShardDownError, "
        f"the other {len(queries) - len(lost)} equal evaluate_bgp, "
        f"degraded_served {st['degraded_served']}; engines built by the "
        f"degrade {built_down}, by the restore {built_up}; "
        f"max_memory_allocated of the pass while degraded {peak:,} bytes, "
        f"{peak - base:,} above the {base:,} allocated before it (both "
        f"states' blocks on the card once it entered the window); of the "
        f"healthy pass {peak_healthy:,}, {peak_healthy - base_healthy:,} "
        f"above {base_healthy:,}; epoch {server.epoch} [{card}]")

    # 4. replication, then failover around the same shard
    restart()
    server = fault_server(main_path)
    serve_passes(server, [one_pass])
    before_ms = timed_serves(server, one_pass, SERVE_REPS)
    restart()
    serve_passes(server, [one_pass])
    launches_before = path_launches()
    misses = cache.misses
    t0 = time.perf_counter()
    rep = server.replicate_hot()
    torch.cuda.synchronize()
    rep_ms = (time.perf_counter() - t0) * 1e3
    restart()
    check_results(one_pass, serve_passes(server, [one_pass]), oracle,
                  "after replicate_hot")
    launches_after = path_launches()
    built = cache.misses - misses
    after_ms = timed_serves(server, one_pass, SERVE_REPS)
    if not rep["replicated_triples"] or sum(rep["collectives_after"]) \
            >= sum(rep["collectives_before"]):
        raise AssertionError(f"replicate_hot: {rep}")
    log(f"  replicate_hot: {rep['replicated_units']} unit copies, "
        f"{rep['replicated_triples']} triples, {rep['plans_rewritten']} "
        f"plans rewritten ({rep['queries_affected']}), collectives "
        f"{rep['collectives_before']} -> {rep['collectives_after']}, "
        f"cap_grew {rep['cap_grew']}, {built} engines built, "
        f"{rep_ms:.3f} ms; every answer equals evaluate_bgp [{card}]")
    log(f"  serve() of one pass, median of {SERVE_REPS}: "
        f"{float(np.median(before_ms)):.3f} ms before "
        f"{[round(t, 3) for t in before_ms]}, "
        f"{float(np.median(after_ms)):.3f} ms after "
        f"{[round(t, 3) for t in after_ms]}; launches a pass "
        f"{launches_before} -> {launches_after} [{card}]")
    restart()
    misses = cache.misses
    queued = [server.submit(n, p, _pump=False) for n, p in one_pass]
    down = server.mark_shard_down(DOWN_SHARD)
    shed = set(down["shed_templates"])
    if any(not (t.done and isinstance(t.error, ShardDownError))
           for t in queued if t.name in shed):
        raise AssertionError("failover: a queued uncovered ticket was not "
                             "resolved at once")
    server.drain()
    covered = [t for t in queued if t.name not in shed]
    check_tickets(covered, oracle, "failover")
    st = server.stats
    if covered and not st["degraded_served"]:
        raise AssertionError(f"failover: degraded_served 0, stats {st}")
    built_down = cache.misses - misses
    misses = cache.misses
    up = server.mark_shard_up()
    check_results(one_pass, serve_passes(server, [one_pass]), oracle,
                  "after the restore")
    log(f"  failover with {len(queued)} queued: {down}; {len(shed)} "
        f"resolved at once with ShardDownError, {len(covered)} drained "
        f"equal to evaluate_bgp (degraded_served "
        f"{st['degraded_served']}), {built_down} engines built; "
        f"mark_shard_up {up}, {cache.misses - misses} engines built "
        f"[{card}]")

    # 5. the adaptive controller on a drifting stream, then under aborts
    wa, wb = two_phase_weights(queries)
    drift = drifting_stream(queries, [(ADAPT_PHASE, wa), (ADAPT_PHASE, wb)],
                            seed=0)
    for aborts in (0, 99):
        restart()
        server = fault_server(
            main_path, adaptive=AdaptiveConfig(**ADAPT_CONFIG),
            faults=FaultPlan(abort_migrations=aborts) if aborts else None)
        migrate, mig_ms = server.migrate, []

        def timed_migrate(new_part, _migrate=migrate, _ms=mig_ms):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return _migrate(new_part)
            finally:
                torch.cuda.synchronize()
                _ms.append((time.perf_counter() - t0) * 1e3)

        server.migrate = timed_migrate
        misses = cache.misses
        results = []
        for i in range(0, len(drift), ADAPT_CHUNK):
            results += server.serve(drift[i:i + ADAPT_CHUNK])
        torch.cuda.synchronize()
        check_results(drift, results, oracle,
                      f"adaptive (abort_migrations={aborts})")
        events = [(e.severity, round(e.divergence, 4), e.mode,
                   e.moved_triples, e.budget_triples,
                   round(e.cost_before, 3), round(e.cost_after, 3))
                  for e in server.adaptive.events]
        st = server.stats
        if aborts:
            injected = server.faults.injected["migration_abort"]
            if server.epoch != 0 or st["migration_aborts"] != injected:
                raise AssertionError(
                    f"adaptive under aborts: epoch {server.epoch}, "
                    f"migration_aborts {st['migration_aborts']}, injected "
                    f"{injected}")
            log(f"  adaptive under abort_migrations=99: epoch 0, "
                f"migration_aborts {st['migration_aborts']} = injected; "
                f"events (severity, divergence, mode, moved, budget, cost "
                f"before, after) {events}; every answer equals "
                f"evaluate_bgp [{card}]")
        else:
            reports = [e.migration for e in server.adaptive.events
                       if e.migration is not None]
            log(f"  adaptive ({ADAPT_CONFIG}, {len(drift)} requests of a "
                f"two-phase drift, {ADAPT_CHUNK} a serve()): events "
                f"(severity, divergence, mode, moved, budget, cost before, "
                f"after) {events}; {server.adaptive.n_migrations} "
                f"migrations, epoch {server.epoch}, migrate() ms "
                f"{[round(t, 3) for t in mig_ms]}, reports {reports}; "
                f"{cache.misses - misses} engines built; every answer "
                f"equals evaluate_bgp [{card}]")
    restart()
    for k in ("scan_select", "join_ranges", "join_select"):
        if launched[k] <= 0:
            raise AssertionError(f"phase 4c never launched {k}")
    log(f"  phase 4c launches {launched}; "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return launched


# ---------------------------------------------------------------------------
# phase 4d: the mesh, one rank per shard on torch.distributed
# ---------------------------------------------------------------------------

MESH_BACKEND = "gloo"        # several ranks on the one card
MESH_TIMEOUT = 300.0         # seconds a collective may wait for a rank
MESH_JOIN = 600.0            # seconds a spawn's ranks get in all
MESH_WIDE = 8                # shards (ranks) of the wide WawPart run
MESH_MPR = 1024              # run_sharded's max_per_row: phase 6's LUBM(1)
MESH_SERVE_REPS = 5          # timed first-pass serve() calls (cache off)
# the expand join under the random placement and over 8 shards gathers
# up to 3 x 65,536 and 8 x 65,536 matches against bucket 4's 32,768 table
# rows, past compat_select's 2^31 pairs an instance; gather_cap compacts
# the gathered matches to the most that stays under it (32,768 x 65,535),
# losslessly: a scan cap of 65,536 or less is 1.5 times its pattern's
# count in the whole store plus 8, and the owner gate keeps each triple
# once, so no gathered block holds more than 43,690 matches
MESH_GATHER_CAP = (2 ** 31 - 1) // 32768


def digest(outs) -> str:
    """A SHA-1 of a (table, mask, overflow)'s shapes, dtypes and bytes."""
    h = hashlib.sha1()
    for t in outs:
        a = t.cpu().numpy() if isinstance(t, torch.Tensor) else t
        h.update(f"{a.shape}{a.dtype}".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def mesh_buckets(mesh, kg, buckets, join: str, gather_cap) -> list[dict]:
    """Every bucket of ``kg`` through the mesh engine (all members, one
    call each) on this rank: the outputs' digest, the counted gathers and
    gathered bytes, the kernel launches and the call's ms."""
    tr, va, pe = kg_local(kg, mesh, shard_perms(kg))
    cache = engine_batch.EngineCache()
    out = []
    for b in buckets:
        fn = cache.get(b.signature, join_impl=join, mesh=mesh, backend="cuda",
                       gather_cap=gather_cap)
        pd, params = engine_batch.stage_batch(
            b, [(i, None) for i in range(len(b.plans))], mesh=mesh)
        torch.cuda.synchronize()
        reset_counts()
        mesh.reset_counts()
        t0 = time.perf_counter()
        res = fn(tr, va, pe, pd, params)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out.append({"digest": digest(res), "gathers": mesh.collectives,
                    "bytes": mesh.gathered_bytes, "launches": counts(),
                    "ms": ms})
    return out


def mesh_rank(mesh, job: dict) -> dict:
    """One rank of phase 4d: the bucket runs, run_sharded of each
    template, and (for a job with "serve") the mesh-routed server on rank
    0 while the other ranks run serve_worker."""
    torch.cuda.reset_peak_memory_stats(mesh.device)
    out = {"rank": mesh.rank, "device": str(mesh.device),
           "name": torch.cuda.get_device_name(mesh.device),
           "count": torch.cuda.device_count(), "buckets": {}, "pq": {}}
    for (label, join), (kg, buckets, cap) in job["buckets"].items():
        out["buckets"][(label, join)] = mesh_buckets(mesh, kg, buckets, join,
                                                     cap)
    for (label, join), (kg, plans) in job.get("pq", {}).items():
        runs = {}
        for name, plan in plans.items():
            reset_counts()
            mesh.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_sharded(plan, kg, mesh, join_impl=join,
                              max_per_row=MESH_MPR, backend="cuda")
            torch.cuda.synchronize()
            runs[name] = {"res": res, "gathers": mesh.collectives,
                          "bytes": mesh.gathered_bytes,
                          "ms": (time.perf_counter() - t0) * 1e3,
                          "launches": counts()}
        out["pq"][(label, join)] = runs
    if "serve" in job:
        if mesh.rank:
            out["worker"] = serve_worker(mesh)
        else:
            try:
                out["serve"] = mesh_serve(mesh, *job["serve"])
            finally:
                stop_workers(mesh)
    out["peak"] = torch.cuda.max_memory_allocated(mesh.device)
    return out


def mesh_serve(mesh, queries, part, oracle) -> dict:
    """Rank 0 of phase 4d's server: two passes of the 14 templates as
    phase 4 serves them, the first-pass serve() ms with the answer cache
    off, then replicate_hot() and a pass after it, each pass's counted
    gathers."""
    one_pass = request_stream(queries, len(queries))
    server = WorkloadServer(queries, part, join_impl="sorted",
                            backend="cuda", mesh=mesh)
    server.warmup(one_pass)
    torch.cuda.synchronize()
    mesh.reset_counts()
    reset_counts()
    per_call, results = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        results += server.serve(one_pass)
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) * 1e3)
    check_results(one_pass * 2, results, oracle, "mesh server")
    out = {"per_call": per_call, "launches": counts(),
           "gathers": mesh.collectives, "bytes": mesh.gathered_bytes,
           "cuts": server.collective_counts(), "stats": server.stats}
    cold = WorkloadServer(queries, part, join_impl="sorted", backend="cuda",
                          mesh=mesh, cache=server.cache, answer_cache=False)
    check_results(one_pass, cold.serve(one_pass), oracle, "mesh server")
    out["first_pass_ms"] = timed_serves(cold, one_pass, MESH_SERVE_REPS)
    rep = server.replicate_hot()
    mesh.reset_counts()
    after = server.serve(one_pass)
    torch.cuda.synchronize()
    check_results(one_pass, after, oracle, "mesh server after replicate_hot")
    out.update(replicate=rep, gathers_after=mesh.collectives,
               bytes_after=mesh.gathered_bytes)
    return out


def mesh_reference(kg, buckets, join: str, gather_cap) -> list[dict]:
    """The single-device engine on the card over the same calls: each
    bucket's outputs' digest and launches; no overflow flag may be
    set."""
    tr, va, pe = engine_batch.kg_tensors(kg, None, DEV)
    cache = engine_batch.EngineCache()
    out = []
    for bi, b in enumerate(buckets):
        fn = cache.get(b.signature, join_impl=join, backend="cuda",
                       gather_cap=gather_cap)
        pd, params = engine_batch.stage_batch(
            b, [(i, None) for i in range(len(b.plans))], device=DEV)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = fn(tr, va, pe, pd, params)
        torch.cuda.synchronize()
        out.append({"digest": digest(res), "launches": counts(),
                    "ms": (time.perf_counter() - t0) * 1e3})
        if res[2].any():
            raise AssertionError(f"{join} bucket {bi} (gather_cap "
                                 f"{gather_cap}): overflow flag set")
    return out


def check_mesh_buckets(label: str, join: str, ranks, ref, buckets) -> dict:
    """Every rank's outputs equal the single-device engine's, its counted
    gathers bucket_collectives, its launches the single-device call's."""
    cuts = [bucket_collectives(b.signature) for b in buckets]
    for r in ranks:
        got = r["buckets"][(label, join)]
        for bi, (g, want, cut) in enumerate(zip(got, ref, cuts)):
            what = f"{label} {join} bucket {bi} rank {r['rank']}"
            if g["digest"] != want["digest"]:
                raise AssertionError(f"{what}: outputs differ from the "
                                     "single-device engine's on the card")
            if g["gathers"] != cut:
                raise AssertionError(f"{what}: {g['gathers']} gathers for "
                                     f"bucket_collectives {cut}")
            if g["launches"] != want["launches"]:
                raise AssertionError(f"{what}: launches {g['launches']}, "
                                     f"single device {want['launches']}")
    total = {k: sum(c["launches"][k] for c in ref) for k in OPS}
    return {"cuts": cuts, "bytes": [c["bytes"] for c in ranks[0]["buckets"][
        (label, join)]], "launches": {k: v for k, v in total.items() if v},
        "ms": [round(c["ms"], 3) for c in ranks[0]["buckets"][
            (label, join)]], "ref_ms": [round(c["ms"], 3) for c in ref]}


def phase_mesh(main_path: dict, main_counts: dict, card: str) -> dict:
    """Phase 4d on phase 4's LUBM(1) store: 3 gloo ranks (WawPart and
    random, both joins, run_sharded, the server) and 8 (WawPart), all on
    the one card. Returns the kernel launches per rank of the bucket
    runs."""
    t_phase = time.perf_counter()
    store, queries, oracle = (main_path["store"], main_path["queries"],
                              main_path["oracle"])
    parts = {"wawpart": main_path["part"],
             "random": random_partition(store, queries, n_shards=3, seed=0)}
    job, refs, plans_of = {"buckets": {}, "pq": {}}, {}, {}
    for label, part in parts.items():
        kg = ShardedKG.build(part)
        plans = pq_plans(queries, part)
        buckets = engine_batch.bucket_plans(list(plans.values()))
        plans_of[label] = (plans, buckets)
        for join in ("expand", "sorted"):
            cap = MESH_GATHER_CAP if (join, label) == ("expand", "random") \
                else None
            job["buckets"][(label, join)] = (kg, buckets, cap)
            refs[(label, join)] = mesh_reference(kg, buckets, join, cap)
        job["pq"][(label, "sorted")] = (kg, plans)
    job["pq"][("wawpart", "expand")] = job["pq"][("wawpart", "sorted")]
    job["serve"] = (queries, parts["wawpart"], oracle)
    t0 = time.perf_counter()
    ranks = spawn(3, mesh_rank, job, backend=MESH_BACKEND, device="cuda",
                  timeout=MESH_TIMEOUT, join_timeout=MESH_JOIN)
    t_spawn3 = time.perf_counter() - t0
    shared = {(r["device"], r["name"], r["count"]) for r in ranks}
    log(f"  3 ranks ({MESH_BACKEND}), {t_spawn3:.1f} s from spawn to the "
        f"last rank's exit; devices {sorted(shared)}: "
        + ("every rank on the one card" if len(shared) == 1
           and torch.cuda.device_count() == 1 else "several cards"))
    summary = {}
    for (label, join) in job["buckets"]:
        summary[(label, join)] = check_mesh_buckets(
            label, join, ranks, refs[(label, join)],
            plans_of[label][1])
        cap = job["buckets"][(label, join)][2]
        log(f"  {label} {join}"
            + (f" (gather_cap {cap})" if cap else "")
            + ": every bucket's outputs on every rank equal "
            f"the single-device engine's on the card; gathers a call "
            f"{summary[(label, join)]['cuts']} = bucket_collectives; "
            f"gathered bytes a rank {summary[(label, join)]['bytes']}; "
            f"launches a rank {summary[(label, join)]['launches']} = the "
            f"single-device calls'; ms a call on rank 0 (a rank's first "
            f"call holds its start-up) {summary[(label, join)]['ms']} "
            f"(single device "
            f"{summary[(label, join)]['ref_ms']})")
    want = {k: main_counts[k] for k in ("scan_select", "join_ranges",
                                        "join_select")}
    got = {k: summary[("wawpart", "sorted")]["launches"].get(k, 0)
           for k in want}
    if got != want:
        raise AssertionError(f"mesh WawPart sorted: launches a rank {got}, "
                             f"phase 4's {want}")
    if not summary[("wawpart", "expand")]["launches"].get("compat_select"):
        raise AssertionError("mesh WawPart expand: no compat_select")

    for (label, join), (kg, plans) in job["pq"].items():
        rows = {}
        for r in ranks:
            for name, run in r["pq"][(label, join)].items():
                if r["rank"] == 0:
                    rows[name] = (run["gathers"], run["bytes"],
                                  round(run["ms"], 3))
                rows_, n, ovf = run["res"]
                if ovf or not np.array_equal(rows_, oracle[name]):
                    raise AssertionError(f"run_sharded {label} {join} "
                                         f"{name} rank {r['rank']}: differs "
                                         "from the oracle")
                if run["gathers"] != plans[name].n_gathers:
                    raise AssertionError(f"run_sharded {label} {join} "
                                         f"{name}: {run['gathers']} gathers "
                                         f"for n_gathers "
                                         f"{plans[name].n_gathers}")
        log(f"  run_sharded {label} {join} (max_per_row {MESH_MPR}): every "
            f"template on every rank equals evaluate_bgp; (gathers = "
            f"n_gathers, gathered bytes a rank, ms on rank 0) {rows}")
    # the centralized placement (phase 6's third) is one shard: a mesh of
    # one, in this process, with no process group and no gather
    one = make_engine_mesh(1, device=DEV)
    cpart = centralized_partition(store, queries)
    ckg = ShardedKG.build(cpart)
    for name, plan in pq_plans(queries, cpart).items():
        rows_, n, ovf = run_sharded(plan, ckg, one, join_impl="sorted",
                                    max_per_row=MESH_MPR, backend="cuda")
        if ovf or not np.array_equal(rows_, oracle[name]):
            raise AssertionError(f"run_sharded centralized {name}: differs "
                                 "from the oracle")
    if one.collectives:
        raise AssertionError(f"centralized: {one.collectives} gathers")
    log(f"  run_sharded centralized (a mesh of one, sorted): every template "
        f"equals evaluate_bgp, no gather")
    for label in parts:
        runs = ranks[0]["pq"][(label, "sorted")]
        log(f"  the distributed join's cost, {label}: gathers "
            f"{sum(r['gathers'] for r in runs.values())} and gathered bytes "
            f"{sum(r['bytes'] for r in runs.values()):,} a rank over the 14 "
            f"templates (run_sharded, sorted); bucket engine "
            f"{sum(summary[(label, 'sorted')]['cuts'])} gathers and "
            f"{sum(summary[(label, 'sorted')]['bytes']):,} bytes a rank")

    srv = ranks[0]["serve"]
    served = {k: srv["launches"][k] for k in want}
    if served != want:
        raise AssertionError(f"mesh server: launches on rank 0 {served}, "
                             f"phase 4's {want}")
    workers = [r["worker"] for r in ranks[1:]]
    if any(w["collectives"] != workers[0]["collectives"] for w in workers) \
            or srv["gathers"] != sum(srv["cuts"]):
        raise AssertionError(f"mesh server gathers: rank 0 {srv['gathers']} "
                             f"for cuts {srv['cuts']}; workers "
                             f"{[w['collectives'] for w in workers]}")
    rep = srv["replicate"]
    if not (srv["gathers_after"] == sum(rep["collectives_after"])
            < sum(rep["collectives_before"])):
        raise AssertionError(f"replicate_hot: gathers {srv['gathers']} -> "
                             f"{srv['gathers_after']}, report {rep}")
    log(f"  mesh server (rank 0 serves, ranks 1-2 serve_worker): two passes "
        f"of the 14 templates, every answer equals evaluate_bgp; serve() "
        f"{[round(t, 3) for t in srv['per_call']]} ms (phase 4, one card: "
        f"{[round(t * 1e3, 3) for t in main_path['per_call']]} ms); "
        f"first pass, answer cache off, {MESH_SERVE_REPS} calls "
        f"{[round(t, 3) for t in srv['first_pass_ms']]} ms (median "
        f"{np.median(srv['first_pass_ms']):.3f}); launches on rank 0 "
        f"{ {k: v for k, v in srv['launches'].items() if v} }; gathers "
        f"{srv['gathers']} ({srv['bytes']:,} bytes) for cuts {srv['cuts']}; "
        f"replicate_hot: {rep['replicated_triples']} triples, cuts "
        f"{rep['collectives_before']} -> {rep['collectives_after']}, "
        f"gathers a pass {srv['gathers']} -> {srv['gathers_after']} "
        f"({srv['bytes']:,} -> {srv['bytes_after']:,} bytes); workers "
        f"(states, dispatches, gathered bytes) "
        f"{[(w['states'], w['dispatches'], w['gathered_bytes'])
            for w in workers]}")
    log(f"  peak memory a rank (max_memory_allocated, 3 ranks): "
        f"{[r['peak'] for r in ranks]} bytes")

    wide = wawpart_partition(store, queries, n_shards=MESH_WIDE)
    kg8 = ShardedKG.build(wide)
    buckets8 = engine_batch.bucket_plans(pq_plans(queries, wide).values())
    job8 = {"buckets": {}}
    refs8 = {}
    for join in ("expand", "sorted"):
        cap = MESH_GATHER_CAP if join == "expand" else None
        job8["buckets"][("wawpart8", join)] = (kg8, buckets8, cap)
        refs8[join] = mesh_reference(kg8, buckets8, join, cap)
    t0 = time.perf_counter()
    ranks8 = spawn(MESH_WIDE, mesh_rank, job8, backend=MESH_BACKEND,
                   device="cuda", timeout=MESH_TIMEOUT,
                   join_timeout=MESH_JOIN)
    t_spawn8 = time.perf_counter() - t0
    for join in ("expand", "sorted"):
        s8 = check_mesh_buckets("wawpart8", join, ranks8, refs8[join],
                                buckets8)
        log(f"  WawPart {MESH_WIDE} shards {wide.shard_sizes.tolist()}, "
            f"{join}"
            + (f" (gather_cap {MESH_GATHER_CAP})" if join == "expand" else "")
            + ": every bucket's outputs on every rank equal the "
            f"single-device engine's on the card; gathers a call "
            f"{s8['cuts']} = bucket_collectives; gathered bytes a rank "
            f"{s8['bytes']}; launches a rank {s8['launches']}; ms a call "
            f"on rank 0 (a rank's first call holds its start-up) "
            f"{s8['ms']} (single device {s8['ref_ms']})")
    log(f"  8 ranks: {t_spawn8:.1f} s from spawn to the last rank's exit, "
        f"devices {sorted({(r['device'], r['count']) for r in ranks8})}, "
        f"peak memory a rank {[r['peak'] for r in ranks8]} bytes; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return {k: v for k, v in summary[("wawpart", "sorted")]["launches"]
            .items()}

# ---------------------------------------------------------------------------
# phase 6: the per-query engine (the paper's execution path)
# ---------------------------------------------------------------------------

def pq_plans(queries, part) -> dict:
    return {q.name: make_plan(q, part) for q in queries}


def pq_expected(plans, join_impl: str) -> dict:
    """The kernel launches of one run_vmapped per plan: a scan_select per
    step; per join a compat_select (expand joins, and the sorted join's
    steps without a shared or a new variable), a join_select (a merge step
    on one shared column) or a join_ranges with the scan_select of its
    pair mask (a merge step that verifies a second shared column)."""
    steps = [s for p in plans.values() for s in p.steps if not s.is_noop]
    merge = [s for s in steps if join_impl == "sorted" and s.shared and s.new]
    verified = sum(len(s.shared) > 1 for s in merge)
    return {"scan_select": len(steps) + verified,
            "compat_select": len(steps) - len(merge),
            "join_select": len(merge) - verified, "join_ranges": verified,
            "compat_matrix": 0, "scan_hits": 0}


def call_ms(fn, reps: int = PQ_REPS) -> float:
    """Median wall milliseconds of fn() after one warm call, with
    torch.cuda.synchronize before and after each call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def pq_fanout(plans, kg) -> int:
    """The sorted join's max_per_row: benchmarks/harness.py's 256, doubled
    until no template flags an overflow."""
    mpr = PQ_FANOUT
    while True:
        flagged = [name for name, plan in plans.items()
                   if run_vmapped(plan, kg, join_impl="sorted",
                                  max_per_row=mpr, backend="cuda",
                                  device=DEV)[2]]
        if not flagged:
            return mpr
        log(f"  max_per_row {mpr}: overflow in {flagged}; doubling")
        mpr *= 2
        if mpr > PQ_FANOUT_LIMIT:
            raise AssertionError(f"overflow past max_per_row "
                                 f"{PQ_FANOUT_LIMIT}: {flagged}")


def pq_exact(label: str, plans, kg, join_impl: str, mpr: int) -> None:
    """Every template's whole table, mask and overflow flag from the
    kernels (backend "cuda") equal the plain primitives' (backend "torch")
    on the same tensors on the card."""
    tr, va = kg.to_device(DEV)
    wall = {"cuda": 0.0, "torch": 0.0}
    for name, plan in plans.items():
        params = torch.zeros((max(1, plan.n_params),), dtype=torch.int32,
                             device=DEV)
        out = {}
        for backend in ("cuda", "torch"):
            engine = make_engine(plan, join_impl=join_impl, max_per_row=mpr,
                                 backend=backend)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[backend] = engine(tr, va, params)
            torch.cuda.synchronize()
            wall[backend] += time.perf_counter() - t0
        for a, b, what in zip(out["cuda"], out["torch"],
                              ("table", "mask", "overflow")):
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"{label} {join_impl} {name}: the "
                                     f"kernels' {what} differs from the "
                                     f"plain primitives'")
        del out
    log(f"  {label}, join {join_impl}: every template's table, mask and "
        f"overflow (backend cuda) bit-identical to the plain primitives' "
        f"(backend torch) on the card; one call each: {wall['cuda']:.3f} s "
        f"with the kernels, {wall['torch']:.3f} s plain")


def pq_workload(label: str, plans, kg, join_impl: str, mpr: int, oracle,
                card: str, bucket=None, profile: bool = False) -> dict:
    """One counted pass of run_vmapped over every plan, each answer held
    to the oracle (and to the bucket engine's), then each template's
    engine call timed with the shard blocks on the card (and, with
    ``profile``, one pass over the templates profiled). Returns the
    launches, ms per template, their sum and the peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    base = torch.cuda.memory_allocated(DEV)
    reset_counts()
    results = {name: run_vmapped(plan, kg, join_impl=join_impl,
                                 max_per_row=mpr, backend="cuda", device=DEV)
               for name, plan in plans.items()}
    torch.cuda.synchronize()
    launched = counts()
    for name, (rows, n, ovf) in results.items():
        if ovf:
            raise AssertionError(f"{label} {join_impl} {name}: overflow "
                                 f"flag set")
        if not np.array_equal(rows, oracle[name]) or n != len(oracle[name]):
            raise AssertionError(f"{label} {join_impl} {name}: result "
                                 f"differs from the oracle")
        if bucket is not None and not np.array_equal(rows, bucket[name]):
            raise AssertionError(f"{label} {join_impl} {name}: result "
                                 f"differs from the bucket engine's")
    expected = pq_expected(plans, join_impl)
    wrong = {k: (launched[k], v) for k, v in expected.items()
             if launched[k] != v}
    if wrong:
        raise AssertionError(f"{label} {join_impl}: launches (counted, "
                             f"expected) {wrong}")
    tr, va = kg.to_device(DEV)
    ms, calls = {}, []
    for name, plan in plans.items():
        engine = make_engine(plan, join_impl=join_impl, max_per_row=mpr,
                             backend="cuda")
        params = torch.zeros((max(1, plan.n_params),), dtype=torch.int32,
                             device=DEV)
        calls.append(lambda e=engine, p=params: e(tr, va, p))
        ms[name] = call_ms(calls[-1])
    peak = torch.cuda.max_memory_allocated(DEV)
    if profile:
        log(f"  {label}, join {join_impl}, one call of each template, "
            f"profiled: " + device_breakdown(lambda: [c() for c in calls]))
    total = sum(ms.values())
    log(f"  {label}, join {join_impl}"
        + (f", max_per_row {mpr}" if join_impl == "sorted" else "")
        + f" ({card})"
        + f": every answer equals evaluate_bgp"
        + (" and the bucket engine's" if bucket is not None else "")
        + f", no overflow ({sum(len(oracle[n]) for n in plans):,} "
        f"solutions); launches "
        f"{ {k: launched[k] for k in expected} } (as the plans' steps give "
        f"them); median ms per call {ms}; workload {total:.3f} ms; "
        f"n_gathers { {n: p.n_gathers for n, p in plans.items()} }; "
        f"max_memory_allocated {peak:,} bytes ({peak - base:,} above the "
        f"{base:,} allocated before the run)")
    return {"launches": {k: launched[k] for k in expected}, "ms": ms,
            "total_ms": total, "peak": peak, "above": peak - base,
            "max_per_row": mpr}


def phase_per_query(main_path: dict, card: str) -> dict:
    """The paper's per-query engine on the card: LUBM(1) under WawPart
    (both joins) and under random and centralized placements (sorted
    join), BSBM at 1,000 products under WawPart (both joins). Returns
    each run's record and the summed launches."""
    t_phase = time.perf_counter()
    store, part = main_path["store"], main_path["part"]
    oracle, bucket = main_path["oracle"], main_path["answers"]
    queries = lubm_queries()
    cfg = lubm_config.full()
    assert (cfg.scale, cfg.seed, cfg.n_shards) == (1.0, 0, 3)
    runs = {}
    kg = ShardedKG.build(part)
    plans = pq_plans(queries, part)
    mpr = pq_fanout(plans, kg)
    log(f"  LUBM (configs/lubm.full(): {cfg.n_universities} university, "
        f"scale {cfg.scale}, seed {cfg.seed}), {len(store):,} triples, "
        f"WawPart {part.shard_sizes.tolist()}, kg {kg.triples.shape}: "
        f"sorted join's "
        f"max_per_row {mpr} (the smallest power of two from {PQ_FANOUT} "
        f"that clears every overflow)")
    for join_impl in ("expand", "sorted"):
        pq_exact("LUBM WawPart", plans, kg, join_impl, mpr)
        runs[f"lubm-wawpart-{join_impl}"] = pq_workload(
            "LUBM WawPart", plans, kg, join_impl, mpr, oracle, card, bucket,
            profile=True)

    for method, bpart in (
            ("random", random_partition(store, queries, n_shards=3, seed=0)),
            ("centralized", centralized_partition(store, queries))):
        bkg = ShardedKG.build(bpart)
        runs[f"lubm-{method}-sorted"] = pq_workload(
            f"LUBM {method} {bpart.shard_sizes.tolist()}",
            pq_plans(queries, bpart), bkg, "sorted", mpr, oracle, card)

    bcfg = bsbm_config.full()
    bstore = generate_bsbm(BSBM_PRODUCTS, seed=bcfg.seed)
    bqueries = bsbm_queries()
    bpart = wawpart_partition(bstore, bqueries, n_shards=bcfg.n_shards)
    bkg = ShardedKG.build(bpart)
    bplans = pq_plans(bqueries, bpart)
    boracle = {n: evaluate_bgp(bstore, p.query, order=p.meta["order"])
               for n, p in bplans.items()}
    bmpr = pq_fanout(bplans, bkg)
    log(f"  BSBM {BSBM_PRODUCTS:,} products: {len(bstore):,} triples, "
        f"WawPart {bpart.shard_sizes.tolist()}, kg {bkg.triples.shape}; "
        f"sorted join's max_per_row {bmpr}")
    for join_impl in ("expand", "sorted"):
        server = WorkloadServer(bqueries, bpart, join_impl=join_impl,
                                backend="cuda", device=DEV)
        stream = request_stream(bqueries, len(bqueries))
        served = {name: rows for (name, _), (rows, _, ovf)
                  in zip(stream, server.serve(stream)) if not ovf}
        if served.keys() != boracle.keys():
            raise AssertionError(f"BSBM bucket engine ({join_impl}) flagged "
                                 f"an overflow")
        pq_exact("BSBM WawPart", bplans, bkg, join_impl, bmpr)
        runs[f"bsbm-wawpart-{join_impl}"] = pq_workload(
            "BSBM WawPart", bplans, bkg, join_impl, bmpr, boracle, card,
            served)

    log(f"  workload time (sum of the templates' median ms, Figs. 5/6), "
        f"{card}: " + ", ".join(f"{k} {r['total_ms']:.3f} ms"
                                for k, r in runs.items()))
    log(f"  peak memory by run (max_memory_allocated, and above what was "
        f"allocated before the run), {card}: "
        + ", ".join(f"{k} {r['peak']:,} ({r['above']:,})"
                    for k, r in runs.items())
        + f"; phase {time.perf_counter() - t_phase:.1f} s")
    total = {}
    for r in runs.values():
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    return {"runs": runs, "launches": total}


# ---------------------------------------------------------------------------
# phase 7: WawPart's query clustering at a production workload's size
# ---------------------------------------------------------------------------

def phase_clustering() -> dict:
    """Distances of the production workload through the entry point, then
    linkage_torch on the card (timed) and against its CPU run."""
    queries = production_queries()
    reset_counts()
    t0 = time.perf_counter()
    dist = jaccard_distance_matrix(queries, use_kernel=True, device=DEV)
    t_dist = time.perf_counter() - t0
    launched = counts()
    n = len(queries)
    if (dist.shape != (n, n) or dist.dtype != np.float32
            or not np.array_equal(dist, dist.T) or np.diag(dist).any()):
        raise AssertionError("distance matrix is not a symmetric (Q, Q) "
                             "float32 matrix with a zero diagonal")
    log(f"  jaccard_distance_matrix(use_kernel=True) over {n:,} queries: "
        f"{t_dist:.3f} s host wall (features, copy in, kernel, "
        f"{dist.nbytes:,} bytes back); launches {launched}")

    d = dist[:LINKAGE_N, :LINKAGE_N]
    timed = {}
    for link in LINKAGES:
        t0 = time.perf_counter()
        z = linkage_torch(d, link, device=DEV)
        timed[link] = time.perf_counter() - t0
        if (z.shape != (LINKAGE_N - 1, 4) or z[-1, 3] != LINKAGE_N
                or not np.isfinite(z).all()):
            raise AssertionError(f"{link} linkage over {LINKAGE_N} is "
                                 "malformed")
        if link == "single" and (np.diff(z[:, 2]) < 0).any():
            raise AssertionError("single linkage heights decrease")
        log(f"  linkage_torch {link} over the first {LINKAGE_N:,} instances "
            f"on the card: {timed[link]:.3f} s "
            f"({timed[link] / (LINKAGE_N - 1) * 1e3:.4f} ms per merge, no "
            f"host sync inside the loop); top merge at {z[-1, 2]:.6f}")

    d = dist[:LINKAGE_CHECK_N, :LINKAGE_CHECK_N]
    log(f"  linkage_torch single over {LINKAGE_CHECK_N:,}, profiled: "
        + device_breakdown(lambda: linkage_torch(d, "single", device=DEV)))
    for link in LINKAGES:
        z = linkage_torch(d, link, device=DEV)
        t0 = time.perf_counter()
        zc = linkage_torch(d, link, device="cpu")
        t_cpu = time.perf_counter() - t0
        if link == "average":
            same = (np.array_equal(z[:, [0, 1, 3]], zc[:, [0, 1, 3]])
                    and np.abs(z[:, 2] - zc[:, 2]).max() <= 1e-6)
        else:
            same = np.array_equal(z, zc)
        if not same:
            raise AssertionError(f"{link} linkage over {LINKAGE_CHECK_N}: "
                                 "card and CPU differ")
        log(f"  linkage_torch {link} over {LINKAGE_CHECK_N:,}: card equals "
            f"CPU (identical matrix{'' if link != 'average' else ' pairs'}, "
            f"max |height diff| {np.abs(z[:, 2] - zc[:, 2]).max()}); "
            f"CPU {t_cpu:.3f} s")
    return launched


# ---------------------------------------------------------------------------
# phase 8: xDeepFM serving forward at full width
# ---------------------------------------------------------------------------

def wall_ms(fn, reps: int) -> float:
    """Median host milliseconds of fn() to a synchronised end, after one
    untimed run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def plain_forward(model: XDeepFM, sparse, dense) -> torch.Tensor:
    """The forward without kernels, over batch chunks of PLAIN_CHUNK: the
    plain CIN materializes (chunk, H, F, D)."""
    return torch.cat([model(sparse[i:i + PLAIN_CHUNK],
                            dense[i:i + PLAIN_CHUNK])
                      for i in range(0, sparse.shape[0], PLAIN_CHUNK)])


def check_cin_layers(model: XDeepFM, sparse) -> list[float]:
    """Each CIN layer of the forward, the kernel against its plain version
    (over batch chunks of PLAIN_CHUNK) on the same input, at CIN_TOL. The
    input is the looked-up embeddings scaled to unit variance: at the
    model's init, layers 2 and 3 sit near 1e-6, below any useful absolute
    tolerance, and move the logits by less than their own. Returns each
    layer's max |diff|."""
    emb = model.embedding_lookup(sparse, use_kernel=True)
    x0 = emb / emb.std()
    xk, errs = x0, []
    for w in model.cin:
        out = cin_ops.cin_layer(xk, x0, w)
        errs.append(float_err(out, cin_plain(xk, x0, w), **CIN_TOL))
        xk = out
    return errs


def phase_xdeepfm() -> dict:
    """The full config served at serve_p99 and serve_bulk through the
    kernels; logits against the plain forward. Returns the launch counts
    of each checked forward, by shape."""
    cfg = xdeepfm_configs.full()
    t0 = time.perf_counter()
    model = XDeepFM.random(cfg, torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {cfg.n_sparse} sparse + {cfg.n_dense} dense fields, "
        f"D {cfg.embed_dim}, CIN {cfg.cin_layers}, MLP {cfg.mlp_layers}, "
        f"{cfg.total_vocab:,} embedding rows, {n_params:,} parameters "
        f"({time.perf_counter() - t0:.2f} s to init on the card)")
    launched = {}
    for shape, bsz in xdeepfm_configs.SERVE_BATCH.items():
        batch = next(click_batches(cfg.vocab_sizes, cfg.n_dense, bsz, seed=0))
        sparse, dense = dev(batch["sparse"]), dev(batch["dense"])
        torch.cuda.reset_peak_memory_stats(DEV)
        with torch.inference_mode():
            reset_counts()
            logits = model(sparse, dense, use_kernel=True)
            torch.cuda.synchronize()
            c = counts()
            if c["gather_rows"] != 1 or c["cin_layer"] != len(cfg.cin_layers):
                raise AssertionError(f"{shape}: forward launched {c}")
            launched[shape] = {k: c[k] for k in ("gather_rows", "cin_layer")}
            peak = torch.cuda.max_memory_allocated(DEV)
            if logits.shape != (bsz,) or not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{shape}: logits malformed")
            err = float_err(logits, plain_forward(model, sparse, dense),
                            **LOGIT_TOL)
            cin_errs = check_cin_layers(model, sparse)
            reps = XDEEPFM_REPS[shape]
            ms = wall_ms(lambda: model(sparse, dense, use_kernel=True), reps)
            plain_ms = wall_ms(lambda: plain_forward(model, sparse, dense),
                               max(1, reps // 3))
        log(f"  {shape} (batch {bsz:,}): {ms:.3f} ms per forward with the "
            f"kernels (median of {reps}), plain {plain_ms:.3f} ms; logits "
            f"within {LOGIT_TOL} of the plain forward (max |diff| {err:.3g}, "
            f"mean logit {logits.mean().item():.4f}); each CIN layer on "
            f"unit-variance embeddings within {CIN_TOL} of the plain layer "
            f"(max |diff| {[f'{e:.3g}' for e in cin_errs]}); launches "
            f"{launched[shape]}; max_memory_allocated {peak:,} bytes")
        with torch.inference_mode():
            log(f"  {shape} forward with the kernels, profiled: "
                + device_breakdown(lambda: model(sparse, dense,
                                                 use_kernel=True)))
    return launched


# ---------------------------------------------------------------------------
# phase 9: dense-transformer serving (prefill and decode)
# ---------------------------------------------------------------------------

def decode_vs_forward(model, toks) -> float:
    """Max |decode step at CHECK_S - forward's logits there| of ``model``
    on CHECK_B x (CHECK_S + 1) tokens; fails past CHECK_DECODE_ERR or if a
    MoE layer drops a (token, k) pair in either."""
    _, cache = model.prefill(toks[:, :CHECK_S], max_len=CHECK_S + 8)
    step, _ = model.decode_step(cache, toks[:, CHECK_S:], CHECK_S)
    drops = sum(int(d) for d in model.dropped)
    fwd = model.forward(toks)[:, CHECK_S:]
    drops += sum(int(d) for d in model.dropped)
    err = (step - fwd).abs().max().item()
    if drops or not err < CHECK_DECODE_ERR:
        raise AssertionError(f"{model.cfg.name}: decode at {CHECK_S} differs "
                             f"from forward by {err} ({drops} pairs dropped)")
    return err


def lm_check(cfg_full) -> str:
    """float32 at full width and CHECK_LAYERS layers: prefill logits with
    the kernel against the plain path (`_sdpa`) within CHECK_LOGIT_SHARE of
    the largest |logit| (float32 sums in other orders, about 1e-6 relative
    per op, through 4 layers), and a decode step at position CHECK_S
    against `forward`'s logits there within CHECK_DECODE_ERR."""
    cfg = dataclasses.replace(cfg_full, n_layers=CHECK_LAYERS,
                              dtype="float32")
    model = Transformer.random(cfg, seed=0, device=DEV)
    toks = dev(next(token_batches(cfg.vocab_size, CHECK_B, CHECK_S + 1,
                                  seed=0))["tokens"])
    logits, cache = model.prefill(toks[:, :CHECK_S], max_len=CHECK_S + 8)
    plain, _ = model.prefill(toks[:, :CHECK_S], max_len=CHECK_S + 8,
                             use_kernel=False)
    top = plain.abs().max().item()
    err = float_err(logits, plain, atol=CHECK_LOGIT_SHARE * top)
    del logits, cache, plain
    dec_err = decode_vs_forward(model, toks)
    return (f"{cfg.name} float32, {CHECK_LAYERS} layers, "
            f"{model.n_params():,} parameters, {CHECK_B} x {CHECK_S} "
            f"tokens: prefill logits with the kernel within "
            f"{CHECK_LOGIT_SHARE} x {top:.4g} of the plain path (max |diff| "
            f"{err:.3g}); decode at {CHECK_S} vs forward max |diff| "
            f"{dec_err:.3g} (< {CHECK_DECODE_ERR})")


def phase_lm() -> dict:
    """granite-3-8b at full width and depth in bf16 through the port's
    entry points: prefill of 1 x PREFILL_S prompt tokens, then DECODE_STEPS
    greedy decode steps of DECODE_B sequences over a DECODE_T-slot cache
    filled from a seeded generator up to DECODE_CUR. Returns the launch
    counts of the two driven runs."""
    for cfg in (granite_3_8b.full(), granite_20b.full()):
        log("  " + lm_check(cfg))
        torch.cuda.empty_cache()

    cfg = granite_3_8b.full()
    t0 = time.perf_counter()
    model = Transformer.random(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.padded_vocab:,}; {model.n_params():,} bf16 "
        f"parameters ({torch.cuda.memory_allocated(DEV):,} bytes; "
        f"{time.perf_counter() - t0:.2f} s to draw on the card)")
    prompt = dev(next(token_batches(cfg.vocab_size, 1, PREFILL_S,
                                    seed=0))["tokens"])
    model.prefill(prompt[:, :256])                       # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(DEV)
    before = torch.cuda.memory_allocated(DEV)
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    prefill_counts = counts()
    peak = torch.cuda.max_memory_allocated(DEV)
    prefill_routes = dict(fa_ops.flash_attention.routes)
    if prefill_counts["flash_attention"] != cfg.n_layers \
            or prefill_routes != {"wgmma": cfg.n_layers}:
        raise AssertionError(f"prefill launched {prefill_counts}, routes "
                             f"{prefill_routes}")
    if logits.shape != (1, PREFILL_S, cfg.padded_vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits malformed or not finite")
    log(f"  prefill 1 x {PREFILL_S:,} tokens: {dt:.4f} s "
        f"({PREFILL_S / dt:,.1f} tokens/s); logits finite; launches "
        f"{prefill_counts}; flash routes {prefill_routes}; "
        f"max_memory_allocated {peak:,} bytes ({before:,} allocated before "
        f"the prefill: the weights and what earlier phases keep)")
    del logits, cache
    log("  prefill, profiled: " + device_breakdown(
        lambda: model.prefill(prompt), share_of=("flash_tile",)))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cache = model.init_cache(DECODE_B, DECODE_T)
    gen = torch.Generator(device=DEV).manual_seed(0)
    for ct in cache["dense"]:
        for layer in ct:
            layer.normal_(generator=gen)
    tok = dev(next(token_batches(cfg.vocab_size, DECODE_B, 1,
                                 seed=0))["tokens"])
    model.decode_step(cache, tok, DECODE_CUR - 1)         # warm-up
    torch.cuda.synchronize()
    log(f"  decode cache: {DECODE_B} x {DECODE_T:,} slots x {cfg.n_layers} "
        f"layers, {2 * cache['dense'][0].nbytes:,} bytes, random from seed 0 "
        f"({time.perf_counter() - t0:.2f} s to fill)")

    torch.cuda.reset_peak_memory_stats(DEV)
    before = torch.cuda.memory_allocated(DEV)
    reset_counts()
    steps = []
    t_all = time.perf_counter()
    for i in range(DECODE_STEPS):
        t0 = time.perf_counter()
        logits, _ = model.decode_step(cache, tok, DECODE_CUR + i)
        tok = logits[:, :, :cfg.vocab_size].argmax(dim=-1).to(torch.int32)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"decode step {i}: logits not finite")
        steps.append((time.perf_counter() - t0) * 1e3)
    dt = time.perf_counter() - t_all
    decode_counts = counts()
    peak = torch.cuda.max_memory_allocated(DEV)
    decode_routes = dict(fa_ops.flash_attention.routes)
    if decode_counts["flash_attention"] != cfg.n_layers * DECODE_STEPS \
            or decode_routes != {"split": cfg.n_layers * DECODE_STEPS}:
        raise AssertionError(f"decode launched {decode_counts}, routes "
                             f"{decode_routes}")
    log(f"  decode {DECODE_B} x {DECODE_STEPS} steps from position "
        f"{DECODE_CUR:,}: {np.median(steps):.3f} ms per step (median; "
        f"{[round(t, 3) for t in steps]}), "
        f"{DECODE_B * DECODE_STEPS / dt:,.1f} tokens/s; logits finite; "
        f"launches {decode_counts}; flash routes {decode_routes}; "
        f"max_memory_allocated {peak:,} bytes ({before:,} allocated before "
        f"the steps)")
    log("  decode step, profiled: " + device_breakdown(
        lambda: model.decode_step(cache, tok, DECODE_CUR),
        share_of=("flash_tile",)))
    del model, cache, logits
    torch.cuda.empty_cache()
    return {"prefill": prefill_counts, "decode": decode_counts}


# ---------------------------------------------------------------------------
# phase 9b: LM serving, MoE and MLA (qwen2-moe-a2.7b, deepseek-v3-671b)
# ---------------------------------------------------------------------------

def no_drop(cfg):
    """``cfg`` at the capacity factor E / top_k: capacity = T, no drops."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def moe_lm_check() -> str:
    """qwen2-moe-a2.7b float32 at full width and MOE_CHECK_LAYERS layers:
    prefill logits with flash_attention against the plain path within
    CHECK_LOGIT_SHARE of the largest |logit|, two calls with the kernel
    bit-identical (dropped pairs scatter zeros into slot (0, 0)), and at a
    capacity factor with no drops a decode step against forward's logits
    within CHECK_DECODE_ERR."""
    cfg = dataclasses.replace(qwen2_moe_a2_7b.full(),
                              n_layers=MOE_CHECK_LAYERS, dtype="float32")
    model = Transformer.random(cfg, seed=0, device=DEV)
    toks = dev(next(token_batches(cfg.vocab_size, CHECK_B, CHECK_S + 1,
                                  seed=0))["tokens"])
    logits, _ = model.prefill(toks[:, :CHECK_S], max_len=CHECK_S + 8)
    drops = [int(d) for d in model.dropped]
    again, _ = model.prefill(toks[:, :CHECK_S], max_len=CHECK_S + 8)
    float_err(again, logits, exact=True)
    del again
    plain, _ = model.prefill(toks[:, :CHECK_S], max_len=CHECK_S + 8,
                             use_kernel=False)
    top = plain.abs().max().item()
    err = float_err(logits, plain, atol=CHECK_LOGIT_SHARE * top)
    del logits, plain
    dec_err = decode_vs_forward(Transformer(no_drop(cfg), model.params), toks)
    return (f"{cfg.name} float32, {MOE_CHECK_LAYERS} layers, "
            f"{model.n_params():,} parameters, {CHECK_B} x {CHECK_S} tokens "
            f"(capacity {lm_mod.moe_capacity(cfg, CHECK_B * CHECK_S)}, pairs "
            f"dropped a layer {drops}): prefill logits with flash_attention "
            f"within {CHECK_LOGIT_SHARE} x {top:.4g} of the plain path (max "
            f"|diff| {err:.3g}), two calls bit-identical; at capacity factor "
            f"{no_drop(cfg).capacity_factor:g} (no drops) decode at {CHECK_S} "
            f"vs forward max |diff| {dec_err:.3g} (< {CHECK_DECODE_ERR})")


def mla_check() -> str:
    """deepseek-v3-671b float32 at full width and its DS_CHECK_LAYERS dense
    MLA layers (with its MTP head's weights): the absorbed decode step
    against forward's (expanded) logits within CHECK_DECODE_ERR."""
    cfg = dataclasses.replace(deepseek_v3_671b.full(),
                              n_layers=DS_CHECK_LAYERS, dtype="float32")
    model = Transformer.random(cfg, seed=0, device=DEV)
    toks = dev(next(token_batches(cfg.vocab_size, CHECK_B, CHECK_S + 1,
                                  seed=0))["tokens"])
    err = decode_vs_forward(model, toks)
    return (f"{cfg.name} float32, {DS_CHECK_LAYERS} dense MLA layers, "
            f"{model.n_params():,} parameters, {CHECK_B} x {CHECK_S} tokens: "
            f"absorbed decode at {CHECK_S} vs forward max |diff| {err:.3g} "
            f"(< {CHECK_DECODE_ERR})")


def moe_parts(model, n_tokens: int) -> str:
    """The first MoE layer's pieces on ``n_tokens`` unit-normal hidden
    states in the model's dtype, each timed with CUDA events (median): the
    routing (router product, softmax, top-k, slot ranking), the dispatch
    (the kept (token, k) pairs copied into (E, capacity, D)), the experts'
    batched products (w_gate, w_in, w_out over every slot), the combine
    (gather and gated sum), the shared expert, and the whole layer; the
    experts' products beside their bound (bf16 tensor-core rate, or their
    weights' bytes)."""
    cfg = model.cfg
    p = model.stacks[-1][2][0]
    k, E, D = cfg.top_k, cfg.n_experts, cfg.d_model
    gen = torch.Generator(device=DEV).manual_seed(3)
    xt = torch.randn(n_tokens, D, generator=gen, device=DEV).to(
        p["router"].dtype)
    gates, _, e, s, keep = lm_mod.moe_route(p, cfg, xt)
    cap = lm_mod.moe_capacity(cfg, n_tokens)
    w = p["experts"]

    def dispatch():
        return lm_mod.moe_dispatch(cfg, xt, e, s, keep)
    buf = dispatch()

    def experts():
        return lm_mod.moe_experts(w, cfg, buf)
    out_e = experts()

    def combine():
        return ((out_e[e, s] * keep[:, None]).reshape(n_tokens, k, D)
                * gates[..., None]).sum(dim=1)
    parts = {"route": lambda: lm_mod.moe_route(p, cfg, xt),
             "dispatch": dispatch, "experts": experts, "combine": combine,
             "shared": lambda: lm_mod._mlp(p["shared"], xt, cfg.mlp),
             "layer": lambda: lm_mod._moe_mlp(p, cfg, xt[None])}
    ms = {name: time_ms(fn, reps=10) for name, fn in parts.items()}
    flops = 2 * 3 * E * cap * D * cfg.moe_d_ff
    b_ms, b_by = bound(sum(t.nbytes for t in w.values()), flops,
                       BF16_TC_OPS_PER_S)
    return (f"{n_tokens:,} tokens, capacity {cap:,} ({E * cap:,} slots for "
            f"{n_tokens * k:,} pairs, {int((~keep).sum()):,} dropped): "
            + ", ".join(f"{name} {t:.4f} ms" for name, t in ms.items())
            + f"; experts' products {flops / ms['experts'] / 1e9:.1f} "
            f"TFLOP/s, bound {b_ms:.4f} ms ({b_by})")


def lm_serve(model, prompt_len: int, decode_b: int, card: str) -> dict:
    """``model`` through its entry points: a prefill of 1 x ``prompt_len``
    prompt tokens, then DECODE_STEPS greedy steps of ``decode_b``
    sequences over a DECODE_T-slot cache filled from a seeded generator up
    to DECODE_CUR. Every logit finite; flash_attention launched once a GQA
    layer a call (route "wgmma" at the prefill, "split" at decode; MLA
    launches none); the pairs each MoE layer drops; seconds, ms a step,
    peak memory, profiles and the first MoE layer's pieces at both
    shapes. Returns the launch counts of the two driven runs."""
    cfg = model.cfg
    n_gqa = 0 if cfg.attn == "mla" else cfg.n_layers
    prompt = dev(next(token_batches(cfg.vocab_size, 1, prompt_len,
                                    seed=0))["tokens"])
    model.prefill(prompt[:, :256])                       # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(DEV)
    before = torch.cuda.memory_allocated(DEV)
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    prefill_counts = counts()
    peak = torch.cuda.max_memory_allocated(DEV)
    routes = dict(fa_ops.flash_attention.routes)
    drops = [int(d) for d in model.dropped]
    if prefill_counts["flash_attention"] != n_gqa or \
            routes != ({"wgmma": n_gqa} if n_gqa else {}):
        raise AssertionError(f"{cfg.name} prefill launched {prefill_counts}, "
                             f"routes {routes}")
    if logits.shape != (1, prompt_len, cfg.padded_vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: prefill logits malformed or not "
                             "finite")
    log(f"  {cfg.name} prefill 1 x {prompt_len:,} tokens: {dt:.4f} s "
        f"({prompt_len / dt:,.1f} tokens/s); logits finite; flash launches "
        f"{prefill_counts['flash_attention']}, routes {routes}; pairs "
        f"dropped by each MoE layer {drops} of {prompt_len * cfg.top_k:,} "
        f"(capacity {lm_mod.moe_capacity(cfg, prompt_len):,}); "
        f"max_memory_allocated {peak:,} bytes ({before:,} before) [{card}]")
    del logits, cache
    log("  prefill, profiled: " + device_breakdown(
        lambda: model.prefill(prompt), share_of=("flash_tile",)))
    log("  first MoE layer at the prefill: " + moe_parts(model, prompt_len))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cache = model.init_cache(decode_b, DECODE_T)
    gen = torch.Generator(device=DEV).manual_seed(0)
    for stack in cache.values():
        for layer in (t for ct in stack or () for t in ct):
            layer.normal_(generator=gen)
    cache_bytes = sum(t.nbytes for st in cache.values() for t in st or ())
    tok = dev(next(token_batches(cfg.vocab_size, decode_b, 1,
                                 seed=0))["tokens"])
    model.decode_step(cache, tok, DECODE_CUR - 1)         # warm-up
    torch.cuda.synchronize()
    log(f"  decode cache: {decode_b} x {DECODE_T:,} slots x {cfg.n_layers} "
        f"layers, {cache_bytes:,} bytes, random from seed 0 "
        f"({time.perf_counter() - t0:.2f} s to fill)")

    torch.cuda.reset_peak_memory_stats(DEV)
    before = torch.cuda.memory_allocated(DEV)
    reset_counts()
    steps, drops = [], []
    t_all = time.perf_counter()
    for i in range(DECODE_STEPS):
        t0 = time.perf_counter()
        logits, _ = model.decode_step(cache, tok, DECODE_CUR + i)
        tok = logits[:, :, :cfg.vocab_size].argmax(dim=-1).to(torch.int32)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name} decode step {i}: logits not "
                                 "finite")
        steps.append((time.perf_counter() - t0) * 1e3)
        drops.append(sum(int(d) for d in model.dropped))
    dt = time.perf_counter() - t_all
    decode_counts = counts()
    peak = torch.cuda.max_memory_allocated(DEV)
    routes = dict(fa_ops.flash_attention.routes)
    n_launch = n_gqa * DECODE_STEPS
    if decode_counts["flash_attention"] != n_launch or \
            routes != ({"split": n_launch} if n_launch else {}):
        raise AssertionError(f"{cfg.name} decode launched {decode_counts}, "
                             f"routes {routes}")
    log(f"  {cfg.name} decode {decode_b} x {DECODE_STEPS} steps from "
        f"position {DECODE_CUR:,}: {np.median(steps):.3f} ms per step "
        f"(median; {[round(t, 3) for t in steps]}), "
        f"{decode_b * DECODE_STEPS / dt:,.1f} tokens/s; logits finite; "
        f"flash launches {decode_counts['flash_attention']}, routes "
        f"{routes}; pairs dropped a step over the MoE layers {drops}; "
        f"max_memory_allocated {peak:,} bytes ({before:,} before) [{card}]")
    log("  decode step, profiled: " + device_breakdown(
        lambda: model.decode_step(cache, tok, DECODE_CUR),
        share_of=("flash_tile",)))
    log("  first MoE layer at a decode step: " + moe_parts(model, decode_b))
    del cache, logits
    torch.cuda.empty_cache()
    return {"prefill": prefill_counts, "decode": decode_counts}


def phase_lm_moe(card: str) -> dict:
    """Phase 9b: the float32 checks, then qwen2-moe-a2.7b at full width and
    depth and deepseek-v3-671b's widths at DS_LAYERS layers served in bf16
    with random weights from seed 0. Returns qwen2-moe's launch counts."""
    t0 = time.perf_counter()
    for check in (moe_lm_check, mla_check):
        log("  " + check())
        torch.cuda.empty_cache()
    out = []
    for cfg, prompt_len, decode_b in (
            (qwen2_moe_a2_7b.full(), PREFILL_S, MOE_DECODE_B),
            (dataclasses.replace(deepseek_v3_671b.full(), n_layers=DS_LAYERS),
             DS_PREFILL_S, DS_DECODE_B)):
        t1 = time.perf_counter()
        model = Transformer.random(cfg, seed=0, device=DEV)
        torch.cuda.synchronize()
        log(f"  {cfg.name}: {cfg.n_layers} layers "
            f"({' + '.join(f'{len(ls)} {n}' for n, _, ls in model.stacks)}"
            f"), d_model {cfg.d_model}, {cfg.attn} attention with "
            f"{cfg.n_heads} heads, {cfg.n_experts} experts top-{cfg.top_k} "
            f"(d_ff {cfg.moe_d_ff}) + {cfg.n_shared_experts} shared, vocab "
            f"{cfg.padded_vocab:,}; {model.n_params():,} bf16 parameters "
            f"({torch.cuda.memory_allocated(DEV):,} bytes; "
            f"{time.perf_counter() - t1:.2f} s to draw on the card)")
        out.append(lm_serve(model, prompt_len, decode_b, card))
        del model
        torch.cuda.empty_cache()
    log(f"  phase 9b: {time.perf_counter() - t0:.1f} s")
    return out[0]


# ---------------------------------------------------------------------------
# phase 10: GNN serving (GCN at ogbn-products, the geometric models)
# ---------------------------------------------------------------------------

def gnn_check(name: str, model, g, *, launches: int | None = None,
              reps: int | None = None, warm: int = 3,
              profile: bool = True) -> int:
    """One forward of ``model`` on ``g`` through the kernel, counted, then
    checked against the same forward with `aggregate` on the plain
    index_add_ path (rtol GNN_SHARE, atol GNN_SHARE x max |plain|), timed
    beside it, and profiled. Returns its segment_spmm launches."""
    torch.cuda.reset_peak_memory_stats(DEV)
    base = torch.cuda.memory_allocated(DEV)
    with torch.inference_mode():
        reset_counts()
        out = model(g)
        torch.cuda.synchronize()
        c = counts()
        builds = seg_ops.segment_plan.builds
        peak = torch.cuda.max_memory_allocated(DEV)
        plain = model(g, use_kernel=False)
        outs = out if isinstance(out, tuple) else (out,)
        plains = plain if isinstance(plain, tuple) else (plain,)
        errs = []
        for o, p in zip(outs, plains):
            if not bool(torch.isfinite(o).all()):
                raise AssertionError(f"{name}: output not finite")
            errs.append(float_err(o, p, rtol=GNN_SHARE,
                                  atol=GNN_SHARE * p.abs().max().item()))
        del out, plain, outs, plains
        want = GNN_LAUNCHES[name] if launches is None else launches
        if c["segment_spmm"] != want:
            raise AssertionError(f"{name}: forward launched {c}")
        if builds != 1:
            raise AssertionError(f"{name}: forward built {builds} segment "
                                 f"plans")
        reps = reps or GNN_REPS[name]
        ms = time_ms(lambda: model(g), reps=reps, warm=warm)
        plain_ms = time_ms(lambda: model(g, use_kernel=False), reps=reps,
                           warm=warm)
        log(f"  {name}: {ms:.3f} ms per forward with the kernel (median of "
            f"{reps}, CUDA events), plain index_add_ path {plain_ms:.3f} ms; "
            f"within rtol {GNN_SHARE} and atol {GNN_SHARE} x max |plain| of "
            f"the plain path (max |diff| {[f'{e:.3g}' for e in errs]}); "
            f"launches {c['segment_spmm']}, segment plans built {builds}; "
            f"max_memory_allocated {peak:,} bytes ({peak - base:,} above "
            f"the weights and the batch)"
            + (f"; with a sorted copy per call it peaked at "
               f"{GCN_PEAK_SORTED_COPY:,} bytes, "
               f"{(GCN_PEAK_SORTED_COPY - peak) / 1e9:.2f} GB more"
               if name == "gcn" else ""))
        if profile:
            log(f"  {name} forward, profiled: " + device_breakdown(
                lambda: model(g), share_of=SPMM_KERNELS))
    return c["segment_spmm"]


def phase_gnn() -> dict:
    """GCN (gcn_cora.full("ogb_products")) on the full ogbn-products
    batch, then EGNN, NequIP and Equiformer-v2 at full() on the molecule
    batch, random weights from seed 0, each through `forward` with the
    kernel against the plain path; Equiformer-v2's energies also under a
    random rotation and translation. Returns each model's launches."""
    launched = {}
    g = gnn_graph("ogb_products")[0]
    cfg = gcn_cora.full("ogb_products")
    model = GCN.random(cfg, torch.Generator(device=DEV).manual_seed(0))
    log(f"  {cfg.name} at ogb_products: {cfg.n_layers} layers, d_in "
        f"{cfg.d_in}, hidden {cfg.d_hidden}, {cfg.n_classes} classes; "
        f"{g.node_mask.shape[0]:,} nodes, {g.receivers.shape[0]:,} edges; "
        f"node features {g.node_feat.nbytes:,} bytes, layer-2 messages "
        f"{g.receivers.shape[0] * cfg.n_classes * 4:,} bytes")
    launched["gcn"] = gnn_check("gcn", model, g)
    del model
    torch.cuda.empty_cache()

    g, build_s, _ = gnn_graph("molecule")
    log(f"  molecule batch: {g.n_graphs} molecules, {g.node_mask.shape[0]:,} "
        f"nodes, {g.receivers.shape[0]:,} edges ({build_s:.2f} s to build)")
    for name, cls, cfg in (("egnn", EGNN, egnn_configs.full()),
                           ("nequip", NequIP, nequip_configs.full()),
                           ("equiformer_v2", EquiformerV2, eq_configs.full())):
        model = cls.random(cfg, torch.Generator(device=DEV).manual_seed(0))
        log(f"  {cfg.name}: {cfg.n_layers} layers, d_hidden {cfg.d_hidden}, "
            f"{sum(p.numel() for p in model.parameters()):,} parameters")
        launched[name] = gnn_check(name, model, g)
    # the reference's invariance test (tests/test_models_gnn.py) on the card
    q, _ = np.linalg.qr(np.random.default_rng(3).normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    moved = dataclasses.replace(
        g, positions=g.positions @ dev(q.T.astype(np.float32)) + 1.5)
    with torch.inference_mode():
        e1, e2 = model(g), model(moved)
    top = e1.abs().max().item()
    diff = (e1 - e2).abs().max().item()
    if not diff <= 1e-4 * top:
        raise AssertionError(f"equiformer_v2: energies move by {diff} under "
                             f"a rotation (max |energy| {top})")
    log(f"  equiformer_v2 under a random rotation and translation: max "
        f"|energy diff| {diff:.3g} (<= 1e-4 x {top:.4g})")
    del model
    torch.cuda.empty_cache()
    return launched


# ---------------------------------------------------------------------------
# phase 11: training through the port's runtime (runtime/trainer.Trainer)
# ---------------------------------------------------------------------------

# xDeepFM trains at train_batch (65,536), halved while the step's peak,
# predicted from two probe steps (the peak is an offset plus a slope in the
# batch: every activation is linear in it), passes TRAIN_PEAK_LIMIT
TRAIN_PEAK_LIMIT = 70e9
TRAIN_PROBES = (2048, 8192)
XDEEPFM_TRAIN_STEPS = 30
# the resume and int8 EF checks: the full config at a smaller batch
RESUME_BATCH, RESUME_STEPS, RESUME_EVERY, RESUME_FAIL = 8192, 6, 3, 4
CKPT_DIR = Path(__file__).resolve().parent / "build" / "smoke_ckpt"
# card against CPU: two steps (step 0 runs at lr 0 in the warmup) at batch
# 256 from the same weights; loss and gradient norm float32 sums in other
# orders (rtol 1e-5); the weights after step 1 (lr 1e-4) within a tenth of
# that lr: the first steps move an entry by lr g / (|g| + eps), which an
# order difference in a gradient entry near eps moves by up to lr
CARD_CPU_BATCH, CARD_CPU_LOSS_RTOL, CARD_CPU_WEIGHT_ATOL = 256, 1e-5, 1e-5
# GNN training: steps per model through the kernel (Trainer.run), and one
# step's gradients with the kernel against use_kernel=False on the card,
# each leaf within GRAD_SHARE of its largest |plain|: tests/test_kernels.py's
# segment_spmm 1e-4, but 2e-3 for Equiformer-v2, whose attention scores
# pass through leaky_relu: the kernel and the plain version sum a node's
# messages in other float32 orders, a score within that noise of 0 then
# takes the other slope in one run, and every gradient upstream of it
# moves by a finite step (up to 3.3e-4 of a leaf's max |plain| seen on
# `layers/11/attn_vec`, and in a second computation of the same gradient
# on the same path)
GNN_TRAIN_STEPS = 3
GRAD_SHARE = {"gcn": 1e-4, "egnn": 1e-4, "nequip": 1e-4,
              "equiformer_v2": 2e-3}
# LM: granite-3-8b's widths at 2 layers in float32 (40 layers' parameters,
# gradients and two moments at 16 bytes each would be 128 GB), batch 2 x
# 4,096 tokens (train_4k's sequence; its batch of 256 is a mesh's)
LM_TRAIN_LAYERS, LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEPS = 2, 2, 4096, 12
# qwen2-moe-a2.7b's widths at LM_TRAIN_LAYERS of 24 layers, batch LM_TRAIN_B
# x LM_TRAIN_S, through launch/train.build_task; deepseek-v3-671b's widths
# with the MTP head at 1 to DS_TRAIN_MAX_LAYERS dense MLA layers (its
# first_dense_layers cut with them: one MoE layer of 256 experts holds 11.3B
# parameters, 180 GB at 16 bytes each), as deep as a probe step at 1 layer
# predicts under TRAIN_PEAK_LIMIT, batch DS_TRAIN_B x DS_TRAIN_S (MLA's
# scores are (128 heads, S, S) float32 a layer, kept for the backward)
# deepseek-v3 trains on its own schedule (arXiv:2412.19437 §4.2: a linear
# warmup to 2.2e-4 over the first 2,000 steps): at build_task's 1e-3 over
# 20 steps its widths diverge (one layer, batch 1 x 2,048, on an NVIDIA H100
# 80GB HBM3 at 700 W: the loss 15.9 -> 33.6 after one step at 5e-5, with
# the MTP term and without it)
MOE_TRAIN_STEPS = 8
DS_TRAIN_MAX_LAYERS, DS_TRAIN_B, DS_TRAIN_S, DS_TRAIN_STEPS = 3, 1, 2048, 8
DS_TRAIN_LR, DS_TRAIN_WARMUP = 2.2e-4, 2000


def train_run(task, steps: int, **kw) -> tuple[Trainer, dict, int]:
    """Trainer(task, **kw).run(steps=steps) with the peak memory reset
    before it; returns (trainer, its result, max_memory_allocated)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(DEV)
    trainer = Trainer(task, **kw)
    out = trainer.run(steps=steps)
    torch.cuda.synchronize()
    return trainer, out, torch.cuda.max_memory_allocated(DEV)


def step_ms(log) -> float:
    """Median ms of the steps after the first (which warms the allocator
    and cuBLAS)."""
    return float(np.median([r["dt"] for r in log[1:]])) * 1e3


def loss_falls(log, name: str, k: int = 5) -> tuple[float, float]:
    """The planted-signal criterion (tests/test_models_recsys.py): the mean
    loss of the last k steps below the first k's; every loss finite."""
    losses = [r["loss"] for r in log]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: a loss is not finite: {losses}")
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    if not last < first:
        raise AssertionError(f"{name}: loss did not fall: {losses}")
    return first, last


def xdeepfm_task(batch: int, steps: int, compress: bool = False):
    return build_task("xdeepfm", steps, batch, 0, compress, device=DEV,
                      config="full")


def xdeepfm_train_batch(card: str) -> int:
    """The largest of 65,536 / 2^k whose predicted step peak fits
    TRAIN_PEAK_LIMIT (one probe step at each of TRAIN_PROBES)."""
    peaks = []
    for b in TRAIN_PROBES:
        _, _, peak = train_run(xdeepfm_task(b, 1), 1)
        peaks.append(peak)
    slope = (peaks[1] - peaks[0]) / (TRAIN_PROBES[1] - TRAIN_PROBES[0])

    def predict(b):
        return peaks[0] + slope * (b - TRAIN_PROBES[0])
    batch = xdeepfm_configs.TRAIN_BATCH
    while predict(batch) > TRAIN_PEAK_LIMIT:
        batch //= 2
    log(f"  xdeepfm step peak: {peaks[0]:,} bytes at batch "
        f"{TRAIN_PROBES[0]:,}, {peaks[1]:,} at {TRAIN_PROBES[1]:,} "
        f"({slope:,.0f} bytes an example); predicted at 65,536: "
        f"{predict(65536):,.0f}; trains at {batch:,} (predicted "
        f"{predict(batch):,.0f} <= {TRAIN_PEAK_LIMIT:,.0f}) [{card}]")
    return batch


def gap(log_a, log_b) -> float:
    return max(abs(a["loss"] - b["loss"]) for a, b in zip(log_a, log_b))


def weight_gap(tree_a, tree_b) -> float:
    return max(float((a.detach() - b.detach().to(a.device)).abs().max())
               for a, b in zip(tree_leaves(tree_a), tree_leaves(tree_b)))


def phase_train_xdeepfm(card: str) -> dict:
    """xDeepFM full() through build_task and the Trainer: the memory probe,
    XDEEPFM_TRAIN_STEPS at the chosen batch (ms a step, peak, a profiled
    step, loss first -> last), card against CPU, resume and int8 EF."""
    cfg = xdeepfm_configs.full()
    out = {}
    batch = xdeepfm_train_batch(card)
    reset_counts()
    trainer, res, peak = train_run(xdeepfm_task(batch, XDEEPFM_TRAIN_STEPS),
                                   XDEEPFM_TRAIN_STEPS)
    c = counts()
    if c["gather_rows"] or c["cin_layer"]:
        raise AssertionError(f"xdeepfm training launched {c}: the training "
                             f"lookup and CIN are the plain path")
    first, last = loss_falls(res["log"], "xdeepfm")
    ms = step_ms(res["log"])
    model = res["params"]
    n_params = sum(p.numel() for p in tree_leaves(model.param_tree()))
    log(f"  xdeepfm full ({n_params:,} parameters, {cfg.total_vocab:,} "
        f"embedding rows) at batch {batch:,}: {ms:.3f} ms a step (median of "
        f"{XDEEPFM_TRAIN_STEPS - 1}); max_memory_allocated {peak:,} bytes; "
        f"loss mean of the first 5 steps {first:.5f} -> last 5 {last:.5f}; "
        f"gather_rows and cin_layer launches 0 (plain path) [{card}]")
    tree = model.param_tree()
    ef = {"_": torch.zeros((), device=DEV)}
    extra = next(trainer.task.batches)
    log("  xdeepfm training step, profiled: " + device_breakdown(
        lambda: trainer._step(model, tree, res["opt"], ef, extra,
                              XDEEPFM_TRAIN_STEPS)))
    out["xdeepfm"] = dict(batch=batch, ms=ms, peak=peak)
    del trainer, res, model, tree, extra
    torch.cuda.empty_cache()

    # card against CPU: the same weights, the same two batches
    init = XDeepFM.random(cfg, torch.Generator(device=DEV).manual_seed(0))
    host = tree_map(lambda t: t.detach().cpu(), init.param_tree())
    del init
    runs = []
    for where in (DEV, torch.device("cpu")):
        task = build_task("xdeepfm", 2, CARD_CPU_BATCH, 0, False,
                          device=where, config="full")
        task.init_params = lambda g, w=where: XDeepFM.from_jax(cfg, host,
                                                               device=w)
        runs.append(Trainer(task).run(steps=2))
    cl, hl = runs[0]["log"], runs[1]["log"]
    for a, b in zip(cl, hl):
        for k in ("loss", "grad_norm"):
            if not abs(a[k] - b[k]) <= CARD_CPU_LOSS_RTOL * abs(b[k]):
                raise AssertionError(f"xdeepfm card vs CPU step {a['step']}: "
                                     f"{k} {a[k]} vs {b[k]}")
    wg = weight_gap(runs[0]["params"].param_tree(),
                    runs[1]["params"].param_tree())
    if not wg <= CARD_CPU_WEIGHT_ATOL:
        raise AssertionError(f"xdeepfm card vs CPU: weights after 2 steps "
                             f"differ by {wg}")
    log(f"  xdeepfm card vs CPU, 2 steps at batch {CARD_CPU_BATCH}: losses "
        f"{[r['loss'] for r in cl]} vs {[r['loss'] for r in hl]}, "
        f"grad_norm {[r['grad_norm'] for r in cl]} vs "
        f"{[r['grad_norm'] for r in hl]} (rtol {CARD_CPU_LOSS_RTOL}); "
        f"weights max |diff| {wg:.3g} (<= {CARD_CPU_WEIGHT_ATOL})")
    del runs, host
    torch.cuda.empty_cache()

    # resume: fail after a checkpoint, resume, against two clean runs
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        Trainer(xdeepfm_task(RESUME_BATCH, RESUME_STEPS),
                ckpt_dir=str(CKPT_DIR), ckpt_every=RESUME_EVERY).run(
            steps=RESUME_STEPS, fail_at_step=RESUME_FAIL)
    except RuntimeError as e:
        if "simulated node failure" not in str(e):
            raise
    else:
        raise AssertionError("fail_at_step did not stop the run")
    resumed = Trainer(xdeepfm_task(RESUME_BATCH, RESUME_STEPS),
                      ckpt_dir=str(CKPT_DIR), ckpt_every=RESUME_EVERY).run(
        steps=RESUME_STEPS)
    ckpt_s = time.perf_counter() - t0
    ckpt_bytes = sum(f.stat().st_size for f in CKPT_DIR.rglob("*")
                     if f.is_file())
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    clean = [Trainer(xdeepfm_task(RESUME_BATCH, RESUME_STEPS)).run(
        steps=RESUME_STEPS) for _ in range(2)]
    if resumed["log"][0]["step"] != RESUME_EVERY:
        raise AssertionError(f"resumed at {resumed['log'][0]['step']}")
    clean_gap = gap(clean[0]["log"], clean[1]["log"])
    clean_wgap = weight_gap(clean[0]["params"].param_tree(),
                            clean[1]["params"].param_tree())
    res_gap = gap(resumed["log"], clean[0]["log"][RESUME_EVERY:])
    res_wgap = weight_gap(resumed["params"].param_tree(),
                          clean[0]["params"].param_tree())
    if clean_gap == 0 and clean_wgap == 0 and (res_gap or res_wgap):
        raise AssertionError(f"xdeepfm: clean runs are bit-identical but the "
                             f"resumed one differs ({res_gap}, {res_wgap})")
    log(f"  xdeepfm resume at batch {RESUME_BATCH:,}: failed at step "
        f"{RESUME_FAIL}, resumed from the step-{RESUME_EVERY} checkpoint "
        f"({ckpt_bytes:,} bytes under build/, {ckpt_s:.1f} s for the two "
        f"runs with their saves and restore); resumed vs clean: max |loss "
        f"diff| {res_gap:.3g}, weights {res_wgap:.3g}; clean vs clean: "
        f"{clean_gap:.3g}, weights {clean_wgap:.3g}")
    out["resume"] = dict(res_gap=res_gap, res_wgap=res_wgap,
                         clean_gap=clean_gap, clean_wgap=clean_wgap)
    del resumed, clean
    torch.cuda.empty_cache()

    # int8 error feedback through the CLI
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "xdeepfm", "--config", "full", "--batch", str(RESUME_BATCH),
           "--steps", str(RESUME_STEPS), "--compress", "--device", "cuda"]
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent
                                            / "src")}
    run = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} failed:\n{run.stderr}")
    line = run.stdout.strip().splitlines()[-1]
    if not line.startswith("[xdeepfm] steps 0..") or "nan" in line:
        raise AssertionError(f"--compress run printed {line!r}")
    log(f"  {' '.join(cmd[2:])}: {line}")
    return out


def gnn_grad_check(name: str, model, loss_fn, g) -> float:
    """One step's gradients with the kernel against use_kernel=False on the
    card: each leaf's max |diff| within GRAD_SHARE[name] x its max |plain|.
    Returns the worst max |diff| as a share of max |plain|."""
    leaves = tree_leaves(model.param_tree())
    for p in leaves:
        p.requires_grad_(True)
    grads = []
    for use_kernel in (True, False):
        loss, _ = loss_fn(model, g, use_kernel=use_kernel)
        grads.append(torch.autograd.grad(loss, leaves, allow_unused=True))
    worst = 0.0
    for gk, gp in zip(*grads):
        if gp is None:
            continue
        top = gp.abs().max().item()
        err = (gk - gp).abs().max().item()
        if not bool(torch.isfinite(gk).all()) or \
                not err <= GRAD_SHARE[name] * top:
            raise AssertionError(
                f"{name}: a gradient with the kernel differs from the plain "
                f"path's by {err} (max |plain| {top}, tolerance "
                f"{GRAD_SHARE[name]} of it)")
        if top > 0:
            worst = max(worst, err / top)
    return worst


def phase_train_gnn(card: str) -> dict:
    """Each GNN through the Trainer on phase 10's batches (GCN at
    ogbn-products, the geometric models on 128 molecules), every
    aggregate through segment_spmm; one step's gradients against the
    plain path. Returns each model's launches."""
    launched = {}
    for name, mod, cls, cfg, shape in (
            ("gcn", gcn_mod, GCN, gcn_cora.full("ogb_products"),
             "ogb_products"),
            ("egnn", egnn_mod, EGNN, egnn_configs.full(), "molecule"),
            ("nequip", nequip_mod, NequIP, nequip_configs.full(),
             "molecule"),
            ("equiformer_v2", eq_mod, EquiformerV2, eq_configs.full(),
             "molecule")):
        g = gnn_graph(shape)[0]
        model = cls.random(cfg, torch.Generator(device=DEV).manual_seed(0))
        err = gnn_grad_check(name, model, mod.loss_fn, g)
        del model

        def batches(g=g):
            while True:
                yield g
        task = TrainTask(name=name, init_params=lambda gen, cls=cls,
                         cfg=cfg: cls.random(cfg, gen),
                         loss_fn=mod.loss_fn, batches=batches(), lr=1e-3,
                         warmup=10, total_steps=GNN_TRAIN_STEPS, device=DEV)
        reset_counts()
        _, res, peak = train_run(task, GNN_TRAIN_STEPS)
        n = counts()["segment_spmm"]
        if n != GNN_LAUNCHES[name] * GNN_TRAIN_STEPS:
            raise AssertionError(f"{name}: {GNN_TRAIN_STEPS} steps launched "
                                 f"segment_spmm {n} times")
        losses = [r["loss"] for r in res["log"]]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: losses {losses}")
        launched[name] = n
        log(f"  {name} training ({shape}): {step_ms(res['log']):.3f} ms a "
            f"step (median of {GNN_TRAIN_STEPS - 1}), segment_spmm "
            f"{n // GNN_TRAIN_STEPS} launches a step (forwards; the "
            f"backward is a gather), losses {[f'{x:.7g}' for x in losses]}, "
            f"max_memory_allocated {peak:,} bytes; one step's gradients "
            f"with the kernel against use_kernel=False: worst max |diff| "
            f"{err:.3g} of the leaf's max |plain| (<= {GRAD_SHARE[name]}) "
            f"[{card}]")
        del res
        torch.cuda.empty_cache()
    return launched


def lm_train_line(name: str, res, peak: int, card: str, *,
                  k: int = 3) -> tuple[str, float]:
    """The step time, peak and loss of a Trainer run, the loss (and with
    an MTP head its "ce" and "mtp_ce") falling over its first and last k
    steps."""
    first, last = loss_falls(res["log"], name, k=k)
    n_params = sum(t.numel() for t in tree_leaves(res["params"].params))
    ms = step_ms(res["log"])
    terms = ""
    for key in ("ce", "mtp_ce") if "mtp_ce" in res["log"][0] else ():
        f, l_ = loss_falls([{"loss": r[key]} for r in res["log"]],
                           f"{name} {key}", k=k)
        terms += f"; {key} {f:.4f} -> {l_:.4f}"
    return (f"{n_params:,} parameters: {ms:.3f} ms a step (median of "
            f"{len(res['log']) - 1}), max_memory_allocated {peak:,} bytes; "
            f"loss mean of the first {k} steps {first:.4f} -> last {k} "
            f"{last:.4f}{terms} [{card}]"), ms


def phase_train_lm(card: str) -> dict:
    """granite-3-8b's widths at LM_TRAIN_LAYERS layers in float32 through
    the Trainer: ms a step, peak, the loss falls, flash_attention not
    launched."""
    cfg = dataclasses.replace(granite_3_8b.full(), n_layers=LM_TRAIN_LAYERS,
                              dtype="float32")
    task = TrainTask(
        name=cfg.name, init_params=lambda g: Transformer.random(
            cfg, seed=g.initial_seed(), device=g.device),
        loss_fn=lambda m, b: lm_loss_fn(m.params, cfg, b["tokens"],
                                        b["labels"]),
        batches=Prefetcher(token_batches(cfg.vocab_size, LM_TRAIN_B,
                                         LM_TRAIN_S, seed=1), device=DEV),
        lr=1e-3, warmup=20, total_steps=LM_TRAIN_STEPS, device=DEV)
    reset_counts()
    _, res, peak = train_run(task, LM_TRAIN_STEPS)
    if counts()["flash_attention"]:
        raise AssertionError("LM training launched flash_attention: it "
                             "trains through _sdpa")
    line, ms = lm_train_line(cfg.name, res, peak, card)
    log(f"  {cfg.name} widths at {LM_TRAIN_LAYERS} layers, float32, batch "
        f"{LM_TRAIN_B} x {LM_TRAIN_S:,}, {line}")
    return dict(ms=ms, peak=peak)


def phase_train_moe(card: str) -> dict:
    """qwen2-moe-a2.7b's and deepseek-v3-671b's widths through
    launch/train.build_task and the Trainer in float32: qwen2-moe at
    LM_TRAIN_LAYERS layers; deepseek-v3 with its MTP head at the depth a
    probe step predicts under TRAIN_PEAK_LIMIT. ms a step, peak, the loss
    (and the MTP term) falls, flash_attention not launched."""
    out = {}
    task = build_task("qwen2-moe-a2.7b", MOE_TRAIN_STEPS, LM_TRAIN_B,
                      LM_TRAIN_S, False, device=DEV, config="full",
                      n_layers=LM_TRAIN_LAYERS)
    reset_counts()
    _, res, peak = train_run(task, MOE_TRAIN_STEPS)
    line, out["qwen2-moe-a2.7b"] = lm_train_line("qwen2-moe-a2.7b", res,
                                                 peak, card)
    log(f"  qwen2-moe-a2.7b widths at {LM_TRAIN_LAYERS} layers, float32, "
        f"batch {LM_TRAIN_B} x {LM_TRAIN_S:,}, {line}")
    del task, res
    cfg = deepseek_v3_671b.full()

    def ds_task(n_layers: int, steps: int):
        task = build_task("deepseek-v3-671b", steps, DS_TRAIN_B, DS_TRAIN_S,
                          False, device=DEV, config="full", n_layers=n_layers)
        task.lr, task.warmup = DS_TRAIN_LR, DS_TRAIN_WARMUP
        return task
    _, res, probe = train_run(ds_task(1, 1), 1)
    held = 16 * sum(t.numel() for t in tree_leaves(res["params"].params))
    del res
    # each further dense layer: its weights, gradients and two moments,
    # and at most what the 1-layer step holds beyond those (the head's
    # logits and the MTP block's included, so an overestimate)
    per_layer = 16 * (dataclasses.replace(cfg, n_layers=2,
                                          first_dense_layers=2).n_params()
                      - dataclasses.replace(cfg, n_layers=1,
                                            first_dense_layers=1).n_params()) \
        + (probe - held)

    def predict(n: int) -> float:
        return probe + (n - 1) * per_layer
    depth = max([n for n in range(1, DS_TRAIN_MAX_LAYERS + 1)
                 if predict(n) <= TRAIN_PEAK_LIMIT] or [1])
    log(f"  deepseek-v3-671b probe step at 1 dense layer, batch {DS_TRAIN_B}"
        f" x {DS_TRAIN_S:,}: max_memory_allocated {probe:,} bytes ({held:,} "
        f"of weights, gradients and moments); predicted "
        + ", ".join(f"{predict(n):,.0f} at {n}"
                    for n in range(1, DS_TRAIN_MAX_LAYERS + 1))
        + f"; trains at {depth} (<= {TRAIN_PEAK_LIMIT:,.0f}) [{card}]")
    torch.cuda.empty_cache()
    _, res, peak = train_run(ds_task(depth, DS_TRAIN_STEPS), DS_TRAIN_STEPS)
    if counts()["flash_attention"]:
        raise AssertionError("MoE and MLA training launched flash_attention: "
                             "they train through _sdpa")
    line, out["deepseek-v3-671b"] = lm_train_line("deepseek-v3-671b", res,
                                                  peak, card)
    log(f"  deepseek-v3-671b widths at {depth} dense MLA layer(s) with the "
        f"MTP head, float32, batch {DS_TRAIN_B} x {DS_TRAIN_S:,}, lr "
        f"{DS_TRAIN_LR:g} after a {DS_TRAIN_WARMUP:,}-step warmup, {line}")
    del res
    torch.cuda.empty_cache()
    return out


def guard_check() -> None:
    """Each kernel without a backward raises on the card when an input
    requires grad under grad mode; segment_spmm's gradient equals its
    plain version's."""
    t = torch.randn(64, 10, device=DEV, requires_grad=True)
    ids = torch.arange(8, device=DEV)
    q = torch.randn(1, 2, 8, 16, device=DEV, requires_grad=True)
    xk = torch.randn(2, 1, 5, device=DEV, requires_grad=True)
    cases = {
        "gather_rows": lambda: emb_ops.gather_rows(t, ids),
        "bag_sum": lambda: emb_ops.bag_sum(t, ids.reshape(2, 4)),
        "cin_layer": lambda: cin_ops.cin_layer(
            xk, torch.randn(2, 7, 5, device=DEV),
            torch.randn(3, 1, 7, device=DEV)),
        "flash_attention": lambda: fa_ops.flash_attention(q, q, q),
        "jaccard_distance": lambda: jac_ops.jaccard_distance(
            (t > 0).float().requires_grad_(True))}
    for name, call in cases.items():
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} ran under autograd on the card")
        with torch.no_grad():
            call()                     # and runs where nothing records it
    vals = torch.randn(500, 7, device=DEV, requires_grad=True)
    recv = torch.randint(-2, 42, (500,), device=DEV, dtype=torch.int32)
    mask = torch.rand(500, device=DEV) < 0.8
    up = torch.randn(40, 7, device=DEV)
    (gk,) = torch.autograd.grad((seg_ops.segment_spmm(vals, recv, mask, 40)
                                 * up).sum(), vals)
    (gp,) = torch.autograd.grad((segment_spmm_ref(vals, recv, mask, 40)
                                 * up).sum(), vals)
    if not torch.equal(gk, gp):
        raise AssertionError("segment_spmm's gradient differs from its "
                             "plain version's")
    log(f"  guard: {', '.join(cases)} raise under autograd on the card and "
        f"run under torch.no_grad(); segment_spmm's gradient equals its "
        f"plain version's (masked edges, receivers outside [0, n))")


def phase_train(card: str) -> dict:
    """Phase 11; returns the GNN training's segment_spmm launches."""
    t0 = time.perf_counter()
    guard_check()
    gnn = phase_train_gnn(card)
    _GRAPHS.clear()
    torch.cuda.empty_cache()
    xd_out = phase_train_xdeepfm(card)
    lm_out = phase_train_lm(card)
    moe_out = phase_train_moe(card)
    log(f"  phase 11: {time.perf_counter() - t0:.1f} s")
    return {"gnn": gnn, "xdeepfm": xd_out, "lm": lm_out, "moe": moe_out}


# ---------------------------------------------------------------------------
# phase 11b: the model-parallel mesh, gloo ranks on the one card
# ---------------------------------------------------------------------------

MM_SEED = 7
MM_TIMEOUT, MM_JOIN = 600.0, 900.0   # a collective's wait; a spawn's in all
# bfloat16 results against the one-device path on the card: max |diff| as
# a share of the one-device result's largest |value|. Both round to
# bfloat16 (2**-8 relative) at different points: the mesh sums partial
# expert outputs, or combines normalised attention partials, in float32
# after each rank rounded its own part, and those steps' differences pass
# through the later layers' bfloat16 products. float32 at full width is
# held at CHECK_LOGIT_SHARE.
MM_BF16_SHARE = 3e-2
MM_TRAIN_RTOL = 1e-3         # mesh Trainer's losses against one device's
MM_DS_TOKENS = 4096          # deepseek-v3's MoE layer: a 1 x 4,096 prefill
MM_QWEN_B, MM_QWEN_S = 2, 4096   # qwen2-moe's: 2 x 4,096 tokens
MM_DECODE_LAYERS, MM_DECODE_REPS = 2, 5
# one step on 2 x 2 before the restore onto 4 x 1 (with three steps there,
# phase 12 took the smoke past 1,000 s)
MM_TRAIN_B, MM_TRAIN_S, MM_TRAIN_STEPS = 4, 1024, 1
# a 2 x 2 rank's max_memory_allocated over that one step under the
# whole-leaf route the FSDP step replaced (every leaf gathered whole into
# the model first), measured by mm_rank_train before the change on an
# NVIDIA H100 80GB HBM3 at 700.00 W
MM_TRAIN_WHOLE_LEAF_PEAK = 10_308_495_360
MM_CKPT_DIR = Path(__file__).resolve().parent / "build" / "smoke_mesh_ckpt"
# flash's lse route at the split decode's rank shape: granite-3-8b's 8
# sequences over a 32,768-slot cache on 2 x 4, a rank's 4 sequences over
# its 8,192 slots, the last slice (cur - its offset = 8,184)
LSE_B, LSE_T, LSE_LIM = 4, 8192, DECODE_CUR - 3 * 8192
# flash's lse output against attention_lse_ref's: float32 lse of the same
# float32 scores in another summation order
LSE_ATOL = 1e-4


def flash_lse_case(b, hkv, g, s, t, d, dt, q_start: int) -> tuple:
    """(max |out diff|, max |lse diff|) of flash_attention(...,
    return_lse=True) on cache-layout views against attention_lse_ref;
    fails beyond FLASH_TOL and LSE_ATOL, or if the launches are not one a
    group of at most 16 rows a KV head on route "split_lse"."""
    q = torch.randn(b, s, hkv * g, d, device=DEV).to(dt).transpose(1, 2)
    k = torch.randn(b, t, hkv, d, device=DEV).to(dt).transpose(1, 2)
    v = torch.randn(b, t, hkv, d, device=DEV).to(dt).transpose(1, 2)
    n0, r0 = (fa_ops.flash_attention.launches,
              fa_ops.flash_attention.routes["split_lse"])
    out, lse = fa_ops.flash_attention(q, k, v, q_start=q_start,
                                      return_lse=True)
    torch.cuda.synchronize()
    groups = -(-g // (16 // s))
    if (fa_ops.flash_attention.launches - n0 != groups
            or fa_ops.flash_attention.routes["split_lse"] - r0 != groups):
        raise AssertionError(f"flash lse {(b, hkv, g, s, t, d)}: "
                             f"{fa_ops.flash_attention.launches - n0} "
                             f"launches, expected {groups} on split_lse")
    ref_out, ref_lse = attention_lse_ref(q, k, v, q_start=q_start)
    e_out = float_err(out.float(), ref_out.float(), **FLASH_TOL[dt])
    e_lse = float_err(lse, ref_lse, atol=LSE_ATOL)
    return e_out, e_lse


def flash_lse_record() -> dict:
    """The split route with its log-sum-exp (what a split-KV decode rank
    launches): a sweep (G 1, 4 and 48, the last in groups of 16 rows; S up
    to 4; one chunk where the grid fills the card; head dims 7 and 100;
    q_start 0 and mid-cache; float32 and bfloat16) against its plain
    version, then the record at the split decode's rank shape in
    bfloat16: q (4, 32, 1, 128) over a (4, 8,192, 8, 128) slice, q_start
    8,184, with its CUDA-event time and its device time (torch.profiler:
    the two launches without the host's time to issue them)."""
    worst = {}
    for case in ((4, 8, 4, 1, 8192, 128, 8184), (1, 1, 48, 1, 300, 128, 299),
                 (64, 8, 4, 1, 2000, 128, 1999), (2, 2, 4, 4, 500, 64, 100),
                 (3, 2, 4, 1, 77, 7, 40), (1, 2, 16, 1, 64, 128, 0),
                 (2, 4, 4, 1, 256, 100, 255)):
        for dt in (torch.float32, torch.bfloat16):
            e = flash_lse_case(*case[:6], dt, case[6])
            worst[dt] = tuple(max(a, b_) for a, b_ in
                              zip(worst.get(dt, (0.0, 0.0)), e))
    log(f"  flash lse sweep: 14 cases within FLASH_TOL and lse atol "
        f"{LSE_ATOL} (max |diff| out, lse: float32 {worst[torch.float32]}, "
        f"bfloat16 {worst[torch.bfloat16]})")
    gen = torch.Generator(device=DEV).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV).bfloat16()
    q = randn(LSE_B, 1, 32, 128).transpose(1, 2)
    k = randn(LSE_B, LSE_T, 8, 128).transpose(1, 2)
    v = randn(LSE_B, LSE_T, 8, 128).transpose(1, 2)
    out, lse = fa_ops.flash_attention(q, k, v, q_start=LSE_LIM,
                                      return_lse=True)
    torch.cuda.synchronize()
    ref_out, ref_lse = attention_lse_ref(q, k, v, q_start=LSE_LIM)
    err = float_err(out.float(), ref_out.float(),
                    **FLASH_TOL[torch.bfloat16])
    e_lse = float_err(lse, ref_lse, atol=LSE_ATOL)
    plan = fa_kernel.plan(q, k, v, causal=True, q_start=LSE_LIM, lse=True)
    b_ms, b_by = flash_bound(q, k, LSE_LIM)

    def call():
        return fa_ops.flash_attention(q, k, v, q_start=LSE_LIM,
                                      return_lse=True)
    rec = dict(
        name="flash_attention.flash_attention[decode_lse]", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:75",
        max_abs_err=err, max_abs_err_lse=e_lse,
        ms=time_ms(call), kernel_ms=kernel_ms(call),
        plain_ms=time_ms(lambda: attention_lse_ref(q, k, v,
                                                   q_start=LSE_LIM), reps=5),
        bound_ms=b_ms, bound_by=b_by,
        # no single PyTorch call returns the output with its lse for
        # grouped KV heads: aten's flash and efficient attention return
        # the lse but take as many KV heads as query heads
        library_ms=None, q=list(q.shape), kv=list(k.shape),
        q_start=LSE_LIM, flash_route="split_lse", n_split=plan.n_split)
    log(f"  flash_attention.flash_attention decode_lse (plan {plan}): {rec}")
    return rec


def mm_gen(*key) -> torch.Generator:
    """A generator on the card seeded from MM_SEED and ``key`` (ints), so
    every process draws the same numbers for the same piece."""
    seed = MM_SEED
    for k_ in key:
        seed = seed * 1_000_003 + k_
    return torch.Generator(device=DEV).manual_seed(seed % (2 ** 63))


def mm_randn(shape, *key, scale: float = 1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=mm_gen(*key), device=DEV)
            * scale).to(dtype)


def mm_moe_pieces(cfg, n_tok: int) -> dict:
    """The MoE layer's router, shared expert and (n_tok, D) tokens, from
    their seeds."""
    d, fs = cfg.d_model, cfg.shared_d_ff
    return {"router": mm_randn((d, cfg.n_experts), 1, scale=d ** -0.5),
            "shared": {"w_in": mm_randn((d, fs), 2, scale=d ** -0.5),
                       "w_gate": mm_randn((d, fs), 3, scale=d ** -0.5),
                       "w_out": mm_randn((fs, d), 4, scale=fs ** -0.5)},
            "x": mm_randn((n_tok, d), 5)}


def mm_experts(cfg, experts) -> dict:
    """The (len(experts), D, F) / (., F, D) weights of ``experts``, each
    expert's three matrices from its own seed."""
    d, f = cfg.d_model, cfg.moe_d_ff
    out = {k: torch.empty(shape, dtype=torch.bfloat16, device=DEV)
           for k, shape in (("w_in", (len(experts), d, f)),
                            ("w_gate", (len(experts), d, f)),
                            ("w_out", (len(experts), f, d)))}
    for i, e in enumerate(experts):
        out["w_in"][i] = mm_randn((d, f), 100 + e, 0, scale=d ** -0.5)
        out["w_gate"][i] = mm_randn((d, f), 100 + e, 1, scale=d ** -0.5)
        out["w_out"][i] = mm_randn((f, d), 100 + e, 2, scale=f ** -0.5)
    return out


def mm_no_drop(cfg, idx, block_counts):
    """cfg at the smallest capacity factor with which no pair drops when
    the tokens are cut into each of ``block_counts`` numbers of equal
    blocks, one device or a mesh rank routing a block."""
    e, k = cfg.n_experts, cfg.top_k
    n = idx.shape[0]
    cf = max(int(torch.bincount(b.reshape(-1), minlength=e).max())
             / (n // nb * k / e)
             for nb in block_counts for b in idx.chunk(nb))
    out = dataclasses.replace(cfg, capacity_factor=cf * (1 + 1e-6))
    for nb in block_counts:
        for b in idx.chunk(nb):
            top = int(torch.bincount(b.reshape(-1), minlength=e).max())
            if (lm_mod.moe_mesh_capacity(out, n // nb) < top
                    or lm_mod.moe_capacity(out, n // nb) < top):
                raise AssertionError("no-drop capacity factor drops pairs")
    return out


def mm_moe_reference(cfg, n_tok: int, block_counts):
    """(cfg at a capacity with no drops, {blocks: the one-device layer's
    output on the card, on the host}) for each number of blocks a mesh
    cuts the tokens into along "data": the one-device layer runs on each
    block, as a rank does. With no drops a token's output does not depend
    on the others, but the card's bfloat16 router product rounds
    differently at another row count, and a near tie between a token's
    k-th and (k+1)-th expert then routes it elsewhere (on an NVIDIA H100,
    110 of 8,192 tokens of qwen2-moe's layer when 2 blocks of 4,096 were
    held to one of 8,192)."""
    pieces = mm_moe_pieces(cfg, n_tok)
    _, idx = lm_mod.moe_gates(pieces, cfg, pieces["x"])
    cfg = mm_no_drop(cfg, idx, block_counts)
    p = {"router": pieces["router"], "shared": pieces["shared"],
         "experts": mm_experts(cfg, range(cfg.n_experts))}
    refs = {}
    for nb in block_counts:
        drops: list = []
        refs[nb] = torch.cat([lm_mod._moe_mlp(p, cfg, xb[None], drops)[0]
                              for xb in pieces["x"].chunk(nb)]).cpu()
        if int(sum(drops)):
            raise AssertionError(f"{cfg.name}: one-device layer dropped "
                                 f"pairs")
    del p, pieces
    torch.cuda.empty_cache()
    return cfg, refs


def mm_rank_moe(mesh, cfg, n_tok: int) -> dict:
    """One MoE layer on this rank: its experts' blocks under
    lm_rules(fsdp=True), its block of the tokens along "data"; the output,
    drops, the collectives' calls and bytes a layer, ms a layer (median of
    3 after a warm call), peak memory."""
    shapes = {"experts": {
        k: types.SimpleNamespace(shape=s) for k, s in (
            ("w_in", (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)),
            ("w_gate", (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)),
            ("w_out", (cfg.n_experts, cfg.moe_d_ff, cfg.d_model)))}}
    specs = make_param_specs(shapes, mesh,
                             lm_rules(mesh, fsdp=True))["experts"]
    ax = specs["w_in"][0]
    n_e = cfg.n_experts // (mesh.axes_size(ax) if ax else 1)
    first = mesh.axis_index(ax) * n_e if ax else 0
    whole = mm_experts(cfg, range(first, first + n_e))
    experts = {k: local_slice(v, P(None, *specs[k][1:]), mesh).clone()
               for k, v in whole.items()}
    del whole
    pieces = mm_moe_pieces(cfg, n_tok)
    n = n_tok // mesh.axes_size("data")
    x = pieces["x"][mesh.axis_index("data") * n:][:n][None]
    p = {"router": pieces["router"], "shared": pieces["shared"],
         "experts": experts}
    torch.cuda.reset_peak_memory_stats()
    lm_mod._moe_mlp(p, cfg, x, mesh=mesh)
    times = []
    for _ in range(3):
        mesh.reset_counts()
        drops: list = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lm_mod._moe_mlp(p, cfg, x, drops, mesh=mesh)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out = out[0].cpu()
    return dict(coords=(mesh.axis_index("data"), mesh.axis_index("model")),
                out=out if mesh.axis_index("model") == 0 else None,
                digest=hashlib.sha1(out.view(torch.int16).numpy().tobytes())
                .hexdigest(), drops=int(sum(drops)),
                calls=dict(mesh.calls), bytes=dict(mesh.bytes),
                ms=float(np.median(times)),
                expert_bytes=sum(t.numel() * t.element_size()
                                 for t in experts.values()),
                mode=lm_mod.moe_mesh_mode(cfg, mesh),
                peak=torch.cuda.max_memory_allocated())


def mm_check_moe(label: str, ranks, ref, card: str) -> None:
    """Every rank of a data row equal (SHA-1), the rows' blocks together
    within MM_BF16_SHARE of the one-device layer, no drops, one all_reduce
    a layer."""
    rows = {}
    for r in ranks:
        rows.setdefault(r["coords"][0], set()).add(r["digest"])
    if any(len(d) != 1 for d in rows.values()):
        raise AssertionError(f"{label}: the model columns of a data row "
                             f"disagree")
    out = torch.cat([r["out"] for r in sorted(
        (r for r in ranks if r["out"] is not None),
        key=lambda r: r["coords"][0])])
    err = float((out.float() - ref.float()).abs().max())
    top = float(ref.float().abs().max())
    if err > MM_BF16_SHARE * top or any(r["drops"] for r in ranks):
        raise AssertionError(f"{label}: max |mesh - one device| {err} of "
                             f"max {top}, drops {[r['drops'] for r in ranks]}")
    if any(r["calls"].get("all_reduce") != 1 for r in ranks):
        raise AssertionError(f"{label}: all_reduces a layer "
                             f"{[r['calls'] for r in ranks]}")
    r0 = ranks[0]
    log(f"  {label} ({r0['mode']}): max |mesh - one device| {err:.4g} "
        f"(share {err / top:.3g} of max {top:.4g}; bf16, within "
        f"{MM_BF16_SHARE}); all_reduce {r0['bytes']['all_reduce']:,} bytes "
        f"a layer a rank, all_gather "
        f"{r0['bytes'].get('all_gather', 0):,} (the ZeRO re-gather); "
        f"expert weights {r0['expert_bytes']:,} bytes a rank; ms a layer "
        f"(host wall, gloo on one card) "
        f"{[round(r['ms'], 3) for r in ranks]}; peak a rank "
        f"{max(r['peak'] for r in ranks):,} bytes [{card}]")


def mm_decode_cfg(name: str, dtype: str):
    if name == "gqa":
        return dataclasses.replace(granite_3_8b.full(),
                                   n_layers=MM_DECODE_LAYERS, dtype=dtype)
    return dataclasses.replace(
        deepseek_v3_671b.full(), n_layers=MM_DECODE_LAYERS,
        first_dense_layers=MM_DECODE_LAYERS, mtp_depth=0, dtype=dtype)


def mm_cache(model, batch: int, mesh=None, rows=None):
    """The decode's cache of DECODE_T slots: each layer's tensors drawn
    unit-normal for DECODE_B sequences from their seeds (rows ``rows`` of
    them kept); whole, or this rank's block for a step of ``batch``."""
    n_b = batch if rows is None else rows.stop - rows.start
    full = model.init_cache(n_b, DECODE_T, mesh=mesh)
    specs = model.cache_specs(n_b, mesh) if mesh is not None else None
    for si, name in enumerate(("dense", "moe")):
        if full[name] is None:
            continue
        for ti, stack in enumerate(full[name]):
            for layer in range(stack.shape[0]):
                shape = (DECODE_B, DECODE_T, *stack.shape[3:])
                t = mm_randn(shape, 200 + si, ti, layer,
                             dtype=stack.dtype)
                if rows is not None:
                    t = t[rows]
                if specs is not None:
                    t = local_slice(t, P(*specs[name][ti][1:]), mesh)
                stack[layer].copy_(t)
                del t
    return full


def mm_decode_model(name: str, dtype: str, mesh=None):
    model = Transformer.random(mm_decode_cfg(name, dtype), seed=MM_SEED,
                               device=DEV)
    if name == "mla" and mesh is not None:
        attn = model.params["dense_layers"]["attn"]
        attn["wkv_b"] = local_slice(attn["wkv_b"], P(None, None, "model"),
                                    mesh).clone()
        model = Transformer(model.cfg, model.params)
    return model


def mm_tokens(model, batch: int):
    return torch.randint(0, model.cfg.vocab_size, (DECODE_B, 1),
                         generator=mm_gen(300), device=DEV)[:batch]


def mm_decode_reference(name: str, dtypes) -> dict:
    """One-device decode logits at DECODE_CUR, for a batch of DECODE_B and
    of 1, in each dtype (flash for GQA, the absorbed decode for MLA)."""
    out = {}
    for dt in dtypes:
        model = mm_decode_model(name, dt)
        for b in (DECODE_B, 1):
            if name == "mla" and b == 1:
                continue
            cache = mm_cache(model, b, rows=None if b > 1 else slice(0, 1))
            logits, _ = model.decode_step(cache, mm_tokens(model, b),
                                          DECODE_CUR)
            out[(dt, b)] = logits.cpu()
            del cache
        del model
        torch.cuda.empty_cache()
    return out


def mm_rank_decode(mesh, name: str, dtypes) -> dict:
    """The split-KV decode on this rank at each dtype and batch: logits
    (rank 0), their SHA-1, and for the timed run (the last dtype, batch
    DECODE_B): ms a step (median of MM_DECODE_REPS after a warm step), the
    flash launches and routes of those steps, the collectives' calls and
    bytes a step, peak memory."""
    out = {"coords": (mesh.axis_index("data"), mesh.axis_index("model"))}
    for dt in dtypes:
        model = mm_decode_model(name, dt, mesh)
        for b in (DECODE_B, 1):
            if name == "mla" and b == 1:
                continue
            cache = mm_cache(model, b, mesh,
                             rows=None if b > 1 else slice(0, 1))
            toks = mm_tokens(model, b)
            torch.cuda.reset_peak_memory_stats()
            logits, _ = model.decode_step(cache, toks, DECODE_CUR,
                                          mesh=mesh)
            torch.cuda.synchronize()
            host = logits.cpu()
            out[(dt, b)] = dict(
                logits=host if mesh.rank == 0 else None,
                digest=hashlib.sha1(host.float().numpy().tobytes())
                .hexdigest())
            if dt == dtypes[-1] and b == DECODE_B:
                reset_counts()
                times = []
                for _ in range(MM_DECODE_REPS):
                    mesh.reset_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    model.decode_step(cache, toks, DECODE_CUR, mesh=mesh)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                out["timed"] = dict(
                    ms=float(np.median(times)), calls=dict(mesh.calls),
                    bytes=dict(mesh.bytes),
                    flash=fa_ops.flash_attention.launches,
                    routes=dict(fa_ops.flash_attention.routes),
                    peak=torch.cuda.max_memory_allocated(),
                    cache_bytes=sum(t.numel() * t.element_size()
                                    for v in cache.values() if v
                                    for t in v))
            del cache
        del model
        torch.cuda.empty_cache()
    return out


def mm_check_decode(label: str, ranks, refs, dtypes, card: str) -> dict:
    """Every rank's logits equal (SHA-1); rank 0's within
    CHECK_LOGIT_SHARE (float32) or MM_BF16_SHARE (bfloat16) of max |logit|
    of the one-device decode; the timed steps' flash launches (GQA: one a
    layer a step on route split_lse on every rank; MLA: none)."""
    for key in refs:
        if len({r[key]["digest"] for r in ranks}) != 1:
            raise AssertionError(f"{label} {key}: ranks' logits differ")
        got, ref = ranks[0][key]["logits"].float(), refs[key].float()
        err, top = float((got - ref).abs().max()), float(ref.abs().max())
        share = CHECK_LOGIT_SHARE if key[0] == "float32" else MM_BF16_SHARE
        if not err <= share * top:
            raise AssertionError(f"{label} {key}: max |mesh - one device| "
                                 f"{err} of max |logit| {top}")
        log(f"  {label} {key[0]} batch {key[1]}: max |mesh - one device| "
            f"{err:.4g} of max |logit| {top:.4g} (share {err / top:.3g}, "
            f"within {share})")
    want = MM_DECODE_LAYERS * MM_DECODE_REPS if label.startswith("GQA") \
        else 0
    for r in ranks:
        t = r["timed"]
        if t["flash"] != want or t["routes"].get("split_lse", 0) != want:
            raise AssertionError(f"{label}: a rank launched flash "
                                 f"{t['flash']} times ({t['routes']}) in "
                                 f"{MM_DECODE_REPS} steps, expected {want} "
                                 f"on split_lse")
    t = ranks[0]["timed"]
    log(f"  {label} bf16, batch {DECODE_B} over {DECODE_T:,} slots from "
        f"{DECODE_CUR:,}: ms a step (host wall, median of "
        f"{MM_DECODE_REPS}) {[round(r['timed']['ms'], 3) for r in ranks]}; "
        f"a rank a step: calls {t['calls']}, bytes {t['bytes']}; flash "
        f"launches a rank {[r['timed']['flash'] for r in ranks]}; cache "
        f"block {t['cache_bytes']:,} bytes, peak a rank "
        f"{max(r['timed']['peak'] for r in ranks):,} [{card}]")
    return {"launches": sum(r["timed"]["flash"] for r in ranks),
            "ms": [r["timed"]["ms"] for r in ranks]}


def mm_train_cfg():
    return dataclasses.replace(granite_3_8b.full(), n_layers=MM_DECODE_LAYERS,
                               dtype="float32")


def mm_train_task(mesh=None) -> TrainTask:
    """granite-3-8b's widths at 2 layers, float32; on a mesh the state by
    lm_rules(fsdp=True) and the batch split over "data"."""
    cfg = mm_train_cfg()
    task = TrainTask(
        name=cfg.name, init_params=lambda g: Transformer.random(
            cfg, seed=g.initial_seed(), device=g.device),
        loss_fn=lambda m, b: lm_loss_fn(m.params, cfg, b["tokens"],
                                        b["labels"]),
        batches=Prefetcher(token_batches(cfg.vocab_size, MM_TRAIN_B,
                                         MM_TRAIN_S, seed=1), device=DEV),
        lr=1e-3, warmup=20, total_steps=20, device=DEV)
    if mesh is not None:
        task.param_specs = lambda tree: make_param_specs(
            tree, mesh, lm_rules(mesh, fsdp=True))
        task.batch_specs = {"tokens": P("data", None),
                            "labels": P("data", None)}
    return task


def mm_rank_train(mesh, steps: int) -> dict:
    """The mesh Trainer (its FSDP step: each layer's blocks gathered in
    the layer, the gradients reduce-scattered as the backward leaves it)
    from MM_CKPT_DIR's latest checkpoint (none on the first run) to
    ``steps``, checkpointing at the end; the collectives counted over the
    steps alone, max_memory_allocated over the run and over the steps
    alone."""
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(mm_train_task(mesh), mesh=mesh,
                      ckpt_dir=str(MM_CKPT_DIR), ckpt_every=1000)
    step, counted, peaks = trainer._mesh_step, {}, {"run": 0, "step": 0}

    def counting(*a, **kw):
        mesh.reset_counts()
        peaks["run"] = max(peaks["run"], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        out = step(*a, **kw)
        peaks["step"] = max(peaks["step"], torch.cuda.max_memory_allocated())
        for k, v in mesh.calls.items():
            counted[k] = counted.get(k, 0) + v
        return out
    trainer._mesh_step = counting
    res = trainer.run(steps=steps)
    return dict(log=[{k: r[k] for k in ("step", "loss", "grad_norm", "dt")}
                     for r in res["log"]],
                calls=counted, peak=max(peaks["run"],
                                        torch.cuda.max_memory_allocated()),
                step_peak=peaks["step"])


# tensor-parallel serving: each rank serves from its lm_rules blocks (the
# layers column/row-parallel over "model", the embedding and the head
# vocabulary-parallel); a prefill of batch x seq tokens into TP_SLOTS
# slots, then TP_STEPS decode steps of fixed tokens from that cache, each
# against the one-device path on the card. Granite-3-8b's ranks also run
# the same passes over whole leaves on the mesh first: the peak beside it
TP_SLOTS, TP_STEPS, TP_WARM_S = 8192, 5, 256
TP_CASES = {
    "granite-3-8b": dict(mesh=(2, 4), batch=2, seq=4096, fsdp=False,
                         dtypes=("bfloat16", "float32")),
    "granite-20b": dict(mesh=(1, 4), batch=1, seq=4096, fsdp=False,
                        dtypes=("bfloat16",)),
    "deepseek-v3": dict(mesh=(2, 2), batch=2, seq=2048, fsdp=True,
                        dtypes=("bfloat16",))}


def tp_cfg(name: str, dtype: str):
    """The case's config: 2 layers at its model's widths (deepseek-v3's 2
    dense MLA layers)."""
    if name == "deepseek-v3":
        return mm_decode_cfg("mla", dtype)
    full = granite_3_8b.full() if name == "granite-3-8b" \
        else granite_20b.full()
    return dataclasses.replace(full, n_layers=MM_DECODE_LAYERS, dtype=dtype)


def tp_tokens(cfg, name: str):
    c = TP_CASES[name]
    return torch.randint(0, cfg.vocab_size,
                         (c["batch"], c["seq"] + TP_STEPS),
                         generator=mm_gen(400), device=DEV)


def tp_reference(name: str) -> dict:
    """The one-device path on the card, per dtype: the prefill's last
    position's logits, then each step's, (B, V) float32 on the host."""
    c, out = TP_CASES[name], {}
    for dt in c["dtypes"]:
        cfg = tp_cfg(name, dt)
        model = Transformer.random(cfg, seed=MM_SEED, device=DEV)
        toks = tp_tokens(cfg, name)
        s = c["seq"]
        with torch.no_grad():
            logits, cache = model.prefill(toks[:, :s], TP_SLOTS)
            out[dt] = [logits[:, -1].float().cpu()]
            for i in range(TP_STEPS):
                step, _ = model.decode_step(cache, toks[:, s + i:s + i + 1],
                                            s + i)
                out[dt].append(step[:, 0].float().cpu())
        del model, cache, logits
        torch.cuda.empty_cache()
    return out


def tp_pass(mesh, model, mine, batch: int, s: int) -> dict:
    """The mesh prefill of this rank's tokens, then TP_STEPS steps (after
    a warm prefill of TP_WARM_S tokens): the logits (the rank's blocks, on
    the host), ms of the prefill and of a step (median), the collectives'
    calls and bytes and the flash launches and routes of each, this
    rank's max_memory_allocated over the passes."""
    with torch.no_grad():
        model.prefill(mine[:, :TP_WARM_S], 4 * TP_WARM_S, mesh=mesh,
                      batch=batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        mesh.reset_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(mine[:, :s], TP_SLOTS, mesh=mesh,
                                      batch=batch)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        out = {"prefill": dict(calls=dict(mesh.calls),
                               bytes=dict(mesh.bytes),
                               flash=fa_ops.flash_attention.launches,
                               routes=dict(fa_ops.flash_attention.routes)),
               "logits": [logits.float().cpu()], "prefill_ms": pre_ms}
        reset_counts()
        mesh.reset_counts()
        times = []
        for i in range(TP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step, _ = model.decode_step(cache, mine[:, s + i:s + i + 1],
                                        s + i, mesh=mesh, batch=batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            out["logits"].append(step[:, 0].float().cpu())
    out["decode"] = dict(calls=dict(mesh.calls), bytes=dict(mesh.bytes),
                         flash=fa_ops.flash_attention.launches,
                         routes=dict(fa_ops.flash_attention.routes))
    out["step_ms"] = float(np.median(times))
    out["peak"] = torch.cuda.max_memory_allocated()
    out["cache_bytes"] = sum(t.numel() * t.element_size()
                             for v in cache.values() if v for t in v)
    return out


def tp_rank(mesh, name: str) -> dict:
    """The case on this rank, per dtype: its blocks cut from the seeded
    whole model (then freed) and `tp_pass` over them; for granite-3-8b in
    bfloat16 first the same passes over the whole leaves."""
    c = TP_CASES[name]
    out = {"coords": (mesh.axis_index("data"), mesh.axis_index("model"))}
    b, s = c["batch"], c["seq"]
    n = b // mesh.axes_size("data") if b > 1 else 1
    d = mesh.axis_index("data") if b > 1 else 0
    for dt in c["dtypes"]:
        cfg = tp_cfg(name, dt)
        model = Transformer.random(cfg, seed=MM_SEED, device=DEV)
        mine = tp_tokens(cfg, name)[d * n:(d + 1) * n]
        if name == "granite-3-8b" and dt == "bfloat16":
            out["whole_leaf"] = tp_pass(mesh, model, mine, b, s)
        specs = make_param_specs(model.param_tree(), mesh,
                                 lm_rules(mesh, fsdp=c["fsdp"]))
        blocks = tree_map(lambda t, sp: local_slice(t, sp, mesh).clone(),
                          model.param_tree(), specs)
        del model
        torch.cuda.empty_cache()
        out[dt] = tp_pass(mesh, Transformer(cfg, Blocks(blocks, specs, mesh)),
                          mine, b, s)
        out[dt]["block_bytes"] = sum(t.numel() * t.element_size()
                                     for t in tree_leaves(blocks))
        del blocks
        torch.cuda.empty_cache()
    return out


def tp_check(name: str, ranks, refs, card: str) -> dict:
    """The ranks' logit blocks put together within CHECK_LOGIT_SHARE
    (float32) or MM_BF16_SHARE (bfloat16) of max |logit| of the one-device
    path, at the prefill and every step; a GQA rank launches flash once a
    layer at the prefill on route "wgmma" ("tile" in float32) and once a
    layer a step on "split_lse" (in groups of at most 16 q heads a KV
    head) where its slots begin at or before the step's position.
    Returns the flash launches over the ranks."""
    c = TP_CASES[name]
    layers = MM_DECODE_LAYERS
    gqa = name != "deepseek-v3"
    launches = {"prefill": 0, "decode": 0}
    for dt in c["dtypes"]:
        worst = 0.0
        for i, ref in enumerate(refs[dt]):
            got = torch.full_like(ref, float("nan"))
            for r in ranks:
                blk = r[dt]["logits"][i]
                dd, m = r["coords"]
                rows = slice(dd * blk.shape[0], (dd + 1) * blk.shape[0]) \
                    if c["batch"] > 1 else slice(0, 1)
                got[rows, m * blk.shape[1]:(m + 1) * blk.shape[1]] = blk
            err, top = float((got - ref).abs().max()), float(ref.abs().max())
            share = CHECK_LOGIT_SHARE if dt == "float32" else MM_BF16_SHARE
            if not err <= share * top:
                raise AssertionError(f"tensor-parallel {name} {dt} "
                                     f"{'prefill' if i == 0 else f'step {i}'}"
                                     f": max |mesh - one device| {err} of "
                                     f"max |logit| {top}")
            worst = max(worst, err / top)
        n_data, n_model = c["mesh"]
        for r in ranks:
            # a rank whose slots all lie past a step's position launches
            # nothing in it (its lse is -inf)
            dd, m = r["coords"]
            if c["batch"] > 1:          # slots over "model"
                off = m * TP_SLOTS // n_model
            else:                       # over ("data", "model")
                off = (dd * n_model + m) * TP_SLOTS // (n_data * n_model)
            steps = sum(c["seq"] + i >= off for i in range(TP_STEPS))
            cfg = tp_cfg(name, dt)
            # the lse route launches a group of at most 16 q rows a KV
            # head: granite-20b's 48 heads over its one in three
            groups = -(-(cfg.n_heads // cfg.n_kv_heads) // 16)
            # float32 prefills take the CUDA-core route
            want = ({"wgmma" if dt == "bfloat16" else "tile": layers},
                    {"split_lse": layers * steps * groups} if steps
                    else {}) if gqa else ({}, {})
            for kind, routes in zip(("prefill", "decode"), want):
                t = r[dt][kind]
                if t["routes"] != routes or t["flash"] != sum(
                        routes.values()):
                    raise AssertionError(
                        f"tensor-parallel {name} {dt} {kind}: a rank "
                        f"launched flash {t['flash']} times {t['routes']}, "
                        f"expected {routes}")
                launches[kind] += t["flash"]
        r0 = ranks[0][dt]
        log(f"  tensor-parallel serving, {name} widths, {layers} layers, "
            f"{dt}, {c['mesh'][0]} x {c['mesh'][1]}: prefill of "
            f"{c['batch']} x {c['seq']:,} into {TP_SLOTS:,} slots and "
            f"{TP_STEPS} steps; max |mesh - one device| share {worst:.3g} "
            f"of max |logit| (within "
            f"{CHECK_LOGIT_SHARE if dt == 'float32' else MM_BF16_SHARE}); "
            f"flash a rank: prefill {r0['prefill']['routes']}, steps "
            f"{r0['decode']['routes']}; collectives a rank a layer: prefill "
            f"calls {r0['prefill']['calls']} bytes "
            f"{r0['prefill']['bytes']} over {layers} layers (the "
            f"embedding's all_reduce with them), {TP_STEPS} steps calls "
            f"{r0['decode']['calls']} bytes {r0['decode']['bytes']}; ms "
            f"(host wall, gloo on one card) prefill "
            f"{[round(r[dt]['prefill_ms'], 1) for r in ranks]}, a step "
            f"{[round(r[dt]['step_ms'], 2) for r in ranks]}; "
            f"max_memory_allocated a rank "
            f"{[r[dt]['peak'] for r in ranks]} (blocks "
            f"{r0['block_bytes']:,}, cache block {r0['cache_bytes']:,}) "
            f"[{card}]")
    if "whole_leaf" in ranks[0]:
        wl = [r["whole_leaf"] for r in ranks]
        tp = [r["bfloat16"]["peak"] for r in ranks]
        log(f"  {name} bfloat16, the same passes over whole leaves on the "
            f"mesh: max_memory_allocated a rank {[w['peak'] for w in wl]} "
            f"against the blocks' {tp} (ratio "
            f"{max(tp) / max(w['peak'] for w in wl):.3f}); ms prefill "
            f"{[round(w['prefill_ms'], 1) for w in wl]}, a step "
            f"{[round(w['step_ms'], 2) for w in wl]}; collectives prefill "
            f"{wl[0]['prefill']['calls']}, steps {wl[0]['decode']['calls']}")
    return launches


def mm_rank_1x4(mesh, ds_cfg) -> dict:
    return {"moe": mm_rank_moe(mesh, ds_cfg, MM_DS_TOKENS),
            "tp": tp_rank(mesh, "granite-20b")}


def mm_rank_2x4(mesh, qwen_cfg) -> dict:
    return {"qwen": mm_rank_moe(mesh, qwen_cfg, MM_QWEN_B * MM_QWEN_S),
            "gqa": mm_rank_decode(mesh, "gqa", ("float32", "bfloat16")),
            "tp": tp_rank(mesh, "granite-3-8b")}


def mm_rank_2x2(mesh) -> dict:
    return {"mla": mm_rank_decode(mesh, "mla", ("bfloat16",)),
            "tp": tp_rank(mesh, "deepseek-v3"),
            "train": mm_rank_train(mesh, MM_TRAIN_STEPS)}


def phase_mesh_models(card: str) -> dict:
    """Phase 11b: the model-parallel mesh on gloo ranks sharing the card,
    each piece against the one-device path on the card. Returns the GQA
    split decode's flash launches (every rank's) for the kernel record,
    and the tensor-parallel serving's at the prefill and the steps."""
    t_phase = time.perf_counter()
    shutil.rmtree(MM_CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    def run(shape, fn, *args):
        t0 = time.perf_counter()
        out = spawn(shape, fn, *args, device=DEV.type, timeout=MM_TIMEOUT,
                    join_timeout=MM_JOIN)
        log(f"  {shape[0]} x {shape[1]} mesh ({fn.__name__}): "
            f"{time.perf_counter() - t0:.1f} s from spawn to the last "
            f"rank's exit")
        return out

    # deepseek-v3's MoE layer, EP on 1 x 4, beside granite-20b's
    # tensor-parallel serving (MQA: its one KV head over 4 model ranks)
    ds = dataclasses.replace(deepseek_v3_671b.full(), dtype="bfloat16")
    ds, ds_ref = mm_moe_reference(ds, MM_DS_TOKENS, (1,))
    tp_ref = tp_reference("granite-20b")
    ranks = run((1, 4), mm_rank_1x4, ds)
    mm_check_moe(f"deepseek-v3 MoE layer, {ds.n_experts} experts x "
                 f"({ds.d_model}, {ds.moe_d_ff}), {MM_DS_TOKENS:,} tokens, "
                 f"1 x 4", [r["moe"] for r in ranks], ds_ref[1], card)
    tp = [tp_check("granite-20b", [r["tp"] for r in ranks], tp_ref, card)]
    # qwen2-moe's layer: EP with the ZeRO re-gather on 2 x 4 (beside the
    # GQA split decode and granite-3-8b's tensor-parallel serving),
    # expert-TP on 1 x 8
    qw = dataclasses.replace(qwen2_moe_a2_7b.full(), dtype="bfloat16")
    n_qw = MM_QWEN_B * MM_QWEN_S
    qw, qw_ref = mm_moe_reference(qw, n_qw, (2, 1))
    gqa_ref = mm_decode_reference("gqa", ("float32", "bfloat16"))
    tp_ref = tp_reference("granite-3-8b")
    ranks = run((2, 4), mm_rank_2x4, qw)
    mm_check_moe(f"qwen2-moe MoE layer, {n_qw:,} tokens, 2 x 4",
                 [r["qwen"] for r in ranks], qw_ref[2], card)
    gqa = mm_check_decode(f"GQA split decode, granite-3-8b widths, "
                          f"{MM_DECODE_LAYERS} layers, 2 x 4",
                          [r["gqa"] for r in ranks], gqa_ref,
                          ("float32", "bfloat16"), card)
    tp.append(tp_check("granite-3-8b", [r["tp"] for r in ranks], tp_ref,
                       card))
    del ranks
    mm_check_moe(f"qwen2-moe MoE layer, {n_qw:,} tokens, 1 x 8",
                 run((1, 8), mm_rank_moe, qw, n_qw), qw_ref[1], card)
    # MLA split decode and the Trainer on 2 x 2, the Trainer resumed on
    # 4 x 1
    mla_ref = mm_decode_reference("mla", ("bfloat16",))
    tp_ref = tp_reference("deepseek-v3")
    one = Trainer(mm_train_task()).run(steps=MM_TRAIN_STEPS + 1)["log"]
    torch.cuda.empty_cache()
    ranks = run((2, 2), mm_rank_2x2)
    mm_check_decode(f"MLA split decode, deepseek-v3 widths, "
                    f"{MM_DECODE_LAYERS} dense layers, 2 x 2",
                    [r["mla"] for r in ranks], mla_ref, ("bfloat16",), card)
    tp_check("deepseek-v3", [r["tp"] for r in ranks], tp_ref, card)
    g = ranks[0]["mla"]["timed"]["bytes"].get("all_gather", 0)
    log(f"  MLA wkv_b gathered a step a rank: {g:,} bytes "
        f"({MM_DECODE_LAYERS} layers, with the logits' gather)")
    resumed = run((4, 1), mm_rank_train, MM_TRAIN_STEPS + 1)
    train = [r["train"] for r in ranks]
    for label, logs, want in (("2 x 2", [t["log"] for t in train],
                               one[:MM_TRAIN_STEPS]),
                              ("4 x 1, resumed", [r["log"] for r in resumed],
                               one[MM_TRAIN_STEPS:])):
        for lg in logs:
            if [x["step"] for x in lg] != [x["step"] for x in want]:
                raise AssertionError(f"mesh Trainer {label}: steps "
                                     f"{[x['step'] for x in lg]}")
            gap = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                      for a, b in zip(lg, want))
            if gap > MM_TRAIN_RTOL:
                raise AssertionError(f"mesh Trainer {label}: loss gap {gap}")
        rs = train if label == "2 x 2" else resumed
        log(f"  mesh Trainer {label} (FSDP step): losses "
            f"{[round(x['loss'], 6) for x in logs[0]]} against one "
            f"device's {[round(x['loss'], 6) for x in want]} (max relative "
            f"gap {max(abs(a['loss'] - b['loss']) / abs(b['loss']) for lg in logs for a, b in zip(lg, want)):.3g}, within {MM_TRAIN_RTOL}); ms a "
            f"step {[round(x['dt'] * 1e3, 1) for x in logs[0]]}; "
            f"max_memory_allocated a rank over the run "
            f"{[t['peak'] for t in rs]} bytes (the whole-leaf route's on "
            f"2 x 2: {MM_TRAIN_WHOLE_LEAF_PEAK:,}), over the steps alone "
            f"{[t['step_peak'] for t in rs]}; collectives a rank over the "
            f"steps {[t['calls'] for t in rs]} [{card}]")
    log(f"  one-device Trainer: ms a step "
        f"{[round(x['dt'] * 1e3, 1) for x in one]}")
    shutil.rmtree(MM_CKPT_DIR, ignore_errors=True)
    log(f"  phase 11b: {time.perf_counter() - t_phase:.1f} s")
    return dict(gqa, tp_prefill=sum(t["prefill"] for t in tp),
                tp_decode=sum(t["decode"] for t in tp))


# ---------------------------------------------------------------------------
# phase 12: the minibatch_lg batch on the card; the dry run on meta
# ---------------------------------------------------------------------------

# minibatch_lg: GCN trains a few steps; Equiformer-v2's depth is the most
# of its 12 layers whose forward the dry run predicts under MB_PEAK_LIMIT
MB_TRAIN_STEPS = 3
MB_PEAK_LIMIT = 70e9
MB_REPS = 3
# the batch's numpy build (about 90 s of one host core) runs in a process
# of its own from phase 9 on, while the card serves the LMs, into this file
MB_NPZ = Path(__file__).resolve().parent / "build" / "minibatch_lg.npz"
# the dry run: every cell on 16 x 16 while the phase's seconds last (the
# whole sweep is the CLI's, `--all --both-meshes`), one
# shape an architecture first (the cheapest: serving shapes, molecule);
# one cell a family on 2 x 16 x 16, and one LM train cell there (the mesh
# Trainer step with ZeRO, remat and accumulation), started first as the
# longest; the engine rows on 16 x 16. The meta runs are the host's work:
# one process a core, one cell a process
DRYRUN_BUDGET_S = 60.0
DRYRUN_WORKERS = os.cpu_count() or 1
DRYRUN_FIRST = {"granite-3-8b": "decode_32k", "granite-20b": "decode_32k",
                "nemotron-4-15b": "decode_32k",
                "qwen2-moe-a2.7b": "decode_32k",
                "deepseek-v3-671b": "decode_32k", "equiformer-v2": "molecule",
                "nequip": "molecule", "egnn": "molecule",
                "gcn-cora": "minibatch_lg", "xdeepfm": "serve_p99"}
DRYRUN_MULTIPOD = (("granite-3-8b", "decode_32k"), ("egnn", "molecule"),
                   ("gcn-cora", "minibatch_lg"), ("xdeepfm", "serve_p99"))
DRYRUN_TRAIN = ("granite-3-8b", "train_4k")
DRYRUN_OUT = Path(__file__).resolve().parent / "build" / "dryrun.jsonl"
# the dry run against the card on a 1 x 1 mesh: FLOPs equal, the peak
# within PEAK_GAP of max_memory_allocated less what the step found held
CARD_CELLS = (("gcn-cora", "minibatch_lg"), ("gcn-cora", "molecule"),
              ("xdeepfm", "serve_p99"))
PEAK_GAP = 0.10
# and one reduced FSDP train cell on 2 x 2 gloo ranks sharing the card:
# granite-3-8b's widths at 2 layers in bfloat16, accum 2, 8 sequences of
# 1,024 (2 a data rank a micro-batch)
FSDP_CELL = dict(layers=2, seq=1024, batch=8, accum=2)
# and two tensor-parallel serving cells on 2 x 2 gloo ranks sharing the
# card, granite-3-8b's widths at 2 layers in bfloat16: a prefill of 4 x
# 2,048 (2 sequences a data rank) and a decode step of 4 sequences over
# 8,192 slots, each rank's lm_rules blocks and its block of the tokens
TP_CELLS = {"prefill_32k": dict(seq=2048, batch=4),
            "decode_32k": dict(seq=8192, batch=4)}


# and GNN train cells at full width on the molecule batch, 2 x 2 gloo ranks
# sharing the card, each rank on its node and edge block
# (`graph_batch_specs`): the loss and every leaf's gradient as AdamW takes
# it within GNN_MESH_RTOL (relative L2) of one device's over the whole
# batch; the peak a rank beside the whole-graph mesh route's (expected at
# most GNN_MESH_PEAK_SHARE of it, recorded either way)
GNN_MESH = (2, 2)
GNN_MESH_ARCHS = {"equiformer-v2": (EquiformerV2, eq_mod),
                  "egnn": (EGNN, egnn_mod)}
GNN_MESH_RTOL = 1e-4
GNN_MESH_PEAK_SHARE = 0.6
GNN_MESH_REF = Path(__file__).resolve().parent / "build" / "gnn_mesh_ref.pt"


def meta_batch(g):
    """A meta GraphBatch of ``g``'s shapes and dtypes."""
    return dataclasses.replace(g, **{
        f.name: torch.empty(getattr(g, f.name).shape,
                            dtype=getattr(g, f.name).dtype, device="meta")
        for f in dataclasses.fields(g)
        if isinstance(getattr(g, f.name), torch.Tensor)})


def predicted_forward_peak(cls, cfg, g) -> int:
    """The dry run's live-bytes peak of one inference forward of ``cls``
    at ``cfg`` on ``g``'s shapes: the weights, the batch and the temps."""
    model = cls.random(cfg, meta_generator(0))
    gm = meta_batch(g)

    def fwd(m, b):
        with torch.inference_mode():
            return m(b)
    return dryrun.account(fwd, (model, gm))["peak_bytes_per_device"]


def build_graph(shape: str, path: str) -> None:
    """``shape``'s batch built on the host (make_graph_batch on the CPU:
    the same numpy draws as on the card), written to ``path`` with its
    build seconds."""
    t0 = time.perf_counter()
    g = make_graph_batch(shape, **gcn_cora.SHAPE_DIMS[shape], seed=0,
                         device="cpu")
    arrays = {f.name: getattr(g, f.name).numpy()
              for f in dataclasses.fields(g)
              if isinstance(getattr(g, f.name), torch.Tensor)}
    np.savez(path + ".tmp.npz", n_graphs=g.n_graphs,
             build_s=time.perf_counter() - t0, **arrays)
    os.replace(path + ".tmp.npz", path)


def start_graph_build(shape: str, path: Path):
    """Start `build_graph` in a process of its own (a daemon: it ends with
    this one)."""
    import multiprocessing
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    proc = multiprocessing.get_context("spawn").Process(
        target=build_graph, args=(shape, str(path)), daemon=True)
    proc.start()
    return proc, path


def load_graph(build):
    """Wait for a `start_graph_build` process; the batch on the card, its
    build seconds and the seconds waited."""
    proc, path = build
    t0 = time.perf_counter()
    proc.join()
    if proc.exitcode != 0:
        raise AssertionError(f"the graph build exited with {proc.exitcode}")
    waited = time.perf_counter() - t0
    with np.load(path) as z:
        g = GraphBatch(**{k: dev(z[k]) for k in z.files
                          if k not in ("n_graphs", "build_s")},
                       n_graphs=int(z["n_graphs"]))
        build_s = float(z["build_s"])
    path.unlink()
    return g, build_s, waited


def phase_minibatch(card: str, build) -> dict:
    """minibatch_lg at full size: the neighbour sampler's batch over the
    232,965-node, 114,615,892-edge graph (built by ``build``, a
    `start_graph_build` process); the four GNNs' forwards through
    segment_spmm against the plain path (Equiformer-v2 at the depth the dry
    run predicts under MB_PEAK_LIMIT); GCN trained; segment_spmm's record at
    GCN layer 2's shape. Returns launches and the record."""
    g, build_s, waited = load_graph(build)
    n, e = g.node_mask.shape[0], g.receivers.shape[0]
    n_live, e_live = int(g.node_mask.sum()), int(g.edge_mask.sum())
    nbytes = sum(getattr(g, f.name).nbytes for f in dataclasses.fields(g)
                 if isinstance(getattr(g, f.name), torch.Tensor))
    log(f"  minibatch_lg built in {build_s:.1f} s (numpy on the host, in a "
        f"process of its own since phase 9; this phase waited "
        f"{waited:.1f} s for it: the synthetic 232,965-node, 114,615,892-"
        f"edge graph, its CSR, the sampler's 1,024 seeds at fan-outs 15, "
        f"10): {n_live:,} nodes of "
        f"{n:,} padded, {e_live:,} edges of {e:,} padded; {nbytes:,} bytes "
        f"on the card, node features {g.node_feat.nbytes:,}; the cell's "
        f"analytic pad {dry_cells.gnn_full_shapes('minibatch_lg')}")
    launched = {}
    full_eq = eq_configs.full()
    eq_cfg, eq_pred = full_eq, None
    for layers in range(full_eq.n_layers, 0, -1):
        eq_cfg = dataclasses.replace(full_eq, n_layers=layers)
        eq_pred = predicted_forward_peak(EquiformerV2, eq_cfg, g)
        if eq_pred <= MB_PEAK_LIMIT:
            break
    log(f"  equiformer_v2 on minibatch_lg: the dry run predicts a forward "
        f"peak of {eq_pred:,} bytes at {eq_cfg.n_layers} of "
        f"{full_eq.n_layers} layers (limit {MB_PEAK_LIMIT:.0f})")
    for name, cls, cfg in (("gcn", GCN, gcn_cora.full("minibatch_lg")),
                           ("egnn", EGNN, egnn_configs.full()),
                           ("nequip", NequIP, nequip_configs.full()),
                           ("equiformer_v2", EquiformerV2, eq_cfg)):
        model = cls.random(cfg, torch.Generator(device=DEV).manual_seed(0))
        want = GNN_LAUNCHES[name] if name != "equiformer_v2" \
            else cfg.n_layers
        launched[name] = gnn_check(
            name, model, g, launches=want,
            reps=1 if name == "equiformer_v2" else MB_REPS,
            warm=1 if name == "equiformer_v2" else 3, profile=False)
        del model
        torch.cuda.empty_cache()
    cfg = gcn_cora.full("minibatch_lg")
    model = GCN.random(cfg, torch.Generator(device=DEV).manual_seed(0))
    err = gnn_grad_check("gcn", model, gcn_mod.loss_fn, g)
    del model

    def batches():
        while True:
            yield g
    task = TrainTask(name="gcn", init_params=lambda gen: GCN.random(cfg, gen),
                     loss_fn=gcn_mod.loss_fn, batches=batches(), lr=1e-3,
                     warmup=10, total_steps=MB_TRAIN_STEPS, device=DEV)
    reset_counts()
    _, res, peak = train_run(task, MB_TRAIN_STEPS)
    n_train = counts()["segment_spmm"]
    if n_train != GNN_LAUNCHES["gcn"] * MB_TRAIN_STEPS:
        raise AssertionError(f"gcn on minibatch_lg: {MB_TRAIN_STEPS} steps "
                             f"launched segment_spmm {n_train} times")
    losses = [r["loss"] for r in res["log"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"gcn on minibatch_lg: losses {losses}")
    log(f"  gcn training on minibatch_lg: {step_ms(res['log']):.3f} ms a "
        f"step (median of {MB_TRAIN_STEPS - 1}), segment_spmm "
        f"{n_train // MB_TRAIN_STEPS} launches a step, losses "
        f"{[f'{x:.7g}' for x in losses]}, max_memory_allocated {peak:,} "
        f"bytes; one step's gradients with the kernel against "
        f"use_kernel=False: worst max |diff| {err:.3g} of the leaf's max "
        f"|plain| (<= {GRAD_SHARE['gcn']}) [{card}]")
    del res
    torch.cuda.empty_cache()
    rec = spmm_record("minibatch_lg", cfg.n_classes, g)
    rec["launches"] = launched["gcn"] + n_train
    return {"launched": launched, "train": n_train, "record": rec,
            "graph": g, "build_s": build_s}


def dry_summary(rec: dict) -> str:
    if "error" in rec:
        return f"{rec['arch']}/{rec['shape']} {rec['mesh']}: ERROR"
    c = rec["collectives"]["per_kind_bytes"]
    ratio = rec["flops"] / rec["model_flops"] if rec["model_flops"] else 0
    return (f"{rec['arch']}/{rec['shape']} {rec['mesh']}: fits "
            f"{rec['fits']}, peak {rec['peak_bytes_per_device'] / 1e9:.3f} "
            f"GB, flops/model_flops {ratio:.4f}, collectives "
            f"{ {k: int(v) for k, v in c.items() if v} } "
            f"({rec['trace_s']:.1f} s)")


def _one_thread() -> None:
    torch.set_num_threads(1)


def phase_dryrun() -> dict:
    """The dry run on the meta device: `run_cell` on the 16 x 16 mesh, one
    shape an architecture, one cell a family on 2 x 16 x 16 and
    DRYRUN_TRAIN on 2 x 16 x 16 first, then
    the other cells while the budget lasts, in DRYRUN_WORKERS processes
    (the ones still running at the deadline are stopped); the engine rows
    beside them. Every record free of errors, each written to
    build/dryrun.jsonl."""
    import multiprocessing
    t0 = time.perf_counter()
    DRYRUN_OUT.parent.mkdir(parents=True, exist_ok=True)
    DRYRUN_OUT.write_text("")
    from repro_torch.configs import all_cells
    first = [(a, s) for a, s in DRYRUN_FIRST.items()]
    rest = [c for c in all_cells() if c not in first]
    must = [(*DRYRUN_TRAIN, True)] + [(a, s, False) for a, s in first] \
        + [(a, s, True) for a, s in DRYRUN_MULTIPOD]
    todo = must + [(a, s, False) for a, s in rest]
    records, skipped = [], []

    def emit(rec):
        records.append(rec)
        with open(DRYRUN_OUT, "a") as f:
            f.write(json.dumps(rec) + "\n")
        log("  " + dry_summary(rec))

    pool = multiprocessing.get_context("spawn").Pool(
        DRYRUN_WORKERS, initializer=_one_thread)
    try:
        engine = pool.apply_async(dryrun.run_engine_rows)
        jobs = [pool.apply_async(dryrun.run_cell, (a, s), {"multi_pod": mp})
                for a, s, mp in todo]
        for i, ((arch, shape, mp), job) in enumerate(zip(todo, jobs)):
            left = t0 + DRYRUN_BUDGET_S - time.perf_counter()
            try:
                emit(job.get(None if i < len(must) else max(left, 0.01)))
            except multiprocessing.TimeoutError:
                skipped.append(f"{arch}/{shape}")
            except Exception as exc:
                emit({"arch": arch, "shape": shape,
                      "mesh": "2x16x16" if mp else "16x16",
                      "error": f"{type(exc).__name__}: {exc}"})
        t_eng = time.perf_counter()
        rows = engine.get()
    finally:
        pool.terminate()
        pool.join()
    for r in rows:
        with open(DRYRUN_OUT, "a") as f:
            f.write(json.dumps(r) + "\n")
    by = {}
    for r in rows:
        m = r["arch"].rsplit("-", 1)[1]
        by[m] = by.get(m, 0) + r["collectives"]["per_kind_bytes"][
            "all-gather"]
    log(f"  engine rows (LUBM(1) scale 0.5, 16 shards on the 'model' axis, "
        f"{len(rows)} rows, {time.perf_counter() - t_eng:.1f} s past the "
        f"cells): gathered "
        f"bytes a rank over the 14 templates, wawpart {by.get('wawpart'):,} "
        f"against random {by.get('random'):,}")
    bad = [r for r in records if "error" in r]
    if bad:
        raise AssertionError(f"dry run: error records {bad}")
    if len(rows) != 2 * len(lubm_queries()):
        raise AssertionError(f"dry run: {len(rows)} engine rows")
    log(f"  dry run: {len(records)} records in {DRYRUN_WORKERS} processes "
        f"(past the {DRYRUN_BUDGET_S:.0f} s budget, not run here: "
        f"{skipped}), written to {DRYRUN_OUT.relative_to(DRYRUN_OUT.parents[1])}"
        f" ({time.perf_counter() - t0:.1f} s)")
    return {"records": records, "skipped": skipped, "engine": by}


def card_cell(arch: str, shape: str, graph=None) -> dict:
    """One cell's step on a 1 x 1 mesh: the dry run on meta, then the same
    step for real on the card (once to warm the allocator and cuBLAS, then
    counted). FLOPs must be equal, each kernel's meta calls its launches,
    and the meta peak within PEAK_GAP of max_memory_allocated less the
    bytes held before the step."""
    meta_cell = dry_cells.build_cell(arch, shape,
                                     MetaMesh((1, 1), ("data", "model")))
    meta = dryrun.account(meta_cell.fn, meta_cell.args)
    real_cell = dry_cells.build_cell(
        arch, shape, make_device_mesh((1, 1), ("data", "model"),
                                      device=DEV))
    args = real_cell.make_args(DEV, batch=graph) if graph is not None \
        else real_cell.make_args(DEV)
    real_cell.fn(*args)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.reset_peak_memory_stats(DEV)
    before = torch.cuda.memory_allocated(DEV)
    real = dryrun.account(real_cell.fn, args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(DEV) - before
    launched = {k: v for k, v in counts().items() if v}
    gap = meta["temp_size_bytes"] / peak - 1 if peak else float("inf")
    line = (f"{arch}/{shape} on 1 x 1: FLOPs meta {meta['dispatch_flops']:,}"
            f" card {real['dispatch_flops']:,}; kernel calls meta "
            f"{meta['kernel_calls']} launches {launched}; peak above the "
            f"held bytes: meta {meta['temp_size_bytes']:,} card "
            f"{peak:,} (gap {gap:+.4f}); whole: meta "
            f"{meta['peak_bytes_per_device']:,} card "
            f"{torch.cuda.max_memory_allocated(DEV):,}")
    log("  " + line)
    if meta["dispatch_flops"] != real["dispatch_flops"]:
        raise AssertionError(f"dry run FLOPs differ from the card's: {line}")
    if meta["kernel_calls"] != launched:
        raise AssertionError(f"dry run kernel calls differ: {line}")
    if not abs(gap) <= PEAK_GAP:
        raise AssertionError(f"dry run peak off by more than "
                             f"{PEAK_GAP:.0%}: {line}")
    del args, real_cell
    torch.cuda.empty_cache()
    return {"flops": meta["dispatch_flops"], "gap": gap,
            "meta_peak": meta["temp_size_bytes"], "card_peak": peak,
            "launches": launched}


def fsdp_cell(mesh):
    """FSDP_CELL's train cell on ``mesh`` (a rank's step: the Trainer's
    FSDP step over the rank's blocks)."""
    cfg = dataclasses.replace(granite_3_8b.full(),
                              n_layers=FSDP_CELL["layers"])
    return dry_cells.build_lm_cell(
        "granite-3-8b", "train_4k", mesh, cfg=cfg,
        shape_def=dict(seq=FSDP_CELL["seq"], batch=FSDP_CELL["batch"]),
        knobs=dict(accum=FSDP_CELL["accum"], fsdp=True, moments="float32"))


def fsdp_cell_rank(mesh) -> dict:
    """One rank of the FSDP cell: its meta run on a `MetaMesh` rank of the
    same coordinates, then the step for real on the card (cuBLAS warmed
    by a small product first), counted."""
    meta_mesh = MetaMesh(mesh.sizes, mesh.axis_names, rank=mesh.rank)
    cell = fsdp_cell(meta_mesh)
    meta_mesh.reset_counts()
    meta = dryrun.account(cell.fn, cell.args)
    meta_calls = dict(meta_mesh.calls)
    cell = fsdp_cell(mesh)
    args = cell.make_args(DEV)
    w = torch.ones(64, 64, dtype=torch.bfloat16, device=DEV,
                   requires_grad=True)
    (w @ w).sum().backward()
    del w
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(DEV)
    before = torch.cuda.memory_allocated(DEV)
    mesh.reset_counts()
    real = dryrun.account(cell.fn, args)
    torch.cuda.synchronize()
    return dict(meta_temp=meta["temp_size_bytes"],
                meta_peak=meta["peak_bytes_per_device"],
                card_temp=torch.cuda.max_memory_allocated(DEV) - before,
                card_peak=torch.cuda.max_memory_allocated(DEV),
                flops_meta=meta["dispatch_flops"],
                flops_card=real["dispatch_flops"],
                calls=dict(mesh.calls), meta_calls=meta_calls)


def fsdp_card_cell(card: str) -> dict:
    """12c's FSDP cell: each rank's meta peak above its held bytes within
    PEAK_GAP of its max_memory_allocated above them, FLOPs and collectives
    equal."""
    t0 = time.perf_counter()
    ranks = spawn((2, 2), fsdp_cell_rank, device=DEV.type, timeout=MM_TIMEOUT,
                  join_timeout=MM_JOIN)
    gaps = []
    for r, x in enumerate(ranks):
        gap = x["meta_temp"] / x["card_temp"] - 1
        gaps.append(gap)
        line = (f"granite-3-8b widths, {FSDP_CELL['layers']} layers, FSDP "
                f"train cell, rank {r} of 2 x 2: FLOPs meta "
                f"{x['flops_meta']:,} card {x['flops_card']:,}; peak above "
                f"the held bytes: meta {x['meta_temp']:,} card "
                f"{x['card_temp']:,} (gap {gap:+.4f}); whole: meta "
                f"{x['meta_peak']:,} card {x['card_peak']:,}; collectives "
                f"{x['calls']}")
        log("  " + line)
        if x["flops_meta"] != x["flops_card"]:
            raise AssertionError(f"FSDP cell FLOPs differ: {line}")
        if x["calls"] != x["meta_calls"]:
            raise AssertionError(f"FSDP cell collectives differ from the "
                                 f"MetaMesh's {x['meta_calls']}: {line}")
        if not abs(gap) <= PEAK_GAP:
            raise AssertionError(f"FSDP cell peak off by more than "
                                 f"{PEAK_GAP:.0%}: {line}")
    log(f"  FSDP cell on 2 x 2: {time.perf_counter() - t0:.1f} s from spawn "
        f"to the last rank's exit [{card}]")
    return {"gap": max(gaps, key=abs), "ranks": ranks}


def tp_cell(mesh, shape: str):
    """TP_CELLS' serving cell ``shape`` on ``mesh`` (a rank's step: the
    tensor-parallel prefill or decode over the rank's blocks)."""
    cfg = dataclasses.replace(granite_3_8b.full(),
                              n_layers=FSDP_CELL["layers"])
    return dry_cells.build_lm_cell("granite-3-8b", shape, mesh, cfg=cfg,
                                   shape_def=TP_CELLS[shape])


def tp_cell_rank(mesh) -> dict:
    """Each tensor-parallel cell on this rank: its meta run on a
    `MetaMesh` rank of the same coordinates, then the step for real on the
    card (once to warm cuBLAS and the allocator, then counted)."""
    out = {}
    for shape in TP_CELLS:
        meta_mesh = MetaMesh(mesh.sizes, mesh.axis_names, rank=mesh.rank)
        cell = tp_cell(meta_mesh, shape)
        meta_mesh.reset_counts()
        meta = dryrun.account(cell.fn, cell.args)
        meta_calls = dict(meta_mesh.calls)
        cell = tp_cell(mesh, shape)
        args = cell.make_args(DEV)
        cell.fn(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(DEV)
        reset_counts()
        before = torch.cuda.memory_allocated(DEV)
        mesh.reset_counts()
        real = dryrun.account(cell.fn, args)
        torch.cuda.synchronize()
        out[shape] = dict(
            meta_temp=meta["temp_size_bytes"],
            meta_peak=meta["peak_bytes_per_device"],
            card_temp=torch.cuda.max_memory_allocated(DEV) - before,
            card_peak=torch.cuda.max_memory_allocated(DEV),
            flops_meta=meta["dispatch_flops"],
            flops_card=real["dispatch_flops"], calls=dict(mesh.calls),
            meta_calls=meta_calls, kernel_calls=meta["kernel_calls"],
            launched={k: v for k, v in counts().items() if v})
        del args, cell
        torch.cuda.empty_cache()
    return out


def tp_card_cells(card: str) -> dict:
    """12c's tensor-parallel cells: each rank's meta peak above its held
    bytes within PEAK_GAP of its max_memory_allocated above them, FLOPs,
    collectives and flash launches equal."""
    t0 = time.perf_counter()
    ranks = spawn((2, 2), tp_cell_rank, device=DEV.type, timeout=MM_TIMEOUT,
                  join_timeout=MM_JOIN)
    out = {}
    for shape in TP_CELLS:
        gaps = []
        for r, ranked in enumerate(ranks):
            x = ranked[shape]
            gap = x["meta_temp"] / x["card_temp"] - 1
            gaps.append(gap)
            line = (f"granite-3-8b widths, {FSDP_CELL['layers']} layers, "
                    f"tensor-parallel {shape} cell {TP_CELLS[shape]}, rank "
                    f"{r} of 2 x 2: FLOPs meta {x['flops_meta']:,} card "
                    f"{x['flops_card']:,}; kernel calls meta "
                    f"{x['kernel_calls']} launches {x['launched']}; peak "
                    f"above the held bytes: meta {x['meta_temp']:,} card "
                    f"{x['card_temp']:,} (gap {gap:+.4f}); whole: meta "
                    f"{x['meta_peak']:,} card {x['card_peak']:,}; "
                    f"collectives {x['calls']}")
            log("  " + line)
            if x["flops_meta"] != x["flops_card"]:
                raise AssertionError(f"tensor-parallel cell FLOPs differ: "
                                     f"{line}")
            if x["calls"] != x["meta_calls"]:
                raise AssertionError(f"tensor-parallel cell collectives "
                                     f"differ from the MetaMesh's "
                                     f"{x['meta_calls']}: {line}")
            if x["kernel_calls"] != x["launched"]:
                raise AssertionError(f"tensor-parallel cell kernel calls "
                                     f"differ: {line}")
            if not abs(gap) <= PEAK_GAP:
                raise AssertionError(f"tensor-parallel cell peak off by "
                                     f"more than {PEAK_GAP:.0%}: {line}")
        out[f"granite-3-8b/{shape}[tp 2x2]"] = {
            "gap": max(gaps, key=abs), "ranks": [r[shape] for r in ranks]}
    log(f"  tensor-parallel cells on 2 x 2: {time.perf_counter() - t0:.1f} "
        f"s from spawn to the last rank's exit [{card}]")
    return out


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in float64 (the difference's norm where
    want is 0)."""
    diff = torch.linalg.vector_norm((got - want).double()).item()
    top = torch.linalg.vector_norm(want.double()).item()
    return diff / top if top else diff


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic kernels where it has them: `index_add_` on
    the card sums each row in index order instead of by atomics (the
    degrees, the edge softmax's denominators, the pooling, the gathers'
    backward). Its warnings for ops that have none are silenced."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def shuffled_edges(g):
    """``g`` with its edges in a fixed random order. The molecule batch
    stores them molecule by molecule, which on GNN_MESH leaves ranks
    (0, 1) and (1, 0) no live edge; shuffled, every rank holds some, so
    both sides of each sum over "model" are non-zero."""
    perm = torch.randperm(g.senders.shape[0],
                          generator=torch.Generator().manual_seed(0))
    perm = perm.to(g.device)
    return dataclasses.replace(g, senders=g.senders[perm],
                               receivers=g.receivers[perm],
                               edge_mask=g.edge_mask[perm])


def gnn_mesh_reference() -> None:
    """One device's loss and gradients for each GNN_MESH_ARCHS cell: the
    cell's weights (seed 0) through the model's loss_fn over the whole
    molecule batch, under `deterministic`, written to GNN_MESH_REF for the
    ranks (which take their gradients so too). Each side is then one
    reproducible sum order: Equiformer-v2's attention scores go through a
    leaky_relu, and where a pre-activation lies within rounding of its
    kink the order of PyTorch's atomic sums decides which slope the
    backward takes."""
    g = dry_cells.real_graph_batch("molecule", DEV)
    out = {}
    for arch, (cls, mod) in GNN_MESH_ARCHS.items():
        model = cls.random(dry_cells.gnn_config(arch, "molecule"),
                           torch.Generator(device=DEV).manual_seed(0))
        leaves = dict(leaves_with_path(model.param_tree()))
        for t in leaves.values():
            t.requires_grad_(True)
        with deterministic():
            loss, _ = mod.loss_fn(model, g)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        out[arch] = {"loss": float(loss.detach()), "grads": {
            p: (torch.zeros_like(t) if gr is None else gr).cpu()
            for (p, t), gr in zip(leaves.items(), grads)}}
        del model, leaves, loss, grads
    GNN_MESH_REF.parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, GNN_MESH_REF)
    torch.cuda.empty_cache()


def gnn_mesh_rank(mesh) -> dict:
    """Each GNN_MESH_ARCHS cell on this rank: its meta run on a `MetaMesh`
    rank of the same coordinates; then on the card the gradients the step
    hands AdamW, under `deterministic`, against one device's
    (`gnn_mesh_reference`; this also warms cuBLAS and the allocator), for
    the molecule batch as stored and with `shuffled_edges`; the step run
    counted (FLOPs, collectives, launches, peak), and the same step over
    the whole batch on every rank (the whole-graph mesh route) for its
    peak."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = torch.load(GNN_MESH_REF)
    whole = dry_cells.real_graph_batch("molecule", DEV)
    orders = {"stored": whole, "shuffled": shuffled_edges(whole)}
    out = {}
    for arch in GNN_MESH_ARCHS:
        meta_mesh = MetaMesh(mesh.sizes, mesh.axis_names, rank=mesh.rank)
        cell = dry_cells.build_gnn_cell(arch, "molecule", meta_mesh)
        meta_mesh.reset_counts()
        meta = dryrun.account(cell.fn, cell.args)
        meta_calls = dict(meta_mesh.calls)
        cell = dry_cells.build_gnn_cell(arch, "molecule", mesh)
        want = ref[arch]["grads"]
        rec = dict(loss_ref=ref[arch]["loss"], errs={}, loss={}, live={})
        for order, batch in orders.items():
            view, blocks, _, block = cell.make_args(DEV, batch=batch)
            ef = {"_": torch.zeros((), device=DEV)}
            with deterministic():
                metrics, grads, _ = Trainer(
                    cell.parts["task"], mesh=mesh)._mesh_grads(
                    view, blocks, cell.param_specs, ef, block,
                    batch_is_local=True)
            errs = {p: rel_l2(gr, want[p].to(DEV))
                    for p, gr in leaves_with_path(grads)}
            rec["errs"][order] = errs
            rec["loss"][order] = float(metrics["loss"])
            rec["live"][order] = int(MeshGraph(block, block.edge_mask)
                                     .edge_mask.sum())
            rec.setdefault("missing", sorted(set(want) - set(errs)))
            del view, blocks, block, grads, metrics
        rec["n_leaves"] = len(want)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        args = cell.make_args(DEV, batch=whole)
        view, blocks, opt, block = args
        torch.cuda.reset_peak_memory_stats(DEV)
        reset_counts()
        before = torch.cuda.memory_allocated(DEV)
        mesh.reset_counts()
        t0 = time.perf_counter()
        real = dryrun.account(cell.fn, args)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        block_peak = torch.cuda.max_memory_allocated(DEV)
        rec.update(
            meta_temp=meta["temp_size_bytes"],
            card_temp=block_peak - before, card_peak=block_peak,
            flops_meta=meta["dispatch_flops"],
            flops_card=real["dispatch_flops"], calls=dict(mesh.calls),
            meta_calls=meta_calls, kernel_calls=meta["kernel_calls"],
            launched={k: v for k, v in counts().items() if v},
            step_ms=step_ms,
            block=(tuple(block.senders.shape), tuple(block.node_mask.shape)))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(DEV)
        t0 = time.perf_counter()
        cell.fn(view, blocks, opt, whole)
        torch.cuda.synchronize()
        rec.update(whole_ms=(time.perf_counter() - t0) * 1e3,
                   whole_peak=torch.cuda.max_memory_allocated(DEV))
        out[arch] = rec
        del args, cell, view, blocks, opt, block
        torch.cuda.empty_cache()
    return out


def gnn_mesh_cells(card: str) -> dict:
    """12c's GNN train cells on GNN_MESH: each rank's loss and gradients
    against one device's, its meta FLOPs, collectives and segment_spmm
    calls equal to the card's, its peak above the held bytes within
    PEAK_GAP, and its peak beside the whole-graph mesh route's."""
    t0 = time.perf_counter()
    gnn_mesh_reference()
    ranks = spawn(GNN_MESH, gnn_mesh_rank, device=DEV.type,
                  timeout=MM_TIMEOUT, join_timeout=MM_JOIN)
    out = {}
    for arch in GNN_MESH_ARCHS:
        gaps, shares = [], []
        for r, ranked in enumerate(ranks):
            x = ranked[arch]
            gap = x["meta_temp"] / x["card_temp"] - 1
            share = x["card_peak"] / x["whole_peak"]
            gaps.append(gap)
            shares.append(share)
            loss_err = max(abs(v - x["loss_ref"]) / abs(x["loss_ref"])
                           for v in x["loss"].values())
            grad_err = max(max(e.values()) for e in x["errs"].values())
            for order, errs in x["errs"].items():
                worst = sorted(errs, key=errs.get)[-3:]
                log(f"  {arch} rank {r}, edges {order} ({x['live'][order]:,} "
                    f"live here): loss {x['loss'][order]:.8g} against "
                    f"{x['loss_ref']:.8g}; the worst leaves' relative L2 "
                    f"against one device: " + ", ".join(
                        f"{p} {errs[p]:.3g}" for p in reversed(worst)))
            line = (f"{arch} full config, molecule train cell, rank {r} of "
                    f"{GNN_MESH[0]} x {GNN_MESH[1]} (edges {x['block'][0]}, "
                    f"nodes {x['block'][1]}): loss against one device's "
                    f"{x['loss_ref']:.6g} (rel {loss_err:.3g}); "
                    f"{x['n_leaves']} leaves' gradients, worst relative L2 "
                    f"{grad_err:.3g}; FLOPs meta {x['flops_meta']:,} "
                    f"card {x['flops_card']:,}; kernel calls meta "
                    f"{x['kernel_calls']} launches {x['launched']}; peak "
                    f"above the held bytes: meta {x['meta_temp']:,} card "
                    f"{x['card_temp']:,} (gap {gap:+.4f}); "
                    f"max_memory_allocated {x['card_peak']:,} against the "
                    f"whole-graph mesh route's {x['whole_peak']:,} "
                    f"({share:.4f}); step {x['step_ms']:.1f} ms (whole "
                    f"graph {x['whole_ms']:.1f}); collectives {x['calls']}")
            log("  " + line)
            if x["missing"] or not loss_err <= GNN_MESH_RTOL \
                    or not grad_err <= GNN_MESH_RTOL:
                raise AssertionError(f"GNN mesh cell differs from one "
                                     f"device beyond {GNN_MESH_RTOL}: {line}")
            if not x["live"]["shuffled"]:
                raise AssertionError(f"no live edge on rank {r} with the "
                                     f"edges shuffled: {line}")
            if x["flops_meta"] != x["flops_card"]:
                raise AssertionError(f"GNN mesh cell FLOPs differ: {line}")
            if x["calls"] != x["meta_calls"]:
                raise AssertionError(f"GNN mesh cell collectives differ "
                                     f"from the MetaMesh's "
                                     f"{x['meta_calls']}: {line}")
            if x["kernel_calls"] != x["launched"] \
                    or not x["launched"].get("segment_spmm"):
                raise AssertionError(f"GNN mesh cell kernel calls differ: "
                                     f"{line}")
            if not abs(gap) <= PEAK_GAP:
                raise AssertionError(f"GNN mesh cell peak off by more than "
                                     f"{PEAK_GAP:.0%}: {line}")
        met = max(shares) <= GNN_MESH_PEAK_SHARE
        log(f"  {arch}: max_memory_allocated a rank at most "
            f"{max(shares):.4f} of the whole-graph mesh route's (expected at "
            f"most {GNN_MESH_PEAK_SHARE}: {'met' if met else 'not met'}) "
            f"[{card}]")
        out[f"{arch}/molecule[gnn 2x2]"] = {
            "gap": max(gaps, key=abs), "share": max(shares),
            "launches": sum(x[arch]["launched"].get("segment_spmm", 0)
                            for x in ranks),
            "ranks": [x[arch] for x in ranks]}
    log(f"  GNN cells on {GNN_MESH[0]} x {GNN_MESH[1]}: "
        f"{time.perf_counter() - t0:.1f} s from the reference to the last "
        f"rank's exit [{card}]")
    return out


def phase_dry_card(graph, card: str) -> dict:
    """12c: the dry run against the card for cells that fit one H100, the
    FSDP train cell and the tensor-parallel prefill and decode cells on
    2 x 2 ranks."""
    out = {}
    for arch, shape in CARD_CELLS:
        g = None
        if (arch, shape) == ("gcn-cora", "minibatch_lg"):
            gs = dry_cells.gnn_full_shapes(shape)
            g = dry_cells.pad_graph_batch(graph, gs["n"], gs["e"])
        out[f"{arch}/{shape}"] = card_cell(arch, shape, g)
        del g
    torch.cuda.empty_cache()
    out["granite-3-8b/train_4k[fsdp 2x2]"] = fsdp_card_cell(card)
    out.update(tp_card_cells(card))
    out.update(gnn_mesh_cells(card))
    return out


def main() -> None:
    t_start = time.perf_counter()

    def at() -> str:
        """Seconds since the start, for each phase's header."""
        return f"({time.perf_counter() - t_start:.0f} s)"
    card = card_line()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"[1/13] device: {card}; torch.cuda.get_device_name: "
        f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; total_memory {total:,} bytes")
    if total != dryrun.H100_TOTAL_MEMORY:
        raise AssertionError(f"the card holds {total:,} bytes; the dry run "
                             f"takes {dryrun.H100_TOTAL_MEMORY:,}")
    # the plain versions' float32 products run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    GRAPH_BUILDS["ogb_products"] = start_graph_build("ogb_products",
                                                     OGB_NPZ)
    log(f"[2/13] {at()} build: {kernels.build():.2f} s (nvcc, "
        f"{' '.join(kernels.NVCC_FLAGS)}; {len(kernels.SOURCES)} libraries)")

    log(f"[3/13] {at()} kernels against their plain versions on the card")
    rec = phase_kernels()

    log(f"[4/13] {at()} main path: LUBM(1) scale 1.0, WawPart 3 shards from the "
        f"Jaccard kernel, join sorted, backend cuda, {BATCH} requests per "
        "serve()")
    main_counts, main_path = serve_path(1.0, "sorted", kernel_partition=True)
    for k in ("jaccard_distance", "scan_select", "join_ranges",
              "join_select"):
        if main_counts[k] <= 0:
            raise AssertionError(f"main path never launched {k}")
    # each merge join searches once: join_select where it expands with no
    # second column to verify (no pair mask, no scan_select), join_ranges
    # elsewhere
    if (main_counts["join_ranges"] + main_counts["join_select"]
            != main_counts["merge_joins"]
            or main_counts["join_select"] != main_counts["select_joins"]):
        raise AssertionError(
            f"main path launched join_ranges {main_counts['join_ranges']} "
            f"and join_select {main_counts['join_select']} times for "
            f"{main_counts['merge_joins']} merge joins, "
            f"{main_counts['select_joins']} of them expanding without "
            f"verification")
    log(f"  main path launches: scan_hits {main_counts['scan_hits']}, "
        f"scan_select {main_counts['scan_select']}, join_ranges "
        f"{main_counts['join_ranges']}, join_select "
        f"{main_counts['join_select']} (merge joins "
        f"{main_counts['merge_joins']}, {main_counts['select_joins']} "
        f"expanding without verification)")

    log(f"[4b/13] {at()} pipeline on phase 4's store and partition: submit / pump "
        "/ drain / shutdown, batches retired on CUDA events, migrate()")
    pipe_counts = phase_pipeline(main_path, card)

    log(f"[4c/13] {at()} faults, replication and the adaptive controller on phase "
        "4's store and partition: chaos with and without retry, a "
        "shard-down window, replicate_hot then failover, adaptive "
        "migrations and aborted ones")
    fault_counts = phase_faults(main_path, card)

    log(f"[4d/13] {at()} mesh on phase 4's store: one gloo rank per shard on the "
        "one card; 3 ranks (WawPart and random, both joins; run_sharded; "
        "the mesh-routed server; replicate_hot) and 8 (WawPart)")
    mesh_counts = phase_mesh(main_path, main_counts, card)

    log(f"[5/13] {at()} expand path: LUBM scale 0.1, join expand, backend cuda")
    expand_counts, _ = serve_path(0.1, "expand")
    for k in ("compat_select", "scan_hits", "scan_select"):
        if expand_counts[k] <= 0:
            raise AssertionError(f"expand path never launched {k}")
    if (expand_counts["join_ranges"] or expand_counts["join_select"]
            or expand_counts["compat_matrix"]):
        raise AssertionError("expand path launched join_ranges, "
                             "join_select or compat_matrix")
    # one compat_select per expand join (where the path took the matrix:
    # one compat_matrix each, 11 in all, and a scan_select more for each
    # that expands)
    if (expand_counts["compat_select"] != expand_counts["expand_joins"]
            or expand_counts["compat_select"] != EXPAND_JOINS):
        raise AssertionError(
            f"expand path launched compat_select "
            f"{expand_counts['compat_select']} times for "
            f"{expand_counts['expand_joins']} expand joins (expected "
            f"{EXPAND_JOINS})")
    log(f"  expand path launches: compat_select "
        f"{expand_counts['compat_select']} (expand joins "
        f"{expand_counts['expand_joins']}, {expand_counts['expanding_joins']}"
        f" of them expanding: the scan_select launches they no longer "
        f"make), compat_matrix 0, scan_select {expand_counts['scan_select']},"
        f" scan_hits {expand_counts['scan_hits']}")

    log(f"[6/13] {at()} per-query engine (the paper's execution path): "
        "run_vmapped over every template, backend cuda; LUBM(1) scale 1.0 "
        "under WawPart (expand and sorted joins), random and centralized "
        "(sorted join); BSBM 1,000 products under WawPart (both joins)")
    per_query = phase_per_query(main_path, card)
    pq_launches = per_query["launches"]
    for k in ("scan_select", "compat_select", "join_select"):
        if pq_launches[k] <= 0:
            raise AssertionError(f"per-query engine never launched {k}")
    if pq_launches["compat_matrix"]:
        raise AssertionError("per-query engine launched compat_matrix")
    log(f"  per-query engine launches over its runs: {pq_launches}")

    log(f"[7/13] {at()} clustering: {UNIVERSITIES * DEPARTMENTS * 14:,} LUBM query "
        "instances")
    cluster_counts = phase_clustering()
    if cluster_counts["jaccard_distance"] <= 0:
        raise AssertionError("clustering never launched jaccard_distance")

    log(f"[8/13] {at()} xDeepFM serving forward, full config")
    xdeepfm_counts = phase_xdeepfm()

    mb_build = start_graph_build("minibatch_lg", MB_NPZ)
    log(f"[9/13] {at()} LM serving: granite-3-8b full config, bf16, random weights "
        "from seed 0; float32 checks at full width and 4 layers")
    lm_counts = phase_lm()

    log(f"[9b/13] {at()} LM serving, MoE and MLA: qwen2-moe-a2.7b full "
        "config and deepseek-v3-671b's widths at 4 layers, bf16, random "
        "weights from seed 0; float32 checks")
    moe_counts = phase_lm_moe(card)

    log(f"[10/13] {at()} GNN serving: GCN at the full ogbn-products size; EGNN, "
        "NequIP and Equiformer-v2 full configs on the molecule batch; "
        "random weights from seed 0")
    gnn_counts = phase_gnn()

    log(f"[11/13] {at()} training through the port's Trainer: GCN at ogbn-products "
        "and EGNN, NequIP, Equiformer-v2 on the molecule batch through "
        "segment_spmm; xDeepFM full() (memory probe, resume, card vs CPU, "
        "int8 EF through the CLI); granite-3-8b and qwen2-moe-a2.7b widths "
        "at 2 layers; deepseek-v3-671b widths with the MTP head")
    train = phase_train(card)
    train_gnn = train["gnn"]

    log(f"[11b/13] {at()} mesh models: gloo ranks on the one card; "
        "deepseek-v3's MoE layer expert-parallel on 1 x 4, qwen2-moe's on "
        "2 x 4 (EP, ZeRO re-gather) and 1 x 8 (expert-TP), the GQA split "
        "decode (granite-3-8b widths) on 2 x 4 through flash's lse route, "
        "the MLA split decode (deepseek-v3 widths) and the Trainer "
        "(granite-3-8b widths, lm_rules(fsdp=True)) on 2 x 2, resumed on "
        "4 x 1; tensor-parallel serving from each rank's lm_rules blocks, "
        "a prefill then decode steps from its cache: granite-3-8b widths "
        "on 2 x 4, granite-20b widths (MQA) on 1 x 4, deepseek-v3's MLA "
        "layers (fsdp) on 2 x 2")
    mesh_models = phase_mesh_models(card)

    log(f"[12/13] {at()} minibatch_lg on the card: the neighbour sampler's "
        "batch over 232,965 nodes and 114,615,892 edges; GCN, EGNN, NequIP "
        "and Equiformer-v2 forwards through segment_spmm; GCN trained")
    mb = phase_minibatch(card, mb_build)
    rec["segment_spmm[minibatch_lg]"] = mb["record"]
    log(f"[12b/13] {at()} dry run on the meta device: one rank of the "
        "16 x 16 and 2 x 16 x 16 meshes, no allocation, collectives "
        "counted; the engine rows")
    dry = phase_dryrun()
    log(f"[12c/13] {at()} the dry run against the card on a 1 x 1 mesh: "
        f"{', '.join(f'{a}/{b}' for a, b in CARD_CELLS)}; an FSDP train "
        f"cell and tensor-parallel prefill and decode cells (granite-3-8b "
        f"widths, {FSDP_CELL['layers']} layers) on 2 x 2 gloo ranks; "
        f"{' and '.join(GNN_MESH_ARCHS)} train cells at full width on the "
        f"molecule batch, each rank on its node and edge block, on 2 x 2")
    dry_card = phase_dry_card(mb.pop("graph"), card)

    rec["scan_hits"]["launches"] = expand_counts["scan_hits"]
    rec["scan_select"]["launches"] = main_counts["scan_select"]
    rec["join_ranges"]["launches"] = main_counts["join_ranges"]
    rec["join_select"]["launches"] = main_counts["join_select"]
    rec["compat_select"]["launches"] = expand_counts["compat_select"]
    rec["jaccard_distance"]["launches"] = main_counts["jaccard_distance"]
    rec["gather_rows"]["launches"] = sum(
        c["gather_rows"] for c in xdeepfm_counts.values())
    rec["cin_layer"]["launches"] = xdeepfm_counts["serve_p99"]["cin_layer"]
    rec["cin_layer[serve_bulk]"]["launches"] = \
        xdeepfm_counts["serve_bulk"]["cin_layer"]
    for name, c in lm_counts.items():
        rec[f"flash_attention[{name}]"]["launches"] = c["flash_attention"]
    for name, c in moe_counts.items():
        rec[f"flash_attention[moe_{name}]"]["launches"] = c["flash_attention"]
    rec["flash_attention[decode_lse]"]["launches"] = (
        mesh_models["launches"] + mesh_models["tp_decode"])
    rec["flash_attention[prefill]"]["launches"] += mesh_models["tp_prefill"]
    rec["segment_spmm[ogb_products]"]["launches"] = (
        gnn_counts["gcn"] + train_gnn["gcn"])
    rec["segment_spmm[molecule]"]["launches"] = sum(
        gnn_counts[k] + train_gnn[k]
        for k in ("egnn", "nequip", "equiformer_v2"))
    rec["segment_spmm[molecule_block]"]["launches"] = sum(
        v["launches"] for k, v in dry_card.items() if k.endswith("[gnn 2x2]"))
    paths = {"scan_hits": "LUBM expand path (phase 5)",
             "scan_select": "LUBM main path (phase 4)",
             "join_ranges": "LUBM main path (phase 4)",
             "join_select": "LUBM main path (phase 4)",
             "compat_matrix": "none (op only; the expand path and the "
                              "per-query engine take compat_select, phases "
                              "5 and 6)",
             "compat_select": "LUBM expand path (phase 5)",
             "jaccard_distance": "WawPart partition (phase 4)",
             "gather_rows": "xDeepFM forward (phase 8)",
             "cin_layer": "xDeepFM forward at serve_p99 (phase 8)",
             "cin_layer[serve_bulk]": "xDeepFM forward at serve_bulk (phase 8)",
             "flash_attention[prefill]": "granite-3-8b prefill (phase 9); "
                                         "tensor-parallel prefills over "
                                         "each rank's heads, every rank "
                                         "of granite-3-8b's 2 x 4 and "
                                         "granite-20b's 1 x 4 (phase 11b)",
             "flash_attention[decode]": "granite-3-8b decode (phase 9)",
             "flash_attention[moe_prefill]": "qwen2-moe-a2.7b prefill "
                                             "(phase 9b)",
             "flash_attention[moe_decode]": "qwen2-moe-a2.7b decode "
                                            "(phase 9b)",
             "flash_attention[decode_lse]": "granite-3-8b widths' split-KV "
                                            "decode, every rank of a 2 x 4 "
                                            "mesh; the tensor-parallel "
                                            "serving's steps on 2 x 4 and "
                                            "1 x 4 (phase 11b)",
             "segment_spmm[ogb_products]": "GCN forward (phase 10); GNN "
                                           "training (phase 11)",
             "segment_spmm[molecule]":
                 "EGNN, NequIP, Equiformer-v2 forwards (phase 10); GNN "
                 "training (phase 11)",
             "segment_spmm[minibatch_lg]":
                 "GCN forward and training on minibatch_lg (phase 12)",
             "segment_spmm[molecule_block]":
                 "Equiformer-v2 and EGNN train cells at full width, each "
                 "rank on its node and edge block of the molecule batch, "
                 "2 x 2 gloo ranks (phase 12c)"}
    # the per-query engine's kernels (phase 6), where it launched them; its
    # launches are printed with the phase, the records keep phase 4's and
    # 5's
    for name in ("scan_select", "join_ranges", "join_select"):
        if pipe_counts[name]:
            paths[name] += "; pipeline (phase 4b)"
        if fault_counts[name]:
            paths[name] += "; faults, replication, adaptive (phase 4c)"
    for name in ("scan_select", "join_ranges", "join_select",
                 "compat_select"):
        if mesh_counts.get(name) or name == "compat_select":
            paths[name] += ("; mesh, 3 and 8 gloo ranks on the one card "
                            "(phase 4d)")
        if pq_launches[name]:
            paths[name] += "; per-query engine (phase 6)"
    for name, path in paths.items():
        rec[name]["path"] = path
    log(f"[13/13] {at()} kernels: " + ", ".join(
        f"{r['name']} ok launches={r['launches']}" for r in rec.values())
        + f"; main path launches {main_counts}, pipeline launches "
        f"{pipe_counts}, faults, replication and adaptive launches "
        f"{fault_counts}, mesh launches a rank (WawPart, sorted) "
        f"{mesh_counts}, expand path launches "
        f"{expand_counts}, per-query engine launches {pq_launches}, "
        f"clustering launches {cluster_counts}, xDeepFM "
        f"launches {xdeepfm_counts}, LM launches (prefill of "
        f"{PREFILL_S:,} tokens, {DECODE_STEPS} decode steps) "
        f"{ {k: c['flash_attention'] for k, c in lm_counts.items()} }, "
        f"qwen2-moe-a2.7b flash launches (same shapes, 4 sequences) "
        f"{ {k: c['flash_attention'] for k, c in moe_counts.items()} }, GNN "
        f"segment_spmm launches {gnn_counts}, GNN training segment_spmm "
        f"launches ({GNN_TRAIN_STEPS} steps each) {train_gnn}, split-KV "
        f"decode flash lse launches over the 8 ranks ({MM_DECODE_REPS} "
        f"steps) {mesh_models['launches']}, tensor-parallel serving flash "
        f"launches over the ranks (prefill {mesh_models['tp_prefill']}, "
        f"steps {mesh_models['tp_decode']}), minibatch_lg segment_spmm "
        f"launches (forwards {mb['launched']}, GCN training {mb['train']}), "
        f"dry run {len(dry['records'])} records (not run here: "
        f"{dry['skipped']}), dry run against the card "
        f"{ {k: round(v['gap'], 4) for k, v in dry_card.items()} }; total "
        f"{time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "path")
    print(card)
    # flash_attention has one record per shape of the LM path, each with the
    # launches of its own run (the prefill, the decode steps); segment_spmm
    # one per GNN path; bag_sum has no path (its launches are its checks'),
    # nor has compat_matrix since the expand path takes compat_select
    # (likewise its checks'; phase 5 asserts none on the path)
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + ("q", "kv", "q_start", "flash_route",
                                  "max_abs_err_lse",
                                  "shape", "ms_with_plan", "plan_ms",
                                  "kernel_only_ms", "kernel_uniform_ms",
                                  "piece", "n_pieces", "n_split",
                                  "kernel_ms")
         if k in r}
        for r in rec.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

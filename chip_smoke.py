#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``egc_tpu_torch``) on one H100.

    python3 chip_smoke.py [--out results.json]

Phases, each of which raises (exit code 1) on any failed check:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off for matmuls and cuDNN.
2. build: every kernel source under ``egc_tpu_torch/csrc/`` with nvcc for
   sm_90a, timed, with each kernel's registers and spills.
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes its path gives it (169,343 nodes, 2,368,458 edges): kernels
   1-4 at F = 128, prims sum/wsum/max with the max mask (bitwise equal to
   the plain one, also on values rounded to a 1/8 grid, where ties at
   scale make the forward re-sweep rows), the backward from c_sum,
   c_wsum, c_max and that mask, head mix H4 B4 A3 L32; the GAT kernels
   at (H8, C19) and (H1, C152); the GATv2 kernels at (H8, C14) and (H1,
   C112); values and gradients through the autograd functions (and the
   whole GATConv and GATv2Conv), and ``segment_gather_reduce`` (kernel 1
   over COO edges); two full-size launches of each gather-reduce kernel,
   of ``headmix_bwd`` and of each GAT and GATv2 kernel must agree
   bitwise. Then again at a small size with empty receivers, senders
   without out-edges, hub senders and receivers (a receiver of 300
   in-edges among them), senders and receivers with 1-3 edges, ties and
   signed zeros (the masks bitwise), F = 40, 37, 136 and 128 (and
   ``mask_words`` of the kernel against the wrapper's), the head mix's
   float4 and tile variants forward and backward (each kernel's pick held
   against ``headmix.fwd_variant`` / ``bwd_variant``; A = 1 and 6, L = 34,
   H8 L44, y_width > B*L, H = 12, L = 3 and 6), GAT and GATv2 (H, C) =
   (8, 5), (1, 37), (4, 37), (3, 37) and (32, 8) with receivers of G - 1 and
   G + 1 in-edges (G edge groups per warp step), and the lane geometry of
   the GAT and of the GATv2 kernels against
   ``attention.gat_edge_geometry`` / ``edge_geometry`` at every shape they
   take (``attention.accepted_shapes``, 1,792). ``gat_fwd``'s m must
   equal the plain version's bit for bit. The six attention kernels again
   at the ogbg-code2 widths, GAT (H8, C38) and (H1, C304), GATv2 (H8, C37)
   and (H1, C296) (32 lanes, one edge per warp step), on a code2 batch
   (14,256 node rows, ~9 k edges) and on the small graph. Kernel, plain
   and library times are medians of CUDA-event timed launches; each
   kernel's bound counts its compulsory bytes, and its floor, for a
   gather over random endpoints, the rows it gathers per edge
   (``floor_ms``). Kernels 1 and 2 again in the instantiation each
   conv-zoo path runs (GCN wsum at F = 156, GIN sum at 156, SAGE sum at
   115, MPNN sum and max at 116, PNA sum / sumsq / max / min at 76 with
   both masks) at the arxiv shape, masks bitwise, timed. Then kernels 1-4
   in the instantiation each EGC path of phase 4 runs (``NEW_GATHER``,
   ``PATH_HEADMIX``): on the first train batch of zinc (F 124, sum /
   sumsq / max), cifar (F 128, sum / wsum / sumsq / max) and hiv (F 224,
   sum / max), each with the max mask, and at mag's full shape (F 176
   wsum over the ``MAG_GRAPH`` graph, whose build on the host is timed),
   the head mix at (H, B, A, L) = (4, 4, 3, 31), (4, 4, 3, 32), (4, 4, 3,
   56) and (8, 4, 1, 44) on the same rows, its variant held against
   ``fwd_variant`` / ``bwd_variant``; values, gradients, masks bitwise,
   two launches bitwise, timed with their bounds. The same for each
   instantiation that only a CLI run of phase 5 launches (``CLI_GATHER``,
   ``CLI_HEADMIX``: on a hiv batch, a code2 batch and the arxiv graph;
   the attention shapes ``CLI_GAT_SHAPES``, ``CLI_GATV2_SHAPES`` on the
   small graph). The launches of ``[gat_wide]``'s rows past one launch
   (``attention.sweeps``): GAT (2, 250), (1, 250), (1, 375), GATv2 (2,
   250), (1, 250) and the ``gatv2w_*`` kernels at (1, 750), each on the
   arxiv graph (values, the backward kernels, two launches bitwise, timed
   with bound and floor), on the small graph with gradients through the
   autograd functions and the convs (the wide kernels also at (2, 600),
   (1, 1100), (3, 513) and (1, 4096), so each variant of their blocks
   runs), and the rows (3, 250) and (1, 750) through the convs over their
   sweeps; the compiled wide rule against ``wide_shape_ok`` and the
   blocks' geometry against ``wide_geometry``; the build's ``ptxas``
   report of the six wide instantiations without spills. What phase 3
   held is recorded
   (``HELD``): every timed
   path and CLI run fails on a gather-reduce (F, primitives, masks; the
   forward without masks counted held with the masked one), head mix
   (H, B, A, L) or attention (H, C) that it launched and phase 3 did not
   hold. The four masked-BatchNorm kernels (``ops/cuda/batch_norm``,
   ``kernels_batch_norm``) at the arxiv shape (169,343 rows and a padded
   one under the node mask, F = 136), and at N = 1, all rows masked, F =
   34, 68 and 352, the scalar variant at 34 and at 68 on a misaligned
   view: the sums of ``bn_stats`` and ``bn_grad_sums`` against their
   float64 values within the worst-case f32 error of the kernels' order
   of addition (``_bn_depth``), ``bn_apply`` (train and eval, the running
   statistics too) and ``bn_apply_bwd`` bitwise against their plain
   versions on the same statistics and sums, two launches of each
   bitwise; timed at the arxiv shape beside their bounds, their plain
   versions and ``torch.nn.functional.batch_norm`` with no mask (the
   yardstick, never called by the port). The build's ``ptxas`` report of the eight
   ``batch_norm`` instantiations must show no spills.
4. the three paths, each through ``train_full_graph`` on the 169,343-node
   synthetic graph: "main" (arxiv EGC-M, h128 H4 B4 symnorm/max/mean),
   "gat" (arxiv GAT, h152 H8) and "gatv2" (arxiv GATv2, h112 H8, lr
   0.0087876, wd 0.001), the attention nets' last layer single-head, 3
   layers each; then ``[gat_wide]``: GAT and GATv2 h750 H3 (``WIDE_NETS``,
   DGL's ogbn-arxiv GAT widths: rows (3, 250) and (1, 750), past one
   kernel launch) the same way, their card step held on a graph of 1/8
   the nodes against the CPU step on the card's branches
   (``_same_branches``), their launches a step by kernel
   (``_wide_launches``), the idle share, ``--check --check-epochs 2`` of
   both through the CLI, and the conv route on the card
   (``check_attention_routes``: 33 heads launch no attention kernel, 32
   heads the three GAT kernels, both held against the CPU). One dropout-0 step
   on the card is held against the same
   step of the port on the CPU (loss and every gradient); then 2 warm-up
   and 10 timed dropout-0.2 steps with the launch counters reset just
   before and read just after: each kernel of the path launches 3 times
   per step (the BatchNorm kernels once a layer) and every other kernel
   never; then a torch.profiler table of
   two more steps (device time by kernel). Then the two batched ogbg-code2
   paths through ``train_batched`` on ``synthetic_code(900)`` at the real
   vocabulary (5000) and attribute count (10,030), batch 128, with the
   loader's prefetch: "code_gat" (CodeNet GAT h304 H8, 4 layers, the last
   single-head) and "code_gatv2" (GATv2 h296 H8): one step on the card
   against the CPU step, then 15 steps (3 epochs) with the launch counters
   (each kernel of the path 4 times per step, the BatchNorm kernels once
   a layer, every other kernel never), a val pass (sequence F1), and a profiler table of two steps with the
   window split into batch fetch, step enqueue, wait and device busy,
   beside the build time of the window's two batches on the prefetch
   threads. Every card-vs-CPU step gradient must agree to relative L2 1e-3;
   on a code2 path the CPU step that agrees is one that replays the card
   step's branch at every ReLU and leaky_relu (one ReLU that flips under
   the card's rounding moves a code2 gradient by ~1e-3, PERF.md §6); the
   plain CPU step's gap is printed beside it. The six conv-zoo arxiv
   paths ("gcn" h156, "gin" h156, "sage" h115, "mpnn_sum" and "mpnn_max"
   h116, "pna" h76; ArxivConfig's lr 0.01, wd 5e-4, dropout 0.2) run as
   the three arxiv paths do, the gather-reduce pair 3 times a step each;
   their card step is held against the CPU step on a graph of 1/8 the
   nodes at the same average degree when two full-size CPU steps a path
   would take the script past ``ZOO_BUDGET_S`` (a line says which). In
   the timed steps of EGC-M and of each zoo path, the (F, primitives,
   masks) that ``ops/dispatch`` launches the gather-reduce pair with must
   be the one phase 3 held (``PATH_GATHER``). In the timed steps of every
   path each BatchNorm kernel launches once a ``MaskedBatchNorm`` layer a
   step (``_per_step``; none on mag, sampled mag and rmag), and in an
   eval forward (the trial's validation, ``--pretrained``) ``bn_apply``
   alone once a layer; each gather-reduce launch of a path whose widths
   share one lane geometry counts under that geometry's counter too
   (``_variant_counts``). Then "mag": MagNet h352 H8
   B4 symnorm (2 layers, lr 0.01, wd 1e-5, dropout 0.3) through
   ``MagConfig``'s hooks on ``synthetic_full_graph`` of ogbn-mag's 736,389
   papers at average degree 15: one dropout-0 iteration against the CPU
   one (on a graph of 1/8 the nodes when the full size would end past
   ``MAG_BUDGET_S``), 2 warm-up and 10 timed iterations with the
   counters (each EGC kernel twice a step), edges/s, peak memory, a
   profiler table. Then ``[sampled_mag]`` on the same graph and card data:
   ``SampledMagConfig`` (fanouts (15, 10), batch 512: batches of 85,000
   rows and 84,480 edge slots); on one host-sampled batch the card-built
   plan (``build_kernel_plan_device``) equal to the host plan field for
   field on the valid prefix, kernels 1-4 on that plan (F 176 wsum, head
   mix (8, 4, 1, 44)), and a dropout-0 card step against the CPU step;
   then each branch, "sampled_host" (the host sampler on 4 prefetch
   threads, the host plan's build timed beside the card's) and
   "sampled_device" (the device sampler; its sample and plan timed by
   CUDA events), 3 warm-up and 20 timed steps through ``batches`` and
   ``sampled_step`` with the counters (each EGC kernel twice a step),
   seeds/s, valid sampled edges/s, peak memory, the idle share of a
   profiler window of two steps; a full-graph ``val``; and ``--sampled``
   and ``--device-sampler`` ``--check --check-epochs 1`` through the CLI
   at h352 H8 B4. Then "rmag": heterogeneous ogbn-mag, REGCNet h64 H4
   B4 (2 layers, lr 0.01, wd 0.001, dropout 0.7) through
   ``RMagConfig``'s hooks on a graph of ogbn-mag's node and edge counts
   (``rmag_raw``: 736,389 papers, 1,134,649 authors, 8,740 institutions,
   59,965 fields of study; 42.2 M edges in seven relations), its host
   plan build timed; first kernels 1-4 in its bipartite instantiations
   (gather-reduce F 64 sum / max with and without the max mask and sum
   alone, beside ``torch.sparse.mm``, on every relation; head mix (4, 4,
   1, 16) and (4, 8, 1, 16) on the paper and author rows), then one
   dropout-0 iteration on a graph of 1/8 the counts against the CPU one
   on the card's branches (every ReLU and max holder), 2 warm-up and 10
   timed iterations (each EGC kernel ``RMAG_LAUNCHES`` = 9 times a step,
   just the instantiations held), edges/s, peak memory, an eval pass and
   the profiler's busy and idle shares. Then ``[partitioned_rmag]`` on the
   same graph: ``PartitionedRMagConfig`` at world size 1 under NCCL (this
   process joins a one-rank group), its plan build timed in its parts
   (the BFS over the typed union graph, the per-type cuts and halos, the
   rank's seven bipartite plans over its ``n_ext`` source and ``n_local``
   destination rows), kernels 1 and 2 held on each rank plan in rmag's
   instantiations, 3 dropout-0 steps against the unpartitioned
   ``RMagConfig`` steps on the card from the same seed (loss rtol 1e-5,
   gradients relative L2 2e-4: every tensor at the first step, the whole
   gradient after it; after it, each step's max holders and ReLU branches
   recorded in global ids (``_holders``), every embedding row off must be
   one whose max holders changed, whose ReLU flipped or that feeds a
   flipped row, and with those rows left out every tensor is held at
   2e-4), 9 launches of each EGC
   kernel a step on both, 10 steps of each at dropout 0.5 in turns, both
   idle shares and their largest device ops, the peak memory with both
   resident, and ``rmag --partitions 1 --check --check-epochs 2`` on
   ``synthetic_rmag`` as a subprocess. Then the batched EGC-M paths of
   ``BATCHED_NETS``
   ("zinc_egc" h124 ``add,std,max`` batch 64, "cifar_egc" h128
   ``symadd,std,max`` batch 32 dropout 0.081, "hiv_egc" h224
   ``add,mean,max`` batch 32 dropout 0.2; H4 B4, 4 layers, the main
   table's lr and wd) through their configs, as the code2 paths: the
   card step held against the CPU step on the card's branches (every
   ReLU, std's gate), 2 warm-up steps and one epoch timed (each EGC
   kernel 4 times a step), a val pass of the config's metric, graphs/s,
   the profiler's split. In the timed steps of these four paths the
   gather-reduce and head-mix instantiations launched must be the ones
   held above (``PATH_GATHER``, ``PATH_HEADMIX``).
5. the trial loop and the command line: ``exp/runner.run_trial`` at arxiv
   size (EGC-M h128 H4 B4 through an ArxivConfig on the 169,343-node
   graph, 12 iterations into a trial directory; seconds an iteration
   beside the bare step, the eval forward and one ``persist_trial``;
   launch counters as on the paths); then ``python -m egc_tpu_torch``'s
   main in process on the card, ``--check --check-epochs 3`` of all nine
   kinds at their reference arxiv widths on ArxivConfig's synthetic graph
   (metrics finite, the kind's kernels launched and no other), then one
   EGC-M h136 ``--use-default-hparams --final-runs 1`` run whose
   ``restore_trial`` gives the accuracies its ``result.json`` recorded;
   then ``--check --check-epochs 2`` of each of the 23 supported (dataset,
   kind) pairs of zinc, cifar, hiv, code, mag and rmag at its main-table
   width (``CLI_DATASET_RUNS``), and one zinc EGC-M h124 final run
   restored the same way.
6. ``[partitioned]`` (after the trial loop): graph-partitioned arxiv
   training at world size 1 under NCCL (this process joins a one-rank
   group), ``PartitionedArxivConfig``'s hooks on the 169,343-node graph
   (the BFS plan with its padded halo and the rank's kernel plan, built
   and timed): 3 EGC-M h128 H4 B4 steps against the unpartitioned
   ``ArxivConfig`` steps on the card from the same seeded weights (loss
   rtol 1e-5, gradients relative L2 <= ``PART_GRAD_REL_L2``), rows 2-5
   and the BatchNorm kernels launched 3 times a step and nothing else; both steps' times (windows
   in turns) and the partitioned step's idle share; one GAT h152 H8 step
   each way (rows 6-7, 3 a step); one DP step at world 1 on a zinc
   EGC-M batch against one device; ``python -m egc_tpu_torch ...
   --partitions 1 --check --check-epochs 2`` as a subprocess, and
   ``--partitions`` past the visible cards exiting 2 before any rank
   starts. ``[multihost]`` (beside phase 5's CLI runs):
   ``exp/multihost_smoke`` as one rank that
   joins from ``torch.distributed.run``'s environment (``--standalone
   --nproc-per-node 1 ... --worker``: NCCL, world 1, on
   ``cuda:LOCAL_RANK``) and as ``--reference --world 1`` (a ``spawn``
   rank), started at once: psum, DP loss and partitioned loss within
   1e-6, their seconds (more than one card is not measured here).
   ``[bf16_dense]``: ``EGC_TPU_BF16_DENSE=1``, set inside the phase only:
   the bf16 GEMMs (``nn/conv/egc.bf16_matmuls``) against their plain
   version on the card at the arxiv and mag layer shapes (value at
   relative L2 1e-5, the cotangents at 1e-2: the card's backward rounds
   the f32 cotangent to bf16), their forward timed beside the f32 ``mm``;
   then arxiv EGC-M h128 and MagNet h352 with the opt-in beside f32: a
   dropout-0 step of each from one seed (the loss's and gradients'
   relative L2), 2 warm-up and 10 timed steps of each in turns of 5 (f32,
   bf16, bf16, f32) with the launch counters, each mode's peak memory,
   and a profiler window of two steps each (device busy, the matmul
   kernels' ms). ``[harness]`` (last): ``--pretrained`` for arxiv EGC-M h136 H4
   B4 symadd/max/mean from a ``checkpoint.pt`` the phase writes (the
   printed accuracies against an in-process eval; rows 2 and 4, 3 each,
   the head mix's tile variant at L 34), then ``run_search_parallel`` on
   zinc EGC-M with 2 candidates of ``SEARCH_ITERS`` epochs on 2 spawned
   workers sharing the card from a cold kernel cache (the libraries
   deleted first, so the build lock has two processes to order), each
   worker's launches, kernel build seconds and device recorded by the
   spec's factory (``search_config``), its wall time beside the same 2
   trials run in turn in this process.
Each phase's seconds are printed at the end.

Printed at the end: one JSON line of the kernels, the nvidia-smi line, and
the result line ``{"ok": true, "device": {...}}``. A kernel row's times
and bound for the GAT and GATv2 kernels are per launch on their arxiv
path (two launches at the first shape and one at the second per step);
``wide`` gives times and bound at the code2 widths (a code2 batch fits in
L2, so its gathered floor is null), ``zoo``, ``paths`` and ``cli`` those
of each gather-reduce and head-mix instantiation held in phase 3
(``partitioned_rmag`` those of the gather pair on the rank plans),
``launches_by_path`` the launches
of each path's timed steps and ``launches`` their sum. The two
gather-reduce rows also give the bytes each edge gathers in their floor
(``gathered_bytes_per_edge``); the forward's row its time without the mask
(``ms_no_mask``) and on the 1/8 grid (``ms_ties``, with ``tied_rows``, the
rows it re-sweeps), and ``zoo`` their times, bound and floor in each
conv-zoo path's instantiation, and ``paths`` those of the kernels 1-4
in each phase-4 EGC path's (a batch's gathered floor is null: it fits in
L2), ``rmag`` those of rmag's bipartite instantiations (each side's rows,
the edges, and for a sum alone the ``torch.sparse.mm`` time as
``library_ms``). Without a
CUDA device, or outside the repository, it exits nonzero and prints no
result. ``--out`` writes every measured number to a JSON file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
STEPS_WARMUP, STEPS_TIMED = 2, 10
NUM_NODES, NUM_EDGES = 169_343, 2_368_458
GAT_NET = dict(kind="gat", hidden=152, heads=8)
GAT_SHAPES = ((8, 19), (1, 152))   # layers 0-1 and layer 2 of h152 H8
# the reference's tuned arxiv GATv2 (scripts/train_main_table.sh:37)
GATV2_NET = dict(kind="gatv2", hidden=112, heads=8, lr=0.0087876393444041,
                 wd=0.001)
GATV2_SHAPES = ((8, 14), (1, 112))  # layers 0-1 and layer 2 of h112 H8
# ogbg-code2 (egc_tpu/exp/pretrained.py:73-74): CodeNet GAT h304 H8 and
# GATv2 h296 H8, 4 layers, the last single-head; the real vocabulary (5000)
# and node attributes (10,030), batch 128, Adam lr 1e-3 (CodeConfig)
CODE_GAT_NET = dict(kind="gat", hidden=304, heads=8)
CODE_GATV2_NET = dict(kind="gatv2", hidden=296, heads=8)
CODE_GAT_SHAPES = ((8, 38), (1, 304))      # layers 0-2 and layer 3
CODE_GATV2_SHAPES = ((8, 37), (1, 296))
CODE_DATA = dict(num_layers=4, vocab_size=5000, num_nodeattributes=10030,
                 num_graphs=900)
CODE_HP = {"lr": 1e-3, "batch_size": 128}
CODE_STEPS = 15   # 3 epochs of the 5 train batches of synthetic_code(900)
# the conv-zoo arxiv paths, each at its reference arxiv width
# (egc_tpu/exp/pretrained.py:59-70; PNA and MPNN with 4 towers) with
# ArxivConfig's defaults (lr 0.01, wd 5e-4, dropout 0.2), and the
# gather-reduce instantiation each runs: (F, primitives, masks)
ZOO_NETS = {"gcn": dict(kind="gcn", hidden=156),
            "gin": dict(kind="gin", hidden=156),
            "sage": dict(kind="sage", hidden=115),
            "mpnn_sum": dict(kind="mpnn-sum", hidden=116),
            "mpnn_max": dict(kind="mpnn-max", hidden=116),
            "pna": dict(kind="pna", hidden=76)}
ZOO_SHAPES = {"gcn": (156, ("wsum",), ()), "gin": (156, ("sum",), ()),
              "sage": (115, ("sum",), ()), "mpnn_sum": (116, ("sum",), ()),
              "mpnn_max": (116, ("max",), ("max",)),
              "pna": (76, ("sum", "sumsq", "max", "min"), ("max", "min"))}
# the EGC paths of the batched tasks and of homogeneous ogbn-mag at the
# main table's EGC-M widths and hyperparameters
# (scripts/train_main_table.sh:16,21,32,60), through their configs
BATCHED_NETS = {
    "zinc_egc": dict(config="ZincConfig", hidden=124,
                     aggrs=("add", "std", "max"),
                     hp={"lr": 0.0019099809690277627, "batch_size": 64,
                         "wd": 0.00020407622034162426}),
    "cifar_egc": dict(config="CifarConfig", hidden=128,
                      aggrs=("symadd", "std", "max"),
                      hp={"lr": 0.0009263869626947979, "batch_size": 32,
                          "wd": 0.0007592290244995363,
                          "dropout": 0.08118925150158363}),
    "hiv_egc": dict(config="MolConfig", hidden=224,
                    aggrs=("add", "mean", "max"),
                    hp={"lr": 0.0001, "batch_size": 32, "wd": 0.001,
                        "dropout": 0.2})}
# MagNet h352 H8 B4 symnorm, 2 layers, on a synthetic graph of ogbn-mag's
# 736,389 papers at average degree 15 (~ its 5,416,271 cites edges, both
# directions after to_undirected), 128 features, 349 classes
MAG_NET = dict(hidden=352, heads=8, bases=4, aggrs=("symnorm",),
               hp={"lr": 0.01, "wd": 1e-05, "dropout": 0.3})
MAG_GRAPH = dict(num_nodes=736_389, avg_degree=15, num_classes=349,
                 num_features=128, seed=0)
# the mag step check moves to a graph of 1/8 the nodes when its two CPU
# steps (projected from the main path's) would end past this
MAG_BUDGET_S = 330
# neighbour-sampled mag (SampledMagConfig's defaults, egc_tpu/exp/
# fullgraph.py:409-438) on the same graph: batches of 85,000 rows (the
# budget of 84,993 rounded up to 8) and 84,480 edge slots, through the
# host sampler ("sampled_host") and the device sampler ("sampled_device")
SAMPLED = dict(fanouts=(15, 10), batch_size=512)
SAMPLED_WARMUP, SAMPLED_TIMED = 3, 20
SAMPLED_PATHS = ("sampled_host", "sampled_device")
SAMPLED_CLI = ["--hidden", "352", "--egc-num-heads", "8", "--egc-num-bases",
               "4", "--aggrs", "symnorm"]
# heterogeneous ogbn-mag: REGCNet h64 H4 B4, 2 layers (a REGConv with
# {mean, max} a relation, then an RGCNConv to the 349 classes) at the main
# table's hyperparameters (scripts/train_main_table.sh:61), on a synthetic
# graph of ogbn-mag's published node and edge counts (OGB's dataset
# table): the paper graph is MAG_GRAPH's (its features, labels, split and
# 11,022,944 cites edges), the other three relations uniform coalesced
# random edges, each with its reverse ("to"): 42.2 M directed edges in
# seven relations
RMAG_NET = dict(hidden=64, heads=4, bases=4,
                hp={"lr": 0.01, "wd": 0.001, "dropout": 0.7})
RMAG_TYPES = {"paper": 736_389, "author": 1_134_649, "institution": 8_740,
              "field_of_study": 59_965}
RMAG_RELATIONS = {("author", "writes", "paper"): 7_145_660,
                  ("author", "affiliated_with", "institution"): 1_043_998,
                  ("paper", "has_topic", "field_of_study"): 7_505_078}
# its kernel instantiations: the REGConv's {mean, max} (sum and max, the
# max mask in training), the RGCNConv's mean (sum), both at F = B*L = 64;
# the REGConv's root head mixes (H4, B4) and relation mixes (H4, K = A*B =
# 8), each at A = 1 and L = 16. A step launches each of the four kernels
# 9 times: the loss reads the paper rows of the last layer only, so it
# aggregates the 3 relations into paper there, and the 6 relations into
# paper, author and field_of_study (the types those read) in the first,
# with 3 root mixes; what reaches no loss is not computed (REGCNet's
# ``layer_out_types``)
RMAG_GATHER = {"regc": (64, ("sum", "max"), ("max",)),
               "rgcn": (64, ("sum",), ())}
RMAG_HEADMIX = {"root": (4, 4, 1, 16), "rel": (4, 8, 1, 16)}
RMAG_LAUNCHES = 9
L2_BYTES = 50 << 20            # H100 SXM L2 cache
# each new EGC path's gather-reduce (F = B*L, primitives, masks) and head
# mix (H, B, A, L); the batched ones H4 B4 A3 (hiv A3 too: add, mean, max)
NEW_GATHER = {"zinc_egc": (124, ("sum", "sumsq", "max"), ("max",)),
              "cifar_egc": (128, ("sum", "wsum", "sumsq", "max"),
                            ("max",)),
              "hiv_egc": (224, ("sum", "max"), ("max",)),
              "mag": (176, ("wsum",), ())}
PATH_HEADMIX = {"main": (4, 4, 3, 32), "zinc_egc": (4, 4, 3, 31),
                "cifar_egc": (4, 4, 3, 32), "hiv_egc": (4, 4, 3, 56),
                "mag": (8, 4, 1, 44),
                **{path: (8, 4, 1, 44) for path in SAMPLED_PATHS}}
#   (held against what ``ops/dispatch`` launches in each path's timed
#   steps, ``_instantiations``; EGC-M's is the main shape's)
PATH_GATHER = {"main": (128, ("sum", "wsum", "max"), ("max",)), **ZOO_SHAPES,
               **NEW_GATHER, **{path: NEW_GATHER["mag"]
                                for path in SAMPLED_PATHS}}
# the parameters of each path, by the whole name, that feed a BatchNorm
# through affine maps only: BN removes a constant shift, so their true
# gradient is 0 and both steps hold rounding noise there (MPNN-max's
# message biases too, where every real node has an in-edge: a constant
# shift of every max). By default a conv's bias (arxiv ``convs.{i}``,
# CodeNet ``graph_layers.{i}.0``); MagNet has no BatchNorm; a batched EGC
# net's conv bias and its readout's first two Linears' biases feed one
# (cifar's conv is graph_layers.{i}.1)
ZERO_GRAD = {"sage": r"convs\.\d+\.lin_l\.bias",
             "gin": r"convs\.\d+\.nn\.bias",
             "mpnn_sum": r"convs\.\d+\.(lin|update_layer\.\d+)\.bias",
             "mpnn_max":
                 r"convs\.\d+\.(lin|(update|message)_layer\.\d+)\.bias",
             "pna": r"convs\.\d+\.(lin|post_nns\.\d+\.0)\.bias",
             "code_gat": r"graph_layers\.\d+\.0\.bias",
             "code_gatv2": r"graph_layers\.\d+\.0\.bias",
             "mag": r"(?!)", "sampled_host": r"(?!)",
             "zinc_egc": r"graph_layers\.\d+\.0\.bias|mlp\.[04]\.bias",
             "cifar_egc": r"graph_layers\.\d+\.1\.bias|mlp\.[04]\.bias",
             "hiv_egc": r"graph_layers\.\d+\.0\.bias|mlp\.[04]\.bias",
             "rmag": r"(?!)"}
# the step check of the zoo paths moves to a graph of 1/8 the nodes (same
# average degree) when its CPU steps would take the script past this
ZOO_BUDGET_S = 420
# the CLI phase: every kind at its reference arxiv width through
# ``python -m egc_tpu_torch``'s main, in process (EGC-M: h136 H4 B4,
# egc_tpu/exp/pretrained.py:69)
CLI_RUNS = {"gcn": ["--hidden", "156"], "gat": ["--hidden", "152"],
            "gatv2": ["--hidden", "112"], "gin": ["--hidden", "156"],
            "sage": ["--hidden", "115"], "mpnn-sum": ["--hidden", "116"],
            "mpnn-max": ["--hidden", "116"], "pna": ["--hidden", "76"],
            "egc": ["--hidden", "136", "--aggrs", "symnorm,max,mean",
                    "--egc-num-heads", "4", "--egc-num-bases", "4"]}
CLI_EPOCHS = 3
# the trial loop the command line runs (``exp/runner.run_trial``) at arxiv
# size: EGC-M h128 H4 B4 (the main path's net) through an ArxivConfig
# whose graph is the 169,343-node one, this many iterations
TRIAL_ITERS = 12
GATHER = ("gather_reduce_fwd", "gather_reduce_bwd")
EGC_KERNELS = ("gather_reduce_fwd", "gather_reduce_bwd", "headmix_fwd",
               "headmix_bwd")
# the head mix's tile-variant counters beside its kernels' own
# (``ops/cuda/headmix.launches``): each counts the launches of its kernel
# that took the tile variant (L or y_width not a multiple of 4)
HEADMIX_TILE = {"headmix_fwd_tile": "headmix_fwd",
                "headmix_bwd_tile": "headmix_bwd"}
# the gather-reduce geometry counters beside its kernels' own
# (``ops/cuda/gather_reduce.launches``): each counts the calls of its
# kernel in that lane geometry (``lane_geometry``: split at F <= 64, a
# split tail past the full chunks at F 132 to 192, ...)
GATHER_GEOMETRY = {f"{k}_{g}": k for k in GATHER for g in ("split",
                                                           "split_tail")}


def _variant_counts(counts: dict, label: str, tiled=None,
                    seen=None) -> dict:
    """``counts`` less the variant counters, each checked against its
    kernel's launches. The head mix's tile counters: all of them where the
    run's head width takes the tile variant (``tiled``), none where it does
    not; with ``tiled`` None (a run whose width this script does not name),
    all or none. The gather-reduce geometry counters: where the gather
    widths of ``seen`` (``_instantiations``) share one geometry, all of
    that geometry's and none of another's; else no more than the kernel's
    launches."""
    from egc_tpu_torch.ops.cuda.gather_reduce import lane_geometry
    for tile, kernel in HEADMIX_TILE.items():
        c, base = counts.get(tile, 0), counts.get(kernel, 0)
        want = {base, 0} if tiled is None else {base if tiled else 0}
        check(c in want, f"{label} {tile} launched {c} times beside "
                         f"{base} of {kernel}, expected {sorted(want)}")
    geometries = {lane_geometry(f) for f, *_ in seen["gather"]} \
        if seen else set()
    for counter, kernel in GATHER_GEOMETRY.items():
        c, base = counts.get(counter, 0), counts.get(kernel, 0)
        if len(geometries) == 1:
            want = base if counter == f"{kernel}_{min(geometries)}" else 0
            check(c == want, f"{label} {counter} launched {c} times beside "
                             f"{base} of {kernel}, expected {want}")
        else:
            check(c <= base, f"{label} {counter} launched {c} times beside "
                             f"{base} of {kernel}")
    return {k: v for k, v in counts.items()
            if k not in HEADMIX_TILE and k not in GATHER_GEOMETRY}


def _path_tiled(path: str) -> bool:
    """Whether a timed path's head mix (``PATH_HEADMIX``) takes the tile
    variant."""
    shape = PATH_HEADMIX.get(path)
    return shape is not None and shape[3] % 4 != 0

GAT_KERNELS = ("gat_fwd", "gat_bwd_t", "gat_bwd_f")
GATV2_KERNELS = ("gatv2_fwd", "gatv2_bwd_t", "gatv2_bwd_f")
GATV2W_KERNELS = ("gatv2w_fwd", "gatv2w_bwd_t", "gatv2w_bwd_f")
# masked BatchNorm (ops/cuda/batch_norm): a training step launches each
# once a MaskedBatchNorm layer, an eval forward bn_apply once a layer
# (``_per_step``); MagNet and the rmag net hold none
BN_KERNELS = ("bn_stats", "bn_apply", "bn_grad_sums", "bn_apply_bwd")
PATH_KERNELS = {
    "main": EGC_KERNELS + BN_KERNELS,
    "gat": GAT_KERNELS + BN_KERNELS,
    "gatv2": GATV2_KERNELS + BN_KERNELS,
    "gat_wide": GAT_KERNELS + BN_KERNELS,
    "gatv2_wide": GATV2_KERNELS + GATV2W_KERNELS + BN_KERNELS,
    "code_gat": GAT_KERNELS + BN_KERNELS,
    "code_gatv2": GATV2_KERNELS + BN_KERNELS,
    **{path: GATHER + BN_KERNELS for path in ZOO_NETS},
    "mag": EGC_KERNELS,
    **{path: EGC_KERNELS + BN_KERNELS for path in BATCHED_NETS},
    "rmag": EGC_KERNELS, **{path: EGC_KERNELS for path in SAMPLED_PATHS},
}
PATH_LAYERS = {"main": 3, "gat": 3, "gatv2": 3, "code_gat": 4,
               "code_gatv2": 4, **{path: 3 for path in ZOO_NETS},
               "mag": 2, **{path: 2 for path in SAMPLED_PATHS},
               **{path: 4 for path in BATCHED_NETS},
               "rmag": RMAG_LAUNCHES}
#   launches of each path kernel per step (the wide paths: by kernel,
#   ``_wide_launches``)
CLI_KERNELS = {"gat": GAT_KERNELS, "gatv2": GATV2_KERNELS,
               "egc": EGC_KERNELS}   # the others: GATHER; BN_KERNELS too
#   where the dataset's net has BatchNorm (not NO_NORM)
# then ``--check --check-epochs 2`` of every SUPPORTED (dataset, kind) of
# the batched datasets and mag, each at its width in
# scripts/train_main_table.sh (EGC: its egc_m row), and one zinc EGC-M
# final run restored with ``restore_trial``
_EGC_M = ["--egc-num-heads", "4", "--egc-num-bases", "4", "--aggrs"]
CLI_DATASET_RUNS = [
    ("zinc", "egc", ["--hidden", "124", *_EGC_M, "add,std,max"]),
    ("zinc", "gatv2", ["--hidden", "104"]),
    ("cifar", "egc", ["--hidden", "128", *_EGC_M, "symadd,std,max"]),
    ("cifar", "gatv2", ["--hidden", "104"]),
    ("hiv", "egc", ["--hidden", "224", *_EGC_M, "add,mean,max"]),
    ("hiv", "gcn", ["--hidden", "240"]), ("hiv", "gat", ["--hidden", "240"]),
    ("hiv", "gatv2", ["--hidden", "184"]), ("hiv", "gin", ["--hidden", "240"]),
    ("hiv", "sage", ["--hidden", "180"]),
    ("hiv", "mpnn-max", ["--hidden", "180"]),
    ("hiv", "mpnn-sum", ["--hidden", "180"]),
    ("code", "egc", ["--hidden", "300", *_EGC_M, "symadd,min,max"]),
    ("code", "gcn", ["--hidden", "304"]), ("code", "gat", ["--hidden", "304"]),
    ("code", "gatv2", ["--hidden", "296"]),
    ("code", "gin", ["--hidden", "304"]),
    ("code", "sage", ["--hidden", "293"]),
    ("code", "mpnn-max", ["--hidden", "292"]),
    ("code", "mpnn-sum", ["--hidden", "292"]),
    ("code", "pna", ["--hidden", "272"]),
    ("mag", "egc", ["--hidden", "352", "--egc-num-heads", "8",
                    "--egc-num-bases", "4", "--aggrs", "symnorm"]),
    ("rmag", "egc", ["--hidden", "64", "--egc-num-heads", "4",
                     "--egc-num-bases", "4"])]
CLI_DATASET_EPOCHS = 2
NO_NORM = ("mag", "rmag")   # datasets whose nets hold no BatchNorm
# the kernel instantiations that the CLI runs launch beyond the timed
# paths', by dataset and kind: gather-reduce (F, primitives, masks) and
# head mix (H, B, A, L), held in phase 3 on a batch of the dataset (arxiv:
# its graph; hiv's mpnn-sum launches sage's (180, sum)); the attention
# shapes (H, C) of hiv GAT h240, zinc / cifar GATv2 h104 and hiv GATv2
# h184, held on the small graph
CLI_GATHER = {
    "arxiv": {"egc": (136, ("sum", "wsum", "max"), ("max",))},
    "hiv": {"gcn": (240, ("wsum",), ()), "gin": (240, ("sum",), ()),
            "sage": (180, ("sum",), ()),
            "mpnn-max": (180, ("max",), ("max",))},
    "code": {"egc": (300, ("wsum", "max", "min"), ("max", "min")),
             "gcn": (304, ("wsum",), ()), "gin": (304, ("sum",), ()),
             "sage": (293, ("sum",), ()), "mpnn-sum": (292, ("sum",), ()),
             "mpnn-max": (292, ("max",), ("max",)),
             "pna": (272, ("sum", "sumsq", "max", "min"), ("max", "min"))}}
CLI_HEADMIX = {"arxiv": {"egc": (4, 4, 3, 34)},
               "code": {"egc": (4, 4, 3, 75)}}
CLI_GAT_SHAPES = ((8, 30), (1, 240))
# ``[gat_wide]``: GAT and GATv2 ArxivNet at the widths of DGL's ogbn-arxiv
# GAT example (examples/pytorch/ogb/ogbn-arxiv/gat.py: 3 heads of 250
# channels, 3 layers; ``main.py EXP gat arxiv --hidden 750
# --egc-num-heads 3``), ArxivConfig's lr 0.01 and wd 5e-4: layers (3, 250)
# twice, then the single-head (1, 750), rows past one launch. Their sweeps
# (``attention.sweeps``): (3, 250) as (2, 250) + (1, 250); GAT's (1, 750)
# as 2 x (1, 375), GATv2's as one ``gatv2w_*`` launch
WIDE_NETS = {"gat_wide": dict(kind="gat", hidden=750, heads=3),
             "gatv2_wide": dict(kind="gatv2", hidden=750, heads=3)}
WIDE_ROWS = ((3, 250), (1, 750))
WIDE_CLI = ["--hidden", "750", "--egc-num-heads", "3"]
# the wide kernels on the small graph: each variant of their blocks
# (attention.wide_geometry): 2-float vectors (C even) at 4, 6 and 22 warps
# (C = 4,096, the widest the rule takes) and at two heads, single floats (C
# odd) at three heads
WIDE_SMALL_SHAPES = ((1, 750), (2, 600), (1, 1100), (3, 513), (1, 4096))
# the narrow launches of those sweeps, GAT's and GATv2's
WIDE_SWEEP_SHAPES = ((2, 250), (1, 250), (1, 375))
CLI_GATV2_SHAPES = ((8, 13), (1, 104), (8, 23), (1, 184))
# what phase 3 held against the plain versions: gather-reduce (F,
# primitives, masks; the forward without masks, as an eval launches it,
# besides each masked one), head mix (H, B, A, L), GAT and GATv2 (H, C).
# Every instantiation a CLI run launches must be among them.
HELD = {"gather": set(), "headmix": set(), "gat": set(), "gatv2": set()}
# tolerances, with why:
SUM_RTOL = SUM_ATOL = 1e-5     # f32 sums of <= ~40 terms in another order
#   rmag's receivers sum up to ~200 terms (author -> institution: ~119 on
#   average), where an element that cancels to near 0 differs between two
#   summation orders by more than 1e-5; its sums are held instead to the
#   worst-case f32 bound of two orders, 2 gamma_d sum |terms| element by
#   element (gamma_d = d u / (1 - d u), u = 2^-24, d the receiver's
#   in-degree: ``_close_sums``), in which one term too few or too many
#   shows
F32_U = 2.0 ** -24
GRAD_REL_L2 = 1e-4             # autograd vs kernel backward; var/std
#                                cancel two large terms
STEP_LOSS_RTOL = 1e-5          # card vs CPU step: cuBLAS vs CPU matmul
RESTORE_RTOL = 1e-5            # a batched eval on the card: atomic sums
STEP_GRAD_REL_L2 = 1e-3        # card vs CPU at full size: max and ReLU
#   selections that flip under another rounding move whole cotangents; the
#   step prints the spread that 1e-7 input noise gives on the CPU alone.
#   A code2 step has ~1e7 kinks (a ReLU after each BN; a leaky_relu per
#   edge and head, in GATv2 per edge and channel) and on a batch of ~9 k
#   nodes one branch that flips under another rounding moves a weight
#   gradient by ~1e-3: code_gatv2's card and CPU steps part at a few kinks
#   (printed per layer) and its layer-2 lin_l.weight gradients by 2.9e-3
#   (PERF.md §6).
#   So on a code2 path the gradients are held against a CPU step that
#   replays the card step's branch at every kink (``_same_branches``); the
#   plain CPU step's gap is printed beside it.
CODE_NOISE_SEEDS = (1, 2, 3, 4, 5)


class CheckFailed(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(got, ref) -> float:
    got, ref = got.double(), ref.double().to(got.device)
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def floor_ms(nbytes: float, row_bytes: float, n: int, e: int,
             flops: float) -> float:
    """The gathered-bytes floor of a gather over random endpoints: the
    compulsory bytes ``nbytes`` count each gathered row once (n rows); here
    each of the e edges reads its ``row_bytes`` from device memory, since
    the gathered arrays (76-347 MB at the arxiv shape) exceed the 50 MB L2.
    Per-head arrays (5.4 MB) fit in L2 and stay counted once. A dense
    kernel (``row_bytes`` 0), or a gather of fewer edges than rows (a
    bipartite relation), keeps its compulsory bound."""
    return bound_ms(nbytes + max(e - n, 0) * row_bytes, flops)[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timed calls of ``fn``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0],
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    log(f"[device] {smi} | torch {info['torch']} cuda {info['cuda']} "
        f"python {info['python']} | devices {info['count']}")
    return info


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> dict:
    from egc_tpu_torch.ops.cuda import _build
    libs = _build.build_all()
    for name, path in libs.items():
        log(f"[build] {name}: {path.name}")
        report = path.with_suffix(".log")
        if report.exists():
            lines = _build.ptxas_summary(report.read_text())
            for line in lines:
                log(f"[build]   {line}")
            if name == "gatv2_attention_wide":
                wide = [ln for ln in lines if ln.startswith("gatv2w_")]
                check(len(wide) == 6 and all(
                    "0 bytes spill stores" in ln for ln in wide),
                    f"[build] the wide kernels: {wide}")
            if name == "batch_norm":
                bn = [ln for ln in lines if ln.startswith("bn_")]
                check(len(bn) == 8 and all(
                    "0 bytes spill stores" in ln for ln in bn),
                    f"[build] the BatchNorm kernels: {bn}")
    log(f"[build] {_build.build_seconds:.3f} s")
    return {"build_seconds": _build.build_seconds}


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def _close(name, got, ref, exact=False):
    import torch
    got, ref = got.detach(), ref.detach()
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    if exact:
        check(torch.equal(got, ref), f"{name}: not equal (max err {err})")
    else:
        check(torch.allclose(got, ref, rtol=SUM_RTOL, atol=SUM_ATOL),
              f"{name}: max abs err {err} beyond rtol/atol {SUM_RTOL}")
    return err


def _close_sums(name, got, ref, abs_sums, deg):
    """``got`` and ``ref``, two f32 sums of each receiver's ``deg`` terms
    in other orders, within twice the worst-case error of one: 2 gamma_d
    times ``abs_sums``, the sum of the terms' magnitudes."""
    gamma = deg * F32_U / (1 - deg * F32_U)
    err = (got - ref).abs()
    over = err > 2 * gamma[:, None] * abs_sums
    check(not bool(over.any()),
          f"{name}: {int(over.sum())} sums beyond 2 gamma_d sum |terms| "
          f"(max abs err {float(err.max())})")
    return float(err.max())


def kernels_main_shapes(data, H=4, B=4, A=3) -> list:
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    from egc_tpu_torch.ops.cuda import gather_reduce as gr
    from egc_tpu_torch.ops.cuda import headmix as hm
    from egc_tpu_torch.ops.dispatch import fused_multi_aggregate
    from egc_tpu_torch.ops.segment import multi_aggregate

    g, plan = data["graph"], data["graph"].kernel_plan
    f, prims, _ = PATH_GATHER["main"]
    n, e, L = g.num_nodes, plan.num_edges, f // B
    dev = g.nodes.device
    gen = torch.Generator(device=dev).manual_seed(0)
    vals = torch.randn(n, f, generator=gen, device=dev)
    rows = []

    # kernel 1 with the max mask the main path's backward takes
    args = (vals, plan.rowptr, plan.fwd_senders, plan.fwd_w, prims)
    mkw = dict(masks=("max",), fwd_to_bwd=plan.fwd_to_bwd)
    outs = gr.gather_reduce_fwd(*args, **mkw)
    ref = gr.gather_reduce_fwd_plain(*args, **mkw)
    names = prims + ("max mask",)
    err = max(_close(f"gather_reduce_fwd[{p}]", o, r,
                     exact=p in ("max", "max mask"))
              for p, o, r in zip(names, outs, ref))
    check(all(torch.equal(a, b) for a, b in
              zip(outs, gr.gather_reduce_fwd(*args, **mkw))),
          "gather_reduce_fwd: two launches differ")
    check(all(torch.equal(a, b) for a, b in
              zip(outs, gr.gather_reduce_fwd(*args))),
          "gather_reduce_fwd: without the mask it differs")
    HELD["gather"] |= {(f, prims, ("max",)), (f, prims, ())}
    words = gr.mask_words(f)
    # vals, rowptr, senders and weights, the outputs, fwd_to_bwd, the mask
    nbytes = 4 * (n * f + (n + 1) + 2 * e + len(prims) * n * f + e
                  + words * e)
    b_ms, b_by = bound_ms(nbytes, 4.0 * e * f)
    # the same at full size on a 1/8 grid: ties at scale, re-swept rows
    ties = torch.round(vals * 8) / 8
    t_args = (ties,) + args[1:]
    t_out = gr.gather_reduce_fwd(*t_args, **mkw)
    t_ref = gr.gather_reduce_fwd_plain(*t_args, **mkw)
    _close("gather_reduce_fwd[max mask, 1/8 grid]", t_out[3], t_ref[3],
           exact=True)
    rows_f = gr._row_ids(plan.rowptr)
    held = torch.zeros(n, f, device=dev).index_add_(
        0, rows_f, (ties[plan.fwd_senders.long()] == t_ref[2][rows_f])
        .float())
    tied_rows = int((held > 1).any(1).sum())
    rows.append(dict(
        name="gather_reduce_fwd", route="cuda",
        source="egc_tpu_torch/csrc/gather_reduce.cu",
        replaces="egc_tpu/ops/pallas/gather_reduce.py:504",
        max_abs_err=err, ms=time_ms(lambda: gr.gather_reduce_fwd(
            *args, **mkw)),
        plain_ms=time_ms(lambda: gr.gather_reduce_fwd_plain(*args, **mkw)),
        bound_ms=b_ms, bound_by=b_by,
        floor_ms=floor_ms(nbytes, 4 * f, n, e, 4.0 * e * f),   # vals[s]
        gathered_bytes_per_edge=4 * f,
        ms_no_mask=time_ms(lambda: gr.gather_reduce_fwd(*args)),
        ms_ties=time_ms(lambda: gr.gather_reduce_fwd(*t_args, **mkw)),
        tied_rows=tied_rows,
        library_ms=None,
        library_note="no single PyTorch call computes sum, wsum and max"))
    log(f"[kernels] gather_reduce_fwd: on the 1/8 grid {tied_rows} of {n} "
        f"rows hold a tied maximum (re-swept); mask bitwise equal")

    # kernel 2: the main path's coefficients, the max mask from above
    coeffs = {k: torch.randn(n, f, generator=gen, device=dev)
              for k in ("c_sum", "c_wsum", "c_max")}
    bkw = dict(coeffs, edge_w=plan.bwd_w, max_mask=outs[3])
    bargs = (plan.colptr, plan.bwd_receivers)
    d_vals = gr.gather_reduce_bwd(*bargs, **bkw)
    err = _close("gather_reduce_bwd", d_vals,
                 gr.gather_reduce_bwd_plain(*bargs, **bkw))
    check(torch.equal(d_vals, gr.gather_reduce_bwd(*bargs, **bkw)),
          "gather_reduce_bwd: two launches differ")
    t_bkw = dict(bkw, max_mask=t_out[3])
    _close("gather_reduce_bwd[1/8 grid]", gr.gather_reduce_bwd(
        *bargs, **t_bkw), gr.gather_reduce_bwd_plain(*bargs, **t_bkw))
    # c_max is read by the 32-byte sector (8 floats) where a bit is set
    sectors = int(gr.unpack_mask(outs[3], f).view(e, f // 8, 8).any(-1)
                  .sum())
    # c_sum, c_wsum, c_max, colptr, receivers and weights, d_vals, mask
    nbytes = 4 * (3 * n * f + (n + 1) + 2 * e + n * f + words * e)
    b_ms, b_by = bound_ms(nbytes, 6.0 * e * f)
    rows.append(dict(
        name="gather_reduce_bwd", route="cuda",
        source="egc_tpu_torch/csrc/gather_reduce.cu",
        replaces="egc_tpu/ops/pallas/gather_reduce.py:839",
        max_abs_err=err, ms=time_ms(lambda: gr.gather_reduce_bwd(
            *bargs, **bkw)),
        plain_ms=time_ms(lambda: gr.gather_reduce_bwd_plain(*bargs, **bkw)),
        bound_ms=b_ms, bound_by=b_by,
        # every edge gathers the c_sum and c_wsum rows of r and the c_max
        # sectors its bits name (compulsory: c_max once, n * f floats)
        floor_ms=floor_ms(nbytes + 32 * sectors - 4 * n * f, 2 * 4 * f, n,
                          e, 6.0 * e * f),
        gathered_bytes_per_edge=2 * 4 * f + 32 * sectors / e + 4 * words,
        library_ms=None,
        library_note="no single PyTorch call computes this gradient"))
    log(f"[kernels] gather_reduce_bwd gathers per edge 2 x {4 * f} B "
        f"(c_sum, c_wsum) + {32 * sectors / e:.1f} B of c_max sectors "
        f"({sectors / (e * f // 8):.3f} of them) + {4 * words} B of mask")

    # kernels 1+2 through the autograd function vs the plain segment path
    aggrs = ("symnorm", "max", "mean")
    x1 = vals.clone().requires_grad_(True)
    x2 = vals.clone().requires_grad_(True)
    ct = torch.randn(n, len(aggrs), f, generator=gen, device=dev)
    y1 = fused_multi_aggregate(x1, plan, aggrs,
                               symnorm_self_w=g.self_weight)
    y2 = multi_aggregate(x2, g.senders, g.receivers, aggrs,
                         edge_mask=g.edge_mask,
                         symnorm_edge_w=g.edge_weight,
                         symnorm_self_w=g.self_weight)
    _close("fused_multi_aggregate", y1, y2)
    (y1 * ct).sum().backward()
    (y2 * ct).sum().backward()
    r = rel_l2(x1.grad, x2.grad)
    check(r <= GRAD_REL_L2, f"fused_multi_aggregate grad rel L2 {r}")
    log(f"[kernels] fused_multi_aggregate vs segment path: grad rel L2 {r:.3e}")

    # kernels 3 and 4
    O, HBA = H * L, H * B * A
    w2d = torch.randn(n, HBA, generator=gen, device=dev)
    ys = [torch.randn(n, B * L, generator=gen, device=dev) for _ in range(A)]
    bias = torch.randn(O, generator=gen, device=dev)
    dz = torch.randn(n, O, generator=gen, device=dev)
    kw = dict(H=H, B=B, A=A, L=L)
    check(hm.kernel_fwd_variant(ys, bias, L, B * L) == "vector",
          "headmix_fwd: the path's shape does not take the float4 variant")
    err = _close("headmix_fwd",
                 hm.headmix_fwd(w2d, ys, bias, y_width=B * L, **kw),
                 hm.headmix_fwd_plain(w2d, ys, bias, **kw))
    y_st = torch.stack(ys, 1).reshape(n, A, B, L)
    w4 = w2d.reshape(n, H, B, A)
    nbytes = 4 * (n * HBA + A * n * B * L + O + n * O)
    b_ms, b_by = bound_ms(nbytes, 2.0 * B * A * n * O)
    rows.append(dict(
        name="headmix_fwd", route="cuda", source="egc_tpu_torch/csrc/headmix.cu",
        replaces="egc_tpu/ops/pallas/headmix.py:146", max_abs_err=err,
        ms=time_ms(lambda: hm.headmix_fwd(w2d, ys, bias, y_width=B * L,
                                          **kw)),
        plain_ms=time_ms(lambda: hm.headmix_fwd_plain(w2d, ys, bias, **kw)),
        bound_ms=b_ms, bound_by=b_by, floor_ms=b_ms,   # dense: no gather
        library_ms=time_ms(lambda: torch.einsum("nhba,nabl->nhl", w4, y_st)),
        library_note="torch.einsum('nhba,nabl->nhl'), bias add excluded"))

    dw, dys = hm.headmix_bwd(w2d, ys, dz, y_width=B * L, **kw)
    check(hm.kernel_bwd_variant(ys, dys, dz, L, B * L) == "vector",
          "headmix_bwd: the path's shape does not take the float4 variant")
    dw_p, dys_p = hm.headmix_bwd_plain(w2d, ys, dz, y_width=B * L, **kw)
    err = max([_close("headmix_bwd[dw]", dw, dw_p)]
              + [_close(f"headmix_bwd[dy{a}]", d, p)
                 for a, (d, p) in enumerate(zip(dys, dys_p))])
    dw2, dys2 = hm.headmix_bwd(w2d, ys, dz, y_width=B * L, **kw)
    check(torch.equal(dw, dw2) and all(torch.equal(a, b)
                                       for a, b in zip(dys, dys2)),
          "headmix_bwd: two launches differ")
    nbytes = 4 * (2 * n * HBA + 2 * A * n * B * L + n * O)
    b_ms, b_by = bound_ms(nbytes, 4.0 * n * H * B * A * L)
    dz4 = dz.reshape(n, H, L)

    def einsum_pair():   # the einsum's backward: dw, then dy
        torch.einsum("nhl,nabl->nhba", dz4, y_st)
        torch.einsum("nhba,nhl->nabl", w4, dz4)

    rows.append(dict(
        name="headmix_bwd", route="cuda", source="egc_tpu_torch/csrc/headmix.cu",
        replaces="egc_tpu/ops/pallas/headmix.py:160", max_abs_err=err,
        ms=time_ms(lambda: hm.headmix_bwd(w2d, ys, dz, y_width=B * L, **kw)),
        plain_ms=time_ms(lambda: hm.headmix_bwd_plain(w2d, ys, dz,
                                                      y_width=B * L, **kw)),
        bound_ms=b_ms, bound_by=b_by, floor_ms=b_ms,
        library_ms=time_ms(einsum_pair),
        library_note="two calls: torch.einsum('nhl,nabl->nhba') for dw and "
                     "torch.einsum('nhba,nhl->nabl') for dy, unsplit"))

    # kernels 3+4 through the autograd function vs autograd of the plain
    _check_headmix_autograd(w2d, ys, bias, dz, H, B, A, L, B * L)
    HELD["headmix"].add((H, B, A, L))
    for row in rows:
        log(f"[kernels] {row['name']}: {row['ms']:.4f} ms (plain "
            f"{row['plain_ms']:.4f}, library {row['library_ms']}, bound "
            f"{row['bound_ms']:.4f} by {row['bound_by']}, floor "
            f"{row['floor_ms']:.4f}), max abs err {row['max_abs_err']:.3e}")
    return rows


def _check_headmix_autograd(w2d, ys, bias, dz, H, B, A, L, yw):
    from egc_tpu_torch.ops.cuda import headmix as hm

    def grads(fn):
        w = w2d.clone().requires_grad_(True)
        y = [t.clone().requires_grad_(True) for t in ys]
        b = bias.clone().requires_grad_(True)
        out = fn(w, y, b)
        out.backward(dz)
        return [out, w.grad, b.grad] + [t.grad for t in y]

    got = grads(lambda w, y, b: hm.head_mix_fused(
        w, y, H=H, B=B, A=A, L=L, y_width=yw, bias=b))
    ref = grads(lambda w, y, b: hm.headmix_fwd_plain(
        w, [t for t in y], b, H=H, B=B, A=A, L=L))
    _close("head_mix_fused", got[0], ref[0])
    for i, (a, b) in enumerate(zip(got[1:], ref[1:])):
        r = rel_l2(a, b)
        check(r <= GRAD_REL_L2, f"head_mix_fused grad {i} rel L2 {r}")


# (H, B, A, L, y_width, ys offset in floats, the variant of kernels 3
# and 4): A = 1 and 6, L = 34 (EGC-M h136 H4), H8 L44 (mag h352), y_width
# > B*L in both variants, H = 12 (a second and third pass of heads), L 3
HEADMIX_SMALL_SHAPES = ((4, 4, 1, 10, 40, 0, "tile"),
                        (2, 3, 2, 5, 24, 0, "tile"),
                        (2, 3, 2, 8, 32, 0, "vector"),
                        (4, 4, 3, 32, 128, 1, "tile"),
                        (4, 4, 6, 32, 128, 0, "vector"),
                        (4, 4, 3, 34, 136, 0, "tile"),
                        (8, 4, 3, 44, 176, 0, "vector"),
                        (4, 4, 3, 32, 132, 0, "vector"),
                        (1, 1, 1, 4, 4, 0, "vector"),
                        (12, 2, 2, 8, 20, 0, "vector"),
                        (1, 1, 1, 3, 5, 0, "tile"),
                        (12, 2, 2, 6, 14, 0, "tile"))


def kernels_small(dev) -> None:
    """Empty receivers, a hub receiver of 300 in-edges, ties (integer
    values, signed zeros) and the max / min masks bitwise, F = 40, 37, 136
    and 128, ``mask_words`` of the kernel and the wrapper; A = 1; the head
    mix's vector and tile variants."""
    import numpy as np
    import torch
    from egc_tpu_torch.graph.transforms import coalesce_np, symnorm_weight
    from egc_tpu_torch.ops.cuda import gather_reduce as gr
    from egc_tpu_torch.ops.cuda import headmix as hm
    from egc_tpu_torch.ops.dispatch import (
        build_kernel_plan, fused_multi_aggregate,
    )
    from egc_tpu_torch.ops.segment import multi_aggregate

    rng = np.random.default_rng(0)
    n = 1000
    hub = rng.choice(n, 300, replace=False)    # receiver 0: >= 300 in-edges
    s = np.concatenate([rng.integers(0, n, 6000), hub])
    r = np.concatenate([rng.integers(0, n - 50, 6000),   # 50 isolated
                        np.zeros(300, np.int64)])
    s, r, _ = coalesce_np(s, r, n)
    check(int((r == 0).sum()) >= 300, "small graph: hub degree")
    ew, sw = symnorm_weight(torch.as_tensor(s), torch.as_tensor(r), n)
    plan = build_kernel_plan(s, r, n, edge_weight=ew.numpy(), device=dev)
    st, rt = torch.as_tensor(s, device=dev), torch.as_tensor(r, device=dev)
    ew, sw = ew.to(dev), sw.to(dev)
    all_aggrs = ("sum", "mean", "max", "min", "var", "std", "symnorm")
    bad = [f for f in range(1, 600)
           if gr.kernel_mask_words(f) != gr.mask_words(f)]
    check(not bad, f"mask_words: kernel and wrapper differ at f = {bad}")
    for f in (40, 37, 136, 128):
        ints = rng.integers(-2, 3, size=(n, f)).astype(np.float32)
        ints[(ints == 0) & (rng.random((n, f)) < 0.5)] = -0.0   # -0 ties +0
        vals = torch.as_tensor(ints, device=dev)
        prims = gr.PRIMS
        args = (vals, plan.rowptr, plan.fwd_senders, plan.fwd_w, prims)
        mkw = dict(masks=gr.EXTREMA, fwd_to_bwd=plan.fwd_to_bwd)
        got = gr.gather_reduce_fwd(*args, **mkw)
        for p, o, ref in zip(prims + ("max mask", "min mask"), got,
                             gr.gather_reduce_fwd_plain(*args, **mkw)):
            _close(f"small fwd[{p}] f={f}", o, ref,
                   exact=p not in ("sum", "wsum", "sumsq"))
            if p in prims:
                check(bool((o[n - 50:] == 0).all()),
                      f"empty rows of {p} not 0")
        coeffs = {k: torch.as_tensor(rng.normal(size=(n, f)).astype(
            np.float32), device=dev) for k in gr.COEFFS}
        bkw = dict(coeffs, edge_w=plan.bwd_w, vals=vals, max_mask=got[5],
                   min_mask=got[6])
        bargs = (plan.colptr, plan.bwd_receivers)
        _close(f"small bwd f={f}", gr.gather_reduce_bwd(*bargs, **bkw),
               gr.gather_reduce_bwd_plain(*bargs, **bkw))
        for include_self in (False, True):
            ct = torch.as_tensor(rng.normal(size=(n, len(all_aggrs), f))
                                 .astype(np.float32), device=dev)
            x1 = vals.clone().requires_grad_(True)
            x2 = vals.clone().requires_grad_(True)
            y1 = fused_multi_aggregate(x1, plan, all_aggrs,
                                       include_self=include_self,
                                       symnorm_self_w=sw)
            y2 = multi_aggregate(x2, st, rt, all_aggrs,
                                 include_self=include_self,
                                 symnorm_edge_w=ew, symnorm_self_w=sw)
            _close(f"small fused f={f} self={include_self}", y1, y2)
            (y1 * ct).sum().backward()
            (y2 * ct).sum().backward()
            rr = rel_l2(x1.grad, x2.grad)
            check(rr <= GRAD_REL_L2, f"small fused grad rel L2 {rr}")
    # head mix: both variants of kernels 3 and 4 at the shapes above; ys
    # at a 4-byte offset force the tile ones
    for H, B, A, L, yw, offset, variant in HEADMIX_SMALL_SHAPES:
        shape = (H, B, A, L, yw, offset)
        w2d = torch.randn(n, H * B * A, device=dev)
        bufs = [torch.randn(n * yw + 4, device=dev) for _ in range(A)]
        ys = [b[offset:offset + n * yw].view(n, yw) for b in bufs]
        bias = torch.randn(H * L, device=dev)
        dz = torch.randn(n, H * L, device=dev)
        ptrs = [y.data_ptr() for y in ys] + [bias.data_ptr()]
        got = (hm.fwd_variant(L, yw, ptrs),
               hm.kernel_fwd_variant(ys, bias, L, yw))
        check(got == (variant, variant),
              f"headmix_fwd {shape}: variant (rule, kernel) {got}, "
              f"expected {variant}")
        kw = dict(H=H, B=B, A=A, L=L)
        _close(f"headmix_fwd {shape}",
               hm.headmix_fwd(w2d, ys, bias, y_width=yw, **kw),
               hm.headmix_fwd_plain(w2d, ys, bias, **kw))
        _check_headmix_autograd(w2d, ys, bias, dz, H, B, A, L, yw)
        dw, dys = hm.headmix_bwd(w2d, ys, dz, y_width=yw, **kw)
        ptrs = [t.data_ptr() for t in ys + list(dys) + [dz]]
        got = (hm.bwd_variant(L, yw, ptrs),
               hm.kernel_bwd_variant(ys, dys, dz, L, yw))
        check(got == (variant, variant),
              f"headmix_bwd {shape}: variant (rule, kernel) {got}, "
              f"expected {variant}")
        dw_p, dys_p = hm.headmix_bwd_plain(w2d, ys, dz, y_width=yw, **kw)
        _close(f"headmix_bwd {shape} dw", dw, dw_p)
        for a, (d, p) in enumerate(zip(dys, dys_p)):
            _close(f"headmix_bwd {shape} dy{a}", d, p)
        check(all(bool((d[:, B * L:] == 0).all()) for d in dys),
              f"headmix_bwd {shape}: dy tail not zero")
    torch.cuda.synchronize()
    log("[kernels] small-size checks passed (empty rows, a 300-in-edge hub, "
        "ties, masks bitwise, F=40/37/136/128, "
        "A=1, head mix (H, B, A, L, y_width, offset) = "
        f"{[sh[:6] for sh in HEADMIX_SMALL_SHAPES]}, vector and tile "
        "variants of kernels 3 and 4)")


# the masked BatchNorm kernels (ops/cuda/batch_norm) off the arxiv shape:
# (rows, F, mask, float offset of x in its buffer); N = 1, all rows masked,
# the readout MLP's h/4 = 34 (scalar variant) and h/2 = 68, 68 on a view
# 4 bytes off 16-byte alignment (scalar), and 352 (MagNet's width)
BN_SMALL = ((1, 136, "none", 0), (1, 34, "masked", 0),
            (128, 34, "some", 0), (128, 68, "some", 0),
            (128, 68, "masked", 0), (1000, 68, "some", 1),
            (2000, 352, "none", 0), (57, 136, "some", 0))
BN_F = 136     # arxiv EGC-M's width (the benchmark's egc_m_arxiv)


def _bn_depth(n: int, f: int, vector: bool) -> int:
    """The additions that a term of a BatchNorm kernel's column sum passes
    through at most: a thread's rows, then its block's R threads, then the
    blocks' partials (``batch_norm.grid``; ``csrc/batch_norm.cu``)."""
    from egc_tpu_torch.ops.cuda import batch_norm as bn
    blocks, rpb = bn.grid(n, f, vector, bn.SUM_BLOCKS)
    rows = bn.THREADS // min(f // 4 if vector else f, bn.THREADS)
    return -(-rpb // rows) + rows + blocks


def _bn_sums_close(name, got, exact, abs_sums, depth: int) -> float:
    """f32 column sums ``got`` against their float64 values ``exact``
    within gamma_depth times ``abs_sums``, the sum of the terms'
    magnitudes: the worst-case error when each term passes through at
    most ``depth`` roundings (``_bn_depth``, plus those that form it)."""
    import torch
    gamma = depth * F32_U / (1 - depth * F32_U)
    err = (got.double() - exact).abs()
    over = err > gamma * abs_sums + torch.finfo(torch.float32).tiny
    check(not bool(over.any()),
          f"{name}: {int(over.sum())} sums beyond gamma_{depth} sum |terms| "
          f"(max abs err {float(err.max())})")
    return float(err.max()) if err.numel() else 0.0


def _bn_case(x, mask, gen, label: str, timed: bool = False) -> dict:
    """The four BatchNorm kernels on ``x`` (and ``mask``) against their
    plain versions: the sums against their float64 values within the
    worst-case f32 error of the kernels' order of addition,
    ``bn_apply`` and ``bn_apply_bwd`` to the bit on the kernels' own
    statistics and sums, two launches of each bitwise; with ``timed``,
    kernel, plain and library times."""
    import torch
    from egc_tpu_torch.ops.cuda import batch_norm as bn
    dev = x.device
    n, f = x.shape
    m = torch.ones(n, device=dev) if mask is None else mask.float()
    w = torch.randn(f, generator=gen, device=dev)
    b = torch.randn(f, generator=gen, device=dev)
    g = torch.randn(n, f, generator=gen, device=dev)
    rm = torch.randn(f, generator=gen, device=dev)
    rv = torch.rand(f, generator=gen, device=dev) + 0.5
    nbt = torch.tensor(5, device=dev)
    vec = bn.variant(f, [x.data_ptr()])
    depth = _bn_depth(n, f, vec == "vector")
    errs = {}
    stats = bn._launch_stats(x, mask)
    xd, md = x.double(), m.double()[:, None]
    errs["bn_stats"] = max(
        _bn_sums_close(f"bn_stats[{label}] s", stats[:f], (xd * md).sum(0),
                       (xd.abs() * md).sum(0), depth),
        _bn_sums_close(f"bn_stats[{label}] ssq", stats[f:2 * f],
                       (xd * xd * md).sum(0), (xd * xd * md).sum(0),
                       depth + 1))
    valid = float(m.sum())
    check(float(stats[2 * f]) == valid, f"bn_stats[{label}]: n "
          f"{float(stats[2 * f])} against {valid}")
    check(torch.equal(bn._launch_stats(x, mask), stats),
          f"bn_stats[{label}]: two launches differ")

    runs = []
    for _ in range(2):
        state = (rm.clone(), rv.clone(), nbt.clone())
        runs.append((bn._launch_apply(x, stats, w, b, *state), state))
    plain = (rm.clone(), rv.clone(), nbt.clone())
    y_ref = bn.apply_plain(x, stats, w, b, *plain)
    (y, state), (y2, state2) = runs
    check(torch.equal(y, y_ref) and all(torch.equal(a, c) for a, c in
                                        zip(state, plain)),
          f"bn_apply[{label}]: not equal to the plain version (max err "
          f"{float((y - y_ref).abs().max())})")
    check(torch.equal(y, y2) and all(torch.equal(a, c) for a, c in
                                     zip(state, state2)),
          f"bn_apply[{label}]: two launches differ")
    ye = bn._launch_apply(x, None, w, b, rm, rv, None)
    check(torch.equal(ye, bn.apply_plain(x, None, w, b, rm, rv, None)),
          f"bn_apply[{label}] eval: not equal to the plain version")
    errs["bn_apply"] = 0.0

    sums = bn._launch_grad_sums(g, x, stats, None, None, w)
    sums_ref = bn.grad_sums_plain(g, x, stats, None, None, w)
    mean, _, r, _, _ = bn._columns(stats, None, None, f)
    gd, rd = g.double(), r.double()
    terms = gd * (xd - mean.double())
    del xd, md
    errs["bn_grad_sums"] = max(
        _bn_sums_close(f"bn_grad_sums[{label}] dbias", sums[1], gd.sum(0),
                       gd.abs().sum(0), depth),
        _bn_sums_close(f"bn_grad_sums[{label}] dweight", sums[0],
                       rd * terms.sum(0), rd.abs() * terms.abs().sum(0),
                       depth + 3))
    del gd, terms
    gap = rel_l2(sums[2], sums_ref[2])
    check(gap <= 1e-3, f"bn_grad_sums[{label}]: (ds, dssq) at relative L2 "
                       f"{gap}")
    check(all(torch.equal(a, c) for a, c in zip(
        sums, bn._launch_grad_sums(g, x, stats, None, None, w))),
        f"bn_grad_sums[{label}]: two launches differ")
    dx = bn._launch_apply_bwd(g, x, mask, stats, None, None, w, sums[2])
    dx_ref = bn.apply_bwd_plain(g, x, mask, stats, None, None, w, sums[2])
    check(torch.equal(dx, dx_ref),
          f"bn_apply_bwd[{label}]: not equal to the plain version (max err "
          f"{float((dx - dx_ref).abs().max())})")
    check(torch.equal(dx, bn._launch_apply_bwd(g, x, mask, stats, None, None,
                                               w, sums[2])),
          f"bn_apply_bwd[{label}]: two launches differ")
    es = bn._launch_grad_sums(g, x, None, rm, rv, w)
    dxe = bn._launch_apply_bwd(g, x, mask, None, rm, rv, w, es[2])
    check(torch.equal(dxe, bn.apply_bwd_plain(g, x, mask, None, rm, rv, w,
                                              es[2])),
          f"bn_apply_bwd[{label}] eval: not equal to the plain version")
    errs["bn_apply_bwd"] = 0.0
    out = {"label": label, "n": n, "f": f, "variant": vec,
           "max_abs_err": errs, "ds_dssq_rel_l2": gap}
    if not timed:
        return out
    import torch.nn.functional as F
    arr = 4.0 * n * f
    mbytes = 0 if mask is None else n
    state = (rm.clone(), rv.clone(), nbt.clone())
    kern = {
        "bn_stats": (lambda: bn._launch_stats(x, mask),
                     lambda: bn.stats_plain(x, mask), arr + mbytes),
        "bn_apply": (lambda: bn._launch_apply(x, stats, w, b, *state),
                     lambda: bn.apply_plain(x, stats, w, b, *state),
                     2 * arr),
        "bn_grad_sums": (
            lambda: bn._launch_grad_sums(g, x, stats, None, None, w),
            lambda: bn.grad_sums_plain(g, x, stats, None, None, w), 2 * arr),
        "bn_apply_bwd": (
            lambda: bn._launch_apply_bwd(g, x, mask, stats, None, None, w,
                                         sums[2]),
            lambda: bn.apply_bwd_plain(g, x, mask, stats, None, None, w,
                                       sums[2]), 3 * arr + mbytes)}
    # the library yardstick, never called by the port: unmasked BatchNorm
    # forward (the pair stats + apply) and backward (grad_sums + apply_bwd)
    xl = x.detach().clone().requires_grad_(True)
    lib_rm, lib_rv = rm.clone(), rv.clone()

    def lib_fwd():
        return F.batch_norm(xl, lib_rm, lib_rv, w, b, training=True)

    yl = lib_fwd()
    library = {"forward": time_ms(lambda: lib_fwd().detach()),
               "backward": time_ms(lambda: torch.autograd.grad(
                   yl, xl, g, retain_graph=True))}
    out["rows"] = {}
    for name, (k_fn, p_fn, nbytes) in kern.items():
        bound, by = bound_ms(nbytes, 4.0 * n * f)   # ~4 flops an element
        out["rows"][name] = {"ms": time_ms(k_fn), "plain_ms": time_ms(p_fn),
                             "bound_ms": bound, "bound_by": by}
    out["library_ms"] = library
    return out


def kernels_batch_norm(data) -> tuple:
    """The masked BatchNorm kernels against their plain versions at the
    arxiv shape (the graph's padded rows under its node mask, F = 136),
    timed, and at ``BN_SMALL``; returns the four kernel rows (their
    ``library_ms``: ``F.batch_norm``'s whole forward, unmasked, beside
    ``bn_stats`` and ``bn_apply``, its backward beside the other two) and
    the library times and small cases."""
    import torch
    dev = data["device"]
    gen = torch.Generator(device=dev).manual_seed(23)
    mask = data["graph"].node_mask
    n = mask.shape[0]
    x = torch.randn(n, BN_F, generator=gen, device=dev) * 2 + 0.5
    main = _bn_case(x, mask, gen, "arxiv", timed=True)
    del x
    rows = []
    for name, row in main["rows"].items():
        rows.append({"name": name, "route": "CUDA",
                     "source": "csrc/batch_norm.cu",
                     "replaces": "none (XLA's fusion in the JAX package)",
                     "variant": main["variant"],
                     "max_abs_err": main["max_abs_err"][name],
                     "floor_ms": row["bound_ms"],
                     "library_ms": main["library_ms"][
                         "forward" if name in ("bn_stats", "bn_apply")
                         else "backward"], **row})
        log(f"[bn] {name} arxiv ({n} x {BN_F}, {main['variant']}): "
            f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} "
            f"({row['bound_by']}), plain {row['plain_ms']:.4f}, max abs "
            f"err {main['max_abs_err'][name]:.3g}")
    log(f"[bn] library F.batch_norm, no mask: forward "
        f"{main['library_ms']['forward']:.4f} ms, backward "
        f"{main['library_ms']['backward']:.4f} ms; (ds, dssq) rel L2 "
        f"{main['ds_dssq_rel_l2']:.3g}")
    small = []
    for n_rows, f, kind, off in BN_SMALL:
        base = torch.randn(n_rows * f + off, generator=gen, device=dev)
        x = base[off:].view(n_rows, f)
        mask = None if kind == "none" else (
            torch.zeros(n_rows, dtype=torch.bool, device=dev)
            if kind == "masked"
            else torch.rand(n_rows, generator=gen, device=dev) < 0.7)
        small.append(_bn_case(x, mask, gen, f"{n_rows}x{f} {kind}"
                              f"{' offset' if off else ''}"))
        log(f"[bn] {small[-1]['label']} ({small[-1]['variant']}): ok")
    check({c["variant"] for c in small} == {"vector", "scalar"},
          "[bn] the small cases miss a variant")
    return rows, {"library_ms": main["library_ms"], "small": small}


def check_segment_gather_reduce(data) -> dict:
    """``segment_gather_reduce`` (kernel 1 behind a COO entry, with its row
    pointer build and input checks) against its plain version at the main
    path's shapes, timed; beside it ``torch.sparse.mm`` of the plan's CSR
    (ones) with ``vals``, its default instantiation (a sum), held against
    the kernel's sum and timed as ``library_ms``."""
    import torch
    from egc_tpu_torch.ops.cuda import gather_reduce as gr
    plan = data["graph"].kernel_plan
    n = plan.num_nodes
    vals = torch.randn(n, 128, generator=torch.Generator(
        device=data["device"]).manual_seed(2), device=data["device"])
    ops = ("sum", "wsum", "max")
    args = (vals, plan.fwd_senders, gr._row_ids(plan.rowptr))
    kw = dict(num_out_rows=n, ops=ops, edge_w=plan.fwd_w)
    got = gr.segment_gather_reduce(*args, **kw)
    ref = gr.gather_reduce_fwd_plain(vals, plan.rowptr, plan.fwd_senders,
                                     plan.fwd_w, ops)
    err = max(_close(f"segment_gather_reduce[{p}]", a, b)
              for p, a, b in zip(ops, got, ref))
    e = plan.num_edges
    nbytes = 4 * (n * 128 + 3 * e + len(ops) * n * 128)
    b_ms, b_by = bound_ms(nbytes, 4.0 * e * 128)
    res = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
               floor_ms=floor_ms(nbytes, 4 * 128, n, e, 4.0 * e * 128),
               ms=time_ms(lambda: gr.segment_gather_reduce(*args, **kw)),
               plain_ms=time_ms(lambda: gr.gather_reduce_fwd_plain(
                   vals, plan.rowptr, plan.fwd_senders, plan.fwd_w, ops)))
    csr = torch.sparse_csr_tensor(plan.rowptr.long(),
                                  plan.fwd_senders.long(),
                                  torch.ones(e, device=vals.device),
                                  size=(n, n))
    sum_only = gr.segment_gather_reduce(*args, num_out_rows=n)[0]
    r = rel_l2(torch.sparse.mm(csr, vals), sum_only)
    check(r <= GRAD_REL_L2, f"torch.sparse.mm vs segment_gather_reduce's "
                            f"sum: rel L2 {r}")
    res.update(library_ms=time_ms(lambda: torch.sparse.mm(csr, vals)),
               sum_ms=time_ms(lambda: gr.segment_gather_reduce(
                   *args, num_out_rows=n)))
    log(f"[kernels] segment_gather_reduce: {res['ms']:.4f} ms (plain "
        f"{res['plain_ms']:.4f}, bound {b_ms:.4f} by {b_by}, floor "
        f"{res['floor_ms']:.4f}), max abs err {err:.3e}; its default "
        f"instantiation (sum) {res['sum_ms']:.4f} ms, torch.sparse.mm "
        f"{res['library_ms']:.4f} ms (rel L2 {r:.2e})")
    return res


_COEFF = {"sum": "c_sum", "wsum": "c_wsum", "sumsq": "c_sumsq2",
          "max": "c_max", "min": "c_min"}
_PRIM_OPS = {"sum": 1, "wsum": 2, "sumsq": 2, "max": 1, "min": 1}


def kernels_zoo_shapes(data) -> dict:
    """Kernels 1 and 2 against their plain versions in the instantiation
    each conv-zoo path runs (``ZOO_SHAPES``: GCN wsum at F = 156, GIN sum
    at 156, SAGE sum at 115 (a lane of one column), MPNN sum and max at
    116, PNA sum / sumsq / max / min at 76 with both masks), at the arxiv
    shape (``_gather_entries``). Returns the entries by kernel."""
    import torch
    gen = torch.Generator(device=data["device"]).manual_seed(12)
    return _gather_entries(data["graph"].kernel_plan, ZOO_SHAPES, gen)


def _gather_entries(plan, shapes: dict, gen, out: dict = None,
                    long_sums: bool = False) -> dict:
    """Kernels 1 and 2 against their plain versions on ``plan`` in each
    instantiation of ``shapes`` (path -> (F, primitives, masks)): the
    values at ``SUM_RTOL``, the extrema and masks bitwise, the backward
    from the path's coefficients (and masks) at ``GRAD_REL_L2``, two
    launches of each bitwise; timed, with the bound and, in a direction
    whose gathered rows exceed the L2 (``L2_BYTES``; not a batch's, nor
    rmag's institution or field_of_study rows), the gathered-bytes floor
    (else null). A bipartite plan gathers its
    ``src_rows`` sender rows into its ``num_nodes`` receiver rows. A sum
    (or wsum) alone is one sparse product: ``torch.sparse.mm`` of the
    plan's CSR (CSC for the backward) is timed beside it as
    ``library_ms`` (else null). ``long_sums``: the sums are held to their
    f32 error bound (``_close_sums``) in place of ``SUM_RTOL``. A plan
    built on the card keeps its masked edges past ``rowptr[N]``: the
    kernels read the ``e = rowptr[N]`` edges before them, which the
    bounds count and the masks are held on. Appends the entries by kernel
    to ``out``."""
    import torch
    from egc_tpu_torch.ops.cuda import gather_reduce as gr
    n_src, n, e = plan.src_rows, plan.num_nodes, int(plan.rowptr[-1])
    dev = plan.rowptr.device
    out = out if out is not None else \
        {"gather_reduce_fwd": [], "gather_reduce_bwd": []}
    for path, (f, prims, masks) in shapes.items():
        label = f"{path} F={f} {'/'.join(prims)}"
        vals = torch.randn(n_src, f, generator=gen, device=dev)
        ew_f = ew_b = None
        if "wsum" in prims:
            ew_f, ew_b = plan.fwd_w, plan.bwd_w
            if ew_f is None:   # a batch plan: weights in edge order, as
                # ops/dispatch permutes symnorm's into both layouts
                w = torch.rand(int(plan.fwd_perm.max()) + 1, generator=gen,
                               device=dev)
                ew_f = w[plan.fwd_perm].contiguous()
                ew_b = w[plan.bwd_perm].contiguous()
        args = (vals, plan.rowptr, plan.fwd_senders, ew_f, prims)
        mkw = dict(masks=masks, fwd_to_bwd=plan.fwd_to_bwd) if masks \
            else {}
        got = gr.gather_reduce_fwd(*args, **mkw)
        ref = gr.gather_reduce_fwd_plain(*args, **mkw)
        names = prims + tuple(f"{m} mask" for m in masks)
        # a mask's words past the e edges are not the kernel's to write
        got, ref = ([t[:e] if p.endswith("mask") else t
                     for p, t in zip(names, res)] for res in (got, ref))
        sums = ("sum", "wsum", "sumsq")
        if long_sums:
            deg = (plan.rowptr[1:] - plan.rowptr[:-1]).double()
            sum_prims = tuple(p for p in prims if p in sums)
            abs_sums = dict(zip(sum_prims, gr.gather_reduce_fwd_plain(
                vals.abs(), plan.rowptr, plan.fwd_senders,
                None if ew_f is None else ew_f.abs(), sum_prims)))
        err = max(_close_sums(f"gather_reduce_fwd[{label}: {p}]", o, r,
                              abs_sums[p], deg)
                  if long_sums and p in sums else
                  _close(f"gather_reduce_fwd[{label}: {p}]", o, r,
                         exact=p not in sums)
                  for p, o, r in zip(names, got, ref))
        abs_sums = deg = None
        check(all(torch.equal(a, b[:a.shape[0]]) for a, b in
                  zip(got, gr.gather_reduce_fwd(*args, **mkw))),
              f"gather_reduce_fwd[{label}]: two launches differ")
        check(all(torch.equal(a, b) for a, b in
                  zip(got, gr.gather_reduce_fwd(*args))),
              f"gather_reduce_fwd[{label}]: without the masks it differs")
        words = gr.mask_words(f)
        w = 1 if ew_f is not None else 0
        # vals, rowptr, senders (and weights), the outputs, fwd_to_bwd once
        # (one CSC position an edge serves every mask), the mask words
        nbytes = 4 * (n_src * f + (n + 1) + (1 + w) * e
                      + len(prims) * n * f + (e if masks else 0)
                      + words * e * len(masks))
        ops = sum(_PRIM_OPS[p] for p in prims) * e * f
        b_ms, b_by = bound_ms(nbytes, ops)
        fwd_floor = 4 * n_src * f > L2_BYTES
        fwd = dict(path=path, f=f, prims=list(prims), masks=list(masks),
                   n_src=n_src, n_dst=n, edges=e, max_abs_err=err,
                   ms=time_ms(lambda: gr.gather_reduce_fwd(*args, **mkw)),
                   plain_ms=time_ms(lambda: gr.gather_reduce_fwd_plain(
                       *args, **mkw)),
                   bound_ms=b_ms, bound_by=b_by,
                   floor_ms=floor_ms(nbytes, 4 * f, n_src, e, ops)
                   if fwd_floor else None, library_ms=None)
        out["gather_reduce_fwd"].append(fwd)

        coeffs = {_COEFF[p]: torch.randn(n, f, generator=gen, device=dev)
                  for p in prims}
        bkw = dict(coeffs)
        if "wsum" in prims:
            bkw["edge_w"] = ew_b
        if "sumsq" in prims:
            bkw["vals"] = vals
        for m, words_t in zip(masks, got[len(prims):]):
            bkw[f"{m}_mask"] = torch.nn.functional.pad(
                words_t, (0, 0, 0, plan.num_edges - e))
        bargs = (plan.colptr, plan.bwd_receivers)
        d_vals = gr.gather_reduce_bwd(*bargs, **bkw)
        d_ref = gr.gather_reduce_bwd_plain(*bargs, **bkw)
        r = rel_l2(d_vals, d_ref)
        check(r <= GRAD_REL_L2, f"gather_reduce_bwd[{label}]: rel L2 {r}")
        check(torch.equal(d_vals, gr.gather_reduce_bwd(*bargs, **bkw)),
              f"gather_reduce_bwd[{label}]: two launches differ")
        # the coefficients, colptr, receivers (and weights), vals (sumsq),
        # d_vals, the masks
        nbytes = 4 * (len(coeffs) * n * f + (n_src + 1) + (1 + w) * e
                      + ("sumsq" in prims) * n_src * f + n_src * f
                      + words * e * len(masks))
        ops = 2.0 * len(coeffs) * e * f
        b_ms, b_by = bound_ms(nbytes, ops)
        # each edge gathers the rows of r of every coefficient not masked,
        # and of c_max / c_min the 32-byte sectors its bits name
        # (compulsory: those once, n * f floats each)
        dense = len(coeffs) - len(masks)
        sectors = 0
        for words_t in got[len(prims):]:
            bits = gr.unpack_mask(words_t, f)
            bits = torch.nn.functional.pad(bits, (0, -f % 8))
            sectors += int(bits.view(e, -1, 8).any(-1).sum())
            del bits
        bwd_floor = 4 * n * f * max(dense, 1) > L2_BYTES
        bwd = dict(
            path=path, f=f, prims=list(prims), masks=list(masks),
            n_src=n_src, n_dst=n, edges=e,
            max_abs_err=float((d_vals - d_ref).abs().max()), rel_l2=r,
            ms=time_ms(lambda: gr.gather_reduce_bwd(*bargs, **bkw)),
            plain_ms=time_ms(lambda: gr.gather_reduce_bwd_plain(
                *bargs, **bkw)),
            bound_ms=b_ms, bound_by=b_by,
            floor_ms=floor_ms(nbytes + 32 * sectors - 4 * n * f * len(masks),
                              4 * f * dense, n, e, ops) if bwd_floor
            else None,
            gathered_bytes_per_edge=4 * f * dense + 32 * sectors / e
            + 4 * words * len(masks), library_ms=None)
        out["gather_reduce_bwd"].append(bwd)
        if prims in (("sum",), ("wsum",)) and not masks:
            _library_entries(plan, prims[0], ew_f, ew_b, vals, got[0],
                             coeffs[_COEFF[prims[0]]], d_vals, fwd, bwd)
        HELD["gather"] |= {(f, tuple(prims), tuple(masks)),
                           (f, tuple(prims), ())}
        for name in GATHER:
            sh = out[name][-1]
            floor = "null" if sh["floor_ms"] is None \
                else f"{sh['floor_ms']:.4f}"
            lib = "" if sh["library_ms"] is None \
                else f", torch.sparse.mm {sh['library_ms']:.4f}"
            log(f"[kernels] {name} {label} (rows {n_src} -> {n}, E {e}): "
                f"{sh['ms']:.4f} ms (plain {sh['plain_ms']:.4f}{lib}, bound "
                f"{sh['bound_ms']:.4f} by {sh['bound_by']}, floor {floor}), "
                f"max abs err {sh['max_abs_err']:.3e}")
        del vals, got, ref, coeffs, bkw, d_vals, d_ref
    return out


def _library_entries(plan, prim, ew_f, ew_b, vals, out, coeff, d_vals,
                     fwd: dict, bwd: dict) -> None:
    """A sum or wsum alone is a sparse product: ``torch.sparse.mm`` of the
    plan's CSR [receivers, senders] with ``vals`` is the forward, of its
    CSC (the transposed CSR) with the coefficient the backward. Both are
    held against the kernels' results (relative L2 ``GRAD_REL_L2``) and
    timed into the entries' ``library_ms``."""
    import torch
    n_src, n, e = plan.src_rows, plan.num_nodes, int(plan.rowptr[-1])
    ones = torch.ones(e, device=vals.device)
    a = torch.sparse_csr_tensor(
        plan.rowptr.long(), plan.fwd_senders[:e].long(),
        ew_f[:e] if prim == "wsum" else ones, size=(n, n_src))
    at = torch.sparse_csr_tensor(
        plan.colptr.long(), plan.bwd_receivers[:e].long(),
        ew_b[:e] if prim == "wsum" else ones, size=(n_src, n))
    for label, mat, x, want, entry in (("fwd", a, vals, out, fwd),
                                       ("bwd", at, coeff, d_vals, bwd)):
        r = rel_l2(torch.sparse.mm(mat, x), want)
        check(r <= GRAD_REL_L2,
              f"torch.sparse.mm ({label}, {entry['path']}) vs the kernel: "
              f"rel L2 {r}")
        entry["library_ms"] = time_ms(lambda: torch.sparse.mm(mat, x))


def _headmix_entries(path: str, n: int, shape, gen, dev) -> tuple:
    """Kernels 3 and 4 against their plain versions at ``shape`` = (H, B,
    A, L) on ``n`` rows: the variant of each (rule and kernel) the one
    ``fwd_variant`` / ``bwd_variant`` give for contiguous tensors, values at
    ``SUM_RTOL``, the autograd function's gradients at ``GRAD_REL_L2``, two
    launches bitwise; timed beside their plain versions and the einsum
    calls, with the bound. Returns the (forward, backward) entries."""
    import torch
    from egc_tpu_torch.ops.cuda import headmix as hm
    H, B, A, L = shape
    O, HBA, yw = H * L, H * B * A, B * L
    w2d = torch.randn(n, HBA, generator=gen, device=dev)
    ys = [torch.randn(n, yw, generator=gen, device=dev) for _ in range(A)]
    bias = torch.randn(O, generator=gen, device=dev)
    dz = torch.randn(n, O, generator=gen, device=dev)
    kw = dict(H=H, B=B, A=A, L=L)
    label = f"{path} H{H} B{B} A{A} L{L}"
    want = hm.fwd_variant(L, yw, [y.data_ptr() for y in ys]
                          + [bias.data_ptr()])
    got_v = hm.kernel_fwd_variant(ys, bias, L, yw)
    check(got_v == want, f"headmix_fwd {label}: kernel variant {got_v}, "
                         f"rule {want}")
    z = hm.headmix_fwd(w2d, ys, bias, y_width=yw, **kw)
    err_f = _close(f"headmix_fwd {label}", z,
                   hm.headmix_fwd_plain(w2d, ys, bias, **kw))
    check(torch.equal(z, hm.headmix_fwd(w2d, ys, bias, y_width=yw, **kw)),
          f"headmix_fwd {label}: two launches differ")
    dw, dys = hm.headmix_bwd(w2d, ys, dz, y_width=yw, **kw)
    want_b = hm.bwd_variant(L, yw, [t.data_ptr() for t in ys + list(dys)
                                    + [dz]])
    got_b = hm.kernel_bwd_variant(ys, dys, dz, L, yw)
    check(got_b == want_b and want_b == want,
          f"headmix_bwd {label}: kernel variant {got_b}, rule {want_b}")
    dw_p, dys_p = hm.headmix_bwd_plain(w2d, ys, dz, y_width=yw, **kw)
    err_b = max([_close(f"headmix_bwd {label} dw", dw, dw_p)]
                + [_close(f"headmix_bwd {label} dy{a}", d, p)
                   for a, (d, p) in enumerate(zip(dys, dys_p))])
    dw2, dys2 = hm.headmix_bwd(w2d, ys, dz, y_width=yw, **kw)
    check(torch.equal(dw, dw2) and all(torch.equal(a, b)
                                       for a, b in zip(dys, dys2)),
          f"headmix_bwd {label}: two launches differ")
    _check_headmix_autograd(w2d, ys, bias, dz, H, B, A, L, yw)
    HELD["headmix"].add((H, B, A, L))
    y_st = torch.stack(ys, 1).reshape(n, A, B, L)
    w4 = w2d.reshape(n, H, B, A)
    dz4 = dz.reshape(n, H, L)

    def einsum_pair():
        torch.einsum("nhl,nabl->nhba", dz4, y_st)
        torch.einsum("nhba,nhl->nabl", w4, dz4)

    common = dict(path=path, H=H, B=B, A=A, L=L, n=n, variant=want)
    b_ms, b_by = bound_ms(4 * (n * HBA + A * n * yw + O + n * O),
                          2.0 * B * A * n * O)
    fwd = dict(common, max_abs_err=err_f, bound_ms=b_ms, bound_by=b_by,
               ms=time_ms(lambda: hm.headmix_fwd(w2d, ys, bias, y_width=yw,
                                                 **kw)),
               plain_ms=time_ms(lambda: hm.headmix_fwd_plain(w2d, ys, bias,
                                                             **kw)),
               library_ms=time_ms(lambda: torch.einsum("nhba,nabl->nhl", w4,
                                                       y_st)))
    b_ms, b_by = bound_ms(4 * (2 * n * HBA + 2 * A * n * yw + n * O),
                          4.0 * n * H * B * A * L)
    bwd = dict(common, max_abs_err=err_b, bound_ms=b_ms, bound_by=b_by,
               ms=time_ms(lambda: hm.headmix_bwd(w2d, ys, dz, y_width=yw,
                                                 **kw)),
               plain_ms=time_ms(lambda: hm.headmix_bwd_plain(
                   w2d, ys, dz, y_width=yw, **kw)),
               library_ms=time_ms(einsum_pair))
    for name, sh in (("headmix_fwd", fwd), ("headmix_bwd", bwd)):
        log(f"[kernels] {name} {label} ({want} variant, n {n}): "
            f"{sh['ms']:.4f} ms (plain {sh['plain_ms']:.4f}, einsum "
            f"{sh['library_ms']:.4f}, bound {sh['bound_ms']:.4f} by "
            f"{sh['bound_by']}), max abs err {sh['max_abs_err']:.3e}")
    return fwd, bwd


def kernels_path_shapes(batches: dict, mag_plan) -> dict:
    """Kernels 1-4 in the instantiation each phase-4 EGC path runs: the
    gather-reduce pair (``NEW_GATHER``) on a batch of each batched path
    and at mag's full shape, and the head mix (``PATH_HEADMIX``) on the
    same rows. Returns the entries by kernel (the rows' ``paths``)."""
    import torch
    dev = mag_plan.rowptr.device
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {"gather_reduce_fwd": [], "gather_reduce_bwd": [],
           "headmix_fwd": [], "headmix_bwd": []}
    for path, plan in list(batches.items()) + [("mag", mag_plan)]:
        # a batch's gathered rows (<= 7 k x 224 f32) fit in the 50 MB L2:
        # no gathered floor; mag's (736 k x 176 f32, 518 MB) do not
        _gather_entries(plan, {path: NEW_GATHER[path]}, gen, out=out)
        fwd, bwd = _headmix_entries(path, plan.num_nodes,
                                    PATH_HEADMIX[path], gen, dev)
        out["headmix_fwd"].append(fwd)
        out["headmix_bwd"].append(bwd)
    torch.cuda.synchronize()
    return out


def kernels_cli_shapes(plans: dict) -> dict:
    """Kernels 1-4 in each instantiation that a CLI run launches and no
    timed path holds (``CLI_GATHER``, ``CLI_HEADMIX``), on ``plans``
    (dataset -> the kernel plan of its graph or of one batch), as
    ``kernels_path_shapes`` does. Returns the entries by kernel (the
    rows' ``cli``)."""
    import torch
    out = {"gather_reduce_fwd": [], "gather_reduce_bwd": [],
           "headmix_fwd": [], "headmix_bwd": []}
    for dataset, plan in plans.items():
        dev = plan.rowptr.device
        gen = torch.Generator(device=dev).manual_seed(14)
        # arxiv's gathered rows (169 k x 136 f32, 92 MB) exceed the L2
        _gather_entries(plan, {f"{dataset}/{kind}": inst for kind, inst
                               in CLI_GATHER[dataset].items()}, gen,
                        out=out)
        for kind, shape in CLI_HEADMIX.get(dataset, {}).items():
            fwd, bwd = _headmix_entries(f"{dataset}/{kind}", plan.num_nodes,
                                        shape, gen, dev)
            out["headmix_fwd"].append(fwd)
            out["headmix_bwd"].append(bwd)
    torch.cuda.synchronize()
    return out


def _coalesced_edges(rng, n_src: int, n_dst: int, count: int):
    """``count`` distinct uniform random (sender, receiver) pairs."""
    import numpy as np
    check(count <= n_src * n_dst, "more edges than pairs")
    keys = np.zeros(0, np.int64)
    while len(keys) < count:
        keys = np.union1d(keys, rng.integers(
            0, n_src * n_dst, count - len(keys) + count // 100 + 1024,
            dtype=np.int64))
    keys = rng.choice(keys, count, replace=False)
    return (keys // n_dst).astype(np.int32), (keys % n_dst).astype(np.int32)


def rmag_raw(paper: dict, scale: int = 1, seed: int = 0) -> dict:
    """The rmag graph in ``synthetic_rmag``'s layout at 1/``scale`` of
    ogbn-mag's counts (``RMAG_TYPES``, ``RMAG_RELATIONS``): the papers,
    their labels, split and cites edges from ``paper`` (a
    ``synthetic_full_graph`` of the paper count), each other relation
    uniform coalesced random edges and its reverse."""
    import numpy as np
    from egc_tpu_torch.graph.hetero import rel_key
    rng = np.random.default_rng(seed)
    n = {t: c // scale for t, c in RMAG_TYPES.items()}
    check(paper["x"].shape[0] == n["paper"], "paper graph of another size")
    edges = {rel_key("paper", "cites", "paper"): (paper["senders"],
                                                  paper["receivers"])}
    for (src, rel, dst), count in RMAG_RELATIONS.items():
        s, r = _coalesced_edges(rng, n[src], n[dst], count // scale)
        edges[rel_key(src, rel, dst)] = (s, r)
        edges[rel_key(dst, "to", src)] = (r, s)
    nodes = {"paper": paper["x"], **{
        t: np.zeros((n[t], 0), np.float32) for t in RMAG_TYPES
        if t != "paper"}}
    return {"nodes": nodes, "edges": edges, "y": paper["y"],
            "train_idx": paper["train_idx"], "val_idx": paper["val_idx"],
            "test_idx": paper["test_idx"],
            "num_classes": paper["num_classes"]}


def rmag_config(raw: dict, device=None):
    """An ``RMagConfig`` (``RMAG_NET``) whose data is ``raw``."""
    from egc_tpu_torch.exp.hetero import RMagConfig

    class RMagAtSize(RMagConfig):
        def load_hetero(self):
            return raw

    return RMagAtSize(RMAG_NET["hidden"], heads=RMAG_NET["heads"],
                      bases=RMAG_NET["bases"], device=device)


def rmag_data(dev, paper: dict):
    """The rmag path's graph at ogbn-mag's counts (``rmag_raw`` of the mag
    path's papers), generated on the host, and its card data through
    ``RMagConfig.data`` (padding, one bipartite kernel plan a relation,
    built on the host: two ``lexsort``s over each relation's edges): the
    config, the raw graph and the data, with the seconds of each part."""
    from egc_tpu_torch.exp import hetero
    t0 = time.perf_counter()
    raw = rmag_raw(paper)
    gen_s = time.perf_counter() - t0
    cfg = rmag_config(raw, dev)
    plan_s, attach = [], hetero.attach_hetero_kernel_plans

    def timed_attach(hg):
        t = time.perf_counter()
        try:
            return attach(hg)
        finally:
            plan_s.append(time.perf_counter() - t)

    hetero.attach_hetero_kernel_plans = timed_attach
    t0 = time.perf_counter()
    try:
        data = cfg.data(RMAG_NET["hp"])
    finally:
        hetero.attach_hetero_kernel_plans = attach
    data_s = time.perf_counter() - t0
    secs = {"generate_s": gen_s, "data_s": data_s, "plan_s": plan_s[0]}
    hg = data["hetero"]
    log(f"[rmag] {dict((t, hg.num_nodes(t)) for t in hg.node_types)} "
        f"padded rows; {data['num_edges']} directed edges in "
        f"{len(hg.relations)} relations "
        f"{ {k: len(v[0]) for k, v in raw['edges'].items()} } "
        f"({gen_s:.1f} s on the host); RMagConfig.data {data_s:.1f} s, of "
        f"it the host plan build {plan_s[0]:.1f} s")
    return cfg, raw, data, secs


def kernels_rmag_shapes(data) -> dict:
    """Kernels 1-4 in rmag's bipartite instantiations at full size: the
    gather-reduce pair (``RMAG_GATHER``: sum / max with the max mask, and
    without it as the eval launches it; sum alone, with
    ``torch.sparse.mm`` beside it) on every relation's plan, from 8,740
    institution rows to 1,134,656 author rows and back; the head mix
    (``RMAG_HEADMIX``) on the paper and the author rows, as
    ``kernels_path_shapes`` does (the institution, 2.2 MB, and
    field_of_study rows, 15 MB, fit in the L2: no floor there). Returns the entries by kernel (the rows' ``rmag``)."""
    import torch
    hg = data["hetero"]
    dev = data["device"]
    gen = torch.Generator(device=dev).manual_seed(15)
    out = {"gather_reduce_fwd": [], "gather_reduce_bwd": [],
           "headmix_fwd": [], "headmix_bwd": []}
    for key in hg.relations:
        _gather_entries(hg.kernel_plans[key],
                        {f"{key}/{conv}": inst
                         for conv, inst in RMAG_GATHER.items()},
                        gen, out=out, long_sums=True)
    for t in ("paper", "author"):
        for mix, shape in RMAG_HEADMIX.items():
            fwd, bwd = _headmix_entries(f"rmag {mix} {t}", hg.num_nodes(t),
                                        shape, gen, dev)
            out["headmix_fwd"].append(fwd)
            out["headmix_bwd"].append(bwd)
    torch.cuda.synchronize()
    return out


def _gat_inputs(n, heads, c, gen, dev):
    """wh, a_src, a_dst and the cotangents g_o, g_d; g_o is scaled so the
    per-head dot q is O(1)."""
    import torch

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    return (randn(n, heads * c), randn(n, heads), randn(n, heads),
            randn(n, heads * c) / math.sqrt(c), randn(n, heads))


def _gat_kernel_args(plan, ins):
    """Arguments of kernels 5, 6 and 7 (m from the plain forward)."""
    from egc_tpu_torch.ops.cuda import attention as at
    wh, a_src, a_dst, g_o, g_d = ins
    fwd = (wh, a_src, a_dst, plan.rowptr, plan.fwd_senders)
    m = at.gat_fwd_plain(*fwd)[2]
    return {"gat_fwd": fwd,
            "gat_bwd_t": (wh, a_src, a_dst, m, g_o, g_d, plan.colptr,
                          plan.bwd_receivers),
            "gat_bwd_f": (wh, a_src, a_dst, m, g_o, g_d, plan.rowptr,
                          plan.fwd_senders)}


def _gat_kernel_errs(kernel_args, label, empty=None, silent=None) -> dict:
    """Each GAT or GATv2 kernel against its plain version on
    ``_gat_kernel_args`` / ``_gatv2_kernel_args``: max abs err by kernel.
    ``empty`` / ``silent``: row masks whose outputs must be exact zeros.
    GATv2's d_att sums de leaky(z) over every edge, with terms of both
    signs that cancel: it is a gradient and is held at the gradient
    tolerance, relative L2."""
    import torch
    from egc_tpu_torch.ops.cuda import attention as at
    errs = {}
    for name, args in kernel_args.items():
        got = getattr(at, name)(*args)
        ref = getattr(at, name + "_plain")(*args)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        check(all(bool(torch.isfinite(t).all()) for t in got),
              f"{name}[{label}]: non-finite output")
        if name in ("gatv2_bwd_f", "gatv2w_bwd_f"):
            r = rel_l2(got[1], ref[1])
            check(r <= GRAD_REL_L2, f"{name}[{label}] d_att rel L2 {r}")
            errs[f"{name} d_att rel L2"] = r
            got, ref = got[:1], ref[:1]
        errs[name] = max(_close(f"{name}[{label}] out {i}", a, b)
                         for i, (a, b) in enumerate(zip(got, ref)))
        if name == "gat_fwd":   # the stationary max is order-free
            _close(f"{name}[{label}] m", got[2], ref[2], exact=True)
        fwd = name.endswith("_fwd")
        rows = silent if name.endswith("_bwd_t") else empty
        if rows is not None:
            outs = got[:2] if fwd else got
            check(all(bool((t[rows] == 0).all()) for t in outs),
                  f"{name}[{label}]: empty rows are not exact zeros")
            if fwd:
                check(bool((got[2][rows] == at.EMPTY_MAX).all()),
                      f"{name}[{label}]: m of empty rows")
    return errs


def _check_repeat_bitwise(kernel_args, label) -> None:
    """Two launches of each GAT or GATv2 kernel give the same bits."""
    import torch
    from egc_tpu_torch.ops.cuda import attention as at
    for name, args in kernel_args.items():
        first, second = getattr(at, name)(*args), getattr(at, name)(*args)
        first = first if isinstance(first, tuple) else (first,)
        second = second if isinstance(second, tuple) else (second,)
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              f"{name}[{label}]: two launches differ")


def _check_gat_autograd(g, ins, heads, c, gen, label) -> float:
    """Gradients through ``gat_attention`` (with the self-term merge) and
    through the whole GATConv against autograd of the plain segment path
    on the same card; returns the worst relative L2."""
    import torch
    from egc_tpu_torch.nn.conv.attention import (
        GATConv, fused_softmax_sum, segment_softmax_sum,
    )
    n, dev = g.num_nodes, g.nodes.device
    plan = g.kernel_plan
    wh, a_src, a_dst = ins[0].view(n, heads, c), ins[1], ins[2]
    proj = torch.randn(n, heads, c, generator=gen, device=dev)

    def plain(h, a, b):
        return segment_softmax_sum(h, a, b, g.senders, g.receivers,
                                   g.edge_mask)

    def run(fn, tensors, extra=()):
        ts = [t.detach().clone().requires_grad_(True) for t in tensors]
        out = fn(*ts)
        (out * proj.reshape(out.shape)).sum().backward()
        return out.detach(), [t.grad for t in ts] + [
            p.grad.clone() for p in extra]

    worst = 0.0
    got, g_got = run(lambda h, a, b: fused_softmax_sum(h, a, b, plan),
                     (wh, a_src, a_dst))
    ref, g_ref = run(plain, (wh, a_src, a_dst))
    _close(f"gat_attention+merge[{label}]", got, ref)
    for i, (a, b) in enumerate(zip(g_got, g_ref)):
        worst = max(worst, rel_l2(a, b))
        check(rel_l2(a, b) <= GRAD_REL_L2,
              f"gat_attention[{label}] grad {i} rel L2 {rel_l2(a, b)}")

    fin = 152
    conv = GATConv(fin, c, heads=heads,
                   generator=torch.Generator().manual_seed(3), device=dev)
    with torch.no_grad():
        conv.bias.normal_(generator=gen)
    x = torch.randn(n, fin, generator=gen, device=dev)
    params = list(conv.parameters())

    def conv_plain(xx):
        h, a, b = conv.project(xx)
        return plain(h, a, b).reshape(n, -1) + conv.bias

    got, g_got = run(lambda xx: conv(g, xx), (x,), params)
    conv.zero_grad()
    ref, g_ref = run(conv_plain, (x,), params)
    _close(f"GATConv[{label}]", got, ref)
    for i, (a, b) in enumerate(zip(g_got, g_ref)):
        worst = max(worst, rel_l2(a, b))
        check(rel_l2(a, b) <= GRAD_REL_L2,
              f"GATConv[{label}] grad {i} rel L2 {rel_l2(a, b)}")
    return worst


def _gat_cost(n, e, heads, f) -> dict:
    """Per GAT kernel: (compulsory bytes, bytes gathered per edge,
    operations) over n rows and e edges at H = ``heads``, F = H*C = f."""
    nh = 4 * n * heads
    ptr_idx = 4 * (n + 1 + e)
    return {
        "gat_fwd": (4 * 2 * n * f + 4 * nh + ptr_idx, 4 * f,       # wh[s]
                    e * (2.0 * f + 6 * heads)),
        "gat_bwd_t": (4 * 3 * n * f + 5 * nh + ptr_idx, 4 * f,     # g_o[r]
                      e * (4.0 * f + 10 * heads)),
        "gat_bwd_f": (4 * 2 * n * f + 5 * nh + ptr_idx, 4 * f,     # wh[s]
                      e * (2.0 * f + 10 * heads)),
    }


def _gatv2_cost(n, e, heads, f) -> dict:
    """``_gat_cost`` for the three GATv2 kernels."""
    nh = 4 * n * heads
    ptr_idx = 4 * (n + 1 + e)
    return {
        "gatv2_fwd": (4 * 3 * n * f + 2 * nh + ptr_idx + 4 * f,
                      4 * f, e * (7.0 * f + 6 * heads)),           # hl[s]
        "gatv2_bwd_t": (4 * 4 * n * f + 2 * nh + ptr_idx + 4 * f,
                        8 * f,                            # hr[r], g_o[r]
                        e * (10.0 * f + 4 * heads)),
        "gatv2_bwd_f": (4 * 4 * n * f + 2 * nh + ptr_idx + 8 * f,
                        4 * f, e * (10.0 * f + 4 * heads)),        # hl[s]
    }


def _shape_entries(kernel_args, cost, errs, n, e, heads, c,
                   gathered: bool = True) -> dict:
    """Each attention kernel at one shape over n rows and e edges: its
    error, kernel and plain times, bound and (``gathered``: the rows exceed
    L2) gathered floor, by name."""
    from egc_tpu_torch.ops.cuda import attention as at
    out = {}
    for name, args in kernel_args.items():
        kern, plain = getattr(at, name), getattr(at, name + "_plain")
        nbytes, row_bytes, ops = cost[name]
        b_ms, b_by = bound_ms(nbytes, ops)
        out[name] = dict(
            heads=heads, channels=c, max_abs_err=errs[name],
            ms=time_ms(lambda: kern(*args)),
            plain_ms=time_ms(lambda: plain(*args)),
            bound_ms=b_ms, bound_by=b_by)
        if gathered:
            out[name]["floor_ms"] = floor_ms(nbytes, row_bytes, n, e, ops)
    return out


def kernels_gat_main_shapes(data) -> list:
    """Kernels 5-7 against their plain versions at the GAT path's shapes,
    (H8, C19) and (H1, C152); the rows report per-launch figures of the
    path (two launches at the first shape, one at the second)."""
    import torch
    from egc_tpu_torch.ops.cuda import attention as at

    g = data["graph"]
    plan, dev = g.kernel_plan, data["device"]
    n, e = plan.num_nodes, plan.num_edges
    gen = torch.Generator(device=dev).manual_seed(4)
    per_shape = {}
    for heads, c in GAT_SHAPES:
        f = heads * c
        ins = _gat_inputs(n, heads, c, gen, dev)
        kernel_args = _gat_kernel_args(plan, ins)
        errs = _gat_kernel_errs(kernel_args, f"H{heads} C{c}")
        _check_repeat_bitwise(kernel_args, f"H{heads} C{c}")
        worst = _check_gat_autograd(g, ins, heads, c, gen, f"H{heads} C{c}")
        log(f"[kernels] H{heads} C{c}: gat_attention and GATConv grads vs "
            f"the plain path: worst rel L2 {worst:.3e}")
        for name, entry in _shape_entries(
                kernel_args, _gat_cost(n, e, heads, f), errs, n, e, heads,
                c).items():
            per_shape.setdefault(name, []).append(entry)
        del ins, kernel_args
        torch.cuda.empty_cache()
    replaces = {"gat_fwd": "egc_tpu/ops/pallas/attention.py:160",
                "gat_bwd_t": "egc_tpu/ops/pallas/attention.py:392",
                "gat_bwd_f": "egc_tpu/ops/pallas/attention.py:392"}
    return _per_launch_rows(per_shape, replaces,
                            "egc_tpu_torch/csrc/gat_attention.cu",
                            "no single PyTorch call computes the GAT edge "
                            "softmax or its gradient")


def _small_attention_graph(dev):
    """A 1,000-node graph with at least 40 receivers without in-edges and 40
    senders without out-edges, three hub senders with 70, 100 and 150 more
    out-edges and three hub receivers with as many more in-edges, ten
    senders with exactly 1, 2 or 3 out-edges and ten receivers with exactly
    1, 2 or 3 in-edges (fewer than a warp's edge groups), receivers with
    exactly G - 1 and G + 1 in-edges for every count G of edge groups per
    warp step that the attention kernels take at the checked shapes and
    for the wide forward's edges a block step (a group runs past the
    row's end); and masks of the empty and the silent rows."""
    import numpy as np
    import torch
    from egc_tpu_torch.graph.structure import Graph
    from egc_tpu_torch.graph.transforms import coalesce_np
    from egc_tpu_torch.ops.cuda import attention as at
    from egc_tpu_torch.ops.dispatch import build_kernel_plan

    rng = np.random.default_rng(1)
    n = 1000
    s = [rng.integers(0, n - 50, 6000)]      # nodes n-50 .. n-1 added below
    r = [rng.integers(0, n - 60, 6000)]      # and receivers n-60 .. n-51
    few = [(node, 1 + i % 3) for i, node in enumerate(range(n - 50, n - 40))]
    groups = {32 // at.edge_geometry(h, c)[0]
              for h, c in GAT_SMALL_SHAPES + GAT_SHAPES + CODE_GAT_SHAPES
              + CLI_GAT_SHAPES + GATV2_SMALL_SHAPES + GATV2_SHAPES
              + CODE_GATV2_SHAPES + CLI_GATV2_SHAPES + WIDE_SWEEP_SHAPES}
    groups.add(at.WIDE_FWD_EDGES)
    near = sorted({k for g in groups for k in (g - 1, g + 1) if k > 0})
    check(len(near) <= 10, f"small graph: {near} needs more nodes")
    few_out = [(0, 70), (1, 100), (2, 150)] + few
    few_in = [(3, 70), (4, 100), (5, 150)] + few + [
        (n - 60 + i, k) for i, k in enumerate(near)]
    for node, k in few_out:                  # n-40 .. n-1 send nothing
        s.append(np.full(k, node))
        r.append(rng.choice(n - 60, k, replace=False))
    for node, k in few_in:                   # n-40 .. n-1 receive nothing
        r.append(np.full(k, node))
        s.append(rng.choice(n - 50, k, replace=False))
    s, r, _ = coalesce_np(np.concatenate(s), np.concatenate(r), n)
    out_deg = np.bincount(s, minlength=n)
    in_deg = np.bincount(r, minlength=n)
    for deg, hubs, side in ((out_deg, few_out, "senders"),
                            (in_deg, few_in, "receivers")):
        check(min(deg[node] for node, _ in hubs[:3]) > 64
              and all(deg[node] == k for node, k in hubs[3:]),
              f"small graph: hub or few-edge {side} missing")
    g = Graph.from_coo(np.zeros((n, 1), np.float32), s, r)
    g = g.replace(kernel_plan=build_kernel_plan(s, r, n)).to(dev)
    empty = torch.as_tensor(in_deg == 0, device=dev)
    silent = torch.as_tensor(out_deg == 0, device=dev)
    return g, empty, silent


GAT_SMALL_SHAPES = ((8, 5), (1, 37), (4, 37), (3, 37), (32, 8))


def kernels_gat_small(dev) -> None:
    """Kernels 5-7 with empty receivers, senders without out-edges, hub
    senders and receivers, senders and receivers with 1-3 edges and
    receivers with G +- 1, at C = 5, 37 and 8 (H = 3 and 32 among them)
    besides the arxiv and code2 paths' shapes and the CLI runs' (hiv GAT
    h240); and the lane geometry of the three kernels as they report it against
    ``attention.gat_edge_geometry`` at every shape they take
    (``attention.accepted_shapes``, 1,792)."""
    import torch
    from egc_tpu_torch.ops.cuda import attention as at
    shapes = at.accepted_shapes()
    bad = [(h, c) for h, c in shapes
           if at.kernel_gat_edge_geometry(h, c) != at.gat_edge_geometry(h, c)]
    check(not bad, f"the geometry of the GAT kernels differs from "
                   f"gat_edge_geometry at {bad[:5]}")
    g, empty, silent = _small_attention_graph(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    held = GAT_SMALL_SHAPES + GAT_SHAPES + CODE_GAT_SHAPES + CLI_GAT_SHAPES
    for heads, c in held:
        ins = _gat_inputs(g.num_nodes, heads, c, gen, dev)
        label = f"small H{heads} C{c}"
        _gat_kernel_errs(_gat_kernel_args(g.kernel_plan, ins), label, empty,
                         silent)
        _check_gat_autograd(g, ins, heads, c, gen, label)
        HELD["gat"].add((heads, c))
    torch.cuda.synchronize()
    log(f"[kernels] GAT small-size checks passed (empty receivers, senders "
        f"without out-edges, hubs, 1-3-edge senders and receivers, receivers "
        f"of G +- 1 edges, (H, C) = {held}); the geometry "
        f"of the GAT kernels agrees at {len(shapes)} shapes")


def _gatv2_inputs(n, heads, c, gen, dev):
    """hl, hr, att and the cotangents g_o, g_d; att and g_o are scaled so
    the logits and the per-head dot q are O(1), as glorot weights keep
    them."""
    import torch

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    return (randn(n, heads * c), randn(n, heads * c),
            randn(heads, c) / math.sqrt(c),
            randn(n, heads * c) / math.sqrt(c), randn(n, heads))


def _gatv2_kernel_args(plan, ins):
    """Arguments of the three GATv2 kernels (m from the plain forward)."""
    from egc_tpu_torch.ops.cuda import attention as at
    hl, hr, att, g_o, g_d = ins
    fwd = (hl, hr, att, plan.rowptr, plan.fwd_senders)
    m = at.gatv2_fwd_plain(*fwd)[2]
    return {"gatv2_fwd": fwd,
            "gatv2_bwd_t": (hl, hr, att, m, g_o, g_d, plan.colptr,
                            plan.bwd_receivers),
            "gatv2_bwd_f": (hl, hr, att, m, g_o, g_d, plan.rowptr,
                            plan.fwd_senders)}


def _check_gatv2_autograd(g, ins, heads, c, gen, label) -> float:
    """Gradients through ``gatv2_attention`` (with the self-term merge) and
    through the whole GATv2Conv against autograd of the plain segment path
    on the same card, d_att included; returns the worst relative L2."""
    import torch
    from egc_tpu_torch.nn.conv.attention import (
        GATv2Conv, fused_softmax_sum_v2, segment_softmax_sum_v2,
    )
    n, dev = g.num_nodes, g.nodes.device
    plan = g.kernel_plan
    hl, hr, att = ins[0].view(n, heads, c), ins[1].view(n, heads, c), ins[2]
    proj = torch.randn(n, heads, c, generator=gen, device=dev)

    def plain(a, b, w):
        return segment_softmax_sum_v2(a, b, w, g.senders, g.receivers,
                                      g.edge_mask)

    def run(fn, tensors, extra=()):
        ts = [t.detach().clone().requires_grad_(True) for t in tensors]
        out = fn(*ts)
        (out * proj.reshape(out.shape)).sum().backward()
        return out.detach(), [t.grad for t in ts] + [
            p.grad.clone() for p in extra]

    def held(what, got, g_got, ref, g_ref):
        _close(f"{what}[{label}]", got, ref)
        worst = 0.0
        for i, (a, b) in enumerate(zip(g_got, g_ref)):
            worst = max(worst, rel_l2(a, b))
            check(rel_l2(a, b) <= GRAD_REL_L2,
                  f"{what}[{label}] grad {i} rel L2 {rel_l2(a, b)}")
        return worst

    got, g_got = run(lambda a, b, w: fused_softmax_sum_v2(a, b, w, plan),
                     (hl, hr, att))
    ref, g_ref = run(plain, (hl, hr, att))
    worst = held("gatv2_attention+merge", got, g_got, ref, g_ref)

    fin = 112
    conv = GATv2Conv(fin, c, heads=heads,
                     generator=torch.Generator().manual_seed(3), device=dev)
    with torch.no_grad():   # nonzero biases, so their gradients are held too
        for p in (conv.bias, conv.lin_l.bias, conv.lin_r.bias):
            p.normal_(generator=gen)
    x = torch.randn(n, fin, generator=gen, device=dev)
    params = list(conv.parameters())

    def conv_plain(xx):
        a, b = conv.project(xx)
        return plain(a, b, conv.att[0]).reshape(n, -1) + conv.bias

    got, g_got = run(lambda xx: conv(g, xx), (x,), params)
    conv.zero_grad()
    ref, g_ref = run(conv_plain, (x,), params)
    return max(worst, held("GATv2Conv", got, g_got, ref, g_ref))


def kernels_gatv2_main_shapes(data) -> list:
    """The GATv2 kernels against their plain versions at the GATv2 path's
    shapes, (H8, C14) and (H1, C112); the rows report per-launch figures
    of the path (two launches at the first shape, one at the second)."""
    import torch
    from egc_tpu_torch.ops.cuda import attention as at

    g = data["graph"]
    plan, dev = g.kernel_plan, data["device"]
    n, e = plan.num_nodes, plan.num_edges
    gen = torch.Generator(device=dev).manual_seed(6)
    per_shape = {}
    for heads, c in GATV2_SHAPES:
        f = heads * c
        ins = _gatv2_inputs(n, heads, c, gen, dev)
        kernel_args = _gatv2_kernel_args(plan, ins)
        label = f"H{heads} C{c}"
        errs = _gat_kernel_errs(kernel_args, label)
        _check_repeat_bitwise(kernel_args, label)
        worst = _check_gatv2_autograd(g, ins, heads, c, gen, label)
        log(f"[kernels] {label}: gatv2_bwd_f d_att rel L2 "
            f"{errs['gatv2_bwd_f d_att rel L2']:.3e}; gatv2_attention and "
            f"GATv2Conv grads vs the plain path: worst rel L2 {worst:.3e}")
        for name, entry in _shape_entries(
                kernel_args, _gatv2_cost(n, e, heads, f), errs, n, e,
                heads, c).items():
            per_shape.setdefault(name, []).append(entry)
        per_shape["gatv2_bwd_f"][-1]["d_att_rel_l2"] = \
            errs["gatv2_bwd_f d_att rel L2"]
        del ins, kernel_args
        torch.cuda.empty_cache()
    replaces = {"gatv2_fwd": "egc_tpu/ops/pallas/attention.py:1267",
                "gatv2_bwd_t": "egc_tpu/ops/pallas/attention.py:752",
                "gatv2_bwd_f": "egc_tpu/ops/pallas/attention.py:1191"}
    return _per_launch_rows(per_shape, replaces,
                            "egc_tpu_torch/csrc/gatv2_attention.cu",
                            "no single PyTorch call computes the GATv2 edge "
                            "softmax or its gradient")


def _per_launch_rows(per_shape, replaces, source, library_note) -> list:
    """Kernel rows of an attention path: per-launch figures of two launches
    at the first shape and one at the second per step."""
    rows = []
    for name, shapes in per_shape.items():
        for sh in shapes:
            log(f"[kernels] {name} H{sh['heads']} C{sh['channels']}: "
                f"{sh['ms']:.4f} ms (plain {sh['plain_ms']:.4f}, bound "
                f"{sh['bound_ms']:.4f} by {sh['bound_by']}, floor "
                f"{sh['floor_ms']:.4f}), max abs err "
                f"{sh['max_abs_err']:.3e}")

        def per_launch(key):
            return (2 * shapes[0][key] + shapes[1][key]) / 3

        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces[name],
            max_abs_err=max(sh["max_abs_err"] for sh in shapes),
            ms=per_launch("ms"), plain_ms=per_launch("plain_ms"),
            bound_ms=per_launch("bound_ms"),
            bound_by=shapes[0]["bound_by"], floor_ms=per_launch("floor_ms"),
            library_ms=None,
            library_note=library_note, per_shape=shapes))
    return rows


GATV2_SMALL_SHAPES = ((8, 5), (1, 37), (4, 37), (3, 37), (32, 8))


def kernels_gatv2_small(dev) -> None:
    """The GATv2 kernels with empty receivers, senders without out-edges,
    hub senders and receivers, and senders and receivers with 1-3 edges, at
    C = 5, 37 and 8 (H = 3 and 32 among them) besides the arxiv and code2
    paths' shapes and the CLI runs' (zinc / cifar h104, hiv h184); and the
    lane geometry of ``gatv2_fwd``, ``gatv2_bwd_t``
    and ``gatv2_bwd_f`` as the kernels report it against the launcher's
    rule for every shape they take (``attention.accepted_shapes``)."""
    import torch
    from egc_tpu_torch.ops.cuda import attention as at
    shapes = at.accepted_shapes()
    bad = [(h, c) for h, c in shapes
           if at.kernel_edge_geometry(h, c) != at.edge_geometry(h, c)]
    check(not bad, f"the geometry of gatv2_fwd, gatv2_bwd_t and gatv2_bwd_f "
                   f"differs from edge_geometry at {bad[:5]}")
    g, empty, silent = _small_attention_graph(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    held = (GATV2_SMALL_SHAPES + GATV2_SHAPES + CODE_GATV2_SHAPES
            + CLI_GATV2_SHAPES)
    for heads, c in held:
        ins = _gatv2_inputs(g.num_nodes, heads, c, gen, dev)
        label = f"small H{heads} C{c}"
        _gat_kernel_errs(_gatv2_kernel_args(g.kernel_plan, ins), label,
                         empty, silent)
        _check_gatv2_autograd(g, ins, heads, c, gen, label)
        HELD["gatv2"].add((heads, c))
    torch.cuda.synchronize()
    log(f"[kernels] GATv2 small-size checks passed (empty receivers, senders "
        f"without out-edges, hub senders and receivers, 1-3-edge senders and "
        f"receivers, (H, C) = {held}); the "
        f"geometry of gatv2_fwd, gatv2_bwd_t and gatv2_bwd_f agrees at "
        f"{len(shapes)} shapes")


def _as_wide(kernel_dict: dict) -> dict:
    """A GATv2 dict keyed by the narrow kernels' names, keyed by the wide
    kernels' (``gatv2_fwd`` -> ``gatv2w_fwd``)."""
    return {k.replace("gatv2", "gatv2w"): v for k, v in kernel_dict.items()}


def _wide_sweeps(v2: bool) -> list:
    """The distinct launches of ``WIDE_ROWS``' sweeps: (H, C, wide)."""
    from egc_tpu_torch.ops.cuda import attention as at
    return sorted({(sw.heads, sw.channels, sw.wide) for hc in WIDE_ROWS
                   for sw in at.sweeps(*hc, v2=v2)})


def kernels_wide_shapes(data) -> tuple:
    """``[gat_wide]``'s kernels against their plain versions on the arxiv
    graph, at the launches its sweeps make: GAT (2, 250), (1, 250) and
    (1, 375); GATv2 (2, 250), (1, 250), and ``gatv2w_*`` at (1, 750):
    values, the backward kernels (the gradients), two launches bitwise,
    timed with their bound and gathered floor. The compiled wide rule
    against ``wide_shape_ok``. Returns (the narrow kernels' entries by
    name, the rows' ``wide``; the wide kernels' entries by name)."""
    import torch
    from egc_tpu_torch.ops.cuda import attention as at

    probe = [(h, c) for h in (0, 1, 2, 3, 32, 33)
             for c in (0, 1, 512, 513, 750, at.WIDE_MAX_CHANNELS,
                       at.WIDE_MAX_CHANNELS + 1)]
    bad = [hc for hc in probe
           if at.kernel_wide_shape_ok(*hc) != at.wide_shape_ok(*hc)]
    check(not bad, f"the wide kernels' rule differs from wide_shape_ok at "
                   f"{bad}")
    bad = [hc for hc in probe + list(WIDE_SMALL_SHAPES)
           if at.wide_shape_ok(*hc)
           and at.kernel_wide_geometry(*hc) != at.wide_geometry(*hc)]
    check(not bad, f"the wide kernels' blocks differ from wide_geometry at "
                   f"{bad}")
    g = data["graph"]
    plan, dev = g.kernel_plan, data["device"]
    n, e = plan.num_nodes, plan.num_edges
    gen = torch.Generator(device=dev).manual_seed(17)
    narrow, wide = {}, {}
    for v2 in (False, True):
        shapes = _wide_sweeps(v2)
        check({(h, c) for h, c, w in shapes if not w}
              == set(WIDE_SWEEP_SHAPES) - ({(1, 375)} if v2 else set()),
              f"the sweeps of {WIDE_ROWS}: {shapes}")
        for heads, c, is_wide in shapes:
            label = f"{'GATv2' if v2 else 'GAT'} arxiv H{heads} C{c}"
            ins = (_gatv2_inputs if v2 else _gat_inputs)(n, heads, c, gen,
                                                         dev)
            kargs = (_gatv2_kernel_args if v2 else _gat_kernel_args)(plan,
                                                                     ins)
            cost = (_gatv2_cost if v2 else _gat_cost)(n, e, heads, heads * c)
            if is_wide:
                kargs, cost = _as_wide(kargs), _as_wide(cost)
            errs = _gat_kernel_errs(kargs, label)
            _check_repeat_bitwise(kargs, label)
            for name, entry in _shape_entries(kargs, cost, errs, n, e, heads,
                                              c).items():
                entry["path"] = "gatv2_wide" if v2 else "gat_wide"
                if f"{name} d_att rel L2" in errs:
                    entry["d_att_rel_l2"] = errs[f"{name} d_att rel L2"]
                (wide if is_wide else narrow).setdefault(name, []).append(
                    entry)
                log(f"[kernels] {name} {label}: {entry['ms']:.4f} ms "
                    f"(plain {entry['plain_ms']:.4f}, bound "
                    f"{entry['bound_ms']:.4f} by {entry['bound_by']}, "
                    f"floor {entry['floor_ms']:.4f}), max abs err "
                    f"{entry['max_abs_err']:.3e}")
            del ins, kargs
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return narrow, wide


def _wide_kernel_rows(wide: dict) -> list:
    """Kernel rows of the three ``gatv2w_*`` kernels: per-launch figures
    at (1, 750), their one launch a step on ``gatv2_wide``."""
    replaces = {"gatv2w_fwd": "egc_tpu/ops/pallas/attention.py:1267",
                "gatv2w_bwd_t": "egc_tpu/ops/pallas/attention.py:752",
                "gatv2w_bwd_f": "egc_tpu/ops/pallas/attention.py:1191"}
    rows = []
    for name, shapes in wide.items():
        sh = shapes[0]
        rows.append(dict(
            name=name, route="cuda",
            source="egc_tpu_torch/csrc/gatv2_attention_wide.cu",
            replaces=replaces[name], max_abs_err=sh["max_abs_err"],
            ms=sh["ms"], plain_ms=sh["plain_ms"], bound_ms=sh["bound_ms"],
            bound_by=sh["bound_by"], floor_ms=sh["floor_ms"],
            library_ms=None,
            library_note="no single PyTorch call computes the GATv2 edge "
                         "softmax or its gradient", per_shape=shapes))
    return rows


def kernels_wide_small(dev) -> None:
    """``[gat_wide]``'s launches on the small graph (empty receivers,
    silent senders, hubs, 1-3-edge rows): each narrow sweep shape and the
    wide kernels at ``WIDE_SMALL_SHAPES`` against their plain versions,
    with gradients through the autograd functions and the whole convs;
    then the rows ``WIDE_ROWS`` through the convs, their sweeps composed
    (``attention.run_sweeps``). ``HELD`` gains all of them."""
    import torch
    g, empty, silent = _small_attention_graph(dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    for v2 in (False, True):
        fam = "gatv2" if v2 else "gat"
        inputs = _gatv2_inputs if v2 else _gat_inputs
        kargs = _gatv2_kernel_args if v2 else _gat_kernel_args
        autograd = _check_gatv2_autograd if v2 else _check_gat_autograd
        shapes = [(h, c, False) for h, c, w in _wide_sweeps(v2) if not w]
        if v2:
            shapes += [(h, c, True) for h, c in WIDE_SMALL_SHAPES]
        for heads, c, is_wide in shapes:
            ins = inputs(g.num_nodes, heads, c, gen, dev)
            label = f"small {fam} H{heads} C{c}"
            args = kargs(g.kernel_plan, ins)
            args = _as_wide(args) if is_wide else args
            _gat_kernel_errs(args, label, empty, silent)
            _check_repeat_bitwise(args, label)
            worst = autograd(g, ins, heads, c, gen, label)
            HELD[fam].add((heads, c))
            log(f"[kernels] {label}: held; autograd and conv grads worst "
                f"rel L2 {worst:.3e}")
        for heads, c in WIDE_ROWS:
            ins = inputs(g.num_nodes, heads, c, gen, dev)
            worst = autograd(g, ins, heads, c, gen,
                             f"small {fam} row H{heads} C{c}")
            HELD[fam].add((heads, c))
            log(f"[kernels] small {fam} row H{heads} C{c} over its sweeps "
                f"(gat_attention / gatv2_attention and the conv): worst "
                f"grad rel L2 {worst:.3e}")
    torch.cuda.synchronize()


def check_attention_routes(dev) -> dict:
    """The convs' route on the card (``nn.conv.attention._attention_route``)
    on the small graph, by the launch counters: a GATConv with 33 heads
    launches no attention kernel, one with 32 heads each of ``gat_fwd``,
    ``gat_bwd_t`` and ``gat_bwd_f`` once; the output and gradients of
    both match the same conv's on the CPU."""
    import copy
    import torch
    from egc_tpu_torch.nn.conv.attention import GATConv
    from egc_tpu_torch.ops.cuda import attention as at
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    g, _, _ = _small_attention_graph(dev)
    g_cpu = g.to("cpu")
    gen = torch.Generator().manual_seed(19)
    res = {}
    for heads in (33, 32):
        conv = GATConv(40, 8, heads=heads, generator=gen, device=dev)
        with torch.no_grad():
            conv.bias.normal_(
                generator=torch.Generator(device=dev).manual_seed(1))
        x = torch.randn(g.num_nodes, 40, generator=gen)
        proj = torch.randn(g.num_nodes, heads * 8, generator=gen)
        want = {k: int(heads <= at.MAX_HEADS and k.startswith("gat_"))
                for k in at.launches}
        outs = {}
        for where, module, graph in (
                ("cuda", conv, g), ("cpu", copy.deepcopy(conv).cpu(), g_cpu)):
            xx = x.to(where).requires_grad_(True)
            reset_launch_counts()
            out = module(graph, xx)
            (out * proj.to(where)).sum().backward()
            if where == "cuda":
                torch.cuda.synchronize()
                counts = launch_counts()
                launched = {k: counts[k] for k in at.launches}
                check(launched == want, f"[routes] GATConv H{heads} launched "
                                        f"{launched}, expected {want}")
            outs[where] = (out.detach().cpu(), [xx.grad.cpu()] + [
                p.grad.cpu() for p in module.parameters()])
        err = _close(f"[routes] GATConv H{heads} card vs CPU",
                     outs["cuda"][0], outs["cpu"][0])
        worst = max(rel_l2(a, b) for a, b in zip(outs["cuda"][1],
                                                 outs["cpu"][1]))
        check(worst <= GRAD_REL_L2,
              f"[routes] GATConv H{heads} grads rel L2 {worst}")
        res[f"h{heads}"] = {"launched": launched, "max_abs_err": err,
                            "grad_rel_l2": worst}
        log(f"[routes] GATConv H{heads}: launched "
            f"{ {k: v for k, v in launched.items() if v} }, card vs CPU "
            f"max abs err {err:.3e}, grads rel L2 {worst:.3e}")
    return res


def phase_gat_wide(raw, data) -> dict:
    """``[gat_wide]``: GAT and GATv2 ArxivNet h750 H3 (``WIDE_NETS``) on
    the arxiv graph through ``phase_path``, their card step held against
    the CPU step on a graph of 1/8 the nodes at the same average degree
    (at full size the CPU segment path holds [E, 750] floats, 7.1 GB a
    tensor) on the card step's branches (``_same_branches``), 2 warm-up
    and 10 timed steps with the launch counters (``_wide_launches``), the
    idle share; ``--check --check-epochs 2`` of both at h750 H3 through
    the command line in process; the route checks
    (``check_attention_routes``)."""
    import ast
    import tempfile
    import torch
    from egc_tpu_torch.data.synthetic import synthetic_full_graph
    from egc_tpu_torch.exp.fullgraph import full_graph_to_device_dict
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    small = synthetic_full_graph(num_nodes=NUM_NODES // 8, avg_degree=14,
                                 num_features=128, num_classes=40, seed=0)
    checked = (small, full_graph_to_device_dict(small),
               full_graph_to_device_dict(small, "cpu"))
    log(f"[gat_wide] step checks on a graph of 1/8 the nodes "
        f"({small['x'].shape[0]} nodes, {len(small['senders'])} edges); "
        f"the timed steps at full size; launches a step "
        f"{ {p: _wide_launches(p) for p in WIDE_NETS} }")
    res = {}
    for path, net in WIDE_NETS.items():
        res[path] = phase_path(path, raw, data, None, net, checked=checked,
                               same_branches=True, idle=True)
        torch.cuda.empty_cache()
    del checked
    res["cli"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for path, net in WIDE_NETS.items():
            kind = net["kind"]
            reset_launch_counts()
            lines, sec = _run_cli([f"{tmp}/{kind}", kind, "arxiv", *WIDE_CLI,
                                   "--check", "--check-epochs", "2"])
            counts = launch_counts()
            printed = ast.literal_eval(lines[-1])
            check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in
                      [printed["best_val"], *printed["test"].values()]),
                  f"[gat_wide] cli {kind}: metrics {printed}")
            for name, c in _variant_counts(
                    counts, f"[gat_wide] cli {kind}", False).items():
                check(c > 0 if name in PATH_KERNELS[path] else c == 0,
                      f"[gat_wide] cli {kind}: {name} launched {c} times")
            res["cli"][kind] = {"printed": printed, "launches": counts,
                                "seconds": sec}
            log(f"[gat_wide] python -m egc_tpu_torch ... {kind} arxiv "
                f"{' '.join(WIDE_CLI)} --check --check-epochs 2: {printed}; "
                f"launches { {k: v for k, v in counts.items() if v} } "
                f"({sec:.1f} s)")
    res["routes"] = check_attention_routes(data["device"])
    return res


def code_batch(dev):
    """The first train batch of the code2 paths' loader (its kernel plan
    built on the host, as on the path): 14,256 node rows, ~9 k edges."""
    from egc_tpu_torch.exp.batched import CodeConfig
    cfg = CodeConfig("gat", CODE_GAT_NET["hidden"], **CODE_DATA)
    g, _ = next(iter(cfg.data(CODE_HP, dev)["train"]))
    check(g.kernel_plan is not None, "a CUDA batch without a kernel plan")
    return g


def batch_plans() -> dict:
    """The kernel plan of the first train batch of each batched EGC path's
    loader (``BATCHED_NETS``, built on the host as on the path)."""
    from egc_tpu_torch.exp import batched
    plans = {}
    for path, net in BATCHED_NETS.items():
        cfg = getattr(batched, net["config"])("egc", net["hidden"], heads=4,
                                              bases=4, aggrs=net["aggrs"])
        g, _ = next(iter(cfg.data(net["hp"])["train"]))
        check(g.kernel_plan is not None, "a CUDA batch without a kernel plan")
        plans[path] = g.kernel_plan
    return plans


def kernels_code_shapes(g) -> dict:
    """All six attention kernels against their plain versions at the four
    ogbg-code2 widths, (H8, C38) and (H1, C304) for GAT, (H8, C37) and (H1,
    C296) for GATv2 (32 lanes, one edge per warp step, K = 10), on a code2
    batch ``g``: values, two launches bitwise, ``gat_fwd``'s m bitwise,
    gradients through the autograd functions and the whole convs, the
    kernels' geometry; timed. Returns the per-shape entries by kernel."""
    import torch
    from egc_tpu_torch.ops.cuda import attention as at
    plan, dev = g.kernel_plan, g.nodes.device
    n, e = plan.num_nodes, plan.num_edges
    gen = torch.Generator(device=dev).manual_seed(8)
    wide = {}
    for shapes, inputs, kargs, autograd, cost, geometry in (
            (CODE_GAT_SHAPES, _gat_inputs, _gat_kernel_args,
             _check_gat_autograd, _gat_cost, at.kernel_gat_edge_geometry),
            (CODE_GATV2_SHAPES, _gatv2_inputs, _gatv2_kernel_args,
             _check_gatv2_autograd, _gatv2_cost, at.kernel_edge_geometry)):
        for heads, c in shapes:
            label = f"code2 H{heads} C{c}"
            got = geometry(heads, c)
            check(got == at.edge_geometry(heads, c) and got[0] == 32
                  and got[2] == 10, f"{label}: kernel geometry {got}")
            ins = inputs(n, heads, c, gen, dev)
            kernel_args = kargs(plan, ins)
            errs = _gat_kernel_errs(kernel_args, label)
            _check_repeat_bitwise(kernel_args, label)
            worst = autograd(g, ins, heads, c, gen, label)
            # a code2 batch's gathered rows (14,256 x <= 304 f32, 17 MB)
            # fit in the 50 MB L2: no gathered floor, the compulsory bound
            for name, entry in _shape_entries(
                    kernel_args, cost(n, e, heads, heads * c), errs, n, e,
                    heads, c, gathered=False).items():
                if name == "gatv2_bwd_f":
                    entry["d_att_rel_l2"] = errs["gatv2_bwd_f d_att rel L2"]
                entry["path"] = "code2"
                wide.setdefault(name, []).append(entry)
            log(f"[kernels] {label}: held on {n} rows, {e} edges; autograd "
                f"and conv grads vs the plain path: worst rel L2 "
                f"{worst:.3e}")
    for name, entries in wide.items():
        for sh in entries:
            log(f"[kernels] {name} code2 H{sh['heads']} C{sh['channels']}: "
                f"{sh['ms']:.4f} ms (plain {sh['plain_ms']:.4f}, bound "
                f"{sh['bound_ms']:.4f} by {sh['bound_by']}), max abs err "
                f"{sh['max_abs_err']:.3e}")
    torch.cuda.synchronize()
    return wide


# ---------------------------------------------------------------------------
# 4. main path
# ---------------------------------------------------------------------------

def _zero_names(path: str) -> str:
    """The regex of the parameters of ``path`` whose true gradient is 0
    (``ZERO_GRAD``, else a conv's bias)."""
    return ZERO_GRAD.get(path, r"convs\.\d+\.bias")


def _grad_rels(model, ref_model, zero: str) -> list:
    """Sorted (relative L2, name) of each parameter gradient of ``model``
    against ``ref_model``'s. A bias that feeds a BatchNorm is cancelled
    by it: its true gradient is 0, so it is checked to be noise-sized and
    left out of the list; ``zero`` matches such names (``_zero_names``)."""
    ref = dict(ref_model.named_parameters())
    scale = max(float(q.grad.abs().max()) for q in ref.values())
    rels = []
    for name, p in model.named_parameters():
        if re.fullmatch(zero, name):
            check(float(p.grad.abs().max()) <= 1e-4 * scale,
                  f"{name}: gradient is not noise-sized")
            continue
        rels.append((rel_l2(p.grad, ref[name].grad), name))
    return sorted(rels, reverse=True)


def _step_vs_cpu(path, loss_card, model_card, loss_cpu, model_cpu,
                 noise_models, cpu_s, same=None) -> dict:
    """One step on the card against the same step of the port on the CPU
    (loss and every gradient); beside it, how far the CPU step moves when
    its inputs carry 1e-7 relative noise (``noise_models``, one per noise
    seed; printed, not gated). Every gradient must agree within
    ``STEP_GRAD_REL_L2``. ``same``: ``(loss, model)`` of the CPU step that
    took the card step's branch at every kink; the gradients are then held
    against it instead, and the plain CPU step's are printed."""
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    check(loss_rel <= STEP_LOSS_RTOL,
          f"[{path}] step loss {loss_card} vs CPU {loss_cpu}")
    zero = _zero_names(path)
    rels = _grad_rels(model_card, model_cpu, zero)
    noise = [dict((name, r) for r, name in _grad_rels(m, model_cpu, zero))
             for m in noise_models]
    noise_worst = max((n[name], name) for n in noise for _, name in rels)
    over_flat = [(r, name) for r, name in rels if r > STEP_GRAD_REL_L2]
    step_cmp = {"loss_card": loss_card, "loss_cpu": loss_cpu,
                "grad_rel_l2_worst": rels[0], "grad_rel_l2_median":
                statistics.median(r for r, _ in rels),
                "grad_rel_l2": {name: r for r, name in rels},
                "noise_grad_rel_l2_worst": noise_worst,
                "noise_grad_rel_l2_worst_by_seed": [
                    max((r, name) for name, r in n.items()) for n in noise],
                "noise_grad_rel_l2_median": statistics.median(
                    r for n in noise for r in n.values()),
                "flat_gate_met": not over_flat, "cpu_step_seconds": cpu_s}
    log(f"[{path}] card vs CPU step: loss {loss_card:.7f} vs "
        f"{loss_cpu:.7f} (rel {loss_rel:.2e}); grad rel L2 worst "
        f"{rels[0]}, median {step_cmp['grad_rel_l2_median']:.2e}; CPU "
        f"step with 1e-7 input noise vs CPU ({len(noise)} seeds): worst "
        f"{noise_worst} (by seed "
        f"{[f'{w[0]:.2e}' for w in step_cmp['noise_grad_rel_l2_worst_by_seed']]}"
        f"), median {step_cmp['noise_grad_rel_l2_median']:.2e}; every "
        f"gradient within {STEP_GRAD_REL_L2:.0e}: {not over_flat}; CPU step "
        f"took {cpu_s:.1f} s")
    for r, name in over_flat:
        log(f"[{path}]   {name}: card vs CPU {r:.3e}; CPU noise "
            f"{[f'{n[name]:.2e}' for n in noise]}")
    if same is not None:
        loss_same, model_same = same
        same_loss_rel = abs(loss_card - loss_same) / abs(loss_same)
        rels = _grad_rels(model_card, model_same, zero)
        step_cmp.update(same_branch_loss_rel=same_loss_rel,
                        same_branch_grad_rel_l2_worst=rels[0],
                        same_branch_grad_rel_l2={name: r for r, name in rels})
        log(f"[{path}] card vs the CPU step on the card's branches: loss "
            f"rel {same_loss_rel:.2e}, grad rel L2 worst {rels[0]}, median "
            f"{statistics.median(r for r, _ in rels):.2e}")
        check(same_loss_rel <= STEP_LOSS_RTOL,
              f"[{path}] step loss {loss_card} vs same-branch CPU "
              f"{loss_same}")
    for r, name in rels:
        check(r <= STEP_GRAD_REL_L2,
              f"[{path}] {name}: grad rel L2 {r} vs "
              f"{'the same-branch ' if same else ''}CPU step, beyond "
              f"{STEP_GRAD_REL_L2}")
    return step_cmp


@contextlib.contextmanager
def _instantiations():
    """Yields the sets of what the block launches, by kernel family:
    ``gather``, the ``(F, primitives, masks)`` of every
    ``gather_reduce_fwd`` call that ``ops/dispatch`` makes (each names the
    forward and, with its masks, the backward instantiation); ``headmix``,
    the ``(H, B, A, L)`` of every head mix of the EGC convs; ``gat`` and
    ``gatv2``, the ``(H, C)`` of every attention call of the convs (the
    head mixes of the hetero convs too)."""
    from egc_tpu_torch.nn.conv import attention, egc, hetero
    from egc_tpu_torch.ops import dispatch
    seen = {"gather": set(), "headmix": set(), "gat": set(), "gatv2": set()}
    launch, mix = dispatch.gather_reduce_fwd, egc.head_mix_fused
    gat, gatv2 = attention.gat_attention, attention.gatv2_attention

    def record(vals, rowptr, senders, edge_w, prims, masks=(),
               fwd_to_bwd=None):
        seen["gather"].add((vals.shape[1], tuple(prims), tuple(masks)))
        return launch(vals, rowptr, senders, edge_w, prims, masks=masks,
                      fwd_to_bwd=fwd_to_bwd)

    def record_mix(w2d, ys, *, H, B, A, L, **kw):
        seen["headmix"].add((H, B, A, L))
        return mix(w2d, ys, H=H, B=B, A=A, L=L, **kw)

    def record_gat(wh, *args):
        seen["gat"].add(tuple(wh.shape[1:]))
        return gat(wh, *args)

    def record_gatv2(hl, *args):
        seen["gatv2"].add(tuple(hl.shape[1:]))
        return gatv2(hl, *args)

    dispatch.gather_reduce_fwd, egc.head_mix_fused = record, record_mix
    hetero.head_mix_fused = record_mix
    attention.gat_attention = record_gat
    attention.gatv2_attention = record_gatv2
    try:
        yield seen
    finally:
        dispatch.gather_reduce_fwd, egc.head_mix_fused = launch, mix
        hetero.head_mix_fused = mix
        attention.gat_attention, attention.gatv2_attention = gat, gatv2


def _check_held(label: str, seen: dict) -> None:
    """Fails unless every instantiation in ``seen`` (``_instantiations``)
    is one that phase 3 held against the plain version (``HELD``)."""
    for family, got in seen.items():
        check(got <= HELD[family],
              f"[{label}] launched {family} at {sorted(got - HELD[family])}, "
              f"which phase 3 did not hold")


def _check_path_instantiation(path: str, seen: dict) -> None:
    """An EGC path launched just the gather-reduce and the head mix whose
    times its kernel rows report (``PATH_GATHER``, ``PATH_HEADMIX``)."""
    check(seen["gather"] == {PATH_GATHER[path]}
          and seen["headmix"] == {PATH_HEADMIX[path]},
          f"[{path}] launched gather-reduce {sorted(seen['gather'])} and "
          f"head mix {sorted(seen['headmix'])}; phase 3 held "
          f"{PATH_GATHER[path]} and {PATH_HEADMIX[path]}")


def _wide_launches(path: str) -> dict:
    """Launches of each attention kernel a step of a ``WIDE_NETS`` path:
    its rows' sweeps (``attention.sweeps``), two layers at (3, 250) and
    one at (1, 750)."""
    from egc_tpu_torch.ops.cuda import attention as at
    v2 = WIDE_NETS[path]["kind"] == "gatv2"
    out = {}
    for (heads, c), layers in zip(WIDE_ROWS, (2, 1)):
        for sw in at.sweeps(heads, c, v2=v2):
            prefix = ("gatv2w" if sw.wide else "gatv2") if v2 else "gat"
            for k in ("fwd", "bwd_t", "bwd_f"):
                out[f"{prefix}_{k}"] = out.get(f"{prefix}_{k}", 0) + layers
    return out


def _norm_layers(model) -> int:
    """The ``MaskedBatchNorm`` layers of ``model``."""
    from egc_tpu_torch.nn.norm import MaskedBatchNorm
    return sum(isinstance(m, MaskedBatchNorm) for m in model.modules())


def _per_step(path: str, name: str, norms: int) -> int:
    """Launches of kernel ``name`` a training step of ``path``, whose
    model holds ``norms`` BatchNorm layers (``_norm_layers``)."""
    if name in BN_KERNELS:
        return norms if name in PATH_KERNELS[path] else 0
    if path in WIDE_NETS:
        return _wide_launches(path).get(name, 0)
    return PATH_LAYERS[path] if name in PATH_KERNELS[path] else 0


def phase_path(path: str, raw, data, d_cpu, net: dict,
               checked=None, same_branches: bool = False,
               idle: bool = False) -> dict:
    """One path ("main": EGC-M, "gat": GAT h152 H8, "gatv2": GATv2 h112
    H8, a conv-zoo path of ``ZOO_NETS`` or a ``WIDE_NETS`` path) through
    ``train_full_graph`` with the net arguments ``net``. ``checked``:
    ``(raw, data, d_cpu)`` of the graph the card step is held against the
    CPU step on, when not the path's own. ``same_branches``: the
    gradients are held against a CPU step that replays the card step's
    branch at every ReLU and leaky_relu (``_same_branches``; the plain CPU
    step's gap printed beside it). ``idle``: the device's busy time and
    idle share over two more steps (``_device_idle``)."""
    import torch
    from egc_tpu_torch.exp.fullgraph import train_full_graph, train_step
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    # one dropout-0 step on the card vs the same step of the port on the
    # CPU; beside it, how far the CPU step itself moves when its inputs
    # carry 1e-7 relative noise (the step's sensitivity to rounding)
    c_raw, c_data, c_cpu = checked or (raw, data, d_cpu)
    if path == "mpnn_max":    # the premise of its message biases' ZERO_GRAD
        deg = c_data["graph"].kernel_plan.deg[:c_raw["x"].shape[0]]
        check(bool((deg > 0).all()), f"[{path}] a real node without in-edges")
    cpu_branches, branches = {}, {}
    t0 = time.perf_counter()
    with _same_branches(cpu_branches, replay=False) if same_branches \
            else contextlib.nullcontext():
        cpu = train_full_graph(c_raw, steps=1, dropout=0.0, data=c_cpu,
                               device="cpu", **net)
    cpu_s = time.perf_counter() - t0
    g = c_cpu["graph"]
    noise = torch.randn(g.nodes.shape,
                        generator=torch.Generator().manual_seed(1))
    pert = train_full_graph(
        c_raw, steps=1, dropout=0.0, device="cpu",
        data={**c_cpu, "graph": g.replace(nodes=g.nodes * (1 + 1e-7 * noise))},
        **net)
    with _same_branches(branches, replay=False) if same_branches \
            else contextlib.nullcontext():
        gpu = train_full_graph(c_raw, steps=1, dropout=0.0, data=c_data,
                               **net)
    same, flips = None, None
    if same_branches:
        with _same_branches(branches, replay=True):
            rep = train_full_graph(c_raw, steps=1, dropout=0.0, data=c_cpu,
                                   device="cpu", **net)
        same = (rep.losses[0], rep.model)
        # by layer: (edge leaky_relu, self leaky_relu, ReLU)
        flips = [int((a != b).sum()) for a, b in zip(branches["kinks"],
                                                     cpu_branches["kinks"])]
        log(f"[{path}] kinks where the card step and the CPU step take "
            f"other branches, by layer (edges, self, ReLU): "
            f"{[flips[i:i + 3] for i in range(0, len(flips), 3)]} of "
            f"{[int(m.numel()) for m in branches['kinks'][:3]]}")
        del rep
    step_cmp = _step_vs_cpu(path, gpu.losses[0], gpu.model, cpu.losses[0],
                            cpu.model, [pert.model], cpu_s, same=same)
    if flips is not None:
        step_cmp["branches_apart"] = flips
    step_cmp["graph_nodes"] = c_raw["x"].shape[0]
    step_cmp["graph_edges"] = c_data["num_edges"]
    del cpu, gpu, pert

    # the timed path, counters reset just before and read just after: each
    # kernel of the path launches 3 times per step (the BatchNorm kernels
    # once a MaskedBatchNorm layer), every other kernel never
    steps = STEPS_WARMUP + STEPS_TIMED
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with _instantiations() as seen:
        run = train_full_graph(raw, steps=steps, dropout=0.2, data=data,
                               **net)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _check_held(path, seen)
    if path in PATH_GATHER:   # the instantiation the kernel rows hold
        check(seen["gather"] == {PATH_GATHER[path]},
              f"[{path}] gather-reduce launched as {sorted(seen['gather'])}, "
              f"the kernel rows hold {PATH_GATHER[path]}")
    norms = _norm_layers(run.model)
    for name, c in _variant_counts(
            counts, f"[{path}]", _path_tiled(path), seen=seen).items():
        want = _per_step(path, name, norms) * steps
        check(c == want, f"[{path}] {name} launched {c} times in {steps} "
                         f"steps, expected {want}")
    check(all(math.isfinite(x) for x in run.losses), "non-finite loss")
    # the step time is the whole timed window over its steps, so a stall
    # anywhere in the window counts; the median stands beside it
    timed = run.step_seconds[STEPS_WARMUP:]
    step_s = sum(timed) / len(timed)
    res = {"net": net, "step_seconds_mean": step_s,
           "step_seconds_median": statistics.median(timed),
           "step_seconds": timed,
           "edges_per_s": data["num_edges"] / step_s,
           "num_edges": data["num_edges"], "num_nodes": raw["x"].shape[0],
           "peak_memory_bytes": peak, "launches": counts,
           "losses": run.losses, "step_vs_cpu": step_cmp}
    log(f"[{path}] {steps} steps: losses {[round(x, 4) for x in run.losses]}")
    med = res["step_seconds_median"]
    log(f"[{path}] step {step_s * 1e3:.3f} ms (mean over {len(timed)} timed "
        f"steps; median {med * 1e3:.3f}, min {min(timed) * 1e3:.3f}, max "
        f"{max(timed) * 1e3:.3f}), "
        f"{res['edges_per_s'] / 1e6:.3f} M edges/s, peak memory "
        f"{peak / 2**30:.3f} GiB, launches {counts}")
    res["profile"] = _profile(run, data, path)
    if idle:
        gen = torch.Generator(device=data["device"]).manual_seed(2)
        res["idle"] = _device_idle(
            lambda: train_step(run.model, run.optimizer, data, gen), step_s)
        log(f"[{path}] device busy {res['idle']['device_busy_s'] * 1e3:.3f} "
            f"ms a step, idle share {res['idle']['idle_share']:.3f}; "
            f"largest device ops (ms a step): " + "; ".join(
                f"{ms:.3f} {op[:50]}"
                for op, ms in res["idle"]["top_ops_ms"][:8]))
    return res


def _profile(run, data, path) -> str:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from egc_tpu_torch.exp.fullgraph import train_step
    gen = torch.Generator(device=data["device"]).manual_seed(1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            train_step(run.model, run.optimizer, data, gen)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    table = averages.table(sort_by="cuda_time_total", row_limit=25)
    log(f"[profile] {path}, two steps:\n" + table)
    glue = _attention_glue(averages, 2)
    if glue:
        log(f"[profile] {path}: device ms a step of the attention autograd "
            f"Functions (kernels = their own time, the ctypes launches; "
            f"around = their aten ops: input and g_o copies, the sweeps' "
            f"column slices, output scatters and zero fills): {glue}")
    return table


def _attention_glue(averages, steps: int) -> dict:
    """By attention autograd Function (``_GATAttention``, its backward,
    the GATv2 pair), device ms a step: ``kernels``, its self time (the
    ctypes launches, which the profiler puts on the enclosing op), and
    ``around``, the rest of its total (the aten ops it runs)."""
    def dev(evt, key):
        return (getattr(evt, key.replace("cuda", "device"), None)
                or getattr(evt, key, 0.0)) / 1e3 / steps
    return {evt.key: {"kernels": round(dev(evt, "self_cuda_time_total"), 3),
                      "around": round(dev(evt, "cuda_time_total")
                                      - dev(evt, "self_cuda_time_total"), 3)}
            for evt in averages if evt.key.startswith(("_GATAttention",
                                                       "_GATv2Attention"))}


def _batched_noise_steps(cfg, hp) -> list:
    """A batched path's CPU step with 1e-7 relative noise on the embedding
    (code2's and zinc's inputs are token ids, cifar's enter through it),
    once per ``CODE_NOISE_SEEDS``: the step's sensitivity to rounding."""
    import torch
    from egc_tpu_torch.train.loop import train_step
    batch = next(iter(cfg.data(hp, "cpu")["train"]))
    models = []
    for seed in CODE_NOISE_SEEDS:
        model = cfg.model(hp, seed=0, device="cpu")
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for w in model.embedding.parameters():
                w.mul_(1 + 1e-7 * torch.randn(w.shape, generator=gen))
        train_step(model, cfg.optimizer(model, hp), cfg.loss_fn, *batch)
        models.append(model)
    return models


@contextlib.contextmanager
def _same_branches(masks: dict, replay: bool):
    """The branch a batched step (or an rmag step) takes at every kink:
    each GAT / GATv2 conv's leaky_relu on its edges and on its self term,
    and every ``torch.relu`` (the ReLU after each BatchNorm and in the
    readout MLP, std's gate on var; rmag's after its REGConv), in the
    order the step meets them (``masks["kinks"]``); and which in-edges
    hold each EGC conv's and each REGConv relation's max / min
    (``masks["extrema"]``, [E, F] in edge order). ``replay=False``
    appends each branch's mask (from the same f32 sums the card's kernels
    form); ``replay=True`` makes the CPU step take them, the extrema's
    cotangent going to the recorded edges, so it evaluates the same
    piecewise-smooth function as the card step and the two differ by
    rounding alone."""
    import torch
    from egc_tpu_torch.nn.conv import attention as at
    from egc_tpu_torch.nn.conv import egc, hetero
    from egc_tpu_torch.ops import segment
    from egc_tpu_torch.ops.cuda.attention import SLOPE
    saved = (at._leaky, torch.relu, at.GATConv.forward,
             at.GATv2Conv.forward, egc.conv_aggregate,
             segment._segment_max_raw, hetero._rel_multi_aggregate)
    kinks, extrema = masks.setdefault("kinks", []), \
        masks.setdefault("extrema", [])
    queues = {"kinks": iter(kinks), "extrema": iter(extrema)}

    def take(z, queue="kinks"):
        m = next(queues[queue], None)
        check(m is not None and m.shape == z.shape,
              f"replayed branches: {None if m is None else m.shape} for "
              f"{tuple(z.shape)}")
        return m

    def recording(forward, sums):
        def fwd(self, g, x, **kw):
            def project(xx):
                out = type(self).project(self, xx)
                s, r = g.senders.long(), g.receivers.long()
                kinks.extend((z >= 0).cpu() for z in sums(out, s, r))
                return out
            self.project = project
            try:
                return forward(self, g, x, **kw)
            finally:
                del self.project
        return fwd

    def relu(t):
        kinks.append((t > 0).cpu())
        return saved[1](t)

    def record_extrema(g, x, aggrs, **kw):
        out = saved[4](g, x, aggrs, **kw)
        ys = out if isinstance(out, tuple) else out.unbind(1)
        s, r = g.senders.long(), g.receivers.long()
        valid = g.edge_mask[:, None]
        for a, y in zip(aggrs, ys):
            if segment.canonical_aggr(a) in ("max", "min"):
                extrema.append(((x[s] == y[r]) & valid).cpu())
        return out

    class ReplayedMax(torch.autograd.Function):
        """The segment max, its cotangent to the recorded edges."""

        @staticmethod
        def forward(ctx, data, ids, num_segments, held):
            ctx.save_for_backward(ids, held)
            return saved[5](data.detach(), ids, num_segments)

        @staticmethod
        def backward(ctx, ct):
            ids, held = ctx.saved_tensors
            safe = torch.clamp(ids, max=ct.shape[0] - 1)
            return torch.where(held, ct[safe], torch.zeros_like(held,
                               dtype=ct.dtype)), None, None, None

    @contextlib.contextmanager
    def replayed_max():
        segment._segment_max_raw = lambda data, ids, n: ReplayedMax.apply(
            data, ids, n, take(data, "extrema"))
        try:
            yield
        finally:
            segment._segment_max_raw = saved[5]

    def replay_extrema(g, x, aggrs, **kw):
        with replayed_max():
            return saved[4](g, x, aggrs, **kw)

    def record_rel(hg, key, x_src, n_dst, aggrs):
        out = saved[6](hg, key, x_src, n_dst, aggrs)
        s, r = hg.senders[key].long(), hg.receivers[key].long()
        valid = hg.edge_mask[key][:, None]
        for a, name in enumerate(aggrs):
            if name in ("max", "min"):
                extrema.append(((x_src[s] == out[r, a]) & valid).cpu())
        return out

    def replay_rel(hg, key, x_src, n_dst, aggrs):
        with replayed_max():
            return saved[6](hg, key, x_src, n_dst, aggrs)

    if replay:
        at._leaky = lambda z: torch.where(take(z), z, SLOPE * z)
        torch.relu = lambda t: torch.where(take(t), t, torch.zeros_like(t))
        egc.conv_aggregate = replay_extrema
        hetero._rel_multi_aggregate = replay_rel
    else:   # GAT: a_src[s] + a_dst[r]; GATv2: hl[s] + hr[r]; then self
        at.GATConv.forward = recording(
            saved[2], lambda o, s, r: (o[1][s] + o[2][r], o[1] + o[2]))
        at.GATv2Conv.forward = recording(
            saved[3], lambda o, s, r: (o[0][s] + o[1][r], o[0] + o[1]))
        torch.relu = relu
        egc.conv_aggregate = record_extrema
        hetero._rel_multi_aggregate = record_rel
    try:
        yield
    finally:
        (at._leaky, torch.relu, at.GATConv.forward, at.GATv2Conv.forward,
         egc.conv_aggregate, segment._segment_max_raw,
         hetero._rel_multi_aggregate) = saved
    if replay:
        check(all(next(q, None) is None for q in queues.values()),
              "replayed branches left over")


def _graphs_per_step(loader, steps: int) -> list:
    """Real graphs in each of the first ``steps`` batches of a loader's
    epochs (the last batch of an epoch is short)."""
    n, bs = len(loader.graphs), loader.batch_size
    sizes = [min(bs, n - k * bs) for k in range(len(loader))]
    return [sizes[i % len(sizes)] for i in range(steps)]


def phase_code_path(path: str, net: dict) -> dict:
    """One ogbg-code2 path ("code_gat": CodeNet GAT h304 H8, "code_gatv2":
    GATv2 h296 H8; 4 layers, vocab 5000, 10,030 attributes, batch 128) on
    ``synthetic_code(900)``, ``CODE_STEPS`` steps (``_batched_path``)."""
    from egc_tpu_torch.exp.batched import CodeConfig
    cfg = CodeConfig(net["kind"], net["hidden"], heads=net["heads"],
                     **CODE_DATA)
    return _batched_path(path, cfg, CODE_HP, CODE_STEPS)


def phase_batched_path(path: str, net: dict) -> dict:
    """One EGC-M path of a batched task (``BATCHED_NETS``: zinc h124, cifar
    h128, hiv h224; H4 B4, 4 layers) through its config on the config's
    synthetic set, at the main table's hyperparameters: 2 warm-up steps
    and one whole epoch timed (``_batched_path``)."""
    from egc_tpu_torch.exp import batched
    cfg = getattr(batched, net["config"])("egc", net["hidden"], heads=4,
                                          bases=4, aggrs=net["aggrs"])
    epoch = math.ceil(len(cfg.load_graphs()["train"])
                      / net["hp"]["batch_size"])
    return _batched_path(path, cfg, net["hp"], STEPS_WARMUP + epoch)


def _batched_path(path: str, cfg, hp: dict, steps: int) -> dict:
    """A batched path through ``train_batched`` with the loader's prefetch:
    one dropout-0 step on the card against the CPU step that takes the
    card's branch at every kink (and, printed, the plain CPU step), then
    ``steps`` steps with the launch counters (each kernel of the path once
    a layer a step, the BatchNorm kernels once a MaskedBatchNorm layer,
    every other kernel never; an EGC path's gather-reduce
    and head-mix instantiations the ones phase 3 held), a val pass (the
    config's metric), and a profiler table of two steps split into the
    host's batch fetch, its step enqueue, its wait on the card, and the
    card's busy time."""
    import torch
    from egc_tpu_torch.exp.batched import evaluate, train_batched
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    check_hp = {**hp, "dropout": 0.0} if "dropout" in hp else hp
    t0 = time.perf_counter()
    cpu_branches, branches = {}, {}
    with _same_branches(cpu_branches, replay=False):
        cpu = train_batched(cfg, check_hp, steps=1, device="cpu")
    cpu_s = time.perf_counter() - t0
    pert = _batched_noise_steps(cfg, check_hp)
    with _same_branches(branches, replay=False):
        gpu = train_batched(cfg, check_hp, steps=1)
    with _same_branches(branches, replay=True):
        same = train_batched(cfg, check_hp, steps=1, device="cpu")
    # where the card step and the CPU step part, kink site by site (code2:
    # per layer, (edge leaky_relu, self leaky_relu, ReLU)), and at how many
    # (edge, column) the max / min is held by other in-edges
    flips = [int((a != b).sum()) for a, b in zip(branches["kinks"],
                                                 cpu_branches["kinks"])]
    sizes = [int(m.numel()) for m in branches["kinks"]]
    if path.startswith("code"):
        flips = [flips[i:i + 3] for i in range(0, len(flips), 3)]
        sizes = sizes[:3]
    held = [int((a != b).sum()) for a, b in zip(branches["extrema"],
                                                cpu_branches["extrema"])]
    log(f"[{path}] kinks where the card step and the CPU step take other "
        f"branches (padding rows included): {flips} of {sizes}; max / min "
        f"held by other in-edges at {held} (edge, column) pairs of "
        f"{[int(m.numel()) for m in branches['extrema']]}")
    step_cmp = _step_vs_cpu(path, gpu.step_losses[0], gpu.model,
                            cpu.step_losses[0], cpu.model, pert, cpu_s,
                            same=(same.step_losses[0], same.model))
    step_cmp["branches_apart"] = flips
    step_cmp["extrema_apart"] = held
    del cpu, gpu, pert, same, branches, cpu_branches

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with _instantiations() as seen:
        run = train_batched(cfg, hp, steps=steps)
    counts = launch_counts()
    data = run.data
    peak = torch.cuda.max_memory_allocated()
    norms = _norm_layers(run.model)
    for name, c in _variant_counts(
            counts, f"[{path}]", _path_tiled(path), seen=seen).items():
        want = _per_step(path, name, norms) * steps
        check(c == want, f"[{path}] {name} launched {c} times in {steps} "
                         f"steps, expected {want}")
    _check_held(path, seen)
    if path in PATH_GATHER:
        _check_path_instantiation(path, seen)
    check(all(math.isfinite(x) for x in run.step_losses), "non-finite loss")
    val = evaluate(cfg, run.model, data["val"], "val")
    check(all(math.isfinite(v) and (0.0 <= v <= 1.0
                                    or not k.endswith("_metric"))
              for k, v in val.items()), f"[{path}] val {val}")
    # the step time is the whole timed window over its steps (CUDA events
    # at the step boundaries, no host synchronise in the loop), with and
    # without the steps that open an epoch (a new prefetch pool whose first
    # batch the step waits for, and the last epoch's losses read)
    epoch = len(data["train"])
    check(steps - STEPS_WARMUP >= epoch,
          f"{steps} steps: under one epoch of {epoch} timed")
    graphs = _graphs_per_step(data["train"], steps)
    timed = list(range(STEPS_WARMUP, steps))
    inner = [i for i in timed if i % epoch]

    def window(idx):
        sec = [run.step_seconds[i] for i in idx]
        return {"steps": len(idx), "mean_s": sum(sec) / len(sec),
                "median_s": statistics.median(sec),
                "graphs_per_s": sum(graphs[i] for i in idx) / sum(sec)}

    whole = window(timed)
    mid = window(inner) if inner else whole
    step_s = whole["mean_s"]
    res = {"hparams": hp, "steps": steps, "epoch_batches": epoch,
           "step_seconds_mean": step_s,
           "step_seconds_median": whole["median_s"],
           "step_seconds": run.step_seconds[STEPS_WARMUP:],
           "graphs_per_s": whole["graphs_per_s"],
           "without_epoch_starts": mid,
           "budget": data["train"].budget, "peak_memory_bytes": peak,
           "build_seconds_per_batch": data["train"].build_seconds / steps,
           "launches": counts, "losses": run.step_losses, "val": val,
           "step_vs_cpu": step_cmp}
    sec = res["step_seconds"]
    log(f"[{path}] {steps} steps: losses "
        f"{[round(x, 4) for x in run.step_losses]}; val {val}")
    log(f"[{path}] step {step_s * 1e3:.3f} ms (whole window over "
        f"{len(timed)} steps after {STEPS_WARMUP} warm-up, epochs of "
        f"{epoch} batches; median {whole['median_s'] * 1e3:.3f}, min "
        f"{min(sec) * 1e3:.3f}, max {max(sec) * 1e3:.3f}), "
        f"{whole['graphs_per_s']:.1f} graphs/s; without the "
        f"{len(timed) - len(inner)} epoch starts: mean "
        f"{mid['mean_s'] * 1e3:.3f} ms, median {mid['median_s'] * 1e3:.3f}"
        f", {mid['graphs_per_s']:.1f} graphs/s; budget "
        f"{data['train'].budget}, peak memory {peak / 2**30:.3f} GiB, batch "
        f"and plan build {res['build_seconds_per_batch'] * 1e3:.3f} ms a "
        f"batch on the prefetch threads, launches {counts}")
    res["profile"], res["split"] = _profile_code(run, cfg, data, path)
    return res


def mag_data(dev):
    """The mag path's graph (``MAG_GRAPH``), generated on the host, and its
    card data through ``MagConfig.data`` (padding, symnorm weights, the
    kernel plan: two ``lexsort``s over every edge): the config, the raw
    graph and the data, with the seconds of each part."""
    from egc_tpu_torch.data.synthetic import synthetic_full_graph
    from egc_tpu_torch.exp import fullgraph

    class MagAtSize(fullgraph.MagConfig):
        def load_full_graph(self):
            return self.raw

    t0 = time.perf_counter()
    raw = synthetic_full_graph(**MAG_GRAPH)
    gen_s = time.perf_counter() - t0
    cfg = MagAtSize("egc", MAG_NET["hidden"], heads=MAG_NET["heads"],
                    bases=MAG_NET["bases"], aggrs=MAG_NET["aggrs"],
                    device=dev)
    cfg.raw = raw
    plan_s, build = [], fullgraph.build_kernel_plan

    def timed_build(*a, **kw):
        t = time.perf_counter()
        try:
            return build(*a, **kw)
        finally:
            plan_s.append(time.perf_counter() - t)

    fullgraph.build_kernel_plan = timed_build
    t0 = time.perf_counter()
    try:
        data = cfg.data(MAG_NET["hp"])
    finally:
        fullgraph.build_kernel_plan = build
    data_s = time.perf_counter() - t0
    secs = {"generate_s": gen_s, "data_s": data_s, "plan_s": plan_s[0]}
    log(f"[mag] synthetic_full_graph({MAG_GRAPH}): {raw['x'].shape[0]} "
        f"nodes, {data['num_edges']} directed edges ({gen_s:.1f} s on the "
        f"host); MagConfig.data {data_s:.1f} s, of it the host plan build "
        f"(two lexsorts) {plan_s[0]:.1f} s")
    return cfg, raw, data, secs


def phase_mag(cfg, raw, data, secs: dict, main_cpu_s: float,
              elapsed: float) -> dict:
    """Homogeneous ogbn-mag through ``MagConfig``'s hooks (``model``,
    ``init_state``, ``train``): MagNet h352 H8 B4 symnorm, 2 layers, lr
    0.01, wd 1e-5, dropout 0.3 on the ``MAG_GRAPH`` graph. One dropout-0
    ``train`` iteration on the card against the same on the CPU, on a
    graph of 1/8 the nodes when the full-size CPU steps would end past
    ``MAG_BUDGET_S``; then 2 warm-up and 10 timed iterations (host clock
    around each, which ends in the loss read) with the launch counters
    (each EGC kernel twice a step, every other kernel never) and the
    gather-reduce and head-mix instantiations, edges/s, peak memory, and a
    profiler table of two steps."""
    import types
    import torch
    from egc_tpu_torch.data.synthetic import synthetic_full_graph
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    path, hp = "mag", MAG_NET["hp"]
    hp0 = {**hp, "dropout": 0.0}
    # a mag step gathers 2 x 11 M edges x 176 columns; main's 3 x 2.4 M x
    # 128: the CPU step scales with that
    work = 2 * data["num_edges"] * 176 / (3 * NUM_EDGES * 128)
    projected = elapsed + 2 * work * main_cpu_s
    c_cfg, c_raw, c_data = cfg, raw, data
    if projected > MAG_BUDGET_S:
        c_raw = synthetic_full_graph(**{**MAG_GRAPH,
                                        "num_nodes": MAG_GRAPH["num_nodes"]
                                        // 8})
        c_cfg = type(cfg)("egc", MAG_NET["hidden"], heads=MAG_NET["heads"],
                          bases=MAG_NET["bases"], aggrs=MAG_NET["aggrs"])
        c_cfg.raw = c_raw
        c_data = c_cfg.data(hp0)
        log(f"[mag] step check on a graph of 1/8 the nodes "
            f"({c_raw['x'].shape[0]} nodes, {c_data['num_edges']} edges, "
            f"average degree 15): two full-size CPU steps would take the "
            f"script to ~{projected:.0f} s, past {MAG_BUDGET_S} s; the timed "
            f"steps and the kernel rows stay at full size")
    else:
        log(f"[mag] step check on the full graph (projected "
            f"{projected:.0f} s <= {MAG_BUDGET_S} s)")
    cpu_cfg = type(cfg)("egc", MAG_NET["hidden"], heads=MAG_NET["heads"],
                        bases=MAG_NET["bases"], aggrs=MAG_NET["aggrs"],
                        device="cpu")
    cpu_cfg.raw = c_raw
    d_cpu = cpu_cfg.data(hp0)

    def one_step(config, d):
        model = config.model(hp0, seed=0)
        state = config.init_state(model, hp0, d, 0)
        _, row = config.train(model, state, d, config.rng(0), 0)
        return row["train_loss"], model

    t0 = time.perf_counter()
    loss_cpu, model_cpu = one_step(cpu_cfg, d_cpu)
    cpu_s = time.perf_counter() - t0
    g = d_cpu["graph"]
    noise = torch.randn(g.nodes.shape,
                        generator=torch.Generator().manual_seed(1))
    _, model_pert = one_step(cpu_cfg, {
        **d_cpu, "graph": g.replace(nodes=g.nodes * (1 + 1e-7 * noise))})
    loss_card, model_card = one_step(c_cfg, c_data)
    step_cmp = _step_vs_cpu(path, loss_card, model_card, loss_cpu,
                            model_cpu, [model_pert], cpu_s)
    step_cmp["graph_nodes"] = c_raw["x"].shape[0]
    step_cmp["graph_edges"] = c_data["num_edges"]
    del d_cpu, model_cpu, model_pert, model_card, c_data, g, noise

    steps = STEPS_WARMUP + STEPS_TIMED
    model = cfg.model(hp, seed=0)
    state = cfg.init_state(model, hp, data, 0)
    rng = cfg.rng(0)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, seconds = [], []
    with _instantiations() as seen:
        for it in range(steps):
            t0 = time.perf_counter()
            state, row = cfg.train(model, state, data, rng, it)
            seconds.append(time.perf_counter() - t0)   # the loss was read
            losses.append(row["train_loss"])
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _check_held(path, seen)
    _check_path_instantiation(path, seen)
    for name, c in _variant_counts(
            counts, f"[{path}]", _path_tiled(path), seen=seen).items():
        want = PATH_LAYERS[path] * steps if name in PATH_KERNELS[path] \
            else 0
        check(c == want, f"[{path}] {name} launched {c} times in {steps} "
                         f"steps, expected {want}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    timed = seconds[STEPS_WARMUP:]
    step_s = sum(timed) / len(timed)
    res = {"net": {k: v for k, v in MAG_NET.items()}, **secs,
           "step_seconds_mean": step_s,
           "step_seconds_median": statistics.median(timed),
           "step_seconds": timed,
           "edges_per_s": data["num_edges"] / step_s,
           "num_edges": data["num_edges"], "num_nodes": raw["x"].shape[0],
           "peak_memory_bytes": peak, "launches": counts, "losses": losses,
           "step_vs_cpu": step_cmp}
    log(f"[{path}] {steps} steps: losses {[round(x, 4) for x in losses]}")
    log(f"[{path}] step {step_s * 1e3:.3f} ms (mean over {len(timed)} timed "
        f"steps; median {res['step_seconds_median'] * 1e3:.3f}, min "
        f"{min(timed) * 1e3:.3f}, max {max(timed) * 1e3:.3f}), "
        f"{res['edges_per_s'] / 1e6:.3f} M edges/s, peak memory "
        f"{peak / 2**30:.3f} GiB, launches {counts}")
    res["profile"] = _profile(types.SimpleNamespace(
        model=model, optimizer=state), data, path)
    return res


def _sampled_config(device_sampler: bool, device, num_features: int):
    """``SampledMagConfig`` of MagNet h352 H8 B4 symnorm at ``SAMPLED``'s
    fanouts and batch; the model reads ``num_features`` (``full_data``
    records it where the config builds its own data)."""
    from egc_tpu_torch.exp.fullgraph import SampledMagConfig
    cfg = SampledMagConfig("egc", MAG_NET["hidden"], heads=MAG_NET["heads"],
                           bases=MAG_NET["bases"], aggrs=MAG_NET["aggrs"],
                           device=device, device_sampler=device_sampler,
                           **SAMPLED)
    cfg._num_features = num_features
    return cfg


def _sampled_window(path: str, cfg, sdata) -> dict:
    """``SAMPLED_WARMUP`` + ``SAMPLED_TIMED`` steps of one branch through
    ``SampledMagConfig.batches`` and ``sampled_step`` (MAG_NET's
    hyperparameters) with the launch counters reset just before and read
    just after (each EGC kernel twice a step, no other kernel) and the
    gather-reduce and head-mix instantiations; the timed window on the host
    clock to the losses' read (step ms), each step's CUDA-event span
    (median), the consumer's wait for each batch, seeds/s, valid sampled
    edges/s, peak memory; then a profiler window of two more steps (device
    busy and idle share). Returns the results, the model and its
    optimizer."""
    import torch
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from egc_tpu_torch.train.loop import StepClock
    from egc_tpu_torch.utils import device_op_table, profile_trace
    hp = MAG_NET["hp"]
    dev = sdata["device"]
    model = cfg.model(hp, seed=0)
    opt = cfg.init_state(model, hp, sdata, 0)
    batches = cfg.batches(sdata, cfg.rng(0), 0)
    clock = StepClock(dev)
    steps = SAMPLED_WARMUP + SAMPLED_TIMED
    losses, edges, waits = [], [], []

    def step():
        t = time.perf_counter()
        gen, g, y, m, gids = next(batches)
        waits.append(time.perf_counter() - t)
        losses.append(cfg.sampled_step(model, opt, sdata["x_full"], g, y, m,
                                       gids, generator=gen))
        edges.append(g.edge_mask.sum())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with _instantiations() as seen:
        for i in range(steps):
            if i == SAMPLED_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                clock.start()
            step()
            if i >= SAMPLED_WARMUP:
                clock.mark()
        loss_values = torch.stack(losses).tolist()
        window = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _check_held(path, seen)
    _check_path_instantiation(path, seen)
    for name, c in _variant_counts(
            counts, f"[{path}]", _path_tiled(path), seen=seen).items():
        want = PATH_LAYERS[path] * steps if name in PATH_KERNELS[path] \
            else 0
        check(c == want, f"[{path}] {name} launched {c} times in {steps} "
                         f"steps, expected {want}")
    check(all(math.isfinite(x) for x in loss_values), "non-finite loss")
    timed_edges = int(torch.stack(edges[SAMPLED_WARMUP:]).sum())
    per_step = clock.seconds()
    with profile_trace() as prof:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        pwin = time.perf_counter() - t1
    batches.close()
    ops = device_op_table(prof)
    busy = sum(v for _, v in ops) / 1e6
    check(busy > 0, f"[{path}] the profiler saw no device time")
    res = {"net": dict(MAG_NET), **SAMPLED, "steps": steps,
           "step_seconds_mean": window / SAMPLED_TIMED,
           "step_seconds_median": statistics.median(per_step),
           "step_seconds": per_step,
           "seeds_per_s": SAMPLED["batch_size"] * SAMPLED_TIMED / window,
           "edges_per_s": timed_edges / window,
           "valid_edges_per_step": timed_edges / SAMPLED_TIMED,
           "wait_seconds_median": statistics.median(
               waits[SAMPLED_WARMUP:steps]),
           "peak_memory_bytes": peak, "launches": counts,
           "losses": loss_values,
           "profile": {"window_s": pwin / 2, "device_busy_s": busy / 2,
                       "busy_share": busy / pwin,
                       "idle_share": 1 - busy / pwin,
                       "top_ops_us": ops[:8]}}
    log(f"[{path}] {steps} steps: losses "
        f"{[round(x, 4) for x in loss_values]}")
    log(f"[{path}] step {res['step_seconds_mean'] * 1e3:.3f} ms (the "
        f"{SAMPLED_TIMED}-step window; median of the CUDA-event spans "
        f"{res['step_seconds_median'] * 1e3:.3f}), "
        f"{res['seeds_per_s']:.1f} seeds/s, "
        f"{res['edges_per_s'] / 1e6:.3f} M valid sampled edges/s "
        f"({res['valid_edges_per_step']:.0f} a step), consumer wait median "
        f"{res['wait_seconds_median'] * 1e3:.3f} ms, peak memory "
        f"{peak / 2**30:.3f} GiB, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    log(f"[{path}] profiler, two steps: window {pwin / 2 * 1e3:.3f} ms a "
        f"step, device busy {busy / 2 * 1e3:.3f} (busy share "
        f"{busy / pwin:.3f}, idle share {1 - busy / pwin:.3f}); top device "
        f"ops {[(k[:40], round(v / 2e3, 3)) for k, v in ops[:6]]} ms a step")
    return res, model, opt


def phase_sampled_mag(cfg, raw, data) -> dict:
    """Neighbour-sampled ogbn-mag (``SampledMagConfig``, MagNet h352 H8 B4
    symnorm at fanouts (15, 10), batch 512) on the mag path's graph and
    card data (``MAG_GRAPH``; the eval dict, its plan and ``x_full`` are
    ``MagConfig``'s, not built again). (b) On one host-sampled batch the
    card-built plan (``build_kernel_plan_device``) equals the host plan
    field for field on the valid prefix; (c) kernels 1-4 on that plan
    (``_gather_entries``, ``_headmix_entries``); (d) a dropout-0 card
    step against the port's CPU step on the same batch. (a, f) Each
    branch, the host sampler on its prefetch threads and the device
    sampler, through ``_sampled_window``, with the host branch's build a
    batch (thread wall time) and the host plan's build beside the card
    plan's, and the device branch's sample and plan by CUDA events; (e)
    one full-graph ``val`` on the card; (g) ``--sampled`` and
    ``--device-sampler`` ``--check --check-epochs 1`` through the CLI.
    Returns the results by path, the kernel entries, and the rest."""
    import ast
    import tempfile
    import torch
    from egc_tpu_torch.data.sampling import SampledNodeLoader
    from egc_tpu_torch.ops import dispatch
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    dev = data["device"]
    n, nfeat = raw["x"].shape
    hcfg = _sampled_config(False, dev, nfeat)
    t0 = time.perf_counter()
    hdata = hcfg.sampling_data(raw, data)
    loader = hdata["loader"]
    sampler = loader.sampler
    sampler_s = time.perf_counter() - t0
    log(f"[sampled_mag] host sampler over {data['num_edges']} edges built "
        f"in {sampler_s:.2f} s; batches of {loader.node_budget} rows and "
        f"{loader.edge_budget} edge slots")

    # (b) one host-sampled batch: its host plan against the card's
    plan_s, build = [], dispatch.build_kernel_plan

    def timed_build(*a, **kw):
        t = time.perf_counter()
        try:
            return build(*a, **kw)
        finally:
            plan_s.append(time.perf_counter() - t)

    planned = SampledNodeLoader(sampler, raw["x"], raw["y"],
                                raw["train_idx"], SAMPLED["batch_size"],
                                rng_seed=1, kernel_plans=True,
                                gather_on_device=True)
    dispatch.build_kernel_plan = timed_build
    try:
        it = iter(planned)
        host_items = [next(it) for _ in range(3)]
        it.close()
    finally:
        dispatch.build_kernel_plan = build
    item = tuple(t.to(dev) for t in host_items[0])
    g = item[0]
    dplan = dispatch.build_kernel_plan_device(g.senders, g.receivers,
                                              g.num_nodes,
                                              edge_mask=g.edge_mask)
    hplan = g.kernel_plan
    e = int(hplan.rowptr[-1])
    for name in ("rowptr", "colptr", "deg", "fwd_senders", "fwd_perm",
                 "bwd_receivers", "bwd_perm", "fwd_to_bwd"):
        a, b = getattr(dplan, name), getattr(hplan, name)
        a = a if name in ("rowptr", "colptr", "deg") else a[:e]
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"[sampled_mag] the card-built plan's {name} differs from the "
              f"host plan's")
    check(int(dplan.rowptr[-1]) == int(dplan.colptr[-1]) == e
          == int(g.edge_mask.sum()), "[sampled_mag] valid edge counts")
    plan_card_ms = time_ms(lambda: dispatch.build_kernel_plan_device(
        g.senders, g.receivers, g.num_nodes, edge_mask=g.edge_mask))
    log(f"[sampled_mag] (b) the card-built plan equals the host plan on "
        f"the valid prefix ({e} of {g.num_edges} edge slots, {g.num_nodes} "
        f"rows); plan build: host {[round(x * 1e3, 3) for x in plan_s]} ms "
        f"(SampledNodeLoader(kernel_plans=True), three batches), card "
        f"{plan_card_ms:.4f} ms (CUDA events)")

    # (c) kernels 1-4 on that plan
    gen = torch.Generator(device=dev).manual_seed(15)
    kernels = _gather_entries(dplan, {"sampled": NEW_GATHER["mag"]}, gen)
    fwd, bwd = _headmix_entries("sampled", dplan.num_nodes,
                                PATH_HEADMIX["mag"], gen, dev)
    kernels.update(headmix_fwd=[fwd], headmix_bwd=[bwd])

    # (d) a dropout-0 card step against the CPU step on the same batch
    hp0 = {**MAG_NET["hp"], "dropout": 0.0}
    ccfg = _sampled_config(False, "cpu", nfeat)

    def one_step(config, x_full, batch):
        model = config.model(hp0, seed=0)
        opt = config.init_state(model, hp0, None, 0)
        loss = config.sampled_step(model, opt, x_full, *batch)
        return float(loss), model

    x_cpu = torch.from_numpy(raw["x"])
    t1 = time.perf_counter()
    loss_cpu, model_cpu = one_step(ccfg, x_cpu, host_items[0])
    cpu_s = time.perf_counter() - t1
    noise = torch.randn(x_cpu.shape,
                        generator=torch.Generator().manual_seed(1))
    _, model_pert = one_step(ccfg, x_cpu * (1 + 1e-7 * noise),
                             host_items[0])
    loss_card, model_card = one_step(hcfg, hdata["x_full"], item)
    step_cmp = _step_vs_cpu("sampled_host", loss_card, model_card, loss_cpu,
                            model_cpu, [model_pert], cpu_s)
    del model_cpu, model_pert, model_card, noise, x_cpu, host_items, item

    # (a, e, f) the host branch; its build a batch on the threads
    build_s, build_batch = [], loader._build

    def timed_batch(*a):
        t = time.perf_counter()
        out = build_batch(*a)
        build_s.append(time.perf_counter() - t)
        return out

    loader._build = timed_batch
    res = {}
    res["sampled_host"], model, _ = _sampled_window("sampled_host", hcfg,
                                                    hdata)
    res["sampled_host"].update(
        build_ms_per_batch=statistics.median(build_s) * 1e3,
        host_plan_ms=[x * 1e3 for x in plan_s], card_plan_ms=plan_card_ms,
        step_vs_cpu=step_cmp, sampler_build_s=sampler_s)
    log(f"[sampled_host] a batch's host build (sample, padding, pinning; "
        f"thread wall time): median {statistics.median(build_s) * 1e3:.3f} "
        f"ms over {len(build_s)} builds on "
        f"{loader.prefetch} threads; a host plan would add "
        f"{statistics.median(plan_s) * 1e3:.3f} ms, the card's takes "
        f"{plan_card_ms:.4f}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    accs = hcfg.val(model, None, hdata)
    eval_s = time.perf_counter() - t1
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in accs.values()),
          f"[sampled_mag] eval accuracies {accs}")
    res["sampled_host"].update(eval_ms=eval_s * 1e3, eval=accs)
    log(f"[sampled_mag] (e) full-graph val on the card after the steps: "
        f"{accs} in {eval_s * 1e3:.3f} ms")
    del model, hdata

    # (a, f) the device branch; its sample and plan by CUDA events
    dcfg = _sampled_config(True, dev, nfeat)
    t0 = time.perf_counter()
    ddata = dcfg.sampling_data(raw, data)
    log(f"[sampled_device] device sampler built in "
        f"{time.perf_counter() - t0:.2f} s")
    res["sampled_device"], _, _ = _sampled_window("sampled_device", dcfg,
                                                  ddata)
    ds = ddata["dsampler"]
    seeds = torch.as_tensor(raw["train_idx"][:SAMPLED["batch_size"]],
                            device=dev)
    sgen = torch.Generator(device=dev).manual_seed(3)
    gs, _ = ds.sample_graph(seeds, generator=sgen)
    res["sampled_device"].update(
        sample_ms=time_ms(lambda: ds.sample(seeds, generator=sgen)),
        card_plan_ms=time_ms(lambda: dispatch.build_kernel_plan_device(
            gs.senders, gs.receivers, gs.num_nodes,
            edge_mask=gs.edge_mask)))
    log(f"[sampled_device] a sample {res['sampled_device']['sample_ms']:.4f} "
        f"ms, its card plan {res['sampled_device']['card_plan_ms']:.4f} ms "
        f"(CUDA events, median of 10)")
    del ddata, ds, gs

    # (g) the command line, both branches
    cli = {}
    with tempfile.TemporaryDirectory() as tmp:
        for flag in ("--sampled", "--device-sampler"):
            reset_launch_counts()
            lines, sec = _run_cli([f"{tmp}/{flag[2:]}", "egc", "mag",
                                   *SAMPLED_CLI, flag, "--check",
                                   "--check-epochs", "1"])
            counts = launch_counts()
            printed = ast.literal_eval(lines[-1])
            values = [printed["best_val"], *printed["test"].values()]
            check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in values),
                  f"[sampled_mag] cli {flag}: metrics {printed}")
            for name, c in _variant_counts(
                    counts, f"[sampled_mag] cli {flag}", False).items():
                check(c > 0 if name in EGC_KERNELS else c == 0,
                      f"[sampled_mag] cli {flag}: {name} launched {c} "
                      f"times")
            cli[flag] = {"printed": printed, "seconds": sec,
                         "launches": counts}
            log(f"[sampled_mag] (g) python -m egc_tpu_torch DIR egc mag "
                f"{' '.join(SAMPLED_CLI)} {flag} --check --check-epochs 1: "
                f"{printed} in {sec:.2f} s")
    return {"paths": res, "kernels": kernels, "cli": cli}


def phase_rmag(cfg, raw, data, secs: dict) -> dict:
    """Heterogeneous ogbn-mag through ``RMagConfig``'s hooks (``model``,
    ``init_state``, ``train``, ``val``): REGCNet h64 H4 B4, 2 layers, lr
    0.01, wd 0.001, dropout 0.7 on the ``rmag_raw`` graph (42.2 M edges in
    seven relations). One dropout-0 iteration on the card against the CPU
    iteration that replays the card's branches (every ReLU, every
    relation's max holders; the plain CPU step's gap printed beside it),
    on a graph of 1/8 the counts; then 2 warm-up and 10 timed iterations
    (host clock around each, which ends in the loss read) with the launch
    counters (each EGC kernel ``RMAG_LAUNCHES`` times a step, every other
    kernel never) and the instantiations (``RMAG_GATHER``,
    ``RMAG_HEADMIX``), edges/s, peak memory; an eval pass
    (``RMagConfig.val``); and a profiler window of two steps: the device's
    busy and idle shares and its table."""
    import torch
    from egc_tpu_torch.data.synthetic import synthetic_full_graph
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    path, hp = "rmag", RMAG_NET["hp"]
    hp0 = {**hp, "dropout": 0.0}

    c_raw = rmag_raw(synthetic_full_graph(**{
        **MAG_GRAPH, "num_nodes": MAG_GRAPH["num_nodes"] // 8}), scale=8)
    c_cfg, cpu_cfg = rmag_config(c_raw), rmag_config(c_raw, "cpu")
    c_data, d_cpu = c_cfg.data(hp0), cpu_cfg.data(hp0)
    c_edges = c_data["num_edges"]
    log(f"[rmag] step check on a graph of 1/8 the counts "
        f"({ {t: x.shape[0] for t, x in c_raw['nodes'].items()} } nodes, "
        f"{c_edges} edges); the timed steps and the kernel rows stay at "
        f"full size")

    def one_step(config, d):
        model = config.model(hp0, seed=0)
        state = config.init_state(model, hp0, d, 0)
        _, row = config.train(model, state, d, config.rng(0), 0)
        return row["train_loss"], model

    cpu_branches, branches = {}, {}
    t0 = time.perf_counter()
    with _same_branches(cpu_branches, replay=False):
        loss_cpu, model_cpu = one_step(cpu_cfg, d_cpu)
    cpu_s = time.perf_counter() - t0
    hg = d_cpu["hetero"]
    noise = torch.randn(hg.nodes["paper"].shape,
                        generator=torch.Generator().manual_seed(1))
    _, model_pert = one_step(cpu_cfg, {**d_cpu, "hetero": hg.replace(
        nodes={**hg.nodes, "paper": hg.nodes["paper"] * (1 + 1e-7 * noise)})})
    with _same_branches(branches, replay=False):
        loss_card, model_card = one_step(c_cfg, c_data)
    with _same_branches(branches, replay=True):
        loss_same, model_same = one_step(cpu_cfg, d_cpu)
    flips = [int((a != b).sum()) for a, b in zip(branches["kinks"],
                                                 cpu_branches["kinks"])]
    held = [int((a != b).sum()) for a, b in zip(branches["extrema"],
                                                cpu_branches["extrema"])]
    log(f"[{path}] ReLUs where the card step and the CPU step take other "
        f"branches (padding rows included): {flips} of "
        f"{[int(m.numel()) for m in branches['kinks']]}; max held by other "
        f"in-edges at {held} (edge, column) pairs of "
        f"{[int(m.numel()) for m in branches['extrema']]}")
    step_cmp = _step_vs_cpu(path, loss_card, model_card, loss_cpu,
                            model_cpu, [model_pert], cpu_s,
                            same=(loss_same, model_same))
    step_cmp.update(branches_apart=flips, extrema_apart=held,
                    graph_edges=c_edges)
    del c_data, d_cpu, hg, noise, model_cpu, model_pert, model_card
    del model_same, branches, cpu_branches

    steps = STEPS_WARMUP + STEPS_TIMED
    model = cfg.model(hp, seed=0)
    state = cfg.init_state(model, hp, data, 0)
    rng = cfg.rng(0)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, seconds = [], []
    with _instantiations() as seen:
        for it in range(steps):
            t0 = time.perf_counter()
            state, row = cfg.train(model, state, data, rng, it)
            seconds.append(time.perf_counter() - t0)   # the loss was read
            losses.append(row["train_loss"])
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _check_held(path, seen)
    check(seen["gather"] == {RMAG_GATHER["regc"], RMAG_GATHER["rgcn"]}
          and seen["headmix"] == set(RMAG_HEADMIX.values()),
          f"[{path}] launched gather-reduce {sorted(seen['gather'])} and "
          f"head mix {sorted(seen['headmix'])}")
    for name, c in _variant_counts(counts, f"[{path}]", False,
                                   seen=seen).items():
        want = RMAG_LAUNCHES * steps if name in PATH_KERNELS[path] else 0
        check(c == want, f"[{path}] {name} launched {c} times in {steps} "
                         f"steps, expected {want}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    t0 = time.perf_counter()
    with _instantiations() as seen_eval:
        accs = cfg.val(model, state, data)
    val_s = time.perf_counter() - t0
    _check_held(f"{path} eval", seen_eval)
    check(all(0.0 <= v <= 1.0 for v in accs.values()),
          f"[{path}] accuracies {accs}")
    timed = seconds[STEPS_WARMUP:]
    step_s = sum(timed) / len(timed)
    res = {"net": dict(RMAG_NET), **secs, "step_seconds_mean": step_s,
           "step_seconds_median": statistics.median(timed),
           "step_seconds": timed,
           "edges_per_s": data["num_edges"] / step_s,
           "num_edges": data["num_edges"],
           "num_nodes": {t: x.shape[0] for t, x in raw["nodes"].items()},
           "peak_memory_bytes": peak, "launches": counts, "losses": losses,
           "val": accs, "val_seconds": val_s, "step_vs_cpu": step_cmp}
    log(f"[{path}] {steps} steps: losses {[round(x, 4) for x in losses]}; "
        f"eval {accs} in {val_s * 1e3:.1f} ms")
    log(f"[{path}] step {step_s * 1e3:.3f} ms (mean over {len(timed)} timed "
        f"steps; median {res['step_seconds_median'] * 1e3:.3f}, min "
        f"{min(timed) * 1e3:.3f}, max {max(timed) * 1e3:.3f}), "
        f"{res['edges_per_s'] / 1e6:.3f} M edges/s, peak memory "
        f"{peak / 2**30:.3f} GiB, host plan build {secs['plan_s']:.1f} s; "
        f"launches a step "
        f"{ {k: v / steps for k, v in counts.items() if v} }")
    res["profile"], res["split"] = _profile_rmag(cfg, model, state, data)
    return res


def _profile_rmag(cfg, model, state, data):
    """A torch.profiler window of two rmag steps: its table, and the
    window beside the device's busy time (kernels and copies) and idle
    share, per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = torch.Generator(device=data["device"]).manual_seed(1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in range(2):
            cfg.train(model, state, data, rng, it)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    averages = prof.key_averages()
    busy = sum((getattr(evt, "self_device_time_total", None)
                or getattr(evt, "self_cuda_time_total", 0.0)) / 1e6
               for evt in averages if evt.device_type == DeviceType.CUDA
               and not getattr(evt, "is_user_annotation", False))
    check(busy > 0, "[rmag] the profiler saw no device time")
    split = {"window_s": window / 2, "device_busy_s": busy / 2,
             "busy_share": busy / window, "idle_share": 1 - busy / window}
    table = averages.table(sort_by="cuda_time_total", row_limit=25)
    log("[profile] rmag, two steps:\n" + table)
    log(f"[profile] rmag per step (under the profiler): window "
        f"{split['window_s'] * 1e3:.3f} ms, device busy "
        f"{split['device_busy_s'] * 1e3:.3f} ms (busy share "
        f"{split['busy_share']:.3f}, idle share {split['idle_share']:.3f})")
    return table, split


def _profile_code(run, cfg, data, path):
    """A torch.profiler table of two code2 steps in the middle of an epoch
    (the loader's prefetch running), and the window split into the host's
    batch fetch (``egc.batch``: waiting for the prefetched batch
    and enqueueing its copy), its step enqueue (``egc.step``), the rest
    (the wait for the card at the losses' read), and the card's busy time
    (kernels and copies); per step. Beside it, the build time of the
    window's two batches on the prefetch threads (``host_build_s``; the
    loader counts a batch's build when it yields it), which overlaps the
    steps before."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from egc_tpu_torch.train.loop import train_epoch
    loader = data["train"]
    batches = iter(loader)   # one step first: the prefetch threads run
    train_epoch(run.model, run.optimizer, cfg.loss_fn, batches, steps=1)
    torch.cuda.synchronize()
    built0 = loader.build_seconds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_epoch(run.model, run.optimizer, cfg.loss_fn, batches, steps=2)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    averages = prof.key_averages()
    host = {"egc.batch": 0.0, "egc.step": 0.0}
    busy = 0.0
    for evt in averages:
        if evt.device_type == DeviceType.CPU and evt.key in host:
            host[evt.key] += evt.cpu_time_total / 1e6
        elif evt.device_type == DeviceType.CUDA and evt.key not in host \
                and not getattr(evt, "is_user_annotation", False):
            busy += (getattr(evt, "self_device_time_total", None)
                     or getattr(evt, "self_cuda_time_total", 0.0)) / 1e6
    split = {"window_s": window / 2, "batch_s": host["egc.batch"] / 2,
             "step_enqueue_s": host["egc.step"] / 2,
             "wait_s": (window - sum(host.values())) / 2,
             "device_busy_s": busy / 2, "idle_share": 1 - busy / window,
             "host_build_s": (loader.build_seconds - built0) / 2}
    table = averages.table(sort_by="cuda_time_total", row_limit=25)
    log(f"[profile] {path}, two steps:\n" + table)
    log(f"[profile] {path} per step (under the profiler): window "
        f"{split['window_s'] * 1e3:.3f} ms = batch fetch "
        f"{split['batch_s'] * 1e3:.3f} + step enqueue "
        f"{split['step_enqueue_s'] * 1e3:.3f} + wait "
        f"{split['wait_s'] * 1e3:.3f}; device busy "
        f"{split['device_busy_s'] * 1e3:.3f} ms (idle share "
        f"{split['idle_share']:.3f}); batch and plan builds on the "
        f"prefetch threads {split['host_build_s'] * 1e3:.3f} ms")
    return table, split


def _zoo_check_graph(results, raw, data, d_cpu, elapsed: float):
    """The graph the conv-zoo paths' card step is held against the CPU
    step on: the path's own, unless its CPU steps (two a path, each
    estimated at the EGC-M path's, the heaviest) would take the script
    past ``ZOO_BUDGET_S``; then ``synthetic_full_graph`` of 1/8 the nodes
    at the same average degree (the timed steps and the kernel rows stay
    at full size)."""
    from egc_tpu_torch.data.synthetic import synthetic_full_graph
    from egc_tpu_torch.exp.fullgraph import full_graph_to_device_dict
    cpu_s = results["main"]["step_vs_cpu"]["cpu_step_seconds"]
    projected = elapsed + 2 * len(ZOO_NETS) * cpu_s
    if projected <= ZOO_BUDGET_S:
        log(f"[zoo] step checks on the full graph (projected "
            f"{projected:.0f} s <= {ZOO_BUDGET_S} s)")
        return raw, data, d_cpu
    small = synthetic_full_graph(num_nodes=NUM_NODES // 8, avg_degree=14,
                                 num_features=128, num_classes=40, seed=0)
    log(f"[zoo] step checks on a graph of 1/8 the nodes "
        f"({small['x'].shape[0]} nodes, {len(small['senders'])} edges, "
        f"average degree 14): two full-size CPU steps a path would take "
        f"the script to ~{projected:.0f} s, past {ZOO_BUDGET_S} s; the "
        f"timed steps and the kernel rows stay at full size")
    return (small, full_graph_to_device_dict(small),
            full_graph_to_device_dict(small, "cpu"))


def phase_trial(raw, main_step_s: float) -> dict:
    """``exp/runner.run_trial``, the loop ``python -m egc_tpu_torch`` runs,
    at arxiv size: EGC-M h128 H4 B4 at ArxivConfig's default hparams
    through an ``ArxivConfig`` whose graph is ``raw`` (169,343 nodes),
    ``TRIAL_ITERS`` iterations into a trial directory. Each iteration is
    the step, the eval-mode forward, the accuracies of every split read
    back, the plateau and, where val improved, ``checkpoint.pt`` /
    ``checkpoint.json``. The launch counters are reset just before and
    read just after (3 launches a layer: each forward kernel in the step,
    the eval forward and the final test forward, each backward kernel in
    the step). Seconds an iteration (from the history's clock, the
    warm-up iterations left out) stand beside the bare step, the eval
    forward and one ``persist_trial``, each timed alone on the trained
    model, and beside the main path's step."""
    import tempfile
    from pathlib import Path
    from egc_tpu_torch.exp.fullgraph import ArxivConfig, train_step
    from egc_tpu_torch.exp.runner import run_trial
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    class ArxivAtSize(ArxivConfig):
        def load_full_graph(self):
            return raw

    config = ArxivAtSize("egc", 128, heads=4, bases=4,
                         aggrs=("symnorm", "max", "mean"))
    hp = config.default_hparams()
    layers, its = PATH_LAYERS["main"], TRIAL_ITERS
    with tempfile.TemporaryDirectory() as tmp:
        reset_launch_counts()
        t0 = time.perf_counter()
        out = run_trial(config, hp, max_iterations=its, patience=its,
                        trial_dir=Path(tmp), verbose=False)
        trial_s = time.perf_counter() - t0
        counts = launch_counts()
        for name, c in _variant_counts(
                counts, "[trial]", _path_tiled("main")).items():
            want = {"gather_reduce_fwd": layers * (2 * its + 1),
                    "headmix_fwd": layers * (2 * its + 1),
                    "bn_apply": layers * (2 * its + 1),
                    "gather_reduce_bwd": layers * its,
                    "headmix_bwd": layers * its, "bn_stats": layers * its,
                    "bn_grad_sums": layers * its,
                    "bn_apply_bwd": layers * its}.get(name, 0)
            check(c == want, f"[trial] {name} launched {c} times in {its} "
                             f"iterations, expected {want}")
        hist = out["history"]
        check(len(hist) == its and all(
            math.isfinite(r["train_loss"]) for r in hist),
            f"[trial] history {hist}")
        clock = [0.0] + [r["time_s"] for r in hist]
        iter_s = [b - a for a, b in zip(clock, clock[1:])][STEPS_WARMUP:]
        vals = [r["val_acc"] for r in hist]
        saves = sum(v > max(vals[:i], default=-1.0)
                    for i, v in enumerate(vals))
        model, opt, data = out["model"], out["state"], out["data"]
        gen = config.rng(0)

        def alone(fn, reps=5):
            fn()
            ts = []
            for _ in range(reps):
                t = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t)
            return statistics.median(ts)

        step_s = alone(lambda: float(train_step(model, opt, data, gen)))
        val_s = alone(lambda: config.val(model, opt, data))
        persist_s = alone(lambda: config.persist_trial(
            Path(tmp), model, opt, config.plateau(hp), hp,
            extra={"iteration": its}))
        ckpt_bytes = (Path(tmp) / "checkpoint.pt").stat().st_size
    res = {"iterations": its, "trial_seconds": trial_s,
           "iteration_seconds": iter_s,
           "iteration_seconds_mean": sum(iter_s) / len(iter_s),
           "iteration_seconds_median": statistics.median(iter_s),
           "checkpoint_writes": saves, "checkpoint_bytes": ckpt_bytes,
           "step_seconds": step_s, "val_seconds": val_s,
           "persist_seconds": persist_s, "main_step_seconds": main_step_s,
           "launches": counts, "history": hist}
    log(f"[trial] run_trial EGC-M h128 at arxiv size, {its} iterations in "
        f"{trial_s:.2f} s ({saves} checkpoint writes of {ckpt_bytes} B): "
        f"{res['iteration_seconds_mean'] * 1e3:.3f} ms an iteration (mean "
        f"of the last {len(iter_s)}; median "
        f"{res['iteration_seconds_median'] * 1e3:.3f}); alone: step "
        f"{step_s * 1e3:.3f}, eval forward and accuracies "
        f"{val_s * 1e3:.3f}, persist_trial {persist_s * 1e3:.3f} ms "
        f"(medians of 5); the main path's step {main_step_s * 1e3:.3f} ms; "
        f"launches { {k: v for k, v in counts.items() if v} }")
    return res


def _run_cli(argv: list) -> tuple:
    """``python -m egc_tpu_torch``'s ``main`` on ``argv``, in process:
    ``(printed lines, seconds)``. Fails unless every kernel instantiation
    the run launched is one that phase 3 held (``_check_held``)."""
    import io
    from egc_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), _instantiations() as seen:
        cli.main(argv)
    sec = time.perf_counter() - t0
    _check_held(f"cli {' '.join(argv[1:3])}", seen)
    return buf.getvalue().strip().splitlines(), sec


def phase_cli() -> dict:
    """``python -m egc_tpu_torch``'s ``main``, in process on the card:
    ``--check --check-epochs 3`` of every kind at its reference arxiv
    width (``CLI_RUNS``) on ``ArxivConfig``'s synthetic graph, each with
    the launch counters reset just before and read just after (the kind's
    kernels launched, every other kernel not) and finite metrics in the
    dict it prints; then one EGC-M ``--use-default-hparams --final-runs
    1`` run, whose ``final/run_0`` ``restore_trial`` must give the val
    accuracy its ``result.json`` recorded. Every run launches only
    instantiations that phase 3 held (``_run_cli``)."""
    import ast
    import tempfile
    from pathlib import Path
    import torch
    from egc_tpu_torch import cli
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for model, args in CLI_RUNS.items():
            reset_launch_counts()
            lines, sec = _run_cli([f"{tmp}/{model}", model, "arxiv", *args,
                                   "--check", "--check-epochs",
                                   str(CLI_EPOCHS)])
            counts = launch_counts()
            printed = ast.literal_eval(lines[-1])
            values = [printed["best_val"], *printed["test"].values()]
            check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in values),
                  f"[cli] {model}: metrics {printed}")
            kernels = CLI_KERNELS.get(model, GATHER) + BN_KERNELS
            tiled = CLI_HEADMIX["arxiv"].get(model, (0,) * 4)[3] % 4 != 0
            for name, c in _variant_counts(counts, f"[cli] {model}",
                                          tiled).items():
                check(c > 0 if name in kernels else c == 0,
                      f"[cli] {model}: {name} launched {c} times")
            res[model] = {"printed": printed, "launches": counts,
                          "seconds": sec}
            log(f"[cli] {model} {' '.join(args)} --check --check-epochs "
                f"{CLI_EPOCHS}: {printed}; launches "
                f"{ {k: v for k, v in counts.items() if v} } ({sec:.1f} s)")
        d = Path(tmp) / "egc_final"
        lines, sec = _run_cli([str(d), "egc", "arxiv", *CLI_RUNS["egc"],
                               "--use-default-hparams", "--final-runs", "1"])
        run_dir = d / "final" / "run_0"
        result = json.loads((run_dir / "result.json").read_text())
        history = json.loads((run_dir / "history.json").read_text())
        config = cli.build_config("arxiv", "egc", hidden=136, heads=4,
                                  bases=4, aggrs="symnorm,max,mean",
                                  num_samples=50)
        model, state, _, hp, data = config.restore_trial(run_dir)
        restored = config.val(model, state, data)
        check(restored == result["test"],
              f"[cli] restored accuracies {restored} vs recorded "
              f"{result['test']}")
        # and the restored weights are the trained ones, not an init's
        fresh = config.model(hp, seed=0).eval()
        with torch.no_grad():
            check(not torch.equal(fresh(data["graph"]),
                                  model(data["graph"])),
                  "[cli] the restored net computes what a fresh one does")
        res["egc_final"] = {"result": result, "iterations": len(history),
                            "restored": restored, "hparams": hp,
                            "seconds": sec}
        log(f"[cli] egc --use-default-hparams --final-runs 1: "
            f"{len(history)} iterations in {sec:.1f} s, best val "
            f"{result['best_val']:.4f} at {result['best_iter']}, final "
            f"{result['test']}; restore_trial of final/run_0 gives "
            f"{restored}")
    return res


def phase_cli_datasets() -> dict:
    """``python -m egc_tpu_torch``'s ``main`` on the card for every other
    dataset: ``--check --check-epochs 2`` of each SUPPORTED
    (dataset, kind) at its main-table width (``CLI_DATASET_RUNS``) on the
    config's synthetic set, each with the launch counters (the kind's
    kernels launched, every other kernel not) and finite metrics (accuracy,
    ROC-AUC and F1 in [0, 1]); then one zinc EGC-M h124 ``--use-default-
    hparams --final-runs 1`` run, whose ``final/run_0`` ``restore_trial``
    must give the test metrics its ``result.json`` recorded. Every run
    launches only instantiations that phase 3 held (``_run_cli``)."""
    import ast
    import tempfile
    from pathlib import Path
    import torch
    from egc_tpu_torch import cli
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dataset, model, args in CLI_DATASET_RUNS:
            key = f"{dataset}/{model}"
            reset_launch_counts()
            lines, sec = _run_cli([f"{tmp}/{dataset}_{model}", model,
                                   dataset, *args, "--check",
                                   "--check-epochs",
                                   str(CLI_DATASET_EPOCHS)])
            counts = launch_counts()
            printed = ast.literal_eval(lines[-1])
            values = {"best_val": printed["best_val"], **printed["test"]}
            check(all(math.isfinite(v) and (
                0.0 <= v <= 1.0 or not k.endswith(("_acc", "_metric")))
                for k, v in values.items()),
                f"[cli] {key}: metrics {printed}")
            kernels = CLI_KERNELS.get(model, GATHER) + (
                () if dataset in NO_NORM else BN_KERNELS)
            for name, c in _variant_counts(counts, f"[cli] {key}").items():
                check(c > 0 if name in kernels else c == 0,
                      f"[cli] {key}: {name} launched {c} times")
            res[key] = {"printed": printed, "launches": counts,
                        "seconds": sec}
            log(f"[cli] {key} {' '.join(args)} --check --check-epochs "
                f"{CLI_DATASET_EPOCHS}: {printed}; launches "
                f"{ {k: v for k, v in counts.items() if v} } ({sec:.1f} s)")
        args = CLI_DATASET_RUNS[0][2]
        d = Path(tmp) / "zinc_final"
        lines, sec = _run_cli([str(d), "egc", "zinc", *args,
                               "--use-default-hparams", "--final-runs", "1"])
        run_dir = d / "final" / "run_0"
        result = json.loads((run_dir / "result.json").read_text())
        history = json.loads((run_dir / "history.json").read_text())
        config = cli.build_config("zinc", "egc", hidden=124, heads=4,
                                  bases=4, aggrs="add,std,max",
                                  num_samples=50)
        model, state, _, hp, data = config.restore_trial(run_dir)
        restored = config.test(model, state, data)
        # the readout's mean pool sums by index_add, whose atomics add in
        # another order each run: the eval is reproducible to rounding
        check(restored.keys() == result["test"].keys() and all(
            abs(v - result["test"][k]) <= RESTORE_RTOL * abs(
                result["test"][k]) for k, v in restored.items()),
              f"[cli] zinc: restored test metrics {restored} vs recorded "
              f"{result['test']}, beyond rtol {RESTORE_RTOL}")
        g, _ = next(iter(data["val"]))
        fresh = config.model(hp, seed=0).eval()
        with torch.no_grad():
            check(not torch.equal(fresh(g), model.eval()(g)),
                  "[cli] zinc: the restored net computes what a fresh one "
                  "does")
        res["zinc_final"] = {"result": result, "iterations": len(history),
                             "restored": restored, "hparams": hp,
                             "seconds": sec}
        log(f"[cli] zinc egc --use-default-hparams --final-runs 1: "
            f"{len(history)} iterations in {sec:.1f} s, best val "
            f"{result['best_val']:.4f} at {result['best_iter']}, final "
            f"{result['test']}; restore_trial of final/run_0 gives "
            f"{restored}")
    return res


# ---------------------------------------------------------------------------
# 6. the partitioned paths and the rest of the harness
# ---------------------------------------------------------------------------

# the partitioned main path: arxiv EGC-M h128 H4 B4 (the main net) over a
# process group of one rank, 3 checked steps (dropout 0, ArxivConfig's
# Adam) beside the unpartitioned ArxivConfig step on the card
PART_STEPS = 3
PART_TIMED = 10               # a step's time: windows of 5, in turns
PART_GRAD_REL_L2 = 2e-4       # card vs card: the partition's BFS order sums
#   every receiver's edges in another order; ROADMAP.md §C records 1.2e-4
#   as EGC's rounding spread through its max and ReLU selections
DP_REL = 1e-5                 # DP at world 1 vs one device: the same ops,
#   but the readout's mean pool adds by atomics, in another order each run
HARNESS_NET = ["--hidden", "136", "--egc-num-heads", "4", "--egc-num-bases",
               "4", "--aggrs", "symadd,max,mean"]   # the registry's egc_m
SEARCH_ITERS = 3              # epochs a search trial
SEARCH_NET = CLI_DATASET_RUNS[0][2]                 # zinc EGC-M h124
PATH_KERNELS.update({
    "partitioned": EGC_KERNELS + BN_KERNELS,
    "partitioned_gat": PATH_KERNELS["gat"],
    "dp": EGC_KERNELS + BN_KERNELS,
    "pretrained": ("gather_reduce_fwd", "headmix_fwd", "bn_apply"),
    "search_workers": EGC_KERNELS + BN_KERNELS})
PATH_GATHER["partitioned"] = PATH_GATHER["main"]
PATH_HEADMIX["partitioned"] = PATH_HEADMIX["main"]
# the partitioned rmag path: REGCNet h64 H4 B4 (RMAG_NET) over a process
# group of one rank on the rmag path's graph, 3 checked steps (dropout 0)
# beside RMagConfig's on the card, then PART_TIMED steps of each in turns
# at the default hyperparameters' dropout
PART_RMAG_DROPOUT = 0.5
PATH_KERNELS["partitioned_rmag"] = EGC_KERNELS
RMAG_CLI = CLI_DATASET_RUNS[-1][2]                  # rmag h64 H4 B4


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _grad_gap(label: str, got: dict, ref: dict, zero: str) -> tuple:
    """(relative L2 of the whole gradient, the largest of one tensor's)
    of ``got`` against ``ref``; a bias that feeds a BatchNorm (``zero``)
    is checked to be noise-sized and left out."""
    import torch
    scale = max(float(g.abs().max()) for g in ref.values())
    keep = []
    for name, g in ref.items():
        if re.fullmatch(zero, name):
            check(float(got[name].abs().max()) <= 1e-4 * scale,
                  f"[{label}] {name}: gradient is not noise-sized")
        else:
            keep.append(name)
    whole = rel_l2(torch.cat([got[n].reshape(-1) for n in keep]),
                   torch.cat([ref[n].reshape(-1) for n in keep]))
    worst = max((rel_l2(got[n], ref[n]), n) for n in keep)
    return whole, worst


def _device_idle(step, step_s: float, steps: int = 2) -> dict:
    """The profiler over ``steps`` calls of ``step``: the device's busy
    time a step, and its idle share of ``step_s``, the step's time
    measured without the profiler (whose own host work stretches the
    profiled window of a step the host nearly keeps up with; that
    window is reported beside it); the 15 largest device ops' ms a
    step."""
    import torch
    from egc_tpu_torch.utils.profiling import device_op_table, profile_trace
    with profile_trace() as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()    # the profiler's start-up left out
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    ops = device_op_table(prof)
    busy = sum(v for _, v in ops) / 1e6
    check(busy > 0, "the profiler saw no device time")
    return {"profiled_window_s": window / steps,
            "device_busy_s": busy / steps,
            "idle_share": 1 - busy / steps / step_s,
            "top_ops_ms": [(k, v / 1e3 / steps) for k, v in ops[:15]]}


def _windows(steps: dict, count: int) -> dict:
    """Each named step function timed in windows of ``count // 2`` steps,
    in turns (a, b, b, a): seconds a step over its two windows (host
    clock, one synchronise a window)."""
    import torch
    half = count // 2
    order = list(steps) + list(steps)[::-1]
    total = {name: 0.0 for name in steps}
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(half):
            steps[name]()
        torch.cuda.synchronize()
        total[name] += time.perf_counter() - t0
    return {name: s / (2 * half) for name, s in total.items()}


def phase_partitioned(raw, data) -> dict:
    """``[partitioned]``: graph-partitioned arxiv training at world size 1
    under NCCL (this process joins a one-rank group): the real process
    group, the partition plan with its halo padding (BFS order, H = 8
    padded halo rows), the kernels on the rank's extended graph, and the
    all-reduces. ``PartitionedArxivConfig``'s hooks on the 169,343-node
    graph (plan build timed), EGC-M h128 H4 B4 symnorm/max/mean from the
    seed of the unpartitioned ``ArxivConfig`` net (the state dicts
    equal); ``PART_STEPS`` steps of each at dropout 0: the loss at rtol
    ``STEP_LOSS_RTOL``, the gradients at relative L2 ``PART_GRAD_REL_L2``
    each step; the counters over the partitioned steps: rows 2-5 and the
    BatchNorm kernels three times a step, nothing else, in the main path's instantiations. Both
    steps' times (windows in turns) and the partitioned step's idle
    share; one GAT h152 H8 step each way with rows 6-7 counted; one DP
    step at world 1 on a zinc EGC-M batch against the one-device step;
    ``python -m egc_tpu_torch ... --partitions 1 --check --check-epochs
    2`` as a subprocess (its rank spawned, NCCL), and ``--partitions``
    one past the visible cards, which must exit 2 with its message
    before any rank starts."""
    import ast
    import tempfile
    import torch
    import torch.distributed as dist
    from egc_tpu_torch.exp.batched import ZincConfig
    from egc_tpu_torch.exp.fullgraph import (
        ArxivConfig, PartitionedArxivConfig, arxiv_net, train_step,
    )
    from egc_tpu_torch.models.nets import ConvSpec
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from egc_tpu_torch.parallel.dp import make_dp_train_step
    from egc_tpu_torch.parallel.halo import (
        DistributedNodeClassifier, partitioned_train_step,
    )
    from egc_tpu_torch.parallel.mesh import free_port, init_mesh

    class AtSize:
        def load_full_graph(self):
            return raw

    class Part(AtSize, PartitionedArxivConfig):
        pass

    class Whole(AtSize, ArxivConfig):
        pass

    egc = dict(heads=4, bases=4, aggrs=("symnorm", "max", "mean"))
    res = {}
    mesh = init_mesh(0, 1, device="cuda",
                     init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        check(mesh.backend == "nccl" and dist.get_world_size() == 1,
              f"[partitioned] group {mesh}")
        pcfg = Part("egc", 128, mesh=mesh, **egc)
        ucfg = Whole("egc", 128, **egc, device=mesh.device)
        hp = {**pcfg.default_hparams(), "dropout": 0.0}
        t0 = time.perf_counter()
        pdata = pcfg.data(hp)
        plan_s = time.perf_counter() - t0
        plan = pdata["plan"]
        check(plan.n_local >= NUM_NODES and pdata["graph"].kernel_plan
              .num_edges == NUM_EDGES,
              f"[partitioned] plan n_local {plan.n_local}, halo "
              f"{plan.halo}, edges {pdata['graph'].kernel_plan.num_edges}")
        pm, um = pcfg.model(hp, seed=0), ucfg.model(hp, seed=0)
        check(pm.state_dict().keys() == um.state_dict().keys() and all(
            torch.equal(v, um.state_dict()[k])
            for k, v in pm.state_dict().items()),
            "[partitioned] the seeded weights differ from ArxivNet's")
        popt = pcfg.init_state(pm, hp, pdata, 0)
        uopt = ucfg.init_state(um, hp, data, 0)
        rng = pcfg.rng(0)
        reset_launch_counts()
        ploss, pgrads = [], []
        with _instantiations() as seen:
            for it in range(PART_STEPS):
                _, m = pcfg.train(pm, popt, pdata, rng, it)
                ploss.append(m["train_loss"])
                pgrads.append(_grads(pm))
        counts = launch_counts()
        _check_path_instantiation("partitioned", seen)
        for name, c in _variant_counts(
                counts, "[partitioned]", _path_tiled("partitioned"),
                seen=seen).items():
            want = 3 * PART_STEPS if name in PATH_KERNELS["partitioned"] \
                else 0
            check(c == want, f"[partitioned] {name} launched {c} times in "
                             f"{PART_STEPS} steps, expected {want}")
        gaps = []
        for it in range(PART_STEPS):
            _, m = ucfg.train(um, uopt, data, rng, it)
            rel_loss = abs(ploss[it] - m["train_loss"]) / abs(
                m["train_loss"])
            whole, worst = _grad_gap("partitioned", pgrads[it], _grads(um),
                                     r"convs\.\d+\.bias")
            gaps.append({"loss": ploss[it], "ref_loss": m["train_loss"],
                         "loss_rel": rel_loss, "grad_rel_l2": whole,
                         "worst": worst})
            check(rel_loss <= STEP_LOSS_RTOL and whole <= PART_GRAD_REL_L2,
                  f"[partitioned] step {it}: {gaps[-1]}")
        g, sidx, y = pdata["graph"], pdata["send_idx"], pdata["y"]
        tmask = pdata["masks"]["train"]
        gen = torch.Generator(device="cuda").manual_seed(1)
        steps = {
            "unpartitioned": lambda: train_step(um, uopt, data, gen),
            "partitioned": lambda: partitioned_train_step(
                pm, popt, g, sidx, y, tmask, gen)}
        times = _windows(steps, PART_TIMED)
        torch.cuda.reset_peak_memory_stats()
        prof = _device_idle(steps["partitioned"], times["partitioned"])
        peak = torch.cuda.max_memory_allocated()
        res["partitioned"] = {
            "plan_seconds": plan_s, "n_local": plan.n_local,
            "halo": plan.halo, "n_ext": plan.n_ext,
            "e_interior": plan.e_interior, "steps": gaps,
            "launches": counts, "step_seconds": times, "profile": prof,
            "peak_memory_bytes": peak}
        log(f"[partitioned] plan (BFS, halo {plan.halo}, n_ext "
            f"{plan.n_ext}) and its kernel plan built in {plan_s:.2f} s; "
            f"{PART_STEPS} steps against ArxivConfig's: "
            + "; ".join(f"loss {s['loss']:.6f} vs {s['ref_loss']:.6f} (rel "
                        f"{s['loss_rel']:.2e}), gradients "
                        f"{s['grad_rel_l2']:.2e} (worst {s['worst'][0]:.2e} "
                        f"{s['worst'][1]})" for s in gaps))
        log(f"[partitioned] step {times['partitioned'] * 1e3:.3f} ms vs "
            f"unpartitioned {times['unpartitioned'] * 1e3:.3f} ms "
            f"({PART_TIMED} steps each, windows in turns); profiler: "
            f"device busy {prof['device_busy_s'] * 1e3:.3f} ms a step, "
            f"idle share {prof['idle_share']:.3f} of the step (the "
            f"profiled window {prof['profiled_window_s'] * 1e3:.3f} ms); "
            f"peak {peak / 2**30:.3f} GiB; "
            f"launches { {k: v for k, v in counts.items() if v} }")

        # one GAT h152 H8 step each way (rows 6-7 counted)
        gat = ConvSpec(kind="gat", heads=GAT_NET["heads"])
        gm = DistributedNodeClassifier(
            gat, GAT_NET["hidden"], dropout=0.0, group=mesh.group,
            generator=torch.Generator().manual_seed(0)).cuda()
        ugm = arxiv_net(gat, GAT_NET["hidden"], dropout=0.0, seed=0,
                        device=mesh.device)
        gopt = torch.optim.Adam(gm.parameters(), lr=0.01, weight_decay=5e-4)
        ugopt = torch.optim.Adam(ugm.parameters(), lr=0.01,
                                 weight_decay=5e-4)
        reset_launch_counts()
        with _instantiations() as seen:
            gl = float(partitioned_train_step(gm, gopt, g, sidx, y, tmask))
        gcounts = launch_counts()
        _check_held("partitioned_gat", seen)
        for name, c in _variant_counts(
                gcounts, "[partitioned_gat]", False, seen=seen).items():
            want = 3 if name in PATH_KERNELS["gat"] else 0
            check(c == want, f"[partitioned_gat] {name} launched {c} times "
                             f"in a step, expected {want}")
        ggrads = _grads(gm)
        ugl = float(train_step(ugm, ugopt, data))
        whole, worst = _grad_gap("partitioned_gat", ggrads, _grads(ugm),
                                 r"convs\.\d+\.bias")
        check(abs(gl - ugl) <= STEP_LOSS_RTOL * abs(ugl)
              and whole <= PART_GRAD_REL_L2,
              f"[partitioned_gat] loss {gl} vs {ugl}, gradients {whole}")
        res["partitioned_gat"] = {"loss": gl, "ref_loss": ugl,
                                  "grad_rel_l2": whole, "worst": worst,
                                  "launches": gcounts}
        log(f"[partitioned_gat] GAT h152 H8 step: loss {gl:.6f} vs "
            f"{ugl:.6f}, gradients {whole:.2e} (worst {worst[0]:.2e} "
            f"{worst[1]}); launches "
            f"{ {k: v for k, v in gcounts.items() if v} }")
        del gm, ugm, gopt, ugopt, pm, um, popt, uopt, pdata

        # one DP step at world 1 on a zinc EGC-M batch
        zcfg = ZincConfig("egc", 124, heads=4, bases=4,
                          aggrs=("add", "std", "max"), device=mesh.device)
        zhp = zcfg.default_hparams()
        zb, zy = next(iter(zcfg.data(zhp)["train"]))

        def zsum(out, y_, graph):
            m = graph.graph_mask.to(out.dtype)
            return ((out.reshape(-1) - y_.reshape(-1)).abs() * m).sum(), \
                m.sum()

        dm, om = zcfg.model(zhp, seed=0), zcfg.model(zhp, seed=0)
        dopt = torch.optim.Adam(dm.parameters(), lr=zhp["lr"])
        oopt = torch.optim.Adam(om.parameters(), lr=zhp["lr"])
        step = make_dp_train_step(dm, zsum, mesh.group)
        reset_launch_counts()
        with _instantiations() as seen:
            dl = float(step(dopt, zb, zy))
        dcounts = launch_counts()
        _check_held("dp", seen)
        for name, c in _variant_counts(dcounts, "[dp]", seen=seen).items():
            want = _norm_layers(dm) if name in BN_KERNELS else \
                4 if name in EGC_KERNELS else 0
            check(c == want, f"[dp] {name} launched {c} times, expected "
                             f"{want}")
        dgrads = _grads(dm)
        om.train()
        oopt.zero_grad()
        s, c = zsum(om(zb), zy, zb)
        (s / c).backward()
        whole, worst = _grad_gap("dp", dgrads, _grads(om), ZERO_GRAD[
            "zinc_egc"])
        ol = (s / c).detach().item()
        check(abs(dl - ol) <= DP_REL * abs(ol) and whole <= GRAD_REL_L2,
              f"[dp] loss {dl} vs {ol}, gradients {whole}")
        res["dp"] = {"loss": dl, "ref_loss": ol, "grad_rel_l2": whole,
                     "worst": worst, "launches": dcounts}
        log(f"[dp] zinc EGC-M h124 DP step at world 1: loss {dl:.6f} vs "
            f"one device {ol:.6f}, gradients {whole:.2e} (worst "
            f"{worst[0]:.2e} {worst[1]}); launches "
            f"{ {k: v for k, v in dcounts.items() if v} }")
    finally:
        dist.destroy_process_group()

    with tempfile.TemporaryDirectory() as tmp:
        argv = [sys.executable, "-m", "egc_tpu_torch", f"{tmp}/p", "egc",
                "arxiv", "--hidden", "128", "--egc-num-heads", "4",
                "--egc-num-bases", "4", "--aggrs", "symnorm,max,mean"]
        t0 = time.perf_counter()
        run = subprocess.run(argv + ["--partitions", "1", "--check",
                                     "--check-epochs", "2"],
                             capture_output=True, text=True, timeout=300)
        sec = time.perf_counter() - t0
        check(run.returncode == 0, f"[partitioned] --partitions 1: exit "
                                   f"{run.returncode}\n{run.stderr[-3000:]}")
        printed = ast.literal_eval(run.stdout.strip().splitlines()[-1])
        check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in
                  [printed["best_val"], *printed["test"].values()]),
              f"[partitioned] --partitions 1 printed {printed}")
        too_many = torch.cuda.device_count() + 1
        t1 = time.perf_counter()
        bad = subprocess.run(argv + ["--partitions", str(too_many),
                                     "--check"],
                             capture_output=True, text=True, timeout=120)
        bad_s = time.perf_counter() - t1
        check(bad.returncode == 2 and f"needs {too_many} CUDA cards"
              in bad.stderr and "[arxiv]" not in bad.stdout,
              f"[partitioned] --partitions {too_many}: exit "
              f"{bad.returncode}, {bad.stderr[-500:]}")
    cli_res = res["partitioned_cli"] = {
        "printed": printed, "seconds": sec,
        "refusal": bad.stderr.strip().splitlines()[-1],
        "refusal_seconds": bad_s}
    log(f"[partitioned] python -m egc_tpu_torch ... --partitions 1 --check "
        f"--check-epochs 2: {printed} ({sec:.1f} s); --partitions "
        f"{too_many}: exit 2, '{cli_res['refusal']}' ({bad_s:.1f} s)")
    return res


@contextlib.contextmanager
def _holders(gids: dict, sizes: dict, relu_types: list):
    """Records, in global ids, what a REGCNet step's branches select:
    ``log["holders"][key]``, for each relation out of a featureless type
    that REGConv maxes over, the least and the greatest global source id
    among the edges holding each (destination, column) max (two ``[N_dst,
    F]`` int32, -1 where no edge holds one: they differ where the max is
    tied), and ``log["relu"][t]``, the ReLU branch of each
    type's first-layer output (``[N_t, F]`` bool; ``relu_types``: the
    types in the order the net applies it). ``gids``: type -> a rank's
    global id of each local or extended row (-1 for a pad), or None for
    the unpartitioned graph; ``sizes``: type -> its global row count."""
    import torch
    from egc_tpu_torch.graph.hetero import split_rel_key
    from egc_tpu_torch.nn.conv import hetero
    saved = (hetero._rel_multi_aggregate, torch.relu)
    log = {"holders": {}, "relu": {}}
    relus = iter(relu_types)
    featureless = set(RMAG_TYPES) - {"paper"}

    def glob(t, idx):
        return idx if gids is None else gids[t][idx]

    def record_rel(hg, key, x_src, n_dst, aggrs):
        out = saved[0](hg, key, x_src, n_dst, aggrs)
        src, _, dst = split_rel_key(key)
        if "max" not in aggrs or src not in featureless:
            return out
        a = list(aggrs).index("max")
        f = out.shape[-1]
        big = torch.iinfo(torch.int64).max
        least = torch.full((sizes[dst], f), big, dtype=torch.int64,
                           device=out.device)
        most = torch.full_like(least, -1)
        s_all, r_all = hg.senders[key].long(), hg.receivers[key].long()
        valid_all = hg.edge_mask[key]
        for lo in range(0, s_all.shape[0], 1 << 21):
            s, r = s_all[lo:lo + (1 << 21)], r_all[lo:lo + (1 << 21)]
            valid = valid_all[lo:lo + (1 << 21)]
            held = (x_src[s] == out[r, a]) & valid[:, None]
            gs, gr = glob(src, s), glob(dst, r)
            keep = valid & (gr >= 0) & (gr < sizes[dst])
            rows = gr[keep][:, None].expand(-1, f)
            held, gs = held[keep], gs[keep][:, None]
            least.scatter_reduce_(0, rows, torch.where(held, gs, big),
                                  "amin")
            most.scatter_reduce_(0, rows, torch.where(held, gs, -1), "amax")
        log["holders"][key] = (
            torch.where(least == big, -1, least).to(torch.int32).cpu(),
            most.to(torch.int32).cpu())
        return out

    def relu(t):
        ntype = next(relus)
        branch = t > 0
        if gids is None:
            log["relu"][ntype] = branch[:sizes[ntype]].cpu()
        else:
            rows = gids[ntype][:t.shape[0]]
            full = torch.zeros(sizes[ntype], t.shape[1], dtype=torch.bool,
                               device=t.device)
            ok = rows >= 0
            full[rows[ok]] = branch[ok]
            log["relu"][ntype] = full.cpu()
        return saved[1](t)

    hetero._rel_multi_aggregate, torch.relu = record_rel, relu
    try:
        yield log
    finally:
        hetero._rel_multi_aggregate, torch.relu = saved


def _swapped_rows(plog: dict, ulog: dict, hg) -> tuple:
    """By featureless type: the global rows whose max holders differ
    between the two steps' logs (``_holders``; the old and the new least
    and greatest holder of every (destination, column) where either
    changed), the rows whose own ReLU branch differs, and the rows that
    send a relation's edge into a row whose ReLU branch differs
    (``hg``: the unpartitioned graph, global ids); and the count of
    changed maxima and of tied ones (the least holder not the
    greatest)."""
    import torch
    from egc_tpu_torch.graph.hetero import split_rel_key
    swapped, flipped, feeding, pairs, ties = {}, {}, {}, 0, 0
    for key, (p_lo, p_hi) in plog["holders"].items():
        u_lo, u_hi = ulog["holders"][key]
        diff = (p_lo != u_lo) | (p_hi != u_hi)
        pairs += int(diff.sum())
        ties += int((p_lo != p_hi).sum() + (u_lo != u_hi).sum())
        ids = torch.cat([p_lo[diff], p_hi[diff], u_lo[diff], u_hi[diff]])
        src = split_rel_key(key)[0]
        swapped[src] = swapped.get(src, set()) | set(
            ids[ids >= 0].tolist())
    for t, mp in plog["relu"].items():
        flipped[t] = set(torch.nonzero(
            (mp != ulog["relu"][t]).any(-1)).flatten().tolist())
    featureless = set(RMAG_TYPES) - {"paper"}
    for key in hg.senders:
        src, _, dst = split_rel_key(key)
        if src not in featureless or not flipped.get(dst):
            continue
        into = torch.zeros(hg.num_nodes(dst), dtype=torch.bool,
                           device=hg.senders[key].device)
        into[torch.as_tensor(sorted(flipped[dst]), device=into.device)] = \
            True
        edge = into[hg.receivers[key].long()] & hg.edge_mask[key]
        feeding[src] = feeding.get(src, set()) | set(
            hg.senders[key][edge].long().tolist())
    return swapped, flipped, feeding, pairs, ties


def phase_partitioned_rmag(ucfg, raw, udata) -> tuple:
    """``[partitioned_rmag]``: graph-partitioned heterogeneous ogbn-mag at
    world size 1 under NCCL (this process joins a one-rank group) on the
    rmag path's graph (``raw``, ogbn-mag's counts), beside the
    unpartitioned ``RMagConfig`` (``ucfg``, its card data ``udata``)
    from the same seed. ``PartitionedRMagConfig``'s hooks: the plan build
    timed in its parts (the BFS over the typed union graph, the per-type
    cuts and halos, the rank's seven bipartite plans over ``n_ext``
    source and ``n_local`` destination rows); kernels 1-4's gather pair
    held against its plain version on each rank plan in rmag's
    instantiations (``RMAG_GATHER``: the rank's row counts); the seeded
    net equal to ``REGCNet``'s (the embeddings gathered); ``PART_STEPS``
    dropout-0 steps of each against each other (loss rtol
    ``STEP_LOSS_RTOL``; gradients, the embeddings' gathered, at relative
    L2 ``PART_GRAD_REL_L2``: every tensor at the first step, from the
    same weights, the whole gradient after it, where rounding swaps the
    holders of near-tied maxima; the worst tensor printed), each EGC kernel
    ``RMAG_LAUNCHES`` times a step on both, in rmag's instantiations;
    ``PART_TIMED`` steps of each at dropout ``PART_RMAG_DROPOUT`` in
    turns, the idle share of each over its unprofiled step and the peak
    memory with both resident; ``python -m egc_tpu_torch ... rmag
    --partitions 1 --check --check-epochs 2`` on ``synthetic_rmag`` as a
    subprocess. Returns the phase's results and the kernel entries on
    the rank plans."""
    import ast
    import tempfile
    import torch
    import torch.distributed as dist
    from egc_tpu_torch.exp import fullgraph, hetero
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from egc_tpu_torch.parallel import hetero_partition
    from egc_tpu_torch.parallel.hetero_halo import (
        gathered_embedding_grads, partitioned_rmag_train_step,
    )
    from egc_tpu_torch.parallel.mesh import free_port, init_mesh
    from egc_tpu_torch.train.loop import train_step
    path = "partitioned_rmag"

    class AtSize(hetero.PartitionedRMagConfig):
        def load_hetero(self):
            return raw

    parts_s = {}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                parts_s[name] = time.perf_counter() - t
        return run

    bfs, cut = hetero_partition._bfs_order, hetero.partition_hetero
    plans = hetero_partition.HeteroPartitionPlan.build_kernel_plans
    hp0 = {**RMAG_NET["hp"], "dropout": 0.0}
    res = {}
    mesh = init_mesh(0, 1, device="cuda",
                     init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        check(mesh.backend == "nccl" and dist.get_world_size() == 1,
              f"[{path}] group {mesh}")
        pcfg = AtSize(RMAG_NET["hidden"], heads=RMAG_NET["heads"],
                      bases=RMAG_NET["bases"], mesh=mesh)
        hetero_partition._bfs_order = timed("bfs_s", bfs)
        hetero.partition_hetero = timed("partition_s", cut)
        hetero_partition.HeteroPartitionPlan.build_kernel_plans = timed(
            "rank_plans_s", plans)
        t0 = time.perf_counter()
        try:
            pdata = pcfg.data(hp0)
        finally:
            hetero_partition._bfs_order, hetero.partition_hetero = bfs, cut
            hetero_partition.HeteroPartitionPlan.build_kernel_plans = plans
        parts_s["data_s"] = time.perf_counter() - t0
        plan, hg = pdata["plan"], pdata["hetero"]
        kplans = hg.kernel_plans
        for key, (s_, _) in raw["edges"].items():
            src, _, dst = key.split("__")
            kp = kplans[key]
            check(kp.num_edges == len(s_)
                  and kp.num_nodes == plan.types[dst].n_local
                  and kp.src_rows == plan.types[src].n_ext,
                  f"[{path}] {key}: plan of {kp.num_edges} edges over "
                  f"{kp.src_rows} -> {kp.num_nodes} rows")
        sizes = {t: dict(n_local=tp.n_local, halo=tp.halo, n_ext=tp.n_ext)
                 for t, tp in plan.types.items()}
        log(f"[{path}] plan at P = 1: {sizes}; BFS over the typed union "
            f"graph {parts_s['bfs_s']:.1f} s, partition_hetero (BFS, cuts, "
            f"halos, relations) {parts_s['partition_s']:.1f} s, the rank's "
            f"seven plans {parts_s['rank_plans_s']:.1f} s; "
            f"PartitionedRMagConfig.data {parts_s['data_s']:.1f} s")

        gen = torch.Generator(device="cuda").manual_seed(16)
        entries = {"gather_reduce_fwd": [], "gather_reduce_bwd": []}
        for key in sorted(kplans):
            _gather_entries(kplans[key], {f"{key}/{conv}": inst
                                          for conv, inst in
                                          RMAG_GATHER.items()},
                            gen, out=entries, long_sums=True)
        torch.cuda.synchronize()

        pm, um = pcfg.model(hp0, seed=0), ucfg.model(hp0, seed=0)
        full, ref_sd = pm.full_state_dict(), um.state_dict()
        check(list(full) == list(ref_sd) and all(
            torch.equal(v, ref_sd[k]) for k, v in full.items()),
            f"[{path}] the seeded weights differ from REGCNet's")
        del full, ref_sd
        popt = pcfg.init_state(pm, hp0, pdata, 0)
        uopt = ucfg.init_state(um, hp0, udata, 0)
        rng = pcfg.rng(0)

        def grads(model, tables):
            out = {n: p.grad.detach().clone()
                   for n, p in model.named_parameters()
                   if not n.startswith("embs.")}
            out.update({f"embs.{t}": v.detach().clone()
                        for t, v in tables.items()})
            return out

        # each step's max holders and ReLU branches, in global ids
        gsizes = {t: len(tp.owner) for t, tp in plan.types.items()}
        pgids = {}
        for t, tp in plan.types.items():
            ext = torch.full((tp.n_ext,), -1, dtype=torch.int64)
            ext[:tp.n_local] = torch.as_tensor(tp.node_gids[0])
            pgids[t] = ext.cuda()
        relu_types = sorted(um.layer_out_types()[0])
        reset_launch_counts()
        ploss, pgrads, pstates, plogs = [], [], [], []
        with _instantiations() as seen:
            for it in range(PART_STEPS):
                with _holders(pgids, gsizes, relu_types) as hlog:
                    _, m = pcfg.train(pm, popt, pdata, rng, it)
                plogs.append(hlog)
                ploss.append(m["train_loss"])
                pgrads.append(grads(pm, gathered_embedding_grads(pm)))
                pstates.append({k: v.clone() for k, v in
                                pm.full_state_dict().items()})
        counts = launch_counts()
        _check_held(path, seen)
        check(seen["gather"] == {RMAG_GATHER["regc"], RMAG_GATHER["rgcn"]}
              and seen["headmix"] == set(RMAG_HEADMIX.values()),
              f"[{path}] launched gather-reduce {sorted(seen['gather'])} "
              f"and head mix {sorted(seen['headmix'])}")
        reset_launch_counts()
        uloss, ugrads, pparams, ulogs = [], [], [], []
        for it in range(PART_STEPS):
            with _holders(None, gsizes, relu_types) as hlog:
                _, m = ucfg.train(um, uopt, udata, rng, it)
            ulogs.append(hlog)
            uloss.append(m["train_loss"])
            ugrads.append(grads(um, {t: um.embs[t].grad
                                     for t in um.featureless_types}))
            usd = um.state_dict()
            pparams.append(max((rel_l2(v, usd[k]), k)
                               for k, v in pstates[it].items()))
        del pstates
        ucounts = launch_counts()
        for name, c in _variant_counts(counts, f"[{path}]", False,
                                       seen=seen).items():
            want = RMAG_LAUNCHES * PART_STEPS if name in EGC_KERNELS else 0
            check(c == want == ucounts[name],
                  f"[{path}] {name} launched {c} times in {PART_STEPS} "
                  f"steps (unpartitioned {ucounts[name]}), expected {want}")
        gaps = []
        for it in range(PART_STEPS):
            rel_loss = abs(ploss[it] - uloss[it]) / abs(uloss[it])
            whole, worst = _grad_gap(path, pgrads[it], ugrads[it], r"(?!)")
            d = (pgrads[it][worst[1]] - ugrads[it][worst[1]]).abs()
            off = d > 1e-3 * float(ugrads[it][worst[1]].abs().max())
            # C.2: the embedding rows off, against the rows whose max
            # holders swapped or whose own ReLU branch flipped; every tensor
            # held with those rows left out of both
            swapped, flipped, feeding, pairs, ties = _swapped_rows(
                plogs[it], ulogs[it], udata["hetero"])
            emb = {}
            for name in pgrads[it]:
                if not name.startswith("embs."):
                    continue
                t = name[len("embs."):]
                g_p, g_u = pgrads[it][name], ugrads[it][name]
                rows_off = set(torch.nonzero(
                    ((g_p - g_u).abs() > 1e-3 * float(g_u.abs().max()))
                    .any(-1)).flatten().tolist())
                tied = (swapped.get(t, set()) | flipped.get(t, set())
                        | feeding.get(t, set()))
                rest = torch.ones(g_u.shape[0], dtype=torch.bool,
                                  device=g_u.device)
                if tied:
                    rest[torch.as_tensor(sorted(tied), device=g_u.device)] \
                        = False
                untied = sorted(rows_off - tied)
                emb[name] = {
                    "rows_off": len(rows_off),
                    "holder_rows": len(swapped.get(t, set())),
                    "relu_rows": len(flipped.get(t, set())),
                    "feeding_rows": len(feeding.get(t, set())),
                    "off_untied": len(untied),
                    "rel_l2_untied": rel_l2(g_p[rest], g_u[rest]),
                    "untied_rows": untied[:8],
                    "untied_err": [float((g_p[i] - g_u[i]).abs().max()
                                         / g_u.abs().max())
                                   for i in untied[:8]]}
            others = max((rel_l2(g, ugrads[it][n]), n)
                         for n, g in pgrads[it].items()
                         if not n.startswith("embs."))
            gaps.append({"loss": ploss[it], "ref_loss": uloss[it],
                         "loss_rel": rel_loss, "grad_rel_l2": whole,
                         "worst": worst, "worst_rows_off": int(
                             off.reshape(off.shape[0], -1).any(-1).sum()),
                         "params_rel_l2": pparams[it],
                         "swapped_maxima": pairs, "tied_maxima": ties,
                         "relu_flips": {t: len(v)
                                        for t, v in flipped.items()},
                         "embeddings": emb, "others_worst": others})
            log(f"[{path}] step {it}: {pairs} (destination, column) maxima "
                f"of the featureless types' relations changed holders "
                f"({ties} tied in either step), ReLU rows flipped "
                f"{gaps[-1]['relu_flips']}; by embedding: "
                f"{emb}; other tensors worst {others[0]:.2e} ({others[1]})")
        del pgrads, ugrads, plogs, ulogs
        log(f"[{path}] {PART_STEPS} dropout-0 steps against RMagConfig's on "
            "the card: " + "; ".join(
                f"loss {g['loss']:.6f} vs {g['ref_loss']:.6f} (rel "
                f"{g['loss_rel']:.2e}), gradients {g['grad_rel_l2']:.2e} "
                f"(worst {g['worst'][0]:.2e} {g['worst'][1]}, "
                f"{g['worst_rows_off']} rows off by > 1e-3 of its largest "
                f"entry), parameters after it {g['params_rel_l2'][0]:.2e} "
                f"at worst ({g['params_rel_l2'][1]})" for g in gaps))
        for it, g in enumerate(gaps):
            # the first step starts both nets from the same weights: every
            # tensor is held. After it their weights differ by rounding: a
            # max whose holders sit within that changes holders (or an
            # exact tie forms or breaks), a ReLU input near 0 flips, and
            # each moves whole embedding rows' gradients (the holders', the
            # flipped row's and the rows feeding it). Every row off must be
            # such a row, and every tensor is held with them left out
            check(g["loss_rel"] <= STEP_LOSS_RTOL
                  and g["grad_rel_l2"] <= PART_GRAD_REL_L2
                  and (it > 0 or g["worst"][0] <= PART_GRAD_REL_L2),
                  f"[{path}] step {it}: {g}")
            check(g["others_worst"][0] <= PART_GRAD_REL_L2
                  and all(e["off_untied"] == 0
                          and e["rel_l2_untied"] <= PART_GRAD_REL_L2
                          for e in g["embeddings"].values()),
                  f"[{path}] step {it}: embedding rows off beyond the "
                  f"swapped holders and flipped ReLUs, or a tensor beyond "
                  f"{PART_GRAD_REL_L2}: {g['embeddings']}, "
                  f"{g['others_worst']}")

        pm.dropout = um.dropout = PART_RMAG_DROPOUT
        tgen = torch.Generator(device="cuda").manual_seed(1)
        steps = {
            "unpartitioned": lambda: train_step(
                um, uopt, fullgraph.masked_loss(udata["masks"]["train"]),
                udata["hetero"], udata["y"], tgen),
            "partitioned": lambda: partitioned_rmag_train_step(
                pm, popt, hg, pdata["send_idx"], pdata["y"],
                pdata["masks"]["train"], tgen)}
        torch.cuda.reset_peak_memory_stats()
        times = _windows(steps, PART_TIMED)
        prof = {name: _device_idle(fn, times[name])
                for name, fn in steps.items()}
        peak = torch.cuda.max_memory_allocated()
        res = {"plan": sizes, "plan_seconds": parts_s, "steps": gaps,
               "launches": counts, "unpartitioned_launches": ucounts,
               "step_seconds": times, "profile": prof,
               "peak_memory_bytes": peak, "dropout": PART_RMAG_DROPOUT}
        log(f"[{path}] step {times['partitioned'] * 1e3:.3f} ms vs "
            f"unpartitioned {times['unpartitioned'] * 1e3:.3f} ms "
            f"({PART_TIMED} steps each at dropout {PART_RMAG_DROPOUT}, "
            f"windows in turns); device busy "
            f"{prof['partitioned']['device_busy_s'] * 1e3:.3f} vs "
            f"{prof['unpartitioned']['device_busy_s'] * 1e3:.3f} ms a "
            f"step, idle share {prof['partitioned']['idle_share']:.3f} vs "
            f"{prof['unpartitioned']['idle_share']:.3f}; peak "
            f"{peak / 2**30:.3f} GiB with both resident; launches a step "
            f"{ {k: v / PART_STEPS for k, v in counts.items() if v} }")
        for name, p in prof.items():
            log(f"[{path}] {name} step, device ms by op: " + "; ".join(
                f"{ms:.3f} {op[:60]}" for op, ms in p["top_ops_ms"]))
        del pm, um, popt, uopt, pdata, hg, kplans, steps
    finally:
        dist.destroy_process_group()

    with tempfile.TemporaryDirectory() as tmp:
        argv = [sys.executable, "-m", "egc_tpu_torch", f"{tmp}/r", "egc",
                "rmag", *RMAG_CLI, "--partitions", "1", "--check",
                "--check-epochs", "2"]
        t0 = time.perf_counter()
        run = subprocess.run(argv, capture_output=True, text=True,
                             timeout=300)
        sec = time.perf_counter() - t0
    check(run.returncode == 0, f"[{path}] --partitions 1: exit "
                               f"{run.returncode}\n{run.stderr[-3000:]}")
    printed = ast.literal_eval(run.stdout.strip().splitlines()[-1])
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in
              [printed["best_val"], *printed["test"].values()]),
          f"[{path}] --partitions 1 printed {printed}")
    res["cli"] = {"printed": printed, "seconds": sec}
    log(f"[{path}] python -m egc_tpu_torch ... rmag --partitions 1 --check "
        f"--check-epochs 2: {printed} ({sec:.1f} s)")
    return res, entries


# ---------------------------------------------------------------------------
# [multihost] and [bf16_dense]
# ---------------------------------------------------------------------------

MULTIHOST_TOL = 1e-6          # env-joined rank vs spawn's rank, both world 1
MULTIHOST_TIMEOUT = 300
# the bf16 GEMMs of EGConv at the paths' layer shapes (rows, fan-in,
# columns): arxiv EGC-M h128 H4 B4 A3 (bases 128, comb 48, two products),
# MagNet h352 H8 B4 A1 (layer 0 from 128 features: bases 176, comb 32;
# layer 1 at fan-in 352, one product over [bases | comb], 208)
BF16_SHAPES = {"main": ((128, 128), (128, 48)),
               "mag": ((128, 176), (128, 32), (352, 208))}
BF16_VALUE_REL = 1e-5         # f32 sums of bf16 products in another order
BF16_GRAD_REL = 1e-2          # the card's backward rounds the f32
#   cotangent to bf16 (unit roundoff 2^-9) before its bf16 GEMMs
BF16_TURN = 5                 # timed steps a turn: f32, bf16, bf16, f32
MATMUL_OPS = re.compile(r"gemm|xmma|nvjet|cutlass", re.I)


@contextlib.contextmanager
def phase_multihost():
    """``[multihost]``, run beside the block it wraps (its two processes
    spend most of their ~30 s starting up; the CLI phase's seconds are
    reported, not compared): ``exp/multihost_smoke`` on the card as one
    rank that joins from ``torch.distributed.run``'s environment
    (``--standalone --nproc-per-node 1 ... --worker``: NCCL, world 1,
    ``cuda:LOCAL_RANK``) and as ``--reference --world 1`` (a ``spawn``
    rank), both started at once; their psum, DP loss and partitioned loss
    must agree within ``MULTIHOST_TOL``. Yields the dict its results land
    in after the block; both processes are stopped on the way out. The
    multi-card case needs more than one card."""
    import os
    import signal
    import tempfile
    import threading
    import torch
    mod = ["-m", "egc_tpu_torch.exp.multihost_smoke"]
    runs = {"worker": [sys.executable, "-m", "torch.distributed.run",
                       "--standalone", "--nproc-per-node", "1", *mod,
                       "--worker", "--device", "cuda"],
            "reference": [sys.executable, *mod, "--reference", "--world",
                          "1", "--device", "cuda"]}
    res = {}
    with contextlib.ExitStack() as files:
        outs = {k: [files.enter_context(tempfile.TemporaryFile("w+"))
                    for _ in range(2)] for k in runs}
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(argv, stdout=outs[k][0],
                                     stderr=outs[k][1], text=True,
                                     start_new_session=True)
                 for k, argv in runs.items()}
        secs = {}

        def clock(k):     # each run's seconds to its exit
            procs[k].wait()
            secs[k] = time.perf_counter() - t0

        clocks = [threading.Thread(target=clock, args=(k,), daemon=True)
                  for k in procs]
        for c in clocks:
            c.start()
        try:
            yield res
            out = {}
            for k, p in procs.items():
                p.wait(timeout=MULTIHOST_TIMEOUT)
                stdout, stderr = (f.seek(0) or f.read() for f in outs[k])
                check(p.returncode == 0, f"[multihost] {k}: exit "
                                         f"{p.returncode}\n{stderr[-3000:]}")
                lines = [ln for ln in stdout.splitlines()
                         if ln.startswith("{")]
                check(len(lines) == 1, f"[multihost] {k} printed {stdout!r}")
                out[k] = json.loads(lines[0])
        finally:
            # SIGTERM first: torchrun's agent then stops its rank, which
            # runs in a session of its own; then each run's process group
            for sig in (signal.SIGTERM, signal.SIGKILL):
                for p in procs.values():
                    if p.poll() is None:
                        with contextlib.suppress(ProcessLookupError):
                            os.killpg(p.pid, sig)
                with contextlib.suppress(subprocess.TimeoutExpired):
                    for p in procs.values():
                        p.wait(timeout=30)
            for c in clocks:
                c.join(timeout=1)
    w, ref = out["worker"], out["reference"]
    check(w["ok"] and ref["ok"] and w["psum"] == ref["psum"] == 1.0,
          f"[multihost] {w} vs {ref}")
    check(w["ranks"] == [{"rank": 0, "local_rank": 0, "device": "cuda:0"}]
          and torch.cuda.device_count() >= 1,
          f"[multihost] the rank is not on cuda:LOCAL_RANK: {w['ranks']}")
    gaps = {k: abs(w[k] - ref[k]) for k in ("loss", "ploss")}
    check(all(v <= MULTIHOST_TOL for v in gaps.values()),
          f"[multihost] env-joined {w} vs spawned {ref}")
    log(f"[multihost] torchrun --standalone --nproc-per-node 1 ... --worker "
        f"(NCCL, world 1, {w['ranks'][0]['device']}): loss {w['loss']!r}, "
        f"ploss {w['ploss']!r}, psum {w['psum']}; --reference --world 1: "
        f"loss {ref['loss']!r}, ploss {ref['ploss']!r}; gaps {gaps}; "
        f"seconds to each exit {({k: round(v, 1) for k, v in secs.items()})}"
        f" (both started at once, beside the CLI phase); more than one "
        f"card: not measured here")
    res.update({"worker": w, "reference": ref, "gaps": gaps,
                "seconds": secs})


@contextlib.contextmanager
def _bf16_dense(on: bool):
    """``EGC_TPU_BF16_DENSE`` set to 1 (or unset) inside the block only;
    the value it had is restored after."""
    import os
    before = os.environ.get("EGC_TPU_BF16_DENSE")
    if on:
        os.environ["EGC_TPU_BF16_DENSE"] = "1"
    else:
        os.environ.pop("EGC_TPU_BF16_DENSE", None)
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("EGC_TPU_BF16_DENSE", None)
        else:
            os.environ["EGC_TPU_BF16_DENSE"] = before


def _bf16_gemms(path: str, n: int, dev) -> list:
    """``bf16_matmuls`` on the card against its plain version on the card
    (``_BF16MatMuls``' CPU arithmetic, f32 matmuls of the bf16 values,
    TF32 off) at ``path``'s layer shapes over ``n`` rows: the value and
    both cotangents, and the forward's and the f32 matmul's ms."""
    import torch
    from egc_tpu_torch.nn.conv.egc import bf16_matmuls
    gen = torch.Generator(device=dev).manual_seed(5)
    out = []
    for k, m in BF16_SHAPES[path]:
        x = torch.randn(n, k, device=dev, generator=gen).requires_grad_()
        w = torch.randn(k, m, device=dev, generator=gen).requires_grad_()
        ct = torch.randn(n, m, device=dev, generator=gen)
        y, = bf16_matmuls(x, w)
        y.backward(ct)
        xb, wb = x.detach().bfloat16().float(), w.detach().bfloat16().float()
        ref = xb @ wb
        dx = (ct @ wb.t()).bfloat16().float()
        dw = (xb.t() @ ct).bfloat16().float()
        e = {"path": path, "n": n, "k": k, "m": m,
             "value_rel_l2": rel_l2(y.detach(), ref),
             "dx_rel_l2": rel_l2(x.grad, dx), "dw_rel_l2": rel_l2(w.grad, dw),
             "max_abs_err": float((y.detach() - ref).abs().max())}
        check(e["value_rel_l2"] <= BF16_VALUE_REL
              and max(e["dx_rel_l2"], e["dw_rel_l2"]) <= BF16_GRAD_REL,
              f"[bf16_dense] GEMM {e}")
        with torch.no_grad():
            e["ms"] = time_ms(lambda: bf16_matmuls(x, w))
            e["f32_ms"] = time_ms(lambda: x @ w)
        out.append(e)
        log(f"[bf16_dense] {path} [{n}, {k}] x [{k}, {m}]: value rel L2 "
            f"{e['value_rel_l2']:.2e} (max abs {e['max_abs_err']:.2e}), dx "
            f"{e['dx_rel_l2']:.2e}, dw {e['dw_rel_l2']:.2e} against the "
            f"plain version; forward {e['ms']:.3f} ms (casts included) vs "
            f"f32 {e['f32_ms']:.3f} ms")
        del x, w, ct, y, xb, wb, ref, dx, dw
    return out


def _bf16_path(path: str, build, step, data) -> dict:
    """One EGC path with the opt-in beside f32: ``build(dropout0)`` a
    model and its optimizer from the path's seed, ``step(model, opt,
    it)`` one training step returning the loss. A dropout-0 step of each
    from the same weights (the loss's and gradients' relative L2 of bf16
    against f32); then 2 warm-up steps of each and ``2 * BF16_TURN``
    timed steps of each in turns (f32, bf16, bf16, f32; host clock around
    each step, which ends in its loss read), the launch counters over
    them; the peak memory of each mode's warm-up; a profiler window of two
    steps each: device busy and the matmul kernels' ms a step."""
    import torch
    from egc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from egc_tpu_torch.utils.profiling import device_op_table, profile_trace
    res = {}
    loss, grads = {}, {}
    for mode in ("f32", "bf16"):
        model, opt = build(True)
        with _bf16_dense(mode == "bf16"):
            loss[mode] = step(model, opt, 0)
        grads[mode] = _grads(model)
        del model, opt
    whole, worst = _grad_gap(f"bf16_{path}", grads["bf16"], grads["f32"],
                             _zero_names(path))
    res["vs_f32"] = {"loss": loss, "loss_rel": abs(loss["bf16"] - loss["f32"])
                     / abs(loss["f32"]), "grad_rel_l2": whole,
                     "worst": worst}
    check(math.isfinite(loss["bf16"]) and res["vs_f32"]["loss_rel"] <= 1e-2,
          f"[bf16_dense] {path}: {res['vs_f32']}")
    del grads
    models, peaks = {}, {}
    for mode in ("f32", "bf16"):
        torch.cuda.reset_peak_memory_stats()
        models[mode] = build(False)
        with _bf16_dense(mode == "bf16"):
            for it in range(STEPS_WARMUP):
                step(*models[mode], it)
        peaks[mode] = torch.cuda.max_memory_allocated()
    seconds = {"f32": [], "bf16": []}
    reset_launch_counts()
    with _instantiations() as seen:
        for mode in ("f32", "bf16", "bf16", "f32"):
            with _bf16_dense(mode == "bf16"):
                for _ in range(BF16_TURN):
                    it = STEPS_WARMUP + len(seconds[mode])
                    t0 = time.perf_counter()
                    step(*models[mode], it)
                    seconds[mode].append(time.perf_counter() - t0)
    counts = launch_counts()
    _check_held(f"bf16_{path}", seen)
    _check_path_instantiation(path, seen)
    steps = 4 * BF16_TURN
    for name, c in _variant_counts(
            counts, f"[bf16_dense] {path}", _path_tiled(path),
            seen=seen).items():
        want = PATH_LAYERS[path] * steps if name in PATH_KERNELS[path] else 0
        check(c == want, f"[bf16_dense] {path}: {name} launched {c} times in "
                         f"{steps} steps, expected {want}")
    for mode in ("f32", "bf16"):
        with _bf16_dense(mode == "bf16"), profile_trace() as prof:
            for it in range(2):
                step(*models[mode], 100 + it)
        ops = device_op_table(prof)
        mm = [(k, v / 2e3) for k, v in ops if MATMUL_OPS.search(k)]
        timed = seconds[mode]
        res[mode] = {
            "step_seconds_mean": sum(timed) / len(timed),
            "step_seconds_median": statistics.median(timed),
            "step_seconds": timed, "peak_memory_bytes": peaks[mode],
            "device_busy_ms": sum(v for _, v in ops) / 2e3,
            "matmul_ms": sum(v for _, v in mm),
            "matmul_ops_ms": mm[:8]}
    res["launches"] = counts
    f, b = res["f32"], res["bf16"]
    log(f"[bf16_dense] {path}: dropout-0 step, bf16 vs f32: loss "
        f"{loss['bf16']:.6f} vs {loss['f32']:.6f} (rel "
        f"{res['vs_f32']['loss_rel']:.2e}), gradients rel L2 {whole:.2e} "
        f"(worst {worst[0]:.2e} {worst[1]})")
    log(f"[bf16_dense] {path}: step f32 {f['step_seconds_mean'] * 1e3:.3f} ms "
        f"(median {f['step_seconds_median'] * 1e3:.3f}), bf16 "
        f"{b['step_seconds_mean'] * 1e3:.3f} ms (median "
        f"{b['step_seconds_median'] * 1e3:.3f}); {2 * BF16_TURN} timed steps "
        f"each in turns; matmul kernels {f['matmul_ms']:.3f} vs "
        f"{b['matmul_ms']:.3f} ms a step, device busy "
        f"{f['device_busy_ms']:.3f} vs {b['device_busy_ms']:.3f}; peak "
        f"{f['peak_memory_bytes'] / 2**30:.3f} vs "
        f"{b['peak_memory_bytes'] / 2**30:.3f} GiB")
    log(f"[bf16_dense] {path}: matmul kernels (ms a step), f32: "
        + "; ".join(f"{v:.3f} {k[:60]}" for k, v in f["matmul_ops_ms"])
        + " | bf16: "
        + "; ".join(f"{v:.3f} {k[:60]}" for k, v in b["matmul_ops_ms"]))
    return res


def phase_bf16_dense(data, mag_cfg, mag_data) -> dict:
    """``[bf16_dense]``: ``EGC_TPU_BF16_DENSE=1`` on the card, set inside
    this phase only. The bf16 GEMMs (``nn/conv/egc.bf16_matmuls``) against
    their plain version at the arxiv and mag layer shapes, then arxiv
    EGC-M h128 H4 B4 symnorm/max/mean ("main", ArxivConfig's Adam, dropout
    0.2) and MagNet h352 H8 B4 ("mag", ``MagConfig``'s hooks) with the
    opt-in beside f32 (``_bf16_path``)."""
    import os
    import torch
    from egc_tpu_torch.exp.fullgraph import arxiv_net, train_step
    from egc_tpu_torch.models.nets import ConvSpec
    check(os.environ.get("EGC_TPU_BF16_DENSE") is None,
          "[bf16_dense] EGC_TPU_BF16_DENSE is set outside the phase")
    dev = data["device"]
    res = {"gemms": _bf16_gemms("main", data["graph"].num_nodes, dev)
           + _bf16_gemms("mag", mag_data["graph"].num_nodes, dev)}
    spec = ConvSpec(kind="egc", heads=4, bases=4,
                    aggrs=("symnorm", "max", "mean"))
    gen = torch.Generator(device=dev).manual_seed(3)

    def arxiv_build(check_step):
        model = arxiv_net(spec, 128, dropout=0.0 if check_step else 0.2,
                          seed=0, device=dev)
        return model, torch.optim.Adam(model.parameters(), lr=0.01,
                                       weight_decay=5e-4)

    def arxiv_step(model, opt, it):
        return float(train_step(model, opt, data, gen))

    res["main"] = _bf16_path("main", arxiv_build, arxiv_step, data)
    hp = MAG_NET["hp"]
    rng = mag_cfg.rng(0)

    def mag_build(check_step):
        h = {**hp, "dropout": 0.0} if check_step else hp
        model = mag_cfg.model(h, seed=0)
        return model, mag_cfg.init_state(model, h, mag_data, 0)

    def mag_step(model, state, it):
        return mag_cfg.train(model, state, mag_data, rng, it)[1][
            "train_loss"]

    res["mag"] = _bf16_path("mag", mag_build, mag_step, mag_data)
    check(os.environ.get("EGC_TPU_BF16_DENSE") is None,
          "[bf16_dense] EGC_TPU_BF16_DENSE was left set")
    return res


def search_config(dataset: str, model: str, *, record_dir: str,
                  workers: int, device=None, **kw):
    """The search workers' config factory: ``cli.build_config`` whose
    ``test`` records the worker's launch counters, its kernel build's
    seconds and its device to ``record_dir`` (one file a trial, by pid).
    Each worker first waits, up to 300 s, until ``workers`` workers have
    started a trial, so every worker runs one."""
    import os
    from pathlib import Path
    import torch
    from egc_tpu_torch import cli
    from egc_tpu_torch.ops.cuda import _build, launch_counts

    rec = Path(record_dir)
    (rec / f"started_{os.getpid()}").touch()
    t0 = time.monotonic()
    while len(list(rec.glob("started_*"))) < workers:
        if time.monotonic() - t0 > 300:
            raise RuntimeError("the other search workers never started")
        time.sleep(0.2)
    cfg = cli.build_config(dataset, model, device=device, **kw)
    test = cfg.test

    def recorded_test(net, state, data):
        out = test(net, state, data)
        torch.cuda.synchronize()
        (rec / f"trial_{os.getpid()}_{time.time_ns()}.json").write_text(
            json.dumps({"pid": os.getpid(), "device": str(cfg.device),
                        "launches": launch_counts(),
                        "build_seconds": _build.build_seconds}))
        return out

    cfg.test = recorded_test
    return cfg


def phase_harness() -> dict:
    """``[harness]``: the rest of the command line on the card.

    ``--pretrained`` for arxiv EGC-M h136 H4 B4 symadd/max/mean (the
    registry's egc_m row) from a ``checkpoint.pt`` this phase writes (the
    config's net after 3 iterations, so BatchNorm holds real statistics):
    ``cli.main`` in process, the counters reset just before; the printed
    accuracies must equal an in-process eval of the same weights, and
    the launches be rows 2 and 4 only, 3 each (one eval forward, the head
    mix at L 34: its tile variant). Then ``run_search_parallel`` on
    zinc EGC-M h124 (``--num-samples 2``: 2 candidates, ``SEARCH_ITERS``
    epochs each) on 2 spawned workers, both on the card, each started
    against a cold kernel cache (the libraries deleted first: the build
    lock makes one worker compile and the other wait); each worker's
    launches (non-zero), kernel build seconds and device come back
    through the spec's factory (``search_config``). Its wall time stands
    beside the same 2 trials run one after the other in this process."""
    import ast
    import glob
    import os
    import tempfile
    from pathlib import Path
    import numpy as np
    import torch
    from egc_tpu_torch import cli
    from egc_tpu_torch.exp.parallel_search import run_search_parallel
    from egc_tpu_torch.exp.runner import run_trial
    from egc_tpu_torch.ops.cuda import (
        _build, headmix, launch_counts, reset_launch_counts,
    )

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp) / "pretrained"
        d.mkdir()
        cfg = cli.build_config("arxiv", "egc", hidden=136, heads=4, bases=4,
                               aggrs="symadd,max,mean", num_samples=1)
        hp = cfg.default_hparams()
        data = cfg.data(hp)
        model = cfg.model(hp, seed=0)
        opt = cfg.init_state(model, hp, data, 0)
        for it in range(3):
            cfg.train(model, opt, data, cfg.rng(0), it)
        torch.save(model.state_dict(), d / "checkpoint.pt")
        ref = cfg.test(model, opt, data)
        reset_launch_counts()
        lines, sec = _run_cli([str(d), "egc", "arxiv", *HARNESS_NET,
                               "--pretrained"])
        counts = launch_counts()
        printed = ast.literal_eval(lines[-1])
        check(any(line.startswith("ArxivNet(") for line in lines),
              f"[pretrained] no model printed: {lines[:3]}")
        # two argmax ties of another rounding at most: 2 / 800 rows
        check(printed.keys() == ref.keys() and all(
            abs(printed[k] - v) <= 2 / 800 + 1e-7 for k, v in ref.items()),
            f"[pretrained] printed {printed}, the in-process eval {ref}")
        for name, c in _variant_counts(counts, "[pretrained]", True).items():
            want = 3 if name in PATH_KERNELS["pretrained"] else 0
            check(c == want, f"[pretrained] {name} launched {c} times, "
                             f"expected {want}")
        variant = headmix.fwd_variant(34, 4 * 34, [0])
        check(variant == "tile", f"[pretrained] head mix L 34: {variant}")
        res["pretrained"] = {"printed": printed, "in_process": ref,
                             "equal": printed == ref, "launches": counts,
                             "seconds": sec, "headmix_variant": variant}
        log(f"[pretrained] --pretrained arxiv EGC-M h136 H4 B4 "
            f"symadd/max/mean: {printed} (in process: {ref}); launches "
            f"{ {k: v for k, v in counts.items() if v} }, head mix "
            f"(4, 4, 3, 34) {variant} ({sec:.1f} s)")

        dataset, model_kind = "zinc", "egc"
        kw = dict(hidden=124, heads=4, bases=4, aggrs="add,std,max",
                  num_samples=2)
        scfg = cli.build_config(dataset, model_kind, **kw)
        metric = scfg.trial_metric()
        cands = scfg.search_strategy().generate(
            scfg.hyperparams(), np.random.default_rng(0))
        check(len(cands) == 2, f"[search] {len(cands)} candidates")
        rec = Path(tmp) / "workers"
        rec.mkdir()
        stale = glob.glob(str(_build.BUILD_DIR / "*.so"))
        for f in stale:
            os.remove(f)
        spec = ("chip_smoke", "search_config", (dataset, model_kind),
                dict(kw, record_dir=str(rec), workers=2))
        t0 = time.perf_counter()
        best = run_search_parallel(
            spec, cands, metric_mode=metric.mode, metric_name=metric.name,
            num_workers=2, exp_dir=Path(tmp) / "search",
            max_iterations=SEARCH_ITERS,
            resources=scfg.resource_requirements(),
            scheduler=scfg.trial_scheduler())
        par_s = time.perf_counter() - t0
        trials = [json.loads(p.read_text()) for p in rec.glob("trial_*")]
        by_pid = {}
        for t in trials:
            by_pid.setdefault(t["pid"], []).append(t)
        check(len(trials) == 2 and len(by_pid) == 2,
              f"[search] trials by worker {by_pid}")
        for pid, ts in by_pid.items():
            last = ts[-1]
            check(last["device"].startswith("cuda") and all(
                last["launches"][k] > 0 for k in EGC_KERNELS),
                f"[search] worker {pid}: {last}")
        check(len(glob.glob(str(_build.BUILD_DIR / "*.so"))) == len(stale)
              and not glob.glob(str(_build.BUILD_DIR / "*.tmp*")),
              "[search] the workers' cold build left another library set")
        results = json.loads((Path(tmp) / "search" / "search_results.json")
                             .read_text())
        check(len(results["results"]) == 2 and best == results["best"],
              f"[search] results {results}")
        t0 = time.perf_counter()
        seq = [run_trial(scfg, hp_, seed=i, max_iterations=SEARCH_ITERS,
                         verbose=False) for i, hp_ in enumerate(cands)]
        seq_s = time.perf_counter() - t0
        workers = {str(pid): {"launches": ts[-1]["launches"],
                              "build_seconds": ts[-1]["build_seconds"],
                              "device": ts[-1]["device"]}
                   for pid, ts in by_pid.items()}
        launches = {k: sum(w["launches"][k] for w in workers.values())
                    for k in launch_counts()}
        res["search_workers"] = {
            "workers": workers, "launches": launches,
            "parallel_seconds": par_s, "sequential_seconds": seq_s,
            "best": best, "results": results["results"],
            "sequential_best_val": [r["best_val"] for r in seq]}
        log(f"[search] --search-workers 2 on zinc EGC-M h124, 2 candidates "
            f"x {SEARCH_ITERS} epochs, both workers on the card, from a "
            f"cold kernel cache: {par_s:.1f} s (2 trials one after the "
            f"other in this process, warm: {seq_s:.1f} s); worker builds "
            + ", ".join(f"{w['build_seconds']:.2f} s"
                        for w in workers.values())
            + f"; launches by worker "
            + "; ".join(f"{ {k: v for k, v in w['launches'].items() if v} }"
                        for w in workers.values()))
    return res


def _attach(rows: list, per_key: dict) -> None:
    """Each kernel row takes its entries of ``per_key`` (key -> entries by
    kernel name) under the key, after any it holds there, and their
    largest error."""
    for row in rows:
        for key, per_shape in per_key.items():
            if row["name"] in per_shape:
                row.setdefault(key, []).extend(per_shape[row["name"]])
                row["max_abs_err"] = max([row["max_abs_err"]] + [
                    sh["max_abs_err"] for sh in row[key]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        import egc_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the egc_tpu_torch package is missing ({exc}); "
              "run from the repository root", file=sys.stderr)
        return 1
    from egc_tpu_torch.data.synthetic import synthetic_full_graph
    from egc_tpu_torch.exp.fullgraph import full_graph_to_device_dict
    from egc_tpu_torch.ops.cuda import launch_counts

    t_start = time.perf_counter()
    phases = {}
    t0 = time.perf_counter()
    info = phase_device()
    results = {"device": info, **phase_build(), "phase_seconds": phases}
    phases["device and build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = synthetic_full_graph(num_nodes=NUM_NODES, avg_degree=14,
                               num_features=128, num_classes=40, seed=0)
    data = full_graph_to_device_dict(raw)
    check(data["num_edges"] == NUM_EDGES,
          f"synthetic graph has {data['num_edges']} edges")
    log(f"[data] {raw['x'].shape[0]} nodes, {data['num_edges']} edges, "
        f"set-up {time.perf_counter() - t0:.1f} s")
    rows = kernels_main_shapes(data)
    results["segment_gather_reduce"] = check_segment_gather_reduce(data)
    rows += kernels_gat_main_shapes(data)
    rows += kernels_gatv2_main_shapes(data)
    code_g = code_batch(data["device"])
    wide = kernels_code_shapes(code_g)
    _attach(rows, {"wide": wide, "zoo": kernels_zoo_shapes(data)})
    wide_narrow, wide_kernels = kernels_wide_shapes(data)
    _attach(rows, {"wide": wide_narrow})
    rows += _wide_kernel_rows(wide_kernels)
    kernels_small(data["device"])
    bn_rows, results["batch_norm"] = kernels_batch_norm(data)
    rows += bn_rows
    kernels_gat_small(data["device"])
    kernels_gatv2_small(data["device"])
    kernels_wide_small(data["device"])
    phases["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mag = mag_data(data["device"])
    plans = batch_plans()
    per_key = {"paths": kernels_path_shapes(plans,
                                            mag[2]["graph"].kernel_plan),
               "cli": kernels_cli_shapes({
                   "arxiv": data["graph"].kernel_plan,
                   "hiv": plans["hiv_egc"], "code": code_g.kernel_plan})}
    del plans, code_g
    _attach(rows, per_key)
    phases["path kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d_cpu = full_graph_to_device_dict(raw, "cpu")
    for path, net in (("main", {}), ("gat", GAT_NET), ("gatv2", GATV2_NET)):
        results[path] = phase_path(path, raw, data, d_cpu, net)
    phases["arxiv paths"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wide = phase_gat_wide(raw, data)
    results.update({path: wide[path] for path in WIDE_NETS})
    results["gat_wide_cli"], results["routes"] = wide["cli"], wide["routes"]
    del wide
    phases["gat wide"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checked = _zoo_check_graph(results, raw, data, d_cpu,
                               time.perf_counter() - t_start)
    results["zoo_check_nodes"] = checked[0]["x"].shape[0]
    for path, net in ZOO_NETS.items():
        results[path] = phase_path(path, raw, data, d_cpu, net,
                                   checked=checked)
    phases["zoo paths"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results["trial"] = phase_trial(
        raw, results["main"]["step_seconds_mean"])
    phases["trial"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results.update(phase_partitioned(raw, data))
    phases["partitioned"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results["bf16_dense"] = phase_bf16_dense(data, mag[0], mag[2])
    phases["bf16 dense"] = time.perf_counter() - t0
    del data, d_cpu, checked
    t0 = time.perf_counter()
    for path, net in (("code_gat", CODE_GAT_NET),
                      ("code_gatv2", CODE_GATV2_NET)):
        results[path] = phase_code_path(path, net)
    phases["code2 paths"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results["mag"] = phase_mag(
        *mag, main_cpu_s=results["main"]["step_vs_cpu"]["cpu_step_seconds"],
        elapsed=time.perf_counter() - t_start)
    phases["mag path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampled = phase_sampled_mag(*mag[:3])
    results.update(sampled["paths"])
    results["sampled_cli"] = sampled["cli"]
    _attach(rows, {"paths": sampled["kernels"]})
    paper = mag[1]
    del mag, sampled
    phases["sampled mag"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rmag = rmag_data(torch.device("cuda"), paper)
    _attach(rows, {"rmag": kernels_rmag_shapes(rmag[2])})
    results["rmag"] = phase_rmag(*rmag)
    phases["rmag path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results["partitioned_rmag"], entries = phase_partitioned_rmag(*rmag[:3])
    _attach(rows, {"partitioned_rmag": entries})
    del rmag, paper, entries
    phases["partitioned rmag"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for path, net in BATCHED_NETS.items():
        results[path] = phase_batched_path(path, net)
    phases["batched paths"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with phase_multihost() as multihost:
        results["cli"] = phase_cli()
        results["cli_datasets"] = phase_cli_datasets()
    results["multihost"] = multihost
    phases["cli and multihost"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results.update(phase_harness())
    phases["harness"] = time.perf_counter() - t0
    for row in rows:   # each path's timed steps, counted on their own
        row["launches_by_path"] = {
            path: results[path]["launches"][row["name"]]
            for path in PATH_KERNELS if row["name"] in PATH_KERNELS[path]}
        row["launches"] = sum(row["launches_by_path"].values())
    # every kernel has its row; the tile-variant and geometry counters
    # count launches of the head-mix and gather-reduce rows' kernels
    kernels = set(launch_counts()) - set(HEADMIX_TILE) - set(GATHER_GEOMETRY)
    check({r["name"] for r in rows} == kernels,
          f"kernel rows {[r['name'] for r in rows]} vs counters "
          f"{sorted(launch_counts())}")
    results["kernels"] = rows
    results["seconds"] = time.perf_counter() - t_start
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1, default=str)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "floor_ms",
            "library_ms", "launches_by_path")
    wide_keys = ("path", "heads", "channels", "ms", "bound_ms", "floor_ms")
    log(f"[done] {results['seconds']:.1f} s; by phase "
        f"{ {k: round(v, 1) for k, v in phases.items()} }")
    extra = ("gathered_bytes_per_edge", "ms_no_mask", "ms_ties",
             "tied_rows")   # the gather-reduce rows
    zoo_keys = ("path", "f", "prims", "masks", "ms", "plain_ms",
                "bound_ms", "floor_ms", "max_abs_err")
    mix_keys = ("path", "H", "B", "A", "L", "variant", "ms", "plain_ms",
                "bound_ms", "library_ms", "max_abs_err")
    # rmag's bipartite entries: the rows of each side, the edges, and the
    # torch.sparse.mm time of the sum alone
    bip_keys = zoo_keys + ("n_src", "n_dst", "edges", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, **{k: r[k] for k in extra if k in r},
         **({"wide": [{k: sh.get(k) for k in wide_keys}   # floor: null
                      for sh in r["wide"]]}
            if "wide" in r else {}),
         **({"zoo": [{k: sh[k] for k in zoo_keys} for sh in r["zoo"]]}
            if "zoo" in r else {}),
         **{key: [{k: sh[k] for k in (
             mix_keys if r["name"].startswith("headmix")
             else bip_keys if key.endswith("rmag") else zoo_keys)}
             for sh in r[key]] for key in ("paths", "cli", "rmag",
                                           "partitioned_rmag")
            if key in r}}
        for r in rows]}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

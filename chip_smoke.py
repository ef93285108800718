#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It needs a
CUDA device and ``nvcc`` (the kernels are built from
``lightgbm_tpu_torch/csrc`` at first use) and imports nothing of JAX or
of the JAX package. Phases, each fatal on failure:

1. build the kernel library and report the build time;
2. hold every kernel against its plain PyTorch version on the card at
   the main paths' shapes and time both, beside the least time the card
   could take and one PyTorch library call computing the same function
   where there is one: the histogram, partition, scan and segment fused
   step on the 2M x 28 u8 training matrix (256 bins; the fused step at
   the root, at a mid-tree split whose smaller child has several
   histogram chunks and at a late one whose smaller child has one, and
   a whole tree's average launch), then the scan at 1023 bins, the leaf
   fused step's root split of the 2M x 28 bin matrix at 1023 bins (u16)
   and at 255 (u8), and the full-range histogram (``hist_rows``) of both
   bin matrices over all rows and over a third of them. The scan is held
   bitwise, every column, there and at B in {1, 31, 32, 33, 255, 256,
   1023, 1024}; the partition also at its tiles' and look-back's edges,
   on a reused scratch, and as two launches a call. Each kernel's time
   (``ms``: the median of CUDA events around a call; ``device_ms``: its
   kernels' time on the card's timeline, torch.profiler) is printed
   beside its bound and its launch floor;
3. train the Higgs-shaped binary model at full width (2M x 28,
   max_bin=255, num_leaves=255, lr=0.1, 8 iterations) through
   ``lightgbm_tpu_torch.train`` twice: the fused path (the default,
   the partitioned learner) and the per-phase path
   (``fused_split_kernel="off"``). Both must grow trees of the same
   structure; one more fused tree runs its L - 1 launches under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync in the
   split loop); the launch counters show that every kernel of each
   path ran;
4. the same at ``max_bin=1023``, which ``create_tree_learner`` gives to
   the serial (leaf_id) learner: fused (one leaf-kernel launch per
   split) and per-phase, the same trees, one more fused tree under the
   sync checker, and the launch counters (``hist_rows`` once a tree on
   the fused path, once a tree and once a split per-phase);
5. leaf against segment: at max_bin=255, 3 trees through a
   ``SerialTreeLearner`` constructed directly (the leaf kernel) and
   through the default ``PartitionedTreeLearner`` (the segment kernel):
   bitwise the same trees on gradients whose sums are exact, and on
   binary gradients, tree by tree from one score, the same structure up
   to the first tie within float rounding of a tree;
6. the fixed quality config (50k x 28, 63 leaves, 100 iterations)
   must reach in-sample AUC >= 0.97906 - 0.002
   (BENCH_QUALITY_BASELINE.json) on the partitioned fused path at
   max_bin=255 and on the serial fused path at max_bin=1023;
7. a 100k-row, 3-tree run through the kernels (fused path) must grow the
   same trees as the same run through the plain versions on the card,
   at max_bin=255 and at max_bin=1023;
8. the model file on the card: phase 3's full-width fused model (2M x
   28, 255 leaves, its 8 trees and the one grown under the sync checker)
   is written with ``model_to_string``, parsed with
   ``Booster(model_str=)`` on the card (no ``device``) and predicts all
   2M rows, raw scores and leaf indices bitwise equal to the trained
   booster's, and writes the same text again; ``train(init_model=)`` its
   file grows 2 more trees, keeping the file's trees to the bit, with
   finite predictions; every golden model the reference wrote
   (``tests/fixtures/golden``, data from ``tests/golden_common.py``)
   predicts within 1e-6 of the reference's output; a ``TEXT_ROWS`` x 28
   (50k, cut from 100k for phase 19)
   Higgs-like matrix written as CSV with a header and as LibSVM reads
   back as its arrays and ``Dataset(path)`` grows the 3 fused trees the
   arrays grow, to the bit. Each training run is driven with the launch
   counts set to 0 just before it and read just after, and must launch
   every kernel of the partitioned fused path. Printed: the write,
   parse and 2M-row predict times and the files' parse rates (rows/s);
9. every objective, valid sets and early stopping: on phase 3's 2M x 28
   matrix and bins, labels from the generator's latent score plus
   noise, 255 leaves, lr 0.1, the fused path, with a 500k-row valid set
   (seed 43) binned with the train set's mappers and evaluated every
   iteration, runs (a) regression (l2, rmse; ``early_stopping(3)`` and
   ``record_evaluation``), (b) regression_l1 (l1; the leaf refit on the
   card), (c) 5-class multiclass on the score's quintiles
   (multi_logloss, multi_error; 8 iterations = 40 trees), (d) the same
   at max_bin 1023 (4 iterations, the serial learner) and (e)
   lambdarank, relevance 0-4 by in-query rank over queries of 10-29
   documents (ndcg@1,3,5), each driven with the launch counts set to 0
   just before it and read just after and required to launch every
   kernel of its fused path. Printed per run: ms/split, gradient ms an
   iteration, the refit ms a tree (b), the valid walk ms a tree, eval
   ms an iteration, the launch counts and the valid history. Then run
   a's best_iteration through its model text on the card (``predict``
   with no ``num_iteration`` equal to ``predict(num_iteration=
   best_iteration)`` and to the loaded text's, to the bit); kernels
   against plain versions at 100k x 28, 63 leaves, 2 iterations
   (``PARITY_ITERS``: this and every later phase's, cut from 3 for
   time) of a, b, c, e at max_bin 255 and c at 1023 (the same trees,
   leaf values and valid histories to the bit); and the golden datasets multiclass, rank,
   regression_l1, monotone and tweedie trained with the reference
   CLI's ``train_params``, their held-out loss within
   ``tests/test_golden_parity.py``'s margins of the reference's
   recorded predictions (NDCG@5 at least the reference's minus 0.02).
   Run e carries the lambdarank example's ``bagging_fraction=0.9,
   bagging_freq=1``;
10. SHAP, early-stopped prediction and row sampling: SHAP
   contributions (``predict(pred_contrib=True)``, the ``tree_shap``
   kernel) of phase 3's binary model (255 leaves, 9 trees) over 100k
   rows, every row held against the plain version run on the card, and
   of phase 9's 5-class model, the nine golden models and a 40-feature
   chain (paths longer than a warp), their first 256 rows against the
   plain version on the CPU; local accuracy on every row; the kernel's
   ms, launches and bound (float64 operations over 34 TFLOP/s or bytes
   over 3.35 TB/s), after the split of the binary model's 2M-row
   predict (the upload, the tree walk with its host read a level
   against the same levels with no read; CUDA events).
   ``pred_early_stop`` of the binary and the 5-class
   model at the median first-check margin, equal to the JAX package's
   host loop to the bit, timed against the plain predict. Full width
   (2M x 28, 255 leaves, lr 0.1, fused): bagging 0.8 at max_bin 255
   and 1023, balanced bagging (0.5 / 0.9), GOSS (0.2 / 0.1, 14
   iterations: 4 sample), DART (drop_rate 0.1) and RF (0.632, feature
   fraction 0.8), each with its launch counts and in-training AUC; then
   kernels against plain versions at 100k x 28, 63 leaves, 3 iterations
   of bagging (255 and 1023 bins), GOSS at lr 0.5 and DART: trees, leaf
   values and train scores to the bit;
11. categorical features on the per-phase path of both learners: an
   airline-shaped matrix (the on-time data of LightGBM's categorical
   experiment: Month, DayofMonth, DayOfWeek, CRSDepTime, UniqueCarrier,
   Origin, Dest, Distance; airports and carriers Zipf-skewed; label
   "delayed", ~20% positive), 2M rows and a 500k-row valid set (seed
   43), ``categorical_feature=[0, 1, 2, 4, 5, 6]``, 255 leaves, lr 0.1,
   ``CATEGORICAL_ITERS`` iterations (2: cut from 8 for time, then from 4
   for phase 20), auc and binary_logloss every
   iteration: (a) max_bin 255 (the partitioned learner; the
   partition's LUT route for every categorical split) and (b) max_bin 1023 (the serial learner; Origin
   and Dest keep 300 bins, wider than the 256-bin bitset, so they never
   split). Printed per run: ms/split, the categorical search's
   CUDA-event ms a split and its share of the split, the launch counts
   and the valid AUC; on a, one more tree of 63 leaves under
   torch.profiler: the card's busy time a split and the partition's
   in-training device us a call, LUT and threshold routes apart. Gates: every kernel of the
   run's path launched (the LUT route on a);
   ``predict(pred_leaf=True)`` of the 2M raw rows equal, tree by tree,
   to the bin-space walk of their bins (at b
   except on rows with a categorical bin at or above 256, whose count
   is printed); a's valid AUC above the same data trained with no
   categorical feature; kernels against plain versions at 100k rows,
   ``CUT_PARITY_LEAVES`` (31, cut from 63 for phase 20) leaves, 2
   iterations at max_bin 255 (``max_cat_to_onehot=8``, so
   DayOfWeek goes one-hot) and 1023: the same trees, leaf values and
   valid histories to the bit. Phase 9's golden datasets include the
   reference CLI's ``categorical`` one (``categorical_feature=0,1`` in
   its params);
12. EFB, multi-val, sparse input and two-round loading, each bundled
   (the default) and with ``enable_bundle=false``, 255 leaves, 8
   iterations, auc on a valid set every iteration: (a) the Expo data
   one-hot (``expo_one_hot``: airline_like's six categorical columns
   one-hot, 674 columns, 8 stored entries a row, scipy CSR, 2M rows,
   valid 500k) at max_bin 255 (its plan goes multi-val: the serial
   learner with the ``hist_multival`` kernel); (a') the same rows with
   Origin and Dest numeric (76 columns, 8 groups: the partitioned
   learner's bundled path, the LUT partition); (b) a at max_bin 1023;
   (c) a Bosch-shaped 1M x 968 CSC matrix at 15% stored (``bosch_like``,
   max_bin 63, lr 0.015, min_sum_hessian_in_leaf 5, valid 200k), which
   must go multi-val; (d) 100k rows of a as LibSVM loaded in memory and
   with ``two_round=true``: the matrices byte for byte and the same
   trees; the multi-val histogram kernel against its plain version over
   all of c's rows and a third (max abs err 0); (e) kernels against
   plain versions at 100k rows, ``CUT_PARITY_LEAVES`` leaves, 2
   iterations for a, a', b, c.
   Printed per run: the plan, ms/split, the debundle's CUDA-event share,
   ``hist_multival`` ms a call, the launch counts, the LUT route's
   launches (= bundled splits on the partitioned learner) and the valid
   AUC; for a, a' and c one more tree under torch.profiler (the card's
   busy share, the LUT partition's us a call);
13. the rest of tree growing and linear leaves at 2M x 28 with a 500k
   valid set, each option beside the same per-phase run without it
   (``extras_phase``), then kernels against plain versions at 100k rows;
14. cv, refit, rollback, the scikit-learn estimators, the binary file
   and the feature join at 2M x 28, 255 leaves, 8 iterations
   (``slice15_phase``): (a) ``lt.cv`` with 5 stratified folds, auc and
   early stopping, every fold on the fused segment path (one
   ``fused_split_step_segment`` launch a split), fold 0 bitwise its rows
   binned against the parent and trained alone; (b) ``Booster.refit`` on
   a second draw (seed 44) of ``REFIT_ROWS`` (500k, cut from 2M for phase
   19) at decay 0.9, one ``hist_rows`` launch a
   tree, ``pred_leaf`` and the replay timed apart, leaf values bitwise
   against the plain versions, decay 1.0 unchanged, AUC before and
   after; (c) ``rollback_one_iter`` twice after 10 iterations against
   an 8-iteration run; (d) ``LGBMClassifier`` and ``LGBMRegressor`` fit
   on the first ``ESTIMATOR_ROWS`` (500k, cut from 2M for phase 19) with
   the 500k ``eval_set``, bitwise ``lt.train`` on the same rows, and whether
   scikit-learn was importable; (e) ``save_binary`` and back, and
   ``add_features_from`` of the two column halves; (f) kernels against
   plain versions at 100k rows, 63 leaves: cv at max_bin 255 and 1023
   (2 iterations), and refit (3 trees). The refit route of
   ``hist_rows`` (F 1, B 255, 2M rows) is timed beside its bound for
   the kernels line.
15. more than 1024 bins: the scan and ``hist_rows`` alone
   (``wide_kernel_checks``, run right after phase 2's checks, while the
   profiler keeps its records) at B in {1025, 2048, 4095, 4096}, the
   last width whose one-feature tile fits a block and one past it,
   32,767, 32,768, 32,769 and 65,536 (2M x 28 rows for ``hist_rows``:
   int16 bits up to 32,768, int32 past; the scan bitwise, ``hist_rows``
   by phase 2's rule), with ms, device ms, bound and library time; then
   (``wide_bins_phase``) the 2M x 28 rows at max_bin 4095 on the serial
   learner's per-phase path (255 leaves, 8 iterations, a 500k valid set)
   beside phase 4's per-phase ms/split at 1023, with
   ``fused_split_step_leaf`` never launched and
   ``split_scan`` and ``hist_rows`` once a tree and once a split; then
   kernel against plain at 100k rows, 63 leaves, 2 iterations at max_bin
   4095 and 40,000 (``min_data_in_bin`` 1), the same trees to the bit;
16. the parallel learners (``parallel_phase``): 2 rank processes on the
   one card (this script with ``--rank``; gloo, a ``file://``
   rendezvous, a 150 s collective timeout, not shorter than the elastic
   watchdog's default bounds), each on its 500k-row
   ``host_row_range`` block of 1M Higgs-shaped rows (cut from phase 3's
   2M for time) under ``pre_partition``, binned from the pooled sample
   of every row; ``tree_learner=data`` at max_bin 255 (the segment
   kernels on each rank) and 1023 (``hist_rows`` and the scan), voting (top_k 20) at 255 and feature at 1023 (every row
   on each rank), 255 leaves, 2 iterations (cut from 8 for time), each
   with its ms/split, collectives and bytes a split and launches, held
   against the single process on the same rows and bins (trained here
   while the ranks run: the same bins; data and feature the same trees
   within the tests' tolerance, and whether to the bit; voting's valid
   AUC within 0.002 of the data model's), then each learner kernel
   against plain at 100k rows, ``CUT_PARITY_LEAVES`` (31, cut from 63
   for phase 20) leaves, 2 iterations, the same trees to the bit. A rank
   that fails or runs out of time fails the run.
   (e) the elastic drill (``drill_references`` in the ranks, then
   ``drill_phase``: legs of this script with ``--leg``), at the phase's
   shapes with the drill's watchdog bounds (heartbeats every 100 ms, a
   2 s heartbeat timeout, a 2 s grace, a 3 s stall timeout at 100k rows
   and 60 s at 1M, where an iteration takes 1-4 s) and a coordinated
   checkpoint every iteration: references on the data
   learner at 255 and 1023 bins, ``DRILL_ITERS`` (3, cut from 4 for
   phase 20) iterations (the texts, a write's ms
   a rank, the shard bytes); kill (``kill_rank@rank=1,iter=2``: rank 1
   exits -9, rank 0 43 with one ``peer_lost`` abort line, the seconds
   between the two exits printed and held to the heartbeat timeout plus
   the grace); resume (2 ranks: byte-equal to the 255-bin reference);
   shrink (one process, ``elastic_resume``, on the 1023-bin reference's
   checkpoint of iteration 2: byte-equal to it); guard (the shrink
   without ``elastic_resume``: the world-mismatch error); stall
   (``stall_rank``, 9 s) and drop_heartbeat at 100k rows and 31 leaves,
   run beside the kill leg: both ranks exit 43 with
   ``collective_stall`` / ``peer_lost``. The kill, resume
   and shrink legs' launch counts show rows 1-5 (shrink: 5 and 8) on
   every rank. (f) Queue 1 item 13 in the ranks (``item13_runs``): the
   Expo one-hot (phase 12's 674 columns, 400k rows: its plan goes
   multi-val) on data and voting, each rank its row block, and on rank 0
   the float64 route of ``hist_multival`` against its plain version
   (max abs err 0), timed beside its byte bound; extra_trees with
   ``feature_fraction_bynode`` 0.5 on data at 255 and feature at 1023;
   regression_l1 under ``pre_partition`` on data at 255 (the latent
   score as label). Each held against the single process on the same
   rows (``item13_check``: multi-val data and L1 the same trees within
   the tests' tolerance, and whether to the bit; voting its valid AUC),
   the ranks' trees equal, each run's kernels launched on every rank,
   and kernel against plain bitwise at 100k rows (the Expo's first
   100k, a subset that keeps its multi-val plan), ``CUT_PARITY_LEAVES``
   leaves; the
   extra_trees runs, whose draws differ over ranks by design, there
   also within the tests' tolerance of the same 2-rank run on the CPU
   (their 1M-row valid AUC printed beside the single process's).
17. multiboost (``multiboost_phase``, run after phase 15): (a)
   ``engine.train_many`` over the 2M x 28 rows (255 leaves, the
   script's iterations) in two buckets, 8 models over learning rate x
   lambda_l2 and 4 with bagging (seeds 40-43), every model's text
   byte-equal to its ``lt.train`` twin (the partitioned learner, fused),
   the report (12 batched models, two buckets, route ``batched``), the
   batched and the twins' seconds and ms a split per model, and the
   launches (``fused_split_step_leaf_batched`` at most iterations x 254 a
   bucket, never ``fused_split_step_leaf``); both batched kernels alone
   at the main path's shapes (4 models, then bucket 0's 8 beside them in
   the record): ms, device ms, plain, bound (kernel A: the models'
   ``leaf_bound_ms`` summed, split by split; kernel B: the bins once, 12
   B of ghc a row a model and the histograms written), kernel A's root
   split bitwise the single kernel's model by model, and for kernel B
   ``index_add_`` and the loop of B ``hist_rows`` launches it replaces
   (``loop_ms``); (b) at 100k rows, 63
   leaves, 2 iterations, B = 4: the kernels' model text equal to the
   plain route's, and kernel B against its plain version and against
   ``hist_rows`` model by model (max abs err 0); (c) ``lt.cv`` of 5
   folds of the 2M rows at lr 0.25: ``multiboost=on`` byte-equal to
   ``train_many`` with the folds' ``row_indices``, and within rtol 1e-5
   / atol 1e-7 of ``multiboost=off``'s per-fold loop.
18. the robustness and observability planes (``planes_phase``, run
   after phase 17 on phase 2's bins, with a 500k-row valid set): (a) a
   plain run (255 leaves, max_bin 255, lr 0.1, the script's iterations)
   against one with ``checkpoint_dir`` (freq 2), ``guard_policy=raise``
   and ``guard_loss_spike=10``, the texts byte-equal up to
   ``parameters:``; the checkpoint writes, their ms and bytes, state.npz's
   MB; (b) the drill ``nan_grad@iteration=3;sigterm@iteration=5`` under
   ``guard_policy=rollback``: preempted, then resumed, byte-equal to
   (a), with ``guard.rollbacks``, ``checkpoint.restores`` and the resume
   iteration; (c) ms/split with telemetry on between two runs with it
   off, then ``telemetry_out``, ``trace_out`` and ``profile_dir``: one
   ``iter`` record an iteration whose ``launch.*`` equal the launch
   counters' deltas, one ``phase_probe`` record and the probe's own
   launches (``hist_segment``, ``partition_segment``, ``split_scan``),
   the profiler window's trace holding ``csrc/split_step_segment.cu``'s
   kernel, and the serial learner's probe (``hist_rows``); (d) a drill
   at 100k x 28, 63 leaves, ``PARITY_ITERS`` + 2 iterations (its faults
   at iterations 1 and 2), max_bin 255 and 1023, kernels against plain
   versions, the texts equal. Prints ``[phase 18] <s>``.

19. serving on the card (``serving_phase``, run after phase 10, which
   leaves it phase 3's model, phase 6's quality model and phase 9 (c)'s
   5-class model): each warmed on ``ServingConfig(buckets=(1, 8, 64,
   512), device="always", fallback_to_host=False)`` (the quality model
   from its model text with its AOT artifact); every (bucket, kind)
   program's CUDA graph replay bitwise the eager walk and
   ``Booster.predict``, a chunked 700-row request, the replay's and the
   eager walk's ms; on phase 3's model bench.py's serving block, a 200
   qps open loop and a 3 s soak with a hot reload every 0.5 s, every
   response bitwise ``Booster.predict``; a torn model file (degraded,
   the old version serving), a flood past ``max_queue`` under both shed
   policies, the HTTP frontend's every endpoint with ``/slo`` after an
   SLO engine evaluated; no capture after warmup, no fallback, no failed
   artifact attach. Prints the ``{"serving": ...}`` record.
20. the fleets on the card (``fleet_phase``, run after phase 19 on phase
   3's model as alpha and phase 6's as beta, the same ``ServingConfig``,
   requests from the 2M matrix's first 4096 rows): (a) a thread
   ``FleetEngine`` of 2 replicas (the models from their texts), every
   kind bitwise ``Booster.predict`` at 1, 7, 64, 300 and 700 rows, a
   0.25 canary alpha -> beta over 400 requests (exactly 100 to beta,
   each its target's), a shadow of alpha to its text under a second name
   (0 mismatches, no shadow response returned), a cold replica capturing
   0 graphs, a replica killed under a 2-thread closed loop (none lost,
   none answered twice), a 50 qps tenant shed with ``quota_exceeded``,
   bench.py's serving block (batch 1 and 64, 2 threads, 2 s) on 2 live
   replicas and on 1; (b) a process fleet of 2 workers
   (``serving_isolation=process``, the models as Boosters: each published
   as text with its AOT artifact, the shared-memory ring on), each on
   ``cuda`` with 12 graphs a model, bitwise over JSON frames (1 and 64
   rows: 14,336 B, under ``serving_shm_min_bytes``) and the ring (512
   rows), worker 0 SIGKILLed under a 200 qps open loop of 2 s (none lost)
   and ``crash_replica@rid=1`` meanwhile, both classified and respawned
   (ready ms, the 24 captures a respawn pays), each worker's reserved
   device memory, a 2 s soak with the kill storm at availability 1.0.
   Every fleet is stopped and its workers reaped in a ``finally``. Prints
   ``[phase 20 ...]`` lines and the ``{"fleet": ...}`` record.

21. the pipeline and the CLI on the card (``pipeline_phase``, run after
   phase 20 on phase 3's model as text): (a) ``PipelineDriver`` in
   refit mode over a thread ``FleetEngine`` of 2 replicas (phase 19's
   ``ServingConfig``), 3 cycles of ``REFIT_ROWS``-row windows from
   ``ReplayLogSource(n_features=28)`` with 4,096-row holdouts, 64
   requests a stage over the JAX driver's stages 0.05 / 0.25 / 0.5 and
   its thresholds but ``pipeline_latency_slo_pct`` 1000, cycle 1's
   training window poisoned (``drift@window=2,flip=1,once=1``): cycles 0
   and 2 promoted, 1 rolled back on ``quality_drop``, every parity
   probe and routed response bitwise ``Booster.predict``; each cycle's
   refit, publish and ramp seconds, the device memory reserved after
   each publish (rolled-back candidates stay registered) and every
   stage's canary and primary p99; (b) continue mode, one cycle of
   ``PARITY_ITERS`` 255-leaf trees on a ``REFIT_ROWS``-row window (the
   fused segment step), its ms a split; (c) 4 tenants in one
   ``train_many`` bucket (4 batched, 0 fallbacks); (d) at 100k rows
   re-drawn by ``peek_window``, the refit, continued training at
   ``CUT_PARITY_LEAVES`` leaves and the tenants through the kernels and
   through the plain versions, the candidate texts byte-equal; (e)
   ``cli.main`` on a ``TEXT_ROWS``-row CSV: train (255 leaves, 8
   iterations), predict (bitwise ``Booster.predict``), refit
   (``Booster.refit``'s trees), convert_model (compiled with ``g++ -O2
   -shared -fPIC``, within 1e-12) and one pipeline cycle. Prints
   ``[phase 21 ...]`` lines and the ``{"pipeline": ...}`` record.

The line before the fleet record is phase 21's pipeline record, the line
before the serving record is phase 20's fleet record, the line before
the per-kernel JSON record is phase 19's serving record, the
second-to-last line of output is the per-kernel JSON record and the last
line is ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

F, B = 28, 256
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
WARPS = 8                    # warps of a hist_rows block (csrc/hist_ids.cuh)
# iterations of the 100k-row kernel-against-plain runs of phases 9 and
# 11-16, cut from 3 for the time limit (phase 7 keeps 3 at 255 leaves;
# phase 10's GOSS samples from its third iteration and keeps 3)
PARITY_ITERS = 2
# phase 14 b refits on this many new rows and 14 d's estimators fit this
# many rows of the 2M matrix (both cut from 2M to make room for phase 19;
# PERF.md section 4)
REFIT_ROWS = 500_000
ESTIMATOR_ROWS = 500_000
# phase 8's CSV and LibSVM files hold this many rows (cut from 100k for
# phase 19 as well)
TEXT_ROWS = 50_000
# phase 12 (c)'s unbundled reference (enable_bundle=false) bins and trains
# the first this many of the Bosch rows (cut from all 1M to make room for
# phase 21; PERF.md section 4)
BOSCH_REF_ROWS = 250_000
# the kernel-against-plain runs of phase 11, phase 12 (e) and phase 16
# in the ranks ((b)'s four learners and (f)'s five configs, the
# extra_trees configs' 2-rank CPU runs too) grow this many leaves,
# phase 11 trains CATEGORICAL_ITERS iterations and phase 16 (e)'s drill
# DRILL_ITERS (cut from 63, 4 and 4 to make room for phase 20), and so do
# phases 9, 10 and 13's (cut from 63 to make room for phase 21; PERF.md
# section 4)
CUT_PARITY_LEAVES = 31
# kernel launches of one wrapper call at phase 2's timed shapes (the
# histograms past one chunk add their reduce)
LAUNCHES_A_CALL = {"hist_segment": 2, "partition_segment": 2,
                   "split_scan": 1, "fused_split_step_segment": 1,
                   "fused_split_step_leaf": 1, "hist_rows": 2}
# each wrapper's CUDA kernels, by a part of their names
KERNEL_NAMES = {"hist_segment": ("hist_partial", "hist_reduce"),
                "partition_segment": ("part_",),
                "split_scan": ("split_scan_kernel", "split_scan_wide_kernel"),
                "fused_split_step_segment": ("split_step_kernel",),
                "fused_split_step_leaf": ("split_step_leaf",),
                "hist_rows": ("hist_rows",)}


def higgs_latent(n: int, f: int = F, seed: int = 42):
    """The synthetic Higgs-shaped problem of bench.py (seed 42): the
    matrix and its latent score plus noise, float32."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)

    def c(i):
        return X[:, i % f]

    logit = (2.0 * c(0) - 1.5 * c(1) + c(2) * c(3)
             + 0.8 * c(4) * c(5) - c(6))
    return X, logit + rng.randn(n).astype(np.float32)


def higgs_like(n: int, f: int = F, seed: int = 42):
    """The Higgs-shaped binary problem: label 1 where the latent score
    plus noise is positive."""
    X, z = higgs_latent(n, f, seed)
    return X, (z > 0).astype(np.float32)


def auc(y: np.ndarray, s: np.ndarray) -> float:
    """Rank AUC with average ranks for ties."""
    from scipy.stats import rankdata
    r = rankdata(s)
    pos = y > 0
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((r[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def merged_us(intervals) -> float:
    """The length of the union of (start, end) intervals, us."""
    total, lo, hi = 0.0, None, None
    for s, e in sorted(intervals):
        if hi is None or s > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return total + (0.0 if hi is None else hi - lo)


def device_us(fn, reps: int, kernel, need=()) -> float:
    """Mean device time of the CUDA kernels whose names hold ``kernel``
    (a string, or a tuple of them for a wrapper of several kernels) over
    ``reps`` calls of ``fn``: their intervals on the card's timeline
    merged (torch.profiler), so work ``fn`` does around the kernel (a
    state restored) is left out. Unlike CUDA events around a call, this
    leaves out the host's time between launches, which is most of a
    small kernel's event time. 0 when a name in ``need`` (a kernel
    every call launches) was recorded fewer than ``reps`` times: the
    profiler lost records."""
    parts = (kernel,) if isinstance(kernel, str) else kernel
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and any(p in e.name for p in parts)]
    if any(sum(n in e.name for e in events) < reps for n in need):
        return 0.0
    return merged_us([(e.time_range.start, e.time_range.end)
                      for e in events]) / reps


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_hist(mat, n, reps):
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    worst = 0.0
    # the whole matrix, a large inner segment, and segments at the chunk
    # rule's edges: one chunk exactly, one row over, past the chunk cap
    cap = hc.max_chunks(F) * hc.CHUNK_ROWS + 1
    for begin, count in ((0, n), (n // 16 + 7, n // 2 + 3),
                         (0, hc.CHUNK_ROWS), (5, hc.CHUNK_ROWS + 1),
                         (3, min(cap, n - 3))):
        ref = hc.histogram_segment_plain(mat, begin, count, B, F)
        scale = hc.histogram_segment_plain(mat, begin, count, B, F,
                                           absolute=True)
        for variant in hc.VARIANTS:
            out = hc.histogram_segment(mat, begin, count, B, F,
                                       variant=variant)
            again = hc.histogram_segment(mat, begin, count, B, F,
                                         variant=variant)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                fail(f"histogram not bitwise repeatable ({variant})")
            err = (out - ref).abs()
            if not torch.equal(out[..., 2], ref[..., 2]):
                fail(f"histogram counts differ ({variant}, {begin})")
            tol = 1e-5 * scale + 1e-6
            if bool((err > tol).any()):
                fail(f"histogram off by {float(err.max())} ({variant})")
            worst = max(worst, float(err.max()))
        # the same segment on the device, launched for a larger bound (a
        # child sized by its parent): the chunks come from its own count
        seg = torch.tensor([begin, count], dtype=torch.int32,
                           device=mat.device)
        bound = hc.histogram_segment(mat, seg, None, B, F, max_count=n)
        if not torch.equal(bound.view(torch.int32), out.view(torch.int32)):
            fail(f"histogram of a device segment ({begin}+{count}) differs "
                 "with a larger bound")
    # timings on the full segment: kernel, plain, one index_add_ call
    ms = time_ms(lambda: hc.histogram_segment(mat, 0, n, B, F), reps)
    device_ms = device_us(lambda: hc.histogram_segment(mat, 0, n, B, F),
                          reps, KERNEL_NAMES["hist_segment"]) / 1e3
    plain_ms = time_ms(
        lambda: hc.histogram_segment_plain(mat, 0, n, B, F), 3)
    g, h, c = hc.decode_payload(mat, F)
    keys = (mat[:, :F].long()
            + torch.arange(F, device=mat.device) * B).reshape(-1)
    vals = torch.stack([g, h, c], 1).repeat_interleave(F, 0)
    lib_out = torch.zeros((F * B, 3), device=mat.device)
    library_ms = time_ms(lambda: lib_out.index_add_(0, keys, vals), reps)
    del keys, vals
    nbytes = n * (F + 9) + F * B * 3 * 4
    return dict(max_abs_err=worst, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")


def check_partition(mat, n, reps):
    import torch
    from lightgbm_tpu_torch.ops import partition_cuda as pc
    from lightgbm_tpu_torch.ops.partition import rows_go_left
    ws = torch.empty_like(mat)
    bits = np.zeros(8, np.uint32)
    for cat in (1, 7, 13, 40, 100, 200, 254):
        bits[cat // 32] |= np.uint32(1 << (cat % 32))
    lut = pc.bitset_to_lut(bits).to(mat.device)
    cases = [  # (feat, thr, dleft, missing code, default bin, is_cat)
        (3, 127, 0, 0, 0, False), (5, 90, 1, 1, 128, False),
        (7, 160, 1, 2, 0, False), (9, 40, 0, 2, 0, False),
        (11, 0, 0, 0, 0, True)]
    tile = pc.TILE_ROWS
    # every decision on two large segments, then the look-back's edges:
    # one row, a tile less one, a tile, a tile and one, three tiles less
    # one and plus one, at begin 0 and past it; all rows left, all right
    segments = [(b0, c, case) for b0, c in ((0, n), (n // 16 + 7, n // 2 + 3))
                for case in cases]
    segments += [(b0, c, cases[k % len(cases)])
                 for k, (b0, c) in enumerate(
                     (b0, c) for b0 in (0, 1_001)
                     for c in (1, 255, 256, 257, tile - 1, tile, tile + 1,
                               3 * tile - 1, 3 * tile + 1))]
    segments += [(5, n - 9, (4, B - 1, 0, 0, 0, False)),
                 (5, n - 9, (4, -1, 0, 0, 0, False))]
    for begin, count, (feat, thr, dl, miss, dbin, is_cat) in segments:
        m1, m2 = mat.clone(), mat.clone()
        s1 = pc.partition_segment(m1, ws, begin, count, feat, thr, dl,
                                  miss, dbin, B, is_cat, lut)
        s2 = pc.partition_segment_plain(m2, None, begin, count, feat,
                                        thr, dl, miss, dbin, B, is_cat,
                                        lut)
        torch.cuda.synchronize()
        if not torch.equal(s1, s2) or not torch.equal(m1, m2):
            fail(f"partition differs (feat {feat}, missing {miss}, "
                 f"lut {is_cat}, segment {begin}+{count})")
        del m1, m2
    # two calls in a row on one scratch, the second on the first's
    # children: the scratch is the same tensor and its tile counter is 0
    m1, m2 = mat.clone(), mat.clone()
    ptr = pc._SCRATCH[mat.device][0].data_ptr()
    for begin, count, feat in ((0, n, 3), (0, None, 9)):
        if count is None:
            count = int(s2[1])
        s1 = pc.partition_segment(m1, ws, begin, count, feat, 100, 0, 0, 0,
                                  B, False)
        s2 = pc.partition_segment_plain(m2, None, begin, count, feat, 100,
                                        0, 0, 0, B, False, None)
        torch.cuda.synchronize()
        if not torch.equal(s1, s2) or not torch.equal(m1, m2):
            fail(f"partition differs on a reused scratch ({count} rows)")
    scratch = pc._SCRATCH[mat.device][0]
    if scratch.data_ptr() != ptr or int(scratch[0]) != 0:
        fail("the partition reallocated its scratch or left its counter")
    del m1, m2
    # two kernel launches a call
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pc.partition_segment(mat.clone(), ws, 0, n, 3, 127, 0, 0, 0, B,
                             False)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "part_" in e.name]
    if len(kernels) != 2:
        fail(f"partition_segment launched {kernels}, not two kernels")
    work = mat.clone()
    args = (0, n, 3, 127, 0, 0, 0, B, False, None)
    ms = time_ms(lambda: pc.partition_segment(work, ws, *args), reps)
    device_ms = device_us(lambda: pc.partition_segment(work, ws, *args),
                          reps, KERNEL_NAMES["partition_segment"]) / 1e3
    plain_ms = time_ms(lambda: pc.partition_segment_plain(work, ws, *args),
                       3)
    right = ~rows_go_left(work[:, 3], 127, 0, 0, 0, B)

    def library():
        order = torch.argsort(right.to(torch.uint8), stable=True)
        work.copy_(work[order])
    library_ms = time_ms(library, reps)
    # a stable partition reads the segment once and writes it once
    nbytes = 2 * n * mat.shape[1]
    return dict(max_abs_err=0.0, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")


def check_scan(hists, dataset, b, reps):
    """The scan kernel on two children's [F, b, 3] histograms against its
    plain version, with every missing convention, monotone bounds, L1,
    max_delta_step and a masked feature."""
    import torch
    from lightgbm_tpu_torch.learner.partitioned import (
        feature_meta_from_dataset, split_params_from_config)
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    from lightgbm_tpu_torch.ops.split import O_SCORE, meta_tensors
    dev = hists[0].device
    leaves = []
    for h in hists:
        s = h[0].sum(0).cpu().numpy().astype(np.float32)
        leaves.append((s[0], s[1], s[2], np.float32(-np.inf),
                       np.float32(np.inf)))
    base = feature_meta_from_dataset(dataset)
    cfg = Config.from_params({"objective": "binary", "verbosity": -1})
    nomiss = (base, split_params_from_config(cfg, any_missing=False),
              leaves)
    # a feature mix with every missing convention, monotone bounds,
    # L1 and max_delta_step, one feature masked off
    miss = np.arange(F, dtype=np.int32) % 3
    meta2 = base._replace(
        missing=miss, default_bin=np.full(F, b // 2, np.int32),
        monotone=np.asarray([(i % 5 == 0) - (i % 7 == 0)
                             for i in range(F)], np.int32))
    p2 = split_params_from_config(Config.from_params({
        "objective": "binary", "verbosity": -1, "lambda_l1": 0.5,
        "lambda_l2": 1.0, "max_delta_step": 0.7}), any_missing=True)
    leaves2 = [leaves[0], leaves[1][:3] + (np.float32(-0.05),
                                           np.float32(0.05))]
    for meta, params, lv in (nomiss, (meta2, p2, leaves2)):
        mask = np.ones(F, bool)
        mask[4] = meta is not meta2
        meta_t = meta_tensors(meta, dev, mask)
        k = sc.per_feature_numerical_cuda(hists, lv, meta_t, params)
        p = sc.per_feature_numerical_plain(hists, lv, meta_t, params)
        k, p = k.cpu().numpy(), p.cpu().numpy()
        if not np.isfinite(p[..., O_SCORE]).any():
            fail(f"scan ({b} bins): no valid feature")
        # every column of the table, bit for bit
        if k.tobytes() != p.tobytes():
            at = np.argwhere(k.view(np.int32) != p.view(np.int32))
            fail(f"scan ({b} bins) differs from its plain version at "
                 f"(leaf, feature, column) {at[:4].tolist()}")
    meta_t = meta_tensors(base, dev)
    tables = sc.scan_meta_tables(meta_t)
    params = nomiss[1]
    call = lambda: sc.per_feature_numerical_cuda(  # noqa: E731
        hists, leaves, meta_t, params, tables)
    ms = time_ms(call, reps)
    device_ms = device_us(call, reps, KERNEL_NAMES["split_scan"]) / 1e3
    plain_ms = time_ms(lambda: sc.per_feature_numerical_plain(
        hists, leaves, meta_t, params), reps)
    nbytes = 2 * F * b * 3 * 4 + 2 * F * 8 * 4
    # per bin and direction: ~4 prefix adds, ~40 flops of gain algebra
    ops = 2 * F * b * 2 * 44
    bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
    return dict(max_abs_err=0.0, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / F32_FLOPS else "operations")


def check_scan_widths(dev):
    """The scan kernel at B in {1, 31, 32, 33, 255, 256, 1023, 1024}
    (the 32-bin segments' edges, the static planes' edge) on random
    children of 200k rows, every missing convention: every column
    bitwise its plain version's."""
    import torch
    from lightgbm_tpu_torch.ops import split as sp
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    from lightgbm_tpu_torch.ops.histogram import build_histogram
    n, f = 200_000, F
    for b in (1, 31, 32, 33, 255, 256, 1023, 1024):
        g = torch.Generator(device=dev).manual_seed(b)
        bins = torch.randint(0, b, (n, f), generator=g, device=dev)
        ghc = torch.stack([torch.randn(n, generator=g, device=dev)
                           + (bins[:, 0] > b // 2).float(),
                           torch.rand(n, generator=g, device=dev) + 0.1,
                           torch.ones(n, device=dev)], dim=1)
        hists = [build_histogram(bins[:n // 3], ghc[:n // 3], b),
                 build_histogram(bins[n // 3:], ghc[n // 3:], b)]
        leaves = [tuple(h[0].sum(0).cpu().numpy()) + (-np.inf, np.inf)
                  for h in hists]
        meta = sp.FeatureMeta(
            num_bins=np.full(f, b, np.int32),
            missing=(np.arange(f) % 3).astype(np.int32),
            default_bin=np.full(f, b // 3, np.int32),
            most_freq_bin=np.zeros(f, np.int32),
            monotone=np.zeros(f, np.int32), penalty=np.ones(f, np.float32),
            is_categorical=np.zeros(f, bool))
        meta_t = sp.meta_tensors(meta, dev)
        params = sp.SplitParams(0.0, 1.0, 0.0, 20.0, 1e-3, 0.0, True)
        k = sc.per_feature_numerical_cuda(hists, leaves, meta_t, params)
        p = sc.per_feature_numerical_plain(hists, leaves, meta_t, params)
        if k.cpu().numpy().tobytes() != p.cpu().numpy().tobytes():
            fail(f"scan at {b} bins differs from its plain version")
    return "B 1, 31, 32, 33, 255, 256, 1023, 1024 bitwise"


def launch_floor_ms(reps):
    """A launch's least time on the card: a CUDA graph of 100
    one-element fills replayed (no host work between the launches), the
    median replay over ``reps`` divided by 100."""
    import torch
    x = torch.zeros(1, device="cuda")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(100):
            x.fill_(1.0)
    return time_ms(graph.replay, reps) / 100


def check_fused(mat, n, dataset, reps):
    """The segment fused kernel against its plain version fed the
    per-phase histogram kernel, at three splits of one tree grown by the
    kernel from the matrix: the root (k = 1), a mid-tree split whose
    smaller child has more than one histogram chunk, and a late split
    whose smaller child is one chunk (a direct cache write). At each:
    S, T, k, the matrix and the histogram cache bitwise equal to the
    plain version's, and the kernel bitwise repeatable. The root's
    child histograms are also held against the float64 plain
    histograms. Then the root split's time, and one whole tree of L - 1
    launches from the root between two CUDA events (the tree-average
    time per launch)."""
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learner.partitioned import (
        dataset_any_missing, feature_meta_from_dataset,
        split_params_from_config)
    from lightgbm_tpu_torch.learner.split_step import (SEG_SI_PREFIX,
                                                       make_grow_pack,
                                                       root_state)
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    from lightgbm_tpu_torch.ops.split import meta_tensors
    dev, big_l = mat.device, 255
    meta = feature_meta_from_dataset(dataset)
    params = split_params_from_config(
        Config.from_params({"objective": "binary", "verbosity": -1}),
        dataset_any_missing(dataset))
    pack = make_grow_pack(SEG_SI_PREFIX, has_monotone=False, big_l=big_l)
    meta_t = meta_tensors(meta, dev)
    imeta, fmeta = ss.pack_meta_tables(meta, None, dev)
    hist0 = torch.zeros((big_l, F, B, 3), device=dev)
    hist0[0] = hc.histogram_segment(mat, 0, n, B, F)
    sums = hist0[0, 0].sum(0).cpu().numpy()
    root = tuple(np.float32(v) for v in sums)
    table = sc.per_feature_numerical_cuda(
        [hist0[0]], [root + (np.float32(-np.inf), np.float32(np.inf))],
        meta_t, params)[0]
    st0 = root_state(pack, table, *root, n, params, big_l)
    k0 = torch.ones((1,), dtype=torch.int32, device=dev)
    kw = dict(params=params, big_l=big_l, max_depth=-1, b=B, f=F,
              has_monotone=False)
    scratch = ss.FusedScratch(mat, F, B)
    ws = torch.empty_like(mat)
    start = [k0, st0["S"], st0["T"], mat, hist0]
    state = [t.clone() for t in start]

    def restore(src):
        for dst, t in zip(state, src):
            dst.copy_(t)

    def kernel():
        k, S, T, m, h = state
        ss.fused_split_step_segment(k, S, T, m, ws, h, imeta, fmeta,
                                    scratch=scratch, **kw)

    def plain(per_phase_hist):
        k, S, T, m, h = state
        fn = (lambda mm, bg, ct, mc: hc.histogram_segment(
            mm, bg, ct, B, F, max_count=mc)) if per_phase_hist else None
        ss.fused_split_step_segment_plain(k, S, T, m, ws, h, imeta, fmeta,
                                          histogram=fn, **kw)

    names = ("k", "S", "T", "mat", "hist")

    def agree(src, what):
        """One split from src through the kernel twice and through the
        plain version fed the per-phase histogram kernel: all bitwise
        equal, the split fields of a leaf without a valid split
        included (both store them defined: finite, or 0). Returns the
        kernel's state."""
        restore(src)
        kernel()
        torch.cuda.synchronize()
        got = [t.clone() for t in state]
        for again in (True, False):
            restore(src)
            if again:
                kernel()
            else:
                plain(True)
            torch.cuda.synchronize()
            for name, a, b in zip(names, got, state):
                a, b = a.view(torch.uint8), b.view(torch.uint8)
                if not torch.equal(a, b):
                    fail(f"fused split step ({what}): {name} "
                         + ("not bitwise repeatable" if again else
                            "differs from its plain version"))
        if int(got[0][0]) != int(src[0][0]) + 1:
            fail(f"fused split step did not split ({what})")
        return got

    def next_small(st):
        """The smaller child's rows of the split the kernel takes next
        (from S on the host: the first open leaf of the largest gain)."""
        v = pack.view({"S": st[1].cpu(), "T": st[2].cpu()})
        k = int(st[0][0])
        gain = np.asarray(v["bs_gain"])[:k]
        leaf = int(np.argmax(gain))
        lc = float(v["bs_lc"][leaf])
        return k, float(gain[leaf]), int(min(lc, float(v["leaf_c"][leaf])
                                             - lc))

    got = agree(start, "root split")
    # the root's child histograms against the float64 plain histograms.
    # Leaf 0 holds the left child, leaf 1 the right; the smaller one is
    # built from its own rows and held to its own sum of |values|, the
    # sibling is parent - child and so to the parent's.
    v = pack.view({"S": got[1], "T": got[2]})
    segs = [(int(v["leaf_begin"][i]), int(v["leaf_cnt"][i])) for i in (0, 1)]
    small = 0 if segs[0][1] <= segs[1][1] else 1
    scales = [hc.histogram_segment_plain(got[3], bg, ct, B, F, absolute=True)
              for bg, ct in segs]
    scales[1 - small] = scales[0] + scales[1]
    worst = 0.0
    for leaf, (bg, ct) in enumerate(segs):
        ref = hc.histogram_segment_plain(got[3], bg, ct, B, F)
        err = (got[4][leaf] - ref).abs()
        if bool((err > 1e-5 * scales[leaf] + 1e-6).any()):
            fail(f"fused child histogram {leaf} off by {float(err.max())}")
        worst = max(worst, float(err.max()))

    def timed(fn, count, src):
        times = []
        for _ in range(count):
            restore(src)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    restore(start)
    kernel()   # warm-up
    ms = timed(kernel, reps, start)
    device_ms = device_us(lambda: (restore(start), kernel()), reps,
                          KERNEL_NAMES["fused_split_step_segment"]) / 1e3
    plain_ms = timed(lambda: plain(False), 3, start)
    # one whole tree from the root, its launches between two events
    restore(start)
    a = torch.cuda.Event(enable_timing=True)
    c = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(big_l - 1):
        kernel()
    c.record()
    torch.cuda.synchronize()
    splits = int(state[0][0]) - 1
    tree_ms = a.elapsed_time(c) / (big_l - 1)
    # the same tree split by split: the state before the first split
    # from 100 on whose smaller child has more than one chunk, and
    # before the first from 200 on whose smaller child is one chunk (or,
    # if none is, the smallest such child from 150 on)
    restore(start)
    snaps, best_late = {}, None
    while len(snaps) < 2:
        k, gain, n_small = next_small(state)
        if k >= big_l or gain <= 0:
            break
        if "mid" not in snaps and k >= 101 \
                and hc.child_chunks(n_small, F) > 1:
            snaps["mid"] = ([t.clone() for t in state], n_small)
        if "late" not in snaps and k >= 201 \
                and hc.child_chunks(n_small, F) == 1:
            snaps["late"] = ([t.clone() for t in state], n_small)
        elif "late" not in snaps and k >= 151 and (
                best_late is None or n_small < best_late[1]):
            best_late = ([t.clone() for t in state], n_small)
        kernel()
    snaps.setdefault("late", best_late)
    split_ms = {}
    for name, snap in snaps.items():
        if snap is None:
            fail(f"no {name} split in the tree")
        src, n_small = snap
        what = f"split {int(src[0][0])}, smaller child {n_small} rows"
        agree(src, what)
        split_ms[name] = dict(split=int(src[0][0]), n_small=n_small,
                              chunks=hc.child_chunks(n_small, F),
                              ms=timed(kernel, reps, src))
    # the parent's segment read once and written once (the smaller
    # child's histogram can come from rows already being read), the
    # parent's cache row read and both children's written
    nbytes = 2 * n * mat.shape[1] + 3 * F * B * 3 * 4
    return dict(max_abs_err=worst, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, library_ms=None,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", launch_shape=scratch.shape,
                root_small=segs[small][1], tree_avg_ms=tree_ms,
                tree_splits=splits, splits=split_ms)


def segment_summary(r):
    parts = ", ".join(f"{name} split {d['split']} {d['ms']:.4f} ms "
                      f"(smaller child {d['n_small']} rows, {d['chunks']} "
                      "chunks)" for name, d in r["splits"].items())
    return (f"root split {r['ms']:.4f} ms (smaller child "
            f"{r['root_small']} rows), {parts}, tree average "
            f"{r['tree_avg_ms']:.4f} ms per launch over "
            f"{r['tree_splits']} splits;")


def leaf_bound_ms(n, n_leaf, n_right, n_small, f, b, bin_bytes):
    """Least time of one leaf split: leaf_id read once and the
    right-going rows' ids written, the split feature's bin of the leaf's
    rows, the smaller child's bins and ghc (12 B), the parent's cache
    row read and both children's written."""
    nbytes = (4 * n + 4 * n_right + bin_bytes * n_leaf
              + n_small * (f * bin_bytes + 12) + 3 * f * b * 3 * 4)
    return nbytes / HBM_BYTES_PER_S * 1e3


def check_fused_leaf(binned, ghc, dataset, b, reps):
    """The root split (k = 1) of the [n, F] bin matrix (u8, or the int16
    bits of u16 bins) through the leaf kernel and through its plain
    version from the same state: k, leaf_id and the int rows of S and T
    bitwise equal, the float rows at rtol 1e-5 / atol 1e-5, and both
    child histograms within 1e-5 x sum|x| of the float64 plain
    histograms (the smaller child's own rows for it, the parent's for
    the sibling, which is parent - child). Then one whole tree of L - 1
    launches from the root between two CUDA events (the tree-average
    time per launch), and a small split: the state after 200 splits is
    kept, and the 201st split is held against its plain version and
    timed from it."""
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learner.partitioned import (
        dataset_any_missing, feature_meta_from_dataset,
        split_params_from_config)
    from lightgbm_tpu_torch.learner.split_step import (make_grow_pack,
                                                       root_state)
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    from lightgbm_tpu_torch.ops.histogram import build_histogram
    from lightgbm_tpu_torch.ops.split import meta_tensors
    dev, big_l = binned.device, 255
    n = binned.shape[0]
    meta = feature_meta_from_dataset(dataset)
    params = split_params_from_config(
        Config.from_params({"objective": "binary", "verbosity": -1}),
        dataset_any_missing(dataset))
    pack = make_grow_pack((), has_monotone=False, big_l=big_l)
    imeta, fmeta = ss.pack_meta_tables(meta, None, dev)
    hist0 = torch.zeros((big_l, F, b, 3), device=dev)
    hist0[0] = build_histogram(binned, ghc, b)
    root = tuple(np.float32(v) for v in hist0[0, 0].sum(0).cpu().numpy())
    table = sc.per_feature_numerical_cuda(
        [hist0[0]], [root + (np.float32(-np.inf), np.float32(np.inf))],
        meta_tensors(meta, dev), params)[0]
    st0 = root_state(pack, table, *root, n, params, big_l)
    k0 = torch.ones((1,), dtype=torch.int32, device=dev)
    lid0 = torch.zeros(n, dtype=torch.int32, device=dev)
    kw = dict(params=params, big_l=big_l, max_depth=-1, b=b,
              has_monotone=False)
    scratch = ss.LeafScratch(binned, b)
    start = [k0, st0["S"], st0["T"], lid0, hist0]
    state = [t.clone() for t in start]

    def restore(src):
        for dst, t in zip(state, src):
            dst.copy_(t)

    def kernel():
        ss.fused_split_step_leaf(*state, binned, ghc, imeta, fmeta,
                                 scratch=scratch, **kw)

    def plain():
        ss.fused_split_step_leaf_plain(*state, binned, ghc, imeta, fmeta,
                                       **kw)

    def agree(src, what, gain_size=False):
        """One split from src through the kernel twice (bitwise the
        same) and through the plain version; returns the kernel's state
        and the worst child-histogram error. With ``gain_size`` the gain
        rows (S bs_gain, T split gain) are held to 1e-5 x (|gain| + the
        leaf's g**2 / h) + 1e-5, as tests/test_torch_fused_leaf.py holds
        them: a gain is a difference of terms of that size, so it
        carries their float32 rounding (ROADMAP Queue 3). The split
        fields of a leaf without a valid split are compared like the
        others (both store them defined: finite, or 0)."""
        restore(src)
        kernel()
        torch.cuda.synchronize()
        got = [t.clone() for t in state]
        restore(src)
        kernel()
        torch.cuda.synchronize()
        for name, a, c in zip(("k", "S", "T", "lid", "hist"), got, state):
            if not torch.equal(a.view(torch.uint8), c.view(torch.uint8)):
                fail(f"leaf kernel ({b} bins, {what}): {name} not bitwise "
                     "repeatable")
        restore(src)
        plain()
        torch.cuda.synchronize()
        if int(got[0][0]) != int(src[0][0]) + 1:
            fail(f"leaf kernel ({b} bins) did not split ({what})")
        nf = len(pack.sf_fields)
        if not torch.equal(got[0], state[0]) or not torch.equal(got[3],
                                                                state[3]):
            fail(f"leaf kernel ({b} bins, {what}): k or leaf_id differs "
                 "from plain")
        S_, T_ = state[1], state[2]
        g = S_[pack.sf_idx["leaf_g"]]
        h = torch.clamp(S_[pack.sf_idx["leaf_h"]], min=1e-3)
        v = T_[pack.tf_idx["internal_value"]]
        w = T_[pack.tf_idx["internal_weight"]]
        sizes = {"S": (pack.sf_idx["bs_gain"], g * g / h),
                 "T": (pack.tf_idx["split_gain_arr"], v * v * w.abs())}
        for name, a, c, nfl in (("S", got[1], S_, nf), ("T", got[2], T_, 4)):
            if not torch.equal(a[nfl:].view(torch.int32),
                               c[nfl:].view(torch.int32)):
                fail(f"leaf kernel ({b} bins, {what}): int rows of {name} "
                     "differ")
            fa, fc = a[:nfl].clone(), c[:nfl].clone()
            if gain_size:
                row, size = sizes[name]
                ga, gc = fa[row], fc[row]
                fin = torch.isfinite(gc)
                if not torch.equal(torch.isfinite(ga), fin) \
                        or not torch.equal(ga[~fin], gc[~fin]) \
                        or bool(((ga - gc).abs()[fin] > 1e-5 * (
                            gc.abs() + size)[fin] + 1e-5).any()):
                    fail(f"leaf kernel ({b} bins, {what}): the gain row of "
                         f"{name} differs beyond its gain size")
                fa[row] = fc[row]
            close = torch.isclose(fa, fc, rtol=1e-5, atol=1e-5) \
                | (torch.isinf(fa) & (fa == fc))
            if not bool(close.all()):
                r, col = (int(x) for x in (~close).nonzero()[0])
                fail(f"leaf kernel ({b} bins, {what}): float rows of "
                     f"{name} differ (row {r}, leaf {col}: "
                     f"{float(fa[r, col])!r} vs plain "
                     f"{float(fc[r, col])!r})")
        # the two children: the leaf split and the new one
        lid_old, lid = src[3], got[3]
        moved = lid != lid_old
        new = int(src[0][0])
        parent = int(lid_old[moved][0]) if bool(moved.any()) else new
        n_leaf = int((lid_old == parent).sum())
        n_right = int(moved.sum())
        small = parent if n_leaf - n_right <= n_right else new
        refs, scales = {}, {}
        for leaf in (parent, new):
            m = (lid == leaf).to(torch.float32)[:, None]
            refs[leaf] = build_histogram(binned, ghc * m, b)
            scales[leaf] = build_histogram(binned, ghc.abs() * m, b)
        other = new if small == parent else parent
        scales[other] = scales[parent] + scales[new]
        worst = 0.0
        for leaf in (parent, new):
            err = (got[4][leaf] - refs[leaf]).abs()
            if bool((err > 1e-5 * scales[leaf] + 1e-6).any()):
                fail(f"leaf kernel ({b} bins, {what}): child histogram "
                     f"{leaf} off by {float(err.max())}")
            worst = max(worst, float(err.max()))
        sizes = dict(n_leaf=n_leaf, n_right=n_right,
                     n_small=min(n_right, n_leaf - n_right))
        return got, worst, sizes

    def timed(fn, count, src):
        times = []
        for _ in range(count):
            restore(src)
            a = torch.cuda.Event(enable_timing=True)
            c = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            c.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(c))
        return float(np.median(times))

    _, worst, root_sizes = agree(start, "root split")
    ms = timed(kernel, reps, start)
    device_ms = device_us(lambda: (restore(start), kernel()), reps,
                          KERNEL_NAMES["fused_split_step_leaf"]) / 1e3
    plain_ms = timed(plain, 3, start)
    bin_bytes = binned.element_size()
    bound = leaf_bound_ms(n, n, root_sizes["n_right"], root_sizes["n_small"],
                          F, b, bin_bytes)
    # one whole tree from the root, its launches between two events
    restore(start)
    a = torch.cuda.Event(enable_timing=True)
    c = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(big_l - 1):
        kernel()
    c.record()
    torch.cuda.synchronize()
    splits = int(state[0][0]) - 1
    tree_ms = a.elapsed_time(c) / (big_l - 1)
    # a small split: the state after 200 splits (fewer if the tree
    # stopped early), then the next one
    restore(start)
    for _ in range(min(200, splits - 1)):
        kernel()
    snap = [t.clone() for t in state]
    _, small_err, small_sizes = agree(snap, f"split {int(snap[0][0])}",
                                      gain_size=True)
    small_ms = timed(kernel, reps, snap)
    small_bound = leaf_bound_ms(n, small_sizes["n_leaf"],
                                small_sizes["n_right"],
                                small_sizes["n_small"], F, b, bin_bytes)
    return dict(max_abs_err=max(worst, small_err), ms=ms,
                device_ms=device_ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound, bound_by="bytes",
                launch_shape=scratch.shape, root=root_sizes,
                tree_avg_ms=tree_ms, tree_splits=splits,
                small_split_ms=small_ms, small_split=small_sizes,
                small_split_bound_ms=small_bound)


def leaf_summary(r):
    return (f"root split {r['ms']:.4f} ms (smaller child "
            f"{r['root']['n_small']} rows), small split "
            f"{r['small_split_ms']:.4f} ms (smaller child "
            f"{r['small_split']['n_small']} rows, bound "
            f"{r['small_split_bound_ms']:.5f} ms), tree average "
            f"{r['tree_avg_ms']:.4f} ms per launch over "
            f"{r['tree_splits']} splits;")


def check_hist_rows(bins_by_width, ghc, reps):
    """The full-range histogram kernel (``hist_rows``) against its plain
    version (``build_histogram``) on the [n, F] bin matrices, u8 (255
    bins) and u16 (1023 bins), over all rows (the serial learner's root)
    and over a random third of the rows in row order (a per-phase
    child): bitwise repeatable, counts exact, sums within 1e-5 x the
    bin's sum of |values| + 1e-6. Each case timed beside its plain
    version, its byte bound (each listed row's bins and ghc read once,
    its id too in list mode, the histogram written once) and one
    float32 ``index_add_`` over the flattened (feature, bin) keys of the
    same rows, and as SM cycles per 32-row feature group (ms x the card's
    maximum SM clock / the groups of a busy warp, then / the busy warps
    of an SM at two blocks an SM). The record's own numbers are the u16
    root's (the serial learner's main path)."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    dev = ghc.device
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], stdout=subprocess.PIPE,
        text=True, check=True).stdout.split()[0]) * 1e6
    n = ghc.shape[0]
    gen = torch.Generator(device=dev).manual_seed(11)
    ids = torch.nonzero(torch.rand(n, generator=gen, device=dev) < 1 / 3) \
        .flatten().to(torch.int32)
    cases, worst = {}, 0.0
    for width, (bins, b) in bins_by_width.items():
        partial = hc.rows_partial(bins, b)
        f, bb = bins.shape[1], bins.element_size()
        for mode, rows in (("all rows", None), ("a third", ids)):
            out = hc.histogram_rows(bins, ghc, b, rows, partial=partial)
            again = hc.histogram_rows(bins, ghc, b, rows, partial=partial)
            ref = hc.histogram_rows_plain(bins, ghc, b, rows)
            scale = hc.histogram_rows_plain(bins, ghc.abs(), b, rows)
            torch.cuda.synchronize()
            what = f"hist_rows ({width}, {mode})"
            if not torch.equal(out.view(torch.int32), again.view(torch.int32)):
                fail(f"{what} not bitwise repeatable")
            if not torch.equal(out[..., 2], ref[..., 2]):
                fail(f"{what}: counts differ from the plain version")
            err = (out - ref).abs()
            if bool((err > 1e-5 * scale + 1e-6).any()):
                fail(f"{what} off by {float(err.max())}")
            worst = max(worst, float(err.max()))
            ms = time_ms(lambda: hc.histogram_rows(bins, ghc, b, rows,
                                                   partial=partial), reps)
            device_ms = device_us(
                lambda: hc.histogram_rows(bins, ghc, b, rows,
                                          partial=partial), reps,
                KERNEL_NAMES["hist_rows"]) / 1e3
            plain_ms = time_ms(
                lambda: hc.histogram_rows_plain(bins, ghc, b, rows), 3)
            sel = torch.arange(n, device=dev) if rows is None else rows.long()
            keys = (bins.index_select(0, sel).long() & 0xFFFF) \
                + torch.arange(f, device=dev) * b
            keys = keys.reshape(-1)
            vals = ghc.index_select(0, sel).repeat_interleave(f, 0)
            lib_out = torch.zeros((f * b, 3), device=dev)
            library_ms = time_ms(lambda: lib_out.index_add_(0, keys, vals),
                                 reps)
            del keys, vals
            rows_n = sel.numel()
            nbytes = rows_n * (f * bb + 12 + (0 if rows is None else 4)) \
                + f * b * 3 * 4
            work = hist_rows_work(rows_n, f, b, bb)
            warp_cycles = ms * 1e-3 * clock_hz / work["groups_per_warp"]
            cases[f"{width}, {mode}"] = dict(
                rows=rows_n, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                library_ms=library_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                chunks=hc.leaf_child_chunks(
                    rows_n, f, hc.leaf_feat_tile(f, b, bb)),
                warp_cycles_per_group=warp_cycles,
                sm_cycles_per_group=warp_cycles / (2 * work["busy_warps"]))
        del partial
    main = cases["u16, all rows"]
    return dict(max_abs_err=worst, ms=main["ms"],
                device_ms=main["device_ms"], plain_ms=main["plain_ms"],
                library_ms=main["library_ms"], bound_ms=main["bound_ms"],
                bound_by="bytes", cases=cases)


def hist_rows_work(rows, f, b, bin_bytes):
    """How one ``hist_rows`` launch over ``rows`` rows divides its work:
    blocks, the busy warps of a block (one a feature of the tile, at
    most eight) and the 32-row feature groups each busy warp sums."""
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    tile = hc.leaf_feat_tile(f, b, bin_bytes)
    chunks = hc.leaf_child_chunks(rows, f, tile)
    per_block = -(-rows // chunks)
    busy = min(tile, WARPS)
    return dict(blocks=chunks * -(-f // tile), busy_warps=busy,
                groups_per_warp=-(-per_block // 32) * -(-tile // busy))


def hist_rows_summary(r):
    return "; ".join(f"{name}: {c['ms']:.4f} ms, device "
                     f"{c['device_ms']:.4f} ({c['rows']} rows, "
                     f"{c['chunks']} chunks; plain {c['plain_ms']:.3f}, "
                     f"index_add_ {c['library_ms']:.3f}, bound "
                     f"{c['bound_ms']:.4f}; cycles per 32-row feature "
                     f"group: a busy warp {c['warp_cycles_per_group']:.0f},"
                     f" an SM {c['sm_cycles_per_group']:.1f})"
                     for name, c in r["cases"].items())


def tree_sig(t):
    return (t.num_leaves, t.split_feature_inner.tolist(),
            t.threshold_bin.tolist(), t.decision_type.tolist(),
            t.left_child.tolist(), t.right_child.tolist(),
            [sorted(c.tolist()) for c in t.cat_threshold])


def first_divergence(a, b):
    """The first node (in split order) where two trees differ in
    feature, threshold or default direction, or None."""
    k = min(a.num_leaves, b.num_leaves) - 1
    for s in range(k):
        if (a.split_feature_inner[s], a.threshold_bin[s],
                a.decision_type[s] & 2) != (b.split_feature_inner[s],
                                            b.threshold_bin[s],
                                            b.decision_type[s] & 2):
            return s
    return None


def node_rows(t, s, lid):
    """Mask of the rows that ``lid`` (tree ``t``'s final leaves) puts
    under node ``s``: the rows of the leaf that node ``s`` splits."""
    import torch
    leaves, stack = [], [s]
    while stack:
        node = stack.pop()
        for c in (int(t.left_child[node]), int(t.right_child[node])):
            if c >= 0:
                stack.append(c)
            else:
                leaves.append(~c)
    return torch.isin(lid.long(), torch.as_tensor(leaves, device=lid.device))


def exact_gain(rows, bins, grad, hess, f, thr):
    """Float64 split gain G_L^2/H_L + G_R^2/H_R - G^2/H (the split_gain
    of lambda_l1 = lambda_l2 = 0, no missing values) of splitting the
    masked rows at bin ``thr`` of feature ``f``."""
    g, h = grad[rows].double(), hess[rows].double()
    left = bins[rows, f].long() <= thr
    gl, hl, gs, hs = g[left].sum(), h[left].sum(), g.sum(), h.sum()
    return float(gl ** 2 / hl + (gs - gl) ** 2 / (hs - hl) - gs ** 2 / hs)


def leaf_vs_segment(binned, params, dev, trees=3):
    """The leaf kernel (a ``SerialTreeLearner`` constructed directly, as
    the JAX package's benchmark leg does) against the segment kernel
    (the default ``PartitionedTreeLearner``) at max_bin=255.

    Exact: gradients and hessians in multiples of 1/8 (|g| <= 1), so
    every histogram sum of 2M rows is exact in float32 in any order;
    the segment kernel's float32 sums and the leaf kernel's float64 sums
    are then equal, and so must be every tree, bit for bit (3 trees,
    boosted with lr 0.1). Then binary logloss gradients, tree by tree
    from one shared score (boosted with the segment learner's trees), so
    every tree is compared from the same inputs: where two trees
    differ, the two splits chosen at the first differing node (of one
    leaf, or of two leaves whose gains tie) must be a tie within float
    rounding: their exact float64 gains, each on its leaf's rows,
    within 1e-3 of each other, and each kernel's gain within 1e-3 of
    its split's exact gain (relative). A deep leaf's histogram comes
    from float32 subtractions of its ancestors', so its rounding is at
    the ancestors' scale: the segment kernel's gains were seen 1.0e-4
    off the exact gains at 2M rows. The nodes of that tree after such a
    tie are not compared (the two trees go on from different leaves)."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.learner import (PartitionedTreeLearner,
                                            SerialTreeLearner)
    cfg = lt.Config.from_params(params)
    y = torch.as_tensor(binned.metadata.label, device=dev,
                        dtype=torch.float32)
    lrns = {"segment": PartitionedTreeLearner(binned, cfg, dev),
            "leaf": SerialTreeLearner(binned, cfg, dev)}
    for name, lrn in lrns.items():
        if not lrn.fused:
            fail(f"the {name} learner is not on its fused path")
    grown = {}
    for name, lrn in lrns.items():
        score = torch.zeros(binned.num_data, device=dev)
        grown[name] = []
        for _ in range(trees):
            p = torch.sigmoid(score)
            grad = torch.round((p - y) * 8) / 8
            hess = torch.clamp(torch.round(p * (1 - p) * 8) / 8, min=0.125)
            tree, lid = lrn.train(grad, hess)
            vals = torch.as_tensor(tree.leaf_value, device=dev)
            score += 0.1 * vals[lid.long()]
            grown[name].append(tree)
    same = [tree_sig(a) == tree_sig(b)
            and a.leaf_value.tobytes() == b.leaf_value.tobytes()
            for a, b in zip(grown["segment"], grown["leaf"])]
    print(f"[leaf vs segment] exact gradients, {binned.num_data} x {F}, "
          f"max_bin 255, {trees} trees of "
          f"{[t.num_leaves for t in grown['leaf']]} leaves: identical "
          f"{same}")
    if not all(same):
        fail("the leaf and segment kernels grew different trees from "
             "exact gradients")
    p0 = float(y.mean())
    score = torch.full((binned.num_data,), float(np.log(p0 / (1 - p0))),
                       device=dev)
    bins = binned.binned_device(dev)
    for i in range(trees):
        p = torch.sigmoid(score)
        grad, hess = p - y, p * (1 - p)
        a, lid = lrns["segment"].train(grad, hess)
        b, lid_b = lrns["leaf"].train(grad, hess)
        s = first_divergence(a, b)
        if s is None and tree_sig(a) == tree_sig(b):
            print(f"[leaf vs segment] binary gradients from one score, "
                  f"tree {i}: same structure, all {a.num_leaves - 1} "
                  "nodes compared")
        elif s is None:
            fail(f"leaf and segment trees {i} differ in their children")
        else:
            ga, gb = float(a.split_gain[s]), float(b.split_gain[s])
            rows_a, rows_b = node_rows(a, s, lid), node_rows(b, s, lid_b)
            ea, eb = (exact_gain(r, bins, grad, hess,
                                 int(t.split_feature_inner[s]),
                                 int(t.threshold_bin[s]))
                      for r, t in ((rows_a, a), (rows_b, b)))
            leaf = "the same leaf" if torch.equal(rows_a, rows_b) \
                else "different leaves"
            print(f"[leaf vs segment] binary gradients from one score, "
                  f"tree {i}: first differs at node {s} of "
                  f"{a.num_leaves - 1} (nodes {s}-{a.num_leaves - 2} not "
                  f"compared), {leaf}: gains {ga!r} (segment) and "
                  f"{gb!r} (leaf); exact float64 gains of the two splits "
                  f"{ea!r} and {eb!r}; relative: segment error "
                  f"{abs(ga - ea) / abs(ea):.3g}, leaf error "
                  f"{abs(gb - eb) / abs(eb):.3g}, exact gap "
                  f"{abs(ea - eb) / abs(ea):.3g}")
            if not max(abs(ga - ea) / abs(ea), abs(gb - eb) / abs(eb),
                       abs(ea - eb) / abs(ea)) <= 1e-3:
                fail(f"leaf and segment trees {i} differ at node {s}, not "
                     "at a tie within float rounding")
        vals = torch.as_tensor(a.leaf_value, device=dev)
        score += 0.1 * vals[lid.long()]


# ms/split of each full-width run of train_paths, by (label, path)
PATH_MS = {}


def train_paths(label, params, ds, iters, dev, on_path, fused_kernel):
    """Full-width training through the fused and the per-phase grow
    paths, each driven with the launch counts set to 0 just before it
    and read just after; the two must grow the same trees, and one more
    fused tree runs its split loop under the sync checker. Returns the
    fused run's launch counts and the per-phase run's."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    runs = {}
    for path, extra in (("fused", {}),
                        ("per-phase", {"fused_split_kernel": "off"})):
        _native.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lt.train(dict(params, **extra), ds, iters, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_native.LAUNCHES)
        splits = sum(t.num_leaves - 1 for t in bst.models)
        runs[path] = (bst, launches)
        PATH_MS[label, path] = wall / max(splits, 1) * 1e3
        lrn = bst._gbdt.learner
        print(f"[train {label}] {path}: {type(lrn).__name__}, "
              f"num_bins_max {lrn.num_bins_max}, {len(bst.models)} trees, "
              f"{splits} splits in {wall:.2f} s = "
              f"{wall / max(splits, 1) * 1e3:.3f} ms/split; "
              f"launches {launches}")
        for name in on_path[path]:
            if launches[name] <= 0:
                fail(f"kernel {name} was not launched on the {label} "
                     f"{path} path")
    fused_bst, per_bst = runs["fused"][0], runs["per-phase"][0]
    if not fused_bst._gbdt.learner.fused or per_bst._gbdt.learner.fused:
        fail(f"the default {label} path is not the fused one")
    same = [tree_sig(a) == tree_sig(b)
            for a, b in zip(fused_bst.models, per_bst.models)]
    rel = max(float(np.max(np.abs(a.leaf_value - b.leaf_value)
                           / np.maximum(np.abs(b.leaf_value), 1e-30)))
              for a, b in zip(fused_bst.models, per_bst.models))
    print(f"[train {label}] fused vs per-phase: structure equal {same}, "
          f"max relative leaf value diff {rel:.3g}")
    if len(same) != iters or not all(same) or rel > 1e-5:
        fail(f"the {label} fused and per-phase paths grew different trees")
    # one more fused tree, its split loop under the sync checker and
    # between two CUDA events
    lrn = fused_bst._gbdt.learner
    launch_loop = lrn._launch_fused
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def checked(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            events[0].record()
            launch_loop(*a, **kw)
            events[1].record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    lrn._launch_fused = checked
    fused_bst.update()
    lrn._launch_fused = launch_loop
    torch.cuda.synchronize()
    loop_ms = events[0].elapsed_time(events[1])
    tree = fused_bst.models[-1]
    print(f"[train {label}] tree {len(fused_bst.models)}: "
          f"{lrn.num_leaves - 1} {fused_kernel} launches ran under "
          f"set_sync_debug_mode('error'), {loop_ms:.3f} ms between the "
          f"events = {loop_ms / (lrn.num_leaves - 1):.4f} ms per launch "
          f"({tree.num_leaves - 1} splits); average-split bound "
          f"{avg_split_bound_ms(fused_bst, lrn):.5f} ms over the "
          f"{len(fused_bst.models)} trees")
    return fused_bst, runs["fused"][1], runs["per-phase"][1]


def avg_split_bound_ms(bst, lrn):
    """The fused kernel's bound (chip_smoke's byte counts, per split)
    averaged over every split of the booster's trees, from the trees'
    node and leaf counts: segment, the parent's segment read and written
    once plus three cache rows; leaf, ``leaf_bound_ms``."""
    from lightgbm_tpu_torch.learner import SerialTreeLearner
    from lightgbm_tpu_torch.ops.hist_cuda import matrix_cols
    n, f, b = lrn.num_data, F, lrn.num_bins_max
    total, splits = 0.0, 0
    for t in bst.models:
        def count(c):
            return int(t.internal_count[c]) if c >= 0 \
                else int(t.leaf_count[~c])
        for s in range(t.num_leaves - 1):
            n_leaf = int(t.internal_count[s])
            n_right = count(int(t.right_child[s]))
            n_small = min(n_right, n_leaf - n_right)
            if isinstance(lrn, SerialTreeLearner):
                total += leaf_bound_ms(n, n_leaf, n_right, n_small, f, b,
                                       lrn.binned.element_size())
            else:
                total += (2 * n_leaf * matrix_cols(f) + 3 * f * b * 3 * 4) \
                    / HBM_BYTES_PER_S * 1e3
            splits += 1
    return total / max(splits, 1)


FUSED_SEGMENT_PATH = ("hist_segment", "split_scan",
                      "fused_split_step_segment")


def counted_train(label, params, ds, iters, dev, init_model=None):
    """``lt.train`` with the launch counts set to 0 just before it and
    read just after; every kernel of the partitioned fused path must have
    run."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    _native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lt.train(params, ds, iters, init_model=init_model, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_native.LAUNCHES)
    for name in FUSED_SEGMENT_PATH:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by {label}")
    if not bst._gbdt.learner.fused:
        fail(f"{label} did not run the fused path")
    return bst, wall, launches


def write_csv(path, X, y):
    """Label first, then the features, with a header; every value as
    the shortest text that reads back as the same float64."""
    header = ",".join(["label"] + [f"f{j}" for j in range(X.shape[1])])
    rows = np.column_stack([y, X]).astype(np.float64).tolist()
    with open(path, "w") as f:
        f.write(header + "\n")
        f.write("\n".join(",".join(map(repr, r)) for r in rows) + "\n")


def write_libsvm(path, X, y):
    """``label i:v ...`` with 0-based indices, zeros left out."""
    full = " ".join(["%r"] + [f"{j}:%r" for j in range(X.shape[1])])
    lines = []
    for lab, r in zip(y.astype(np.float64).tolist(),
                      X.astype(np.float64).tolist()):
        lines.append(full % (lab, *r) if 0.0 not in r else " ".join(
            [repr(lab)] + [f"{j}:{v!r}" for j, v in enumerate(r) if v]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def same_trees(a, b):
    """The model text's view of two tree lists equal to the bit: split
    features, raw thresholds, default directions, missing types,
    children and leaf values (a tree read from text has no bins)."""
    def sig(t):
        return (t.num_leaves, t.split_feature.tolist(),
                t.threshold.tobytes(), (t.decision_type & 3).tolist(),
                t.missing_code.tolist(), t.left_child.tolist(),
                t.right_child.tolist(), t.leaf_value.tobytes())
    return len(a) == len(b) and all(sig(s) == sig(t) for s, t in zip(a, b))


def model_file_phase(bst, ds, X, params, dev):
    """Phase 8: the model file on the card. The full-width fused model
    through its text and back (predictions and leaf indices bitwise
    equal, the text a fixed point), continued training from its file,
    every golden model the reference wrote, and training from CSV and
    LibSVM files against training from the same arrays."""
    import os
    import tempfile
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.config import Config
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    from golden_common import DATASETS
    out = {}
    n = X.shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        # the full-width model through its text
        t0 = time.perf_counter()
        text = bst.model_to_string()
        out["write_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        loaded = lt.Booster(model_str=text)
        out["parse_ms"] = (time.perf_counter() - t0) * 1e3
        if loaded.device.type != "cuda":
            fail("a loaded model without a device is not on the card")
        raw = bst.predict(X, raw_score=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw_loaded = loaded.predict(X, raw_score=True)
        out["predict_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        leaf_loaded = loaded.predict(X, pred_leaf=True)
        out["predict_leaf_ms"] = (time.perf_counter() - t0) * 1e3
        leaf = bst.predict(X, pred_leaf=True)
        trees = len(bst.models)
        print(f"[model file] {n} x {X.shape[1]}, {trees} trees of up to "
              f"{max(t.num_leaves for t in bst.models)} leaves, "
              f"{len(text)} bytes: write {out['write_ms']:.1f} ms, parse "
              f"{out['parse_ms']:.1f} ms, predict {n} rows "
              f"{out['predict_ms']:.1f} ms (raw), "
              f"{out['predict_leaf_ms']:.1f} ms (leaf indices)")
        if not np.array_equal(raw, raw_loaded) \
                or not np.array_equal(leaf, leaf_loaded) \
                or leaf.shape != (n, trees):
            fail("the loaded full-width model does not predict as the "
                 "trained one, bit for bit")
        if loaded.model_to_string() != text:
            fail("writing the loaded full-width model gives other text")
        path = os.path.join(tmp, "model.txt")
        bst.save_model(path)

        # continued training from the file: 2 more trees
        more, wall, launches = counted_train(
            "continued training", params, ds, 2, dev, init_model=path)
        grown = more.predict(X, raw_score=True)
        print(f"[model file] continued training: {len(more.models)} trees "
              f"({trees} from the file) in {wall:.2f} s; launches "
              f"{launches}")
        if len(more.models) != trees + 2 \
                or not same_trees(more.models[:trees], bst.models) \
                or not np.isfinite(grown).all():
            fail("continued training did not keep the file's trees, or "
                 "predicts non-finite values")

        # every golden model the reference wrote, on the card
        worst = {}
        for name in sorted(DATASETS):
            g = lt.Booster(model_file=os.path.join(
                here, "tests", "fixtures", "golden", f"model_{name}.txt"))
            _, _, Xte, _ = DATASETS[name]["make"]()
            ref = np.loadtxt(os.path.join(here, "tests", "fixtures",
                                          "golden", f"pred_{name}.txt"))
            pred = g.predict(Xte)
            err = np.abs(pred - ref)
            worst[name] = float(err.max())
            if pred.shape != ref.shape \
                    or not (err <= 1e-6 + 1e-6 * np.abs(ref)).all():
                fail(f"golden model {name} predicts off the reference's "
                     f"output (max abs err {worst[name]:.3g})")
        out["golden_max_abs_err"] = worst
        print(f"[model file] {len(worst)} golden models on the card within "
              f"1e-6 of the reference's output: max abs err {worst}")

        # text data: CSV with a header and LibSVM, against the arrays
        Xt, yt = higgs_like(TEXT_ROWS, seed=5)
        base, _, _ = counted_train("training from arrays", params,
                                   lt.Dataset(Xt, label=yt), 3, dev)
        for fmt, writer, extra in (("csv", write_csv, {"header": True}),
                                   ("libsvm", write_libsvm, {})):
            fpath = os.path.join(tmp, f"train.{fmt}")
            t0 = time.perf_counter()
            writer(fpath, Xt, yt)
            write_s = time.perf_counter() - t0
            fparams = dict(params, **extra)
            fds = lt.Dataset(fpath)
            t0 = time.perf_counter()
            data = fds.raw_matrix(Config.from_params(fparams))
            parse_s = time.perf_counter() - t0
            if not np.array_equal(data, Xt.astype(np.float64)) \
                    or not np.array_equal(fds.label, yt):
                fail(f"the {fmt} file does not read back as its arrays")
            fbst, wall, _ = counted_train(f"training from {fmt}", fparams,
                                          fds, 3, dev)
            out[f"{fmt}_parse_rows_per_s"] = len(yt) / parse_s
            print(f"[model file] {fmt}: {len(yt)} x {Xt.shape[1]} written in "
                  f"{write_s:.2f} s ({os.path.getsize(fpath)} bytes), "
                  f"parsed in {parse_s:.2f} s = "
                  f"{len(yt) / parse_s:.0f} rows/s; binned and 3 fused "
                  f"trees in {wall:.2f} s")
            if not same_trees(fbst.models, base.models):
                fail(f"training from the {fmt} file grew other trees than "
                     "training from the arrays")
    return out


# ---- phase 9: every objective, valid sets and early stopping ---------
OBJECTIVE_RUNS = (
    # (run, objective, max_bin, iterations, metric)
    ("a", "regression", 255, 8, "l2,rmse"),
    ("b", "regression_l1", 255, 8, "l1"),
    ("c", "multiclass", 255, 8, "multi_logloss,multi_error"),
    ("d", "multiclass", 1023, 4, "multi_logloss,multi_error"),
    ("e", "lambdarank", 255, 8, "ndcg"),
)
# the lambdarank example's bagging (examples/lambdarank/train.conf)
RANK_BAGGING = {"bagging_fraction": 0.9, "bagging_freq": 1}
PATH_KERNELS = {255: FUSED_SEGMENT_PATH,
                1023: ("hist_rows", "split_scan", "fused_split_step_leaf")}


def query_sizes(n, seed, lo=10, hi=30):
    """Queries of lo to hi - 1 documents covering n rows (the shape of
    examples/lambdarank/gen_data.py); the last one takes the rest."""
    sizes = np.random.RandomState(seed).randint(lo, hi, n // lo + 1)
    cum = np.cumsum(sizes)
    k = int(np.searchsorted(cum, n))
    sizes = sizes[:k + 1].copy()
    sizes[-1] -= cum[k] - n
    return sizes[sizes > 0]


def objective_labels(objective, z, group=None):
    """A run's labels from the latent score plus noise: the score itself
    (regression), its quintiles (multiclass), or relevance 0-4 by its
    rank inside the query (lambdarank)."""
    if objective.startswith("regression"):
        return z.astype(np.float64)
    if objective == "multiclass":
        return np.digitize(z, np.quantile(z, [0.2, 0.4, 0.6, 0.8])).astype(
            np.float64)
    qid = np.repeat(np.arange(len(group)), group)
    start = np.repeat(np.cumsum(group) - group, group)
    order = np.lexsort((z, qid))
    rank = np.empty(len(z), np.int64)
    rank[order] = np.arange(len(z)) - start[order]
    return np.clip(rank * 5 // np.repeat(group, group), 0, 4).astype(
        np.float64)


def relabeled(binned, label, group=None):
    """A binned dataset under other labels and query groups: the bins
    depend only on the matrix and max_bin, so a run reuses them."""
    import copy
    from lightgbm_tpu_torch.data.dataset import Metadata
    out = copy.copy(binned)
    out.metadata = Metadata(binned.num_data)
    out.metadata.set_label(label)
    out.metadata.set_query(group)
    return out


def labeled_sets(binned, vbinned, X, Xv, objective, z, zv, groups):
    """The train and valid ``lt.Dataset`` of one run over bins made
    once (the valid bins with ``reference=`` the train set)."""
    import lightgbm_tpu_torch as lt
    group, vgroup = groups if objective == "lambdarank" else (None, None)
    y = objective_labels(objective, z, group)
    yv = objective_labels(objective, zv, vgroup)
    tr = lt.Dataset(X, label=y, group=group)
    tr._binned = relabeled(binned, y, group)
    va = tr.create_valid(Xv, label=yv, group=vgroup)
    va._binned = relabeled(vbinned, yv, vgroup)
    return tr, va


class DeviceTimer:
    """CUDA events around every call of a function; summed after one
    synchronisation."""

    def __init__(self):
        self.pairs = []

    def wrap(self, fn):
        import torch

        def timed(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            self.pairs.append(ev)
            return out
        return timed

    def ms(self):
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def objective_run(run, params, tr, va, iters, dev, early_stop=False):
    """One phase-9 run through ``lt.train`` with a valid set, the launch
    counts set to 0 just before it and read just after, and CUDA events
    around the gradients, the L1 refit, each valid-set walk of a tree
    and each evaluation. Returns the booster, its numbers and its valid
    history."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.models.tree import Tree
    from lightgbm_tpu_torch.ops import _native
    timers = {k: DeviceTimer() for k in ("grad", "refit", "walk", "eval")}

    def instrument(env):
        g = env.model._gbdt
        if not hasattr(g, "_timed"):
            g._timed = True
            g.gradients = timers["grad"].wrap(g.gradients)
            g.eval_sets = timers["eval"].wrap(g.eval_sets)
            if g.objective.is_renew_tree_output:
                g.objective.renew_tree_output = timers["refit"].wrap(
                    g.objective.renew_tree_output)
    instrument.before_iteration = True
    hist = {}
    callbacks = [instrument, lt.record_evaluation(hist)]
    if early_stop:
        callbacks.append(lt.early_stopping(3, verbose=False))
    walk = Tree.predict_binned_add
    Tree.predict_binned_add = timers["walk"].wrap(walk)
    try:
        _native.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lt.train(params, tr, iters, valid_sets=[va],
                       valid_names=["valid"], callbacks=callbacks,
                       verbose_eval=False, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Tree.predict_binned_add = walk
    launches = dict(_native.LAUNCHES)
    trees = len(bst.models)
    its = bst.current_iteration()
    splits = sum(t.num_leaves - 1 for t in bst.models)
    info = dict(wall_s=wall, trees=trees, iterations=its, splits=splits,
                ms_per_split=wall / max(splits, 1) * 1e3,
                grad_ms_per_iter=timers["grad"].ms() / max(its, 1),
                walk_ms_per_tree=timers["walk"].ms() / max(trees, 1),
                eval_ms_per_iter=timers["eval"].ms() / max(its, 1),
                launches=launches)
    if timers["refit"].pairs:
        info["refit_ms_per_tree"] = timers["refit"].ms() / trees
    for name in PATH_KERNELS[int(params["max_bin"])]:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by run {run}")
    if not bst._gbdt.learner.fused:
        fail(f"run {run} did not take the fused path")
    return bst, info, hist["valid"]


def objectives_phase(X, binned, binned_wide, dev):
    """Phase 9: runs a-e at 2M x 28 (255 leaves, lr 0.1, the fused
    path), each with a 500k-row valid set; run a's early stopping and
    model text; kernels against plain versions for every new objective
    at 100k x 28; the golden datasets' quality against the reference
    CLI's predictions."""
    import torch
    import lightgbm_tpu_torch as lt
    n = X.shape[0]
    t0 = time.perf_counter()
    _, z = higgs_latent(n)
    Xv, zv = higgs_latent(n // 4, seed=43)
    groups = (query_sizes(n, 44), query_sizes(len(zv), 45))
    vbins = {}
    for max_bin, b in ((255, binned), (1023, binned_wide)):
        base = lt.Dataset(X)
        base._binned = b
        vbins[max_bin] = base.create_valid(Xv)._construct(
            lt.Config.from_params({"max_bin": max_bin, "verbosity": -1}))
    print(f"[objectives] labels, {len(groups[0])} train and "
          f"{len(groups[1])} valid queries, {len(zv)} valid rows binned at "
          f"max_bin 255 and 1023 in {time.perf_counter() - t0:.1f} s")
    out = {}
    run_a = None
    for run, objective, max_bin, iters, metric in OBJECTIVE_RUNS:
        params = {"objective": objective, "num_leaves": 255,
                  "learning_rate": 0.1, "max_bin": max_bin,
                  "metric": metric, "verbosity": -1}
        if objective == "multiclass":
            params["num_class"] = 5
        if objective == "lambdarank":
            params.update(eval_at=[1, 3, 5], **RANK_BAGGING)
        tr, va = labeled_sets(binned if max_bin == 255 else binned_wide,
                              vbins[max_bin], X, Xv, objective, z, zv,
                              groups)
        bst, info, hist = objective_run(run, params, tr, va, iters, dev,
                                        early_stop=run == "a")
        info["history"] = hist
        out[run] = info
        extra = f", refit {info['refit_ms_per_tree']:.3f} ms a tree" \
            if "refit_ms_per_tree" in info else ""
        print(f"[objectives {run}] {objective} max_bin {max_bin} "
              f"({type(bst._gbdt.learner).__name__}): {info['iterations']} "
              f"iterations, {info['trees']} trees, {info['splits']} splits "
              f"in {info['wall_s']:.2f} s = {info['ms_per_split']:.4f} "
              f"ms/split; gradients {info['grad_ms_per_iter']:.3f} ms an "
              f"iteration{extra}; valid walk {info['walk_ms_per_tree']:.3f} "
              f"ms a tree; eval {info['eval_ms_per_iter']:.3f} ms an "
              f"iteration; launches {info['launches']}")
        print(f"[objectives {run}] valid history {json.dumps(hist)}")
        for name, vals in hist.items():
            if len(vals) != info["iterations"] \
                    or not np.isfinite(vals).all():
                fail(f"run {run}'s valid {name} history is not one finite "
                     "value an iteration")
        if run == "a":
            run_a = (bst, Xv[:100_000])
        elif run == "c":
            out["c_model"] = bst       # phase 10 explains it (SHAP)
        else:
            del bst
        del tr, va
        torch.cuda.empty_cache()
    out["early_stopping"] = early_stopping_check(*run_a)
    del run_a
    torch.cuda.empty_cache()
    out["parity"] = objective_parity(dev)
    out["golden"] = golden_quality(dev)
    return out


def early_stopping_check(bst, Xq):
    """Run a's best_iteration through the model text on the card, and
    ``predict`` with no ``num_iteration`` at best_iteration."""
    import lightgbm_tpu_torch as lt
    best = bst.best_iteration
    loaded = lt.Booster(model_str=bst.model_to_string())
    at_best = bst.predict(Xq, num_iteration=best)
    same = np.array_equal(bst.predict(Xq), at_best) \
        and np.array_equal(loaded.predict(Xq), at_best)
    print(f"[objectives a] best_iteration {best} of "
          f"{bst.current_iteration()}; the loaded text holds "
          f"{loaded.current_iteration()} iterations; predict() = "
          f"predict(num_iteration={best}) = loaded predict(): {same}")
    if best < 1 or loaded.current_iteration() != best or not same:
        fail("run a's best_iteration did not survive the model text")
    return {"best_iteration": best,
            "iterations": bst.current_iteration()}


def objective_parity(dev):
    """Kernels against plain versions at 100k x 28,
    ``CUT_PARITY_LEAVES`` leaves (cut from 255, then 63, for the time
    limit), ``PARITY_ITERS`` iterations, for runs a, b, c, e at max_bin
    255 and c at 1023: the
    same trees, leaf values equal to the bit, and the same valid
    histories to the bit."""
    import torch
    import lightgbm_tpu_torch as lt
    Xp, zp = higgs_latent(100_000, seed=3)
    Xpv, zpv = higgs_latent(20_000, seed=4)
    groups = (query_sizes(len(zp), 46), query_sizes(len(zpv), 47))
    out = {}
    for max_bin, runs in ((255, "abce"), (1023, "c")):
        cfg = lt.Config.from_params({"max_bin": max_bin, "verbosity": -1})
        base = lt.Dataset(Xp)
        binned = base._construct(cfg)
        vbinned = base.create_valid(Xpv)._construct(cfg)
        for run, objective, _, _, metric in OBJECTIVE_RUNS:
            if run not in runs:
                continue
            t0 = time.perf_counter()
            params = {"objective": objective,
                      "num_leaves": CUT_PARITY_LEAVES,
                      "learning_rate": 0.1, "max_bin": max_bin,
                      "metric": metric, "verbosity": -1}
            if objective == "multiclass":
                params["num_class"] = 5
            if objective == "lambdarank":
                params.update(RANK_BAGGING)
            res = {}
            for ops in ("kernel", "plain"):
                tr, va = labeled_sets(binned, vbinned, Xp, Xpv, objective,
                                      zp, zpv, groups)
                hist = {}
                b = lt.train(params, tr, PARITY_ITERS, valid_sets=[va],
                             valid_names=["valid"], evals_result=hist,
                             verbose_eval=False, device=dev, ops=ops)
                res[ops] = (b, hist["valid"])
            (kb, kh), (pb, ph) = res["kernel"], res["plain"]
            same = len(kb.models) == len(pb.models) and all(
                tree_sig(a) == tree_sig(c)
                for a, c in zip(kb.models, pb.models))
            diff = max(float(np.abs(a.leaf_value - c.leaf_value).max())
                       for a, c in zip(kb.models, pb.models))
            key = f"{run} max_bin {max_bin}"
            out[key] = dict(trees=len(kb.models), same=same,
                            leaf_value_diff=diff, history_equal=kh == ph,
                            seconds=time.perf_counter() - t0)
            print(f"[objectives parity] {key} ({objective}, "
                  f"{type(kb._gbdt.learner).__name__}, kernel fused "
                  f"{kb._gbdt.learner.fused}): {len(kb.models)} trees, "
                  f"structure equal {same}, max leaf value diff {diff:.3g}, "
                  f"valid histories equal {kh == ph} in "
                  f"{out[key]['seconds']:.1f} s")
            if not same or diff != 0 or kh != ph:
                fail(f"kernel and plain runs differ for run {key}")
            del kb, pb, res
            torch.cuda.empty_cache()
    return out


GOLDEN_QUALITY = {"multiclass": 0.05, "regression_l1": 0.05,
                  "monotone": 0.05, "tweedie": 0.10, "categorical": 0.05,
                  "rank": None}


def golden_loss(objective, spec, p, y):
    """The held-out loss of tests/test_golden_parity.py."""
    p = np.asarray(p)
    if objective == "multiclass":
        p = np.clip(p.reshape(len(y), -1), 1e-12, None)
        return -np.mean(np.log(p[np.arange(len(y)), y.astype(int)]))
    if objective == "tweedie":
        rho = float(spec.get("tweedie_variance_power", 1.5))
        mu = np.clip(p.reshape(-1), 1e-9, None)
        return np.mean(2 * (
            np.where(y > 0, np.maximum(y, 1e-9) ** (2 - rho)
                     / ((1 - rho) * (2 - rho)), 0.0)
            - y * mu ** (1 - rho) / (1 - rho) + mu ** (2 - rho) / (2 - rho)))
    return np.mean(np.abs(p.reshape(-1) - y))


def golden_quality(dev):
    """The golden datasets trained on the card with the reference
    model's train_params; held-out loss within the margins of
    tests/test_golden_parity.py of the reference's recorded predictions
    (NDCG@5 at least the reference's minus 0.02)."""
    import os
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.data.dataset import Metadata
    from lightgbm_tpu_torch.metric.rank_metrics import NDCGMetric
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    from golden_common import DATASETS
    out = {}
    for name, tol in GOLDEN_QUALITY.items():
        spec = dict(kv.split("=", 1) for kv in DATASETS[name]["train_params"])
        n_trees = int(spec.pop("num_trees"))
        Xtr, ytr, Xte, yte = DATASETS[name]["make"]()
        ref = np.loadtxt(os.path.join(here, "tests", "fixtures", "golden",
                                      f"pred_{name}.txt"))
        group = None
        if "make_query" in DATASETS[name]:
            group, qte = DATASETS[name]["make_query"]()
        bst = lt.train(spec, lt.Dataset(Xtr, label=ytr, group=group),
                       n_trees, device=dev)
        pred = bst.predict(Xte)
        if tol is None:
            md = Metadata(len(yte))
            md.set_label(yte)
            md.set_query(qte)
            metric = NDCGMetric(lt.Config.from_params(
                {"objective": "lambdarank", "eval_at": [5]}))
            metric.init(md, len(yte), dev)

            def ndcg5(sc):
                t = torch.as_tensor(np.asarray(sc).reshape(-1),
                                    device=dev)
                return float(metric.eval(t, t)[0])
            ours, theirs = ndcg5(pred), ndcg5(ref)
            ok = ours > theirs - 0.02
            what = "NDCG@5"
        else:
            ours = golden_loss(spec["objective"], spec, pred, yte)
            theirs = golden_loss(spec["objective"], spec, ref, yte)
            ok = ours < theirs * (1 + tol)
            what = f"loss (margin {tol:.0%})"
        out[name] = {"ours": ours, "reference": theirs}
        print(f"[objectives golden] {name}: {what} ours {ours:.6f}, "
              f"reference CLI {theirs:.6f}")
        if not ok:
            fail(f"golden {name}: {what} {ours} against the reference's "
                 f"{theirs}")
    return out


# ---- phase 10: SHAP, early-stopped prediction, row sampling -----------
F64_FLOPS = 34e12            # H100 SXM float64 outside the tensor cores
SHAP_PARITY_ROWS = 256
SAMPLING_RUNS = (
    # (run, extra params, max_bin, iterations)
    ("bagging", {"bagging_fraction": 0.8, "bagging_freq": 1}, 255, 8),
    ("bagging 1023", {"bagging_fraction": 0.8, "bagging_freq": 1}, 1023,
     8),
    ("balanced", {"pos_bagging_fraction": 0.5, "neg_bagging_fraction": 0.9,
                  "bagging_freq": 1}, 255, 8),
    ("goss", {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.1}, 255,
     14),
    ("dart", {"boosting": "dart", "drop_rate": 0.1}, 255, 8),
    ("rf", {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
            "feature_fraction": 0.8}, 255, 8),
)
SAMPLING_PARITY = (
    ("bagging", {"bagging_fraction": 0.8, "bagging_freq": 1}, 255),
    ("bagging 1023", {"bagging_fraction": 0.8, "bagging_freq": 1}, 1023),
    ("goss", {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.1,
              "learning_rate": 0.5}, 255),
    ("dart", {"boosting": "dart", "drop_rate": 0.1}, 255),
)


def shap_explain(label, bst, X, dev, reps, plain_on_card=False,
                 abs_scale=False):
    """One model through ``Booster.predict(pred_contrib=True)`` on the
    card (the launch counts set to 0 just before and read just after),
    local accuracy on every row (1e-9 relative to the raw score, or with
    ``abs_scale`` to the sum of the row's |contributions|, for a
    synthetic chain whose 41-element paths cancel), the kernel against
    its plain version (every row on the card with ``plain_on_card``,
    else the first 256 rows on the CPU), two launches on every row
    bitwise equal, the kernel's ms over ``reps`` calls and its bound."""
    import torch
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.ops.tree_shap_cuda import (ShapModel, shap_work,
                                                       tree_shap_cuda)
    from lightgbm_tpu_torch.predictor import tree_shap_plain
    X = np.ascontiguousarray(X, np.float64)
    n, f = X.shape
    k = bst.num_model_per_iteration()
    _native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bst.predict(X, pred_contrib=True).reshape(n, -1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _native.LAUNCHES["tree_shap"]
    if launches < 1:
        fail(f"SHAP of {label} did not launch tree_shap")
    if out.shape != (n, k * (f + 1)) or not np.isfinite(out).all():
        fail(f"SHAP of {label}: shape {out.shape} or not finite")
    raw = bst.predict(X, raw_score=True).reshape(n, k)
    per = out.reshape(n, k, f + 1)
    scale = np.abs(per).sum(axis=2) if abs_scale else np.abs(raw)
    local = np.abs(per.sum(axis=2) - raw) / np.maximum(scale, 1e-300)
    if not (np.abs(per.sum(axis=2) - raw) <= 1e-12 + 1e-9 * scale).all():
        fail(f"SHAP of {label}: local accuracy off by {local.max():.3g}")
    models = bst.models
    xd = torch.from_numpy(X).to(dev)
    sm = ShapModel(models, k, dev)
    if not torch.equal(tree_shap_cuda(sm, xd), tree_shap_cuda(sm, xd)):
        fail(f"SHAP of {label}: the kernel is not bitwise repeatable")
    ms = time_ms(lambda: tree_shap_cuda(sm, xd), reps)
    plain_ms = None
    if plain_on_card:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = tree_shap_plain(models, xd, k)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        ref, got = ref.cpu().numpy(), out
    else:
        m = min(n, SHAP_PARITY_ROWS)
        ref = tree_shap_plain(models, torch.from_numpy(X[:m]), k).numpy()
        got = tree_shap_cuda(sm, xd[:m]).cpu().numpy()
    err = float(np.abs(got - ref).max())
    if not np.allclose(got, ref, rtol=1e-9, atol=1e-12):
        fail(f"SHAP of {label}: the kernel is {err:.3g} from the plain "
             "version")
    nbytes, ops = shap_work(sm.paths, n, f, k)
    bound = max(nbytes / HBM_BYTES_PER_S, ops / F64_FLOPS) * 1e3
    r = dict(rows=n, trees=len(models), paths=len(sm.paths["pvalue"]),
             max_path=sm.paths["max_len"], wall_ms=wall * 1e3, ms=ms,
             plain_ms=plain_ms, max_abs_err=err,
             parity_rows=len(ref), launches=launches,
             local_rel_err=float(local.max()), bound_ms=bound,
             bound_by="operations" if ops / F64_FLOPS
             > nbytes / HBM_BYTES_PER_S else "bytes")
    print(f"[shap {label}] {n} x {f}, {len(models)} trees, "
          f"{r['paths']} paths of at most {r['max_path']} elements: "
          f"predict(pred_contrib) {r['wall_ms']:.1f} ms wall, kernel "
          f"{ms:.3f} ms (bound {bound:.4f} ms, {r['bound_by']}), "
          f"launches {launches}; kernel vs plain on {len(ref)} rows "
          f"max abs err {err:.3g}"
          + (f", plain on the card {plain_ms:.1f} ms" if plain_ms else "")
          + f"; local accuracy {r['local_rel_err']:.3g} relative")
    return r


def early_stop_reference(bst, X, freq, margin):
    """The JAX package's early-stopped loop (predictor.py:140) in numpy
    on the host trees: each row's float64 sum in tree order, its live
    rows checked every ``freq * k`` trees."""
    k = bst.num_model_per_iteration()
    models = bst.models
    raw = np.zeros((len(X), k))
    active = np.arange(len(X))
    period = freq * k
    for i, t in enumerate(models):
        if len(active) == 0:
            break
        raw[active, i % k] += t.predict(X[active])
        if (i + 1) % period == 0 and i + 1 < len(models):
            sub = raw[active]
            if k == 1:
                m = 2.0 * np.abs(sub[:, 0])
            else:
                top = np.sort(sub, axis=1)
                m = top[:, -1] - top[:, -2]
            active = active[m < margin]
    return raw


def early_stop_check(label, bst, X, dev, reps, freq=2):
    """``pred_early_stop`` on the card at the median margin of the first
    check (about half the rows stop there): scores equal to the host
    loop's to the bit, and its ms against the plain predict's."""
    k = bst.num_model_per_iteration()
    X = np.ascontiguousarray(X, np.float64)
    first = bst.predict(X, raw_score=True,
                        num_iteration=freq).reshape(len(X), k)
    if k == 1:
        m = 2.0 * np.abs(first[:, 0])
    else:
        top = np.sort(first, axis=1)
        m = top[:, -1] - top[:, -2]
    margin = float(np.median(m))
    kw = dict(raw_score=True, pred_early_stop=True,
              pred_early_stop_freq=freq, pred_early_stop_margin=margin)
    got = bst.predict(X, **kw).reshape(len(X), k)
    ref = early_stop_reference(bst, X, freq, margin)
    same = np.array_equal(got, ref)
    stopped = float(np.mean(m >= margin))
    es_ms = time_ms(lambda: bst.predict(X, **kw), reps)
    full_ms = time_ms(lambda: bst.predict(X, raw_score=True), reps)
    print(f"[early stop {label}] {len(X)} rows, {len(bst.models)} trees, "
          f"freq {freq}, margin {margin:.4g} ({stopped:.1%} stop at the "
          f"first check): {es_ms:.2f} ms against the plain predict's "
          f"{full_ms:.2f} ms; equal to the host loop to the bit: {same}")
    if not same:
        fail(f"early-stopped predict of {label} differs from the host loop")
    return dict(ms=es_ms, plain_ms=full_ms, stopped=stopped)


def walk_levels(stacked, x, levels):
    """``predictor.predict_leaf_index``'s walk for exactly ``levels``
    levels (the predictor walks the stack's deepest level, ``depth``)."""
    import torch
    from lightgbm_tpu_torch.predictor import _category_left, numerical_left
    t, n = stacked["feat"].shape[0], x.shape[0]
    node = torch.zeros((t, n), dtype=torch.int64, device=x.device)
    out = torch.zeros((t, n), dtype=torch.int64, device=x.device)
    done = stacked["single"][:, None].expand(t, n).clone()
    rows = torch.arange(n, device=x.device)[None, :].expand(t, n)
    for _ in range(levels):
        nd = torch.where(done, torch.zeros_like(node), node)

        def at(name):
            return torch.gather(stacked[name], 1, nd)
        go_left, fval = numerical_left(x[rows, at("feat")], at("thr"),
                                       at("dleft"), at("miss"))
        if stacked["words"] is not None:
            go_left = torch.where(at("is_cat"), _category_left(
                stacked["words"], nd, fval), go_left)
        child = torch.where(go_left, at("left"), at("right"))
        is_leaf = child < 0
        out = torch.where(~done & is_leaf, ~child, out)
        node = torch.where(~done & ~is_leaf, child, node)
        done = done | is_leaf
    return out


def predict_split(bst, X, dev):
    """How the 2M-row predict's time splits (PERF.md section 7), with
    CUDA events and host clocks (no profiler): the rows to float64 on
    the host, their upload, the tree walk as ``predict_raw`` runs it
    (the stack's deepest level, with no host read) against each chunk's
    own deepest level, and the whole ``predict_raw``."""
    import torch
    from lightgbm_tpu_torch.predictor import (_row_chunks, predict_raw,
                                              predict_leaf_index,
                                              stack_trees, used_models)
    models = used_models(bst._src())
    k = bst.num_model_per_iteration()
    predict_raw(models, X[:1000], dev, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    X = np.asarray(X, np.float64)
    convert = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    predict_raw(models, X, dev, k)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    x = torch.as_tensor(X, device=dev)
    ev[1].record()
    torch.cuda.synchronize()
    upload = ev[0].elapsed_time(ev[1])
    stacked = stack_trees(models, dev)
    chunks = _row_chunks(len(X), len(models))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    leaves = [predict_leaf_index(stacked, x[lo:hi]) for lo, hi in chunks]
    torch.cuda.synchronize()
    walk = (time.perf_counter() - t0) * 1e3
    # the deepest leaf each chunk's rows reached
    levels = [max(int(t.leaf_depth[li[i].cpu().numpy()].max())
                  for i, t in enumerate(models) if t.num_leaves > 1)
              for li in leaves]
    ev[0].record()
    fixed = [walk_levels(stacked, x[lo:hi], lv)
             for (lo, hi), lv in zip(chunks, levels)]
    ev[1].record()
    torch.cuda.synchronize()
    device_walk = ev[0].elapsed_time(ev[1])
    if not all(torch.equal(a, b) for a, b in zip(fixed, leaves)):
        fail("the walk of each chunk's own levels found other leaves")
    r = dict(convert_ms=convert, wall_ms=wall, upload_ms=upload,
             walk_ms=walk, walk_chunk_levels_ms=device_walk,
             levels=stacked["depth"], chunk_levels=levels,
             chunks=len(chunks))
    print(f"[predict split] {len(X)} rows x {len(models)} trees "
          f"({len(chunks)} row chunks): the rows to float64 on the host "
          f"{convert:.1f} ms; predict_raw {wall:.1f} ms; of it the upload "
          f"{upload:.1f} ms (CUDA events) and the tree walk {walk:.1f} ms "
          f"({stacked['depth']} levels, no host read), against "
          f"{device_walk:.1f} ms for each chunk's own deepest level "
          f"{levels} (CUDA events)")
    return r


def sampling_run(label, params, ds, iters, dev, y):
    """One full-width training run with row sampling through the fused
    path, the launch counts set to 0 just before it and read just after;
    every kernel of the path must have run. Prints ms/split and the
    in-training AUC (the train scores against the labels)."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    _native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lt.train(params, ds, iters, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_native.LAUNCHES)
    splits = sum(t.num_leaves - 1 for t in bst.models)
    for name in PATH_KERNELS[int(params["max_bin"])]:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the {label} run")
    lrn = bst._gbdt.learner
    if not lrn.fused:
        fail(f"the {label} run did not take the fused path")
    score = bst._gbdt.train_score[:, 0].cpu().numpy()
    a = auc(y, score)
    bag = bst._gbdt.bag_weight
    inbag = "all" if bag is None else f"{float(bag.gt(0).float().mean()):.4f}"
    print(f"[sampling {label}] {type(lrn).__name__}, {len(bst.models)} "
          f"trees, {splits} splits in {wall:.2f} s = "
          f"{wall / max(splits, 1) * 1e3:.4f} ms/split; in-training AUC "
          f"{a:.5f}; rows in the last bag {inbag}; launches {launches}")
    if not np.isfinite(score).all() or len(bst.models) != iters:
        fail(f"the {label} run's scores are not finite or it stopped")
    return dict(ms_per_split=wall / max(splits, 1) * 1e3, auc=a,
                trees=len(bst.models), launches=launches)


def sampling_parity(dev):
    """Kernels against plain versions at 100k x 28,
    ``CUT_PARITY_LEAVES`` leaves (cut from 63), 3 iterations: bagging (255 and 1023 bins), GOSS at lr 0.5 (it samples
    from iteration 2) and DART; trees, leaf values and train scores to
    the bit."""
    import torch
    import lightgbm_tpu_torch as lt
    Xp, yp = higgs_like(100_000, seed=3)
    out = {}
    for label, extra, max_bin in SAMPLING_PARITY:
        t0 = time.perf_counter()
        params = dict({"objective": "binary",
                       "num_leaves": CUT_PARITY_LEAVES,
                       "learning_rate": 0.1, "max_bin": max_bin,
                       "verbosity": -1}, **extra)
        ds = lt.Dataset(Xp, label=yp)
        kb, pb = (lt.train(params, ds, 3, device=dev, ops=ops)
                  for ops in ("kernel", "plain"))
        same = len(kb.models) == len(pb.models) == 3 and all(
            tree_sig(a) == tree_sig(b) for a, b in zip(kb.models, pb.models))
        leaves = all(np.array_equal(a.leaf_value, b.leaf_value)
                     for a, b in zip(kb.models, pb.models))
        scores = torch.equal(kb._gbdt.train_score, pb._gbdt.train_score)
        out[label] = dict(same=same, leaves=leaves, scores=scores,
                          seconds=time.perf_counter() - t0)
        print(f"[sampling parity] {label} ({type(kb._gbdt.learner).__name__}"
              f", kernel fused {kb._gbdt.learner.fused}): structure equal "
              f"{same}, leaf values equal {leaves}, train scores equal "
              f"{scores} in {out[label]['seconds']:.1f} s")
        if not (same and leaves and scores):
            fail(f"kernel and plain runs differ for {label}")
        del kb, pb
        torch.cuda.empty_cache()
    return out


def sampling_phase(X, y, binned, binned_wide, bin_bst, mc_bst, dev, reps):
    """Phase 10: SHAP (the tree_shap kernel) of the full-width binary
    model, phase 9's 5-class model, the golden models and a chain deeper
    than a warp; early-stopped prediction of the first two; training
    with bagging, balanced bagging, GOSS, DART and RF at full width; the
    kernels against their plain versions with sampling. Returns the
    tree_shap record and its launches on the main path (the binary
    model's SHAP)."""
    import os
    import torch
    import lightgbm_tpu_torch as lt
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    from golden_common import DATASETS
    from torch_shap_model import chain_rows, chain_tree
    predict_split(bin_bst, X, dev)
    rows = X[:100_000]
    shap = shap_explain("binary", bin_bst, rows, dev, reps,
                        plain_on_card=True)
    shap_explain("multiclass 5", mc_bst, rows, dev, max(reps // 4, 2))
    for name in sorted(DATASETS):
        with open(os.path.join(here, "tests", "fixtures", "golden",
                               f"model_{name}.txt")) as fh:
            gb = lt.Booster(model_str=fh.read(), device=dev)
        Xte = DATASETS[name]["make"]()[2]
        Xte = Xte.todense() if hasattr(Xte, "todense") else Xte
        shap_explain(f"golden {name}", gb, np.asarray(Xte), dev, 2)
    chain = lt.Booster.from_trees(
        [chain_tree(list(range(40)), list(0.05 * np.arange(40) - 1.0),
                    seed=2)], {"objective": "regression"}, device=dev)
    shap_explain("40-feature chain", chain, chain_rows(40, n=5_000), dev, 2,
                 abs_scale=True)
    for label, bst in (("binary", bin_bst), ("multiclass 5", mc_bst)):
        early_stop_check(label, bst, rows, dev, max(reps // 4, 2))
    base = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
            "verbosity": -1}
    for label, extra, max_bin, iters in SAMPLING_RUNS:
        ds = lt.Dataset(X, label=y)
        ds._binned = binned if max_bin == 255 else binned_wide
        sampling_run(label, dict(base, max_bin=max_bin, **extra), ds,
                     iters, dev, y)
        torch.cuda.empty_cache()
    sampling_parity(dev)
    rec = dict(max_abs_err=shap["max_abs_err"], ms=shap["ms"],
               device_ms=None, plain_ms=shap["plain_ms"],
               bound_ms=float(shap["bound_ms"]), bound_by=shap["bound_by"],
               library_ms=None)
    return rec, shap["launches"]

# ---- phase 11: categorical features ------------------------------------
AIRLINE_CATEGORICAL = [0, 1, 2, 4, 5, 6]
# cut from 8, then 4, for the time limit (PERF.md section 4)
CATEGORICAL_ITERS = 2
CATEGORICAL_PROFILE_LEAVES = 63   # the profiled tree, cut from 255 as well
CATEGORICAL_PATH = {255: ("hist_segment", "partition_segment", "split_scan"),
                    1023: ("hist_rows", "split_scan")}


def airline_like(n: int, seed: int = 42):
    """An airline-shaped matrix: the columns of the on-time data of
    LightGBM's "Optimal Split for Categorical Features" experiment (Expo
    data) with their cardinalities, Month (12), DayofMonth (31),
    DayOfWeek (7), CRSDepTime (hhmm), UniqueCarrier (22), Origin (300),
    Dest (300) and Distance; carriers Zipf(1.1) and airports Zipf(1.5)
    over shuffled ids. The label (delayed, ~20% positive) is logistic in
    per-category effects, the departure hour and the log distance. The
    effects, ids and distances are one fixed draw (seed 7), the rows
    come from ``seed``."""
    rng = np.random.RandomState(seed)
    world = np.random.RandomState(7)
    month_e, dom_e, dow_e = (world.randn(k) * sd for k, sd in
                             ((12, 0.3), (31, 0.1), (7, 0.25)))
    carrier_e, origin_e, dest_e = (world.randn(k) * sd for k, sd in
                                   ((22, 0.4), (300, 0.5), (300, 0.4)))
    carrier_ids, origin_ids, dest_ids = (world.permutation(k)
                                         for k in (22, 300, 300))
    miles = world.uniform(100.0, 2700.0, (300, 300))

    def zipf(k, s):
        p = np.arange(1, k + 1, dtype=np.float64) ** -s
        return rng.choice(k, n, p=p / p.sum())
    month = rng.randint(0, 12, n)
    dom = rng.randint(0, 31, n)
    dow = rng.randint(0, 7, n)
    hour = rng.choice(np.arange(5, 24), n)
    dep = hour * 100 + rng.randint(0, 60, n)
    carrier = carrier_ids[zipf(22, 1.1)]
    origin = origin_ids[zipf(300, 1.5)]
    dest = dest_ids[zipf(300, 1.5)]
    dist = miles[origin, dest] * np.exp(0.05 * rng.randn(n))
    logit = (-1.75 + month_e[month] + dom_e[dom] + dow_e[dow]
             + carrier_e[carrier] + origin_e[origin] + dest_e[dest]
             + 0.07 * (hour - 14) + 0.2 * np.log(dist / 800.0))
    y = (logit + rng.logistic(size=n) > 0).astype(np.float32)
    X = np.column_stack([month, dom, dow, dep, carrier, origin, dest,
                         dist]).astype(np.float64)
    return X, y


def categorical_run(label, params, tr, va, iters, dev):
    """One phase-11 run through ``lt.train`` with its valid set, the
    launch counts set to 0 just before it and read just after, CUDA
    events around every categorical search (``per_feature_categorical``:
    both children of a split in one call). Returns the booster, its
    numbers and its valid history."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.ops import split_categorical as sc
    timer = DeviceTimer()
    search = sc.per_feature_categorical
    sc.per_feature_categorical = timer.wrap(search)
    hist = {}
    try:
        _native.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lt.train(params, tr, iters, valid_sets=[va],
                       valid_names=["valid"], evals_result=hist,
                       verbose_eval=False, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sc.per_feature_categorical = search
    launches = dict(_native.LAUNCHES)
    lut = _native.ROUTE_LAUNCHES["partition_segment_lut"]
    splits = sum(t.num_leaves - 1 for t in bst.models)
    cat_nodes = sum(int((t.decision_type[:t.num_leaves - 1] & 1).sum())
                    for t in bst.models)
    ms_split = wall / max(splits, 1) * 1e3
    search_ms = timer.ms() / max(splits, 1)
    info = dict(wall_s=wall, trees=len(bst.models), splits=splits,
                categorical_splits=cat_nodes, ms_per_split=ms_split,
                search_ms_per_split=search_ms,
                search_share=search_ms / ms_split,
                launches=launches, lut_launches=lut,
                valid_auc=hist["valid"]["auc"][-1])
    lrn = bst._gbdt.learner
    print(f"[categorical {label}] {type(lrn).__name__} (fused "
          f"{lrn.fused}), num_bins_max {lrn.num_bins_max}: "
          f"{len(bst.models)} trees, {splits} splits ({cat_nodes} "
          f"categorical) in {wall:.2f} s = {ms_split:.3f} ms/split; "
          f"categorical search {search_ms:.3f} ms a split "
          f"({info['search_share']:.1%}, CUDA events); launches "
          f"{launches}, LUT route {lut}; valid "
          f"auc {[round(v, 6) for v in hist['valid']['auc']]}, "
          f"binary_logloss "
          f"{[round(v, 6) for v in hist['valid']['binary_logloss']]}")
    for name in CATEGORICAL_PATH[int(params["max_bin"])]:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by categorical run "
                 f"{label}")
    if int(params["max_bin"]) == 255 and (lut <= 0 or lut != cat_nodes):
        fail(f"categorical run {label}: {lut} LUT-route partitions for "
             f"{cat_nodes} categorical splits")
    if lrn.fused or not cat_nodes:
        fail(f"categorical run {label} took the fused path or grew no "
             "categorical split")
    return bst, info, hist["valid"]


def categorical_profile(label, params, tr, dev, tag="categorical"):
    """One more tree of a phase-11 (or 12, ``tag``) run under
    torch.profiler: the card's
    busy time a split (every kernel's interval merged) and, on the
    partitioned learner, the partition's in-training device us a call by
    route (a call's two kernels merged: the k-th call is the k-th pair
    of ``part_`` kernels on the stream)."""
    import torch
    import lightgbm_tpu_torch as lt
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lightgbm_tpu_torch.ops import _native, split_step_cuda as ssc
    routes, part = [], ssc.partition_segment
    launched = _native.LAUNCHES["partition_segment"]

    def recorded(*a, **kw):
        routes.append(bool(a[10]))
        return part(*a, **kw)
    ssc.partition_segment = recorded
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            bst = lt.train(params, tr, 1, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        ssc.partition_segment = part
    launched = _native.LAUNCHES["partition_segment"] - launched
    if launched != len(routes):
        fail(f"{tag} {label}: {launched} partition launches for "
             f"{len(routes)} calls")
    evs = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    splits = max(bst.models[0].num_leaves - 1, 1)
    busy_ms = merged_us([(a, b) for a, b, _ in evs]) / 1e3
    out = dict(profiled_ms_per_split=wall / splits * 1e3,
               busy_ms_per_split=busy_ms / splits,
               idle_share=1.0 - busy_ms / (wall * 1e3))
    pairs = [(a, b) for a, b, name in evs if "part_" in name]
    # the k-th call's kernels are the k-th pair on the stream. Every call
    # launched (the wrapper's count above); torch.profiler now and then
    # drops a record, and then the pairs no longer line up and the
    # per-route times are not measured. More records than launches is a
    # fault.
    if len(pairs) > 2 * len(routes):
        fail(f"{tag} {label}: {len(pairs)} partition kernels for "
             f"{len(routes)} calls")
    paired = bool(routes) and len(pairs) == 2 * len(routes)
    if paired:
        per_call = [merged_us(pairs[2 * i:2 * i + 2])
                    for i in range(len(routes))]
        for key, want in (("lut", True), ("threshold", False)):
            us = [u for u, r in zip(per_call, routes) if r == want]
            out[f"partition_{key}_calls"] = len(us)
            out[f"partition_{key}_us_per_call"] = float(np.mean(us)) \
                if us else None
    note = ""
    if routes and not paired:
        note = ("; partition in training, device us a call: not measured "
                f"(the profiler recorded {len(pairs)} partition kernels "
                f"for {len(routes)} calls)")
    elif routes:
        note = "; partition in training, device us a call: " + ", ".join(
            f"{k} route {out[f'partition_{k}_us_per_call']:.2f} "
            f"({out[f'partition_{k}_calls']} calls)"
            if out[f"partition_{k}_calls"] else f"{k} route no call"
            for k in ("lut", "threshold"))
    print(f"[{tag} {label}] one more tree under the profiler: "
          f"{out['profiled_ms_per_split']:.3f} ms/split, the card busy "
          f"{out['busy_ms_per_split']:.4f} ms a split (idle share "
          f"{out['idle_share']:.3f}){note}")
    return out


def leaf_walk_check(label, bst, X, binned, dev, wide_cols):
    """``predict(X, pred_leaf=True)`` of the raw rows against the
    bin-space walk of their bins (``Tree.predict_binned_add`` with the
    leaf indices as leaf values), tree by tree. Differences are allowed
    only on rows with a bin at or above 256 in one of ``wide_cols`` (the
    bitset's edge, ROADMAP.md Queue 3); their count is printed."""
    import copy
    import torch
    leaves = bst.predict(X, pred_leaf=True)
    bins = binned.binned_device(dev)
    edge = np.zeros(len(X), bool)
    for c in wide_cols:
        edge |= binned.binned[:, c].astype(np.int64) >= 256
    bad = edge_diff = 0
    for j, t in enumerate(bst.models):
        walk_tree = copy.copy(t)
        walk_tree.leaf_value = np.arange(t.num_leaves, dtype=np.float64)
        score = torch.zeros((len(X), 1), device=dev)
        walk_tree.predict_binned_add(score, 0, bins)
        diff = score[:, 0].long().cpu().numpy() != leaves[:, j]
        bad += int((diff & ~edge).sum())
        edge_diff += int((diff & edge).sum())
    print(f"[categorical {label}] pred_leaf of {len(X)} raw rows against "
          f"the bin walk, {len(bst.models)} trees: {bad} differences off "
          f"the edge; {int(edge.sum())} rows with a categorical bin >= "
          f"256, {edge_diff} (row, tree) differences there")
    if bad:
        fail(f"categorical {label}: pred_leaf and the bin walk differ")


def categorical_parity(dev):
    """Kernels against plain versions at 100k rows, ``CUT_PARITY_LEAVES``
    leaves, ``PARITY_ITERS`` iterations, max_bin 255 (max_cat_to_onehot
    8) and 1023: the same trees, leaf values and valid histories to the
    bit."""
    import torch
    import lightgbm_tpu_torch as lt
    X, y = airline_like(100_000, seed=3)
    Xv, yv = airline_like(20_000, seed=4)
    for max_bin, extra in ((255, {"max_cat_to_onehot": 8}), (1023, {})):
        t0 = time.perf_counter()
        params = dict({"objective": "binary",
                       "num_leaves": CUT_PARITY_LEAVES,
                       "learning_rate": 0.1, "max_bin": max_bin,
                       "metric": "auc,binary_logloss", "verbosity": -1},
                      **extra)
        res = {}
        for ops in ("kernel", "plain"):
            tr = lt.Dataset(X, label=y, categorical_feature=AIRLINE_CATEGORICAL)
            hist = {}
            b = lt.train(params, tr, PARITY_ITERS,
                         valid_sets=[tr.create_valid(Xv, label=yv)],
                         valid_names=["valid"], evals_result=hist,
                         verbose_eval=False, device=dev, ops=ops)
            res[ops] = (b, hist["valid"])
        (kb, kh), (pb, ph) = res["kernel"], res["plain"]
        same = len(kb.models) == len(pb.models) == PARITY_ITERS and all(
            tree_sig(a) == tree_sig(c) for a, c in zip(kb.models, pb.models))
        diff = max(float(np.abs(a.leaf_value - c.leaf_value).max())
                   for a, c in zip(kb.models, pb.models))
        cat_nodes = sum(int(((t.decision_type[:t.num_leaves - 1] & 1) > 0).sum())
                     for t in kb.models)
        print(f"[categorical parity] 100000 x 8, max_bin {max_bin} "
              f"{extra}, {type(kb._gbdt.learner).__name__}: structure "
              f"equal {same}, max leaf value diff {diff:.3g}, valid "
              f"histories equal {kh == ph}, {cat_nodes} categorical nodes in "
              f"{time.perf_counter() - t0:.1f} s")
        if not same or diff != 0 or kh != ph or not cat_nodes:
            fail(f"categorical kernel and plain runs differ at max_bin "
                 f"{max_bin}")
        del kb, pb, res
        torch.cuda.empty_cache()


def categorical_phase(n, iters, dev):
    """Phase 11: runs a (max_bin 255) and b (1023) at n x 8 with a
    500k-row valid set, their gates, the no-categorical AUC gate and the
    kernel-against-plain parity. Returns the runs' numbers."""
    import torch
    import lightgbm_tpu_torch as lt
    t0 = time.perf_counter()
    X, y = airline_like(n, seed=42)
    Xv, yv = airline_like(500_000, seed=43)
    print(f"[categorical] {n} x 8 airline-shaped rows, {y.mean():.3f} "
          f"positive, valid 500000 rows in {time.perf_counter() - t0:.1f} s")
    out = {}
    for run, max_bin in (("a", 255), ("b", 1023)):
        t0 = time.perf_counter()
        params = {"objective": "binary", "num_leaves": 255,
                  "learning_rate": 0.1, "max_bin": max_bin,
                  "metric": "auc,binary_logloss", "verbosity": -1}
        tr = lt.Dataset(X, label=y, categorical_feature=AIRLINE_CATEGORICAL)
        va = tr.create_valid(Xv, label=yv)
        binned = tr._construct(lt.Config.from_params(params))
        va._construct(lt.Config.from_params(params))     # outside the run
        nb = [int(binned.feature_mapper(i).num_bin)
              for i in range(binned.num_features)]
        print(f"[categorical {run}] max_bin {max_bin}: bins per column "
              f"{nb}, binned in {time.perf_counter() - t0:.1f} s")
        bst, info, _ = categorical_run(f"{run} max_bin {max_bin}", params,
                                       tr, va, iters, dev)
        if run == "a":
            t0 = time.perf_counter()
            info.update(categorical_profile(
                f"{run} max_bin {max_bin}",
                dict(params, num_leaves=CATEGORICAL_PROFILE_LEAVES), tr, dev))
            print(f"[categorical a] profiled tree in "
                  f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        wide = [binned.used_feature_map[c] for c in AIRLINE_CATEGORICAL
                if binned.bin_mappers[c].num_bin > 256]
        leaf_walk_check(f"{run} max_bin {max_bin}", bst, X, binned, dev,
                        wide)
        print(f"[categorical {run}] pred_leaf check in "
              f"{time.perf_counter() - t0:.1f} s")
        out[run] = info
        if run == "a":
            hist = {}
            t0 = time.perf_counter()
            nc = lt.Dataset(X, label=y)
            lt.train(params, nc, iters,
                     valid_sets=[nc.create_valid(Xv, label=yv)],
                     valid_names=["valid"], evals_result=hist,
                     verbose_eval=False, device=dev)
            out["a_no_categorical_auc"] = hist["valid"]["auc"][-1]
            print(f"[categorical a] the same data with no categorical "
                  f"feature: valid auc {out['a_no_categorical_auc']:.6f} "
                  f"against {info['valid_auc']:.6f} "
                  f"({time.perf_counter() - t0:.1f} s)")
            if not info["valid_auc"] > out["a_no_categorical_auc"]:
                fail("categorical treatment did not beat numerical "
                     "treatment in valid AUC")
            del nc
        del bst, tr, va, binned
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    categorical_parity(dev)
    print(f"[categorical parity] done in {time.perf_counter() - t0:.1f} s")
    return out


# ---- phase 12: EFB, multi-val, sparse input, two-round loading --------
# the categories of airline_like's six categorical columns
EXPO_CARDS = {0: 12, 1: 31, 2: 7, 4: 22, 5: 300, 6: 300}
EFB_PATH = {("SerialTreeLearner", False): ("hist_rows", "split_scan"),
            ("SerialTreeLearner", True): ("hist_rows", "split_scan",
                                          "fused_split_step_leaf"),
            ("PartitionedTreeLearner", False): ("hist_segment",
                                                "partition_segment",
                                                "split_scan"),
            ("PartitionedTreeLearner", True): ("hist_segment", "split_scan",
                                               "fused_split_step_segment")}


def expo_one_hot(n, seed, airports=True):
    """The Expo data as the reference's 700-feature run feeds it:
    ``airline_like`` with its categorical columns one-hot (Month 12,
    DayofMonth 31, DayOfWeek 7, UniqueCarrier 22, Origin 300, Dest 300:
    672 columns) and CRSDepTime and Distance beside them, 8 stored
    entries a row, as a scipy CSR matrix. ``airports=False`` keeps Origin
    and Dest as numeric id columns (76 columns). Returns (csr, y)."""
    import scipy.sparse as sp
    X, y = airline_like(n, seed)
    cats = [c for c in AIRLINE_CATEGORICAL if airports or c not in (5, 6)]
    numeric = [3, 7] if airports else [3, 5, 6, 7]
    k = len(cats) + len(numeric)
    idx = np.empty((n, k), np.int64)
    val = np.ones((n, k))
    off = 0
    for j, c in enumerate(cats):
        idx[:, j] = off + X[:, c].astype(np.int64)
        off += EXPO_CARDS[c]
    for j, c in enumerate(numeric):
        idx[:, len(cats) + j] = off + j
        val[:, len(cats) + j] = X[:, c]
    csr = sp.csr_matrix((val.ravel(), idx.ravel(),
                         np.arange(0, k * n + 1, k)),
                        shape=(n, off + len(numeric)))
    return csr, y


def bosch_like(n, f=968, density=0.15, seed=44):
    """A Bosch-shaped matrix (the reference's Bosch GPU run: 968 numeric
    columns, mostly empty), generated column by column as CSC, never
    dense: ~``density`` of the cells stored at random positions, values
    positive measurements (two decimals, so a column's default and most
    frequent bin is its zero), the label ~0.6% positive, logistic in five
    columns. Returns (csc, y)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    indptr = np.zeros(f + 1, np.int64)
    rows, vals = [], []
    for j in range(f):
        r = np.flatnonzero(rng.random(n, dtype=np.float32)
                           < density).astype(np.int32)
        rows.append(r)
        vals.append(np.round(rng.gamma(2.0, 0.5, len(r)), 2) + 0.01)
        indptr[j + 1] = indptr[j] + len(r)
    csc = sp.csc_matrix((np.concatenate(vals), np.concatenate(rows),
                         indptr), shape=(n, f))
    logit = -5.5 + sum(w * csc[:, j].toarray()[:, 0] for j, w in
                       enumerate((0.9, -0.7, 0.6, 0.5, -0.4)))
    y = (logit + rng.logistic(size=n) > 0).astype(np.float32)
    return csc, y


def describe_plan(label, ds):
    """Print a binned dataset's EFB plan: dense groups and their bins,
    multi-val pseudo-groups and the slot width."""
    g_dense, g_all = ds.num_dense_groups, ds.num_groups
    bins = [int(b) for b in ds.group_num_bins[:g_dense]] \
        if ds.is_bundled else []
    k = ds.mv_slots.shape[1] if ds.has_multival else 0
    print(f"[efb {label}] {ds.num_data} rows, {ds.num_total_features} "
          f"columns ({ds.num_features} used): {g_dense} dense groups "
          f"{bins if len(bins) <= 16 else bins[:16] + ['...']} "
          f"({ds.binned.dtype}, {ds.binned.nbytes / 1e6:.1f} MB), "
          f"{g_all - g_dense} multi-val pseudo-groups, slots K {k}"
          + (f" ({ds.mv_slots.nbytes / 1e9:.2f} GB)" if k else ""))
    return dict(features=ds.num_features, dense_groups=g_dense,
                mv_groups=g_all - g_dense, slots_k=k,
                group_bins_max=max(bins, default=0))


def efb_run(label, params, tr, va, iters, dev, want_learner):
    """One phase-12 run through ``lt.train`` with its valid set (auc
    every iteration), the launch counts set to 0 just before it and read
    just after, CUDA events around every debundle
    (``debundle_leaf_hists``: the root, or both children of a split)
    and multi-val histogram. Returns the
    booster and its numbers."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.learner import partitioned as lp
    from lightgbm_tpu_torch.learner import serial as ls
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.ops import hist_multival_cuda as hmc
    deb, mvh = DeviceTimer(), DeviceTimer()
    saved = (lp.debundle_leaf_hists, ls.hist_multival, hmc.hist_multival)
    lp.debundle_leaf_hists = deb.wrap(saved[0])
    ls.hist_multival = hmc.hist_multival = mvh.wrap(saved[1])
    hist = {}
    try:
        _native.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lt.train(params, tr, iters, valid_sets=[va],
                       valid_names=["valid"], evals_result=hist,
                       verbose_eval=False, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        lp.debundle_leaf_hists, ls.hist_multival, hmc.hist_multival = saved
    launches = dict(_native.LAUNCHES)
    lut = _native.ROUTE_LAUNCHES["partition_segment_lut"]
    lrn = bst._gbdt.learner
    td = bst._gbdt.train_data
    splits = sum(t.num_leaves - 1 for t in bst.models)
    bundled_nodes = sum(int((td.feature_offset[
        t.split_feature_inner[:t.num_leaves - 1]] > 0).sum())
        for t in bst.models) if td.is_bundled else 0
    ms_split = wall / max(splits, 1) * 1e3
    deb_ms = deb.ms() / max(splits, 1)
    mv_calls = len(mvh.pairs)
    info = dict(learner=type(lrn).__name__, fused=lrn.fused,
                num_bins_max=lrn.num_bins_max, wall_s=wall,
                trees=len(bst.models), splits=splits,
                bundled_splits=bundled_nodes, ms_per_split=ms_split,
                debundle_ms_per_split=deb_ms,
                debundle_share=deb_ms / ms_split,
                hist_multival_calls=mv_calls,
                hist_multival_ms_per_call=mvh.ms() / mv_calls
                if mv_calls else None,
                launches=launches, lut_launches=lut,
                valid_auc=hist["valid"]["auc"][-1])
    print(f"[efb {label}] {info['learner']} (fused {lrn.fused}), "
          f"num_bins_max {lrn.num_bins_max}: {len(bst.models)} trees, "
          f"{splits} splits ({bundled_nodes} on bundled features) in "
          f"{wall:.2f} s = {ms_split:.4f} ms/split; debundle "
          f"{deb_ms:.4f} ms a split ({info['debundle_share']:.1%}, CUDA "
          f"events); hist_multival {mv_calls} calls"
          + (f", {info['hist_multival_ms_per_call']:.3f} ms a call"
             if mv_calls else "")
          + f"; launches {launches}, LUT route {lut}; valid auc "
          f"{[round(v, 6) for v in hist['valid']['auc']]}")
    if info["learner"] != want_learner:
        fail(f"efb run {label} trained on {info['learner']}, expected "
             f"{want_learner}")
    for name in EFB_PATH[want_learner, bool(lrn.fused)] + (
            ("hist_multival",) if td.has_multival else ()):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by efb run {label}")
    if td.is_bundled:
        if lrn.fused:
            fail(f"efb run {label}: a bundled dataset took the fused path")
        if want_learner == "PartitionedTreeLearner" \
                and lut != bundled_nodes:
            fail(f"efb run {label}: {lut} LUT-route partitions for "
                 f"{bundled_nodes} bundled splits")
    if not np.isfinite(hist["valid"]["auc"]).all():
        fail(f"efb run {label}: valid auc not finite")
    return bst, info


def efb_pair(label, params, data, y, vdata, vy, iters, dev,
             profile=False, keep=False, ref_rows=None):
    """A dataset trained bundled (EFB on, the default) and with
    ``enable_bundle=false``, each with its valid set: plan, runs, and
    the bundled run's profiled tree. ``keep`` returns the bundled binned
    dataset beside the numbers; ``ref_rows`` trains the unbundled
    reference on the first that many rows."""
    import torch
    import lightgbm_tpu_torch as lt
    out = {}
    for mode, extra in (("bundled", {}), ("unbundled",
                                          {"enable_bundle": False})):
        p = dict(params, **extra)
        t0 = time.perf_counter()
        if mode == "unbundled" and ref_rows is not None:
            data, y = data[:ref_rows], y[:ref_rows]
        tr = lt.Dataset(data, label=y)
        va = tr.create_valid(vdata, label=vy)
        ds = tr._construct(lt.Config.from_params(p))
        va._construct(lt.Config.from_params(p))     # outside the run
        plan = describe_plan(f"{label} {mode}", ds)
        plan["bin_s"] = time.perf_counter() - t0
        print(f"[efb {label} {mode}] binned (train and valid) in "
              f"{plan['bin_s']:.1f} s")
        # the learner rule (parallel/learners.py): multi-val pins the
        # serial learner, as do bins wider than a byte
        want = "SerialTreeLearner" if ds.has_multival or int(
            ds.num_bins_array().max()) > 256 else "PartitionedTreeLearner"
        bst, info = efb_run(f"{label} {mode}", p, tr, va, iters, dev, want)
        info["plan"] = plan
        if profile and mode == "bundled":
            info.update(categorical_profile(f"{label} {mode}", p, tr, dev,
                                            tag="efb"))
        out[mode] = info
        if keep and mode == "bundled":
            kept = ds
        del bst, tr, va, ds
        torch.cuda.empty_cache()
    b, u = out["bundled"], out["unbundled"]
    u["rows"] = len(y)
    print(f"[efb {label}] bundled {b['ms_per_split']:.4f} ms/split "
          f"({b['learner']}, fused {b['fused']}), auc "
          f"{b['valid_auc']:.6f}; unbundled {u['ms_per_split']:.4f} "
          f"ms/split ({u['learner']}, fused {u['fused']}) on {len(y)} "
          f"rows, auc {u['valid_auc']:.6f}")
    return (out, kept) if keep else out


def multival_bytes(lay, ids, b: int) -> int:
    """The bytes the multi-val histogram must move over the compact
    layout ``lay``: each real slot of the listed rows once (2 B), each
    listed row's ghc (12 B), one offset (8 B) and, with a row list
    ``ids``, its id (4 B) once, and the [G_mv, B, 3] f32 histogram
    written once."""
    real = lay.k - lay.npad.long()
    if ids is None:
        rows, entries = lay.n, int(real.sum())
    else:
        rows, entries = ids.numel(), int(real[ids.long()].sum())
    return entries * 2 + rows * (12 + 8 + (0 if ids is None else 4)) \
        + lay.g_mv * b * 3 * 4


def check_hist_multival(ds, dev, reps):
    """The multi-val histogram kernel against its plain version on a
    multi-val dataset's slots over all rows (the serial learner's root)
    and a random third of them in row order (a per-phase child): max
    abs err 0, bitwise repeatable, and within one float32 rounding of a
    float64 ``index_add_`` over the raw slots (which does not read the
    compact layout). Timed beside its plain version, its byte bound
    (``multival_bytes``) and that ``index_add_`` (the same sums in
    atomic order); the compact layout's build (once a dataset, at
    learner setup) timed apart. The record's numbers are the root's."""
    import torch
    from lightgbm_tpu_torch.ops import hist_multival_cuda as hm
    slots = ds.mv_slots_device(dev)
    n, k = slots.shape
    g_mv = ds.num_groups - ds.num_dense_groups
    b = int(max(ds.num_bins_array().max(), ds.group_num_bins.max()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lay = hm.MultivalLayout(slots, g_mv)
    torch.cuda.synchronize()
    layout_ms = (time.perf_counter() - t0) * 1e3
    gen = torch.Generator(device=dev).manual_seed(12)
    ghc = torch.stack([torch.randn(n, generator=gen, device=dev),
                       torch.rand(n, generator=gen, device=dev) * 0.25,
                       torch.ones(n, device=dev)], 1).contiguous()
    third = torch.nonzero(torch.rand(n, generator=gen, device=dev)
                          < 1 / 3).flatten().to(torch.int32)
    partial = hm.multival_partial(g_mv, b, dev)
    cases, worst = {}, 0.0
    for mode, ids in (("all rows", None), ("a third", third)):
        out = hm.hist_multival(lay, ghc, b, ids, partial=partial)
        again = hm.hist_multival(lay, ghc, b, ids, partial=partial)
        ref = hm.hist_multival_plain(lay, ghc, b, ids)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        worst = max(worst, err)
        if not torch.equal(out, again):
            fail(f"hist_multival ({mode}) not bitwise repeatable")
        if err != 0.0:
            fail(f"hist_multival ({mode}) off its plain version by {err}")
        ms = time_ms(lambda: hm.hist_multival(lay, ghc, b, ids,
                                              partial=partial), reps)
        # None: the profiler lost some of its main kernel's records (it
        # loses records late in a long script), not measured
        dev_ms = device_us(lambda: hm.hist_multival(
            lay, ghc, b, ids, partial=partial), reps, ("hist_multival",),
            need=("hist_multival_kernel",)) / 1e3 or None
        plain_ms = time_ms(lambda: hm.hist_multival_plain(
            lay, ghc, b, ids), 3)
        rows = n if ids is None else ids.numel()
        sel = torch.arange(n, device=dev) if ids is None else ids.long()
        keys = slots.index_select(0, sel).reshape(-1).long()
        vals = ghc.index_select(0, sel).double().repeat_interleave(k, 0)
        lib_out = torch.zeros((g_mv * 256, 3), dtype=torch.float64,
                              device=dev)
        # the raw slots' sums, independent of the layout: within one
        # float32 rounding (rtol 2^-23) of the kernel, atol 1e-9 for the
        # float64 sums' order
        lib_out.index_add_(0, keys, vals)
        lib = lib_out.view(g_mv, 256, 3)[:, :b].float().double()
        if not torch.allclose(out.double(), lib, rtol=2.0 ** -23,
                              atol=1e-9):
            fail(f"hist_multival ({mode}) off the raw slots' index_add_ "
                 f"by {float((out.double() - lib).abs().max())}")
        del lib
        library_ms = time_ms(lambda: lib_out.index_add_(0, keys, vals),
                             reps)
        del keys, vals
        nbytes = multival_bytes(lay, ids, b)
        cases[mode] = dict(rows=rows, ms=ms, device_ms=dev_ms,
                           plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                           chunks=hm.child_chunks(rows, g_mv),
                           windows=lay.windows)
    main = cases["all rows"]
    print(f"[check] hist_multival layout: {lay.ent.numel()} real slots of "
          f"{n * k} ({lay.ent.numel() / max(n, 1):.1f} a row), "
          f"{lay.windows} windows, built in {layout_ms:.1f} ms")
    print("[check] hist_multival ok: " + "; ".join(
        f"{m}: {c['ms']:.4f} ms, device {c['device_ms'] or 'not measured'}"
        f" ({c['rows']} "
        f"rows x K {k}, G_mv {g_mv}, {c['chunks']} chunks x "
        f"{c['windows']} windows; plain {c['plain_ms']:.3f}, float64 "
        f"index_add_ {c['library_ms']:.3f}, bound {c['bound_ms']:.4f})"
        for m, c in cases.items()))
    return dict(max_abs_err=worst, ms=main["ms"],
                device_ms=main["device_ms"], plain_ms=main["plain_ms"],
                library_ms=main["library_ms"], bound_ms=main["bound_ms"],
                bound_by="bytes", cases=cases, layout_ms=layout_ms)


def write_libsvm_csr(path, csr, y):
    """A CSR matrix as LibSVM text, one row a line (``%.17g`` values)."""
    with open(path, "w") as fh:
        for i in range(csr.shape[0]):
            lo, hi = csr.indptr[i], csr.indptr[i + 1]
            fh.write(f"{y[i]:.17g} " + " ".join(
                f"{j}:{v:.17g}" for j, v in zip(csr.indices[lo:hi],
                                                csr.data[lo:hi])) + "\n")


def two_round_check(csr, y, dev):
    """(d): the first rows of (a) as LibSVM, loaded in memory and with
    two_round: the binned matrices and slots byte for byte, the same
    trees (3 iterations, 63 leaves, on the card)."""
    import os
    import tempfile
    import lightgbm_tpu_torch as lt
    params = {"objective": "binary", "num_leaves": 63, "max_bin": 255,
              "learning_rate": 0.1, "verbosity": -1}
    out, res = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.svm")
        t0 = time.perf_counter()
        write_libsvm_csr(path, csr, y)
        print(f"[efb d] {csr.shape[0]} rows written as LibSVM "
              f"({os.path.getsize(path) / 1e6:.1f} MB) in "
              f"{time.perf_counter() - t0:.1f} s")
        for mode in ("in memory", "two_round"):
            p = dict(params, two_round=mode == "two_round")
            t0 = time.perf_counter()
            ds = lt.Dataset(path)
            binned = ds._construct(lt.Config.from_params(p))
            out[f"{mode}_load_s"] = time.perf_counter() - t0
            res[mode] = (binned, lt.train(p, ds, 3, device=dev))
            print(f"[efb d] {mode}: loaded and binned in "
                  f"{out[f'{mode}_load_s']:.1f} s, {binned.binned.shape} "
                  f"{binned.binned.dtype}, multi-val {binned.has_multival}")
    (a, ba), (b, bb) = res["in memory"], res["two_round"]
    same = a.binned.dtype == b.binned.dtype \
        and np.array_equal(a.binned, b.binned) \
        and (a.mv_slots is None) == (b.mv_slots is None) \
        and (a.mv_slots is None or np.array_equal(a.mv_slots, b.mv_slots)) \
        and np.array_equal(a.metadata.label, b.metadata.label)
    trees = len(ba.models) == len(bb.models) and all(
        tree_sig(s) == tree_sig(t) and np.array_equal(s.leaf_value,
                                                      t.leaf_value)
        for s, t in zip(ba.models, bb.models))
    print(f"[efb d] two_round against in memory: matrices equal {same}, "
          f"trees and leaf values equal {trees}")
    if not same or not trees:
        fail("two_round loading differs from in-memory loading")
    return out


def efb_parity(dev, expo, expo_num, bosch):
    """(e): kernels against plain versions at 100k rows,
    ``CUT_PARITY_LEAVES`` leaves, ``PARITY_ITERS`` iterations, for (a),
    (a'), (b) and (c): the same trees and leaf values to the bit. Each
    dataset is binned once for both runs (PR 24; each run uploads the
    bins itself)."""
    import torch
    import lightgbm_tpu_torch as lt
    runs = (("a", expo, 255), ("a'", expo_num, 255), ("b", expo, 1023),
            ("c", bosch, 63))
    for label, (data, y), max_bin in runs:
        t0 = time.perf_counter()
        params = {"objective": "binary", "num_leaves": CUT_PARITY_LEAVES,
                  "learning_rate": 0.1, "max_bin": max_bin,
                  "verbosity": -1}
        if label == "c":
            params.update(learning_rate=0.015, min_sum_hessian_in_leaf=5)
        binned = lt.Dataset(data, label=y)._construct(
            lt.Config.from_params(params))
        res = {}
        for ops in ("kernel", "plain"):
            ds = over_binned(binned, data, y)
            ds._binned._device_copies = {}
            res[ops] = lt.train(params, ds, PARITY_ITERS, device=dev,
                                ops=ops)
        kb, pb = res["kernel"], res["plain"]
        same = len(kb.models) == len(pb.models) == PARITY_ITERS and all(
            tree_sig(a) == tree_sig(c) for a, c in zip(kb.models, pb.models))
        diff = max(float(np.abs(a.leaf_value - c.leaf_value).max())
                   for a, c in zip(kb.models, pb.models))
        td = kb._gbdt.train_data
        print(f"[efb parity] {label}: {data.shape[0]} x {data.shape[1]}, "
              f"max_bin {max_bin}, {type(kb._gbdt.learner).__name__} "
              f"(bundled {td.is_bundled}, multi-val {td.has_multival}): "
              f"structure equal {same}, max leaf value diff {diff:.3g} in "
              f"{time.perf_counter() - t0:.1f} s")
        if not same or diff != 0:
            fail(f"efb kernel and plain runs differ ({label})")
        del kb, pb, res
        torch.cuda.empty_cache()


def efb_phase(n, iters, dev, reps, bosch_rows=1_000_000):
    """Phase 12: (a) Expo one-hot at max_bin 255, (a') with the airports
    as numeric columns (the partitioned learner on bundles), (b) (a) at
    max_bin 1023, (c) Bosch-shaped multi-val, each bundled and with
    ``enable_bundle=false``; (d) two-round loading; (e) kernels against
    plain versions and the multi-val histogram's check. Returns the
    runs' numbers and the multi-val histogram's record."""
    import torch
    from lightgbm_tpu_torch.ops import _native
    out = {}
    t0 = time.perf_counter()
    expo, y = expo_one_hot(n, 42)
    expo_v, yv = expo_one_hot(500_000, 43)
    print(f"[efb] Expo one-hot {expo.shape[0]} x {expo.shape[1]} CSR "
          f"({expo.nnz} stored, {y.mean():.3f} positive), valid "
          f"{expo_v.shape[0]} rows, in {time.perf_counter() - t0:.1f} s")
    base = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
            "metric": "auc", "verbosity": -1}
    out["a"] = efb_pair("a max_bin 255", dict(base, max_bin=255), expo, y,
                        expo_v, yv, iters, dev, profile=True)
    num, ynum = expo_one_hot(n, 42, airports=False)
    num_v, ynum_v = expo_one_hot(500_000, 43, airports=False)
    out["a'"] = efb_pair("a' airports numeric", dict(base, max_bin=255),
                         num, ynum, num_v, ynum_v, iters, dev,
                         profile=True)
    del num, num_v
    out["b"] = efb_pair("b max_bin 1023", dict(base, max_bin=1023), expo, y,
                        expo_v, yv, iters, dev)
    t0 = time.perf_counter()
    out["d"] = two_round_check(expo[:100_000], y[:100_000], dev)
    print(f"[efb d] done in {time.perf_counter() - t0:.1f} s")
    del expo_v
    t0 = time.perf_counter()
    bosch, yb = bosch_like(bosch_rows)
    bosch_v, ybv = bosch_like(200_000, seed=45)
    print(f"[efb] Bosch-shaped {bosch.shape[0]} x {bosch.shape[1]} CSC "
          f"({bosch.nnz} stored, {bosch.nnz / np.prod(bosch.shape):.3f} "
          f"density, {yb.mean():.4f} positive), valid "
          f"{bosch_v.shape[0]} rows, in {time.perf_counter() - t0:.1f} s")
    cparams = dict(base, max_bin=63, learning_rate=0.015,
                   min_sum_hessian_in_leaf=5)
    out["c"], cds = efb_pair("c bosch", cparams, bosch, yb, bosch_v, ybv,
                             iters, dev, profile=True, keep=True,
                             ref_rows=BOSCH_REF_ROWS)
    if not out["c"]["bundled"]["plan"]["mv_groups"]:
        fail("the Bosch-shaped plan did not go multi-val")
    launches = out["c"]["bundled"]["launches"]["hist_multival"]
    del bosch_v
    torch.cuda.empty_cache()
    # the multi-val histogram against its plain version on (c)'s slots
    t0 = time.perf_counter()
    rec = check_hist_multival(cds, dev, reps)
    print(f"[check] hist_multival in {time.perf_counter() - t0:.1f} s")
    del cds
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    efb_parity(dev, (expo[:100_000], y[:100_000]),
               expo_one_hot(100_000, 3, airports=False),
               (bosch[:100_000], yb[:100_000]))
    print(f"[efb parity] done in {time.perf_counter() - t0:.1f} s")
    _native.reset_launch_counts()
    return out, rec, launches


# ---- 13. the rest of tree growing and linear leaves --------------------

PER_PHASE_PATH = {"PartitionedTreeLearner": ("hist_segment",
                                             "partition_segment",
                                             "split_scan"),
                  "SerialTreeLearner": ("hist_rows", "split_scan")}
FUSED_PATH = {"PartitionedTreeLearner": FUSED_SEGMENT_PATH,
              "SerialTreeLearner": ("hist_rows", "split_scan",
                                    "fused_split_step_leaf")}


def forced_json(path, X):
    """Phase 13 d's plan: 3 levels, 7 splits on features 0-3 at their
    medians, breadth first f0; f1, f2; f3, f2, f1, f3."""
    med = [float(np.nanmedian(X[:, f])) for f in range(4)]

    def nd(f, left=None, right=None):
        out = {"feature": f, "threshold": med[f]}
        if left is not None:
            out.update(left=left, right=right)
        return out
    plan = nd(0, nd(1, nd(3), nd(2)), nd(2, nd(1), nd(3)))
    with open(path, "w") as fh:
        json.dump(plan, fh)


def with_raw(binned, X, label=None):
    """A binned dataset that also holds its raw values (what
    ``linear_tree`` keeps), over the same bins."""
    import copy
    out = copy.copy(binned)
    out._device_copies = dict(binned._device_copies)
    out.raw_numeric = np.ascontiguousarray(
        X[:, binned.real_feature_idx], np.float32)
    return out


def scan_us_in_training(bst):
    """The scan kernel's mean device us a launch over one more tree of
    ``bst`` (profiler, merged intervals) and the launches of that tree."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lightgbm_tpu_torch.ops import _native
    before = _native.LAUNCHES["split_scan"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bst.update()
        torch.cuda.synchronize()
    calls = _native.LAUNCHES["split_scan"] - before
    iv = [(e.time_range.start, e.time_range.end) for e in prof.events()
          if e.device_type == DeviceType.CUDA
          and "split_scan_kernel" in e.name]
    if not iv:
        return None, calls
    return merged_us(iv) / max(len(iv), 1), calls


def extras_run(label, params, tr, va, iters, dev, want):
    """One phase-13 run through ``lt.train`` with a 500k-row valid set
    (auc), the launch counts set to 0 just before it and read just
    after: the learner must be ``want`` and every kernel of its grow
    path must have run."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    hist = {}
    _native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lt.train(dict(params, metric="auc"), tr, iters, valid_sets=[va],
                   valid_names=["valid"],
                   callbacks=[lt.record_evaluation(hist)],
                   verbose_eval=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    lrn = bst._gbdt.learner
    name = type(lrn).__name__
    splits = sum(t.num_leaves - 1 for t in bst.models)
    info = dict(learner=name, fused=bool(lrn.fused), trees=len(bst.models),
                splits=splits, wall_s=wall,
                ms_per_split=wall / max(splits, 1) * 1e3,
                auc=float(hist["valid"]["auc"][-1]), launches=launches)
    print(f"[extras {label}] {name}, {'fused' if lrn.fused else 'per-phase'}"
          f", {len(bst.models)} trees, {splits} splits in {wall:.2f} s = "
          f"{info['ms_per_split']:.4f} ms/split; valid auc "
          f"{info['auc']:.6f}; launches {launches}")
    if name != want:
        fail(f"phase 13 {label} trained on {name}, not {want}")
    path = (FUSED_PATH if lrn.fused else PER_PHASE_PATH)[name]
    for k in path:
        if not launches.get(k):
            fail(f"kernel {k} was not launched by phase 13 {label}")
    if splits == 0:
        fail(f"phase 13 {label} grew no split")
    return bst, info


def same_or_tie(label, a_models, b_models):
    """Tree by tree (``b_models`` may hold more trees: its first ones
    count), the same structure, or the first difference at a near tie
    (gains within 1e-5 relative: float association picks another of two
    near-equal candidates); returns (trees equal, max leaf value diff over the
    equal trees, the tie or None)."""
    equal, diff = 0, 0.0
    if len(a_models) > len(b_models):
        fail(f"{label}: {len(a_models)} trees against {len(b_models)}")
    for i, (a, b) in enumerate(zip(a_models, b_models)):
        if tree_sig(a) == tree_sig(b):
            equal += 1
            diff = max(diff, float(np.abs(a.leaf_value
                                          - b.leaf_value).max()))
            continue
        s = first_divergence(a, b)
        ga, gb = float(a.split_gain[s]), float(b.split_gain[s])
        tie = abs(ga - gb) <= 1e-5 * abs(gb)
        if not tie:
            fail(f"{label}: tree {i} differs at node {s} (gains {ga!r}, "
                 f"{gb!r})")
        return equal, diff, (i, s, ga, gb)
    return equal, diff, None


def check_scan_node(dev, reps):
    """The scan kernel with a node table (rand bins and node masks)
    against its plain version with the same rows, bitwise, at B 255 and
    1023, K 1 and 2; its time with and without the table."""
    import torch
    from lightgbm_tpu_torch.ops import split as sp
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    from lightgbm_tpu_torch.ops.histogram import build_histogram
    n, f = 200_000, F
    out = {}
    for b in (255, 1023):
        g = torch.Generator(device=dev).manual_seed(b)
        bins = torch.randint(0, b, (n, f), generator=g, device=dev)
        ghc = torch.stack([torch.randn(n, generator=g, device=dev)
                           + (bins[:, 0] > b // 2).float(),
                           torch.rand(n, generator=g, device=dev) + 0.1,
                           torch.ones(n, device=dev)], dim=1)
        hists = [build_histogram(bins[:n // 3], ghc[:n // 3], b),
                 build_histogram(bins[n // 3:], ghc[n // 3:], b)]
        leaves = [tuple(h[0].sum(0).cpu().numpy()) + (-np.inf, np.inf)
                  for h in hists]
        meta = sp.FeatureMeta(
            num_bins=np.full(f, b, np.int32),
            missing=(np.arange(f) % 3).astype(np.int32),
            default_bin=np.full(f, b // 3, np.int32),
            most_freq_bin=np.zeros(f, np.int32),
            monotone=np.zeros(f, np.int32), penalty=np.ones(f, np.float32),
            is_categorical=np.zeros(f, bool))
        meta_t = sp.meta_tensors(meta, dev)
        tables = sc.scan_meta_tables(meta_t)
        params = sp.SplitParams(0.0, 1.0, 0.0, 20.0, 1e-3, 0.0, True)
        rng = np.random.RandomState(b)
        rb = rng.randint(0, b - 2, (5, f))
        rb[1] = -1                      # a row of every threshold
        nm = rng.rand(5, f) < 0.6
        for rbs, nms in ((rb, None), (None, nm), (rb, nm)):
            node = sc.node_table(rbs, nms, f, dev)
            for k, salts in ((1, (3,)), (2, (2, 4)), (2, (1, 0))):
                kk = sc.per_feature_numerical_cuda(
                    hists[:k], leaves[:k], meta_t, params, tables,
                    node=node, salts=salts)
                pp = sc.per_feature_numerical_plain(
                    hists[:k], leaves[:k], meta_t, params, node, salts)
                if kk.cpu().numpy().tobytes() != pp.cpu().numpy().tobytes():
                    fail(f"scan with a node table ({b} bins, K {k}) "
                         "differs from its plain version")
        node = sc.node_table(rb, nm, f, dev)
        with_t = time_ms(lambda: sc.per_feature_numerical_cuda(
            hists, leaves, meta_t, params, tables, node=node,
            salts=(2, 4)), reps)
        without = time_ms(lambda: sc.per_feature_numerical_cuda(
            hists, leaves, meta_t, params, tables), reps)
        out[b] = dict(max_abs_err=0.0, ms=with_t, ms_without=without)
    return out


def extras_parity(dev, forced_path):
    """Phase 13 g: kernels against plain versions at 100k x 28,
    ``CUT_PARITY_LEAVES`` leaves (cut from 63), ``PARITY_ITERS``
    iterations, for each option of a-f, the two runs on one binning (each
    uploading it itself): the same trees, leaf values and linear
    coefficients to the bit."""
    import lightgbm_tpu_torch as lt
    Xp, yp = higgs_like(100_000, seed=3)
    forced_json(forced_path, Xp)
    base = {"objective": "binary", "num_leaves": CUT_PARITY_LEAVES,
            "learning_rate": 0.1, "verbosity": -1}
    slot = F * 256 * 12
    runs = [("a extra 255", {"extra_trees": True, "max_bin": 255}),
            ("a extra 1023", {"extra_trees": True, "max_bin": 1023}),
            ("b bynode", {"feature_fraction": 0.8,
                          "feature_fraction_bynode": 0.5}),
            ("c cegb", dict(CEGB_COUPLED)),
            ("c lazy", dict(CEGB_LAZY)),
            ("d forced", {"forcedsplits_filename": forced_path}),
            ("e pool", {"histogram_pool_size": 8.5 * slot / 2 ** 20}),
            ("e rebuild 1023", {"histogram_pool_size": 1.5 * 4 * slot
                                / 2 ** 20, "max_bin": 1023}),
            ("f linear", {"linear_tree": True, "linear_max_features": 8})]
    out = {}
    for label, extra in runs:
        t0 = time.perf_counter()
        pp = dict(base, **extra)
        binned = lt.Dataset(Xp, label=yp)._construct(
            lt.Config.from_params(pp))
        runs_ = {}
        for ops in ("kernel", "plain"):
            ds = over_binned(binned, Xp, yp)
            ds._binned._device_copies = {}
            runs_[ops] = lt.train(pp, ds, PARITY_ITERS, device=dev,
                                  ops=ops)
        kb, pb = runs_["kernel"], runs_["plain"]
        same = [tree_sig(a) == tree_sig(b) for a, b in zip(kb.models,
                                                           pb.models)]
        leaf = all(a.leaf_value.tobytes() == b.leaf_value.tobytes()
                   for a, b in zip(kb.models, pb.models))
        lin = all((a.leaf_coeff.tobytes() == b.leaf_coeff.tobytes()
                   and a.leaf_const.tobytes() == b.leaf_const.tobytes())
                  for a, b in zip(kb.models, pb.models) if a.is_linear)
        nlin = sum(a.is_linear for a in kb.models)
        print(f"[extras parity {label}] {type(kb._gbdt.learner).__name__}"
              f": structure equal {same}, leaf values bitwise {leaf}, "
              f"linear trees {nlin} bitwise {lin} in "
              f"{time.perf_counter() - t0:.1f} s")
        if len(kb.models) != PARITY_ITERS or not all(same) or not leaf \
                or not lin:
            fail(f"phase 13 {label}: kernel and plain runs differ")
        if label == "f linear" and nlin == 0:
            fail("phase 13 f: no linear tree at 100k rows")
        out[label] = all(same) and leaf and lin
    return out


CEGB_COUPLED = {"cegb_penalty_split": 1e-7,
                "cegb_penalty_feature_coupled": [2.0 + 0.5 * i
                                                 for i in range(F)]}
CEGB_LAZY = {"cegb_penalty_feature_lazy": [1e-5] * F}


def extras_phase(X, y, binned, binned_wide, dev, iters, reps):
    """Phase 13: extra_trees, by-node sampling, CEGB, forced splits,
    the bounded histogram memory and linear leaves at 2M x 28 (255
    leaves, lr 0.1, 8 iterations cut from 500) with a 500k-row valid
    set, each beside the same run without the option; then the scan's
    node table against its plain version and the kernels against their
    plain versions at 100k rows (g)."""
    import tempfile
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.learner import partitioned as lp
    from lightgbm_tpu_torch.models import gbdt as mg
    t0 = time.perf_counter()
    Xv, yv = higgs_like(500_000, seed=43)
    sets = {}
    for mb, b in ((255, binned), (1023, binned_wide)):
        tr = lt.Dataset(X, label=y)
        tr._binned = b
        va = tr.create_valid(Xv, label=yv)
        va._construct(lt.Config.from_params({"max_bin": mb,
                                            "verbosity": -1}))
        sets[mb] = (tr, va)
    print(f"[extras] valid 500000 rows binned at max_bin 255 and 1023 in "
          f"{time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp()
    forced_path = os.path.join(tmp, "forced.json")
    forced_json(forced_path, X)
    base = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
            "verbosity": -1, "fused_split_kernel": "off"}
    out = {}
    scan_us = {}
    # one warm-up tree, so that the first timed run pays no first use
    extras_run("warm-up", dict(base, max_bin=255), *sets[255], 1, dev,
               "PartitionedTreeLearner")
    for mb, want in ((255, "PartitionedTreeLearner"),
                     (1023, "SerialTreeLearner")):
        bst, info = extras_run(f"baseline {mb}", dict(base, max_bin=mb),
                               *sets[mb], iters, dev, want)
        scan_us[f"without {mb}"] = scan_us_in_training(bst)
        out[f"baseline {mb}"] = (bst, info)
    g = binned.num_groups
    slot = {mb: g * out[f"baseline {mb}"][0]._gbdt.learner.num_bins_max
            * 12 for mb in (255, 1023)}
    runs = [("a extra 255", {"extra_trees": True}, 255,
             "PartitionedTreeLearner"),
            ("a extra 1023", {"extra_trees": True}, 1023,
             "SerialTreeLearner"),
            ("b bynode", {"feature_fraction": 0.8,
                          "feature_fraction_bynode": 0.5}, 255,
             "PartitionedTreeLearner"),
            ("c cegb", dict(CEGB_COUPLED), 255, "PartitionedTreeLearner"),
            ("c lazy", dict(CEGB_LAZY), 255, "SerialTreeLearner"),
            ("d forced", {"forcedsplits_filename": forced_path}, 255,
             "PartitionedTreeLearner"),
            ("e pool", {"histogram_pool_size": 32.5 * slot[255] / 2 ** 20},
             255, "PartitionedTreeLearner"),
            ("e rebuild 1023", {"histogram_pool_size": 1.5 * slot[1023]
                                / 2 ** 20}, 1023, "SerialTreeLearner")]
    for label, extra, mb, want in runs:
        bst, info = extras_run(label, dict(base, max_bin=mb, **extra),
                               *sets[mb], iters, dev, want)
        lrn = bst._gbdt.learner
        ref_bst, ref = out[f"baseline {mb}"]
        info["auc_without"] = ref["auc"]
        if label.startswith("a"):
            scan_us[f"with {mb}"] = scan_us_in_training(bst)
        if label == "d forced":
            plan = lrn.forced_plan
            want_f = [p.feat for p in plan]
            want_t = [p.thr for p in plan]
            ok = len(plan) == 7 and all(
                list(t.split_feature_inner[:7]) == want_f
                and list(t.threshold_bin[:7]) == want_t
                for t in bst.models)
            print(f"[extras d] plan (feature, bin) "
                  f"{list(zip(want_f, want_t))}: every tree's first 7 "
                  f"nodes are the plan's {ok}")
            if not ok:
                fail("phase 13 d: a tree does not start with the plan")
        if label.startswith("e"):
            mode = lrn.mem.mode
            per_phase = info["trees"] + info["splits"]
            hist_name = "hist_segment" if mb == 255 else "hist_rows"
            extra_launches = info["launches"].get(hist_name, 0) - per_phase
            equal, diff, tie = same_or_tie(f"phase 13 {label}",
                                           bst.models, ref_bst.models)
            info.update(mode=mode, slots=lrn.hist_slots,
                        builds=lrn.mem.builds,
                        extra_hist_launches=extra_launches,
                        trees_equal=equal, max_leaf_diff=diff, tie=tie)
            print(f"[extras {label}] {mode}, {lrn.hist_slots} slots: "
                  f"{extra_launches} {hist_name} launches beyond the "
                  f"cache's; {equal} of {info['trees']} trees equal to "
                  f"the full cache's (max leaf value diff {diff:.3g}), "
                  f"first tie {tie}")
            if mode != ("pool" if mb == 255 else "rebuild"):
                fail(f"phase 13 {label} ran histogram memory {mode}")
        if label.startswith("c"):
            info["cegb_used"] = int(lrn.cegb.used.sum())
        out[label] = (None, info)
        del bst
        torch.cuda.empty_cache()
    # f: linear leaves (the same bins, with their raw values)
    tr, va = lt.Dataset(X, label=y), None
    tr._binned = with_raw(binned, X)
    va = tr.create_valid(Xv, label=yv)
    va._binned = with_raw(sets[255][1]._binned, Xv)
    fit = DeviceTimer()
    fit_fn = mg.fit_linear_leaves
    mg.fit_linear_leaves = fit.wrap(fit_fn)
    try:
        bst, info = extras_run("f linear", dict(
            base, max_bin=255, linear_tree=True, linear_max_features=8,
            fused_split_kernel="auto"), tr, va, iters, dev,
            "PartitionedTreeLearner")
    finally:
        mg.fit_linear_leaves = fit_fn
    # a tree's fit; the first call also loads the card's solver
    # library, so the median stands for the steady state
    fit.ms()
    fit_each = [a.elapsed_time(b) for a, b in fit.pairs]
    info["fit_ms_per_tree"] = float(np.median(fit_each))
    info["fit_ms_first"] = fit_each[0]
    info["auc_without"] = out["baseline 255"][1]["auc"]
    nlin = sum(t.is_linear for t in bst.models)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pred = bst.predict(X, raw_score=True)
    torch.cuda.synchronize()
    info["predict_s"] = time.perf_counter() - t1
    gap = float(np.abs(np.asarray(pred, np.float64) - bst._gbdt.train_score[
        :, 0].double().cpu().numpy()).max())
    text = bst.model_to_string()
    again = lt.Booster(model_str=text, device=dev).model_to_string()
    info.update(linear_trees=nlin, train_vs_predict=gap,
                text_round_trip=text == again)
    print(f"[extras f] {nlin} linear trees; fit {info['fit_ms_per_tree']:.3f}"
          f" ms a tree (median; the first {info['fit_ms_first']:.3f}); "
          f"train score vs predict(raw_score) of the 2M rows "
          f"{gap:.3g}; predict {info['predict_s']:.2f} s; text round trip "
          f"byte-equal {text == again}; valid auc {info['auc']:.6f} "
          f"against constant leaves {info['auc_without']:.6f}")
    if nlin == 0 or gap > 2e-5 or text != again \
            or not np.isfinite(pred).all():
        fail("phase 13 f: linear leaves missing, off their predictions or "
             "not round-tripped")
    out["f linear"] = (None, info)
    del bst, tr, va
    torch.cuda.empty_cache()
    for k, (us, calls) in scan_us.items():
        print(f"[extras scan] {k} bins: "
              + (f"{us:.2f} us a launch" if us is not None
                 else "not measured") + f" over one tree ({calls} launches)")
    node = check_scan_node(dev, reps)
    print(f"[extras scan] node table against plain bitwise: {node}")
    parity = extras_parity(dev, forced_path)
    shutil.rmtree(tmp, ignore_errors=True)
    res = {k: v[1] for k, v in out.items()}
    res["scan_us"] = {k: v[0] for k, v in scan_us.items()}
    res["node_table"] = node
    res["parity"] = parity
    return res


# ---- phase 14: cv, refit, rollback, the estimators, the binary file ----

def trees_bitwise(a_models, b_models):
    """Two tree lists with the same structure and leaf values (and
    linear models) to the bit."""
    def lin(t):
        return (t.leaf_const.tobytes(), t.leaf_coeff.tobytes()) \
            if t.is_linear else None
    return len(a_models) == len(b_models) and all(
        tree_sig(a) == tree_sig(b)
        and a.leaf_value.tobytes() == b.leaf_value.tobytes()
        and lin(a) == lin(b) for a, b in zip(a_models, b_models))


def over_binned(binned, X, label):
    """An ``lt.Dataset`` over already binned rows (no host binning):
    ``binned``'s bins with ``label``."""
    import copy
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.data.dataset import Metadata
    ds = lt.Dataset(X, label=label)
    ds._binned = copy.copy(binned)
    ds._binned.metadata = Metadata(binned.num_data)
    ds._binned.metadata.set_label(label)
    return ds


def trees_text(bst):
    """The trees of a model's text (no header or parameters)."""
    return bst.model_to_string().split("Tree=0")[1].split("end of trees")[0]


def timed_updates(lt):
    """Wrap ``Booster.update`` to sum each booster's wall time of an
    update (synchronised); returns the sums by booster and the undo."""
    import torch
    orig = lt.Booster.update
    spent = {}

    def update(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, *a, **kw)
        torch.cuda.synchronize()
        spent[id(self)] = spent.get(id(self), 0.0) \
            + time.perf_counter() - t0
        return out
    lt.Booster.update = update

    def undo():
        lt.Booster.update = orig
    return spent, undo


def refit_route_record(dev, n, reps):
    """The refit route of ``hist_rows``: one tree's per-leaf sums at
    F = 1, B = 255 over ``n`` rows (the leaf ids as uint8 bins): us a
    call (CUDA events) and on the card (profiler), the plain version's
    us, the byte bound (the leaf ids and ghc read once, the [255, 3]
    float32 sums written once) and the kernel against the plain version
    (max abs err, 0 = bitwise)."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    g = torch.Generator(device=dev).manual_seed(15)
    leaf = torch.randint(0, 255, (n,), generator=g, device=dev)
    ghc = torch.stack([torch.randn(n, generator=g, device=dev),
                       torch.rand(n, generator=g, device=dev),
                       torch.ones(n, device=dev)], dim=1)
    out = hc.leaf_histogram(leaf, ghc, 255)
    plain = hc.leaf_histogram(leaf, ghc, 255, plain=True)
    err = float((out - plain).abs().max())
    us = time_ms(lambda: hc.leaf_histogram(leaf, ghc, 255), reps) * 1e3
    # None: the profiler recorded no launch (it can lose records late
    # in a long process)
    dev_us = device_us(lambda: hc.leaf_histogram(leaf, ghc, 255), reps,
                       "hist_rows") or None
    plain_us = time_ms(lambda: hc.leaf_histogram(leaf, ghc, 255,
                                                 plain=True), reps) * 1e3
    # one flattened float64 index_add_ of the same sums
    lib_out = torch.zeros((255, 3), dtype=torch.float64, device=dev)
    vals = ghc.double()
    library_us = time_ms(lambda: lib_out.index_add_(0, leaf, vals),
                         reps) * 1e3
    bound_us = (n * (1 + 12) + 255 * 3 * 4) / HBM_BYTES_PER_S * 1e6
    return dict(us=us, device_us=dev_us, plain_us=plain_us,
                library_us=library_us, bound_us=bound_us, bound_by="bytes",
                max_abs_err=err, rows=n, num_leaves=255)


def slice15_cv(params, full, X, y, iters, dev):
    """14 a: ``lt.cv`` at full width, 5 folds stratified by the port's
    own splitter, auc, early stopping after 3 rounds; every fold on the
    fused segment path, one ``fused_split_step_segment`` launch a split
    of a full tree; fold 0's rows bitwise the parent's and its trees
    bitwise ``lt.train`` on those raw rows binned with the parent as
    reference."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    spent, undo = timed_updates(lt)
    _native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = lt.cv(dict(params, metric="auc"), full, iters, nfold=5,
                    early_stopping_rounds=3, return_cvbooster=True,
                    device=dev)
    finally:
        undo()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    cvb = res.pop("cvbooster")
    trees = sum(b.num_trees() for b in cvb.boosters)
    splits = sum(t.num_leaves - 1 for b in cvb.boosters for t in b.models)
    per_fold = []
    for i, b in enumerate(cvb.boosters):
        lrn = b._gbdt.learner
        s = sum(t.num_leaves - 1 for t in b.models)
        per_fold.append(spent[id(b)] / max(s, 1) * 1e3)
        if type(lrn).__name__ != "PartitionedTreeLearner" or not lrn.fused:
            fail(f"phase 14 a: fold {i} did not train on the fused "
                 "segment path")
    want = trees * (int(params["num_leaves"]) - 1)
    print(f"[slice15 a] cv 5 folds x {iters} iterations in {wall:.2f} s: "
          f"{trees} trees, {splits} splits; ms/split by fold (update "
          f"wall, synchronised) {[round(v, 4) for v in per_fold]}; "
          f"launches {launches}; cv_agg auc mean "
          f"{res['auc-mean'][-1]:.6f} stdv {res['auc-stdv'][-1]:.6f} "
          f"(best iteration {cvb.best_iteration})")
    for name in FUSED_SEGMENT_PATH:
        if not launches.get(name):
            fail(f"phase 14 a: kernel {name} was not launched by cv")
    if launches.get("fused_split_step_segment") != want or splits != want:
        fail(f"phase 14 a: {launches.get('fused_split_step_segment')} "
             f"fused_split_step_segment launches for {splits} splits "
             f"({want} in full trees)")
    b0 = cvb.boosters[0]
    idx = b0.train_set.used_indices
    rows_equal = np.array_equal(b0.train_set._construct().binned,
                                full._construct().binned[idx])
    t1 = time.perf_counter()
    ref = lt.train(params, lt.Dataset(X[idx], label=y[idx], reference=full),
                   b0.num_trees(), device=dev)
    same = trees_bitwise(b0.models, ref.models)
    print(f"[slice15 a] fold 0: {len(idx)} rows, binned rows bitwise the "
          f"parent's {rows_equal}; {b0.num_trees()} trees bitwise lt.train "
          f"on lt.Dataset(X[idx], reference=full) {same} "
          f"({time.perf_counter() - t1:.1f} s)")
    if not rows_equal or not same:
        fail("phase 14 a: fold 0 differs from its rows trained alone")
    return dict(wall_s=wall, trees=trees, splits=splits,
                ms_per_split_by_fold=per_fold, launches=launches,
                auc_mean=res["auc-mean"][-1], auc_stdv=res["auc-stdv"][-1],
                best_iteration=cvb.best_iteration)


def slice15_refit(params, bst, n, dev):
    """14 b: refit of the phase's model on a second draw (seed 44) at
    decay 0.9 through ``Booster.refit``: one ``hist_rows`` launch a
    tree; ``pred_leaf`` and the replay timed apart; leaf values bitwise
    against the plain versions; decay 1.0 changes nothing."""
    import copy
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    X2, y2 = higgs_like(n, seed=44)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    leaf = bst.predict(X2, pred_leaf=True, num_iteration=-1)
    torch.cuda.synchronize()
    pred_ms = (time.perf_counter() - t0) * 1e3
    routes = dict(hc.LEAF_SUM_ROUTES)
    _native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kb = bst.refit(X2, y2, 0.9)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    route = hc.LEAF_SUM_ROUTES["hist_rows"] - routes["hist_rows"]
    sorted_trees = hc.LEAF_SUM_ROUTES["sorted"] - routes["sorted"]
    trees = kb.num_trees()
    # the replay alone, on the refit booster's binned rows
    ts = kb.train_set
    rp = dict(params, refit_decay_rate=0.9)
    nb = lt.Booster(rp, ts, device=dev)
    nb._gbdt.models = [copy.deepcopy(t) for t in bst.models]
    nb._gbdt.iter = bst.current_iteration()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nb._gbdt.refit(leaf)
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3
    pb = bst._refit_on(ts, leaf, rp, ops="plain")
    ob = bst._refit_on(ts, leaf, dict(params, refit_decay_rate=1.0))
    kernel_plain = trees_bitwise(kb.models, pb.models)
    repeat = trees_bitwise(kb.models, nb.models)
    unchanged = trees_bitwise(ob.models, bst.models)
    auc_before = auc(y2, bst.predict(X2, raw_score=True))
    auc_after = auc(y2, kb.predict(X2, raw_score=True))
    print(f"[slice15 b] refit of {trees} trees on {n} new rows (seed 44), "
          f"decay 0.9: Booster.refit {refit_s:.2f} s (pred_leaf "
          f"{pred_ms:.1f} ms, the replay {replay_ms:.1f} ms, the rest the "
          f"new rows' binning and the booster's set-up); launches "
          f"{launches}; per-leaf sums by hist_rows {route} trees, sorted "
          f"{sorted_trees}; kernel against plain bitwise {kernel_plain}, "
          f"a second replay bitwise {repeat}; decay 1.0 unchanged "
          f"{unchanged}; AUC on the new rows {auc_before:.6f} before, "
          f"{auc_after:.6f} after")
    if launches.get("hist_rows") != trees or route != trees \
            or sorted_trees:
        fail("phase 14 b: refit's per-leaf sums were not one hist_rows "
             "launch a tree")
    if not (kernel_plain and repeat and unchanged):
        fail("phase 14 b: refit kernel and plain runs differ, or decay 1.0 "
             "changed the model")
    if not np.isfinite(auc_after) or auc_after < auc_before - 0.01:
        fail("phase 14 b: refit lost the model's AUC")
    return dict(trees=trees, hist_rows_launches=launches.get("hist_rows"),
                refit_s=refit_s, pred_leaf_ms=pred_ms, replay_ms=replay_ms,
                auc_before=auc_before, auc_after=auc_after)


def slice15_rollback(params, full, bst8, iters, dev):
    """14 c: ``rollback_one_iter`` twice after ``iters + 2`` iterations:
    the remaining trees' text equals an ``iters``-iteration run's, the
    train scores within 1e-5."""
    import lightgbm_tpu_torch as lt
    rb = lt.train(params, full, iters + 2, device=dev)
    rb.rollback_one_iter().rollback_one_iter()
    same = trees_text(rb) == trees_text(bst8)
    gap = float((rb._gbdt.train_score - bst8._gbdt.train_score).abs().max())
    print(f"[slice15 c] {iters + 2} iterations rolled back twice: "
          f"{rb.num_trees()} trees, text equal to a {iters}-iteration run's "
          f"{same}; train score gap {gap:.3g}")
    if not same or gap > 1e-5 or rb.current_iteration() != iters:
        fail("phase 14 c: rollback did not return to the shorter run")
    return dict(text_equal=same, train_score_gap=gap)


def slice15_estimators(params, X, y, Xv, yv, bst8, dev):
    """14 d: ``LGBMClassifier`` and ``LGBMRegressor`` on the first
    ``ESTIMATOR_ROWS`` rows (28 features, 255 leaves) with the 500k
    ``eval_set``; the classifier's ``predict_proba`` bitwise
    ``lt.train``'s on the same rows, the regressor's predictions bitwise
    ``lt.train``'s on the latent score."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import sklearn as psk
    out = {"sklearn_importable": psk.SKLEARN_INSTALLED,
           "rows": ESTIMATOR_ROWS}
    iters = bst8.current_iteration()
    # the latent score of the whole matrix (its rows are the matrix's)
    z = higgs_latent(len(y))[1][:ESTIMATOR_ROWS]
    X, y = X[:ESTIMATOR_ROWS], y[:ESTIMATOR_ROWS]
    t0 = time.perf_counter()
    clf = lt.LGBMClassifier(n_estimators=iters, num_leaves=255, device=dev)
    clf.fit(X, y, eval_set=[(Xv, yv)])
    proba = clf.predict_proba(Xv)
    # the lt.train references share one binning of the rows
    binned = lt.Dataset(X, label=y)._construct(lt.Config.from_params(params))
    p = lt.train(params, over_binned(binned, X, y), iters,
                 device=dev).predict(Xv)
    clf_same = np.array_equal(proba[:, 1], p) \
        and np.array_equal(proba[:, 0], 1.0 - p)
    out["classifier_s"] = time.perf_counter() - t0
    hist = clf.evals_result_["valid_0"]["binary_logloss"]
    _, zv = higgs_latent(len(yv), seed=43)
    t0 = time.perf_counter()
    reg = lt.LGBMRegressor(n_estimators=iters, num_leaves=255, device=dev)
    reg.fit(X, z, eval_set=[(Xv, zv)])
    rb = lt.train(dict(params, objective="regression"),
                  over_binned(binned, X, z), iters, device=dev)
    reg_same = np.array_equal(reg.predict(Xv), rb.predict(Xv))
    out["regressor_s"] = time.perf_counter() - t0
    l2 = reg.evals_result_["valid_0"]["l2"]
    print(f"[slice15 d] scikit-learn importable {psk.SKLEARN_INSTALLED}; "
          f"LGBMClassifier fit + predict {out['classifier_s']:.1f} s, "
          f"predict_proba bitwise lt.train's {clf_same}, valid logloss "
          f"{hist[0]:.6f} -> {hist[-1]:.6f}; LGBMRegressor "
          f"{out['regressor_s']:.1f} s, predict bitwise lt.train's "
          f"{reg_same}, valid l2 {l2[0]:.6f} -> {l2[-1]:.6f}")
    if not (clf_same and reg_same) or not hist[-1] < hist[0] \
            or not l2[-1] < l2[0]:
        fail("phase 14 d: an estimator is not its lt.train model")
    out.update(classifier_bitwise=clf_same, regressor_bitwise=reg_same)
    return out


def slice15_files(params, full, X, bst8, binned, dev):
    """14 e: ``save_binary`` of the 2M x 28 dataset and back (the same 8
    trees, to the bit), and ``add_features_from`` of columns 0-13 and
    14-27 (each half binned with the whole matrix's mappers: bin finding
    is per column, so a fresh binning finds the same ones) against the
    28-column binned matrix."""
    import tempfile
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.data.dataset import Dataset as Binned
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "train.bin")
    t0 = time.perf_counter()
    full.save_binary(path)
    save_s = time.perf_counter() - t0
    mb = os.path.getsize(path) / 2 ** 20
    t0 = time.perf_counter()
    disk = lt.Dataset(path)
    disk.construct()
    load_s = time.perf_counter() - t0
    again = lt.train(params, disk, bst8.current_iteration(), device=dev)
    same = trees_bitwise(again.models, bst8.models)
    cfg = lt.Config.from_params(params)
    half = X.shape[1] // 2
    t0 = time.perf_counter()
    left = Binned.from_numpy(X[:, :half], cfg,
                             bin_mappers=binned.bin_mappers[:half])
    right = Binned.from_numpy(X[:, half:], cfg,
                              bin_mappers=binned.bin_mappers[half:])
    left.add_features_from(right)
    joined = np.array_equal(left.binned, binned.binned) \
        and left.num_total_features == binned.num_total_features
    join_s = time.perf_counter() - t0
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"[slice15 e] save_binary {save_s:.2f} s, {mb:.1f} MB; load "
          f"{load_s:.2f} s; {again.num_trees()} trees bitwise the "
          f"in-memory run's {same}; add_features_from of columns 0-{half - 1}"
          f" and {half}-{X.shape[1] - 1} bitwise the {X.shape[1]}-column "
          f"binned matrix {joined} ({join_s:.1f} s)")
    if not same or not joined:
        fail("phase 14 e: the binary file or the feature join differs")
    return dict(save_s=save_s, load_s=load_s, file_mb=mb)


def slice15_parity(dev):
    """14 f: kernels against plain versions at 100k rows, 63 leaves: cv
    (3 folds, ``PARITY_ITERS`` iterations) at max_bin 255 (the segment
    kernels) and 1023 (the leaf kernel and ``hist_rows``), and refit (3
    trees): the same folds' trees and cv lists, and the same refit leaf
    values, to the bit."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    Xp, yp = higgs_like(100_000, seed=3)
    base = {"objective": "binary", "num_leaves": 63, "learning_rate": 0.1,
            "verbosity": -1, "metric": "auc"}
    out = {}
    for mb, kernel in ((255, "fused_split_step_segment"),
                       (1023, "fused_split_step_leaf")):
        t0 = time.perf_counter()
        pp = dict(base, max_bin=mb)
        ds = lt.Dataset(Xp, label=yp)
        _native.reset_launch_counts()
        kr = lt.cv(pp, ds, PARITY_ITERS, nfold=3, return_cvbooster=True,
                   device=dev)
        launched = dict(_native.LAUNCHES)
        pr = lt.cv(pp, ds, PARITY_ITERS, nfold=3, return_cvbooster=True,
                   device=dev, ops="plain")
        kc, pc = kr.pop("cvbooster"), pr.pop("cvbooster")
        same = kr == pr and all(
            trees_bitwise(a.models, b.models)
            for a, b in zip(kc.boosters, pc.boosters))
        print(f"[slice15 f] cv max_bin {mb}: kernel against plain bitwise "
              f"{same} ({kernel} {launched[kernel]}, hist_rows "
              f"{launched['hist_rows']} launches) in "
              f"{time.perf_counter() - t0:.1f} s")
        if not same or not launched[kernel] or (
                mb == 1023 and not launched["hist_rows"]):
            fail(f"phase 14 f: cv at max_bin {mb}: kernel and plain differ")
        out[f"cv {mb}"] = same
    t0 = time.perf_counter()
    text = lt.train(dict(base, max_bin=255), lt.Dataset(Xp, label=yp), 3,
                    device=dev).model_to_string()
    Xq, yq = higgs_like(100_000, seed=4)
    _native.reset_launch_counts()
    kb = lt.Booster(model_str=text, device=dev).refit(Xq, yq, 0.9)
    launched = _native.LAUNCHES["hist_rows"]
    pb = lt.Booster(model_str=text, device=dev, ops="plain").refit(Xq, yq,
                                                                   0.9)
    same = trees_bitwise(kb.models, pb.models)
    print(f"[slice15 f] refit: kernel against plain bitwise {same} "
          f"(hist_rows {launched} launches) in "
          f"{time.perf_counter() - t0:.1f} s")
    if not same or launched != 3:
        fail("phase 14 f: refit kernel and plain differ")
    out["refit"] = same
    return out


def slice15_phase(X, y, binned, dev, iters, reps):
    """Phase 14: cv, refit, rollback, the scikit-learn estimators, the
    binary file and the feature join at full width (2M x 28, 255 leaves,
    lr 0.1, binary, max_bin 255, ``iters`` iterations cut from 500;
    valid 500k, seed 43), then kernels against plain versions at 100k
    rows. Returns its numbers and the refit route's record for the
    kernels line."""
    import torch
    import lightgbm_tpu_torch as lt
    params = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
              "max_bin": 255, "verbosity": -1}
    full = over_binned(binned, X, y)
    Xv, yv = higgs_like(500_000, seed=43)
    out = {"a cv": slice15_cv(params, full, X, y, iters, dev)}
    torch.cuda.empty_cache()
    bst8 = lt.train(params, full, iters, device=dev)
    out["b refit"] = slice15_refit(params, bst8, REFIT_ROWS, dev)
    torch.cuda.empty_cache()
    out["c rollback"] = slice15_rollback(params, full, bst8, iters, dev)
    out["d estimators"] = slice15_estimators(params, X, y, Xv, yv, bst8,
                                             dev)
    torch.cuda.empty_cache()
    out["e files"] = slice15_files(params, full, X, bst8, binned, dev)
    del bst8, full
    torch.cuda.empty_cache()
    out["f parity"] = slice15_parity(dev)
    route = refit_route_record(dev, len(y), reps)
    route["launches"] = out["b refit"]["hist_rows_launches"]
    on_card = "not measured" if route["device_us"] is None \
        else f"{route['device_us']:.1f}"
    print(f"[slice15 route] hist_rows refit route, F 1, B 255, "
          f"{route['rows']} rows: {route['us']:.1f} us a call (events), "
          f"{on_card} on the card, plain {route['plain_us']:.1f}, float64 "
          f"index_add_ {route['library_us']:.1f}, bound "
          f"{route['bound_us']:.2f} us (bytes), max abs err "
          f"{route['max_abs_err']}")
    if route["max_abs_err"] != 0.0:
        fail("phase 14: the refit route disagrees with its plain version")
    return out, route


# ---- phase 15: more than 1024 bins ------------------------------------

def wide_bins_dtype(b):
    """The device copy of a bin matrix at ``b`` bins (data/dataset.py
    ``binned_device``): uint8, the int16 bits of uint16, or int32 past
    32,768 bins."""
    import torch
    return torch.uint8 if b <= 256 else torch.int16 if b <= 32768 \
        else torch.int32


def wide_scan_case(dev, b, reps, n=200_000, f=F):
    """The scan kernel at ``b`` bins on two random children of ``n``
    rows, every missing convention: every column bitwise its plain
    version's; ms, device ms, plain ms and bound."""
    import torch
    from lightgbm_tpu_torch.ops import split as sp
    from lightgbm_tpu_torch.ops import split_scan_cuda as sc
    from lightgbm_tpu_torch.ops.histogram import build_histogram
    g = torch.Generator(device=dev).manual_seed(b)
    bins = torch.randint(0, b, (n, f), generator=g, device=dev)
    ghc = torch.stack([torch.randn(n, generator=g, device=dev)
                       + (bins[:, 0] > b // 2).float(),
                       torch.rand(n, generator=g, device=dev) + 0.1,
                       torch.ones(n, device=dev)], dim=1)
    hists = [build_histogram(bins[:n // 3], ghc[:n // 3], b),
             build_histogram(bins[n // 3:], ghc[n // 3:], b)]
    leaves = [tuple(h[0].sum(0).cpu().numpy()) + (-np.inf, np.inf)
              for h in hists]
    meta = sp.FeatureMeta(
        num_bins=np.full(f, b, np.int32),
        missing=(np.arange(f) % 3).astype(np.int32),
        default_bin=np.full(f, b // 3, np.int32),
        most_freq_bin=np.zeros(f, np.int32),
        monotone=np.zeros(f, np.int32), penalty=np.ones(f, np.float32),
        is_categorical=np.zeros(f, bool))
    meta_t = sp.meta_tensors(meta, dev)
    tables = sc.scan_meta_tables(meta_t)
    params = sp.SplitParams(0.0, 1.0, 0.0, 20.0, 1e-3, 0.0, True)
    k = sc.per_feature_numerical_cuda(hists, leaves, meta_t, params, tables)
    p = sc.per_feature_numerical_plain(hists, leaves, meta_t, params)
    k, p = k.cpu().numpy(), p.cpu().numpy()
    if k.tobytes() != p.tobytes():
        fail(f"scan at {b} bins differs from its plain version")
    if not np.isfinite(k[..., sp.O_SCORE]).any():
        fail(f"scan at {b} bins: no valid feature")
    call = lambda: sc.per_feature_numerical_cuda(  # noqa: E731
        hists, leaves, meta_t, params, tables)
    nbytes = 2 * f * b * 3 * 4 + 2 * f * 8 * 4
    ops = 2 * f * b * 2 * 44
    # None: the profiler recorded no launch
    return dict(ms=time_ms(call, reps),
                device_ms=device_us(call, reps,
                                    KERNEL_NAMES["split_scan"]) / 1e3
                or None,
                plain_ms=time_ms(lambda: sc.per_feature_numerical_plain(
                    hists, leaves, meta_t, params), 3),
                bound_ms=max(nbytes / HBM_BYTES_PER_S,
                             ops / F32_FLOPS) * 1e3,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / F32_FLOPS else "operations", library_ms=None,
                max_abs_err=0.0)


def wide_hist_case(dev, b, reps, n, f=F):
    """``hist_rows`` over all ``n`` rows of a random [n, f] bin matrix at
    ``b`` bins (the device copy's dtype at that width) against its plain
    version, phase 2's rule (bitwise repeatable, counts exact, sums
    within 1e-5 x the bin's sum of |values| + 1e-6); ms, device ms,
    plain ms, one flattened float32 ``index_add_`` of the same rows and
    the byte bound; the blocks' window of bins."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    g = torch.Generator(device=dev).manual_seed(b + 1)
    bins = torch.randint(0, b, (n, f), generator=g, device=dev) \
        .to(wide_bins_dtype(b))
    ghc = torch.stack([torch.randn(n, generator=g, device=dev),
                       torch.rand(n, generator=g, device=dev) + 0.1,
                       (torch.rand(n, generator=g, device=dev) < 0.9)
                       .float()], dim=1)
    bb = bins.element_size()
    partial = hc.rows_partial(bins, b)
    out = hc.histogram_rows(bins, ghc, b, partial=partial)
    again = hc.histogram_rows(bins, ghc, b, partial=partial)
    ref = hc.histogram_rows_plain(bins, ghc, b)
    scale = hc.histogram_rows_plain(bins, ghc.abs(), b)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), again.view(torch.int32)):
        fail(f"hist_rows at {b} bins not bitwise repeatable")
    if not torch.equal(out[..., 2], ref[..., 2]):
        fail(f"hist_rows at {b} bins: counts differ from the plain version")
    err = (out - ref).abs()
    if bool((err > 1e-5 * scale + 1e-6).any()):
        fail(f"hist_rows at {b} bins off by {float(err.max())}")
    del again, ref, scale
    call = lambda: hc.histogram_rows(bins, ghc, b,  # noqa: E731
                                     partial=partial)
    keys = (bins.long() & 0xFFFFFFFF) + torch.arange(f, device=dev) * b
    keys = keys.reshape(-1)
    vals = ghc.repeat_interleave(f, 0)
    lib_out = torch.zeros((f * b, 3), device=dev)
    library_ms = time_ms(lambda: lib_out.index_add_(0, keys, vals), reps)
    del keys, vals, lib_out
    tile = hc.leaf_feat_tile(f, b, bb)
    nbytes = n * (f * bb + 12) + f * b * 3 * 4
    return dict(ms=time_ms(call, reps),
                device_ms=device_us(call, reps,
                                    KERNEL_NAMES["hist_rows"]) / 1e3
                or None,
                plain_ms=time_ms(lambda: hc.histogram_rows_plain(
                    bins, ghc, b), 3),
                library_ms=library_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                max_abs_err=float(err.max()), rows=n, bin_bytes=bb,
                feat_tile=tile, window=hc.rows_window(bb, b, tile))


def wide_parity(dev, max_bin, min_data_in_bin=3):
    """Kernel against plain at 100k rows, 63 leaves, ``PARITY_ITERS``
    iterations, at ``max_bin`` (the serial learner, per-phase past 1024 bins): the same
    trees and leaf values to the bit."""
    import lightgbm_tpu_torch as lt
    Xp, yp = higgs_like(100_000, seed=3)
    pp = {"objective": "binary", "num_leaves": 63, "learning_rate": 0.1,
          "max_bin": max_bin, "min_data_in_bin": min_data_in_bin,
          "verbosity": -1}
    t0 = time.perf_counter()
    ds = lt.Dataset(Xp, label=yp)
    kb = lt.train(pp, ds, PARITY_ITERS, device=dev)
    pb = lt.train(pp, ds, PARITY_ITERS, device=dev, ops="plain")
    lrn = kb._gbdt.learner
    same = trees_bitwise(kb.models, pb.models)
    print(f"[wide bins] parity at max_bin {max_bin}: num_bins_max "
          f"{lrn.num_bins_max}, bins {lrn.binned.dtype}, fused "
          f"{lrn.fused}, trees bitwise {same} in "
          f"{time.perf_counter() - t0:.1f} s")
    if not same or len(kb.models) != PARITY_ITERS:
        fail(f"kernel and plain runs grew different trees at max_bin "
             f"{max_bin}")
    return lrn.num_bins_max


def fmt_ms(v):
    return "not measured" if v is None else f"{v:.4f}"


def wide_kernel_checks(dev, n, reps):
    """Phase 15's kernels alone (run beside phase 2's, early in the
    process, where the profiler keeps its records): the scan and
    ``hist_rows`` past 1024 bins at B in {1025, 2048, 4095, 4096}, the
    last width whose one-feature tile fits a block and one past it,
    32,767, 32,768, 32,769 and 65,536."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    t0 = time.perf_counter()
    fit = hc.rows_window(2, 65536, 1)     # the widest one-feature tile
    widths = (1025, 2048, 4095, 4096, fit, fit + 1, 32767, 32768, 32769,
              65536)
    reps = min(reps, 5)
    scans, hists = {}, {}
    for b in widths:
        scans[b] = wide_scan_case(dev, b, reps)
        hists[b] = wide_hist_case(dev, b, reps, n)
        torch.cuda.empty_cache()
        s, h = scans[b], hists[b]
        print(f"[wide bins] B {b}: split_scan {s['ms']:.4f} ms, device "
              f"{fmt_ms(s['device_ms'])}, plain {s['plain_ms']:.3f}, bound "
              f"{s['bound_ms']:.5f} ({s['bound_by']}), bitwise; hist_rows "
              f"({h['bin_bytes']}-byte bins, tile {h['feat_tile']}, window "
              f"{h['window']}) {h['ms']:.4f} ms, device "
              f"{fmt_ms(h['device_ms'])}, plain {h['plain_ms']:.3f}, "
              f"index_add_ {h['library_ms']:.3f}, bound "
              f"{h['bound_ms']:.4f}, max abs err {h['max_abs_err']:.3g}")
    print(f"[wide bins] kernels alone in {time.perf_counter() - t0:.1f} s")
    return scans, hists


def wide_bins_phase(X, y, dev, iters):
    """Phase 15 (ROADMAP Queue 1 item 4), past its kernels alone
    (``wide_kernel_checks``): the 2M x 28 rows at max_bin 4095 on the
    serial learner's per-phase path (255 leaves, a 500k valid set)
    beside phase 4's per-phase run at 1023; then kernel against plain at
    4095 and past 32,768 bins."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.learner import SerialTreeLearner
    from lightgbm_tpu_torch.ops import _native
    t0 = time.perf_counter()
    params = {"objective": "binary", "num_leaves": 255,
              "learning_rate": 0.1, "max_bin": 4095, "verbosity": -1,
              "metric": "auc"}
    tr = lt.Dataset(X, label=y, params=params)
    Xv, yv = higgs_like(len(X) // 4, seed=43)
    va = tr.create_valid(Xv, label=yv)
    tr._construct()
    va._construct()
    t_bin = time.perf_counter() - t0
    _native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = {}
    bst = lt.train(params, tr, iters, valid_sets=[va], valid_names=["valid"],
                   evals_result=hist, verbose_eval=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_native.LAUNCHES)
    lrn = bst._gbdt.learner
    trees = bst.models[:iters]
    splits = sum(t.num_leaves - 1 for t in trees)
    ms = wall / max(splits, 1) * 1e3
    valid_auc = hist["valid"]["auc"][-1]
    print(f"[wide bins] 4095: {type(lrn).__name__}, num_bins_max "
          f"{lrn.num_bins_max}, bins {lrn.binned.dtype}, fused "
          f"{lrn.fused}, {len(trees)} trees, {splits} splits in "
          f"{wall:.2f} s = {ms:.4f} ms/split (phase 4 per-phase at 1023: "
          f"{PATH_MS.get(('max_bin 1023', 'per-phase'), float('nan')):.4f});"
          f" binned in {t_bin:.1f} s; valid auc {valid_auc:.6f}; launches "
          f"{launches}")
    if not isinstance(lrn, SerialTreeLearner) or lrn.fused:
        fail("max_bin 4095 did not train on the serial learner's "
             "per-phase path")
    if launches["fused_split_step_leaf"] != 0:
        fail("the fused leaf kernel ran past 1024 bins")
    if launches["hist_rows"] != len(trees) + splits \
            or launches["split_scan"] != len(trees) + splits:
        fail("hist_rows and split_scan did not run once a tree and once a "
             "split at max_bin 4095")
    if not valid_auc > 0.75:
        fail(f"valid AUC {valid_auc} at max_bin 4095")
    del bst, tr, va
    torch.cuda.empty_cache()
    wide4095 = wide_parity(dev, 4095)
    wide40k = wide_parity(dev, 40000, min_data_in_bin=1)
    if wide40k <= 32768:
        fail(f"the parity run past 32,768 bins has {wide40k} bins")
    return dict(ms_per_split=ms, valid_auc=valid_auc, launches=launches,
                splits=splits, parity_bins=[wide4095, wide40k],
                per_phase_1023_ms=PATH_MS.get(("max_bin 1023", "per-phase")))


# ---- phase 17: multiboost (train_many, BoosterBatch, batched cv) -------

def mb_sweep(iters):
    """Phase 17 (a)'s two buckets at full width: 8 models over learning
    rate x lambda_l2, and 4 with bagging (fractions 0.7/0.8, seeds
    40-43)."""
    base = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
            "verbosity": -1}
    sweep = [dict(base, learning_rate=lr, lambda_l2=l2)
             for lr in (0.05, 0.1, 0.2, 0.3) for l2 in (0.0, 1.0)]
    bag = [dict(base, learning_rate=0.1, bagging_fraction=frac,
                bagging_freq=1, bagging_seed=40 + i)
           for i, frac in enumerate((0.7, 0.7, 0.8, 0.8))]
    return sweep + bag


def mb_split_counts(tree):
    """(rows of the leaf, of its right child, of the smaller child) of
    each split of a tree grown without row weights, in split order."""
    def cnt(c):
        return int(tree.internal_count[c]) if c >= 0 \
            else int(tree.leaf_count[~c])
    return [(int(tree.internal_count[s]), cnt(tree.right_child[s]),
             min(cnt(tree.left_child[s]), cnt(tree.right_child[s])))
            for s in range(tree.num_leaves - 1)]


def mb_ghc(params, ds, dev):
    """A ``BoosterBatch`` of ``params`` over ``ds``, set up, and its
    models' iteration-0 ghc [B, N, 3] (the scores at boost_from_average,
    no row weights)."""
    from lightgbm_tpu_torch.multiboost.batch import BoosterBatch, ModelSpec
    from lightgbm_tpu_torch.multiboost.program import batched_gradients
    from lightgbm_tpu_torch.ops.histogram import make_ghc
    bb = BoosterBatch(ds, [ModelSpec(params=dict(p)) for p in params], 1,
                      device=dev).setup()
    bb._score += bb._hyp.init_score[:, None]
    grad, hess = batched_gradients(bb._grad_obj, bb._attrs, bb._score)
    return bb, make_ghc(grad, hess)


def mb_kernel_records(params, ds, dev, reps):
    """Both batched kernels alone at the main path's shapes: the first
    four models of the sweep (learning rate 0.05 / 0.1 x lambda_l2 0 / 1)
    at iteration 0 over the 2M x 28 rows. Kernel B (``hist_rows_batched``)
    bitwise against ``hist_rows`` model by model, timed with CUDA events
    and on the card (profiler), beside its plain version, one flattened
    float32 ``index_add_`` over the [B, F, Bins] keys and its byte bound
    (the bins read once, each model's ghc, 12 B a row, and the
    histograms written). Kernel A (``fused_split_step_leaf_batched``):
    the root split of the 4 models (one launch) and a whole tree of
    L - 1 launches, against the sum of the models' ``leaf_bound_ms`` of
    the same splits; its plain version's root split."""
    import torch
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    from lightgbm_tpu_torch.ops import split_step_cuda as ss
    bb, ghc = mb_ghc(params, ds, dev)
    lrn = bb.learner
    bins, nb = lrn.serial.binned, lrn.serial.num_bins_max
    m, n = lrn.models, lrn.num_data
    bin_bytes = bins.element_size()
    partial = lrn._scratch.partial

    # ---- kernel B
    out = hc.histogram_rows_batched(bins, ghc, nb, partial=partial)
    for i in range(m):
        if not torch.equal(out[i].view(torch.int32), hc.histogram_rows(
                bins, ghc[i].contiguous(), nb).view(torch.int32)):
            fail(f"phase 17: hist_rows_batched model {i} is not hist_rows'")
    plain = hc.histogram_rows_batched_plain(bins, ghc, nb)
    b_err = float((out - plain).abs().max())
    if b_err != 0.0:
        fail(f"phase 17: hist_rows_batched is off its plain version by "
             f"{b_err} (B {m})")
    b_ms = time_ms(lambda: hc.histogram_rows_batched(bins, ghc, nb,
                                                     partial=partial), reps)
    # None: the profiler recorded fewer launches than calls (it loses
    # records late in a long process)
    b_dev = device_us(lambda: hc.histogram_rows_batched(
        bins, ghc, nb, partial=partial), reps, "hist_rows_batched",
        need=("hist_rows_batched_kernel",)) / 1e3 or None
    b_plain = time_ms(lambda: hc.histogram_rows_batched_plain(bins, ghc, nb),
                      1)
    # the loop the kernel replaces: m hist_rows launches at the same shape
    single = hc.rows_partial(bins, nb)
    ghcs = [ghc[i].contiguous() for i in range(m)]
    b_loop = time_ms(lambda: [hc.histogram_rows(bins, g, nb, partial=single)
                              for g in ghcs], reps)
    del single, ghcs
    f = bins.shape[1]
    keys = ((torch.arange(m, device=dev)[:, None, None] * f
             + torch.arange(f, device=dev)[None, None, :]) * nb
            + (bins.long() & 0xFFFF)[None]).reshape(-1)
    vals = ghc[:, :, None, :].expand(m, n, f, 3).reshape(-1, 3)
    lib_out = torch.zeros((m * f * nb, 3), device=dev)
    b_lib = time_ms(lambda: lib_out.index_add_(0, keys, vals), reps)
    del keys, vals, lib_out, plain
    b_bound = (n * f * bin_bytes + m * n * 12 + m * f * nb * 3 * 4) \
        / HBM_BYTES_PER_S * 1e3
    shape = hc.rows_batched_shape(bin_bytes, nb,
                                  hc.leaf_feat_tile(f, nb, bin_bytes), m)
    rec_b = dict(max_abs_err=b_err, ms=b_ms, device_ms=b_dev,
                 plain_ms=b_plain, library_ms=b_lib, bound_ms=b_bound,
                 bound_by="bytes", models=m, block_shape=shape,
                 loop_ms=b_loop)

    # ---- kernel A
    k, S, T, imeta, fmeta = lrn.root_states(ghc)
    start = [t.clone() for t in (k, S, T, lrn.lid, lrn.hist)]
    step = lrn.split_step(k, S, T, ghc, imeta, fmeta)
    state = (k, S, T, lrn.lid, lrn.hist)

    def restore():
        for dst, t in zip(state, start):
            dst.copy_(t)

    def timed(fn, count):
        times = []
        for _ in range(count):
            restore()
            a = torch.cuda.Event(enable_timing=True)
            c = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            c.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(c))
        return float(np.median(times))

    a_ms = timed(step, reps)
    a_dev = device_us(lambda: (restore(), step()), reps,
                      "split_step_leaf_batched",
                      need=("split_step_leaf_batched",)) / 1e3 or None
    restore()
    step()
    got = [t.clone() for t in state]
    restore()
    ss.fused_split_step_leaf_batched_plain(
        *state, bins, ghc, imeta, fmeta, params=lrn.params,
        big_l=lrn.num_leaves, max_depth=lrn.serial.max_depth, b=nb,
        has_monotone=lrn.serial.has_monotone)
    for name, x, y in zip(("k", "S", "T", "lid"), got, state):
        if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
            fail(f"phase 17: fused_split_step_leaf_batched's {name} differs "
                 "bitwise from its plain version (root split, B "
                 f"{m})")
    a_err = float((got[4] - state[4]).abs().max())
    if a_err != 0.0:
        fail(f"phase 17: fused_split_step_leaf_batched's cache is off its "
             f"plain version's by {a_err} (root split, B {m})")
    # model by model, the single-model kernel's root split from the same
    # state: the same bits
    restore()
    for i in range(m):
        ss.fused_split_step_leaf(
            k[i:i + 1], S[i], T[i], lrn.lid[i], lrn.hist[i], bins,
            ghc[i].contiguous(), imeta, fmeta, params=lrn.params[i],
            big_l=lrn.num_leaves, max_depth=lrn.serial.max_depth, b=nb,
            has_monotone=lrn.serial.has_monotone)
    for name, x, y in zip(("k", "S", "T", "lid", "cache"), got, state):
        if not torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
            fail(f"phase 17: fused_split_step_leaf_batched's {name} differs "
                 f"bitwise from fused_split_step_leaf's, model by model "
                 f"(root split, B {m})")
    a_plain = timed(lambda: ss.fused_split_step_leaf_batched_plain(
        *state, bins, ghc, imeta, fmeta, params=lrn.params,
        big_l=lrn.num_leaves, max_depth=lrn.serial.max_depth, b=nb,
        has_monotone=lrn.serial.has_monotone), 1)
    root_bound = 0.0
    for i in range(m):
        moved = int((got[3][i] != 0).sum())
        root_bound += leaf_bound_ms(n, n, moved, min(moved, n - moved), f,
                                    nb, bin_bytes)
    # a whole tree of every model
    restore()
    a = torch.cuda.Event(enable_timing=True)
    c = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(lrn.num_leaves - 1):
        step()
    c.record()
    torch.cuda.synchronize()
    tree_ms = a.elapsed_time(c) / (lrn.num_leaves - 1)
    from lightgbm_tpu_torch.learner.split_step import grown_tree
    Sh, Th, kh = S.cpu(), T.cpu(), k.cpu().tolist()
    splits = [mb_split_counts(grown_tree(lrn.serial.pack,
                                         {"S": Sh[i], "T": Th[i]}, kh[i],
                                         lrn.dataset)[0]) for i in range(m)]
    tree_bound = sum(leaf_bound_ms(n, nl, nr, ns, f, nb, bin_bytes)
                     for sp in splits for nl, nr, ns in sp) \
        / (lrn.num_leaves - 1)
    rec_a = dict(max_abs_err=a_err, ms=a_ms, device_ms=a_dev,
                 plain_ms=a_plain, library_ms=None, bound_ms=root_bound,
                 bound_by="bytes", models=m, single_kernel_equal=True,
                 tree_avg_ms=tree_ms,
                 tree_avg_bound_ms=tree_bound,
                 tree_splits=[len(sp) for sp in splits],
                 launch_shape=lrn._scratch.shape)
    del bb, lrn, ghc, start, got
    torch.cuda.empty_cache()
    return rec_a, rec_b


def mb_parity(dev):
    """Phase 17 (b): 100k rows, 63 leaves, ``PARITY_ITERS`` iterations,
    B = 4 (rates and min_data_in_leaf varying) through the batched
    kernels and through ``ops="plain"``: the trees bitwise (model text);
    then kernel B on the 4 models' iteration-0 ghc against its plain
    version and, model by model, ``hist_rows`` (max abs err)."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    Xp, yp = higgs_like(100_000, seed=3)
    params = [{"objective": "binary", "num_leaves": 63, "verbosity": -1,
               "learning_rate": lr, "min_data_in_leaf": md}
              for lr, md in ((0.05, 20), (0.1, 10), (0.2, 40), (0.3, 5))]
    t0 = time.perf_counter()
    kb, rk = lt.engine.train_many([dict(p) for p in params],
                                  lt.Dataset(Xp, label=yp), PARITY_ITERS,
                                  return_report=True, device=dev)
    pb, rp = lt.engine.train_many([dict(p) for p in params],
                                  lt.Dataset(Xp, label=yp), PARITY_ITERS,
                                  return_report=True, device=dev,
                                  ops="plain")
    same = [a.model_to_string() == b.model_to_string()
            for a, b in zip(kb, pb)]
    bb, ghc = mb_ghc(params, lt.Dataset(Xp, label=yp), dev)
    bins, nb = bb.learner.serial.binned, bb.learner.serial.num_bins_max
    out = hc.histogram_rows_batched(bins, ghc, nb)
    err_plain = float((out - hc.histogram_rows_batched_plain(
        bins, ghc, nb)).abs().max())
    err_single = max(float((out[i] - hc.histogram_rows(
        bins, ghc[i].contiguous(), nb)).abs().max()) for i in range(4))
    print(f"[multiboost b] 100000 x {F}, 63 leaves, {PARITY_ITERS} "
          f"iterations, B 4 (routes {[b['route'] for b in rk['buckets']]}, "
          f"plain {[b['route'] for b in rp['buckets']]}): kernel and plain "
          f"model text equal {same}; hist_rows_batched max abs err "
          f"{err_plain} against its plain version, {err_single} against "
          f"hist_rows model by model ({time.perf_counter() - t0:.1f} s)")
    if not all(same) or rk["batched_models"] != 4 \
            or rp["batched_models"] != 4:
        fail("phase 17 b: the batched kernels' trees differ from the plain "
             "route's")
    if err_single != 0.0:
        fail("phase 17 b: hist_rows_batched differs from hist_rows")
    if err_plain != 0.0:
        fail("phase 17 b: hist_rows_batched differs from its plain version")
    del bb, ghc
    torch.cuda.empty_cache()
    return dict(model_text_equal=same, hist_err_plain=err_plain,
                hist_err_hist_rows=err_single)


def mb_cv(binned, X, y, iters, dev):
    """Phase 17 (c): 5 folds of the 2M rows (the port's stratified
    splitter, seed 0), lr 0.25, binary_logloss, ``iters`` rounds:
    ``multiboost=on`` (one batch of 5 fold models) against
    ``train_many`` with the folds' ``row_indices`` (model text byte for
    byte) and against ``multiboost=off`` (the per-fold loop; means and
    standard deviations within rtol 1e-5, atol 1e-7)."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import engine as pe
    from lightgbm_tpu_torch.ops import _native
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.25, "metric": "binary_logloss",
              "verbosity": -1}
    folds = list(pe._StratifiedKFold(5, shuffle=True, random_state=0)
                 .split(None, y))
    out = {}
    _native.reset_launch_counts()
    t0 = time.perf_counter()
    on = lt.cv(dict(params, multiboost="on"), over_binned(binned, X, y),
               iters, folds=folds, return_cvbooster=True)
    torch.cuda.synchronize()
    out["batched_s"] = time.perf_counter() - t0
    out["batched_launches"] = {k: v for k, v in _native.LAUNCHES.items()
                               if v}
    t0 = time.perf_counter()
    twins = lt.engine.train_many(
        [dict(params, multiboost="on") for _ in folds],
        over_binned(binned, X, y), iters,
        row_indices=[tr for tr, _ in folds])
    out["train_many_s"] = time.perf_counter() - t0
    same = [a.model_to_string() == b.model_to_string()
            for a, b in zip(on.pop("cvbooster").boosters, twins)]
    t0 = time.perf_counter()
    off = lt.cv(dict(params, multiboost="off"), over_binned(binned, X, y),
                iters, folds=folds)
    torch.cuda.synchronize()
    out["loop_s"] = time.perf_counter() - t0
    worst = 0.0
    for key in off:
        a, b = np.asarray(on[key]), np.asarray(off[key])
        if a.shape != b.shape or not np.allclose(a, b, rtol=1e-5,
                                                 atol=1e-7):
            fail(f"phase 17 c: batched cv {key} {a.tolist()} is not the "
                 f"per-fold loop's {b.tolist()}")
        worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(
            np.abs(b), 1e-30))))
    print(f"[multiboost c] cv 5 folds of {len(y)} rows x {iters} rounds, "
          f"lr 0.25: batched {out['batched_s']:.2f} s (launches "
          f"{out['batched_launches']}), fold texts equal train_many's "
          f"{same} ({out['train_many_s']:.2f} s); per-fold loop "
          f"{out['loop_s']:.2f} s, the largest relative gap of a mean or "
          f"stdv {worst:.3g}; logloss mean "
          f"{on['binary_logloss-mean'][-1]:.6f} (loop "
          f"{off['binary_logloss-mean'][-1]:.6f})")
    if not all(same) or len(same) != 5:
        fail("phase 17 c: a batched cv fold booster is not its train_many "
             "twin")
    out.update(fold_text_equal=same, worst_rel_gap=worst)
    return out


def multiboost_phase(X, y, binned, dev, iters, reps):
    """Phase 17: ``engine.train_many`` at full width (2M x 28, 255
    leaves, ``iters`` iterations) in two buckets (``mb_sweep``), every
    model's text held to its ``lt.train`` twin's (the partitioned
    learner, fused) byte for byte, the report, the batched kernels'
    launches (``fused_split_step_leaf_batched`` at most iters x 254 a
    bucket, ``hist_rows_batched`` one an iteration a bucket); the two
    kernels alone (``mb_kernel_records``); (b) ``mb_parity``; (c)
    ``mb_cv``. Returns the phase's numbers and both kernels' records."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    params = mb_sweep(iters)
    out = {}
    _native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    boosters, report = lt.engine.train_many(
        [dict(p) for p in params], over_binned(binned, X, y), iters,
        return_report=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_native.LAUNCHES)
    print(f"[multiboost a] train_many of {len(params)} models, {len(y)} x "
          f"{F}, 255 leaves, {iters} iterations in {wall:.2f} s: buckets "
          f"{[(b['size'], b['route']) for b in report['buckets']]}, "
          f"batched_models {report['batched_models']}, loop fallbacks "
          f"{report['loop_fallback']}, batched_seconds "
          f"{report['batched_seconds']:.2f}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if report["batched_models"] != 12 or len(report["buckets"]) != 2 \
            or any(b["route"] != "batched" for b in report["buckets"]):
        fail(f"phase 17 a: the report is not 12 models in two batched "
             f"buckets: {report}")
    cap = iters * 254
    if launches["fused_split_step_leaf_batched"] > 2 * cap \
            or launches["fused_split_step_leaf"] \
            or launches["fused_split_step_leaf_batched"] == 0 \
            or launches["hist_rows_batched"] == 0:
        fail(f"phase 17 a: batched kernel launches {launches}")
    t0 = time.perf_counter()
    equal, first_diff = [], None
    twin_splits = 0
    for i, p in enumerate(params):
        twin = lt.train(dict(p), over_binned(binned, X, y), iters)
        twin_splits += sum(t.num_leaves - 1 for t in twin.models)
        if type(twin._gbdt.learner).__name__ != "PartitionedTreeLearner" \
                or not twin._gbdt.learner.fused:
            fail("phase 17 a: a twin did not train on the fused "
                 "partitioned path")
        a, b = boosters[i].model_to_string(), twin.model_to_string()
        equal.append(a == b)
        if a != b and first_diff is None:
            la, lb = a.splitlines(), b.splitlines()
            j = next(j for j, (u, v) in enumerate(zip(la, lb)) if u != v)
            first_diff = (i, j, la[j][:160], lb[j][:160])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    batched_splits = sum(t.num_leaves - 1 for b in boosters
                         for t in b.models)
    print(f"[multiboost a] model text byte-equal to its lt.train twin: "
          f"{equal}; twins' loop {loop_s:.2f} s ({twin_splits} splits), "
          f"batched {report['batched_seconds']:.2f} s ({batched_splits} "
          f"splits): ms a split per model {report['batched_seconds'] / max(batched_splits, 1) * 1e3:.4f}"
          f" against the twins' {loop_s / max(twin_splits, 1) * 1e3:.4f}")
    if first_diff is not None:
        i, j, la, lb = first_diff
        print(f"[multiboost a] model {i} first differs at line {j}: "
              f"batched {la!r}, twin {lb!r}")
        fail("phase 17 a: a batched model's text is not its lt.train "
             "twin's")
    out["a"] = dict(wall_s=wall, batched_seconds=report["batched_seconds"],
                    loop_seconds=loop_s, batched_splits=batched_splits,
                    twin_splits=twin_splits, text_equal=equal,
                    buckets=report["buckets"],
                    launches={k: v for k, v in launches.items() if v})
    del boosters
    torch.cuda.empty_cache()
    def dev_ms(v):
        return "not measured" if v is None else f"{v:.4f}"
    # the kernels alone at B 4 (the record's numbers) and B 8 (bucket 0's
    # 8 models, beside them in the record)
    recs = {}
    for models in (4, 8):
        t0 = time.perf_counter()
        ra, rb = recs[models] = mb_kernel_records(
            params[:models], over_binned(binned, X, y), dev, reps)
        print(f"[multiboost kernels] fused_split_step_leaf_batched (B "
              f"{ra['models']}, grid {ra['launch_shape']}): root split "
              f"{ra['ms']:.4f} ms (device {dev_ms(ra['device_ms'])}, plain "
              f"{ra['plain_ms']:.2f}, bound {ra['bound_ms']:.5f}), tree "
              f"average {ra['tree_avg_ms']:.4f} ms a launch (bound "
              f"{ra['tree_avg_bound_ms']:.5f}) over "
              f"{ra['tree_splits']} splits; cache max abs err against "
              f"plain {ra['max_abs_err']}, root split bitwise the single "
              f"kernel's {ra['single_kernel_equal']}; hist_rows_batched (B "
              f"{rb['models']}, block {rb['block_shape']}): "
              f"{rb['ms']:.4f} ms (device {dev_ms(rb['device_ms'])}, "
              f"{rb['models']} hist_rows launches {rb['loop_ms']:.4f}, plain "
              f"{rb['plain_ms']:.2f}, index_add_ {rb['library_ms']:.3f}, "
              f"bound {rb['bound_ms']:.5f}), max abs err against plain "
              f"{rb['max_abs_err']} ({time.perf_counter() - t0:.1f} s)")
    rec_a, rec_b = recs[4]
    rec_a["models_8"], rec_b["models_8"] = recs[8]
    rec_a["launches"] = launches["fused_split_step_leaf_batched"]
    rec_b["launches"] = launches["hist_rows_batched"]
    out["b"] = mb_parity(dev)
    out["c"] = mb_cv(binned, X, y, iters, dev)
    return out, rec_a, rec_b


# ---- phase 16: the parallel learners over ranks on one card -------------

PAR_RANKS = 2
PAR_ITERS = 2          # cut from 8 for the time limit (PERF.md section 4)
PAR_ROWS = 1_000_000   # cut from phase 3's 2M for the time limit as well
# run -> (tree_learner, max_bin): the rows each rank loaded
PAR_RUNS = {"data_255": ("data", 255), "data_1023": ("data", 1023),
            "voting_255": ("voting", 255), "feature_1023": ("feature", 1023)}
PAR_LEARNERS = {"data_255": "MeshPartitionedTreeLearner",
                "data_1023": "DataParallelTreeLearner",
                "voting_255": "MeshPartitionedTreeLearner",
                "feature_1023": "FeatureParallelTreeLearner"}


def par_tree(t):
    k = t.num_leaves
    return dict(num_leaves=k,
                split_feature=t.split_feature_inner[:k - 1].tolist(),
                threshold_bin=t.threshold_bin[:k - 1].tolist(),
                leaf_value=t.leaf_value[:k].tolist())


def par_params(learner, max_bin, n):
    """Phase 3's params for ``learner`` at ``max_bin``: every rank bins
    from the pooled sample of every row (``bin_construct_sample_cnt`` =
    the rows), so its bins are the single process's."""
    p = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
         "max_bin": max_bin, "verbosity": -1, "tree_learner": learner,
         "bin_construct_sample_cnt": n, "top_k": 20,
         # the group stays up for the rank's next run
         "elastic_shutdown": False}
    if learner != "feature":
        p["pre_partition"] = True
    return p


def par_full(local, mb, n, X, y):
    """Every row, binned with a rank's pooled mappers (the single
    process's bins)."""
    import lightgbm_tpu_torch as lt
    p = par_params("serial", mb, n)
    p.pop("pre_partition")
    full = lt.Dataset(X, label=y, reference=local, params=p)
    full._construct()
    return full


def par_rank(rank, size, rdzv, out, n, iters):
    """One rank of phase 16 (``chip_smoke.py --rank``): joins the gloo
    group on the one card, loads its ``host_row_range`` block of the
    phase's ``n`` rows under ``pre_partition`` (binned from the pooled sample of
    every row), trains each run with the launch and collective counts
    set to 0 just before it and read just after, then kernel against
    plain at 100k rows; rank 0 also trains the single process on every
    row with the same bins (the feature run's rows). Writes its results
    to ``out/rank<r>.json``."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.learner import comm
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.parallel.distributed import shutdown_distributed
    from lightgbm_tpu_torch.parallel.ingest import host_row_range
    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    lt.init_distributed(rank=rank, world_size=size,
                        init_method=f"file://{rdzv}", backend="gloo")
    res = {"runs": {}, "parity": {}, "single": {}}
    t0 = time.perf_counter()
    X, z = higgs_latent(n)
    y = (z > 0).astype(np.float32)
    lo, hi = host_row_range(n)
    res["rows"] = [lo, hi]
    local = {}
    for mb in (255, 1023):
        ds = lt.Dataset(X[lo:hi], label=y[lo:hi],
                        params=par_params("data", mb, n))
        ds._construct()
        local[mb] = ds
    res["bin_s"] = time.perf_counter() - t0
    res["mappers"] = {str(mb): [[m.num_bin, list(m.bin_upper_bound)]
                                for m in local[mb]._binned.bin_mappers]
                      for mb in local}
    # the feature learner's rows: every row, with the pooled mappers
    full = {1023: par_full(local[1023], 1023, n, X, y)}
    Xv, yv = higgs_like(n // 4, seed=43) if rank == 0 else (None, None)
    parts = {}
    t1 = time.perf_counter()
    if rank == 0:
        # the single process on every row and the same bins, per-phase
        full[255] = par_full(local[255], 255, n, X, y)
        for mb in (255, 1023):
            p = dict(par_params("serial", mb, n), fused_split_kernel="off")
            p.pop("pre_partition")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            bst = lt.train(p, full[mb], iters, device=dev)
            torch.cuda.synchronize()
            splits = sum(t.num_leaves - 1 for t in bst.models)
            res["single"][str(mb)] = dict(
                trees=[par_tree(t) for t in bst.models],
                ms_per_split=(time.perf_counter() - t1) / max(splits, 1)
                * 1e3, valid_auc=auc(yv, bst.predict(Xv, raw_score=True)))
            del bst
        torch.cuda.empty_cache()
    parts["single"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    for run, (learner, mb) in PAR_RUNS.items():
        ds = full[mb] if learner == "feature" else local[mb]
        params = par_params(learner, mb, n)
        _native.reset_launch_counts()
        comm.reset_comm_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bst = lt.train(params, ds, iters, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        splits = sum(t.num_leaves - 1 for t in bst.models)
        res["runs"][run] = dict(
            learner=type(bst._gbdt.learner).__name__,
            fused=bst._gbdt.learner.fused, wall_s=wall, splits=splits,
            ms_per_split=wall / max(splits, 1) * 1e3,
            launches=dict(_native.LAUNCHES),
            calls=dict(comm.COMM_CALLS), bytes=dict(comm.COMM_BYTES),
            trees=[par_tree(t) for t in bst.models],
            valid_auc=None if Xv is None
            else auc(yv, bst.predict(Xv, raw_score=True)))
        del bst
        torch.cuda.empty_cache()
    parts["runs"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    # kernel against plain at 100k rows, CUT_PARITY_LEAVES leaves,
    # PARITY_ITERS iterations
    Xp, yp = higgs_like(100_000, seed=3)
    plo, phi = host_row_range(len(Xp))
    for run, (learner, mb) in PAR_RUNS.items():
        p = dict(par_params(learner, mb, len(Xp)),
                 num_leaves=CUT_PARITY_LEAVES)
        rows = slice(None) if learner == "feature" else slice(plo, phi)
        ds = lt.Dataset(Xp[rows], label=yp[rows], params=p)
        kb = lt.train(p, ds, PARITY_ITERS, device=dev)
        pb = lt.train(p, ds, PARITY_ITERS, device=dev, ops="plain")
        res["parity"][run] = trees_bitwise(kb.models, pb.models)
    parts["parity"] = time.perf_counter() - t1
    res["part_s"] = parts
    # (e) the drill's references and the legs' binned rows
    t1 = time.perf_counter()
    res["drill"] = drill_references(local, full, rank, out, n, dev)
    res["drill_s"] = time.perf_counter() - t1
    # (f) ROADMAP Queue 1 item 13 over the ranks
    t1 = time.perf_counter()
    res["item13"] = item13_runs(z, local, full, rank, n, iters, dev, Xv, yv)
    res["item13_s"] = time.perf_counter() - t1
    res["total_s"] = time.perf_counter() - t0
    shutdown_distributed()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)


# ---- phase 16 (e): the elastic drill; (f): Queue 1 item 13 on ranks ----

DRILL_ITERS = 3
# the watchdog's drill bounds (detection in seconds, not minutes)
DRILL_WATCHDOG = {"elastic_heartbeat_ms": 100.0,
                  "elastic_heartbeat_timeout_ms": 2000.0,
                  "elastic_stall_timeout_ms": 3000.0,
                  "elastic_abort_grace_ms": 2000.0,
                  "elastic_barrier_s": 60.0}
# the stall timeout of the 1M-row runs (the references, kill, resume,
# shrink, guard): an iteration there takes 1-4 s and more (254 splits at
# 4-9 ms over gloo, and the first collectives' connection set-up), so a
# 3 s timeout declares a healthy first iteration a collective_stall; the
# 3 s bound is the 100k-row stall and drop_heartbeat legs'
DRILL_STALL_1M_MS = 60000.0
DRILL_KILL_ITER = 2
DRILL_STALL_ITER = 2
# the stall and drop_heartbeat legs test the watchdog alone: 100k rows
# and 31 leaves, so that a healthy iteration stays far inside their 3 s
# stall timeout beside the 1M-row kill leg, and iterations enough to
# outlast the detection (an abort ends the leg at once)
DRILL_SMALL_ROWS = 100_000
DRILL_SMALL_LEAVES = 31
DRILL_SMALL_ITERS = 200
# leg -> (max_bin, ranks, extra params); 1 rank: one process, no group
DRILL_LEGS = {
    "kill": (255, 2, {"faults": f"kill_rank@rank=1,iter={DRILL_KILL_ITER}"}),
    "resume": (255, 2, {}),
    "shrink": (1023, 1, {"elastic_resume": True}),
    "guard": (1023, 1, {}),
    "stall": (255, 2, {"faults": f"stall_rank@rank=1,iter={DRILL_STALL_ITER},"
                                 "ms=9000"}),
    "drop_heartbeat": (255, 2, {"faults": "drop_heartbeat@rank=1"}),
}
LEG_LIMIT_S = 120.0
# legs started beside the first ones that wait for a go file (written once
# the kill leg's checkpoint is in place): their process start-up overlaps
# the first legs' (PR 24, was a second wave of processes; PERF.md
# section 4)
DRILL_GO_LEGS = ["resume"]
# (f): phase 12's Expo one-hot (674 columns; multi-val from ~400k rows
# at the default bin sample), every row on each rank, the data and
# voting learners taking their row blocks
ITEM13_MV_ROWS = 400_000
ITEM13_EXTRA = {"extra_trees": True, "feature_fraction_bynode": 0.5}
# extra_trees and by-node draws differ over ranks by design (a feature
# shard folds its rank into its keys, as the JAX learners fold the mesh
# position), so the single process is no reference for such a run: the
# card's 2-rank trees are held to the same 2-rank run on the CPU (the
# run that tests/test_torch_parallel_item13.py ties to JAX's mesh of 2)
# at the 100k parity rows; their valid AUC at 1M rows is a diagnostic
ITEM13_CPU_CASES = ("extra_data_255", "extra_feature_1023")
# the multi-val voting run's valid AUC against the single process's
ITEM13_AUC_TOL = 0.01


def drill_params(mb, n):
    """Phase 16's data learner at ``max_bin`` ``mb`` on ``n`` rows with a
    coordinated checkpoint every iteration and the drill's watchdog
    bounds (at the phase's 1M rows, ``DRILL_STALL_1M_MS``)."""
    p = dict(par_params("data", mb, n), checkpoint_freq=1,
             checkpoint_keep=DRILL_ITERS, **DRILL_WATCHDOG)
    if n > DRILL_SMALL_ROWS:
        p["elastic_stall_timeout_ms"] = DRILL_STALL_1M_MS
    return p


def drill_text(bst):
    """A model's trees: its text before the parameters (which hold each
    leg's paths)."""
    return bst.model_to_string().split("\nparameters:")[0]


def path_launches(launches, mb):
    """The path's kernels of the data learner at ``mb`` bins (rows 1-5,
    or 5 and 8 past 255) and their launches."""
    names = ("hist_segment", "partition_segment", "split_scan") \
        if mb <= 255 else ("hist_rows", "split_scan")
    return {k: launches.get(k, 0) for k in names}


def drill_references(local, full, rank, out, n, dev):
    """(e)'s references in the rank processes: the data learner at 255
    and 1023 bins, ``DRILL_ITERS`` iterations with a coordinated
    checkpoint each (``ck_<mb>``), the text, the writes' ms and this
    rank's shard bytes; then each rank's binned rows (and on rank 0
    every row at 1023) as binary files for the legs."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    refs = {}
    for mb in (255, 1023):
        ck = os.path.join(out, f"ck_{mb}")
        _native.reset_launch_counts()
        writes, undo = timed_checkpoints()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            bst = lt.train(dict(drill_params(mb, n), checkpoint_dir=ck),
                           local[mb], DRILL_ITERS, device=dev)
        finally:
            undo()
        torch.cuda.synchronize()
        shard = os.path.join(ck, f"ckpt_{DRILL_ITERS:08d}",
                             f"shard_{rank:05d}.npz")
        refs[str(mb)] = dict(
            text=drill_text(bst), wall_s=time.perf_counter() - t0,
            writes=writes["writes"], write_ms=writes["ms"]
            / max(writes["writes"], 1), shard_bytes=os.path.getsize(shard),
            launches=path_launches(_native.LAUNCHES, mb))
        local[mb].save_binary(os.path.join(out, f"local_{mb}_{rank}.bin"))
        del bst
    if rank == 0:
        full[1023].save_binary(os.path.join(out, "full_1023.bin"))
    return refs


def drill_leg(leg, rank, size, rdzv, out, n):
    """One rank of an (e) leg (``chip_smoke.py --leg``): the data learner
    on the reference's binned rows (or 100k fresh rows for the watchdog
    legs), the leg's params, the launch counts written after every
    iteration (a SIGKILLed rank keeps its last); a watchdog verdict
    writes them and exits with the elastic exit code and its
    ``ELASTIC_ABORT`` line. Writes ``out/leg_<leg>_<rank>.json``."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.parallel.ingest import host_row_range
    from lightgbm_tpu_torch.robustness.elastic import (ElasticError,
                                                       elastic_exit)
    from lightgbm_tpu_torch.utils.log import LightGBMError
    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    mb, _, extra = DRILL_LEGS[leg]
    if size > 1:
        lt.init_distributed(rank=rank, world_size=size,
                            init_method=f"file://{rdzv}", backend="gloo")
    small = leg in ("stall", "drop_heartbeat")
    iters = DRILL_SMALL_ITERS if small else DRILL_ITERS
    if small:
        X, y = higgs_like(DRILL_SMALL_ROWS, seed=5)
        lo, hi = host_row_range(len(X))
        ds = lt.Dataset(X[lo:hi], label=y[lo:hi],
                        params=par_params("data", mb, len(X)))
        n_run = len(X)
    else:
        ds = lt.Dataset(os.path.join(out, "full_1023.bin" if size == 1
                                     else f"local_{mb}_{rank}.bin"))
        n_run = n
    if leg in DRILL_GO_LEGS:
        # started beside the first legs; runs once the kill leg's
        # checkpoint is in place (its start-up overlaps theirs)
        go = os.path.join(out, f"go_{leg}")
        deadline = time.monotonic() + 2 * LEG_LIMIT_S
        while not os.path.exists(go):
            if time.monotonic() > deadline:
                raise SystemExit(f"leg {leg}: no {go}")
            time.sleep(0.05)
    ck = os.path.join(out, f"ck_{leg}")
    params = dict(drill_params(mb, n_run), checkpoint_dir=ck, **extra)
    if small:
        params["num_leaves"] = DRILL_SMALL_LEAVES
    path = os.path.join(out, f"leg_{leg}_{rank}.json")
    res = {"rank": rank, "iterations": 0}

    def dump(env=None):
        if env is not None:
            res["iterations"] = env.iteration + 1
        res["launches"] = path_launches(_native.LAUNCHES, mb)
        with open(path, "w") as fh:
            json.dump(res, fh)
    _native.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        bst = lt.train(params, ds, iters, device=dev, callbacks=[dump])
    except ElasticError as err:
        res.update(error=str(err)[:300], seconds=time.perf_counter() - t0)
        dump()
        elastic_exit(err)
    except LightGBMError as err:
        res.update(error=str(err), seconds=time.perf_counter() - t0)
        dump()
        return
    res.update(text=drill_text(bst), seconds=time.perf_counter() - t0,
               resumed=getattr(bst, "resumed_iteration", None),
               learner=type(bst._gbdt.learner).__name__,
               trees=[par_tree(t) for t in bst.models])
    dump()


def start_legs(legs, tmp, n):
    """Start each leg's ranks at once (``--leg``, its own rendezvous and
    logs); returns their processes and logs."""
    procs = {}
    for leg in legs:
        _, size, _ = DRILL_LEGS[leg]
        procs[leg] = []
        for r in range(size):
            log = open(os.path.join(tmp, f"leg_{leg}_{r}.log"), "w")
            procs[leg].append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--leg", leg,
                 "--rank", str(r), "--world", str(size), "--rdzv",
                 os.path.join(tmp, f"rdzv_{leg}"), "--out", tmp, "--rows",
                 str(n)], stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def wait_legs(procs, tmp):
    """Wait for ``start_legs``' processes, killing past ``LEG_LIMIT_S``;
    return per leg the exit codes, the logs and the host clock's exit
    time of each rank."""
    deadline = time.monotonic() + LEG_LIMIT_S
    ended = {leg: [None] * len(ps) for leg, ps in procs.items()}
    while time.monotonic() < deadline and any(
            None in e for e in ended.values()):
        for leg, ps in procs.items():
            for r, (p, _) in enumerate(ps):
                if ended[leg][r] is None and p.poll() is not None:
                    ended[leg][r] = time.monotonic()
        time.sleep(0.02)
    out = {}
    for leg, ps in procs.items():
        for p, log in ps:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        logs = []
        for r in range(len(ps)):
            with open(os.path.join(tmp, f"leg_{leg}_{r}.log")) as fh:
                logs.append(fh.read())
        out[leg] = dict(codes=[p.returncode for p, _ in ps], logs=logs,
                        ended=ended[leg])
    return out


def leg_result(tmp, leg, rank):
    path = os.path.join(tmp, f"leg_{leg}_{rank}.json")
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return json.load(fh)


def abort_reasons(log):
    """The ``ELASTIC_ABORT`` lines of a rank's log, classified."""
    from lightgbm_tpu_torch.robustness.elastic import \
        classify_elastic_failure
    return [classify_elastic_failure(ln) for ln in log.splitlines()
            if ln.startswith("ELASTIC_ABORT")]


def leg_fail(leg, msg, run):
    for r, log in enumerate(run["logs"]):
        print(f"[drill {leg}] rank {r} (exit {run['codes'][r]}) log tail:\n"
              + "\n".join(log.splitlines()[-12:]))
    fail(f"phase 16 (e) {leg}: {msg}")


def drill_phase(tmp, n, refs):
    """(e): the kill leg (its detection timed) beside the stall and
    drop_heartbeat legs (the stall held to the injected one: both ranks
    through ``DRILL_STALL_ITER`` iterations), then the resume, shrink and
    guard legs at once; each leg's seconds, verdicts, texts and launches
    checked.
    ``refs``: the ranks' references (``drill_references``)."""
    out = {}
    for mb in ("255", "1023"):
        if refs[0][mb]["text"] != refs[1][mb]["text"]:
            fail(f"phase 16 (e): the ranks' {mb}-bin references differ")
    ref = {mb: refs[0][mb]["text"] for mb in ("255", "1023")}
    out["references"] = {mb: dict(
        wall_s=refs[0][mb]["wall_s"], writes=refs[0][mb]["writes"],
        write_ms=[r[mb]["write_ms"] for r in refs],
        shard_bytes=[r[mb]["shard_bytes"] for r in refs])
        for mb in ("255", "1023")}
    # the kill leg writes into its own directory; the resume continues
    # there, the shrink and the guard read a 2-rank 1023-bin checkpoint of
    # iteration DRILL_KILL_ITER (the reference's, the later ones removed)
    for leg in ("shrink", "guard"):
        dst = os.path.join(tmp, f"ck_{leg}")
        shutil.copytree(os.path.join(tmp, "ck_1023"), dst)
        for it in range(DRILL_KILL_ITER + 1, DRILL_ITERS + 1):
            shutil.rmtree(os.path.join(dst, f"ckpt_{it:08d}"))
    # every leg starts at once; the resume leg waits (after its start-up)
    # for the kill leg's checkpoint, which needs no other leg
    t0 = time.perf_counter()
    first = start_legs(["kill", "stall", "drop_heartbeat", "shrink",
                        "guard"], tmp, n)
    waiting = start_legs(DRILL_GO_LEGS, tmp, n)
    try:
        runs = wait_legs(first, tmp)
        out["first_legs_s"] = time.perf_counter() - t0
        kill = runs["kill"]
        if kill["codes"] != [43, -9]:
            leg_fail("kill", f"exit codes {kill['codes']}, want [43, -9]",
                     kill)
        if abort_reasons(kill["logs"][0]) != ["peer_lost"] \
                or "reason=peer_lost rank=1" not in kill["logs"][0]:
            leg_fail("kill", "rank 0 did not abort with peer_lost rank=1",
                     kill)
        detect = kill["ended"][0] - kill["ended"][1]
        bound = (DRILL_WATCHDOG["elastic_heartbeat_timeout_ms"]
                 + DRILL_WATCHDOG["elastic_abort_grace_ms"]) / 1e3
        if detect > bound + 1.0:
            leg_fail("kill", f"rank 0 took {detect:.2f} s to abort", kill)
        out["kill_detect_s"] = detect
        os.rename(os.path.join(tmp, "ck_kill"),
                  os.path.join(tmp, "ck_resume"))
        t0 = time.perf_counter()
        for leg in DRILL_GO_LEGS:
            with open(os.path.join(tmp, f"go_{leg}"), "w"):
                pass
        runs.update(wait_legs(waiting, tmp))
    finally:
        # a failed check leaves no waiting leg behind
        for ps in waiting.values():
            for p, log in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
    out["resume_s"] = time.perf_counter() - t0
    res = {leg: [leg_result(tmp, leg, r)
                 for r in range(DRILL_LEGS[leg][1])] for leg in runs}
    for leg in ("kill", "resume", "shrink"):
        mb = DRILL_LEGS[leg][0]
        for r, rec in enumerate(res[leg]):
            if not rec or not all(v > 0 for v in rec["launches"].values()):
                leg_fail(leg, f"rank {r} did not launch its path's "
                         f"kernels: {rec.get('launches')}", runs[leg])
    for leg in ("resume", "shrink"):
        if any(runs[leg]["codes"]):
            leg_fail(leg, f"exit codes {runs[leg]['codes']}", runs[leg])
        for rec in res[leg]:
            if rec.get("resumed") != DRILL_KILL_ITER:
                leg_fail(leg, f"resumed at {rec.get('resumed')}", runs[leg])
    for rec in res["resume"]:
        if rec["text"] != ref["255"]:
            leg_fail("resume", "the resumed text is not the reference's",
                     runs["resume"])
    shrink_exact = res["shrink"][0]["text"] == ref["1023"]
    if not shrink_exact:
        leg_fail("shrink", "the 2 -> 1 reshard is not byte-equal to the "
                 "2-rank reference (the data learner at 1023 bins grows the "
                 "single process's trees bitwise)", runs["shrink"])
    guard = res["guard"][0]
    if runs["guard"]["codes"] != [0] or \
            "world mismatch" not in guard.get("error", "") or \
            "elastic_resume=true" not in guard.get("error", ""):
        leg_fail("guard", f"no world-mismatch error: {guard}", runs["guard"])
    want = {"stall": "collective_stall", "drop_heartbeat": "peer_lost"}
    for leg, reason in want.items():
        run = runs[leg]
        if run["codes"] != [43, 43] or any(
                abort_reasons(log)[:1] != [reason] for log in run["logs"]):
            leg_fail(leg, f"want both ranks to exit 43 with {reason}: exit "
                     f"codes {run['codes']}", run)
        out[f"{leg}_iterations"] = [rec.get("iterations") for rec in
                                    res[leg]]
        out[f"{leg}_exit_s"] = [e - min(run["ended"])
                                for e in run["ended"]]
    if out["stall_iterations"] != [DRILL_STALL_ITER] * 2:
        leg_fail("stall", "the stall was not the injected one (iterations "
                 f"done {out['stall_iterations']}, the stall at "
                 f"{DRILL_STALL_ITER})", runs["stall"])
    out["launches"] = {leg: [rec["launches"] for rec in res[leg]]
                       for leg in ("kill", "resume", "shrink")}
    out["shrink_byte_equal"] = shrink_exact
    out["legs_s"] = {leg: [rec.get("seconds") for rec in res[leg]]
                     for leg in res}
    print(f"[drill] kill: rank 1 SIGKILLed at iteration {DRILL_KILL_ITER}, "
          f"rank 0 exit 43 peer_lost {detect:.3f} s after it (bound "
          f"{bound:.1f} s); resume and shrink (2 -> 1, 1023 bins) "
          f"byte-equal to the references; guard: world mismatch; stall: "
          f"both ranks collective_stall, exits "
          f"{[round(v, 2) for v in out['stall_exit_s']]} s apart; "
          f"drop_heartbeat: both peer_lost; a coordinated write "
          f"{[round(v, 2) for v in out['references']['255']['write_ms']]} "
          f"ms a rank at 255 bins, shard bytes "
          f"{out['references']['255']['shard_bytes']}; legs: "
          f"kill+stall+drop_heartbeat+shrink+guard "
          f"{out['first_legs_s']:.1f} s, then resume (started beside "
          f"them) {out['resume_s']:.1f} s")
    return out


def check_multival_f64(ds, dev, reps):
    """The float64 route of ``hist_multival`` (the data-parallel
    learners') against its plain version on a multi-val dataset's slots,
    all rows and a random third: max abs err 0; timed (CUDA events)
    beside the plain version and its byte bound (``multival_bytes`` with
    the histogram written as float64)."""
    import torch
    from lightgbm_tpu_torch.ops import hist_multival_cuda as hm
    lay = ds.mv_layout_device(dev)
    g_mv = ds.num_groups - ds.num_dense_groups
    b = int(max(ds.num_bins_array().max(), ds.group_num_bins.max()))
    n = lay.n
    gen = torch.Generator(device=dev).manual_seed(21)
    ghc = torch.stack([torch.randn(n, generator=gen, device=dev),
                       torch.rand(n, generator=gen, device=dev) * 0.25,
                       torch.ones(n, device=dev)], 1).contiguous()
    third = torch.nonzero(torch.rand(n, generator=gen, device=dev)
                          < 1 / 3).flatten().to(torch.int32)
    partial = hm.multival_partial(g_mv, b, dev)
    cases = {}
    for mode, ids in (("all rows", None), ("a third", third)):
        out = hm.hist_multival(lay, ghc, b, ids, partial=partial,
                               float64=True)
        ref = hm.hist_multival_plain(lay, ghc, b, ids, float64=True)
        rounded = hm.hist_multival(lay, ghc, b, ids, partial=partial)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if out.dtype != torch.float64 or err != 0.0 \
                or not torch.equal(out.float(), rounded):
            fail(f"hist_multival float64 route ({mode}) off its plain "
                 f"version by {err}, or not the float32 route unrounded")
        nbytes = multival_bytes(lay, ids, b) + g_mv * b * 3 * 4
        cases[mode] = dict(
            rows=n if ids is None else ids.numel(), max_abs_err=err,
            ms=time_ms(lambda: hm.hist_multival(
                lay, ghc, b, ids, partial=partial, float64=True), reps),
            ms_float32=time_ms(lambda: hm.hist_multival(
                lay, ghc, b, ids, partial=partial), reps),
            plain_ms=time_ms(lambda: hm.hist_multival_plain(
                lay, ghc, b, ids, float64=True), 3),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            chunks=hm.child_chunks(n if ids is None else ids.numel(), g_mv))
    print("[check] hist_multival float64 route ok (G_mv "
          f"{g_mv}, K {ds.mv_slots.shape[1]}): " + "; ".join(
              f"{m}: {c['ms']:.4f} ms (float32 route {c['ms_float32']:.4f},"
              f" plain {c['plain_ms']:.3f}, bound {c['bound_ms']:.4f}, "
              f"{c['chunks']} chunks)" for m, c in cases.items()))
    return dict(g_mv=g_mv, k=int(ds.mv_slots.shape[1]), b=b, cases=cases)


def item13_runs(z, local, full, rank, n, iters, dev, Xv, yv):
    """(f) in the rank processes, each run with the launch counts set to 0
    just before it and read just after, rank 0 training the single
    process on the same rows: (i) the Expo one-hot on the data and voting
    learners (every row on each rank, each learner its row block; the
    data recipe's multi-val histograms by the float64 route) and, on rank
    0, the float64 route against its plain version; (ii) extra_trees
    with ``feature_fraction_bynode`` 0.5 on data at 255 bins (the
    rank's ``pre_partition`` rows) and feature at 1023 (every row);
    (iii) regression_l1 under ``pre_partition`` (the latent score as the
    label) on data at 255. Then each config's kernel against plain at
    100k rows (the Expo's first 100k as a subset, which keeps its
    multi-val plan), CUT_PARITY_LEAVES leaves, and the extra_trees
    configs' kernel runs against the same 2-rank runs on the CPU."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.parallel.ingest import host_row_range
    res = {"runs": {}, "single": {}, "parity": {}, "cpu": {}}
    parts = res["part_s"] = {}
    t_part = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    def run(name, params, ds, valid=None, single=False):
        _native.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lt.train(params, ds, iters, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        splits = sum(t.num_leaves - 1 for t in bst.models)
        rec = dict(learner=type(bst._gbdt.learner).__name__, wall_s=wall,
                   ms_per_split=wall / max(splits, 1) * 1e3,
                   launches=dict(_native.LAUNCHES),
                   trees=[par_tree(t) for t in bst.models])
        if valid is not None:
            rec["valid_auc"] = auc(valid[1],
                                   bst.predict(valid[0], raw_score=True))
        (res["single"] if single else res["runs"])[name] = rec
        return bst

    # (i) multi-val
    t0 = time.perf_counter()
    mv, ymv = expo_one_hot(ITEM13_MV_ROWS, 42)
    mvv = expo_one_hot(100_000, 43) if rank == 0 else None
    mvp = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
           "max_bin": 255, "verbosity": -1, "elastic_shutdown": False}
    ds_mv = lt.Dataset(mv, label=ymv, params=mvp)
    binned = ds_mv._construct()
    if not binned.has_multival:
        fail("phase 16 (f): the Expo one-hot plan did not go multi-val")
    res["mv_plan"] = dict(rows=ITEM13_MV_ROWS, columns=int(mv.shape[1]),
                          dense_groups=binned.num_dense_groups,
                          mv_groups=binned.num_groups
                          - binned.num_dense_groups,
                          slots_k=int(binned.mv_slots.shape[1]),
                          bin_s=time.perf_counter() - t0)
    part("mv_data")
    if rank == 0:
        run("multival", dict(mvp, tree_learner="serial"), ds_mv, mvv,
            single=True)
        res["multival_f64"] = check_multival_f64(binned, dev, 10)
    part("mv_single_f64")
    run("multival_data", dict(mvp, tree_learner="data"), ds_mv, mvv)
    run("multival_voting", dict(mvp, tree_learner="voting", top_k=20),
        ds_mv, mvv)
    part("mv_runs")
    # (ii) extra_trees and by-node sampling
    for mb, learner in ((255, "data"), (1023, "feature")):
        p = dict(par_params(learner, mb, n), **ITEM13_EXTRA)
        if rank == 0:
            single = dict(par_params("serial", mb, n), **ITEM13_EXTRA)
            single.pop("pre_partition")
            run(f"extra_{mb}", single, full[mb], (Xv, yv), single=True)
        run(f"extra_{learner}_{mb}", p,
            full[mb] if learner == "feature" else local[mb],
            None if Xv is None else (Xv, yv))
    # (iii) the L1 refit under pre_partition: the latent score as label
    lo, hi = host_row_range(n)
    local[255].set_label(z[lo:hi])
    l1 = dict(par_params("data", 255, n), objective="regression_l1")
    if rank == 0:
        full[255].set_label(z)
        single = dict(l1, tree_learner="serial")
        single.pop("pre_partition")
        run("l1_255", single, full[255], single=True)
    run("l1_data_255", l1, local[255])
    part("extra_l1_runs")
    # kernel against plain, CUT_PARITY_LEAVES leaves, PARITY_ITERS
    # iterations
    Xp, zp = higgs_latent(100_000, seed=3)
    yp = (zp > 0).astype(np.float32)
    plo, phi = host_row_range(len(Xp))
    # the Expo's first 100k rows keep its multi-val plan (a subset is
    # binned with its parent's bins)
    mv_sub = ds_mv.subset(np.arange(100_000))
    cases = {
        "multival_data": (dict(mvp, tree_learner="data"), mv_sub),
        "multival_voting": (dict(mvp, tree_learner="voting", top_k=20),
                            mv_sub),
        "extra_data_255": (dict(par_params("data", 255, len(Xp)),
                                **ITEM13_EXTRA), (Xp[plo:phi], yp[plo:phi])),
        "extra_feature_1023": (dict(par_params("feature", 1023, len(Xp)),
                                    **ITEM13_EXTRA), (Xp, yp)),
        "l1_data_255": (dict(par_params("data", 255, len(Xp)),
                             objective="regression_l1"),
                        (Xp[plo:phi], zp[plo:phi])),
    }
    for name, (p, data) in cases.items():
        p = dict(p, num_leaves=CUT_PARITY_LEAVES)
        ds = data if isinstance(data, lt.Dataset) \
            else lt.Dataset(data[0], label=data[1], params=p)
        kb = lt.train(p, ds, PARITY_ITERS, device=dev)
        pb = lt.train(p, ds, PARITY_ITERS, device=dev, ops="plain")
        res["parity"][name] = trees_bitwise(kb.models, pb.models)
        part(f"parity_{name}")
        if name in ITEM13_CPU_CASES:
            cb = lt.train(p, lt.Dataset(data[0], label=data[1], params=p),
                          PARITY_ITERS, device="cpu")
            res["cpu"][name] = dict(
                kernel=[par_tree(t) for t in kb.models],
                cpu=[par_tree(t) for t in cb.models])
            part(f"cpu_{name}")
    return res


def item13_check(ranks):
    """(f)'s checks on the ranks' records: the ranks grew the same trees;
    the multi-val data run and the L1 refit hold the single process's
    trees (the parity standard; whether to the bit); multi-val voting
    holds its valid AUC; the extra_trees runs (whose draws differ over
    ranks by design, as the JAX learners') hold the same 2-rank run on
    the CPU at the 100k parity rows (the parity standard), their 1M-row
    AUC a diagnostic; every run launched its path's kernels; kernel
    against plain bitwise on every rank."""
    r0 = ranks[0]["item13"]
    out = {"mv_plan": r0["mv_plan"], "runs": {},
           "multival_f64": r0["multival_f64"]}
    paths = {"multival_data": ("hist_rows", "split_scan", "hist_multival"),
             "multival_voting": ("hist_rows", "split_scan",
                                 "hist_multival"),
             "extra_data_255": ("hist_segment", "partition_segment",
                                "split_scan"),
             "extra_feature_1023": ("hist_rows", "split_scan"),
             "l1_data_255": ("hist_segment", "partition_segment",
                             "split_scan")}
    single_of = {"multival_data": "multival", "multival_voting": "multival",
                 "extra_data_255": "extra_255",
                 "extra_feature_1023": "extra_1023",
                 "l1_data_255": "l1_255"}
    for name, kernels in paths.items():
        recs = [rk["item13"]["runs"][name] for rk in ranks]
        r = recs[0]
        single = r0["single"][single_of[name]]
        if any(x["trees"] != r["trees"] for x in recs[1:]):
            fail(f"phase 16 (f) {name}: the ranks grew different trees")
        for k in kernels:
            if any(x["launches"].get(k, 0) <= 0 for x in recs):
                fail(f"phase 16 (f) {name}: kernel {k} was not launched on "
                     "every rank")
        if not all(rk["item13"]["parity"][name] for rk in ranks):
            fail(f"phase 16 (f) {name}: kernel and plain runs grew "
                 "different trees")
        ref = single["trees"]
        exact = len(ref) == len(r["trees"]) and all(
            par_same(a, b, True) for a, b in zip(r["trees"], ref))
        close = len(ref) == len(r["trees"]) and all(
            par_same(a, b, False) for a, b in zip(r["trees"], ref))
        rec = dict(learner=r["learner"], ms_per_split=r["ms_per_split"],
                   single_ms_per_split=single["ms_per_split"],
                   launches=r["launches"], trees_equal_to_the_bit=exact,
                   trees_within_tolerance=close, parity_bitwise=True)
        if name in ("multival_data", "l1_data_255"):
            if not close:
                fail(f"phase 16 (f) {name}: not the single process's trees")
        else:
            rec.update(valid_auc=r["valid_auc"],
                       single_valid_auc=single["valid_auc"])
        if name == "multival_voting" and abs(
                r["valid_auc"] - single["valid_auc"]) > ITEM13_AUC_TOL:
            fail(f"phase 16 (f) {name}: valid AUC {r['valid_auc']} is "
                 f"more than {ITEM13_AUC_TOL} from the single process's "
                 f"{single['valid_auc']}")
        if name in ITEM13_CPU_CASES:
            exact_cpu = close_cpu = True
            for rk in ranks:
                c = rk["item13"]["cpu"][name]
                if len(c["kernel"]) != len(c["cpu"]):
                    fail(f"phase 16 (f) {name}: {len(c['kernel'])} trees on "
                         f"the card, {len(c['cpu'])} on the CPU")
                pairs = list(zip(c["kernel"], c["cpu"]))
                exact_cpu &= all(par_same(a, b, True) for a, b in pairs)
                close_cpu &= all(par_same(a, b, False) for a, b in pairs)
            if not close_cpu:
                fail(f"phase 16 (f) {name}: the card's 2-rank trees are not "
                     "the 2-rank CPU run's (100k rows, "
                     f"{CUT_PARITY_LEAVES} leaves)")
            rec.update(cpu_trees_equal_to_the_bit=exact_cpu,
                       cpu_trees_within_tolerance=close_cpu)
        out["runs"][name] = rec
        print(f"[item13] {name}: {r['learner']} on {PAR_RANKS} ranks, "
              f"{r['ms_per_split']:.4f} ms/split (single "
              f"{single['ms_per_split']:.4f}); trees: to the bit {exact}, "
              f"within tolerance {close}"
              + (f"; valid auc {r['valid_auc']:.6f} (single "
                 f"{rec['single_valid_auc']:.6f})" if "valid_auc" in rec
                 else "")
              + (f"; the 2-rank CPU run's trees (100k rows): to the bit "
                 f"{rec['cpu_trees_equal_to_the_bit']}, within tolerance "
                 f"{rec['cpu_trees_within_tolerance']}"
                 if name in ITEM13_CPU_CASES else "")
              + f"; kernel vs plain bitwise; launches (rank 0) "
              f"{ {k: r['launches'][k] for k in kernels} }")
    return out


def par_same(a, b, exact):
    """Two tree records: the same structure; leaf values equal to the
    bit (``exact``) or within the tests' rtol 2e-4 / atol 2e-6."""
    if a["num_leaves"] != b["num_leaves"] \
            or a["split_feature"] != b["split_feature"] \
            or a["threshold_bin"] != b["threshold_bin"]:
        return False
    x, z = np.asarray(a["leaf_value"]), np.asarray(b["leaf_value"])
    return bool(np.array_equal(x, z) if exact
                else np.allclose(x, z, rtol=2e-4, atol=2e-6))


def parallel_phase(n, iters, dev, limit_s):
    """Phase 16 (ROADMAP Queue 1 item 8): ``PAR_RANKS`` rank processes on
    the one card (gloo, a ``file://`` rendezvous in a temporary
    directory), each on its block of ``n`` Higgs-shaped rows binned from
    the pooled sample; tree_learner=data at max_bin 255 (the segment
    kernels on each rank) and 1023 (hist_rows and the scan), voting
    (top_k 20) at 255 and feature at 1023, each held against the single
    process on the same rows and bins (rank 0 trains it); then each
    learner kernel against plain at 100k rows. Meanwhile this process
    bins every row itself, on the host only, for the ranks' bins to be
    held against."""
    import tempfile
    import lightgbm_tpu_torch as lt
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--world", str(PAR_RANKS), "--rdzv", os.path.join(tmp, "rdzv"),
         "--out", tmp, "--rows", str(n), "--iters", str(iters)])
        for r in range(PAR_RANKS)]
    try:
        X, y = higgs_like(n)
        mappers = {}
        for mb in (255, 1023):
            p = par_params("serial", mb, n)
            p.pop("pre_partition", None)
            ds = lt.Dataset(X, label=y, params=p)
            ds._construct()
            mappers[mb] = [[m.num_bin, list(m.bin_upper_bound)]
                           for m in ds._binned.bin_mappers]
            del ds
        del X, y
        deadline = time.monotonic() + limit_s
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        fail(f"phase 16: the ranks did not finish in {limit_s:.0f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        fail(f"phase 16: a rank failed (exit codes "
             f"{[p.returncode for p in procs]})")
    ranks = []
    for r in range(PAR_RANKS):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for mb in (255, 1023):
        for rk in ranks:
            if rk["mappers"][str(mb)] != mappers[mb]:
                fail(f"phase 16: a rank's bins at {mb} are not the single "
                     "process's")
    out = {"rows": [rk["rows"] for rk in ranks], "bin_s": r0["bin_s"],
           "rank_s": r0["total_s"], "wall_s": wall, "runs": {}}
    data_auc = r0["runs"]["data_255"]["valid_auc"]
    for run, (learner, mb) in PAR_RUNS.items():
        recs = [rk["runs"][run] for rk in ranks]
        r = recs[0]
        single = r0["single"][str(mb)]
        if any(x["trees"] != r["trees"] for x in recs[1:]):
            fail(f"phase 16 {run}: the ranks grew different trees")
        if r["learner"] != PAR_LEARNERS[run] or r["fused"]:
            fail(f"phase 16 {run} ran {r['learner']} (fused {r['fused']})")
        ref = single["trees"]
        exact = len(ref) == len(r["trees"]) and all(
            par_same(a, b, True) for a, b in zip(r["trees"], ref))
        close = len(ref) == len(r["trees"]) and all(
            par_same(a, b, False) for a, b in zip(r["trees"], ref))
        if learner == "voting":
            if abs(r["valid_auc"] - data_auc) > 0.002:
                fail(f"phase 16 voting: valid AUC {r['valid_auc']} is "
                     f"more than 0.002 from the data model's {data_auc}")
        elif not close:
            fail(f"phase 16 {run}: not the single process's trees")
        if not all(rk["parity"][run] for rk in ranks):
            fail(f"phase 16 {run}: kernel and plain runs grew different "
                 "trees")
        on_path = ("hist_segment", "partition_segment", "split_scan") \
            if PAR_LEARNERS[run] == "MeshPartitionedTreeLearner" \
            else ("hist_rows", "split_scan")
        for name in on_path:
            if r["launches"][name] <= 0:
                fail(f"phase 16 {run}: kernel {name} was not launched")
        splits = max(r["splits"], 1)
        rec = dict(
            learner=r["learner"], ms_per_split=r["ms_per_split"],
            single_ms_per_split=single["ms_per_split"],
            collectives_per_split={k: v / splits
                                   for k, v in r["calls"].items()},
            bytes_per_split={k: v / splits for k, v in r["bytes"].items()},
            launches=r["launches"], valid_auc=r["valid_auc"],
            single_valid_auc=single["valid_auc"],
            trees_equal_to_the_bit=exact, trees_within_tolerance=close,
            parity_bitwise=True)
        out["runs"][run] = rec
        print(f"[parallel] {run}: {r['learner']} on {PAR_RANKS} ranks, "
              f"{r['splits']} splits, {r['ms_per_split']:.4f} ms/split "
              f"(single process per-phase {single['ms_per_split']:.4f}); "
              f"collectives a split {rec['collectives_per_split']}, bytes "
              f"a split {rec['bytes_per_split']}; valid auc "
              f"{r['valid_auc']:.6f} (single {single['valid_auc']:.6f}); "
              f"trees: to the bit {exact}, within tolerance {close}; "
              f"kernel vs plain bitwise; launches (rank 0) {r['launches']}")
    print(f"[parallel] ranks: binning {r0['bin_s']:.1f} s, rank 0 in all "
          f"{r0['total_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in r0["part_s"].items())
          + " s); the bins of every rank equal this process's on every "
          "row")
    # (f) item 13 over the ranks, (e) the elastic drill
    out["item13"] = item13_check(ranks)
    out["item13_s"] = r0["item13_s"]
    print(f"[item13] (f) in the ranks {r0['item13_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in
                      r0["item13"]["part_s"].items()) + " s)")
    t1 = time.perf_counter()
    try:
        out["drill"] = drill_phase(tmp, n, [rk["drill"] for rk in ranks])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["drill"]["references_s"] = r0["drill_s"]
    out["drill_s"] = time.perf_counter() - t1 + r0["drill_s"]
    print(f"[drill] (e) {out['drill_s']:.1f} s (the references in the ranks "
          f"{r0['drill_s']:.1f} s, the legs {time.perf_counter() - t1:.1f} "
          "s)")
    return out


# ---- phase 18: the robustness and observability planes ---------------

# the drill of (b) and (d): a NaN gradient rolled back to the last
# checkpoint, then a preemption; the second call resumes
PLANES_DRILL = "nan_grad@iteration=3;sigterm@iteration=5"
# (d)'s drill on PARITY_ITERS + 2 iterations (the faults must fire)
PLANES_PARITY_DRILL = "nan_grad@iteration=1;sigterm@iteration=2"


def planes_text(bst):
    """The model text up to its ``parameters:`` section (which records
    the plane params)."""
    return bst.model_to_string().split("parameters:")[0]


def timed_checkpoints():
    """Wrap ``CheckpointManager.save`` to count its writes and sum their
    wall ms (host clock around each save); returns the record and an
    undo."""
    from lightgbm_tpu_torch.robustness.checkpoint import CheckpointManager
    orig = CheckpointManager.save
    rec = {"writes": 0, "ms": 0.0}

    def save(self, *a, **kw):
        t0 = time.perf_counter()
        out = orig(self, *a, **kw)
        if out is not None:
            rec["writes"] += 1
            rec["ms"] += (time.perf_counter() - t0) * 1e3
        return out
    CheckpointManager.save = save

    def undo():
        CheckpointManager.save = orig
    return rec, undo


def planes_train(params, tr, va, iters, dev, ops="kernel", callbacks=None):
    """``lt.train`` with the valid set, the host clock around it
    (synchronised); returns the booster, its seconds and its splits."""
    import torch
    import lightgbm_tpu_torch as lt
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    bst = lt.train(params, tr, iters, valid_sets=[va], valid_names=["v"],
                   verbose_eval=False, callbacks=callbacks, device=dev,
                   ops=ops)
    sync()
    wall = time.perf_counter() - t0
    return bst, wall, sum(t.num_leaves - 1 for t in bst.models)


def planes_drill(params, tr, va, iters, dev, ckpt, drill, ops="kernel"):
    """The drill: a first call that must come back preempted, then a
    second that resumes; returns both boosters."""
    from lightgbm_tpu_torch.observability.telemetry import get_telemetry
    from lightgbm_tpu_torch.robustness.faults import set_fault_plan
    p = dict(params, checkpoint_dir=ckpt, guard_policy="rollback",
             faults=drill)
    tel = get_telemetry()
    tel.ensure_ring()
    before = dict(tel.counters)
    first, _, _ = planes_train(p, tr, va, iters, dev, ops)
    set_fault_plan(None)
    if not first.preempted:
        fail(f"phase 18: the drill ({drill}) did not preempt")
    second, _, _ = planes_train(dict(p, faults=""), tr, va, iters, dev, ops)
    counts = {k: tel.counters.get(k, 0.0) - before.get(k, 0.0)
              for k in ("guard.rollbacks", "checkpoint.restores",
                        "checkpoint.writes", "faults.injected")}
    return first, second, counts


def trace_kernels(path):
    """The device kernels' names and count in a torch.profiler Chrome
    trace."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    return [e.get("name", "") for e in events
            if e.get("cat") == "kernel"]


def planes_phase(X, y, binned, dev, iters):
    """Phase 18: the robustness and observability planes at full width
    (2M x 28, 255 leaves, max_bin 255, lr 0.1, ``iters`` rounds, a
    500k-row valid set; phase 2's bins). (a) a plain run against one
    with ``checkpoint_dir`` (freq 2), ``guard_policy=raise`` and
    ``guard_loss_spike=10``: the texts byte-equal up to ``parameters:``;
    (b) the drill (``PLANES_DRILL`` under ``guard_policy=rollback``):
    preempted, then resumed, byte-equal to (a); (c) telemetry, the span
    trace and the profiler window: ``iters`` iter records whose
    ``launch.*`` equal the iteration's launch deltas, one phase_probe
    record, the probe's own launches, a device trace holding
    ``csrc/split_step_segment.cu``'s kernel, and the serial learner's
    probe (``hist_rows``); (d) the drill at 100k x 28, 63 leaves,
    max_bin 255 and 1023, kernel against plain, the texts equal."""
    import tempfile
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.learner import SerialTreeLearner
    from lightgbm_tpu_torch.observability import get_tracer
    from lightgbm_tpu_torch.observability.probe import run_phase_probe
    from lightgbm_tpu_torch.observability.telemetry import get_telemetry
    from lightgbm_tpu_torch.ops import _native
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="planes_")
    params = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
              "max_bin": 255, "verbosity": -1}
    tr = lt.Dataset(X, label=y)
    tr._binned = binned
    Xv, yv = higgs_like(500_000, seed=43)
    va = tr.create_valid(Xv, label=yv)
    va._construct(lt.Config.from_params(params))
    out = {"valid_bin_s": round(time.perf_counter() - t0, 2)}

    # (a) no number changes
    plain, wall_p, splits_p = planes_train(params, tr, va, iters, dev)
    ck = os.path.join(tmp, "a")
    rec, undo = timed_checkpoints()
    try:
        guarded, wall_g, splits_g = planes_train(
            dict(params, checkpoint_dir=ck, checkpoint_freq=2,
                 guard_policy="raise", guard_loss_spike=10.0),
            tr, va, iters, dev)
    finally:
        undo()
    if planes_text(plain) != planes_text(guarded):
        fail("phase 18 (a): the checkpointed, guarded run's trees differ "
             "from the plain run's")
    kept = sorted(os.listdir(ck))
    last = os.path.join(ck, kept[-1])
    sizes = {f: os.path.getsize(os.path.join(last, f))
             for f in os.listdir(last)}
    out["a"] = {
        "ms_split_plain": round(wall_p * 1e3 / splits_p, 4),
        "ms_split_planes": round(wall_g * 1e3 / splits_g, 4),
        "checkpoint_writes": rec["writes"],
        "checkpoint_ms": round(rec["ms"] / max(rec["writes"], 1), 2),
        "checkpoint_bytes": sum(sizes.values()),
        "state_npz_mb": round(sizes["state.npz"] / 2**20, 2),
        "kept": kept, "equal": True}
    print(f"[phase 18 a] ms/split plain {out['a']['ms_split_plain']}, with "
          f"checkpoint_dir + guards {out['a']['ms_split_planes']}; "
          f"{rec['writes']} checkpoint writes, "
          f"{out['a']['checkpoint_ms']} ms and {sum(sizes.values())} "
          f"bytes a write (state.npz {out['a']['state_npz_mb']} MB); "
          f"texts equal")
    del guarded
    torch.cuda.empty_cache()

    # (b) the drill: rollback, preemption, resume
    first, second, counts = planes_drill(
        dict(params, checkpoint_freq=2, guard_loss_spike=10.0), tr, va,
        iters, dev, os.path.join(tmp, "b"), PLANES_DRILL)
    if planes_text(second) != planes_text(plain):
        fail("phase 18 (b): the resumed run's trees differ from (a)'s")
    if counts["guard.rollbacks"] != 1 or counts["checkpoint.restores"] < 2:
        fail(f"phase 18 (b): unexpected drill counters {counts}")
    out["b"] = dict(counts, preempted_at=first._gbdt.iter,
                    resumed_iteration=second.resumed_iteration, equal=True)
    print(f"[phase 18 b] drill {PLANES_DRILL}: preempted after iteration "
          f"{first._gbdt.iter - 1}, guard.rollbacks "
          f"{counts['guard.rollbacks']}, checkpoint.restores "
          f"{counts['checkpoint.restores']}, resumed at iteration "
          f"{second.resumed_iteration}; texts equal to (a)")
    del first, second
    get_telemetry().reset()
    torch.cuda.empty_cache()

    # (c) telemetry, trace, profiler window, probe
    # telemetry alone (its probe off, so the wall is the loop's) between
    # two runs with telemetry off
    tel_only = os.path.join(tmp, "tel_only.jsonl")
    walls = {"off": [], "on": []}
    for mode in ("off", "on", "off"):
        p = dict(params, telemetry_out=tel_only) if mode == "on" \
            else params
        os.environ["LGBM_TPU_TELEMETRY_NO_PROBE"] = "1"
        try:
            b_tel, wall_t, splits_t = planes_train(p, tr, va, iters, dev)
        finally:
            del os.environ["LGBM_TPU_TELEMETRY_NO_PROBE"]
        get_telemetry().reset()
        walls[mode].append(round(wall_t * 1e3 / splits_t, 4))
        if planes_text(b_tel) != planes_text(plain):
            fail(f"phase 18 (c): the run with telemetry {mode} grew "
                 "other trees")
        del b_tel
    jl = os.path.join(tmp, "tel.jsonl")
    prof_dir = os.path.join(tmp, "prof")
    snaps = []

    def snap(env):
        snaps.append(dict(_native.LAUNCHES))
    snap.order = 30
    _native.reset_launch_counts()
    b_c, wall_c, splits_c = planes_train(
        dict(params, telemetry_out=jl, trace_out=os.path.join(tmp,
                                                              "trace.json"),
             profile_dir=prof_dir), tr, va, iters, dev, callbacks=[snap])
    after = dict(_native.LAUNCHES)
    get_telemetry().flush()
    if planes_text(b_c) != planes_text(plain):
        fail("phase 18 (c): the run with telemetry, trace and profiler "
             "grew other trees")
    with open(jl) as fh:
        recs = [json.loads(line) for line in fh]
    iter_recs = [r for r in recs if r["kind"] == "iter"]
    if len(iter_recs) != iters:
        fail(f"phase 18 (c): {len(iter_recs)} iter records, not {iters}")
    prev = {k: 0 for k in _native.LAUNCHES}
    per_iter = []
    for r, s in zip(iter_recs, snaps):
        counts = r.get("counts", {})
        for k in _native.LAUNCHES:
            if counts.get(f"launch.{k}", -1) != s[k] - prev[k]:
                fail(f"phase 18 (c): iteration {r['iter']} launch.{k} "
                     f"{counts.get(f'launch.{k}')} against the launch "
                     f"counter's delta {s[k] - prev[k]}")
        launched = sum(s[k] - prev[k] for k in _native.LAUNCHES)
        if counts.get("host.dispatches", 0) < launched:
            fail(f"phase 18 (c): iteration {r['iter']} host.dispatches "
                 f"{counts.get('host.dispatches')} below its {launched} "
                 "launches")
        per_iter.append(counts["launch.fused_split_step_segment"])
        prev = s
    probe = [r for r in recs if r["kind"] == "phase_probe"]
    if len(probe) != 1 or set(probe[0]["phases"]) != {
            "grad", "update", "hist", "partition", "split"}:
        fail(f"phase 18 (c): phase_probe records {probe}")
    probe_launches = {k: after[k] - prev[k] for k in _native.LAUNCHES
                      if after[k] != prev[k]}
    for k in ("hist_segment", "partition_segment", "split_scan"):
        if probe_launches.get(k, 0) <= 0:
            fail(f"phase 18 (c): the probe did not launch {k}")
    files = [f for f in os.listdir(prof_dir) if f.endswith(".json")] \
        if os.path.isdir(prof_dir) else []
    names = trace_kernels(os.path.join(prof_dir, files[0])) if files else []
    seg = sum(1 for nm in names if "split_step_kernel" in nm)
    if not seg:
        fail("phase 18 (c): the profiler window's trace holds no kernel "
             "of csrc/split_step_segment.cu")
    spans = sorted({e["name"] for e in get_tracer().events
                    if e.get("ph") == "X"})
    # the serial learner's probe on the same bins: hist_rows (row 8)
    lrn = SerialTreeLearner(binned, b_c._gbdt.config, dev)
    part_learner = b_c._gbdt.learner
    b_c._gbdt.learner = lrn
    _native.reset_launch_counts()
    serial_probe = run_phase_probe(b_c._gbdt)
    serial_launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    b_c._gbdt.learner = part_learner
    if not serial_probe or serial_launches.get("hist_rows", 0) <= 0:
        fail(f"phase 18 (c): the serial probe {serial_probe} launched "
             f"{serial_launches}")
    out["c"] = {
        "ms_split_telemetry_off": walls["off"],
        "ms_split_telemetry": walls["on"][0],
        "ms_split_telemetry_trace_profile": round(wall_c * 1e3 / splits_c,
                                                  4),
        "iter_records": len(iter_recs),
        "launch_fused_split_step_segment": per_iter,
        "probe_ms": {k: round(v * 1e3, 4)
                     for k, v in probe[0]["phases"].items()},
        "probe_launches": probe_launches,
        "serial_probe_ms": {k: round(v * 1e3, 4)
                            for k, v in serial_probe.items()},
        "serial_probe_launches": serial_launches,
        "profiled_segment_kernels": seg, "profiled_kernels": len(names),
        "spans": spans,
        "records": sorted({r["kind"] for r in recs})}
    print(f"[phase 18 c] ms/split telemetry off "
          f"{out['c']['ms_split_telemetry_off']}, telemetry on "
          f"{out['c']['ms_split_telemetry']}, with trace and profiler "
          f"window {out['c']['ms_split_telemetry_trace_profile']}; "
          f"{len(iter_recs)} iter records, launch.fused_split_step_segment "
          f"{per_iter} (= the launch counter's deltas); probe ms "
          f"{out['c']['probe_ms']} launches {probe_launches}; serial probe "
          f"ms {out['c']['serial_probe_ms']} launches {serial_launches}; "
          f"profiler trace: {seg} split_step_kernel of {len(names)} "
          f"kernels; spans {spans}")
    del b_c, lrn, part_learner, plain
    get_telemetry().reset()
    get_tracer().reset()
    torch.cuda.empty_cache()

    # (d) the drill, kernels against plain versions, at 100k rows
    Xp, yp = higgs_like(100_000, seed=3)
    Xpv, ypv = higgs_like(20_000, seed=4)
    out["d"] = {}
    for max_bin in (255, 1023):
        pp = dict(params, max_bin=max_bin, num_leaves=63)
        texts = {}
        for ops in ("kernel", "plain"):
            trp = lt.Dataset(Xp, label=yp)
            vap = trp.create_valid(Xpv, label=ypv)
            first, second, counts = planes_drill(
                dict(pp, checkpoint_freq=1), trp, vap, PARITY_ITERS + 2,
                dev, os.path.join(tmp, f"d{max_bin}{ops}"),
                PLANES_PARITY_DRILL, ops=ops)
            texts[ops] = planes_text(second)
            if counts["guard.rollbacks"] != 1:
                fail(f"phase 18 (d): {ops} drill counters {counts}")
        if texts["kernel"] != texts["plain"]:
            fail(f"phase 18 (d): the drill's kernel and plain texts differ "
                 f"at max_bin {max_bin}")
        out["d"][str(max_bin)] = "equal"
        print(f"[phase 18 d] drill {PLANES_PARITY_DRILL} at 100000 x {F}, "
              f"63 leaves, max_bin {max_bin}, {PARITY_ITERS + 2} "
              f"iterations: kernel and plain texts equal")
    shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---- phase 19: serving on the card ------------------------------------

SERVING_BUCKETS = (1, 8, 64, 512)
SERVING_KINDS = {"predict": {}, "raw_score": {"raw_score": True},
                 "pred_leaf": {"pred_leaf": True}}
SERVING_ROWS = 4096          # the requests' rows: the 2M matrix's first
SERVING_REPS = 10            # CUDA-event repetitions a bucket


class ServeRecorder:
    """A ServingEngine as the load generator drives it, keeping every
    request's rows and future, and the source of every version a reload
    made, so the loops' responses are held against ``Booster.predict``
    after the loop."""

    def __init__(self, eng):
        import threading
        self.eng, self.config = eng, eng.config
        self.lock = threading.Lock()
        self.log = []
        self.sources = {}

    def stats(self):
        return self.eng.stats()

    def submit(self, rows, kind="predict", timeout_ms=None):
        fut = self.eng.submit(rows, kind=kind, timeout_ms=timeout_ms)
        with self.lock:
            self.log.append((rows, kind, fut))
        return fut

    def predict(self, rows, kind="predict", timeout_ms=None):
        return self.submit(rows, kind, timeout_ms).result(timeout=60.0)

    def reload(self, source):
        version = self.eng.reload(source)
        with self.lock:
            self.sources[version] = source
        return version


def serving_responses_equal(rec, refs, label):
    """Every response in ``rec.log`` against its version's reference
    booster: rows grouped by (version, kind), one ``predict`` of the
    group's rows (rows are independent), compared to the bit."""
    groups = {}
    for rows, kind, fut in rec.log:
        out = fut.result(timeout=60.0)
        key = (fut.meta["version"], kind)
        groups.setdefault(key, ([], []))
        groups[key][0].append(rows)
        groups[key][1].append(out)
    for (version, kind), (rows, outs) in groups.items():
        ref = refs[version].predict(np.concatenate(rows),
                                    **SERVING_KINDS[kind])
        if np.concatenate(outs).tobytes() != ref.tobytes():
            fail(f"phase 19 {label}: a {kind} response of version "
                 f"{version} is not Booster.predict of its rows")
    return sum(len(r) for r, _ in groups.values())


def serving_programs(label, eng, bst, Xr, card):
    """Each (bucket, kind) program of the engine's current version:
    its replay equal to ``Booster.predict`` and to the eager walk of the
    same static inputs, to the bit; for ``predict``, the replay's and
    the eager walk's ms (CUDA events); then a 700-row request (chunked
    512 + 188) of every kind."""
    mv = eng.registry.current()
    if sorted(mv.programs) != sorted(
            (b, k) for b in SERVING_BUCKETS for k in SERVING_KINDS):
        fail(f"phase 19 {label}: warmup captured {sorted(mv.programs)}")
    out = {}
    for (b, kind), prog in sorted(mv.programs.items()):
        if prog.graph is None:
            fail(f"phase 19 {label}: bucket {b} {kind} has no CUDA graph")
        got = prog.run(Xr[:b])
        eager = prog._body()[:b].cpu().numpy()
        ref = bst.predict(Xr[:b], **SERVING_KINDS[kind])
        if not got.tobytes() == eager.tobytes() == ref.tobytes():
            fail(f"phase 19 {label}: bucket {b} {kind}: the replay, the "
                 "eager walk and Booster.predict differ")
        if kind == "predict":
            out[b] = {"replay_ms": time_ms(prog.graph.replay, SERVING_REPS),
                      "eager_ms": time_ms(prog._body, SERVING_REPS)}
    for kind, kw in SERVING_KINDS.items():
        if eng.predict(Xr[:700], kind=kind).tobytes() \
                != bst.predict(Xr[:700], **kw).tobytes():
            fail(f"phase 19 {label}: the chunked 700-row {kind} request "
                 "is not Booster.predict")
    print(f"[phase 19 {label}] {card}: v{mv.version} {mv.num_trees} trees "
          f"(k {mv.k}), {len(mv.programs)} graphs captured in "
          f"{eng.stats()['warmup_s']:.3f} s; replay against the eager walk "
          "(predict, ms a call, CUDA events): "
          + ", ".join(f"bucket {b} {r['replay_ms']:.4f} / "
                      f"{r['eager_ms']:.4f}" for b, r in out.items()))
    return {"trees": mv.num_trees, "k": mv.k,
            "warmup_s": eng.stats()["warmup_s"], "buckets": out}


def loop_line(label, block, stats, card):
    errors = block.get("errors", block.get("non_shed_errors"))
    print(f"[phase 19 {label}] {card}: {block['requests']} requests, "
          f"{block['rows']} rows in {block['duration_s']} s: "
          f"{block['throughput_rps']} req/s, {block['rows_per_s']} rows/s, "
          f"p50 {block['p50_ms']} ms, p95 {block['p95_ms']} ms, p99 "
          f"{block['p99_ms']} ms; errors {errors}, shed {block['shed']}; "
          f"engine: queue peak {stats['queue_peak']}, bucket hit rate "
          f"{stats['bucket_hit_rate']}")


def serving_flood(bst, Xr, dev):
    """Past ``max_queue`` (2) with the flusher off, under each shed
    policy: structured QueueFullErrors, and the queued requests served
    once the flusher starts."""
    from lightgbm_tpu_torch.serving import (QueueFullError, ServingConfig,
                                            ServingEngine)
    out = {}
    for policy in ("reject_new", "drop_oldest"):
        eng = ServingEngine(bst, config=ServingConfig(
            buckets=(8,), warmup=False, max_queue=2, shed_policy=policy,
            device="always", fallback_to_host=False), auto_start=False,
            device=dev)
        try:
            futs, shed = [], 0
            for i in range(10):
                try:
                    futs.append((i, eng.submit(Xr[i:i + 1], timeout_ms=0)))
                except QueueFullError as e:
                    if e.to_dict()["error"] != "queue_full" \
                            or e.http_status != 429:
                        fail(f"phase 19 flood: {e.to_dict()}")
                    shed += 1
            eng.start()
            served = 0
            for i, f in futs:
                try:
                    got = f.result(timeout=60.0)
                except QueueFullError:
                    shed += 1
                    continue
                if got.tobytes() != bst.predict(Xr[i:i + 1]).tobytes():
                    fail("phase 19 flood: a queued response is wrong")
                served += 1
            if served != 2 or shed != 8 or eng.stats()["shed"] != 8:
                fail(f"phase 19 flood {policy}: served {served}, shed "
                     f"{shed}")
            out[policy] = {"served": served, "shed": shed}
        finally:
            eng.stop()
    return out


def serving_http(eng, bst, Xr, text_a):
    """``make_http_server`` on 127.0.0.1:0: each endpoint once, ``/slo``
    after an SLO engine over the engine's counters sampled and
    evaluated."""
    import threading
    import urllib.request
    from lightgbm_tpu_torch.observability.slo import SLOEngine
    from lightgbm_tpu_torch.serving.http import make_http_server
    server = make_http_server(eng, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def call(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=data,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = r.read().decode()
            return r.status, body

    out = {}
    try:
        for kind, kw in SERVING_KINDS.items():
            status, body = call(f"/{kind}", {"rows": Xr[:5].tolist()})
            got = np.asarray(json.loads(body)["predictions"])
            ref = bst.predict(Xr[:5], **kw)
            if status != 200 or not np.array_equal(got, ref):
                fail(f"phase 19 http /{kind}: {status}")
        for path in ("/health", "/stats", "/metrics"):
            status, body = call(path)
            if status != 200:
                fail(f"phase 19 http {path}: {status}")
        out["health"] = json.loads(call("/health")[1])["status"]
        slo = SLOEngine(counts_fn=eng.stats, windows=["1m", "5m"])
        slo.sample()
        slo.evaluate()
        status, body = call("/slo")
        rep = json.loads(body)
        if status != 200 or not rep["enabled"] or not rep["last"]["slos"]:
            fail(f"phase 19 http /slo: {body[:200]}")
        out["slo_max_burn"] = rep["last"]["max_burn"]
        status, body = call("/reload", {"model_str": text_a})
        if status != 200 or json.loads(body)["status"] != "ok":
            fail(f"phase 19 http /reload: {body[:200]}")
        out["reload_version"] = json.loads(body)["version"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    return out


def serving_phase(models, X, dev, card):
    """Phase 19: serving on the card. (a) phase 3's full-width fused
    binary model from its Booster, (b) phase 6's quality model published
    as model text with its AOT artifact, (c) phase 9 (c)'s 5-class model;
    each warmed on ``ServingConfig(buckets=(1, 8, 64, 512),
    device="always", fallback_to_host=False)``: its programs' replays
    bitwise the eager walk and ``Booster.predict`` (and a chunked 700-row
    request), timed against the eager walk. On (a): bench.py's closed
    loop, a 200 qps open loop, a 3 s soak with a hot reload every 0.5 s
    between (a) and (b), a torn model file on reload, a flood past
    ``max_queue`` under both shed policies and the HTTP frontend; every
    response of the loops bitwise ``Booster.predict`` of its rows; no
    capture after warmup, no fallback, no failed artifact attach."""
    import tempfile
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.serving import (ModelLoadError, ServingConfig,
                                            ServingEngine, loadgen)
    from lightgbm_tpu_torch.serving.aot import build_artifact
    t_phase = time.perf_counter()
    Xr = np.ascontiguousarray(X[:SERVING_ROWS], np.float64)
    cfg = ServingConfig(buckets=SERVING_BUCKETS, device="always",
                        fallback_to_host=False)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    out = {}
    engines = []
    try:
        text_a = models["a"].model_to_string()
        text_b = models["b"].model_to_string()
        t0 = time.perf_counter()
        art_b = build_artifact(models["b"], text_b, buckets=SERVING_BUCKETS,
                               out_dir=tmp, device=dev)
        out["artifact_s"] = time.perf_counter() - t0
        refs = {"a": models["a"], "b": lt.Booster(model_str=text_b,
                                                  device=dev),
                "c": models["c"]}
        eng = {}
        for name in ("a", "b", "c"):
            eng[name] = ServingEngine(config=cfg, device=dev)
            engines.append(eng[name])
            if name == "b":
                eng[name].load(text_b, aot=art_b)
            else:
                eng[name].load(models[name])
            out[name] = serving_programs(name, eng[name], refs[name], Xr,
                                         card)
        if eng["b"].stats().get("aot_attach") != 1 \
                or not eng["b"].registry.current().describe()["aot"]:
            fail("phase 19 b: the AOT artifact was not attached")
        ea = eng["a"]
        captures = ea.stats()["graph_captures"]
        rec = ServeRecorder(ea)
        rec.sources[1] = models["a"]
        out["closed"] = loadgen.serving_block(rec, Xr, batch_sizes=(1, 64),
                                              threads=2, duration_s=2.0)
        loop_line("closed", out["closed"], ea.stats(), card)
        out["open"] = loadgen.open_loop(rec, Xr, qps=200.0, duration_s=2.0)
        loop_line("open", out["open"], ea.stats(), card)
        for block in ("closed", "open"):
            if out[block]["errors"]:
                fail(f"phase 19 {block}: {out[block]['errors']} errors")
        out["soak"] = loadgen.soak_loop(
            rec, Xr, duration_s=3.0, qps=100.0, reload_every_s=0.5,
            reload_sources={"b": text_b, "a": models["a"]})
        loop_line("soak", out["soak"], ea.stats(), card)
        soak = out["soak"]
        if soak["non_shed_errors"] or soak["shed"] or soak["reloads"] < 2 \
                or soak["reload_failures"]:
            fail(f"phase 19 soak: {json.dumps(soak)}")
        vrefs = {v: refs["b"] if isinstance(src, str) else refs["a"]
                 for v, src in rec.sources.items()}
        out["responses_checked"] = serving_responses_equal(rec, vrefs,
                                                           "loops")
        # a torn model file: degraded, the old version keeps serving
        torn = os.path.join(tmp, "torn.txt")
        with open(torn, "w") as fh:
            fh.write(text_a[:len(text_a) // 2])
        version = ea.version
        try:
            ea.reload(torn)
            fail("phase 19: a torn model file loaded")
        except ModelLoadError:
            pass
        health = ea.health()
        if health["status"] != "degraded" or ea.version != version \
                or ea.predict(Xr[:3]).tobytes() \
                != vrefs[version].predict(Xr[:3]).tobytes():
            fail(f"phase 19: after a torn reload {health['status']}")
        out["torn_reload"] = health["status"]
        out["flood"] = serving_flood(models["a"], Xr, dev)
        out["http"] = serving_http(ea, refs["a"], Xr, text_a)
        st = ea.stats()
        loads = 1 + st["reloads"]
        if st["graph_captures"] != captures * loads:
            fail(f"phase 19: {st['graph_captures']} graph captures for "
                 f"{loads} loads of {captures} programs each: a capture "
                 "after warmup")
        for name, e in eng.items():
            s = e.stats()
            if s["fallbacks"] or s.get("aot_attach_failures", 0):
                fail(f"phase 19 {name}: fallbacks {s['fallbacks']}, AOT "
                     f"attach failures {s.get('aot_attach_failures')}")
        out["stats_a"] = {k: st[k] for k in (
            "requests", "rows", "batches", "reloads", "bucket_hits",
            "bucket_misses", "bucket_hit_rate", "queue_peak",
            "graph_captures", "graph_replays", "fallbacks")}
        print(f"[phase 19 counts] {card}: engine a {json.dumps(out['stats_a'])}"
              f"; loads {loads} x {captures} programs = "
              f"{st['graph_captures']} captures, none after warmup")
    finally:
        for e in engines:
            e.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[phase 19] {card}: {out['seconds']:.1f} s")
    return out


# ---- phase 20: the fleets on the card ---------------------------------

FLEET_SIZES = (1, 7, 64, 300, 700)   # (a)'s bitwise request sizes
FLEET_CANARY = 400                   # requests of the 0.25 canary
FLEET_SHADOW = 50                    # requests mirrored to the shadow
FLEET_TENANT_QPS = 50.0              # the shed tenant's rate and burst
FLEET_WAIT_S = 90.0                  # a respawn's bound


class FleetRecorder:
    """A fleet as the load generator drives it (every other attribute is
    the fleet's), keeping every request's rows, kind and future, so that
    the loops' responses are held against ``Booster.predict`` of their
    target after the loop."""

    def __init__(self, fl):
        import threading
        self._fl = fl
        self._lock = threading.Lock()
        self.log = []

    def __getattr__(self, name):
        return getattr(self._fl, name)

    def submit(self, rows, kind="predict", timeout_ms=None, model=None,
               tenant="default"):
        fut = self._fl.submit(rows, kind=kind, timeout_ms=timeout_ms,
                              model=model, tenant=tenant)
        with self._lock:
            self.log.append((rows, kind, fut))
        return fut


def fleet_responses_equal(log, refs, label, phase="phase 20"):
    """Every (rows, kind, future) of ``log`` against ``Booster.predict``
    of its target model: rows grouped by (target, kind), one predict a
    group, compared to the bit. Returns the responses checked."""
    groups = {}
    for rows, kind, fut in log:
        out = fut.result(timeout=60.0)
        key = (fut.meta["target"], kind)
        groups.setdefault(key, ([], []))
        groups[key][0].append(rows)
        groups[key][1].append(out)
    for (target, kind), (rows, outs) in groups.items():
        ref = refs[target].predict(np.concatenate(rows),
                                   **SERVING_KINDS[kind])
        if np.concatenate(outs).tobytes() != ref.tobytes():
            fail(f"{phase} {label}: a {kind} response of {target} is not "
                 "Booster.predict of its rows")
    return sum(len(o) for _, o in groups.values())


def fleet_captures(fl):
    """The CUDA graphs the thread fleet's engines captured."""
    return sum(r._captures() for r in fl.replicas)


def fleet_wait(cond, label, timeout=FLEET_WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    fail(f"phase 20 {label}: not within {timeout:.0f} s")


def fleet_bitwise(fl, refs, Xr, sizes, label):
    for n in sizes:
        for model, ref in refs.items():
            for kind, kw in SERVING_KINDS.items():
                got = fl.predict(Xr[:n], kind=kind, model=model)
                if got.tobytes() != ref.predict(Xr[:n], **kw).tobytes():
                    fail(f"phase 20 {label}: {model} {kind} at {n} rows is "
                         "not Booster.predict")
    return len(sizes) * len(refs) * len(SERVING_KINDS)


def fleet_kill_under_load(fl, refs, Xr):
    """Two closed-loop threads on alpha; a replica killed under them: no
    request lost, none answered twice."""
    import threading
    before = fl.stats()
    log, errors = [], []
    stop = threading.Event()

    def worker(tid):
        i = tid
        while not stop.is_set():
            lo = (i * 37) % (len(Xr) - 4)
            i += 2
            try:
                fut = fl.submit(Xr[lo:lo + 4], model="alpha")
                fut.result(timeout=60.0)
            except Exception as e:   # surfaced below
                errors.append(repr(e))
                return
            log.append((Xr[lo:lo + 4], "predict", fut))
    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.4)
    victim = [r.rid for r in fl.replicas if r.state == "ok"][0]
    fl.kill_replica(victim)
    time.sleep(0.6)
    stop.set()
    for t in threads:
        t.join(60.0)
    if errors:
        fail(f"phase 20 kill: {errors[:3]}")
    after = fl.stats()
    requests = after["requests"] - before["requests"]
    redispatched = after.get("redispatches", 0) \
        - before.get("redispatches", 0)
    served = after["engine_totals"]["requests"] \
        - before["engine_totals"]["requests"]
    if requests != len(log) or served != requests + redispatched \
            or after["errors"] != before["errors"]:
        fail(f"phase 20 kill: {len(log)} answered, fleet requests "
             f"{requests}, engine requests {served}, redispatches "
             f"{redispatched}, errors {after['errors']}")
    fleet_responses_equal(log, refs, "kill")
    return {"victim": victim, "requests": requests,
            "redispatches": redispatched, "lost": 0, "duplicates": 0}


def fleet_thread(texts, refs, Xr, dev, card, fleets):
    """(a) the thread fleet: 2 replicas sharing each version's graphs."""
    from lightgbm_tpu_torch.serving import (FleetEngine, QuotaExceededError,
                                            ServingConfig, TenantQuotas,
                                            loadgen)
    cfg = ServingConfig(buckets=SERVING_BUCKETS, device="always",
                        fallback_to_host=False)
    out = {}
    t0 = time.perf_counter()
    fl = FleetEngine(config=cfg, replicas=2, default_model="alpha",
                     device=dev, quotas=TenantQuotas(tenants={
                         "t50": (FLEET_TENANT_QPS, FLEET_TENANT_QPS)}))
    fleets.append(fl)
    for name in ("alpha", "beta"):
        fl.load_model(name, texts[name])
    out["load_s"] = time.perf_counter() - t0
    out["captures_at_load"] = fleet_captures(fl)
    out["bitwise_requests"] = fleet_bitwise(fl, refs, Xr, FLEET_SIZES,
                                            "thread")
    # a canary at 0.25: exactly a quarter of alpha's traffic to beta
    fl.router.set_canary("alpha", "beta", 0.25)
    log = [(Xr[i:i + 1], "predict", fl.submit(Xr[i:i + 1], model="alpha"))
           for i in range(FLEET_CANARY)]
    fleet_responses_equal(log, refs, "canary")
    to_beta = sum(f.meta["target"] == "beta" for _, _, f in log)
    if to_beta != FLEET_CANARY // 4:
        fail(f"phase 20 canary: {to_beta} of {FLEET_CANARY} to beta")
    fl.router.set_canary("alpha", None, 0.0)
    out["canary"] = {"requests": FLEET_CANARY, "to_beta": to_beta}
    # a shadow of alpha to the same text under a second name: compared,
    # never returned
    fl.load_model("alpha_shadow", texts["alpha"])
    fl.router.set_shadow("alpha", "alpha_shadow")
    log = [(Xr[i:i + 2], "predict", fl.submit(Xr[i:i + 2], model="alpha"))
           for i in range(FLEET_SHADOW)]
    fleet_responses_equal(log, refs, "shadow")
    if any(f.meta["target"] != "alpha" for _, _, f in log):
        fail("phase 20 shadow: a response came from the shadow")
    fleet_wait(lambda: fl.stats().get("shadow_parity_ok", 0)
               + fl.stats().get("shadow_parity_mismatch", 0)
               >= FLEET_SHADOW, "shadow compares", 60.0)
    st = fl.stats()
    if st.get("shadow_parity_mismatch", 0) or st.get("shadow_errors", 0) \
            or st["shadow_mirrored"] != FLEET_SHADOW:
        fail(f"phase 20 shadow: {st.get('shadow_parity_mismatch')} "
             f"mismatches, {st.get('shadow_mirrored')} mirrored")
    fl.router.set_shadow("alpha", None)
    out["shadow"] = {"mirrored": st["shadow_mirrored"],
                     "parity_ok": st["shadow_parity_ok"], "mismatches": 0}
    captures = fleet_captures(fl)
    if captures != 3 * len(SERVING_BUCKETS) * len(SERVING_KINDS):
        fail(f"phase 20 thread: {captures} graphs for 3 models")
    t0 = time.perf_counter()
    rep = fl.cold_start_replica()
    out["cold_start_s"] = time.perf_counter() - t0
    if rep.cold_start_captures != 0 or fleet_captures(fl) != captures:
        fail(f"phase 20: the cold replica captured "
             f"{rep.cold_start_captures} graphs")
    out["cold_start_captures"] = rep.cold_start_captures
    out["kill"] = fleet_kill_under_load(fl, refs, Xr)
    # a tenant past its 50 qps: shed at admission, structured
    futs, shed = [], []
    for i in range(3 * int(FLEET_TENANT_QPS)):
        try:
            futs.append((Xr[i:i + 1], "predict",
                         fl.submit(Xr[i:i + 1], tenant="t50")))
        except QuotaExceededError as e:
            d = e.to_dict()
            if d["error"] != "quota_exceeded" or e.http_status != 429 \
                    or d.get("tenant") != "t50" \
                    or not d.get("retry_after_s", 0) > 0:
                fail(f"phase 20 quota: {d}")
            shed.append(d)
    fleet_responses_equal(futs, refs, "quota")
    if not shed or fl.stats()["quota_shed"] != len(shed):
        fail(f"phase 20 quota: {len(shed)} shed, "
             f"{fl.stats().get('quota_shed')} counted")
    out["quota"] = {"admitted": len(futs), "shed": len(shed),
                    "error": shed[0]["error"]}
    # bench.py's serving block on 2 live replicas, then on 1
    live = [r.rid for r in fl.replicas if r.state == "ok"]
    out["loops"] = {}
    out["loops"]["2"] = loadgen.serving_block(fl, Xr, batch_sizes=(1, 64),
                                              threads=2, duration_s=2.0)
    fl.drain_replica(live[-1])
    out["loops"]["1"] = loadgen.serving_block(fl, Xr, batch_sizes=(1, 64),
                                              threads=2, duration_s=2.0)
    for k, block in out["loops"].items():
        if block["errors"]:
            fail(f"phase 20 closed loop on {k} replicas: "
                 f"{block['errors']} errors")
        print(f"[phase 20 thread] {card}: {k} replica(s), closed loop "
              f"(batch 1 and 64, 2 threads, 2 s): "
              f"{block['throughput_rps']} req/s, {block['rows_per_s']} "
              f"rows/s, p50 {block['p50_ms']} ms, p95 {block['p95_ms']} "
              f"ms, p99 {block['p99_ms']} ms")
    st = fl.stats()
    if fleet_captures(fl) != captures or st["errors"] \
            or st["engine_totals"].get("fallbacks", 0):
        fail(f"phase 20 thread: captures {fleet_captures(fl)}, errors "
             f"{st['errors']}, fallbacks "
             f"{st['engine_totals'].get('fallbacks')}")
    out["requests"] = st["requests"]
    out["redispatches"] = st.get("redispatches", 0)
    print(f"[phase 20 thread] {card}: 2 replicas, alpha and beta bitwise "
          f"Booster.predict ({out['bitwise_requests']} requests, "
          f"{FLEET_SIZES} rows, every kind); {out['captures_at_load']} "
          f"graphs at load, a cold replica {out['cold_start_captures']} in "
          f"{out['cold_start_s']:.3f} s; canary 0.25: {to_beta} of "
          f"{FLEET_CANARY} to beta; shadow: {out['shadow']['parity_ok']} "
          f"of {FLEET_SHADOW} equal, none returned; kill under load: "
          f"{out['kill']['requests']} requests, "
          f"{out['kill']['redispatches']} redispatched, 0 lost, 0 twice; "
          f"quota: {len(shed)} of {3 * int(FLEET_TENANT_QPS)} shed "
          "(quota_exceeded, 429)")
    fl.stop()
    return out


def fleet_process(models, refs, Xr, dev, card, fleets):
    """(b) the process fleet: 2 workers, each its own CUDA context."""
    import os
    import signal
    import threading
    from lightgbm_tpu_torch.robustness.faults import set_fault_plan
    from lightgbm_tpu_torch.serving import (FleetEngine, ProcFleetOptions,
                                            ServingConfig, loadgen)
    cfg = ServingConfig(buckets=SERVING_BUCKETS, device="always",
                        fallback_to_host=False)
    opts = ProcFleetOptions(heartbeat_ms=100.0, heartbeat_timeout_ms=5000.0,
                            spawn_timeout_s=FLEET_WAIT_S, restart_max=5)
    out = {}
    t0 = time.perf_counter()
    fl = FleetEngine(models={"alpha": models["a"], "beta": models["b"]},
                     config=cfg, replicas=2, default_model="alpha",
                     isolation="process", proc_opts=opts, device=dev)
    fleets.append(fl)
    out["start_s"] = time.perf_counter() - t0
    reps = fl.replicas
    per_model = len(SERVING_BUCKETS) * len(SERVING_KINDS)
    for r in reps:
        if r.device != dev.type or r.captures != {"alpha": per_model,
                                                "beta": per_model} \
                or r.aot_models != {"alpha": True, "beta": True}:
            fail(f"phase 20 process: replica {r.rid} device {r.device}, "
                 f"captures {r.captures}, AOT {r.aot_models}")
    out["spawn_ready_ms"] = [r.restart_ready_ms for r in reps]
    out["spawn_split_ms"] = [r.spawn_split_ms for r in reps]
    out["captures"] = [r.captures for r in reps]

    def ring_writes():
        return sum(r.shm_stats()["writes"] for r in fl.replicas)
    w0 = ring_writes()
    fleet_bitwise(fl, refs, Xr, (1, 64), "process JSON")
    if ring_writes() != w0:
        fail("phase 20 process: a request under serving_shm_min_bytes "
             "took the ring")
    fleet_bitwise(fl, refs, Xr, (512,), "process ring")
    shm = [r.shm_stats() for r in fl.replicas]
    if ring_writes() - w0 != 2 * len(SERVING_KINDS) \
            or any(s["fallbacks"] or s["oversize_misses"]
                   or s["full_misses"] for s in shm):
        fail(f"phase 20 process: ring {shm}")
    out["ring"] = shm
    fleet_wait(lambda: all("device" in r.stats_lite()
                           for r in fl.replicas), "worker stats", 10.0)
    out["reserved_mb"] = [r.stats_lite().get("device_reserved_bytes", 0)
                          / 2**20 for r in fl.replicas]
    # SIGKILL worker 0 under a 200 qps open loop
    rec = FleetRecorder(fl)
    victim = reps[0]
    inc = victim.incarnation
    killer = threading.Timer(0.5, os.kill, (victim.pid, signal.SIGKILL))
    killer.start()
    block = loadgen.open_loop(rec, Xr, qps=200.0, duration_s=2.0)
    killer.join()
    out["open"] = {k: block[k] for k in ("requests", "errors",
                                         "throughput_rps", "p50_ms",
                                         "p95_ms", "p99_ms")}
    checked = fleet_responses_equal(rec.log, refs, "sigkill")
    if block["errors"] or checked != block["requests"]:
        fail(f"phase 20 process: {block['errors']} lost in the SIGKILL")
    # crash_replica on the other worker while worker 0 respawns (no
    # traffic meanwhile)
    other = reps[1]
    inc1 = other.incarnation
    plan = set_fault_plan(f"crash_replica@rid={other.rid},signal=9")
    try:
        fleet_wait(lambda: victim.state == "ok" and victim.incarnation > inc,
                   "the SIGKILLed worker's respawn")
        fleet_wait(lambda: other.state == "ok" and other.incarnation > inc1,
                   "crash_replica's respawn")
        if plan.pending():
            fail("phase 20 process: crash_replica did not fire")
    finally:
        set_fault_plan(None)
    out["sigkill"] = {"reason": victim.last_death.get("reason_code"),
                      "respawn_ready_ms": victim.restart_ready_ms,
                      "respawn_split_ms": victim.spawn_split_ms,
                      "cold_start_captures": victim.cold_start_captures}
    out["crash_replica"] = {"reason": other.last_death.get("reason_code"),
                            "respawn_ready_ms": other.restart_ready_ms,
                            "respawn_split_ms": other.spawn_split_ms,
                            "cold_start_captures":
                                other.cold_start_captures}
    for r in reps:
        if r.cold_start_captures != 2 * per_model or r.device != dev.type:
            fail(f"phase 20 process: respawned replica {r.rid} captured "
                 f"{r.cold_start_captures} on {r.device}")
    # a 2 s soak with the kill storm (its respawn is not waited for: the
    # fleet's stop ends a respawn in flight and reaps its worker)
    rec = FleetRecorder(fl)
    soak = loadgen.soak_loop(rec, Xr, duration_s=2.0, qps=100.0,
                             models=["alpha", "beta"],
                             kill_storm_every_s=0.5,
                             kill_storm_kinds=("crash",))
    fleet_responses_equal(rec.log, refs, "soak")
    if soak["availability"] != 1.0 or soak["non_shed_errors"] \
            or soak["fault_storms"] < 1:
        fail(f"phase 20 soak: {json.dumps(soak)}")
    out["soak"] = {k: soak[k] for k in (
        "requests", "availability", "non_shed_errors", "fault_storms",
        "replica_deaths", "replica_restarts", "redispatches", "p50_ms",
        "p99_ms")}
    st = fl.stats()
    if st["errors"] or st["engine_totals"].get("fallbacks", 0):
        fail(f"phase 20 process: errors {st['errors']}, fallbacks "
             f"{st['engine_totals'].get('fallbacks')}")
    out["requests"] = st["requests"]
    out["restarts"] = st.get("replica_restarts", 0)
    print(f"[phase 20 process] {card}: 2 workers on "
          f"{[r.device for r in reps]}, {per_model} graphs a model each, "
          f"AOT attached; up in {out['start_s']:.1f} s (ready ms "
          f"{out['spawn_ready_ms']}: {out['spawn_split_ms']}); reserved "
          "device MB "
          f"{[round(v, 1) for v in out['reserved_mb']]}; bitwise "
          "Booster.predict at 1 and 64 rows (JSON) and 512 (the ring, "
          f"{2 * len(SERVING_KINDS)} writes, 0 fallbacks)")
    print(f"[phase 20 process] {card}: SIGKILL under 200 qps: "
          f"{block['requests']} requests, 0 lost, p50 {block['p50_ms']} ms, "
          f"p99 {block['p99_ms']} ms; {out['sigkill']['reason']}, respawn "
          f"ready {out['sigkill']['respawn_ready_ms']} ms "
          f"({out['sigkill']['respawn_split_ms']}), "
          f"{out['sigkill']['cold_start_captures']} captures; crash_replica "
          f"{out['crash_replica']['reason']}, ready "
          f"{out['crash_replica']['respawn_ready_ms']} ms; soak with the "
          f"kill storm: {soak['requests']} requests, availability "
          f"{soak['availability']}, {soak['fault_storms']} storm(s)")
    fl.stop(drain=False)
    return out


def fleet_phase(models, X, dev, card):
    """Phase 20: the fleets on the card. (a) a thread fleet of 2 replicas
    serving phase 3's model (alpha) and phase 6's (beta) from their model
    texts: every kind bitwise ``Booster.predict`` at 1-700 rows, a 0.25
    canary (exactly a quarter to beta, each response its target's), a
    shadow of alpha to the same text under a second name (compared, never
    returned), a cold replica capturing no graph, a replica killed under
    a 2-thread closed loop (none lost, none answered twice), a 50 qps
    tenant shed with ``quota_exceeded``, bench.py's serving block on 2
    replicas and on 1; (b) a process fleet of 2 workers (the models as
    Boosters: text and AOT artifact published), each on ``cuda`` with 12
    graphs a model, bitwise over JSON frames and the shared-memory ring,
    a worker SIGKILLed under a 200 qps open loop (none lost) and
    respawned, ``crash_replica`` classified and respawned, a 2 s soak
    with the kill storm at availability 1.0. Every fleet is stopped and
    its workers reaped in a ``finally``."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _native
    t_phase = time.perf_counter()
    _native.reset_launch_counts()
    Xr = np.ascontiguousarray(X[:SERVING_ROWS], np.float64)
    texts = {"alpha": models["a"].model_to_string(),
             "beta": models["b"].model_to_string()}
    refs = {k: lt.Booster(model_str=t, device=dev) for k, t in texts.items()}
    out = {}
    fleets = []
    try:
        t0 = time.perf_counter()
        out["thread"] = fleet_thread(texts, refs, Xr, dev, card, fleets)
        out["thread"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["process"] = fleet_process(models, refs, Xr, dev, card, fleets)
        out["process"]["seconds"] = time.perf_counter() - t0
    finally:
        for fl in fleets:
            fl.stop(drain=False)
    # the fleets run phase 19's route: no hand-written kernel
    out["launches"] = sum(_native.LAUNCHES.values())
    if out["launches"]:
        fail(f"phase 20 launched kernels: {dict(_native.LAUNCHES)}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[phase 20] {card}: {out['seconds']:.1f} s (thread "
          f"{out['thread']['seconds']:.1f}, process "
          f"{out['process']['seconds']:.1f}); kernel launches 0")
    return out


# ---- phase 21: the pipeline and the CLI on the card --------------------

PIPE_HOLDOUT_ROWS = 4096            # (a)'s clean holdout windows
PIPE_STAGE_REQUESTS = 64            # (a)'s routed requests a canary stage
PIPE_STAGES = "0.05,0.25,0.5"       # the JAX driver's default stages
# (a)'s cycle 1 trains on window 2 (each cycle draws its window and then
# its holdout) with every label flipped
PIPE_DRIFT = "drift@window=2,flip=1,once=1"
PIPE_TENANTS = ("acme", "globex", "initech", "umbrella")
PIPE_PARITY_ROWS = 100_000          # (d)'s window
PIPE_CODEGEN_ROWS = 2048            # (e)'s rows through the compiled C++
PIPE_SEED = 21                      # the replay stream's seed


def pipe_params(**over):
    """Phase 3's training params (and the pipeline's ``over``)."""
    return dict({"objective": "binary", "num_leaves": 255,
                 "learning_rate": 0.1, "max_bin": 255, "verbosity": -1},
                **over)


def pipe_counted(label, want, fn):
    """``fn()`` with the launch counts set to 0 just before it and read
    just after; every kernel in ``want`` must have launched. Returns
    (its result, the launches, its seconds)."""
    import torch
    from lightgbm_tpu_torch.ops import _native
    _native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    for name in want:
        if launches.get(name, 0) <= 0:
            fail(f"phase 21 {label}: kernel {name} was not launched "
                 f"({launches})")
    return res, launches, wall


def pipe_fleet(text, dev):
    """A thread fleet of 2 replicas serving ``text`` as "default",
    every request recorded."""
    from lightgbm_tpu_torch.serving import FleetEngine, ServingConfig
    return FleetRecorder(FleetEngine(
        models={"default": text},
        config=ServingConfig(buckets=SERVING_BUCKETS, device="always",
                             fallback_to_host=False),
        replicas=2, device=dev))


def pipe_refit(text, dev, card, tmp):
    """(a) refit mode at full width: 3 cycles of ``REFIT_ROWS``-row
    windows, the second poisoned; every cycle's refit, publish and ramp
    timed, the device memory reserved after every publish, every stage's
    p99s and parity probe, every routed response against
    ``Booster.predict`` of its target."""
    import torch
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.pipeline import PipelineDriver
    from lightgbm_tpu_torch.robustness.faults import set_fault_plan
    path = os.path.join(tmp, "base.txt")
    with open(path, "w") as fh:
        fh.write(text)
    fl = pipe_fleet(text, dev)
    set_fault_plan(PIPE_DRIFT)
    cycles = []
    drv = None
    try:
        drv = PipelineDriver({
            "task": "pipeline", "input_model": path, "verbosity": -1,
            "pipeline_window_rows": REFIT_ROWS,
            "pipeline_holdout_rows": PIPE_HOLDOUT_ROWS,
            "pipeline_stage_requests": PIPE_STAGE_REQUESTS,
            "pipeline_canary_stages": PIPE_STAGES,
            "pipeline_latency_slo_pct": 1000,
            "pipeline_replay_seed": PIPE_SEED,
            "pipeline_dir": os.path.join(tmp, "cands")}, fleet=fl)

        def timed(obj, name, after=None):
            fn = getattr(obj, name)

            def wrapper(*a, **kw):
                if name == "refit":
                    cycles.append({})
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn(*a, **kw)
                torch.cuda.synchronize()
                cycles[-1][f"{name}_s"] = time.perf_counter() - t0
                if after is not None:
                    after(r)
                return r
            setattr(obj, name, wrapper)

        def published(name):
            cycles[-1]["reserved_mb"] = torch.cuda.memory_reserved(
                dev) / 2 ** 20
            cycles[-1]["allocated_mb"] = torch.cuda.memory_allocated(
                dev) / 2 ** 20

        def ramped(ok):
            cycles[-1]["stages"] = [dict(
                weight=m.weight, decision=v.decision, reasons=v.reasons,
                requests=m.requests, canary_requests=m.canary_requests,
                canary_p99_ms=m.canary_p99_ms,
                primary_p99_ms=m.baseline_p99_ms,
                canary_quality=m.canary_quality,
                primary_quality=m.baseline_quality,
                parity_mismatches=m.parity_mismatches)
                for m, v in drv.ramp.verdicts]
        timed(drv.trainer, "refit")
        timed(drv.publisher, "publish", published)
        timed(drv.ramp, "ramp", ramped)
        summary, launches, wall = pipe_counted(
            "a", ("hist_rows",),
            lambda: drv.run(max_cycles=3, stop_fleet=False))
        hist = summary["history"]
        status = [r["status"] for r in hist]
        if status != ["promoted", "rolled_back", "promoted"] \
                or not hist[1]["reason"].startswith("quality_drop") \
                or hist[1]["window"]["drift"]["flip"] != 1.0:
            fail(f"phase 21 a: statuses {status}, reasons "
                 f"{[r.get('reason') for r in hist]}")
        probes = [s["parity_mismatches"] for c in cycles
                  for s in c["stages"]]
        if any(probes):
            fail(f"phase 21 a: parity probes mismatched {probes}")
        refs = {"default": lt.Booster(model_str=text, device=dev)}
        for cand in drv.publisher.history:
            refs[cand.name] = lt.Booster(model_str=cand.model_text,
                                         device=dev)
        checked = fleet_responses_equal(fl.log, refs, "a", "phase 21")
        names = fl.fleet.names()
        st = fl.stats()
        if st.get("fallbacks") or st["errors"]:
            fail(f"phase 21 a: fleet errors {st['errors']}, fallbacks "
                 f"{st.get('fallbacks')}")
        for i, (c, r) in enumerate(zip(cycles, hist)):
            c.update(status=r["status"], reason=r.get("reason"),
                     window=r["window"])
            print(f"[phase 21 a] {card}: cycle {i} window "
                  f"{r['window']['index']} ({r['window']['rows']} rows, "
                  f"drift {r['window']['drift']}): {r['status']} "
                  f"{r.get('reason') or ''}; refit {c['refit_s']:.3f} s, "
                  f"publish {c['publish_s']:.3f} s (reserved "
                  f"{c['reserved_mb']:.1f} MB, allocated "
                  f"{c['allocated_mb']:.1f} MB after it), ramp "
                  f"{c['ramp_s']:.3f} s")
            for s in c["stages"]:
                print(f"[phase 21 a]   stage {s['weight']}: "
                      f"{s['decision']} {s['reasons']}; canary "
                      f"{s['canary_requests']}/{s['requests']} requests, "
                      f"p99 canary {fmt_ms(s['canary_p99_ms'])} ms, "
                      f"primary {fmt_ms(s['primary_p99_ms'])} ms; quality "
                      f"canary {s['canary_quality']:.6f}, primary "
                      f"{s['primary_quality']:.6f}; parity mismatches "
                      f"{s['parity_mismatches']}")
        print(f"[phase 21 a] {card}: {len(hist)} cycles in {wall:.1f} s; "
              f"{checked} routed responses bitwise Booster.predict; "
              f"registered {names} (rolled-back candidates stay); primary "
              f"{summary['primary']}; launches {launches}")
        promoted = drv.publisher.history[-1].model_text
    finally:
        set_fault_plan(None)
        if drv is not None:
            drv.stop()        # its SLO engine, then the fleet
        else:
            fl.stop(drain=False)
    return dict(cycles=cycles, seconds=wall, launches=launches,
                responses_checked=checked, registered=names,
                primary=summary["primary"]), promoted


def pipe_continue(text, dev, card, tmp):
    """(b) continue mode: one cycle growing ``PARITY_ITERS`` 255-leaf
    trees on a ``REFIT_ROWS``-row window (the fused segment step),
    their ms a split timed around the GBDT's loop."""
    import torch
    from lightgbm_tpu_torch.models import gbdt as gm
    from lightgbm_tpu_torch.pipeline import PipelineDriver
    path = os.path.join(tmp, "promoted.txt")
    with open(path, "w") as fh:
        fh.write(text)
    fl = pipe_fleet(text, dev)
    loop = {}
    orig = gm.GBDT.train

    def timed_train(self, num_iterations):
        n0 = len(self.models)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig(self, num_iterations)
        torch.cuda.synchronize()
        loop.update(seconds=time.perf_counter() - t0,
                    splits=sum(t.num_leaves - 1 for t in self.models[n0:]),
                    learner=type(self.learner).__name__,
                    fused=self.learner.fused)
    gm.GBDT.train = timed_train
    drv = None
    try:
        drv = PipelineDriver(pipe_params(**{
            "task": "pipeline", "input_model": path,
            "pipeline_mode": "continue",
            "pipeline_continue_iters": PARITY_ITERS,
            "pipeline_window_rows": REFIT_ROWS,
            "pipeline_holdout_rows": PIPE_HOLDOUT_ROWS,
            "pipeline_stage_requests": PIPE_STAGE_REQUESTS,
            "pipeline_canary_stages": PIPE_STAGES,
            "pipeline_latency_slo_pct": 1000,
            "pipeline_replay_seed": PIPE_SEED + 1}), fleet=fl)
        summary, launches, wall = pipe_counted(
            "b", FUSED_SEGMENT_PATH,
            lambda: drv.run(max_cycles=1, stop_fleet=False))
    finally:
        gm.GBDT.train = orig
        if drv is not None:
            drv.stop()
        else:
            fl.stop(drain=False)
    rec = summary["history"][0]
    if not loop.get("fused") or rec["status"] not in ("promoted",
                                                      "rolled_back"):
        fail(f"phase 21 b: {rec.get('status')}, loop {loop}")
    ms = loop["seconds"] / max(loop["splits"], 1) * 1e3
    print(f"[phase 21 b] {card}: continue {PARITY_ITERS} x 255 leaves on "
          f"{REFIT_ROWS} rows ({loop['learner']}, fused {loop['fused']}): "
          f"{loop['splits']} splits in {loop['seconds']:.3f} s = "
          f"{ms:.4f} ms/split; the cycle {rec['status']} "
          f"{rec.get('reason') or ''} in {wall:.1f} s; launches {launches}")
    return dict(ms_per_split=ms, splits=loop["splits"], seconds=wall,
                status=rec["status"], launches=launches)


def pipe_tenants(dev, card):
    """(c) 4 tenants' candidates, ``PARITY_ITERS`` iterations each, on a
    ``REFIT_ROWS``-row window: one ``train_many`` bucket (the batched
    kernels)."""
    from lightgbm_tpu_torch.pipeline import ReplayLogSource
    from lightgbm_tpu_torch.pipeline.trainer import TenantRefitTrainer
    win = ReplayLogSource(n_features=F, seed=PIPE_SEED + 2).next_window(
        REFIT_ROWS)
    tr = TenantRefitTrainer(PIPE_TENANTS, params=pipe_params(),
                            num_boost_round=PARITY_ITERS, device=dev)
    cands, launches, wall = pipe_counted(
        "c", ("fused_split_step_leaf_batched", "hist_rows_batched"),
        lambda: tr.refit_all(win))
    rep = tr.last_report
    if rep["batched_models"] != len(PIPE_TENANTS) or rep["loop_fallback"] \
            or len(rep["buckets"]) != 1 or len(cands) != len(PIPE_TENANTS):
        fail(f"phase 21 c: report {rep}")
    print(f"[phase 21 c] {card}: {len(PIPE_TENANTS)} tenants x "
          f"{PARITY_ITERS} iterations on {REFIT_ROWS} rows in {wall:.2f} s: "
          f"batched_models {rep['batched_models']}, loop_fallback "
          f"{len(rep['loop_fallback'])}, buckets {len(rep['buckets'])} "
          f"(route {rep['buckets'][0]['route']}); launches {launches}")
    return dict(seconds=wall, batched_models=rep["batched_models"],
                loop_fallback=len(rep["loop_fallback"]), launches=launches)


def pipe_parity(text, dev, card):
    """(d) kernels against plain versions on a ``PIPE_PARITY_ROWS``-row
    window re-drawn with ``peek_window``: the refit, continued training
    at ``CUT_PARITY_LEAVES`` leaves and the tenants' batch, each
    candidate's text byte-equal."""
    from lightgbm_tpu_torch.pipeline import ReplayLogSource
    from lightgbm_tpu_torch.pipeline.trainer import (RefitTrainer,
                                                     TenantRefitTrainer)
    t0 = time.perf_counter()
    win = ReplayLogSource(n_features=F, seed=PIPE_SEED).peek_window(
        0, PIPE_PARITY_ROWS)
    small = pipe_params(num_leaves=CUT_PARITY_LEAVES)
    texts = {}
    for ops in ("kernel", "plain"):
        texts[ops] = [
            RefitTrainer(text, mode="refit", device=dev,
                         ops=ops).refit(win).model_text,
            RefitTrainer(text, params=small, mode="continue",
                         continue_iters=PARITY_ITERS, device=dev,
                         ops=ops).refit(win).model_text]
        tens = TenantRefitTrainer(PIPE_TENANTS, params=small,
                                  num_boost_round=PARITY_ITERS, device=dev,
                                  ops=ops).refit_all(win)
        texts[ops] += [tens[t].model_text for t in PIPE_TENANTS]
    labels = ["refit", "continue"] + [f"tenant {t}" for t in PIPE_TENANTS]
    differ = [lab for lab, k, p in zip(labels, texts["kernel"],
                                       texts["plain"]) if k != p]
    if differ:
        fail(f"phase 21 d: kernel and plain candidate texts differ: "
             f"{differ}")
    print(f"[phase 21 d] {card}: {PIPE_PARITY_ROWS} rows (peek_window), "
          f"kernel against plain: refit, continue ({CUT_PARITY_LEAVES} "
          f"leaves, {PARITY_ITERS} iterations) and {len(PIPE_TENANTS)} "
          f"tenants' texts byte-equal in {time.perf_counter() - t0:.1f} s")
    return dict(equal=labels, seconds=time.perf_counter() - t0)


def pipe_cli(X, y, dev, card, tmp):
    """(e) the CLI in process on a ``TEXT_ROWS``-row CSV of the 2M
    matrix: train (255 leaves, 8 iterations), predict (the file equal to
    ``Booster.predict`` to the bit), refit (its trees equal to
    ``Booster.refit``'s), convert_model (compiled with g++, within 1e-12
    of the booster's raw scores) and one pipeline cycle."""
    import ctypes
    import lightgbm_tpu_torch as lt
    import lightgbm_tpu_torch.pipeline as pipe
    from lightgbm_tpu_torch import cli
    out = {}
    Xc = np.ascontiguousarray(X[:TEXT_ROWS], np.float64)
    yc = np.asarray(y[:TEXT_ROWS], np.float64)
    csv = os.path.join(tmp, "train.csv")
    t0 = time.perf_counter()
    write_csv(csv, Xc, yc)
    out["csv_s"] = time.perf_counter() - t0
    # the tasks run on the card by default (a CPU rehearsal names its
    # device)
    dt = [] if dev.type == "cuda" else [f"device_type={dev.type}"]
    data = [f"data={csv}", "header=true", "verbosity=-1"] + dt
    model = os.path.join(tmp, "cli_model.txt")
    _, out["train_launches"], out["train_s"] = pipe_counted(
        "e train", FUSED_SEGMENT_PATH, lambda: cli.main(
            ["task=train", "objective=binary", "num_leaves=255",
             "max_bin=255", "learning_rate=0.1", "num_trees=8",
             f"output_model={model}"] + data))
    bst = lt.Booster(model_file=model, device=dev)
    pred = os.path.join(tmp, "cli_pred.txt")
    t0 = time.perf_counter()
    cli.main(["task=predict", f"input_model={model}",
              f"output_result={pred}"] + data)
    out["predict_s"] = time.perf_counter() - t0
    if np.loadtxt(pred).tobytes() != bst.predict(Xc).tobytes():
        fail("phase 21 e: the predict task's file is not Booster.predict")
    refit = os.path.join(tmp, "cli_refit.txt")
    _, out["refit_launches"], out["refit_s"] = pipe_counted(
        "e refit", ("hist_rows",), lambda: cli.main(
            ["task=refit", f"input_model={model}",
             f"output_model={refit}", "refit_decay_rate=0.9"] + data))
    with open(refit) as fh:
        got = fh.read().split("\nparameters:")[0]
    want = bst.refit(Xc, yc, decay_rate=0.9).model_to_string()
    if got != want.split("\nparameters:")[0]:
        fail("phase 21 e: the refit task's trees are not Booster.refit's")
    cpp = os.path.join(tmp, "model.cpp")
    lib = os.path.join(tmp, "model.so")
    t0 = time.perf_counter()
    cli.main(["task=convert_model", f"input_model={model}",
              f"convert_model={cpp}"] + dt)
    out["convert_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", lib, cpp],
                   check=True)
    out["gxx_s"] = time.perf_counter() - t0
    dll = ctypes.CDLL(lib)
    dll.PredictRaw.restype = None
    dll.PredictRaw.argtypes = [ctypes.POINTER(ctypes.c_double)] * 2
    rows = Xc[:PIPE_CODEGEN_ROWS]
    got = np.zeros(len(rows))
    buf = (ctypes.c_double * 1)()
    for i, row in enumerate(rows):
        dll.PredictRaw(row.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       buf)
        got[i] = buf[0]
    out["codegen_max_abs_err"] = float(np.abs(
        got - bst.predict(rows, raw_score=True)).max())
    if not out["codegen_max_abs_err"] <= 1e-12:
        fail(f"phase 21 e: the compiled model is "
             f"{out['codegen_max_abs_err']} off the booster")
    seen = {}
    real = pipe.run_pipeline

    def spy(params):
        seen["summary"] = real(params)
        return seen["summary"]
    pipe.run_pipeline = spy
    t0 = time.perf_counter()
    try:
        cli.main(["task=pipeline", f"input_model={model}",
                  "pipeline_cycles=1", "pipeline_latency_slo_pct=1000",
                  f"pipeline_dir={os.path.join(tmp, 'cli_cands')}",
                  "verbosity=-1"] + dt)
    finally:
        pipe.run_pipeline = real
    out["pipeline_s"] = time.perf_counter() - t0
    rec = seen["summary"]["history"][0]
    if seen["summary"]["cycles"] != 1 or rec["status"] not in (
            "promoted", "rolled_back"):
        fail(f"phase 21 e: the pipeline task's cycle {rec}")
    out["pipeline_status"] = rec["status"]
    print(f"[phase 21 e] {card}: CLI on a {TEXT_ROWS}-row CSV (written in "
          f"{out['csv_s']:.1f} s): train {out['train_s']:.1f} s (launches "
          f"{out['train_launches']}), predict {out['predict_s']:.1f} s "
          f"(bitwise Booster.predict), refit {out['refit_s']:.1f} s "
          f"(Booster.refit's trees; launches {out['refit_launches']}), "
          f"convert_model {out['convert_s']:.2f} s + g++ "
          f"{out['gxx_s']:.1f} s (max abs err "
          f"{out['codegen_max_abs_err']:.3g} over {PIPE_CODEGEN_ROWS} "
          f"rows), pipeline 1 cycle {rec['status']} in "
          f"{out['pipeline_s']:.1f} s")
    return out


def pipeline_phase(bst, X, y, dev, card):
    """Phase 21: the pipeline and the CLI on the card, on phase 3's model
    as text. (a) refit mode through ``PipelineDriver`` over a thread
    fleet of 2 replicas: 3 cycles of ``REFIT_ROWS``-row replay windows,
    the second's labels flipped (promoted, rolled back on quality_drop,
    promoted); (b) continue mode; (c) 4 tenants in one ``train_many``
    bucket; (d) kernels against plain versions, candidate texts
    byte-equal; (e) the CLI's train, predict, refit, convert_model and
    pipeline tasks. Every fleet is stopped in a ``finally``."""
    import tempfile
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    text = bst.model_to_string()
    out = {"trees": len(bst.models)}
    try:
        out["a"], promoted = pipe_refit(text, dev, card, tmp)
        out["b"] = pipe_continue(promoted, dev, card, tmp)
        out["c"] = pipe_tenants(dev, card)
        out["d"] = pipe_parity(text, dev, card)
        out["e"] = pipe_cli(X, y, dev, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {}
    for part in (out["a"]["launches"], out["b"]["launches"],
                 out["c"]["launches"], out["e"]["train_launches"],
                 out["e"]["refit_launches"]):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[phase 21] {card}: {out['seconds']:.1f} s (a "
          f"{out['a']['seconds']:.1f}, b {out['b']['seconds']:.1f}, c "
          f"{out['c']['seconds']:.1f}, d {out['d']['seconds']:.1f}); "
          f"kernel launches {launches}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--quality-iters", type=int, default=100)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--bosch-rows", type=int, default=1_000_000)
    # phase 16's rank processes (the script runs itself once a rank)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=PAR_RANKS)
    ap.add_argument("--rdzv", default=None)
    ap.add_argument("--out", default=None)
    # phase 16 (e)'s leg processes
    ap.add_argument("--leg", default=None, choices=sorted(DRILL_LEGS))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.leg is not None:
        drill_leg(args.leg, args.rank, args.world, args.rdzv, args.out,
                  args.rows)
        return 0
    if args.rank is not None:
        par_rank(args.rank, args.world, args.rdzv, args.out, args.rows,
                 args.iters)
        return 0
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.learner import SerialTreeLearner
    from lightgbm_tpu_torch.ops import _native
    from lightgbm_tpu_torch.ops.histogram import build_histogram, make_ghc
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    _native.library()
    print(f"[build] {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_native.BUILD_INFO['seconds']:.2f} s)")
    for line in _native.BUILD_INFO["ptxas"].splitlines():
        if "Used" in line or line.startswith("=="):
            print("  " + line.strip())

    # ---- 2. kernels against their plain versions -----------------------
    n = args.rows
    t0 = time.perf_counter()
    X, y = higgs_like(n)
    params = {"objective": "binary", "num_leaves": 255,
              "learning_rate": 0.1, "max_bin": 255, "verbosity": -1}
    params_wide = dict(params, max_bin=1023)
    ds = lt.Dataset(X, label=y)
    binned = ds._construct(lt.Config.from_params(params))
    ds_wide = lt.Dataset(X, label=y)
    binned_wide = ds_wide._construct(lt.Config.from_params(params_wide))
    b_wide = int(binned_wide.num_bins_array().max())
    print(f"[data] {n} x {F} binned at max_bin 255 and 1023 "
          f"(num_bins_max {int(binned.num_bins_array().max())} and "
          f"{b_wide}) in {time.perf_counter() - t0:.1f} s")
    from lightgbm_tpu_torch.ops import hist_cuda as hc
    mat = hc.build_matrix(binned.binned_device(dev))
    gen = torch.Generator(device=dev).manual_seed(7)
    grad = torch.randn(n, generator=gen, device=dev)
    hess = torch.rand(n, generator=gen, device=dev) * 0.25 + 1e-3
    hc.pack_gh(mat, F, grad, hess, torch.ones(n, device=dev))
    t0 = time.perf_counter()
    rec = {"hist_segment": check_hist(mat, n, args.reps)}
    print(f"[check] hist_segment ok {time.perf_counter() - t0:.1f} s "
          f"{rec['hist_segment']}")
    t0 = time.perf_counter()
    hists = [hc.histogram_segment(mat, 0, n // 3, B, F),
             hc.histogram_segment(mat, n // 3, n - n // 3, B, F)]
    scan256 = check_scan(hists, binned, B, args.reps)
    print(f"[check] split_scan ({B} bins) ok {time.perf_counter() - t0:.1f} "
          f"s {scan256}")
    t0 = time.perf_counter()
    rec["partition_segment"] = check_partition(mat, n, args.reps)
    print(f"[check] partition_segment ok {time.perf_counter() - t0:.1f} s "
          f"{rec['partition_segment']}")
    t0 = time.perf_counter()
    rec["fused_split_step_segment"] = check_fused(mat, n, binned, args.reps)
    print(f"[check] fused_split_step_segment ok "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{segment_summary(rec['fused_split_step_segment'])} "
          f"{rec['fused_split_step_segment']}")
    del mat, hists
    torch.cuda.empty_cache()
    # the serial learner's inputs: the bin matrices and ghc
    ghc = make_ghc(grad, hess)
    bins_wide = binned_wide.binned_device(dev)
    t0 = time.perf_counter()
    hists = [build_histogram(bins_wide[:n // 3], ghc[:n // 3], b_wide),
             build_histogram(bins_wide[n // 3:], ghc[n // 3:], b_wide)]
    rec["split_scan"] = check_scan(hists, binned_wide, b_wide, args.reps)
    print(f"[check] split_scan ({b_wide} bins) ok "
          f"{time.perf_counter() - t0:.1f} s {rec['split_scan']}")
    del hists
    t0 = time.perf_counter()
    rec["fused_split_step_leaf"] = check_fused_leaf(
        bins_wide, ghc, binned_wide, b_wide, args.reps)
    print(f"[check] fused_split_step_leaf ({b_wide} bins, u16) ok "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{leaf_summary(rec['fused_split_step_leaf'])} "
          f"{rec['fused_split_step_leaf']}")
    t0 = time.perf_counter()
    b_u8 = int(binned.num_bins_array().max())
    leaf_u8 = check_fused_leaf(binned.binned_device(dev), ghc, binned, b_u8,
                               args.reps)
    print(f"[check] fused_split_step_leaf ({b_u8} bins, u8) ok "
          f"{time.perf_counter() - t0:.1f} s: {leaf_summary(leaf_u8)} "
          f"{leaf_u8}")
    t0 = time.perf_counter()
    rec["hist_rows"] = check_hist_rows(
        {"u8": (binned.binned_device(dev), b_u8),
         "u16": (bins_wide, b_wide)}, ghc, args.reps)
    print(f"[check] hist_rows ok {time.perf_counter() - t0:.1f} s: "
          f"{hist_rows_summary(rec['hist_rows'])} {rec['hist_rows']}")
    del ghc, bins_wide, grad, hess
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    print(f"[check] split_scan widths: {check_scan_widths(dev)} "
          f"{time.perf_counter() - t0:.1f} s")
    # phase 15's kernels alone, here while the profiler keeps records
    wide_scans, wide_hists = wide_kernel_checks(dev, n, args.reps)
    # each kernel beside its byte (or operation) bound and its launch
    # floor: the launches of one call times a launch's least device time
    floor = launch_floor_ms(args.reps)
    print(f"[floor] a launch's least time on the card {floor * 1e3:.2f} "
          "us (a CUDA graph of one-element fills); ms: the median of CUDA "
          "events around a call; device: its kernels' time (profiler)")
    for name, r in rec.items():
        print(f"[floor] {name}: {r['ms']:.4f} ms, device "
              f"{r['device_ms']:.4f} ms, bound {r['bound_ms']:.5f}"
              f" ms ({r['bound_by']}), launch floor "
              f"{LAUNCHES_A_CALL[name] * floor:.4f} ms "
              f"({LAUNCHES_A_CALL[name]} launches a call)")
    print(f"[floor] split_scan ({B} bins): {scan256['ms']:.4f} ms, device "
          f"{scan256['device_ms']:.4f} ms, bound "
          f"{scan256['bound_ms']:.5f} ms, launch floor {floor:.4f} ms")

    # ---- 3. the partitioned learner at full width, fused and per-phase -
    fused_bst, part_fused, part_per = train_paths(
        "max_bin 255", params, ds, args.iters, dev,
        {"fused": ("hist_segment", "split_scan", "fused_split_step_segment"),
         "per-phase": ("hist_segment", "split_scan", "partition_segment")},
        "fused_split_step_segment")
    pred = fused_bst.predict(X[:100_000], raw_score=True)
    if pred.shape != (100_000,) or not np.isfinite(pred).all():
        fail("full-width predictions are not finite")

    # ---- 4. the serial learner at full width (1023 bins) ---------------
    serial_bst, serial_fused, serial_per = train_paths(
        "max_bin 1023", params_wide, ds_wide, args.iters, dev,
        {"fused": ("hist_rows", "split_scan", "fused_split_step_leaf"),
         "per-phase": ("hist_rows", "split_scan")}, "fused_split_step_leaf")
    if not isinstance(serial_bst._gbdt.learner, SerialTreeLearner):
        fail("max_bin 1023 did not train through the SerialTreeLearner")
    # hist_rows: the root of every tree, and per-phase every split's
    # smaller child too (the two paths grew the same trees)
    trees = serial_bst.models[:args.iters]
    splits = sum(t.num_leaves - 1 for t in trees)
    print(f"[train max_bin 1023] hist_rows launches: fused "
          f"{serial_fused['hist_rows']} (trees {len(trees)}), per-phase "
          f"{serial_per['hist_rows']} (trees + splits "
          f"{len(trees) + splits})")
    if serial_fused["hist_rows"] != len(trees) \
            or serial_per["hist_rows"] != len(trees) + splits:
        fail("hist_rows launches on the serial paths are not one a tree "
             "(fused) and one a tree plus one a split (per-phase)")
    if part_fused["hist_rows"] or part_per["hist_rows"]:
        fail("the partitioned learner launched hist_rows")
    pred = serial_bst.predict(X[:100_000], raw_score=True)
    if pred.shape != (100_000,) or not np.isfinite(pred).all():
        fail("full-width serial predictions are not finite")
    del serial_bst, ds_wide
    torch.cuda.empty_cache()
    launches = {name: 0 for name in _native.LAUNCHES}
    launches.update(hist_segment=part_fused["hist_segment"],
                    fused_split_step_segment=part_fused[
                        "fused_split_step_segment"],
                    partition_segment=part_per["partition_segment"],
                    split_scan=serial_fused["split_scan"],
                    fused_split_step_leaf=serial_fused[
                        "fused_split_step_leaf"],
                    hist_rows=serial_fused["hist_rows"])

    # ---- 5. leaf kernel against segment kernel at 255 bins -------------
    t0 = time.perf_counter()
    leaf_vs_segment(binned, params, dev)
    print(f"[leaf vs segment] done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # ---- 6. quality ----------------------------------------------------
    Xq, yq = higgs_like(50_000)
    for max_bin in (255, 1023):
        t0 = time.perf_counter()
        qparams = {"objective": "binary", "num_leaves": 63,
                   "learning_rate": 0.1, "max_bin": max_bin,
                   "verbosity": -1}
        bq = lt.train(qparams, lt.Dataset(Xq, label=yq), args.quality_iters,
                      device=dev)
        q_auc = auc(yq, bq.predict(Xq, raw_score=True))
        lrn = bq._gbdt.learner
        print(f"[quality] 50000 x {F}, 63 leaves, max_bin {max_bin}, "
              f"{args.quality_iters} iters ({type(lrn).__name__}, fused "
              f"{lrn.fused}): AUC {q_auc:.5f} in "
              f"{time.perf_counter() - t0:.1f} s")
        if not lrn.fused:
            fail("the quality config did not run the fused path")
        if args.quality_iters >= 100 and q_auc < 0.97906 - 0.002:
            fail(f"AUC {q_auc} below 0.97706 at max_bin {max_bin}")
        if max_bin == 255:
            quality_bst = bq       # phase 19 serves it from its text

    # ---- 7. parity: kernels against plain versions, end to end --------
    Xp, yp = higgs_like(100_000, seed=3)
    for max_bin in (255, 1023):
        t0 = time.perf_counter()
        pp = dict(params, max_bin=max_bin)
        kb = lt.train(pp, lt.Dataset(Xp, label=yp), 3, device=dev)
        pb = lt.train(pp, lt.Dataset(Xp, label=yp), 3, device=dev,
                      ops="plain")
        same = [tree_sig(a) == tree_sig(b) for a, b in zip(kb.models,
                                                           pb.models)]
        leaf_err = max(float(np.abs(a.leaf_value - b.leaf_value).max())
                       for a, b in zip(kb.models, pb.models))
        print(f"[parity] 100000 x {F}, max_bin {max_bin}, 3 trees, "
              f"{type(kb._gbdt.learner).__name__} fused path (kernel "
              f"{kb._gbdt.learner.fused}, plain {pb._gbdt.learner.fused}): "
              f"structure equal {same}, "
              f"max leaf value diff {leaf_err:.3g} "
              f"in {time.perf_counter() - t0:.1f} s")
        if len(kb.models) != 3 or not all(same):
            for i, (a, b) in enumerate(zip(kb.models, pb.models)):
                s = first_divergence(a, b)
                if s is not None:
                    print(f"[parity] tree {i} first differs at node {s}: "
                          f"kernel feature {int(a.split_feature_inner[s])}"
                          f" bin {int(a.threshold_bin[s])} gain "
                          f"{float(a.split_gain[s])!r}, plain feature "
                          f"{int(b.split_feature_inner[s])} bin "
                          f"{int(b.threshold_bin[s])} gain "
                          f"{float(b.split_gain[s])!r}")
                    break
            fail(f"kernel and plain runs grew different trees "
                 f"(max_bin {max_bin})")

    # ---- 8. the model file on the card ---------------------------------
    t0 = time.perf_counter()
    model_file_phase(fused_bst, ds, X, params, dev)
    print(f"[model file] done in {time.perf_counter() - t0:.1f} s")
    del ds
    torch.cuda.empty_cache()

    # ---- 9. every objective, valid sets and early stopping ------------
    t0 = time.perf_counter()
    multiclass_bst = objectives_phase(X, binned, binned_wide,
                                      dev).pop("c_model")
    print(f"[objectives] done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # ---- 10. SHAP, early-stopped prediction, row sampling --------------
    t0 = time.perf_counter()
    rec["tree_shap"], launches["tree_shap"] = sampling_phase(
        X, y, binned, binned_wide, fused_bst, multiclass_bst, dev,
        args.reps)
    print(f"[sampling] done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # ---- 19. serving on the card ---------------------------------------
    serving = serving_phase({"a": fused_bst, "b": quality_bst,
                             "c": multiclass_bst}, X, dev, card)

    # ---- 20. the fleets on the card ------------------------------------
    fleet = fleet_phase({"a": fused_bst, "b": quality_bst}, X, dev, card)

    # ---- 21. the pipeline and the CLI on the card ----------------------
    pipeline = pipeline_phase(fused_bst, X, y, dev, card)
    del fused_bst, multiclass_bst, quality_bst
    torch.cuda.empty_cache()

    # ---- 11. categorical features on the per-phase path ----------------
    t0 = time.perf_counter()
    cat = categorical_phase(n, min(args.iters, CATEGORICAL_ITERS), dev)
    print(f"[categorical] done in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(cat))
    torch.cuda.empty_cache()

    # ---- 12. EFB, multi-val, sparse input, two-round loading -----------
    t0 = time.perf_counter()
    efb, rec["hist_multival"], launches["hist_multival"] = efb_phase(
        n, args.iters, dev, args.reps, bosch_rows=args.bosch_rows)
    print(f"[efb] done in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(efb, default=str))
    torch.cuda.empty_cache()

    # ---- 13. the rest of tree growing and linear leaves ----------------
    t0 = time.perf_counter()
    extras = extras_phase(X, y, binned, binned_wide, dev, args.iters,
                          args.reps)
    del binned_wide
    print(f"[extras] done in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(extras, default=str))
    torch.cuda.empty_cache()

    # ---- 14. cv, refit, rollback, estimators, binary file --------------
    t0 = time.perf_counter()
    slice15, refit_route = slice15_phase(X, y, binned, dev, args.iters,
                                         args.reps)
    print(f"[slice15] done in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(slice15, default=str))
    torch.cuda.empty_cache()

    # ---- 15. more than 1024 bins ---------------------------------------
    t0 = time.perf_counter()
    wide = wide_bins_phase(X, y, dev, args.iters)
    print(f"[wide bins] done in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(wide, default=str))
    torch.cuda.empty_cache()

    # ---- 17. multiboost: train_many, BoosterBatch, batched cv ----------
    t0 = time.perf_counter()
    mb, rec["fused_split_step_leaf_batched"], rec["hist_rows_batched"] = \
        multiboost_phase(X, y, binned, dev, args.iters, args.reps)
    launches["fused_split_step_leaf_batched"] = \
        rec["fused_split_step_leaf_batched"].pop("launches")
    launches["hist_rows_batched"] = rec["hist_rows_batched"].pop("launches")
    print(f"[multiboost] done in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(mb, default=str))
    torch.cuda.empty_cache()

    # ---- 18. the robustness and observability planes -------------------
    t0 = time.perf_counter()
    planes = planes_phase(X, y, binned, dev, args.iters)
    del binned
    print(f"[phase 18] {time.perf_counter() - t0:.1f} s: "
          + json.dumps(planes, default=str))
    torch.cuda.empty_cache()

    # ---- 16. the parallel learners over ranks on the card --------------
    t0 = time.perf_counter()
    par = parallel_phase(min(n, PAR_ROWS), min(args.iters, PAR_ITERS), dev,
                         limit_s=400.0)
    print(f"[parallel] done in {time.perf_counter() - t0:.1f} s: "
          + json.dumps(par, default=str))

    sources = {
        "hist_segment": ("lightgbm_tpu_torch/csrc/hist_segment.cu",
                         "lightgbm_tpu/ops/hist_pallas.py:322"),
        "partition_segment": (
            "lightgbm_tpu_torch/csrc/partition_segment.cu",
            "lightgbm_tpu/ops/partition_pallas.py:51"),
        "split_scan": ("lightgbm_tpu_torch/csrc/split_scan.cu",
                       "lightgbm_tpu/ops/split_scan_pallas.py:56"),
        "fused_split_step_segment": (
            "lightgbm_tpu_torch/csrc/split_step_segment.cu",
            "lightgbm_tpu/ops/split_step_pallas.py:531"),
        "fused_split_step_leaf": (
            "lightgbm_tpu_torch/csrc/split_step_leaf.cu",
            "lightgbm_tpu/ops/split_step_pallas.py:413"),
        "hist_rows": ("lightgbm_tpu_torch/csrc/hist_rows.cu",
                      "lightgbm_tpu/ops/hist_pallas.py:642"),
        "tree_shap": ("lightgbm_tpu_torch/csrc/tree_shap.cu",
                      "no TPU kernel: the host TreeSHAP "
                      "lightgbm_tpu/native/treeshap.cpp, called from "
                      "lightgbm_tpu/predictor.py:503"),
        "hist_multival": ("lightgbm_tpu_torch/csrc/hist_multival.cu",
                          "lightgbm_tpu/ops/histogram.py:103 multival_hist "
                          "(XLA scatter, no Pallas kernel)"),
        "fused_split_step_leaf_batched": (
            "lightgbm_tpu_torch/csrc/split_step_leaf.cu",
            "no Pallas kernel but the vmapped scan "
            "lightgbm_tpu/ops/split_scan_pallas.py:224: the XLA split body "
            "of grow_tree, lightgbm_tpu/learner/serial.py:1043, under "
            "jax.vmap at lightgbm_tpu/multiboost/program.py:157 "
            "(fused_kernel=False, :120); the model axis of the port of "
            "split_step_pallas.py:413"),
        "hist_rows_batched": (
            "lightgbm_tpu_torch/csrc/hist_rows.cu",
            "no Pallas kernel: the root's build_histogram, "
            "lightgbm_tpu/learner/serial.py:794 (histogram_onehot, "
            "lightgbm_tpu/ops/histogram.py:58, on a TPU), under jax.vmap "
            "at lightgbm_tpu/multiboost/program.py:157; the model axis of "
            "the port of hist_pallas.py:642"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        r = rec[name]
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=rep, launches=launches[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            device_ms=r["device_ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
        if name == "hist_rows":
            # refit's per-leaf sums (phase 14): F = 1, B = the leaves
            kernels[-1]["refit_route"] = refit_route
        if name in ("split_scan", "hist_rows"):
            # past 1024 bins alone (phase 15), and its launches in the
            # 4095-bin training run
            kernels[-1]["wide_bins"] = {
                str(b): v for b, v in (wide_scans if name == "split_scan"
                                       else wide_hists).items()}
            kernels[-1]["wide_bins_launches"] = wide["launches"][name]
        # each kernel's launches in phase 21's counted runs (the
        # pipeline's refit, continue and tenant cycles and the CLI's
        # train and refit)
        kernels[-1]["pipeline_launches"] = pipeline["launches"].get(name, 0)
        # each kernel's launches on rank 0 of phase 16's runs
        kernels[-1]["parallel_launches"] = {
            run: r["launches"].get(name, 0)
            for run, r in par["runs"].items()}
        if name == "fused_split_step_leaf_batched":
            kernels[-1]["tree_avg_ms"] = r["tree_avg_ms"]
            kernels[-1]["tree_avg_bound_ms"] = r["tree_avg_bound_ms"]
            kernels[-1]["models"] = r["models"]
            kernels[-1]["single_kernel_equal"] = r["single_kernel_equal"]
        if name == "hist_rows_batched":
            kernels[-1]["models"] = r["models"]
            # the m hist_rows launches the kernel replaces, timed beside it
            kernels[-1]["loop_ms"] = r["loop_ms"]
        if name in ("fused_split_step_leaf_batched", "hist_rows_batched"):
            # bucket 0's 8 models at once, measured beside B 4
            kernels[-1]["models_8"] = {
                key: r["models_8"][key] for key in (
                    "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                    "max_abs_err", "tree_avg_ms", "tree_avg_bound_ms",
                    "loop_ms", "block_shape", "launch_shape")
                if key in r["models_8"]}
        if name == "hist_multival":
            # the data-parallel learners' float64 route (phase 16 f): its
            # launches in the multi-val data run on rank 0
            kernels[-1]["float64_route"] = dict(
                par["item13"]["multival_f64"],
                launches=par["item13"]["runs"]["multival_data"][
                    "launches"]["hist_multival"])
        if name == "split_scan":
            # the per-phase scan also takes the tree's node table
            # (extra_trees, by-node sampling; phase 13)
            kernels[-1]["node_table"] = {
                str(b): v for b, v in extras["node_table"].items()}
    print(f"[total] {time.perf_counter() - t_all:.1f} s")
    # phase 21's record: the card, each cycle's decisions, stage p99s and
    # seconds, the memory reserved after each publish, the CLI's tasks
    print(json.dumps({"pipeline": dict(card=card, **pipeline)},
                     default=str))
    # phase 20's record: the card, the thread and the process fleet's
    # checks and times (no hand-written kernel: the fleets run phase 19's
    # route)
    print(json.dumps({"fleet": dict(card=card, **fleet)}, default=str))
    # phase 19's record: the card, each loop's latency and rate, each
    # model's warmup and replay against eager walk (no hand-written
    # kernel: the serving route is PyTorch on the card, captured as
    # CUDA graphs)
    print(json.dumps({"serving": dict(
        card=card, seconds=serving["seconds"],
        loops={k: {m: serving[k][m] for m in (
            "requests", "rows", "throughput_rps", "rows_per_s", "p50_ms",
            "p95_ms", "p99_ms", "shed")} for k in ("closed", "open",
                                                   "soak")},
        models={m: serving[m] for m in ("a", "b", "c")},
        engine_a=serving["stats_a"],
        responses_checked=serving["responses_checked"])}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

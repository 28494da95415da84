#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (libfm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # configs #3, #4, #5, bench_bs(_ctx), #1, #4b; the probes
    python3 chip_smoke.py --config3-kernels   # config #3's kernel checks only
    python3 chip_smoke.py --config4           # config #4's kernel checks and its MCMC
                                              # path twice at one seed only
    python3 chip_smoke.py --config5-kernels   # config #5's dual_draw check and the
                                              # hyperprior group sums only
    python3 chip_smoke.py --bench-bs          # bench_bs's and bench_bs_ctx's kernel
                                              # checks and paths only
    python3 chip_smoke.py --exact             # the exact engines' kernel checks and
                                              # paths only
    python3 chip_smoke.py --sgda              # SGDA's kernel checks and its two paths
                                              # only
    python3 chip_smoke.py --probes            # the probe-shape kernel checks and the
                                              # probe path only
    python3 chip_smoke.py --cli               # the CLI phase only
    python3 chip_smoke.py --options           # the options phase only (k = 0,
                                              # checkpoints, predict_new, case
                                              # reordering)
    python3 chip_smoke.py --quality           # MCMC 24 iterations at #3, #4, #5 against
                                              # bench.py's quality targets, and at
                                              # bench_bs_ctx and bench_bs_c

What it does, in order (any failed phase exits non-zero):

1. Checks for a CUDA device and prints the card's name and power limit.
2. Builds the port's CUDA kernels from libfm_tpu_torch/csrc (nvcc, sm_90a)
   and prints the build seconds.
3. Kernel phase. At the shapes the main paths give each kernel, runs every
   kernel and its plain PyTorch version on the same seeded inputs, checks
   the difference against a stated tolerance and times kernel, plain
   version and (where one exists) the one PyTorch library call that
   computes the same function, with CUDA events:
   - config #3 (movielens_like(71567, 10681, 10M, seed=1): 9M train rows,
     82,248 features, k=64): fm_refresh (train and test mode),
     slot_stats (case_stats, which the JAX engine's gate keeps off these
     blocks, timed beside it), schur_draw, dense_update; schur_draw also
     on both blocks
     with every 4th feature's system made not positive definite (its
     reject flags must equal the plain version's, and every such draw
     must be rejected); fm_refresh and dense_update also timed with every
     id on table row 0 or on the first 1,024 rows, beside the real ids
     (gather against streaming), and dense_update with skewed ids: every
     covered case on one of 4 rows, or on Zipf(1.2) ranks as ctr_like
     draws a field's values; slot_update (K4b, the slot scatter) on both
     blocks' slots in case order (the learner's lists) from the same A
     and tables, against its plain version and against dense_update on
     the same blocks, timed beside it, and on the per-feature lists (the
     same bits, timed beside it); the incremental test tail on the 1M test rows: fm_refresh's
     train mode with y = 0 (the refresh's te_chunk) and dense_update on
     the tail's rows, each against its plain version;
   - SGD: one whole epoch (sgd_step with the w0 update + table_scatter)
     from the same table, kernels against plain versions (table and w0;
     each batch's in-kernel w0 bitwise against the torch line on its
     sums), at config #1 (the same ML data, k=8, B=32768, "pair" mode),
     config #4b (ctr_like(13, 5000, 2M, seed=1), k=16, B=8192, "onehot")
     and #4b's data with values from N(1, 0.25) ("general"); each kernel
     also timed alone over an epoch's batches in the learner's form
     (update rows at their sorted positions, read in order; table_scatter
     against index_add_ of the same rows); at #1 and #4b one batch whose
     ids are all equal through table_scatter;
   - table_scatter at probe P4's shape (against index_add_) and
     table_read at probes P1 (scale 8) and P3 (scale 1) on the shared form
     of its plan, and at P3's ids on a table of 65,536 rows on its l2
     form, two calls the same bits; the plan goes in the row, and the
     first version's time and the lookups' shared-memory floor are
     printed beside it;
   - SGDA (K13): one whole epoch with lambda steps (sgda_step with the w0
     update + table_scatter + sgda_lambda on validation batch i % NV) from
     the same table, caches and regularizers, kernels against plain
     versions, at config #1's settings ("pair", users and items as the 2
     groups), #4b's ("onehot", the 13 fields) and #4b's data with values
     from N(1, 0.25) ("general"), each on a validation set carved from the
     train rows (a seeded random ninth): batch by batch in lockstep (the
     update rows, the table, the cache rows, the regularizers, and each
     batch's in-kernel w0 bitwise against `w0_update` on its sum) and
     free-running to the epoch's end; each kernel also timed alone over an
     epoch's launches; sgda_step on the first batch twice from the same
     state (the rows, cache rows, sum and w0 the same bits; the rows' and
     cache rows' digest printed, so that a run of this script in an
     earlier commit's tree shows whether they keep its bits);
   - config #4 (bench.py:236-277: MCMC probit classification, k=16, on
     #4b's data with its 13 field groups): case_stats on the 13 blocks
     under their launch plans (one iteration's launches, a second one the
     same bits; slot_stats, which computes the same GG, and
     torch.index_select of the slots' rows alone timed beside it; both
     kernels, and the plain version in float32, held to the plain version
     in float64 entry by entry over the entry's sum of magnitudes),
     fm_refresh's probit train mode (latents drawn from
     given uniforms, and as expectations) and probit_latent, each against
     its plain version on the same uniforms (probit_latent's correct count
     and its two residual sums, which the next alpha and w0 draws take, a
     second launch the same bits, the digest printed; its bound also at
     A's sectors);
   - config #5 (bench.py:337-389, bench_largevocab: MCMC probit
     classification, k=128, ctr_like(26, 40000, 3M, seed=1), the 26
     fields as groups): dual_draw on the dual features of the 26 blocks
     (one iteration's launches), sampling and ALS, against its plain
     version on the same noise; the dual features counted by slot count
     and checked against the JAX engine's rule reckoned straight from the
     train rows (features of 1 to 32 entries); the library
     yardstick is torch.linalg.cholesky_ex + torch.cholesky_solve on the
     same c x c systems, grouped by c; and the hyperprior draws' group
     sums at its shapes (1,040,000 features, k = 128, 26 groups; one
     sweep's four sums): ops.segment.GroupSums, in a fixed order, against
     the index_add_ it replaced, both against float64 (tol 1e-5 of the
     magnitudes), two calls of GroupSums the same bits;
   - bench_bs (bench.py:392-455: relational regression, 1M train and 100K
     test cases joined to 4,000 block rows of 16 gaussian entries over
     20,000 features, k=32, rebuilt with numpy from default_rng(7); its
     block count and shapes, observed and unobserved features and route
     printed): rel_scores (a second launch the same bits, SC's digest
     printed; and over two relations stacked in one launch, bench_bs's and
     its first half of block rows, every row the one-relation call's bits
     and the sentinels 0), rel_refresh (train and tail modes; a second
     train-mode launch the same bits, the digests of A and the tail
     printed) and rel_cache from a seeded P (a second launch the same
     bits, C's digest printed); one sweep of the 23 blocks to make SD
     non-zero, then a second holding each block's rel_stats (to float64,
     over each entry's sum of magnitudes, as rel_cache), each draw from
     its GG (schur_draw's relational form) against the float64 draw from
     the float64 GG, in posterior standard deviations (their root mean
     square over the features within 1.5 times the float32 plain
     version's, which sums in a fixed order, and here, at a fixed state,
     their largest too), the same bits as schur_draw's on the same inputs
     (the distance from schur_draw_plain's printed), and the form's SD
     (K10's update) against rel_update_plain (SD's and theta's digests
     printed); the update's cost as the 23 launches' time less
     the same launches as plain schur_draw; rel_deferred (K10's
     closed-form sums, float64) at the checked sweep's SD against its
     plain version (within a float32 ulp; a second call the same bits);
     rel_resync in write mode (train rows) and read-only (the test tail),
     both timed, beside the first version's times.
     The yardstick of rel_cache is one torch.bmm of the pre-gathered rows
     [1 | e | Q]. The draw check runs again, with both gates, at the
     state mcmc_bs ends in (phase 4), the same on every run.
   - bench_bs_ctx (bench_bs's data with a main table of two one-hot
     context fields, day of 1,000 and hour of 168, drawn from
     default_rng(8); 21,168 features; bench_bs_c its probit form, the
     sign of the regression target; its main blocks, route and class
     share printed): rel_refresh with the main rows, train mode (A per
     column within 1e-4, the summed error within 1e-6 relative) and test
     mode; rel_refresh_probit, sampling on given uniforms and as
     expectations (Q, the predictions and the latents as config #4's
     probit check holds them, the correct count equal to the plain
     version's; in each mode a second launch the same bits, and the
     digests of A, the latents and the test predictions printed); on both
     main blocks (K12's main half) slot_stats (GG
     within 1e-4 per part), schur_draw (1e-3) and slot_update (1e-5).
   - the exact engines (K11): coord_draw, w and v (factor k/2), on config
     #3's two blocks and on config #4's block with the longest feature
     (its slot count printed), rel_coord_draw w and v on bench_bs_ctx's 23
     relation blocks (the caches from rel_cache_cols over A's columns e,
     Q_0 and over e, q', qB a column of the score table), sampling and
     ALS, block by block from the same state as the plain version and the
     plain version in float64: within 1e-5, or 3 times the float32 plain
     version's own distance from float64 where larger; the rejection
     counts equal, a second launch the same bits. Each block under its
     launch plan (DrawPlan: short features a warp, medium a CTA, long in
     pieces with a second launch; #3 has short and medium features, #4's
     block all three classes), the relation blocks (short) also under
     plans that make every feature medium or cut it into pieces of 2, so
     that every class is held in every mode; at #3 the v launches also
     timed with the short class cut at 64 and 128 slots. rel_cache_cols
     (rel_cache's narrow form at k = 1) over e and q' against float64 (its
     yardstick one torch.bmm of the pre-gathered rows).
4. Path phase. Resets the launch counters before each run and reads them
   after it; each run must launch its own kernels, and no other: ALSVectorLearner (3
   iterations) and MCMCVectorLearner (4) at config #3 (regression, slot
   statistics), twice more at config #3 with dense_update=False
   (slot_update twice an iteration, no dense_update; test_all within 2e-3
   of the first MCMC run's at every iteration, the same seed making the
   same draws) and with the incremental test tail (dense_update four times
   an iteration, fm_refresh only to build and re-ground A; within 1e-4),
   and at config #4 (classification: case_stats 13 times an
   iteration, fm_refresh's probit mode at the refresh iterations and
   probit_latent at the others; the MCMC run twice at one seed, whose
   P, w0, alpha, hyperpriors and test prediction sum must be equal bit
   for bit), MCMCVectorLearner (4) at config #5
   (classification: slot_stats and schur_draw on each block's dense
   features, dual_draw on its dual ones, 26 blocks an iteration);
   at bench_bs ALSVectorLearner (9 iterations) and MCMCVectorLearner (24:
   test_all must end at or below 0.31, bench_bs's quality target being
   0.3002) on the deferred path and MCMCVectorLearner (4) on the resync
   path (bs_deferred=False), each launching exactly the BS engine's
   kernels as its iterations and refreshes need; at bench_bs_ctx
   ALSVectorLearner (3 iterations, regw = regv = 5; its train RMSE must
   fall) and MCMCVectorLearner (4; test_all below the test targets' sd),
   and at bench_bs_c the same two (MCMC: refreshes at 0 and 3 with
   rel_refresh_probit, probit_latent at 1 and 2; test accuracy above the
   larger class's share), each on the resync path with no test tail and
   exactly its launches (the main blocks' slot_stats, schur_draw and
   slot_update once an iteration each); the exact engines: ALSLearner (3
   iterations, regw = regv = 5; train RMSE must fall) and MCMCLearner (4;
   test_all below the test targets' sd) at config #3, MCMCLearner (4)
   probit at config #4 (accuracy above the larger class's share), at
   bench_bs_ctx ALSLearner (3) and MCMCLearner (4) and at bench_bs_c
   MCMCLearner (4) on the exact BS engine, and ALSVectorLearner (3) with
   bs_vector=False at bench_bs (relational_mode "bs"), each with exactly
   its launches (coord_draw and rel_coord_draw once a block for w and for
   each factor, twice on a block with a long feature, rel_cache 1 + k an
   iteration, the refreshes) and each
   reading printed beside the vector engine's run; SGDLearner for 3 epochs
   at config #1 (regression) and config #4b (classification); SGDALearner for 3 epochs
   at config #1's settings (8M train rows, 1M validation, 1M test) and
   #4b's (1.6M, 200K, 200K), which must launch sgda_step and
   table_scatter once a batch, sgda_lambda once a batch from the second
   epoch, fm_refresh for the evaluations and nothing else. Checks that
   every metric is finite, that no draw was rejected, that the ALS train
   RMSE falls and that every learned regularizer is finite and >= 0;
   prints accuracy, log10-loss and AUC at each config #4 and #5 iteration.
4b. CLI phase. `python -m libfm_tpu_torch.cli` as a user runs it, through
   cli.main on the card: #3's 10M rows written to binary .x/.y and read
   back (seconds printed), MCMC 4 iterations at #3 with -out, -rlog and
   -verbosity 1 (path cli_3), ALS 2 with -save_model and again with
   -load_model (cli_als_3; the model file holds 82,248 rows of 64
   values), ALS 3 at bench_bs through -relation on a binary block and
   binary join maps (cli_bs) and SGD 2 epochs at #1's settings with -rlog
   (cli_sgd_1). Each run other than ALS's two is held against its learner
   run in process with the arguments the CLI derives: the same readings
   at every iteration, the same final bits and the same launches (so an
   rlog adds none); -out against predict() and the rlog's columns
   checked. Prints the phase's seconds.
4c. Options phase (the learner options). The flat engine's
   kernels at k = 0, the pure linear model (P = [w], A = [e]), against
   their plain versions: at config #3 fm_refresh (train mode, test mode
   timed beside), case_stats (also to float64) and slot_stats on both
   blocks, schur_draw's scalar conjugate draw (the plain version's bits),
   dense_update and slot_update on both blocks; at config #4 fm_refresh's
   probit mode and probit_latent at a stride of one float. Then, each with
   its launches: k = 0 ALS 3 and MCMC 4 at #3 on the default route
   (case_stats: both blocks pass the gate at moment width 2), MCMC 2 with
   case_major_stats=False (slot_stats) and with dense_update=False
   (slot_update), probit MCMC 3 at #4 and exact MCMC 2 at #3 (coord_draw's
   w sweep alone), their test RMSE printed; MCMC at #3 (k = 64) and #4
   saved at iteration 4 and resumed from the file twice to 8, and bench_bs
   saved at 12 and resumed twice to 24: the two resumes the same bits, each
   within 1e-4 (5e-3 under probit) of the straight run (mcmc_bs at
   bench_bs), the file's size and the save and load seconds printed;
   predict_new after ALS 3 at #3 on the 1M test rows (the same bits as
   predict()) and at bench_bs chunked (predict_expand_cap 200,000)
   against unchunked (the same bits); ALS 3 at #3 with case reordering
   (case_major_stats=False) within 2e-4 of the same run without.
4d. Stream phase (out-of-core data). #3's train and test sets written
   as libFM binary files; the train set's transpose .xt built by the
   port's tools/transpose.py out of core (a cache of a fifth of its
   entries: 6 passes), its bytes against Dataset.transpose's, the seconds
   printed. Then from StreamingDatasets whose windows cut the train set
   into 9 (the test set into 9): ALS 3 and MCMC 4 with the train set
   streamed (paths stream_als_3, stream_mcmc_3), MCMC 4 with both sets
   streamed (stream_test_3) and the exact engine's MCMC 4 (stream_exact_3),
   each ending in the resident run's bits (P, the sampler state, every
   reading) with its launches; SGD 1 epoch and SGDA 2 (the lambda step
   runs from the second) at #1 through learn_stream, SGDA's validation
   streamed (stream_sgd_1, stream_sgda_1), each the bits of `learn` with
   its batch kernels' launches (fm_refresh differs: no train metric, one
   validation launch a batch); bench_bs's ALS 2 through the command line
   with -relation and -cache_size (stream_bs) equal to the resident
   command line's run; MCMC 2 at #3 through the command line's entry
   point in a child process, streamed (-cache_size a tenth of the train
   .x) and resident, and a third on the ML-100K-sized set (the baseline:
   the process, CUDA and the kernels with next to no data), each child's
   peak host RSS (its VmRSS read every 10 ms), its peak traced by
   tracemalloc (numpy's arrays and Python's objects: the host data) and
   its own #mem line printed; the data's share of the RSS (a peak less
   the baseline's). Set-up and per-iteration seconds, streamed beside
   resident.
5. Probe phase. The ported table probes (libfm_tpu_torch.studies
   pallas_gather.main and pallas_scatter.main) at the studies' shapes,
   each against its plain version; prints ns/row.
6. Prints each phase's seconds, one {"kernels": [...]} line (launches on
   every path that runs each kernel), the per-iteration and per-epoch
   seconds, and as the last line {"ok": true, "device": {...}}.

`--cli` builds the kernels, #3's and bench_bs's data and runs the CLI
phase alone; it prints the CLI paths' launches as one JSON line.
`--stream` builds the kernels, #3's and bench_bs's data and runs the
stream phase alone (with the resident ALS 3, MCMC 4 and exact MCMC 4 at
#3 it compares with); it prints the phase's launches as one JSON line.
`--options` builds the kernels, #3's, #4's and bench_bs's data and runs
the options phase alone (bench_bs's straight MCMC 24 too); it prints the
k = 0 rows and the phase's launches as one JSON line.
`--sgda` runs only SGDA's kernel checks (phase 3's SGDA part) and its two
paths (phase 4's sgda_1 and sgda_4b, traced under `--profile`).
`--config4` runs only config #4's kernel checks and its MCMC path twice
at one seed (the same bits); with `--profile`, its traced probit runs
print their kernel launches at each iteration without a refresh.

`--quality` runs none of that but MCMCVectorLearner to bench.py's 24
iterations (`_cycle_iters` with refresh_every 8) at configs #3, #4 and #5
and prints each final test_all beside bench.py's quality target (test RMSE
0.3541, accuracy 0.7294 and 0.5169) and numpy's version (#5's data
depends on it); a reading that misses its target is printed, not failed.
Then MCMC 24 iterations at bench_bs_ctx and bench_bs_c, which have no
published target: printed beside the test targets' sd and the larger
class's share.

It runs on one card: the first that CUDA_VISIBLE_DEVICES names (card 0
when it is unset), and it hides the others. It imports nothing of jax
or of the JAX package. `--out PATH` also writes every number to a JSON
file. `--config3-kernels` builds the kernels and runs config #3's kernel
checks alone, and prints their rows as one JSON line; `--config5-kernels`
does the same for config #5's dual_draw check, and `--bench-bs` runs
bench_bs's kernel checks and three paths and bench_bs_ctx's kernel checks
and four paths alone, and `--exact` the exact engines' kernel checks and
seven paths (building their data). All four use only the
wrappers' and learners' public calls, so they also time another version
of the package (a checkout of an earlier commit) when copied into that
checkout's root.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
import time
import types

T_START = time.perf_counter()
# one card, set before CUDA starts: torch.cuda.device_count() is then 1
CARD = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
os.environ["CUDA_VISIBLE_DEVICES"] = CARD

import torch  # noqa: E402

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_FP64_FLOPS = 34e12  # H100 SXM fp64 outside the tensor cores (NVIDIA's data sheet)
# config #3 (BASELINE.json): MCMC FM, k=64, ML-10M-shaped one-hot data
USERS, ITEMS, RATINGS, FACTORS, SEED = 71567, 10681, 10_000_000, 64, 1
ALS_ITERS, MCMC_ITERS = 3, 4  # refresh_every=8: both include a non-refresh step
# the SGD configurations of bench.py: #1 (bench_sgd, :90-109) on the ML
# data above, #4b (bench_sgdc, :279-309) on ctr_like(13, 5000, 2M, seed=1)
SGD_CONFIGS = {
    "sgd_1": dict(k=8, task=0, lr=0.003, batch=32768, regw=0.0, regv=0.01),
    "sgd_4b": dict(k=16, task=1, lr=1e-4, batch=8192, regw=0.01, regv=0.01),
}
SGD_EPOCHS = 3
# SGDA (learners/sgda.py, K13) with config #1's and #4b's data and
# settings; the regularizers are learned per group (users and items at
# #1, the 13 fields at #4b) on a validation set carved from the train
# rows: a seeded random ninth (HOLDOUT_SEED), the test set untouched
SGDA_CONFIGS = {"sgda_1": "sgd_1", "sgda_4b": "sgd_4b"}
SGDA_EPOCHS = 3
HOLDOUT_SEED = 7
# SGDA's kernels against their plain versions over an epoch. In lockstep
# (every batch from the kernels' state): the update rows, the table after
# the scatter and the cache rows 1e-4 relative per column, as SGD's; the
# regularizers after a lambda step, beyond two ulps of their value, 1e-3
# of the step the plain version takes (the step sums over a validation
# batch of up to 32,768 rows in f32, the tests' 1,000 rows hold 1e-4).
# Free-running to the epoch's end:
# table and caches 1e-4 per column, the regularizers 1e-3 of their
# largest value; w0 is recorded (its line is chaotic at #1's batch size,
# ROADMAP §3) and held bitwise in lockstep.
SGDA_TOL, SGDA_REG_TOL = 1e-4, 1e-3
CTR_FIELDS, CTR_CARD, CTR_EXAMPLES = 13, 5000, 2_000_000
# config #4 (bench.py:236-277, bench_ctr): MCMC probit classification on
# the same CTR data, k=16, the 13 fields as groups; ALS with regw = regv = 5
# as at config #3
CTR_FACTORS, CTR_ALS_ITERS, CTR_MCMC_ITERS = 16, 3, 4
# fm_refresh's probit latents are held to the plain draw on the kernel's
# predictions, which come back as e + latent, to an ulp. An ulp of pred can
# move u = a + (1 - a) U by its own ulp, and a draw z = sqrt2 erfinv(u)
# from its mean by ~6e-8 / (|z| (1 - u)): 2e-6 at |z| = 2.5, 4e-4 at 3.9,
# so the draws are checked where |z| <= 2.5
LATENT_CHECKED = 2.5
# case_stats (and slot_stats at config #4) against the float64 plain
# version: the largest error over the entry's sum of magnitudes
CASE_STATS_TOL = 6e-7
# config #5 (bench.py:337-389, bench_largevocab): MCMC probit
# classification, k=128, on ctr_like(26, 40000, 3M, seed=1) with the 26
# fields as groups; nothing cut but the iterations
LV_FIELDS, LV_CARD, LV_EXAMPLES, LV_FACTORS, LV_MCMC_ITERS = 26, 40_000, 3_000_000, 128, 4
# the dual features by the JAX engine's rule (mcmc_vector.py:731-763):
# each of #5's blocks has a head of more than 4,096 entries, so
# build_block_layout cuts it on the width ladder (32, 256), which gives a
# feature of 1 to 32 entries one whole segment of width 32 < d = 129 and
# any other feature two segments or one of width 256 > 64. So the dual
# features are those of 1 to 32 train entries, counted straight from the
# rows (numpy 2.0.2's zipf draws 890,171 of them, 303,277 of 1 or 2
# entries; another numpy version draws other data)
LV_DUAL_MAX, LV_WHOLE_MAX = 32, 4096
# dual_draw against its plain version: the largest |difference| over
# max(1, |theta|). K = I + Phi D^-1 Phi^T >= I, so ||K^-1|| <= 1 and the
# f32 sums (the Gram's dot products of length 129, taken in another order)
# move theta by ~1e-6 of its scale
DUAL_TOL = 1e-4
# timed runs of a plain version that takes a third of a second (config #5's
# dual_draw_plain): its time is recorded, not compared, so the median of 3
PLAIN_REPS = 3
# bench_bs (bench.py:392-455): fat-block relational (BS) regression, 1M
# train and 100K test cases joined to one relation of 4,000 block rows of
# 16 gaussian entries over 20,000 features, k=32, the data drawn from
# default_rng(7); the join expands ~15x, above expand_max_ratio = 8, so the
# learner's default routing takes the BS vector engine
BS_NB, BS_W, BS_NF, BS_NTR, BS_FACTORS, BS_SEED = 4000, 16, 20000, 1_000_000, 32, 7
# ALS (regw = regv = 5, as at config #3) 9 iterations and MCMC 24
# (bench_bs's own count, _cycle_iters with refresh_every 8) on the deferred
# path; MCMC 4 on the resync path (bs_deferred=False)
BS_ALS_ITERS, BS_MCMC_ITERS, BS_RESYNC_ITERS = 9, 24, 4
# bench_bs's quality target, a test RMSE after 24 iterations (BENCH_r05.json,
# a quality value), and the limit this run holds: the data's noise floor is
# 0.3, predicting the prior mean reads about 0.5
BS_TARGET, BS_LIMIT = 0.3002, 0.31
# bench_bs_ctx: bench_bs's data with a main table of two one-hot context
# fields, day (1,000 values) and hour (168), the VLDB 2013 shape (context
# in the main table, entity attributes in the block): gD, gH, day and hour
# drawn in that order from default_rng(8) after bench_bs's data; main ids
# day -> d, hour -> 1000 + h, value 1; the relation's features from 1,168
# on; the regression target bench_bs's + 0.2 gD[day] + 0.2 gH[hour], the
# probit target (bench_bs_c) +1 where that is > 0, else -1. k = 32 and
# expand_max_ratio = 0, as bench.py sets for bench_bs (with the main table
# the join's ratio falls to ~5.9, which would expand it). ALS (regw = regv
# = 5) 3 iterations and MCMC 4 at each task: every path on the resync
# path, with no test tail
BS_CTX_SEED, BS_DAYS, BS_HOURS, BS_CTX_WEIGHT = 8, 1000, 168, 0.2
BS_CTX_ALS_ITERS, BS_CTX_MCMC_ITERS = 3, 4
# rel_refresh with main rows against its plain version: A per column
# (1e-4 of the column's largest value), the summed error 1e-6 relative
BS_CTX_A_TOL, BS_CTX_SUM_TOL = 1e-4, 1e-6
# the exact engines' draws (coord_draw, rel_coord_draw) against their plain
# versions from one state with the same normals: theta and the caches, the
# largest difference over max(1, the plain version's largest magnitude).
# The per-feature sums run in another float32 order (a CTA's strided
# partials against a pairwise sum in slot order)
EXACT_TOL = 1e-5
# ... or, where larger, this many times the float32 plain version's own
# distance from the plain version in float64 on the same launch
EXACT_SLACK = 3.0
# config #3's K4b paths against the `mcmc` run of the same seed (the same
# draws; only the order of float32 sums differs): the slot scatter within
# the JAX test's own band (tests/test_mcmc_vector.py:213-232), the
# incremental test tail within 1e-4
K4B_SCATTER_TOL, K4B_TAIL_TOL = 2e-3, 1e-4
# --quality: bench.py's iterations (_cycle_iters at refresh_every 8) and
# quality targets (BENCH_r05.json): test RMSE at #3, accuracy at #4 and #5
QUALITY_ITERS = 24
QUALITY_TARGETS = {"quality_3": 0.3541, "quality_4": 0.7294, "quality_5": 0.5169}
# the CLI phase (libfm_tpu_torch/cli.py, `python -m libfm_tpu_torch.cli`):
# MCMC 4 iterations at #3 with -out and -rlog, ALS 2 iterations there with
# -save_model and again with -load_model (regw = regv = 5, as the ALS
# paths above), ALS 3 at bench_bs through -relation, SGD 2 epochs at #1
CLI_MCMC_ITERS, CLI_ALS_ITERS, CLI_BS_ITERS, CLI_SGD_EPOCHS = 4, 2, 3, 2
# the options phase (run_options): the pure linear model (k = 0) at #3,
# ALS 3 and MCMC 4 on the default route, MCMC 2 with case_major_stats=False
# and with dense_update=False, exact MCMC 2; probit MCMC 3 at #4 (refreshes
# at 0 and 2, probit_latent at 1)
OPT_K0_ALS_ITERS, OPT_K0_MCMC_ITERS, OPT_K0_SHORT_ITERS, OPT_K0_PROBIT_ITERS = 3, 4, 2, 3
# checkpoints: MCMC saved at iteration 4 and resumed to 8 at #3 and #4, at
# 12 and resumed to 24 at bench_bs (mcmc_bs the straight run); the resumed
# readings against the straight run's: JAX's own tolerances
# (tests/test_checkpoint.py), 1e-4 (vector engines) and 5e-3 under probit;
# at bench_bs the band its deferred path keeps from the resync path
# (tests/test_torch_bs_vector.py), 2e-4: the resumed run re-grounds C and
# SD at 11 and 12, where the straight one carries them to 15
OPT_CKPT_HALF, OPT_BS_HALF = 4, 12
OPT_RESUME_TOL, OPT_RESUME_PROBIT_TOL, OPT_RESUME_BS_TOL = 1e-4, 5e-3, 2e-4
# predict_new at bench_bs after ALS 3: unchunked (the test join's 1.6M
# entries, under predict_expand_cap) and chunked under this cap
OPT_BS_ALS_ITERS, OPT_PREDICT_CAP = 3, 200_000
# case reordering: the ALS readings against the unordered run's (the JAX
# test's band, tests/test_mcmc_vector.py:345-371)
OPT_REORDER_TOL = 2e-4
# the stream phase (run_stream): the out-of-core transpose's cache a fifth
# of #3's train entries (a counting pass and 5 column blocks), the
# StreamingDatasets' windows a ninth of each set's entries; SGD 1 epoch
# and SGDA 2 (its lambda step runs from the second) at #1; bench_bs's ALS
# 2 through the command line with -cache_size 100,000 B; MCMC 2 at #3 in
# a child process
# each, -cache_size a tenth of the train .x
STREAM_CACHE_PARTS, STREAM_WINDOWS = 5, 9
STREAM_SGD_EPOCHS, STREAM_SGDA_EPOCHS, STREAM_BS_ITERS, STREAM_CHILD_ITERS = 1, 2, 2, 2
STREAM_BS_CACHE = 100_000
U32 = 2.0 ** -24  # float32's unit roundoff
HOT_ROWS = 1024  # the gather-against-streaming line's small table
FEW_ROWS = 4  # a field of few values (the skewed line)
ZIPF = 1.2  # ctr_like's default power of a field's values
# the kernels each path must launch
EXPECTED = {
    "als": {"fm_refresh", "slot_stats", "schur_draw", "dense_update"},
    "mcmc": {"fm_refresh", "slot_stats", "schur_draw", "dense_update"},
    "mcmc_scatter": {"fm_refresh", "slot_stats", "schur_draw", "slot_update"},
    "mcmc_tail": {"fm_refresh", "slot_stats", "schur_draw", "dense_update"},
    "als_4": {"fm_refresh", "fm_refresh_probit", "case_stats", "schur_draw",
              "dense_update", "probit_latent"},
    "mcmc_4": {"fm_refresh", "fm_refresh_probit", "case_stats", "schur_draw",
               "dense_update", "probit_latent"},
    "mcmc_5": {"fm_refresh", "fm_refresh_probit", "slot_stats", "schur_draw",
               "dual_draw", "dense_update", "probit_latent"},
    "sgd_1": {"sgd_step", "table_scatter", "fm_refresh"},
    "sgd_4b": {"sgd_step", "table_scatter", "fm_refresh"},
    "sgda_1": {"sgda_step", "table_scatter", "sgda_lambda", "fm_refresh"},
    "sgda_4b": {"sgda_step", "table_scatter", "sgda_lambda", "fm_refresh"},
    "probes": {"table_read", "table_scatter"},
    **{name: {"rel_scores", "rel_refresh", "rel_cache", "rel_stats", "schur_draw",
              "rel_update", "rel_resync"} for name in ("als_bs", "mcmc_bs", "mcmc_bs_resync")},
}
EXPECTED.update({name: EXPECTED["mcmc_bs_resync"] | {"slot_stats", "slot_update"}
                 for name in ("als_bs_ctx", "mcmc_bs_ctx")})
# the deferred path's closed-form sums (K10's `_deferred_sums`)
EXPECTED.update({name: EXPECTED[name] | {"rel_deferred"} for name in ("als_bs", "mcmc_bs")})
EXPECTED.update({name: EXPECTED["mcmc_bs_ctx"] | {"rel_refresh_probit", "probit_latent"}
                 for name in ("als_bs_c", "mcmc_bs_c")})
EXPECTED.update({name: {"coord_draw", "fm_refresh"} for name in ("als_exact_3", "exact_3")})
EXPECTED["exact_4"] = {"coord_draw", "fm_refresh", "fm_refresh_probit"}
EXPECTED["bs_fallback"] = {"rel_coord_draw", "rel_cache", "rel_scores", "rel_refresh"}
EXPECTED.update({name: EXPECTED["bs_fallback"] | {"coord_draw"}
                 for name in ("als_exact_bs_ctx", "exact_bs_ctx")})
EXPECTED["exact_bs_c"] = EXPECTED["exact_bs_ctx"] | {"rel_refresh_probit"}
EXPECTED["mcmc_4_again"] = EXPECTED["mcmc_4"]
EXPECTED.update(cli_3=EXPECTED["mcmc"], cli_als_3=EXPECTED["als"], cli_bs=EXPECTED["als_bs"],
                cli_sgd_1=EXPECTED["sgd_1"])
# the options phase: k = 0 on the default route (case_stats), the slot
# statistics, the slot scatter, probit at #4 and the exact engine; the
# checkpointed chains' and predict_new's paths
EXPECTED.update(
    als_k0_3={"fm_refresh", "case_stats", "schur_draw", "dense_update"},
    mcmc_k0_3={"fm_refresh", "case_stats", "schur_draw", "dense_update"},
    mcmc_k0_slot_3=EXPECTED["mcmc"], mcmc_k0_scatter_3=EXPECTED["mcmc_scatter"],
    mcmc_k0_4=EXPECTED["mcmc_4"], exact_k0_3=EXPECTED["exact_3"],
    **{f"ckpt_{kind}_{c}": EXPECTED[run] for c, run in (
        ("3", "mcmc"), ("4", "mcmc_4"), ("bs", "mcmc_bs")) for kind in (
        "straight", "save", "resume", "resume_again") if (kind, c) != ("straight", "bs")},
    als_pn_3=EXPECTED["als"], als_reorder_3=EXPECTED["als"], als_pn_bs=EXPECTED["als_bs"],
    predict_new_3={"fm_refresh"}, predict_new_bs={"fm_refresh"})
# the stream phase's paths: the resident runs' kernels
EXPECTED.update(stream_als_3=EXPECTED["als"], stream_mcmc_3=EXPECTED["mcmc"],
                stream_test_3=EXPECTED["mcmc"], stream_exact_3=EXPECTED["exact_3"],
                stream_sgd_1=EXPECTED["sgd_1"], resident_sgd_1=EXPECTED["sgd_1"],
                stream_sgda_1=EXPECTED["sgda_1"], resident_sgda_1=EXPECTED["sgda_1"],
                stream_bs=EXPECTED["als_bs"], resident_bs=EXPECTED["als_bs"])
EXPECTED.update(quality_3=EXPECTED["mcmc"], quality_4=EXPECTED["mcmc_4"],
                quality_5=EXPECTED["mcmc_5"], quality_bs_ctx=EXPECTED["mcmc_bs_ctx"],
                quality_bs_c=EXPECTED["mcmc_bs_c"])


#: the first versions' times of case_stats (config #4's 13 blocks) and
#: slot_update, as PERF.md §6 keeps them (H100 80GB HBM3, 700 W), printed
#: beside this run's
CASE_STATS_FIRST_MS = 3.229
SLOT_UPDATE_FIRST_MS = {"config #3": 5.776, "bench_bs_ctx": 0.4640}
#: ... and at bench_bs rel_cache's and the standalone rel_update's (one
#: iteration's 23 launches), which schur_draw's relational form replaced
REL_CACHE_FIRST_MS, REL_UPDATE_FIRST_MS = 0.2533, 0.0680
#: ... and rel_resync's (one warp a case): read-only on the 100K test tail,
#: write mode on the 1M train rows
REL_RESYNC_FIRST_MS = {"read-only": 0.0157, "write": 0.1777}
#: ... and table_read's at probes P1 and P3 (the one-launch L2 form's
#: predecessor: partials, then a combine launch)
TABLE_READ_FIRST_MS = {"P1": 0.0797, "P3": 0.0793}
#: ... and at k = 0, dense_update's and slot_update's tiled and staged
#: kernels' k = 0 instances on config #3's 2 blocks, which their k = 0
#: kernels replaced
K0_FIRST_MS = {"dense_update": 2.1194, "slot_update": 1.8759}
#: rows of the table past a one-column slice, which table_read reads on
#: its l2 form (128 columns: 32 MB, within the 50 MB L2)
TALL_NSUB = 65_536


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    from libfm_tpu_torch.utils.timers import device_ms

    return device_ms(fn, reps, warmup)


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_FLOPS):
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def kernel_row(name, replaces, err, tol, ms, plain_ms, nbytes, flops, lib_ms,
               timed, label="", source=None, peak_flops=PEAK_FP32_FLOPS):
    """One row of the kernels line: fails when `err` exceeds `tol`."""
    bms, by = bound_ms(nbytes, flops, peak_flops)
    print(f"{name}{label}: err={err:.3g} (tol {tol:g}) ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}) "
          f"library_ms={lib_ms}")
    if not err <= tol:
        fail(f"{name}{label} disagrees with its plain version: {err} > {tol}")
    return dict(
        name=name, route="cuda", source=source or f"libfm_tpu_torch/csrc/{name}.cu",
        replaces=replaces, launches=0, max_abs_err=err, tolerance=tol,
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=lib_ms, timed=timed,
    )


def fill_launches(table, counts):
    """Set each row's launches: its kernel's on every path run, in all and
    by path (`counts`: path -> launch counts)."""
    for row in table:
        by_path = {p: c[row["name"]] for p, c in counts.items() if c[row["name"]]}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path


def bits(*tensors) -> str:
    """A digest of the tensors' bytes (16 hex digits): two runs, or two
    commits run on the same inputs, print the same digest exactly when
    their outputs are the same bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def note_bits(label, rec, *tensors):
    """Print and keep the tensors' digest under `label`."""
    digest = bits(*tensors)
    print(f"{label}: digest {digest}")
    rec.setdefault("digests", {})[label] = digest


def repeat_check(label, first, again, rec):
    """Fail unless two launches on the same inputs gave the same bits;
    print and keep the outputs' digest (what an A/B against an earlier
    commit compares)."""
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    digest = bits(*first)
    print(f"{label}: two launches the same bits: {same}; digest {digest}")
    rec.setdefault("digests", {})[label] = digest
    if not same:
        fail(f"{label}: a second launch on the same inputs gave other bits")


def col_rel_err(a, b):
    """Largest difference per column over the column's largest value (a
    0-dim tensor)."""
    return ((a - b).abs().amax(dim=0) / b.abs().amax(dim=0).clamp_min(1e-12)).max()


def kernel_checks(args, rec, dev):
    """Phase 3: every kernel of the vector engine against its plain
    version at config #3."""
    import numpy as np

    from libfm_tpu_torch.data.batching import conflict_free_blocks
    from libfm_tpu_torch.data.synth import movielens_like
    from libfm_tpu_torch.data.vector_layout import padded_rows_layout
    from libfm_tpu_torch.kernels import case_stats as cs
    from libfm_tpu_torch.kernels import dense_update as du
    from libfm_tpu_torch.kernels import fm_refresh as fr
    from libfm_tpu_torch.kernels import schur_draw as sd
    from libfm_tpu_torch.kernels import slot_stats as ss
    from libfm_tpu_torch.learners.mcmc_vector import DevBlock

    k, d = FACTORS, FACTORS + 1
    T = k * (k + 1) // 2
    GW = T + 2 * k + 2
    # the learner's set-up steps, timed one by one (host clock)
    setup = {}
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    setup["cuda_context"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train, test = movielens_like(USERS, ITEMS, RATINGS, seed=SEED)
    n, nc = train.num_features, train.num_rows
    setup["movielens_like"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fblocks = conflict_free_blocks(train)
    setup["conflict_free_blocks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    blocks = [DevBlock(b, np.zeros(len(b.features), np.int32), nc, dev, k, True)
              for b in fblocks]
    if any(b.case_major for b in blocks):
        fail("config #3: a block took the case-major path")
    torch.cuda.synchronize()
    setup["DevBlock"] = time.perf_counter() - t0
    for b in fblocks:
        cnt = np.bincount(b.entry_feat)
        print(f"block: F={len(b.features)} slots={int(b.entry_rows.size)} "
              f"per feature max {int(cnt.max())} mean {cnt.mean():.1f}")
    del fblocks
    t0 = time.perf_counter()
    ids, vals = (torch.as_tensor(x, device=dev) for x in
                 padded_rows_layout(train.indptr, train.cols, train.vals))
    te_ids, te_vals = (torch.as_tensor(x, device=dev) for x in
                       padded_rows_layout(test.indptr, test.cols, test.vals))
    torch.cuda.synchronize()
    setup["padded_rows_layout"] = time.perf_counter() - t0
    y = torch.as_tensor(train.target, device=dev)
    L = ids.shape[1]
    rec["setup_step_seconds"] = setup
    print(f"data: {nc} train rows, {test.num_rows} test rows, {n} features; "
          f"set-up steps (s): {setup}")

    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    P = 0.1 * torch.randn(n, d, generator=g, device=dev)
    w0 = torch.tensor(3.5, device=dev)
    out = []

    def entry(*a, timed="one iteration's launches: one per block", **kw):
        out.append(kernel_row(*a, timed=timed, **kw))

    # ---- A. fm_refresh (train mode; test mode checked alongside)
    A_k = torch.empty(nc, d, device=dev)
    A_p = torch.empty(nc, d, device=dev)
    kw = dict(use_linear=True, use_bias=True, min_target=1.0, max_target=5.0)
    sse_k = fr.fm_refresh(P, ids, vals, w0, y, A_k, **kw)
    sse_p = fr.fm_refresh_plain(P, ids, vals, w0, y, A_p, **kw)
    pt_k = fr.fm_refresh(P, te_ids, te_vals, w0)
    pt_p = fr.fm_refresh_plain(P, te_ids, te_vals, w0)
    torch.cuda.synchronize()
    err = max(
        (A_k - A_p).abs().max().item(),
        (pt_k - pt_p).abs().max().item(),
        abs(sse_k.item() - sse_p.item()) / max(1.0, abs(sse_p.item())),
    )
    entry(
        "fm_refresh", "libfm_tpu/learners/mcmc_vector.py:1117", err, 1e-4,
        cuda_ms(lambda: fr.fm_refresh(P, ids, vals, w0, y, A_k, **kw), args.reps),
        cuda_ms(lambda: fr.fm_refresh_plain(P, ids, vals, w0, y, A_p, **kw), args.reps),
        nbytes=nc * L * 8 + nc * 4 + n * d * 4 + nc * d * 4,
        flops=nc * (L * (4 * k + 2) + 2 * k + 8),
        lib_ms=None, timed="one train-mode launch (the refresh)",
    )
    # the test-mode launch, one on every iteration, timed beside it
    nt, Lt = te_ids.shape
    out[-1]["test_mode_ms"] = cuda_ms(lambda: fr.fm_refresh(P, te_ids, te_vals, w0),
                                      args.reps)
    out[-1]["test_mode_plain_ms"] = cuda_ms(
        lambda: fr.fm_refresh_plain(P, te_ids, te_vals, w0), args.reps)
    out[-1]["test_mode_bound_ms"] = bound_ms(nt * Lt * 8 + nt * 4 + n * d * 4, 0)[0]
    print(f"fm_refresh test mode: ms={out[-1]['test_mode_ms']:.4f} "
          f"plain_ms={out[-1]['test_mode_plain_ms']:.4f} "
          f"bound_ms={out[-1]['test_mode_bound_ms']:.4f} (bytes)")
    # gather against streaming: every id on table row 0 (hot in L1), or
    # on the first HOT_ROWS rows (hot in L2), beside the real ids
    hot = {"fm_refresh train, real ids": out[-1]["ms"],
           "fm_refresh test, real ids": out[-1]["test_mode_ms"]}
    for label, few in (("row 0", lambda i: torch.zeros_like(i)),
                       (f"{HOT_ROWS} rows", lambda i: i % HOT_ROWS)):
        ids0, te_ids0 = few(ids), few(te_ids)
        hot[f"fm_refresh train, {label}"] = cuda_ms(
            lambda: fr.fm_refresh(P, ids0, vals, w0, y, A_k, **kw), args.reps)
        hot[f"fm_refresh test, {label}"] = cuda_ms(
            lambda: fr.fm_refresh(P, te_ids0, te_vals, w0), args.reps)
    del ids0, te_ids0
    fr.fm_refresh(P, ids, vals, w0, y, A_k, **kw)
    A = A_k
    del A_p

    # ---- B. slot_stats (both blocks = one iteration's launches)
    GG_k = [torch.empty(b.F, GW, device=dev) for b in blocks]
    errs = []
    for b, G in zip(blocks, GG_k):
        ss.slot_stats(A, P, b.feat_off, b.slot_case, b.slot_val, b.feat_id, GG=G,
                      pieces=b.pieces)
        Gp = ss.slot_stats_plain(A, P, b.feat_off, b.slot_case, b.slot_val, b.feat_id)
        torch.cuda.synchronize()
        errs.append(ss.gg_rel_err(G, Gp, k))
        del Gp

    def run_stats(fn, GGs=GG_k, plans=None, **kw):
        def go():
            for i, (b, G) in enumerate(zip(blocks, GGs)):
                fn(A, P, b.feat_off, b.slot_case, b.slot_val, b.feat_id, GG=G,
                   pieces=b.pieces if plans is None else plans[i], **kw)
        return go

    E = sum(int(b.slot_case.numel()) for b in blocks)
    Fsum = sum(b.F for b in blocks)
    entry(
        "slot_stats", "libfm_tpu/learners/mcmc_vector.py:1428", max(errs), 1e-4,
        cuda_ms(run_stats(ss.slot_stats), args.reps),
        cuda_ms(run_stats(ss.slot_stats_plain), args.reps, warmup=1),
        nbytes=E * (8 + d * 4) + Fsum * (4 + 8 + k * 4 + GW * 4),
        flops=E * (2 * T + 7 * k + 4),
        lib_ms=None,
    )
    rec["slot_stats_rel_err_per_block"] = errs
    # case_stats on the same blocks, which the JAX engine's gate keeps on
    # the slot path (Fd * MW far above 8e6): the other kernel's time here
    if not all(b.onehot for b in blocks):
        fail("config #3: a block is not one-hot")
    GG_c = [torch.empty(b.F, GW, device=dev) for b in blocks]
    plans = [cs.CaseStatsPlan(b.feat_off, k, dev) for b in blocks]
    run_stats(cs.case_stats, GG_c, plans, onehot=True)()
    torch.cuda.synchronize()
    cs_err = max(ss.gg_rel_err(Gc, Gk, k) for Gc, Gk in zip(GG_c, GG_k))
    out[-1]["case_stats_same_blocks"] = dict(
        ms=cuda_ms(run_stats(cs.case_stats, GG_c, plans, onehot=True), args.reps),
        rel_err_against_slot_stats=cs_err, tolerance=1e-4)
    print(f"case_stats on config #3's blocks: ms "
          f"{out[-1]['case_stats_same_blocks']['ms']:.4f} against slot_stats "
          f"{out[-1]['ms']:.4f}; GG rel err against slot_stats {cs_err:.3g} (tol 1e-4)")
    if not cs_err <= 1e-4:
        fail(f"case_stats and slot_stats disagree at config #3: {cs_err}")
    del GG_c, plans

    # ---- C. schur_draw (both blocks; sampling mode, mean mode checked too)
    alpha = torch.tensor(2.0, device=dev)
    sys_in = []
    for b, G in zip(blocks, GG_k):
        theta = P[b.features].contiguous()
        lam = torch.full((b.F, d), 5.0, device=dev)
        mu = 0.01 * torch.randn(b.F, d, generator=g, device=dev)
        z = torch.randn(b.F, d, generator=g, device=dev)
        sys_in.append((G, theta, lam, mu, z))
    bound = 1e6 * 5.0
    errs, nrej = [], 0
    for G, theta, lam, mu, z in sys_in:
        for samp in (True, False):
            tk, rk = sd.schur_draw(G, theta, lam, mu, z, alpha, do_sample=samp, bound=bound)
            tp, rp = sd.schur_draw_plain(G, theta, lam, mu, z, alpha, do_sample=samp, bound=bound)
            torch.cuda.synchronize()
            errs.append(((tk - tp).abs().max() / tp.abs().max().clamp_min(1.0)).item())
            if not torch.equal(rk, rp):
                fail("schur_draw reject flags differ from the plain version")
            nrej += int(rk.sum().item())
    # the reject path at full size: every 4th feature gets a prior
    # precision far below minus its Gram's largest diagonal, so S is not
    # positive definite there; flags must equal the plain version's
    diag = torch.as_tensor([k * i - i * (i - 1) // 2 for i in range(k)], device=dev)
    npd = []
    for G, theta, lam, mu, z in sys_in:
        bad_lam = lam.clone()
        bad_lam[::4, 1:] = -10.0 * (alpha * G[:, diag].max() + 1.0)
        tk, rk = sd.schur_draw(G, theta, bad_lam, mu, z, alpha, do_sample=True, bound=bound)
        tp, rp = sd.schur_draw_plain(G, theta, bad_lam, mu, z, alpha, do_sample=True,
                                     bound=bound)
        torch.cuda.synchronize()
        errs.append(((tk - tp).abs().max() / tp.abs().max().clamp_min(1.0)).item())
        if not torch.equal(rk, rp):
            fail("schur_draw reject flags differ from the plain version on the "
                 "batch that is not positive definite")
        npd.append((int(rk.sum().item()), int(rk[::4].sum().item()), G.shape[0]))
    print(f"schur_draw, systems not positive definite on every 4th feature: "
          f"rejected (all, of those) / systems per block {npd}; flags equal the plain "
          f"version's")
    if any(of_those != (F + 3) // 4 for _, of_those, F in npd):
        fail(f"schur_draw kept a draw from a system that is not positive definite: {npd}")
    rec["schur_draw_not_pd_rejected"] = npd

    def run_draw(fn):
        def go():
            for G, theta, lam, mu, z in sys_in:
                fn(G, theta, lam, mu, z, alpha, do_sample=True, bound=bound)
        return go

    S_lib = [sd.schur_system(G, theta, lam, mu, alpha)[0] for G, theta, lam, mu, _ in sys_in]
    rhs_lib = [torch.randn(S.shape[0], k, 1, generator=g, device=dev) for S in S_lib]

    def run_lib():
        for S, r in zip(S_lib, rhs_lib):
            Lf = torch.linalg.cholesky(S)
            yv = torch.linalg.solve_triangular(Lf, r, upper=False)
            torch.linalg.solve_triangular(Lf.transpose(-1, -2), yv, upper=True)

    entry(
        "schur_draw", "libfm_tpu/learners/mcmc_vector.py:1553", max(errs), 1e-3,
        cuda_ms(run_draw(sd.schur_draw), args.reps),
        cuda_ms(run_draw(sd.schur_draw_plain), args.reps),
        nbytes=Fsum * (GW * 4 + 5 * d * 4 + 4),
        flops=Fsum * (k ** 3 / 3 + 6 * k * k),
        lib_ms=cuda_ms(run_lib, args.reps),
    )
    rec["schur_draw_rejected_in_check"] = nrej
    del S_lib, rhs_lib

    # ---- D. dense_update (both blocks, in place on copies of A)
    tabs = []
    for b, (G, theta, lam, mu, z) in zip(blocks, sys_in):
        tnew, _ = sd.schur_draw(G, theta, lam, mu, z, alpha, do_sample=True, bound=bound)
        tabs.append(du.update_table(theta, tnew))
    A_k = A.clone()
    A_p = A.clone()
    for b, tab in zip(blocks, tabs):
        du.dense_update(A_k, b.up_col, b.up_val, tab)
        du.dense_update_plain(A_p, b.up_col, b.up_val, tab)
    torch.cuda.synchronize()
    err = (A_k - A_p).abs().max().item()

    def run_upd(fn, A_):
        def go():
            for b, tab in zip(blocks, tabs):
                fn(A_, b.up_col, b.up_val, tab)
        return go

    covered = sum(int((b.up_col != b.F).sum().item()) for b in blocks)
    entry(
        "dense_update", "libfm_tpu/learners/mcmc_vector.py:1766", err, 1e-4,
        cuda_ms(run_upd(du.dense_update, A_k), args.reps),
        cuda_ms(run_upd(du.dense_update_plain, A_p), args.reps),
        nbytes=len(blocks) * nc * 4 + covered * d * 8
        + sum((b.F + 1) * (d + 1) * 4 for b in blocks),
        flops=covered * (4 * k + 6),
        lib_ms=None,
    )
    hot["dense_update, real ids"] = out[-1]["ms"]
    # the skewed blocks of CTR data: a field's few values put many cases
    # of a tile on one table row
    zipf = torch.as_tensor(np.random.default_rng(SEED).zipf(ZIPF, nc) - 1, device=dev)
    for label, few in (("row 0", lambda c, F: torch.zeros_like(c)),
                       (f"{FEW_ROWS} rows", lambda c, F: c % FEW_ROWS),
                       (f"Zipf({ZIPF}) ranks", lambda c, F: zipf % F),
                       (f"{HOT_ROWS} rows", lambda c, F: c % HOT_ROWS)):
        cols0 = [torch.where(b.up_col != b.F, few(b.up_col, b.F), b.F).to(torch.int32)
                 for b in blocks]
        A0, A0_p = A.clone(), A.clone()
        for b, c0, tab in zip(blocks, cols0, tabs):
            du.dense_update(A0, c0, b.up_val, tab)
            du.dense_update_plain(A0_p, c0, b.up_val, tab)
        skew_err = (A0 - A0_p).abs().max().item()
        if not skew_err <= 1e-4:
            fail(f"dense_update with every covered case on {label} disagrees with "
                 f"its plain version: {skew_err} > 0.0001")
        del A0, A0_p

        def run_few():
            for b, c0, tab in zip(blocks, cols0, tabs):
                du.dense_update(A_k, c0, b.up_val, tab)

        hot[f"dense_update, {label}"] = cuda_ms(run_few, args.reps)
    rec["table_row0_against_real_ids_ms"] = hot
    print(f"gather against streaming on {rec['card']}, ms: every id on table row 0, "
          f"on {FEW_ROWS} rows, on Zipf({ZIPF}) ranks (dense_update) or on {HOT_ROWS} "
          f"rows against the real ids {hot}")
    del A_k, A_p, cols0, zipf
    out.append(slot_update_check(args, dev, A, blocks, tabs, run_upd))
    tail_checks(args, rec, dev, out, test, te_ids, te_vals, P, w0, nc, blocks, tabs)
    del A, GG_k, sys_in, tabs, blocks
    torch.cuda.empty_cache()
    return out, (train, test)


def slot_update_check(args, dev, A, blocks, tabs, run_upd):
    """Config #3's slot_update row: both blocks through their slots in case
    order (K4b, as the learner runs them with dense_update=False: each
    block's own list, `case_order`) from the same A and update tables,
    against the plain version and against dense_update on the same blocks,
    which is timed beside it; the kernel on the per-feature lists (the
    first version's order) timed beside it too, and held to the same bits.
    Tolerance per column, the largest difference over the column's largest
    magnitude, 1e-5: each Q entry takes one float32 product and sum, each
    e entry a k-term dot product in another order."""
    import numpy as np

    from libfm_tpu_torch.kernels import dense_update as du
    from libfm_tpu_torch.kernels import slot_update as su

    k, d = FACTORS, FACTORS + 1
    by_feature, by_case = [], []
    for b in blocks:
        lists = (b.slot_case.cpu().numpy(), b.slot_val.cpu().numpy(),
                 np.repeat(np.arange(b.F, dtype=np.int32), np.diff(b.feat_off.cpu().numpy())))
        by_feature.append([torch.as_tensor(a, device=dev) for a in lists])
        by_case.append([torch.as_tensor(a, device=dev) for a in su.case_order(*lists)])

    def run_slots(fn, A_, lists=by_case):
        def go():
            for (c, v, f), tab in zip(lists, tabs):
                fn(A_, c, v, f, tab)
        return go

    A_k, A_p, A_d, A_f = A.clone(), A.clone(), A.clone(), A.clone()
    run_slots(su.slot_update, A_k)()
    run_slots(su.slot_update_plain, A_p)()
    run_upd(du.dense_update, A_d)()
    run_slots(su.slot_update, A_f, by_feature)()
    torch.cuda.synchronize()
    err = col_rel_err(A_k, A_p).item()
    err_dense = col_rel_err(A_k, A_d).item()
    same_bits = torch.equal(A_k, A_f)
    del A_d, A_f
    E = sum(int(c.numel()) for c, _, _ in by_case)
    row = kernel_row(
        "slot_update", "libfm_tpu/learners/mcmc_vector.py:1842", err, 1e-5,
        cuda_ms(run_slots(su.slot_update, A_k), args.reps),
        cuda_ms(run_slots(su.slot_update_plain, A_p), args.reps, warmup=1),
        nbytes=E * (12 + 2 * d * 4) + sum((b.F + 1) * (d + 1) * 4 for b in blocks),
        flops=E * (4 * k + 6), lib_ms=None,
        timed="one iteration's launches at dense_update=False: one per block, the slots "
              "in case order",
    )
    row["library_note"] = ("none: no one PyTorch call gathers the slots' rows of A, dots "
                           "them with their features' table rows and adds the rows back")
    row["dense_update_same_blocks_ms"] = cuda_ms(run_upd(du.dense_update, A_k), args.reps)
    row["feature_order_ms"] = cuda_ms(run_slots(su.slot_update, A_k, by_feature), args.reps)
    row["rel_err_against_dense_update"] = err_dense
    row["feature_order_same_bits"] = same_bits
    print(f"slot_update on config #3's blocks ({E} slots, in case order): ms {row['ms']:.4f} "
          f"against dense_update's {row['dense_update_same_blocks_ms']:.4f} on the same "
          f"blocks and its own {row['feature_order_ms']:.4f} on the per-feature lists (the "
          f"same bits: {same_bits}); per-column error against dense_update {err_dense:.3g} "
          f"(tol 1e-5); the first version took {SLOT_UPDATE_FIRST_MS['config #3']} ms "
          f"(PERF.md, on an H100 80GB HBM3 at 700 W)")
    if not err_dense <= 1e-5:
        fail(f"slot_update and dense_update disagree at config #3: {err_dense}")
    if not same_bits:
        fail("slot_update gives other bits on the per-feature lists than in case order")
    return row


def tail_checks(args, rec, dev, out, test, te_ids, te_vals, P, w0, nc, blocks, tabs):
    """Config #3's incremental test tail on the 1M test rows, as the learner
    lays it out past the train rows: fm_refresh's train mode with y = 0
    (the refresh's te_chunk: pred and Q, unclipped) and dense_update on the
    tail's rows with each block's test columns, each against its plain
    version (1e-4, as the train rows'); the tail's pred column against the
    test mode's prediction. Times go into the fm_refresh and dense_update
    rows."""
    from libfm_tpu_torch.kernels import dense_update as du
    from libfm_tpu_torch.kernels import fm_refresh as fr
    from libfm_tpu_torch.learners.mcmc_vector import tail_columns

    rows = {r["name"]: r for r in out}
    k, d = FACTORS, FACTORS + 1
    n, nt = P.shape[0], test.num_rows
    test_off = -(-nc // 4) * 4
    A_rows = torch.empty(test_off + nt, d, device=dev)
    A_te = A_rows[test_off:]
    y0 = torch.zeros(nt, device=dev)
    cols = []
    for b in blocks:
        tail = tail_columns(b.host_features, b.onehot, test, n)
        if tail is None:
            fail("config #3: the incremental test tail steps aside")
        cols.append(torch.as_tensor(tail[0], device=dev))
    T_p = torch.empty(nt, d, device=dev)
    fr.fm_refresh(P, te_ids, te_vals, w0, y0, A_te)
    fr.fm_refresh_plain(P, te_ids, te_vals, w0, y0, T_p)
    pred = fr.fm_refresh(P, te_ids, te_vals, w0)
    torch.cuda.synchronize()
    err_ref = max((A_te - T_p).abs().max().item(), (A_te[:, 0] - pred).abs().max().item())
    T_p.copy_(A_te)
    for c, tab in zip(cols, tabs):
        du.dense_update(A_te, c, None, tab)
        du.dense_update_plain(T_p, c, None, tab)
    torch.cuda.synchronize()
    err_upd = (A_te - T_p).abs().max().item()
    del T_p

    def run_tail_update(fn=du.dense_update):
        for c, tab in zip(cols, tabs):
            fn(A_te, c, None, tab)

    Lt = te_ids.shape[1]
    covered = sum(int((c != b.F).sum().item()) for c, b in zip(cols, blocks))
    fr_row, du_row = rows["fm_refresh"], rows["dense_update"]
    fr_row["tail_mode"] = dict(
        err=err_ref, tolerance=1e-4, timed="one launch on the 1M-row tail (a refresh)",
        ms=cuda_ms(lambda: fr.fm_refresh(P, te_ids, te_vals, w0, y0, A_te), args.reps),
        plain_ms=cuda_ms(lambda: fr.fm_refresh_plain(P, te_ids, te_vals, w0, y0, A_te),
                         args.reps),
        bound_ms=bound_ms(nt * Lt * 8 + nt * 4 + n * d * 4 + nt * d * 4,
                          nt * (Lt * (4 * k + 2) + 2 * k + 8))[0])
    du_row["tail"] = dict(
        err=err_upd, tolerance=1e-4, timed="one iteration's tail launches: one per block",
        ms=cuda_ms(run_tail_update, args.reps),
        plain_ms=cuda_ms(lambda: run_tail_update(du.dense_update_plain), args.reps),
        bound_ms=bound_ms(len(cols) * nt * 4 + covered * d * 8
                          + sum((b.F + 1) * (d + 1) * 4 for b in blocks),
                          covered * (4 * k + 6))[0])
    print(f"test tail ({nt} rows from row {test_off}): fm_refresh y=0 mode err {err_ref:.3g} "
          f"(tol 1e-4) ms {fr_row['tail_mode']['ms']:.4f} plain_ms "
          f"{fr_row['tail_mode']['plain_ms']:.4f} bound_ms "
          f"{fr_row['tail_mode']['bound_ms']:.4f}; dense_update err {err_upd:.3g} (tol 1e-4) "
          f"ms {du_row['tail']['ms']:.4f} plain_ms {du_row['tail']['plain_ms']:.4f} bound_ms "
          f"{du_row['tail']['bound_ms']:.4f}")
    if not (err_ref <= 1e-4 and err_upd <= 1e-4):
        fail(f"config #3's test tail disagrees with the plain versions: {err_ref}, {err_upd}")
    rec["test_tail_rows"] = [test_off, nt, covered]
    del A_rows, cols


def ctr_data():
    """Config #4b's and #4's data (bench.py:279-309, :236-277): targets
    binarized to +-1 (ctr_like's are already); with the field groups."""
    from libfm_tpu_torch.data.synth import ctr_like

    train, test, groups = ctr_like(num_fields=CTR_FIELDS, field_cardinality=CTR_CARD,
                                   num_examples=CTR_EXAMPLES, seed=SEED)
    train.binarize_targets()
    test.binarize_targets()
    return train, test, groups


def ctr_kernel_checks(args, rec, dev, ctr):
    """Phase 3, config #4: case_stats on the 13 blocks (slot_stats timed
    on the same blocks), fm_refresh's probit train mode and probit_latent,
    each against its plain version on the same uniforms. Returns their
    three rows."""
    import numpy as np

    from libfm_tpu_torch.data.batching import conflict_free_blocks
    from libfm_tpu_torch.data.vector_layout import padded_rows_layout
    from libfm_tpu_torch.kernels import case_stats as cs
    from libfm_tpu_torch.kernels import fm_refresh as fr
    from libfm_tpu_torch.kernels import probit_latent as pl
    from libfm_tpu_torch.kernels import slot_stats as ss
    from libfm_tpu_torch.learners.mcmc_vector import DevBlock
    from libfm_tpu_torch.ops.samplers import probit_latent as draw

    train, _, groups = ctr
    k, d = CTR_FACTORS, CTR_FACTORS + 1
    n, nc = train.num_features, train.num_rows
    T = k * (k + 1) // 2
    GW = ss.gg_width(k)
    t0 = time.perf_counter()
    blocks = [DevBlock(b, groups[b.features], nc, dev, k, True)
              for b in conflict_free_blocks(train, attr_group=groups)]
    ids, vals = (torch.as_tensor(x, device=dev) for x in
                 padded_rows_layout(train.indptr, train.cols, train.vals))
    y = torch.as_tensor(train.target, device=dev)
    torch.cuda.synchronize()
    heavy = [int((b.feat_off[1:] - b.feat_off[:-1]).max()) for b in blocks]
    print(f"config #4: {len(blocks)} blocks, case-major "
          f"{[b.case_major for b in blocks]}, one-hot {all(b.onehot for b in blocks)}, "
          f"case_stats CTAs {[b.case_plan.count for b in blocks if b.case_major]}, longest "
          f"slot list "
          f"{heavy} ({time.perf_counter() - t0:.1f} s)")
    if not all(b.case_major and b.onehot for b in blocks):
        fail("config #4: a block left the case-major path or is not one-hot")
    g = torch.Generator(device=dev).manual_seed(SEED)
    P = 0.1 * torch.randn(n, d, generator=g, device=dev)
    w0 = torch.tensor(0.05, device=dev)
    A = torch.empty(nc, d, device=dev)
    fr.fm_refresh(P, ids, vals, w0, y, A)
    out = []

    # ---- case_stats, one iteration's 13 launches; slot_stats beside it.
    # Both are held to the plain version in float64, entry by entry, over
    # the entry's sum of magnitudes (cs.case_stats_reference): a feature
    # of 12 cases as closely as the head of 321K; the plain version in
    # float32 is read the same way
    GG_k = [torch.empty(b.F, GW, device=dev) for b in blocks]
    GG_p = []

    def run_cs(fn, keep=False):
        def go():
            for b, G in zip(blocks, GG_k):
                r = fn(A, P, b.feat_off, b.slot_case, b.slot_val, b.feat_id,
                       onehot=b.onehot, GG=G if fn is cs.case_stats else None,
                       pieces=b.case_plan)
                if keep:
                    GG_p.append(r)
        return go

    run_cs(cs.case_stats)()
    plain_ms = cuda_ms(run_cs(cs.case_stats_plain, keep=True), 1, warmup=0)
    GG_s = [torch.empty(b.F, GW, device=dev) for b in blocks]

    def run_ss():
        for b, G in zip(blocks, GG_s):
            ss.slot_stats(A, P, b.feat_off, b.slot_case, b.slot_val, b.feat_id, GG=G,
                          pieces=b.pieces)

    run_ss()
    torch.cuda.synchronize()
    errs, errs_p, errs_s = [], [], []
    for b, Gk, Gp, Gs in zip(blocks, GG_k, GG_p, GG_s):
        ref, scale = cs.case_stats_reference(A, P, b.feat_off, b.slot_case, b.slot_val,
                                             b.feat_id, onehot=b.onehot)
        errs.append(cs.err_over_magnitudes(Gk, ref, scale))
        errs_p.append(cs.err_over_magnitudes(Gp, ref, scale))
        errs_s.append(cs.err_over_magnitudes(Gs, ref, scale))
        del ref, scale
    del GG_p
    E = sum(int(b.slot_case.numel()) for b in blocks)
    Fsum = sum(b.F for b in blocks)
    MW = cs.moment_width(k, True)
    row = kernel_row(
        "case_stats", "libfm_tpu/learners/mcmc_vector.py:1320", max(errs), CASE_STATS_TOL,
        cuda_ms(run_cs(cs.case_stats), args.reps), plain_ms,
        # one-hot blocks: slot_case and the A row a slot, v and the GG row
        # a feature (slot_val is not read)
        nbytes=E * (4 + d * 4) + Fsum * (8 + 4 + k * 4 + GW * 4),
        flops=E * 2 * MW + Fsum * 6 * T,
        lib_ms=None, timed="one iteration's launches at config #4: one per block (13)",
        label=" (config #4)")
    row["also_replaces"] = ["libfm_tpu/learners/mcmc_vector.py:1383 (the reconstruction)"]
    row["error_measure"] = ("largest |GG - float64 plain| over the entry's sum of "
                            "magnitudes, over the 13 blocks")
    row["per_block_err"] = errs
    row["plain_f32_err"] = max(errs_p)
    row["slot_stats_err_same_blocks"] = max(errs_s)
    row["slot_stats_ms_same_blocks"] = cuda_ms(run_ss, args.reps)
    # the rows' gather alone, in the kernel's order: what reading A by the
    # slot lists costs, with no sums
    rows_out = [torch.empty(b.slot_case.numel(), d, device=dev) for b in blocks]

    def gather():
        for b, out_rows in zip(blocks, rows_out):
            torch.index_select(A, 0, b.slot_case.long(), out=out_rows)

    row["rows_gather_ms"] = cuda_ms(gather, args.reps)
    del rows_out
    row["library_ms_none_because"] = ("no one PyTorch call sums the moment rows per feature "
                                      "and reconstructs GG")
    print(f"case_stats against the float64 plain version, over each entry's sum of "
          f"magnitudes: kernel {row['max_abs_err']:.3g}, plain version in float32 "
          f"{row['plain_f32_err']:.3g}, slot_stats {row['slot_stats_err_same_blocks']:.3g} "
          f"(tol {CASE_STATS_TOL:g}); slot_stats ms {row['slot_stats_ms_same_blocks']:.4f} "
          f"against case_stats {row['ms']:.4f}; torch.index_select of the slots' rows "
          f"alone {row['rows_gather_ms']:.4f}; the first version of case_stats took "
          f"{CASE_STATS_FIRST_MS} ms (PERF.md, on an H100 80GB HBM3 at 700 W)")
    same = run_cs(cs.case_stats)
    GG_again = [G.clone() for G in GG_k]
    same()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(GG_again, GG_k)):
        fail("case_stats gives other bits on a second launch at config #4")
    del GG_again
    if not row["slot_stats_err_same_blocks"] <= CASE_STATS_TOL:
        fail(f"slot_stats disagrees with the float64 plain version at config #4: "
             f"{row['slot_stats_err_same_blocks']}")
    out.append(row)
    del GG_k, GG_s

    # ---- fm_refresh, probit train mode: sampling (MCMC) and expectation (ALS)
    U = torch.rand(nc, generator=g, device=dev)
    L = ids.shape[1]
    cases = {}
    for mode, u in (("sample", U), ("mean", None)):
        A_k, A_p = torch.empty(nc, d, device=dev), torch.empty(nc, d, device=dev)
        lat_k, lat_p = torch.empty(nc, device=dev), torch.empty(nc, device=dev)
        c_k = fr.fm_refresh(P, ids, vals, w0, y, A_k, probit=mode, U=u, latent=lat_k)
        c_p = fr.fm_refresh_plain(P, ids, vals, w0, y, A_p, probit=mode, U=u, latent=lat_p)
        torch.cuda.synchronize()
        # the kernel's predictions, as e + latent (to an ulp); a draw more
        # than LATENT_CHECKED from its mean turns that ulp into more than 1e-5
        pred_k = A_k[:, 0] + lat_k
        lat_ref = draw(pred_k, y, u)
        near = ((lat_ref - pred_k).abs() <= LATENT_CHECKED if u is not None
                else torch.ones_like(y, dtype=torch.bool))
        err = max(
            (A_k[:, 1:] - A_p[:, 1:]).abs().max().item(),
            (pred_k - (A_p[:, 0] + lat_p)).abs().max().item(),
            ((lat_k - lat_ref).abs() / lat_ref.abs().clamp_min(1.0))[near].max().item(),
            float(not ((lat_k >= 0) == (y >= 0)).all()),
        )
        cases[mode] = dict(
            max_abs_err=err, correct_kernel=c_k.item(), correct_plain=c_p.item(),
            cases_beyond_latent_check=int((~near).sum().item()),
            ms=cuda_ms(lambda: fr.fm_refresh(P, ids, vals, w0, y, A_k, probit=mode, U=u,
                                             latent=lat_k), args.reps),
            plain_ms=cuda_ms(lambda: fr.fm_refresh_plain(P, ids, vals, w0, y, A_p,
                                                         probit=mode, U=u, latent=lat_p),
                             args.reps))
        print(f"fm_refresh probit ({mode}): err {err:.3g} (Q and pred 1e-4 absolute, "
              f"latents 1e-5 relative above 1 against the plain draw on the kernel's "
              f"predictions where the draw lies within {LATENT_CHECKED} of its mean, all "
              f"but {cases[mode]['cases_beyond_latent_check']} cases; every latent on "
              f"y's side of 0), correct {c_k.item():.0f} (plain {c_p.item():.0f}), "
              f"ms {cases[mode]['ms']:.4f} plain {cases[mode]['plain_ms']:.4f}")
        del A_k, A_p, lat_p
    row = kernel_row(
        "fm_refresh_probit", "libfm_tpu/learners/mcmc_vector.py:1136",
        max(c["max_abs_err"] for c in cases.values()), 1e-4,
        cases["sample"]["ms"], cases["sample"]["plain_ms"],
        # ids and values, then y, U and the latents, the table, the rows of A
        nbytes=nc * L * 8 + nc * 4 * 3 + n * d * 4 + nc * d * 4,
        flops=nc * (L * (4 * k + 2) + 2 * k + 8 + 40),
        lib_ms=None, timed="one probit train-mode launch at config #4 (sampling)",
        source="libfm_tpu_torch/csrc/fm_refresh.cu")
    row["cases"] = cases
    row["library_ms_none_because"] = "no one PyTorch call computes the gathered FM forward"
    out.append(row)

    # ---- probit_latent on the refreshed A: sampling and expectation; its
    # correct count and residual sums (the next alpha and w0 draws' inputs)
    # against the plain version's, the sums over the sum of magnitudes
    lat0 = lat_k
    cases = {}
    for mode, u in (("sample", U), ("mean", None)):
        A_k, A_p, A_2 = A.clone(), A.clone(), A.clone()
        l_k, l_p, l_2 = lat0.clone(), lat0.clone(), lat0.clone()
        out_k = pl.probit_latent(A_k, l_k, y, u)
        c_p, se_p, se2_p = pl.probit_latent_plain(A_p, l_p, y, u)
        out_2 = pl.probit_latent(A_2, l_2, y, u)
        torch.cuda.synchronize()
        repeat_check(f"probit_latent count and sums, config #4 ({mode})", out_k, out_2, rec)
        c_k, se_k, se2_k = out_k
        sums_err = max(abs(se_k.item() - se_p.item()) / A_p[:, 0].abs().sum().item(),
                       abs(se2_k.item() - se2_p.item()) / se2_p.item())
        err = max(((l_k - l_p).abs() / l_p.abs().clamp_min(1.0)).max().item(),
                  ((A_k[:, 0] - A_p[:, 0]).abs() / A_p[:, 0].abs().clamp_min(1.0))
                  .max().item(),
                  abs(c_k.item() - c_p.item()), sums_err,
                  float(not torch.equal(A_k[:, 1:], A[:, 1:])))
        cases[mode] = dict(
            max_abs_err=err, sums_err=sums_err,
            ms=cuda_ms(lambda: pl.probit_latent(A_k, l_k, y, u), args.reps),
            plain_ms=cuda_ms(lambda: pl.probit_latent_plain(A_p, l_p, y, u), args.reps))
        print(f"probit_latent ({mode}): err {err:.3g} (tol 1e-5, relative above 1; the "
              f"sums {sums_err:.3g} of their magnitudes), ms {cases[mode]['ms']:.4f} plain "
              f"{cases[mode]['plain_ms']:.4f}")
        del A_k, A_p, A_2
    row = kernel_row(
        "probit_latent", "libfm_tpu/learners/mcmc_vector.py:2033",
        max(c["max_abs_err"] for c in cases.values()), 1e-5,
        cases["sample"]["ms"], cases["sample"]["plain_ms"],
        nbytes=nc * 4 * 6, flops=nc * 60, lib_ms=None,
        timed="one launch at config #4 (sampling)")
    row["cases"] = cases
    row["library_ms_none_because"] = "no one PyTorch call draws the truncated normals"
    # the bound at A's sectors: a 4-byte piece of each (k+1)-float row touches
    # every 32-byte sector of A, read and written, beside latent (read and
    # written), y and U (studies/probit_latent_floor.py measures that traffic)
    row["sector_bound_ms"] = bound_ms(nc * d * 4 * 2 + nc * 4 * 4, 0)[0]
    print(f"probit_latent: bound at A's sectors {row['sector_bound_ms']:.4f} ms")
    out.append(row)
    del A, blocks, ids, vals
    torch.cuda.empty_cache()
    return out


def lv_data():
    """Config #5's data (bench.py:337-389): +-1 targets, the field groups."""
    from libfm_tpu_torch.data.synth import ctr_like

    return ctr_like(num_fields=LV_FIELDS, field_cardinality=LV_CARD,
                    num_examples=LV_EXAMPLES, seed=SEED)


def lv_kernel_checks(args, rec, dev, lv):
    """Phase 3, config #5: dual_draw on the dual features of the 26 blocks
    (one iteration's launches) against its plain version, in sampling and
    ALS mode on the same noise; the library yardstick on the same c x c
    systems. Returns its row and the blocks' (dense, dual) feature counts."""
    import numpy as np

    from libfm_tpu_torch.data.batching import conflict_free_blocks
    from libfm_tpu_torch.data.vector_layout import padded_rows_layout
    from libfm_tpu_torch.kernels import dual_draw as dd
    from libfm_tpu_torch.kernels import fm_refresh as fr
    from libfm_tpu_torch.learners.mcmc_vector import DevBlock

    train, _, groups = lv
    k, d = LV_FACTORS, LV_FACTORS + 1
    n, nc = train.num_features, train.num_rows
    per_feature = np.bincount(train.cols, minlength=n)
    heads = [int(per_feature[groups == f].max()) for f in range(int(groups.max()) + 1)]
    want = dict(features=int(((per_feature >= 1) & (per_feature <= LV_DUAL_MAX)).sum()),
                c_le_2=int(((per_feature >= 1) & (per_feature <= 2)).sum()),
                observed=int((per_feature > 0).sum()), numpy=np.__version__)
    t0 = time.perf_counter()
    blocks = [DevBlock(b, groups[b.features], nc, dev, k, True, dual_draws=True)
              for b in conflict_free_blocks(train, attr_group=groups)]
    torch.cuda.synchronize()
    counts = np.concatenate([np.diff(b.dual_off.cpu().numpy()) for b in blocks])
    hist = np.bincount(counts)
    dual = dict(features=int(len(counts)), slots=int(counts.sum()),
                c_le_2=int((counts <= 2).sum()), c_gt_2=int((counts > 2).sum()),
                dense_features=sum(b.Fd for b in blocks),
                per_c={int(c): int(m) for c, m in enumerate(hist) if m},
                blocks=len(blocks), set_up_seconds=time.perf_counter() - t0)
    dual["reckoned_from_the_rows"] = want
    rec["config5_dual"] = dual
    print(f"config #5: {len(blocks)} blocks, {dual['dense_features']} dense and "
          f"{dual['features']} dual features ({dual['c_le_2']} of c <= 2, "
          f"{dual['c_gt_2']} of c > 2; {dual['slots']} dual slots), case-major "
          f"{sum(b.case_major for b in blocks)} blocks; dual features by c "
          f"{dual['per_c']} ({dual['set_up_seconds']:.1f} s)")
    print(f"config #5, reckoned from the train rows (numpy {np.__version__}): "
          f"{want['observed']} observed features, {want['features']} of 1 to "
          f"{LV_DUAL_MAX} entries, {want['c_le_2']} of 1 or 2; fields' heads {heads}")
    if min(heads) <= LV_WHOLE_MAX or (dual["features"], dual["c_le_2"]) != (
            want["features"], want["c_le_2"]):
        fail(f"config #5: {dual['features']} dual features, {dual['c_le_2']} of c <= 2; "
             f"the JAX engine's rule gives {want['features']} and {want['c_le_2']}")
    if any(b.case_major for b in blocks) or not all(b.Fd and b.Fu for b in blocks):
        fail("config #5: a block took the case-major gate or has no dense or no dual "
             "feature")
    ids, vals = (torch.as_tensor(x, device=dev) for x in
                 padded_rows_layout(train.indptr, train.cols, train.vals))
    y = torch.as_tensor(train.target, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    P = 0.1 * torch.randn(n, d, generator=g, device=dev)
    A = torch.empty(nc, d, device=dev)
    fr.fm_refresh(P, ids, vals, torch.tensor(0.05, device=dev), y, A)
    del ids, vals, y
    alpha = torch.tensor(2.0, device=dev)
    bound = 1e6
    sys_in = []
    for b in blocks:
        th = P[b.features[b.Fd:]].contiguous()
        sys_in.append((b, th, torch.full((b.Fu, d), 5.0, device=dev),
                       0.01 * torch.randn(b.Fu, d, generator=g, device=dev),
                       torch.randn(b.Fu, d, generator=g, device=dev),
                       torch.randn(b.dual_case.shape[0], generator=g, device=dev)))

    def run(fn, sample=True):
        def go():
            return [fn(A, b.dual_off, b.dual_case, b.dual_val, th, lam, mu, u, dl, alpha,
                       do_sample=sample, bound=bound, use_linear=True, plan=b.dual_plan)
                    for b, th, lam, mu, u, dl in sys_in]
        return go

    errs, nrej = {}, 0
    for sample in (True, False):
        got, want = run(dd.dual_draw, sample)(), run(dd.dual_draw_plain, sample)()
        torch.cuda.synchronize()
        errs["sampling" if sample else "ALS"] = max(
            ((tk - tp).abs() / tp.abs().clamp_min(1.0)).max().item()
            for (tk, _), (tp, _) in zip(got, want))
        if not all(torch.equal(rk, rp) for (_, rk), (_, rp) in zip(got, want)):
            fail("config #5: dual_draw's reject flags differ from the plain version's")
        nrej += sum(int(rk.sum().item()) for _, rk in got)
        del got, want
    # the library yardstick: cholesky_ex + cholesky_solve on the same K
    # systems, one batch for each slot count c of each block
    lib_in = []
    for b, th, lam, mu, _, _ in sys_in:
        cnt = b.dual_off[1:] - b.dual_off[:-1]
        for c in torch.unique(cnt).tolist():
            sel = torch.nonzero(cnt == c).squeeze(1)
            K = dd.dual_system(A, b.dual_off, sel, b.dual_case, b.dual_val, th, lam, mu,
                               alpha, use_linear=True)[3]
            lib_in.append((K, torch.randn(K.shape[0], K.shape[1], 1, generator=g,
                                          device=dev)))

    def run_lib():
        for K, r in lib_in:
            Lf, _ = torch.linalg.cholesky_ex(K)
            torch.cholesky_solve(r, Lf)

    c = counts.astype(np.float64)
    row = kernel_row(
        "dual_draw", "libfm_tpu/learners/mcmc_vector.py:1661", max(errs.values()),
        DUAL_TOL, cuda_ms(run(dd.dual_draw), args.reps),
        cuda_ms(run(dd.dual_draw_plain), PLAIN_REPS, warmup=1),
        # a slot: its A row, case, value and noise; a feature: its offset,
        # theta_old, lam, mu, u and theta_new, and its flag
        nbytes=c.sum() * (d * 4 + 12) + len(c) * (8 + 5 * d * 4 + 4),
        # the Gram (c(c+1)/2 dot products of d), h, ytil, v and Phi^T w
        # (8 c d), the factorisation (c^3 / 3) and the solves (2 c^2)
        flops=float((c * (c + 1) * d + 8 * c * d + c ** 3 / 3 + 2 * c * c).sum()),
        lib_ms=cuda_ms(run_lib, args.reps),
        timed="one iteration's launches at config #5: one per block (26), sampling",
        label=" (config #5)")
    row["also_replaces"] = ["libfm_tpu/ops/lane_chol.py:232 (cho_solve_lanes)"]
    row["errors_by_mode"] = errs
    row["rejected_in_check"] = nrej
    row["dual_features"] = dual
    row["library_call"] = ("torch.linalg.cholesky_ex + torch.cholesky_solve on the same "
                           "K systems, one batch a slot count a block")
    print(f"dual_draw at config #5: err sampling {errs['sampling']:.3g}, ALS "
          f"{errs['ALS']:.3g} (tol {DUAL_TOL:g}); {nrej} rejected")
    if nrej:
        fail(f"config #5: dual_draw rejected {nrej} draws of well-posed systems")
    launches = dict(dense=sum(bool(b.Fd) for b in blocks),
                    dual=sum(bool(b.Fu) for b in blocks))
    del A, P, blocks, sys_in, lib_in
    torch.cuda.empty_cache()
    return row, launches


def bs_data(dev):
    """bench_bs's data (bench.py:402-429) rebuilt with numpy, and its
    relation's layout as the BS engine cuts it; prints the block count and
    shapes, the observed and unobserved features and the learner's route
    (`relational_mode`). Another numpy version may draw other data, so the
    counts are printed on every run."""
    import numpy as np

    from libfm_tpu_torch.data.dataset import Dataset
    from libfm_tpu_torch.data.relation import RelationData, RelationJoin
    from libfm_tpu_torch.learners.mcmc_rel_vector import RelLayout
    from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner
    from libfm_tpu_torch.models.fm import FMConfig

    rng = np.random.default_rng(BS_SEED)
    NB, W, NF, NTR = BS_NB, BS_W, BS_NF, BS_NTR
    NTE = NTR // 10
    cols = np.stack([np.sort(rng.choice(NF, W, replace=False))
                     for _ in range(NB)]).astype(np.int32)
    vals = rng.standard_normal((NB, W)).astype(np.float32)
    rd = RelationData(np.arange(NB + 1, dtype=np.int64) * W, cols.ravel(), vals.ravel(), NF)
    rd.attr_offset = 0
    beta = rng.standard_normal(NF).astype(np.float32) * 0.1
    score = (vals * beta[cols]).sum(axis=1)

    def build(m, y):
        ds = Dataset(np.zeros(len(y) + 1, np.int64), np.empty(0, np.int32),
                     np.empty(0, np.float32), y, 0)
        ds.relations = [RelationJoin(rd, m)]
        return ds

    mtr = rng.integers(0, NB, NTR).astype(np.int32)
    mte = rng.integers(0, NB, NTE).astype(np.int32)
    train = build(mtr, (score[mtr] + 0.3 * rng.standard_normal(NTR)).astype(np.float32))
    test = build(mte, (score[mte] + 0.3 * rng.standard_normal(NTE)).astype(np.float32))
    lay = RelLayout(train.relations[0], test.relations[0], np.zeros(NF, np.int32), NF)
    probe = MCMCVectorLearner(FMConfig(num_features=NF, num_factors=BS_FACTORS),
                              verbose=False, device=dev)
    probe._route_relational(train, test)
    shapes = {}
    for b in lay.blocks:
        key = (len(b.features), len(b.entry_b))
        shapes[key] = shapes.get(key, 0) + 1
    observed = NF - len(lay.unobserved)
    print(f"bench_bs: {train.num_rows} train and {test.num_rows} test cases, {lay.nb} "
          f"block rows, {rd.nnz} block entries; {len(lay.blocks)} conflict-free blocks "
          f"(features, entries): count {shapes}; {observed} observed and "
          f"{len(lay.unobserved)} unobserved features; most cases on one block row "
          f"{int(np.diff(lay.case_off).max())}; relational_mode {probe.relational_mode}")
    if probe.relational_mode != "bs_vector":
        fail(f"bench_bs routes to {probe.relational_mode}, not bs_vector")
    return dict(train=train, test=test, layout=lay, blocks=len(lay.blocks), shapes=shapes,
                observed=observed, unobserved=len(lay.unobserved))


def bs_want(iters, nblk, deferred, refresh_every=8, main=0, classify=False):
    """The launches of a BS engine run (one relation, nblk blocks): at the
    set-up and at each refresh rel_scores once and rel_refresh twice (train
    and tail), on the deferred path rel_cache too; every iteration
    rel_stats and schur_draw's relational form (counted as schur_draw and
    as rel_update, K10's update that it does) once a block, and rel_resync once
    (deferred: the read-only test prediction) or twice with rel_cache once
    (resync path); on the deferred path rel_deferred once an iteration
    (alpha's and w0's sums) and again at each iteration without a refresh
    (the train metric). With a main table of `main` blocks (no tail, no deferred
    path): every iteration also slot_stats, schur_draw and slot_update once
    a main block, rel_scores and rel_refresh (test mode) once, rel_resync
    once; at the set-up and at each refresh rel_refresh once (train). With
    `classify` each refresh's train-mode rel_refresh is rel_refresh_probit
    (the set-up's stays: e = pred - y) and the other iterations resample the
    latents (probit_latent)."""
    from libfm_tpu_torch.learners.mcmc import dispatch_chunks

    refresh = len(dispatch_chunks(0, iters, refresh_every))
    want = dict(rel_scores=1 + refresh, rel_refresh=2 * (1 + refresh),
                rel_stats=iters * nblk, schur_draw=iters * (nblk + main),
                rel_update=iters * nblk)
    want.update(dict(rel_cache=1 + refresh, rel_resync=iters,
                     rel_deferred=iters + (iters - refresh)) if deferred
                else dict(rel_cache=iters, rel_resync=(1 if main else 2) * iters))
    if main:
        want.update(rel_scores=1 + iters, rel_refresh=1 + iters + refresh,
                    slot_stats=iters * main, slot_update=iters * main)
    if classify:
        want.update(rel_refresh=want["rel_refresh"] - refresh, rel_refresh_probit=refresh,
                    probit_latent=iters - refresh)
    return want


def posterior_sd_units(d, GG, lam, alpha):
    """sqrt(d^T Lam d) [F] for each feature: a difference d [F, k+1] of
    two draws in standard deviations of the posterior whose precision
    Lam = alpha H^T H + diag(lam) the statistics GG (float64) give."""
    from libfm_tpu_torch.kernels.schur_draw import unpack_sym

    F, d1 = d.shape
    k = d1 - 1
    T = k * (k + 1) // 2
    lam = lam.double()
    L = torch.zeros(F, d1, d1, dtype=torch.float64, device=d.device)
    L[:, 0, 0] = alpha * GG[:, T + 2 * k] + lam[:, 0]
    L[:, 0, 1:] = alpha * GG[:, T:T + k]
    L[:, 1:, 0] = alpha * GG[:, T:T + k]
    L[:, 1:, 1:] = alpha * unpack_sym(GG, k) + torch.diag_embed(lam[:, 1:])
    d = d.double()
    return torch.einsum("fi,fij,fj->f", d, L, d).clamp_min(0).sqrt()


def bs_sweeps(rel, lay, C, P, alpha, lam_row, mu_row, g, bound):
    """Two Gibbs sweeps of a relation's blocks from the caches C and a zero
    SD, as the deferred path runs them (P updated in place): the first
    makes SD non-zero, the second is held to the plain versions. Each
    block's rel_stats against the float64 plain version over each entry's
    sum of magnitudes (the float32 plain version's error measured beside
    it); every draw from the kernel's GG (schur_draw's relational form)
    and from the float32 plain GG (schur_draw_plain) against the float64
    draw from the float64 GG on the same noise, in posterior standard
    deviations (the median, 99th percentile, largest and root mean square
    over the features); the form's draws the same bits as schur_draw's on
    the same inputs and against schur_draw_plain's on the same GG, and its
    SD against rel_update_plain on its draws. `lam_row` and `mu_row` [k+1] give
    every feature's prior. Returns (SD, the checked sweep's (block,
    theta_old, theta_new, GG, lam, mu, z), its errors)."""
    import numpy as np

    from libfm_tpu_torch.kernels import rel_sweep as rs
    from libfm_tpu_torch.kernels import schur_draw as sd
    from libfm_tpu_torch.kernels.case_stats import err_over_magnitudes

    def dist(x, y):
        return ((x.double() - y.double()).abs().max()
                / y.double().abs().max().clamp_min(1.0)).item()

    d = P.shape[1]
    SD = torch.zeros(lay.nb + 1, d, device=P.device)
    sweep_in = []
    for checked in (False, True):
        stat_err = upd_err = plain_err = draw_err = plain_draw_err = 0.0
        emax = rej = 0
        dist_k, dist_p = [], []
        for hb, blk in zip(lay.blocks, rel.blocks):
            b_args = (C, SD, rel.wnum, blk.feat_off, blk.entry_b, blk.entry_x, blk.feat_id, P)
            G_k = rs.rel_stats(*b_args)
            th_old = P[blk.features]
            lam = lam_row.expand(blk.F, d).contiguous()
            mu = mu_row.expand(blk.F, d).contiguous()
            z = torch.randn(blk.F, d, generator=g, device=P.device)
            if checked:  # from SD before the block's update
                ref, scale = rs.rel_stats_reference(*b_args)
                stat_err = max(stat_err, err_over_magnitudes(G_k, ref, scale))
                G_p = rs.rel_stats_plain(*b_args)
                plain_err = max(plain_err, err_over_magnitudes(G_p, ref, scale))
                emax = max(emax, int(np.diff(hb.feat_off).max()))
                SD_before = SD.clone()
            th_k, r_k = sd.schur_draw_rel(G_k, th_old, lam, mu, z, alpha, SD, blk.feat_off,
                                          blk.entry_b, blk.entry_x, do_sample=True,
                                          bound=bound)
            if checked:
                th_f, r_f = sd.schur_draw(G_k, th_old, lam, mu, z, alpha, do_sample=True,
                                          bound=bound)
                if not (torch.equal(th_k, th_f) and torch.equal(r_k, r_f)):
                    fail("bench_bs: schur_draw's relational form drew other bits than "
                         "schur_draw on the same inputs")
                th_p, r_p = sd.schur_draw_plain(G_p, th_old, lam, mu, z, alpha,
                                                do_sample=True, bound=bound)
                f64 = dict(do_sample=True, bound=bound)
                th_64, _ = sd.schur_draw_plain(ref, th_old.double(), lam.double(),
                                               mu.double(), z.double(), alpha.double(), **f64)
                a = float(alpha)
                dist_k.append(posterior_sd_units(th_k - th_64, ref, lam, a))
                dist_p.append(posterior_sd_units(th_p - th_64, ref, lam, a))
                if not torch.equal(r_k, r_p):
                    fail("bench_bs: schur_draw's reject flags on rel_stats' GG differ "
                         "from the plain version's")
                rej += int(r_k.sum().item())
                # on the kernel's GG: schur_draw_plain in float32 and float64
                th_pk, _ = sd.schur_draw_plain(G_k, th_old, lam, mu, z, alpha, **f64)
                th_pk64, _ = sd.schur_draw_plain(G_k.double(), th_old.double(), lam.double(),
                                                 mu.double(), z.double(), alpha.double(), **f64)
                draw_err = max(draw_err, dist(th_k, th_pk))
                plain_draw_err = max(plain_draw_err, dist(th_pk, th_pk64))
                del ref, scale, th_64, th_pk, th_pk64, th_f
                rs.rel_update_plain(SD_before, blk.entry_b, blk.entry_x,
                                    torch.as_tensor(hb.entry_f, device=P.device), th_old, th_k)
                upd_err = max(upd_err, col_rel_err(SD, SD_before).item())
                sweep_in.append((blk, th_old, th_k, G_k, lam, mu, z))
                del SD_before
            P[blk.features] = th_k
    torch.cuda.synchronize()
    k = d - 1
    dist_k, dist_p = torch.cat(dist_k), torch.cat(dist_p)
    q = torch.tensor([0.5, 0.99], dtype=torch.float64, device=P.device)
    return SD, sweep_in, dict(
        stat_err=stat_err, stat_tol=2 * (emax + k + 8) * U32, stats_plain_f32_err=plain_err,
        upd_err=upd_err, draw_err=draw_err, plain_draw_err=plain_draw_err, rejected=rej,
        features=dist_k.numel(),
        **{f"{key}_{stat}": v for key, x in (("kernel", dist_k), ("plain", dist_p))
           for stat, v in zip(("median", "p99", "max", "rms"),
                              [*torch.quantile(x, q).tolist(), x.max().item(),
                               x.square().mean().sqrt().item()])})


def check_bs_draws(res, state):
    """Fails unless the draws of a checked `bs_sweeps` lie, in posterior
    standard deviations, no further from the float64 draws than 1.5 times
    the float32 plain version's own, by their root mean square over the
    features and by the largest distance, with none rejected, and
    rel_stats, the draws against schur_draw_plain and K10's update of SD
    hold: the draws within max(1e-3, 3 x schur_draw_plain's own distance
    from its float64 draws) of schur_draw_plain's on the same GG, as in
    the card test. Returns the numbers for the record."""
    # the draws amplify GG's float32 rounding: its reconstruction cancels
    # (Qq = M2 - v S3 - S3 v + m4 v v), so the float32 plain version's own
    # draws lie up to tenths of a posterior standard deviation from the
    # float64 ones. Both versions sum in a fixed order on the card (the
    # plain version through ops.segment.sorted_index_add_), so at a fixed
    # state both distances are the same on every run; the kernel sums
    # sequentially, its rms ~1.25 x the plain version's at mcmc_bs's last
    # state. The chain's sums too are taken in a fixed order (the
    # hyperprior draws' group sums through ops.segment.GroupSums), so that
    # state is the same on every run, and the largest distance is gated
    # there as at the check state
    draw_tol = 1.5 * res["plain_rms"]
    max_tol = 1.5 * res["plain_max"]
    draw_err_tol = max(1e-3, 3 * res["plain_draw_err"])
    print(f"bench_bs draws at {state}: distances in posterior sd from the float64 draws "
          f"over {res['features']} features, schur_draw on rel_stats' GG rms "
          f"{res['kernel_rms']:.4g} (tol {draw_tol:.4g}: 1.5 x the float32 plain version's "
          f"{res['plain_rms']:.4g}), median / p99 / max {res['kernel_median']:.4g} / "
          f"{res['kernel_p99']:.4g} / {res['kernel_max']:.4g} (plain "
          f"{res['plain_median']:.4g} / {res['plain_p99']:.4g} / {res['plain_max']:.4g}); "
          f"{res['rejected']} rejected; rel_stats {res['stat_err']:.3g} and its float32 plain "
          f"version {res['stats_plain_f32_err']:.3g} of the sums of magnitudes from float64 "
          f"(tol {res['stat_tol']:.3g}); schur_draw's relational form: its draws the same "
          f"bits as schur_draw's, {res['draw_err']:.3g} from schur_draw_plain's on the same "
          f"GG (the largest difference over max(1, the largest magnitude); tol "
          f"{draw_err_tol:.3g}: max(1e-3, 3 x schur_draw_plain's {res['plain_draw_err']:.3g} "
          f"from its own float64 draws)), its SD (K10's update) {res['upd_err']:.3g} from "
          f"rel_update_plain's (tol 1e-5)")
    if not res["kernel_rms"] <= draw_tol or res["rejected"]:
        fail(f"bench_bs at {state}: draws from rel_stats' GG lie {res['kernel_rms']} posterior "
             f"sd (rms) from float64 (> {draw_tol}) or were rejected ({res['rejected']})")
    print(f"bench_bs draws at {state}: largest distance {res['kernel_max']:.4g} (tol "
          f"{max_tol:.4g}: 1.5 x the float32 plain version's {res['plain_max']:.6g})")
    if not res["kernel_max"] <= max_tol:
        fail(f"bench_bs at {state}: a draw from rel_stats' GG lies {res['kernel_max']} "
             f"posterior sd from float64 (> {max_tol})")
    if not res["draw_err"] <= draw_err_tol:
        fail(f"bench_bs at {state}: schur_draw's relational form lies {res['draw_err']} from "
             f"schur_draw_plain on the same GG (> {draw_err_tol})")
    if not res["stat_err"] <= res["stat_tol"] or not res["upd_err"] <= 1e-5:
        fail(f"bench_bs at {state}: rel_stats ({res['stat_err']} > {res['stat_tol']}) or "
             f"K10's update of SD ({res['upd_err']} > 1e-5) disagrees")
    return dict(res, state=state, draw_tol=draw_tol, max_tol=max_tol,
                draw_err_tol=draw_err_tol)


def bs_chain_check(rec, dev, bs, learner):
    """The draw check of `bs_sweeps` again at a state of the chain: the
    parameters, alpha and hyperpriors `learner` (mcmc_bs) ends with (its
    last iteration a refresh), the caches taken from A as that refresh
    writes it. Its launches fall outside every path's count."""
    from libfm_tpu_torch.kernels import rel_cache as rc
    from libfm_tpu_torch.kernels import rel_refresh as rr
    from libfm_tpu_torch.learners.mcmc_rel_vector import DevRel

    st = learner._final_state
    train, lay = bs["train"], bs["layout"]
    rel = DevRel(lay, dev)
    P = torch.cat([st["w"][:, None], st["V"]], dim=1).contiguous()
    A = torch.empty(train.num_rows, P.shape[1], device=dev)
    rr.rel_refresh(rr.rel_scores(P, rel.indptr, rel.cols, rel.vals), rel.map_tr[None].contiguous(),
                   st["w0"], A, torch.as_tensor(train.target, device=dev),
                   min_target=float(train.min_target), max_target=float(train.max_target))
    C = rc.rel_cache(A, rel.case_off, rel.case_ids)
    del A
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    bound = 1e6 * max(1.0, abs(float(train.min_target)), abs(float(train.max_target)))
    lam_row = torch.cat([st["w_lambda"][:1], st["v_lambda"][0]])
    mu_row = torch.cat([st["w_mu"][:1], st["v_mu"][0]])
    _, _, res = bs_sweeps(rel, lay, C, P, st["alpha"], lam_row, mu_row, g, bound)
    state = (f"mcmc_bs's last state (alpha {float(st['alpha']):.4g}, lambda_w "
             f"{float(st['w_lambda'][0]):.4g}, mean lambda_v "
             f"{float(st['v_lambda'].mean()):.4g})")
    rec["bs_sweep_chain"] = check_bs_draws(res, state)
    del C, P
    torch.cuda.empty_cache()


def bs_kernel_checks(args, rec, dev, bs):
    """Phase 3, bench_bs: the BS engine's six kernels against their plain
    versions at its shapes. rel_scores and rel_refresh (train and tail
    modes) from a seeded P; rel_cache from the A that refresh writes, held
    to the float64 plain version entry by entry over the entry's sum of
    magnitudes; two sweeps of the 23 blocks (`bs_sweeps`: rel_stats,
    every draw from its GG and K10's update of SD, by schur_draw's
    relational form, held in the second; the form timed with and without
    the update);
    rel_resync in write mode on the train rows and read-only on the test
    tail."""
    import numpy as np

    from libfm_tpu_torch.kernels import rel_cache as rc
    from libfm_tpu_torch.kernels import rel_refresh as rr
    from libfm_tpu_torch.kernels import rel_sweep as rs
    from libfm_tpu_torch.kernels.case_stats import err_over_magnitudes
    from libfm_tpu_torch.kernels.slot_stats import gg_width
    from libfm_tpu_torch.learners.mcmc_rel_vector import DevRel, stacked_design

    train, test, lay = bs["train"], bs["test"], bs["layout"]
    k, d, n = BS_FACTORS, BS_FACTORS + 1, BS_NF
    T = k * (k + 1) // 2
    CW, GW = rc.cache_width(k), gg_width(k)
    nc, nte, nb = train.num_rows, test.num_rows, lay.nb
    nnz = int(lay.cols.shape[0])
    rel = DevRel(lay, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    P = 0.1 * torch.randn(n, d, generator=g, device=dev)
    w0 = torch.tensor(0.05, device=dev)
    y = torch.as_tensor(train.target, device=dev)
    out = []

    def entry(*a, source, timed="one launch (at the set-up and each refresh)", **kw):
        out.append(kernel_row(*a, timed=timed, source=f"libfm_tpu_torch/csrc/{source}",
                              **kw))

    # ---- rel_scores: bench_bs's relation, then two relations stacked in one
    # launch (bench_bs's and its first half of block rows as a second)
    sc_args = (P, rel.indptr, rel.cols, rel.vals)
    SC = rr.rel_scores(*sc_args)
    SC_p = rr.rel_scores_plain(*sc_args)
    SC_2 = rr.rel_scores(*sc_args)
    torch.cuda.synchronize()
    repeat_check("rel_scores SC, bench_bs", (SC,), (SC_2,), rec)
    half = nb // 2
    cut = int(rel.indptr[half])
    rel2 = types.SimpleNamespace(indptr=rel.indptr[:half + 1], cols=rel.cols[:cut],
                                 vals=rel.vals[:cut])
    SC2_k = rr.rel_scores(P, *stacked_design([rel, rel2]))
    SC2_p = rr.rel_scores_plain(P, *stacked_design([rel, rel2]))
    torch.cuda.synchronize()
    # each row is its relation's own: the same bits as the one-relation call's
    stacked_same = (torch.equal(SC2_k[:nb + 1], SC)
                    and torch.equal(SC2_k[nb + 1:nb + 1 + half], SC[:half])
                    and not SC2_k[nb + 1 + half].any())
    err2 = col_rel_err(SC2_k, SC2_p).item()
    print(f"rel_scores, two relations in one launch ({nb + 1} + {half + 1} rows): err "
          f"{err2:.3g} (tol 1e-5); rows the one-relation call's bits and sentinels 0: "
          f"{stacked_same}")
    if not stacked_same:
        fail("rel_scores over two stacked relations: a row differs from its relation's own")
    entry("rel_scores", "libfm_tpu/learners/mcmc_rel_vector.py:761",
          max(col_rel_err(SC, SC_p).item(), err2), 1e-5,
          cuda_ms(lambda: rr.rel_scores(*sc_args), args.reps),
          cuda_ms(lambda: rr.rel_scores_plain(*sc_args), args.reps),
          nbytes=(nb + 1) * 8 + nnz * 8 + len(np.unique(lay.cols)) * d * 4
          + (nb + 1) * (k + 2) * 4,
          flops=nnz * (4 * k + 2), lib_ms=None, source="rel_refresh.cu",
          timed="one launch at bench_bs (at the set-up and each refresh)")
    out[-1]["library_note"] = ("none: one sparse product gives qB and linB, not sqB "
                               "(a sum of squares over the entries)")
    out[-1]["two_relations"] = dict(max_abs_err=err2, rows_equal_one_relation=stacked_same)
    del SC_p, SC_2, SC2_k, SC2_p

    # ---- rel_refresh, train mode (the refresh) and tail mode
    maps_tr, maps_te = rel.map_tr[None].contiguous(), rel.map_te[None].contiguous()
    kw = dict(min_target=float(train.min_target), max_target=float(train.max_target))
    A, A_p = torch.empty(nc, d, device=dev), torch.empty(nc, d, device=dev)
    tail, tail_p = torch.empty(nte, d, device=dev), torch.empty(nte, d, device=dev)
    m_k = rr.rel_refresh(SC, maps_tr, w0, A, y, **kw)
    m_p = rr.rel_refresh_plain(SC, maps_tr, w0, A_p, y, **kw)
    rr.rel_refresh(SC, maps_te, w0, tail)
    rr.rel_refresh_plain(SC, maps_te, w0, tail_p)
    err = max(col_rel_err(A, A_p).item(), col_rel_err(tail, tail_p).item(),
              abs(m_k.item() - m_p.item()) / m_p.item())
    A_2 = torch.empty_like(A)
    m_2 = rr.rel_refresh(SC, maps_tr, w0, A_2, y, **kw)
    torch.cuda.synchronize()
    repeat_check("rel_refresh A, bench_bs train mode", (A,), (A_2,), rec)
    repeat_check("rel_refresh summed error, bench_bs train mode", (m_k,), (m_2,), rec)
    note_bits("rel_refresh tail, bench_bs tail mode", rec, tail)
    del A_2
    entry("rel_refresh", "libfm_tpu/learners/mcmc_rel_vector.py:777", err, 1e-5,
          cuda_ms(lambda: rr.rel_refresh(SC, maps_tr, w0, A, y, **kw), args.reps),
          cuda_ms(lambda: rr.rel_refresh_plain(SC, maps_tr, w0, A_p, y, **kw), args.reps),
          nbytes=nc * (d * 4 + 8) + (nb + 1) * (k + 2) * 4, flops=nc * (2 * k + 8),
          lib_ms=None, timed="one train-mode launch (the refresh)", source="rel_refresh.cu")
    out[-1]["library_note"] = "none: no one call gathers the joined rows' scores"
    out[-1]["tail_mode_ms"] = cuda_ms(lambda: rr.rel_refresh(SC, maps_te, w0, tail),
                                      args.reps)
    out[-1]["tail_mode_bound_ms"] = bound_ms(nte * (d * 4 + 4) + (nb + 1) * (k + 2) * 4,
                                             0)[0]
    print(f"rel_refresh tail mode: ms={out[-1]['tail_mode_ms']:.4f} "
          f"bound_ms={out[-1]['tail_mode_bound_ms']:.4f} (bytes)")
    del A_p, tail_p

    # ---- rel_cache, from the refreshed A
    C = rc.rel_cache(A, rel.case_off, rel.case_ids)
    C_2 = rc.rel_cache(A, rel.case_off, rel.case_ids)
    torch.cuda.synchronize()
    repeat_check("rel_cache C, bench_bs", (C,), (C_2,), rec)
    del C_2
    ref, scale = rc.rel_cache_reference(A, rel.case_off, rel.case_ids)
    counts = np.diff(lay.case_off)
    lmax = int(counts.max())
    err = err_over_magnitudes(C, ref, scale)
    del ref, scale
    # the yardstick: one bmm of the pre-gathered, zero-padded rows [1 | e | Q]
    # a block row (its R^T R holds every cache; the gather is not timed)
    rowid = torch.as_tensor(np.repeat(np.arange(nb), counts), device=dev)
    pos = torch.as_tensor(np.arange(nc) - np.repeat(lay.case_off[:-1], counts), device=dev)
    R = torch.zeros(nb, lmax, k + 2, device=dev)
    R[rowid, pos, 0] = 1.0
    R[rowid, pos, 1:] = A[rel.case_ids.long()]
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = cuda_ms(lambda: torch.bmm(R.transpose(1, 2), R), args.reps)
    del R, rowid, pos
    entry("rel_cache", "libfm_tpu/learners/mcmc_rel_vector.py:982", err,
          2 * (lmax + 2) * U32,
          cuda_ms(lambda: rc.rel_cache(A, rel.case_off, rel.case_ids), args.reps),
          cuda_ms(lambda: rc.rel_cache_plain(A, rel.case_off, rel.case_ids), args.reps),
          nbytes=nc * (d * 4 + 4) + (nb + 1) * 8 + (nb + 1) * CW * 4,
          flops=2 * nc * CW, lib_ms=lib, source="rel_cache.cu",
          timed="one launch (deferred path: at the set-up and each refresh)")
    out[-1]["library_note"] = ("torch.bmm(R^T, R) of the pre-gathered rows [1 | e | Q], "
                               f"zero-padded to [nb, {lmax}, k+2], fp32 without TF32; "
                               "the gather not timed")
    out[-1]["tolerance_note"] = ("2 (most cases on a row + 2) float32 roundings of each "
                                 "entry's sum of magnitudes: a sequential sum's bound")
    print(f"rel_cache at bench_bs: ms={out[-1]['ms']:.4f}; the first version took "
          f"{REL_CACHE_FIRST_MS} ms (PERF.md, on an H100 80GB HBM3 at 700 W)")

    # ---- one sweep to make SD non-zero, then a checked one
    alpha = torch.tensor(2.0, device=dev)
    bound = 1e6 * max(1.0, abs(kw["min_target"]), abs(kw["max_target"]))
    SD, sweep_in, res = bs_sweeps(rel, lay, C, P, alpha, torch.full((d,), 5.0, device=dev),
                                  torch.zeros(d, device=dev), g, bound)
    stat_err, upd_err, stat_tol = res["stat_err"], res["upd_err"], res["stat_tol"]
    rec["bs_sweep"] = check_bs_draws(res, "the check state (P = 0.1 randn, alpha 2, "
                                     "lambda 5)")
    note_bits("bench_bs sweeps: SD", rec, SD)
    note_bits("bench_bs sweeps: theta", rec, P)
    # ---- rel_deferred: the deferred path's closed-form sums (float64) at
    # this SD, within a float32 ulp of the plain version's; two calls the
    # same bits. Bound: C, SD and wnum read once, the two sums written;
    # the float64 operations (each triangle entry's 4, each factor's 6)
    # at the card's fp64 rate
    def_k = torch.stack(rs.rel_deferred(C, SD, rel.wnum))
    def_2 = torch.stack(rs.rel_deferred(C, SD, rel.wnum))
    def_p = torch.stack(rs.rel_deferred_plain(C, SD, rel.wnum))
    torch.cuda.synchronize()
    repeat_check("rel_deferred (sum e, sum e^2), bench_bs", (def_k,), (def_2,), rec)
    ulp = torch.nextafter(def_p.abs(), torch.full_like(def_p, math.inf)) - def_p.abs()
    print(f"rel_deferred: kernel {def_k.tolist()}, plain {def_p.tolist()}")
    entry("rel_deferred", "libfm_tpu/learners/mcmc_rel_vector.py:1053",
          ((def_k - def_p).abs() / ulp).max().item(), 1.0,
          cuda_ms(lambda: rs.rel_deferred(C, SD, rel.wnum), args.reps),
          cuda_ms(lambda: rs.rel_deferred_plain(C, SD, rel.wnum), args.reps),
          nbytes=(nb + 1) * (CW + d + 1) * 4 + 8, flops=(nb + 1) * (4 * T + 6 * k + 12),
          lib_ms=None, source="rel_sweep.cu", peak_flops=PEAK_FP64_FLOPS,
          timed="one launch (deferred path: each iteration, again at each one without a "
          "refresh)")
    out[-1]["library_note"] = "none: no one call forms the rows' closed-form sums"
    out[-1]["tolerance_note"] = ("float32 ulps of the plain version's sums (both float64, "
                                 "summed in another order)")
    del def_k, def_2, def_p

    def run_stats(fn):
        def go():
            for blk in rel.blocks:
                fn(C, SD, rel.wnum, blk.feat_off, blk.entry_b, blk.entry_x, blk.feat_id, P)
        return go

    E = nnz
    F = sum(blk.F for blk in rel.blocks)
    entry("rel_stats", "libfm_tpu/learners/mcmc_rel_vector.py:1144", stat_err, stat_tol,
          cuda_ms(run_stats(rs.rel_stats), args.reps),
          cuda_ms(run_stats(rs.rel_stats_plain), args.reps),
          nbytes=E * (8 + (CW + d + 1) * 4) + len(rel.blocks) * 8 + F * (8 + 4 + d * 4
                                                                         + GW * 4),
          flops=E * (8 * T + 2 * k * k + 12 * k) + F * 6 * T, lib_ms=None,
          source="rel_sweep.cu", timed=f"one iteration's launches: one per block "
          f"({len(rel.blocks)})")
    out[-1]["library_note"] = ("none: no one call sums the corrected caches' moments per "
                               "feature and rebuilds GG")
    out[-1]["tolerance_note"] = ("2 (most entries of a feature + k + 8) float32 roundings "
                                 "of each entry's sum of magnitudes")

    # ---- K10's update, inside schur_draw's relational form: the checked
    # sweep's 23 launches timed with the update (on a copy of SD) and as
    # plain schur_draw launches; the update's cost is their difference
    from libfm_tpu_torch.kernels import schur_draw as sd

    SD_t = SD.clone()
    entry_f = {id(blk): torch.as_tensor(hb.entry_f, device=dev)
               for hb, blk in zip(lay.blocks, rel.blocks)}

    def run_sweep(update):
        def go():
            for blk, th_old, _, G, lam, mu, z in sweep_in:
                if update:
                    sd.schur_draw_rel(G, th_old, lam, mu, z, alpha, SD_t, blk.feat_off,
                                      blk.entry_b, blk.entry_x, do_sample=True, bound=bound)
                else:
                    sd.schur_draw(G, th_old, lam, mu, z, alpha, do_sample=True, bound=bound)
        return go

    def run_upd_plain():
        for blk, th_old, th_new, *_ in sweep_in:
            rs.rel_update_plain(SD_t, blk.entry_b, blk.entry_x, entry_f[id(blk)], th_old,
                                th_new)

    draw_ms = cuda_ms(run_sweep(False), args.reps)
    fused_ms = cuda_ms(run_sweep(True), args.reps)
    draw_ms_2 = cuda_ms(run_sweep(False), args.reps)
    # bound: the update's own work inside the draw (old and new theta are
    # in registers there): each entry's b and x read, its SD row read and
    # written, and each block's feat_off
    entry("rel_update", "libfm_tpu/learners/mcmc_rel_vector.py:1284", upd_err, 1e-5,
          fused_ms - (draw_ms + draw_ms_2) / 2, cuda_ms(run_upd_plain, args.reps),
          nbytes=E * (8 + 2 * d * 4) + (F + len(rel.blocks)) * 8, flops=E * (6 * k + 4),
          lib_ms=None,
          source="schur_draw.cu",
          timed=f"one iteration's launches of schur_draw's relational form, one per block "
          f"({len(rel.blocks)}), less the same launches as plain schur_draw")
    out[-1].update(fused_ms=fused_ms, draw_ms=[draw_ms, draw_ms_2])
    out[-1]["library_note"] = "none: no one call forms and adds the rows' shifts"
    print(f"schur_draw's relational form at bench_bs ({len(rel.blocks)} launches): "
          f"{fused_ms:.4f} ms with K10's update, {draw_ms:.4f} / {draw_ms_2:.4f} as plain "
          f"schur_draw (before / after); the standalone rel_update took "
          f"{REL_UPDATE_FIRST_MS} ms (PERF.md, on an H100 80GB HBM3 at 700 W)")
    del SD_t

    # ---- rel_resync: write mode on the train rows, read-only on the tail
    A_k, A_p = A.clone(), A.clone()
    rs.rel_resync(SD, rel.map_tr, A_k)
    rs.rel_resync_plain(SD, rel.map_tr, A_p)
    e_k = rs.rel_resync(SD, rel.map_te, tail, read_only=True)
    e_p = rs.rel_resync_plain(SD, rel.map_te, tail, read_only=True)
    err = max(col_rel_err(A_k, A_p).item(),
              ((e_k - e_p).abs().max() / e_p.abs().max()).item())
    # both modes' outputs the same bits on a second launch; their digests
    # (A after write mode, the read-only predictions) are what an A/B
    # against an earlier commit compares
    A_2 = A.clone()
    rs.rel_resync(SD, rel.map_tr, A_2)
    e_2 = rs.rel_resync(SD, rel.map_te, tail, read_only=True)
    torch.cuda.synchronize()
    repeat_check("rel_resync A, bench_bs write mode", (A_k,), (A_2,), rec)
    repeat_check("rel_resync predictions, bench_bs read-only mode", (e_k,), (e_2,), rec)
    del A_2, e_2
    plan = rs.resync_plan(k)
    entry("rel_resync", "libfm_tpu/learners/mcmc_rel_vector.py:1548", err, 1e-5,
          cuda_ms(lambda: rs.rel_resync(SD, rel.map_te, tail, read_only=True), args.reps),
          cuda_ms(lambda: rs.rel_resync_plain(SD, rel.map_te, tail, read_only=True),
                  args.reps),
          nbytes=nte * (d * 4 + 8) + (nb + 1) * d * 4, flops=nte * (2 * k + 2), lib_ms=None,
          source="rel_sweep.cu",
          timed="one read-only launch on the test tail (the deferred path's prediction)")
    out[-1]["library_note"] = "none: no one call gathers, dots and shifts the rows"
    out[-1]["plan"] = plan._asdict()
    out[-1]["write_mode_ms"] = cuda_ms(lambda: rs.rel_resync(SD, rel.map_tr, A_k),
                                       args.reps)
    out[-1]["write_mode_bound_ms"] = bound_ms(nc * (d * 8 + 4) + (nb + 1) * d * 4, 0)[0]
    print(f"rel_resync write mode, the train rows: ms={out[-1]['write_mode_ms']:.4f} "
          f"bound_ms={out[-1]['write_mode_bound_ms']:.4f} (bytes); run {plan.run} cases, "
          f"{plan.smem_bytes} bytes of shared memory; the first version took "
          f"{REL_RESYNC_FIRST_MS['read-only']} ms read-only, "
          f"{REL_RESYNC_FIRST_MS['write']} ms in write mode (PERF.md, on an H100 80GB HBM3 "
          f"at 700 W)")
    del A, A_k, A_p, tail, C, SD, SC, sweep_in
    torch.cuda.empty_cache()
    return out


def bs_ctx_data(dev, bs):
    """bench_bs_ctx's data: bench_bs's relation, joins and targets with a
    main table of two one-hot context fields (BS_CTX_SEED's draws, the
    relation's features moved past the main table's 1,168), for regression
    and for probit classification (bench_bs_c: the sign of the regression
    target); its main blocks and relation layout as the BS engine cuts
    them. Prints the block counts and shapes, the observed and unobserved
    features and the learner's route."""
    import numpy as np

    from libfm_tpu_torch.data.dataset import Dataset
    from libfm_tpu_torch.data.relation import RelationData, RelationJoin
    from libfm_tpu_torch.learners.mcmc_rel_vector import RelLayout, main_layout
    from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner
    from libfm_tpu_torch.models.fm import FMConfig

    train0, test0 = bs["train"], bs["test"]
    rd0 = train0.relations[0].data
    n_main = BS_DAYS + BS_HOURS
    rd = RelationData(rd0.indptr, rd0.cols, rd0.vals, rd0.num_features)
    rd.attr_offset = n_main
    n = n_main + rd.num_features
    ntr, nte = train0.num_rows, test0.num_rows
    ctx = np.random.default_rng(BS_CTX_SEED)
    gD = ctx.standard_normal(BS_DAYS)
    gH = ctx.standard_normal(BS_HOURS)
    day = ctx.integers(0, BS_DAYS, ntr + nte)
    hour = ctx.integers(0, BS_HOURS, ntr + nte)
    y_all = (np.concatenate([train0.target, test0.target]).astype(np.float64)
             + BS_CTX_WEIGHT * gD[day] + BS_CTX_WEIGHT * gH[hour])
    cols = np.stack([day, BS_DAYS + hour], axis=1).astype(np.int32)

    def build(sl, join, y):
        m = len(y)
        ds = Dataset(np.arange(m + 1, dtype=np.int64) * 2, cols[sl].ravel(),
                     np.ones(2 * m, np.float32), y, n_main)
        ds.relations = [RelationJoin(rd, join.row_map)]
        return ds

    out = {}
    for task, ys in ((0, y_all.astype(np.float32)),
                     (1, np.where(y_all > 0, 1.0, -1.0).astype(np.float32))):
        out[task] = (build(slice(0, ntr), train0.relations[0], ys[:ntr]),
                     build(slice(ntr, None), test0.relations[0], ys[ntr:]))
    train, test = out[0]
    for ds in out[1]:
        ds.min_target, ds.max_target = -1.0, 1.0
    groups = np.zeros(n, np.int32)
    lay = RelLayout(train.relations[0], test.relations[0], groups, n)
    mains, main_unobs = main_layout(train, groups, n_main, dev)
    probe = MCMCVectorLearner(FMConfig(num_features=n, num_factors=BS_FACTORS),
                              verbose=False, device=dev)
    probe.expand_max_ratio = 0.0
    probe._route_relational(train, test)
    exp_nnz = (ntr + nte) * (BS_W + 2)
    main_shapes = [(b.F, int(b.slot_case.numel()),
                    int((b.feat_off[1:] - b.feat_off[:-1]).max().item())) for b in mains]
    observed = n - len(main_unobs) - len(lay.unobserved)
    share = float((out[1][1].target > 0).mean())
    print(f"bench_bs_ctx: {ntr} train and {nte} test cases, main table {n_main} features "
          f"(day {BS_DAYS}, hour {BS_HOURS}), {n} features in all; main blocks (features, "
          f"slots, most slots of a feature) {main_shapes}; {len(lay.blocks)} relation "
          f"blocks; {observed} observed and {len(main_unobs) + len(lay.unobserved)} "
          f"unobserved features; the join would expand to ~{exp_nnz} entries; "
          f"relational_mode {probe.relational_mode} (expand_max_ratio 0); bench_bs_c: "
          f"{share:.4f} of the test targets +1; regression test target sd "
          f"{float(test.target.std()):.4f}")
    if probe.relational_mode != "bs_vector":
        fail(f"bench_bs_ctx routes to {probe.relational_mode}, not bs_vector")
    return dict(train=train, test=test, train_c=out[1][0], test_c=out[1][1], layout=lay,
                mains=mains, num_features=n, blocks=len(lay.blocks), main_blocks=len(mains),
                main_shapes=main_shapes, observed=observed, positive_share=share)


def bs_ctx_kernel_checks(args, rec, dev, ctx):
    """Phase 3, bench_bs_ctx: rel_refresh with the main table's rows (train
    and test modes; A per column within BS_CTX_A_TOL, the summed error
    within BS_CTX_SUM_TOL), rel_refresh_probit (sampling on given
    uniforms, and expectations: Q and the predictions, the latents as
    config #4's fm_refresh probit check holds them, the correct count
    equal), and on both main blocks slot_stats, schur_draw and slot_update
    (K12's main half), each against its plain version, from a seeded P."""
    from libfm_tpu_torch.data.vector_layout import padded_rows_layout
    from libfm_tpu_torch.kernels import dense_update as du
    from libfm_tpu_torch.kernels import rel_refresh as rr
    from libfm_tpu_torch.kernels import schur_draw as sd
    from libfm_tpu_torch.kernels import slot_stats as ss
    from libfm_tpu_torch.kernels import slot_update as su
    from libfm_tpu_torch.learners.mcmc_rel_vector import DevRel
    from libfm_tpu_torch.ops.samplers import probit_latent as draw

    train, test, lay, mains = ctx["train"], ctx["test"], ctx["layout"], ctx["mains"]
    k, d, n = BS_FACTORS, BS_FACTORS + 1, ctx["num_features"]
    T = k * (k + 1) // 2
    GW = ss.gg_width(k)
    nc, nte, nb = train.num_rows, test.num_rows, lay.nb
    n_main = BS_DAYS + BS_HOURS
    rel = DevRel(lay, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    P = 0.1 * torch.randn(n, d, generator=g, device=dev)
    w0 = torch.tensor(0.05, device=dev)
    y = torch.as_tensor(train.target, device=dev)
    y_c = torch.as_tensor(ctx["train_c"].target, device=dev)
    out = []

    def rows(ds):
        ids, vals = padded_rows_layout(ds.indptr, ds.cols, ds.vals)
        return dict(P=P, ids=torch.as_tensor(ids, device=dev),
                    vals=torch.as_tensor(vals, device=dev))

    main_tr, main_te = rows(train), rows(test)
    L = main_tr["ids"].shape[1]
    SC = rr.rel_scores(P, rel.indptr, rel.cols, rel.vals)
    maps_tr, maps_te = rel.map_tr[None].contiguous(), rel.map_te[None].contiguous()
    kw = dict(min_target=float(train.min_target), max_target=float(train.max_target))
    sc_bytes = (nb + 1) * (k + 2) * 4 + n_main * d * 4

    # ---- rel_refresh with main rows: train mode (the refresh), test mode
    A, A_p = torch.empty(nc, d, device=dev), torch.empty(nc, d, device=dev)
    m_k = rr.rel_refresh(SC, maps_tr, w0, A, y, **main_tr, **kw)
    m_p = rr.rel_refresh_plain(SC, maps_tr, w0, A_p, y, **main_tr, **kw)
    pt_k = rr.rel_refresh(SC, maps_te, w0, **main_te)
    pt_p = rr.rel_refresh_plain(SC, maps_te, w0, **main_te)
    torch.cuda.synchronize()
    err_A = max(col_rel_err(A, A_p).item(),
                ((pt_k - pt_p).abs().max() / pt_p.abs().max()).item())
    err_sum = abs(m_k.item() - m_p.item()) / m_p.item()
    A_2 = torch.empty_like(A)
    m_2 = rr.rel_refresh(SC, maps_tr, w0, A_2, y, **main_tr, **kw)
    torch.cuda.synchronize()
    repeat_check("rel_refresh A, bench_bs_ctx train mode (main rows)", (A,), (A_2,), rec)
    repeat_check("rel_refresh summed error, bench_bs_ctx train mode (main rows)", (m_k,),
                 (m_2,), rec)
    note_bits("rel_refresh pred, bench_bs_ctx test mode", rec, pt_k)
    del A_2
    row = kernel_row(
        "rel_refresh", "libfm_tpu/learners/mcmc_rel_vector.py:777", err_A, BS_CTX_A_TOL,
        cuda_ms(lambda: rr.rel_refresh(SC, maps_tr, w0, A, y, **main_tr, **kw), args.reps),
        cuda_ms(lambda: rr.rel_refresh_plain(SC, maps_tr, w0, A_p, y, **main_tr, **kw),
                args.reps),
        nbytes=nc * (d * 4 + 4 + 4 + L * 8) + sc_bytes,
        flops=nc * (L * (4 * k + 2) + 2 * k + 8), lib_ms=None,
        timed="one train-mode launch at bench_bs_ctx (the refresh), main rows",
        label=" (bench_bs_ctx, main rows)", source="libfm_tpu_torch/csrc/rel_refresh.cu")
    row.update(config="bench_bs_ctx", error_sum_rel_err=err_sum,
               error_sum_tolerance=BS_CTX_SUM_TOL,
               library_note="none: no one call gathers the main rows and the joined "
               "rows' scores",
               test_mode_ms=cuda_ms(lambda: rr.rel_refresh(SC, maps_te, w0, **main_te),
                                    args.reps),
               test_mode_bound_ms=bound_ms(nte * (4 + 4 + L * 8) + sc_bytes, 0)[0])
    print(f"rel_refresh (bench_bs_ctx) summed error {err_sum:.3g} (tol {BS_CTX_SUM_TOL:g}); "
          f"test mode ({nte} cases) ms={row['test_mode_ms']:.4f} "
          f"bound_ms={row['test_mode_bound_ms']:.4f} (bytes)")
    if not err_sum <= BS_CTX_SUM_TOL:
        fail(f"rel_refresh with main rows: the summed error lies {err_sum} from the plain "
             f"version's (> {BS_CTX_SUM_TOL})")
    out.append(row)
    del A_p

    # ---- rel_refresh_probit: sampling (MCMC) and expectation (ALS)
    U = torch.rand(nc, generator=g, device=dev)
    cases = {}
    for mode, u in (("sample", U), ("mean", None)):
        A_k, A_p = torch.empty(nc, d, device=dev), torch.empty(nc, d, device=dev)
        lat_k, lat_p = torch.empty(nc, device=dev), torch.empty(nc, device=dev)
        pk = dict(probit=mode, U=u, **main_tr)
        c_k = rr.rel_refresh(SC, maps_tr, w0, A_k, y_c, latent=lat_k, **pk)
        c_p = rr.rel_refresh_plain(SC, maps_tr, w0, A_p, y_c, latent=lat_p, **pk)
        A_2, lat_2 = torch.empty_like(A_k), torch.empty_like(lat_k)
        c_2 = rr.rel_refresh(SC, maps_tr, w0, A_2, y_c, latent=lat_2, **pk)
        torch.cuda.synchronize()
        repeat_check(f"rel_refresh_probit A and latents, bench_bs_c ({mode})", (A_k, lat_k),
                     (A_2, lat_2), rec)
        repeat_check(f"rel_refresh_probit correct count, bench_bs_c ({mode})", (c_k,), (c_2,),
                     rec)
        del A_2, lat_2
        # the kernel's predictions, as e + latent (to an ulp); a draw more
        # than LATENT_CHECKED from its mean turns that ulp into more than 1e-5
        pred_k = A_k[:, 0] + lat_k
        lat_ref = draw(pred_k, y_c, u)
        near = ((lat_ref - pred_k).abs() <= LATENT_CHECKED if u is not None
                else torch.ones_like(y_c, dtype=torch.bool))
        err = max(
            col_rel_err(A_k[:, 1:], A_p[:, 1:]).item(),
            (pred_k - (A_p[:, 0] + lat_p)).abs().max().item(),
            ((lat_k - lat_ref).abs() / lat_ref.abs().clamp_min(1.0))[near].max().item(),
            float(not ((lat_k >= 0) == (y_c >= 0)).all()),
        )
        cases[mode] = dict(
            max_abs_err=err, correct_kernel=c_k.item(), correct_plain=c_p.item(),
            cases_beyond_latent_check=int((~near).sum().item()),
            ms=cuda_ms(lambda: rr.rel_refresh(SC, maps_tr, w0, A_k, y_c, latent=lat_k,
                                              **pk), args.reps),
            plain_ms=cuda_ms(lambda: rr.rel_refresh_plain(SC, maps_tr, w0, A_p, y_c,
                                                          latent=lat_p, **pk), args.reps))
        print(f"rel_refresh_probit ({mode}): err {err:.3g} (Q 1e-4 per column, pred 1e-4 "
              f"absolute, latents 1e-5 relative above 1 against the plain draw on the "
              f"kernel's predictions where the draw lies within {LATENT_CHECKED} of its "
              f"mean, all but {cases[mode]['cases_beyond_latent_check']} cases; every latent "
              f"on y's side of 0), correct {c_k.item():.0f} (plain {c_p.item():.0f}), ms "
              f"{cases[mode]['ms']:.4f} plain {cases[mode]['plain_ms']:.4f}")
        if c_k.item() != c_p.item():
            fail(f"rel_refresh_probit ({mode}): correct count {c_k.item()} against the plain "
                 f"version's {c_p.item()}")
        del A_k, A_p, lat_k, lat_p
    row = kernel_row(
        "rel_refresh_probit", "libfm_tpu/learners/mcmc_rel_vector.py:816",
        max(c["max_abs_err"] for c in cases.values()), 1e-4,
        cases["sample"]["ms"], cases["sample"]["plain_ms"],
        # maps, main ids and values, y, U and the latents, the rows of A
        nbytes=nc * (4 + L * 8 + 3 * 4 + d * 4) + sc_bytes,
        flops=nc * (L * (4 * k + 2) + 2 * k + 8 + 40), lib_ms=None,
        timed="one probit train-mode launch at bench_bs_c (sampling), main rows",
        source="libfm_tpu_torch/csrc/rel_refresh.cu")
    row.update(config="bench_bs_c", cases=cases,
               library_note="none: no one call computes the gathered forward and draws "
               "the truncated normals")
    out.append(row)

    # ---- K12's main half on both main blocks, from the refreshed A
    GG = [torch.empty(b.F, GW, device=dev) for b in mains]
    errs = []
    for b, G in zip(mains, GG):
        ss.slot_stats(A, P, b.feat_off, b.slot_case, b.slot_val, b.feat_id, GG=G,
                      pieces=b.pieces)
        Gp = ss.slot_stats_plain(A, P, b.feat_off, b.slot_case, b.slot_val, b.feat_id)
        torch.cuda.synchronize()
        errs.append(ss.gg_rel_err(G, Gp, k))
        del Gp

    def run_stats(fn):
        def go():
            for b, G in zip(mains, GG):
                fn(A, P, b.feat_off, b.slot_case, b.slot_val, b.feat_id, GG=G,
                   pieces=b.pieces)
        return go

    E = sum(int(b.slot_case.numel()) for b in mains)
    F = sum(b.F for b in mains)
    timed = f"one iteration's launches at bench_bs_ctx: one per main block ({len(mains)})"
    row = kernel_row(
        "slot_stats", "libfm_tpu/learners/mcmc_rel_vector.py:910", max(errs), 1e-4,
        cuda_ms(run_stats(ss.slot_stats), args.reps),
        cuda_ms(run_stats(ss.slot_stats_plain), args.reps, warmup=1),
        nbytes=E * (8 + d * 4) + F * (4 + 8 + k * 4 + GW * 4),
        flops=E * (2 * T + 7 * k + 4), lib_ms=None, timed=timed,
        label=" (bench_bs_ctx main blocks)")
    row.update(config="bench_bs_ctx", rel_err_per_block=errs,
               library_note="none: the per-feature Gram over a ragged slot list is no one "
               "call")
    out.append(row)

    alpha = torch.tensor(2.0, device=dev)
    bound = 1e6 * max(1.0, abs(kw["min_target"]), abs(kw["max_target"]))
    sys_in = []
    for b, G in zip(mains, GG):
        sys_in.append((G, P[b.features].contiguous(), torch.full((b.F, d), 5.0, device=dev),
                       0.01 * torch.randn(b.F, d, generator=g, device=dev),
                       torch.randn(b.F, d, generator=g, device=dev)))
    errs, nrej = [], 0
    for G, theta, lam, mu, z in sys_in:
        for samp in (True, False):
            tk, rk = sd.schur_draw(G, theta, lam, mu, z, alpha, do_sample=samp, bound=bound)
            tp, rp = sd.schur_draw_plain(G, theta, lam, mu, z, alpha, do_sample=samp,
                                         bound=bound)
            torch.cuda.synchronize()
            errs.append(((tk - tp).abs().max() / tp.abs().max().clamp_min(1.0)).item())
            if not torch.equal(rk, rp):
                fail("bench_bs_ctx: schur_draw's reject flags differ from the plain version's")
            nrej += int(rk.sum().item())

    def run_draw(fn):
        def go():
            for G, theta, lam, mu, z in sys_in:
                fn(G, theta, lam, mu, z, alpha, do_sample=True, bound=bound)
        return go

    S_lib = [sd.schur_system(G, theta, lam, mu, alpha)[0] for G, theta, lam, mu, _ in sys_in]
    rhs_lib = [torch.randn(S.shape[0], k, 1, generator=g, device=dev) for S in S_lib]

    def run_lib():
        for S, r in zip(S_lib, rhs_lib):
            Lf = torch.linalg.cholesky(S)
            yv = torch.linalg.solve_triangular(Lf, r, upper=False)
            torch.linalg.solve_triangular(Lf.transpose(-1, -2), yv, upper=True)

    row = kernel_row(
        "schur_draw", "libfm_tpu/learners/mcmc_rel_vector.py:945", max(errs), 1e-3,
        cuda_ms(run_draw(sd.schur_draw), args.reps),
        cuda_ms(run_draw(sd.schur_draw_plain), args.reps),
        nbytes=F * (GW * 4 + 5 * d * 4 + 4), flops=F * (k ** 3 / 3 + 6 * k * k),
        lib_ms=cuda_ms(run_lib, args.reps), timed=timed,
        label=" (bench_bs_ctx main blocks)")
    row.update(config="bench_bs_ctx", rejected_in_check=nrej,
               library_note="torch.linalg.cholesky + two solve_triangular on the same "
               "systems")
    out.append(row)
    if nrej:
        fail(f"bench_bs_ctx: schur_draw rejected {nrej} draws at the check state")
    del S_lib, rhs_lib

    tabs = []
    for G, theta, lam, mu, z in sys_in:
        tnew, _ = sd.schur_draw(G, theta, lam, mu, z, alpha, do_sample=True, bound=bound)
        tabs.append(du.update_table(theta, tnew))

    def run_upd(fn, A_):
        def go():
            for b, tab in zip(mains, tabs):
                fn(A_, b.upd_case, b.upd_val, b.upd_feat, tab)
        return go

    A_k, A_p = A.clone(), A.clone()
    run_upd(su.slot_update, A_k)()
    run_upd(su.slot_update_plain, A_p)()
    torch.cuda.synchronize()
    row = kernel_row(
        "slot_update", "libfm_tpu/learners/mcmc_rel_vector.py:956",
        col_rel_err(A_k, A_p).item(), 1e-5,
        cuda_ms(run_upd(su.slot_update, A_k), args.reps),
        cuda_ms(run_upd(su.slot_update_plain, A_p), args.reps, warmup=1),
        nbytes=E * (12 + 2 * d * 4) + sum((b.F + 1) * (d + 1) * 4 for b in mains),
        flops=E * (4 * k + 6), lib_ms=None, timed=timed,
        label=" (bench_bs_ctx main blocks)")
    row.update(config="bench_bs_ctx",
               library_note="none: no one PyTorch call gathers the slots' rows of A, dots "
               "them with their features' table rows and adds the rows back")
    print(f"slot_update on bench_bs_ctx's main blocks, the slots in case order: ms "
          f"{row['ms']:.4f}; the first version took {SLOT_UPDATE_FIRST_MS['bench_bs_ctx']} ms "
          f"(PERF.md, on an H100 80GB HBM3 at 700 W)")
    out.append(row)
    del A, A_k, A_p, GG, sys_in, tabs, SC, main_tr, main_te
    torch.cuda.empty_cache()
    return out


def run_bench_bs_ctx(args, rec, dev, counts, done, bs):
    """bench_bs_ctx: its data, its kernel checks and its four paths with
    their exact launches into `counts`: ALS 3 and MCMC 4 iterations at each
    task, every one on the resync path with no test tail. Returns the
    checks' rows and the data."""
    from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner, MCMCVectorLearner

    t0 = time.perf_counter()
    ctx = bs_ctx_data(dev, bs)
    t0 = done("bench_bs_ctx data", t0)
    table = bs_ctx_kernel_checks(args, rec, dev, ctx)
    t0 = done("bench_bs_ctx kernel checks", t0)
    rec["bench_bs_ctx"] = {key: ctx[key] for key in (
        "num_features", "blocks", "main_blocks", "main_shapes", "observed",
        "positive_share")}
    nblk, nmain = ctx["blocks"], ctx["main_blocks"]
    c_bs = dict(factors=BS_FACTORS, num_features=ctx["num_features"],
                flags=dict(expand_max_ratio=0.0))
    reg = dict(regw=5.0, regv=5.0)
    paths = (
        ("als_bs_ctx", ALSVectorLearner, 0, BS_CTX_ALS_ITERS, reg),
        ("mcmc_bs_ctx", MCMCVectorLearner, 0, BS_CTX_MCMC_ITERS, {}),
        ("als_bs_c", ALSVectorLearner, 1, BS_CTX_ALS_ITERS, reg),
        ("mcmc_bs_c", MCMCVectorLearner, 1, BS_CTX_MCMC_ITERS, {}),
    )
    for name, cls, task, iters, kw in paths:
        data = (ctx["train_c"], ctx["test_c"]) if task else (ctx["train"], ctx["test"])
        learner, counts[name] = run_learner(
            cls, name, data, args, rec, iters=iters, task=task,
            want=bs_want(iters, nblk, False, main=nmain, classify=bool(task)), **kw, **c_bs)
        if (learner.relational_mode, learner.incr_test, learner.deferred) != (
                "bs_vector", False, False):
            fail(f"{name}: routed to {learner.relational_mode}, test tail "
                 f"{learner.incr_test}, deferred path {learner.deferred}")
        hist = rec[name]["history"]
        if name == "als_bs_ctx" and not hist[-1]["train"] < hist[0]["train"]:
            fail(f"{name}: train RMSE did not fall: {[h['train'] for h in hist]}")
        if name == "mcmc_bs_ctx":
            sd_te = float(data[1].target.std())
            print(f"{name}: test_all after {iters} iterations {hist[-1]['test_all']:.6f}, "
                  f"the test targets' sd {sd_te:.6f}")
            if not hist[-1]["test_all"] < sd_te:
                fail(f"{name}: test_all {hist[-1]['test_all']} is not below the test "
                     f"targets' sd {sd_te}")
        if name == "mcmc_bs_c":
            larger = max(ctx["positive_share"], 1.0 - ctx["positive_share"])
            print(f"{name}: test accuracy after {iters} iterations "
                  f"{hist[-1]['test_all']:.6f}, the larger class's share {larger:.6f}")
            if not hist[-1]["test_all"] > larger:
                fail(f"{name}: test accuracy {hist[-1]['test_all']} is not above the "
                     f"larger class's share {larger}")
        del learner
        t0 = done(f"bench_bs_ctx {name} path", t0)
    return table, ctx



def lockstep_err(P0, w0, batches, kw, lr0, reg0):
    """An SGD epoch in which every batch's kernels and plain versions start
    from the same state (the kernels'), in the learner's form (update rows
    in the sorted order, w0 moved inside sgd_step): the largest difference,
    relative per column, of the update rows, of the table after the
    scatter (the plain scatter adds the same rows) and of the batch sums.
    Fails unless every batch's w0 equals, bit for bit, the torch line
    `sgd_w0_update(w0, lr0, red[0], red[1], reg0)` on the kernel's sums."""
    from libfm_tpu_torch.kernels import sgd_step as sg
    from libfm_tpu_torch.kernels import table_scatter as ts

    P, errs, w0_bits = P0.clone(), [], []
    w0 = w0.clone()
    for ids, vals, y, m, sids, _perm, order, run in batches:
        w0_was = w0.clone()
        u_k, r_k = sg.sgd_step(P, ids, vals, y, m, w0, order=order, lr0=lr0, reg0=reg0,
                               **kw)
        u_p, r_p = sg.sgd_step_plain(P, ids, vals, y, m, w0_was.clone(), order=order,
                                     lr0=lr0, reg0=reg0, **kw)
        P_p = ts.table_scatter_plain(P.clone(), sids, None, u_k)
        ts.table_scatter(P, sids, None, u_k, max_run=run)
        errs.append(torch.stack([
            col_rel_err(u_k, u_p), col_rel_err(P, P_p),
            ((r_k - r_p).abs() / r_p.abs().clamp_min(1.0)).max(),
        ]))
        w0_bits.append(torch.equal(w0, sg.sgd_w0_update(w0_was, lr0, r_k[0], r_k[1], reg0)))
    if not all(w0_bits):
        fail(f"sgd_step's w0 differs from the torch line on its sums in "
             f"{w0_bits.count(False)} of {len(w0_bits)} batches")
    return torch.stack(errs).max().item()


def plain_epoch(P0, w0, batches, kw, lr0, reg0, sums=None):
    """The plain versions' SGD epoch from (P0, w0), in P0's dtype: the
    learner's loop (step with the w0 line, scatter of the sorted rows)
    with sgd_step_plain and table_scatter_plain. With `sums` (a step
    function), w0 moves by the batch sums that `sums` takes on the same
    state instead. Returns (P, w0)."""
    from libfm_tpu_torch.kernels import sgd_step as sg
    from libfm_tpu_torch.kernels import table_scatter as ts

    P, w0 = P0.clone(), w0.clone()
    for ids, vals, y, m, sids, _perm, order, _run in batches:
        if sums is None:
            upd, _ = sg.sgd_step_plain(P, ids, vals, y, m, w0, order=order, lr0=lr0,
                                       reg0=reg0, **kw)
        else:
            upd, _ = sg.sgd_step_plain(P, ids, vals, y, m, w0, order=order, **kw)
            red = sums(P, ids, vals, y, m, w0, **kw)[1]
            w0 = sg.sgd_w0_update(w0, lr0, red[0], red[1], reg0)
        ts.table_scatter_plain(P, sids, None, upd)
    return P, w0


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def one_run_batch(args, dev, g, P0, E, label):
    """A batch of E update rows whose ids are all equal (one run over the
    whole batch, the scatter's longest chain) through table_scatter
    against the plain version in float64 and index_add_, on a copy of the
    table P0. The error is a summation's: the largest difference per
    column over the column's largest sum of magnitudes (|P0| + sum |upd|),
    tol 1e-5 (a sum of 65,536 random signs cancels, so the final sum is no
    scale for it; the plain version in float32, recorded beside, errs by
    more than 1e-5 itself, so the reference is the float64 sum)."""
    from libfm_tpu_torch.kernels import table_scatter as ts

    d = P0.shape[1]
    upd = torch.randn(E, d, generator=g, device=dev)
    sids = torch.full((E,), 7, dtype=torch.int32, device=dev)
    T_k, T_p = P0.clone(), P0.clone()
    ts.table_scatter(T_k, sids, None, upd, max_run=E)
    ts.table_scatter_plain(T_p, sids, None, upd)
    T_64 = ts.table_scatter_plain(P0.double(), sids, None, upd.double())
    scale = ts.table_scatter_plain(P0.abs().double(), sids, None, upd.abs().double())
    err, err32 = (((T.double() - T_64).abs().amax(dim=0) / scale.amax(dim=0)).max().item()
                  for T in (T_k, T_p))
    out = dict(entries=E, width=d, max_rel_err=err, tolerance=1e-5,
               plain_f32_rel_err=err32,
               ms=cuda_ms(lambda: ts.table_scatter(T_k, sids, None, upd, max_run=E),
                          args.reps),
               plain_ms=cuda_ms(lambda: ts.table_scatter_plain(T_p, sids, None, upd),
                                args.reps),
               library_ms=cuda_ms(lambda: T_p.index_add_(0, sids.long(), upd), args.reps))
    print(f"table_scatter, one run of {E} equal ids ({label}, W={d}): err={err:.3g} "
          f"against the plain version in float64, over the sum of magnitudes (tol "
          f"1e-05, {1e-5 / max(err, 1e-30):.3g}x the error; the plain version in "
          f"float32: {err32:.3g}) ms={out['ms']:.4f} plain_ms={out['plain_ms']:.4f} "
          f"index_add_ ms={out['library_ms']:.4f}")
    if not err <= 1e-5:
        fail(f"table_scatter on one run of {E} equal ids ({label}) disagrees with its "
             f"plain version: {err} > 1e-05")
    return out


def sgd_kernel_checks(args, rec, dev, ml, ctr):
    """Phase 3, SGD: one whole epoch, kernels against plain versions from
    the same table, at config #1 ("pair"), config #4b ("onehot") and
    #4b's data with valued entries ("general"): held batch by batch in
    lockstep, and free-running to the epoch's end, table and w0 (beside
    the plain version's own run-to-run spread, the plain epoch with the
    kernel's batch sums and the plain epoch in float64); then each kernel
    alone over an epoch's batches. Returns the rows of sgd_step and
    table_scatter (config #1's numbers, every case under "cases")."""
    import numpy as np

    from libfm_tpu_torch.data.batching import batch_dataset
    from libfm_tpu_torch.data.dataset import Dataset
    from libfm_tpu_torch.kernels import sgd_step as sg
    from libfm_tpu_torch.kernels import table_scatter as ts
    from libfm_tpu_torch.learners.sgd import (
        _epoch_mode, _packed, make_epoch_fn, sorted_scatter_order,
    )
    from libfm_tpu_torch.models.fm import FMConfig, FMParams

    valued = Dataset(ctr.indptr, ctr.cols,
                     np.random.default_rng(SEED).normal(1.0, 0.25, ctr.nnz)
                     .astype(np.float32), ctr.target, ctr.num_features)
    # the last field: whether w0 after the free-running epoch is held to
    # the plain epoch's at 1e-4. At config #1 each batch moves w0 by
    # 0.003 x a sum over 32,768 rows (98x the mean multiplier), so
    # rounding alone moves the end of the epoch's w0 by more (the plain
    # epoch against itself, index_add_'s atomics, does it too): there the
    # kernel's w0 is held to the plain epoch run with the kernel's batch
    # sums, and the float64 epoch is recorded beside it
    cases = [("config #1 pair", "sgd_1", ml, "pair", False),
             ("config #4b onehot", "sgd_4b", ctr, "onehot", True),
             ("config #4b general", "sgd_4b", valued, "general", True)]
    reps = max(3, args.reps // 3)
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = {"sgd_step": [], "table_scatter": []}
    orders = {}  # the scatter order by config: #4b's two cases share their ids
    equal_ids = {}  # the one-run batch by config
    for label, cname, ds, mode, gate_w0 in cases:
        t0 = time.perf_counter()
        c = SGD_CONFIGS[cname]
        k, d = c["k"], c["k"] + 1
        tb = batch_dataset(ds, c["batch"])
        if _epoch_mode(ds, tb.ids.shape[2]) != mode:
            fail(f"{label}: the learner would pick mode {_epoch_mode(ds, tb.ids.shape[2])}")
        if cname not in orders:
            sids_np, perm_np = sorted_scatter_order(tb.ids)
            orders[cname] = (sids_np, perm_np, ts.longest_runs(sids_np))
        sids_np, perm_np, max_runs = orders[cname]
        arrs = [torch.as_tensor(x, device=dev) for x in
                (tb.ids, tb.vals, tb.y, tb.row_mask, sids_np, perm_np)]
        nb, B, L = tb.ids.shape
        E = nb * B * L
        uniq = int(nb + np.count_nonzero(np.diff(sids_np, axis=1)))
        n = ds.num_features
        cfg = FMConfig(num_features=n, num_factors=k, regw=c["regw"], regv=c["regv"])
        params = FMParams(torch.tensor(0.1, device=dev),
                          0.01 * torch.randn(n, generator=g, device=dev),
                          0.1 * torch.randn(n, k, generator=g, device=dev))
        lrs, lims = (c["lr"],) * 3, (float(ds.min_target), float(ds.max_target))
        ep_k = make_epoch_fn(cfg, c["task"], mode)
        P0 = _packed(params)
        # each entry's sorted position, as the learner's epoch inverts perm
        perm_t = arrs[5].long()
        order = torch.empty_like(perm_t).scatter_(
            1, perm_t, torch.arange(B * L, device=dev).expand(nb, -1))
        order = order.to(torch.int32).reshape(nb, B, L)
        batches = list(zip(*(a.unbind(0) for a in arrs), order.unbind(0),
                           (int(r) for r in max_runs)))
        kw = dict(mode=mode, task=c["task"], lr1=c["lr"], lr2=c["lr"], regw=c["regw"],
                  regv=c["regv"], min_target=lims[0], max_target=lims[1])
        t1 = time.perf_counter()
        secs = {"set-up": t1 - t0}
        err = lockstep_err(P0, params.w0, batches, kw, c["lr"], cfg.reg0)

        def ep_p(P_, w0_, sums=None):
            return plain_epoch(P_, w0_, batches, kw, c["lr"], cfg.reg0, sums)

        # free-running from the same table: the kernels' epoch (the
        # learner's), the plain epoch (in a fixed order on the card since
        # table_scatter_plain sums each run in entry order), the plain epoch
        # with the kernel's batch sums, and the plain epoch in float64
        r_k = ep_k(params, *arrs, lrs, *lims, max_runs)
        P_k, w0_k = _packed(r_k), r_k.w0.item()
        P_p, w0_p = ep_p(P0, params.w0)
        w0_ks = ep_p(P0, params.w0, sums=sg.sgd_step)[1].item()
        w0_64 = ep_p(P0.double(), params.w0.double())[1].item()
        w0_p = w0_p.item()
        free = col_rel_err(P_k, P_p).item()
        w0_err, w0_sums_err = rel(w0_k, w0_p), rel(w0_k, w0_ks)
        t2 = time.perf_counter()
        secs["lockstep and free-running epochs"] = t2 - t1
        epoch_ms = cuda_ms(lambda: ep_k(params, *arrs, lrs, *lims, max_runs), reps)
        epoch_plain_ms = cuda_ms(lambda: ep_p(P0, params.w0), 1, warmup=0)
        print(f"SGD epoch, {label}: {nb} batches of {B}x{L}; kernels against plain "
              f"in lockstep (every batch from the same state): {err:.3g} (tol 1e-4, "
              f"relative per column); free-running after one epoch: table, kernels "
              f"against plain {free:.3g} (tol 1e-4); w0 kernels {w0_k!r}, plain "
              f"{w0_p!r}, "
              f"plain with the kernel's sums {w0_ks!r}, plain float64 {w0_64!r}; "
              f"w0 kernels against plain {w0_err:.3g} "
              f"({'tol 1e-4' if gate_w0 else 'recorded'}), against plain with the "
              f"kernel's sums {w0_sums_err:.3g} (tol 1e-4); "
              f"epoch ms {epoch_ms:.3f}, plain {epoch_plain_ms:.3f}")
        if not max(err, free, w0_sums_err, w0_err if gate_w0 else 0.0) <= 1e-4:
            fail(f"SGD epoch at {label}: kernels and plain versions differ by "
                 f"{err} (lockstep), {free} (free-running table), {w0_err} "
                 f"(w0), {w0_sums_err} (w0 against the plain epoch with the "
                 f"kernel's sums)")
        # each kernel alone over the epoch's batches, from the initial table,
        # in the learner's form: sgd_step writes the rows in the sorted
        # order and moves w0, table_scatter reads them in order, buffers and
        # scratch allocated once (the entry-order form through perm lost:
        # PERF.md)
        w0_t = params.w0.clone()
        bufs = dict(upd=torch.empty(B * L, d, device=dev), red=torch.empty(2, device=dev),
                    scratch=sg.sgd_step_scratch(dev))

        def steps(fn):
            return lambda: [fn(P0, i, v, y, m, w0_t, order=o, lr0=c["lr"], reg0=cfg.reg0,
                               **bufs, **kw)
                            for i, v, y, m, _, _, o, _ in batches]

        upds = [sg.sgd_step(P0, i, v, y, m, params.w0, order=o, **kw)[0]
                for i, v, y, m, _, _, o, _ in batches]
        P_s = P0.clone()
        sids_l = [b[4].long() for b in batches]
        sc_ts = ts.ScatterScratch(B * L, d, dev)

        def scatters(fn):
            return lambda: [fn(P_s, b[4], None, u, scratch=sc_ts, max_run=b[7])
                            for b, u in zip(batches, upds)]

        def library():  # the same sorted rows at the same sorted ids
            for f, u in zip(sids_l, upds):
                P_s.index_add_(0, f, u)

        timed = f"one epoch's launches ({nb}), {label}"
        row = kernel_row(
            "sgd_step", "libfm_tpu/learners/sgd.py:128", err, 1e-4,
            cuda_ms(steps(sg.sgd_step), reps),
            cuda_ms(steps(sg.sgd_step_plain), 1, warmup=0),
            nbytes=E * 4 * (3 if mode == "general" else 2) + nb * B * 5
            + uniq * d * 4 + E * d * 4 + nb * 8,
            flops=E * 10 * d, lib_ms=None, timed=timed, label=f" ({label})")
        row["also_replaces"] = ["libfm_tpu/learners/sgd.py:160"]
        rows["sgd_step"].append(row)
        row = kernel_row(
            "table_scatter", "studies/probes/pallas_scatter.py:35", err, 1e-4,
            cuda_ms(scatters(ts.table_scatter), reps),
            cuda_ms(scatters(ts.table_scatter_plain), 1, warmup=0),
            nbytes=E * 4 + E * d * 4 + uniq * d * 8, flops=E * d,
            lib_ms=cuda_ms(library, reps), timed=timed,
            label=f" ({label})")
        row["longest_runs"] = dict(min=int(max_runs.min()), median=float(np.median(max_runs)),
                                   max=int(max_runs.max()),
                                   over_long_run=int((max_runs > ts.LONG_RUN).sum()))
        print(f"{label}: each batch's longest run of equal ids {row['longest_runs']} "
              f"(at W <= 16 the batches with one over {ts.LONG_RUN} take the long form)")
        row["also_replaces"] = ["studies/pallas_gather.py:112",
                                "libfm_tpu/learners/sgd.py:157,212"]
        rows["table_scatter"].append(row)
        if cname not in equal_ids:
            equal_ids[cname] = one_run_batch(args, dev, g, P0, B * L, label)
        rec.setdefault("sgd_epoch", {})[label] = dict(
            kernels_ms=epoch_ms, plain_ms=epoch_plain_ms, batches=nb, entries=E,
            unique_rows=uniq, lockstep_err=err, free_running_err=free,
            w0_kernels=w0_k, w0_plain=w0_p,
            w0_plain_kernel_sums=w0_ks, w0_plain_f64=w0_64, w0_err=w0_err,
            w0_err_gated=gate_w0, w0_kernel_sums_err=w0_sums_err)
        secs["timing"] = time.perf_counter() - t2
        rec["sgd_epoch"][label]["check_seconds"] = secs
        print(f"SGD check seconds, {label}: {secs}")
        del upds, P_s, arrs, batches, sids_l, order, perm_t, bufs
        torch.cuda.empty_cache()
    rec["one_run_batch"] = equal_ids
    out = []
    for name, rs in rows.items():
        main_row = dict(rs[0])
        main_row["cases"] = {r["timed"]: {key: r[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "longest_runs") if key in r}
            for r in rs}
        if name == "table_scatter":
            main_row["one_run_batch"] = equal_ids
        out.append(main_row)
    return out


def sgda_data(ml, ctr):
    """SGDA's runs: name -> (train, test, validation, groups), at config
    #1 (the ML data; users group 0, items group 1) and #4b (the CTR data,
    its 13 field groups)."""
    import numpy as np

    ml_groups = (np.arange(ml[0].num_features) >= USERS).astype(np.int32)
    out = {}
    for name, (train, test, groups) in (("sgda_1", (ml[0], ml[1], ml_groups)),
                                        ("sgda_4b", ctr)):
        trn, val = train.holdout(HOLDOUT_SEED)
        out[name] = (trn, test, val, groups)
        print(f"{name}: {trn.num_rows} train, {val.num_rows} validation, {test.num_rows} "
              f"test rows; {int(groups.max()) + 1} groups")
    return out


def max_step_err(got, want, was):
    """The regularizers after a lambda step against the plain version's:
    the largest |got - want| beyond two ulps of want (both round
    was + step to f32, and at #4b's lr of 1e-4 a step is ~1e-6 of a
    value ~0.02 whose ulp is ~2e-9), over the largest step |want - was|."""
    ulp = torch.nextafter(want.abs(), torch.full_like(want, math.inf)) - want.abs()
    excess = ((got - want).abs() - 2 * ulp).clamp_min(0)
    return (excess.max() / (want - was).abs().max().clamp_min(1e-12)).item()


def sgda_kernel_checks(args, rec, dev, runs):
    """Phase 3, SGDA: one whole epoch in the form of the second and later
    epochs (lambda steps on), kernels against plain versions from the same
    table, caches and regularizers, at config #1 ("pair"), config #4b
    ("onehot") and #4b's data with values from N(1, 0.25) ("general"): in
    lockstep batch by batch (w0 bitwise against `w0_update` on the
    kernel's sum) and free-running to the epoch's end; then each kernel
    alone over an epoch's launches. Returns the rows of sgda_step and
    sgda_lambda (config #1's numbers, every case under "cases")."""
    import numpy as np

    from libfm_tpu_torch.data.batching import batch_dataset
    from libfm_tpu_torch.data.dataset import Dataset
    from libfm_tpu_torch.kernels import sgda_lambda as sl
    from libfm_tpu_torch.kernels import sgda_step as sa
    from libfm_tpu_torch.kernels import table_scatter as ts
    from libfm_tpu_torch.learners.sgd import _epoch_mode
    from libfm_tpu_torch.learners.sgda import make_epoch_fn, sgda_batches
    from libfm_tpu_torch.models.fm import FMConfig

    trn4, _, val4, groups4 = runs["sgda_4b"]
    rng = np.random.default_rng(SEED)

    def valued(ds):
        return Dataset(ds.indptr, ds.cols, rng.normal(1.0, 0.25, ds.nnz).astype(np.float32),
                       ds.target, ds.num_features, ds.min_target, ds.max_target)

    trn1, _, val1, groups1 = runs["sgda_1"]
    cases = [("config #1 pair", "sgda_1", trn1, val1, groups1, "pair"),
             ("config #4b onehot", "sgda_4b", trn4, val4, groups4, "onehot"),
             ("config #4b general", "sgda_4b", valued(trn4), valued(val4), groups4,
              "general")]
    reps = max(3, args.reps // 3)
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = {"sgda_step": [], "sgda_lambda": []}
    for label, cname, trn, val, groups, mode in cases:
        t0 = time.perf_counter()
        c = SGD_CONFIGS[SGDA_CONFIGS[cname]]
        k, d, lr, task = c["k"], c["k"] + 1, c["lr"], c["task"]
        n, G = trn.num_features, int(groups.max()) + 1
        tb, vb = batch_dataset(trn, c["batch"]), batch_dataset(val, c["batch"])
        modes = (_epoch_mode(trn, tb.ids.shape[2]), _epoch_mode(val, vb.ids.shape[2]))
        if modes != (mode, mode):
            fail(f"SGDA {label}: the learner would pick modes {modes}")
        tr = sgda_batches(tb, n, dev)
        va = [torch.as_tensor(x, device=dev) for x in (vb.ids, vb.vals, vb.y, vb.row_mask)]
        attr = torch.as_tensor(groups, device=dev)
        nb, B, L = tr.ids.shape
        nv = vb.ids.shape[0]
        lims = dict(task=task, lr=lr, min_target=float(trn.min_target),
                    max_target=float(trn.max_target))
        # the state: a table and w0 as the SGD check's, caches ~N(0, 0.01^2),
        # regularizers in [0, 0.02)
        P0 = torch.cat([0.01 * torch.randn(n, 1, generator=g, device=dev),
                        0.1 * torch.randn(n, k, generator=g, device=dev)], 1)
        Gc0 = 0.01 * torch.randn(n + 1, d, generator=g, device=dev)
        rw0 = 0.02 * torch.rand(G, generator=g, device=dev)
        rv0 = 0.02 * torch.rand(G, k, generator=g, device=dev)
        w00 = torch.tensor(0.1, device=dev)
        batches = list(zip(*(a.unbind(0) for a in (*tr.arrays, tr.order, tr.gc_row)),
                           (s[:m] for s, m in zip(tr.sids.unbind(0), tr.n_real)),
                           tr.n_real, tr.max_runs))
        vbatches = list(zip(*(a.unbind(0) for a in va)))
        t1 = time.perf_counter()
        secs = {"set-up": t1 - t0}

        # lockstep: each batch's kernels and plain versions from the kernels' state
        P, Gc, w0, rw, rv = P0.clone(), Gc0.clone(), w00.clone(), rw0.clone(), rv0.clone()
        errs, reg_errs, w0_bits = [], [], []
        for i, (ids, vals, y, m, order, gc_row, sids, nr, run) in enumerate(batches):
            w0_was, Gc_p = w0.clone(), Gc.clone()
            u_k, r_k = sa.sgda_step(P, ids, vals, y, m, w0, Gc, gc_row, attr, rw, rv,
                                    mode=mode, order=order, **lims)
            u_p, r_p = sa.sgda_step_plain(P, ids, vals, y, m, w0_was.clone(), Gc_p, gc_row,
                                          attr, rw, rv, mode=mode, order=order, **lims)
            P_p = ts.table_scatter_plain(P.clone(), sids, None, u_k[:nr])
            ts.table_scatter(P, sids, None, u_k[:nr], max_run=run)
            errs.append(torch.stack([
                col_rel_err(u_k[:nr], u_p[:nr]), col_rel_err(P, P_p),
                col_rel_err(Gc[:n], Gc_p[:n]),
                ((r_k - r_p).abs() / r_p.abs().clamp_min(1.0)).max()]))
            w0_bits.append(torch.equal(w0, sa.w0_update(w0_was, lr, r_k[0])))
            rw_was, rv_was = rw.clone(), rv.clone()
            rw_p, rv_p = rw.clone(), rv.clone()
            sl.sgda_lambda(P, Gc, *vbatches[i % nv], w0, attr, rw, rv, mode=mode, **lims)
            sl.sgda_lambda_plain(P, Gc, *vbatches[i % nv], w0, attr, rw_p, rv_p, mode=mode,
                                 **lims)
            reg_errs.append(max(max_step_err(rw, rw_p, rw_was),
                                max_step_err(rv, rv_p, rv_was)))
        err = torch.stack(errs).max().item()
        reg_err = max(reg_errs)
        if not all(w0_bits):
            fail(f"SGDA {label}: sgda_step's w0 differs from w0_update on its sum in "
                 f"{w0_bits.count(False)} of {len(w0_bits)} batches")
        lock_regs = (rw.clone(), rv.clone())

        # the first batch twice from the same state: the same bits (rows,
        # cache rows, sum, w0); the digest of the rows and cache rows is
        # what an earlier commit's kernel is held to
        ids, vals, y, m, order, gc_row, _, nr, _ = batches[0]
        runs_1 = []
        for _ in range(2):
            Gc_r, w0_r = Gc0.clone(), w00.clone()
            u_r, r_r = sa.sgda_step(P0, ids, vals, y, m, w0_r, Gc_r, gc_row, attr, rw0, rv0,
                                    mode=mode, order=order, **lims)
            runs_1.append((u_r[:nr].clone(), Gc_r, r_r.clone(), w0_r))
        torch.cuda.synchronize()
        repeat_check(f"sgda_step rows and cache rows, {label}, batch 0", runs_1[0][:2],
                     runs_1[1][:2], rec)
        repeat_check(f"sgda_step sum and w0, {label}, batch 0", runs_1[0][2:], runs_1[1][2:],
                     rec)
        del runs_1

        # free-running from the same state: the learner's epoch (kernels)
        # and the plain versions' epoch
        cfg = FMConfig(num_features=n, num_factors=k)
        epoch = make_epoch_fn(cfg, task, mode, mode)
        ends = {}
        for side in ("kernels", "plain"):
            S = [P0.clone(), w00.clone(), Gc0.clone(), rw0.clone(), rv0.clone()]
            if side == "kernels":
                epoch(*S, attr, tr, va, lr, lims["min_target"], lims["max_target"])
            else:
                P_, w0_, Gc_, rw_, rv_ = S
                for i, (ids, vals, y, m, order, gc_row, sids, nr, _) in enumerate(batches):
                    upd, _ = sa.sgda_step_plain(P_, ids, vals, y, m, w0_, Gc_, gc_row, attr,
                                                rw_, rv_, mode=mode, order=order, **lims)
                    ts.table_scatter_plain(P_, sids, None, upd[:nr])
                    sl.sgda_lambda_plain(P_, Gc_, *vbatches[i % nv], w0_, attr, rw_, rv_,
                                         mode=mode, **lims)
            ends[side] = S
        (Pk, w0k, Gck, rwk, rvk), (Pp, w0p, Gcp, rwp, rvp) = ends["kernels"], ends["plain"]
        free = dict(table=col_rel_err(Pk, Pp).item(), caches=col_rel_err(Gck[:n], Gcp[:n]).item(),
                    reg_w=((rwk - rwp).abs().max() / rwp.abs().max().clamp_min(1e-30)).item(),
                    reg_v=((rvk - rvp).abs().max() / rvp.abs().max().clamp_min(1e-30)).item(),
                    w0_kernels=w0k.item(), w0_plain=w0p.item())
        t2 = time.perf_counter()
        secs["lockstep and free-running epochs"] = t2 - t1
        print(f"SGDA epoch, {label}: {nb} batches of {B}x{L}, {nv} validation batches, G={G}; "
              f"kernels against plain in lockstep: rows, table, caches, sums {err:.3g} (tol "
              f"{SGDA_TOL:g}, relative per column), regularizers {reg_err:.3g} of the plain "
              f"step beyond 2 ulps (tol {SGDA_REG_TOL:g}), w0 bitwise on the kernel's sums; free-running "
              f"after one epoch: {free} (tol table and caches {SGDA_TOL:g}, regularizers "
              f"{SGDA_REG_TOL:g}; w0 recorded)")
        if not (err <= SGDA_TOL and reg_err <= SGDA_REG_TOL and free["table"] <= SGDA_TOL
                and free["caches"] <= SGDA_TOL and free["reg_w"] <= SGDA_REG_TOL
                and free["reg_v"] <= SGDA_REG_TOL):
            fail(f"SGDA epoch at {label}: kernels and plain versions differ: lockstep "
                 f"{err}, regularizers {reg_err}, free-running {free}")
        if not (torch.isfinite(lock_regs[1]).all() and (lock_regs[1] >= 0).all()):
            fail(f"SGDA {label}: regularizers non-finite or negative")

        # each kernel alone over the epoch's launches, in the learner's form
        bufs = dict(upd=torch.empty(B * L, d, device=dev), red=torch.empty(1, device=dev),
                    scratch=sa.sgda_step_scratch(dev))
        Gc_t, w0_t = Gc0.clone(), w00.clone()
        lam_s = sl.sgda_lambda_scratch(G, k, dev)
        rw_t, rv_t = rw0.clone(), rv0.clone()

        def steps(fn):
            return lambda: [fn(P0, i_, v_, y_, m_, w0_t, Gc_t, gr_, attr, rw0, rv0, mode=mode,
                               order=o_, **bufs, **lims)
                            for i_, v_, y_, m_, o_, gr_, *_ in batches]

        def lambdas(fn):
            return lambda: [fn(P0, Gc0, *vbatches[i % nv], w00, attr, rw_t, rv_t, mode=mode,
                               **({"scratch": lam_s} if fn is sl.sgda_lambda else {}), **lims)
                            for i in range(nb)]

        E = nb * B * L
        ids_np = tb.ids.reshape(nb, -1)
        uniq = int(sum(np.unique(r).size for r in ids_np))
        writers = int((tr.gc_row < n).sum().item())
        vids = vb.ids.reshape(nv, -1)
        v_uniq = [np.unique(r).size for r in vids]
        uniq_v = int(sum(v_uniq[i % nv] for i in range(nb)))
        Ev = nb * vb.ids.shape[1] * vb.ids.shape[2]
        valued_mode = mode == "general"
        timed = f"one epoch's launches ({nb}), {label}"
        row = kernel_row(
            "sgda_step", "libfm_tpu/learners/sgda.py:70", err, SGDA_TOL,
            cuda_ms(steps(sa.sgda_step), reps), cuda_ms(steps(sa.sgda_step_plain), 1, warmup=0),
            # ids, order, gc_row (and values) an entry; y and the mask a row;
            # each touched table row and its group id; the update rows; the
            # cache rows written; the regularizers, w0 and the sum a batch
            nbytes=E * (12 + 4 * valued_mode) + nb * B * 5 + uniq * (d * 4 + 4)
            + E * d * 4 + writers * d * 4 + nb * (G * d * 4 + 12),
            flops=E * 12 * d, lib_ms=None, timed=timed, label=f" ({label})")
        row["library_ms_none_because"] = ("no one PyTorch call gathers, predicts and forms "
                                          "the update and cache rows")
        rows["sgda_step"].append(row)
        row = kernel_row(
            "sgda_lambda", "libfm_tpu/learners/sgda.py:109", reg_err, SGDA_REG_TOL,
            cuda_ms(lambdas(sl.sgda_lambda), reps),
            cuda_ms(lambdas(sl.sgda_lambda_plain), 1, warmup=0),
            # ids (and values) an entry; y and the mask a row; each touched
            # row of P and of Gc and its group id; the regularizers read and
            # written, w0
            nbytes=Ev * (4 + 4 * valued_mode) + nb * vb.ids.shape[1] * 5
            + uniq_v * (2 * d * 4 + 4) + nb * (2 * G * d * 4 + 4),
            flops=Ev * 20 * d, lib_ms=None, timed=timed, label=f" ({label})")
        row["library_ms_none_because"] = ("no one PyTorch call looks ahead, predicts and "
                                          "reduces per group")
        rows["sgda_lambda"].append(row)
        rec.setdefault("sgda_epoch", {})[label] = dict(
            batches=nb, validation_batches=nv, groups=G, entries=E, unique_rows=uniq,
            cache_writers=writers, lockstep_err=err, lockstep_reg_err=reg_err,
            free_running=free, check_seconds=dict(secs, timing=time.perf_counter() - t2))
        print(f"SGDA check seconds, {label}: {rec['sgda_epoch'][label]['check_seconds']}")
        del tr, va, batches, vbatches, bufs, P, Gc, P_p, Gc_p, ends
        torch.cuda.empty_cache()
    out = []
    for name, rs in rows.items():
        main_row = dict(rs[0])
        main_row["cases"] = {r["timed"]: {key: r[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for r in rs}
        out.append(main_row)
    return out


def run_sgda(name, runs, args, rec):
    """Path phase: SGDALearner for SGDA_EPOCHS epochs at one config. Its
    batch loop must launch sgda_step and table_scatter once a batch and,
    from the second epoch, sgda_lambda once a batch; besides them only
    fm_refresh (three evaluations an epoch)."""
    from libfm_tpu_torch import kernels
    from libfm_tpu_torch.data.batching import batch_dataset
    from libfm_tpu_torch.learners.sgda import SGDALearner
    from libfm_tpu_torch.models.fm import FMConfig

    c = SGD_CONFIGS[SGDA_CONFIGS[name]]
    train, test, val, groups = runs[name]
    cfg = FMConfig(num_features=train.num_features, num_factors=c["k"])
    learner = SGDALearner(cfg, attr_group=groups, task=c["task"], num_iter=SGDA_EPOCHS,
                          learn_rate=c["lr"], batch_size=c["batch"], seed=SEED)
    nb = batch_dataset(train, c["batch"]).num_batches
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    t0 = time.perf_counter()
    hist = learner.learn(train, test, val)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if prof is not None:
        prof.stop()
        profile_summary(prof, args.profile, rec, name, batches=nb)
    secs = [h[3] for h in hist]
    regs = (learner.reg_w.cpu(), learner.reg_v.cpu())
    rec[name] = dict(history=hist, launches=counts, learn_seconds=wall,
                     setup_seconds=wall - sum(secs), batches=nb,
                     reg_w=regs[0].tolist(), reg_v=regs[1].tolist(),
                     peak_mem_bytes=torch.cuda.max_memory_allocated())
    print(f"{name}: {nb} batches; launches {counts}; learn() {wall:.2f} s, of which set-up "
          f"and evaluation {wall - sum(secs):.2f} s; per-epoch s {secs}")
    for it, (tr, te, vl, s) in enumerate(hist):
        print(f"{name} epoch {it}: train {tr:.6g}, test {te:.6g}, validation {vl:.6g}, "
              f"{s:.4f} s")
    print(f"{name} final regularizers: reg_w {[round(x, 6) for x in regs[0].tolist()]}, "
          f"reg_v by group (mean, max) "
          f"{[(round(r.mean().item(), 6), round(r.max().item(), 6)) for r in regs[1]]}")
    check_launches(name, counts)
    want = dict(sgda_step=nb * SGDA_EPOCHS, table_scatter=nb * SGDA_EPOCHS,
                sgda_lambda=nb * (SGDA_EPOCHS - 1), fm_refresh=3 * SGDA_EPOCHS)
    wrong = {key: (v, want.get(key, 0)) for key, v in counts.items() if v != want.get(key, 0)}
    if wrong:
        fail(f"{name}: launches (made, expected) {wrong}")
    for it, h in enumerate(hist):
        if not all(math.isfinite(x) for x in h[:3]):
            fail(f"{name}: non-finite metric at epoch {it}: {h}")
    for r in regs:
        if not (torch.isfinite(r).all() and (r >= 0).all()):
            fail(f"{name}: a regularizer is non-finite or negative: {r}")
    return counts


def table_checks(args, rec, dev, scatter_row):
    """Phase 3, the probes' shapes: table_scatter at P4's (against
    index_add_, added to the table_scatter row under "p4"), table_read at
    P1's (scale 8) and P3's (scale 1) on the shared form of its plan
    ("p3" in the row), and at P3's ids on a table past a one-column
    slice, on the l2 form ("tall"): each within 1e-5 of the plain version
    and the same bits on a second call. Returns the table_read row."""
    from libfm_tpu_torch.kernels import table_read as tr
    from libfm_tpu_torch.kernels import table_scatter as ts
    from libfm_tpu_torch.studies import pallas_gather as pg
    from libfm_tpu_torch.studies import pallas_scatter as ps

    g = torch.Generator(device=dev).manual_seed(SEED)
    ids = torch.randint(0, ps.N, (ps.E,), generator=g, device=dev, dtype=torch.int32)
    upd = torch.randn(ps.E, ps.W, generator=g, device=dev)
    sids, perm = ps.sorted_order(ids)
    run = int(ts.longest_runs(sids))
    T_k = torch.zeros(ps.N, ps.W, device=dev)
    T_p = torch.zeros(ps.N, ps.W, device=dev)
    ts.table_scatter(T_k, sids, perm, upd, max_run=run)
    ts.table_scatter_plain(T_p, sids, perm, upd)
    err = (T_k - T_p).abs().max().item()
    uniq = int(torch.unique(ids).numel())
    p4 = kernel_row(
        "table_scatter", "studies/probes/pallas_scatter.py:35", err, 1e-5,
        cuda_ms(lambda: ts.table_scatter(T_k, sids, perm, upd, max_run=run), args.reps),
        cuda_ms(lambda: ts.table_scatter_plain(T_p, sids, perm, upd), args.reps),
        nbytes=ps.E * 8 + ps.E * ps.W * 4 + uniq * ps.W * 8, flops=ps.E * ps.W,
        lib_ms=cuda_ms(lambda: T_p.index_add_(0, ids.long(), upd), args.reps),
        timed="one launch at P4's shape (E=65536, W=16)", label=" (P4)")
    scatter_row["p4"] = {key: p4[key] for key in (
        "max_abs_err", "tolerance", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "timed")}

    T = torch.randn(pg.NSUB, 128, generator=g, device=dev)
    ids = torch.randint(0, pg.NSUB, (pg.NIDS,), generator=g, device=dev,
                        dtype=torch.int32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for probe, scale, n_used, site, nsub in (
        ("P1", float(pg.UNROLL), pg.NIDS // pg.UNROLL * pg.UNROLL,
         "studies/pallas_gather.py:79", pg.NSUB),
        ("P3", 1.0, pg.NIDS // pg.CHUNK * pg.CHUNK, "studies/pallas_gather.py:147", pg.NSUB),
        ("P3's ids, a table of 65,536 rows", 1.0, pg.NIDS // pg.CHUNK * pg.CHUNK,
         "studies/pallas_gather.py:147", TALL_NSUB),
    ):
        if nsub == TALL_NSUB:
            T = torch.randn(nsub, 128, generator=g, device=dev)
        plan = tr.read_plan(nsub, 128, n_used, pg.REPS, sms)
        if (plan.form == "l2") != (nsub == TALL_NSUB):
            fail(f"table_read at {probe}: plan {plan}")
        o_k = tr.table_read(T, ids, pg.REPS, scale, n_used)
        o_p = tr.table_read_plain(T, ids, pg.REPS, scale, n_used)
        again = tr.table_read(T, ids, pg.REPS, scale, n_used)
        if not torch.equal(o_k, again):
            fail(f"table_read at {probe}: two calls differ")
        err = ((o_k - o_p).abs().max() / o_p.abs().max()).item()
        row = kernel_row(
            "table_read", site, err, 1e-5,
            cuda_ms(lambda: tr.table_read(T, ids, pg.REPS, scale, n_used), args.reps),
            cuda_ms(lambda: tr.table_read_plain(T, ids, pg.REPS, scale, n_used),
                    args.reps),
            nbytes=nsub * 128 * 4 + n_used * 4 + 128 * 4,
            flops=pg.REPS * n_used * 128, lib_ms=None,
            timed=f"one call at {probe}'s shape ({pg.REPS} reps of {n_used} ids, "
                  f"{nsub} rows, scale {scale:g}); error relative to the largest lane",
            label=f" ({probe})")
        row["plan"] = dataclasses.asdict(plan)
        first_ms = TABLE_READ_FIRST_MS.get(probe)
        first = (f"first version {first_ms} ms, PERF.md, on an H100 80GB HBM3 at 700 W"
                 if first_ms else "no first version at this shape")
        print(f"table_read ({probe}): plan {pg.plan_text(row['plan'])}; {row['ms']:.4f} ms"
              f" ({first}), bound {row['bound_ms']:.4f} ms (HBM bytes), shared-memory floor "
              f"{pg.smem_floor_ms(pg.REPS, n_used, 128, dev.index or 0)} ms (the lookups' "
              f"bytes at {pg.SMEM_BYTES_PER_CLOCK} B a clock an SM at the card's clock; not "
              f"a bound of the row, not measured); two calls the same bits")
        rows.append(row)
    keys = ("replaces", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "timed",
            "plan")
    read_row = dict(rows[0])
    read_row["p3"] = {key: rows[1][key] for key in keys}
    read_row["tall"] = {key: rows[2][key] for key in keys}
    return read_row


def check_launches(name, counts):
    """Fails unless the run launched each kernel of its path and no other."""
    for kname in sorted(EXPECTED[name]):
        if counts.get(kname, 0) <= 0:
            fail(f"{name}: kernel {kname} was not launched on the path")
    others = {kname: c for kname, c in counts.items() if c and kname not in EXPECTED[name]}
    if others:
        fail(f"{name}: launched kernels outside its path: {others}")


def run_sgd(name, data, args, rec):
    """Path phase: SGDLearner for SGD_EPOCHS epochs at one config."""
    from libfm_tpu_torch import kernels
    from libfm_tpu_torch.learners.sgd import SGDLearner
    from libfm_tpu_torch.models.fm import FMConfig

    c = SGD_CONFIGS[name]
    train, test = data
    cfg = FMConfig(num_features=train.num_features, num_factors=c["k"],
                   regw=c["regw"], regv=c["regv"])
    learner = SGDLearner(cfg, task=c["task"], num_iter=SGD_EPOCHS,
                         learn_rate=c["lr"], batch_size=c["batch"], seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    t0 = time.perf_counter()
    hist = learner.learn(train, test)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if prof is not None:
        prof.stop()
        profile_summary(prof, args.profile, rec, name,
                        batches=counts["sgd_step"] // SGD_EPOCHS)
    secs = [h[2] for h in hist]
    rec[name] = dict(history=hist, launches=counts, learn_seconds=wall,
                     setup_seconds=wall - sum(secs),
                     peak_mem_bytes=torch.cuda.max_memory_allocated())
    print(f"{name}: launches {counts}; learn() {wall:.2f} s, of which set-up and "
          f"evaluation {wall - sum(secs):.2f} s; per-epoch s {secs}")
    check_launches(name, counts)
    for it, (tr, te, _) in enumerate(hist):
        if not (math.isfinite(tr) and math.isfinite(te)):
            fail(f"{name}: non-finite metric at epoch {it}: {tr}, {te}")
    return counts


def run_probes(rec):
    """Probe phase: the ported table probes at the studies' shapes."""
    from libfm_tpu_torch import kernels
    from libfm_tpu_torch.studies import pallas_gather, pallas_scatter

    kernels.reset_launch_counts()
    try:
        print("probes (libfm_tpu_torch/studies/pallas_gather.py):")
        gather = pallas_gather.main()
        print("probe (libfm_tpu_torch/studies/pallas_scatter.py):")
        scatter = pallas_scatter.main()
    except AssertionError as e:
        fail(f"probes: {e}")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    rec["probes"] = dict(gather=gather, scatter=scatter, launches=counts)
    check_launches("probes", counts)
    return counts


# the device names of the SGD and SGDA batch loops' kernels
BATCH_KERNELS = ("sgd_step_kernel", "scatter_narrow", "scatter_wide", "sgda_step_kernel",
                 "sgda_lambda_kernel")


def profile_summary(prof, out_dir, rec, name, batches=None):
    """From a torch.profiler run of learner `name`: per iteration or
    epoch (the learners' "iteration N" / "epoch N" ranges) the wall time,
    the device-busy time (union of the device activities inside the
    range), the kernel launches the host made in it (its cudaLaunchKernel
    calls) and the device time by name; for the first one also its
    longest host events. For an SGD or SGDA run (`batches` a epoch) also
    the device activities an epoch, the batch loop's kernels a batch, and
    the torch ops an epoch with those run at least once a batch. Writes
    DIR/trace_<name>.json."""
    from torch.autograd import DeviceType

    ranges = ("iteration ", "epoch ")
    evs = prof.events()
    iters = sorted(
        (e for e in evs if e.device_type == DeviceType.CPU
         and e.name.startswith(ranges)),
        key=lambda e: e.time_range.start,
    )
    on_dev = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in evs
        if e.device_type == DeviceType.CUDA and not e.name.startswith(ranges)
    )
    rows = []
    for ev in iters:
        lo, hi = ev.time_range.start, ev.time_range.end
        busy, cur, by_name = 0.0, lo, {}
        for s, t, nm in on_dev:
            s, t = max(s, lo), min(t, hi)
            if t <= s:
                continue
            by_name[nm[:60]] = by_name.get(nm[:60], 0.0) + (t - s) / 1e3
            if t > cur:
                busy += t - max(s, cur)
                cur = t
        wall = (hi - lo) / 1e3
        launches = sum(1 for e in evs if e.device_type == DeviceType.CPU
                       and e.name.startswith("cudaLaunchKernel")
                       and lo <= e.time_range.start and e.time_range.end <= hi)
        row = dict(name=ev.name, wall_ms=wall, device_busy_ms=busy / 1e3,
                   idle_share=1.0 - busy / 1e3 / wall, launches=launches,
                   device_ms_by_name=dict(sorted(by_name.items(),
                                                 key=lambda kv: -kv[1])[:10]))
        if batches:
            inside = [nm for s, t, nm in on_dev if lo <= s and t <= hi]
            loop = sum(1 for nm in inside if any(b in nm for b in BATCH_KERNELS))
            ops = {}
            for e in evs:
                if (e.device_type == DeviceType.CPU and e.name.startswith("aten::")
                        and lo <= e.time_range.start and e.time_range.end <= hi):
                    ops[e.name] = ops.get(e.name, 0) + 1
            row.update(batches=batches, device_activities=len(inside),
                       batch_loop_kernels=loop, kernels_a_batch=loop / batches,
                       other_device_activities=len(inside) - loop, torch_ops=ops,
                       torch_ops_once_a_batch_or_more={
                           k: v for k, v in ops.items() if v >= batches})
            print(f"profile {name} {ev.name}: {batches} batches, {loop} launches of the "
                  f"batch loop's kernels ({loop / batches:g} a batch), "
                  f"{len(inside) - loop} other device activities; torch ops {ops}")
        rows.append(row)
        print(f"profile {name} {ev.name}: wall {wall:.3f} ms, device busy "
              f"{row['device_busy_ms']:.3f} ms, idle share {row['idle_share']:.4f}, "
              f"{launches} kernel launches")
        for nm, ms in list(row["device_ms_by_name"].items())[:8]:
            print(f"    {ms:9.3f} ms  {nm}")
    if iters:
        lo, hi = iters[0].time_range.start, iters[0].time_range.end
        host = sorted(
            ((e.time_range.end - e.time_range.start) / 1e3, e.name) for e in evs
            if e.device_type == DeviceType.CPU and e is not iters[0]
            and lo <= e.time_range.start and e.time_range.end <= hi
        )[::-1][:8]
        rows[0]["longest_host_events_ms"] = host
        print(f"profile {name} {iters[0].name}: longest host events (ms): {host}")
    rec.setdefault("profile", {})[name] = rows
    prof.export_chrome_trace(f"{out_dir}/trace_{name}.json")


def fast_launches(rec, name, iters, refresh_every):
    """Print a traced probit run's kernel launches at each iteration
    without a refresh, and which of its iterations follow a fast step
    (probit_latent) and so take its residual sums for alpha and w0."""
    from libfm_tpu_torch.learners.mcmc import dispatch_chunks

    refreshes = {i0 + L - 1 for i0, L in dispatch_chunks(0, iters, refresh_every)}
    by_it = {int(r["name"].split()[1]): r["launches"] for r in rec["profile"][name]}
    fast = {it: n for it, n in by_it.items() if it not in refreshes}
    carried = [it for it in by_it if it > 0 and it - 1 not in refreshes]
    rec["profile"][name + "_fast"] = dict(launches_by_non_refresh_iteration=fast,
                                          iterations_with_carried_sums=carried)
    print(f"profile {name}: kernel launches by non-refresh iteration {fast}; iterations "
          f"that take probit_latent's sums (after a fast step) {carried}")


def run_learner(cls, name, data, args, rec, factors=FACTORS, iters=None, groups=None,
                task=0, per_iter=None, want=None, num_features=None, flags=None,
                learner_kw=None, extra_want=None, exact=True, **cfg_kw):
    """Path phase: one learner run. `per_iter` gives the launches each
    iteration must make of slot_stats, case_stats, schur_draw, dual_draw
    and slot_update (2 slot_stats and schur_draw launches, no other, when
    None: config #3), and of any other kernel it names; a probit run also
    makes the refreshes' probit launches. `extra_want` adds the run's
    launches of other kernels; `want` gives the run's launches instead
    (the BS engine's runs); `exact=False` checks only that the run
    launched its path's kernels and no other. `num_features` is the
    model's width where the main table is narrower (relational data);
    `learner_kw` constructor options; `flags` learner attributes to
    set."""
    from libfm_tpu_torch import kernels
    from libfm_tpu_torch.learners.mcmc import dispatch_chunks
    from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner
    from libfm_tpu_torch.models.fm import FMConfig

    train, test = data[:2]
    cfg = FMConfig(num_features=num_features or train.num_features, num_factors=factors,
                   **cfg_kw)
    if iters is None:
        iters = ALS_ITERS if name == "als" else MCMC_ITERS
    learner = cls(cfg, task=task, num_iter=iters, seed=SEED, verbose=True,
                  attr_group=groups, **(learner_kw or {}))
    for key, v in (flags or {}).items():
        setattr(learner, key, v)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    prof = None
    if args.profile and name.startswith(("mcmc", "exact")):
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    t0 = time.perf_counter()
    hist = learner.learn(train, test)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
        profile_summary(prof, args.profile, rec, name)
        if task and isinstance(learner, MCMCVectorLearner):  # the probit fast path's engines
            fast_launches(rec, name, iters, learner.refresh_every)
    counts = kernels.launch_counts()
    rec[name] = dict(
        history=hist, launches=counts, learn_seconds=wall,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
    )
    secs = [h["time"] for h in hist]
    rec[name]["setup_seconds"] = wall - sum(secs)
    print(f"{name}: launches {counts}; learn() {wall:.2f} s, of which set-up "
          f"{wall - sum(secs):.2f} s; per-iteration s {secs}; seconds an iteration past "
          f"the first {secs[1:]}; peak device memory "
          f"{rec[name]['peak_mem_bytes'] / 1e9:.3f} GB")
    check_launches(name, counts)
    # the launches each path's iterations must make, exactly
    if not exact:
        want = {}
    elif want is None:
        refresh = len(dispatch_chunks(0, iters, learner.refresh_every))
        per_iter = dict(dict(slot_stats=0, case_stats=0, schur_draw=0, dual_draw=0,
                             slot_update=0),
                        **(per_iter or dict(slot_stats=2, schur_draw=2)))
        want = dict({key: v * iters for key, v in per_iter.items()},
                    fm_refresh_probit=refresh if task else 0,
                    probit_latent=iters - refresh if task else 0, **(extra_want or {}))
    wrong = {key: (counts[key], v) for key, v in want.items() if counts[key] != v}
    if wrong:
        fail(f"{name}: launches (made, expected) {wrong}")
    keys = ("train", "test_this", "test_all") + (("test_all_m2", "auc_all") if task else ())
    for h in hist:
        for key in keys:
            if not math.isfinite(h[key]):
                fail(f"{name}: non-finite {key} at iteration {h['iter']}")
        if h["rejected"] != 0:
            fail(f"{name}: {h['rejected']} rejected draws at iteration {h['iter']}")
        if task:
            print(f"{name} iteration {h['iter']}: train accuracy {h['train']:.6g}, test "
                  f"accuracy {h['test_all']:.6g}, log10-loss {h['test_all_m2']:.6g}, AUC "
                  f"{h['auc_all']:.6g}, {h['time']:.4f} s")
    return learner, counts


#: the final state two runs of one chain at one seed must share, bit for bit
REPRO_KEYS = ("w0", "alpha", "w_mu", "w_lambda", "v_mu", "v_lambda", "w", "V", "pred_sum_all")


def repro_check(args, rec, first, name, cls, data, **kw):
    """The chain of learner `first` once more at the same seed, as run
    `name`: fails unless its P = [w | V], w0, alpha, hyperpriors and test
    prediction sum equal the first run's bit for bit (every sum of the
    chain is taken in a fixed order). Returns the run's launches."""
    learner, counts = run_learner(cls, name, data, args, rec, **kw)
    a, b = first._final_state, learner._final_state
    differ = [key for key in REPRO_KEYS if not torch.equal(a[key], b[key])]
    rec[name]["same_bits"] = not differ
    print(f"{name}: the chain again at seed {SEED}: {', '.join(REPRO_KEYS)} equal bit for "
          f"bit: {not differ}; test_all {[h['test_all'] for h in rec[name]['history']]}")
    if differ:
        fail(f"{name}: a second run at one seed ends in other bits: {differ}")
    return counts


def group_sum_check(args, rec, dev, lv):
    """The hyperprior draws' group sums at config #5's shapes (its
    1,040,000 features, k = 128, its 26 field groups): one sweep's four
    sums (w and V, each beside its squares) by GroupSums, in a fixed
    order, against the index_add_ they replaced (float atomics on the
    card), both held to float64 over each sum's magnitudes (tol 1e-5),
    GroupSums twice the same bits."""
    from libfm_tpu_torch.ops.segment import GroupSums, seg_sum

    train, _, groups = lv
    n, d = train.num_features, LV_FACTORS + 1
    t0 = time.perf_counter()
    gs = GroupSums(groups, int(groups.max()) + 1, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    P = 0.1 * torch.randn(n, d, generator=g, device=dev)
    thetas = (P[:, 0], P[:, 0] ** 2, P[:, 1:], P[:, 1:] ** 2)

    def fixed():
        return [gs(x) for x in thetas]

    def atomics():
        return [seg_sum(x, gs.ids, gs.num_groups) for x in thetas]

    a1, a2, b1, b2 = fixed(), fixed(), atomics(), atomics()
    err = err_atomics = 0.0
    for x, a, b in zip(thetas, a1, b1):
        ref = seg_sum(x.double(), gs.ids, gs.num_groups)
        mag = seg_sum(x.double().abs(), gs.ids, gs.num_groups).clamp_min(1e-300)
        err = max(err, ((a.double() - ref).abs() / mag).max().item())
        err_atomics = max(err_atomics, ((b.double() - ref).abs() / mag).max().item())
    out = dict(
        ms=cuda_ms(fixed, args.reps), index_add_ms=cuda_ms(atomics, args.reps),
        err=err, index_add_err=err_atomics, tol=1e-5, setup_s=setup_s,
        same_bits=all(torch.equal(x, y) for x, y in zip(a1, a2)),
        index_add_same_bits=all(torch.equal(x, y) for x, y in zip(b1, b2)),
        features=n, groups=gs.num_groups)
    rec["group_sums_config5"] = out
    print(f"hyperprior group sums at config #5 ({n} features, k = {LV_FACTORS}, "
          f"{gs.num_groups} groups; one sweep's 4 sums): GroupSums {out['ms']:.4f} ms (set-up "
          f"{setup_s:.2f} s; two calls the same bits: {out['same_bits']}; err {err:.3g} of "
          f"the magnitudes, tol 1e-5) against index_add_ {out['index_add_ms']:.4f} ms (two "
          f"calls the same bits: {out['index_add_same_bits']}; err {err_atomics:.3g})")
    if not (err <= 1e-5 and out["same_bits"]):
        fail(f"GroupSums at config #5: err {err} or other bits on a second call")
    del P, thetas, a1, a2, b1, b2
    torch.cuda.empty_cache()
    return out


def run_k4b_paths(args, rec, data, counts, done):
    """Path phase, config #3's K4b paths: MCMC (4 iterations, the `mcmc`
    run's seed) with dense_update=False and with the incremental test
    tail, each with its exact launches and each held to the `mcmc` run's
    test_all at every iteration (the same draws: the options change only
    the order of float32 sums)."""
    from libfm_tpu_torch.learners.mcmc import dispatch_chunks
    from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner

    refresh = len(dispatch_chunks(0, MCMC_ITERS, MCMCVectorLearner.ALS_DEFAULT_REFRESH))
    base = rec["mcmc"]["history"]
    paths = (
        ("mcmc_scatter", K4B_SCATTER_TOL, dict(
            learner_kw=dict(dense_update=False),
            per_iter=dict(slot_stats=2, schur_draw=2, slot_update=2, dense_update=0),
            extra_want=dict(fm_refresh=1 + MCMC_ITERS + refresh))),
        ("mcmc_tail", K4B_TAIL_TOL, dict(
            flags=dict(flat_incr_test=True),
            per_iter=dict(slot_stats=2, schur_draw=2, dense_update=4),
            extra_want=dict(fm_refresh=2 * (1 + refresh)))),
    )
    for name, tol, kw in paths:
        t0 = time.perf_counter()
        learner, counts[name] = run_learner(MCMCVectorLearner, name, data, args, rec, **kw)
        if learner.incr_test != (name == "mcmc_tail"):
            fail(f"{name}: the incremental test tail is {'on' if learner.incr_test else 'off'}")
        hist = rec[name]["history"]
        diff = max(abs(h["test_all"] - b["test_all"]) for h, b in zip(hist, base, strict=True))
        rec[name]["test_all_from_mcmc"] = diff
        print(f"{name}: test_all by iteration {[round(h['test_all'], 7) for h in hist]} "
              f"against mcmc's {[round(b['test_all'], 7) for b in base]}: largest difference "
              f"{diff:.3g} (tol {tol:g}); seconds an iteration "
              f"{[round(h['time'], 6) for h in hist]} against mcmc's "
              f"{[round(b['time'], 6) for b in base]}")
        if not diff <= tol:
            fail(f"{name}: test_all lies {diff} from the mcmc run's (> {tol})")
        del learner
        done(f"config #3 {name} path", t0)


def run_quality(args, rec, dev, counts, done):
    """--quality: MCMCVectorLearner to bench.py's 24 iterations at configs
    #3, #4 and #5 (bench_ml, bench_ctr, bench_largevocab), each with its
    path's kernels and no other; prints each final test_all beside its
    quality target and numpy's version. Then bench_bs_ctx and bench_bs_c
    to 24 iterations, which have no published target: their test RMSE
    beside the test targets' sd, their accuracy beside the larger class's
    share. Returns the readings."""
    import numpy as np

    from libfm_tpu_torch.data.synth import movielens_like
    from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner

    makers = (
        ("quality_3", "#3", lambda: movielens_like(USERS, ITEMS, RATINGS, seed=SEED), {}),
        ("quality_4", "#4", ctr_data, dict(factors=CTR_FACTORS, task=1)),
        ("quality_5", "#5", lv_data, dict(factors=LV_FACTORS, task=1)),
    )
    out = {}
    for name, config, make, kw in makers:
        t0 = time.perf_counter()
        data = make()
        t0 = done(f"config {config} data", t0)
        groups = data[2] if len(data) > 2 else None
        _, counts[name] = run_learner(MCMCVectorLearner, name, data, args, rec,
                                      iters=QUALITY_ITERS, groups=groups, exact=False, **kw)
        del data
        hist = rec[name]["history"]
        got, target = hist[-1]["test_all"], QUALITY_TARGETS[name]
        classify = kw.get("task", 0) == 1
        met = got >= target if classify else got <= target
        out[name] = dict(config=config, test_all=got, target=target, met=met,
                         metric="test accuracy" if classify else "test RMSE",
                         seconds=[h["time"] for h in hist])
        print(f"quality at config {config}: {out[name]['metric']} (test_all) after "
              f"{QUALITY_ITERS} iterations {got:.6f}, target {target}: "
              f"{'met' if met else 'missed'} ({got - target:+.4g}); numpy {np.__version__}; "
              f"test_all by iteration {[round(h['test_all'], 6) for h in hist]}")
        done(f"config {config} quality run", t0)
    t0 = time.perf_counter()
    ctx = bs_ctx_data(dev, bs_data(dev))
    t0 = done("bench_bs_ctx data", t0)
    for name, task in (("quality_bs_ctx", 0), ("quality_bs_c", 1)):
        data = (ctx["train_c"], ctx["test_c"]) if task else (ctx["train"], ctx["test"])
        _, counts[name] = run_learner(
            MCMCVectorLearner, name, data, args, rec, iters=QUALITY_ITERS, task=task,
            factors=BS_FACTORS, num_features=ctx["num_features"], exact=False,
            flags=dict(expand_max_ratio=0.0))
        hist = rec[name]["history"]
        floor = (max(ctx["positive_share"], 1.0 - ctx["positive_share"]) if task
                 else float(data[1].target.std()))
        out[name] = dict(config="bench_bs_c" if task else "bench_bs_ctx",
                         test_all=hist[-1]["test_all"], target=None,
                         metric="test accuracy" if task else "test RMSE",
                         baseline=floor, seconds=[h["time"] for h in hist])
        print(f"quality at {out[name]['config']}: {out[name]['metric']} (test_all) after "
              f"{QUALITY_ITERS} iterations {hist[-1]['test_all']:.6f} (no published target; "
              f"{'the larger class share' if task else 'the test targets sd'} {floor:.6f}); "
              f"test_all by iteration {[round(h['test_all'], 6) for h in hist]}")
        t0 = done(f"{out[name]['config']} quality run", t0)
    return out


def run_bench_bs(args, rec, dev, counts, done):
    """bench_bs: its data, the kernel checks at its shapes and the three
    paths (their launches into `counts`): ALS 9 iterations and MCMC 24 on
    the deferred path, the draw check again at the state MCMC ends in, MCMC
    4 on the resync path; then bench_bs_ctx's (`run_bench_bs_ctx`).
    `done(name, t0)` records a phase's seconds. Returns the checks' rows
    and the data of bench_bs and bench_bs_ctx."""
    from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner, MCMCVectorLearner

    t0 = time.perf_counter()
    bs = bs_data(dev)
    t0 = done("bench_bs data", t0)
    table = bs_kernel_checks(args, rec, dev, bs)
    t0 = done("bench_bs kernel checks", t0)
    rec["bench_bs"] = {key: bs[key] for key in ("blocks", "observed", "unobserved")}
    rec["bench_bs"]["shapes"] = [[F, E, c] for (F, E), c in bs["shapes"].items()]
    c_bs = dict(factors=BS_FACTORS, num_features=BS_NF)
    learner, counts["als_bs"] = run_learner(
        ALSVectorLearner, "als_bs", (bs["train"], bs["test"]), args, rec,
        iters=BS_ALS_ITERS, want=bs_want(BS_ALS_ITERS, bs["blocks"], True), regw=5.0,
        regv=5.0, **c_bs)
    if learner.relational_mode != "bs_vector":
        fail(f"als_bs: routed to {learner.relational_mode}")
    als = rec["als_bs"]["history"]
    if not als[-1]["train"] < als[0]["train"]:
        fail(f"bench_bs ALS train RMSE did not fall: {[h['train'] for h in als]}")
    t0 = done("bench_bs ALS path", t0)
    learner, counts["mcmc_bs"] = run_learner(
        MCMCVectorLearner, "mcmc_bs", (bs["train"], bs["test"]), args, rec,
        iters=BS_MCMC_ITERS, want=bs_want(BS_MCMC_ITERS, bs["blocks"], True), **c_bs)
    rmse = rec["mcmc_bs"]["history"][-1]["test_all"]
    print(f"mcmc_bs: test_all after {BS_MCMC_ITERS} iterations {rmse:.6f} (bench_bs's "
          f"quality target {BS_TARGET}, limit {BS_LIMIT}); test_all by iteration "
          f"{[round(h['test_all'], 6) for h in rec['mcmc_bs']['history']]}")
    if not rmse <= BS_LIMIT:
        fail(f"mcmc_bs: test_all {rmse} after {BS_MCMC_ITERS} iterations is above "
             f"{BS_LIMIT}")
    t0 = done("bench_bs MCMC path", t0)
    bs_chain_check(rec, dev, bs, learner)
    del learner
    t0 = done("bench_bs draw check at the chain's state", t0)
    _, counts["mcmc_bs_resync"] = run_learner(
        MCMCVectorLearner, "mcmc_bs_resync", (bs["train"], bs["test"]), args, rec,
        iters=BS_RESYNC_ITERS, want=bs_want(BS_RESYNC_ITERS, bs["blocks"], False),
        flags=dict(bs_deferred=False), **c_bs)
    done("bench_bs MCMC resync path", t0)
    ctx_table, ctx = run_bench_bs_ctx(args, rec, dev, counts, done, bs)
    return table + ctx_table, bs, ctx


# ---- the exact engines (K11): coord_draw and rel_coord_draw


def exact_draw_row(args, dev, name, label, config, blocks, state, run_block, parts, nbytes,
                   flops, timed, forced=None):
    """One kernel row of the exact engines' draws. `state` holds every float
    input (parameters, caches, hyperparameters, the normals `z` of all
    blocks end to end); `run_block(fn, s, i, rej, sample, plan)` launches
    block i's draws on `s` in place under `plan`, and `parts(s)` lists the
    outputs held. Block by block in lockstep, sampling and ALS: the kernel,
    the plain version and the plain version in float64 each run block i
    from the kernel's state so far. Held: the kernel within the stated
    tolerance of the float32 plain version (the largest difference over
    max(1, the plain output's largest magnitude)): EXACT_TOL, or
    EXACT_SLACK times the float32 plain version's own distance from
    float64 where that is larger (a posterior mean cancels, mean = -s2
    (alpha (num - theta den) - mu lambda), and the sums' f32 order moves
    it by that much); the rejection counts equal; a second kernel launch
    the same bits. Under each block's own plan, and again under each of
    `forced` (name -> DrawPlan keyword arguments: thresholds that move
    the features to a longer class); timed under the blocks' own plans.
    The row records the features each plan put in each class."""
    from libfm_tpu_torch.kernels import coord_draw as cd

    kern = cd.coord_draw if name == "coord_draw" else cd.rel_coord_draw
    plain = cd.coord_draw_plain if name == "coord_draw" else cd.rel_coord_draw_plain
    plan_sets = {"kernel": [b.plan for b in blocks]}
    for key, kw in (forced or {}).items():
        plan_sets[key] = [cd.DrawPlan(b.feat_off, dev, **kw) for b in blocks]
    classes = {key: {c: sum(p.classes()[c] for p in plans) for c in ("short", "medium", "long")}
               for key, plans in plan_sets.items()}

    def clone(s, dtype=None):
        return {key: v.to(dtype) if dtype else v.clone() for key, v in s.items()}

    def dist(a, b):
        return max(((x.double() - y.double()).abs().max()
                    / y.double().abs().max().clamp_min(1.0)).item()
                   for x, y in zip(parts(a), parts(b)))

    errs, nrej, worst = {}, 0, dict(err=0.0, tol=EXACT_TOL)
    for key, plans in plan_sets.items():
        for sample in (True, False):
            s = clone(state)
            err_k64 = err_p64 = 0.0
            for i, (b, plan) in enumerate(zip(blocks, plans)):
                sp, sk2, s64 = clone(s), clone(s), clone(s, torch.float64)
                rk, rp, rk2, r64 = (torch.zeros(b.F, dtype=torch.int32, device=dev)
                                    for _ in range(4))
                run_block(kern, s, i, rk, sample, plan)
                run_block(plain, sp, i, rp, sample, plan)
                run_block(kern, sk2, i, rk2, sample, plan)
                run_block(plain, s64, i, r64, sample, plan)
                torch.cuda.synchronize()
                err, e_p64 = dist(s, sp), dist(sp, s64)
                tol = max(EXACT_TOL, EXACT_SLACK * e_p64)
                if err / tol > worst["err"] / worst["tol"]:
                    worst.update(err=err, tol=tol)
                err_k64, err_p64 = max(err_k64, dist(s, s64)), max(err_p64, e_p64)
                if not torch.equal(rk, rp):
                    fail(f"{name}{label}, {key} plan: block {i}'s rejection counts differ "
                         "from the plain version's")
                if (any(not torch.equal(s[x], sk2[x]) for x in s)
                        or not torch.equal(rk, rk2)):
                    fail(f"{name}{label}, {key} plan: a second launch from the same state "
                         "gave other bits")
                nrej += int(rk.sum().item())
                del sp, sk2, s64
            errs[f"{key} plan, {'sample' if sample else 'als'}"] = dict(
                kernel_from_float64=err_k64, plain_from_float64=err_p64)
            del s
    if nrej:
        fail(f"{name}{label}: {nrej} draws rejected at the check state")
    s_k, s_p = clone(state), clone(state)
    rej = [torch.zeros(b.F, dtype=torch.int32, device=dev) for b in blocks]

    def run_all(fn, s):
        def go():
            for i, b in enumerate(blocks):
                run_block(fn, s, i, rej[i], True, b.plan)
        return go

    print(f"{name}{label}: features by class, under each plan held {classes}; largest "
          f"distance from the float64 plain version, kernel / float32 plain: {errs}")
    row = kernel_row(
        name, config["replaces"], worst["err"], worst["tol"],
        cuda_ms(run_all(kern, s_k), args.reps),
        cuda_ms(run_all(plain, s_p), args.reps, warmup=1),
        nbytes=nbytes, flops=flops, lib_ms=None, timed=timed, label=label,
        source="libfm_tpu_torch/csrc/coord_draw.cu")
    row.update(config=config["name"], mode=config["mode"], err_from_float64=errs,
               classes=classes, launches_a_sweep=sum(b.plan.launches for b in blocks),
               tolerance_note=f"{EXACT_TOL:g}, or {EXACT_SLACK:g} times the float32 plain "
               "version's distance from float64 on the same launch where larger; each "
               "block from the same state, under each plan held",
               library_note="none: no one call gathers a block's cache rows, sums them "
               "per feature, draws and scatters the updates back")
    del s_k, s_p
    return row


def exact_flat_checks(args, dev, config, train, groups, k, longest_only):
    """Phase 3, the flat exact engine: coord_draw w and v (factor k/2, whose
    q lies in another 32-byte sector of A's row than e, as most factors'
    do) on the
    config's blocks (or on the block with the longest feature alone),
    from P = 0.1 randn and the A = [e | Q] that fm_refresh writes from it,
    alpha 1 / var(e), lambda 5 and mu 0 in every group; each block under
    its own plan (config #3: short and medium features; #4's block also
    long ones). At config #3 the v launches are also timed with the short
    class cut at 64 and 128 slots (the rest medium). Returns the rows and
    the coord_draw launches of one sweep over all the config's blocks."""
    import numpy as np

    from libfm_tpu_torch.kernels import coord_draw as cd
    from libfm_tpu_torch.kernels import fm_refresh as fr
    from libfm_tpu_torch.learners.mcmc import exact_layout, padded_rows

    n, nc, d = train.num_features, train.num_rows, k + 1
    groups = groups if groups is not None else np.zeros(n, np.int32)
    blocks, _ = exact_layout(train, groups, 128, dev)
    sweep_launches = sum(b.plan.launches for b in blocks)
    longest = [int((b.feat_off[1:] - b.feat_off[:-1]).max().item()) for b in blocks]
    if longest_only:
        i = int(np.argmax(longest))
        blocks, longest = [blocks[i]], [longest[i]]
    E = sum(int(b.slot_row.numel()) for b in blocks)
    F = sum(b.F for b in blocks)
    z_off = np.cumsum([0] + [b.F for b in blocks])
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)
    P = 0.1 * torch.randn(n, d, generator=g, device=dev)
    ids, vals = padded_rows(train, dev)
    y = torch.as_tensor(train.target, device=dev)
    w0 = torch.tensor(float(train.target.mean()), device=dev)
    A = torch.empty(nc, d, device=dev)
    fr.fm_refresh(P, ids, vals, w0, y, A, min_target=float(train.min_target),
                  max_target=float(train.max_target))
    del ids, vals
    G = int(groups.max()) + 1
    # e and factor k/2's q as the engines' draws hold them (draw_caches: side
    # by side), and in A's columns (a row apart; the first version's layout)
    fv = 1 + k // 2
    state = dict(P=P, EQ=torch.stack([A[:, 0], A[:, fv]], dim=1),
                 lam=torch.full((G,), 5.0, device=dev), mu=torch.zeros(G, device=dev),
                 alpha=(1.0 / A[:, 0].var()).reshape(()),
                 z=torch.randn(F, generator=g, device=dev))
    bound = 1e6 * max(1.0, abs(float(train.min_target)), abs(float(train.max_target)))
    print(f"{config}: exact-engine blocks (features, slots, longest feature's slots) "
          f"{[(b.F, int(b.slot_row.numel()), m) for b, m in zip(blocks, longest)]}")

    def mode_fns(mode, on_a=False):
        col = 0 if mode == "w" else fv

        def caches(s):
            return (s["A"][:, 0], s["A"][:, fv]) if on_a else (s["EQ"][:, 0], s["EQ"][:, 1])

        def run_block(fn, s, i, rej, sample, plan):
            b = blocks[i]
            e, q = caches(s)
            fn(s["P"][:, col], b.feat_off, b.slot_row, b.slot_val, b.feat_id, b.group_id,
               s["lam"], s["mu"], s["alpha"], s["z"][z_off[i]:z_off[i + 1]] if sample else None,
               rej, bound=bound, e=e, q=None if mode == "w" else q, plan=plan)

        def parts(s):
            e, q = caches(s)
            return [s["P"][:, col], e] + ([q] if mode == "v" else [])
        return run_block, parts

    def timed(mode, plans=None, on_a=False):
        """The kernel's time over the blocks (their own plans, or `plans`),
        from a copy of the state."""
        run_block = mode_fns(mode, on_a)[0]
        s = {key: v.clone() for key, v in state.items()}
        if on_a:
            s["A"] = A.clone()
        rej = [torch.zeros(b.F, dtype=torch.int32, device=dev) for b in blocks]

        def go():
            for i, b in enumerate(blocks):
                run_block(cd.coord_draw, s, i, rej[i], True, plans[i] if plans else b.plan)
        ms = cuda_ms(go, args.reps)
        del s
        return ms

    rows = []
    where = ("the block with the longest feature" if longest_only
             else f"{len(blocks)} blocks")
    for mode, per_slot in (("v", 24), ("w", 16)):
        rows.append(exact_draw_row(
            args, dev, "coord_draw", f" ({config}, {mode})",
            dict(name=config, mode=mode,
                 replaces="libfm_tpu/learners/mcmc.py:" + ("281" if mode == "v" else "254")),
            blocks, state, *mode_fns(mode),
            nbytes=E * per_slot + F * 36, flops=E * (10 if mode == "v" else 4) + F * 12,
            timed=f"one {'factor' if mode == 'v' else 'w sweep'}'s launches on {where}, "
            "e and q side by side (draw_caches)"))
        rows[-1].update(blocks=len(blocks), slots=E, features=F,
                        longest_feature_slots=max(longest),
                        ms_on_A_columns=timed(mode, on_a=True))
    print(f"{config}: coord_draw v / w on e and q side by side {rows[0]['ms']:.4f} / "
          f"{rows[1]['ms']:.4f} ms, on A's columns {rows[0]['ms_on_A_columns']:.4f} / "
          f"{rows[1]['ms_on_A_columns']:.4f} ms" + (
              f"; the longest feature holds {max(longest)} of the block's {E} slots"
              if longest_only else ""))
    if not longest_only:
        # the short class's threshold: v launches with shorter ones
        by_short = {}
        for short_max in (64, 128, cd.SHORT_MAX):
            plans = [cd.DrawPlan(b.feat_off, dev, short_max=short_max) for b in blocks]
            by_short[short_max] = dict(ms=timed("v", plans),
                                       short=sum(p.n_short for p in plans))
        print(f"{config}: coord_draw v by the short class's most slots (ms, short "
              f"features): {by_short}")
        rows[0]["v_ms_by_short_max"] = by_short
        # the access pattern alone: torch's gathers and scatters of one v
        # factor's e and q over every block's slots, 4 launches, on each layout
        at = torch.cat([b.slot_row for b in blocks]).long()

        def scattered(T, c0, c1):
            def go():
                e_, q_ = T[at, c0], T[at, c1]
                T[at, c0] = e_
                T[at, c1] = q_
            return cuda_ms(go, args.reps)
        pattern = dict(side_by_side=scattered(state["EQ"], 0, 1), A_columns=scattered(A, 0, fv))
        print(f"{config}: torch's gathers and scatters of the same slots' e and q (4 "
              f"launches) {pattern} ms")
        rows[0]["scattered_sectors_ms"] = pattern
        del at
    del P, A, state
    torch.cuda.empty_cache()
    return rows, sweep_launches


def exact_rel_checks(args, dev, ctx):
    """Phase 3, the exact BS engine at bench_bs_ctx: rel_coord_draw w (we
    from rel_cache_cols over A's first two columns) and v (factor f = k/2:
    rel_cache_cols over e and q', qB the score table's column f) on the
    relation's 23 blocks, under their own plans (short features) and under
    forced ones (every feature medium; cut into pieces of 2 slots), and
    rel_cache_cols (rel_cache at k = 1) against the float64 plain version,
    from P = 0.1 randn and the A that rel_refresh writes with the main
    rows. Returns the rows and the rel_coord_draw launches of one sweep."""
    import numpy as np

    from libfm_tpu_torch.kernels import rel_cache as rc
    from libfm_tpu_torch.kernels import rel_refresh as rr
    from libfm_tpu_torch.kernels.case_stats import err_over_magnitudes
    from libfm_tpu_torch.learners.mcmc import padded_rows
    from libfm_tpu_torch.learners.mcmc_rel_vector import RelLayout
    from libfm_tpu_torch.learners.mcmc_relational import ExactRel

    train, test, n = ctx["train"], ctx["test"], ctx["num_features"]
    k, d = BS_FACTORS, BS_FACTORS + 1
    nc = train.num_rows
    lay = RelLayout(train.relations[0], test.relations[0], np.zeros(n, np.int32), n,
                    by_shape=False)
    rel = ExactRel(lay, dev)
    nb = rel.nb
    blocks = rel.blocks
    E = sum(int(b.slot_row.numel()) for b in blocks)
    F = sum(b.F for b in blocks)
    z_off = np.cumsum([0] + [b.F for b in blocks])
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)
    P = 0.1 * torch.randn(n, d, generator=g, device=dev)
    ids, vals = padded_rows(train, dev)
    y = torch.as_tensor(train.target, device=dev)
    w0 = torch.tensor(float(train.target.mean()), device=dev)
    SC = rr.rel_scores(P, rel.indptr, rel.cols, rel.vals)
    A = torch.empty(nc, d, device=dev)
    rr.rel_refresh(SC, rel.map_tr.to(torch.int32)[None].contiguous(), w0, A, y, P=P,
                   ids=ids, vals=vals, min_target=float(train.min_target),
                   max_target=float(train.max_target))
    del ids, vals
    yb = 0.5 * ((SC[:, :k] * SC[:, :k]).sum(dim=1) - SC[:, k]) + SC[:, k + 1]
    f = k // 2
    # e and q as the engine's draws hold them (draw_caches: side by side)
    EQ = torch.stack([A[:, 0], A[:, 1 + f]], dim=1)
    e, qd = EQ[:, 0], EQ[:, 1] - SC[rel.map_tr, f]
    C_w = rc.rel_cache_cols(e, A[:, 1], rel.case_off, rel.case_ids)
    C_v = rc.rel_cache_cols(e, qd, rel.case_off, rel.case_ids)
    const = dict(lam=torch.full((1,), 5.0, device=dev), mu=torch.zeros(1, device=dev),
                 alpha=(1.0 / A[:, 0].var()).reshape(()), wnum=rel.wnum,
                 z=torch.randn(F, generator=g, device=dev))
    bound = 1e6 * max(1.0, abs(float(train.min_target)), abs(float(train.max_target)))

    def run_block(fn, s, i, rej, sample, plan):
        b = blocks[i]
        C = s["C"]
        extra = {} if "SC" not in s else dict(
            weq=C[:, 3], wc=C[:, 2], wc_sqr=C[:, 4], qb=s["SC"][:, f])
        fn(s["P"][:, 0 if "SC" not in s else 1 + f], b.feat_off, b.slot_row, b.slot_val,
           b.feat_id, b.group_id, s["lam"], s["mu"], s["alpha"],
           s["z"][z_off[i]:z_off[i + 1]] if sample else None, rej, bound=bound, we=C[:, 0],
           wnum=s["wnum"], yb=s["yb"], plan=plan, **extra)

    # the relation's features are short; these move them to the other classes
    forced = dict(medium=dict(short_max=0), pieces=dict(short_max=0, piece_len=2))

    def parts(s):
        if "SC" not in s:
            return [s["P"][:, 0], s["yb"], s["C"][:, 0]]
        return [s["P"][:, 1 + f], s["yb"], s["C"][:, 0], s["C"][:, 3], s["SC"][:, f]]

    print(f"bench_bs_ctx: the exact BS engine's {len(blocks)} relation blocks over {nb} "
          f"block rows, {F} features, {E} entries")
    rows = [
        exact_draw_row(
            args, dev, "rel_coord_draw", " (bench_bs_ctx, v)",
            dict(name="bench_bs_ctx", mode="v",
                 replaces="libfm_tpu/learners/mcmc_relational.py:156"),
            blocks, dict(P=P, C=C_v, yb=yb, SC=SC, **const), run_block, parts,
            nbytes=E * 52 + F * 36, flops=E * 24 + F * 12,
            timed=f"one factor's launches: one per relation block ({len(blocks)})",
            forced=forced),
        exact_draw_row(
            args, dev, "rel_coord_draw", " (bench_bs_ctx, w)",
            dict(name="bench_bs_ctx", mode="w",
                 replaces="libfm_tpu/learners/mcmc_relational.py:129"),
            blocks, dict(P=P, C=C_w, yb=yb, **const), run_block, parts,
            nbytes=E * 28 + F * 36, flops=E * 6 + F * 12,
            timed=f"the w sweep's launches: one per relation block ({len(blocks)})",
            forced=forced),
    ]
    for r in rows:
        r.update(blocks=len(blocks), slots=E, features=F)

    # ---- rel_cache at k = 1 (rel_cache_cols): the per-block-row sums of e, q'
    T = torch.stack([e, qd], dim=1)
    ref, scale = rc.rel_cache_reference(T, rel.case_off, rel.case_ids)
    counts = np.diff(lay.case_off)
    lmax = int(counts.max())
    err = err_over_magnitudes(C_v, ref, scale)
    del ref, scale
    rowid = torch.as_tensor(np.repeat(np.arange(nb), counts), device=dev)
    pos = torch.as_tensor(np.arange(nc) - np.repeat(lay.case_off[:-1], counts), device=dev)
    R = torch.zeros(nb, lmax, 3, device=dev)
    R[rowid, pos, 0] = 1.0
    R[rowid, pos, 1:] = T[rel.case_ids.long()]
    lib = cuda_ms(lambda: torch.bmm(R.transpose(1, 2), R), args.reps)
    del R, rowid, pos
    row = kernel_row(
        "rel_cache", "libfm_tpu/learners/mcmc_relational.py:544", err, 2 * (lmax + 2) * U32,
        cuda_ms(lambda: rc.rel_cache_cols(e, qd, rel.case_off, rel.case_ids), args.reps),
        cuda_ms(lambda: rc.rel_cache_cols_plain(e, qd, rel.case_off, rel.case_ids),
                args.reps),
        nbytes=nc * (2 * 4 + 4) + (nb + 1) * 8 + (nb + 1) * 5 * 4, flops=2 * nc * 5,
        lib_ms=lib, timed="one launch: the exact BS engine's per-row sums of one factor "
        "(rel_cache_cols over e, stride 2, and q')",
        label=" (k = 1, bench_bs_ctx)", source="libfm_tpu_torch/csrc/rel_cache.cu")
    if not torch.equal(C_v, rc.rel_cache_cols(e, qd, rel.case_off, rel.case_ids)):
        fail("rel_cache (k = 1, bench_bs_ctx): a second launch gave other bits")
    row.update(config="bench_bs_ctx", k=1, most_cases_on_a_row=lmax, form="narrow",
               library_note=f"torch.bmm(R^T, R) of the pre-gathered rows [1 | e | q'], "
               f"zero-padded to [nb, {lmax}, 3], fp32; the gather not timed",
               tolerance_note="2 (most cases on a row + 2) float32 roundings of each "
               "entry's sum of magnitudes, against float64")
    rows.append(row)
    sweep_launches = sum(b.plan.launches for b in blocks)
    del P, A, T, SC, C_v, C_w, e, qd, EQ
    torch.cuda.empty_cache()
    return rows, sweep_launches


def flat_exact_want(iters, sweep, k, probit=False):
    """The flat exact engine's launches: coord_draw's `sweep` launches (one
    a block, two on a block with a long feature) for w and for each
    factor, fm_refresh at the set-up and twice an iteration (test and
    train mode; probit: the train mode counted as fm_refresh_probit)."""
    return dict(coord_draw=iters * sweep * (1 + k),
                fm_refresh=1 + iters * (1 if probit else 2),
                fm_refresh_probit=iters if probit else 0)


def bs_exact_want(iters, mains, blocks, k, probit=False):
    """The exact BS engine's launches (one relation): coord_draw on the main
    blocks and rel_coord_draw on the relation's, `mains` and `blocks`
    launches a sweep (one a block, two on a block with a long feature),
    for w and for each factor; rel_cache 1 + k an iteration; rel_scores at
    the set-up and once
    an iteration; rel_refresh at the set-up and twice an iteration (probit:
    the train mode counted as rel_refresh_probit)."""
    return dict(coord_draw=iters * mains * (1 + k), rel_coord_draw=iters * blocks * (1 + k),
                rel_cache=iters * (1 + k), rel_scores=1 + iters,
                rel_refresh=1 + iters * (1 if probit else 2),
                rel_refresh_probit=iters if probit else 0)


def beside(rec, name, vector, key="test_all"):
    """Print run `name`'s readings by iteration beside the vector engine's
    run `vector` (where this invocation ran it)."""
    got = [round(h[key], 6) for h in rec[name]["history"]]
    other = rec.get(vector)
    vec = ([round(h[key], 6) for h in other["history"][:len(got)]] if other
           else "not run in this invocation")
    print(f"{name}: {key} by iteration {got}; the vector engine's {vector} {vec}; seconds "
          f"an iteration {[round(h['time'], 6) for h in rec[name]['history']]}")


def run_exact(args, rec, dev, counts, done, data=None, ctr=None, bs=None, ctx=None,
              keep=None):
    """The exact engines (K11): the kernel checks (returns their rows) and
    the paths, each with its exact launches into `counts`: ALS 3 and MCMC 4
    iterations at config #3, MCMC 4 (probit) at config #4, ALS 3 and MCMC 4
    at bench_bs_ctx and MCMC 4 at bench_bs_c on the exact BS engine, and the
    vector learner's fallback to it at bench_bs (bs_vector off, ALS 3).
    Builds the data it is not given."""
    from libfm_tpu_torch.data.synth import movielens_like
    from libfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
    from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner

    t0 = time.perf_counter()
    if data is None:
        data = movielens_like(USERS, ITEMS, RATINGS, seed=SEED)
        t0 = done("config #3 data", t0)
    if ctr is None:
        ctr = ctr_data()
        t0 = done("config #4 data", t0)
    if bs is None:
        bs = bs_data(dev)
        t0 = done("bench_bs data", t0)
    if ctx is None:
        ctx = bs_ctx_data(dev, bs)
        t0 = done("bench_bs_ctx data", t0)
    table, sweep3 = exact_flat_checks(args, dev, "config #3", data[0], None, FACTORS, False)
    rows, sweep4 = exact_flat_checks(args, dev, "config #4", ctr[0], ctr[2], CTR_FACTORS,
                                     True)
    table += rows
    rows, main_sweep = exact_flat_checks(args, dev, "bench_bs_ctx main", ctx["train"], None,
                                         BS_FACTORS, False)
    table += rows
    rows, rel_sweep = exact_rel_checks(args, dev, ctx)
    table += rows
    # every class of the plan held in every mode
    held = {}
    for row in table:
        for classes in row.get("classes", {}).values():
            held.setdefault((row["name"], row["mode"]), set()).update(
                c for c, nf in classes.items() if nf)
    missing = {key: {"short", "medium", "long"} - got for key, got in held.items()
               if got != {"short", "medium", "long"}}
    if missing or len(held) != 4:
        fail(f"exact kernel checks: classes not held (kernel, mode): {missing or held}")
    print(f"exact engines: launches a sweep, coord_draw at #3 {sweep3}, #4 {sweep4}, "
          f"bench_bs_ctx's main blocks {main_sweep}; rel_coord_draw {rel_sweep}")
    t0 = done("exact kernel checks", t0)

    reg = dict(regw=5.0, regv=5.0)
    _, counts["als_exact_3"] = run_learner(
        ALSLearner, "als_exact_3", data, args, rec, iters=ALS_ITERS,
        want=flat_exact_want(ALS_ITERS, sweep3, FACTORS), **reg)
    hist = rec["als_exact_3"]["history"]
    if not hist[-1]["train"] < hist[0]["train"]:
        fail(f"als_exact_3: train RMSE did not fall: {[h['train'] for h in hist]}")
    beside(rec, "als_exact_3", "als", "train")
    t0 = done("config #3 exact ALS path", t0)
    sd3 = float(data[1].target.std())
    exact_3, counts["exact_3"] = run_learner(MCMCLearner, "exact_3", data, args, rec,
                                             iters=MCMC_ITERS,
                                             want=flat_exact_want(MCMC_ITERS, sweep3, FACTORS))
    if keep is not None:  # the stream phase's resident run
        keep["exact_3"] = exact_3
    del exact_3
    beside(rec, "exact_3", "mcmc")
    got = rec["exact_3"]["history"][-1]["test_all"]
    print(f"exact_3: test_all after {MCMC_ITERS} iterations {got:.6f}, the test targets' "
          f"sd {sd3:.6f}")
    if not got < sd3:
        fail(f"exact_3: test_all {got} is not below the test targets' sd {sd3}")
    t0 = done("config #3 exact MCMC path", t0)
    _, counts["exact_4"] = run_learner(
        MCMCLearner, "exact_4", ctr, args, rec, factors=CTR_FACTORS, iters=CTR_MCMC_ITERS,
        groups=ctr[2], task=1, want=flat_exact_want(CTR_MCMC_ITERS, sweep4, CTR_FACTORS,
                                                    probit=True))
    beside(rec, "exact_4", "mcmc_4")
    share = float((ctr[1].target > 0).mean())
    larger = max(share, 1.0 - share)
    got = rec["exact_4"]["history"][-1]["test_all"]
    print(f"exact_4: test accuracy after {CTR_MCMC_ITERS} iterations {got:.6f}, the larger "
          f"class's share {larger:.6f}")
    if not got > larger:
        fail(f"exact_4: test accuracy {got} is not above the larger class's share {larger}")
    t0 = done("config #4 exact MCMC path", t0)

    c_bs = dict(factors=BS_FACTORS, num_features=ctx["num_features"])
    paths = (("als_exact_bs_ctx", ALSLearner, 0, BS_CTX_ALS_ITERS, reg, "als_bs_ctx"),
             ("exact_bs_ctx", MCMCLearner, 0, BS_CTX_MCMC_ITERS, {}, "mcmc_bs_ctx"),
             ("exact_bs_c", MCMCLearner, 1, BS_CTX_MCMC_ITERS, {}, "mcmc_bs_c"))
    for name, cls, task, iters, kw, vector in paths:
        pair = (ctx["train_c"], ctx["test_c"]) if task else (ctx["train"], ctx["test"])
        _, counts[name] = run_learner(
            cls, name, pair, args, rec, iters=iters, task=task,
            want=bs_exact_want(iters, main_sweep, rel_sweep, BS_FACTORS, probit=bool(task)),
            **kw,
            **c_bs)
        hist = rec[name]["history"]
        beside(rec, name, vector, "train" if cls is ALSLearner else "test_all")
        if cls is ALSLearner and not hist[-1]["train"] < hist[0]["train"]:
            fail(f"{name}: train RMSE did not fall: {[h['train'] for h in hist]}")
        if name == "exact_bs_ctx":
            sd_te = float(pair[1].target.std())
            print(f"{name}: test_all after {iters} iterations {hist[-1]['test_all']:.6f}, "
                  f"the test targets' sd {sd_te:.6f}")
            if not hist[-1]["test_all"] < sd_te:
                fail(f"{name}: test_all {hist[-1]['test_all']} is not below the test "
                     f"targets' sd {sd_te}")
        if name == "exact_bs_c":
            larger = max(ctx["positive_share"], 1.0 - ctx["positive_share"])
            print(f"{name}: test accuracy after {iters} iterations "
                  f"{hist[-1]['test_all']:.6f}, the larger class's share {larger:.6f}")
            if not hist[-1]["test_all"] > larger:
                fail(f"{name}: test accuracy {hist[-1]['test_all']} is not above the "
                     f"larger class's share {larger}")
        t0 = done(f"bench_bs_ctx {name} path", t0)
    # bench_bs's relation: the blocks bench_bs_ctx's relation has
    learner, counts["bs_fallback"] = run_learner(
        ALSVectorLearner, "bs_fallback", (bs["train"], bs["test"]), args, rec,
        iters=BS_CTX_ALS_ITERS, want=bs_exact_want(BS_CTX_ALS_ITERS, 0, rel_sweep,
                                                   BS_FACTORS),
        factors=BS_FACTORS, num_features=BS_NF, flags=dict(bs_vector=False), **reg)
    if learner.relational_mode != "bs":
        fail(f"bs_fallback: routed to {learner.relational_mode}, not the exact BS engine")
    hist = rec["bs_fallback"]["history"]
    if not hist[-1]["train"] < hist[0]["train"]:
        fail(f"bs_fallback: train RMSE did not fall: {[h['train'] for h in hist]}")
    beside(rec, "bs_fallback", "als_bs", "train")
    done("bench_bs exact fallback path", t0)
    return table


# ---- the CLI phase: libfm_tpu_torch/cli.py on the card


# ---- the learner options: the pure linear model (k = 0), checkpoints,
# predict_new and case reordering


def event_ms(fn) -> float:
    """Milliseconds of one run of `fn` between two CUDA events (for a plain
    version that takes seconds, whose host gaps do not matter)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def k0_kernel_checks(args, rec, dev, data, ctr):
    """The options phase's kernel checks: the flat engine's kernels at
    k = 0 (the pure linear model: P = [w], A = [e]) against their plain
    versions on the same inputs, at the shapes the k = 0 paths give them.
    At config #3 (both blocks pass the case-major gate at k = 0: moment
    width 2): fm_refresh's train mode (its test mode on the 1M test rows
    timed beside), case_stats (also against its float64 plain version
    over each entry's sum of magnitudes) and slot_stats on both blocks,
    schur_draw's scalar draw (sampling, the mean checked too; the plain
    version's bits), dense_update and slot_update (the blocks' slots in
    case order) on both blocks. At config #4: fm_refresh's probit mode and
    probit_latent on A's residual at a stride of one float. Returns the
    rows, each with "config" saying where it ran."""
    import numpy as np

    from libfm_tpu_torch.data.batching import conflict_free_blocks, feature_slots
    from libfm_tpu_torch.data.vector_layout import padded_rows_layout
    from libfm_tpu_torch.kernels import case_stats as cs
    from libfm_tpu_torch.kernels import dense_update as du
    from libfm_tpu_torch.kernels import fm_refresh as fr
    from libfm_tpu_torch.kernels import probit_latent as pl
    from libfm_tpu_torch.kernels import schur_draw as sd
    from libfm_tpu_torch.kernels import slot_stats as ss
    from libfm_tpu_torch.kernels import slot_update as su
    from libfm_tpu_torch.learners.mcmc_vector import DevBlock
    from libfm_tpu_torch.ops.samplers import probit_latent as draw

    d, GW = 1, ss.gg_width(0)
    out = []

    def entry(name, replaces, err, tol, ms, plain_ms, nbytes, flops, config, timed,
              source=None):
        row = kernel_row(name, replaces, err, tol, ms, plain_ms, nbytes, flops, None, timed,
                         label=f" (k = 0, {config})", source=source)
        row["config"] = f"{config}, k = 0"
        out.append(row)
        return row

    def padded(ds):
        return [torch.as_tensor(x, device=dev) for x in
                padded_rows_layout(ds.indptr, ds.cols, ds.vals)]

    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    train, test = data[:2]
    n, nc = train.num_features, train.num_rows
    fblocks = conflict_free_blocks(train)
    blocks = [DevBlock(b, np.zeros(len(b.features), np.int32), nc, dev, 0, True)
              for b in fblocks]
    if not all(b.case_major and not b.scatter_update for b in blocks):
        fail("config #3 at k = 0: a block left the case-major route")
    ids, vals = padded(train)
    te_ids, te_vals = padded(test)
    y = torch.as_tensor(train.target, device=dev)
    L, (nt, Lt) = ids.shape[1], te_ids.shape
    P = 0.1 * torch.randn(n, d, generator=g, device=dev)
    w0 = torch.tensor(3.5, device=dev)

    # ---- fm_refresh (train mode; test mode beside)
    kw = dict(min_target=1.0, max_target=5.0)
    A, A_p = torch.empty(nc, d, device=dev), torch.empty(nc, d, device=dev)
    s_k = fr.fm_refresh(P, ids, vals, w0, y, A, **kw)
    s_p = fr.fm_refresh_plain(P, ids, vals, w0, y, A_p, **kw)
    p_k = fr.fm_refresh(P, te_ids, te_vals, w0)
    p_p = fr.fm_refresh_plain(P, te_ids, te_vals, w0)
    torch.cuda.synchronize()
    err = max((A - A_p).abs().max().item(), (p_k - p_p).abs().max().item(),
              abs(s_k.item() - s_p.item()) / max(1.0, abs(s_p.item())))
    row = entry("fm_refresh", "libfm_tpu/learners/mcmc_vector.py:1090-1199", err, 1e-4,
                cuda_ms(lambda: fr.fm_refresh(P, ids, vals, w0, y, A, **kw), args.reps),
                cuda_ms(lambda: fr.fm_refresh_plain(P, ids, vals, w0, y, A_p, **kw),
                        args.reps),
                nbytes=nc * L * 8 + nc * 4 + n * d * 4 + nc * d * 4, flops=nc * (2 * L + 8),
                config="config #3", timed="one train-mode launch (the refresh)")
    row["test_mode_ms"] = cuda_ms(lambda: fr.fm_refresh(P, te_ids, te_vals, w0), args.reps)
    row["test_mode_plain_ms"] = cuda_ms(lambda: fr.fm_refresh_plain(P, te_ids, te_vals, w0),
                                        args.reps)
    row["test_mode_bound_ms"] = bound_ms(nt * Lt * 8 + nt * 4 + n * d * 4, 0)[0]
    print(f"fm_refresh test mode (k = 0): ms={row['test_mode_ms']:.4f} plain_ms="
          f"{row['test_mode_plain_ms']:.4f} bound_ms={row['test_mode_bound_ms']:.4f} (bytes)")
    fr.fm_refresh(P, ids, vals, w0, y, A, **kw)
    del A_p, p_k, p_p
    E = sum(int(b.slot_case.numel()) for b in blocks)
    Fsum = sum(b.F for b in blocks)

    def run_stats(fn, GGs, extra):
        """One iteration's launches of `fn` over both blocks; `extra(b)` the
        block's own keywords."""
        def go():
            for b, G in zip(blocks, GGs):
                fn(A, P, b.feat_off, b.slot_case, b.slot_val, b.feat_id, GG=G, **extra(b))
        return go

    def reference(b):
        """Block b's GG at k = 0 in float64, [aa | ae] = [sum x^2 | sum x e]
        over its slots, and each entry's sum of magnitudes."""
        f = torch.repeat_interleave(torch.arange(b.Fd, device=dev),
                                    b.feat_off[1:] - b.feat_off[:-1])
        c = b.slot_case.long()
        real = (c < nc).double()
        x = b.slot_val.double() * real
        e = A[c.clamp_max(nc - 1), 0].double() * real
        sums = [torch.zeros(b.Fd, dtype=torch.float64, device=dev).index_add_(0, f, v)
                for v in (x * x, x * e, (x * e).abs())]
        return torch.stack(sums[:2], 1), torch.stack([sums[0], sums[2]], 1)

    # ---- case_stats (the k = 0 route) and slot_stats on both blocks
    GG_c = [torch.empty(b.F, GW, device=dev) for b in blocks]
    GG_s = [torch.empty(b.F, GW, device=dev) for b in blocks]
    GG_p = [torch.empty(b.F, GW, device=dev) for b in blocks]
    run_stats(cs.case_stats, GG_c, lambda b: dict(onehot=b.onehot, pieces=b.case_plan))()
    run_stats(ss.slot_stats, GG_s, lambda b: dict(pieces=b.pieces))()
    # the plain version takes seconds here (a one-hot product over 71,567
    # features a chunk of cases): timed on its one checked run
    plain_ms = event_ms(run_stats(cs.case_stats_plain, GG_p, lambda b: dict(onehot=b.onehot)))
    errs, plain_errs = [], []
    for b, Gc, Gs, Gp in zip(blocks, GG_c, GG_s, GG_p):
        errs.append(cs.err_over_magnitudes(Gc, *reference(b)))
        plain_errs += [col_rel_err(Gc, Gp).item(),
                       col_rel_err(Gs, ss.slot_stats_plain(A, P, b.feat_off, b.slot_case,
                                                           b.slot_val, b.feat_id)).item(),
                       col_rel_err(Gs, Gc).item()]
    row = entry("case_stats", "libfm_tpu/learners/mcmc_vector.py:1320-1422", max(errs),
                CASE_STATS_TOL,
                cuda_ms(run_stats(cs.case_stats, GG_c,
                                  lambda b: dict(onehot=b.onehot, pieces=b.case_plan)),
                        args.reps),
                plain_ms,
                # each slot's case and e; each feature's offsets, id and GG row
                nbytes=E * 8 + Fsum * (8 + 4 + GW * 4), flops=E * 32,
                config="config #3", timed="one iteration's launches: one per block")
    row["plain_f32_and_slot_stats_rel_err"] = max(plain_errs)
    print(f"case_stats (k = 0) against float64 over the sums of magnitudes "
          f"{max(errs):.3g} (tol {CASE_STATS_TOL:g}); against the float32 plain version and "
          f"slot_stats, per column {max(plain_errs):.3g} (tol 1e-4)")
    if not max(plain_errs) <= 1e-4:
        fail(f"case_stats / slot_stats at k = 0 disagree: {max(plain_errs)}")
    entry("slot_stats", "libfm_tpu/learners/mcmc_vector.py:1277-1289, 1428-1492",
          max(col_rel_err(Gs, ss.slot_stats_plain(A, P, b.feat_off, b.slot_case, b.slot_val,
                                                  b.feat_id)).item()
              for b, Gs in zip(blocks, GG_s)), 1e-4,
          cuda_ms(run_stats(ss.slot_stats, GG_s, lambda b: dict(pieces=b.pieces)), args.reps),
          cuda_ms(run_stats(ss.slot_stats_plain, GG_s, lambda b: {}), args.reps, warmup=1),
          nbytes=E * (8 + d * 4) + Fsum * (4 + 8 + GW * 4), flops=E * 8,
          config="config #3", timed="one iteration's launches: one per block")

    # ---- schur_draw: the scalar conjugate draw (sampling; the mean too)
    alpha = torch.tensor(2.0, device=dev)
    sys_in = []
    for b, G in zip(blocks, GG_c):
        sys_in.append((G, P[b.features].contiguous(), torch.full((b.F, d), 5.0, device=dev),
                       0.01 * torch.randn(b.F, d, generator=g, device=dev),
                       torch.randn(b.F, d, generator=g, device=dev)))
    bound, errs = 1e6 * 5.0, []
    for G, theta, lam, mu, z in sys_in:
        for samp in (True, False):
            tk, rk = sd.schur_draw(G, theta, lam, mu, z, alpha, do_sample=samp, bound=bound)
            tp, rp = sd.schur_draw_plain(G, theta, lam, mu, z, alpha, do_sample=samp,
                                         bound=bound)
            torch.cuda.synchronize()
            if not torch.equal(rk, rp):
                fail("schur_draw (k = 0): reject flags differ from the plain version")
            errs.append(((tk - tp).abs().max() / tp.abs().max().clamp_min(1.0)).item())

    def run_draw(fn):
        def go():
            for G, theta, lam, mu, z in sys_in:
                fn(G, theta, lam, mu, z, alpha, do_sample=True, bound=bound)
        return go

    entry("schur_draw", "libfm_tpu/learners/mcmc_vector.py:1561-1578", max(errs), 1e-6,
          cuda_ms(run_draw(sd.schur_draw), args.reps),
          cuda_ms(run_draw(sd.schur_draw_plain), args.reps),
          nbytes=Fsum * (GW * 4 + 5 * d * 4 + 4), flops=Fsum * 12, config="config #3",
          timed="one iteration's launches: one per block")

    # ---- dense_update and slot_update (the blocks' slots in case order)
    tabs = []
    for G, theta, lam, mu, z in sys_in:
        tnew, _ = sd.schur_draw(G, theta, lam, mu, z, alpha, do_sample=True, bound=bound)
        tabs.append(du.update_table(theta, tnew))
    A_k, A_p = A.clone(), A.clone()
    for b, tab in zip(blocks, tabs):
        du.dense_update(A_k, b.up_col, b.up_val, tab)
        du.dense_update_plain(A_p, b.up_col, b.up_val, tab)
    torch.cuda.synchronize()

    def run_upd(fn, A_):
        def go():
            for b, tab in zip(blocks, tabs):
                fn(A_, b.up_col, b.up_val, tab)
        return go

    covered = sum(int((b.up_col != b.F).sum().item()) for b in blocks)
    tab_bytes = sum((b.F + 1) * (d + 1) * 4 for b in blocks)
    A_dense = A_k.clone()  # the timed launches below update A_k again
    entry("dense_update", "libfm_tpu/learners/mcmc_vector.py:1766-1791",
          (A_k - A_p).abs().max().item(), 1e-4,
          cuda_ms(run_upd(du.dense_update, A_k), args.reps),
          cuda_ms(run_upd(du.dense_update_plain, A_p), args.reps),
          nbytes=len(blocks) * nc * 4 + covered * d * 8 + tab_bytes, flops=covered * 6,
          config="config #3", timed="one iteration's launches: one per block")
    lists = []
    for fb in fblocks:
        off, sc, sv = feature_slots(fb)
        lists.append([torch.as_tensor(x, device=dev) for x in su.case_order(
            sc, sv, np.repeat(np.arange(len(fb.features), dtype=np.int32), np.diff(off)))])
    S_k, S_p = A.clone(), A.clone()
    for lst, tab in zip(lists, tabs):
        su.slot_update(S_k, *lst, tab)
        su.slot_update_plain(S_p, *lst, tab)
    torch.cuda.synchronize()
    err = max(col_rel_err(S_k, S_p).item(), col_rel_err(S_k, A_dense).item())

    def run_slots(fn, A_):
        def go():
            for lst, tab in zip(lists, tabs):
                fn(A_, *lst, tab)
        return go

    entry("slot_update", "libfm_tpu/learners/mcmc_vector.py:1842-1865", err, 1e-5,
          cuda_ms(run_slots(su.slot_update, S_k), args.reps),
          cuda_ms(run_slots(su.slot_update_plain, S_p), args.reps),
          nbytes=E * (2 * d * 4 + 12) + tab_bytes, flops=E * 6, config="config #3",
          timed="one iteration's launches (dense_update=False): one per block")
    print(f"k = 0's own update kernels at config #3 against the tiled and staged kernels' "
          f"k = 0 instances: dense_update {out[-2]['ms']:.4f} ms (first version "
          f"{K0_FIRST_MS['dense_update']}), slot_update {out[-1]['ms']:.4f} (first version "
          f"{K0_FIRST_MS['slot_update']}; PERF.md, on an H100 80GB HBM3 at 700 W)")
    del A, A_k, A_p, A_dense, S_k, S_p, GG_c, GG_s, GG_p, sys_in, tabs, lists, blocks, fblocks
    del ids, vals

    # ---- config #4: fm_refresh's probit mode and probit_latent at d = 1
    train4 = ctr[0]
    n4, nc4 = train4.num_features, train4.num_rows
    ids4, vals4 = padded(train4)
    y4 = torch.as_tensor(train4.target, device=dev)
    L4 = ids4.shape[1]
    P4 = 0.1 * torch.randn(n4, d, generator=g, device=dev)
    w04 = torch.tensor(0.1, device=dev)
    U = torch.rand(nc4, generator=g, device=dev)
    cases, errs = {}, []
    for mode, u in (("sample", U), ("mean", None)):
        A_k, A_p = torch.empty(nc4, d, device=dev), torch.empty(nc4, d, device=dev)
        lat_k, lat_p = torch.empty(nc4, device=dev), torch.empty(nc4, device=dev)
        c_k = fr.fm_refresh(P4, ids4, vals4, w04, y4, A_k, probit=mode, U=u, latent=lat_k)
        c_p = fr.fm_refresh_plain(P4, ids4, vals4, w04, y4, A_p, probit=mode, U=u,
                                  latent=lat_p)
        torch.cuda.synchronize()
        pred_k = A_k[:, 0] + lat_k
        lat_ref = draw(pred_k, y4, u)
        near = ((lat_ref - pred_k).abs() <= LATENT_CHECKED if u is not None
                else torch.ones_like(y4, dtype=torch.bool))
        errs.append(max((pred_k - (A_p[:, 0] + lat_p)).abs().max().item(),
                        ((lat_k - lat_ref).abs() / lat_ref.abs().clamp_min(1.0))[near]
                        .max().item(),
                        float(not ((lat_k >= 0) == (y4 >= 0)).all())))
        cases[mode] = dict(
            correct_kernel=c_k.item(), correct_plain=c_p.item(),
            ms=cuda_ms(lambda: fr.fm_refresh(P4, ids4, vals4, w04, y4, A_k, probit=mode, U=u,
                                             latent=lat_k), args.reps),
            plain_ms=cuda_ms(lambda: fr.fm_refresh_plain(P4, ids4, vals4, w04, y4, A_p,
                                                         probit=mode, U=u, latent=lat_p),
                             args.reps))
    row = entry("fm_refresh_probit", "libfm_tpu/learners/mcmc_vector.py:1136-1166", max(errs),
                1e-4, cases["sample"]["ms"], cases["sample"]["plain_ms"],
                nbytes=nc4 * L4 * 8 + nc4 * 4 * 3 + n4 * d * 4 + nc4 * d * 4,
                flops=nc4 * (2 * L4 + 48), config="config #4",
                timed="one probit train-mode launch (sampling)",
                source="libfm_tpu_torch/csrc/fm_refresh.cu")
    row["cases"] = cases
    cases, errs = {}, []
    for mode, u in (("sample", U), ("mean", None)):
        A_k, A_p, A_2 = A_k.clone(), A_k.clone(), A_k.clone()
        l_k, l_p, l_2 = lat_k.clone(), lat_k.clone(), lat_k.clone()
        out_k = pl.probit_latent(A_k, l_k, y4, u)
        c_p, se_p, se2_p = pl.probit_latent_plain(A_p, l_p, y4, u)
        out_2 = pl.probit_latent(A_2, l_2, y4, u)
        torch.cuda.synchronize()
        repeat_check(f"probit_latent count and sums, config #4, k = 0 ({mode})", out_k,
                     out_2, rec)
        c_k, se_k, se2_k = out_k
        errs.append(max(((l_k - l_p).abs() / l_p.abs().clamp_min(1.0)).max().item(),
                        ((A_k[:, 0] - A_p[:, 0]).abs() / A_p[:, 0].abs().clamp_min(1.0))
                        .max().item(), abs(c_k.item() - c_p.item()),
                        abs(se_k.item() - se_p.item()) / A_p[:, 0].abs().sum().item(),
                        abs(se2_k.item() - se2_p.item()) / se2_p.item()))
        cases[mode] = dict(ms=cuda_ms(lambda: pl.probit_latent(A_k, l_k, y4, u), args.reps),
                           plain_ms=cuda_ms(lambda: pl.probit_latent_plain(A_p, l_p, y4, u),
                                            args.reps))
    # e, and the latents, read and written; y and U read
    row = entry("probit_latent", "libfm_tpu/learners/mcmc_vector.py:2033-2076", max(errs),
                1e-5, cases["sample"]["ms"], cases["sample"]["plain_ms"],
                nbytes=nc4 * 4 * 6, flops=nc4 * 60, config="config #4",
                timed="one launch (sampling)")
    row["cases"] = cases
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def checkpoint_clock(times):
    """Time every checkpoint save and restore of the learners (host clock,
    the card synchronised), appending ("save" | "load", seconds) to
    `times`."""
    from libfm_tpu_torch.learners.mcmc import MCMCLearner

    save, restore = MCMCLearner._save_checkpoint, MCMCLearner._maybe_restore

    def timed(kind, fn):
        def wrapper(self, *a):
            t0 = time.perf_counter()
            out = fn(self, *a)
            torch.cuda.synchronize()
            if kind == "save" or out:
                times.append((kind, time.perf_counter() - t0))
            return out
        return wrapper

    MCMCLearner._save_checkpoint = timed("save", save)
    MCMCLearner._maybe_restore = timed("load", restore)
    try:
        yield
    finally:
        MCMCLearner._save_checkpoint, MCMCLearner._maybe_restore = save, restore


def resume_check(args, rec, counts, tmp, config, data, straight, half, tol, **kw):
    """A chain saved at iteration `half` (run "ckpt_save_<config>") and
    resumed from that file twice to the end of the straight run
    `straight` (runs "ckpt_resume_<config>" and "..._again"): the two
    resumes must end in the same bits and read the same at every
    iteration, and lie within `tol` of the straight run's test_this and
    test_all. Prints the file's size and the save and load seconds."""
    from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner

    path = os.path.join(tmp, f"{config}.npz")
    full = len(rec[straight]["history"])
    times = []
    with checkpoint_clock(times):
        _, counts[f"ckpt_save_{config}"] = run_learner(
            MCMCVectorLearner, f"ckpt_save_{config}", data, args, rec, iters=half,
            exact=False, learner_kw=dict(checkpoint_path=path, checkpoint_every=half), **kw)
        size = os.path.getsize(path)
        runs = []
        for name in (f"ckpt_resume_{config}", f"ckpt_resume_again_{config}"):
            learner, counts[name] = run_learner(
                MCMCVectorLearner, name, data, args, rec, iters=full, exact=False,
                learner_kw=dict(checkpoint_path=path), **kw)
            runs.append(learner._final_state)
    a, b = (rec[f"ckpt_resume{s}_{config}"]["history"] for s in ("", "_again"))
    base = rec[straight]["history"][half:]
    if [h["iter"] for h in a] != list(range(half, full)):
        fail(f"ckpt_resume_{config} did not resume at iteration {half}: "
             f"{[h['iter'] for h in a]}")
    same = (all(torch.equal(runs[0][key], runs[1][key]) for key in REPRO_KEYS)
            and [h["test_all"] for h in a] == [h["test_all"] for h in b])
    diff = max(abs(h[key] - s[key]) for h, s in zip(a, base, strict=True)
               for key in ("test_this", "test_all"))
    out = dict(file_bytes=size, seconds=times, same_bits=same, from_straight=diff, tol=tol)
    rec[f"ckpt_{config}"] = out
    print(f"checkpoint at {config}: saved at iteration {half} ({size} bytes; save and load "
          f"seconds {[(k_, round(s_, 3)) for k_, s_ in times]}), resumed to {full} twice: "
          f"the same bits {same}; test_this / test_all within {diff:.3g} of the straight "
          f"run {straight} (tol {tol:g}); test_all {[round(h['test_all'], 6) for h in a]} "
          f"against {[round(h['test_all'], 6) for h in base]}")
    if not same:
        fail(f"{config}: two resumes from one checkpoint end in other bits")
    if not diff <= tol:
        fail(f"{config}: the resumed chain lies {diff} from the straight one (> {tol})")
    os.remove(path)
    return out


def run_options(args, rec, dev, counts, done, data, ctr, bs):
    """The options phase: the k = 0 kernel checks (returns their rows), then
    on the card at the configs' full widths, each path's launches into
    `counts`: k = 0 ALS 3 and MCMC 4 at config #3 on the default route,
    MCMC 2 there with case_major_stats=False and with dense_update=False,
    probit MCMC 3 at config #4 and exact MCMC 2 at config #3; a checkpoint
    at iteration 4 of MCMC at #3 and #4 and at iteration 12 at bench_bs,
    resumed twice to 8 (24 at bench_bs: the mcmc_bs run is the straight
    one, where it ran); predict_new after ALS 3 at #3 (against predict(),
    the same bits) and at bench_bs (chunked against unchunked, the same
    bits); ALS 3 at #3 with case reordering against the same run without
    (case_major_stats=False: within 2e-4)."""
    import tempfile

    import numpy as np

    from libfm_tpu_torch import kernels
    from libfm_tpu_torch.learners.mcmc import MCMCLearner
    from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner, MCMCVectorLearner

    t0 = time.perf_counter()
    table = k0_kernel_checks(args, rec, dev, data, ctr)
    t0 = done("options: k = 0 kernel checks", t0)

    # ---- the pure linear model's paths
    k0 = dict(factors=0)
    routes = (
        ("als_k0_3", ALSVectorLearner, OPT_K0_ALS_ITERS, dict(regw=5.0, regv=5.0), {}),
        ("mcmc_k0_3", MCMCVectorLearner, OPT_K0_MCMC_ITERS, {}, {}),
        ("mcmc_k0_slot_3", MCMCVectorLearner, OPT_K0_SHORT_ITERS, {},
         dict(case_major_stats=False)),
        ("mcmc_k0_scatter_3", MCMCVectorLearner, OPT_K0_SHORT_ITERS, {},
         dict(dense_update=False)),
    )
    for name, cls, iters, cfg_kw, learner_kw in routes:
        stats = "case_stats" if not learner_kw else "slot_stats"
        update = "slot_update" if "dense_update" in learner_kw else "dense_update"
        run_learner(cls, name, data, args, rec, iters=iters, learner_kw=learner_kw,
                    per_iter={stats: 2, "schur_draw": 2, update: 2}, **k0, **cfg_kw)
        counts[name] = rec[name]["launches"]
        hist = rec[name]["history"]
        print(f"{name}: test RMSE (test_all) by iteration "
              f"{[round(h['test_all'], 6) for h in hist]}; seconds an iteration "
              f"{[round(h['time'], 6) for h in hist]}")
        t0 = done(f"options: {name} path", t0)
    _, counts["mcmc_k0_4"] = run_learner(
        MCMCVectorLearner, "mcmc_k0_4", ctr, args, rec, iters=OPT_K0_PROBIT_ITERS,
        groups=ctr[2], task=1,
        per_iter=dict(case_stats=CTR_FIELDS, schur_draw=CTR_FIELDS, dense_update=CTR_FIELDS),
        **k0)
    t0 = done("options: mcmc_k0_4 path", t0)
    # the w sweep only: one coord_draw launch a block at #3 (no long feature)
    _, counts["exact_k0_3"] = run_learner(
        MCMCLearner, "exact_k0_3", data, args, rec, iters=OPT_K0_SHORT_ITERS,
        want=flat_exact_want(OPT_K0_SHORT_ITERS, 2, 0), **k0)
    t0 = done("options: exact_k0_3 path", t0)

    # ---- checkpoints: saved, resumed twice, against the straight chain
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        _, counts["ckpt_straight_3"] = run_learner(
            MCMCVectorLearner, "ckpt_straight_3", data, args, rec, iters=2 * OPT_CKPT_HALF,
            exact=False)
        resume_check(args, rec, counts, tmp, "3", data, "ckpt_straight_3", OPT_CKPT_HALF,
                     OPT_RESUME_TOL)
        t0 = done("options: checkpoint at config #3", t0)
        c4 = dict(factors=CTR_FACTORS, groups=ctr[2], task=1)
        _, counts["ckpt_straight_4"] = run_learner(
            MCMCVectorLearner, "ckpt_straight_4", ctr, args, rec, iters=2 * OPT_CKPT_HALF,
            exact=False, **c4)
        resume_check(args, rec, counts, tmp, "4", ctr, "ckpt_straight_4", OPT_CKPT_HALF,
                     OPT_RESUME_PROBIT_TOL, **c4)
        t0 = done("options: checkpoint at config #4", t0)
        c_bs = dict(factors=BS_FACTORS, num_features=BS_NF)
        bs_data_ = (bs["train"], bs["test"])
        if "mcmc_bs" not in rec:
            _, counts["mcmc_bs"] = run_learner(
                MCMCVectorLearner, "mcmc_bs", bs_data_, args, rec, iters=BS_MCMC_ITERS,
                want=bs_want(BS_MCMC_ITERS, bs["blocks"], True), **c_bs)
        resume_check(args, rec, counts, tmp, "bs", bs_data_, "mcmc_bs", OPT_BS_HALF,
                     OPT_RESUME_BS_TOL, **c_bs)
        t0 = done("options: checkpoint at bench_bs", t0)

    # ---- predict_new after ALS: #3 (against predict()), bench_bs (chunked)
    als3, counts["als_pn_3"] = run_learner(
        ALSVectorLearner, "als_pn_3", data, args, rec, iters=ALS_ITERS, regw=5.0, regv=5.0,
        learner_kw=dict(case_major_stats=False))
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    new = als3.predict_new(data[1])
    pn_seconds = time.perf_counter() - t1
    counts["predict_new_3"] = kernels.launch_counts()
    check_launches("predict_new_3", counts["predict_new_3"])
    same = np.array_equal(new, als3.predict())
    rec["predict_new_3"] = dict(seconds=pn_seconds, same_bits_as_predict=same,
                                rows=len(new))
    print(f"predict_new at config #3 after ALS 3: {len(new)} rows in {pn_seconds:.3f} s "
          f"({counts['predict_new_3']['fm_refresh']} fm_refresh launches); equal to "
          f"predict() bit for bit: {same}")
    if not same:
        fail("predict_new after ALS differs from predict() at config #3")
    t0 = done("options: predict_new at config #3", t0)
    learner, counts["als_pn_bs"] = run_learner(
        ALSVectorLearner, "als_pn_bs", (bs["train"], bs["test"]), args, rec,
        iters=OPT_BS_ALS_ITERS, want=bs_want(OPT_BS_ALS_ITERS, bs["blocks"], True),
        regw=5.0, regv=5.0, factors=BS_FACTORS, num_features=BS_NF)
    kernels.reset_launch_counts()
    full = learner.predict_new(bs["test"])
    learner.predict_expand_cap = OPT_PREDICT_CAP
    chunked = learner.predict_new(bs["test"])
    counts["predict_new_bs"] = kernels.launch_counts()
    check_launches("predict_new_bs", counts["predict_new_bs"])
    same = np.array_equal(full, chunked)
    gap = float(np.abs(full - learner.predict()).max())
    rec["predict_new_bs"] = dict(same_bits_chunked=same, from_predict=gap)
    print(f"predict_new at bench_bs after ALS {OPT_BS_ALS_ITERS}: chunked (cap "
          f"{OPT_PREDICT_CAP} entries) equal to unchunked bit for bit: {same}; largest "
          f"distance from predict() {gap:.3g} (tol 5e-3: the deferred path's test "
          f"prediction is the tail plus SD)")
    if not same or not gap <= 5e-3:
        fail(f"predict_new at bench_bs: chunked the same bits {same}, from predict() {gap}")
    del learner
    t0 = done("options: predict_new at bench_bs", t0)

    # ---- case reordering at #3 (the slot path), against als_pn_3
    learner, counts["als_reorder_3"] = run_learner(
        ALSVectorLearner, "als_reorder_3", data, args, rec, iters=ALS_ITERS, regw=5.0,
        regv=5.0,
        learner_kw=dict(case_major_stats=False), flags=dict(case_reorder=True))
    if not learner._case_reordered:
        fail("als_reorder_3: the cases were not reordered")
    a, b = rec["als_pn_3"]["history"], rec["als_reorder_3"]["history"]
    diff = max(abs(x[key] - y[key]) for x, y in zip(a, b, strict=True)
               for key in ("train", "test_this", "test_all"))
    rec["als_reorder_3"]["from_unordered"] = diff
    print(f"als_reorder_3: readings within {diff:.3g} of als_pn_3's (tol {OPT_REORDER_TOL:g});"
          f" seconds an iteration {[round(h['time'], 6) for h in b]} against "
          f"{[round(h['time'], 6) for h in a]}")
    if not diff <= OPT_REORDER_TOL:
        fail(f"case reordering moved the ALS readings by {diff} (> {OPT_REORDER_TOL})")
    del learner, als3
    done("options: case reordering at config #3", t0)
    torch.cuda.empty_cache()
    return table


def cli_run(name, argv, counts):
    """One command line through libfm_tpu_torch.cli.main (the entry point
    of `python -m libfm_tpu_torch.cli`) on the card, its launches added to
    counts[name]. Fails unless it exits 0. Returns (its learner, its
    launches, its seconds)."""
    from libfm_tpu_torch import cli, kernels

    runs = []
    print(f"{name}: python -m libfm_tpu_torch.cli {' '.join(argv)}")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv, runs=runs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = kernels.launch_counts()
    if rc != 0:
        fail(f"{name}: the CLI exited {rc}")
    prev = counts.get(name)
    counts[name] = got if prev is None else {key: prev[key] + v for key, v in got.items()}
    print(f"{name}: exit 0 in {secs:.2f} s (loading included); launches "
          f"{ {key: v for key, v in got.items() if v} }")
    check_launches(name, got)
    return runs[0], got, secs


def cli_twin(learner, data):
    """Run `learner` (built with the arguments the CLI derives) in process
    on `data`; returns its launches."""
    from libfm_tpu_torch import kernels

    kernels.reset_launch_counts()
    learner.learn(*data)
    torch.cuda.synchronize()
    return kernels.launch_counts()


def cli_seconds(learner):
    """A learner's seconds an iteration (MCMC, ALS) or epoch (SGD)."""
    return [round(h["time"] if isinstance(h, dict) else h[-1], 6) for h in learner.history]


def cli_same(name, got, want, got_counts, want_counts, rec):
    """Fail unless the CLI's run and the in-process one read the same at
    every iteration (every metric but the seconds), end in the same bits
    and made the same launches."""
    def readings(hist):
        if hist and isinstance(hist[0], dict):
            return [{key: v for key, v in h.items() if key != "time"} for h in hist]
        return [h[:-1] for h in hist]  # SGD: (train, test, seconds)

    same_readings = readings(got.history) == readings(want.history)
    if hasattr(want, "_final_state"):
        a, b = got._final_state, want._final_state
        differ = [key for key in REPRO_KEYS if key in b and not torch.equal(a[key], b[key])]
    else:
        differ = [key for key in ("w0", "w", "v")
                  if not torch.equal(getattr(got.params, key), getattr(want.params, key))]
    same_launches = got_counts == want_counts
    rec[name] = dict(history=got.history, same_readings=same_readings,
                     same_bits=not differ, same_launches=same_launches,
                     seconds=cli_seconds(got), in_process_seconds=cli_seconds(want))
    print(f"{name}: readings equal to the in-process run's at every iteration: "
          f"{same_readings}; final state the same bits: {not differ}; launches equal: "
          f"{same_launches}; seconds an iteration or epoch {rec[name]['seconds']} "
          f"(in process {rec[name]['in_process_seconds']})")
    if not same_readings:
        fail(f"{name}: readings {readings(got.history)} against the in-process "
             f"{readings(want.history)}")
    if differ:
        fail(f"{name}: the final state differs from the in-process run's: {differ}")
    if not same_launches:
        fail(f"{name}: launches {got_counts} against the in-process {want_counts}")


def cli_rlog(name, path, rows, must):
    """The rlog's header and rows: fails unless it has `rows` rows and the
    columns `must`, each finite on every row. Returns the rows as dicts."""
    import numpy as np

    lines = open(path).read().splitlines()
    header = lines[0].split("\t")
    table = [dict(zip(header, (float(x) for x in line.split("\t")))) for line in lines[1:]]
    missing = [c for c in must if c not in header]
    if len(table) != rows or missing:
        fail(f"{name}: rlog has {len(table)} rows (want {rows}), missing columns {missing}")
    bad = [c for c in must for r in table if not np.isfinite(r[c])]
    if bad:
        fail(f"{name}: rlog columns not finite: {sorted(set(bad))}")
    print(f"{name}: rlog {len(header)} columns, {rows} rows; first row "
          f"{ {c: table[0][c] for c in must[:6]} }")
    return table


def run_cli(args, rec, dev, counts, done, data, bs, files=None):
    """The CLI phase: `python -m libfm_tpu_torch.cli` as a user runs it,
    through cli.main on the card, on binary files written here (#3's data
    and bench_bs's relation; into the directory `files` where given, else
    a temporary one), each run's launches into `counts` (paths cli_3,
    cli_als_3, cli_bs, cli_sgd_1) and held against the same learner run in
    process with the arguments the CLI derives."""
    import tempfile

    import numpy as np

    from libfm_tpu_torch.data import binary as binio
    from libfm_tpu_torch.data.dataset import Dataset
    from libfm_tpu_torch.data.relation import RelationData, RelationJoin
    from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner, MCMCVectorLearner
    from libfm_tpu_torch.learners.sgd import SGDLearner
    from libfm_tpu_torch.models.fm import FMConfig

    t_phase = t0 = time.perf_counter()
    out = rec["cli_phase"] = {}
    train, test = data[:2]
    n = max(train.num_features, test.num_features, 1)
    with (contextlib.nullcontext(files) if files
          else tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")) as tmp:
        # ---- 1. #3's data to binary and back
        ml = os.path.join(tmp, "ml")
        t = time.perf_counter()
        train.to_binary(ml + ".train", with_transpose=False)
        test.to_binary(ml + ".test", with_transpose=False)
        out["binary_write_seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        back = Dataset.load(ml + ".train"), Dataset.load(ml + ".test")
        out["binary_load_seconds"] = time.perf_counter() - t
        same = all(np.array_equal(getattr(a, f), getattr(b, f)) and
                   getattr(a, f).dtype == getattr(b, f).dtype
                   for a, b in zip((train, test), back)
                   for f in ("indptr", "cols", "vals", "target"))
        same = same and all(a.num_features == b.num_features
                            for a, b in zip((train, test), back))
        rows = train.num_rows + test.num_rows
        print(f"cli: #3's {rows} rows ({train.nnz + test.nnz} entries) written to binary "
              f".x/.y in {out['binary_write_seconds']:.3f} s, loaded in "
              f"{out['binary_load_seconds']:.3f} s; the same arrays: {same}")
        if not same:
            fail("cli: #3's data read back from binary differs")
        del back
        t0 = done("CLI: #3's data to binary and back", t0)

        # ---- 2. MCMC at #3: -out, -rlog, -verbosity
        pred, rlog = os.path.join(tmp, "pred.txt"), os.path.join(tmp, "mcmc.tsv")
        files = ["-train", ml + ".train", "-test", ml + ".test", "-seed", str(SEED)]
        got, got_counts, secs = cli_run("cli_3", [
            "-task", "r", *files, "-method", "mcmc", "-dim", f"1,1,{FACTORS}",
            "-iter", str(CLI_MCMC_ITERS), "-out", pred, "-rlog", rlog, "-verbosity", "1",
        ], counts)
        twin = MCMCVectorLearner(FMConfig(num_features=n, num_factors=FACTORS), task=0,
                                 num_iter=CLI_MCMC_ITERS, num_eval_cases=None, seed=SEED,
                                 attr_group=np.zeros(n, np.int32), refresh_every=None,
                                 verbose=False, device=dev)
        twin.set_regularization([], 1)
        cli_same("cli_3", got, twin, got_counts, cli_twin(twin, (train, test)), rec)
        out["cli_3_seconds"] = secs
        p = np.loadtxt(pred, dtype=np.float64)
        want_p = twin.predict(test)
        lo, hi = train.min_target, train.max_target
        ok = (p.shape == (test.num_rows,) and np.isfinite(p).all() and p.min() >= lo
              and p.max() <= hi and np.allclose(p, want_p, rtol=1e-5, atol=0))
        print(f"cli_3: -out {p.shape[0]} lines, in [{p.min():.6g}, {p.max():.6g}] "
              f"(targets {lo:g}-{hi:g}), the in-process predict() to 6 digits: {ok}")
        if not ok:
            fail("cli_3: -out is not the learner's predictions")
        must = ["time_learn", "time_learn2", "time_learn4", "rmse", "alpha", "wmu[0]",
                *(f"{c}[0,{f}]" for c in ("vmu", "vlambda") for f in range(FACTORS))]
        table = cli_rlog("cli_3", rlog, CLI_MCMC_ITERS, must)
        if [f"{r['rmse']:.6g}" for r in table] != [f"{h['test_all']:.6g}"
                                                   for h in got.history]:
            fail("cli_3: the rlog's rmse is not the run's test_all")
        del got, twin
        torch.cuda.empty_cache()
        t0 = done("CLI: MCMC at #3 and its in-process twin", t0)

        # ---- 3. ALS at #3 with -save_model, then with -load_model
        model = os.path.join(tmp, "als3.model")
        als = ["-task", "r", *files, "-method", "als", "-dim", f"1,1,{FACTORS}",
               "-iter", str(CLI_ALS_ITERS), "-regular", "0,5,5"]
        for flag in ("-save_model", "-load_model"):
            got, got_counts, secs = cli_run("cli_als_3", als + [flag, model], counts)
            out[f"cli_als_3{flag}_seconds"] = secs
            bad = [h["iter"] for h in got.history
                   if not all(np.isfinite(h[key]) for key in ("train", "test_all"))]
            want_k = 2 * CLI_ALS_ITERS
            rec[f"cli_als_3{flag}"] = dict(history=got.history, seconds=cli_seconds(got))
            print(f"cli_als_3 {flag}: test_all {[h['test_all'] for h in got.history]}; "
                  f"seconds an iteration {cli_seconds(got)}")
            if bad or got_counts["slot_stats"] != want_k or got_counts["schur_draw"] != want_k:
                fail(f"cli_als_3 {flag}: non-finite at {bad} or launches {got_counts}")
            if flag == "-save_model":
                lines = open(model).read().split("\n")
                vrows = lines[lines.index("#pairwise interactions Vj,f") + 1:][:n]
                ok = len(vrows) == n and all(len(r.split(" ")) == FACTORS for r in vrows)
                print(f"cli_als_3: model file {os.path.getsize(model)} B, {len(vrows)} V "
                      f"rows of {FACTORS} values: {ok}")
                if not ok:
                    fail("cli_als_3: the saved model does not hold n rows of k values")
            del got
        t0 = done("CLI: ALS at #3, -save_model then -load_model", t0)

        # ---- 4. bench_bs through -relation: binary block, binary join maps
        bsp = os.path.join(tmp, "bs")
        join_tr, join_te = bs["train"].relations[0], bs["test"].relations[0]
        rd = join_tr.data
        RelationData(rd.indptr, rd.cols, rd.vals, rd.num_features).save(bsp + ".rel")
        binio.write_dvector_binary(bsp + ".rel.train", join_tr.row_map.astype(np.uint32))
        binio.write_dvector_binary(bsp + ".rel.test", join_te.row_map.astype(np.uint32))
        bs["train"].to_binary(bsp + ".train", with_transpose=False)
        bs["test"].to_binary(bsp + ".test", with_transpose=False)
        got, got_counts, secs = cli_run("cli_bs", [
            "-task", "r", "-train", bsp + ".train", "-test", bsp + ".test",
            "-relation", bsp + ".rel", "-method", "als", "-dim", f"1,1,{BS_FACTORS}",
            "-iter", str(CLI_BS_ITERS), "-regular", "0,5,5", "-seed", str(SEED),
        ], counts)
        out["cli_bs_seconds"] = secs
        # what the CLI derives: the main table has no feature, so one
        # attribute (group 0), and the relation's features from 1 on (group 1)
        rd1 = RelationData(rd.indptr, rd.cols, rd.vals, rd.num_features)
        rd1.attr_offset = 1
        twin_data = []
        for ds, join in ((bs["train"], join_tr), (bs["test"], join_te)):
            d1 = Dataset(ds.indptr, ds.cols, ds.vals, ds.target, ds.num_features)
            d1.relations = [RelationJoin(rd1, join.row_map)]
            twin_data.append(d1)
        nb = 1 + rd.num_features
        groups = np.ones(nb, np.int32)
        groups[0] = 0
        twin = ALSVectorLearner(
            FMConfig(num_features=nb, num_factors=BS_FACTORS, regw=5.0, regv=5.0),
            task=0, num_iter=CLI_BS_ITERS, num_eval_cases=None, seed=SEED,
            attr_group=groups, refresh_every=None, verbose=False, device=dev)
        twin.set_regularization([0.0, 5.0, 5.0], 2)
        cli_same("cli_bs", got, twin, got_counts, cli_twin(twin, twin_data), rec)
        print(f"cli_bs: relational_mode {got.relational_mode} (in process "
              f"{twin.relational_mode}); test_all {[h['test_all'] for h in got.history]}")
        if got.relational_mode != "bs_vector":
            fail(f"cli_bs: routed to {got.relational_mode}")
        del got, twin, twin_data
        t0 = done("CLI: ALS at bench_bs through -relation and its twin", t0)

        # ---- 5. SGD at #1's settings with -rlog
        c = SGD_CONFIGS["sgd_1"]
        rlog = os.path.join(tmp, "sgd.tsv")
        got, got_counts, secs = cli_run("cli_sgd_1", [
            "-task", "r", *files, "-method", "sgd", "-dim", f"1,1,{c['k']}",
            "-learn_rate", str(c["lr"]), "-regular", f"0,{c['regw']},{c['regv']}",
            "-batch_size", str(c["batch"]), "-iter", str(CLI_SGD_EPOCHS), "-rlog", rlog,
        ], counts)
        out["cli_sgd_1_seconds"] = secs
        twin = SGDLearner(FMConfig(num_features=n, num_factors=c["k"], regw=c["regw"],
                                   regv=c["regv"]),
                          task=0, num_iter=CLI_SGD_EPOCHS, learn_rates=(c["lr"],) * 3,
                          batch_size=c["batch"], seed=SEED, verbose=False, device=dev)
        cli_same("cli_sgd_1", got, twin, got_counts, cli_twin(twin, (train, test)), rec)
        cli_rlog("cli_sgd_1", rlog, CLI_SGD_EPOCHS,
                 ["rmse", "mae", "time_pred", "time_learn", "time_learn4", "rmse_train"])
        del got, twin
        done("CLI: SGD at #1 and its twin", t0)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"cli: the CLI phase took {out['seconds']:.1f} s")


def stream_epochs(name, learner, data, counts, rec):
    """One SGD or SGDA run (`learn` or `learn_stream` on `data`) as path
    `name`; returns (its history, its launches)."""
    from libfm_tpu_torch import kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    fn = learner.learn_stream if name.startswith("stream") else learner.learn
    hist = fn(*data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts[name] = kernels.launch_counts()
    secs = [h[-1] for h in hist]
    rec[name] = dict(history=hist, launches=counts[name], learn_seconds=wall,
                     setup_seconds=wall - sum(secs))
    print(f"{name}: launches { {k: v for k, v in counts[name].items() if v} }; learn "
          f"{wall:.2f} s, of which set-up and evaluation {wall - sum(secs):.2f} s; per-epoch "
          f"s {secs}; test readings {[h[1] for h in hist]}")
    check_launches(name, counts[name])
    return hist, counts[name]


def stream_same_epochs(name, got, want, got_n, want_n, batch_kernels, fm_refresh):
    """Fail unless the streamed SGD / SGDA run `got` ends in the bits of
    the resident `want` (parameters, regularizers, test and validation
    readings), with the same launches of `batch_kernels` and `fm_refresh`
    launches of fm_refresh."""
    keys = [key for key in ("w0", "w", "v")
            if not torch.equal(getattr(got.params, key), getattr(want.params, key))]
    keys += [key for key in ("reg_w", "reg_v") if getattr(want, key, None) is not None
             and not torch.equal(getattr(got, key), getattr(want, key))]
    same_readings = [h[1:-1] for h in got.history] == [h[1:-1] for h in want.history]
    wrong = {key: (got_n[key], want_n[key]) for key in batch_kernels if got_n[key] != want_n[key]}
    if got_n["fm_refresh"] != fm_refresh:
        wrong["fm_refresh"] = (got_n["fm_refresh"], fm_refresh)
    print(f"{name}: the resident run's bits: {not keys}; its test (and validation) readings: "
          f"{same_readings}; launches of {', '.join(batch_kernels)} equal, fm_refresh "
          f"{got_n['fm_refresh']} (resident {want_n['fm_refresh']}): {not wrong}")
    if keys or not same_readings:
        fail(f"{name}: differs from the resident run: {keys}, readings "
             f"{[h[1:-1] for h in got.history]} against {[h[1:-1] for h in want.history]}")
    if wrong:
        fail(f"{name}: launches (made, expected) {wrong}")


#: how often cli_child reads its child's resident set, in seconds
RSS_EVERY = 0.01


def cli_child(name, argv, rec):
    """`libfm_tpu_torch.cli.main(argv -verbosity 1 -rlog F)`, the entry
    point of `python -m libfm_tpu_torch.cli`, in a child process on the
    card under tracemalloc. Returns (its wall seconds, its peak resident
    set in bytes: the largest VmRSS of /proc/<pid>/status, read every
    RSS_EVERY seconds while it runs, its traced peak in bytes: numpy's
    arrays and Python's objects, not CUDA's or torch's host memory, its
    seconds an iteration from the rlog's time_learn4). The child's own
    #mem line (VmHWM) is kept beside: where the kernel counts the
    high-water mark of the process it was forked from too (the card's
    machine does), it reads this script's."""
    import re
    import tempfile

    def rss(pid):
        try:
            with open(f"/proc/{pid}/status") as f:
                return next(int(line.split()[1]) * 1024 for line in f
                            if line.startswith("VmRSS:"))
        except (OSError, StopIteration):
            return 0

    traced = ("import sys, tracemalloc\n"
              "tracemalloc.start()\n"
              "from libfm_tpu_torch import cli\n"
              "rc = cli.main(sys.argv[1:])\n"
              "print(f'#traced_peak_bytes={tracemalloc.get_traced_memory()[1]}')\n"
              "sys.exit(rc)\n")
    with tempfile.NamedTemporaryFile(suffix=".tsv") as rlog, \
            tempfile.TemporaryFile("w+") as out:
        cmd = [sys.executable, "-c", traced, *argv, "-verbosity", "1", "-rlog", rlog.name]
        t0 = time.perf_counter()
        p = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, text=True,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        peak = 0
        while p.poll() is None:
            peak = max(peak, rss(p.pid))
            time.sleep(RSS_EVERY)
        wall = time.perf_counter() - t0
        out.seek(0)
        text = out.read()
        if p.returncode != 0:
            fail(f"{name}: the child exited {p.returncode}: {text[-4000:]}")
        lines = open(rlog.name).read().splitlines()
    col = lines[0].split("\t").index("time_learn4")
    iters = [float(line.split("\t")[col]) for line in lines[1:]]
    hwm = int(re.search(r"#mem host_peak_rss_bytes=(\d+)", text)[1])
    tpeak = int(re.search(r"#traced_peak_bytes=(\d+)", text)[1])
    said = [line for line in text.splitlines() if "out-of-core" in line]
    rec[name] = dict(wall_seconds=wall, peak_rss_bytes=peak, traced_peak_bytes=tpeak,
                     own_report_bytes=hwm, iteration_seconds=iters, said=said)
    print(f"{name}: python -m libfm_tpu_torch.cli {' '.join(argv)}: exit 0 in {wall:.2f} s "
          f"under tracemalloc (process start, loading and set-up {wall - sum(iters):.2f} s); "
          f"peak host RSS {peak / 2**20:.1f} MiB (VmRSS every {RSS_EVERY} s), traced peak "
          f"{tpeak / 2**20:.1f} MiB, its own #mem line {hwm / 2**20:.1f} MiB; seconds an "
          f"iteration {iters}; {said}")
    if not peak:
        fail(f"{name}: no VmRSS read of the child")
    return wall, peak, tpeak, iters


def run_stream(args, rec, dev, counts, done, data, bs, resident=None, files=None):
    """The stream phase: #3's data (and #1's, the same rows; bench_bs's)
    out of core, each streamed run held against its resident run (the
    default run's als, mcmc and exact_3 in `resident`, where it ran them),
    launches into `counts` (paths stream_*). #3's binary files are the CLI
    phase's where `files` holds them."""
    import filecmp
    import tempfile

    import numpy as np

    from libfm_tpu_torch.data import binary as binio
    from libfm_tpu_torch.data.relation import RelationData
    from libfm_tpu_torch.data.streaming import StreamingDataset, stream_sparse_binary
    from libfm_tpu_torch.data.synth import movielens_like
    from libfm_tpu_torch.learners.mcmc import MCMCLearner
    from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner, MCMCVectorLearner
    from libfm_tpu_torch.learners.sgd import SGDLearner
    from libfm_tpu_torch.learners.sgda import SGDALearner
    from libfm_tpu_torch.models.fm import FMConfig
    from libfm_tpu_torch.tools.transpose import transpose_streaming

    t_phase = t0 = time.perf_counter()
    out = rec["stream_phase"] = {}
    smi = rec["card"]
    train, test = data[:2]
    resident = dict(resident or {})
    with (contextlib.nullcontext(files) if files
          else tempfile.TemporaryDirectory(prefix="chip_smoke_stream_")) as tmp:
        # ---- 1. the binary files (the CLI phase's where it wrote them) and
        # the out-of-core transpose
        ml = os.path.join(tmp, "ml")
        t = time.perf_counter()
        wrote = not os.path.exists(ml + ".test.y")
        if wrote:
            train.to_binary(ml + ".train", with_transpose=False)
            test.to_binary(ml + ".test", with_transpose=False)
        out["write_seconds"] = time.perf_counter() - t
        how = (f"written to binary in {out['write_seconds']:.3f} s" if wrote
               else "in the CLI phase's binary files")
        cache = -(-train.nnz // STREAM_CACHE_PARTS)
        t = time.perf_counter()
        passes = transpose_streaming(ml + ".train.x", ml + ".train.xt", cache)
        out["transpose_seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        binio.write_sparse_binary(ml + ".ref.xt", *train.transpose(), train.num_rows)
        out["in_memory_transpose_seconds"] = time.perf_counter() - t
        same = filecmp.cmp(ml + ".train.xt", ml + ".ref.xt", shallow=False)
        os.remove(ml + ".ref.xt")
        out.update(transpose_passes=passes, transpose_cache_entries=cache)
        print(f"stream: #3's sets {how}; the "
              f".xt out of core ({cache} entries of cache, {passes} passes over .x) in "
              f"{out['transpose_seconds']:.3f} s (in memory and written "
              f"{out['in_memory_transpose_seconds']:.3f} s), the same bytes as "
              f"Dataset.transpose's: {same}; on {smi}")
        if not same or passes < 1 + STREAM_CACHE_PARTS:
            fail(f"stream: the out-of-core transpose (passes {passes}) differs")
        budget = {s: -(-ds.nnz // STREAM_WINDOWS) for s, ds in (("train", train), ("test", test))}

        def streamed(which):
            return StreamingDataset(f"{ml}.{which}.x", f"{ml}.{which}.y", budget[which])

        windows = {s: sum(1 for _ in stream_sparse_binary(f"{ml}.{s}.x", budget[s]))
                   for s in budget}
        out["windows"] = windows
        print(f"stream: windows of {budget} entries: {windows}")
        if min(windows.values()) < 8:
            fail(f"stream: fewer than 8 windows: {windows}")
        t0 = done("stream: binary files and the out-of-core transpose", t0)

        # ---- 2. ALS, MCMC, the streamed test set, the exact engine at #3
        if "als" not in resident:
            resident["als"], counts["als"] = run_learner(
                ALSVectorLearner, "als", data, args, rec, iters=ALS_ITERS, regw=5.0, regv=5.0)
            resident["mcmc"], counts["mcmc"] = run_learner(MCMCVectorLearner, "mcmc", data,
                                                           args, rec, iters=MCMC_ITERS)
        if "exact_3" not in resident:
            resident["exact_3"], counts["exact_3"] = run_learner(
                MCMCLearner, "exact_3", data, args, rec, iters=MCMC_ITERS, exact=False)
        for name, cls, want, kw, sets in (
                ("stream_als_3", ALSVectorLearner, "als", dict(iters=ALS_ITERS, regw=5.0,
                                                              regv=5.0), ("train",)),
                ("stream_mcmc_3", MCMCVectorLearner, "mcmc", dict(iters=MCMC_ITERS),
                 ("train",)),
                ("stream_test_3", MCMCVectorLearner, "mcmc", dict(iters=MCMC_ITERS),
                 ("train", "test")),
                ("stream_exact_3", MCMCLearner, "exact_3", dict(iters=MCMC_ITERS,
                                                                exact=False), ("train",))):
            sdata = tuple(streamed(s) if s in sets else ds
                          for s, ds in (("train", train), ("test", test)))
            got, counts[name] = run_learner(cls, name, sdata, args, rec, **kw)
            setup = rec[name]["setup_seconds"]
            cli_same(name, got, resident[want], counts[name], counts[want], rec)
            rec[name].update(setup_seconds=setup,
                             resident_setup_seconds=rec[want]["setup_seconds"])
            print(f"{name}: set-up {setup:.2f} s streamed, "
                  f"{rec[want]['setup_seconds']:.2f} s resident ({want}); seconds an "
                  f"iteration {rec[name]['seconds']} against {rec[name]['in_process_seconds']}; "
                  f"test_all {[h['test_all'] for h in got.history]}; on {smi}")
            del got
            torch.cuda.empty_cache()
            t0 = done(f"stream: {name}", t0)

        # ---- 3. SGD and SGDA at #1 through learn_stream
        c = SGD_CONFIGS["sgd_1"]
        runs = {}
        for name in ("resident_sgd_1", "stream_sgd_1"):
            lrn = SGDLearner(FMConfig(num_features=train.num_features, num_factors=c["k"],
                                      regw=c["regw"], regv=c["regv"]),
                             task=c["task"], num_iter=STREAM_SGD_EPOCHS, learn_rate=c["lr"],
                             batch_size=c["batch"], seed=SEED, verbose=False)
            tr = streamed("train") if name.startswith("stream") else train
            runs[name] = (lrn, stream_epochs(name, lrn, (tr, test), counts, rec)[1])
        (r, rn), (g, gn) = runs["resident_sgd_1"], runs["stream_sgd_1"]
        stream_same_epochs("stream_sgd_1", g, r, gn, rn, ("sgd_step", "table_scatter"),
                           STREAM_SGD_EPOCHS)
        del runs, r, g
        t0 = done("stream: SGD at #1", t0)
        groups = (np.arange(train.num_features) >= USERS).astype(np.int32)
        trn, val = train.holdout(HOLDOUT_SEED)
        trn.to_binary(ml + ".sgda", with_transpose=False)
        val.to_binary(ml + ".val", with_transpose=False)
        b_val = -(-val.nnz // STREAM_WINDOWS)
        runs = {}
        for name in ("resident_sgda_1", "stream_sgda_1"):
            lrn = SGDALearner(FMConfig(num_features=train.num_features, num_factors=c["k"]),
                              attr_group=groups, task=c["task"], num_iter=STREAM_SGDA_EPOCHS,
                              learn_rate=c["lr"], batch_size=c["batch"], seed=SEED,
                              verbose=False)
            sets = ((StreamingDataset(ml + ".sgda.x", ml + ".sgda.y", budget["train"]), test,
                     StreamingDataset(ml + ".val.x", ml + ".val.y", b_val))
                    if name.startswith("stream") else (trn, test, val))
            runs[name] = (lrn, stream_epochs(name, lrn, sets, counts, rec)[1])
        (r, rn), (g, gn) = runs["resident_sgda_1"], runs["stream_sgda_1"]
        nv = -(-val.num_rows // c["batch"])
        stream_same_epochs("stream_sgda_1", g, r, gn, rn,
                           ("sgda_step", "table_scatter", "sgda_lambda"),
                           STREAM_SGDA_EPOCHS * (nv + 1))
        del runs, r, g, trn, val
        t0 = done("stream: SGDA at #1", t0)

        # ---- 4. bench_bs through -relation with -cache_size
        bsp = os.path.join(tmp, "bs")
        join_tr, join_te = bs["train"].relations[0], bs["test"].relations[0]
        rd = join_tr.data
        RelationData(rd.indptr, rd.cols, rd.vals, rd.num_features).save(bsp + ".rel")
        binio.write_dvector_binary(bsp + ".rel.train", join_tr.row_map.astype(np.uint32))
        binio.write_dvector_binary(bsp + ".rel.test", join_te.row_map.astype(np.uint32))
        bs["train"].to_binary(bsp + ".train", with_transpose=True)
        bs["test"].to_binary(bsp + ".test", with_transpose=False)
        argv = ["-task", "r", "-train", bsp + ".train", "-test", bsp + ".test", "-relation",
                bsp + ".rel", "-method", "als", "-dim", f"1,1,{BS_FACTORS}", "-iter",
                str(STREAM_BS_ITERS), "-regular", "0,5,5", "-seed", str(SEED)]
        want, want_n, _ = cli_run("resident_bs", argv, counts)
        got, got_n, _ = cli_run("stream_bs", argv + ["-cache_size", str(STREAM_BS_CACHE)],
                                counts)
        cli_same("stream_bs", got, want, got_n, want_n, rec)
        print(f"stream_bs: test_all {[h['test_all'] for h in got.history]}")
        del got, want
        t0 = done("stream: bench_bs through -relation -cache_size", t0)

        # ---- 5. peak host RSS: the command line in a child process, at #3
        # streamed and resident, and on the ML-100K-sized set (the baseline)
        small = os.path.join(tmp, "small")
        for suffix, ds in zip((".train", ".test"), movielens_like(seed=SEED)):
            ds.to_binary(small + suffix, with_transpose=False)
        xbytes = os.path.getsize(ml + ".train.x")

        def argv(prefix):
            return ["-task", "r", "-train", prefix + ".train", "-test", prefix + ".test",
                    "-method", "mcmc", "-dim", f"1,1,{FACTORS}", "-iter",
                    str(STREAM_CHILD_ITERS), "-seed", str(SEED)]

        base = cli_child("child_baseline", argv(small), out)
        res = cli_child("child_resident_3", argv(ml), out)
        got = cli_child("child_stream_3", argv(ml) + ["-cache_size", str(xbytes // 10)], out)
        if len(out["child_stream_3"]["said"]) != 2:
            fail(f"child_stream_3: not out of core: {out['child_stream_3']['said']}")
        out["data_share_bytes"] = dict(resident=res[1] - base[1], stream=got[1] - base[1])
        mib = lambda b: f"{b / 2**20:.1f}"  # noqa: E731
        print(f"stream: MCMC {STREAM_CHILD_ITERS} at #3 through the command line, peak host "
              f"RSS streamed {mib(got[1])} MiB against resident {mib(res[1])}, the baseline "
              f"{mib(base[1])}; the data's share (a peak less the baseline's) streamed "
              f"{mib(got[1] - base[1])} MiB against resident {mib(res[1] - base[1])}; traced "
              f"peak streamed {mib(got[2])} MiB against resident {mib(res[2])}, the baseline "
              f"{mib(base[2])}; wall under tracemalloc {got[0]:.2f} s against {res[0]:.2f} s; "
              f"seconds an iteration {got[3]} against {res[3]}; on {smi}")
        done("stream: the command line's peak host RSS, streamed and resident", t0)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"stream: the stream phase took {out['seconds']:.1f} s on {smi}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10,
                    help="timed runs per kernel, plain version and library call")
    ap.add_argument("--out", default=None, help="also write the results here")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="run the MCMC, SGD and SGDA learners under torch.profiler: "
                    "print each iteration's or epoch's device-busy time and write "
                    "DIR/trace_<run>.json (their per-iteration seconds then "
                    "include the profiler's cost)")
    ap.add_argument("--config3-kernels", action="store_true",
                    help="only build the kernels and run config #3's kernel checks; "
                    "print their rows as one JSON line")
    ap.add_argument("--config4", action="store_true",
                    help="only build the kernels, run config #4's kernel checks and its "
                    "MCMC path twice at one seed (the same bits); print the rows as one "
                    "JSON line")
    ap.add_argument("--config5-kernels", action="store_true",
                    help="only build the kernels and run config #5's dual_draw "
                    "check; print its row as one JSON line")
    ap.add_argument("--bench-bs", action="store_true",
                    help="only build the kernels and run bench_bs and bench_bs_ctx: "
                    "their kernel checks and their three and four paths; print the rows "
                    "and launches as one JSON line")
    ap.add_argument("--exact", action="store_true",
                    help="only build the kernels and run the exact engines' kernel "
                    "checks and paths (configs #3 and #4, bench_bs_ctx, bench_bs_c, the "
                    "fallback at bench_bs); print the rows as one JSON line")
    ap.add_argument("--sgda", action="store_true",
                    help="only build the kernels and run SGDA's kernel checks (configs #1 "
                    "and #4b) and its two paths; print the rows and launches as one JSON "
                    "line")
    ap.add_argument("--probes", action="store_true",
                    help="only build the kernels and run the probe-shape kernel checks "
                    "(table_scatter at P4, table_read at P1, P3 and a table past its "
                    "shared form) and the probe path; print the rows as one JSON line")
    ap.add_argument("--cli", action="store_true",
                    help="only build the kernels and run the CLI phase (python -m "
                    "libfm_tpu_torch.cli at configs #3 and #1 and at bench_bs, each "
                    "against the learner run in process); print the launches as one "
                    "JSON line")
    ap.add_argument("--options", action="store_true",
                    help="only build the kernels and run the options phase (k = 0 kernel "
                    "checks and paths at configs #3 and #4, checkpoints resumed at #3, "
                    "#4 and bench_bs, predict_new, case reordering); print the rows and "
                    "launches as one JSON line")
    ap.add_argument("--stream", action="store_true",
                    help="only build the kernels and run the stream phase (out-of-core "
                    "data at #3, #1 and bench_bs, each against its resident run, and the "
                    "command line's peak host RSS streamed and resident); print the "
                    "launches as one JSON line")
    ap.add_argument("--quality", action="store_true",
                    help="only build the kernels and run MCMC to bench.py's 24 "
                    "iterations at configs #3, #4 and #5; print each test_all beside "
                    "its quality target as one JSON line")
    args = ap.parse_args(argv)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    # the port itself: absent when this script is run outside the repo
    import libfm_tpu_torch  # noqa: F401
    from libfm_tpu_torch import kernels
    from libfm_tpu_torch.learners.mcmc_vector import (
        ALSVectorLearner,
        MCMCVectorLearner,
    )

    smi = subprocess.run(
        ["nvidia-smi", "-i", CARD, "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    rec = dict(card=smi, kind=kind, torch=torch.__version__, args=vars(args))

    phase = {}

    def done(name, t0):
        phase[name] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.library()
    rec["build_seconds"] = time.perf_counter() - t0
    print(f"build: {rec['build_seconds']:.1f} s")
    kernels.import_all()
    t0 = done("build", t0)

    dev = torch.device("cuda")
    if args.quality:
        import numpy as np

        quality = run_quality(args, rec, dev, {}, done)
        print(f"phase seconds: { {key: round(v, 2) for key, v in phase.items()} }")
        print(json.dumps({"card": smi, "numpy": np.__version__, "quality": quality}))
        return 0
    if args.cli:
        from libfm_tpu_torch.data.synth import movielens_like

        data = movielens_like(USERS, ITEMS, RATINGS, seed=SEED)
        t0 = done("config #3 data", t0)
        bs = bs_data(dev)
        t0 = done("bench_bs data", t0)
        counts = {}
        run_cli(args, rec, dev, counts, done, data, bs)
        phase["total, from the script's start"] = time.perf_counter() - T_START
        print(f"phase seconds on {smi}: "
              f"{ {key: round(v, 2) for key, v in phase.items()} }")
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(rec, cli_launches=counts, phase_seconds=phase), f, indent=1)
        print(json.dumps({"card": smi, "cli_launches": {
            p: {key: v for key, v in c.items() if v} for p, c in counts.items()}}))
        return 0
    if args.stream:
        from libfm_tpu_torch.data.synth import movielens_like

        data = movielens_like(USERS, ITEMS, RATINGS, seed=SEED)
        t0 = done("config #3 data", t0)
        bs = bs_data(dev)
        t0 = done("bench_bs data", t0)
        counts = {}
        run_stream(args, rec, dev, counts, done, data, bs)
        phase["total, from the script's start"] = time.perf_counter() - T_START
        print(f"phase seconds on {smi}: "
              f"{ {key: round(v, 2) for key, v in phase.items()} }")
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(rec, stream_launches=counts, phase_seconds=phase), f, indent=1)
        print(json.dumps({"card": smi, "stream_launches": {
            p: {key: v for key, v in c.items() if v} for p, c in counts.items()}}))
        return 0
    if args.options:
        from libfm_tpu_torch.data.synth import movielens_like

        data = movielens_like(USERS, ITEMS, RATINGS, seed=SEED)
        ctr = ctr_data()
        bs = bs_data(dev)
        t0 = done("config #3, #4 and bench_bs data", t0)
        counts = {}
        table = run_options(args, rec, dev, counts, done, data, ctr, bs)
        fill_launches(table, counts)
        phase["total, from the script's start"] = time.perf_counter() - T_START
        print(f"phase seconds on {smi}: "
              f"{ {key: round(v, 2) for key, v in phase.items()} }")
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(rec, kernels=table, phase_seconds=phase), f, indent=1)
        print(json.dumps({"card": smi, "kernels": table, "options_launches": {
            p: {key: v for key, v in c.items() if v} for p, c in counts.items()}}))
        return 0
    if args.bench_bs:
        counts = {}
        table, _, _ = run_bench_bs(args, rec, dev, counts, done)
        fill_launches(table, counts)
        print(f"phase seconds: { {key: round(v, 2) for key, v in phase.items()} }")
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(rec, kernels=table, phase_seconds=phase), f, indent=1)
        print(json.dumps({"card": smi, "kernels": table}))
        return 0
    if args.exact:
        counts = {}
        table = run_exact(args, rec, dev, counts, done)
        fill_launches(table, counts)
        print(f"phase seconds: { {key: round(v, 2) for key, v in phase.items()} }")
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(rec, kernels=table, phase_seconds=phase), f, indent=1)
        print(json.dumps({"card": smi, "kernels": table}))
        return 0
    if args.sgda:
        from libfm_tpu_torch.data.synth import movielens_like

        runs = sgda_data(movielens_like(USERS, ITEMS, RATINGS, seed=SEED), ctr_data())
        t0 = done("config #1 / #4b data", t0)
        table = sgda_kernel_checks(args, rec, dev, runs)
        t0 = done("SGDA kernel checks", t0)
        counts = {}
        for name in SGDA_CONFIGS:
            counts[name] = run_sgda(name, runs, args, rec)
            t0 = done(f"SGDA {name} path", t0)
        fill_launches(table, counts)
        print(f"phase seconds: { {key: round(v, 2) for key, v in phase.items()} }")
        for name in SGDA_CONFIGS:
            print(f"{name} per-epoch seconds on {smi}: "
                  f"{[round(h[3], 6) for h in rec[name]['history']]}")
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(rec, kernels=table, phase_seconds=phase), f, indent=1)
        print(json.dumps({"card": smi, "kernels": table}))
        return 0
    if args.probes:
        table = [table_checks(args, rec, dev, {})]
        counts = {"probes": run_probes(rec)}
        fill_launches(table, counts)
        print(json.dumps({"card": smi, "kernels": table}))
        return 0
    if args.config5_kernels:
        lv = lv_data()
        row, _ = lv_kernel_checks(args, rec, dev, lv)
        sums = group_sum_check(args, rec, dev, lv)
        print(json.dumps({"card": smi, "kernels": [row], "group_sums": sums}))
        return 0
    if args.config4:
        ctr = ctr_data()
        table = ctr_kernel_checks(args, rec, dev, ctr)
        t0 = done("config #4 data and kernel checks", t0)
        c4 = dict(factors=CTR_FACTORS, groups=ctr[2], task=1, iters=CTR_MCMC_ITERS,
                  per_iter=dict(case_stats=CTR_FIELDS, schur_draw=CTR_FIELDS))
        counts = {}
        mcmc_4, counts["mcmc_4"] = run_learner(MCMCVectorLearner, "mcmc_4", ctr, args, rec,
                                               **c4)
        counts["mcmc_4_again"] = repro_check(args, rec, mcmc_4, "mcmc_4_again",
                                             MCMCVectorLearner, ctr, **c4)
        done("config #4 MCMC path twice", t0)
        fill_launches(table, counts)
        print(f"phase seconds: { {key: round(v, 2) for key, v in phase.items()} }")
        print(json.dumps({"card": smi, "kernels": table}))
        return 0
    table, data = kernel_checks(args, rec, dev)
    t0 = done("config #3 data and kernel checks", t0)
    if args.config3_kernels:
        print(json.dumps({"card": smi, "kernels": table,
                          "gather_against_streaming_ms": rec[
                              "table_row0_against_real_ids_ms"]}))
        return 0
    ctr = ctr_data()
    print(f"config #4 / #4b data: {ctr[0].num_rows} train rows, {ctr[1].num_rows} test "
          f"rows, {ctr[0].num_features} features ({time.perf_counter() - t0:.1f} s)")
    t0 = done("config #4 / #4b data", t0)
    table += sgd_kernel_checks(args, rec, dev, data[0], ctr[0])
    t0 = done("SGD kernel checks", t0)
    table.append(table_checks(args, rec, dev, table[-1]))
    t0 = done("probe-shape kernel checks", t0)
    sgda_runs = sgda_data(data, ctr)
    table += sgda_kernel_checks(args, rec, dev, sgda_runs)
    t0 = done("SGDA data and kernel checks", t0)
    table += ctr_kernel_checks(args, rec, dev, ctr)
    t0 = done("config #4 kernel checks", t0)
    lv = lv_data()
    print(f"config #5 data: {lv[0].num_rows} train rows, {lv[1].num_rows} test rows, "
          f"{lv[0].num_features} features ({time.perf_counter() - t0:.1f} s)")
    t0 = done("config #5 data", t0)
    row, lv_blocks = lv_kernel_checks(args, rec, dev, lv)
    table.append(row)
    group_sum_check(args, rec, dev, lv)
    t0 = done("config #5 kernel checks and group sums", t0)

    counts = {}
    als_3, counts["als"] = run_learner(ALSVectorLearner, "als", data, args, rec,
                                       regw=5.0, regv=5.0)
    als = rec["als"]["history"]
    if not als[-1]["train"] < als[0]["train"]:
        fail(f"ALS train RMSE did not fall: {[h['train'] for h in als]}")
    t0 = done("ALS path", t0)
    mcmc_3, counts["mcmc"] = run_learner(MCMCVectorLearner, "mcmc", data, args, rec)
    t0 = done("MCMC path", t0)
    run_k4b_paths(args, rec, data, counts, done)
    t0 = time.perf_counter()
    c4 = dict(factors=CTR_FACTORS, groups=ctr[2], task=1,
              per_iter=dict(case_stats=CTR_FIELDS, schur_draw=CTR_FIELDS))
    _, counts["als_4"] = run_learner(ALSVectorLearner, "als_4", ctr, args, rec,
                                     iters=CTR_ALS_ITERS, regw=5.0, regv=5.0, **c4)
    t0 = done("config #4 ALS path", t0)
    mcmc_4, counts["mcmc_4"] = run_learner(MCMCVectorLearner, "mcmc_4", ctr, args, rec,
                                           iters=CTR_MCMC_ITERS, **c4)
    t0 = done("config #4 MCMC path", t0)
    counts["mcmc_4_again"] = repro_check(args, rec, mcmc_4, "mcmc_4_again", MCMCVectorLearner,
                                         ctr, iters=CTR_MCMC_ITERS, **c4)
    del mcmc_4
    t0 = done("config #4 MCMC path again (the same bits)", t0)
    _, counts["mcmc_5"] = run_learner(
        MCMCVectorLearner, "mcmc_5", lv, args, rec, factors=LV_FACTORS,
        iters=LV_MCMC_ITERS, groups=lv[2], task=1,
        per_iter=dict(slot_stats=lv_blocks["dense"], schur_draw=lv_blocks["dense"],
                      dual_draw=lv_blocks["dual"]))
    del lv
    t0 = done("config #5 MCMC path", t0)
    bs_table, bs, ctx = run_bench_bs(args, rec, dev, counts, done)
    table += bs_table
    kept = dict(als=als_3, mcmc=mcmc_3)  # the stream phase's resident runs
    del als_3, mcmc_3
    table += run_exact(args, rec, dev, counts, done, data=data, ctr=ctr, bs=bs, ctx=ctx,
                       keep=kept)
    del ctx
    t0 = time.perf_counter()
    counts["sgd_1"] = run_sgd("sgd_1", data, args, rec)
    t0 = done("SGD #1 path", t0)
    counts["sgd_4b"] = run_sgd("sgd_4b", ctr[:2], args, rec)
    t0 = done("SGD #4b path", t0)
    for name in SGDA_CONFIGS:
        counts[name] = run_sgda(name, sgda_runs, args, rec)
        t0 = done(f"SGDA {name} path", t0)
    del sgda_runs
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_files_") as files:
        run_cli(args, rec, dev, counts, done, data, bs, files=files)
        table += run_options(args, rec, dev, counts, done, data, ctr, bs)
        run_stream(args, rec, dev, counts, done, data, bs, resident=kept, files=files)
    del bs, kept
    t0 = time.perf_counter()
    counts["probes"] = run_probes(rec)
    done("probe path", t0)
    phase["total, from the script's start"] = time.perf_counter() - T_START
    rec["phase_seconds"] = phase
    print(f"phase seconds on {smi}: "
          f"{ {key: round(v, 2) for key, v in phase.items()} }")
    fill_launches(table, counts)
    rec["kernels"] = table
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps({"kernels": table}))
    for name in ("als", "mcmc", "mcmc_scatter", "mcmc_tail", "als_4", "mcmc_4",
                 "mcmc_4_again", "mcmc_5",
                 "als_bs", "mcmc_bs", "mcmc_bs_resync", "als_bs_ctx", "mcmc_bs_ctx",
                 "als_bs_c", "mcmc_bs_c", "als_exact_3", "exact_3", "exact_4",
                 "als_exact_bs_ctx", "exact_bs_ctx", "exact_bs_c", "bs_fallback",
                 "als_k0_3", "mcmc_k0_3", "mcmc_k0_4", "exact_k0_3", "ckpt_straight_3",
                 "ckpt_resume_3", "als_reorder_3", "stream_als_3", "stream_mcmc_3",
                 "stream_test_3", "stream_exact_3"):
        print(f"{name} per-iteration seconds on {smi}: "
              f"{[round(h['time'], 6) for h in rec[name]['history']]}")
    for name in SGD_CONFIGS:
        print(f"{name} per-epoch seconds on {smi}: "
              f"{[round(h[2], 6) for h in rec[name]['history']]}")
    for name in SGDA_CONFIGS:
        print(f"{name} per-epoch seconds on {smi}: "
              f"{[round(h[3], 6) for h in rec[name]['history']]}")
    print(smi)  # the card, as nvidia-smi names it, on the line before the last
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

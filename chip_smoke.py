#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (libfm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # configs #3, #4, #5, #1 and #4b; the table probes
    python3 chip_smoke.py --config3-kernels   # config #3's kernel checks only
    python3 chip_smoke.py --config5-kernels   # config #5's dual_draw check only

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
     draws a field's values;
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
     table_read at probes P1 (scale 8) and P3 (scale 1);
   - config #4 (bench.py:236-277: MCMC probit classification, k=16, on
     #4b's data with its 13 field groups): case_stats on the 13 blocks
     (one iteration's launches; slot_stats, which computes the same GG,
     timed beside it; both, and the plain version in float32, held to
     the plain version in float64 entry by entry over the entry's sum of
     magnitudes), fm_refresh's probit train mode (latents drawn from
     given uniforms, and as expectations) and probit_latent, each against
     its plain version on the same uniforms;
   - config #5 (bench.py:337-389, bench_largevocab: MCMC probit
     classification, k=128, ctr_like(26, 40000, 3M, seed=1), the 26
     fields as groups): dual_draw on the dual features of the 26 blocks
     (one iteration's launches), sampling and ALS, against its plain
     version on the same noise; the dual features counted by slot count
     and checked against the JAX engine's rule reckoned straight from the
     train rows (features of 1 to 32 entries); the library
     yardstick is torch.linalg.cholesky_ex + torch.cholesky_solve on the
     same c x c systems, grouped by c.
4. Path phase. Resets the launch counters before each run and reads them
   after it; each run must launch its own kernels, and no other: ALSVectorLearner (3
   iterations) and MCMCVectorLearner (4) at config #3 (regression, slot
   statistics) and at config #4 (classification: case_stats 13 times an
   iteration, fm_refresh's probit mode at the refresh iterations and
   probit_latent at the others), MCMCVectorLearner (4) at config #5
   (classification: slot_stats and schur_draw on each block's dense
   features, dual_draw on its dual ones, 26 blocks an iteration); and
   the paths of configs #3 and #4 launch no dual_draw; SGDLearner for 3 epochs at config #1
   (regression) and config #4b (classification). Checks that every metric
   is finite, that no draw was rejected and that the ALS train RMSE falls;
   prints accuracy, log10-loss and AUC at each config #4 and #5 iteration.
5. Probe phase. The ported table probes (libfm_tpu_torch.studies
   pallas_gather.main and pallas_scatter.main) at the studies' shapes,
   each against its plain version; prints ns/row.
6. Prints each phase's seconds, one {"kernels": [...]} line (launches on
   every path that runs each kernel), the per-iteration and per-epoch
   seconds, and as the last line {"ok": true, "device": {...}}.

It runs on one card: the first that CUDA_VISIBLE_DEVICES names (card 0
when it is unset), and it hides the others. It imports nothing of jax
or of the JAX package. `--out PATH` also writes every number to a JSON
file. `--config3-kernels` builds the kernels and runs config #3's kernel
checks alone, and prints their rows as one JSON line; `--config5-kernels`
does the same for config #5's dual_draw check. Both use only the
wrappers' public calls, so they also time another version of the package
(a checkout of an earlier commit) when copied into that checkout's root.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

T_START = time.perf_counter()
# one card, set before CUDA starts: torch.cuda.device_count() is then 1
CARD = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
os.environ["CUDA_VISIBLE_DEVICES"] = CARD

import torch  # noqa: E402

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
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
HOT_ROWS = 1024  # the gather-against-streaming line's small table
FEW_ROWS = 4  # a field of few values (the skewed line)
ZIPF = 1.2  # ctr_like's default power of a field's values
# the kernels each path must launch
EXPECTED = {
    "als": {"fm_refresh", "slot_stats", "schur_draw", "dense_update"},
    "mcmc": {"fm_refresh", "slot_stats", "schur_draw", "dense_update"},
    "als_4": {"fm_refresh", "fm_refresh_probit", "case_stats", "schur_draw",
              "dense_update", "probit_latent"},
    "mcmc_4": {"fm_refresh", "fm_refresh_probit", "case_stats", "schur_draw",
               "dense_update", "probit_latent"},
    "mcmc_5": {"fm_refresh", "fm_refresh_probit", "slot_stats", "schur_draw",
               "dual_draw", "dense_update", "probit_latent"},
    "sgd_1": {"sgd_step", "table_scatter", "fm_refresh"},
    "sgd_4b": {"sgd_step", "table_scatter", "fm_refresh"},
    "probes": {"table_read", "table_scatter"},
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    from libfm_tpu_torch.utils.timers import device_ms

    return device_ms(fn, reps, warmup)


def bound_ms(nbytes: float, flops: float):
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / PEAK_FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def kernel_row(name, replaces, err, tol, ms, plain_ms, nbytes, flops, lib_ms,
               timed, label="", source=None):
    """One row of the kernels line: fails when `err` exceeds `tol`."""
    bms, by = bound_ms(nbytes, flops)
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
    out[-1]["test_mode_bound_ms"] = bound_ms(nt * Lt * 8 + nt * 4 + n * d * 4, 0)[0]
    print(f"fm_refresh test mode: ms={out[-1]['test_mode_ms']:.4f} "
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

    def run_stats(fn, GGs=GG_k, **kw):
        def go():
            for b, G in zip(blocks, GGs):
                fn(A, P, b.feat_off, b.slot_case, b.slot_val, b.feat_id, GG=G,
                   pieces=b.pieces, **kw)
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
    run_stats(cs.case_stats, GG_c, onehot=True)()
    torch.cuda.synchronize()
    cs_err = max(ss.gg_rel_err(Gc, Gk, k) for Gc, Gk in zip(GG_c, GG_k))
    out[-1]["case_stats_same_blocks"] = dict(
        ms=cuda_ms(run_stats(cs.case_stats, GG_c, onehot=True), args.reps),
        rel_err_against_slot_stats=cs_err, tolerance=1e-4)
    print(f"case_stats on config #3's blocks: ms "
          f"{out[-1]['case_stats_same_blocks']['ms']:.4f} against slot_stats "
          f"{out[-1]['ms']:.4f}; GG rel err against slot_stats {cs_err:.3g} (tol 1e-4)")
    if not cs_err <= 1e-4:
        fail(f"case_stats and slot_stats disagree at config #3: {cs_err}")
    del GG_c

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
    del A, A_k, A_p, GG_k, sys_in, tabs, blocks, cols0, zipf
    torch.cuda.empty_cache()
    return out, (train, test)


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
          f"pieces {[b.pieces.count for b in blocks if b.case_major]}, longest slot list "
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
                       pieces=b.pieces)
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
    row["library_ms_none_because"] = ("no one PyTorch call sums the moment rows per feature "
                                      "and reconstructs GG")
    print(f"case_stats against the float64 plain version, over each entry's sum of "
          f"magnitudes: kernel {row['max_abs_err']:.3g}, plain version in float32 "
          f"{row['plain_f32_err']:.3g}, slot_stats {row['slot_stats_err_same_blocks']:.3g} "
          f"(tol {CASE_STATS_TOL:g}); slot_stats ms {row['slot_stats_ms_same_blocks']:.4f} "
          f"against case_stats {row['ms']:.4f}")
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

    # ---- probit_latent on the refreshed A: sampling and expectation
    lat0 = lat_k
    cases = {}
    for mode, u in (("sample", U), ("mean", None)):
        A_k, A_p = A.clone(), A.clone()
        l_k, l_p = lat0.clone(), lat0.clone()
        c_k = pl.probit_latent(A_k, l_k, y, u)
        c_p = pl.probit_latent_plain(A_p, l_p, y, u)
        torch.cuda.synchronize()
        err = max(((l_k - l_p).abs() / l_p.abs().clamp_min(1.0)).max().item(),
                  ((A_k[:, 0] - A_p[:, 0]).abs() / A_p[:, 0].abs().clamp_min(1.0))
                  .max().item(),
                  abs(c_k.item() - c_p.item()),
                  float(not torch.equal(A_k[:, 1:], A[:, 1:])))
        cases[mode] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: pl.probit_latent(A_k, l_k, y, u), args.reps),
            plain_ms=cuda_ms(lambda: pl.probit_latent_plain(A_p, l_p, y, u), args.reps))
        print(f"probit_latent ({mode}): err {err:.3g} (tol 1e-5, relative above 1), "
              f"ms {cases[mode]['ms']:.4f} plain {cases[mode]['plain_ms']:.4f}")
        del A_k, A_p
    row = kernel_row(
        "probit_latent", "libfm_tpu/learners/mcmc_vector.py:2033",
        max(c["max_abs_err"] for c in cases.values()), 1e-5,
        cases["sample"]["ms"], cases["sample"]["plain_ms"],
        nbytes=nc * 4 * 6, flops=nc * 60, lib_ms=None,
        timed="one launch at config #4 (sampling)")
    row["cases"] = cases
    row["library_ms_none_because"] = "no one PyTorch call draws the truncated normals"
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
        cuda_ms(run(dd.dual_draw_plain), args.reps, warmup=1),
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


def lockstep_err(P0, w0, batches, kw, lr0, reg0):
    """An SGD epoch in which every batch's kernels and plain versions start
    from the same state (the kernels'), in the learner's form (update rows
    in the sorted order, w0 moved inside sgd_step): the largest difference,
    relative per column, of the update rows, of the table after the
    scatter (the plain scatter adds the same rows) and of the batch sums.
    Fails unless every batch's w0 equals, bit for bit, the torch line
    `w0 - lr0 * (red[0] + red[1] * reg0 * w0)` on the kernel's sums."""
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
        w0_bits.append(torch.equal(w0, w0_was - lr0 * (r_k[0] + r_k[1] * reg0 * w0_was)))
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
            w0 = w0 - lr0 * (red[0] + red[1] * reg0 * w0)
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
        if _epoch_mode(ds, tb) != mode:
            fail(f"{label}: the learner would pick mode {_epoch_mode(ds, tb)}")
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
        # learner's), the plain epoch twice (index_add_'s atomics add in no
        # fixed order), the plain epoch with the kernel's batch sums, and
        # the plain epoch in float64
        r_k = ep_k(params, *arrs, lrs, *lims, max_runs)
        P_k, w0_k = _packed(r_k), r_k.w0.item()
        (P_p, w0_p), (P_p2, w0_p2) = ep_p(P0, params.w0), ep_p(P0, params.w0)
        w0_ks = ep_p(P0, params.w0, sums=sg.sgd_step)[1].item()
        w0_64 = ep_p(P0.double(), params.w0.double())[1].item()
        w0_p, w0_p2 = w0_p.item(), w0_p2.item()
        free = [col_rel_err(P_k, P_p).item(), col_rel_err(P_p2, P_p).item()]
        w0_err, w0_sums_err = rel(w0_k, w0_p), rel(w0_k, w0_ks)
        t2 = time.perf_counter()
        secs["lockstep and free-running epochs"] = t2 - t1
        epoch_ms = cuda_ms(lambda: ep_k(params, *arrs, lrs, *lims, max_runs), reps)
        epoch_plain_ms = cuda_ms(lambda: ep_p(P0, params.w0), 1, warmup=0)
        print(f"SGD epoch, {label}: {nb} batches of {B}x{L}; kernels against plain "
              f"in lockstep (every batch from the same state): {err:.3g} (tol 1e-4, "
              f"relative per column); free-running after one epoch: table, kernels "
              f"against plain {free[0]:.3g} (tol 1e-4), plain against plain "
              f"{free[1]:.3g}; w0 kernels {w0_k!r}, plain {w0_p!r} and {w0_p2!r}, "
              f"plain with the kernel's sums {w0_ks!r}, plain float64 {w0_64!r}; "
              f"w0 kernels against plain {w0_err:.3g} "
              f"({'tol 1e-4' if gate_w0 else 'recorded'}), against plain with the "
              f"kernel's sums {w0_sums_err:.3g} (tol 1e-4); "
              f"epoch ms {epoch_ms:.3f}, plain {epoch_plain_ms:.3f}")
        if not max(err, free[0], w0_sums_err, w0_err if gate_w0 else 0.0) <= 1e-4:
            fail(f"SGD epoch at {label}: kernels and plain versions differ by "
                 f"{err} (lockstep), {free[0]} (free-running table), {w0_err} "
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
            unique_rows=uniq, lockstep_err=err, free_running_err=free[0],
            plain_repeat_err=free[1], w0_kernels=w0_k, w0_plain=[w0_p, w0_p2],
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


def table_checks(args, rec, dev, scatter_row):
    """Phase 3, the probes' shapes: table_scatter at P4's (against
    index_add_, added to the table_scatter row under "p4"), table_read at
    P1's (scale 8) and P3's (scale 1). Returns the table_read row."""
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
    rows = []
    for probe, scale, n_used, site in (
        ("P1", float(pg.UNROLL), pg.NIDS // pg.UNROLL * pg.UNROLL,
         "studies/pallas_gather.py:79"),
        ("P3", 1.0, pg.NIDS // pg.CHUNK * pg.CHUNK, "studies/pallas_gather.py:147"),
    ):
        o_k = tr.table_read(T, ids, pg.REPS, scale, n_used)
        o_p = tr.table_read_plain(T, ids, pg.REPS, scale, n_used)
        err = ((o_k - o_p).abs().max() / o_p.abs().max()).item()
        rows.append(kernel_row(
            "table_read", site, err, 1e-5,
            cuda_ms(lambda: tr.table_read(T, ids, pg.REPS, scale, n_used), args.reps),
            cuda_ms(lambda: tr.table_read_plain(T, ids, pg.REPS, scale, n_used),
                    args.reps),
            nbytes=pg.NSUB * 128 * 4 + n_used * 4 + 128 * 4,
            flops=pg.REPS * n_used * 128, lib_ms=None,
            timed=f"one call at {probe}'s shape ({pg.REPS} reps of {n_used} ids, "
                  f"scale {scale:g}); error relative to the largest lane",
            label=f" ({probe})"))
    read_row = dict(rows[0])
    read_row["p3"] = {key: rows[1][key] for key in (
        "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "timed")}
    return read_row


def check_launches(name, counts):
    for kname in sorted(EXPECTED[name]):
        if counts.get(kname, 0) <= 0:
            fail(f"{name}: kernel {kname} was not launched on the path")


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


# the device names of the SGD batch loop's two kernels
BATCH_KERNELS = ("sgd_step_kernel", "scatter_narrow", "scatter_wide")


def profile_summary(prof, out_dir, rec, name, batches=None):
    """From a torch.profiler run of learner `name`: per iteration or
    epoch (the learners' "iteration N" / "epoch N" ranges) the wall time,
    the device-busy time (union of the device activities inside the
    range) and the device time by name; for the first one also its
    longest host events. For an SGD run (`batches` a epoch) also the
    device activities an epoch, the batch loop's kernels a batch, and the
    torch ops an epoch with those run at least once a batch. Writes
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
        row = dict(name=ev.name, wall_ms=wall, device_busy_ms=busy / 1e3,
                   idle_share=1.0 - busy / 1e3 / wall,
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
            print(f"profile {name} {ev.name}: {batches} batches, {loop} launches of "
                  f"sgd_step/table_scatter ({loop / batches:g} a batch), "
                  f"{len(inside) - loop} other device activities; torch ops {ops}")
        rows.append(row)
        print(f"profile {name} {ev.name}: wall {wall:.3f} ms, device busy "
              f"{row['device_busy_ms']:.3f} ms, idle share {row['idle_share']:.4f}")
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


def run_learner(cls, name, data, args, rec, factors=FACTORS, iters=None, groups=None,
                task=0, per_iter=None, **cfg_kw):
    """Path phase: one learner run. `per_iter` gives the launches each
    iteration must make of slot_stats, case_stats, schur_draw and
    dual_draw (2 slot_stats and schur_draw launches, no other, when None:
    config #3); a probit run also makes the refreshes' probit launches."""
    from libfm_tpu_torch import kernels
    from libfm_tpu_torch.learners.mcmc import dispatch_chunks
    from libfm_tpu_torch.models.fm import FMConfig

    train, test = data[:2]
    cfg = FMConfig(num_features=train.num_features, num_factors=factors, **cfg_kw)
    if iters is None:
        iters = ALS_ITERS if name == "als" else MCMC_ITERS
    learner = cls(cfg, task=task, num_iter=iters, seed=SEED, verbose=True,
                  attr_group=groups)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    prof = None
    if args.profile and name.startswith("mcmc"):
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
    counts = kernels.launch_counts()
    rec[name] = dict(
        history=hist, launches=counts, learn_seconds=wall,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
    )
    secs = [h["time"] for h in hist]
    rec[name]["setup_seconds"] = wall - sum(secs)
    print(f"{name}: launches {counts}; learn() {wall:.2f} s, of which set-up "
          f"{wall - sum(secs):.2f} s; per-iteration s {secs}; seconds an iteration past "
          f"the first {secs[1:]}")
    check_launches(name, counts)
    # the launches each path's iterations must make, exactly
    refresh = len(dispatch_chunks(0, iters, learner.refresh_every))
    per_iter = dict(dict(slot_stats=0, case_stats=0, schur_draw=0, dual_draw=0),
                    **(per_iter or dict(slot_stats=2, schur_draw=2)))
    want = dict({key: v * iters for key, v in per_iter.items()},
                fm_refresh_probit=refresh if task else 0,
                probit_latent=iters - refresh if task else 0)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10,
                    help="timed runs per kernel, plain version and library call")
    ap.add_argument("--out", default=None, help="also write the results here")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="run the MCMC and SGD learners under torch.profiler: "
                    "print each iteration's or epoch's device-busy time and write "
                    "DIR/trace_<run>.json (their per-iteration seconds then "
                    "include the profiler's cost)")
    ap.add_argument("--config3-kernels", action="store_true",
                    help="only build the kernels and run config #3's kernel checks; "
                    "print their rows as one JSON line")
    ap.add_argument("--config5-kernels", action="store_true",
                    help="only build the kernels and run config #5's dual_draw "
                    "check; print its row as one JSON line")
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
    if args.config5_kernels:
        row, _ = lv_kernel_checks(args, rec, dev, lv_data())
        print(json.dumps({"card": smi, "kernels": [row]}))
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
    table += ctr_kernel_checks(args, rec, dev, ctr)
    t0 = done("config #4 kernel checks", t0)
    lv = lv_data()
    print(f"config #5 data: {lv[0].num_rows} train rows, {lv[1].num_rows} test rows, "
          f"{lv[0].num_features} features ({time.perf_counter() - t0:.1f} s)")
    t0 = done("config #5 data", t0)
    row, lv_blocks = lv_kernel_checks(args, rec, dev, lv)
    table.append(row)
    t0 = done("config #5 kernel checks", t0)

    counts = {}
    _, counts["als"] = run_learner(ALSVectorLearner, "als", data, args, rec,
                                   regw=5.0, regv=5.0)
    als = rec["als"]["history"]
    if not als[-1]["train"] < als[0]["train"]:
        fail(f"ALS train RMSE did not fall: {[h['train'] for h in als]}")
    t0 = done("ALS path", t0)
    _, counts["mcmc"] = run_learner(MCMCVectorLearner, "mcmc", data, args, rec)
    t0 = done("MCMC path", t0)
    c4 = dict(factors=CTR_FACTORS, groups=ctr[2], task=1,
              per_iter=dict(case_stats=CTR_FIELDS, schur_draw=CTR_FIELDS))
    _, counts["als_4"] = run_learner(ALSVectorLearner, "als_4", ctr, args, rec,
                                     iters=CTR_ALS_ITERS, regw=5.0, regv=5.0, **c4)
    t0 = done("config #4 ALS path", t0)
    _, counts["mcmc_4"] = run_learner(MCMCVectorLearner, "mcmc_4", ctr, args, rec,
                                      iters=CTR_MCMC_ITERS, **c4)
    t0 = done("config #4 MCMC path", t0)
    _, counts["mcmc_5"] = run_learner(
        MCMCVectorLearner, "mcmc_5", lv, args, rec, factors=LV_FACTORS,
        iters=LV_MCMC_ITERS, groups=lv[2], task=1,
        per_iter=dict(slot_stats=lv_blocks["dense"], schur_draw=lv_blocks["dense"],
                      dual_draw=lv_blocks["dual"]))
    del lv
    t0 = done("config #5 MCMC path", t0)
    counts["sgd_1"] = run_sgd("sgd_1", data, args, rec)
    t0 = done("SGD #1 path", t0)
    counts["sgd_4b"] = run_sgd("sgd_4b", ctr[:2], args, rec)
    t0 = done("SGD #4b path", t0)
    counts["probes"] = run_probes(rec)
    done("probe path", t0)
    phase["total, from the script's start"] = time.perf_counter() - T_START
    rec["phase_seconds"] = phase
    print(f"phase seconds on {smi}: "
          f"{ {key: round(v, 2) for key, v in phase.items()} }")
    for row in table:
        by_path = {p: c[row["name"]] for p, c in counts.items() if c[row["name"]]}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    rec["kernels"] = table
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps({"kernels": table}))
    for name in ("als", "mcmc", "als_4", "mcmc_4", "mcmc_5"):
        print(f"{name} per-iteration seconds on {smi}: "
              f"{[round(h['time'], 6) for h in rec[name]['history']]}")
    for name in SGD_CONFIGS:
        print(f"{name} per-epoch seconds on {smi}: "
              f"{[round(h[2], 6) for h in rec[name]['history']]}")
    print(smi)  # the card, as nvidia-smi names it, on the line before the last
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Exact relational (BS) MCMC/ALS engine (PyTorch, one device).

The port of `libfm_tpu.learners.mcmc_relational`: the VLDB 2013
block-structure algorithm behind libFM's `-relation` with libFM's
per-coordinate draws (draw_w_rel, fm_learn_mcmc.h:734-790; draw_v_rel,
:849-909), each conflict-free block's coordinates drawn in parallel. The
join is never materialised: a relation feature's draw costs O(its block
entries), through per-block-row caches.

State on the device:
- P = [w | V] [n, k+1], the packed parameter table;
- A = [e | Q] [num_train, k+1]: each train case's residual (pred - y, or
  pred - latent under probit) and factor sums over its main-table entries
  and joined block rows;
- per relation its score table [qB | sqB | linB] [nb+1, k+2]
  (`rel_scores`) and y_b [nb+1], each block row's part of a joined case's
  prediction, 1/2 (|qB|^2 - sqB) + linB; both rebuilt at every
  re-prediction (row nb a zero sentinel).

One iteration, in the JAX engine's order:
  alpha, w0 (e moves with it) and the hyperpriors (plain torch);
  the w sweep: `coord_draw` (w) on each main-table block, then per
    relation `rel_cache_cols` over A's columns e and Q_0 (we: each block
    row's sum of e), `rel_coord_draw` (w) on each of its blocks and
    e += (y_b - y_old)[map];
  the unobserved features;
  per factor f, with q = A[:, 1+f] (e and q worked on in `draw_caches`,
    side by side): `coord_draw` (v) on each main block;
    per relation q' = q - qB[map], `rel_cache_cols` over e and q' (its
    columns sum e, e q', q' and q'^2 a block row: we, weq, wc, wc_sqr),
    `rel_coord_draw` (v) on each of its blocks, then
    e += (y_b - y_old)[map] + q' (qB - qB_old)[map] and q = q' + qB[map];
  the re-prediction: `rel_scores`, then `rel_refresh`'s test mode and its
    train mode (A rewritten, the clipped squared error) or probit mode.
The JAX engine applies the *net* cache deltas after a relation's draws in
place of libFM's un-sync / re-sync of e (fm_learn_mcmc.h:478-509,
598-638); so does this one. Like the flat exact engine, it draws V's
hyperpriors and the unobserved features' V before the w sweep's blocks
(learners/mcmc.py `learn_exact` says why that changes nothing). On CPU
tensors each kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch

from libfm_tpu_torch.kernels.coord_draw import coord_draw, rel_coord_draw
from libfm_tpu_torch.kernels.rel_cache import rel_cache_cols
from libfm_tpu_torch.kernels.rel_refresh import rel_refresh, rel_scores
from libfm_tpu_torch.learners.mcmc import (
    HYPER,
    CoordBlock,
    attach_counters,
    draw_caches,
    attr_groups,
    draw_alpha,
    draw_block,
    draw_sweep_hyperpriors,
    draw_unobserved,
    draw_w0,
    initial_state,
    run_iterations,
    step_metrics,
)
from libfm_tpu_torch.learners.mcmc_rel_vector import (
    RelLayout,
    check_relational,
    main_blocks,
    main_rows,
    stacked_design,
    stacked_maps,
)
from libfm_tpu_torch.ops import samplers
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION


class ExactRel:
    """One relation on the device (the JAX engine's `_build_rel_layout`):
    its conflict-free blocks over block rows in `conflict_free_blocks`'
    order (CoordBlock), `wnum` float32 [nb+1] (train cases joined to each
    row), its design matrix by block row (`indptr`, `cols` global ids,
    `vals`), the train join map (`map_tr`, int64) and the train cases of
    each block row (`case_off`, `case_ids`, for rel_cache)."""

    def __init__(self, lay: RelLayout, device):
        def t(x, dtype=None):
            return torch.as_tensor(x, dtype=dtype, device=device)

        self.nb = lay.nb
        self.blocks = [CoordBlock(b.features, b.groups, b.feat_off, b.entry_b, b.entry_x,
                                  device) for b in lay.blocks]
        self.wnum = t(lay.wnum, torch.float32)
        self.indptr, self.cols, self.vals = t(lay.indptr), t(lay.cols), t(lay.vals)
        self.map_tr = t(lay.row_map_train, torch.long)
        self.case_off, self.case_ids = t(lay.case_off), t(lay.case_ids)


def learn_relational(lrn, train, test):
    """Run the exact BS MCMC/ALS loop for `lrn` (an MCMCLearner, or the
    vector learner's fallback) on block-structure data, regression or
    probit classification, with or without main-table features; returns
    the history."""
    check_relational(lrn, train, test)
    cfg = lrn.cfg
    dev, gen, f32 = lrn.device, lrn.generator, torch.float32
    n, k = cfg.num_features, cfg.num_factors
    lrn.min_target, lrn.max_target = train.min_target, train.max_target
    min_t, max_t = float(lrn.min_target), float(lrn.max_target)
    bound = samplers.DRAW_BOUND * max(1.0, abs(min_t), abs(max_t))
    use_linear = cfg.use_linear
    classify = lrn.task == TASK_CLASSIFICATION
    nc_train, nc_test = train.num_rows, test.num_rows

    attr_group_np, group_sums = attr_groups(lrn.attr_group_np, n, dev)
    attr_group = group_sums.ids
    lays = [RelLayout(jt, je, attr_group_np, n, by_shape=False)
            for jt, je in zip(train.relations, test.relations)]
    rels = [ExactRel(lay, dev) for lay in lays]
    mains_host, main_unobs = main_blocks(train, attr_group_np, lays[0].attr_offset)
    mains = [CoordBlock.from_feature_block(b, attr_group_np, dev) for b in mains_host]
    # features in no block: the main table's and each relation's
    unobserved = torch.as_tensor(np.concatenate([main_unobs] + [lay.unobserved for lay in lays]),
                                 dtype=torch.long, device=dev)
    rejected = attach_counters(mains + [b for r in rels for b in r.blocks], dev)
    first = np.cumsum([0] + [lay.nb + 1 for lay in lays])
    maps_tr = stacked_maps(lays, "row_map_train", nc_train, dev)
    maps_te = stacked_maps(lays, "row_map_test", nc_test, dev)
    y_train = torch.as_tensor(train.target, dtype=f32, device=dev)
    y_test = torch.as_tensor(test.target, dtype=f32, device=dev)
    nec = lrn.num_eval_cases if lrn.num_eval_cases is not None else nc_test
    eval_mask = (torch.arange(nc_test, device=dev) < nec).to(f32)

    P, st = initial_state(lrn, lrn.init_params, n, k, group_sums.num_groups, nc_test)
    rows_tr, rows_te = main_rows(train, P, dev), main_rows(test, P, dev)
    A = torch.empty(nc_train, k + 1, dtype=f32, device=dev)
    EQ = draw_caches(nc_train, dev)
    fwd = dict(use_linear=use_linear, use_bias=cfg.use_bias)
    clip = dict(min_target=min_t, max_target=max_t)
    probit = None if not classify else "sample" if lrn.do_sample else "mean"

    design = stacked_design(rels)

    def scores():
        """The relations' score tables stacked (rel_refresh's SC, one
        rel_scores launch), each relation's part of it (views) and its y_b
        (the JAX engine's `rel_predict`)."""
        SC = rel_scores(P, *design, use_linear=use_linear)
        parts = [SC[a:b] for a, b in zip(first[:-1], first[1:])]
        y_bs = []
        for S in parts:
            y_b = 0.5 * ((S[:, :k] * S[:, :k]).sum(dim=1) - S[:, k])
            y_bs.append(y_b + S[:, k + 1] if use_linear else y_b)
        return SC, parts, y_bs

    # the initial prediction takes e = pred - y for both tasks (libFM
    # fm_learn_mcmc_simultaneous.h:70-86): the latents start at y
    SC, parts, y_bs = scores()
    rel_refresh(SC, maps_tr, st["w0"], A, y_train, **clip, **rows_tr, **fwd)
    latent = y_train.clone() if classify else None
    cur = dict(parts=parts, y_bs=y_bs)

    def draw_all():
        e, q = EQ[:, 0], EQ[:, 1]
        e.copy_(A[:, 0])
        alpha, rej = draw_alpha(gen, e, nc_train, st["alpha"], lrn.alpha_0, lrn.gamma_0,
                                lrn.do_multilevel, lrn.do_sample)
        w0 = st["w0"]
        if cfg.use_bias:
            w0_new, r = draw_w0(lrn, e.sum(), nc_train, w0, alpha, bound)
            rej = rej + r
            e += w0_new - w0
            w0 = w0_new
        hyper, r = draw_sweep_hyperpriors(lrn, P, group_sums, st)
        rej = rej + r
        w_mu, w_lambda, v_mu, v_lambda = hyper
        if use_linear:
            for blk in mains:
                draw_block(lrn, coord_draw, blk, P[:, 0], w_lambda, w_mu, alpha, bound, e=e)
            for rel, y_b in zip(rels, cur["y_bs"]):
                # we: each block row's sum of e, the caches' first column
                C = rel_cache_cols(e, A[:, 1], rel.case_off, rel.case_ids)
                y_old = y_b.clone()
                for blk in rel.blocks:
                    draw_block(lrn, rel_coord_draw, blk, P[:, 0], w_lambda, w_mu, alpha,
                               bound, we=C[:, 0], wnum=rel.wnum, yb=y_b)
                # e follows its block row's new prediction
                e += (y_b - y_old)[rel.map_tr]
        rej = rej + draw_unobserved(lrn, P, unobserved, attr_group, hyper, bound)
        for f in range(k):
            # q is A's column 1+f and each relation's qB the column f of
            # its score table, both from the re-prediction: V[:, f] has not
            # changed since (learners/mcmc.py `learn_exact`)
            q.copy_(A[:, 1 + f])
            theta, lam, mu = P[:, 1 + f], v_lambda[:, f], v_mu[:, f]
            for blk in mains:
                draw_block(lrn, coord_draw, blk, theta, lam, mu, alpha, bound, e=e, q=q)
            for rel, S, y_b in zip(rels, cur["parts"], cur["y_bs"]):
                qb = S[:, f]
                qd = q - qb[rel.map_tr]  # q without the relation's part
                # per block row: sum e | sum e^2 | wc = sum q' | weq = sum q' e
                # | wc_sqr = sum q'^2
                C = rel_cache_cols(e, qd, rel.case_off, rel.case_ids)
                y_old, qb_old = y_b.clone(), qb.clone()
                for blk in rel.blocks:
                    draw_block(lrn, rel_coord_draw, blk, theta, lam, mu, alpha, bound,
                               we=C[:, 0], weq=C[:, 3], wc=C[:, 2], wc_sqr=C[:, 4],
                               wnum=rel.wnum, yb=y_b, qb=qb)
                e.copy_(e + (y_b - y_old)[rel.map_tr] + qd * (qb - qb_old)[rel.map_tr])
                q.copy_(qd + qb[rel.map_tr])
        # the re-prediction rewrites A; q's last values are not read again
        A[:, 0] = e
        st.update(w0=w0, alpha=alpha, **dict(zip(HYPER, hyper)))
        return rej

    def one_step(it):
        rej = draw_all()
        w0 = st["w0"]
        SC, cur["parts"], cur["y_bs"] = scores()
        pred_test = rel_refresh(SC, maps_te, w0, **rows_te, **fwd)
        U = torch.rand(nc_train, generator=gen, device=dev) if probit == "sample" else None
        m = rel_refresh(SC, maps_tr, w0, A, y_train, probit=probit, U=U, latent=latent,
                        **clip, **rows_tr, **fwd)
        train_metric = m / max(nc_train, 1) if classify else torch.sqrt(m / max(nc_train, 1))
        rej = rej + rejected.sum()
        rejected.zero_()
        return step_metrics(lrn, st, it, pred_test, train_metric, rej, y_test, eval_mask)

    def bufs():
        # besides P and A, each relation's score table and y_b (the y_B
        # caches the next iteration's draws start from)
        out = dict(P=P, A=A, rejected=rejected, **({"latent": latent} if classify else {}))
        for r, (S, y_b) in enumerate(zip(cur["parts"], cur["y_bs"])):
            out[f"scores.{r}"], out[f"y_b.{r}"] = S, y_b
        return out

    return run_iterations(lrn, "exact_bs", one_step, P, st, bufs)

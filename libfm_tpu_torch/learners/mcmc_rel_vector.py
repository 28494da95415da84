"""Relational (BS) vector-sweep MCMC/ALS engine (PyTorch, one device).

The port of `libfm_tpu.learners.mcmc_rel_vector`: the VLDB 2013
block-structure algorithm behind libFM's `-relation` (fm_learn_mcmc.h
:734-790, 849-909) with joint draws of each block feature's whole
theta_j = (w_j, v_j), as the flat vector engine draws them. The join is
never materialised: per-feature work is O(nnz of the block), not O(the
expanded entries).

State on the device:
- P = [w | V] [n, k+1], the packed parameter table;
- A = [e | Q] [num_train, k+1], the per-case residual and factor sums
  (classification: e = pred - latent, with the probit latent of every
  train case);
- the test tail [num_test, k+1] = [pred | Q], kept current by the same
  per-case updates as A (the incremental test prediction; only with an
  empty main table);
- per relation, block-row tables of b = 0..nb (row nb a zero sentinel):
  the frozen caches C (`rel_cache`) and SD = [s | dQB], the per-row shift
  of every case joined to the row since C was taken (kernels/rel_sweep.py
  gives the algebra).

One iteration, in the JAX engine's order (`draw_all`, `one_step`):
alpha, w0 and the hyperpriors (plain torch), then per main-table
conflict-free block (`sweep_main_block`, over the train cases):
  slot_stats  (each feature's GG from its slots' rows of A),
  schur_draw  (the blocked Cholesky draw of its theta),
  slot_update (the draw's update of the slots' rows of A),
then per relation:
  rel_cache   (C from A: the resync path only, every iteration),
  per conflict-free block (over block rows, in the JAX engine's order):
    rel_stats   (each feature's GG from C and SD),
    schur_draw  (its relational form: each draw's shift into SD too,
                 K10's update),
  rel_resync  (SD into A and the test tail: the resync path only),
then the unobserved features, the test prediction (from the tail, or
rel_scores + rel_refresh's test mode over the test cases' main entries
and joined rows) and, every `refresh_every` iterations, rel_scores +
rel_refresh (A and the tail rebuilt from P; for classification its
probit mode, which resamples the latents) and, on the deferred path, a
fresh C and a zero SD. Classification resamples the latents between
refreshes too, from pred = e + latent (probit_latent), which also sums
the new e and its squares for the next iteration's alpha and w0 draws.
rel_scores writes every relation's score table in one launch, from the
relations' designs stacked in one CSR (`stacked_design`).

The deferred path (one relation, regression, no main table, the JAX
engine's gate) keeps C and SD across iterations: alpha, w0 and the train
metric between refreshes come from closed-form block-row sums
(`rel_deferred`), and the test prediction is the frozen tail plus SD
(`rel_resync`'s read-only mode). On CPU tensors each kernel wrapper runs
its plain PyTorch version.

This engine runs any number of relations beside a main table or none,
regression and probit classification, MCMC and ALS, and saves and
resumes checkpoints (the deferred path's C and SD among the state). A
mesh (ROADMAP §1 item 6) raises in the learner's constructor, and k = 0
in `learn` (§1 item 2).
"""

from __future__ import annotations

import numpy as np
import torch

from libfm_tpu_torch.data.batching import conflict_free_blocks, feature_slots
from libfm_tpu_torch.data.dataset import Dataset
from libfm_tpu_torch.kernels.dense_update import update_table
from libfm_tpu_torch.kernels.pieces import Pieces
from libfm_tpu_torch.kernels.probit_latent import probit_latent
from libfm_tpu_torch.kernels.rel_cache import case_lists, rel_cache
from libfm_tpu_torch.kernels.rel_refresh import rel_refresh, rel_scores
from libfm_tpu_torch.kernels.rel_sweep import rel_deferred, rel_resync, rel_stats
from libfm_tpu_torch.kernels.schur_draw import schur_draw, schur_draw_rel
from libfm_tpu_torch.kernels.slot_stats import gg_width, slot_stats
from libfm_tpu_torch.kernels.slot_update import case_order, slot_update
from libfm_tpu_torch.learners.mcmc import (
    HYPER,
    attr_groups,
    draw_alpha,
    draw_alpha_from_sum,
    draw_sweep_hyperpriors,
    draw_unobserved,
    draw_w0,
    initial_state,
    padded_rows,
    run_iterations,
    step_metrics,
)
from libfm_tpu_torch.ops import samplers
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION

#: the cache build pads no case list here, but the routing keeps the JAX
#: engine's skew gate (`bs_vector_skew` above it goes to the exact engine)
MAX_SKEW = 16.0


def _pow2_at_least(x: int, lo: int = 8) -> int:
    p = lo
    while p < x:
        p <<= 1
    return p


def bs_vector_skew(train) -> float:
    """The JAX engine's padding blow-up of its per-relation case lists:
    nb times the most cases joined to one block row, over the cases. The
    learner routes joins above MAX_SKEW to the exact BS engine."""
    worst = 1.0
    for join in train.relations:
        nb = join.data.num_cases
        counts = np.bincount(join.row_map, minlength=nb)
        if counts.sum() == 0:
            continue
        worst = max(worst, nb * int(counts.max()) / max(1, len(join.row_map)))
    return worst


class RelBlock:
    """One conflict-free block of a relation's features (over block rows),
    host arrays at its real size: `features` (global ids), `groups`, and
    the per-feature entry lists `feat_off` [F+1], `entry_b` (block rows),
    `entry_x` (values) and `entry_f` (each entry's block-local feature)."""

    def __init__(self, block, attr_offset: int, groups):
        off, eb, ex = feature_slots(block)
        self.features = np.asarray(block.features, np.int64) + attr_offset
        self.groups = np.asarray(groups)
        self.feat_off = off
        self.entry_b = eb
        self.entry_x = ex
        self.entry_f = np.repeat(np.arange(len(off) - 1, dtype=np.int32), np.diff(off))


class RelLayout:
    """The host layout of one relation (the JAX engines' `_build_rel_layout`):
    its conflict-free blocks in the order the JAX vector engine sweeps them
    (grouped by power-of-two shape, in order of that shape; with
    `by_shape` False in `conflict_free_blocks`' order, the exact BS
    engine's), `wnum`
    [nb+1] (train cases joined to each row, the sentinel 0), its design
    matrix by block row, the join maps, one CSR list of train cases a
    block row (`case_off`, `case_ids`) and its unobserved features
    (global ids)."""

    def __init__(self, join_tr, join_te, attr_group, n: int, by_shape: bool = True):
        rd = join_tr.data
        nb = rd.num_cases
        for which, join in (("train", join_tr), ("test", join_te)):
            if len(join.row_map) and int(join.row_map.max()) >= nb:
                raise ValueError(
                    f"relation join map ({which}) references block row "
                    f"{int(join.row_map.max())} but the relation has only "
                    f"{nb} rows — wrong relation file for this join map?"
                )
        ds = Dataset(rd.indptr, rd.cols, rd.vals, np.zeros(nb, dtype=np.float32),
                     rd.num_features)
        local_groups = attr_group[rd.attr_offset:rd.attr_offset + rd.num_features]
        blocks = conflict_free_blocks(ds, attr_group=local_groups)
        observed = np.zeros(rd.num_features, dtype=bool)
        for b in blocks:
            observed[b.features] = True
        shape = [(_pow2_at_least(len(b.features)), _pow2_at_least(len(b.entry_rows)))
                 for b in blocks]
        order = sorted(range(len(blocks)), key=lambda i: shape[i] if by_shape else 0)  # stable
        self.nb = nb
        self.attr_offset = rd.attr_offset
        self.blocks = [RelBlock(blocks[i], rd.attr_offset,
                                local_groups[blocks[i].features]) for i in order]
        self.wnum = np.zeros(nb + 1, np.float64)
        self.wnum[:nb] = np.bincount(join_tr.row_map, minlength=nb)
        self.indptr = rd.indptr.astype(np.int64)
        self.cols = (rd.cols.astype(np.int64) + rd.attr_offset).astype(np.int32)
        self.vals = rd.vals.astype(np.float32)
        self.row_map_train = join_tr.row_map.astype(np.int32)
        self.row_map_test = join_te.row_map.astype(np.int32)
        self.case_off, self.case_ids = case_lists(self.row_map_train, nb)
        self.unobserved = (np.nonzero(~observed)[0] + rd.attr_offset).astype(np.int64)


class DevRelBlock:
    """Device copy of a RelBlock."""

    def __init__(self, blk: RelBlock, device):
        def t(x, dtype=None):
            return torch.as_tensor(x, dtype=dtype, device=device)

        self.F = len(blk.features)
        self.features = t(blk.features, torch.long)
        self.feat_id = t(blk.features, torch.int32)
        self.groups = t(blk.groups, torch.long)
        self.feat_off = t(blk.feat_off)
        self.entry_b = t(blk.entry_b)
        self.entry_x = t(blk.entry_x)


class DevRel:
    """Device copy of a RelLayout."""

    def __init__(self, lay: RelLayout, device):
        def t(x, dtype=None):
            return torch.as_tensor(x, dtype=dtype, device=device)

        self.nb = lay.nb
        self.blocks = [DevRelBlock(b, device) for b in lay.blocks]
        self.wnum = t(lay.wnum, torch.float32)
        self.indptr = t(lay.indptr)
        self.cols = t(lay.cols)
        self.vals = t(lay.vals)
        self.map_tr = t(lay.row_map_train)
        self.map_te = t(lay.row_map_test)
        self.case_off = t(lay.case_off)
        self.case_ids = t(lay.case_ids)


def check_relational(learner, train, test) -> None:
    """Raise ValueError where train and test do not join the same
    relations."""
    if len(train.relations) != len(test.relations):
        raise ValueError("train and test must join the same relations")


class MainBlock:
    """One conflict-free block of the main table's features (over the train
    cases), on the device: `features` (global ids, long and int32
    `feat_id`), `groups`, the per-feature slot lists `feat_off`,
    `slot_case`, `slot_val` (`batching.feature_slots`, as RelBlock builds
    its entry lists), `pieces` (their cut for `slot_stats`) and the
    update's own list of the slots in case order, `upd_case`, `upd_val`
    and `upd_feat` (each slot's feature within the block), for
    `slot_update`."""

    def __init__(self, block, groups, device):
        def t(x, dtype=None):
            return torch.as_tensor(x, dtype=dtype, device=device)

        off, sc, sv = feature_slots(block)
        self.F = len(block.features)
        self.features = t(block.features, torch.long)
        self.feat_id = t(block.features, torch.int32)
        self.groups = t(np.asarray(groups), torch.long)
        self.feat_off = t(off)
        self.slot_case = t(sc)
        self.slot_val = t(sv)
        self.pieces = Pieces(off, device)
        self.upd_case, self.upd_val, self.upd_feat = (t(a) for a in case_order(
            sc, sv, np.repeat(np.arange(self.F, dtype=np.int32), np.diff(off))))


def main_blocks(train, attr_group_np, n_main: int):
    """The main table's conflict-free blocks in the JAX engines' order
    (`conflict_free_blocks` over the train cases, the table's own groups,
    host FeatureBlocks) and its features in no block (global ids, int64)."""
    blocks = conflict_free_blocks(train, attr_group=attr_group_np[:max(train.num_features, 1)])
    observed = np.zeros(max(n_main, 1), dtype=bool)
    for b in blocks:
        observed[b.features] = True
    return blocks, np.nonzero(~observed[:n_main])[0].astype(np.int64)


def main_layout(train, attr_group_np, n_main: int, device):
    """`main_blocks` with each block on the device (MainBlock)."""
    blocks, unobserved = main_blocks(train, attr_group_np, n_main)
    return [MainBlock(b, attr_group_np[b.features], device) for b in blocks], unobserved


def main_rows(ds, P, device):
    """rel_refresh's main-table arguments for the cases of `ds`: the padded
    rows (ids, vals) [nc, L] and P; none for an empty main table."""
    if not ds.nnz:
        return {}
    ids, vals = padded_rows(ds, device)
    return dict(P=P, ids=ids, vals=vals)


def stacked_maps(lays, which: str, nc: int, device):
    """rel_refresh's maps int32 [R, nc] for the join maps `which`
    ("row_map_train" or "row_map_test") of the relations `lays`: the
    relations' score tables stack in one table, one under the other, and
    each map points into its relation's part."""
    first = np.cumsum([0] + [lay.nb + 1 for lay in lays])
    maps = [getattr(lay, which).astype(np.int64) + f for lay, f in zip(lays, first)]
    return torch.as_tensor(np.stack(maps).astype(np.int32).reshape(len(lays), nc),
                           device=device)


def stacked_design(rels):
    """rel_scores' design (indptr, cols, vals) over every relation of
    `rels` (DevRel or ExactRel) at once: relation r's block rows from row
    first[r] = sum of the earlier relations' nb + 1 on (`stacked_maps`'
    offsets), each relation's sentinel row an empty range, so one launch
    writes the stacked score table that rel_refresh reads."""
    ptrs, nnz = [], 0
    for r in rels:
        # nb + 1 row starts: the last is the sentinel's, which ends where
        # the next relation's first row starts
        ptrs.append(r.indptr + nnz)
        nnz += int(r.cols.shape[0])
    return (torch.cat(ptrs), torch.cat([r.cols for r in rels]),
            torch.cat([r.vals for r in rels]))


def learn_relational_vector(learner, train, test):
    """Run the BS vector MCMC/ALS loop for `learner` (MCMCVectorLearner)
    on block-structure data, regression or probit classification, with
    or without main-table features; returns the history."""
    check_relational(learner, train, test)
    cfg = learner.cfg
    dev, gen, f32 = learner.device, learner.generator, torch.float32
    n, k = cfg.num_features, cfg.num_factors
    d = k + 1
    learner.min_target = train.min_target
    learner.max_target = train.max_target
    do_sample, do_multilevel = learner.do_sample, learner.do_multilevel
    min_t, max_t = float(learner.min_target), float(learner.max_target)
    draw_bound = samplers.DRAW_BOUND * max(1.0, abs(min_t), abs(max_t))
    use_linear, use_bias = cfg.use_linear, cfg.use_bias
    nc_train, nc_test = train.num_rows, test.num_rows
    classify = learner.task == TASK_CLASSIFICATION

    attr_group_np, group_sums = attr_groups(learner.attr_group_np, n, dev)
    attr_group = group_sums.ids
    G = group_sums.num_groups
    lays = [RelLayout(jt, je, attr_group_np, n)
            for jt, je in zip(train.relations, test.relations)]
    rels = [DevRel(lay, dev) for lay in lays]
    mains, main_unobs = main_layout(train, attr_group_np, lays[0].attr_offset, dev)
    # features in no block: the main table's and each relation's, as the
    # JAX engine lists them
    unobserved = torch.as_tensor(
        np.concatenate([main_unobs] + [lay.unobserved for lay in lays]),
        dtype=torch.long, device=dev)
    maps_tr = stacked_maps(lays, "row_map_train", nc_train, dev)
    maps_te = stacked_maps(lays, "row_map_test", nc_test, dev)
    y_train = torch.as_tensor(train.target, dtype=f32, device=dev)
    y_test = torch.as_tensor(test.target, dtype=f32, device=dev)
    nec = learner.num_eval_cases if learner.num_eval_cases is not None else nc_test
    eval_mask = (torch.arange(nc_test, device=dev) < nec).to(f32)
    # the JAX engine's gates: the main sweeps would leave the tail stale, and
    # the deferred sums hold for one relation's regression residuals only
    incr_test = not mains and nc_test > 0 and learner.bs_incr_test
    deferred = (not classify and len(rels) == 1 and not mains and incr_test
                and learner.bs_deferred)
    learner.incr_test, learner.deferred = incr_test, deferred

    P, st = initial_state(learner, learner.init_params, n, k, G, nc_test)

    rows_tr, rows_te = main_rows(train, P, dev), main_rows(test, P, dev)
    A = torch.empty(nc_train, d, dtype=f32, device=dev)
    tail = torch.empty(nc_test, d, dtype=f32, device=dev) if incr_test else None
    GG_buf = torch.empty(max([b.F for r in rels for b in r.blocks] + [b.F for b in mains],
                             default=0), gg_width(k), dtype=f32, device=dev)
    fwd = dict(use_linear=use_linear, use_bias=use_bias)
    probit = None if not classify else "sample" if do_sample else "mean"

    design = stacked_design(rels)

    def scores():
        return rel_scores(P, *design, use_linear=use_linear)

    def refresh(SC, U=None, latent=None):
        """A and the test tail from P (rel_refresh); returns the clipped
        squared train error summed, or with `latent` (the probit mode)
        the count of correct train cases."""
        m = rel_refresh(SC, maps_tr, st["w0"], A, y_train, min_target=min_t,
                        max_target=max_t, probit=None if latent is None else probit,
                        U=U, latent=latent, **rows_tr, **fwd)
        if incr_test:
            rel_refresh(SC, maps_te, st["w0"], tail, **rows_te, **fwd)
        return m

    def new_sd(r):
        return torch.zeros(r.nb + 1, d, dtype=f32, device=dev)

    # the initial refresh takes e = pred - y for both tasks (the JAX
    # engine's init refresh): the latents start at y
    refresh(scores())
    latent = y_train.clone() if classify else None
    if deferred:
        relc = rel_cache(A, rels[0].case_off, rels[0].case_ids)
        SD_def = new_sd(rels[0])

    def prior_rows(groups, hyper):
        """Each feature's prior precision and mean [F, k+1]; without the
        linear term w is frozen (infinite precision at mean 0)."""
        w_mu, w_lambda, v_mu, v_lambda = hyper
        lam = torch.cat([w_lambda[groups][:, None], v_lambda[groups]], dim=1)
        mu_pr = torch.cat([w_mu[groups][:, None], v_mu[groups]], dim=1)
        if not use_linear:
            lam[:, 0] = 1e30
            mu_pr[:, 0] = 0.0
        return lam, mu_pr

    def draw(GG, theta_old, groups, alpha, hyper, rel_block=None, SD=None):
        """The block's joint draws; with `rel_block` (a relation's block)
        each draw's shift is added to SD too (schur_draw's relational
        form)."""
        lam, mu_pr = prior_rows(groups, hyper)
        z = torch.randn(theta_old.shape[0], d, generator=gen, device=dev) if do_sample else None
        if rel_block is None:
            return schur_draw(GG, theta_old, lam, mu_pr, z, alpha, do_sample=do_sample,
                              bound=draw_bound)
        return schur_draw_rel(GG, theta_old, lam, mu_pr, z, alpha, SD, rel_block.feat_off,
                              rel_block.entry_b, rel_block.entry_x, do_sample=do_sample,
                              bound=draw_bound)

    def sweep_main(blk, alpha, hyper):
        """Joint draws for one main-table block (the JAX engine's
        sweep_main_block: the slot path, always): updates A and P in place
        and returns the number of rejected draws."""
        theta_old = P[blk.features]
        GG = slot_stats(A, P, blk.feat_off, blk.slot_case, blk.slot_val, blk.feat_id,
                        use_linear=use_linear, GG=GG_buf, pieces=blk.pieces)
        theta_new, rj = draw(GG, theta_old, blk.groups, alpha, hyper)
        slot_update(A, blk.upd_case, blk.upd_val, blk.upd_feat,
                    update_table(theta_old, theta_new))
        P[blk.features] = theta_new
        return rj.sum()

    def sweep_relation(r, alpha, hyper, C, SD):
        """One Gibbs sweep over a relation's blocks; updates P and SD in
        place and returns the number of rejected draws."""
        rej = torch.zeros((), dtype=torch.int64, device=dev)
        for blk in r.blocks:
            theta_old = P[blk.features]
            GG = rel_stats(C, SD, r.wnum, blk.feat_off, blk.entry_b, blk.entry_x,
                           blk.feat_id, P, use_linear=use_linear, GG=GG_buf)
            theta_new, rj = draw(GG, theta_old, blk.groups, alpha, hyper, blk, SD)
            P[blk.features] = theta_new
            rej += rj.sum()
        return rej

    # probit_latent's sums of A[:, 0] as it left it, for the next draw_all
    # only (a refresh rewrites A; the w0 shift moves it)
    carried = {}

    def draw_all():
        sums = carried.pop("sums", None)
        if deferred or sums is not None:
            sum_e, sum_e2 = rel_deferred(relc, SD_def, rels[0].wnum) if deferred else sums
            alpha, rej = draw_alpha_from_sum(gen, sum_e2, nc_train, st["alpha"],
                                             learner.alpha_0, learner.gamma_0,
                                             do_multilevel, do_sample)
        else:
            sum_e = A[:, 0].sum()
            alpha, rej = draw_alpha(gen, A[:, 0], nc_train, st["alpha"], learner.alpha_0,
                                    learner.gamma_0, do_multilevel, do_sample)
        w0 = st["w0"]
        if use_bias:
            w0_new, r = draw_w0(learner, sum_e, nc_train, w0, alpha, draw_bound)
            rej = rej + r
            if deferred:
                # every case maps to one real block row of the one relation:
                # its s column moves every e by the delta
                SD_def[:rels[0].nb, 0] += w0_new - w0
            else:
                A[:, 0] += w0_new - w0
                if incr_test:
                    tail[:, 0] += w0_new - w0
            w0 = w0_new
        hyper, r = draw_sweep_hyperpriors(learner, P, group_sums, st)
        rej = rej + r
        for blk in mains:
            rej = rej + sweep_main(blk, alpha, hyper)
        for rel in rels:
            if deferred:
                rej = rej + sweep_relation(rel, alpha, hyper, relc, SD_def)
                continue
            C = rel_cache(A, rel.case_off, rel.case_ids)
            SD = new_sd(rel)
            rej = rej + sweep_relation(rel, alpha, hyper, C, SD)
            rel_resync(SD, rel.map_tr, A)
            if incr_test:
                rel_resync(SD, rel.map_te, tail)
        rej = rej + draw_unobserved(learner, P, unobserved, attr_group, hyper,
                                     draw_bound)
        st.update(w0=w0, alpha=alpha, **dict(zip(HYPER, hyper)))
        return rej

    def one_step(it, do_refresh):
        nonlocal relc, SD_def
        rej = draw_all()
        # one set of block scores serves the test prediction and the
        # refresh (the same P), as in the JAX engine
        SC = scores() if do_refresh or not incr_test else None
        if deferred:
            pred_test = rel_resync(SD_def, rels[0].map_te, tail, read_only=True)
        elif incr_test:
            pred_test = tail[:, 0].clone()
        else:
            pred_test = rel_refresh(SC, maps_te, st["w0"], **rows_te, **fwd)
        U = (torch.rand(nc_train, generator=gen, device=dev)
             if classify and do_sample else None)
        if do_refresh:
            m = refresh(SC, U, latent)
            train_metric = (m / max(nc_train, 1) if classify
                            else torch.sqrt(m / max(nc_train, 1)))
            if deferred:
                relc = rel_cache(A, rels[0].case_off, rels[0].case_ids)
                SD_def.zero_()
        elif classify:
            # the sweeps keep e = pred - latent current: resample the
            # latents from pred = e + latent (the JAX engine's fast path)
            correct, *carried["sums"] = probit_latent(A, latent, y_train, U)
            train_metric = correct / max(nc_train, 1)
        elif deferred:
            # the closed-form e^2 sum, without the target clamp (the
            # refresh iterations report the clamped metric), as the JAX
            # engine reports it
            _, sum_e2 = rel_deferred(relc, SD_def, rels[0].wnum)
            train_metric = torch.sqrt(sum_e2.clamp_min(0.0) / max(nc_train, 1))
        else:
            err = (A[:, 0] + y_train).clamp(min_t, max_t) - y_train
            train_metric = torch.sqrt((err * err).sum() / max(nc_train, 1))
        return step_metrics(learner, st, it, pred_test, train_metric, rej, y_test,
                            eval_mask)

    def bufs():
        # besides P and A: the test tail, the probit latents and the
        # deferred path's frozen caches and SD rows
        out = dict(P=P, A=A)
        if incr_test:
            out["tail"] = tail
        if classify:
            out["latent"] = latent
        if deferred:
            out.update(relc=relc, SD=SD_def)
        return out

    return run_iterations(learner, "bs_vector", one_step, P, st, bufs,
                          learner.refresh_every)

"""Vector-sweep MCMC/ALS engine (PyTorch, one device).

The port of `libfm_tpu.learners.mcmc_vector`: each feature's whole
parameter vector theta_j = (w_j, v_j) is drawn jointly from its exact
Gaussian conditional, one conflict-free block at a time (blocked Gibbs;
with do_sample=False, vector-wise block coordinate descent — ALS).

State on the device:
- P = [w | V] [n, k+1], the packed parameter table (w and V are views);
- A = [e | Q] [num_train, k+1], the per-case residual and per-factor
  linear caches, maintained incrementally by every block's update and
  rewritten by the periodic refresh; with the incremental test tail
  (`flat_incr_test`) A also holds [pred | Q] of every test case, in rows
  of its own past the train rows;
- classification: the probit latent of every train case, with
  e = pred - latent.

One iteration: alpha, w0 and hyperprior draws (plain torch), then per
block the CUDA kernels
  case_stats or slot_stats (per-feature statistics GG of the block's
               dense features: case-major moment sums where the JAX
               engine's gate admits the block, else the slot path),
  schur_draw   (blocked Cholesky draw of every dense feature's theta),
  dual_draw    (the c x c Woodbury draw of every dual feature: one whose
               one segment of the JAX engine's width layout holds it
               whole, at a width W < k+1 and W <= 64),
  dense_update (case-major in-place update of A, over every feature) or,
               for a block whose entries cover fewer than num_rows // 4
               cases and for every block with dense_update=False,
  slot_update  (the same update over the block's slots, in case order:
               the JAX engine's slot scatter); with the test tail,
               dense_update also on the tail's rows,
then the unobserved-feature draws, the test prediction (fm_refresh, test
mode; with the tail, its pred column) and, every `refresh_every`
iterations, the train refresh (fm_refresh, train mode; for
classification its probit mode, which resamples the latents; with the
tail, train mode with y = 0 on the tail's rows as well). Classification
resamples the latents between refreshes too, from pred = e + latent
(probit_latent), which also sums the new e and its squares for the next
iteration's alpha and w0 draws. On CPU tensors each kernel wrapper runs
its plain PyTorch version.

This engine runs regression and probit classification on one device,
with case-major statistics, dual draws and the dense update on by
default as in the JAX engine, and the pure linear model (k = 0: P = [w],
each draw the scalar conjugate one). The incremental test tail is off by
default, as in JAX; set `flat_incr_test = True` on the learner, and it
steps aside silently where the JAX engine's does (a block on the slot
scatter, a test case holding two features of one block, a one-hot block
meeting a test value other than 1). Case reordering (`case_reorder`) is
off by default, as in JAX. Checkpoints (`checkpoint_path`,
`checkpoint_every`) save and resume the whole chain. Relational (BS)
data is routed as the JAX engine routes it (`_route_relational`): thin
joins are expanded and run here, fat ones on the BS vector engine
(learners/mcmc_rel_vector.py) or, with bs_vector off or a skewed join,
on the exact BS engine (learners/mcmc_relational.py). The train set, the
test set or both may be a `data.streaming.StreamingDataset` (out of
core): the blocks of a streamed train set come from its transpose
`<x_path>t`, each uploaded before the next is read, and the padded rows
of a streamed set fill the device chunk by chunk, so that the whole
matrix is never on the host (a block is: see learners/mcmc.py); the run is then the resident one's, bit for
bit (the test tail steps aside, as in JAX, and case reordering too). What
it does not take raises NotImplementedError with the ROADMAP item it
waits for: k = 0 on relational data and k > 128 on the card (§1 item 2)
and a mesh (§1 item 6). With an rlog each iteration writes one row.
"""

from __future__ import annotations

import numpy as np
import torch

from libfm_tpu_torch.data.batching import (
    case_columns,
    conflict_free_blocks,
    feature_slots,
    split_feature_slots,
)
from libfm_tpu_torch.data.relation import expand_join, expansion_cost
from libfm_tpu_torch.data.streaming import is_stream
from libfm_tpu_torch.data.vector_layout import single_segment_widths
from libfm_tpu_torch.kernels.case_stats import CaseStatsPlan, case_stats, moment_width
from libfm_tpu_torch.kernels.dense_update import dense_update, update_table
from libfm_tpu_torch.kernels.dual_draw import DualPlan, dual_draw
from libfm_tpu_torch.kernels.fm_refresh import fm_refresh
from libfm_tpu_torch.kernels.pieces import Pieces
from libfm_tpu_torch.kernels.probit_latent import probit_latent
from libfm_tpu_torch.kernels.schur_draw import schur_draw
from libfm_tpu_torch.kernels.slot_stats import gg_width, slot_stats
from libfm_tpu_torch.kernels.slot_update import case_order, slot_update
from libfm_tpu_torch.learners.mcmc import (
    HYPER,
    MCMCLearner,
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
    train_blocks,
)
from libfm_tpu_torch.learners.mcmc_rel_vector import (
    MAX_SKEW,
    bs_vector_skew,
    learn_relational_vector,
)
from libfm_tpu_torch.learners.mcmc_relational import learn_relational
from libfm_tpu_torch.ops import samplers
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION

#: the JAX engine's case-major chunk (`_cu_chunk`): the case count that
#: the case-major gate's cost term pads to
CU_CHUNK = 1 << 17


def dense_coverage(num_entries: int, num_rows: int) -> bool:
    """The JAX engine's coverage rule (mcmc_vector.py learn,
    `_dense_update_arrays`): a block whose entries cover at least
    num_rows // 4 cases takes the case-major dense update (with
    dense_update on); below that it takes the slot scatter, and its
    statistics stay on the slot path."""
    return num_entries >= num_rows // 4


def case_major_gate(num_dense: int, k: int, onehot: bool, num_entries: int,
                    num_rows: int) -> bool:
    """Whether a block takes case-major statistics, as the JAX engine
    decides (mcmc_vector.py learn: `_dense_update_arrays` and the gate
    after it): its entries pass `dense_coverage` (the learner also needs
    dense_update on), its moment table is small (Fd * MW <= 8e6) and the
    one-hot matmul's FLOPs Fd * MW * nc_up_pad stay <= 2e13, with
    nc_up_pad the case count rounded up to CU_CHUNK. Fd counts the dense
    (not dual) features, all of them while dual draws are off."""
    if not dense_coverage(num_entries, num_rows):
        return False
    MW = moment_width(k, onehot)
    nc_up_pad = -(-max(num_rows, 1) // CU_CHUNK) * CU_CHUNK
    return num_dense * MW <= 8_000_000 and float(num_dense) * MW * nc_up_pad <= 2e13


def dual_features(counts, d: int, widths=(32, 256)) -> np.ndarray:
    """Which features of a block (entry counts [F]) the JAX engine draws
    through the dual system (mcmc_vector.py learn, the dual/dense split):
    those whose one segment of `build_block_layout`'s layout holds the
    whole feature, at a width W < d and W <= 64."""
    W = single_segment_widths(counts, widths)
    return (W > 0) & (W < d) & (W <= 64)


class DevBlock:
    """Device copy of one conflict-free block. Its features are ordered
    dense first, then dual (`dual_features`, with `dual_draws`): `F`
    features, the first `Fd` drawn by `schur_draw` from their statistics,
    the other `Fu` by `dual_draw`. Each part has its own per-feature slot
    lists: `feat_off`, `slot_case`, `slot_val` and the global `feat_id`
    for the statistics kernels, `dual_off`, `dual_case`, `dual_val` (and
    `dual_plan`, their CTAs) for `dual_draw`. `scatter_update` says which
    update the block takes, as the JAX engine decides (`dense_coverage`,
    and always with dense_update off): with it, `upd_case`, `upd_val` and
    `upd_feat` are one slot list over all F features in case order
    (`case_order`; `upd_feat` the slot's feature's place in the block's
    order: dense, then dual) for `slot_update`, and
    `up_col`/`up_val` are None; without it, `up_col` and `up_val` are the
    per-case (feature, value) arrays `dense_update` reads, over every
    feature (val None: one-hot). `case_major` (with `case_major_stats`)
    takes the gate of the JAX engine on the dense count; `pieces` is the
    dense lists' cut for `slot_stats` (kernels/pieces.py) and `case_plan`
    (where `case_major`) `case_stats`' launch plan. `host_features` are
    the global ids in the block's order; `te_col`/`te_val` the
    incremental test tail's per-case arrays (`tail_columns`), set by the
    learner."""

    def __init__(self, block, groups, num_rows: int, device, k: int,
                 case_major_stats: bool, dual_draws: bool = False, widths=(32, 256),
                 dense_update: bool = True):
        F = len(block.features)
        off, sc, sv = feature_slots(block)
        dual = (dual_features(np.diff(off), k + 1, widths) if dual_draws
                else np.zeros(F, dtype=bool))
        (off_d, sc_d, sv_d, pos_d), (off_u, sc_u, sv_u, pos_u) = split_feature_slots(
            off, sc, sv, dual)
        order = np.concatenate([pos_d, pos_u])
        features = np.asarray(block.features)[order]
        self.F, self.Fd, self.Fu = F, len(pos_d), len(pos_u)
        self.host_features = features
        self.features = torch.as_tensor(features, dtype=torch.long, device=device)
        self.feat_id = torch.as_tensor(features[:self.Fd], dtype=torch.int32, device=device)
        self.groups = torch.as_tensor(np.asarray(groups)[order], dtype=torch.long,
                                      device=device)
        self.feat_off = torch.as_tensor(off_d, device=device)
        self.slot_case = torch.as_tensor(sc_d, device=device)
        self.slot_val = torch.as_tensor(sv_d, device=device)
        self.dual_off = torch.as_tensor(off_u, device=device)
        self.dual_case = torch.as_tensor(sc_u, device=device)
        self.dual_val = torch.as_tensor(sv_u, device=device)
        self.dual_plan = DualPlan(off_u, k + 1, device)
        self.onehot = bool((block.entry_vals == 1.0).all())
        num_entries = len(block.entry_rows)
        self.scatter_update = not (dense_update and dense_coverage(num_entries, num_rows))
        self.up_col = self.up_val = None
        self.upd_case = self.upd_val = self.upd_feat = None
        if self.scatter_update:
            counts = np.concatenate([np.diff(off_d), np.diff(off_u)])
            self.upd_case, self.upd_val, self.upd_feat = (
                torch.as_tensor(a, device=device) for a in case_order(
                    np.concatenate([sc_d, sc_u]), np.concatenate([sv_d, sv_u]),
                    np.repeat(np.arange(F, dtype=np.int32), counts)))
        else:
            col, val = case_columns(block, num_rows)
            rank = np.empty(F + 1, dtype=np.int32)  # block position -> place in `order`
            rank[order] = np.arange(F, dtype=np.int32)
            rank[F] = F
            self.up_col = torch.as_tensor(rank[col], device=device)
            self.up_val = None if self.onehot else torch.as_tensor(val, device=device)
        self.case_major = (case_major_stats and not self.scatter_update
                           and case_major_gate(self.Fd, k, self.onehot, num_entries, num_rows))
        self.pieces = Pieces(off_d, device)
        self.case_plan = CaseStatsPlan(off_d, k, device) if self.case_major else None
        self.te_col = self.te_val = None


def tail_columns(features, onehot: bool, test, num_features: int):
    """The incremental test tail's per-case arrays of one block, as the
    JAX engine builds its te_col/te_val (mcmc_vector.py learn): for every
    test case, the place in the block's order (`features`, global ids) of
    the one block feature it holds (F where it holds none) and that
    entry's value (0 where none; None for a one-hot block). Returns None
    where the tail cannot take the block: a test case holds two of its
    features, or the block is one-hot and a test value is not 1."""
    F = len(features)
    loc = np.full(num_features, F, np.int32)
    loc[features] = np.arange(F, dtype=np.int32)
    lc = loc[np.asarray(test.cols)]
    m = lc != F
    rows = test.row_of_entry[m]
    nc = test.num_rows
    if len(rows) and np.bincount(rows, minlength=nc).max() > 1:
        return None
    col = np.full(nc, F, np.int32)
    val = np.zeros(nc, np.float32)
    col[rows] = lc[m]
    val[rows] = np.asarray(test.vals, dtype=np.float32)[m]
    if onehot:
        return (col, None) if (val[col != F] == 1.0).all() else None
    return col, val


class MCMCVectorLearner(MCMCLearner):
    """MCMC/ALS with joint (w_j, v_j) vector draws on one device
    (`init_params` as MCMCLearner's)."""

    ALS_DEFAULT_REFRESH = 8

    def __init__(self, *args, widths=(32, 256), mesh=None, dual_draws=True,
                 dense_update=True, refresh_every=None, case_major_stats=True, **kwargs):
        super().__init__(*args, **kwargs)
        if mesh is not None:
            raise NotImplementedError("mesh (multi-GPU) waits for ROADMAP M13")
        # the JAX engine's segment widths: they decide which features take
        # the dual draw (dual_features), as in the JAX engine
        self.widths = widths
        # dual_draws: draw the whole-feature segments of few entries through
        # the c x c Woodbury system (dual_draw) instead of the dense d x d
        # one; the same distribution
        self.dual_draws = dual_draws
        # dense_update: apply each block's update to A case-major
        # (dense_update) where its entries cover at least num_rows // 4
        # cases, else by the slot scatter (slot_update); off: the slot
        # scatter for every block. The same update at another cost
        self.dense_update = dense_update
        if refresh_every is None:
            refresh_every = self.ALS_DEFAULT_REFRESH
        self.refresh_every = refresh_every
        self.case_major_stats = case_major_stats
        # case reordering (JAX `case_reorder`, off by default there too):
        # the train cases sorted by the dominant block's feature
        # (`_maybe_reorder_cases`) where A takes at least
        # case_reorder_min_bytes; `_case_reordered` says it was done. The
        # JAX engine then gathers that block's statistics from windows of
        # A of `slab_cases` cases (a TPU device for dynamic_slice); the
        # port's kernels read A's rows through slot lists, whose order is
        # all the reordering changes here, so slab_cases has no effect
        self.case_reorder = False
        self.case_reorder_min_bytes = 128 << 20
        self.slab_cases = None
        self._case_reordered = False
        # the incremental test tail, off by default as in the JAX engine;
        # incr_test says whether the last learn() ran a tail (this one, or
        # the BS engine's)
        self.flat_incr_test = False
        self.incr_test = False
        # relational (BS) routing (`_route_relational`) and the BS vector
        # engine's paths (learners/mcmc_rel_vector.py): the deferred path
        # for one relation, the incremental test tail; `deferred` says
        # whether the last learn() on the BS engine took the deferred path
        self.relational_mode = None
        self.expand_max_ratio = 8.0
        self.bs_vector = True
        self.bs_deferred = True
        self.bs_incr_test = True
        self.deferred = False

    def _maybe_reorder_cases(self, train):
        """The train cases sorted by the dominant conflict-free block's
        feature, as the JAX engine sorts them (`_maybe_reorder_cases`):
        a stable argsort of each case's feature in that block, cases
        outside it last, then `train.permuted(perm)`. Returns `train`
        unchanged when reordering is off, the data streams, A is below
        `case_reorder_min_bytes`, no block holds a quarter of the entries,
        or the dominant block would take case-major statistics (the JAX
        engine's own bound on it). A pure host-side step: every per-case
        metric is a sum, and the permutation is the data's, so a
        checkpoint resumes on the same order."""
        if not self.case_reorder or is_stream(train):
            return train
        nc, k = train.num_rows, self.cfg.num_factors
        if (nc + 1) * (1 + k) * 4 < self.case_reorder_min_bytes:
            return train  # A small enough for any order
        attr_group = self.attr_group_np
        if attr_group is None:
            attr_group = np.zeros(self.cfg.num_features, dtype=np.int32)
        blocks = conflict_free_blocks(train, attr_group=attr_group)
        if not blocks:
            return train
        sizes = [len(b.entry_rows) for b in blocks]
        bi = int(np.argmax(sizes))
        dom = blocks[bi]
        if sizes[bi] < 0.25 * sum(sizes):
            return train  # no dominant block
        MW = k * (k + 1) // 2 + 3 * k + 5
        Fd = len(dom.features)
        if self.case_major_stats and Fd * MW <= 8_000_000 and float(Fd) * MW * nc <= 2e13:
            return train  # the JAX engine's case-major bound: no slot path to sort for
        key = np.full(nc, np.iinfo(np.int64).max, dtype=np.int64)
        key[dom.entry_rows] = dom.entry_feat
        perm = np.argsort(key, kind="stable")
        if self.verbose:
            print(f"case reorder: sorting {nc} cases by block {bi} "
                  f"({Fd} features, {sizes[bi]} slots)")
        self._case_reordered = True
        if np.array_equal(perm, np.arange(nc)):
            return train
        return train.permuted(perm)

    def _route_relational(self, train, test):
        """Route block-structure (BS) data as the JAX engine does
        (mcmc_vector.py learn): a join whose materialisation costs at most
        200M entries and `expand_max_ratio` times the BS form (block tables
        that train and test share counted once) is expanded and runs on
        the flat engine ("expanded"); a fatter one runs on the BS vector
        engine ("bs_vector") when `bs_vector` is on and the join's skew is
        at most MAX_SKEW, and on the exact BS engine ("bs",
        learners/mcmc_relational.py) else. Sets `relational_mode` and
        returns the (train, test) the engine runs on."""
        exp_nnz, bs_nnz = expansion_cost(train)
        exp_nnz_te, bs_nnz_te = expansion_cost(test)
        shared_nnz = sum(
            jte.data.nnz for jte in test.relations
            if any(jte.data is jtr.data for jtr in train.relations)
        )
        bs_total = bs_nnz + bs_nnz_te - shared_nnz
        exp_total = exp_nnz + exp_nnz_te
        if exp_total <= 200_000_000 and exp_total <= self.expand_max_ratio * bs_total:
            self.relational_mode = "expanded"
            if self.verbose:
                print(f"BS join expanded: {exp_total} entries (BS form {bs_total}); "
                      "vector sweeps")
            return expand_join(train), expand_join(test)
        vector = self.bs_vector and bs_vector_skew(train) <= MAX_SKEW
        self.relational_mode = "bs_vector" if vector else "bs"
        return train, test

    # ------------------------------------------------------------ learn
    def learn(self, train, test):
        self._check_supported(train, test)
        if getattr(train, "relations", None):
            train, test = self._route_relational(train, test)
            if self.relational_mode == "bs_vector":
                return learn_relational_vector(self, train, test)
            if self.relational_mode == "bs":
                # the exact BS engine: libFM's per-coordinate draws over
                # block rows, whose cost does not grow with the join's skew
                self.incr_test = self.deferred = False
                return learn_relational(self, train, test)
        train = self._maybe_reorder_cases(train)
        cfg = self.cfg
        dev = self.device
        gen = self.generator
        f32 = torch.float32
        n, k = cfg.num_features, cfg.num_factors
        d = k + 1
        self.min_target = train.min_target
        self.max_target = train.max_target
        do_sample, do_multilevel = self.do_sample, self.do_multilevel
        alpha_0, gamma_0 = self.alpha_0, self.gamma_0
        min_t, max_t = float(self.min_target), float(self.max_target)
        draw_bound = samplers.DRAW_BOUND * max(1.0, abs(min_t), abs(max_t))
        use_linear, use_bias = cfg.use_linear, cfg.use_bias

        # ---- host layouts -> device
        attr_group_np, group_sums = attr_groups(self.attr_group_np, n, dev)
        attr_group = group_sums.ids
        G = group_sums.num_groups
        nc_train, nc_test = train.num_rows, test.num_rows
        # a StreamingDataset's blocks come from its transpose, each built
        # and uploaded before the next is read (train_blocks)
        blocks, observed = train_blocks(train, attr_group_np, lambda b: DevBlock(
            b, attr_group_np[b.features], nc_train, dev, k, self.case_major_stats,
            self.dual_draws, self.widths, self.dense_update))
        # the incremental test tail (JAX mcmc_vector.py learn, `incr_te`):
        # the test cases' [pred | Q] rows ride in A past the train rows and
        # take every block's update, so an iteration reads its test
        # prediction from A; it steps aside where the JAX engine's does,
        # and where either set streams
        incr_te = bool(self.flat_incr_test and nc_test > 0 and blocks
                       and not is_stream(train) and not is_stream(test)
                       and not any(b.scatter_update for b in blocks))
        if incr_te:
            tails = [tail_columns(b.host_features, b.onehot, test, n) for b in blocks]
            incr_te = all(t is not None for t in tails)
        if incr_te:
            for b, (col, val) in zip(blocks, tails):
                b.te_col = torch.as_tensor(col, device=dev)
                b.te_val = None if val is None else torch.as_tensor(val, device=dev)
            del tails
        self.incr_test = incr_te
        unobserved = torch.as_tensor(np.nonzero(~observed)[0], dtype=torch.long, device=dev)

        tr_ids, tr_pv = padded_rows(train, dev)
        te_ids, te_pv = padded_rows(test, dev)
        y_train = torch.as_tensor(train.target, dtype=f32, device=dev)
        y_test = torch.as_tensor(test.target, dtype=f32, device=dev)
        nec = self.num_eval_cases if self.num_eval_cases is not None else nc_test
        eval_mask = (torch.arange(nc_test, device=dev) < nec).to(f32)

        P, st = initial_state(self, self.init_params, n, k, G, nc_test)
        classify = self.task == TASK_CLASSIFICATION
        if incr_te:
            # the tail starts at the first row past the train rows whose
            # offset is whole 16-byte pieces: dense_update and fm_refresh
            # move A's rows by bulk copies
            test_off = -(-nc_train // 4) * 4
            A_rows = torch.empty(test_off + nc_test, d, dtype=f32, device=dev)
            A, A_te = A_rows[:nc_train], A_rows[test_off:]
            y_te0 = torch.zeros(nc_test, dtype=f32, device=dev)
        else:
            A = torch.empty(nc_train, d, dtype=f32, device=dev)
            A_te = None

        def refresh_tail(w0):
            """Re-ground the tail: A_te = [pred | Q] of every test case
            (fm_refresh's train mode with y = 0 writes the pred unclipped)."""
            fm_refresh(P, te_ids, te_pv, w0, y_te0, A_te, use_linear=use_linear,
                       use_bias=use_bias)

        # the initial refresh takes e = pred - y for both tasks (libFM
        # fm_learn_mcmc_simultaneous.h:70-86): the latents start at y
        fm_refresh(P, tr_ids, tr_pv, st["w0"], y_train, A, use_linear=use_linear,
                   use_bias=use_bias, min_target=min_t, max_target=max_t)
        if incr_te:
            refresh_tail(st["w0"])
        latent = y_train.clone() if classify else None
        probit = None if not classify else "sample" if do_sample else "mean"
        GG_buf = torch.empty(
            max([b.Fd for b in blocks], default=0), gg_width(k), dtype=f32, device=dev
        )

        def sweep_block(blk, alpha, w_mu, w_lambda, v_mu, v_lambda):
            """Joint draws for every feature of one block (the dense ones,
            then the dual ones); updates A and P in place and returns the
            number of rejected draws."""
            theta_old = P[blk.features]  # [F, d] (a copy)
            lam = torch.cat([w_lambda[blk.groups][:, None], v_lambda[blk.groups]], dim=1)
            mu_pr = torch.cat([w_mu[blk.groups][:, None], v_mu[blk.groups]], dim=1)
            if not use_linear:
                # freeze w: infinite prior precision at prior mean 0
                lam[:, 0] = 1e30
                mu_pr[:, 0] = 0.0
            Fd = blk.Fd
            drawn, rej = [], []
            if Fd:
                if blk.case_major:
                    GG = case_stats(A, P, blk.feat_off, blk.slot_case, blk.slot_val,
                                    blk.feat_id, onehot=blk.onehot,
                                    use_linear=use_linear, GG=GG_buf,
                                    pieces=blk.case_plan)
                else:
                    GG = slot_stats(A, P, blk.feat_off, blk.slot_case, blk.slot_val,
                                    blk.feat_id, use_linear=use_linear, GG=GG_buf,
                                    pieces=blk.pieces)
                z = (torch.randn(Fd, d, generator=gen, device=dev)
                     if do_sample else None)
                th, r = schur_draw(GG, theta_old[:Fd], lam[:Fd], mu_pr[:Fd], z, alpha,
                                   do_sample=do_sample, bound=draw_bound)
                drawn.append(th)
                rej.append(r.sum())
            if blk.Fu:
                u, dl = ((torch.randn(blk.Fu, d, generator=gen, device=dev),
                          torch.randn(blk.dual_case.shape[0], generator=gen, device=dev))
                         if do_sample else (None, None))
                th, r = dual_draw(A, blk.dual_off, blk.dual_case, blk.dual_val,
                                  theta_old[Fd:], lam[Fd:], mu_pr[Fd:], u, dl, alpha,
                                  do_sample=do_sample, bound=draw_bound,
                                  use_linear=use_linear, plan=blk.dual_plan)
                drawn.append(th)
                rej.append(r.sum())
            theta_new = drawn[0] if len(drawn) == 1 else torch.cat(drawn)
            # the table uses the PRE-draw V (qp = Q - x v_old); it covers
            # the dense and the dual features alike
            tab = update_table(theta_old, theta_new)
            if blk.scatter_update:
                slot_update(A, blk.upd_case, blk.upd_val, blk.upd_feat, tab)
            else:
                dense_update(A, blk.up_col, blk.up_val, tab)
            if blk.te_col is not None:
                dense_update(A_te, blk.te_col, blk.te_val, tab)
            P[blk.features] = theta_new
            return sum(rej)

        # probit_latent's sums of A[:, 0] as it left it, for the next
        # draw_all only (a refresh rewrites A; the w0 shift moves it)
        carried = {}

        def draw_all():
            rej = torch.zeros((), dtype=torch.int64, device=dev)
            e = A[:, 0]
            sums = carried.pop("sums", None)
            if sums is None:
                alpha, r = draw_alpha(gen, e, nc_train, st["alpha"], alpha_0, gamma_0,
                                      do_multilevel, do_sample)
            else:
                alpha, r = draw_alpha_from_sum(gen, sums[1], nc_train, st["alpha"], alpha_0,
                                               gamma_0, do_multilevel, do_sample)
            rej += r
            w0 = st["w0"]
            if use_bias:
                w0_new, r = draw_w0(self, e.sum() if sums is None else sums[0], nc_train,
                                    w0, alpha, draw_bound)
                rej += r
                A[:, 0] += w0_new - w0
                if incr_te:
                    # the tail holds pred, which moves with w0 too
                    A_te[:, 0] += w0_new - w0
                w0 = w0_new
            hyper, r = draw_sweep_hyperpriors(self, P, group_sums, st)
            rej += r
            for blk in blocks:
                rej += sweep_block(blk, alpha, *hyper)
            rej += draw_unobserved(self, P, unobserved, attr_group, hyper, draw_bound)
            st.update(w0=w0, alpha=alpha, **dict(zip(HYPER, hyper)))
            return rej

        def one_step(it, refresh):
            rej = draw_all()
            w0 = st["w0"]
            # the tail's pred column, kept current by the updates and the
            # w0 shifts (the unobserved features' draws reach it only at
            # the next refresh, as in the JAX engine)
            pred_test = (A_te[:, 0].clone() if incr_te else
                         fm_refresh(P, te_ids, te_pv, w0, use_linear=use_linear,
                                    use_bias=use_bias))
            U = (torch.rand(nc_train, generator=gen, device=dev)
                 if classify and do_sample else None)
            if refresh:
                m = fm_refresh(P, tr_ids, tr_pv, w0, y_train, A,
                               use_linear=use_linear, use_bias=use_bias,
                               min_target=min_t, max_target=max_t, probit=probit,
                               U=U, latent=latent)
                if incr_te:
                    refresh_tail(w0)
                train_metric = (m / max(nc_train, 1) if classify
                                else torch.sqrt(m / max(nc_train, 1)))
            elif classify:
                # the sweeps keep e = pred - latent current: resample the
                # latents from pred = e + latent, no pass over P
                correct, *carried["sums"] = probit_latent(A, latent, y_train, U)
                train_metric = correct / max(nc_train, 1)
            else:
                # the sweeps keep A = [e | Q] current (up to f32 drift,
                # cleared by the periodic refresh): pred = e + y
                err = (A[:, 0] + y_train).clamp(min_t, max_t) - y_train
                train_metric = torch.sqrt((err * err).sum() / max(nc_train, 1))
            return step_metrics(self, st, it, pred_test, train_metric, rej, y_test,
                                eval_mask)

        def bufs():
            # besides P and A: the incremental test tail and the probit
            # latents (a save follows a refresh, so `carried` is empty)
            out = dict(P=P, A=A)
            if incr_te:
                out["A_te"] = A_te
            if classify:
                out["latent"] = latent
            return out

        return run_iterations(self, "vector", one_step, P, st, bufs, self.refresh_every)


class ALSVectorLearner(MCMCVectorLearner):
    """Vector-wise ALS (block coordinate descent on whole (w_j, v_j))."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("do_sample", False)
        kwargs.setdefault("do_multilevel", False)
        super().__init__(*args, **kwargs)

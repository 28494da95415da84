"""Vector-sweep MCMC/ALS engine (PyTorch, one device).

The port of `libfm_tpu.learners.mcmc_vector`: each feature's whole
parameter vector theta_j = (w_j, v_j) is drawn jointly from its exact
Gaussian conditional, one conflict-free block at a time (blocked Gibbs;
with do_sample=False, vector-wise block coordinate descent — ALS).

State on the device:
- P = [w | V] [n, k+1], the packed parameter table (w and V are views);
- A = [e | Q] [num_train, k+1], the per-case residual and per-factor
  linear caches, maintained incrementally by every block's update and
  rewritten by the periodic refresh;
- classification: the probit latent of every train case, with
  e = pred - latent.

One iteration: alpha, w0 and hyperprior draws (plain torch), then per
block the three CUDA kernels
  case_stats or slot_stats (per-feature statistics GG: case-major moment
               sums where the JAX engine's gate admits the block, else
               the slot path),
  schur_draw   (blocked Cholesky draw of every feature's theta),
  dense_update (case-major in-place update of A),
then the unobserved-feature draws, the test prediction (fm_refresh, test
mode) and, every `refresh_every` iterations, the train refresh
(fm_refresh, train mode; for classification its probit mode, which
resamples the latents). Classification resamples the latents between
refreshes too, from pred = e + latent (probit_latent). On CPU tensors
each kernel wrapper runs its plain PyTorch version.

This slice runs regression and probit classification on one device,
with case-major statistics on by default as in the JAX engine. What it
does not take raises NotImplementedError with the ROADMAP item it waits
for: dual (Woodbury) draws (kernel K7, M7 c; `dual_draws` defaults to
False here, True in the JAX engine, which draws the same distribution),
the incremental test tail (M7), case reordering and slabs (M7),
streaming data (M7), relational data (M9), a mesh (M13), checkpoints and
rlog (M7). The update always runs as the case-major dense pass (the JAX
engine's low-coverage slot-scatter fallback computes the same update).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from libfm_tpu_torch.data.batching import (
    case_columns,
    conflict_free_blocks,
    feature_slots,
)
from libfm_tpu_torch.data.vector_layout import padded_rows_layout
from libfm_tpu_torch.kernels.case_stats import case_stats, moment_width
from libfm_tpu_torch.kernels.dense_update import dense_update, update_table
from libfm_tpu_torch.kernels.fm_refresh import fm_refresh
from libfm_tpu_torch.kernels.pieces import Pieces
from libfm_tpu_torch.kernels.probit_latent import probit_latent
from libfm_tpu_torch.kernels.schur_draw import schur_draw
from libfm_tpu_torch.kernels.slot_stats import gg_width, slot_stats
from libfm_tpu_torch.learners import base as _base
from libfm_tpu_torch.learners.mcmc import (
    MCMCLearner,
    _masked_acc_ll,
    _masked_auc,
    _masked_rmse_mae,
    dispatch_chunks,
    draw_alpha,
    draw_theta_hyperpriors,
)
from libfm_tpu_torch.models.fm import init_fm
from libfm_tpu_torch.ops import samplers
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION
from libfm_tpu_torch.utils.timers import iter_clocks

#: the CUDA kernels take k <= 128
MAX_FACTORS_CUDA = 128
#: the JAX engine's case-major chunk (`_cu_chunk`): the case count that
#: the case-major gate's cost term pads to
CU_CHUNK = 1 << 17


def case_major_gate(num_dense: int, k: int, onehot: bool, num_entries: int,
                    num_rows: int) -> bool:
    """Whether a block takes case-major statistics, as the JAX engine
    decides (mcmc_vector.py learn: `_dense_update_arrays` and the gate
    after it): its entries cover at least num_rows // 4 cases (else the
    JAX engine updates by the slot scatter and keeps the slot path), its
    moment table is small (Fd * MW <= 8e6) and the one-hot matmul's
    FLOPs Fd * MW * nc_up_pad stay <= 2e13, with nc_up_pad the case
    count rounded up to CU_CHUNK. Fd counts the dense (not dual)
    features, all of them while dual draws are off."""
    if num_entries < num_rows // 4:
        return False
    MW = moment_width(k, onehot)
    nc_up_pad = -(-max(num_rows, 1) // CU_CHUNK) * CU_CHUNK
    return num_dense * MW <= 8_000_000 and float(num_dense) * MW * nc_up_pad <= 2e13


class DevBlock:
    """Device copy of one conflict-free block: its features and groups,
    the per-feature slot lists `slot_stats` and `case_stats` read, and
    the per-case (feature, value) arrays `dense_update` reads (val None:
    one-hot). `case_major` (with `case_major_stats`) takes the gate of
    the JAX engine; `pieces` is the block's cut for the statistics
    kernels (kernels/pieces.py), whichever of the two runs."""

    def __init__(self, block, groups, num_rows: int, device, k: int,
                 case_major_stats: bool):
        F = len(block.features)
        self.F = F
        self.features = torch.as_tensor(block.features, dtype=torch.long, device=device)
        self.feat_id = torch.as_tensor(block.features, dtype=torch.int32, device=device)
        self.groups = torch.as_tensor(groups, dtype=torch.long, device=device)
        off, sc, sv = feature_slots(block)
        self.feat_off = torch.as_tensor(off, device=device)
        self.slot_case = torch.as_tensor(sc, device=device)
        self.slot_val = torch.as_tensor(sv, device=device)
        col, val = case_columns(block, num_rows)
        self.up_col = torch.as_tensor(col, device=device)
        self.onehot = bool((block.entry_vals == 1.0).all())
        self.up_val = None if self.onehot else torch.as_tensor(val, device=device)
        self.case_major = case_major_stats and case_major_gate(
            F, k, self.onehot, len(block.entry_rows), num_rows)
        self.pieces = Pieces(off, device)


class MCMCVectorLearner(MCMCLearner):
    """MCMC/ALS with joint (w_j, v_j) vector draws on one device.

    `init_params=(w0, w, V)` (numpy arrays or tensors) starts the chain
    from the given parameters instead of the learner's own N(init_mean,
    init_stdev) draw (see convert.params_from_jax)."""

    ALS_DEFAULT_REFRESH = 8

    def __init__(self, *args, mesh=None, dual_draws=False, refresh_every=None,
                 case_major_stats=True, init_params=None, **kwargs):
        super().__init__(*args, **kwargs)
        if mesh is not None:
            raise NotImplementedError("mesh (multi-GPU) waits for ROADMAP M13")
        self.dual_draws = dual_draws
        if refresh_every is None:
            refresh_every = self.ALS_DEFAULT_REFRESH
        self.refresh_every = refresh_every
        self.case_major_stats = case_major_stats
        self.case_reorder = False
        self.flat_incr_test = False
        self.init_params = init_params

    def _check_supported(self, train, test):
        _base.check_num_features(self.cfg, train, test)
        k = self.cfg.num_factors
        why = None
        if getattr(train, "relations", None) or getattr(test, "relations", None):
            why = "relational (BS) data waits for ROADMAP M9"
        elif not hasattr(train, "indptr") or not hasattr(test, "indptr"):
            why = "streaming data waits for ROADMAP M7"
        elif self.dual_draws:
            why = "dual (Woodbury) draws, kernel K7, wait for ROADMAP M7 c"
        elif self.flat_incr_test:
            why = "the incremental test tail waits for ROADMAP M7"
        elif self.case_reorder:
            why = "case reordering and slab gathers wait for ROADMAP M7"
        elif k < 1:
            why = "the pure linear model (k=0) waits for ROADMAP M7"
        elif self.device.type == "cuda" and k > MAX_FACTORS_CUDA:
            why = f"the CUDA kernels take k <= {MAX_FACTORS_CUDA}"
        if why:
            raise NotImplementedError(why)

    # ------------------------------------------------------------ learn
    def learn(self, train, test):
        self._check_supported(train, test)
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
        beta_0, mu_0 = self.beta_0, self.mu_0
        min_t, max_t = float(self.min_target), float(self.max_target)
        draw_bound = samplers.DRAW_BOUND * max(1.0, abs(min_t), abs(max_t))
        use_linear, use_bias = cfg.use_linear, cfg.use_bias

        # ---- host layouts -> device
        attr_group_np = self.attr_group_np
        if attr_group_np is None:
            attr_group_np = np.zeros(n, dtype=np.int32)
        G = int(attr_group_np.max()) + 1
        attr_group = torch.as_tensor(attr_group_np, dtype=torch.long, device=dev)
        num_attr_per_group = torch.as_tensor(
            np.bincount(attr_group_np, minlength=G).astype(np.float32), device=dev
        )
        nc_train, nc_test = train.num_rows, test.num_rows
        blocks = []
        observed = np.zeros(n, dtype=bool)
        for b in conflict_free_blocks(train, attr_group=attr_group_np):
            observed[b.features] = True
            blocks.append(DevBlock(b, attr_group_np[b.features], nc_train, dev, k,
                                   self.case_major_stats))
        unobserved = torch.as_tensor(np.nonzero(~observed)[0], dtype=torch.long, device=dev)
        n_unobs = int(unobserved.shape[0])

        def _rows(ds):
            ids, vals = padded_rows_layout(ds.indptr, ds.cols, ds.vals)
            return torch.as_tensor(ids, device=dev), torch.as_tensor(vals, device=dev)

        tr_ids, tr_pv = _rows(train)
        te_ids, te_pv = _rows(test)
        y_train = torch.as_tensor(train.target, dtype=f32, device=dev)
        y_test = torch.as_tensor(test.target, dtype=f32, device=dev)
        nec = self.num_eval_cases if self.num_eval_cases is not None else nc_test
        eval_mask = (torch.arange(nc_test, device=dev) < nec).to(f32)

        # ---- parameters
        if self.init_params is not None:
            w0, w, V = (
                (x if torch.is_tensor(x) else torch.tensor(np.asarray(x)))
                .to(device=dev, dtype=f32).reshape(shape)
                for x, shape in zip(self.init_params, ((), (n,), (n, k)))
            )
        else:
            init = init_fm(cfg, gen, mcmc_style_w=True)
            w0, w, V = init.w0, init.w, init.v
        if self.warm_start is not None:
            V = torch.as_tensor(self.warm_start.v, dtype=f32, device=dev)
            w0 = torch.as_tensor(self.warm_start.w0, dtype=f32, device=dev).reshape(())
        if not use_linear:
            w = torch.zeros(n, dtype=f32, device=dev)
        P = torch.cat([w[:, None], V], dim=1).contiguous()  # [n, d]
        w_lambda = (
            torch.as_tensor(self._w_lambda_vec, dtype=f32, device=dev)
            if self._w_lambda_vec is not None
            else torch.full((G,), float(self._init_w_lambda), dtype=f32, device=dev)
        )
        v_lambda = (
            torch.as_tensor(self._v_lambda_vec, dtype=f32, device=dev)
            if self._v_lambda_vec is not None
            else torch.full((G, k), float(self._init_v_lambda), dtype=f32, device=dev)
        )
        st = dict(
            w0=w0,
            alpha=torch.tensor(1.0, dtype=f32, device=dev),
            w_mu=torch.zeros(G, dtype=f32, device=dev), w_lambda=w_lambda,
            v_mu=torch.zeros(G, k, dtype=f32, device=dev), v_lambda=v_lambda,
            pred_this=torch.zeros(nc_test, dtype=f32, device=dev),
            pred_sum_all=torch.zeros(nc_test, dtype=f32, device=dev),
            pred_sum_all_but5=torch.zeros(nc_test, dtype=f32, device=dev),
        )
        classify = self.task == TASK_CLASSIFICATION
        A = torch.empty(nc_train, d, dtype=f32, device=dev)
        # the initial refresh takes e = pred - y for both tasks (libFM
        # fm_learn_mcmc_simultaneous.h:70-86): the latents start at y
        fm_refresh(P, tr_ids, tr_pv, w0, y_train, A, use_linear=use_linear,
                   use_bias=use_bias, min_target=min_t, max_target=max_t)
        latent = y_train.clone() if classify else None
        probit = None if not classify else "sample" if do_sample else "mean"
        GG_buf = torch.empty(
            max([b.F for b in blocks], default=0), gg_width(k), dtype=f32, device=dev
        )

        def sweep_block(blk, alpha, w_mu, w_lambda, v_mu, v_lambda):
            """Joint draws for every feature of one block; updates A and P
            in place and returns the number of rejected draws."""
            theta_old = P[blk.features]  # [F, d] (a copy)
            if blk.case_major:
                GG = case_stats(A, P, blk.feat_off, blk.slot_case, blk.slot_val,
                                blk.feat_id, onehot=blk.onehot, use_linear=use_linear,
                                GG=GG_buf, pieces=blk.pieces)
            else:
                GG = slot_stats(A, P, blk.feat_off, blk.slot_case, blk.slot_val,
                                blk.feat_id, use_linear=use_linear, GG=GG_buf,
                                pieces=blk.pieces)
            lam = torch.cat([w_lambda[blk.groups][:, None], v_lambda[blk.groups]], dim=1)
            mu_pr = torch.cat([w_mu[blk.groups][:, None], v_mu[blk.groups]], dim=1)
            if not use_linear:
                # freeze w: infinite prior precision at prior mean 0
                lam[:, 0] = 1e30
                mu_pr[:, 0] = 0.0
            z = (torch.randn(blk.F, d, generator=gen, device=dev)
                 if do_sample else None)
            theta_new, rej = schur_draw(GG, theta_old, lam, mu_pr, z, alpha,
                                        do_sample=do_sample, bound=draw_bound)
            # the table uses the PRE-draw V (qp = Q - x v_old)
            dense_update(A, blk.up_col, blk.up_val, update_table(theta_old, theta_new))
            P[blk.features] = theta_new
            return rej.sum()

        def draw_all():
            rej = torch.zeros((), dtype=torch.int64, device=dev)
            e = A[:, 0]
            alpha, r = draw_alpha(gen, e, nc_train, st["alpha"], alpha_0, gamma_0,
                                  do_multilevel, do_sample)
            rej += r
            w0 = st["w0"]
            if use_bias:
                acc = e.sum() - nc_train * w0
                sigma_sqr = 1.0 / (self.reg0 + alpha * nc_train)
                mean = -sigma_sqr * (alpha * acc - self.w0_mean_0 * self.reg0)
                prop = (samplers.gaussian(gen, mean, torch.sqrt(sigma_sqr))
                        if do_sample else mean)
                w0_new, r = samplers.finite_or(prop, w0, bound=draw_bound)
                rej += r
                A[:, 0] += w0_new - w0
                w0 = w0_new
            w_mu, w_lambda = st["w_mu"], st["w_lambda"]
            v_mu, v_lambda = st["v_mu"], st["v_lambda"]
            if do_multilevel:
                if use_linear:
                    w_lambda, w_mu, r = draw_theta_hyperpriors(
                        gen, P[:, 0], attr_group, num_attr_per_group, w_mu,
                        w_lambda, alpha_0, gamma_0, beta_0, mu_0, do_sample,
                    )
                    rej += r
                v_lambda, v_mu, r = draw_theta_hyperpriors(
                    gen, P[:, 1:], attr_group, num_attr_per_group, v_mu,
                    v_lambda, alpha_0, gamma_0, beta_0, mu_0, do_sample,
                )
                rej += r
            else:
                w_mu = torch.full_like(w_mu, mu_0)
                v_mu = torch.full_like(v_mu, mu_0)

            for blk in blocks:
                rej += sweep_block(blk, alpha, w_mu, w_lambda, v_mu, v_lambda)

            if n_unobs:
                # features in no block: posterior == prior
                # (libFM fm_learn_mcmc.h:467-476)
                g_u = attr_group[unobserved]
                if do_sample:
                    w_u = samplers.gaussian(gen, w_mu[g_u], torch.sqrt(1.0 / w_lambda[g_u]))
                    v_u = samplers.gaussian(gen, v_mu[g_u], torch.sqrt(1.0 / v_lambda[g_u]))
                else:
                    w_u = w_mu[g_u]
                    v_u = v_mu[g_u] + torch.zeros(n_unobs, k, dtype=f32, device=dev)
                w_u, r1 = samplers.finite_or(w_u, P[unobserved, 0], bound=draw_bound)
                v_u, r2 = samplers.finite_or(v_u, P[unobserved, 1:], bound=draw_bound)
                rej += r1 + r2
                if use_linear:
                    P[unobserved, 0] = w_u
                P[unobserved, 1:] = v_u
            st.update(w0=w0, alpha=alpha, w_mu=w_mu, w_lambda=w_lambda,
                      v_mu=v_mu, v_lambda=v_lambda)
            return rej

        def one_step(it, refresh):
            rej = draw_all()
            w0 = st["w0"]
            pred_test = fm_refresh(P, te_ids, te_pv, w0, use_linear=use_linear,
                                   use_bias=use_bias)
            U = (torch.rand(nc_train, generator=gen, device=dev)
                 if classify and do_sample else None)
            if refresh:
                m = fm_refresh(P, tr_ids, tr_pv, w0, y_train, A,
                               use_linear=use_linear, use_bias=use_bias,
                               min_target=min_t, max_target=max_t, probit=probit,
                               U=U, latent=latent)
                train_metric = (m / max(nc_train, 1) if classify
                                else torch.sqrt(m / max(nc_train, 1)))
            elif classify:
                # the sweeps keep e = pred - latent current: resample the
                # latents from pred = e + latent, no pass over P
                train_metric = probit_latent(A, latent, y_train, U) / max(nc_train, 1)
            else:
                # the sweeps keep A = [e | Q] current (up to f32 drift,
                # cleared by the periodic refresh): pred = e + y
                err = (A[:, 0] + y_train).clamp(min_t, max_t) - y_train
                train_metric = torch.sqrt((err * err).sum() / max(nc_train, 1))
            if classify:
                p_test = samplers.cdf_gaussian(pred_test)
                metric = _masked_acc_ll
            else:
                p_test = pred_test.clamp(min_t, max_t)
                metric = partial(_masked_rmse_mae, min_t=min_t, max_t=max_t)
            st["pred_this"] = p_test if classify else pred_test
            st["pred_sum_all"] = st["pred_sum_all"] + p_test
            if it >= 5:
                st["pred_sum_all_but5"] = st["pred_sum_all_but5"] + p_test
            n_all = it + 1.0
            n_but5 = max(it - 4.0, 1e-12)
            m_this = metric(st["pred_this"], y_test, eval_mask, normalizer=1.0)
            m_all = metric(st["pred_sum_all"], y_test, eval_mask, normalizer=1.0 / n_all)
            m_but5 = metric(st["pred_sum_all_but5"], y_test, eval_mask,
                            normalizer=1.0 / n_but5)
            extra = [_masked_auc(st["pred_sum_all"], y_test, eval_mask)] if classify else []
            vals = torch.stack([
                train_metric, *m_this, *m_all, *m_but5, st["alpha"],
                rej.to(f32), *extra,
            ]).tolist()  # one device-to-host copy per iteration
            out = dict(
                train=vals[0], this=vals[1:3], all=vals[3:5], but5=vals[5:7],
                alpha=vals[7], rejected=int(vals[8]),
            )
            if classify:
                out["auc"] = vals[9]
            return out

        self.history = []
        for i0, L in dispatch_chunks(0, self.num_iter, self.refresh_every):
            for it in range(i0, i0 + L):
                c0 = iter_clocks(dev)
                # a named range for torch.profiler traces (chip_smoke.py --profile)
                with torch.profiler.record_function(f"iteration {it}"):
                    metrics = one_step(it, refresh=(it == i0 + L - 1))
                c1 = iter_clocks(dev)
                self._log_iteration(it, metrics, tuple(b - a for a, b in zip(c0, c1)))
        self._final_state = dict(st, w=P[:, 0].clone(), V=P[:, 1:].clone())
        return self.history


class ALSVectorLearner(MCMCVectorLearner):
    """Vector-wise ALS (block coordinate descent on whole (w_j, v_j))."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("do_sample", False)
        kwargs.setdefault("do_multilevel", False)
        super().__init__(*args, **kwargs)

"""ALS / MCMC (Gibbs) learner and the flat exact engine.

The port of `libfm_tpu.learners.mcmc`. It carries the learner's
configuration surface (constructor, `set_regularization`, per-iteration
logging, `predict`, `get_params`), the hyperparameter draws
(`draw_alpha`, `draw_alpha_from_sum`, `draw_theta_hyperpriors`), the
refresh cadence (`dispatch_chunks`), the masked test metrics (RMSE/MAE
for regression, accuracy/log10-likelihood and AUC for probit
classification), the steps every engine shares (the initial state, the
w0, hyperprior and unobserved-feature draws, the per-iteration metrics)
and the exact per-coordinate engine (`-engine exact`, `MCMCLearner` /
`ALSLearner`): libFM's Gibbs scan, one coordinate of w, then of each
factor of V, at a time, drawn in parallel within a conflict-free block
(`coord_draw`), the caches A = [e | Q] re-predicted every iteration
(`fm_refresh`). Relational (BS) data runs on the exact BS engine
(learners/mcmc_relational.py). The vector engines (learners/mcmc_vector.py,
learners/mcmc_rel_vector.py) run on top of the shared steps. The flat
engines take a `data.streaming.StreamingDataset` for the train set, the
test set or both (`train_blocks`, `padded_rows`): the blocks come from the
train set's transpose and the rows fill the device chunk by chunk, so the
run is the resident one's, and the host never holds the whole matrix: at
most the blocks the transpose's reader has open, the one being built
into its slot lists, and one window. Where a block holds a large share
of the entries (at two one-hot fields, every row's user entry), so does
the host.

ALS is MCMC with do_sample=False, do_multilevel=False — posterior means
instead of draws (libFM src/libfm/libfm.cpp:135-139).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from libfm_tpu_torch.data.batching import conflict_free_blocks, feature_slots
from libfm_tpu_torch.data.streaming import is_stream, stream_blocks
from libfm_tpu_torch.data.vector_layout import padded_rows_layout
from libfm_tpu_torch.device import resolve_device
from libfm_tpu_torch.kernels.coord_draw import DrawPlan, coord_draw
from libfm_tpu_torch.kernels.fm_refresh import fm_refresh
from libfm_tpu_torch.kernels.probit_latent import capped_squares
from libfm_tpu_torch.learners import base as _base
from libfm_tpu_torch.learners.base import RANGE_OF_K, rmse_mae
from libfm_tpu_torch.models.fm import FMConfig, FMParams, init_fm
from libfm_tpu_torch.ops import samplers
from libfm_tpu_torch.ops.segment import GroupSums
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION, TASK_REGRESSION
from libfm_tpu_torch.utils.timers import iter_clocks


#: the hyperparameters a sweep draws with (`draw_sweep_hyperpriors`'
#: order)
HYPER = ("w_mu", "w_lambda", "v_mu", "v_lambda")

# --------------------------------------------------------------------------
# Hyperprior draws
# --------------------------------------------------------------------------


def draw_alpha(generator, e, num_cases, alpha, alpha_0, gamma_0,
               do_multilevel, do_sample):
    """Noise precision alpha (libFM fm_learn_mcmc.h:911-939); ALS keeps
    alpha = alpha_0. Returns (alpha 0-dim tensor, rejected count).

    Each e^2 and the total are clamped so a runaway residual gives a tiny
    positive alpha instead of an infinite rate, and a proposal that is
    not finite or not > 0 keeps the old alpha (counted)."""
    if not do_multilevel:
        return (
            torch.tensor(alpha_0, dtype=e.dtype, device=e.device),
            torch.zeros((), dtype=torch.int64, device=e.device),
        )
    alpha_n = alpha_0 + num_cases
    gamma_n = (gamma_0 + capped_squares(e).sum()).clamp_max(1e37)
    proposal = samplers.gamma(generator, alpha_n / 2.0, gamma_n / 2.0)
    ok = torch.isfinite(proposal) & (proposal > 0.0)
    return torch.where(ok, proposal, alpha), (~ok).sum()


def draw_alpha_from_sum(generator, sum_e2, num_cases, alpha, alpha_0, gamma_0,
                        do_multilevel, do_sample):
    """draw_alpha when only sum(e^2) is at hand (the BS engine's deferred
    path sums it in closed form from block-row caches; probit_latent hands
    the probit fast path's next draw the sum of capped squares): the same
    formula, with the runaway clamp on the sum. On draw_alpha's per-element
    capped sum (each term <= 1e30, the sum finite) it gives draw_alpha's
    gamma_n exactly: both cap gamma_0 + sum at 1e37."""
    if not do_multilevel:
        return (
            torch.tensor(alpha_0, dtype=sum_e2.dtype, device=sum_e2.device),
            torch.zeros((), dtype=torch.int64, device=sum_e2.device),
        )
    alpha_n = alpha_0 + num_cases
    s = torch.nan_to_num(sum_e2, nan=1e37, posinf=1e37, neginf=1e37).clamp_max(1e37)
    gamma_n = (gamma_0 + s).clamp_max(1e37)
    proposal = samplers.gamma(generator, alpha_n / 2.0, gamma_n / 2.0)
    ok = torch.isfinite(proposal) & (proposal > 0.0)
    return torch.where(ok, proposal, alpha), (~ok).sum()


def draw_theta_hyperpriors(generator, theta, groups, mu_cur, lambda_cur, alpha_0, gamma_0,
                           beta_0, mu_0, do_sample):
    """Draw (lambda, mu) per group for theta [n] (w; lambda, mu [G]) or
    theta [n, k] (V, each factor on its own; lambda, mu [G, k]): lambda
    first with the current mu, then mu with the new lambda (libFM
    fm_learn_mcmc.h:444-445; draw_w_lambda :980-1017, draw_w_mu
    :941-978). `groups` (ops.segment.GroupSums) holds each row's group
    and sums each group's rows in a fixed order, so the draws take the
    same bits on every run. Returns (lambda, mu, rejected count)."""
    G = groups.num_groups
    num_attr_per_group = groups.count.reshape((G,) + (1,) * (theta.dim() - 1))
    sum_theta = groups(theta)
    dev = theta - mu_cur[groups.ids]
    lambda_gamma = beta_0 * (mu_cur - mu_0) ** 2 + gamma_0 + groups(dev * dev)
    lambda_alpha = alpha_0 + num_attr_per_group + 1.0
    if do_sample:
        lam_prop = samplers.gamma(generator, lambda_alpha / 2.0, lambda_gamma / 2.0)
    else:
        lam_prop = lambda_alpha / lambda_gamma
    lam_new, rej1 = samplers.finite_or(lam_prop, lambda_cur)
    mu_mean = (sum_theta + beta_0 * mu_0) / (num_attr_per_group + beta_0)
    mu_sigma_sqr = 1.0 / ((num_attr_per_group + beta_0) * lam_new)
    if do_sample:
        mu_prop = samplers.gaussian(generator, mu_mean, torch.sqrt(mu_sigma_sqr))
    else:
        mu_prop = mu_mean
    mu_new, rej2 = samplers.finite_or(mu_prop, mu_cur)
    return lam_new, mu_new, rej1 + rej2


def dispatch_chunks(start, num_iter, refresh_every, ckpt_every=0):
    """Split iterations [start, num_iter) into chunks whose LAST iteration
    is a refresh point: refresh iff R == 1, it == start, it % R == R-1 or
    it == num_iter-1; a checkpoint boundary ((it + 1) % ckpt_every == 0)
    closes a chunk too, so that a save sees the state right after a
    refresh. The JAX engine runs one jit dispatch per chunk; the port runs
    the chunk's iterations one by one and refreshes at each chunk's last,
    so both take the same refresh cadence and the same trajectory (the
    first iteration after a restart refreshes, as in JAX)."""
    R = max(1, int(refresh_every))
    chunks = []
    i0 = start
    for it in range(start, num_iter):
        if (R == 1 or it == start or it % R == R - 1 or it == num_iter - 1
                or (ckpt_every and (it + 1) % ckpt_every == 0)):
            chunks.append((i0, it - i0 + 1))
            i0 = it + 1
    return chunks


def _masked_rmse_mae(pred_sum, y, mask, min_t, max_t, normalizer):
    """Clamped (RMSE, MAE) of pred_sum * normalizer over the masked cases."""
    return rmse_mae(pred_sum * normalizer, y, min_t, max_t, mask)


def _masked_acc_ll(pred_sum, y, mask, normalizer):
    """(accuracy, negative mean log10-likelihood) of the probabilities
    p = pred_sum * normalizer over the masked cases: p >= 0.5 predicts
    y > 0, p < 0.5 predicts y < 0; p clipped to [0.01, 0.99] in the
    likelihood (libFM fm_learn_mcmc_simultaneous.h:291-309)."""
    p = pred_sum * normalizer
    correct = (((p >= 0.5) & (y > 0.0)) | ((p < 0.5) & (y < 0.0))).to(p.dtype)
    n = mask.sum().clamp_min(1.0)
    acc = (correct * mask).sum() / n
    m01 = (y + 1.0) * 0.5
    pc = p.clamp(0.01, 0.99)
    ll = m01 * torch.log10(pc) + (1.0 - m01) * torch.log10(1.0 - pc)
    return acc, -(ll * mask).sum() / n


def _masked_auc(p, y, mask):
    """ROC AUC by the Mann-Whitney rank sum over the masked cases (a
    metric beyond libFM's, as in the JAX package). Ties take the ranks of
    a stable sort, not their midpoint."""
    n = p.shape[0]
    order = torch.argsort(torch.where(mask > 0, p, torch.full_like(p, float("inf"))),
                          stable=True)
    ranks = torch.empty_like(p)
    ranks[order] = torch.arange(1, n + 1, dtype=p.dtype, device=p.device)
    pos = (y > 0.0) & (mask > 0)
    neg = (y <= 0.0) & (mask > 0)
    npos = pos.sum().to(p.dtype)
    nneg = neg.sum().to(p.dtype)
    rsum = torch.where(pos, ranks, torch.zeros_like(ranks)).sum()
    return (rsum - npos * (npos + 1.0) / 2.0) / torch.clamp_min(npos * nneg, 1.0)


# --------------------------------------------------------------------------
# The steps the vector engines share (flat: learners/mcmc_vector.py; BS:
# learners/mcmc_rel_vector.py). `lrn` is the MCMCLearner whose settings
# and generator a step uses.
# --------------------------------------------------------------------------


def attr_groups(attr_group_np, n, device):
    """(attr_group_np [n], groups): the features' groups on the host and
    on `device` (`GroupSums`: each feature's group `ids`, the groups'
    `count` and their sums in a fixed order); one group when
    `attr_group_np` is None."""
    if attr_group_np is None:
        attr_group_np = np.zeros(n, dtype=np.int32)
    return attr_group_np, GroupSums(attr_group_np, int(attr_group_np.max()) + 1, device)


def initial_state(lrn, init_params, n, k, G, nc_test):
    """(P = [w | V] [n, k+1], the sampler state st): the parameters
    `init_params` = (w0, w, V) when given, else drawn; the warm start's w0
    and V; w = 0 without the linear term; alpha 1, mu 0 and the lambdas of
    the regularization; zeroed test-prediction sums."""
    dev, f32, cfg = lrn.device, torch.float32, lrn.cfg
    if init_params is not None:
        w0, w, V = (
            (x if torch.is_tensor(x) else torch.tensor(np.asarray(x)))
            .to(device=dev, dtype=f32).reshape(shape)
            for x, shape in zip(init_params, ((), (n,), (n, k)))
        )
    else:
        init = init_fm(cfg, lrn.generator, mcmc_style_w=True)
        w0, w, V = init.w0, init.w, init.v
    if lrn.warm_start is not None:
        V = torch.as_tensor(lrn.warm_start.v, dtype=f32, device=dev)
        w0 = torch.as_tensor(lrn.warm_start.w0, dtype=f32, device=dev).reshape(())
    if not cfg.use_linear:
        w = torch.zeros(n, dtype=f32, device=dev)
    P = torch.cat([w[:, None], V], dim=1).contiguous()  # [n, d]
    w_lambda = (
        torch.as_tensor(lrn._w_lambda_vec, dtype=f32, device=dev)
        if lrn._w_lambda_vec is not None
        else torch.full((G,), float(lrn._init_w_lambda), dtype=f32, device=dev)
    )
    v_lambda = (
        torch.as_tensor(lrn._v_lambda_vec, dtype=f32, device=dev)
        if lrn._v_lambda_vec is not None
        else torch.full((G, k), float(lrn._init_v_lambda), dtype=f32, device=dev)
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
    return P, st


def draw_w0(lrn, sum_e, num_cases, w0, alpha, bound):
    """w0's draw (its mean under ALS) given sum_e, the sum of the train
    residuals e = pred - y (libFM fm_learn_mcmc.h:447-465). Returns
    (w0_new, rejected)."""
    acc = sum_e - num_cases * w0
    sigma_sqr = 1.0 / (lrn.reg0 + alpha * num_cases)
    mean = -sigma_sqr * (alpha * acc - lrn.w0_mean_0 * lrn.reg0)
    prop = (samplers.gaussian(lrn.generator, mean, torch.sqrt(sigma_sqr))
            if lrn.do_sample else mean)
    return samplers.finite_or(prop, w0, bound=bound)


def draw_sweep_hyperpriors(lrn, P, group_sums, st):
    """(w_mu, w_lambda, v_mu, v_lambda) for the sweep: drawn per group
    (`group_sums`, a GroupSums) from P = [w | V] with do_multilevel, else the
    state's lambdas at mean mu_0. Returns (that tuple, rejected)."""
    w_mu, w_lambda = st["w_mu"], st["w_lambda"]
    v_mu, v_lambda = st["v_mu"], st["v_lambda"]
    rej = torch.zeros((), dtype=torch.int64, device=P.device)
    if not lrn.do_multilevel:
        return (torch.full_like(w_mu, lrn.mu_0), w_lambda,
                torch.full_like(v_mu, lrn.mu_0), v_lambda), rej
    hp = (lrn.alpha_0, lrn.gamma_0, lrn.beta_0, lrn.mu_0, lrn.do_sample)
    if lrn.cfg.use_linear:
        w_lambda, w_mu, r = draw_theta_hyperpriors(
            lrn.generator, P[:, 0], group_sums, w_mu, w_lambda, *hp,
        )
        rej += r
    if P.shape[1] > 1:  # no factor to draw for at k = 0 (JAX: `if k > 0`)
        v_lambda, v_mu, r = draw_theta_hyperpriors(
            lrn.generator, P[:, 1:], group_sums, v_mu, v_lambda, *hp,
        )
        rej += r
    return (w_mu, w_lambda, v_mu, v_lambda), rej


def draw_unobserved(lrn, P, unobserved, attr_group, hyper, bound):
    """Draw the features in no block from their prior (libFM
    fm_learn_mcmc.h:467-476), in P; `hyper` is the sweep's (w_mu,
    w_lambda, v_mu, v_lambda). Returns the rejected count."""
    w_mu, w_lambda, v_mu, v_lambda = hyper
    n_unobs = int(unobserved.shape[0])
    if not n_unobs:
        return 0
    gen = lrn.generator
    g_u = attr_group[unobserved]
    k = P.shape[1] - 1
    if lrn.do_sample:
        w_u = samplers.gaussian(gen, w_mu[g_u], torch.sqrt(1.0 / w_lambda[g_u]))
    else:
        w_u = w_mu[g_u]
    w_u, rej = samplers.finite_or(w_u, P[unobserved, 0], bound=bound)
    if lrn.cfg.use_linear:
        P[unobserved, 0] = w_u
    if k:
        if lrn.do_sample:
            v_u = samplers.gaussian(gen, v_mu[g_u], torch.sqrt(1.0 / v_lambda[g_u]))
        else:
            v_u = v_mu[g_u] + torch.zeros(n_unobs, k, dtype=P.dtype, device=P.device)
        v_u, r2 = samplers.finite_or(v_u, P[unobserved, 1:], bound=bound)
        P[unobserved, 1:] = v_u
        rej = rej + r2
    return rej


def step_metrics(lrn, st, it, pred_test, train_metric, rej, y_test, eval_mask):
    """Fold iteration `it`'s test prediction into the state's sums and
    return the logged metrics (host floats, one device-to-host copy)."""
    classify = lrn.task == TASK_CLASSIFICATION
    min_t, max_t = float(lrn.min_target), float(lrn.max_target)
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
    m_but5 = metric(st["pred_sum_all_but5"], y_test, eval_mask, normalizer=1.0 / n_but5)
    extra = [_masked_auc(st["pred_sum_all"], y_test, eval_mask)] if classify else []
    vals = torch.stack([
        torch.as_tensor(train_metric, dtype=torch.float32, device=pred_test.device),
        *m_this, *m_all, *m_but5, st["alpha"], torch.as_tensor(rej).to(torch.float32),
        *extra,
    ])
    if lrn.rlog is None:
        vals = vals.tolist()  # one device-to-host copy per iteration
    else:
        # the hyperpriors ride in the same copy, only for the rlog's columns
        vals = torch.cat([vals, *(st[key].reshape(-1) for key in HYPER)]).tolist()
    out = dict(
        train=vals[0], this=vals[1:3], all=vals[3:5], but5=vals[5:7],
        alpha=vals[7], rejected=int(vals[8]),
    )
    if classify:
        out["auc"] = vals[9]
    if lrn.rlog is not None:
        at = 9 + len(extra)
        G, k = st["v_mu"].shape
        out["w_mu"], out["w_lambda"] = vals[at:at + G], vals[at + G:at + 2 * G]
        at += 2 * G
        out["v_mu"] = np.reshape(vals[at:at + G * k], (G, k))
        out["v_lambda"] = np.reshape(vals[at + G * k:at + 2 * G * k], (G, k))
    return out



# --------------------------------------------------------------------------
# The exact engines' blocks and draws (flat below, BS in
# learners/mcmc_relational.py)
# --------------------------------------------------------------------------

#: the CUDA kernels take k <= 128; the flat engines' kernels also k = 0
MAX_FACTORS_CUDA = 128


class CoordBlock:
    """One conflict-free block on the device, as `coord_draw` and
    `rel_coord_draw` read it: its features (global ids: `features` long,
    `feat_id` int32), their groups (`group_id` int32), the per-feature slot
    lists `feat_off` int64 [F+1], `slot_row` int32 (train cases, or block
    rows) and `slot_val` float32, the kernel's launch plan (`plan`, a
    DrawPlan) and `rejected`, the block's slice of the engine's rejection
    counters (`attach_counters`)."""

    def __init__(self, features, groups, feat_off, slot_row, slot_val, device):
        def t(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        self.F = len(features)
        self.num_entries = int(feat_off[-1])
        self.features = t(features, torch.long)
        self.feat_id = t(features, torch.int32)
        self.group_id = t(groups, torch.int32)
        self.feat_off = t(feat_off, torch.int64)
        self.slot_row = t(slot_row, torch.int32)
        self.slot_val = t(slot_val, torch.float32)
        self.plan = DrawPlan(np.asarray(feat_off), device)
        self.rejected = None

    @classmethod
    def from_feature_block(cls, block, attr_group_np, device):
        off, rows, vals = feature_slots(block)
        return cls(block.features, attr_group_np[block.features], off, rows, vals, device)


def attach_counters(blocks, device):
    """One zeroed int32 rejection counter a feature of `blocks`; each
    block's `rejected` is its slice. Returns the whole buffer, which the
    engine sums and zeroes once an iteration."""
    buf = torch.zeros(sum(b.F for b in blocks), dtype=torch.int32, device=device)
    o = 0
    for b in blocks:
        b.rejected = buf[o:o + b.F]
        o += b.F
    return buf


def draw_caches(nc, device):
    """The exact engines' working copy of e and one factor's q, [nc, 2]:
    the draws of an iteration read and write e and q here rather than in
    A = [e | Q], where they lie a row (k+1 floats) apart, so that a slot's
    two values share one 32-byte sector of the card's memory. Each factor
    copies its q in from A (written by the last re-prediction); e goes
    back to A when the draws end."""
    return torch.empty(nc, 2, dtype=torch.float32, device=device)


def draw_block(lrn, kernel, blk, theta, lam, mu, alpha, bound, **caches):
    """One block's draws with `kernel` (`coord_draw` or `rel_coord_draw`)
    on the parameter column `theta`, the normals drawn from the learner's
    generator first (none under ALS)."""
    z = (torch.randn(blk.F, generator=lrn.generator, device=theta.device)
         if lrn.do_sample else None)
    kernel(theta, blk.feat_off, blk.slot_row, blk.slot_val, blk.feat_id, blk.group_id, lam,
           mu, alpha, z, blk.rejected, bound=bound, plan=blk.plan, **caches)


def row_width(ds) -> int:
    """The longest row of `ds` (at least 1); of a relational dataset, of
    its materialised join, counted without building it."""
    lens = np.diff(ds.indptr).astype(np.int64)
    for join in getattr(ds, "relations", None) or ():
        lens = lens + np.diff(join.data.indptr).astype(np.int64)[join.row_map]
    return max(1, int(lens.max()) if len(lens) else 1)


def padded_rows(ds, device):
    """`fm_refresh`'s (ids, vals) [nc, L] for the cases of `ds`, L its
    longest row (at least 1). A StreamingDataset fills the same tensors
    chunk by chunk from its windows, so that the host holds one chunk."""
    if not is_stream(ds):
        ids, vals = padded_rows_layout(ds.indptr, ds.cols, ds.vals)
        return torch.as_tensor(ids, device=device), torch.as_tensor(vals, device=device)
    L = max(1, ds.max_row_nnz())
    ids = torch.empty(ds.num_rows, L, dtype=torch.int32, device=device)
    vals = torch.empty(ds.num_rows, L, dtype=torch.float32, device=device)
    for a, ci, cv in ds.padded_rows(L):
        ids[a:a + len(ci)].copy_(torch.from_numpy(ci))
        vals[a:a + len(cv)].copy_(torch.from_numpy(cv))
    return ids, vals


def train_blocks(train, attr_group_np, build):
    """`build(block)` for each conflict-free block of the train cases, in
    `conflict_free_blocks`' order; returns (the built blocks, the
    observed-feature mask). A StreamingDataset's blocks come from its
    transpose (`streaming.stream_blocks`): each is built, so uploaded,
    before the next is read, and the built ones are put in order after."""
    observed = np.zeros(len(attr_group_np), dtype=bool)
    src = (stream_blocks(train, attr_group_np) if is_stream(train)
           else enumerate(conflict_free_blocks(train, attr_group=attr_group_np)))
    built = []
    for key, b in src:
        observed[b.features] = True
        built.append((key, build(b)))
        del b
    built.sort(key=lambda kb: kb[0])
    return [blk for _, blk in built], observed


def exact_layout(train, attr_group_np, max_blocks: int, device):
    """The flat exact engine's blocks (`conflict_free_blocks` over the
    train cases, in the JAX engine's order) and the features in no block
    (int64). Above `max_blocks` blocks the JAX engine draws the largest
    max_blocks one by one and the rest under one lax.scan (a bound on
    XLA's program size), all in the order of a stable sort by entry count,
    descending; the port draws every block in one loop, in that order."""
    blocks, observed = train_blocks(
        train, attr_group_np,
        lambda b: CoordBlock.from_feature_block(b, attr_group_np, device))
    if len(blocks) > max_blocks:
        order = np.argsort([-b.num_entries for b in blocks], kind="stable")
        blocks = [blocks[i] for i in order]
    return blocks, np.nonzero(~observed)[0].astype(np.int64)


def learn_exact(lrn, train, test):
    """The flat exact engine (JAX mcmc.py `learn`, `draw_all`, `iteration`)
    for `lrn`, regression or probit classification; returns the history.

    State on the device: P = [w | V] [n, k+1] and A = [e | Q] [num_train,
    k+1] (e = pred - y, or pred - latent under probit); the draws work on
    a copy of e and of one factor's q side by side (`draw_caches`). One
    iteration: alpha, w0 (e moves with it), the hyperpriors, one
    `coord_draw` w call a block (one launch, two on a block with a long
    feature), the unobserved features, then for each factor f one
    `coord_draw` v call a block on (e, q = A[:, 1+f]); then the
    re-prediction: `fm_refresh`'s test mode, and its train mode (A
    rewritten, the clipped squared error) or probit mode (the latents
    drawn, or their expectations under ALS, and the correct count)."""
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
    blocks, unobserved = exact_layout(train, attr_group_np, lrn.max_blocks, dev)
    unobserved = torch.as_tensor(unobserved, device=dev)
    rejected = attach_counters(blocks, dev)
    tr_ids, tr_vals = padded_rows(train, dev)
    te_ids, te_vals = padded_rows(test, dev)
    y_train = torch.as_tensor(train.target, dtype=f32, device=dev)
    y_test = torch.as_tensor(test.target, dtype=f32, device=dev)
    nec = lrn.num_eval_cases if lrn.num_eval_cases is not None else nc_test
    eval_mask = (torch.arange(nc_test, device=dev) < nec).to(f32)

    P, st = initial_state(lrn, lrn.init_params, n, k, group_sums.num_groups, nc_test)
    A = torch.empty(nc_train, k + 1, dtype=f32, device=dev)
    EQ = draw_caches(nc_train, dev)
    fwd = dict(use_linear=use_linear, use_bias=cfg.use_bias)
    clip = dict(min_target=min_t, max_target=max_t)
    # the initial prediction takes e = pred - y for both tasks (libFM
    # fm_learn_mcmc_simultaneous.h:70-86): the latents start at y
    fm_refresh(P, tr_ids, tr_vals, st["w0"], y_train, A, **clip, **fwd)
    latent = y_train.clone() if classify else None
    probit = None if not classify else "sample" if lrn.do_sample else "mean"

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
        # V's hyperpriors and the unobserved features' V are drawn here
        # with w's; the JAX engine draws them after the w sweep (the
        # hyperpriors) and after each factor's blocks (the unobserved).
        # Neither reads what the w sweep changes and the unobserved
        # features touch no case, so the distribution and the ALS
        # trajectory are the same
        hyper, r = draw_sweep_hyperpriors(lrn, P, group_sums, st)
        rej = rej + r
        w_mu, w_lambda, v_mu, v_lambda = hyper
        if use_linear:
            for blk in blocks:
                draw_block(lrn, coord_draw, blk, P[:, 0], w_lambda, w_mu, alpha, bound, e=e)
        rej = rej + draw_unobserved(lrn, P, unobserved, attr_group, hyper, bound)
        for f in range(k):
            # factor f's q is A's column 1+f: the last re-prediction wrote
            # it from V[:, f], which nothing has changed since, and each
            # block's draws keep it current. It is the JAX engine's rebuilt
            # q (add_main_q) up to the order of f32 sums
            q.copy_(A[:, 1 + f])
            for blk in blocks:
                draw_block(lrn, coord_draw, blk, P[:, 1 + f], v_lambda[:, f], v_mu[:, f],
                           alpha, bound, e=e, q=q)
        # the re-prediction rewrites A; q's last values are not read again
        A[:, 0] = e
        st.update(w0=w0, alpha=alpha, **dict(zip(HYPER, hyper)))
        return rej

    def one_step(it):
        rej = draw_all()
        w0 = st["w0"]
        pred_test = fm_refresh(P, te_ids, te_vals, w0, **fwd)
        U = torch.rand(nc_train, generator=gen, device=dev) if probit == "sample" else None
        m = fm_refresh(P, tr_ids, tr_vals, w0, y_train, A, probit=probit, U=U,
                       latent=latent, **clip, **fwd)
        train_metric = m / max(nc_train, 1) if classify else torch.sqrt(m / max(nc_train, 1))
        rej = rej + rejected.sum()
        rejected.zero_()
        return step_metrics(lrn, st, it, pred_test, train_metric, rej, y_test, eval_mask)

    def bufs():
        return dict(P=P, A=A, rejected=rejected, **({"latent": latent} if classify else {}))

    return run_iterations(lrn, "exact", one_step, P, st, bufs)


def run_iterations(lrn, engine, one_step, P, st, bufs, refresh_every=None):
    """Every engine's loop, from iteration 0 or from the iteration a
    checkpoint holds: `one_step(it)` at every iteration (the exact
    engines, which re-predict at each), or with `refresh_every`
    `one_step(it, refresh)`, refresh at the last iteration of each of
    `dispatch_chunks`' chunks (the vector engines). Each iteration is
    timed and logged; with `checkpoint_every` the state is saved after
    every iteration it divides. `bufs()` returns the engine's tensors the
    next iteration reads besides the sampler state `st` ({name: tensor},
    restored in place); `engine` tags the checkpoint. The final state is
    kept for predict(), predict_new() and get_params()."""
    lrn.history = []
    start = lrn._maybe_restore(engine, st, bufs())
    every = lrn.checkpoint_every if lrn.checkpoint_path else 0
    for i0, L in dispatch_chunks(start, lrn.num_iter, refresh_every or 1, every):
        for it in range(i0, i0 + L):
            c0 = iter_clocks(lrn.device)
            # a named range for torch.profiler traces (chip_smoke.py --profile)
            with torch.profiler.record_function(f"iteration {it}"):
                metrics = (one_step(it) if refresh_every is None
                           else one_step(it, it == i0 + L - 1))
            c1 = iter_clocks(lrn.device)
            lrn._log_iteration(it, metrics, tuple(b - a for a, b in zip(c0, c1)))
        if every and (i0 + L) % every == 0:
            lrn._save_checkpoint(engine, st, bufs(), i0 + L)
    lrn._final_state = dict(st, w=P[:, 0].clone(), V=P[:, 1:].clone())
    return lrn.history


# --------------------------------------------------------------------------
# The learner
# --------------------------------------------------------------------------


class MCMCLearner:
    """MCMC Gibbs / ALS learner configuration.

    do_sample=True, do_multilevel=True  -> MCMC (libFM's default)
    do_sample=False, do_multilevel=False -> ALS
    Runs on `device` (default CUDA; raises when CUDA is absent) with one
    `torch.Generator` on that device, seeded from `seed`.
    `init_params=(w0, w, V)` (numpy arrays or tensors) starts the chain
    from the given parameters instead of the learner's own N(init_mean,
    init_stdev) draw (see convert.params_from_jax).
    """

    def __init__(
        self,
        cfg: FMConfig,
        task: int = TASK_REGRESSION,
        num_iter: int = 100,
        do_sample: bool = True,
        do_multilevel: bool = True,
        num_eval_cases: int | None = None,
        seed: int = 1,
        rlog=None,
        verbose: bool = True,
        attr_group: np.ndarray | None = None,
        max_blocks: int = 128,
        dtype=None,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 0,
        device=None,
        init_params=None,
    ):
        self.cfg = cfg
        self.task = task
        self.num_iter = num_iter
        self.do_sample = do_sample
        self.do_multilevel = do_multilevel
        self.num_eval_cases = num_eval_cases
        self.seed = seed
        self.rlog = rlog
        self.verbose = verbose
        self.max_blocks = max_blocks
        self.dtype = dtype or cfg.dtype
        if self.dtype != torch.float32:
            raise NotImplementedError("the port runs in float32 only")
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # hyperprior constants (libFM fm_learn_mcmc.h:1107-1114)
        self.alpha_0 = 1.0
        self.gamma_0 = 1.0
        self.beta_0 = 1.0
        self.mu_0 = 0.0
        self.w0_mean_0 = 0.0
        self.min_target = 0.0
        self.max_target = 0.0
        if attr_group is not None:
            attr_group = np.asarray(attr_group, dtype=np.int32)
        self.attr_group_np = attr_group
        # per-group regularization seeds (libfm.cpp:326-365)
        self._init_w_lambda = cfg.regw
        self._init_v_lambda = cfg.regv
        self.reg0 = cfg.reg0
        self._w_lambda_vec = None
        self._v_lambda_vec = None
        self.history: list = []
        # -load_model warm start: only the loaded w0 and V take effect
        # for the MCMC family (libfm.cpp:262-268, :283)
        self.warm_start = None  # FMParams | None
        self.init_params = init_params
        # full-state checkpoints (utils/checkpoint.py): saved after every
        # `checkpoint_every` iterations (0: never), resumed from when the
        # file exists and matches this run
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every

    def set_regularization(self, reg: list[float], num_groups: int):
        """libFM's reg-arity rules: 0 / 1 / 3 / (1 + 2*num_groups) values
        (src/libfm/libfm.cpp:326-365)."""
        k = self.cfg.num_factors
        self._w_lambda_vec = None
        self._v_lambda_vec = None
        if len(reg) == 0:
            self._init_w_lambda, self._init_v_lambda = 0.0, 0.0
            self.reg0 = 0.0
        elif len(reg) == 1:
            self._init_w_lambda, self._init_v_lambda = reg[0], reg[0]
            self.reg0 = reg[0]
        elif len(reg) == 3:
            self._init_w_lambda, self._init_v_lambda = reg[1], reg[2]
            self.reg0 = reg[0]
        elif len(reg) == 1 + 2 * num_groups:
            self.reg0 = reg[0]
            self._w_lambda_vec = np.asarray(reg[1 : 1 + num_groups])
            self._v_lambda_vec = np.repeat(
                np.asarray(reg[1 + num_groups :])[:, None], k, axis=1
            )
        else:
            raise ValueError(
                f"-regular expects 0, 1, 3 or {1 + 2 * num_groups} values"
            )

    def _check_supported(self, train, test):
        _base.check_num_features(self.cfg, train, test)
        k = self.cfg.num_factors
        if is_stream(train) and getattr(train, "relations", None):
            raise ValueError("relational (BS) data needs its main table resident: "
                             "pass a Dataset, not a StreamingDataset")
        why = None
        if k < 1 and getattr(train, "relations", None):
            why = f"the pure linear model (k=0) on relational (BS) data {RANGE_OF_K}"
        elif self.device.type == "cuda" and k > MAX_FACTORS_CUDA:
            why = f"k > {MAX_FACTORS_CUDA} on the CUDA kernels {RANGE_OF_K}"
        if why:
            raise NotImplementedError(why)

    def learn(self, train, test):
        """The exact engine (`-engine exact`): the flat one, or for
        relational (BS) data the exact BS engine
        (learners/mcmc_relational.py). Returns the history."""
        self._check_supported(train, test)
        if getattr(train, "relations", None):
            from libfm_tpu_torch.learners.mcmc_relational import learn_relational

            return learn_relational(self, train, test)
        return learn_exact(self, train, test)

    # ----------------------------------------------------------- reporting
    def _log_iteration(self, it, metrics, dt):
        """`metrics` holds host floats: train, this/all/but5 as (rmse,
        mae) pairs (classification: (accuracy, log10-loss)), alpha,
        rejected and, for classification, auc. `dt` is the (user, cpu,
        wall) triple of timers.iter_clocks() differences or a
        wall-seconds float."""
        t_wall = dt[2] if isinstance(dt, tuple) else dt
        tr = float(metrics["train"])
        te = float(metrics["all"][0])
        if self.verbose:
            if self.task == TASK_REGRESSION:
                print(f"#Iter={it:3d}\tTrain={tr:.6g}\tTest={te:.6g}")
            else:
                ll = float(metrics["all"][1])
                print(f"#Iter={it:3d}\tTrain={tr:.6g}\tTest={te:.6g}\tTest(ll)={ll:.6g}")
        self.history.append(
            dict(
                iter=it,
                train=tr,
                test_this=float(metrics["this"][0]),
                test_all=te,
                test_all_but5=float(metrics["but5"][0]),
                test_this_m2=float(metrics["this"][1]),
                test_all_m2=float(metrics["all"][1]),
                test_all_but5_m2=float(metrics["but5"][1]),
                alpha=float(metrics["alpha"]),
                rejected=int(metrics["rejected"]),
                time=t_wall,
                **({"auc_all": float(metrics["auc"])} if "auc" in metrics else {}),
            )
        )
        if self.rlog is not None:
            self._log_rlog_row(metrics, dt)

    def _log_rlog_row(self, metrics, dt):
        """One rlog row (JAX mcmc.py:1280-1312): the (user, cpu, wall)
        times of the iteration (time_pred stays NaN, as in libFM's MCMC,
        fm_learn_mcmc_simultaneous.h:202-208), alpha, the hyperpriors
        (`step_metrics` adds them when there is an rlog) and the test
        metrics."""
        m, log = metrics, self.rlog.log
        t_user, t_cpu, t_wall = dt if isinstance(dt, tuple) else (dt, dt, dt)
        log("time_learn", t_user)
        log("time_learn2", t_cpu)
        log("time_learn4", t_wall)
        log("alpha", float(m["alpha"]))
        for g, (mu, lam) in enumerate(zip(m["w_mu"], m["w_lambda"])):
            log(f"wmu[{g}]", mu)
            log(f"wlambda[{g}]", lam)
        v_mu, v_lam = m["v_mu"], m["v_lambda"]
        for g in range(v_mu.shape[0]):
            for fc in range(v_mu.shape[1]):
                log(f"vmu[{g},{fc}]", float(v_mu[g, fc]))
                log(f"vlambda[{g},{fc}]", float(v_lam[g, fc]))
        if self.task == TASK_REGRESSION:
            log("rmse", float(m["all"][0]))
            log("mae", float(m["all"][1]))
            log("rmse_mcmc_this", float(m["this"][0]))
            log("rmse_mcmc_all", float(m["all"][0]))
            log("rmse_mcmc_all_but5", float(m["but5"][0]))
        else:
            log("accuracy", float(m["all"][0]))
            log("acc_mcmc_this", float(m["this"][0]))
            log("acc_mcmc_all", float(m["all"][0]))
            log("acc_mcmc_all_but5", float(m["but5"][0]))
            log("ll_mcmc_this", float(m["this"][1]))
            log("ll_mcmc_all", float(m["all"][1]))
            log("ll_mcmc_all_but5", float(m["but5"][1]))
            if "auc" in m:
                log("auc_mcmc_all", float(m["auc"]))
        self.rlog.new_line()

    def register_log_fields(self):
        """Declare the rlog's columns (libFM fm_learn_mcmc.h:1127-1157, and
        the per-group hyperpriors of :444-449, 521-526; auc_mcmc_all is
        the JAX package's addition)."""
        if self.rlog is None:
            return
        nan = float("nan")
        add = self.rlog.add_field
        if self.task == TASK_REGRESSION:
            for fname in ("rmse", "mae"):
                add(fname, nan)
        else:
            add("accuracy", nan)
        for fname in ("time_pred", "time_learn", "time_learn2", "time_learn4"):
            add(fname, nan)
        add("alpha", nan)
        if self.task == TASK_REGRESSION:
            for fname in ("rmse_mcmc_this", "rmse_mcmc_all", "rmse_mcmc_all_but5"):
                add(fname, nan)
        else:
            for fname in ("acc_mcmc_this", "acc_mcmc_all", "acc_mcmc_all_but5",
                          "ll_mcmc_this", "ll_mcmc_all", "ll_mcmc_all_but5",
                          "auc_mcmc_all"):
                add(fname, nan)
        G = self._num_groups_for_log()
        for g in range(G):
            add(f"wmu[{g}]", nan)
            add(f"wlambda[{g}]", nan)
        for g in range(G):
            for fc in range(self.cfg.num_factors):
                add(f"vmu[{g},{fc}]", nan)
                add(f"vlambda[{g},{fc}]", nan)

    def _num_groups_for_log(self) -> int:
        if self.attr_group_np is None:
            return 1
        return int(self.attr_group_np.max()) + 1

    # ------------------------------------------------------- checkpoints
    def _ckpt_meta(self, it: int, engine: str) -> dict:
        return dict(
            iter=it, engine=engine, seed=self.seed, num_features=self.cfg.num_features,
            num_factors=self.cfg.num_factors, task=self.task, do_sample=self.do_sample,
            do_multilevel=self.do_multilevel,
        )

    def _ckpt_state(self, st, bufs) -> dict:
        """The tensors a checkpoint holds, by name: the sampler state
        `st`, the engine's buffers and the generator's state."""
        return {**{f"st.{key}": v for key, v in st.items()}, **bufs,
                "generator": self.generator.get_state()}

    def _save_checkpoint(self, engine: str, st, bufs, it: int) -> None:
        from libfm_tpu_torch.utils import checkpoint as ckpt

        ckpt.save_state(self.checkpoint_path, self._ckpt_state(st, bufs),
                        self._ckpt_meta(it, engine))

    def _maybe_restore(self, engine: str, st, bufs) -> int:
        """Resume from `checkpoint_path` when it exists and matches this
        run; returns the iteration to start at (0: a fresh start). The
        whole sampler state comes back (the parameters, hyperparameters,
        caches, prediction sums, probit latents and the generator), the
        capability libFM disables -save_model for under MCMC
        (libfm.cpp:123-133): `st`'s entries are replaced, the buffers
        `bufs` copied into in place. A file of another engine, meta or
        layout warns and starts fresh."""
        import os

        from libfm_tpu_torch.utils import checkpoint as ckpt

        path = self.checkpoint_path
        if not path or not os.path.exists(path):
            return 0
        saved, meta = ckpt.restore_state(path)
        expect = self._ckpt_meta(0, engine)
        if meta.get("engine") != engine:
            print(f"WARNING: checkpoint {path} was written by the {meta.get('engine')} "
                  f"engine, not the {engine} engine; starting fresh.")
            return 0
        if any(meta.get(key) != v for key, v in expect.items() if key != "iter"):
            print(f"WARNING: checkpoint {path} does not match this run's config; "
                  "starting fresh.")
            return 0
        like = self._ckpt_state(st, bufs)
        if set(saved) != set(like) or any(
                saved[key].shape != tuple(v.shape) or str(saved[key].dtype)
                != str(v.dtype).removeprefix("torch.") for key, v in like.items()):
            print(f"WARNING: checkpoint {path} has a different state structure; "
                  "starting fresh.")
            return 0
        for key, arr in saved.items():
            t = torch.from_numpy(arr)
            if key == "generator":
                self.generator.set_state(t)
            elif key.startswith("st."):
                st[key[3:]] = t.to(self.device)
            else:
                bufs[key].copy_(t)
        it = int(meta["iter"])
        if self.verbose:
            print(f"Resuming from {path} at iteration {it}")
        return it

    # ---------------------------------------------------------- inference
    def predict(self, test=None) -> np.ndarray:
        """Posterior-mean predictions for the test set passed to learn(),
        clamped to the target range (regression) or to [0, 1]
        (classification: the mean of Phi(pred), or Phi(pred) under ALS)
        (libFM fm_learn_mcmc.h:380-404)."""
        st = self._final_state
        if self.do_sample:
            out = st["pred_sum_all"].cpu().numpy() / self.num_iter
        else:
            out = st["pred_this"].cpu().numpy()
        if self.task == TASK_REGRESSION:
            return np.clip(out, self.min_target, self.max_target)
        return np.clip(out, 0.0, 1.0)

    def get_params(self) -> FMParams:
        st = self._final_state
        return FMParams(w0=st["w0"], w=st["w"], v=st["V"])

    #: entries of a relational dataset's materialised join above which
    #: predict_new expands and scores it in case-range chunks (~8 bytes an
    #: entry on the host: ~400 MB at the cap)
    predict_expand_cap = 50_000_000

    def predict_new(self, ds, batch_size: int = 8192) -> np.ndarray:
        """Predictions for data NOT passed to learn(), from the final
        parameters as a point estimate (JAX mcmc.py `predict_new`; libFM's
        MCMC cannot predict a case after the run, fm_learn_mcmc.h:141-143):
        `fm_refresh`'s test mode over the padded rows, `batch_size` cases a
        launch, clamped to the learn-time target range (regression) or
        linked through the probit CDF and clipped to [0, 1]
        (classification). Relational data is scored on its materialised
        join (`expand_join`, the features numbered as the learners number
        them), in case-range chunks above `predict_expand_cap` entries,
        which give the same bits. Less accurate than `predict()`, the
        posterior mean over the run, on the learn-time test set."""
        if getattr(ds, "relations", None):
            from libfm_tpu_torch.data.relation import expand_join, expansion_cost

            exp_nnz, _ = expansion_cost(ds)
            if exp_nnz > self.predict_expand_cap:
                return self._predict_new_chunked(ds, exp_nnz, batch_size)
            ds = expand_join(ds)
        return self._finish(self._scores(ds, batch_size, row_width(ds)))

    def _scores(self, ds, batch_size: int, width: int) -> torch.Tensor:
        """Raw scores of the flat dataset `ds`, its rows padded to `width`
        (a chunk's rows pad to the whole dataset's width: each batch is
        then the unchunked path's, bit for bit)."""
        if ds.num_features > self.cfg.num_features:
            raise ValueError(f"dataset has feature ids up to {ds.num_features - 1} but "
                             f"the model covers {self.cfg.num_features} features")
        st = self._final_state
        P = torch.cat([st["w"][:, None], st["V"]], dim=1).contiguous()
        ids, vals = padded_rows_layout(ds.indptr, ds.cols, ds.vals)
        pad = ((0, 0), (0, width - ids.shape[1]))
        ids, vals = np.pad(ids, pad), np.pad(vals, pad)
        out = [fm_refresh(P, torch.as_tensor(ids[a:a + batch_size], device=self.device),
                          torch.as_tensor(vals[a:a + batch_size], device=self.device),
                          st["w0"], use_linear=self.cfg.use_linear,
                          use_bias=self.cfg.use_bias)
               for a in range(0, ds.num_rows, batch_size)]
        return torch.cat(out) if out else torch.zeros(0, device=self.device)

    def _finish(self, scores: torch.Tensor) -> np.ndarray:
        if self.task == TASK_REGRESSION:
            return np.clip(scores.cpu().numpy(), self.min_target, self.max_target)
        return np.clip(samplers.cdf_gaussian(scores).cpu().numpy(), 0.0, 1.0)

    def _predict_new_chunked(self, ds, exp_nnz: int, batch_size: int) -> np.ndarray:
        """predict_new for relational data whose join exceeds
        `predict_expand_cap` entries: case ranges of about half the cap
        each, a whole number of batches, expanded and scored one at a
        time. Each batch is the unchunked path's, so the scores are its
        bits (JAX `_predict_new_chunked`)."""
        from libfm_tpu_torch.data.dataset import Dataset
        from libfm_tpu_torch.data.relation import RelationJoin, expand_join

        nc = ds.num_rows
        per_case = max(1, exp_nnz // max(nc, 1))
        step = max(1, (self.predict_expand_cap // 2) // per_case) // batch_size * batch_size
        step = min(max(step, batch_size), max(nc, 1))
        width = row_width(ds)
        out = []
        for a in range(0, nc, step):
            b = min(nc, a + step)
            lo, hi = ds.indptr[a], ds.indptr[b]
            sub = Dataset(ds.indptr[a:b + 1] - lo, ds.cols[lo:hi], ds.vals[lo:hi],
                          ds.target[a:b], ds.num_features)
            sub.relations = [RelationJoin(r.data, r.row_map[a:b]) for r in ds.relations]
            out.append(self._scores(expand_join(sub), batch_size, width))
        return self._finish(torch.cat(out))


class ALSLearner(MCMCLearner):
    """ALS = MCMC with expectation updates and fixed hyperpriors."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("do_sample", False)
        kwargs.setdefault("do_multilevel", False)
        super().__init__(*args, **kwargs)

"""ALS / MCMC (Gibbs) learner: configuration surface and shared draws.

The port's counterpart of `libfm_tpu.learners.mcmc`. This slice carries
the learner's configuration surface (constructor, `set_regularization`,
per-iteration logging, `predict`, `get_params`), the hyperparameter
draws (`draw_alpha`, `draw_theta_hyperpriors`), the refresh cadence
(`dispatch_chunks`) and the masked test metrics: RMSE/MAE for
regression, accuracy/log10-likelihood and AUC for probit
classification. The vector engine
(`learners/mcmc_vector.py`) runs on top of it. The exact per-coordinate
engine (`-engine exact`) is not ported: `MCMCLearner.learn` raises
(ROADMAP M10).

ALS is MCMC with do_sample=False, do_multilevel=False — posterior means
instead of draws (libFM src/libfm/libfm.cpp:135-139).
"""

from __future__ import annotations

import numpy as np
import torch

from libfm_tpu_torch.device import resolve_device
from libfm_tpu_torch.learners.base import rmse_mae
from libfm_tpu_torch.models.fm import FMConfig, FMParams
from libfm_tpu_torch.ops import samplers
from libfm_tpu_torch.ops.segment import seg_sum
from libfm_tpu_torch.tasks import TASK_REGRESSION


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
    e2 = e * e
    e2 = torch.where(torch.isfinite(e2), e2.clamp_max(1e30), torch.full_like(e2, 1e30))
    gamma_n = (gamma_0 + e2.sum()).clamp_max(1e37)
    proposal = samplers.gamma(generator, alpha_n / 2.0, gamma_n / 2.0)
    ok = torch.isfinite(proposal) & (proposal > 0.0)
    return torch.where(ok, proposal, alpha), (~ok).sum()


def draw_theta_hyperpriors(generator, theta, attr_group, num_attr_per_group,
                           mu_cur, lambda_cur, alpha_0, gamma_0, beta_0, mu_0,
                           do_sample):
    """Draw (lambda, mu) per group for theta [n] (w; lambda, mu [G]) or
    theta [n, k] (V, each factor on its own; lambda, mu [G, k]): lambda
    first with the current mu, then mu with the new lambda (libFM
    fm_learn_mcmc.h:444-445; draw_w_lambda :980-1017, draw_w_mu
    :941-978). Returns (lambda, mu, rejected count)."""
    G = num_attr_per_group.shape[0]
    num_attr_per_group = num_attr_per_group.reshape((G,) + (1,) * (theta.dim() - 1))
    sum_theta = seg_sum(theta, attr_group, G)
    dev = theta - mu_cur[attr_group]
    lambda_gamma = (
        beta_0 * (mu_cur - mu_0) ** 2 + gamma_0 + seg_sum(dev * dev, attr_group, G)
    )
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


def dispatch_chunks(start, num_iter, refresh_every):
    """Split iterations [start, num_iter) into chunks whose LAST iteration
    is a refresh point: refresh iff R == 1, it == start, it % R == R-1 or
    it == num_iter-1. The JAX engine runs one jit dispatch per chunk (and
    also cuts at checkpoint boundaries, which wait for ROADMAP M7); the
    port runs the chunk's iterations one by one and refreshes at each
    chunk's last, so both take the same refresh cadence and the same
    trajectory."""
    R = max(1, int(refresh_every))
    chunks = []
    i0 = start
    for it in range(start, num_iter):
        if R == 1 or it == start or it % R == R - 1 or it == num_iter - 1:
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
# The learner
# --------------------------------------------------------------------------


class MCMCLearner:
    """MCMC Gibbs / ALS learner configuration.

    do_sample=True, do_multilevel=True  -> MCMC (libFM's default)
    do_sample=False, do_multilevel=False -> ALS
    Runs on `device` (default CUDA; raises when CUDA is absent) with one
    `torch.Generator` on that device, seeded from `seed`.
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
        dtype=None,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 0,
        device=None,
    ):
        if rlog is not None:
            raise NotImplementedError("rlog output waits for ROADMAP M7")
        if checkpoint_path is not None:
            raise NotImplementedError("checkpoint/resume waits for ROADMAP M7")
        self.cfg = cfg
        self.task = task
        self.num_iter = num_iter
        self.do_sample = do_sample
        self.do_multilevel = do_multilevel
        self.num_eval_cases = num_eval_cases
        self.seed = seed
        self.rlog = None
        self.verbose = verbose
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

    def learn(self, train, test):
        raise NotImplementedError(
            "the exact per-coordinate engine (-engine exact) waits for "
            "ROADMAP M10; use MCMCVectorLearner / ALSVectorLearner"
        )

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

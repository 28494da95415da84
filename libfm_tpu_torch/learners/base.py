"""Shared learner machinery: metrics, the feature-count check and the
prediction link.

Metric formulas reproduce libFM:
- regression RMSE/MAE with the prediction clamped to the observed target
  range (src/libfm/src/fm_learn.h:132-153);
- classification accuracy by sign agreement of the raw score
  (src/libfm/src/fm_learn.h:113-130);
- MCMC probability metrics: accuracy at p>=0.5 and negative mean
  log10-likelihood with p clipped to [0.01, 0.99]
  (src/libfm/src/fm_learn_mcmc_simultaneous.h:291-309).
"""

from __future__ import annotations

import torch

from libfm_tpu_torch.tasks import TASK_CLASSIFICATION, TASK_REGRESSION

#: where the learners' refusals of a k outside their kernels' range point:
#: k > 128 on every kernel, k = 0 on the BS, SGD and SGDA kernels
RANGE_OF_K = "waits for ROADMAP §1 item 2 (the kernels' range of k)"


def clamp(pred, min_target, max_target):
    return pred.clamp(min_target, max_target)


def rmse_mae(pred, target, min_target, max_target, mask=None):
    """Clamped RMSE and MAE (0-dim tensors) of the raw score `pred`, over
    the cases where the 0/1 `mask` is 1 (all cases when None)."""
    err = clamp(pred, min_target, max_target) - target
    if mask is None:
        return torch.sqrt((err * err).mean()), err.abs().mean()
    n = mask.sum().clamp_min(1.0)
    err = err * mask
    return torch.sqrt((err * err).sum() / n), err.abs().sum() / n


def _masked_mean(x, mask):
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def sign_accuracy(score, target, mask=None):
    """Fraction of cases where sign(score) matches sign(target); score>=0
    counts as positive (libFM fm_learn.h:117)."""
    correct = ((score >= 0) & (target >= 0)) | ((score < 0) & (target < 0))
    return _masked_mean(correct.to(score.dtype), mask)


def prob_accuracy(p, target, mask=None):
    """MCMC-style accuracy: p>=0.5 counts as a positive prediction
    (libFM fm_learn_mcmc_simultaneous.h:297)."""
    correct = ((p >= 0.5) & (target > 0.0)) | ((p < 0.5) & (target < 0.0))
    return _masked_mean(correct.to(p.dtype), mask)


def neg_log10_likelihood(p, target, mask=None):
    """-mean[ m*log10(p) + (1-m)*log10(1-p) ], m = (target+1)/2, with p
    clipped to [0.01, 0.99] (libFM fm_learn_mcmc_simultaneous.h:300-304)."""
    m01 = (target + 1.0) * 0.5
    pc = p.clamp(0.01, 0.99)
    ll = m01 * torch.log10(pc) + (1.0 - m01) * torch.log10(1.0 - pc)
    return -_masked_mean(ll, mask)


def required_features(ds) -> int:
    """Highest feature count `ds` addresses, including relational blocks
    in the joined attribute space (attr_offset + block features, libFM
    libfm.cpp:199-243)."""
    n = int(ds.num_features)
    for join in getattr(ds, "relations", None) or ():
        rd = join.data
        n = max(n, int(rd.attr_offset) + int(rd.num_features))
    return n


def check_num_features(cfg, *datasets) -> None:
    """Fail fast when the model's parameter table is smaller than the
    data's feature space (gathers would read out of range)."""
    need = max(required_features(d) for d in datasets if d is not None)
    if cfg.num_features < need:
        raise ValueError(
            f"FMConfig.num_features={cfg.num_features} but the data "
            f"addresses {need} features (joined attribute space); size the "
            "model to the max feature count over train/test/validation"
        )


def link_prediction(score, task: int, min_target, max_target):
    """Final-prediction link: clamp for regression, sigmoid for
    classification (libFM fm_learn_sgd.h:76-90)."""
    if task == TASK_REGRESSION:
        return score.clamp(min_target, max_target)
    if task == TASK_CLASSIFICATION:
        return 1.0 / (1.0 + torch.exp(-score))
    raise ValueError(f"unknown task {task}")

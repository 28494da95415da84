"""Distribution samplers for the Bayesian learners (PyTorch).

Every draw takes an explicit `torch.Generator` (the learner owns one,
seeded from its `seed`), so a chain is reproducible on one device. The
generator is Philox on CUDA and MT19937 on the CPU, so draws do not
match the JAX package's threefry draws: tests compare deterministic
parts pointwise and draws by their moments.

The truncated normals, the probit link Phi and the truncated-normal
expectations serve probit classification. Each truncated draw has a
form that takes its uniforms U as an argument, so a kernel and its plain
version (or a test) can be fed the same U.
"""

from __future__ import annotations

import math

import torch

# f32 runaway bound for PARAMETER draws (w0/w/V), scaled by the target
# magnitude at each learn(): a huge-but-finite draw from an
# ill-conditioned posterior overflows sum(e^2) in f32 within a couple of
# iterations; rejecting |draw| > bound (keep old, count it) is the f32
# analog of libFM's NaN/Inf rule (fm_learn_mcmc.h:700-724).
DRAW_BOUND = 1e6

# Shapes are broadcast with torch.broadcast_tensors, never
# torch.broadcast_shapes: the latter imports sympy at its first call,
# seconds of host time inside the first MCMC iteration.


def gaussian(generator: torch.Generator, mean: torch.Tensor, stdev: torch.Tensor):
    """mean + stdev * N(0,1), elementwise over broadcast shapes."""
    mean, stdev = torch.broadcast_tensors(mean, stdev)
    z = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return mean + stdev * z


def gamma(generator: torch.Generator, alpha, beta: torch.Tensor):
    """Gamma(shape=alpha, rate=beta) — libFM's ran_gamma(alpha, beta) =
    ran_gamma(alpha)/beta (src/util/random.h:144). alpha: a tensor or a
    number.

    alpha is broadcast against beta BEFORE sampling, so a [G,1] alpha
    with a [G,k] rate draws G*k independent variates (drawing alpha's
    shape alone would reuse one variate across the k columns)."""
    alpha = torch.as_tensor(alpha, dtype=beta.dtype, device=beta.device)
    alpha, beta = torch.broadcast_tensors(alpha, beta)
    return torch._standard_gamma(alpha.contiguous(), generator=generator) / beta


def finite_or(new: torch.Tensor, old: torch.Tensor, bound=None):
    """Keep the old value wherever the new draw is NaN/Inf (libFM's
    per-draw rejection rule) or, with `bound`, wherever |new| exceeds it.
    Returns (value, number rejected as an int64 tensor)."""
    ok = torch.isfinite(new)
    if bound is not None:
        ok = ok & (new.abs() <= bound)
    return torch.where(ok, new, old), (~ok).sum()


# ---- probit classification (JAX ops/samplers.py:56-139)

_SQRT2 = math.sqrt(2.0)
#: the largest float32 below 1: the inverse-CDF draw keeps u inside
#: (-1, 1). torch's erf (and CUDA's erff) round to exactly +-1 from
#: |x| ~ 3.83 on, and erfinv(+-1) is infinite; XLA's f32 erf saturates
#: at 0.9999998 instead, so the JAX draw never meets u = +-1. With u held
#: below 1 a draw deep in the tail clips to the truncation point, as the
#: JAX draw does.
ONE_BELOW = float(torch.nextafter(torch.tensor(1.0), torch.tensor(0.0)))


def truncated_normal_from_uniform(lo, hi, U):
    """jax.random.truncated_normal's inverse-CDF transform on given
    uniforms U in [0, 1): a = erf(lo/sqrt2), b = erf(hi/sqrt2),
    u = max(a, a + (b - a) U) held inside (-1, 1), z = sqrt2 erfinv(u),
    clipped to [nextafter(lo, +inf), nextafter(hi, -inf)].

    lo/sqrt2 is taken as lo * f32(1/sqrt2), as PyTorch's CUDA division by
    a scalar and the kernels take it: where u nears +-1 an ulp of erf's
    argument moves the draw by up to 1e-4."""
    lo, hi, U = torch.broadcast_tensors(lo, hi, U)
    a = torch.erf(lo * (1.0 / _SQRT2))
    b = torch.erf(hi * (1.0 / _SQRT2))
    u = torch.maximum(a, U * (b - a) + a).clamp(-ONE_BELOW, ONE_BELOW)
    z = _SQRT2 * torch.erfinv(u)
    inf = torch.full_like(lo, math.inf)
    return torch.minimum(torch.maximum(z, torch.nextafter(lo, inf)),
                         torch.nextafter(hi, -inf))


def left_truncated_from_uniform(left, mean, stdev, U):
    """N(mean, stdev) conditioned on x >= left, from uniforms U."""
    lo = (left - mean) / stdev
    lo = torch.as_tensor(lo)
    return mean + stdev * truncated_normal_from_uniform(
        lo, torch.full_like(lo, math.inf), U)


def right_truncated_from_uniform(right, mean, stdev, U):
    """N(mean, stdev) conditioned on x <= right, from uniforms U."""
    hi = torch.as_tensor((right - mean) / stdev)
    return mean + stdev * truncated_normal_from_uniform(
        torch.full_like(hi, -math.inf), hi, U)


def _uniform_like(generator, x):
    return torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)


def left_truncated_gaussian(generator, left, mean, stdev):
    """Sample N(mean, stdev) conditioned on x >= left (libFM
    ran_left_tgaussian, src/util/random.h:70-104)."""
    mean = torch.as_tensor(mean)
    return left_truncated_from_uniform(left, mean, stdev, _uniform_like(generator, mean))


def right_truncated_gaussian(generator, right, mean, stdev):
    """Sample N(mean, stdev) conditioned on x <= right (libFM
    ran_right_tgaussian, src/util/random.h:106-112)."""
    mean = torch.as_tensor(mean)
    return right_truncated_from_uniform(right, mean, stdev, _uniform_like(generator, mean))


def cdf_gaussian(x):
    """Standard normal CDF Phi(x), with the exact erf."""
    return 0.5 * (1.0 + torch.erf(x * (1.0 / _SQRT2)))


def normal_pdf(x):
    return torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def _normal_hazard(a):
    """phi(a) / (1 - Phi(a)), stable for every a: erfc up to a = 6, the
    asymptotic series a + 1/a - 2/a^3 + 10/a^5 above (the naive
    1 - Phi(a) cancels in f32 from a ~ 5.3 on)."""
    direct = normal_pdf(a) / torch.clamp_min(0.5 * torch.erfc(a * (1.0 / _SQRT2)), 1e-38)
    a_safe = torch.where(a > 6.0, a, torch.full_like(a, 6.0))
    asym = a_safe + 1.0 / a_safe - 2.0 / a_safe**3 + 10.0 / a_safe**5
    return torch.where(a > 6.0, asym, direct)


def left_tn_expectation(mu):
    """E[z | z ~ N(mu, 1), z >= 0] = mu + hazard(-mu): the ALS latent
    (libFM fm_learn_mcmc_simultaneous.h:177-182)."""
    return mu + _normal_hazard(-mu)


def right_tn_expectation(mu):
    """E[z | z ~ N(mu, 1), z <= 0] = mu - hazard(mu)
    (fm_learn_mcmc_simultaneous.h:186-192)."""
    return mu - _normal_hazard(mu)


def probit_latent(pred, y, U=None):
    """The probit latent of each case: N(pred, 1) truncated to [0, inf)
    where y >= 0 and to (-inf, 0] where y < 0, drawn from the uniforms U
    (the same U for both sides, as the JAX engine draws both from one
    key), or with U None the truncated normal's expectation (ALS)."""
    if U is None:
        pos, neg = left_tn_expectation(pred), right_tn_expectation(pred)
    else:
        pos = left_truncated_from_uniform(0.0, pred, 1.0, U)
        neg = right_truncated_from_uniform(0.0, pred, 1.0, U)
    return torch.where(y >= 0.0, pos, neg)

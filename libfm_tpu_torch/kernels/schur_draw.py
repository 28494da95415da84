"""schur_draw: blocked joint draw of theta_j = (w_j, v_j) from each
feature's GG row, Cholesky and both solves fused in. CUDA source:
csrc/schur_draw.cu.

Replaces the JAX engine's `draw_chunk` (libfm_tpu/learners/mcmc_vector.py)
with the lane Cholesky and solves (libfm_tpu/ops/lane_chol.py) it calls.

Its relational form, `schur_draw_rel`, also adds each draw's shift to the
relational (BS) engine's per-block-row state SD: K10's `upd_chunk`
(libfm_tpu/learners/mcmc_rel_vector.py), whose contract
`rel_sweep.rel_update_plain` keeps, done by the warp that drew the
feature.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, padded_width, ptr
from libfm_tpu_torch.kernels.rel_sweep import rel_update_plain
from libfm_tpu_torch.kernels.slot_stats import gg_width
from libfm_tpu_torch.ops.lane_chol import (
    cholesky_lanes,
    solve_lower_lanes,
    solve_upper_lanes,
)

KERNEL = Kernel(
    "schur_draw", "schur_draw_launch",
    [ctypes.c_void_p] * 8
    + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float],
)
#: the relational form: K10's update (rel_update) folded into the draw,
#: registered under K10's name and counted as a schur_draw launch too
REL = Kernel(
    "rel_update", "schur_draw_rel_launch",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_float],
    also_counts=(KERNEL,),
)
# features per step of the plain version (bounds its [C, k, k] temps)
_PLAIN_CHUNK = 8192


def unpack_sym(GG: torch.Tensor, k: int) -> torch.Tensor:
    """[F, k, k] symmetric Qq from the packed upper triangle of GG rows."""
    T = k * (k + 1) // 2
    iu0, iu1 = np.triu_indices(k)
    sym = np.zeros((k, k), np.int64)
    sym[iu0, iu1] = np.arange(T)
    sym[iu1, iu0] = sym[iu0, iu1]
    idx = torch.as_tensor(sym.reshape(-1), device=GG.device)
    return GG[:, :T][:, idx].reshape(-1, k, k)


def schur_system(GG, theta, lam, mu, alpha):
    """(S, b0, bv, s0, col) of the blocked draw for a batch of features:
    S = alpha Qq + diag(lamv) - col col^T, with s0 = sqrt(alpha aa + lam0),
    col = alpha qa / s0, b = alpha H^T H theta - alpha H^T e + lam mu."""
    k = theta.shape[1] - 1
    T = k * (k + 1) // 2
    Qq = unpack_sym(GG, k)
    qa = GG[:, T:T + k]
    qe = GG[:, T + k:T + 2 * k]
    aa = GG[:, T + 2 * k]
    ae = GG[:, T + 2 * k + 1]
    th0, thv = theta[:, 0], theta[:, 1:]
    lam0, lamv = lam[:, 0], lam[:, 1:]
    b0 = alpha * (aa * th0 + (qa * thv).sum(-1)) - alpha * ae + lam0 * mu[:, 0]
    bv = (
        alpha * (qa * th0[:, None] + torch.einsum("fij,fj->fi", Qq, thv))
        - alpha * qe
        + lamv * mu[:, 1:]
    )
    s0 = torch.sqrt(alpha * aa + lam0)
    col = alpha * qa / s0[:, None]
    S = alpha * Qq + torch.diag_embed(lamv) - col[:, :, None] * col[:, None, :]
    return S, b0, bv, s0, col


def scalar_draw_plain(GG, theta, lam, mu, z, alpha, *, do_sample, bound):
    """schur_draw_plain at k = 0 (the pure linear model): the JAX engine's
    scalar conjugate draw of w (mcmc_vector.py draw_chunk's k == 0 branch,
    mcmc_rel_vector.py blocked_theta_draw's), from GG = [aa | ae]."""
    aa, ae = GG[:, 0], GG[:, 1]
    w, lam0, mu0 = theta[:, 0], lam[:, 0], mu[:, 0]
    prec = alpha * aa + lam0
    new = (alpha * aa * w - alpha * ae + lam0 * mu0) / prec
    if do_sample:
        new = new + z[:, 0] / torch.sqrt(prec)
    ok = new.abs() <= bound  # False for NaN
    return torch.where(ok, new, w)[:, None], (~ok).int()


def schur_draw_plain(GG, theta, lam, mu, z, alpha, *, do_sample, bound):
    """The plain PyTorch version; same contract as `schur_draw`."""
    if theta.shape[1] == 1:
        return scalar_draw_plain(GG, theta, lam, mu, z, alpha, do_sample=do_sample,
                                 bound=bound)
    Fd = theta.shape[0]
    out = torch.empty_like(theta)
    rej = torch.zeros(Fd, dtype=torch.int32, device=theta.device)
    for f0 in range(0, Fd, _PLAIN_CHUNK):
        f1 = min(Fd, f0 + _PLAIN_CHUNK)
        th = theta[f0:f1]
        S, b0, bv, s0, col = schur_system(
            GG[f0:f1], th, lam[f0:f1], mu[f0:f1], alpha
        )
        L = cholesky_lanes(S)
        y0 = b0 / s0
        yv = solve_lower_lanes(L, bv - col * y0[:, None])
        if do_sample:
            y0 = y0 + z[f0:f1, 0]
            yv = yv + z[f0:f1, 1:]
        xv = solve_upper_lanes(L, yv)
        x0 = (y0 - (col * xv).sum(-1)) / s0
        new = torch.cat([x0[:, None], xv], dim=1)
        ok = (new.abs() <= bound).all(dim=1, keepdim=True)  # False for NaN
        out[f0:f1] = torch.where(ok, new, th)
        rej[f0:f1] = (~ok[:, 0]).int()
    return out, rej


def schur_draw(GG, theta, lam, mu, z, alpha, *, do_sample, bound):
    """Draw (or, with do_sample=False, solve for the mean of) every
    feature's theta = (w, v) ~ N(Lam^-1 b, Lam^-1); at k = 0 the scalar
    draw of w alone (`scalar_draw_plain`).

    GG [Fd, T+2k+2] statistics rows; theta (old), lam, mu [Fd, k+1];
    z [Fd, k+1] standard normal noise (read only when sampling; may be
    None otherwise); alpha a 0-dim tensor. Returns (theta_new [Fd, k+1],
    rej int32 [Fd]): a draw that is not finite or exceeds `bound` in any
    component keeps the old theta and has rej = 1.
    """
    tensors = [GG, theta, lam, mu, alpha] + ([z] if do_sample else [])
    if not on_cuda(*tensors):
        return schur_draw_plain(GG, theta, lam, mu, z, alpha,
                                do_sample=do_sample, bound=bound)
    Fd, d = theta.shape
    k = d - 1
    check(GG, "GG", torch.float32, (Fd, gg_width(k)))
    check(theta, "theta", torch.float32)
    check(lam, "lam", torch.float32, (Fd, d))
    check(mu, "mu", torch.float32, (Fd, d))
    check(alpha, "alpha", torch.float32, ())
    if do_sample:
        check(z, "z", torch.float32, (Fd, d))
    out = torch.empty_like(theta)
    rej = torch.empty(Fd, dtype=torch.int32, device=theta.device)
    KERNEL.launch(
        ptr(GG), ptr(theta), ptr(lam), ptr(mu), ptr(z) if do_sample else None,
        ptr(alpha), ptr(out), ptr(rej), Fd, k, padded_width(k, min_k=0), int(bool(do_sample)),
        float(bound),
    )
    return out, rej


def schur_draw_rel_plain(GG, theta, lam, mu, z, alpha, SD, feat_off, entry_b, entry_x, *,
                         do_sample, bound):
    """The plain PyTorch version; same contract as `schur_draw_rel`:
    `schur_draw_plain`, then `rel_update_plain` with the theta it
    returns."""
    out, rej = schur_draw_plain(GG, theta, lam, mu, z, alpha, do_sample=do_sample,
                                bound=bound)
    entry_f = torch.repeat_interleave(
        torch.arange(theta.shape[0], dtype=torch.int32, device=feat_off.device),
        feat_off[1:] - feat_off[:-1], output_size=entry_b.shape[0])
    rel_update_plain(SD, entry_b, entry_x, entry_f, theta, out)
    return out, rej


def schur_draw_rel(GG, theta, lam, mu, z, alpha, SD, feat_off, entry_b, entry_x, *,
                   do_sample, bound):
    """`schur_draw` for one conflict-free block of a relation, which also
    adds each draw to SD [nb+1, k+1] = [s | dQB] in place (K10's update,
    `rel_sweep.rel_update_plain`'s contract): for each entry (b, x) of
    feature f, feat_off int64 [Fd+1] over entry_b int32 (block rows, all
    distinct) / entry_x float32 [E], with (dw, dv) = theta_new[f] -
    theta[f], s_b += x (dw + dv . (dQB_b - x v_old)) and dQB_b += x dv.
    A rejected draw keeps its theta, and so moves nothing. Returns
    (theta_new, rej) as `schur_draw`."""
    Fd, d = theta.shape
    if tuple(feat_off.shape) != (Fd + 1,):
        raise ValueError(f"feat_off: shape {tuple(feat_off.shape)}, expected {(Fd + 1,)}")
    if entry_b.dim() != 1 or entry_x.shape != entry_b.shape:
        raise ValueError(f"entry_b {tuple(entry_b.shape)} and entry_x "
                         f"{tuple(entry_x.shape)}: one 1-D list of entries")
    tensors = [GG, theta, lam, mu, alpha, SD, feat_off, entry_b, entry_x]
    if not on_cuda(*tensors + ([z] if do_sample else [])):
        if int(feat_off[0]) != 0 or int(feat_off[-1]) != entry_b.shape[0]:
            raise ValueError(f"feat_off runs from {int(feat_off[0])} to "
                             f"{int(feat_off[-1])}, not over the {entry_b.shape[0]} entries")
        return schur_draw_rel_plain(GG, theta, lam, mu, z, alpha, SD, feat_off, entry_b,
                                    entry_x, do_sample=do_sample, bound=bound)
    k = d - 1
    check(GG, "GG", torch.float32, (Fd, gg_width(k)))
    check(theta, "theta", torch.float32)
    check(lam, "lam", torch.float32, (Fd, d))
    check(mu, "mu", torch.float32, (Fd, d))
    check(alpha, "alpha", torch.float32, ())
    if do_sample:
        check(z, "z", torch.float32, (Fd, d))
    check(SD, "SD", torch.float32, (SD.shape[0], d))
    check(feat_off, "feat_off", torch.int64)
    check(entry_b, "entry_b", torch.int32)
    check(entry_x, "entry_x", torch.float32)
    out = torch.empty_like(theta)
    rej = torch.empty(Fd, dtype=torch.int32, device=theta.device)
    REL.launch(
        ptr(GG), ptr(theta), ptr(lam), ptr(mu), ptr(z) if do_sample else None, ptr(alpha),
        ptr(out), ptr(rej), ptr(SD), ptr(feat_off), ptr(entry_b), ptr(entry_x), Fd, k,
        padded_width(k), int(bool(do_sample)), float(bound),
    )
    return out, rej

"""fm_refresh: FM forward over padded rows; rewrites A = [e | Q] (train)
or returns the predictions (test). CUDA source: csrc/fm_refresh.cu.

Replaces the JAX engine's refresh_A_and_train_metric (regression, and
the probit branch of classification, K5b), _chunk_pred_q and
predict_padded (libfm_tpu/learners/mcmc_vector.py). The probit train
mode counts its launches apart, as `fm_refresh_probit`.
"""

from __future__ import annotations

import ctypes

import torch

from libfm_tpu_torch.kernels import Kernel, check, check_aligned, on_cuda, ptr
from libfm_tpu_torch.ops.samplers import cdf_gaussian, probit_latent

_ARGTYPES = (
    [ctypes.c_void_p] * 10
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int]
)
KERNEL = Kernel("fm_refresh", "fm_refresh_launch", _ARGTYPES)
#: the same entry point in its probit train mode, counted apart
PROBIT_KERNEL = Kernel("fm_refresh_probit", "fm_refresh_launch", _ARGTYPES)
#: the probit modes: latents drawn from given uniforms, or expectations
PROBIT_MODES = {"sample": 1, "mean": 2}
#: length of the per-CTA error partials (the kernel's grid is at most
#: this; it writes 0 past its grid, so the sum is over a fixed length)
_PARTS = 4096


def probit_correct(pred, y):
    """1 where Phi(pred) >= 0.5 and y > 0, or Phi(pred) < 0.5 and y < 0."""
    p = cdf_gaussian(pred)
    return (((p >= 0.5) & (y > 0.0)) | ((p < 0.5) & (y < 0.0))).to(pred.dtype)


def write_train_rows(A, pred, Q, y, min_target, max_target, probit=None, U=None,
                     latent=None):
    """The train mode's output, shared by the plain versions of fm_refresh
    and rel_refresh: A = [pred - y | Q] and the clipped squared error
    summed; in a probit mode A = [pred - latent | Q], the latents written
    and the correct cases counted."""
    A[:, 1:] = Q
    if probit is not None:
        lat = probit_latent(pred, y, U if probit == "sample" else None)
        A[:, 0] = pred - lat
        latent.copy_(lat)
        return probit_correct(pred, y).sum()
    A[:, 0] = pred - y
    err = pred.clamp(min_target, max_target) - y
    return (err * err).sum()


def fm_refresh_plain(P, ids, vals, w0, y=None, A=None, *, use_linear=True,
                     use_bias=True, min_target=0.0, max_target=0.0, probit=None,
                     U=None, latent=None):
    """The plain PyTorch version; same contract as `fm_refresh`."""
    rows = P[ids.long()]  # [nr, L, d]
    wx = rows[..., 0] * vals
    vx = rows[..., 1:] * vals[..., None]
    Q = vx.sum(dim=1)
    sq = (vx * vx).sum(dim=(1, 2))
    pred = 0.5 * ((Q * Q).sum(dim=1) - sq)
    if use_linear:
        pred = pred + wx.sum(dim=1)
    if use_bias:
        pred = pred + w0
    if A is None:
        return pred
    return write_train_rows(A, pred, Q, y, min_target, max_target, probit, U, latent)


def fm_refresh(P, ids, vals, w0, y=None, A=None, *, use_linear=True,
               use_bias=True, min_target=0.0, max_target=0.0, probit=None,
               U=None, latent=None):
    """Forward pass of the FM with packed parameters P = [w | V] [n, k+1]
    over padded rows ids/vals [nr, L] (padding: value 0); w0 is a 0-dim
    tensor.

    Test mode (A is None): returns pred [nr].
    Train mode (A [nr, k+1] and y [nr] given): writes A[r] = [pred - y | Q]
    in place and returns the clipped squared error summed over the rows
    (0-dim tensor), with predictions clipped to [min_target, max_target].
    On the card A must be 16-byte aligned (the kernel stores it by bulk
    copies).
    Probit train mode (classification; `probit` "sample" with uniforms
    U [nr] in [0, 1), or "mean"): each case's latent is a draw of
    N(pred, 1) truncated to [0, inf) where y >= 0 and to (-inf, 0] where
    y < 0 (samplers.probit_latent), or that truncated normal's
    expectation; writes latent [nr] and A[r] = [pred - latent | Q] and
    returns the number of cases with Phi(pred) >= 0.5 and y > 0 or
    Phi(pred) < 0.5 and y < 0 (0-dim tensor).
    """
    train = A is not None
    if probit is not None and (probit not in PROBIT_MODES or not train or latent is None
                               or (probit == "sample") != (U is not None)):
        raise ValueError(f"probit={probit!r} needs A, y, latent and (sampling) U")
    tensors = [P, ids, vals, w0] + ([y, A] if train else [])
    tensors += [t for t in (U, latent) if t is not None]
    if not on_cuda(*tensors):
        return fm_refresh_plain(
            P, ids, vals, w0, y, A, use_linear=use_linear, use_bias=use_bias,
            min_target=min_target, max_target=max_target, probit=probit, U=U,
            latent=latent,
        )
    nr, L = ids.shape
    d = P.shape[1]
    check(P, "P", torch.float32)
    check(ids, "ids", torch.int32)
    check(vals, "vals", torch.float32, (nr, L))
    check(w0, "w0", torch.float32, ())
    if train:
        check(y, "y", torch.float32, (nr,))
        check(A, "A", torch.float32, (nr, d))
        check_aligned(A, "A")
    if probit is not None:
        check(latent, "latent", torch.float32, (nr,))
        if U is not None:
            check(U, "U", torch.float32, (nr,))
    if nr == 0:
        return (torch.zeros((), dtype=torch.float32, device=P.device) if train
                else torch.empty(0, dtype=torch.float32, device=P.device))
    if train:
        part = torch.empty(_PARTS, dtype=torch.float32, device=P.device)
        pred = None
    else:
        part = None
        pred = torch.empty(nr, dtype=torch.float32, device=P.device)
    (KERNEL if probit is None else PROBIT_KERNEL).launch(
        ptr(P), ptr(ids), ptr(vals), ptr(y), ptr(w0), ptr(A), ptr(pred),
        ptr(part), ptr(U), ptr(latent), nr, L, d - 1, int(use_linear), int(use_bias),
        float(min_target), float(max_target), _PARTS, PROBIT_MODES.get(probit, 0),
    )
    return part.sum() if train else pred

"""probit_latent: the probit latents' resample between refreshes, in
place on A's residual column. CUDA source: csrc/probit_latent.cu.

Replaces the JAX engine's classification fast path in one_step
(libfm_tpu/learners/mcmc_vector.py): with the sweeps keeping
e = pred - latent current, pred = e + latent needs no pass over P. The
same pass sums the new e and its capped squares, which the learners' next
alpha and w0 draws take in place of another pass over A's column.
"""

from __future__ import annotations

import ctypes

import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, ptr
from libfm_tpu_torch.kernels.fm_refresh import probit_correct
from libfm_tpu_torch.ops.samplers import probit_latent as draw_latent

KERNEL = Kernel(
    "probit_latent", "probit_latent_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_int],
)
#: length of each row of the per-CTA partials (the kernel's grid is at most this)
_PARTS = 1024


def capped_squares(e):
    """e * e with draw_alpha's rule (learners/mcmc.py): each square capped
    at 1e30, a non-finite one counted as 1e30."""
    e2 = e * e
    return torch.where(torch.isfinite(e2), e2.clamp_max(1e30), torch.full_like(e2, 1e30))


def probit_latent_plain(A, latent, y, U=None):
    """The plain PyTorch version; same contract as `probit_latent`."""
    pred = A[:, 0] + latent
    correct = probit_correct(pred, y).sum()
    lat = draw_latent(pred, y, U)
    e = pred - lat
    A[:, 0] = e
    latent.copy_(lat)
    return correct, e.sum(), capped_squares(e).sum()


def probit_latent(A, latent, y, U=None):
    """In place, for every train case r with pred = A[r, 0] + latent[r]:
    latent[r] becomes a draw of N(pred, 1) truncated to [0, inf) where
    y[r] >= 0 and to (-inf, 0] where y[r] < 0, from the uniform U[r] in
    [0, 1) (U None: that truncated normal's expectation, ALS), and
    A[r, 0] = pred - latent[r]. Returns (correct, sum_e, sum_e2), 0-dim
    tensors: the number of cases with Phi(pred) >= 0.5 and y > 0 or
    Phi(pred) < 0.5 and y < 0, before the resample; the sum of the new
    A[:, 0]; and the sum of its squares under draw_alpha's rule
    (`capped_squares`), so that draw_alpha_from_sum on it gives
    draw_alpha's gamma_n. The kernel sums in a fixed order: the same bits
    on every run.

    A [nc, k+1] float32, contiguous; latent, y, U float32 [nc]."""
    tensors = [A, latent, y] + ([U] if U is not None else [])
    if not on_cuda(*tensors):
        return probit_latent_plain(A, latent, y, U)
    nc, d = A.shape
    check(A, "A", torch.float32)
    check(latent, "latent", torch.float32, (nc,))
    check(y, "y", torch.float32, (nc,))
    if U is not None:
        check(U, "U", torch.float32, (nc,))
    part = torch.empty(3, _PARTS, dtype=torch.float32, device=A.device)
    KERNEL.launch(ptr(A), d, ptr(latent), ptr(y), ptr(U), nc, int(U is not None),
                  ptr(part), _PARTS)
    correct, sum_e, sum_e2 = part.sum(dim=1)
    return correct, sum_e, sum_e2

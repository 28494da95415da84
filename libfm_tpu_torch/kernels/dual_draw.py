"""dual_draw: joint draw of theta_j = (w_j, v_j) through the c x c
Woodbury (dual) system of each feature's c slots, Cholesky and both
solves fused in. CUDA source: csrc/dual_draw.cu.

Replaces the JAX engine's `dual_chunk` (libfm_tpu/learners/mcmc_vector.py)
with the lane Cholesky and `cho_solve_lanes` (libfm_tpu/ops/lane_chol.py)
it calls. With Lam = D + alpha H^T H (D = diag(lam)), Lam^-1 H^T =
D^-1 H^T (I + alpha H D^-1 H^T)^-1, so the posterior mean and an exact
N(mu_post, Lam^-1) draw need only a c x c Cholesky when a feature has
c < d entries (Bhattacharya et al. 2016).

The kernel works on each feature's real slot count c; the JAX engine
pads each segment to its bucket's width W and splits off the count <= 2
segments, and both give the same function: a padding slot has h = 0 and
e = 0, so its row of K is a row of I and its noise never reaches theta.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, ptr
from libfm_tpu_torch.ops.lane_chol import cho_solve_lanes, cholesky_lanes

KERNEL = Kernel(
    "dual_draw", "dual_draw_launch",
    [ctypes.c_void_p] * 14
    + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_float],
)
#: the most slots a dual feature may hold (the JAX engine's W <= 64)
MAX_SLOTS = 64
#: warps (features) a CTA holds at most (csrc: kMaxWarps)
CTA_WARPS = 16
#: a CTA's shared memory holds the areas of this many features of the
#: longest list, so 2 CTAs share an SM at c = 32, d = 129
_AREAS_OF_LONGEST = 4
# features per step of the plain version (bounds its [C, c, d] temps)
_PLAIN_CHUNK = 4096


def area_floats(c, d: int):
    """Shared-memory floats of one feature of c slots: its A rows (then h),
    K (c rows of c | 1, room for c + 1) and the right-hand side."""
    return c * d + c * (c + 1) + c


class DualPlan:
    """dual_draw's CTAs for one feature set, made once (a host copy of the
    offsets): the features, in order, go to CTAs of at most CTA_WARPS
    features whose areas (`area_floats` of each feature's own count) fit
    the CTA's shared memory, `floats` (the areas of _AREAS_OF_LONGEST
    features of the longest list). A CTA of features of few slots so
    holds up to 16 of them where one of the longest lists holds 4.

    cta_first int32 [ctas+1]: each CTA's first feature; area int32 [F]:
    where each feature's area starts in its CTA's shared memory."""

    def __init__(self, dual_off, d: int, device):
        off = dual_off.cpu().numpy() if torch.is_tensor(dual_off) else np.asarray(dual_off)
        cnt = np.diff(off).astype(np.int64)
        self.cmax = int(cnt.max()) if len(cnt) else 0
        if self.cmax > MAX_SLOTS:
            raise ValueError(f"dual_draw takes features of at most {MAX_SLOTS} slots; "
                             f"got up to {self.cmax}")
        need = area_floats(cnt, d)
        self.floats = _AREAS_OF_LONGEST * int(area_floats(max(self.cmax, 1), d))
        first, area = [0], np.zeros(len(cnt), dtype=np.int64)
        used = 0
        for j, a in enumerate(need.tolist()):
            if used + a > self.floats or j - first[-1] == CTA_WARPS:
                first.append(j)
                used = 0
            area[j] = used
            used += a
        if len(cnt):
            first.append(len(cnt))
        self.ctas = len(first) - 1
        self.cta_first = torch.as_tensor(np.asarray(first, dtype=np.int32), device=device)
        self.area = torch.as_tensor(area.astype(np.int32), device=device)


def dual_system(A, dual_off, sel, slot_case, slot_val, theta, lam, mu, alpha, *,
                use_linear):
    """The Woodbury systems of the features `sel` (a long index tensor into
    dual_off's features), their slots padded to the largest count cm with
    h = 0 and e = 0: (Phi [C, cm, d], Dinv [C, d], ytil [C, cm], K [C, cm,
    cm] = Phi D^-1 Phi^T + I, real bool [C, cm], pos [C, cm] the slots'
    positions, 0 at padding)."""
    off = dual_off.long()
    c = off[sel + 1] - off[sel]
    cm = max(1, int(c.max()))
    zero = torch.zeros((), device=theta.device)
    s = torch.arange(cm, device=theta.device)
    real = s[None, :] < c[:, None]
    pos = torch.where(real, off[sel][:, None] + s, torch.zeros_like(s))
    x = torch.where(real, slot_val[pos], zero)
    A_slot = A[slot_case[pos].long()]  # [C, cm, d]
    e = torch.where(real, A_slot[..., 0], zero)
    th, m = theta[sel], mu[sel]
    qp = A_slot[..., 1:] - x[..., None] * th[:, None, 1:]
    h = torch.cat([x[..., None], x[..., None] * qp], dim=-1)
    if not use_linear:
        h[..., 0] = 0.0
    Dinv = 1.0 / lam[sel]
    sqa = torch.sqrt(alpha)
    Phi = sqa * h
    ytil = sqa * (torch.einsum("cwd,cd->cw", h, th - m) - e)
    K = torch.einsum("cwd,cd,cud->cwu", Phi, Dinv, Phi) + torch.eye(cm, device=theta.device)
    return Phi, Dinv, ytil, K, real, pos


def dual_draw_plain(A, dual_off, slot_case, slot_val, theta, lam, mu, u, dl, alpha, *,
                    do_sample, bound, use_linear, plan=None):
    """The plain PyTorch version; same contract as `dual_draw` (`plan` is
    not read). Features go in chunks of like slot counts, each padded to
    its largest count."""
    Fu, d = theta.shape
    out = torch.empty_like(theta)
    rej = torch.zeros(Fu, dtype=torch.int32, device=theta.device)
    if Fu == 0:
        return out, rej
    order = torch.argsort(dual_off[1:] - dual_off[:-1], stable=True)
    for f0 in range(0, Fu, _PLAIN_CHUNK):
        sel = order[f0:f0 + _PLAIN_CHUNK]
        Phi, Dinv, ytil, K, real, pos = dual_system(
            A, dual_off, sel, slot_case, slot_val, theta, lam, mu, alpha,
            use_linear=use_linear)
        L = cholesky_lanes(K)
        if do_sample:
            up = torch.sqrt(Dinv) * u[sel]
            noise = torch.where(real, dl[pos], torch.zeros((), device=theta.device))
            v = torch.einsum("cwd,cd->cw", Phi, up) + noise
        else:
            up = torch.zeros_like(Dinv)
            v = torch.zeros_like(ytil)
        w = cho_solve_lanes(L, ytil - v)
        new = mu[sel] + (up + Dinv * torch.einsum("cwd,cw->cd", Phi, w))
        ok = (new.abs() <= bound).all(dim=1, keepdim=True)  # False for NaN
        out[sel] = torch.where(ok, new, theta[sel])
        rej[sel] = (~ok[:, 0]).int()
    return out, rej


def dual_draw(A, dual_off, slot_case, slot_val, theta, lam, mu, u, dl, alpha, *,
              do_sample, bound, use_linear, plan=None):
    """Draw (or, with do_sample=False, solve for the mean of) the theta =
    (w, v) of every dual feature through its c x c Woodbury system.

    A [num_rows, k+1] = [e | Q]; feature j's slots are [dual_off[j],
    dual_off[j+1]) of slot_case (int32 rows of A) and slot_val (float32),
    at most MAX_SLOTS of them (the learner sends features of c < k+1).
    theta (old), lam, mu [Fu, k+1] are the features' rows; theta's factor part is the pre-draw
    v_j that h = x [1 | Q - x v_j] takes. When sampling, u [Fu, k+1]
    and dl [num slots] are standard normal noise (a feature's u and its
    slots' dl; may be None otherwise); alpha is a 0-dim tensor. With
    use_linear False the w column of h is zero. `plan`, the features' CTAs
    (`DualPlan`, made once for the feature set), is made here, a host copy,
    when not given. Returns (theta_new [Fu, k+1], rej int32 [Fu]): a draw
    that is not finite or exceeds `bound` in any component keeps the old
    theta and has rej = 1.
    """
    tensors = [A, dual_off, slot_case, slot_val, theta, lam, mu, alpha] + (
        [u, dl] if do_sample else [])
    if not on_cuda(*tensors):
        return dual_draw_plain(A, dual_off, slot_case, slot_val, theta, lam, mu, u, dl,
                               alpha, do_sample=do_sample, bound=bound,
                               use_linear=use_linear)
    Fu, d = theta.shape
    E = slot_case.shape[0]
    check(A, "A", torch.float32, (A.shape[0], d))
    check(dual_off, "dual_off", torch.int64, (Fu + 1,))
    check(slot_case, "slot_case", torch.int32)
    check(slot_val, "slot_val", torch.float32, (E,))
    check(theta, "theta", torch.float32)
    check(lam, "lam", torch.float32, (Fu, d))
    check(mu, "mu", torch.float32, (Fu, d))
    check(alpha, "alpha", torch.float32, ())
    if do_sample:
        check(u, "u", torch.float32, (Fu, d))
        check(dl, "dl", torch.float32, (E,))
    if plan is None:
        plan = DualPlan(dual_off, d, theta.device)
    out = torch.empty_like(theta)
    rej = torch.empty(Fu, dtype=torch.int32, device=theta.device)
    if Fu == 0:
        return out, rej
    KERNEL.launch(
        ptr(A), ptr(dual_off), ptr(slot_case), ptr(slot_val), ptr(theta), ptr(lam),
        ptr(mu), ptr(u) if do_sample else None, ptr(dl) if do_sample else None,
        ptr(alpha), ptr(plan.cta_first), ptr(plan.area), ptr(out), ptr(rej), plan.ctas,
        d - 1, plan.floats, int(bool(do_sample)), int(bool(use_linear)), float(bound),
    )
    return out, rej

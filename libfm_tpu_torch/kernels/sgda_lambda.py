"""sgda_lambda: one lambda step of SGDA on a validation batch (the
look-ahead prediction and a clamped gradient step on the per-group
regularizers, in place). CUDA source: csrc/sgda_lambda.cu.

Replaces K13's `lambda_step` (libfm_tpu/learners/sgda.py:109-173). The
reduction to G x (1+k) is taken in a fixed order, with no floating-point
atomics; the kernel holds a warp's copy of it in shared memory, so one
call takes G * (1+k) <= MAX_GROUP_WIDTH.
"""

from __future__ import annotations

import ctypes

import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, ptr
from libfm_tpu_torch.kernels.sgda_step import MODES, entry_values, sgda_multiplier

KERNEL = Kernel(
    "sgda_lambda", "sgda_lambda_launch",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float] * 3,
)
#: the largest G * (1+k) one call takes (csrc: kMaxGD): k = 128 with up
#: to 55 groups, k = 16 with up to 421
MAX_GROUP_WIDTH = 7168
_MAX_CTAS = 264  # CTA partials the scratch holds (csrc: kMaxCtas)


def sgda_lambda_scratch(num_groups: int, k: int, device) -> torch.Tensor:
    """Zeroed scratch for `sgda_lambda` with `num_groups` groups and k
    factors on one stream (the CTA partials and the last-CTA ticket;
    csrc: sgda_lambda_scratch_floats); every call leaves it ready for the
    next, so it is allocated once."""
    return torch.zeros(_MAX_CTAS * num_groups * (k + 1) + 4, dtype=torch.float32,
                       device=device)


def sgda_lambda_plain(P, Gc, ids, vals, y, row_mask, w0, attr_group, reg_w, reg_v, *,
                      mode, task, lr, min_target, max_target, use_linear=True,
                      use_bias=True, scratch=None):
    """The plain PyTorch version (the JAX lambda_step's arithmetic: per-row,
    per-group segment sums, then the sums over the rows); same contract as
    `sgda_lambda`. Computes in P's dtype."""
    B, L = ids.shape
    k = P.shape[1] - 1
    G = reg_w.shape[0]
    dt = P.dtype
    x = entry_values(mode, vals, row_mask, dt)
    idl = ids.long()
    g = attr_group[idl].long()  # [B, L]
    em = (x != 0.0).to(dt)
    rows, grads = P[idl], Gc[idl]
    w_g, v_g = rows[..., 0], rows[..., 1:]
    w_dash = w_g - lr * (grads[..., 0] + 2.0 * reg_w[g] * w_g)
    v_dash = v_g - lr * (grads[..., 1:] + 2.0 * reg_v[g] * v_g)
    vx_d = v_dash * x[..., None]
    sum_f_dash = vx_d.sum(dim=1)  # [B, k]
    p = 0.5 * ((sum_f_dash * sum_f_dash).sum(dim=1) - (vx_d * vx_d).sum(dim=(1, 2)))
    if use_bias:
        p = p + w0
    if use_linear:
        p = p + (w_dash * x).sum(dim=1)
    gl = sgda_multiplier(p, y.to(dt), task, min_target, max_target)
    gl = torch.where(row_mask, gl, torch.zeros_like(gl))
    seg = (torch.arange(B, device=P.device)[:, None] * G + g).reshape(-1)

    def row_group_sum(e):  # [B, L, ...] -> [B, G, ...], entries in order
        out = torch.zeros((B * G,) + e.shape[2:], dtype=dt, device=P.device)
        return out.index_add_(0, seg, e.reshape((B * L,) + e.shape[2:])).reshape(
            (B, G) + e.shape[2:])

    new_w = reg_w
    if use_linear:
        lam_w = row_group_sum(x * w_g * em)  # [B, G]
        new_w = (reg_w - lr * (gl[:, None] * (-2.0 * lr * lam_w)).sum(dim=0)).clamp_min(0.0)
    xv = v_g * x[..., None]
    xv_dash = v_dash * x[..., None]
    sum_f_g = row_group_sum(xv)  # [B, G, k]
    sum_fdf_g = row_group_sum(xv_dash * xv)
    lam_v = -2.0 * lr * (sum_f_dash[:, None, :] * sum_f_g - sum_fdf_g)
    new_v = (reg_v - lr * (gl[:, None, None] * lam_v).sum(dim=0)).clamp_min(0.0)
    reg_w.copy_(new_w)
    reg_v.copy_(new_v)
    return reg_w, reg_v


def sgda_lambda(P, Gc, ids, vals, y, row_mask, w0, attr_group, reg_w, reg_v, *, mode,
                task, lr, min_target, max_target, use_linear=True, use_bias=True,
                scratch=None):
    """One SGDA lambda step on a validation batch; updates reg_w and reg_v
    in place and returns them.

    With each entry's look-ahead parameters theta' = theta - lr (grad +
    2 reg[group] theta) (w0 is not looked ahead), the row's prediction
    and multiplier gl: reg_w[g] <- max(reg_w[g] - lr sum_b gl (-2 lr
    sum_{l in g} x w), 0) (with the linear term only) and reg_v[g] <-
    max(reg_v[g] - lr sum_b gl (-2 lr (sum_l v' x . sum_{l in g} v x -
    sum_{l in g} v' x v x)), 0).

    P [n, 1+k] and Gc [n+1, 1+k] (the caches of the last `sgda_step`)
    float32; ids int32 [B, L]; vals float32 [B, L] (read in "general"
    mode only); y float32 [B]; row_mask bool [B]; w0 a 0-dim tensor;
    attr_group int32 [n] in [0, G); reg_w [G], reg_v [G, k] float32.
    On a CUDA device G * (1+k) may be at most MAX_GROUP_WIDTH; the call
    raises above it. `scratch` (`sgda_lambda_scratch(G, k)`'s) may be
    passed in so that a call allocates nothing."""
    tensors = [P, Gc, ids, vals, y, row_mask, w0, attr_group, reg_w, reg_v]
    if scratch is not None:
        tensors.append(scratch)
    if not on_cuda(*tensors):
        return sgda_lambda_plain(
            P, Gc, ids, vals, y, row_mask, w0, attr_group, reg_w, reg_v, mode=mode,
            task=task, lr=lr, min_target=min_target, max_target=max_target,
            use_linear=use_linear, use_bias=use_bias,
        )
    B, L = ids.shape
    n, d = P.shape
    G = reg_w.shape[0]
    if G * d > MAX_GROUP_WIDTH:
        raise ValueError(f"sgda_lambda: G * (1+k) = {G} * {d} = {G * d} groups' columns; "
                         f"the CUDA kernel takes at most {MAX_GROUP_WIDTH}")
    check(P, "P", torch.float32)
    check(Gc, "Gc", torch.float32, (n + 1, d))
    check(ids, "ids", torch.int32)
    check(vals, "vals", torch.float32, (B, L))
    check(y, "y", torch.float32, (B,))
    check(row_mask, "row_mask", torch.bool, (B,))
    check(w0, "w0", torch.float32, ())
    check(attr_group, "attr_group", torch.int32, (n,))
    check(reg_w, "reg_w", torch.float32, (G,))
    check(reg_v, "reg_v", torch.float32, (G, d - 1))
    if mode not in MODES or (mode == "pair" and L != 2):
        raise ValueError(f"mode {mode!r} with L={L}")
    if scratch is None:
        scratch = sgda_lambda_scratch(G, d - 1, P.device)
    check(scratch, "scratch", torch.float32, (_MAX_CTAS * G * d + 4,))
    KERNEL.launch(
        ptr(P), ptr(Gc), ptr(ids), ptr(vals), ptr(y), ptr(row_mask), ptr(attr_group),
        ptr(reg_w), ptr(reg_v), ptr(w0), ptr(scratch), B, L, d, G, MODES[mode], int(task),
        int(use_linear), int(use_bias), float(lr), float(min_target), float(max_target),
    )
    return reg_w, reg_v

"""sgd_step: one mini-batch SGD step on the packed table P = [w | V], up
to the scatter. CUDA source: csrc/sgd_step.cu.

Replaces K8, the SGD learner's hand-laid chunk body `pair_step` /
`packed_step` (libfm_tpu/learners/sgd.py:128-213). The update rows it
returns are applied by `table_scatter` in the presorted order; the batch
sums and the w0 update are folded into the same launch.
"""

from __future__ import annotations

import ctypes

import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, ptr
from libfm_tpu_torch.kernels.sgda_step import fma_f32
from libfm_tpu_torch.tasks import TASK_REGRESSION

KERNEL = Kernel(
    "sgd_step", "sgd_step_launch",
    [ctypes.c_void_p] * 10
    + [ctypes.c_int] * 8
    + [ctypes.c_float] * 8,
)
MODES = {"pair": 0, "onehot": 1, "general": 2}
_MAX_PARTS = 4096  # CTA partials the scratch holds (csrc: kMaxParts)
SCRATCH_FLOATS = 2 * _MAX_PARTS + 4  # csrc: sgd_step_scratch_floats()


def sgd_step_scratch(device) -> torch.Tensor:
    """Zeroed scratch for `sgd_step` on one stream (the CTA partials and
    the last-CTA ticket); every call leaves it ready for the next, so it
    is allocated once."""
    return torch.zeros(SCRATCH_FLOATS, dtype=torch.float32, device=device)


def sgd_w0_update(w0, lr0, m, n, reg0):
    """w0 - lr0 (m + n reg0 w0), the SGD w0 line for a batch whose
    multipliers sum to m over n real rows, rounded as XLA rounds JAX's
    line on the CPU (libfm_tpu/learners/sgd.py:147) and as the kernel
    rounds it: n reg0 first, then two fused multiply-adds, g = (n reg0) w0
    + m and w0 - lr0 g, each rounded once (`fma_f32`). In another dtype,
    op by op."""
    if w0.dtype != torch.float32:
        return w0 - lr0 * (m + n * reg0 * w0)
    g = fma_f32(n * reg0, w0, m)
    return fma_f32(torch.tensor(-lr0, dtype=torch.float32, device=w0.device), g, w0)


def sgd_multiplier(pred, y, task: int, min_target, max_target):
    """Per-example loss derivative (libFM fm_learn_sgd_element.h:60-64):
    clamp(pred) - y for regression, -y (1 - sigmoid(y pred)) for
    classification."""
    if task == TASK_REGRESSION:
        return pred.clamp(min_target, max_target) - y
    return -y * (1.0 - torch.sigmoid(y * pred))


def sgd_step_plain(P, ids, vals, y, row_mask, w0, *, mode, task, lr1, lr2,
                   regw, regv, min_target, max_target, use_linear=True,
                   use_bias=True, order=None, lr0=None, reg0=0.0, upd=None,
                   red=None, scratch=None):
    """The plain PyTorch version (the JAX step's arithmetic, entry-major);
    same contract as `sgd_step`. Computes in P's dtype."""
    B, L = ids.shape
    d = P.shape[1]
    dt = P.dtype
    vals = vals.to(dt)
    rows = P[ids.reshape(-1).long()].reshape(B, L, d)
    w_g, v_g = rows[..., 0], rows[..., 1:]
    mask = row_mask.to(dt)
    onehot = mode == "onehot"
    if mode == "pair":
        pred = (v_g[:, 0] * v_g[:, 1]).sum(dim=1)
        if use_linear:
            pred = pred + w_g.sum(dim=1)
    else:
        vx = v_g if onehot else v_g * vals[..., None]
        vs = vx.sum(dim=1)  # [B, k]
        pred = 0.5 * ((vs * vs).sum(dim=1) - (vx * vx).sum(dim=(1, 2)))
        if use_linear:
            pred = pred + (w_g if onehot else w_g * vals).sum(dim=1)
    if use_bias:
        pred = pred + w0
    mult = sgd_multiplier(pred, y.to(dt), task, min_target, max_target)
    mult = torch.where(row_mask, mult, torch.zeros_like(mult))
    mE = mult[:, None]
    if mode == "general":
        em = (vals != 0.0).to(dt)
        gw = mE * vals + regw * w_g * em
        gv = mE[..., None] * (vs[:, None, :] * vals[..., None]
                              - v_g * (vals * vals)[..., None])
    else:
        em = mask[:, None].expand(B, L)
        gw = mE + regw * w_g * em
        if mode == "pair":
            gv = mE[..., None] * v_g.flip(1)
        else:
            gv = mE[..., None] * (vs[:, None, :] - v_g)
    gv = gv + regv * v_g * em[..., None]
    if not use_linear:
        gw = torch.zeros_like(gw)
    out = torch.cat([(-lr1 * gw)[..., None], -lr2 * gv], dim=2).reshape(B * L, d)
    if order is not None:
        out = torch.empty_like(out).index_copy_(0, order.reshape(-1).long(), out)
    sums = torch.stack([mult.sum(), mask.sum()])
    if upd is not None:
        out = upd.copy_(out)
    if red is not None:
        sums = red.copy_(sums)
    if lr0 is not None:
        w0.copy_(sgd_w0_update(w0, lr0, sums[0], sums[1], reg0))
    return out, sums


def sgd_step(P, ids, vals, y, row_mask, w0, *, mode, task, lr1, lr2, regw,
             regv, min_target, max_target, use_linear=True, use_bias=True,
             order=None, lr0=None, reg0=0.0, upd=None, red=None, scratch=None):
    """One mini-batch SGD step up to the scatter. Returns (upd, red):

    - upd [B*L, 1+k]: the update row of every entry (b, l), already scaled
      by -lr1 (column 0) and -lr2 (the factors), in entry order, or with
      `order` [B, L] int32 at row order[b, l] (the entry's position in the
      sorted scatter order, so that `table_scatter` reads them in order);
    - red [2]: the sum of the batch's multipliers and its count of real
      rows.

    With `lr0`, w0 is also updated in place from red, as
    `sgd_w0_update(w0, lr0, red[0], red[1], reg0)` rounds it.

    P [n, 1+k] float32; ids int32 [B, L]; vals float32 [B, L] (read in
    "general" mode only); y float32 [B]; row_mask bool [B]; w0 a 0-dim
    tensor. `mode` is "pair" (L == 2, values 1, the direct product v_u.v_i),
    "onehot" (values 1) or "general". `upd`, `red` and `scratch`
    (`sgd_step_scratch`'s) may be passed in so that a call allocates
    nothing."""
    tensors = [P, ids, vals, y, row_mask, w0]
    tensors += [t for t in (order, upd, red, scratch) if t is not None]
    if not on_cuda(*tensors):
        return sgd_step_plain(
            P, ids, vals, y, row_mask, w0, mode=mode, task=task, lr1=lr1,
            lr2=lr2, regw=regw, regv=regv, min_target=min_target,
            max_target=max_target, use_linear=use_linear, use_bias=use_bias,
            order=order, lr0=lr0, reg0=reg0, upd=upd, red=red,
        )
    B, L = ids.shape
    d = P.shape[1]
    check(P, "P", torch.float32)
    check(ids, "ids", torch.int32)
    check(vals, "vals", torch.float32, (B, L))
    check(y, "y", torch.float32, (B,))
    check(row_mask, "row_mask", torch.bool, (B,))
    check(w0, "w0", torch.float32, ())
    if order is not None:
        check(order, "order", torch.int32, (B, L))
    if mode not in MODES or (mode == "pair" and L != 2):
        raise ValueError(f"mode {mode!r} with L={L}")
    dev = P.device
    if upd is None:
        upd = torch.empty(B * L, d, dtype=torch.float32, device=dev)
    if red is None:
        red = torch.empty(2, dtype=torch.float32, device=dev)
    if scratch is None:
        scratch = sgd_step_scratch(dev)
    check(upd, "upd", torch.float32, (B * L, d))
    check(red, "red", torch.float32, (2,))
    check(scratch, "scratch", torch.float32, (SCRATCH_FLOATS,))
    KERNEL.launch(
        ptr(P), ptr(ids), ptr(vals), ptr(y), ptr(row_mask), ptr(order), ptr(w0),
        ptr(upd), ptr(scratch), ptr(red), B, L, d, MODES[mode], int(task),
        int(use_linear), int(use_bias), int(lr0 is not None),
        float(lr0 or 0.0), float(reg0), float(lr1), float(lr2), float(regw),
        float(regv), float(min_target), float(max_target),
    )
    return upd, red

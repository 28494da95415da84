"""sgda_step: one mini-batch theta step of SGDA on the packed table
P = [w | V], up to the scatter, with the gradient caches and w0. CUDA
source: csrc/sgda_step.cu.

Replaces K13's `theta_step` (libfm_tpu/learners/sgda.py:70-107). The
update rows it returns are added by `table_scatter` in the presorted
order; the cache rows, the batch sum and the w0 update are folded into
the same launch. The per-group regularizers are read on the device:
`regs_shared` says whether a CTA copies them into shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, ptr
from libfm_tpu_torch.tasks import TASK_REGRESSION

KERNEL = Kernel(
    "sgda_step", "sgda_step_launch",
    [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10 + [ctypes.c_float] * 3,
)
MODES = {"pair": 0, "onehot": 1, "general": 2}
_MAX_PARTS = 4096  # CTA partials the scratch holds (csrc: kMaxParts)
SCRATCH_FLOATS = _MAX_PARTS + 4  # csrc: sgda_step_scratch_floats()
#: the regularizers' copy in a CTA's shared memory: G (1+k) floats at most
#: (csrc: kRegFloats, `sgda_step_reg_floats()`)
REG_FLOATS = 4096


def regs_shared(G: int, k: int) -> bool:
    """Whether each CTA of a theta step copies the regularizers reg_w [G]
    and reg_v [G, k] into shared memory: where their G (1+k) floats fit
    REG_FLOATS. Else the kernel reads them from global memory."""
    return G * (k + 1) <= REG_FLOATS


def sgda_step_scratch(device) -> torch.Tensor:
    """Zeroed scratch for `sgda_step` on one stream (the CTA partials and
    the last-CTA ticket); every call leaves it ready for the next, so it
    is allocated once."""
    return torch.zeros(SCRATCH_FLOATS, dtype=torch.float32, device=device)


def sgda_multiplier(pred, y, task: int, min_target, max_target):
    """SGDA's loss derivative (sgda.py:39-44, libFM
    fm_learn_sgd_element_adapt_reg.h:139-144): 2 (clamp(pred) - y) for
    regression, unlike plain SGD's clamp(pred) - y; y (sigmoid(y pred) - 1)
    for classification."""
    if task == TASK_REGRESSION:
        return 2.0 * (pred.clamp(min_target, max_target) - y)
    return y * (torch.sigmoid(y * pred) - 1.0)


def fma_f32(a, b, c):
    """a b + c rounded once to float32, as a fused multiply-add rounds it
    (float32 tensors of one shape, or broadcast). In float64: the product
    of two float32 is exact there, the sum's rounding error is recovered
    exactly (TwoSum) and the sum rounded to odd, so that its rounding to
    float32 is the single rounding of a b + c."""
    x = a.double() * b.double()
    c = c.double()
    z = x + c
    bb = z - x
    err = (x - (z - bb)) + (c - bb)
    even = (z.reshape(-1).view(torch.int64) & 1).reshape(z.shape) == 0
    z = torch.where((err != 0) & even, torch.nextafter(z, err * float("inf")), z)
    return z.float()


def w0_update(w0, lr, s):
    """w0 - lr s rounded once, as XLA contracts JAX's w0 line into a fused
    multiply-add on the CPU (sgda.py:85-87) and as the kernel rounds it
    (__fmaf_rn); lr is taken in w0's dtype (`fma_f32` in float32)."""
    if w0.dtype != torch.float32:
        return w0 - lr * s
    return fma_f32(torch.tensor(-lr, dtype=torch.float32, device=w0.device), s, w0)


def entry_values(mode, vals, row_mask, dtype):
    """The value x of every entry [B, L]: `vals` in "general" mode; in
    "pair" and "onehot" modes, where the kernels do not read the values,
    the row mask (1 on a real row, 0 on a padded one)."""
    if mode == "general":
        return vals.to(dtype)
    return row_mask.to(dtype)[:, None].expand(vals.shape)


def sgda_step_plain(P, ids, vals, y, row_mask, w0, Gc, gc_row, attr_group, reg_w,
                    reg_v, *, order, mode, task, lr, min_target, max_target,
                    use_linear=True, use_bias=True, upd=None, red=None, scratch=None):
    """The plain PyTorch version (the JAX theta_step's arithmetic); same
    contract as `sgda_step`. Computes in P's dtype."""
    B, L = ids.shape
    d = P.shape[1]
    n = P.shape[0]
    dt = P.dtype
    x = entry_values(mode, vals, row_mask, dt)
    idl = ids.long()
    rows = P[idl]  # [B, L, d]
    w_g, v_g = rows[..., 0], rows[..., 1:]
    vx = v_g * x[..., None]
    vsum = vx.sum(dim=1)
    pred = 0.5 * ((vsum * vsum).sum(dim=1) - (vx * vx).sum(dim=(1, 2)))
    if use_linear:
        pred = pred + (w_g * x).sum(dim=1)
    if use_bias:
        pred = pred + w0
    mult = sgda_multiplier(pred, y.to(dt), task, min_target, max_target)
    mult = torch.where(row_mask, mult, torch.zeros_like(mult))
    em = (x != 0.0).to(dt)
    g = attr_group[idl].long()
    gw = mult[:, None] * x
    gv = mult[:, None, None] * (x[..., None] * (vsum[:, None, :] - v_g * x[..., None]))
    upd_v = -lr * (gv + 2.0 * reg_v[g] * v_g * em[..., None])
    if use_linear:
        upd_w = -lr * (gw + 2.0 * reg_w[g] * w_g * em)
    else:
        upd_w = torch.zeros_like(gw)
    out = torch.cat([upd_w[..., None], upd_v], dim=2).reshape(B * L, d)
    out = torch.empty_like(out).index_copy_(0, order.reshape(-1).long(), out)
    # the cache rows: one writer a row (gc_row < n), the others write nothing
    tgt = gc_row.reshape(-1).long()
    w_at = torch.nonzero(tgt < n).squeeze(1)
    if use_linear:
        Gc[:, 0].index_copy_(0, tgt[w_at], gw.reshape(-1)[w_at].to(Gc.dtype))
    Gc[:, 1:].index_copy_(0, tgt[w_at], gv.reshape(B * L, d - 1)[w_at].to(Gc.dtype))
    sums = mult.sum().reshape(1)
    if upd is not None:
        out = upd.copy_(out)
    if red is not None:
        sums = red.copy_(sums)
    if use_bias:
        w0.copy_(w0_update(w0, lr, sums[0]))
    return out, sums


def sgda_step(P, ids, vals, y, row_mask, w0, Gc, gc_row, attr_group, reg_w, reg_v, *,
              order, mode, task, lr, min_target, max_target, use_linear=True,
              use_bias=True, upd=None, red=None, scratch=None):
    """One mini-batch SGDA theta step up to the scatter. Returns (upd, red):

    - upd [B*L, 1+k]: every entry's update row -lr (g + 2 reg[group] theta m),
      at row order[b, l], the entry's sorted position (`order` [B, L] int32,
      from `sgda_scatter_plan`), so that `table_scatter` reads them in order;
    - red [1]: the sum of the batch's multipliers.

    Also, in place: Gc [n+1, 1+k] row gc_row[b, l] is set to the entry's
    gradients [mult x | mult x (vsum - v x)] wherever gc_row[b, l] < n
    (`sgda_scatter_plan` names one writer a row: the last entry of value
    != 0 of each id); column 0 only with the linear term. With use_bias,
    w0 <- w0 - lr * red[0], rounded once as `w0_update` rounds it.

    P [n, 1+k] float32; ids int32 [B, L]; vals float32 [B, L] (read in
    "general" mode only; "pair" and "onehot" take the row mask as every
    entry's value); y float32 [B]; row_mask bool [B]; w0 a 0-dim tensor;
    gc_row int32 [B, L]; attr_group int32 [n] in [0, G); reg_w [G] and
    reg_v [G, k] float32, read on the device. `mode` "pair" is "onehot"
    at L = 2. `upd`, `red` and `scratch` (`sgda_step_scratch`'s) may be
    passed in so that a call allocates nothing."""
    tensors = [P, ids, vals, y, row_mask, w0, Gc, gc_row, attr_group, reg_w, reg_v, order]
    tensors += [t for t in (upd, red, scratch) if t is not None]
    if not on_cuda(*tensors):
        return sgda_step_plain(
            P, ids, vals, y, row_mask, w0, Gc, gc_row, attr_group, reg_w, reg_v,
            mode=mode, task=task, lr=lr, min_target=min_target, max_target=max_target,
            use_linear=use_linear, use_bias=use_bias, order=order, upd=upd, red=red,
        )
    B, L = ids.shape
    n, d = P.shape
    G = reg_w.shape[0]
    check(P, "P", torch.float32)
    check(ids, "ids", torch.int32)
    check(vals, "vals", torch.float32, (B, L))
    check(y, "y", torch.float32, (B,))
    check(row_mask, "row_mask", torch.bool, (B,))
    check(w0, "w0", torch.float32, ())
    check(Gc, "Gc", torch.float32, (n + 1, d))
    check(gc_row, "gc_row", torch.int32, (B, L))
    check(attr_group, "attr_group", torch.int32, (n,))
    check(reg_w, "reg_w", torch.float32, (G,))
    check(reg_v, "reg_v", torch.float32, (G, d - 1))
    check(order, "order", torch.int32, (B, L))
    if mode not in MODES or (mode == "pair" and L != 2):
        raise ValueError(f"mode {mode!r} with L={L}")
    dev = P.device
    if upd is None:
        upd = torch.empty(B * L, d, dtype=torch.float32, device=dev)
    if red is None:
        red = torch.empty(1, dtype=torch.float32, device=dev)
    if scratch is None:
        scratch = sgda_step_scratch(dev)
    check(upd, "upd", torch.float32, (B * L, d))
    check(red, "red", torch.float32, (1,))
    check(scratch, "scratch", torch.float32, (SCRATCH_FLOATS,))
    KERNEL.launch(
        ptr(P), ptr(ids), ptr(vals), ptr(y), ptr(row_mask), ptr(order), ptr(gc_row),
        ptr(attr_group), ptr(reg_w), ptr(reg_v), ptr(w0), ptr(upd), ptr(Gc), ptr(scratch),
        ptr(red), B, L, d, n, G, int(regs_shared(G, d - 1)), MODES[mode], int(task),
        int(use_linear), int(use_bias), float(lr), float(min_target), float(max_target),
    )
    return upd, red

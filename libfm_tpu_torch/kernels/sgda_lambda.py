"""sgda_lambda: one lambda step of SGDA on a validation batch (the
look-ahead prediction and a clamped gradient step on the per-group
regularizers, in place). CUDA source: csrc/sgda_lambda.cu.

Replaces K13's `lambda_step` (libfm_tpu/learners/sgda.py:109-173). The
reduction to G x (1+k) is taken in a fixed order, with no floating-point
atomics: each lane group (a row at a time) adds into its own copy of S
in shared memory, a CTA adds its copies in order, and the CTAs'
partials are added in CTA order over two levels of at most FAN.
`lambda_plan` sizes a launch on the host: the grid by the batch, and
S's columns in tiles where one copy a lane group of all G (1+k) does not
fit in shared memory, so any G takes the kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, ptr
from libfm_tpu_torch.kernels.sgda_step import MODES, entry_values, sgda_multiplier

KERNEL = Kernel(
    "sgda_lambda", "sgda_lambda_launch",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float] * 3 + [ctypes.c_int] * 4,
)
WARPS = 8  # a CTA's warps (csrc: kWarps)
MAX_CTAS = 512  # CTAs a launch at most (csrc: kMaxCtas)
FAN = 32  # partials one CTA of the cross-CTA sum adds (csrc: kFan)
TICKET_FLOATS = 64  # the tickets at the scratch's start: MAX_CTAS // FAN + 1 ints
#: an H100 SM's shared memory, the most a CTA may have (csrc: kMaxDynamic
#: with its static part), and the share the system keeps a CTA
SMEM_SM = 233_472
SMEM_CTA = 232_448 - 256
SMEM_RESERVED = 1024


@dataclass(frozen=True)
class LambdaPlan:
    """One sgda_lambda launch: `lanes` a row and `per_lane` factors a
    lane; `grid` CTAs of `passes` passes of `rows` rows, `ctas_per_sm` of
    them on an SM at once; S's G (1+k) columns in tiles of `tile`, the
    lane groups' copies `stride` floats apart (a multiple of 32 plus
    `lanes`, so the lane groups of a warp add into other banks)."""

    lanes: int
    per_lane: int
    rows: int
    ctas_per_sm: int
    grid: int
    passes: int
    tile: int
    stride: int
    columns: int

    @property
    def tiles(self) -> int:
        return -(-self.columns // self.tile)

    @property
    def smem(self) -> int:
        """Dynamic shared memory in bytes: a tile's copy a lane group."""
        return self.rows * self.stride * 4


def _stride(width: int, lanes: int) -> int:
    return width if lanes == 32 else width + (lanes - width) % 32


def _budget(ctas_per_sm: int) -> int:
    return min(SMEM_CTA, SMEM_SM // ctas_per_sm - SMEM_RESERVED - 256)


@lru_cache(maxsize=256)
def _form(k: int, G: int) -> tuple[int, int, int, int, int, int]:
    """(lanes, per_lane, rows, ctas_per_sm, tile, stride) at k factors and
    G groups: S's copies in one tile where they fit 4 CTAs an SM (64
    registers a thread: csrc's __launch_bounds__), else the whole 227 KB
    of one CTA an SM, else tiles of what that holds."""
    lanes = 8 if k <= 8 else 16 if k <= 16 else 32
    per_lane = -(-k // lanes)
    rows = WARPS * (32 // lanes)
    columns = G * (k + 1)
    per_sm = 4
    stride = _stride(columns, lanes)
    tile = columns
    if rows * stride * 4 > _budget(per_sm):
        per_sm = 1
        most = _budget(1) // (4 * rows)
        if stride > most:
            stride = most - (most - lanes) % 32 if lanes < 32 else most
            tile = stride
    return lanes, per_lane, rows, per_sm, tile, stride


def most_ctas(k: int, G: int, sms: int) -> int:
    """The largest grid of any batch at k and G: the CTAs the SMs hold at
    once, up to MAX_CTAS."""
    return min(sms * _form(k, G)[3], MAX_CTAS)


@lru_cache(maxsize=256)
def lambda_plan(B: int, k: int, G: int, sms: int) -> LambdaPlan:
    """The launch of one lambda step on B rows, k factors and G groups, on
    a card of `sms` SMs (`_form` lays out S). The grid is the batch's rows
    over `rows` a pass, up to `most_ctas`; then as few CTAs as take those
    passes."""
    lanes, per_lane, rows, per_sm, tile, stride = _form(k, G)
    grid = max(1, min(-(-B // rows), most_ctas(k, G, sms)))
    passes = -(-B // (grid * rows))
    grid = -(-B // (passes * rows))
    return LambdaPlan(lanes, per_lane, rows, per_sm, grid, passes, tile, stride, G * (k + 1))


def groups_in_one_tile(k: int) -> int:
    """The most groups whose S one launch holds in a single tile (the
    widest shared-memory form) at k factors."""
    plan = lambda_plan(1, k, 1, 1)
    most = _budget(1) // (4 * plan.rows)
    G = most // (k + 1)
    while _stride(G * (k + 1), plan.lanes) > most:
        G -= 1
    return G


def scratch_floats(num_groups: int, k: int, sms: int) -> int:
    """Floats of sgda_lambda's scratch on a card of `sms` SMs: the tickets,
    then the partials of the largest grid (`most_ctas`) and of its runs
    of FAN."""
    most = most_ctas(k, num_groups, sms)
    return TICKET_FLOATS + (most + -(-most // FAN)) * num_groups * (k + 1)


def sgda_lambda_scratch(num_groups: int, k: int, device) -> torch.Tensor:
    """Zeroed scratch for `sgda_lambda` with `num_groups` groups and k
    factors on one stream (the tickets in its first TICKET_FLOATS, then
    the partials); every call leaves the tickets zero, so it is allocated
    once. On the CPU, where the plain version runs, it holds the tickets
    only."""
    device = torch.device(device)
    n = (scratch_floats(num_groups, k, _sms(device.index or 0)) if device.type == "cuda"
         else TICKET_FLOATS)
    return torch.zeros(n, dtype=torch.float32, device=device)


@lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    `scratch` (`sgda_lambda_scratch(G, k)`'s) may be passed in so that a
    call allocates nothing."""
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
    sms = _sms(P.device.index or 0)
    if scratch is None:
        scratch = sgda_lambda_scratch(G, d - 1, P.device)
    check(scratch, "scratch", torch.float32, (scratch_floats(G, d - 1, sms),))
    plan = lambda_plan(B, d - 1, G, sms)
    KERNEL.launch(
        ptr(P), ptr(Gc), ptr(ids), ptr(vals), ptr(y), ptr(row_mask), ptr(attr_group),
        ptr(reg_w), ptr(reg_v), ptr(w0), ptr(scratch), B, L, d, G, MODES[mode], int(task),
        int(use_linear), int(use_bias), float(lr), float(min_target), float(max_target),
        plan.grid, plan.passes, plan.tile, plan.stride,
    )
    return reg_w, reg_v

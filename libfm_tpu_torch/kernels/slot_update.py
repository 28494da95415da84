"""slot_update: the slot-scatter, in-place update of A = [e | Q] after one
block's draws. CUDA source: csrc/slot_update.cu.

Replaces the JAX engine's `upd_chunk` (libfm_tpu/learners/mcmc_vector.py,
K4b): the update of a block whose entries cover fewer than num_rows // 4
cases, and of every block with dense_update=False. It computes
dense_update's function over the block's slots instead of over every case.
The learners hand it the block's slots in case order (`case_order`, made
once a block), so that the kernel reads A's rows in address order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libfm_tpu_torch.kernels import Kernel, check, check_aligned, on_cuda, ptr

KERNEL = Kernel(
    "slot_update", "slot_update_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong],
)


def case_order(slot_case, slot_val, slot_feat):
    """A block's slots (numpy case, value and feature arrays) in case order:
    the update's own slot list, made once a block. A conflict-free block
    holds at most one slot per case, so the order changes no row's
    arithmetic; the statistics kernels keep their per-feature lists."""
    o = np.argsort(slot_case, kind="stable")
    return slot_case[o], slot_val[o], slot_feat[o]


def slot_update_plain(A, slot_case, slot_val, slot_feat, tab):
    """The plain PyTorch version; same contract as `slot_update`. It
    gathers the slots' rows, forms the new rows and writes them back with
    one indexed assignment: the cases are distinct, so every run gives the
    same bits."""
    k = A.shape[1] - 1
    c = slot_case.long()
    t = tab[slot_feat.long()]  # [E, k+2]
    x = slot_val
    rows = A[c]  # [E, k+1] (a copy)
    dpred = x * (t[:, 0] + (rows[:, 1:] * t[:, 1:1 + k]).sum(dim=1)) - (x * x) * t[:, 1 + k]
    rows[:, 0] += dpred
    rows[:, 1:] += x[:, None] * t[:, 1:1 + k]
    A[c] = rows
    return A


def slot_update(A, slot_case, slot_val, slot_feat, tab):
    """In place: for every slot s, with c = slot_case[s], x = slot_val[s]
    and t = tab[slot_feat[s]],
    A[c, 0] += x (t0 + A[c,1:] . t[1:k+1]) - x^2 t[k+1];
    A[c, 1:] += x t[1:k+1]. No two slots may share a case (the slots of
    one conflict-free block); any order is right, and case order
    (`case_order`) is the fast one. Returns A.

    A [nc, k+1] float32, contiguous, 16-byte aligned; slot_case int32 [E]
    (rows of A), slot_val float32 [E], slot_feat int32 [E] (rows of tab);
    tab [F+1, k+2] float32 as `update_table` lays it out: 16-byte aligned,
    contiguous rows whose stride is a multiple of 4 floats (the kernel
    copies a stage's rows of A and of tab in 16-byte pieces)."""
    if not on_cuda(A, slot_case, slot_val, slot_feat, tab):
        return slot_update_plain(A, slot_case, slot_val, slot_feat, tab)
    nc, d = A.shape
    E = slot_case.shape[0]
    check(A, "A", torch.float32)
    check(slot_case, "slot_case", torch.int32, (E,))
    check(slot_val, "slot_val", torch.float32, (E,))
    check(slot_feat, "slot_feat", torch.int32, (E,))
    if tab.dtype != torch.float32:
        raise TypeError(f"tab: dtype {tab.dtype}, expected {torch.float32}")
    if (tab.dim() != 2 or tab.shape[1] != d + 1 or tab.stride(1) != 1
            or tab.stride(0) < d + 1 or tab.stride(0) % 4):
        raise ValueError(f"tab: shape {tuple(tab.shape)}, strides {tab.stride()}; expected "
                         f"[F+1, {d + 1}] with contiguous rows whose stride is a multiple "
                         f"of 4 (update_table's)")
    check_aligned(A, "A")
    check_aligned(tab, "tab")
    if not 0 <= d - 1 <= 128:
        raise ValueError(f"k={d - 1}: the CUDA kernels take 0 <= k <= 128")
    if E:
        KERNEL.launch(ptr(A), ptr(slot_case), ptr(slot_val), ptr(slot_feat), ptr(tab), E,
                      tab.stride(0), d - 1, nc)
    return A

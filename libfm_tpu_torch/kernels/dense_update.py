"""dense_update: case-major, in-place update of A = [e | Q] after one
block's draws. CUDA source: csrc/dense_update.cu.

Replaces the JAX engine's `upd_dense` (libfm_tpu/learners/mcmc_vector.py).
"""

from __future__ import annotations

import ctypes

import torch

from libfm_tpu_torch.kernels import Kernel, check, check_aligned, on_cuda, ptr

KERNEL = Kernel(
    "dense_update", "dense_update_launch",
    [ctypes.c_void_p] * 4
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
)


def table_stride(width: int) -> int:
    """Floats between the rows of a `width`-wide update table: `width`
    rounded up to whole 16-byte pieces, so the kernel copies each row it
    gathers as one bulk copy."""
    return -(-width // 4) * 4


def update_table(theta_old: torch.Tensor, theta_new: torch.Tensor) -> torch.Tensor:
    """[F+1, k+2] table [dw | dv | s = v_old . dv] with a zero row F (the
    sentinel for cases outside the block), built from the PRE-draw theta.
    A view of a zeroed [F+1, table_stride(k+2)] buffer: its rows lie
    table_stride(k+2) floats apart."""
    F, d = theta_old.shape
    delta = theta_new - theta_old
    buf = theta_old.new_zeros(F + 1, table_stride(d + 1))
    buf[:F, :d] = delta
    buf[:F, d] = (theta_old[:, 1:] * delta[:, 1:]).sum(dim=1)
    return buf[:, :d + 1]


def dense_update_plain(A, col, val, tab):
    """The plain PyTorch version; same contract as `dense_update`."""
    k = A.shape[1] - 1
    F = tab.shape[0] - 1
    t = tab[col.long()]  # [nc, k+2]
    x = (col != F).to(A.dtype) if val is None else val
    Q = A[:, 1:]
    dpred = x * (t[:, 0] + (Q * t[:, 1:1 + k]).sum(dim=1)) - (x * x) * t[:, 1 + k]
    A[:, 0] += dpred
    A[:, 1:] += x[:, None] * t[:, 1:1 + k]
    return A


def dense_update(A, col, val, tab):
    """In place: for every case c, with t = tab[col[c]] and x = val[c]
    (val None: one-hot, x = 1 where col[c] != F),
    A[c, 0] += x (t0 + A[c,1:] . t[1:k+1]) - x^2 t[k+1];
    A[c, 1:] += x t[1:k+1]. Returns A.

    A [nc, k+1] float32, contiguous and 16-byte aligned (the kernel moves
    it by bulk copies); col int32 [nc] (F = no feature of the block);
    val float32 [nc] or None; tab [F+1, k+2] from `update_table` (on the
    card: 16-byte aligned, rows table_stride(k+2) floats apart)."""
    tensors = [A, col, tab] + ([val] if val is not None else [])
    if not on_cuda(*tensors):
        return dense_update_plain(A, col, val, tab)
    nc, d = A.shape
    check(A, "A", torch.float32)
    check_aligned(A, "A")
    check(col, "col", torch.int32, (nc,))
    if val is not None:
        check(val, "val", torch.float32, (nc,))
    if tab.dtype != torch.float32:
        raise TypeError(f"tab: dtype {tab.dtype}, expected {torch.float32}")
    if tab.dim() != 2 or tab.shape[1] != d + 1 or tab.stride() != (table_stride(d + 1), 1):
        raise ValueError(
            f"tab: shape {tuple(tab.shape)}, strides {tab.stride()}; expected "
            f"[F+1, {d + 1}] with rows {table_stride(d + 1)} floats apart (update_table)"
        )
    check_aligned(tab, "tab")
    if nc == 0:
        return A
    KERNEL.launch(
        ptr(A), ptr(col), ptr(val), ptr(tab), nc, tab.shape[0] - 1, d - 1,
    )
    return A

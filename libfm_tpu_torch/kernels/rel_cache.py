"""rel_cache: the relational (BS) engine's frozen per-block-row caches
(K9). CUDA source: csrc/rel_cache.cu.

Replaces `build_rel_caches` (libfm_tpu/learners/mcmc_rel_vector.py) and
its `moments`: per block row b of a relation, over the train cases joined
to b (a CSR list, `case_off`/`case_ids`), the sums of the per-case table
A = [e | Q]

    C[b] = [we0 | we2_0 | SQ0 (k) | SQe0 (k) | SQQ0 (T)]
    we0 = sum e, we2_0 = sum e^2, SQ0 = sum Q, SQe0 = sum Q e,
    SQQ0 = sum Q Q^T as its T = k(k+1)/2 upper triangle (np.triu_indices
    order, the packing of schur_draw's GG),

with the sentinel row nb = 0. JAX's slab layout of the same sums (a
layout for the TPU's gather cost) is not carried over: the sums are the
same, in another f32 order.

From k = 3 each CTA sums several block rows, each thread a 4 x 4 tile
of a row's Gram of u = [1 | e | Q] in registers, the rows' cases staged
by cp.async in a two-stage ring; every sum adds one product a case in
case order, so C is the same bits on every run. At k <= 2 (the exact BS
engine's k = 1: its per-row sums of e and q',
libfm_tpu/learners/mcmc_relational.py:540-547) a narrow form of the
kernel runs, one warp a block row; `rel_cache_cols` gives it e and q' as
two columns at any stride, so nothing is copied first.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, padded_width, ptr
from libfm_tpu_torch.kernels.case_stats import triu
from libfm_tpu_torch.ops.segment import sorted_index_add_

KERNEL = Kernel(
    "rel_cache", "rel_cache_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3,
)
_P, _L = ctypes.c_void_p, ctypes.c_longlong
#: the narrow form (k <= 2, columns at any stride), counted as rel_cache
NARROW = Kernel("rel_cache", "rel_cache_cols_launch",
                [_P, _L] * 3 + [ctypes.c_int] + [_P] * 3 + [ctypes.c_int], count_as=KERNEL)
#: the widest k the narrow form takes
NARROW_MAX_K = 2
#: cases a step of the plain version sums (bounds its [chunk, CW] rows)
_PLAIN_CHUNK = 1 << 15


def cache_width(k: int) -> int:
    return 2 + 2 * k + k * (k + 1) // 2


def case_lists(row_map, nb: int):
    """(case_off int64 [nb+1], case_ids int32 [nc]): the train cases joined
    to each block row, in case order (a stable sort of the join map)."""
    row_map = np.asarray(row_map)
    case_ids = np.argsort(row_map, kind="stable").astype(np.int32)
    case_off = np.zeros(nb + 1, np.int64)
    np.cumsum(np.bincount(row_map, minlength=nb), out=case_off[1:])
    return case_off, case_ids


def rel_cache_plain(A, case_off, case_ids):
    """The plain PyTorch version; same contract as `rel_cache` (in A's
    dtype)."""
    nb = case_off.shape[0] - 1
    k = A.shape[1] - 1
    iu0, iu1 = triu(k, A.device)
    rows = torch.repeat_interleave(torch.arange(nb, device=A.device),
                                   case_off[1:] - case_off[:-1],
                                   output_size=case_ids.shape[0])
    C = torch.zeros(nb + 1, cache_width(k), dtype=A.dtype, device=A.device)
    for c0 in range(0, case_ids.shape[0], _PLAIN_CHUNK):
        Ac = A[case_ids[c0:c0 + _PLAIN_CHUNK].long()]
        e, Q = Ac[:, :1], Ac[:, 1:]
        sorted_index_add_(C, rows[c0:c0 + _PLAIN_CHUNK],
                          torch.cat([e, e * e, Q, Q * e, Q[:, iu0] * Q[:, iu1]], dim=1))
    return C


def rel_cache_cols_plain(e, q, case_off, case_ids):
    """The plain PyTorch version of `rel_cache_cols`: `rel_cache_plain` on
    the stacked columns [e | q]."""
    return rel_cache_plain(torch.stack([e, q], dim=1), case_off, case_ids)


def rel_cache_reference(A, case_off, case_ids):
    """The plain version in float64, and beside it every entry's sum of
    magnitudes (the same sums over |A|). Returns (C, scale), float64."""
    return (rel_cache_plain(A.double(), case_off, case_ids),
            rel_cache_plain(A.abs().double(), case_off, case_ids))


def rel_cache(A, case_off, case_ids):
    """C [nb+1, cache_width(k)]: the frozen caches of every block row b
    over its cases case_ids[case_off[b]:case_off[b+1]] (int64 offsets,
    int32 case ids into A [nc, k+1] = [e | Q]); row nb is 0."""
    if not on_cuda(A, case_off, case_ids):
        return rel_cache_plain(A, case_off, case_ids)
    nb = case_off.shape[0] - 1
    k = A.shape[1] - 1
    check(A, "A", torch.float32)
    check(case_off, "case_off", torch.int64, (nb + 1,))
    check(case_ids, "case_ids", torch.int32)
    C = torch.empty(nb + 1, cache_width(k), dtype=torch.float32, device=A.device)
    if k <= NARROW_MAX_K:
        _narrow(A[:, 0], [A[:, 1 + i] for i in range(k)], case_off, case_ids, C)
    else:
        KERNEL.launch(ptr(A), ptr(case_off), ptr(case_ids), ptr(C), nb, k, padded_width(k))
    return C


def _narrow(e, qs, case_off, case_ids, C):
    """One launch of the narrow form over the columns e and qs (1-D
    float32, any stride) into C."""
    s = [(t.data_ptr(), t.stride(0)) for t in qs] + [(None, 0)] * (NARROW_MAX_K - len(qs))
    NARROW.launch(e.data_ptr(), e.stride(0), *s[0], *s[1], len(qs), ptr(case_off),
                  ptr(case_ids), ptr(C), case_off.shape[0] - 1)


def rel_cache_cols(e, q, case_off, case_ids):
    """`rel_cache` at k = 1 over the columns e and q (1-D float32 [nc], any
    stride: a column of A, or a tensor of its own), without stacking them:
    C [nb+1, 5] = [sum e | sum e^2 | sum q | sum q e | sum q^2] over each
    block row's cases; row nb is 0."""
    if not on_cuda(e, q, case_off, case_ids):
        return rel_cache_cols_plain(e, q, case_off, case_ids)
    nb = case_off.shape[0] - 1
    for t, name in ((e, "e"), (q, "q")):
        if t.dtype != torch.float32 or t.dim() != 1:
            raise TypeError(f"{name}: expected a 1-D float32 tensor, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if e.shape != q.shape:
        raise ValueError(f"e {tuple(e.shape)} and q {tuple(q.shape)} differ in length")
    check(case_off, "case_off", torch.int64, (nb + 1,))
    check(case_ids, "case_ids", torch.int32)
    C = torch.empty(nb + 1, cache_width(1), dtype=torch.float32, device=e.device)
    _narrow(e, [q], case_off, case_ids, C)
    return C

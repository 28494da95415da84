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
    KERNEL.launch(ptr(A), ptr(case_off), ptr(case_ids), ptr(C), nb, k, padded_width(k))
    return C

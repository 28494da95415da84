"""rel_stats, rel_resync and rel_deferred: the relational (BS) engine's
sweep over one relation (K10). CUDA source: csrc/rel_sweep.cu.

Replace, in libfm_tpu/learners/mcmc_rel_vector.py `sweep_relation`, the
per-block `block_step` (its `corrected` caches, `mom_chunk` moments and
the reconstruction of GG), `resync_chunk`, `resync_te` and the deferred
path's `_te_chunk`, and the deferred path's `_deferred_sums`. Its
`upd_chunk`, the draw's shift into SD (`rel_update_plain` here), runs
inside `schur_draw`'s relational form (kernels/schur_draw.py
`schur_draw_rel`).

During a sweep the per-case state moves only through per-block-row
quantities SD [nb+1, k+1] = [s | dQB]: case c joined to row b has
e(c) = e0(c) + s_b + dQB_b . Q0(c) and Q(c) = Q0(c) + dQB_b, so the
caches a feature needs follow in closed form from the frozen ones
(`rel_cache`'s C):

    SQ  = SQ0 + wnum dQB,   we = we0 + wnum s + SQ0 . dQB,
    SQe = SQe0 + s SQ0 + SQQ0 dQB + dQB we,
    SQQ = SQQ0 + dQB SQ0^T + SQ0 dQB^T + wnum dQB dQB^T.

A feature j's statistics over the expanded cases are the x-power sums of
those caches over its entries (b, x) — the valued moment row of
`case_stats` [x^2 SQQ | x^2 SQ | x^3 SQ | x SQe | x^2 wnum | x^3 wnum |
x^4 wnum | x we | x^2 we] — and GG follows by `gg_from_moments`.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, padded_width, ptr
from libfm_tpu_torch.kernels.case_stats import gg_from_moments, moment_width, triu
from libfm_tpu_torch.kernels.rel_cache import cache_width
from libfm_tpu_torch.kernels.slot_stats import gg_width
from libfm_tpu_torch.ops.segment import sorted_index_add_

STATS = Kernel(
    "rel_stats", "rel_stats_launch",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5,
)
RESYNC = Kernel(
    "rel_resync", "rel_resync_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3,
)
DEFERRED = Kernel(
    "rel_deferred", "rel_deferred_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3,
)


#: the most entries rel_stats stages at once (csrc: kMaxBatch, a warp each)
MAX_BATCH = 8
#: the bytes a batch of staged entries aims at (two batches are in flight)
BATCH_BYTES = 12 * 1024


def stats_slot(k: int) -> int:
    """Floats of shared memory one staged entry takes in rel_stats (csrc:
    stats_slot): its cache row and its SD row, each with room to keep
    its source's offset within 16 bytes."""
    return _round4(cache_width(k) + 3) + _round4(k + 4)


def stats_batch(k: int) -> int:
    """The entries of a feature rel_stats stages at once at k factors:
    as many as fit in BATCH_BYTES, 1 to MAX_BATCH."""
    return max(1, min(MAX_BATCH, BATCH_BYTES // (4 * stats_slot(k))))


def _round4(n: int) -> int:
    return (n + 3) & ~3


#: the bytes of A's rows one run of rel_resync stages, two runs in flight
#: (8.5 KB: 64 cases at k = 32, which beat runs of 32, 48, 96 and 124 in
#: write mode at bench_bs's shapes, studies/rel_resync_ab.py)
RUN_BYTES = 8704
#: the most cases of a run (csrc: kMaxRun, one map entry a thread)
MAX_RUN = 256


class ResyncPlan(NamedTuple):
    """rel_resync's launch at k factors: `run` consecutive cases a CTA
    stages at once (a multiple of 4, so that a run's span of A keeps A's
    offset within 16 bytes), and the dynamic shared memory of two
    buffers, each the run's rows (with room for that offset), its map
    entries and its e."""

    run: int
    smem_bytes: int


def resync_smem(run: int, k: int) -> int:
    """Bytes of rel_resync's two buffers at `run` cases a run (csrc:
    resync_buffer): each the run's rows with 3 floats of room, its map
    entries and its e."""
    return 2 * 4 * (_round4(run * (k + 1) + 3) + 2 * run)


def resync_plan(k: int) -> ResyncPlan:
    """The run is as many cases as RUN_BYTES of rows hold, in fours, 4 to
    MAX_RUN: 64 at bench_bs's k = 32."""
    if not 1 <= k <= 128:
        raise ValueError(f"k={k}: rel_resync takes 1 <= k <= 128")
    run = max(4, min(MAX_RUN, RUN_BYTES // (4 * (k + 1)) // 4 * 4))
    return ResyncPlan(run, resync_smem(run, k))


@lru_cache(maxsize=None)
def _sym(k: int, device):
    """[k*k] positions in the packed upper triangle of a symmetric k x k
    matrix's entries, on `device`."""
    iu0, iu1 = np.triu_indices(k)
    sym = np.zeros((k, k), np.int64)
    sym[iu0, iu1] = np.arange(len(iu0))
    sym[iu1, iu0] = sym[iu0, iu1]
    return torch.as_tensor(sym.reshape(-1), device=device)


def _unpack(Cp, k):
    """[E, k, k] symmetric matrices from packed upper triangles [E, T]."""
    return Cp[:, _sym(k, Cp.device)].reshape(-1, k, k)


def rel_moments(C, SD, wnum, entry_b, entry_x, k):
    """The moment row [E, moment_width(k, False)] of every entry (b, x)
    from the corrected caches of its block row."""
    iu0, iu1 = triu(k, C.device)
    eb = entry_b.long()
    x = entry_x.to(C.dtype)
    Cb = C[eb]
    we0, SQ0, SQe0, SQQ0 = Cb[:, 0], Cb[:, 2:2 + k], Cb[:, 2 + k:2 + 2 * k], Cb[:, 2 + 2 * k:]
    sd = SD[eb]
    s, dq = sd[:, 0], sd[:, 1:]
    wn = wnum[eb].to(C.dtype)
    SQ = SQ0 + wn[:, None] * dq
    we = we0 + wn * s + (SQ0 * dq).sum(-1)
    SQe = (SQe0 + s[:, None] * SQ0 + torch.einsum("efg,eg->ef", _unpack(SQQ0, k), dq)
           + dq * we[:, None])
    SQQ = (SQQ0 + dq[:, iu0] * SQ0[:, iu1] + SQ0[:, iu0] * dq[:, iu1]
           + wn[:, None] * (dq[:, iu0] * dq[:, iu1]))
    x2 = x * x
    x3 = x2 * x
    x4 = x2 * x2
    rows = torch.cat([x2[:, None] * SQQ, x2[:, None] * SQ, x3[:, None] * SQ,
                      x[:, None] * SQe, (x2 * wn)[:, None], (x3 * wn)[:, None],
                      (x4 * wn)[:, None], (x * we)[:, None], (x2 * we)[:, None]], dim=1)
    return rows


def rel_stats_plain(C, SD, wnum, feat_off, entry_b, entry_x, feat_id, P, *,
                    use_linear=True, GG=None):
    """The plain PyTorch version; same contract as `rel_stats` (in C's
    dtype)."""
    k = P.shape[1] - 1
    F = feat_id.shape[0]
    ef = torch.repeat_interleave(torch.arange(F, device=C.device),
                                 feat_off[1:] - feat_off[:-1], output_size=entry_b.shape[0])
    MOM = torch.zeros(F, moment_width(k, False), dtype=C.dtype, device=C.device)
    sorted_index_add_(MOM, ef, rel_moments(C, SD, wnum, entry_b, entry_x, k))
    return gg_from_moments(MOM, P[feat_id.long(), 1:].to(C.dtype), onehot=False,
                           use_linear=use_linear, GG=GG)


def rel_stats_reference(C, SD, wnum, feat_off, entry_b, entry_x, feat_id, P, *,
                        use_linear=True):
    """The plain version in float64, and beside it every GG entry's sum of
    magnitudes: the same sums and reconstruction over |C|, |SD|, |x| and
    -|v|, in which every term adds. Returns (GG, scale), float64."""
    args = (feat_off, entry_b)
    ref = rel_stats_plain(C.double(), SD.double(), wnum.double(), *args, entry_x,
                          feat_id, P.double(), use_linear=use_linear)
    P_mag = torch.cat([P[:, :1], -P[:, 1:].abs()], dim=1).double()
    scale = rel_stats_plain(C.abs().double(), SD.abs().double(), wnum.double(), *args,
                            entry_x.abs(), feat_id, P_mag, use_linear=use_linear)
    return ref, scale


def rel_stats(C, SD, wnum, feat_off, entry_b, entry_x, feat_id, P, *,
              use_linear=True, GG=None):
    """GG [F, T+2k+2]: the statistics row of every feature of one
    conflict-free block of a relation (`slot_stats`' layout), from the
    frozen caches C [nb+1, cache_width(k)], the sweep's SD [nb+1, k+1] =
    [s | dQB] and wnum float32 [nb+1] (train cases joined to each row).
    feat_off int64 [F+1] cuts entry_b int32 (block rows) / entry_x float32
    [E] into per-feature entry lists; feat_id int32 [F] are the features'
    global ids into P = [w | V] [n, k+1] (the PRE-draw V). GG may be
    passed to write into (its first F rows)."""
    tensors = [C, SD, wnum, feat_off, entry_b, entry_x, feat_id, P]
    if not on_cuda(*tensors):
        return rel_stats_plain(C, SD, wnum, feat_off, entry_b, entry_x, feat_id, P,
                               use_linear=use_linear, GG=GG)
    k = P.shape[1] - 1
    F = feat_id.shape[0]
    nb1 = C.shape[0]
    check(C, "C", torch.float32, (nb1, cache_width(k)))
    check(SD, "SD", torch.float32, (nb1, k + 1))
    check(wnum, "wnum", torch.float32, (nb1,))
    check(feat_off, "feat_off", torch.int64, (F + 1,))
    check(entry_b, "entry_b", torch.int32)
    check(entry_x, "entry_x", torch.float32, entry_b.shape)
    check(feat_id, "feat_id", torch.int32)
    check(P, "P", torch.float32)
    if GG is None:
        GG = torch.empty(F, gg_width(k), dtype=torch.float32, device=C.device)
    if GG.shape[0] < F or GG.shape[1] != gg_width(k) or not GG.is_contiguous():
        raise ValueError(f"GG: shape {tuple(GG.shape)} cannot hold {F} rows")
    STATS.launch(ptr(C), ptr(SD), ptr(wnum), ptr(feat_off), ptr(entry_b), ptr(entry_x),
                 ptr(feat_id), ptr(P), ptr(GG), F, k, padded_width(k), int(use_linear),
                 stats_batch(k))
    return GG[:F]


def rel_update_plain(SD, entry_b, entry_x, entry_f, theta_old, theta_new):
    """Add one block's draw to SD [nb+1, k+1] = [s | dQB], in place: for
    each entry (b, x) of feature f (block-local, entry_f int32), with
    (dw, dv) = theta_new[f] - theta_old[f] and v_old = theta_old[f, 1:],
    s_b += x (dw + dv . (dQB_b - x v_old)) and dQB_b += x dv (dQB_b as it
    was before this block). A conflict-free block's entries hold distinct
    block rows. Returns SD. The plain version of the update that
    `schur_draw_rel` runs after each draw."""
    eb = entry_b.long()
    ef = entry_f.long()
    x = entry_x
    dq = SD[eb, 1:]
    de = (theta_new - theta_old)[ef]
    vo = theta_old[ef, 1:]
    ds = x * (de[:, 0] + (de[:, 1:] * (dq - x[:, None] * vo)).sum(-1))
    SD.index_add_(0, eb, torch.cat([ds[:, None], x[:, None] * de[:, 1:]], dim=1))
    return SD


@lru_cache(maxsize=None)
def _tri_pairs(k: int, device) -> tuple:
    """(iu0, iu1, twice) of the packed upper triangle on `device`, made
    once: twice is 1.0 on the diagonal, 2.0 off it (float64)."""
    iu0, iu1 = triu(k, device)
    return iu0, iu1, torch.where(iu0 == iu1, 1.0, 2.0).to(torch.float64)


def rel_deferred_plain(C, SD, wnum):
    """The plain PyTorch version (float64 per block row, then the rows'
    sums); same contract as `rel_deferred`."""
    C, SD, wnum = C.double(), SD.double(), wnum.double()
    k = SD.shape[1] - 1
    iu0, iu1, twice = _tri_pairs(k, C.device)
    we0, we2_0 = C[:, 0], C[:, 1]
    SQ0, SQe0, SQQ0 = C[:, 2:2 + k], C[:, 2 + k:2 + 2 * k], C[:, 2 + 2 * k:]
    s, dq = SD[:, 0], SD[:, 1:]
    dqSQ = (dq * SQ0).sum(-1)
    sum_e = we0 + wnum * s + dqSQ
    dqSQQdq = (SQQ0 * twice * dq[:, iu0] * dq[:, iu1]).sum(-1)
    sum_e2 = (we2_0 + 2.0 * s * we0 + 2.0 * (dq * SQe0).sum(-1)
              + wnum * s * s + 2.0 * s * dqSQ + dqSQQdq)
    return sum_e.sum().float(), sum_e2.sum().float()


#: rel_deferred's scratch a device: (float64 partials, the ticket)
_deferred_scratch: dict = {}


def rel_deferred(C, SD, wnum):
    """Closed-form (sum e, sum e^2) over the train cases from one
    relation's frozen caches C [nb+1, cache_width(k)] and its accumulated
    SD [nb+1, k+1] = [s | dQB], wnum float32 [nb+1]: per block row b every
    case has e = e0 + s_b + dQB_b . Q0, so
      sum_b e   = we0 + wnum s + dQB . SQ0,
      sum_b e^2 = we2_0 + 2 s we0 + 2 dQB . SQe0 + wnum s^2
                  + 2 s (dQB . SQ0) + dQB^T SQQ0 dQB
    over every row, the pad row too (the JAX engine's `_deferred_sums`;
    exact for one relation). The terms cancel (the sum of e^2 is ~1e-3 of
    its terms' magnitude on small problems), so they are summed in
    float64; returns float32 0-dim tensors. On the card one launch, no
    host copy, the same bits every call."""
    if not on_cuda(C, SD, wnum):
        return rel_deferred_plain(C, SD, wnum)
    nb1, d = SD.shape
    k = d - 1
    check(C, "C", torch.float32, (nb1, cache_width(k)))
    check(SD, "SD", torch.float32, (nb1, d))
    check(wnum, "wnum", torch.float32, (nb1,))
    most = max(1, -(-nb1 // 8))  # csrc: a warp a row, 8 a CTA
    partial, ticket = _deferred_scratch.get(C.device, (None, None))
    if partial is None or partial.numel() < 2 * most:
        partial = torch.empty(2 * most, dtype=torch.float64, device=C.device)
        ticket = torch.zeros(1, dtype=torch.int32, device=C.device)
        _deferred_scratch[C.device] = partial, ticket
    out = torch.empty(2, dtype=torch.float32, device=C.device)
    DEFERRED.launch(ptr(C), ptr(SD), ptr(wnum), ptr(partial), ptr(ticket), ptr(out), nb1, k,
                    partial.numel() // 2)
    return out[0], out[1]


def rel_resync_plain(SD, row_map, A, read_only=False):
    """The plain PyTorch version; same contract as `rel_resync`."""
    sd = SD[row_map.long()]
    e = A[:, 0] + sd[:, 0] + (sd[:, 1:] * A[:, 1:]).sum(-1)
    if read_only:
        return e
    A[:, 1:] += sd[:, 1:]
    A[:, 0] = e
    return None


def rel_resync(SD, row_map, A, read_only=False):
    """Apply SD [nb+1, k+1] = [s | dQB] to the cases of A [nc, k+1] =
    [e | Q] through their block rows row_map int32 [nc]: e += s + dQB . Q
    (with the Q before the update), then Q += dQB, in place. With
    `read_only`, A is left as it is and e + s + dQB . Q [nc] is
    returned (the deferred path's test prediction from the frozen tail).
    On the card under `resync_plan(k)`."""
    if not on_cuda(SD, row_map, A):
        return rel_resync_plain(SD, row_map, A, read_only)
    nc, d = A.shape
    check(SD, "SD", torch.float32, (SD.shape[0], d))
    check(row_map, "row_map", torch.int32, (nc,))
    check(A, "A", torch.float32)
    out = torch.empty(nc, dtype=torch.float32, device=A.device) if read_only else None
    if nc:
        launch_resync(SD, row_map, A, out, resync_plan(d - 1))
    return out


def launch_resync(SD, row_map, A, out, plan: ResyncPlan) -> None:
    """One rel_resync launch under `plan` (out None: write mode), on
    tensors `rel_resync` has checked; studies and tests time and hold
    other runs through it."""
    RESYNC.launch(ptr(SD), ptr(row_map), ptr(A), ptr(out), A.shape[0], A.shape[1] - 1,
                  plan.run, plan.smem_bytes)

"""coord_draw and rel_coord_draw: the exact engines' per-coordinate
conjugate draws of one conflict-free block (K11). CUDA source:
csrc/coord_draw.cu.

Replace `_posterior_gaussian`, `draw_w_block` and `draw_v_block`
(libfm_tpu/learners/mcmc.py, the flat exact engine: `coord_draw`) and
`draw_w_rel_block` and `draw_v_rel_block`
(libfm_tpu/learners/mcmc_relational.py, the exact BS engine:
`rel_coord_draw`). One entry point draws every feature of one block;
its launches are counted under the two names.

A block is given as per-feature slot lists: feature j (global id
feat_id[j], group group[j]) has the slots feat_off[j] .. feat_off[j+1]
of slot_row (rows of the caches: train cases, or block rows) and
slot_val. The parameter column `theta`, the caches and the
hyperparameters are 1-D float32 tensors at any stride (columns of
P = [w | V], of A = [e | Q], of rel_cache's table, of v_lambda [G, k]),
updated in place. `rejected` int32 [F] gets one added where feature j's
draw was rejected; the caller sums it once an iteration.

On the card a launch follows a `DrawPlan`, made once a block from
feat_off (the learners keep it on the block as `blk.plan`; without one
the wrapper makes it): short features a warp each, medium ones a CTA
each, long ones cut into `Pieces`, whose rows a second launch updates.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from libfm_tpu_torch.kernels import Kernel, check, on_cuda, ptr
from libfm_tpu_torch.kernels.pieces import PIECE_LEN, Pieces
from libfm_tpu_torch.ops.segment import sorted_index_add_

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = ([_I] * 3 + [_P] * 6 + [_L] + [_P] * 2 + [_L] + [_P] * 2
             + [ctypes.c_float] + [_P] * 2 + [_L, _P, _L] + [_P] * 3 + [_L] + [_P] * 2
             + [_P] * 2 + [_I] * 4 + [_P] * 2)
KERNEL = Kernel("coord_draw", "coord_draw_launch", _ARGTYPES)
#: the same entry point in its relational (BS) modes, counted apart
REL_KERNEL = Kernel("rel_coord_draw", "coord_draw_launch", _ARGTYPES)
MODES = {"w": 0, "v": 1, "w_rel": 2, "v_rel": 3}
#: slots a thread of the kernel holds from the sum to the update
LANE_SLOTS = 8
#: warps a CTA of the kernel (a medium feature or a piece: a CTA; short
#: features: one a warp)
WARPS = 8
#: the most slots of a short feature: a warp's 32 lanes x LANE_SLOTS
SHORT_MAX = 32 * LANE_SLOTS
#: the scratch floats a long piece takes (its num, den; the feature's
#: first row also delta and the old theta)
SCRATCH_ROW = 4
assert PIECE_LEN <= 32 * WARPS * LANE_SLOTS  # a piece fits a CTA's registers


class DrawPlan:
    """The launch plan of one block's draws, made once a block on the host
    from its feat_off (int64 [F+1]). Features are sorted by slot count n
    into three classes:

    - long (n > piece_len): cut into `Pieces` of piece_len slots, one CTA
      each, first in the grid (`n_long` pieces, `pieces.order[:n_long]`);
      the last piece of a feature draws, and a second launch updates the
      pieces' rows: `launches` is 2 where the block has a long feature;
    - medium (short_max < n <= piece_len): a CTA each, then
    - short (n <= short_max, empty features too): a warp each, WARPS a
      CTA.

    `feats` int32 lists the medium features, then the short ones, each
    class by slot count, longest first (a CTA's warps finish together).
    short_max (<= SHORT_MAX) and piece_len (<= PIECE_LEN) are the
    kernel's; smaller values only move features to a longer class (the
    card checks hold every class in every mode so)."""

    def __init__(self, feat_off, device, short_max: int = SHORT_MAX,
                 piece_len: int = PIECE_LEN):
        if not 0 <= short_max <= SHORT_MAX:
            raise ValueError(f"short_max {short_max}: the kernel takes 0 to {SHORT_MAX}")
        if not 1 <= piece_len <= PIECE_LEN:
            raise ValueError(f"piece_len {piece_len}: the kernel takes 1 to {PIECE_LEN}")
        off = feat_off.cpu().numpy() if torch.is_tensor(feat_off) else np.asarray(feat_off)
        self.off = off.astype(np.int64)
        n = np.diff(self.off)
        self.F = len(n)
        self.short_max, self.piece_len = short_max, piece_len
        self.pieces = Pieces(self.off, device, piece_len)
        self.n_long = self.pieces.rows
        one = n <= piece_len
        by_len = np.argsort(-n, kind="stable")
        medium = by_len[one[by_len] & (n[by_len] > short_max)]
        short = by_len[one[by_len] & (n[by_len] <= short_max)]
        self.n_medium, self.n_short = len(medium), len(short)
        self.feats = torch.as_tensor(np.concatenate([medium, short]).astype(np.int32),
                                     device=device)
        self.launches = 2 if self.n_long else 1
        self.device = self.feats.device
        self._args = None
        self.ctas = self.n_long + self.n_medium + -(-self.n_short // WARPS)

    def scratch(self) -> torch.Tensor:
        return self.pieces.scratch(SCRATCH_ROW)

    def launch_args(self) -> tuple:
        """The plan's arguments of the kernel's entry point, made at the
        first launch (the scratch with them) and kept: a block's draws
        launch 1 + k times an iteration."""
        if self._args is None:
            self._args = (ptr(self.pieces.order), ptr(self.feats), self.n_long,
                          self.n_medium, self.n_short, self.piece_len, ptr(self.scratch()),
                          ptr(self.pieces.ticket))
        return self._args

    def classes(self) -> dict:
        """Features a class: {"short": .., "medium": .., "long": ..}."""
        return dict(short=self.n_short, medium=self.n_medium,
                    long=self.F - self.n_short - self.n_medium)

    def units(self) -> np.ndarray:
        """The first launch's work as the kernel reads the plan: int64 rows
        (class 0 short / 1 medium / 2 long piece, CTA, warp or -1 for a
        whole CTA, feature, first slot, end slot), in grid order; the
        second launch takes the long pieces' rows again, CTA for CTA."""
        out = []
        for b, (f, rank, _, _) in enumerate(self.pieces.order[:self.n_long].cpu().numpy()):
            s0 = self.off[f] + rank * self.piece_len
            out.append((2, b, -1, f, s0, min(self.off[f + 1], s0 + self.piece_len)))
        feats = self.feats.cpu().numpy()
        for i, f in enumerate(feats[:self.n_medium]):
            out.append((1, self.n_long + i, -1, f, self.off[f], self.off[f + 1]))
        for i, f in enumerate(feats[self.n_medium:]):
            out.append((0, self.n_long + self.n_medium + i // WARPS, i % WARPS, f,
                        self.off[f], self.off[f + 1]))
        return np.array(out, dtype=np.int64).reshape(-1, 6)


def posterior(num, den, theta, lam, mu, alpha, z, bound):
    """`_posterior_gaussian` with `finite_or`: (new theta, rejected as
    int32) per feature."""
    s2 = 1.0 / (lam + alpha * den)
    mean = -s2 * (alpha * (num - theta * den) - mu * lam)
    prop = mean + torch.sqrt(s2) * z if z is not None else mean
    prop = torch.where(torch.isfinite(s2), prop, torch.zeros_like(prop))
    ok = torch.isfinite(prop) & (prop.abs() <= bound)
    return torch.where(ok, prop, theta), (~ok).to(torch.int32)


def _slot_features(feat_off, E):
    F = feat_off.shape[0] - 1
    return torch.repeat_interleave(torch.arange(F, device=feat_off.device),
                                   feat_off[1:] - feat_off[:-1], output_size=E)


def _draw_plain(theta, feat_off, slot_val, feat_id, group, lam, mu, alpha, z, rejected,
                bound, terms):
    """The shared steps of the plain versions: the per-slot terms
    (num, den) summed per feature in slot order, the posterior, theta and
    the counters written. Returns (delta per slot, old theta per slot)."""
    F = feat_off.shape[0] - 1
    f = _slot_features(feat_off, slot_val.shape[0])
    fid = feat_id.long()
    th = theta[fid]
    th_s = th[f]
    t_num, t_den = terms(th_s)
    zero = torch.zeros(F, dtype=theta.dtype, device=theta.device)
    num = sorted_index_add_(zero.clone(), f, t_num)
    den = sorted_index_add_(zero.clone(), f, t_den)
    g = group.long()
    new, bad = posterior(num, den, th, lam[g], mu[g], alpha, z, bound)
    theta[fid] = new
    rejected += bad
    return (new - th)[f], th_s


def coord_draw_plain(theta, feat_off, slot_row, slot_val, feat_id, group, lam, mu, alpha,
                     z, rejected, *, bound, e, q=None, plan=None):
    """The plain PyTorch version; same contract as `coord_draw` (the plan,
    a launch layout, is not read)."""
    r = slot_row.long()
    x = slot_val.to(theta.dtype)
    e_r = e[r]
    q_r = None if q is None else q[r]

    def terms(th_s):
        if q is None:
            return x * e_r, x * x
        h = x * (q_r - x * th_s)
        return h * e_r, h * h

    d, th_s = _draw_plain(theta, feat_off, x, feat_id, group, lam, mu, alpha, z, rejected,
                          bound, terms)
    if q is None:
        e[r] = e_r + x * d
    else:
        h = x * (q_r - x * th_s)
        q[r] = q_r + x * d
        e[r] = e_r + h * d


def rel_coord_draw_plain(theta, feat_off, slot_row, slot_val, feat_id, group, lam, mu,
                         alpha, z, rejected, *, bound, we, wnum, yb, qb=None, weq=None,
                         wc=None, wc_sqr=None, plan=None):
    """The plain PyTorch version; same contract as `rel_coord_draw` (the
    plan is not read)."""
    b = slot_row.long()
    x = slot_val.to(theta.dtype)
    we_b, wn_b = we[b], wnum[b]
    if qb is not None:
        qb_b, weq_b, wc_b, wcs_b = qb[b], weq[b], wc[b], wc_sqr[b]

    def terms(th_s):
        if qb is None:
            return x * we_b, x * x * wn_b
        h = x * (qb_b - x * th_s)
        return (h * we_b + x * weq_b,
                h * h * wn_b + 2.0 * wc_b * x * h + x * x * wcs_b)

    d, th_s = _draw_plain(theta, feat_off, x, feat_id, group, lam, mu, alpha, z, rejected,
                          bound, terms)
    if qb is None:
        we[b] = we_b + x * d * wn_b
        yb[b] = yb[b] + x * d
    else:
        h = x * (qb_b - x * th_s)
        we[b] = we_b + d * (h * wn_b + x * wc_b)
        weq[b] = weq_b + d * (h * wc_b + x * wcs_b)
        qb[b] = qb_b + d * x
        yb[b] = yb[b] + d * h


def _vec(t, name):
    """(pointer, stride) of a 1-D float32 tensor at any stride; (None, 0)
    for None."""
    if t is None:
        return None, 0
    if t.dtype != torch.float32 or t.dim() != 1:
        raise TypeError(f"{name}: expected a 1-D float32 tensor, got {t.dtype} {tuple(t.shape)}")
    return t.data_ptr(), t.stride(0)


def _launch(kernel, mode, theta, feat_off, slot_row, slot_val, feat_id, group, lam, mu,
            alpha, z, rejected, bound, plan, e, q=None, weq=None, wc=None, wc_sqr=None,
            wnum=None, yb=None):
    F = feat_id.shape[0]
    if plan is None:
        plan = DrawPlan(feat_off, feat_off.device)
    if plan.F != F or plan.device != feat_off.device:
        raise ValueError(f"the plan is for {plan.F} features on {plan.device}, the block "
                         f"has {F} on {feat_off.device}")
    E = slot_row.shape[0]
    check(feat_off, "feat_off", torch.int64, (F + 1,))
    check(slot_row, "slot_row", torch.int32, (E,))
    check(slot_val, "slot_val", torch.float32, (E,))
    check(feat_id, "feat_id", torch.int32, (F,))
    check(group, "group", torch.int32, (F,))
    check(alpha, "alpha", torch.float32, ())
    check(rejected, "rejected", torch.int32, (F,))
    if z is not None:
        check(z, "z", torch.float32, (F,))
    (p_th, s_th), (p_lam, s_lam), (p_mu, s_mu) = (
        _vec(theta, "theta"), _vec(lam, "lam"), _vec(mu, "mu"))
    if s_lam != s_mu:
        raise ValueError(f"lam and mu must share a stride ({s_lam}, {s_mu})")
    (p_e, s_e), (p_q, s_q) = _vec(e, "e"), _vec(q, "q")
    (p_weq, s_weq), (p_wc, s_wc), (p_wcs, s_wcs) = (
        _vec(weq, "weq"), _vec(wc, "wc"), _vec(wc_sqr, "wc_sqr"))
    if len({s for s, p in ((s_weq, p_weq), (s_wc, p_wc), (s_wcs, p_wcs)) if p}) > 1:
        raise ValueError("weq, wc and wc_sqr must share a stride")
    for t, name in ((wnum, "wnum"), (yb, "yb")):
        if t is not None:
            check(t, name, torch.float32)
    args = (F, ptr(feat_off), ptr(slot_row), ptr(slot_val), ptr(feat_id), ptr(group), p_th,
            s_th, p_lam, p_mu, s_lam, ptr(alpha), ptr(z), float(bound), ptr(rejected), p_e,
            s_e, p_q, s_q, p_weq, p_wc, p_wcs, s_weq or s_wc or s_wcs, ptr(wnum), ptr(yb),
            *plan.launch_args())
    for phase in range(plan.launches):
        kernel.launch(MODES[mode], phase, *args)


def coord_draw(theta, feat_off, slot_row, slot_val, feat_id, group, lam, mu, alpha, z,
               rejected, *, bound, e, q=None, plan=None):
    """Draw every feature of one conflict-free block of the flat exact
    engine, in place: w mode (q None: theta is P's w column, e the
    residuals) or v mode (theta P's column 1+f, q the factor's linear
    cache, both beside e in A). Per feature j, over its slots (x, r):
    w: num = sum x e[r], den = sum x^2; v: h = x (q[r] - x theta_j),
    num = sum h e[r], den = sum h^2; then sigma^2 = 1/(lam + alpha den),
    mean = -sigma^2 (alpha (num - theta_j den) - mu lam) with lam, mu of
    the feature's group, the proposal mean + sqrt(sigma^2) z_j (z None:
    ALS, the mean), 0 where sigma^2 is not finite, the old theta kept
    (rejected[j] += 1) where the proposal is not finite or exceeds
    `bound`; then with delta = new - old: w: e[r] += x delta;
    v: q[r] += x delta, e[r] += h delta.

    feat_off int64 [F+1], slot_row int32 [E], slot_val float32 [E],
    feat_id int32 [F] (rows of theta), group int32 [F] (rows of lam and
    mu), alpha a 0-dim float32 tensor, z float32 [F] or None, rejected
    int32 [F]; theta, lam, mu, e, q 1-D float32 at any stride. No two slots
    of the block may share a row. `plan`: the block's DrawPlan (made here
    when None; the plain version reads none). One launch, two where the
    plan has a long feature."""
    tensors = [theta, feat_off, slot_row, slot_val, feat_id, group, lam, mu, alpha,
               rejected, e] + [t for t in (z, q) if t is not None]
    if not on_cuda(*tensors):
        return coord_draw_plain(theta, feat_off, slot_row, slot_val, feat_id, group, lam,
                                mu, alpha, z, rejected, bound=bound, e=e, q=q)
    _launch(KERNEL, "w" if q is None else "v", theta, feat_off, slot_row, slot_val, feat_id,
            group, lam, mu, alpha, z, rejected, bound, plan, e, q)


def rel_coord_draw(theta, feat_off, slot_row, slot_val, feat_id, group, lam, mu, alpha, z,
                   rejected, *, bound, we, wnum, yb, qb=None, weq=None, wc=None,
                   wc_sqr=None, plan=None):
    """Draw every feature of one conflict-free block of a relation (slots
    over block rows b), the exact BS engine's draws, in place: w mode
    (qb None): num = sum x we[b], den = sum x^2 wnum[b], then
    we[b] += x delta wnum[b], yb[b] += x delta; v mode (qb, weq, wc,
    wc_sqr given): h = x (qb[b] - x theta_j),
    num = sum h we[b] + x weq[b],
    den = sum h^2 wnum[b] + 2 wc[b] x h + x^2 wc_sqr[b], then
    we[b] += delta (h wnum[b] + x wc[b]), weq[b] += delta (h wc[b] +
    x wc_sqr[b]), qb[b] += delta x, yb[b] += delta h. The posterior, z,
    bound, the counters and the plan as `coord_draw`'s. wnum and yb
    contiguous float32 [nb+1]; we, weq, wc, wc_sqr (one stride) and qb 1-D
    float32 at any stride."""
    tensors = [theta, feat_off, slot_row, slot_val, feat_id, group, lam, mu, alpha,
               rejected, we, wnum, yb] + [t for t in (z, qb, weq, wc, wc_sqr) if t is not None]
    v = qb is not None
    if v and (weq is None or wc is None or wc_sqr is None):
        raise ValueError("the v mode needs qb, weq, wc and wc_sqr")
    if not on_cuda(*tensors):
        return rel_coord_draw_plain(theta, feat_off, slot_row, slot_val, feat_id, group, lam,
                                    mu, alpha, z, rejected, bound=bound, we=we, wnum=wnum,
                                    yb=yb, qb=qb, weq=weq, wc=wc, wc_sqr=wc_sqr)
    _launch(REL_KERNEL, "v_rel" if v else "w_rel", theta, feat_off, slot_row, slot_val,
            feat_id, group, lam, mu, alpha, z, rejected, bound, plan, we, qb, weq, wc, wc_sqr,
            wnum, yb)

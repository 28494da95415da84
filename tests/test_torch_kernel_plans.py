"""The host-side launch plans of the CUDA kernels, as pure functions on
the CPU (the kernels themselves run on the card: tests/test_torch_cuda.py).

- rel_stats (kernels/rel_sweep.py): the entries a CTA stages at once, by
  k: one to eight (a warp stages each), as many as BATCH_BYTES holds;
  each staged entry's slot holds its cache row and its SD row at every
  offset within 16 bytes a row may start at (the copies keep it), and two
  batches' shared memory stays under a CTA's 227 KB for every k in 1-128.
- sgda_lambda (kernels/sgda_lambda.py `lambda_plan`): the CTAs' rows
  cover the batch once, with no CTA left empty and the grid sized to the
  batch (configs #1's and #4b's shapes, and batches of 1 and 31 rows);
  the two levels of the cross-CTA sum hold the grid, and the scratch the
  largest grid the SMs hold at once (one wave);
  S's columns are covered by the tiles, the copies fit the CTAs an SM is
  planned for, the lane groups of a warp add into distinct banks;
  `groups_in_one_tile` is the widest one-tile form (one group more takes
  tiles), and G (1+k) far above the first kernel's 7,168 plans a launch.
- case_stats (kernels/case_stats.py `CaseStatsPlan`): the runs its teams
  sum cover every slot of every feature once (short features a team
  each, up to 256 / team to a CTA; long ones in pieces, a CTA each, its
  teams on consecutive parts), at config #4's Zipf shape and at features
  of 0 and 1 slots, for every k in 1-128; the CTA's shared memory one-hot
  and valued within 227 KB.
- slot_update's case-ordered list (`case_order`, and the lists the flat
  engine's scatter blocks and the BS engine's main blocks build with it):
  the same (case, value, feature) triples as the per-feature lists, the
  cases strictly ascending.
- sgda_step (kernels/sgda_step.py `regs_shared`): the regularizers in
  shared memory exactly where G (1+k) fits REG_FLOATS (configs #1's and
  #4b's shapes; 500 groups at k = 16 and 64 at k = 128 above it).
- rel_refresh (kernels/rel_refresh.py `refresh_plan`, `warp_bytes`): a
  CTA's shared memory within 227 KB for every k in 1-128, with as many
  warps as it holds, up to 8. (The kernel's own shared memory is held to
  `warp_bytes` on the card, tests/test_torch_cuda.py.)
- table_read (kernels/table_read.py `read_plan`): a CTA's slice plus its
  group's ids within 227 KB; the slices cover every column once and the
  id groups split [0, n_used) with none empty and no overlap; the widest
  slice that fits is taken, at each width's edge in nsub, and the l2
  form past the last or where the slices outnumber the SMs; W = 7, 128 and 130, no ids and more reps than
  rows. A float64 emulation of the kernel's sums under the plan (each
  group's ids mod nsub, one conditional subtraction a lookup, the carry)
  against the plain version.
- rel_resync (kernels/rel_sweep.py `resync_plan`): a run a multiple of 4
  cases, 4 to MAX_RUN, as many as RUN_BYTES of rows hold, for every k in
  1-128 (k = 0 and 129 refused); two buffers within 227 KB; the runs of
  a one-wave grid cover the cases once; a run's copy (4-byte pieces at
  its ends, 16-byte ones between, aligned in A and in shared memory)
  covers its span once at each offset of A within 16 bytes.
"""

import itertools

import numpy as np
import pytest

from libfm_tpu_torch.data.batching import FeatureBlock, feature_slots
from libfm_tpu_torch.kernels import case_stats as cs
from libfm_tpu_torch.kernels import rel_refresh as rr
from libfm_tpu_torch.kernels import rel_sweep as rs
from libfm_tpu_torch.kernels import sgda_lambda as sl
from libfm_tpu_torch.kernels import sgda_step as sa
from libfm_tpu_torch.kernels import table_read as tr
from libfm_tpu_torch.kernels.rel_cache import cache_width
from libfm_tpu_torch.kernels.slot_update import case_order
from libfm_tpu_torch.learners.mcmc_rel_vector import MainBlock
from libfm_tpu_torch.learners.mcmc_vector import DevBlock

SMEM_CTA = 232_448  # a CTA's shared memory on the H100, static and dynamic
SMEM_STATIC = 49_152  # a CTA's static shared memory at most
SMS = 132  # an H100 SXM's SMs


def _round4(n):
    return (n + 3) // 4 * 4


@pytest.mark.parametrize("k", [1, 8, 16, 24, 25, 32, 52, 64, 128])
def test_rel_stats_batch_fills_its_bytes(k):
    """The batch is the most entries BATCH_BYTES holds, 1 to MAX_BATCH;
    bench_bs's k = 32 stages 4 entries at once."""
    slot = rs.stats_slot(k)
    n = rs.stats_batch(k)
    assert 1 <= n <= rs.MAX_BATCH
    assert n == rs.MAX_BATCH or n == 1 or (n + 1) * slot * 4 > rs.BATCH_BYTES
    assert n == 1 or n * slot * 4 <= rs.BATCH_BYTES
    if k == 32:
        assert n == 4


def test_rel_stats_slot_holds_each_row_at_each_offset_for_every_k():
    """A staged entry: its cache row from the slot's start plus the row's
    offset within 16 bytes (0-3 floats), its SD row from the 16-byte
    boundary after it plus its own offset; both inside the slot, the
    slots 16-byte aligned; two batches (and the kernel's static arrays,
    at most 6 KB) within a CTA's shared memory, for every k in 1-128."""
    for k in range(1, 129):
        slot, cw, d = rs.stats_slot(k), cache_width(k), k + 1
        assert slot % 4 == 0
        sd_base = _round4(cw + 3)
        for mis in range(4):
            assert mis + cw <= sd_base
            assert sd_base + mis + d <= slot
        assert 2 * rs.stats_batch(k) * slot * 4 + 6 * 1024 <= SMEM_CTA


SGDA_SHAPES = {
    "config #1": (32768, 8, 2),
    "config #4b": (8192, 16, 13),
    "one row": (1, 8, 2),
    "31 rows": (31, 16, 13),
    "k=16, 500 groups": (8192, 16, 500),
    "k=128, 64 groups": (8192, 128, 64),
}


def _check_plan(p, B, k, G):
    # lanes
    assert p.lanes in (8, 16, 32) and p.lanes * p.per_lane >= k
    assert p.lanes * (p.per_lane - 1) < k
    assert p.rows == sl.WARPS * 32 // p.lanes
    # rows: CTA c takes [c passes rows, (c+1) passes rows), none empty
    assert 1 <= p.grid <= sl.MAX_CTAS and p.passes >= 1
    assert p.grid * p.passes * p.rows >= B
    assert (p.grid - 1) * p.passes * p.rows < B
    assert p.grid <= SMS * p.ctas_per_sm
    # the cross-CTA sum: runs of FAN, at most MAX_CTAS / FAN of them, and
    # their tickets in the scratch's first TICKET_FLOATS
    assert -(-p.grid // sl.FAN) <= sl.MAX_CTAS // sl.FAN < sl.TICKET_FLOATS
    # S's columns in tiles; the copies in shared memory
    assert p.columns == G * (k + 1)
    assert 1 <= p.tile <= p.stride and p.tiles * p.tile >= p.columns
    assert (p.tiles - 1) * p.tile < p.columns
    assert p.smem == p.rows * p.stride * 4 <= sl.SMEM_CTA
    assert p.ctas_per_sm * (p.smem + sl.SMEM_RESERVED + 256) <= sl.SMEM_SM
    if p.tiles == 1:
        assert p.tile == p.columns
    # a warp's lane groups: lane gl of group g adds at g stride + c + gl
    groups = 32 // p.lanes
    banks = {(g * p.stride + gl) % 32 for g in range(groups) for gl in range(p.lanes)}
    assert len(banks) == 32
    # the scratch: the tickets, then the partials of the largest grid at
    # (k, G) and of its runs; this grid's fit
    most = sl.most_ctas(k, G, SMS)
    assert p.grid <= most == min(SMS * p.ctas_per_sm, sl.MAX_CTAS)
    assert sl.scratch_floats(G, k, SMS) == (sl.TICKET_FLOATS
                                            + (most + -(-most // sl.FAN)) * p.columns)
    assert sl.TICKET_FLOATS + (p.grid + -(-p.grid // sl.FAN)) * p.columns <= (
        sl.scratch_floats(G, k, SMS))


@pytest.mark.parametrize("name", sorted(SGDA_SHAPES))
def test_sgda_lambda_plan_at_the_paths_shapes(name):
    B, k, G = SGDA_SHAPES[name]
    p = sl.lambda_plan(B, k, G, SMS)
    _check_plan(p, B, k, G)
    want = {"config #1": (512, 2, 1), "config #4b": (512, 1, 1), "one row": (1, 1, 1),
            "31 rows": (2, 1, 1), "k=16, 500 groups": (128, 4, 3),
            "k=128, 64 groups": (128, 8, 2)}[name]
    assert (p.grid, p.passes, p.tiles) == want


def test_sgda_lambda_plan_over_batches_widths_and_groups():
    """Every combination of B in 1-100,000, k in 1-128 and G in 1-5,000
    plans a launch that holds _check_plan's invariants."""
    for B, k, G in itertools.product([1, 2, 31, 33, 1000, 8192, 32768, 100_000],
                                     [1, 5, 8, 9, 16, 17, 32, 33, 64, 65, 128],
                                     [1, 2, 13, 56, 57, 211, 500, 2000, 5000]):
        _check_plan(sl.lambda_plan(B, k, G, SMS), B, k, G)


@pytest.mark.parametrize("k,G,most", [(8, 2, 512), (16, 13, 512), (16, 500, 132),
                                      (64, 50_000, 132), (128, 64, 132)])
def test_sgda_lambda_scratch_holds_the_grid_the_sms_hold(k, G, most):
    """The partials are as many as one wave's CTAs: 4 an SM (up to
    MAX_CTAS) while S's copies fit that, else one an SM; at k = 64 and
    50,000 groups about 1.8 GB, not MAX_CTAS' 6.9 GB."""
    assert sl.most_ctas(k, G, SMS) == most
    nbytes = 4 * sl.scratch_floats(G, k, SMS)
    assert nbytes == 4 * (sl.TICKET_FLOATS + (most + -(-most // sl.FAN)) * G * (k + 1))
    if G == 50_000:
        assert nbytes < 2e9


@pytest.mark.parametrize("k", [1, 5, 8, 9, 16, 17, 32, 64, 65, 128])
def test_groups_in_one_tile_is_the_widest_one_tile_form(k):
    G = sl.groups_in_one_tile(k)
    assert sl.lambda_plan(1000, k, G, SMS).tiles == 1
    wider = sl.lambda_plan(1000, k, G + 1, SMS)
    assert wider.tiles == 2 and wider.ctas_per_sm == 1
    if k == 128:  # the first kernel took 55 groups at k = 128
        assert G >= 55


# ---------------------------------------------------------------- case_stats

def _zipf_counts(rng, slots, features, power=1.2):
    """A CTR field's slot counts: `slots` cases over `features` values by
    Zipf ranks (ctr_like's form), most of them in the head."""
    ranks = (rng.zipf(power, slots) - 1) % features
    return np.bincount(ranks, minlength=features)


def _check_case_plan(counts, k):
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    plan = cs.CaseStatsPlan(off, k, "cpu")
    cta = plan.cta.numpy()
    assert plan.count == len(cta) and plan.team == (32 if k <= 32 else 256)
    # short CTAs: up to `teams` features each, the longest first
    short = [(-1 - a, n) for a, n, _, _ in cta if a < 0]
    assert all(1 <= n <= plan.teams for _, n in short)
    longs = cta[cta[:, 0] >= 0]
    assert (longs[:, 0] == cta[:len(longs), 0]).all()  # long pieces first
    per_long = np.bincount(longs[:, 0], minlength=len(counts))
    assert (np.diff(longs[:, 3]) <= 0).all()  # features of many pieces first
    for f in np.flatnonzero(per_long):
        mine = longs[longs[:, 0] == f]
        assert counts[f] > plan.short_len
        assert sorted(mine[:, 1].tolist()) == list(range(per_long[f]))
        assert (mine[:, 3] == per_long[f]).all()
        assert per_long[f] == -(-counts[f] // plan.piece_len)
    # scratch rows: a feature of several pieces takes one a piece, disjoint
    bases = {int(f): int(b) for f, _, b, n in longs if n > 1}
    spans = sorted((b, b + per_long[f]) for f, b in bases.items())
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert plan.rows == sum(per_long[f] for f in bases) and (not spans
                                                              or spans[-1][1] <= plan.rows)
    # every slot once
    runs = plan.team_runs(off)
    cover = np.zeros(off[-1], dtype=np.int64)
    for f, lo, hi in runs:
        assert off[f] <= lo <= hi <= off[f + 1]
        cover[lo:hi] += 1
    assert (cover == 1).all()
    seen = np.bincount(runs[:, 0], minlength=len(counts))
    assert (seen > 0).all()  # every feature, a GG row even with no slot
    shorts = plan.short.numpy()[:sum(n for _, n in short)]
    assert sorted(shorts.tolist() + np.flatnonzero(per_long).tolist()) == list(
        range(len(counts)))
    assert (np.diff(counts[shorts]) <= 0).all()
    for onehot in (True, False):
        assert cs.smem_bytes(k, onehot) <= SMEM_CTA
    return plan


def test_case_stats_plan_at_config4s_zipf_shape():
    """A block of config #4: 1.8M cases over 5,000 features, k = 16; the
    head feature in pieces of 4,096 slots, the Zipf tail in short CTAs of
    8 warps."""
    counts = _zipf_counts(np.random.default_rng(1), 1_800_000, 5000)
    plan = _check_case_plan(counts, 16)
    assert counts.max() > 300_000 and plan.teams == 8 and plan.piece_len == 4096
    cta = plan.cta.numpy()
    assert (cta[:, 0] >= 0).sum() >= counts.max() // 4096


@pytest.mark.parametrize("k", range(1, 129))
def test_case_stats_plan_every_k(k):
    """Features of 0 and 1 slots, short ones, one just past the short
    length, a few pieces long and one of exactly two pieces, a Zipf tail."""
    rng = np.random.default_rng(k)
    short_len = cs.SHORT_LEN if k <= 32 else cs.PIECE_SLOTS[False]
    piece = cs.PIECE_SLOTS[k <= 32]
    counts = np.concatenate([[0, 1, 0, 1, short_len, short_len + 1, 2 * piece,
                              3 * piece + 7], _zipf_counts(rng, 20_000, 300),
                             rng.integers(0, 3, 40)])
    _check_case_plan(rng.permutation(counts), k)


# ---------------------------------------------------------------- slot_update

def _block(rng, nc, F, coverage):
    cases = rng.choice(nc, int(coverage * nc), replace=False).astype(np.int32)
    feat = rng.integers(0, F, cases.size).astype(np.int32)
    vals = rng.normal(1.0, 0.5, cases.size).astype(np.float32)
    return FeatureBlock(np.arange(F, dtype=np.int32) * 3, cases, vals, feat)


@pytest.mark.parametrize("coverage", [0.05, 1.0])
def test_case_order_holds_the_same_slots(coverage):
    rng = np.random.default_rng(int(coverage * 100))
    blk = _block(rng, 5000, 120, coverage)
    off, sc, sv = feature_slots(blk)
    sf = np.repeat(np.arange(len(off) - 1, dtype=np.int32), np.diff(off))
    want = sorted(zip(sc.tolist(), sv.tolist(), sf.tolist()))
    c, v, f = case_order(sc, sv, sf)
    assert c.dtype == np.int32 and v.dtype == np.float32 and f.dtype == np.int32
    flat = DevBlock(blk, np.zeros(len(off) - 1, np.int32), 5000, "cpu", 4, False,
                    dense_update=False)
    main = MainBlock(blk, np.zeros(len(off) - 1, np.int32), "cpu")
    assert flat.scatter_update
    for c, v, f in ((c, v, f), (flat.upd_case, flat.upd_val, flat.upd_feat),
                    (main.upd_case, main.upd_val, main.upd_feat)):
        c, v, f = (np.asarray(a) for a in (c, v, f))
        assert (np.diff(c) > 0).all()
        assert list(zip(c.tolist(), v.tolist(), f.tolist())) == want


# ---------------------------------------------------------------- sgda_step

@pytest.mark.parametrize("name", sorted(SGDA_SHAPES))
def test_sgda_step_regularizers_at_the_paths_shapes(name):
    """The regularizers in shared memory at configs #1 and #4b (18 and 221
    floats), at one row and 31; read from global memory above the budget:
    500 groups at k = 16 (8,500 floats) and 64 at k = 128 (8,256). Their
    shared copy fits a CTA's static shared memory beside the rest."""
    B, k, G = SGDA_SHAPES[name]
    shared = sa.regs_shared(G, k)
    assert shared == (name not in ("k=16, 500 groups", "k=128, 64 groups"))
    assert shared == (G * (k + 1) <= sa.REG_FLOATS)
    assert 4 * sa.REG_FLOATS <= SMEM_STATIC // 2


def test_sgda_step_regularizers_over_widths_and_groups():
    """Every k in 1-128: shared up to the most groups whose G (1+k) floats
    fit REG_FLOATS, global from one group more."""
    for k in range(1, 129):
        most = sa.REG_FLOATS // (k + 1)
        assert sa.regs_shared(1, k) and sa.regs_shared(most, k)
        assert not sa.regs_shared(most + 1, k) and not sa.regs_shared(5000, k)


# ---------------------------------------------------------------- rel_refresh

@pytest.mark.parametrize("k", range(1, 129))
def test_rel_refresh_plan_shared_memory_every_k(k):
    """A CTA's stages and tiles within 227 KB (its dynamic part within
    SMEM_DYNAMIC, the static part of 8 floats beside it), as many warps
    as fit up to MAX_WARPS, each warp's region a whole number of 16-byte
    pieces; main rows staged up to STAGE_L entries; the tile 32 (k+1)
    floats and 4 for A's offset."""
    for R, L, has_A in itertools.product([1, 2, 3], [0, 1, 2, 13, 16, 17, 100],
                                         [True, False]):
        warps, per = rr.refresh_plan(k, R, L, has_A), rr.warp_bytes(k, R, L, has_A)
        staged = 0 < L <= rr.STAGE_L
        assert per % 16 == 0
        tile = per - rr.warp_bytes(k, R, L, False)
        assert tile == (4 * (rr.TILE * (k + 1) + 4) if has_A else 0)
        assert per - tile >= 8 * rr.TILE * (R + 2 + (2 * L if staged else 0))
        assert 1 <= warps <= rr.MAX_WARPS
        assert warps * per <= rr.SMEM_DYNAMIC and warps * per + 4 * rr.MAX_WARPS <= SMEM_CTA
        assert warps == rr.MAX_WARPS or (warps + 1) * per > rr.SMEM_DYNAMIC
    if k == 32:  # bench_bs_ctx's train refresh: 8 warps, 4.2 KB of tile a warp
        assert rr.refresh_plan(32, 1, 2, True) == 8
        assert 8 * rr.warp_bytes(32, 1, 2, True) == 48_256
    if k == 128:  # 16.5 KB of tile a warp
        assert rr.warp_bytes(128, 1, 2, True) - rr.warp_bytes(128, 1, 2, False) == 16_528


# ---------------------------------------------------------------- table_read

READ_WIDTHS = [7, 128, 130]


def _read_plan_holds(plan, nsub, W, n_used):
    """What every plan must hold: its shared memory, the columns and the
    ids each covered once."""
    assert plan.smem_bytes == tr.smem_bytes(plan.form, nsub, plan.cols, plan.per_group)
    assert plan.smem_bytes <= SMEM_CTA
    cols = [c for s in range(plan.slices) for c in range(s * plan.cols, (s + 1) * plan.cols)
            if c < W]
    assert cols == list(range(W)) and (plan.slices - 1) * plan.cols < W
    assert plan.per_group % 4 == 0 and 1 <= plan.groups <= 65535
    spans = [(g * plan.per_group, min((g + 1) * plan.per_group, n_used))
             for g in range(plan.groups)]
    if n_used == 0:
        assert (plan.groups, plan.per_group) == (1, 0)
    else:
        assert spans[0][0] == 0 and spans[-1][1] == n_used
        assert all(lo < hi for lo, hi in spans)  # none empty
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))  # no gap, no overlap
    assert 1 <= plan.rep_split <= min(plan.shape[3], 65_535)
    if plan.form == "l2":
        assert plan.cols == tr.L2_COLS and plan.per_group <= tr.L2_IDS
    else:
        assert plan.rep_split == 1
        assert plan.cols in tr.SLICE_WIDTHS and (plan.cols <= W or plan.cols == 1)
        assert plan.slices * plan.groups <= SMS  # one wave, one CTA an SM


def _edge(cols, per):
    """The most rows a `cols`-column slice holds beside `per` ids."""
    nsub = 1
    while tr.smem_bytes("shared", 2 * nsub, cols, per) <= SMEM_CTA:
        nsub *= 2
    lo, hi = nsub, 2 * nsub  # fits at lo, not at hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if tr.smem_bytes("shared", mid, cols, per) <= SMEM_CTA else (lo, mid)
    return lo


def test_read_plan_at_the_probes_shape():
    """P1 / P3: 4-column slices, 32 slices x 4 groups of 4,096 ids."""
    plan = tr.read_plan(10_256, 128, 16_384, 20)
    assert (plan.form, plan.cols, plan.slices, plan.groups, plan.per_group) == (
        "shared", 4, 32, 4, 4096)
    assert plan.smem_bytes == 16 + 8192 + 10_256 * 16 + 2 * 4096 * 4
    _read_plan_holds(plan, 10_256, 128, 16_384)


@pytest.mark.parametrize("W", READ_WIDTHS)
@pytest.mark.parametrize("n_used", [0, 1, 4992, 16_384, 1_000_003])
@pytest.mark.parametrize("nsub", [1, 37, 1000, 10_256, 40_000, 60_000, 200_000])
def test_read_plan_covers_and_fits(W, n_used, nsub):
    plan = tr.read_plan(nsub, W, n_used, 20)
    _read_plan_holds(plan, nsub, W, n_used)
    if plan.form == "shared":  # no wider slice fits
        assert plan == tr.shared_plan(nsub, W, n_used, 20, plan.cols)
        wider = [c for c in tr.SLICE_WIDTHS if c > plan.cols and c <= W]
        for c in wider:
            assert tr.shared_plan(nsub, W, n_used, 20, c) is None
    if nsub > _edge(1, 0):  # past any one-column slice: the l2 form
        assert plan.form == "l2"
        assert all(tr.shared_plan(nsub, W, n_used, 20, c) is None for c in tr.SLICE_WIDTHS)


@pytest.mark.parametrize("W", READ_WIDTHS)
@pytest.mark.parametrize("n_used", [0, 16_384])
def test_read_plan_at_each_widths_edge(W, n_used):
    """At the most rows a width's slice holds beside its group's ids the
    plan takes that width; one row more, a narrower one, and past the
    one-column edge the l2 form."""
    for cols in tr.SLICE_WIDTHS:
        per = tr.shared_plan(1, W, n_used, 3, cols).per_group
        edge = _edge(cols, per)
        at, past = tr.read_plan(edge, W, n_used, 3), tr.read_plan(edge + 1, W, n_used, 3)
        _read_plan_holds(at, edge, W, n_used)
        _read_plan_holds(past, edge + 1, W, n_used)
        assert (at.form, at.cols) == ("shared", cols)
        assert past.form == "l2" if cols == 1 else past.cols < cols


def test_read_plan_l2_form_on_request_and_narrow_tables():
    """`l2_plan` gives the l2 form at any shape; a table of 1 or 3 columns
    takes no slice wider than itself."""
    plan = tr.l2_plan(10_256, 128, 16_384, 20)
    assert (plan.form, plan.slices, plan.groups, plan.per_group, plan.rep_split) == (
        "l2", 1, 16, 1024, 20)
    _read_plan_holds(plan, 10_256, 128, 16_384)
    assert tr.read_plan(5, 1, 100, 3).cols == 1 and tr.read_plan(5, 3, 100, 3).cols == 2


@pytest.mark.parametrize("nsub,W,form,cols", [
    (1000, 528, "shared", 4), (1000, 529, "l2", 128), (1000, 600, "l2", 128),
    (20_000, 264, "shared", 2), (20_000, 265, "l2", 128),
    (40_000, 132, "shared", 1), (40_000, 133, "l2", 128)])
def test_read_plan_keeps_the_shared_grid_in_one_wave(nsub, W, form, cols):
    """The shared form's grid is one cooperative wave of one CTA an SM: a
    table with more slices than SMs at every width that fits takes the
    l2 form."""
    plan = tr.read_plan(nsub, W, 4992, 5)
    _read_plan_holds(plan, nsub, W, 4992)
    assert (plan.form, plan.cols) == (form, cols)
    if form == "shared":
        assert plan.slices == SMS and plan.groups == 1


def _emulate(plan, T, ids, reps, scale):
    """The kernel's sums under `plan`, in float64: each CTA's slice and
    id group, a lookup's row id mod nsub + r mod nsub less nsub once."""
    nsub, W = T.shape
    n_used = plan.shape[2]
    acc = np.zeros(W)
    for r in range(reps):
        S = np.zeros(W)
        for g in range(plan.groups):
            sids = ids[g * plan.per_group:min((g + 1) * plan.per_group, n_used)] % nsub
            rows = sids + r % nsub
            rows = np.where(rows >= nsub, rows - nsub, rows)
            assert (rows >= 0).all() and (rows < nsub).all()
            for s in range(plan.slices):
                cols = slice(s * plan.cols, min((s + 1) * plan.cols, W))
                S[cols] += T[rows, cols].sum(axis=0)
        acc = scale * acc + S
    return acc


@pytest.mark.parametrize("W", READ_WIDTHS)
@pytest.mark.parametrize("nsub,n_used,reps,scale", [
    (1000, 4992, 5, 8.0), (37, 1000, 100, 1.0), (1000, 0, 3, 1.0), (60_000, 5000, 2, 1.0)])
def test_read_plan_emulated_against_plain(W, nsub, n_used, reps, scale):
    """More reps than rows (37 rows, 100 reps), no ids, the l2 form
    (60,000 rows), ids at and above nsub (reduced once, when staged)."""
    import torch

    rng = np.random.default_rng(W + nsub + reps)
    T = rng.standard_normal((nsub, W))
    ids = rng.integers(0, 3 * nsub, n_used + 7).astype(np.int32)
    plan = tr.read_plan(nsub, W, n_used, reps)
    assert plan.form == ("l2" if nsub == 60_000 else "shared")
    want = tr.table_read_plain(torch.as_tensor(T), torch.as_tensor(ids), reps, scale, n_used)
    np.testing.assert_allclose(_emulate(plan, T, ids, reps, scale), want.numpy(), rtol=1e-12,
                               atol=1e-9)


# ---------------------------------------------------------------- rel_resync


@pytest.mark.parametrize("k", range(1, 129))
def test_resync_plan_every_k(k):
    """A run of 4n cases, 4 to MAX_RUN, the most RUN_BYTES of rows hold;
    each buffer holds the span at any offset of A within 16 bytes, the
    map entries and e; two within a CTA's shared memory (and within the
    48 KB a launch takes without asking)."""
    plan, d = rs.resync_plan(k), k + 1
    run = plan.run
    assert run % 4 == 0 and 4 <= run <= rs.MAX_RUN and run * d * 4 % 16 == 0
    assert run * d * 4 <= rs.RUN_BYTES
    assert run == rs.MAX_RUN or (run + 4) * d * 4 > rs.RUN_BYTES
    span = _round4(run * d + 3)
    assert all(mis + run * d <= span for mis in range(4))
    assert plan.smem_bytes == rs.resync_smem(run, k) == 2 * 4 * (span + 2 * run)
    assert plan.smem_bytes <= min(SMEM_CTA, SMEM_STATIC)
    if k == 32:  # bench_bs: 64 cases, 8,448 bytes of rows a run
        assert run == 64 and plan.smem_bytes == 2 * 4 * (2116 + 128)


@pytest.mark.parametrize("k", [0, 129])
def test_resync_plan_refuses_k_outside_1_to_128(k):
    with pytest.raises(ValueError, match="1 <= k <= 128"):
        rs.resync_plan(k)


@pytest.mark.parametrize("nc", [1, 3, 123, 124, 125, 100_000, 1_000_000])
@pytest.mark.parametrize("grid", [1, 7, 792])
def test_resync_runs_cover_the_cases_once(nc, grid):
    """The kernel's loop (CTA b takes runs b, b + grid, ...; a run the
    cases [r run, min((r + 1) run, nc))): every case once, every run
    non-empty and starting on a multiple of 4 cases."""
    run = rs.resync_plan(32).run
    nruns = -(-nc // run)
    seen = np.zeros(nc, np.int64)
    for b in range(min(grid, nruns)):
        for r in range(b, nruns, grid):
            c0, c1 = r * run, min((r + 1) * run, nc)
            assert c0 < c1 and c0 % 4 == 0
            seen[c0:c1] += 1
    assert (seen == 1).all()


def _copy_pieces(mis, nf):
    """The pieces a run's copy moves (csrc: rel_resync_kernel's `issue`
    and its store), as (first float, floats): A's span starts `mis`
    floats past a 16-byte boundary, and so does its copy."""
    head = min((4 - mis) & 3, nf)
    nbody = (nf - head) >> 2
    tail = head + 4 * nbody
    return ([(j, 1) for j in range(head)] + [(head + 4 * c, 4) for c in range(nbody)]
            + [(tail + j, 1) for j in range(nf - tail)])


@pytest.mark.parametrize("k", [1, 16, 32, 33, 128])
def test_resync_copy_covers_each_span_once(k):
    """At each offset of A within 16 bytes and for every run length up to
    the plan's: the pieces cover the span once, each 16-byte piece aligned
    in A and in shared memory, all within the buffer's span area."""
    plan, d = rs.resync_plan(k), k + 1
    span = _round4(plan.run * d + 3)
    for mis in range(4):
        for n in range(1, plan.run + 1):
            covered = np.zeros(n * d, np.int64)
            for at, size in _copy_pieces(mis, n * d):
                covered[at:at + size] += 1
                if size == 4:
                    assert (mis + at) % 4 == 0
                assert mis + at + size <= span
            assert (covered == 1).all()

"""The host-side launch plans of two CUDA kernels, as pure functions on
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
"""

import itertools

import pytest

from libfm_tpu_torch.kernels import rel_sweep as rs
from libfm_tpu_torch.kernels import sgda_lambda as sl
from libfm_tpu_torch.kernels.rel_cache import cache_width

SMEM_CTA = 232_448  # a CTA's shared memory on the H100, static and dynamic
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

"""The launch plan of the exact engines' draws (`DrawPlan`,
kernels/coord_draw.py) and the narrow form of `rel_cache`
(`rel_cache_cols`), on the CPU.

- The plan, over blocks with empty features, a single feature, a
  synthetic Zipf head of 322,428 slots (config #4's largest) beside a
  tail of 5,000 features, features at each class's edges and a real
  conflict-free block of ctr data; each at the kernel's thresholds and at
  forced ones (every feature medium or cut into pieces of 64, as the card
  checks hold every class in every mode): every slot in exactly one
  warp, CTA or piece; a long feature's pieces contiguous in the grid and
  in rank order; the classes following the thresholds, each sorted
  longest first; the scratch rows one a long piece, each piece its own.
- rel_cache_cols' plain version equal bit for bit to rel_cache_plain on
  the stacked columns, from strided and contiguous columns; within 1e-6
  of each entry's sum of magnitudes of JAX's seg_sum sums of the exact BS
  engine's factor body (libfm_tpu/learners/mcmc_relational.py:544-547).
- The flat and the BS exact engines hand every block draw its block's
  plan (the trajectories against JAX, with the plans handed over, are
  tests/test_torch_exact.py's and test_torch_exact_relational.py's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfm_tpu.ops.segment import seg_sum as jax_seg_sum
from libfm_tpu_torch.data.batching import conflict_free_blocks, feature_slots
from libfm_tpu_torch.data.synth import ctr_like, movielens_like
from libfm_tpu_torch.kernels import coord_draw as cd
from libfm_tpu_torch.kernels.pieces import PIECE_LEN
from libfm_tpu_torch.kernels.rel_cache import (
    case_lists,
    rel_cache_cols,
    rel_cache_cols_plain,
    rel_cache_plain,
)
from libfm_tpu_torch.learners import mcmc as tmcmc
from libfm_tpu_torch.learners import mcmc_relational as trel
from libfm_tpu_torch.learners.mcmc import ALSLearner
from libfm_tpu_torch.models.fm import FMConfig

from test_mcmc_rel_vector import _single_rel_problem
from test_torch_relation import to_port

HEAD = 322_428  # config #4's longest feature (PERF.md §4)


def _zipf_head():
    tail = np.maximum(1, (HEAD * np.arange(2, 5002) ** -1.2).astype(np.int64))
    return np.concatenate([[HEAD], tail])


def _ctr_block():
    train, _, _ = ctr_like(3, 200, 30000, seed=5)
    off, _, _ = feature_slots(conflict_free_blocks(train)[0])
    return np.diff(off)


BLOCKS = {
    "empty_features": lambda: np.array([0, 0, 5, 0, 300, 0, 3000, 0]),
    "single_feature": lambda: np.array([7]),
    "zipf_head": _zipf_head,
    "class_edges": lambda: np.array([1, cd.SHORT_MAX - 1, cd.SHORT_MAX, cd.SHORT_MAX + 1,
                                     PIECE_LEN - 1, PIECE_LEN, PIECE_LEN + 1, 2 * PIECE_LEN,
                                     2 * PIECE_LEN + 1, 0]),
    "ctr_block": _ctr_block,
}
#: the kernel's thresholds, and forced ones (every feature medium, or cut
#: into pieces of 64 slots)
THRESHOLDS = {"kernel": {}, "forced": dict(short_max=0, piece_len=64)}


def _plan(name, thresholds):
    counts = BLOCKS[name]()
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return counts, off, cd.DrawPlan(off, "cpu", **THRESHOLDS[thresholds])


cases = pytest.mark.parametrize("thresholds", sorted(THRESHOLDS))
blocks = pytest.mark.parametrize("name", sorted(BLOCKS))


@blocks
@cases
def test_every_slot_in_exactly_one_warp_cta_or_piece(name, thresholds):
    counts, off, plan = _plan(name, thresholds)
    u = plan.units()
    E = int(off[-1])
    cover = np.zeros(E + 1, np.int64)
    np.add.at(cover, u[:, 4], 1)
    np.add.at(cover, u[:, 5], -1)
    assert (np.cumsum(cover)[:E] == 1).all()
    assert sorted(set(u[:, 3].tolist())) == list(range(len(counts)))
    # a warp or a CTA holds one whole feature; each (CTA, warp) once
    whole = u[u[:, 0] < 2]
    assert (whole[:, 4] == off[whole[:, 3]]).all() and (whole[:, 5] == off[whole[:, 3] + 1]).all()
    assert len({(c, w) for c, w in u[:, 1:3].tolist()}) == len(u)
    assert u[:, 1].max() == plan.ctas - 1 and (np.diff(u[:, 1]) >= 0).all()
    assert (u[u[:, 0] > 0, 2] == -1).all() and ((u[u[:, 0] == 0, 2] >= 0)
                                                & (u[u[:, 0] == 0, 2] < cd.WARPS)).all()


@blocks
@cases
def test_long_features_pieces_are_contiguous_in_rank_order(name, thresholds):
    counts, off, plan = _plan(name, thresholds)
    u = plan.units()
    pieces = u[u[:, 0] == 2]
    assert (u[:len(pieces), 0] == 2).all()  # first in the grid
    assert (pieces[:, 1] == np.arange(len(pieces))).all()
    L = plan.piece_len
    for f in np.unique(pieces[:, 3]):
        at = np.nonzero(pieces[:, 3] == f)[0]
        assert (np.diff(at) == 1).all()
        per = -(-counts[f] // L)
        assert len(at) == per > 1
        p = pieces[at]
        assert (p[:, 4] == off[f] + L * np.arange(per)).all()
        assert (p[:-1, 5] - p[:-1, 4] == L).all() and p[-1, 5] == off[f + 1]
    # Pieces.order: the feature's pieces in rank order, of `per` pieces
    order = plan.pieces.order[:plan.n_long].numpy()
    assert (order[:, 0] == pieces[:, 3]).all()
    assert (order[:, 3] == -(-counts[order[:, 0]] // L)).all()


@blocks
@cases
def test_classes_follow_the_thresholds(name, thresholds):
    counts, off, plan = _plan(name, thresholds)
    short_max, L = plan.short_max, plan.piece_len
    want = dict(short=int((counts <= min(short_max, L)).sum()),
                medium=int(((counts > short_max) & (counts <= L)).sum()),
                long=int((counts > L).sum()))
    assert plan.classes() == want
    assert plan.launches == (2 if want["long"] else 1)
    feats = plan.feats.numpy()
    med, short = counts[feats[:plan.n_medium]], counts[feats[plan.n_medium:]]
    assert ((med > short_max) & (med <= L)).all() and (short <= short_max).all()
    assert (np.diff(med) <= 0).all() and (np.diff(short) <= 0).all()  # longest first
    assert (counts[plan.units()[:, 3][plan.units()[:, 0] == 2]] > L).all()
    assert plan.ctas == plan.n_long + plan.n_medium + -(-plan.n_short // cd.WARPS)


@blocks
@cases
def test_scratch_rows_one_a_long_piece(name, thresholds):
    counts, off, plan = _plan(name, thresholds)
    L = plan.piece_len
    per = -(-counts // L)
    assert plan.n_long == int(per[counts > L].sum())
    scratch = plan.scratch()
    assert scratch.numel() == max(plan.n_long, 1) * cd.SCRATCH_ROW
    order = plan.pieces.order[:plan.n_long].numpy()
    rows = order[:, 2] + order[:, 1]  # the feature's first row + the piece's rank
    assert sorted(rows.tolist()) == list(range(plan.n_long))
    assert plan.pieces.ticket.shape == (len(counts),) and not plan.pieces.ticket.any()
    assert plan.scratch() is scratch  # made once, kept


def test_plan_refuses_thresholds_the_kernel_cannot_take():
    off = np.array([0, 5, 9])
    for kw in (dict(short_max=cd.SHORT_MAX + 1), dict(short_max=-1),
               dict(piece_len=PIECE_LEN + 1), dict(piece_len=0)):
        with pytest.raises(ValueError):
            cd.DrawPlan(off, "cpu", **kw)


# ---------------------------------------------------------------- rel_cache_cols

def _join(seed=4, nb=50, nc=3000):
    rng = np.random.default_rng(seed)
    row_map = rng.integers(0, nb, nc).astype(np.int32)
    row_map[: nc * 3 // 4] = 0  # a hot block row
    row_map[row_map == 1] = 2  # and one joined by no case
    off, ids = case_lists(row_map, nb)
    return rng, row_map, torch.as_tensor(off), torch.as_tensor(ids)


@pytest.mark.parametrize("layout", ["strided", "contiguous"])
def test_rel_cache_cols_plain_equals_rel_cache_plain_bitwise(layout):
    rng, _, off, ids = _join()
    nc = ids.shape[0]
    A = torch.as_tensor(rng.normal(0, 1, (nc, 5)), dtype=torch.float32)
    e, q = (A[:, 0], A[:, 3]) if layout == "strided" else (A[:, 0].clone(), A[:, 3].clone())
    assert (e.stride(0) == 5) == (layout == "strided")
    C = rel_cache_cols(e, q, off, ids)
    assert torch.equal(C, rel_cache_cols_plain(e, q, off, ids))
    assert torch.equal(C, rel_cache_plain(torch.stack([e, q], dim=1), off, ids))
    assert C.shape == (51, 5) and not C[1].any() and not C[50].any()


def test_rel_cache_cols_matches_jax_per_row_sums():
    rng, row_map, off, ids = _join(seed=8)
    nb, nc = off.shape[0] - 1, ids.shape[0]
    e = rng.normal(0, 1.0, nc).astype(np.float32)
    qd = rng.normal(0, 0.7, nc).astype(np.float32)
    C = rel_cache_cols(torch.tensor(e), torch.tensor(qd), off, ids).numpy()
    m = jnp.asarray(row_map)
    for col, terms in ((0, (e,)), (3, (e, qd)), (2, (qd,)), (4, (qd, qd))):
        x = np.prod(terms, axis=0)
        want = np.asarray(jax_seg_sum(jnp.asarray(x), m, nb))
        scale = np.asarray(jax_seg_sum(jnp.asarray(np.abs(x)), m, nb))
        assert (np.abs(C[:nb, col] - want) <= 1e-6 * np.maximum(scale, 1.0)).all(), col


# ---------------------------------------------------------------- the engines

def _recording(monkeypatch, module, name, seen):
    real = getattr(module, name)

    def recorded(theta, feat_off, *args, plan=None, **kw):
        seen.append((feat_off, plan))
        return real(theta, feat_off, *args, plan=plan, **kw)

    monkeypatch.setattr(module, name, recorded)


def _check_plans(seen, calls):
    assert len(seen) == calls
    for feat_off, plan in seen:
        assert isinstance(plan, cd.DrawPlan)
        assert np.array_equal(plan.off, feat_off.numpy())
    # one plan a block, made once: as many plans as blocks, each reused
    assert len({id(p) for _, p in seen}) < calls


def test_flat_exact_engine_hands_each_block_its_plan(monkeypatch):
    train, test = movielens_like(num_users=40, num_items=30, num_ratings=3000, seed=3)
    seen = []
    _recording(monkeypatch, tmcmc, "coord_draw", seen)
    k, iters = 2, 2
    ALSLearner(FMConfig(num_features=train.num_features, num_factors=k, regw=1, regv=1),
               num_iter=iters, seed=3, verbose=False, device="cpu").learn(train, test)
    _check_plans(seen, iters * (1 + k) * 2)  # two blocks: users, items


def test_bs_exact_engine_hands_each_block_its_plan(monkeypatch):
    train, test, nf = _single_rel_problem(NTR=800)
    train, test = to_port(train, test)
    seen = []
    _recording(monkeypatch, trel, "rel_coord_draw", seen)
    k, iters = 2, 2
    ALSLearner(FMConfig(num_features=nf, num_factors=k, regw=0.3, regv=0.3),
               num_iter=iters, seed=3, verbose=False, device="cpu").learn(train, test)
    nblk = len(seen) // (iters * (1 + k))
    assert nblk >= 2
    _check_plans(seen, iters * (1 + k) * nblk)

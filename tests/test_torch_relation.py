"""The port's relational (BS) data and the BS vector engine's host layout
and plain kernel versions, against the JAX package, on the CPU.

- data: `expand_join`, `expansion_cost`, `RelationJoin.permuted` and
  `bs_vector_skew` equal JAX's exactly; so do the layout's blocks (in the
  JAX engine's sweep order) and `wnum`; the learner routes
  (`relational_mode`) as JAX's does for the same data and flags;
- plain versions against what they replace, on data expanded by
  `expand_join` (the identities in the JAX engine's docstring,
  libfm_tpu/learners/mcmc_rel_vector.py:15-54): `rel_refresh_plain` over
  `rel_scores_plain` equals `fm_refresh_plain` on the expanded rows;
  `rel_cache_plain` then `rel_stats_plain` at a non-zero SD equals
  `slot_stats_plain` over the expanded cases (float64, 1e-9 of each
  part's largest value), also for a feature on every block row; `rel_update_plain` then `rel_resync_plain`
  equals `dense_update_plain` on the expanded cases; `rel_deferred_plain`
  equals the sums over the resynced residuals, and a per-row float64
  numpy loop of its formulas at k = 1, 3, 32 and 128 (the pad row
  summed too);
- BS classification and main-table features beside relations run on the
  BS engine (tests/test_torch_bs_main.py and
  tests/test_torch_bs_classification.py hold them to JAX), bs_vector off
  on the exact BS engine (tests/test_torch_exact_relational.py); what the
  port does not take raises NotImplementedError naming its ROADMAP item.
"""

import copy

import numpy as np
import pytest
import torch

import libfm_tpu.data.relation as jrelation
import libfm_tpu.learners.mcmc_rel_vector as jrel
from libfm_tpu.learners.mcmc_vector import MCMCVectorLearner as JaxMCMC
from libfm_tpu.models.fm import FMConfig as JaxFMConfig
from libfm_tpu_torch.data import relation as trelation
from libfm_tpu_torch.data.dataset import Dataset
from libfm_tpu_torch.data.vector_layout import padded_rows_layout
from libfm_tpu_torch.kernels.dense_update import dense_update_plain, update_table
from libfm_tpu_torch.kernels.fm_refresh import fm_refresh_plain
from libfm_tpu_torch.kernels.rel_cache import case_lists, rel_cache_plain
from libfm_tpu_torch.kernels.rel_refresh import rel_refresh_plain, rel_scores_plain
from libfm_tpu_torch.kernels.rel_sweep import (
    rel_deferred_plain,
    rel_resync_plain,
    rel_stats_plain,
    rel_update_plain,
)
from libfm_tpu_torch.kernels.slot_stats import slot_stats_plain
from libfm_tpu_torch.learners import mcmc_rel_vector as trel
from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner
from libfm_tpu_torch.models.fm import FMConfig
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION

from test_mcmc_rel_vector import _general_bs_problem, _single_rel_problem
from test_mcmc_relational import make_relational_problem


def to_port(*datasets):
    """The port's Datasets for JAX Datasets with relations; a relation
    block shared by several datasets stays one object."""
    blocks = {}
    out = []
    for ds in datasets:
        t = Dataset(ds.indptr, ds.cols, ds.vals, ds.target, ds.num_features)
        for join in ds.relations:
            rd = join.data
            if id(rd) not in blocks:
                blocks[id(rd)] = trelation.RelationData(rd.indptr, rd.cols, rd.vals,
                                                        rd.num_features)
                blocks[id(rd)].attr_offset = rd.attr_offset
            t.relations.append(trelation.RelationJoin(blocks[id(rd)],
                                                      np.asarray(join.row_map)))
        out.append(t)
    return out


def _skewed_problem():
    """One relation of 40 rows, most cases joined to row 0 (skew ~33)."""
    train, test, nf = _single_rel_problem(seed=3, NB=40, NTR=600)
    for ds in (train, test):
        m = ds.relations[0].row_map
        m[: 5 * len(m) // 6] = 0
    return train, test, nf


def _every_row_problem():
    """One relation of 300 rows of 4 entries with feature 0 on every row:
    a conflict-free block of that one feature, whose entries are all the
    rows (rel_stats takes them in many batches)."""
    train, test, nf = _single_rel_problem(seed=11, NB=300, W=4, NF=80, NTR=1500)
    rd = train.relations[0].data
    rd.cols.reshape(300, 4)[:, 0] = 0  # each row's smallest column; rows stay sorted
    return train, test, nf


PROBLEMS = {
    "single": lambda: _single_rel_problem(seed=9),
    "two": lambda: make_relational_problem()[:2] + make_relational_problem()[4:],
    "general": _general_bs_problem,
    "skewed": _skewed_problem,
    "every_row": _every_row_problem,
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_data_functions_equal_jax(name):
    train, test, _ = PROBLEMS[name]()
    ttr, tte = to_port(train, test)
    for j, t in ((train, ttr), (test, tte)):
        je, te = jrelation.expand_join(j), trelation.expand_join(t)
        for f in ("indptr", "cols", "vals", "target"):
            np.testing.assert_array_equal(getattr(te, f), getattr(je, f))
        assert te.num_features == je.num_features
        assert trelation.expansion_cost(t) == jrelation.expansion_cost(j)
        perm = np.random.default_rng(1).permutation(j.num_rows)
        for jj, tj in zip(j.relations, t.relations):
            np.testing.assert_array_equal(tj.permuted(perm).row_map,
                                          jj.permuted(perm).row_map)
    assert trel.bs_vector_skew(ttr) == jrel.bs_vector_skew(train)


@pytest.mark.parametrize("name", ["single", "two", "general"])
def test_layout_blocks_and_wnum_equal_jax(name):
    """The port's blocks, in sweep order, are the JAX engine's stacks
    unpadded (feature ids, entry rows, values), and wnum is equal."""
    train, test, nf = PROBLEMS[name]()
    ttr, tte = to_port(train, test)
    groups = np.zeros(nf, np.int32)
    for jt, je, tt, te in zip(train.relations, test.relations, ttr.relations,
                              tte.relations):
        jl = jrel._build_rel_layout(jt, je, groups, nf)
        tl = trel.RelLayout(tt, te, groups, nf)
        np.testing.assert_array_equal(tl.wnum, jl.wnum)
        jblocks = []
        for st in jl.stacks:
            for feats, eb, ex in zip(st.feats, st.entry_b, st.entry_x):
                F, E = int((feats < nf).sum()), int((eb < jl.nb).sum())
                jblocks.append((feats[:F], eb[:E], ex[:E]))
        assert len(tl.blocks) == len(jblocks)
        for tb, (feats, eb, ex) in zip(tl.blocks, jblocks):
            np.testing.assert_array_equal(tb.features, feats)
            np.testing.assert_array_equal(tb.entry_b, eb)
            np.testing.assert_array_equal(tb.entry_x, ex)
        np.testing.assert_array_equal(tl.unobserved, jl.unobserved_local + jl.attr_offset)


class _Routed(Exception):
    pass


ROUTES = [("single", {}), ("single", dict(expand_max_ratio=0.0)),
          ("two", {}), ("two", dict(expand_max_ratio=0.0)),
          ("skewed", dict(expand_max_ratio=0.0)),
          ("single", dict(expand_max_ratio=0.0, bs_vector=False))]


@pytest.mark.parametrize("name,flags", ROUTES)
def test_routing_matches_jax(name, flags, monkeypatch):
    """relational_mode as JAX decides it for the same data and flags (the
    JAX engines are stopped right after the decision), the exact BS
    engine ("bs") included."""
    train, test, nf = PROBLEMS[name]()

    def stop(*a, **kw):
        raise _Routed

    monkeypatch.setattr(jrelation, "expand_join", stop)
    monkeypatch.setattr(jrel, "learn_relational_vector", stop)
    monkeypatch.setattr(JaxMCMC, "_learn_relational", stop)
    jl = JaxMCMC(JaxFMConfig(num_features=nf, num_factors=2), num_iter=1, verbose=False)
    for key, v in flags.items():
        setattr(jl, key, v)
    with pytest.raises(_Routed):
        jl.learn(train, test)
    tl = MCMCVectorLearner(FMConfig(num_features=nf, num_factors=2), num_iter=1,
                           verbose=False, device="cpu")
    for key, v in flags.items():
        setattr(tl, key, v)
    ttr, tte = to_port(train, test)
    tl._route_relational(ttr, tte)
    assert tl.relational_mode == jl.relational_mode


# ---- the plain versions against what they replace, on the expansion


def _port_problem(name, k, seed=0):
    """(train, its expansion, P [n, k+1] float64, w0) for a problem's train
    set, P random."""
    train, test, nf = PROBLEMS[name]()
    ttr, _ = to_port(train, test)
    rng = np.random.default_rng(seed)
    P = torch.as_tensor(rng.normal(0, 0.5, (nf, k + 1)))
    return ttr, trelation.expand_join(ttr), P, torch.tensor(0.3, dtype=torch.float64)


@pytest.mark.parametrize("name", ["single", "two"])
@pytest.mark.parametrize("use_linear", [True, False])
def test_rel_refresh_plain_equals_fm_refresh_on_expansion(name, use_linear):
    k = 3
    ttr, exp, P, w0 = _port_problem(name, k)
    P = P.float()
    w0 = w0.float()
    nc = ttr.num_rows
    SC, maps, first = [], [], 0
    for join in ttr.relations:
        rd = join.data
        cols = torch.as_tensor(rd.cols.astype(np.int64) + rd.attr_offset)
        SC.append(rel_scores_plain(P, torch.as_tensor(rd.indptr), cols,
                                   torch.as_tensor(rd.vals), use_linear=use_linear))
        maps.append(torch.as_tensor(join.row_map.astype(np.int64) + first))
        first += rd.num_cases + 1
    SC, maps = torch.cat(SC), torch.stack(maps).int()
    y = torch.as_tensor(ttr.target)
    kw = dict(use_linear=use_linear, min_target=ttr.min_target, max_target=ttr.max_target)
    A_rel = torch.empty(nc, k + 1)
    m_rel = rel_refresh_plain(SC, maps, w0, A_rel, y, **kw)
    tail = torch.empty(nc, k + 1)
    rel_refresh_plain(SC, maps, w0, tail, use_linear=use_linear)
    ids, vals = (torch.as_tensor(a) for a in padded_rows_layout(exp.indptr, exp.cols,
                                                                 exp.vals))
    A_flat = torch.empty(nc, k + 1)
    m_flat = fm_refresh_plain(P, ids, vals, w0, y, A_flat, **kw)
    pred = fm_refresh_plain(P, ids, vals, w0, use_linear=use_linear)
    torch.testing.assert_close(A_rel, A_flat, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tail[:, 0], pred, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tail[:, 1:], A_rel[:, 1:], rtol=0, atol=0)
    torch.testing.assert_close(m_rel, m_flat, rtol=1e-5, atol=0)


def _sweep_state(name, k, seed):
    """A relation's caches at a non-zero SD, in float64: (train, expansion,
    P, layout, C, SD, the frozen A0 and the current A = A0 resynced by SD)."""
    ttr, exp, P, _ = _port_problem(name, k, seed)
    join = ttr.relations[0]
    nf = P.shape[0]
    lay = trel.RelLayout(join, join, np.zeros(nf, np.int32), nf)
    rng = np.random.default_rng(seed + 1)
    A0 = torch.as_tensor(rng.normal(0, 1, (ttr.num_rows, k + 1)))
    C = rel_cache_plain(A0, *(torch.as_tensor(a) for a in case_lists(join.row_map, lay.nb)))
    SD = torch.as_tensor(rng.normal(0, 0.3, (lay.nb + 1, k + 1)))
    SD[lay.nb] = 0.0
    A = A0.clone()
    rel_resync_plain(SD, torch.as_tensor(join.row_map), A)
    return ttr, exp, P, lay, C, SD, A0, A


def _expanded_slots(exp, feats):
    """Per feature of `feats` (global ids) its slots over the expansion:
    (feat_off, slot_case, slot_val)."""
    t_indptr, t_rows, t_vals = exp.transpose()
    cnt = t_indptr[feats + 1] - t_indptr[feats]
    idx = np.concatenate([np.arange(t_indptr[f], t_indptr[f + 1]) for f in feats])
    off = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    return (torch.as_tensor(off), torch.as_tensor(t_rows[idx].astype(np.int32)),
            torch.as_tensor(t_vals[idx].astype(np.float32)))


def _part_err(G, ref, k):
    T = k * (k + 1) // 2
    cuts = [0, T, T + k, T + 2 * k, T + 2 * k + 2]
    return max(((G[:, a:b] - ref[:, a:b]).abs().max()
                / ref[:, a:b].abs().max().clamp_min(1e-300)).item()
               for a, b in zip(cuts, cuts[1:]))


@pytest.mark.parametrize("name,k", [("single", 3), ("general", 4), ("general", 1),
                                    ("every_row", 1), ("every_row", 8), ("every_row", 32)])
@pytest.mark.parametrize("use_linear", [True, False])
def test_rel_cache_and_stats_plain_equal_slot_stats_on_expansion(name, k, use_linear):
    """GG from the frozen caches and SD equals slot_stats over the
    expanded cases of the current A, every block (float64, 1e-9); on
    "every_row" a block's one feature has an entry on each block row."""
    _, exp, P, lay, C, SD, _, A = _sweep_state(name, k, seed=2)
    wnum = torch.as_tensor(lay.wnum)
    assert len(lay.blocks) > (1 if name == "general" else 0)
    if name == "every_row":
        assert max(int(np.diff(b.feat_off).max()) for b in lay.blocks) == lay.nb
    for blk in lay.blocks:
        G_rel = rel_stats_plain(C, SD, wnum, torch.as_tensor(blk.feat_off),
                                torch.as_tensor(blk.entry_b), torch.as_tensor(blk.entry_x),
                                torch.as_tensor(blk.features.astype(np.int32)), P,
                                use_linear=use_linear)
        off, sc, sv = _expanded_slots(exp, blk.features)
        G_flat = slot_stats_plain(A, P, off, sc, sv.double(),
                                  torch.as_tensor(blk.features.astype(np.int32)),
                                  use_linear=use_linear)
        assert _part_err(G_rel, G_flat, k) < 1e-9


@pytest.mark.parametrize("name,k", [("single", 3), ("general", 4)])
def test_rel_update_and_resync_plain_equal_dense_update_on_expansion(name, k):
    """A block's draw folded into SD (rel_update_plain) and resynced into
    A0 equals the flat engine's dense update of the expanded cases, block
    after block (float64)."""
    ttr, exp, P, lay, C, SD, A0, A = _sweep_state(name, k, seed=4)
    rmap = torch.as_tensor(ttr.relations[0].row_map)
    rng = np.random.default_rng(5)
    for blk in lay.blocks:
        feats = torch.as_tensor(blk.features)
        theta_old = P[feats]
        theta_new = theta_old + torch.as_tensor(rng.normal(0, 0.2, theta_old.shape))
        rel_update_plain(SD, torch.as_tensor(blk.entry_b), torch.as_tensor(blk.entry_x),
                         torch.as_tensor(blk.entry_f), theta_old, theta_new)
        col = np.full(exp.num_rows, len(blk.features), np.int32)
        val = np.zeros(exp.num_rows, np.float64)
        t_indptr, t_rows, t_vals = exp.transpose()
        for j, f in enumerate(blk.features):
            rows = t_rows[t_indptr[f]:t_indptr[f + 1]]
            col[rows] = j
            val[rows] = t_vals[t_indptr[f]:t_indptr[f + 1]]
        dense_update_plain(A, torch.as_tensor(col), torch.as_tensor(val),
                           update_table(theta_old, theta_new))
        P[feats] = theta_new
        A_bs = A0.clone()
        rel_resync_plain(SD, rmap, A_bs)
        torch.testing.assert_close(A_bs, A, rtol=1e-10, atol=1e-10)
        pred = rel_resync_plain(SD, rmap, A0, read_only=True)
        torch.testing.assert_close(pred, A[:, 0], rtol=1e-10, atol=1e-10)


def test_deferred_sums_equal_the_resynced_sums():
    _, _, _, lay, C, SD, _, A = _sweep_state("single", 3, seed=6)
    s, s2 = rel_deferred_plain(C, SD, torch.as_tensor(lay.wnum))
    np.testing.assert_allclose(float(s), float(A[:, 0].sum()), rtol=1e-6)
    np.testing.assert_allclose(float(s2), float((A[:, 0] ** 2).sum()), rtol=1e-6)


def _deferred_loop(C, SD, wnum, k):
    """(sum e, sum e^2) by a loop over the rows of C (the pad row too),
    each row's terms in float64 from its caches, SQQ0 unpacked into the
    full symmetric matrix."""
    iu0, iu1 = np.triu_indices(k)
    se = se2 = 0.0
    for c, sd, wn in zip(C.astype(np.float64), SD.astype(np.float64),
                         wnum.astype(np.float64)):
        we0, we2_0 = c[0], c[1]
        SQ0, SQe0 = c[2:2 + k], c[2 + k:2 + 2 * k]
        M = np.zeros((k, k))
        M[iu0, iu1] = c[2 + 2 * k:]
        M[iu1, iu0] = c[2 + 2 * k:]
        s, dq = sd[0], sd[1:]
        se += we0 + wn * s + dq @ SQ0
        se2 += (we2_0 + 2 * s * we0 + 2 * dq @ SQe0 + wn * s * s + 2 * s * (dq @ SQ0)
                + dq @ M @ dq)
    return se, se2


@pytest.mark.parametrize("k", [1, 3, 32, 128])
@pytest.mark.parametrize("nb", [1, 6])
def test_rel_deferred_plain_equals_a_row_loop(k, nb):
    """rel_deferred_plain against the formulas row by row in float64, on
    float32 caches of nb block rows plus the pad row (its SD zero, its
    caches not): within 1e-6 of the sums' magnitudes, float32 results."""
    rng = np.random.default_rng(k + nb)
    C = rng.normal(0, 1, (nb + 1, 2 + 2 * k + k * (k + 1) // 2)).astype(np.float32)
    SD = rng.normal(0, 0.3, (nb + 1, k + 1)).astype(np.float32)
    SD[nb] = 0.0
    wnum = rng.integers(0, 40, nb + 1).astype(np.float32)
    s, s2 = rel_deferred_plain(*(torch.as_tensor(a) for a in (C, SD, wnum)))
    assert s.dtype == s2.dtype == torch.float32 and s.dim() == s2.dim() == 0
    want, want2 = _deferred_loop(C, SD, wnum, k)
    mag, mag2 = _deferred_loop(np.abs(C), np.abs(SD), wnum, k)
    assert abs(float(s) - want) <= 1e-6 * mag
    assert abs(float(s2) - want2) <= 1e-6 * mag2


# ---- what the slice does not take


def _binarised(train, test):
    """The problem with targets +1 where y > 0 and -1 elsewhere (copies)."""
    out = []
    for ds in (train, test):
        ds = copy.copy(ds)
        ds.target = np.where(ds.target > 0, 1.0, -1.0).astype(np.float32)
        ds.min_target, ds.max_target = -1.0, 1.0
        out.append(ds)
    return out


def test_out_of_slice_relational_cases_raise(tmp_path):
    train, test, nf = _single_rel_problem(seed=9)
    ttr, tte = to_port(train, test)
    cfg = FMConfig(num_features=nf, num_factors=2)

    def fat(**kw):
        lr = MCMCVectorLearner(cfg, num_iter=1, verbose=False, device="cpu", **kw)
        lr.expand_max_ratio = 0.0
        return lr

    # BS classification, main-table features beside relations and the
    # exact BS engine run (tests/test_torch_bs_main.py and
    # tests/test_torch_exact_relational.py hold them to JAX); the rest raises
    ctr = fat(task=TASK_CLASSIFICATION)
    ctr.learn(*to_port(*_binarised(train, test)))
    assert ctr.relational_mode == "bs_vector" and np.isfinite(ctr.history[-1]["test_all"])
    gtr, gte, gnf = _general_bs_problem()
    lr = MCMCVectorLearner(FMConfig(num_features=gnf, num_factors=2), num_iter=1,
                           verbose=False, device="cpu")
    lr.expand_max_ratio = 0.0
    lr.learn(*to_port(gtr, gte))
    assert lr.relational_mode == "bs_vector" and np.isfinite(lr.history[-1]["test_all"])
    off = fat()
    off.bs_vector = False
    off.learn(ttr, tte)
    assert off.relational_mode == "bs" and np.isfinite(off.history[-1]["test_all"])
    with pytest.raises(NotImplementedError, match="M13"):
        MCMCVectorLearner(cfg, mesh=object(), device="cpu")
    # checkpoints are in the slice since the learner options' slice
    # (tests/test_torch_checkpoint.py); the pure linear model (k = 0) on
    # relational data is not
    k0 = MCMCVectorLearner(FMConfig(num_features=nf, num_factors=0), num_iter=1,
                           verbose=False, device="cpu")
    with pytest.raises(NotImplementedError, match="§1 item 2"):
        k0.learn(ttr, tte)
    # rlog and the resident binary block load are in the slice since the
    # CLI's port, -cache_size's entry_budget since the out-of-core slice:
    # at budgets of 1 and of 5 entries the block loads as without one
    assert MCMCVectorLearner(cfg, rlog=object(), device="cpu").rlog is not None
    block = ttr.relations[0].data
    block.save(str(tmp_path / "blk"))
    for budget in (None, 1, 5):
        got = trelation.RelationData.load(str(tmp_path / "blk"), entry_budget=budget)
        for key in ("indptr", "cols", "vals"):
            assert np.array_equal(getattr(got, key), getattr(block, key))
            assert getattr(got, key).dtype == getattr(block, key).dtype
        assert got.num_features == block.num_features
    for budget in (None, 1024):
        with pytest.raises(FileNotFoundError):
            trelation.RelationData.load("no_such_prefix", entry_budget=budget)


def test_relation_join_load_text_and_binary(tmp_path):
    rd = trelation.RelationData(np.arange(4), np.arange(3), np.ones(3), 3)
    path = tmp_path / "map.txt"
    np.savetxt(path, np.array([2, 0, 1, 1]), fmt="%d")
    join = trelation.RelationJoin.load(rd, str(path), 4)
    np.testing.assert_array_equal(join.row_map, [2, 0, 1, 1])
    with pytest.raises(ValueError, match="expected 5"):
        trelation.RelationJoin.load(rd, str(path), 5)
    binary = tmp_path / "map.bin"
    binary.write_bytes(np.array([1, 4, 2], np.uint32).tobytes() + np.array([2, 1], np.uint32).tobytes())
    join = trelation.RelationJoin.load(rd, str(binary), 2)
    assert join.row_map.dtype == np.int32
    np.testing.assert_array_equal(join.row_map, [2, 1])

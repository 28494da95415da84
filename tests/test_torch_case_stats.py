"""Case-major moment statistics (K6) of the port against the slot path and
the JAX engine, on the CPU.

- `case_stats`'s plain GG against `slot_stats`'s plain GG on the blocks
  of ctr_like(5, 200, 15000, seed=4) at k=8, one-hot and with values
  from N(1, 0.25): within 1e-4 of each column's largest magnitude (the
  same statistic, f32 sums of moments instead of a Gram of v-corrected
  rows: M2 and m4 v v cancel).
- The case-major gate: the blocks that take case-major statistics are
  the JAX engine's, read from its own layouts (libfm_tpu.learners.
  mcmc_vector.DevLayout.stats_map), on ctr_like, on ml_small and on a
  block that covers fewer than a quarter of the cases.
- ALS regression at the JAX defaults of this slice (case-major
  statistics on both sides, dual draws off) on ml_small: test_this within
  1e-4 at every iteration of 4 (the refreshes at 0 and 3, the fast path
  between: the JAX engine compiles one program for each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libfm_tpu.learners.mcmc_vector as jmv
from libfm_tpu.data.dataset import Dataset as JaxDataset
from libfm_tpu.data.synth import movielens_like as jax_movielens_like
from libfm_tpu.models.fm import FMConfig as JaxFMConfig
from libfm_tpu_torch.convert import params_from_jax
from libfm_tpu_torch.data.batching import conflict_free_blocks
from libfm_tpu_torch.data.dataset import Dataset
from libfm_tpu_torch.data.synth import ctr_like, movielens_like
from libfm_tpu_torch.kernels import case_stats as cs
from libfm_tpu_torch.kernels import fm_refresh as fr
from libfm_tpu_torch.kernels import slot_stats as ss
from libfm_tpu_torch.kernels.pieces import PIECE_LEN, Pieces
from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner, DevBlock
from libfm_tpu_torch.models.fm import FMConfig

K = 8


def _jax_init(n, k, seed, init_stdev=0.1):
    """The JAX engine's initial draw (mcmc_vector.py learn: PRNGKey(seed),
    split 3, normals for w then V)."""
    key = jax.random.PRNGKey(seed)
    key, kw, kv = jax.random.split(key, 3)
    w = init_stdev * jax.random.normal(kw, (n,), dtype=jnp.float32)
    V = init_stdev * jax.random.normal(kv, (n, k), dtype=jnp.float32)
    return np.float32(0.0), np.asarray(w), np.asarray(V)


def _valued(ds, seed):
    rng = np.random.default_rng(seed)
    return Dataset(ds.indptr, ds.cols, rng.normal(1.0, 0.25, ds.nnz).astype(np.float32),
                   ds.target, ds.num_features)


def _col_rel_err(a, b):
    """Largest difference per column over the column's largest magnitude."""
    return ((a - b).abs().amax(dim=0) / b.abs().amax(dim=0).clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("valued", [False, True])
@pytest.mark.parametrize("use_linear", [True, False])
def test_case_stats_plain_matches_slot_stats(valued, use_linear):
    tr, _, groups = ctr_like(5, 200, 15000, seed=4)
    if valued:
        tr = _valued(tr, 7)
    n, nc = tr.num_features, tr.num_rows
    rng = np.random.default_rng(3)
    P = torch.tensor(rng.normal(0, 0.3, (n, K + 1)).astype(np.float32))
    w0 = torch.tensor(0.1)
    ids, vals = (torch.tensor(x) for x in _padded(tr))
    y = torch.tensor(tr.target)
    A = torch.empty(nc, K + 1)
    fr.fm_refresh_plain(P, ids, vals, w0, y, A)
    for b in conflict_free_blocks(tr, attr_group=groups):
        blk = DevBlock(b, groups[b.features], nc, "cpu", K, True)
        assert blk.onehot is not valued
        args = (A, P, blk.feat_off, blk.slot_case, blk.slot_val, blk.feat_id)
        G_c = cs.case_stats(*args, onehot=blk.onehot, use_linear=use_linear)
        G_s = ss.slot_stats(*args, use_linear=use_linear)
        assert G_c.shape == G_s.shape == (blk.F, ss.gg_width(K))
        if use_linear:
            assert _col_rel_err(G_c, G_s) < 1e-4
        else:
            T = K * (K + 1) // 2
            assert _col_rel_err(G_c[:, :T], G_s[:, :T]) < 1e-4
            assert _col_rel_err(G_c[:, T + K:T + 2 * K], G_s[:, T + K:T + 2 * K]) < 1e-4
            assert not G_c[:, T:T + K].any() and not G_c[:, T + 2 * K:].any()


def _padded(ds):
    from libfm_tpu_torch.data.vector_layout import padded_rows_layout

    return padded_rows_layout(ds.indptr, ds.cols, ds.vals)


def test_case_stats_padding_slots_add_nothing():
    """Slots whose case is num_rows are padding, as for slot_stats."""
    rng = np.random.default_rng(5)
    nc, n, k = 50, 6, 3
    A = torch.tensor(rng.normal(0, 1, (nc, k + 1)).astype(np.float32))
    P = torch.tensor(rng.normal(0, 1, (n, k + 1)).astype(np.float32))
    off = torch.tensor([0, 4, 4, 9], dtype=torch.int64)
    sc = torch.tensor([1, 7, 8, 30, 2, 3, nc, 11, nc], dtype=torch.int32)
    sv = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1, 0], dtype=torch.float32)
    fid = torch.tensor([0, 2, 5], dtype=torch.int32)
    G_c = cs.case_stats(A, P, off, sc, sv, fid, onehot=True)
    G_s = ss.slot_stats(A, P, off, sc, sv, fid)
    assert _col_rel_err(G_c, G_s) < 1e-5
    assert not G_c[1].any()  # a feature with no slot


@pytest.mark.parametrize("k,onehot,items", [(5, True, 6), (8, False, 6), (16, True, 15),
                                            (16, False, 15), (64, True, 153),
                                            (128, False, 561)])
def test_scratch_floats_counts_the_kernel_items(k, onehot, items):
    """A piece's scratch row: a 4 x 4 sum an item, one-hot or valued alike;
    the CTA's shared memory within the H100's 227 KB either way."""
    assert cs.num_items(k) == items and cs.scratch_floats(k) == 16 * items
    assert cs.smem_bytes(k, onehot) <= 232_448


def test_pieces_cut_long_lists():
    counts = np.array([0, 3, 2 * PIECE_LEN, 1, 3 * PIECE_LEN + 1])
    p = Pieces(np.concatenate([[0], np.cumsum(counts)]), "cpu")
    assert p.count == 9 and p.rows == 6
    # every piece once, features of many pieces first, with their first
    # scratch row (only features of several pieces take rows) and count
    assert p.order.tolist() == [[4, 0, 2, 4], [4, 1, 2, 4], [4, 2, 2, 4], [4, 3, 2, 4],
                                [2, 0, 0, 2], [2, 1, 0, 2],
                                [0, 0, 0, 1], [1, 0, 0, 1], [3, 0, 2, 1]]
    assert p.ticket.tolist() == [0] * 5
    assert p.scratch(12).numel() == 6 * 12 and p.scratch(12) is p.scratch(12)


# ---------------------------------------------------------------- the gate

def _jax_gate(monkeypatch, learner, train, test):
    """The JAX engine's case-major decision per block, in block order: its
    learn() builds every DevLayout, then stops at the first random key."""
    seen = []
    real = jmv.DevLayout

    def record(**kw):
        seen.append(kw["stats_map"] is not None)
        return real(**kw)

    class Stop(Exception):
        pass

    def stop(*a, **kw):
        raise Stop

    monkeypatch.setattr(jmv, "DevLayout", record)
    monkeypatch.setattr(jax.random, "PRNGKey", stop)
    with pytest.raises(Stop):
        learner.learn(train, test)
    monkeypatch.undo()
    return seen


def _low_coverage(np_ds_cls):
    """ml-like data with a third group on a tenth of the rows: its block
    covers fewer than a quarter of the cases."""
    rng = np.random.default_rng(11)
    nr, nu, ni, nt = 3000, 60, 40, 12
    u = rng.integers(0, nu, nr)
    i = nu + rng.integers(0, ni, nr)
    tag = rng.random(nr) < 0.1
    t = nu + ni + rng.integers(0, nt, nr)
    lens = 2 + tag
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    cols = np.concatenate([np.stack([u, i], 1)[r] if not tag[r] else
                           np.array([u[r], i[r], t[r]]) for r in range(nr)]).astype(np.int32)
    vals = np.ones(len(cols), np.float32)
    y = rng.uniform(1, 5, nr).astype(np.float32)
    groups = np.repeat(np.arange(3, dtype=np.int32), [nu, ni, nt])
    n = nu + ni + nt
    return (np_ds_cls(indptr, cols, vals, y, n),
            np_ds_cls(indptr[:101], cols[:indptr[100]], vals[:indptr[100]], y[:100], n),
            groups)


def _cases():
    tr, te, g = ctr_like(5, 200, 15000, seed=4)
    yield "ctr_like", (tr, te, g), tuple(
        JaxDataset(d.indptr, d.cols, d.vals, d.target, d.num_features) for d in (tr, te)
    ) + (g,)
    ml, mlt = movielens_like(num_users=120, num_items=90, num_ratings=8000, seed=3)
    jml, jmlt = jax_movielens_like(num_users=120, num_items=90, num_ratings=8000, seed=3)
    yield "ml_small", (ml, mlt, None), (jml, jmlt, None)
    yield "low coverage", _low_coverage(Dataset), _low_coverage(JaxDataset)


@pytest.mark.parametrize("case", ["ctr_like", "ml_small", "low coverage"])
def test_case_major_blocks_match_jax(monkeypatch, case):
    (tr, te, g), (jtr, jte, jg) = next((p, j) for c, p, j in _cases() if c == case)
    n = tr.num_features
    learner = jmv.ALSVectorLearner(JaxFMConfig(num_features=n, num_factors=K), num_iter=1,
                                   verbose=False, dual_draws=False, attr_group=jg)
    assert learner.case_major_stats
    jax_sel = _jax_gate(monkeypatch, learner, jtr, jte)
    groups = np.zeros(n, np.int32) if g is None else g
    port_sel = [DevBlock(b, groups[b.features], tr.num_rows, "cpu", K, True).case_major
                for b in conflict_free_blocks(tr, attr_group=groups)]
    assert port_sel == jax_sel
    assert any(port_sel)
    if case == "low coverage":
        assert port_sel == [True, True, False]


# ------------------------------------------- ALS regression, case-major on

ITERS = 4


def test_als_case_major_matches_jax():
    jtr, jte = jax_movielens_like(num_users=120, num_items=90, num_ratings=8000, seed=3)
    n = jtr.num_features
    ja = jmv.ALSVectorLearner(JaxFMConfig(num_features=n, num_factors=K, regw=5, regv=5),
                              num_iter=ITERS, seed=1, verbose=False, dual_draws=False)
    assert ja.case_major_stats
    ja.learn(jtr, jte)
    tr, te = movielens_like(num_users=120, num_items=90, num_ratings=8000, seed=3)
    ta = ALSVectorLearner(FMConfig(num_features=n, num_factors=K, regw=5, regv=5),
                          num_iter=ITERS, seed=1, verbose=False, device="cpu",
                          init_params=params_from_jax(*_jax_init(n, K, 1), device="cpu"))
    assert ta.case_major_stats
    ta.learn(tr, te)
    assert len(ta.history) == len(ja.history) == ITERS
    for hj, ht in zip(ja.history, ta.history):
        assert abs(hj["test_this"] - ht["test_this"]) < 1e-4, (hj, ht)
        assert ht["rejected"] == 0

"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device. Run them on the
GPU machine (no jax there, so skip the jax-configuring conftest):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

chip_smoke.py holds the kernels at the shapes of configs #1, #3 and
#4b; these tests cover the other widths and options: k from 1 to 128,
skewed slot counts, features with no slots, padding slots and slot lists
of many tiles, valued (not one-hot) entries, the linear and bias terms
switched off, the reject guard on systems that are not positive
definite, more systems than one persistent wave and rows that start off
16-byte boundaries; for SGD rows of L = 1, 2 and 13,
heavy duplicate ids in a batch, a padded final batch and table widths 9,
16, 17 and 128. The tiled kernels (dense_update, fm_refresh) at no rows,
part of a tile, ragged tails and many tiles a CTA, L = 1, 2, 5 and 13,
blocks that cover no case or few tiles, the same bits on a second
launch, and the inputs they refuse (A off 16 bytes, a table whose rows
are not update_table's 16-byte pieces). Tolerances as in chip_smoke.py:
fp32 sums taken in another order.
"""

import numpy as np
import pytest
import torch

from libfm_tpu_torch import kernels
from libfm_tpu_torch.data.batching import FeatureBlock, feature_slots
from libfm_tpu_torch.data.synth import ctr_like, movielens_like
from libfm_tpu_torch.kernels import dense_update as du
from libfm_tpu_torch.kernels import dual_draw as dd
from libfm_tpu_torch.kernels import fm_refresh as fr
from libfm_tpu_torch.kernels import schur_draw as sd
from libfm_tpu_torch.kernels import sgd_step as sg
from libfm_tpu_torch.kernels import slot_stats as ss
from libfm_tpu_torch.kernels import table_read as tr
from libfm_tpu_torch.kernels import table_scatter as ts
from libfm_tpu_torch.learners import sgd as tsgd
from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner
from libfm_tpu_torch.models.fm import FMConfig, FMParams
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION

pytestmark = pytest.mark.cuda

KS = [1, 5, 8, 32, 64, 128]
# case_stats against the float64 plain version, over each entry's sum of
# magnitudes (as chip_smoke.py holds it)
CASE_STATS_TOL = 6e-7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU with "
                    "`python -m pytest --noconftest -q tests/test_torch_cuda.py`")
    return torch.device("cuda")


def _block(rng, nc, F, n, skewed):
    """A conflict-free block with valued entries: Zipf-skewed slot counts
    (1 to 300 a feature) or near-uniform ones (48-59)."""
    counts = np.minimum(rng.zipf(1.5, F), 300) if skewed else rng.integers(48, 60, F)
    counts = np.minimum(counts, nc)
    entry_feat = np.repeat(np.arange(F, dtype=np.int32), counts)
    rows = rng.permutation(nc)[: counts.sum()] if counts.sum() <= nc else None
    if rows is None:
        rows = np.concatenate([rng.choice(nc, c, replace=False) for c in counts])
    features = rng.choice(n, F, replace=False).astype(np.int32)
    vals = rng.normal(1.0, 0.5, len(entry_feat)).astype(np.float32)
    return FeatureBlock(features, rows.astype(np.int32), vals, entry_feat)


def _to(dev, *xs):
    return [torch.as_tensor(x, device=dev) for x in xs]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("use_linear,use_bias", [(True, True), (False, False)])
def test_fm_refresh_kernel_matches_plain(cuda, k, use_linear, use_bias):
    rng = np.random.default_rng(k)
    n, nr, L = 500, 3000, 5
    P, ids, vals, y = _to(
        cuda,
        rng.normal(0, 0.3, (n, k + 1)).astype(np.float32),
        rng.integers(0, n, (nr, L)).astype(np.int32),
        (rng.normal(1, 0.5, (nr, L)) * (rng.random((nr, L)) < 0.8)).astype(np.float32),
        rng.uniform(1, 5, nr).astype(np.float32),
    )
    w0 = torch.tensor(3.0, device=cuda)
    kw = dict(use_linear=use_linear, use_bias=use_bias, min_target=1.0, max_target=5.0)
    A_k = torch.empty(nr, k + 1, device=cuda)
    A_p = torch.empty(nr, k + 1, device=cuda)
    before = kernels.launch_counts()["fm_refresh"]
    s_k = fr.fm_refresh(P, ids, vals, w0, y, A_k, **kw)
    s_p = fr.fm_refresh_plain(P, ids, vals, w0, y, A_p, **kw)
    p_k = fr.fm_refresh(P, ids, vals, w0, **kw)
    p_p = fr.fm_refresh_plain(P, ids, vals, w0, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fm_refresh"] == before + 2
    assert (A_k - A_p).abs().max().item() < 1e-4
    assert (p_k - p_p).abs().max().item() < 1e-4
    assert abs(s_k.item() - s_p.item()) <= 1e-4 * max(1.0, s_p.item())


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("use_linear", [True, False])
def test_slot_stats_kernel_matches_plain(cuda, k, skewed, use_linear):
    rng = np.random.default_rng(100 + k + skewed)
    nc, F, n = 4000, 60, 400
    blk = _block(rng, nc, F, n, skewed)
    off, sc, sv = feature_slots(blk)
    A, P, off, sc, sv, fid = _to(
        cuda,
        rng.normal(0, 1, (nc, k + 1)).astype(np.float32),
        rng.normal(0, 0.3, (n, k + 1)).astype(np.float32),
        off, sc, sv, blk.features,
    )
    G_k = ss.slot_stats(A, P, off, sc, sv, fid, use_linear=use_linear)
    G_p = ss.slot_stats_plain(A, P, off, sc, sv, fid, use_linear=use_linear)
    torch.cuda.synchronize()
    assert ss.gg_rel_err(G_k, G_p, k) < 1e-4


def _gg_rows(dev, rng, F, k, W):
    """GG rows [F, T+2k+2] of consistent statistics: H^T H and H^T e of
    random [W, k+1] slot matrices H and residuals e."""
    H = torch.as_tensor(rng.normal(0, 1, (F, W, k + 1)), device=dev, dtype=torch.float32)
    Et = torch.as_tensor(rng.normal(0, 1, (F, W)), device=dev, dtype=torch.float32)
    HtH = torch.einsum("fwi,fwj->fij", H, H)
    Hte = torch.einsum("fwi,fw->fi", H, Et)
    iu0, iu1 = np.triu_indices(k)
    return torch.cat([
        HtH[:, 1:, 1:][:, iu0, iu1], HtH[:, 1:, 0], Hte[:, 1:],
        HtH[:, 0, :1], Hte[:, :1],
    ], dim=1).contiguous()


def _draw_both(GG, theta, lam, mu, z, alpha, do_sample, bound):
    """schur_draw and its plain version on the same inputs; checks that
    the reject flags agree and that a rejected draw keeps the old theta."""
    t_k, r_k = sd.schur_draw(GG, theta, lam, mu, z, alpha, do_sample=do_sample, bound=bound)
    t_p, r_p = sd.schur_draw_plain(GG, theta, lam, mu, z, alpha, do_sample=do_sample,
                                   bound=bound)
    torch.cuda.synchronize()
    assert torch.equal(r_k, r_p)
    assert torch.equal(t_k[r_k == 1], theta[r_k == 1])
    return t_k, r_k, t_p


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("do_sample", [True, False])
def test_schur_draw_kernel_matches_plain(cuda, k, do_sample):
    rng = np.random.default_rng(200 + k)
    F, W, d = 300, 3 * k + 8, k + 1
    GG = _gg_rows(cuda, rng, F, k, W)
    theta, lam, mu, z = _to(
        cuda,
        rng.normal(0, 0.1, (F, d)).astype(np.float32),
        rng.uniform(0.5, 5, (F, d)).astype(np.float32),
        rng.normal(0, 0.1, (F, d)).astype(np.float32),
        rng.normal(size=(F, d)).astype(np.float32),
    )
    GG[0, : k * (k + 1) // 2] = -1.0  # not positive definite: rejected
    mu[1] = 1e4  # a mean beyond the bound: rejected
    alpha = torch.tensor(1.3, device=cuda)
    t_k, r_k = sd.schur_draw(GG, theta, lam, mu, z, alpha, do_sample=do_sample, bound=100.0)
    t_p, r_p = sd.schur_draw_plain(GG, theta, lam, mu, z, alpha, do_sample=do_sample, bound=100.0)
    torch.cuda.synchronize()
    assert torch.equal(r_k, r_p)
    assert r_k[0].item() == 1 and r_k[1].item() == 1
    assert torch.equal(t_k[:2], theta[:2])
    assert ((t_k - t_p).abs().max() / t_p.abs().max().clamp_min(1.0)).item() < 1e-3


# dual_draw's (slot count, k) pairs: every count below d = k + 1, up to
# the JAX engine's widest dual segment (64)
DUAL_CASES = [(c, k) for k in (5, 32, 40, 128) for c in (1, 2, 3, 17, 32, 64) if c < k + 1]


def _dual_inputs(dev, rng, k, c, onehot, F=300, nc=4000):
    """F dual features of 1 to c slots (the first three of exactly c, one
    of 1) on an A of nc rows, with the rows, priors and noise of a draw.
    Returns (args of dual_draw without the keywords, counts)."""
    d = k + 1
    counts = rng.integers(1, c + 1, F)
    counts[:3] = c
    counts[3] = 1
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    sc = np.concatenate([rng.choice(nc, n, replace=False) for n in counts]).astype(np.int32)
    sv = (np.ones(len(sc)) if onehot else rng.normal(1.0, 0.5, len(sc))).astype(np.float32)
    A = rng.normal(0, 0.5, (nc, d)).astype(np.float32)
    theta = rng.normal(0, 0.1, (F, d)).astype(np.float32)
    lam = rng.uniform(0.5, 5, (F, d)).astype(np.float32)
    mu = rng.normal(0, 0.1, (F, d)).astype(np.float32)
    u = rng.normal(size=(F, d)).astype(np.float32)
    dl = rng.normal(size=len(sc)).astype(np.float32)
    return _to(dev, A, off, sc, sv, theta, lam, mu, u, dl, np.float32(1.3)), counts


def _dual_both(args, **kw):
    """dual_draw and its plain version on the same inputs: the reject flags
    agree, a rejected draw keeps the old theta, and a second launch gives
    the same bits. Returns (kernel's theta, flags, plain's theta)."""
    t_k, r_k = dd.dual_draw(*args, **kw)
    t_k2, _ = dd.dual_draw(*args, **kw)
    t_p, r_p = dd.dual_draw_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(t_k, t_k2)
    assert torch.equal(r_k, r_p)
    theta = args[4]
    assert torch.equal(t_k[r_k == 1], theta[r_k == 1])
    return t_k, r_k, t_p


def _dual_err(t_k, t_p):
    return ((t_k - t_p).abs() / t_p.abs().clamp_min(1.0)).max().item()


@pytest.mark.parametrize("c,k", DUAL_CASES)
@pytest.mark.parametrize("onehot", [True, False])
@pytest.mark.parametrize("do_sample", [True, False])
def test_dual_draw_kernel_matches_plain(cuda, c, k, onehot, do_sample):
    """Tolerance 1e-4 of max(1, |theta|), as chip_smoke.py holds it: fp32
    sums in another order through K = I + Phi D^-1 Phi^T >= I."""
    rng = np.random.default_rng(900 + 7 * c + k + onehot)
    args, _ = _dual_inputs(cuda, rng, k, c, onehot)
    t_k, r_k, t_p = _dual_both(args, do_sample=do_sample, bound=100.0, use_linear=True)
    assert not r_k.any()
    assert _dual_err(t_k, t_p) < 1e-4


@pytest.mark.parametrize("k", [5, 40, 128])
def test_dual_draw_kernel_rejects_what_plain_rejects(cuda, k):
    """Every 3rd feature gets a negative prior precision (K indefinite: a
    NaN draw) and feature 1 a mean beyond the bound; the flags equal the
    plain version's and those draws keep the old theta."""
    rng = np.random.default_rng(950 + k)
    args, _ = _dual_inputs(cuda, rng, k, min(32, k), onehot=False)
    lam, mu = args[5], args[6]
    lam[::3] = -1e-3 * lam[::3]
    mu[1] = 1e4
    t_k, r_k, t_p = _dual_both(args, do_sample=True, bound=100.0, use_linear=True)
    assert r_k[::3].all() and r_k[1].item() == 1
    ok = r_k == 0
    assert ((t_k[ok] - t_p[ok]).abs() / t_p[ok].abs().clamp_min(1.0)).max().item() < 1e-4


@pytest.mark.parametrize("k", [5, 128])
def test_dual_draw_kernel_frozen_linear_term(cuda, k):
    """use_linear False: h's w column is zero, and the learner's lam0 = 1e30
    and mu0 = 0 keep w at the prior's draw alone."""
    rng = np.random.default_rng(970 + k)
    args, _ = _dual_inputs(cuda, rng, k, min(17, k), onehot=False)
    args[5][:, 0] = 1e30
    args[6][:, 0] = 0.0
    for do_sample in (True, False):
        t_k, r_k, t_p = _dual_both(args, do_sample=do_sample, bound=100.0,
                                   use_linear=False)
        assert not r_k.any()
        assert _dual_err(t_k, t_p) < 1e-4
        assert t_k[:, 0].abs().max().item() < 1e-12


def test_dual_draw_kernel_refuses_longer_lists(cuda):
    rng = np.random.default_rng(990)
    args, _ = _dual_inputs(cuda, rng, 128, 65, onehot=True)
    with pytest.raises(ValueError, match="at most 64"):
        dd.dual_draw(*args, do_sample=True, bound=100.0, use_linear=True)


def test_als_dual_on_cuda_follows_the_cpu_trajectory(cuda):
    """ALS classification with dual draws (ctr_like(4, 100, 2000, seed=1),
    k=40: every block has dense and dual features) on the card against the
    CPU from the same initial parameters, within 1e-4 at every iteration."""
    train, test, groups = ctr_like(4, 100, 2000, seed=1)
    n, k = train.num_features, 40
    rng = np.random.default_rng(1)
    init = (np.float32(0.0), rng.normal(0, 0.1, n).astype(np.float32),
            rng.normal(0, 0.1, (n, k)).astype(np.float32))
    cfg = FMConfig(num_features=n, num_factors=k, regw=5.0, regv=5.0)
    runs = {}
    for dev in ("cpu", "cuda"):
        kernels.reset_launch_counts()
        learner = ALSVectorLearner(cfg, task=TASK_CLASSIFICATION, num_iter=6, seed=1,
                                   verbose=False, device=dev, attr_group=groups,
                                   init_params=init)
        runs[dev] = learner.learn(train, test)
    assert kernels.launch_counts()["dual_draw"] == 4 * 6
    for hc, hg in zip(runs["cpu"], runs["cuda"], strict=True):
        for key in ("test_this", "test_this_m2", "train"):
            assert abs(hc[key] - hg[key]) < 1e-4, (key, hc, hg)
        assert hg["rejected"] == 0


@pytest.mark.parametrize("k", [8, 64, 100])
def test_schur_draw_kernel_rejects_what_plain_rejects(cuda, k):
    """Systems that are not positive definite (a large negative lam on a
    third of the features) are rejected exactly where the plain version
    rejects them, in both modes."""
    rng = np.random.default_rng(250 + k)
    F, d = 900, k + 1
    GG = _gg_rows(cuda, rng, F, k, 2 * k + 8)
    theta, lam, mu, z = _to(
        cuda,
        rng.normal(0, 0.1, (F, d)).astype(np.float32),
        rng.uniform(0.5, 5, (F, d)).astype(np.float32),
        rng.normal(0, 0.1, (F, d)).astype(np.float32),
        rng.normal(size=(F, d)).astype(np.float32),
    )
    lam[::3, 1:] = -1e4  # far past the Gram's diagonal (~2k + 8)
    alpha = torch.tensor(1.0, device=cuda)
    for do_sample in (True, False):
        t_k, r_k, t_p = _draw_both(GG, theta, lam, mu, z, alpha, do_sample, 1e6)
        assert r_k[::3].all() and int(r_k.sum()) >= F // 3
        assert ((t_k - t_p).abs().max() / t_p.abs().max().clamp_min(1.0)).item() < 1e-3


@pytest.mark.parametrize("k", [5, 64])
def test_schur_draw_kernel_frozen_linear_term(cuda, k):
    """lam0 = 1e30 and mu0 = 0, as the learner sets them with
    use_linear=False: w stays 0 and nothing is rejected."""
    rng = np.random.default_rng(260 + k)
    F, d = 400, k + 1
    GG = _gg_rows(cuda, rng, F, k, 2 * k + 8)
    theta, lam, mu, z = _to(
        cuda,
        rng.normal(0, 0.1, (F, d)).astype(np.float32),
        rng.uniform(0.5, 5, (F, d)).astype(np.float32),
        rng.normal(0, 0.1, (F, d)).astype(np.float32),
        rng.normal(size=(F, d)).astype(np.float32),
    )
    theta[:, 0] = 0.0
    lam[:, 0] = 1e30
    mu[:, 0] = 0.0
    alpha = torch.tensor(2.0, device=cuda)
    for do_sample in (True, False):
        t_k, r_k, t_p = _draw_both(GG, theta, lam, mu, z, alpha, do_sample, 1e6)
        assert int(r_k.sum()) == 0
        assert t_k[:, 0].abs().max().item() < 1e-6
        assert ((t_k - t_p).abs().max() / t_p.abs().max().clamp_min(1.0)).item() < 1e-3


@pytest.mark.parametrize("k", [32, 64])
def test_schur_draw_kernel_many_systems_unaligned_rows(cuda, k):
    """More systems than one persistent wave of warps holds (the warps
    walk several systems each), with every input a view that starts one
    row into its buffer, so GG rows and theta rows start off 16-byte
    boundaries."""
    rng = np.random.default_rng(270 + k)
    F, d = 20000, k + 1
    GG = _gg_rows(cuda, rng, F + 1, k, k + 8)[1:]
    theta, lam, mu, z = (
        torch.as_tensor(a, device=cuda)[1:] for a in (
            rng.normal(0, 0.1, (F + 1, d)).astype(np.float32),
            rng.uniform(0.5, 5, (F + 1, d)).astype(np.float32),
            rng.normal(0, 0.1, (F + 1, d)).astype(np.float32),
            rng.normal(size=(F + 1, d)).astype(np.float32),
        )
    )
    assert GG.data_ptr() % 16 != 0 and theta.data_ptr() % 16 != 0
    alpha = torch.tensor(1.5, device=cuda)
    t_k, r_k, t_p = _draw_both(GG, theta, lam, mu, z, alpha, True, 1e6)
    assert int(r_k.sum()) == 0
    assert ((t_k - t_p).abs().max() / t_p.abs().max().clamp_min(1.0)).item() < 1e-3


def _slots(rng, nc, counts, pad_share=0.0):
    """Per-feature slot lists with the given counts; a share of the slots
    are padding (case == nc)."""
    off = np.zeros(len(counts) + 1, np.int64)
    off[1:] = np.cumsum(counts)
    sc = np.concatenate([rng.choice(nc, c, replace=False) for c in counts]
                        + [np.zeros(0, np.int64)]).astype(np.int32)
    sc[rng.random(len(sc)) < pad_share] = nc
    sv = rng.normal(1.0, 0.5, len(sc)).astype(np.float32)
    return off, sc, sv


@pytest.mark.parametrize("k", [5, 64, 128])
def test_slot_stats_kernel_edge_lists(cuda, k):
    """A feature with no slots (its row is all zero), padding slots (a
    fifth of them), features that span many 32-slot tiles, and lists cut
    into several pieces (2,048 slots a CTA: 2, 3 and 7 pieces). One cut
    serves every call: its ticket is zero again after each."""
    from libfm_tpu_torch.kernels.pieces import PIECE_LEN, Pieces

    rng = np.random.default_rng(150 + k)
    nc, n = 20000, 300
    counts = np.array([0, 1, 31, 32, 33, 0, 2000, 97, 4000, 64, 3,
                       2 * PIECE_LEN + 5, 7 * PIECE_LEN])
    off, sc, sv = _slots(rng, nc, counts, pad_share=0.2)
    fid = rng.choice(n, len(counts), replace=False).astype(np.int32)
    A, P, off, sc, sv, fid = _to(
        cuda,
        rng.normal(0, 1, (nc, k + 1)).astype(np.float32),
        rng.normal(0, 0.3, (n, k + 1)).astype(np.float32),
        off, sc, sv, fid,
    )
    pieces = Pieces(off, cuda)
    assert pieces.rows == 2 + 3 + 7
    for use_linear in (True, False):
        G_k = ss.slot_stats(A, P, off, sc, sv, fid, use_linear=use_linear, pieces=pieces)
        G_p = ss.slot_stats_plain(A, P, off, sc, sv, fid, use_linear=use_linear)
        torch.cuda.synchronize()
        assert ss.gg_rel_err(G_k, G_p, k) < 1e-4
        assert (G_k[0] == 0).all() and (G_k[5] == 0).all()
        again = ss.slot_stats(A, P, off, sc, sv, fid, use_linear=use_linear, pieces=pieces)
        assert torch.equal(G_k, again)  # deterministic: pieces add in piece order
        assert (pieces.ticket == 0).all()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("onehot", [True, False])
def test_dense_update_kernel_matches_plain(cuda, k, onehot):
    rng = np.random.default_rng(300 + k)
    nc, F = 5000, 70
    col = rng.integers(0, F + 1, nc).astype(np.int32)
    val = np.where(col != F, rng.normal(1, 0.5, nc), 0).astype(np.float32)
    A, colt, valt = _to(cuda, rng.normal(0, 1, (nc, k + 1)).astype(np.float32), col, val)
    th_old = torch.as_tensor(rng.normal(0, 0.3, (F, k + 1)), dtype=torch.float32, device=cuda)
    tab = du.update_table(th_old, th_old + 0.1 * torch.randn_like(th_old))
    v = None if onehot else valt
    A_k = du.dense_update(A.clone(), colt, v, tab)
    A_p = du.dense_update_plain(A.clone(), colt, v, tab)
    torch.cuda.synchronize()
    assert (A_k - A_p).abs().max().item() < 1e-4
    assert torch.equal(A_k[colt == F], A[colt == F])  # cases outside the block


DU_TILE = 32  # cases in a dense_update tile (csrc/dense_update.cu kTile)


def _dense_update_inputs(dev, rng, nc, k, F, covered=None):
    """A, col, val and the update table of a block of F features; with
    `covered` (a bool mask over the cases), the other cases get col == F."""
    col = rng.integers(0, F + 1, nc).astype(np.int32)
    if covered is not None:
        col[~covered] = F
    val = np.where(col != F, rng.normal(1, 0.5, nc), 0).astype(np.float32)
    A, colt, valt = _to(dev, rng.normal(0, 1, (nc, k + 1)).astype(np.float32), col, val)
    th_old = torch.as_tensor(rng.normal(0, 0.3, (F, k + 1)), dtype=torch.float32,
                             device=dev)
    tab = du.update_table(th_old, th_old + 0.1 * torch.randn_like(th_old))
    return A, colt, valt, tab


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("nc", [0, 1, DU_TILE - 3, 5 * DU_TILE, 7 * DU_TILE + 13,
                                40000 * DU_TILE + 9])
def test_dense_update_kernel_tiles(cuda, k, nc):
    """Case counts of no tile, part of one, whole tiles, a ragged tail and
    many tiles a CTA (cases valued); the same bits on a second launch."""
    if nc > 1_000_000 and k > 32:
        nc = 2000 * DU_TILE + 9  # keep A small at the wide rows
    rng = np.random.default_rng(700 + k + nc % 97)
    A, col, val, tab = _dense_update_inputs(cuda, rng, nc, k, 70)
    before = kernels.launch_counts()["dense_update"]
    A_k = du.dense_update(A.clone(), col, val, tab)
    A_k2 = du.dense_update(A.clone(), col, val, tab)
    A_p = du.dense_update_plain(A.clone(), col, val, tab)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["dense_update"] == before + (2 if nc else 0)
    assert torch.equal(A_k, A_k2)  # deterministic
    if nc:
        assert (A_k - A_p).abs().max().item() < 1e-4
    outside = col == 70
    assert torch.equal(A_k[outside], A[outside])


@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("onehot", [True, False])
def test_dense_update_kernel_tiles_outside_the_block(cuda, k, onehot):
    """A block that covers no case leaves A bitwise as it was; one that
    covers a case in every 50th tile only (long runs of tiles that move
    no bytes between stored ones) updates exactly those cases."""
    rng = np.random.default_rng(750 + k)
    nc = 3000 * DU_TILE + 21
    for covered in (np.zeros(nc, bool), np.arange(nc) % (50 * DU_TILE) == 5):
        A, col, val, tab = _dense_update_inputs(cuda, rng, nc, k, 40, covered)
        v = None if onehot else val
        A_k = du.dense_update(A.clone(), col, v, tab)
        A_p = du.dense_update_plain(A.clone(), col, v, tab)
        torch.cuda.synchronize()
        keep = torch.as_tensor(~covered, device=cuda)
        assert torch.equal(A_k[keep], A[keep])
        assert (A_k - A_p).abs().max().item() < 1e-4


@pytest.mark.parametrize("k", [8, 33, 64])
@pytest.mark.parametrize("skew", ["row 0", "4 rows", "zipf"])
def test_dense_update_kernel_skewed_rows(cuda, k, skew):
    """Many cases of a tile on one table row (the kernel copies each
    distinct row of a tile once and its cases share it), beside cases
    outside the block; the same bits on a second launch."""
    rng = np.random.default_rng(780 + k)
    nc, F = 900 * DU_TILE + 11, 50
    A, col, val, tab = _dense_update_inputs(cuda, rng, nc, k, F)
    rows = {"row 0": np.zeros(nc, np.int64), "4 rows": rng.integers(0, 4, nc),
            "zipf": (rng.zipf(1.2, nc) - 1) % F}[skew]
    col = torch.where(col != F, torch.as_tensor(rows, device=cuda), F).to(torch.int32)
    A_k = du.dense_update(A.clone(), col, val, tab)
    A_k2 = du.dense_update(A.clone(), col, val, tab)
    A_p = du.dense_update_plain(A.clone(), col, val, tab)
    torch.cuda.synchronize()
    assert torch.equal(A_k, A_k2)
    assert (A_k - A_p).abs().max().item() < 1e-4
    assert torch.equal(A_k[col == F], A[col == F])


def test_dense_update_kernel_rejects_unaligned_A(cuda):
    """A contiguous A that starts 4 bytes off a 16-byte boundary raises:
    the kernel moves A by bulk copies and has no other path."""
    rng = np.random.default_rng(760)
    nc, k = 500, 8
    A, col, val, tab = _dense_update_inputs(cuda, rng, nc, k, 30)
    buf = torch.zeros(nc * (k + 1) + 4, device=cuda)
    A_off = buf[1:1 + nc * (k + 1)].view(nc, k + 1)
    A_off.copy_(A)
    assert A_off.is_contiguous() and A_off.data_ptr() % 16 == 4
    before = kernels.launch_counts()["dense_update"]
    with pytest.raises(ValueError, match="16-byte"):
        du.dense_update(A_off, col, val, tab)
    assert kernels.launch_counts()["dense_update"] == before
    assert torch.equal(A_off, A)


def test_dense_update_kernel_rejects_unpadded_table(cuda):
    """A table whose rows lie k+2 floats apart (not update_table's
    16-byte pieces) raises: the kernel copies each row as one bulk copy."""
    rng = np.random.default_rng(770)
    A, col, val, tab = _dense_update_inputs(cuda, rng, 300, 8, 30)
    with pytest.raises(ValueError, match="update_table"):
        du.dense_update(A, col, val, tab.contiguous())


FR_ROWS = [0, 7, 1003, 20011]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("L", [1, 2, 5, 13])
def test_fm_refresh_kernel_tiles(cuda, k, L):
    """Row counts of none, part of one tile, ragged tails and many tiles a
    CTA, in both modes, against the plain version; a second launch gives
    the same bits (A, the error sum and the predictions)."""
    rng = np.random.default_rng(800 + k + L)
    n = 700
    P = torch.as_tensor(rng.normal(0, 0.3, (n, k + 1)), dtype=torch.float32, device=cuda)
    w0 = torch.tensor(2.5, device=cuda)
    kw = dict(min_target=1.0, max_target=5.0)
    for nr in FR_ROWS:
        ids, vals, y = _to(
            cuda,
            rng.integers(0, n, (nr, L)).astype(np.int32),
            (rng.normal(1, 0.5, (nr, L)) * (rng.random((nr, L)) < 0.8)).astype(np.float32),
            rng.uniform(1, 5, nr).astype(np.float32),
        )
        A_k, A_k2, A_p = (torch.full((nr, k + 1), 7.0, device=cuda) for _ in range(3))
        s_k = fr.fm_refresh(P, ids, vals, w0, y, A_k, **kw)
        s_k2 = fr.fm_refresh(P, ids, vals, w0, y, A_k2, **kw)
        s_p = fr.fm_refresh_plain(P, ids, vals, w0, y, A_p, **kw)
        p_k = fr.fm_refresh(P, ids, vals, w0, **kw)
        p_k2 = fr.fm_refresh(P, ids, vals, w0, **kw)
        p_p = fr.fm_refresh_plain(P, ids, vals, w0, **kw)
        torch.cuda.synchronize()
        assert p_k.shape == (nr,) and s_k.shape == ()
        assert torch.equal(A_k, A_k2) and torch.equal(s_k, s_k2) and torch.equal(p_k, p_k2)
        if nr:
            assert (A_k - A_p).abs().max().item() < 1e-4
            assert (p_k - p_p).abs().max().item() < 1e-4
        assert abs(s_k.item() - s_p.item()) <= 1e-4 * max(1.0, s_p.item())


def test_fm_refresh_kernel_rejects_unaligned_A(cuda):
    rng = np.random.default_rng(850)
    n, nr, L, k = 100, 300, 2, 16
    P, ids, vals, y = _to(
        cuda,
        rng.normal(0, 0.3, (n, k + 1)).astype(np.float32),
        rng.integers(0, n, (nr, L)).astype(np.int32),
        np.ones((nr, L), np.float32),
        rng.uniform(1, 5, nr).astype(np.float32),
    )
    buf = torch.zeros(nr * (k + 1) + 4, device=cuda)
    A_off = buf[1:1 + nr * (k + 1)].view(nr, k + 1)
    assert A_off.is_contiguous() and A_off.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte"):
        fr.fm_refresh(P, ids, vals, torch.tensor(0.0, device=cuda), y, A_off)
    with pytest.raises(ValueError, match="contiguous"):
        fr.fm_refresh(P, ids, vals, torch.tensor(0.0, device=cuda), y,
                      torch.zeros(k + 1, nr, device=cuda).t())


def test_als_on_cuda_follows_the_cpu_trajectory(cuda):
    """The whole learner on the card (kernels) against the CPU (plain
    versions) from the same initial parameters: ALS has no draws, so the
    trajectories agree up to fp32 summation order."""
    train, test = movielens_like(300, 200, 30000, seed=5)
    n, k = train.num_features, 16
    rng = np.random.default_rng(0)
    init = (np.float32(0.0), rng.normal(0, 0.1, n).astype(np.float32),
            rng.normal(0, 0.1, (n, k)).astype(np.float32))
    cfg = FMConfig(num_features=n, num_factors=k, regw=2.0, regv=2.0)
    runs = {}
    for dev in ("cpu", "cuda"):
        learner = ALSVectorLearner(cfg, num_iter=10, seed=1, verbose=False,
                                   device=dev, init_params=init)
        runs[dev] = learner.learn(train, test)
    for hc, hg in zip(runs["cpu"], runs["cuda"]):
        assert abs(hc["test_this"] - hg["test_this"]) < 1e-4
        assert abs(hc["train"] - hg["train"]) < 1e-4


def _col_rel_err(a, b):
    """Largest difference per column over the column's largest value."""
    return ((a - b).abs().amax(dim=0) / b.abs().amax(dim=0).clamp_min(1e-6)).max().item()


def _sgd_batch(dev, rng, n, B, L, mode, pad=7):
    """A batch with heavy duplicate ids (Zipf over n features) whose last
    `pad` rows are padding (id 0, value 0, row_mask False)."""
    ids = np.minimum(rng.zipf(1.3, (B, L)) - 1, n - 1).astype(np.int32)
    if mode == "general":
        vals = (rng.normal(1, 0.5, (B, L)) * (rng.random((B, L)) < 0.8)).astype(np.float32)
    else:
        vals = np.ones((B, L), np.float32)
    mask = np.ones(B, bool)
    mask[B - pad:] = False
    ids[~mask] = 0
    vals[~mask] = 0.0
    y = rng.choice([-1.0, 1.0], B).astype(np.float32)
    return _to(dev, ids, vals, y, mask)


SGD_KS = [1, 8, 16, 32]
SGD_SHAPES = [("pair", 2), ("onehot", 1), ("onehot", 13), ("general", 1),
              ("general", 2), ("general", 13)]


@pytest.mark.parametrize("k", SGD_KS)
@pytest.mark.parametrize("mode,L", SGD_SHAPES)
@pytest.mark.parametrize("task", [0, 1])
def test_sgd_step_kernel_matches_plain(cuda, k, mode, L, task):
    rng = np.random.default_rng(400 + k + L)
    n, B = 300, 1000
    P = torch.as_tensor(rng.normal(0, 0.3, (n, k + 1)), dtype=torch.float32, device=cuda)
    ids, vals, y, mask = _sgd_batch(cuda, rng, n, B, L, mode)
    if task == 0:
        y = 3.0 + y
    w0 = torch.tensor(0.2, device=cuda)
    kw = dict(mode=mode, task=task, lr1=0.01, lr2=0.02, regw=0.05, regv=0.03,
              min_target=1.0, max_target=5.0)
    before = kernels.launch_counts()["sgd_step"]
    u_k, r_k = sg.sgd_step(P, ids, vals, y, mask, w0, **kw)
    u_p, r_p = sg.sgd_step_plain(P, ids, vals, y, mask, w0, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sgd_step"] == before + 1
    assert u_k.shape == (B * L, k + 1)
    assert _col_rel_err(u_k, u_p) < 1e-4
    assert r_k[1].item() == B - 7
    assert abs(r_k[0].item() - r_p[0].item()) <= 1e-4 * max(1.0, r_p[0].abs().item())
    pad = u_k.reshape(B, L, k + 1)[B - 7:]
    assert (pad == 0).all()


@pytest.mark.parametrize("mode,L", [("pair", 2), ("onehot", 13), ("general", 13)])
@pytest.mark.parametrize("use_linear,use_bias", [(False, True), (True, False), (False, False)])
def test_sgd_step_options_match_plain(cuda, mode, L, use_linear, use_bias):
    rng = np.random.default_rng(7)
    n, B, k = 200, 513, 8
    P = torch.as_tensor(rng.normal(0, 0.3, (n, k + 1)), dtype=torch.float32, device=cuda)
    ids, vals, y, mask = _sgd_batch(cuda, rng, n, B, L, mode)
    w0 = torch.tensor(0.7, device=cuda)
    kw = dict(mode=mode, task=1, lr1=0.01, lr2=0.02, regw=0.05, regv=0.03,
              min_target=-1.0, max_target=1.0, use_linear=use_linear, use_bias=use_bias)
    u_k, r_k = sg.sgd_step(P, ids, vals, y, mask, w0, **kw)
    u_p, r_p = sg.sgd_step_plain(P, ids, vals, y, mask, w0, **kw)
    torch.cuda.synchronize()
    assert _col_rel_err(u_k, u_p) < 1e-4
    if not use_linear:
        assert (u_k[:, 0] == 0).all()
    assert abs(r_k[0].item() - r_p[0].item()) <= 1e-4 * max(1.0, r_p[0].abs().item())


@pytest.mark.parametrize("W", [9, 16, 17, 128])
@pytest.mark.parametrize("heavy", [False, True])
def test_table_scatter_kernel_matches_np_add_at(cuda, W, heavy):
    """np.add.at (a sequential scatter) within f32 rounding of sums over
    up to ~15,000 rows (heavy), and the same bits on every launch: every
    sum is taken in a fixed order."""
    rng = np.random.default_rng(500 + W + heavy)
    n, E = 5000, 70000
    ids = (np.minimum(rng.zipf(1.2, E) - 1, n - 1) if heavy
           else rng.integers(0, n, E)).astype(np.int32)
    upd = rng.standard_normal((E, W)).astype(np.float32)
    T0 = rng.standard_normal((n, W)).astype(np.float32)
    want = T0.copy()
    np.add.at(want, ids, upd)
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    sids, permt, updt, T = _to(cuda, ids[perm], perm, upd, T0.copy())
    T2 = T.clone()
    ts.table_scatter(T, sids, permt, updt)
    ts.table_scatter(T2, sids, permt, updt)
    T_p = ts.table_scatter_plain(torch.as_tensor(T0, device=cuda), sids, permt, updt)
    torch.cuda.synchronize()
    assert torch.equal(T, T2)
    assert _col_rel_err(T, torch.as_tensor(want, device=cuda)) < 1e-5
    assert _col_rel_err(T, T_p) < 1e-5


@pytest.mark.parametrize("W", [16, 128, 200])
@pytest.mark.parametrize("scale,reps", [(1.0, 1), (1.0, 5), (8.0, 5)])
def test_table_read_kernel_matches_plain(cuda, W, scale, reps):
    rng = np.random.default_rng(600 + W + reps)
    nsub, nids = 1000, 5000
    T, ids = _to(cuda, rng.standard_normal((nsub, W)).astype(np.float32),
                 rng.integers(0, nsub, nids).astype(np.int32))
    out_k = tr.table_read(T, ids, reps, scale, n_used=nids - 8)
    out_p = tr.table_read_plain(T, ids, reps, scale, n_used=nids - 8)
    again = tr.table_read(T, ids, reps, scale, n_used=nids - 8)
    torch.cuda.synchronize()
    assert torch.equal(out_k, again)  # deterministic
    assert ((out_k - out_p).abs().max() / out_p.abs().max()).item() < 1e-5


@pytest.mark.parametrize("which", ["ml", "ctr"])
def test_sgd_on_cuda_follows_the_cpu_trajectory(cuda, which):
    """The SGD learner on the card (kernels) against the CPU (plain
    versions) from the same parameters; the card's epoch is also
    deterministic run to run. The steps are small enough (sum-reduced
    over 1000 rows) that f32 rounding differences do not grow."""
    from libfm_tpu_torch.data.synth import ctr_like

    if which == "ml":
        train, test = movielens_like(300, 200, 30000, seed=5)
        task, lr, k = 0, 1e-4, 8
    else:
        train, test, _ = ctr_like(13, 300, 20000, seed=5)
        task, lr, k = 1, 2e-4, 16
    n = train.num_features
    rng = np.random.default_rng(0)
    init = (np.float32(0.0), np.zeros(n, np.float32),
            rng.normal(0, 0.1, (n, k)).astype(np.float32))
    cfg = FMConfig(num_features=n, num_factors=k, regw=0.01, regv=0.01)
    runs = {}
    for dev in ("cpu", "cuda", "cuda"):
        learner = tsgd.SGDLearner(cfg, task=task, num_iter=3, learn_rate=lr,
                                  batch_size=1000, verbose=False, device=dev)
        learner.init_params(FMParams(*(torch.as_tensor(x) for x in init)))
        hist = learner.learn(train, test)
        if dev in runs:
            assert [h[:2] for h in hist] == [h[:2] for h in runs[dev][0]]
            assert torch.equal(learner.params.v.cpu(), runs[dev][1])
        runs[dev] = (hist, learner.params.v.cpu())
    tol = 1e-4 if task == 0 else 1.0 / test.num_rows + 1e-9
    for hc, hg in zip(runs["cpu"][0], runs["cuda"][0]):
        assert abs(hc[0] - hg[0]) <= tol and abs(hc[1] - hg[1]) <= tol
    assert (runs["cpu"][1] - runs["cuda"][1]).abs().max().item() < 1e-3


SCATTER_WIDTHS = [1, 9, 16, 17, 33, 64, 128, 129]


def _sum_err(T, want, mag):
    """A scatter's error against a float64 reference `want`: the largest
    difference per column over the column's largest sum of magnitudes
    `mag` (a long run of random signs cancels, so its sum is no scale)."""
    diff = np.abs(T.double().cpu().numpy() - want).max(axis=0)
    return float((diff / np.maximum(mag.max(axis=0), 1e-12)).max())


def _scatter_ids(rng, layout, E, n):
    """Sorted-order test ids: every id equal (one run over E), runs of 100
    (each spans 2 windows), runs of 5,000 (each spans many windows and
    CTAs), or Zipf(1.2) ids."""
    if layout == "one_run":
        return np.full(E, 7, np.int32)
    if layout in ("runs_100", "runs_5000"):
        length = int(layout.split("_")[1])
        return rng.permutation(np.arange(E) // length % n).astype(np.int32)
    return np.minimum(rng.zipf(1.2, E) - 1, n - 1).astype(np.int32)


@pytest.mark.parametrize("W", SCATTER_WIDTHS)
@pytest.mark.parametrize("layout", ["one_run", "runs_100", "runs_5000", "zipf"])
@pytest.mark.parametrize("form", ["longest_run", "one_round", "long_form"])
def test_table_scatter_kernel_widths_and_runs(cuda, W, layout, form):
    """np.add.at within 1e-5 and the plain version within 1e-4 at every
    width and run length, both in float64 and as a sum's error (per
    column, over the largest sum of magnitudes), with the windows that the
    longest run picks (max_run computed by the wrapper) and with either
    form forced where the width has two; the same bits on a second launch,
    and from update rows already in sorted order (perm=None)."""
    rng = np.random.default_rng(700 + W)
    n, E = 3000, 20011
    ids = _scatter_ids(rng, layout, E, n)
    upd = rng.standard_normal((E, W)).astype(np.float32)
    T0 = rng.standard_normal((n, W)).astype(np.float32)
    # np.add.at in float64 (over one run of 20,011 rows a float32
    # sequential sum errs by more than 1e-5 itself), and the error of a
    # sum: over the column's largest sum of magnitudes
    want, mag = T0.astype(np.float64), np.abs(T0).astype(np.float64)
    np.add.at(want, ids, upd.astype(np.float64))
    np.add.at(mag, ids, np.abs(upd).astype(np.float64))
    perm = np.argsort(ids, kind="stable").astype(np.int32)
    sids, permt, updt, upd_sorted = _to(cuda, ids[perm], perm, upd, upd[perm])
    T, T2, T3, T4 = (torch.as_tensor(T0, device=cuda) for _ in range(4))
    scratch = ts.ScatterScratch(E, W, cuda)
    run = int(ts.longest_runs(ids[perm]))
    max_run = {"longest_run": None, "one_round": 1, "long_form": ts.LONG_RUN + 1}[form]
    before = kernels.launch_counts()["table_scatter"]
    ts.table_scatter(T, sids, permt, updt, scratch=scratch, max_run=max_run)
    ts.table_scatter(T2, sids, permt, updt, scratch=scratch, max_run=max_run)
    ts.table_scatter(T3, sids, None, upd_sorted, max_run=max_run)
    ts.table_scatter(T4, sids, None, upd_sorted, max_run=run if max_run is None else max_run)
    T_p = ts.table_scatter_plain(torch.as_tensor(T0, dtype=torch.float64, device=cuda),
                                 sids, permt, updt.double())
    torch.cuda.synchronize()
    assert kernels.launch_counts()["table_scatter"] == before + 4
    assert torch.equal(T, T2) and torch.equal(T, T3) and torch.equal(T, T4)
    assert _sum_err(T, want, mag) < 1e-5
    assert _sum_err(T, T_p.cpu().numpy(), mag) < 1e-4
    assert scratch.calls == 2


def test_table_scatter_kernel_scratch_reused_across_shapes(cuda):
    """One scratch, sized for the largest call, serves calls of other
    lengths and widths in turn, with the bits of a fresh scratch."""
    rng = np.random.default_rng(9)
    scratch = ts.ScatterScratch(50000, 40, cuda)
    for E, W, layout in ((50000, 9, "runs_5000"), (777, 40, "zipf"), (31, 17, "one_run"),
                         (50000, 17, "runs_100"), (1, 1, "one_run")):
        ids = _scatter_ids(rng, layout, E, 500)
        upd = rng.standard_normal((E, W)).astype(np.float32)
        perm = np.argsort(ids, kind="stable").astype(np.int32)
        want, mag = np.zeros((500, W)), np.zeros((500, W))
        np.add.at(want, ids, upd.astype(np.float64))
        np.add.at(mag, ids, np.abs(upd).astype(np.float64))
        sids, permt, updt = _to(cuda, ids[perm], perm, upd)
        T, T_fresh = torch.zeros(500, W, device=cuda), torch.zeros(500, W, device=cuda)
        ts.table_scatter(T, sids, permt, updt, scratch=scratch)
        ts.table_scatter(T_fresh, sids, permt, updt)
        torch.cuda.synchronize()
        assert torch.equal(T, T_fresh)
        assert _sum_err(T, want, mag) < 1e-5


STEP_KS = [1, 8, 16, 64, 128]
STEP_SHAPES = [("pair", 2), ("onehot", 13), ("general", 13), ("general", 20)]


@pytest.mark.parametrize("k", STEP_KS)
@pytest.mark.parametrize("mode,L", STEP_SHAPES)
def test_sgd_step_kernel_sums_w0_and_order(cuda, k, mode, L):
    """A padded batch: the update rows and red against the plain version;
    red and the rows the same bits on a second launch; w0 updated in the
    launch equal, bit for bit, to the torch line on the returned red; with
    `order`, each entry's row at its sorted position, the same bits."""
    rng = np.random.default_rng(800 + k + L)
    n, B = 400, 3001
    P = torch.as_tensor(rng.normal(0, 0.3, (n, k + 1)), dtype=torch.float32, device=cuda)
    ids, vals, y, mask = _sgd_batch(cuda, rng, n, B, L, mode)
    kw = dict(mode=mode, task=1, lr1=0.01, lr2=0.02, regw=0.05, regv=0.03,
              min_target=-1.0, max_target=1.0)
    lr0, reg0 = 0.003, 0.02
    w0 = torch.tensor(0.2, device=cuda)
    scratch = sg.sgd_step_scratch(cuda)
    u_k, r_k = sg.sgd_step(P, ids, vals, y, mask, w0, scratch=scratch, **kw)
    u_k2, r_k2 = sg.sgd_step(P, ids, vals, y, mask, w0, scratch=scratch, **kw)
    u_p, r_p = sg.sgd_step_plain(P, ids, vals, y, mask, w0, **kw)
    w0_new = w0.clone()
    u_w, r_w = sg.sgd_step(P, ids, vals, y, mask, w0_new, lr0=lr0, reg0=reg0,
                           scratch=scratch, **kw)
    perm = torch.argsort(ids.reshape(-1).long(), stable=True)
    order = torch.empty_like(perm).scatter_(0, perm, torch.arange(B * L, device=cuda))
    order = order.to(torch.int32).reshape(B, L)
    u_o, r_o = sg.sgd_step(P, ids, vals, y, mask, w0, order=order, scratch=scratch, **kw)
    torch.cuda.synchronize()
    assert _col_rel_err(u_k, u_p) < 1e-4
    assert abs(r_k[0].item() - r_p[0].item()) <= 1e-4 * max(1.0, r_p[0].abs().item())
    assert r_k[1].item() == B - 7
    assert torch.equal(r_k, r_k2) and torch.equal(u_k, u_k2)
    assert torch.equal(r_w, r_k) and torch.equal(u_w, u_k)
    assert torch.equal(w0_new, w0 - lr0 * (r_k[0] + r_k[1] * reg0 * w0))
    assert torch.equal(u_o, u_k[perm]) and torch.equal(r_o, r_k)
    assert (scratch[-4:] == 0).all()  # the ticket is left at zero


@pytest.mark.parametrize("which", ["ml", "ctr"])
def test_sgd_epoch_on_cuda_launches_two_kernels_a_batch(cuda, which):
    """The epoch's batch loop: one sgd_step and one table_scatter launch a
    batch, and nothing else of the port's kernels."""
    from libfm_tpu_torch.data.batching import batch_dataset
    from libfm_tpu_torch.data.synth import ctr_like

    if which == "ml":
        train, _ = movielens_like(300, 200, 30000, seed=5)
        task, mode, k = 0, "pair", 8
    else:
        train, _, _ = ctr_like(13, 300, 20000, seed=5)
        task, mode, k = 1, "onehot", 16
    tb = batch_dataset(train, 1000)
    sids, perm = tsgd.sorted_scatter_order(tb.ids)
    arrs = _to(cuda, tb.ids, tb.vals, tb.y, tb.row_mask, sids, perm)
    n = train.num_features
    rng = np.random.default_rng(1)
    params = FMParams(torch.tensor(0.1, device=cuda),
                      *_to(cuda, rng.normal(0, 0.01, n).astype(np.float32),
                           rng.normal(0, 0.1, (n, k)).astype(np.float32)))
    epoch = tsgd.make_epoch_fn(FMConfig(num_features=n, num_factors=k, regw=0.01,
                                        regv=0.01, reg0=0.01), task, mode)
    kernels.reset_launch_counts()
    out = epoch(params, *arrs, (1e-3, 1e-3, 1e-3), -1.0, 5.0)
    torch.cuda.synchronize()
    counts = {name: c for name, c in kernels.launch_counts().items() if c}
    assert counts == {"sgd_step": tb.num_batches, "table_scatter": tb.num_batches}
    assert float(out.w0) != 0.1
    ref = tsgd.make_epoch_fn(FMConfig(num_features=n, num_factors=k, regw=0.01,
                                      regv=0.01, reg0=0.01), task, mode)(
        FMParams(params.w0.cpu(), params.w.cpu(), params.v.cpu()), *(a.cpu() for a in arrs),
        (1e-3, 1e-3, 1e-3), -1.0, 5.0)
    assert abs(float(out.w0) - float(ref.w0)) < 1e-4
    assert (out.v.cpu() - ref.v).abs().max().item() < 1e-4


# ---- probit classification and case-major statistics

def _close(a, b):
    """Largest |a - b| over max(1, |b|)."""
    return ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()


# every compiled form: (KP, items a thread, groups) = (8,1,8) at k=5,
# (16,1,8) at 12, (16,1,4) at 16, (32,1,2) at 20, (64,2,1) at 48,
# (64,3,1) at 64, (128,5,1) at 90, (128,9,1) at 128 (one-hot and valued
# differ in the item count, not the form, but for k=12 valued: (16,1,4))
@pytest.mark.parametrize("k", [5, 12, 16, 20, 48, 64, 90, 128])
@pytest.mark.parametrize("onehot", [True, False])
@pytest.mark.parametrize("use_linear", [True, False])
def test_case_stats_kernel_matches_plain(cuda, k, onehot, use_linear):
    """Lists longer than a piece (3 and 7 pieces of PIECE_LEN slots), a
    feature with none, a fifth of the slots padding; two launches give
    the same bits (the pieces of a feature add in piece order)."""
    from libfm_tpu_torch.kernels import case_stats as cs
    from libfm_tpu_torch.kernels.pieces import Pieces

    rng = np.random.default_rng(900 + k + 2 * onehot + use_linear)
    nc, n = 20000, 300
    counts = np.array([0, 1, 31, 33, 2 * cs.PIECE_LEN + 5, 97, 7 * cs.PIECE_LEN, 3])
    # a block: no case in two lists, each list in case order
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    sc = rng.permutation(nc)[:off[-1]].astype(np.int32)
    for a, b in zip(off[:-1], off[1:]):
        sc[a:b].sort()
    sc[rng.random(len(sc)) < 0.2] = nc
    sv = (np.where(sc < nc, 1.0, 0.0) if onehot
          else rng.normal(1.0, 0.5, len(sc))).astype(np.float32)
    fid = rng.choice(n, len(counts), replace=False).astype(np.int32)
    A, P, off, sc, sv, fid = _to(
        cuda,
        rng.normal(0, 1, (nc, k + 1)).astype(np.float32),
        rng.normal(0, 0.3, (n, k + 1)).astype(np.float32),
        off, sc, sv, fid,
    )
    pieces = Pieces(off, cuda)
    before = kernels.launch_counts()["case_stats"]
    kw = dict(onehot=onehot, use_linear=use_linear)
    G_k = cs.case_stats(A, P, off, sc, sv, fid, pieces=pieces, **kw)
    G_k2 = cs.case_stats(A, P, off, sc, sv, fid, pieces=pieces, **kw)
    G_p = cs.case_stats_plain(A, P, off, sc, sv, fid, **kw)
    G_s = ss.slot_stats_plain(A, P, off, sc, sv, fid, use_linear=use_linear)
    ref, scale = cs.case_stats_reference(A, P, off, sc, sv, fid, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["case_stats"] == before + 2
    assert torch.equal(G_k, G_k2) and (pieces.ticket == 0).all()
    assert (G_k[0] == 0).all()
    assert ss.gg_rel_err(G_k, G_p, k) < 1e-4
    assert ss.gg_rel_err(G_k, G_s, k) < 1e-4
    assert cs.err_over_magnitudes(G_k, ref, scale) < CASE_STATS_TOL


@pytest.mark.parametrize("k", [8, 16, 64])
@pytest.mark.parametrize("mode", ["sample", "mean"])
def test_fm_refresh_probit_kernel_matches_plain(cuda, k, mode):
    """Q and pred = e + latent against the plain version within 1e-4; the
    latents within 1e-5 (relative above 1) of the plain draw on the
    kernel's predictions where the draw lies within 2.5 of its mean (the
    predictions come back as e + latent, to an ulp, and further out the
    draw turns that ulp into more; chip_smoke.LATENT_CHECKED), on y's side
    of 0 everywhere; the count of correct cases within 3 of the plain
    count (pred near 0 may round to either side)."""
    from libfm_tpu_torch.ops.samplers import probit_latent as draw

    rng = np.random.default_rng(950 + k)
    n, nr, L = 600, 20011, 5
    P, ids, vals, y, U = _to(
        cuda,
        rng.normal(0, 0.5, (n, k + 1)).astype(np.float32),
        rng.integers(0, n, (nr, L)).astype(np.int32),
        rng.normal(1, 0.5, (nr, L)).astype(np.float32),
        rng.choice([-1.0, 1.0], nr).astype(np.float32),
        rng.random(nr).astype(np.float32),
    )
    U = U if mode == "sample" else None
    w0 = torch.tensor(0.3, device=cuda)
    A_k, A_p = (torch.empty(nr, k + 1, device=cuda) for _ in range(2))
    lat_k, lat_p = (torch.empty(nr, device=cuda) for _ in range(2))
    before = kernels.launch_counts()
    c_k = fr.fm_refresh(P, ids, vals, w0, y, A_k, probit=mode, U=U, latent=lat_k)
    c_p = fr.fm_refresh_plain(P, ids, vals, w0, y, A_p, probit=mode, U=U, latent=lat_p)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["fm_refresh_probit"] == before["fm_refresh_probit"] + 1
    assert after["fm_refresh"] == before["fm_refresh"]
    pred_k = A_k[:, 0] + lat_k
    ref = draw(pred_k, y, U)
    near = (ref - pred_k).abs() <= 2.5 if U is not None else torch.ones_like(y, dtype=bool)
    assert (A_k[:, 1:] - A_p[:, 1:]).abs().max().item() < 1e-4
    assert (pred_k - (A_p[:, 0] + lat_p)).abs().max().item() < 1e-4
    assert _close(lat_k[near], ref[near]) < 1e-5
    assert near.float().mean().item() > 0.5
    assert abs(float(c_k) - float(c_p)) <= 3
    assert ((lat_k >= 0) == (y >= 0)).all()


@pytest.mark.parametrize("k", [1, 16, 128])
@pytest.mark.parametrize("mode", ["sample", "mean"])
def test_probit_latent_kernel_matches_plain(cuda, k, mode):
    """Predictions e + latent up to |12|, 1.8M cases (the strided e column
    of config #4's A): the same count, latents and e within 1e-5 (relative
    above 1), the other columns of A untouched."""
    from libfm_tpu_torch.kernels import probit_latent as pl

    rng = np.random.default_rng(990 + k)
    nc = 1_800_000 if k == 16 else 30011
    A, lat, y, U = _to(
        cuda,
        rng.normal(0, 4, (nc, k + 1)).astype(np.float32),
        rng.normal(0, 2, nc).astype(np.float32),
        rng.choice([-1.0, 1.0], nc).astype(np.float32),
        rng.random(nc).astype(np.float32),
    )
    U = U if mode == "sample" else None
    A_k, A_p, lat_k, lat_p = A.clone(), A.clone(), lat.clone(), lat.clone()
    before = kernels.launch_counts()["probit_latent"]
    c_k = pl.probit_latent(A_k, lat_k, y, U)
    c_p = pl.probit_latent_plain(A_p, lat_p, y, U)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["probit_latent"] == before + 1
    assert float(c_k) == float(c_p)
    assert _close(lat_k, lat_p) < 1e-5
    assert _close(A_k[:, 0], A_p[:, 0]) < 1e-5
    assert torch.equal(A_k[:, 1:], A[:, 1:])
    assert ((lat_k >= 0) == (y >= 0)).all()


@pytest.mark.parametrize("mode", ["sample", "mean"])
def test_probit_kernels_in_the_tail(cuda, mode):
    """Predictions at +-12 on the wrong side of 0: every latent sits at
    the truncation point, in both kernels."""
    from libfm_tpu_torch.kernels import probit_latent as pl

    nc, k = 4096, 4
    y = torch.where(torch.arange(nc, device=cuda) % 2 == 0, 1.0, -1.0)
    pred = -12.0 * y
    U = torch.rand(nc, device=cuda) if mode == "sample" else None
    A = torch.zeros(nc, k + 1, device=cuda)
    A[:, 0] = pred
    lat = torch.zeros(nc, device=cuda)
    pl.probit_latent(A, lat, y, U)
    torch.cuda.synchronize()
    lat_p = torch.zeros(nc, device=cuda)
    A_p = torch.zeros(nc, k + 1, device=cuda)
    A_p[:, 0] = pred
    pl.probit_latent_plain(A_p, lat_p, y, U)
    assert _close(lat, lat_p) < 1e-5
    assert (lat * y >= 0).all() and (lat.abs() < (0.1 if mode == "mean" else 1e-5)).all()


def test_als_classification_on_cuda_follows_the_cpu_trajectory(cuda):
    """ALS probit (latents as expectations, case-major statistics) on the
    card against the CPU from the same initial parameters."""
    from libfm_tpu_torch.data.synth import ctr_like
    from libfm_tpu_torch.tasks import TASK_CLASSIFICATION

    train, test, groups = ctr_like(5, 300, 30000, seed=5)
    n, k = train.num_features, 16
    rng = np.random.default_rng(0)
    init = (np.float32(0.0), rng.normal(0, 0.1, n).astype(np.float32),
            rng.normal(0, 0.1, (n, k)).astype(np.float32))
    cfg = FMConfig(num_features=n, num_factors=k, regw=2.0, regv=2.0)
    runs = {}
    for dev in ("cpu", "cuda"):
        kernels.reset_launch_counts()
        learner = ALSVectorLearner(cfg, task=TASK_CLASSIFICATION, num_iter=10, seed=1,
                                   verbose=False, device=dev, init_params=init,
                                   attr_group=groups)
        runs[dev] = learner.learn(train, test)
        counts = kernels.launch_counts()
    assert counts["case_stats"] == 5 * 10 and counts["slot_stats"] == 0
    assert counts["fm_refresh_probit"] == 3 and counts["probit_latent"] == 7
    for hc, hg in zip(runs["cpu"], runs["cuda"]):
        assert abs(hc["test_this_m2"] - hg["test_this_m2"]) < 1e-4
        assert abs(hc["train"] - hg["train"]) <= 3.0 / train.num_rows

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
are not update_table's 16-byte pieces). SGDA's two kernels at k 1-128,
G 1, 2, 13 and the most the lambda step takes, in each mode, with
padded rows and on a batch of one id, the lambda step at batches of
1 to 32,768 rows and with S's columns in tiles (G (1+k) above 7,168),
and the learner against the CPU. rel_stats on a feature of every block
row (2,000 entries in many batches). slot_update (K4b) at k 4-128,
one-hot and valued, a twentieth and all of the cases covered, against its
plain version and dense_update on the same block; dense_update on the
incremental test tail's view of A; ALS with dense_update=False and with
the test tail on the card against the CPU, with exact launches.
rel_cache's wide form at k 3-128 over rows of 0, 1 and several hundred
cases; schur_draw's relational form (K10's update folded in) at k 1-128,
with and without the linear term, every draw rejected or none, and with
a feature on every block row. rel_deferred (K10's closed-form sums) at
k 1, 32 and 128 over 0 to 4,000 block rows, within one float32 ulp of
its plain version, one launch a call, the same bits twice; rel_resync
in both modes at k 1-128 on a case count off its run and on A at each
offset within 16 bytes, and the same bits under runs of 4 to 256 cases.
rel_scores over one and two relations' stacked designs in one launch (k
1, 3, 32 and 128; rows of 40 entries), and the BS ALS over two relations
with one rel_scores launch a call; probit_latent's residual sums, with a
NaN and an overflowing residual. rel_refresh with main rows beside two
relations (k 8-128, L 1 and 3, rows
with no main entry, train, tail and test modes) and its
probit mode (sampling and expectations); rel_refresh's tiles at 1, 31,
33 and 2^20 + 5 cases, L 0-13, one and two relations, in every mode, A
off 16 bytes; sgda_step under each form of its plan (rows gathered
again, regularizers in shared or global memory); and the BS ALS with a main
table, regression and probit, on the card against the CPU with exact
launches. The exact engines' coord_draw and rel_coord_draw under launch
plans that put a block's features in each class (a warp, a CTA, pieces
with a second launch), in each mode; rel_cache's narrow form over two
columns (rel_cache_cols), strided and contiguous. case_stats under its
launch plan at every k in 1-128 (a feature of several pieces, one of a
CTA, many of one slot), one-hot and valued; slot_update on a block's
slots in case order, the same bits as in feature order. Two MCMC runs at
one seed end in the same bits, on the flat vector engine (regression and
probit), the exact engine and the BS vector engine; an MCMC run with an
rlog makes the launches, and ends in the bits, of one without. The pure
linear model (k = 0) on the flat engine's seven kernels (fm_refresh in
every mode, case_stats, slot_stats, schur_draw's scalar draw,
dense_update, slot_update, probit_latent at a stride of 1) and its ALS
on each route against the CPU; a checkpoint resumed twice on the card
(the CUDA generator's state in it), the same bits, on four engines.
Tolerances as in chip_smoke.py: fp32 sums taken in another order.
"""

import itertools

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
from libfm_tpu_torch.kernels import slot_update as su
from libfm_tpu_torch.kernels import table_read as tr
from libfm_tpu_torch.kernels import table_scatter as ts
from libfm_tpu_torch.learners import sgd as tsgd
from libfm_tpu_torch.learners.mcmc_vector import ALSVectorLearner
from libfm_tpu_torch.models.fm import FMConfig, FMParams
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION

pytestmark = pytest.mark.cuda

KS = [1, 5, 8, 32, 64, 128]
# the flat engine's kernels also take the pure linear model (k = 0)
KS_FLAT = [0] + KS
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


@pytest.mark.parametrize("k", KS_FLAT)
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


@pytest.mark.parametrize("k", KS_FLAT)
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


@pytest.mark.parametrize("k", KS_FLAT)
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


@pytest.mark.parametrize("k", KS_FLAT)
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


@pytest.mark.parametrize("k", KS_FLAT)
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


# k = 0 takes slot_update_k0; at k = 1 and 2 a row past A's last whole
# 16-byte piece has no bulk copy (the case-order test's A ends there)
SU_KS = [0, 1, 2, 4, 16, 32, 128]


@pytest.mark.parametrize("k", SU_KS)
@pytest.mark.parametrize("onehot", [True, False])
@pytest.mark.parametrize("coverage", [0.05, 1.0])
def test_slot_update_kernel_matches_plain(cuda, k, onehot, coverage):
    """slot_update on a block's slots (grouped by feature, each case once,
    a few features with no slot) against its plain version and against
    dense_update on the same block; cases outside the block untouched; the
    same bits on a second launch; one launch a call."""
    rng = np.random.default_rng(900 + k + int(coverage * 10))
    nc, F = 20_000, 300
    case = rng.choice(nc, int(coverage * nc), replace=False).astype(np.int32)
    feat = np.sort(rng.integers(0, F - 3, case.size)).astype(np.int32)
    val = (np.ones(case.size) if onehot else rng.normal(1, 0.5, case.size)).astype(np.float32)
    col = np.full(nc, F, np.int32)
    col[case] = feat
    x = np.zeros(nc, np.float32)
    x[case] = val
    A, ct, vt, ft, colt, xt = _to(cuda, rng.normal(0, 1, (nc, k + 1)).astype(np.float32),
                                  case, val, feat, col, x)
    th_old = torch.as_tensor(rng.normal(0, 0.3, (F, k + 1)), dtype=torch.float32, device=cuda)
    tab = du.update_table(th_old, th_old + 0.1 * torch.randn_like(th_old))
    before = kernels.launch_counts()["slot_update"]
    A_k = su.slot_update(A.clone(), ct, vt, ft, tab)
    A_k2 = su.slot_update(A.clone(), ct, vt, ft, tab)
    A_p = su.slot_update_plain(A.clone(), ct, vt, ft, tab)
    A_d = du.dense_update(A.clone(), colt, None if onehot else xt, tab)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["slot_update"] == before + 2
    assert torch.equal(A_k, A_k2)
    assert _col_rel_err(A_k, A_p) < 1e-5
    assert _col_rel_err(A_k, A_d) < 1e-5
    outside = colt == F
    assert torch.equal(A_k[outside], A[outside])


def test_slot_update_kernel_takes_no_slot_and_refuses_wide_k(cuda):
    A = torch.zeros(8, 5, device=cuda)
    none = torch.zeros(0, dtype=torch.int32, device=cuda)
    tab = du.update_table(torch.zeros(3, 5, device=cuda), torch.ones(3, 5, device=cuda))
    before = kernels.launch_counts()["slot_update"]
    su.slot_update(A, none, none.float(), none, tab)
    assert kernels.launch_counts()["slot_update"] == before
    assert not A.any()
    wide = torch.zeros(2, 131, device=cuda)
    th = torch.zeros(1, 131, device=cuda)
    one = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="k=130"):
        su.slot_update(wide, one, one.float(), one, du.update_table(th, th))


@pytest.mark.parametrize("offset_rows", [4, 1000])
def test_dense_update_on_the_test_tail_view(cuda, offset_rows):
    """dense_update on a view of A past its train rows at an offset of
    whole 16-byte pieces (the incremental test tail) touches only the
    view's rows and agrees with its plain version."""
    rng = np.random.default_rng(950 + offset_rows)
    k, nt, F = 64, 5000, 70
    rows = torch.as_tensor(rng.normal(0, 1, (offset_rows + nt, k + 1)).astype(np.float32),
                           device=cuda)
    col, _ = _to(cuda, rng.integers(0, F + 1, nt).astype(np.int32), np.zeros(1))
    th_old = torch.as_tensor(rng.normal(0, 0.3, (F, k + 1)), dtype=torch.float32, device=cuda)
    tab = du.update_table(th_old, th_old + 0.1 * torch.randn_like(th_old))
    got = rows.clone()
    du.dense_update(got[offset_rows:], col, None, tab)
    want = du.dense_update_plain(rows[offset_rows:].clone(), col, None, tab)
    torch.cuda.synchronize()
    assert torch.equal(got[:offset_rows], rows[:offset_rows])
    assert (got[offset_rows:] - want).abs().max().item() < 1e-4


@pytest.mark.parametrize("option", ["dense_update_off", "flat_incr_test"])
def test_als_k4b_options_on_cuda_follow_the_cpu_trajectory(cuda, option):
    """ALS with the slot scatter on every block, or with the incremental
    test tail, on the card against the CPU from the same initial
    parameters, within 1e-4 at every iteration; the card launches
    slot_update twice an iteration and no dense_update (the scatter), or
    dense_update four times an iteration (two train blocks, two tails)."""
    train, test = movielens_like(300, 200, 30000, seed=5)
    n, k, iters = train.num_features, 16, 6
    rng = np.random.default_rng(0)
    init = (np.float32(0.0), rng.normal(0, 0.1, n).astype(np.float32),
            rng.normal(0, 0.1, (n, k)).astype(np.float32))
    cfg = FMConfig(num_features=n, num_factors=k, regw=2.0, regv=2.0)
    kw = dict(dense_update=False) if option == "dense_update_off" else {}
    runs = {}
    for dev in ("cpu", "cuda"):
        kernels.reset_launch_counts()
        learner = ALSVectorLearner(cfg, num_iter=iters, seed=1, verbose=False, device=dev,
                                   init_params=init, **kw)
        learner.flat_incr_test = option == "flat_incr_test"
        runs[dev] = learner.learn(train, test)
        assert learner.incr_test is (option == "flat_incr_test")
    counts = kernels.launch_counts()
    if option == "dense_update_off":
        assert (counts["slot_update"], counts["dense_update"]) == (2 * iters, 0)
    else:
        assert (counts["slot_update"], counts["dense_update"]) == (0, 4 * iters)
    for hc, hg in zip(runs["cpu"], runs["cuda"], strict=True):
        assert abs(hc["test_this"] - hg["test_this"]) < 1e-4, (hc, hg)
        assert abs(hc["train"] - hg["train"]) < 1e-4, (hc, hg)


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


@pytest.mark.parametrize("W", [7, 16, 128, 130, 200])
@pytest.mark.parametrize("nsub,n_used,scale,reps", [
    (1000, 4992, 1.0, 1), (1000, 4992, 1.0, 5), (1000, 4992, 8.0, 5),  # shared form
    (1000, 0, 1.0, 3),  # no ids
    (37, 4992, 1.0, 50),  # more reps than rows
    (60_000, 4992, 1.0, 5),  # past a one-column slice: the l2 form
])
def test_table_read_kernel_matches_plain(cuda, W, nsub, n_used, scale, reps):
    """Both forms of read_plan against the plain version (relative to the
    largest lane, as chip_smoke.py holds P1 and P3), ids up to 3 nsub
    (reduced mod nsub when staged), and the same bits on a second call."""
    rng = np.random.default_rng(600 + W + reps + nsub)
    T, ids = _to(cuda, rng.standard_normal((nsub, W)).astype(np.float32),
                 rng.integers(0, 3 * nsub, n_used + 8).astype(np.int32))
    plan = tr.read_plan(nsub, W, n_used, reps, torch.cuda.get_device_properties(cuda)
                        .multi_processor_count)
    assert plan.form == ("l2" if nsub == 60_000 else "shared")
    out_k = tr.table_read(T, ids, reps, scale, n_used=n_used)
    out_p = tr.table_read_plain(T, ids, reps, scale, n_used=n_used)
    again = tr.table_read(T, ids, reps, scale, n_used=n_used)
    torch.cuda.synchronize()
    assert torch.equal(out_k, again)  # deterministic
    if n_used == 0:
        assert torch.equal(out_k, torch.zeros_like(out_k))
    else:
        assert ((out_k - out_p).abs().max() / out_p.abs().max()).item() < 1e-5


@pytest.mark.parametrize("W", [7, 128, 130, 528, 600])
def test_table_read_wide_tables_match_plain(cuda, W):
    """The shared form up to as many slices as SMs (W = 528: 132 slices
    of 4 columns, one CTA each, a cooperative launch), the l2 form past
    them (W = 600: 150 slices), each against the plain version and the
    same bits on a second call."""
    rng = np.random.default_rng(700 + W)
    nsub, n_used, reps, scale = 1000, 4992, 5, 8.0
    T, ids = _to(cuda, rng.standard_normal((nsub, W)).astype(np.float32),
                 rng.integers(0, nsub, n_used).astype(np.int32))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = tr.read_plan(nsub, W, n_used, reps, sms)
    if -(-W // 4) <= sms:
        assert (plan.form, plan.cols) == ("shared", 4) and plan.slices * plan.groups <= sms
    else:
        assert plan.form == "l2"
    assert (plan.form == "l2") == (W == 600)  # on a card of 132 SMs
    out_k = tr.table_read(T, ids, reps, scale, n_used)
    out_p = tr.table_read_plain(T, ids, reps, scale, n_used)
    again = tr.table_read(T, ids, reps, scale, n_used)
    torch.cuda.synchronize()
    assert torch.equal(out_k, again)
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
    assert torch.equal(w0_new, sg.sgd_w0_update(w0, lr0, r_k[0], r_k[1], reg0))
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


# every compiled form (the padded width KP 4-128: a warp a team to 32, a
# CTA above) at k = 5, 12, 16, 20, 48, 64, 90 and 128
@pytest.mark.parametrize("k", [0, 5, 12, 16, 20, 48, 64, 90, 128])
@pytest.mark.parametrize("onehot", [True, False])
@pytest.mark.parametrize("use_linear", [True, False])
def test_case_stats_kernel_matches_plain(cuda, k, onehot, use_linear):
    """Lists longer than a piece (2 and 3 pieces of the plan's piece_len
    slots, one just past the short length), a feature with none, a fifth
    of the slots padding; two launches give the same bits (the pieces of a
    feature add in piece order) and leave the ticket zero."""
    from libfm_tpu_torch.kernels import case_stats as cs

    rng = np.random.default_rng(900 + k + 2 * onehot + use_linear)
    nc, n = 24000, 300
    piece = cs.PIECE_SLOTS[k <= 32]
    counts = np.array([0, 1, 31, 33, 2 * piece + 5, 97, 3 * piece, 3, cs.SHORT_LEN + 1])
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
    plan = cs.CaseStatsPlan(off, k, cuda)
    before = kernels.launch_counts()["case_stats"]
    kw = dict(onehot=onehot, use_linear=use_linear)
    G_k = cs.case_stats(A, P, off, sc, sv, fid, pieces=plan, **kw)
    G_k2 = cs.case_stats(A, P, off, sc, sv, fid, pieces=plan, **kw)
    G_p = cs.case_stats_plain(A, P, off, sc, sv, fid, **kw)
    G_s = ss.slot_stats_plain(A, P, off, sc, sv, fid, use_linear=use_linear)
    ref, scale = cs.case_stats_reference(A, P, off, sc, sv, fid, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["case_stats"] == before + 2
    assert torch.equal(G_k, G_k2) and (plan.ticket == 0).all()
    assert (G_k[0] == 0).all()
    assert ss.gg_rel_err(G_k, G_p, k) < 1e-4
    assert ss.gg_rel_err(G_k, G_s, k) < 1e-4
    assert cs.err_over_magnitudes(G_k, ref, scale) < CASE_STATS_TOL


@pytest.mark.parametrize("k", [0, 8, 16, 64])
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
    assert k == 0 or (A_k[:, 1:] - A_p[:, 1:]).abs().max().item() < 1e-4
    assert (pred_k - (A_p[:, 0] + lat_p)).abs().max().item() < 1e-4
    assert _close(lat_k[near], ref[near]) < 1e-5
    assert near.float().mean().item() > 0.5
    assert abs(float(c_k) - float(c_p)) <= 3
    assert ((lat_k >= 0) == (y >= 0)).all()


@pytest.mark.parametrize("k", [0, 1, 16, 128])
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
    A_2, lat_2 = A.clone(), lat.clone()
    before = kernels.launch_counts()["probit_latent"]
    c_k, se_k, se2_k = pl.probit_latent(A_k, lat_k, y, U)
    c_p, se_p, se2_p = pl.probit_latent_plain(A_p, lat_p, y, U)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["probit_latent"] == before + 1
    assert float(c_k) == float(c_p)
    assert _close(lat_k, lat_p) < 1e-5
    assert _close(A_k[:, 0], A_p[:, 0]) < 1e-5
    assert torch.equal(A_k[:, 1:], A[:, 1:])
    assert ((lat_k >= 0) == (y >= 0)).all()
    # the residual sums (fp32 in another order: within 1e-5 of the sum of
    # magnitudes), and the same bits from a second launch
    assert abs(se_k.item() - se_p.item()) <= 1e-5 * A_p[:, 0].abs().sum().item()
    assert abs(se2_k.item() - se2_p.item()) <= 1e-5 * se2_p.item()
    again = pl.probit_latent(A_2, lat_2, y, U)
    assert all(torch.equal(a, b) for a, b in zip((c_k, se_k, se2_k), again))
    assert torch.equal(A_2, A_k) and torch.equal(lat_2, lat_k)


@pytest.mark.parametrize("mode", ["sample", "mean"])
def test_probit_latent_sums_count_non_finite_squares(cuda, mode):
    """A NaN residual and one whose square overflows each count 1e30 in
    sum_e2, as draw_alpha counts them; sum_e is NaN, as torch's sum."""
    from libfm_tpu_torch.kernels import probit_latent as pl

    nc = 70_000
    rng = np.random.default_rng(3)
    A, lat, y, U = _to(cuda, rng.normal(0, 2, (nc, 5)).astype(np.float32),
                       np.zeros(nc, np.float32), np.ones(nc, np.float32),
                       rng.random(nc).astype(np.float32))
    A[3, 0], A[60_001, 0] = float("nan"), -1e20
    U = U if mode == "sample" else None
    A_p, lat_p = A.clone(), lat.clone()
    _, se_k, se2_k = pl.probit_latent(A, lat, y, U)
    _, se_p, se2_p = pl.probit_latent_plain(A_p, lat_p, y, U)
    torch.cuda.synchronize()
    assert torch.isnan(se_k) and torch.isnan(se_p)
    assert 2e30 <= se2_k.item() < 3e30
    assert abs(se2_k.item() - se2_p.item()) <= 1e-5 * se2_p.item()


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


# ---- SGDA (K13): sgda_step and sgda_lambda

SGDA_KS = [1, 8, 16, 64, 128]
SGDA_SHAPES = [("pair", 2), ("onehot", 13), ("general", 13)]
SGDA_GROUPS = [1, 2, 13, "most"]  # "most": the most G sgda_lambda holds in one tile at k


def _sgda_inputs(dev, rng, k, G, mode, L, task, n=400, B=1000, same_id=False, pad=7):
    """A batch padded in its last `pad` rows (Zipf ids, or every id 7),
    its scatter plan, and a state: P, Gc [n+1, 1+k] (row n a sentinel no
    step may write), w0, the groups arange(n) % G and the regularizers,
    half 0, half in [0, 0.05)."""
    from libfm_tpu_torch.learners.sgda import sgda_scatter_plan

    ids, vals, y, mask = _sgd_batch(dev, rng, n, B, L, mode, pad=pad)
    if same_id:
        ids = torch.where(mask[:, None], torch.full_like(ids, 7), ids)
    if task == 0:
        y = 3.0 + y
    _, order, gc_row, n_real = sgda_scatter_plan(ids.cpu().numpy()[None],
                                                 vals.cpu().numpy()[None], n)
    P = torch.as_tensor(rng.normal(0, 0.3, (n, k + 1)), dtype=torch.float32, device=dev)
    Gc = torch.as_tensor(rng.normal(0, 0.1, (n + 1, k + 1)), dtype=torch.float32,
                         device=dev)
    f32 = np.float32
    reg_w = rng.random(G).astype(f32) * 0.05 * (rng.random(G) < 0.5)
    reg_v = rng.random((G, k)).astype(f32) * 0.05 * (rng.random((G, k)) < 0.5)
    groups = (np.arange(n) % G).astype(np.int32)
    return dict(ids=ids, vals=vals, y=y, mask=mask, P=P, Gc=Gc,
                w0=torch.tensor(0.2, device=dev),
                groups=torch.as_tensor(groups, device=dev),
                reg_w=torch.as_tensor(reg_w, device=dev),
                reg_v=torch.as_tensor(reg_v, device=dev),
                order=torch.as_tensor(order[0], device=dev),
                gc_row=torch.as_tensor(gc_row[0], device=dev), n_real=int(n_real[0]))


def _most_groups(G, k):
    from libfm_tpu_torch.kernels.sgda_lambda import groups_in_one_tile

    return groups_in_one_tile(k) if G == "most" else G


@pytest.mark.parametrize("k", SGDA_KS)
@pytest.mark.parametrize("mode,L", SGDA_SHAPES)
@pytest.mark.parametrize("G", SGDA_GROUPS)
@pytest.mark.parametrize("task", [0, 1])
def test_sgda_step_kernel_matches_plain(cuda, k, mode, L, G, task):
    """The update rows at their sorted positions, the batch sum and the
    cache rows against the plain version; w0 moved in the launch equal,
    bit for bit, to `w0_update` on the returned sum; the padded slots
    write no cache row (row 0, which they address, holds its last real
    entry's gradients) and row n is never written; the same bits on a
    second launch."""
    from libfm_tpu_torch.kernels import sgda_step as sa

    G = _most_groups(G, k)
    rng = np.random.default_rng(900 + k + L + G + task)
    s = _sgda_inputs(cuda, rng, k, G, mode, L, task)
    kw = dict(mode=mode, task=task, lr=0.05, min_target=1.0, max_target=5.0)
    args = (s["ids"], s["vals"], s["y"], s["mask"])
    Gc_k, Gc_p, Gc_2 = s["Gc"].clone(), s["Gc"].clone(), s["Gc"].clone()
    w0_k, w0_p = s["w0"].clone(), s["w0"].clone()
    rest = (s["gc_row"], s["groups"], s["reg_w"], s["reg_v"])
    before = kernels.launch_counts()["sgda_step"]
    u_k, r_k = sa.sgda_step(s["P"], *args, w0_k, Gc_k, *rest, order=s["order"], **kw)
    u_2, r_2 = sa.sgda_step(s["P"], *args, s["w0"].clone(), Gc_2, *rest, order=s["order"],
                            **kw)
    u_p, r_p = sa.sgda_step_plain(s["P"], *args, w0_p, Gc_p, *rest, order=s["order"], **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sgda_step"] == before + 2
    assert torch.equal(u_k, u_2) and torch.equal(r_k, r_2) and torch.equal(Gc_k, Gc_2)
    m = s["n_real"]
    assert _col_rel_err(u_k[:m], u_p[:m]) < 1e-4
    assert (u_k[m:] == 0).all()  # the slots keyed to n: padding and values 0
    assert abs(r_k[0].item() - r_p[0].item()) <= 1e-4 * max(1.0, r_p[0].abs().item())
    assert torch.equal(w0_k, sa.w0_update(s["w0"], 0.05, r_k[0]))
    n = s["P"].shape[0]
    assert _col_rel_err(Gc_k[:n], Gc_p[:n]) < 1e-4
    written = torch.zeros(n + 1, dtype=torch.bool, device=cuda)
    written[s["gc_row"].reshape(-1).long()] = True
    written[n] = False
    assert torch.equal(Gc_k[~written], s["Gc"][~written])  # row n among them
    if mode != "general":  # row 0: padded slots address it, its real entries write it
        assert written[0] and not torch.equal(Gc_k[0], s["Gc"][0])


@pytest.mark.parametrize("k", SGDA_KS)
@pytest.mark.parametrize("mode,L", SGDA_SHAPES)
@pytest.mark.parametrize("G", SGDA_GROUPS)
@pytest.mark.parametrize("task", [0, 1])
def test_sgda_lambda_kernel_matches_plain(cuda, k, mode, L, G, task):
    """reg_w and reg_v after one lambda step against the plain version: the
    largest difference over the largest step the plain version takes (the
    clamp at 0 moves neither further); the same bits on a second launch;
    the tickets left at zero."""
    from libfm_tpu_torch.kernels import sgda_lambda as sl

    G = _most_groups(G, k)
    rng = np.random.default_rng(1900 + k + L + G + task)
    s = _sgda_inputs(cuda, rng, k, G, mode, L, task)
    regs, scratch = _lambda_step_twice(cuda, s, k, G, mode, task)
    assert torch.equal(regs[0][0], regs[1][0]) and torch.equal(regs[0][1], regs[1][1])
    assert (scratch[:sl.TICKET_FLOATS] == 0).all()
    _hold_lambda_step(regs[0], regs[2], s)


def _hold_lambda_step(got, plain, s):
    """The kernel's regularizers within 1e-4 of the plain version's largest
    step (the clamp at 0 moves neither further), and none negative."""
    for j, old in ((1, s["reg_v"]), (0, s["reg_w"])):
        step = (plain[j] - old).abs().max().item()
        assert (got[j] - plain[j]).abs().max().item() <= 1e-4 * max(step, 1e-12)
        assert (got[j] >= 0).all()


def _lambda_step_twice(cuda, s, k, G, mode, task=0):
    """Two kernel launches and the plain version from the same state:
    (first, second, plain) regularizers, and the scratch."""
    from libfm_tpu_torch.kernels import sgda_lambda as sl

    kw = dict(mode=mode, task=task, lr=0.05, min_target=1.0, max_target=5.0)
    args = (s["P"], s["Gc"], s["ids"], s["vals"], s["y"], s["mask"], s["w0"], s["groups"])
    regs = [(s["reg_w"].clone(), s["reg_v"].clone()) for _ in range(3)]
    scratch = sl.sgda_lambda_scratch(G, k, cuda)
    before = kernels.launch_counts()["sgda_lambda"]
    sl.sgda_lambda(*args, *regs[0], scratch=scratch, **kw)
    sl.sgda_lambda(*args, *regs[1], scratch=scratch, **kw)
    sl.sgda_lambda_plain(*args, *regs[2], **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sgda_lambda"] == before + 2
    return regs, scratch


@pytest.mark.parametrize("k,G", [(128, 64), (16, 500)])
@pytest.mark.parametrize("mode,L", SGDA_SHAPES)
def test_sgda_lambda_kernel_takes_columns_in_tiles(cuda, k, G, mode, L):
    """G (1+k) above 7,168, the first kernel's limit: S's columns in 2 and
    3 tiles (one CTA an SM), against the plain version; the same bits on
    a second launch; the tickets left at zero."""
    from libfm_tpu_torch.kernels import sgda_lambda as sl

    assert G * (k + 1) > 7168
    assert sl.lambda_plan(1000, k, G, 132).tiles > 1
    s = _sgda_inputs(cuda, np.random.default_rng(2900 + k + L), k, G, mode, L, 0, n=1500)
    regs, scratch = _lambda_step_twice(cuda, s, k, G, mode)
    assert torch.equal(regs[0][0], regs[1][0]) and torch.equal(regs[0][1], regs[1][1])
    assert (scratch[:sl.TICKET_FLOATS] == 0).all()
    _hold_lambda_step(regs[0], regs[2], s)


@pytest.mark.parametrize("B", [1, 31, 8192, 32768])
@pytest.mark.parametrize("k,G", [(8, 2), (16, 13), (64, 3)])
@pytest.mark.parametrize("mode,L", SGDA_SHAPES)
def test_sgda_lambda_kernel_at_each_batch_size(cuda, B, k, G, mode, L):
    """Batches of 1 and 31 rows (one or two CTAs, the padded rows at the
    end), and configs #1's and #4b's 8,192 and 32,768 (the grid at its
    cap, two levels of the cross-CTA sum), against the plain version; the
    same bits on a second launch."""
    s = _sgda_inputs(cuda, np.random.default_rng(3900 + B + k + L), k, G, mode, L, 0, B=B,
                     pad=min(7, B - 1))
    regs, _ = _lambda_step_twice(cuda, s, k, G, mode)
    assert torch.equal(regs[0][0], regs[1][0]) and torch.equal(regs[0][1], regs[1][1])
    _hold_lambda_step(regs[0], regs[2], s)


@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("mode,L", SGDA_SHAPES)
def test_sgda_kernels_on_a_batch_of_one_id(cuda, k, mode, L):
    """Every real entry on id 7: one cache writer (the last real entry),
    the lambda step's sums all in that id's group."""
    from libfm_tpu_torch.kernels import sgda_lambda as sl
    from libfm_tpu_torch.kernels import sgda_step as sa

    s = _sgda_inputs(cuda, np.random.default_rng(50 + k + L), k, 2, mode, L, 1,
                     same_id=True)
    kw = dict(mode=mode, task=1, lr=0.05, min_target=-1.0, max_target=1.0)
    args = (s["ids"], s["vals"], s["y"], s["mask"])
    rest = (s["gc_row"], s["groups"], s["reg_w"], s["reg_v"])
    Gc_k, Gc_p = s["Gc"].clone(), s["Gc"].clone()
    u_k, _ = sa.sgda_step(s["P"], *args, s["w0"].clone(), Gc_k, *rest, order=s["order"],
                          **kw)
    u_p, _ = sa.sgda_step_plain(s["P"], *args, s["w0"].clone(), Gc_p, *rest,
                                order=s["order"], **kw)
    regs = [(s["reg_w"].clone(), s["reg_v"].clone()) for _ in range(2)]
    sl.sgda_lambda(s["P"], Gc_k, *args, s["w0"], s["groups"], *regs[0], **kw)
    sl.sgda_lambda_plain(s["P"], Gc_k, *args, s["w0"], s["groups"], *regs[1], **kw)
    torch.cuda.synchronize()
    assert int((s["gc_row"] < s["P"].shape[0]).sum()) == 1
    assert _col_rel_err(u_k[: s["n_real"]], u_p[: s["n_real"]]) < 1e-4
    assert _col_rel_err(Gc_k, Gc_p) < 1e-4
    step = (regs[1][1] - s["reg_v"]).abs().max().item()
    assert (regs[0][1] - regs[1][1]).abs().max().item() <= 1e-4 * step


@pytest.mark.parametrize("k", [1, 8, 16, 17, 64, 128])
@pytest.mark.parametrize("mode,L", [("pair", 2), ("onehot", 13), ("general", 20),
                                    ("onehot", 40)])
@pytest.mark.parametrize("G", [3, 2500])
@pytest.mark.parametrize("task", [0, 1])
def test_sgda_step_kernel_under_its_plan(cuda, k, mode, L, G, task):
    """sgda_step under each of its forms: 1,001 rows (no whole number of
    a CTA's rows), rows of up to the kept entries (16, 8 above k = 32) and
    longer ones (20 and 40 entries, and 13 above k = 32) gathered again,
    the regularizers in shared memory (3 groups) and read from global
    memory (2,500 groups, above REG_FLOATS at every k): the rows, the sum
    and the cache rows against the plain version, w0 bitwise against
    `w0_update` on the sum, and a second launch the same bits."""
    from libfm_tpu_torch.kernels import sgda_step as sa

    rng = np.random.default_rng(1700 + k + L + G + task)
    B = 1001
    s = _sgda_inputs(cuda, rng, k, G, mode, L, task, B=B)
    assert sa.regs_shared(G, k) == (G == 3)
    kw = dict(mode=mode, task=task, lr=0.05, min_target=1.0, max_target=5.0)
    args = (s["ids"], s["vals"], s["y"], s["mask"])
    rest = (s["gc_row"], s["groups"], s["reg_w"], s["reg_v"])
    Gc_k, Gc_2, Gc_p = s["Gc"].clone(), s["Gc"].clone(), s["Gc"].clone()
    w0_k, w0_2, w0_p = s["w0"].clone(), s["w0"].clone(), s["w0"].clone()
    u_k, r_k = sa.sgda_step(s["P"], *args, w0_k, Gc_k, *rest, order=s["order"], **kw)
    u_2, r_2 = sa.sgda_step(s["P"], *args, w0_2, Gc_2, *rest, order=s["order"], **kw)
    u_p, r_p = sa.sgda_step_plain(s["P"], *args, w0_p, Gc_p, *rest, order=s["order"], **kw)
    torch.cuda.synchronize()
    assert torch.equal(u_k, u_2) and torch.equal(Gc_k, Gc_2)
    assert torch.equal(r_k, r_2) and torch.equal(w0_k, w0_2)
    m, n = s["n_real"], s["P"].shape[0]
    assert _col_rel_err(u_k[:m], u_p[:m]) < 1e-4
    assert (u_k[m:] == 0).all()
    assert abs(r_k[0].item() - r_p[0].item()) <= 1e-4 * max(1.0, r_p[0].abs().item())
    assert torch.equal(w0_k, sa.w0_update(s["w0"], 0.05, r_k[0]))
    assert _col_rel_err(Gc_k[:n], Gc_p[:n]) < 1e-4
    assert torch.equal(Gc_k[n], s["Gc"][n])


@pytest.mark.parametrize("which", ["ml", "ctr", "wide"])
def test_sgda_on_cuda_follows_the_cpu_trajectory(cuda, which):
    """SGDALearner on the card (kernels) against the CPU (plain versions)
    from the same parameters, 3 epochs: the metrics, regularizers and
    factors; on the card its batch loop launches sgda_step and
    table_scatter once a batch and, from the second epoch, sgda_lambda
    once a batch, and besides them only fm_refresh (the evaluations).
    "wide": a group a feature, 500 at k = 16 (G (1+k) = 8,500, above the
    first kernel's 7,168: S's columns in tiles)."""
    from libfm_tpu_torch.data.batching import batch_dataset
    from libfm_tpu_torch.data.synth import ctr_like
    from libfm_tpu_torch.learners.sgda import SGDALearner

    if which == "ml":
        train, test = movielens_like(300, 200, 30000, seed=5)
        groups = (np.arange(500) >= 300).astype(np.int32)
        task, lr, k = 0, 1e-4, 8
    elif which == "wide":
        train, test = movielens_like(300, 200, 30000, seed=5)
        groups = np.arange(500, dtype=np.int32)
        task, lr, k = 0, 1e-4, 16
    else:
        train, test, groups = ctr_like(13, 300, 20000, seed=5)
        task, lr, k = 1, 1e-3, 16
    trn, val = train.holdout(3)
    n = train.num_features
    rng = np.random.default_rng(0)
    init = (np.float32(0.0), np.zeros(n, np.float32),
            rng.normal(0, 0.1, (n, k)).astype(np.float32))
    cfg = FMConfig(num_features=n, num_factors=k)
    runs = {}
    for dev in ("cpu", "cuda"):
        kernels.reset_launch_counts()
        learner = SGDALearner(cfg, attr_group=groups, task=task, num_iter=3,
                              learn_rate=lr, batch_size=1000, verbose=False, device=dev)
        learner.init_params(FMParams(*(torch.as_tensor(x) for x in init)))
        hist = learner.learn(trn, test, val)
        runs[dev] = (hist, learner.reg_v.cpu(), learner.params.v.cpu())
        counts = {name: c for name, c in kernels.launch_counts().items() if c}
    nb = batch_dataset(trn, 1000).num_batches
    assert counts == {"sgda_step": 3 * nb, "table_scatter": 3 * nb,
                      "sgda_lambda": 2 * nb, "fm_refresh": 9}
    tol = 1e-4 if task == 0 else 1.0 / test.num_rows + 1e-9
    for hc, hg in zip(runs["cpu"][0], runs["cuda"][0]):
        assert all(abs(a - b) <= tol for a, b in zip(hc[:3], hg[:3]))
    reg_c, reg_g = runs["cpu"][1], runs["cuda"][1]
    assert reg_c.max() > 0
    assert (reg_c - reg_g).abs().max().item() <= 1e-3 * reg_c.abs().max().item()
    assert (runs["cpu"][2] - runs["cuda"][2]).abs().max().item() < 1e-3


# ---- the relational (BS) engine's kernels: rel_scores, rel_refresh,
# rel_cache, rel_stats, schur_draw's relational form (K10's update),
# rel_resync

REL_KS = [1, 8, 32, 64, 128]
U32 = 2.0 ** -24  # float32's unit roundoff


def _relation(rng, nb, W, nf, nc, offset=0, every_row=False):
    """A relation of nb block rows of W valued entries over nf features,
    joined by nc cases: row 1 joined by no case, row 0 by most (skew just
    under 16), and feature nf - 1 on exactly one row; with `every_row`,
    feature 0 on all nb rows."""
    from libfm_tpu_torch.data.relation import RelationData, RelationJoin

    cols = np.stack([np.sort(rng.choice(nf - 1, W, replace=False)) for _ in range(nb)])
    cols[2, -1] = nf - 1
    if every_row:
        cols[:, 0] = 0  # each row's smallest column: the rows stay sorted
    rd = RelationData(np.arange(nb + 1) * W, cols.ravel(), rng.normal(0, 1, nb * W), nf)
    rd.attr_offset = offset
    heavy = int(15.5 * nc / nb)
    m = np.concatenate([np.zeros(heavy, np.int64), rng.integers(2, nb, nc - heavy)])
    return RelationJoin(rd, rng.permutation(m).astype(np.int32))


def _rel_state(cuda, k, seed=0, nb=64, W=6, nf=150, nc=3000, every_row=False):
    """(P, A, layout, its device copy, C, SD) on the card: P and A random,
    C the plain caches of A, SD random with a zero sentinel row."""
    from libfm_tpu_torch.learners.mcmc_rel_vector import DevRel, RelLayout

    rng = np.random.default_rng(seed)
    join = _relation(rng, nb, W, nf, nc, every_row=every_row)
    lay = RelLayout(join, join, np.zeros(nf, np.int32), nf)
    rel = DevRel(lay, cuda)
    P = torch.as_tensor(rng.normal(0, 0.5, (nf, k + 1)), dtype=torch.float32, device=cuda)
    A = torch.as_tensor(rng.normal(0, 1, (nc, k + 1)), dtype=torch.float32, device=cuda)
    from libfm_tpu_torch.kernels.rel_cache import rel_cache_plain

    C = rel_cache_plain(A, rel.case_off, rel.case_ids)
    SD = torch.as_tensor(rng.normal(0, 0.3, (nb + 1, k + 1)), dtype=torch.float32,
                         device=cuda)
    SD[nb] = 0.0
    return P, A, lay, rel, C, SD


@pytest.mark.parametrize("k", REL_KS)
@pytest.mark.parametrize("use_linear", [True, False])
def test_rel_scores_and_refresh_kernels_match_plain(cuda, k, use_linear):
    """Two relations in one rel_refresh launch, train and tail modes."""
    from libfm_tpu_torch.kernels import rel_refresh as rr

    rng = np.random.default_rng(k)
    nc, nf1, nf2 = 2500, 120, 90
    joins = [_relation(rng, 50, 7, nf1, nc), _relation(rng, 30, 4, nf2, nc, offset=nf1)]
    P = torch.as_tensor(rng.normal(0, 0.5, (nf1 + nf2, k + 1)), dtype=torch.float32,
                        device=cuda)
    SC_k, SC_p, maps, first = [], [], [], 0
    for j in joins:
        rd = j.data
        args = _to(cuda, rd.indptr, (rd.cols + rd.attr_offset).astype(np.int32), rd.vals)
        SC_k.append(rr.rel_scores(P, *args, use_linear=use_linear))
        SC_p.append(rr.rel_scores_plain(P, *args, use_linear=use_linear))
        maps.append(j.row_map.astype(np.int64) + first)
        first += rd.num_cases + 1
    SC_k, SC_p = torch.cat(SC_k), torch.cat(SC_p)
    assert _col_rel_err(SC_k[:, :k + 1], SC_p[:, :k + 1]) < 1e-5
    assert (SC_k[:, k + 1] - SC_p[:, k + 1]).abs().max() <= 1e-5 * max(
        1.0, SC_p[:, k + 1].abs().max().item())
    maps = torch.as_tensor(np.stack(maps).astype(np.int32), device=cuda)
    y = torch.as_tensor(rng.normal(0, 1, nc), dtype=torch.float32, device=cuda)
    w0 = torch.tensor(0.4, device=cuda)
    kw = dict(use_linear=use_linear, min_target=-2.0, max_target=2.0)
    A_k, A_p = (torch.empty(nc, k + 1, device=cuda) for _ in range(2))
    m_k = rr.rel_refresh(SC_p, maps, w0, A_k, y, **kw)
    m_k2 = rr.rel_refresh(SC_p, maps, w0, A_k.clone(), y, **kw)
    m_p = rr.rel_refresh_plain(SC_p, maps, w0, A_p, y, **kw)
    assert _col_rel_err(A_k, A_p) < 1e-5
    assert abs(m_k.item() - m_p.item()) <= 1e-5 * m_p.item()
    assert torch.equal(m_k, m_k2)
    T_k, T_p = (torch.empty(nc, k + 1, device=cuda) for _ in range(2))
    rr.rel_refresh(SC_p, maps, w0, T_k, use_linear=use_linear)
    rr.rel_refresh_plain(SC_p, maps, w0, T_p, use_linear=use_linear)
    assert _col_rel_err(T_k, T_p) < 1e-5
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", [1, 3, 32, 128])
@pytest.mark.parametrize("nrel", [1, 2])
def test_rel_scores_kernel_on_stacked_relations(cuda, k, nrel):
    """One launch over one or two relations' stacked designs (rows of 6
    and of 40 entries: a second batch of 32 and groups of 16 in flight),
    against the plain version within 1e-5 a column, every sentinel row 0,
    and the same bits from a second launch."""
    from libfm_tpu_torch.kernels import rel_refresh as rr
    from libfm_tpu_torch.learners.mcmc_rel_vector import (
        DevRel,
        RelLayout,
        stacked_design,
    )

    rng = np.random.default_rng(40 + k)
    nf = 150
    joins = [_relation(rng, 64, 6, nf, 2000), _relation(rng, 30, 40, nf, 2000, offset=nf)]
    n = 2 * nf
    rels = [DevRel(RelLayout(j, j, np.zeros(n, np.int32), n), cuda) for j in joins[:nrel]]
    P = torch.as_tensor(rng.normal(0, 0.5, (n, k + 1)), dtype=torch.float32, device=cuda)
    design = stacked_design(rels)
    before = kernels.launch_counts()["rel_scores"]
    SC_k = rr.rel_scores(P, *design)
    SC_2 = rr.rel_scores(P, *design)
    SC_p = rr.rel_scores_plain(P, *design)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rel_scores"] == before + 2
    assert SC_k.shape == (sum(r.nb + 1 for r in rels), k + 2)
    assert _col_rel_err(SC_k, SC_p) < 1e-5
    assert torch.equal(SC_k, SC_2)
    first = np.cumsum([r.nb + 1 for r in rels]) - 1
    assert not SC_k[torch.as_tensor(first, device=cuda)].any()


def test_bs_two_relations_one_scores_launch_a_call(cuda):
    """The BS vector engine's ALS over two relations on the card: one
    rel_scores launch at the set-up and at each refresh, whatever the
    number of relations, and the CPU's trajectory within 1e-4."""
    from libfm_tpu_torch.data.dataset import Dataset
    from libfm_tpu_torch.learners.mcmc import dispatch_chunks

    rng = np.random.default_rng(8)
    nf, nc, nte = 150, 3000, 600
    joins = [_relation(rng, 64, 6, nf, nc + nte), _relation(rng, 40, 4, 90, nc + nte,
                                                               offset=nf)]
    y = rng.normal(0, 1, nc + nte).astype(np.float32)

    def ds(sl):
        d = Dataset(np.zeros(len(y[sl]) + 1, np.int64), np.empty(0, np.int32),
                    np.empty(0, np.float32), y[sl], 0)
        d.relations = [j.permuted(np.arange(nc + nte)[sl]) for j in joins]
        return d

    train, test = ds(slice(0, nc)), ds(slice(nc, None))
    n = nf + 90
    init = (np.float32(0.0), rng.normal(0, 0.1, n).astype(np.float32),
            rng.normal(0, 0.1, (n, 8)).astype(np.float32))
    hist = {}
    for dev in ("cpu", "cuda"):
        kernels.reset_launch_counts()
        lr = ALSVectorLearner(FMConfig(num_features=n, num_factors=8, regw=1.0, regv=1.0),
                              num_iter=5, seed=1, verbose=False, device=dev,
                              init_params=[torch.as_tensor(x) for x in init])
        lr.expand_max_ratio = 0.0
        hist[dev] = lr.learn(train, test)
        assert lr.relational_mode == "bs_vector"
    refresh = len(dispatch_chunks(0, 5, lr.refresh_every))
    assert kernels.launch_counts()["rel_scores"] == 1 + refresh
    for hc, hg in zip(hist["cpu"], hist["cuda"]):
        assert abs(hc["test_this"] - hg["test_this"]) < 1e-4
        assert abs(hc["train"] - hg["train"]) < 1e-4


def _main_forward(cuda, rng, k, L, nc=2500, n_main=40):
    """rel_refresh's inputs with main rows beside two relations: (SC, maps,
    w0, P, ids, vals) on the card. Rows of 0 to L main entries padded with
    value 0 (case 0 has none, case 1 all L), valued entries."""
    from libfm_tpu_torch.data.vector_layout import padded_rows_layout
    from libfm_tpu_torch.kernels import rel_refresh as rr

    lens = rng.integers(0, L + 1, nc)
    lens[0], lens[1] = 0, L
    indptr = np.concatenate([[0], np.cumsum(lens)])
    cols = np.concatenate([np.sort(rng.choice(n_main, m, replace=False)) for m in lens])
    ids, vals = padded_rows_layout(indptr, cols.astype(np.int32),
                                   rng.normal(1.0, 0.5, len(cols)).astype(np.float32))
    joins = [_relation(rng, 50, 7, 120, nc, offset=n_main),
             _relation(rng, 30, 4, 90, nc, offset=n_main + 120)]
    P = torch.as_tensor(rng.normal(0, 0.3, (n_main + 210, k + 1)), dtype=torch.float32,
                        device=cuda)
    SC, maps, first = [], [], 0
    for j in joins:
        rd = j.data
        SC.append(rr.rel_scores_plain(P, *_to(cuda, rd.indptr, (rd.cols + rd.attr_offset)
                                                  .astype(np.int32), rd.vals)))
        maps.append(j.row_map.astype(np.int64) + first)
        first += rd.num_cases + 1
    return (torch.cat(SC), torch.as_tensor(np.stack(maps).astype(np.int32), device=cuda),
            torch.tensor(0.3, device=cuda), P, *_to(cuda, ids, vals))


@pytest.mark.parametrize("k", [8, 32, 128])
@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("use_linear", [True, False])
def test_rel_refresh_main_rows_kernel_matches_plain(cuda, k, L, use_linear):
    """Main rows beside two relations in one rel_refresh launch: train,
    tail and test modes against the plain version (A per column within
    1e-4 of the column's largest value, the summed error within 1e-6
    relative, as chip_smoke.py holds them at bench_bs_ctx), the same bits
    on a second launch; the test mode's predictions equal the tail mode's."""
    from libfm_tpu_torch.kernels import rel_refresh as rr

    rng = np.random.default_rng(100 * k + L)
    SC, maps, w0, P, ids, vals = _main_forward(cuda, rng, k, L)
    nc = ids.shape[0]
    main = dict(P=P, ids=ids, vals=vals, use_linear=use_linear)
    y = torch.as_tensor(rng.normal(0, 1, nc), dtype=torch.float32, device=cuda)
    kw = dict(min_target=-2.0, max_target=2.0)
    A_k, A_p = (torch.empty(nc, k + 1, device=cuda) for _ in range(2))
    m_k = rr.rel_refresh(SC, maps, w0, A_k, y, **kw, **main)
    m_k2 = rr.rel_refresh(SC, maps, w0, A_k.clone(), y, **kw, **main)
    m_p = rr.rel_refresh_plain(SC, maps, w0, A_p, y, **kw, **main)
    assert _col_rel_err(A_k, A_p) < 1e-4
    assert abs(m_k.item() - m_p.item()) <= 1e-6 * m_p.item()
    assert torch.equal(m_k, m_k2)
    T_k, T_p = (torch.empty(nc, k + 1, device=cuda) for _ in range(2))
    rr.rel_refresh(SC, maps, w0, T_k, **main)
    rr.rel_refresh_plain(SC, maps, w0, T_p, **main)
    assert _col_rel_err(T_k, T_p) < 1e-4
    p_k = rr.rel_refresh(SC, maps, w0, **main)
    assert torch.equal(p_k, T_k[:, 0])
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", [8, 32, 128])
@pytest.mark.parametrize("mode", ["sample", "mean"])
def test_rel_refresh_probit_kernel_matches_plain(cuda, k, mode):
    """rel_refresh's probit train mode with main rows, counted apart: Q and
    the predictions (e + latent) within 1e-4, the latents within 1e-5
    relative above 1 of the plain draw on the kernel's predictions where
    the draw lies within 2.5 of its mean (config #4's rule in
    chip_smoke.py), every latent on y's side of 0, the correct count
    equal to the plain version's, one rel_refresh_probit launch."""
    from libfm_tpu_torch.kernels import rel_refresh as rr
    from libfm_tpu_torch.ops.samplers import probit_latent

    rng = np.random.default_rng(7 * k)
    SC, maps, w0, P, ids, vals = _main_forward(cuda, rng, k, 3)
    nc = ids.shape[0]
    y = torch.as_tensor(np.where(rng.random(nc) < 0.5, 1.0, -1.0), dtype=torch.float32,
                        device=cuda)
    U = (torch.as_tensor(rng.random(nc), dtype=torch.float32, device=cuda)
         if mode == "sample" else None)
    A_k, A_p = (torch.empty(nc, k + 1, device=cuda) for _ in range(2))
    l_k, l_p = (torch.empty(nc, device=cuda) for _ in range(2))
    before = kernels.launch_counts()
    c_k = rr.rel_refresh(SC, maps, w0, A_k, y, P=P, ids=ids, vals=vals, probit=mode, U=U,
                         latent=l_k)
    after = kernels.launch_counts()
    c_p = rr.rel_refresh_plain(SC, maps, w0, A_p, y, P=P, ids=ids, vals=vals, probit=mode,
                               U=U, latent=l_p)
    assert after["rel_refresh_probit"] == before["rel_refresh_probit"] + 1
    assert after["rel_refresh"] == before["rel_refresh"]
    assert (A_k[:, 1:] - A_p[:, 1:]).abs().max().item() < 1e-4
    pred_k = A_k[:, 0] + l_k
    assert (pred_k - (A_p[:, 0] + l_p)).abs().max().item() < 1e-4
    ref = probit_latent(pred_k, y, U)
    near = (ref - pred_k).abs() <= 2.5 if U is not None else torch.ones_like(y, dtype=bool)
    assert ((l_k - ref).abs() / ref.abs().clamp_min(1.0))[near].max().item() < 1e-5
    assert ((l_k >= 0) == (y >= 0)).all()
    assert c_k.item() == c_p.item()
    torch.cuda.synchronize()


def _refresh_inputs(cuda, rng, nc, k, L, R, n_main=40, rows=50):
    """rel_refresh's inputs: R relations of `rows` score rows each (and a
    sentinel), stacked in SC with random scores, maps [R, nc] into each
    relation's rows; with L > 0 main rows of 0 to L valued entries
    (padding: id 0, value 0) into P [n_main, k+1]; y, targets of +-1 and
    uniforms. Made on the host from `rng`."""
    SC = torch.as_tensor(rng.normal(0, 0.3, (R * (rows + 1), k + 2)), dtype=torch.float32,
                         device=cuda)
    maps = np.stack([rng.integers(r * (rows + 1), r * (rows + 1) + rows + 1, nc)
                     for r in range(R)]).astype(np.int32)
    main = {}
    if L:
        lens = rng.integers(0, L + 1, nc)
        keep = np.arange(L)[None, :] < lens[:, None]
        ids = np.where(keep, rng.integers(0, n_main, (nc, L)), 0).astype(np.int32)
        vals = np.where(keep, rng.normal(1.0, 0.5, (nc, L)), 0.0).astype(np.float32)
        P = torch.as_tensor(rng.normal(0, 0.3, (n_main, k + 1)), dtype=torch.float32,
                            device=cuda)
        main = dict(P=P, ids=torch.as_tensor(ids, device=cuda),
                    vals=torch.as_tensor(vals, device=cuda))
    y = torch.as_tensor(rng.normal(0, 1, nc), dtype=torch.float32, device=cuda)
    y_c = torch.as_tensor(np.where(rng.random(nc) < 0.5, 1.0, -1.0), dtype=torch.float32,
                          device=cuda)
    U = torch.as_tensor(rng.random(nc), dtype=torch.float32, device=cuda)
    return SC, torch.as_tensor(maps, device=cuda), torch.tensor(0.3, device=cuda), main, y, \
        y_c, U


def test_kernel_plans_hold_the_sources_sizes(cuda):
    """The host's plans against the sizes the kernels' sources export:
    sgda_step's regularizer budget and scratch, rel_refresh's shared
    memory a warp for every k in 1-128 and several row shapes, and
    table_read's shared memory a CTA in both forms."""
    import ctypes

    from libfm_tpu_torch.kernels import library
    from libfm_tpu_torch.kernels import rel_refresh as rr
    from libfm_tpu_torch.kernels import sgda_step as sa

    lib = library()
    assert lib.sgda_step_reg_floats() == sa.REG_FLOATS
    assert lib.sgda_step_scratch_floats() == sa.SCRATCH_FLOATS
    for k, R, L, has_A in itertools.product(range(1, 129), [1, 2, 3],
                                            [0, 1, 2, 13, 16, 17, 100], [0, 1]):
        assert lib.rel_refresh_warp_bytes(k, R, L, has_A) == rr.warp_bytes(k, R, L, has_A)
    smem = lib.table_read_smem_bytes
    smem.restype = ctypes.c_longlong
    smem.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    for (form, code), nsub, cols, per in itertools.product(
            tr.FORMS.items(), [1, 37, 10_256, 60_000], tr.SLICE_WIDTHS, [0, 256, 4096]):
        assert smem(code, nsub, cols, per) == tr.smem_bytes(form, nsub, cols, per)


def _pred_rounding(SC, maps, w0, k, main):
    """Per case, a bound (float64) on how far two float32 evaluations of
    its prediction may lie apart: twice gamma eps times the sum of the
    absolute values of the terms it adds, 1/2 (|Q|^2 + sq) + |lin| + |w0|,
    each of Q, sq and lin over the absolute values of the mapped score
    rows and main entries, with gamma = 2 (L + R + k) + 8 roundings."""
    R, L = maps.shape[0], (main["ids"].shape[1] if main else 0)
    rows = SC.double()[maps.long()].abs()  # [R, nc, k+2]
    q, sq, lin = rows[..., :k].sum(0), rows[..., k].sum(0), rows[..., k + 1].sum(0)
    if main:
        xP = main["P"].double()[main["ids"].long()].abs()  # [nc, L, k+1]
        xP *= main["vals"].double().abs()[..., None]
        q = q + xP[..., 1:].sum(1)
        sq = sq + (xP[..., 1:] ** 2).sum((1, 2))
        lin = lin + xP[..., 0].sum(1)
    mag = 0.5 * ((q ** 2).sum(1) + sq) + lin + abs(w0.item())
    return 2 * (2 * (L + R + k) + 8) * 2.0 ** -24 * mag


@pytest.mark.parametrize("nc,k", [(1, 5), (31, 32), (32, 8), (33, 100), (33, 5),
                                  (100_000, 64), (2**20 + 5, 32)])
@pytest.mark.parametrize("L", [0, 1, 2, 13, 20])
@pytest.mark.parametrize("R", [1, 2])
def test_rel_refresh_kernel_tiles_every_mode(cuda, nc, k, L, R):
    """rel_refresh's tiles of 32 cases (one ragged tile, one whole tile,
    a tile and one case, 100,000 and 2^20 + 5 cases over a persistent
    grid) with 0-13 main entries staged and 20 read from global memory,
    and 1-2 relations, in every mode against the plain version: train (A
    per column within 1e-4; the summed error against the float64 sum over
    the plain version's predictions, within the root sum of squares of
    what each case's prediction may round (`_pred_rounding`) and 1e-6
    relative for the float32 sum;
    A also as a view off 16 bytes), tail, test (the tail's predictions,
    bit for bit), probit sampling and expectations (Q and the predictions within
    1e-4, the latents as test_rel_refresh_probit_kernel_matches_plain
    holds them, the correct count equal); two launches the same bits in
    each train mode."""
    from libfm_tpu_torch.kernels import rel_refresh as rr
    from libfm_tpu_torch.ops.samplers import probit_latent

    rng = np.random.default_rng(nc % 1000 + 10 * k + 100 * L + R)
    SC, maps, w0, main, y, y_c, U = _refresh_inputs(cuda, rng, nc, k, L, R)
    kw = dict(min_target=-1.5, max_target=1.5, **main)
    d = k + 1
    A_k, A_2, A_p = (torch.empty(nc, d, device=cuda) for _ in range(3))
    big = torch.empty(nc + 1, d, device=cuda)
    A_off = big[1:]  # (k+1) floats past a 16-byte boundary
    m_k = rr.rel_refresh(SC, maps, w0, A_k, y, **kw)
    m_2 = rr.rel_refresh(SC, maps, w0, A_2, y, **kw)
    m_o = rr.rel_refresh(SC, maps, w0, A_off, y, **kw)
    rr.rel_refresh_plain(SC, maps, w0, A_p, y, **kw)
    torch.cuda.synchronize()
    assert torch.equal(A_k, A_2) and torch.equal(m_k, m_2)
    assert torch.equal(A_off, A_k) and torch.equal(m_o, m_k)
    assert _col_rel_err(A_k, A_p) < 1e-4
    # the summed error against the plain version's in float64: a case's
    # clipped error may move by D, what two evaluations of its prediction
    # may differ by, and by the rounding of A[c, 0] = pred - y, so its
    # square by (2 |e| + D) D; the cases' roundings, of either sign, add
    # as a root sum of squares; 1e-6 relative for the float32 sum
    y64 = y.double()
    pred_p = A_p[:, 0].double() + y64
    e_p = pred_p.clamp(-1.5, 1.5) - y64
    D = _pred_rounding(SC, maps, w0, k, main) + 2.0 ** -24 * (pred_p.abs() + y64.abs())
    m_ref = (e_p ** 2).sum().item()
    tol = ((2 * e_p.abs() + D) * D).square().sum().sqrt().item() + 1e-6 * m_ref
    assert abs(m_k.item() - m_ref) <= tol
    T_k, T_p = (torch.empty(nc, d, device=cuda) for _ in range(2))
    rr.rel_refresh(SC, maps, w0, T_k, **main)
    rr.rel_refresh_plain(SC, maps, w0, T_p, **main)
    p_k = rr.rel_refresh(SC, maps, w0, **main)
    torch.cuda.synchronize()
    assert _col_rel_err(T_k, T_p) < 1e-4
    assert torch.equal(p_k, T_k[:, 0]) and torch.equal(T_k[:, 1:], A_k[:, 1:])
    for mode, u in (("sample", U), ("mean", None)):
        got = []
        for _ in range(2):
            A_c, l_c = torch.empty(nc, d, device=cuda), torch.empty(nc, device=cuda)
            c_c = rr.rel_refresh(SC, maps, w0, A_c, y_c, probit=mode, U=u, latent=l_c,
                                 **main)
            got.append((A_c, l_c, c_c))
        A_q, l_p = torch.empty(nc, d, device=cuda), torch.empty(nc, device=cuda)
        c_p = rr.rel_refresh_plain(SC, maps, w0, A_q, y_c, probit=mode, U=u, latent=l_p,
                                   **main)
        torch.cuda.synchronize()
        (A_c, l_c, c_c), (A_c2, l_c2, c_c2) = got
        assert torch.equal(A_c, A_c2) and torch.equal(l_c, l_c2) and torch.equal(c_c, c_c2)
        assert torch.equal(A_c[:, 1:], A_k[:, 1:])
        assert (A_c[:, 1:] - A_q[:, 1:]).abs().max().item() < 1e-4
        pred = A_c[:, 0] + l_c
        assert (pred - (A_q[:, 0] + l_p)).abs().max().item() < 1e-4
        ref = probit_latent(pred, y_c, u)
        near = (ref - pred).abs() <= 2.5 if u is not None else torch.ones_like(y_c, dtype=bool)
        if near.any():
            assert ((l_c - ref).abs() / ref.abs().clamp_min(1.0))[near].max().item() < 1e-5
        assert ((l_c >= 0) == (y_c >= 0)).all()
        assert c_c.item() == c_p.item()


@pytest.mark.parametrize("k", [1, 3, 8, 16, 32, 40, 64, 128])
def test_rel_cache_kernel_matches_float64(cuda, k):
    """Every cache entry within (the row's cases + 2) roundings of its sum
    of magnitudes, over rows of 0, 1, a few and several hundred cases (a
    CTA's rows of unequal lengths, more rows than one CTA sums); the
    unjoined rows and the sentinel are 0; a second launch gives the same
    bits."""
    from libfm_tpu_torch.kernels import rel_cache as rc
    from libfm_tpu_torch.kernels.case_stats import err_over_magnitudes

    rng = np.random.default_rng(7 + k)
    counts = rng.integers(0, 40, 97)
    counts[:6] = [0, 1, 700, 0, 1, 333]
    nb, nc = len(counts), 6000
    case_off = np.zeros(nb + 1, np.int64)
    np.cumsum(counts, out=case_off[1:])
    case_ids = rng.integers(0, nc, case_off[-1]).astype(np.int32)
    A = torch.as_tensor(rng.normal(0, 1, (nc, k + 1)), dtype=torch.float32, device=cuda)
    case_off, case_ids = _to(cuda, case_off, case_ids)
    C_k = rc.rel_cache(A, case_off, case_ids)
    ref, scale = rc.rel_cache_reference(A, case_off, case_ids)
    assert err_over_magnitudes(C_k, ref, scale) <= 2 * (int(counts.max()) + 2) * U32
    assert (C_k[0] == 0).all() and (C_k[3] == 0).all() and (C_k[nb] == 0).all()
    assert torch.equal(C_k, rc.rel_cache(A, case_off, case_ids))
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", REL_KS)
@pytest.mark.parametrize("use_linear", [True, False])
def test_rel_stats_kernel_matches_float64(cuda, k, use_linear):
    """Every block's GG at a non-zero SD within (the feature's entries + k
    + 8) roundings of each entry's sum of magnitudes (the feature of one
    entry among them)."""
    from libfm_tpu_torch.kernels import rel_sweep as rs
    from libfm_tpu_torch.kernels.case_stats import err_over_magnitudes

    P, A, lay, rel, C, SD = _rel_state(cuda, k, seed=1)
    ones = 0
    for hb, blk in zip(lay.blocks, rel.blocks):
        args = (C, SD, rel.wnum, blk.feat_off, blk.entry_b, blk.entry_x, blk.feat_id, P)
        G_k = rs.rel_stats(*args, use_linear=use_linear)
        ref, scale = rs.rel_stats_reference(*args, use_linear=use_linear)
        emax = int(np.diff(hb.feat_off).max())
        assert err_over_magnitudes(G_k, ref, scale) <= 2 * (emax + k + 8) * U32
        assert torch.equal(G_k, rs.rel_stats(*args, use_linear=use_linear))
        ones += int((np.diff(hb.feat_off) == 1).sum())
    assert ones > 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", REL_KS)
def test_rel_stats_kernel_on_a_feature_of_every_row(cuda, k):
    """A relation whose feature 0 lies on all 2,000 block rows: a block of
    that one feature, whose 2,000 entries rel_stats stages in many
    batches (its rows and SD at every 16-byte offset), within (the
    feature's entries + k + 8) roundings of each entry's sum of
    magnitudes; a second launch gives the same bits."""
    from libfm_tpu_torch.kernels import rel_sweep as rs
    from libfm_tpu_torch.kernels.case_stats import err_over_magnitudes

    nb = 2000
    P, A, lay, rel, C, SD = _rel_state(cuda, k, seed=3, nb=nb, W=3, nf=300, nc=10000,
                                       every_row=True)
    longest = 0
    for hb, blk in zip(lay.blocks, rel.blocks):
        args = (C, SD, rel.wnum, blk.feat_off, blk.entry_b, blk.entry_x, blk.feat_id, P)
        G_k = rs.rel_stats(*args)
        ref, scale = rs.rel_stats_reference(*args)
        emax = int(np.diff(hb.feat_off).max())
        assert err_over_magnitudes(G_k, ref, scale) <= 2 * (emax + k + 8) * U32
        assert torch.equal(G_k, rs.rel_stats(*args))
        longest = max(longest, emax)
        del ref, scale
    assert longest == nb
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", sorted(REL_KS + [3, 40]))
@pytest.mark.parametrize("use_linear", [True, False])
@pytest.mark.parametrize("rejected", [False, True])
@pytest.mark.parametrize("every_row", [False, True])
def test_rel_update_and_resync_kernels_match_plain(cuda, k, use_linear, rejected, every_row):
    """schur_draw's relational form (K10's update folded into the draw),
    block after block from rel_stats' GG: theta and the reject flags the
    same bits as schur_draw's on the same inputs; theta within 1e-3 of
    schur_draw_plain's (or 3 times the float32 plain draw's own distance
    from float64, where larger: these systems are less well conditioned
    than schur_draw's own test's), the flags equal; SD within 1e-5 of
    rel_update_plain on the kernel's theta; with a tiny bound every draw
    is rejected and SD keeps its bits. With `every_row` feature 0 lies on
    all 64 block rows, so its entries run past the ones loaded ahead and
    are taken in batches. Then rel_resync, both modes."""
    from libfm_tpu_torch.kernels import rel_sweep as rs

    P, A, lay, rel, C, SD = _rel_state(cuda, k, seed=2, every_row=every_row)
    if every_row:
        assert max(int(np.diff(hb.feat_off).max()) for hb in lay.blocks) == lay.nb
    rng = np.random.default_rng(3)
    d = k + 1
    lam_row = torch.full((d,), 4.0, device=cuda)
    mu_row = torch.zeros(d, device=cuda)
    if not use_linear:  # w frozen, as the BS engine holds it
        lam_row[0] = 1e30
    alpha = torch.tensor(1.5, device=cuda)
    bound = 1e-6 if rejected else 1e6
    SD_k = SD.clone()
    for hb, blk in zip(lay.blocks, rel.blocks):
        GG = rs.rel_stats_plain(C, SD_k, rel.wnum, blk.feat_off, blk.entry_b, blk.entry_x,
                                blk.feat_id, P, use_linear=use_linear)
        th_old = P[blk.features]
        lam, mu = lam_row.expand(blk.F, d).contiguous(), mu_row.expand(blk.F, d).contiguous()
        z = torch.as_tensor(rng.normal(size=(blk.F, d)), dtype=torch.float32, device=cuda)
        SD_before = SD_k.clone()
        t_k, r_k = sd.schur_draw_rel(GG, th_old, lam, mu, z, alpha, SD_k, blk.feat_off,
                                     blk.entry_b, blk.entry_x, do_sample=True, bound=bound)
        t_f, r_f = sd.schur_draw(GG, th_old, lam, mu, z, alpha, do_sample=True, bound=bound)
        t_p, r_p = sd.schur_draw_plain(GG, th_old, lam, mu, z, alpha, do_sample=True,
                                       bound=bound)
        t_64, _ = sd.schur_draw_plain(GG.double(), th_old.double(), lam.double(), mu.double(),
                                      z.double(), alpha.double(), do_sample=True, bound=bound)
        SD_p = rs.rel_update_plain(SD_before.clone(), blk.entry_b, blk.entry_x,
                                   torch.as_tensor(hb.entry_f, device=cuda), th_old, t_k)
        torch.cuda.synchronize()
        assert torch.equal(t_k, t_f) and torch.equal(r_k, r_f)
        assert torch.equal(r_k, r_p)

        def dist(x, y):
            return ((x.double() - y.double()).abs().max()
                    / y.double().abs().max().clamp_min(1.0)).item()

        assert dist(t_k, t_p) <= max(1e-3, 3 * dist(t_p, t_64))
        assert _col_rel_err(SD_k, SD_p) < 1e-5
        if rejected:
            assert bool(r_k.all()) and torch.equal(t_k, th_old)
            assert torch.equal(SD_k, SD_before)
        else:
            assert not bool(r_k.any())
        P[blk.features] = t_k
    A_k, A_p = A.clone(), A.clone()
    rs.rel_resync(SD_k, rel.map_tr, A_k)
    rs.rel_resync_plain(SD_k, rel.map_tr, A_p)
    assert _col_rel_err(A_k, A_p) < 1e-5
    e_k = rs.rel_resync(SD_k, rel.map_tr, A, read_only=True)
    e_p = rs.rel_resync_plain(SD_k, rel.map_tr, A, read_only=True)
    assert (e_k - e_p).abs().max() <= 1e-5 * e_p.abs().max()
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", [1, 32, 128])
@pytest.mark.parametrize("nb", [0, 64, 4000])
def test_rel_deferred_kernel_matches_plain(cuda, k, nb):
    """rel_deferred's two float32 sums within one ulp of the plain
    version's (float64 sums in another order) over nb block rows and the
    pad row, from one CTA to a grid of many (4,000 rows: ~500 CTAs and
    the last one's sum of their partials); one launch a call; a second
    call the same bits."""
    from libfm_tpu_torch.kernels import rel_sweep as rs
    from libfm_tpu_torch.kernels.rel_cache import cache_width

    rng = np.random.default_rng(k + nb)
    C = torch.as_tensor(rng.normal(0, 1, (nb + 1, cache_width(k))), dtype=torch.float32,
                        device=cuda)
    SD = torch.as_tensor(rng.normal(0, 0.3, (nb + 1, k + 1)), dtype=torch.float32,
                         device=cuda)
    SD[nb] = 0.0
    wnum = torch.as_tensor(rng.integers(0, 500, nb + 1), dtype=torch.float32, device=cuda)
    kernels.reset_launch_counts()
    got = torch.stack(rs.rel_deferred(C, SD, wnum))
    assert kernels.launch_counts()["rel_deferred"] == 1
    again = torch.stack(rs.rel_deferred(C, SD, wnum))
    want = torch.stack(rs.rel_deferred_plain(C, SD, wnum))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ulp = (torch.nextafter(want.abs(), torch.full_like(want, float("inf"))) - want.abs())
    assert ((got - want).abs() <= ulp).all(), (got, want)


@pytest.mark.parametrize("k", [1, 16, 32, 128])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_rel_resync_kernel_both_modes_match_plain(cuda, k, offset):
    """rel_resync on nc cases not a multiple of the plan's run, on A's rows
    from row `offset` of a larger tensor (A 4 (k+1) offset bytes past a
    16-byte boundary): write mode's Q + dQB equal to torch's float32 add
    bit for bit, its e within 1e-5 of the plain version's (another order
    of the dot product) and within 2e-6 of float64; read-only mode returns
    write mode's e bit for bit and leaves A as it was; a second launch
    gives the same bits."""
    from libfm_tpu_torch.kernels import rel_sweep as rs

    _, A_all, lay, rel, _, SD = _rel_state(cuda, k, seed=5, nc=3000 + 4)
    run = rs.resync_plan(k).run
    nc = 3000 - 3
    assert nc % run
    A_all_before = A_all.clone()
    A = A_all[offset:offset + nc]
    rmap = rel.map_tr[:nc].contiguous()
    A_before = A.clone()
    e = rs.rel_resync(SD, rmap, A, read_only=True)
    e_2 = rs.rel_resync(SD, rmap, A, read_only=True)
    torch.cuda.synchronize()
    assert torch.equal(A, A_before) and torch.equal(e, e_2)
    e_p = rs.rel_resync_plain(SD, rmap, A_before, read_only=True)
    sd = SD[rmap.long()]
    e_64 = (A_before[:, 0].double() + sd[:, 0].double()
            + (sd[:, 1:].double() * A_before[:, 1:].double()).sum(-1))
    mag = (A_before[:, 0].abs().double() + sd[:, 0].abs().double()
           + (sd[:, 1:].abs().double() * A_before[:, 1:].abs().double()).sum(-1))
    assert (e - e_p).abs().max() <= 1e-5 * e_p.abs().max()
    assert ((e.double() - e_64).abs() <= 2e-6 * mag).all()
    A_p = A_before.clone()
    rs.rel_resync_plain(SD, rmap, A_p)
    rs.rel_resync(SD, rmap, A)
    A_2 = A_before.clone()
    rs.rel_resync(SD, rmap, A_2)
    torch.cuda.synchronize()
    assert torch.equal(A, A_2)
    assert torch.equal(A[:, 0], e)
    assert torch.equal(A[:, 1:], A_before[:, 1:] + sd[:, 1:])
    assert _col_rel_err(A, A_p) < 1e-5
    # the rows around A's are untouched
    assert torch.equal(A_all[:offset], A_all_before[:offset])
    assert torch.equal(A_all[offset + nc:], A_all_before[offset + nc:])


@pytest.mark.parametrize("k", [1, 32, 128])
def test_rel_resync_kernel_bits_do_not_depend_on_the_run(cuda, k):
    """Both modes under runs of 4, 12, 60 and 256 cases (one run and many
    a CTA) give the default plan's bits; a run whose two buffers the
    card's shared memory cannot hold (256 cases at k = 128: 268,320
    bytes) is refused at launch."""
    from libfm_tpu_torch.kernels import rel_sweep as rs

    _, A, _, rel, _, SD = _rel_state(cuda, k, seed=6)
    want_A = A.clone()
    rs.rel_resync(SD, rel.map_tr, want_A)
    want_e = rs.rel_resync(SD, rel.map_tr, A, read_only=True)
    most = 232_448  # the shared memory a CTA of an H100 can take
    for run in (4, 12, 60, 256):
        plan = rs.ResyncPlan(run, rs.resync_smem(run, k))
        got_A, got_e = A.clone(), torch.empty_like(want_e)
        if plan.smem_bytes > most:
            with pytest.raises(RuntimeError, match="failed to launch"):
                rs.launch_resync(SD, rel.map_tr, got_A, None, plan)
            assert k == 128 and run == 256
            continue
        rs.launch_resync(SD, rel.map_tr, got_A, None, plan)
        rs.launch_resync(SD, rel.map_tr, A, got_e, plan)
        torch.cuda.synchronize()
        assert torch.equal(got_A, want_A) and torch.equal(got_e, want_e), run


@pytest.mark.parametrize("deferred", [True, False])
def test_bs_als_on_cuda_follows_the_cpu_trajectory(cuda, deferred):
    """The BS vector engine's ALS on the card against the CPU (plain
    versions) from the same parameters, 5 iterations; the kernels it
    launches, exactly."""
    from libfm_tpu_torch.data.dataset import Dataset
    from libfm_tpu_torch.learners.mcmc import dispatch_chunks

    rng = np.random.default_rng(4)
    nf, nc = 150, 4000
    join = _relation(rng, 64, 6, nf, nc + 800)
    y = rng.normal(0, 1, nc + 800).astype(np.float32)

    def ds(sl):
        d = Dataset(np.zeros(len(y[sl]) + 1, np.int64), np.empty(0, np.int32),
                    np.empty(0, np.float32), y[sl], 0)
        d.relations = [join.permuted(np.arange(nc + 800)[sl])]
        return d

    train, test = ds(slice(0, nc)), ds(slice(nc, None))
    init = (np.float32(0.0), rng.normal(0, 0.1, nf).astype(np.float32),
            rng.normal(0, 0.1, (nf, 8)).astype(np.float32))
    hist = {}
    for dev in ("cpu", "cuda"):
        kernels.reset_launch_counts()
        lr = ALSVectorLearner(FMConfig(num_features=nf, num_factors=8, regw=1.0, regv=1.0),
                              num_iter=5, seed=1, verbose=False, device=dev,
                              init_params=[torch.as_tensor(x) for x in init])
        lr.expand_max_ratio = 0.0
        lr.bs_deferred = deferred
        hist[dev] = lr.learn(train, test)
        assert lr.relational_mode == "bs_vector"
    counts = {name: c for name, c in kernels.launch_counts().items() if c}
    nblk = counts["rel_stats"] // 5
    refresh = len(dispatch_chunks(0, 5, lr.refresh_every))
    want = dict(rel_scores=1 + refresh, rel_refresh=2 + 2 * refresh, rel_stats=5 * nblk,
                schur_draw=5 * nblk, rel_update=5 * nblk)
    want.update(dict(rel_cache=1 + refresh, rel_resync=5, rel_deferred=5 + 5 - refresh)
                if deferred else dict(rel_cache=5, rel_resync=10))
    assert counts == want
    for hc, hg in zip(hist["cpu"], hist["cuda"]):
        assert abs(hc["test_this"] - hg["test_this"]) < 1e-4
        assert abs(hc["train"] - hg["train"]) < 1e-4


@pytest.mark.parametrize("task", [0, 1])
def test_bs_als_with_main_table_on_cuda_follows_the_cpu_trajectory(cuda, task):
    """The BS vector engine's ALS with a main table of two one-hot fields
    (20 and 7 values) beside one relation, regression and probit, on the
    card against the CPU from the same parameters, 5 iterations; the
    kernels it launches, exactly: the main blocks' slot_stats, schur_draw
    and slot_update every iteration, no tail, the probit refreshes and
    fast steps."""
    from libfm_tpu_torch.data.dataset import Dataset
    from libfm_tpu_torch.learners.mcmc import dispatch_chunks

    rng = np.random.default_rng(5)
    n_main, nf, nc, nte = 27, 150, 4000, 800
    join = _relation(rng, 64, 6, nf, nc + nte, offset=n_main)
    main = np.stack([rng.integers(0, 20, nc + nte), 20 + rng.integers(0, 7, nc + nte)], 1)
    y = rng.normal(0, 1, nc + nte).astype(np.float32)
    if task:
        y = np.where(y > 0, 1.0, -1.0).astype(np.float32)

    def ds(sl):
        m = len(y[sl])
        d = Dataset(np.arange(m + 1, dtype=np.int64) * 2, main[sl].ravel().astype(np.int32),
                    np.ones(2 * m, np.float32), y[sl], n_main)
        d.relations = [join.permuted(np.arange(nc + nte)[sl])]
        return d

    train, test = ds(slice(0, nc)), ds(slice(nc, None))
    n = n_main + nf
    init = (np.float32(0.0), rng.normal(0, 0.1, n).astype(np.float32),
            rng.normal(0, 0.1, (n, 8)).astype(np.float32))
    hist = {}
    for dev in ("cpu", "cuda"):
        kernels.reset_launch_counts()
        lr = ALSVectorLearner(FMConfig(num_features=n, num_factors=8, regw=1.0, regv=1.0),
                              task=task, num_iter=5, seed=1, verbose=False, device=dev,
                              init_params=[torch.as_tensor(x) for x in init])
        lr.expand_max_ratio = 0.0
        hist[dev] = lr.learn(train, test)
        assert (lr.relational_mode, lr.incr_test, lr.deferred) == ("bs_vector", False, False)
    counts = {name: c for name, c in kernels.launch_counts().items() if c}
    nblk = counts["rel_stats"] // 5
    refresh = len(dispatch_chunks(0, 5, lr.refresh_every))
    want = dict(rel_scores=6, rel_refresh=6 + refresh, rel_stats=5 * nblk,
                schur_draw=5 * (nblk + 2), rel_update=5 * nblk, rel_cache=5, rel_resync=5,
                slot_stats=10, slot_update=10)
    if task:
        want.update(rel_refresh=6, rel_refresh_probit=refresh, probit_latent=5 - refresh)
    assert counts == want
    for hc, hg in zip(hist["cpu"], hist["cuda"]):
        for key in ("test_this", "test_this_m2", "train"):
            assert abs(hc[key] - hg[key]) < 1e-4


# ---- the exact engines (K11): coord_draw, rel_coord_draw, the learners

CD_KS = [1, 8, 64, 128]


def _coord_inputs(dev, rng, k, F=300, nc=20000, skewed=True):
    """A valued conflict-free block (Zipf slot counts up to 300, one
    feature of 5,000 slots, one of none), its CoordBlock, P [n, k+1] and
    A [nc, k+1] random, lambda / mu over 3 groups, the normals."""
    from libfm_tpu_torch.learners.mcmc import CoordBlock

    blk = _block(rng, nc, F, 2 * F, skewed)
    counts = np.bincount(blk.entry_feat, minlength=F)
    counts[0], counts[1] = 5000, 0
    rows = rng.permutation(nc)[:counts.sum()].astype(np.int32)
    off = np.zeros(F + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    vals = rng.normal(1.0, 0.5, len(rows)).astype(np.float32)
    groups = rng.integers(0, 3, F).astype(np.int32)
    cb = CoordBlock(blk.features, groups, off, rows, vals, dev)
    n = 2 * F
    P = torch.as_tensor(rng.normal(0, 0.3, (n, k + 1)), dtype=torch.float32, device=dev)
    A = torch.as_tensor(rng.normal(0, 1, (nc, k + 1)), dtype=torch.float32, device=dev)
    lam = torch.as_tensor(rng.uniform(0.5, 3, (3, k)), dtype=torch.float32, device=dev)
    mu = torch.as_tensor(rng.normal(0, 0.1, (3, k)), dtype=torch.float32, device=dev)
    z = torch.as_tensor(rng.normal(0, 1, F), dtype=torch.float32, device=dev)
    return cb, P, A, lam, mu, z


@pytest.mark.parametrize("k", CD_KS)
@pytest.mark.parametrize("mode", ["w", "v"])
@pytest.mark.parametrize("sample", [True, False])
def test_coord_draw_kernel_matches_plain(cuda, k, mode, sample):
    """coord_draw on a strided column of P and of A (row stride k+1), the
    hyperparameters a column of [3, k]: theta, e and q within 1e-5 of the
    plain version, the rejection counts equal, a second launch the same
    bits."""
    from libfm_tpu_torch.kernels import coord_draw as cd

    rng = np.random.default_rng(k)
    cb, P, A, lam, mu, z = _coord_inputs(cuda, rng, k)
    col = 0 if mode == "w" else k  # the last factor
    alpha = torch.tensor(1.3, device=cuda)
    outs = []
    for fn in (cd.coord_draw, cd.coord_draw_plain, cd.coord_draw):
        Pc, Ac = P.clone(), A.clone()
        rej = torch.zeros(cb.F, dtype=torch.int32, device=cuda)
        fn(Pc[:, col], cb.feat_off, cb.slot_row, cb.slot_val, cb.feat_id, cb.group_id,
           lam[:, k - 1], mu[:, k - 1], alpha, z if sample else None, rej, bound=1e6,
           e=Ac[:, 0], q=None if mode == "w" else Ac[:, col])
        outs.append((Pc, Ac, rej))
    torch.cuda.synchronize()
    (Pk, Ak, rk), (Pp, Ap, rp), (Pk2, Ak2, rk2) = outs
    for x, y in ((Pk, Pp), (Ak, Ap)):
        assert ((x - y).abs().max() / y.abs().max().clamp_min(1.0)).item() <= 1e-5
    assert torch.equal(rk, rp)
    assert torch.equal(Pk, Pk2) and torch.equal(Ak, Ak2) and torch.equal(rk, rk2)
    assert (Pk[:, col] != P[:, col]).sum().item() == cb.F  # every feature drawn


def test_coord_draw_kernel_rejects_what_plain_rejects(cuda):
    """A near-zero lambda and alpha 0: draws of sd ~1e3 past a bound of 1
    keep the old theta, counted as the plain version counts them."""
    from libfm_tpu_torch.kernels import coord_draw as cd

    rng = np.random.default_rng(3)
    cb, P, A, _, _, z = _coord_inputs(cuda, rng, 8)
    lam = torch.full((3,), 1e-6, device=cuda)
    mu = torch.zeros(3, device=cuda)
    res = []
    for fn in (cd.coord_draw, cd.coord_draw_plain):
        Pc, Ac = P.clone(), A.clone()
        rej = torch.zeros(cb.F, dtype=torch.int32, device=cuda)
        fn(Pc[:, 1], cb.feat_off, cb.slot_row, cb.slot_val, cb.feat_id, cb.group_id, lam,
           mu, torch.tensor(0.0, device=cuda), z, rej, bound=1.0, e=Ac[:, 0], q=Ac[:, 1])
        res.append((Pc, rej))
    assert torch.equal(res[0][1], res[1][1]) and int(res[0][1].sum()) > cb.F // 2
    assert torch.equal(res[0][0], res[1][0])


@pytest.mark.parametrize("k", CD_KS)
@pytest.mark.parametrize("mode", ["w", "v"])
def test_rel_coord_draw_kernel_matches_plain(cuda, k, mode):
    """rel_coord_draw over a relation's blocks in turn, the caches in
    rel_cache's table (stride 5) and qB a column of a score table (stride
    k+2): theta and every cache within 1e-5 of the plain version."""
    from libfm_tpu_torch.kernels import coord_draw as cd
    from libfm_tpu_torch.kernels.rel_cache import rel_cache
    from libfm_tpu_torch.learners.mcmc_rel_vector import RelLayout
    from libfm_tpu_torch.learners.mcmc_relational import ExactRel

    rng = np.random.default_rng(10 + k)
    nb, nf, nc = 64, 150, 3000
    join = _relation(rng, nb, 6, nf, nc)
    rel = ExactRel(RelLayout(join, join, np.zeros(nf, np.int32), nf, by_shape=False), cuda)
    P = torch.as_tensor(rng.normal(0, 0.3, (nf, k + 1)), dtype=torch.float32, device=cuda)
    T = torch.as_tensor(rng.normal(0, 1, (nc, 2)), dtype=torch.float32, device=cuda)
    C = rel_cache(T, rel.case_off, rel.case_ids)
    SC = torch.as_tensor(rng.normal(0, 0.5, (nb + 1, k + 2)), dtype=torch.float32,
                         device=cuda)
    yb = torch.as_tensor(rng.normal(0, 0.5, nb + 1), dtype=torch.float32, device=cuda)
    lam, mu = torch.full((1,), 2.0, device=cuda), torch.zeros(1, device=cuda)
    alpha = torch.tensor(1.1, device=cuda)
    zs = [torch.as_tensor(rng.normal(0, 1, b.F), dtype=torch.float32, device=cuda)
          for b in rel.blocks]
    outs = []
    for fn in (cd.rel_coord_draw, cd.rel_coord_draw_plain):
        s = dict(P=P.clone(), C=C.clone(), SC=SC.clone(), yb=yb.clone())
        rejs = []
        for b, z in zip(rel.blocks, zs):
            rej = torch.zeros(b.F, dtype=torch.int32, device=cuda)
            extra = ({} if mode == "w" else
                     dict(qb=s["SC"][:, k - 1], weq=s["C"][:, 3], wc=s["C"][:, 2],
                          wc_sqr=s["C"][:, 4]))
            fn(s["P"][:, 0 if mode == "w" else k], b.feat_off, b.slot_row, b.slot_val,
               b.feat_id, b.group_id, lam, mu, alpha, z, rej, bound=1e6, we=s["C"][:, 0],
               wnum=rel.wnum, yb=s["yb"], **extra)
            rejs.append(rej)
        outs.append((s, torch.cat(rejs)))
    torch.cuda.synchronize()
    (sk, rk), (sp, rp) = outs
    for key in sk:
        err = ((sk[key] - sp[key]).abs().max() / sp[key].abs().max().clamp_min(1.0)).item()
        assert err <= 1e-5, (key, err)
    assert torch.equal(rk, rp)


#: plans that put the features of `_coord_inputs`' block in each class:
#: the kernel's thresholds (short, medium and one long feature of 5,000
#: slots), every feature medium (and the long one), every feature of more
#: than 3 slots cut into pieces of 3
CD_PLANS = {"kernel": {}, "medium": dict(short_max=0), "pieces": dict(short_max=0, piece_len=3)}


@pytest.mark.parametrize("plan_kw", sorted(CD_PLANS))
@pytest.mark.parametrize("mode", ["w", "v"])
def test_coord_draw_holds_each_class_of_its_plan(cuda, plan_kw, mode):
    """coord_draw at k = 32 under plans that put the block's features in
    each class (short a warp, medium a CTA, long in pieces with a second
    launch): within 1e-5 of the plain version, the rejection counts
    equal, a second launch the same bits, the launches the plan's."""
    from libfm_tpu_torch.kernels import coord_draw as cd

    k = 32
    rng = np.random.default_rng(21)
    cb, P, A, lam, mu, z = _coord_inputs(cuda, rng, k)
    plan = cd.DrawPlan(cb.feat_off, cuda, **CD_PLANS[plan_kw])
    classes = plan.classes()
    assert classes["long"] > 0 and classes["medium"] > 0
    assert classes["short"] > 1 if plan_kw == "kernel" else classes["short"] == 1  # empty
    col = 0 if mode == "w" else k // 2
    alpha = torch.tensor(1.3, device=cuda)
    outs = []
    for fn in (cd.coord_draw, cd.coord_draw_plain, cd.coord_draw):
        Pc, Ac = P.clone(), A.clone()
        rej = torch.zeros(cb.F, dtype=torch.int32, device=cuda)
        before = kernels.launch_counts()["coord_draw"]
        fn(Pc[:, col], cb.feat_off, cb.slot_row, cb.slot_val, cb.feat_id, cb.group_id,
           lam[:, k // 2], mu[:, k // 2], alpha, z, rej, bound=1e6, e=Ac[:, 0],
           q=None if mode == "w" else Ac[:, col], plan=plan)
        made = kernels.launch_counts()["coord_draw"] - before
        assert made == (plan.launches if fn is cd.coord_draw else 0)
        outs.append((Pc, Ac, rej))
    torch.cuda.synchronize()
    (Pk, Ak, rk), (Pp, Ap, rp), (Pk2, Ak2, rk2) = outs
    for x, y in ((Pk, Pp), (Ak, Ap)):
        assert ((x - y).abs().max() / y.abs().max().clamp_min(1.0)).item() <= 1e-5
    assert torch.equal(rk, rp)
    assert torch.equal(Pk, Pk2) and torch.equal(Ak, Ak2) and torch.equal(rk, rk2)
    assert not plan.pieces.ticket.any()  # left zero for the next call


@pytest.mark.parametrize("plan_kw", sorted(CD_PLANS))
@pytest.mark.parametrize("mode", ["w", "v"])
def test_rel_coord_draw_holds_each_class_of_its_plan(cuda, plan_kw, mode):
    """rel_coord_draw (k = 8) on one block of a relation whose features
    lie on up to ~60 rows, under plans that put them in each class;
    every cache within 1e-5 of the plain version, a second launch the
    same bits."""
    from libfm_tpu_torch.kernels import coord_draw as cd
    from libfm_tpu_torch.kernels.rel_cache import rel_cache_cols
    from libfm_tpu_torch.learners.mcmc_rel_vector import RelLayout
    from libfm_tpu_torch.learners.mcmc_relational import ExactRel

    k = 8
    rng = np.random.default_rng(30)
    nb, nf, nc = 400, 40, 6000
    join = _relation(rng, nb, 6, nf, nc)
    rel = ExactRel(RelLayout(join, join, np.zeros(nf, np.int32), nf, by_shape=False), cuda)
    b = max(rel.blocks, key=lambda blk: blk.slot_row.numel())
    plan = cd.DrawPlan(b.feat_off, cuda, **CD_PLANS[plan_kw])
    P = torch.as_tensor(rng.normal(0, 0.3, (nf, k + 1)), dtype=torch.float32, device=cuda)
    T = torch.as_tensor(rng.normal(0, 1, (nc, 2)), dtype=torch.float32, device=cuda)
    C = rel_cache_cols(T[:, 0], T[:, 1], rel.case_off, rel.case_ids)
    SC = torch.as_tensor(rng.normal(0, 0.5, (nb + 1, k + 2)), dtype=torch.float32,
                         device=cuda)
    yb = torch.as_tensor(rng.normal(0, 0.5, nb + 1), dtype=torch.float32, device=cuda)
    lam, mu = torch.full((1,), 2.0, device=cuda), torch.zeros(1, device=cuda)
    alpha = torch.tensor(1.1, device=cuda)
    z = torch.as_tensor(rng.normal(0, 1, b.F), dtype=torch.float32, device=cuda)
    outs = []
    for fn in (cd.rel_coord_draw, cd.rel_coord_draw_plain, cd.rel_coord_draw):
        s = dict(P=P.clone(), C=C.clone(), SC=SC.clone(), yb=yb.clone())
        rej = torch.zeros(b.F, dtype=torch.int32, device=cuda)
        extra = ({} if mode == "w" else
                 dict(qb=s["SC"][:, k // 2], weq=s["C"][:, 3], wc=s["C"][:, 2],
                      wc_sqr=s["C"][:, 4]))
        fn(s["P"][:, 0 if mode == "w" else 1 + k // 2], b.feat_off, b.slot_row, b.slot_val,
           b.feat_id, b.group_id, lam, mu, alpha, z, rej, bound=1e6, we=s["C"][:, 0],
           wnum=rel.wnum, yb=s["yb"], plan=plan, **extra)
        outs.append((s, rej))
    torch.cuda.synchronize()
    (sk, rk), (sp, rp), (sk2, rk2) = outs
    assert plan.classes()["short" if plan_kw == "kernel" else "medium"] > 0
    assert plan_kw != "pieces" or plan.classes()["long"] > 0
    for key in sk:
        err = ((sk[key] - sp[key]).abs().max() / sp[key].abs().max().clamp_min(1.0)).item()
        assert err <= 1e-5, (key, err)
        assert torch.equal(sk[key], sk2[key])
    assert torch.equal(rk, rp) and torch.equal(rk, rk2)


@pytest.mark.parametrize("layout", ["strided", "contiguous"])
def test_rel_cache_cols_kernel_matches_float64(cuda, layout):
    """The narrow form over two columns (of a [nc, 5] table, stride 5, or
    tensors of their own) on a join whose row 0 holds most cases and row 1
    none: within (the row's cases + 2) roundings of each entry's sum of
    magnitudes, one rel_cache launch, a second launch the same bits."""
    from libfm_tpu_torch.kernels.case_stats import err_over_magnitudes
    from libfm_tpu_torch.kernels.rel_cache import rel_cache_cols, rel_cache_reference
    from libfm_tpu_torch.learners.mcmc_rel_vector import RelLayout
    from libfm_tpu_torch.learners.mcmc_relational import ExactRel

    rng = np.random.default_rng(12)
    nb, nf, nc = 64, 150, 9000
    join = _relation(rng, nb, 6, nf, nc)
    rel = ExactRel(RelLayout(join, join, np.zeros(nf, np.int32), nf, by_shape=False), cuda)
    T = torch.as_tensor(rng.normal(0, 1, (nc, 5)), dtype=torch.float32, device=cuda)
    e, q = (T[:, 0], T[:, 3]) if layout == "strided" else (T[:, 0].clone(), T[:, 3].clone())
    before = kernels.launch_counts()["rel_cache"]
    C = rel_cache_cols(e, q, rel.case_off, rel.case_ids)
    assert kernels.launch_counts()["rel_cache"] == before + 1
    ref, scale = rel_cache_reference(torch.stack([e, q], dim=1), rel.case_off, rel.case_ids)
    lmax = int((rel.case_off[1:] - rel.case_off[:-1]).max())
    assert C.shape == (nb + 1, 5)
    assert err_over_magnitudes(C, ref, scale) <= 2 * (lmax + 2) * U32
    assert not C[1].any() and not C[nb].any()
    assert torch.equal(C, rel_cache_cols(e, q, rel.case_off, rel.case_ids))


def test_rel_cache_kernel_at_k1_matches_plain(cuda):
    """rel_cache over [e | q'] (k = 1, its smallest compiled width) on a
    join whose row 0 holds most cases and row 1 none."""
    from libfm_tpu_torch.kernels.case_stats import err_over_magnitudes
    from libfm_tpu_torch.kernels.rel_cache import rel_cache, rel_cache_reference
    from libfm_tpu_torch.learners.mcmc_rel_vector import RelLayout
    from libfm_tpu_torch.learners.mcmc_relational import ExactRel

    rng = np.random.default_rng(2)
    nb, nf, nc = 64, 150, 5000
    join = _relation(rng, nb, 6, nf, nc)
    rel = ExactRel(RelLayout(join, join, np.zeros(nf, np.int32), nf, by_shape=False), cuda)
    T = torch.as_tensor(rng.normal(0, 1, (nc, 2)), dtype=torch.float32, device=cuda)
    C = rel_cache(T, rel.case_off, rel.case_ids)
    ref, scale = rel_cache_reference(T, rel.case_off, rel.case_ids)
    lmax = int((rel.case_off[1:] - rel.case_off[:-1]).max())
    assert C.shape == (nb + 1, 5)
    assert err_over_magnitudes(C, ref, scale) <= 2 * (lmax + 2) * 2.0 ** -24
    assert not C[1].any() and not C[nb].any()


@pytest.mark.parametrize("task", [0, 1])
def test_exact_als_on_cuda_follows_the_cpu_trajectory(cuda, task):
    """ALSLearner (the flat exact engine), regression and probit, on the
    card against the CPU from the same parameters, 5 iterations: coord_draw
    once a block for w and each factor, fm_refresh (and its probit mode)
    as the engine needs."""
    from libfm_tpu_torch.learners.mcmc import ALSLearner, exact_layout

    train, test, groups = ctr_like(6, 200, 20000, seed=2)
    n, k = train.num_features, 8
    rng = np.random.default_rng(0)
    init = (np.float32(0.0), rng.normal(0, 0.1, n).astype(np.float32),
            rng.normal(0, 0.1, (n, k)).astype(np.float32))
    hist = {}
    for dev in ("cpu", "cuda"):
        kernels.reset_launch_counts()
        lr = ALSLearner(FMConfig(num_features=n, num_factors=k, regw=1.0, regv=1.0),
                        task=task, num_iter=5, seed=1, verbose=False, device=dev,
                        attr_group=groups, init_params=init)
        hist[dev] = lr.learn(train, test)
    counts = {name: c for name, c in kernels.launch_counts().items() if c}
    # one coord_draw launch a block, two on a block with a long feature
    blocks, _ = exact_layout(train, groups, 128, "cpu")
    assert len(blocks) == 6
    want = dict(coord_draw=5 * sum(b.plan.launches for b in blocks) * (1 + k),
                fm_refresh=11 - 5 * task)
    if task:
        want["fm_refresh_probit"] = 5
    assert counts == want
    for hc, hg in zip(hist["cpu"], hist["cuda"]):
        for key in ("test_this", "test_this_m2", "train"):
            assert abs(hc[key] - hg[key]) < 1e-4


@pytest.mark.parametrize("task", [0, 1])
def test_exact_bs_als_on_cuda_follows_the_cpu_trajectory(cuda, task):
    """ALSLearner on relational data (the exact BS engine) with a main
    table of one one-hot field beside one relation, regression and
    probit, on the card against the CPU, 4 iterations, with its exact
    launches."""
    from libfm_tpu_torch.data.dataset import Dataset
    from libfm_tpu_torch.learners.mcmc import ALSLearner

    rng = np.random.default_rng(6)
    n_main, nf, nc, nte, k = 20, 150, 4000, 800, 8
    join = _relation(rng, 64, 6, nf, nc + nte, offset=n_main)
    main = rng.integers(0, n_main, nc + nte).astype(np.int32)
    y = rng.normal(0, 1, nc + nte).astype(np.float32)
    if task:
        y = np.where(y > 0, 1.0, -1.0).astype(np.float32)

    def ds(sl):
        m = len(y[sl])
        d = Dataset(np.arange(m + 1, dtype=np.int64), main[sl], np.ones(m, np.float32),
                    y[sl], n_main)
        d.relations = [join.permuted(np.arange(nc + nte)[sl])]
        return d

    train, test = ds(slice(0, nc)), ds(slice(nc, None))
    n = n_main + nf
    init = (np.float32(0.0), rng.normal(0, 0.1, n).astype(np.float32),
            rng.normal(0, 0.1, (n, k)).astype(np.float32))
    hist = {}
    for dev in ("cpu", "cuda"):
        kernels.reset_launch_counts()
        lr = ALSLearner(FMConfig(num_features=n, num_factors=k, regw=1.0, regv=1.0),
                        task=task, num_iter=4, seed=1, verbose=False, device=dev,
                        init_params=init)
        hist[dev] = lr.learn(train, test)
    counts = {name: c for name, c in kernels.launch_counts().items() if c}
    nrel = counts["rel_coord_draw"] // (4 * (1 + k))
    want = dict(coord_draw=4 * (1 + k), rel_coord_draw=4 * nrel * (1 + k),
                rel_cache=4 * (1 + k), rel_scores=5, rel_refresh=9 - 4 * task)
    if task:
        want["rel_refresh_probit"] = 4
    assert counts == want and nrel >= 2
    for hc, hg in zip(hist["cpu"], hist["cuda"]):
        for key in ("test_this", "test_this_m2", "train"):
            assert abs(hc[key] - hg[key]) < 1e-4


@pytest.mark.parametrize("k", range(1, 129))
@pytest.mark.parametrize("onehot", [True, False])
def test_case_stats_kernel_at_every_k(cuda, k, onehot):
    """case_stats under its launch plan at every k: a feature of several
    pieces, one of a CTA (just past the short length), 150 features of one
    slot, short ones and one with none; against the plain version and
    float64 over each entry's sum of magnitudes; two launches the same
    bits."""
    from libfm_tpu_torch.kernels import case_stats as cs

    rng = np.random.default_rng(k + 1000 * onehot)
    nc, n = 16000, 400
    piece = cs.PIECE_SLOTS[k <= 32]
    short = cs.SHORT_LEN if k <= 32 else piece
    counts = rng.permutation(np.concatenate([[2 * piece + 9, short + 3, 0],
                                             np.ones(150, np.int64),
                                             rng.integers(2, 40, 60)]))
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    sc = rng.permutation(nc)[:off[-1]].astype(np.int32)
    for a, b in zip(off[:-1], off[1:]):
        sc[a:b].sort()
    sv = (np.ones(len(sc)) if onehot else rng.normal(1.0, 0.5, len(sc))).astype(np.float32)
    fid = rng.choice(n, len(counts), replace=False).astype(np.int32)
    A, P, off, sc, sv, fid = _to(
        cuda, rng.normal(0, 1, (nc, k + 1)).astype(np.float32),
        rng.normal(0, 0.3, (n, k + 1)).astype(np.float32), off, sc, sv, fid)
    plan = cs.CaseStatsPlan(off, k, cuda)
    kw = dict(onehot=onehot)
    G_k = cs.case_stats(A, P, off, sc, sv, fid, pieces=plan, **kw)
    G_k2 = cs.case_stats(A, P, off, sc, sv, fid, pieces=plan, **kw)
    G_p = cs.case_stats_plain(A, P, off, sc, sv, fid, **kw)
    ref, scale = cs.case_stats_reference(A, P, off, sc, sv, fid, **kw)
    torch.cuda.synchronize()
    assert torch.equal(G_k, G_k2) and (plan.ticket == 0).all()
    assert ss.gg_rel_err(G_k, G_p, k) < 1e-4
    assert cs.err_over_magnitudes(G_k, ref, scale) < CASE_STATS_TOL


@pytest.mark.parametrize("k", SU_KS)
@pytest.mark.parametrize("onehot", [True, False])
@pytest.mark.parametrize("coverage", [0.05, 1.0])
def test_slot_update_kernel_in_case_order(cuda, k, onehot, coverage):
    """slot_update on a block's slots in case order (`case_order`, as the
    learners hand them over), a twentieth and all of the cases covered:
    against its plain version and dense_update, and the same bits as on
    the per-feature lists (each row's arithmetic does not depend on the
    order)."""
    rng = np.random.default_rng(700 + k + int(coverage * 10) + 2 * onehot)
    nc, F = 20_001, 300  # A's end off a 16-byte boundary for most k
    case = rng.choice(nc, int(coverage * nc), replace=False).astype(np.int32)
    feat = np.sort(rng.integers(0, F, case.size)).astype(np.int32)
    val = (np.ones(case.size) if onehot else rng.normal(1, 0.5, case.size)).astype(np.float32)
    col = np.full(nc, F, np.int32)
    col[case] = feat
    x = np.zeros(nc, np.float32)
    x[case] = val
    oc, ov, of = su.case_order(case, val, feat)
    assert (np.diff(oc) > 0).all()
    A, ct, vt, ft, oct_, ovt, oft, colt, xt = _to(
        cuda, rng.normal(0, 1, (nc, k + 1)).astype(np.float32), case, val, feat, oc, ov, of,
        col, x)
    th_old = torch.as_tensor(rng.normal(0, 0.3, (F, k + 1)), dtype=torch.float32, device=cuda)
    tab = du.update_table(th_old, th_old + 0.1 * torch.randn_like(th_old))
    A_k = su.slot_update(A.clone(), oct_, ovt, oft, tab)
    A_f = su.slot_update(A.clone(), ct, vt, ft, tab)
    A_p = su.slot_update_plain(A.clone(), oct_, ovt, oft, tab)
    A_d = du.dense_update(A.clone(), colt, None if onehot else xt, tab)
    torch.cuda.synchronize()
    assert torch.equal(A_k, A_f)
    assert _col_rel_err(A_k, A_p) < 1e-5
    assert _col_rel_err(A_k, A_d) < 1e-5
    outside = colt == F
    assert torch.equal(A_k[outside], A[outside])


#: the final state two MCMC runs at one seed share, bit for bit
REPRO_KEYS = ("w0", "alpha", "w_mu", "w_lambda", "v_mu", "v_lambda", "w", "V", "pred_sum_all")


@pytest.mark.parametrize("engine", ["vector", "vector probit", "exact", "bs vector"])
def test_mcmc_runs_at_one_seed_end_in_the_same_bits(cuda, engine):
    """Two MCMC runs at one seed, 4 iterations each, end in the same bits:
    P = [w | V], w0, alpha, the hyperpriors and the test prediction sum.
    Every sum of the chain is taken in a fixed order (the hyperprior
    draws' group sums through ops.segment.GroupSums, not index_add_'s
    float atomics)."""
    from libfm_tpu_torch.data.dataset import Dataset
    from libfm_tpu_torch.learners.mcmc import MCMCLearner
    from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner

    if engine == "bs vector":
        rng = np.random.default_rng(4)
        nf, nc = 150, 4000
        join = _relation(rng, 64, 6, nf, nc + 800)
        y = rng.normal(0, 1, nc + 800).astype(np.float32)

        def ds(sl):
            d = Dataset(np.zeros(len(y[sl]) + 1, np.int64), np.empty(0, np.int32),
                        np.empty(0, np.float32), y[sl], 0)
            d.relations = [join.permuted(np.arange(nc + 800)[sl])]
            return d

        train, test = ds(slice(0, nc)), ds(slice(nc, None))
        cls, cfg, kw = MCMCVectorLearner, FMConfig(num_features=nf, num_factors=8), {}
    else:
        train, test, groups = ctr_like(6, 300, 30000, seed=3)
        cls = MCMCLearner if engine == "exact" else MCMCVectorLearner
        cfg = FMConfig(num_features=train.num_features, num_factors=8 if engine == "exact"
                       else 16)
        kw = dict(attr_group=groups, task=TASK_CLASSIFICATION if "probit" in engine else 0)
    states = []
    for _ in range(2):
        lr = cls(cfg, num_iter=4, seed=7, verbose=False, device="cuda", **kw)
        if engine == "bs vector":
            lr.expand_max_ratio = 0.0
        lr.learn(train, test)
        if engine == "bs vector":
            assert lr.relational_mode == "bs_vector"
        states.append(lr._final_state)
    a, b = states
    assert [key for key in REPRO_KEYS if not torch.equal(a[key], b[key])] == []


@pytest.mark.parametrize("engine", ["vector", "vector probit", "exact"])
def test_mcmc_rlog_adds_no_launch(cuda, engine):
    """A small MCMC run makes the same launches, and ends in the same bits,
    with an rlog as without one: the hyperpriors the rlog's columns read
    ride in the iteration's one device-to-host copy."""
    import io

    from libfm_tpu_torch.learners.mcmc import MCMCLearner
    from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner
    from libfm_tpu_torch.utils.rlog import RLog

    train, test, groups = ctr_like(6, 300, 30000, seed=3)
    cls = MCMCLearner if engine == "exact" else MCMCVectorLearner
    cfg = FMConfig(num_features=train.num_features, num_factors=8)
    task = TASK_CLASSIFICATION if "probit" in engine else 0
    runs = []
    for rlog in (None, RLog(io.StringIO())):
        lr = cls(cfg, num_iter=4, seed=7, verbose=False, device="cuda", attr_group=groups,
                 task=task, rlog=rlog)
        lr.register_log_fields()
        if rlog is not None:
            rlog.init()
        kernels.reset_launch_counts()
        lr.learn(train, test)
        torch.cuda.synchronize()
        runs.append((kernels.launch_counts(), lr._final_state))
    (counts, a), (counts_rlog, b) = runs
    assert counts == counts_rlog and sum(counts.values()) > 0
    assert [key for key in REPRO_KEYS if not torch.equal(a[key], b[key])] == []
    lines = rlog._out.getvalue().splitlines()
    assert len(lines) == 5 and f"vmu[{int(groups.max())},7]" in lines[0].split("\t")


@pytest.mark.parametrize("do_sample", [True, False])
def test_schur_draw_kernel_k0_is_the_scalar_draw(cuda, do_sample):
    """At k = 0 schur_draw is the JAX engine's scalar conjugate draw of w
    (`scalar_draw_plain`): the plain version's bits on the card (each
    operation rounded on its own, in its order), a draw past the bound and
    a NaN rejected with the old w kept, more features than one CTA; its
    relational form keeps refusing k = 0."""
    rng = np.random.default_rng(1300 + do_sample)
    F = 5000
    GG, theta, lam, mu, z = _to(
        cuda,
        np.stack([rng.uniform(0, 50, F), rng.normal(0, 5, F)], axis=1).astype(np.float32),
        rng.normal(0, 0.1, (F, 1)).astype(np.float32),
        rng.uniform(0.5, 5, (F, 1)).astype(np.float32),
        rng.normal(0, 0.1, (F, 1)).astype(np.float32),
        rng.normal(size=(F, 1)).astype(np.float32),
    )
    mu[1] = 1e9  # a mean beyond the bound
    GG[2, 0] = float("nan")
    alpha = torch.tensor(1.3, device=cuda)
    before = kernels.launch_counts()["schur_draw"]
    t_k, r_k, t_p = _draw_both(GG, theta, lam, mu, z, alpha, do_sample, 100.0)
    assert kernels.launch_counts()["schur_draw"] == before + 1
    assert r_k[1].item() == 1 and r_k[2].item() == 1 and int(r_k.sum()) == 2
    assert torch.equal(t_k, t_p)
    with pytest.raises(ValueError, match="k=0"):
        sd.schur_draw_rel(GG, theta, lam, mu, z, alpha, torch.zeros(3, 1, device=cuda),
                          torch.zeros(F + 1, dtype=torch.int64, device=cuda),
                          torch.zeros(0, dtype=torch.int32, device=cuda),
                          torch.zeros(0, device=cuda), do_sample=do_sample, bound=100.0)


@pytest.mark.parametrize("route", ["case_major", "slot_stats", "slot_update"])
def test_als_k0_on_cuda_follows_the_cpu_trajectory(cuda, route):
    """The pure linear model's ALS on the card (fm_refresh, the statistics
    of the route, schur_draw's scalar draw, the update of the route)
    against the CPU from the same w, with exact launches."""
    train, test = movielens_like(300, 200, 30000, seed=5)
    n = train.num_features
    rng = np.random.default_rng(0)
    init = (np.float32(0.0), rng.normal(0, 0.1, n).astype(np.float32),
            np.zeros((n, 0), np.float32))
    flags = dict(case_major=dict(), slot_stats=dict(case_major_stats=False),
                 slot_update=dict(dense_update=False))[route]
    cfg = FMConfig(num_features=n, num_factors=0, regw=2.0, regv=2.0)
    runs = {}
    for dev in ("cpu", "cuda"):
        learner = ALSVectorLearner(cfg, num_iter=6, seed=1, verbose=False, device=dev,
                                   init_params=init, **flags)
        kernels.reset_launch_counts()
        runs[dev] = learner.learn(train, test)
        counts = kernels.launch_counts()
    for hc, hg in zip(runs["cpu"], runs["cuda"]):
        assert abs(hc["test_this"] - hg["test_this"]) < 1e-5
        assert abs(hc["train"] - hg["train"]) < 1e-5
    stats = "case_stats" if route == "case_major" else "slot_stats"
    update = "slot_update" if route == "slot_update" else "dense_update"
    assert counts[stats] == counts["schur_draw"] == counts[update] == 12
    # the initial refresh, a test prediction an iteration, the refreshes
    # at iterations 0 and 5
    assert counts["fm_refresh"] == 1 + 6 + 2


@pytest.mark.parametrize("engine", ["vector", "vector probit", "exact", "bs vector"])
def test_checkpoint_resumes_on_the_card_the_same_bits(cuda, engine, tmp_path):
    """A chain saved at iteration 4 on the card (the CUDA generator's
    state with it) and resumed to 8 twice: the same bits both times,
    within 1e-4 of the straight run's test_this (5e-3 under probit)."""
    from libfm_tpu_torch.learners.mcmc import MCMCLearner
    from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner

    if engine == "bs vector":
        from test_torch_checkpoint import single_rel_problem

        train, test, n = single_rel_problem()
        groups = None
    else:
        train, test, groups = ctr_like(6, 300, 30000, seed=3)
        n = train.num_features
    cls = MCMCLearner if engine == "exact" else MCMCVectorLearner
    task = TASK_CLASSIFICATION if "probit" in engine else 0
    path = str(tmp_path / "chain.npz")

    def run(iters, every, ckpt=True):
        lr = cls(FMConfig(num_features=n, num_factors=8), num_iter=iters, seed=7,
                 verbose=False, device="cuda", attr_group=groups, task=task,
                 checkpoint_path=path if ckpt else None, checkpoint_every=every)
        if engine == "bs vector":
            lr.expand_max_ratio = 0.0
        lr.learn(train, test)
        return lr

    straight = run(8, 0, ckpt=False)
    run(4, 4)
    a, b = run(8, 0), run(8, 0)
    assert [h["iter"] for h in a.history] == list(range(4, 8))
    assert [key for key in REPRO_KEYS if not torch.equal(a._final_state[key],
                                                         b._final_state[key])] == []
    got = np.array([h["test_this"] for h in a.history])
    want = np.array([h["test_this"] for h in straight.history[4:]])
    if task:
        np.testing.assert_allclose(got, want, atol=5e-3)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_streamed_als_is_the_resident_run_on_the_card(cuda, tmp_path):
    """chip_smoke.py's stream_als_3 check at a small size: ALS from a
    StreamingDataset (train in windows of 700 entries, its blocks from the
    .xt) ends in the resident run's bits (P, the sampler state, every
    reading) with the same launches, the test tail off."""
    from libfm_tpu_torch.data.streaming import StreamingDataset

    train, test = movielens_like(num_users=300, num_items=200, num_ratings=20000, seed=5)
    train.to_binary(str(tmp_path / "tr"), with_transpose=True)
    runs = []
    for data in ((train, test), (StreamingDataset(str(tmp_path / "tr.x"),
                                                  str(tmp_path / "tr.y"), 700), test)):
        lr = ALSVectorLearner(FMConfig(num_features=train.num_features, num_factors=16,
                                       regw=5.0, regv=5.0),
                              num_iter=3, seed=1, verbose=False, device="cuda")
        lr.flat_incr_test = False
        kernels.reset_launch_counts()
        lr.learn(*data)
        torch.cuda.synchronize()
        runs.append((lr, kernels.launch_counts()))
    (res, res_n), (got, got_n) = runs
    assert got_n == res_n and got_n["schur_draw"] > 0
    assert ([{key: v for key, v in h.items() if key != "time"} for h in got.history]
            == [{key: v for key, v in h.items() if key != "time"} for h in res.history])
    assert [key for key in REPRO_KEYS if not torch.equal(got._final_state[key],
                                                         res._final_state[key])] == []

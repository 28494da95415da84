"""The kernels' plain PyTorch versions on the CPU, against the JAX
reference or a direct numpy computation:

- schur_draw against JAX `mcmc_rel_vector.blocked_theta_draw` (the same
  blocked draw on the full k x k statistic) with the same noise z, in
  both sample modes, at k = 4, 8 and 64 (config #3's width); atol 1e-4
  (fp32 Cholesky in another order);
- slot_stats against numpy H^T H, H^T e with H = [x, x qp] per feature,
  at near-uniform and skewed slot counts, k = 6 and 64; rtol 1e-4 /
  atol 1e-4;
- the padded width the two CUDA kernels are compiled for;
- dense_update against numpy, one-hot and valued; atol 1e-5.

The CUDA kernels are held to these plain versions by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfm_tpu.learners.mcmc_rel_vector import blocked_theta_draw
from libfm_tpu_torch import kernels as kmod
from libfm_tpu_torch.data.batching import FeatureBlock, feature_slots
from libfm_tpu_torch.kernels import dense_update as kdu
from libfm_tpu_torch.kernels import schur_draw as ksd
from libfm_tpu_torch.kernels import slot_stats as kss


def _stats(rng, F, k, W):
    """Consistent per-feature statistics from random slot data: the full
    k x k form for JAX and the packed GG row for the port."""
    x = rng.normal(1.0, 0.3, (F, W))
    qp = rng.normal(0, 1.0, (F, W, k))
    e = rng.normal(0, 1.0, (F, W))
    hq = x[..., None] * qp
    Qq = np.einsum("fwi,fwj->fij", hq, hq)
    qa = np.einsum("fwi,fw->fi", hq, x)
    qe = np.einsum("fwi,fw->fi", hq, e)
    aa = (x * x).sum(1)
    ae = (x * e).sum(1)
    iu0, iu1 = np.triu_indices(k)
    full = np.concatenate([Qq.reshape(F, -1), qa, qe, aa[:, None], ae[:, None]], 1)
    packed = np.concatenate([Qq[:, iu0, iu1], qa, qe, aa[:, None], ae[:, None]], 1)
    return full.astype(np.float32), packed.astype(np.float32)


@pytest.mark.parametrize("do_sample", [False, True])
@pytest.mark.parametrize("k", [4, 8, 64])
def test_schur_draw_plain_matches_blocked_theta_draw(do_sample, k):
    rng = np.random.default_rng(10 + k + do_sample)
    F, W, d = 37, 24, k + 1
    full, packed = _stats(rng, F, k, W)
    th = rng.normal(0, 0.1, (F, d)).astype(np.float32)
    lam = rng.uniform(0.5, 5.0, (F, d)).astype(np.float32)
    mu = rng.normal(0, 0.1, (F, d)).astype(np.float32)
    z = rng.normal(size=(F, d)).astype(np.float32)
    alpha = 1.7
    jt, jr = blocked_theta_draw(
        jnp.asarray(full), jnp.asarray(th), jnp.asarray(lam), jnp.asarray(mu),
        jnp.asarray(z), jnp.float32(alpha), k, do_sample, bound=1e6,
    )
    tt, tr = ksd.schur_draw(
        torch.tensor(packed), torch.tensor(th), torch.tensor(lam),
        torch.tensor(mu), torch.tensor(z), torch.tensor(alpha, dtype=torch.float32),
        do_sample=do_sample, bound=1e6,
    )
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    assert int(tr.sum()) == int(jr) == 0


def test_schur_draw_plain_guard_keeps_old_theta():
    """A draw beyond the bound (or not finite) keeps the old theta and is
    flagged, like the JAX guard."""
    rng = np.random.default_rng(7)
    k, F = 4, 6
    full, packed = _stats(rng, F, k, 10)
    th = rng.normal(0, 0.1, (F, k + 1)).astype(np.float32)
    lam = np.ones((F, k + 1), np.float32)
    mu = np.full((F, k + 1), 50.0, np.float32)  # pulls the means far out
    jt, jr = blocked_theta_draw(
        jnp.asarray(full), jnp.asarray(th), jnp.asarray(lam), jnp.asarray(mu),
        jnp.zeros((F, k + 1)), jnp.float32(1.0), k, False, bound=1.0,
    )
    tt, tr = ksd.schur_draw(
        torch.tensor(packed), torch.tensor(th), torch.tensor(lam),
        torch.tensor(mu), None, torch.tensor(1.0), do_sample=False, bound=1.0,
    )
    assert int(tr.sum()) == int(jr) > 0
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_array_equal(tt.numpy()[tr.numpy() == 1], th[tr.numpy() == 1])


def _numpy_stats(A, P, features, off, sc, sv, use_linear):
    k = P.shape[1] - 1
    iu0, iu1 = np.triu_indices(k)
    rows = []
    for j, fid in enumerate(features):
        c = sc[off[j]:off[j + 1]].astype(np.int64)
        x = sv[off[j]:off[j + 1]].astype(np.float64)
        qp = A[c, 1:] - x[:, None] * P[fid, 1:][None, :]
        H = np.concatenate([x[:, None] * (1.0 if use_linear else 0.0),
                            x[:, None] * qp], 1)
        HtH = H.T @ H
        Hte = H.T @ A[c, 0]
        rows.append(np.concatenate([
            HtH[1:, 1:][iu0, iu1], HtH[1:, 0], Hte[1:], [HtH[0, 0]], [Hte[0]],
        ]))
    return np.asarray(rows)


@pytest.mark.parametrize("k", [6, 64])
@pytest.mark.parametrize("use_linear", [True, False])
@pytest.mark.parametrize("skewed", [False, True])
def test_slot_stats_plain_matches_numpy(use_linear, skewed, k):
    rng = np.random.default_rng(20 + skewed)
    nc, F, n = 600, 25, 40
    if skewed:  # counts far from uniform
        counts = np.minimum(rng.zipf(1.6, F), 90)
    else:
        counts = rng.integers(15, 25, F)
    counts = np.minimum(counts, nc)
    entry_feat = np.repeat(np.arange(F, dtype=np.int32), counts)
    entry_rows = np.concatenate(
        [rng.choice(nc, c, replace=False) for c in counts]
    ).astype(np.int32)
    entry_vals = rng.normal(1.0, 0.5, len(entry_rows)).astype(np.float32)
    features = rng.choice(n, F, replace=False).astype(np.int32)
    off, sc, sv = feature_slots(FeatureBlock(features, entry_rows, entry_vals, entry_feat))
    assert off[-1] == len(entry_rows)
    A = rng.normal(0, 1, (nc, k + 1)).astype(np.float32)
    P = rng.normal(0, 0.3, (n, k + 1)).astype(np.float32)
    GG = kss.slot_stats(
        torch.tensor(A), torch.tensor(P), torch.tensor(off), torch.tensor(sc),
        torch.tensor(sv), torch.tensor(features), use_linear=use_linear,
    )
    ref = _numpy_stats(A.astype(np.float64), P.astype(np.float64), features,
                       off, sc, sv, use_linear)
    assert GG.shape == (F, kss.gg_width(k))
    np.testing.assert_allclose(GG.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_padded_width_is_the_smallest_compiled_width_that_holds_k():
    """slot_stats and schur_draw run a k-factor system at this width."""
    for k in range(1, kmod.PADDED_WIDTHS[-1] + 1):
        kp = kmod.padded_width(k)
        assert kp in kmod.PADDED_WIDTHS and k <= kp
        assert all(w < k for w in kmod.PADDED_WIDTHS if w < kp)
    assert [kmod.padded_width(k) for k in (1, 16, 17, 33, 64, 65)] == [16, 16, 32, 64, 64, 128]


@pytest.mark.parametrize("k", [0, 129])
def test_padded_width_refuses_what_the_kernels_do_not_take(k):
    with pytest.raises(ValueError):
        kmod.padded_width(k)


@pytest.mark.parametrize("onehot", [True, False])
def test_dense_update_plain_matches_numpy(onehot):
    rng = np.random.default_rng(30 + onehot)
    nc, F, k = 200, 15, 5
    A = rng.normal(0, 1, (nc, k + 1)).astype(np.float32)
    col = rng.integers(0, F + 1, nc).astype(np.int32)  # F: case not in block
    val = None if onehot else np.where(col != F, rng.normal(1, 0.5, nc), 0).astype(np.float32)
    th_old = rng.normal(0, 0.3, (F, k + 1)).astype(np.float32)
    th_new = th_old + rng.normal(0, 0.1, (F, k + 1)).astype(np.float32)
    tab = kdu.update_table(torch.tensor(th_old), torch.tensor(th_new))
    assert tab.shape == (F + 1, k + 2) and float(tab[F].abs().max()) == 0.0
    out = kdu.dense_update(torch.tensor(A), torch.tensor(col),
                           None if onehot else torch.tensor(val), tab)
    ref = A.astype(np.float64).copy()
    x = (col != F).astype(np.float64) if onehot else val.astype(np.float64)
    for c in range(nc):
        if col[c] == F:
            continue
        dv = (th_new - th_old)[col[c]].astype(np.float64)
        vold = th_old[col[c], 1:].astype(np.float64)
        qp = ref[c, 1:] - x[c] * vold
        ref[c, 0] += x[c] * (dv[0] + qp @ dv[1:])
        ref[c, 1:] += x[c] * dv[1:]
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
def test_check_aligned_refuses_views_off_16_bytes(offset):
    """The alignment check of the bulk-copy kernels (dense_update's A,
    fm_refresh's train-mode A): a view `offset` floats into a fresh
    buffer passes only on a 16-byte boundary."""
    buf = torch.zeros(64 + 8)
    assert buf.data_ptr() % 16 == 0
    view = buf[offset:offset + 64].view(8, 8)
    if offset % 4 == 0:
        kmod.check_aligned(view, "A")
    else:
        with pytest.raises(ValueError, match=f"{4 * offset} bytes past a 16-byte"):
            kmod.check_aligned(view, "A")


def test_wrappers_take_unaligned_cpu_views_and_empty_inputs_by_plain_versions():
    """On CPU tensors the wrappers run the plain versions, whatever the
    alignment; no rows at all give an empty result and a zero error sum."""
    from libfm_tpu_torch.kernels import fm_refresh as kfr

    rng = np.random.default_rng(40)
    nc, F, k = 50, 6, 3
    A = torch.tensor(rng.normal(0, 1, (nc, k + 1)).astype(np.float32))
    buf = torch.zeros(nc * (k + 1) + 1)
    A_off = buf[1:].view(nc, k + 1)
    A_off.copy_(A)
    col = torch.tensor(rng.integers(0, F + 1, nc).astype(np.int32))
    th = torch.tensor(rng.normal(0, 0.3, (F, k + 1)).astype(np.float32))
    tab = kdu.update_table(th, th + 0.1)
    assert torch.equal(kdu.dense_update(A_off, col, None, tab),
                       kdu.dense_update(A.clone(), col, None, tab))
    P = torch.tensor(rng.normal(0, 0.3, (9, k + 1)).astype(np.float32))
    ids = torch.zeros(0, 2, dtype=torch.int32)
    vals = torch.zeros(0, 2)
    w0 = torch.tensor(1.0)
    assert kfr.fm_refresh(P, ids, vals, w0).shape == (0,)
    sse = kfr.fm_refresh(P, ids, vals, w0, torch.zeros(0), torch.zeros(0, k + 1))
    assert sse.shape == () and float(sse) == 0.0


@pytest.mark.parametrize("k", [1, 2, 3, 5, 64])
def test_update_table_rows_lie_whole_16_byte_pieces_apart(k):
    """dense_update's kernel copies each table row it gathers as one bulk
    copy: the rows of update_table lie k+2 rounded up to 4 floats apart,
    and the values are [dw | dv | v_old . dv] with a zero row F."""
    rng = np.random.default_rng(50 + k)
    F = 9
    th_old = torch.tensor(rng.normal(0, 0.3, (F, k + 1)).astype(np.float32))
    th_new = th_old + torch.tensor(rng.normal(0, 0.1, (F, k + 1)).astype(np.float32))
    tab = kdu.update_table(th_old, th_new)
    assert tab.shape == (F + 1, k + 2)
    assert tab.stride() == (kdu.table_stride(k + 2), 1)
    assert kdu.table_stride(k + 2) % 4 == 0 and 0 <= kdu.table_stride(k + 2) - (k + 2) < 4
    delta = th_new - th_old
    assert torch.equal(tab[:F, :k + 1], delta)
    torch.testing.assert_close(tab[:F, k + 1], (th_old[:, 1:] * delta[:, 1:]).sum(1))
    assert float(tab[F].abs().max()) == 0.0

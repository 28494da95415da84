"""Port vs JAX: the plain batched Cholesky/solves (against
`libfm_tpu.ops.lane_chol`), the samplers and the segment sum, on the CPU.

Cholesky tolerance: atol 1e-4, the same as tests/test_lane_chol.py holds
the lane Cholesky to XLA's — fp32, a different elimination order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfm_tpu.ops import lane_chol as jchol
from libfm_tpu.ops import samplers as jsamp
from libfm_tpu_torch.ops import lane_chol as tchol
from libfm_tpu_torch.ops import samplers as tsamp
from libfm_tpu_torch.ops.segment import run_sums, seg_sum, sorted_index_add_


@pytest.mark.parametrize("C,W", [(7, 5), (64, 32), (16, 128), (3, 1)])
def test_plain_cholesky_and_solves_match_lane_chol(C, W):
    rng = np.random.default_rng(C * 131 + W)
    Pm = rng.standard_normal((C, W, W))
    M = (Pm @ np.swapaxes(Pm, 1, 2) / W + 3.0 * np.eye(W)).astype(np.float32)
    b = rng.standard_normal((C, W)).astype(np.float32)

    Lj = jchol.cholesky_lanes(jnp.asarray(M))
    Lt = tchol.cholesky_lanes(torch.tensor(M))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=1e-4)
    assert float(torch.triu(Lt, 1).abs().max()) == 0.0

    yj = jchol.solve_lower_lanes(Lj, jnp.asarray(b))
    yt = tchol.solve_lower_lanes(Lt, torch.tensor(b))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4)

    xj = jchol.solve_upper_lanes(Lj, yj)
    xt = tchol.solve_upper_lanes(Lt, yt)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)


def test_plain_cholesky_not_pd_gives_nan():
    """Like the lane Cholesky (sqrt of a negative pivot), a system that is
    not positive definite yields NaN, which the draw guard rejects."""
    M = torch.eye(4).repeat(3, 1, 1)
    M[1, 2, 2] = -1.0
    L = tchol.cholesky_lanes(M)
    assert torch.isnan(L[1]).all()
    assert torch.isfinite(L[0]).all() and torch.isfinite(L[2]).all()
    Lj = jchol.cholesky_lanes(jnp.asarray(M.numpy()))
    assert not np.isfinite(np.asarray(Lj[1])).all()


def test_finite_or_matches_jax():
    new = np.array([1.0, np.nan, np.inf, -3e7, 2e6, -1.0], np.float32)
    old = np.arange(6, dtype=np.float32)
    for bound in (None, 1e6):
        jv, jn = jsamp.finite_or(jnp.asarray(new), jnp.asarray(old), bound=bound)
        tv, tn = tsamp.finite_or(torch.tensor(new), torch.tensor(old), bound=bound)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert int(tn) == int(jn)
    assert tsamp.DRAW_BOUND == jsamp.DRAW_BOUND


def test_gaussian_moments():
    g = torch.Generator().manual_seed(3)
    mean = torch.tensor([[-2.0], [0.5], [3.0]])
    x = tsamp.gaussian(g, mean, torch.full((3, 200_000), 0.5))
    assert x.shape == (3, 200_000)
    np.testing.assert_allclose(x.mean(dim=1).numpy(), [-2.0, 0.5, 3.0], atol=0.01)
    np.testing.assert_allclose(x.std(dim=1).numpy(), [0.5] * 3, atol=0.01)


def test_gamma_moments_and_broadcast():
    """Gamma(shape a, rate b): mean a/b, var a/b^2. A [G,1] shape with a
    [G,k] rate draws G*k independent variates (JAX samplers.gamma)."""
    g = torch.Generator().manual_seed(4)
    a = torch.tensor([[2.0], [50.0]])
    b = torch.full((2, 100_000), 4.0)
    x = tsamp.gamma(g, a, b)
    assert x.shape == (2, 100_000)
    np.testing.assert_allclose(x.mean(dim=1).numpy(), [0.5, 12.5], rtol=0.01)
    np.testing.assert_allclose(x.var(dim=1).numpy(), [2 / 16, 50 / 16], rtol=0.03)
    y = tsamp.gamma(g, torch.tensor([[3.0]]), torch.ones(1, 4))
    assert len(set(y.reshape(-1).tolist())) == 4  # not one shared variate
    jx = jsamp.gamma(jax.random.PRNGKey(0), jnp.asarray([[2.0], [50.0]]),
                     jnp.full((2, 100_000), 4.0))
    np.testing.assert_allclose(np.asarray(jx).mean(axis=1), [0.5, 12.5], rtol=0.01)


def test_seg_sum_matches_numpy():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(100, 3)).astype(np.float32)
    ids = rng.integers(0, 7, 100)
    ref = np.zeros((7, 3), np.float32)
    np.add.at(ref, ids, data)
    out = seg_sum(torch.tensor(data), torch.tensor(ids), 7)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("shape", [(), (3,)])
@pytest.mark.parametrize("longest", [1, 2, 7, 300])
def test_run_sums_add_each_run_in_a_fixed_order(shape, longest):
    """run_sums (the CUDA path of sorted_index_add_) gives each run of
    equal sorted ids once, with its rows' sum: equal to the float64 sum to
    float32 rounding, the same bits on a second call."""
    rng = np.random.default_rng(longest)
    lens = rng.integers(1, longest + 1, 40)
    ids = np.repeat(np.sort(rng.choice(1000, 40, replace=False)), lens)
    rows = rng.normal(size=(len(ids),) + shape).astype(np.float32)
    got_ids, got = run_sums(torch.tensor(ids, dtype=torch.int32), torch.tensor(rows))
    got_ids2, got2 = run_sums(torch.tensor(ids, dtype=torch.int32), torch.tensor(rows))
    assert got_ids.tolist() == sorted(set(ids.tolist()))
    assert torch.equal(got, got2) and torch.equal(got_ids, got_ids2)
    ref = np.zeros((1000,) + shape)
    np.add.at(ref, ids, rows.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), ref[got_ids.numpy()], rtol=1e-5, atol=1e-5)


def test_sorted_index_add_on_the_cpu_is_index_add():
    rng = np.random.default_rng(4)
    ids = torch.tensor(np.sort(rng.integers(0, 9, 200)))
    rows = torch.tensor(rng.normal(size=(200, 4)).astype(np.float32))
    out = torch.ones(9, 4)
    want = torch.ones(9, 4).index_add_(0, ids, rows)
    assert sorted_index_add_(out, ids, rows) is out
    assert torch.equal(out, want)

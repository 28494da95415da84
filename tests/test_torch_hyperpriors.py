"""The hyperprior draws' group sums, taken in a fixed order (no float
atomics), against the JAX package on the CPU.

- `GroupSums`' set-up: the stable sort by group and the groups' offsets
  cover every row once, each group's rows in their own order; every
  chunk of the first level holds rows of one group, and the second level
  holds every chunk once.
- The port's `draw_theta_hyperpriors` with do_sample=False (posterior
  means: lambda = (alpha_0 + n_g + 1) / gamma_g, then mu from the new
  lambda) against `libfm_tpu.learners.mcmc.draw_theta_hyperpriors` on
  the same numpy inputs: theta of shape [n] and [n, k], G = 1, 2, 13 and
  26, the group ids unsorted and a group in the middle with no row.
  Tolerance: lambda and mu within 1e-5 of the scale of what each sums,
  the group's sum of |theta - mu| squared (lambda's gamma) or of |theta|
  (mu's mean), taken relative to that sum: float32 sums of up to 5,000
  rows in two different orders. A group with no row takes the prior's
  value in both, to 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libfm_tpu.learners import mcmc as jax_mcmc
from libfm_tpu_torch.learners.mcmc import draw_theta_hyperpriors
from libfm_tpu_torch.ops.segment import GroupSums

#: alpha_0, gamma_0, beta_0, mu_0 (libFM's defaults)
PRIOR = (1.0, 1.0, 1.0, 0.0)
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread while the file runs (the order of a CPU sum
    then does not depend on the machine's cores)."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@jax.jit
def _jax_means(theta, attr_group, counts, mu_cur, lambda_cur):
    return jax_mcmc.draw_theta_hyperpriors(
        jax.random.PRNGKey(0), theta, attr_group, counts, mu_cur, lambda_cur, *PRIOR,
        do_sample=False)


def _groups(rng, n, G):
    """Unsorted group ids in [0, G), group G // 2 empty where G > 2."""
    g = rng.integers(0, G, n)
    if G > 2:
        g[g == G // 2] = G // 2 + 1
    return g.astype(np.int32)


@pytest.mark.parametrize("G", [1, 2, 13, 26])
@pytest.mark.parametrize("chunk", [3, 256])
def test_group_sums_setup_covers_every_row_once(G, chunk):
    rng = np.random.default_rng(G)
    g = _groups(rng, 4000, G)
    gs = GroupSums(g, G, "cpu", chunk=chunk)
    counts = np.bincount(g, minlength=G)
    assert sorted(gs.perm.tolist()) == list(range(len(g)))
    assert (np.diff(gs.offsets) == counts).all() and gs.offsets[-1] == len(g)
    for h in range(G):
        run = gs.perm[gs.offsets[h]:gs.offsets[h + 1]]
        assert (g[run] == h).all() and (np.diff(run) > 0).all()  # stable
    rows, valid = gs.rows.numpy(), gs.valid.numpy()
    assert sorted(rows[valid].tolist()) == list(range(len(g)))
    for r, v in zip(rows, valid):
        assert len(set(g[r[v]].tolist())) == 1  # a chunk lies in one group
    nch = rows.shape[0]
    idx2 = gs.idx2.numpy()
    assert sorted(idx2[idx2 < nch].tolist()) == list(range(nch))
    assert (gs.count.numpy() == counts).all()
    assert G <= 2 or counts[G // 2] == 0


@pytest.mark.parametrize("G", [1, 2, 13, 26])
@pytest.mark.parametrize("k", [0, 8])
def test_means_match_jax(G, k):
    rng = np.random.default_rng(100 * G + k)
    n = 5000
    g = _groups(rng, n, G)
    shape = (n, k) if k else (n,)
    gshape = (G, k) if k else (G,)
    theta = rng.normal(0.3, 1.0, shape).astype(np.float32)
    mu_cur = rng.normal(0.0, 0.2, gshape).astype(np.float32)
    lam_cur = rng.uniform(0.5, 2.0, gshape).astype(np.float32)
    counts = np.bincount(g, minlength=G).astype(np.float32)

    gs = GroupSums(g, G, "cpu")
    lam, mu, rej = draw_theta_hyperpriors(
        None, torch.as_tensor(theta), gs, torch.as_tensor(mu_cur), torch.as_tensor(lam_cur),
        *PRIOR, do_sample=False)
    # JAX's function takes the counts in theta's rank: [G, 1] beside [n, k]
    counts_j = counts[:, None] if k else counts
    lam_j, mu_j, rej_j = (np.asarray(x) for x in _jax_means(
        jnp.asarray(theta), jnp.asarray(g), jnp.asarray(counts_j), jnp.asarray(mu_cur),
        jnp.asarray(lam_cur)))
    assert int(rej) == int(rej_j) == 0

    c = counts.reshape((G,) + (1,) * (theta.ndim - 1)).astype(np.float64)
    beta_0 = PRIOR[2]
    abs_mag = np.zeros(gshape)
    np.add.at(abs_mag, g, np.abs(theta.astype(np.float64)))
    # lambda = (alpha_0 + c + 1) / gamma, gamma a sum of squares (its own
    # sum of magnitudes): lambda's error over lambda is gamma's over gamma.
    # mu = (sum + beta_0 mu_0) / (c + beta_0): its error is the sum's over
    # c + beta_0
    lam_err = np.abs(lam.numpy() - lam_j) / lam_j
    mu_err = np.abs(mu.numpy() - mu_j) * (c + beta_0) / np.maximum(abs_mag, 1e-30)
    empty = np.broadcast_to(c == 0, gshape)
    assert lam_err.max() <= TOL
    assert mu_err[~empty].max() <= TOL
    assert np.abs(mu.numpy() - mu_j)[empty].max(initial=0.0) <= 1e-6

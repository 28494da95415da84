"""schur_draw's relational form (`schur_draw_rel`: the BS engine's draw with
K10's update of SD folded in) on the CPU, where it runs its plain version:

- bit for bit `schur_draw_plain` then `rel_update_plain`, at k = 1, 3, 8
  and 32, sampling and not, with and without rejected draws (a bound
  that a third of the draws exceed);
- theta against the JAX engine's `blocked_theta_draw` on the same noise
  (atol 1e-4, as the plain schur_draw's own test) and SD against the
  update written out in numpy float64 (rtol 1e-5);
- the entry lists it refuses: feat_off of another length, entry_x of
  another length than entry_b, entries not 1-D, feat_off not running
  over all the entries.

The CUDA kernel is held to the same plain pair on the card
(tests/test_torch_cuda.py, chip_smoke.py's bench_bs rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libfm_tpu.learners.mcmc_rel_vector import blocked_theta_draw
from libfm_tpu_torch import kernels
from libfm_tpu_torch.kernels import rel_sweep as rs
from libfm_tpu_torch.kernels import schur_draw as ksd


def _block(k, seed, F=23, nb=400, bound_frac=0.0, do_sample=True):
    """A conflict-free block of F features over nb block rows (features of
    0 to 12 entries, the entries' rows all distinct), its statistics as the
    full and the packed GG rows, old theta, priors, noise and an SD; the
    bound that `bound_frac` of the draws in mode `do_sample` (by their
    largest component) exceed, or 1e6."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 13, F)
    counts[0], counts[1] = 0, 12
    E = int(counts.sum())
    feat_off = np.zeros(F + 1, np.int64)
    np.cumsum(counts, out=feat_off[1:])
    entry_b = rng.permutation(nb)[:E].astype(np.int32)
    entry_x = rng.normal(1.0, 0.5, E).astype(np.float32)
    W, d = 16, k + 1
    x = rng.normal(1.0, 0.3, (F, W))
    hq = x[..., None] * rng.normal(0, 1.0, (F, W, k))
    e = rng.normal(0, 1.0, (F, W))
    Qq = np.einsum("fwi,fwj->fij", hq, hq)
    parts = [np.einsum("fwi,fw->fi", hq, x), np.einsum("fwi,fw->fi", hq, e),
             (x * x).sum(1)[:, None], (x * e).sum(1)[:, None]]
    iu0, iu1 = np.triu_indices(k)
    full = np.concatenate([Qq.reshape(F, -1)] + parts, 1).astype(np.float32)
    packed = np.concatenate([Qq[:, iu0, iu1]] + parts, 1).astype(np.float32)
    th = rng.normal(0, 0.1, (F, d)).astype(np.float32)
    lam = rng.uniform(0.5, 5.0, (F, d)).astype(np.float32)
    mu = rng.normal(0, 0.1, (F, d)).astype(np.float32)
    z = rng.normal(size=(F, d)).astype(np.float32)
    SD = rng.normal(0, 0.3, (nb + 1, d)).astype(np.float32)
    SD[nb] = 0.0
    bound = 1e6
    if bound_frac:
        free, _ = ksd.schur_draw_plain(torch.tensor(packed), torch.tensor(th),
                                       torch.tensor(lam), torch.tensor(mu), torch.tensor(z),
                                       torch.tensor(1.3), do_sample=do_sample, bound=1e6)
        bound = float(np.quantile(free.abs().amax(1).numpy(), 1.0 - bound_frac))
    return dict(full=full, packed=packed, th=th, lam=lam, mu=mu, z=z, SD=SD,
                feat_off=feat_off, entry_b=entry_b, entry_x=entry_x, bound=bound)


def _args(b, do_sample):
    t = {key: torch.tensor(b[key]) for key in ("packed", "th", "lam", "mu", "z", "SD",
                                               "feat_off", "entry_b", "entry_x")}
    return ((t["packed"], t["th"], t["lam"], t["mu"], t["z"] if do_sample else None,
             torch.tensor(1.3), t["SD"], t["feat_off"], t["entry_b"], t["entry_x"]),
            dict(do_sample=do_sample, bound=b["bound"]))


@pytest.mark.parametrize("rejected", [False, True])
@pytest.mark.parametrize("do_sample", [True, False])
@pytest.mark.parametrize("k", [1, 3, 8, 32])
def test_schur_draw_rel_on_cpu_is_the_draw_then_the_update(k, do_sample, rejected):
    b = _block(k, seed=k + 10 * do_sample, bound_frac=0.3 if rejected else 0.0,
               do_sample=do_sample)
    args, kw = _args(b, do_sample)
    before = kernels.launch_counts()
    theta, rej = ksd.schur_draw_rel(*args, **kw)
    assert kernels.launch_counts() == before
    GG, th, lam, mu, z, alpha, SD0, feat_off, entry_b, entry_x = _args(b, do_sample)[0]
    theta_p, rej_p = ksd.schur_draw_plain(GG, th, lam, mu, z, alpha, **kw)
    entry_f = np.repeat(np.arange(len(b["feat_off"]) - 1, dtype=np.int32),
                        np.diff(b["feat_off"]))
    rs.rel_update_plain(SD0, entry_b, entry_x, torch.tensor(entry_f), th, theta_p)
    assert torch.equal(theta, theta_p) and torch.equal(rej, rej_p)
    assert torch.equal(args[6], SD0)
    assert (int(rej.sum()) > 0) == rejected
    # a rejected feature keeps its theta and leaves its entries' rows alone
    for f in np.nonzero(rej.numpy())[0]:
        rows = b["entry_b"][b["feat_off"][f]:b["feat_off"][f + 1]]
        assert torch.equal(theta[f], th[f])
        assert np.array_equal(args[6].numpy()[rows], b["SD"][rows])


@pytest.mark.parametrize("k", [3, 32])
def test_schur_draw_rel_on_cpu_matches_jax_draw_and_float64_update(k):
    b = _block(k, seed=40 + k)
    args, kw = _args(b, True)
    theta, rej = ksd.schur_draw_rel(*args, **kw)
    jt, jr = blocked_theta_draw(
        jnp.asarray(b["full"]), jnp.asarray(b["th"]), jnp.asarray(b["lam"]),
        jnp.asarray(b["mu"]), jnp.asarray(b["z"]), jnp.float32(1.3), k, True, bound=1e6)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jt), atol=1e-4)
    assert int(rej.sum()) == int(jr) == 0
    # the update in float64 from the port's draw
    SD = b["SD"].astype(np.float64)
    new, old = theta.numpy().astype(np.float64), b["th"].astype(np.float64)
    for f in range(len(b["feat_off"]) - 1):
        dw, dv = new[f, 0] - old[f, 0], new[f, 1:] - old[f, 1:]
        for e in range(b["feat_off"][f], b["feat_off"][f + 1]):
            row, x = b["entry_b"][e], float(b["entry_x"][e])
            SD[row, 0] += x * (dw + dv @ (SD[row, 1:] - x * old[f, 1:]))
            SD[row, 1:] += x * dv
    np.testing.assert_allclose(args[6].numpy(), SD, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fault", ["feat_off_length", "entry_x_length", "entries_2d",
                                   "feat_off_short_of_entries"])
def test_schur_draw_rel_refuses_mismatched_entry_lists(fault):
    b = _block(3, seed=5)
    args, kw = _args(b, True)
    args = list(args)
    if fault == "feat_off_length":
        args[7] = args[7][:-1]
    elif fault == "entry_x_length":
        args[9] = args[9][:-1]
    elif fault == "entries_2d":
        args[8], args[9] = args[8][None], args[9][None]
    else:
        args[7] = args[7].clone()
        args[7][-1] -= 1
    SD = args[6].clone()
    with pytest.raises(ValueError, match="feat_off|entry"):
        ksd.schur_draw_rel(*args, **kw)
    assert torch.equal(args[6], SD)

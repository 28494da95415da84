"""MCMC bands of the flat engine's K4b options against the JAX engine, on
the CPU, at the ml_small size (movielens_like(120, 90, 8000, seed=3),
k=8, 12 iterations, both packages at their default flags otherwise):

- `dense_update=False` (the slot scatter for every block);
- `flat_incr_test` (the incremental test tail).

Each port run's test_all lies within 0.03 of the JAX run's after 12
iterations, with no rejected draw. Draws cannot match one for one:
torch's generators are not JAX's threefry.
"""

import pytest

from libfm_tpu.data.synth import movielens_like as jax_movielens_like
from libfm_tpu.learners.mcmc_vector import MCMCVectorLearner as JaxMCMC
from libfm_tpu.models.fm import FMConfig as JaxFMConfig
from libfm_tpu_torch.data.synth import movielens_like
from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner
from libfm_tpu_torch.models.fm import FMConfig

K = 8
ITERS = 12


@pytest.mark.parametrize("kwargs,flags", [
    (dict(dense_update=False), {}),
    ({}, dict(flat_incr_test=True)),
], ids=["dense_update_off", "flat_incr_test"])
def test_mcmc_band_against_jax(kwargs, flags):
    jtr, jte = jax_movielens_like(num_users=120, num_items=90, num_ratings=8000, seed=3)
    n = jtr.num_features
    jm = JaxMCMC(JaxFMConfig(num_features=n, num_factors=K), num_iter=ITERS, seed=1,
                 verbose=False, **kwargs)
    tr, te = movielens_like(num_users=120, num_items=90, num_ratings=8000, seed=3)
    tm = MCMCVectorLearner(FMConfig(num_features=n, num_factors=K), num_iter=ITERS, seed=1,
                           verbose=False, device="cpu", **kwargs)
    for key, v in flags.items():
        setattr(jm, key, v)
        setattr(tm, key, v)
    jm.learn(jtr, jte)
    tm.learn(tr, te)
    assert tm.incr_test is bool(flags)
    assert abs(jm.history[-1]["test_all"] - tm.history[-1]["test_all"]) < 0.03, (
        jm.history[-1]["test_all"], tm.history[-1]["test_all"])
    assert all(h["rejected"] == 0 for h in tm.history)

"""Probit MCMC of the port against the JAX package, on the CPU.

Sampled chains cannot match draw for draw (torch's generators are not
JAX's threefry), so they are held to bands:

- on ctr_like(5, 200, 15000, seed=4), k=8, 15 iterations, with the field
  groups: the port's final test_all accuracy within 0.02 of the JAX
  engine's, no rejected draw, predict() in [0, 1]. (The JAX engine runs
  with refresh_every=1: one compiled step instead of two; its chain is
  the same up to f32 drift, as the cadence test below shows for the
  port.) Neither engine reaches 0.62 there at 15 iterations (JAX
  0.5673, the port 0.5833);
- the quality floor of tests/test_mcmc_vector.py:95-108 (accuracy above
  0.62 on ctr_like(5, 50, 6000, seed=4), k=4, 15 iterations), held on
  the mean of three chains (seeds 1-3): one chain's accuracy is a count
  of 600 test cases and moves by 0.03 from seed to seed;
- the refresh cadence (tests/test_mcmc_vector.py:317-343): R=1 and R=4
  land within 1e-2 in test and train accuracy.
"""

import numpy as np
import pytest

from libfm_tpu.data.dataset import Dataset as JaxDataset
from libfm_tpu.learners.mcmc_vector import MCMCVectorLearner as JaxMCMC
from libfm_tpu.models.fm import FMConfig as JaxFMConfig
from libfm_tpu.tasks import TASK_CLASSIFICATION as JAX_TASK_CLASSIFICATION
from libfm_tpu_torch.data.synth import ctr_like
from libfm_tpu_torch.learners.mcmc_vector import MCMCVectorLearner
from libfm_tpu_torch.models.fm import FMConfig
from libfm_tpu_torch.tasks import TASK_CLASSIFICATION

ITERS = 15


@pytest.fixture(scope="module")
def ctr():
    return ctr_like(5, 200, 15000, seed=4)


def _port(ctr, k=8, seed=1, **kw):
    tr, te, groups = ctr
    m = MCMCVectorLearner(FMConfig(num_features=tr.num_features, num_factors=k),
                          task=TASK_CLASSIFICATION, num_iter=ITERS, seed=seed,
                          verbose=False, device="cpu", attr_group=groups, **kw)
    m.learn(tr, te)
    return m


def test_mcmc_classification_band_against_jax(ctr):
    tr, te, groups = ctr
    jtr, jte = (JaxDataset(d.indptr, d.cols, d.vals, d.target, d.num_features)
                for d in (tr, te))
    jm = JaxMCMC(JaxFMConfig(num_features=tr.num_features, num_factors=8),
                 task=JAX_TASK_CLASSIFICATION, num_iter=ITERS, seed=1, verbose=False,
                 dual_draws=False, attr_group=groups, refresh_every=1)
    assert jm.case_major_stats
    jm.learn(jtr, jte)
    tm = _port(ctr)
    assert abs(jm.history[-1]["test_all"] - tm.history[-1]["test_all"]) < 0.02
    assert all(h["rejected"] == 0 for h in tm.history)
    assert all(np.isfinite(h[key]) for h in tm.history
               for key in ("train", "test_all", "test_all_m2", "auc_all"))
    preds = tm.predict()
    assert preds.shape == (te.num_rows,)
    assert ((preds >= 0) & (preds <= 1)).all()


def test_mcmc_classification_quality_floor():
    data = ctr_like(5, 50, 6000, seed=4)
    acc = [_port(data, k=4, seed=s).history[-1]["test_all"] for s in (1, 2, 3)]
    assert np.mean(acc) > 0.62, acc


def test_classification_refresh_cadence_quality(ctr):
    res = {r: _port(ctr, seed=3, refresh_every=r).history[-1] for r in (1, 4)}
    assert abs(res[1]["test_all"] - res[4]["test_all"]) < 1e-2, res
    assert abs(res[1]["train"] - res[4]["train"]) < 1e-2, res
    assert res[4]["rejected"] == 0

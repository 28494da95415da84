"""Synthetic dataset generators (numpy).

The port's copies of `libfm_tpu.data.synth.movielens_like` and
`ctr_like`: the same numpy calls in the same order, so the same seed
gives bit-identical data in both packages. Ground truth comes from a
planted MF / FM model.
"""

from __future__ import annotations

import numpy as np

from libfm_tpu_torch.data.dataset import Dataset


def movielens_like(
    num_users: int = 943,
    num_items: int = 1682,
    num_ratings: int = 100_000,
    rank: int = 4,
    noise: float = 0.3,
    seed: int = 0,
):
    """One-hot user x item regression data from a planted MF model with
    ratings clipped to [1, 5] (the ML-100K shape by default). Returns
    (train Dataset, test Dataset) with a 90/10 split; the first tenth of
    the ratings is the test set."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, num_users, num_ratings).astype(np.int32)
    items = rng.integers(0, num_items, num_ratings).astype(np.int32)

    pu = rng.normal(0, 0.5, (num_users, rank))
    qi = rng.normal(0, 0.5, (num_items, rank))
    bu = rng.normal(0, 0.3, num_users)
    bi = rng.normal(0, 0.3, num_items)
    mu = 3.5
    y = (
        mu
        + bu[users]
        + bi[items]
        + np.einsum("nf,nf->n", pu[users], qi[items])
        + rng.normal(0, noise, num_ratings)
    )
    y = np.clip(np.round(y * 2) / 2, 1.0, 5.0).astype(np.float32)

    n = num_ratings
    indptr = np.arange(0, 2 * n + 1, 2, dtype=np.int64)
    cols = np.empty(2 * n, dtype=np.int32)
    cols[0::2] = users
    cols[1::2] = num_users + items
    vals = np.ones(2 * n, dtype=np.float32)

    n_test = n // 10
    test = Dataset(
        indptr[: n_test + 1],
        cols[: 2 * n_test],
        vals[: 2 * n_test],
        y[:n_test],
        num_users + num_items,
    )
    # the clamp range comes from train (libFM src/libfm/libfm.cpp:295-296)
    train = Dataset(
        indptr[: n - n_test + 1],
        cols[2 * n_test :],
        vals[2 * n_test :],
        y[n_test:],
        num_users + num_items,
    )
    return train, test


def ctr_like(
    num_fields: int = 13,
    field_cardinality: int = 1000,
    num_examples: int = 100_000,
    rank: int = 4,
    seed: int = 0,
    power: float = 1.2,
):
    """Criteo-style multi-field one-hot binary-classification data with a
    Zipf-ish feature popularity and a planted FM scorer. Returns (train,
    test, attr_group) with +-1 targets; the first tenth of the examples is
    the test set."""
    rng = np.random.default_rng(seed)
    n = num_examples
    raw = rng.zipf(power, size=(n, num_fields))
    ids_in_field = np.minimum(raw - 1, field_cardinality - 1).astype(np.int32)
    offsets = np.arange(num_fields, dtype=np.int32) * field_cardinality
    cols = (ids_in_field + offsets[None, :]).reshape(-1).astype(np.int32)
    num_features = num_fields * field_cardinality

    v = rng.normal(0, 0.3, (num_features, rank))
    w = rng.normal(0, 0.2, num_features)
    rows_v = v[cols].reshape(n, num_fields, rank)
    s = rows_v.sum(axis=1)
    s2 = (rows_v**2).sum(axis=1)
    score = (
        w[cols].reshape(n, num_fields).sum(axis=1)
        + 0.5 * (s**2 - s2).sum(axis=1)
        - 0.1
    )
    p = 1.0 / (1.0 + np.exp(-score))
    y = np.where(rng.uniform(size=n) < p, 1.0, -1.0).astype(np.float32)

    indptr = np.arange(0, num_fields * n + 1, num_fields, dtype=np.int64)
    vals = np.ones(num_fields * n, dtype=np.float32)

    n_test = n // 10
    test = Dataset(
        indptr[: n_test + 1],
        cols[: num_fields * n_test],
        vals[: num_fields * n_test],
        y[:n_test],
        num_features,
    )
    train = Dataset(
        indptr[: n - n_test + 1],
        cols[num_fields * n_test :],
        vals[num_fields * n_test :],
        y[n_test:],
        num_features,
    )
    attr_group = np.repeat(np.arange(num_fields, dtype=np.int32), field_cardinality)
    return train, test, attr_group

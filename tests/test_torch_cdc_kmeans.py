"""The port's k-means (tpurec_torch.cdc.algorithm.kmeans_group, numpy)
against scikit-learn's ``KMeans(n_clusters, random_state=seed,
n_init=10).fit(X).labels_``, which the JAX package clusters with.

The labels choose which tower serves each domain, so they must be
sklearn's labels, not merely the same partition under other names.  The
inputs are what CDC clusters: arccos of the causal kernel of seeded mask
matrices (``calc_causal_matrix``), block-structured (domains drawn from
k latent groups) and unstructured, at D = 6, 25 and 50 domains and k = 2
and 4, ten seeds each; and degenerate ones (duplicate rows, which empty
clusters and relocate them; a constant matrix).  No seeded case is known
where the labels differ."""

import warnings

import numpy as np
import pytest
from sklearn.cluster import KMeans

from tpurec_torch.cdc.algorithm import calc_causal_matrix, kmeans_group

SEEDS = range(10)


def _causal_distances(rng, D, k, kind):
    n_mask = 12
    if kind == "blocks":
        groups = rng.integers(0, k, D)
        M = rng.normal(size=(n_mask, k))[:, groups] \
            + 0.3 * rng.normal(size=(n_mask, D))
    else:
        M = rng.normal(size=(n_mask, D))
    return np.arccos(np.clip(calc_causal_matrix(M.T), -1.0, 1.0))


def _sklearn_labels(X, k, seed):
    with warnings.catch_warnings():
        # duplicate rows: sklearn warns that it found fewer clusters
        warnings.simplefilter("ignore")
        km = KMeans(n_clusters=k, random_state=seed, n_init=10).fit(X)
    return km.labels_


@pytest.mark.parametrize("kind", ["blocks", "unstructured"])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("D", [6, 25, 50])
def test_kmeans_gives_sklearns_labels(D, k, kind):
    for seed in SEEDS:
        rng = np.random.default_rng(1000 * D + 10 * k + seed)
        X = _causal_distances(rng, D, k, kind)
        got = kmeans_group(X, k, seed=seed)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, _sklearn_labels(X, k, seed),
                                      err_msg=f"seed {seed}")


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("D", [6, 25])
def test_kmeans_degenerate_inputs(D, k):
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        cases = {
            "duplicates": np.repeat(rng.normal(size=(3, D)),
                                    [D - 2, 1, 1], axis=0),
            "two points": np.repeat(rng.normal(size=(2, D)),
                                    [D // 2, D - D // 2], axis=0),
            "ties": rng.integers(0, 3, (D, D)).astype(np.float64),
            "constant": np.zeros((D, D)),
        }
        for name, X in cases.items():
            np.testing.assert_array_equal(
                kmeans_group(X, k, seed=seed), _sklearn_labels(X, k, seed),
                err_msg=f"{name}, seed {seed}")


def test_kmeans_draws_like_sklearn():
    """The same seed gives the same labels on repeat, and the input is not
    modified (sklearn centres a copy)."""
    X = _causal_distances(np.random.default_rng(0), 25, 4, "blocks")
    X0 = X.copy()
    a, b = kmeans_group(X, 4, seed=7), kmeans_group(X, 4, seed=7)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(X, X0)
    with pytest.raises(ValueError, match="n_samples"):
        kmeans_group(X[:3], 4, seed=0)

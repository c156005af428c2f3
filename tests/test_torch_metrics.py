"""The port's metrics (tpurec_torch.metrics) against the JAX package's
(tpurec.metrics) on the same arrays, made with numpy from a seed.

Tolerance: none.  The numpy functions are copies and must give tpurec's
floats exactly; streaming_auc_bins adds 0/1 weights, whose float32 sums
are exact below 2**24 in any order, so its counts must be equal too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurec.metrics as jm
import tpurec_torch.metrics as pm


def _preds(seed, n=3000, n_domain=5, single_class_domain=None):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.35).astype(np.float32)
    p = rng.random(n) * 0.5 + y * 0.25
    p[::7] = np.round(p[::7], 2)                 # ties
    p = np.clip(p, 1e-6, 1 - 1e-6)
    d = rng.integers(0, n_domain, n)
    if single_class_domain is not None:
        y[d == single_class_domain] = 1.0
    w = np.bincount(d, minlength=n_domain) / n
    return y, p.astype(np.float32), d, w


def _same(a, b):
    """Equal floats, NaN equal to NaN, through nested dicts."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True), \
            (a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auc_and_log_loss_equal_tpurec(seed):
    y, p, _, _ = _preds(seed)
    assert pm.auc_score(y, p) == jm.auc_score(y, p)
    assert pm.log_loss_score(y, p) == jm.log_loss_score(y, p)
    with pytest.raises(ValueError):
        pm.auc_score(np.ones(4), np.arange(4.0))


@pytest.mark.parametrize("single", [None, 2])
def test_evaluate_multi_domain_equals_tpurec(single):
    y, p, d, w = _preds(3, single_class_domain=single)
    got = pm.evaluate_multi_domain(y, p, d, w)
    want = jm.evaluate_multi_domain(y, p, d, w)
    _same(got, want)
    if single is not None:
        assert np.isnan(got["domain_auc"][single])
        assert np.isnan(got["mean_auc"])


def test_gauc_equals_tpurec():
    rng = np.random.default_rng(4)
    y, p, _, _ = _preds(4, n=2000)
    users = rng.integers(0, 60, 2000)
    assert pm.gauc_score(y, p, users) == jm.gauc_score(y, p, users)
    weights = {u: float(u % 5 + 1) for u in range(60)}
    assert pm.gauc_score(y, p, users, weights) == \
        jm.gauc_score(y, p, users, weights)


@pytest.mark.parametrize("per_domain", [False, True])
def test_streaming_bins_equal_tpurec(per_domain):
    y, p, d, _ = _preds(5, n=20000)
    p[:5] = [0.0, 1.0, 1.0 - 1e-7, 0.99999994, 0.5]   # the clip's edges
    n_bins = 1024
    kw = dict(domains=d, n_domain=5) if per_domain else {}
    jkw = dict(domains=jnp.asarray(d), n_domain=5) if per_domain else {}
    tkw = dict(domains=torch.from_numpy(d), n_domain=5) if per_domain else {}
    want = jm.streaming_auc_bins(jnp.asarray(y), jnp.asarray(p), n_bins,
                                 **jkw)
    got = pm.streaming_auc_bins(torch.from_numpy(y), torch.from_numpy(p),
                                n_bins, **tkw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _same(pm.streaming_auc_from_bins(*[g.numpy() for g in got]),
          jm.streaming_auc_from_bins(*[np.asarray(w) for w in want]))
    assert kw or got[0].shape == (1, n_bins)


@pytest.mark.parametrize("single", [None, 1])
def test_streaming_eval_result_equals_tpurec(single):
    y, p, d, w = _preds(6, n=8000, single_class_domain=single)
    y_t, p_t, d_t = (torch.from_numpy(a) for a in (y, p, d))
    pos, neg = pm.streaming_auc_bins(y_t, p_t, 512, domains=d_t, n_domain=5)
    lsum = np.bincount(d, weights=-np.log(np.where(y > 0, p, 1 - p)),
                       minlength=5)
    lcnt = np.bincount(d, minlength=5).astype(np.float64)
    lcnt[4] = lsum[4] = 0.0                       # a domain with no rows
    args = (pos.numpy(), neg.numpy(), lsum, lcnt)
    for weights in (None, w):
        _same(pm.streaming_eval_result(*args, weights),
              jm.streaming_eval_result(*args, weights))

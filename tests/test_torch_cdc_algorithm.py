"""The port's CDC clustering algorithm (tpurec_torch.cdc.algorithm, numpy)
against the JAX package's (tpurec.cdc.algorithm).

Everything but ``kmeans_group`` is a copy, so the causal kernel is held
within 1e-12 and the clustering passes (source-group growth, in-group
metric, two successive ``update_group`` calls with their affinity
transforms, EMA blends and re-assignment) must agree exactly: the same
lists, the same ``domain2group`` and the same matrices.  tpurec's
``kmeans_group`` is patched to the port's inside these tests, so that
they isolate the rest; ``tests/test_torch_cdc_kmeans.py`` holds the
port's k-means against scikit-learn's."""

import dataclasses
import itertools

import numpy as np
import pytest

import tpurec.cdc.algorithm as ja
from tpurec.config import CDCConfig as JaxCDCConfig
from tpurec_torch.cdc import algorithm as pa
from tpurec_torch.config import CDCConfig

METRICS = ("loss", "auc")
AFFINITIES = ("minus", "divide")
MODES = ("iterative", "greedy")
P_METHODS = ("exponential_decay", "linear_decay", "quadratic_decay")


@pytest.fixture(autouse=True)
def _port_kmeans_in_tpurec(monkeypatch):
    monkeypatch.setattr(ja, "kmeans_group", pa.kmeans_group)


def _matrices(rng, D, n_cluster, n_mask, metric):
    """Seeded float64 matrices in the metric's range: probe losses about
    0.5-1.5, probe AUCs in (0.3, 0.9)."""
    def draw(shape):
        if metric == "auc":
            return 0.3 + 0.6 * rng.random(shape)
        return 0.5 + rng.random(shape)

    return (draw((D + 1, D)), draw((D + n_cluster, D)), draw((n_mask, D)))


def _states(D, cfg_kw):
    ccfg = CDCConfig(base_model="mmoe", **cfg_kw)
    jcfg = JaxCDCConfig(base_model="mmoe", **cfg_kw)
    return (pa.CDCClusterState.create(D, ccfg.n_cluster, ccfg), ccfg,
            ja.CDCClusterState.create(D, jcfg.n_cluster, jcfg), jcfg)


def _fill(st, A, B, mask):
    st.matrix_A, st.matrix_B, st.matrix_mask = A.copy(), B.copy(), mask.copy()


def _assert_same_state(p, j):
    for f in dataclasses.fields(j):
        a, b = getattr(p, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("alpha", [None, 0.05])
@pytest.mark.parametrize("D", [6, 25, 50])
def test_causal_matrix_matches_tpurec(D, alpha):
    rng = np.random.default_rng(D)
    for n_mask in (5, 50):
        X = rng.normal(size=(D, n_mask))
        got = pa.calc_causal_matrix(X, alpha=alpha)
        want = ja.calc_causal_matrix(X, alpha=alpha)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert got.max() <= 1.0


def _cases():
    """(D, metric, affinity, mode, p_method, old_w, mask_ema): the full
    grid at D=6, the metric x affinity x mode grid at D=25 with the decay
    method and the EMA knobs cycling, and two greedy cases at D=50
    (tpurec's iterative mode there takes about 8 s a call)."""
    out = []
    for i, (m, a, c, p) in enumerate(itertools.product(
            METRICS, AFFINITIES, MODES, P_METHODS)):
        out.append((6, m, a, c, p, 0.3 * (i % 2), 0.5 * (i // 2 % 2)))
    for i, (m, a, c) in enumerate(itertools.product(METRICS, AFFINITIES,
                                                    MODES)):
        out.append((25, m, a, c, P_METHODS[i % 3], 0.3 * (i % 2),
                    0.5 * (i // 2 % 2)))
    out.append((50, "loss", "minus", "greedy", "exponential_decay", 0.0,
                0.0))
    out.append((50, "auc", "divide", "greedy", "linear_decay", 0.3, 0.5))
    return out


@pytest.mark.parametrize("D,metric,affinity,mode,p_method,old_w,mask_ema",
                         _cases())
def test_update_group_matches_tpurec(D, metric, affinity, mode, p_method,
                                     old_w, mask_ema):
    n_cluster = 2 if D == 6 else 4
    kw = dict(n_cluster=n_cluster, n_causal_mask=8 if D == 6 else 20,
              use_metric=metric, affinity_func=affinity, cluster_mode=mode,
              p_weight_method=p_method, old_matrix_weight=old_w,
              mask_ema=mask_ema)
    p, pcfg, j, jcfg = _states(D, kw)
    rng = np.random.default_rng(D * 1000 + len(metric) + len(affinity))
    w = rng.random(D) + 0.1
    w /= w.sum()
    for call in range(2):
        mats = _matrices(rng, D, n_cluster, kw["n_causal_mask"], metric)
        _fill(p, *mats)
        _fill(j, *mats)
        seed = int(rng.integers(2**31))
        got = pa.update_group(p, pcfg, w, kmeans_seed=seed)
        want = ja.update_group(j, jcfg, w, kmeans_seed=seed)
        assert got == want, call
        _assert_same_state(p, j)
        assert p.call_update_group == call + 1
    # the helpers the passes are built of, on the updated state
    for c, t_group in enumerate(j.t_group2domain_list):
        if not t_group:
            continue
        assert pa.get_source_domain(p, t_group, c, w) == \
            ja.get_source_domain(j, t_group, c, w)
        s_group = j.s_group2domain_list[c]
        for d in range(D):
            assert pa.calc_metric_in_source_group(p, d, s_group) == \
                ja.calc_metric_in_source_group(j, d, s_group)
        assert pa.get_center_domain_in_group(p, t_group, 2) == \
            ja.get_center_domain_in_group(j, t_group, 2)
        np.testing.assert_array_equal(
            pa.calc_domain_lambda_in_group(p, t_group),
            ja.calc_domain_lambda_in_group(j, t_group))


def test_update_group_copies_and_aliases_as_tpurec():
    """update_group transforms st.matrix_* in place where tpurec does and
    keeps raw copies in st.old_matrix_*: the second call reads the same
    matrices in both packages, and a caller's arrays are the state's."""
    kw = dict(n_cluster=2, n_causal_mask=6, old_matrix_weight=0.4,
              mask_ema=0.5)
    p, pcfg, j, jcfg = _states(5, kw)
    rng = np.random.default_rng(3)
    w = np.full(5, 0.2)
    A, B, mask = _matrices(rng, 5, 2, 6, "loss")
    for st, cfg in ((p, pcfg), (j, jcfg)):
        st.matrix_A, st.matrix_B, st.matrix_mask = A.copy(), B.copy(), \
            mask.copy()
        a_in = st.matrix_A
        (pa if st is p else ja).update_group(st, cfg, w, kmeans_seed=1)
        # the first call transforms A in place; mask is a new array
        assert st.matrix_A is a_in
        np.testing.assert_array_equal(st.old_matrix_A, A)
        np.testing.assert_array_equal(st.old_matrix_mask, mask)
    _assert_same_state(p, j)


def test_cluster_state_defaults_match_tpurec():
    for metric, affinity in itertools.product(METRICS, AFFINITIES):
        kw = dict(n_cluster=3, n_causal_mask=7, use_metric=metric,
                  affinity_func=affinity)
        p, _, j, _ = _states(9, kw)
        _assert_same_state(p, j)
        assert p.domain2group_list == j.domain2group_list == [0] * 9

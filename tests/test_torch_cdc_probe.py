"""The port's CDC engine against the JAX package's where the probes see
more than rounding: the default weight decay, and the AUC probe metric
(helpers and data of ``tests/test_torch_cdc_engine.py``).

- Default wd = 1e-8.  A bias feeding a training BatchNorm has a gradient
  that is zero but for rounding, which Adam turns into a step of up to lr
  either way, differently in the two packages (ROADMAP.md queue 3).
  Training losses do not see it; the probe evals do, through the
  BatchNorm's running mean: the rows after a treatment burst differ by
  up to 1.7e-4 of max(1, |x|), the baseline row (after the warmup's 5
  steps) by 7.0e-5 (``pytest -s`` prints them; 2.4e-7 at wd = 1e-3).
  They are held within 1e-3, the baseline row within 1e-4, the losses
  within 1e-4 relative, and the clustering must be the same.
- use_metric="auc" at wd = 1e-3: one update's raw matrices within 1e-4.
  A pair of rows whose logits swap order between the packages moves a
  domain's AUC by 1/(pos * neg), 6.4e-5 or more at these batch sizes,
  so the tolerance allows at most one such pair a domain (measured:
  none, the rows are equal)."""

import numpy as np
import pytest
import torch

import tpurec.cdc.engine as jax_engine
import tpurec_torch.cdc.engine as port_engine
from test_torch_cdc_engine import (ROW_TOL, _pair, _record_groups, _row_err,
                                   check_epoch_pair, run_epoch_pair)
from tpurec_torch.config import TrainConfig
from tpurec_torch.data import make_synthetic

QUIRK_ROW_TOL = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return make_synthetic(n_rows=3500, n_fields=6, n_domain=4, domain_idx=3,
                          seed=1, domain_cluster_k=2)


def test_cdc_epoch_at_default_wd_matches_tpurec(data, monkeypatch):
    check_epoch_pair(data, *run_epoch_pair(data, monkeypatch, TrainConfig.wd),
                     tol=QUIRK_ROW_TOL)


def test_auc_probe_update_matches_tpurec(data, monkeypatch):
    jtr, tr = _pair(data, wd=1e-3, use_metric="auc")
    groups = {"jax": [], "port": []}
    _record_groups(monkeypatch, jax_engine, groups["jax"])
    _record_groups(monkeypatch, port_engine, groups["port"])
    for t in (jtr, tr):
        t.setup_data(data.train, data.valid)
    k = tr._scaled_update_matrix_step()
    jtr.update_matrix_cdc(k)
    tr.update_matrix_cdc(k)
    (gj,), (gp,) = groups["jax"], groups["port"]
    errs = {name: _row_err(gp[name], gj[name]).max()
            for name in ("mask", "A", "B")}
    print(f"AUC probe rows vs tpurec, max err: {errs}")   # pytest -s
    for name in ("mask", "A", "B"):
        assert gp[name].shape == gj[name].shape
        assert errs[name] <= ROW_TOL, name
        assert ((gp[name] >= 0) & (gp[name] <= 1)).all()
    assert gp["d2g"] == gj["d2g"]
    assert tr.cluster.s_group2domain_list == jtr.cluster.s_group2domain_list
    assert tr.state.step == int(jtr.state.step)
    # an AUC's best direction is up: the state's orientation
    assert tr.cluster.is_max_metric_value_better
    assert np.isfinite(tr.cluster.matrix_causal).all()

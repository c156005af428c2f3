"""CDC on its default base (PLE) across more than one matrix update, in
the port (plain versions on the CPU) against the JAX package's
CDCTrainer, and the port's two data placements against each other.

The shape of tests/test_torch_cdc_engine.py (its data, helpers and
limits) with PLE narrowed as in tests/test_torch_cdc_bases.py, row lanes
(``parallel_rows=4``) and ``update_interval=2``: the epoch's 14 steps of
256 rows cross two boundaries (before steps 0 and 7), so one epoch runs
two matrix updates, and the second one's B rows train on the first
clustering's groups.

- Against tpurec (wd = 1e-3): each update's raw matrices within ROW_TOL
  of max(1, |x|), the same k-means seed and clustering after each, every
  step's loss within 1e-4 relative.
- ``"stream"`` (the split in host memory, a window of the scheduled
  rows a block or span) against ``"resident"`` (the split on the
  device), serially and in lanes: the same rows in the same order, so
  every loss, every update's matrices and clustering and the final state
  bitwise equal.
- A trainer dropped after a lane update frees its state at once (the row
  lanes hold it weakly)."""

import gc
import weakref

import numpy as np
import pytest
import torch

import tpurec.cdc.engine as jax_engine
import tpurec_torch.cdc.engine as port_engine
from test_torch_cdc_engine import (CDC, MODEL, ROW_TOL, TRAIN, _pair,
                                   _record_groups, _record_jax_steps,
                                   _record_port_steps, _row_err)
from tpurec_torch.cdc import CDCTrainer
from tpurec_torch.config import CDCConfig, Config, ModelConfig, TrainConfig
from tpurec_torch.data import make_synthetic

PLE = dict(ple_expert_dims=((16, 8), (8,)))
CADENCE = dict(base_model="ple", update_interval=2)


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


def test_two_lane_updates_on_ple_match_tpurec(data, monkeypatch):
    jtr, tr = _pair(data, wd=1e-3, model=PLE, parallel_rows=4, **CADENCE)
    groups = {"jax": [], "port": []}
    _record_groups(monkeypatch, jax_engine, groups["jax"])
    _record_groups(monkeypatch, port_engine, groups["port"])
    steps = {"jax": {"warmup": [], "split": []},
             "port": {"warmup": [], "split": []}}
    _record_jax_steps(jtr, steps["jax"])
    _record_port_steps(tr, steps["port"])
    for t in (jtr, tr):
        t.setup_data(data.train, data.valid)
    mean_j, mean_p = jtr.train_cdc_epoch(0), tr.train_cdc_epoch(0)

    j, p = steps["jax"], steps["port"]
    assert len(p["warmup"]) == len(j["warmup"]) == 5
    assert len(p["split"]) == len(j["split"]) == 14
    for mode in ("warmup", "split"):
        np.testing.assert_allclose(p[mode], j[mode], rtol=1e-4, atol=0)
    assert mean_p == pytest.approx(mean_j, rel=1e-4)
    assert tr.state.step == int(jtr.state.step)

    assert len(groups["port"]) == len(groups["jax"]) == 2
    for u, (gj, gp) in enumerate(zip(groups["jax"], groups["port"])):
        assert gp["seed"] == gj["seed"], u
        errs = {name: _row_err(gp[name], gj[name]).max()
                for name in ("mask", "A", "B")}
        print(f"update {u + 1}: raw matrix rows vs tpurec, max err of "
              f"max(1, |x|): {errs}")          # shown by pytest -s
        for name, err in errs.items():
            assert err <= ROW_TOL, (u, name, err)
        assert gp["d2g"] == gj["d2g"], u
    assert tr.cluster.call_update_group == jtr.cluster.call_update_group == 2
    assert tr.cluster.s_group2domain_list == jtr.cluster.s_group2domain_list
    assert tr.cluster.t_group2domain_list == jtr.cluster.t_group2domain_list
    assert tr.np_rng.integers(2**31) == jtr.np_rng.integers(2**31)
    assert tr.train_batcher.rng.integers(2**31) == \
        jtr.train_batcher.rng.integers(2**31)


def _placement_epoch(data, monkeypatch, placement, lanes):
    """One epoch of the port at ``placement`` -> (its losses, each
    update's matrices and clustering, its final state)."""
    cfg = Config(model=ModelConfig(**{**MODEL, **PLE, "dropout": 0.2}),
                 cdc=CDCConfig(**{**CDC, **CADENCE, "parallel_rows": lanes,
                                  "data_placement": placement,
                                  "n_causal_mask": 2}),
                 train=TrainConfig(**TRAIN))
    tr = CDCTrainer(cfg, data.field_dims, data.n_domain, data.domain_idx,
                    device="cpu")
    groups, steps = [], {"warmup": [], "split": []}
    with monkeypatch.context() as m:
        _record_groups(m, port_engine, groups)
        _record_port_steps(tr, steps)
        tr.setup_data(data.train, data.valid)
        assert tr._resident == (placement == "resident")
        tr.train_cdc_epoch(0)
    return steps, groups, tr.snapshot_bytes()


@pytest.mark.parametrize("lanes", [0, 4], ids=["serial", "lanes"])
def test_stream_is_resident_bitwise_over_two_updates(data, monkeypatch,
                                                     lanes):
    """Dropout 0.2 at the default wd, 2 mask rows: the two placements
    draw the same dropout bits and gather the same rows, so nothing may
    part them."""
    res = _placement_epoch(data, monkeypatch, "resident", lanes)
    stream = _placement_epoch(data, monkeypatch, "stream", lanes)
    (s_r, g_r, b_r), (s_s, g_s, b_s) = res, stream
    assert s_r == s_s and len(s_r["split"]) == 14
    assert len(g_r) == len(g_s) == 2
    for u, (a, b) in enumerate(zip(g_r, g_s)):
        for name in ("mask", "A", "B"):
            np.testing.assert_array_equal(a[name], b[name], err_msg=f"{u}")
        assert a["d2g"] == b["d2g"] and a["seed"] == b["seed"], u
    assert b_r == b_s


@pytest.mark.parametrize("lanes", [0, 4], ids=["serial", "lanes"])
def test_a_dropped_trainer_frees_its_state(data, lanes):
    """After an update, the last reference to a trainer frees it and its
    tensors at once, without the garbage collector: the row lanes, built
    by the first lane update, hold no strong reference back to it."""
    cfg = Config(model=ModelConfig(**{**MODEL, **PLE}),
                 cdc=CDCConfig(**{**CDC, **CADENCE, "parallel_rows": lanes,
                                  "n_causal_mask": 2}),
                 train=TrainConfig(**TRAIN))
    tr = CDCTrainer(cfg, data.field_dims, data.n_domain, data.domain_idx,
                    device="cpu")
    tr.setup_data(data.train, data.valid)
    tr.update_matrix_cdc(1)
    assert (tr._lanes is not None) == (lanes > 0)
    refs = [weakref.ref(tr), weakref.ref(tr.model.embedding.table)]
    if lanes:
        refs.append(weakref.ref(tr._lanes.table))
    gc.disable()
    try:
        del tr
        assert [r() is None for r in refs] == [True] * len(refs)
    finally:
        gc.enable()

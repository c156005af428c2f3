"""``CDCTrainer.fit`` of the port against the JAX package's, end to end,
and CDC checkpoints across the two packages.

Data: make_synthetic(3500 rows, 6 fields, 4 domains, domain_idx 3, 2
domain clusters) at bs=256, the widths of tests/test_torch_cdc_engine.py
and update_interval 2 (a boundary every 8 steps): the warmup, the update
before step 0, a second update before step 7 of the epoch's 14, and the
split-mode spans between.  The port starts from tpurec's initial state
with dropout 0, at the default weight decay.

Tolerances.  The clusterings must be equal.  Valid and test AUC 1e-3,
LogLoss 1e-4: the room that a bias feeding a training BatchNorm leaves,
whose rounding-only gradient Adam turns into steps of up to lr either
way, differently in each package (tests/test_torch_trainer.py; ``pytest
-s`` prints the differences: 1.2e-4 valid AUC, 8.9e-6 LogLoss).  Eval of one state in both packages:
AUC 1e-4, LogLoss 1e-5.  A checkpoint's state and cluster restore
bitwise into either package; its predictions in the two Predictors
agree within 1e-5."""

import flax.serialization as fser
import numpy as np
import pytest
import torch

from tpurec.cdc import CDCTrainer as JaxCDCTrainer
from tpurec.config import CDCConfig as JaxCDCConfig
from tpurec.config import Config as JaxConfig
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.serve import predictor_from_checkpoint as jax_predictor_from_ckpt
from tpurec_torch.cdc import CDCTrainer
from tpurec_torch.config import CDCConfig, Config, ModelConfig, TrainConfig
from tpurec_torch.convert import train_state_to_flax
from tpurec_torch.data import make_synthetic
from tpurec_torch.serve import predictor_from_checkpoint

MODEL = dict(model="cdc", embed_dim=8, mlp_dims=(32, 16), atten_embed_dim=8,
             att_layer_num=1, dropout=0.0)
CDC = dict(base_model="mmoe", n_cluster=2, n_causal_mask=4, warmup_step=1,
           update_matrix_step=1, update_interval=2, cdc_tower_dims=(16,))
TRAIN = dict(bs=256, epoch=1, seed=0)
P_ATOL = 1e-5


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


def _jax(data):
    return JaxCDCTrainer(
        JaxConfig(model=JaxModelConfig(**MODEL), cdc=JaxCDCConfig(**CDC),
                  train=JaxTrainConfig(**TRAIN)),
        data.field_dims, data.n_domain, data.domain_idx)


def _port(data):
    return CDCTrainer(
        Config(model=ModelConfig(**MODEL), cdc=CDCConfig(**CDC),
               train=TrainConfig(**TRAIN)),
        data.field_dims, data.n_domain, data.domain_idx, device="cpu")


@pytest.fixture(scope="module")
def fitted(data):
    """Both packages fitted from one initial state: (tpurec trainer, its
    fit output and log, port trainer, its fit output and log)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jtr, tr = _jax(data), _port(data)
    tr.restore_bytes(fser.to_bytes(jtr.state))
    lj, lp = [], []
    oj = jtr.fit(data.train, data.valid, test=data.test, log_fn=lj.append)
    op = tr.fit(data.train, data.valid, test=data.test, log_fn=lp.append)
    torch.set_num_threads(n)
    return jtr, oj, lj, tr, op, lp


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_same_state(port_tree, jax_tree):
    got, want = dict(_leaves(port_tree)), dict(_leaves(jax_tree))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        g = g.float().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w).astype(g.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


def _assert_same_cluster(a, b):
    assert a.domain2group_list == b.domain2group_list
    for name in ("s_group2domain_list", "t_group2domain_list",
                 "initial_s_group2domain_list", "call_update_group",
                 "p_weight"):
        assert getattr(a, name) == getattr(b, name), name
    for name in ("matrix_A", "matrix_B", "matrix_mask", "matrix_causal"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_fit_matches_tpurec(fitted):
    jtr, oj, lj, tr, op, lp = fitted
    updates_j = [r["domain2group"] for r in lj if "domain2group" in r]
    updates_p = [r["domain2group"] for r in lp if "domain2group" in r]
    assert len(updates_p) == len(updates_j) == 2     # two updates
    assert updates_p == updates_j
    assert tr.cluster.call_update_group == jtr.cluster.call_update_group == 2
    assert op["domain2group_list"] == oj["domain2group_list"]
    assert op["s_group2domain_list"] == oj["s_group2domain_list"]
    assert tr.state.step == int(jtr.state.step)
    print("fit vs tpurec: " + ", ".join(      # shown by pytest -s
        f"{split} {k} diff {abs(op[split][k] - oj[split][k]):.3g}"
        for split in ("valid", "test") for k in ("total_auc", "total_loss")))
    for split in ("valid", "test"):
        assert abs(op[split]["total_auc"] - oj[split]["total_auc"]) <= 1e-3
        assert abs(op[split]["total_loss"] - oj[split]["total_loss"]) <= 1e-4
        assert abs(op[split]["mean_auc"] - oj[split]["mean_auc"]) <= 1e-3
    assert op["valid"]["train_loss"] == pytest.approx(
        oj["valid"]["train_loss"], rel=1e-4)
    assert op["valid"]["epoch"] == oj["valid"]["epoch"] == 0


def test_eval_of_one_state_matches_tpurec(fitted, data):
    """tpurec's fitted state and clustering in a port trainer: exact and
    streaming eval within 1e-4 AUC, 1e-5 LogLoss of tpurec's."""
    jtr = fitted[0]
    tr = _port(data)
    tr.restore_bytes(fser.to_bytes(jtr.state))
    tr._restore_cluster(jtr._cluster_payload())
    tr.setup_data(data.train, data.valid)
    for fn in ("evaluate", "evaluate_streaming"):
        want = getattr(jtr, fn)(jtr.valid_batcher)
        got = getattr(tr, fn)(tr.valid_batcher)
        for k in ("total_auc", "mean_auc"):
            assert abs(got[k] - want[k]) <= 1e-4, (fn, k)
        for k in ("total_loss", "mean_loss"):
            assert abs(got[k] - want[k]) <= 1e-5, (fn, k)
        assert set(got["domain_auc"]) == set(want["domain_auc"])


def test_port_checkpoint_in_tpurec(fitted, data, tmp_path):
    _, _, _, tr, _, _ = fitted
    path = str(tmp_path / "port_cdc.pkl")
    tr.save_checkpoint(path, extra={"note": "port"})
    jtr = _jax(data)
    payload = jtr.load_checkpoint(path)
    assert payload["extra"] == {"note": "port"}
    _assert_same_state(train_state_to_flax(tr.state),
                       fser.to_state_dict(jtr.state))
    _assert_same_cluster(jtr.cluster, tr.cluster)
    assert payload["domain2group_list"] == tr.cluster.domain2group_list
    Xv = data.valid[0]
    want = predictor_from_checkpoint(path, batch_sizes=(256,),
                                     device="cpu")(Xv)
    np.testing.assert_allclose(
        jax_predictor_from_ckpt(path, batch_sizes=(256,))(Xv), want,
        rtol=0, atol=P_ATOL)
    # the Predictor routes each row as the trainer's eval does
    X, _, p_tr = tr.predict_split(tr.valid_batcher)
    np.testing.assert_allclose(
        predictor_from_checkpoint(path, batch_sizes=(256,),
                                  device="cpu")(X), p_tr, rtol=0,
        atol=P_ATOL)


def test_tpurec_checkpoint_in_port(fitted, data, tmp_path):
    jtr = fitted[0]
    path = str(tmp_path / "jax_cdc.pkl")
    jtr.save_checkpoint(path, extra={"note": "jax"})
    tr = _port(data)
    assert tr.load_checkpoint(path)["extra"] == {"note": "jax"}
    _assert_same_state(train_state_to_flax(tr.state),
                       fser.to_state_dict(jtr.state))
    _assert_same_cluster(tr.cluster, jtr.cluster)
    # setup_data after the restore keeps the restored clustering
    tr.setup_data(data.train, data.valid)
    _assert_same_cluster(tr.cluster, jtr.cluster)
    Xv = data.valid[0]
    np.testing.assert_allclose(
        predictor_from_checkpoint(path, batch_sizes=(256,),
                                  device="cpu")(Xv),
        jax_predictor_from_ckpt(path, batch_sizes=(256,))(Xv), rtol=0,
        atol=P_ATOL)

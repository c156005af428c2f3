"""The port's Trainer (tpurec_torch.train.loop, plain versions on the CPU)
against the JAX package's (tpurec.train.loop), and against itself.

Data: make_synthetic(4000, 6, 4, domain_idx=3, seed=1) at bs=256 (15
steps an epoch, the last one padded), the widths of
tests/test_train_e2e.py.  Across packages the port starts from tpurec's
initial state (``Trainer.restore`` of ``flax.serialization.to_bytes``)
with dropout 0: the two packages cannot share dropout bits.

Tolerances across packages: per-step losses 1e-4 relative; the final
state 1e-4 of max(1, |x|) for every leaf but two kinds.  A bias feeding a
training BatchNorm has a gradient that is zero but for rounding, which
Adam turns into a step of up to about lr either way in both packages
(ROADMAP.md queue 3), so such a bias may differ by 2 lr a step, and so
may the BatchNorm's running mean, which averages the bias in.  Eval on
one state: AUC 1e-4, LogLoss 1e-5.  Eval of the two trained states:
AUC 1e-3, LogLoss 1e-4, the room those biases leave (measured: 9.6e-5
and 1.9e-5).  Within the port the indexed and host paths are bitwise
equal, as are two fits from one seed.  Streaming eval against the exact
eval: the limits of tests/test_train_e2e.py."""

import dataclasses

import flax.serialization as fser
import numpy as np
import pytest
import torch

from tpurec.config import Config as JaxConfig
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.train import Trainer as JaxTrainer
from tpurec.train.loop import EarlyStopper as JaxEarlyStopper
from tpurec_torch.config import Config, ModelConfig, TrainConfig
from tpurec_torch.convert import train_state_to_flax
from tpurec_torch.data import make_synthetic
from tpurec_torch.train import Trainer
from tpurec_torch.train.loop import EarlyStopper, use_streaming_eval

SMALL_MODEL = dict(embed_dim=8, mlp_dims=(32, 16), mmoe_expert_dims=(32, 16),
                   mmoe_tower_dims=(16,), atten_embed_dim=8, att_layer_num=1)
TRAIN = dict(bs=256, epoch=1, seed=0, steps_per_dispatch=4)
D2G = {"mmoe": np.arange(4), "dcn": None}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The models here are small: one torch thread runs them fastest
    beside the other test workers, whose threads would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return make_synthetic(n_rows=4000, n_fields=6, n_domain=4, domain_idx=3,
                          seed=1)


def _cfg(name, dropout=0.0, **train):
    return Config(model=ModelConfig(model=name, dropout=dropout,
                                    **SMALL_MODEL),
                  train=TrainConfig(**{**TRAIN, **train}))


def _trainer(data, name, dropout=0.0, **train):
    return Trainer(_cfg(name, dropout, **train), data.field_dims,
                   data.n_domain, data.domain_idx, domain2group=D2G[name],
                   device="cpu")


def _record(tr, jax_side=False):
    """Wrap tr.scan_steps_idx to keep every step's loss as numpy."""
    orig, out = tr.scan_steps_idx, []

    def wrapped(*args):
        r = orig(*args)
        out.append(np.asarray(r[1] if jax_side else r))
        return r

    tr.scan_steps_idx = wrapped
    return out


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _f64(a):
    if torch.is_tensor(a):
        return a.double().numpy()
    return np.asarray(a).astype(np.float64)


def _feeds_training_bn(key):
    """A Linear's bias whose output a training BatchNorm normalises
    (``linear_i`` -> ``bn_i`` of one MLP), or that BatchNorm's running
    mean."""
    parts = key.split(".")
    if parts[-1] == "mean" and "batch_stats" in parts:
        return True
    if parts[-1] == "bias" and parts[-2].startswith("linear_") \
            and parts[0] == "params":
        return parts[-2] != "linear_out"
    return False


@pytest.mark.parametrize("name", ["mmoe", "dcn"])
def test_one_epoch_matches_tpurec(data, name):
    jcfg = JaxConfig(model=JaxModelConfig(model=name, dropout=0.0,
                                          **SMALL_MODEL),
                     train=JaxTrainConfig(**TRAIN))
    jtr = JaxTrainer(jcfg, data.field_dims, data.n_domain, data.domain_idx,
                     domain2group=D2G[name])
    tr = _trainer(data, name)
    tr.restore(fser.to_bytes(jtr.state))
    lj, lp = _record(jtr, jax_side=True), _record(tr)
    X, y = data.train
    mean_j = jtr.train_epoch(X, y, 0)
    mean_p = tr.train_epoch(X, y, 0)
    lj, lp = np.concatenate(lj), np.concatenate(lp)
    assert lj.shape == lp.shape == (-(-len(X) // TRAIN["bs"]),)
    np.testing.assert_allclose(lp, lj, rtol=1e-4, atol=0)
    assert mean_p == pytest.approx(mean_j, rel=1e-4)

    n_steps = len(lp)
    drift = 2 * jcfg.train.lr * n_steps
    want = dict(_leaves(fser.to_state_dict(jtr.state)))
    got = dict(_leaves(train_state_to_flax(tr.state)))
    assert set(got) == set(want)
    assert int(got["step"]) == int(want["step"]) == n_steps
    assert got["opt_state.0.1.count"].dtype == np.int32
    n_drift = 0
    for k, w in want.items():
        g, w = _f64(got[k]), _f64(w)
        assert g.shape == w.shape, k
        err = np.max(np.abs(g - w) / np.maximum(1.0, np.abs(w)),
                     initial=0.0)
        if _feeds_training_bn(k):
            n_drift += 1
            assert np.max(np.abs(g - w), initial=0.0) <= drift, (k, err)
        else:
            assert err <= 1e-4, (k, err)
    assert n_drift >= 3

    Xv, yv = data.valid
    w = data.domain_cnt_weight()
    ev_j = jtr.evaluate(Xv, yv, w)
    ev_p = tr.evaluate(Xv, yv, w)
    assert abs(ev_p["total_auc"] - ev_j["total_auc"]) <= 1e-3
    assert abs(ev_p["total_loss"] - ev_j["total_loss"]) <= 1e-4
    # one state, two evals: tpurec's trained state in the port
    tr.restore(fser.to_bytes(jtr.state))
    ev_s = tr.evaluate(Xv, yv, w)
    assert abs(ev_s["total_auc"] - ev_j["total_auc"]) <= 1e-4
    assert abs(ev_s["total_loss"] - ev_j["total_loss"]) <= 1e-5
    assert abs(ev_s["mean_auc"] - ev_j["mean_auc"]) <= 1e-4


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("name", ["mmoe", "dcn"])
def test_indexed_and_host_epochs_agree_bitwise(data, name, dropout):
    """The device-resident (indexed) epoch and the host-batching one share
    the batch schedule and the dropout draws; their padding rows differ
    (row 0 of the split against the batch's first row) under mask 0."""
    dev = _trainer(data, name, dropout)
    host = _trainer(data, name, dropout)
    host.DEVICE_RESIDENT_BYTES = 0           # force the host path
    steps = {"dev": [], "host": []}
    for tag, tr in (("dev", dev), ("host", host)):
        for attr in ("scan_steps_idx", "scan_steps", "train_step"):
            orig = getattr(tr, attr)

            def wrapped(*a, _orig=orig, _out=steps[tag]):
                r = _orig(*a)
                _out.append(r.reshape(-1).clone())
                return r

            setattr(tr, attr, wrapped)
    X, y = data.train
    loss_dev = dev.train_epoch(X, y, 0)
    loss_host = host.train_epoch(X, y, 0)
    assert torch.equal(torch.cat(steps["dev"]), torch.cat(steps["host"]))
    assert len(steps["host"]) == 4           # K=4: 4 + 4 + 4 + 3 steps
    assert loss_dev == pytest.approx(loss_host, rel=1e-6)   # sum order
    assert dev.snapshot() == host.snapshot()
    Xv, yv = data.valid
    np.testing.assert_array_equal(dev.predict(Xv), host.predict(Xv))


def test_predict_host_path_equals_resident_path(data):
    tr = _trainer(data, "mmoe")
    tr.train_epoch(*data.train, 0)
    Xv = data.valid[0][:1001]
    resident = tr.predict(Xv)
    assert tr.predict(Xv) is not resident
    assert len(tr._zero_y_cache) == 1        # one zero-label array per X
    tr.DEVICE_RESIDENT_BYTES = 0
    np.testing.assert_array_equal(tr.predict(Xv), resident)
    assert tr.predict(Xv[:0]).shape == (0,)


def test_streaming_eval_matches_exact(data):
    tr = _trainer(data, "mmoe")
    tr.fit(data.train, data.valid, domain_cnt_weight=data.domain_cnt_weight())
    Xv, yv = data.valid
    w = data.domain_cnt_weight()
    exact = tr.evaluate(Xv, yv, domain_cnt_weight=w)
    stream = tr.evaluate_streaming(Xv, yv, domain_cnt_weight=w)
    assert abs(stream["total_auc"] - exact["total_auc"]) < 2e-4
    assert abs(stream["total_loss"] - exact["total_loss"]) < 1e-5
    assert abs(stream["mean_auc"] - exact["mean_auc"]) < 5e-4
    assert abs(stream["mean_loss"] - exact["mean_loss"]) < 1e-5
    assert set(stream["domain_auc"]) == set(exact["domain_auc"])
    for d in exact["domain_auc"]:
        assert abs(stream["domain_auc"][d] - exact["domain_auc"][d]) < 1e-3
        assert abs(stream["domain_loss"][d] - exact["domain_loss"][d]) < 1e-5
    # a ragged final batch is mask-padded, not dropped
    exact_odd = tr.evaluate(Xv[:101], yv[:101], domain_cnt_weight=w)
    stream_odd = tr.evaluate_streaming(Xv[:101], yv[:101],
                                       domain_cnt_weight=w)
    assert abs(stream_odd["total_auc"] - exact_odd["total_auc"]) < 1e-3
    assert abs(stream_odd["total_loss"] - exact_odd["total_loss"]) < 1e-5
    # a split over the device budget streams through fixed-size windows
    tr.DEVICE_RESIDENT_BYTES = 2 << 10
    stream_w = tr.evaluate_streaming(Xv, yv, domain_cnt_weight=w)
    assert abs(stream_w["total_auc"] - stream["total_auc"]) < 1e-6
    assert abs(stream_w["total_loss"] - stream["total_loss"]) < 1e-6
    with pytest.raises(ValueError, match="empty"):
        tr.evaluate_streaming(Xv[:0], yv[:0])


def test_early_stopper_decides_as_tpurec():
    script = [{"total_auc": 0.6}, {"total_auc": 0.62},
              {"mean_auc": 0.55, "total_auc": 0.9}, {"mean_auc": 0.7},
              {"mean_auc": 0.69}, {"mean_auc": 0.7}, {"mean_auc": 0.71},
              {"mean_auc": 0.5}, {"mean_auc": 0.5}, {"mean_auc": 0.5}]
    for patience in (1, 2, 3):
        a, b = EarlyStopper(patience), JaxEarlyStopper(patience)
        for r in script:
            assert a.is_continuable(dict(r)) == b.is_continuable(dict(r))
            assert a.improved == b.improved
            assert a.trial_counter == b.trial_counter
            assert a.best_mean_auc == b.best_mean_auc
            assert a.best_result == b.best_result


def test_fit_restores_the_best_epoch(data):
    tr = _trainer(data, "mmoe", epoch=3, early_stop=5)
    aucs = iter([0.6, 0.7, 0.65])
    snaps = []

    def scripted_eval(X, y, w):
        snaps.append(tr.snapshot())
        return {"total_auc": next(aucs), "total_loss": 0.5}

    tr.evaluate = scripted_eval
    out = tr.fit(data.train, data.valid)
    assert out["valid"]["epoch"] == 1 and out["valid"]["total_auc"] == 0.7
    assert len(snaps) == 3 and snaps[1] != snaps[2]
    assert tr.snapshot() == snaps[1]         # every tensor, bit for bit
    assert tr.state.step == 2 * -(-len(data.train[0]) // TRAIN["bs"])


def test_fit_is_reproducible(data):
    outs = []
    for _ in range(2):
        tr = _trainer(data, "mmoe", dropout=0.2, epoch=2)
        logs = []
        out = tr.fit(data.train, data.valid, data.test,
                     domain_cnt_weight=data.domain_cnt_weight(),
                     log_fn=logs.append)
        for r in (out["valid"], out["test"]):
            r.pop("epoch_seconds", None)
        outs.append((out, tr.snapshot(), [l.get("train_loss") for l in logs]))
    assert repr(outs[0][0]) == repr(outs[1][0])       # NaN-tolerant
    assert outs[0][1] == outs[1][1]
    assert outs[0][2] == outs[1][2]
    assert 0.0 < outs[0][0]["valid"]["total_auc"] <= 1.0


def test_unported_and_invalid_options_raise(data):
    args = (data.field_dims, data.n_domain, data.domain_idx)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(_cfg("mmoe"), *args, mesh=object(), device="cpu")
    bad = dataclasses.replace(_cfg("mmoe"), train=dataclasses.replace(
        _cfg("mmoe").train, embedding_update="dense"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(bad, *args, device="cpu")
    with pytest.raises(ValueError, match="CDC"):
        Trainer(_cfg("cdc"), *args, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(_cfg("deepfm"), *args, device="cpu")
    with pytest.raises(ValueError, match="Unknown model"):
        Trainer(_cfg("nope"), *args, device="cpu")
    tr = _trainer(data, "dcn")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.train_epoch_multihost(*data.train, len(data.train[0]), 0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.evaluate_streaming_multihost(*data.valid, len(data.valid[0]))
    with pytest.raises(ValueError, match="empty"):
        tr.evaluate(data.valid[0][:0], data.valid[1][:0])
    assert not use_streaming_eval(tr.cfg, None)
    assert use_streaming_eval(_cfg("dcn", eval_streaming=True), None)

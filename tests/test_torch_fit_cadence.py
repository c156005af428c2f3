"""Trainer.fit of the port to its early stop, against tpurec's Trainer.fit
(``tpurec/train/loop.py:787``) and against itself.

Data: make_synthetic(4000, 6, 4, domain_idx=3, seed=4) at bs=256 (15
steps an epoch, the last one padded); tests/test_torch_trainer.py's
widths, dropout 0, lr 3e-3, and TrainConfig's own epoch 10 and
early_stop 2.  From tpurec's initial state (``Trainer.restore`` of its
bytes) the valid mean AUC reads 0.585, 0.669, 0.682, 0.670, 0.665: the
fit keeps epoch 2 and stops after epoch 4, each decision by at least
0.012, far above the packages' parting.

Held across packages: the stop epoch and the best epoch; each epoch's
valid AUCs (total and mean) within EPOCH_AUC_TOL and LogLoss within
EPOCH_LOSS_TOL, and the test split's after the restore (measured
largest parting: AUC 5.9e-4 valid, 1.0e-3 test mean AUC; LogLoss 1.9e-4,
which the zero-gradient biases below leave in the BatchNorms' running
means); the restored state within test_one_epoch_matches_tpurec's
limits: 1e-4 of max(1, |x|) (measured 2.4e-7), 2 lr a step for the
biases before a training BatchNorm and their running means, and for the
key third of the attention's ``in_proj_bias``, whose gradient is rounding
too (measured 1.1e-4 after 45 steps).  Windowed streaming eval (a budget
that cuts the train split into 4 windows, the last one ragged) from one
state, tpurec's restored one, within 1e-6 of tpurec's windowed eval
(measured: equal but for 1e-16 in the mean LogLoss).
Within the port the resident fit and the fit with every split over
DEVICE_RESIDENT_BYTES (the host epoch, predict's batch path) are bitwise
equal: every step loss, every epoch's result, the restored state."""

import gc
import threading
import weakref

import flax.serialization as fser
import numpy as np
import pytest
import torch

from tpurec.config import Config as JaxConfig
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.train import Trainer as JaxTrainer
from tpurec_torch.config import Config, ModelConfig, TrainConfig
from tpurec_torch.convert import train_state_to_flax
from tpurec_torch.data import make_synthetic
from tpurec_torch.train import Trainer
import tpurec_torch.train.loop as loop

from test_torch_trainer import _f64, _feeds_training_bn, _leaves

MODEL = dict(model="mmoe", dropout=0.0, embed_dim=8,
             mmoe_expert_dims=(32, 16), mmoe_tower_dims=(16,),
             atten_embed_dim=8, att_layer_num=1)
TRAIN = dict(bs=256, seed=0, lr=3e-3, steps_per_dispatch=4)
D2G = np.arange(4)
BEST, STOP = 2, 4               # the epochs this data gives
EPOCH_AUC_TOL = 2e-3
EPOCH_LOSS_TOL = 5e-4
STATE_RTOL = 1e-4
WINDOW_TOL = 1e-6
WINDOW_ROWS = 1024              # the windowed eval's rows a window
RESULT_KEYS = ("total_auc", "total_loss", "mean_auc", "mean_loss")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _epoch_results(logs):
    return [r for r in logs if "epoch_seconds" in r]


def _record_losses(tr):
    out = []
    for attr in ("scan_steps_idx", "scan_steps", "train_step"):
        orig = getattr(tr, attr)

        def wrapped(*a, _orig=orig):
            r = _orig(*a)
            out.append(r.reshape(-1).clone())
            return r

        setattr(tr, attr, wrapped)
    return out


def _record_snapshots(tr):
    """The snapshot fit keeps at each improving epoch, in order."""
    out, orig = [], tr.snapshot

    def wrapped(*a, **k):
        b = orig(*a, **k)
        out.append(b)
        return b

    tr.snapshot = wrapped
    return out


@pytest.fixture(scope="module")
def runs():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield _fits()
    torch.set_num_threads(n_threads)


def _fits():
    """tpurec's fit, then the port's resident and over the budget, all
    from tpurec's initial state."""
    data = make_synthetic(n_rows=4000, n_fields=6, n_domain=4, domain_idx=3,
                          seed=4)
    w = data.domain_cnt_weight()
    jcfg = JaxConfig(model=JaxModelConfig(**MODEL),
                     train=JaxTrainConfig(**TRAIN))
    jtr = JaxTrainer(jcfg, data.field_dims, data.n_domain, data.domain_idx,
                     domain2group=D2G)
    init = fser.to_bytes(jtr.state)
    jlogs = []
    jout = jtr.fit(data.train, data.valid, data.test, domain_cnt_weight=w,
                   log_fn=jlogs.append)
    cfg = Config(model=ModelConfig(**MODEL), train=TrainConfig(**TRAIN))
    ports = {}
    smallest = min(x.nbytes + y.nbytes
                   for x, y in (data.train, data.valid, data.test))
    for placement in ("resident", "over"):
        tr = Trainer(cfg, data.field_dims, data.n_domain, data.domain_idx,
                     domain2group=D2G, device="cpu")
        tr.restore(init)
        if placement == "over":
            tr.DEVICE_RESIDENT_BYTES = smallest - 1
        losses, snaps, logs = _record_losses(tr), _record_snapshots(tr), []
        out = tr.fit(data.train, data.valid, data.test, domain_cnt_weight=w,
                     log_fn=logs.append)
        del tr.snapshot                  # the class's again
        ports[placement] = dict(tr=tr, out=out, logs=logs, snaps=snaps,
                                losses=torch.cat(losses))
    return dict(data=data, w=w, jtr=jtr, jout=jout, jlogs=jlogs,
                ports=ports)


def test_fit_stops_early_as_tpurecs(runs):
    jep = _epoch_results(runs["jlogs"])
    assert runs["jtr"].cfg.train.epoch == 10
    assert runs["jtr"].cfg.train.early_stop == 2
    assert [r["epoch"] for r in jep] == list(range(STOP + 1))
    assert runs["jout"]["valid"]["epoch"] == BEST
    for p in runs["ports"].values():
        ep = _epoch_results(p["logs"])
        assert [r["epoch"] for r in ep] == list(range(STOP + 1))
        assert p["out"]["valid"]["epoch"] == BEST
        assert p["tr"].stopper.best_result is p["out"]["valid"]
        for a, b in zip(ep, jep):
            for k in ("total_auc", "mean_auc"):
                assert abs(a[k] - b[k]) <= EPOCH_AUC_TOL, (a["epoch"], k)
            for k in ("total_loss", "mean_loss"):
                assert abs(a[k] - b[k]) <= EPOCH_LOSS_TOL, (a["epoch"], k)
            assert a["train_loss"] == pytest.approx(b["train_loss"],
                                                    rel=1e-3)


def test_restored_state_matches_tpurecs(runs):
    jtr = runs["jtr"]
    want = dict(_leaves(fser.to_state_dict(jtr.state)))
    n_steps = (BEST + 1) * -(-len(runs["data"].train[0]) // TRAIN["bs"])
    drift = 2 * TRAIN["lr"] * n_steps
    for p in runs["ports"].values():
        got = dict(_leaves(train_state_to_flax(p["tr"].state)))
        assert set(got) == set(want)
        assert int(got["step"]) == int(want["step"]) == n_steps
        for k, w in want.items():
            g, w = _f64(got[k]), _f64(w)
            drifts = np.full(w.shape, _feeds_training_bn(k))
            if k.endswith("in_proj_bias"):
                A = w.shape[-1] // 3
                drifts[..., A:2 * A] = True     # the keys' bias
            err = np.abs(g - w)
            assert np.max(err[drifts], initial=0.0) <= drift, k
            assert np.max((err / np.maximum(1.0, np.abs(w)))[~drifts],
                          initial=0.0) <= STATE_RTOL, k
    jt, pt = runs["jout"]["test"], runs["ports"]["resident"]["out"]["test"]
    assert abs(pt["total_auc"] - jt["total_auc"]) <= EPOCH_AUC_TOL
    assert abs(pt["total_loss"] - jt["total_loss"]) <= EPOCH_LOSS_TOL


def test_fit_restores_the_best_snapshot(runs):
    """The state after fit is the one snapshotted at the best epoch, and
    evaluating it gives the best epoch's valid result again."""
    data = runs["data"]
    for p in runs["ports"].values():
        tr = p["tr"]
        best = p["snaps"][-1]        # the last improving epoch's
        assert len(p["snaps"]) == BEST + 1
        assert tr.snapshot() == best
        ev = tr.evaluate(*data.valid, runs["w"])
        for k in RESULT_KEYS:
            assert ev[k] == p["out"]["valid"][k], k
        assert ev["domain_auc"] == p["out"]["valid"]["domain_auc"]


def test_placements_agree_bitwise(runs):
    res, over = runs["ports"]["resident"], runs["ports"]["over"]
    n_batch = -(-len(runs["data"].train[0]) // TRAIN["bs"])
    assert res["losses"].numel() == (STOP + 1) * n_batch
    assert torch.equal(res["losses"], over["losses"])
    for a, b in zip(_epoch_results(res["logs"]), _epoch_results(over["logs"])):
        for k in (*RESULT_KEYS, "domain_auc", "domain_loss"):
            assert a[k] == b[k], (a["epoch"], k)
    assert res["snaps"] == over["snaps"]
    assert res["tr"].snapshot() == over["tr"].snapshot()
    assert repr(res["out"]["test"]["total_auc"]) == repr(
        over["out"]["test"]["total_auc"])


def test_windowed_streaming_eval_matches_tpurecs(runs):
    """From one state (tpurec's restored one), the train split through 4
    windows (the last ragged) in both packages, against each other and
    against the port's resident streaming eval."""
    data, w, jtr = runs["data"], runs["w"], runs["jtr"]
    X, y = data.train
    budget = WINDOW_ROWS * (4 * X.shape[1] + 4)
    assert -(-len(y) // WINDOW_ROWS) == 4 and len(y) % WINDOW_ROWS
    tr = Trainer(Config(model=ModelConfig(**MODEL),
                        train=TrainConfig(**TRAIN)),
                 data.field_dims, data.n_domain, data.domain_idx,
                 domain2group=D2G, device="cpu")
    tr.restore(fser.to_bytes(jtr.state))
    resident = tr.evaluate_streaming(X, y, w)
    tr.DEVICE_RESIDENT_BYTES = budget
    jtr.DEVICE_RESIDENT_BYTES = budget
    windows, cut = [], tr._padded_index_batches

    def count(n, bs, chunk):
        windows.append(n)
        return cut(n, bs, chunk)

    tr._padded_index_batches = count
    port = tr.evaluate_streaming(X, y, w)
    ref = jtr.evaluate_streaming(X, y, w)
    assert windows == [WINDOW_ROWS] * 3 + [len(y) - 3 * WINDOW_ROWS]
    for k in RESULT_KEYS:
        assert abs(port[k] - ref[k]) <= WINDOW_TOL, k
        assert abs(port[k] - resident[k]) <= WINDOW_TOL, k
    for d in ref["domain_auc"]:
        assert abs(port["domain_auc"][d] - ref["domain_auc"][d]) <= WINDOW_TOL


class _Stop(Exception):
    pass


@pytest.mark.parametrize("exc", [_Stop, KeyboardInterrupt])
def test_cut_host_epoch_lets_the_split_go(runs, exc):
    """A host-batching epoch cut by its log_fn (or an interrupt) leaves no
    prefetch worker holding the batch stream, and its state is the
    resident epoch's cut at the same step."""
    data = runs["data"]
    cfg = Config(model=ModelConfig(**MODEL),
                 train=TrainConfig(**{**TRAIN, "log_interval_rows": 256}))
    made = []

    class Batcher(loop.ArrayBatcher):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(weakref.ref(self))

    def trainer():
        tr = Trainer(cfg, data.field_dims, data.n_domain, data.domain_idx,
                     domain2group=D2G, device="cpu")
        tr.DEVICE_RESIDENT_BYTES = 0
        return tr

    calls = []

    def cut(r):
        calls.append(r["it"])
        if len(calls) == 2:
            raise exc("cut")

    before = threading.active_count()
    host, resident = trainer(), trainer()
    resident.DEVICE_RESIDENT_BYTES = Trainer.DEVICE_RESIDENT_BYTES
    orig = loop.ArrayBatcher
    loop.ArrayBatcher = Batcher
    try:
        with pytest.raises(exc, match="cut"):
            host.train_epoch(*data.train, 0, log_fn=cut)
    finally:
        loop.ArrayBatcher = orig
    gc.collect()
    assert calls == [4, 8]           # K = 4 steps a chunk, a log each
    assert len(made) == 1 and made[0]() is None
    assert threading.active_count() == before
    # the resident epoch cut at the same step: the same state, bit for bit
    calls.clear()
    with pytest.raises(exc, match="cut"):
        resident.train_epoch(*data.train, 0, log_fn=cut)
    assert calls == [4, 8]
    assert host.state.step == resident.state.step == 8
    assert host.snapshot() == resident.snapshot()

"""The port's Trainer on a mesh (over gloo on the CPU) against the port's
one-device Trainer, the JAX package's Trainer (checkpoints both ways)
and a one-process replay of the multihost epoch.

Two spawns (tests/test_torch_mesh_worker.py's ``trainer`` task): 4 ranks
fit one epoch on (2, 2) and write a pickle checkpoint; 2 ranks load the
JAX package's checkpoint onto (1, 2), then run train_epoch_multihost and
evaluate_streaming_multihost on (2, 1), each data rank feeding only its
dataset range, and the host-batching epoch on (2, 1).  Dropout is 0 (the mesh's masks are not one device's).

Limits: per-step losses rtol 2e-5 and the table and its moments atol
2e-5 (the JAX package's limits for its mesh); a result evaluated from
one state on both sides (the same weights, scored in other batches)
within 1e-6.  Two fits' tables part by about 1e-7, but the biases
before a BatchNorm have no true gradient and step by about lr on
rounding alone (ROADMAP.md, queue 3), and the eval's running means lag
them: the valid scores part by about 1e-4 (held at 1e-3).  Their exact
valid AUCs differ by no more than the share of (positive, negative)
pairs whose scores lie within twice the measured gap (the only pairs
whose order can differ); the mesh's streaming result is the one-device
streaming eval of the mesh's own state.
"""

import numpy as np
import pytest
import torch

import test_torch_mesh_worker as mw
from tpurec_torch.convert import train_state_to_flax
from tpurec_torch.data.loader import ArrayBatcher

LOSS_RTOL, STATE_ATOL, EVAL_TOL, PRED_TOL = 2e-5, 2e-5, 1e-6, 1e-3


def _tpurec_trainer():
    from tpurec.config import Config, ModelConfig, TrainConfig
    from tpurec.train import Trainer

    cfg = Config(model=ModelConfig(**mw.FIT_MODEL),
                 train=TrainConfig(bs=mw.FIT_BS, epoch=1, seed=0))
    return Trainer(cfg, mw.FIT_DIMS, 4, 3, domain2group=np.arange(4))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("trainer")
    data = mw.fit_data()
    jt = _tpurec_trainer()
    jt.save_checkpoint(str(out / "tpurec.pkl"))
    want_load = jt.evaluate(*data.valid, data.domain_cnt_weight())
    mw.spawn("trainer", 4, str(out))
    mw.spawn("trainer", 2, str(out))
    res = {}
    for w in (2, 4):
        with np.load(out / f"trainer_{w}.npz") as z:
            res.update({k: z[k] for k in z.files})
    jt2 = _tpurec_trainer()
    jt2.load_checkpoint(str(out / "mesh.pkl"))
    res["tpurec_eval_of_mesh"] = jt2.evaluate(*data.valid,
                                              data.domain_cnt_weight())
    res["tpurec_load"] = want_load
    return res


def _held(state):
    return [k for k in state if k.endswith("embedding.table")
            or k.endswith(".1.m") or k.endswith(".1.v")]


def test_fit_epoch_on_2x2_matches_one_device(runs):
    data = mw.fit_data()
    tr = mw.record_steps(mw.fit_trainer(mw.fit_config(eval_streaming=True)))
    out = tr.fit(data.train, data.valid,
                 domain_cnt_weight=data.domain_cnt_weight())
    np.testing.assert_allclose(runs["fit/losses"], tr.step_losses,
                               rtol=LOSS_RTOL)
    assert len(tr.step_losses) == -(-len(data.train[0]) // mw.FIT_BS)
    state = mw.flat(train_state_to_flax(tr.state))
    assert len(_held(state)) == 3
    for k in _held(state):
        np.testing.assert_allclose(runs[f"fit/{k}"], state[k], rtol=0,
                                   atol=STATE_ATOL, err_msg=k)
    p = tr.predict(data.valid[0])
    gap = float(np.max(np.abs(runs["fit/pred"] - p)))
    assert gap <= PRED_TOL
    y = data.valid[1].reshape(-1) > 0
    close = np.abs(p[y][:, None] - p[~y][None, :]) <= 2 * gap
    exact = tr.evaluate(*data.valid, data.domain_cnt_weight())
    assert abs(float(runs["fit/exact_total_auc"]) - exact["total_auc"]) \
        <= close.sum() / close.size + 1e-12
    # the mesh's fit evaluates by streaming histograms (its default): the
    # one-device streaming eval of the mesh's own state
    from tpurec_torch.convert import restore_train_state

    restore_train_state(tr.state, _nest({k[4:]: v for k, v in runs.items()
                                         if k.startswith("fit/")
                                         and k[4:] in state}))
    ev = tr.evaluate_streaming(*data.valid, data.domain_cnt_weight())
    for k in ("total_auc", "total_loss", "mean_auc"):
        assert abs(float(runs[f"fit/valid_{k}"]) - ev[k]) <= EVAL_TOL, k


def test_mesh_checkpoint_evaluates_in_tpurec(runs):
    got = runs["tpurec_eval_of_mesh"]
    for k in ("total_auc", "total_loss", "mean_auc"):
        assert abs(got[k] - float(runs[f"fit/exact_{k}"])) <= EVAL_TOL, k


def test_tpurec_checkpoint_loads_onto_1x2(runs):
    want = runs["tpurec_load"]
    for k in ("total_auc", "total_loss"):
        assert abs(float(runs[f"load/{k}"]) - want[k]) <= EVAL_TOL, k


def _replay_streams(data):
    """The global batches of train_epoch_multihost on (2, 1), replayed in
    one process: rank d's shuffled local stream (seed + 7919 d, its
    dataset range, fillers to the global batch count), batch by batch
    concatenated in data-rank order."""
    X, y = data.train
    n, bs = len(X), mw.FIT_BS
    nb, bl = -(-n // bs), bs // 2
    streams = []
    for d in range(2):
        lo, hi = d * n // 2, (d + 1) * n // 2
        b = ArrayBatcher(X[lo:hi], y[lo:hi], bl, group=X[lo:hi, 3],
                         shuffle=True, rng=np.random.default_rng(7919 * d))
        s = list(b)[:nb]
        fill = {"x": np.zeros((bl, X.shape[1]), np.int32),
                "y": np.zeros(bl, np.float32),
                "mask": np.zeros(bl, np.float32),
                "group": np.zeros(bl, np.int32)}
        streams.append(s + [fill] * (nb - len(s)))
    return [{k: np.concatenate([a[k], b[k]]) for k in a}
            for a, b in zip(*streams)]


def test_multihost_epoch_and_eval_match_replay(runs):
    data = mw.fit_data()
    tr = mw.fit_trainer(mw.fit_config())
    losses = []
    for b in _replay_streams(data):
        losses.append(float(tr.train_step(
            tr.state, {k: torch.from_numpy(v) for k, v in b.items()},
            tr.dropout_gen)))
    np.testing.assert_allclose(runs["mh/losses"], losses, rtol=LOSS_RTOL)
    assert abs(float(runs["mh/loss"]) - np.mean(losses)) \
        <= LOSS_RTOL * abs(np.mean(losses))
    state = mw.flat(train_state_to_flax(tr.state))
    for k in _held(state):
        np.testing.assert_allclose(runs[f"mh/{k}"], state[k], rtol=0,
                                   atol=STATE_ATOL, err_msg=k)
    # the eval of the mesh's own state, on one device
    from tpurec_torch.convert import restore_train_state

    restore_train_state(tr.state, _nest({k[3:]: v for k, v in runs.items()
                                         if k.startswith("mh/")
                                         and k[3:] in state}))
    ev = tr.evaluate_streaming(*data.valid, data.domain_cnt_weight())
    for k in ("total_auc", "total_loss", "mean_auc"):
        assert abs(float(runs[f"mh/eval_{k}"]) - ev[k]) <= EVAL_TOL, k
    assert "more rows than this rank's share" in str(runs["mh/surplus"])


def test_host_epoch_on_2x1_matches_one_device(runs):
    """The host-batching epoch (the "dense" update's: ArrayBatcher, K
    stacked batches a call) gives data rank d the d-th slice of every
    global batch, as the indexed epoch does."""
    data = mw.fit_data()
    tr = mw.record_steps(mw.fit_trainer(mw.fit_config(
        embedding_update="dense")))
    tr.train_epoch(*data.train, 0)
    np.testing.assert_allclose(runs["host/losses"], tr.step_losses,
                               rtol=LOSS_RTOL)
    state = mw.flat(train_state_to_flax(tr.state))
    held = [k for k in state if k.endswith("embedding.table")]
    assert len(held) == 3, held               # the table, mu, nu
    for k in held:
        np.testing.assert_allclose(runs[f"host/{k}"], state[k], rtol=0,
                                   atol=STATE_ATOL, err_msg=k)


def _nest(flat):
    out = {}
    for key, v in flat.items():
        *path, last = key.split(".")
        t = out
        for k in path:
            t = t.setdefault(k, {})
        t[last] = v
    return out

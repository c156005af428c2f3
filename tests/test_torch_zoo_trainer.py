"""Training and serving DeepFM, AutoInt and xDeepFM (plain versions on the
CPU) through the Trainer against the JAX package's:

- one indexed epoch (make_synthetic(4000 rows), bs 256: 15 steps, the
  last one padded) and its eval, as tests/test_torch_trainer.py holds
  MMoE: per-step losses 1e-4 relative, the state 1e-4 of max(1, |x|), the
  zero-gradient entries of tests/test_torch_zoo_train.py and the running
  means they feed at 2 lr a step.  One table row may sit past 1e-4, at 2
  lr a step: the zero-gradient biases drift apart by about lr a step in
  the two packages (ROADMAP.md queue 3), which moves the rounding of the
  BatchNorm outputs they feed, and a ReLU input within rounding of 0 then
  takes the other branch.  Measured on AutoInt: step 14 of 15 finds an
  MLP ReLU input at exactly 0 in the port's trajectory, its rows'
  gradients part by 5.3e-5 (of a largest 6.2e-4) from the port's own
  gradients at tpurec's state, and one row ends 1.45e-4 apart; from one
  state every step's row gradients agree within 2.8e-7 of their largest
  (tests/test_torch_zoo_train.py holds steps from one state);
- Trainer checkpoints both ways, bit for bit, served by both packages'
  Predictors and the port's HTTP host, and trained on.  Predictions of
  one state in both packages 4e-6 (P_ATOL: measured 1.1e-6 on DeepFM,
  whose logits reach +-12 at the N(0, 1) table init).
"""

import json
import threading
import urllib.request

import flax.serialization as fser
import numpy as np
import pytest
import torch

from test_torch_zoo_train import PREBN
from tpurec.config import Config as JaxConfig
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.serve import Predictor as JaxPredictor
from tpurec.train import Trainer as JaxTrainer
from tpurec_torch.config import Config, ModelConfig, TrainConfig
from tpurec_torch.convert import train_state_to_flax
from tpurec_torch.data import make_synthetic
from tpurec_torch.serve import predictor_from_checkpoint
from tpurec_torch.server import make_server
from tpurec_torch.train import Trainer

NAMES = ("deepfm", "autoint", "xdeepfm")
SMALL_MODEL = dict(embed_dim=8, atten_embed_dim=8, att_layer_num=1,
                   mlp_dims=(32, 16), cin_layer_sizes=(8, 4), dropout=0.0)
TRAIN = dict(bs=256, epoch=1, seed=0, steps_per_dispatch=4)
P_ATOL = 4e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return make_synthetic(n_rows=4000, n_fields=6, n_domain=4, domain_idx=3,
                          seed=1)


def _cfgs(name, **train):
    kw = dict(model=name, **SMALL_MODEL)
    t = {**TRAIN, **train}
    return (JaxConfig(model=JaxModelConfig(**kw), train=JaxTrainConfig(**t)),
            Config(model=ModelConfig(**kw), train=TrainConfig(**t)))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _drifts(key, shape):
    """Entries of a state-tree leaf whose gradient is rounding alone, or
    the BatchNorm running means such a bias feeds."""
    parts = key.split(".")
    out = np.zeros(shape, bool)
    if parts[0] == "params" and PREBN.match(".".join(parts[1:])):
        out[:] = True
    elif parts[0] == "model_state" and parts[-1] == "mean":
        out[:] = bool(PREBN.match(".".join(parts[2:-2] + [
            parts[-2].replace("bn_", "linear_"), "bias"])))
    elif parts[0] == "params" and parts[-1] == "in_proj_bias":
        A = shape[-1] // 3
        out[..., A:2 * A] = True
    return out


@pytest.mark.parametrize("name", NAMES)
def test_one_epoch_matches_tpurec(data, name):
    """One indexed epoch from tpurec's initial state, per-step losses, the
    final state, eval of the two states (AUC 1e-3, LogLoss 1e-4) and of
    one state in both (AUC 1e-4, LogLoss 1e-5)."""
    jcfg, cfg = _cfgs(name)
    args = (data.field_dims, data.n_domain, data.domain_idx)
    jtr = JaxTrainer(jcfg, *args)
    tr = Trainer(cfg, *args, device="cpu")
    tr.restore(fser.to_bytes(jtr.state))
    lj, lp = [], []
    for t, out, jax_side in ((jtr, lj, True), (tr, lp, False)):
        orig = t.scan_steps_idx

        def wrapped(*a, _orig=orig, _out=out, _j=jax_side):
            r = _orig(*a)
            _out.append(np.asarray(r[1] if _j else r))
            return r
        t.scan_steps_idx = wrapped
    X, y = data.train
    assert len(X) % TRAIN["bs"]                # a padded last batch
    jtr.train_epoch(X, y, 0)
    tr.train_epoch(X, y, 0)
    lj, lp = np.concatenate(lj), np.concatenate(lp)
    assert lj.shape == lp.shape == (-(-len(X) // TRAIN["bs"]),)
    np.testing.assert_allclose(lp, lj, rtol=1e-4, atol=0)
    drift = 2 * jcfg.train.lr * len(lp)
    want = dict(_leaves(fser.to_state_dict(jtr.state)))
    got = dict(_leaves(train_state_to_flax(tr.state)))
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        drifts = _drifts(k, w.shape)
        err = np.abs(g - w) / np.maximum(1.0, np.abs(w))
        if k == "params.embedding.table":    # a ReLU tie's row, at most
            tied = (err > 1e-4).any(axis=1)
            assert tied.sum() <= 1, (k, np.flatnonzero(tied))
            drifts[tied] = True
        assert np.max(np.abs(g - w)[drifts], initial=0.0) <= drift, k
        assert np.max(err[~drifts], initial=0.0) <= 1e-4, (k, err.max())
    Xv, yv = data.valid
    w = data.domain_cnt_weight()
    ev_j, ev_p = jtr.evaluate(Xv, yv, w), tr.evaluate(Xv, yv, w)
    assert abs(ev_p["total_auc"] - ev_j["total_auc"]) <= 1e-3
    assert abs(ev_p["total_loss"] - ev_j["total_loss"]) <= 1e-4
    tr.restore(fser.to_bytes(jtr.state))
    ev_s = tr.evaluate(Xv, yv, w)
    assert abs(ev_s["total_auc"] - ev_j["total_auc"]) <= 1e-4
    assert abs(ev_s["total_loss"] - ev_j["total_loss"]) <= 1e-5


@pytest.mark.parametrize("name", NAMES)
def test_checkpoints_both_ways(tmp_path, data, name):
    """A port Trainer's checkpoint loads into tpurec's Trainer bit for bit
    and tpurec's Predictor serves it; a tpurec checkpoint loads into a
    port Trainer bit for bit, the port's Predictor and HTTP host serve it,
    and the port trains on from it."""
    jcfg, cfg = _cfgs(name, embedding_moments_dtype="bfloat16")
    args = (data.field_dims, data.n_domain, data.domain_idx)
    Xv = data.valid[0]
    tr = Trainer(cfg, *args, device="cpu")
    tr.train_epoch(*data.train, 0)
    path = str(tmp_path / "port.pkl")
    tr.save_checkpoint(path, extra={"note": "port"})
    want = tr.predict(Xv)
    jtr = JaxTrainer(jcfg, *args)
    assert jtr.load_checkpoint(path)["extra"] == {"note": "port"}
    got_tree = dict(_leaves(fser.to_state_dict(jtr.state)))
    for k, v in _leaves(train_state_to_flax(tr.state)):
        a = v.float().numpy() if torch.is_tensor(v) else np.asarray(v)
        np.testing.assert_array_equal(
            np.asarray(got_tree[k]).astype(a.dtype), a, err_msg=k)
    np.testing.assert_allclose(jtr.predict(Xv), want, rtol=0, atol=P_ATOL)
    jp = JaxPredictor(jcfg, *args, batch_sizes=(256,))
    jp.load_checkpoint(path)
    np.testing.assert_allclose(jp(Xv), want, rtol=0, atol=P_ATOL)

    jtr.train_epoch(*data.train, 1)
    jpath = str(tmp_path / "jax.pkl")
    jtr.save_checkpoint(jpath, extra={"note": "jax"})
    want = jtr.predict(Xv)
    back = Trainer(cfg, *args, device="cpu")
    assert back.load_checkpoint(jpath)["extra"] == {"note": "jax"}
    tree = dict(_leaves(train_state_to_flax(back.state)))
    for k, v in _leaves(fser.to_state_dict(jtr.state)):
        t = tree[k]
        a = t.float().numpy() if torch.is_tensor(t) else np.asarray(t)
        np.testing.assert_array_equal(a, np.asarray(v).astype(a.dtype),
                                      err_msg=k)
    np.testing.assert_allclose(back.predict(Xv), want, rtol=0, atol=P_ATOL)
    pred = predictor_from_checkpoint(jpath, batch_sizes=(256,), device="cpu")
    np.testing.assert_allclose(pred(Xv), want, rtol=0, atol=P_ATOL)
    assert np.isfinite(back.train_epoch(*data.train, 2))
    assert back.state.step == 3 * tr.state.step

    srv = make_server(pred, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/predict",
            data=json.dumps({"instances": Xv[:3].tolist()}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            got = np.asarray(json.loads(r.read())["predictions"],
                             np.float32)
        np.testing.assert_array_equal(got, pred(Xv[:3]))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)

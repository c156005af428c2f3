"""Training and serving the group-routed models (HiNet, ADL, ADL-split,
AdaSparse; plain versions on the CPU) through the Trainer against the JAX
package's:

- one indexed epoch (make_synthetic(4000 rows), bs 256: 15 steps, the last
  one padded, whose padded rows tpurec's ADL centre update reads) and its
  eval, as tests/test_torch_trainer.py holds MMoE: per-step losses 1e-4
  relative, the state 1e-4 of max(1, |x|), the zero-gradient biases of
  tests/test_torch_routed_train.py and the running means they feed at 2
  lr a step;
- Trainer checkpoints both ways, bit for bit (ADL's ``adl_state`` rides
  in them), served by both packages' Predictors (1e-6) and the port's
  HTTP host, and trained on;
- ADL's tower count: ``adl`` routes over ``cdc.n_cluster`` towers (4
  here) in the Trainer and the Predictor, ``adl-split`` over the
  grouping's (3).
"""

import json
import threading
import urllib.request

import flax.serialization as fser
import numpy as np
import pytest
import torch

from test_torch_routed import ROUTED
from test_torch_routed_train import PREBN
from tpurec.config import Config as JaxConfig
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.serve import Predictor as JaxPredictor
from tpurec.train import Trainer as JaxTrainer
from tpurec_torch.config import Config, ModelConfig, TrainConfig
from tpurec_torch.convert import train_state_to_flax
from tpurec_torch.data import make_synthetic
from tpurec_torch.serve import Predictor, predictor_from_checkpoint
from tpurec_torch.server import make_server
from tpurec_torch.train import Trainer

SMALL_MODEL = dict(embed_dim=8, atten_embed_dim=8, att_layer_num=1,
                   sei_dims=(16, 8), tower_dims=(32, 16), mlp_dims=(32, 16),
                   dropout=0.0)
TRAIN = dict(bs=256, epoch=1, seed=0, steps_per_dispatch=4)
D2G = np.arange(4) % 3
P_ATOL = 1e-6


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


def _drifts(key):
    """A zero-gradient parameter, or a BatchNorm running mean it feeds,
    in the flax state tree of a TrainState."""
    parts = key.split(".")
    if parts[0] == "params" and parts[-1] == "bias":
        return bool(PREBN.match(".".join(parts[1:])))
    if parts[0] == "model_state" and parts[-1] == "mean":
        return bool(PREBN.match(".".join(parts[2:-2] + [
            parts[-2].replace("bn_", "linear_"), "bias"])))
    return False


@pytest.mark.parametrize("name", ROUTED)
def test_one_epoch_matches_tpurec(data, name):
    """One indexed epoch from tpurec's initial state (15 steps, the last
    one padded), per-step losses 1e-4 relative, the final state 1e-4 of
    max(1, |x|) (ADL's centres included), the drifting entries at 2 lr a
    step; eval of the two states (AUC 1e-3, LogLoss 1e-4) and of one
    state in both (AUC 1e-4, LogLoss 1e-5), as tests/test_torch_trainer.py
    holds MMoE."""
    jcfg, cfg = _cfgs(name)
    jtr = JaxTrainer(jcfg, data.field_dims, data.n_domain, data.domain_idx,
                     domain2group=D2G)
    tr = Trainer(cfg, data.field_dims, data.n_domain, data.domain_idx,
                 domain2group=D2G, device="cpu")
    assert tr.model.n_tower == jtr.model.n_tower == (
        4 if name == "adl" else 3)
    tr.restore(fser.to_bytes(jtr.state))
    lj, lp = [], []
    for t, out, jax_side in ((jtr, lj, True), (tr, lp, False)):
        orig = t.scan_steps_idx

        def wrapped(*args, _orig=orig, _out=out, _j=jax_side):
            r = _orig(*args)
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
    assert ("model_state.adl_state.cluster_centers" in got) == \
        name.startswith("adl")
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        drifts = np.full(w.shape, _drifts(k))
        if k.endswith("in_proj_bias"):
            A = w.shape[-1] // 3
            drifts[..., A:2 * A] = True
        err = np.abs(g - w) / np.maximum(1.0, np.abs(w))
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


@pytest.mark.parametrize("name", ROUTED)
def test_checkpoints_both_ways(tmp_path, data, name):
    """A port Trainer's checkpoint loads into tpurec's Trainer bit for bit
    (ADL's adl_state included) and tpurec's Predictor serves it; a tpurec
    checkpoint loads into a port Trainer bit for bit, the port's
    Predictor and HTTP host serve it, and the port trains on from it."""
    jcfg, cfg = _cfgs(name, embedding_moments_dtype="bfloat16")
    Xv = data.valid[0]
    tr = Trainer(cfg, data.field_dims, data.n_domain, data.domain_idx,
                 domain2group=D2G, device="cpu")
    tr.train_epoch(*data.train, 0)
    path = str(tmp_path / "port.pkl")
    tr.save_checkpoint(path, extra={"note": "port"})
    want = tr.predict(Xv)
    jtr = JaxTrainer(jcfg, data.field_dims, data.n_domain, data.domain_idx,
                     domain2group=D2G)
    assert jtr.load_checkpoint(path)["extra"] == {"note": "port"}
    got_tree = dict(_leaves(fser.to_state_dict(jtr.state)))
    for k, v in _leaves(train_state_to_flax(tr.state)):
        a = v.float().numpy() if torch.is_tensor(v) else np.asarray(v)
        np.testing.assert_array_equal(
            np.asarray(got_tree[k]).astype(a.dtype), a, err_msg=k)
    np.testing.assert_allclose(jtr.predict(Xv), want, rtol=0, atol=P_ATOL)
    jp = JaxPredictor(jcfg, data.field_dims, data.n_domain, data.domain_idx,
                      domain2group=D2G, batch_sizes=(256,))
    jp.load_checkpoint(path)
    np.testing.assert_allclose(jp(Xv), want, rtol=0, atol=P_ATOL)

    # the other way: tpurec trains on, and its checkpoint comes back
    jtr.train_epoch(*data.train, 1)
    jpath = str(tmp_path / "jax.pkl")
    jtr.save_checkpoint(jpath, extra={"note": "jax"})
    want = jtr.predict(Xv)
    back = Trainer(cfg, data.field_dims, data.n_domain, data.domain_idx,
                   domain2group=D2G, device="cpu")
    assert back.load_checkpoint(jpath)["extra"] == {"note": "jax"}
    tree = dict(_leaves(train_state_to_flax(back.state)))
    for k, v in _leaves(fser.to_state_dict(jtr.state)):
        t = tree[k]
        a = t.float().numpy() if torch.is_tensor(t) else np.asarray(t)
        np.testing.assert_array_equal(a, np.asarray(v).astype(a.dtype),
                                      err_msg=k)
    np.testing.assert_allclose(back.predict(Xv), want, rtol=0, atol=P_ATOL)
    pred = predictor_from_checkpoint(jpath, batch_sizes=(256,), device="cpu")
    assert pred.model.n_tower == (4 if name == "adl" else 3)
    np.testing.assert_allclose(pred(Xv), want, rtol=0, atol=P_ATOL)
    assert np.isfinite(back.train_epoch(*data.train, 2))
    assert back.state.step == 3 * tr.state.step
    if name.startswith("adl"):               # the centres moved on
        assert not np.array_equal(back.model.cluster_centers.numpy(),
                                  tree["model_state.adl_state."
                                       "cluster_centers"])

    srv = make_server(pred, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/predict",
            data=json.dumps({"instances": Xv[:1].tolist()}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            got = np.asarray(json.loads(r.read())["predictions"],
                             np.float32)
        np.testing.assert_array_equal(got, pred(Xv[:1]))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def test_adl_tower_counts_follow_tpurec():
    """``adl`` takes n_cluster towers in the Trainer and the Predictor;
    ``adl-split`` takes the grouping's in the Trainer, and in the
    Predictor too (tpurec's Predictor names ``adl`` alone)."""
    from tpurec_torch.config import CDCConfig

    cfg = Config(model=ModelConfig(model="adl", **SMALL_MODEL),
                 cdc=CDCConfig(n_cluster=5))
    d2g = np.array([0, 1, 1, 0])
    assert Predictor(cfg, (6, 7, 8, 4), 4, 3, domain2group=d2g,
                     device="cpu").model.n_tower == 5
    assert Trainer(cfg, (6, 7, 8, 4), 4, 3, domain2group=d2g,
                   device="cpu").model.n_tower == 5
    split = Config(model=ModelConfig(model="adl-split", **SMALL_MODEL),
                   cdc=CDCConfig(n_cluster=5))
    assert Predictor(split, (6, 7, 8, 4), 4, 3, domain2group=d2g,
                     device="cpu").model.n_tower == 2
    assert Trainer(split, (6, 7, 8, 4), 4, 3, domain2group=d2g,
                   device="cpu").model.n_tower == 2

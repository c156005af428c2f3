"""Checkpoints across the two packages: the port's flax-msgpack writer
(tpurec_torch.train.checkpoint.msgpack_dumps) against flax's, a port
Trainer checkpoint in tpurec's Predictor and Trainer, a tpurec Trainer
checkpoint in the port's (MMoE, DCN and CDC's other bases: PLE, PEPNet,
EPNet, STAR; each trains on in the other package), and the port's
versioned PickleBackend.

Tolerances.  The writer and reader move bytes: equal bytes and equal
values.  A checkpoint's state restores exactly (bitwise) into either
Trainer.  Predictions of one state in the other package: 1e-6 absolute
(float32 forwards of two libraries; measured well below)."""

import dataclasses

import flax.serialization as fser
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import tpurec_torch.train.checkpoint as ckpt
from tpurec.config import Config as JaxConfig
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.serve import Predictor as JaxPredictor
from tpurec.serve import predictor_from_checkpoint as jax_predictor_from_ckpt
from tpurec.train import Trainer as JaxTrainer
from tpurec_torch.config import Config, ModelConfig, TrainConfig
from tpurec_torch.convert import train_state_to_flax
from tpurec_torch.data import make_synthetic
from tpurec_torch.serve import Predictor, predictor_from_checkpoint
from tpurec_torch.train import Trainer

SMALL_MODEL = dict(embed_dim=8, mlp_dims=(32, 16), mmoe_expert_dims=(32, 16),
                   mmoe_tower_dims=(16,), atten_embed_dim=8, att_layer_num=1,
                   ple_expert_dims=((32, 16), (16,)), ple_tower_dims=(16,),
                   tower_dims=(32, 16), gate_hidden_dim=16, dropout=0.0)
# CDC's other bases train and serve as zoo models too
BASES = ["ple", "pepnet", "epnet", "star"]
D2G = {"mmoe": np.arange(4), "dcn": None, "ple": np.arange(4),
       "pepnet": np.arange(4), "epnet": np.arange(4),
       "star": np.arange(4) % 3}
P_ATOL = 1e-6


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
    return make_synthetic(n_rows=3000, n_fields=6, n_domain=4, domain_idx=3,
                          seed=1)


def _train_kw(moments):
    return dict(bs=256, epoch=1, seed=0, steps_per_dispatch=4,
                embedding_moments_dtype=moments)


def _port(data, name, moments="float32"):
    cfg = Config(model=ModelConfig(model=name, **SMALL_MODEL),
                 train=TrainConfig(**_train_kw(moments)))
    return Trainer(cfg, data.field_dims, data.n_domain, data.domain_idx,
                   domain2group=D2G[name], device="cpu")


def _jax(data, name, moments="float32"):
    cfg = JaxConfig(model=JaxModelConfig(model=name, **SMALL_MODEL),
                    train=JaxTrainConfig(**_train_kw(moments)))
    return JaxTrainer(cfg, data.field_dims, data.n_domain, data.domain_idx,
                      domain2group=D2G[name])


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _values(a):
    """A leaf as (dtype name, float64 or int values) for an exact match."""
    if torch.is_tensor(a):
        return str(a.dtype).split(".")[-1], a.double().numpy()
    a = np.asarray(a)
    return a.dtype.name, a.astype(np.float64)


def _assert_same_state(got_tree, want_tree):
    got, want = dict(_leaves(got_tree)), dict(_leaves(want_tree))
    assert set(got) == set(want)
    for k in want:
        (dg, g), (dw, w) = _values(got[k]), _values(want[k])
        assert dg == dw and g.shape == w.shape, (k, dg, dw)
        np.testing.assert_array_equal(g, w, err_msg=k)


def _tree(rng):
    bf = rng.normal(size=(5, 3)).astype(np.float32)
    return {
        "f32": rng.normal(size=(4, 7)).astype(np.float32),
        "bf16": bf.astype(ml_dtypes.bfloat16),
        "i8": rng.integers(-128, 127, (300,)).astype(np.int8),
        "i32": rng.integers(-2**31, 2**31 - 1, (2, 3, 4)).astype(np.int32),
        "scalar0d": np.asarray(7, np.int32),
        "npscalar": np.float32(2.5),
        "empty": np.zeros((0, 3), np.float32),
        "nest": {"a": {}, "b": {"c": np.arange(20, dtype=np.int64)}},
        "big_str": "x" * 300, "neg": -70000, "pos": 2**40, "small": -3,
        "t": True, "f": False,
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_msgpack_dumps_equals_flax(seed):
    tree = _tree(np.random.default_rng(seed))
    tree = jax.tree_util.tree_map(lambda x: x, tree)   # flax's key order
    blob = ckpt.msgpack_dumps(tree)
    assert blob == fser.msgpack_serialize(tree)
    back = ckpt.msgpack_restore(blob)
    flax_back = fser.msgpack_restore(blob)
    for (k, v), (_, w) in zip(_leaves(back), _leaves(flax_back)):
        if k == "bf16":                        # the reader widens to f32
            assert v.dtype == np.float32 and w.dtype.name == "bfloat16"
            w = w.astype(np.float32)
        elif isinstance(w, np.ndarray):
            assert v.dtype == w.dtype, k
        np.testing.assert_array_equal(v, w, err_msg=k)
    # torch tensors, bfloat16 included, write the same bytes as numpy
    as_torch = dict(tree, f32=torch.from_numpy(tree["f32"]),
                    bf16=torch.from_numpy(tree["bf16"].astype(np.float32))
                    .to(torch.bfloat16))
    assert ckpt.msgpack_dumps(as_torch) == blob


def test_msgpack_dumps_chunks_large_arrays(monkeypatch):
    a = np.arange(1000, dtype=np.float32).reshape(10, 100)
    monkeypatch.setattr(ckpt, "MAX_CHUNK_SIZE", 1024)
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 1024)
    tree = {"a": a, "b": {"c": torch.from_numpy(a.copy())}}
    blob = ckpt.msgpack_dumps(tree)
    assert blob == fser.msgpack_serialize(
        {"a": a, "b": {"c": a.copy()}})
    back = ckpt.msgpack_restore(blob)
    np.testing.assert_array_equal(back["a"], a)
    np.testing.assert_array_equal(back["b"]["c"], a)
    for unsupported in (object(), 0.5, None):
        with pytest.raises(TypeError):
            ckpt.msgpack_dumps({"x": unsupported})


@pytest.mark.parametrize(
    "name,moments", [(n, m) for n in ("mmoe", "dcn")
                     for m in ("float32", "bfloat16")]
    + [(n, "bfloat16") for n in BASES])
def test_port_checkpoint_in_tpurec(tmp_path, data, name, moments):
    tr = _port(data, name, moments)
    tr.fit(data.train, data.valid)
    path = str(tmp_path / "port.pkl")
    tr.save_checkpoint(path, extra={"note": "port"})
    Xv = data.valid[0]
    want = tr.predict(Xv)

    # tpurec's Trainer restores it: the same tree, bit for bit
    jtr = _jax(data, name, moments)
    payload = jtr.load_checkpoint(path)
    assert payload["extra"] == {"note": "port"}
    _assert_same_state(fser.to_state_dict(jtr.state),
                       train_state_to_flax(tr.state))
    assert jtr.state.step.dtype == np.int32
    np.testing.assert_allclose(jtr.predict(Xv), want, rtol=0, atol=P_ATOL)

    # tpurec's Predictor serves it
    jp = jax_predictor_from_ckpt(path, batch_sizes=(256,))
    np.testing.assert_allclose(jp(Xv), want, rtol=0, atol=P_ATOL)
    # ... and so does the port's, bit for bit
    np.testing.assert_array_equal(
        predictor_from_checkpoint(path, batch_sizes=(256,),
                                  device="cpu")(Xv), want)
    if name in BASES:                          # tpurec trains on from it
        assert np.isfinite(jtr.train_epoch(*data.train, 1))
        assert int(jtr.state.step) == 2 * tr.state.step


@pytest.mark.parametrize("name", ["mmoe", "dcn"] + BASES)
def test_tpurec_checkpoint_in_port(tmp_path, data, name):
    jtr = _jax(data, name, "bfloat16")
    jtr.fit(data.train, data.valid)
    path = str(tmp_path / "jax.pkl")
    jtr.save_checkpoint(path, extra={"note": "jax"})
    Xv = data.valid[0]
    want = jtr.predict(Xv)

    tr = _port(data, name, "bfloat16")
    assert tr.load_checkpoint(path)["extra"] == {"note": "jax"}
    _assert_same_state(train_state_to_flax(tr.state),
                       fser.to_state_dict(jtr.state))
    np.testing.assert_allclose(tr.predict(Xv), want, rtol=0, atol=P_ATOL)
    pred = predictor_from_checkpoint(path, batch_sizes=(256,), device="cpu")
    np.testing.assert_allclose(pred(Xv), want, rtol=0, atol=P_ATOL)
    # a live port Trainer serves through Predictor.load_from_trainer
    live = Predictor(tr.cfg, data.field_dims, data.n_domain, data.domain_idx,
                     domain2group=D2G[name], batch_sizes=(256,),
                     device="cpu").load_from_trainer(tr)
    np.testing.assert_array_equal(live(Xv), tr.predict(Xv))
    loss = tr.train_epoch(*data.train, 1)      # training does not reach it
    np.testing.assert_array_equal(live(Xv), pred(Xv))
    assert np.isfinite(loss) and tr.state.step == 2 * int(jtr.state.step)


def test_snapshot_restore_is_exact_and_in_place(data):
    tr = _port(data, "mmoe", "bfloat16")
    tr.train_epoch(*data.train, 0)
    snap = tr.snapshot()
    table = tr.model.embedding.table
    gather = tr.scan_steps.upd._gather
    loss_a = tr.train_epoch(*data.train, 1)
    after_a = tr.snapshot()
    tr.restore(snap)
    assert tr.snapshot() == snap
    assert tr.model.embedding.table is table
    assert tr.scan_steps.upd._gather is gather and gather.serves(table)
    tr.dropout_gen.manual_seed(tr.cfg.train.seed + 1)
    fresh = _port(data, "mmoe", "bfloat16")
    fresh.restore(snap)
    assert fresh.train_epoch(*data.train, 1) == loss_a
    assert fresh.snapshot() == after_a


def test_pickle_backend_versions(tmp_path, data):
    tr = _port(data, "dcn")
    be = tr.make_checkpointer(str(tmp_path / "v"), max_to_keep=2)
    snaps = {}
    for s in (1, 2, 3, 4):
        tr.train_epoch(*data.train, s)
        tr.save_versioned(be, s, extra={"s": s})
        snaps[s] = tr.snapshot()
    assert sorted(be.all_steps()) == [3, 4] and be.latest_step() == 4
    other = _port(data, "dcn")
    meta = other.load_versioned(be)                  # the newest
    assert meta["extra"] == {"s": 4} and other.snapshot() == snaps[4]
    meta = other.load_versioned(be, step=3)
    assert meta["extra"] == {"s": 3} and other.snapshot() == snaps[3]
    with pytest.raises(FileNotFoundError):
        other.load_versioned(be, step=1)
    empty = ckpt.make_backend("pickle", str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        empty.restore(other.state)
    # "orbax" is the port's asynchronous sharded backend
    # (tests/test_torch_parallel_checkpoint.py)
    assert isinstance(ckpt.make_backend("orbax", str(tmp_path / "o")),
                      ckpt.AsyncBackend)
    with pytest.raises(ValueError, match="unknown"):
        ckpt.make_backend("nope", str(tmp_path / "o"))


def test_layout_tag_is_checked(tmp_path, data):
    import pickle

    tr = _port(data, "dcn")
    path = str(tmp_path / "c.pkl")
    tr.save_checkpoint(path)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    payload["embed_layout"] = None
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(ValueError, match="layout"):
        tr.load_checkpoint(path)

"""tpurec_torch's own copies of the JAX package's pure-Python pieces: the
flax-msgpack checkpoint reader (against flax.serialization), the config
dataclasses, feature hashing, and the params -> state_dict converter."""

import dataclasses

import flax.serialization as fser
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurec.config import CDCConfig as JaxCDCConfig
from tpurec.config import Config as JaxConfig
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import config_to_dict as jax_config_to_dict
from tpurec.data.hashing import hash_ids as jax_hash_ids
from tpurec_torch.config import Config, config_from_dict, config_to_dict
from tpurec_torch.convert import state_dict_from_flax
from tpurec_torch.data.hashing import hash_ids
from tpurec_torch.train.checkpoint import msgpack_restore


def _assert_tree_equal(a, b):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b)
        for k in b:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.shape == b.shape
        np.testing.assert_array_equal(a, b.astype(a.dtype))
    else:
        assert type(a) is type(b) and (a == b or a != a), (a, b)


def _tree(rng):
    return {
        "params": {
            "embedding": {"table": rng.normal(size=(40, 8)).astype(np.float32)},
            "experts": {"linear_0": {
                "weight": rng.normal(size=(3, 16, 4)).astype(np.float32),
                "bias": np.zeros((3, 4), np.float32)}},
        },
        "model_state": {"batch_stats": {"bn_0": {
            "mean": rng.normal(size=(3, 4)).astype(np.float32),
            "num_batches_tracked": np.asarray(7, np.int32)}}},
        "step": np.int64(123456789012),
        "scalars": {"f": 1.5, "neg": -3, "big": 2**40, "nbig": -(2**40),
                    "u8": 200, "i16": -300, "t": True, "none": None,
                    "s": "x" * 40, "long_s": "y" * 70000,
                    "f32": np.float32(0.25), "i8": np.int8(-7),
                    "bool_": np.bool_(True), "c": 1 + 2j},
        "dtypes": {n: (np.arange(6) % 3).astype(n).reshape(2, 3)
                   for n in ("int8", "uint8", "int16", "int32", "uint32",
                             "int64", "float16", "float64", "bool")},
        "wide": {str(i): np.full((1,), i, np.int32) for i in range(20)},
        "list": [1, 2.0, "three"] * 6,
    }


def test_msgpack_reader_matches_flax(rng):
    tree = _tree(rng)
    blob = fser.msgpack_serialize(tree)
    _assert_tree_equal(msgpack_restore(blob), fser.msgpack_restore(blob))


def test_msgpack_reader_bfloat16_and_chunked(rng, monkeypatch):
    bf = jnp.asarray(rng.normal(size=(5, 7)), jnp.bfloat16)
    big = rng.normal(size=(33, 5)).astype(np.float32)
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)   # force chunking
    blob = fser.msgpack_serialize({"bf": np.asarray(bf), "big": big})
    got = msgpack_restore(blob)
    assert got["bf"].dtype == np.float32               # exact widening
    np.testing.assert_array_equal(got["bf"], np.asarray(bf, np.float32))
    np.testing.assert_array_equal(got["big"], big)


def test_msgpack_reader_rejects_truncated_data(rng):
    blob = fser.msgpack_serialize({"a": np.ones(10, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(blob[:-3])
    with pytest.raises(ValueError, match="trailing"):
        msgpack_restore(blob + b"\x00")


def test_config_loads_the_jax_config_dict():
    jcfg = JaxConfig(model=JaxModelConfig(model="cdc", mlp_dims=(8, 4),
                                          ple_expert_dims=((4, 2), (3,))),
                     cdc=JaxCDCConfig(base_model="mmoe", n_cluster=3))
    d = jax_config_to_dict(jcfg)
    cfg = config_from_dict(d)
    assert config_to_dict(cfg) == d
    assert cfg.model.ple_expert_dims == ((4, 2), (3,))
    # same fields and defaults, dataclass by dataclass
    assert config_to_dict(Config()) == jax_config_to_dict(JaxConfig())
    for a, b in zip(dataclasses.fields(Config), dataclasses.fields(JaxConfig)):
        assert a.name == b.name


def test_hash_ids_matches_jax_package(rng):
    ids = rng.integers(-2**40, 2**40, 1000)
    for nb, salt in ((16, 0), (1000, 3), (2**31 - 1, 7)):
        np.testing.assert_array_equal(hash_ids(ids, nb, salt),
                                      jax_hash_ids(ids, nb, salt))


def test_state_dict_from_flax_copies_and_flattens(rng):
    tree = _tree(rng)
    sd = state_dict_from_flax(tree["params"], tree["model_state"])
    assert set(sd) == {"embedding.table", "experts.linear_0.weight",
                       "experts.linear_0.bias", "bn_0.mean",
                       "bn_0.num_batches_tracked"}
    assert sd["bn_0.num_batches_tracked"].dtype == torch.int32
    assert sd["bn_0.num_batches_tracked"].shape == ()
    sd["embedding.table"][0, 0] = 99.0                # a copy, not a view
    assert tree["params"]["embedding"]["table"][0, 0] != 99.0
    with pytest.raises(ValueError, match="two leaves"):
        state_dict_from_flax({"a": {"b": np.ones(1)}},
                             {"c": {"a": {"b": np.ones(1)}}})

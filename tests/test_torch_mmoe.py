"""tpurec_torch MMoE forward (plain versions on the CPU) against the JAX
package's ``model.apply(train=False)``, weights copied with
tpurec_torch.convert, at the flagship widths on a small vocabulary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.models import build_model as jax_build_model
from tpurec_torch.config import ModelConfig
from tpurec_torch.convert import state_dict_from_flax
from tpurec_torch.models import build_model

# the flagship schema's 23 fields with the two huge vocabularies cut down
# (250,000 user ids -> 2,500; 1,368,287 item ids -> 13,683; both stay
# "big" fields of the layout)
FIELD_DIMS = (2500, 10, 10, 10, 10, 10, 10, 10, 10, 13683, 50,
              5000, 400, 3000, 80, 80, 60, 30, 12, 12, 12, 12, 4)
DOMAIN_IDX, N_TOWER = 10, 4
BENCH = dict(model="mmoe", embed_dim=16, mmoe_expert_dims=(256, 128, 64),
             mmoe_tower_dims=(64, 32), use_atten=True, atten_embed_dim=64,
             att_layer_num=3, att_head_num=2)


def random_batch_stats(tree, rng):
    """Non-trivial BN running statistics (means ~N(0,0.3), vars in
    [0.5, 1.5])."""
    def one(path, a):
        if a.dtype != np.float32:
            return a
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.3 * rng.normal(size=a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, tree)


def jax_and_port(field_dims, kw, n_tower, X_init, rng):
    jm = jax_build_model("mmoe", field_dims, n_tower, DOMAIN_IDX,
                         JaxModelConfig(**kw))
    v = jax.tree.map(np.asarray,
                     jax.jit(jm.init)(jax.random.PRNGKey(0),
                                      jnp.asarray(X_init)))
    variables = {"params": v["params"],
                 "batch_stats": random_batch_stats(v["batch_stats"], rng)}
    pm = build_model("mmoe", field_dims, n_tower, DOMAIN_IDX,
                     ModelConfig(**kw), device="cpu").eval()
    pm.load_state_dict(state_dict_from_flax(
        variables["params"], {"batch_stats": variables["batch_stats"]}),
        strict=True)
    return jm, variables, pm


def _ids(rng, field_dims, n):
    return np.stack([rng.integers(0, d, n) for d in field_dims],
                    1).astype(np.int32)


def test_mmoe_forward_matches_jax_at_bench_widths(rng):
    X = _ids(rng, FIELD_DIMS, 53)
    jm, variables, pm = jax_and_port(FIELD_DIMS, BENCH, N_TOWER, X, rng)
    want = np.asarray(jm.apply(variables, jnp.asarray(X), train=False))
    with torch.no_grad():
        got = pm(torch.from_numpy(X)).numpy()
        # the Predictor's form: rows gathered outside the model
        rows = pm.embedding(torch.from_numpy(X))
        got_rows = pm(torch.from_numpy(X), embed_rows=rows.reshape(-1, 16))
    assert got.shape == (53, N_TOWER)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(got_rows.numpy(), got)


def test_mmoe_batch_of_one_skips_batchnorm(rng):
    """BN passes a 1-row batch through unchanged in both packages."""
    dims = (30, 7, 5, 9)
    kw = dict(model="mmoe", embed_dim=8, mmoe_expert_dims=(16, 8),
              mmoe_tower_dims=(8,), atten_embed_dim=8, att_layer_num=1)
    jm, variables, pm = jax_and_port(dims, kw, 2, _ids(rng, dims, 8), rng)
    X = _ids(rng, dims, 1)
    want = np.asarray(jm.apply(variables, jnp.asarray(X), train=False))
    with torch.no_grad():
        got = pm(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_mlp_matches_jax(rng):
    from tpurec.nn.core import MLP as JaxMLP
    from tpurec_torch.nn.core import MLP

    x = rng.normal(size=(9, 12)).astype(np.float32)
    jm = JaxMLP((16, 8))
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    variables = {"params": v["params"],
                 "batch_stats": random_batch_stats(v["batch_stats"], rng)}
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    tm = MLP(12, (16, 8))
    tm.load_state_dict(state_dict_from_flax(
        variables["params"], {"batch_stats": variables["batch_stats"]}),
        strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_state_dict_keys_are_the_flax_paths():
    dims = (30, 7, 5, 9)
    cfg = ModelConfig(model="mmoe", embed_dim=8, mmoe_expert_dims=(16,),
                      mmoe_tower_dims=(8,), atten_embed_dim=8,
                      att_layer_num=2)
    jm = jax_build_model("mmoe", dims, 3, DOMAIN_IDX, JaxModelConfig(
        **{f: getattr(cfg, f) for f in ("model", "embed_dim",
                                        "mmoe_expert_dims", "mmoe_tower_dims",
                                        "atten_embed_dim", "att_layer_num")}))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((4, 4), jnp.int32))
    want = {k: tuple(v.shape) for k, v in state_dict_from_flax(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"]),
        {"batch_stats": jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                     shapes["batch_stats"])}).items()}
    pm = build_model("mmoe", dims, 3, DOMAIN_IDX, cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == want


def test_port_init_is_seeded_and_torch_default(rng):
    dims = (30, 7, 5, 9)
    cfg = ModelConfig(model="mmoe", embed_dim=8, mmoe_expert_dims=(16,),
                      mmoe_tower_dims=(8,), atten_embed_dim=8,
                      att_layer_num=1)
    a = build_model("mmoe", dims, 2, 2, cfg, device="cpu",
                    generator=torch.Generator().manual_seed(5)).state_dict()
    b = build_model("mmoe", dims, 2, 2, cfg, device="cpu",
                    generator=torch.Generator().manual_seed(5)).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    table = a["embedding.table"]
    n_rows = sum(dims)
    assert torch.all(table[n_rows:] == 0) and table[:n_rows].std() > 0.5
    w = a["experts.linear_0.weight"]                  # fan_in = 4 * 8
    assert w.abs().max() <= 1 / np.sqrt(32) and w.abs().max() > 0.1
    bound = np.sqrt(6.0 / (8 + 24))                   # xavier [8, 24]
    w_in = a["aux.atten.self_attn_0.in_proj_weight"]
    assert w_in.abs().max() <= bound
    assert torch.all(a["aux.atten.self_attn_0.in_proj_bias"] == 0)


def test_unported_paths_raise():
    dims = (30, 7, 5, 9)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model("deepfm", dims, 1, 2, ModelConfig(model="deepfm"),
                    device="cpu")
    with pytest.raises(ValueError, match="Unknown model"):
        build_model("nope", dims, 1, 2, ModelConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="DCN"):
        build_model("mmoe", dims, 1, 2, ModelConfig(model="mmoe",
                                                    use_dcn=True),
                    device="cpu")


def test_build_model_defaults_to_the_card():
    dims = (30, 7, 5, 9)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("mmoe", dims, 1, 2, ModelConfig(model="mmoe"))

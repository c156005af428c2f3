"""tpurec_torch's DCN family (plain versions on the CPU) against the JAX
package: the DCN eval forward at the flagship widths, the Predictor on
converted JAX variables and on a JAX checkpoint, the hybrid training step
(one step, and 4 steps from a carried state with bf16 table moments), the
L2 coefficient map, and MMoE with the cross network in its aux head
(``use_dcn=True``).

Weights and optimizer state cross over with tpurec_torch.convert; inputs
are made with numpy from a seed.  Dropout is 0: the two packages cannot
share dropout bits.  Tolerances are those of test_torch_train.py (see its
docstring): the loss and gradients to float32 rounding, parameters after
one step within 2e-6, the dense weights after several steps within 2 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurec.config import Config as JaxConfig
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.config import config_to_dict as jax_config_to_dict
from tpurec.models import build_model as jax_build_model
from tpurec.serve import Predictor as JaxPredictor
from tpurec.train.hybrid import make_hybrid_train_step as jax_hybrid_step
from tpurec.train.reg import reg_coef_tree as jax_reg_coef_tree
from tpurec.train.sparse import init_sparse_opt_state as jax_init_opt
from tpurec.train.step import TrainState as JaxTrainState
from tpurec.train.step import make_optimizer as jax_make_optimizer
from tpurec_torch.config import ModelConfig, TrainConfig, config_from_dict
from tpurec_torch.convert import state_dict_from_flax, train_state_from_flax
from tpurec_torch.models import MULTI_TOWER_OUTPUT, build_model
from tpurec_torch.serve import Predictor, predictor_from_checkpoint
from tpurec_torch.train.hybrid import (init_train_state,
                                       make_hybrid_train_step)
from tpurec_torch.train.reg import reg_coef_tree

# the flagship schema's 23 fields with the two huge vocabularies cut down
# (as tests/test_torch_mmoe.py)
BENCH_DIMS = (2500, 10, 10, 10, 10, 10, 10, 10, 10, 13683, 50,
              5000, 400, 3000, 80, 80, 60, 30, 12, 12, 12, 12, 4)
BENCH = dict(model="dcn", embed_dim=16, mlp_dims=(256, 128, 64),
             n_cross_layers=3)
FIELD_DIMS = (16, 64, 12, 8, 40)      # fields 1 and 4 big at threshold 20
DOMAIN_IDX, BS = 3, 32
SMALL = {"dcn": dict(model="dcn", embed_dim=4, mlp_dims=(16, 8),
                     n_cross_layers=3, dropout=0.0),
         "mmoe_dcn": dict(model="mmoe", embed_dim=4, mmoe_expert_dims=(8,),
                          mmoe_tower_dims=(4,), use_dcn=True,
                          n_cross_layers=2, use_atten=True,
                          atten_embed_dim=8, att_layer_num=1,
                          dropout=0.0)}
L2 = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7


def _ids(rng, dims, n):
    return np.stack([rng.integers(0, d, n) for d in dims],
                    1).astype(np.int32)


def _random_stats(tree, rng):
    def one(path, a):
        if a.dtype != np.float32:
            return a
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.3 * rng.normal(size=a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, tree)


def _jax_variables(jm, X, rng):
    v = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                  jnp.asarray(X)))
    return v["params"], {"batch_stats": _random_stats(v["batch_stats"], rng)}


def test_dcn_forward_matches_jax_at_bench_widths(rng):
    X = _ids(rng, BENCH_DIMS, 53)
    jm = jax_build_model("dcn", BENCH_DIMS, 1, 10, JaxModelConfig(**BENCH))
    params, ms = _jax_variables(jm, X, rng)
    want = np.asarray(jm.apply({"params": params, **ms}, jnp.asarray(X),
                               train=False))
    pm = build_model("dcn", BENCH_DIMS, 1, 10, ModelConfig(**BENCH),
                     device="cpu").eval()
    pm.load_state_dict(state_dict_from_flax(params, ms), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(X)).numpy()
        rows = pm.embedding(torch.from_numpy(X)).reshape(-1, 16)
        got_rows = pm(torch.from_numpy(X), embed_rows=rows).numpy()
    assert got.shape == want.shape == (53,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_rows, got)
    assert "dcn" not in MULTI_TOWER_OUTPUT


@pytest.mark.parametrize("table_dtype,tol", [("float32", 1e-5),
                                             ("int8", 1e-4)])
def test_dcn_predictor_matches_jax_predictor(rng, table_dtype, tol):
    jcfg = JaxConfig(model=JaxModelConfig(**BENCH))
    jp = JaxPredictor(jcfg, BENCH_DIMS, 50, 10, batch_sizes=(32, 128),
                      table_dtype=table_dtype)
    params, ms = _jax_variables(jp.model, _ids(rng, BENCH_DIMS, 8), rng)
    jp.load_variables(params, ms)
    tp = Predictor(config_from_dict(jax_config_to_dict(jcfg)), BENCH_DIMS, 50,
                   10, batch_sizes=(32, 128), table_dtype=table_dtype,
                   device="cpu").load_variables(params, ms)
    assert tp.model_name == "dcn" and not tp.multi_tower
    X = _ids(rng, BENCH_DIMS, 300)         # two chunks of 128 + a tail
    got, want = tp(X), jp(X)
    assert got.shape == want.shape == (300,)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_dcn_checkpoint_serves_like_jax(rng, tmp_path):
    """A JAX Trainer's DCN checkpoint (self-describing) loads through
    predictor_from_checkpoint and scores as the JAX Predictor does."""
    from tpurec.serve import predictor_from_checkpoint as jax_from_ckpt
    from tpurec.train import Trainer

    dims = (300, 7, 5, 9)
    cfg = JaxConfig(model=JaxModelConfig(model="dcn", embed_dim=4,
                                         mlp_dims=(16, 8)),
                    train=JaxTrainConfig(bs=64, seed=0))
    tr = Trainer(cfg, dims, 5, 2)
    path = str(tmp_path / "dcn.pkl")
    tr.save_checkpoint(path)
    X = _ids(rng, dims, 100)
    want = jax_from_ckpt(path, batch_sizes=(64,))(X)
    got = predictor_from_checkpoint(path, batch_sizes=(64,), device="cpu")(X)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_convert_refuses_missing_and_extra_leaves(rng):
    X = _ids(rng, FIELD_DIMS, 8)
    jm = jax_build_model("dcn", FIELD_DIMS, 1, DOMAIN_IDX,
                         JaxModelConfig(**SMALL["dcn"]))
    params, ms = _jax_variables(jm, X, rng)
    pm = build_model("dcn", FIELD_DIMS, 1, DOMAIN_IDX,
                     ModelConfig(**SMALL["dcn"]), device="cpu")
    pm.load_state_dict(state_dict_from_flax(params, ms), strict=True)
    extra = {**params, "cn": {**params["cn"], "w_9": params["cn"]["w_0"]}}
    with pytest.raises(RuntimeError, match="cn.w_9"):
        pm.load_state_dict(state_dict_from_flax(extra, ms), strict=True)
    lacking = {**params, "cn": {k: v for k, v in params["cn"].items()
                                if k != "b_2"}}
    with pytest.raises(RuntimeError, match="cn.b_2"):
        pm.load_state_dict(state_dict_from_flax(lacking, ms), strict=True)


def test_train_state_refuses_missing_and_extra_moments():
    """train_state_from_flax holds the optax moments to the model's dense
    parameters as load_state_dict(strict=True) holds the weights."""
    jcfg, tcfg = _cfgs()
    b = _batch(np.random.default_rng(5))
    _, st, _, _ = _jax_side("mmoe_dcn", jcfg, b)
    ts = _port_side("mmoe_dcn", st, tcfg)
    assert ts.optimizer.state[ts.model.get_parameter("aux.cn.w_0")][
        "exp_avg"].shape == (20, 1)
    opt_rest, emb = st.opt_state
    adam = opt_rest[1]
    mu = jax.tree.map(np.asarray, adam.mu)
    extra = {**mu, "aux": {**mu["aux"], "cn": {**mu["aux"]["cn"],
                                               "w_7": mu["aux"]["cn"]["w_0"]}}}
    lacking = {**mu, "aux": {**mu["aux"], "cn": {
        k: v for k, v in mu["aux"]["cn"].items() if k != "b_1"}}}
    for tree, name in ((extra, "aux.cn.w_7"), (lacking, "aux.cn.b_1")):
        pm = build_model("mmoe", FIELD_DIMS, 2, DOMAIN_IDX,
                         ModelConfig(**SMALL["mmoe_dcn"]), device="cpu")
        with pytest.raises(ValueError, match=name):
            train_state_from_flax(
                pm, tcfg, jax.tree.map(np.asarray, st.params),
                jax.tree.map(np.asarray, st.model_state), tree,
                jax.tree.map(np.asarray, adam.nu), np.asarray(adam.count),
                np.asarray(emb.m), np.asarray(emb.v), np.asarray(st.step),
                device="cpu")


def test_l2_coefficients_follow_jax(rng):
    """dcn: cn.w_* and mlp weights l2_dnn, linear.weight l2_lin, the table
    l2_emb, and nothing for cn.b_*, mlp_linear, biases or BN; the same
    map as the JAX package's reg_coef_tree leaf for leaf."""
    X = _ids(rng, FIELD_DIMS, 8)
    for kind in SMALL:
        kw = SMALL[kind]
        name = kw["model"]
        jm = jax_build_model(name, FIELD_DIMS, 2, DOMAIN_IDX,
                             JaxModelConfig(**kw))
        params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                  jnp.asarray(X)))["params"]
        want = {k: float(v) for k, v in state_dict_from_flax(
            jax_reg_coef_tree(params, name, 1.0, 2.0, 3.0)).items()}
        pm = build_model(name, FIELD_DIMS, 2, DOMAIN_IDX, ModelConfig(**kw),
                         device="cpu")
        got = reg_coef_tree([n for n, _ in pm.named_parameters()], name,
                            1.0, 2.0, 3.0)
        assert got == want, kind
    coefs = reg_coef_tree([n for n, _ in pm.named_parameters()], "mmoe",
                          1.0, 2.0, 3.0)
    assert coefs["aux.cn.w_0"] == 0.0 and coefs["aux.cn_linear.weight"] == 0
    dcn = build_model("dcn", FIELD_DIMS, 1, DOMAIN_IDX,
                      ModelConfig(**SMALL["dcn"]), device="cpu")
    coefs = reg_coef_tree([n for n, _ in dcn.named_parameters()], "dcn",
                          1.0, 2.0, 3.0)
    assert coefs["embedding.table"] == 1.0
    assert coefs["linear.weight"] == 2.0
    assert coefs["cn.w_0"] == coefs["cn.w_2"] == 3.0
    assert coefs["mlp.linear_0.weight"] == coefs["mlp.linear_1.weight"] == 3.0
    for n in ("cn.b_0", "mlp_linear.weight", "mlp.linear_0.bias",
              "mlp.bn_0.scale", "mlp.bn_0.bias", "linear.bias"):
        assert coefs[n] == 0.0, n


# -- the hybrid training step ------------------------------------------------

def _batch(rng, masked=0, dup_heavy=False):
    x = _ids(rng, FIELD_DIMS, BS)
    if dup_heavy:
        x[:, 1] = rng.integers(0, 3, BS)
        x[:, 4] = rng.integers(0, 2, BS)
    mask = np.ones(BS, np.float32)
    mask[BS - masked:] = 0.0
    return {"x": x, "y": rng.integers(0, 2, BS).astype(np.float32),
            "group": (x[:, DOMAIN_IDX] % 2).astype(np.int32), "mask": mask}


def _cfgs(moments="float32"):
    kw = dict(bs=BS, wd=1e-8, embedding_moments_dtype=moments)
    return JaxTrainConfig(**kw), TrainConfig(**kw)


def _jax_side(kind, tcfg, batch, moments_rng=None):
    kw = SMALL[kind]
    name = kw["model"]
    jm = jax_build_model(name, FIELD_DIMS, 2, DOMAIN_IDX,
                         JaxModelConfig(**kw))
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(batch["x"]))
    params = v["params"]
    ms = {k: x for k, x in v.items() if k != "params"}
    tx = jax_make_optimizer(tcfg)
    reg = jax_reg_coef_tree(params, name, L2, L2, L2)
    opt_rest, emb = jax_init_opt(params, tx, tcfg.embedding_moments_dtype)
    step = jnp.zeros((), jnp.int32)
    if moments_rng is not None:
        r = moments_rng

        def rnd(a, scale, pos=False):
            z = r.normal(size=a.shape).astype(np.float32) * scale
            return jnp.asarray(np.abs(z) if pos else z, a.dtype)
        adam = opt_rest[1]
        opt_rest = (opt_rest[0], adam._replace(
            count=jnp.asarray(5, jnp.int32),
            mu=jax.tree.map(lambda a: rnd(a, 1e-2), adam.mu),
            nu=jax.tree.map(lambda a: rnd(a, 1e-4, True), adam.nu)),
            opt_rest[2])
        emb = emb.replace(m=rnd(emb.m, 1e-2), v=rnd(emb.v, 1e-4, True))
        step = jnp.asarray(5, jnp.int32)
    st = JaxTrainState(params=params, opt_state=(opt_rest, emb),
                       model_state=ms, step=step)
    return jm, st, tx, reg


def _port_side(kind, jst, tcfg):
    kw = SMALL[kind]
    pm = build_model(kw["model"], FIELD_DIMS, 2, DOMAIN_IDX,
                     ModelConfig(**kw), device="cpu")
    opt_rest, emb = jst.opt_state
    adam = opt_rest[1]
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return train_state_from_flax(
        pm, tcfg, np_(jst.params), np_(jst.model_state), np_(adam.mu),
        np_(adam.nu), np.asarray(adam.count), np.asarray(emb.m),
        np.asarray(emb.v), np.asarray(jst.step), device="cpu")


def _steps(kind, jm, tx, reg, jcfg, ts, tcfg):
    multi = SMALL[kind]["model"] in MULTI_TOWER_OUTPUT
    jstep, _ = jax_hybrid_step(jm, jcfg, reg, multi, ("batch_stats",),
                               l2_reg_embedding=L2, optimizer=tx,
                               big_vocab_threshold=20)
    step = make_hybrid_train_step(
        ts.model, tcfg, reg_coef_tree(
            [n for n, _ in ts.model.named_parameters()],
            SMALL[kind]["model"], L2, L2, L2),
        multi, L2, big_vocab_threshold=20)
    return jstep, step


def _jax_grads(kind, jm, st, reg, b):
    """loss_fn of hybrid.py:388-403, differentiated as :414-416."""
    from tpurec.train.hybrid import EmbeddingUpdater
    from tpurec.train.reg import regularization_loss as jax_reg_loss
    from tpurec.train.step import bce_with_logits as jax_bce
    from tpurec.train.step import select_tower as jax_select_tower

    batch = {k: jnp.asarray(v) for k, v in b.items()}
    table = st.params["embedding"]["table"]
    rest = {k: v for k, v in st.params.items() if k != "embedding"}
    reg_rest = {k: v for k, v in reg.items() if k != "embedding"}
    rows = EmbeddingUpdater(FIELD_DIMS, JaxTrainConfig(), L2).gather_rows(
        table, batch["x"])
    multi = SMALL[kind]["model"] in MULTI_TOWER_OUTPUT

    def loss_fn(rest, rows):
        out, _ = jm.apply({"params": rest, **st.model_state}, batch["x"],
                          group=batch["group"], train=True,
                          row_mask=batch["mask"], mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)},
                          embed_rows=rows)
        logit = jax_select_tower(out, batch["group"]) if multi else out
        return (jax_bce(logit, batch["y"], batch["mask"])
                + jax_reg_loss(rest, reg_rest))

    loss, (g_rest, g_rows) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        rest, rows)
    return float(loss), _flat(g_rest), np.asarray(g_rows)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# parameters whose gradient is zero in exact arithmetic: a bias that feeds a
# training BatchNorm (the batch mean takes it out again) and the key part of
# an attention in-projection bias (the softmax ignores a shift of every
# score of a row).  Adam turns their rounding-level gradients into steps
# of about lr whose sign the rounding decides, so they hold to 2 lr.
ZERO_GRAD = ("mlp.linear_0.bias", "mlp.linear_1.bias",
             "experts.linear_0.bias", "towers.linear_0.bias",
             "aux.atten.self_attn_0.in_proj_bias")


def _assert_close_state(st, ts, what, dense_atol=2e-6, lr=1e-3):
    sd = {k: v.detach().numpy() for k, v in ts.model.state_dict().items()}
    want = _flat(st.params)
    want.update(_flat(st.model_state["batch_stats"]))
    assert set(want) == set(sd)
    for k, w in want.items():
        if "num_batches" in k:
            np.testing.assert_array_equal(sd[k], w, err_msg=f"{what}: {k}")
        elif "mean" in k or "var" in k:
            np.testing.assert_allclose(sd[k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what}: {k}")
        else:
            atol = (2e-6 if k == "embedding.table" else
                    2 * lr if k in ZERO_GRAD else dense_atol)
            np.testing.assert_allclose(sd[k], w, atol=atol, rtol=0,
                                       err_msg=f"{what}: {k}")
    emb = st.opt_state[1]
    for name in ("m", "v"):
        w = np.asarray(getattr(emb, name)).astype(np.float32)
        got = getattr(ts.emb_opt, name).float().numpy()
        np.testing.assert_allclose(got, w, atol=1e-7, rtol=1e-5,
                                   err_msg=f"{what}: table {name}")


@pytest.mark.parametrize("masked", [0, 3])
@pytest.mark.parametrize("kind", ["dcn", "mmoe_dcn"])
def test_one_step_matches_jax(kind, masked):
    """The rows' and the dense parameters' gradients and the loss before
    the optimizer (the cross network's through autograd of the plain
    recurrence), then every parameter, the BN statistics and the table's
    moments after one hybrid step."""
    jcfg, tcfg = _cfgs()
    b = _batch(np.random.default_rng(0), masked)
    jm, st, tx, reg = _jax_side(kind, jcfg, b)
    ts = _port_side(kind, st, tcfg)
    jstep, step = _steps(kind, jm, tx, reg, jcfg, ts, tcfg)

    loss_j, g_rest_j, g_rows_j = _jax_grads(kind, jm, st, reg, b)
    loss_t, _, g_rows_t = step.loss_and_grads(
        ts, {k: torch.from_numpy(v) for k, v in b.items()}, None)
    assert float(loss_t) == pytest.approx(loss_j, rel=1e-6)
    np.testing.assert_allclose(g_rows_t.numpy(), g_rows_j.reshape(-1, 4),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    named = dict(ts.model.named_parameters())
    assert set(g_rest_j) == set(named) - {"embedding.table"}
    for k, want in g_rest_j.items():
        np.testing.assert_allclose(named[k].grad.numpy(), want,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)

    ts = _port_side(kind, st, tcfg)         # fresh: loss_and_grads moved BN
    jstep, step = _steps(kind, jm, tx, reg, jcfg, ts, tcfg)
    st, loss_j = jstep(st, {k: jnp.asarray(v) for k, v in b.items()},
                       jax.random.PRNGKey(0))
    loss_t = step(ts, {k: torch.from_numpy(v) for k, v in b.items()}, None)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-6)
    assert ts.step == int(st.step) == 1
    _assert_close_state(st, ts, f"{kind} step 1")


@pytest.mark.parametrize("kind", ["dcn", "mmoe_dcn"])
def test_four_steps_from_a_carried_state_bf16_moments(kind):
    jcfg, tcfg = _cfgs("bfloat16")
    rng = np.random.default_rng(1)
    b = _batch(rng, masked=2, dup_heavy=True)
    jm, st, tx, reg = _jax_side(kind, jcfg, b, moments_rng=rng)
    ts = _port_side(kind, st, tcfg)
    assert ts.step == 5 and ts.emb_opt.m.dtype == torch.bfloat16
    jstep, step = _steps(kind, jm, tx, reg, jcfg, ts, tcfg)
    for i in range(4):
        bi = _batch(rng, masked=i, dup_heavy=i % 2 == 1)
        st, loss_j = jstep(st, {k: jnp.asarray(v) for k, v in bi.items()},
                           jax.random.PRNGKey(i))
        loss_t = step(ts, {k: torch.from_numpy(v) for k, v in bi.items()},
                      None)
        assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5), i
    assert ts.step == int(st.step) == 9
    _assert_close_state(st, ts, f"{kind} step 9", dense_atol=2 * jcfg.lr)


def test_mmoe_with_cross_network_forward_matches_jax(rng):
    kw = dict(SMALL["mmoe_dcn"], embed_dim=8, n_cross_layers=3)
    X = _ids(rng, FIELD_DIMS, 40)
    jm = jax_build_model("mmoe", FIELD_DIMS, 2, DOMAIN_IDX,
                         JaxModelConfig(**kw))
    params, ms = _jax_variables(jm, X, rng)
    assert set(params["aux"]) >= {"cn", "cn_linear"}
    want = np.asarray(jm.apply({"params": params, **ms}, jnp.asarray(X),
                               train=False))
    pm = build_model("mmoe", FIELD_DIMS, 2, DOMAIN_IDX, ModelConfig(**kw),
                     device="cpu").eval()
    pm.load_state_dict(state_dict_from_flax(params, ms), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_dcn_training_dropout_is_seeded():
    """MLP dropout draws from the caller's generator: one seed, one loss."""
    _, tcfg = _cfgs()
    b = {k: torch.from_numpy(v) for k, v in _batch(
        np.random.default_rng(4)).items()}
    losses = []
    for seed in (3, 3, 4):
        pm = build_model("dcn", FIELD_DIMS, 1, DOMAIN_IDX, ModelConfig(
            **dict(SMALL["dcn"], dropout=0.2)), device="cpu")
        ts = init_train_state(pm, tcfg, device="cpu")
        step = make_hybrid_train_step(pm, tcfg, {}, False, L2)
        losses.append(step(ts, b, torch.Generator().manual_seed(seed)))
    torch.testing.assert_close(losses[0], losses[1], rtol=0, atol=0)
    assert not torch.equal(losses[0], losses[2])

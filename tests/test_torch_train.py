"""The port's hybrid training step (tpurec_torch.train.hybrid, plain
versions on the CPU) against the JAX package's make_hybrid_train_step, on
the small MMoE of tests/test_hybrid_embed.py with the attention head on.

Weights and optimizer state cross over with tpurec_torch.convert; inputs
are made with numpy from a seed.  Dropout is 0: the two packages cannot
share dropout bits.

Tolerances.  Gradients and the loss agree to float32 rounding of sums
taken in another order (rel 1e-5, or 1e-7 absolute near zero).  Adam
turns a gradient's sign and size into a step of about lr whatever its
magnitude, so a near-zero gradient whose rounding differs in sign moves
a parameter by up to 2 lr the other way.  After one step every
parameter is compared at atol 2e-6; after several steps the dense
weights at 2 lr (the measured difference after 4 steps is about 3e-8,
but a sign flip of one rounding-level gradient would be legitimate),
the table still at 2e-6 (its rows with no batch gradient step on
coef * p alone, computed alike in both packages).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.models import build_model as jax_build_model
from tpurec.train.hybrid import make_hybrid_train_step as jax_hybrid_step
from tpurec.train.reg import reg_coef_tree as jax_reg_coef_tree
from tpurec.train.reg import regularization_loss as jax_reg_loss
from tpurec.train.sparse import init_sparse_opt_state as jax_init_opt
from tpurec.train.step import TrainState as JaxTrainState
from tpurec.train.step import bce_with_logits as jax_bce
from tpurec.train.step import make_optimizer as jax_make_optimizer
from tpurec.train.step import select_tower as jax_select_tower
from tpurec_torch.config import ModelConfig, TrainConfig
from tpurec_torch.convert import train_state_from_flax
from tpurec_torch.models import build_model
from tpurec_torch.train.hybrid import (init_train_state,
                                       make_hybrid_train_step)
from tpurec_torch.train.reg import reg_coef_tree

FIELD_DIMS = (16, 64, 12, 8, 40)      # fields 1 and 4 big at threshold 20
DOMAIN_IDX, N_TOWER, BS = 3, 2, 32
MODEL = dict(model="mmoe", embed_dim=4, mmoe_expert_dims=(8,),
             mmoe_tower_dims=(4,), use_atten=True, atten_embed_dim=8,
             att_layer_num=2, att_head_num=2, dropout=0.0)
L2 = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7


def _batch(rng, dup_heavy=False, masked=0):
    x = np.stack([rng.integers(0, d, BS) for d in FIELD_DIMS],
                 1).astype(np.int32)
    if dup_heavy:
        x[:, 1] = rng.integers(0, 3, BS)
        x[:, 4] = rng.integers(0, 2, BS)
    mask = np.ones(BS, np.float32)
    mask[BS - masked:] = 0.0
    return {"x": x, "y": rng.integers(0, 2, BS).astype(np.float32),
            "group": (x[:, DOMAIN_IDX] % N_TOWER).astype(np.int32),
            "mask": mask}


def _jax_side(tcfg, threshold, batch, moments_rng=None):
    jm = jax_build_model("mmoe", FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                         JaxModelConfig(**MODEL))
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(batch["x"]))
    params = v["params"]
    ms = {k: x for k, x in v.items() if k != "params"}
    tx = jax_make_optimizer(tcfg)
    reg = jax_reg_coef_tree(params, "mmoe", L2, L2, L2)
    opt_rest, emb = jax_init_opt(params, tx, tcfg.embedding_moments_dtype)
    step = jnp.zeros((), jnp.int32)
    if moments_rng is not None:
        # a state part-way through training: non-zero moments everywhere
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


def _port_side(jst, tcfg):
    pm = build_model("mmoe", FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                     ModelConfig(**MODEL), device="cpu")
    opt_rest, emb = jst.opt_state
    adam = opt_rest[1]
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return train_state_from_flax(
        pm, tcfg, np_(jst.params), np_(jst.model_state), np_(adam.mu),
        np_(adam.nu), np.asarray(adam.count), np.asarray(emb.m),
        np.asarray(emb.v), np.asarray(jst.step), device="cpu")


def _cfgs(moments="float32"):
    kw = dict(bs=BS, wd=1e-8, embedding_moments_dtype=moments)
    return JaxTrainConfig(**kw), TrainConfig(**kw)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_grads(jm, st, reg, batch):
    """loss_fn of hybrid.py:388-403, differentiated as :414-416."""
    from tpurec.train.hybrid import EmbeddingUpdater

    table = st.params["embedding"]["table"]
    rest = {k: v for k, v in st.params.items() if k != "embedding"}
    reg_rest = {k: v for k, v in reg.items() if k != "embedding"}
    upd = EmbeddingUpdater(FIELD_DIMS, JaxTrainConfig(), L2)
    rows = upd.gather_rows(table, batch["x"])

    def loss_fn(rest, rows):
        out, _ = jm.apply({"params": rest, **st.model_state}, batch["x"],
                          group=batch["group"], train=True,
                          row_mask=batch["mask"], mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)},
                          embed_rows=rows)
        logit = jax_select_tower(out, batch["group"])
        return (jax_bce(logit, batch["y"], batch["mask"])
                + jax_reg_loss(rest, reg_rest))

    loss, (g_rest, g_rows) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        rest, rows)
    return float(loss), _flat(g_rest), np.asarray(g_rows)


def _assert_close_state(st, ts, what, table_atol=2e-6, dense_atol=2e-6):
    sd = {k: v.detach().numpy() for k, v in ts.model.state_dict().items()}
    np.testing.assert_allclose(sd["embedding.table"],
                               np.asarray(st.params["embedding"]["table"]),
                               atol=table_atol, rtol=0, err_msg=what)
    np.testing.assert_allclose(
        sd["experts.linear_0.weight"],
        np.asarray(st.params["experts"]["linear_0"]["weight"]),
        atol=dense_atol, rtol=0, err_msg=what)
    emb = st.opt_state[1]
    for name in ("m", "v"):
        want = np.asarray(getattr(emb, name)).astype(np.float32)
        got = getattr(ts.emb_opt, name).float().numpy()
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-5,
                                   err_msg=f"{what}: table {name}")
    bs = _flat(st.model_state["batch_stats"], "")
    for k, want in bs.items():
        np.testing.assert_allclose(sd[k], want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("masked", [0, 2])
@pytest.mark.parametrize("dup_heavy", [False, True])
@pytest.mark.parametrize("threshold", [20, 0, 10**9])
def test_one_step_matches_jax(threshold, dup_heavy, masked):
    """Row and dense gradients before the optimizer, the loss, then the
    table, its moments, a dense weight and the BN statistics after one
    step, at thresholds that split the fields (20), send every field down
    the row path (0) and every layout-small field down the sweep (10**9)."""
    jcfg, tcfg = _cfgs()
    b = _batch(np.random.default_rng(0), dup_heavy, masked)
    jm, st, tx, reg = _jax_side(jcfg, threshold, b)
    ts = _port_side(st, tcfg)
    step = make_hybrid_train_step(
        ts.model, tcfg, reg_coef_tree(
            [n for n, _ in ts.model.named_parameters()], "mmoe", L2, L2, L2),
        True, L2, big_vocab_threshold=threshold)

    loss_j, g_rest_j, g_rows_j = _jax_grads(jm, st, reg, _jax_batch(b))
    loss_t, _, g_rows_t = step.loss_and_grads(ts, _torch_batch(b), None)
    assert float(loss_t) == pytest.approx(loss_j, rel=1e-6)
    np.testing.assert_allclose(g_rows_t.numpy(), g_rows_j.reshape(-1, 4),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    named = dict(ts.model.named_parameters())
    assert set(g_rest_j) == set(named) - {"embedding.table"}
    for k, want in g_rest_j.items():
        np.testing.assert_allclose(named[k].grad.numpy(), want,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)

    jstep, _ = jax_hybrid_step(jm, jcfg, reg, True, ("batch_stats",),
                               l2_reg_embedding=L2, optimizer=tx,
                               big_vocab_threshold=threshold)
    ts = _port_side(st, tcfg)          # fresh: loss_and_grads moved BN
    st, loss_jax = jstep(st, _jax_batch(b), jax.random.PRNGKey(0))
    loss_port = step(ts, _torch_batch(b), None)
    assert float(loss_port) == pytest.approx(float(loss_jax), rel=1e-6)
    assert ts.step == int(st.step) == 1
    _assert_close_state(st, ts, "step 1")


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_four_steps_from_a_carried_state(moments):
    """4 steps from a JAX state with non-zero moments (dense and table) at
    step 5, carried over by train_state_from_flax; bf16 moment storage
    against EmbeddingUpdater's embedding_moments_dtype='bfloat16'."""
    jcfg, tcfg = _cfgs(moments)
    rng = np.random.default_rng(1)
    b = _batch(rng, dup_heavy=True, masked=2)
    jm, st, tx, reg = _jax_side(jcfg, 20, b, moments_rng=rng)
    ts = _port_side(st, tcfg)
    assert ts.step == 5 and ts.emb_opt.m.dtype == getattr(torch, moments)
    jstep, _ = jax_hybrid_step(jm, jcfg, reg, True, ("batch_stats",),
                               l2_reg_embedding=L2, optimizer=tx,
                               big_vocab_threshold=20)
    step = make_hybrid_train_step(
        ts.model, tcfg, reg_coef_tree(
            [n for n, _ in ts.model.named_parameters()], "mmoe", L2, L2, L2),
        True, L2, big_vocab_threshold=20)
    for i in range(4):
        bi = _batch(rng, dup_heavy=i % 2 == 1, masked=i)
        st, loss_j = jstep(st, _jax_batch(bi), jax.random.PRNGKey(i))
        loss_t = step(ts, _torch_batch(bi), None)
        assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5), i
    assert ts.step == int(st.step) == 9
    _assert_close_state(st, ts, "step 9", dense_atol=2 * jcfg.lr)


def test_scan_k_matches_single_steps():
    _, tcfg = _cfgs()
    b = _batch(np.random.default_rng(2), masked=1)
    states, losses = [], []
    for scan_k in (None, 3):
        pm = build_model("mmoe", FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                         ModelConfig(**{**MODEL, "dropout": 0.2}),
                         device="cpu",
                         generator=torch.Generator().manual_seed(3))
        ts = init_train_state(pm, tcfg, device="cpu")
        reg = reg_coef_tree([n for n, _ in pm.named_parameters()], "mmoe",
                            L2, L2, L2)
        step = make_hybrid_train_step(pm, tcfg, reg, True, L2,
                                      scan_k=scan_k, big_vocab_threshold=20)
        gen = torch.Generator().manual_seed(7)
        if scan_k:
            tb = {k: torch.from_numpy(np.stack([v] * 3)) for k, v in b.items()}
            out = step(ts, tb, gen)
            assert out.shape == (3,)
        else:
            out = torch.stack([step(ts, _torch_batch(b), gen)
                               for _ in range(3)])
        states.append(ts)
        losses.append(out)
    torch.testing.assert_close(losses[0], losses[1], rtol=0, atol=0)
    a, c = (s.model.state_dict() for s in states)
    for k in a:
        torch.testing.assert_close(a[k], c[k], rtol=0, atol=0)
    assert states[0].step == states[1].step == 3


def test_unported_options_raise():
    _, tcfg = _cfgs()
    pm = build_model("mmoe", FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                     ModelConfig(**MODEL), device="cpu")
    # indexed=True is ported: the device-resident dataset's loop
    scan_idx = make_hybrid_train_step(pm, tcfg, {}, True, L2, indexed=True)
    assert scan_idx.__name__ == "scan_steps_idx"
    # the maker reads no embedding_update (tpurec's does not either, and
    # its CDC engine runs "dense" through it): a "dense" config builds
    dense = make_hybrid_train_step(
        pm, dataclasses.replace(tcfg, embedding_update="dense"), {},
        True, L2)
    assert dense.__class__.__name__ == "HybridTrainStep"
    # bf16 compute is ported; a dtype that names nothing raises
    make_hybrid_train_step(
        pm, dataclasses.replace(tcfg, compute_dtype="bfloat16"), {}, True, L2)
    with pytest.raises(ValueError, match="compute_dtype"):
        make_hybrid_train_step(
            pm, dataclasses.replace(tcfg, compute_dtype="float16"), {},
            True, L2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_hybrid_train_step(pm, tcfg, {}, True, L2).upd.update_stacked()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_train_state(pm, tcfg)

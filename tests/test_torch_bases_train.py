"""The port's hybrid training step on CDC's other base models (PLE,
PEPNet/EPNet and their -single variants, STAR; plain versions on the
CPU) against the JAX package's make_hybrid_train_step, as
tests/test_torch_train.py holds MMoE: the models of
tests/test_torch_bases.py (dropout 0), weights and optimizer state
crossing with tpurec_torch.convert.

After one step every parameter, the table, its moments and the running
statistics (BatchNorm's and STAR's PN) within 2e-6.  After 4 steps from
a carried state (non-zero moments, step 5) the same, except the biases
that reach a training BatchNorm only through its batch mean (PREBN):
their gradient is zero but for rounding, which Adam turns into a step of
up to lr either way, differently in the two packages (ROADMAP.md queue
3), so they are held at 2 lr.  They are the PLE and EPNet towers'
``towers.linear_i.bias``, PEPNet's ``ppnet.tower_linear_i.bias`` and
STAR's ``domain_b_i``, ``shared_b_i`` and its PN's ``bias`` and
``shared_bias`` (each tower's shift is a constant per channel of the
next layer, which the tower BatchNorm over the group's rows removes).  The key third of every
attention layer's ``in_proj_bias`` is held so too, after one step and
after four: a softmax over the keys ignores a shift common to all of
them, so its gradient is rounding alone as well.  Before the first
step, the loss and every gradient agree with tpurec's (rel 1e-5, or 1e-7
absolute near zero), as tests/test_torch_train.py holds MMoE's; those
zero-gradient entries are instead held to be zero, within ZERO_GRAD in
both packages.  The
groups passed to the model (STAR's statistics) are the batch's, as
tpurec's Trainer passes them.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bases import (DOMAIN_IDX, FIELD_DIMS, N_TOWER, NAMES,
                              groups_of, ids, small_kw)
from test_torch_train import (GRAD_ATOL, GRAD_RTOL, _flat, _jax_batch,
                              _torch_batch)
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.models import MULTI_TOWER_OUTPUT as JAX_MULTI
from tpurec.models import build_model as jax_build_model
from tpurec.train.hybrid import make_hybrid_train_step as jax_hybrid_step
from tpurec.train.reg import reg_coef_tree as jax_reg_coef_tree
from tpurec.train.sparse import init_sparse_opt_state as jax_init_opt
from tpurec.train.reg import regularization_loss as jax_reg_loss
from tpurec.train.step import TrainState as JaxTrainState
from tpurec.train.step import bce_with_logits as jax_bce
from tpurec.train.step import make_optimizer as jax_make_optimizer
from tpurec.train.step import select_tower as jax_select_tower
from tpurec_torch.config import ModelConfig, TrainConfig
from tpurec_torch.convert import train_state_from_flax
from tpurec_torch.models import MULTI_TOWER_OUTPUT, build_model
from tpurec_torch.train.hybrid import make_hybrid_train_step
from tpurec_torch.train.reg import reg_coef_tree

BS, L2, THRESHOLD = 32, 1e-5, 20
STATE_TOL = 2e-6
ZERO_GRAD = 1e-6        # a gradient that is zero but for rounding
# biases feeding a training BatchNorm through its mean alone
PREBN = re.compile(r"^(towers\.linear_\d+\.bias|ppnet\.tower_linear_\d+\.bias"
                   r"|domain_b_\d+|shared_b_\d+|pn\.(shared_)?bias)$")


def multi(name):
    return name in MULTI_TOWER_OUTPUT and not name.endswith("-single")


def batch(rng, masked=0):
    x = ids(rng, BS)
    x[:, 1] = rng.integers(0, 3, BS)          # duplicate big-field rows
    mask = np.ones(BS, np.float32)
    mask[BS - masked:] = 0.0
    return {"x": x, "y": rng.integers(0, 2, BS).astype(np.float32),
            "group": groups_of(x), "mask": mask}


def jax_state(name, tcfg, b, moments_rng=None):
    kw = small_kw(name)
    jm = jax_build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                         JaxModelConfig(**kw))
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(b["x"]),
                group=jnp.asarray(b["group"]))
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
    jstep, _ = jax_hybrid_step(jm, tcfg, reg, name in JAX_MULTI
                               and not name.endswith("-single"),
                               ("batch_stats",), l2_reg_embedding=L2,
                               optimizer=tx, big_vocab_threshold=THRESHOLD)
    return jm, reg, st, jax.jit(jstep)


def jax_grads(name, jm, st, reg, b):
    """The loss of the hybrid step before the table's L2 term and its
    gradients (``tpurec/train/hybrid.py:388-416``)."""
    from tpurec.train.hybrid import EmbeddingUpdater

    table = st.params["embedding"]["table"]
    rest = {k: v for k, v in st.params.items() if k != "embedding"}
    reg_rest = {k: v for k, v in reg.items() if k != "embedding"}
    rows = EmbeddingUpdater(FIELD_DIMS, JaxTrainConfig(), L2).gather_rows(
        table, b["x"])

    def loss_fn(rest, rows):
        out, _ = jm.apply({"params": rest, **st.model_state}, b["x"],
                          group=b["group"], train=True, row_mask=b["mask"],
                          mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)},
                          embed_rows=rows)
        logit = jax_select_tower(out, b["group"]) if multi(name) else out
        return jax_bce(logit, b["y"], b["mask"]) + jax_reg_loss(rest,
                                                               reg_rest)

    loss, (g_rest, g_rows) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1)))(rest, rows)
    return float(loss), _flat(g_rest), np.asarray(g_rows)


def port_state(name, jst, tcfg):
    pm = build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                     ModelConfig(**small_kw(name)), device="cpu")
    opt_rest, emb = jst.opt_state
    adam = opt_rest[1]
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    ts = train_state_from_flax(
        pm, tcfg, np_(jst.params), np_(jst.model_state), np_(adam.mu),
        np_(adam.nu), np.asarray(adam.count), np.asarray(emb.m),
        np.asarray(emb.v), np.asarray(jst.step), device="cpu")
    step = make_hybrid_train_step(
        pm, tcfg, reg_coef_tree([n for n, _ in pm.named_parameters()],
                                name, L2, L2, L2),
        multi(name), L2, big_vocab_threshold=THRESHOLD)
    return ts, step


def cfgs(moments="float32"):
    kw = dict(bs=BS, wd=1e-8, embedding_moments_dtype=moments)
    return JaxTrainConfig(**kw), TrainConfig(**kw)


def assert_close_state(st, ts, what, prebn_atol=STATE_TOL):
    """Every parameter and buffer, the table's moments -> the names held
    at ``prebn_atol`` that differ by more than STATE_TOL."""
    sd = {k: v.detach().numpy() for k, v in ts.model.state_dict().items()}
    want = _flat(st.params)
    want.update(_flat(st.model_state["batch_stats"]))
    assert set(want) == set(sd), what
    loose = []
    for k, w in want.items():
        parts = [(k, sd[k], w, PREBN.match(k))]
        if k.endswith("in_proj_bias"):          # q, k, v thirds
            A = w.shape[0] // 3
            parts = [(f"{k}[{i}]", sd[k][i * A:(i + 1) * A],
                      w[i * A:(i + 1) * A], i == 1) for i in range(3)]
        for key, a, b, zero_grad in parts:
            err = np.abs(a - b).max()
            assert err <= (prebn_atol if zero_grad else STATE_TOL), \
                (what, key, err)
            if err > STATE_TOL:
                loose.append(key)
    emb = st.opt_state[1]
    for name in ("m", "v"):
        w = np.asarray(getattr(emb, name)).astype(np.float32)
        got = getattr(ts.emb_opt, name).float().numpy()
        np.testing.assert_allclose(got, w, atol=1e-7, rtol=1e-5,
                                   err_msg=f"{what}: table {name}")
    return loose


@pytest.mark.parametrize("name", NAMES)
def test_one_step_matches_tpurec(name):
    """The loss and every gradient before the optimizer, then the state
    after one step (the zero-gradient biases at 2 lr)."""
    jcfg, tcfg = cfgs()
    b = batch(np.random.default_rng(0), masked=3)
    jm, reg, st, jstep = jax_state(name, jcfg, b)
    ts, step = port_state(name, st, tcfg)
    loss_j, g_rest_j, g_rows_j = jax_grads(name, jm, st, reg, _jax_batch(b))
    loss_t, _, g_rows_t = step.loss_and_grads(ts, _torch_batch(b), None)
    assert float(loss_t) == pytest.approx(loss_j, rel=1e-6)
    np.testing.assert_allclose(g_rows_t.numpy(), g_rows_j.reshape(-1, 4),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    named = dict(ts.model.named_parameters())
    assert set(g_rest_j) == set(named) - {"embedding.table"}
    for k, want in g_rest_j.items():
        got = named[k].grad.numpy()
        zero = np.zeros(want.shape, bool)
        if PREBN.match(k):
            zero[:] = True
        elif k.endswith("in_proj_bias"):
            A = want.shape[0] // 3
            zero[A:2 * A] = True
        assert np.abs(got[zero]).max(initial=0) <= ZERO_GRAD, k
        assert np.abs(want[zero]).max(initial=0) <= ZERO_GRAD, k
        np.testing.assert_allclose(got[~zero], want[~zero], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    ts, step = port_state(name, st, tcfg)    # fresh: the forward moved BN
    st, loss_j = jstep(st, _jax_batch(b), jax.random.PRNGKey(0))
    loss_t = step(ts, _torch_batch(b), None)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-6)
    assert ts.step == int(st.step) == 1
    loose = assert_close_state(st, ts, f"{name} step 1",
                               prebn_atol=2 * jcfg.lr)
    print(f"{name}: zero-gradient biases beyond {STATE_TOL} after a step: "
          f"{loose}")                              # shown by pytest -s


@pytest.mark.parametrize("name", NAMES)
def test_four_steps_from_a_carried_state(name):
    """4 steps from a JAX state with non-zero moments at step 5, bf16
    table moments; the pre-BatchNorm biases at 2 lr."""
    jcfg, tcfg = cfgs("bfloat16")
    rng = np.random.default_rng(1)
    b = batch(rng, masked=2)
    _, _, st, jstep = jax_state(name, jcfg, b, moments_rng=rng)
    ts, step = port_state(name, st, tcfg)
    for i in range(4):
        bi = batch(rng, masked=i)
        st, loss_j = jstep(st, _jax_batch(bi), jax.random.PRNGKey(i))
        loss_t = step(ts, _torch_batch(bi), None)
        assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5), i
    assert ts.step == int(st.step) == 9
    loose = assert_close_state(st, ts, f"{name} step 9",
                               prebn_atol=2 * jcfg.lr)
    print(f"{name}: zero-gradient biases beyond {STATE_TOL} after 4 steps: "
          f"{loose}")                              # shown by pytest -s

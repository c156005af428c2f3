"""The hybrid training step on the group-routed models (HiNet, ADL,
ADL-split, AdaSparse; plain versions on the CPU) against the JAX
package's make_hybrid_train_step, as tests/test_torch_bases_train.py holds
CDC's bases: the loss and every gradient before the optimizer (rel 1e-5,
or 1e-7 absolute near zero), the state after one step and after 4 carried
steps (non-zero moments, step 5, bf16 table moments, padded rows) within
2e-6, ADL's centres (the ``adl_state`` collection the step carries)
included.  The Trainer, checkpoints and serving of these models are
tests/test_torch_routed_trainer.py.

The zero-gradient parameters (ROADMAP.md queue 3): a bias whose Linear
feeds a training BatchNorm (HiNet's SEI experts' and tower's
``linear_i.bias``, ADL's ``domain_mlps.linear_i.bias``) has a gradient
that is zero but for rounding, as has the key third of the attention's
``in_proj_bias``.  Before a step both packages' gradients there are held
to be zero within 1e-6; after it the values at 2 lr a step (Adam turns
rounding into a step of about lr either way), and so are the BatchNorm
running means they feed, as tests/test_torch_trainer.py does.
AdaSparse's ``linear_w_i``/``linear_b_i`` reach a training BatchNorm
through the pruner's factor, which the BatchNorm's backward nearly
cancels: their gradients are held at 1e-5 of each tensor's largest
(CANCELS).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bases import DOMAIN_IDX, FIELD_DIMS, N_TOWER, ids
from test_torch_routed import ROUTED, groups_of, routed_kw
from test_torch_train import (GRAD_ATOL, GRAD_RTOL, _flat, _jax_batch,
                              _torch_batch)
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
from tpurec_torch.config import ModelConfig, TrainConfig
from tpurec_torch.convert import train_state_from_flax
from tpurec_torch.models import build_model
from tpurec_torch.train.hybrid import make_hybrid_train_step
from tpurec_torch.train.reg import reg_coef_tree

BS, L2, THRESHOLD = 32, 1e-5, 20
STATE_TOL = 2e-6
ZERO_GRAD = 1e-6
# biases feeding a training BatchNorm through its mean alone
PREBN = re.compile(r"^((specific|shared)_experts|tower|domain_mlps)"
                   r"\.linear_\d+\.bias$")
# AdaSparse's layer weights and biases reach a training BatchNorm through
# the pruner's row-wise factor: their gradients are sums whose terms the
# BatchNorm's backward nearly cancels, so each is held at GRAD_RTOL of its
# tensor's largest |g| (measured: linear_b_0 2.6e-7 apart at 1.0e-2, 5.4e-6
# of its max; linear_w_0 4.4e-7 at 1.2e-2, 3.0e-7 of its max)
CANCELS = re.compile(r"^linear_[wb]_\d+$")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch(rng, masked=0):
    x = ids(rng, BS)
    x[:, 1] = rng.integers(0, 3, BS)          # duplicate big-field rows
    mask = np.ones(BS, np.float32)
    mask[BS - masked:] = 0.0
    return {"x": x, "y": rng.integers(0, 2, BS).astype(np.float32),
            "group": groups_of(x), "mask": mask}


def cfgs(moments="float32"):
    kw = dict(bs=BS, wd=1e-8, embedding_moments_dtype=moments)
    return JaxTrainConfig(**kw), TrainConfig(**kw)


def jax_state(name, tcfg, b, moments_rng=None, kw=None):
    jm = jax_build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                         JaxModelConfig(**(kw or routed_kw(name))))
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
    jstep, _ = jax_hybrid_step(jm, tcfg, reg, False, tuple(ms),
                               l2_reg_embedding=L2, optimizer=tx,
                               big_vocab_threshold=THRESHOLD)
    return jm, reg, st, jax.jit(jstep)


def jax_grads(jm, st, reg, b):
    """The hybrid step's loss before the table's L2 term and its
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
                          mutable=list(st.model_state),
                          rngs={"dropout": jax.random.PRNGKey(0)},
                          embed_rows=rows)
        return jax_bce(out, b["y"], b["mask"]) + jax_reg_loss(rest,
                                                              reg_rest)

    loss, (g_rest, g_rows) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1)))(rest, rows)
    return float(loss), _flat(g_rest), np.asarray(g_rows)


def port_state(name, jst, tcfg, kw=None):
    pm = build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                     ModelConfig(**(kw or routed_kw(name))), device="cpu")
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
        False, L2, big_vocab_threshold=THRESHOLD)
    return ts, step


def zero_grad_entries(key, shape):
    """Entries of parameter ``key`` whose gradient is rounding alone."""
    zero = np.zeros(shape, bool)
    if PREBN.match(key):
        zero[:] = True
    elif key.endswith("in_proj_bias"):
        A = shape[0] // 3
        zero[A:2 * A] = True
    return zero


def assert_close_state(st, ts, what, zero_atol):
    """Every parameter and buffer (ADL's centres included) and the
    table's moments; the zero-gradient entries and the running means
    they feed at ``zero_atol``."""
    sd = {k: v.detach().numpy() for k, v in ts.model.state_dict().items()}
    want = _flat(st.params)
    for coll in st.model_state.values():
        want.update(_flat(coll))
    assert set(want) == set(sd), what
    for k, w in want.items():
        loose = zero_grad_entries(k, w.shape) if w.ndim else \
            np.zeros((), bool)
        if k.endswith(".mean") and PREBN.match(
                k.replace(".bn_", ".linear_").replace(".mean", ".bias")):
            loose = np.ones(w.shape, bool)
        err = np.abs(sd[k].astype(np.float64) - w)
        assert np.max(err[~loose], initial=0) <= STATE_TOL, (what, k)
        assert np.max(err[loose], initial=0) <= zero_atol, (what, k)
    emb = st.opt_state[1]
    for name in ("m", "v"):
        w = np.asarray(getattr(emb, name)).astype(np.float32)
        got = getattr(ts.emb_opt, name).float().numpy()
        np.testing.assert_allclose(got, w, atol=1e-7, rtol=1e-5,
                                   err_msg=f"{what}: table {name}")


@pytest.mark.parametrize("name", ROUTED)
def test_one_step_matches_tpurec(name):
    jcfg, tcfg = cfgs()
    b = batch(np.random.default_rng(0), masked=3)
    jm, reg, st, jstep = jax_state(name, jcfg, b)
    ts, step = port_state(name, st, tcfg)
    loss_j, g_rest_j, g_rows_j = jax_grads(jm, st, reg, _jax_batch(b))
    loss_t, _, g_rows_t = step.loss_and_grads(ts, _torch_batch(b), None)
    assert float(loss_t) == pytest.approx(loss_j, rel=1e-6)
    np.testing.assert_allclose(g_rows_t.numpy(), g_rows_j.reshape(-1, 4),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    named = dict(ts.model.named_parameters())
    assert set(g_rest_j) == set(named) - {"embedding.table"}
    for k, want in g_rest_j.items():
        got = named[k].grad.numpy()
        zero = zero_grad_entries(k, want.shape)
        assert np.abs(got[zero]).max(initial=0) <= ZERO_GRAD, k
        assert np.abs(want[zero]).max(initial=0) <= ZERO_GRAD, k
        atol = GRAD_ATOL
        if CANCELS.match(k):
            atol = max(atol, GRAD_RTOL * np.abs(want).max())
        np.testing.assert_allclose(got[~zero], want[~zero], rtol=GRAD_RTOL,
                                   atol=atol, err_msg=k)
    ts, step = port_state(name, st, tcfg)    # fresh: the forward moved BN
    entry = {k: v.clone() for k, v in ts.model.state_dict().items()}
    st, loss_j = jstep(st, _jax_batch(b), jax.random.PRNGKey(0))
    loss_t = step(ts, _torch_batch(b), None)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-6)
    assert ts.step == int(st.step) == 1
    assert_close_state(st, ts, f"{name} step 1", 2 * jcfg.lr)
    if name.startswith("adl"):               # the step moved the centres
        assert "adl_state" in st.model_state
        assert not torch.equal(ts.model.cluster_centers,
                               entry["cluster_centers"])


@pytest.mark.parametrize("name", ROUTED)
def test_four_steps_from_a_carried_state(name):
    """4 steps from a JAX state with non-zero moments at step 5, bf16
    table moments, the last two batches with padded rows."""
    jcfg, tcfg = cfgs("bfloat16")
    rng = np.random.default_rng(1)
    b = batch(rng, masked=2)
    _, _, st, jstep = jax_state(name, jcfg, b, moments_rng=rng)
    ts, step = port_state(name, st, tcfg)
    for i in range(4):
        bi = batch(rng, masked=3 * (i // 2))
        st, loss_j = jstep(st, _jax_batch(bi), jax.random.PRNGKey(i))
        loss_t = step(ts, _torch_batch(bi), None)
        assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5), i
    assert ts.step == int(st.step) == 9
    assert_close_state(st, ts, f"{name} step 9", 2 * 4 * jcfg.lr)

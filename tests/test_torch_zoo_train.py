"""The hybrid training step on the rest of the zoo (DeepFM, DCNv2, AutoInt
with and without its residual, xDeepFM, IPNN, OPNN, AFM; plain versions
on the CPU) against the JAX package's make_hybrid_train_step, as
tests/test_torch_routed_train.py holds the routed models: the loss and
every gradient before the optimizer (rel 1e-5, or 1e-7 absolute near
zero), the state after one step and after 4 carried steps (non-zero
moments, step 5, bf16 table moments, padded rows) within 2e-6.

The zero-gradient parameters (ROADMAP.md queue 3): a bias whose Linear
feeds a training BatchNorm (every MLP's ``linear_i.bias``; in DCNv2's
``stacked`` structure also CrossNetV2's last ``b_i``, a shift of every
row the ``dnn``'s first BatchNorm removes), the key third of AutoInt's
``in_proj_bias`` and AFM's ``projection.bias`` (a shift common to every
pair, which the pairs' softmax ignores) have gradients that are zero but
for rounding.  Before a step both packages' gradients
there are held to be zero within 1e-6; after it the values at 2 lr a step
(Adam turns rounding into a step of about lr either way), and so are the
BatchNorm running means they feed.
"""

import re

import jax
import numpy as np
import pytest
import torch

from test_torch_routed_train import batch, cfgs, jax_grads, jax_state, \
    port_state
from test_torch_train import GRAD_ATOL, GRAD_RTOL, _flat, _jax_batch, \
    _torch_batch
from test_torch_zoo import zoo_kw

VARIANTS = ("deepfm", "dcnv2", "dcnv2-v2-stacked", "autoint",
            "autoint-nores", "xdeepfm", "ipnn", "opnn", "afm")
STATE_TOL = 2e-6
ZERO_GRAD = 1e-6
# biases feeding a training BatchNorm through its mean alone, and AFM's
# projection bias, which the softmax over the pairs ignores
PREBN = re.compile(r"^(mlp|dnn)\.linear_\d+\.bias$|^afm\.projection\.bias$")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def zero_grad_entries(key, shape, kw=None):
    """Entries of parameter ``key`` (of the variant of ModelConfig fields
    ``kw``) whose gradient is rounding alone."""
    zero = np.zeros(shape, bool)
    stacked_v2 = kw is not None and kw.get("dcnv2_structure") == "stacked" \
        and not kw.get("dcnv2_use_low_rank_mixture", True)
    if PREBN.match(key) or (stacked_v2 and key ==
                            f"crossnet.b_{kw['n_cross_layers'] - 1}"):
        zero[:] = True
    elif key.endswith("in_proj_bias"):
        A = shape[0] // 3
        zero[A:2 * A] = True
    return zero


def assert_close_state(st, ts, what, zero_atol, kw):
    """Every parameter and buffer and the table's moments; the
    zero-gradient entries and the running means they feed at
    ``zero_atol``."""
    sd = {k: v.detach().numpy() for k, v in ts.model.state_dict().items()}
    want = _flat(st.params)
    for coll in st.model_state.values():
        want.update(_flat(coll))
    assert set(want) == set(sd), what
    for k, w in want.items():
        loose = zero_grad_entries(k, w.shape, kw) if w.ndim else \
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


@pytest.mark.parametrize("variant", VARIANTS)
def test_one_step_matches_tpurec(variant):
    kw = zoo_kw(variant)
    name = kw["model"]
    jcfg, tcfg = cfgs()
    b = batch(np.random.default_rng(0), masked=3)
    jm, reg, st, jstep = jax_state(name, jcfg, b, kw=kw)
    ts, step = port_state(name, st, tcfg, kw=kw)
    loss_j, g_rest_j, g_rows_j = jax_grads(jm, st, reg, _jax_batch(b))
    loss_t, _, g_rows_t = step.loss_and_grads(ts, _torch_batch(b), None)
    assert float(loss_t) == pytest.approx(loss_j, rel=1e-6)
    np.testing.assert_allclose(g_rows_t.numpy(), g_rows_j.reshape(-1, 4),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    named = dict(ts.model.named_parameters())
    assert set(g_rest_j) == set(named) - {"embedding.table"}
    for k, want in g_rest_j.items():
        got = named[k].grad.numpy()
        zero = zero_grad_entries(k, want.shape, kw)
        assert np.abs(got[zero]).max(initial=0) <= ZERO_GRAD, k
        assert np.abs(want[zero]).max(initial=0) <= ZERO_GRAD, k
        np.testing.assert_allclose(got[~zero], want[~zero], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    ts, step = port_state(name, st, tcfg, kw=kw)  # fresh: BN moved
    st, loss_j = jstep(st, _jax_batch(b), jax.random.PRNGKey(0))
    loss_t = step(ts, _torch_batch(b), None)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-6)
    assert ts.step == int(st.step) == 1
    assert_close_state(st, ts, f"{variant} step 1", 2 * jcfg.lr, kw)


@pytest.mark.parametrize("variant", VARIANTS)
def test_four_steps_from_a_carried_state(variant):
    """4 steps from a JAX state with non-zero moments at step 5, bf16
    table moments, the last two batches with padded rows."""
    kw = zoo_kw(variant)
    name = kw["model"]
    jcfg, tcfg = cfgs("bfloat16")
    rng = np.random.default_rng(1)
    b = batch(rng, masked=2)
    _, _, st, jstep = jax_state(name, jcfg, b, moments_rng=rng, kw=kw)
    ts, step = port_state(name, st, tcfg, kw=kw)
    for i in range(4):
        bi = batch(rng, masked=3 * (i // 2))
        st, loss_j = jstep(st, _jax_batch(bi), jax.random.PRNGKey(i))
        loss_t = step(ts, _torch_batch(bi), None)
        assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5), i
    assert ts.step == int(st.step) == 9
    assert_close_state(st, ts, f"{variant} step 9", 2 * 4 * jcfg.lr,
                       kw)

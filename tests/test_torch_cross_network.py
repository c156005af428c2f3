"""tpurec_torch's cross network (kernels 8 and 9, plain versions on the CPU)
against the JAX package's cross_network_fused in interpret mode and its
cross_network_reference.

Inputs come from numpy with a seed.  Tolerances: the forward within 1e-5
of the output's scale, each gradient within 2e-5 of its own scale (float32
sums taken in another order; the measured differences are about 1e-7 and
1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurec.nn.interactions import CrossNetwork as JaxCrossNetwork
from tpurec.ops.crossnet_pallas import cross_network_fused
from tpurec.ops.crossnet_pallas import \
    cross_network_reference as jax_cross_reference
from tpurec_torch.convert import state_dict_from_flax
from tpurec_torch.nn.interactions import CrossNetwork
from tpurec_torch.ops.cross_network import (cross_network,
                                            cross_network_bwd,
                                            cross_network_bwd_reference,
                                            cross_network_fwd,
                                            cross_network_reference)

SHAPES = [(32, 24, 3), (16, 12, 2), (1100, 16, 2), (21, 13, 3)]


def _inputs(B, D, L, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, D)).astype(np.float32),
            (rng.normal(size=(L, D)) * 0.2).astype(np.float32),
            (rng.normal(size=(L, D)) * 0.1).astype(np.float32))


def _jax_grads(fn, x, w, b):
    def loss(x, w, b):
        return jnp.sum(jnp.tanh(fn(x, w, b)))
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))]


def _close(got, want, rel, what):
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("oracle", ["fused_interpret", "reference"])
@pytest.mark.parametrize("B,D,L", SHAPES)
def test_forward_and_gradients_match_jax(B, D, L, oracle):
    """cross_network's value and its autograd gradient of a tanh-sum loss
    (as test_pallas_ops.py does) against the Pallas kernel in interpret
    mode and against the jnp recurrence."""
    x, w, b = _inputs(B, D, L)
    fn = ((lambda x, w, b: cross_network_fused(x, w, b, True))
          if oracle == "fused_interpret" else jax_cross_reference)
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    y = cross_network(*leaves)
    _close(y.detach().numpy(), want, 1e-5, "forward")
    torch.tanh(y).sum().backward()
    for name, t, g in zip("xwb", leaves, _jax_grads(fn, x, w, b)):
        _close(t.grad.numpy(), g, 2e-5, f"d{name}")


@pytest.mark.parametrize("B,D,L", SHAPES)
def test_plain_backward_in_kernel_steps_matches_jax(B, D, L):
    """cross_network_bwd (kernel 9's plain version on the CPU) from the
    output gradient of the tanh-sum loss, against JAX's custom VJP."""
    x, w, b = _inputs(B, D, L, seed=1)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    y = cross_network_fwd(xt, wt, bt)
    g = 1.0 - torch.tanh(y) ** 2
    got = cross_network_bwd(xt, wt, bt, g)
    want = _jax_grads(lambda x, w, b: cross_network_fused(x, w, b, True),
                      x, w, b)
    for name, a, e in zip("xwb", got, want):
        assert a.shape == e.shape
        _close(a.numpy(), e, 2e-5, f"d{name}")


def test_nan_row_gives_nan_weight_gradients_in_both_packages():
    """A real row holding NaN (the gather's out-of-range fill) spreads into
    dw and db, in JAX's kernel and in the port; dx stays finite on the
    other rows."""
    x, w, b = _inputs(20, 12, 2, seed=2)
    x[3, 5] = np.nan
    g = np.ones_like(x)
    _, vjp = jax.vjp(lambda x, w, b: cross_network_fused(x, w, b, True),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    dx, dw, db = (a.numpy() for a in cross_network_bwd_reference(
        *(torch.from_numpy(a) for a in (x, w, b, g))))
    for port, jax_ in ((dw, jdw), (db, jdb)):
        assert np.isnan(port).any() and np.isnan(jax_).any()
        np.testing.assert_array_equal(np.isnan(port), np.isnan(jax_))
    np.testing.assert_array_equal(np.isnan(dx), np.isnan(jdx))
    assert np.isfinite(np.delete(dx, 3, axis=0)).all()


def test_module_keeps_jax_names_shapes_and_output():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(9, 20)).astype(np.float32)
    jm = JaxCrossNetwork(3, fused=False)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))["params"]
    params = jax.tree.map(lambda a: a + rng.normal(size=a.shape).astype(
        np.float32) * 0.1, params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = CrossNetwork(20, 3)
    sd = state_dict_from_flax(params)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    assert set(sd) == {f"{p}_{i}" for p in "wb" for i in range(3)}
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    _close(got, want, 1e-5, "CrossNetwork")


def test_module_init_is_torch_linear_default():
    from tpurec_torch.nn.initializers import init_module

    tm = init_module(CrossNetwork(64, 2), torch.Generator().manual_seed(0))
    for i in range(2):
        w, b = getattr(tm, f"w_{i}"), getattr(tm, f"b_{i}")
        assert w.shape == (64, 1) and b.shape == (64,)
        assert 0.08 < w.abs().max() <= 1 / 8 and torch.all(b == 0)


def test_reference_is_the_jnp_recurrence():
    x, w, b = _inputs(7, 5, 4, seed=4)
    want = np.asarray(jax_cross_reference(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b)))
    got = cross_network_reference(*(torch.from_numpy(a) for a in (x, w, b)))
    _close(got.numpy(), want, 1e-5, "reference")


def test_bad_shapes_raise():
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="w and b"):
        cross_network(x, torch.zeros(2, 5), torch.zeros(2, 5))
    with pytest.raises(ValueError, match="at least one layer"):
        cross_network(x, torch.zeros(0, 6), torch.zeros(0, 6))
    with pytest.raises(ValueError, match="g must be"):
        cross_network_bwd(x, torch.zeros(2, 6), torch.zeros(2, 6),
                          torch.zeros(3, 6))


def _one_reduction(x, w, b):
    """The algebra kernels 8 and 9 run, in float64 numpy: c_l = x0 . w_l,
    e_l = bsum_l . w_l, s_l = (1 + S_l) c_l + e_l, out = x0 (1 + S_L) +
    bsum_L."""
    x, w, b = (a.astype(np.float64) for a in (x, w, b))
    L = w.shape[0]
    c = x @ w.T                                               # [B, L]
    bsum = np.concatenate([np.zeros((1, w.shape[1])), np.cumsum(b, 0)])
    e = np.einsum("ld,ld->l", bsum[:L], w)                    # e_0 = 0
    S = np.zeros(x.shape[0])
    for l in range(L):
        S = S + (1.0 + S) * c[:, l] + e[l]
    return x * (1.0 + S)[:, None] + bsum[L]


@pytest.mark.parametrize("B,D,L", SHAPES + [(9, 368, 3), (5, 16, 1),
                                            (6, 20, 8), (4, 24, 11)])
def test_one_reduction_algebra_equals_the_recurrence(B, D, L):
    """The one-reduction rewrite equals tpurec's cross_network_reference
    (the recurrence, in float32) to float32 rounding, and the recurrence
    in float64 to float64 rounding."""
    x, w, b = _inputs(B, D, L, seed=7)
    got = _one_reduction(x, w, b)
    want = np.asarray(jax_cross_reference(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b)))
    _close(got, want, 1e-5, "vs tpurec's reference")
    x64, w64, b64 = (a.astype(np.float64) for a in (x, w, b))
    r = x64
    for l in range(L):
        r = x64 * (r @ w64[l])[:, None] + b64[l] + r
    _close(got, r, 1e-12, "vs the float64 recurrence")

"""tpurec_torch's per-layer attention path (kernels 4 and 5, plain versions
on the CPU) against the JAX package's fused_field_attention_layered and
fused_attention_layer in interpret mode, at test_attention_pallas.py's
shapes; and, inside the port, the layered form against the stack form
with dropout and one seed.

Inputs come from numpy with a seed.  Tolerances: the forward within 1e-5
(as test_attention_pallas.py holds the JAX kernels), gradients within 2e-5
of each one's scale (float32 sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurec.ops.attention_pallas import (fused_attention_layer as
                                         jax_fused_attention_layer)
from tpurec.ops.attention_pallas import fused_field_attention_layered
from tpurec_torch.ops.attention import (attention_layer_bwd,
                                        attention_layer_bwd_reference,
                                        attention_layer_fwd,
                                        field_attention,
                                        field_attention_layered,
                                        fused_attention_layer, keep_mask)

B, F, D, A, H, L = 36, 7, 16, 32, 2, 3


def _weights(rng, res=True):
    mk = lambda *s: (rng.normal(size=s) * 0.2).astype(np.float32)  # noqa
    flat = [mk(D, A), mk(A), mk(D, A) if res else None,
            mk(A) if res else None]
    for _ in range(L):
        flat += [mk(A, 3 * A), mk(3 * A), mk(A, A), mk(A)]
    return flat


def _jax_layered(emb, flat):
    return fused_field_attention_layered(emb, flat, 0, L, H, 0.0, False, 16,
                                         True)


def _close(got, want, rel, what):
    scale = float(np.max(np.abs(want))) + 1e-9
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0,
                               err_msg=what)


def test_layered_forward_matches_jax(rng):
    flat = _weights(rng)
    emb = rng.normal(size=(B, F, D)).astype(np.float32)
    want = np.asarray(_jax_layered(jnp.asarray(emb),
                                   [jnp.asarray(w) for w in flat]))
    with torch.no_grad():
        got = field_attention_layered(torch.from_numpy(emb),
                                      [torch.from_numpy(w) for w in flat],
                                      L, H)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_rows", [28, 1])
def test_layered_gradients_match_jax(rng, n_rows):
    """The gradient of sum(y**2) with respect to emb and every weight, at a
    ragged batch (28 rows against JAX's 16-row tiles) and at one row."""
    flat = _weights(rng)
    emb = rng.normal(size=(n_rows, F, D)).astype(np.float32)

    def loss(emb, flat):
        return jnp.sum(_jax_layered(emb, flat) ** 2)

    g_emb, g_flat = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(emb), [jnp.asarray(w) for w in flat])
    e = torch.from_numpy(emb).requires_grad_(True)
    leaves = [torch.from_numpy(w).requires_grad_(True) for w in flat]
    (field_attention_layered(e, leaves, L, H) ** 2).sum().backward()
    _close(e.grad.numpy(), np.asarray(g_emb), 2e-5, "demb")
    for i, (t, g) in enumerate(zip(leaves, g_flat)):
        _close(t.grad.numpy(), np.asarray(g), 2e-5, f"flat_w[{i}]")


def test_one_layer_and_its_backward_match_jax(rng):
    """fused_attention_layer and attention_layer_bwd (kernel 5's plain
    version) against JAX's one-layer kernel and its custom VJP."""
    x = rng.normal(size=(B, F, A)).astype(np.float32)
    ws = [w.astype(np.float32) for w in _weights(rng)[4:8]]
    dy = rng.normal(size=(B, F, A)).astype(np.float32)

    def jfn(x, *ws):
        return jax_fused_attention_layer(x, *ws, 0, H, 0.0, False, 16, True)

    want, vjp = jax.vjp(jfn, jnp.asarray(x), *[jnp.asarray(w) for w in ws])
    want_grads = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x)
    tws = [torch.from_numpy(w) for w in ws]
    got = fused_attention_layer(tx, *tws, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    dx, grads = attention_layer_bwd(tx, torch.from_numpy(dy), *tws, H)
    for i, (a, g) in enumerate(zip([dx] + grads, want_grads)):
        assert a.shape == g.shape
        _close(a.numpy(), np.asarray(g), 2e-5, f"grad {i}")


@pytest.mark.parametrize("res", [True, False])
def test_layered_equals_stack_in_training_with_one_seed(rng, res):
    """With dropout 0.2 and one seed, the layered form drops the weights the
    stack drops: the output and every gradient agree."""
    flat = [None if w is None else torch.from_numpy(w)
            for w in _weights(rng, res)]
    emb = torch.from_numpy(rng.normal(size=(B, F, D)).astype(np.float32))
    seed = torch.tensor(12345)

    def run(fn):
        e = emb.clone().requires_grad_(True)
        leaves = [None if w is None else w.clone().requires_grad_(True)
                  for w in flat]
        y = fn(e, leaves, L, H, train=True, rate=0.2, seed=seed)
        (y ** 2).sum().backward()
        return [y.detach(), e.grad] + [w.grad for w in leaves
                                       if w is not None]

    layered, stack = run(field_attention_layered), run(field_attention)
    assert not torch.equal(layered[0], run(
        lambda *a, **k: field_attention_layered(*a, **{**k, "rate": 0.0}))[0])
    for i, (a, b) in enumerate(zip(layered, stack)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6,
                                   msg=f"tensor {i}")


def test_layer_dropout_uses_the_layer_index(rng):
    """Layer l's kernel draws the stack's hash of layer l: the plain
    forward and backward with that mask, by hand."""
    x = torch.from_numpy(rng.normal(size=(5, F, A)).astype(np.float32))
    ws = [torch.from_numpy(w) for w in _weights(rng)[8:12]]
    seed = torch.tensor(3)
    dy = torch.ones(5, F, A)
    y1 = attention_layer_fwd(x, *ws, H, 1, 0.3, seed)
    y2 = attention_layer_fwd(x, *ws, H, 2, 0.3, seed)
    assert not torch.equal(y1, y2)
    assert not torch.equal(keep_mask(seed, 5, 1, H, F, 0.3),
                           keep_mask(seed, 5, 2, H, F, 0.3))
    dx, grads = attention_layer_bwd(x, dy, *ws, H, 1, 0.3, seed)
    dx_r, grads_r = attention_layer_bwd_reference(x, dy, *ws, H, 1, 0.3,
                                                  seed)
    for a, b in zip([dx] + grads, [dx_r] + grads_r):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_eval_ignores_the_rate(rng):
    flat = [torch.from_numpy(w) for w in _weights(rng)]
    emb = torch.from_numpy(rng.normal(size=(4, F, D)).astype(np.float32))
    with torch.no_grad():
        a = field_attention_layered(emb, flat, L, H, train=False, rate=0.5,
                                    seed=torch.tensor(1))
        b = field_attention_layered(emb, flat, L, H)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bad_layer_inputs_raise(rng):
    ws = [torch.from_numpy(w) for w in _weights(rng)[4:8]]
    x = torch.zeros(2, F, A)
    with pytest.raises(ValueError, match="w_out"):
        attention_layer_fwd(x, ws[0], ws[1], ws[0], ws[3], H)
    with pytest.raises(ValueError, match="heads"):
        attention_layer_fwd(x, *ws, 3)
    with pytest.raises(ValueError, match="seed"):
        attention_layer_fwd(x, *ws, H, 0, 0.2, None)
    with pytest.raises(ValueError, match="dy must be"):
        attention_layer_bwd(x, torch.zeros(3, F, A), *ws, H)

"""tpurec_torch field attention (plain version on the CPU) against the JAX
package: the FieldAttention / FieldMultiHeadAttention modules (weights
copied through tpurec_torch.convert) and the Pallas stack kernel in
interpret mode.  Tolerance atol 1e-5: float32 sums in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurec.nn.interactions import FieldAttention as JaxFieldAttention
from tpurec.nn.interactions import \
    FieldMultiHeadAttention as JaxFieldMultiHeadAttention
from tpurec.ops.attention_pallas import (field_attention_reference,
                                         fused_field_attention)
from tpurec_torch.convert import state_dict_from_flax
from tpurec_torch.nn.interactions import (FieldAttention,
                                          FieldMultiHeadAttention)
from tpurec_torch.ops.attention import field_attention

F, D, A, H, L = 7, 16, 32, 2, 3


@pytest.mark.parametrize("att_res", [True, False])
@pytest.mark.parametrize("B", [1, 5, 37])
def test_field_attention_module_matches_jax(rng, B, att_res):
    emb = rng.normal(size=(B, F, D)).astype(np.float32)
    jm = JaxFieldAttention(atten_embed_dim=A, att_layer_num=L,
                           att_head_num=H, att_res=att_res)
    params = jax.tree.map(
        np.asarray, jm.init(jax.random.PRNGKey(B), jnp.asarray(emb))["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(emb)))

    tm = FieldAttention(D, A, L, H, att_res)
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(emb)).numpy()
    assert got.shape == (B, F * A)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_field_mha_matches_jax(rng):
    x = rng.normal(size=(6, F, A)).astype(np.float32)
    jm = JaxFieldMultiHeadAttention(num_heads=H)
    params = jax.tree.map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = FieldMultiHeadAttention(A, H)
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B", [3, 36])
def test_field_attention_matches_pallas_kernel(rng, B):
    mk = lambda *s: (rng.normal(size=s) * 0.2).astype(np.float32)
    flat = [mk(D, A), mk(A), mk(D, A), mk(A)]
    for _ in range(L):
        flat += [mk(A, 3 * A), mk(3 * A), mk(A, A), mk(A)]
    emb = rng.normal(size=(B, F, D)).astype(np.float32)
    jflat = [jnp.asarray(w) for w in flat]
    want = fused_field_attention(jnp.asarray(emb), jflat, 0, L, H, 0.0,
                                 False, 16, True)
    oracle = field_attention_reference(jnp.asarray(emb), jflat, L, H)
    got = field_attention(torch.from_numpy(emb),
                          [torch.from_numpy(w) for w in flat], L, H).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=1e-5, rtol=0)


def test_field_attention_rejects_bad_shapes(rng):
    mk = lambda *s: torch.zeros(*s)
    flat = [mk(D, A), mk(A), mk(D, A), mk(A), mk(A, 3 * A), mk(3 * A),
            mk(A, A), mk(A)]
    emb = mk(2, F, D)
    with pytest.raises(ValueError, match="heads"):
        field_attention(emb, flat, 1, 3)
    with pytest.raises(ValueError, match="must hold"):
        field_attention(emb, flat, 2, H)
    with pytest.raises(ValueError, match=r"flat_w\[4\]"):
        field_attention(emb, flat[:4] + [mk(A, A)] + flat[5:], 1, H)
    with pytest.raises(ValueError, match="emb"):
        field_attention(emb.double(), flat, 1, H)

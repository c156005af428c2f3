"""The port's FeaturesLinear and activation (tpurec_torch.nn.core) against
the JAX package's (tpurec.nn.core), parameters carried across by
tpurec_torch.convert.  Tolerance 1e-6 absolute: float32 products of at
most 48 terms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurec.nn.core import FeaturesLinear as JaxFeaturesLinear
from tpurec.nn.core import activation as jax_activation
from tpurec_torch.convert import state_dict_from_flax
from tpurec_torch.nn.core import FeaturesLinear, activation

TOL = 1e-6
NAMES = ("relu", "sigmoid", "linear", "tanh", "ReLU", "Tanh")


@pytest.mark.parametrize("B,in_dim", [(1, 8), (7, 24), (64, 48)])
def test_features_linear_matches_tpurec(B, in_dim):
    rng = np.random.default_rng(B * 100 + in_dim)
    x = rng.normal(size=(B, in_dim)).astype(np.float32)
    jm = JaxFeaturesLinear()
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(B),
                                              jnp.asarray(x))["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = FeaturesLinear(in_dim)
    sd = state_dict_from_flax(params)
    assert sorted(sd) == ["fc.bias", "fc.weight"]
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", NAMES)
def test_activation_matches_tpurec(name):
    x = np.random.default_rng(0).normal(size=(5, 9)).astype(np.float32) * 4
    want = np.asarray(jax_activation(name)(jnp.asarray(x)))
    got = activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["gelu", "swish", ""])
def test_unknown_activation_raises_as_tpurec(name):
    with pytest.raises(NotImplementedError) as want:
        jax_activation(name)
    with pytest.raises(NotImplementedError) as got:
        activation(name)
    assert str(got.value) == str(want.value)

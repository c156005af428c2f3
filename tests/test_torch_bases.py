"""CDC's other base models in the port (tpurec_torch.models: PLE,
PEPNet/EPNet and their -single variants, STAR; plain versions on the CPU)
against the JAX package's, weights copied with tpurec_torch.convert.

Small widths: 5 fields of embed 4, 3 towers, attention A=8, L=1, every
model's own layers narrowed (SMALL).  Parameters are the JAX init times
(1 + 0.1 N(0, 1)), so BatchNorm and PN scales and shifts are not ones and
zeros; running statistics are random.  Tolerance 2e-5 absolute on logits
and on the running statistics a training forward leaves.  Dropout 0: the
two packages cannot share dropout bits.

The helpers here (SMALL, the paired models, the batches) serve the
training, Trainer, CDC and checkpoint tests of these models too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.models import NEEDS_GROUP as JAX_NEEDS_GROUP
from tpurec.models import build_model as jax_build_model
from tpurec.train.reg import reg_coef_tree as jax_reg_coef_tree
from tpurec_torch.config import ModelConfig
from tpurec_torch.convert import state_dict_from_flax
from tpurec_torch.models import (CDC_BASE_MODELS, MULTI_TOWER_OUTPUT,
                                 NEEDS_GROUP, build_model)
from tpurec_torch.train.reg import reg_coef_tree

FIELD_DIMS = (16, 64, 12, 8, 40)      # fields 1 and 4 big at threshold 20
DOMAIN_IDX, N_TOWER = 3, 3
NAMES = ("ple", "pepnet", "epnet", "pepnet-single", "epnet-single", "star")
BASES = ("ple", "pepnet", "epnet", "star")
COMMON = dict(embed_dim=4, atten_embed_dim=8, att_layer_num=1,
              att_head_num=2, dropout=0.0)
SMALL = {
    "ple": dict(ple_expert_dims=((16, 8), (8,)), ple_tower_dims=(8,)),
    "pepnet": dict(tower_dims=(16, 8), gate_hidden_dim=8),
    "epnet": dict(tower_dims=(16, 8), gate_hidden_dim=8),
    "star": dict(tower_dims=(16, 8)),
}
FWD_TOL = 2e-5


def small_kw(name, **over):
    """The small ModelConfig fields of model ``name``."""
    base = name.replace("-single", "")
    return {"model": name, **COMMON, **SMALL[base], **over}


def ids(rng, n, field_dims=FIELD_DIMS):
    return np.stack([rng.integers(0, d, n) for d in field_dims],
                    1).astype(np.int32)


def groups_of(x, n_tower=N_TOWER):
    return (x[:, DOMAIN_IDX] % n_tower).astype(np.int32)


def perturbed(tree, rng, scale=0.1):
    """Every float leaf times (1 + scale N(0, 1)), plus scale N(0, 1)
    where it is zero (BN and PN shifts)."""
    def one(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return a
        z = rng.normal(size=a.shape).astype(np.float32)
        return np.where(a == 0, scale * z, a * (1 + scale * z)).astype(
            np.float32)
    return jax.tree.map(one, tree)


def random_stats(tree, rng):
    """Random BN/PN running statistics: means N(0, 0.3), vars in [0.5,
    1.5]; integer counters kept."""
    def one(path, a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return a
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.3 * rng.normal(size=a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, tree)


def jax_variables(name, kw, rng, n_tower=N_TOWER, field_dims=FIELD_DIMS):
    """(tpurec model, its variables as numpy trees with perturbed params
    and random statistics)."""
    jm = jax_build_model(name, field_dims, n_tower, DOMAIN_IDX,
                         JaxModelConfig(**kw))
    x = jnp.asarray(ids(rng, 8, field_dims))
    v = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    return jm, {"params": perturbed(v["params"], rng),
                "batch_stats": random_stats(v["batch_stats"], rng)}


@functools.lru_cache(maxsize=None)
def jax_pair(name):
    """(tpurec model, its variables, its jitted eval forward (variables, x,
    group)), one per model name for this module's tests."""
    rng = np.random.default_rng(NAMES.index(name))
    jm, variables = jax_variables(name, small_kw(name), rng)
    fwd = jax.jit(functools.partial(jm.apply, train=False))
    return jm, variables, lambda v, x, group=None: fwd(v, x, group=group)


def port_model(name, kw, variables, n_tower=N_TOWER,
               field_dims=FIELD_DIMS):
    pm = build_model(name, field_dims, n_tower, DOMAIN_IDX,
                     ModelConfig(**kw), device="cpu")
    pm.load_state_dict(state_dict_from_flax(
        variables["params"], {"batch_stats": variables["batch_stats"]}),
        strict=True)
    return pm


def flat_stats(tree):
    return {k: np.asarray(v) for k, v in state_dict_from_flax(
        {}, {"batch_stats": tree}).items()}


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("name", NAMES)
def test_eval_forward_matches_tpurec(name, B):
    """train=False, with the group (the Predictor's call) and without it
    (CDC's): a 1-row batch skips the tower BatchNorms of PLE and PEPNet
    as in tpurec, and never STAR's (its mask is never None)."""
    rng = np.random.default_rng(B)
    kw = small_kw(name)
    _, variables, fwd = jax_pair(name)
    pm = port_model(name, kw, variables).eval()
    X = ids(rng, B)
    g = groups_of(X)
    for group in (g, None):
        want = np.asarray(fwd(
            variables, jnp.asarray(X),
            None if group is None else jnp.asarray(group)))
        with torch.no_grad():
            got = pm(torch.from_numpy(X), train=False,
                     group=None if group is None else torch.from_numpy(
                         group)).numpy()
            rows = pm.embedding(torch.from_numpy(X)).reshape(-1, 4)
            got_rows = pm(torch.from_numpy(X), train=False,
                          group=None if group is None else torch.from_numpy(
                              group), embed_rows=rows).numpy()
        single = name.endswith("-single")
        assert got.shape == ((B,) if single else (B, N_TOWER))
        np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)
        np.testing.assert_array_equal(got_rows, got)


@pytest.mark.parametrize("B", [1, 29])
@pytest.mark.parametrize("name", NAMES)
def test_train_forward_matches_tpurec(name, B):
    """train=True with dropout 0 and a row mask: the logits, their
    gradient with respect to the gathered rows and the running statistics
    the forward leaves.  STAR's groups include one past the towers and a
    negative one, which tpurec's one-hot leaves all zero."""
    rng = np.random.default_rng(100 + B)
    kw = small_kw(name)
    jm, variables, _ = jax_pair(name)
    pm = port_model(name, kw, variables).train()
    X = ids(rng, B)
    g = groups_of(X)
    if name == "star" and B > 2:
        g[0], g[1] = N_TOWER, -1
    mask = np.ones(B, np.float32)
    mask[B - B // 4:] = 0.0
    dy = rng.normal(size=(B,) if name.endswith("-single")
                    else (B, N_TOWER)).astype(np.float32)
    rows0 = np.asarray(variables["params"]["embedding"]["table"])[
        (X + np.asarray(pm.embedding.layout.offsets)[None]).reshape(-1)]

    def jax_fwd(rows):
        out, st = jm.apply(variables, jnp.asarray(X),
                           group=jnp.asarray(g), train=True,
                           row_mask=jnp.asarray(mask),
                           mutable=["batch_stats"],
                           rngs={"dropout": jax.random.PRNGKey(0)},
                           embed_rows=rows)
        return jnp.sum(out * dy), (out, st)

    (_, (want, st)), want_g = jax.jit(jax.value_and_grad(
        jax_fwd, has_aux=True))(jnp.asarray(rows0))
    rows = torch.from_numpy(rows0).requires_grad_(True)
    got = pm(torch.from_numpy(X), group=torch.from_numpy(g), train=True,
             row_mask=torch.from_numpy(mask), embed_rows=rows)
    (got * torch.from_numpy(dy)).sum().backward()
    for what, a, w in (("logits", got.detach().numpy(), want),
                       ("row grads", rows.grad.numpy(), want_g)):
        w = np.asarray(w)
        err = np.abs(a - w) / np.maximum(1.0, np.abs(w))
        assert err.max() <= FWD_TOL, (what, err.max())
    sd = pm.state_dict()
    for k, w in flat_stats(st["batch_stats"]).items():
        np.testing.assert_allclose(sd[k].numpy(), w, atol=FWD_TOL, rtol=0,
                                   err_msg=k)


def test_star_without_group_normalises_over_the_batch():
    """group=None (CDC's call) takes every row into every tower's
    statistics, as tpurec's ones(B, T)."""
    rng = np.random.default_rng(2)
    kw = small_kw("star")
    jm, variables, _ = jax_pair("star")
    pm = port_model("star", kw, variables).train()
    X = ids(rng, 23)
    mask = np.ones(23, np.float32)
    mask[-3:] = 0.0
    want, st = jm.apply(variables, jnp.asarray(X), train=True,
                        row_mask=jnp.asarray(mask), mutable=["batch_stats"],
                        rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = pm(torch.from_numpy(X), train=True,
                 row_mask=torch.from_numpy(mask))
        grouped = pm(torch.from_numpy(X), group=torch.from_numpy(
            groups_of(X)), train=True, row_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=0)
    assert not np.allclose(grouped.numpy(), got.numpy(), atol=1e-3)
    pm2 = port_model("star", kw, variables).train()
    with torch.no_grad():
        pm2(torch.from_numpy(X), train=True, row_mask=torch.from_numpy(mask))
    sd = pm2.state_dict()
    for k, w in flat_stats(st["batch_stats"]).items():
        np.testing.assert_allclose(sd[k].numpy(), w, atol=FWD_TOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_reg_coefs_match_tpurec(name):
    """The L2 map: reg_coef_tree's coefficients, name for name, as the JAX
    package's (its nonzero set included)."""
    kw = small_kw(name)
    _, variables, _ = jax_pair(name)
    want = {k: float(v) for k, v in state_dict_from_flax(
        jax_reg_coef_tree(variables["params"], name, 1.0, 2.0,
                          3.0)).items()}
    pm = build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                     ModelConfig(**kw), device="cpu")
    got = reg_coef_tree([n for n, _ in pm.named_parameters()], name,
                        1.0, 2.0, 3.0)
    assert got == want
    assert {k for k, c in got.items() if c} == {k for k, c in want.items()
                                                if c}
    assert sum(c == 3.0 for c in got.values()) >= 2


@pytest.mark.parametrize("share", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_state_dict_is_the_flax_tree(name, share):
    """Keys and shapes are the flax paths' (PN's two-leaf batch_stats,
    [T, C] BatchNorm statistics, bias-free banks, STAR's raw parameters),
    on the CPU and in a "meta" build; PEPNet with and without shared
    tower weights."""
    kw = small_kw(name, pepnet_share_tower_weights=share)
    jm = jax_build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                         JaxModelConfig(**kw))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((4, 5), jnp.int32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = {k: tuple(v.shape) for k, v in state_dict_from_flax(
        zeros["params"], {"batch_stats": zeros["batch_stats"]}).items()}
    for device in ("cpu", "meta"):
        pm = build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                         ModelConfig(**kw), device=device)
        assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} \
            == want, device


def test_seeded_init_and_registry():
    """One seed gives one set of weights (STAR's raw parameters and PN
    included); the registry's sets are tpurec's."""
    from tpurec.models import CDC_BASE_MODELS as JAX_CDC
    from tpurec.models import MULTI_TOWER_OUTPUT as JAX_MULTI

    assert NEEDS_GROUP == JAX_NEEDS_GROUP
    assert MULTI_TOWER_OUTPUT == JAX_MULTI and CDC_BASE_MODELS == JAX_CDC
    for name in NAMES:
        cfg = ModelConfig(**small_kw(name))
        a, b = (build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX, cfg,
                            device="cpu",
                            generator=torch.Generator().manual_seed(5)
                            ).state_dict() for _ in range(2))
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
    sd = build_model("star", FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                     ModelConfig(**small_kw("star")), device="cpu",
                     generator=torch.Generator().manual_seed(5)).state_dict()
    bound = 1 / np.sqrt(5 * 4)                     # fan_in of layer 0
    for k in ("domain_w_0", "shared_w_0", "domain_b_0", "shared_b_0"):
        assert 0.5 * bound < sd[k].abs().max() <= bound, k
    assert torch.all(sd["pn.weight"] == 1) and torch.all(sd["pn.bias"] == 0)
    assert torch.all(sd["pn.var"] == 1) and "pn.num_batches_tracked" not in sd


@pytest.mark.parametrize("use_bn", [True, False])
def test_stacked_mlp_use_bn_matches_tpurec(use_bn):
    """StackedMLP with and without BatchNorm (no ``bn_i`` module or key
    without it), eval and training forwards against tpurec's."""
    from tpurec.nn.core import StackedMLP as JaxStackedMLP
    from tpurec_torch.nn.core import StackedMLP

    rng = np.random.default_rng(4)
    x = rng.normal(size=(9, 12)).astype(np.float32)
    jm = JaxStackedMLP(3, (16, 8), use_bn=use_bn)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    stats = {k: random_stats(c, rng) for k, c in v.items() if k != "params"}
    variables = {"params": perturbed(v["params"], rng), **stats}
    tm = StackedMLP(3, 12, (16, 8), use_bn=use_bn)
    tm.load_state_dict(state_dict_from_flax(variables["params"], stats),
                       strict=True)
    assert any(k.startswith("bn_") for k in tm.state_dict()) == use_bn
    for train in (False, True):
        want = jm.apply(variables, jnp.asarray(x), train=train,
                        mutable=["batch_stats"] if train else False)
        want = np.asarray(want[0] if train else want)
        got = tm(torch.from_numpy(x), train=train).detach().numpy()
        np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)

"""The group-routed models in the port (tpurec_torch.models: HiNet, ADL for
``adl`` and ``adl-split``, AdaSparse; plain versions on the CPU) against
the JAX package's, weights and collections copied with
tpurec_torch.convert.

Small widths: 5 fields of embed 4, 3 towers, attention A=8, L=1, each
model's own layers narrowed (SMALL).  Parameters are the JAX init times
(1 + 0.1 N(0, 1)), AdaSparse's pruner weights times PRUNER_SCALE too, and
BatchNorm running statistics are random; ADL's cluster centres keep
their N(0, 1) draw.  Tolerance 2e-5 of max(1, |x|) on logits, their
gradient with respect to the gathered rows, the running statistics and
ADL's centres after a training forward.  Dropout 0: the
two packages cannot share dropout bits.

ADL routes by an argmax of a softmax; AdaSparse prunes where
``|pi| <= epsilon``.  A value within rounding of a tie or of the
threshold could take the other branch in the other package: each test
asserts the two packages' branches are the same (the routing, the
pruner masks) before it compares numbers, so a flip reads as a flip.

The helpers here serve tests/test_torch_routed_train.py and
tests/test_torch_bf16.py too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bases import (DOMAIN_IDX, FIELD_DIMS, N_TOWER, ids,
                              perturbed, random_stats)
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.models import build_model as jax_build_model
from tpurec.train.reg import reg_coef_tree as jax_reg_coef_tree
from tpurec_torch.config import ModelConfig
from tpurec_torch.convert import state_dict_from_flax
from tpurec_torch.models import (MODEL_REGISTRY, MULTI_TOWER_OUTPUT,
                                 NEEDS_GROUP, build_model)
from tpurec_torch.train.reg import reg_coef_tree

ROUTED = ("hinet", "adl", "adl-split", "adasparse")
COMMON = dict(embed_dim=4, atten_embed_dim=8, att_layer_num=1,
              att_head_num=2, dropout=0.0)
SMALL = {
    "hinet": dict(sei_dims=(8, 4), sei_expert_num=2, tower_dims=(16, 8)),
    "adl": dict(tower_dims=(16, 8)),
    "adl-split": dict(tower_dims=(16, 8)),
    "adasparse": dict(mlp_dims=(16, 8)),
}
TOL = 2e-5
# AdaSparse's pruner weights are scaled by this, so that about a tenth of
# the pruner's outputs fall under epsilon at these widths (none would at
# the init's scale) and the threshold is on every test's path
PRUNER_SCALE = 4.0


def routed_kw(name, **over):
    return {"model": name, **COMMON, **SMALL[name], **over}


def groups_of(x):
    return (x[:, DOMAIN_IDX] % N_TOWER).astype(np.int32)


def collections_of(variables):
    """The model collections (batch_stats, and ADL's adl_state)."""
    return {k: v for k, v in variables.items() if k != "params"}


def jax_variables(name, kw, rng):
    """(tpurec model, its variables as numpy trees: perturbed params,
    random BN statistics, ADL's centres as drawn)."""
    jm = jax_build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                         JaxModelConfig(**kw))
    x = jnp.asarray(ids(rng, 8))
    v = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    out = {"params": perturbed(v["params"], rng),
           "batch_stats": random_stats(v.get("batch_stats", {}), rng)}
    if "adl_state" in v:
        out["adl_state"] = v["adl_state"]
    for k, layer in out["params"].items():
        if k.startswith("pruner_"):          # AdaSparse: prune some
            layer["weight"] = layer["weight"] * PRUNER_SCALE
    return jm, out


@functools.lru_cache(maxsize=None)
def jax_pair(name):
    """(tpurec model, its variables), one per model name."""
    return jax_variables(name, routed_kw(name),
                         np.random.default_rng(ROUTED.index(name)))


def port_model(name, kw, variables):
    pm = build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                     ModelConfig(**kw), device="cpu")
    pm.load_state_dict(state_dict_from_flax(
        variables["params"], collections_of(variables)), strict=True)
    return pm


def flat(tree):
    return {k: np.asarray(v) for k, v in state_dict_from_flax(
        {}, tree).items()}


def rel_err(a, w):
    a, w = np.asarray(a), np.asarray(w)
    return float((np.abs(a - w) / np.maximum(1.0, np.abs(w))).max())


def jax_routing(variables, X):
    """ADL's routing in tpurec's arithmetic: argmax of the softmax of the
    rows' flat embeddings against the centres."""
    table = np.asarray(variables["params"]["embedding"]["table"])
    from tpurec.nn.core import EmbeddingLayout

    off = EmbeddingLayout(FIELD_DIMS).offsets
    flat_x = jnp.asarray(table[X + off[None]].reshape(X.shape[0], -1))
    c = jnp.asarray(variables["adl_state"]["cluster_centers"])
    sims = jnp.einsum("bd,td->bt", flat_x, c,
                      preferred_element_type=jnp.float32)
    return np.asarray(jnp.argmax(jax.nn.softmax(sims, axis=1), axis=1))


def port_routing(pm, X):
    with torch.no_grad():
        f = pm.embedding(torch.from_numpy(X)).reshape(X.shape[0], -1)
        return torch.argmax(torch.softmax(f @ pm.cluster_centers.T, dim=1),
                            dim=1).numpy()


def check_routing(name, pm, variables, X):
    if name.startswith("adl"):
        np.testing.assert_array_equal(port_routing(pm, X),
                                      jax_routing(variables, X))


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("name", ROUTED)
def test_eval_forward_matches_tpurec(name, B):
    """train=False with the group, without it (HiNet takes tower 0, as
    tpurec's zeros) and with groups outside [0, T) (a one-hot of zeros);
    the gathered-rows path equals the table's."""
    rng = np.random.default_rng(B)
    jm, variables = jax_pair(name)
    pm = port_model(name, routed_kw(name), variables).eval()
    fwd = jax.jit(functools.partial(jm.apply, train=False))
    X = ids(rng, B)
    g = groups_of(X)
    if B > 2:
        g[0], g[1] = N_TOWER, -1
    check_routing(name, pm, variables, X)
    for group in (g, None):
        want = np.asarray(fwd(variables, jnp.asarray(X),
                              group=None if group is None
                              else jnp.asarray(group)))
        with torch.no_grad():
            tg = None if group is None else torch.from_numpy(group)
            got = pm(torch.from_numpy(X), group=tg).numpy()
            rows = pm.embedding(torch.from_numpy(X)).reshape(-1, 4)
            got_rows = pm(torch.from_numpy(X), group=tg,
                          embed_rows=rows).numpy()
        assert got.shape == (B,)
        assert rel_err(got, want) <= TOL
        np.testing.assert_array_equal(got_rows, got)
    if name == "hinet":                   # the group selects features
        with torch.no_grad():
            x = torch.from_numpy(X)
            a = pm(x, group=torch.zeros(B, dtype=torch.int32))
            b = pm(x, group=torch.ones(B, dtype=torch.int32))
        assert not torch.allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("B", [1, 29])
@pytest.mark.parametrize("name", ROUTED)
def test_train_forward_matches_tpurec(name, B):
    """train=True with dropout 0 and a row mask (the last quarter padded):
    the logits, their gradient with respect to the gathered rows, and the
    collections the forward leaves (BatchNorm statistics; ADL's centres,
    moved in place from every row, padded ones included)."""
    rng = np.random.default_rng(100 + B)
    jm, variables = jax_pair(name)
    pm = port_model(name, routed_kw(name), variables).train()
    X = ids(rng, B)
    g = groups_of(X)
    if name == "hinet" and B > 2:
        g[0], g[1] = N_TOWER, -1
    mask = np.ones(B, np.float32)
    mask[B - B // 4:] = 0.0
    dy = rng.normal(size=(B,)).astype(np.float32)
    rows0 = np.asarray(variables["params"]["embedding"]["table"])[
        (X + np.asarray(pm.embedding.layout.offsets)[None]).reshape(-1)]
    check_routing(name, pm, variables, X)
    mutable = list(collections_of(variables))

    def jax_fwd(rows):
        out, st = jm.apply(variables, jnp.asarray(X), group=jnp.asarray(g),
                           train=True, row_mask=jnp.asarray(mask),
                           mutable=mutable,
                           rngs={"dropout": jax.random.PRNGKey(0)},
                           embed_rows=rows)
        return jnp.sum(out * dy), (out, st)

    (_, (want, st)), want_g = jax.jit(jax.value_and_grad(
        jax_fwd, has_aux=True))(jnp.asarray(rows0))
    rows = torch.from_numpy(rows0).requires_grad_(True)
    got = pm(torch.from_numpy(X), group=torch.from_numpy(g), train=True,
             row_mask=torch.from_numpy(mask), embed_rows=rows)
    (got * torch.from_numpy(dy)).sum().backward()
    assert rel_err(got.detach().numpy(), want) <= TOL
    assert rel_err(rows.grad.numpy(), want_g) <= TOL
    sd = pm.state_dict()
    want_state = flat(jax.tree.map(np.asarray, st))
    assert set(want_state) <= set(sd)
    for k, w in want_state.items():
        assert rel_err(sd[k].numpy(), w) <= TOL, k
    if name.startswith("adl"):
        c0 = variables["adl_state"]["cluster_centers"]
        assert not np.allclose(sd["cluster_centers"].numpy(), c0)
        assert "cluster_centers" in want_state


@pytest.mark.parametrize("name", ["adl", "adl-split"])
def test_adl_centres_read_padded_rows_and_eval_keeps_them(name):
    """tpurec's centre update sums over every row of the batch, padded
    ones included: the port's centres after a training forward equal
    tpurec's, and differ from the centres of the unpadded rows alone.
    Eval leaves them where they are."""
    rng = np.random.default_rng(7)
    jm, variables = jax_pair(name)
    X = ids(rng, 24)
    mask = np.ones(24, np.float32)
    mask[16:] = 0.0
    _, st = jm.apply(variables, jnp.asarray(X), train=True,
                     row_mask=jnp.asarray(mask),
                     mutable=list(collections_of(variables)),
                     rngs={"dropout": jax.random.PRNGKey(0)})
    want = np.asarray(st["adl_state"]["cluster_centers"])
    pm = port_model(name, routed_kw(name), variables)
    with torch.no_grad():
        pm(torch.from_numpy(X), train=False)
        np.testing.assert_array_equal(
            pm.cluster_centers.numpy(),
            variables["adl_state"]["cluster_centers"])
        pm(torch.from_numpy(X), train=True, row_mask=torch.from_numpy(mask))
    assert rel_err(pm.cluster_centers.numpy(), want) <= TOL
    norms = np.linalg.norm(pm.cluster_centers.numpy(), axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-6)
    alone = port_model(name, routed_kw(name), variables)
    with torch.no_grad():
        alone(torch.from_numpy(X[:16]), train=True)
    assert np.abs(alone.cluster_centers.numpy() - want).max() > 1e-4


def test_adasparse_prunes_as_tpurec():
    """The pruner's masks (|pi| <= epsilon) are the same in both packages
    and prune some entries, so the threshold is on the path."""
    rng = np.random.default_rng(3)
    jm, variables = jax_pair("adasparse")
    pm = port_model("adasparse", routed_kw("adasparse"), variables).eval()
    X = ids(rng, 64)
    cfg = pm.cfg
    with torch.no_grad():
        f, emb = pm.embed(torch.from_numpy(X))
        z = pm.pruner_0(torch.cat([f, emb[:, DOMAIN_IDX]], dim=-1))
        pi = cfg.adasparse_beta * torch.sigmoid(cfg.adasparse_alpha * z)
    jw = variables["params"]["pruner_0"]
    fj = np.asarray(f)
    zj = np.concatenate([fj, fj.reshape(64, -1, 4)[:, DOMAIN_IDX]], 1) \
        @ np.asarray(jw["weight"]) + np.asarray(jw["bias"])
    pij = cfg.adasparse_beta / (1 + np.exp(-cfg.adasparse_alpha * zj))
    pruned = pi.abs().numpy() <= cfg.adasparse_epsilon
    np.testing.assert_array_equal(pruned, np.abs(pij) <= cfg.adasparse_epsilon)
    assert 0 < pruned.mean() < 1


@pytest.mark.parametrize("name", ROUTED)
def test_reg_coefs_match_tpurec(name):
    """The L2 map, name for name, as tpurec's reg_coef_tree; ADL's centre
    buffer is no parameter, so it takes no L2 and no Adam."""
    _, variables = jax_pair(name)
    want = {k: float(v) for k, v in state_dict_from_flax(
        jax_reg_coef_tree(variables["params"], name, 1.0, 2.0,
                          3.0)).items()}
    pm = build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                     ModelConfig(**routed_kw(name)), device="cpu")
    names = [n for n, _ in pm.named_parameters()]
    got = reg_coef_tree(names, name, 1.0, 2.0, 3.0)
    assert got == want
    assert sum(c == 3.0 for c in got.values()) >= 2
    assert "cluster_centers" not in names


@pytest.mark.parametrize("name", ROUTED)
def test_state_dict_is_the_flax_tree(name):
    """Keys and shapes are the flax paths' of params and every collection
    (ADL's adl_state included), on the CPU and in a "meta" build."""
    kw = routed_kw(name)
    jm = jax_build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                         JaxModelConfig(**kw))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((4, 5), jnp.int32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = {k: tuple(v.shape) for k, v in state_dict_from_flax(
        zeros["params"], collections_of(zeros)).items()}
    assert ("adl_state" in zeros) == name.startswith("adl")
    for device in ("cpu", "meta"):
        pm = build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                         ModelConfig(**kw), device=device)
        assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} \
            == want, device


def test_seeded_init_and_registry():
    """One seed gives one set of weights; AdaSparse's layer weights are
    N(0, 1e-4**2) and ADL's centres N(0, 1); the registry builds the four
    names among every name of tpurec's, and without a card raises unless
    asked for the CPU."""
    from tpurec.models import MODEL_REGISTRY as JAX_REGISTRY
    from tpurec.models import MULTI_TOWER_OUTPUT as JAX_MULTI
    from tpurec.models import NEEDS_GROUP as JAX_NEEDS

    assert MULTI_TOWER_OUTPUT == JAX_MULTI and NEEDS_GROUP == JAX_NEEDS
    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY)
    assert set(ROUTED) <= set(MODEL_REGISTRY)
    for name in ROUTED:
        cfg = ModelConfig(**routed_kw(name))
        a, b = (build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX, cfg,
                            device="cpu",
                            generator=torch.Generator().manual_seed(5)
                            ).state_dict() for _ in range(2))
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX, cfg)
    big = dict(routed_kw("adasparse"), mlp_dims=(256,))
    sd = build_model("adasparse", FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                     ModelConfig(**big), device="cpu").state_dict()
    assert 0.8e-4 < float(sd["linear_w_0"].std()) < 1.2e-4
    bound = 1 / np.sqrt(5 * 4)
    assert 0.5 * bound < float(sd["linear_b_0"].abs().max()) <= bound
    big = dict(routed_kw("adl"), tower_dims=(8,))
    sd = build_model("adl", (4000,) * 5, 64, DOMAIN_IDX, ModelConfig(**big),
                     device="cpu").state_dict()
    assert 0.9 < float(sd["cluster_centers"].std()) < 1.1

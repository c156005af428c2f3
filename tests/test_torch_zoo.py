"""The rest of the zoo in the port (tpurec_torch.models: DeepFM, DCNv2,
AutoInt, xDeepFM, IPNN/OPNN, AFM, and their interactions in
tpurec_torch.nn.interactions; plain versions on the CPU) against the JAX
package's, weights and statistics copied with tpurec_torch.convert.

Small widths: 5 fields of embed 4, MLPs (16, 8), attention A=8, L=2, H=2,
2 cross layers, DCNv2's mixture of 2 experts of rank 3, CIN (6, 4), AFM
attention 5.  Parameters are the JAX init times (1 + 0.1 N(0, 1)), and
BatchNorm running statistics are random.  Dropout 0 and
``afm_dropouts=(0, 0)``: the two packages cannot share dropout bits.

Tolerance (TOL): 2e-5 of max(1, |x|) on every output, its gradient with
respect to the input (the interactions) or the gathered rows (the
models), and the running statistics a training forward leaves.  Measured
on the CPU: at most 9.5e-7 (the interactions, Anova at order 3) and
5.5e-7 (the models, DeepFM the largest), float32 sums taken in another
order.

The helpers here (ZOO, the variants, the paired models) serve
tests/test_torch_zoo_train.py, tests/test_torch_zoo_trainer.py and
tests/test_torch_zoo_bf16.py too.
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
from tpurec.models import MODEL_REGISTRY as JAX_REGISTRY
from tpurec.models import build_model as jax_build_model
from tpurec.nn import interactions as jax_ix
from tpurec.train.reg import reg_coef_tree as jax_reg_coef_tree
from tpurec_torch.config import ModelConfig
from tpurec_torch.convert import state_dict_from_flax
from tpurec_torch.models import (MODEL_REGISTRY, MULTI_TOWER_OUTPUT,
                                 build_model)
from tpurec_torch.nn import interactions as ix
from tpurec_torch.train.reg import reg_coef_tree

ZOO = ("deepfm", "dcnv2", "autoint", "xdeepfm", "ipnn", "opnn", "afm")
COMMON = dict(embed_dim=4, mlp_dims=(16, 8), atten_embed_dim=8,
              att_layer_num=2, att_head_num=2, n_cross_layers=2,
              dcnv2_low_rank=3, dcnv2_num_experts=2, cin_layer_sizes=(6, 4),
              afm_attn_size=5, afm_dropouts=(0.0, 0.0), dropout=0.0)
# variant -> (registry name, its ModelConfig fields beyond COMMON)
VARIANTS = {
    "deepfm": ("deepfm", {}),
    "dcnv2": ("dcnv2", {}),
    "dcnv2-stacked": ("dcnv2", dict(dcnv2_structure="stacked")),
    "dcnv2-crossnet_only": ("dcnv2", dict(dcnv2_structure="crossnet_only")),
    "dcnv2-v2": ("dcnv2", dict(dcnv2_use_low_rank_mixture=False)),
    "dcnv2-v2-stacked": ("dcnv2", dict(dcnv2_use_low_rank_mixture=False,
                                       dcnv2_structure="stacked")),
    "dcnv2-v2-crossnet_only": ("dcnv2", dict(
        dcnv2_use_low_rank_mixture=False, dcnv2_structure="crossnet_only")),
    "autoint": ("autoint", {}),
    "autoint-nores": ("autoint", dict(att_res=False)),
    "xdeepfm": ("xdeepfm", {}),
    "ipnn": ("ipnn", {}),
    "opnn": ("opnn", {}),
    "afm": ("afm", {}),
}
TOL = 2e-5


def zoo_kw(variant, **over):
    """The small ModelConfig fields of a variant."""
    name, extra = VARIANTS[variant]
    return {"model": name, **COMMON, **extra, **over}


def rel_err(a, w):
    a, w = np.asarray(a), np.asarray(w)
    return float((np.abs(a - w) / np.maximum(1.0, np.abs(w))).max())


def flat(tree):
    return {k: np.asarray(v) for k, v in state_dict_from_flax(
        {}, tree).items()}


def jax_variables(variant, rng, kw=None):
    """(tpurec model, its variables as numpy trees: perturbed params,
    random BN statistics)."""
    kw = kw or zoo_kw(variant)
    jm = jax_build_model(kw["model"], FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                         JaxModelConfig(**kw))
    v = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(ids(rng, 8))))
    return jm, {"params": perturbed(v["params"], rng),
                "batch_stats": random_stats(v.get("batch_stats", {}), rng)}


@functools.lru_cache(maxsize=None)
def jax_pair(variant):
    """(tpurec model, its variables), one per variant."""
    return jax_variables(variant, np.random.default_rng(
        list(VARIANTS).index(variant)))


def port_model(variant, variables, kw=None):
    kw = kw or zoo_kw(variant)
    pm = build_model(kw["model"], FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                     ModelConfig(**kw), device="cpu")
    pm.load_state_dict(state_dict_from_flax(
        variables["params"], {"batch_stats": variables["batch_stats"]}),
        strict=True)
    return pm


# -- the interactions -------------------------------------------------------

B, F, D = 9, 5, 4
# case -> (tpurec module, the port's module, input [B, F, D] or [B, F*D])
INTERACTIONS = {
    "fm": (lambda: jax_ix.FactorizationMachine(),
           lambda: ix.FactorizationMachine(), 3),
    "fm-vector": (lambda: jax_ix.FactorizationMachine(reduce_sum=False),
                  lambda: ix.FactorizationMachine(reduce_sum=False), 3),
    "crossnetv2": (lambda: jax_ix.CrossNetV2(3),
                   lambda: ix.CrossNetV2(F * D, 3), 2),
    "crossnetmix": (lambda: jax_ix.CrossNetMix(3, low_rank=3, num_experts=2),
                    lambda: ix.CrossNetMix(F * D, 3, 3, 2), 2),
    "ipn": (lambda: jax_ix.InnerProductNetwork(),
            lambda: ix.InnerProductNetwork(), 3),
    **{f"opn-{k}": (functools.partial(jax_ix.OuterProductNetwork, F, D, k),
                    functools.partial(ix.OuterProductNetwork, F, D, k), 3)
       for k in ("mat", "vec", "num")},
    "afm": (lambda: jax_ix.AttentionalFactorizationMachine(5, (0.0, 0.0)),
            lambda: ix.AttentionalFactorizationMachine(D, 5, (0.0, 0.0)), 3),
    "cin-split": (lambda: jax_ix.CompressedInteractionNetwork(F, (6, 4, 2)),
                  lambda: ix.CompressedInteractionNetwork(F, (6, 4, 2)), 3),
    "cin-nosplit": (lambda: jax_ix.CompressedInteractionNetwork(
        F, (6, 3), split_half=False),
        lambda: ix.CompressedInteractionNetwork(F, (6, 3), False), 3),
    **{f"anova-{t}-{r}": (
        functools.partial(jax_ix.AnovaKernel, t, r),
        functools.partial(ix.AnovaKernel, t, r), 3)
       for t in (2, 3) for r in (True, False)},
}


@pytest.mark.parametrize("case", list(INTERACTIONS))
def test_interaction_matches_tpurec(case):
    """The forward and the gradient of sum(out * dy) with respect to the
    input, from the same (perturbed) parameters."""
    make_jax, make_port, ndim = INTERACTIONS[case]
    rng = np.random.default_rng(list(INTERACTIONS).index(case))
    x = rng.normal(size=(B, F, D) if ndim == 3 else (B, F * D)).astype(
        np.float32)
    jmod = make_jax()
    v = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = perturbed(jax.tree.map(np.asarray, v.get("params", {})), rng)
    pmod = make_port()
    pmod.load_state_dict(state_dict_from_flax(params), strict=True)
    fwd = jax.jit(lambda p, a: jmod.apply({"params": p}, a))
    y0 = fwd(params, jnp.asarray(x))
    dy = rng.normal(size=y0.shape).astype(np.float32)
    want_g = jax.jit(jax.grad(lambda a: jnp.sum(fwd(params, a) * dy)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pmod(xt)
    (got * torch.from_numpy(dy)).sum().backward()
    assert tuple(got.shape) == y0.shape
    assert rel_err(got.detach().numpy(), y0) <= TOL
    assert rel_err(xt.grad.numpy(), want_g) <= TOL


# -- the models ---------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eval_forward_matches_tpurec(variant):
    """train=False at B = 1 and 37; the gathered-rows path equals the
    table's."""
    jm, variables = jax_pair(variant)
    pm = port_model(variant, variables).eval()
    fwd = jax.jit(functools.partial(jm.apply, train=False))
    rng = np.random.default_rng(5)
    for n in (1, 37):
        X = ids(rng, n)
        g = (X[:, DOMAIN_IDX] % N_TOWER).astype(np.int32)
        want = np.asarray(fwd(variables, jnp.asarray(X),
                              group=jnp.asarray(g)))
        with torch.no_grad():
            x = torch.from_numpy(X)
            got = pm(x, group=torch.from_numpy(g)).numpy()
            rows = pm.embedding(x).reshape(-1, 4)
            got_rows = pm(x, group=torch.from_numpy(g),
                          embed_rows=rows).numpy()
        assert got.shape == (n,)
        assert rel_err(got, want) <= TOL, n
        np.testing.assert_array_equal(got_rows, got)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_forward_matches_tpurec(variant):
    """train=True with dropout 0 and a row mask (the last quarter padded):
    the logits, their gradient with respect to the gathered rows, and the
    BatchNorm statistics the forward leaves."""
    n = 29
    rng = np.random.default_rng(100)
    jm, variables = jax_pair(variant)
    pm = port_model(variant, variables).train()
    X = ids(rng, n)
    mask = np.ones(n, np.float32)
    mask[n - n // 4:] = 0.0
    dy = rng.normal(size=(n,)).astype(np.float32)
    rows0 = np.asarray(variables["params"]["embedding"]["table"])[
        (X + np.asarray(pm.embedding.layout.offsets)[None]).reshape(-1)]

    def jax_fwd(rows):
        out, st = jm.apply(variables, jnp.asarray(X), train=True,
                           row_mask=jnp.asarray(mask),
                           mutable=["batch_stats"],
                           rngs={"dropout": jax.random.PRNGKey(0)},
                           embed_rows=rows)
        return jnp.sum(out * dy), (out, st)

    (_, (want, st)), want_g = jax.jit(jax.value_and_grad(
        jax_fwd, has_aux=True))(jnp.asarray(rows0))
    rows = torch.from_numpy(rows0).requires_grad_(True)
    got = pm(torch.from_numpy(X), train=True,
             row_mask=torch.from_numpy(mask), embed_rows=rows)
    (got * torch.from_numpy(dy)).sum().backward()
    assert rel_err(got.detach().numpy(), want) <= TOL
    assert rel_err(rows.grad.numpy(), want_g) <= TOL
    assert np.abs(rows.grad.numpy()).max() > 0
    sd = pm.state_dict()
    want_state = flat(jax.tree.map(np.asarray, st))
    assert set(want_state) <= set(sd)
    for k, w in want_state.items():
        assert rel_err(sd[k].numpy(), w) <= TOL, k


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_state_dict_is_the_flax_tree(variant):
    """Keys and shapes are the flax paths' of params and batch_stats, on
    the CPU and in a "meta" build."""
    kw = zoo_kw(variant)
    jm = jax_build_model(kw["model"], FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                         JaxModelConfig(**kw))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((4, 5), jnp.int32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = {k: tuple(v.shape) for k, v in state_dict_from_flax(
        zeros["params"], {k: v for k, v in zeros.items()
                          if k != "params"}).items()}
    for device in ("cpu", "meta"):
        pm = build_model(kw["model"], FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                         ModelConfig(**kw), device=device)
        assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} \
            == want, device


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_reg_coefs_match_tpurec(variant):
    """The L2 map, name for name, as tpurec's reg_coef_tree (DCNv2's
    ``gating`` and ``bias_i`` take none)."""
    kw = zoo_kw(variant)
    name = kw["model"]
    _, variables = jax_pair(variant)
    want = {k: float(v) for k, v in state_dict_from_flax(
        jax_reg_coef_tree(variables["params"], name, 1.0, 2.0,
                          3.0)).items()}
    pm = build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                     ModelConfig(**kw), device="cpu")
    got = reg_coef_tree([n for n, _ in pm.named_parameters()], name, 1.0,
                        2.0, 3.0)
    assert got == want
    assert got["embedding.table"] == 1.0
    assert got.get("linear.weight", 2.0) == 2.0
    assert sum(c == 3.0 for c in got.values()) >= 1
    if name == "dcnv2" and kw.get("dcnv2_use_low_rank_mixture", True):
        assert got["crossnet.gating"] == 0.0
        assert got["crossnet.bias_0"] == 0.0
        assert got["crossnet.u_1"] == 3.0


def test_init_statistics():
    """One seed gives one set of weights; the inits' laws at widths where
    a draw's statistics are sharp: CrossNetMix's u/v/c xavier-normal per
    expert slice, its gating and CrossNetV2's w torch-Linear bounds, the
    "mat" kernel's 3-D xavier-uniform fans, CIN's fan-in bounds."""
    gen = torch.Generator().manual_seed(3)
    mix = ix.CrossNetMix(400, 2, 32, 4)
    v2 = ix.CrossNetV2(400, 2)
    opn = ix.OuterProductNetwork(23, 16, "mat")
    vec = ix.OuterProductNetwork(23, 16, "vec")
    cin = ix.CompressedInteractionNetwork(23, (128, 128))
    for m in (mix, v2, opn, vec, cin):
        m.reset_parameters(gen)
    with torch.no_grad():
        assert float(mix.u_0.std()) == pytest.approx(np.sqrt(2 / 432),
                                                     rel=0.02)
        assert float(mix.c_1.std()) == pytest.approx(np.sqrt(2 / 64),
                                                     rel=0.05)
    for w, bound in ((mix.gating, 1 / 20), (v2.w_0, 1 / 20),
                     (opn.kernel, np.sqrt(6 / (253 * 16 + 16 * 16))),
                     (vec.kernel, np.sqrt(6 / (253 + 16))),
                     (cin.conv_w_1, 1 / np.sqrt(23 * 64)),
                     (cin.conv_b_0, 1 / np.sqrt(23 * 23))):
        top = float(w.detach().abs().max())
        assert 0.9 * bound < top <= bound
    assert torch.all(mix.bias_1 == 0) and torch.all(v2.b_0 == 0)
    assert cin.output_dim == 64 + 128
    for name in ZOO:
        cfg = ModelConfig(**zoo_kw(name))
        a, b = (build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX, cfg,
                            device="cpu",
                            generator=torch.Generator().manual_seed(5)
                            ).state_dict() for _ in range(2))
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)


def test_registry_is_tpurecs():
    """build_model builds every name of tpurec's registry, the seven of
    this slice single-head; without a card it raises unless asked for the
    CPU; an odd CIN layer under split_half and an unknown OPN kernel or
    DCNv2 structure raise as tpurec's do."""
    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY)
    for name in ZOO:
        assert name not in MULTI_TOWER_OUTPUT
        cfg = ModelConfig(**zoo_kw(name))
        pm = build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX, cfg,
                         device="cpu").eval()
        with torch.no_grad():
            assert pm(torch.from_numpy(ids(np.random.default_rng(0), 3))
                      ).shape == (3,)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX, cfg)
    with pytest.raises(ValueError, match="even"):
        ix.CompressedInteractionNetwork(5, (5, 4))
    with pytest.raises(ValueError, match="kernel type"):
        ix.OuterProductNetwork(5, 4, "nope")
    with pytest.raises(ValueError, match="structure"):
        build_model("dcnv2", FIELD_DIMS, 1, DOMAIN_IDX, ModelConfig(
            **zoo_kw("dcnv2", dcnv2_structure="nope")), device="cpu")
    assert isinstance(build_model("opnn", FIELD_DIMS, 1, DOMAIN_IDX,
                                  ModelConfig(**zoo_kw("opnn")),
                                  device="cpu").product,
                      ix.OuterProductNetwork)
    assert isinstance(build_model("ipnn", FIELD_DIMS, 1, DOMAIN_IDX,
                                  ModelConfig(**zoo_kw("ipnn")),
                                  device="cpu").product,
                      ix.InnerProductNetwork)

"""bf16 compute in the port (tpurec_torch.nn.precision and its scope at
every entry point; plain versions on the CPU) against the JAX package's
``compute_dtype="bfloat16"``.

- ``cast_operands`` rounds to bfloat16 and back on every device, as the
  JAX package's CPU branch does: values and gradients bitwise equal to
  tpurec's (the backward rounds each cotangent at the cast).
- ``Linear`` and ``StackedLinear`` under the scope: outputs and
  gradients within 1e-6 of tpurec's (both round the same operands; the
  products differ by float32 summation order alone), and apart from
  their float32 results.
- The scope is per context: another thread sees its own, a nested
  scope restores the outer one, and the backward of a forward run under
  the scope rounds where the forward cast, outside the ``with``.
- Every ported model with ``use_atten=False`` (the training forward and
  the row gradient) against tpurec in bf16: the logits at
  BF16_TOL, the row gradient at BF16_GRAD_TOL of its largest.  A float32
  value whose last bit differs between the two packages' summation
  orders can round to the neighbouring bf16 value, 2**-8 of it apart;
  each limit is about four times the largest such gap measured over
  these models (``pytest -s`` prints them).  DCN runs tpurec's
  cross stack through its Pallas kernel (interpret mode, a test-local
  monkeypatch): the kernel casts nothing, as the port's #8/#9 do not.
The attention gap, the Predictor and the hybrid step in bf16 are
tests/test_torch_bf16_serve.py; the Trainer, CDC and the AUC gap
tests/test_torch_bf16_train.py.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurec.nn.precision as jprec
from test_torch_bases import DOMAIN_IDX, N_TOWER, ids
from test_torch_bases import small_kw as bases_kw
from test_torch_routed import jax_variables, port_model, routed_kw
from tpurec.nn.core import Linear as JaxLinear
from tpurec.nn.core import StackedLinear as JaxStackedLinear
from tpurec_torch.convert import state_dict_from_flax
from tpurec_torch.models import MULTI_TOWER_OUTPUT
from tpurec_torch.nn import precision
from tpurec_torch.nn.core import Linear, StackedLinear

BF16 = "bfloat16"
# every model the port builds; use_atten=False leaves attention out
MODELS = ("mmoe", "dcn", "ple", "pepnet", "epnet", "star", "hinet", "adl",
          "adasparse")
# bf16, use_atten=False, port vs tpurec (measured, ``pytest -s``): logits
# at most 3.0e-7 of max(1, |x|) (STAR's training forward), the row
# gradient at most 1.8e-3 of its largest (PLE's training forward, whose
# experts have no BatchNorm); the limits are about 4x those, far inside
# tpurec's own bf16-vs-float32 gap (2.7e-3 to 1.3e-2 on these models)
BF16_TOL = 1e-6
BF16_GRAD_TOL = 7e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_kw(name, **over):
    if name in ("hinet", "adl", "adl-split", "adasparse"):
        return routed_kw(name, **over)
    if name == "mmoe":
        return {"model": "mmoe", "embed_dim": 4, "mmoe_expert_dims": (16, 8),
                "mmoe_tower_dims": (8,), "atten_embed_dim": 8,
                "att_layer_num": 1, "dropout": 0.0, **over}
    if name == "dcn":
        return {"model": "dcn", "embed_dim": 4, "mlp_dims": (16, 8),
                "dropout": 0.0, **over}
    return bases_kw(name, **over)


@pytest.fixture
def fused_cross(monkeypatch):
    """tpurec's CrossNetwork through its Pallas kernel, in interpret mode
    on the CPU (the TPU's default path, which casts nothing); tpurec's
    files are not touched."""
    import tpurec.models.base as jbase
    import tpurec.models.dcn as jdcn
    import tpurec.ops.crossnet_pallas as cp
    from tpurec.nn.interactions import CrossNetwork

    orig = cp.cross_network_fused
    monkeypatch.setattr(cp, "cross_network_fused",
                        lambda x, w, b, interpret=False: orig(x, w, b, True))
    fused = functools.partial(CrossNetwork, fused=True)
    monkeypatch.setattr(jdcn, "CrossNetwork", fused)
    monkeypatch.setattr(jbase, "CrossNetwork", fused)


def rel(a, w):
    a, w = np.asarray(a, np.float64), np.asarray(w, np.float64)
    return float((np.abs(a - w) / np.maximum(1.0, np.abs(w))).max())


# -- the policy -----------------------------------------------------------

def test_cast_operands_matches_tpurec():
    """Values (including ties, subnormals, inf and NaN) and gradients
    bitwise equal to tpurec's CPU cast; off, the tensors pass through."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 9)) * 10.0 ** rng.integers(
        -40, 30, (64, 9))).astype(np.float32)
    x.reshape(-1)[:6] = [np.inf, -np.inf, np.nan, 1 + 2 ** -8, 1 + 3 * 2 ** -8,
                         1e-41]
    w = rng.normal(size=(9, 5)).astype(np.float32)
    g = rng.normal(size=(64, 5)).astype(np.float32)
    assert precision.get_compute_dtype() is None
    xt = torch.from_numpy(x)
    assert precision.cast_operands(xt) is xt
    with precision.compute_dtype(BF16), jprec.compute_dtype(BF16):
        xc, wc = precision.cast_operands(xt, torch.from_numpy(w))
        jx, jw = jprec.cast_operands(jnp.asarray(x), jnp.asarray(w))
        assert xc.dtype == torch.float32
        np.testing.assert_array_equal(xc.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(wc.numpy(), np.asarray(jw))

        def jloss(a, b):
            aa, bb = jprec.cast_operands(a, b)
            return jnp.sum((aa @ bb) * g)
        xf = np.nan_to_num(x, posinf=1.0, neginf=-1.0, nan=0.0)
        want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xf),
                                               jnp.asarray(w))
        a = torch.tensor(xf, requires_grad=True)
        b = torch.tensor(w, requires_grad=True)
        aa, bb = precision.cast_operands(a, b)
        ((aa @ bb) * torch.from_numpy(g)).sum().backward()
    for got, wnt in zip((a.grad, b.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(wnt), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(wnt)).max())
    # the cotangent reaching x is rounded: a.grad is g @ w_bf16^T rounded
    gw = torch.from_numpy(g) @ bb.detach().T
    assert not torch.equal(a.grad, gw)
    torch.testing.assert_close(a.grad, gw.to(torch.bfloat16).float(),
                               rtol=0, atol=0)


def test_aliases_and_errors():
    for name in (None, "", "float32", "f32", torch.float32):
        with precision.compute_dtype(name):
            assert precision.get_compute_dtype() is None
    for name in ("bfloat16", "bf16", torch.bfloat16):
        with precision.compute_dtype(name):
            assert precision.get_compute_dtype() is torch.bfloat16
    for bad in ("float16", "fp8", torch.float16):
        with pytest.raises(ValueError, match="compute_dtype"):
            precision.check_compute_dtype(bad)
        with pytest.raises(ValueError, match="compute_dtype"):
            with precision.compute_dtype(bad):
                pass
    assert precision.get_compute_dtype() is None


def test_scope_is_per_context_and_covers_the_backward():
    """A thread sees its own scope; a nested scope restores the outer
    one; set_compute_dtype sets the current context's; a backward run
    after the ``with`` block rounds where its forward cast."""
    seen = {}
    ready, go = threading.Event(), threading.Event()

    def other():
        seen["start"] = precision.get_compute_dtype()
        with precision.compute_dtype("float32"):
            ready.set()
            go.wait(10)
            seen["inner"] = precision.get_compute_dtype()
        precision.set_compute_dtype(BF16)
        seen["set"] = precision.get_compute_dtype()

    with precision.compute_dtype(BF16):
        t = threading.Thread(target=other)
        t.start()
        ready.wait(10)
        assert precision.get_compute_dtype() is torch.bfloat16
        with precision.compute_dtype(None):
            assert precision.get_compute_dtype() is None
            go.set()
            t.join(10)
        assert precision.get_compute_dtype() is torch.bfloat16
    assert seen == {"start": None, "inner": None, "set": torch.bfloat16}
    assert precision.get_compute_dtype() is None

    rng = np.random.default_rng(1)
    lin = Linear(7, 3)
    lin.weight.data = torch.from_numpy(rng.normal(size=(7, 3)).astype(
        np.float32))
    lin.bias.data.zero_()
    x0 = torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    grads = {}
    for dt in (None, BF16):
        x = x0.clone().requires_grad_(True)
        with precision.compute_dtype(dt):
            y = lin(x)
        (y * dy).sum().backward()            # outside the scope
        grads[dt] = x.grad
    w16 = lin.weight.detach().to(torch.bfloat16).float()
    want = (dy @ w16.T).to(torch.bfloat16).float()
    torch.testing.assert_close(grads[BF16], want, rtol=0, atol=0)
    assert not torch.equal(grads[BF16], grads[None])


@pytest.mark.parametrize("stacked", [False, True])
def test_linear_layers_match_tpurec(stacked):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(11, 3, 6) if stacked else (11, 6)).astype(
        np.float32)
    dy_shape = (11, 3, 4)
    jm = JaxStackedLinear(3, 4) if stacked else JaxLinear(4)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    tm = StackedLinear(3, 6, 4) if stacked else Linear(6, 4)
    tm.load_state_dict(state_dict_from_flax(v["params"]), strict=True)
    dy = rng.normal(size=dy_shape if stacked else (11, 4)).astype(np.float32)
    out = {}
    for dt in ("float32", BF16):
        def jf(p, xx):
            with jprec.compute_dtype(dt):
                return jnp.sum(jm.apply({"params": p}, xx) * dy)
        want_y = jax.jit(lambda p, xx: jm.apply({"params": p}, xx)) \
            if dt == "float32" else None
        with jprec.compute_dtype(dt):
            wy = np.asarray(jm.apply(v, jnp.asarray(x)))
        wg = jax.grad(jf, argnums=(0, 1))(v["params"], jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        with precision.compute_dtype(dt):
            y = tm(xt)
        (y * torch.from_numpy(dy)).sum().backward()
        np.testing.assert_allclose(y.detach().numpy(), wy, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wg[1]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tm.weight.grad.numpy(),
                                   np.asarray(wg[0]["weight"]), rtol=1e-6,
                                   atol=1e-5)
        tm.zero_grad()
        out[dt] = y.detach()
        del want_y
    assert not torch.equal(out["float32"], out[BF16])


# -- the models -----------------------------------------------------------

def _forward_gap(name, kw, seed, train):
    """(port bf16 vs tpurec bf16, tpurec bf16 vs its float32, row-gradient
    gap) on one batch; ``train`` runs the training forward with a row
    mask and differentiates sum(out * dy) by the gathered rows."""
    rng = np.random.default_rng(seed)
    jm, variables = jax_variables(name, kw, rng)
    pm = port_model(name, kw, variables)
    X = ids(rng, 40)
    g = (X[:, DOMAIN_IDX] % N_TOWER).astype(np.int32)
    mask = np.ones(40, np.float32)
    mask[-6:] = 0.0
    multi = name in MULTI_TOWER_OUTPUT
    dy = rng.normal(size=(40, N_TOWER) if multi else (40,)).astype(
        np.float32)
    rows0 = np.asarray(variables["params"]["embedding"]["table"])[
        (X + np.asarray(pm.embedding.layout.offsets)[None]).reshape(-1)]
    mutable = [k for k in variables if k != "params"]

    def jax_run(dt):
        def f(rows):
            with jprec.compute_dtype(dt):
                if train:
                    out, _ = jm.apply(
                        variables, jnp.asarray(X), group=jnp.asarray(g),
                        train=True, row_mask=jnp.asarray(mask),
                        mutable=mutable,
                        rngs={"dropout": jax.random.PRNGKey(0)},
                        embed_rows=rows)
                else:
                    out = jm.apply(variables, jnp.asarray(X),
                                   group=jnp.asarray(g), embed_rows=rows)
            return jnp.sum(out * dy), out
        (_, out), grad = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jnp.asarray(rows0))
        return np.asarray(out), np.asarray(grad)

    want, want_g = jax_run(BF16)
    want32, _ = jax_run("float32")
    pm.train(train)
    rows = torch.from_numpy(rows0).requires_grad_(True)
    with precision.compute_dtype(BF16):
        out = pm(torch.from_numpy(X), group=torch.from_numpy(g), train=train,
                 row_mask=torch.from_numpy(mask) if train else None,
                 embed_rows=rows)
    (out * torch.from_numpy(dy)).sum().backward()
    return (rel(out.detach().numpy(), want), rel(want, want32),
            float(np.abs(rows.grad.numpy() - want_g).max()
                  / np.abs(want_g).max()))


@pytest.mark.parametrize("name", MODELS)
def test_models_without_attention_match_tpurec(name, fused_cross):
    """use_atten=False, the training forward with a row mask: the port's
    casts are tpurec's, so the logits hold to BF16_TOL and the row
    gradient to BF16_GRAD_TOL, far inside tpurec's own bf16-vs-float32
    gap (which shows the casts are on the path).  The eval forwards are
    tests/test_torch_bf16_serve.py's Predictors."""
    gap, own, grad = _forward_gap(name, model_kw(name, use_atten=False),
                                  MODELS.index(name), True)
    print(f"{name} bf16, no attention: port vs tpurec "
          f"{gap:.3g} (logits), {grad:.3g} (row gradient, of its max); "
          f"tpurec bf16 vs float32 {own:.3g}")    # shown by pytest -s
    assert gap <= BF16_TOL and grad <= BF16_GRAD_TOL
    assert own > 10 * gap

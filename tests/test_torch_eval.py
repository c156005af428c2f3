"""The port's eval steps (tpurec_torch.train.step) against the JAX
package's (tpurec.train.step) on the same converted parameters of the
MMoE and DCN models at the widths of tests/test_train_e2e.py, with random
BatchNorm statistics; ids and labels are made with numpy from a seed.

Tolerances.  Probabilities: 1e-5 absolute (float32 forwards whose sums
run in another order).  Histogram counts: equal (0/1 weights sum exactly
in float32).  Log-loss sums: 1e-6 relative (per-row float32 logaddexp of
two libraries, summed in another order).  The same logits go into both
hist_update calls, so no bin can differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurec.train.step as js
import tpurec_torch.train.step as ps
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.models import build_model as jax_build_model
from tpurec_torch.config import ModelConfig
from tpurec_torch.convert import state_dict_from_flax
from tpurec_torch.models import MULTI_TOWER_OUTPUT, build_model

FIELD_DIMS = (34, 36, 50, 4, 61, 9)
DOMAIN_IDX, N_DOMAIN, BS = 3, 4, 64
SMALL_MODEL = dict(embed_dim=8, mlp_dims=(32, 16), mmoe_expert_dims=(32, 16),
                   mmoe_tower_dims=(16,), atten_embed_dim=8, att_layer_num=1)
N_TOWER = {"mmoe": N_DOMAIN, "dcn": 1}
D2G = {"mmoe": np.arange(N_DOMAIN, dtype=np.int32),
       "dcn": np.zeros(N_DOMAIN, np.int32)}
P_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The models here are small: one torch thread runs them fastest
    beside the other test workers, whose threads would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_stats(tree, rng):
    def one(path, a):
        if a.dtype != np.float32:
            return a
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.3 * rng.normal(size=a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, tree)


def _ids(rng, n):
    return np.stack([rng.integers(0, d, n) for d in FIELD_DIMS],
                    1).astype(np.int32)


_MODELS = {}


def _models(name):
    """(jax model, params, model_state, port model), built once a name."""
    if name not in _MODELS:
        rng = np.random.default_rng(0)
        jm = jax_build_model(name, FIELD_DIMS, N_TOWER[name], DOMAIN_IDX,
                             JaxModelConfig(model=name, **SMALL_MODEL))
        v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1),
                                             jnp.asarray(_ids(rng, 2))))
        params = v["params"]
        ms = {"batch_stats": _random_stats(v["batch_stats"], rng)}
        pm = build_model(name, FIELD_DIMS, N_TOWER[name], DOMAIN_IDX,
                         ModelConfig(model=name, **SMALL_MODEL), device="cpu")
        pm.load_state_dict(state_dict_from_flax(params, ms), strict=True)
        _MODELS[name] = (jm, params, ms, pm)
    return _MODELS[name]


def _dataset(seed, n=700):
    rng = np.random.default_rng(seed)
    return _ids(rng, n), (rng.random(n) < 0.3).astype(np.float32)


@pytest.mark.parametrize("name", ["mmoe", "dcn"])
def test_eval_step_matches_jax(name):
    jm, params, ms, pm = _models(name)
    multi = name in MULTI_TOWER_OUTPUT
    X, _ = _dataset(1, BS)
    group = D2G[name][X[:, DOMAIN_IDX]]
    want = js.make_eval_step(jm, multi)(
        params, ms, {"x": jnp.asarray(X), "group": jnp.asarray(group)})
    got = ps.make_eval_step(pm, multi)(
        pm, {"x": torch.from_numpy(X), "group": torch.from_numpy(group)})
    assert got.shape == (BS,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=P_ATOL)


def _index_batches(n, k, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (k, BS)).astype(np.int32)
    mask = (rng.random((k, BS)) < 0.9).astype(np.float32)
    return idx, mask


@pytest.mark.parametrize("name", ["mmoe", "dcn"])
def test_indexed_eval_scan_matches_jax(name):
    jm, params, ms, pm = _models(name)
    multi = name in MULTI_TOWER_OUTPUT
    X, _ = _dataset(2)
    idx, _ = _index_batches(len(X), 3, 3)
    want = js.make_indexed_eval_scan(jm, multi, DOMAIN_IDX)(
        params, ms, jnp.asarray(X), jnp.asarray(D2G[name]),
        jnp.asarray(idx))
    got = ps.make_indexed_eval_scan(pm, multi, DOMAIN_IDX)(
        pm, torch.from_numpy(X), torch.from_numpy(D2G[name]),
        torch.from_numpy(idx))
    assert got.shape == (3, BS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=P_ATOL)


def _hist_inputs(seed, n=5000):
    rng = np.random.default_rng(seed)
    logit = (rng.normal(size=n) * 4).astype(np.float32)
    logit[:6] = [0.0, 40.0, -40.0, 16.2, -17.5, 30.0]   # saturated rows
    y = (rng.random(n) < 0.4).astype(np.float32)
    mask = (rng.random(n) < 0.8).astype(np.float32)
    dom = rng.integers(0, N_DOMAIN, n).astype(np.int32)
    return dom, logit, y, mask


def _assert_carry(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if i == 2:                                   # the log-loss sums
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        else:                                        # counts
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_bins", [64, 8192])
def test_hist_update_matches_jax(n_bins):
    dom, logit, y, mask = _hist_inputs(4)
    want = js.hist_update(js.hist_init(N_DOMAIN, n_bins), jnp.asarray(dom),
                          jnp.asarray(logit), jnp.asarray(y),
                          jnp.asarray(mask), n_bins)
    carry = ps.hist_init(N_DOMAIN, n_bins, device="cpu")
    got = ps.hist_update(carry, torch.from_numpy(dom),
                         torch.from_numpy(logit), torch.from_numpy(y),
                         torch.from_numpy(mask), n_bins)
    assert got is carry                              # in place
    _assert_carry(got, want)
    assert float(got[2].sum()) > 0 and np.isfinite(got[2].numpy()).all()


def test_host_hist_accumulator_flushes_equal_totals():
    n_bins = 128
    parts = [_hist_inputs(s, 900) for s in range(5)]

    def run(mod, device_kw, to):
        acc = mod.HostHistAccumulator(
            lambda: mod.hist_init(N_DOMAIN, n_bins, **device_kw),
            flush_every=2)
        for dom, logit, y, mask in parts:
            acc.update(mod.hist_update(acc.carry, to(dom), to(logit), to(y),
                                       to(mask), n_bins))
        return acc.totals()

    want = run(js, {}, jnp.asarray)
    got = run(ps, {"device": "cpu"}, torch.from_numpy)
    for g in got:
        assert g.dtype == np.float64
    _assert_carry(got, want)


@pytest.mark.parametrize("name", ["mmoe", "dcn"])
def test_streaming_eval_scans_match_jax(name):
    jm, params, ms, pm = _models(name)
    multi = name in MULTI_TOWER_OUTPUT
    n_bins = 256
    X, y = _dataset(5)
    d2g = D2G[name]
    idx, mask = _index_batches(len(X), 4, 6)
    jscan, jinit = js.make_streaming_eval_scan(jm, multi, DOMAIN_IDX,
                                               N_DOMAIN, n_bins)
    want = jscan(params, ms, jnp.asarray(X), jnp.asarray(y),
                 jnp.asarray(d2g), (jnp.asarray(idx), jnp.asarray(mask)),
                 *jinit())
    pscan, pinit = ps.make_streaming_eval_scan(pm, multi, DOMAIN_IDX,
                                               N_DOMAIN, n_bins)
    got = pscan(pm, torch.from_numpy(X), torch.from_numpy(y),
                torch.from_numpy(d2g),
                (torch.from_numpy(idx), torch.from_numpy(mask)), *pinit())
    _assert_carry(got, want)
    # the same batches, stacked, through the batch-mode scan
    xs = X[idx]
    batches = {"x": xs, "y": y[idx], "group": d2g[xs[:, :, DOMAIN_IDX]],
               "mask": mask}
    jb, jbinit = js.make_streaming_eval_batch_scan(jm, multi, DOMAIN_IDX,
                                                   N_DOMAIN, n_bins)
    pb, pbinit = ps.make_streaming_eval_batch_scan(pm, multi, DOMAIN_IDX,
                                                   N_DOMAIN, n_bins)
    want_b = jb(params, ms, *jbinit(),
                {k: jnp.asarray(v) for k, v in batches.items()})
    got_b = pb(pm, *pbinit(),
               {k: torch.from_numpy(v) for k, v in batches.items()})
    _assert_carry(got_b, want_b)
    for g, w in zip(got_b, got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_bf16_compute_is_refused():
    """bf16 compute is ported: every eval step and scan takes it, and its
    forward differs from the float32 one (the Linears cast); a compute
    dtype that names nothing still raises ValueError."""
    _, _, _, pm = _models("dcn")
    makers = (ps.make_eval_step, ps.make_indexed_eval_scan,
              ps.make_streaming_eval_scan,
              ps.make_streaming_eval_batch_scan)
    for make in makers:
        args = {ps.make_eval_step: (pm, False),
                ps.make_indexed_eval_scan: (pm, False, 3)}.get(
            make, (pm, False, 3, 4))
        make(*args, compute_dtype="bfloat16")
        with pytest.raises(ValueError, match="compute_dtype"):
            make(*args, compute_dtype="float16")
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 3, (16, len(pm.field_dims))).astype(np.int32))
    p32 = ps.make_eval_step(pm, False)(pm, {"x": x})
    p16 = ps.make_eval_step(pm, False, "bfloat16")(pm, {"x": x})
    assert not torch.equal(p32, p16)
    torch.testing.assert_close(p16, p32, rtol=0, atol=0.05)

"""The port's CDC engine (tpurec_torch.cdc.CDCTrainer, plain versions on the
CPU) against the JAX package's (tpurec.cdc.CDCTrainer): one CDC epoch,
that is the warmup, one matrix update and the split-mode spans.

Data: make_synthetic(3500 rows, 6 fields, 4 domains, domain_idx 3, 2
domain clusters) at bs=256: a warmup of 5 steps, an update of 4 mask
rows, the baseline, 4 A rows and 6 B rows (k = 4 steps a burst, W =
1,792), then 14 split-mode steps.  The port starts from tpurec's initial
state (``restore_bytes`` of ``flax.serialization.to_bytes``) with dropout
0, and each package clusters with its own k-means (tpurec's is
scikit-learn's).

Tolerances: per-step losses 1e-4 relative; the raw matrices of the
update (mask, A with its baseline row, B) 1e-4 of max(1, |x|); the same
domain2group.  A bias feeding a training BatchNorm has a gradient that is
zero but for rounding, which Adam turns into a step of up to lr either
way, differently in the two packages (ROADMAP.md queue 3).  Training
losses do not see it (the BatchNorm normalises the bias away), but the
probe evals do, through the BatchNorm's running mean.  With wd = 1e-3
the decay term outweighs the rounding, both packages take the same step
and the rows agree to 2.4e-7 (``pytest -s`` prints them), so this file
runs at wd = 1e-3;
``tests/test_torch_cdc_probe.py`` runs the same epoch at the default wd
and with the AUC probe metric, through the helpers here."""

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurec.cdc.engine as jax_engine
from tpurec.cdc import CDCTrainer as JaxCDCTrainer
from tpurec.config import CDCConfig as JaxCDCConfig
from tpurec.config import Config as JaxConfig
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.train.step import bce_on_probs as jax_bce_on_probs
import tpurec_torch.cdc.engine as port_engine
from tpurec_torch.cdc import CDCTrainer
from tpurec_torch.config import CDCConfig, Config, ModelConfig, TrainConfig
from tpurec_torch.data import make_synthetic
from tpurec_torch.train.step import bce_on_probs

MODEL = dict(model="cdc", embed_dim=8, mlp_dims=(32, 16), atten_embed_dim=8,
             att_layer_num=1, dropout=0.0)
CDC = dict(base_model="mmoe", n_cluster=2, n_causal_mask=4, warmup_step=1,
           update_matrix_step=1, update_interval=4, cdc_tower_dims=(16,))
TRAIN = dict(bs=256, epoch=1, seed=0)
ROW_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return make_synthetic(n_rows=3500, n_fields=6, n_domain=4, domain_idx=3,
                          seed=1, domain_cluster_k=2)


def _pair(data, wd=TrainConfig.wd, model=None, **cdc):
    """(tpurec trainer, port trainer started from its state); ``model``
    overrides fields of MODEL."""
    t, c = {**TRAIN, "wd": wd}, {**CDC, **cdc}
    m = {**MODEL, **(model or {})}
    jtr = JaxCDCTrainer(
        JaxConfig(model=JaxModelConfig(**m), cdc=JaxCDCConfig(**c),
                  train=JaxTrainConfig(**t)),
        data.field_dims, data.n_domain, data.domain_idx)
    tr = CDCTrainer(
        Config(model=ModelConfig(**m), cdc=CDCConfig(**c),
               train=TrainConfig(**t)),
        data.field_dims, data.n_domain, data.domain_idx, device="cpu")
    tr.restore_bytes(fser.to_bytes(jtr.state))
    return jtr, tr


def _record_groups(monkeypatch, module, out):
    """Keep the raw matrices update_group receives, and its result."""
    orig = module.update_group

    def rec(st, cfg, w, kmeans_seed=None):
        entry = {"mask": st.matrix_mask.copy(), "A": st.matrix_A.copy(),
                 "B": st.matrix_B.copy(), "seed": kmeans_seed}
        entry["d2g"] = list(orig(st, cfg, w, kmeans_seed=kmeans_seed))
        out.append(entry)
        return entry["d2g"]

    monkeypatch.setattr(module, "update_group", rec)


def _record_jax_steps(jtr, out):
    """Each warmup and split step's loss of tpurec's trainer, in order
    (a gated scan's skipped steps dropped)."""
    warm = jtr._warmup_scan

    def warmup(*a):
        st, losses = warm(*a)
        out["warmup"].extend(np.asarray(losses).tolist())
        return st, losses

    step, scan, gated = (jtr._split_step, jtr._split_scan,
                         jtr._split_scan_gated)

    def split_step(*a):
        st, loss = step(*a)
        out["split"].append(float(loss))
        return st, loss

    def split_scan(*a):
        st, losses = scan(*a)
        out["split"].extend(np.asarray(losses).tolist())
        return st, losses

    def split_gated(ts, X, y, idxs, masks, valids, *rest):
        st, losses = gated(ts, X, y, idxs, masks, valids, *rest)
        keep = np.asarray(valids) > 0
        out["split"].extend(np.asarray(losses)[keep].tolist())
        return st, losses

    jtr._warmup_scan, jtr._split_step = warmup, split_step
    jtr._split_scan, jtr._split_scan_gated = split_scan, split_gated


def _record_port_steps(tr, out):
    run = tr._run_steps

    def run_steps(mode, idxs, masks, valids=None):
        losses = run(mode, idxs, masks, valids)
        out[mode].extend(float(v) for v in losses)
        return losses

    tr._run_steps = run_steps


def _row_err(got, want):
    return np.abs(got - want) / np.maximum(1.0, np.abs(want))


@pytest.mark.parametrize("weights", [False, True])
def test_bce_on_probs_matches_tpurec(weights):
    rng = np.random.default_rng(0)
    p = rng.random(64).astype(np.float32)
    p[:3] = (0.0, 1.0, 1e-9)                 # clipped: no gradient
    y = (rng.random(64) < 0.4).astype(np.float32)
    w = (rng.random(64) < 0.8).astype(np.float32) if weights else None

    def jax_loss(pp):
        return jax_bce_on_probs(pp, jnp.asarray(y),
                                None if w is None else jnp.asarray(w))

    want, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(p))
    pt = torch.tensor(p, requires_grad=True)
    got = bce_on_probs(pt, torch.tensor(y),
                       None if w is None else torch.tensor(w))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-7)
    assert (pt.grad[:3] == 0).all()
    zero = bce_on_probs(torch.ones(4) * 0.5, torch.ones(4), torch.zeros(4))
    assert zero.item() == 0.0                # sum(w) clamps to 1


def run_epoch_pair(data, monkeypatch, wd, model=None, **cdc):
    """One CDC epoch in both packages from one state -> (tpurec trainer,
    port trainer, their update_group records, their step losses)."""
    jtr, tr = _pair(data, wd=wd, model=model, **cdc)
    groups = {"jax": [], "port": []}
    _record_groups(monkeypatch, jax_engine, groups["jax"])
    _record_groups(monkeypatch, port_engine, groups["port"])
    steps = {"jax": {"warmup": [], "split": []},
             "port": {"warmup": [], "split": []}}
    _record_jax_steps(jtr, steps["jax"])
    _record_port_steps(tr, steps["port"])
    for t in (jtr, tr):
        t.setup_data(data.train, data.valid)
    means = (jtr.train_cdc_epoch(0), tr.train_cdc_epoch(0))
    return jtr, tr, groups, steps, means


def check_epoch_pair(data, jtr, tr, groups, steps, means, tol):
    """Losses, the update's raw matrices (burst rows within ``tol``) and
    the clustering of :func:`run_epoch_pair`."""
    mean_j, mean_p = means
    j, p = steps["jax"], steps["port"]
    assert len(p["warmup"]) == len(j["warmup"]) == 5
    assert len(p["split"]) == len(j["split"]) == len(
        tr.train_batcher.domain_batch_seq) == 14
    for mode in ("warmup", "split"):
        np.testing.assert_allclose(p[mode], j[mode], rtol=1e-4, atol=0)
    assert mean_p == pytest.approx(mean_j, rel=1e-4)
    assert tr.state.step == int(jtr.state.step)

    (gj,), (gp,) = groups["jax"], groups["port"]
    assert gp["seed"] == gj["seed"]
    D = data.n_domain
    errs = {}
    for name in ("mask", "A", "B"):
        assert gp[name].shape == gj[name].shape
        errs[name] = _row_err(gp[name], gj[name]).max()
    errs["baseline"] = _row_err(gp["A"][D], gj["A"][D]).max()
    print(f"wd {tr.cfg.train.wd}: raw matrix rows vs tpurec, max err of "
          f"max(1, |x|): {errs}")          # shown by pytest -s
    for name in ("mask", "A", "B"):
        assert errs[name] <= tol, (name, errs[name])
    # the baseline row sees no burst, only the warmup's 5 steps
    assert errs["baseline"] <= ROW_TOL
    assert gp["d2g"] == gj["d2g"]
    assert tr.cluster.s_group2domain_list == jtr.cluster.s_group2domain_list
    assert tr.cluster.t_group2domain_list == jtr.cluster.t_group2domain_list
    assert tr.cluster.call_update_group == jtr.cluster.call_update_group == 1
    np.testing.assert_allclose(tr.cluster.matrix_causal,
                               jtr.cluster.matrix_causal, rtol=0,
                               atol=10 * tol)
    # the schedules drew the same numbers from the same generators
    assert tr.np_rng.integers(2**31) == jtr.np_rng.integers(2**31)
    assert tr.train_batcher.rng.integers(2**31) == \
        jtr.train_batcher.rng.integers(2**31)


def test_cdc_epoch_matches_tpurec(data, monkeypatch):
    """wd = 1e-3: every row of the update within ROW_TOL."""
    check_epoch_pair(data, *run_epoch_pair(data, monkeypatch, 1e-3),
                     tol=ROW_TOL)

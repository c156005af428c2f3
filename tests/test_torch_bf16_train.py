"""bf16 compute through the port's Trainer and CDCTrainer (plain versions
on the CPU) against the JAX package's, and the AUC gap the attention
stack's float32 kernel leaves.

- One Trainer epoch of MMoE and of HiNet with ``use_atten=False`` (15
  steps, the last one padded) from tpurec's initial state: per-step
  losses and the eval of the two trained states against tpurec's, at
  limits about 4x the largest measured (``pytest -s`` prints them).
- One CDC epoch on the MMoE base with ``use_atten=False`` at wd 1e-3
  (tests/test_torch_cdc_engine.py's): step losses, the update's raw
  matrices and the clustering against tpurec's.
- The AUC gap, with attention on (the default): tpurec in bf16, the port
  in bf16 and in float32, and tpurec in float32, each trained 2 epochs on
  one synthetic set (the drive recipe's) from tpurec's initial state.
  tpurec's models cast inside the attention stack and the port's kernel
  does not (``tpurec_torch/nn/interactions.py``); the port's bf16 AUC is
  held within AUC_GAP of tpurec's bf16 AUC, and the printed gaps decide
  ROADMAP.md queue 2 item 4.
"""

import flax.serialization as fser
import numpy as np
import pytest
import torch

import test_torch_cdc_engine as cdc_test
from tpurec.config import Config as JaxConfig
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.train import Trainer as JaxTrainer
from tpurec_torch.config import Config, ModelConfig, TrainConfig
from tpurec_torch.data import make_synthetic
from tpurec_torch.train import Trainer

BF16 = "bfloat16"
SMALL = dict(embed_dim=8, mmoe_expert_dims=(32, 16), mmoe_tower_dims=(16,),
             sei_dims=(16, 8), tower_dims=(32, 16), atten_embed_dim=8,
             att_layer_num=1, dropout=0.0)
TRAIN = dict(bs=256, epoch=1, seed=0, steps_per_dispatch=4)
# bf16, no attention, port vs tpurec over one epoch (measured, ``pytest
# -s``: per-step losses 7.7e-5 (MMoE) and 4.2e-4 (HiNet) relative, eval
# AUC 2.9e-4 and 1.9e-4, LogLoss 7.7e-6 and 4.0e-6; a CDC epoch's step
# losses 1.9e-4, its raw matrix rows 3.4e-5 of max(1, |x|)).  A bf16 rounding that differs moves a near-zero
# gradient's sign, which Adam turns into a step of lr the other way, so
# the two packages part more than in float32; each limit is about 4x the
# largest measured.
STEP_RTOL = 2e-3
EVAL_AUC_TOL, EVAL_LOSS_TOL = 1.2e-3, 3e-5
CDC_STEP_RTOL = 1e-3
CDC_ROW_TOL = 1.5e-4
# the AUC gap with attention (measured: 3.6e-4, beside tpurec's own
# bf16-vs-float32 gap of 3.7e-4 and the float32 packages' 1.2e-4)
AUC_GAP = 1.5e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return make_synthetic(n_rows=4000, n_fields=6, n_domain=4, domain_idx=3,
                          seed=1)


def _pair(data, name, dtype, use_atten, epoch=1):
    kw = dict(model=name, use_atten=use_atten, **SMALL)
    t = dict(TRAIN, compute_dtype=dtype, epoch=epoch)
    jtr = JaxTrainer(JaxConfig(model=JaxModelConfig(**kw),
                               train=JaxTrainConfig(**t)),
                     data.field_dims, data.n_domain, data.domain_idx,
                     domain2group=np.arange(4))
    tr = Trainer(Config(model=ModelConfig(**kw), train=TrainConfig(**t)),
                 data.field_dims, data.n_domain, data.domain_idx,
                 domain2group=np.arange(4), device="cpu")
    tr.restore(fser.to_bytes(jtr.state))
    return jtr, tr


def _record(tr, jax_side):
    orig, out = tr.scan_steps_idx, []

    def wrapped(*args):
        r = orig(*args)
        out.append(np.asarray(r[1] if jax_side else r))
        return r

    tr.scan_steps_idx = wrapped
    return out


@pytest.mark.parametrize("name", ["mmoe", "hinet"])
def test_one_epoch_matches_tpurec(data, name):
    jtr, tr = _pair(data, name, BF16, use_atten=False)
    lj, lp = _record(jtr, True), _record(tr, False)
    X, y = data.train
    jtr.train_epoch(X, y, 0)
    tr.train_epoch(X, y, 0)
    lj, lp = np.concatenate(lj), np.concatenate(lp)
    assert lp.shape == lj.shape == (-(-len(X) // TRAIN["bs"]),)
    Xv, yv = data.valid
    w = data.domain_cnt_weight()
    ev_j, ev_p = jtr.evaluate(Xv, yv, w), tr.evaluate(Xv, yv, w)
    errs = (float(np.max(np.abs(lp / lj - 1))),
            abs(ev_p["total_auc"] - ev_j["total_auc"]),
            abs(ev_p["total_loss"] - ev_j["total_loss"]))
    print(f"{name} bf16 epoch, no attention: per-step loss {errs[0]:.3g}, "
          f"eval AUC {errs[1]:.3g}, LogLoss {errs[2]:.3g}")   # pytest -s
    assert errs[0] <= STEP_RTOL
    assert errs[1] <= EVAL_AUC_TOL and errs[2] <= EVAL_LOSS_TOL


def test_cdc_epoch_matches_tpurec(monkeypatch):
    """One CDC epoch in bf16 (no attention, wd 1e-3), with the helpers of
    tests/test_torch_cdc_engine.py: the step losses at CDC_STEP_RTOL, the
    update's raw matrices at CDC_ROW_TOL of max(1, |x|), the same
    clustering."""
    monkeypatch.setattr(cdc_test, "TRAIN", {**cdc_test.TRAIN,
                                            "compute_dtype": BF16})
    cdc = make_synthetic(n_rows=3500, n_fields=6, n_domain=4, domain_idx=3,
                         seed=1, domain_cluster_k=2)
    jtr, tr, groups, steps, means = cdc_test.run_epoch_pair(
        cdc, monkeypatch, 1e-3, model={"use_atten": False})
    assert tr.cfg.train.compute_dtype == jtr.cfg.train.compute_dtype == BF16
    j, p = steps["jax"], steps["port"]
    step_err = max(float(np.max(np.abs(np.asarray(p[m]) / np.asarray(j[m])
                                       - 1))) for m in ("warmup", "split"))
    (gj,), (gp,) = groups["jax"], groups["port"]
    row_err = max(float(cdc_test._row_err(gp[m], gj[m]).max())
                  for m in ("mask", "A", "B"))
    print(f"CDC bf16 epoch, no attention: step losses {step_err:.3g}, raw "
          f"matrix rows {row_err:.3g}")             # shown by pytest -s
    assert len(p["split"]) == len(j["split"]) == 14
    assert step_err <= CDC_STEP_RTOL
    assert row_err <= CDC_ROW_TOL
    assert gp["d2g"] == gj["d2g"]
    assert tr.cluster.s_group2domain_list == jtr.cluster.s_group2domain_list


def test_auc_gap_with_attention():
    """2 epochs of MMoE with attention on the drive recipe's data, from
    one initial state: tpurec bf16, port bf16, port float32, tpurec
    float32; each valid AUC printed (``pytest -s``)."""
    small = make_synthetic(n_rows=12000, n_fields=6, n_domain=4,
                           domain_idx=3, seed=1)
    auc = {}
    for dtype in ("float32", BF16):
        jtr, tr = _pair(small, "mmoe", dtype, use_atten=True, epoch=2)
        for who, t in (("tpurec", jtr), ("port", tr)):
            res = t.fit(small.train, small.valid,
                        domain_cnt_weight=small.domain_cnt_weight())
            auc[who, dtype] = res["valid"]["total_auc"]
    port_gap = abs(auc["port", BF16] - auc["tpurec", BF16])
    own_gap = abs(auc["tpurec", BF16] - auc["tpurec", "float32"])
    print("valid AUC: " + ", ".join(f"{w} {d} {a:.5f}" for (w, d), a in
                                    auc.items())
          + f"; port bf16 vs tpurec bf16 {port_gap:.3g}, tpurec bf16 vs "
          f"float32 {own_gap:.3g}")                # shown by pytest -s
    assert all(a > 0.7 for a in auc.values())
    assert abs(auc["port", "float32"] - auc["tpurec", "float32"]) <= 1e-3
    assert port_gap <= AUC_GAP

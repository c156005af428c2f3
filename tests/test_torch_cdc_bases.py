"""The port's CDC engine on its other base models (PLE, PEPNet, EPNet,
STAR; plain versions on the CPU) against the JAX package's CDCTrainer:
one CDC epoch each, in the shape of tests/test_torch_cdc_engine.py (its
data, schedule and helpers), at wd = 1e-3.

Tolerances as there: per-step losses 1e-4 relative, the update's raw
matrices 1e-4 of max(1, |x|), the same domain2group.  The bases are
narrowed (PLE's experts ((16, 8), (8,)), gates of 8); CDC's remap gives
every base the towers (16,).

STAR is the case that needs CDC to call its base without ``group``, as
tpurec's engine does: with the group, its partitioned norm and tower
BatchNorms would take their training statistics per group, not over the
batch, and the treatment bursts, matrices and clustering would drift
from tpurec's."""

import numpy as np
import pytest
import torch

from test_torch_cdc_engine import check_epoch_pair, run_epoch_pair
from tpurec_torch.cdc import CDCTrainer
from tpurec_torch.config import CDCConfig, Config, ModelConfig, TrainConfig
from tpurec_torch.data import make_synthetic

BASE_MODEL = {"ple": dict(ple_expert_dims=((16, 8), (8,))),
              "pepnet": dict(gate_hidden_dim=8),
              "epnet": dict(gate_hidden_dim=8),
              "star": {}}


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


def epoch_matches_tpurec(data, monkeypatch, base):
    check_epoch_pair(data, *run_epoch_pair(
        data, monkeypatch, 1e-3, model=BASE_MODEL[base], base_model=base),
        tol=1e-4)


@pytest.mark.parametrize("base", ["ple", "star"])
def test_cdc_epoch_matches_tpurec(data, monkeypatch, base):
    epoch_matches_tpurec(data, monkeypatch, base)


def test_default_cdc_config_runs_on_ple(data):
    """A Config with a default CDCConfig() (base "ple", PLE's own nested
    expert dims, towers (64, 32)) builds and trains."""
    cfg = Config(model=ModelConfig(model="cdc", embed_dim=4,
                                   atten_embed_dim=8, att_layer_num=1),
                 train=TrainConfig(bs=256, seed=0))
    assert cfg.cdc == CDCConfig() and cfg.cdc.base_model == "ple"
    tr = CDCTrainer(cfg, data.field_dims, data.n_domain, data.domain_idx,
                    device="cpu")
    names = dict(tr.model.named_parameters())
    assert names["cgc_0.experts_specific.linear_0.weight"].shape == (
        cfg.cdc.n_cluster * 2, 6 * 4, 256)
    assert names["towers.linear_1.weight"].shape[-1] == 32
    tr.setup_data(data.train, data.valid)
    tr._train_burst(0, 2)
    tr._train_burst([0, 1, 2], 1)
    assert tr.state.step == 3
    res = tr.evaluate(tr.valid_batcher)
    assert np.isfinite(res["total_loss"]) and 0 < res["total_auc"] < 1

"""bf16 compute at the port's entry points (plain versions on the CPU)
against the JAX package's, with the models and helpers of
tests/test_torch_bf16.py:

- With attention (the default), the stated gap: tpurec's models run
  attention on its jnp path, which casts inside the stack, while the
  port's kernel #2 stays float32 (``tpurec_torch/nn/interactions.py``).
  The logit gap is held to ATTN_GAP_TOL, measured beside tpurec's own
  bf16-vs-float32 gap.
- The Predictor in bf16 (use_atten=False; 1e-5 on probabilities) against
  tpurec's, and apart from its float32 predictions.
- One hybrid step in bf16 (use_atten=False) from one state: the loss at
  1e-5 relative, the state at 2e-6 but the zero-gradient entries of
  tests/test_torch_routed_train.py (2 lr), ADL's centres included.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_bases import DOMAIN_IDX, FIELD_DIMS, N_TOWER, ids
from test_torch_bf16 import BF16, _forward_gap, model_kw
from test_torch_routed import jax_variables
from tpurec.config import CDCConfig as JaxCDCConfig
from tpurec.config import Config as JaxConfig
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.serve import Predictor as JaxPredictor
from tpurec_torch.config import CDCConfig, Config, ModelConfig, TrainConfig
from tpurec_torch.serve import Predictor

# with attention: 1.8e-3 to 2.5e-3 measured (MMoE, HiNet, ADL), against
# tpurec's own bf16-vs-float32 3.8e-3 to 5.2e-3
ATTN_GAP_TOL = 1e-2
P_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["mmoe", "hinet", "adl"])
def test_attention_gap_is_bounded(name):
    """With attention: tpurec's jnp path casts inside the stack, the
    port's kernel does not.  The logit gap is held to ATTN_GAP_TOL."""
    gap, own, _ = _forward_gap(name, model_kw(name), 50, False)
    print(f"{name} bf16 with attention: port vs tpurec {gap:.3g}; tpurec "
          f"bf16 vs float32 {own:.3g}")            # shown by pytest -s
    assert gap <= ATTN_GAP_TOL


@pytest.mark.parametrize("name", ["mmoe", "hinet", "adl", "adasparse"])
def test_predictor_matches_tpurec(name):
    """A bf16-trained config serves in bf16 in both packages."""
    rng = np.random.default_rng(60)
    kw = model_kw(name, use_atten=False)
    d2g = np.arange(FIELD_DIMS[DOMAIN_IDX]) % N_TOWER
    # ADL serves n_cluster towers: as many as the grouping's here
    jcfg = JaxConfig(model=JaxModelConfig(**kw),
                     train=JaxTrainConfig(compute_dtype=BF16),
                     cdc=JaxCDCConfig(n_cluster=N_TOWER))
    cfg = Config(model=ModelConfig(**kw), train=TrainConfig(
        compute_dtype=BF16), cdc=CDCConfig(n_cluster=N_TOWER))
    n_domain = FIELD_DIMS[DOMAIN_IDX]
    jp = JaxPredictor(jcfg, FIELD_DIMS, n_domain, DOMAIN_IDX,
                      domain2group=d2g, batch_sizes=(16, 64))
    _, variables = jax_variables(name, kw, rng)
    coll = {k: v for k, v in variables.items() if k != "params"}
    jp.load_variables(variables["params"], coll)
    tp = Predictor(cfg, FIELD_DIMS, n_domain, DOMAIN_IDX, domain2group=d2g,
                   batch_sizes=(16, 64), device="cpu").load_variables(
        variables["params"], coll)
    f32 = Predictor(Config(model=ModelConfig(**kw),
                           cdc=CDCConfig(n_cluster=N_TOWER)), FIELD_DIMS,
                    n_domain,
                    DOMAIN_IDX, domain2group=d2g, batch_sizes=(16, 64),
                    device="cpu").load_variables(variables["params"], coll)
    X = ids(rng, 70)
    got, want = tp(X), jp(X)
    np.testing.assert_allclose(got, want, rtol=0, atol=P_ATOL)
    assert np.abs(f32(X) - got).max() > 10 * P_ATOL


@pytest.mark.parametrize("name", ["hinet", "adl", "adasparse"])
def test_hybrid_step_matches_tpurec(name):
    """One bf16 hybrid step from one state (tests/test_torch_routed_train.py's
    helpers, attention off): the loss 1e-5 relative, the state at 2e-6
    but the zero-gradient entries (2 lr), ADL's centres included."""
    import test_torch_routed_train as rt

    jcfg = JaxTrainConfig(bs=rt.BS, wd=1e-8, compute_dtype=BF16)
    tcfg = TrainConfig(bs=rt.BS, wd=1e-8, compute_dtype=BF16)
    b = rt.batch(np.random.default_rng(0), masked=3)
    kw = model_kw(name, use_atten=False)
    _, _, st, jstep = rt.jax_state(name, jcfg, b, kw=kw)
    ts, step = rt.port_state(name, st, tcfg, kw=kw)
    st, loss_j = jstep(st, rt._jax_batch(b), jax.random.PRNGKey(0))
    loss_t = step(ts, rt._torch_batch(b), None)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    rt.assert_close_state(st, ts, f"{name} bf16 step", 2 * jcfg.lr)

"""bf16 compute on the rest of the zoo (DeepFM, DCNv2 with and without the
mixture, AutoInt, xDeepFM, IPNN, OPNN, AFM; plain versions on the CPU)
against the JAX package's ``compute_dtype="bfloat16"``, with the helpers
of tests/test_torch_bf16.py:

- every model but AutoInt: the port casts where tpurec casts (the Linears,
  CrossNetV2's and CrossNetMix's operands; FM, IPN, OPN and CIN cast
  nothing), so the logits of the training and the eval forward hold to
  tests/test_torch_bf16.py's BF16_TOL and the row gradient to its
  BF16_GRAD_TOL, far inside tpurec's own bf16-vs-float32 gap (measured:
  logits at most 7.8e-7 of max(1, |x|) (DeepFM), row gradients at most
  1.0e-4 of their largest (OPNN's eval forward); tpurec's own gap
  2.0e-3 to 9.5e-3);
- AutoInt: tpurec runs its attention on the jnp path, which casts inside
  the stack, while the port's kernel #2 stays float32 (the known
  difference, ROADMAP.md queue 3).  Its logit gap is held to
  tests/test_torch_bf16_serve.py's ATTN_GAP_TOL and measured beside
  tpurec's own bf16-vs-float32 gap (``pytest -s`` prints both; measured
  2.5e-3 beside tpurec's 5.6e-3 with the residual, 4.0e-4 beside 3.0e-3
  without it).
"""

import numpy as np
import pytest
import torch

from test_torch_bf16 import BF16_GRAD_TOL, BF16_TOL, _forward_gap
from test_torch_bf16_serve import ATTN_GAP_TOL
from test_torch_zoo import zoo_kw

VARIANTS = ("deepfm", "dcnv2", "dcnv2-v2", "xdeepfm", "ipnn", "opnn", "afm")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("variant", VARIANTS)
def test_models_match_tpurec_in_bf16(variant, train):
    kw = zoo_kw(variant)
    gap, own, grad = _forward_gap(kw["model"], kw,
                                  70 + VARIANTS.index(variant), train)
    print(f"{variant} bf16 (train={train}): port vs tpurec {gap:.3g} "
          f"(logits), {grad:.3g} (row gradient, of its max); tpurec bf16 "
          f"vs float32 {own:.3g}")                 # shown by pytest -s
    assert gap <= BF16_TOL and grad <= BF16_GRAD_TOL
    assert own > 10 * gap


@pytest.mark.parametrize("att_res", [True, False])
def test_autoint_attention_gap_is_bounded(att_res):
    """The logit gap of the eval forward, beside tpurec's own."""
    kw = zoo_kw("autoint", att_res=att_res)
    gap, own, _ = _forward_gap("autoint", kw, 80, False)
    print(f"autoint bf16 (att_res={att_res}): port vs tpurec {gap:.3g}; "
          f"tpurec bf16 vs float32 {own:.3g}")   # shown by pytest -s
    assert gap <= ATTN_GAP_TOL
    assert np.isfinite(own) and own > 0

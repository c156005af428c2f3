"""Per-model L2 regularisation (counterpart of ``tpurec/train/reg.py``).

The reference adds ``sum(l2 * w**2)`` over a per-model set of weight
tensors to every step's loss (its layer.py:86-112).  The coefficients are
computed once, keyed by parameter name: the port's ``state_dict`` names
are the flax paths joined with dots, so the JAX package's rules apply
with ``.`` in place of ``/``.  For MMoE: ``experts.*`` and ``towers.*``
weights get ``l2_dnn``, ``aux.linear.weight`` gets ``l2_lin``, the table
``l2_emb``; BN parameters, gates and the attention head get nothing.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Tuple

import torch

# weight-like leaf names (the reference registers tensors whose name
# contains 'weight')
_WEIGHT_NAME = re.compile(
    r"^(weight|w_\d+|[uvc]_\d+|in_proj_weight|out_proj_weight"
    r"|domain_w_\d+|shared_w_\d+|linear_w_\d+|kernel|conv_w_\d+)$")
# modules that are never regularised (BN parameters)
_EXCLUDE = re.compile(r"(^|\.)(bn_\d+|tower_bn_\d+|pn)(\.|$)")

# model -> name-prefix patterns whose weight leaves get l2_dnn
MODEL_REG_PREFIXES: Dict[str, List[str]] = {
    "deepfm": [r"^mlp\."],
    "dcn": [r"^mlp\.", r"^cn\."],
    "dcnv2": [r"^dnn\.", r"^dnn_linear\.", r"^crossnet\."],
    "autoint": [r"^dnn\."],
    "mmoe": [r"^experts\.", r"^towers\."],
    "ple": [r"^cgc_\d+\.", r"^towers\."],
    "pepnet": [r"^epnet\.", r"^ppnet\."],
    "pepnet-single": [r"^epnet\.", r"^ppnet\."],
    "epnet": [r"^epnet\.", r"^towers\."],
    "epnet-single": [r"^epnet\.", r"^towers\."],
    "star": [r"^domain_w_\d+$", r"^shared_w_\d+$"],
    "adl": [r"^domain_mlps\."],
    "adl-split": [r"^domain_mlps\."],
    "hinet": [r"^specific_experts\.", r"^specific_gates\.",
              r"^shared_experts\.", r"^shared_gate\.", r"^san_gate\.",
              r"^tower\."],
    "adasparse": [r"^linear_w_\d+$", r"^pruner_\d+\."],
    "xdeepfm": [r"^mlp\.", r"^cin\."],
    "ipnn": [r"^mlp\.", r"^product\."],
    "opnn": [r"^mlp\.", r"^product\."],
    "afm": [r"^afm\."],
}


def reg_coef_tree(names: Iterable[str], model_name: str, l2_emb: float,
                  l2_lin: float, l2_dnn: float) -> Dict[str, float]:
    """Parameter name -> its L2 coefficient (0.0 where unregularised)."""
    prefixes = [re.compile(p) for p in MODEL_REG_PREFIXES.get(model_name, [])]

    def coef_for(full: str) -> float:
        if full == "embedding.table":
            return l2_emb
        if full in ("linear.weight", "aux.linear.weight"):
            return l2_lin
        module, _, leaf = full.rpartition(".")
        if _EXCLUDE.search(module) or not _WEIGHT_NAME.match(leaf):
            return 0.0
        return l2_dnn if any(p.search(full) for p in prefixes) else 0.0

    return {n: coef_for(n) for n in names}


def regularization_loss(named_params: Iterable[Tuple[str, torch.Tensor]],
                        coefs: Dict[str, float]) -> torch.Tensor:
    """``sum(coef * sum(w**2))`` over the parameters with a coefficient."""
    total = None
    for name, w in named_params:
        c = coefs.get(name, 0.0)
        if c:
            term = c * torch.sum(w * w)
            total = term if total is None else total + term
    return total if total is not None else torch.zeros(())

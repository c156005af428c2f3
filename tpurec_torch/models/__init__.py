"""Model registry of the port (counterpart of ``tpurec/models/__init__.py``).

Every name of the JAX package's registry: the reference's zoo
(``deepfm``, ``dcn``, ``dcnv2``, ``autoint``, ``mmoe``, ``ple``,
``pepnet``, ``epnet`` and their ``-single`` variants, ``star``, ``adl``,
``adl-split``, ``hinet``, ``adasparse``) and the extensions ``xdeepfm``,
``ipnn``, ``opnn`` and ``afm``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpurec_torch.config import ModelConfig
from tpurec_torch.device import resolve_device
from tpurec_torch.models.adasparse import AdaSparse
from tpurec_torch.models.adl import ADL
from tpurec_torch.models.autoint import AutoInt
from tpurec_torch.models.base import AuxLogits, CTRModel
from tpurec_torch.models.dcn import DCN
from tpurec_torch.models.dcnv2 import DCNv2
from tpurec_torch.models.deepfm import DeepFM
from tpurec_torch.models.extensions import AFM, PNN, xDeepFM
from tpurec_torch.models.hinet import HiNet
from tpurec_torch.models.mmoe import MMoE
from tpurec_torch.models.pepnet import PEPNet
from tpurec_torch.models.ple import PLE
from tpurec_torch.models.star import STAR
from tpurec_torch.nn.initializers import init_module

MODEL_REGISTRY = {"deepfm": DeepFM, "dcn": DCN, "dcnv2": DCNv2,
                  "autoint": AutoInt, "mmoe": MMoE, "ple": PLE,
                  "pepnet": PEPNet, "epnet": PEPNet, "pepnet-single": PEPNet,
                  "epnet-single": PEPNet, "star": STAR, "adl": ADL,
                  "adl-split": ADL, "hinet": HiNet, "adasparse": AdaSparse,
                  "xdeepfm": xDeepFM, "ipnn": PNN, "opnn": PNN, "afm": AFM}

# models whose output is [B, n_tower] and whose caller selects the group's
# tower (run.py:481-484); hinet/adl select internally and return [B]
MULTI_TOWER_OUTPUT = {"mmoe", "ple", "pepnet", "epnet", "star"}
# models that read the per-row group id (run.py:64-65 + STAR's PN masking)
NEEDS_GROUP = {"star", "adl", "adl-split", "hinet"}
# CDC-supported base models (cdc.py:32-54)
CDC_BASE_MODELS = {"mmoe", "ple", "pepnet", "epnet", "star"}


def build_model(name: str, field_dims: Tuple[int, ...], n_tower: int,
                domain_idx: int, cfg: ModelConfig, device=None,
                generator: Optional[torch.Generator] = None) -> CTRModel:
    """Build model ``name`` with torch-default inits drawn from
    ``generator`` (a fresh CPU generator seeded 0 when None) and move it to
    ``device``: the card by default (raises when there is none), ``"cpu"``
    when asked.  The inits are drawn on the CPU, so one seed gives one set
    of weights on either device.  ``device="meta"`` builds shapes only,
    for a caller that loads every weight itself."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model: {name}")
    kw = dict(field_dims=tuple(int(d) for d in field_dims),
              embed_dim=cfg.embed_dim, cfg=cfg, n_tower=n_tower,
              domain_idx=domain_idx)
    if name in ("pepnet", "pepnet-single", "epnet", "epnet-single"):
        kw["use_ppnet"] = name.startswith("pepnet")
    elif name == "opnn":
        kw["use_inner"] = False
    if name.endswith("-single"):
        kw["n_tower"] = 1
    if device is not None and torch.device(device).type == "meta":
        return MODEL_REGISTRY[name](**kw, device=torch.device("meta"))
    device = resolve_device(device)
    model = MODEL_REGISTRY[name](**kw)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_module(model, generator)
    return model.to(device)


__all__ = ["ADL", "AFM", "AdaSparse", "AutoInt", "AuxLogits",
           "CDC_BASE_MODELS", "CTRModel", "DCN", "DCNv2", "DeepFM", "HiNet",
           "MMoE", "MODEL_REGISTRY", "MULTI_TOWER_OUTPUT", "NEEDS_GROUP",
           "PEPNet", "PLE", "PNN", "STAR", "build_model", "xDeepFM"]

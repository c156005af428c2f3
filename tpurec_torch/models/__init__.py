"""Model registry of the port (counterpart of ``tpurec/models/__init__.py``).

Only ``mmoe`` is ported in this slice; the JAX package's other model names
raise ``NotImplementedError`` and ``ROADMAP.md`` lists when they come.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpurec_torch.config import ModelConfig
from tpurec_torch.device import resolve_device
from tpurec_torch.models.base import AuxLogits, CTRModel
from tpurec_torch.models.mmoe import MMoE
from tpurec_torch.nn.initializers import init_module

MODEL_REGISTRY = {"mmoe": MMoE}

# the JAX package's zoo, still to be ported
_NOT_PORTED = {
    "deepfm", "dcn", "dcnv2", "autoint", "ple", "pepnet", "epnet",
    "pepnet-single", "epnet-single", "star", "adl", "adl-split", "hinet",
    "adasparse", "xdeepfm", "ipnn", "opnn", "afm",
}

# models whose output is [B, n_tower] and whose caller selects the group's
# tower (run.py:481-484)
MULTI_TOWER_OUTPUT = {"mmoe", "ple", "pepnet", "epnet", "star"}


def build_model(name: str, field_dims: Tuple[int, ...], n_tower: int,
                domain_idx: int, cfg: ModelConfig, device=None,
                generator: Optional[torch.Generator] = None) -> CTRModel:
    """Build model ``name`` with torch-default inits drawn from
    ``generator`` (a fresh CPU generator seeded 0 when None) and move it to
    ``device``: the card by default (raises when there is none), ``"cpu"``
    when asked.  The inits are drawn on the CPU, so one seed gives one set
    of weights on either device.  ``device="meta"`` builds shapes only,
    for a caller that loads every weight itself."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to tpurec_torch yet: see "
            "ROADMAP.md, queue 1")
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model: {name}")
    kw = dict(field_dims=tuple(int(d) for d in field_dims),
              embed_dim=cfg.embed_dim, cfg=cfg, n_tower=n_tower,
              domain_idx=domain_idx)
    if device is not None and torch.device(device).type == "meta":
        return MODEL_REGISTRY[name](**kw, device=torch.device("meta"))
    device = resolve_device(device)
    model = MODEL_REGISTRY[name](**kw)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_module(model, generator)
    return model.to(device)


__all__ = ["AuxLogits", "CTRModel", "MMoE", "MODEL_REGISTRY",
           "MULTI_TOWER_OUTPUT", "build_model"]

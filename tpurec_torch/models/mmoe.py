"""MMoE (counterpart of ``tpurec/models/mmoe.py``, reference model/mmoe.py).

Experts and towers are weight banks with a leading expert/tower axis, each
one batched product; the gates are a per-tower softmax over the experts.
"""

from __future__ import annotations

import torch

from tpurec_torch.models.base import AuxLogits, CTRModel
from tpurec_torch.nn.core import StackedLinear, StackedMLP


class MMoE(CTRModel):
    """n_expert shared expert MLPs, per-tower softmax gate, per-tower tower
    MLP + aux logit heads.  Defaults: n_expert=4, expert_dims=(256,128,64),
    tower_dims=(64,32)."""

    def __init__(self, field_dims, embed_dim, cfg, n_tower=1, domain_idx=0,
                 device=None):
        super().__init__(field_dims, embed_dim, cfg, n_tower, domain_idx,
                         device)
        n_expert = cfg.mmoe_n_expert
        in_dim = self.embed_output_dim
        self.experts = StackedMLP(n_expert, in_dim, cfg.mmoe_expert_dims,
                                  output_layer=False, device=device)
        self.gates = StackedLinear(n_tower, in_dim, n_expert, device=device)
        self.towers = StackedMLP(n_tower, cfg.mmoe_expert_dims[-1],
                                 cfg.mmoe_tower_dims, output_layer=True,
                                 device=device)
        self.aux = AuxLogits(cfg, self.field_num, embed_dim, device=device)

    def forward(self, x, group=None, train: bool = False, embed_rows=None):
        """x [B, F] ids -> logits [B, n_tower] (eval)."""
        if train:
            raise NotImplementedError(
                "the training forward (dropout, batch statistics) comes "
                "with the training slice: see ROADMAP.md")
        flat, emb = self.embed(x, embed_rows)
        expert_outs = self.experts(flat)                          # [B, E, H]
        gates = torch.softmax(self.gates(flat), dim=-1)           # [B, T, E]
        tower_inputs = torch.einsum("bte,beh->bth", gates, expert_outs)
        tower_logits = self.towers(tower_inputs)[..., 0]          # [B, T]
        return tower_logits + self.aux(flat, emb)

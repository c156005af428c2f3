"""DCNv2 (counterpart of ``tpurec/models/dcnv2.py``, reference
model/dcnv2.py)."""

from __future__ import annotations

import torch

from tpurec_torch.models.base import CTRModel
from tpurec_torch.nn.core import MLP, Linear
from tpurec_torch.nn.interactions import CrossNetMix, CrossNetV2


class DCNv2(CTRModel):
    """``crossnet`` (CrossNetMix, the default: 4 experts of rank 32; or
    CrossNetV2) in one of three structures (dcnv2.py:35-70):
    ``crossnet_only``, ``stacked`` (the ``dnn`` MLP on the cross output) or
    ``parallel`` (the default: cross output ∥ ``dnn`` on the embeddings);
    then ``dnn_linear`` (no bias) + the first-order ``linear``: [B]."""

    def __init__(self, field_dims, embed_dim, cfg, n_tower=1, domain_idx=0,
                 device=None):
        super().__init__(field_dims, embed_dim, cfg, n_tower, domain_idx,
                         device)
        in_dim = self.embed_output_dim
        if cfg.dcnv2_use_low_rank_mixture:
            self.crossnet = CrossNetMix(in_dim, cfg.n_cross_layers,
                                        cfg.dcnv2_low_rank,
                                        cfg.dcnv2_num_experts, device=device)
        else:
            self.crossnet = CrossNetV2(in_dim, cfg.n_cross_layers,
                                       device=device)
        self.structure = cfg.dcnv2_structure
        mlp_out = cfg.mlp_dims[-1] if cfg.mlp_dims else in_dim
        if self.structure == "crossnet_only":
            final_dim = in_dim
        elif self.structure == "stacked":
            final_dim = mlp_out
        elif self.structure == "parallel":
            final_dim = in_dim + mlp_out
        else:
            raise ValueError(f"unknown dcnv2 structure {self.structure!r}")
        if self.structure != "crossnet_only":
            self.dnn = MLP(in_dim, cfg.mlp_dims, output_layer=False,
                           dropout=cfg.dropout, device=device)
        self.dnn_linear = Linear(final_dim, 1, use_bias=False, device=device)
        self.linear = Linear(in_dim, 1, device=device)

    def forward(self, x, group=None, train: bool = False, row_mask=None,
                embed_rows=None, generator=None):
        flat, _ = self.embed(x, embed_rows)
        cross_out = self.crossnet(flat)
        if self.structure == "crossnet_only":
            final = cross_out
        elif self.structure == "stacked":
            final = self.dnn(cross_out, train, row_mask, generator)
        else:
            final = torch.cat(
                [cross_out, self.dnn(flat, train, row_mask, generator)],
                dim=1)
        return (self.dnn_linear(final) + self.linear(flat))[:, 0]

"""AutoInt (counterpart of ``tpurec/models/autoint.py``, reference
model/autoint.py)."""

from __future__ import annotations

import torch

from tpurec_torch.models.base import CTRModel
from tpurec_torch.nn.core import MLP, Linear
from tpurec_torch.nn.interactions import FieldAttention


class AutoInt(CTRModel):
    """The field-attention stack ``atten`` (kernels 2 and 3 on the card) ∥
    the ``dnn`` MLP, concatenated into ``dnn_linear`` (no bias) + the
    first-order ``linear`` (autoint.py:48-65): [B]."""

    def __init__(self, field_dims, embed_dim, cfg, n_tower=1, domain_idx=0,
                 device=None):
        super().__init__(field_dims, embed_dim, cfg, n_tower, domain_idx,
                         device)
        in_dim = self.embed_output_dim
        self.atten = FieldAttention(
            embed_dim, cfg.atten_embed_dim, cfg.att_layer_num,
            cfg.att_head_num, cfg.att_res, dropout=cfg.dropout,
            device=device)
        self.dnn = MLP(in_dim, cfg.mlp_dims, output_layer=False,
                       dropout=cfg.dropout, device=device)
        mlp_out = cfg.mlp_dims[-1] if cfg.mlp_dims else in_dim
        self.dnn_linear = Linear(self.field_num * cfg.atten_embed_dim
                                 + mlp_out, 1, use_bias=False, device=device)
        self.linear = Linear(in_dim, 1, device=device)

    def forward(self, x, group=None, train: bool = False, row_mask=None,
                embed_rows=None, generator=None):
        flat, emb = self.embed(x, embed_rows)
        cross_term = self.atten(emb, train=train, generator=generator)
        dnn_out = self.dnn(flat, train, row_mask, generator)
        final = torch.cat([cross_term, dnn_out], dim=1)
        return (self.dnn_linear(final) + self.linear(flat))[:, 0]

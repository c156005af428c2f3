"""The zoo's extensions beyond the reference's architectures (counterpart
of ``tpurec/models/extensions.py``): standard models on the interaction
ops the reference ships but never wires into a model.

- :class:`xDeepFM`: linear + CIN + DNN;
- :class:`PNN`: [embeddings ∥ pairwise products] -> DNN, inner products
  (``ipnn``) or kernel outer products (``opnn``);
- :class:`AFM`: linear + attention-pooled pairwise interactions.

All single-head: logits [B].
"""

from __future__ import annotations

import torch

from tpurec_torch.models.base import CTRModel
from tpurec_torch.nn.core import MLP, Linear
from tpurec_torch.nn.interactions import (AttentionalFactorizationMachine,
                                          CompressedInteractionNetwork,
                                          InnerProductNetwork,
                                          OuterProductNetwork)


class xDeepFM(CTRModel):
    """``linear`` + ``cin`` -> ``cin_linear`` (no bias) + ``mlp`` (with its
    output layer), summed logits; CIN sizes and split from
    ``cin_layer_sizes``/``cin_split_half``."""

    def __init__(self, field_dims, embed_dim, cfg, n_tower=1, domain_idx=0,
                 device=None):
        super().__init__(field_dims, embed_dim, cfg, n_tower, domain_idx,
                         device)
        in_dim = self.embed_output_dim
        self.linear = Linear(in_dim, 1, device=device)
        self.cin = CompressedInteractionNetwork(
            self.field_num, cfg.cin_layer_sizes, cfg.cin_split_half,
            device=device)
        self.cin_linear = Linear(self.cin.output_dim, 1, use_bias=False,
                                 device=device)
        self.mlp = MLP(in_dim, cfg.mlp_dims, output_layer=True,
                       dropout=cfg.dropout, device=device)

    def forward(self, x, group=None, train: bool = False, row_mask=None,
                embed_rows=None, generator=None):
        flat, emb = self.embed(x, embed_rows)
        logit = (self.linear(flat) + self.cin_linear(self.cin(emb))
                 + self.mlp(flat, train, row_mask, generator))
        return logit[:, 0]


class PNN(CTRModel):
    """[embeddings ∥ ``product``'s pair features] -> ``mlp`` (with its
    output layer).  ``use_inner``: inner products (``ipnn``), else the
    kernel outer product of ``pnn_kernel_type`` (``opnn``)."""

    def __init__(self, field_dims, embed_dim, cfg, n_tower=1, domain_idx=0,
                 use_inner: bool = True, device=None):
        super().__init__(field_dims, embed_dim, cfg, n_tower, domain_idx,
                         device)
        F = self.field_num
        self.product = (InnerProductNetwork() if use_inner else
                        OuterProductNetwork(F, embed_dim,
                                            cfg.pnn_kernel_type,
                                            device=device))
        self.mlp = MLP(self.embed_output_dim + F * (F - 1) // 2,
                       cfg.mlp_dims, output_layer=True, dropout=cfg.dropout,
                       device=device)

    def forward(self, x, group=None, train: bool = False, row_mask=None,
                embed_rows=None, generator=None):
        flat, emb = self.embed(x, embed_rows)
        h = torch.cat([flat, self.product(emb)], dim=1)
        return self.mlp(h, train, row_mask, generator)[:, 0]


class AFM(CTRModel):
    """``linear`` + ``afm`` (attention-pooled second-order interactions,
    its dropouts from ``afm_dropouts``)."""

    def __init__(self, field_dims, embed_dim, cfg, n_tower=1, domain_idx=0,
                 device=None):
        super().__init__(field_dims, embed_dim, cfg, n_tower, domain_idx,
                         device)
        self.linear = Linear(self.embed_output_dim, 1, device=device)
        self.afm = AttentionalFactorizationMachine(
            embed_dim, cfg.afm_attn_size, cfg.afm_dropouts, device=device)

    def forward(self, x, group=None, train: bool = False, row_mask=None,
                embed_rows=None, generator=None):
        flat, emb = self.embed(x, embed_rows)
        return (self.linear(flat) + self.afm(emb, train, generator))[:, 0]

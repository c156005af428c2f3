"""AdaSparse (counterpart of ``tpurec/models/adasparse.py``, reference
model/adasparse.py).

A domain-conditioned pruned DNN: each layer's activations are multiplied
by a pruner's ``pi = beta * sigmoid(alpha * Linear([h, domain_emb]))``,
set to 0 where ``|pi| <= epsilon``.  The layers' raw ``linear_w_i`` /
``linear_b_i`` keep the JAX package's names; their product is float32
in bf16 mode too (the pruners are Linears and cast).
"""

from __future__ import annotations

import torch
from torch import nn

from tpurec_torch.models.base import AuxLogits, CTRModel
from tpurec_torch.nn import initializers as tinit
from tpurec_torch.nn.core import BatchNorm, Linear, dropout


class AdaSparse(CTRModel):
    """DNN with pruners + linear head + aux heads (``tpurec/models/
    adasparse.py:19-56``): hidden dims ``mlp_dims``, ``linear_w_i`` drawn
    N(0, adasparse_init_std**2), the domain embedding detached in the
    pruner's input.  Returns [B] logits."""

    def __init__(self, field_dims, embed_dim, cfg, n_tower=1, domain_idx=0,
                 device=None):
        super().__init__(field_dims, embed_dim, cfg, n_tower, domain_idx,
                         device)
        self.dims = (self.embed_output_dim,) + tuple(cfg.mlp_dims)
        for i in range(len(cfg.mlp_dims)):
            in_d, out_d = self.dims[i], self.dims[i + 1]
            setattr(self, f"linear_w_{i}", nn.Parameter(torch.empty(
                in_d, out_d, device=device)))
            setattr(self, f"linear_b_{i}", nn.Parameter(torch.empty(
                out_d, device=device)))
            setattr(self, f"pruner_{i}", Linear(in_d + embed_dim, out_d,
                                                device=device))
            setattr(self, f"bn_{i}", BatchNorm((out_d,), device=device))
        self.dnn_linear = Linear(self.dims[-1], 1, device=device)
        self.aux = AuxLogits(cfg, self.field_num, embed_dim, device=device)

    def reset_parameters(self, generator):
        for i in range(len(self.dims) - 1):
            tinit.normal_(getattr(self, f"linear_w_{i}"), generator,
                          self.cfg.adasparse_init_std)
            tinit.linear_uniform_(getattr(self, f"linear_b_{i}"),
                                  self.dims[i], generator)

    def forward(self, x, group=None, train: bool = False, row_mask=None,
                embed_rows=None, generator=None):
        cfg = self.cfg
        flat, emb = self.embed(x, embed_rows)
        domain_embed = emb[:, self.domain_idx, :].detach()
        h = flat
        for i in range(len(self.dims) - 1):
            fc = h @ getattr(self, f"linear_w_{i}") \
                + getattr(self, f"linear_b_{i}")
            pruner_in = torch.cat([h, domain_embed], dim=-1)
            pi = cfg.adasparse_beta * torch.sigmoid(
                cfg.adasparse_alpha * getattr(self, f"pruner_{i}")(pruner_in))
            pi = torch.where(pi.abs() <= cfg.adasparse_epsilon,
                             torch.zeros((), dtype=pi.dtype,
                                         device=pi.device), pi)
            fc = getattr(self, f"bn_{i}")(fc * pi, train, row_mask)
            h = torch.relu(fc)
            if train:
                h = dropout(h, cfg.dropout, generator)
        logit = self.dnn_linear(h) + self.aux(flat, emb, train, generator)
        return logit[:, 0]

"""PEPNet / EPNet and their ``-single`` variants (counterpart of
``tpurec/models/pepnet.py``, reference model/pepnet.py).

- EPNet: a :class:`GateNN` over the detached flat embedding and the
  domain field's embedding scales the flat embedding by ``2 * sigmoid``.
- PPNet: a gate per tower layer scales each tower's layer input.

The JAX package's ``jax.lax.stop_gradient`` is ``.detach()`` here: the
gates' gradients do not reach the gathered rows, so the hybrid step's
table update is tpurec's.  With ``pepnet_share_tower_weights`` (the
default, the reference's ``[module] * n_tower``) each PPNet tower layer is
one Linear [in, out] broadcast over the towers; its BatchNorm still keeps
statistics per (tower, channel).
"""

from __future__ import annotations

import torch
from torch import nn

from tpurec_torch.models.base import AuxLogits, CTRModel
from tpurec_torch.nn.core import (BatchNorm, GateNN, Linear, StackedLinear,
                                  StackedMLP, dropout)


class PPNetBlock(nn.Module):
    """The gated tower stack (``tpurec/models/pepnet.py:27-64``): input
    the flat embedding and the gate's embedding (EPNet's output), both
    [B, in]; output [B, T, tower_dims[-1]]."""

    def __init__(self, in_dim: int, tower_dims, gate_hidden_dim: int,
                 n_tower: int, dropout: float = 0.0,
                 share_tower_weights: bool = True, device=None):
        super().__init__()
        self.n_tower = n_tower
        self.dropout = dropout
        self.n_layers = len(tower_dims)
        dims = (in_dim,) + tuple(tower_dims)
        for i in range(self.n_layers):
            setattr(self, f"gate_{i}", GateNN(
                2 * in_dim, gate_hidden_dim, dims[i] * n_tower, dropout=0.0,
                device=device))
            setattr(self, f"tower_linear_{i}",
                    Linear(dims[i], dims[i + 1], device=device)
                    if share_tower_weights else
                    StackedLinear(n_tower, dims[i], dims[i + 1],
                                  device=device))
            setattr(self, f"tower_bn_{i}",
                    BatchNorm((n_tower, dims[i + 1]), device=device))

    def forward(self, feature_emb, gate_emb, train: bool = False,
                row_mask=None, generator=None):
        B = feature_emb.shape[0]
        T = self.n_tower
        gate_input = torch.cat([feature_emb.detach(), gate_emb], dim=-1)
        x = feature_emb[:, None, :]                          # [B, 1, in]
        for i in range(self.n_layers):
            gw = getattr(self, f"gate_{i}")(gate_input, train, generator)
            h = getattr(self, f"tower_linear_{i}")(
                x * gw.reshape(B, T, -1))
            h = torch.relu(getattr(self, f"tower_bn_{i}")(h, train,
                                                          row_mask))
            if train:
                h = dropout(h, self.dropout, generator)
            x = h
        return x


class PEPNet(CTRModel):
    """PEPNet (``use_ppnet=True``) or EPNet (``use_ppnet=False``)
    (``tpurec/models/pepnet.py:67-114``); ``n_tower = 1`` gives the
    ``-single`` variants, whose logits are [B].  tower_dims=(256, 128,
    64, 32), gate_hidden_dim=64."""

    def __init__(self, field_dims, embed_dim, cfg, n_tower=1, domain_idx=0,
                 use_ppnet: bool = True, device=None):
        super().__init__(field_dims, embed_dim, cfg, n_tower, domain_idx,
                         device)
        in_dim = self.embed_output_dim
        self.use_ppnet = use_ppnet
        self.epnet = GateNN(in_dim + embed_dim, cfg.gate_hidden_dim, in_dim,
                            dropout=cfg.dropout, device=device)
        self.aux = AuxLogits(cfg, self.field_num, embed_dim, device=device)
        if use_ppnet:
            self.ppnet = PPNetBlock(
                in_dim, cfg.tower_dims, cfg.gate_hidden_dim, n_tower,
                cfg.dropout, cfg.pepnet_share_tower_weights, device=device)
        else:
            self.towers = StackedMLP(n_tower, in_dim, cfg.tower_dims,
                                     output_layer=False, dropout=cfg.dropout,
                                     device=device)
        last = cfg.tower_dims[-1] if cfg.tower_dims else in_dim
        self.ppnet_linears = StackedLinear(n_tower, last, 1, use_bias=False,
                                           device=device)

    def forward(self, x, group=None, train: bool = False, row_mask=None,
                embed_rows=None, generator=None):
        """x [B, F] ids -> logits [B, n_tower] ([B] when n_tower == 1)."""
        flat, emb = self.embed(x, embed_rows)
        domain_embed = emb[:, self.domain_idx, :]
        epnet_weight = self.epnet(
            torch.cat([flat.detach(), domain_embed], dim=-1), train,
            generator)
        epnet_out = flat * epnet_weight
        aux = self.aux(flat, emb, train, generator)           # [B, 1]
        if self.use_ppnet:
            h = self.ppnet(flat, epnet_out, train, row_mask, generator)
        else:
            h = self.towers(epnet_out, train, row_mask, generator)
        logits = self.ppnet_linears(h)[..., 0] + aux          # [B, T]
        return logits[:, 0] if self.n_tower == 1 else logits

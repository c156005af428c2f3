"""DCN v1 (counterpart of ``tpurec/models/dcn.py``, reference model/dcn.py).

The cross network and an MLP run side by side on the flattened field
embeddings; their outputs are concatenated into ``mlp_linear`` (no bias)
and added to the first-order ``linear`` term.  Single-head: logits [B].
"""

from __future__ import annotations

import torch

from tpurec_torch.models.base import CTRModel
from tpurec_torch.nn.core import MLP, Linear
from tpurec_torch.nn.interactions import CrossNetwork


class DCN(CTRModel):
    """CrossNetwork ∥ MLP -> concat -> linear head + first-order linear
    term (dcn.py:36-43); n_cross_layers=3 (run.py:321), mlp_dims=(256, 128,
    64) (config.py:18)."""

    def __init__(self, field_dims, embed_dim, cfg, n_tower=1, domain_idx=0,
                 device=None):
        super().__init__(field_dims, embed_dim, cfg, n_tower, domain_idx,
                         device)
        in_dim = self.embed_output_dim
        self.cn = CrossNetwork(in_dim, cfg.n_cross_layers, device=device)
        self.mlp = MLP(in_dim, cfg.mlp_dims, output_layer=False,
                       dropout=cfg.dropout, device=device)
        mlp_out = cfg.mlp_dims[-1] if cfg.mlp_dims else in_dim
        self.linear = Linear(in_dim, 1, device=device)
        self.mlp_linear = Linear(in_dim + mlp_out, 1, use_bias=False,
                                 device=device)

    def forward(self, x, group=None, train: bool = False, row_mask=None,
                embed_rows=None, generator=None):
        """x [B, F] ids -> logits [B] (``tpurec/models/dcn.py:17-29``).
        Training uses batch statistics weighted by ``row_mask`` and MLP
        dropout with draws from ``generator`` (on x's device)."""
        flat, _ = self.embed(x, embed_rows)
        cn_out = self.cn(flat)
        mlp_out = self.mlp(flat, train, row_mask, generator)
        stack = torch.cat([cn_out, mlp_out], dim=1)
        return (self.linear(flat) + self.mlp_linear(stack))[:, 0]

"""HiNet (counterpart of ``tpurec/models/hinet.py``, reference model/hinet.py).

The n_tower specific SEIs (each an expert_num-expert MoE) are one
StackedMLP bank of n_tower * expert_num experts with a StackedLinear gate
bank; the shared SEI is a bank of expert_num experts with a Linear gate;
the SAN gate mixes the specific features by the domain embedding; each
row's own scenario features are a one-hot product of its group.  The
gate mixings are float32 products, as in the JAX package (bf16 mode casts
in the Linears alone).
"""

from __future__ import annotations

import torch

from tpurec_torch.models.base import AuxLogits, CTRModel
from tpurec_torch.nn.core import MLP, Linear, StackedLinear, StackedMLP


class HiNet(CTRModel):
    """SEI banks + SAN gate + one tower head (``tpurec/models/hinet.py:
    19-78``).  Returns [B] logits: ``group`` selects the scenario
    features, tower 0 when it is None, none (a one-hot of zeros, as
    ``jax.nn.one_hot`` gives) when it is outside [0, n_tower)."""

    def __init__(self, field_dims, embed_dim, cfg, n_tower=1, domain_idx=0,
                 device=None):
        super().__init__(field_dims, embed_dim, cfg, n_tower, domain_idx,
                         device)
        T, E = n_tower, cfg.sei_expert_num
        in_dim = self.embed_output_dim
        H = cfg.sei_dims[-1]
        self.specific_experts = StackedMLP(T * E, in_dim, cfg.sei_dims,
                                           output_layer=False,
                                           dropout=cfg.dropout,
                                           device=device)
        self.specific_gates = StackedLinear(T, in_dim, E, device=device)
        self.shared_experts = StackedMLP(E, in_dim, cfg.sei_dims,
                                         output_layer=False,
                                         dropout=cfg.dropout, device=device)
        self.shared_gate = Linear(in_dim, E, device=device)
        self.san_gate = Linear(embed_dim, T, device=device)
        self.tower = MLP(3 * H, cfg.tower_dims, output_layer=False,
                         dropout=cfg.dropout, device=device)
        self.tower_linear = Linear(cfg.tower_dims[-1], 1, use_bias=False,
                                   device=device)
        self.aux = AuxLogits(cfg, self.field_num, embed_dim, device=device)

    def forward(self, x, group=None, train: bool = False, row_mask=None,
                embed_rows=None, generator=None):
        flat, emb = self.embed(x, embed_rows)
        B, T = flat.shape[0], self.n_tower
        E, H = self.cfg.sei_expert_num, self.cfg.sei_dims[-1]
        domain_embed = emb[:, self.domain_idx, :]
        if group is None:
            group = torch.zeros(B, dtype=torch.long, device=flat.device)

        # specific SEIs: T banks x E experts in one pass
        spec_outs = self.specific_experts(flat, train, row_mask,
                                          generator).reshape(B, T, E, H)
        spec_gates = torch.softmax(self.specific_gates(flat), dim=-1)
        specific = torch.einsum("bte,bteh->bth", spec_gates, spec_outs)

        # shared SEI
        shared_outs = self.shared_experts(flat, train, row_mask,
                                          generator)            # [B, E, H]
        shared_gate = torch.softmax(self.shared_gate(flat), dim=-1)
        shared = torch.einsum("be,beh->bh", shared_gate, shared_outs)

        # SAN: scenario-aware mixture keyed on the domain embedding
        san_gate = torch.softmax(self.san_gate(domain_embed), dim=-1)
        san = torch.einsum("bt,bth->bh", san_gate, specific)

        # own-scenario features: one-hot select
        onehot = (group.long()[:, None] == torch.arange(
            T, device=flat.device)).to(flat.dtype)
        own = torch.einsum("bt,bth->bh", onehot, specific)

        feature = torch.cat([shared, own, san], dim=1)
        tower_out = self.tower(feature, train, row_mask, generator)
        logit = self.tower_linear(tower_out) + self.aux(flat, emb, train,
                                                        generator)
        return logit[:, 0]

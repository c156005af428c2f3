"""ADL (counterpart of ``tpurec/models/adl.py``, reference model/adl.py),
for ``adl`` and ``adl-split``.

The distribution learning module routes each row to the tower whose
cluster centre is most similar to its detached embedding (a softmax of
``flat . centers^T``, then argmax: the first maximum on a tie, in both
packages); each tower is one bank of a StackedMLP whose BatchNorms take
their statistics over the rows routed to it, and the final linear is
``domain_linear_w * shared_linear_w`` fused.

The centres are the buffer ``cluster_centers`` [T, F*D], drawn N(0, 1);
the JAX package keeps them in the ``adl_state`` collection, which
:mod:`tpurec_torch.convert` maps by this name.  As there:

- the training forward moves them in place (no gradient): the softmax
  weights' sum of the rows, L2-normalised, blended by
  ``dlm_update_rate`` with the entry value and L2-normalised again; eval
  never moves them (the JAX package's documented divergence from the
  reference, ``tpurec/models/adl.py:12-14``);
- that update sums over EVERY row of the batch, padded rows included
  (``adl.py:61-66`` reads no ``row_mask``), while the tower BatchNorms
  take the routed rows under ``row_mask`` alone.

The similarity, centre update and tower products are float32 in bf16
mode too; only the StackedMLP's Linears cast.
"""

from __future__ import annotations

import torch
from torch import nn

from tpurec_torch.models.base import AuxLogits, CTRModel
from tpurec_torch.nn import initializers as tinit
from tpurec_torch.nn.core import StackedMLP


def _l2norm(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)


class ADL(CTRModel):
    """Returns [B] logits, each row through its routed tower
    (``tpurec/models/adl.py:39-89``)."""

    def __init__(self, field_dims, embed_dim, cfg, n_tower=1, domain_idx=0,
                 device=None):
        super().__init__(field_dims, embed_dim, cfg, n_tower, domain_idx,
                         device)
        T, in_d = n_tower, cfg.tower_dims[-1]
        self.register_buffer("cluster_centers", torch.empty(
            T, self.embed_output_dim, device=device))
        self.domain_mlps = StackedMLP(T, self.embed_output_dim,
                                      cfg.tower_dims, output_layer=False,
                                      dropout=cfg.dropout, device=device)

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        self.domain_linear_w = param(T, in_d, 1)
        self.domain_linear_b = param(T, 1)
        self.shared_linear_w = param(in_d, 1)
        self.shared_linear_b = param(1)
        self.aux = AuxLogits(cfg, self.field_num, embed_dim, device=device)

    def reset_parameters(self, generator):
        tinit.normal_(self.cluster_centers, generator)
        for name in ("domain_linear_w", "domain_linear_b", "shared_linear_w",
                     "shared_linear_b"):
            tinit.linear_uniform_(getattr(self, name),
                                  self.cfg.tower_dims[-1], generator)

    def forward(self, x, group=None, train: bool = False, row_mask=None,
                embed_rows=None, generator=None):
        flat, emb = self.embed(x, embed_rows)
        T = self.n_tower
        with torch.no_grad():
            embed_sg = flat.detach()
            c = self.cluster_centers
            coeff = torch.softmax(embed_sg @ c.T, dim=1)          # [B, T]
            if train:
                rate = self.cfg.dlm_update_rate
                tmp = _l2norm(coeff.T @ embed_sg)
                c.copy_(_l2norm(rate * c + (1 - rate) * tmp))
            routing = torch.argmax(coeff, dim=1)
            onehot = (routing[:, None] == torch.arange(
                T, device=flat.device)).to(flat.dtype)
        bn_mask = onehot if row_mask is None else onehot * row_mask[:, None]
        tower_out = self.domain_mlps(flat, train, bn_mask, generator)
        logits_t = torch.einsum(
            "bth,tho->bto", tower_out,
            self.domain_linear_w * self.shared_linear_w[None])[..., 0] \
            + (self.domain_linear_b + self.shared_linear_b[None])[None, :, 0]
        logits_t = logits_t + self.aux(flat, emb, train, generator)
        return torch.sum(logits_t * onehot, dim=1)

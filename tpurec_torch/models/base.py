"""Shared model scaffolding (counterpart of ``tpurec/models/base.py``).

Output contract, as in the JAX package: multi-tower models return logits
[B, n_tower] and the caller selects each row's tower by its group id
(:func:`tpurec_torch.train.step.select_tower`).  Models emit logits.

:class:`AuxLogits` is the auxiliary logit of every tower model: the
first-order linear term plus, when ``use_atten`` (the default), the
field-attention head.  ``train=True`` runs the training forward
(``tpurec/models/base.py:50-66``): attention dropout with draws from the
caller's generator.
"""

from __future__ import annotations

from typing import Tuple

from torch import nn

from tpurec_torch.config import ModelConfig
from tpurec_torch.nn.core import FusedEmbedding, Linear
from tpurec_torch.nn.interactions import FieldAttention


class AuxLogits(nn.Module):
    """Sum of the auxiliary scalar logit heads shared by the tower models:
    ``linear`` on the flattened embeddings, and ``atten`` (field-attention
    stack) -> ``atten_linear`` (no bias) when ``cfg.use_atten``."""

    def __init__(self, cfg: ModelConfig, field_num: int, embed_dim: int,
                 device=None):
        super().__init__()
        if cfg.use_dcn:
            raise NotImplementedError(
                "use_dcn=True needs the cross-network kernel, which comes "
                "with the DCN slice: see ROADMAP.md")
        self.linear = Linear(field_num * embed_dim, 1, device=device)
        if cfg.use_atten:
            self.atten = FieldAttention(
                embed_dim, cfg.atten_embed_dim, cfg.att_layer_num,
                cfg.att_head_num, cfg.att_res, dropout=cfg.dropout,
                device=device)
            self.atten_linear = Linear(field_num * cfg.atten_embed_dim, 1,
                                       use_bias=False, device=device)
        else:
            self.atten = None

    def forward(self, embed_flat, embed_3d, train: bool = False,
                generator=None):
        out = self.linear(embed_flat)
        if self.atten is not None:
            out = out + self.atten_linear(
                self.atten(embed_3d, train=train, generator=generator))
        return out  # [B, 1]


class CTRModel(nn.Module):
    """Base of the zoo models: the fused embedding and shared attributes.

    Subclasses implement ``forward(x, group=None, train=False,
    row_mask=None, embed_rows=None, generator=None)``; ``row_mask`` ([B]
    0/1) marks padding rows, which then take no part in the BatchNorm
    statistics.
    """

    def __init__(self, field_dims: Tuple[int, ...], embed_dim: int,
                 cfg: ModelConfig, n_tower: int = 1, domain_idx: int = 0,
                 device=None):
        super().__init__()
        self.field_dims = tuple(int(d) for d in field_dims)
        self.embed_dim = embed_dim
        self.cfg = cfg
        self.n_tower = n_tower
        self.domain_idx = domain_idx
        self.embedding = FusedEmbedding(self.field_dims, embed_dim,
                                        init_std=cfg.embed_init_std,
                                        device=device)

    @property
    def field_num(self) -> int:
        return len(self.field_dims)

    @property
    def embed_output_dim(self) -> int:
        return self.field_num * self.embed_dim

    def embed(self, x, embed_rows=None):
        """-> ([B, F*D] flat, [B, F, D]).

        ``embed_rows`` ([B*F, D] or [B, F, D]) are rows gathered already
        (the Predictor gathers from its quantised table; the training step
        gathers outside autograd and differentiates with respect to the
        rows); without them the model's own table is looked up.
        """
        if embed_rows is not None:
            emb = embed_rows.reshape(x.shape[0], self.field_num,
                                     self.embed_dim)
        else:
            emb = self.embedding(x)
        return emb.reshape(emb.shape[0], -1), emb

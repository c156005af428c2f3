"""DeepFM (counterpart of ``tpurec/models/deepfm.py``, reference
model/dfm.py)."""

from __future__ import annotations

from tpurec_torch.models.base import CTRModel
from tpurec_torch.nn.core import MLP, Linear
from tpurec_torch.nn.interactions import FactorizationMachine


class DeepFM(CTRModel):
    """First-order ``linear`` + second-order FM + ``mlp`` (with its output
    layer), summed logits (dfm.py:30-35): [B]."""

    def __init__(self, field_dims, embed_dim, cfg, n_tower=1, domain_idx=0,
                 device=None):
        super().__init__(field_dims, embed_dim, cfg, n_tower, domain_idx,
                         device)
        in_dim = self.embed_output_dim
        self.linear = Linear(in_dim, 1, device=device)
        self.fm = FactorizationMachine()
        self.mlp = MLP(in_dim, cfg.mlp_dims, output_layer=True,
                       dropout=cfg.dropout, device=device)

    def forward(self, x, group=None, train: bool = False, row_mask=None,
                embed_rows=None, generator=None):
        flat, emb = self.embed(x, embed_rows)
        logit = (self.linear(flat) + self.fm(emb)
                 + self.mlp(flat, train, row_mask, generator))
        return logit[:, 0]

"""STAR (counterpart of ``tpurec/models/star.py``, reference
model/star.py).

A star-topology network: each domain tower's layer weight is the
elementwise product of its own weight with a shared one, its bias the sum
of the two.  Partitioned normalisation is one BatchNorm per tower whose
scale is ``weight * shared_weight`` and shift ``bias + shared_bias``.

All towers run over the whole batch as one tower-batched product; each
tower's BatchNorm statistics are taken over its group's rows
(``group_onehot * row_mask``).  Without ``group`` (CDC calls its base so)
every tower normalises over the whole batch.

The raw parameters keep the JAX package's names (``domain_w_i``,
``domain_b_i``, ``shared_w_i``, ``shared_b_i``, ``domain_linear_w/b``,
``shared_linear_w/b``), which :mod:`tpurec_torch.convert` and
:mod:`tpurec_torch.train.reg` rely on.
"""

from __future__ import annotations

import torch
from torch import nn

from tpurec_torch.models.base import AuxLogits, CTRModel
from tpurec_torch.nn import initializers as tinit
from tpurec_torch.nn.core import BatchNorm, dropout


class PartitionedNorm(nn.Module):
    """One BatchNorm per domain tower with a shared scale and shift fused
    in (``tpurec/models/star.py:25-63``).  Input [B, C] and the [B, T]
    group one-hot; output [B, T, C], slice t normalised by tower t's
    statistics.  Buffers ``mean``/``var`` [T, C] move only where a group
    had rows; no batch-of-one skip, no ``num_batches_tracked``."""

    momentum = 0.1
    eps = 1e-5

    def __init__(self, n_tower: int, C: int, device=None):
        super().__init__()
        self.shared_weight = nn.Parameter(torch.ones(C, device=device))
        self.shared_bias = nn.Parameter(torch.zeros(C, device=device))
        self.weight = nn.Parameter(torch.ones(n_tower, C, device=device))
        self.bias = nn.Parameter(torch.zeros(n_tower, C, device=device))
        self.register_buffer("mean", torch.zeros(n_tower, C, device=device))
        self.register_buffer("var", torch.ones(n_tower, C, device=device))

    def reset_parameters(self, generator):
        with torch.no_grad():
            for p in (self.shared_weight, self.weight):
                p.fill_(1.0)
            for p in (self.shared_bias, self.bias):
                p.zero_()

    def forward(self, x, group_onehot, train: bool = False, row_mask=None):
        xt = x[:, None, :]                                   # [B, 1, C]
        if train:
            m = group_onehot if row_mask is None else \
                group_onehot * row_mask[:, None]
            w = m[:, :, None]                                # [B, T, 1]
            n = w.sum(dim=0)                                 # [T, 1]
            n_safe = torch.clamp(n, min=1.0)
            mean = (w * xt).sum(dim=0) / n_safe
            var = (w * torch.square(xt - mean[None])).sum(dim=0) / n_safe
            with torch.no_grad():
                mo = self.momentum
                unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
                has_rows = (n > 0).to(x.dtype)
                self.mean.add_(mo * has_rows * (mean - self.mean))
                self.var.add_(mo * has_rows * (unbiased - self.var))
        else:
            mean, var = self.mean, self.var
        return (xt - mean[None]) * torch.rsqrt(var + self.eps) \
            * (self.weight * self.shared_weight)[None] \
            + (self.bias + self.shared_bias)[None]


class STAR(CTRModel):
    """STAR (``tpurec/models/star.py:66-119``): PN -> the star network of
    ``tower_dims`` per tower (BatchNorm over each group's rows, ReLU,
    dropout) -> the star output layer + aux heads.  Output [B, T]."""

    def __init__(self, field_dims, embed_dim, cfg, n_tower=1, domain_idx=0,
                 device=None):
        super().__init__(field_dims, embed_dim, cfg, n_tower, domain_idx,
                         device)
        T = n_tower
        self.dims = (self.embed_output_dim,) + tuple(cfg.tower_dims)
        self.aux = AuxLogits(cfg, self.field_num, embed_dim, device=device)
        self.pn = PartitionedNorm(T, self.embed_output_dim, device=device)

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        for i in range(len(cfg.tower_dims)):
            i_d, o_d = self.dims[i], self.dims[i + 1]
            setattr(self, f"domain_w_{i}", param(T, i_d, o_d))
            setattr(self, f"domain_b_{i}", param(T, o_d))
            setattr(self, f"shared_w_{i}", param(i_d, o_d))
            setattr(self, f"shared_b_{i}", param(o_d))
            setattr(self, f"dnn_bn_{i}", BatchNorm((T, o_d), device=device))
        last = self.dims[-1]
        self.domain_linear_w = param(T, last, 1)
        self.domain_linear_b = param(T, 1)
        self.shared_linear_w = param(last, 1)
        self.shared_linear_b = param(1)

    def _star_params(self):
        """(name, fan_in) of the star network's raw parameters."""
        for i in range(len(self.dims) - 1):
            for kind in ("domain_w", "domain_b", "shared_w", "shared_b"):
                yield f"{kind}_{i}", self.dims[i]
        for name in ("domain_linear_w", "domain_linear_b",
                     "shared_linear_w", "shared_linear_b"):
            yield name, self.dims[-1]

    def reset_parameters(self, generator):
        for name, fan_in in self._star_params():
            tinit.linear_uniform_(getattr(self, name), fan_in, generator)

    def forward(self, x, group=None, train: bool = False, row_mask=None,
                embed_rows=None, generator=None):
        """x [B, F] ids -> logits [B, n_tower].  A group outside [0, T)
        has a row of zeros in the one-hot, as ``jax.nn.one_hot`` gives."""
        flat, emb = self.embed(x, embed_rows)
        B, T = flat.shape[0], self.n_tower
        if group is None:
            onehot = torch.ones(B, T, dtype=flat.dtype, device=flat.device)
        else:
            onehot = (group.long()[:, None] == torch.arange(
                T, device=flat.device)).to(flat.dtype)
        aux = self.aux(flat, emb, train, generator)
        h = self.pn(flat, onehot, train, row_mask)           # [B, T, C]
        bn_mask = onehot if row_mask is None else onehot * row_mask[:, None]
        for i in range(len(self.dims) - 1):
            w = getattr(self, f"domain_w_{i}") * getattr(self,
                                                         f"shared_w_{i}")
            b = getattr(self, f"domain_b_{i}") + getattr(self,
                                                         f"shared_b_{i}")
            h = torch.einsum("bti,tio->bto", h, w) + b[None]
            h = torch.relu(getattr(self, f"dnn_bn_{i}")(h, train, bn_mask))
            if train:
                h = dropout(h, self.cfg.dropout, generator)
        logit = torch.einsum("bti,tio->bto", h,
                             self.domain_linear_w * self.shared_linear_w) \
            + (self.domain_linear_b + self.shared_linear_b)[None]
        return logit[..., 0] + aux

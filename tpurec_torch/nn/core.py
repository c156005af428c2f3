"""Core NN building blocks of the port (counterpart of ``tpurec/nn/core.py``).

Parameters keep the JAX package's names, shapes and layouts, so a flax
parameter tree maps onto a ``state_dict`` by joining its path with dots
(:mod:`tpurec_torch.convert`):

- :class:`Linear` stores ``weight`` as [in, out] (flax's layout, not
  torch's [out, in]) and computes ``x @ weight + bias``.
- :class:`StackedLinear` is a bank of ``n_stack`` Linears, weight
  [T, in, out], computed as one batched product.
- :class:`BatchNorm` holds ``scale``/``bias`` parameters and ``mean``/
  ``var``/``num_batches_tracked`` buffers of the JAX module's shapes; it
  normalises with the running statistics in eval and with masked batch
  statistics in training.
- :func:`dropout` is flax's, with its draws from an explicit generator.
- :class:`EmbeddingLayout` is the same row layout of the fused table
  (small-vocab fields first, rows padded to 8), so tables copy verbatim.
- :func:`mixed_table_lookup` is one launch of the gather kernel.

Modules are built with ``torch.empty`` parameters; ``reset_parameters``
draws the torch-default inits from an explicit generator
(:func:`tpurec_torch.nn.initializers.init_module` calls them all).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tpurec_torch.nn import initializers as tinit
from tpurec_torch.ops.embedding import embedding_gather


class Linear(nn.Module):
    """Dense layer with torch nn.Linear default init, weight [in, out]."""

    def __init__(self, in_dim: int, features: int, use_bias: bool = True,
                 device=None):
        super().__init__()
        self.in_dim = in_dim
        self.weight = nn.Parameter(torch.empty(in_dim, features,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device))
                     if use_bias else None)

    def reset_parameters(self, generator):
        tinit.linear_uniform_(self.weight, self.in_dim, generator)
        if self.bias is not None:
            tinit.linear_uniform_(self.bias, self.in_dim, generator)

    def forward(self, x):
        y = torch.matmul(x, self.weight)
        return y if self.bias is None else y + self.bias


class StackedLinear(nn.Module):
    """A bank of ``n_stack`` Linear layers, weight [T, in, out].

    Input [B, in] broadcasts to every stack entry; input [B, T, in] applies
    entry t to slice [:, t, :].  Output is [B, T, out].
    """

    def __init__(self, n_stack: int, in_dim: int, features: int,
                 device=None):
        super().__init__()
        self.in_dim = in_dim
        self.weight = nn.Parameter(torch.empty(n_stack, in_dim, features,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(n_stack, features,
                                             device=device))

    def reset_parameters(self, generator):
        tinit.linear_uniform_(self.weight, self.in_dim, generator)
        tinit.linear_uniform_(self.bias, self.in_dim, generator)

    def forward(self, x):
        if x.dim() == 2:
            y = torch.einsum("bi,tio->bto", x, self.weight)
        elif x.dim() == 3:
            y = torch.einsum("bti,tio->bto", x, self.weight)
        else:
            raise ValueError(
                f"StackedLinear expects rank-2/3 input, got {tuple(x.shape)}")
        return y + self.bias[None]


class BatchNorm(nn.Module):
    """BatchNorm1d with the JAX module's layout and torch semantics
    (``tpurec/nn/core.py:96-160``).

    Statistics have shape ``stat_shape`` (x.shape[1:]: a stacked input
    [B, T, C] keeps one BN per tower).  Eval normalises with the running
    statistics.  Training normalises with the batch statistics over axis 0
    (biased variance), weighted by ``mask`` ([B], 0/1) when given, and
    updates the running ones with momentum 0.1 and the unbiased variance —
    with a mask, only where at least one row contributed — and counts
    ``num_batches_tracked``.  A batch of one row with no mask passes
    through unchanged, as the JAX module skips BN at batch size 1.
    """

    momentum = 0.1

    def __init__(self, stat_shape: Tuple[int, ...], eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.eps = eps
        C = stat_shape[-1]
        self.scale = nn.Parameter(torch.ones(C, device=device))
        self.bias = nn.Parameter(torch.zeros(C, device=device))
        self.register_buffer("mean", torch.zeros(stat_shape, device=device))
        self.register_buffer("var", torch.ones(stat_shape, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.int32,
                                         device=device))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x, train: bool = False, mask=None):
        if x.shape[0] == 1 and mask is None:
            return x
        if not train:
            mean, var = self.mean, self.var
        else:
            if mask is None:
                n = torch.tensor(float(x.shape[0]), dtype=x.dtype,
                                 device=x.device)
                mean = x.mean(dim=0)
                var = torch.square(x - mean).mean(dim=0)
            else:
                m = mask.to(x.dtype)
                w = m.reshape(m.shape + (1,) * (x.dim() - m.dim())) \
                    .expand_as(x)
                n = w.sum(dim=0)
                n_safe = torch.clamp(n, min=1.0)
                mean = (w * x).sum(dim=0) / n_safe
                var = (w * torch.square(x - mean)).sum(dim=0) / n_safe
            with torch.no_grad():
                mo = self.momentum
                unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
                if mask is None:
                    self.mean.copy_((1 - mo) * self.mean + mo * mean)
                    self.var.copy_((1 - mo) * self.var + mo * unbiased)
                else:
                    has_rows = (n > 0).to(x.dtype)
                    self.mean.add_(mo * has_rows * (mean - self.mean))
                    self.var.add_(mo * has_rows * (unbiased - self.var))
                self.num_batches_tracked.add_(1)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale \
            + self.bias


def dropout(x, rate: float, generator: Optional[torch.Generator]):
    """flax ``nn.Dropout``: keep each value with probability 1 - rate and
    scale kept values by 1/(1 - rate); the uniform draws come from
    ``generator`` (on ``x``'s device)."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                             device=x.device))


class MLP(nn.Module):
    """[Linear -> BN -> ReLU -> Dropout]* [+ Linear(1)]
    (``tpurec/nn/core.py:163-185``); dropout acts in training only."""

    def __init__(self, in_dim: int, layer_dims: Sequence[int],
                 output_layer: bool = True, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.n_layers = len(layer_dims)
        self.dropout = dropout
        for i, dim in enumerate(layer_dims):
            setattr(self, f"linear_{i}", Linear(in_dim, dim, device=device))
            setattr(self, f"bn_{i}", BatchNorm((dim,), device=device))
            in_dim = dim
        self.linear_out = (Linear(in_dim, 1, device=device)
                           if output_layer else None)

    def forward(self, x, train: bool = False, mask=None, generator=None):
        for i in range(self.n_layers):
            x = getattr(self, f"linear_{i}")(x)
            x = torch.relu(getattr(self, f"bn_{i}")(x, train, mask))
            if train:
                x = dropout(x, self.dropout, generator)
        return x if self.linear_out is None else self.linear_out(x)


class StackedMLP(nn.Module):
    """A bank of per-tower/per-expert MLPs computed as batched products
    (``tpurec/nn/core.py:188-215``).

    Input [B, in] or [B, T, in]; output [B, T, out_dim] (out_dim=1 if
    ``output_layer``).  ``mask`` [B] weights the BN statistics.
    """

    def __init__(self, n_stack: int, in_dim: int, layer_dims: Sequence[int],
                 output_layer: bool = True, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.n_layers = len(layer_dims)
        self.dropout = dropout
        for i, dim in enumerate(layer_dims):
            setattr(self, f"linear_{i}",
                    StackedLinear(n_stack, in_dim, dim, device=device))
            setattr(self, f"bn_{i}", BatchNorm((n_stack, dim), device=device))
            in_dim = dim
        self.linear_out = (StackedLinear(n_stack, in_dim, 1, device=device)
                           if output_layer else None)

    def forward(self, x, train: bool = False, mask=None, generator=None):
        for i in range(self.n_layers):
            x = getattr(self, f"linear_{i}")(x)
            x = torch.relu(getattr(self, f"bn_{i}")(x, train, mask))
            if train:
                x = dropout(x, self.dropout, generator)
        return x if self.linear_out is None else self.linear_out(x)


SMALL_VOCAB_THRESHOLD = 8192
ROW_PAD = 8


class EmbeddingLayout:
    """Row layout of the fused table: small-vocab fields first, padded vocab.

    The same layout as ``tpurec/nn/core.py::EmbeddingLayout`` (the
    checkpoint tag ``smallfirst-v2``), so the JAX package's tables load
    row for row.  ``row_limits`` gives each field the row range the JAX
    lookup gathers it from (the small-field prefix or the whole table),
    which fixes where an out-of-range id wraps or fills.
    """

    def __init__(self, field_dims):
        self.field_dims = tuple(int(d) for d in field_dims)
        self.small_fields = tuple(f for f, d in enumerate(self.field_dims)
                                  if d <= SMALL_VOCAB_THRESHOLD)
        self.big_fields = tuple(f for f, d in enumerate(self.field_dims)
                                if d > SMALL_VOCAB_THRESHOLD)
        offsets = np.zeros(len(self.field_dims), np.int64)
        pos = 0
        for f in self.small_fields + self.big_fields:
            offsets[f] = pos
            pos += self.field_dims[f]
        self.offsets = offsets.astype(np.int32)
        self.n_rows = pos                       # true rows
        self.small_rows = int(sum(self.field_dims[f] for f in self.small_fields))
        self.vocab = -(-pos // ROW_PAD) * ROW_PAD  # padded rows
        self._device_arrays: Dict[Tuple[str, int], Tuple[torch.Tensor, ...]] = {}

    def row_limits(self, n_table_rows: int) -> np.ndarray:
        """[F] int32: rows each field's lookup may address."""
        lim = np.full(len(self.field_dims), n_table_rows, np.int32)
        if self.small_fields and self.big_fields:
            lim[list(self.small_fields)] = self.small_rows
        return lim

    def device_arrays(self, device, n_table_rows: int):
        """(offsets, limits) as int32 tensors on ``device`` (cached)."""
        key = (str(torch.device(device)), int(n_table_rows))
        if key not in self._device_arrays:
            self._device_arrays[key] = (
                torch.as_tensor(self.offsets, device=device),
                torch.as_tensor(self.row_limits(n_table_rows), device=device))
        return self._device_arrays[key]


def mixed_table_lookup(table: torch.Tensor, ids: torch.Tensor,
                       layout: EmbeddingLayout,
                       scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ids [B, F] (field-local, int32) -> float32 rows [B, F, D].

    The JAX function splits the lookup into a small-prefix and a full-table
    gather (a TPU speed trick); the rows are the same, so here it is one
    launch of the gather kernel, with per-field row limits that keep
    ``jnp.take``'s out-of-range results.  ``scales`` dequantises an int8
    table.
    """
    offsets, limits = layout.device_arrays(table.device, table.shape[0])
    return embedding_gather(table, ids.to(torch.int32).contiguous(),
                            offsets, limits, scales)


class FusedEmbedding(nn.Module):
    """One fused embedding table over all categorical fields.

    ids[b, f] reads row ``offsets[f] + ids[b, f]`` of a [vocab, embed_dim]
    table laid out by :class:`EmbeddingLayout`; padding rows are zero.
    """

    def __init__(self, field_dims, embed_dim: int,
                 init_std: Optional[float] = None, device=None):
        super().__init__()
        self.layout = EmbeddingLayout(field_dims)
        self.init_std = init_std
        self.table = nn.Parameter(torch.empty(self.layout.vocab, embed_dim,
                                              device=device))

    def reset_parameters(self, generator):
        tinit.normal_(self.table, generator, self.init_std)
        with torch.no_grad():
            self.table[self.layout.n_rows:] = 0.0

    def forward(self, ids):
        """ids [B, F] -> rows [B, F, D]."""
        return mixed_table_lookup(self.table, ids, self.layout)

"""Core NN building blocks of the port (counterpart of ``tpurec/nn/core.py``).

Parameters keep the JAX package's names, shapes and layouts, so a flax
parameter tree maps onto a ``state_dict`` by joining its path with dots
(:mod:`tpurec_torch.convert`):

- :class:`Linear` stores ``weight`` as [in, out] (flax's layout, not
  torch's [out, in]) and computes ``x @ weight + bias``.
- :class:`StackedLinear` is a bank of ``n_stack`` Linears, weight
  [T, in, out], computed as one batched product.
- Those two round their operands to the compute dtype
  (:func:`tpurec_torch.nn.precision.cast_operands`), as the JAX
  package's do (``tpurec/nn/core.py:58,83``); nothing else here casts.
- :class:`GateNN` is PEPNet's ``2 * sigmoid`` gate.
- :class:`FeaturesLinear` is the first-order term, a ``Linear(in, 1)``
  named ``fc`` on the flattened embeddings; :func:`activation` maps an
  activation's name to its function.
- :class:`BatchNorm` holds ``scale``/``bias`` parameters and ``mean``/
  ``var``/``num_batches_tracked`` buffers of the JAX module's shapes; it
  normalises with the running statistics in eval and with masked batch
  statistics in training.
- :func:`dropout` is flax's, with its draws from an explicit generator.
- :class:`EmbeddingLayout` is the same row layout of the fused table
  (small-vocab fields first, rows padded to 8), so tables copy verbatim.
- :func:`mixed_table_lookup` is one launch of the gather kernel;
  :meth:`EmbeddingLayout.gather` prepares it once for a table.

On a mesh (:mod:`tpurec_torch.parallel`) the training forward runs
inside :func:`tpurec_torch.parallel.collectives.mesh_scope`: BatchNorm
then takes its statistics over the global batch (its sums all-reduced
over the data group), and a :class:`FusedEmbedding` whose table is one
shard of the rows (``shard``) gathers its window and sums the rows over
the model group.  A :class:`StackedMLP` expert bank split over the
model axis (``expert_shard``, :mod:`tpurec_torch.parallel.experts`) runs
its own stacks and returns every stack (:func:`split_bank_forward`).

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
from tpurec_torch.nn.precision import cast_operands
from tpurec_torch.ops.embedding import EmbeddingGather
from tpurec_torch.parallel.collectives import (copy_to_model, current_mesh,
                                               data_all_reduce,
                                               gather_from_model,
                                               scatter_to_model)
from tpurec_torch.parallel.embedding import sharded_embedding_lookup


def activation(name: str):
    """str -> activation function (``tpurec/nn/core.py:34-45``)."""
    name = name.lower()
    if name == "relu":
        return torch.relu
    if name == "sigmoid":
        return torch.sigmoid
    if name == "linear":
        return lambda x: x
    if name == "tanh":
        return torch.tanh
    raise NotImplementedError(f"activation {name!r}")


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
        xc, wc = cast_operands(x, self.weight)
        y = torch.matmul(xc, wc)
        return y if self.bias is None else y + self.bias


class StackedLinear(nn.Module):
    """A bank of ``n_stack`` Linear layers, weight [T, in, out] (bias [T,
    out] unless ``use_bias=False``).

    Input [B, in] broadcasts to every stack entry; input [B, T, in] applies
    entry t to slice [:, t, :].  Output is [B, T, out].
    """

    def __init__(self, n_stack: int, in_dim: int, features: int,
                 use_bias: bool = True, device=None):
        super().__init__()
        self.in_dim = in_dim
        self.weight = nn.Parameter(torch.empty(n_stack, in_dim, features,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(n_stack, features,
                                              device=device))
                     if use_bias else None)

    def reset_parameters(self, generator):
        tinit.linear_uniform_(self.weight, self.in_dim, generator)
        if self.bias is not None:
            tinit.linear_uniform_(self.bias, self.in_dim, generator)

    def forward(self, x):
        xc, wc = cast_operands(x, self.weight)
        if x.dim() == 2:
            y = torch.einsum("bi,tio->bto", xc, wc)
        elif x.dim() == 3:
            y = torch.einsum("bti,tio->bto", xc, wc)
        else:
            raise ValueError(
                f"StackedLinear expects rank-2/3 input, got {tuple(x.shape)}")
        return y if self.bias is None else y + self.bias[None]


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

    Inside a :func:`~tpurec_torch.parallel.collectives.mesh_scope` with a
    data group, the batch is the global one: the count and the (masked)
    sum are all-reduced over the data group for the mean, then the
    centred sum of squares for the variance (the JAX module's two passes),
    and the one-row skip reads the global batch size.  The running
    statistics then update identically on every rank.
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
        mesh = current_mesh()
        n_data = 1 if mesh is None else mesh.n_data
        if x.shape[0] * n_data == 1 and mask is None:
            return x
        if not train:
            mean, var = self.mean, self.var
        elif mask is None and n_data == 1:
            n = torch.tensor(float(x.shape[0]), dtype=x.dtype,
                             device=x.device)
            mean = x.mean(dim=0)
            var = torch.square(x - mean).mean(dim=0)
        else:
            mean, var, n = global_moments(x, mask, mesh)
        if train:
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


def global_moments(x, mask, mesh):
    """(mean, biased variance, count) over axis 0 of the global batch
    whose rows ``x`` [B_local, ...] are this data rank's, weighted by
    ``mask`` [B_local] (or [B_local, T] for a bank, ``x`` broadcasting
    over T) when given.  Without a data group (``mesh`` None or n_data 1)
    the batch is ``x``'s own and no collective runs."""
    stat = x.shape[1:]
    if mask is None:
        w = None
        s = x.sum(dim=0)
        n_l = torch.full(stat, float(x.shape[0]), dtype=x.dtype,
                         device=x.device)
    else:
        m = mask.to(x.dtype)
        w = m.reshape(m.shape + (1,) * (x.dim() - m.dim()))
        s = (w * x).sum(dim=0)
        n_l = w.sum(dim=0).expand_as(s)
    sn = data_all_reduce(torch.stack([s, n_l.detach()]), mesh)
    n = sn[1].detach()
    n_safe = torch.clamp(n, min=1.0)
    mean = sn[0] / n_safe
    sq = torch.square(x - mean)
    q = (sq if w is None else w * sq).sum(dim=0)
    var = data_all_reduce(q, mesh) / n_safe
    return mean, var, n


def dropout(x, rate: float, generator: Optional[torch.Generator],
            stacks=None):
    """flax ``nn.Dropout``: keep each value with probability 1 - rate and
    scale kept values by 1/(1 - rate); the uniform draws come from
    ``generator`` (on ``x``'s device).  ``stacks`` (a
    :class:`~tpurec_torch.parallel.experts.BankShard`): ``x`` [B, E/n, ...]
    holds this rank's stacks of a bank; the draws are the whole bank's
    [B, E, ...] and this rank keeps its slice, so the generator advances
    as without the split."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    shape = x.shape if stacks is None else (
        (x.shape[0], stacks.n_stack) + tuple(x.shape[2:]))
    u = torch.rand(shape, generator=generator, device=x.device,
                   dtype=x.dtype)
    if stacks is not None:
        u = u.narrow(1, stacks.lo, stacks.n_local)
    keep = u >= rate
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
        return _mlp_layers(self, x, train, mask, generator)


class StackedMLP(nn.Module):
    """A bank of per-tower/per-expert MLPs computed as batched products
    (``tpurec/nn/core.py:188-215``).

    Input [B, in] or [B, T, in]; output [B, T, out_dim] (out_dim=1 if
    ``output_layer``).  ``mask`` [B] or [B, T] weights the BN statistics;
    ``use_bn=False`` leaves BN out.  ``expert_shard`` (None: whole) is set
    when the bank is split over the model axis
    (:func:`tpurec_torch.parallel.experts.split_expert_banks`).
    """

    def __init__(self, n_stack: int, in_dim: int, layer_dims: Sequence[int],
                 output_layer: bool = True, dropout: float = 0.0,
                 use_bn: bool = True, device=None):
        super().__init__()
        self.n_stack = n_stack
        self.n_layers = len(layer_dims)
        self.dropout = dropout
        self.expert_shard = None
        for i, dim in enumerate(layer_dims):
            setattr(self, f"linear_{i}",
                    StackedLinear(n_stack, in_dim, dim, device=device))
            if use_bn:
                setattr(self, f"bn_{i}", BatchNorm((n_stack, dim),
                                                   device=device))
            in_dim = dim
        self.linear_out = (StackedLinear(n_stack, in_dim, 1, device=device)
                           if output_layer else None)

    def forward(self, x, train: bool = False, mask=None, generator=None):
        if self.expert_shard is not None:
            return split_bank_forward(self, x, train, mask, generator)
        return _mlp_layers(self, x, train, mask, generator)


def split_bank_forward(bank, x, train, mask, generator):
    """The forward of a bank split over the model axis: the input through
    :func:`~tpurec_torch.parallel.collectives.copy_to_model` ([B, in]) or
    this rank's stacks of it (:func:`~tpurec_torch.parallel.collectives.
    scatter_to_model`, [B, E, in]; a [B, E] mask likewise), this rank's
    stacks, then every stack's output [B, E, H] through
    :func:`~tpurec_torch.parallel.collectives.gather_from_model`.  Each
    stack computes what it computes in the whole bank; BatchNorm updates
    this rank's running statistics only."""
    shard = bank.expert_shard
    mesh = shard.mesh
    x = copy_to_model(x, mesh) if x.dim() == 2 else scatter_to_model(x, mesh)
    if mask is not None and mask.dim() == 2:
        mask = mask.narrow(1, shard.lo, shard.n_local)
    y = _mlp_layers(bank, x, train, mask, generator, shard)
    return gather_from_model(y, mesh)


def _mlp_layers(mlp, x, train, mask, generator, stacks=None):
    """The layers of an :class:`MLP` or :class:`StackedMLP` (``stacks``:
    a split bank's :class:`~tpurec_torch.parallel.experts.BankShard`)."""
    for i in range(mlp.n_layers):
        x = getattr(mlp, f"linear_{i}")(x)
        bn = getattr(mlp, f"bn_{i}", None)
        if bn is not None:
            x = bn(x, train, mask)
        x = torch.relu(x)
        if train:
            x = dropout(x, mlp.dropout, generator, stacks)
    return x if mlp.linear_out is None else mlp.linear_out(x)


class GateNN(nn.Module):
    """PEPNet's gate (``tpurec/nn/core.py:344-358``): ``fc1`` -> ReLU ->
    dropout (training only) -> ``fc2`` -> ``2 * sigmoid``."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.dropout = dropout
        self.fc1 = Linear(in_dim, hidden_dim, device=device)
        self.fc2 = Linear(hidden_dim, output_dim, device=device)

    def forward(self, x, train: bool = False, generator=None):
        h = torch.relu(self.fc1(x))
        if train:
            h = dropout(h, self.dropout, generator)
        return 2.0 * torch.sigmoid(self.fc2(h))


class FeaturesLinear(nn.Module):
    """First-order term (``tpurec/nn/core.py:335-341``): ``fc``, a
    Linear(in_dim -> 1), on the flattened embeddings [B, in_dim]."""

    def __init__(self, in_dim: int, device=None):
        super().__init__()
        self.fc = Linear(in_dim, 1, device=device)

    def forward(self, flat_embed):
        return self.fc(flat_embed)


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

    def gather(self, table: torch.Tensor,
               scales: Optional[torch.Tensor] = None,
               window=None) -> EmbeddingGather:
        """The lookup of :func:`mixed_table_lookup` prepared for ``table``
        (and its int8 ``scales``): call it with int32 ids [B, F].
        ``window`` ``(row_lo, n_table_rows)``: ``table`` holds those rows
        of an ``n_table_rows``-row table, and a row outside reads zero."""
        row_lo, V = window or (0, table.shape[0])
        offsets, limits = self.device_arrays(table.device, V)
        return EmbeddingGather(table, offsets, limits, scales, row_lo, V)


def mixed_table_lookup(table: torch.Tensor, ids: torch.Tensor,
                       layout: EmbeddingLayout,
                       scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ids [B, F] (field-local, int32) -> float32 rows [B, F, D].

    The JAX function splits the lookup into a small-prefix and a full-table
    gather (a TPU speed trick); the rows are the same, so here it is one
    launch of the gather kernel, with per-field row limits that keep
    ``jnp.take``'s out-of-range results.  ``scales`` dequantises an int8
    table.  One-shot: a caller that looks up the same table again holds
    ``layout.gather(table, scales)`` instead.
    """
    return layout.gather(table, scales)(ids.to(torch.int32).contiguous())


def prepared_gather(holder, table: torch.Tensor, layout: EmbeddingLayout,
                    window=None) -> EmbeddingGather:
    """``holder``'s gather of ``table``, prepared at the first call and
    again only when the table is another tensor or has moved to another
    device, shape or type, or the window changed
    (:meth:`EmbeddingGather.serves`).  ``window``: ``(row_lo,
    n_table_rows)`` when ``table`` is one shard of the rows."""
    g = getattr(holder, "_gather", None)
    if g is None or not g.serves(table, window):
        g = holder._gather = layout.gather(table, window=window)
    return g


class FusedEmbedding(nn.Module):
    """One fused embedding table over all categorical fields.

    ids[b, f] reads row ``offsets[f] + ids[b, f]`` of a [vocab, embed_dim]
    table laid out by :class:`EmbeddingLayout`; padding rows are zero.
    Where autograd records, the table takes the rows' gradients
    (:func:`tpurec_torch.ops.embedding.embedding_lookup`: the ``"dense"``
    update differentiates through the lookup).

    ``shard`` (a :class:`tpurec_torch.parallel.embedding.TableShard`, set
    when the table is replaced by one shard of its rows): the lookup
    gathers the shard's window and sums the rows over the model group.
    """

    def __init__(self, field_dims, embed_dim: int,
                 init_std: Optional[float] = None, device=None):
        super().__init__()
        self.layout = EmbeddingLayout(field_dims)
        self.init_std = init_std
        self.table = nn.Parameter(torch.empty(self.layout.vocab, embed_dim,
                                              device=device))
        self.shard = None

    def reset_parameters(self, generator):
        tinit.normal_(self.table, generator, self.init_std)
        with torch.no_grad():
            self.table[self.layout.n_rows:] = 0.0

    def forward(self, ids):
        """ids [B, F] -> rows [B, F, D]."""
        shard = self.shard
        return sharded_embedding_lookup(
            prepared_gather(self, self.table, self.layout,
                            None if shard is None else shard.window),
            ids, shard)

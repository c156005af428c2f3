"""The embedding table row-sharded over the mesh's model axis (counterpart
of ``tpurec/parallel/embedding.py:30-73``).

:func:`shard_table` pads the table's V rows up to a multiple of
``n_model`` and keeps this rank's block of rows, ``[row_lo, row_lo +
V_pad / n_model)``: a :class:`TableShard` records where it lies.  The
padding rows are zero; no id reaches them (the gather's limits stay those
of the V-row table), and :meth:`TableShard.gather` drops them.

:func:`sharded_embedding_lookup`, which the models' embedding and the
hybrid and sparse updates call, is kernel 1 over the shard's window (a
row outside it reads zero, in the same launch) and then the model
group's all-reduce (:func:`tpurec_torch.parallel.collectives.
model_all_reduce`, backward the identity): every id's row lives in one
shard, so the sum is the lookup.  Batch rows stay with their data rank;
only the gathered [B_local, F, D] rows cross between model ranks.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpurec_torch.ops.embedding import EmbeddingGather, embedding_lookup
from tpurec_torch.parallel.collectives import all_gather, model_all_reduce


class TableShard:
    """This rank's rows of a ``V``-row table over ``mesh``'s model axis:
    ``[row_lo, row_lo + n_local)``, ``n_local = V_pad / n_model``."""

    def __init__(self, V: int, mesh):
        n = mesh.n_model
        self.mesh = mesh
        self.V = int(V)
        self.V_pad = -(-self.V // n) * n
        self.n_local = self.V_pad // n
        self.row_lo = mesh.m * self.n_local
        self.window = (self.row_lo, self.V)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """A [V, ...] tensor -> this shard's [n_local, ...] rows (a copy;
        the padding rows are zero)."""
        if full.shape[0] != self.V:
            raise ValueError(f"expected {self.V} rows, got {full.shape[0]}")
        out = torch.zeros((self.n_local,) + tuple(full.shape[1:]),
                          dtype=full.dtype, device=full.device)
        hi = min(self.row_lo + self.n_local, self.V)
        if hi > self.row_lo:
            out[:hi - self.row_lo] = full[self.row_lo:hi]
        return out

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """Every model rank's [n_local, ...] rows -> the [V, ...] tensor
        (a collective of the model group; the padding rows dropped)."""
        if local.shape[0] != self.n_local:
            raise ValueError(f"expected {self.n_local} rows, got "
                             f"{local.shape[0]}")
        full = all_gather(local.contiguous(), self.mesh.model_group,
                          self.mesh.n_model, self.mesh.m)
        return full[:self.V]

    def exchange(self, *tensors: torch.Tensor):
        """Each tensor [B_local, ...] of every data rank, concatenated in
        data-rank order, which is the global batch's (unchanged without a
        data group)."""
        mesh = self.mesh
        if mesh.data_group is None:
            return tensors
        return tuple(all_gather(t.contiguous(), mesh.data_group,
                                mesh.n_data, mesh.d) for t in tensors)

    def small_rows(self, S: int) -> int:
        """How many of this shard's rows lie in the global prefix [0, S)."""
        return max(0, min(S - self.row_lo, self.n_local))


def table_shard(model) -> Optional[TableShard]:
    """``model``'s :class:`TableShard` (its ``embedding.shard``), or None
    when it holds the whole table."""
    return getattr(getattr(model, "embedding", None), "shard", None)


def shard_table(table: torch.Tensor, mesh):
    """A [V, D] table -> (this rank's [V_pad / n_model, D] rows, its
    :class:`TableShard`)."""
    shard = TableShard(table.shape[0], mesh)
    return shard.local(table), shard


def sharded_embedding_lookup(gather: EmbeddingGather, ids: torch.Tensor,
                             shard: Optional[TableShard] = None
                             ) -> torch.Tensor:
    """``gather``: kernel 1 prepared on this rank's rows of the table (its
    window ``shard.window``); ``ids`` [B, F] -> the rows [B, F, D] of the
    whole table, replicated over the model group (``shard`` None: the
    table is whole and no collective runs).  A float32 table that
    requires its gradient takes it through the lookup (only its own
    rows)."""
    ids = ids.to(torch.int32).contiguous()
    if torch.is_grad_enabled() and gather.table.requires_grad:
        rows = embedding_lookup(gather, ids)
    else:
        rows = gather(ids)
    return rows if shard is None else model_all_reduce(rows, shard.mesh)

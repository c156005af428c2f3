"""The embedding table's optimizer state and the ``"sparse"`` update's
table step (counterpart of ``tpurec/train/sparse.py``).

- :class:`SparseEmbedState` holds the table's Adam moments ``m``/``v``
  (float32, or bfloat16 storage with float32 math);
- :func:`init_sparse_opt_state` makes zero moments beside a table
  (``sparse.py:226-232``; the dense parameters' Adam is a
  ``torch.optim.Adam``, :func:`tpurec_torch.train.step.make_optimizer`);
- :func:`combine_duplicate_rows` sorts the touched ids and sums each id's
  gradients (``sparse.py:58-77``);
- :class:`LazyAdamRows` is the ``"sparse"`` update's lazy Adam on the
  touched rows (``sparse.py:180-207``), which the step
  :class:`tpurec_torch.train.hybrid.SparseTrainStep` runs after its
  dense Adam.

The lazy Adam is plain PyTorch on either device, as the JAX package's is
jnp: no kernel of the port runs it.  Rows the batch does not touch, and
their moments, stay bitwise unchanged; their moments do not decay between
touches and the embedding L2 and weight decay reach only touched rows
(``sparse.py:19-25``: the lazy-Adam trade).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from tpurec_torch.config import TrainConfig
from tpurec_torch.nn.core import EmbeddingLayout

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# above this many table rows the "scatter" dedup's O(vocab) pass loses to
# the sort (sparse.py:81); the flagship's 1.63M rows take "scatter"
SORT_DEDUP_VOCAB = 4_000_000


@dataclasses.dataclass
class SparseEmbedState:
    m: torch.Tensor
    v: torch.Tensor


def moments_dtype(name: str) -> torch.dtype:
    """``TrainConfig.embedding_moments_dtype`` -> torch dtype."""
    if name not in _MOMENT_DTYPES:
        raise ValueError(f"embedding_moments_dtype must be one of "
                         f"{sorted(_MOMENT_DTYPES)}, got {name!r}")
    return _MOMENT_DTYPES[name]


def init_sparse_opt_state(table: torch.Tensor,
                          moments_dtype_name: str = "float32"
                          ) -> SparseEmbedState:
    """Zero moments of ``table``'s shape on its device (two buffers)."""
    dt = moments_dtype(moments_dtype_name)
    return SparseEmbedState(
        m=torch.zeros(table.shape, dtype=dt, device=table.device),
        v=torch.zeros(table.shape, dtype=dt, device=table.device))


def combine_duplicate_rows(ids: torch.Tensor, g_rows: torch.Tensor,
                           vocab_size: int):
    """Sort ``ids`` [N] (stably) and sum the gradients ``g_rows`` [N, D] of
    equal ids, in sorted order.  -> (seg_ids [N]: segment j's id, or
    ``vocab_size`` for the segments past the last; g_unique [N, D]: segment
    j's summed gradient, zero past the last; valid [N] bool)."""
    N = ids.shape[0]
    sid, order = torch.sort(ids, stable=True)
    sg = g_rows.index_select(0, order)
    head = torch.ones(N, dtype=torch.bool, device=ids.device)
    head[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    g_u = torch.zeros_like(sg).index_add_(0, seg, sg)
    id_u = torch.full((N,), vocab_size, dtype=ids.dtype,
                      device=ids.device).scatter_(0, seg, sid)
    valid = torch.arange(N, device=ids.device) <= seg[-1]
    return id_u, g_u, valid


class LazyAdamRows:
    """The ``"sparse"`` update's table step (``sparse.py:180-207``): Adam
    on the rows the batch touched, each row once with its gradients summed,
    with the global step's bias corrections.  The L2 (``2 * l2_emb``) and
    the weight decay ``wd`` are added to the touched rows' gradients.

    ``dedup`` picks how equal ids are combined: ``"scatter"`` adds every
    row gradient into a zero [V, D] tensor and reads each occurrence's sum
    back (every occurrence of a row then writes the same values);
    ``"sort"`` is :func:`combine_duplicate_rows` over the touched rows.
    None picks ``"sort"`` above :data:`SORT_DEDUP_VOCAB` table rows, else
    ``"scatter"``."""

    def __init__(self, field_dims, tcfg: TrainConfig,
                 l2_reg_embedding: float, dedup: Optional[str] = None):
        layout = EmbeddingLayout(field_dims)
        self.offsets = layout.offsets
        self.vocab = layout.vocab
        if dedup is None:
            dedup = "sort" if self.vocab > SORT_DEDUP_VOCAB else "scatter"
        if dedup not in ("sort", "scatter"):
            raise ValueError(f"unknown dedup {dedup!r}")
        self.dedup = dedup
        self.tcfg = tcfg
        self.coef = 2.0 * l2_reg_embedding + tcfg.wd
        self._offsets: Dict[str, torch.Tensor] = {}

    def _flat_ids(self, x: torch.Tensor) -> torch.Tensor:
        key = str(x.device)
        if key not in self._offsets:
            self._offsets[key] = torch.as_tensor(
                self.offsets, dtype=torch.int64, device=x.device)
        return (x.to(torch.int64) + self._offsets[key]).reshape(-1)

    @torch.no_grad()
    def update(self, table: torch.Tensor, emb_opt: SparseEmbedState,
               x: torch.Tensor, rows: torch.Tensor, g_rows: torch.Tensor,
               step: int) -> None:
        """One lazy-Adam step of ``table`` and ``emb_opt``, in place, given
        the batch's ids ``x`` [B, F], the rows gathered for it ``rows``
        [B*F, D] and their gradients; ``step`` is Adam's 1-based count."""
        tcfg = self.tcfg
        D = table.shape[1]
        flat_ids = self._flat_ids(x)
        g_rows = g_rows.reshape(-1, D).to(torch.float32)
        if self.dedup == "scatter":
            g_u = torch.zeros_like(table).index_add_(
                0, flat_ids, g_rows).index_select(0, flat_ids)
            ids, p = flat_ids, rows.reshape(-1, D)
        else:
            seg_ids, g_u, valid = combine_duplicate_rows(flat_ids, g_rows,
                                                         self.vocab)
            n = int(valid.sum())
            ids, g_u = seg_ids[:n], g_u[:n]
            p = table.index_select(0, ids)
        g_u = g_u + self.coef * p
        b1, b2 = tcfg.adam_b1, tcfg.adam_b2
        m_u = (b1 * emb_opt.m.index_select(0, ids).to(torch.float32)
               + (1 - b1) * g_u)
        v_u = (b2 * emb_opt.v.index_select(0, ids).to(torch.float32)
               + (1 - b2) * torch.square(g_u))
        t = torch.tensor(float(step), dtype=torch.float32,
                         device=table.device)
        m_hat = m_u / (1 - b1 ** t)
        v_hat = v_u / (1 - b2 ** t)
        upd = tcfg.lr * m_hat / (torch.sqrt(v_hat) + tcfg.adam_eps)
        table.index_copy_(0, ids, p - upd)
        emb_opt.m.index_copy_(0, ids, m_u.to(emb_opt.m.dtype))
        emb_opt.v.index_copy_(0, ids, v_u.to(emb_opt.v.dtype))

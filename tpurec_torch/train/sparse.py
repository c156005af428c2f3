"""The embedding table's optimizer state (counterpart of the parts of
``tpurec/train/sparse.py`` the hybrid update shares with it).

- :class:`SparseEmbedState` holds the table's Adam moments ``m``/``v``
  (float32, or bfloat16 storage with float32 math);
- :func:`combine_duplicate_rows` sorts row ids and sums duplicate rows'
  gradients with static shapes (``sparse.py:58-74``);
- :func:`init_sparse_opt_state` makes zero moments beside a table
  (``sparse.py:226-232``; the dense parameters' Adam is a
  ``torch.optim.Adam``, :func:`tpurec_torch.train.step.make_optimizer`).
"""

from __future__ import annotations

import dataclasses

import torch

from tpurec_torch.ops.fused_adam import dedup_sorted

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


# (ids [N], g_rows [N, D], vocab_size) -> (id_u: sorted unique ids, then
# the sentinel vocab_size; g_u: their summed gradients; valid [N] bool)
combine_duplicate_rows = dedup_sorted


def init_sparse_opt_state(table: torch.Tensor,
                          moments_dtype_name: str = "float32"
                          ) -> SparseEmbedState:
    """Zero moments of ``table``'s shape on its device (two buffers)."""
    dt = moments_dtype(moments_dtype_name)
    return SparseEmbedState(
        m=torch.zeros(table.shape, dtype=dt, device=table.device),
        v=torch.zeros(table.shape, dtype=dt, device=table.device))

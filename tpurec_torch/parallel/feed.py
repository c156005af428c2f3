"""Each data rank's rows of the global batches (counterpart of
``tpurec/parallel/feed.py:31-186``).

In the JAX package a process feeds the data blocks of its local devices
and ``jax.make_array_from_process_local_data`` assembles global arrays.
PyTorch has no global array: a rank is one process with one data
coordinate ``d``, and its rows of a global batch of ``bs`` rows are the
``d``-th slice of ``bs / n_data``.  So here:

- :func:`process_shard` is the JAX package's even split of a dataset;
- :class:`GlobalBatchFeed` gives this rank's dataset range and rows a
  step, and moves its rows to its device (``global_batch`` and
  ``global_stacked_batch`` return this rank's rows, not a global array).
  The ranks of one data block (its model replicas) must hold the same
  rows: :meth:`GlobalBatchFeed.check_replicas` compares them;
- :func:`epoch_plan` is the JAX package's: the batch count comes from the
  GLOBAL row count, so every rank runs the same number of collective
  steps.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def process_shard(n_rows: int, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> Tuple[int, int]:
    """[start, end) row range of this process's dataset shard (default:
    this rank of the world): rows split as evenly as possible, the first
    ``n_rows % P`` shards one row longer."""
    ready = dist.is_initialized()
    pi = ((dist.get_rank() if ready else 0) if process_index is None
          else process_index)
    pc = ((dist.get_world_size() if ready else 1) if process_count is None
          else process_count)
    if not 0 <= pi < pc:
        raise ValueError(f"process_index {pi} not in [0, {pc})")
    base, extra = divmod(n_rows, pc)
    start = pi * base + min(pi, extra)
    return start, start + base + (1 if pi < extra else 0)


class GlobalBatchFeed:
    """This rank's share of global row-split batches over ``mesh``'s data
    axis."""

    def __init__(self, mesh, data_axis: str = "data"):
        if data_axis not in mesh.axis_names:
            raise ValueError(f"mesh has no {data_axis!r} axis: "
                             f"{mesh.axis_names}")
        self.mesh = mesh
        self.data_axis = data_axis
        self.n_data = mesh.shape[data_axis]
        self.d = mesh.d
        self._validate_process_layout()

    def _validate_process_layout(self):
        """A rank owns exactly one data block: its coordinate must lie on
        the mesh, and the mesh must span the process group (when one was
        joined)."""
        world = (dist.get_world_size() if dist.is_initialized()
                 else self.mesh.size)
        if self.mesh.size != world or not 0 <= self.d < self.n_data:
            raise ValueError(f"{self.mesh} does not span the {world} ranks")

    def dataset_range(self, n_rows: int) -> Tuple[int, int]:
        """[start, end) dataset rows this rank should load: its data
        block's, ``d * n_rows // n_data`` up to the next block's (the JAX
        package's split of a [n_rows] array over the data axis)."""
        return (self.d * n_rows // self.n_data,
                (self.d + 1) * n_rows // self.n_data)

    def local_rows_per_step(self, global_rows: int) -> int:
        """Rows this rank supplies for a global batch of ``global_rows``."""
        if global_rows % self.n_data:
            raise ValueError(f"global batch {global_rows} not divisible by "
                             f"data axis {self.n_data}")
        return global_rows // self.n_data

    def check_replicas(self, X: np.ndarray) -> None:
        """Raise unless every rank of this rank's model group holds the
        same ``X`` (a checksum's max and min over the group)."""
        group = self.mesh.model_group
        if group is None:
            return
        a = np.asarray(X, np.float64).reshape(-1)
        w = np.arange(1, a.size + 1, dtype=np.float64) % 9973 + 1
        c = float(a.size) + float(a @ w) if a.size else 0.0
        t = torch.tensor([c, -c], dtype=torch.float64,
                         device=self.mesh.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        if float(t[0]) != -float(t[1]):
            raise ValueError(
                f"model replicas of data block {self.d} hold different "
                "rows: every rank of one data block must load the same "
                "dataset range")

    def global_batch(self, local_batch: Dict[str, np.ndarray],
                     global_rows: int) -> Dict[str, torch.Tensor]:
        """This rank's rows [global_rows / n_data, ...] of every entry, on
        its device."""
        return self._put(local_batch, global_rows, 0)

    def global_stacked_batch(self, local_batch: Dict[str, np.ndarray],
                             global_rows: int) -> Dict[str, torch.Tensor]:
        """The same for scan-stacked [K, rows, ...] entries (rows on
        axis 1)."""
        return self._put(local_batch, global_rows, 1)

    def _put(self, batch, global_rows: int, axis: int):
        want = self.local_rows_per_step(global_rows)
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            if v.shape[axis] != want:
                raise ValueError(f"{k}: {v.shape[axis]} rows, this rank "
                                 f"supplies {want} of {global_rows}")
            out[k] = torch.as_tensor(v).to(self.mesh.device,
                                           non_blocking=True)
        return out


def epoch_plan(n_global_rows: int, bs_global: int, feed: GlobalBatchFeed
               ) -> Tuple[int, int]:
    """(n_batches, local_rows_per_batch) for one multi-rank epoch: the
    batch count from the GLOBAL row count, as every rank must run the
    same number of collective steps; each rank pads its stream with
    masked rows."""
    if n_global_rows <= 0:
        raise ValueError("empty epoch")
    n_batches = -(-n_global_rows // bs_global)
    return n_batches, feed.local_rows_per_step(bs_global)

"""The (data, model) mesh over ``torch.distributed`` (counterpart of
``tpurec/parallel/mesh.py:28-134``).

The JAX package builds a ``jax.sharding.Mesh`` and lets GSPMD place its
collectives.  The port follows PyTorch's idiom: one process per rank,
explicit collectives (:mod:`tpurec_torch.parallel.collectives`).  The
layout is the JAX package's:

- ``data`` axis: each data rank takes its slice of every global batch;
  dense gradients, BatchNorm statistics and the loss's denominator are
  summed over the data group (the ranks of one model coordinate);
- ``model`` axis: the fused embedding table and its table-shaped moments
  are split by rows over the model group (the ranks of one data
  coordinate); with ``Shardings(expert_parallel=True)`` the expert banks
  split their leading axis over it too
  (:mod:`tpurec_torch.parallel.experts`); every other parameter is
  replicated.

Ranks are laid out row-major, ``np.arange(world).reshape(n_data,
n_model)``, as the JAX package lays out its devices: rank ``r`` is
``(d, m) = divmod(r, n_model)``.

:func:`init_distributed` joins the process group that ``torchrun``
(``python -m torch.distributed.run``) describes in ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``.  A rank runs on
card ``LOCAL_RANK % device_count`` unless the caller asks for the CPU.
The backend is NCCL when every local rank has a card of its own, and gloo
when ranks share a card or run on the CPU; the choice is printed and
returned.  Under NCCL the group is bound to the rank's card, and
:func:`barrier` names it.  ``timeout`` bounds every collective's wait: a
rank whose peer raised or hung fails after it (NCCL's watchdog ends the
process) instead of waiting out the backend's default.
:func:`shutdown_distributed` tears the group down; every rank calls it
before it exits (a group left to interpreter exit can abort the process
or hang it).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpurec_torch.device import resolve_device
from tpurec_torch.parallel.experts import in_expert_bank, split_expert_banks


@dataclasses.dataclass(frozen=True)
class Distributed:
    """What :func:`init_distributed` chose."""
    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: str
    reason: str


_JOINED: Optional[Distributed] = None


def choose_backend(device: torch.device, local_world: int,
                   n_cards: int) -> Tuple[str, str]:
    """-> (backend, why): NCCL when every local rank has a card of its
    own, else gloo (ranks sharing a card, or on the CPU)."""
    if device.type == "cpu":
        return "gloo", "ranks on the CPU"
    if local_world <= n_cards:
        return "nccl", f"{local_world} local ranks on {n_cards} cards"
    return "gloo", (f"{local_world} local ranks share {n_cards} card"
                    f"{'s' if n_cards > 1 else ''}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(device=None, timeout=None) -> Distributed:
    """Join the process group of this launch (once; later calls return
    the first one's choice).  ``device``: "cpu" puts the rank on the CPU;
    else the rank takes card ``LOCAL_RANK % device_count`` (raising when
    there is none).  ``timeout`` (seconds or a ``timedelta``; None: the
    backend's default) bounds each collective's wait.  Without a
    launcher's ``MASTER_ADDR`` a world of one joins on a free localhost
    port."""
    global _JOINED
    if _JOINED is not None:
        return _JOINED
    env = os.environ
    rank = int(env.get("RANK", 0))
    world = int(env.get("WORLD_SIZE", 1))
    local_rank = int(env.get("LOCAL_RANK", 0))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
        n_cards = 0
    else:
        resolve_device("cuda")          # raises without a card
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    chosen, why = choose_backend(dev, local_world, n_cards)
    init_method = "env://"
    if not dist.is_initialized():
        if "MASTER_ADDR" not in env:
            if world != 1:
                raise RuntimeError(
                    f"WORLD_SIZE {world} without MASTER_ADDR/MASTER_PORT: "
                    "launch with python -m torch.distributed.run")
            init_method = f"tcp://127.0.0.1:{_free_port()}"
        extra = {}
        if timeout is not None:
            extra["timeout"] = (timeout if isinstance(timeout,
                                                      datetime.timedelta)
                                else datetime.timedelta(seconds=timeout))
        if chosen == "nccl":
            extra["device_id"] = dev
        dist.init_process_group(chosen, init_method=init_method, rank=rank,
                                world_size=world, **extra)
    _JOINED = Distributed(rank, world, local_rank, dev, chosen, why)
    print(f"tpurec_torch.parallel: rank {rank} of {world} on {dev}, "
          f"backend {chosen} ({why})", flush=True)
    return _JOINED


def shutdown_distributed() -> None:
    """Tear down this process's group (a no-op when none is joined); a
    later :func:`init_distributed` joins anew."""
    global _JOINED
    if dist.is_initialized():
        dist.destroy_process_group()
    _JOINED = None


def barrier(device: Optional[torch.device] = None) -> None:
    """``torch.distributed.barrier()`` over the world; under NCCL on
    ``device``, the rank's card (None: the current one)."""
    if dist.get_backend() != "nccl":
        dist.barrier()
        return
    index = (device.index if device is not None and device.index is not None
             else torch.cuda.current_device())
    dist.barrier(device_ids=[index])


def joined() -> Optional[Distributed]:
    """The choice of :func:`init_distributed` in this process, or None."""
    return _JOINED


def mesh_layout(n_data: int, n_model: int) -> np.ndarray:
    """[n_data, n_model] global ranks, row-major."""
    return np.arange(n_data * n_model).reshape(n_data, n_model)


class Mesh:
    """This rank's place on a (data, model) mesh and its two groups.

    ``d``, ``m``: the rank's coordinates; ``data_ranks`` the ranks of its
    model coordinate (its data group), ``model_ranks`` those of its data
    coordinate (its model group), each in coordinate order.  A group of
    one rank is None (:mod:`tpurec_torch.parallel.collectives` skips it).
    ``shape`` maps axis names to sizes, as ``jax.sharding.Mesh.shape``."""

    def __init__(self, n_data: int, n_model: int, rank: int,
                 device: torch.device, backend: str, data_group=None,
                 model_group=None, data_axis: str = "data",
                 model_axis: str = "model"):
        self.n_data, self.n_model = n_data, n_model
        self.rank = rank
        self.d, self.m = divmod(rank, n_model)
        layout = mesh_layout(n_data, n_model)
        self.data_ranks = tuple(int(r) for r in layout[:, self.m])
        self.model_ranks = tuple(int(r) for r in layout[self.d, :])
        self.device = device
        self.backend = backend
        self.data_group = data_group
        self.model_group = model_group
        self.axis_names = (data_axis, model_axis)
        self.shape = {data_axis: n_data, model_axis: n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    def __repr__(self) -> str:
        return (f"Mesh(data={self.n_data}, model={self.n_model}, rank "
                f"{self.rank} = ({self.d}, {self.m}), {self.device}, "
                f"{self.backend})")


def make_mesh(n_data: int = 0, n_model: int = 1, world: Optional[int] = None,
              device=None, data_axis: str = "data",
              model_axis: str = "model") -> Mesh:
    """The (data, model) mesh over every rank of the process group (a
    world of one when none was joined), with the JAX package's checks:
    ``n_data <= 0`` takes every rank left after ``n_model``, and the
    product must be the world.  Every rank must call it, in the same
    order, with the same arguments: it creates the groups."""
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data <= 0:
        if world % n_model:
            raise AssertionError(
                f"{world} ranks do not split into model groups of {n_model}")
        n_data = world // n_model
    if n_data * n_model != world:
        raise AssertionError(
            f"{n_data}x{n_model} mesh needs {n_data*n_model} devices, have "
            f"{world}")
    j = joined()
    dev = (torch.device(device) if device is not None
           else j.device if j is not None else resolve_device(None))
    backend = (dist.get_backend() if dist.is_initialized() else "none")
    rank = dist.get_rank() if dist.is_initialized() else 0
    layout = mesh_layout(n_data, n_model)
    data_group = model_group = None
    if world > 1:
        for m in range(n_model):        # every rank creates every group
            g = _group(layout[:, m])
            if rank in layout[:, m]:
                data_group = g
        for d in range(n_data):
            g = _group(layout[d, :])
            if rank in layout[d, :]:
                model_group = g
    return Mesh(n_data, n_model, rank, dev, backend, data_group,
                model_group, data_axis, model_axis)


def _group(ranks: Sequence[int]):
    """A process group of ``ranks``, or None for one rank."""
    ranks = [int(r) for r in ranks]
    g = dist.new_group(ranks)
    return g if len(ranks) > 1 else None


# state names (dotted) that are row-sharded over the model axis
_ROW_SHARDED_SUFFIXES = ("embedding.table",)


def row_sharded(path) -> bool:
    """Whether the leaf at ``path`` (a dotted name, or its keys) is
    row-sharded over the model axis: ``embedding.table``, and ``m``/``v``
    under the optimizer state (the table's moments: ``emb_opt.m``,
    ``opt_state.1.m``); ``_spec_for_path``'s rules
    (``tpurec/parallel/mesh.py:78-101``)."""
    keys = path.split(".") if isinstance(path, str) else [
        str(k) for k in path]
    full = ".".join(keys)
    if any(full.endswith(s) for s in _ROW_SHARDED_SUFFIXES):
        return True
    return bool(keys) and keys[-1] in ("m", "v") and any(
        "opt_state" in k or k == "emb_opt" for k in keys)


class Shardings:
    """Which leaves of a state are split over the model axis
    (``tpurec/parallel/mesh.py:67-131``, ``_spec_for_path``'s rules on the
    port's dotted names): ``embedding.table`` and the table's moments
    (``m``/``v`` under the optimizer state: ``emb_opt.m``,
    ``opt_state.1.m``) split by rows; with ``expert_parallel``, a leaf of
    an expert bank (:data:`~tpurec_torch.parallel.experts.
    EXPERT_BANK_NAMES` in its path; its Adam moments share the path) of
    two axes or more whose leading axis divides the model axis splits
    along that axis; every other leaf is replicated.

    :meth:`shard_model` cuts a model to this rank's part."""

    def __init__(self, mesh: Mesh, data_axis: str = "data",
                 model_axis: str = "model", expert_parallel: bool = False):
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.expert_parallel = expert_parallel

    def spec(self, path, leaf=None) -> Tuple:
        """``path`` (a dotted name, or its keys) and, for an expert bank's
        leaf, the ``leaf`` itself (its shape decides) -> ``(model_axis,
        None)`` for a row-sharded leaf (:func:`row_sharded`),
        ``(model_axis, None, ...)`` for a split bank leaf, ``()`` for a
        replicated one."""
        if row_sharded(path):
            return (self.model_axis, None)
        shape = tuple(getattr(leaf, "shape", ()))
        if (self.expert_parallel and in_expert_bank(path)
                and len(shape) >= 2
                and shape[0] % self.mesh.shape[self.model_axis] == 0):
            return (self.model_axis,) + (None,) * (len(shape) - 1)
        return ()

    def shard_model(self, model) -> None:
        """Cut ``model`` (every rank's the same) to this rank's part, in
        place: the table to its rows
        (:func:`tpurec_torch.parallel.embedding.shard_table`) and, with
        ``expert_parallel``, each expert bank that divides the model axis
        to its stacks (:func:`tpurec_torch.parallel.experts.
        split_expert_banks`).  Rank 0 prints which banks split and which
        stayed whole."""
        from tpurec_torch.parallel.embedding import shard_table

        emb = model.get_submodule("embedding")
        local, emb.shard = shard_table(emb.table.detach(), self.mesh)
        emb.table = torch.nn.Parameter(local)
        if not self.expert_parallel:
            return
        split, whole = split_expert_banks(model, self.mesh)
        if self.mesh.rank == 0:
            n = self.mesh.n_model
            E = {name: model.get_submodule(name).n_stack
                 for name in split + whole}
            parts = [f"{name} ({E[name]} -> {E[name] // n} a rank)"
                     for name in split]
            parts += [f"{name} whole ({E[name]} stacks on a model axis of "
                      f"{n})" for name in whole]
            print(f"tpurec_torch.parallel: expert parallelism over the "
                  f"model axis of {n}: "
                  + ("; ".join(parts) if parts else "no expert bank"),
                  flush=True)

"""The mesh's collectives over ``torch.distributed``, and the scope that
carries the mesh into a forward.

The JAX package lets GSPMD insert its collectives (``tpurec/parallel/
mesh.py``); the port writes each one out.  Two all-reduces feed autograd,
and their backward rules differ:

- :func:`model_all_reduce` sums the rows that each model rank gathered
  from its shard of the table (:mod:`tpurec_torch.parallel.embedding`).
  Every model rank then repeats the same computation on the sum, so the
  backward is the identity: the transpose of ``psum`` under a replicated
  ``out_spec`` (``tpurec/parallel/embedding.py:56-73``).  An all-reduce
  there would multiply the table's gradient by ``n_model``.
- :func:`data_all_reduce` joins statistics of rows whose losses are
  summed across the data ranks (BatchNorm's sums, the loss's
  denominator).  Each data rank's loss depends on the joined value, so
  the backward all-reduces the gradient over the data group too.

Expert parallelism (:mod:`tpurec_torch.parallel.experts`) adds three
more, on the model group, around a bank split over it:

- :func:`copy_to_model` hands a bank its replicated input: forward the
  identity, backward the sum over the model group (each model rank's
  stacks give part of the input's gradient);
- :func:`scatter_to_model` hands it this rank's stacks of a per-stack
  input: forward the slice, backward the gather of every rank's slice;
- :func:`gather_from_model` returns every rank's stacks: forward the
  gather along the stack axis, backward this rank's slice.

A group of one rank is None: every collective over it returns its input,
so a mesh of one rank runs the one-device code bit for bit.

:func:`mesh_scope` sets the mesh that the forward's batch-coupled
reductions read (:func:`current_mesh`), as :mod:`tpurec_torch.nn.
precision` carries the compute dtype.  :data:`STATS` counts the
collectives and the host time spent in them.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Optional

import torch
import torch.distributed as dist

_MESH: contextvars.ContextVar = contextvars.ContextVar("tpurec_mesh",
                                                       default=None)

# collectives issued and host seconds inside them (a collective over gloo
# on a CUDA tensor waits for the card, so these include that wait)
STATS = {"calls": 0, "seconds": 0.0, "bytes": 0}


def reset_stats() -> None:
    STATS.update(calls=0, seconds=0.0, bytes=0)


@contextlib.contextmanager
def mesh_scope(mesh):
    """Within the block, :func:`current_mesh` is ``mesh`` (None: none)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh of the enclosing :func:`mesh_scope`, or None."""
    return _MESH.get()


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group``, in place (no autograd); None: nothing."""
    if group is None:
        return t
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    STATS["seconds"] += time.perf_counter() - t0
    return t


def broadcast_(t: torch.Tensor, src: int) -> torch.Tensor:
    """``t`` from rank ``src`` to every rank of the world, in place."""
    t0 = time.perf_counter()
    dist.broadcast(t, src)
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    STATS["seconds"] += time.perf_counter() - t0
    return t


def all_gather(t: torch.Tensor, group, size: int, index: int
               ) -> torch.Tensor:
    """[size * n, ...]: every rank's ``t`` [n, ...] of ``group``,
    concatenated in group-rank order (``index`` is this rank's).  Written
    as a sum into zeroed slots, which gloo takes on CUDA tensors too; the
    sum of a value and zeros is the value (a -0.0 may come back as 0.0)."""
    if group is None:
        return t
    out = torch.zeros((size,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    out[index] = t
    all_reduce_(out, group)
    return out.reshape((size * t.shape[0],) + tuple(t.shape[1:]))


class _ModelAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _DataAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def model_all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over ``mesh``'s model group; backward identity."""
    group = None if mesh is None else mesh.model_group
    return x if group is None else _ModelAllReduce.apply(x, group)


def data_all_reduce(x: torch.Tensor, mesh: Optional[object]) -> torch.Tensor:
    """The sum of ``x`` over ``mesh``'s data group; backward the sum of the
    gradients over the data group."""
    group = None if mesh is None else mesh.data_group
    return x if group is None else _DataAllReduce.apply(x, group)


def all_reduce_grads(params, group, *scalars: torch.Tensor):
    """Sum the gradients of ``params`` (those that have one) and the
    0-dim ``scalars`` over ``group`` in ONE collective of one flat float32
    buffer, the gradients in place.  -> the summed scalars (``scalars``
    themselves when ``group`` is None)."""
    if group is None:
        return scalars
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [s.reshape(1).to(torch.float32) for s in scalars])
    all_reduce_(flat, group)
    o = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[o:o + n].view_as(g))
        o += n
    return tuple(flat[o + i] for i in range(len(scalars)))


def _gather_axis(t: torch.Tensor, group, size: int, index: int,
                 axis: int) -> torch.Tensor:
    """:func:`all_gather` along ``axis``."""
    full = all_gather(t.movedim(axis, 0).contiguous(), group, size, index)
    return full.movedim(0, axis).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index, axis):
        ctx.n, ctx.index, ctx.axis = x.shape[axis], index, axis
        return _gather_axis(x, group, size, index, axis)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.axis, ctx.index * ctx.n, ctx.n).contiguous(),
                None, None, None, None)


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index, axis):
        n = x.shape[axis] // size
        ctx.group, ctx.size, ctx.index, ctx.axis = group, size, index, axis
        return x.narrow(axis, index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_gather_axis(g, ctx.group, ctx.size, ctx.index, ctx.axis),
                None, None, None, None)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``, replicated over ``mesh``'s model group, into a bank split
    over it; backward the sum of the gradients over the model group."""
    group = None if mesh is None else mesh.model_group
    return x if group is None else _CopyToModel.apply(x, group)


def gather_from_model(x: torch.Tensor, mesh, axis: int = 1) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``axis`` in model-rank
    order; backward this rank's slice of the gradient."""
    group = None if mesh is None else mesh.model_group
    return x if group is None else _GatherFromModel.apply(
        x, group, mesh.n_model, mesh.m, axis)


def scatter_to_model(x: torch.Tensor, mesh, axis: int = 1) -> torch.Tensor:
    """This model rank's slice of ``x`` along ``axis`` (``x.shape[axis] /
    n_model`` entries); backward every rank's gradient gathered."""
    group = None if mesh is None else mesh.model_group
    return x if group is None else _ScatterToModel.apply(
        x, group, mesh.n_model, mesh.m, axis)

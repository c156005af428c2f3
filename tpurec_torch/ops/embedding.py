"""Embedding row gather: kernel 1 of the port, and its plain version.

Replaces ``tpurec/ops/embedding_pallas.py::embedding_gather_fused`` (a
Pallas TPU kernel, ``_gather_kernel``) together with the lookup the JAX
Predictor runs around it: ``nn/core.py::mixed_table_lookup`` and the int8
dequantisation of ``serve.py:202-206``.  The CUDA source is
``tpurec_torch/csrc/embedding_gather.cu``; its header says how the kernel
is laid out.

Bound on the H100: bytes (ids in, rows read, float32 rows out; about
1.5 MB at 512 rows of 23 fields).  That is well under a microsecond of
memory time, so at serving batch sizes the host's cost of a call bounds
it.  So the gather is prepared once per table (:class:`EmbeddingGather`):
the table, offsets, limits and scales are checked at construction, and a
call checks only the ids, allocates the output and launches.

:class:`EmbeddingGather` and :func:`embedding_gather` (one-shot) launch
the kernel for CUDA tensors and run :func:`embedding_gather_reference`
for CPU tensors only.

A row window serves a table row-sharded over a mesh's model axis
(:mod:`tpurec_torch.parallel.embedding`): the table passed holds global
rows ``[row_lo, row_lo + n_rows)`` of an ``n_table_rows``-row table, and a
row the rules read outside the window is a zero row, in the same launch.
The window is fixed when the gather is prepared, so a call does no more
work; the whole table as the window is the plain gather, bit for bit.

:func:`embedding_lookup` is the gather with a gradient with respect to
the table (the ``"dense"`` embedding update differentiates through the
lookup): the forward is the prepared gather (kernel 1 on the card), the
backward :func:`embedding_gather_table_grad`, the rows' gradients
``index_add_``-ed into a zero [V, D] table gradient.  The JAX package
computes that scatter as XLA's transpose of ``jnp.take``, outside any
Pallas kernel; ``index_add_`` is its PyTorch counterpart.  On the card it
sums a row's gradients by atomics, in an order that varies from run to
run, so two runs' table gradients may differ in their last bits wherever
a row is touched more than once; on the CPU it sums in index order.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpurec_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


class _Plan(ctypes.Structure):
    """The source's ``GatherPlan``."""
    _fields_ = [("scales", ctypes.c_void_p), ("offsets", ctypes.c_void_p),
                ("limits", ctypes.c_void_p), ("dtype", ctypes.c_int),
                ("n_fields", ctypes.c_int), ("d", ctypes.c_int),
                ("n_table_rows", ctypes.c_int), ("row_lo", ctypes.c_int),
                ("n_window", ctypes.c_int)]


_SIGNATURES = {
    "tpurec_embedding_gather": (ctypes.c_int, [
        ctypes.POINTER(_Plan), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]),
}
_MAX_PIECES = 2**31 - 1         # the kernel's 32-bit piece index


def _check_table(table, offsets, limits, scales,
                 n_fields: Optional[int] = None) -> None:
    """Refuse a table/offsets/limits/scales set that does not fit
    (``n_fields``: the ids' width, when known; else offsets' length)."""
    if table.dtype not in _DTYPE_CODES or table.dim() != 2:
        raise ValueError(f"table must be [V, D] float32/bfloat16/int8, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if n_fields is None:
        n_fields = offsets.shape[0] if offsets.dim() == 1 else -1
    F = n_fields
    for name, t in (("offsets", offsets), ("limits", limits)):
        if t.dtype != torch.int32 or tuple(t.shape) != (F,):
            raise ValueError(f"{name} must be [{F}] int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if (table.dtype == torch.int8) != (scales is not None):
        raise ValueError("scales go with an int8 table, and only with one")
    if scales is not None and (scales.dtype != torch.float32
                               or tuple(scales.shape) != (table.shape[0],)):
        raise ValueError(f"scales must be [{table.shape[0]}] float32")
    tensors = [table, offsets, limits] + ([scales] if scales is not None
                                          else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("table, offsets, limits and scales must share one "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("embedding_gather needs contiguous tensors")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"embedding_gather runs on cuda or cpu, not "
                         f"{table.device}")


class EmbeddingGather:
    """A gather prepared for one table: ``g(ids)`` maps ids [N, F] int32
    to float32 rows [N, F, D] of ``table`` [V, D].

    Row ``ids[n, f] + offsets[f]`` with ``jnp.take``'s out-of-range rule
    over ``limits[f]`` rows (see the CUDA source); an int8 table is
    dequantised with its per-row ``scales`` [V].  The table, offsets,
    limits and scales are checked here, once, and kept referenced; a call
    checks only the ids.  The table may change in place between calls
    (its pointer is read at each call).

    ``row_lo``/``n_table_rows``: ``table`` (and ``scales``) hold global
    rows ``[row_lo, row_lo + V)`` of a table of ``n_table_rows`` rows
    (default: the whole table, ``row_lo`` 0); a row read outside that
    window is zero.
    """

    def __init__(self, table: torch.Tensor, offsets: torch.Tensor,
                 limits: torch.Tensor,
                 scales: Optional[torch.Tensor] = None, row_lo: int = 0,
                 n_table_rows: Optional[int] = None):
        _check_table(table, offsets, limits, scales)
        self.table, self.offsets, self.limits, self.scales = (
            table, offsets, limits, scales)
        self.n_fields = offsets.shape[0]
        self.V, self.D = table.shape
        self.row_lo = int(row_lo)
        self.n_table_rows = (self.V if n_table_rows is None
                             else int(n_table_rows))
        if not 0 <= self.row_lo <= self.n_table_rows < 2**31:
            raise ValueError(f"window row_lo {row_lo} of a "
                             f"{self.n_table_rows}-row table")
        self.window = (self.row_lo, self.n_table_rows)
        self.dtype = table.dtype
        self.device = table.device
        self.device_index = table.get_device()       # -1 on the CPU
        if self.device.type == "cuda":
            self._lib = _build.load("embedding_gather", _SIGNATURES)
            self._fn = self._lib.tpurec_embedding_gather
            self._plan = ctypes.pointer(_Plan(
                None if scales is None else scales.data_ptr(),
                offsets.data_ptr(), limits.data_ptr(),
                _DTYPE_CODES[table.dtype], self.n_fields, self.D,
                self.n_table_rows, self.row_lo, self.V))

    def serves(self, table: torch.Tensor, window=None) -> bool:
        """Whether this gather still fits ``table`` and ``window``
        (``(row_lo, n_table_rows)``; None: the whole table): the same
        tensor, on the same device, of the same shape and type (its
        storage may have been replaced: a call reads the pointer)."""
        return (self.table is table
                and table.get_device() == self.device_index
                and table.dtype == self.dtype
                and tuple(table.shape) == (self.V, self.D)
                and self.window == (window or (0, self.V)))

    def _check_ids(self, ids: torch.Tensor) -> None:
        if (ids.dtype is not torch.int32 or ids.dim() != 2
                or ids.shape[1] != self.n_fields):
            raise ValueError(f"ids must be [N, {self.n_fields}] int32, got "
                             f"{tuple(ids.shape)} {ids.dtype}")
        if not (ids.is_cuda and ids.get_device() == self.device_index
                if self.device_index >= 0 else ids.is_cpu):
            raise ValueError(f"ids are on {ids.device}, the table on "
                             f"{self.device}")
        if not ids.is_contiguous():
            raise ValueError("embedding_gather needs contiguous ids")

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        self._check_ids(ids)
        if self.device_index < 0:
            return embedding_gather_reference(
                self.table, ids, self.offsets, self.limits, self.scales,
                self.row_lo, self.n_table_rows)
        N = ids.shape[0]
        if N * self.n_fields * self.D > _MAX_PIECES:
            raise ValueError(f"{N} rows of {self.n_fields} fields x "
                             f"{self.D} is over the kernel's 2^31 pieces")
        out = torch.empty((N, self.n_fields, self.D), dtype=torch.float32,
                          device=self.device)
        dev = self.device_index
        if torch._C._cuda_getDevice() == dev:
            rc = self._fn(self._plan, self.table.data_ptr(), ids.data_ptr(),
                          N, out.data_ptr(),
                          torch._C._cuda_getCurrentRawStream(dev))
        else:
            with torch.cuda.device(dev):
                rc = self._fn(self._plan, self.table.data_ptr(),
                              ids.data_ptr(), N, out.data_ptr(),
                              torch._C._cuda_getCurrentRawStream(dev))
        if rc:
            _build.check(self._lib, rc, "embedding_gather")
        embedding_gather.launches += 1
        return out


def embedding_gather(table: torch.Tensor, ids: torch.Tensor,
                     offsets: torch.Tensor, limits: torch.Tensor,
                     scales: Optional[torch.Tensor] = None, row_lo: int = 0,
                     n_table_rows: Optional[int] = None) -> torch.Tensor:
    """One-shot :class:`EmbeddingGather`: ids [N, F] int32 -> float32 rows
    [N, F, D] of ``table`` [V, D] (the same rules, window and results)."""
    _check_table(table, offsets, limits, scales,
                 ids.shape[1] if ids.dim() == 2 else None)
    return EmbeddingGather(table, offsets, limits, scales, row_lo,
                           n_table_rows)(ids)


embedding_gather.launches = 0   # kernel 1's launches, from either form


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value XLA's wrapping add would give (as int64)."""
    return (x + 2**31) % 2**32 - 2**31


def take_rows(src: torch.Tensor, idx: torch.Tensor, limit=None):
    """``jnp.take(src[:limit], idx, axis=0)`` with its default out-of-range
    rule: idx in [-limit, 0) wraps, anything else outside [0, limit) gives
    the fill value (NaN for floating ``src``, the type's minimum for
    integers).  ``limit`` (default: all rows) broadcasts against ``idx``."""
    n = src.shape[0]
    limit = n if limit is None else torch.clamp(limit, max=n)
    idx = idx.long()
    r = torch.where(idx < 0, idx + limit, idx)
    ok = (r >= 0) & (r < limit)
    vals = src[r.clamp(0, max(n - 1, 0))]
    fill = (float("nan") if src.dtype.is_floating_point
            else torch.iinfo(src.dtype).min)
    ok = ok.reshape(ok.shape + (1,) * (vals.dim() - ok.dim()))
    return torch.where(ok, vals, torch.full((), fill, dtype=src.dtype,
                                            device=src.device))


def _window_rows(ids, offsets, limits, row_lo, n_window, n_table_rows):
    """(g, ok, in_win, w): each id's global row before the limit rule, and
    whether the rule reads a row, whether that row lies in the window and
    its row in the window (see the CUDA source)."""
    g = _wrap_int32(ids.long() + offsets.long()[None, :])
    lim = torch.clamp(limits.long()[None, :], max=n_table_rows)
    r = torch.where(g < 0, g + lim, g)
    ok = (r >= 0) & (r < lim)
    w = r - row_lo
    return g, ok, ok & (w >= 0) & (w < n_window), w


def embedding_gather_reference(table, ids, offsets, limits, scales=None,
                               row_lo: int = 0,
                               n_table_rows: Optional[int] = None):
    """Plain PyTorch version of :func:`embedding_gather` (same rules and
    window)."""
    n = table.shape[0]
    V = n if n_table_rows is None else n_table_rows
    g, ok, in_win, w = _window_rows(ids, offsets, limits, row_lo, n, V)
    dev = table.device
    fill = float("nan") if table.dtype.is_floating_point else float(
        torch.iinfo(table.dtype).min)
    vals = table[w.clamp(0, max(n - 1, 0))].to(torch.float32)
    zero = (ok & ~in_win)[..., None]
    rows = torch.where(in_win[..., None], vals,
                       torch.where(zero, 0.0, torch.tensor(fill,
                                                           device=dev)))
    if scales is not None:
        s = torch.where(g < 0, g + V, g)
        sw = s - row_lo
        sok = (s >= 0) & (s < V) & (sw >= 0) & (sw < n)
        sc = torch.where(sok, scales[sw.clamp(0, max(n - 1, 0))],
                         torch.tensor(float("nan"), device=dev))
        rows = torch.where(zero, rows, rows * sc[..., None])
    return rows


def embedding_gather_table_grad(dy: torch.Tensor, ids: torch.Tensor,
                                offsets: torch.Tensor, limits: torch.Tensor,
                                n_rows: int, row_lo: int = 0,
                                n_table_rows: Optional[int] = None
                                ) -> torch.Tensor:
    """The gradient of :func:`embedding_gather` with respect to a float32
    table of ``n_rows`` rows: ``dy`` [N, F, D] added into a zero [n_rows,
    D] tensor at each id's row by ``index_add_`` (by atomics, in a varying
    order, on the card).  An id that wraps reaches the row it read; one
    that read the fill value reaches no row, as in the transpose of
    ``jnp.take``.  With a window (``row_lo``, ``n_table_rows``: the table
    is rows [row_lo, row_lo + n_rows) of that many) only the rows read in
    the window take a gradient."""
    V = n_rows if n_table_rows is None else n_table_rows
    _, _, ok, r = _window_rows(ids, offsets, limits, row_lo, n_rows, V)
    D = dy.shape[-1]
    vals = torch.where(ok[..., None], dy.to(torch.float32),
                       torch.zeros((), dtype=torch.float32,
                                   device=dy.device))
    grad = torch.zeros((n_rows, D), dtype=torch.float32, device=dy.device)
    return grad.index_add_(0, torch.where(ok, r, 0).reshape(-1),
                           vals.reshape(-1, D))


class _Lookup(torch.autograd.Function):
    """The prepared gather with the table's gradient in its backward."""

    @staticmethod
    def forward(ctx, table, ids, gather):
        ctx.save_for_backward(ids)
        ctx.gather = gather
        return gather(ids)

    @staticmethod
    def backward(ctx, dy):
        ids, = ctx.saved_tensors
        g = ctx.gather
        return (embedding_gather_table_grad(dy, ids, g.offsets, g.limits,
                                            g.V, g.row_lo, g.n_table_rows),
                None, None)


def embedding_lookup(gather: EmbeddingGather,
                     ids: torch.Tensor) -> torch.Tensor:
    """``gather(ids)``, differentiable with respect to ``gather.table`` (a
    float32 table that requires its gradient) through
    :func:`embedding_gather_table_grad`; the ids take no gradient."""
    if gather.dtype != torch.float32:
        raise ValueError("embedding_lookup differentiates a float32 table "
                         f"only, not {gather.dtype}")
    return _Lookup.apply(gather.table, ids, gather)

"""Exact dense-Adam update of the embedding table: kernel 7 (the full-table
sweep) and kernel 6 (the sparse row step) of the port, and their plain
versions.

Kernel 7 replaces ``tpurec/ops/fused_adam_pallas.py::fused_decay_adam``
(``_decay_kernel``): one pass over the table computing the zero-gradient
Adam step ``u = coef * p``, with the small-field prefix gradient added on
rows [0, S), and ``sum(p**2)`` of the table before the step.  Kernel 6
replaces the function of ``fused_sparse_adam`` (``_kernel``) in the form
the hybrid update uses (``train/hybrid.py:249-263``): the exact Adam step
of sorted, unique touched rows, ``u = g_u + coef * p_old``, computed from
the table before the sweep into compact buffers (:func:`adam_rows`) and
written over the swept rows after it (:func:`write_rows`).  The CUDA source
is ``tpurec_torch/csrc/fused_adam.cu``; its header gives the design and the
bounds (bytes: 16 B per element with bfloat16 moments, 24 B with float32;
the row step is launch-bound).

All three update the table and moments **in place**; the moments are
float32 or bfloat16 (stored rounded to nearest even, math in float32).
:func:`fused_sparse_adam` composes them into the TPU function's whole
contract: duplicates summed (:func:`dedup_sorted`, torch ops), the row
step, the sweep, the write-back.  It is the one place that orders them:
the hybrid training step calls it with the small-field prefix gradient.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors only.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from tpurec_torch.ops import _build

SWEEP_GRID_PER_SM = 16          # decay sweep: blocks per SM (grid stride)
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "tpurec_decay_adam": (_I, [_P, _P, _P, _I, _P, _L, _L] + [_F] * 9
                          + [_I, _P, _P, _P]),
    "tpurec_adam_rows": (_I, [_P, _P, _P, _I, _P, _P, _I, _I, _L]
                         + [_F] * 9 + [_P, _P, _P, _P]),
    "tpurec_write_rows": (_I, [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _L,
                               _P]),
}
_MOMENT_DTYPES = (torch.float32, torch.bfloat16)


def bias_corrections(t: int, b1: float, b2: float) -> Tuple[float, float]:
    """(1 - b1**t, 1 - b2**t) in float32, as the JAX package computes them
    from a float32 step count."""
    tf = np.float32(t)
    return (float(np.float32(1.0) - np.float32(b1) ** tf),
            float(np.float32(1.0) - np.float32(b2) ** tf))


def _consts(t, lr, b1, b2, eps, coef):
    bc1, bc2 = bias_corrections(t, b1, b2)
    return (lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, coef, bc1, bc2)


def _check_table(table, m, v) -> None:
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"table must be [V, D] float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    for name, t in (("m", m), ("v", v)):
        if t.dtype not in _MOMENT_DTYPES or t.shape != table.shape:
            raise ValueError(f"{name} must be {tuple(table.shape)} float32 "
                             f"or bfloat16, got {tuple(t.shape)} {t.dtype}")
    if m.dtype != v.dtype:
        raise ValueError("m and v must share one dtype")
    if not (table.device == m.device == v.device):
        raise ValueError("table, m and v must share one device")
    if not all(t.is_contiguous() for t in (table, m, v)):
        raise ValueError("table, m and v must be contiguous")


def _on_card(table, what: str) -> None:
    if table.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {table.device}")


# -- kernel 7: the sweep ---------------------------------------------------

def fused_decay_adam(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                     g_small: Optional[torch.Tensor], t: int, *, lr: float,
                     b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8,
                     coef: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """One exact dense-Adam step of the whole table with ``u = coef * p``
    plus ``g_small`` [S, D] on rows [0, S), in place.

    -> (table, m, v, sumsq) with sumsq = sum(table**2) before the step (a
    float32 scalar tensor on the table's device)."""
    _check_table(table, m, v)
    V, D = table.shape
    if g_small is None:
        g_small = torch.zeros((0, D), dtype=torch.float32,
                              device=table.device)
    if (g_small.dtype != torch.float32 or g_small.dim() != 2
            or g_small.shape[1] != D or g_small.shape[0] > V
            or g_small.device != table.device):
        raise ValueError(f"g_small must be [S <= {V}, {D}] float32 on "
                         f"{table.device}, got {tuple(g_small.shape)} "
                         f"{g_small.dtype}")
    if table.device.type == "cpu":
        return fused_decay_adam_reference(table, m, v, g_small, t, lr=lr,
                                          b1=b1, b2=b2, eps=eps, coef=coef)
    _on_card(table, "fused_decay_adam")
    n = table.numel()
    if n % 8:
        raise ValueError(f"the sweep moves 8 values per step: V*D={n} must "
                         f"be a multiple of 8")
    g_small = g_small.contiguous()
    if any(x.data_ptr() % 16 for x in (table, m, v, g_small)):
        raise ValueError("the sweep needs 16-byte aligned tensors")
    lib = _build.load("fused_adam", _SIGNATURES)
    dev = table.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(-(-n // (8 * 256)), SWEEP_GRID_PER_SM * n_sm))
    block_sumsq = torch.empty((grid,), dtype=torch.float64, device=dev)
    sumsq = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpurec_decay_adam(
            table.data_ptr(), m.data_ptr(), v.data_ptr(),
            int(m.dtype == torch.bfloat16), g_small.data_ptr(), n,
            g_small.numel(), *_consts(t, lr, b1, b2, eps, coef), grid,
            block_sumsq.data_ptr(), sumsq.data_ptr(), stream)
    _build.check(lib, rc, "fused_decay_adam")
    fused_decay_adam.launches += 1
    return table, m, v, sumsq


fused_decay_adam.launches = 0


@torch.no_grad()
def fused_decay_adam_reference(table, m, v, g_small, t, *, lr, b1=0.9,
                               b2=0.99, eps=1e-8, coef=0.0):
    """Plain PyTorch version of :func:`fused_decay_adam` (in place), the
    math of ``fused_adam_pallas.py::fused_decay_adam_reference`` with
    moments stored in ``m.dtype``."""
    bc1, bc2 = bias_corrections(t, b1, b2)
    sumsq = torch.sum(table * table)
    u = coef * table
    S = 0 if g_small is None else g_small.shape[0]
    if S:
        u[:S] = u[:S] + g_small
    m2 = b1 * m.to(torch.float32) + (1.0 - b1) * u
    v2 = b2 * v.to(torch.float32) + (1.0 - b2) * (u * u)
    table.copy_(table - lr * (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps))
    m.copy_(m2)
    v.copy_(v2)
    return table, m, v, sumsq


# -- kernel 6: the row step and its write-back -----------------------------

def _check_rows(table, m, ids, g) -> None:
    N = ids.shape[0]
    D = table.shape[1]
    if ids.dtype != torch.int64 or ids.dim() != 1:
        raise ValueError(f"ids must be [N] int64, got {tuple(ids.shape)} "
                         f"{ids.dtype}")
    if g is not None and (g.dtype != torch.float32
                          or tuple(g.shape) != (N, D)):
        raise ValueError(f"g must be [{N}, {D}] float32, got "
                         f"{tuple(g.shape)} {g.dtype}")
    for x in (ids,) + (() if g is None else (g,)):
        if x.device != table.device or not x.is_contiguous():
            raise ValueError(f"ids and g must be contiguous on "
                             f"{table.device}")


def adam_rows(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
              ids: torch.Tensor, g: torch.Tensor, t: int, *, lr: float,
              b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8,
              coef: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 6's row step: the exact Adam step of rows ``ids`` [N]
    (unique; ids outside [0, V) are skipped and their output rows left
    unset) with gradients ``g`` [N, D], from the table and moments as they
    stand.  -> compact (pb [N, D] float32, mb, vb [N, D] in m's dtype)."""
    _check_table(table, m, v)
    _check_rows(table, m, ids, g)
    if table.device.type == "cpu":
        return adam_rows_reference(table, m, v, ids, g, t, lr=lr, b1=b1,
                                   b2=b2, eps=eps, coef=coef)
    _on_card(table, "adam_rows")
    lib = _build.load("fused_adam", _SIGNATURES)
    (V, D), N = table.shape, ids.shape[0]
    pb = torch.empty((N, D), dtype=torch.float32, device=table.device)
    mb = torch.empty((N, D), dtype=m.dtype, device=table.device)
    vb = torch.empty_like(mb)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpurec_adam_rows(
            table.data_ptr(), m.data_ptr(), v.data_ptr(),
            int(m.dtype == torch.bfloat16), ids.data_ptr(), g.data_ptr(),
            N, D, V, *_consts(t, lr, b1, b2, eps, coef), pb.data_ptr(),
            mb.data_ptr(), vb.data_ptr(), stream)
    _build.check(lib, rc, "adam_rows")
    adam_rows.launches += 1
    return pb, mb, vb


adam_rows.launches = 0


def write_rows(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
               ids: torch.Tensor, pb: torch.Tensor, mb: torch.Tensor,
               vb: torch.Tensor) -> None:
    """Kernel 6's write-back: rows ``ids`` (unique; outside [0, V)
    skipped) of table, m, v become pb, mb, vb, in place."""
    _check_table(table, m, v)
    _check_rows(table, m, ids, pb)
    N, D = pb.shape
    if (mb.dtype != m.dtype or vb.dtype != m.dtype
            or tuple(mb.shape) != (N, D) or tuple(vb.shape) != (N, D)
            or not (mb.is_contiguous() and vb.is_contiguous())):
        raise ValueError(f"mb and vb must be contiguous [{N}, {D}] {m.dtype}")
    if table.device.type == "cpu":
        write_rows_reference(table, m, v, ids, pb, mb, vb)
        return
    _on_card(table, "write_rows")
    lib = _build.load("fused_adam", _SIGNATURES)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpurec_write_rows(
            table.data_ptr(), m.data_ptr(), v.data_ptr(),
            int(m.dtype == torch.bfloat16), ids.data_ptr(), pb.data_ptr(),
            mb.data_ptr(), vb.data_ptr(), N, D, table.shape[0], stream)
    _build.check(lib, rc, "write_rows")
    write_rows.launches += 1


write_rows.launches = 0


@torch.no_grad()
def adam_rows_reference(table, m, v, ids, g, t, *, lr, b1=0.9, b2=0.99,
                        eps=1e-8, coef=0.0):
    """Plain PyTorch version of :func:`adam_rows` (rows of skipped ids
    hold the step of row 0 or V-1; :func:`write_rows` never reads them)."""
    bc1, bc2 = bias_corrections(t, b1, b2)
    idc = ids.clamp(0, table.shape[0] - 1)
    p_old = table[idc]
    ub = g + coef * p_old
    mb = b1 * m[idc].to(torch.float32) + (1.0 - b1) * ub
    vb = b2 * v[idc].to(torch.float32) + (1.0 - b2) * (ub * ub)
    pb = p_old - lr * (mb / bc1) / (torch.sqrt(vb / bc2) + eps)
    return pb, mb.to(m.dtype), vb.to(v.dtype)


@torch.no_grad()
def write_rows_reference(table, m, v, ids, pb, mb, vb) -> None:
    """Plain PyTorch version of :func:`write_rows`."""
    ok = (ids >= 0) & (ids < table.shape[0])
    rows = ids[ok]
    table[rows] = pb[ok]
    m[rows] = mb[ok]
    v[rows] = vb[ok]


# -- the TPU function's whole contract -------------------------------------

def dedup_sorted(ids: torch.Tensor, g_rows: torch.Tensor, sentinel: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort ids, sum duplicate rows' gradients (``_dedup_sorted`` /
    ``train/sparse.py::combine_duplicate_rows``), with static shapes and no
    host round trip.

    -> (id_u [N] int64: the sorted unique ids, then ``sentinel``;
        g_u [N, D]: row j is id_u[j]'s summed gradient, zero past the
        unique ids; valid [N] bool).  Sums run in the order of the stable
    sort, so a run gives the same bits every time."""
    N = ids.shape[0]
    dev = ids.device
    sid, order = torch.sort(ids.to(torch.int64), stable=True)
    sg = g_rows.index_select(0, order)
    head = torch.ones(N, dtype=torch.bool, device=dev)
    head[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(head.to(torch.int64), 0) - 1               # [N]
    lengths = torch.zeros(N, dtype=torch.int64, device=dev).scatter_add_(
        0, seg, torch.ones_like(seg))
    g_u = torch.segment_reduce(sg, "sum", lengths=lengths, axis=0,
                               unsafe=True)
    j = torch.arange(N, device=dev)
    first = torch.searchsorted(seg, j).clamp(max=max(N - 1, 0))
    valid = j < seg[-1:] + 1
    id_u = torch.where(valid, sid[first], torch.full_like(sid, sentinel))
    return id_u, g_u, valid


def fused_sparse_adam(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                      ids: torch.Tensor, g_rows: torch.Tensor, t: int, *,
                      lr: float, b1: float = 0.9, b2: float = 0.99,
                      eps: float = 1e-8, coef: float = 0.0,
                      g_small: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """One exact dense-Adam step of the table with sparse gradients
    ``g_rows`` [N, D] at ``ids`` [N] (duplicates summed) and, optionally,
    a dense gradient ``g_small`` [S, D] of rows [0, S), in place.
    ``g_small`` must be zero on rows that ``ids`` touch: their write-back
    replaces the sweep's step.

    The row step reads the table before the sweep changes it, into compact
    buffers; the sweep then runs in place; the write-back puts the rows
    over the swept ones.  The hybrid training step's table update is this
    function.

    -> (table, m, v, sumsq) with sumsq = sum(table**2) before the step."""
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, coef=coef)
    if ids.shape[0] == 0:
        return fused_decay_adam(table, m, v, g_small, t, **kw)
    id_u, g_u, _ = dedup_sorted(ids, g_rows.to(torch.float32),
                                table.shape[0])
    pb, mb, vb = adam_rows(table, m, v, id_u, g_u, t, **kw)
    table, m, v, sumsq = fused_decay_adam(table, m, v, g_small, t, **kw)
    write_rows(table, m, v, id_u, pb, mb, vb)
    return table, m, v, sumsq

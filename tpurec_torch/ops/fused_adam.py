"""Exact dense-Adam update of the embedding table: kernel 7 (the full-table
sweep) and kernel 6 (the sparse row step, carried by the sweep's pass) of
the port, and their plain versions.

Kernel 7 replaces ``tpurec/ops/fused_adam_pallas.py::fused_decay_adam``
(``_decay_kernel``): one pass over the table computing the zero-gradient
Adam step ``u = coef * p``, with the small-field prefix gradient added on
rows [0, S), and ``sum(p**2)`` of the table before the step.  Kernel 6
replaces ``fused_sparse_adam`` (``_kernel``): the same pass, in which each
touched row's gradients, summed in the order of a stable sort of the ids,
give ``u = coef * p + g_row`` in place of ``coef * p + g_small`` (the
hybrid update sets the row correction over the swept row,
``tpurec/train/hybrid.py:122-129``).  As the TPU function keeps its sort
and ``searchsorted`` outside ``pallas_call``, :func:`fused_sparse_adam`
runs one stable ``torch.sort`` of the ids and one ``torch.searchsorted``
of the tiles' row bounds, then one launch of the sweep that reads each
tile's entries.  The CUDA source is ``tpurec_torch/csrc/fused_adam.cu``;
its header gives the design and the bounds (bytes: 16 B per element with
bfloat16 moments, 24 B with float32).

Both update the table and moments **in place**; the moments are float32
or bfloat16 (stored rounded to nearest even, math in float32).  The
hybrid training step's table update is :func:`fused_sparse_adam` with the
small-field prefix gradient.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors only.  ``fused_decay_adam.launches`` counts the
sweep's launches, with or without rows; ``fused_sparse_adam.launches``
those that carried rows.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from tpurec_torch.ops import _build
from tpurec_torch.ops.attention import _sm_count

SWEEP_GRID_PER_SM = 16          # decay sweep: blocks per SM (grid stride)
TILE = 256                      # values a warp moves a step (kTile)
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "tpurec_decay_adam": (_I, [_P, _P, _P, _I, _P, _L, _L] + [_F] * 9
                          + [_I, _P, _P, _P, _P, _P, _P, _I, _P]),
}
_TILE_QUERIES = {}
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

def _check_g_small(table, g_small) -> torch.Tensor:
    V, D = table.shape
    if g_small is None:
        return torch.zeros((0, D), dtype=torch.float32, device=table.device)
    if (g_small.dtype != torch.float32 or g_small.dim() != 2
            or g_small.shape[1] != D or g_small.shape[0] > V
            or g_small.device != table.device):
        raise ValueError(f"g_small must be [S <= {V}, {D}] float32 on "
                         f"{table.device}, got {tuple(g_small.shape)} "
                         f"{g_small.dtype}")
    return g_small


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
    g_small = _check_g_small(table, g_small)
    if table.device.type == "cpu":
        return fused_decay_adam_reference(table, m, v, g_small, t, lr=lr,
                                          b1=b1, b2=b2, eps=eps, coef=coef)
    _on_card(table, "fused_decay_adam")
    return _sweep(table, m, v, g_small, t, (lr, b1, b2, eps, coef), None)


fused_decay_adam.launches = 0


def _sweep(table, m, v, g_small, t, hyper, rows):
    """Launch the sweep (kernel 7) and its sum's finish on the card, the
    sweep carrying kernel 6's ``rows`` = (sid, order, g_rows, bounds) when
    not None."""
    n = table.numel()
    if n % 8:
        raise ValueError(f"the sweep moves 8 values per step: V*D={n} must "
                         f"be a multiple of 8")
    g_small = g_small.contiguous()
    dev = table.device
    row_ptrs = [0] * 4
    if rows is not None:
        row_ptrs = [x.data_ptr() for x in rows]
    if any(x.data_ptr() % 16 for x in (table, m, v, g_small)) or (
            row_ptrs[2] % 16):
        raise ValueError("the sweep needs 16-byte aligned tensors")
    lib = _build.load("fused_adam", _SIGNATURES)
    grid = max(1, min(-(-n // (8 * 256)), SWEEP_GRID_PER_SM * _sm_count(dev)))
    block_sumsq = torch.empty((grid,), dtype=torch.float64, device=dev)
    sumsq = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpurec_decay_adam(
            table.data_ptr(), m.data_ptr(), v.data_ptr(),
            int(m.dtype == torch.bfloat16), g_small.data_ptr(), n,
            g_small.numel(), *_consts(t, *hyper), grid,
            block_sumsq.data_ptr(), sumsq.data_ptr(), *row_ptrs,
            table.shape[1], stream)
    _build.check(lib, rc, "fused_decay_adam")
    fused_decay_adam.launches += 1
    if rows is not None:
        fused_sparse_adam.launches += 1
    return table, m, v, sumsq


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


# -- kernel 6: the touched rows in the sweep's pass -------------------------

def tile_row_bounds(V: int, D: int, device) -> torch.Tensor:
    """[2, T] int64, T = ceil(V * D / TILE): for each tile t of the flat
    table, the first row it meets, floor(TILE t / D), and one past the
    last, min(V, ceil(TILE (t + 1) / D)) (cached per shape and device).
    Searched in the sorted ids, they give each tile's entries; ids outside
    [0, V) fall in no tile."""
    key = (V, D, str(device))
    if key not in _TILE_QUERIES:
        T = -(-V * D // TILE)
        t = torch.arange(T, dtype=torch.int64)
        _TILE_QUERIES[key] = torch.stack(
            [t * TILE // D, (-(-(t + 1) * TILE // D)).clamp(max=V)]
        ).to(device)
    return _TILE_QUERIES[key]


def _check_rows(table, ids, g_rows) -> None:
    if ids.dim() != 1 or ids.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"ids must be [N] int64 or int32, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    N, D = ids.shape[0], table.shape[1]
    if tuple(g_rows.shape) != (N, D):
        raise ValueError(f"g_rows must be [{N}, {D}], got "
                         f"{tuple(g_rows.shape)}")
    if not ids.device == g_rows.device == table.device:
        raise ValueError(f"ids and g_rows must be on {table.device}")
    if N >= 2**31:
        raise ValueError(f"the row step takes fewer than 2**31 ids, got {N}")


def fused_sparse_adam(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                      ids: torch.Tensor, g_rows: torch.Tensor, t: int, *,
                      lr: float, b1: float = 0.9, b2: float = 0.99,
                      eps: float = 1e-8, coef: float = 0.0,
                      g_small: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """One exact dense-Adam step of the table with sparse gradients
    ``g_rows`` [N, D] at ``ids`` [N] (duplicates summed in batch order;
    ids outside [0, V) touch nothing) and, optionally, a dense gradient
    ``g_small`` [S, D] of rows [0, S), in place.  A touched row takes
    ``u = coef * p + (its summed gradient)``, which replaces ``g_small``
    there; every other row ``u = coef * p (+ g_small)``.

    On the card: one stable sort of the ids, one searchsorted of the
    tiles' row bounds, one launch of the sweep carrying the rows, and the
    one-block finish of sum(table**2).

    -> (table, m, v, sumsq) with sumsq = sum(table**2) before the step."""
    _check_table(table, m, v)
    _check_rows(table, ids, g_rows)
    g_small = _check_g_small(table, g_small)
    g_rows = g_rows.to(torch.float32)
    if table.device.type == "cpu":
        return fused_sparse_adam_reference(table, m, v, ids, g_rows, t,
                                           lr=lr, b1=b1, b2=b2, eps=eps,
                                           coef=coef, g_small=g_small)
    _on_card(table, "fused_sparse_adam")
    rows = None
    if ids.shape[0]:
        sid, order = torch.sort(ids.to(torch.int64), stable=True)
        bounds = torch.searchsorted(
            sid, tile_row_bounds(*table.shape, table.device), out_int32=True)
        rows = (sid, order, g_rows.contiguous(), bounds)
    return _sweep(table, m, v, g_small, t, (lr, b1, b2, eps, coef), rows)


fused_sparse_adam.launches = 0


@torch.no_grad()
def fused_sparse_adam_reference(table, m, v, ids, g_rows, t, *, lr, b1=0.9,
                                b2=0.99, eps=1e-8, coef=0.0, g_small=None):
    """Plain PyTorch version of :func:`fused_sparse_adam` (in place): the
    ids sorted stably, each touched row's gradients summed in that order
    (``index_add_``, in index order on the CPU) over a zero row that
    replaces ``g_small``'s, then the sweep's formula on the dense
    gradient."""
    V, D = table.shape
    g = torch.zeros_like(table)
    if g_small is not None and g_small.shape[0]:
        g[:g_small.shape[0]] = g_small
    sid, order = torch.sort(ids.to(torch.int64), stable=True)
    ok = (sid >= 0) & (sid < V)
    rows = sid[ok]
    g[rows] = 0.0
    g.index_add_(0, rows, g_rows.to(torch.float32)[order[ok]])
    return fused_decay_adam_reference(table, m, v, g, t, lr=lr, b1=b1,
                                      b2=b2, eps=eps, coef=coef)

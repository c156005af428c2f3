"""Embedding row gather: kernel 1 of the port, and its plain version.

Replaces ``tpurec/ops/embedding_pallas.py::embedding_gather_fused`` (a
Pallas TPU kernel, ``_gather_kernel``) together with the lookup the JAX
Predictor runs around it: ``nn/core.py::mixed_table_lookup`` and the int8
dequantisation of ``serve.py:202-206``.  The CUDA source is
``tpurec_torch/csrc/embedding_gather.cu``; its header says how the kernel
is laid out.

Bound on the H100: bytes (ids in, rows read, float32 rows out; about
1.5 MB at 512 rows of 23 fields).  That is well under a microsecond of
memory time, so at serving batch sizes the launch bounds it.

:func:`embedding_gather` launches the kernel for CUDA tensors and runs
:func:`embedding_gather_reference` for CPU tensors only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpurec_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SIGNATURES = {
    "tpurec_embedding_gather": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
}


def _check(table, ids, offsets, limits, scales) -> None:
    if table.dtype not in _DTYPE_CODES or table.dim() != 2:
        raise ValueError(f"table must be [V, D] float32/bfloat16/int8, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if ids.dtype != torch.int32 or ids.dim() != 2:
        raise ValueError(f"ids must be [N, F] int32, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    F = ids.shape[1]
    for name, t in (("offsets", offsets), ("limits", limits)):
        if t.dtype != torch.int32 or tuple(t.shape) != (F,):
            raise ValueError(f"{name} must be [{F}] int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if (table.dtype == torch.int8) != (scales is not None):
        raise ValueError("scales go with an int8 table, and only with one")
    if scales is not None and (scales.dtype != torch.float32
                               or tuple(scales.shape) != (table.shape[0],)):
        raise ValueError(f"scales must be [{table.shape[0]}] float32")
    tensors = [table, ids, offsets, limits] + ([scales] if scales is not None
                                               else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("table, ids, offsets, limits and scales must share "
                         "one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("embedding_gather needs contiguous tensors")


def embedding_gather(table: torch.Tensor, ids: torch.Tensor,
                     offsets: torch.Tensor, limits: torch.Tensor,
                     scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ids [N, F] int32 -> float32 rows [N, F, D] of ``table`` [V, D].

    Row ``ids[n, f] + offsets[f]`` with ``jnp.take``'s out-of-range rule
    over ``limits[f]`` rows (see the CUDA source); an int8 table is
    dequantised with its per-row ``scales`` [V].
    """
    _check(table, ids, offsets, limits, scales)
    if table.device.type == "cpu":
        return embedding_gather_reference(table, ids, offsets, limits, scales)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_gather runs on cuda or cpu, not "
                         f"{table.device}")
    lib = _build.load("embedding_gather", _SIGNATURES)
    N, F = ids.shape
    V, D = table.shape
    out = torch.empty((N, F, D), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpurec_embedding_gather(
            table.data_ptr(), _DTYPE_CODES[table.dtype],
            None if scales is None else scales.data_ptr(),
            ids.data_ptr(), offsets.data_ptr(), limits.data_ptr(),
            N * F, F, D, V, out.data_ptr(), stream)
    _build.check(lib, rc, "embedding_gather")
    embedding_gather.launches += 1
    return out


embedding_gather.launches = 0


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


def embedding_gather_reference(table, ids, offsets, limits, scales=None):
    """Plain PyTorch version of :func:`embedding_gather` (same rules)."""
    g = _wrap_int32(ids.long() + offsets.long()[None, :])
    rows = take_rows(table, g, limits.long()[None, :]).to(torch.float32)
    if scales is not None:
        rows = rows * take_rows(scales, g)[..., None]
    return rows

"""Compute-dtype policy of the port (``tpurec/nn/precision.py``'s
counterpart).

``TrainConfig.compute_dtype="bfloat16"`` rounds the operands of the dense
contractions that the JAX package casts (:class:`tpurec_torch.nn.core.
Linear` and :class:`~tpurec_torch.nn.core.StackedLinear`) to bfloat16,
while every product still accumulates and emits float32.  Parameters,
optimizer state, BatchNorm statistics, softmax and all elementwise math
stay float32.

The policy is a ``ContextVar``: the entry points (the Predictor, the
training step, the eval steps and scans, the CDC engine's forwards) run
their forward inside :func:`compute_dtype`, so each thread and context
sees only its own scope.  Autograd runs the backward outside that block,
but the casts were recorded in the forward's graph, so the backward
rounds each cotangent to bfloat16 at the cast, as JAX's does.

:func:`cast_operands` rounds to bfloat16 and back to float32 on every
device: the function the JAX package computes on the CPU
(``tpurec/nn/precision.py:84-92``), and on the TPU's MXU, whose
bf16 x bf16 product is exact in float32.  The card's float32 products run
with TF32 off, so they round nothing more.

The kernels cast nothing, as the JAX package's Pallas kernels do: the
attention stack (kernels #2-#5) and the cross network (#8/#9) stay float32
in bf16 mode (see :mod:`tpurec_torch.nn.interactions` for the one
difference from the JAX package's default attention path).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

_COMPUTE_DTYPE: contextvars.ContextVar[Optional[torch.dtype]] = \
    contextvars.ContextVar("tpurec_torch_compute_dtype", default=None)

_ALIASES = {
    None: None,
    "": None,
    "float32": None,
    "f32": None,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def _resolve(dtype) -> Optional[torch.dtype]:
    if isinstance(dtype, str) or dtype is None:
        if dtype not in _ALIASES:
            raise ValueError(f"unsupported compute_dtype {dtype!r}")
        return _ALIASES[dtype]
    if dtype == torch.float32:
        return None
    if dtype == torch.bfloat16:
        return torch.bfloat16
    raise ValueError(f"unsupported compute_dtype {dtype!r}")


def set_compute_dtype(dtype) -> None:
    """Set the operand dtype ('float32'/'bfloat16'/None) for the CURRENT
    context/thread."""
    _COMPUTE_DTYPE.set(_resolve(dtype))


def get_compute_dtype() -> Optional[torch.dtype]:
    return _COMPUTE_DTYPE.get()


@contextlib.contextmanager
def compute_dtype(dtype):
    tok = _COMPUTE_DTYPE.set(_resolve(dtype))
    try:
        yield
    finally:
        _COMPUTE_DTYPE.reset(tok)


def cast_operands(*xs):
    """Round contraction operands to the policy dtype and back to float32
    (no-op when off); one tensor in, one out."""
    dt = _COMPUTE_DTYPE.get()
    if dt is None:
        return xs if len(xs) > 1 else xs[0]
    out = tuple(x.to(dt).to(torch.float32) for x in xs)
    return out if len(out) > 1 else out[0]


def check_compute_dtype(dtype) -> None:
    """Raise ValueError unless ``dtype`` names a supported compute dtype
    (the entry points check at construction, before any forward)."""
    _resolve(dtype)

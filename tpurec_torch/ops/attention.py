"""Field-attention stack, eval forward: kernel 2 of the port, and its plain
version.

Replaces the forward of ``tpurec/ops/attention_pallas.py::
fused_field_attention`` (Pallas ``_fwd_kernel``) with dropout off: field
embeddings [B, F, D] -> ``relu(stack(x) + V_res)`` [B, F, A], the whole
aux-attention head of the tower models.  The CUDA source is
``tpurec_torch/csrc/field_attention.cu``; its header gives the design.

Bound on the H100: float32 operations, about 2.76 MFLOP per batch row at
the flagship shapes (F=23, D=16, A=64, H=2, L=3): 1.41 GFLOP at B=512,
about 21 us at 67 TFLOP/s; its bytes (about 4 MB) take about 1.2 us.
The kernel keeps every intermediate of a row in shared memory, so the
memory traffic is the input and the output only.

``flat_w`` is the Pallas kernel's weight list, [w_emb, b_emb, w_res, b_res,
(w_in, b_in, w_out, b_out) x L], weights [in, out]; ``w_res``/``b_res``
are None when the head has no V_res residual.  :func:`field_attention`
launches the kernel for CUDA tensors and runs
:func:`field_attention_reference` for CPU tensors only.  Training
(dropout, gradients) comes with the training slice.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from tpurec_torch.ops import _build

MAX_LAYERS = 8                  # TPUREC_ATTN_MAX_LAYERS in the source
SMEM_LIMIT = 232448             # bytes of shared memory a block may use
_SIGNATURES = {
    "tpurec_field_attention_fwd": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]),
}


def smem_bytes(F: int, D: int, A: int, H: int) -> int:
    """Shared memory of one block (emb, x, qkv, scores, o of one row)."""
    return 4 * (F * D + 5 * F * A + H * F * F)


def _check(emb, flat_w, n_layers: int, n_heads: int) -> None:
    if emb.dtype != torch.float32 or emb.dim() != 3:
        raise ValueError(f"emb must be [B, F, D] float32, got "
                         f"{tuple(emb.shape)} {emb.dtype}")
    if len(flat_w) != 4 + 4 * n_layers:
        raise ValueError(f"flat_w must hold {4 + 4 * n_layers} tensors, "
                         f"got {len(flat_w)}")
    _, F, D = emb.shape
    A = flat_w[0].shape[1]
    if n_heads <= 0 or A % n_heads != 0:
        raise ValueError(f"atten dim {A} must divide into {n_heads} heads")
    want = [(D, A), (A,), (D, A), (A,)]
    for _ in range(n_layers):
        want += [(A, 3 * A), (3 * A,), (A, A), (A,)]
    if (flat_w[2] is None) != (flat_w[3] is None):
        raise ValueError("w_res and b_res are both given or both None")
    for i, (w, shape) in enumerate(zip(flat_w, want)):
        if w is None and i in (2, 3):
            continue
        if (tuple(w.shape) != shape or w.dtype != torch.float32
                or w.device != emb.device or not w.is_contiguous()):
            raise ValueError(f"flat_w[{i}] must be a contiguous float32 "
                             f"{shape} on {emb.device}, got "
                             f"{tuple(w.shape)} {w.dtype} {w.device}")


def field_attention(emb: torch.Tensor,
                    flat_w: Sequence[Optional[torch.Tensor]],
                    n_layers: int, n_heads: int) -> torch.Tensor:
    """[B, F, D] field embeddings -> [B, F, A] attention-stack output
    (after the V_res residual and ReLU), eval mode."""
    _check(emb, flat_w, n_layers, n_heads)
    if emb.device.type == "cpu":
        return field_attention_reference(emb, flat_w, n_layers, n_heads)
    if emb.device.type != "cuda":
        raise ValueError(f"field_attention runs on cuda or cpu, not "
                         f"{emb.device}")
    B, F, D = emb.shape
    A = flat_w[0].shape[1]
    if n_layers > MAX_LAYERS:
        raise ValueError(f"the kernel takes at most {MAX_LAYERS} layers, "
                         f"got {n_layers}")
    if D % 4 or A % 4 or (A // n_heads) % 4:
        raise ValueError(f"the kernel needs D, A and A/H to be multiples of "
                         f"4, got D={D}, A={A}, H={n_heads}")
    smem = smem_bytes(F, D, A, n_heads)
    if smem > SMEM_LIMIT:
        raise ValueError(f"F={F}, D={D}, A={A}, H={n_heads} needs {smem} B "
                         f"of shared memory per row, over {SMEM_LIMIT}")
    if any(w is not None and w.data_ptr() % 16 for w in flat_w):
        raise ValueError("the kernel needs 16-byte aligned weights")
    lib = _build.load("field_attention", _SIGNATURES)
    emb = emb.contiguous()
    if emb.data_ptr() % 16:
        emb = emb.clone()
    y = torch.empty((B, F, A), dtype=torch.float32, device=emb.device)
    ptrs = (ctypes.c_void_p * len(flat_w))(
        *[None if w is None else w.data_ptr() for w in flat_w])
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpurec_field_attention_fwd(
            emb.data_ptr(), ptrs, B, F, D, A, n_heads, n_layers,
            y.data_ptr(), stream)
    _build.check(lib, rc, "field_attention")
    field_attention.launches += 1
    return y


field_attention.launches = 0


def attention_layer(x, w_in, b_in, w_out, b_out, n_heads: int):
    """One multi-head self-attention layer over the field axis, [B, F, A]
    -> [B, F, A] (torch nn.MultiheadAttention math, eval)."""
    A = x.shape[-1]
    hd = A // n_heads
    qkv = torch.matmul(x, w_in) + b_in
    outs = []
    for h in range(n_heads):
        q = qkv[..., h * hd:(h + 1) * hd]
        k = qkv[..., A + h * hd:A + (h + 1) * hd]
        v = qkv[..., 2 * A + h * hd:2 * A + (h + 1) * hd]
        s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        outs.append(torch.matmul(torch.softmax(s, dim=-1), v))
    return torch.matmul(torch.cat(outs, dim=-1), w_out) + b_out


def field_attention_reference(emb, flat_w, n_layers: int, n_heads: int):
    """Plain PyTorch version: the math of ``attention_pallas.py::
    field_attention_reference`` (train=False)."""
    w_emb, b_emb, w_res, b_res = flat_w[:4]
    x = torch.matmul(emb, w_emb) + b_emb
    for l in range(n_layers):
        x = attention_layer(x, *flat_w[4 + 4 * l: 8 + 4 * l], n_heads)
    if w_res is not None:
        x = x + (torch.matmul(emb, w_res) + b_res)
    return torch.relu(x)

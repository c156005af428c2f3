"""Field-attention stack: kernel 2 (forward, eval and training) and kernel 3
(its backward) of the port, and their plain versions.

Replaces ``tpurec/ops/attention_pallas.py::fused_field_attention``: the
forward ``_fwd_kernel`` (run by ``_run_fwd``) and the backward
``_bwd_kernel`` (``_run_bwd``, through the custom VJP ``_ffa_bwd``).  Field
embeddings [B, F, D] -> ``relu(stack(x) + V_res)`` [B, F, A], the whole
aux-attention head of the tower models.  The CUDA source is
``tpurec_torch/csrc/field_attention.cu``; its header gives the designs.

Bound on the H100: float32 operations, about 2.76 MFLOP per batch row
forward at the flagship shapes (F=23, D=16, A=64, H=2, L=3): 1.41 GFLOP at
B=512, about 21 us at 67 TFLOP/s; the backward about 2.5x that.  The
kernels keep every intermediate of a row in shared memory, so the memory
traffic is the inputs, the outputs and (training) the layer inputs saved
for the backward.

``flat_w`` is the Pallas kernel's weight list, [w_emb, b_emb, w_res, b_res,
(w_in, b_in, w_out, b_out) x L], weights [in, out]; ``w_res``/``b_res``
are None when the head has no V_res residual.

Dropout (training) drops attention weights with a counter-based hash of
(seed, batch row, layer, head, i, j) that the CUDA source and
:func:`keep_mask` both compute, so the kernel and its plain version drop
the same weights and the backward regenerates the forward's mask.  The
seed is an int64 scalar tensor on the card, drawn per step
(:func:`draw_seed`) as ``nn/interactions.py:298-300`` draws it.

:func:`field_attention` launches the kernels for CUDA tensors (through
:class:`FieldAttentionFn` when training) and runs the plain version
(autograd gives its backward) for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import torch

from tpurec_torch.ops import _build

MAX_LAYERS = 8                  # TPUREC_ATTN_MAX_LAYERS in the source
SMEM_LIMIT = 232448             # bytes of shared memory a block may use
BWD_BLOCKS_PER_SM = 2           # backward grid: this many blocks per SM
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "tpurec_field_attention_fwd": (_I, [
        _P, _P, _I, _I, _I, _I, _I, _I, _P, ctypes.c_uint, ctypes.c_float,
        _I, _P, _P, _P]),
    "tpurec_field_attention_bwd": (_I, [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, ctypes.c_uint,
        ctypes.c_float, _I, _I, _P, _P, _P, _P]),
}
_M32 = 0xFFFFFFFF


def smem_bytes(F: int, D: int, A: int, H: int) -> int:
    """Shared memory of one forward block (emb, x, qkv, scores, o)."""
    return 4 * (F * D + 5 * F * A + H * F * F)


def bwd_smem_bytes(F: int, D: int, A: int, H: int) -> int:
    """Shared memory of one backward block (the source's
    ``bwd_smem_floats``: each buffer padded to 4 floats)."""
    def pad(n):
        return (n + 3) // 4 * 4
    return 4 * (2 * pad(F * D) + 4 * pad(F * A) + 2 * pad(3 * F * A)
                + 3 * pad(H * F * F))


def keep_threshold(rate: float) -> int:
    """Keep a weight when its 32 hash bits are below this
    (``attention_pallas.py::_keep_mask``)."""
    return min(int((1.0 - rate) * 2**32), 2**32 - 1)


def draw_seed(generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """An int64 scalar seed in [0, 2**31 - 1) drawn on ``device`` from
    ``generator`` (on the same device), without a host round trip."""
    return torch.randint(0, 2**31 - 1, (), generator=generator,
                         device=device, dtype=torch.int64)


# -- the dropout hash, in int64 arithmetic on uint32 values ---------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for 0 <= x < 2**32, without int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The source's ``mix32`` ("lowbias32")."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_mask(seed: torch.Tensor, B: int, layer: int, H: int, F: int,
              rate: float) -> torch.Tensor:
    """[B, H, F, F] bool: which attention weights layer ``layer`` keeps,
    the same bits as the kernels."""
    dev = seed.device
    s = seed.to(torch.int64).reshape(()) & _M32
    rows = torch.arange(B, device=dev, dtype=torch.int64) & _M32
    key = _mix32(_mix32(s ^ 0x9E3779B9) ^ rows)                    # [B]
    ctr = (layer * H * F * F
           + torch.arange(H * F * F, device=dev, dtype=torch.int64))
    bits = _mix32(key[:, None] ^ ctr[None, :]).reshape(B, H, F, F)
    return bits < keep_threshold(rate)


# -- checks shared by the wrappers ----------------------------------------

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


def _check_rate(rate: float, seed) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("dropout needs a seed")


def _check_kernel(emb, flat_w, n_layers: int, n_heads: int,
                  smem: int) -> None:
    """What the CUDA kernels do not take, refused before a launch."""
    if emb.device.type != "cuda":
        raise ValueError(f"field_attention runs on cuda or cpu, not "
                         f"{emb.device}")
    _, F, D = emb.shape
    A = flat_w[0].shape[1]
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"the kernel takes 1 to {MAX_LAYERS} layers, "
                         f"got {n_layers}")
    if D % 4 or A % 4 or (A // n_heads) % 4:
        raise ValueError(f"the kernel needs D, A and A/H to be multiples of "
                         f"4, got D={D}, A={A}, H={n_heads}")
    if smem > SMEM_LIMIT:
        raise ValueError(f"F={F}, D={D}, A={A}, H={n_heads} needs {smem} B "
                         f"of shared memory per row, over {SMEM_LIMIT}")
    if any(w is not None and w.data_ptr() % 16 for w in flat_w):
        raise ValueError("the kernel needs 16-byte aligned weights")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _ptrs(flat_w):
    return (ctypes.c_void_p * len(flat_w))(
        *[None if w is None else w.data_ptr() for w in flat_w])


def _seed_arg(seed, rate: float, device):
    """(pointer, keep-alive tensor) of the int64 device seed, or None."""
    if rate <= 0.0:
        return None, None
    s = seed.to(device=device, dtype=torch.int64).reshape(1).contiguous()
    return s.data_ptr(), s


# -- kernel launches -------------------------------------------------------

def field_attention_fwd(emb: torch.Tensor,
                        flat_w: Sequence[Optional[torch.Tensor]],
                        n_layers: int, n_heads: int, rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None,
                        save: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Kernel 2 -> (y [B, F, A], the layer inputs [L, B, F, A] when
    ``save``, else None), dropping attention weights at ``rate`` > 0 with
    the hash seeded by ``seed``.  CPU tensors run
    :func:`field_attention_reference`."""
    _check(emb, flat_w, n_layers, n_heads)
    _check_rate(rate, seed)
    if emb.device.type == "cpu":
        saved = [] if save else None
        y = field_attention_reference(emb, flat_w, n_layers, n_heads, rate,
                                      seed, saved=saved)
        return y, (torch.stack(saved) if save else None)
    B, F, D = emb.shape
    A = flat_w[0].shape[1]
    _check_kernel(emb, flat_w, n_layers, n_heads,
                  smem_bytes(F, D, A, n_heads))
    lib = _build.load("field_attention", _SIGNATURES)
    emb = _aligned(emb)
    y = torch.empty((B, F, A), dtype=torch.float32, device=emb.device)
    saved = (torch.empty((n_layers, B, F, A), dtype=torch.float32,
                         device=emb.device) if save else None)
    seed_ptr, seed_t = _seed_arg(seed, rate, emb.device)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpurec_field_attention_fwd(
            emb.data_ptr(), _ptrs(flat_w), B, F, D, A, n_heads, n_layers,
            seed_ptr, keep_threshold(rate), 1.0 - rate, int(rate > 0.0),
            y.data_ptr(), None if saved is None else saved.data_ptr(),
            stream)
    del seed_t
    _build.check(lib, rc, "field_attention")
    field_attention.launches += 1
    return y, saved


def field_attention_bwd(emb: torch.Tensor, dy: torch.Tensor,
                        saved: torch.Tensor,
                        flat_w: Sequence[Optional[torch.Tensor]],
                        n_layers: int, n_heads: int, rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
    """Kernel 3: dy [B, F, A] -> (demb [B, F, D], gradients of ``flat_w``),
    recomputing each layer from ``saved`` [L, B, F, A] (the training
    forward's layer inputs) with the forward's dropout mask.  CPU tensors
    run :func:`field_attention_bwd_reference`."""
    _check(emb, flat_w, n_layers, n_heads)
    _check_rate(rate, seed)
    B, F, D = emb.shape
    A = flat_w[0].shape[1]
    if tuple(dy.shape) != (B, F, A) or tuple(saved.shape) != (
            n_layers, B, F, A):
        raise ValueError(f"dy must be [{B}, {F}, {A}] and saved "
                         f"[{n_layers}, {B}, {F}, {A}]")
    if emb.device.type == "cpu":
        return field_attention_bwd_reference(emb, dy, saved, flat_w,
                                             n_layers, n_heads, rate, seed)
    _check_kernel(emb, flat_w, n_layers, n_heads,
                  bwd_smem_bytes(F, D, A, n_heads))
    lib = _build.load("field_attention", _SIGNATURES)
    emb, dy, saved = (_aligned(t.to(torch.float32)) for t in (emb, dy, saved))
    shapes = [None if w is None else tuple(w.shape) for w in flat_w]
    n_w = sum(math.prod(s) for s in shapes if s is not None)
    dev = emb.device
    grid = max(1, min(B, BWD_BLOCKS_PER_SM * torch.cuda.get_device_properties(
        dev).multi_processor_count))
    demb = torch.empty((B, F, D), dtype=torch.float32, device=dev)
    wgrad = torch.empty((n_w,), dtype=torch.float32, device=dev)
    partial = torch.empty((grid, n_w), dtype=torch.float32, device=dev)
    seed_ptr, seed_t = _seed_arg(seed, rate, dev)
    if B:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.tpurec_field_attention_bwd(
                emb.data_ptr(), dy.data_ptr(), saved.data_ptr(),
                _ptrs(flat_w), B, F, D, A, n_heads, n_layers, seed_ptr,
                keep_threshold(rate), 1.0 - rate, int(rate > 0.0), grid,
                demb.data_ptr(), partial.data_ptr(), wgrad.data_ptr(),
                stream)
        _build.check(lib, rc, "field_attention_bwd")
        field_attention_bwd.launches += 1
    else:
        wgrad.zero_()
    del seed_t
    grads, pos = [], 0
    for s in shapes:
        if s is None:
            grads.append(None)
            continue
        n = math.prod(s)
        grads.append(wgrad[pos:pos + n].view(s))
        pos += n
    return demb, grads


field_attention_bwd.launches = 0


class FieldAttentionFn(torch.autograd.Function):
    """Kernel 2 in training mode forward, kernel 3 backward."""

    @staticmethod
    def forward(ctx, emb, seed, n_layers, n_heads, rate, *flat_w):
        y, saved = field_attention_fwd(emb, flat_w, n_layers, n_heads, rate,
                                       seed, save=True)
        ctx.meta = (n_layers, n_heads, rate, [w is None for w in flat_w])
        ctx.save_for_backward(emb, seed, saved,
                              *[w for w in flat_w if w is not None])
        return y

    @staticmethod
    def backward(ctx, dy):
        n_layers, n_heads, rate, missing = ctx.meta
        emb, seed, saved, *ws = ctx.saved_tensors
        it = iter(ws)
        flat_w = [None if m else next(it) for m in missing]
        demb, grads = field_attention_bwd(emb, dy, saved, flat_w, n_layers,
                                          n_heads, rate, seed)
        return (demb, None, None, None, None, *grads)


def field_attention(emb: torch.Tensor,
                    flat_w: Sequence[Optional[torch.Tensor]],
                    n_layers: int, n_heads: int, train: bool = False,
                    rate: float = 0.0,
                    seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, F, D] field embeddings -> [B, F, A] attention-stack output
    (after the V_res residual and ReLU).

    ``train`` applies attention-weight dropout at ``rate`` with the hash
    seeded by ``seed`` (an int64 scalar tensor) and makes the result
    differentiable through kernel 3; eval ignores ``rate``."""
    rate = float(rate) if train else 0.0
    if not train or emb.device.type == "cpu":
        # the plain version on the CPU is differentiable by autograd
        return field_attention_fwd(emb, flat_w, n_layers, n_heads, rate,
                                   seed)[0]
    if seed is None and rate == 0.0:
        seed = torch.zeros((), dtype=torch.int64, device=emb.device)
    return FieldAttentionFn.apply(emb, seed, n_layers, n_heads, rate,
                                  *flat_w)


field_attention.launches = 0


# -- plain versions --------------------------------------------------------

def _heads(qkv, A: int, H: int):
    hd = A // H
    for h in range(H):
        yield (qkv[..., h * hd:(h + 1) * hd],
               qkv[..., A + h * hd:A + (h + 1) * hd],
               qkv[..., 2 * A + h * hd:2 * A + (h + 1) * hd])


def attention_layer(x, w_in, b_in, w_out, b_out, n_heads: int,
                    keep: Optional[torch.Tensor] = None, rate: float = 0.0):
    """One multi-head self-attention layer over the field axis, [B, F, A]
    -> [B, F, A] (torch nn.MultiheadAttention math); ``keep`` [B, H, F, F]
    drops attention weights, scaling kept ones by 1/(1 - rate)."""
    A = x.shape[-1]
    hd = A // n_heads
    qkv = torch.matmul(x, w_in) + b_in
    outs = []
    for h, (q, k, v) in enumerate(_heads(qkv, A, n_heads)):
        s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        a = torch.softmax(s, dim=-1)
        if keep is not None:
            a = torch.where(keep[:, h], a / (1.0 - rate), torch.zeros_like(a))
        outs.append(torch.matmul(a, v))
    return torch.matmul(torch.cat(outs, dim=-1), w_out) + b_out


def field_attention_reference(emb, flat_w, n_layers: int, n_heads: int,
                              rate: float = 0.0, seed=None,
                              saved: Optional[list] = None):
    """Plain PyTorch version: the math of ``attention_pallas.py::
    field_attention_reference``, with :func:`keep_mask` dropout at
    ``rate`` > 0.  ``saved``, when a list, collects each layer's input."""
    B, F, _ = emb.shape
    w_emb, b_emb, w_res, b_res = flat_w[:4]
    x = torch.matmul(emb, w_emb) + b_emb
    for l in range(n_layers):
        if saved is not None:
            saved.append(x)
        keep = (keep_mask(seed, B, l, n_heads, F, rate) if rate > 0.0
                else None)
        x = attention_layer(x, *flat_w[4 + 4 * l: 8 + 4 * l], n_heads,
                            keep, rate)
    if w_res is not None:
        x = x + (torch.matmul(emb, w_res) + b_res)
    return torch.relu(x)


def field_attention_bwd_reference(emb, dy, saved, flat_w, n_layers: int,
                                  n_heads: int, rate: float = 0.0,
                                  seed=None):
    """Plain PyTorch version of kernel 3, in its steps
    (``attention_pallas.py::_bwd_kernel``): the ReLU mask from the last
    layer recomputed from its saved input, then layer by layer backwards,
    each layer's internals recomputed from ``saved`` and its dropout mask
    regenerated from the seed."""
    B, F, D = emb.shape
    w_emb, b_emb, w_res, b_res = flat_w[:4]
    A = w_emb.shape[1]
    H = n_heads
    hd = A // H
    e2 = emb.reshape(B * F, D)

    def internals(l):
        w_in, b_in = flat_w[4 + 4 * l: 6 + 4 * l]
        qkv = torch.matmul(saved[l], w_in) + b_in
        keep = keep_mask(seed, B, l, H, F, rate) if rate > 0.0 else None
        heads, outs = [], []
        for h, (q, k, v) in enumerate(_heads(qkv, A, H)):
            a = torch.softmax(torch.matmul(q, k.transpose(-1, -2))
                              / math.sqrt(hd), dim=-1)
            kh = None if keep is None else keep[:, h]
            ad = a if kh is None else torch.where(kh, a / (1.0 - rate),
                                                  torch.zeros_like(a))
            heads.append((q, k, v, a, kh, ad))
            outs.append(torch.matmul(ad, v))
        return heads, torch.cat(outs, dim=-1)

    _, o = internals(n_layers - 1)
    w_out, b_out = flat_w[6 + 4 * (n_layers - 1): 8 + 4 * (n_layers - 1)]
    z = torch.matmul(o, w_out) + b_out
    grads: List[Optional[torch.Tensor]] = [None] * len(flat_w)
    if w_res is not None:
        z = z + torch.matmul(emb, w_res) + b_res
    dz = torch.where(z > 0, dy, torch.zeros_like(dy))
    dz2 = dz.reshape(B * F, A)
    if w_res is not None:
        grads[2] = e2.T @ dz2
        grads[3] = dz2.sum(0)
        demb = torch.matmul(dz, w_res.T)
    else:
        demb = torch.zeros_like(emb)
    dx = dz
    for l in range(n_layers - 1, -1, -1):
        w_in, _, w_out, _ = flat_w[4 + 4 * l: 8 + 4 * l]
        heads, o = internals(l)
        dx2 = dx.reshape(B * F, A)
        grads[6 + 4 * l] = o.reshape(B * F, A).T @ dx2
        grads[7 + 4 * l] = dx2.sum(0)
        do = torch.matmul(dx, w_out.T)
        dq, dk, dv = [], [], []
        for h, (q, k, v, a, kh, ad) in enumerate(heads):
            do_h = do[..., h * hd:(h + 1) * hd]
            d_ad = torch.matmul(do_h, v.transpose(-1, -2))
            dv.append(torch.matmul(ad.transpose(-1, -2), do_h))
            d_a = d_ad if kh is None else torch.where(
                kh, d_ad / (1.0 - rate), torch.zeros_like(d_ad))
            d_s = (d_a - (d_a * a).sum(-1, keepdim=True)) * a / math.sqrt(hd)
            dq.append(torch.matmul(d_s, k))
            dk.append(torch.matmul(d_s.transpose(-1, -2), q))
        dqkv = torch.cat(dq + dk + dv, dim=-1)
        dqkv2 = dqkv.reshape(B * F, 3 * A)
        grads[4 + 4 * l] = saved[l].reshape(B * F, A).T @ dqkv2
        grads[5 + 4 * l] = dqkv2.sum(0)
        dx = torch.matmul(dqkv, w_in.T)
    dx2 = dx.reshape(B * F, A)
    grads[0] = e2.T @ dx2
    grads[1] = dx2.sum(0)
    return demb + torch.matmul(dx, w_emb.T), grads

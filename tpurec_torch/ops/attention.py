"""Field-attention stack: kernel 2 (forward, eval and training) and kernel 3
(its backward) of the port; one attention layer: kernel 4 (forward) and
kernel 5 (its backward); and their plain versions.

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
for the backward.  The forward stacks R batch rows in a block
(:func:`rows_per_block`), reads each weight once per block and runs the
projections on the tensor cores in 3xTF32 (float32 accuracy); so do the
backward kernels 3 and 5 (:func:`bwd_config`, :func:`layer_bwd_config`),
on a persistent grid of at most one block per SM.

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

:func:`field_attention_layered` is the same head with one kernel per
attention layer (``attention_pallas.py::fused_field_attention_layered``):
the embedding projection and the V_res residual + ReLU are plain
products, each layer is :func:`fused_attention_layer` (kernel 4 forward,
kernel 5 backward, through :class:`AttentionLayerFn`).  Layer ``l`` draws
the stack's hash of layer ``l``, so the two forms drop the same weights
for one seed.  Bound on the H100: float32 operations, 0.89 MFLOP per row
forward and 2.48 backward at F=23, A=64, H=2 (B=512: 6.8 and 18.9 us).
Kernel 4 is kernel 2's layer body with its launch (:func:`layer_fwd_config`:
R rows a block, w_in and w_out staged, 3xTF32 products).
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import torch

from tpurec_torch.ops import _build

MAX_LAYERS = 8                  # TPUREC_ATTN_MAX_LAYERS in the source
SMEM_LIMIT = 232448             # bytes of shared memory a block may use
BWD_ROWS = 2                    # batch rows a backward block stacks, at most
FWD_THREADS = 512               # threads of a forward block (kFwdThreads)
FWD_ROWS = 96                   # stacked field rows a forward block holds
FWD_UNIT_ROWS = 48              # rows of a forward warp's unit (kFwdMTiles)
BWD_UNIT_ROWS = 16              # the backward pads stacked rows to this
FWD_FILL = 0.95                 # share of SMs the forward's grid must fill
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "tpurec_field_attention_fwd": (_I, [
        _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, ctypes.c_uint,
        ctypes.c_float, _I, _P, _P, _P]),
    "tpurec_field_attention_smem_bytes": (ctypes.c_longlong,
                                          [_I, _I, _I, _I, _I, _I]),
    "tpurec_field_attention_bwd": (_I, [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
        ctypes.c_uint, ctypes.c_float, _I, _I, _P, _P, _P, _P]),
    "tpurec_field_attention_bwd_smem_bytes": (ctypes.c_longlong,
                                              [_I, _I, _I, _I, _I, _I]),
    "tpurec_attention_layer_fwd": (_I, [
        _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, ctypes.c_uint,
        ctypes.c_float, _I, _P, _P]),
    "tpurec_attention_layer_smem_bytes": (ctypes.c_longlong,
                                          [_I, _I, _I, _I, _I]),
    "tpurec_attention_layer_bwd": (_I, [
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, ctypes.c_uint,
        ctypes.c_float, _I, _I, _P, _P, _P, _P]),
    "tpurec_attention_layer_bwd_smem_bytes": (ctypes.c_longlong,
                                              [_I, _I, _I, _I, _I]),
}
_M32 = 0xFFFFFFFF


def _fwd_stride(k: int) -> int:
    """The source's ``fwd_stride``: k rounded up to 8, plus 4."""
    return (k + 7) // 8 * 8 + 4


def _fwd_wstride(n: int) -> int:
    """The source's ``fwd_wstride``: n rounded up to 8, = 8 or 24 mod 32."""
    c = (n + 7) // 8 * 8
    return c + 8 if c % 16 == 0 else c


def smem_bytes(F: int, D: int, A: int, H: int, R: int = 1,
               stage: bool = True) -> int:
    """Shared memory of one forward block of R batch rows (the source's
    ``FwdLayout``): x [M, .] or the scores [R*H*F, .]; qkv [M, .] or emb
    [M, .]; with ``stage``, the two weight buffers.  M = R*F padded to
    whole row units."""
    M = (R * F + FWD_UNIT_ROWS - 1) // FWD_UNIT_ROWS * FWD_UNIT_ROWS
    xs = (max(M * _fwd_stride(A), R * H * F * _fwd_stride(F)) + 3) // 4 * 4
    q = M * max(_fwd_stride(3 * A), _fwd_stride(D))
    if not stage:
        return 4 * (xs + q)
    wa = max(A * _fwd_wstride(3 * A), D * _fwd_wstride(A))
    wb = max(A, D) * _fwd_wstride(A)
    return 4 * (xs + q + wa + wb)


def rows_per_block(B: int, F: int, D: int, A: int, H: int,
                   n_sm: int = 132, stage: bool = True) -> int:
    """R, the batch rows kernel 2 stacks in a block: as many as fit
    ``FWD_ROWS`` stacked field rows (at F=23, R=4: the fastest R on the
    H100 at B=4096) and the shared memory, but no more than leave
    ``FWD_FILL`` of the card's ``n_sm`` SMs a block (B=512 at F=23: R=4,
    128 blocks on 132 SMs); 1 when even R=2 would leave SMs idle."""
    r = max(1, FWD_ROWS // F)
    while r > 1 and smem_bytes(F, D, A, H, r, stage) > SMEM_LIMIT:
        r -= 1
    while r > 1 and -(-B // r) < FWD_FILL * n_sm:
        r -= 1
    return r


def fwd_config(B: int, F: int, D: int, A: int, H: int,
               n_sm: int = 132) -> Tuple[int, bool, int]:
    """(R, stage, shared memory bytes of a block) of kernel 2's launch at
    batch size B: the weights staged in shared memory where they fit
    beside a block's activations, else read from device memory;
    ValueError when even a block of one batch row does not fit
    ``SMEM_LIMIT``."""
    for stage in (True, False):
        R = rows_per_block(B, F, D, A, H, n_sm, stage)
        smem = smem_bytes(F, D, A, H, R, stage)
        if smem <= SMEM_LIMIT:
            return R, stage, smem
    raise ValueError(f"F={F}, D={D}, A={A}, H={H} needs {smem} B of "
                     f"shared memory per block, over {SMEM_LIMIT}")


def bwd_smem_bytes(F: int, D: int, A: int, H: int, R: int = 1,
                   stage: bool = True) -> int:
    """Shared memory of one backward block of R batch rows (the source's
    ``BwdLayout``; D = 0 for kernel 5): with ``stage``, w_in and w_out;
    qkv and dqkv [M, .]; the layer input, o, dO and dx [M, .]; the softmax and
    the score gradients [R*H*F, .]; for kernel 3, emb and demb's residual
    part [M, .].  M = R*F padded to whole m16 tiles."""
    M = (R * F + BWD_UNIT_ROWS - 1) // BWD_UNIT_ROWS * BWD_UNIT_ROWS
    floats = (2 * M * _fwd_stride(3 * A) + 4 * M * _fwd_stride(A)
              + 2 * R * H * F * _fwd_stride(F)
              + (2 * M * _fwd_stride(D) if D else 0))
    if stage:
        floats += A * (_fwd_wstride(3 * A) + _fwd_wstride(A))
    return 4 * floats


def bwd_grid(B: int, R: int, n_sm: int = 132) -> int:
    """Blocks of a backward launch: at most one per SM (the partial sums
    stay in L2), each walking the same number of groups of R batch rows
    within one, so the grid has no tail wave."""
    groups = -(-B // R)
    if groups == 0:
        return 0
    return -(-groups // -(-groups // n_sm))


def bwd_config(B: int, F: int, D: int, A: int, H: int,
               n_sm: int = 132) -> Tuple[int, bool, int, int]:
    """(R, stage, shared memory bytes of a block, grid) of kernel 3's
    launch at batch size B: ``BWD_ROWS`` batch rows a block (R=2 at F=23:
    the fastest at B=512 in chip_smoke.py's sweep), fewer where they do
    not fit, and the weights staged in shared memory unless even one row
    a block does not fit beside them; ValueError when nothing fits
    ``SMEM_LIMIT``."""
    smem = 0
    for stage in (True, False):
        for R in range(BWD_ROWS, 0, -1):
            smem = bwd_smem_bytes(F, D, A, H, R, stage)
            if smem <= SMEM_LIMIT:
                return R, stage, smem, bwd_grid(B, R, n_sm)
    raise ValueError(f"F={F}, D={D}, A={A}, H={H} needs {smem} B of "
                     f"shared memory per block, over {SMEM_LIMIT}")


def layer_bwd_config(B: int, F: int, A: int, H: int,
                     n_sm: int = 132) -> Tuple[int, bool, int, int]:
    """(R, stage, shared memory bytes, grid) of kernel 5's launch, chosen
    as :func:`bwd_config` chooses kernel 3's."""
    return bwd_config(B, F, 0, A, H, n_sm)


def layer_smem_bytes(F: int, A: int, H: int, R: int = 1,
                     stage: bool = True) -> int:
    """Shared memory of one kernel-4 block of R batch rows: kernel 2's
    layout without the embedding operands (x or the scores, qkv, and with
    ``stage`` w_in and w_out)."""
    return smem_bytes(F, 0, A, H, R, stage)


def layer_fwd_config(B: int, F: int, A: int, H: int,
                     n_sm: int = 132) -> Tuple[int, bool, int]:
    """(R, stage, shared memory bytes of a block) of kernel 4's launch,
    chosen as :func:`fwd_config` chooses kernel 2's (B=512 at F=23: R=4,
    128 blocks, w_in and w_out staged)."""
    return fwd_config(B, F, 0, A, H, n_sm)


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
                         f"of shared memory per block, over {SMEM_LIMIT}")
    if any(w is not None and w.data_ptr() % 16 for w in flat_w):
        raise ValueError("the kernel needs 16-byte aligned weights")


_SM_COUNT = {}


def _sm_count(device) -> int:
    """The SM count of a CUDA device (cached)."""
    i = torch.device(device).index
    i = torch.cuda.current_device() if i is None else i
    if i not in _SM_COUNT:
        props = torch.cuda.get_device_properties(i)
        _SM_COUNT[i] = props.multi_processor_count
    return _SM_COUNT[i]


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
    if emb.device.type != "cuda":
        raise ValueError(f"field_attention runs on cuda or cpu, not "
                         f"{emb.device}")
    B, F, D = emb.shape
    A = flat_w[0].shape[1]
    R, stage, smem = fwd_config(B, F, D, A, n_heads, _sm_count(emb.device))
    _check_kernel(emb, flat_w, n_layers, n_heads, smem)
    lib = _build.load("field_attention", _SIGNATURES)
    emb = _aligned(emb)
    y = torch.empty((B, F, A), dtype=torch.float32, device=emb.device)
    saved = (torch.empty((n_layers, B, F, A), dtype=torch.float32,
                         device=emb.device) if save else None)
    seed_ptr, seed_t = _seed_arg(seed, rate, emb.device)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpurec_field_attention_fwd(
            emb.data_ptr(), _ptrs(flat_w), B, R, int(stage), F, D, A,
            n_heads, n_layers,
            seed_ptr, keep_threshold(rate), 1.0 - rate, int(rate > 0.0),
            y.data_ptr(), None if saved is None else saved.data_ptr(),
            stream)
    del seed_t
    _build.check(lib, rc, "field_attention")
    field_attention.launches += 1
    return y, saved


def field_attention_bwd(emb: torch.Tensor, dy: torch.Tensor,
                        saved: torch.Tensor, y: torch.Tensor,
                        flat_w: Sequence[Optional[torch.Tensor]],
                        n_layers: int, n_heads: int, rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
    """Kernel 3: dy [B, F, A] -> (demb [B, F, D], gradients of ``flat_w``),
    recomputing each layer from ``saved`` [L, B, F, A] (the training
    forward's layer inputs) with the forward's dropout mask.  The last
    ReLU passes dy where the forward's output ``y`` [B, F, A] is above 0:
    the branch the forward took.  CPU tensors run
    :func:`field_attention_bwd_reference`."""
    _check(emb, flat_w, n_layers, n_heads)
    _check_rate(rate, seed)
    B, F, D = emb.shape
    A = flat_w[0].shape[1]
    if (tuple(dy.shape) != (B, F, A) or tuple(y.shape) != (B, F, A)
            or tuple(saved.shape) != (n_layers, B, F, A)):
        raise ValueError(f"dy and y must be [{B}, {F}, {A}] and saved "
                         f"[{n_layers}, {B}, {F}, {A}]")
    if emb.device.type == "cpu":
        return field_attention_bwd_reference(emb, dy, saved, y, flat_w,
                                             n_layers, n_heads, rate, seed)
    if emb.device.type != "cuda":
        raise ValueError(f"field_attention runs on cuda or cpu, not "
                         f"{emb.device}")
    dev = emb.device
    R, stage, smem, grid = bwd_config(B, F, D, A, n_heads, _sm_count(dev))
    _check_kernel(emb, flat_w, n_layers, n_heads, smem)
    lib = _build.load("field_attention", _SIGNATURES)
    emb, dy, saved, y = (_aligned(t.to(torch.float32))
                         for t in (emb, dy, saved, y))
    shapes = [None if w is None else tuple(w.shape) for w in flat_w]
    n_w = sum(math.prod(s) for s in shapes if s is not None)
    demb = torch.empty((B, F, D), dtype=torch.float32, device=dev)
    wgrad = torch.empty((n_w,), dtype=torch.float32, device=dev)
    seed_ptr, seed_t = _seed_arg(seed, rate, dev)
    if B:
        partial = torch.empty((grid, n_w), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.tpurec_field_attention_bwd(
                emb.data_ptr(), dy.data_ptr(), saved.data_ptr(),
                y.data_ptr(), _ptrs(flat_w), B, R, int(stage), F, D, A, n_heads, n_layers,
                seed_ptr, keep_threshold(rate), 1.0 - rate, int(rate > 0.0),
                grid, demb.data_ptr(), partial.data_ptr(), wgrad.data_ptr(),
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
    """Kernel 2 in training mode forward, kernel 3 backward.  The output
    is kept for the backward, which takes the last ReLU's branch from
    it."""

    @staticmethod
    def forward(ctx, emb, seed, n_layers, n_heads, rate, *flat_w):
        y, saved = field_attention_fwd(emb, flat_w, n_layers, n_heads, rate,
                                       seed, save=True)
        ctx.meta = (n_layers, n_heads, rate, [w is None for w in flat_w])
        ctx.save_for_backward(emb, seed, saved, y,
                              *[w for w in flat_w if w is not None])
        return y

    @staticmethod
    def backward(ctx, dy):
        n_layers, n_heads, rate, missing = ctx.meta
        emb, seed, saved, y, *ws = ctx.saved_tensors
        it = iter(ws)
        flat_w = [None if m else next(it) for m in missing]
        demb, grads = field_attention_bwd(emb, dy, saved, y, flat_w,
                                          n_layers, n_heads, rate, seed)
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


# -- one attention layer (kernels 4 and 5) ----------------------------------

def _check_layer(x, layer_w, n_heads: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"x must be [B, F, A] float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    A = x.shape[-1]
    if n_heads <= 0 or A % n_heads != 0:
        raise ValueError(f"atten dim {A} must divide into {n_heads} heads")
    for name, w, shape in zip(("w_in", "b_in", "w_out", "b_out"), layer_w,
                              ((A, 3 * A), (3 * A,), (A, A), (A,))):
        if (tuple(w.shape) != shape or w.dtype != torch.float32
                or w.device != x.device):
            raise ValueError(f"{name} must be float32 {shape} on "
                             f"{x.device}, got {tuple(w.shape)} {w.dtype} "
                             f"{w.device}")


def _check_layer_kernel(x, n_heads: int, layer: int, smem: int) -> None:
    """What kernels 4 and 5 do not take, refused before a launch."""
    if x.device.type != "cuda":
        raise ValueError(f"the attention layer runs on cuda or cpu, not "
                         f"{x.device}")
    _, F, A = x.shape
    if A % 4 or (A // n_heads) % 4:
        raise ValueError(f"the kernel needs A and A/H to be multiples of 4, "
                         f"got A={A}, H={n_heads}")
    if layer < 0:
        raise ValueError(f"layer index must be >= 0, got {layer}")
    if smem > SMEM_LIMIT:
        raise ValueError(f"F={F}, A={A}, H={n_heads} needs {smem} B of "
                         f"shared memory per block, over {SMEM_LIMIT}")


def attention_layer_fwd(x: torch.Tensor, w_in: torch.Tensor,
                        b_in: torch.Tensor, w_out: torch.Tensor,
                        b_out: torch.Tensor, n_heads: int, layer: int = 0,
                        rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 4: one attention layer, x [B, F, A] -> [B, F, A], dropping
    attention weights at ``rate`` > 0 with the hash of layer ``layer``
    seeded by ``seed``.  CPU tensors run :func:`attention_layer`."""
    layer_w = (w_in, b_in, w_out, b_out)
    _check_layer(x, layer_w, n_heads)
    _check_rate(rate, seed)
    B, F, A = x.shape
    if x.device.type == "cpu":
        keep = (keep_mask(seed, B, layer, n_heads, F, rate) if rate > 0.0
                else None)
        return attention_layer(x, *layer_w, n_heads, keep, rate)
    if x.device.type != "cuda":
        raise ValueError(f"the attention layer runs on cuda or cpu, not "
                         f"{x.device}")
    R, stage, smem = layer_fwd_config(B, F, A, n_heads, _sm_count(x.device))
    _check_layer_kernel(x, n_heads, layer, smem)
    lib = _build.load("field_attention", _SIGNATURES)
    x = _aligned(x)
    layer_w = [_aligned(w) for w in layer_w]
    y = torch.empty((B, F, A), dtype=torch.float32, device=x.device)
    seed_ptr, seed_t = _seed_arg(seed, rate, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpurec_attention_layer_fwd(
            x.data_ptr(), _ptrs(layer_w), B, R, int(stage), F, A, n_heads,
            layer, seed_ptr, keep_threshold(rate), 1.0 - rate,
            int(rate > 0.0), y.data_ptr(), stream)
    del seed_t
    _build.check(lib, rc, "attention_layer")
    fused_attention_layer.launches += 1
    return y


def attention_layer_bwd(x: torch.Tensor, dy: torch.Tensor,
                        w_in: torch.Tensor, b_in: torch.Tensor,
                        w_out: torch.Tensor, b_out: torch.Tensor,
                        n_heads: int, layer: int = 0, rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Kernel 5: dy [B, F, A] -> (dx [B, F, A], [gw_in, gb_in, gw_out,
    gb_out]), recomputing the layer from its input ``x`` with the
    forward's dropout mask.  CPU tensors run
    :func:`attention_layer_bwd_reference`."""
    layer_w = (w_in, b_in, w_out, b_out)
    _check_layer(x, layer_w, n_heads)
    _check_rate(rate, seed)
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"dy must be {tuple(x.shape)}, got "
                         f"{tuple(dy.shape)}")
    if x.device.type == "cpu":
        return attention_layer_bwd_reference(x, dy, *layer_w, n_heads,
                                             layer, rate, seed)
    B, F, A = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"the attention layer runs on cuda or cpu, not "
                         f"{x.device}")
    dev = x.device
    R, stage, smem, grid = layer_bwd_config(B, F, A, n_heads, _sm_count(dev))
    _check_layer_kernel(x, n_heads, layer, smem)
    lib = _build.load("field_attention", _SIGNATURES)
    x, dy = (_aligned(t.to(torch.float32)) for t in (x, dy))
    layer_w = [_aligned(w) for w in layer_w]
    n_w = 4 * A * A + 4 * A
    dx = torch.empty((B, F, A), dtype=torch.float32, device=dev)
    # the ordered reduction writes every element; zeros only for B = 0
    wgrad = (torch.empty if B else torch.zeros)((n_w,), dtype=torch.float32,
                                                device=dev)
    if B:
        partial = torch.empty((grid, n_w), dtype=torch.float32, device=dev)
        seed_ptr, seed_t = _seed_arg(seed, rate, dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.tpurec_attention_layer_bwd(
                x.data_ptr(), dy.data_ptr(), _ptrs(layer_w), B, R,
                int(stage), F, A, n_heads, layer, seed_ptr,
                keep_threshold(rate), 1.0 - rate, int(rate > 0.0), grid,
                dx.data_ptr(), partial.data_ptr(), wgrad.data_ptr(), stream)
        del seed_t
        _build.check(lib, rc, "attention_layer_bwd")
        attention_layer_bwd.launches += 1
    sizes = (3 * A * A, 3 * A, A * A, A)
    return dx, [g.view(w.shape) for g, w in zip(wgrad.split(sizes), layer_w)]


attention_layer_bwd.launches = 0


class AttentionLayerFn(torch.autograd.Function):
    """Kernel 4 forward, kernel 5 backward from the saved layer input."""

    @staticmethod
    def forward(ctx, x, seed, n_heads, layer, rate, w_in, b_in, w_out,
                b_out):
        ctx.meta = (n_heads, layer, rate)
        ctx.save_for_backward(x, seed, w_in, b_in, w_out, b_out)
        return attention_layer_fwd(x, w_in, b_in, w_out, b_out, n_heads,
                                   layer, rate, seed)

    @staticmethod
    def backward(ctx, dy):
        n_heads, layer, rate = ctx.meta
        x, seed, *layer_w = ctx.saved_tensors
        dx, grads = attention_layer_bwd(x, dy, *layer_w, n_heads, layer,
                                        rate, seed)
        return (dx, None, None, None, None, *grads)


def fused_attention_layer(x: torch.Tensor, w_in: torch.Tensor,
                          b_in: torch.Tensor, w_out: torch.Tensor,
                          b_out: torch.Tensor, n_heads: int, layer: int = 0,
                          train: bool = False, rate: float = 0.0,
                          seed: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """One attention layer [B, F, A] -> [B, F, A] (``attention_pallas.py::
    fused_attention_layer``), differentiable in x and the weights (kernel 5
    on the card).  ``train`` drops attention weights at ``rate`` with the
    hash of layer ``layer`` seeded by ``seed``; eval ignores ``rate``."""
    rate = float(rate) if train else 0.0
    layer_w = (w_in, b_in, w_out, b_out)
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *layer_w))
    if x.device.type == "cpu" or not wants_grad:
        # the plain version on the CPU is differentiable by autograd
        return attention_layer_fwd(x, *layer_w, n_heads, layer, rate, seed)
    if seed is None and rate == 0.0:
        seed = torch.zeros((), dtype=torch.int64, device=x.device)
    return AttentionLayerFn.apply(x, seed, n_heads, layer, rate, *layer_w)


fused_attention_layer.launches = 0


def field_attention_layered(emb: torch.Tensor,
                            flat_w: Sequence[Optional[torch.Tensor]],
                            n_layers: int, n_heads: int, train: bool = False,
                            rate: float = 0.0,
                            seed: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The attention head with one kernel per layer (``attention_pallas.py::
    fused_field_attention_layered``): [B, F, D] -> [B, F, A], the same
    function as :func:`field_attention`.  The embedding projection and the
    V_res residual + ReLU are plain products, as JAX leaves them to XLA."""
    _check(emb, flat_w, n_layers, n_heads)
    rate = float(rate) if train else 0.0
    _check_rate(rate, seed)
    w_emb, b_emb, w_res, b_res = flat_w[:4]
    x = torch.matmul(emb, w_emb) + b_emb
    for l in range(n_layers):
        x = fused_attention_layer(x, *flat_w[4 + 4 * l: 8 + 4 * l], n_heads,
                                  l, train, rate, seed)
    if w_res is not None:
        x = x + (torch.matmul(emb, w_res) + b_res)
    return torch.relu(x)


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


def attention_layer_bwd_reference(x, dy, w_in, b_in, w_out, b_out,
                                  n_heads: int, layer: int = 0,
                                  rate: float = 0.0, seed=None):
    """Plain PyTorch version of kernel 5: autograd through
    :func:`attention_layer` with the layer's keep mask.  -> (dx, [gw_in,
    gb_in, gw_out, gb_out])."""
    B, F, _ = x.shape
    keep = keep_mask(seed, B, layer, n_heads, F, rate) if rate > 0.0 else None
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, w_in, b_in, w_out, b_out)]
        y = attention_layer(*leaves, n_heads, keep, rate)
        grads = torch.autograd.grad(y, leaves, dy)
    return grads[0], list(grads[1:])


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


def field_attention_bwd_reference(emb, dy, saved, y, flat_w, n_layers: int,
                                  n_heads: int, rate: float = 0.0,
                                  seed=None):
    """Plain PyTorch version of kernel 3, in its steps
    (``attention_pallas.py::_bwd_kernel``): the ReLU mask from the
    forward's output ``y`` (dy passes where y > 0), then layer by layer
    backwards, each layer's internals recomputed from ``saved`` and its
    dropout mask regenerated from the seed."""
    B, F, D = emb.shape
    w_emb, _, w_res, _ = flat_w[:4]
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

    grads: List[Optional[torch.Tensor]] = [None] * len(flat_w)
    dz = torch.where(y > 0, dy, torch.zeros_like(dy))
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

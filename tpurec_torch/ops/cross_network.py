"""DCN-v1 cross network: kernel 8 (forward) and kernel 9 (backward) of the
port, and their plain versions.

Replaces ``tpurec/ops/crossnet_pallas.py::cross_network_fused``: the
forward ``_fwd_kernel`` (run by ``_pallas_fwd``) and the backward
``_bwd_kernel`` (``_pallas_bwd``, through the custom VJP ``_fused_bwd``).
x [B, D], w and b [L, D]:

    x_{l+1} = x0 * (x_l . w_l) + b_l + x_l,   out = x_L

The CUDA source is ``tpurec_torch/csrc/cross_network.cu``; its header gives
the design.  Bound on the H100: bytes (the rows read and written, about
1.5 MB forward and 2.3 MB backward at B=512, D=368), well under a
microsecond, so the launch and the loads' latency bound both kernels at
the models' batch sizes.  Both take one warp reduction a row: with c_l =
x0 . w_l, the layers' dot products follow from a scalar recurrence.
Kernel 8 (:func:`fwd_config`) gives a block ``FWD_WARPS`` warps and a
warp 1 or 2 rows (:func:`rows_per_warp`, where the blocks still fill the
card), with w and b read straight into registers three layers at a time
(any number of layers).  Kernel 9 is one launch (:func:`bwd_config`):
clusters of ``CLUSTER`` blocks, each warp carrying its rows K at a time,
the weight gradients summed in a fixed order across warps, blocks, a
cluster's blocks and, by the last block to finish, across clusters; it
takes at most ``BWD_MAX_LAYERS`` layers.

:func:`cross_network` launches the kernels for CUDA tensors (through
:class:`CrossNetworkFn` when a gradient is wanted) and runs the plain
recurrence (autograd gives its backward) for CPU tensors only.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tpurec_torch.ops import _build
from tpurec_torch.ops.attention import _sm_count

SMEM_LIMIT = 232448             # bytes of shared memory a block may use
MAX_CHUNKS = 8                  # kMaxChunks in the source
BWD_MAX_LAYERS = 8              # kMaxLayers in the source
FWD_WARPS = 4                   # warps of a forward block
FWD_MAX_WARPS = 8               # kMaxFwdWarps in the source
CLUSTER = 8                     # blocks of a backward cluster (kCluster)
BWD_WARPS = 4                   # warps of a backward block (fewer if D is big)
BWD_MAX_WARPS = 8               # kMaxBwdWarps in the source
BWD_MAX_CLUSTERS = 16           # kMaxClusters in the source
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "tpurec_cross_network_fwd": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _P, _P]),
    "tpurec_cross_network_bwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _I, _P, _P, _P, _P, _P]),
    "tpurec_cross_network_bwd_smem_bytes": (ctypes.c_longlong,
                                            [_I, _I, _I, _I]),
    "tpurec_cross_network_rows_per_warp": (_I, [_I, _I]),
    "tpurec_cross_network_empty": (_I, [_I, _I, ctypes.c_longlong, _P]),
    "tpurec_cross_network_empty_fwd": (_I, [_I, _I, _P]),
}
_COUNTERS = {}


def rows_per_warp(D: int, vec: int) -> int:
    """Rows a warp of either kernel carries at a time (the source's
    ``rows_per_warp``): 2 while a lane's share of a row is at most 4
    chunks of ``vec`` floats, else 1."""
    return 2 if -(-D // (32 * vec)) <= 4 else 1


def _check_chunks(D: int, vec: int) -> None:
    if -(-D // (32 * vec)) > MAX_CHUNKS:
        raise ValueError(f"D={D} is over {MAX_CHUNKS} chunks of {vec} "
                         f"floats a lane")


def fwd_config(B: int, D: int, L: int, vec: int, n_sm: int = 132,
               warps: int = FWD_WARPS) -> Tuple[int, int, int]:
    """(rows a warp, warps a block, grid) of kernel 8's launch: ``warps``
    warps a block, each taking :func:`rows_per_warp` rows where that still
    gives every SM a block, else 1 (B=512 at D=368: 1 row a warp, 128
    blocks of 4 warps, one wave; B=4096: 2 rows a warp, 512 blocks), at
    any number of layers L; ValueError for a lane's share of a row over
    ``MAX_CHUNKS`` chunks."""
    _check_chunks(D, vec)
    K = rows_per_warp(D, vec)
    if -(-B // (K * warps)) < n_sm:
        K = 1
    return K, warps, max(1, -(-B // (K * warps)))


def bwd_smem_bytes(D: int, L: int, vec: int, warps: int) -> int:
    """Shared memory of one backward block (the source's ``BwdLayout``): w
    and the running sums of b [L, D]; each warp's dw/db slice [2, L, D];
    32 dot products a warp; 3 scalars a layer of each of a warp's rows
    (room for 8 layers)."""
    K = rows_per_warp(D, vec)
    return 4 * (2 * L * D + warps * 2 * L * D + 32 * warps
                + warps * K * 3 * BWD_MAX_LAYERS)


def bwd_config(B: int, D: int, L: int, vec: int, n_sm: int = 132,
               warps: int = BWD_WARPS) -> Tuple[int, int, int, int]:
    """(warps a block, rows a warp carries at a time, grid, shared memory
    bytes of a block) of kernel 9's launch: ``warps`` warps a block
    (fewer where the slices do not fit), and clusters of ``CLUSTER``
    blocks, as many as give every warp its rows in one pass, up to one
    block per SM (B=512 at D=368: 4 warps of 2 rows, 64 blocks, 8
    clusters whose partial sums take 70 KB); ValueError for more than
    ``BWD_MAX_LAYERS`` layers, a lane's share of a row over
    ``MAX_CHUNKS`` chunks, or a block that does not fit even one warp."""
    if L > BWD_MAX_LAYERS:
        raise ValueError(f"the cross-network backward takes 1 to "
                         f"{BWD_MAX_LAYERS} layers, got {L}")
    _check_chunks(D, vec)
    K = rows_per_warp(D, vec)
    for W in range(warps, 0, -1):
        smem = bwd_smem_bytes(D, L, vec, W)
        if smem <= SMEM_LIMIT:
            clusters = -(-B // (CLUSTER * W * K))
            clusters = max(1, min(clusters, n_sm // CLUSTER,
                                  BWD_MAX_CLUSTERS))
            return W, K, CLUSTER * clusters, smem
    raise ValueError(f"L={L}, D={D}: the backward needs {smem} B of shared "
                     f"memory per block, over {SMEM_LIMIT}")


def _counter(device, stream: int) -> torch.Tensor:
    """Kernel 9's finishing counter for one stream of a device: zero
    between launches (each launch's last block resets it)."""
    key = (device.index, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def _check(x, w, b) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be [B, D] float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    D = x.shape[1]
    if (w.dim() != 2 or w.shape[1] != D or tuple(b.shape) != tuple(w.shape)
            or w.dtype != torch.float32 or b.dtype != torch.float32):
        raise ValueError(f"w and b must be [L, {D}] float32, got "
                         f"{tuple(w.shape)} {w.dtype} and {tuple(b.shape)} "
                         f"{b.dtype}")
    if w.shape[0] < 1:
        raise ValueError("the cross network needs at least one layer")
    if not x.device == w.device == b.device:
        raise ValueError("x, w and b must share one device")


def _kernel_args(*ts: torch.Tensor) -> Tuple[int, Tuple[torch.Tensor, ...]]:
    """-> (vec, the tensors made contiguous): 16-byte loads (vec 4) when D
    is a multiple of 4 and every tensor is 16-byte aligned, else 1."""
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"cross_network runs on cuda or cpu, not {dev}")
    ts = tuple(t.contiguous() for t in ts)
    D = ts[0].shape[-1]
    vec = 4 if D % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ts) else 1
    if D > 32 * MAX_CHUNKS * vec:
        raise ValueError(f"the cross-network kernels take D <= "
                         f"{32 * MAX_CHUNKS * vec} (at {vec}-float loads), "
                         f"got D={D}")
    return vec, ts


def cross_network_fwd(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Kernel 8: x [B, D], w and b [L, D] -> the stack's output [B, D].
    CPU tensors run :func:`cross_network_reference`."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return cross_network_reference(x, w, b)
    vec, (x, w, b) = _kernel_args(x, w, b)
    (B, D), L = x.shape, w.shape[0]
    K, warps, _ = fwd_config(B, D, L, vec, _sm_count(x.device))
    lib = _build.load("cross_network", _SIGNATURES)
    out = torch.empty((B, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpurec_cross_network_fwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), B, D, L, vec, warps, K,
            out.data_ptr(), stream)
    _build.check(lib, rc, "cross_network")
    cross_network.launches += 1
    return out


def cross_network_bwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      g: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 9: the forward's input x [B, D], w, b [L, D] and the output's
    gradient g [B, D] -> (dx [B, D], dw [L, D], db [L, D]), recomputing
    the layer states from x.  CPU tensors run
    :func:`cross_network_bwd_reference`."""
    _check(x, w, b)
    if tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"g must be {tuple(x.shape)}, got {tuple(g.shape)}")
    g = g.to(torch.float32)
    if x.device.type == "cpu":
        return cross_network_bwd_reference(x, w, b, g)
    vec, (x, w, b, g) = _kernel_args(x, w, b, g)
    (B, D), L = x.shape, w.shape[0]
    dev = x.device
    dx = torch.empty((B, D), dtype=torch.float32, device=dev)
    # the launch writes every element of dw and db; zeros only for B = 0
    dw_db = (torch.empty if B else torch.zeros)(
        (2, L, D), dtype=torch.float32, device=dev)
    if B == 0:
        return dx, dw_db[0], dw_db[1]
    warps, _, grid, _ = bwd_config(B, D, L, vec, _sm_count(dev))
    partial = torch.empty((grid // CLUSTER, 2, L, D), dtype=torch.float32,
                          device=dev)           # unused with one cluster
    lib = _build.load("cross_network", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpurec_cross_network_bwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(), B, D, L,
            vec, warps, grid, dx.data_ptr(),
            partial.data_ptr(), _counter(dev, stream).data_ptr(),
            dw_db.data_ptr(), stream)
    _build.check(lib, rc, "cross_network_bwd")
    cross_network_bwd.launches += 1
    return dx, dw_db[0], dw_db[1]


cross_network_bwd.launches = 0


class CrossNetworkFn(torch.autograd.Function):
    """Kernel 8 forward, kernel 9 backward from the saved x, w, b."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return cross_network_fwd(x, w, b)

    @staticmethod
    def backward(ctx, g):
        # kernel 9 computes dx, dw and db together; autograd drops the ones
        # no input asked for
        return cross_network_bwd(*ctx.saved_tensors, g)


def cross_network(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """The cross stack, x [B, D], w and b [L, D] -> [B, D], differentiable
    in x, w and b (kernel 9 on the card)."""
    _check(x, w, b)
    if x.device.type == "cpu":
        # the plain version on the CPU is differentiable by autograd
        return cross_network_reference(x, w, b)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return CrossNetworkFn.apply(x, w, b)
    return cross_network_fwd(x, w, b)


cross_network.launches = 0


# -- plain versions --------------------------------------------------------

def cross_network_reference(x, w, b):
    """Plain PyTorch version: the recurrence of ``crossnet_pallas.py::
    cross_network_reference``."""
    x0 = x
    for l in range(w.shape[0]):
        xw = torch.matmul(x, w[l])
        x = x0 * xw[:, None] + b[l][None, :] + x
    return x


def cross_network_bwd_reference(x, w, b, g):
    """Plain PyTorch version of kernel 9, in the steps of ``crossnet_pallas.
    py::_bwd_kernel``: the states recomputed, then the layers walked
    backwards.  -> (dx, dw, db)."""
    x0 = x
    xs = [x0]
    for l in range(w.shape[0]):
        x = x0 * torch.matmul(x, w[l])[:, None] + b[l][None, :] + x
        xs.append(x)
    dw = torch.empty_like(w)
    db = torch.empty_like(b)
    extra = torch.zeros_like(x0)
    for l in range(w.shape[0] - 1, -1, -1):
        xw = torch.matmul(xs[l], w[l])[:, None]
        dxw = (g * x0).sum(1, keepdim=True)
        db[l] = g.sum(0)
        dw[l] = (dxw * xs[l]).sum(0)
        extra = extra + g * xw
        g = g + dxw * w[l][None, :]
    return g + extra, dw, db

"""Interactions of the port (counterpart of ``tpurec/nn/interactions.py``).

Parameter names and shapes are those of the JAX modules (and of their
``_LinearParams``/``_MHAParams`` holders), weights [in, out], so
:mod:`tpurec_torch.convert` maps them without special cases.

- :class:`FieldAttention` (AutoInt's stack: ``atten_embedding``,
  ``V_res_embedding``, ``self_attn_{i}.{in_proj,out_proj}_{weight,bias}``)
  runs as one call of :func:`tpurec_torch.ops.attention.field_attention`,
  the kernels on the card: in training with attention-weight dropout and a
  gradient through kernel 3.
- :class:`CrossNetwork` (DCN v1, ``w_{i}`` [D, 1], ``b_{i}`` [D]) runs as
  one call of :func:`tpurec_torch.ops.cross_network.cross_network`
  (kernels 8 and 9 on the card).
- :class:`FactorizationMachine`, :class:`CrossNetV2`,
  :class:`CrossNetMix`, :class:`InnerProductNetwork`,
  :class:`OuterProductNetwork`, :class:`AttentionalFactorizationMachine`,
  :class:`CompressedInteractionNetwork` and :class:`AnovaKernel` are plain
  PyTorch, as the JAX package's are jnp outside any Pallas kernel: every
  product is a ``torch.matmul``/``einsum``, every ReLU ``torch.relu``.

In bf16 mode (``compute_dtype="bfloat16"``) each casts where the JAX
module does and nowhere else: CrossNetV2 and CrossNetMix round their
operands (:func:`~tpurec_torch.nn.precision.cast_operands`), AFM through
its Linears; FM, IPN, OPN, CIN and Anova cast nothing.  Kernels #2-#5 and
#8/#9 compute what the JAX package's Pallas kernels compute, and those
cast nothing.  On the TPU the JAX package runs the cross stack through its
kernel, so the port's DCN in bf16 is its function there.  The one known
difference is attention: the JAX package's models run it on its jnp path
(``FieldAttention.fused=None``), which rounds the operands of every
projection and product of the stack to bfloat16
(``tpurec/nn/interactions.py:177-221`` and its ``atten_embedding``/
``V_res_embedding`` Linears), while the port's stack, those projections
included, stays float32 inside kernel #2.  A Linear outside the kernel
(``atten_linear``, AutoInt's ``dnn_linear``) casts in both packages.  The
gap is measured as a logit difference (``tests/test_torch_bf16_serve.py``,
``tests/test_torch_zoo_bf16.py``) and as an AUC gap
(``tests/test_torch_bf16_train.py``); ``PERF.md`` and ``ROADMAP.md``
(queue 3, "Differences kept on purpose") record it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tpurec_torch.nn import initializers as tinit
from tpurec_torch.nn.core import Linear, dropout
from tpurec_torch.nn.precision import cast_operands
from tpurec_torch.ops.attention import (attention_layer, draw_seed,
                                        field_attention)
from tpurec_torch.ops.cross_network import cross_network


class CrossNetwork(nn.Module):
    """DCN-v1 cross stack, x_{l+1} = x0 * (x_l . w_l) + b_l + x_l
    (``tpurec/nn/interactions.py:48-85``): [..., D] -> [..., D].  ``w_{i}``
    [D, 1] has torch-Linear init (fan-in D), ``b_{i}`` [D] is zero; the
    layers are stacked into [L, D] for one call of the fused stack."""

    def __init__(self, in_dim: int, num_layers: int, device=None):
        super().__init__()
        self.in_dim = in_dim
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"w_{i}", nn.Parameter(torch.empty(
                in_dim, 1, device=device)))
            setattr(self, f"b_{i}", nn.Parameter(torch.empty(
                in_dim, device=device)))

    def reset_parameters(self, generator):
        for i in range(self.num_layers):
            tinit.linear_uniform_(getattr(self, f"w_{i}"), self.in_dim,
                                  generator)
            with torch.no_grad():
                getattr(self, f"b_{i}").zero_()

    def forward(self, x):
        w = torch.stack([getattr(self, f"w_{i}")[:, 0]
                         for i in range(self.num_layers)])
        b = torch.stack([getattr(self, f"b_{i}")
                         for i in range(self.num_layers)])
        shape = x.shape
        return cross_network(x.reshape(-1, shape[-1]), w, b).reshape(shape)


class FieldMultiHeadAttention(nn.Module):
    """Self-attention over the field axis (torch nn.MultiheadAttention
    semantics): [B, F, A] -> [B, F, A]; ``keep`` [B, H, F, F] drops
    attention weights at ``rate`` (``tpurec/nn/interactions.py:190-206``).
    in_proj is one [A, 3A] xavier-uniform weight with zero bias; out_proj
    has torch-Linear init and zero bias."""

    def __init__(self, atten_dim: int, num_heads: int, device=None):
        super().__init__()
        if atten_dim % num_heads != 0:
            raise ValueError("embed dim must divide heads")
        A = atten_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(A, 3 * A,
                                                       device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * A, device=device))
        self.out_proj_weight = nn.Parameter(torch.empty(A, A, device=device))
        self.out_proj_bias = nn.Parameter(torch.empty(A, device=device))

    def reset_parameters(self, generator):
        tinit.xavier_uniform_2d_(self.in_proj_weight, generator)
        tinit.linear_uniform_(self.out_proj_weight,
                              self.out_proj_weight.shape[0], generator)
        with torch.no_grad():
            self.in_proj_bias.zero_()
            self.out_proj_bias.zero_()

    def weights(self):
        return [self.in_proj_weight, self.in_proj_bias,
                self.out_proj_weight, self.out_proj_bias]

    def forward(self, x, keep=None, rate: float = 0.0):
        return attention_layer(x, *self.weights(), self.num_heads, keep,
                               rate)


class FieldAttention(nn.Module):
    """AutoInt attention stack: project fields to the atten dim, N MHA
    layers, optional V_res residual, ReLU, flatten.

    Input: field embeddings [B, F, D]; output [B, F*atten_embed_dim].
    In training, attention weights drop at ``dropout`` with a seed drawn
    per call from the caller's generator.
    """

    def __init__(self, embed_dim: int, atten_embed_dim: int,
                 att_layer_num: int = 3, att_head_num: int = 2,
                 att_res: bool = True, dropout: float = 0.2, device=None):
        super().__init__()
        A = atten_embed_dim
        self.att_layer_num = att_layer_num
        self.att_head_num = att_head_num
        self.dropout = dropout
        self.atten_embedding = Linear(embed_dim, A, device=device)
        for i in range(att_layer_num):
            setattr(self, f"self_attn_{i}",
                    FieldMultiHeadAttention(A, att_head_num, device=device))
        self.V_res_embedding = (Linear(embed_dim, A, device=device)
                                if att_res else None)

    def flat_weights(self):
        """The kernel's weight list (``attention_pallas._flat_weights``)."""
        res = self.V_res_embedding
        flat = [self.atten_embedding.weight, self.atten_embedding.bias,
                None if res is None else res.weight,
                None if res is None else res.bias]
        for i in range(self.att_layer_num):
            flat += getattr(self, f"self_attn_{i}").weights()
        return flat

    def forward(self, embed_x, train: bool = False, generator=None):
        B = embed_x.shape[0]
        rate = self.dropout if train else 0.0
        seed = (draw_seed(generator, embed_x.device) if rate > 0.0
                else None)
        out = field_attention(embed_x, self.flat_weights(),
                              self.att_layer_num, self.att_head_num,
                              train=train, rate=rate, seed=seed)
        return out.reshape(B, -1)


class FactorizationMachine(nn.Module):
    """0.5 * ((sum_f v_f)^2 - sum_f v_f^2): [B, F, D] -> [B, 1], or [B, D]
    without ``reduce_sum`` (``tpurec/nn/interactions.py:33-45``)."""

    def __init__(self, reduce_sum: bool = True):
        super().__init__()
        self.reduce_sum = reduce_sum

    def forward(self, x):
        ix = torch.square(x.sum(dim=1)) - torch.square(x).sum(dim=1)
        if self.reduce_sum:
            ix = ix.sum(dim=1, keepdim=True)
        return 0.5 * ix


class CrossNetV2(nn.Module):
    """Full-matrix cross, x_{l+1} = x0 * (x_l W_l) + b_l + x_l
    (``tpurec/nn/interactions.py:88-102``): ``w_{i}`` [D, D] with
    torch-Linear init, ``b_{i}`` [D] zero."""

    def __init__(self, in_dim: int, num_layers: int, device=None):
        super().__init__()
        self.in_dim = in_dim
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"w_{i}", nn.Parameter(torch.empty(
                in_dim, in_dim, device=device)))
            setattr(self, f"b_{i}", nn.Parameter(torch.empty(
                in_dim, device=device)))

    def reset_parameters(self, generator):
        for i in range(self.num_layers):
            tinit.linear_uniform_(getattr(self, f"w_{i}"), self.in_dim,
                                  generator)
            with torch.no_grad():
                getattr(self, f"b_{i}").zero_()

    def forward(self, x):
        x0 = x
        for i in range(self.num_layers):
            xc, wc = cast_operands(x, getattr(self, f"w_{i}"))
            x = x0 * torch.matmul(xc, wc) + getattr(self, f"b_{i}") + x
        return x


class CrossNetMix(nn.Module):
    """DCN-v2's mixture of low-rank experts (``tpurec/nn/interactions.py:
    105-148``).  Per layer l and expert e: v = tanh(V[l,e]^T x), v =
    tanh(C[l,e] v), uv = U[l,e] v, out_e = x0 * (uv + bias[l]); the gate
    x . g_e is shared across layers; x <- sum_e out_e softmax_e(gate) + x.

    ``gating`` [E, D] has torch-Linear init (fan-in D); ``u_{i}``, ``v_{i}``
    [E, D, r] and ``c_{i}`` [E, r, r] are xavier-normal per expert slice;
    ``bias_{i}`` [D] is zero."""

    def __init__(self, in_dim: int, num_layers: int = 2, low_rank: int = 32,
                 num_experts: int = 4, device=None):
        super().__init__()
        E, r = num_experts, low_rank
        self.in_dim = in_dim
        self.num_layers = num_layers
        self.gating = nn.Parameter(torch.empty(E, in_dim, device=device))
        for i in range(num_layers):
            for name, shape in ((f"u_{i}", (E, in_dim, r)),
                                (f"v_{i}", (E, in_dim, r)),
                                (f"c_{i}", (E, r, r)),
                                (f"bias_{i}", (in_dim,))):
                setattr(self, name, nn.Parameter(torch.empty(
                    shape, device=device)))

    def reset_parameters(self, generator):
        tinit.linear_uniform_(self.gating, self.in_dim, generator)
        for i in range(self.num_layers):
            for name in (f"u_{i}", f"v_{i}", f"c_{i}"):
                tinit.xavier_normal_(getattr(self, name), generator)
            with torch.no_grad():
                getattr(self, f"bias_{i}").zero_()

    def forward(self, x):
        x0 = x
        for i in range(self.num_layers):
            xc, gc, vc, uc, cc = cast_operands(
                x, self.gating, getattr(self, f"v_{i}"),
                getattr(self, f"u_{i}"), getattr(self, f"c_{i}"))
            gate = torch.einsum("bi,ei->be", xc, gc)
            vx = torch.tanh(torch.einsum("bi,eir->ber", xc, vc))
            cv = torch.tanh(torch.einsum("ber,eqr->beq", cast_operands(vx),
                                         cc))
            uv = torch.einsum("beq,eiq->bei", cast_operands(cv), uc)
            expert_out = x0[:, None, :] * (uv + getattr(self, f"bias_{i}"))
            x = torch.einsum("bei,be->bi", expert_out,
                             torch.softmax(gate, dim=1)) + x
        return x


def _pair_indices(num_fields: int) -> Tuple[np.ndarray, np.ndarray]:
    """The field pairs (i < j) in ``np.triu_indices(F, 1)``'s order."""
    return np.triu_indices(num_fields, k=1)


def _pairs(x):
    """[B, F, D] -> (p, q) [B, P, D]: the two fields of every pair."""
    row, col = _pair_indices(x.shape[1])
    return x[:, row], x[:, col]


class InnerProductNetwork(nn.Module):
    """Pairwise inner products of the field embeddings: [B, F, D] -> [B, P]
    (``tpurec/nn/interactions.py:329-335``)."""

    def forward(self, x):
        p, q = _pairs(x)
        return (p * q).sum(dim=2)


class OuterProductNetwork(nn.Module):
    """Kernel product of every field pair: [B, F, D] -> [B, P]
    (``tpurec/nn/interactions.py:338-367``).  ``kernel``: [D, P, D] for
    ``"mat"`` (torch's 3-D xavier-uniform fans), [P, D] for ``"vec"``,
    [P, 1] for ``"num"`` (2-D xavier-uniform)."""

    def __init__(self, num_fields: int, embed_dim: int,
                 kernel_type: str = "mat", device=None):
        super().__init__()
        P = len(_pair_indices(num_fields)[0])
        shapes = {"mat": (embed_dim, P, embed_dim), "vec": (P, embed_dim),
                  "num": (P, 1)}
        if kernel_type not in shapes:
            raise ValueError(f"unknown kernel type {kernel_type}")
        self.kernel_type = kernel_type
        self.kernel = nn.Parameter(torch.empty(shapes[kernel_type],
                                               device=device))

    def reset_parameters(self, generator):
        if self.kernel_type == "mat":
            tinit.xavier_uniform_3d_(self.kernel, generator)
        else:
            tinit.xavier_uniform_2d_(self.kernel, generator)

    def forward(self, x):
        p, q = _pairs(x)
        if self.kernel_type == "mat":
            kp = torch.einsum("bnd,dne->bne", p, self.kernel)
            return (kp * q).sum(dim=-1)
        return (p * q * self.kernel[None]).sum(dim=-1)


class AttentionalFactorizationMachine(nn.Module):
    """AFM: attention-pooled pairwise interactions -> [B, 1]
    (``tpurec/nn/interactions.py:379-395``).  ``attention`` (D -> attn
    size), ``projection`` (-> 1) and ``fc`` (D -> 1) are Linears; in
    training the attention scores drop at ``dropouts[0]`` and the pooled
    vector at ``dropouts[1]``, with draws from the caller's generator."""

    def __init__(self, embed_dim: int, attn_size: int,
                 dropouts: Sequence[float] = (0.2, 0.2), device=None):
        super().__init__()
        self.dropouts = tuple(dropouts)
        self.attention = Linear(embed_dim, attn_size, device=device)
        self.projection = Linear(attn_size, 1, device=device)
        self.fc = Linear(embed_dim, 1, device=device)

    def forward(self, x, train: bool = False, generator=None):
        p, q = _pairs(x)
        inner = p * q                                       # [B, P, D]
        scores = torch.relu(self.attention(inner))
        scores = torch.softmax(self.projection(scores), dim=1)
        if train:
            scores = dropout(scores, self.dropouts[0], generator)
        out = (scores * inner).sum(dim=1)
        if train:
            out = dropout(out, self.dropouts[1], generator)
        return self.fc(out)


class CompressedInteractionNetwork(nn.Module):
    """xDeepFM's CIN (``tpurec/nn/interactions.py:398-432``): [B, F, D] ->
    [B, sum of the layers' kept sizes].  Layer i's pointwise convolution
    is ``conv_w_{i}`` [F * Fin, size] and ``conv_b_{i}`` [size], both with
    torch-Linear init (fan-in F * Fin); ``split_half`` keeps half of every
    layer's maps but the last and feeds the other half on."""

    def __init__(self, input_dim: int, cross_layer_sizes: Sequence[int],
                 split_half: bool = True, device=None):
        super().__init__()
        self.sizes = tuple(int(s) for s in cross_layer_sizes)
        self.split_half = split_half
        self.fans = []
        fin, self.output_dim = input_dim, 0
        for i, size in enumerate(self.sizes):
            fan = input_dim * fin
            self.fans.append(fan)
            setattr(self, f"conv_w_{i}", nn.Parameter(torch.empty(
                fan, size, device=device)))
            setattr(self, f"conv_b_{i}", nn.Parameter(torch.empty(
                size, device=device)))
            if split_half and i != len(self.sizes) - 1:
                if size % 2:
                    raise ValueError(f"split_half needs even layer sizes, "
                                     f"got {size}")
                fin = size // 2
            else:
                fin = size
            self.output_dim += fin

    def reset_parameters(self, generator):
        for i, fan in enumerate(self.fans):
            tinit.linear_uniform_(getattr(self, f"conv_w_{i}"), fan,
                                  generator)
            tinit.linear_uniform_(getattr(self, f"conv_b_{i}"), fan,
                                  generator)

    def forward(self, x):
        B, _, D = x.shape
        x0, h = x[:, :, None, :], x
        xs = []
        for i in range(len(self.sizes)):
            z = (x0 * h[:, None, :, :]).reshape(B, -1, D)   # [B, F*Fin, D]
            z = torch.relu(
                torch.einsum("bcd,ce->bed", z, getattr(self, f"conv_w_{i}"))
                + getattr(self, f"conv_b_{i}")[None, :, None])
            if self.split_half and i != len(self.sizes) - 1:
                z, h = z.chunk(2, dim=1)
            else:
                h = z
            xs.append(z)
        return torch.cat(xs, dim=1).sum(dim=2)


class AnovaKernel(nn.Module):
    """Order-t ANOVA kernel by its dynamic-programming recurrence: [B, F, D]
    -> [B, 1], or [B, D] without ``reduce_sum``
    (``tpurec/nn/interactions.py:435-451``)."""

    def __init__(self, order: int, reduce_sum: bool = True):
        super().__init__()
        self.order = order
        self.reduce_sum = reduce_sum

    def forward(self, x):
        B, F, D = x.shape
        a_prev = torch.ones(B, F + 1, D, dtype=x.dtype, device=x.device)
        for t in range(self.order):
            head = torch.zeros(B, t + 1, D, dtype=x.dtype, device=x.device)
            a_prev = torch.cumsum(torch.cat(
                [head, x[:, t:, :] * a_prev[:, t:-1, :]], dim=1), dim=1)
        last = a_prev[:, -1, :]
        return last.sum(dim=-1, keepdim=True) if self.reduce_sum else last

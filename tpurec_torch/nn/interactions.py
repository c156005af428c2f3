"""Field attention of the port (counterpart of ``tpurec/nn/interactions.py``
:class:`FieldMultiHeadAttention` and :class:`FieldAttention`).

Parameter names and shapes are those of the JAX modules (and of their
``_LinearParams``/``_MHAParams`` holders): ``atten_embedding``,
``V_res_embedding``, ``self_attn_{i}.{in_proj,out_proj}_{weight,bias}``,
weights [in, out].  :class:`FieldAttention` runs the whole stack as one
call of :func:`tpurec_torch.ops.attention.field_attention`, the kernels on
the card: in training with attention-weight dropout and a gradient
through kernel 3.  The interaction ops of the other zoo models come with
their slices.
"""

from __future__ import annotations

import torch
from torch import nn

from tpurec_torch.nn import initializers as tinit
from tpurec_torch.nn.core import Linear
from tpurec_torch.ops.attention import (attention_layer, draw_seed,
                                        field_attention)


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

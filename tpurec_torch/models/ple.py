"""PLE / CGC (counterpart of ``tpurec/models/ple.py``, reference
model/ple.py).

Each CGC level runs its task-specific expert bank (n_task * S MLPs
without BatchNorm) and its shared bank as two batched passes; the gates
mix the experts in one product.  Expert (t, s) of the specific bank reads
task t's input: ``repeat_interleave``, as the JAX package's
``jnp.repeat(task_inputs, S, axis=1)`` (not ``Tensor.repeat``, which
tiles).  The first level's task input is the flat embedding, the same for
every task, which the banks broadcast from [B, in]
(:class:`tpurec_torch.nn.core.StackedLinear`) without repeating it.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from tpurec_torch.models.base import AuxLogits, CTRModel
from tpurec_torch.nn.core import Linear, StackedLinear, StackedMLP


class CGC(nn.Module):
    """One Customized-Gate-Control level (``tpurec/models/ple.py:21-75``).

    Input: task_inputs [B, T, in] (or [B, in], one input for every task)
    and shared_input [B, in].  Output:
    task_outputs [B, T, H] and shared_output [B, H], or None at the last
    level.  The gates put each task's specific experts before the shared
    ones.
    """

    def __init__(self, in_dim: int, last: bool, n_task: int,
                 n_expert_specific: int, n_expert_shared: int,
                 expert_dims: Tuple[int, ...], dropout: float = 0.2,
                 device=None):
        super().__init__()
        T, S, P = n_task, n_expert_specific, n_expert_shared
        self.n_task, self.n_specific, self.n_shared = T, S, P
        self.experts_specific = StackedMLP(
            T * S, in_dim, expert_dims, output_layer=False, dropout=dropout,
            use_bn=False, device=device)
        self.experts_shared = StackedMLP(
            P, in_dim, expert_dims, output_layer=False, dropout=dropout,
            use_bn=False, device=device)
        self.gates_specific = StackedLinear(T, in_dim, S + P, device=device)
        self.gate_shared = (None if last else
                            Linear(in_dim, T * S + P, device=device))

    def forward(self, task_inputs, shared_input, train: bool = False,
                row_mask=None, generator=None):
        T, S, P = self.n_task, self.n_specific, self.n_shared
        B = shared_input.shape[0]
        spec_in = (task_inputs if task_inputs.dim() == 2 else
                   task_inputs.repeat_interleave(S, dim=1))  # [B, T*S, in]
        spec_outs = self.experts_specific(spec_in, train, row_mask,
                                          generator)          # [B, T*S, H]
        shared_outs = self.experts_shared(shared_input, train, row_mask,
                                          generator)          # [B, P, H]
        gates = torch.softmax(self.gates_specific(task_inputs),
                              dim=-1)                         # [B, T, S+P]
        H = spec_outs.shape[-1]
        experts_t = torch.cat(
            [spec_outs.reshape(B, T, S, H),
             shared_outs[:, None].expand(B, T, P, H)], dim=2)  # [B,T,S+P,H]
        task_out = torch.einsum("bte,bteh->bth", gates, experts_t)
        if self.gate_shared is None:
            return task_out, None
        all_experts = torch.cat([spec_outs, shared_outs], dim=1)
        gate_shared = torch.softmax(self.gate_shared(shared_input), dim=-1)
        return task_out, torch.einsum("be,beh->bh", gate_shared, all_experts)


class PLE(CTRModel):
    """Progressive Layered Extraction (``tpurec/models/ple.py:78-112``):
    ``len(ple_expert_dims)`` CGC levels, then per-task tower MLPs and the
    aux logit heads.  Defaults: 2 specific + 2 shared experts a task,
    expert dims ((256, 128), (64,)), towers (64, 32)."""

    def __init__(self, field_dims, embed_dim, cfg, n_tower=1, domain_idx=0,
                 device=None):
        super().__init__(field_dims, embed_dim, cfg, n_tower, domain_idx,
                         device)
        expert_dims = cfg.ple_expert_dims
        in_dim = self.embed_output_dim
        self.n_level = len(expert_dims)
        for i, dims in enumerate(expert_dims):
            setattr(self, f"cgc_{i}", CGC(
                in_dim, i + 1 == self.n_level, n_tower,
                cfg.ple_n_expert_specific, cfg.ple_n_expert_shared,
                tuple(dims), cfg.dropout, device=device))
            in_dim = dims[-1]
        self.towers = StackedMLP(n_tower, in_dim, cfg.ple_tower_dims,
                                 output_layer=True, dropout=cfg.dropout,
                                 device=device)
        self.aux = AuxLogits(cfg, self.field_num, embed_dim, device=device)

    def forward(self, x, group=None, train: bool = False, row_mask=None,
                embed_rows=None, generator=None):
        """x [B, F] ids -> logits [B, n_tower].  The first level's task
        input is the flat embedding, once for all tasks ([B, in])."""
        flat, emb = self.embed(x, embed_rows)
        task_inputs, shared_input = flat, flat
        for i in range(self.n_level):
            task_inputs, shared_input = getattr(self, f"cgc_{i}")(
                task_inputs, shared_input, train, row_mask, generator)
        tower_logits = self.towers(task_inputs, train, row_mask,
                                   generator)[..., 0]         # [B, T]
        return tower_logits + self.aux(flat, emb, train, generator)

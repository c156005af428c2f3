"""Training-step helpers of the port (counterpart of ``tpurec/train/step.py``).

- :func:`select_tower` picks each row's tower logit;
- :func:`bce_with_logits` is the masked mean BCE of the JAX package;
- :func:`make_optimizer` is the dense parameters' Adam
  (``add_decayed_weights(wd)`` -> ``scale_by_adam`` -> ``scale(-lr)``, which
  is ``torch.optim.Adam(weight_decay=wd)``: wd is added to the gradient
  before the moments, as the reference's run.py:720-723 does);
- :class:`TrainState` holds a model, its dense optimizer, the embedding
  table's Adam moments and the step count.

The hybrid training step itself is :mod:`tpurec_torch.train.hybrid`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch
import torch.nn.functional as Fn

from tpurec_torch.config import TrainConfig
from tpurec_torch.train.sparse import SparseEmbedState


def select_tower(logits: torch.Tensor, group: torch.Tensor) -> torch.Tensor:
    """[B, T] logits + [B] group -> [B] (run.py:484 ``pred.gather(1, group)``).

    Out-of-range groups follow ``jnp.take_along_axis``: a group in [-T, 0)
    wraps, any other gives NaN.
    """
    if logits.dim() == 1:
        return logits
    T = logits.shape[1]
    g = group.long()
    g = torch.where(g < 0, g + T, g)
    ok = (g >= 0) & (g < T)
    out = logits.gather(1, g.clamp(0, T - 1)[:, None])[:, 0]
    return torch.where(ok, out, torch.full((), float("nan"),
                                           dtype=out.dtype,
                                           device=out.device))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean BCE on logits; with ``weights`` the weighted sum over
    ``max(sum(weights), 1)`` (``tpurec/train/step.py:46-52``)."""
    losses = Fn.binary_cross_entropy_with_logits(
        logits, targets.to(logits.dtype), reduction="none")
    if weights is None:
        return losses.mean()
    w = weights.to(losses.dtype)
    return (losses * w).sum() / torch.clamp(w.sum(), min=1.0)


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   tcfg: TrainConfig) -> torch.optim.Adam:
    """Adam over the dense parameters, with the JAX package's settings."""
    return torch.optim.Adam(params, lr=tcfg.lr,
                            betas=(tcfg.adam_b1, tcfg.adam_b2),
                            eps=tcfg.adam_eps, weight_decay=tcfg.wd)


@dataclasses.dataclass
class TrainState:
    """What the hybrid step reads and updates in place.

    ``model`` holds the table (``embedding.table``), the dense parameters
    and the BN buffers; ``optimizer`` steps every parameter but the table;
    ``emb_opt`` holds the table's Adam moments; ``step`` counts the steps
    taken (the next one is ``step + 1``, Adam's 1-based count)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    emb_opt: SparseEmbedState
    step: int = 0

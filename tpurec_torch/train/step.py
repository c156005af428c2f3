"""Training-step helpers of the port (counterpart of ``tpurec/train/step.py``).

The serving slice needs :func:`select_tower` only; the train and eval
steps come with the training slice.
"""

from __future__ import annotations

import torch


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

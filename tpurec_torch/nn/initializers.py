"""Initializers matching torch defaults, drawn from an explicit generator.

The same distributions as ``tpurec/nn/initializers.py`` (the JAX package
draws them from ``jax.random`` keys, so the numbers differ; parity tests
copy weights across with :mod:`tpurec_torch.convert` instead):

- ``nn.Linear``: weight, bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
- ``nn.Embedding``: N(0, 1), or N(0, std) when ``embed_init_std`` is set
- ``nn.MultiheadAttention`` in_proj: xavier-uniform over [A, 3A]
- CrossNetMix's ``nn.init.xavier_normal_`` per expert slice [E, in, out]
- OuterProductNetwork's ``nn.init.xavier_uniform_`` on a 3-D kernel

Each function fills ``t`` in place and returns it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


@torch.no_grad()
def linear_uniform_(t: torch.Tensor, fan_in: int,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) — torch nn.Linear default."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def normal_(t: torch.Tensor, generator: Optional[torch.Generator],
            std: Optional[float] = None) -> torch.Tensor:
    """N(0, 1) (torch nn.Embedding default) or N(0, std)."""
    return t.normal_(0.0, 1.0 if std is None else std, generator=generator)


def init_module(module: torch.nn.Module,
                generator: Optional[torch.Generator]) -> torch.nn.Module:
    """Call every submodule's ``reset_parameters(generator)``, in
    registration order, so one seed gives one set of weights."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return module


@torch.no_grad()
def xavier_uniform_2d_(t: torch.Tensor,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
    """Xavier/Glorot uniform with fan_in = shape[0], fan_out = shape[1]."""
    bound = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def xavier_normal_(t: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """Xavier/Glorot normal over the last two axes: fan_in = shape[-2],
    fan_out = shape[-1], leading axes batch (torch's ``xavier_normal_`` on
    each [in, out] expert slice, ``tpurec/nn/initializers.py:49-60``)."""
    std = math.sqrt(2.0 / (t.shape[-2] + t.shape[-1]))
    return t.normal_(0.0, std, generator=generator)


@torch.no_grad()
def xavier_uniform_3d_(t: torch.Tensor,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
    """torch's ``xavier_uniform_`` on a 3-D tensor: fan_in = shape[1] *
    shape[2], fan_out = shape[0] * shape[2]
    (``tpurec/nn/interactions.py:370-376``)."""
    fan_in, fan_out = t.shape[1] * t.shape[2], t.shape[0] * t.shape[2]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return t.uniform_(-bound, bound, generator=generator)

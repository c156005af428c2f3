"""Where the port runs: the card unless the caller names the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` or, when None, ``cuda``; raises if that card is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: tpurec_torch runs on the card; pass "
            "device='cpu' to run the kernels' plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev

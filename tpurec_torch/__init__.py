"""tpurec_torch — the PyTorch/CUDA port of tpurec for NVIDIA Hopper.

A package of its own beside the JAX package ``tpurec`` (the reference it is
tested against); it imports torch, numpy and the standard library only.
This slice carries the serving path of the MMoE model:
:mod:`tpurec_torch.serve` (Predictor) and :mod:`tpurec_torch.server`
(HTTP host), with hand-written CUDA kernels in ``tpurec_torch/csrc``.
"""

__version__ = "0.1.0"

"""tpurec_torch — the PyTorch/CUDA port of tpurec for NVIDIA Hopper.

A package of its own beside the JAX package ``tpurec`` (the reference it is
tested against); it imports torch, numpy and the standard library only.
It carries the serving path (:mod:`tpurec_torch.serve`, the Predictor,
and :mod:`tpurec_torch.server`, the HTTP host), the hybrid training step
(:mod:`tpurec_torch.train.hybrid`) and the training harness
(:class:`tpurec_torch.train.Trainer`, with :mod:`tpurec_torch.metrics`
and :mod:`tpurec_torch.data`) of the MMoE and DCN models, with
hand-written CUDA kernels in ``tpurec_torch/csrc``.
"""

__version__ = "0.1.0"

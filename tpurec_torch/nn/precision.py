"""Compute-dtype policy of the port: float32 only, for now.

``tpurec/nn/precision.py`` can cast the operands of dense contractions to
bfloat16 (``TrainConfig.compute_dtype="bfloat16"``).  The port computes
every contraction in float32; a bf16 config is refused rather than served
with math its validation AUC was not measured with.
"""

from __future__ import annotations

_FLOAT32 = (None, "", "float32", "f32")
_BFLOAT16 = ("bfloat16", "bf16")


def check_compute_dtype(dtype) -> None:
    """Raise unless ``dtype`` names float32 compute."""
    if dtype in _FLOAT32:
        return
    if dtype in _BFLOAT16:
        raise NotImplementedError(
            "compute_dtype='bfloat16' is not ported yet: see ROADMAP.md, "
            "queue 1, 'bf16 compute scope'")
    raise ValueError(f"unsupported compute_dtype {dtype!r}")

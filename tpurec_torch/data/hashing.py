"""Feature hashing for categorical ids (the "hash trick"), numpy only.

The port's own copy of ``tpurec/data/hashing.py::hash_ids``: a
deterministic 32-bit avalanche hash (murmur3 finalizer) with a per-field
salt.  The Predictor applies a checkpoint's ``cfg.data.hash_buckets`` with
it, so raw request ids land in the same buckets the training load path
used (salt = field index).
"""

from __future__ import annotations

import numpy as np


def _fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3 32-bit finalizer (public domain), vectorized numpy."""
    h = x.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h ^= h >> np.uint32(13)
    h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
    h ^= h >> np.uint32(16)
    return h


def hash_ids(ids, n_buckets: int, salt: int = 0) -> np.ndarray:
    """ids (any integer array) -> int64 bucket ids in [0, n_buckets)."""
    h = _fmix32(np.asarray(ids).astype(np.uint32)
                ^ np.uint32(salt & 0xFFFFFFFF))
    return (h % np.uint32(n_buckets)).astype(np.int64)

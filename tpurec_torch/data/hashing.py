"""Feature hashing for categorical ids (the "hash trick"), numpy only.

The port's own copy of ``tpurec/data/hashing.py``'s numpy path:

- :func:`hash_ids`, a deterministic 32-bit avalanche hash (murmur3
  finalizer) with a per-field salt.  The Predictor applies a checkpoint's
  ``cfg.data.hash_buckets`` with it, so raw request ids land in the same
  buckets the training load path used (salt = field index);
- :func:`apply_hash_trick` rewrites selected columns of an [N, F] id
  matrix into bucket ids and returns the updated ``field_dims``.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

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


def apply_hash_trick(
    X: np.ndarray,
    field_dims: Sequence[int],
    hash_buckets: Mapping[int, int],
    salts: Optional[Mapping[int, int]] = None,
) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Hash selected columns of an [N, F] id matrix into fixed buckets.

    ``hash_buckets``: {field index -> n_buckets}.  Returns (X', field_dims')
    where hashed columns hold bucket ids and their field dim is the bucket
    count.  Typically applied to the huge-vocabulary id fields (user/item)
    so the embedding table size is a deployment choice instead of a
    function of the training vocabulary, and serving never sees an
    out-of-range id.
    """
    X = np.asarray(X)
    out = X.astype(np.int64, copy=True)
    dims = list(int(d) for d in field_dims)
    for f, nb in hash_buckets.items():
        f, nb = int(f), int(nb)
        if not 0 <= f < X.shape[1]:
            raise ValueError(f"hash field {f} out of range for {X.shape[1]} columns")
        if nb <= 0:
            raise ValueError(f"n_buckets must be positive, got {nb} for field {f}")
        salt = int(salts[f]) if salts and f in salts else f
        out[:, f] = hash_ids(X[:, f], nb, salt=salt)
        dims[f] = nb
    return out, tuple(dims)

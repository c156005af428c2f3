"""Synthetic multi-domain CTR dataset generator (the port's own copy of
``tpurec/data/synthetic.py``: numpy only, so every seed gives the JAX
package's arrays bit for bit).

Produces learnable click data with the same row schema the reference's
runtime loader emits (int feature ids [N, F] + binary label, with one column
being the domain id — run.py:51,54-58): a random per-field latent factor
model plus a per-domain bias/slope so that (a) models can reach AUC >> 0.5
quickly in integration tests and (b) domains genuinely differ, giving the
CDC clustering something to find.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticMultiDomain:
    X: np.ndarray          # int32 [N, F]
    y: np.ndarray          # float32 [N]
    field_dims: Tuple[int, ...]
    domain_idx: int
    n_domain: int
    split: np.ndarray      # int8 [N]; 0=train 1=valid 2=test (train_tag style)
    # ground-truth domain cluster assignment when the generator was asked
    # for clustered domain effects (domain_cluster_k); None otherwise
    domain_cluster: Optional[np.ndarray] = None

    @property
    def train(self):
        m = self.split == 0
        return self.X[m], self.y[m]

    @property
    def valid(self):
        m = self.split == 1
        return self.X[m], self.y[m]

    @property
    def test(self):
        m = self.split == 2
        return self.X[m], self.y[m]

    def domain_cnt_weight(self) -> np.ndarray:
        Xtr, _ = self.train
        cnt = np.bincount(Xtr[:, self.domain_idx], minlength=self.n_domain)
        return cnt / cnt.sum()


def make_synthetic(
    n_rows: int = 20000,
    n_fields: int = 8,
    n_domain: int = 6,
    field_dims: Optional[Tuple[int, ...]] = None,
    domain_idx: int = 3,
    latent_dim: int = 4,
    seed: int = 0,
    domain_skew: float = 1.0,
    domain_cluster_k: Optional[int] = None,
    domain_cluster_noise: float = 0.15,
    domain_cluster_conflict: bool = False,
) -> SyntheticMultiDomain:
    """``domain_cluster_k=K`` draws the per-domain slope/bias from K
    latent cluster centers (plus ``domain_cluster_noise`` jitter) instead
    of independently per domain — a known ground-truth grouping for
    evaluating whether CDC's causal clustering recovers real structure
    (scripts/ablate_cdc_benefit.py).  Default None preserves the original
    draw sequence exactly, so all existing seeds stay bit-identical.

    ``domain_cluster_conflict=True`` (requires ``domain_cluster_k``)
    switches the cluster centers to ANTIPODAL pairs of orthonormal latent
    directions with zero bias: clusters 2j and 2j+1 score the SAME latent
    factor with OPPOSITE sign.  This induces genuine negative transfer —
    the regime the CDC paper targets (its published gains come from
    domains whose label functions conflict, not merely differ): a tower
    pooled over opposite-sign domains must learn a multiplicative
    sign(domain)*h(x) interaction, while a tower per true cluster sees a
    coherent task.  Shared embeddings stay conflict-free (the sign lives
    in the readout), matching the reference's architecture where grouping
    only re-routes towers (run.py:41-43,229)."""
    rng = np.random.default_rng(seed)
    if field_dims is None:
        field_dims = tuple(
            n_domain if f == domain_idx else int(rng.integers(8, 64))
            for f in range(n_fields)
        )
    assert field_dims[domain_idx] == n_domain

    # domain sampling with power-law skew (real multi-domain data is skewed)
    dweights = rng.dirichlet(np.full(n_domain, domain_skew))
    dweights = np.maximum(dweights, 2.0 / n_domain / 10)
    dweights /= dweights.sum()

    X = np.empty((n_rows, n_fields), dtype=np.int32)
    for f, dim in enumerate(field_dims):
        if f == domain_idx:
            X[:, f] = rng.choice(n_domain, size=n_rows, p=dweights)
        else:
            X[:, f] = rng.integers(0, dim, size=n_rows)

    # ground-truth latent factors per field value + per-domain slope/bias
    factors = [rng.normal(0, 1, size=(dim, latent_dim)) for dim in field_dims]
    domain_cluster = None
    if domain_cluster_conflict and domain_cluster_k is None:
        raise ValueError("domain_cluster_conflict requires domain_cluster_k")
    if domain_cluster_k is not None and domain_cluster_conflict:
        n_dir = (domain_cluster_k + 1) // 2
        if n_dir > latent_dim:
            raise ValueError("conflict mode needs latent_dim >= k/2 "
                             "orthogonal directions")
        # orthonormal directions via QR; clusters (2j, 2j+1) = ±direction j
        q, _ = np.linalg.qr(rng.normal(0, 1, size=(latent_dim, n_dir)))
        signs = np.array([1.0 if c % 2 == 0 else -1.0
                          for c in range(domain_cluster_k)])
        centers = 2.0 * signs[:, None] * q.T[np.arange(domain_cluster_k) // 2]
        center_bias = np.zeros(domain_cluster_k)
    elif domain_cluster_k is not None:
        centers = rng.normal(1.0, 0.5, size=(domain_cluster_k, latent_dim))
        center_bias = rng.normal(0.0, 0.7, size=domain_cluster_k)
    if domain_cluster_k is not None:
        if domain_cluster_conflict:
            # balanced shuffled assignment: every cluster (so every
            # antipodal partner) is populated — an i.i.d. draw can leave a
            # sign unopposed at small n_domain, erasing the conflict
            domain_cluster = rng.permutation(
                np.arange(n_domain) % domain_cluster_k)
        else:
            domain_cluster = rng.integers(0, domain_cluster_k, size=n_domain)
        domain_slope = (centers[domain_cluster]
                        + rng.normal(0, domain_cluster_noise,
                                     size=(n_domain, latent_dim)))
        domain_bias = (center_bias[domain_cluster]
                       + rng.normal(0, domain_cluster_noise, size=n_domain))
    else:
        domain_slope = rng.normal(1.0, 0.5, size=(n_domain, latent_dim))
        domain_bias = rng.normal(0.0, 0.7, size=n_domain)

    z = np.zeros((n_rows, latent_dim))
    for f in range(n_fields):
        if f == domain_idx:
            continue
        z += factors[f][X[:, f]]
    z /= np.sqrt(max(n_fields - 1, 1))
    d = X[:, domain_idx]
    logit = np.sum(z * domain_slope[d], axis=1) + domain_bias[d]
    p = 1.0 / (1.0 + np.exp(-1.2 * logit))
    y = (rng.random(n_rows) < p).astype(np.float32)

    # time-style split 90/5/5 (run.py:116 quantile split analog)
    split = np.zeros(n_rows, dtype=np.int8)
    u = rng.random(n_rows)
    split[u >= 0.90] = 1
    split[u >= 0.95] = 2

    return SyntheticMultiDomain(
        X=X, y=y, field_dims=tuple(int(v) for v in field_dims),
        domain_idx=domain_idx, n_domain=n_domain, split=split,
        domain_cluster=domain_cluster,
    )

"""Metrics of the port (counterpart of ``tpurec/metrics/metrics.py``).

The numpy functions are the JAX package's own, copied so that the port
imports nothing of it:

- :func:`auc_score` — exact tie-aware ROC-AUC via average ranks
  (equivalent to sklearn.roc_auc_score, used at run.py:682)
- :func:`log_loss_score` — binary cross-entropy with sklearn-style clipping
  (run.py:683)
- :func:`evaluate_multi_domain` — per-domain AUC/LogLoss plus
  count-weighted means (run.py:690-711)
- :func:`gauc_score` — per-user impression-weighted AUC (base.py:10-64)
- :func:`streaming_eval_result` / :func:`streaming_auc_from_bins` — the
  result dict and AUC from per-(domain, bin) score histograms

:func:`streaming_auc_bins` accumulates those histograms on torch tensors,
on the tensors' device, so eval never hauls the full prediction set to the
host.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

_EPS = 1e-15
# the largest binned probability: float32(1 - 1e-7), as jnp.clip rounds it
BIN_P_MAX = float(np.float32(1.0 - 1e-7))


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """Ranks 1..n with ties assigned the average rank."""
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(len(x), dtype=np.float64)
    sx = x[order]
    # boundaries of tie groups
    boundary = np.concatenate([[True], sx[1:] != sx[:-1]])
    group_id = np.cumsum(boundary) - 1
    counts = np.bincount(group_id)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    avg = start + (counts + 1) / 2.0  # average of ranks (1-indexed)
    ranks[order] = avg[group_id]
    return ranks


def auc_score(y_true, y_pred) -> float:
    """Exact ROC-AUC (Mann-Whitney with tie correction)."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_pred = np.asarray(y_pred, dtype=np.float64).ravel()
    n_pos = float(np.sum(y_true > 0))
    n_neg = float(len(y_true) - n_pos)
    if n_pos == 0 or n_neg == 0:
        raise ValueError("AUC undefined with a single class present")
    ranks = _average_ranks(y_pred)
    pos_rank_sum = float(np.sum(ranks[y_true > 0]))
    return (pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def log_loss_score(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    p = np.clip(np.asarray(y_pred, dtype=np.float64).ravel(), _EPS, 1 - _EPS)
    return float(-np.mean(y_true * np.log(p) + (1 - y_true) * np.log(1 - p)))


def evaluate_multi_domain(
    targets, predicts, domains, domain_cnt_weight, n_domain: Optional[int] = None
) -> Dict:
    """Per-domain AUC/LogLoss dicts + count-weighted means (run.py:690-711).

    Domains with a single label class get NaN metrics and the NaN propagates
    into the weighted mean exactly like the reference's try/except+nan path.
    """
    targets = np.asarray(targets).ravel()
    predicts = np.asarray(predicts).ravel()
    domains = np.asarray(domains).ravel()
    domain_auc: Dict[int, float] = {}
    domain_loss: Dict[int, float] = {}
    mean_auc, mean_loss = 0.0, 0.0
    for d in np.unique(domains):
        m = domains == d
        try:
            auc = auc_score(targets[m], predicts[m])
            loss = log_loss_score(targets[m], predicts[m])
        except ValueError:
            auc, loss = np.nan, np.nan
        d = int(d)
        domain_auc[d], domain_loss[d] = auc, loss
        w = float(domain_cnt_weight[d])
        mean_auc += w * auc
        mean_loss += w * loss
    return {
        "domain_auc": domain_auc,
        "domain_loss": domain_loss,
        "mean_auc": mean_auc,
        "mean_loss": mean_loss,
    }


def gauc_score(y_true, y_pred, users, weights: Optional[Dict] = None) -> float:
    """Per-user AUC weighted by impressions, skipping single-class users
    (base.py:33-64)."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    users = np.asarray(users).ravel()
    score, num = 0.0, 0.0
    order = np.argsort(users, kind="mergesort")
    y_true, y_pred, users = y_true[order], y_pred[order], users[order]
    boundaries = np.concatenate(
        [[0], np.nonzero(users[1:] != users[:-1])[0] + 1, [len(users)]]
    )
    for s, e in zip(boundaries[:-1], boundaries[1:]):
        yt, yp = y_true[s:e], y_pred[s:e]
        if not (np.any(yt > 0) and np.any(yt <= 0)):
            continue
        auc = auc_score(yt, yp)
        w = float(e - s) if weights is None else float(weights[users[s]])
        score += auc * w
        num += w
    if num == 0:
        raise ValueError("GAUC undefined: no user has both classes")
    return score / num


# ---------------------------------------------------------------------------
# On-device streaming (histogram) AUC: bin predictions, accumulate per-bin
# positive/negative counts, trapezoidal AUC from the histogram.  Error is
# O(1/n_bins); validated to >=4 decimals vs the exact AUC in tests.
# ---------------------------------------------------------------------------


def streaming_auc_bins(y_true, y_prob, n_bins: int = 8192, domains=None,
                       n_domain: int = 1):
    """Accumulate per-(domain,bin) pos/neg counts on the tensors' device.

    ``y_true``/``y_prob`` (and ``domains``) are torch tensors.  Returns
    (pos_counts, neg_counts), float32 tensors of shape [n_domain, n_bins].
    The bin is ``int(clip(p, 0, 1-1e-7) * n_bins)`` in float32, as in the
    JAX package (``1-1e-7`` rounds to float32 first).
    """
    y_true = y_true.to(torch.float32).reshape(-1)
    p = torch.clamp(y_prob.to(torch.float32).reshape(-1), min=0.0,
                    max=BIN_P_MAX)
    idx = (p * n_bins).to(torch.int64)
    if domains is None:
        flat = idx
        size = n_bins
    else:
        flat = domains.to(torch.int64).reshape(-1) * n_bins + idx
        size = n_domain * n_bins
    zeros = torch.zeros((size,), dtype=torch.float32, device=y_true.device)
    pos = zeros.index_add(0, flat, y_true)
    neg = zeros.index_add(0, flat, 1.0 - y_true)
    return pos.reshape(n_domain, n_bins), neg.reshape(n_domain, n_bins)


def streaming_eval_result(pos, neg, lsum, lcnt, domain_cnt_weight=None) -> Dict:
    """Assemble the eval result dict from device-accumulated histograms.

    Inputs: pos/neg [n_domain, n_bins] score histograms, lsum/lcnt
    [n_domain] log-loss sums and row counts.  Returns the same keys as the
    exact eval (total_auc/total_loss, and with ``domain_cnt_weight`` the
    per-domain dicts + weighted means; single-class domains contribute NaN
    to the mean exactly like :func:`evaluate_multi_domain`).  Domains with
    zero rows are omitted from the per-domain dicts and means.
    """
    pos = np.asarray(pos, dtype=np.float64)
    neg = np.asarray(neg, dtype=np.float64)
    lsum = np.asarray(lsum, dtype=np.float64)
    lcnt = np.asarray(lcnt, dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        dom_auc = streaming_auc_from_bins(pos, neg)
        dom_loss = lsum / lcnt
    # evaluate_multi_domain's try/except NaNs BOTH metrics when auc_score
    # raises on a single-class domain (metrics.py:80-83) — mirror that so
    # mean_loss agrees between the exact and streaming evals
    single_class = (pos.sum(axis=1) == 0) | (neg.sum(axis=1) == 0)
    dom_loss = np.where(single_class, np.nan, dom_loss)
    tot = streaming_auc_from_bins(
        pos.sum(axis=0, keepdims=True), neg.sum(axis=0, keepdims=True))
    result = {
        "total_auc": float(tot[0]),
        "total_loss": float(lsum.sum() / max(lcnt.sum(), 1.0)),
    }
    if domain_cnt_weight is not None:
        present = np.nonzero(lcnt > 0)[0]
        result.update({
            "domain_auc": {int(d): float(dom_auc[d]) for d in present},
            "domain_loss": {int(d): float(dom_loss[d]) for d in present},
            "mean_auc": float(sum(
                float(domain_cnt_weight[d]) * dom_auc[d] for d in present)),
            "mean_loss": float(sum(
                float(domain_cnt_weight[d]) * dom_loss[d] for d in present)),
        })
    return result


def streaming_auc_from_bins(pos, neg) -> np.ndarray:
    """Trapezoidal AUC per domain from [n_domain, n_bins] histograms."""
    pos = np.asarray(pos, dtype=np.float64)
    neg = np.asarray(neg, dtype=np.float64)
    # Ascending score bins: count (neg below) * pos + 0.5 * same-bin pairs.
    cum_neg = np.cumsum(neg, axis=1) - neg
    pairs = np.sum(pos * (cum_neg + 0.5 * neg), axis=1)
    denom = pos.sum(axis=1) * neg.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        return pairs / denom

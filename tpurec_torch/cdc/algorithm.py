"""CDC clustering algorithm (host-side, numpy): the port's own copy of
``tpurec/cdc/algorithm.py``.

Ports the *algorithm* of the reference's model/cdc.py (the WWW'25 CDC
method): affinity transforms, the distance-covariance causal kernel,
KMeans seeding, the iterative/greedy target re-assignment, and the greedy
source-group growth.  All matrices are tiny ([n_domain<=50] square), so
this runs on the host between device training bursts.

Everything but :func:`kmeans_group` is the JAX package's code verbatim.
``kmeans_group`` is scikit-learn's ``KMeans(n_clusters,
random_state=seed, n_init=10).fit(X).labels_`` written out in numpy (the
port depends on no scikit-learn): the same random draws in the same
order, so the same labels, not merely the same partition.

State kept in :class:`CDCClusterState`; the heavy counterpart (matrix
population via train/eval bursts) lives in :mod:`tpurec_torch.cdc.engine`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from tpurec_torch.config import CDCConfig


@dataclasses.dataclass
class CDCClusterState:
    n_domain: int
    n_cluster: int
    n_causal_mask: int
    # affinity matrices (populated by the engine, transformed here)
    matrix_A: np.ndarray = None   # [n_domain+1, n_domain]; row -1 = warm baseline (cdc.py:79)
    matrix_B: np.ndarray = None   # [n_domain+n_cluster, n_domain] (cdc.py:80)
    matrix_mask: np.ndarray = None  # [n_causal_mask, n_domain] (cdc.py:81)
    matrix_causal: np.ndarray = None  # [n_domain, n_domain]
    old_matrix_A: Optional[np.ndarray] = None
    old_matrix_B: Optional[np.ndarray] = None
    old_matrix_mask: Optional[np.ndarray] = None
    # clustering state (cdc.py:70-75)
    domain2group: np.ndarray = None
    s_group2domain_list: List[List[int]] = None
    t_group2domain_list: List[List[int]] = None
    initial_s_group2domain_list: Optional[List[List[int]]] = None
    call_update_group: int = 0
    p_weight: float = 0.02
    # metric orientation (cdc.py:87-93)
    default_metric_value: float = 1e6
    is_max_metric_value_better: bool = False

    @classmethod
    def create(cls, n_domain: int, n_cluster: int, cfg: CDCConfig) -> "CDCClusterState":
        use_loss = cfg.use_metric == "loss"
        divide = cfg.affinity_func == "divide"
        if use_loss ^ divide:
            default, max_better = 1e6, False
        else:
            default, max_better = -1e6, True
        return cls(
            n_domain=n_domain,
            n_cluster=n_cluster,
            n_causal_mask=cfg.n_causal_mask,
            matrix_A=np.zeros((n_domain + 1, n_domain), np.float64),
            matrix_B=np.zeros((n_domain + n_cluster, n_domain), np.float64),
            matrix_mask=np.zeros((cfg.n_causal_mask, n_domain), np.float64),
            matrix_causal=np.zeros((n_domain, n_domain), np.float64),
            domain2group=np.zeros(n_domain, np.int64),
            s_group2domain_list=[list(range(n_domain))],
            t_group2domain_list=[list(range(n_domain))],
            p_weight=cfg.p_weight,
            default_metric_value=default,
            is_max_metric_value_better=max_better,
        )

    @property
    def domain2group_list(self) -> List[int]:
        return self.domain2group.tolist()


def calc_causal_matrix(X: np.ndarray, alpha: Optional[float] = None) -> np.ndarray:
    """Distance-covariance-based causal-similarity kernel (cdc.py:364-393).

    The method of "A Distance Covariance-based Kernel for Nonlinear Causal
    Clustering in Heterogeneous Populations" (causal.dev dep_con_kernel):
    per feature j, the doubly-centered+standardized cityblock distance matrix
    Z_j; kernel gamma = (F^T F)^2 - 2*tensordot + ||thresh||; kappa = cosine
    normalization.  X: [num_samples, num_features] (domains x treatments).
    Returns kappa in [-1, 1]; arccos(kappa) is the angular causal distance.
    """
    X = np.asarray(X, np.float64)
    num_samps, num_feats = X.shape
    thresh = np.eye(num_feats)
    if alpha is not None:
        from scipy.stats import chi2

        off = chi2(1).ppf(1 - alpha) / num_samps
        thresh = np.where(np.eye(num_feats) > 0, 0.0, off)
    Z = np.zeros((num_feats, num_samps, num_samps))
    for j in range(num_feats):
        col = X[:, j]
        D = np.abs(col[:, None] - col[None, :])  # cityblock pdist, squareform
        mean_all = D.mean()
        Z[j] = (D - D.mean(0)[None, :] - D.mean(1)[:, None]) / mean_all + 1.0

    F = Z.reshape(num_feats * num_samps, num_samps)
    left = np.tensordot(Z, thresh, axes=([0], [0]))
    left_right = np.tensordot(left, Z, axes=([2, 1], [0, 1]))
    gamma = (F.T @ F) ** 2 - 2 * left_right + np.linalg.norm(thresh)

    diag = np.diag(gamma)
    kappa = gamma / np.sqrt(np.outer(diag, diag))
    kappa = np.minimum(kappa, 1.0)  # numerical errors (cdc.py:392)
    return kappa


# scikit-learn's KMeans settings (KMeans(n_clusters, random_state=seed,
# n_init=10), its defaults otherwise: k-means++ init, Lloyd, max_iter 300,
# tol 1e-4)
KMEANS_N_INIT = 10
KMEANS_MAX_ITER = 300
KMEANS_TOL = 1e-4


def _row_norms_sq(X: np.ndarray) -> np.ndarray:
    """sklearn.utils.extmath.row_norms(X, squared=True)."""
    return np.einsum("ij,ij->i", X, X)


def _sq_distances(Xa: np.ndarray, X: np.ndarray,
                  x_sq: np.ndarray) -> np.ndarray:
    """sklearn's _euclidean_distances(Xa, X, Y_norm_squared=x_sq,
    squared=True) for float64 arrays -> [len(Xa), len(X)]."""
    d = -2 * np.dot(Xa, X.T)
    d += _row_norms_sq(Xa)[:, None]
    d += x_sq[None, :]
    np.maximum(d, 0, out=d)
    return d


def _kmeans_plusplus(X, n_clusters, x_sq, rs) -> np.ndarray:
    """Greedy k-means++ seeding with 2 + floor(ln k) local trials and unit
    sample weights (sklearn.cluster._kmeans._kmeans_plusplus)."""
    n_samples = X.shape[0]
    w = np.ones(n_samples, X.dtype)
    centers = np.empty((n_clusters, X.shape[1]), dtype=X.dtype)
    n_local_trials = 2 + int(np.log(n_clusters))
    center_id = rs.choice(n_samples, p=w / w.sum())
    centers[0] = X[center_id]
    closest = _sq_distances(centers[0, np.newaxis], X, x_sq)
    pot = closest @ w
    for c in range(1, n_clusters):
        rand_vals = rs.uniform(size=n_local_trials) * pot
        cand = np.searchsorted(np.cumsum(w * closest), rand_vals)
        np.clip(cand, None, closest.size - 1, out=cand)
        dist = _sq_distances(X[cand], X, x_sq)
        np.minimum(closest, dist, out=dist)
        cand_pot = dist @ w.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot = cand_pot[best]
        closest = dist[best]
        centers[c] = X[cand[best]]
    return centers


def _sq_dist_unrolled(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise squared distances summed as sklearn's
    _euclidean_dense_dense sums them: four terms at a time, each group's
    ((t0 + t1) + t2) + t3 added to a running sum, then the remainder one
    by one."""
    t = (a - b) * (a - b)
    n4 = t.shape[1] // 4 * 4
    g = t[:, :n4].reshape(t.shape[0], -1, 4)
    g = ((g[..., 0] + g[..., 1]) + g[..., 2]) + g[..., 3]
    out = np.zeros(t.shape[0], t.dtype)
    for j in range(g.shape[1]):
        out += g[:, j]
    for j in range(n4, t.shape[1]):
        out += t[:, j]
    return out


def _lloyd_labels(X, centers) -> np.ndarray:
    """The E-step: each row's nearest center, the first on a tie, from
    ||c||^2 - 2 x.c as sklearn's _update_chunk_dense computes it."""
    d = -2.0 * np.dot(X, centers.T) + _row_norms_sq(centers)[None, :]
    return np.argmin(d, axis=1).astype(np.int32)


def _lloyd_iter(X, centers, labels) -> tuple:
    """One Lloyd step (sklearn's lloyd_iter_chunked_dense with unit
    weights): new labels, the centers summed in row order, empty clusters
    relocated to the rows farthest from their centers, the centers
    averaged, and each center's shift.  -> (new centers, shift)."""
    k, n_feat = centers.shape
    labels[:] = _lloyd_labels(X, centers)
    new = np.zeros_like(centers)
    np.add.at(new, labels, X)
    weight = np.bincount(labels, minlength=k).astype(X.dtype)
    empty = np.where(np.equal(weight, 0))[0].astype(np.int32)
    if len(empty):
        dist = ((X - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
        if np.max(dist) != 0:
            for new_id, far_idx in zip(empty, far):
                old_id = labels[far_idx]
                new[old_id] -= X[far_idx]
                new[new_id] = X[far_idx]
                weight[new_id] = 1.0
                weight[old_id] -= 1.0
    biggest = int(np.argmax(weight))
    for j in range(k):
        if weight[j] > 0:
            new[j] *= 1.0 / weight[j]
        else:
            new[j] = new[biggest]
    shift = np.sqrt(_sq_dist_unrolled(new, centers))
    return new, shift


def _kmeans_single_lloyd(X, centers, tol) -> tuple:
    """sklearn's _kmeans_single_lloyd: iterate until the labels repeat
    (strict convergence) or the centers' squared shift is within ``tol``;
    without strict convergence the labels are recomputed from the final
    centers.  -> (labels, inertia)."""
    labels = np.full(X.shape[0], -1, dtype=np.int32)
    labels_old = labels.copy()
    strict = False
    for _ in range(KMEANS_MAX_ITER):
        centers, shift = _lloyd_iter(X, centers, labels)
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old[:] = labels
    if not strict:
        labels = _lloyd_labels(X, centers)
    inertia = 0.0
    for d in _sq_dist_unrolled(X, centers[labels]):
        inertia += d
    return labels, inertia


def _is_same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    """Whether labels ``a`` and ``b`` are one partition up to renaming."""
    mapping = np.full(k, -1, np.int64)
    for la, lb in zip(a, b):
        if mapping[la] == -1:
            mapping[la] = lb
        elif mapping[la] != lb:
            return False
    return True


def kmeans_group(matrix_causal: np.ndarray, n_cluster: int, seed: Optional[int] = None):
    """KMeans on rows of the causal distance matrix (cdc.py:359-362):
    scikit-learn's ``KMeans(n_clusters=n_cluster, random_state=seed,
    n_init=10).fit(matrix_causal).labels_``, step for step.

    The tolerance is 1e-4 of the mean per-column variance; X is centred
    by its column means; each of the 10 runs seeds with greedy k-means++
    and runs Lloyd; the run of least inertia is kept unless it is the
    best run's partition under other names.  Every draw comes from
    ``np.random.RandomState(seed)`` (numpy's global one when ``seed`` is
    None), in sklearn's order.  Rows are summed in row order: above 256
    rows sklearn sums chunks on several threads, in an order no copy can
    follow."""
    X = np.array(matrix_causal, dtype=np.float64, order="C", copy=True)
    if X.shape[0] < n_cluster:
        raise ValueError(
            f"n_samples={X.shape[0]} should be >= n_clusters={n_cluster}.")
    rs = (np.random.mtrand._rand if seed is None
          else np.random.RandomState(seed))
    tol = np.mean(np.var(X, axis=0)) * KMEANS_TOL
    X -= X.mean(axis=0)
    x_sq = _row_norms_sq(X)
    best_labels, best_inertia = None, None
    for _ in range(KMEANS_N_INIT):
        centers = _kmeans_plusplus(X, n_cluster, x_sq, rs)
        labels, inertia = _kmeans_single_lloyd(X, centers, tol)
        if best_inertia is None or (
                inertia < best_inertia
                and not _is_same_clustering(labels, best_labels, n_cluster)):
            best_labels, best_inertia = labels, inertia
    return best_labels.astype(np.int64)


def calc_domain_lambda_in_group(
    st: CDCClusterState, group: Sequence[int], domain: Optional[Sequence[int]] = None
) -> np.ndarray:
    """λ in-group similarity (cdc.py:321-341):
    clamp((|G|-1) * Σ_{g∈G} dist(g, d) / (ΣΣ_{GxG} dist - Σ dist(G, d)) * 0.5, 0, 1)."""
    group = list(group)
    if domain is None:
        domain = list(range(st.n_domain))
    group_dis = st.matrix_causal[np.ix_(group, group)]
    group_total = group_dis.sum()
    related = st.matrix_causal[np.ix_(group, list(domain))].sum(axis=0)
    non_related = group_total - related
    with np.errstate(divide="ignore", invalid="ignore"):
        vals = (len(group) - 1) * related / non_related * 0.5
    return np.clip(np.nan_to_num(vals, nan=0.0, posinf=1.0, neginf=0.0), 0.0, 1.0)


def get_center_domain_in_group(
    st: CDCClusterState, group: Sequence[int], center_num: int = 1
) -> List[int]:
    """Domains with smallest λ-distance within the group (cdc.py:314-319)."""
    group = list(group)
    center_num = min(center_num, len(group))
    vals = calc_domain_lambda_in_group(st, group, group)
    best = np.argsort(vals, kind="stable")[:center_num]
    return [group[i] for i in best]


def get_source_domain(
    st: CDCClusterState,
    t_group: Sequence[int],
    group_idx: int,
    domain_cnt_weight: np.ndarray,
) -> List[int]:
    """Greedy source-group growth (cdc.py:240-296): start from 2 center
    domains; iteratively add the domain with the best expected gain
    J(i) = Σ_t w_t [(1-λ)A[i,t] + λB[i,t]] (+ decaying prior toward the
    initial clusters) while the gain is useful."""
    t_group = list(t_group)
    s_group = get_center_domain_in_group(st, t_group, center_num=2)
    has_useful = True
    n = st.n_domain

    while has_useful and len(s_group) < n:
        lam_rows = []
        for d_i in range(n):
            if d_i in s_group:
                lam_rows.append(np.zeros(len(t_group)))
            else:
                lam_rows.append(
                    calc_domain_lambda_in_group(st, s_group + [d_i], t_group)
                )
        lam = np.stack(lam_rows, axis=0)  # [n_domain, |t_group|]

        w = domain_cnt_weight[t_group].astype(np.float64)
        if w.sum() != 0:
            w = w / w.sum()

        A_sel = st.matrix_A[:n][:, t_group]
        B_sel = st.matrix_B[:n][:, t_group]
        J = (((1 - lam) * A_sel + lam * B_sel) * w[None, :]).sum(axis=1)

        if st.initial_s_group2domain_list is None:
            result = J.copy()
        else:
            P = (
                1 - 2 * calc_domain_lambda_in_group(
                    st, st.initial_s_group2domain_list[group_idx]
                )
            ) * np.power(domain_cnt_weight, 0.5)
            if st.is_max_metric_value_better:
                result = J + st.p_weight * P
            else:
                result = J - st.p_weight * P
        result[s_group] = st.default_metric_value
        if st.is_max_metric_value_better:
            best_domain = int(np.argmax(result))
            has_useful = result[best_domain] > 0
        else:
            best_domain = int(np.argmin(result))
            has_useful = result[best_domain] < 0
        if has_useful:
            s_group.append(best_domain)
    return s_group


def calc_metric_in_source_group(
    st: CDCClusterState, target_domain: int, s_group: Sequence[int]
) -> float:
    """(cdc.py:308-312)"""
    lam = calc_domain_lambda_in_group(st, s_group, [target_domain])
    return float(
        np.sum(
            (1 - lam) * st.matrix_A[list(s_group), target_domain]
            + lam * st.matrix_B[list(s_group), target_domain]
        )
    )


def _update_p_weight(st: CDCClusterState, cfg: CDCConfig):
    """(cdc.py:298-306) — decay applied at the start of each update_group."""
    if st.p_weight > 1e-10:
        if cfg.p_weight_method == "linear_decay":
            st.p_weight = cfg.p_weight / st.call_update_group
        elif cfg.p_weight_method == "quadratic_decay":
            st.p_weight = cfg.p_weight / (st.call_update_group ** 2)
        elif cfg.p_weight_method == "exponential_decay":
            st.p_weight = st.p_weight * cfg.p_weight_exp_decay


def update_group(
    st: CDCClusterState,
    cfg: CDCConfig,
    domain_cnt_weight: np.ndarray,
    kmeans_seed: Optional[int] = None,
) -> List[int]:
    """Full re-clustering pass (cdc.py:121-238): EMA-blend matrices,
    affinity transform, causal kernel, then KMeans (first call) or
    center-seeded iterative/greedy re-assignment + source-group growth."""
    st.call_update_group += 1
    _update_p_weight(st, cfg)

    if cfg.old_matrix_weight > 0 and st.old_matrix_A is not None:
        w = cfg.old_matrix_weight
        st.matrix_A = st.old_matrix_A * w + st.matrix_A * (1 - w)
        st.matrix_B = st.old_matrix_B * w + st.matrix_B * (1 - w)
    # cdc-plus: EMA the raw mask matrix across updates.  The reference
    # EMAs A/B (old_matrix_weight) but rebuilds mask from single-probe
    # measurements every update (cdc.py:131-134), so the clustering input
    # carries full per-update probe noise; mask_ema=0 keeps that behavior.
    if cfg.mask_ema > 0 and st.old_matrix_mask is not None:
        w = cfg.mask_ema
        st.matrix_mask = st.old_matrix_mask * w + st.matrix_mask * (1 - w)
    st.old_matrix_A = st.matrix_A.copy()
    st.old_matrix_B = st.matrix_B.copy()
    st.old_matrix_mask = st.matrix_mask.copy()

    n = st.n_domain
    if cfg.affinity_func == "minus":  # less is better (cdc.py:136-140)
        st.matrix_A[:-1] -= st.matrix_A[-1]
        st.matrix_B[:n] = st.matrix_B[st.domain2group + n] - st.matrix_B[:n]
        st.matrix_mask = st.matrix_mask - st.matrix_A[-1]
    elif cfg.affinity_func == "divide":  # larger is better (cdc.py:141-144)
        st.matrix_A[:-1] = 1 - st.matrix_A[:-1] / st.matrix_A[-1]
        st.matrix_B[:n] = 1 - st.matrix_B[st.domain2group + n] / st.matrix_B[:n]
        st.matrix_mask = 1 - st.matrix_mask / st.matrix_A[-1]
    else:
        raise ValueError(f"Unknown affinity_func: {cfg.affinity_func}")

    kappa = calc_causal_matrix(st.matrix_mask.T)
    st.matrix_causal = np.arccos(np.clip(kappa, -1.0, 1.0))

    if int(st.domain2group.max()) == 0:
        # first call: KMeans on causal distances (cdc.py:156-169)
        labels = kmeans_group(st.matrix_causal, st.n_cluster, seed=kmeans_seed)
        st.domain2group = labels
        t_groups = [[] for _ in range(st.n_cluster)]
        for d, g in enumerate(labels):
            t_groups[int(g)].append(d)
        st.t_group2domain_list = t_groups
        st.s_group2domain_list = [
            get_source_domain(st, t_groups[c], c, domain_cnt_weight)
            for c in range(st.n_cluster)
        ]
        st.initial_s_group2domain_list = [list(g) for g in st.s_group2domain_list]
    else:
        t_prev = st.t_group2domain_list
        domain_queue = list(range(n))
        t_group = [[] for _ in range(st.n_cluster)]
        s_group = [[] for _ in range(st.n_cluster)]
        metric = np.empty((n, st.n_cluster))
        centers = [
            get_center_domain_in_group(st, t_prev[c])[0] for c in range(st.n_cluster)
        ]
        for c in range(st.n_cluster):
            t_group[c].append(centers[c])
            domain_queue.remove(centers[c])
            metric[centers[c], :] = st.default_metric_value

        if cfg.cluster_mode == "iterative":  # (cdc.py:183-211)
            updated = True
            while domain_queue and updated:
                updated = False
                for c in range(st.n_cluster):
                    s_group[c] = get_source_domain(st, t_group[c], c, domain_cnt_weight)
                for d in domain_queue:
                    for c in range(st.n_cluster):
                        metric[d, c] = calc_metric_in_source_group(st, d, s_group[c])
                if st.is_max_metric_value_better:
                    best_domain = np.argmax(metric, axis=0)
                else:
                    best_domain = np.argmin(metric, axis=0)
                for c in range(st.n_cluster):
                    row = metric[best_domain[c], :]
                    flag = (
                        np.argmax(row) == c
                        if st.is_max_metric_value_better
                        else np.argmin(row) == c
                    )
                    if flag:
                        updated = True
                        b = int(best_domain[c])
                        t_group[c].append(b)
                        domain_queue.remove(b)
                        metric[b, :] = st.default_metric_value
            if domain_queue:
                raise ValueError("target domain_queue is not empty")  # cdc.py:211
        elif cfg.cluster_mode == "greedy":  # (cdc.py:212-225)
            for c in range(st.n_cluster):
                s_group[c] = get_source_domain(st, t_group[c], c, domain_cnt_weight)
            for d in domain_queue:
                for c in range(st.n_cluster):
                    metric[d, c] = calc_metric_in_source_group(st, d, s_group[c])
            for d in domain_queue:
                best = (
                    int(np.argmax(metric[d]))
                    if st.is_max_metric_value_better
                    else int(np.argmin(metric[d]))
                )
                t_group[best].append(d)
        else:
            raise ValueError(f"unknown cluster_mode {cfg.cluster_mode!r}")

        st.t_group2domain_list = t_group
        d2g = np.zeros(n, np.int64)
        for c in range(st.n_cluster):
            st.s_group2domain_list[c] = get_source_domain(
                st, t_group[c], c, domain_cnt_weight
            )
            d2g[t_group[c]] = c
        st.domain2group = d2g

    return st.domain2group_list

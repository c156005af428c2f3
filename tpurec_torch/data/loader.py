"""Runtime batching (the port's own copy of ``tpurec/data/loader.py``,
numpy only).

Re-designs the reference's runtime loaders (run.py:194-293) for an
accelerator:

- whole split tensorized once; batches are fixed-shape [bs, F] slices of a
  shuffled index permutation, with the tail batch PADDED and masked
  (the reference's variable last batch and variable-size domain subsets
  would change the step's shapes)
- :class:`DomainBatcher` reproduces the per-domain loaders + shuffled
  ``*_domain_batch_seq`` multiset of run.py:248-293 and the auto-reset
  round-robin generators of run.py:499-526, with numpy RNG so the CDC
  schedule semantics match the reference's np.random-driven schedule.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class ArrayBatcher:
    """Shuffled fixed-shape batches over (X, y[, group]) numpy arrays."""

    def __init__(
        self,
        X: np.ndarray,
        y: np.ndarray,
        bs: int,
        group: Optional[np.ndarray] = None,
        shuffle: bool = True,
        rng: Optional[np.random.Generator] = None,
        drop_remainder: bool = False,
    ):
        self.X = X
        self.y = y.astype(np.float32).reshape(-1)
        self.group = group
        self.bs = bs
        self.shuffle = shuffle
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.drop_remainder = drop_remainder
        self.n = X.shape[0]

    def __len__(self):
        if self.drop_remainder:
            return self.n // self.bs
        return -(-self.n // self.bs)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(self.n)
        if self.shuffle:
            self.rng.shuffle(idx)
        nb = len(self)
        for b in range(nb):
            sl = idx[b * self.bs : (b + 1) * self.bs]
            yield pad_batch(
                self.X[sl], self.y[sl],
                None if self.group is None else self.group[sl],
                self.bs,
            )


def pad_batch(
    X: np.ndarray, y: np.ndarray, group: Optional[np.ndarray], bs: int
) -> Dict[str, np.ndarray]:
    """Fixed-shape batch dict with a validity mask (pad rows repeat row 0)."""
    n = X.shape[0]
    mask = np.ones(bs, np.float32)
    if n < bs:
        pad = bs - n
        X = np.concatenate([X, np.repeat(X[:1], pad, axis=0)], axis=0)
        y = np.concatenate([y, np.zeros(pad, y.dtype)])
        if group is not None:
            group = np.concatenate([group, np.repeat(group[:1], pad)])
        mask[n:] = 0.0
    out = {"x": X.astype(np.int32), "y": y.astype(np.float32), "mask": mask}
    out["group"] = (
        group.astype(np.int32) if group is not None else np.zeros(bs, np.int32)
    )
    return out


class DomainBatcher:
    """Per-domain batch streams + the shuffled domain batch sequence.

    Matches run.py:248-293: each domain d contributes
    ceil(n_d/bs) entries to the epoch's ``domain_batch_seq``; iterating a
    domain past its end reshuffles and restarts it (run.py:499-526).
    """

    def __init__(
        self,
        X: np.ndarray,
        y: np.ndarray,
        domain_idx: int,
        n_domain: int,
        bs: int,
        rng: Optional[np.random.Generator] = None,
    ):
        self.bs = bs
        self.n_domain = n_domain
        self.rng = rng if rng is not None else np.random.default_rng(0)
        d = X[:, domain_idx]
        self.dom_X: List[np.ndarray] = []
        self.dom_y: List[np.ndarray] = []
        self.dom_rows: List[np.ndarray] = []  # global row indices per domain
        self._perm: List[np.ndarray] = []
        self._pos: List[int] = []
        seq: List[int] = []
        for dom in range(n_domain):
            m = d == dom
            self.dom_X.append(X[m])
            self.dom_y.append(y[m].astype(np.float32).reshape(-1))
            self.dom_rows.append(np.nonzero(m)[0].astype(np.int32))
            self._perm.append(self.rng.permutation(int(m.sum())))
            self._pos.append(0)
            seq.extend([dom] * int(np.ceil(m.sum() / bs)))
        self.domain_batch_seq = np.array(seq, np.int32)
        self.rng.shuffle(self.domain_batch_seq)
        counts = np.array([len(xx) for xx in self.dom_X], np.float64)
        self.domain_cnt = counts
        self.domain_cnt_weight = counts / counts.sum()

    def epoch_seq(self, reshuffle: bool = True) -> np.ndarray:
        if reshuffle:
            self.rng.shuffle(self.domain_batch_seq)
        return self.domain_batch_seq

    def next_batch(self, d: int) -> Tuple[np.ndarray, np.ndarray]:
        """One [<=bs] batch from domain d, auto-resetting (run.py:499-518)."""
        n = len(self.dom_X[d])
        pos = self._pos[d]
        if pos >= n:
            self._perm[d] = self.rng.permutation(n)
            self._pos[d] = 0
            pos = 0
        sl = self._perm[d][pos : pos + self.bs]
        self._pos[d] = pos + len(sl)
        return self.dom_X[d][sl], self.dom_y[d][sl]

    def next_idx(self, d: int) -> np.ndarray:
        """Global row indices of the next batch of domain d (same scheduling
        semantics as :meth:`next_batch`), for device-resident gather feeds."""
        n = len(self.dom_rows[d])
        pos = self._pos[d]
        if pos >= n:
            self._perm[d] = self.rng.permutation(n)
            self._pos[d] = 0
            pos = 0
        sl = self._perm[d][pos : pos + self.bs]
        self._pos[d] = pos + len(sl)
        return self.dom_rows[d][sl]

    def next_padded(self, d: int, group_of: Optional[np.ndarray] = None) -> Dict:
        X, y = self.next_batch(d)
        g = None
        if group_of is not None:
            g = np.full(len(y), group_of[d], np.int32)
        batch = pad_batch(X, y, g, self.bs)
        return batch

    def next_multi(
        self, domains: Sequence[int], n_slots: int, group_of: Optional[np.ndarray] = None
    ) -> Dict:
        """One batch from each domain in ``domains`` concatenated into a
        fixed [n_slots*bs] super-batch (run.py:519-526), shuffled order,
        padding unused slots."""
        ds = list(domains)
        self.rng.shuffle(ds)
        Xs, ys, gs = [], [], []
        for d in ds[:n_slots]:
            X, y = self.next_batch(d)
            Xs.append(X)
            ys.append(y)
            if group_of is not None:
                gs.append(np.full(len(y), group_of[d], np.int32))
        X = np.concatenate(Xs, axis=0)
        y = np.concatenate(ys)
        g = np.concatenate(gs) if gs else None
        return pad_batch(X, y, g, n_slots * self.bs)


def prefetch_iter(it, depth: int = 2):
    """Run ``it`` on a worker thread, keeping up to ``depth`` items ready.

    Used to overlap host-side batch stacking + H2D transfer start with
    device compute (the reference's DataLoader blocks the train loop on
    every batch).  Exceptions on the worker re-raise at the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        if isinstance(item, BaseException):
            raise item
        yield item

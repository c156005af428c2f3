"""Training/eval harness of the port (counterpart of ``tpurec/train/loop.py``).

The reference's ``Run`` class (run.py:30-765) split into a reusable Trainer:
epoch loop, weighted-mean-AUC early stopping with patience (run.py:440-468),
best-state save/reload (run.py:447-459,758-760), and global + per-domain
evaluation (run.py:647-711).

- ``cfg.train.embedding_update`` picks the table's update as the JAX
  package's Trainer does (``tpurec/train/loop.py:126-177``): ``"hybrid"``
  (the default, :func:`tpurec_torch.train.hybrid.make_hybrid_train_step`),
  ``"sparse"`` (:func:`~tpurec_torch.train.hybrid.make_sparse_train_step`,
  lazy Adam on the touched rows) or ``"dense"``
  (:func:`tpurec_torch.train.step.make_train_step`, one Adam over every
  parameter).
- Under ``"hybrid"``, an epoch over a dataset that fits
  :attr:`Trainer.DEVICE_RESIDENT_BYTES` runs device-resident: the split
  is copied to the card once, and each step gathers its batch there by
  row index (:meth:`tpurec_torch.train.hybrid.HybridTrainStep.
  scan_steps_idx`); a larger one, and every epoch of the other two
  updates (which have no ``scan_steps_idx``, as in the JAX package), is
  batched on the host (``ArrayBatcher`` on a prefetch thread, K stacked
  batches a call).  Both follow the JAX package's batch schedule, so they
  differ only in their padding rows, which are masked.
- Losses stay on the device; the host sums them only at log points and
  at the end of the epoch.
- Dropout draws from one ``torch.Generator`` on the device, seeded from
  ``cfg.train.seed + 1``, in step order.
- The state's snapshots and checkpoints are flax msgpack bytes of the JAX
  package's TrainState layout (:mod:`tpurec_torch.convert`), so a
  checkpoint written here loads into the JAX package's Trainer and
  Predictor, and theirs into the port's.

Not ported (each raises NotImplementedError naming ROADMAP.md): a mesh
(``mesh``/``shardings``, ``train_epoch_multihost``,
``evaluate_streaming_multihost``).
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, Optional

import numpy as np
import torch

from tpurec_torch.config import Config, config_to_dict
from tpurec_torch.convert import restore_train_state, train_state_to_flax
from tpurec_torch.data.loader import ArrayBatcher, prefetch_iter
from tpurec_torch.device import resolve_device
from tpurec_torch.metrics import (auc_score, evaluate_multi_domain,
                                  log_loss_score, streaming_eval_result)
from tpurec_torch.models import MULTI_TOWER_OUTPUT, build_model
from tpurec_torch.train.checkpoint import (EMBED_LAYOUT_VERSION,
                                           check_embed_layout_version,
                                           make_backend, msgpack_dumps,
                                           msgpack_restore)
from tpurec_torch.train.hybrid import (init_train_state,
                                       make_hybrid_train_step,
                                       make_sparse_train_step)
from tpurec_torch.train.reg import reg_coef_tree
from tpurec_torch.train.step import (HostHistAccumulator,
                                     init_dense_train_state, make_eval_step,
                                     make_indexed_eval_scan,
                                     make_streaming_eval_scan,
                                     make_train_step)

EMBEDDING_UPDATES = ("hybrid", "sparse", "dense")


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer, np.floating)):
        return obj.item()
    return obj


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to tpurec_torch yet: see ROADMAP.md, queue 1, "
        f"{item}")


def use_streaming_eval(cfg, mesh) -> bool:
    """eval_streaming=None means auto: histogram (no-host-gather) eval
    whenever running on a mesh.  Single rule shared by the trainers."""
    es = cfg.train.eval_streaming
    return (mesh is not None) if es is None else bool(es)


class EarlyStopper:
    """mean_auc-keyed early stopping with patience (run.py:440-468)."""

    def __init__(self, patience: int):
        self.patience = patience
        self.trial_counter = 0
        self.best_mean_auc = 0.0
        self.best_result: Optional[Dict] = None

    def is_continuable(self, result: Dict) -> bool:
        key = "mean_auc" if result.get("mean_auc") is not None else "total_auc"
        if result[key] > self.best_mean_auc:
            self.trial_counter = 0
            self.best_mean_auc = result[key]
            self.best_result = result
            return True
        elif self.trial_counter + 1 < self.patience:
            self.trial_counter += 1
            return True
        return False

    @property
    def improved(self) -> bool:
        return self.trial_counter == 0


class Trainer:
    """Standard (non-CDC) training harness for the ported models, on
    ``device`` (the card unless the caller asks for the CPU).

    The model's weights are drawn from a CPU generator seeded
    ``cfg.train.seed``; ``self.state`` is the port's
    :class:`tpurec_torch.train.step.TrainState`."""

    def __init__(self, cfg: Config, field_dims, n_domain: int, domain_idx: int,
                 domain2group=None, mesh=None, shardings=None, device=None):
        if mesh is not None or shardings is not None:
            raise _not_ported("a mesh (mesh=, shardings=)", "'Parallelism'")
        self.cfg = cfg
        self.n_domain = n_domain
        self.domain_idx = domain_idx
        name = cfg.model.model
        if domain2group is None:
            domain2group = np.zeros(n_domain, np.int32)
        self.domain2group = np.asarray(domain2group, np.int32)
        if name in ("cdc",):
            raise ValueError("use the CDC trainer for CDC")
        if cfg.train.embedding_update not in EMBEDDING_UPDATES:
            raise ValueError(f"embedding_update must be one of "
                             f"{EMBEDDING_UPDATES}, got "
                             f"{cfg.train.embedding_update!r}")
        # ADL routes over n_cluster towers (run.py:43); adl-split, as every
        # other model, over the grouping's (tpurec/train/loop.py:100-102)
        self.n_tower = (cfg.cdc.n_cluster if name == "adl"
                        else int(self.domain2group.max()) + 1)
        self.device = resolve_device(device)
        self.model = build_model(
            name, field_dims, self.n_tower, domain_idx, cfg.model,
            device=self.device,
            generator=torch.Generator().manual_seed(cfg.train.seed))
        self.multi_tower = (name in MULTI_TOWER_OUTPUT
                            and not name.endswith("-single"))
        self.mesh = None

        tcfg = cfg.train
        self.reg_coefs = reg_coef_tree(
            [n for n, _ in self.model.named_parameters()], name,
            cfg.model.l2_reg_embedding, cfg.model.l2_reg_linear,
            cfg.model.l2_reg_dnn)
        self.embedding_update = tcfg.embedding_update
        # one step object (one table updater, one prepared gather) serves
        # the single step, the K-step loop and (hybrid) the indexed loop
        if self.embedding_update == "dense":
            self.state = init_dense_train_state(self.model, tcfg,
                                                self.device)
            step = make_train_step(self.model, tcfg, self.reg_coefs,
                                   self.multi_tower,
                                   scan_k=tcfg.steps_per_dispatch)
        else:
            self.state = init_train_state(self.model, tcfg, self.device)
            make = (make_hybrid_train_step
                    if self.embedding_update == "hybrid"
                    else make_sparse_train_step)
            step = make(self.model, tcfg, self.reg_coefs, self.multi_tower,
                        l2_reg_embedding=cfg.model.l2_reg_embedding,
                        scan_k=tcfg.steps_per_dispatch)
        self.train_step = step.one_step
        self.scan_steps = step
        self.scan_steps_idx = (step.scan_steps_idx
                               if self.embedding_update == "hybrid"
                               else None)
        self.eval_step = make_eval_step(self.model, self.multi_tower,
                                        compute_dtype=tcfg.compute_dtype)
        self.eval_scan = make_indexed_eval_scan(
            self.model, self.multi_tower, self.domain_idx,
            compute_dtype=tcfg.compute_dtype)
        self.dropout_gen = torch.Generator(device=self.device).manual_seed(
            tcfg.seed + 1)
        self.stopper = EarlyStopper(tcfg.early_stop)
        self._best_bytes: Optional[bytes] = None

    # ------------------------------------------------------------------
    def _group_of(self, X: np.ndarray) -> np.ndarray:
        return self.domain2group[X[:, self.domain_idx]]

    # datasets up to this size train device-resident (leaves the card's
    # memory to the table, its moments and the activations)
    DEVICE_RESIDENT_BYTES = 4 << 30

    def _device_dataset(self, X: np.ndarray, y: np.ndarray):
        """(X int32, y float32, domain2group int32) on the device, cached
        so that alternating train/valid/test epochs do not copy again.

        The cache holds references to the HOST arrays too: the key uses
        id(), which CPython reuses after GC — a dead X would let a new
        same-shape array silently hit the stale device copy.  Aggregate
        bytes are capped; the oldest entries evict first."""
        cache = getattr(self, "_dev_data_cache", None)
        if cache is None:
            cache = self._dev_data_cache = {}
        key = (id(X), X.shape, id(y))
        if key not in cache:
            budget = int(1.5 * self.DEVICE_RESIDENT_BYTES)  # aggregate cap
            while cache and (
                sum(e[0].nbytes + e[1].nbytes for e in cache.values())
                + X.nbytes + y.nbytes > budget
                or len(cache) >= 4
            ):
                cache.pop(next(iter(cache)))
            cache[key] = (
                X, y,
                torch.as_tensor(np.asarray(X, np.int32), device=self.device),
                torch.as_tensor(np.asarray(y, np.float32).reshape(-1),
                                device=self.device),
                torch.as_tensor(self.domain2group, device=self.device),
            )
        return cache[key][2:]

    def _to_device(self, arrays: Dict[str, np.ndarray]):
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in arrays.items()}

    def _train_epoch_device_resident(self, X, y, epoch_i, log_fn) -> float:
        """Epoch with the dataset on the device: the epoch's [nb, bs] row
        indices cross to the card once.  The same shuffle as the host path;
        the tail batch is padded with row 0 under mask 0
        (``tpurec/train/loop.py:220-281``)."""
        bs = self.cfg.train.bs
        K = max(1, self.cfg.train.steps_per_dispatch)
        Xdev, ydev, d2g = self._device_dataset(X, y)
        n = X.shape[0]
        idx = np.arange(n)
        np.random.default_rng(self.cfg.train.seed + epoch_i).shuffle(idx)
        nb = -(-n // bs)
        pad = nb * bs - n
        mask = np.ones(nb * bs, np.float32)
        if pad:
            idx = np.concatenate([idx, np.zeros(pad, np.int64)])
            mask[n:] = 0.0
        idx_dev = torch.as_tensor(idx.reshape(nb, bs).astype(np.int32),
                                  device=self.device)
        mask_dev = torch.as_tensor(mask.reshape(nb, bs), device=self.device)

        loss_sum, n_batches, device_losses = 0.0, 0, []

        def synced_loss():
            nonlocal loss_sum, device_losses
            for part in device_losses:
                loss_sum += float(part.sum())
            device_losses = []
            return loss_sum / max(n_batches, 1)

        # the chunk bounds how often log_fn fires (tpurec/train/loop.py:260)
        CH = max(K, min(2048, self.cfg.train.log_interval_rows // bs
                        if log_fn is not None else 2048))
        for b0 in range(0, nb, CH):
            k = min(CH, nb - b0)
            losses = self.scan_steps_idx(
                self.state, Xdev, ydev, d2g, idx_dev[b0:b0 + k],
                mask_dev[b0:b0 + k], self.dropout_gen)
            device_losses.append(losses)
            n_batches += k
            if log_fn is not None:
                log_fn({"train_loss": synced_loss(), "epoch": epoch_i,
                        "it": n_batches})
        return synced_loss()

    def train_epoch(self, X: np.ndarray, y: np.ndarray, epoch_i: int,
                    log_fn=None) -> float:
        if (self.scan_steps_idx is not None
                and X.nbytes + y.nbytes <= self.DEVICE_RESIDENT_BYTES):
            return self._train_epoch_device_resident(X, y, epoch_i, log_fn)
        bs = self.cfg.train.bs
        batcher = ArrayBatcher(
            X, y, bs, group=self._group_of(X), shuffle=True,
            rng=np.random.default_rng(self.cfg.train.seed + epoch_i),
        )
        loss_sum, n_batches = 0.0, 0
        log_interval = max(1, self.cfg.train.log_interval_rows // bs)
        K = max(1, self.cfg.train.steps_per_dispatch)

        def chunked():
            """Host side: stack K batches and start their copy to the
            device.  Runs on the prefetch thread, so stacking and the copy
            overlap the steps."""
            pending = []

            def emit():
                if not pending:
                    return None
                if len(pending) == 1 or K == 1:
                    out = [(self._to_device(b), 1, False) for b in pending]
                else:
                    stacked = self._to_device(
                        {k: np.stack([b[k] for b in pending])
                         for k in pending[0]})
                    out = [(stacked, len(pending), True)]
                pending.clear()
                return out

            for batch in batcher:
                pending.append(batch)
                if len(pending) == K:
                    yield from emit()
            e = emit()
            if e:
                yield from e

        device_losses = []

        def synced_loss():
            nonlocal loss_sum, device_losses
            for part in device_losses:
                loss_sum += float(part.sum())
            device_losses = []
            return loss_sum / max(n_batches, 1)

        rows_since_log = 0
        for stacked, count, is_scan in prefetch_iter(chunked(), depth=2):
            if is_scan:
                losses = self.scan_steps(self.state, stacked,
                                         self.dropout_gen)
            else:
                losses = self.train_step(self.state, stacked,
                                         self.dropout_gen)
            # losses stay on the device; the host syncs at log points and
            # at the end of the epoch
            device_losses.append(losses)
            n_batches += count
            rows_since_log += count
            if log_fn is not None and rows_since_log >= log_interval:
                log_fn({"train_loss": synced_loss(), "epoch": epoch_i,
                        "it": n_batches})
                rows_since_log = 0
        return synced_loss()

    def train_epoch_multihost(self, *args, **kwargs) -> float:
        raise _not_ported("train_epoch_multihost", "'Parallelism'")

    EVAL_CHUNK = 128  # batches per eval call (device-resident path)

    @staticmethod
    def _padded_index_batches(n: int, bs: int, chunk: int):
        """[nb, bs] row-index batches padded to a CHUNK-aligned batch count.
        Pad entries index row 0 with mask 0.  Returns (idx int32, mask f32,
        chunk_used)."""
        nb = -(-n // bs)
        ch = min(chunk, nb)
        nb = -(-nb // ch) * ch
        idx = np.zeros(nb * bs, dtype=np.int32)
        idx[:n] = np.arange(n, dtype=np.int32)
        mask = np.zeros(nb * bs, dtype=np.float32)
        mask[:n] = 1.0
        return idx.reshape(nb, bs), mask.reshape(nb, bs), ch

    @property
    def _use_streaming_eval(self) -> bool:
        return use_streaming_eval(self.cfg, self.mesh)

    def evaluate(self, X: np.ndarray, y: np.ndarray,
                 domain_cnt_weight: Optional[np.ndarray] = None) -> Dict:
        if X.shape[0] == 0:
            raise ValueError("evaluate: empty eval split")
        predicts = self.predict(X, _y_for_cache=y)
        targets = y.reshape(-1)
        result = {
            "total_auc": auc_score(targets, predicts),
            "total_loss": log_loss_score(targets, predicts),
        }
        if self.cfg.train.is_evaluate_multi_domain and domain_cnt_weight is not None:
            result.update(
                evaluate_multi_domain(
                    targets, predicts, X[:, self.domain_idx], domain_cnt_weight
                )
            )
        return result

    def predict(self, X: np.ndarray,
                _y_for_cache: Optional[np.ndarray] = None) -> np.ndarray:
        """Probabilities [N] for raw id rows (each row's tower selected by
        its domain's group) — the library-level scoring call.  For
        serving-grade scoring (table quantization, hash spec) use
        tpurec_torch.serve.Predictor."""
        if X.shape[0] == 0:
            return np.zeros(0, np.float32)
        zero_y_nbytes = X.shape[0] * 4
        resident = X.nbytes + zero_y_nbytes <= self.DEVICE_RESIDENT_BYTES
        if _y_for_cache is not None:
            y = _y_for_cache
        elif resident:
            # reuse ONE zero-label array per X so the device-dataset cache
            # key (id(X), shape, id(y)) repeats across predict(X) calls.
            # Values hold a reference to X: id() keys are only valid while
            # the keyed object is alive.
            zc = getattr(self, "_zero_y_cache", None)
            if zc is None:
                zc = self._zero_y_cache = {}
            key = (id(X), X.shape[0])
            ent = zc.get(key)
            if ent is None or ent[0] is not X:
                while len(zc) >= 4:
                    zc.pop(next(iter(zc)))
                ent = zc[key] = (X, np.zeros(X.shape[0], np.float32))
            y = ent[1]
        else:
            y = np.zeros(X.shape[0], np.float32)
        bs = self.cfg.train.bs
        if resident:
            # gather batches by index on the device, EVAL_CHUNK batches a
            # call; one copy to the host at the end
            Xdev, _, d2g = self._device_dataset(X, y)
            n = X.shape[0]
            idx, _, ch = self._padded_index_batches(n, bs, self.EVAL_CHUNK)
            idx_dev = torch.as_tensor(idx, device=self.device)
            preds = [self.eval_scan(self.model, Xdev, d2g,
                                    idx_dev[b0:b0 + ch])
                     for b0 in range(0, idx.shape[0], ch)]
            return torch.cat(preds).reshape(-1)[:n].cpu().numpy()
        batcher = ArrayBatcher(X, y, bs, group=self._group_of(X),
                               shuffle=False)
        preds = []
        for batch in batcher:
            p = self.eval_step(self.model, self._to_device(batch))
            preds.append((p, batch["mask"]))  # copied to the host below
        return np.concatenate(
            [p.cpu().numpy()[mask > 0] for p, mask in preds])

    def evaluate_streaming(self, X: np.ndarray, y: np.ndarray,
                           domain_cnt_weight: Optional[np.ndarray] = None,
                           n_bins: int = 8192) -> Dict:
        """Eval without hauling predictions to the host: per-(domain, bin)
        AUC histograms + per-domain loss sums accumulate on the device; the
        host copies 2x[n_domain, n_bins] + 2x[n_domain] per flush.

        AUC error is O(1/n_bins); LogLoss is exact up to float32
        accumulation.  Same result keys as :meth:`evaluate`.  A split over
        the device budget streams through fixed-size row windows."""
        bs = self.cfg.train.bs
        cache = getattr(self, "_stream_eval_cache", None)
        if cache is None:
            cache = self._stream_eval_cache = {}
        if n_bins not in cache:
            cache[n_bins] = make_streaming_eval_scan(
                self.model, self.multi_tower, self.domain_idx,
                self.n_domain, n_bins, self.cfg.train.compute_dtype)
        scan_hist, init_carry = cache[n_bins]

        n = X.shape[0]
        if n == 0:
            raise ValueError("evaluate_streaming: empty eval split")
        # float32 carries on the device flush into float64 host totals, so
        # counts stay exact at any eval-split size
        acc = HostHistAccumulator(init_carry)

        def run_window(Xdev, ydev, d2g, n_rows):
            idx, mask, ch = self._padded_index_batches(n_rows, bs,
                                                       self.EVAL_CHUNK)
            idx_dev = torch.as_tensor(idx, device=self.device)
            mask_dev = torch.as_tensor(mask, device=self.device)
            for b0 in range(0, idx.shape[0], ch):
                acc.update(scan_hist(
                    self.model, Xdev, ydev, d2g,
                    (idx_dev[b0:b0 + ch], mask_dev[b0:b0 + ch]),
                    *acc.carry))

        if X.nbytes + y.nbytes <= self.DEVICE_RESIDENT_BYTES:
            Xdev, ydev, d2g = self._device_dataset(X, y)
            run_window(Xdev, ydev, d2g, n)
        else:
            # the split exceeds the device budget: stream it through
            # fixed-size row windows (the tail window zero-padded and
            # masked out); the histogram carry accumulates across windows
            row_bytes = 4 * X.shape[1] + 4  # int32 ids + f32 label
            W = max(bs, (self.DEVICE_RESIDENT_BYTES // row_bytes) // bs * bs)
            d2g = torch.as_tensor(self.domain2group, device=self.device)
            yf = y.astype(np.float32).reshape(-1)
            for w0 in range(0, n, W):
                Xw = np.asarray(X[w0:w0 + W], dtype=np.int32)
                yw = yf[w0:w0 + W]
                nw = Xw.shape[0]
                if nw < W:
                    Xw = np.concatenate(
                        [Xw, np.zeros((W - nw, X.shape[1]), np.int32)])
                    yw = np.concatenate([yw, np.zeros(W - nw, np.float32)])
                run_window(torch.as_tensor(Xw, device=self.device),
                           torch.as_tensor(yw, device=self.device), d2g, nw)
        pos, neg, lsum, lcnt = acc.totals()
        return streaming_eval_result(
            pos.reshape(self.n_domain, n_bins),
            neg.reshape(self.n_domain, n_bins), lsum, lcnt,
            domain_cnt_weight
            if self.cfg.train.is_evaluate_multi_domain else None)

    def evaluate_streaming_multihost(self, *args, **kwargs) -> Dict:
        raise _not_ported("evaluate_streaming_multihost", "'Parallelism'")

    # ------------------------------------------------------------------
    def snapshot(self) -> bytes:
        """The state as flax msgpack bytes (the JAX package's TrainState
        layout)."""
        return msgpack_dumps(train_state_to_flax(self.state))

    def restore(self, blob: bytes):
        """Load a :meth:`snapshot` (or a JAX package TrainState's
        ``flax.serialization.to_bytes``) into the state, in place."""
        restore_train_state(self.state, msgpack_restore(blob))

    def save_checkpoint(self, path: str, extra: Optional[Dict] = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {
            "state": self.snapshot(),
            "best_result": self.stopper.best_result,
            "config_model": self.cfg.model.model,
            # self-describing checkpoint: full config + dataset schema, so
            # serving (predictor_from_checkpoint) needs nothing but this
            # file
            "config": config_to_dict(self.cfg),
            "field_dims": list(self.model.field_dims),
            "n_domain": int(self.n_domain),
            "domain_idx": int(self.domain_idx),
            "domain2group": [int(g) for g in self.domain2group],
            "extra": extra or {},
            "embed_layout": EMBED_LAYOUT_VERSION,
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    def load_checkpoint(self, path: str) -> Dict:
        """Load a ``save_checkpoint`` file of either package.

        TRUST BOUNDARY: the file is a pickle; load only checkpoints you
        wrote or trust."""
        with open(path, "rb") as f:
            payload = pickle.load(f)
        check_embed_layout_version(payload.get("embed_layout"), path)
        self.restore(payload["state"])
        return payload

    # -- backend-based (versioned) checkpoints -------------------------
    def make_checkpointer(self, directory: str, max_to_keep: int = 3):
        """Versioned checkpoint manager (tpurec_torch.train.checkpoint):
        backend chosen by TrainConfig.checkpoint_backend ('pickle'; 'orbax'
        is not ported)."""
        return make_backend(
            self.cfg.train.checkpoint_backend, directory, max_to_keep
        )

    def save_versioned(self, backend, step: int, extra: Optional[Dict] = None):
        meta = {
            "best_result": _jsonable(self.stopper.best_result),
            "config_model": self.cfg.model.model,
        }
        if extra:
            meta["extra"] = extra
        backend.save(step, self.state, meta)

    def load_versioned(self, backend, step: Optional[int] = None) -> Dict:
        state, meta = backend.restore(self.state, step)
        self.state = state
        return meta

    # ------------------------------------------------------------------
    def fit(self, train, valid, test=None, domain_cnt_weight=None, log_fn=None) -> Dict:
        """Epoch loop with early stop + best-state reload (run.py:746-764)."""
        Xtr, ytr = train
        Xva, yva = valid
        if domain_cnt_weight is None:
            cnt = np.bincount(Xtr[:, self.domain_idx], minlength=self.n_domain)
            domain_cnt_weight = cnt / cnt.sum()
        eval_fn = (self.evaluate_streaming if self._use_streaming_eval
                   else self.evaluate)
        for epoch_i in range(self.cfg.train.epoch):
            t0 = time.time()
            train_loss = self.train_epoch(Xtr, ytr, epoch_i, log_fn=log_fn)
            result = eval_fn(Xva, yva, domain_cnt_weight)
            result["epoch"] = epoch_i
            result["train_loss"] = train_loss
            result["epoch_seconds"] = time.time() - t0
            if log_fn is not None:
                log_fn(result)
            cont = self.stopper.is_continuable(result)
            if self.stopper.improved:
                self._best_bytes = self.snapshot()
            if not cont:
                break
        if self._best_bytes is not None:
            self.restore(self._best_bytes)
        out = {"valid": self.stopper.best_result}
        if test is not None:
            out["test"] = eval_fn(test[0], test[1], domain_cnt_weight)
        return out

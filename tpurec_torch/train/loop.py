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

On a (data, model) mesh (``mesh=``/``shardings=``, :mod:`tpurec_torch.
parallel`; one process a rank) the trainer computes the one-device
training on the global batch, as the JAX package's GSPMD mesh does:

- every rank builds the same initial state (one broadcast checksum
  checks it); the table and its moments are then cut to this rank's rows
  over the model axis, and with ``Shardings(expert_parallel=True)`` the
  expert banks and their moments to this rank's stacks
  (:meth:`tpurec_torch.parallel.mesh.Shardings.shard_model`); the
  dataset is replicated on every rank;
- both epochs give data rank ``d`` the ``d``-th slice of every global
  batch, from one shuffle seed on all ranks; the steps add the
  collectives of :mod:`tpurec_torch.train.hybrid`;
- dropout draws come from a generator seeded from the data coordinate
  (``seed + 1 + DROPOUT_SEED_STRIDE * d``), never from the rank, so the
  model replicas of one data block draw the same masks.  The masks are
  not the one-device run's (kernel 2's hash reads the local row), which
  the JAX package's are;
- eval defaults to the streaming histograms, summed over the data group;
  the exact eval gathers each data rank's predictions in global order;
- :meth:`Trainer.snapshot` and :meth:`Trainer.save_checkpoint` gather the
  shards and the split banks (rank 0 writes the file);
  :meth:`Trainer.load_checkpoint` reads the file on every rank, which
  keeps its rows and its stacks.

:meth:`Trainer.train_epoch_multihost` and
:meth:`Trainer.evaluate_streaming_multihost` feed each data rank only its
own dataset shard (``tpurec/train/loop.py:345-450, 631-720``).
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
from tpurec_torch.parallel.collectives import (all_gather, all_reduce_,
                                               broadcast_)
from tpurec_torch.parallel.feed import GlobalBatchFeed, epoch_plan
from tpurec_torch.parallel.mesh import Mesh, Shardings, barrier
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
                                     make_streaming_eval_batch_scan,
                                     make_streaming_eval_scan,
                                     make_train_step)

EMBEDDING_UPDATES = ("hybrid", "sparse", "dense")
# data rank d's dropout generator is seeded seed + 1 + this * d
DROPOUT_SEED_STRIDE = 7919


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


def use_streaming_eval(cfg, mesh) -> bool:
    """eval_streaming=None means auto: histogram (no-host-gather) eval
    whenever running on a mesh.  Single rule shared by the trainers."""
    es = cfg.train.eval_streaming
    return (mesh is not None) if es is None else bool(es)


def check_same_state(model, mesh, device) -> None:
    """Raise unless this rank's initial ``model`` equals rank 0's (one
    broadcast of a checksum over every parameter and buffer)."""
    c = torch.zeros(2, dtype=torch.float64, device=device)
    for t in model.state_dict().values():
        t = t.detach().to(torch.float64)
        c[0] += t.sum()
        c[1] += (t * t).sum()
    ref = broadcast_(c.clone(), 0)
    if not torch.equal(c, ref):
        raise RuntimeError(
            f"rank {mesh.rank}'s initial state differs from rank 0's "
            f"(checksums {c.tolist()} vs {ref.tolist()}): every rank must "
            "build the model from the same config and seed")


def gather_rows_global(local: torch.Tensor, mesh) -> torch.Tensor:
    """[nb, bs_local] per data rank -> [nb, bs] in global order."""
    if mesh is None or mesh.data_group is None:
        return local
    g = all_gather(local[None].contiguous(), mesh.data_group,
                   mesh.n_data, mesh.d)
    return g.permute(1, 0, 2).reshape(local.shape[0], -1)


def data_totals(totals, mesh, device):
    """Host float64 histogram totals summed over the data group (its
    ranks scored different rows; the model group's repeat them)."""
    if mesh is None or mesh.data_group is None:
        return totals
    sizes = [t.size for t in totals]
    flat = torch.as_tensor(np.concatenate(totals), device=device)
    flat = all_reduce_(flat, mesh.data_group).cpu().numpy()
    return tuple(np.split(flat, np.cumsum(sizes)[:-1]))


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
    :class:`tpurec_torch.train.step.TrainState`.  ``mesh``/``shardings``
    (:mod:`tpurec_torch.parallel`) train on a (data, model) mesh, on the
    mesh's device unless ``device`` says otherwise."""

    def __init__(self, cfg: Config, field_dims, n_domain: int, domain_idx: int,
                 domain2group=None, mesh=None, shardings=None, device=None):
        if shardings is not None and mesh is None:
            mesh = shardings.mesh
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a tpurec_torch.parallel.Mesh "
                            f"(make_mesh), got {type(mesh).__name__}")
        if mesh is not None and shardings is None:
            shardings = Shardings(mesh)
        if mesh is not None and device is None:
            device = mesh.device
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
        self.mesh = mesh
        self.shardings = shardings
        if mesh is not None:
            self.feed = GlobalBatchFeed(mesh, cfg.mesh.data_axis)
            check_same_state(self.model, mesh, self.device)
            shardings.shard_model(self.model)

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
        d = 0 if mesh is None else mesh.d
        self.dropout_gen = torch.Generator(device=self.device).manual_seed(
            tcfg.seed + 1 + DROPOUT_SEED_STRIDE * d)
        self.stopper = EarlyStopper(tcfg.early_stop)
        self._best_bytes: Optional[bytes] = None

    def _local_rows(self, bs: int) -> slice:
        """This data rank's columns of a global batch of ``bs`` rows."""
        if self.mesh is None:
            return slice(0, bs)
        bl = self.feed.local_rows_per_step(bs)
        return slice(self.mesh.d * bl, (self.mesh.d + 1) * bl)

    def _gather_rows_global(self, local: torch.Tensor) -> torch.Tensor:
        return gather_rows_global(local, self.mesh)

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
        cols = self._local_rows(bs)
        idx_dev = torch.as_tensor(
            idx.reshape(nb, bs)[:, cols].astype(np.int32), device=self.device)
        mask_dev = torch.as_tensor(mask.reshape(nb, bs)[:, cols],
                                   device=self.device)

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
        cols = self._local_rows(bs)
        batcher = ArrayBatcher(
            X, y, bs, group=self._group_of(X), shuffle=True,
            rng=np.random.default_rng(self.cfg.train.seed + epoch_i),
        )
        return self._host_epoch(
            ({k: v[cols] for k, v in b.items()} for b in batcher),
            epoch_i, log_fn)

    def _host_epoch(self, batches, epoch_i: int, log_fn) -> float:
        """The host-batching loop over ``batches`` (this rank's rows of
        each step): K stacked a call, the copy on a prefetch thread."""
        bs = self.cfg.train.bs
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

            for batch in batches:
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

    def train_epoch_multihost(self, X_local: np.ndarray, y_local: np.ndarray,
                              n_global_rows: int, epoch_i: int,
                              log_fn=None) -> float:
        """One epoch where each data rank feeds only ITS dataset shard
        (``tpurec/train/loop.py:345-450``): load ``X_local`` with
        ``GlobalBatchFeed(mesh).dataset_range(n_global_rows)``; the model
        replicas of a data block must load the same rows (checked).
        Every rank runs the same ``n_batches`` steps
        (:func:`~tpurec_torch.parallel.feed.epoch_plan`); a short local
        stream is padded with fully masked filler batches, and surplus
        rows wait for the next epoch's reshuffle.  The shuffle seed is
        ``seed + epoch + 7919 * d``: the JAX package's ``7919 *
        process_index``, where a process here is a rank and its model
        replicas must agree."""
        if self.mesh is None:
            raise ValueError("train_epoch_multihost requires a mesh")
        bs = self.cfg.train.bs
        feed = self.feed
        nb, bs_local = epoch_plan(n_global_rows, bs, feed)
        feed.check_replicas(X_local)
        batcher = ArrayBatcher(
            X_local, y_local, bs_local, group=self._group_of(X_local),
            shuffle=True, rng=np.random.default_rng(
                self.cfg.train.seed + epoch_i + 7919 * self.mesh.d),
        ) if len(X_local) else None
        return self._host_epoch(
            self._local_stream(batcher, nb, bs_local, X_local, None),
            epoch_i, log_fn)

    def _local_stream(self, batcher, nb: int, bs_local: int, X_local,
                      surplus: Optional[str]):
        """``nb`` local batches: the batcher's, then masked fillers.  A
        batch past ``nb`` is left for the next epoch, or, with
        ``surplus`` (its message), raises ValueError."""
        n_fields = (X_local.shape[1] if X_local.ndim == 2
                    else len(self.model.field_dims))
        filler = {
            "x": np.zeros((bs_local, n_fields), np.int32),
            "y": np.zeros(bs_local, np.float32),
            "mask": np.zeros(bs_local, np.float32),
            "group": np.zeros(bs_local, np.int32),
        }
        produced = 0
        if batcher is not None:
            for b in batcher:
                if produced == nb:
                    if surplus is not None:
                        raise ValueError(surplus)
                    break
                produced += 1
                yield b
        while produced < nb:
            produced += 1
            yield filler

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
            idx_dev = torch.as_tensor(idx[:, self._local_rows(bs)],
                                      device=self.device)
            preds = [self.eval_scan(self.model, Xdev, d2g,
                                    idx_dev[b0:b0 + ch])
                     for b0 in range(0, idx.shape[0], ch)]
            preds = self._gather_rows_global(torch.cat(preds))
            return preds.reshape(-1)[:n].cpu().numpy()
        batcher = ArrayBatcher(X, y, bs, group=self._group_of(X),
                               shuffle=False)
        cols = self._local_rows(bs)
        preds = torch.stack([
            self.eval_step(self.model, self._to_device(
                {k: v[cols] for k, v in batch.items()}))
            for batch in batcher])
        return self._gather_rows_global(preds).reshape(-1)[
            :X.shape[0]].cpu().numpy()

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

        cols = self._local_rows(bs)

        def run_window(Xdev, ydev, d2g, n_rows):
            idx, mask, ch = self._padded_index_batches(n_rows, bs,
                                                       self.EVAL_CHUNK)
            idx_dev = torch.as_tensor(idx[:, cols], device=self.device)
            mask_dev = torch.as_tensor(mask[:, cols], device=self.device)
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
        pos, neg, lsum, lcnt = self._data_totals(acc.totals())
        return streaming_eval_result(
            pos.reshape(self.n_domain, n_bins),
            neg.reshape(self.n_domain, n_bins), lsum, lcnt,
            domain_cnt_weight
            if self.cfg.train.is_evaluate_multi_domain else None)

    def _data_totals(self, totals):
        return data_totals(totals, self.mesh, self.device)

    def evaluate_streaming_multihost(self, X_local: np.ndarray,
                                     y_local: np.ndarray,
                                     n_global_rows: int,
                                     domain_cnt_weight: Optional[np.ndarray] = None,
                                     n_bins: int = 8192) -> Dict:
        """Streaming eval where each data rank feeds only ITS dataset shard
        (``tpurec/train/loop.py:631-720``, the same contract as
        :meth:`train_epoch_multihost`): the histograms are summed over the
        data group, so every rank returns the whole eval's result.  Rows
        past this rank's share raise ValueError (an eval has no next
        pass to take them)."""
        if self.mesh is None:
            raise ValueError("evaluate_streaming_multihost requires a mesh")
        bs = self.cfg.train.bs
        cache = getattr(self, "_stream_eval_mh_cache", None)
        if cache is None:
            cache = self._stream_eval_mh_cache = {}
        if n_bins not in cache:
            cache[n_bins] = make_streaming_eval_batch_scan(
                self.model, self.multi_tower, self.domain_idx,
                self.n_domain, n_bins, self.cfg.train.compute_dtype)
        hist_scan, init_carry = cache[n_bins]
        nb, bs_local = epoch_plan(n_global_rows, bs, self.feed)
        batcher = ArrayBatcher(
            X_local, y_local, bs_local, group=self._group_of(X_local),
            shuffle=False) if len(X_local) else None
        stream = self._local_stream(
            batcher, nb, bs_local, X_local,
            f"X_local has more rows than this rank's share of the "
            f"{n_global_rows}-row global eval ({nb} global batches x "
            f"{bs_local} local rows)")
        acc = HostHistAccumulator(init_carry)
        K = self.EVAL_CHUNK
        pending = []
        for i, batch in enumerate(stream):
            pending.append(batch)
            if len(pending) == K or i == nb - 1:
                stacked = self.feed.global_stacked_batch(
                    {k: np.stack([b[k] for b in pending])
                     for k in pending[0]}, bs)
                acc.update(hist_scan(self.model, *acc.carry, stacked))
                pending = []
        pos, neg, lsum, lcnt = self._data_totals(acc.totals())
        return streaming_eval_result(
            pos.reshape(self.n_domain, n_bins),
            neg.reshape(self.n_domain, n_bins), lsum, lcnt,
            domain_cnt_weight
            if self.cfg.train.is_evaluate_multi_domain else None)

    # ------------------------------------------------------------------
    def snapshot(self, local: bool = False) -> bytes:
        """The state as flax msgpack bytes (the JAX package's TrainState
        layout).  On a mesh the table and its moments are gathered (every
        rank must call), unless ``local``: this rank's rows, for its own
        :meth:`restore` (the best state of :meth:`fit`)."""
        return msgpack_dumps(train_state_to_flax(self.state, local=local))

    def restore(self, blob: bytes):
        """Load a :meth:`snapshot` (or a JAX package TrainState's
        ``flax.serialization.to_bytes``) into the state, in place; on a
        mesh this rank keeps its rows of the table."""
        restore_train_state(self.state, msgpack_restore(blob))

    def _is_writer(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def save_checkpoint(self, path: str, extra: Optional[Dict] = None):
        """The JAX package's pickle checkpoint; on a mesh the shards are
        gathered and rank 0 writes it (every rank must call; they leave
        together, once the file is complete)."""
        state = self.snapshot()
        if not self._is_writer():
            barrier(self.mesh.device)
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {
            "state": state,
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
        if self.mesh is not None:
            barrier(self.mesh.device)

    def load_checkpoint(self, path: str) -> Dict:
        """Load a ``save_checkpoint`` file of either package (on a mesh,
        every rank reads it and keeps its rows).

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
        backend chosen by TrainConfig.checkpoint_backend ('pickle', or
        'orbax': the port's asynchronous sharded backend)."""
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
        local = self.mesh is not None   # the best state: each rank's rows
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
                self._best_bytes = self.snapshot(local=local)
            if not cont:
                break
        if self._best_bytes is not None:
            self.restore(self._best_bytes)
        out = {"valid": self.stopper.best_result}
        if test is not None:
            out["test"] = eval_fn(test[0], test[1], domain_cnt_weight)
        return out

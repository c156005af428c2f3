"""CDC training engine of the port: counterfactual matrix population and
clustered training (counterpart of ``tpurec/cdc/engine.py``).

The device-heavy half of CDC (reference run.py:528-645), on the card:

- **Snapshot/rollback**: the reference deep-copies the base model's
  state_dict and restores it after each treatment burst (cdc.py:343-354);
  here :meth:`CDCTrainer.save_model_state` clones every parameter and
  BatchNorm buffer and :meth:`CDCTrainer.load_model_state` copies them
  back **in place**, so the table stays the tensor kernel 1's prepared
  gather serves and ``torch.optim.Adam`` keeps its state keyed to the same
  parameters.  The optimizers' moments, their step counts and
  ``TrainState.step`` are intentionally NOT rolled back, preserving the
  reference's asymmetry (save_model_state snapshots the base model only).
- **Fixed widths**: single-domain steps run on [bs] batches; multi-domain
  treatment steps on [group_chunk_size*bs] super-batches, padded and
  masked (run.py:519-526 concatenates up to 7 domain batches a step); the
  eval on all domains stacks one batch per domain into ONE [D*ebs]
  forward (the reference loops over the domains, run.py:550-558).
- **Warmup mode**: loss on the MEAN OF TOWER PROBABILITIES (cdc.py:99-102,
  sigmoid before averaging, :func:`tpurec_torch.train.step.bce_on_probs`);
  split mode: each row's tower selected by domain2group[domain]
  (cdc.py:103-111).
- **Where the time goes**: a step is the port's hybrid step
  (:meth:`tpurec_torch.train.hybrid.HybridTrainStep.one_step`: kernel 1's
  gather, the forward and backward through kernels 2 and 3, the dense
  Adam, and the table's update in kernel 7's pass carrying kernel 6's
  rows), its batch gathered on the card by row index.  The JAX package's
  scans are Python loops here: a gated step (valid 0) is skipped on the
  host, so it draws no dropout and advances no counter, as ``lax.cond``
  does.  Losses and matrix rows stay on the card; the host fetches them
  once a span and once a matrix update.  Schedules cross to the card once
  a block or span, never once a step.
- **Random draws**: every schedule draws from the same numpy generators
  in the same order as the JAX package (``train_batcher.rng``,
  ``np_rng``), so the two packages train on the same rows; dropout draws
  from one ``torch.Generator`` on the device seeded ``cfg.train.seed + 1``
  (the two packages cannot share dropout bits).

The JAX engine's XLA compile machinery (``_DaemonBuild``,
``_populate_exec``, ``_sync_populate_cache``, ``_collect_warm``,
``_populate_avals``, ``_data_avals``, ``_populate_shapes``) has no
counterpart: nothing compiles in eager PyTorch, and
:meth:`CDCTrainer.warm_compile` does nothing.

On a (data, model) mesh (``mesh``/``shardings``, :mod:`tpurec_torch.
parallel`; one process a rank) the engine computes the one-device CDC on
each step's whole schedule, as the JAX package's GSPMD mesh does
(``tpurec/cdc/engine.py:86-199``):

- every rank builds the same initial state (checked), then cuts the
  table to its rows and, with ``Shardings(expert_parallel=True)``, the
  expert banks to its stacks (:meth:`tpurec_torch.parallel.mesh.
  Shardings.shard_model`); every rank holds the whole split and draws
  every schedule from the same host generators;
- a step of ``W`` rows gives data rank ``d`` its rows ``[d W / n_data,
  (d + 1) W / n_data)`` (a ``bs`` that does not divide ``n_data``
  raises: every width is a multiple of it), and the hybrid step adds the mesh's collectives; the probe
  eval scores each data rank's slice of the ``D * ebs`` rows and gathers
  the logits over the data group, so every rank computes the same
  matrix rows and clustering (one broadcast checks the clustering);
- dropout draws from a generator seeded from the data coordinate
  (``seed + 1 + DROPOUT_SEED_STRIDE * d``), as the Trainer's;
- the split evals score each data rank's slice of every batch: the
  streaming eval (the default on a mesh) sums its histograms over the
  data group, the exact eval gathers the predictions in global order;
- snapshots for the rollback are each rank's own tensors; checkpoints
  gather the table and the banks, and rank 0 writes them.

**Row lanes** (``cdc.parallel_rows = N > 0``, ``populate_rows_parallel``,
``tpurec/cdc/engine.py:414-481``): the JAX package's documented divergence
from the serial rows (``tpurec/config.py:170-183``).  A block's rows run in
chunks of N lanes (:class:`RowLanes`); every lane of every chunk starts
from the update-entry state with its own copy of the parameters, the BN
buffers, the dense Adam state, the table, its moments and the step count,
runs its row's treatment burst over the valid steps only, step-major (step
s of every lane, then step s + 1), and scores its probe eval; the lanes'
losses are discarded and the trainer's state leaves the update unchanged.
A short last chunk leaves its spare lanes idle.  The lanes' tables and
moments are one lane-flat [N*V, D] allocation each, stepped once a step by
:meth:`tpurec_torch.train.hybrid.EmbeddingUpdater.update_stacked` over the
lanes whose step is valid.  Dropout: at each chunk's start one call draws N
int64 seeds from the trainer's ``dropout_gen`` (lane l takes the l-th)
and reseeds lane l's own generator, from which the lane's steps draw as a
serial step draws from ``dropout_gen`` (kernel 2's seed, then the MLP's
masks, forward by forward): a row does not depend on the other lanes.  On
a mesh each lane's step takes this data rank's columns and each lane's
table is its copy of this rank's shard, as in the serial path.

``compute_dtype="bfloat16"`` reaches every forward, as in the JAX
package's six scopes (``tpurec/cdc/engine.py:205,291,493,516,545,573``):
the training step's, the probe eval's (:meth:`CDCTrainer._eval_rows`)
and the eval scans'.

The base model (``mmoe``, ``ple``, ``pepnet``, ``epnet`` or ``star``)
trains without ``group``, as tpurec's engine calls it
(``tpurec/cdc/engine.py:203-220``); the group only selects each row's
tower.  STAR's partitioned and tower BatchNorms then take their training
statistics over the whole batch.  The eval forwards, which use running
statistics only, give the same logits with or without it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import pickle
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from tpurec_torch.cdc.algorithm import CDCClusterState, update_group
from tpurec_torch.config import Config, config_to_dict
from tpurec_torch.convert import restore_train_state, train_state_to_flax
from tpurec_torch.data.loader import DomainBatcher
from tpurec_torch.device import resolve_device
from tpurec_torch.metrics import (auc_score, evaluate_multi_domain,
                                  log_loss_score, streaming_eval_result)
from tpurec_torch.models import CDC_BASE_MODELS, build_model
from tpurec_torch.nn.precision import compute_dtype as _precision_scope
from tpurec_torch.ops.embedding import take_rows
from tpurec_torch.parallel.collectives import broadcast_
from tpurec_torch.parallel.embedding import table_shard
from tpurec_torch.parallel.mesh import Mesh, Shardings, barrier
from tpurec_torch.train.checkpoint import (EMBED_LAYOUT_VERSION,
                                           check_embed_layout_version,
                                           make_backend, msgpack_dumps,
                                           msgpack_restore)
from tpurec_torch.train.hybrid import (TABLE, HybridTrainStep,
                                       dense_named_parameters,
                                       init_train_state)
from tpurec_torch.train.loop import (DROPOUT_SEED_STRIDE, EarlyStopper,
                                     check_same_state, data_totals,
                                     gather_rows_global, use_streaming_eval)
from tpurec_torch.train.reg import reg_coef_tree
from tpurec_torch.train.sparse import SparseEmbedState
from tpurec_torch.train.step import (HostHistAccumulator, TrainState,
                                     bce_on_probs, make_indexed_eval_scan,
                                     make_optimizer,
                                     make_streaming_eval_scan, select_tower)


def _warmup_head(out, batch):
    """Warmup loss (cdc.py:99-102): BCE on the mean of the towers'
    probabilities."""
    return bce_on_probs(torch.sigmoid(out).mean(dim=1), batch["y"],
                        batch["mask"])


def probe_loss(vals, ys, masks):
    """[D, ebs] logits -> [D] masked mean BCE on probabilities clipped to
    [1e-7, 1 - 1e-7] (cdc.py:113-116)."""
    p = torch.clamp(torch.sigmoid(vals), 1e-7, 1 - 1e-7)
    losses = -(ys * torch.log(p) + (1 - ys) * torch.log1p(-p))
    return (losses * masks).sum(dim=1) / torch.clamp(masks.sum(dim=1),
                                                     min=1.0)


def probe_auc(vals, ys, masks):
    """[D, ebs] logits -> [D] exact tie-aware pairwise AUC (cdc.py:117-119):
    every (positive, negative) pair of a domain, a tie counting one half,
    over max(pos * neg, 1).  AUC is rank-based, so logits suffice."""
    pos = ys * masks
    neg = (1 - ys) * masks
    a, b = vals[:, :, None], vals[:, None, :]
    score = (a > b).to(vals.dtype) + 0.5 * (a == b).to(vals.dtype)
    wins = (pos[:, :, None] * neg[:, None, :] * score).sum(dim=(1, 2))
    return wins / torch.clamp(pos.sum(dim=1) * neg.sum(dim=1), min=1.0)


class RowLanes:
    """N lane copies of a :class:`CDCTrainer`'s state for CDC's row lanes
    (``cdc.parallel_rows = N``), built once for the trainer's life: N base
    models (each its own parameters, BN buffers, kernel 1 gather and
    hybrid step), N dense ``torch.optim.Adam``, and one lane-flat table
    and pair of moments [N*V, D] whose block l is lane l's table (its
    model's ``embedding.table`` is a view of it).  :meth:`start` copies
    the trainer's state into the first lanes in place; :meth:`step` takes
    one step of some lanes.  Tensors are matched by name
    (``state_dict`` keys; the table is ``embedding.table``).  The lanes
    hold their trainer by a weak reference: the trainer holds them, and a
    cycle would keep both, and their device memory, after the last
    reference to the trainer is gone, until the garbage collector ran."""

    def __init__(self, tr: "CDCTrainer", n: int):
        self.tr, self.n = weakref.proxy(tr), n
        entry = tr.model.get_parameter(TABLE)
        V, D = entry.shape
        self.V = V
        self.table = torch.empty((n * V, D), dtype=entry.dtype,
                                 device=entry.device)
        m = tr.state.emb_opt.m
        self.emb_opt = SparseEmbedState(
            m=torch.empty((n * V, D), dtype=m.dtype, device=m.device),
            v=torch.empty((n * V, D), dtype=m.dtype, device=m.device))
        tcfg = tr.cfg.train
        self.models, self.states, self.train_steps = [], [], []
        for l in range(n):
            model = tr._new_base(tr.model.field_dims)
            if tr.mesh is not None:
                with contextlib.redirect_stdout(io.StringIO()):
                    tr.shardings.shard_model(model)
            model.embedding.table = torch.nn.Parameter(
                self.table[l * V:(l + 1) * V])
            self.models.append(model)
            self.states.append(TrainState(
                model=model, optimizer=make_optimizer(
                    [p for _, p in dense_named_parameters(model)], tcfg),
                emb_opt=None))
            self.train_steps.append(HybridTrainStep(
                model, tcfg, tr.reg_coefs, multi_tower=True,
                l2_reg_embedding=tr.cfg.model.l2_reg_embedding,
                model_group=False))
        self.gens = [torch.Generator(device=tr.device) for _ in range(n)]

    @torch.no_grad()
    def start(self, k: int):
        """A chunk's start: lanes [0, k) take the trainer's state (copied
        in place) and a dropout seed each from its ``dropout_gen``."""
        tr = self.tr
        seeds = torch.randint(2**62, (self.n,), generator=tr.dropout_gen,
                              device=tr.device).tolist()
        entry = tr.model.state_dict()
        src_opt = tr.state.optimizer
        src = dict(dense_named_parameters(tr.model))
        V, D = self.V, self.table.shape[1]
        for flat, t in ((self.table, entry[TABLE]),
                        (self.emb_opt.m, tr.state.emb_opt.m),
                        (self.emb_opt.v, tr.state.emb_opt.v)):
            flat[:k * V].view(k, V, D).copy_(t.expand(k, V, D))
        for l in range(k):
            for name, t in self.models[l].state_dict().items():
                if name != TABLE:
                    t.copy_(entry[name])
            opt = self.states[l].optimizer
            for name, p in dense_named_parameters(self.models[l]):
                _copy_adam_state(opt.state[p], src_opt.state.get(src[name],
                                                                 {}))
            self.states[l].step = tr.state.step
            self.gens[l].manual_seed(seeds[l])

    def step(self, lanes: List[int], batches: List[Dict]):
        """One split-mode step of each lane of ``lanes`` (sorted) on its
        batch: each lane's forward, backward and dense Adam, then one
        :meth:`~tpurec_torch.train.hybrid.EmbeddingUpdater.update_stacked`
        of their tables.  The losses are discarded."""
        xs, gs = [], []
        for l, batch in zip(lanes, batches):
            ts = self.states[l]
            _, _, g_rows = self.train_steps[l].loss_and_grads(
                ts, batch, self.gens[l])
            ts.optimizer.step()
            xs.append(batch["x"])
            gs.append(g_rows)
        shard = table_shard(self.models[0])
        self.tr.emb_upd.update_stacked(
            self.table, self.emb_opt, torch.stack(xs), torch.stack(gs),
            [self.states[l].step + 1 for l in lanes], lanes=self.n,
            active=lanes, shard=shard)
        for l in lanes:
            self.states[l].step += 1


def _copy_adam_state(dst: Dict, src: Dict):
    """``torch.optim.Adam``'s per-parameter state ``src`` (tensors) into
    ``dst``, in place where ``dst`` already holds the same entries."""
    if dst.keys() != src.keys():
        dst.clear()
        dst.update({k: v.clone() for k, v in src.items()})
        return
    for k, v in src.items():
        dst[k].copy_(v)


class CDCTrainer:
    """CDC harness (reference Run.train_cdc/update_matrix_cdc + CDC module)
    on ``device``: the card unless the caller asks for the CPU.

    The base model's weights are drawn from a CPU generator seeded
    ``cfg.train.seed``; ``self.state`` is the port's hybrid
    :class:`tpurec_torch.train.step.TrainState`.  ``mesh``/``shardings``
    (:mod:`tpurec_torch.parallel`) train on a (data, model) mesh, on the
    mesh's device unless ``device`` says otherwise."""

    # dataset-placement budgets (CDCConfig.data_placement='auto'): a train
    # split up to this size lives on the card, a larger one streams; on a
    # mesh every rank holds the whole split, so the budget is smaller
    # (tpurec/cdc/engine.py:604-621)
    RESIDENT_BUDGET = 4 << 30
    MESH_RESIDENT_BUDGET = 256 << 20
    # split-mode steps per span of host scheduling (tpurec's scan length)
    _SPAN_SCAN = 256
    _HIST_BINS = 8192  # streaming-eval score bins (AUC error O(1/bins))

    def __init__(self, cfg: Config, field_dims, n_domain: int,
                 domain_idx: int, mesh=None, shardings=None, device=None):
        if shardings is not None and mesh is None:
            mesh = shardings.mesh
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a tpurec_torch.parallel.Mesh "
                            f"(make_mesh), got {type(mesh).__name__}")
        if mesh is not None and shardings is None:
            shardings = Shardings(mesh)
        if mesh is not None and device is None:
            device = mesh.device
        assert cfg.cdc.base_model in CDC_BASE_MODELS, cfg.cdc.base_model
        # burst steps ALWAYS use the hybrid embedding update: it is
        # bit-equivalent to the reference's dense Adam (so 'dense' changes
        # nothing) and the lazy 'sparse' variant would alter the
        # counterfactual matrices CDC clusters on
        if cfg.train.embedding_update == "sparse":
            raise ValueError(
                "CDCTrainer does not support embedding_update='sparse': "
                "lazy Adam changes the treatment-burst dynamics the "
                "affinity matrices are built from.  Use 'hybrid' (default; "
                "bit-equivalent to 'dense').")
        self.cfg = cfg
        self.n_domain = n_domain
        self.domain_idx = domain_idx
        self.mesh = mesh
        self.shardings = shardings
        self.n_cluster = cfg.cdc.n_cluster
        self.device = resolve_device(device)

        # base model with n_tower = n_cluster (run.py:43); CDC passes
        # expert_dims=mlp_dims and tower_dims=cdc_tower_dims into the base
        # (run.py:424-425); PLE keeps its own nested expert dims, as in
        # tpurec (the reference would feed it flat mlp_dims and crash)
        self._base_cfg = dataclasses.replace(
            cfg.model,
            mmoe_expert_dims=cfg.model.mlp_dims,
            mmoe_tower_dims=cfg.cdc.cdc_tower_dims,
            ple_tower_dims=cfg.cdc.cdc_tower_dims,
            tower_dims=cfg.cdc.cdc_tower_dims,
        )
        tcfg = cfg.train
        self.model = self._new_base(field_dims)
        if mesh is not None:
            # every width a step or a probe eval takes (bs, W =
            # group_chunk_size * bs, D * ebs) is a multiple of bs
            if tcfg.bs % mesh.n_data:
                raise ValueError(
                    f"bs = {tcfg.bs} does not split over the data axis of "
                    f"{mesh.n_data}: a step of W rows gives each data rank "
                    "W / n_data of them")
            check_same_state(self.model, mesh, self.device)
            shardings.shard_model(self.model)
        self.reg_coefs = reg_coef_tree(
            [n for n, _ in self.model.named_parameters()], cfg.cdc.base_model,
            cfg.model.l2_reg_embedding, cfg.model.l2_reg_linear,
            cfg.model.l2_reg_dnn)
        self.state = init_train_state(self.model, tcfg, self.device)
        # one step object: one table updater, one prepared gather
        self.train_step = HybridTrainStep(
            self.model, tcfg, self.reg_coefs, multi_tower=True,
            l2_reg_embedding=cfg.model.l2_reg_embedding, model_group=False)
        self.emb_upd = self.train_step.upd
        self.eval_scan = make_indexed_eval_scan(
            self.model, True, domain_idx, compute_dtype=tcfg.compute_dtype)
        d = 0 if mesh is None else mesh.d
        self.dropout_gen = torch.Generator(device=self.device).manual_seed(
            tcfg.seed + 1 + DROPOUT_SEED_STRIDE * d)
        self.np_rng = np.random.default_rng(tcfg.seed)
        self.stopper = EarlyStopper(tcfg.early_stop)
        self.cluster: Optional[CDCClusterState] = None
        self._best_bytes = None
        self._snapshot = None
        self._d2g = None
        self._lanes: Optional[RowLanes] = None

    def _new_base(self, field_dims) -> torch.nn.Module:
        """The base model, its weights drawn from a CPU generator seeded
        ``cfg.train.seed``, on the trainer's device."""
        return build_model(
            self.cfg.cdc.base_model, field_dims, self.n_cluster,
            self.domain_idx, self._base_cfg, device=self.device,
            generator=torch.Generator().manual_seed(self.cfg.train.seed))

    # ------------------------------------------------------------------
    # snapshot / rollback (cdc.py:343-354): params + model buffers, NOT opt
    def _model_tensors(self) -> Dict[str, torch.Tensor]:
        return {k: t.detach().clone()
                for k, t in self.model.state_dict().items()}

    @torch.no_grad()
    def _load_model_tensors(self, snap: Dict[str, torch.Tensor]):
        """Copy ``snap`` back into the model's own tensors."""
        for k, t in self.model.state_dict().items():
            t.copy_(snap[k])

    def save_model_state(self):
        self._snapshot = self._model_tensors()

    def load_model_state(self):
        self._load_model_tensors(self._snapshot)

    # ------------------------------------------------------------------
    def _decide_placement(self, nbytes: int) -> bool:
        """True = device-resident, False = host-stream windows."""
        mode = self.cfg.cdc.data_placement
        if mode == "resident":
            return True
        if mode == "stream":
            return False
        if mode != "auto":
            raise ValueError(f"unknown data_placement {mode!r}")
        budget = (self.MESH_RESIDENT_BUDGET if self.mesh is not None
                  else self.RESIDENT_BUDGET)
        return nbytes <= budget

    def setup_data(self, train, valid=None, test=None):
        Xtr, ytr = train
        bs, seed = self.cfg.train.bs, self.cfg.train.seed
        self.train_batcher = DomainBatcher(
            Xtr, ytr, self.domain_idx, self.n_domain, bs,
            rng=np.random.default_rng(seed + 10))
        self.domain_cnt_weight = self.train_batcher.domain_cnt_weight
        self.valid_batcher = (
            DomainBatcher(valid[0], valid[1], self.domain_idx, self.n_domain,
                          bs, rng=np.random.default_rng(seed + 11))
            if valid is not None else None)
        self.test_batcher = (
            DomainBatcher(test[0], test[1], self.domain_idx, self.n_domain,
                          bs, rng=np.random.default_rng(seed + 12))
            if test is not None else None)
        if self.cluster is None:
            self.cluster = CDCClusterState.create(
                self.n_domain, self.n_cluster, self.cfg.cdc)
        Xh = np.ascontiguousarray(Xtr, dtype=np.int32)
        yh = np.ascontiguousarray(ytr, dtype=np.float32).reshape(-1)
        self._resident = self._decide_placement(Xh.nbytes + yh.nbytes)
        if self._resident:
            # the training split on the card; steps gather rows by index
            self.Xhost = self.yhost = None
            self.Xdev, self.ydev = self._dev(Xh), self._dev(yh)
        else:
            # host-stream: the split never lives on the card; every block
            # or span gathers its scheduled rows into one window host-side
            # (_feed) and the indices are positions in it
            self.Xhost, self.yhost = Xh, yh
            self.Xdev = self.ydev = None

    def _dev(self, a) -> torch.Tensor:
        """Host array -> a tensor on the card (one copy)."""
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _feed(self, *idx_arrays):
        """(index schedules) -> (Xsrc, ysrc, *idx on the device).

        resident: the device-resident split and the indices unchanged.
        stream:   host-gathers the scheduled rows into ONE window
                  [sum(sizes), F] and re-points the indices at window
                  positions.
        """
        if self._resident:
            return (self.Xdev, self.ydev) + tuple(
                self._dev(np.asarray(a, np.int32)) for a in idx_arrays)
        flat = np.concatenate(
            [np.asarray(a, np.int64).ravel() for a in idx_arrays])
        Xw, yw = self._dev(self.Xhost[flat]), self._dev(self.yhost[flat])
        outs, off = [], 0
        for a in idx_arrays:
            outs.append(self._dev(
                np.arange(off, off + a.size, dtype=np.int32).reshape(a.shape)))
            off += a.size
        return (Xw, yw) + tuple(outs)

    @property
    def domain2group_dev(self) -> torch.Tensor:
        """The clustering's domain -> group table on the device, copied
        again only when the clustering changes."""
        d2g = np.asarray(self.cluster.domain2group, np.int32)
        if self._d2g is None or not np.array_equal(self._d2g[0], d2g):
            self._d2g = (d2g, self._dev(d2g))
        return self._d2g[1]

    # ------------------------------------------------------------------
    def _cols(self, width: int) -> slice:
        """This data rank's columns of a ``width``-row schedule (all of
        them without a mesh)."""
        if self.mesh is None:
            return slice(0, width)
        n = width // self.mesh.n_data
        return slice(self.mesh.d * n, (self.mesh.d + 1) * n)

    def _batch(self, Xsrc, ysrc, idx, mask, d2g):
        """One step's batch from its schedule row ``idx`` [W] and ``mask``
        [W] (device): on a mesh, this data rank's columns."""
        cols = self._cols(idx.shape[0])
        idx = idx[cols]
        x = Xsrc.index_select(0, idx)
        return {"x": x, "y": ysrc.index_select(0, idx),
                "group": take_rows(d2g, x[:, self.domain_idx]),
                "mask": mask[cols]}

    def _steps(self, mode: str, Xsrc, ysrc, idxs, masks, valids=None
               ) -> List[torch.Tensor]:
        """One hybrid step per row of ``idxs`` [K, W] (device) whose
        ``valids`` entry (host) is set -> the steps' losses, on the
        device.  ``mode`` is "warmup" or "split".  On a mesh each step
        takes this data rank's columns of its row."""
        head = _warmup_head if mode == "warmup" else None
        d2g = self.domain2group_dev
        losses = []
        for s in range(idxs.shape[0]):
            if valids is not None and not valids[s]:
                continue
            batch = self._batch(Xsrc, ysrc, idxs[s], masks[s], d2g)
            losses.append(self.train_step.one_step(
                self.state, batch, self.dropout_gen, head))
        return losses

    @torch.no_grad()
    def _eval_rows(self, Xsrc, ysrc, idx, mask, model=None) -> torch.Tensor:
        """[D, ebs] row indices (device) -> [D] probe metric from ONE
        eval forward of D*ebs rows of ``model`` (the trainer's unless
        given): the per-domain loss, or the exact pairwise AUC for
        use_metric='auc' (cdc.py:113-119; run.py:550-558 evaluates the
        domains one by one).  On a mesh each data rank scores its slice
        of the rows and the logits are gathered over the data group, so
        every rank computes the same [D] row."""
        model = self.model if model is None else model
        D, ebs = idx.shape
        flat = idx.reshape(-1)
        x = Xsrc.index_select(0, flat[self._cols(D * ebs)])
        ys = ysrc.index_select(0, flat).reshape(D, ebs)
        group = take_rows(self.domain2group_dev, x[:, self.domain_idx])
        model.eval()
        with _precision_scope(self.cfg.train.compute_dtype):
            out = model(x, group=group, train=False)
        vals = gather_rows_global(select_tower(out, group)[None],
                                  self.mesh).reshape(D, ebs)
        if self.cfg.cdc.use_metric == "auc":
            return probe_auc(vals, ys, mask)
        return probe_loss(vals, ys, mask)

    # ------------------------------------------------------------------
    def _next_idx_padded(self, d: int, width: int):
        """Next batch of domain d as (idx[width], mask[width])."""
        idx = self.train_batcher.next_idx(d)
        mask = np.zeros(width, np.float32)
        mask[: len(idx)] = 1.0
        out = np.zeros(width, np.int32)
        out[: len(idx)] = idx
        return out, mask

    def _multi_idx_padded(self, domains, width: int):
        """One batch from each domain concatenated (run.py:519-526),
        shuffled order, padded to ``width`` rows."""
        ds = list(domains)
        self.train_batcher.rng.shuffle(ds)
        idxs = [self.train_batcher.next_idx(d) for d in ds]
        flat = np.concatenate(idxs)[:width]
        out = np.zeros(width, np.int32)
        mask = np.zeros(width, np.float32)
        out[: len(flat)] = flat
        mask[: len(flat)] = 1.0
        return out, mask

    def _run_steps(self, mode: str, idxs, masks, valids=None
                   ) -> List[torch.Tensor]:
        """Schedules [K, W] (host) -> the steps' losses (device)."""
        Xsrc, ysrc, idxs_d = self._feed(idxs)
        return self._steps(mode, Xsrc, ysrc, idxs_d, self._dev(masks),
                           valids)

    def _train_burst(self, domains, k: int):
        """k repetitions over a domain (or domain set) with rollbackable
        weights (cdc_train_update_with_domain, run.py:529-548): an int
        domain trains k single-domain steps; a list trains on chunks of
        ``group_chunk_size`` domains concatenated per step."""
        bs = self.cfg.train.bs
        if isinstance(domains, (int, np.integer)):
            pairs = [self._next_idx_padded(int(domains), bs)
                     for _ in range(k)]
            self._run_steps("split", np.stack([p[0] for p in pairs]),
                            np.stack([p[1] for p in pairs]))
            return
        idxs, masks, valids = self._multi_burst_sched(
            domains, k, self._burst_k_max(k))
        self._run_steps("split", idxs, masks, valids)

    def _burst_k_max(self, k: int) -> int:
        """Schedule length covering the largest possible burst: n_domain
        domains repeated k times in chunks of group_chunk_size."""
        chunk = self.cfg.cdc.group_chunk_size
        return max(1, -(-(self.n_domain * max(k, 1)) // chunk))

    @property
    def _ebs(self) -> int:
        """Probe-eval width per domain: bs * cdc.probe_eval_batches
        (reference = one bs batch; widening cuts probe eval noise)."""
        return self.cfg.train.bs * max(1, self.cfg.cdc.probe_eval_batches)

    def _eval_sched(self):
        """Probe-eval schedule: (idx [D, ebs], mask [D, ebs]) — one
        train-stream batch per domain at reference defaults,
        probe_eval_batches consecutive batches concatenated otherwise."""
        bs, ebs = self.cfg.train.bs, self._ebs
        D = self.n_domain
        idx = np.zeros((D, ebs), np.int32)
        mask = np.zeros((D, ebs), np.float32)
        for d in range(D):
            flat = np.concatenate(
                [self.train_batcher.next_idx(d) for _ in range(ebs // bs)])
            idx[d, : len(flat)] = flat
            mask[d, : len(flat)] = 1.0
        return idx, mask

    def _multi_burst_sched(self, domains, k: int, K_max: int):
        """Index schedule of a multi-domain treatment burst: list repeated k
        times, chunks of group_chunk_size concatenated per step
        (run.py:529-548), padded to K_max gated steps."""
        bs = self.cfg.train.bs
        chunk = self.cfg.cdc.group_chunk_size
        W = chunk * bs
        idxs = np.zeros((K_max, W), np.int32)
        masks = np.zeros((K_max, W), np.float32)
        valids = np.zeros((K_max,), np.float32)
        if domains:
            tmp = list(domains) * k
            for s, i in enumerate(range(0, len(tmp), chunk)):
                if s >= K_max:
                    break
                idxs[s], masks[s] = self._multi_idx_padded(tmp[i: i + chunk],
                                                           W)
                valids[s] = 1.0
        return idxs, masks, valids

    def warm_compile(self, update_matrix_step: int):
        """Nothing to do: the JAX engine compiles its populate shapes here,
        and eager PyTorch compiles nothing.  Kept so that callers of
        either package run unchanged."""

    # ------------------------------------------------------------------
    def _run_populate_async(self, bidx, bmask, bvalid, eidx, emask
                            ) -> torch.Tensor:
        """All matrix rows of one block (``populate_rows``,
        ``tpurec/cdc/engine.py:313-357``) -> [R, D] rows, on the device.

        Per row r: the treatment burst (bidx[r] [K, W], its valid steps
        only), the metric on every domain (eidx[r] [D, ebs]), then the
        rollback of the parameters and BN buffers to the block's entry
        values, KEEPING the optimizers' moments and step counts.  With
        ``cdc.parallel_rows > 0`` the rows run in lanes instead
        (:meth:`_run_populate_lanes`, ``tpurec/cdc/engine.py:1028-1029``)."""
        if bidx.shape[0] == 0:
            return torch.zeros((0, self.n_domain), device=self.device)
        Xsrc, ysrc, bidx_d, eidx_d = self._feed(bidx, eidx)
        bmask_d, emask_d = self._dev(bmask), self._dev(emask)
        if self.cfg.cdc.parallel_rows > 0:
            return self._run_populate_lanes(Xsrc, ysrc, bidx_d, bmask_d,
                                            bvalid, eidx_d, emask_d)
        entry = self._model_tensors()
        rows = []
        for r in range(bidx.shape[0]):
            self._steps("split", Xsrc, ysrc, bidx_d[r], bmask_d[r],
                        bvalid[r])
            rows.append(self._eval_rows(Xsrc, ysrc, eidx_d[r], emask_d[r]))
            self._load_model_tensors(entry)
        return torch.stack(rows)

    def _run_populate_lanes(self, Xsrc, ysrc, bidx, bmask, bvalid, eidx,
                            emask) -> torch.Tensor:
        """A block's rows in chunks of ``cdc.parallel_rows`` lanes
        (``_run_populate_parallel``, ``tpurec/cdc/engine.py:1044-1078``)
        -> [R, D] rows, on the device; the trainer's state is not
        touched.  Schedules as :meth:`_run_populate_async`'s, on the
        device but ``bvalid`` [R, K] (host)."""
        n_lanes = self.cfg.cdc.parallel_rows
        if self._lanes is None or self._lanes.n != n_lanes:
            self._lanes = RowLanes(self, n_lanes)
        lanes = self._lanes
        d2g = self.domain2group_dev
        R, K = bvalid.shape
        rows = []
        for lo in range(0, R, lanes.n):
            n = min(lanes.n, R - lo)
            lanes.start(n)
            for s in range(K):
                on = [l for l in range(n) if bvalid[lo + l, s]]
                if on:
                    lanes.step(on, [self._batch(Xsrc, ysrc, bidx[lo + l, s],
                                                bmask[lo + l, s], d2g)
                                    for l in on])
            rows += [self._eval_rows(Xsrc, ysrc, eidx[lo + l], emask[lo + l],
                                     model=lanes.models[l])
                     for l in range(n)]
        return torch.stack(rows)

    def eval_all_domains(self, idx, mask) -> torch.Tensor:
        """The probe metric of the current state on every domain: (idx
        [D, ebs], mask [D, ebs]) host schedules -> [D], on the device
        (cdc_test_all_domain, run.py:550-558)."""
        Xsrc, ysrc, idx_d = self._feed(idx)
        return self._eval_rows(Xsrc, ysrc, idx_d, self._dev(mask))

    def update_matrix_cdc(self, update_matrix_step: int):
        """Populate matrix_mask/A/B (run.py:528-594) then re-cluster.

        Three populate blocks; each block's [R, D] rows stay on the card,
        and all are fetched at once after the last block."""
        st = self.cluster
        cfg = self.cfg.cdc
        k = update_matrix_step
        bs = self.cfg.train.bs
        D = self.n_domain
        K_max = self._burst_k_max(k)

        # ---- treatment (causal-mask) rows (run.py:563-569)
        R = cfg.n_causal_mask
        W = cfg.group_chunk_size * bs
        ebs = self._ebs
        bidx = np.zeros((R, K_max, W), np.int32)
        bmask = np.zeros((R, K_max, W), np.float32)
        bvalid = np.zeros((R, K_max), np.float32)
        eidx = np.zeros((R, D, ebs), np.int32)
        emask = np.zeros((R, D, ebs), np.float32)
        for r in range(R):
            size = int(self.np_rng.integers(5, max(D, 6)))
            treat = self.np_rng.choice(D, p=self.domain_cnt_weight, size=size)
            bidx[r], bmask[r], bvalid[r] = self._multi_burst_sched(
                list(treat), k, K_max)
            eidx[r], emask[r] = self._eval_sched()
        mask_rows = self._run_populate_async(bidx, bmask, bvalid, eidx, emask)

        # ---- matrix A: warm baseline (eval-only) + train-on-one rows
        # (run.py:571-577); single-domain bursts are k steps of [bs].  The
        # baseline sees the rolled-back parameters (the pre-update ones).
        ei, em = self._eval_sched()
        warm_row = self.eval_all_domains(ei, em)
        bidx = np.zeros((D, k, bs), np.int32)
        bmask = np.zeros((D, k, bs), np.float32)
        bvalid = np.ones((D, k), np.float32)
        eidx = np.zeros((D, D, ebs), np.int32)
        emask = np.zeros((D, D, ebs), np.float32)
        for d in range(D):
            for s in range(k):
                bidx[d, s], bmask[d, s] = self._next_idx_padded(d, bs)
            eidx[d], emask[d] = self._eval_sched()
        a_rows = self._run_populate_async(bidx, bmask, bvalid, eidx, emask)

        # ---- matrix B: leave-one-out rows + per-cluster rows
        # (run.py:579-592).  Cluster rows train on ALL domains of cluster c
        # (cdc.py:80's intent; run.py:587's domain2group_list[c] indexing
        # is a reference bug, not reproduced).  Before the first
        # clustering only row D (the one all-domain cluster) trains.
        d2g = st.domain2group_list
        R_B = D + self.n_cluster
        bidx = np.zeros((R_B, K_max, W), np.int32)
        bmask = np.zeros((R_B, K_max, W), np.float32)
        bvalid = np.zeros((R_B, K_max), np.float32)
        eidx = np.zeros((R_B, D, ebs), np.int32)
        emask = np.zeros((R_B, D, ebs), np.float32)
        for r in range(R_B):
            if r >= D:
                c = r - D
                if max(d2g) > 0:
                    train_domains = list(st.t_group2domain_list[c])
                else:
                    train_domains = list(range(D)) if c == 0 else []
            else:
                train_domains = [
                    d for d in st.s_group2domain_list[d2g[r]] if d != r]
            bidx[r], bmask[r], bvalid[r] = self._multi_burst_sched(
                train_domains, k, K_max)
            eidx[r], emask[r] = self._eval_sched()
        b_rows = self._run_populate_async(bidx, bmask, bvalid, eidx, emask)

        # one fetch once the whole update is queued
        rows = torch.cat([mask_rows, warm_row[None], a_rows, b_rows]
                         ).cpu().double().numpy()
        st.matrix_mask[:] = rows[:R]
        st.matrix_A[D] = rows[R]
        st.matrix_A[:D] = rows[R + 1: R + 1 + D]
        st.matrix_B[:] = rows[R + 1 + D:]

        update_group(st, cfg, self.domain_cnt_weight,
                     kmeans_seed=int(self.np_rng.integers(2**31)))
        self._check_clustering()
        if cfg.save_matrix_artifacts:
            self._dump_matrices()

    def _check_clustering(self):
        """On a mesh, raise unless every rank holds rank 0's domain2group
        (one broadcast): two ranks must never train different towers."""
        if self.mesh is None or not torch.distributed.is_initialized():
            return
        mine = torch.as_tensor(
            np.asarray(self.cluster.domain2group, np.int64),
            device=self.device)
        ref = broadcast_(mine.clone(), 0)
        if not torch.equal(mine, ref):
            raise RuntimeError(
                f"rank {self.mesh.rank}'s clustering {mine.tolist()} is not "
                f"rank 0's {ref.tolist()}: the ranks' matrix rows differ")

    def _dump_matrices(self, out_dir: Optional[str] = None):
        """Persist A/B/mask/causal matrices (cdc.py:395-426's dump): csv +
        .xlsx (dependency-free writer, to_excel(index=False) layout) +
        per-cell-annotated imshow PNG when matplotlib is installed."""
        from tpurec_torch.utils.xlsx import write_matrix_xlsx

        st = self.cluster
        out_dir = out_dir or os.path.join(self.cfg.train.save_path,
                                          "cdc_matrices")
        os.makedirs(out_dir, exist_ok=True)
        k = st.call_update_group
        for name, m in (
            ("matrix_A", st.matrix_A), ("matrix_B", st.matrix_B),
            ("matrix_mask", st.matrix_mask), ("causal_matrix", st.matrix_causal),
        ):
            np.savetxt(os.path.join(out_dir, f"{name}_step{k}.csv"), m,
                       delimiter=",")
            write_matrix_xlsx(os.path.join(out_dir, f"{name}_step{k}.xlsx"), m)
            try:
                import matplotlib

                matplotlib.use("Agg")
                import matplotlib.pyplot as plt

                # illustration trims A/B's extra baseline/group rows to the
                # domain block, like the reference (cdc.py:404-405)
                mm = m[: self.n_domain] if name in ("matrix_A", "matrix_B") else m
                vmax = max(abs(float(mm.min())), abs(float(mm.max())), 1e-12)
                fig, ax = plt.subplots(figsize=(10, 8))
                im = ax.imshow(mm, cmap="RdBu", interpolation="nearest",
                               vmin=-vmax, vmax=vmax)
                ax.set_title(f"{name} step-{k}")
                ax.set_xlabel("Domain Index")
                ax.set_ylabel("Treatment Index")
                # per-cell value annotations (cdc.py:421-423)
                for i in range(mm.shape[0]):
                    for j in range(mm.shape[1]):
                        ax.text(j, i, f"{mm[i, j]:.1e}", ha="center",
                                va="center", color="black", fontsize=4)
                fig.colorbar(im)
                fig.savefig(os.path.join(out_dir, f"{name}_step{k}.png"))
                plt.close(fig)
            except ImportError:
                pass

    # ------------------------------------------------------------------
    def _scaled_update_matrix_step(self) -> int:
        """The reference's batch-size normalization of the burst length
        (run.py:601-604): cfg values are calibrated for bs=1024."""
        ccfg = self.cfg.cdc
        if ccfg.update_matrix_step == 0:
            return 0
        return max(1, (ccfg.update_matrix_step * 1024) // self.cfg.train.bs)

    def _warmup_sched(self):
        """The warmup's (idxs, masks) [steps, bs]: each step one batch of
        a domain drawn by its share of the train split (run.py:609-627)."""
        tcfg, ccfg = self.cfg.train, self.cfg.cdc
        warmup_step = max(5, (ccfg.warmup_step * 1024) // tcfg.bs)
        pairs = []
        for _ in range(warmup_step):
            d = int(self.np_rng.choice(self.n_domain, p=self.domain_cnt_weight))
            pairs.append(self._next_idx_padded(d, tcfg.bs))
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))

    def train_cdc_epoch(self, epoch_i: int, log_fn=None) -> float:
        """One CDC epoch (run.py:596-645)."""
        tcfg, ccfg = self.cfg.train, self.cfg.cdc
        update_matrix_step = self._scaled_update_matrix_step()
        update_interval = (ccfg.update_interval * 1024) // tcfg.bs

        if epoch_i == 0:
            # the entire warmup as one run of steps
            self._run_steps("warmup", *self._warmup_sched())

        loss_sum, n_steps = 0.0, 0
        seq = self.train_batcher.epoch_seq()
        interval = max(update_interval, 1)

        def run_update():
            t0 = time.time()
            self.update_matrix_cdc(update_matrix_step)
            if log_fn:
                log_fn({
                    "cdc_update_seconds": time.time() - t0,
                    "domain2group": self.cluster.domain2group_list,
                })

        # reference semantics (run.py:630-645): before training step i, run
        # the matrix update iff (epoch 0 and i==0) or (i+1) % interval == 0.
        # cdc-plus freeze_after_updates: once the clustering has been
        # updated that many times, skip further updates (0 = reference
        # behavior, re-cluster at every boundary).
        def frozen():
            return (ccfg.freeze_after_updates > 0
                    and self.cluster.call_update_group
                    >= ccfg.freeze_after_updates)

        i = 0
        while i < len(seq):
            if (not frozen()) and (
                    (epoch_i == 0 and i == 0) or ((i + 1) % interval == 0)):
                run_update()
                loss_sum += self._train_span(seq, i, i + 1)
                n_steps += 1
                i += 1
                continue
            # frozen: no more boundaries will fire, run to epoch end
            next_boundary = (len(seq) if frozen()
                             else (i // interval + 1) * interval - 1)  # > i
            seg_end = min(len(seq), next_boundary)
            loss_sum += self._train_span(seq, i, seg_end)
            n_steps += seg_end - i
            i = seg_end
        return loss_sum / max(n_steps, 1)

    def _train_span(self, seq, lo: int, hi: int) -> float:
        """Train split-mode steps lo..hi-1 of the domain sequence, their
        schedules built _SPAN_SCAN steps at a time.  Loss sums stay on the
        device until the span ends: one fetch a span."""
        bs = self.cfg.train.bs
        chunk_losses = []
        j = lo
        while j < hi:
            span = min(self._SPAN_SCAN, hi - j)
            pairs = [self._next_idx_padded(int(seq[t]), bs)
                     for t in range(j, j + span)]
            losses = self._run_steps("split", np.stack([p[0] for p in pairs]),
                                     np.stack([p[1] for p in pairs]))
            chunk_losses.append(torch.stack(losses).sum())
            j += span
        return (float(torch.stack(chunk_losses).sum())
                if chunk_losses else 0.0)

    # ------------------------------------------------------------------
    def _padded_split(self, batcher: DomainBatcher):
        """Concatenated eval split, zero-padded to a chunk-aligned batch
        count (shared staging of evaluate / evaluate_streaming; padding
        rows are discarded or masked out; the chunk adapts down for small
        splits so padding waste stays <2x).  Returns (X, y, Xp, yp, mp, n,
        nb, CH)."""
        bs = self.cfg.train.bs
        X = np.concatenate(batcher.dom_X, axis=0)
        y = np.concatenate(batcher.dom_y, axis=0).astype(np.float32)
        n = len(y)
        nb = -(-n // bs)
        CH = min(128, nb)
        nb = -(-nb // CH) * CH
        Xp = np.zeros((nb * bs, X.shape[1]), X.dtype)
        Xp[:n] = X
        yp = np.zeros(nb * bs, np.float32)
        yp[:n] = y
        mp = np.zeros(nb * bs, np.float32)
        mp[:n] = 1.0
        return X, y, Xp, yp, mp, n, nb, CH

    @property
    def _use_streaming_eval(self) -> bool:
        return use_streaming_eval(self.cfg, self.mesh)

    def predict_split(self, batcher: DomainBatcher):
        """The split's rows in domain order -> (X, y, probabilities [n]):
        the padded split crosses to the card once, its [bs] batches run
        CH to a call, each row routed by domain2group; one fetch at the
        end.  On a mesh each data rank scores its columns of every batch
        and the predictions are gathered in global order."""
        bs = self.cfg.train.bs
        X, y, Xp, _, _, n, nb, CH = self._padded_split(batcher)
        Xd = self._dev(Xp.astype(np.int32))
        idx = torch.arange(nb * bs, dtype=torch.int32,
                           device=self.device).reshape(nb, bs)[
                               :, self._cols(bs)]
        d2g = self.domain2group_dev
        preds = [self.eval_scan(self.model, Xd, d2g, idx[b0:b0 + CH])
                 for b0 in range(0, nb, CH)]
        preds = gather_rows_global(torch.cat(preds), self.mesh)
        return X, y, preds.reshape(-1)[:n].cpu().numpy()

    def evaluate(self, batcher: DomainBatcher) -> Dict:
        """Split-mode eval (run.py:653-661): :meth:`predict_split`, then
        global and per-domain metrics on the host."""
        X, y, predicts = self.predict_split(batcher)
        result = {
            "total_auc": auc_score(y, predicts),
            "total_loss": log_loss_score(y, predicts),
        }
        result.update(evaluate_multi_domain(
            y, predicts, X[:, self.domain_idx], self.domain_cnt_weight))
        return result

    def evaluate_streaming(self, batcher: DomainBatcher) -> Dict:
        """Split-mode eval with NO host prediction gather: per-(domain, bin)
        AUC histograms + capped BCE sums accumulate on the card (see
        Trainer.evaluate_streaming); same result keys as :meth:`evaluate`,
        AUC within O(1/_HIST_BINS) of it.  On a mesh each data rank
        scores its columns of every batch and the histograms are summed
        over the data group."""
        bs = self.cfg.train.bs
        n_bins = self._HIST_BINS
        _, _, Xp, yp, mp, n, nb, CH = self._padded_split(batcher)
        scan_hist, init = make_streaming_eval_scan(
            self.model, True, self.domain_idx, self.n_domain, n_bins,
            self.cfg.train.compute_dtype)
        acc = HostHistAccumulator(init)
        cols = self._cols(bs)
        Xd, yd = self._dev(Xp.astype(np.int32)), self._dev(yp)
        md = self._dev(mp.reshape(nb, bs)[:, cols])
        idx = torch.arange(nb * bs, dtype=torch.int32,
                           device=self.device).reshape(nb, bs)[:, cols]
        d2g = self.domain2group_dev
        for b0 in range(0, nb, CH):
            acc.update(scan_hist(self.model, Xd, yd, d2g,
                                 (idx[b0:b0 + CH], md[b0:b0 + CH]),
                                 *acc.carry))
        pos, neg, lsum, lcnt = data_totals(acc.totals(), self.mesh,
                                           self.device)
        return streaming_eval_result(
            pos.reshape(self.n_domain, n_bins),
            neg.reshape(self.n_domain, n_bins), lsum, lcnt,
            self.domain_cnt_weight)

    # ------------------------------------------------------------------
    def snapshot_bytes(self, local: bool = False) -> bytes:
        """The state as flax msgpack bytes (the JAX package's hybrid
        TrainState layout).  On a mesh the table and the split banks are
        gathered (every rank must call), unless ``local``: this rank's
        part, for its own :meth:`restore_bytes`."""
        return msgpack_dumps(train_state_to_flax(self.state, local=local))

    def restore_bytes(self, blob: bytes):
        """Load a :meth:`snapshot_bytes` (or a JAX package TrainState's
        ``flax.serialization.to_bytes``) into the state, in place; on a
        mesh this rank keeps its part."""
        restore_train_state(self.state, msgpack_restore(blob))

    def _cluster_payload(self) -> Dict:
        """Clustering state as a json-able dict — the cluster assignment is
        part of CDC's checkpoint semantics (run.py:455-457 saves
        domain2group_list and s_group2domain_list alongside the model)."""
        st = self.cluster
        return {
            "domain2group_list": list(st.domain2group_list),
            "s_group2domain_list": [list(g) for g in st.s_group2domain_list],
            "t_group2domain_list": [list(g) for g in st.t_group2domain_list],
            "initial_s_group2domain_list": (
                [list(g) for g in st.initial_s_group2domain_list]
                if st.initial_s_group2domain_list is not None else None),
            "call_update_group": st.call_update_group,
            "p_weight": st.p_weight,
            "matrices": {
                "A": st.matrix_A, "B": st.matrix_B,
                "mask": st.matrix_mask, "causal": st.matrix_causal,
            },
        }

    def _restore_cluster(self, payload: Dict):
        if self.cluster is None:
            self.cluster = CDCClusterState.create(
                self.n_domain, self.n_cluster, self.cfg.cdc)
        st = self.cluster
        st.domain2group = np.asarray(payload["domain2group_list"], np.int64)
        st.s_group2domain_list = [list(g) for g in payload["s_group2domain_list"]]
        st.t_group2domain_list = [list(g) for g in payload["t_group2domain_list"]]
        init = payload["initial_s_group2domain_list"]
        st.initial_s_group2domain_list = (
            [list(g) for g in init] if init is not None else None)
        st.call_update_group = int(payload["call_update_group"])
        st.p_weight = float(payload["p_weight"])
        m = payload["matrices"]
        # a JSON round trip gives nested lists; pickle, ndarrays
        st.matrix_A = np.asarray(m["A"], np.float64)
        st.matrix_B = np.asarray(m["B"], np.float64)
        st.matrix_mask = np.asarray(m["mask"], np.float64)
        st.matrix_causal = (np.asarray(m["causal"], np.float64)
                            if m["causal"] is not None else None)

    def save_checkpoint(self, path: str, extra: Optional[Dict] = None):
        """Persist train state + the clustering state (single-file pickle,
        the JAX package's payload; for versioned checkpoints see
        :meth:`make_checkpointer`).  On a mesh the state is gathered and
        rank 0 writes the file (every rank must call; they leave
        together)."""
        state = self.snapshot_bytes()
        writer = self.mesh is None or self.mesh.rank == 0
        if writer:
            self._write_checkpoint(path, state, extra)
        if self.mesh is not None and torch.distributed.is_initialized():
            barrier(self.mesh.device)

    def _write_checkpoint(self, path: str, state: bytes,
                          extra: Optional[Dict]):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {
            "state": state,
            # self-describing (see Trainer.save_checkpoint): serving needs
            # nothing but this file
            "config": config_to_dict(self.cfg),
            "field_dims": list(self.model.field_dims),
            "n_domain": int(self.n_domain),
            "domain_idx": int(self.domain_idx),
            **self._cluster_payload(),
            "best_result": self.stopper.best_result,
            "extra": extra or {},
            "embed_layout": EMBED_LAYOUT_VERSION,
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    def load_checkpoint(self, path: str) -> Dict:
        """Load a ``save_checkpoint`` file of either package (on a mesh,
        every rank reads it and keeps its part).

        TRUST BOUNDARY: the file is a pickle; load only checkpoints you
        wrote or trust."""
        with open(path, "rb") as f:
            payload = pickle.load(f)
        check_embed_layout_version(payload.get("embed_layout"), path)
        self.restore_bytes(payload["state"])
        self._restore_cluster(payload)
        return payload

    # -- versioned checkpoints -------------------------------------------
    def make_checkpointer(self, directory: str, max_to_keep: int = 3):
        """Versioned checkpoint manager (tpurec_torch.train.checkpoint):
        backend chosen by TrainConfig.checkpoint_backend ('pickle', or
        'orbax': the port's asynchronous sharded backend).  The clustering
        rides in the step's ``extra``."""
        return make_backend(self.cfg.train.checkpoint_backend, directory,
                            max_to_keep)

    def save_versioned(self, backend, step: int, extra: Optional[Dict] = None):
        """Save train state + cluster state under ``step``."""
        meta = {"cluster": self._cluster_payload(),
                "best_result": self.stopper.best_result}
        if extra:
            meta["extra"] = extra
        backend.save(step, self.state, meta)

    def load_versioned(self, backend, step: Optional[int] = None) -> Dict:
        state, meta = backend.restore(self.state, step)
        self.state = state
        self._restore_cluster(meta["cluster"])
        return meta

    # ------------------------------------------------------------------
    def fit(self, train, valid, test=None, log_fn=None) -> Dict:
        self.setup_data(train, valid, test)
        self.warm_compile(self._scaled_update_matrix_step())
        eval_fn = (self.evaluate_streaming if self._use_streaming_eval
                   else self.evaluate)
        best_cluster = None
        for epoch_i in range(self.cfg.train.epoch):
            t0 = time.time()
            train_loss = self.train_cdc_epoch(epoch_i, log_fn=log_fn)
            result = eval_fn(self.valid_batcher)
            result.update(epoch=epoch_i, train_loss=train_loss,
                          epoch_seconds=time.time() - t0)
            if log_fn:
                log_fn(result)
            cont = self.stopper.is_continuable(result)
            if self.stopper.improved:
                # on a mesh: each rank's own part
                self._best_bytes = self.snapshot_bytes(
                    local=self.mesh is not None)
                # cluster assignment is part of checkpoint semantics
                # (run.py:455-457)
                best_cluster = (
                    list(self.cluster.domain2group_list),
                    [list(g) for g in self.cluster.s_group2domain_list],
                )
            if not cont:
                break
        if self._best_bytes is not None:
            self.restore_bytes(self._best_bytes)
            if best_cluster is not None:
                self.cluster.domain2group = np.asarray(best_cluster[0],
                                                       np.int64)
                self.cluster.s_group2domain_list = best_cluster[1]
        out = {"valid": self.stopper.best_result,
               "domain2group_list": self.cluster.domain2group_list,
               "s_group2domain_list": self.cluster.s_group2domain_list}
        if test is not None:
            out["test"] = eval_fn(self.test_batcher)
        return out

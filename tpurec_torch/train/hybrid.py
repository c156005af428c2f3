"""The hybrid training step: exact dense-Adam semantics for the embedding
table (counterpart of ``tpurec/train/hybrid.py``).

Per step (``hybrid.py:405-431``):

1. the batch's table rows are gathered outside autograd (kernel 1,
   prepared once for the table: :func:`tpurec_torch.nn.core.
   prepared_gather`);
2. the model runs its training forward on those rows (attention through
   kernels 2 and 3), and the loss (masked BCE + L2 of the dense weights)
   is differentiated with respect to the rows and the dense parameters;
3. the dense parameters take one ``torch.optim.Adam`` step;
4. the table takes one exact dense-Adam step, in place
   (:class:`EmbeddingUpdater`, through
   :func:`tpurec_torch.ops.fused_adam.fused_sparse_adam`): one pass over
   the table (kernel 7's sweep, ``u = coef * p`` plus the small-field
   prefix gradient) that carries the big-field rows (kernel 6): a touched
   row takes ``u = coef * p + g_row`` in place of the sweep's, the value
   tpurec's update sets over the swept row (``hybrid.py:117-129``);
5. the reported loss is ``loss + l2_emb * sum(table**2)`` (``:431``).

``coef = 2 * l2_emb + wd``: the reference's dense embedding L2 and Adam
weight decay reach every row every step.  The small fields' gradients
are dense over the table's prefix [0, S) (``EmbeddingLayout`` puts them
first): they are summed per row in one sorted segment sum.  The big
fields' touched rows are sorted stably, and the pass sums each row's
gradients in that order (batch order).

On a mesh (:mod:`tpurec_torch.parallel`: the model's table is one shard
of its rows, ``embedding.shard``) the batch is this data rank's slice of
the global batch, and a step adds collectives:

1. kernel 1 gathers the shard's window, and the model group sums the rows;
2. the forward's BatchNorm statistics and the loss's denominator are the
   global batch's (:func:`tpurec_torch.parallel.collectives.mesh_scope`);
3. the dense gradients and the loss are summed over the data group in one
   buffer, the dense L2 counted on data rank 0 only;
4. the ids and the rows' gradients are gathered over the data group in
   data-rank order, which is the global batch's: the sorts, and with them
   the summation orders, are the one-device step's; the ids are then
   localised to the shard (those outside touch nothing) and the
   small-field prefix is cut to the shard's rows;
5. ``sumsq`` is summed over the model group.

Under expert parallelism (:mod:`tpurec_torch.parallel.experts`) a split
bank's leaves hold this rank's stacks and their gradients are those
stacks' part: they are summed over the data group only, as every dense
gradient.  The whole leaves of a split bank (its BatchNorm ``scale``/
``bias``) take a partial gradient on each model rank, which is summed
over the model group as well.  Their L2 terms join the loss on model
rank 0 only, the stacks' on every model rank, and the returned loss adds
those terms summed over the model group: it is the one-device loss.

Ported: the single step, ``scan_k`` (a Python loop that returns the K
losses) and ``indexed=True`` (the device-resident dataset's loop:
:meth:`HybridTrainStep.scan_steps_idx`); the CDC engine drives
:meth:`HybridTrainStep.one_step` with a loss head of its own.
The training forward runs inside the ``tcfg.compute_dtype`` scope
(``hybrid.py:389``); its backward, outside the block, rounds at the casts
the forward recorded.  :meth:`EmbeddingUpdater.update_stacked` steps the
lane-flat tables of CDC's row lanes.  The step reads no
``embedding_update``: the JAX package's maker does not either, and its
CDC engine runs ``"dense"`` through it.

:class:`SparseTrainStep` is the ``"sparse"`` update
(``tpurec/train/sparse.py:85-223``): steps 1-3 as above, then, in place of
step 4, lazy Adam on the touched rows
(:class:`tpurec_torch.train.sparse.LazyAdamRows`); it returns the loss
before the table's L2 term, as the JAX step does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from tpurec_torch.config import TrainConfig
from tpurec_torch.device import resolve_device
from tpurec_torch.nn.core import EmbeddingLayout, prepared_gather
from tpurec_torch.nn.precision import check_compute_dtype
from tpurec_torch.nn.precision import compute_dtype as _precision_scope
from tpurec_torch.ops.embedding import take_rows
from tpurec_torch.ops.fused_adam import fused_sparse_adam
from tpurec_torch.parallel.collectives import (all_reduce_, all_reduce_grads,
                                               mesh_scope)
from tpurec_torch.parallel.embedding import (sharded_embedding_lookup,
                                             table_shard)
from tpurec_torch.parallel.experts import expert_leaves, model_split_l2
from tpurec_torch.train.reg import regularization_loss
from tpurec_torch.train.sparse import (LazyAdamRows, SparseEmbedState,
                                       init_sparse_opt_state, moments_dtype)
from tpurec_torch.train.step import (TrainState, bce_with_logits,
                                     make_optimizer, select_tower)



BIG_VOCAB_THRESHOLD = 8192
TABLE = "embedding.table"


class EmbeddingUpdater:
    """One exact dense-Adam step of the table from the gathered rows'
    gradients (``hybrid.py:58-263``).

    ``big_vocab_threshold`` can only demote a layout-small field to the
    row path (its prefix segment of the gradient is then zero); any split
    is exact.
    """

    def __init__(self, field_dims, tcfg: TrainConfig, l2_reg_embedding: float,
                 big_vocab_threshold: int = BIG_VOCAB_THRESHOLD):
        self.moments_dtype = moments_dtype(tcfg.embedding_moments_dtype)
        self.field_dims = tuple(int(d) for d in field_dims)
        self.layout = EmbeddingLayout(self.field_dims)
        self.vocab = self.layout.vocab
        self.small = [f for f in self.layout.small_fields
                      if self.field_dims[f] <= big_vocab_threshold]
        small_set = set(self.small)
        self.big = [f for f in range(len(self.field_dims))
                    if f not in small_set]
        # the prefix [0, S) ends with the last field kept on the small path
        n_keep = 0
        for i, f in enumerate(self.layout.small_fields):
            if f in small_set:
                n_keep = i + 1
        self.S = sum(self.field_dims[f]
                     for f in self.layout.small_fields[:n_keep])
        self.tcfg = tcfg
        self.l2_reg_embedding = l2_reg_embedding
        self.coef = 2.0 * l2_reg_embedding + tcfg.wd
        self._index: Dict[str, tuple] = {}

    def _arrays(self, device):
        """(small fields, their offsets, their vocab sizes, big fields,
        their offsets) as tensors on ``device`` (cached)."""
        key = str(device)
        if key not in self._index:
            off = self.layout.offsets

            def t(vals):
                return torch.tensor(vals, dtype=torch.int64, device=device)
            self._index[key] = (
                t(self.small), t([int(off[f]) for f in self.small]),
                t([self.field_dims[f] for f in self.small]),
                t(self.big), t([int(off[f]) for f in self.big]))
        return self._index[key]

    def gather_rows(self, table: torch.Tensor, x: torch.Tensor,
                    shard=None) -> torch.Tensor:
        """x [B, F] -> the batch's table rows [B*F, D] (kernel 1; with a
        ``shard``, its window, summed over the model group)."""
        return sharded_embedding_lookup(
            prepared_gather(self, table, self.layout,
                            None if shard is None else shard.window),
            x, shard).reshape(-1, table.shape[1])

    def small_field_grads(self, x, g_rows) -> Optional[torch.Tensor]:
        """[S, D] gradient of the small-field prefix (None when S = 0):
        each row's gradients summed in batch order.  Ids outside their
        field's vocabulary contribute nothing, as in the one-hot product
        of ``hybrid.py:144-167``."""
        if not self.S:
            return None
        fields, offs, dims, _, _ = self._arrays(x.device)
        D = g_rows.shape[-1]
        xs = x.index_select(1, fields).to(torch.int64)            # [B, n]
        ok = (xs >= 0) & (xs < dims)
        ids = torch.where(ok, xs + offs, self.S).reshape(-1)      # S: drop
        g = g_rows.index_select(1, fields).reshape(-1, D)
        sid, order = torch.sort(ids, stable=True)
        lengths = torch.zeros(self.S + 1, dtype=torch.int64,
                              device=x.device).scatter_add_(
            0, sid, torch.ones_like(sid))
        return torch.segment_reduce(g.index_select(0, order), "sum",
                                    lengths=lengths, axis=0,
                                    unsafe=True)[:self.S]

    def big_rows(self, x, g_rows):
        """(ids [B*n], g [B*n, D]) of the big-field rows, in batch order
        with duplicates (empty when no field is big)."""
        _, _, _, fields, offs = self._arrays(x.device)
        D = g_rows.shape[-1]
        ids = (x.index_select(1, fields).to(torch.int64) + offs).reshape(-1)
        return ids, g_rows.index_select(1, fields).reshape(-1, D)

    @torch.no_grad()
    def update(self, table: torch.Tensor, emb_opt: SparseEmbedState,
               x: torch.Tensor, g_rows: torch.Tensor, step: int,
               shard=None) -> torch.Tensor:
        """One exact dense-Adam step of ``table`` and ``emb_opt``, in place,
        given the batch's ids ``x`` [B, F] and its rows' gradients
        ``g_rows`` [B*F, D]; ``step`` is Adam's 1-based count.  -> sumsq =
        sum(table**2) before the step.  With a ``shard``, ``table`` and
        ``emb_opt`` are its rows and ``x``/``g_rows`` this data rank's:
        they are gathered over the data group first, and sumsq is the
        whole table's."""
        tcfg = self.tcfg
        B, F = x.shape
        g_rows = g_rows.reshape(B, F, -1).to(torch.float32)
        if shard is not None:
            x, g_rows = shard.exchange(x, g_rows)
        ids, g = self.big_rows(x, g_rows)
        g_small = self.small_field_grads(x, g_rows)
        if shard is not None:
            ids = ids - shard.row_lo            # outside the shard: no row
            S = shard.small_rows(self.S)
            g_small = (g_small[shard.row_lo:shard.row_lo + S]
                       if S else None)
        _, _, _, sumsq = fused_sparse_adam(
            table, emb_opt.m, emb_opt.v, ids, g, step, lr=tcfg.lr,
            b1=tcfg.adam_b1, b2=tcfg.adam_b2, eps=tcfg.adam_eps,
            coef=self.coef, g_small=g_small)
        if shard is not None:
            all_reduce_(sumsq, shard.mesh.model_group)
        return sumsq

    @torch.no_grad()
    def update_stacked(self, table: torch.Tensor, emb_opt: SparseEmbedState,
                       x: torch.Tensor, g_rows: torch.Tensor, step, *,
                       lanes: int, active: Optional[Sequence[int]] = None,
                       shard=None) -> torch.Tensor:
        """``lanes`` independent lanes of :meth:`update` on lane-flat
        operands, in place (``hybrid.py:265-356``): ``table`` and
        ``emb_opt``'s moments are [N*V, D] and lane l owns rows
        [l*V, (l+1)*V); ``x`` is [n, B, F], ``g_rows`` [n, B*F, D] and
        ``step`` [n] (1-based), one entry for each lane of ``active``
        (sorted lane indices; all N lanes when None).  A lane not in
        ``active`` is left as it was: the JAX package computes its step
        and discards it.  -> sumsq [n], each lane's sum(table**2) before
        the step.

        Each lane's rows are one contiguous [V, D] view, and its step is
        :meth:`update` on that view (kernel 7's pass carrying kernel 6's
        rows, one launch a lane): per-lane bias corrections, the small-
        field prefix [l*V, l*V + S), big-field duplicates summed in batch
        order, and ids outside [0, V) touching nothing, never the next
        lane's block.  The views keep the sweep's 16-byte alignment only
        when V*D is a multiple of 8.  With a ``shard`` each lane's view
        is its block of the shard's rows, ``x``/``g_rows`` are this data
        rank's, exchanged lane by lane, and each sumsq is the whole
        lane's table's."""
        NV, D = table.shape
        V = NV // lanes
        if lanes < 1 or V * lanes != NV:
            raise ValueError(f"a lane-flat table of {NV} rows does not "
                             f"split into {lanes} lanes")
        if (V * D) % 8:
            raise ValueError(f"each lane's [{V}, {D}] block must start "
                             f"16-byte aligned for the sweep: V*D = {V * D} "
                             f"is not a multiple of 8")
        ids = list(range(lanes)) if active is None else [int(l) for l in
                                                         active]
        if ids != sorted(set(ids)) or not all(0 <= l < lanes for l in ids):
            raise ValueError(f"active must list distinct lanes of "
                             f"[0, {lanes}) in order, got {ids}")
        if not (x.shape[0] == g_rows.shape[0] == len(step) == len(ids)):
            raise ValueError(f"x, g_rows and step need one entry per "
                             f"active lane ({len(ids)}), got "
                             f"{x.shape[0]}, {g_rows.shape[0]}, {len(step)}")
        sumsq = []
        for i, l in enumerate(ids):
            rows = slice(l * V, (l + 1) * V)
            sumsq.append(self.update(
                table[rows], SparseEmbedState(m=emb_opt.m[rows],
                                              v=emb_opt.v[rows]),
                x[i], g_rows[i], int(step[i]), shard))
        return torch.stack(sumsq)


def dense_named_parameters(model: torch.nn.Module):
    """(name, parameter) of everything but the table, in registration
    order: what the dense optimizer steps."""
    return [(n, p) for n, p in model.named_parameters() if n != TABLE]


def init_train_state(model: torch.nn.Module, tcfg: TrainConfig,
                     device=None) -> TrainState:
    """Move ``model`` to ``device`` (the card unless the caller asks for
    the CPU) and give it a dense Adam and zero table moments: the state of
    the ``"hybrid"`` and ``"sparse"`` updates (the ``"dense"`` one's is
    :func:`tpurec_torch.train.step.init_dense_train_state`)."""
    dev = resolve_device(device)
    model.to(dev)
    table = model.get_parameter(TABLE)
    return TrainState(
        model=model,
        optimizer=make_optimizer(
            [p for _, p in dense_named_parameters(model)], tcfg),
        emb_opt=init_sparse_opt_state(table.detach(),
                                      tcfg.embedding_moments_dtype),
        step=0)


class HybridTrainStep:
    """``step(ts, batch, generator) -> loss`` (or, with ``scan_k``,
    ``step(ts, batches, generator) -> [K] losses`` over batches stacked on
    a leading K axis), updating ``ts`` in place.

    ``batch`` holds x [B, F] int, y [B] float, group [B] int and
    (optionally) mask [B] float; ``generator`` is a torch.Generator on the
    model's device, the source of every dropout draw.

    ``model_group`` (default True, as tpurec's step) hands the batch's
    ``group`` to the model's forward; False calls the model without it
    while the loss still selects each row's tower by it, as tpurec's CDC
    engine calls its base (``tpurec/cdc/engine.py:203-220``): STAR then
    normalises every tower over the whole batch.
    """

    def __init__(self, model, tcfg: TrainConfig, reg_coefs,
                 multi_tower: bool, l2_reg_embedding: float,
                 scan_k: Optional[int] = None,
                 big_vocab_threshold: int = BIG_VOCAB_THRESHOLD,
                 model_group: bool = True):
        check_compute_dtype(tcfg.compute_dtype)
        self.tcfg = tcfg
        self.model_group = model_group
        self.reg_coefs_rest = {k: c for k, c in reg_coefs.items()
                               if k != TABLE}
        self.multi_tower = multi_tower
        self.l2_reg_embedding = l2_reg_embedding
        self.scan_k = scan_k
        self.upd = EmbeddingUpdater(model.field_dims, tcfg, l2_reg_embedding,
                                    big_vocab_threshold)

    def loss_and_grads(self, ts: TrainState, batch, generator, head=None):
        """The loss before the table's L2 term, with the dense parameters'
        gradients left in their ``.grad`` -> (loss, rows [B*F, D] gathered
        from the table, their gradient).  ``head(out, batch) -> loss``
        replaces the masked BCE of the group's tower logit (the CDC
        engine's warmup loss)."""
        model = ts.model
        table = model.get_parameter(TABLE)
        dev = table.device
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        x = batch["x"].to(torch.int32)
        shard = table_shard(model)
        mesh = None if shard is None else shard.mesh
        with torch.no_grad():
            rows = self.upd.gather_rows(table, x, shard)
        rows.requires_grad_(True)
        model.train()
        with mesh_scope(mesh):
            with _precision_scope(self.tcfg.compute_dtype):
                out = model(x, group=batch.get("group") if self.model_group
                            else None, train=True,
                            row_mask=batch.get("mask"), embed_rows=rows,
                            generator=generator)
            if head is not None:
                loss = head(out, batch)
            else:
                logit = (select_tower(out, batch["group"])
                         if self.multi_tower else out)
                loss = bce_with_logits(logit, batch["y"], batch.get("mask"))
        dense = dense_named_parameters(model)
        if mesh is None:
            loss = loss + regularization_loss(dense, self.reg_coefs_rest)
            ts.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            return loss.detach(), rows.detach(), rows.grad
        # the split expert banks' L2 terms are summed over the model
        # group, and so are the gradients of their whole leaves (both
        # empty without expert parallelism)
        split, partial = expert_leaves(model)
        whole, summed = model_split_l2(dense, split, partial, mesh.m)
        if mesh.d == 0:     # the L2 counted once
            reg_m = regularization_loss(summed, self.reg_coefs_rest).to(dev)
            loss = loss + regularization_loss(whole, self.reg_coefs_rest) \
                + reg_m
        else:
            reg_m = torch.zeros((), device=dev)
        ts.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss, reg_m = all_reduce_grads(
            [p for _, p in dense], mesh.data_group,
            loss.detach() - reg_m.detach(), reg_m.detach())
        if split or partial:
            reg_m, = all_reduce_grads([p for n, p in dense if n in partial],
                                      mesh.model_group, reg_m)
        return loss + reg_m, rows.detach(), rows.grad

    def one_step(self, ts: TrainState, batch, generator, head=None
                 ) -> torch.Tensor:
        loss, _, g_rows = self.loss_and_grads(ts, batch, generator, head)
        ts.optimizer.step()
        table = ts.model.get_parameter(TABLE).detach()
        sumsq = self.upd.update(table, ts.emb_opt, batch["x"].to(
            table.device), g_rows, ts.step + 1, table_shard(ts.model))
        ts.step += 1
        return loss + self.l2_reg_embedding * sumsq

    def __call__(self, ts: TrainState, batch, generator) -> torch.Tensor:
        if not self.scan_k:
            return self.one_step(ts, batch, generator)
        K = batch["x"].shape[0]
        return torch.stack([
            self.one_step(ts, {k: v[i] for k, v in batch.items()}, generator)
            for i in range(K)])

    def scan_steps_idx(self, ts: TrainState, Xdev, ydev, d2g, idxs, masks,
                       generator) -> torch.Tensor:
        """One step per row of ``idxs`` [k, bs] over a dataset on the
        device (``hybrid.py:433-456``): each step gathers ``x = Xdev[idx]``,
        ``y = ydev[idx]`` and ``group = d2g[x[:, domain_idx]]`` there, with
        ``masks`` [k, bs] marking the padding rows.  -> [k] losses, left on
        the device."""
        domain_idx = ts.model.domain_idx
        losses = []
        for idx, mask in zip(idxs, masks):
            x = Xdev.index_select(0, idx)
            batch = {"x": x, "y": ydev.index_select(0, idx),
                     "group": take_rows(d2g, x[:, domain_idx]),
                     "mask": mask}
            losses.append(self.one_step(ts, batch, generator))
        return torch.stack(losses)


def make_hybrid_train_step(model, tcfg: TrainConfig, reg_coefs,
                           multi_tower: bool, l2_reg_embedding: float,
                           scan_k: Optional[int] = None,
                           big_vocab_threshold: int = BIG_VOCAB_THRESHOLD,
                           indexed: bool = False):
    """The train step (or K-step loop when ``scan_k``) with the hybrid
    table update (``hybrid.py:359-469``), whatever ``embedding_update``
    says.  ``reg_coefs`` maps parameter names to L2 coefficients
    (:func:`tpurec_torch.train.reg.reg_coef_tree`); the table's entry is
    dropped, its L2 reaches the table through ``coef``.  ``indexed=True``
    returns the device-resident dataset's loop, ``scan_steps_idx(ts, Xdev,
    ydev, d2g, idxs, masks, generator) -> [k] losses``
    (:meth:`HybridTrainStep.scan_steps_idx`)."""
    step = HybridTrainStep(model, tcfg, reg_coefs, multi_tower,
                           l2_reg_embedding, scan_k, big_vocab_threshold)
    return step.scan_steps_idx if indexed else step


class SparseTrainStep(HybridTrainStep):
    """The ``"sparse"`` update's step (``tpurec/train/sparse.py:85-223``):
    the hybrid step's gather, forward and dense Adam, then lazy Adam on
    the touched table rows (:class:`LazyAdamRows`, ``dedup`` "scatter" or
    "sort", chosen by the table's size when None).  Returns the loss
    before the table's L2 term.  The state is :func:`init_train_state`'s
    (moments in ``embedding_moments_dtype``)."""

    def __init__(self, model, tcfg: TrainConfig, reg_coefs,
                 multi_tower: bool, l2_reg_embedding: float,
                 scan_k: Optional[int] = None, dedup: Optional[str] = None):
        super().__init__(model, tcfg, reg_coefs, multi_tower,
                         l2_reg_embedding, scan_k)
        self.rows_update = LazyAdamRows(model.field_dims, tcfg,
                                        l2_reg_embedding, dedup)

    def one_step(self, ts: TrainState, batch, generator, head=None
                 ) -> torch.Tensor:
        loss, rows, g_rows = self.loss_and_grads(ts, batch, generator, head)
        ts.optimizer.step()
        table = ts.model.get_parameter(TABLE).detach()
        self.rows_update.update(table, ts.emb_opt,
                                batch["x"].to(table.device), rows, g_rows,
                                ts.step + 1, table_shard(ts.model))
        ts.step += 1
        return loss


def make_sparse_train_step(model, tcfg: TrainConfig, reg_coefs,
                           multi_tower: bool, l2_reg_embedding: float,
                           scan_k: Optional[int] = None,
                           dedup: Optional[str] = None) -> SparseTrainStep:
    """The ``"sparse"`` update's step, or its K-step loop when ``scan_k``
    (``tpurec/train/sparse.py:85-223``): ``reg_coefs`` as
    :func:`make_hybrid_train_step`'s (the table's L2 reaches the touched
    rows through ``l2_reg_embedding``); ``dedup`` as
    :class:`LazyAdamRows`'s."""
    return SparseTrainStep(model, tcfg, reg_coefs, multi_tower,
                           l2_reg_embedding, scan_k, dedup)

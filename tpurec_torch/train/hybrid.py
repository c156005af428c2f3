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

Ported: the single step, ``scan_k`` (a Python loop that returns the K
losses) and ``indexed=True`` (the device-resident dataset's loop:
:meth:`HybridTrainStep.scan_steps_idx`).  ``update_stacked`` (CDC
lanes), ``embedding_update`` other than ``"hybrid"`` and
``compute_dtype="bfloat16"`` raise NotImplementedError; see ROADMAP.md.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from tpurec_torch.config import TrainConfig
from tpurec_torch.device import resolve_device
from tpurec_torch.nn.core import EmbeddingLayout, prepared_gather
from tpurec_torch.nn.precision import check_compute_dtype
from tpurec_torch.ops.embedding import take_rows
from tpurec_torch.ops.fused_adam import fused_sparse_adam
from tpurec_torch.train.reg import regularization_loss
from tpurec_torch.train.sparse import (SparseEmbedState,
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

    def gather_rows(self, table: torch.Tensor, x: torch.Tensor
                    ) -> torch.Tensor:
        """x [B, F] -> the batch's table rows [B*F, D] (kernel 1)."""
        return prepared_gather(self, table, self.layout)(
            x.to(torch.int32).contiguous()).reshape(-1, table.shape[1])

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
               x: torch.Tensor, g_rows: torch.Tensor, step: int
               ) -> torch.Tensor:
        """One exact dense-Adam step of ``table`` and ``emb_opt``, in place,
        given the batch's ids ``x`` [B, F] and its rows' gradients
        ``g_rows`` [B*F, D]; ``step`` is Adam's 1-based count.  -> sumsq =
        sum(table**2) before the step."""
        tcfg = self.tcfg
        B, F = x.shape
        g_rows = g_rows.reshape(B, F, -1).to(torch.float32)
        ids, g = self.big_rows(x, g_rows)
        _, _, _, sumsq = fused_sparse_adam(
            table, emb_opt.m, emb_opt.v, ids, g, step, lr=tcfg.lr,
            b1=tcfg.adam_b1, b2=tcfg.adam_b2, eps=tcfg.adam_eps,
            coef=self.coef, g_small=self.small_field_grads(x, g_rows))
        return sumsq

    def update_stacked(self, *args, **kwargs):
        raise NotImplementedError(
            "update_stacked (the CDC engine's lanes) is not ported yet: see "
            "ROADMAP.md, queue 1, 'CDC engine'")


def dense_named_parameters(model: torch.nn.Module):
    """(name, parameter) of everything but the table, in registration
    order: what the dense optimizer steps."""
    return [(n, p) for n, p in model.named_parameters() if n != TABLE]


def init_train_state(model: torch.nn.Module, tcfg: TrainConfig,
                     device=None) -> TrainState:
    """Move ``model`` to ``device`` (the card unless the caller asks for
    the CPU) and give it a dense Adam and zero table moments."""
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
    """

    def __init__(self, model, tcfg: TrainConfig, reg_coefs,
                 multi_tower: bool, l2_reg_embedding: float,
                 scan_k: Optional[int] = None,
                 big_vocab_threshold: int = BIG_VOCAB_THRESHOLD):
        self.tcfg = tcfg
        self.reg_coefs_rest = {k: c for k, c in reg_coefs.items()
                               if k != TABLE}
        self.multi_tower = multi_tower
        self.l2_reg_embedding = l2_reg_embedding
        self.scan_k = scan_k
        self.upd = EmbeddingUpdater(model.field_dims, tcfg, l2_reg_embedding,
                                    big_vocab_threshold)

    def loss_and_grads(self, ts: TrainState, batch, generator):
        """The loss before the table's L2 term, with the dense parameters'
        gradients left in their ``.grad`` -> (loss, rows [B*F, D] gathered
        from the table, their gradient)."""
        model = ts.model
        table = model.get_parameter(TABLE)
        dev = table.device
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        x = batch["x"].to(torch.int32)
        with torch.no_grad():
            rows = self.upd.gather_rows(table, x)
        rows.requires_grad_(True)
        model.train()
        out = model(x, group=batch.get("group"), train=True,
                    row_mask=batch.get("mask"), embed_rows=rows,
                    generator=generator)
        logit = select_tower(out, batch["group"]) if self.multi_tower else out
        loss = bce_with_logits(logit, batch["y"], batch.get("mask"))
        loss = loss + regularization_loss(dense_named_parameters(model),
                                          self.reg_coefs_rest)
        ts.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        return loss.detach(), rows.detach(), rows.grad

    def one_step(self, ts: TrainState, batch, generator) -> torch.Tensor:
        loss, _, g_rows = self.loss_and_grads(ts, batch, generator)
        ts.optimizer.step()
        table = ts.model.get_parameter(TABLE).detach()
        sumsq = self.upd.update(table, ts.emb_opt, batch["x"].to(
            table.device), g_rows, ts.step + 1)
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
    table update (``hybrid.py:359-469``).  ``reg_coefs`` maps parameter
    names to L2 coefficients (:func:`tpurec_torch.train.reg.reg_coef_tree`);
    the table's entry is dropped, its L2 reaches the table through
    ``coef``.  ``indexed=True`` returns the device-resident dataset's loop,
    ``scan_steps_idx(ts, Xdev, ydev, d2g, idxs, masks, generator) -> [k]
    losses`` (:meth:`HybridTrainStep.scan_steps_idx`)."""
    if tcfg.embedding_update != "hybrid":
        raise NotImplementedError(
            f"embedding_update={tcfg.embedding_update!r} is not ported: the "
            "port trains with 'hybrid' only; see ROADMAP.md")
    check_compute_dtype(tcfg.compute_dtype)
    step = HybridTrainStep(model, tcfg, reg_coefs, multi_tower,
                           l2_reg_embedding, scan_k, big_vocab_threshold)
    return step.scan_steps_idx if indexed else step

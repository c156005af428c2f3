"""Training-step helpers of the port (counterpart of ``tpurec/train/step.py``).

- :func:`select_tower` picks each row's tower logit;
- :func:`bce_with_logits` is the masked mean BCE of the JAX package, and
  :func:`bce_on_probs` the same on probabilities (CDC's warmup);
- :func:`make_optimizer` is the dense parameters' Adam
  (``add_decayed_weights(wd)`` -> ``scale_by_adam`` -> ``scale(-lr)``, which
  is ``torch.optim.Adam(weight_decay=wd)``: wd is added to the gradient
  before the moments, as the reference's run.py:720-723 does);
- :class:`TrainState` holds a model, its dense optimizer, the embedding
  table's Adam moments and the step count;
- :func:`make_train_step` is the ``"dense"`` embedding update's step
  (``step.py:73-175``): autograd through the lookup, one
  ``torch.optim.Adam`` over every parameter, the table included
  (:func:`init_dense_train_state`);
- the eval steps (``step.py:178-370``): :func:`make_eval_step`,
  :func:`make_indexed_eval_scan` (batches gathered by row index from a
  dataset on the device), the streaming-eval accumulators
  :func:`hist_init` / :func:`hist_update` / :class:`HostHistAccumulator`,
  and :func:`make_streaming_eval_scan` /
  :func:`make_streaming_eval_batch_scan`.

A callable these return takes the model first, where the JAX package's
takes ``params, model_state`` (the port's model holds both), then the JAX
package's other arguments in their order.  A "scan" is a Python loop over
the ``k`` batches that leaves every result on the device: nothing in it
waits for the card.  Every eval forward runs inside its
``compute_dtype`` scope (:mod:`tpurec_torch.nn.precision`), as the JAX
package's does (``step.py:189,311,341,360``).

The hybrid and ``"sparse"`` training steps are
:mod:`tpurec_torch.train.hybrid`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Iterable, Optional

import torch
import torch.nn.functional as Fn

from tpurec_torch.config import TrainConfig
from tpurec_torch.device import resolve_device
from tpurec_torch.metrics.metrics import BIN_P_MAX
from tpurec_torch.nn.precision import check_compute_dtype
from tpurec_torch.nn.precision import compute_dtype as _precision_scope
from tpurec_torch.ops.embedding import take_rows
from tpurec_torch.train.reg import regularization_loss
from tpurec_torch.train.sparse import SparseEmbedState

# the per-row log loss's cap, -log(1e-15), as metrics.log_loss_score clips
_LL_MAX = -math.log(1e-15)


def select_tower(logits: torch.Tensor, group: torch.Tensor) -> torch.Tensor:
    """[B, T] logits + [B] group -> [B] (run.py:484 ``pred.gather(1, group)``).

    Out-of-range groups follow ``jnp.take_along_axis``: a group in [-T, 0)
    wraps, any other gives NaN.
    """
    if logits.dim() == 1:
        return logits
    T = logits.shape[1]
    g = group.long()
    g = torch.where(g < 0, g + T, g)
    ok = (g >= 0) & (g < T)
    out = logits.gather(1, g.clamp(0, T - 1)[:, None])[:, 0]
    return torch.where(ok, out, torch.full((), float("nan"),
                                           dtype=out.dtype,
                                           device=out.device))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean BCE on logits; with ``weights`` the weighted sum over
    ``max(sum(weights), 1)`` (``tpurec/train/step.py:46-52``)."""
    losses = Fn.binary_cross_entropy_with_logits(
        logits, targets.to(logits.dtype), reduction="none")
    if weights is None:
        return losses.mean()
    w = weights.to(losses.dtype)
    return (losses * w).sum() / torch.clamp(w.sum(), min=1.0)


def bce_on_probs(probs: torch.Tensor, targets: torch.Tensor,
                 weights: Optional[torch.Tensor] = None,
                 eps: float = 1e-7) -> torch.Tensor:
    """BCE on probabilities clipped to [eps, 1 - eps]; with ``weights`` the
    weighted sum over ``max(sum(weights), 1)`` (``tpurec/train/step.py:
    55-64``: CDC's warmup loss on the mean of the towers' probabilities).
    The clip zeroes the gradient where a probability saturates."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    t = targets.to(p.dtype)
    losses = -(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))
    if weights is None:
        return losses.mean()
    w = weights.to(losses.dtype)
    return (losses * w).sum() / torch.clamp(w.sum(), min=1.0)


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   tcfg: TrainConfig) -> torch.optim.Adam:
    """Adam over the dense parameters, with the JAX package's settings."""
    return torch.optim.Adam(params, lr=tcfg.lr,
                            betas=(tcfg.adam_b1, tcfg.adam_b2),
                            eps=tcfg.adam_eps, weight_decay=tcfg.wd)


@dataclasses.dataclass
class TrainState:
    """What a training step reads and updates in place.

    ``model`` holds the table (``embedding.table``), the dense parameters
    and the BN buffers.  Under the ``"hybrid"`` and ``"sparse"`` updates
    ``optimizer`` steps every parameter but the table and ``emb_opt``
    holds the table's Adam moments; under ``"dense"`` ``optimizer`` steps
    the table too, with float32 moments, and ``emb_opt`` is None.
    ``step`` counts the steps taken (the next one is ``step + 1``, Adam's
    1-based count)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    emb_opt: Optional[SparseEmbedState]
    step: int = 0


def init_dense_train_state(model: torch.nn.Module, tcfg: TrainConfig,
                           device=None) -> TrainState:
    """The ``"dense"`` update's state: ``model`` on ``device`` (the card
    unless the caller asks for the CPU) and one Adam over every parameter.
    Its moments are float32 whatever ``embedding_moments_dtype`` says, as
    the JAX package's ``tx.init(params)`` (``tpurec/train/loop.py:
    133-134``)."""
    model.to(resolve_device(device))
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(), tcfg),
                      emb_opt=None, step=0)


class DenseTrainStep:
    """The ``"dense"`` embedding update's step (``tpurec/train/step.py:
    73-175``): ``step(ts, batch, generator) -> loss`` (with ``scan_k``,
    ``step(ts, batches, generator) -> [K] losses`` over batches stacked on
    a leading K axis), updating ``ts`` in place.

    The training forward looks the batch up in the table with autograd
    recording (kernel 1 on the card, its backward ``index_add_``:
    :func:`tpurec_torch.ops.embedding.embedding_lookup`); the loss is the
    masked BCE plus the L2 of every parameter in ``reg_coefs``, the
    table's included, and one ``torch.optim.Adam`` steps every parameter.
    The returned loss is that whole loss."""

    def __init__(self, model, tcfg: TrainConfig, reg_coefs,
                 multi_tower: bool, scan_k: Optional[int] = None):
        check_compute_dtype(tcfg.compute_dtype)
        self.tcfg = tcfg
        self.reg_coefs = dict(reg_coefs)
        self.multi_tower = multi_tower
        self.scan_k = scan_k

    def loss_and_grads(self, ts: TrainState, batch, generator
                       ) -> torch.Tensor:
        """The loss, with every parameter's gradient left in its
        ``.grad``."""
        model = ts.model
        dev = model.get_parameter("embedding.table").device
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        model.train()
        with _precision_scope(self.tcfg.compute_dtype):
            out = model(batch["x"], group=batch.get("group"), train=True,
                        row_mask=batch.get("mask"), generator=generator)
        logit = (select_tower(out, batch["group"]) if self.multi_tower
                 else out)
        loss = bce_with_logits(logit, batch["y"], batch.get("mask"))
        loss = loss + regularization_loss(model.named_parameters(),
                                          self.reg_coefs)
        ts.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        return loss.detach()

    def one_step(self, ts: TrainState, batch, generator) -> torch.Tensor:
        loss = self.loss_and_grads(ts, batch, generator)
        ts.optimizer.step()
        ts.step += 1
        return loss

    def __call__(self, ts: TrainState, batch, generator) -> torch.Tensor:
        if not self.scan_k:
            return self.one_step(ts, batch, generator)
        return torch.stack([
            self.one_step(ts, {k: v[i] for k, v in batch.items()}, generator)
            for i in range(batch["x"].shape[0])])


def make_train_step(model, tcfg: TrainConfig, reg_coefs, multi_tower: bool,
                    scan_k: Optional[int] = None) -> DenseTrainStep:
    """The ``"dense"`` update's step, or its K-step loop when ``scan_k``
    (``tpurec/train/step.py``'s ``make_train_step`` and
    ``make_scan_train_steps``).  ``reg_coefs`` maps parameter names to L2
    coefficients (:func:`tpurec_torch.train.reg.reg_coef_tree`), the
    table's included; the state is :func:`init_dense_train_state`'s."""
    return DenseTrainStep(model, tcfg, reg_coefs, multi_tower, scan_k)


def _eval_logit(model, x, group, multi_tower: bool,
                dtype: str = "float32") -> torch.Tensor:
    """The eval forward of ``model`` on ids ``x`` in compute dtype
    ``dtype`` -> each row's logit."""
    model.eval()
    with _precision_scope(dtype):
        out = model(x, group=group, train=False)
    return select_tower(out, group) if multi_tower else out


def _gather_batch(Xdev, d2g, idx, domain_idx: int):
    """Rows ``idx`` of the device dataset -> (x [bs, F], dom, group)."""
    x = Xdev.index_select(0, idx)
    dom = x[:, domain_idx]
    return x, dom, take_rows(d2g, dom)


def make_eval_step(model, multi_tower: bool, compute_dtype: str = "float32"):
    """``eval_step(model, batch) -> probabilities [B]`` (each row's group
    tower selected); ``batch`` holds x and group on the model's device."""
    check_compute_dtype(compute_dtype)

    @torch.no_grad()
    def eval_step(model, batch):
        return torch.sigmoid(_eval_logit(model, batch["x"],
                                         batch.get("group"), multi_tower,
                                         compute_dtype))

    return eval_step


def make_indexed_eval_scan(model, multi_tower: bool, domain_idx: int,
                           compute_dtype: str = "float32"):
    """Device-resident-dataset eval: ``eval_scan(model, Xdev, d2g, idxs)
    -> [K, bs]`` probabilities of the [K, bs] row-index batches, each
    gathered from ``Xdev`` on the device; the result stays there."""
    check_compute_dtype(compute_dtype)

    @torch.no_grad()
    def eval_scan(model, Xdev, d2g, idxs):
        ps = []
        for idx in idxs:
            x, _, group = _gather_batch(Xdev, d2g, idx, domain_idx)
            ps.append(torch.sigmoid(_eval_logit(model, x, group,
                                                multi_tower, compute_dtype)))
        return torch.stack(ps)

    return eval_scan


def hist_init(n_domain: int, n_bins: int, device=None):
    """Zeroed streaming-eval accumulators on ``device``: per-(domain, bin)
    pos/neg score histograms (flattened) + per-domain log-loss sums and row
    counts, all float32."""
    def z(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)
    return (z(n_domain * n_bins), z(n_domain * n_bins), z(n_domain),
            z(n_domain))


def hist_update(carry, dom, logit, y, mask, n_bins: int):
    """One masked batch into the streaming-eval accumulators, in place
    (``step.py:214-236``); returns the carry.

    - AUC histograms: predictions binned at int(clip(p, 0, 1-1e-7)*n_bins),
      in float32.
    - LogLoss in LOGIT space: y*softplus(-l) + (1-y)*softplus(l), with
      softplus(x) = logaddexp(x, 0) as JAX computes it (torch's softplus
      switches to x above its threshold), capped at -log(1e-15).

    Counts are added by ``index_add_``: their float32 sums are exact below
    2**24 per cell, which :class:`HostHistAccumulator`'s flushes bound.
    """
    pos, neg, lsum, lcnt = carry
    logit = logit.to(torch.float32)
    y = y.to(torch.float32)
    mask = mask.to(torch.float32)
    dom = dom.to(torch.int64)
    p = torch.sigmoid(logit)
    flat = dom * n_bins + (torch.clamp(p, min=0.0, max=BIN_P_MAX)
                           * n_bins).to(torch.int64)
    pos.index_add_(0, flat, mask * y)
    neg.index_add_(0, flat, mask * (1.0 - y))
    zero = torch.zeros((), dtype=logit.dtype, device=logit.device)
    ll = (y * torch.logaddexp(-logit, zero)
          + (1.0 - y) * torch.logaddexp(logit, zero))
    ll = torch.clamp(ll, max=_LL_MAX)
    lsum.index_add_(0, dom, mask * ll)
    lcnt.index_add_(0, dom, mask)
    return carry


class HostHistAccumulator:
    """Exact streaming-eval totals: float32 accumulators on the device,
    float64 totals on the host (``step.py:239-283``).

    After ``flush_every`` updates (default: 128 updates x <= 128 batches x
    bs rows, well under the 2**24 float32-exactness bound even if every
    row of a flush lands in ONE (domain, bin) cell) the carry is copied to
    the host, added into the float64 totals, and reset."""

    def __init__(self, init_fn, flush_every: int = 128):
        self._init = init_fn
        self._flush_every = flush_every
        self._since_flush = 0
        self._totals = None
        self.carry = self._init()

    def update(self, carry):
        self.carry = carry
        self._since_flush += 1
        if self._since_flush >= self._flush_every:
            self._flush()

    def _flush(self):
        parts = tuple(c.detach().to("cpu", torch.float64).numpy()
                      for c in self.carry)
        if self._totals is None:
            self._totals = list(parts)
        else:
            for t, p in zip(self._totals, parts):
                t += p
        self.carry = self._init()
        self._since_flush = 0

    def totals(self):
        self._flush()
        return tuple(self._totals)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def make_streaming_eval_scan(model, multi_tower: bool, domain_idx: int,
                             n_domain: int, n_bins: int = 8192,
                             compute_dtype: str = "float32"):
    """Device-resident eval that never hauls predictions to the host.

    -> (``eval_scan_hist(model, Xdev, ydev, d2g, (idxs, masks), pos, neg,
    lsum, lcnt) -> carry``, ``init_carry()``): the :func:`hist_update`
    statistics of the [K, bs] index batches accumulate on the device, in
    the carry's tensors."""
    check_compute_dtype(compute_dtype)

    @torch.no_grad()
    def eval_scan_hist(model, Xdev, ydev, d2g, idx_mask, pos, neg, lsum,
                       lcnt):
        idxs, masks = idx_mask
        carry = (pos, neg, lsum, lcnt)
        for idx, mask in zip(idxs, masks):
            x, dom, group = _gather_batch(Xdev, d2g, idx, domain_idx)
            y = ydev.index_select(0, idx)
            carry = hist_update(carry, dom,
                                _eval_logit(model, x, group, multi_tower,
                                            compute_dtype),
                                y, mask, n_bins)
        return carry

    return eval_scan_hist, functools.partial(
        hist_init, n_domain, n_bins, device=_model_device(model))


def make_streaming_eval_batch_scan(model, multi_tower: bool, domain_idx: int,
                                   n_domain: int, n_bins: int = 8192,
                                   compute_dtype: str = "float32"):
    """Batch-mode variant of :func:`make_streaming_eval_scan` for stacked
    batches (x, y, group, mask on a leading K axis): ``hist_scan(model,
    pos, neg, lsum, lcnt, batches) -> carry``."""
    check_compute_dtype(compute_dtype)

    @torch.no_grad()
    def hist_scan(model, pos, neg, lsum, lcnt, batches):
        carry = (pos, neg, lsum, lcnt)
        for i in range(batches["x"].shape[0]):
            x = batches["x"][i].to(torch.int32)
            group = batches["group"][i]
            carry = hist_update(carry, x[:, domain_idx],
                                _eval_logit(model, x, group, multi_tower,
                                            compute_dtype),
                                batches["y"][i], batches["mask"][i], n_bins)
        return carry

    return hist_scan, functools.partial(
        hist_init, n_domain, n_bins, device=_model_device(model))

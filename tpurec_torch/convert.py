"""The one place the JAX package's parameter trees map onto the port's.

``state_dict_from_flax(params, model_state)`` turns a flax ``params`` tree
and its collections (``batch_stats``) — nested dicts of numpy arrays, as
``Trainer.state`` or a checkpoint holds them — into the ``state_dict`` of
the port's model:

- a leaf's key is its path joined with dots (``experts.linear_0.weight``,
  ``aux.atten.self_attn_2.in_proj_bias``, ``embedding.table``);
- weights keep flax's layout: a Linear's [in, out] and a stacked bank's
  [T, in, out] are the port's own layouts too, so nothing is transposed;
- ``batch_stats`` leaves (``mean``, ``var``, ``num_batches_tracked``) land
  beside their module's ``scale``/``bias`` as buffers, and so does ADL's
  ``adl_state`` collection (``cluster_centers``); on the way back
  :data:`BUFFER_COLLECTIONS` names each buffer's collection by its path.

Every leaf is copied.  :func:`train_state_from_flax` builds a port
TrainState from the JAX package's TrainState;
:func:`train_state_to_flax` is its inverse (the tree that
``flax.serialization.to_state_dict`` gives for that TrainState), and
:func:`restore_train_state` loads such a tree into a port TrainState in
place.  Two optimizer layouts cross, by the trainer's
``embedding_update``:

- ``"hybrid"`` and ``"sparse"``: ``(tx.init(rest), SparseEmbedState)``,
  optax's chain state over the parameters but the table, beside the
  table's moments;
- ``"dense"``: optax's chain state over every parameter, the table's
  ``mu``/``nu`` included, and no ``SparseEmbedState``.

A tree of the other layout than the state's raises.

A state on a mesh (its table one shard of the rows:
:class:`tpurec_torch.parallel.embedding.TableShard` at
``model.embedding.shard``) crosses as the whole table: the table and its
moments are gathered over the model group on the way out (a collective:
every rank calls it; ``local=True`` keeps this rank's rows instead), and
each rank keeps its rows of a whole table on the way in.  The padding
rows of the shards never appear in a tree.  The leaves of expert banks
split over the model axis (:mod:`tpurec_torch.parallel.experts`), their
Adam moments included, cross the same way: gathered to the one-device
shapes on the way out (``local_experts=True`` keeps this rank's
stacks), cut to this rank's stacks on the way in.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from tpurec_torch.parallel.embedding import table_shard
from tpurec_torch.parallel.experts import expert_leaf_shards


# a buffer's flax collection, by its path in the state_dict; every other
# buffer is a BatchNorm statistic, in ``batch_stats``
BUFFER_COLLECTIONS = {"cluster_centers": "adl_state"}
TABLE = "embedding.table"


def _rows_in(shard):
    """Table-shaped array -> this shard's rows (a whole table's are cut;
    a tensor of the shard's rows passes)."""
    def rows(t: torch.Tensor) -> torch.Tensor:
        if shard is None or t.shape[0] == shard.n_local:
            return t
        return shard.local(t)
    return rows


def _cuts(model):
    """state_dict key -> a function taking a whole leaf (or one of this
    rank's part) to this rank's part: the table's rows, a split bank's
    stacks; other keys are absent."""
    cuts = {k: sh.local for k, sh in expert_leaf_shards(model).items()}
    shard = table_shard(model)
    if shard is not None:
        cuts[TABLE] = _rows_in(shard)
    return cuts


def _gathers(model, local: bool, local_experts: bool):
    """state_dict key -> the function gathering this rank's part of it to
    the whole leaf (a collective), for the table unless ``local`` and for
    the split banks' leaves unless ``local_experts``."""
    out = {} if local_experts else {
        k: sh.gather for k, sh in expert_leaf_shards(model).items()}
    shard = table_shard(model)
    if shard is not None and not local:
        out[TABLE] = shard.gather
    return out


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _leaves(v, key + ".")
        else:
            yield key, v


def state_dict_from_flax(params: Mapping,
                         model_state: Optional[Mapping] = None
                         ) -> Dict[str, torch.Tensor]:
    """flax ``params`` + ``model_state`` collections -> port state_dict."""
    trees = [params] + list((model_state or {}).values())
    out: Dict[str, torch.Tensor] = {}
    for tree in trees:
        for key, leaf in _leaves(tree):
            if key in out:
                raise ValueError(f"two leaves map to {key!r}")
            out[key] = _tensor(leaf)
    return out


def _tensor(leaf) -> torch.Tensor:
    """numpy (or ml_dtypes bfloat16) array -> a torch tensor of its dtype."""
    a = np.array(leaf)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def train_state_from_flax(model: torch.nn.Module, tcfg, params: Mapping,
                          model_state: Optional[Mapping], adam_mu: Mapping,
                          adam_nu: Mapping, adam_count, emb_m, emb_v,
                          step, device=None):
    """The JAX package's ``TrainState`` pieces, as numpy arrays, -> the
    port's :class:`tpurec_torch.train.step.TrainState` on ``device`` (the
    card unless the caller asks for the CPU).

    ``params``/``model_state`` load into ``model``; ``adam_mu``,
    ``adam_nu`` and ``adam_count`` are optax's ``ScaleByAdamState`` of the
    parameters the dense optimizer steps (trees of the same paths), which
    become the ``torch.optim.Adam``'s ``exp_avg``, ``exp_avg_sq`` and
    ``step``; ``emb_m``/``emb_v`` are the table's moments
    (``SparseEmbedState``, float32 or bfloat16) of the hybrid/sparse
    layout, or None for the ``"dense"`` layout, whose Adam trees hold the
    table too; ``step`` the step count.  A leaf the model lacks, or one it
    has and the trees do not, raises."""
    from tpurec_torch.train.hybrid import init_train_state
    from tpurec_torch.train.step import init_dense_train_state

    _load_model(model, params, model_state)
    ts = (init_dense_train_state if emb_m is None else init_train_state)(
        model, tcfg, device)
    _load_optimizer(ts, adam_mu, adam_nu, adam_count, emb_m, emb_v, step)
    return ts


def _load_model(model, params, model_state) -> None:
    """The trees into ``model`` (its rows of the table and its stacks of
    the split banks on a mesh)."""
    sd = state_dict_from_flax(params, model_state)
    for k, cut in _cuts(model).items():
        if k in sd:
            sd[k] = cut(sd[k])
    model.load_state_dict(sd, strict=True)


def _load_optimizer(ts, adam_mu, adam_nu, adam_count, emb_m, emb_v,
                    step) -> None:
    """The dense Adam's moments and count, the table's moments and the
    step into ``ts``, in place where a tensor exists already."""
    dev = ts.model.get_parameter("embedding.table").device
    mu = dict(_leaves(adam_mu))
    nu = dict(_leaves(adam_nu))
    names = {id(p): n for n, p in ts.model.named_parameters()}
    stepped = {names[id(p)] for group in ts.optimizer.param_groups
               for p in group["params"]}
    for what, tree in (("adam_mu", mu), ("adam_nu", nu)):
        if set(tree) != stepped:
            raise ValueError(
                f"{what} does not fit the model's dense parameters: missing "
                f"{sorted(stepped - set(tree))}, unexpected "
                f"{sorted(set(tree) - stepped)}")
    count = float(np.asarray(adam_count))
    cuts = _cuts(ts.model)
    for group in ts.optimizer.param_groups:
        for p in group["params"]:
            n = names[id(p)]
            cut = cuts.get(n, lambda t: t)
            ts.optimizer.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": cut(_tensor(mu[n])).to(dev, torch.float32),
                "exp_avg_sq": cut(_tensor(nu[n])).to(dev, torch.float32),
            }
    if ts.emb_opt is not None:
        for name, src in (("m", emb_m), ("v", emb_v)):
            dst = getattr(ts.emb_opt, name)
            dst.copy_(cuts.get(TABLE, lambda t: t)(_tensor(src))
                      .to(dev, dst.dtype))
    ts.step = int(np.asarray(step))


def _set_leaf(tree: Dict, key: str, leaf) -> None:
    *path, last = key.split(".")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[last] = leaf


def _numpy(t: torch.Tensor):
    """A tensor -> numpy on the host; bfloat16 stays a tensor (numpy has
    none), which the msgpack writer stores with its raw 2-byte payload."""
    t = t.detach().to("cpu", copy=True)
    return t if t.dtype == torch.bfloat16 else t.numpy()


def train_state_to_flax(ts, local: bool = False,
                        local_experts: Optional[bool] = None
                        ) -> Dict[str, Any]:
    """A port TrainState -> the flax state dict of the JAX package's
    TrainState (``flax.serialization.to_state_dict``'s tree):

    ``{"params", "opt_state": {"0": {"0": {}, "1": {"count", "mu", "nu"},
    "2": {}}, "1": {"m", "v"}}, "model_state", "step"}`` (``model_state``
    holds ``batch_stats`` and, for ADL, ``adl_state``) — the layout of
    ``optax.chain(add_decayed_weights, scale_by_adam, scale)`` beside the
    table's ``SparseEmbedState`` — or, for a ``"dense"`` state (no
    ``emb_opt``), ``"opt_state": {"0": {}, "1": {"count", "mu", "nu"},
    "2": {}}`` over every parameter.  Leaves are numpy arrays (bfloat16
    table moments stay CPU tensors); ``count`` and ``step`` are int32
    scalars; the dense Adam's per-parameter step is one count.  On a
    mesh the table-shaped leaves are gathered (every rank must call),
    unless ``local``, and the split expert banks' leaves and moments,
    unless ``local_experts`` (default: ``local``)."""
    model = ts.model
    gathers = _gathers(model, local,
                       local if local_experts is None else local_experts)
    full = gathers.get(TABLE, lambda t: t)
    params: Dict[str, Any] = {}
    collections: Dict[str, Dict[str, Any]] = {}
    names = {n for n, _ in model.named_parameters()}
    for key, t in model.state_dict().items():
        tree = params if key in names else collections.setdefault(
            BUFFER_COLLECTIONS.get(key, "batch_stats"), {})
        _set_leaf(tree, key, _numpy(gathers.get(key, lambda v: v)(t)))
    mu: Dict[str, Any] = {}
    nu: Dict[str, Any] = {}
    ids = {id(p): n for n, p in model.named_parameters()}
    counts = set()
    for group in ts.optimizer.param_groups:
        for p in group["params"]:
            st = ts.optimizer.state.get(p) or {}
            zero = torch.zeros_like(p, dtype=torch.float32)
            cut = gathers.get(ids[id(p)], lambda t: t)
            _set_leaf(mu, ids[id(p)], _numpy(cut(st.get("exp_avg", zero))))
            _set_leaf(nu, ids[id(p)],
                      _numpy(cut(st.get("exp_avg_sq", zero))))
            counts.add(int(st["step"]) if "step" in st else 0)
    if len(counts) > 1:
        raise ValueError(f"the dense parameters' Adam counts differ: "
                         f"{sorted(counts)}")
    count = counts.pop() if counts else 0
    chain = {"0": {}, "1": {"count": np.asarray(count, np.int32),
                            "mu": mu, "nu": nu}, "2": {}}
    return {
        "params": params,
        "opt_state": chain if ts.emb_opt is None else {
            "0": chain,
            "1": {"m": _numpy(full(ts.emb_opt.m)),
                  "v": _numpy(full(ts.emb_opt.v))}},
        "model_state": collections,
        "step": np.asarray(ts.step, np.int32),
    }


def _layout(dense: bool) -> str:
    return ("'dense' (Adam over every parameter)" if dense else
            "'hybrid'/'sparse' (Adam over the rest, the table's moments "
            "beside it)")


def restore_train_state(ts, tree: Mapping) -> None:
    """Load a flax state dict of the JAX package's TrainState (as
    :func:`train_state_to_flax` writes it, or a tpurec checkpoint holds
    it) into ``ts``, in place: the model's parameters and buffers are
    copied into the tensors they hold (so a gather prepared for the table
    stays valid), then the optimizers' state and the step.  A tree whose
    optimizer layout is not the state's raises ValueError before anything
    is copied."""
    opt = tree["opt_state"]
    dense = "count" in opt["1"]
    if dense != (ts.emb_opt is None):
        raise ValueError(
            f"the checkpoint's optimizer state has the {_layout(dense)} "
            f"layout, the trainer's update the {_layout(not dense)} one: "
            "restore it into a trainer of the update that wrote it")
    _load_model(ts.model, tree["params"], tree.get("model_state"))
    adam, emb = (opt["1"], {}) if dense else (opt["0"]["1"], opt["1"])
    _load_optimizer(ts, adam["mu"], adam["nu"], adam["count"],
                    emb.get("m"), emb.get("v"), tree["step"])

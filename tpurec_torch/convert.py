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
  beside their module's ``scale``/``bias`` as buffers.

Every leaf is copied.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch


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
    """The JAX package's hybrid ``TrainState`` pieces, as numpy arrays, ->
    the port's :class:`tpurec_torch.train.step.TrainState` on ``device``
    (the card unless the caller asks for the CPU).

    ``params``/``model_state`` load into ``model``; ``adam_mu``,
    ``adam_nu`` and ``adam_count`` are optax's ``ScaleByAdamState`` of the
    parameters other than the table (trees of the same paths), which
    become the dense ``torch.optim.Adam``'s ``exp_avg``, ``exp_avg_sq``
    and ``step``; ``emb_m``/``emb_v`` are the table's moments
    (``SparseEmbedState``, float32 or bfloat16); ``step`` the step
    count."""
    from tpurec_torch.train.hybrid import init_train_state

    model.load_state_dict(state_dict_from_flax(params, model_state),
                          strict=True)
    ts = init_train_state(model, tcfg, device)
    dev = ts.model.get_parameter("embedding.table").device
    mu = dict(_leaves(adam_mu))
    nu = dict(_leaves(adam_nu))
    names = {id(p): n for n, p in ts.model.named_parameters()}
    count = float(np.asarray(adam_count))
    for group in ts.optimizer.param_groups:
        for p in group["params"]:
            n = names[id(p)]
            ts.optimizer.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": _tensor(mu[n]).to(dev, torch.float32),
                "exp_avg_sq": _tensor(nu[n]).to(dev, torch.float32),
            }
    for name, src in (("m", emb_m), ("v", emb_v)):
        dst = getattr(ts.emb_opt, name)
        dst.copy_(_tensor(src).to(dev, dst.dtype))
    ts.step = int(np.asarray(step))
    return ts

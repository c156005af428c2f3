"""Expert parallelism: the MoE banks split over the mesh's model axis
(counterpart of ``tpurec/parallel/mesh.py:46-101``, ``expert_parallel``).

The JAX package shards the leading axis of every leaf whose path names
an expert bank (:data:`EXPERT_BANK_NAMES`) over the model axis, when the
leaf has two axes or more and the bank's size divides the axis, and lets
GSPMD place the collectives.  The port splits the same leaves and writes
the collectives out (:mod:`tpurec_torch.parallel.collectives`):

- a bank is a :class:`tpurec_torch.nn.core.StackedMLP` whose dotted name
  contains a bank name (MMoE's ``experts``, PLE's ``experts_specific`` and
  ``experts_shared``, HiNet's ``specific_experts`` and
  ``shared_experts``).  Model rank ``m`` of ``n`` keeps the contiguous
  stacks ``[m E / n, (m + 1) E / n)`` of its ``[E, ...]`` leaves (the
  StackedLinear weights and biases, the BatchNorm running statistics),
  as GSPMD splits them; the 1-D leaves (the bank's shared BatchNorm
  ``scale``/``bias``) stay whole, and so does a bank whose ``E`` does not
  divide ``n``;
- the bank's forward (:func:`tpurec_torch.nn.core.split_bank_forward`)
  takes its input through :func:`~tpurec_torch.parallel.collectives.
  copy_to_model` (or, for a per-stack input, its own stacks through
  :func:`~tpurec_torch.parallel.collectives.scatter_to_model`), runs its
  stacks and returns every stack through :func:`~tpurec_torch.parallel.
  collectives.gather_from_model`: the layers after it are unchanged;
- a split leaf's gradient is its stacks' part of the one-device
  gradient; a whole leaf inside a split bank takes a partial gradient on
  each model rank, which the steps sum over the model group
  (:func:`expert_leaves`).

:class:`BankShard` records a split bank; checkpoints gather its leaves
to the one-device shapes and cut them again on load
(:mod:`tpurec_torch.convert`).
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

import torch

from tpurec_torch.parallel.collectives import all_gather

# module names whose [E, ...] leaves are expert banks
# (tpurec/parallel/mesh.py:52-55)
EXPERT_BANK_NAMES = frozenset(
    {"experts", "experts_specific", "experts_shared",
     "specific_experts", "shared_experts"})


def in_expert_bank(path) -> bool:
    """Whether ``path`` (a dotted name, or its keys) names a leaf of an
    expert bank."""
    keys = path.split(".") if isinstance(path, str) else [str(k)
                                                          for k in path]
    return any(k in EXPERT_BANK_NAMES for k in keys)


class BankShard:
    """This rank's stacks ``[lo, lo + n_local)`` of an ``n_stack`` bank
    over ``mesh``'s model axis."""

    def __init__(self, n_stack: int, mesh):
        n = mesh.n_model
        if n_stack % n:
            raise ValueError(f"a bank of {n_stack} does not split over "
                             f"{n} model ranks")
        self.mesh = mesh
        self.n_stack = int(n_stack)
        self.n_local = self.n_stack // n
        self.lo = mesh.m * self.n_local

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """A whole ``[n_stack, ...]`` leaf -> this rank's stacks (a copy);
        a leaf of this rank's stacks passes unchanged."""
        if full.shape[0] == self.n_local:
            return full
        if full.shape[0] != self.n_stack:
            raise ValueError(f"expected {self.n_stack} stacks, got "
                             f"{full.shape[0]}")
        return full[self.lo:self.lo + self.n_local].clone()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """Every model rank's stacks -> the whole ``[n_stack, ...]`` leaf
        (a collective of the model group)."""
        if local.shape[0] != self.n_local:
            raise ValueError(f"expected {self.n_local} stacks, got "
                             f"{local.shape[0]}")
        return all_gather(local.contiguous(), self.mesh.model_group,
                          self.mesh.n_model, self.mesh.m)


def _banks(model):
    """(dotted name, module) of each expert bank of ``model``: a module
    with an ``expert_shard`` slot (a StackedMLP) under a bank name."""
    return [(name, mod) for name, mod in model.named_modules()
            if hasattr(mod, "expert_shard") and in_expert_bank(name)]


def split_expert_banks(model, mesh) -> Tuple[List[str], List[str]]:
    """Cut every expert bank of ``model`` whose size divides ``mesh``'s
    model axis to this rank's stacks, in place (its ``[E, ...]``
    parameters and buffers; ``expert_shard`` set).  -> (names of the
    split banks, names of the banks left whole: every bank on a model
    axis of one)."""
    split, whole = [], []
    for name, mod in _banks(model):
        if mod.expert_shard is not None:
            raise ValueError(f"{name} is split already")
        if mesh.n_model == 1 or mod.n_stack % mesh.n_model:
            whole.append(name)
            continue
        shard = BankShard(mod.n_stack, mesh)
        for sub in mod.modules():
            for pname, p in list(sub.named_parameters(recurse=False)):
                if p.dim() >= 2:
                    setattr(sub, pname, torch.nn.Parameter(
                        shard.local(p.detach()),
                        requires_grad=p.requires_grad))
            for bname, b in list(sub.named_buffers(recurse=False)):
                if b is not None and b.dim() >= 2:
                    setattr(sub, bname, shard.local(b))
        mod.expert_shard = shard
        split.append(name)
    return split, whole


def expert_leaf_shards(model) -> Dict[str, BankShard]:
    """state_dict key -> the :class:`BankShard` of each split leaf (a
    leaf of two axes or more in a split bank)."""
    out = {}
    for name, mod in _banks(model):
        shard = mod.expert_shard
        if shard is None:
            continue
        for key, t in mod.state_dict(keep_vars=True).items():
            if t.dim() >= 2:
                out[f"{name}.{key}"] = shard
    return out


def expert_leaves(model) -> Tuple[Set[str], Set[str]]:
    """(split, partial): the names of the parameters that hold this
    rank's stacks of a split bank, and of those that stay whole inside a
    split bank (their gradient on a model rank is its stacks' part).
    Both empty without expert parallelism."""
    split: Set[str] = set()
    partial: Set[str] = set()
    for name, mod in _banks(model):
        if mod.expert_shard is None:
            continue
        for pname, p in mod.named_parameters():
            (split if p.dim() >= 2 else partial).add(f"{name}.{pname}")
    return split, partial


def model_split_l2(named, split: Set[str], partial: Set[str], m: int,
                   also: Tuple[str, ...] = ()):
    """Partition ``named`` (name, parameter) pairs by how a mesh counts
    their L2 -> (whole, summed): ``whole``, the leaves every model rank
    holds alike, whose L2 each rank adds itself; ``summed``, the leaves
    whose L2 terms are summed over the model group: this rank's stacks
    (``split``), the names in ``also`` (the table's rows) and, on model
    rank 0 only, the whole leaves of split banks (``partial``: their
    gradients are summed over the model group, so their L2 counts once).
    Both keep ``named``'s order."""
    whole, summed = [], []
    for n, p in named:
        if n in split or n in also:
            summed.append((n, p))
        elif n in partial:
            if m == 0:
                summed.append((n, p))
        else:
            whole.append((n, p))
    return whole, summed

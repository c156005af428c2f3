"""Serving for trained models on the card (counterpart of ``tpurec/serve.py``).

- :class:`Predictor` scores [N, F] id matrices in chunks of its largest
  configured batch size; the ragged tail is padded to the smallest
  configured size that fits it (pad rows use id 0), as in the JAX package.
- The embedding table is held quantised (``table_dtype`` float32, bfloat16
  or int8 with per-row scales); the gather kernel dequantises while it
  gathers, so one launch turns ids into float32 rows.
- Multi-tower models select the ``domain2group[domain]`` tower; CDC
  checkpoints serve their base model at ``n_tower = n_cluster`` with the
  persisted clustering as the routing table.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (which runs each kernel's plain version); with no card
and no explicit CPU device it raises.  Usage::

    pred = predictor_from_checkpoint("ckpt.pkl", batch_sizes=(512, 4096))
    probs = pred(X)                         # np.ndarray [N] probabilities
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tpurec_torch.config import Config
from tpurec_torch.convert import state_dict_from_flax
from tpurec_torch.data.hashing import hash_ids
from tpurec_torch.device import resolve_device
from tpurec_torch.models import MULTI_TOWER_OUTPUT, build_model
from tpurec_torch.nn.core import EmbeddingLayout
from tpurec_torch.nn.precision import check_compute_dtype
from tpurec_torch.ops.embedding import take_rows
from tpurec_torch.train.checkpoint import (check_embed_layout_version,
                                           msgpack_restore)
from tpurec_torch.train.step import select_tower

_TABLE_DTYPES = ("float32", "bfloat16", "int8")


def quantize_table(table, dtype: str):
    """-> (qtable, scales|None) as CPU tensors, with the JAX package's
    rounding (``tpurec/serve.py:50-66``).

    int8: symmetric per-row, scale = max|row|/127 (scale 1.0 for all-zero
    rows so dequant stays exact), round half to even.  bfloat16: cast with
    round to nearest even.  float32: no-op.
    """
    t = torch.as_tensor(np.asarray(table) if not torch.is_tensor(table)
                        else table).to("cpu", torch.float32)
    if dtype == "float32":
        return t.contiguous(), None
    if dtype == "bfloat16":
        return t.to(torch.bfloat16), None
    if dtype == "int8":
        amax = t.abs().amax(dim=1)
        scales = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        q = torch.clamp(torch.round(t / scales[:, None]), -127, 127)
        return q.to(torch.int8), scales
    raise ValueError(f"table_dtype must be one of {_TABLE_DTYPES}, got {dtype!r}")


class Predictor:
    """Batch predictor for a ported model (MMoE and DCN) or a CDC
    checkpoint on its MMoE base.  Multi-tower models select each row's
    tower; single-head models (DCN) return their one logit.

    ``cfg`` must be the TRAINING config; for ``cfg.model.model == "cdc"``
    the served network is the CDC base model with ``n_tower = n_cluster``.
    """

    def __init__(self, cfg: Config, field_dims, n_domain: int,
                 domain_idx: int, domain2group=None,
                 batch_sizes: Sequence[int] = (512,),
                 table_dtype: str = "float32", device=None):
        if table_dtype not in _TABLE_DTYPES:
            raise ValueError(
                f"table_dtype must be one of {_TABLE_DTYPES}, got {table_dtype!r}")
        self.device = resolve_device(device)
        check_compute_dtype(cfg.train.compute_dtype)
        self.cfg = cfg
        self.field_dims = tuple(int(d) for d in field_dims)
        self.n_domain = int(n_domain)
        self.domain_idx = int(domain_idx)
        self.table_dtype = table_dtype
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        if not self.batch_sizes:
            raise ValueError("need at least one batch size")

        name = cfg.model.model
        if domain2group is None:
            domain2group = np.zeros(n_domain, np.int32)
        if name == "cdc":
            # CDC serves its base model at n_tower=n_cluster, with the
            # expert/tower dims remapped as the CDC engine builds it
            mcfg = dataclasses.replace(
                cfg.model,
                model=cfg.cdc.base_model,
                mmoe_expert_dims=cfg.model.mlp_dims,
                mmoe_tower_dims=cfg.cdc.cdc_tower_dims,
                ple_tower_dims=cfg.cdc.cdc_tower_dims,
                tower_dims=cfg.cdc.cdc_tower_dims,
            )
            name = cfg.cdc.base_model
            n_tower = cfg.cdc.n_cluster
        else:
            mcfg = cfg.model
            n_tower = int(np.max(domain2group)) + 1
        self.model_name = name
        self.domain2group = np.asarray(domain2group, np.int32)
        # raw request ids on hashed fields are bucketed like the training
        # load path (salt = field index)
        self.hash_buckets = dict(cfg.data.hash_buckets or ())
        # shapes only: every weight arrives through load_state_dict
        self.model = build_model(name, self.field_dims, n_tower, domain_idx,
                                 mcfg, device="meta").eval()
        self.multi_tower = (name in MULTI_TOWER_OUTPUT
                            and not name.endswith("-single"))
        self.layout = EmbeddingLayout(self.field_dims)
        self._qtable = None
        self._scales = None
        self._gather = None
        self._d2g = None

    # -- loading -------------------------------------------------------
    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]):
        """Install the port model's weights (quantising the table)."""
        sd = dict(state_dict)
        q, s = quantize_table(sd.pop("embedding.table"), self.table_dtype)
        dev = self.device
        missing, unexpected = self.model.load_state_dict(
            {k: v.to(dev) for k, v in sd.items()}, strict=False, assign=True)
        if unexpected or missing != ["embedding.table"]:
            raise ValueError(f"state_dict does not fit the model: missing "
                             f"{missing}, unexpected {unexpected}")
        self._qtable = q.to(dev)
        self._scales = None if s is None else s.to(dev)
        self._gather = self.layout.gather(self._qtable, self._scales)
        self._d2g = torch.as_tensor(self.domain2group, device=dev)
        return self

    def load_variables(self, params, model_state: Optional[Dict] = None):
        """Install the JAX package's variables (numpy trees)."""
        return self.load_state_dict(state_dict_from_flax(params, model_state))

    def load_from_trainer(self, trainer):
        """Copy the current weights out of a live port ``Trainer`` (later
        training does not reach them)."""
        return self.load_state_dict(
            {k: v.detach().clone()
             for k, v in trainer.model.state_dict().items()})

    def load_checkpoint(self, path: str, payload: Optional[Dict] = None):
        """Load a Trainer or CDCTrainer ``save_checkpoint`` file, of the
        JAX package or the port (both write the same payload).

        A persisted routing table REPLACES the constructor's grouping, so
        serving routes the way training did.  Only params and model
        collections are read out of the state bytes.
        """
        if payload is None:
            payload = _load_payload(path)
        check_embed_layout_version(payload.get("embed_layout"), path)
        d2g = payload.get("domain2group_list", payload.get("domain2group"))
        if d2g is not None:
            d2g = np.asarray(d2g, np.int32)
            n_tower = int(self.model.n_tower)
            if d2g.size and int(d2g.max()) >= n_tower:
                raise ValueError(
                    f"checkpoint grouping routes to tower {int(d2g.max())} "
                    f"but the model was built with n_tower={n_tower}; "
                    "construct the Predictor with the matching "
                    "domain2group/config")
            self.domain2group = d2g
        raw = msgpack_restore(payload["state"])
        return self.load_variables(raw["params"], raw.get("model_state") or {})

    # -- forward -------------------------------------------------------
    @torch.inference_mode()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, F] int32 on the device -> probabilities [B]."""
        rows = self._gather(x)
        group = take_rows(self._d2g, x[:, self.domain_idx])
        out = self.model(x, group=group, embed_rows=rows)
        logit = select_tower(out, group) if self.multi_tower else out
        return torch.sigmoid(logit)

    def warm(self):
        """Run every configured batch size once (builds the kernels)."""
        if self._qtable is None:
            raise RuntimeError("load_state_dict/load_checkpoint first")
        for bs in self.batch_sizes:
            self._forward(torch.zeros((bs, len(self.field_dims)),
                                      dtype=torch.int32, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def predict_async(self, X: np.ndarray):
        """Submit the scoring of X [N, F] WITHOUT waiting for the device;
        returns a zero-arg callable yielding the [N] probabilities.

        CUDA launches are asynchronous, so a server that serialises only
        the submission lets concurrent requests overlap on the card.
        """
        if self._qtable is None:
            raise RuntimeError("load_state_dict/load_checkpoint first")
        X = np.asarray(X)
        if self.hash_buckets:
            X = X.astype(np.int64, copy=True)
            for f, nb in self.hash_buckets.items():
                X[:, f] = hash_ids(X[:, f], nb, salt=f)
        X = X.astype(np.int32)
        n = X.shape[0]
        bs = self.batch_sizes[-1]
        parts = []  # (in-flight device tensor, rows to keep)
        for lo in range(0, n, bs):
            hi = min(lo + bs, n)
            xb = X[lo:hi]
            if hi - lo < bs:
                # smallest configured size that fits the tail
                bs_t = next(b for b in self.batch_sizes if b >= hi - lo)
                xb = np.concatenate(
                    [xb, np.zeros((bs_t - (hi - lo), X.shape[1]), X.dtype)])
            x = torch.from_numpy(np.ascontiguousarray(xb)).to(self.device)
            parts.append((self._forward(x), hi - lo))

        def result() -> np.ndarray:
            out = np.empty((n,), np.float32)
            lo = 0
            for p, take in parts:
                out[lo:lo + take] = p[:take].cpu().numpy()
                lo += take
            return out

        return result

    def __call__(self, X: np.ndarray) -> np.ndarray:
        """X [N, F] int -> probabilities [N] (np.float32)."""
        return self.predict_async(X)()

    # -- memory accounting --------------------------------------------
    def table_bytes(self) -> Tuple[int, int]:
        """(quantized bytes incl. scales, float32-equivalent bytes)."""
        if self._qtable is None:
            raise RuntimeError("load_state_dict/load_checkpoint first")
        q = self._qtable.numel() * self._qtable.element_size()
        if self._scales is not None:
            q += self._scales.numel() * 4
        return int(q), int(self._qtable.numel() * 4)


def _load_payload(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def predictor_from_checkpoint(path: str,
                              batch_sizes: Sequence[int] = (512,),
                              table_dtype: str = "float32",
                              cfg: Optional[Config] = None,
                              device=None) -> Predictor:
    """Build + load a Predictor from a self-describing tpurec checkpoint
    (it carries the training config and the dataset schema).  ``cfg``
    overrides the embedded config.

    TRUST BOUNDARY: the checkpoint envelope is a pickle, and unpickling
    executes arbitrary code — load checkpoints ONLY from paths you
    produced or trust.
    """
    payload = _load_payload(path)
    if cfg is None:
        if "config" not in payload:
            raise ValueError(
                f"{path} predates self-describing checkpoints; pass cfg=")
        from tpurec_torch.config import config_from_dict

        cfg = config_from_dict(payload["config"])
    field_dims = payload.get("field_dims")
    if field_dims is None:
        raise ValueError(f"{path} has no field_dims; re-save the checkpoint")
    d2g = payload.get("domain2group_list", payload.get("domain2group"))
    pred = Predictor(
        cfg, field_dims, payload["n_domain"], payload["domain_idx"],
        domain2group=None if d2g is None else np.asarray(d2g, np.int32),
        batch_sizes=batch_sizes, table_dtype=table_dtype, device=device,
    )
    return pred.load_checkpoint(path, payload=payload)


def main(argv=None):
    """Score a table of categorical ids with a trained checkpoint.

        python -m tpurec_torch.serve --ckpt ckpt.pkl --input X.npy \\
            --output probs.npy --table_dtype int8 --bs 4096 --device cuda

    ``--input``: .npy int array [N, F] (field-local ids, same schema as
    training) or a headerless CSV of ints.  Output: .npy float32 [N]
    probabilities (or CSV if --output ends in .csv).
    """
    import argparse

    p = argparse.ArgumentParser(description="tpurec_torch serving CLI")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--bs", type=int, default=4096)
    p.add_argument("--table_dtype", default="float32",
                   choices=list(_TABLE_DTYPES))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    if args.input.endswith(".npy"):
        X = np.load(args.input)
    else:
        X = np.loadtxt(args.input, delimiter=",", dtype=np.int64)
    # keep int64: hash-trained checkpoints accept raw ids wider than int32
    X = np.atleast_2d(np.asarray(X, np.int64))

    pred = predictor_from_checkpoint(
        args.ckpt, batch_sizes=(args.bs,), table_dtype=args.table_dtype,
        device=args.device)
    probs = pred(X)
    if args.output.endswith(".csv"):
        np.savetxt(args.output, probs, fmt="%.6f")
    else:
        np.save(args.output, probs)
    print(f"scored {len(probs)} rows -> {args.output} "
          f"(mean prob {probs.mean():.4f})")


if __name__ == "__main__":
    main()

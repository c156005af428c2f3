"""CLI entry: train/eval any zoo model or CDC, on the card (the port's copy
of ``tpurec/cli.py``).

Mirrors the reference's 21-flag surface (main.py:16-41) on top of the typed
config, including the all-args seed-hash default (main.py:43-47), with the
JAX package's flags and defaults plus ``--device`` (``cuda``, the default,
or ``cpu``).  The seed hash reads every flag but ``--device``, so one argv
gives the JAX package's seed in one process.  Python salts ``str``
hashes per process, so under a launcher rank 0's hash is broadcast to
every rank before anything is seeded: the ranks of one launch train from
one seed.

    python -m tpurec_torch.cli --model cdc --dataset_name synthetic \
        --base_model mmoe --mesh_data -1
    python -m torch.distributed.run --nproc_per_node 4 -m tpurec_torch.cli \
        --model mmoe --dataset_name aliccp --data_path dataset/aliccp \
        --group_strategy split --mesh_data 2 --mesh_model 2

The mesh follows the JAX package's rule (``tpurec/cli.py:299-328``) with
ranks for devices: under ``torch.distributed.run`` the world is the
launch's ranks, the default ``--mesh_data 0`` takes all of them, an
explicit mesh larger than the world exits, and ``--mesh_data -1`` trains
each rank alone.  A plain launch on a host of several cards exits with
how to launch, where the JAX package would train on every card; a mesh
must take every rank of the launch.  Only rank 0 logs, writes the
checkpoint and prints the result line.  The mesh reaches ``Trainer`` and
``CDCTrainer`` alike, and ``--mesh_expert_parallel`` splits the expert
banks over its model axis (``Shardings(expert_parallel=True)``; without
a mesh the flag does nothing, as in the JAX package).  pandas is
imported only by the CSV datasets' branch.

    python -m torch.distributed.run --nproc_per_node 2 -m tpurec_torch.cli \
        --model cdc --base_model ple --mesh_model 2 --mesh_expert_parallel
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from tpurec_torch.config import (
    CDCConfig,
    Config,
    DataConfig,
    DOMAIN2GROUP_ORG_DICT,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from tpurec_torch.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="tpurec_torch trainer")
    p.add_argument("--model", default="deepfm")
    p.add_argument("--dataset_name", default="synthetic")
    p.add_argument("--data_path", default="dataset")
    p.add_argument("--base_model", default="mmoe")
    p.add_argument("--seed", type=int, default=2000)
    p.add_argument("--is_set_seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--bs", type=int, default=512)
    p.add_argument("--l2_reg", type=float, default=1e-5)
    p.add_argument("--epoch", type=int, default=10)
    p.add_argument("--embed_dim", type=int, default=16)
    # None = reference N(0,1) embedding init (layer.py:140)
    p.add_argument("--embed_init_std", type=float, default=None)
    # feature hashing, e.g. --hash_buckets '{9: 100000}' (field idx -> buckets)
    p.add_argument("--hash_buckets", default=None)
    # directory for the final best-model checkpoint ('' disables saving)
    p.add_argument("--save_path", default="save")
    p.add_argument("--prepare2train_month", type=int, default=12)
    p.add_argument("--group_strategy", default="mix")
    p.add_argument("--domain_filter", default=None,
                   help="e.g. '[0,3,5]' — keep only these domains (run.py:120-123)")
    p.add_argument("--resume", default=None,
                   help="checkpoint path to resume from (is_increment analog)")
    # cdc flags (main.py:30-40)
    p.add_argument("--n_cluster", type=int, default=4)
    p.add_argument("--update_matrix_step", type=int, default=2)
    p.add_argument("--warmup_step", type=int, default=200)
    p.add_argument("--p_weight", type=float, default=0.02)
    p.add_argument("--p_weight_method", default="exponential_decay")
    p.add_argument("--p_weight_exp_decay", type=float, default=0.4)
    p.add_argument("--n_causal_mask", type=int, default=50)
    p.add_argument("--update_interval", type=int, default=1000)
    p.add_argument("--affinity_func", default="minus")
    p.add_argument("--old_matrix_weight", type=float, default=0.0)
    p.add_argument("--use_metric", default="loss", choices=["loss", "auc"])
    # cdc-plus extensions (defaults = reference-exact procedure; see
    # docs/MIGRATION.md + docs/RESULTS.md "Conflict ablation")
    p.add_argument("--probe_eval_batches", type=int, default=1,
                   help="average counterfactual probe evals over this "
                        "many batches per domain (1 = reference)")
    p.add_argument("--mask_ema", type=float, default=0.0,
                   help="EMA weight for the mask matrix across updates "
                        "(0 = reference: rebuilt from single probes)")
    p.add_argument("--freeze_after_updates", type=int, default=0,
                   help="stop re-clustering after N matrix updates "
                        "(0 = reference: re-cluster at every boundary)")
    p.add_argument("--parallel_rows", type=int, default=0,
                   help="populate N counterfactual matrix rows per vmapped "
                        "dispatch with per-row Adam-moment copies (0 = "
                        "reference: serial rows, moments carried across)")
    # target re-assignment mode (cdc.py:121 update_group(mode=...))
    p.add_argument("--cluster_mode", default="iterative",
                   choices=["iterative", "greedy"])
    # where the CDC train split lives (CDCConfig.data_placement):
    # resident=HBM, stream=host-RAM windows (beyond-HBM datasets),
    # auto=resident while it fits the budget
    p.add_argument("--data_placement", default="auto",
                   choices=["auto", "resident", "stream"])
    # synthetic-data knobs
    p.add_argument("--n_domain", type=int, default=6)
    p.add_argument("--n_rows", type=int, default=50000)
    p.add_argument("--log_path", default=None)
    # mirror scalar metrics to wandb when the package is installed
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--wandb_project", default="tpurec")
    # device mesh: data x model axes over the launch's ranks.  mesh_data=0
    # means "all remaining ranks after mesh_model"; -1 disables the mesh
    # even under a launcher; with 1 rank no mesh is built.
    p.add_argument("--mesh_data", type=int, default=0)
    p.add_argument("--mesh_model", type=int, default=1)
    # shard MoE expert banks (MMoE/PLE/HiNet) over the model axis too
    p.add_argument("--mesh_expert_parallel", action="store_true")
    # performance knobs (TrainConfig)
    p.add_argument("--embedding_update", default="hybrid",
                   choices=["hybrid", "dense", "sparse"])
    p.add_argument("--embedding_moments_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    # on-device histogram eval (Trainer.evaluate_streaming) instead of
    # gathering predictions to host
    # tri-state: unset = auto (streaming iff mesh), explicit on/off wins
    p.add_argument("--eval_streaming", action=argparse.BooleanOptionalAction,
                   default=None)
    # where the port runs: the card unless the caller names the CPU
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    if args.is_set_seed == 0:
        # unique seed from all args (main.py:43-47); --device is left out,
        # so the seed is the JAX package's for the same argv
        items = [kv for kv in vars(args).items() if kv[0] != "device"]
        args.seed = hash(frozenset(items)) % 10000
        args.is_set_seed = 1
    return args


def build_config(args: argparse.Namespace) -> Config:
    return Config(
        model=ModelConfig(
            model=args.model, embed_dim=args.embed_dim, l2_reg=args.l2_reg,
            embed_init_std=args.embed_init_std,
        ),
        cdc=CDCConfig(
            base_model=args.base_model, n_cluster=args.n_cluster,
            n_causal_mask=args.n_causal_mask, warmup_step=args.warmup_step,
            update_matrix_step=args.update_matrix_step,
            update_interval=args.update_interval, p_weight=args.p_weight,
            p_weight_method=args.p_weight_method,
            p_weight_exp_decay=args.p_weight_exp_decay,
            affinity_func=args.affinity_func,
            old_matrix_weight=args.old_matrix_weight,
            use_metric=args.use_metric,
            cluster_mode=args.cluster_mode,
            data_placement=args.data_placement,
            probe_eval_batches=args.probe_eval_batches,
            mask_ema=args.mask_ema,
            freeze_after_updates=args.freeze_after_updates,
            parallel_rows=args.parallel_rows,
        ),
        train=TrainConfig(
            lr=args.lr, bs=args.bs, epoch=args.epoch, seed=args.seed,
            embedding_update=args.embedding_update,
            embedding_moments_dtype=args.embedding_moments_dtype,
            compute_dtype=args.compute_dtype,
            eval_streaming=args.eval_streaming,
        ),
        data=DataConfig(
            dataset_name=args.dataset_name, data_path=args.data_path,
            n_domain=args.n_domain, n_rows=args.n_rows,
            group_strategy=args.group_strategy,
            prepare2train_month=args.prepare2train_month,
            domain_filter=(
                tuple(__import__("ast").literal_eval(args.domain_filter))
                if args.domain_filter else None
            ),
            hash_buckets=(
                tuple(sorted(
                    (int(k), int(v)) for k, v in
                    __import__("ast").literal_eval(args.hash_buckets).items()))
                if args.hash_buckets else None
            ),
        ),
        mesh=MeshConfig(
            n_data=max(args.mesh_data, 1), n_model=max(args.mesh_model, 1),
            expert_parallel=args.mesh_expert_parallel,
        ),
    )


def load_dataset(cfg: Config):
    """-> (train, valid, test, field_dims, n_domain, domain_idx)."""
    dc = cfg.data
    if dc.dataset_name == "synthetic":
        from tpurec_torch.data import make_synthetic

        data = make_synthetic(
            n_rows=dc.n_rows, n_domain=dc.n_domain, seed=cfg.train.seed
        )
        return (data.train, data.valid, data.test, data.field_dims,
                data.n_domain, data.domain_idx)

    import pandas as pd

    if dc.dataset_name == "amazon":
        from tpurec_torch.data.preprocess import AmazonPreprocessor

        pre = AmazonPreprocessor(dc.data_path, dc.prepare2train_month)
        path = pre.preprocess_path
        feature_names = ["userid", "itemid", "weekday", "domain",
                         "sales_chart", "sales_rank", "brand", "price"]
        label, split_col = "label", "timestamp"
    elif dc.dataset_name == "aliccp":
        from tpurec_torch.data.preprocess import AliCCPPreprocessor

        pre = AliCCPPreprocessor(dc.data_path)
        path = pre.preprocess_path
        feature_names = ["userid", "121", "122", "124", "125", "126", "127",
                         "128", "129", "itemid", "domain", "207", "210",
                         "216", "508", "509", "702", "853", "109_14",
                         "110_14", "127_14", "150_14", "301"]
        label, split_col = "click", "train_tag"
    else:
        raise ValueError(f"unknown dataset {dc.dataset_name!r}")

    df = pd.read_csv(path, usecols=feature_names + [label, split_col])
    X = df[feature_names].values.astype(np.int32)
    y = df[label].values.astype(np.float32)
    domain_idx = feature_names.index("domain")
    field_dims = tuple(int(v) + 1 for v in X.max(axis=0))
    n_domain = int(df["domain"].nunique())
    if dc.dataset_name == "amazon":
        # timestamp-quantile split 0.9/0.95 (run.py:116)
        ts = df[split_col].values
        q90, q95 = np.quantile(ts, 0.9), np.quantile(ts, 0.95)
        tr, va, te = ts < q90, (ts >= q90) & (ts < q95), ts >= q95
    else:
        tag = df[split_col].values
        tr, va, te = tag == 0, tag == 1, tag == 2
    return ((X[tr], y[tr]), (X[va], y[va]), (X[te], y[te]),
            field_dims, n_domain, domain_idx)


def _launched() -> bool:
    """Whether a launcher (torch.distributed.run) started this process."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def resolve_mesh(args):
    """The (n_data, n_model) the flags ask for, or None for no mesh
    (``tpurec/cli.py:299-328`` with the launch's ranks as its devices).
    Exits with a message where the request cannot be met."""
    launched = _launched()
    if launched:
        n_dev = int(os.environ["WORLD_SIZE"])
    else:
        n_dev = torch.cuda.device_count() if args.device == "cuda" else 1
    explicit = args.mesh_data > 0 or args.mesh_model > 1
    if args.mesh_data < 0 or not (explicit or n_dev > 1):
        return None
    n_model = max(args.mesh_model, 1)
    n_data = args.mesh_data if args.mesh_data > 0 else max(n_dev // n_model, 1)
    n_use = n_data * n_model
    if n_use > n_dev:
        # an EXPLICIT request that can't be satisfied must fail loudly —
        # silently training unsharded would hide a misconfiguration
        raise SystemExit(
            f"--mesh_data {n_data} x --mesh_model {n_model} needs "
            f"{n_use} devices, have {n_dev}")
    if n_use == 1:
        return None
    if not launched:
        raise SystemExit(
            f"a mesh of --mesh_data {n_data} x --mesh_model {n_model} runs "
            f"one process a rank: launch with python -m "
            f"torch.distributed.run --nproc_per_node {n_use} -m "
            f"tpurec_torch.cli ..., or pass --mesh_data -1 to train on one "
            f"device")
    if n_use != n_dev:
        raise SystemExit(
            f"--mesh_data {n_data} x --mesh_model {n_model} uses {n_use} of "
            f"the launch's {n_dev} ranks: a mesh takes every rank")
    return n_data, n_model


def _shared_seed(args, device) -> None:
    """Rank 0's seed on every rank (each process salts its str hashes)."""
    from tpurec_torch.parallel.collectives import broadcast_

    t = torch.tensor([args.seed], dtype=torch.int64, device=device)
    args.seed = int(broadcast_(t, 0))


def main(argv=None):
    args = parse_args(argv)
    shape = resolve_mesh(args)
    # a mesh's rank tears down the group it joined once it is done (left
    # to interpreter exit, a rank can abort there, or hang under NCCL)
    owned = shape is not None and not torch.distributed.is_initialized()
    try:
        return _main(args, shape)
    finally:
        if owned:
            from tpurec_torch.parallel import shutdown_distributed

            shutdown_distributed()


def _main(args, shape):
    mesh = shardings = None
    rank0 = True
    if shape is not None:
        from tpurec_torch.parallel import Shardings, init_distributed, make_mesh

        joined = init_distributed(args.device)
        _shared_seed(args, joined.device)
        mesh = make_mesh(*shape, device=joined.device)
        shardings = Shardings(mesh,
                              expert_parallel=args.mesh_expert_parallel)
        rank0 = mesh.rank == 0
    cfg = build_config(args)
    if mesh is not None:
        # record the RESOLVED mesh (mesh_data=0 means auto) so the config
        # serialized into checkpoints describes the actual run
        import dataclasses

        cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, n_data=shape[0], n_model=shape[1]))
    resolve_device(args.device)     # no card: fail before loading data
    np.random.seed(cfg.train.seed)

    train, valid, test, field_dims, n_domain, domain_idx = load_dataset(cfg)

    if cfg.data.domain_filter:
        # keep only the listed domains, re-encode contiguously (run.py:120-123)
        keep = np.asarray(sorted(cfg.data.domain_filter))
        remap = -np.ones(int(keep.max()) + 1, np.int32)
        remap[keep] = np.arange(len(keep))

        def _filt(split):
            X, y = split
            m = np.isin(X[:, domain_idx], keep)
            X = X[m].copy()
            X[:, domain_idx] = remap[X[:, domain_idx]]
            return X, y[m]

        train, valid, test = _filt(train), _filt(valid), _filt(test)
        n_domain = len(keep)
        field_dims = tuple(
            n_domain if i == domain_idx else d for i, d in enumerate(field_dims)
        )

    if cfg.data.hash_buckets:
        # feature hashing (tpurec_torch.data.hashing): cap selected fields'
        # vocabularies at fixed bucket counts.  The spec rides in cfg (and
        # therefore in checkpoints) so serving hashes raw ids identically.
        from tpurec_torch.data import apply_hash_trick

        buckets = dict(cfg.data.hash_buckets)
        if domain_idx in buckets:
            raise SystemExit("--hash_buckets must not hash the domain field")
        new = []
        for X, y in (train, valid, test):
            X2, dims2 = apply_hash_trick(X, field_dims, buckets)
            new.append((X2, y))
        train, valid, test = new
        field_dims = dims2

    from tpurec_torch.utils.logging import JsonlLogger

    logger = JsonlLogger(args.log_path)
    log_fn = logger
    if mesh is not None:
        log_fn({"mesh": [mesh.n_data, mesh.n_model], "ranks": mesh.size,
                "backend": mesh.backend, "device": str(mesh.device),
                "seed": cfg.train.seed})
    if args.wandb and rank0:
        # optional wandb mirror (the reference logs through wandb,
        # main.py:79-80); gated on the package being installed
        try:
            import wandb
        except ImportError:
            print("WARNING: --wandb requested but wandb is not installed; "
                  "logging to JSONL only.", flush=True)
        else:
            from tpurec_torch.config import config_to_dict

            wandb.init(project=args.wandb_project,
                       config=config_to_dict(cfg))

            def log_fn(rec, _jsonl=logger):
                _jsonl(rec)
                wandb.log({k: v for k, v in rec.items()
                           if isinstance(v, (int, float))})

    if "cdc" in cfg.model.model:
        from tpurec_torch.cdc import CDCTrainer

        tr = CDCTrainer(cfg, field_dims, n_domain, domain_idx, mesh=mesh,
                        shardings=shardings,
                        device=None if mesh is not None else args.device)
        if args.resume:
            tr.load_checkpoint(args.resume)
        out = tr.fit(train, valid, test=test, log_fn=log_fn)
    else:
        from tpurec_torch.train import Trainer

        strategy = DOMAIN2GROUP_ORG_DICT.get(cfg.data.dataset_name, {}).get(
            cfg.data.group_strategy
        )
        if strategy is None:
            strategy = (
                list(range(n_domain)) if cfg.data.group_strategy == "split"
                else [0] * n_domain
            )
        tr = Trainer(cfg, field_dims, n_domain, domain_idx,
                     domain2group=strategy[:n_domain], mesh=mesh,
                     shardings=shardings,
                     device=None if mesh is not None else args.device)
        if args.resume:
            tr.load_checkpoint(args.resume)
        out = tr.fit(train, valid, test=test, log_fn=log_fn)

    # persist the best model (fit already reloaded it) as a self-describing
    # checkpoint so `python -m tpurec_torch.serve --ckpt ...` needs nothing
    # else
    # (the reference saves on every improvement, run.py:447-459; one final
    # save of the reloaded best is equivalent and avoids N stale files)
    if args.save_path:
        os.makedirs(args.save_path, exist_ok=True)
        ckpt = os.path.join(
            args.save_path,
            f"{cfg.model.model}_{cfg.data.dataset_name}_seed{cfg.train.seed}.pkl")
        tr.save_checkpoint(ckpt, extra={"result": _jsonable(out)})
        out["checkpoint"] = ckpt

    if rank0:
        print(json.dumps(_jsonable(out), default=str))
    return out


def _jsonable(d):
    if isinstance(d, dict):
        return {str(k): _jsonable(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [_jsonable(v) for v in d]
    if isinstance(d, (np.floating, np.integer)):
        return float(d)
    return d


if __name__ == "__main__":
    main()

"""Rank process of the port's mesh tests (tests/test_torch_parallel_*.py,
tests/test_torch_cdc_mesh*.py, tests/test_torch_cli_mesh*.py), and the
launcher that starts the ranks.

:func:`spawn` starts ``world`` copies of this script on the CPU, joined
over gloo on a free localhost port (``RANK``/``WORLD_SIZE``/
``MASTER_ADDR``/``MASTER_PORT``, as ``torch.distributed.run`` sets
them); each runs one task, which runs every case of its test file and
writes its results (``.npz``/JSON) under the output directory for the
tests to read.  The ``cli`` task runs ``tpurec_torch.cli.main`` with
dropout 0 (the CLI has no dropout flag), under ``torch.distributed.run``.

This file has no test functions: its name keeps it among the port's test
files.  It imports nothing of the JAX package.

    python tests/test_torch_mesh_worker.py <task> <out_dir> [args...]
"""

import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# tests/test_sharding.py's MMoE, with a big field (> 8192 rows) so that
# the table update has rows as well as the small-field prefix
FIELD_DIMS = (64, 48, 16, 8, 24, 9000)
DOMAIN_IDX = 3
N_DOMAIN = 8
N_TOWER = 2
D2G = np.arange(N_DOMAIN) % N_TOWER
BS = 64
MODEL = dict(model="mmoe", embed_dim=8, mmoe_expert_dims=(16, 8),
             mmoe_tower_dims=(8,), use_atten=True, atten_embed_dim=8,
             att_layer_num=1, dropout=0.0)
STEPS = 4
UPDATES = ("hybrid", "dense", "sparse")
# one step of the models with the other batch-coupled reductions
OTHERS = {"star": dict(model="star", embed_dim=8, tower_dims=(16, 8),
                       use_atten=False, dropout=0.0),
          "adl": dict(model="adl", embed_dim=8, tower_dims=(16, 8),
                      use_atten=False, dropout=0.0)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# what a rank that leaves its process group to interpreter exit can print
EXIT_FAULTS = ("terminate called", "process group has NOT been destroyed")


def spawn(task, world, out_dir, *args, timeout=300, torchrun=False):
    """Run ``task`` on ``world`` ranks; raise with every log's tail unless
    all exit 0 and no log shows an exit fault (:data:`EXIT_FAULTS`).
    ``torchrun``: one ``python -m torch.distributed.run`` starts them
    (``args`` then follow the script)."""
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("PYTHONHASHSEED", None)
    port = _free_port()
    me = os.path.abspath(__file__)
    if torchrun:
        cmds = [[sys.executable, "-m", "torch.distributed.run",
                 "--nnodes", "1", "--nproc_per_node", str(world),
                 "--master_addr", "127.0.0.1", "--master_port", str(port),
                 me, task, str(out_dir), *map(str, args)]]
        envs = [env]
    else:
        cmds, envs = [], []
        for r in range(world):
            cmds.append([sys.executable, me, task, str(out_dir),
                         *map(str, args)])
            envs.append(dict(env, RANK=str(r), WORLD_SIZE=str(world),
                             LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                             MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
    procs, logs = [], []
    for i, (cmd, e) in enumerate(zip(cmds, envs)):
        log = open(os.path.join(out_dir, f"{task}_{i}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=e, stdout=log,
                                      stderr=subprocess.STDOUT))
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    texts = []
    for i in range(len(procs)):
        with open(os.path.join(out_dir, f"{task}_{i}.log")) as f:
            texts.append(f.read())
    torn = [i for i, t in enumerate(texts)
            if any(s in t for s in EXIT_FAULTS)]
    if any(rcs) or torn:
        tails = [f"--- {task} {i} (rc={rcs[i]}) ---\n"
                 + "".join(t.splitlines(True)[-40:])
                 for i, t in enumerate(texts)]
        raise AssertionError(f"{task} failed (rcs={rcs}; a rank's exit "
                             f"fault in {torn})\n" + "\n".join(tails))
    return rcs


# ---------------------------------------------------------------- shared

def config(update="hybrid", model=None, **train):
    from tpurec_torch.config import Config, ModelConfig, TrainConfig

    return Config(model=ModelConfig(**(model or MODEL)),
                  train=TrainConfig(**{"bs": BS, "wd": 1e-8,
                                       "embedding_update": update,
                                       **train}))


def global_batches(n=STEPS, seed=0):
    """``n`` global batches (numpy) of BS rows, the last rows of each
    masked."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = np.stack([rng.integers(0, d, BS) for d in FIELD_DIMS],
                     1).astype(np.int32)
        x[: BS // 4, 5] = rng.integers(0, 5, BS // 4)   # repeated big rows
        mask = np.ones(BS, np.float32)
        mask[BS - 3 - i:] = 0.0
        out.append({"x": x, "y": rng.integers(0, 2, BS).astype(np.float32),
                    "group": D2G[x[:, DOMAIN_IDX]].astype(np.int32),
                    "mask": mask})
    return out


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            t = v
            if hasattr(t, "detach"):
                import torch

                t = t.detach().to("cpu", torch.float32).numpy()
            out[f"{prefix}{k}"] = np.asarray(t)
    return out


def trainer(cfg, mesh=None, field_dims=FIELD_DIMS, n_domain=N_DOMAIN,
            d2g=D2G):
    from tpurec_torch.train import Trainer

    return Trainer(cfg, field_dims, n_domain, DOMAIN_IDX, domain2group=d2g,
                   mesh=mesh, device=None if mesh is not None else "cpu")


def run_steps(tr, batches, rows=None):
    """The trainer's single step on each batch (its rows ``rows``) ->
    losses."""
    import torch

    losses = []
    for b in batches:
        if rows is not None:
            b = {k: v[rows] for k, v in b.items()}
        losses.append(float(tr.train_step(
            tr.state, {k: torch.from_numpy(v) for k, v in b.items()},
            tr.dropout_gen)))
    return losses


def _join():
    import torch

    from tpurec_torch.parallel import init_distributed

    torch.set_num_threads(1)
    return init_distributed("cpu")


def _rows(mesh, bs=BS):
    bl = bs // mesh.n_data
    return slice(mesh.d * bl, (mesh.d + 1) * bl)


# ---------------------------------------------------------------- tasks

def task_steps(out_dir):
    """4 steps under each update on every mesh of this world, and one
    step of STAR and ADL on (world, 1): losses and the whole state
    (gathered) from rank 0."""
    from tpurec_torch.convert import train_state_to_flax
    from tpurec_torch.parallel import make_mesh

    j = _join()
    shapes = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}[j.world]
    res = {}
    for shape in shapes:
        mesh = make_mesh(*shape)
        for upd in UPDATES:
            tr = trainer(config(upd), mesh)
            losses = run_steps(tr, global_batches(), _rows(mesh))
            state = flat(train_state_to_flax(tr.state))
            if j.rank == 0:
                key = f"{upd}_{shape[0]}x{shape[1]}"
                res.update({f"{key}/{k}": v for k, v in state.items()})
                res[f"{key}/losses"] = np.asarray(losses)
        if shape[1] == 1 and j.world == 2:
            for name, kw in OTHERS.items():
                tr = trainer(config(model=kw), mesh)
                losses = run_steps(tr, global_batches(1), _rows(mesh))
                state = flat(train_state_to_flax(tr.state))
                if j.rank == 0:
                    res.update({f"{name}/{k}": v for k, v in state.items()})
                    res[f"{name}/losses"] = np.asarray(losses)
    if j.rank == 0:
        np.savez(os.path.join(out_dir, f"steps_{j.world}.npz"), **res)


def lookup_inputs(n_rows=40):
    """(table [V, D] float32, ids [n_rows, F] int32 field-local with
    out-of-range ones, weights of the test loss [n_rows, F, D])."""
    from tpurec_torch.nn.core import EmbeddingLayout

    rng = np.random.default_rng(3)
    layout = EmbeddingLayout(FIELD_DIMS)
    table = rng.normal(size=(layout.vocab, 8)).astype(np.float32)
    ids = np.stack([rng.integers(0, d, n_rows) for d in FIELD_DIMS],
                   1).astype(np.int32)
    ids[0, 0] = -1                   # wraps inside the small prefix
    ids[1, 5] = 10**8                # past the table: NaN
    ids[2, 1] = 9999                 # past the small prefix: NaN
    ids[3, 5] = -5                   # wraps over the whole table
    ids[4:12, 5] = ids[4, 5]         # a row read many times
    w = rng.normal(size=(n_rows, len(FIELD_DIMS), 8)).astype(np.float32)
    return layout, table, ids, w


def task_lookup(out_dir):
    """Mesh coordinates and groups; the collectives' backward rules; the
    windowed gather and sharded_embedding_lookup, with their table
    gradients, on every mesh of this world."""
    import torch
    import torch.distributed as dist

    from tpurec_torch.ops.embedding import EmbeddingGather
    from tpurec_torch.parallel import make_mesh
    from tpurec_torch.parallel.collectives import (all_reduce_,
                                                   data_all_reduce,
                                                   model_all_reduce)
    from tpurec_torch.parallel.embedding import (shard_table,
                                                 sharded_embedding_lookup)

    j = _join()
    shapes = {2: [(2, 1), (1, 2)], 4: [(2, 2), (4, 1), (1, 4)]}[j.world]
    layout, table, ids, w = lookup_inputs()
    res = {}
    for shape in shapes:
        mesh = make_mesh(*shape)
        key = f"{shape[0]}x{shape[1]}"
        t = torch.tensor([float(j.rank)])
        d_sum = float(all_reduce_(t.clone(), mesh.data_group))
        m_sum = float(all_reduce_(t.clone(), mesh.model_group))
        # backward rules: y = AR(c x); loss = k y
        c, k = 3.0, float(j.rank + 1)
        x = torch.tensor(1.0, requires_grad=True)
        (k * model_all_reduce(c * x, mesh)).backward()
        gm = float(x.grad)
        x = torch.tensor(1.0, requires_grad=True)
        (k * data_all_reduce(c * x, mesh)).backward()
        gd = float(x.grad)
        res[f"{key}/coords"] = [mesh.d, mesh.m, list(mesh.data_ranks),
                                list(mesh.model_ranks), d_sum, m_sum,
                                gm, gd]
        # the lookup: this data rank's rows of ids, the table's layout
        rows = slice(mesh.d * len(ids) // mesh.n_data,
                     (mesh.d + 1) * len(ids) // mesh.n_data)
        local, shard = shard_table(torch.from_numpy(table), mesh)
        local.requires_grad_(True)
        out = sharded_embedding_lookup(
            layout.gather(local, window=shard.window),
            torch.from_numpy(ids[rows]), shard)
        torch.nansum(torch.tanh(out) * torch.from_numpy(w[rows])).backward()
        g = all_reduce_(local.grad.clone(), mesh.data_group)
        full_g = shard.gather(g)
        got = shard.exchange(out.detach())[0]
        # global-row ids, no layout (tpurec's sharded_embedding_lookup)
        gids = np.clip(ids + layout.offsets[None], 0, layout.vocab - 1)
        local2, shard2 = shard_table(torch.from_numpy(table), mesh)
        local2.requires_grad_(True)
        F = gids.shape[1]
        out2 = sharded_embedding_lookup(
            EmbeddingGather(local2, torch.zeros(F, dtype=torch.int32),
                            torch.full((F,), shard2.V, dtype=torch.int32),
                            row_lo=shard2.row_lo, n_table_rows=shard2.V),
            torch.from_numpy(gids[rows].astype(np.int32)), shard2)
        torch.sum(torch.tanh(out2) * torch.from_numpy(w[rows])).backward()
        g2 = shard2.gather(all_reduce_(local2.grad.clone(),
                                       mesh.data_group))
        got2 = shard2.exchange(out2.detach())[0]
        if j.rank == 0:
            res[f"{key}/rows"] = got.numpy()
            res[f"{key}/grad"] = full_g.numpy()
            res[f"{key}/rows_global"] = got2.numpy()
            res[f"{key}/grad_global"] = g2.numpy()
            res[f"{key}/shape"] = [shard.V, shard.V_pad, shard.n_local]
        coords = [None] * j.world
        dist.all_gather_object(coords, res[f"{key}/coords"])
        res[f"{key}/coords"] = coords
    if j.rank == 0:
        np.savez(os.path.join(out_dir, f"lookup_{j.world}.npz"),
                 **{k: np.asarray(v, dtype=object if k.endswith("coords")
                                  else None) for k, v in res.items()})


# the Trainer tests' data: a big field (9000 rows) and 4 domains
FIT_DIMS = (60, 9000, 30, 4, 20, 12)
FIT_MODEL = dict(model="mmoe", embed_dim=8, mmoe_expert_dims=(16,),
                 mmoe_tower_dims=(8,), use_atten=True, atten_embed_dim=8,
                 att_layer_num=1, dropout=0.0, embed_init_std=0.01)
FIT_BS = 256


def fit_config(**train):
    from tpurec_torch.config import Config, ModelConfig, TrainConfig

    kw = dict(bs=FIT_BS, epoch=1, seed=0, steps_per_dispatch=4, wd=1e-8)
    kw.update(train)
    return Config(model=ModelConfig(**FIT_MODEL), train=TrainConfig(**kw))


def fit_data():
    from tpurec_torch.data import make_synthetic

    return make_synthetic(n_rows=3000, n_fields=len(FIT_DIMS),
                          field_dims=FIT_DIMS, n_domain=4,
                          domain_idx=3, seed=5)


def fit_trainer(cfg, mesh=None):
    from tpurec_torch.train import Trainer

    return Trainer(cfg, FIT_DIMS, 4, 3, domain2group=np.arange(4),
                   mesh=mesh, device=None if mesh is not None else "cpu")


def record_steps(tr):
    """Make ``tr``'s step loops keep their losses in ``tr.step_losses``."""
    tr.step_losses = []
    for name in ("scan_steps_idx", "scan_steps", "train_step"):
        fn = getattr(tr, name)
        if fn is None:
            continue

        def rec(*a, _fn=fn, **k):
            out = _fn(*a, **k)
            tr.step_losses.extend(np.atleast_1d(
                out.detach().cpu().numpy()).tolist())
            return out
        setattr(tr, name, rec)
    return tr


def task_trainer(out_dir):
    """4 ranks: one fit epoch on (2, 2) (per-step losses, the result, the
    exact eval, the gathered state) and a pickle checkpoint from rank 0.
    2 ranks: tpurec's checkpoint (``tpurec.pkl``) onto (1, 2) and its
    exact eval; then train_epoch_multihost and evaluate_streaming_multihost
    on (2, 1), each rank feeding its own dataset range, a surplus of eval
    rows, and the host-batching epoch (the "dense" update) on (2, 1)."""
    from tpurec_torch.convert import train_state_to_flax
    from tpurec_torch.parallel import make_mesh

    j = _join()
    data = fit_data()
    res = {}
    if j.world == 4:
        mesh = make_mesh(2, 2)
        tr = record_steps(fit_trainer(fit_config(), mesh))
        out = tr.fit(data.train, data.valid,
                     domain_cnt_weight=data.domain_cnt_weight())
        exact = tr.evaluate(*data.valid, data.domain_cnt_weight())
        pred = tr.predict(data.valid[0])
        state = flat(train_state_to_flax(tr.state))
        tr.save_checkpoint(os.path.join(out_dir, "mesh.pkl"))
        if j.rank == 0:
            res.update({f"fit/{k}": v for k, v in state.items()})
            res["fit/losses"] = np.asarray(tr.step_losses)
            res["fit/pred"] = pred
            for k in ("total_auc", "total_loss", "mean_auc"):
                res[f"fit/valid_{k}"] = out["valid"][k]
                res[f"fit/exact_{k}"] = exact[k]
    else:
        mesh = make_mesh(1, 2)
        tr = fit_trainer(fit_config(), mesh)
        tr.load_checkpoint(os.path.join(out_dir, "tpurec.pkl"))
        ev = tr.evaluate(*data.valid, data.domain_cnt_weight())
        if j.rank == 0:
            res["load/total_auc"] = ev["total_auc"]
            res["load/total_loss"] = ev["total_loss"]
        mesh = make_mesh(2, 1)
        tr = record_steps(fit_trainer(fit_config(), mesh))
        X, y = data.train
        lo, hi = tr.feed.dataset_range(len(X))
        loss = tr.train_epoch_multihost(X[lo:hi], y[lo:hi], len(X), 0)
        Xv, yv = data.valid
        vlo, vhi = tr.feed.dataset_range(len(Xv))
        ev = tr.evaluate_streaming_multihost(
            Xv[vlo:vhi], yv[vlo:vhi], len(Xv), data.domain_cnt_weight())
        try:
            tr.evaluate_streaming_multihost(Xv, yv, len(Xv) // 2)
            surplus = ""
        except ValueError as e:
            surplus = str(e)
        state = flat(train_state_to_flax(tr.state))
        # the host-batching epoch (the "dense" update's) on (2, 1)
        hb = record_steps(fit_trainer(fit_config(embedding_update="dense"),
                                      mesh))
        hb.train_epoch(X, y, 0)
        host = flat(train_state_to_flax(hb.state))
        if j.rank == 0:
            res.update({f"host/{k}": v for k, v in host.items()})
            res["host/losses"] = np.asarray(hb.step_losses)
            res.update({f"mh/{k}": v for k, v in state.items()})
            res["mh/loss"] = loss
            res["mh/losses"] = np.asarray(tr.step_losses)
            res["mh/surplus"] = surplus
            for k in ("total_auc", "total_loss", "mean_auc"):
                res[f"mh/eval_{k}"] = ev[k]
    if j.rank == 0:
        np.savez(os.path.join(out_dir, f"trainer_{j.world}.npz"), **res)


def task_ckpt(out_dir):
    """2 ranks: 3 saves of a (1, 2) trainer through the async backend
    (``max_to_keep`` 2), then step 3 restored onto (2, 1) and saved there
    as step 4; the gathered states of both and what the step-4 directory
    holds, from rank 0."""
    import torch.distributed as dist

    from tpurec_torch.convert import train_state_to_flax
    from tpurec_torch.parallel import make_mesh

    j = _join()
    cfg = fit_config(checkpoint_backend="orbax")
    data = fit_data()
    X, y = data.train
    tr = fit_trainer(cfg, make_mesh(1, 2))
    be = tr.make_checkpointer(os.path.join(out_dir, "ck"), max_to_keep=2)
    for step in (1, 2, 3):
        tr.train_epoch(X[: FIT_BS * step], y[: FIT_BS * step], step)
        tr.save_versioned(be, step, extra={"s": step})
    be.wait_until_finished()
    saved = flat(train_state_to_flax(tr.state))
    tr2 = fit_trainer(cfg, make_mesh(2, 1))
    meta = tr2.load_versioned(tr2.make_checkpointer(
        os.path.join(out_dir, "ck")), step=3)
    loaded = flat(train_state_to_flax(tr2.state))
    # a save on (2, 1), where data rank 1 writes no file
    be2 = tr2.make_checkpointer(os.path.join(out_dir, "ck21"))
    tr2.save_versioned(be2, 4)
    be2.wait_until_finished()
    dist.barrier()
    if j.rank == 0:
        res = {f"saved/{k}": v for k, v in saved.items()}
        res["ck21"] = np.asarray(sorted(os.listdir(os.path.join(out_dir,
                                                                "ck21"))))
        res.update({f"loaded/{k}": v for k, v in loaded.items()})
        res["steps"] = np.asarray(sorted(be.all_steps()))
        res["extra"] = json.dumps(meta["extra"])
        np.savez(os.path.join(out_dir, "ckpt.npz"), **res)


def task_cli(out_dir, *argv):
    """One rank of ``tpurec_torch.cli.main(argv)`` under
    torch.distributed.run, with dropout 0; writes the seed its config
    took (``seed_<rank>.json``) and its steps' losses
    (``losses_<rank>.json``)."""
    import torch

    from tpurec_torch import cli

    torch.set_num_threads(1)
    build = cli.build_config

    def no_dropout(args):
        cfg = build(args)
        rank = os.environ.get("RANK", "0")
        with open(os.path.join(out_dir, f"seed_{rank}.json"), "w") as f:
            json.dump(cfg.train.seed, f)
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, dropout=0.0))

    cli.build_config = no_dropout
    losses = record_losses()
    cli.main(list(argv))
    with open(os.path.join(out_dir, f"losses_{os.environ['RANK']}.json"),
              "w") as f:
        json.dump(losses, f)


def record_losses(patch=setattr):
    """Make the hybrid step append each step's loss to the returned list
    (``patch``: how to set the attribute, e.g. a monkeypatch's)."""
    from tpurec_torch.train import hybrid

    losses = []
    one_step = hybrid.HybridTrainStep.one_step

    def recorded(self, *args, **kwargs):
        loss = one_step(self, *args, **kwargs)
        losses.append(float(loss))
        return loss

    patch(hybrid.HybridTrainStep, "one_step", recorded)
    return losses


# ------------------------------------------------------- expert parallelism

EP_WD = 1e-3            # the parameters' check (see test_torch_parallel_expert)
EP_MODELS = {
    "mmoe": MODEL,
    "ple": dict(model="ple", embed_dim=8, ple_expert_dims=((16, 8), (8,)),
                ple_tower_dims=(8,), use_atten=False, dropout=0.0),
    "hinet": dict(model="hinet", embed_dim=8, sei_dims=(16, 8),
                  tower_dims=(8,), use_atten=False, dropout=0.0),
}
EP_STEPS = 3
# the L2 of a bank's shared BatchNorm scale, which the models leave at 0
BN_SCALE_L2 = 0.05


def ep_trainer(cfg, mesh=None, expert_parallel=True):
    from tpurec_torch.parallel import Shardings
    from tpurec_torch.train import Trainer

    sh = None if mesh is None else Shardings(mesh,
                                             expert_parallel=expert_parallel)
    return Trainer(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX, domain2group=D2G,
                   shardings=sh, device=None if mesh is not None else "cpu")


def ep_forwards(tr, batch, rows, mesh):
    """(eval logits, training logits with dropout 0, training logits at
    the model's dropout) of ``tr.model`` on this data rank's ``rows``."""
    import torch

    from tpurec_torch.parallel.collectives import mesh_scope

    b = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    out = []
    with torch.no_grad():
        tr.model.eval()
        out.append(tr.model(b["x"], group=b["group"]))
        tr.model.train()
        gen = torch.Generator().manual_seed(7)
        with mesh_scope(mesh):
            out.append(tr.model(b["x"], group=b["group"], train=True,
                                row_mask=b["mask"], generator=gen))
    return [o.numpy() for o in out]


def bn_scale_grads(tr, batch, rows, bank="experts"):
    """One hybrid loss_and_grads with the bank's BatchNorm scale given an
    L2 coefficient -> (loss, the scale's gradient, the bank's first
    weight's gradient gathered over the model group)."""
    import torch

    from tpurec_torch.train.hybrid import HybridTrainStep

    coefs = dict(tr.reg_coefs)
    coefs[f"{bank}.bn_0.scale"] = BN_SCALE_L2
    step = HybridTrainStep(tr.model, tr.cfg.train, coefs, True,
                           tr.cfg.model.l2_reg_embedding)
    b = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    loss, _, _ = step.loss_and_grads(tr.state, b, tr.dropout_gen)
    mod = tr.model.get_submodule(bank)
    w = mod.linear_0.weight.grad
    if mod.expert_shard is not None:
        w = mod.expert_shard.gather(w)
    return (float(loss), mod.bn_0.scale.grad.numpy().copy(),
            w.numpy().copy())


def task_expert(out_dir):
    """2 ranks, (1, 2): MMoE, PLE and HiNet with their banks split, each
    rank's leaf shapes and the eval and training forwards (dropout 0 and
    the models' 0.2).  4 ranks, (2, 2): EP_STEPS steps of MMoE under each
    update at EP_WD and the hybrid's at the default wd, the gathered
    states and losses, and the BatchNorm scale's gradient with an L2;
    (1, 4): EP_STEPS hybrid steps of PLE, whose 2 shared experts stay
    whole.  Rank 0 writes ``expert_<world>.npz``."""
    from tpurec_torch.convert import train_state_to_flax
    from tpurec_torch.parallel import make_mesh

    j = _join()
    res = {}
    batches = global_batches(EP_STEPS)
    if j.world == 2:
        mesh = make_mesh(1, 2)
        rows = _rows(mesh)
        for name, kw in EP_MODELS.items():
            for rate in (0.0, 0.2):
                tr = ep_trainer(config(model=dict(kw, dropout=rate)), mesh)
                outs = ep_forwards(tr, batches[0], rows, mesh)
                shapes = {k: list(t.shape)
                          for k, t in tr.model.state_dict().items()}
                if j.rank == 0:
                    for i, o in enumerate(outs):
                        res[f"{name}_{rate}/fwd{i}"] = o
                res[f"{name}_{rate}/shapes_{j.rank}"] = json.dumps(shapes)
        shapes = [None] * j.world
        import torch.distributed as dist

        for key in [k for k in res if k.endswith(f"shapes_{j.rank}")]:
            dist.all_gather_object(shapes, res[key])
            for r, v in enumerate(shapes):
                res[key[:-1] + str(r)] = v
    else:
        mesh = make_mesh(2, 2)
        rows = _rows(mesh)
        for upd in UPDATES:
            for wd in (EP_WD, 1e-8):
                if wd != EP_WD and upd != "hybrid":
                    continue
                tr = ep_trainer(config(upd, wd=wd), mesh)
                losses = run_steps(tr, batches, rows)
                state = flat(train_state_to_flax(tr.state))
                key = f"{upd}_{wd:g}"
                if j.rank == 0:
                    res.update({f"{key}/{k}": v for k, v in state.items()})
                    res[f"{key}/losses"] = np.asarray(losses)
                if wd == EP_WD and upd != "sparse":
                    # the pickle and the async checkpoint, and the
                    # pickle back onto a fresh (2, 2) trainer
                    tr.save_checkpoint(os.path.join(out_dir, f"{key}.pkl"))
                    be = tr.make_checkpointer(os.path.join(out_dir,
                                                           f"{key}_ck"))
                    be.save(1, tr.state)
                    be.wait_until_finished()
                    back = ep_trainer(config(upd, wd=wd), mesh)
                    back.load_checkpoint(os.path.join(out_dir, f"{key}.pkl"))
                    again = flat(train_state_to_flax(back.state))
                    if j.rank == 0:
                        res[f"{key}/reloaded_equal"] = all(
                            np.array_equal(again[k], state[k]) for k in state)
        loss, g_scale, g_w = bn_scale_grads(ep_trainer(config(wd=EP_WD),
                                                       mesh), batches[0],
                                            rows)
        if j.rank == 0:
            res.update({"bn/loss": loss, "bn/scale": g_scale, "bn/w": g_w})
        mesh = make_mesh(1, 4)
        tr = ep_trainer(config(model=EP_MODELS["ple"], wd=EP_WD), mesh)
        split = sorted(n for n, m in tr.model.named_modules()
                       if getattr(m, "expert_shard", None) is not None)
        losses = run_steps(tr, batches, _rows(mesh))
        state = flat(train_state_to_flax(tr.state))
        if j.rank == 0:
            res.update({f"ple14/{k}": v for k, v in state.items()})
            res["ple14/losses"] = np.asarray(losses)
            res["ple14/split"] = json.dumps(split)
    if j.rank == 0:
        np.savez(os.path.join(out_dir, f"expert_{j.world}.npz"), **res)


# ------------------------------------------------------------- CDC's mesh

CDC_DIMS = dict(n_rows=3500, n_fields=6, n_domain=4, domain_idx=3, seed=1,
                domain_cluster_k=2)
CDC_MODEL = dict(model="cdc", embed_dim=8, mlp_dims=(32, 16),
                 atten_embed_dim=8, att_layer_num=1, dropout=0.0)
CDC_CDC = dict(base_model="mmoe", n_cluster=2, n_causal_mask=8,
               warmup_step=1, update_matrix_step=1, update_interval=2,
               cdc_tower_dims=(16,))
CDC_WD = 1e-3           # the probe rows' check (see test_torch_cdc_mesh)
CDC_FEW_MASK_ROWS = 4   # where the clustering of the 4 domains ties
CDC_LANES = 4           # cdc.parallel_rows of the lanes' update


def cdc_data():
    from tpurec_torch.data import make_synthetic

    return make_synthetic(**CDC_DIMS)


def cdc_config(placement="resident", mask_rows=CDC_CDC["n_causal_mask"],
               lanes=0, **train):
    from tpurec_torch.config import CDCConfig, Config, ModelConfig, \
        TrainConfig

    kw = dict(bs=256, epoch=1, seed=0, wd=CDC_WD,
              checkpoint_backend="orbax")
    kw.update(train)
    cdc = {**CDC_CDC, "n_causal_mask": mask_rows, "parallel_rows": lanes}
    return Config(model=ModelConfig(**CDC_MODEL),
                  cdc=CDCConfig(**cdc, data_placement=placement),
                  train=TrainConfig(**kw))


def cdc_trainer(cfg, data, mesh=None, expert_parallel=False):
    from tpurec_torch.cdc import CDCTrainer
    from tpurec_torch.parallel import Shardings

    sh = None if mesh is None else Shardings(mesh,
                                             expert_parallel=expert_parallel)
    return CDCTrainer(cfg, data.field_dims, data.n_domain, data.domain_idx,
                      shardings=sh,
                      device=None if mesh is not None else "cpu")


def cluster_of(tr):
    st = tr.cluster
    return {"mask": st.matrix_mask, "A": st.matrix_A, "B": st.matrix_B,
            "d2g": np.asarray(st.domain2group_list)}


@contextlib.contextmanager
def kmeans_seeds():
    """Record the k-means seed of each clustering the CDC engine runs."""
    import tpurec_torch.cdc.engine as eng

    seeds, orig = [], eng.update_group

    def update_group(st, cfg, w, kmeans_seed=None):
        seeds.append(kmeans_seed)
        return orig(st, cfg, w, kmeans_seed=kmeans_seed)

    eng.update_group = update_group
    try:
        yield seeds
    finally:
        eng.update_group = orig


def clustering_tie(mask, n_cluster, seed, atol, draws=32):
    """The first update's clustering (k-means on the causal distances of
    ``mask``, st.matrix_mask after the affinity transform, with the
    update's seed) of ``mask`` and of ``draws`` copies moved by +-atol
    -> (labels, {labels: count}).  More than one labelling among the
    copies: the clustering is a tie that the tolerance does not decide."""
    from collections import Counter

    from tpurec_torch.cdc.algorithm import calc_causal_matrix, kmeans_group

    def labels(m):
        causal = np.arccos(np.clip(calc_causal_matrix(m.T), -1.0, 1.0))
        return tuple(int(g) for g in kmeans_group(causal, n_cluster,
                                                   seed=seed))

    rng = np.random.default_rng(0)
    moved = Counter(labels(mask + atol * rng.choice((-1.0, 1.0), mask.shape))
                    for _ in range(draws))
    return labels(mask), dict(moved)


def task_cdc(out_dir):
    """4 ranks, (2, 2): one update_matrix_cdc resident and "stream",
    without and with expert parallelism (the matrices and the
    clustering), resident with CDC_FEW_MASK_ROWS (with the k-means
    seed), and resident in CDC_LANES row lanes, without and with expert
    parallelism.  2 ranks, (2, 1): CDCTrainer.fit (two updates), the exact
    valid eval, and the pickle and async checkpoints.  Rank 0 writes
    ``cdc_<world>.npz``."""
    from tpurec_torch.parallel import make_mesh

    j = _join()
    data = cdc_data()
    res = {}
    if j.world == 4:
        mesh = make_mesh(2, 2)
        for ep in (False, True):
            for placement in ("resident", "stream"):
                tr = cdc_trainer(cdc_config(placement), data, mesh, ep)
                tr.setup_data(data.train, data.valid)
                tr.update_matrix_cdc(1)
                key = f"{placement}_{'ep' if ep else 'dp'}"
                res.update({f"{key}/{k}": v
                            for k, v in cluster_of(tr).items()})
                res[f"{key}/resident"] = tr._resident
        for ep in (False, True):
            with kmeans_seeds() as seeds:
                tr = cdc_trainer(cdc_config(mask_rows=CDC_FEW_MASK_ROWS),
                                 data, mesh, ep)
                tr.setup_data(data.train, data.valid)
                tr.update_matrix_cdc(1)
            key = f"few_{'ep' if ep else 'dp'}"
            res.update({f"{key}/{k}": v for k, v in cluster_of(tr).items()})
            res[f"{key}/seeds"] = np.asarray(seeds)
        for ep in (False, True):
            tr = cdc_trainer(cdc_config(lanes=CDC_LANES), data, mesh, ep)
            tr.setup_data(data.train, data.valid)
            tr.update_matrix_cdc(1)
            key = f"lanes_{'ep' if ep else 'dp'}"
            res.update({f"{key}/{k}": v for k, v in cluster_of(tr).items()})
    else:
        mesh = make_mesh(2, 1)
        tr = cdc_trainer(cdc_config(), data, mesh)
        out = tr.fit(data.train, data.valid)
        exact = tr.evaluate(tr.valid_batcher)
        tr.save_checkpoint(os.path.join(out_dir, "cdc_mesh.pkl"))
        be = tr.make_checkpointer(os.path.join(out_dir, "cdc_ck"))
        tr.save_versioned(be, 1, extra={"s": 1})
        be.wait_until_finished()
        if j.rank == 0:
            res["fit/d2g"] = np.asarray(out["domain2group_list"])
            res["fit/s_groups"] = json.dumps(out["s_group2domain_list"])
            for k in ("total_auc", "total_loss"):
                res[f"fit/valid_{k}"] = out["valid"][k]
                res[f"fit/exact_{k}"] = exact[k]
    if j.rank == 0:
        np.savez(os.path.join(out_dir, f"cdc_{j.world}.npz"), **res)


# ------------------------------------------- CDC's cadence on the mesh

CADENCE_BS = 512        # 2-step bursts, a boundary every 2 steps
CADENCE_INTERVAL = 1    # update_interval (units of 1,024 rows)
CADENCE_UPDATES = 3     # freeze_after_updates: the epoch's first three
CADENCE_LANES = 2       # cdc.parallel_rows of the lane fits
CADENCE_BUDGET = 1 << 16  # a mesh budget below the 3,130-row split's 88 kB
CADENCE_FITS = (("resident", 0), ("stream", 0),
                ("resident", CADENCE_LANES), ("stream", CADENCE_LANES))
PARTING_MESHES = ((2, 1), (1, 2))
CADENCE_INIT = "init.msgpack"  # the fits' initial state, flax bytes


def cadence_config(placement="resident", lanes=0):
    """:func:`cdc_config` with CDC_FEW_MASK_ROWS mask rows, bs 512 and an
    update every 2 steps, the first CADENCE_UPDATES of the 7-step
    epoch."""
    cfg = cdc_config(placement, mask_rows=CDC_FEW_MASK_ROWS, lanes=lanes,
                     bs=CADENCE_BS)
    return dataclasses.replace(cfg, cdc=dataclasses.replace(
        cfg.cdc, update_interval=CADENCE_INTERVAL,
        freeze_after_updates=CADENCE_UPDATES))


def cadence_fit(tr, data):
    """``tr.fit`` recording every hybrid step's loss, and after each
    matrix update its matrices, k-means seed and clustering; then the
    gathered final state.  -> record."""
    rec = {"losses": [], "d2g": [], "mask": [], "A": [], "B": []}
    steps, update = tr._steps, tr.update_matrix_cdc

    def steps_(mode, *args):
        out = steps(mode, *args)
        rec["losses"].extend(float(x) for x in out)
        return out

    def update_(k):
        update(k)
        st = tr.cluster
        for m, v in (("mask", st.matrix_mask), ("A", st.matrix_A),
                     ("B", st.matrix_B)):
            rec[m].append(v.copy())
        rec["d2g"].append(list(st.domain2group_list))

    tr._steps, tr.update_matrix_cdc = steps_, update_
    with kmeans_seeds() as seeds:
        tr.fit(data.train, data.valid)
    rec["seeds"] = list(seeds)
    rec["state"] = np.frombuffer(tr.snapshot_bytes(), np.uint8)
    rec["resident"] = tr._resident
    return {k: np.asarray(v) for k, v in rec.items()}


def task_cadence(out_dir):
    """4 ranks, (2, 2), the experts whole (split, they add half again to
    the fits' time on the CPU; ``cdc`` runs one update with them split):
    CDCTrainer.fit with CADENCE_UPDATES matrix updates of
    :func:`cadence_config`, "resident" and "stream", serially and in
    CADENCE_LANES lanes, from the initial state in ``CADENCE_INIT``
    (tpurec's, written by the test), and the placement "auto"
    chooses with the instance's mesh budget lowered below the split and
    at its default.  Every rank writes its records, ``cadence_<r>.npz``.
    2 ranks, (2, 1) then (1, 2), the experts whole: one
    update_matrix_cdc of :func:`cdc_config` from the initial state; rank
    0 writes ``parting.npz``."""
    from tpurec_torch.parallel import make_mesh

    j = _join()
    data = cdc_data()
    res = {}
    if j.world == 4:
        mesh = make_mesh(2, 2)
        with open(os.path.join(out_dir, CADENCE_INIT), "rb") as f:
            init = f.read()
        for placement, lanes in CADENCE_FITS:
            tr = cdc_trainer(cadence_config(placement, lanes), data, mesh)
            tr.restore_bytes(init)
            rec = cadence_fit(tr, data)
            res.update({f"{placement}_{lanes}/{k}": v
                        for k, v in rec.items()})
        for budget in ("default", "lowered"):
            tr = cdc_trainer(cadence_config("auto"), data, mesh)
            if budget == "lowered":
                tr.MESH_RESIDENT_BUDGET = CADENCE_BUDGET
            tr.setup_data(data.train, data.valid)
            res[f"auto_{budget}/resident"] = tr._resident
        np.savez(os.path.join(out_dir, f"cadence_{j.rank}.npz"), **res)
        return
    for shape in PARTING_MESHES:
        mesh = make_mesh(*shape)
        tr = cdc_trainer(cdc_config(), data, mesh)
        tr.setup_data(data.train, data.valid)
        tr.update_matrix_cdc(1)
        key = "x".join(map(str, shape))
        res.update({f"{key}/{k}": v for k, v in cluster_of(tr).items()})
    if j.rank == 0:
        np.savez(os.path.join(out_dir, "parting.npz"), **res)


def task_timeout(out_dir, seconds):
    """2 ranks on the CPU joined with a process-group timeout of
    ``seconds``: a barrier, then rank 1 stays away from rank 0's
    all-reduce for 4x the timeout.  Rank 0's all-reduce must fail within
    the timeout; both ranks tear down.  Rank 0 writes ``timeout.json``
    (the wait, the error, the group after the teardown)."""
    import time

    import torch
    import torch.distributed as dist

    from tpurec_torch.parallel import (barrier, init_distributed,
                                       shutdown_distributed)
    from tpurec_torch.parallel.mesh import joined

    torch.set_num_threads(1)
    j = init_distributed("cpu", timeout=float(seconds))
    barrier(j.device)
    if j.rank == 1:
        time.sleep(4 * float(seconds))
        return
    t0 = time.perf_counter()
    try:
        dist.all_reduce(torch.ones(1))
        err = None
    except RuntimeError as e:
        err = str(e)
    waited = time.perf_counter() - t0
    shutdown_distributed()
    with open(os.path.join(out_dir, "timeout.json"), "w") as f:
        json.dump({"waited": waited, "error": err,
                   "joined": joined() is not None,
                   "initialized": dist.is_initialized()}, f)


def task_exit_fault(out_dir):
    """A rank that exits 0 after printing an exit fault."""
    print(f"{EXIT_FAULTS[0]} without an active exception", file=sys.stderr)


TASKS = {"cli": task_cli, "steps": task_steps, "lookup": task_lookup,
         "trainer": task_trainer, "ckpt": task_ckpt, "expert": task_expert,
         "cdc": task_cdc, "cadence": task_cadence,
         "timeout": task_timeout, "exit_fault": task_exit_fault}


if __name__ == "__main__":
    try:
        TASKS[sys.argv[1]](*sys.argv[2:])
    finally:
        # every task's rank tears down the group it joined
        if "torch" in sys.modules:
            from tpurec_torch.parallel import shutdown_distributed

            shutdown_distributed()

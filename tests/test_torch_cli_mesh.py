"""The port's CLI on a mesh: ``python -m torch.distributed.run
--nproc_per_node 2`` runs ``tpurec_torch.cli.main`` on 2 ranks over gloo
on the CPU (tests/test_torch_mesh_worker.py's ``cli`` task, which sets
dropout 0: the CLI has no dropout flag), against ``--mesh_data -1`` in
this process; and the mesh rule of ``tpurec/cli.py:299-328`` with ranks
for devices.

- Without ``--seed`` the seed is the hash of the flags, which Python
  salts per process: both ranks must train from rank 0's, and the first
  two steps' losses equal the one-device run's at that seed within
  tpurec's step limit (rtol 2e-5, ``tests/test_sharding.py``), whatever
  the seed.  From the third step on the runs part by more: the first Adam
  step, lr g / (|g| + eps), moves a parameter whose gradient lies near
  eps = 1e-8 with the rounding of g (the biases before a BatchNorm,
  whose true gradient is 0, have gradients of 1e-9), and the rounding
  follows the summation order (ROADMAP.md, queue 3).
- From the CLI's default ``--seed 2000``, the 2-rank run against the
  one-device run over the epoch: the train loss within 1e-4 (relative);
  the valid scores of the two checkpoints within 1e-3, and the valid
  AUCs by no more than the share of (positive, negative) pairs whose
  scores lie within twice the measured gap.  The eval's running means
  lag the biases that the step above moves, so at other seeds the scores
  part by up to 5.2e-3 and the epoch's train loss by up to 2.6e-4
  (ROADMAP.md, queue 3); a fixed seed keeps this check repeatable.
- Rank 0 alone prints the result line, logs and writes the checkpoint.
"""

import dataclasses
import glob
import json

import numpy as np
import pytest
import torch

import test_torch_mesh_worker as mw
from tpurec_torch import cli as pcli

ARGV = ["--device", "cpu", "--model", "mmoe", "--n_rows", "5000",
        "--n_domain", "3", "--epoch", "1", "--bs", "256", "--embed_dim", "8",
        "--no-eval_streaming"]
PRED_TOL, LOSS_RTOL = 1e-3, 1e-4
FIRST_STEPS, STEP_RTOL = 2, 2e-5
SEED = 2000                      # the CLI's default --seed


def _spawn(out, *extra):
    mw.spawn("cli", 2, str(out), *ARGV, *extra, "--mesh_data", "2",
             "--save_path", str(out / "save"),
             "--log_path", str(out / "log.jsonl"), torchrun=True)
    seeds = [json.load(open(out / f"seed_{r}.json")) for r in (0, 1)]
    with open(out / "cli_0.log") as f:
        lines = f.read().splitlines()
    results = [json.loads(x) for x in lines
               if x.startswith("{") and '"valid"' in x and '"test"' in x]
    losses = json.load(open(out / "losses_0.json"))
    return out, seeds, results, losses


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Without --seed: the seed comes from the salted hash."""
    return _spawn(tmp_path_factory.mktemp("cli"))


@pytest.fixture(scope="module")
def seeded_run(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("cli_seeded"), "--seed",
                  str(SEED), "--is_set_seed", "1")


def _one_device(monkeypatch, seed, out):
    """The one-device CLI run from ``seed``, dropout 0, one thread ->
    (argv, its result, its steps' losses)."""
    build = pcli.build_config
    monkeypatch.setattr(pcli, "build_config", lambda a: dataclasses.replace(
        build(a), model=dataclasses.replace(build(a).model, dropout=0.0)))
    losses = mw.record_losses(monkeypatch.setattr)
    argv = ARGV + ["--mesh_data", "-1", "--seed", str(seed),
                   "--is_set_seed", "1", "--save_path", str(out / "one")]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = pcli.main(argv)
    finally:
        torch.set_num_threads(n)
    return argv, one, losses


def test_ranks_train_from_one_seed(mesh_run):
    _, seeds, _, _ = mesh_run
    assert seeds[0] == seeds[1]


def test_first_steps_match_one_device(mesh_run, monkeypatch):
    out, seeds, _, losses = mesh_run
    _, _, one = _one_device(monkeypatch, seeds[0], out)
    assert len(losses) == len(one)
    np.testing.assert_allclose(losses[:FIRST_STEPS], one[:FIRST_STEPS],
                               rtol=STEP_RTOL, atol=0)


def test_matches_one_device_run(seeded_run, monkeypatch):
    out, seeds, results, _ = seeded_run
    assert seeds == [SEED, SEED]
    argv, one, _ = _one_device(monkeypatch, SEED, out)
    got = results[0]["valid"]
    assert abs(got["train_loss"] - one["valid"]["train_loss"]) \
        <= LOSS_RTOL * abs(got["train_loss"])
    _, valid, _, *_ = pcli.load_dataset(pcli.build_config(
        pcli.parse_args(argv)))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        p = [_scores(path, valid[0]) for path in (results[0]["checkpoint"],
                                                  one["checkpoint"])]
    finally:
        torch.set_num_threads(n)
    gap = float(np.max(np.abs(p[0] - p[1])))
    assert gap <= PRED_TOL
    y = valid[1].reshape(-1) > 0
    close = np.abs(p[1][y][:, None] - p[1][~y][None, :]) <= 2 * gap
    assert abs(got["total_auc"] - one["valid"]["total_auc"]) \
        <= close.sum() / close.size + 1e-12


def _scores(path, X):
    from tpurec_torch.serve import predictor_from_checkpoint

    return predictor_from_checkpoint(path, device="cpu")(X)


def test_rank0_alone_prints_logs_and_saves(mesh_run):
    out, seeds, results, _ = mesh_run
    assert len(results) == 1
    ckpts = glob.glob(str(out / "save" / "*"))
    assert ckpts == [str(out / "save" / f"mmoe_synthetic_seed{seeds[0]}.pkl")]
    assert results[0]["checkpoint"] == ckpts[0]
    recs = [json.loads(x) for x in open(out / "log.jsonl")]
    mesh = [r for r in recs if "mesh" in r]
    assert len(mesh) == 1 and mesh[0]["mesh"] == [2, 1]
    assert mesh[0]["backend"] == "gloo" and mesh[0]["ranks"] == 2
    assert sum("total_auc" in r for r in recs) == 1    # one epoch, once


def _args(*extra, device="cpu"):
    return pcli.parse_args(["--device", device, "--is_set_seed", "1",
                            *extra])


def _launched(monkeypatch, world):
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("RANK", "0")


def test_explicit_mesh_larger_than_world_exits(monkeypatch):
    _launched(monkeypatch, 2)
    with pytest.raises(SystemExit) as e:
        pcli.resolve_mesh(_args("--mesh_data", "4"))
    # tpurec/cli.py:313-315's message, with the launch's ranks
    assert str(e.value) == ("--mesh_data 4 x --mesh_model 1 needs 4 "
                            "devices, have 2")


@pytest.mark.parametrize("world,flags,want", [
    (4, [], (4, 1)), (4, ["--mesh_model", "2"], (2, 2)),
    (4, ["--mesh_data", "2", "--mesh_model", "2"], (2, 2)),
    (2, ["--mesh_data", "-1"], None), (1, [], None),
    (1, ["--mesh_data", "1"], None)])
def test_mesh_under_a_launcher_takes_the_ranks(monkeypatch, world, flags,
                                               want):
    _launched(monkeypatch, world)
    assert pcli.resolve_mesh(_args(*flags)) == want


def test_mesh_of_part_of_the_launch_exits(monkeypatch):
    _launched(monkeypatch, 4)
    with pytest.raises(SystemExit, match="takes every rank"):
        pcli.resolve_mesh(_args("--mesh_data", "2"))


def test_plain_launch_on_several_cards_exits(monkeypatch):
    for v in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit) as e:
        pcli.resolve_mesh(_args(device="cuda"))
    msg = str(e.value)
    assert "torch.distributed.run --nproc_per_node 2" in msg
    assert "--mesh_data -1" in msg
    assert pcli.resolve_mesh(_args("--mesh_data", "-1",
                                   device="cuda")) is None
    # an explicit mesh of 2 on the CPU (one device) exits as tpurec's
    with pytest.raises(SystemExit, match="needs 2 devices, have 1"):
        pcli.resolve_mesh(_args("--mesh_data", "2"))

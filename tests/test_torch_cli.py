"""``python -m tpurec_torch.cli`` against ``python -m tpurec.cli`` on the CPU.

- ``parse_args``: every flag and default of the JAX package's, plus
  ``--device``; for the same argv, in one process, the same ``vars()``
  apart from ``device`` and the same seed hash (Python's string hash is
  salted per process, so the two are compared in one);
- ``build_config``: equal ``config_to_dict``;
- the data path of ``main`` (``load_dataset`` on Amazon- and
  Ali-CCP-shaped CSVs written at ``preprocess_path``, then
  ``--domain_filter`` and ``--hash_buckets``): what reaches the Trainer is
  bitwise equal (the Trainers are replaced by recorders);
- ``main`` end to end on the synthetic DeepFM (``--embed_init_std 0.01``,
  1 epoch, 3,000 rows): both packages resume one tpurec CLI checkpoint
  (the port's initial state cannot be drawn from JAX's PRNG) with dropout
  0 in both (the packages cannot share dropout bits, ROADMAP.md's ground
  rules): the epoch's loss, the final state as
  tests/test_torch_zoo_trainer.py holds one epoch, LogLoss 1e-4 and the
  same ``domain_auc`` keys (``test_main_matches_tpurec`` says why the
  two runs' AUCs are printed, not held); each checkpoint served by the
  other package's Predictor within 1e-5;
- (``--model cdc``: tests/test_torch_cli_cdc.py);
- ``--parallel_rows 2`` (CDC's row lanes) against tpurec's CLI, and
  ``--wandb`` without the package warns and trains.
"""

import dataclasses
import json
import os
import pickle
import sys

import flax.serialization as fser
import numpy as np
import pandas as pd
import pytest
import torch

import tpurec.cli as jcli
import tpurec.train
import tpurec_torch.cli as pcli
import tpurec_torch.train
from tpurec.config import config_to_dict as jax_config_to_dict
from tpurec.serve import predictor_from_checkpoint as jax_predictor_from_ckpt
from tpurec_torch.config import config_to_dict
from tpurec_torch.serve import predictor_from_checkpoint
from test_torch_zoo_trainer import _drifts, _leaves

AUC_TOL, LOSS_TOL, P_ATOL = 1e-3, 1e-4, 1e-5
ARGVS = [
    [],
    ["--model", "dcn"],
    ["--model", "cdc", "--base_model", "ple", "--n_cluster", "3",
     "--affinity_func", "divide", "--lr", "0.01", "--probe_eval_batches",
     "4", "--mask_ema", "0.5", "--freeze_after_updates", "2"],
    ["--model", "mmoe", "--dataset_name", "aliccp", "--data_path", "d",
     "--group_strategy", "split", "--domain_filter", "[0,3,5]",
     "--hash_buckets", "{0: 100, 9: 64}", "--embed_init_std", "0.01",
     "--compute_dtype", "bfloat16", "--no-eval_streaming", "--wandb"],
    ["--model", "hinet", "--mesh_data", "-1", "--mesh_model", "2",
     "--mesh_expert_parallel", "--embedding_update", "sparse",
     "--embedding_moments_dtype", "bfloat16", "--cluster_mode", "greedy",
     "--data_placement", "stream", "--use_metric", "auc"],
]
DEEPFM = ["--model", "deepfm", "--dataset_name", "synthetic", "--n_rows",
          "3000", "--n_domain", "4", "--epoch", "1", "--bs", "256",
          "--is_set_seed", "1", "--seed", "3", "--embed_dim", "8",
          "--embed_init_std", "0.01", "--mesh_data", "-1"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _patch_config(mp, model=None, cdc=None):
    """Make both CLIs build the same changed config (a test-side change)."""
    for mod in (jcli, pcli):
        orig = mod.build_config

        def build(args, _orig=orig):
            cfg = _orig(args)
            return dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, **(model or {})),
                cdc=dataclasses.replace(cfg.cdc, **(cdc or {})))

        mp.setattr(mod, "build_config", build)


# ---------------------------------------------------------------------------
# flags, seed, config
# ---------------------------------------------------------------------------


def _parsers(monkeypatch):
    """The two CLIs' ArgumentParsers, caught as parse_args runs them."""
    import argparse

    seen = []
    orig = argparse.ArgumentParser.parse_args

    def catch(self, *a, **k):
        seen.append(self)
        return orig(self, *a, **k)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    jcli.parse_args(["--is_set_seed", "1"])
    pcli.parse_args(["--is_set_seed", "1"])
    return seen


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type,
                     a.nargs, a.const, type(a).__name__)
            for a in parser._actions}


def test_flags_and_defaults_are_tpurecs_plus_device(monkeypatch):
    jp, pp = _parsers(monkeypatch)
    want, got = _actions(jp), _actions(pp)
    assert got.pop("device") == (("--device",), "cuda", ["cuda", "cpu"],
                                 None, None, None, "_StoreAction")
    assert got == want


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
@pytest.mark.parametrize("device", [None, "cpu"])
def test_parse_args_gives_tpurecs_seed(argv, device):
    want = jcli.parse_args(["--is_set_seed", "0"] + argv)
    extra = [] if device is None else ["--device", device]
    got = pcli.parse_args(["--is_set_seed", "0"] + argv + extra)
    assert got.device == (device or "cuda")
    assert got.is_set_seed == want.is_set_seed == 1
    assert got.seed == want.seed
    assert {k: v for k, v in vars(got).items() if k != "device"} == vars(want)
    # an explicit seed stays
    assert pcli.parse_args(argv + ["--seed", "7", "--is_set_seed", "1"]
                           ).seed == 7


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_build_config_is_tpurecs(argv):
    argv = argv + ["--is_set_seed", "1"]
    got = config_to_dict(pcli.build_config(pcli.parse_args(argv)))
    want = jax_config_to_dict(jcli.build_config(jcli.parse_args(argv)))
    assert got == want


# ---------------------------------------------------------------------------
# the data path: load_dataset, --domain_filter, --hash_buckets
# ---------------------------------------------------------------------------

AMAZON = ["userid", "itemid", "weekday", "domain", "sales_chart",
          "sales_rank", "brand", "price"]
ALICCP = ["userid", "121", "122", "124", "125", "126", "127", "128", "129",
          "itemid", "domain", "207", "210", "216", "508", "509", "702", "853",
          "109_14", "110_14", "127_14", "150_14", "301"]


@pytest.fixture(scope="module")
def csv_dirs(tmp_path_factory):
    """Amazon- and Ali-CCP-shaped preprocessed CSVs at the paths the CLI
    reads, with extra columns it skips."""
    from tpurec_torch.data.preprocess import (AliCCPPreprocessor,
                                              AmazonPreprocessor)

    rng = np.random.default_rng(5)
    n = 1500
    root = tmp_path_factory.mktemp("csv")
    am = root / "amazon"
    am.mkdir()
    df = pd.DataFrame({c: rng.integers(0, 40, n) for c in AMAZON})
    df["domain"] = rng.integers(0, 6, n)
    df["label"] = rng.integers(0, 2, n)
    df["timestamp"] = rng.integers(1_500_000_000, 1_534_000_000, n)
    df.insert(2, "skipped", rng.integers(0, 9, n))
    df.to_csv(AmazonPreprocessor(str(am), 12).preprocess_path, index=False)
    ali = root / "aliccp"
    ali.mkdir()
    df = pd.DataFrame({c: rng.integers(0, 30, n) for c in ALICCP})
    df["userid"] = rng.integers(0, 300, n)
    df["itemid"] = rng.integers(0, 500, n)
    df["domain"] = rng.integers(0, 6, n)
    df["click"] = rng.integers(0, 2, n)
    df["purchase"] = rng.integers(0, 2, n)
    df["train_tag"] = rng.choice(3, n, p=[0.8, 0.1, 0.1])
    df.to_csv(AliCCPPreprocessor(str(ali)).preprocess_path, index=False)
    return {"amazon": str(am), "aliccp": str(ali)}


@pytest.mark.parametrize("name", ["amazon", "aliccp"])
def test_load_dataset_is_tpurecs(csv_dirs, name):
    argv = ["--dataset_name", name, "--data_path", csv_dirs[name],
            "--is_set_seed", "1"]
    got = pcli.load_dataset(pcli.build_config(pcli.parse_args(argv)))
    want = jcli.load_dataset(jcli.build_config(jcli.parse_args(argv)))
    for g, w in zip(got[:3], want[:3]):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[3:] == want[3:]
    assert len(got[0][1]) > len(got[1][1]) > 0 and len(got[2][1]) > 0


class _Recorder:
    """Stands in for a Trainer: records what main hands it."""

    seen = []

    def __init__(self, cfg, field_dims, n_domain, domain_idx,
                 domain2group=None, **kw):
        self.rec = {"config": cfg, "field_dims": tuple(field_dims),
                    "n_domain": n_domain, "domain_idx": domain_idx,
                    "domain2group": list(domain2group)}
        _Recorder.seen.append(self.rec)

    def fit(self, train, valid, test=None, log_fn=None, **kw):
        self.rec["splits"] = (train, valid, test)
        return {"valid": None}


@pytest.mark.parametrize("name,opts", [
    ("amazon", []),
    ("amazon", ["--domain_filter", "[1,2,5]", "--hash_buckets",
                "{0: 16, 1: 8}"]),
    ("aliccp", ["--domain_filter", "[0,4]", "--group_strategy", "split"]),
    ("aliccp", ["--hash_buckets", "{0: 16, 9: 32}"]),
    ("synthetic", ["--domain_filter", "[0,2,4]", "--hash_buckets",
                   "{0: 8}", "--n_rows", "800"]),
])
def test_main_hands_the_trainer_tpurecs_data(csv_dirs, name, opts,
                                             monkeypatch, capsys):
    argv = ["--dataset_name", name, "--data_path", csv_dirs.get(name, "-"),
            "--is_set_seed", "1", "--seed", "4", "--save_path", "",
            "--mesh_data", "-1"] + opts
    monkeypatch.setattr(tpurec.train, "Trainer", _Recorder)
    monkeypatch.setattr(tpurec_torch.train, "Trainer", _Recorder)
    _Recorder.seen = []
    jcli.main(argv)
    pcli.main(argv + ["--device", "cpu"])
    want, got = _Recorder.seen
    assert jax_config_to_dict(want.pop("config")) == config_to_dict(
        got.pop("config"))
    wsplits, gsplits = want.pop("splits"), got.pop("splits")
    assert got == want
    for g, w in zip(gsplits, wsplits):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if "--domain_filter" in opts:
        keep = len(json.loads(opts[opts.index("--domain_filter") + 1]))
        assert got["n_domain"] == keep
        assert gsplits[0][0][:, got["domain_idx"]].max() == keep - 1
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
        "valid": None}


# ---------------------------------------------------------------------------
# main end to end: DeepFM against tpurec, checkpoints across packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def deepfm_runs(tmp_path_factory):
    """tpurec's CLI trains one epoch (checkpoint ``start``); then each
    package's CLI resumes ``start`` for one more.  -> (tpurec's output,
    the port's output, start)."""
    root = tmp_path_factory.mktemp("deepfm")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        _patch_config(mp, model={"dropout": 0.0})
        start = jcli.main(DEEPFM + ["--save_path", str(root / "start")]
                          )["checkpoint"]
        resumed = ["--resume", start, "--log_path"]
        oj = jcli.main(DEEPFM + resumed + [str(root / "j.jsonl"),
                                           "--save_path", str(root / "j")])
        op = pcli.main(DEEPFM + resumed + [str(root / "p.jsonl"),
                                           "--save_path", str(root / "p"),
                                           "--device", "cpu"])
    torch.set_num_threads(n)
    return oj, op, start


def _state(path):
    with open(path, "rb") as f:
        return dict(_leaves(fser.msgpack_restore(pickle.load(f)["state"])))


def test_main_matches_tpurec(deepfm_runs):
    """The epoch's train loss 1e-4 relative; the final state as
    tests/test_torch_zoo_trainer.py holds one epoch (1e-4 of max(1, |x|),
    the zero-gradient biases and the running means they feed at 2 lr a
    step); LogLoss 1e-4 and the same ``domain_auc`` keys.  The two runs'
    AUCs are printed, not held: at this table init the pre-BatchNorm
    activations have a spread of about 0.01, so the zero-gradient
    biases' drift of about lr a step (ROADMAP.md queue 3) moves the eval
    logits by up to 2.3e-3 against a spread of 0.02, and the AUC of a
    model this barely trained reorders pairs (measured: valid 8.1e-4,
    test 4.2e-3).  One state in both packages agrees within 1e-5 below."""
    oj, op, _ = deepfm_runs
    print("cli vs tpurec: " + ", ".join(      # shown by pytest -s
        f"{s} {k} diff {abs(op[s][k] - oj[s][k]):.3g}"
        for s in ("valid", "test") for k in ("total_auc", "total_loss")))
    assert op["valid"]["train_loss"] == pytest.approx(
        oj["valid"]["train_loss"], rel=1e-4)
    for split in ("valid", "test"):
        assert np.isfinite(op[split]["total_auc"])
        assert abs(op[split]["total_loss"]
                   - oj[split]["total_loss"]) <= LOSS_TOL
        assert set(op[split]["domain_auc"]) == set(oj[split]["domain_auc"])
    assert op["valid"]["epoch"] == oj["valid"]["epoch"] == 0
    got, want = _state(op["checkpoint"]), _state(oj["checkpoint"])
    assert set(got) == set(want)
    steps = int(want["step"]) - int(_state(deepfm_runs[2])["step"])
    assert steps == int(got["step"]) - int(_state(deepfm_runs[2])["step"]) > 0
    drift = 2 * 1e-3 * steps                    # the CLI's default lr
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        drifts = _drifts(k, w.shape)
        assert np.max(np.abs(g - w)[drifts], initial=0.0) <= drift, k
        err = np.abs(g - w) / np.maximum(1.0, np.abs(w))
        assert np.max(err[~drifts], initial=0.0) <= 1e-4, (k, err.max())


def test_checkpoint_name_log_and_resume(deepfm_runs):
    oj, op, start = deepfm_runs
    assert os.path.basename(op["checkpoint"]) == os.path.basename(
        oj["checkpoint"]) == "deepfm_synthetic_seed3.pkl"
    with open(op["checkpoint"], "rb") as f:
        payload = pickle.load(f)
    assert payload["extra"]["result"]["valid"]["total_auc"] == pytest.approx(
        op["valid"]["total_auc"])
    assert payload["config"]["train"]["seed"] == 3
    # the JSONL log: one line a log event, the same kinds as tpurec's
    logs = {}
    for who, path in (("j", oj), ("p", op)):
        d = os.path.dirname(os.path.dirname(path["checkpoint"]))
        with open(os.path.join(d, f"{who}.jsonl")) as f:
            logs[who] = [json.loads(line) for line in f]
    assert [sorted(r) for r in logs["p"]] == [sorted(r) for r in logs["j"]]
    assert any("train_loss" in r for r in logs["p"])
    # the run resumed tpurec's checkpoint: its step count goes on from the
    # start's (one epoch each)
    assert int(_state(op["checkpoint"])["step"]) == 2 * int(
        _state(start)["step"]) > 0


@pytest.mark.parametrize("who", ["port", "tpurec"])
def test_checkpoint_serves_in_the_other_package(deepfm_runs, who):
    oj, op, _ = deepfm_runs
    path = (op if who == "port" else oj)["checkpoint"]
    with open(path, "rb") as f:
        fd = pickle.load(f)["field_dims"]
    rng = np.random.default_rng(2)
    X = np.stack([rng.integers(0, d, 300) for d in fd], 1).astype(np.int32)
    got = predictor_from_checkpoint(path, batch_sizes=(128,),
                                    device="cpu")(X)
    want = jax_predictor_from_ckpt(path, batch_sizes=(128,))(X)
    assert got.shape == (300,)
    np.testing.assert_allclose(got, want, rtol=0, atol=P_ATOL)


# ---------------------------------------------------------------------------
# CDC's row lanes, and the wandb gate
# ---------------------------------------------------------------------------

SMALL = ["--n_rows", "600", "--n_domain", "3", "--epoch", "1", "--bs",
         "128", "--embed_dim", "4", "--is_set_seed", "1", "--save_path", "",
         "--device", "cpu"]


@pytest.mark.parametrize("opts,what", [
    (["--model", "cdc", "--parallel_rows", "2"], "parallel_rows"),
])
def test_not_ported_raises_naming_roadmap(tmp_path, opts, what):
    """What raised here before it was ported now trains as tpurec's CLI
    does on the same argv: CDC's row lanes (``--parallel_rows 2``) at
    tests/test_torch_cli_cdc.py's CDC case, held as that case holds it
    (the clustering, AUC and LogLoss), with the option in both configs."""
    from test_torch_cli_cdc import run_cdc_clis

    assert pcli.build_config(pcli.parse_args(opts)).cdc.parallel_rows == 2
    oj, op = run_cdc_clis(tmp_path, opts[2:])
    assert op["domain2group_list"] == oj["domain2group_list"]
    assert op["s_group2domain_list"] == oj["s_group2domain_list"]
    for split in ("valid", "test"):
        assert abs(op[split]["total_auc"] - oj[split]["total_auc"]) <= AUC_TOL
        assert abs(op[split]["total_loss"]
                   - oj[split]["total_loss"]) <= LOSS_TOL, what


def test_one_device_mesh_trains(capsys):
    out = pcli.main(SMALL + ["--mesh_data", "1", "--mesh_model", "1"])
    assert np.isfinite(out["valid"]["total_auc"])
    out = pcli.main(SMALL + ["--mesh_data", "-1", "--mesh_model", "2"])
    assert np.isfinite(out["valid"]["total_auc"])


def test_wandb_without_the_package_warns_and_trains(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)   # import wandb fails
    out = pcli.main(SMALL + ["--wandb"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("WARNING: --wandb requested but wandb is not "
                               "installed")
    assert json.loads(lines[-1])["valid"]["total_auc"] == pytest.approx(
        out["valid"]["total_auc"])
    assert np.isfinite(out["valid"]["total_auc"])

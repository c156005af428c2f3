"""Time a training step of ``python -m tpurec_torch.cli`` against the same
training driven through ``Trainer.fit`` directly, on one CUDA card, in one
process and in turns.

Three arms, each one epoch at B=512 of ``make_synthetic`` rows:

- ``cli``: ``tpurec_torch.cli.main`` with chip_smoke.py phase 21 (a)'s
  argv (MMoE at ModelConfig's widths, the CLI's synthetic schema) but one
  epoch;
- ``fit``: ``Trainer.fit`` of the config, data and grouping that the CLI
  builds for that argv (``cli.build_config``, ``cli.load_dataset``), with
  no logger;
- ``flagship``: ``Trainer.fit`` at chip_smoke.py phase 16's settings (the
  flagship's 23 fields, 4 towers, bf16 table moments).

Each epoch's host seconds are taken around ``train_epoch`` (synchronized),
with the gen-2 garbage collections that ran inside it.  It prints one line
a run and, last, one JSON object; ``--rounds`` sets the turns.

    python3 scripts/time_cli_step.py --rounds 3
"""

import argparse
import contextlib
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as C  # noqa: E402
import tpurec_torch.train  # noqa: E402
from tpurec_torch import cli  # noqa: E402
from tpurec_torch.config import Config, ModelConfig, TrainConfig  # noqa: E402
from tpurec_torch.data import make_synthetic  # noqa: E402
from tpurec_torch.ops import _build  # noqa: E402
from tpurec_torch.train import Trainer  # noqa: E402


class Timed(Trainer):
    """A Trainer that keeps each train_epoch's host seconds and the gen-2
    collections inside it."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.epochs = []
        self.n_train = None

    def fit(self, train, *a, **k):
        self.n_train = len(train[1])
        return super().fit(train, *a, **k)

    def train_epoch(self, *a, **k):
        torch.cuda.synchronize()
        gen2 = gc.get_stats()[2]["collections"]
        t0 = time.perf_counter()
        r = super().train_epoch(*a, **k)
        torch.cuda.synchronize()
        self.epochs.append((time.perf_counter() - t0,
                            gc.get_stats()[2]["collections"] - gen2))
        return r


def result(arm, tr):
    secs, gen2 = tr.epochs[0]
    steps = -(-tr.n_train // tr.cfg.train.bs)
    return {"arm": arm, "ms_a_step": secs / steps * 1e3, "steps": steps,
            "gen2_collections": gen2, "tracked_objects": len(gc.get_objects())}


def run_cli(argv):
    made = []

    class Kept(Timed):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    tpurec_torch.train.Trainer = Kept
    try:
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            cli.main(argv)
    finally:
        tpurec_torch.train.Trainer = Trainer
    return result("cli", made[-1])


def run_fit(argv):
    args = cli.parse_args(argv)
    cfg = cli.build_config(args)
    np.random.seed(cfg.train.seed)
    train, valid, test, field_dims, n_domain, domain_idx = \
        cli.load_dataset(cfg)
    tr = Timed(cfg, field_dims, n_domain, domain_idx,
               domain2group=[0] * n_domain)   # the CLI's "mix" grouping
    tr.fit(train, valid, test=test)
    return result("fit", tr)


def run_flagship(data):
    cfg = Config(model=ModelConfig(**C.MODEL, dropout=C.DROPOUT),
                 train=TrainConfig(bs=512, epoch=1, seed=0,
                                   embedding_moments_dtype="bfloat16"))
    tr = Timed(cfg, C.FIELD_DIMS, C.N_DOMAIN, C.DOMAIN_IDX,
               domain2group=np.arange(C.N_DOMAIN) % C.N_TOWER)
    tr.fit(data.train, data.valid, data.test,
           domain_cnt_weight=data.domain_cnt_weight())
    return result("flagship", tr)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--rows", type=int, default=C.CLI_ROWS)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_cli_step: no CUDA device; this script runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    _build.build()
    tmp = tempfile.mkdtemp(prefix="cli_step_")
    argv = ["--model", "mmoe", "--dataset_name", "synthetic", "--n_rows",
            str(args.rows), "--n_domain", "6", "--bs", "512", "--epoch", "1",
            "--mesh_data", "-1", "--is_set_seed", "1", "--seed", "21",
            "--save_path", tmp, "--log_path", os.path.join(tmp, "log.jsonl")]
    data = make_synthetic(n_rows=args.rows, n_fields=len(C.FIELD_DIMS),
                          n_domain=C.N_DOMAIN, field_dims=C.FIELD_DIMS,
                          domain_idx=C.DOMAIN_IDX, seed=1)
    runs = []
    for r in range(args.rounds):
        arms = (("cli", "fit", "flagship") if r % 2 == 0
                else ("flagship", "fit", "cli"))
        for arm in arms:
            out = (run_cli(argv) if arm == "cli" else run_fit(argv)
                   if arm == "fit" else run_flagship(data))
            out["round"] = r
            runs.append(out)
            print(f"[{gpu}] round {r} {arm}: {out['ms_a_step']:.3f} ms a "
                  f"step ({out['steps']} steps, host clock), "
                  f"{out['gen2_collections']} gen-2 collections, "
                  f"{out['tracked_objects']} objects tracked", flush=True)
            torch.cuda.empty_cache()
    med = {arm: float(np.median([x["ms_a_step"] for x in runs
                                 if x["arm"] == arm]))
           for arm in ("cli", "fit", "flagship")}
    print(json.dumps({"device": gpu, "median_ms_a_step": med, "runs": runs}))


if __name__ == "__main__":
    main()

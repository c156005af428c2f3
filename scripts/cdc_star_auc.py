"""CDC's valid AUC on STAR, PEPNet and EPNet through both packages' CLIs,
on the CPU, at ``chip_smoke.py`` phase 21 (b)'s configuration.

Phase 21 (b) runs ``tpurec_torch.cli`` with CDC on each of these bases
(32,768 synthetic rows, 6 domains, 1 epoch, B=512, warmup_step 10, one
matrix update of 4 causal-mask rows, seed 21).  This script runs the same
argv through ``python -m tpurec.cli`` (JAX on the CPU) and ``python -m
tpurec_torch.cli --device cpu``, each a subprocess writing into a
temporary directory, and prints each run's valid and test AUC: whether a
base's AUC is the JAX package's own behaviour at this configuration or a
fault of the port.  ``--seeds`` repeats it at other seeds (the seed
draws the data and the initial weights, which the two packages draw
from their own generators), so that a gap can be set beside the spread
that the draw alone gives.  ``--same-init`` instead fits each package's
CDCTrainer in this process on the CLI's configuration and data, the port
started from tpurec's initial state (``restore_bytes`` of its
``flax.serialization.to_bytes``), at the CLI's dropout and at dropout 0
(the two packages cannot share dropout bits): what is left between them
is the port's computation.

    JAX_PLATFORMS=cpu python scripts/cdc_star_auc.py [--bases star pepnet]
        [--seeds 21 22 23] [--same-init]

About 15 s a port run and 50 s a JAX run on 8 CPU cores.  The last line
is one JSON object: {base: {seed: {run: {"valid_total_auc", ...}}}}, a
run being a package (the CLIs) or "tpurec"/"port" at a dropout
(``--same-init``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = ("star", "pepnet", "epnet")
SEED = 21                       # chip_smoke.py: SEED + 21
# chip_smoke.py cli_main_path (b) and _cli_argv
ARGV = ["--model", "cdc", "--dataset_name", "synthetic", "--n_rows",
        "32768", "--n_domain", "6", "--epoch", "1", "--bs", "512",
        "--warmup_step", "10", "--update_interval", "100000",
        "--n_causal_mask", "4", "--mesh_data", "-1", "--is_set_seed", "1"]
GAP = 0.01                      # STAR's AUC: the port within this of tpurec


def run_cli(package: str, base: str, seed: int, tmp: str) -> dict:
    """One CLI run -> its result line's AUCs and clustering."""
    name = f"{package}_{base}_{seed}"
    argv = ARGV + ["--seed", str(seed), "--base_model", base, "--save_path",
                   os.path.join(tmp, name), "--log_path",
                   os.path.join(tmp, f"{name}.jsonl")]
    if package == "tpurec_torch":
        argv += ["--device", "cpu"]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{package}.cli", *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"{package}.cli on {base} exited "
                         f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    results = [json.loads(x) for x in proc.stdout.splitlines()
               if x.startswith("{") and '"valid"' in x]
    if len(results) != 1:
        raise SystemExit(f"{package}.cli on {base}: {len(results)} result "
                         "lines")
    out = results[0]
    return {"valid_total_auc": out["valid"]["total_auc"],
            "test_total_auc": out["test"]["total_auc"],
            "domain2group": out["domain2group_list"], "seconds": secs}


def run_same_init(base: str, seed: int) -> dict:
    """Both packages' CDCTrainer.fit from tpurec's initial state on the
    CLI's configuration, at the CLI's dropout and at 0 -> {run: AUCs}."""
    import dataclasses

    import flax.serialization as fser
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import tpurec.cli as jcli
    import tpurec_torch.cli as pcli
    from tpurec.cdc import CDCTrainer as JaxCDCTrainer
    from tpurec_torch.cdc import CDCTrainer

    argv = ARGV + ["--seed", str(seed), "--base_model", base]
    jcfg = jcli.build_config(jcli.parse_args(argv))
    pcfg = pcli.build_config(pcli.parse_args(argv + ["--device", "cpu"]))
    np.random.seed(jcfg.train.seed)
    train, valid, _, dims, n_domain, domain_idx = jcli.load_dataset(jcfg)
    out = {}
    for dropout in (jcfg.model.dropout, 0.0):
        cfgs = [dataclasses.replace(c, model=dataclasses.replace(
            c.model, dropout=dropout)) for c in (jcfg, pcfg)]
        jtr = JaxCDCTrainer(cfgs[0], dims, n_domain, domain_idx)
        tr = CDCTrainer(cfgs[1], dims, n_domain, domain_idx, device="cpu")
        tr.restore_bytes(fser.to_bytes(jtr.state))
        for name, t in (("tpurec", jtr), ("port", tr)):
            t0 = time.perf_counter()
            r = t.fit(train, valid)
            out[f"{name} dropout {dropout}"] = {
                "valid_total_auc": r["valid"]["total_auc"],
                "domain2group": [int(g) for g in r["domain2group_list"]],
                "seconds": time.perf_counter() - t0}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bases", nargs="+", default=list(BASES),
                    choices=BASES)
    ap.add_argument("--seeds", nargs="+", type=int, default=[SEED])
    ap.add_argument("--same-init", action="store_true")
    opts = ap.parse_args()
    res = {}
    if opts.same_init:
        for base in opts.bases:
            res[base] = {}
            for seed in opts.seeds:
                res[base][seed] = runs = run_same_init(base, seed)
                for run, r in runs.items():
                    print(f"cdc on {base}, seed {seed}, from tpurec's init, "
                          f"{run}: valid total_auc "
                          f"{r['valid_total_auc']:.5f}, clustering "
                          f"{r['domain2group']} ({r['seconds']:.1f} s)",
                          flush=True)
        print(json.dumps(res))
        return 0
    with tempfile.TemporaryDirectory(prefix="cdc_star_auc_") as tmp:
        for base in opts.bases:
            res[base] = {}
            for seed in opts.seeds:
                res[base][seed] = {}
                for package in ("tpurec", "tpurec_torch"):
                    r = run_cli(package, base, seed, tmp)
                    res[base][seed][package] = r
                    print(f"cdc on {base}, seed {seed}, {package}.cli: valid "
                          f"total_auc {r['valid_total_auc']:.5f}, test "
                          f"{r['test_total_auc']:.5f}, clustering "
                          f"{r['domain2group']} ({r['seconds']:.1f} s)",
                          flush=True)
    for base, by_seed in res.items():
        for seed, r in by_seed.items():
            gap = r["tpurec_torch"]["valid_total_auc"] \
                - r["tpurec"]["valid_total_auc"]
            verdict = ("within" if abs(gap) <= GAP else "NOT within")
            print(f"{base}, seed {seed}: the port's valid AUC - tpurec's = "
                  f"{gap:+.5f} ({verdict} {GAP})")
        for package in ("tpurec", "tpurec_torch"):
            aucs = [r[package]["valid_total_auc"] for r in by_seed.values()]
            print(f"{base}, {package}: valid AUC over {len(aucs)} seeds "
                  f"{min(aucs):.5f}-{max(aucs):.5f}, mean "
                  f"{sum(aucs) / len(aucs):.5f}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

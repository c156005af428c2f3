"""Step 1's gradient of the gathered rows, card against CPU, with the CPU
on its own ReLU branches and on the card's.

For each model ``chip_smoke.py`` trains (at its table scale in phases 9,
13 and 18, and PLE and PEPNet also at x1) and a few seeded batches, one
``loss_and_grads`` of the hybrid step runs on the card, recording every
``torch.relu`` call's branches, then twice on the CPU's plain path: as
is, and replaying the card's branches (``chip_smoke.relu_branches``).
It prints each gradient's max abs error relative to its largest value,
and how many ReLU inputs fell on the other branch.  A ReLU input within
rounding of 0 may take either branch on two devices, and the gradient
then parts by that unit's whole contribution.  Needs a card:

    python3 scripts/row_grad_flips.py --seeds 0 1 2

With ``--phase18 S ...`` it runs ``chip_smoke.py --phase 18 --seed S``
instead (phase 18 (a) alone, checks included, the same draws) and runs
each base's 3 steps against the CPU once more with the CPU on its own
branches: the losses' and the table's parting beside the checked run's
on the card's branches, that is, what the replay removes:

    python3 scripts/row_grad_flips.py --phase18 0 1

The last line is one JSON object.
"""

import argparse
import copy
import inspect
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from tpurec_torch.config import ModelConfig, TrainConfig  # noqa: E402
from tpurec_torch.models import MULTI_TOWER_OUTPUT, build_model  # noqa: E402
from tpurec_torch.train import hybrid  # noqa: E402
from tpurec_torch.train.reg import reg_coef_tree  # noqa: E402

CASES = (("mmoe", cs.MODEL, 0.01), ("dcn", cs.DCN_MODEL, 0.01),
         ("ple", {"model": "ple"}, 1.0), ("pepnet", {"model": "pepnet"}, 1.0),
         ("pepnet", {"model": "pepnet"}, 0.01),
         ("epnet", {"model": "epnet"}, 0.01),
         ("star", {"model": "star"}, 0.01))


def row_grad(name, kw, scale, where, batch, branches=None):
    """``loss_and_grads``'s row gradient of a fresh seeded model, inside
    ``branches`` (a ``chip_smoke.relu_branches``) when given."""
    tcfg = TrainConfig(bs=512, embedding_moments_dtype="bfloat16")
    model = build_model(name, cs.FIELD_DIMS, cs.N_TOWER, cs.DOMAIN_IDX,
                        ModelConfig(**kw, dropout=0.0), device=where,
                        generator=torch.Generator().manual_seed(cs.SEED + 3))
    with torch.no_grad():
        model.embedding.table.mul_(scale)
    ts = hybrid.init_train_state(model, tcfg, device=where)
    reg = reg_coef_tree([n for n, _ in model.named_parameters()], name,
                        cs.L2, cs.L2, cs.L2)
    step = hybrid.make_hybrid_train_step(model, tcfg, reg,
                                         name in MULTI_TOWER_OUTPUT, cs.L2)
    if branches is None:
        return step.loss_and_grads(ts, batch, None)[2].detach().cpu()
    with branches:
        return step.loss_and_grads(ts, batch, None)[2].detach().cpu()


def phase18_own_branches(seeds):
    """``chip_smoke.phase18_main`` at each seed, its ``train_vs_cpu``
    wrapped: after each checked run (on the card's branches), the same
    batches' 3 steps on the card and on the CPU on its own branches.
    -> rows."""
    checked, rows = cs.train_vs_cpu, []
    sig = inspect.signature(checked)

    def train_vs_cpu(*args, **kw):
        a = sig.bind(*args, **kw)
        a.apply_defaults()
        a = a.arguments
        batches = cs.train_batches(copy.deepcopy(a["rng"]), 3, "cpu")
        summary = checked(*args, **kw)
        tcfg = cs.vs_cpu_config(a["wd"], a["compute_dtype"])
        (lg, dg, tg, _), (lc, dc, tc, _) = (
            cs.three_steps(w, a["name"], a["model_kw"], a["table_scale"],
                           tcfg, batches, a["update"])
            for w in ("cuda", "cpu"))
        row = {"seed": seed, "model": a["name"],
               "own_loss_rel_err": max(abs(x / y - 1)
                                       for x, y in zip(lg, lc)),
               "own_data_loss_rel_err": max(abs(x / y - 1)
                                            for x, y in zip(dg, dc)),
               "own_table_share_beyond_1e-6":
                   ((tg - tc).abs() > 1e-6).float().mean().item(),
               "card_loss_rel_err": summary["loss_rel_err"],
               "card_data_loss_rel_err": summary["data_loss_rel_err"],
               "card_table_share_beyond_1e-6":
                   summary["table_share_beyond_1e-6"],
               "flipped": summary["step_flips"]}
        rows.append(row)
        print(f"seed {seed} {a['name']} 3 steps, card vs CPU: loss max rel "
              f"err {row['own_loss_rel_err']:.3g}, before the table's L2 "
              f"{row['own_data_loss_rel_err']:.3g}, table after step 1 "
              f"beyond 1e-6 {row['own_table_share_beyond_1e-6']:.3g} on the "
              f"CPU's own branches; {row['card_loss_rel_err']:.3g}, "
              f"{row['card_data_loss_rel_err']:.3g}, "
              f"{row['card_table_share_beyond_1e-6']:.3g} on the card's "
              f"({row['flipped']} inputs flipped)", flush=True)
        return summary

    cs.train_vs_cpu = train_vs_cpu
    try:
        for seed in seeds:
            if cs.phase18_main(seed) != 0:
                sys.exit(1)
    finally:
        cs.train_vs_cpu = checked
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--phase18", type=int, nargs="+", metavar="SEED",
                    help="phase 18 (a) alone at these seeds, the CPU also "
                         "on its own branches")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    if args.phase18:
        rows = phase18_own_branches(args.phase18)
        print(json.dumps({"device": gpu, "phase18": rows}))
        return
    rows = []
    for seed in args.seeds:
        b = cs.train_batches(np.random.default_rng(seed), 1, "cpu")
        batch = {k: v[0] for k, v in b.items()}
        for name, kw, scale in CASES:
            masks = []
            g_card = row_grad(name, kw, scale, "cuda", batch,
                              cs.relu_branches(masks, record=True))
            g_own = row_grad(name, kw, scale, "cpu", batch)
            replay = cs.relu_branches(masks, record=False)
            g_replay = row_grad(name, kw, scale, "cpu", batch, replay)
            top = g_own.abs().max().item()
            row = {"seed": seed, "model": name, "scale": scale,
                   "max_g": top,
                   "own_branches": (g_card - g_own).abs().max().item() / top,
                   "card_branches": (g_card - g_replay).abs().max().item()
                   / top,
                   "flipped": replay.flipped, "relu_inputs": replay.inputs}
            rows.append(row)
            print(f"[{gpu}] seed {seed} {name} x{scale}: row gradient max "
                  f"err / max |g| {row['own_branches']:.3g} on the CPU's "
                  f"own ReLU branches, {row['card_branches']:.3g} on the "
                  f"card's; {replay.flipped} of {replay.inputs} ReLU "
                  f"inputs flipped", flush=True)
    print(json.dumps({"device": gpu, "rows": rows}))


if __name__ == "__main__":
    main()

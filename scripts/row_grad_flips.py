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

The last line is one JSON object.
"""

import argparse
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
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

"""How far rounding alone moves a model's training losses, on the CPU.

Runs 3 hybrid steps of a full-width model on the flagship schema (the
batches and seeded weights of ``chip_smoke.py``'s phase 9, every dropout 0,
bf16 table moments, the table scaled by ``--scale``, Adam's weight decay
``--wd``) twice: as is, and with one unit of float32 rounding (relative
noise of 1.2e-7, seeded) on the table rows the first step gathers.  It
prints how far each step's loss before the table's L2 term (the data
loss and the dense weights' L2) moves, relative, and how far the first
step's gradient of the gathered rows moves, relative to its largest
value.  A model whose later losses move by more than the card
check's tolerance (1e-4) under that noise cannot be held to it against
the card at that scale, whatever the kernels do.

    python3 scripts/loss_sensitivity.py --model ple --scale 0.01 0.1
    python3 scripts/loss_sensitivity.py --model ple --scale 0.01 --wd 1e-3

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


def losses(name, scale, wd, noise_seed=None):
    """3 steps' losses before the table's L2 term and the first step's
    gathered-row gradient; ``noise_seed`` puts the rounding-sized noise on
    the first step's gathered rows."""
    batches = cs.train_batches(np.random.default_rng(cs.SEED), 3, "cpu")
    tcfg = TrainConfig(bs=512, embedding_moments_dtype="bfloat16", wd=wd)
    model = build_model(name, cs.FIELD_DIMS, cs.N_TOWER, cs.DOMAIN_IDX,
                        ModelConfig(model=name, **cs.NO_DROPOUT),
                        device="cpu",
                        generator=torch.Generator().manual_seed(cs.SEED + 3))
    with torch.no_grad():
        model.embedding.table.mul_(scale)
    ts = hybrid.init_train_state(model, tcfg, device="cpu")
    reg = reg_coef_tree([n for n, _ in model.named_parameters()], name,
                        cs.L2, cs.L2, cs.L2)
    step = hybrid.make_hybrid_train_step(
        model, tcfg, reg, name in MULTI_TOWER_OUTPUT, cs.L2)
    gather = step.upd.gather_rows
    if noise_seed is not None:
        def noisy(table, x):
            r = gather(table, x)
            if ts.step == 0:
                g = torch.Generator().manual_seed(noise_seed)
                r = r * (1 + 1.2e-7 * torch.randn(r.shape, generator=g))
            return r
        step.upd.gather_rows = noisy
    out, grad1, loss_and_grads = [], [], step.loss_and_grads

    def record(*a):
        r = loss_and_grads(*a)
        out.append(float(r[0]))
        if not grad1:
            grad1.append(r[2].detach().clone())
        return r

    step.loss_and_grads = record
    for i in range(3):
        step(ts, {k: v[i] for k, v in batches.items()}, None)
    return out, grad1[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="ple")
    ap.add_argument("--scale", type=float, nargs="+", default=[0.01, 0.1])
    ap.add_argument("--wd", type=float, default=TrainConfig.wd)
    ap.add_argument("--seeds", type=int, default=2)
    args = ap.parse_args()
    out = {}
    for scale in args.scale:
        base, g0 = losses(args.model, scale, args.wd)
        rel, grad_rel = [], []
        for s in range(1, args.seeds + 1):
            got, g = losses(args.model, scale, args.wd, s)
            rel.append([abs(a / b - 1) for a, b in zip(got, base)])
            grad_rel.append(((g - g0).abs().max() / g0.abs().max()).item())
        worst = [max(r[i] for r in rel) for i in range(3)]
        print(f"{args.model} table x{scale}, wd {args.wd}: losses before "
              f"the table's L2 {base}; under one "
              f"rounding of the step-1 rows they move by (relative, worst "
              f"of {args.seeds} seeds) {worst}; the step-1 row gradient "
              f"by {max(grad_rel)} of its max |g| {g0.abs().max().item()}")
        out[str(scale)] = {"losses": base, "rel_change": worst,
                           "row_grad_rel_change": max(grad_rel)}
    print(json.dumps({"model": args.model, "wd": args.wd, "device": "cpu",
                      **out}))


if __name__ == "__main__":
    main()

"""bf16 compute's card-vs-CPU gaps, over several seeds: phase 19 (b) of
chip_smoke.py (the Predictor and 3 steps of the flagship MMoE and of
HiNet in compute_dtype="bfloat16", the CPU on the card's branches) run
with three batch seeds, to set chip_smoke.py's BF16_* limits from what
is measured.  The first seed also runs phase 19 (b)'s Trainer.fit
epochs.  Run from the repository root on one card:

    python3 scripts/bf16_card_gaps.py [--out PATH]

Prints a line per seed and model (Predictor max abs err, the bf16-vs-
float32 Predictor gap, loss and row-gradient gaps, the table share beyond
1e-6, the branches replayed) and the fits' summary; with --out, the whole
result goes to PATH as JSON.  Each check in the run uses chip_smoke.py's
limits as they stand.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="write the whole result here as JSON")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpurec_torch.ops import _build

    gpu = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]
    tag = f"[{gpu}]"
    _build.build()
    dev = torch.device("cuda")
    out = []
    fit = cs.bf16_fit
    for seed in (0, 1, 2):
        if seed:                 # the fits once, with the first seed
            cs.bf16_fit = lambda *a, **k: {
                "valid_total_auc": float("nan"),
                "valid_mean_auc": float("nan"), "steps": 0, "step_ms": 0.0}
        out.append(cs.bf16_main_path(dev, np.random.default_rng(100 + seed),
                                     tag, float("nan")))
    cs.bf16_fit = fit
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": gpu, "seeds": out}, f, default=str)
    for i, r in enumerate(out):
        for name in cs.BF16_MODELS:
            v = r[name]["vs_cpu"]
            g = v["row_grad"]
            print(f"{tag} seed {100 + i} {name}: Predictor "
                  f"{r[name]['predictor_max_abs_err']:.3g} (bf16 vs float32 "
                  f"{r[name]['predictor_bf16_vs_f32']:.3g}); loss "
                  f"{v['loss_rel_err']:.3g}, before the table's L2 "
                  f"{v['data_loss_rel_err']:.3g}; row gradient "
                  f"{g['max_abs_err'] / g['max']:.3g} of its max; table "
                  f"share beyond 1e-6 {v['table_share_beyond_1e-6']:.3g}; "
                  f"branches replayed {v['step_flips']}")
    print(json.dumps(out[0]["fit"]))


if __name__ == "__main__":
    main()

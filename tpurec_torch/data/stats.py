"""Dataset sanity statistics (the port's own copy of
``tpurec/data/stats.py``).

The reference prints per-domain counts/positives and train/valid/test
user+item overlap at load time (run.py:143-188); this is that capability as
a reusable function returning a dict (and optionally printing).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def summarize_splits(
    train: Tuple[np.ndarray, np.ndarray],
    valid: Tuple[np.ndarray, np.ndarray],
    test: Tuple[np.ndarray, np.ndarray],
    domain_idx: int,
    userid_idx: int = 0,
    itemid_idx: int = 1,
    verbose: bool = False,
) -> Dict:
    Xtr, ytr = train
    Xva, yva = valid
    Xte, yte = test

    def overlap(a, b):
        sa, sb = set(np.unique(a)), set(np.unique(b))
        inter = len(sa & sb)
        return inter, len(sb), (inter / len(sb) if sb else float("nan"))

    n_domain = int(
        max(Xtr[:, domain_idx].max(), Xva[:, domain_idx].max(),
            Xte[:, domain_idx].max())
    ) + 1
    domain_counts = np.bincount(Xtr[:, domain_idx], minlength=n_domain)
    domain_pos = np.bincount(
        Xtr[:, domain_idx], weights=ytr.reshape(-1), minlength=n_domain
    )

    uv = overlap(Xtr[:, userid_idx], Xva[:, userid_idx])
    ut = overlap(Xtr[:, userid_idx], Xte[:, userid_idx])
    iv = overlap(Xtr[:, itemid_idx], Xva[:, itemid_idx])
    it = overlap(Xtr[:, itemid_idx], Xte[:, itemid_idx])

    total = len(ytr) + len(yva) + len(yte)
    stats = {
        "n_rows": {"train": len(ytr), "valid": len(yva), "test": len(yte)},
        "split_fractions": {
            "train": len(ytr) / total, "valid": len(yva) / total,
            "test": len(yte) / total,
        },
        "n_domain": n_domain,
        "domain_counts": domain_counts.tolist(),
        "domain_positives": domain_pos.astype(int).tolist(),
        "domain_ctr": (
            domain_pos / np.maximum(domain_counts, 1)
        ).round(4).tolist(),
        "user_overlap": {
            "valid_in_train": {"inter": uv[0], "total": uv[1], "frac": uv[2]},
            "test_in_train": {"inter": ut[0], "total": ut[1], "frac": ut[2]},
        },
        "item_overlap": {
            "valid_in_train": {"inter": iv[0], "total": iv[1], "frac": iv[2]},
            "test_in_train": {"inter": it[0], "total": it[1], "frac": it[2]},
        },
    }
    if verbose:
        print(f"train:valid:test = "
              f"{stats['split_fractions']['train']:.2f}:"
              f"{stats['split_fractions']['valid']:.2f}:"
              f"{stats['split_fractions']['test']:.2f}")
        print("counts per domain (train):", domain_counts)
        print(f"{uv[0]}/{uv[1]} ({uv[2]:.2f}) users in valid exist in train")
        print(f"{ut[0]}/{ut[1]} ({ut[2]:.2f}) users in test exist in train")
        print(f"{iv[0]}/{iv[1]} ({iv[2]:.2f}) items in valid exist in train")
        print(f"{it[0]}/{it[1]} ({it[2]:.2f}) items in test exist in train")
    return stats

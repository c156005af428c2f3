"""Host time of ``Predictor.predict_async`` on the card, split into its
submission and its fetch, against the path it replaced (each chunk's ids
copied from pageable memory with a blocking copy, each chunk's
probabilities copied back by ``.cpu()`` in the fetch) and against itself
with a blocking-sync event (the fetch's thread sleeps until the card is
done instead of spinning), in turns in one process on one Predictor of
the flagship MMoE (seeded weights, bfloat16 table, ``--bs`` 4096 as the
HTTP host runs it); then each step the pinned path adds, and each it
drops, timed alone.

    python scripts/time_predict_submit.py [--rows 1 4096 10000]
        [--pairs 12] [--calls 200]

Prints one JSON line per request size (medians over the pairs of each
path's per-call medians, ms) and one for the steps (us a call).  Needs a
card; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FIELD_DIMS = (
    250000, 10, 10, 10, 10, 10, 10, 10, 10,
    1368287,
    50,
    5000, 400, 3000, 80, 80, 60, 30, 12, 12, 12, 12, 4,
)
DOMAIN_IDX, N_DOMAIN, N_TOWER = 10, 50, 4
MODEL = dict(model="mmoe", embed_dim=16, mmoe_expert_dims=(256, 128, 64),
             mmoe_tower_dims=(64, 32), use_atten=True, atten_embed_dim=64,
             att_layer_num=3, att_head_num=2)
BS = 4096


def blocking_predict_async(pred, X):
    """The submission ``predict_async`` had before pinned staging."""
    X = np.asarray(X).astype(np.int32)
    n, bs = X.shape[0], pred.batch_sizes[-1]
    parts = []
    for lo in range(0, n, bs):
        hi = min(lo + bs, n)
        xb = X[lo:hi]
        if hi - lo < bs:
            bs_t = next(b for b in pred.batch_sizes if b >= hi - lo)
            xb = np.concatenate(
                [xb, np.zeros((bs_t - (hi - lo), X.shape[1]), X.dtype)])
        x = torch.from_numpy(np.ascontiguousarray(xb)).to(pred.device)
        parts.append((pred._forward(x), hi - lo))

    def result():
        out = np.empty((n,), np.float32)
        lo = 0
        for p, take in parts:
            out[lo:lo + take] = p[:take].cpu().numpy()
            lo += take
        return out

    return result


def with_blocking_sync_event(submit):
    """``submit`` with every ``torch.cuda.Event`` it makes created with
    ``blocking=True``."""
    def call(X):
        event = torch.cuda.Event
        torch.cuda.Event = functools.partial(event, blocking=True)
        try:
            return submit(X)
        finally:
            torch.cuda.Event = event
    return call


def calls(submit, X, n):
    """n submissions and fetches -> (median submit ms, median fetch ms,
    median total ms)."""
    sub, fet = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        fetch = submit(X)
        t1 = time.perf_counter()
        fetch()
        t2 = time.perf_counter()
        sub.append(t1 - t0)
        fet.append(t2 - t1)
    tot = np.add(sub, fet)
    return (1e3 * float(np.median(sub)), 1e3 * float(np.median(fet)),
            1e3 * float(np.median(tot)))


def steps_us(pred, n=1000):
    """Each step of one 1-row request's chunk, timed alone, then the two
    submissions whole and the forward after each kind of copy (host us a
    call, the card synchronized outside the timed call)."""
    dev = pred.device
    F = len(FIELD_DIMS)
    X = np.zeros((1, F), np.int32)
    xh = torch.empty((BS, F), dtype=torch.int32, pin_memory=True)
    x = xh.to(dev)
    with torch.inference_mode():
        p = pred._forward(x)
    ph = torch.empty((BS,), dtype=torch.float32, pin_memory=True)
    stream = torch.cuda.current_stream(dev)
    done = torch.cuda.Event(blocking=True)
    done.record(stream)

    def fill():
        xa = xh.numpy()
        xa[:1] = X
        xa[1:] = 0

    steps = {
        "pinned ids block": lambda: torch.empty(
            (BS, F), dtype=torch.int32, pin_memory=True),
        "pinned probabilities block": lambda: torch.empty(
            (BS,), dtype=torch.float32, pin_memory=True),
        "fill the pinned ids": fill,
        "ids to the card, non_blocking": lambda: xh.to(dev,
                                                      non_blocking=True),
        "probabilities back, non_blocking": lambda: ph[:1].copy_(
            p[:1], non_blocking=True),
        "event (blocking sync) and record": lambda: torch.cuda.Event(
            blocking=True).record(stream),
        "event (spin) and record": lambda: torch.cuda.Event().record(stream),
        "wait on a passed event (blocking sync)": done.synchronize,
        "forward of the chunk": lambda: pred._forward(x),
        "old: pad by np.concatenate": lambda: np.concatenate(
            [X, np.zeros((BS - 1, F), np.int32)]),
        "old: ids to the card, blocking": lambda: torch.from_numpy(
            np.zeros((BS, F), np.int32)).to(dev),
        "old: probabilities back, .cpu()": lambda: p[:1].cpu().numpy(),
        # the two submissions whole, and the forward after each copy
        "submission, pinned path": lambda: pred.predict_async(X),
        "submission, blocking path": lambda: blocking_predict_async(pred, X),
        "forward after ids to the card, non_blocking": lambda: pred._forward(
            xh.to(dev, non_blocking=True)),
        "forward after ids to the card, blocking": lambda: pred._forward(
            torch.from_numpy(np.zeros((BS, F), np.int32)).to(dev)),
    }
    out = {}
    with torch.inference_mode():
        for name, fn in steps.items():
            ts = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            out[name] = 1e6 * float(np.median(ts))
    torch.cuda.synchronize()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, nargs="+", default=[1, 4096, 10000])
    ap.add_argument("--pairs", type=int, default=12,
                    help="rounds of the three paths in turn")
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_predict_submit.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    from tpurec_torch.config import Config, ModelConfig
    from tpurec_torch.serve import Predictor
    from tpurec_torch.train import Trainer

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(gpu, flush=True)
    torch.manual_seed(0)
    cfg = Config(model=ModelConfig(**MODEL))
    d2g = np.arange(N_DOMAIN) % N_TOWER
    tr = Trainer(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX, domain2group=d2g)
    pred = Predictor(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX, domain2group=d2g,
                     batch_sizes=(BS,), table_dtype="bfloat16"
                     ).load_from_trainer(tr).warm()
    del tr
    rng = np.random.default_rng(0)
    paths = {"pinned": pred.predict_async,
             "pinned, blocking-sync event": with_blocking_sync_event(
                 pred.predict_async),
             "blocking": lambda X: blocking_predict_async(pred, X)}
    for n in args.rows:
        X = np.stack([rng.integers(0, d, n) for d in FIELD_DIMS], 1)
        check = [f(X)() for f in paths.values()]
        if not all(np.array_equal(c, check[0]) for c in check):
            sys.exit(f"rows={n}: the paths' probabilities differ")
        runs = {k: [] for k in paths}
        names = list(paths)
        for i in range(args.pairs):
            # each path first, in the middle and last in turn
            for k in names[i % 3:] + names[:i % 3]:
                runs[k].append(calls(paths[k], X, args.calls))
        line = {"rows": n, "pairs": args.pairs, "calls": args.calls,
                "device": gpu}
        for k, rs in runs.items():
            a = np.asarray(rs)
            line[k] = {"submit_ms": float(np.median(a[:, 0])),
                       "fetch_ms": float(np.median(a[:, 1])),
                       "total_ms": float(np.median(a[:, 2])),
                       "total_ms_each": [round(float(t), 4) for t in a[:, 2]]}
        line["won_against_blocking"] = {
            k: int(sum(p[2] < b[2] for p, b in zip(runs[k],
                                                   runs["blocking"])))
            for k in names[:2]}
        print(json.dumps(line), flush=True)
    print(json.dumps({"steps_us": steps_us(pred), "device": gpu}), flush=True)


if __name__ == "__main__":
    main()

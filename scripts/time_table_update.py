"""Time the hybrid training step's table update on one CUDA card:
``EmbeddingUpdater.update`` at the flagship's 23 fields (a 1,627,120-row x
16 table), B=512 and bfloat16 moments, through the public API, so that it
runs on any tree of the port.  For each case (the batch's own ids, and
every big-field id equal) it prints the device time by kernel and the
launches a call (torch.profiler over 20 calls), and the host ms a call
(median of 20 calls, each ended by a synchronize); then the sweep alone
(``fused_decay_adam`` without ids, kernel 7) the same way.  The last line
is one JSON object.

It imports the ``tpurec_torch`` of the working directory, so running it
from the roots of two checkouts in turns (parent, change, change, parent)
compares two commits on one card:

    (cd ../parent && python3 ../repo/scripts/time_table_update.py)
    python3 scripts/time_table_update.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())
from tpurec_torch.config import TrainConfig  # noqa: E402
from tpurec_torch.ops.fused_adam import fused_decay_adam  # noqa: E402
from tpurec_torch.train.hybrid import EmbeddingUpdater  # noqa: E402
from tpurec_torch.train.sparse import SparseEmbedState  # noqa: E402

# the flagship schema of chip_smoke.py (bench.py's 23 Ali-CCP-shaped fields)
FIELD_DIMS = (
    250000, 10, 10, 10, 10, 10, 10, 10, 10,
    1368287,
    50,
    5000, 400, 3000, 80, 80, 60, 30, 12, 12, 12, 12, 4,
)
B, D, N_CALLS = 512, 16, 20
LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")


def measure(fn):
    """-> (device us a call by kernel name, launches a call, host ms a call
    (median, synchronized))."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(N_CALLS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(N_CALLS):
            fn()
        torch.cuda.synchronize()
    evs = prof.key_averages()
    dev = {e.key: e.self_device_time_total / N_CALLS for e in evs
           if str(e.device_type).endswith("CUDA")
           and e.self_device_time_total > 0}
    launches = sum(e.count for e in evs if e.key in LAUNCH_EVENTS) / N_CALLS
    return dev, launches, float(np.median(host))


def main():
    if not torch.cuda.is_available():
        sys.exit("time_table_update: no CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    upd = EmbeddingUpdater(FIELD_DIMS, TrainConfig(
        bs=B, embedding_moments_dtype="bfloat16"), 1e-5)
    gen = torch.Generator(device=dev).manual_seed(0)
    V = upd.vocab
    table = torch.randn(V, D, device=dev, generator=gen)
    st = SparseEmbedState(
        m=(torch.randn(V, D, device=dev, generator=gen) * 0.01).to(
            torch.bfloat16),
        v=(torch.rand(V, D, device=dev, generator=gen) * 1e-4).to(
            torch.bfloat16))
    rng = np.random.default_rng(0)
    X = np.stack([rng.integers(0, d, B) for d in FIELD_DIMS], 1)
    # every big-field id on one row: field f's id i is row offsets[f] + i
    offs = np.asarray(upd.layout.offsets)
    same = X.copy()
    same[:, upd.big] = offs[upd.big[0]] + 7 - offs[upd.big]
    g_rows = torch.randn(B * len(FIELD_DIMS), D, device=dev, generator=gen)
    out = {"device": gpu, "n_big_ids": B * len(upd.big), "cases": {}}
    print(f"{gpu}: table {V} x {D}, B={B}, {len(upd.big)} big fields "
          f"({B * len(upd.big)} row ids a call), bf16 moments")
    cases = {name: torch.from_numpy(x.astype(np.int32)).to(dev)
             for name, x in (("batch", X), ("all_equal", same))}
    g_small = torch.randn(upd.S, D, device=dev, generator=gen)
    calls = {name: (lambda x=x: upd.update(table, st, x, g_rows, 5))
             for name, x in cases.items()}
    calls["sweep_alone"] = lambda: fused_decay_adam(
        table, st.m, st.v, g_small, 5, lr=1e-3, coef=2e-5)
    for name, fn in calls.items():
        dev_us, launches, host_ms = measure(fn)
        busy = sum(dev_us.values())
        out["cases"][name] = {"device_us": dev_us, "busy_us": busy,
                              "launches": launches, "host_ms": host_ms}
        print(f"{name}: host {host_ms:.4f} ms a call (median of {N_CALLS}, "
              f"synchronized); {launches:.0f} launches a call; device busy "
              f"{busy:.2f} us:" + "".join(
                  f"\n    {us:9.2f} us  {k[:100]}" for k, us in sorted(
                      dev_us.items(), key=lambda kv: -kv[1])))
    print(json.dumps(out))


if __name__ == "__main__":
    main()

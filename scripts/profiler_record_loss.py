"""Count the kernel records torch.profiler keeps on one CUDA card, capture
after capture, in one process: how many of a fixed workload's launches
each capture records, and whether the shortfall grows with the process's
age or with the number of captures taken before it.

The workload is KINDS distinct elementwise kernels launched in order,
CALLS times a capture, so the record count of each kind shows which
launches went missing (the first kinds are the first launches).  The
phases:

1. one capture at once;
2. an idle pause of ``--idle`` seconds, then one capture: age alone;
3. ``--captures`` captures back to back, cycling through four variants:
   CUDA activity only or CPU and CUDA, each with and without ``--markers``
   spin kernels (synchronized) opening the window, as ``chip_smoke.py``'s
   ``open_capture_window`` does.

It prints one line per phase and per block of captures, writes every
capture's counts to ``chiprun_out/profiler_record_loss.json`` when that
directory exists, and prints one JSON object as its last line.

    python3 scripts/profiler_record_loss.py [--captures 240] [--idle 30]
        [--markers 4]
"""

import argparse
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

# launch order within a call, and a piece of each kernel's name
KINDS = ("add", "mul", "clamp", "neg", "abs", "sqrt", "sin", "cos")
PATTERNS = ("add", "mul", "clamp", "neg_kernel", "absfunctor",
            "sqrt_kernel", "sin_kernel", "cos_kernel")
CALLS = 5


def work(x):
    for _ in range(CALLS):
        x.add_(1.0)
        x.mul_(0.5)
        x.clamp_(-4.0, 4.0)
        x.neg_()
        x.abs_()
        x.sqrt_()
        x.sin_()
        x.cos_()


def kind_of(key):
    low = key.lower()
    for k, pat in zip(KINDS, PATTERNS):
        if pat in low:
            return k
    return None


def capture(x, cpu, markers):
    acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * cpu
    with profile(activities=acts) as prof:
        if markers:
            for _ in range(markers):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        work(x)
        torch.cuda.synchronize()
    counts = dict.fromkeys(KINDS, 0)
    other = 0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") or "spin_kernel" in e.key:
            continue
        k = kind_of(e.key)
        if k is None:
            other += e.count
        else:
            counts[k] += e.count
    return {"recorded": sum(counts.values()) + other, "by_kind": counts,
            "other": other}


def kernel_names(x):
    """The device kernels one call of the workload launches, by name."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        work(x)
        torch.cuda.synchronize()
    return sorted(e.key[:100] for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--captures", type=int, default=240)
    ap.add_argument("--idle", type=float, default=30.0)
    ap.add_argument("--markers", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_record_loss: no CUDA device")
    t0 = time.perf_counter()
    x = torch.rand(1 << 16, device="cuda")
    work(x)
    torch.cuda.synchronize()
    want = CALLS * len(KINDS)
    rows = []

    def take(phase, i, cpu, markers):
        r = capture(x, cpu, markers)
        r.update(phase=phase, i=i, cpu=cpu, markers=markers,
                 age_s=time.perf_counter() - t0)
        rows.append(r)
        return r

    r = take("first", 0, False, False)
    print(f"first capture: {r['recorded']} of {want} launches recorded, "
          f"by kind {r['by_kind']}, other {r['other']}")
    time.sleep(args.idle)
    r = take("after_idle", 0, False, False)
    print(f"after {args.idle:g} s idle: {r['recorded']} of {want}, by kind "
          f"{r['by_kind']}")
    m = args.markers
    variants = [(False, 0), (True, 0), (False, m), (True, m)]
    block = 40
    for i in range(args.captures):
        cpu, markers = variants[i % 4]
        take("series", i + 1, cpu, markers)
        if (i + 1) % block == 0:
            last = rows[-block:]
            parts = []
            for cpu, markers in variants:
                got = [r["recorded"] for r in last
                       if (r["cpu"], r["markers"]) == (cpu, markers)]
                parts.append(f"{'cpu+cuda' if cpu else 'cuda'}"
                             f"{' +markers' if markers else ''} "
                             f"min {min(got)} mean {sum(got) / len(got):.2f}")
            print(f"captures {i + 2 - block}..{i + 1} (age "
                  f"{last[-1]['age_s']:.1f} s), of {want}: "
                  + "; ".join(parts))
    print("kernels:\n  " + "\n  ".join(kernel_names(x)))
    short = [r for r in rows if r["recorded"] < want]
    first_kind = {}
    for r in short:
        lost = [k for k in KINDS if r["by_kind"][k] < CALLS]
        if lost:
            first_kind[lost[0]] = first_kind.get(lost[0], 0) + 1
    if os.path.isdir("chiprun_out"):
        with open("chiprun_out/profiler_record_loss.json", "w") as f:
            json.dump(rows, f)
    print(json.dumps({
        "launches_per_capture": want, "captures": len(rows),
        "short": len(short),
        "short_by_variant": {
            f"{'cpu+cuda' if c else 'cuda'}{'+markers' if m else ''}":
            sum(1 for r in short if (r["cpu"], r["markers"]) == (c, m))
            for c, m in variants},
        "most_lost": max((want - r["recorded"] for r in rows), default=0),
        "first_kind_short": first_kind,
        "device": torch.cuda.get_device_name(0),
        "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()

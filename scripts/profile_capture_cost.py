"""Where a torch.profiler capture's time goes on one CUDA card, and
whether ``chip_smoke.capture_records`` reads the same records as
``key_averages``.

Two workloads of the flagship MMoE at phase 16's settings
(``chip_smoke.harness_config``): 16 indexed training steps (one call)
and 10 eval calls of 512 rows through ``Trainer.predict``.  Each is
captured with CUDA activity alone and with CPU activity too, the window
opened as ``chip_smoke.profile_calls`` opens it.  For each capture it
prints the seconds of the with-block's start, the window, its exit,
``capture_records`` and ``key_averages``; and whether the two give the
same kernel names, counts and device microseconds, the same host launch
count and the same kernel count (``chip_smoke.device_kernels``).  The
last line is one JSON object; it exits 1 where they differ.

    python3 scripts/profile_capture_cost.py
"""

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as C  # noqa: E402


def main() -> int:
    from torch.profiler import ProfilerActivity, profile

    from tpurec_torch.data import make_synthetic
    from tpurec_torch.train import Trainer

    start = C._phase_alone("profile capture cost")
    if start is None:
        return 1
    dev, _ = start
    data = make_synthetic(n_rows=C.FIT_ROWS, n_fields=len(C.FIELD_DIMS),
                          n_domain=C.N_DOMAIN, field_dims=C.FIELD_DIMS,
                          domain_idx=C.DOMAIN_IDX, seed=1)
    X, y = data.train
    tr = Trainer(C.harness_config(epoch=1), C.FIELD_DIMS, C.N_DOMAIN,
                 C.DOMAIN_IDX, domain2group=np.arange(C.N_DOMAIN) % C.N_TOWER)
    Xdev, ydev, d2g = tr._device_dataset(X, y)
    idx = torch.as_tensor(np.random.default_rng(0).integers(
        0, len(y), (16, 512), dtype=np.int32), device=dev)
    ones = torch.ones((16, 512), device=dev)
    Xv = data.valid[0][:512]
    workloads = {
        "train16": lambda: tr.scan_steps_idx(tr.state, Xdev, ydev, d2g, idx,
                                             ones, tr.dropout_gen),
        "eval10": lambda: [tr.predict(Xv) for _ in range(10)]}
    out, same_all = [], True
    for label, run in workloads.items():
        run()
        torch.cuda.synchronize()
        for cpu in (True, False):
            acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * cpu
            t0 = time.perf_counter()
            with profile(activities=acts) as prof:
                C.open_capture_window()
                t1 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            t3 = time.perf_counter()
            card, host = C.capture_records(prof)
            t4 = time.perf_counter()
            evs = prof.key_averages()
            t5 = time.perf_counter()
            ka = {e.key: [e.count, e.self_device_time_total] for e in evs
                  if str(e.device_type).endswith("CUDA")
                  and not getattr(e, "is_user_annotation", False)}
            ka_launched = sum(e.count for e in evs if e.key in C.LAUNCH_KEYS)
            ka_kernels = sum(c for k, (c, _) in ka.items()
                             if not k.startswith(("Memcpy", "Memset"))
                             and not C.is_marker(k))
            launched = sum(host.get(k, 0) for k in C.LAUNCH_KEYS)
            same = (set(ka) == set(card)
                    and all(ka[k][0] == card[k][0]
                            and abs(ka[k][1] - card[k][1]) <= 1e-6 * max(
                                1.0, ka[k][1]) for k in ka)
                    and ka_launched == launched
                    and ka_kernels == C.device_kernels(card))
            same_all &= same
            r = {"workload": label, "cpu": cpu, "start_s": t1 - t0,
                 "window_s": t2 - t1, "exit_s": t3 - t2,
                 "capture_records_s": t4 - t3, "key_averages_s": t5 - t4,
                 "names": len(card), "launched": launched,
                 "kernels": C.device_kernels(card), "same": same}
            out.append(r)
            print(f"{label} cpu={cpu}: start {r['start_s']:.3f} s, window "
                  f"{r['window_s']:.3f} s, exit {r['exit_s']:.3f} s, "
                  f"capture_records {r['capture_records_s']:.3f} s, "
                  f"key_averages {r['key_averages_s']:.3f} s; {len(card)} "
                  f"names, {launched} host launches, {r['kernels']} kernels; "
                  f"the same records: {same}", flush=True)
    print(json.dumps({"captures": out, "same": same_all}))
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())

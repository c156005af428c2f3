"""Device time of the attention forward kernels and the cross-network
kernels on one CUDA card: kernel 2 (the stack's forward, eval, at the
MMoE serving chunk's shapes B = 512 and 4096), kernel 4 (one layer's
forward at the layered call's shapes, B=512), kernel 8 (the cross stack's
forward, B = 512 and 4096) and kernel 9 (its backward, B=512), at F=23,
D=16, A=64, H=2, L=3 and the DCN's D=368, L=3; each from torch.profiler
over 20 back-to-back calls of its wrapper, every launch of the call
counted (kernel 9 is one launch now, two before).  Prints one JSON line.

It imports the ``tpurec_torch`` of the working directory, so running it
from the roots of two checkouts in turns (parent, change, change, parent)
compares two commits on one card:

    (cd ../parent && python3 ../repo/scripts/time_kernels.py)
    python3 scripts/time_kernels.py
"""

import json
import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())
from tpurec_torch.ops import attention as att  # noqa: E402
from tpurec_torch.ops import cross_network as cn  # noqa: E402

F, D, A, H, L = 23, 16, 64, 2, 3
CROSS_D, CROSS_L = 368, 3
N_CALLS = 20
# the kernels' symbols in this tree or its parent's
SYMBOLS = {
    "field_attention": ("field_attention_kernel",),
    "attention_layer": ("attention_layer_kernel",),
    "cross_network": ("cross_fwd_kernel",),
    "cross_network_bwd": ("cross_bwd_kernel", "sum_partials_kernel"),
}


def main():
    if not torch.cuda.is_available():
        sys.exit("time_kernels: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def mk(*s, scale=0.2):
        return torch.from_numpy(
            (rng.normal(size=s) * scale).astype(np.float32)).to(dev)

    flat = [mk(D, A), mk(A), mk(D, A), mk(A)]
    for _ in range(L):
        flat += [mk(A, 3 * A), mk(3 * A), mk(A, A), mk(A)]
    embs = {B: mk(B, F, D, scale=1.0) for B in (512, 4096)}
    x = att.field_attention_fwd(embs[512], flat, L, H, 0.2,
                                torch.tensor(5, device=dev), True)[1][1]
    x = x.contiguous()
    cw = mk(CROSS_L, CROSS_D, scale=CROSS_D ** -0.5)
    cb = mk(CROSS_L, CROSS_D, scale=0.1)
    cx = {B: mk(B, CROSS_D, scale=1.0) for B in (512, 4096)}
    cg = mk(512, CROSS_D, scale=1.0)
    calls = [
        ("field_attention", 512,
         lambda: att.field_attention_fwd(embs[512], flat, L, H)),
        ("field_attention", 4096,
         lambda: att.field_attention_fwd(embs[4096], flat, L, H)),
        ("attention_layer", 512,
         lambda: att.attention_layer_fwd(x, *flat[8:12], H, 1)),
        ("cross_network", 512, lambda: cn.cross_network_fwd(cx[512], cw, cb)),
        ("cross_network", 4096,
         lambda: cn.cross_network_fwd(cx[4096], cw, cb)),
        ("cross_network_bwd", 512,
         lambda: cn.cross_network_bwd(cx[512], cw, cb, cg)),
    ]
    for _, _, fn in calls:
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    out = {"device": torch.cuda.get_device_name(0)}
    for name, B, fn in calls:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(N_CALLS):
                fn()
            torch.cuda.synchronize()
        by_sym = {}
        for ev in prof.key_averages():
            for sym in SYMBOLS[name]:
                if sym in ev.key and ev.self_device_time_total > 0:
                    by_sym[sym] = (by_sym.get(sym, 0.0)
                                   + ev.self_device_time_total / N_CALLS / 1e3)
        if not by_sym:
            sys.exit(f"time_kernels: no device time for {name} B={B}")
        out[f"{name} B={B}"] = {"ms": sum(by_sym.values()),
                                "by_kernel": by_sym}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

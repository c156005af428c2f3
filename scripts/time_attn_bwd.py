"""Device time of the attention backward kernels on one CUDA card: kernel 3
(the stack's backward, at the MMoE training step's shapes) and kernel 5
(one layer's, at the layered call's), B=512, F=23, D=16, A=64, H=2, L=3,
each apart from its ordered reduction (reduce_partials_kernel), from
torch.profiler over 20 back-to-back calls.  Prints one JSON line.

It imports the ``tpurec_torch`` of the working directory, so running it
from the roots of two checkouts in turns (parent, change, change, parent)
compares two commits on one card (kernel 3 gets the forward's output
where the checkout's wrapper takes it):

    (cd ../parent && python3 ../repo/scripts/time_attn_bwd.py)
    python3 scripts/time_attn_bwd.py
"""

import inspect
import json
import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())
from tpurec_torch.ops import attention as att  # noqa: E402

B, F, D, A, H, L = 512, 23, 16, 64, 2, 3
N_CALLS = 20


def main():
    if not torch.cuda.is_available():
        sys.exit("time_attn_bwd: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def mk(*s):
        return torch.from_numpy(
            (rng.normal(size=s) * 0.2).astype(np.float32)).to(dev)

    flat = [mk(D, A), mk(A), mk(D, A), mk(A)]
    for _ in range(L):
        flat += [mk(A, 3 * A), mk(3 * A), mk(A, A), mk(A)]
    emb = mk(B, F, D)
    seed = torch.tensor(5, device=dev)
    y, saved = att.field_attention_fwd(emb, flat, L, H, 0.2, seed, True)
    dy = mk(B, F, A) * 5
    x = saved[1].contiguous()
    # kernel 3 takes the forward's output y since the ReLU repair; a
    # checkout from before it does not
    stack_args = ((emb, dy, saved, y) if "y" in inspect.signature(
        att.field_attention_bwd).parameters else (emb, dy, saved))
    calls = (
        ("field_attention_bwd", "field_attention_bwd_kernel",
         lambda: att.field_attention_bwd(*stack_args, flat, L, H, 0.2,
                                         seed)),
        ("attention_layer_bwd", "attention_layer_bwd_kernel",
         lambda: att.attention_layer_bwd(x, dy, *flat[8:12], H, 1)))
    for _, _, fn in calls:
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    out = {"device": torch.cuda.get_device_name(0)}
    for name, sym, fn in calls:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(N_CALLS):
                fn()
            torch.cuda.synchronize()
        kernel = reduce = 0.0
        for ev in prof.key_averages():
            ms = ev.self_device_time_total / N_CALLS / 1e3
            if sym in ev.key:
                kernel += ms
            elif "reduce_partials_kernel" in ev.key:
                reduce += ms
        out[name] = {"kernel_ms": kernel, "reduce_ms": reduce,
                     "total_ms": kernel + reduce}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

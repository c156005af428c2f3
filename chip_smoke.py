"""Drive tpurec_torch's serving path, training step (under each embedding
update), training harness and CDC engine on one CUDA card, for each model
it ports, in float32 and in bf16 compute, and check them.

    python3 chip_smoke.py            # from the repository root, one card

Phases (any failure exits non-zero and prints no result line):

1. versions: torch, CUDA, nvcc, triton (if present), the card and its
   power limit;
2. build every kernel in tpurec_torch/csrc with nvcc (one process per
   source, in parallel) and print ptxas' register/spill report, then the
   launches of the attention stack's forward, one layer's forward (4) and
   both backward kernels (3, 5) at each batch size (batch rows a block or
   group, weights staged or not, dynamic shared memory, the backward's
   persistent grid) and of the cross network's forward (8: rows a warp,
   warps a block) and backward (9: grid of clusters, rows a warp, warps a
   block); the source's layout held against the wrapper's;
3. hold each serving kernel against its plain PyTorch version on the card,
   at the flagship shapes and ragged batch sizes: the prepared gather
   (EmbeddingGather) bit-exact for float32, bfloat16 and int8 tables
   (out-of-range ids included); the attention stack within 1e-4 at B = 1,
   R - 1, R, R + 1, 512, 513, 4096, 4097 (R its rows a block), bitwise
   repeatable, a NaN in one batch row kept out of its block-mates';
4. the serving path: a Predictor of the flagship MMoE (23 Ali-CCP-shaped
   fields, 1.63M-row table, 4 experts, 4 towers, attention head) with
   seeded random weights and BN statistics scores 5,000 rows; it must
   match the same model on the CPU's plain path within 1e-4, and both
   kernel launch counts must have risen during that run;
5. the HTTP host: /predict with 1, 37 and 5,000 rows equals the direct
   predictions; /healthz and /metrics answer;
6. serving timings: each kernel's wrapper (CUDA events over back-to-back
   calls) beside its plain version, a PyTorch library call computing the
   same function, and its bound; the gather's host enqueue time
   (perf_counter_ns over 1,000 calls, no synchronize) beside
   index_select's, and its device time launched back to back; the
   attention stack launched alone at R = 1, 2, ...
   rows a block; Predictor rows/s and the 1-row HTTP p50 (host clock); a
   profile of one chunk at each batch size;
7. the training kernels against their plain versions: the attention
   forward (same keep mask, read back through the output) and its
   backward against autograd at B = 1, R - 1, R, R + 1, 512, 513, 4097 (R
   the rows a backward group stacks) with dropout 0 and 0.2, and once
   without the residual (bitwise repeatable; dy zeroed where the plain
   pre-ReLU value lies within 1e-4 of 0, where rounding alone sets the
   mask), the table sweep at float32 and bfloat16 moments,
   the training step's table update (one sweep carrying the touched rows
   and the small-field gradient, and its sum's finish: no other port
   kernel) with duplicate ids against the CPU, and at the flagship table
   against the plain version with ids in the small-field prefix, 1,024
   equal ids and ids outside the table, bitwise repeatable; sentinel ids
   write nothing; a swept table value may differ by 1e-6 (2e-6 for the
   update) of the larger of 1, its value and its step, which FMA
   contraction scales where a second moment near 0 makes the step large;
8. the training path: the flagship MMoE's hybrid training step at full
   width (B=512, dropout 0.2, bfloat16 table moments, L2 1e-5) as a K=8
   loop, 8 warm-up and 16 timed steps; all five training kernels must
   launch once per step and the loss must stay finite;
9. 3 full-width steps with dropout 0 on the card against the CPU's plain
   path: the loss and the table after step 1;
10. training timings: each training kernel beside its bound, its plain
    version and a library yardstick (kernel 3 also beside its 3xTF32
    tensor-core bound, launched alone at R = 1, 2, 3 rows a group, staged
    or not; the sweep carrying kernel 6's rows launched alone with the
    batch's ids and with every id on one row, beside the sweep without
    ids); the step's host-clock phases, peak memory, the table update's
    own profile (launches a step, device time by kernel) and a profile
    of the step (device busy share, launches per step, device time by
    kernel, kernel 3's apart from its reduction's, and by launching op,
    host time by op);
11. the DCN and layered-attention kernels against their plain versions:
    the cross network forward (#8) and backward (#9, bitwise repeatable,
    a NaN row spreading into dw/db as in the plain version) at B = 1,
    each side of #9's launch boundaries, 512, 513, 4096, 4097 with D=368,
    L=3, and what #8 and its plain version give for a row holding +inf;
    one attention layer forward (#4) and backward (#5), both bitwise
    repeatable, at phase 7's batch sizes and R - 1, R, R + 1, 511 of #4's
    launch with dropout 0 and 0.2, a NaN in one batch row kept out of #4's
    block-mates; the layered path against the stack (#2, #3) in training
    with one dropout seed (dy zeroed near the ReLU's kink, as in phase 7);
12. the DCN serving path: a Predictor of the full-width DCN (the same 23
    fields and table, mlp (256, 128, 64), 3 cross layers) scores 5,000
    rows against the CPU's plain path within 1e-4 at float32, bfloat16
    and int8 tables, with the gather and #8 counters risen; /predict for
    1 and 5,000 rows; rows/s and a profile per chunk;
13. the DCN training path: the hybrid step at full width as a K=8 loop
    (8 warm-up, 16 timed steps) with gather, #8, #9 and the sweep carrying
    #6's rows once per step, a step profile with the table update's own,
    and 3 steps against the CPU's plain path;
14. the layered attention path as scripts/profile_attn_layered.py drives
    it (the gradient of sum(y**2) at B=512) against the plain version,
    #4 and #5 launching 3 times each;
15. timings of #4, #5, #8 and #9 beside their bounds, plain versions and
    library yardsticks; #4 and #5 also beside their 3xTF32 bounds, #4 at
    R = 1 .. 4 rows a block, #5 at R = 1, 2, 3 rows a group, staged or
    not, and its device time apart from its reduction's; #8 launched alone
    at 1 and 2 rows a warp and 1, 2, 4, 8 warps a block, at B = 512 and
    4096; #9 launched alone at 2, 4 and 8 warps a block; each beside the
    floor of an empty kernel launched as it is;
16. the training harness at full width: make_synthetic(131,072 rows) at
    the flagship schema -> Trainer(...).fit(train, valid, test) of the
    flagship MMoE (B=512, 1 epoch, dropout 0.2, bf16 table moments)
    through the device-resident (indexed) epoch, with the counters of
    kernels 1, 2, 3 and 6/7 read around the fit (a step each, and a
    forward per eval batch); valid AUC at least 0.65; the same epoch
    through the host-batching path from the same initial state (per-step
    losses within 1e-5, valid AUC within 1e-4); streaming against exact
    eval; Predictor.load_from_trainer against predict (1e-5); a
    checkpoint served by predictor_from_checkpoint and loaded by a fresh
    Trainer, both bitwise equal to predict; the small drive recipe (MMoE,
    embed 8, 2 epochs) above AUC 0.7; epoch, eval and checkpoint times and
    a profile of 16 indexed steps;
17. the CDC engine at full width: make_synthetic(131,072 rows) at the
    flagship schema with 4 antipodal domain clusters ->
    CDCTrainer(...).fit(train, valid, test) on the flagship MMoE as CDC's
    base (4 clusters, the reference's CDC defaults, B=512, 3 epochs,
    dropout 0.2, bf16 table moments): the warmup (400 steps), one matrix
    update (50 mask rows at W = 3,584, the baseline and 50 A rows at 512,
    54 B rows, 155 probe evals of 25,600 rows, the clustering) and the
    split-mode epochs; the counters of kernels 1, 2, 3 and 6/7 read around
    the fit against the schedule the trainer built (a step each, a forward
    per probe eval and eval batch); valid AUC at least 0.65 with 4 groups
    and finite matrices; the rollback bitwise with the moments and step
    advanced; one populate row (2 steps at W = 3,584, its 25,600-row
    eval) against the CPU's plain path; a checkpoint through a fresh
    CDCTrainer (bitwise) and predictor_from_checkpoint (1e-5); update,
    warmup, epoch and fit times and a profile of treatment steps at W =
    3,584 and 512;
18. CDC's other base models (PLE, PEPNet, EPNet, STAR) at their
    ModelConfig defaults on the flagship schema: (a) each one's Predictor
    scores 5,000 rows against the CPU's plain path (#1 and #2 counted),
    rows/s and a chunk profile at B = 512 and 4096; its hybrid step as
    phase 8 drives MMoE's (#1, #2, #3 and #6's pass once a step), a step
    profile, and 3 steps against the CPU's plain path; (b) phase 17's
    CDCTrainer.fit on PLE at CDCConfig()'s defaults (4 clusters), with
    phase 17's checks but the treatment profile; (c) STAR as CDC's base
    (called without the group): one populate row at W = 3,584 with its
    25,600-row eval against the CPU.
    A kernel of a path that a profile does not see fails its phase.
19. the group-routed models and bf16 compute: (a) HiNet, ADL, ADL-split
    and AdaSparse at their ModelConfig defaults on the flagship schema,
    as phase 18 (a) drives CDC's bases: the Predictor against the CPU's
    plain path, the K=8 loop with #1, #2, #3 and #6's pass once a step
    and its profile, 3 steps, step 1's row gradient and ADL's centres
    against the CPU, each comparison on the card's branches (ReLU masks,
    ADL's routing, AdaSparse's pruner mask, replayed on the CPU); (b)
    compute_dtype="bfloat16" on the flagship MMoE and on HiNet: the
    Predictor and 3 steps against the CPU's bf16 plain path, and one
    Trainer.fit epoch at phase 16's settings (HiNet's also in float32),
    its valid AUC beside phase 16's.
20. the rest of the zoo and the "dense" and "sparse" embedding updates:
    (a) DeepFM, DCNv2, AutoInt, xDeepFM, IPNN, OPNN and AFM at their
    ModelConfig defaults on the flagship schema, one tower, as phase 19
    (a) drives the routed models: the Predictor against the CPU's plain
    path on the card's branches (#1 counted, and #2 for AutoInt), rows/s
    and a chunk profile at each batch size, the K=8 loop with #1 and #6's
    pass once a step (#2 and #3 too for AutoInt) and its profile, 3 steps
    and step 1's row gradient against the CPU on the card's branches
    (each at its ZOO_SCALE); (b) "dense" and "sparse" on DeepFM and the
    flagship MMoE: the K=8 loop (#1 once a step, #2 and #3 for MMoE, #6's
    pass never), 3 steps against the CPU's plain path on the card's
    branches ("dense": the whole table's gradient, the lookup's
    index_add_ backward), from one state with float32 moments the
    "dense" table against the "hybrid" one after 3 steps and "sparse"'s
    untouched rows and moments bitwise unchanged; one Trainer.fit epoch
    of DeepFM (table init N(0, 0.01**2)) under each of the three updates
    at phase 16's settings, valid AUC at least 0.65 and ms a step.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.  TF32 is off throughout.
"""

from __future__ import annotations

import functools
import itertools
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# the flagship schema (23 Ali-CCP-shaped fields) and model widths
FIELD_DIMS = (
    250000, 10, 10, 10, 10, 10, 10, 10, 10,   # user + 8 user-profile cats
    1368287,                                   # itemid
    50,                                        # domain
    5000, 400, 3000, 80, 80, 60, 30, 12, 12, 12, 12, 4,  # item/context cats
)
DOMAIN_IDX, N_DOMAIN, N_TOWER = 10, 50, 4
# phase 20's single-head models, built with one tower; every other model
# of the script takes N_TOWER
ZOO = ("deepfm", "dcnv2", "autoint", "xdeepfm", "ipnn", "opnn", "afm")
MODEL = dict(model="mmoe", embed_dim=16, mmoe_expert_dims=(256, 128, 64),
             mmoe_tower_dims=(64, 32), use_atten=True, atten_embed_dim=64,
             att_layer_num=3, att_head_num=2)
BATCH_SIZES = (512, 4096)
BATCHES_BWD = (512, 4096)       # the backward launches printed in phase 2
N_ROWS = 5000
SEED = 0
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12          # H100 SXM float32, outside the tensor cores
PEAK_TF32_FLOPS = 495e12        # H100 SXM TF32 tensor cores, dense
GATHER_THREADS, GATHER_PIECES = 256, 2   # kBlock, kUnroll of kernel 1
ATTN_TOL = 1e-4
PRED_TOL = 1e-4


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=60).stdout.strip()


def nan_equal(a, b) -> bool:
    return bool(torch.all((a == b) | (torch.isnan(a) & torch.isnan(b))))


def cuda_ms(fn, iters=50, warmup=5):
    """Mean milliseconds per call of ``fn``, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_enqueue_us(fn, n=1000):
    """Microseconds of host time per call of ``fn`` over ``n`` calls with
    no synchronize in between (perf_counter_ns): what a call costs the
    host, whatever the device does meanwhile."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    us = (time.perf_counter_ns() - t0) / n / 1e3
    torch.cuda.synchronize()
    return us


def tc_bound_ms(flops, nbytes):
    """Kernel 2's bound for the work it issues on the tensor cores: every
    product in three TF32 passes (3xTF32) at the TF32 peak, or its bytes,
    whichever is larger (the f32 bound counts the same flops at the f32
    peak)."""
    return max(3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3


def rows_sweep(dev, emb, flat, L, H, iters=20):
    """Kernel 2 launched through its C entry point at R = 1, 2, ... batch
    rows a block (weights staged, eval), CUDA events over back-to-back
    launches: what stacking rows in a block buys (the wrapper fixes R).
    -> {R: ms}."""
    from tpurec_torch.ops import _build
    from tpurec_torch.ops import attention as att

    lib = _build.load("field_attention", att._SIGNATURES)
    B, F, D = emb.shape
    A = flat[0].shape[1]
    y = torch.empty(B, F, A, device=dev)
    ptrs = att._ptrs(flat)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for R in range(1, 9):
        if att.smem_bytes(F, D, A, H, R) > att.SMEM_LIMIT:
            break

        def run(R=R):
            rc = lib.tpurec_field_attention_fwd(
                emb.data_ptr(), ptrs, B, R, 1, F, D, A, H, L, None,
                att.keep_threshold(0.0), 1.0, 0, y.data_ptr(), None, stream)
            check(rc == 0, f"kernel 2 at R={R}: CUDA error {rc}")
        out[R] = cuda_ms(run, iters=iters, warmup=2)
    return out


def bwd_rows_sweep(launch, F, D, A, H, iters=20):
    """Kernel 3 (D > 0) or 5 (D = 0) launched through its C entry point
    (``launch(R, stage)`` -> its return code) at R = 1, 2, 3 batch
    rows a group, w_in/w_out staged or read from device memory, on the
    persistent grid bwd_grid gives; CUDA events over back-to-back launches,
    the ordered reduction included: what the wrapper's choice of R and
    staging buys.  -> {"R=r staged|unstaged": ms, or None where the block
    does not fit}."""
    from tpurec_torch.ops import attention as att

    out = {}
    for R in (1, 2, 3):
        for stage in (True, False):
            key = f"R={R} {'staged' if stage else 'unstaged'}"
            if att.bwd_smem_bytes(F, D, A, H, R, stage) > att.SMEM_LIMIT:
                out[key] = None
                continue

            def run(R=R, stage=stage):
                rc = launch(R, stage)
                check(rc == 0, f"backward sweep {key}: CUDA error {rc}")
            out[key] = cuda_ms(run, iters=iters, warmup=2)
    return out


def port_kernel(key: str, name: str) -> bool:
    """Whether a profiler kernel name is the port's kernel ``name`` (its
    kernels live in an anonymous namespace at the top level; PyTorch has
    kernels of the same short names inside its own namespaces)."""
    return key.removeprefix("void ").startswith(
        f"(anonymous namespace)::{name}")


def attention_launch(dev):
    """Phase 2: kernel 2's launch at the flagship shapes per batch size
    (rows a block, weights staged or not, dynamic shared memory), the
    source's layout held against the wrapper's.  -> {B: (R, stage,
    smem)}."""
    from tpurec_torch.ops import _build
    from tpurec_torch.ops import attention as att

    lib = _build.load("field_attention", att._SIGNATURES)
    F, D = len(FIELD_DIMS), MODEL["embed_dim"]
    A, H = MODEL["atten_embed_dim"], MODEL["att_head_num"]
    n_sm = att._sm_count(dev)
    out = {}
    for B in (1,) + BATCH_SIZES:
        R, stage, smem = att.fwd_config(B, F, D, A, H, n_sm)
        c = lib.tpurec_field_attention_smem_bytes(R, F, D, A, H, int(stage))
        check(c == smem, f"kernel 2 layout: source {c} B, wrapper {smem} B")
        out[B] = (R, stage, smem)
        print(f"  field_attention_kernel B={B}: {R} batch rows a block, "
              f"{-(-B // R)} blocks of {att.FWD_THREADS} threads, weights "
              f"{'staged' if stage else 'from device memory'}, {smem} B of "
              f"dynamic shared memory ({n_sm} SMs)")
    # kernel 4: one layer, kernel 2's launch without the embedding operands
    for B in (1,) + BATCH_SIZES:
        R, stage, smem = att.layer_fwd_config(B, F, A, H, n_sm)
        c = lib.tpurec_attention_layer_smem_bytes(R, F, A, H, int(stage))
        check(c == smem, f"kernel 4 layout: source {c} B, wrapper {smem} B")
        out[("attention_layer_kernel", B)] = (R, stage, smem)
        print(f"  attention_layer_kernel B={B}: {R} batch rows a block, "
              f"{-(-B // R)} blocks of {att.FWD_THREADS} threads, w_in/w_out "
              f"{'staged' if stage else 'from device memory'}, {smem} B of "
              f"dynamic shared memory")
    # the backward kernels (3: the stack, 5: one layer)
    for name, cfg, src in (
            ("field_attention_bwd_kernel",
             lambda B: att.bwd_config(B, F, D, A, H, n_sm),
             lambda R, st: lib.tpurec_field_attention_bwd_smem_bytes(
                 R, F, D, A, H, st)),
            ("attention_layer_bwd_kernel",
             lambda B: att.layer_bwd_config(B, F, A, H, n_sm),
             lambda R, st: lib.tpurec_attention_layer_bwd_smem_bytes(
                 R, F, A, H, st))):
        for B in (1,) + BATCHES_BWD:
            R, stage, smem, grid = cfg(B)
            c = src(R, int(stage))
            check(c == smem, f"{name} layout: source {c} B, wrapper {smem} B")
            out[(name, B)] = (R, stage, smem, grid)
            print(f"  {name} B={B}: {R} batch rows a group, {-(-B // R)} "
                  f"groups on a persistent grid of {grid} blocks of "
                  f"{att.FWD_THREADS} threads, w_in/w_out "
                  f"{'staged' if stage else 'from device memory'}, {smem} B "
                  f"of dynamic shared memory")
    return out


def cross_launch(dev):
    """Phase 2: kernel 8's launch (rows a warp, warps a block, grid) and
    kernel 9's (grid of clusters, rows a warp, warps a block, dynamic
    shared memory, partial sums) at the DCN shapes (D=368, L=3) per batch
    size, the source's layout held against the wrapper's.  -> {B: (warps,
    rows a warp, grid, smem)} of kernel 9."""
    from tpurec_torch.ops import _build
    from tpurec_torch.ops import attention as att
    from tpurec_torch.ops import cross_network as cn

    lib = _build.load("cross_network", cn._SIGNATURES)
    L = DCN_MODEL["n_cross_layers"]
    D = len(FIELD_DIMS) * DCN_MODEL["embed_dim"]
    n_sm = att._sm_count(dev)
    out = {}
    for B in (1,) + BATCH_SIZES:
        W, K, grid, smem = cn.bwd_config(B, D, L, 4, n_sm)
        c = lib.tpurec_cross_network_bwd_smem_bytes(D, L, 4, W)
        k = lib.tpurec_cross_network_rows_per_warp(D, 4)
        check(c == smem and k == K, f"kernel 9 layout: source {c} B, {k} "
              f"rows a warp; wrapper {smem} B, {K}")
        out[B] = (W, K, grid, smem)
        print(f"  cross_bwd_kernel B={B}: grid {grid} ({grid // cn.CLUSTER} "
              f"clusters of {cn.CLUSTER}), {W} warps a block, {K} rows a "
              f"warp at a time, {-(-B // (grid * W * K))} pass(es), {smem} B "
              f"of dynamic shared memory, partial sums "
              f"{grid // cn.CLUSTER * 2 * L * D * 4} B")
        K, W, grid = cn.fwd_config(B, D, L, 4, n_sm)
        check(K in (1, k), f"kernel 8: source {k} rows a warp, wrapper {K}")
        print(f"  cross_fwd_kernel B={B}: {K} rows a warp, {W} warps a "
              f"block, grid {grid}, no shared memory")
    return out


def towers(name):
    """The tower count model ``name`` is built with."""
    return 1 if name in ZOO else N_TOWER


def random_ids(rng, n):
    return np.stack([rng.integers(0, d, n) for d in FIELD_DIMS],
                    1).astype(np.int32)


def attn_flops_per_row(F, D, A, H, L):
    hd = A // H
    return 2 * F * D * A * 2 + L * (2 * F * A * 3 * A + 4 * H * F * F * hd
                                    + 2 * F * A * A)


def sdpa_stack(emb, flat, L, H, dropout_p=0.0):
    """The attention stack from PyTorch library calls (timed as a
    yardstick only; the port never calls it)."""
    B, F, _ = emb.shape
    w_emb, b_emb, w_res, b_res = flat[:4]
    A = w_emb.shape[1]
    x = torch.addmm(b_emb, emb.reshape(B * F, -1), w_emb).reshape(B, F, A)
    for l in range(L):
        x = sdpa_layer(x, *flat[4 + 4 * l: 8 + 4 * l], H, dropout_p)
    res = torch.addmm(b_res, emb.reshape(B * F, -1), w_res)
    return torch.relu(x.reshape(B * F, A) + res).reshape(B, F, A)


def sdpa_layer(x, w_in, b_in, w_out, b_out, H, dropout_p=0.0):
    """One attention layer [B, F, A] from PyTorch library calls (a
    yardstick only; the port never calls it)."""
    import torch.nn.functional as Fn

    B, F, A = x.shape
    qkv = torch.addmm(b_in, x.reshape(B * F, A), w_in).reshape(
        B, F, 3, H, A // H)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    o = Fn.scaled_dot_product_attention(q, k, v, dropout_p=dropout_p)
    return torch.addmm(b_out, o.transpose(1, 2).reshape(B * F, A),
                       w_out).reshape(B, F, A)


def serving_weights(name, mcfg, gen):
    """Seeded weights of model ``name`` with random BatchNorm statistics,
    as a CPU state_dict.  -> (state_dict, number of parameters)."""
    from tpurec_torch.models import build_model
    from tpurec_torch.models.star import PartitionedNorm
    from tpurec_torch.nn.core import BatchNorm

    model = build_model(name, FIELD_DIMS, towers(name), DOMAIN_IDX, mcfg,
                        device="cpu", generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.mean.normal_(0.0, 0.3, generator=gen)
                m.var.uniform_(0.5, 1.5, generator=gen)
                m.scale.uniform_(0.8, 1.2, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
            elif isinstance(m, PartitionedNorm):
                m.mean.normal_(0.0, 0.3, generator=gen)
                m.var.uniform_(0.5, 1.5, generator=gen)
                m.weight.uniform_(0.8, 1.2, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
    sd = model.state_dict()
    return sd, sum(v.numel() for k, v in sd.items()
                   if "mean" not in k and "var" not in k
                   and "num_batches" not in k)


# -- training (phases 7-10) -------------------------------------------------

TRAIN_K = 8                     # steps per call of the K-step loop
TRAIN_WARMUP_CALLS, TRAIN_TIMED_CALLS = 1, 2    # 8 warm-up, 16 timed steps
L2 = 1e-5                       # bench.py:117,126
TRAIN_WD = 1e-8                 # TrainConfig's default wd
DROPOUT = 0.2
# every dropout of a model off (AFM's two take their rates from
# afm_dropouts, not from dropout): the comparisons against the CPU
NO_DROPOUT = dict(dropout=0.0, afm_dropouts=(0.0, 0.0))
BWD_TOL = 1e-4          # demb abs; a weight gradient: 1e-4 x max(1, max|g|)
SWEEP_TOL = 1e-6        # p: this x max(1, |p'|, the step's terms) (see
                        # sweep_p_limit); moments rel + this x max|moment|
BF16_MOMENT_TOL = 1e-2  # one bfloat16 ulp (2**-8) when FMA flips a rounding
SUMSQ_RTOL = 1e-5
ROWS_TOL = 2e-6         # the table update vs the CPU, as SWEEP_TOL for p
CPU_LOSS_RTOL = 1e-4
ROW_GRAD_RTOL = 1e-4    # step 1's gathered-row gradient, of its max |g|
SWEEP_SYMS = ("decay_adam_kernel", "finish_sumsq_kernel")   # kernels 6, 7
LAUNCH_KEYS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx")
# share of table values allowed beyond 1e-6 after step 1: about 26 of
# the 26M (runs on the H100 have measured 1 and 3 such values)
CPU_TABLE_SHARE = 1e-6


def attn_bwd_flops_per_row(F, D, A, H, L, res=True):
    """Float32 operations of kernel 3 per batch row, counted from the code:
    each layer's in-projection and attention recomputed from its saved
    input, the last layer's out-projection once (for the ReLU mask; the
    other layers' outputs are the saved inputs of the next), the residual,
    and per layer the out- and in-projection backward (weight gradient
    and input gradient) and the four [F, F] x [F, hd] products per head;
    then the embedding projection's backward."""
    hd = A // H
    recompute = (L * (2 * F * A * 3 * A + 4 * H * F * F * hd)
                 + 2 * F * A * A)
    per_layer = (2 * 2 * F * A * A + 4 * 2 * H * F * F * hd
                 + 2 * 2 * F * A * 3 * A)
    res_part = 3 * 2 * F * D * A if res else 0   # recompute, dW, dx
    return recompute + res_part + L * per_layer + 2 * 2 * F * D * A


def decoded_keep_masks(dev, B, F, H, seed, rate):
    """Kernel 2's keep mask of layer 0, read back through its output: with
    q = k = 0 the softmax is 1/F and head h's value channel 0 of field g
    is 2**g, so output column h*hd of field f is c * sum_g keep * 2**g."""
    from tpurec_torch.ops.attention import field_attention

    D, A = 4, 4 * H
    hd = A // H
    emb = torch.zeros(B, F, D)
    emb[:, :, 0] = 2.0 ** torch.arange(F)
    w_emb = torch.zeros(D, A)
    w_emb[0, 0] = 1.0
    w_in = torch.zeros(A, 3 * A)
    for h in range(H):
        w_in[0, 2 * A + h * hd] = 1.0
    flat = [w_emb, torch.zeros(A), None, None, w_in, torch.zeros(3 * A),
            torch.eye(A), torch.zeros(A)]
    y = field_attention(emb.to(dev), [None if w is None else w.to(dev)
                                      for w in flat], 1, H, train=True,
                        rate=rate, seed=seed)
    c = np.float32(np.float32(1.0) / np.float32(F)) / np.float32(1.0 - rate)
    ints = torch.round(y[..., ::hd].double().cpu() / float(c)).long()
    bits = (ints[..., None] >> torch.arange(F)) & 1          # [B, F, H, F]
    return bits.permute(0, 2, 1, 3).bool()


def train_batches(rng, K, dev):
    """K batches of the flagship shape, stacked: x, y, group, mask."""
    xs = np.stack([random_ids(rng, 512) for _ in range(K)])
    return {"x": torch.from_numpy(xs).to(dev),
            "y": torch.from_numpy(rng.integers(0, 2, (K, 512)).astype(
                np.float32)).to(dev),
            "group": torch.from_numpy((xs[..., DOMAIN_IDX] % N_TOWER).astype(
                np.int32)).to(dev),
            "mask": torch.ones((K, 512), dtype=torch.float32, device=dev)}


def check_moments(got, want, what):
    """Hold got's moments (got[1], got[2]) against want's.  -> the rtol.

    b1 * m + (1 - b1) * u cancels for some elements, and FMA contraction
    then moves the float32 result by an ulp of the terms rather than of
    the result: the absolute part of the tolerance scales with the
    moment's largest value.  bfloat16 storage adds one bfloat16 ulp where
    that moves a value across a rounding boundary."""
    rtol = SWEEP_TOL if got[1].dtype == torch.float32 else BF16_MOMENT_TOL
    for name, a, b in (("m", got[1], want[1]), ("v", got[2], want[2])):
        a, b = a.float(), b.float()
        bad = ((a - b).abs() > rtol * b.abs()
               + SWEEP_TOL * b.abs().max()).sum().item()
        check(bad == 0, f"{what}: {bad} values of {name} beyond rel {rtol} "
              f"+ {SWEEP_TOL} x max|{name}|")
    return rtol


def sweep_step(p, m, v, g_small, t, *, lr, coef, b1=0.9, b2=0.99,
               eps=1e-8):
    """The size of each value's step in the sweep, taken from the terms
    of m' before they cancel, from the inputs before the step.

    p' = p - lr (m'/bc1) / (sqrt(v'/bc2) + eps) rounds to an ulp of p',
    and FMA contraction moves m' by an ulp of its terms and v' by one of
    its own, which the step carries in proportion.  So the error allowed
    in p' is SWEEP_TOL x max(1, |p'|, step).  Where v is near 0 (uniform
    moments over 26M values hold a few such) the step reaches several
    units, and its rounding more than 1e-6 absolute."""
    from tpurec_torch.ops.fused_adam import bias_corrections

    bc1, bc2 = bias_corrections(t, b1, b2)
    u = coef * p
    u[:g_small.shape[0]] += g_small
    m, v = m.float(), v.float()
    terms = b1 * m.abs() + (1 - b1) * u.abs()
    v2 = b2 * v + (1 - b2) * (u * u)
    return lr * (terms / bc1) / (torch.sqrt(v2 / bc2) + eps)


RELU_MARGIN = 1e-4      # |pre-ReLU value| below which rounding sets the mask


def away_from_relu_kink(emb, flat, L, H, rate, seed, dy):
    """dy with zeros where the plain forward's pre-ReLU value (in float64)
    lies within RELU_MARGIN of 0.  There float32 rounding alone decides the
    ReLU's mask: the kernel's recomputed value and the plain version's may
    fall on either side, each gradient right for its own rounding, and one
    such element moves its batch row's demb by about |dy|.  -> (dy, share
    of elements zeroed)."""
    from tpurec_torch.ops.attention import (attention_layer,
                                            field_attention_reference,
                                            keep_mask)

    e = emb.double()
    f = [None if w is None else w.double() for w in flat]
    saved = []
    field_attention_reference(e, f, L, H, rate, seed, saved=saved)
    B, F, _ = emb.shape
    keep = keep_mask(seed, B, L - 1, H, F, rate) if rate > 0 else None
    z = attention_layer(saved[-1], *f[4 + 4 * (L - 1):8 + 4 * (L - 1)], H,
                        keep, rate)
    if f[2] is not None:
        z = z + (e @ f[2] + f[3])
    near = z.abs() < RELU_MARGIN
    return (torch.where(near, torch.zeros_like(dy), dy),
            near.float().mean().item())


def bwd_batches(dev):
    """The batch sizes at which phases 7 and 11 check kernels 3 and 5: 1,
    R - 1, R, R + 1 (R the rows a group stacks at B=512), 512, 513 and
    4097 (the last group partly past B, the persistent grid walking more
    than one group a block)."""
    from tpurec_torch.ops.attention import _sm_count, bwd_config

    F, D = len(FIELD_DIMS), MODEL["embed_dim"]
    R = bwd_config(512, F, D, MODEL["atten_embed_dim"], MODEL["att_head_num"],
                   _sm_count(dev))[0]
    return sorted({1, max(1, R - 1), R, R + 1, 512, 513, 4097})


def train_kernel_checks(dev, rng, flat, table, emb_of):
    """Phase 7: the training kernels against their plain versions on the
    card.  -> max abs errors by kernel name."""
    from tpurec_torch.ops.attention import (field_attention_bwd,
                                            field_attention_fwd,
                                            field_attention_reference,
                                            keep_mask)
    from tpurec_torch.config import TrainConfig
    from tpurec_torch.ops.fused_adam import (fused_decay_adam,
                                             fused_decay_adam_reference,
                                             fused_sparse_adam,
                                             fused_sparse_adam_reference)
    from tpurec_torch.nn.core import EmbeddingLayout
    from tpurec_torch.train.hybrid import EmbeddingUpdater
    from tpurec_torch.train.sparse import SparseEmbedState

    L, H = MODEL["att_layer_num"], MODEL["att_head_num"]
    errs = {}
    seed = torch.tensor(31337, device=dev)
    got = decoded_keep_masks(dev, 512, 12, H, seed, DROPOUT)
    want = keep_mask(seed, 512, 0, H, 12, DROPOUT).cpu()
    check(torch.equal(got, want), "attention: the kernel's keep mask differs "
          "from the plain hash")
    print(f"attention train: the kernel's keep mask equals the plain hash "
          f"(512 rows x 2 heads x 12 x 12, drop share "
          f"{1 - want.float().mean().item():.4f} at rate {DROPOUT})")

    err_f = err_b = 0.0
    no_res = flat[:2] + [None, None] + flat[4:]
    bs = bwd_batches(dev)
    cases = [(B, rate, flat) for rate in (0.0, DROPOUT) for B in bs]
    cases.append((513, DROPOUT, no_res))
    zeroed = 0.0
    for B, rate, fl in cases:
        what = (f"B={B} dropout {rate}"
                + ("" if fl[2] is not None else " no residual"))
        emb = emb_of(B)
        saved_p = []
        want = field_attention_reference(emb, fl, L, H, rate, seed,
                                         saved=saved_p)
        y, saved = field_attention_fwd(emb, fl, L, H, rate, seed, True)
        torch.cuda.synchronize()
        e = max((y - want).abs().max().item(),
                (saved - torch.stack(saved_p)).abs().max().item())
        check(e <= ATTN_TOL, f"attention train fwd {what}: max abs err {e}")
        err_f = max(err_f, e)
        # backward against autograd of the plain version, same seed
        leaves = [None if w is None else w.clone().requires_grad_(True)
                  for w in fl]
        e_leaf = emb.clone().requires_grad_(True)
        dy, share = away_from_relu_kink(emb, fl, L, H, rate, seed,
                                        torch.randn(y.shape, device=dev))
        zeroed = max(zeroed, share)
        field_attention_reference(e_leaf, leaves, L, H, rate,
                                  seed).backward(dy)
        demb, grads = field_attention_bwd(emb, dy, saved, fl, L, H, rate,
                                          seed)
        demb2, grads2 = field_attention_bwd(emb, dy, saved, fl, L, H, rate,
                                            seed)
        torch.cuda.synchronize()
        check(torch.equal(demb, demb2) and all(
            a is None or torch.equal(a, b) for a, b in zip(grads, grads2)),
            f"attention bwd {what}: two calls differ (the partial sums "
            f"should be deterministic)")
        e = (demb - e_leaf.grad).abs().max().item()
        check(e <= BWD_TOL, f"attention bwd {what}: demb max abs err {e}")
        err_b = max(err_b, e)
        for i, (g, w) in enumerate(zip(grads, leaves)):
            if w is None:
                check(g is None, f"attention bwd {what}: gradient {i} of a "
                      f"missing weight")
                continue
            e = (g - w.grad).abs().max().item()
            scale = max(1.0, w.grad.abs().max().item())
            check(e <= BWD_TOL * scale, f"attention bwd {what}: weight {i} "
                  f"max abs err {e} (scale {scale:.3g})")
            err_b = max(err_b, e / scale)
    errs["field_attention_train"], errs["field_attention_bwd"] = err_f, err_b
    print(f"attention train fwd (dropout 0 and {DROPOUT}): max abs err "
          f"{err_f:.3g} vs plain (tol {ATTN_TOL}); bwd vs autograd of plain: "
          f"max err {err_b:.3g} (tol {BWD_TOL}, weight grads relative to "
          f"max(1, max|g|)) at B={','.join(map(str, bs))}, dropout 0 and "
          f"{DROPOUT}, and B=513 without the residual; bwd bitwise "
          f"repeatable; dy zeroed where |pre-ReLU| < {RELU_MARGIN} (at most "
          f"{zeroed:.2e} of the elements)")

    layout = EmbeddingLayout(FIELD_DIMS)
    V, D = table.shape
    kw = dict(lr=1e-3, coef=2 * L2 + 1e-8)
    gen7 = torch.Generator(device=dev).manual_seed(SEED + 7)
    g_small = torch.randn(layout.small_rows, D, device=dev, generator=gen7)
    err7 = 0.0
    for mdt in (torch.float32, torch.bfloat16):
        p = table.to(dev)
        m = (torch.randn(V, D, device=dev, generator=gen7) * 0.01).to(mdt)
        v = (torch.rand(V, D, device=dev, generator=gen7) * 1e-4).to(mdt)
        step = sweep_step(p, m, v, g_small, 5, **kw)
        want = fused_decay_adam_reference(p.clone(), m.clone(), v.clone(),
                                          g_small, 5, **kw)
        got = fused_decay_adam(p, m, v, g_small, 5, **kw)
        torch.cuda.synchronize()
        diff = (got[0] - want[0]).abs()
        scale = torch.maximum(want[0].abs(), step).clamp(min=1.0)
        worst = (diff / scale).max().item()
        check(worst <= SWEEP_TOL, f"sweep {mdt}: p error {worst} x max(1, "
              f"|p'|, step) (largest abs err {diff.max().item()})")
        e = diff.max().item()
        err7 = max(err7, e)
        rtol = check_moments(got, want, f"sweep {mdt}")
        r = abs(got[3].item() / want[3].item() - 1)
        check(r <= SUMSQ_RTOL, f"sweep {mdt}: sumsq rel err {r}")
        print(f"sweep {str(mdt)[6:]} moments: p max abs err {e:.3g}, "
              f"{worst:.3g} x max(1, |p'|, step) (tol {SWEEP_TOL}; largest "
              f"step {step.max().item():.3g}), m/v within rel {rtol}, sumsq "
              f"rel err {r:.3g} (tol {SUMSQ_RTOL}) at {V} x {D}")
        del p, m, v, got, want, step, diff, scale
    errs["fused_decay_adam"] = err7

    # kernel 6 as the training step runs it: EmbeddingUpdater.update (one
    # sweep carrying the rows, with the small-field gradient) at a batch's
    # ids with duplicate big-field ids, against the CPU
    upd = EmbeddingUpdater(FIELD_DIMS, TrainConfig(
        bs=512, embedding_moments_dtype="bfloat16"), L2)
    X = random_ids(rng, 512)
    X[:256, 0] = X[256:, 0]
    x = torch.from_numpy(X)
    gen6 = torch.Generator().manual_seed(SEED + 6)
    gr = torch.randn(512 * len(FIELD_DIMS), D, generator=gen6)
    m0 = (torch.randn(V, D, generator=gen6) * 0.01).to(torch.bfloat16)
    v0 = (torch.rand(V, D, generator=gen6) * 1e-4).to(torch.bfloat16)
    res = {}
    for where in ("cuda", "cpu"):
        st = SparseEmbedState(m=m0.clone().to(where), v=v0.clone().to(where))
        p = table.clone().to(where)
        before = (fused_sparse_adam.launches, fused_decay_adam.launches)
        sq = upd.update(p, st, x.to(where), gr.to(where), 5)
        if where == "cuda":
            torch.cuda.synchronize()
            after = (fused_sparse_adam.launches, fused_decay_adam.launches)
            check([b - a for a, b in zip(before, after)] == [1, 1],
                  f"table update: launches (rows, sweep) {before} -> {after}")
        res[where] = [p.cpu(), st.m.cpu(), st.v.cpu(), sq.cpu()]
        if where == "cuda":
            kernels = update_port_kernels(
                lambda: upd.update(p, st, x.to(where), gr.to(where), 5), p)
        del p, st
    check(kernels == dict.fromkeys(SWEEP_SYMS, 1),
          f"table update: port kernels launched {kernels}, want the sweep "
          f"carrying the rows and its sum's finish once each")
    got, want = res["cuda"], res["cpu"]
    tc = upd.tcfg
    step = sweep_step(table, m0, v0, upd.small_field_grads(
        x, gr.reshape(512, len(FIELD_DIMS), D)), 5, lr=tc.lr,
        coef=upd.coef, b1=tc.adam_b1, b2=tc.adam_b2, eps=tc.adam_eps)
    err6, worst6, r6 = held_to_plain(got, want, step, "table update")
    del res, got, want, step
    # the rows' cases at the flagship table, against the plain version on
    # the CPU: ids inside g_small's prefix (their rows' step replaces
    # g_small's), 1,024 equal ids, ids outside [0, V); bitwise repeatable.
    # The kernel sums a row's entries in sort order; so does index_add_ on
    # the CPU, while on the card it adds by atomics in a varying order, and
    # two float32 orders of 1,024 N(0, 1) terms differ by up to about 3e-5,
    # beyond SWEEP_TOL x max|v| for the moments
    S = layout.small_rows
    g6 = torch.Generator(device=dev).manual_seed(SEED + 61)
    gs = torch.randn(S, D, device=dev, generator=g6)
    outside = torch.tensor([-1, -7, V, V + 5, 10**9, -10**9] * 4, device=dev)
    cases = {
        "prefix": torch.randint(0, 2 * S, (1024,), device=dev, generator=g6),
        "all_equal": torch.full((1024,), S + 77, device=dev),
        "outside": torch.cat([torch.randint(0, V, (1000,), device=dev,
                                            generator=g6), outside])}
    # each case with bfloat16 moments (the flagship's) and float32 ones
    # (TrainConfig's default)
    moments = {torch.bfloat16: (m0.to(dev), v0.to(dev)),
               torch.float32: (torch.randn(V, D, device=dev, generator=g6)
                               * 0.01,
                               torch.rand(V, D, device=dev, generator=g6)
                               * 1e-4)}
    worst6c = 0.0
    for (name, ids), (mdt, (m0c, v0c)) in itertools.product(
            cases.items(), moments.items()):
        what = f"rows {name} ({str(mdt)[6:]} moments)"
        g_ids = torch.randn(len(ids), D, device=dev, generator=g6)
        outs = []
        for _ in range(2):
            out = fused_sparse_adam(table.to(dev), m0c.clone(), v0c.clone(),
                                    ids, g_ids, 5, g_small=gs, **kw)
            torch.cuda.synchronize()
            outs.append([t.cpu() for t in out])
        check(all(torch.equal(a, b) for a, b in zip(*outs)),
              f"{what}: two calls differ")
        want = fused_sparse_adam_reference(
            table.clone(), m0c.cpu(), v0c.cpu(), ids.cpu(), g_ids.cpu(), 5,
            g_small=gs.cpu(), **kw)
        step = sweep_step(table.to(dev), m0c, v0c,
                          dense_grad(V, ids, g_ids, gs), 5, **kw).cpu()
        e, worst, _ = held_to_plain(outs[0], want, step, what)
        err6, worst6c = max(err6, e), max(worst6c, worst)
        del outs, want, step
    del moments
    # ids outside [0, V) touch nothing: with zero moments and no weight
    # decay, only row 4 moves
    t2 = table[:64].clone().to(dev)
    z = torch.zeros(64, D, device=dev, dtype=torch.bfloat16)
    fused_sparse_adam(t2, z, z.clone(), torch.tensor([4, 64, 70, -1],
                                                     device=dev),
                      torch.ones(4, D, device=dev), 1, lr=1e-3)
    torch.cuda.synchronize()
    changed = (t2.cpu() != table[:64]).any(1).nonzero().flatten().tolist()
    check(changed == [4], f"sparse rows: sentinel ids wrote rows {changed}")
    errs["fused_sparse_adam"] = err6
    print(f"table update as the training step runs it (1,024 big-field ids "
          f"with duplicates, small-field gradient, bf16 moments): one launch "
          f"of the sweep carrying the rows and its sum's finish, no other "
          f"port kernel; "
          f"table {worst6:.3g} x max(1, |p'|, step) vs the CPU plain path "
          f"(tol {ROWS_TOL}), m/v within rel {BF16_MOMENT_TOL}, sumsq rel "
          f"err {r6:.3g}; at {V} x {D} against the plain version on the "
          f"CPU, ids in g_small's prefix, 1,024 equal ids, ids outside "
          f"[0, V), each with bf16 and f32 moments (m/v within rel "
          f"{SWEEP_TOL} at f32): {worst6c:.3g} (tol {ROWS_TOL}), bitwise "
          f"repeatable; "
          f"max abs err {err6:.3g}; sentinel ids write nothing")
    return errs


def dense_grad(V, ids, g_rows, g_small):
    """The gradient the table update adds to coef * p on each row:
    g_small on [0, S), replaced on each touched row by the sum of its
    entries."""
    g = torch.zeros(V, g_rows.shape[1], device=g_rows.device)
    g[:g_small.shape[0]] = g_small
    ok = (ids >= 0) & (ids < V)
    g[ids[ok]] = 0.0
    return g.index_add_(0, ids[ok], g_rows[ok])


def held_to_plain(got, want, step, what):
    """Hold a table update's (table, m, v, sumsq) to the plain version's:
    the table within ROWS_TOL x max(1, |p'|, step), the moments as
    check_moments does, sumsq within SUMSQ_RTOL.  -> (max abs err of the
    table, its largest share of the limit's scale, sumsq rel err)."""
    diff = (got[0] - want[0]).abs()
    worst = (diff / torch.maximum(want[0].abs(), step).clamp(min=1.0)
             ).max().item()
    check(worst <= ROWS_TOL, f"{what}: table error {worst} x max(1, |p'|, "
          f"step) (largest abs err {diff.max().item()})")
    check_moments(got, want, what)
    r = abs(got[3].item() / want[3].item() - 1)
    check(r <= SUMSQ_RTOL, f"{what}: sumsq rel err {r}")
    return diff.max().item(), worst, r


def update_port_kernels(fn, table):
    """The port's kernels (every __global__ function of tpurec_torch/csrc)
    one call of ``fn``, a table update of ``table`` in place, launches, by
    name, with their launch counts (from torch.profiler).

    A capture is taken again, at most twice, only when it was shown to
    have failed: it recorded no device kernel, or it lacks some of the
    pass's two kernels (and holds nothing more) while ``table`` moved in
    most of its rows, which only the pass writes.  (Captures have recorded
    nothing, in phase 7, and one kernel of two, in phase 18.)  Any other
    capture is returned as it is, right or wrong."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from tpurec_torch.ops import _build

    names = {m for src in _build.sources().values() for m in re.findall(
        r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*(\w+)\s*\(",
        src.read_text())}
    want = dict.fromkeys(SWEEP_SYMS, 1)
    for attempt in range(3):
        before = table.detach().clone()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            open_capture_window()
            fn()
            torch.cuda.synchronize()
        moved = (table.detach() != before).any(dim=1).float().mean().item()
        del before
        evs = prof.key_averages()
        ran = device_kernels(evs)
        out = {}
        for e in evs:
            for name in names:
                if str(e.device_type).endswith("CUDA") and port_kernel(
                        e.key, name):
                    out[name] = out.get(name, 0) + e.count
        lost = ran == 0 or (out != want and moved > 0.5 and all(
            n <= want.get(k, 0) for k, n in out.items()))
        if not lost:
            return out
        print(f"port kernels: capture {attempt + 1} recorded {ran} device "
              f"kernels, {out}, while the table moved in {100 * moved:.1f}% "
              f"of its rows: a lost capture; capturing again")
    return out


def train_counters(name, update="hybrid"):
    """The launch counters that model ``name``'s training step under the
    embedding update ``update`` must raise once per step, by kernel name:
    the gather; the model's own kernels (the cross network's, or the
    attention stack's where the model has it); #6's pass under "hybrid"
    only (the "dense" and "sparse" table steps are plain PyTorch, and
    :func:`table_counters` then stay at 0)."""
    from tpurec_torch.ops.attention import field_attention, \
        field_attention_bwd
    from tpurec_torch.ops.cross_network import cross_network, \
        cross_network_bwd
    from tpurec_torch.ops.embedding import embedding_gather

    if name == "dcn":
        own = {"cross_network": cross_network,
               "cross_network_bwd": cross_network_bwd}
    elif name in ZOO and name != "autoint":
        own = {}
    else:
        own = {"field_attention_train": field_attention,
               "field_attention_bwd": field_attention_bwd}
    return {"embedding_gather": embedding_gather, **own,
            **(table_counters() if update == "hybrid" else {})}


def table_counters():
    """The launch counters of the hybrid table update (#6's pass)."""
    from tpurec_torch.ops.fused_adam import (fused_decay_adam,
                                             fused_sparse_adam)

    return {"fused_decay_adam": fused_decay_adam,
            "fused_sparse_adam": fused_sparse_adam}


def train_state(model, tcfg, device, update="hybrid"):
    """``model``'s training state on ``device`` under the embedding update
    ``update`` ("hybrid", "sparse" or "dense")."""
    from tpurec_torch.train.hybrid import init_train_state
    from tpurec_torch.train.step import init_dense_train_state

    return (init_dense_train_state if update == "dense"
            else init_train_state)(model, tcfg, device)


def train_step_of(model, tcfg, name, update="hybrid", scan_k=None):
    """Model ``name``'s training step (its K-step loop with ``scan_k``)
    under the embedding update ``update``."""
    from tpurec_torch.models import MULTI_TOWER_OUTPUT
    from tpurec_torch.train.hybrid import (make_hybrid_train_step,
                                           make_sparse_train_step)
    from tpurec_torch.train.reg import reg_coef_tree
    from tpurec_torch.train.step import make_train_step

    reg = reg_coef_tree([n for n, _ in model.named_parameters()], name, L2,
                        L2, L2)
    multi = name in MULTI_TOWER_OUTPUT
    if update == "dense":
        return make_train_step(model, tcfg, reg, multi, scan_k=scan_k)
    make = (make_hybrid_train_step if update == "hybrid"
            else make_sparse_train_step)
    return make(model, tcfg, reg, multi, L2, scan_k=scan_k)


def train_main_path(dev, rng, tag, name="mmoe", model_kw=MODEL,
                    update="hybrid", calls=None):
    """Phase 8 (phase 13 for DCN): the flagship training step of model
    ``name`` at full width, driven as bench.py drives the JAX one, under
    the embedding update ``update`` (phase 20 runs "dense" and "sparse"
    too, ``calls`` = (warm-up, timed) calls of the K-step loop).  ->
    (state, single-step fn, batches, generator, launches, timings)."""
    from tpurec_torch.config import ModelConfig, TrainConfig
    from tpurec_torch.models import build_model

    warm_calls, timed_calls = calls or (TRAIN_WARMUP_CALLS,
                                        TRAIN_TIMED_CALLS)
    tcfg = TrainConfig(bs=512, embedding_moments_dtype="bfloat16")
    t0 = time.perf_counter()
    model = build_model(name, FIELD_DIMS, towers(name), DOMAIN_IDX,
                        ModelConfig(**model_kw, dropout=DROPOUT),
                        generator=torch.Generator().manual_seed(SEED + 1))
    ts = train_state(model, tcfg, dev, update)
    check(next(model.parameters()).device.type == "cuda",
          "the model was not built on the card")
    scan = train_step_of(model, tcfg, name, update, TRAIN_K)
    single = train_step_of(model, tcfg, name, update)
    batches = train_batches(rng, TRAIN_K, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    torch.cuda.synchronize()
    print(f"{name} train state ({update}): "
          f"{sum(p.numel() for p in model.parameters())} params on {dev}, "
          f"{'float32' if update == 'dense' else 'bf16'} table moments, "
          f"built in {time.perf_counter() - t0:.1f} s")

    counters = train_counters(name, update)
    idle = {} if update == "hybrid" else table_counters()
    for fn in (*counters.values(), *idle.values()):
        fn.launches = 0
    losses = []
    for _ in range(warm_calls):
        losses.append(scan(ts, batches, gen))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(timed_calls):
        losses.append(scan(ts, batches, gen))
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    idle_launches = {k: fn.launches for k, fn in idle.items()}
    n_steps = (warm_calls + timed_calls) * TRAIN_K
    print(f"{name} train main path ({update}): {n_steps} steps, launches "
          f"{launches}" + (f", and {idle_launches} of the hybrid table "
                           f"update" if idle else ""))
    check(all(n > 0 for n in launches.values()),
          f"a kernel was not launched on the training path: {launches}")
    check(all(n == n_steps for n in launches.values()),
          f"a kernel did not launch once per step: {launches}")
    check(not any(idle_launches.values()), f"the {update} step launched "
          f"the hybrid table update: {idle_launches}")
    launches.update(idle_launches)
    loss = torch.cat(losses).cpu()
    check(bool(torch.isfinite(loss).all()), f"non-finite loss: {loss}")
    timed = timed_calls * TRAIN_K
    step_ms = host_s / timed * 1e3
    event_ms = start.elapsed_time(end) / timed
    timing = {"step_ms_host": step_ms, "step_ms_events": event_ms,
              "examples_per_s_host": 512 / (step_ms / 1e3),
              "examples_per_s_events": 512 / (event_ms / 1e3),
              "loss_first": float(loss[0]), "loss_last": float(loss[-1])}
    print(f"{tag} {name} train step ({update}, B=512, K={TRAIN_K}, "
          f"{timed} timed steps): "
          f"{step_ms:.3f} ms host clock = {timing['examples_per_s_host']:.0f}"
          f" examples/s; {event_ms:.3f} ms by CUDA events = "
          f"{timing['examples_per_s_events']:.0f} examples/s; loss "
          f"{float(loss[0]):.4f} -> {float(loss[-1]):.4f}")
    return ts, single, batches, gen, launches, timing


class relu_branches:
    """Inside, the branch points of a forward and backward are recorded
    (``record=True``) or replayed in order (``record=False``), each call
    matched to the next recorded one of its kind and shape, counting the
    inputs whose own branch differs: ``torch.relu``'s mask (x > 0), ADL's
    routing (``torch.argmax``) and AdaSparse's pruner mask (``torch.where``
    with a 0-dim second operand: ``|pi| <= epsilon``).  Calls of other
    shapes (the attention's plain version, which the card runs inside
    kernel 2) compute as usual.  A value within rounding of a branch's
    edge may take either side on two devices, and a gradient (or, at a
    routing or a pruner edge, a logit) then parts by that unit's whole
    contribution; replaying the card's branches on the CPU leaves rounding
    alone between the two."""

    def __init__(self, masks, record):
        self.masks, self.record = masks, record
        self.used = self.flipped = self.inputs = 0
        self.flips = {"relu": 0, "argmax": 0, "where": 0}

    def _next(self, kind, shape):
        if self.used < len(self.masks) and self.masks[self.used][0] == kind \
                and self.masks[self.used][1].shape == shape:
            self.used += 1
            return self.masks[self.used - 1][1]
        return None

    def _count(self, kind, own, rec):
        n = int((own != rec).sum())
        self.inputs += rec.numel()
        self.flipped += n
        self.flips[kind] += n

    def __call__(self, x):
        if self.record:
            self.masks.append(("relu", (x > 0).cpu()))
            return self.relu(x)
        mask = self._next("relu", x.shape)
        if mask is None:
            return self.relu(x)
        mask = mask.to(x.device)
        self._count("relu", x > 0, mask)
        return x * mask

    def argmax(self, x, *args, **kwargs):
        out = self._argmax(x, *args, **kwargs)
        if self.record:
            self.masks.append(("argmax", out.cpu()))
            return out
        rec = self._next("argmax", out.shape)
        if rec is None:
            return out
        rec = rec.to(out.device)
        self._count("argmax", out, rec)
        return rec

    def where(self, cond, *args, **kwargs):
        if kwargs or len(args) != 2 or not (
                torch.is_tensor(args[0]) and args[0].dim() == 0):
            return self._where(cond, *args, **kwargs)
        if self.record:
            self.masks.append(("where", cond.cpu()))
            return self._where(cond, *args)
        rec = self._next("where", cond.shape)
        if rec is None:
            return self._where(cond, *args)
        rec = rec.to(cond.device)
        self._count("where", cond, rec)
        return self._where(rec, *args)

    def __enter__(self):
        self.relu, torch.relu = torch.relu, self
        self._argmax, torch.argmax = torch.argmax, self.argmax
        self._where, torch.where = torch.where, self.where
        return self

    def __exit__(self, *exc):
        torch.relu = self.relu
        torch.argmax = self._argmax
        torch.where = self._where


def row_grad_vs_cpu(name, model_kw, table_scale, tcfg, batch,
                    rtol=ROW_GRAD_RTOL, update="hybrid"):
    """Step 1's gradient of the gathered rows (``loss_and_grads``'s,
    before Adam and before wd reaches anything) on the card against the
    CPU's plain path, from train_vs_cpu's seeded weights and first batch,
    the CPU on the card's branches (:class:`relu_branches`); held to
    ``rtol`` (ROW_GRAD_RTOL) of its largest value.  A wrong table gradient that
    Adam's sign amplification or PLE's wd would hide shows here.  Under
    the "dense" update the whole table's gradient is held instead: the
    rows' gradients through the lookup's backward (``index_add_``, by
    atomics on the card, in index order on the CPU) plus the table's L2.
    -> summary dict."""
    from tpurec_torch.config import ModelConfig
    from tpurec_torch.models import build_model

    masks, grads = [], {}
    for where in ("cuda", "cpu"):
        model = build_model(name, FIELD_DIMS, towers(name), DOMAIN_IDX,
                            ModelConfig(**model_kw, **NO_DROPOUT),
                            device=where,
                            generator=torch.Generator().manual_seed(SEED + 3))
        with torch.no_grad():
            model.embedding.table.mul_(table_scale)
        ts = train_state(model, tcfg, where, update)
        step = train_step_of(model, tcfg, name, update)
        with relu_branches(masks, record=where == "cuda") as branches:
            out = step.loss_and_grads(ts, batch, None)
        g = (model.embedding.table.grad if update == "dense" else out[2])
        grads[where] = g.detach().cpu()
        del model, ts, step
    check(branches.used == len(masks) > 0,
          f"{name} row gradient: the CPU replayed {branches.used} of the "
          f"card's {len(masks)} ReLU calls")
    err = (grads["cuda"] - grads["cpu"]).abs().max().item()
    top = grads["cpu"].abs().max().item()
    check(err <= rtol * top,
          f"{name} train cuda vs cpu: step 1's row gradient max abs err "
          f"{err} of max |g| {top} ({branches.flips} inputs on the "
          f"other branch on the CPU)")
    return {"max_abs_err": err, "max": top, "flipped": branches.flipped,
            "flips": branches.flips, "relu_inputs": branches.inputs,
            "relu_calls": len(masks)}


def train_vs_cpu(dev, rng, name="mmoe", model_kw=MODEL, table_scale=0.01,
                 wd=TRAIN_WD, compute_dtype="float32", replay=False,
                 loss_rtol=CPU_LOSS_RTOL, grad_rtol=ROW_GRAD_RTOL,
                 table_share=CPU_TABLE_SHARE, update="hybrid"):
    """Phase 9 (phase 13 for DCN, 18 for CDC's other bases): 3 full-width
    steps of model ``name`` with dropout 0 on the card and on the CPU's
    plain path, from the same seeded weights and batches.  The table is
    scaled to N(0, table_scale**2), so that the reported loss's L2 term
    (l2 * sum(table**2), 260 at the N(0, 1) init) does not hide the data
    loss; the loss before the table's L2 term (``loss_and_grads``'s) is
    held to the same limit.  PLE runs at its init's scale, 1, and wd 1e-3
    (``PLE_VS_CPU``): its experts have no BatchNorm, and at 0.01 one
    rounding of the first step's rows moves its third loss by 2.6e-4 on
    the CPU alone, at 1 by 7.9e-8 (``scripts/loss_sensitivity.py``); at
    1 a table value's step is small beside the value, and about 30 of
    the 26M values, whose first step is within a rounding of Adam's eps,
    land more than 1e-6 apart (two H100 runs) unless wd * p, about 1e-3,
    outweighs that rounding, as CDC_CHECK_WD does for phase 17's row.
    The first step's gradient of the gathered rows is held apart, by
    :func:`row_grad_vs_cpu`.  ``replay`` (phase 19) runs the 3 steps on
    the card's branches too (:class:`relu_branches`: the routed models'
    argmax and pruner edges part the losses themselves) and holds ADL's
    centres after them to CENTRE_TOL; ``compute_dtype`` runs the steps in
    that precision, held to ``loss_rtol``, ``grad_rtol`` and
    ``table_share``.  ``update`` (phase 20) steps the table under that
    embedding update: the loss held is then the one its step returns (the
    whole loss under "dense", the loss before the table's L2 under
    "sparse"), and the "dense" one's row gradient is the table's
    (:func:`row_grad_vs_cpu`).  -> summary dict."""
    from tpurec_torch.config import ModelConfig, TrainConfig
    from tpurec_torch.models import build_model

    tcfg = TrainConfig(bs=512, embedding_moments_dtype="bfloat16", wd=wd,
                       compute_dtype=compute_dtype)
    batches = train_batches(rng, 3, "cpu")
    out, masks, centres = {}, [], {}
    branches = None
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = build_model(name, FIELD_DIMS, towers(name), DOMAIN_IDX,
                            ModelConfig(**model_kw, **NO_DROPOUT),
                            device=where,
                            generator=torch.Generator().manual_seed(SEED + 3))
        with torch.no_grad():
            model.embedding.table.mul_(table_scale)
        ts = train_state(model, tcfg, where, update)
        step = train_step_of(model, tcfg, name, update)
        losses, data_losses, table1 = [], [], None
        loss_and_grads = step.loss_and_grads

        def record(*args, _f=loss_and_grads, _out=data_losses):
            out = _f(*args)
            _out.append(float(out[0] if isinstance(out, tuple) else out))
            return out

        step.loss_and_grads = record
        if replay:
            branches = relu_branches(masks, record=where == "cuda")
            branches.__enter__()
        try:
            for i in range(3):
                losses.append(float(step(ts, {k: v[i] for k, v in
                                              batches.items()}, None)))
                if i == 0:
                    table1 = model.embedding.table.detach().cpu().clone()
        finally:
            if replay:
                branches.__exit__(None, None, None)
        if hasattr(model, "cluster_centers"):
            centres[where] = model.cluster_centers.detach().cpu().clone()
        out[where] = (losses, table1, data_losses)
        print(f"{name}: 3 steps on {where}: losses {losses} "
              f"({time.perf_counter() - t0:.1f} s)")
        del model, ts
    (lg, tg, dg), (lc, tc, dc) = out["cuda"], out["cpu"]
    rel = max(abs(a / b - 1) for a, b in zip(lg, lc))
    data_rel = max(abs(a / b - 1) for a, b in zip(dg, dc))
    check(rel <= loss_rtol,
          f"{name} train cuda vs cpu: loss rel err {rel}")
    check(data_rel <= loss_rtol,
          f"{name} train cuda vs cpu: loss before the table's L2 rel err "
          f"{data_rel}")
    if replay:
        check(branches.used == len(masks) > 0,
              f"{name} 3 steps: the CPU replayed {branches.used} of the "
              f"card's {len(masks)} branch calls")
    centre_err = None
    if centres:
        centre_err = (centres["cuda"] - centres["cpu"]).abs().max().item()
        check(centre_err <= CENTRE_TOL, f"{name} train cuda vs cpu: "
              f"cluster centres after 3 steps max abs err {centre_err}")
    grad = row_grad_vs_cpu(name, model_kw, table_scale, tcfg,
                           {k: v[0] for k, v in batches.items()}, grad_rtol,
                           update)
    diff = (tg - tc).abs()
    share = (diff > 1e-6).float().mean().item()
    check(diff.max().item() <= 2 * tcfg.lr + 1e-6 and
          share <= table_share,
          f"{name} train cuda vs cpu: table after step 1 max abs err "
          f"{diff.max().item()}, share beyond 1e-6 {share}")
    print(f"{name} train cuda vs cpu plain path, 3 full-width steps "
          f"({update}, dropout 0, table x{table_scale}, wd {wd}, "
          f"{compute_dtype}): "
          f"loss max rel err {rel:.3g}, "
          f"before the table's L2 {data_rel:.3g} (tol {loss_rtol}; "
          f"those losses {dc})"
          + (f", on the card's branches ({branches.flips} of "
             f"{branches.inputs} inputs flipped)" if replay else "")
          + ("" if centre_err is None else
             f"; cluster centres after 3 steps max abs err "
             f"{centre_err:.3g} (tol {CENTRE_TOL})")
          + f"; step 1's gathered-row gradient max abs "
          f"err {grad['max_abs_err']:.3g} of max |g| {grad['max']:.3g} "
          f"(tol {grad_rtol} of it; {grad['flips']} inputs of "
          f"{grad['relu_inputs']} on the other branch on the CPU, which "
          f"follows the card's); table after "
          f"step 1 max abs err {diff.max().item():.3g} (tol 2 lr: Adam's "
          f"first step is +-lr whatever a gradient's size), share beyond "
          f"1e-6 {share:.3g} (tol {table_share})")
    return {"loss_rel_err": rel, "data_loss_rel_err": data_rel,
            "update": update, "table_scale": table_scale, "wd": wd,
            "compute_dtype": compute_dtype, "row_grad": grad,
            "step_flips": branches.flips if replay else None,
            "centre_max_abs_err": centre_err,
            "table_max_abs_err": diff.max().item(),
            "table_share_beyond_1e-6": share}


def step_profile(dev, ts, single, batches, gen, tag, step_ms, syms=()):
    """Where a training step's time goes: host-clock phases (each ended by
    a synchronize), peak memory, and a profile of single steps (device busy
    share, launches per step, device time by kernel and by launching op,
    host time by op).  ``syms``: the model's own port kernels, each
    launched once a step, beside the gather and #6's pass.  -> (device us
    by kernel name, summary)."""
    upd = single.upd
    table = ts.model.embedding.table.detach()
    b0 = {k: v[0] for k, v in batches.items()}
    single(ts, b0, gen)
    torch.cuda.synchronize()
    # host clock per phase of a step, each phase ended by a synchronize
    phase_ms = {"forward+backward": 0.0, "dense Adam": 0.0,
                "table update": 0.0}
    n_ph = 10
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(n_ph):
        t0 = time.perf_counter()
        _, _, g_rows_b = single.loss_and_grads(ts, b0, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ts.optimizer.step()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        upd.update(table, ts.emb_opt, b0["x"], g_rows_b, ts.step + 1)
        ts.step += 1
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(phase_ms, (t1 - t0, t2 - t1, t3 - t2)):
            phase_ms[k] += dt * 1e3 / n_ph
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"{tag} train step phases (host clock, synchronized, mean of "
          f"{n_ph}): " + ", ".join(f"{k} {v:.3f} ms"
                                   for k, v in phase_ms.items())
          + f"; peak device memory {peak_gb:.2f} GB")
    table_update = update_profile(upd, table, ts.emb_opt, b0["x"], g_rows_b,
                                  ts.step + 1, tag)

    n_prof = 3

    def run():
        for _ in range(n_prof):
            single(ts, b0, gen)

    prof, dev_us, _, launches = profile_calls(
        run, n_prof, f"{tag} step profile",
        ("gather_kernel",) + SWEEP_SYMS + tuple(syms), record_shapes=True)
    evs = prof.key_averages()
    # which host op launched the device time (by op and input shapes)
    op_top = sorted(((f"{e.key} {e.input_shapes}",
                      e.self_device_time_total / n_prof)
                     for e in prof.key_averages(group_by_input_shape=True)
                     if not str(e.device_type).endswith("CUDA")
                     and not getattr(e, "is_user_annotation", False)
                     and e.self_device_time_total > 0),
                    key=lambda kv: -kv[1])[:8]
    host_top = sorted(((e.key, e.self_cpu_time_total / n_prof) for e in evs
                       if not str(e.device_type).endswith("CUDA")),
                      key=lambda kv: -kv[1])[:10]
    busy = sum(dev_us.values())
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:14]
    print(f"{tag} profile of one train step: device busy {busy:.1f} us, "
          f"{100 * busy / (step_ms * 1e3):.1f}% of the {step_ms * 1e3:.1f} "
          f"us host-clock step; {len(dev_us)} kernel kinds, {launches:.0f} "
          f"kernel launches"
          + "".join(f"\n    {us:9.1f} us  {name[:90]}"
                    for name, us in top)
          + "\n  device time by the host op that launched it:"
          + "".join(f"\n    {us:9.1f} us  {name[:160]}"
                    for name, us in op_top)
          + "\n  host, self CPU time per step (profiled):"
          + "".join(f"\n    {us:9.1f} us  {name[:90]}"
                    for name, us in host_top))
    profile_summary = {"busy_us": busy, "step_us": step_ms * 1e3,
                       "busy_share": busy / (step_ms * 1e3),
                       "launches_per_step": launches,
                       "phase_ms": phase_ms, "peak_memory_gb": peak_gb,
                       "table_update": table_update,
                       "gather_device_ms": path_device_ms(
                           dev_us, ("gather_kernel",), 1, f"{tag} step"),
                       "top": [[n[:90], us] for n, us in top],
                       "op_top": [[n[:160], us] for n, us in op_top],
                       "host_top": [[n[:90], us] for n, us in host_top]}
    return dev_us, profile_summary


def update_profile(upd, table, st, x, g_rows, t, tag, n=5):
    """The table update of a training step on its own (kernels 6 and 7 in
    one pass): its launches a step and device time by kernel, from
    torch.profiler over ``n`` updates, beside the sweep without ids
    launched alone; no other port kernel may launch.  -> a summary
    dict."""
    from tpurec_torch.ops.fused_adam import fused_decay_adam

    def update():
        upd.update(table, st, x, g_rows, t)

    def run():
        for _ in range(n):
            update()

    update()
    torch.cuda.synchronize()
    prof, dev_us, _, launches = profile_calls(run, n, f"{tag} table update",
                                              SWEEP_SYMS)
    recorded = device_kernels(prof.key_averages()) / n
    kernels = update_port_kernels(update, table)
    check(kernels == dict.fromkeys(SWEEP_SYMS, 1),
          f"{tag} table update: port kernels {kernels}")
    pass_ms = path_device_ms(dev_us, SWEEP_SYMS, 1, f"{tag} table update")
    B, F = x.shape
    tc = upd.tcfg
    g_small = upd.small_field_grads(x, g_rows.reshape(B, F, -1))
    sweep_ms = kernel_alone_ms(lambda: fused_decay_adam(
        table, st.m, st.v, g_small, t, lr=tc.lr, b1=tc.adam_b1,
        b2=tc.adam_b2, eps=tc.adam_eps, coef=upd.coef), *SWEEP_SYMS, n=10)
    busy = sum(dev_us.values())
    print(f"{tag} table update (kernel 6 in the sweep's pass): {launches:.0f} "
          f"launches a step, {recorded:g} device kernels recorded; device "
          f"busy {busy:.1f} us, the pass {pass_ms:.4f} ms beside the sweep without ids launched alone "
          f"{sweep_ms:.4f} ms" + "".join(
              f"\n    {us:9.2f} us  {k[:90]}" for k, us in sorted(
                  dev_us.items(), key=lambda kv: -kv[1])))
    return {"launches": launches, "kernels_recorded": recorded,
            "busy_us": busy, "pass_ms": pass_ms,
            "sweep_alone_ms": sweep_ms,
            "device_us": {k[:90]: us for k, us in dev_us.items()}}


def train_timings(dev, ts, single, batches, gen, tag, step_ms):
    """Phase 10: each training kernel's time beside its bound, its plain
    version and a library yardstick, at the main path's shapes; then a
    profile of single steps."""
    from tpurec_torch.ops import _build
    from tpurec_torch.ops.attention import _SIGNATURES as att_signatures
    from tpurec_torch.ops.attention import _ptrs as att_ptrs
    from tpurec_torch.ops.attention import (_sm_count, bwd_config, bwd_grid,
                                            field_attention_bwd,
                                            field_attention_bwd_reference,
                                            field_attention_fwd,
                                            field_attention_reference,
                                            fwd_config, keep_threshold)
    from tpurec_torch.ops.fused_adam import (TILE, fused_decay_adam,
                                             fused_decay_adam_reference,
                                             fused_sparse_adam,
                                             fused_sparse_adam_reference)

    L, H = MODEL["att_layer_num"], MODEL["att_head_num"]
    A = MODEL["atten_embed_dim"]
    model = ts.model
    upd = single.upd
    table = model.embedding.table.detach()
    V, D = table.shape
    F = len(FIELD_DIMS)
    x = batches["x"][0]
    with torch.no_grad():
        emb = upd.gather_rows(table, x).reshape(512, F, D)
    flat = [w.detach() for w in model.aux.atten.flat_weights()]
    w_bytes = sum(w.numel() * 4 for w in flat)
    seed = torch.tensor(12345, device=dev)
    rows = {}

    fwd_flops = 512 * attn_flops_per_row(F, D, A, H, L)
    fwd_bytes = 512 * F * (D + A + L * A) * 4 + w_bytes
    t_ops, t_b = fwd_flops / PEAK_F32_FLOPS, fwd_bytes / PEAK_BYTES_PER_S
    R, stage, _ = fwd_config(512, F, D, A, H, _sm_count(dev))
    rows["field_attention_train"] = dict(
        rows_per_block=R, weights_staged=stage,
        tc_bound_ms=tc_bound_ms(fwd_flops, fwd_bytes),
        ms=cuda_ms(lambda: field_attention_fwd(emb, flat, L, H, DROPOUT,
                                               seed, True)),
        plain_ms=cuda_ms(lambda: field_attention_reference(
            emb, flat, L, H, DROPOUT, seed)),
        library_ms=cuda_ms(lambda: sdpa_stack(emb, flat, L, H, DROPOUT)),
        library="F.scaled_dot_product_attention(dropout_p=0.2) + addmm "
                "stack",
        bound_ms=max(t_ops, t_b) * 1e3, flops=fwd_flops, bytes=fwd_bytes,
        bound_by="operations" if t_ops >= t_b else "bytes")

    _, saved = field_attention_fwd(emb, flat, L, H, DROPOUT, seed, True)
    dy = torch.randn(512, F, A, device=dev)
    leaves = [w.clone().requires_grad_(True) for w in flat]
    e_leaf = emb.clone().requires_grad_(True)
    y_lib = sdpa_stack(e_leaf, leaves, L, H, DROPOUT)
    bwd_flops = 512 * attn_bwd_flops_per_row(F, D, A, H, L)
    bwd_bytes = 512 * F * (2 * D + A + L * A) * 4 + 2 * w_bytes
    t_ops, t_b = bwd_flops / PEAK_F32_FLOPS, bwd_bytes / PEAK_BYTES_PER_S
    rows["field_attention_bwd"] = dict(
        ms=cuda_ms(lambda: field_attention_bwd(emb, dy, saved, flat, L, H,
                                               DROPOUT, seed)),
        plain_ms=cuda_ms(lambda: field_attention_bwd_reference(
            emb, dy, saved, flat, L, H, DROPOUT, seed)),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            y_lib, [e_leaf] + leaves, dy, retain_graph=True)),
        library="torch.autograd.grad through the SDPA + addmm stack "
                "(dropout_p=0.2)",
        bound_ms=max(t_ops, t_b) * 1e3, flops=bwd_flops, bytes=bwd_bytes,
        bound_by="operations" if t_ops >= t_b else "bytes",
        tc_bound_ms=tc_bound_ms(bwd_flops, bwd_bytes))
    del y_lib, leaves, e_leaf
    # kernel 3 at R rows a group, staged or not, through its C entry point
    R, stage, smem, grid = bwd_config(512, F, D, A, H, _sm_count(dev))
    lib = _build.load("field_attention", att_signatures)
    n_w = sum(w.numel() for w in flat)
    demb_s = torch.empty_like(emb)
    wgrad_s = torch.empty(n_w, device=dev)
    partial_s = torch.empty(_sm_count(dev), n_w, device=dev)
    seed_s = seed.reshape(1).contiguous()
    ptrs = att_ptrs(flat)
    stream = torch.cuda.current_stream().cuda_stream
    by_r = bwd_rows_sweep(
        lambda r, st: lib.tpurec_field_attention_bwd(
            emb.data_ptr(), dy.data_ptr(), saved.data_ptr(), ptrs, 512, r,
            int(st), F, D, A, H, L, seed_s.data_ptr(),
            keep_threshold(DROPOUT), 1.0 - DROPOUT, 1,
            bwd_grid(512, r, _sm_count(dev)), demb_s.data_ptr(),
            partial_s.data_ptr(), wgrad_s.data_ptr(), stream),
        F, D, A, H)
    rows["field_attention_bwd"].update(
        rows_per_block=R, weights_staged=stage, smem_bytes=smem, grid=grid,
        ms_by_rows_per_block=by_r)
    print(f"{tag} field_attention_bwd B=512: launched alone (CUDA events, 20 "
          f"launches, reduction included): " + ", ".join(
              f"{k} " + ("does not fit" if v is None else f"{v:.4f} ms")
              for k, v in by_r.items()) + f"; the wrapper takes R={R} "
          f"{'staged' if stage else 'unstaged'}")
    del demb_s, wgrad_s, partial_s

    kw = dict(lr=1e-3, coef=2 * L2 + 1e-8)
    S = upd.S
    g_small = torch.randn(S, D, device=dev)
    by_moments = {}
    for name, mdt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        p = table.clone()
        m = torch.zeros(V, D, device=dev, dtype=mdt)
        v = torch.zeros(V, D, device=dev, dtype=mdt)
        ms = cuda_ms(lambda: fused_decay_adam(p, m, v, g_small, 5, **kw))
        plain = cuda_ms(lambda: fused_decay_adam_reference(
            p, m, v, g_small, 5, **kw), iters=10, warmup=2)
        nbytes = V * D * (4 + 2 * m.element_size()) * 2 + S * D * 4
        r = dict(ms=ms, plain_ms=plain, bytes=nbytes,
                 bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes")
        if mdt == torch.float32:
            tp = torch.nn.Parameter(table.clone())
            tp.grad = torch.zeros_like(tp)
            tp.grad[:S] = g_small
            opt = torch.optim.Adam([tp], lr=1e-3, betas=(0.9, 0.99),
                                   eps=1e-8, weight_decay=kw["coef"],
                                   fused=True)
            r["library_ms"] = cuda_ms(opt.step)
            r["library"] = ("torch.optim.Adam(fused=True, weight_decay=coef)"
                            " step, float32 moments")
            del tp, opt
        by_moments[name] = r
        del p, m, v
    rows["fused_decay_adam"] = dict(
        by_moments["bf16"], library_ms=by_moments["f32"]["library_ms"],
        library=by_moments["f32"]["library"] + " (at f32; bf16: none)",
        by_moments=by_moments)

    # kernel 6: the table update's one pass with the batch's big-field ids
    # (its sort and searchsorted included in the wrapper's time), and with
    # every one of them on one row
    g_rows = torch.randn(512 * F, D, device=dev).reshape(512, F, D)
    ids, g_ids = upd.big_rows(x, g_rows)
    same = torch.full_like(ids, S + 77)
    N = ids.shape[0]
    p = table.clone()
    m = torch.zeros(V, D, device=dev, dtype=torch.bfloat16)
    v = torch.zeros_like(m)

    def fused(i=ids):
        return fused_sparse_adam(p, m, v, i, g_ids, 5, g_small=g_small, **kw)

    nbytes = (V * D * (4 + 2 + 2) * 2 + S * D * 4 + N * (8 + 8 + D * 4)
              + 2 * -(-V * D // TILE) * 4)
    rows["fused_sparse_adam"] = dict(
        ms=cuda_ms(fused),
        plain_ms=cuda_ms(lambda: fused_sparse_adam_reference(
            p, m, v, ids, g_ids, 5, g_small=g_small, **kw), iters=10,
            warmup=2),
        library_ms=None,
        library="none: torch.optim.SparseAdam steps only the touched rows, "
                "with no coef * p (L2 / weight decay) term and float32 "
                "moments, so it computes another function",
        bytes=nbytes, bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
        bound_by="bytes", n_ids=N,
        pass_alone_ms=kernel_alone_ms(fused, *SWEEP_SYMS, n=20),
        all_equal_alone_ms=kernel_alone_ms(lambda: fused(same), *SWEEP_SYMS,
                                           n=20),
        sweep_alone_ms=kernel_alone_ms(lambda: fused_decay_adam(
            p, m, v, g_small, 5, **kw), *SWEEP_SYMS, n=20))
    r = rows["fused_sparse_adam"]
    print(f"{tag} fused_sparse_adam (kernel 6 in the sweep's pass, {N} ids): "
          f"the pass launched alone (torch.profiler, 20 launches) "
          f"{r['pass_alone_ms']:.4f} ms, with every id on one row "
          f"{r['all_equal_alone_ms']:.4f} ms; the sweep alone without ids "
          f"{r['sweep_alone_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms")
    rows["fused_decay_adam"]["device_ms"] = r["sweep_alone_ms"]
    del p, m, v
    for name, r in rows.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"{tag} {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    r = rows["fused_decay_adam"]["by_moments"]["f32"]
    print(f"{tag} fused_decay_adam f32 moments: kernel {r['ms']:.4f} ms, "
          f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
          f"bound {r['bound_ms']:.4f} ms")

    # where a step's time goes (profiler device time against the main
    # path's host-clock step time)
    dev_us, profile_summary = step_profile(
        dev, ts, single, batches, gen, tag, step_ms,
        ("field_attention_kernel", "field_attention_bwd_kernel",
         "reduce_partials_kernel"))
    for name, syms in (
            ("field_attention_train", ("field_attention_kernel",)),
            ("field_attention_bwd", ("field_attention_bwd_kernel",
                                     "reduce_partials_kernel")),
            ("fused_sparse_adam", SWEEP_SYMS)):
        rows[name]["device_ms"] = path_device_ms(dev_us, syms, 1,
                                                 f"{tag} step")
    split_device_ms(rows["field_attention_bwd"], dev_us,
                    "field_attention_bwd_kernel", 1)
    r = rows["field_attention_bwd"]
    print(f"{tag} field_attention_bwd in the step: device "
          f"{r['device_ms_kernel']} ms + reduction {r['device_ms_reduce']} "
          f"ms; bound {r['bound_ms']:.4f} ms (f32), {r['tc_bound_ms']:.4f} "
          f"ms (3xTF32 on the tensor cores)")
    return rows, profile_summary


# -- the DCN family and the layered attention (phases 11-15) -----------------

DCN_MODEL = dict(model="dcn", embed_dim=16, mlp_dims=(256, 128, 64),
                 n_cross_layers=3)          # config.py:18, run.py:321
CROSS_TOL = 1e-5        # #8's output and #9's dx, of the output's scale
CROSS_WGRAD_TOL = 1e-4  # #9's dw, db, of each one's scale
LAYER_TOL = 1e-4        # #4, #5 abs; a weight gradient: x max(1, max|g|)


def layer_flops_per_row(F, A, H, bwd=False):
    """Float32 operations of kernel 4 (or 5) per batch row, counted from
    the code: the in-projection, scores and weighted sum, out-projection;
    the backward recomputes the first two and adds the out- and
    in-projection backward (weight and input gradients) and the four
    [F, F] x [F, hd] products per head."""
    hd = A // H
    fwd = 2 * F * A * 3 * A + 4 * H * F * F * hd + 2 * F * A * A
    if not bwd:
        return fwd
    return (2 * F * A * 3 * A + 4 * H * F * F * hd + 2 * 2 * F * A * A
            + 4 * 2 * H * F * F * hd + 2 * 2 * F * A * 3 * A)


def nan_rel_err(got, want, what):
    """max |got - want| over max |want|, where want is not NaN; the NaN
    positions must agree."""
    check(torch.equal(torch.isnan(got), torch.isnan(want)),
          f"{what}: NaN positions differ from the plain version")
    ok = ~torch.isnan(want)
    if not bool(ok.any()):
        return 0.0
    scale = max(want[ok].abs().max().item(), 1e-30)
    return (got[ok] - want[ok]).abs().max().item() / scale


def cross_inputs(dev, emb_of, B, seed):
    """The cross network's inputs at the DCN shapes: x [B, 368] gathered
    rows, w and b [3, 368] (w at the torch-Linear scale), g [B, 368]."""
    L = DCN_MODEL["n_cross_layers"]
    D = len(FIELD_DIMS) * DCN_MODEL["embed_dim"]
    g = torch.Generator(device=dev).manual_seed(seed)
    w = (torch.rand(L, D, device=dev, generator=g) * 2 - 1) / D ** 0.5
    b = torch.randn(L, D, device=dev, generator=g) * 0.1
    return (emb_of(B).reshape(B, D), w, b,
            torch.randn(B, D, device=dev, generator=g))


def cross_kernel_checks(dev, emb_of):
    """Phase 11 (a): kernels 8 and 9 against their plain versions at the
    DCN shapes, #9 bitwise repeatable, a NaN row spreading as in the plain
    version; #8 at other depths, and rows holding +inf where the rewrite
    parts from the recurrence.  -> max errors by kernel name."""
    from tpurec_torch.ops.cross_network import (cross_network_bwd,
                                                cross_network_bwd_reference,
                                                cross_network_fwd,
                                                cross_network_reference)

    err_f = err_b = 0.0
    # B = 1, each side of #9's launch boundaries (2 rows a warp, 8 a block,
    # 64 a cluster, 1024 a full grid's pass), the serving sizes, a NaN row
    bs = (1, 2, 3, 8, 9, 64, 65, 512, 513, 1024, 1025, 4096, 4097)
    for B, nan_row in [(B, False) for B in bs] + [(513, True)]:
        x, w, b, g = cross_inputs(dev, emb_of, B, SEED + B)
        if nan_row:
            x[200, 7] = float("nan")
        y = cross_network_fwd(x, w, b)
        got = cross_network_bwd(x, w, b, g)
        again = cross_network_bwd(x, w, b, g)
        want_y = cross_network_reference(x, w, b)
        want = cross_network_bwd_reference(x, w, b, g)
        torch.cuda.synchronize()
        what = f"cross B={B}{' (NaN row)' if nan_row else ''}"
        check(all(nan_equal(p, q) for p, q in zip(got, again)),
              f"{what}: two calls of kernel 9 differ")
        e = nan_rel_err(y, want_y, f"{what} fwd")
        check(e <= CROSS_TOL, f"{what} fwd: rel err {e}")
        err_f = max(err_f, e)
        e = nan_rel_err(got[0], want[0], f"{what} dx")
        check(e <= CROSS_TOL, f"{what} dx: rel err {e}")
        ew = max(nan_rel_err(got[i], want[i], f"{what} d{n}")
                 for i, n in ((1, "w"), (2, "b")))
        check(ew <= CROSS_WGRAD_TOL, f"{what} dw/db: rel err {ew}")
        err_b = max(err_b, e, ew)
        if nan_row:
            check(bool(torch.isnan(got[1]).any() and torch.isnan(got[2])
                       .any()), f"{what}: the NaN row left dw/db finite")
    print(f"cross network: #8 rel err {err_f:.3g} (tol {CROSS_TOL}), #9 "
          f"rel err {err_b:.3g} (dx tol {CROSS_TOL}, dw/db "
          f"{CROSS_WGRAD_TOL}) vs plain at B={','.join(map(str, bs))}, "
          f"D=368, L=3; #9 bitwise repeatable; a NaN row reaches dw/db as "
          f"in the plain version")
    # any depth: the forward takes the layers three at a time (a partial
    # group at 1 and 5, more than the backward's 8 at 11)
    depth_err = 0.0
    for L in (1, 5, 11):
        x, _, _, _ = cross_inputs(dev, emb_of, 513, SEED + L)
        gd = torch.Generator(device=dev).manual_seed(SEED + 100 + L)
        w = (torch.rand(L, x.shape[1], device=dev, generator=gd) * 2 - 1
             ) / x.shape[1] ** 0.5
        b = torch.randn(L, x.shape[1], device=dev, generator=gd) * 0.1
        e = nan_rel_err(cross_network_fwd(x, w, b),
                        cross_network_reference(x, w, b), f"cross L={L}")
        check(e <= CROSS_TOL, f"cross fwd L={L}: rel err {e}")
        depth_err = max(depth_err, e)
    print(f"cross network: #8 at L = 1, 5, 11, B=513, rel err "
          f"{depth_err:.3g} (tol {CROSS_TOL})")

    # rows holding +inf, where the rewrite and the recurrence part: with
    # x0[j] = +inf, c_l is inf with w_l[j]'s sign, so where w_l[j] > 0 for
    # every l >= 1 the kernel's S_L and row are +-inf; the recurrence's
    # mixed-sign dot products make the row NaN.  One row for each kind of
    # column, at 1 and 2 rows a warp; the other rows must not notice.
    def kinds(row):
        return {"nan": int(torch.isnan(row).sum()),
                "+inf": int(torch.isposinf(row).sum()),
                "-inf": int(torch.isneginf(row).sum()),
                "finite": int(torch.isfinite(row).sum())}

    inf_row = {}
    for B in (513, 4096):
        x, w, b, _ = cross_inputs(dev, emb_of, B, SEED + 5)
        pos = (w[1:] > 0).all(0)
        cols = {"w_l[j] > 0 for all l": pos & (w[0] > 0),
                "w_0[j] < 0, w_l[j] > 0 for l >= 1": pos & (w[0] < 0),
                "some w_l[j] < 0, l >= 1": ~pos}
        cols = {k: int(torch.nonzero(v)[0]) for k, v in cols.items()}
        for r, j in enumerate(cols.values()):
            x[300 + r, j] = float("inf")
        y, want_y = cross_network_fwd(x, w, b), cross_network_reference(x, w,
                                                                        b)
        torch.cuda.synchronize()
        others = [i for i in range(B) if not 300 <= i < 303]
        e = nan_rel_err(y[others], want_y[others], "cross +inf rows, others")
        check(e <= CROSS_TOL, f"cross +inf rows B={B}: other rows rel err "
              f"{e}")
        for r, (what, j) in enumerate(cols.items()):
            got = {"kernel": kinds(y[300 + r]),
                   "plain": kinds(want_y[300 + r])}
            inf_row[f"B={B} {what}"] = got
            D = y.shape[1]
            want_kernel = "nan" if what.startswith("some") else "inf"
            n_kernel = (got["kernel"]["nan"] if want_kernel == "nan"
                        else got["kernel"]["+inf"] + got["kernel"]["-inf"])
            check(n_kernel == D and got["plain"]["nan"] == D,
                  f"cross +inf row B={B}, column {j} ({what}): kernel "
                  f"{got['kernel']}, plain {got['plain']}; want kernel all "
                  f"{want_kernel}, plain all nan")
            print(f"cross network: B={B}, +inf at column {j} ({what}): of "
                  f"368 outputs, kernel {got['kernel']}, plain "
                  f"{got['plain']}")
        print(f"cross network: B={B}, the other rows within {e:.3g}")
    return {"cross_network": err_f, "cross_network_bwd": err_b,
            "cross_network_inf_row": inf_row}


def layer_kernel_checks(dev, flat, emb_of):
    """Phase 11 (a): kernels 4 and 5 against their plain versions with
    dropout 0 and 0.2 at both kernels' ragged batch sizes (R - 1, R, R + 1
    of each), bitwise repeatable, a NaN in one batch row kept out of #4's
    block-mates; then the layered path against the stack (kernels 2, 3) in
    training with one seed.  -> max errors by kernel name."""
    from tpurec_torch.ops.attention import (_sm_count, attention_layer,
                                            attention_layer_bwd,
                                            attention_layer_bwd_reference,
                                            attention_layer_fwd,
                                            field_attention,
                                            field_attention_layered,
                                            keep_mask, layer_fwd_config)

    L, H = MODEL["att_layer_num"], MODEL["att_head_num"]
    F = len(FIELD_DIMS)
    seed = torch.tensor(4242, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    ws = flat[8:12]                            # layer 1's weights
    err_f = err_b = 0.0
    R4 = layer_fwd_config(512, F, flat[0].shape[1], H, _sm_count(dev))[0]
    bs = sorted(set(bwd_batches(dev)) | {max(1, R4 - 1), R4, R4 + 1, 511})
    for rate in (0.0, DROPOUT):
        for B in bs:
            x = torch.matmul(emb_of(B), flat[0]) + flat[1]
            dy = torch.randn(x.shape, device=dev, generator=g)
            y = attention_layer_fwd(x, *ws, H, 1, rate, seed)
            y2 = attention_layer_fwd(x, *ws, H, 1, rate, seed)
            keep = keep_mask(seed, B, 1, H, F, rate) if rate else None
            want = attention_layer(x, *ws, H, keep, rate)
            dx, grads = attention_layer_bwd(x, dy, *ws, H, 1, rate, seed)
            dx2, grads2 = attention_layer_bwd(x, dy, *ws, H, 1, rate, seed)
            dx_r, grads_r = attention_layer_bwd_reference(x, dy, *ws, H, 1,
                                                          rate, seed)
            torch.cuda.synchronize()
            what = f"attention layer B={B} rate={rate}"
            check(torch.equal(y, y2), f"{what}: two calls of kernel 4 differ")
            check(torch.equal(dx, dx2) and all(
                torch.equal(a, b) for a, b in zip(grads, grads2)),
                f"{what}: two calls of kernel 5 differ")
            e = (y - want).abs().max().item()
            check(e <= LAYER_TOL, f"{what} fwd: max abs err {e}")
            err_f = max(err_f, e)
            e = (dx - dx_r).abs().max().item()
            check(e <= LAYER_TOL, f"{what} dx: max abs err {e}")
            err_b = max(err_b, e)
            for i, (a, r) in enumerate(zip(grads, grads_r)):
                s = max(1.0, r.abs().max().item())
                e = (a - r).abs().max().item()
                check(e <= LAYER_TOL * s, f"{what} weight {i}: err {e}")
                err_b = max(err_b, e / s)
    # a NaN in one batch row stays out of #4's block-mates' rows
    x = torch.matmul(emb_of(512), flat[0]) + flat[1]
    bad = x.clone()
    bad[5, 3, 0] = float("nan")
    y0, y1 = attention_layer_fwd(x, *ws, H), attention_layer_fwd(bad, *ws, H)
    others = [r for r in range(512) if r != 5]
    check(bool(torch.isnan(y1[5]).any())
          and torch.equal(y0[others], y1[others]),
          "attention layer: a NaN row reached another batch row")
    print(f"attention layer: #4 max abs err {err_f:.3g}, #5 {err_b:.3g} "
          f"(tol {LAYER_TOL}; weight grads relative to max(1, max|g|)) vs "
          f"plain at B={','.join(map(str, bs))} (#4 {R4} rows a block), "
          f"dropout 0 and {DROPOUT}; both bitwise repeatable; a NaN in "
          f"batch row 5 stays in it")

    # the layered path with seed s drops what the stack drops with seed s
    # (dy zeroed where rounding decides the final ReLU: the stack's kernel
    # 3 recomputes it, the layered path takes torch.relu's)
    emb = emb_of(512)
    dy, _ = away_from_relu_kink(
        emb, flat, L, H, DROPOUT, seed,
        torch.randn(512, F, flat[0].shape[1], device=dev, generator=g))

    def run(fn):
        e = emb.clone().requires_grad_(True)
        leaves = [w.clone().requires_grad_(True) for w in flat]
        y = fn(e, leaves, L, H, train=True, rate=DROPOUT, seed=seed)
        y.backward(dy)
        return [y.detach(), e.grad] + [w.grad for w in leaves]

    layered, stack = run(field_attention_layered), run(field_attention)
    torch.cuda.synchronize()
    e_ls = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
               for a, b in zip(layered, stack))
    check(e_ls <= LAYER_TOL, f"layered vs stack (dropout {DROPOUT}, one "
          f"seed): err {e_ls}")
    print(f"layered path (#4, #5) vs the stack (#2, #3), training, dropout "
          f"{DROPOUT}, one seed, B=512: output and all 17 gradients within "
          f"{e_ls:.3g} of max(1, scale) (tol {LAYER_TOL})")
    return {"attention_layer": err_f, "attention_layer_bwd": err_b,
            "layered_vs_stack": e_ls}


def dcn_serving(dev, rng, tag):
    """Phase 12: the full-width DCN Predictor (23 fields, the 1.63M-row
    table, mlp (256, 128, 64), 3 cross layers, seeded weights and random
    BN statistics) scores 5,000 rows on the card against the CPU's plain
    path at float32, bfloat16 and int8 tables; /predict for 1 and 5,000
    rows; rows/s and a profile per chunk.  -> a summary dict."""
    import http.client

    from tpurec_torch.config import Config, ModelConfig
    from tpurec_torch.ops.cross_network import cross_network
    from tpurec_torch.ops.embedding import embedding_gather
    from tpurec_torch.serve import Predictor
    from tpurec_torch.server import make_server

    cfg = Config(model=ModelConfig(**DCN_MODEL))
    sd, n_params = serving_weights("dcn", cfg.model,
                                   torch.Generator().manual_seed(SEED + 12))
    preds = {w: Predictor(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                          batch_sizes=BATCH_SIZES, device=w).load_state_dict(sd)
             for w in ("cuda", "cpu")}
    pred = preds["cuda"].warm()
    check(not pred.multi_tower, "DCN should serve single-head")
    X = random_ids(rng, N_ROWS)
    embedding_gather.launches = cross_network.launches = 0
    p_gpu = pred(X)
    launches = {"embedding_gather": embedding_gather.launches,
                "cross_network": cross_network.launches}
    print(f"dcn main path: {n_params} params, {N_ROWS} rows scored, "
          f"launches {launches}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel was not launched on the DCN serving path: {launches}")
    p_cpu = preds["cpu"](X)
    errs = {"float32": float(np.max(np.abs(p_gpu - p_cpu)))}
    check(p_gpu.shape == (N_ROWS,) and np.all(np.isfinite(p_gpu))
          and np.all((p_gpu > 0) & (p_gpu < 1)), "DCN predictions malformed")
    del preds["cpu"]
    for dtype in ("bfloat16", "int8"):
        pq = {w: Predictor(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                           batch_sizes=BATCH_SIZES, table_dtype=dtype,
                           device=w).load_state_dict(sd)
              for w in ("cuda", "cpu")}
        errs[dtype] = float(np.max(np.abs(pq["cuda"](X[:1000])
                                          - pq["cpu"](X[:1000]))))
        del pq
    check(max(errs.values()) <= PRED_TOL,
          f"DCN Predictor cuda vs cpu: max abs errs {errs}")
    print(f"DCN Predictor cuda vs cpu plain path: max abs err by table "
          f"{errs} (tol {PRED_TOL}); mean prob {p_gpu.mean():.4f}")

    srv = make_server(pred, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                          timeout=120)
        for n in (1, N_ROWS):
            conn.request("POST", "/predict",
                         body=json.dumps({"instances": X[:n].tolist()}))
            r = conn.getresponse()
            body = r.read()
            check(r.status == 200, f"DCN /predict {r.status}: {body[:200]!r}")
            got = np.asarray(json.loads(body)["predictions"], np.float32)
            check(np.array_equal(got, pred(X[:n])),
                  f"DCN HTTP predictions for {n} rows differ from direct ones")
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    print("DCN HTTP: /predict 1/5000 rows == direct predictions")

    chunk_s, chunk_dev, busy = chunk_timings(
        pred, rng, tag, {"embedding_gather": "gather_kernel",
                         "cross_network": "cross_fwd_kernel"})
    return {"launches": launches, "max_abs_err": errs,
            "rows_per_s": {str(B): B / s for B, s in chunk_s.items()},
            "chunk_ms": {str(B): s * 1e3 for B, s in chunk_s.items()},
            "busy_us": {str(B): v for B, v in busy.items()},
            "device_ms": {k: {str(B): v for B, v in d.items()}
                          for k, d in chunk_dev.items()}}


def layered_main_path(dev):
    """Phase 14: the layered attention path as scripts/profile_attn_
    layered.py drives it: the gradient of sum(y**2) with respect to emb
    and every weight at B=512, F=23, D=16, A=64, H=2, L=3 (weights
    N(0, 0.2**2), emb N(0, 1), from numpy seed 0), against the plain
    version; kernels 4 and 5 launch L times each.  -> (launches, max
    errors, ms per call by form)."""
    from tpurec_torch.ops.attention import (attention_layer_bwd,
                                            field_attention,
                                            field_attention_layered,
                                            field_attention_reference,
                                            fused_attention_layer)

    B, F, D, A, H, L = 512, 23, 16, 64, 2, 3
    rng = np.random.default_rng(0)

    def mk(*s):
        return torch.from_numpy((rng.normal(size=s) * 0.2).astype(
            np.float32)).to(dev)

    flat = [mk(D, A), mk(A), mk(D, A), mk(A)]
    for _ in range(L):
        flat += [mk(A, 3 * A), mk(3 * A), mk(A, A), mk(A)]
    emb = torch.from_numpy(rng.normal(size=(B, F, D)).astype(
        np.float32)).to(dev)

    def grads(fn):
        e = emb.clone().requires_grad_(True)
        leaves = [w.clone().requires_grad_(True) for w in flat]
        (fn(e, leaves, L, H) ** 2).sum().backward()
        return [e.grad] + [w.grad for w in leaves]

    fused_attention_layer.launches = attention_layer_bwd.launches = 0
    got = grads(field_attention_layered)
    torch.cuda.synchronize()
    launches = {"attention_layer": fused_attention_layer.launches,
                "attention_layer_bwd": attention_layer_bwd.launches}
    print(f"layered main path: launches {launches}")
    check(launches == {"attention_layer": L, "attention_layer_bwd": L},
          f"kernels 4 and 5 should launch {L} times each: {launches}")
    want = grads(field_attention_reference)
    e_emb = (got[0] - want[0]).abs().max().item() / max(
        1.0, want[0].abs().max().item())
    e_w = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
              for a, b in zip(got[1:], want[1:]))
    check(max(e_emb, e_w) <= LAYER_TOL, f"layered gradients vs plain: "
          f"demb {e_emb}, weights {e_w} (of max(1, scale))")
    ms = {name: cuda_ms(lambda: grads(fn), iters=20, warmup=3)
          for name, fn in (("layered", field_attention_layered),
                           ("stack", lambda *a: field_attention(
                               *a, train=True)),
                           ("plain", field_attention_reference))}
    print(f"layered path: gradient of sum(y**2) at B=512 vs plain: demb "
          f"{e_emb:.3g}, weights {e_w:.3g} of max(1, scale) (tol "
          f"{LAYER_TOL}); fwd+bwd per call: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in ms.items()))
    return launches, {"demb": e_emb, "weights": e_w}, ms, emb, flat


def layer_rows_sweep(x, ws, H, iters=20):
    """Kernel 4 launched through its C entry point at R = 1 .. 4 batch rows
    a block (w_in and w_out staged, eval), CUDA events over back-to-back
    launches, as rows_sweep does for kernel 2; each R's output held to the
    plain version.  -> {R: ms}."""
    from tpurec_torch.ops import _build
    from tpurec_torch.ops import attention as att

    lib = _build.load("field_attention", att._SIGNATURES)
    B, F, A = x.shape
    y = torch.empty_like(x)
    ptrs = att._ptrs(ws)
    stream = torch.cuda.current_stream().cuda_stream
    want = att.attention_layer(x, *ws, H)
    out = {}
    for R in range(1, 5):
        if att.layer_smem_bytes(F, A, H, R) > att.SMEM_LIMIT:
            break

        def run(R=R):
            rc = lib.tpurec_attention_layer_fwd(
                x.data_ptr(), ptrs, B, R, 1, F, A, H, 0, None,
                att.keep_threshold(0.0), 1.0, 0, y.data_ptr(), stream)
            check(rc == 0, f"kernel 4 at R={R}: CUDA error {rc}")
        out[R] = cuda_ms(run, iters=iters, warmup=2)
        e = (y - want).abs().max().item()
        check(e <= LAYER_TOL, f"kernel 4 at R={R}: max abs err {e}")
    return out


def cross_bwd_sweep(dev, x, w, b, g, iters=50):
    """Kernel 9 launched through its C entry point at 2, 4 and 8 warps a
    block (the grid follows: clusters of 8 blocks enough for one pass);
    device ms a launch from torch.profiler, back to back, each variant's
    result held to the plain version.  Then the floor: an empty kernel
    launched as the wrapper launches kernel 9 (its grid, cluster, block
    and shared memory).  -> ({variant: ms}, floor ms)."""
    from tpurec_torch.ops import _build
    from tpurec_torch.ops import attention as att
    from tpurec_torch.ops import cross_network as cn

    lib = _build.load("cross_network", cn._SIGNATURES)
    (B, D), L = x.shape, w.shape[0]
    n_sm = att._sm_count(dev)
    dx = torch.empty_like(x)
    wgrad = torch.empty(2, L, D, device=dev)
    partial = torch.empty(cn.BWD_MAX_CLUSTERS, 2, L, D, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    want = cn.cross_network_bwd_reference(x, w, b, g)
    out = {}
    for W in (2, 4, 8):
        _, _, grid, _ = cn.bwd_config(B, D, L, 4, n_sm, warps=W)
        key = f"warps={W} grid={grid}"

        def run(W=W, grid=grid, key=key):
            rc = lib.tpurec_cross_network_bwd(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), g.data_ptr(), B, D,
                L, 4, W, grid, dx.data_ptr(), partial.data_ptr(),
                counter.data_ptr(), wgrad.data_ptr(), stream)
            check(rc == 0, f"kernel 9 {key}: CUDA error {rc}")
        out[key] = kernel_alone_ms(run, "cross_bwd_kernel", n=iters)
        e = max(nan_rel_err(dx, want[0], key) / CROSS_TOL,
                nan_rel_err(wgrad[0], want[1], key) / CROSS_WGRAD_TOL,
                nan_rel_err(wgrad[1], want[2], key) / CROSS_WGRAD_TOL)
        check(e <= 1.0, f"kernel 9 {key}: error {e} of its tolerance")
    W, _, grid, smem = cn.bwd_config(B, D, L, 4, n_sm)
    floor = kernel_alone_ms(
        lambda: check(lib.tpurec_cross_network_empty(
            grid, 32 * W, smem, stream) == 0, "empty kernel: CUDA error"),
        "empty_cluster_kernel", n=iters)
    return out, floor


def cross_fwd_sweep(dev, x, w, b, iters=50):
    """Kernel 8 launched through its C entry point at each rows-a-warp (1,
    2) and warps-a-block (1, 2, 4, 8) setting; device ms a launch from
    torch.profiler, back to back, each setting's result held to the plain
    version.  Then the floor: an empty kernel launched with the wrapper's
    grid and block.  -> ({setting: ms}, floor ms)."""
    from tpurec_torch.ops import _build
    from tpurec_torch.ops import attention as att
    from tpurec_torch.ops import cross_network as cn

    lib = _build.load("cross_network", cn._SIGNATURES)
    (B, D), L = x.shape, w.shape[0]
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    want = cn.cross_network_reference(x, w, b)
    res = {}
    for K in (1, 2):
        for W in (1, 2, 4, 8):
            key = f"rows={K} warps={W}"

            def run(K=K, W=W, key=key):
                rc = lib.tpurec_cross_network_fwd(
                    x.data_ptr(), w.data_ptr(), b.data_ptr(), B, D, L, 4, W,
                    K, out.data_ptr(), stream)
                check(rc == 0, f"kernel 8 {key}: CUDA error {rc}")
            res[key] = kernel_alone_ms(run, "cross_fwd_kernel", n=iters)
            e = nan_rel_err(out, want, key)
            check(e <= CROSS_TOL, f"kernel 8 {key}: rel err {e}")
    _, W, grid = cn.fwd_config(B, D, L, 4, att._sm_count(dev))
    floor = kernel_alone_ms(
        lambda: check(lib.tpurec_cross_network_empty_fwd(
            grid, 32 * W, stream) == 0, "empty kernel: CUDA error"),
        "empty_kernel", n=iters)
    return res, floor


def new_kernel_timings(dev, emb_of, emb, flat, tag):
    """Phase 15 (e): kernels 4, 5, 8 and 9 at the main paths' shapes
    (B=512; #8 also at 4096): wrapper time (CUDA events), plain version,
    library yardstick, bound; #4 at R = 1 .. 4 rows a block; #9 launched
    alone at each variant of its launch, beside the floor of an empty
    kernel launched as it is; device time of #4 and #5 from a profile of
    one layered call.  -> rows by kernel name."""
    from tpurec_torch.ops import _build
    from tpurec_torch.ops.attention import _SIGNATURES as att_signatures
    from tpurec_torch.ops.attention import _ptrs as att_ptrs
    from tpurec_torch.ops.attention import (_sm_count, attention_layer,
                                            attention_layer_bwd,
                                            attention_layer_bwd_reference,
                                            attention_layer_fwd, bwd_grid,
                                            field_attention_layered,
                                            keep_threshold, layer_bwd_config,
                                            layer_fwd_config)
    from tpurec_torch.ops.cross_network import bwd_config as \
        cross_network_bwd_config
    from tpurec_torch.ops.cross_network import fwd_config as \
        cross_network_fwd_config
    from tpurec_torch.ops.cross_network import (cross_network_bwd,
                                                cross_network_bwd_reference,
                                                cross_network_fwd,
                                                cross_network_reference)

    rows = {}
    none = ("none: no single PyTorch call computes the cross stack (each "
            "layer's row dot product and rank-1 update are separate calls)")
    by_b = {}
    for B in BATCH_SIZES:
        x, w, b, g = cross_inputs(dev, emb_of, B, SEED + 31)
        L, D = w.shape
        nbytes = 2 * B * D * 4 + 2 * L * D * 4
        flops = B * L * 5 * D
        t_ops, t_b = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
        by_cfg, floor = cross_fwd_sweep(dev, x, w, b)
        K, W, grid = cross_network_fwd_config(B, D, L, 4, _sm_count(dev))
        by_b[B] = dict(
            ms=cuda_ms(lambda: cross_network_fwd(x, w, b)),
            plain_ms=cuda_ms(lambda: cross_network_reference(x, w, b)),
            library_ms=None, bytes=nbytes, flops=flops,
            bound_ms=max(t_ops, t_b) * 1e3,
            bound_by="operations" if t_ops > t_b else "bytes",
            ms_by_config=by_cfg, floor_ms=floor, rows_per_warp=K, warps=W,
            grid=grid)
        print(f"{tag} cross_network B={B}: launched alone (device ms, "
              f"torch.profiler, 50 launches): " + ", ".join(
                  f"{k} {v:.5f}" for k, v in by_cfg.items())
              + f"; the wrapper takes rows={K} warps={W} (grid {grid}); an "
              f"empty kernel launched as it is: {floor:.5f} ms; bound "
              f"{by_b[B]['bound_ms']:.5f} ms")
        if B == BATCH_SIZES[0]:               # the training batch, 512
            nbytes = 3 * B * D * 4 + 4 * L * D * 4
            # per row: the dot products c_l and q (2 D each), x_l for l >
            # 0 (2 D), per layer the sums into dw and db and the updates
            # of dx0_extra and g (7 D), dx (D); once: e_l (2 D each)
            flops = (B * (2 * D * (L + 1) + 2 * D * (L - 1) + 7 * D * L + D)
                     + 2 * D * (L - 1))
            t_ops, t_b = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
            by_cfg, floor = cross_bwd_sweep(dev, x, w, b, g)
            W, K, grid, smem = cross_network_bwd_config(
                B, D, L, 4, _sm_count(dev))
            print(f"{tag} cross_network_bwd B={B}: launched alone (device "
                  f"ms, torch.profiler, 50 launches): " + ", ".join(
                      f"{k} {v:.5f}" for k, v in by_cfg.items())
                  + f"; the wrapper takes warps={W}; an empty kernel "
                  f"launched as it is (grid {grid}, clusters of 8, {32 * W} "
                  f"threads, {smem} B): {floor:.5f} ms")
            rows["cross_network_bwd"] = dict(
                ms_by_config=by_cfg, floor_ms=floor, warps=W,
                rows_per_warp=K, grid=grid, smem_bytes=smem,
                ms=cuda_ms(lambda: cross_network_bwd(x, w, b, g)),
                plain_ms=cuda_ms(lambda: cross_network_bwd_reference(
                    x, w, b, g)),
                library_ms=None, library=none, bytes=nbytes, flops=flops,
                bound_ms=max(t_ops, t_b) * 1e3,
                bound_by="operations" if t_ops > t_b else "bytes")
    rows["cross_network"] = dict(by_b[BATCH_SIZES[-1]], library=none,
                                 by_batch={str(k): v for k, v in by_b.items()})

    F, A, H = emb.shape[1], flat[0].shape[1], 2
    x = (torch.matmul(emb, flat[0]) + flat[1]).detach()
    ws = flat[4:8]
    dy = torch.randn(x.shape, device=dev)
    B = x.shape[0]
    w_bytes = sum(t.numel() * 4 for t in ws)
    for name, bwd in (("attention_layer", False),
                      ("attention_layer_bwd", True)):
        flops = B * layer_flops_per_row(F, A, H, bwd)
        nbytes = (3 if bwd else 2) * B * F * A * 4 + (2 if bwd else 1) * w_bytes
        t_ops, t_b = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
        rows[name] = dict(flops=flops, bytes=nbytes,
                          bound_ms=max(t_ops, t_b) * 1e3,
                          bound_by="operations" if t_ops >= t_b else "bytes",
                          tc_bound_ms=tc_bound_ms(flops, nbytes))
    rows["attention_layer"].update(
        ms=cuda_ms(lambda: attention_layer_fwd(x, *ws, H)),
        plain_ms=cuda_ms(lambda: attention_layer(x, *ws, H)),
        library_ms=cuda_ms(lambda: sdpa_layer(x, *ws, H)),
        library="addmm + F.scaled_dot_product_attention + addmm, one layer")
    R, stage, smem = layer_fwd_config(B, F, A, H, _sm_count(dev))
    by_r = layer_rows_sweep(x, ws, H)
    rows["attention_layer"].update(
        rows_per_block=R, weights_staged=stage, smem_bytes=smem,
        ms_by_rows_per_block=by_r)
    print(f"{tag} attention_layer B={B}: launched alone at R rows a block "
          f"(CUDA events, 20 launches): " + ", ".join(
              f"R={r} {v:.4f} ms" for r, v in by_r.items())
          + f"; the wrapper takes R={R} "
          f"{'staged' if stage else 'unstaged'}")
    leaves = [t.clone().requires_grad_(True) for t in [x] + list(ws)]
    y_lib = sdpa_layer(*leaves, H)
    rows["attention_layer_bwd"].update(
        ms=cuda_ms(lambda: attention_layer_bwd(x, dy, *ws, H)),
        plain_ms=cuda_ms(lambda: attention_layer_bwd_reference(
            x, dy, *ws, H)),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            y_lib, leaves, dy, retain_graph=True)),
        library="torch.autograd.grad through the one-layer SDPA form")
    del y_lib, leaves
    # kernel 5 at R rows a group, staged or not, through its C entry point
    n_sm = _sm_count(dev)
    R, stage, smem, grid = layer_bwd_config(B, F, A, H, n_sm)
    lib = _build.load("field_attention", att_signatures)
    dx_s = torch.empty_like(x)
    n_w = sum(t.numel() for t in ws)
    wgrad_s = torch.empty(n_w, device=dev)
    partial_s = torch.empty(n_sm, n_w, device=dev)
    ptrs = att_ptrs(ws)
    stream = torch.cuda.current_stream().cuda_stream
    by_r = bwd_rows_sweep(
        lambda r, st: lib.tpurec_attention_layer_bwd(
            x.data_ptr(), dy.data_ptr(), ptrs, B, r, int(st), F, A, H, 0,
            None, keep_threshold(0.0), 1.0, 0, bwd_grid(B, r, n_sm),
            dx_s.data_ptr(), partial_s.data_ptr(), wgrad_s.data_ptr(),
            stream),
        F, 0, A, H)
    rows["attention_layer_bwd"].update(
        rows_per_block=R, weights_staged=stage, smem_bytes=smem, grid=grid,
        ms_by_rows_per_block=by_r)
    print(f"{tag} attention_layer_bwd B={B}: launched alone (CUDA events, 20 "
          f"launches, reduction included): " + ", ".join(
              f"{k} " + ("does not fit" if v is None else f"{v:.4f} ms")
              for k, v in by_r.items()) + f"; the wrapper takes R={R} "
          f"{'staged' if stage else 'unstaged'}")
    del dx_s, wgrad_s, partial_s

    # device time of kernels 4 and 5 in the layered path (3 each a call)
    e = emb.clone().requires_grad_(True)
    leaves = [w.clone().requires_grad_(True) for w in flat]
    (field_attention_layered(e, leaves, 3, H) ** 2).sum().backward()
    torch.cuda.synchronize()

    def run():
        for _ in range(5):
            (field_attention_layered(e, leaves, 3, H) ** 2).sum().backward()

    _, dev_us, _, _ = profile_calls(
        run, 5, f"{tag} layered call", ("attention_layer_kernel",
                                        "attention_layer_bwd_kernel",
                                        "reduce_partials_kernel"), per=3)
    for name, syms in (("attention_layer", ("attention_layer_kernel",)),
                       ("attention_layer_bwd", ("attention_layer_bwd_kernel",
                                                "reduce_partials_kernel"))):
        # three launches a call: the device time of one
        rows[name]["device_ms"] = path_device_ms(dev_us, syms, 3,
                                                 f"{tag} layered call")
    split_device_ms(rows["attention_layer_bwd"], dev_us,
                    "attention_layer_bwd_kernel", 3)
    r = rows["attention_layer_bwd"]
    print(f"{tag} attention_layer_bwd in the layered call: device "
          f"{r['device_ms_kernel']} ms + reduction {r['device_ms_reduce']} "
          f"ms a launch; bound {r['bound_ms']:.4f} ms (f32), "
          f"{r['tc_bound_ms']:.4f} ms (3xTF32 on the tensor cores)")
    busy = sum(dev_us.values())
    print(f"{tag} profile of one layered fwd+bwd call (B=512): device busy "
          f"{busy:.1f} us" + "".join(
              f"\n    {us:9.1f} us  {k[:90]}" for k, us in sorted(
                  dev_us.items(), key=lambda kv: -kv[1])[:8]))
    for name, r in rows.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        dms = r.get("device_ms")
        print(f"{tag} {name}: kernel {r['ms']:.4f} ms"
              + ("" if dms is None else f" (device {dms:.4f} ms)")
              + f", plain {r['plain_ms']:.4f} ms, library {lib}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    r = rows["cross_network"]["by_batch"][str(BATCH_SIZES[0])]
    print(f"{tag} cross_network B={BATCH_SIZES[0]}: kernel {r['ms']:.4f} ms, "
          f"plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms")
    return rows


def path_device_ms(dev_us, syms, per, what):
    """Device ms a launch of the port kernels ``syms`` took in a profile
    (``per`` launches of each in its averaged window).  Fails when one of
    them shows no device time: a kernel of the path that was renamed, or
    did not run, must not vanish from the record."""
    found = {s: [v for k, v in dev_us.items() if port_kernel(k, s)]
             for s in syms}
    missing = [s for s, us in found.items() if not us]
    check(not missing, f"{what}: the profile shows no device time for "
          f"{missing}")
    return sum(sum(us) for us in found.values()) / per / 1e3


def split_device_ms(row, dev_us, sym, per):
    """Record a backward kernel's device time apart from its ordered
    reduction's (reduce_partials_kernel), each per launch (``per``
    launches in the profiled window's average)."""
    for key, name in (("device_ms_kernel", sym),
                      ("device_ms_reduce", "reduce_partials_kernel")):
        row[key] = path_device_ms(dev_us, (name,), per, sym)


def kernel_alone_ms(fn, *syms, n=50):
    """Device ms of the port kernels ``syms`` when ``fn`` (one launch of
    each) runs ``n`` times back to back, from torch.profiler: the kernels
    with their data warm in L2 where it fits, beside their time inside the
    main path."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(n):
            fn()

    what = f"{syms[0]} launched alone"
    _, dev_us, _, _ = profile_calls(run, n, what, syms, cpu=False)
    return path_device_ms(dev_us, syms, 1, what)


CAPTURE_ATTEMPTS = 4
# profiler captures this run: taken, taken again, short after every attempt
CAPTURES = {"taken": 0, "retaken": 0, "short": 0}
MARKERS = 64                    # spin kernels that open a capture window
MARKER_KERNEL = "spin_kernel"


def open_capture_window():
    """The first thing inside a torch.profiler capture on the card.  Such
    a capture drops the records of the first kernels launched in it: two
    of a 40-launch workload in every capture but a process's first
    (``scripts/profiler_record_loss.py``), and more as a process loads
    more kernels (a table update's 38 recorded as 38 in phase 10, 34.6 by
    phase 20).  MARKERS spin kernels, synchronized, take that loss before
    the work the capture measures.  Their records, and their host
    launches, are left out of every count."""
    for _ in range(MARKERS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def is_marker(key):
    return MARKER_KERNEL in key


def device_kernels(evs):
    """Kernel records in a capture's key_averages, the markers' left out
    (copies and memsets are not kernels)."""
    return sum(e.count for e in evs if str(e.device_type).endswith("CUDA")
               and not e.key.startswith(("Memcpy", "Memset"))
               and not getattr(e, "is_user_annotation", False)
               and not is_marker(e.key))


def profile_calls(run, n, what, syms=(), per=1, cpu=True,
                  record_shapes=False):
    """torch.profiler over ``run()``, which makes ``n`` calls of a path
    that launches each port kernel of ``syms`` ``per`` times a call.
    -> (profile, device us a call by kernel name, the window's host
    seconds, synchronize included, host kernel launches a call or None
    without ``cpu``).

    The window opens with :func:`open_capture_window`.  Captures on the
    card lose records at random too: all of them (phases 7, 10; 2 of 242
    in ``scripts/profiler_record_loss.py``), every launch of one kernel of
    two (phases 18, 20's sweep launched alone), some launches.  So a
    capture with no device activity, fewer than n * per records of a
    kernel of ``syms``, or (with ``cpu``) fewer kernel records than host
    launches, is taken again, up to CAPTURE_ATTEMPTS captures in all.
    The fullest one stands; a kernel of ``syms`` still short of records
    has its time averaged over the launches it recorded, and one with no
    record in any capture fails the phase (a renamed or unlaunched kernel
    must not vanish from the record)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * cpu
    want = n * per
    best = None
    for attempt in range(CAPTURE_ATTEMPTS):
        with profile(activities=acts, record_shapes=record_shapes) as prof:
            open_capture_window()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        CAPTURES["taken" if attempt == 0 else "retaken"] += 1
        all_evs = prof.key_averages()
        evs = [e for e in all_evs
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)
               and not is_marker(e.key)]
        got = {s: sum(e.count for e in evs if port_kernel(e.key, s))
               for s in syms}
        launched = (sum(e.count for e in all_evs if e.key in LAUNCH_KEYS)
                    - MARKERS if cpu else None)
        unrecorded = (max(0, launched - device_kernels(all_evs)) if cpu
                      else 0)
        score = (bool(evs), sum(min(c, want) for c in got.values()),
                 -unrecorded)
        if best is None or score > best[0]:
            best = (score, prof, evs, got, window_s, launched)
        if evs and all(c >= want for c in got.values()) and not unrecorded:
            break
        print(f"{what}: capture {attempt + 1} recorded "
              + (f"{got} of {want} launches each, {unrecorded} of "
                 f"{launched} host launches without a kernel record"
                 if evs else "no device activity")
              + ("; capturing again" if attempt + 1 < CAPTURE_ATTEMPTS
                 else ""))
    _, prof, evs, got, window_s, launched = best
    short = {s: c for s, c in got.items() if 0 < c < want}
    if short:
        CAPTURES["short"] += 1
        print(f"{what}: the fullest capture recorded {short} of {want} "
              f"launches; their time is averaged over those recorded")
    dev_us = {}
    for e in evs:
        s = next((s for s in syms if port_kernel(e.key, s)), None)
        scale = want / got[s] if s in short else 1
        dev_us[e.key] = dev_us.get(e.key, 0.0) + (
            e.self_device_time_total * scale / n)
    return prof, dev_us, window_s, None if launched is None else launched / n


def chunk_timings(pred, rng, tag, syms):
    """A Predictor's rows/s at each batch size (host clock, median of 20
    calls, copies included), then where a chunk's time goes: a profile of
    10 chunks at each size, device time by kernel against the chunk's
    unprofiled host-clock time.  ``syms`` maps a port kernel's name to its
    symbol; each launches once per chunk (a kernel the profile does not see
    fails the phase).  -> (seconds per chunk by B, device ms by kernel name
    and B, device busy us per chunk by B)."""
    chunk_s, busy_us = {}, {}
    device_ms = {name: {} for name in syms}
    for B in BATCH_SIZES:
        Xb = random_ids(rng, B)
        for _ in range(3):
            pred(Xb)
        ts = []
        for _ in range(20):
            t0 = time.perf_counter()
            pred(Xb)
            ts.append(time.perf_counter() - t0)
        med = chunk_s[B] = float(np.median(ts))
        print(f"{tag} Predictor({pred.model_name}) B={B}: {B / med:.0f} "
              f"rows/s (median {med * 1e3:.3f} ms per call, host clock, "
              f"incl. copies)")
    for B in BATCH_SIZES:
        Xb = random_ids(rng, B)
        pred(Xb)
        def run():
            for _ in range(10):
                pred(Xb)

        _, dev_us, _, _ = profile_calls(
            run, 10, f"{tag} chunk profile B={B}", tuple(syms.values()))
        busy, wall = sum(dev_us.values()), chunk_s[B] * 1e6
        busy_us[B] = busy
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        print(f"{tag} profile {pred.model_name} B={B}: device busy "
              f"{busy:.1f} us per chunk, {100 * busy / wall:.1f}% of its "
              f"{wall:.1f} us; {len(dev_us)} kernel kinds"
              + "".join(f"\n    {us:9.1f} us  {name[:90]}"
                        for name, us in top))
        for name, sym in syms.items():
            device_ms[name][B] = path_device_ms(
                dev_us, (sym,), 1, f"{pred.model_name} chunk B={B}")
    return chunk_s, device_ms, busy_us


# -- the training harness (phase 16) ------------------------------------------

FIT_ROWS = 131072               # make_synthetic rows; ~118k train, ~6.5k valid
FIT_AUC_MIN = 0.65              # a model that learns nothing reads ~0.5
FIT_STEP_TOL = 1e-5             # indexed vs host epoch, per-step loss
FIT_PATH_AUC_TOL = 1e-4         # indexed vs host epoch, valid AUC
STREAM_TOL = {"total_auc": 2e-4, "total_loss": 1e-5, "mean_auc": 5e-4}
LOAD_TOL = 1e-5                 # Predictor.load_from_trainer vs predict
RECIPE_AUC_MIN = 0.7            # the small recipe, 2 epochs
PROFILE_STEPS = 16


def _record_steps(tr):
    """Wrap a Trainer's step callables to keep each step's loss (on the
    device) in order; -> the list they fill."""
    out = []
    for attr in ("scan_steps_idx", "scan_steps", "train_step"):
        orig = getattr(tr, attr)

        def wrapped(*a, _orig=orig):
            r = _orig(*a)
            out.append(r.detach().reshape(-1).clone())
            return r

        setattr(tr, attr, wrapped)
    return out


def harness_main_path(dev, tag):
    """Phase 16: the training harness at full width.  make_synthetic at
    the flagship schema -> Trainer(...).fit(train, valid, test) through
    the device-resident (indexed) epoch, with the kernel counters read
    around the fit; then the host-batching epoch from the same initial
    state, streaming against exact eval, Predictor.load_from_trainer, a
    checkpoint through predictor_from_checkpoint and a fresh Trainer, and
    the small drive recipe.  -> (launches, summary)."""
    import os
    import tempfile

    from tpurec_torch.config import Config, ModelConfig, TrainConfig
    from tpurec_torch.data import make_synthetic
    from tpurec_torch.serve import Predictor, predictor_from_checkpoint
    from tpurec_torch.train import Trainer

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    data = make_synthetic(n_rows=FIT_ROWS, n_fields=len(FIELD_DIMS),
                          n_domain=N_DOMAIN, field_dims=FIELD_DIMS,
                          domain_idx=DOMAIN_IDX, seed=1)
    Xtr, ytr = data.train
    Xva, yva = data.valid
    w = data.domain_cnt_weight()
    print(f"harness data: make_synthetic({FIT_ROWS} rows, flagship fields) "
          f"in {time.perf_counter() - t0:.2f} s: {len(ytr)} train, "
          f"{len(yva)} valid, {len(data.test[1])} test rows, "
          f"{(Xtr.nbytes + ytr.nbytes) / 1e6:.1f} MB train split")
    cfg = Config(model=ModelConfig(**MODEL, dropout=DROPOUT),
                 train=TrainConfig(bs=512, epoch=1, seed=0,
                                   embedding_moments_dtype="bfloat16"))
    d2g = np.arange(N_DOMAIN) % N_TOWER

    def trainer():
        return Trainer(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                       domain2group=d2g)

    t0 = time.perf_counter()
    tr = trainer()
    check(tr.device.type == "cuda" and
          tr.model.embedding.table.device.type == "cuda",
          "the Trainer was not built on the card")
    check(Xtr.nbytes + ytr.nbytes <= tr.DEVICE_RESIDENT_BYTES,
          "the train split is over the device-resident budget")
    snap0 = tr.snapshot()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    steps_idx = _record_steps(tr)

    n_steps = -(-len(ytr) // cfg.train.bs)
    n_eval = sum(tr._padded_index_batches(len(y), cfg.train.bs,
                                          tr.EVAL_CHUNK)[0].shape[0]
                 for y in (yva, data.test[1]))
    counters = train_counters("mmoe")
    for fn in counters.values():
        fn.launches = 0
    marks = {}

    def log_fn(r):
        torch.cuda.synchronize()
        marks["train_end" if "it" in r else "eval_end"] = time.perf_counter()

    t0 = time.perf_counter()
    out = tr.fit(data.train, data.valid, data.test, domain_cnt_weight=w,
                 log_fn=log_fn)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    want = {"embedding_gather": n_steps + n_eval,
            "field_attention_train": n_steps + n_eval,
            "field_attention_bwd": n_steps, "fused_decay_adam": n_steps,
            "fused_sparse_adam": n_steps}
    print(f"harness main path: Trainer.fit, 1 epoch of {n_steps} indexed "
          f"steps + {n_eval} eval batches (valid, test), launches "
          f"{launches}")
    check(launches == want, f"fit's kernel launches {launches}, expected "
          f"{want} (a step each, and a forward per eval batch)")
    train_s = marks["train_end"] - t0
    valid = out["valid"]
    check(valid is not None, "fit returned no valid result")
    auc, mean_auc, loss = (valid["total_auc"], valid["mean_auc"],
                           valid["total_loss"])
    print(f"harness fit: valid total_auc {auc:.5f} (min {FIT_AUC_MIN}), "
          f"mean_auc {mean_auc:.5f}, total_loss {loss:.5f}; test total_auc "
          f"{out['test']['total_auc']:.5f}; train loss "
          f"{valid['train_loss']:.4f}")
    check(auc >= FIT_AUC_MIN, f"valid total_auc {auc} < {FIT_AUC_MIN}")
    check(np.isfinite(mean_auc) and np.isfinite(loss),
          f"valid mean_auc {mean_auc}, total_loss {loss} not finite")
    step_loss_idx = torch.cat(steps_idx).cpu()
    check(step_loss_idx.numel() == n_steps and
          bool(torch.isfinite(step_loss_idx).all()),
          f"indexed epoch: {step_loss_idx.numel()} step losses, finite "
          f"{bool(torch.isfinite(step_loss_idx).all())}")
    print(f"{tag} harness epoch (indexed, B=512, {n_steps} steps): train "
          f"{train_s:.3f} s host clock = {len(ytr) / train_s:.0f} "
          f"examples/s ({train_s / n_steps * 1e3:.3f} ms a step); epoch with "
          f"valid eval {valid['epoch_seconds']:.3f} s; fit {fit_s:.3f} s "
          f"(snapshot, best-state restore and test eval included); Trainer "
          f"built in {build_s:.2f} s")

    # the same epoch through the host path, from the same initial state
    t0 = time.perf_counter()
    tr2 = trainer()
    tr2.restore(snap0)
    tr2.DEVICE_RESIDENT_BYTES = 0               # the host-batching path
    steps_host = _record_steps(tr2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host_loss = tr2.train_epoch(Xtr, ytr, 0)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t1
    step_loss_host = torch.cat(steps_host).cpu()
    check(step_loss_host.shape == step_loss_idx.shape,
          f"host epoch took {step_loss_host.numel()} steps")
    path_err = (step_loss_host - step_loss_idx).abs().max().item()
    ev_host = tr2.evaluate(Xva, yva, w)
    path_auc = abs(ev_host["total_auc"] - auc)
    print(f"{tag} harness epoch (host batching, ArrayBatcher + prefetch, "
          f"K={cfg.train.steps_per_dispatch}): {host_s:.3f} s = "
          f"{len(ytr) / host_s:.0f} examples/s; vs indexed: per-step loss "
          f"max abs err {path_err:.3g} (tol {FIT_STEP_TOL}), valid AUC "
          f"{ev_host['total_auc']:.5f} (diff {path_auc:.3g}, tol "
          f"{FIT_PATH_AUC_TOL}); bitwise equal losses "
          f"{torch.equal(step_loss_host, step_loss_idx)}; epoch loss "
          f"{host_loss:.5f} vs {valid['train_loss']:.5f}")
    check(path_err <= FIT_STEP_TOL, f"host vs indexed epoch: step loss err "
          f"{path_err}")
    check(path_auc <= FIT_PATH_AUC_TOL,
          f"host vs indexed epoch: valid AUC diff {path_auc}")

    # where the epoch's time goes: a profile of 16 indexed steps
    Xdev, ydev, d2g_dev = tr2._device_dataset(Xtr, ytr)
    rng = np.random.default_rng(SEED + 16)
    idx = torch.as_tensor(rng.integers(0, len(ytr), (PROFILE_STEPS + 2, 512),
                                       dtype=np.int32), device=dev)
    ones = torch.ones((PROFILE_STEPS + 2, 512), device=dev)
    tr2.scan_steps_idx(tr2.state, Xdev, ydev, d2g_dev, idx[:2], ones[:2],
                       tr2.dropout_gen)
    torch.cuda.synchronize()
    _, dev_us, window_s, step_launches = profile_calls(
        lambda: tr2.scan_steps_idx(tr2.state, Xdev, ydev, d2g_dev, idx[2:],
                                   ones[2:], tr2.dropout_gen),
        PROFILE_STEPS, f"{tag} harness epoch profile")
    busy_us = sum(dev_us.values()) * PROFILE_STEPS
    check(busy_us > 0, "the epoch profile shows no device time")
    busy_share = busy_us / 1e6 / window_s
    epoch_share = busy_us / PROFILE_STEPS / (train_s / n_steps * 1e6)
    print(f"{tag} harness epoch profile ({PROFILE_STEPS} indexed steps): "
          f"device busy {busy_us / PROFILE_STEPS:.1f} us a step, "
          f"{100 * busy_share:.1f}% of the profiled window's "
          f"{window_s * 1e3 / PROFILE_STEPS:.3f} ms a step, "
          f"{100 * epoch_share:.1f}% of the unprofiled epoch's step; "
          f"{step_launches:.0f} launches a step")
    del tr2, Xdev, ydev
    torch.cuda.empty_cache()

    # streaming against exact eval on the valid split
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    exact = tr.evaluate(Xva, yva, w)
    exact_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    stream = tr.evaluate_streaming(Xva, yva, w)
    stream_s = time.perf_counter() - t1
    stream_err = {k: abs(stream[k] - exact[k]) for k in STREAM_TOL}
    print(f"{tag} harness eval of {len(yva)} valid rows: exact "
          f"{exact_s:.4f} s, streaming {stream_s:.4f} s (host clock); "
          f"streaming vs exact {stream_err} (tol {STREAM_TOL})")
    check(exact["total_auc"] == auc, f"evaluate after fit {exact['total_auc']}"
          f" differs from fit's valid AUC {auc}")
    check(all(stream_err[k] <= STREAM_TOL[k] for k in STREAM_TOL),
          f"streaming vs exact eval: {stream_err}")

    # serving the trained state
    Xs = Xva[:N_ROWS]
    p_tr = tr.predict(Xs)
    live = Predictor(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX, domain2group=d2g,
                     batch_sizes=(cfg.train.bs,)).load_from_trainer(tr)
    load_err = float(np.max(np.abs(live(Xs) - p_tr)))
    check(load_err <= LOAD_TOL, f"Predictor.load_from_trainer vs predict: "
          f"max abs err {load_err}")
    del live
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        path = os.path.join(tmp, "harness.pkl")
        t1 = time.perf_counter()
        tr.save_checkpoint(path, extra={"phase": 16})
        write_s = time.perf_counter() - t1
        size_mb = os.path.getsize(path) / 1e6
        t1 = time.perf_counter()
        served = predictor_from_checkpoint(path,
                                           batch_sizes=(cfg.train.bs,))
        read_s = time.perf_counter() - t1
        p_ckpt = served(Xs)
        del served
        t1 = time.perf_counter()
        fresh = trainer()
        payload = fresh.load_checkpoint(path)
        load_s = time.perf_counter() - t1
    check(payload["extra"] == {"phase": 16}, "checkpoint extra lost")
    check(np.array_equal(p_ckpt, p_tr), "predictor_from_checkpoint differs "
          f"from Trainer.predict: max abs err "
          f"{float(np.max(np.abs(p_ckpt - p_tr)))}")
    p_fresh = fresh.predict(Xs)
    check(np.array_equal(p_fresh, p_tr), "a fresh Trainer.load_checkpoint "
          f"predicts otherwise: max abs err "
          f"{float(np.max(np.abs(p_fresh - p_tr)))}")
    del fresh, tr
    torch.cuda.empty_cache()
    print(f"{tag} harness checkpoint: {size_mb:.1f} MB written in "
          f"{write_s:.3f} s; predictor_from_checkpoint {read_s:.3f} s, "
          f"Trainer.load_checkpoint {load_s:.3f} s (build included); "
          f"Predictor.load_from_trainer vs predict max abs err "
          f"{load_err:.3g} (tol {LOAD_TOL}); checkpoint Predictor and fresh "
          f"Trainer bitwise equal to predict on {len(Xs)} valid rows")

    # the small drive recipe: MMoE, embed 8, 2 epochs on 12,000 rows
    t1 = time.perf_counter()
    small = make_synthetic(n_rows=12000, n_fields=6, n_domain=4, domain_idx=3,
                           seed=1)
    rcfg = Config(model=ModelConfig(model="mmoe", embed_dim=8,
                                    mmoe_expert_dims=(32, 16),
                                    mmoe_tower_dims=(16,), atten_embed_dim=8,
                                    att_layer_num=1),
                  train=TrainConfig(bs=256, epoch=2, seed=0))
    rtr = Trainer(rcfg, small.field_dims, small.n_domain, small.domain_idx,
                  domain2group=np.arange(small.n_domain))
    rout = rtr.fit(small.train, small.valid,
                   domain_cnt_weight=small.domain_cnt_weight())
    recipe_auc = rout["valid"]["total_auc"]
    print(f"harness small recipe (MMoE embed 8, 2 epochs, 12,000 rows): "
          f"valid total_auc {recipe_auc:.5f} (min {RECIPE_AUC_MIN}) in "
          f"{time.perf_counter() - t1:.2f} s")
    check(recipe_auc > RECIPE_AUC_MIN,
          f"small recipe valid AUC {recipe_auc} <= {RECIPE_AUC_MIN}")
    del rtr
    phase_s = time.perf_counter() - t_phase
    print(f"harness phase: {phase_s:.1f} s")
    return launches, {
        "rows": {"train": len(ytr), "valid": len(yva),
                 "test": len(data.test[1])},
        "steps": n_steps, "eval_batches": n_eval, "launches": launches,
        "valid": {k: valid[k] for k in ("total_auc", "mean_auc",
                                        "total_loss", "mean_loss",
                                        "train_loss", "epoch_seconds")},
        "test_total_auc": out["test"]["total_auc"],
        "train_seconds": train_s, "examples_per_s": len(ytr) / train_s,
        "fit_seconds": fit_s, "build_seconds": build_s,
        "host_path_seconds": host_s,
        "host_path_examples_per_s": len(ytr) / host_s,
        "host_vs_indexed_step_loss_err": path_err,
        "host_vs_indexed_valid_auc_diff": path_auc,
        "busy_us_per_step": busy_us / PROFILE_STEPS,
        "busy_share_window": busy_share, "busy_share_epoch": epoch_share,
        "launches_per_step": step_launches,
        "eval_exact_seconds": exact_s, "eval_streaming_seconds": stream_s,
        "streaming_vs_exact": stream_err,
        "load_from_trainer_err": load_err,
        "checkpoint_mb": size_mb, "checkpoint_write_seconds": write_s,
        "predictor_from_checkpoint_seconds": read_s,
        "trainer_load_checkpoint_seconds": load_s,
        "recipe_valid_auc": recipe_auc, "phase_seconds": phase_s}


# -- the CDC engine on the MMoE base (phase 17) --------------------------------

CDC_ROW_TOL = 1e-4              # a populate row, card vs CPU, of max(1, |x|)
# weight decay of the populate-row check: a bias feeding a training
# BatchNorm has a gradient that is zero but for rounding, which Adam turns
# into a step of up to lr either way, differently on the card and the CPU
# (ROADMAP.md queue 3); wd * bias outweighs that rounding, so both take
# the same step and the row compares the kernels, not the rounding's sign
CDC_CHECK_WD = 1e-3
CDC_TREAT = 14                  # the checked mask row: 14 domains, 2 steps
# epochs of the fit: the warmup and the one matrix update run in epoch 0,
# the others train the clustering split-mode (the 2,048-step update
# interval is longer than an epoch).  One epoch read valid AUC 0.634 on
# these conflicting clusters on an H100 (PERF.md §4): the check that the
# fit learns needs more than one epoch's 252 steps; each epoch's AUC prints
CDC_EPOCHS = 3


def adjusted_rand_index(a, b) -> float:
    """Adjusted Rand index of two labelings (Hubert and Arabie)."""
    a = np.unique(np.asarray(a), return_inverse=True)[1]
    b = np.unique(np.asarray(b), return_inverse=True)[1]
    cont = np.zeros((a.max() + 1, b.max() + 1), np.int64)
    np.add.at(cont, (a, b), 1)

    def pairs(x):
        return (x * (x - 1) / 2).sum()

    s, sa, sb = pairs(cont), pairs(cont.sum(1)), pairs(cont.sum(0))
    expected = sa * sb / pairs(np.array([len(a)]))
    top = (sa + sb) / 2
    return float((s - expected) / (top - expected)) if top != expected \
        else 1.0


def cdc_config(dropout=DROPOUT, epoch=CDC_EPOCHS, base="mmoe", **train):
    """Phase 17's configuration: the flagship MMoE as CDC's base (expert
    dims from mlp_dims), 4 clusters, every other CDC field at its
    reference default; B=512, CDC_EPOCHS epochs, bf16 table moments.
    ``base`` names another base (phase 18: "ple" gives CDCConfig()
    itself, PLE keeping its own expert dims; "star")."""
    from tpurec_torch.config import (CDCConfig, Config, ModelConfig,
                                     TrainConfig)

    return Config(
        model=ModelConfig(model="cdc", embed_dim=16,
                          mlp_dims=(256, 128, 64), mmoe_n_expert=4,
                          use_atten=True, atten_embed_dim=64,
                          att_layer_num=3, att_head_num=2, dropout=dropout),
        cdc=CDCConfig(base_model=base, n_cluster=N_TOWER,
                      cdc_tower_dims=(64, 32)),
        train=TrainConfig(**{"bs": 512, "epoch": epoch, "seed": 0,
                             "embedding_moments_dtype": "bfloat16",
                             **train}))


def _observe_schedule(tr, sched):
    """Wrap the trainer's schedule entry points to record what it built:
    the warmup's steps, each populate block's rows, valid steps and
    trained rows, the probe forwards; and time the warmup and the
    split-mode spans (each ended by a synchronize)."""
    orig_warm, orig_pop = tr._warmup_sched, tr._run_populate_async
    orig_base, orig_run, orig_span = (tr.eval_all_domains, tr._run_steps,
                                      tr._train_span)

    def warmup_sched():
        out = orig_warm()
        sched["warmup_steps"] += len(out[0])
        return out

    def populate(bidx, bmask, bvalid, eidx, emask):
        valid = bvalid > 0
        sched["blocks"].append({
            "rows": int(bidx.shape[0]), "valid_steps": int(valid.sum()),
            "width": int(bidx.shape[-1]),
            "trained_rows": int(bmask[valid].sum())})
        sched["probe_forwards"] += int(bidx.shape[0])
        return orig_pop(bidx, bmask, bvalid, eidx, emask)

    def baseline(idx, mask):
        sched["probe_forwards"] += 1
        return orig_base(idx, mask)

    def run_steps(mode, idxs, masks, valids=None):
        if mode != "warmup":
            return orig_run(mode, idxs, masks, valids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_run(mode, idxs, masks, valids)
        torch.cuda.synchronize()
        sched["warmup_seconds"] += time.perf_counter() - t0
        return out

    def span(seq, lo, hi):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_span(seq, lo, hi)          # ends in its loss fetch
        sched["span_seconds"] += time.perf_counter() - t0
        sched["span_steps"] += hi - lo
        return out

    tr._warmup_sched, tr._run_populate_async = warmup_sched, populate
    tr.eval_all_domains, tr._run_steps, tr._train_span = (baseline,
                                                          run_steps, span)


def _check_rollback(tr, sched, record):
    """Wrap update_matrix_cdc: after it, every parameter and BN buffer
    equals its update-entry value bitwise, while the table's moments, the
    dense Adam's and the step count advanced by the blocks' valid steps."""
    orig = tr.update_matrix_cdc
    names = {id(p): n for n, p in tr.model.named_parameters()}

    def update(k):
        entry = {n: t.detach().clone()
                 for n, t in tr.model.state_dict().items()}
        step0, n_blocks = tr.state.step, len(sched["blocks"])
        m0 = tr.state.emb_opt.m.clone()
        p = next(iter(tr.state.optimizer.state))
        adam0 = {k: v.clone() for k, v in tr.state.optimizer.state[p].items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig(k)
        torch.cuda.synchronize()
        record["seconds"] = time.perf_counter() - t0
        changed = [n for n, t in tr.model.state_dict().items()
                   if not torch.equal(t, entry[n])]
        check(not changed, f"update_matrix_cdc did not roll back {changed}")
        valid = sum(b["valid_steps"] for b in sched["blocks"][n_blocks:])
        adam1 = tr.state.optimizer.state[p]
        check(tr.state.step - step0 == valid,
              f"update_matrix_cdc advanced the step by {tr.state.step - step0}"
              f", its blocks hold {valid} valid steps")
        check(int(adam1["step"]) - int(adam0["step"]) == valid,
              f"the dense Adam of {names[id(p)]} advanced "
              f"{int(adam1['step']) - int(adam0['step'])} steps, not {valid}")
        check(not torch.equal(tr.state.emb_opt.m, m0)
              and not torch.equal(adam1["exp_avg"], adam0["exp_avg"]),
              "update_matrix_cdc rolled the Adam moments back")
        record.update(tensors=len(entry), valid_steps=valid,
                      step_before=step0, step_after=tr.state.step)
        del entry, m0

    tr.update_matrix_cdc = update


def cdc_row_vs_cpu(data, blob, d2g, tag, base="mmoe"):
    """Check 3 of phase 17: one mask row (CDC_TREAT domains, one pass, so
    2 treatment steps at W = 3,584 with masked rows) and its all-domain
    probe eval (D * 512 = 25,600 rows), from the fitted state with dropout
    0, on the card and on the CPU's plain path; the [D] row within
    CDC_ROW_TOL of max(1, |x|), the table after the burst as phase 9
    compares it.  The table's moments are held in float32 here (the
    fitted bfloat16 ones convert exactly): from a trained state a float32
    moment one rounding apart lands in another bfloat16 value on either
    side, and the second step then differs by about 0.4% of its size (5.6e-6
    on 68 of 26M entries on an H100); phases 7 and 9 hold the bfloat16
    moments.  ``base``: CDC's base model (phase 18)."""
    from tpurec_torch.cdc import CDCTrainer

    cfg = cdc_config(dropout=0.0, wd=CDC_CHECK_WD, base=base,
                     embedding_moments_dtype="float32")
    what = "cdc" if base == "mmoe" else f"cdc {base}"
    out = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        t = CDCTrainer(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX, device=where)
        t.restore_bytes(blob)
        t.setup_data(data.train)
        t.cluster.domain2group = np.asarray(d2g, np.int64)
        bidx, bmask, bvalid = t._multi_burst_sched(
            list(range(CDC_TREAT)), 1, 2)
        eidx, emask = t._eval_sched()
        Xsrc, ysrc, bi, ei = t._feed(bidx, eidx)
        losses = t._steps("split", Xsrc, ysrc, bi, t._dev(bmask), bvalid)
        table = t.model.embedding.table.detach().cpu().clone()
        row = t._eval_rows(Xsrc, ysrc, ei, t._dev(emask)).cpu().double()
        out[where] = dict(losses=[float(v) for v in losses], table=table,
                          row=row, bidx=bidx, eidx=eidx,
                          masked=int((bmask[bvalid > 0] == 0).sum()))
        print(f"{what} populate row on {where}: {len(losses)} steps of "
              f"{bidx.shape[1]} rows ({out[where]['masked']} masked), losses "
              f"{out[where]['losses']}, probe eval of {eidx.size} rows "
              f"({time.perf_counter() - t0:.1f} s)")
        del t, Xsrc, ysrc, bi, ei
        torch.cuda.empty_cache()
    g, c = out["cuda"], out["cpu"]
    check(np.array_equal(g["bidx"], c["bidx"])
          and np.array_equal(g["eidx"], c["eidx"]),
          "the card's and the CPU's schedules differ")
    check(len(g["losses"]) == 2 and g["bidx"].shape[1] == 7 * 512,
          f"the checked row ran {len(g['losses'])} steps of "
          f"{g['bidx'].shape[1]} rows")
    row_err = ((g["row"] - c["row"]).abs()
               / torch.clamp(c["row"].abs(), min=1.0)).max().item()
    diff = (g["table"] - c["table"]).abs()
    share = (diff > 1e-6).float().mean().item()
    loss_rel = max(abs(a / b - 1) for a, b in zip(g["losses"], c["losses"]))
    print(f"{tag} {what} populate row, card vs CPU plain path (dropout 0, wd "
          f"{CDC_CHECK_WD}, float32 moments): [D] probe row max err {row_err:.3g} of max(1, "
          f"|x|) (tol {CDC_ROW_TOL}); step loss max rel err {loss_rel:.3g}; "
          f"table after the burst max abs err {diff.max().item():.3g} (tol "
          f"2 lr), share beyond 1e-6 {share:.3g} (tol {CPU_TABLE_SHARE})")
    check(row_err <= CDC_ROW_TOL, f"{what} populate row: max err {row_err}")
    check(loss_rel <= CPU_LOSS_RTOL, f"{what} populate row: loss rel err "
          f"{loss_rel}")
    check(diff.max().item() <= 2 * cfg.train.lr + 1e-6
          and share <= CPU_TABLE_SHARE,
          f"{what} populate row: table max abs err {diff.max().item()}, share "
          f"beyond 1e-6 {share}")
    return {"row_err": row_err, "loss_rel_err": loss_rel,
            "table_max_abs_err": diff.max().item(),
            "table_share_beyond_1e-6": share,
            "masked_rows": g["masked"]}


def cdc_profile(tr, tag, n=PROFILE_STEPS):
    """Check 6 of phase 17: where a treatment step's time goes, at W =
    3,584 (7 domains a step) and at 512 (one domain), from the fitted
    trainer: device busy share of the profiled window, launches a step,
    device time by kernel."""
    out = {}
    for width in (7 * 512, 512):
        if width == 512:
            pairs = [tr._next_idx_padded(d % N_DOMAIN, 512)
                     for d in range(n + 2)]
            idxs = np.stack([p[0] for p in pairs])
            masks = np.stack([p[1] for p in pairs])
        else:
            idxs, masks, _ = tr._multi_burst_sched(
                list(range(N_DOMAIN)), 3, n + 2)
        Xsrc, ysrc, bi = tr._feed(idxs)
        md = tr._dev(masks)
        tr._steps("split", Xsrc, ysrc, bi[:2], md[:2])
        torch.cuda.synchronize()
        prof, dev_us, window_s, launches = profile_calls(
            lambda: tr._steps("split", Xsrc, ysrc, bi[2:], md[2:]), n,
            f"{tag} cdc profile W={width}",
            ("gather_kernel", "field_attention_kernel",
             "field_attention_bwd_kernel", "reduce_partials_kernel")
            + SWEEP_SYMS)
        busy = sum(dev_us.values())
        step_us = window_s / n * 1e6
        kernels = {
            name: path_device_ms(dev_us, syms, 1, f"{tag} cdc W={width}")
            for name, syms in (
                ("embedding_gather", ("gather_kernel",)),
                ("field_attention_train", ("field_attention_kernel",)),
                ("field_attention_bwd", ("field_attention_bwd_kernel",
                                         "reduce_partials_kernel")),
                ("fused_sparse_adam", SWEEP_SYMS))}
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        print(f"{tag} cdc treatment step profile, W={width} ({n} steps): "
              f"device busy {busy:.1f} us a step, {100 * busy / step_us:.1f}%"
              f" of the profiled window's {step_us / 1e3:.3f} ms a step; "
              f"{launches:.0f} launches a step; port kernels (ms a step) "
              + ", ".join(f"{k} {v:.4f}" for k, v in kernels.items())
              + "".join(f"\n    {us:9.1f} us  {name[:90]}"
                        for name, us in top))
        out[str(width)] = {"busy_us": busy, "step_ms_profiled": step_us / 1e3,
                           "busy_share": busy / step_us,
                           "launches_per_step": launches,
                           "kernel_device_ms": kernels,
                           "top": [[k[:90], v] for k, v in top]}
    return out


@functools.lru_cache(maxsize=None)
def cdc_data():
    """Phases 17 and 18's data: make_synthetic(131,072 rows) at the
    flagship schema with 4 antipodal domain clusters (made once)."""
    from tpurec_torch.data import make_synthetic

    return make_synthetic(
        n_rows=FIT_ROWS, n_fields=len(FIELD_DIMS), n_domain=N_DOMAIN,
        field_dims=FIELD_DIMS, domain_idx=DOMAIN_IDX, seed=1,
        domain_cluster_k=N_TOWER, domain_cluster_conflict=True)


def cdc_main_path(dev, tag, base="mmoe", phase=17, profile=True):
    """Phase 17: the CDC engine on the flagship MMoE at full width.
    make_synthetic(131,072 rows, the flagship schema, 4 antipodal domain
    clusters) -> CDCTrainer(...).fit(train, valid, test): the warmup, one
    matrix update (mask, A and B blocks, the clustering) and the
    split-mode epoch, with the kernel counters read around the fit against
    the schedule the trainer built; then one populate row against the
    CPU's plain path, the rollback (checked inside the fit), a checkpoint
    through a fresh CDCTrainer and predictor_from_checkpoint, and a
    profile of treatment steps (when ``profile``).  Phase 18 runs it on
    another ``base``.  -> (launches, summary)."""
    import os
    import tempfile

    from tpurec_torch.cdc import CDCTrainer
    from tpurec_torch.serve import predictor_from_checkpoint

    t_phase = time.perf_counter()
    data = cdc_data()
    cfg = cdc_config(base=base)
    what = "cdc" if base == "mmoe" else f"cdc {base}"
    t0 = time.perf_counter()
    tr = CDCTrainer(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX)
    check(tr.device.type == "cuda"
          and tr.model.embedding.table.device.type == "cuda",
          "the CDCTrainer was not built on the card")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sched = {"warmup_steps": 0, "blocks": [], "probe_forwards": 0,
             "warmup_seconds": 0.0, "span_seconds": 0.0, "span_steps": 0}
    rollback = {}
    _observe_schedule(tr, sched)
    _check_rollback(tr, sched, rollback)
    logs = []

    counters = train_counters(base)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = tr.fit(data.train, data.valid, data.test, log_fn=logs.append)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}

    epochs = [r for r in logs if "epoch_seconds" in r]
    n_epoch = len(epochs) * len(tr.train_batcher.domain_batch_seq)
    n_block = sum(b["valid_steps"] for b in sched["blocks"])
    n_steps = sched["warmup_steps"] + n_block + n_epoch
    n_eval = (len(epochs) * tr._padded_split(tr.valid_batcher)[6]
              + tr._padded_split(tr.test_batcher)[6])
    n_fwd = n_steps + sched["probe_forwards"] + n_eval
    want = {"embedding_gather": n_fwd, "field_attention_train": n_fwd,
            "field_attention_bwd": n_steps, "fused_decay_adam": n_steps,
            "fused_sparse_adam": n_steps}
    print(f"{what} main path: CDCTrainer.fit, {sched['warmup_steps']} warmup "
          f"steps, {len(sched['blocks'])} populate blocks "
          f"{[(b['rows'], b['valid_steps'], b['width']) for b in sched['blocks']]}"
          f" (rows, valid steps, width), {sched['probe_forwards']} probe "
          f"forwards, {len(epochs)} epochs of {n_epoch // len(epochs)} "
          f"steps, {n_eval} eval batches; "
          f"launches {launches}")
    check(launches == want, f"{what} fit's kernel launches {launches}, "
          f"expected {want} (a step each; a forward per probe eval and eval "
          f"batch)")
    check(rollback.get("valid_steps") == n_block,
          f"the rollback check saw {rollback.get('valid_steps')} valid "
          f"steps, the blocks hold {n_block}")

    st = tr.cluster
    d2g, s_g = out["domain2group_list"], out["s_group2domain_list"]
    valid = out["valid"]
    check(len(d2g) == N_DOMAIN and set(d2g) == set(range(N_TOWER)),
          f"domain2group_list {d2g} does not cover {N_TOWER} groups")
    check(len(s_g) == N_TOWER, f"s_group2domain_list has {len(s_g)} lists")
    mats = {"A": st.matrix_A, "B": st.matrix_B, "mask": st.matrix_mask,
            "causal": st.matrix_causal, "old_A": st.old_matrix_A,
            "old_B": st.old_matrix_B, "old_mask": st.old_matrix_mask}
    check(all(np.all(np.isfinite(m)) for m in mats.values()),
          "a CDC matrix is not finite")
    check(np.abs(st.old_matrix_mask).sum() > 0
          and np.abs(st.old_matrix_A).sum() > 0,
          "the mask or A matrix was not populated")
    auc, mean_auc = valid["total_auc"], valid["mean_auc"]
    ari = adjusted_rand_index(d2g, data.domain_cluster)
    upd_log = [r for r in logs if "cdc_update_seconds" in r]
    check(len(upd_log) == 1 and st.call_update_group == 1,
          f"{len(upd_log)} matrix updates logged, "
          f"{st.call_update_group} clusterings (one expected)")
    update_s = upd_log[0]["cdc_update_seconds"]
    upd_rows = sum(b["trained_rows"] for b in sched["blocks"])
    print(f"{tag} {what} fit: valid total_auc {auc:.5f} (min {FIT_AUC_MIN}), "
          f"mean_auc {mean_auc:.5f}, total_loss {valid['total_loss']:.5f}; "
          f"test total_auc {out['test']['total_auc']:.5f}; valid total_auc "
          f"by epoch {[round(r['total_auc'], 5) for r in epochs]} (best "
          f"epoch {valid['epoch']}); groups "
          f"{np.bincount(d2g, minlength=N_TOWER).tolist()}, adjusted Rand "
          f"index vs the data's clusters {ari:.4f}")
    print(f"{tag} {what} times (host clock): build {build_s:.2f} s; warmup "
          f"{sched['warmup_steps']} steps {sched['warmup_seconds']:.3f} s "
          f"({sched['warmup_seconds'] / sched['warmup_steps'] * 1e3:.3f} ms a "
          f"step); cdc_update_seconds {update_s:.3f} ({rollback['seconds']:.3f}"
          f" synchronized), {n_block} valid steps, {upd_rows} trained rows = "
          f"{upd_rows / update_s:.0f} rows/s, {sched['probe_forwards']} probe "
          f"evals of {N_DOMAIN * 512} rows; split-mode epochs {sched['span_steps']} steps "
          f"{sched['span_seconds']:.3f} s "
          f"({sched['span_seconds'] / max(sched['span_steps'], 1) * 1e3:.3f} "
          f"ms a step); epoch 0 with warmup, update and valid eval "
          f"{epochs[0]['epoch_seconds']:.3f} s; fit {fit_s:.3f} s")
    check(auc >= FIT_AUC_MIN, f"{what} valid total_auc {auc} < {FIT_AUC_MIN}")
    check(np.isfinite(mean_auc), f"{what} valid mean_auc {mean_auc}")
    print(f"{tag} {what} rollback: {rollback['tensors']} parameters and buffers "
          f"bitwise equal to their update-entry values; step "
          f"{rollback['step_before']} -> {rollback['step_after']} (+"
          f"{rollback['valid_steps']} valid steps), moments advanced")

    # one populate row on the card against the CPU's plain path
    blob = tr.snapshot_bytes()
    row_check = cdc_row_vs_cpu(data, blob, d2g, tag, base)

    # the checkpoint: a fresh trainer, and the Predictor
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        path = os.path.join(tmp, "cdc.pkl")
        t1 = time.perf_counter()
        tr.save_checkpoint(path, extra={"phase": phase})
        write_s = time.perf_counter() - t1
        size_mb = os.path.getsize(path) / 1e6
        fresh = CDCTrainer(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX)
        payload = fresh.load_checkpoint(path)
        served = predictor_from_checkpoint(path, batch_sizes=(512,))
    check(payload["extra"] == {"phase": phase}, f"{what} checkpoint extra lost")
    check(fresh.snapshot_bytes() == blob,
          "a fresh CDCTrainer.load_checkpoint holds another state")
    a, b = fresh._cluster_payload(), tr._cluster_payload()
    same = all(
        np.array_equal(a["matrices"][k], b["matrices"][k])
        for k in b["matrices"]) and all(
        a[k] == b[k] for k in b if k != "matrices")
    check(same, "a fresh CDCTrainer.load_checkpoint holds another cluster")
    del fresh
    Xv, _, p_tr = tr.predict_split(tr.valid_batcher)
    p_srv = served(Xv)
    serve_err = float(np.max(np.abs(p_srv - p_tr)))
    del served
    torch.cuda.empty_cache()
    print(f"{tag} {what} checkpoint: {size_mb:.1f} MB written in {write_s:.3f} "
          f"s; a fresh CDCTrainer's state and cluster bitwise equal; "
          f"predictor_from_checkpoint vs CDCTrainer.predict_split on "
          f"{len(Xv)} valid rows max abs err {serve_err:.3g} (tol "
          f"{LOAD_TOL})")
    check(serve_err <= LOAD_TOL, f"{what} checkpoint Predictor: max abs err "
          f"{serve_err}")

    prof = cdc_profile(tr, tag) if profile else None
    del tr
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"{what} phase: {phase_s:.1f} s")
    return launches, {
        "rows": {"train": len(data.train[1]), "valid": len(data.valid[1]),
                 "test": len(data.test[1])},
        "warmup_steps": sched["warmup_steps"], "blocks": sched["blocks"],
        "probe_forwards": sched["probe_forwards"], "epoch_steps": n_epoch,
        "eval_batches": n_eval, "launches": launches,
        "valid": {k: valid[k] for k in ("total_auc", "mean_auc",
                                        "total_loss", "mean_loss",
                                        "train_loss", "epoch_seconds",
                                        "epoch")},
        "valid_auc_by_epoch": [r["total_auc"] for r in epochs],
        "epoch_seconds": [r["epoch_seconds"] for r in epochs],
        "test_total_auc": out["test"]["total_auc"],
        "domain2group": d2g, "adjusted_rand_index": ari,
        "build_seconds": build_s, "warmup_seconds": sched["warmup_seconds"],
        "cdc_update_seconds": update_s,
        "update_seconds_synchronized": rollback["seconds"],
        "update_valid_steps": n_block, "update_trained_rows": upd_rows,
        "update_rows_per_s": upd_rows / update_s,
        "epoch_span_seconds": sched["span_seconds"],
        "epoch_span_steps": sched["span_steps"], "fit_seconds": fit_s,
        "populate_row_vs_cpu": row_check, "checkpoint_mb": size_mb,
        "checkpoint_write_seconds": write_s, "checkpoint_serve_err": serve_err,
        "profile": prof, "phase_seconds": phase_s}


# -- CDC's other base models through every entry point (phase 18) ------------

BASES = ("ple", "pepnet", "epnet", "star")
# PLE's table scale and wd in the 3 steps against the CPU (train_vs_cpu)
PLE_VS_CPU = (1.0, 1e-3)


def bases_main_path(dev, rng, tag):
    """Phase 18 (a): each of CDC's other bases at its ModelConfig defaults
    on the flagship schema: the Predictor scores N_ROWS rows against the
    CPU's plain path with #1 and #2 counted, rows/s and a chunk profile at
    each batch size; the hybrid step as phase 8 drives MMoE's (K=8, 8
    warm-up and 16 timed steps, #1, #2, #3 and #6's pass once a step),
    its profile, and 3 steps against the CPU's plain path.
    -> {name: summary}."""
    from tpurec_torch.config import Config, ModelConfig
    from tpurec_torch.ops.attention import field_attention
    from tpurec_torch.ops.embedding import embedding_gather
    from tpurec_torch.serve import Predictor

    out = {}
    d2g = np.arange(N_DOMAIN) % N_TOWER
    for i, name in enumerate(BASES):
        t0 = time.perf_counter()
        kw = {"model": name}
        cfg = Config(model=ModelConfig(**kw))
        sd, n_params = serving_weights(
            name, cfg.model, torch.Generator().manual_seed(SEED + 10 + i))
        preds = {w: Predictor(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                              domain2group=d2g, batch_sizes=BATCH_SIZES,
                              device=w).load_state_dict(sd)
                 for w in ("cuda", "cpu")}
        pred = preds["cuda"]
        pred.warm()
        X = random_ids(rng, N_ROWS)
        embedding_gather.launches = 0
        field_attention.launches = 0
        p_gpu = pred(X)
        serve_launches = {"embedding_gather": embedding_gather.launches,
                          "field_attention": field_attention.launches}
        check(all(n > 0 for n in serve_launches.values()),
              f"{name} Predictor: a kernel was not launched: "
              f"{serve_launches}")
        p_cpu = preds.pop("cpu")(X)
        err = float(np.max(np.abs(p_gpu - p_cpu)))
        check(p_gpu.shape == (N_ROWS,) and np.all(np.isfinite(p_gpu))
              and np.all((p_gpu > 0) & (p_gpu < 1)),
              f"{name} predictions malformed")
        check(err <= PRED_TOL, f"{name} Predictor cuda vs cpu: max abs err "
              f"{err}")
        print(f"{name} main path: Predictor ({n_params} params) scored "
              f"{N_ROWS} rows, launches {serve_launches}; cuda vs cpu plain "
              f"path max abs err {err:.3g} (tol {PRED_TOL}); mean prob "
              f"{p_gpu.mean():.4f}")
        chunk_s, chunk_dev, chunk_busy = chunk_timings(
            pred, rng, tag, {"embedding_gather": "gather_kernel",
                             "field_attention": "field_attention_kernel"})
        del preds, pred
        ts, single, batches, tgen, train_launches, timing = \
            train_main_path(dev, rng, tag, name, kw)
        _, profile = step_profile(dev, ts, single, batches, tgen,
                                  f"{tag} {name}", timing["step_ms_host"])
        del ts, single, batches
        torch.cuda.empty_cache()
        vs_cpu = train_vs_cpu(dev, rng, name, kw,
                              *PLE_VS_CPU if name == "ple" else ())
        out[name] = {
            "params": n_params,
            "serve": {"launches": serve_launches, "max_abs_err": err,
                      "rows_per_s": {str(B): B / t for B, t in
                                     chunk_s.items()},
                      "chunk_device_busy_us": {str(B): v for B, v in
                                               chunk_busy.items()},
                      "chunk_device_ms": chunk_dev},
            "train": {**timing, "launches": train_launches,
                      "vs_cpu": vs_cpu, "profile": profile},
            "seconds": time.perf_counter() - t0}
        B = BATCH_SIZES[-1]
        print(f"{tag} {name}: serving {B} rows/s "
              f"{out[name]['serve']['rows_per_s'][str(B)]:.0f}, "
              f"training {timing['examples_per_s_host']:.0f} examples/s "
              f"(host clock), step busy {100 * profile['busy_share']:.1f}% "
              f"over {profile['launches_per_step']:.0f} launches "
              f"({out[name]['seconds']:.1f} s)")
        torch.cuda.empty_cache()
    return out


def star_cdc_row(tag):
    """Phase 18 (c): STAR as CDC's base, called without the group (every
    tower's BatchNorms take the whole batch): one populate row at W =
    3,584 with its 25,600-row probe eval, card against the CPU's plain
    path, as phase 17's check 3.  The state is a fresh trainer's, with its
    partitioned norm's shifts drawn N(0, 0.1**2): a zero shift has a
    gradient that is rounding alone (the tower BatchNorms remove it), which
    wd * shift then outweighs, as CDC_CHECK_WD does for the trained biases
    of phase 17."""
    from tpurec_torch.cdc import CDCTrainer

    tr = CDCTrainer(cdc_config(base="star"), FIELD_DIMS, N_DOMAIN,
                    DOMAIN_IDX)
    gen = torch.Generator().manual_seed(SEED + 20)
    with torch.no_grad():
        for p in (tr.model.pn.bias, tr.model.pn.shared_bias):
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    blob = tr.snapshot_bytes()
    del tr
    torch.cuda.empty_cache()
    return cdc_row_vs_cpu(cdc_data(), blob, np.arange(N_DOMAIN) % N_TOWER,
                          tag, "star")



# -- the group-routed models and bf16 compute (phase 19) ----------------------

ROUTED = ("hinet", "adl", "adl-split", "adasparse")
# ADL's cluster centres after 3 steps, card vs CPU (unit vectors)
CENTRE_TOL = 1e-5
# bf16 compute, card vs CPU on the card's branches: a pre-cast float32
# value whose last bits differ between the two rounds to a neighbouring
# bf16 value, 2**-8 apart, which moves the products it enters.  Each limit
# is about 4x the largest of 3 seeds x (MMoE, HiNet) measured on an
# NVIDIA H100 80GB HBM3 at 700 W (scripts/bf16_card_gaps.py: phase 19 (b)
# at batch seeds 100-102; PERF.md): the Predictor 5.0e-5 to 1.47e-4 max
# abs; the loss 2.2e-4 to 5.0e-4 relative; step 1's row gradient 5.0e-3
# to 7.6e-3 of its max; table values beyond 1e-6 after step 1 (Adam's
# +-lr where a near-zero gradient's sign differs) 3.1e-6 to 4.2e-6
BF16_PRED_TOL = 6e-4
BF16_LOSS_RTOL = 2e-3
BF16_GRAD_RTOL = 3e-2
BF16_TABLE_SHARE = 2e-5
BF16_MODELS = ("mmoe", "hinet")
# AdaSparse's table scale in the 3 steps against the CPU: its layer weights
# start N(0, 1e-4**2), and at x0.01 one rounding of the first step's rows
# moves its third loss by 1.75e-3 and its row gradient by 2.6e-2 of the
# largest on the CPU alone, at x1 by 2.2e-7 and 4.3e-7
# (scripts/loss_sensitivity.py --model adasparse --scale 0.01 1.0); at
# x0.01 the card's third loss sat 2.5e-4 from the CPU's in one run
ROUTED_SCALE = {"adasparse": 1.0}


def routed_main_path(dev, rng, tag):
    """Phase 19 (a): HiNet, ADL, ADL-split and AdaSparse at their
    ModelConfig defaults on the flagship schema, as phase 18 (a) drives
    CDC's bases: the Predictor on N_ROWS rows against the CPU's plain
    path on the card's branches (ADL's routing and AdaSparse's pruner
    mask replayed), #1 and #2 counted, rows/s and a chunk profile at each
    batch size; the K=8 loop with #1, #2, #3 and #6's pass once a step and
    its profile; 3 steps, step 1's row gradient and ADL's centres against
    the CPU on the card's branches (AdaSparse at its table's init scale,
    ROUTED_SCALE).  -> {name: summary}."""
    from tpurec_torch.config import Config, ModelConfig
    from tpurec_torch.ops.attention import field_attention
    from tpurec_torch.ops.embedding import embedding_gather
    from tpurec_torch.serve import Predictor

    out = {}
    d2g = np.arange(N_DOMAIN) % N_TOWER
    for i, name in enumerate(ROUTED):
        t0 = time.perf_counter()
        kw = {"model": name}
        cfg = Config(model=ModelConfig(**kw))
        sd, n_params = serving_weights(
            name, cfg.model, torch.Generator().manual_seed(SEED + 30 + i))
        preds = {w: Predictor(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                              domain2group=d2g, batch_sizes=BATCH_SIZES,
                              device=w).load_state_dict(sd)
                 for w in ("cuda", "cpu")}
        pred = preds["cuda"]
        check(pred.model.n_tower == N_TOWER, f"{name}: {pred.model.n_tower} "
              f"towers, expected {N_TOWER} (n_cluster or the grouping's)")
        pred.warm()
        X = random_ids(rng, N_ROWS)
        embedding_gather.launches = 0
        field_attention.launches = 0
        masks = []
        with relu_branches(masks, record=True):
            p_gpu = pred(X)
        serve_launches = {"embedding_gather": embedding_gather.launches,
                          "field_attention": field_attention.launches}
        check(all(n > 0 for n in serve_launches.values()),
              f"{name} Predictor: a kernel was not launched: "
              f"{serve_launches}")
        with relu_branches(masks, record=False) as br:
            p_cpu = preds.pop("cpu")(X)
        check(br.used == len(masks), f"{name} Predictor: the CPU replayed "
              f"{br.used} of the card's {len(masks)} branch calls")
        err = float(np.max(np.abs(p_gpu - p_cpu)))
        check(p_gpu.shape == (N_ROWS,) and np.all(np.isfinite(p_gpu))
              and np.all((p_gpu > 0) & (p_gpu < 1)),
              f"{name} predictions malformed")
        check(err <= PRED_TOL, f"{name} Predictor cuda vs cpu: max abs err "
              f"{err}")
        print(f"{name} main path: Predictor ({n_params} params, "
              f"{pred.model.n_tower} towers) scored {N_ROWS} rows, launches "
              f"{serve_launches}; cuda vs cpu plain path (on the card's "
              f"branches, {br.flips} inputs flipped) max abs err {err:.3g} "
              f"(tol {PRED_TOL}); mean prob {p_gpu.mean():.4f}")
        chunk_s, chunk_dev, chunk_busy = chunk_timings(
            pred, rng, tag, {"embedding_gather": "gather_kernel",
                             "field_attention": "field_attention_kernel"})
        del preds, pred
        ts, single, batches, tgen, train_launches, timing = \
            train_main_path(dev, rng, tag, name, kw)
        _, profile = step_profile(dev, ts, single, batches, tgen,
                                  f"{tag} {name}", timing["step_ms_host"])
        del ts, single, batches
        torch.cuda.empty_cache()
        vs_cpu = train_vs_cpu(dev, rng, name, kw,
                              ROUTED_SCALE.get(name, 0.01), replay=True)
        out[name] = {
            "params": n_params,
            "serve": {"launches": serve_launches, "max_abs_err": err,
                      "flips": br.flips,
                      "rows_per_s": {str(B): B / t for B, t in
                                     chunk_s.items()},
                      "chunk_device_busy_us": {str(B): v for B, v in
                                               chunk_busy.items()},
                      "chunk_device_ms": chunk_dev},
            "train": {**timing, "launches": train_launches,
                      "vs_cpu": vs_cpu, "profile": profile},
            "seconds": time.perf_counter() - t0}
        B = BATCH_SIZES[-1]
        print(f"{tag} {name}: serving {B} rows/s "
              f"{out[name]['serve']['rows_per_s'][str(B)]:.0f}, "
              f"training {timing['examples_per_s_host']:.0f} examples/s "
              f"(host clock), step busy {100 * profile['busy_share']:.1f}% "
              f"over {profile['launches_per_step']:.0f} launches "
              f"({out[name]['seconds']:.1f} s)")
        torch.cuda.empty_cache()
    return out


def bf16_fit(tag, name, data, compute_dtype):
    """One Trainer.fit epoch at phase 16's settings (B=512, dropout 0.2,
    bf16 table moments, the indexed epoch) of model ``name`` in
    ``compute_dtype``.  -> summary dict (valid AUC, ms a step)."""
    from tpurec_torch.config import Config, ModelConfig, TrainConfig
    from tpurec_torch.train import Trainer

    cfg = Config(model=ModelConfig(**(MODEL if name == "mmoe"
                                      else {"model": name}),
                                   dropout=DROPOUT),
                 train=TrainConfig(bs=512, epoch=1, seed=0,
                                   embedding_moments_dtype="bfloat16",
                                   compute_dtype=compute_dtype))
    tr = Trainer(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                 domain2group=np.arange(N_DOMAIN) % N_TOWER)
    n_steps = -(-len(data.train[1]) // cfg.train.bs)
    marks = {}

    def log_fn(r):
        torch.cuda.synchronize()
        marks.setdefault("train_end", time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tr.fit(data.train, data.valid,
                 domain_cnt_weight=data.domain_cnt_weight(), log_fn=log_fn)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    valid = res["valid"]
    check(valid is not None and np.isfinite(valid["total_auc"]),
          f"{name} {compute_dtype} fit: no finite valid result")
    check(valid["total_auc"] >= FIT_AUC_MIN, f"{name} {compute_dtype} fit: "
          f"valid total_auc {valid['total_auc']} < {FIT_AUC_MIN}")
    step_ms = (marks["train_end"] - t0) / n_steps * 1e3
    del tr
    torch.cuda.empty_cache()
    return {"valid_total_auc": valid["total_auc"],
            "valid_mean_auc": valid["mean_auc"],
            "valid_total_loss": valid["total_loss"],
            "train_loss": valid["train_loss"], "steps": n_steps,
            "step_ms": step_ms, "fit_seconds": fit_s}


def bf16_main_path(dev, rng, tag, f32_fit_auc):
    """Phase 19 (b): compute_dtype="bfloat16" on the flagship MMoE and on
    HiNet: each one's Predictor on N_ROWS rows and 3 steps against the
    CPU's bf16 plain path (on the card's branches), held to the BF16_*
    limits; one Trainer.fit epoch at phase 16's settings in bf16 (and
    HiNet's in float32), its valid AUC beside phase 16's float32 MMoE
    AUC ``f32_fit_auc``.  -> summary dict."""
    import dataclasses

    from tpurec_torch.config import Config, ModelConfig
    from tpurec_torch.data import make_synthetic
    from tpurec_torch.serve import Predictor

    out = {}
    d2g = np.arange(N_DOMAIN) % N_TOWER
    for i, name in enumerate(BF16_MODELS):
        kw = MODEL if name == "mmoe" else {"model": name}
        cfg = Config(model=ModelConfig(**kw))
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, compute_dtype="bfloat16"))
        sd, _ = serving_weights(
            name, cfg.model, torch.Generator().manual_seed(SEED + 40 + i))
        preds = {w: Predictor(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                              domain2group=d2g, batch_sizes=BATCH_SIZES,
                              device=w).load_state_dict(sd)
                 for w in ("cuda", "cpu")}
        X = random_ids(rng, N_ROWS)
        masks = []
        with relu_branches(masks, record=True):
            p_gpu = preds["cuda"](X)
        with relu_branches(masks, record=False) as br:
            p_cpu = preds["cpu"](X)
        f32 = Predictor(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, compute_dtype="float32")), FIELD_DIMS, N_DOMAIN,
            DOMAIN_IDX, domain2group=d2g, batch_sizes=BATCH_SIZES,
            device="cuda").load_state_dict(sd)
        p_f32 = f32(X)
        del preds, f32
        err = float(np.max(np.abs(p_gpu - p_cpu)))
        gap = float(np.max(np.abs(p_gpu - p_f32)))
        check(np.all(np.isfinite(p_gpu)) and err <= BF16_PRED_TOL,
              f"{name} bf16 Predictor cuda vs cpu: max abs err {err}")
        check(gap > 0, f"{name} bf16 Predictor equals float32's: no cast")
        print(f"{tag} {name} bf16 Predictor: cuda vs cpu bf16 plain path "
              f"max abs err {err:.3g} (tol {BF16_PRED_TOL}; {br.flips} "
              f"inputs flipped, replayed); bf16 vs float32 on the card max "
              f"abs {gap:.3g}")
        torch.cuda.empty_cache()
        vs_cpu = train_vs_cpu(dev, rng, name, kw, compute_dtype="bfloat16",
                              replay=True, loss_rtol=BF16_LOSS_RTOL,
                              grad_rtol=BF16_GRAD_RTOL,
                              table_share=BF16_TABLE_SHARE)
        out[name] = {"predictor_max_abs_err": err,
                     "predictor_bf16_vs_f32": gap, "flips": br.flips,
                     "vs_cpu": vs_cpu}
    t0 = time.perf_counter()
    data = make_synthetic(n_rows=FIT_ROWS, n_fields=len(FIELD_DIMS),
                          n_domain=N_DOMAIN, field_dims=FIELD_DIMS,
                          domain_idx=DOMAIN_IDX, seed=1)
    print(f"bf16 fit data: make_synthetic({FIT_ROWS} rows) in "
          f"{time.perf_counter() - t0:.2f} s")
    fits = {"mmoe/bfloat16": bf16_fit(tag, "mmoe", data, "bfloat16"),
            "hinet/bfloat16": bf16_fit(tag, "hinet", data, "bfloat16"),
            "hinet/float32": bf16_fit(tag, "hinet", data, "float32")}
    for k, r in fits.items():
        print(f"{tag} fit {k}: 1 epoch of {r['steps']} indexed steps, "
              f"{r['step_ms']:.3f} ms a step (host clock), valid total_auc "
              f"{r['valid_total_auc']:.5f} (phase 16's float32 MMoE "
              f"{f32_fit_auc:.5f}), mean_auc {r['valid_mean_auc']:.5f}")
    out["fit"] = fits
    out["fit"]["mmoe/float32 (phase 16)"] = {"valid_total_auc": f32_fit_auc}
    return out

# -- the rest of the zoo and the "dense"/"sparse" updates (phase 20) ----------

# the table scale of each zoo model's 3 steps against the CPU
# (train_vs_cpu), from scripts/loss_sensitivity.py --model <name> --scale
# 0.01 1.0 on the CPU: one rounding of step 1's rows moves the three
# losses (worst of 2 seeds, relative) at x0.01 / x1 by: DeepFM 1.7e-7 /
# 7.2e-8 (but its loss at x1 is 27: saturated logits), DCNv2 1.7e-7 /
# 1.5e-7, AutoInt 8.6e-8 / 8.5e-8, xDeepFM 1.7e-7 / 3.2e-6, IPNN 6.8e-6 /
# 8.4e-8, OPNN 1.7e-7 / 2.5e-7, AFM 0 / 0 (with afm_dropouts off too).
# Each runs where it moves least; DeepFM, at a loss of 27 at x1
# (saturated logits), and AFM, even, at x0.01
ZOO_SCALE = {"deepfm": 0.01, "dcnv2": 0.01, "autoint": 0.01,
             "xdeepfm": 0.01, "ipnn": 1.0, "opnn": 0.01, "afm": 0.01}
# the "dense" and "sparse" updates run on DeepFM (the CLI's default) and
# on the flagship MMoE (kernels 2 and 3 under each)
UPDATE_MODELS = ("deepfm", "mmoe")
UPDATE_CALLS = (1, 1)           # warm-up and timed calls of the K=8 loop
ZOO_FIT_AUC_MIN = 0.65
ZOO_FIT_INIT_STD = 0.01         # tpurec's documented opt-in embed_init_std


def zoo_kw(name):
    return MODEL if name == "mmoe" else {"model": name}


def zoo_main_path(dev, rng, tag):
    """Phase 20 (a): DeepFM, DCNv2, AutoInt, xDeepFM, IPNN, OPNN and AFM at
    their ModelConfig defaults on the flagship schema with one tower, as
    phase 19 (a) drives the routed models: the Predictor on N_ROWS rows
    against the CPU's plain path on the card's branches, #1 counted (and
    #2 for AutoInt), rows/s and a chunk profile at each batch size; the
    K=8 loop with #1 and #6's pass once a step (#2 and #3 too for AutoInt)
    and its profile; 3 steps and step 1's row gradient against the CPU on
    the card's branches (each at its ZOO_SCALE).  -> {name: summary}."""
    from tpurec_torch.config import Config, ModelConfig
    from tpurec_torch.ops.attention import field_attention
    from tpurec_torch.ops.embedding import embedding_gather
    from tpurec_torch.serve import Predictor

    out = {}
    d2g = np.zeros(N_DOMAIN, np.int64)
    for i, name in enumerate(ZOO):
        t0 = time.perf_counter()
        kw = {"model": name}
        cfg = Config(model=ModelConfig(**kw))
        sd, n_params = serving_weights(
            name, cfg.model, torch.Generator().manual_seed(SEED + 50 + i))
        preds = {w: Predictor(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                              domain2group=d2g, batch_sizes=BATCH_SIZES,
                              device=w).load_state_dict(sd)
                 for w in ("cuda", "cpu")}
        pred = preds["cuda"]
        check(pred.model.n_tower == 1, f"{name}: {pred.model.n_tower} towers")
        pred.warm()
        X = random_ids(rng, N_ROWS)
        counters = {"embedding_gather": embedding_gather}
        syms = {"embedding_gather": "gather_kernel"}
        if name == "autoint":
            counters["field_attention"] = field_attention
            syms["field_attention"] = "field_attention_kernel"
        for fn in counters.values():
            fn.launches = 0
        masks = []
        with relu_branches(masks, record=True):
            p_gpu = pred(X)
        serve_launches = {k: fn.launches for k, fn in counters.items()}
        check(all(n > 0 for n in serve_launches.values()),
              f"{name} Predictor: a kernel was not launched: "
              f"{serve_launches}")
        with relu_branches(masks, record=False) as br:
            p_cpu = preds.pop("cpu")(X)
        check(br.used == len(masks), f"{name} Predictor: the CPU replayed "
              f"{br.used} of the card's {len(masks)} branch calls")
        err = float(np.max(np.abs(p_gpu - p_cpu)))
        check(p_gpu.shape == (N_ROWS,) and np.all(np.isfinite(p_gpu))
              and np.all((p_gpu >= 0) & (p_gpu <= 1)),
              f"{name} predictions malformed")
        check(err <= PRED_TOL, f"{name} Predictor cuda vs cpu: max abs err "
              f"{err}")
        print(f"{name} main path: Predictor ({n_params} params, one tower) "
              f"scored {N_ROWS} rows, launches {serve_launches}; cuda vs cpu "
              f"plain path (on the card's branches, {br.flips} inputs "
              f"flipped) max abs err {err:.3g} (tol {PRED_TOL}); mean prob "
              f"{p_gpu.mean():.4f}")
        chunk_s, chunk_dev, chunk_busy = chunk_timings(pred, rng, tag, syms)
        del preds, pred
        ts, single, batches, tgen, train_launches, timing = \
            train_main_path(dev, rng, tag, name, kw)
        _, profile = step_profile(dev, ts, single, batches, tgen,
                                  f"{tag} {name}", timing["step_ms_host"])
        del ts, single, batches
        torch.cuda.empty_cache()
        vs_cpu = train_vs_cpu(dev, rng, name, kw, ZOO_SCALE[name],
                              replay=True)
        out[name] = {
            "params": n_params,
            "serve": {"launches": serve_launches, "max_abs_err": err,
                      "flips": br.flips,
                      "rows_per_s": {str(B): B / t for B, t in
                                     chunk_s.items()},
                      "chunk_device_busy_us": {str(B): v for B, v in
                                               chunk_busy.items()},
                      "chunk_device_ms": chunk_dev},
            "train": {**timing, "launches": train_launches,
                      "vs_cpu": vs_cpu, "profile": profile},
            "seconds": time.perf_counter() - t0}
        B = BATCH_SIZES[-1]
        print(f"{tag} {name}: serving {B} rows/s "
              f"{out[name]['serve']['rows_per_s'][str(B)]:.0f}, "
              f"training {timing['examples_per_s_host']:.0f} examples/s "
              f"(host clock), step busy {100 * profile['busy_share']:.1f}% "
              f"over {profile['launches_per_step']:.0f} launches "
              f"({out[name]['seconds']:.1f} s)")
        torch.cuda.empty_cache()
    return out


# "dense" against "hybrid" on the card, from one state with float32
# moments, the table after 3 steps, "hybrid" on "dense"'s branches: both
# are tpurec's exact dense Adam, and they differ in where rounding falls
# (torch.optim.Adam's arithmetic and index_add_'s atomics against kernel
# 6's pass).  Measured on an NVIDIA H100 80GB HBM3 at 700 W: max abs
# 1.92e-5 (DeepFM) and 9.96e-6 (MMoE), share of values beyond 1e-6 2.3e-7
# and 1.9e-7 (a value whose step sits within a rounding of Adam's eps);
# the limits are about 5x those
DENSE_HYBRID_TOL = 1e-4
DENSE_HYBRID_SHARE = 1e-6


def three_updates_on_card(dev, rng, name, kw, scale):
    """From one seeded state with float32 moments: 3 steps of model
    ``name`` under "dense", "hybrid" and "sparse" on the card, dropout 0,
    the same batches.  Holds the "dense" table against the "hybrid" one
    (DENSE_HYBRID_*), "hybrid" on "dense"'s branches
    (:class:`relu_branches`: the biases before a training BatchNorm step
    by about lr on rounding alone, differently in the two, which moves the
    rounding of the ReLU inputs after it), and "sparse"'s untouched rows
    and their moments to be bitwise unchanged.  -> summary dict."""
    from tpurec_torch.config import ModelConfig, TrainConfig
    from tpurec_torch.models import build_model

    tcfg = TrainConfig(bs=512, embedding_moments_dtype="float32",
                       wd=TRAIN_WD)
    batches = train_batches(rng, 3, dev)
    tables, out, masks = {}, {}, []
    for update in ("dense", "hybrid", "sparse"):
        model = build_model(name, FIELD_DIMS, towers(name), DOMAIN_IDX,
                            ModelConfig(**kw, **NO_DROPOUT), device=dev,
                            generator=torch.Generator().manual_seed(SEED + 5))
        with torch.no_grad():
            model.embedding.table.mul_(scale)
        ts = train_state(model, tcfg, dev, update)
        step = train_step_of(model, tcfg, name, update)
        table = model.embedding.table
        if update == "sparse":
            before = (table.detach().clone(), ts.emb_opt.m.clone(),
                      ts.emb_opt.v.clone())
        replay = update != "sparse"
        if replay:
            branches = relu_branches(masks, record=update == "dense")
            branches.__enter__()
        try:
            for i in range(3):
                step(ts, {k: v[i] for k, v in batches.items()}, None)
        finally:
            if replay:
                branches.__exit__(None, None, None)
        if update == "hybrid":
            check(branches.used == len(masks) > 0, f"{name} hybrid: "
                  f"replayed {branches.used} of dense's {len(masks)} "
                  f"branch calls")
            out["flips"] = branches.flips
        torch.cuda.synchronize()
        tables[update] = table.detach().clone()
        if update == "sparse":
            off = torch.as_tensor(model.embedding.layout.offsets,
                                  dtype=torch.int64, device=dev)
            touched = torch.zeros(table.shape[0], dtype=torch.bool,
                                  device=dev)
            touched[(batches["x"].long() + off).reshape(-1)] = True
            now = (table.detach(), ts.emb_opt.m, ts.emb_opt.v)
            same = all(torch.equal(a[~touched], b[~touched])
                       for a, b in zip(now, before))
            moved = float((now[0][touched] != before[0][touched]).any(
                dim=1).float().mean())
            check(same, f"{name} sparse: an untouched row or its moments "
                  f"changed")
            check(moved == 1.0, f"{name} sparse: only {moved} of the "
                  f"touched rows moved")
            out["sparse_untouched_rows"] = int((~touched).sum())
            out["sparse_touched_rows"] = int(touched.sum())
        del model, ts, step
        torch.cuda.empty_cache()
    diff = (tables["dense"] - tables["hybrid"]).abs()
    err = diff.max().item()
    share = (diff > 1e-6).float().mean().item()
    out.update({"dense_vs_hybrid_max_abs": err,
                "dense_vs_hybrid_share_beyond_1e-6": share})
    print(f"{name} on the card, 3 steps from one state (float32 moments, "
          f"table x{scale}): dense vs hybrid table max abs "
          f"{err:.3g}, share beyond 1e-6 {share:.3g} (tol "
          f"{DENSE_HYBRID_TOL}, {DENSE_HYBRID_SHARE}); sparse: "
          f"{out['sparse_untouched_rows']} untouched rows and their "
          f"moments bitwise unchanged, all {out['sparse_touched_rows']} "
          f"touched rows moved")
    check(err <= DENSE_HYBRID_TOL and share <= DENSE_HYBRID_SHARE,
          f"{name}: dense vs hybrid table max abs {err}, share beyond 1e-6 "
          f"{share}")
    return out


def zoo_fit(tag, data, update):
    """One Trainer.fit epoch of DeepFM at phase 16's settings (B=512,
    dropout 0.2, bf16 table moments) under the embedding update
    ``update``, its table drawn N(0, ZOO_FIT_INIT_STD**2).  -> summary
    dict (valid AUC, ms a step of the training epoch alone)."""
    from tpurec_torch.config import Config, ModelConfig, TrainConfig
    from tpurec_torch.train import Trainer

    cfg = Config(model=ModelConfig(model="deepfm", dropout=DROPOUT,
                                   embed_init_std=ZOO_FIT_INIT_STD),
                 train=TrainConfig(bs=512, epoch=1, seed=0,
                                   embedding_moments_dtype="bfloat16",
                                   embedding_update=update))
    tr = Trainer(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX)
    check((tr.scan_steps_idx is None) == (update != "hybrid"),
          f"deepfm {update} fit: the wrong epoch path")
    n_steps = -(-len(data.train[1]) // cfg.train.bs)
    epoch_s = []
    train_epoch = tr.train_epoch

    def timed_epoch(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = train_epoch(*a, **k)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        return r

    tr.train_epoch = timed_epoch
    t0 = time.perf_counter()
    res = tr.fit(data.train, data.valid,
                 domain_cnt_weight=data.domain_cnt_weight())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    valid = res["valid"]
    check(valid is not None and np.isfinite(valid["total_auc"]),
          f"deepfm {update} fit: no finite valid result")
    check(valid["total_auc"] >= ZOO_FIT_AUC_MIN, f"deepfm {update} fit: "
          f"valid total_auc {valid['total_auc']} < {ZOO_FIT_AUC_MIN}")
    step_ms = epoch_s[0] / n_steps * 1e3
    del tr
    torch.cuda.empty_cache()
    print(f"{tag} fit deepfm/{update}: 1 epoch of {n_steps} steps, "
          f"{step_ms:.3f} ms a step (host clock), valid total_auc "
          f"{valid['total_auc']:.5f}, mean_auc {valid['mean_auc']:.5f}")
    return {"valid_total_auc": valid["total_auc"],
            "valid_mean_auc": valid["mean_auc"],
            "valid_total_loss": valid["total_loss"],
            "train_loss": valid["train_loss"], "steps": n_steps,
            "step_ms": step_ms, "fit_seconds": fit_s}


def updates_main_path(dev, rng, tag):
    """Phase 20 (b): the "dense" and "sparse" embedding updates on DeepFM
    and the flagship MMoE: the K=8 loop at full width with each one's
    kernels counted (#1 once a step, #2 and #3 for MMoE, #6's pass never);
    3 steps of each against the CPU's plain path on the card's branches;
    from one state, the "dense" table against the "hybrid" one and
    "sparse"'s untouched rows; then one Trainer.fit epoch of DeepFM under
    each of the three updates.  -> summary dict."""
    from tpurec_torch.data import make_synthetic

    out = {}
    for name in UPDATE_MODELS:
        kw = zoo_kw(name)
        scale = ZOO_SCALE.get(name, 0.01)
        for update in ("dense", "sparse"):
            _, _, _, _, launches, timing = train_main_path(
                dev, rng, tag, name, kw, update, UPDATE_CALLS)
            torch.cuda.empty_cache()
            vs_cpu = train_vs_cpu(dev, rng, name, kw, scale, replay=True,
                                  update=update)
            out[f"{name}/{update}"] = {**timing, "launches": launches,
                                       "vs_cpu": vs_cpu}
        out[f"{name}/one state"] = three_updates_on_card(dev, rng, name,
                                                         kw, scale)
    t0 = time.perf_counter()
    data = make_synthetic(n_rows=FIT_ROWS, n_fields=len(FIELD_DIMS),
                          n_domain=N_DOMAIN, field_dims=FIELD_DIMS,
                          domain_idx=DOMAIN_IDX, seed=1)
    print(f"zoo fit data: make_synthetic({FIT_ROWS} rows) in "
          f"{time.perf_counter() - t0:.2f} s")
    out["fit"] = {f"deepfm/{u}": zoo_fit(tag, data, u)
                  for u in ("hybrid", "sparse", "dense")}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tpurec_torch.config import Config, ModelConfig
    from tpurec_torch.nn.core import EmbeddingLayout
    from tpurec_torch.nn.initializers import init_module
    from tpurec_torch.nn.interactions import FieldAttention
    from tpurec_torch.ops import _build
    from tpurec_torch.ops.attention import (field_attention,
                                            field_attention_reference)
    from tpurec_torch.ops.embedding import (embedding_gather,
                                            embedding_gather_reference)
    from tpurec_torch.serve import Predictor, quantize_table
    from tpurec_torch.server import make_server

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- 1. versions ---------------------------------------------------
    gpu = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    tag = f"[{gpu}]"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")
    print("nvcc: " + sh([_build.nvcc(), "--version"]).splitlines()[-1])
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not installed")
    print(f"cards: {torch.cuda.device_count()}; {gpu}")

    # -- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for b in built.values():
        print(f"  {b.name}: {b.seconds:.1f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                print("    ptxas " + line.split("ptxas info    :")[-1].strip())
    fwd_launch = attention_launch(dev)
    cross_launches = cross_launch(dev)

    # -- 3. kernels against their plain versions -----------------------
    torch.manual_seed(SEED)     # draws without a generator repeat too
    rng = np.random.default_rng(SEED)
    gen = torch.Generator().manual_seed(SEED)
    layout = EmbeddingLayout(FIELD_DIMS)
    F, D = len(FIELD_DIMS), MODEL["embed_dim"]
    table = torch.randn(layout.vocab, D, generator=gen)
    table[layout.n_rows:] = 0.0
    offsets, limits = layout.device_arrays(dev, layout.vocab)
    gather_err = 0.0
    tables = {}
    for dtype in ("float32", "bfloat16", "int8"):
        q, s = quantize_table(table, dtype)
        q, s = q.to(dev), None if s is None else s.to(dev)
        tables[dtype] = (q, s)
        g = layout.gather(q, s)                 # the prepared gather
        for B in (1, 512, 513, 4096, 4097):
            X = random_ids(rng, B)
            X[0, 1] = -1                     # wraps inside the small prefix
            X[-1, 9] = 10**8                 # past the table -> fill
            ids = torch.from_numpy(X).to(dev)
            got = g(ids)
            want = embedding_gather_reference(q, ids, offsets, limits, s)
            torch.cuda.synchronize()
            check(got.shape == (B, F, D), f"gather shape {tuple(got.shape)}")
            check(nan_equal(got, want), f"gather {dtype} B={B} differs")
            ok = ~torch.isnan(want)
            gather_err = max(gather_err,
                             (got[ok] - want[ok]).abs().max().item())
    print(f"gather (prepared, EmbeddingGather): bit-exact vs plain for "
          f"float32/bfloat16/int8 at B=1,512,513,4096,4097 (out-of-range "
          f"ids included)")

    A, H, L = MODEL["atten_embed_dim"], MODEL["att_head_num"], \
        MODEL["att_layer_num"]
    head = init_module(FieldAttention(D, A, L, H), gen).to(dev)
    flat = [w.detach() for w in head.flat_weights()]
    q32 = tables["float32"][0]
    attn_err = 0.0
    R4 = fwd_launch[BATCH_SIZES[-1]][0]
    attn_bs = sorted({1, max(1, R4 - 1), R4, R4 + 1, 512, 513, 4096, 4097})
    for B in attn_bs:
        emb = embedding_gather(q32, torch.from_numpy(random_ids(rng, B))
                               .to(dev), offsets, limits)
        got = field_attention(emb, flat, L, H)
        again = field_attention(emb, flat, L, H)
        want = field_attention_reference(emb, flat, L, H)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"attention B={B}: two calls differ")
        err = (got - want).abs().max().item()
        check(err <= ATTN_TOL, f"attention B={B}: max abs err {err}")
        attn_err = max(attn_err, err)
    # a NaN in one batch row stays in that row, not its block-mates'
    emb = embedding_gather(q32, torch.from_numpy(random_ids(rng, 512))
                           .to(dev), offsets, limits)
    bad = emb.clone()
    bad[5, 3, 0] = float("nan")
    y0, y1 = field_attention(emb, flat, L, H), field_attention(bad, flat, L, H)
    others = [r for r in range(512) if r != 5]
    check(bool(torch.isnan(y1[5]).any())
          and torch.equal(y0[others], y1[others]),
          "attention: a NaN row reached another batch row")
    print(f"attention: max abs err {attn_err:.3g} vs plain (tol {ATTN_TOL}) "
          f"at B={','.join(map(str, attn_bs))} ({R4} rows a block at "
          f"{BATCH_SIZES[-1]}); bitwise repeatable; a NaN in batch row 5 "
          f"stays in it")

    # -- 4. the main path: Predictor at full width ----------------------
    cfg = Config(model=ModelConfig(**MODEL))
    sd, n_params = serving_weights("mmoe", cfg.model, gen)
    d2g = np.arange(N_DOMAIN) % N_TOWER
    preds = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        preds[where] = Predictor(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                                 domain2group=d2g, batch_sizes=BATCH_SIZES,
                                 device=where).load_state_dict(sd)
        if where == "cuda":
            preds[where].warm()
        print(f"Predictor({where}): {n_params} params, loaded+warmed in "
              f"{time.perf_counter() - t0:.1f} s")
    pred = preds["cuda"]
    X = random_ids(rng, N_ROWS)

    embedding_gather.launches = 0
    field_attention.launches = 0
    p_gpu = pred(X)
    launches = {"embedding_gather": embedding_gather.launches,
                "field_attention": field_attention.launches}
    print(f"main path: {N_ROWS} rows scored, launches {launches}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel was not launched on the main path: {launches}")

    p_cpu = preds["cpu"](X)
    err = float(np.max(np.abs(p_gpu - p_cpu)))
    check(p_gpu.shape == (N_ROWS,) and np.all(np.isfinite(p_gpu))
          and np.all((p_gpu > 0) & (p_gpu < 1)), "predictions malformed")
    check(err <= PRED_TOL, f"Predictor cuda vs cpu: max abs err {err}")
    print(f"Predictor float32: cuda vs cpu plain path max abs err {err:.3g} "
          f"(tol {PRED_TOL}); mean prob {p_gpu.mean():.4f}")
    for dtype in ("bfloat16", "int8"):
        pq = {w: Predictor(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                           domain2group=d2g, batch_sizes=BATCH_SIZES,
                           table_dtype=dtype, device=w).load_state_dict(sd)
              for w in ("cuda", "cpu")}
        e = float(np.max(np.abs(pq["cuda"](X[:1000]) - pq["cpu"](X[:1000]))))
        check(e <= PRED_TOL, f"Predictor {dtype}: max abs err {e}")
        print(f"Predictor {dtype}: cuda vs cpu max abs err {e:.3g}")
        del pq
    del preds["cpu"]

    # -- 5. HTTP host ----------------------------------------------------
    import http.client

    srv = make_server(pred, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    http_p50 = None
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                          timeout=120)

        def post(rows):
            conn.request("POST", "/predict",
                         body=json.dumps({"instances": rows.tolist()}))
            r = conn.getresponse()
            body = r.read()
            check(r.status == 200, f"/predict {r.status}: {body[:200]!r}")
            return np.asarray(json.loads(body)["predictions"], np.float32)

        for n in (1, 37, N_ROWS):
            check(np.array_equal(post(X[:n]), pred(X[:n])),
                  f"HTTP predictions for {n} rows differ from direct ones")
        conn.request("GET", "/healthz")
        h = json.loads(conn.getresponse().read())
        check(h["status"] == "ok" and h["n_rows"] == 1 + 37 + N_ROWS,
              f"/healthz {h}")
        conn.request("GET", "/metrics")
        m = conn.getresponse().read().decode()
        check("tpurec_requests_total 3" in m, "/metrics counters")
        lat = []
        for i in range(60):
            t0 = time.perf_counter()
            post(X[i:i + 1])
            lat.append((time.perf_counter() - t0) * 1e3)
        http_p50 = float(np.median(lat[10:]))
        conn.close()
        print("HTTP: /predict 1/37/5000 rows == direct predictions; "
              "/healthz and /metrics ok")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)

    # -- 6. timings ------------------------------------------------------
    attn_bytes_w = sum(w.numel() * 4 for w in flat)
    rows = {"embedding_gather": {}, "field_attention": {}}
    for B in BATCH_SIZES:
        id_sets = [torch.from_numpy(random_ids(rng, B)).to(dev)
                   for _ in range(16)]
        glob = [(i.long() + offsets.long()).reshape(-1) for i in id_sets]
        it = iter(range(10**9))

        def pick(lst):
            return lst[next(it) % len(lst)]

        g32 = layout.gather(q32)             # as the Predictor holds it
        ms = cuda_ms(lambda: g32(pick(id_sets)))
        lib = cuda_ms(lambda: torch.index_select(q32, 0, pick(glob)))
        one_shot = cuda_ms(lambda: embedding_gather(q32, pick(id_sets),
                                                    offsets, limits))
        plain = cuda_ms(lambda: embedding_gather_reference(
            q32, pick(id_sets), offsets, limits))
        host_us = host_enqueue_us(lambda: g32(id_sets[0]))
        alone = kernel_alone_ms(lambda: g32(pick(id_sets)), "gather_kernel")
        lib_host_us = host_enqueue_us(
            lambda: torch.index_select(q32, 0, glob[0]))
        n_unique = torch.unique(glob[0]).numel()
        g_bytes = B * F * 4 + 2 * F * 4 + n_unique * D * 4 + B * F * D * 4
        rows["embedding_gather"][B] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, bytes=g_bytes,
            bound_ms=g_bytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
            one_shot_ms=one_shot, host_enqueue_us=host_us,
            device_alone_ms=alone,
            library_host_enqueue_us=lib_host_us,
            rows_per_block=GATHER_THREADS * GATHER_PIECES / (F * D / 4))
        print(f"{tag} embedding_gather B={B}: prepared {ms:.4f} ms, "
              f"index_select {lib:.4f} ms, one-shot {one_shot:.4f} ms (CUDA "
              f"events); host enqueue {host_us:.2f} us a call, index_select "
              f"{lib_host_us:.2f} us (perf_counter_ns over 1000 calls, no "
              f"synchronize); device "
              + ("not seen" if alone is None else f"{alone:.5f} ms")
              + " a launch back to back (torch.profiler, 50 launches)")

        embs = [embedding_gather(q32, i, offsets, limits) for i in id_sets[:4]]
        ms = cuda_ms(lambda: field_attention(pick(embs), flat, L, H))
        plain = cuda_ms(lambda: field_attention_reference(pick(embs), flat,
                                                          L, H))
        lib = cuda_ms(lambda: sdpa_stack(pick(embs), flat, L, H))
        lib_err = (sdpa_stack(embs[0], flat, L, H)
                   - field_attention_reference(embs[0], flat, L, H)
                   ).abs().max().item()
        flops = B * attn_flops_per_row(F, D, A, H, L)
        a_bytes = B * F * D * 4 + attn_bytes_w + B * F * A * 4
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, a_bytes / PEAK_BYTES_PER_S
        R, stage, smem = fwd_launch[B]
        by_r = rows_sweep(dev, embs[0], flat, L, H)
        rows["field_attention"][B] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, library_err=lib_err,
            flops=flops, bytes=a_bytes, bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            rows_per_block=R, weights_staged=stage, smem_bytes=smem,
            tc_bound_ms=tc_bound_ms(flops, a_bytes),
            ms_by_rows_per_block=by_r)
        print(f"{tag} field_attention B={B}: launched alone at R rows a "
              f"block (CUDA events, 20 launches): " + ", ".join(
                  f"R={r} {v:.4f} ms" for r, v in by_r.items()))
        for name in rows:
            r = rows[name][B]
            print(f"{tag} {name} B={B}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                  + (f", tensor-core bound {r['tc_bound_ms']:.4f} ms"
                     if "tc_bound_ms" in r else ""))
        print(f"{tag} attention library stack vs plain: max abs err "
              f"{lib_err:.3g}")

    _, chunk_dev, _ = chunk_timings(
        pred, rng, tag, {"embedding_gather": "gather_kernel",
                         "field_attention": "field_attention_kernel"})
    print(f"{tag} HTTP 1-row /predict p50: {http_p50:.3f} ms "
          f"(50 requests, keep-alive)")
    for name, by_b in chunk_dev.items():
        for B, ms in by_b.items():
            rows[name][B]["device_ms"] = ms

    # -- 7-10. training ----------------------------------------------------
    def emb_of(B):
        return embedding_gather(q32, torch.from_numpy(random_ids(rng, B))
                                .to(dev), offsets, limits)

    train_errs = train_kernel_checks(dev, rng, flat, table, emb_of)
    ts, single, batches, tgen, train_launches, train_timing = \
        train_main_path(dev, rng, tag)
    train_rows, train_profile = train_timings(
        dev, ts, single, batches, tgen, tag, train_timing["step_ms_host"])
    del ts, single, batches
    torch.cuda.empty_cache()
    cpu_match = train_vs_cpu(dev, rng)

    # -- 11-15. the DCN family and the layered attention --------------------
    errs11 = {**cross_kernel_checks(dev, emb_of),
              **layer_kernel_checks(dev, flat, emb_of)}
    dcn = dcn_serving(dev, rng, tag)
    ts, single, batches, tgen, dcn_launches, dcn_timing = train_main_path(
        dev, rng, tag, "dcn", DCN_MODEL)
    dcn_dev_us, dcn_profile = step_profile(
        dev, ts, single, batches, tgen, f"{tag} dcn",
        dcn_timing["step_ms_host"], ("cross_fwd_kernel", "cross_bwd_kernel"))
    dcn_step_dev = {}
    for name, sym in (("cross_network", "cross_fwd_kernel"),
                      ("cross_network_bwd", "cross_bwd_kernel")):
        dcn_step_dev[name] = path_device_ms(dcn_dev_us, (sym,), 1,
                                            f"{tag} dcn step")
    print(f"{tag} dcn step: #8 device {dcn_step_dev['cross_network']:.5f} "
          f"ms, #9 device {dcn_step_dev['cross_network_bwd']:.5f} ms (one "
          f"launch a step)")
    del ts, single, batches
    torch.cuda.empty_cache()
    dcn_cpu = train_vs_cpu(dev, rng, "dcn", DCN_MODEL)
    layered_launches, layered_errs, layered_ms, l_emb, l_flat = \
        layered_main_path(dev)
    new_rows = new_kernel_timings(dev, emb_of, l_emb, l_flat, tag)
    r = new_rows["cross_network_bwd"]
    print(f"{tag} cross_network_bwd in the DCN step: device "
          f"{dcn_step_dev['cross_network_bwd']:.5f} ms (one launch), floor "
          f"{r['floor_ms']:.5f} ms (an empty kernel launched as it is), "
          f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")

    # -- 16. the training harness ------------------------------------------
    fit_launches, fit_summary = harness_main_path(dev, tag)

    # -- 17. the CDC engine ---------------------------------------------------
    cdc_launches, cdc_summary = cdc_main_path(dev, tag)

    # -- 18. CDC's other base models ------------------------------------------
    t18 = time.perf_counter()
    bases = bases_main_path(dev, rng, tag)
    ple_launches, ple_cdc = cdc_main_path(dev, tag, base="ple", phase=18,
                                          profile=False)
    star_row = star_cdc_row(tag)
    bases_s = time.perf_counter() - t18
    print(f"bases phase: {bases_s:.1f} s")

    # -- 19. the group-routed models and bf16 compute ------------------------
    t19 = time.perf_counter()
    routed = routed_main_path(dev, rng, tag)
    bf16 = bf16_main_path(dev, rng, tag, fit_summary["valid"]["total_auc"])
    routed_s = time.perf_counter() - t19
    print(f"routed and bf16 phase: {routed_s:.1f} s")

    # -- 20. the rest of the zoo and the "dense"/"sparse" updates ------------
    t20 = time.perf_counter()
    zoo = zoo_main_path(dev, rng, tag)
    updates = updates_main_path(dev, rng, tag)
    zoo_s = time.perf_counter() - t20
    print(f"zoo and updates phase: {zoo_s:.1f} s")

    replaces = {
        "embedding_gather": "tpurec/ops/embedding_pallas.py:61",
        "field_attention": "tpurec/ops/attention_pallas.py:310",
        "field_attention_train": "tpurec/ops/attention_pallas.py:243",
        "field_attention_bwd": "tpurec/ops/attention_pallas.py:273",
        "fused_decay_adam": "tpurec/ops/fused_adam_pallas.py:246",
        "fused_sparse_adam": "tpurec/ops/fused_adam_pallas.py:131"}
    sources = {"field_attention_train": "field_attention",
               "field_attention_bwd": "field_attention",
               "fused_decay_adam": "fused_adam",
               "fused_sparse_adam": "fused_adam"}
    errs = {"embedding_gather": gather_err, "field_attention": attn_err,
            **train_errs}
    library = {"embedding_gather": "torch.index_select on global ids",
               "field_attention": "F.scaled_dot_product_attention + addmm "
                                  "stack"}
    kernels = []
    for name, by_b in rows.items():
        main = by_b[BATCH_SIZES[-1]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpurec_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "launches_train": (train_launches["embedding_gather"]
                               if name == "embedding_gather" else None),
            "max_abs_err": errs[name], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library": library[name], "batch": BATCH_SIZES[-1],
            **{k: main[k] for k in ("rows_per_block", "tc_bound_ms",
                                    "weights_staged", "host_enqueue_us",
                                    "one_shot_ms") if k in main},
            "by_batch": {str(b): {k: v for k, v in r.items()}
                         for b, r in by_b.items()},
        })
    for name, r in train_rows.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpurec_torch/csrc/{sources[name]}.cu",
            "replaces": replaces[name], "launches": train_launches[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": r["library"], "batch": 512,
            "device_ms": r.get("device_ms"),
            **{k: v for k, v in r.items() if k not in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library", "device_ms")}})
    new_meta = {
        "cross_network": dict(
            replaces="tpurec/ops/crossnet_pallas.py:133",
            source="cross_network", batch=BATCH_SIZES[-1],
            launches=dcn["launches"]["cross_network"],
            launches_train=dcn_launches["cross_network"],
            device_ms=dcn["device_ms"]["cross_network"][
                str(BATCH_SIZES[-1])],
            device_ms_by_batch=dcn["device_ms"]["cross_network"],
            device_ms_train=dcn_step_dev["cross_network"]),
        "cross_network_bwd": dict(
            replaces="tpurec/ops/crossnet_pallas.py:101",
            source="cross_network", batch=512,
            launches=dcn_launches["cross_network_bwd"],
            device_ms=dcn_step_dev["cross_network_bwd"]),
        "attention_layer": dict(
            replaces="tpurec/ops/attention_pallas.py:505",
            source="field_attention", batch=512,
            launches=layered_launches["attention_layer"]),
        "attention_layer_bwd": dict(
            replaces="tpurec/ops/attention_pallas.py:470",
            source="field_attention", batch=512,
            launches=layered_launches["attention_layer_bwd"])}
    for name, meta in new_meta.items():
        r = {**new_rows[name], **meta}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpurec_torch/csrc/{meta['source']}.cu",
            "replaces": meta["replaces"], "launches": meta["launches"],
            "max_abs_err": errs11[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: v for k, v in r.items() if k not in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "launches", "replaces", "source")}})
    print(json.dumps({"train": {**train_timing, "launches": train_launches,
                                "vs_cpu": cpu_match,
                                "profile": train_profile}}))
    print(json.dumps({"dcn": {"serving": dcn,
                              "train": {**dcn_timing,
                                        "launches": dcn_launches,
                                        "vs_cpu": dcn_cpu,
                                        "profile": dcn_profile}},
                      "layered": {"launches": layered_launches,
                                  "errors": layered_errs,
                                  "fwd_bwd_ms": layered_ms,
                                  "vs_stack": errs11["layered_vs_stack"]}}))
    for k in kernels:
        if k["name"] in fit_launches:
            k["launches_fit"] = fit_launches[k["name"]]
        if k["name"] in cdc_launches:
            k["launches_cdc"] = cdc_launches[k["name"]]
        by_base = {}
        for name, b in bases.items():
            n = {"serve": b["serve"]["launches"].get(k["name"]),
                 "train": b["train"]["launches"].get(k["name"])}
            if any(v is not None for v in n.values()):
                by_base[name] = n
        if by_base:
            k["launches_bases"] = by_base
        if k["name"] in ple_launches:
            k["launches_cdc_ple"] = ple_launches[k["name"]]
        by_model = {}
        for name, b in routed.items():
            n = {"serve": b["serve"]["launches"].get(k["name"]),
                 "train": b["train"]["launches"].get(k["name"])}
            if any(v is not None for v in n.values()):
                by_model[name] = n
        if by_model:
            k["launches_routed"] = by_model
        by_zoo = {}
        for name, b in zoo.items():
            n = {"serve": b["serve"]["launches"].get(k["name"]),
                 "train": b["train"]["launches"].get(k["name"])}
            if any(v is not None for v in n.values()):
                by_zoo[name] = n
        for key, r in updates.items():
            if "launches" in r and k["name"] in r["launches"]:
                by_zoo[key] = {"train": r["launches"][k["name"]]}
        if by_zoo:
            k["launches_zoo"] = by_zoo
    print(json.dumps({"harness": fit_summary}))
    print(json.dumps({"cdc": cdc_summary}))
    print(json.dumps({"bases": bases, "cdc_ple": ple_cdc,
                      "cdc_star_row": star_row, "phase_seconds": bases_s}))
    print(json.dumps({"routed": routed, "bf16": bf16,
                      "phase_seconds": routed_s}))
    print(json.dumps({"zoo": zoo, "updates": updates,
                      "phase_seconds": zoo_s}))
    print(json.dumps({"profiler_captures": CAPTURES}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)

"""Drive tpurec_torch's serving path and training step on one CUDA card,
and check them.

    python3 chip_smoke.py            # from the repository root, one card

Phases (any failure exits non-zero and prints no result line):

1. versions: torch, CUDA, nvcc, triton (if present), the card and its
   power limit;
2. build every kernel in tpurec_torch/csrc with nvcc (one process per
   source, in parallel) and print ptxas' register/shared-memory report;
3. hold each serving kernel against its plain PyTorch version on the card,
   at the flagship shapes and ragged batch sizes: the gather bit-exact for
   float32, bfloat16 and int8 tables (out-of-range ids included), the
   attention stack within 1e-4;
4. the serving path: a Predictor of the flagship MMoE (23 Ali-CCP-shaped
   fields, 1.63M-row table, 4 experts, 4 towers, attention head) with
   seeded random weights and BN statistics scores 5,000 rows; it must
   match the same model on the CPU's plain path within 1e-4, and both
   kernel launch counts must have risen during that run;
5. the HTTP host: /predict with 1, 37 and 5,000 rows equals the direct
   predictions; /healthz and /metrics answer;
6. serving timings: each kernel's wrapper (CUDA events over back-to-back
   calls) beside its plain version, a PyTorch library call computing the
   same function, and its bound; Predictor rows/s and the 1-row HTTP p50
   (host clock); a profile of one chunk at each batch size;
7. the training kernels against their plain versions: the attention
   forward with dropout 0.2 (same keep mask, read back through the
   output) and its backward against autograd at B = 1, 513, 512
   (bitwise repeatable), the table sweep at float32 and bfloat16 moments,
   the training step's table update (row step, sweep with the small-field
   gradient, write-back) with duplicate ids, and sentinel ids;
8. the training path: the flagship MMoE's hybrid training step at full
   width (B=512, dropout 0.2, bfloat16 table moments, L2 1e-5) as a K=8
   loop, 8 warm-up and 16 timed steps; all five training kernels must
   launch once per step and the loss must stay finite;
9. 3 full-width steps with dropout 0 on the card against the CPU's plain
   path: the loss and the table after step 1;
10. training timings: each training kernel beside its bound, its plain
    version and a library yardstick; the step's host-clock phases, peak
    memory and a profile (device busy share, launches per step, device
    time by kernel and by launching op, host time by op).

The line before the last is a JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.  TF32 is off throughout.
"""

from __future__ import annotations

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
MODEL = dict(model="mmoe", embed_dim=16, mmoe_expert_dims=(256, 128, 64),
             mmoe_tower_dims=(64, 32), use_atten=True, atten_embed_dim=64,
             att_layer_num=3, att_head_num=2)
BATCH_SIZES = (512, 4096)
N_ROWS = 5000
SEED = 0
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12          # H100 SXM float32, outside the tensor cores
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


def port_kernel(key: str, name: str) -> bool:
    """Whether a profiler kernel name is the port's kernel ``name`` (its
    kernels live in an anonymous namespace at the top level; PyTorch has
    kernels of the same short names inside its own namespaces)."""
    return key.removeprefix("void ").startswith(
        f"(anonymous namespace)::{name}")


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
    import torch.nn.functional as Fn

    B, F, _ = emb.shape
    w_emb, b_emb, w_res, b_res = flat[:4]
    A = w_emb.shape[1]
    x = torch.addmm(b_emb, emb.reshape(B * F, -1), w_emb)
    for l in range(L):
        w_in, b_in, w_out, b_out = flat[4 + 4 * l: 8 + 4 * l]
        qkv = torch.addmm(b_in, x, w_in).reshape(B, F, 3, H, A // H)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        o = Fn.scaled_dot_product_attention(q, k, v, dropout_p=dropout_p)
        x = torch.addmm(b_out, o.transpose(1, 2).reshape(B * F, A), w_out)
    res = torch.addmm(b_res, emb.reshape(B * F, -1), w_res)
    return torch.relu(x + res).reshape(B, F, A)


# -- training (phases 7-10) -------------------------------------------------

TRAIN_K = 8                     # steps per call of the K-step loop
TRAIN_WARMUP_CALLS, TRAIN_TIMED_CALLS = 1, 2    # 8 warm-up, 16 timed steps
L2 = 1e-5                       # bench.py:117,126
DROPOUT = 0.2
BWD_TOL = 1e-4          # demb abs; a weight gradient: 1e-4 x max(1, max|g|)
SWEEP_TOL = 1e-6        # p abs; moments rel + this x max|moment| (FMA)
BF16_MOMENT_TOL = 1e-2  # one bfloat16 ulp (2**-8) when FMA flips a rounding
SUMSQ_RTOL = 1e-5
ROWS_TOL = 2e-6
CPU_LOSS_RTOL = 1e-4
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


def train_kernel_checks(dev, rng, flat, table, emb_of):
    """Phase 7: the training kernels against their plain versions on the
    card.  -> max abs errors by kernel name."""
    from tpurec_torch.ops.attention import (field_attention_bwd,
                                            field_attention_fwd,
                                            field_attention_reference,
                                            keep_mask)
    from tpurec_torch.config import TrainConfig
    from tpurec_torch.ops.fused_adam import (adam_rows, fused_decay_adam,
                                             fused_decay_adam_reference,
                                             write_rows)
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
    for B in (1, 513, 512):
        emb = emb_of(B)
        saved_p = []
        want = field_attention_reference(emb, flat, L, H, DROPOUT, seed,
                                         saved=saved_p)
        y, saved = field_attention_fwd(emb, flat, L, H, DROPOUT, seed, True)
        torch.cuda.synchronize()
        e = max((y - want).abs().max().item(),
                (saved - torch.stack(saved_p)).abs().max().item())
        check(e <= ATTN_TOL, f"attention train fwd B={B}: max abs err {e}")
        err_f = max(err_f, e)
        # backward against autograd of the plain version, same seed
        leaves = [w.clone().requires_grad_(True) for w in flat]
        e_leaf = emb.clone().requires_grad_(True)
        dy = torch.randn(y.shape, device=dev)
        field_attention_reference(e_leaf, leaves, L, H, DROPOUT,
                                  seed).backward(dy)
        demb, grads = field_attention_bwd(emb, dy, saved, flat, L, H,
                                          DROPOUT, seed)
        demb2, grads2 = field_attention_bwd(emb, dy, saved, flat, L, H,
                                            DROPOUT, seed)
        torch.cuda.synchronize()
        check(torch.equal(demb, demb2) and all(
            torch.equal(a, b) for a, b in zip(grads, grads2)),
            f"attention bwd B={B}: two calls differ (the partial sums "
            f"should be deterministic)")
        e = (demb - e_leaf.grad).abs().max().item()
        check(e <= BWD_TOL, f"attention bwd B={B}: demb max abs err {e}")
        err_b = max(err_b, e)
        for i, (g, w) in enumerate(zip(grads, leaves)):
            e = (g - w.grad).abs().max().item()
            scale = max(1.0, w.grad.abs().max().item())
            check(e <= BWD_TOL * scale, f"attention bwd B={B}: weight {i} "
                  f"max abs err {e} (scale {scale:.3g})")
            err_b = max(err_b, e / scale)
    errs["field_attention_train"], errs["field_attention_bwd"] = err_f, err_b
    print(f"attention train fwd (dropout {DROPOUT}): max abs err {err_f:.3g} "
          f"vs plain (tol {ATTN_TOL}); bwd vs autograd of plain: max err "
          f"{err_b:.3g} (tol {BWD_TOL}, weight grads relative to "
          f"max(1, max|g|)) at B=1,513,512; bwd bitwise repeatable")

    layout = EmbeddingLayout(FIELD_DIMS)
    V, D = table.shape
    kw = dict(lr=1e-3, coef=2 * L2 + 1e-8)
    g_small = torch.randn(layout.small_rows, D, device=dev)
    err7 = 0.0
    for mdt in (torch.float32, torch.bfloat16):
        p = table.to(dev)
        m = (torch.randn(V, D, device=dev) * 0.01).to(mdt)
        v = (torch.rand(V, D, device=dev) * 1e-4).to(mdt)
        want = fused_decay_adam_reference(p.clone(), m.clone(), v.clone(),
                                          g_small, 5, **kw)
        got = fused_decay_adam(p, m, v, g_small, 5, **kw)
        torch.cuda.synchronize()
        e = (got[0] - want[0]).abs().max().item()
        check(e <= SWEEP_TOL, f"sweep {mdt}: p max abs err {e}")
        err7 = max(err7, e)
        rtol = check_moments(got, want, f"sweep {mdt}")
        r = abs(got[3].item() / want[3].item() - 1)
        check(r <= SUMSQ_RTOL, f"sweep {mdt}: sumsq rel err {r}")
        print(f"sweep {str(mdt)[6:]} moments: p max abs err {e:.3g} (tol "
              f"{SWEEP_TOL}), m/v within rel {rtol}, sumsq rel err {r:.3g} "
              f"(tol {SUMSQ_RTOL}) at {V} x {D}")
        del p, m, v, got, want
    errs["fused_decay_adam"] = err7

    # kernel 6 as the training step runs it: EmbeddingUpdater.update (the
    # row step, the sweep with the small-field gradient, the write-back)
    # at a batch's ids with duplicate big-field ids, against the CPU
    upd = EmbeddingUpdater(FIELD_DIMS, TrainConfig(
        bs=512, embedding_moments_dtype="bfloat16"), L2)
    X = random_ids(rng, 512)
    X[:256, 0] = X[256:, 0]
    x = torch.from_numpy(X)
    gr = torch.randn(512 * len(FIELD_DIMS), D)
    m0 = (torch.randn(V, D) * 0.01).to(torch.bfloat16)
    v0 = (torch.rand(V, D) * 1e-4).to(torch.bfloat16)
    res = {}
    for where in ("cuda", "cpu"):
        st = SparseEmbedState(m=m0.clone().to(where), v=v0.clone().to(where))
        p = table.clone().to(where)
        before = (adam_rows.launches, fused_decay_adam.launches,
                  write_rows.launches)
        sq = upd.update(p, st, x.to(where), gr.to(where), 5)
        if where == "cuda":
            torch.cuda.synchronize()
            after = (adam_rows.launches, fused_decay_adam.launches,
                     write_rows.launches)
            check([b - a for a, b in zip(before, after)] == [1, 1, 1],
                  f"table update: launches {before} -> {after}")
        res[where] = [p.cpu(), st.m.cpu(), st.v.cpu(), sq.cpu()]
        del p, st
    got, want = res["cuda"], res["cpu"]
    err6 = (got[0] - want[0]).abs().max().item()
    check(err6 <= ROWS_TOL, f"table update: table max abs err {err6}")
    check_moments(got, want, "table update")
    r6 = abs(got[3].item() / want[3].item() - 1)
    check(r6 <= SUMSQ_RTOL, f"table update: sumsq rel err {r6}")
    del res, got, want
    # sentinels (>= V) and negative ids are skipped
    t2 = table[:64].clone().to(dev)
    z = torch.zeros(64, D, device=dev, dtype=torch.bfloat16)
    ids2 = torch.tensor([4, 64, 70, -1], device=dev)
    rows = adam_rows(t2, z, z.clone(), ids2, torch.ones(4, D, device=dev), 1,
                     **kw)
    write_rows(t2, z, z.clone(), ids2, *rows)
    torch.cuda.synchronize()
    changed = (t2.cpu() != table[:64]).any(1).nonzero().flatten().tolist()
    check(changed == [4], f"sparse rows: sentinel ids wrote rows {changed}")
    errs["sparse_adam_rows"] = err6
    print(f"table update as the training step runs it (1,024 big-field ids "
          f"with duplicates, small-field gradient, bf16 moments): table max "
          f"abs err {err6:.3g} vs the CPU plain path (tol {ROWS_TOL}), m/v "
          f"within rel {BF16_MOMENT_TOL}, sumsq rel err {r6:.3g}; sentinel "
          f"ids write nothing")
    return errs


def train_main_path(dev, rng, tag):
    """Phase 8: the flagship training step at full width, driven as
    bench.py drives the JAX one.  -> (state, single-step fn, batches,
    generator, launches, timings)."""
    from tpurec_torch.config import ModelConfig, TrainConfig
    from tpurec_torch.models import build_model
    from tpurec_torch.ops.attention import field_attention, \
        field_attention_bwd
    from tpurec_torch.ops.embedding import embedding_gather
    from tpurec_torch.ops.fused_adam import (adam_rows, fused_decay_adam,
                                             write_rows)
    from tpurec_torch.train.hybrid import (init_train_state,
                                           make_hybrid_train_step)
    from tpurec_torch.train.reg import reg_coef_tree

    tcfg = TrainConfig(bs=512, embedding_moments_dtype="bfloat16")
    t0 = time.perf_counter()
    model = build_model("mmoe", FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                        ModelConfig(**MODEL, dropout=DROPOUT),
                        generator=torch.Generator().manual_seed(SEED + 1))
    ts = init_train_state(model, tcfg)
    check(next(model.parameters()).device.type == "cuda",
          "the model was not built on the card")
    reg = reg_coef_tree([n for n, _ in model.named_parameters()], "mmoe",
                        L2, L2, L2)
    scan = make_hybrid_train_step(model, tcfg, reg, True, L2, scan_k=TRAIN_K)
    single = make_hybrid_train_step(model, tcfg, reg, True, L2)
    batches = train_batches(rng, TRAIN_K, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    torch.cuda.synchronize()
    print(f"train state: {sum(p.numel() for p in model.parameters())} "
          f"params on {dev}, bf16 table moments, built in "
          f"{time.perf_counter() - t0:.1f} s")

    counters = {"embedding_gather": embedding_gather,
                "field_attention_train": field_attention,
                "field_attention_bwd": field_attention_bwd,
                "fused_decay_adam": fused_decay_adam,
                "sparse_adam_rows": adam_rows, "sparse_write_rows": write_rows}
    for fn in counters.values():
        fn.launches = 0
    losses = []
    for _ in range(TRAIN_WARMUP_CALLS):
        losses.append(scan(ts, batches, gen))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TRAIN_TIMED_CALLS):
        losses.append(scan(ts, batches, gen))
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    n_steps = (TRAIN_WARMUP_CALLS + TRAIN_TIMED_CALLS) * TRAIN_K
    print(f"train main path: {n_steps} steps, launches {launches}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel was not launched on the training path: {launches}")
    check(all(n == n_steps for n in launches.values()),
          f"a kernel did not launch once per step: {launches}")
    loss = torch.cat(losses).cpu()
    check(bool(torch.isfinite(loss).all()), f"non-finite loss: {loss}")
    timed = TRAIN_TIMED_CALLS * TRAIN_K
    step_ms = host_s / timed * 1e3
    event_ms = start.elapsed_time(end) / timed
    timing = {"step_ms_host": step_ms, "step_ms_events": event_ms,
              "examples_per_s_host": 512 / (step_ms / 1e3),
              "examples_per_s_events": 512 / (event_ms / 1e3),
              "loss_first": float(loss[0]), "loss_last": float(loss[-1])}
    print(f"{tag} train step (B=512, K={TRAIN_K}, {timed} timed steps): "
          f"{step_ms:.3f} ms host clock = {timing['examples_per_s_host']:.0f}"
          f" examples/s; {event_ms:.3f} ms by CUDA events = "
          f"{timing['examples_per_s_events']:.0f} examples/s; loss "
          f"{float(loss[0]):.4f} -> {float(loss[-1]):.4f}")
    return ts, single, batches, gen, launches, timing


def train_vs_cpu(dev, rng):
    """Phase 9: 3 full-width steps with dropout 0 on the card and on the
    CPU's plain path, from the same seeded weights and batches.  The table
    is scaled to N(0, 0.01**2), so that the reported loss's L2 term
    (l2 * sum(table**2), 260 at the N(0, 1) init) does not hide the data
    loss."""
    from tpurec_torch.config import ModelConfig, TrainConfig
    from tpurec_torch.models import build_model
    from tpurec_torch.train.hybrid import (init_train_state,
                                           make_hybrid_train_step)
    from tpurec_torch.train.reg import reg_coef_tree

    tcfg = TrainConfig(bs=512, embedding_moments_dtype="bfloat16")
    batches = train_batches(rng, 3, "cpu")
    out = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = build_model("mmoe", FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                            ModelConfig(**MODEL, dropout=0.0), device=where,
                            generator=torch.Generator().manual_seed(SEED + 3))
        with torch.no_grad():
            model.embedding.table.mul_(0.01)
        ts = init_train_state(model, tcfg, device=where)
        reg = reg_coef_tree([n for n, _ in model.named_parameters()],
                            "mmoe", L2, L2, L2)
        step = make_hybrid_train_step(model, tcfg, reg, True, L2)
        losses, table1 = [], None
        for i in range(3):
            losses.append(float(step(ts, {k: v[i] for k, v in
                                          batches.items()}, None)))
            if i == 0:
                table1 = model.embedding.table.detach().cpu().clone()
        out[where] = (losses, table1)
        print(f"3 steps on {where}: losses {losses} "
              f"({time.perf_counter() - t0:.1f} s)")
        del model, ts
    (lg, tg), (lc, tc) = out["cuda"], out["cpu"]
    rel = max(abs(a / b - 1) for a, b in zip(lg, lc))
    check(rel <= CPU_LOSS_RTOL, f"train cuda vs cpu: loss rel err {rel}")
    diff = (tg - tc).abs()
    share = (diff > 1e-6).float().mean().item()
    check(diff.max().item() <= 2 * tcfg.lr + 1e-6 and
          share <= CPU_TABLE_SHARE,
          f"train cuda vs cpu: table after step 1 max abs err "
          f"{diff.max().item()}, share beyond 1e-6 {share}")
    print(f"train cuda vs cpu plain path, 3 full-width steps (dropout 0): "
          f"loss max rel err {rel:.3g} (tol {CPU_LOSS_RTOL}); table after "
          f"step 1 max abs err {diff.max().item():.3g} (tol 2 lr: Adam's "
          f"first step is +-lr whatever a gradient's size), share beyond "
          f"1e-6 {share:.3g} (tol {CPU_TABLE_SHARE})")
    return {"loss_rel_err": rel, "table_max_abs_err": diff.max().item(),
            "table_share_beyond_1e-6": share}


def train_timings(dev, ts, single, batches, gen, tag, step_ms):
    """Phase 10: each training kernel's time beside its bound, its plain
    version and a library yardstick, at the main path's shapes; then a
    profile of single steps."""
    from tpurec_torch.ops.attention import (field_attention_bwd,
                                            field_attention_bwd_reference,
                                            field_attention_fwd,
                                            field_attention_reference)
    from tpurec_torch.ops.fused_adam import (adam_rows, adam_rows_reference,
                                             dedup_sorted, fused_decay_adam,
                                             fused_decay_adam_reference,
                                             write_rows, write_rows_reference)

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
    rows["field_attention_train"] = dict(
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
        bound_by="operations" if t_ops >= t_b else "bytes")
    del y_lib, leaves, e_leaf

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

    g_rows = torch.randn(512 * F, D, device=dev).reshape(512, F, D)

    def combine():
        return dedup_sorted(*upd.big_rows(x, g_rows), V)[:2]

    id_u, g_u = combine()
    n_u = int((id_u < V).sum())
    p = table.clone()
    m = torch.zeros(V, D, device=dev, dtype=torch.bfloat16)
    v = torch.zeros_like(m)

    def rows_kernel():
        write_rows(p, m, v, id_u, *adam_rows(p, m, v, id_u, g_u, 5, **kw))

    def rows_plain():
        write_rows_reference(p, m, v, id_u, *adam_rows_reference(
            p, m, v, id_u, g_u, 5, **kw))

    N = id_u.shape[0]
    nbytes = N * 8 + N * D * 4 + n_u * D * (4 + 2 + 2) * 2
    rows["sparse_adam_rows"] = dict(
        ms=cuda_ms(rows_kernel), plain_ms=cuda_ms(rows_plain),
        library_ms=None,
        library="none: torch.optim.SparseAdam steps a set of rows but has "
                "no coef * p_old (L2 / weight decay) term and keeps float32 "
                "moments, so it computes another function",
        bytes=nbytes, bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
        bound_by="bytes", n_ids=N, n_unique=n_u,
        combine_ms=cuda_ms(combine))
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
    from torch.profiler import ProfilerActivity, profile

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

    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(n_prof):
            single(ts, b0, gen)
        torch.cuda.synchronize()
    evs = prof.key_averages()
    # which host op launched the device time (by op and input shapes)
    op_top = sorted(((f"{e.key} {e.input_shapes}",
                      e.self_device_time_total / n_prof)
                     for e in prof.key_averages(group_by_input_shape=True)
                     if not str(e.device_type).endswith("CUDA")
                     and not getattr(e, "is_user_annotation", False)
                     and e.self_device_time_total > 0),
                    key=lambda kv: -kv[1])[:8]
    # kernels only: a user annotation's device time is the span of the
    # kernels under it, gaps included
    dev_us = {e.key: e.self_device_time_total / n_prof for e in evs
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)}
    launches = sum(e.count for e in evs if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx")) / n_prof
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
    for name, syms in (
            ("field_attention_train", ("field_attention_kernel",)),
            ("field_attention_bwd", ("field_attention_bwd_kernel",
                                     "reduce_partials_kernel")),
            ("fused_decay_adam", ("decay_adam_kernel",
                                  "finish_sumsq_kernel")),
            ("sparse_adam_rows", ("adam_rows_kernel", "write_rows_kernel"))):
        us = [v for k, v in dev_us.items()
              if any(port_kernel(k, s) for s in syms)]
        rows[name]["device_ms"] = sum(us) / 1e3 if us else None
    gather_us = [v for k, v in dev_us.items()
                 if port_kernel(k, "gather_kernel")]
    profile_summary = {"busy_us": busy, "step_us": step_ms * 1e3,
                       "busy_share": busy / (step_ms * 1e3),
                       "launches_per_step": launches,
                       "phase_ms": phase_ms, "peak_memory_gb": peak_gb,
                       "gather_device_ms": sum(gather_us) / 1e3
                       if gather_us else None,
                       "top": [[n[:90], us] for n, us in top],
                       "op_top": [[n[:160], us] for n, us in op_top],
                       "host_top": [[n[:90], us] for n, us in host_top]}
    return rows, profile_summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tpurec_torch.config import Config, ModelConfig
    from tpurec_torch.models import build_model
    from tpurec_torch.nn.core import BatchNorm, EmbeddingLayout
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
            if "registers" in line or "Compiling entry" in line:
                print("    ptxas " + line.split("ptxas info    :")[-1].strip())

    # -- 3. kernels against their plain versions -----------------------
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
        for B in (1, 512, 513, 4096, 4097):
            X = random_ids(rng, B)
            X[0, 1] = -1                     # wraps inside the small prefix
            X[-1, 9] = 10**8                 # past the table -> fill
            ids = torch.from_numpy(X).to(dev)
            got = embedding_gather(q, ids, offsets, limits, s)
            want = embedding_gather_reference(q, ids, offsets, limits, s)
            torch.cuda.synchronize()
            check(got.shape == (B, F, D), f"gather shape {tuple(got.shape)}")
            check(nan_equal(got, want), f"gather {dtype} B={B} differs")
            ok = ~torch.isnan(want)
            gather_err = max(gather_err,
                             (got[ok] - want[ok]).abs().max().item())
    print(f"gather: bit-exact vs plain for float32/bfloat16/int8 at "
          f"B=1,512,513,4096,4097 (out-of-range ids included)")

    A, H, L = MODEL["atten_embed_dim"], MODEL["att_head_num"], \
        MODEL["att_layer_num"]
    head = init_module(FieldAttention(D, A, L, H), gen).to(dev)
    flat = [w.detach() for w in head.flat_weights()]
    q32 = tables["float32"][0]
    attn_err = 0.0
    for B in (1, 512, 513, 4096, 4097):
        emb = embedding_gather(q32, torch.from_numpy(random_ids(rng, B))
                               .to(dev), offsets, limits)
        got = field_attention(emb, flat, L, H)
        want = field_attention_reference(emb, flat, L, H)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= ATTN_TOL, f"attention B={B}: max abs err {err}")
        attn_err = max(attn_err, err)
    print(f"attention: max abs err {attn_err:.3g} vs plain (tol {ATTN_TOL}) "
          f"at B=1,512,513,4096,4097")

    # -- 4. the main path: Predictor at full width ----------------------
    cfg = Config(model=ModelConfig(**MODEL))
    model = build_model("mmoe", FIELD_DIMS, N_TOWER, DOMAIN_IDX, cfg.model,
                        device="cpu", generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.mean.normal_(0.0, 0.3, generator=gen)
                m.var.uniform_(0.5, 1.5, generator=gen)
                m.scale.uniform_(0.8, 1.2, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
    sd = model.state_dict()
    n_params = sum(v.numel() for k, v in sd.items()
                   if "mean" not in k and "var" not in k
                   and "num_batches" not in k)
    del model
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

        ms = cuda_ms(lambda: embedding_gather(q32, pick(id_sets), offsets,
                                              limits))
        plain = cuda_ms(lambda: embedding_gather_reference(
            q32, pick(id_sets), offsets, limits))
        lib = cuda_ms(lambda: torch.index_select(q32, 0, pick(glob)))
        n_unique = torch.unique(glob[0]).numel()
        g_bytes = B * F * 4 + 2 * F * 4 + n_unique * D * 4 + B * F * D * 4
        rows["embedding_gather"][B] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, bytes=g_bytes,
            bound_ms=g_bytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes")

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
        rows["field_attention"][B] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, library_err=lib_err,
            flops=flops, bytes=a_bytes, bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes")
        for name in rows:
            r = rows[name][B]
            print(f"{tag} {name} B={B}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        print(f"{tag} attention library stack vs plain: max abs err "
              f"{lib_err:.3g}")

    chunk_s = {}
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
        print(f"{tag} Predictor B={B}: {B / med:.0f} rows/s "
              f"(median {med * 1e3:.3f} ms per call, host clock, "
              f"incl. copies)")
    print(f"{tag} HTTP 1-row /predict p50: {http_p50:.3f} ms "
          f"(50 requests, keep-alive)")

    # where a chunk's time goes: device time by kernel (profiler) against
    # the chunk's unprofiled host-clock time above
    from torch.profiler import ProfilerActivity, profile

    for B in BATCH_SIZES:
        Xb = random_ids(rng, B)
        pred(Xb)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                pred(Xb)
        dev_us = {e.key: e.self_device_time_total / 10
                  for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")
                  and e.self_device_time_total > 0}
        busy, wall = sum(dev_us.values()), chunk_s[B] * 1e6
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        print(f"{tag} profile B={B}: device busy {busy:.1f} us per chunk, "
              f"{100 * busy / wall:.1f}% of its {wall:.1f} us; "
              f"{len(dev_us)} kernel kinds"
              + "".join(f"\n    {us:9.1f} us  {name[:90]}"
                        for name, us in top))
        # one launch of each port kernel per chunk: its device time (None
        # when the profiler saw no device activity)
        for name, sym in (("embedding_gather", "gather_kernel"),
                          ("field_attention", "field_attention_kernel")):
            us = [v for k, v in dev_us.items() if port_kernel(k, sym)]
            rows[name][B]["device_ms"] = sum(us) / 1e3 if us else None

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

    replaces = {
        "embedding_gather": "tpurec/ops/embedding_pallas.py:61",
        "field_attention": "tpurec/ops/attention_pallas.py:310",
        "field_attention_train": "tpurec/ops/attention_pallas.py:243",
        "field_attention_bwd": "tpurec/ops/attention_pallas.py:273",
        "fused_decay_adam": "tpurec/ops/fused_adam_pallas.py:246",
        "sparse_adam_rows": "tpurec/ops/fused_adam_pallas.py:131"}
    sources = {"field_attention_train": "field_attention",
               "field_attention_bwd": "field_attention",
               "fused_decay_adam": "fused_adam",
               "sparse_adam_rows": "fused_adam"}
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
    print(json.dumps({"train": {**train_timing, "launches": train_launches,
                                "vs_cpu": cpu_match,
                                "profile": train_profile}}))
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

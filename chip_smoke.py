"""Drive tpurec_torch's serving path, training step (under each embedding
update), training harness, CDC engine and CLI on one CUDA card, for each
model it ports, in float32 and in bf16 compute, and check them.

    python3 chip_smoke.py            # from the repository root, one card
    python3 chip_smoke.py --phase 22 --draws 3   # the mesh alone
    python3 chip_smoke.py --phase 25 --rows 52000000   # CDC, split streamed
    python3 chip_smoke.py --phase 26 [--rows 4000000]  # CDC's mesh cadence
    python3 chip_smoke.py --phase 27 [--rows 52000000] # harness over budget
    python3 chip_smoke.py --phase 28 [--parent DIR]    # serving under load
    python3 chip_smoke.py --phase 29 [--rows 4000000]  # four cards, NCCL

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
   (out-of-range ids included), and with a row window (each half of the
   table, a (., 2) mesh's shards) bit-exact against its plain version
   with the window; the attention stack within 1e-4 at B = 1,
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
    forward per eval batch); valid AUC at least 0.65 (phase 27 (a) holds
    the host-batching epoch against this one); streaming against exact
    eval; Predictor.load_from_trainer against predict (1e-5); a
    checkpoint served by predictor_from_checkpoint and loaded by a fresh
    Trainer, both bitwise equal to predict; the small drive recipe (MMoE,
    embed 8, 2 epochs) above AUC 0.7; epoch, eval and checkpoint times and
    a profile of 16 indexed steps;
17. the CDC engine at full width: make_synthetic(131,072 rows) at the
    flagship schema with 4 antipodal domain clusters ->
    CDCTrainer(...).fit(train, valid, test) on the flagship MMoE as CDC's
    base (4 clusters, the reference's CDC defaults but 4 mask rows (not
    50), B=512, 2 epochs, dropout 0.2, bf16 table moments): the warmup
    (400 steps), one matrix update (4 mask rows at W = 3,584, the
    baseline and 50 A rows at 512, 54 B rows, 109 probe evals of 25,600
    rows, the clustering) and the
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
    CDCTrainer.fit on PLE at CDCConfig()'s defaults (4 clusters) but 4
    causal-mask rows (phase 25 (b) runs the 50 at scale), with
    phase 17's checks but the treatment profile; (c) STAR as CDC's base
    (called without the group): one populate row at W = 3,584 with its
    25,600-row eval against the CPU; (d) PEPNet-single and EPNet-single,
    which CDC takes as no base: (c)'s burst and eval through their own
    hybrid step, against the CPU on the card's branches.
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
    at phase 16's settings, valid AUC at least 0.65 and ms a step; the
    flagship MMoE's "sparse" 8 steps from one state again with
    LazyAdamRows' "sort" dedup: each table update replayed from
    "scatter"'s entry under both (table within 2 lr, at most 1e-6 of it
    beyond 1e-6, moments as phase 7's), untouched rows bitwise, ms a step
    of each.
21. the CLI (``tpurec_torch.cli.main``, in-process, the kernel counters
    read around each run; every argv with --mesh_data -1 and a seed):
    (a) MMoE at ModelConfig's widths, 2 epochs of 131,072 synthetic rows:
    finite valid and test AUC, valid at least 0.65, a domain_auc key a
    domain, train_loss records in the JSONL log, the checkpoint, #1, #2,
    #3 and #6's pass once a step (and #1, #2 a forward per eval batch)
    against the trainer's schedule, ms a step; (b) CDC on PEPNet, EPNet
    and STAR (32,768 rows, one matrix update each): the clustering, a
    finite valid AUC, the checkpoint served by predictor_from_checkpoint
    on the card against the CPU within 1e-4; (c) --resume from (a)'s
    checkpoint (1 epoch), --domain_filter '[0,2,4]' --hash_buckets
    '{0: 16}' on DeepFM (only the kept domains in domain_auc), bf16
    compute on MMoE (its valid AUC beside (a)'s first epoch's); (d)
    ``python3 -m tpurec_torch.cli`` as a subprocess (rc 0, the result as
    its last line), its checkpoint through ``python3 -m
    tpurec_torch.serve`` on the card against the CPU within 1e-4, and a
    ``utils.profiling.trace`` of 8 of (a)'s steps naming #1, #2 and #3
    with a StepTimer summary; (e) a preprocessed Ali-CCP CSV of 131,072
    rows at the flagship's 23 fields (written with numpy, read by the
    CLI with pandas) trained for an epoch with (a)'s checks.
22. the (data, model) mesh (``tpurec_torch.parallel``): (a) a world of
    one over NCCL, ``make_mesh(1, 1)``: 3 flagship steps (dropout 0.2) of
    the mesh Trainer bit for bit the mesh-less Trainer's; (b) 4 ranks on
    the card over gloo (this script with ``--mesh-rank``), mesh (2, 2),
    global B=512, dropout 0, bf16 moments: 3 hybrid steps against the
    one-device card step (loss rtol 2e-5; the table gathered to rank 0
    within 2e-5 of the one-device update replayed on the mesh's row
    gradients, and of the one-device run at wd 1e-3; at the default wd
    the parting by step printed: row gradients, the dense values after
    step 1, each table value beyond 2e-5), each rank's #1,
    #2, #3 and #6/7's pass once a step; (c) one
    Trainer.fit epoch on (2, 2) at phase 16's settings: the valid AUC
    within 0.01 of phase 16's, ms a step and the collectives' share, the
    async backend's save beside the pickle's, its checkpoint restored
    onto one device evaluating within 1e-6; (d) ``python -m
    torch.distributed.run --nproc_per_node 2 -m tpurec_torch.cli`` at 21
    (a)'s configuration for one epoch: exit 0, one result line, its valid
    AUC within 0.01 of 21 (a)'s first epoch's (with ``--phase 22`` only,
    which runs 21 (a) first).  Every rank's exit code is checked.
23. CDC on the mesh and expert parallelism: (a) 4 ranks on (2, 2) over
    gloo, the flagship MMoE's 4 experts split 2 a rank, 3 hybrid steps
    against one device (losses rtol 2e-5; at wd 1e-3 the gathered
    experts and table within 2e-5; at the default wd the parting
    printed); (b) CDCTrainer.fit on (2, 2) with the experts split,
    against the one-device fit from the mesh's state at each populate
    block's entry (the matrices within 5e-5 and the same clustering
    unless it ties within 5e-5), also with its rows in another order
    (the parting of a summation order), the loss parting by step and the
    AUCs printed (``--phase 23`` adds the whole one-device fits),
    the async checkpoint restored onto one device within 1e-6; the same
    fit with ``data_placement="stream"`` bitwise the resident one on
    every rank (every step's loss, the matrices, the clustering, the
    gathered table and experts), its ``_feed`` share and each rank's
    peak memory printed;
    (c) the CLI's CDC on PLE on 2 ranks with ``--mesh_expert_parallel``.
24. CDC's row lanes (``cdc.parallel_rows``): (a)
    ``EmbeddingUpdater.update_stacked`` at the flagship table, 4 lanes
    at steps (3, 7, 11, 1), bf16 and float32 moments, duplicate ids, row
    ids in the small-field prefix and ids outside the table, against 4
    plain-version updates on the CPU (phase 7's limits), bitwise
    repeatable, a lane left out keeping its block; (b) phase 17's
    configuration through its warmup, then one lane row against the
    CPU's plain path and, on the card, against the serial row 0 (1e-6,
    bitwise expected).  ``--phase 24`` alone also runs (b)'s
    update_matrix_cdc in 4 lanes, then serially, from one state before
    that row (each update's seconds and peak memory, the trainer's state
    bitwise unchanged by the lanes, #1, #2, #3 and #6/7's pass against
    the schedule).  (c) phase 23 (b)'s configuration on (2, 2) over gloo
    with the experts split and the split streamed (this script with
    ``--lanes-rank``): one lane update against one device's lanes from
    the mesh's state (matrices within 5e-5, the clustering unless it
    ties), #1, #2, #3 and #6/7's pass against the schedule a rank.
25. CDC as its users run it, on CDCConfig()'s default base PLE: (a)
    phase 23 (b)'s data (32,768 rows, 6 domains) through five
    CDCTrainer.fit runs from one state at CDCConfig()'s defaults but 4
    mask rows, warmup_step 10 and update_interval 10 (an update before
    steps 0, 19 and 39): "resident" and "stream", each serially and in 4
    row lanes, and "stream" in lanes in bf16; "stream" bitwise
    "resident" (every loss, each update's matrices and clustering, the
    final state), #1, #2, #3 and #6/7's pass against the schedule update
    by update, at updates 2 and 3 a serial mask row and a lane B row
    against the CPU's plain path on the card's branches, bf16 finite;
    each update's seconds, its host window's seconds and peak memory.
    (b) ``--phase 25 [--rows N]`` alone: 52,000,000 synthetic rows at
    the flagship schema, a 4.49 GB train split that "auto" must
    stream; the warmup, the update before step 0, steps 0-1998, the
    update before step 1999 serially and in 4 lanes from one state, then
    in turns 1,024 steps with the split moved onto the card and 1,024 with
    it back in host memory: seconds, the host
    window's share, host and device peak memory, launches against the
    schedule, the valid AUC, one populate row against the CPU.
    ``--phase 23`` also runs phase 23 (b)'s witness: (b)'s fit on (2, 1)
    (the data split alone), (1, 2) with the experts whole (the table's
    row shards alone) and (2, 2), 4 row orders each (this script with
    ``--witness-rank``), against one device from the mesh's state at
    each block's entry in the same row order and in another, and on the
    meshes with a data split against one device making its batch sums
    in the data ranks' row blocks (``mesh_split_sums``), with and
    without its products and normalisation in those blocks too: each
    block's parting as min / median / max over the draws.
26. ``--phase 26`` alone, CDC's cadence on the mesh: (b) 4 ranks on (2,
    2) over gloo with the experts split (this script with
    ``--cadence-rank``), phase 25 (a)'s configuration at dropout 0 and wd
    1e-3, four fits from one state ("resident" and "stream", serially and
    in 4 lanes), each with 4 matrix updates: "stream" bitwise "resident",
    lane row 0 bitwise the serial row 0 at each update, #1, #2, #3 and
    #6/7's pass against the schedule update by update on every rank,
    every rank holding rank 0's clustering; update 1 against one device
    from the mesh's state at each block's entry (5e-5); each update's
    seconds, ``_feed`` and collectives' shares, peak memory a rank.  (c)
    ``--phase 26 --rows N``: N synthetic rows at the flagship schema,
    CDCConfig() on PLE: "auto" must stream on every rank, the warmup and
    the first update (the epoch after it cut), one clustering on every
    rank, two mask rows (row 0 and the fewest steps') against one
    device from the mesh's state at each row's start, beside one device
    in two other row orders (5e-5, or twice one device's own parting
    where that is larger), and row 0's first two step losses within 1e-6
    of one device's, which a planted fault (the last data rank's rows
    left out of step 1) must exceed; each rank's data and set-up seconds,
    the update's seconds, ``_feed`` and collectives' shares, host and
    device peak memory, the valid AUC.
27. the training harness as its users run it: (a) phase 16's data and
    settings with TrainConfig's own epoch 10 and early_stop 2, two fits
    from one state at once, resident and (this script with
    ``--fit-over``) with every split over the instance's
    DEVICE_RESIDENT_BYTES (the host-batching epoch, predict's batch
    path): a stop before epoch 10 at an earlier best epoch, every step
    loss, each epoch's valid result, the stop and best epoch, the
    restored state (the best epoch's snapshot) and the test result
    bitwise across the two, evaluate(valid) after the fit the stopper's
    best result, launches against the schedule; on the restored state
    the streaming eval through 4 windows (the tail padded) within 1e-6 of
    the resident one and STREAM_TOL of the exact one; each placement's
    epoch seconds, the snapshots' and the restore's seconds and bytes.
    (b) ``--phase 27 [--rows N]`` alone: phase 25 (b)'s 52,000,000 rows,
    a 4.49 GB train split the Trainer's "auto" must batch on the host:
    the epoch cut by a raising log_fn after 4,096 steps (the prefetch
    worker ended, the batch stream let go, host RSS), the same cut epoch
    with the split on the card bitwise (losses and state), the valid AUC,
    1,024 steps of each placement twice in turns (examples/s), a 16-step
    profile of each, and the exact and streaming evals of the 46.8M-row
    split (seconds, rows/s, the window copies, streaming within
    STREAM_TOL of exact), host and device peak memory.
28. serving as its users run it: (a) the checkpoints of phases 16 (the
    flagship MMoE's fit) and 18 (b) (CDC on PLE, served at n_tower =
    n_cluster and routed by its domain2group), each served by ``python -m
    tpurec_torch.server --port 0 --bs 4096 --table_dtype bfloat16`` in a
    process of its own (through SERVE_WRAPPER, which prints #1 and #2's
    launches and the device peak when SIGINT ends the host); a card
    Predictor of the checkpoint in this process takes a 10,000-row
    predict_async (3 chunks) under set_sync_debug_mode("error") (its host
    time beside its chunks' device time) and three requests fetched out
    of order, bitwise; 4 client threads on a keep-alive connection each
    send 25 1-row and 25 512-row requests interleaved and one of 10,000
    rows: every reply bitwise that Predictor's, 1,000 rows within 1e-4 of
    the CPU's plain path, /healthz and /metrics the requests and rows
    sent, #1 and #2's launches the chunks sent plus warm()'s, rc 0 within
    10 s of SIGINT; p50 and p99 by request size.  (b) ``--phase 28
    [--parent DIR]`` alone: phase 16's fit, its checkpoint served at --bs
    4096 (float32, bfloat16, int8 tables; 1-, 512- and 4,096-row
    requests) and --bs 512 (1 and 512 rows) to 1, 4 and 16 keep-alive
    clients (``scripts/serve_load.py``): p50, p99, requests/s, rows/s
    and the host's device busy share (a profiler window inside the host)
    a cell; with ``--parent`` (the parent commit's tree, unpacked) the
    corners (1 and 16 clients x 1 and 4,096 rows) on its host and on
    this tree's in turns; a soak of 16 clients on a new connection every
    request for 120 s, every reply bitwise, the host's RSS, threads and
    memory_reserved at the start, after 10 s and at the end (no growth
    after 10 s).
29. ``--phase 29 [--rows N] [--parts abcd]`` alone, on a host of four
    cards (it fails on fewer: no gloo, shared-card or CPU fallback): the
    mesh a rank a card over NCCL, each rank joined with a 300 s group
    timeout, a failed rank's peers ended 30 s after it.  (a) 4 ranks
    (this script with ``--group-rank``) NCCL on cuda:0-3, four card
    UUIDs, every collective of ``parallel.collectives`` (the autograd
    rules too), ``check_replicas`` and ``data_totals`` exact on known
    inputs, ``collectives.all_gather`` (an all-reduce of n slots)
    bitwise ``all_gather_into_tensor`` and both timed at the exchange's
    and the expert banks' shapes, and in each rank's profiles every
    record on its own card with #1, #2, #3 and #6/7's pass among them;
    (b) phase 22 (b)/(c) on
    (2, 2) and on (4, 1); (c) phase 23 (a)/(b) on (2, 2), the experts
    split; (d) ``python -m torch.distributed.run --nproc_per_node 4 -m
    tpurec_torch.cli``, MMoE (resolving to (4, 1)) and CDC on PLE with
    ``--mesh_model 2 --mesh_expert_parallel``: exit 0, no rank's exit
    fault, every rank NCCL on its own card, each checkpoint's streaming
    eval on one device within 1e-6 of the mesh's; (e) (a)'s ranks time
    the flagship at 512 rows a data rank on one card (no mesh, every card
    at once), on (4, 1) and on (2, 2), 3 rounds in turns of 64 steps:
    ms a step, examples/s, each rank's device busy, NCCL's kernels'
    device share and the bytes reduced a step; with ``--rows N`` phase
    26 (c) on the cards, a mask row of its update profiled on each rank.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.  TF32 is off throughout.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import shutil
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


def gather_window_checks(dev, layout, tables):
    """Phase 3: kernel 1 with a row window, each half of the flagship table
    (a (., 2) mesh's shards; the rows outside it zero), bit-exact against
    its plain version with the window, at every table dtype.  Its ids come
    from a generator of its own, so the later phases' draws stay as they
    were."""
    from tpurec_torch.ops.embedding import embedding_gather_reference

    rng = np.random.default_rng(SEED + 3)

    F, D = len(FIELD_DIMS), MODEL["embed_dim"]
    V = layout.vocab
    half = -(-V // 2)
    offsets, limits = layout.device_arrays(dev, V)
    for dtype, (q, s) in tables.items():
        qp = torch.cat([q, torch.zeros((2 * half - V, D), dtype=q.dtype,
                                       device=dev)])
        sp_ = None if s is None else torch.cat(
            [s, torch.zeros(2 * half - V, device=dev)])
        for m in range(2):
            qs = qp[m * half:(m + 1) * half].contiguous()
            ss = None if sp_ is None else \
                sp_[m * half:(m + 1) * half].contiguous()
            g = layout.gather(qs, ss, window=(m * half, V))
            for B in (512, 4096):
                X = random_ids(rng, B)
                X[0, 1] = -1
                X[-1, 9] = 10**8
                ids = torch.from_numpy(X).to(dev)
                got = g(ids)
                want = embedding_gather_reference(qs, ids, offsets, limits,
                                                  ss, m * half, V)
                torch.cuda.synchronize()
                check(got.shape == (B, F, D) and nan_equal(got, want),
                      f"windowed gather {dtype} shard {m} B={B} differs")
    print("gather with a row window (each half of the table, the rows "
          "outside it zero): bit-exact vs plain for float32/bfloat16/int8 "
          "at B=512,4096")


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
    input (the last ReLU's branch is read from the forward's output, and
    the other layers' outputs are the saved inputs of the next), the
    residual's backward, and per layer the out- and in-projection backward
    (weight gradient and input gradient) and the four [F, F] x [F, hd]
    products per head; then the embedding projection's backward."""
    hd = A // H
    recompute = L * (2 * F * A * 3 * A + 4 * H * F * F * hd)
    per_layer = (2 * 2 * F * A * A + 4 * 2 * H * F * F * hd
                 + 2 * 2 * F * A * 3 * A)
    res_part = 2 * 2 * F * D * A if res else 0   # dW, dx
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
    ReLU's mask: the kernel's forward and the plain version's may fall on
    either side, each gradient right for its own forward, and one such
    element moves its batch row's demb by about |dy|.  -> (dy, share of
    elements zeroed)."""
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


def attention_train_checks(dev, flat, emb_of, bs, L, H, seed, what=""):
    """Kernel 2 in training mode and kernel 3 against the plain version
    (its forward, and autograd through it) at the batch sizes ``bs``,
    dropout 0 and DROPOUT, and B=513 without the residual: the forward
    and its saved layer inputs within ATTN_TOL, demb within BWD_TOL and
    each weight gradient within BWD_TOL of max(1, max|g|), the backward
    bitwise repeatable; dy zeroed where the pre-ReLU value is within
    RELU_MARGIN of 0 (:func:`away_from_relu_kink`).  ``emb_of(B)``: the
    embeddings of B rows.  -> (forward max abs err, backward max err)."""
    from tpurec_torch.ops.attention import (field_attention_bwd,
                                            field_attention_fwd,
                                            field_attention_reference)

    err_f = err_b = 0.0
    no_res = flat[:2] + [None, None] + flat[4:]
    cases = [(B, rate, flat) for rate in (0.0, DROPOUT) for B in bs]
    cases.append((513, DROPOUT, no_res))
    zeroed = 0.0
    for B, rate, fl in cases:
        case = (f"B={B} dropout {rate}"
                + ("" if fl[2] is not None else " no residual") + what)
        emb = emb_of(B)
        saved_p = []
        want = field_attention_reference(emb, fl, L, H, rate, seed,
                                         saved=saved_p)
        y, saved = field_attention_fwd(emb, fl, L, H, rate, seed, True)
        torch.cuda.synchronize()
        e = max((y - want).abs().max().item(),
                (saved - torch.stack(saved_p)).abs().max().item())
        check(e <= ATTN_TOL, f"attention train fwd {case}: max abs err {e}")
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
        demb, grads = field_attention_bwd(emb, dy, saved, y, fl, L, H,
                                          rate, seed)
        demb2, grads2 = field_attention_bwd(emb, dy, saved, y, fl, L, H,
                                            rate, seed)
        torch.cuda.synchronize()
        check(torch.equal(demb, demb2) and all(
            a is None or torch.equal(a, b) for a, b in zip(grads, grads2)),
            f"attention bwd {case}: two calls differ (the partial sums "
            f"should be deterministic)")
        e = (demb - e_leaf.grad).abs().max().item()
        check(e <= BWD_TOL, f"attention bwd {case}: demb max abs err {e}")
        err_b = max(err_b, e)
        for i, (g, w) in enumerate(zip(grads, leaves)):
            if w is None:
                check(g is None, f"attention bwd {case}: gradient {i} of a "
                      f"missing weight")
                continue
            e = (g - w.grad).abs().max().item()
            scale = max(1.0, w.grad.abs().max().item())
            check(e <= BWD_TOL * scale, f"attention bwd {case}: weight {i} "
                  f"max abs err {e} (scale {scale:.3g})")
            err_b = max(err_b, e / scale)
    print(f"attention train fwd (dropout 0 and {DROPOUT}): max abs err "
          f"{err_f:.3g} vs plain (tol {ATTN_TOL}); bwd vs autograd of plain: "
          f"max err {err_b:.3g} (tol {BWD_TOL}, weight grads relative to "
          f"max(1, max|g|)) at B={','.join(map(str, bs))}, dropout 0 and "
          f"{DROPOUT}, and B=513 without the residual; bwd bitwise "
          f"repeatable; dy zeroed where |pre-ReLU| < {RELU_MARGIN} (at most "
          f"{zeroed:.2e} of the elements)" + what)
    return err_f, err_b


def attention_bound(B, F, D, A, H, L, w_bytes, part):
    """The least time of #2 in eval ("eval") or in training ("train"), or
    of #3 ("bwd"), on B rows: its operations at the float32 peak and its
    bytes (each input read once, each output written once) at the memory
    rate, the larger; the 3xTF32 bound beside.  -> dict."""
    if part == "bwd":
        flops = B * attn_bwd_flops_per_row(F, D, A, H, L)
        nbytes = B * F * (2 * D + 2 * A + L * A) * 4 + 2 * w_bytes
    else:
        flops = B * attn_flops_per_row(F, D, A, H, L)
        saved = L * A if part == "train" else 0
        nbytes = B * F * (D + A + saved) * 4 + w_bytes
    t_ops, t_b = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return dict(bound_ms=max(t_ops, t_b) * 1e3, flops=flops, bytes=nbytes,
                tc_bound_ms=tc_bound_ms(flops, nbytes),
                bound_by="operations" if t_ops >= t_b else "bytes")


def attention_timing_rows(embs, flat, L, H, seed,
                          parts=("eval", "train", "bwd"), alone=False):
    """#2 in eval and in training and #3 (``parts``) on the rows of
    ``embs`` ([B, F, D] batches, which the timed calls take in turn):
    each kernel's ms (CUDA events) beside its plain version's, the
    library's SDPA stack's (dropout DROPOUT in training) and its bound
    (:func:`attention_bound`), and its rows a block; with ``alone``, its
    device ms launched alone (torch.profiler, 20 launches).  -> {kernel
    name: row}."""
    from tpurec_torch.ops.attention import (_sm_count, bwd_config,
                                            field_attention,
                                            field_attention_bwd,
                                            field_attention_bwd_reference,
                                            field_attention_fwd,
                                            field_attention_reference,
                                            fwd_config)

    e = embs[0]
    B, F, D = e.shape
    n_sm = _sm_count(e.device)
    w_bytes = sum(w.numel() * 4 for w in flat)
    turn = iter(range(10**9))

    def pick():
        return embs[next(turn) % len(embs)]

    y, saved = field_attention_fwd(e, flat, L, H, DROPOUT, seed, True)
    A = y.shape[-1]
    R, stage, _ = fwd_config(B, F, D, A, H, n_sm)
    rows = {}
    if "eval" in parts:
        rows["field_attention"] = dict(
            ms=cuda_ms(lambda: field_attention(pick(), flat, L, H)),
            plain_ms=cuda_ms(lambda: field_attention_reference(
                pick(), flat, L, H)),
            library_ms=cuda_ms(lambda: sdpa_stack(pick(), flat, L, H)),
            library="F.scaled_dot_product_attention + addmm stack",
            rows_per_block=R, weights_staged=stage,
            **attention_bound(B, F, D, A, H, L, w_bytes, "eval"))
        if alone:
            rows["field_attention"]["device_ms"] = kernel_alone_ms(
                lambda: field_attention(e, flat, L, H),
                "field_attention_kernel", n=20)
    if "train" in parts:
        rows["field_attention_train"] = dict(
            ms=cuda_ms(lambda: field_attention_fwd(pick(), flat, L, H,
                                                   DROPOUT, seed, True)),
            plain_ms=cuda_ms(lambda: field_attention_reference(
                pick(), flat, L, H, DROPOUT, seed)),
            library_ms=cuda_ms(lambda: sdpa_stack(pick(), flat, L, H,
                                                  DROPOUT)),
            library=f"F.scaled_dot_product_attention(dropout_p={DROPOUT}) "
                    "+ addmm stack",
            rows_per_block=R, weights_staged=stage,
            **attention_bound(B, F, D, A, H, L, w_bytes, "train"))
        if alone:
            rows["field_attention_train"]["device_ms"] = kernel_alone_ms(
                lambda: field_attention_fwd(e, flat, L, H, DROPOUT, seed,
                                            True),
                "field_attention_kernel", n=20)
    if "bwd" in parts:
        dy = torch.randn(y.shape, device=e.device)
        leaves = [w.clone().requires_grad_(True) for w in flat]
        e_leaf = e.clone().requires_grad_(True)
        y_lib = sdpa_stack(e_leaf, leaves, L, H, DROPOUT)

        def bwd():
            return field_attention_bwd(e, dy, saved, y, flat, L, H,
                                       DROPOUT, seed)

        rows["field_attention_bwd"] = dict(
            ms=cuda_ms(bwd),
            plain_ms=cuda_ms(lambda: field_attention_bwd_reference(
                e, dy, saved, y, flat, L, H, DROPOUT, seed), iters=10),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                y_lib, [e_leaf] + leaves, dy, retain_graph=True)),
            library="torch.autograd.grad through the SDPA + addmm stack "
                    f"(dropout_p={DROPOUT})",
            rows_per_block=bwd_config(B, F, D, A, H, n_sm)[0],
            **attention_bound(B, F, D, A, H, L, w_bytes, "bwd"))
        if alone:
            rows["field_attention_bwd"]["device_ms"] = kernel_alone_ms(
                bwd, "field_attention_bwd_kernel", "reduce_partials_kernel",
                n=20)
    return rows


def table_pass_timing(p, m, v, ids, g_ids, g_small, plain=False,
                      iters=50):
    """The table pass (#7's sweep of ``p``, ``m``, ``v`` carrying #6's
    rows ``ids``, its sort and searchsorted included): its ms (CUDA
    events), its device ms launched alone (torch.profiler, 20 launches)
    and its bound (bytes: the table and both moments read and written,
    the small fields' gradient, each id, its sorted copy and its row's
    gradient, the tiles' sums written and read); with ``plain``, its
    plain version's ms.  -> (row, the pass as a function of the ids)."""
    from tpurec_torch.ops.fused_adam import (TILE, fused_sparse_adam,
                                             fused_sparse_adam_reference)

    kw = dict(lr=1e-3, coef=2 * L2 + 1e-8)

    def fused(i=ids):
        return fused_sparse_adam(p, m, v, i, g_ids, 5, g_small=g_small,
                                 **kw)

    (V, D), S, N = p.shape, g_small.shape[0], ids.shape[0]
    nbytes = (V * D * (4 + 2 * m.element_size()) * 2 + S * D * 4
              + N * (8 + 8 + D * 4) + 2 * -(-V * D // TILE) * 4)
    row = dict(ms=cuda_ms(fused, iters=iters),
               device_ms=kernel_alone_ms(fused, *SWEEP_SYMS, n=20),
               library_ms=None, bytes=nbytes,
               bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
               n_ids=N)
    if plain:
        row["plain_ms"] = cuda_ms(lambda: fused_sparse_adam_reference(
            p, m, v, ids, g_ids, 5, g_small=g_small, **kw), iters=10,
            warmup=2)
    return row, fused


def table_update_vs_cpu(dims, table, X, mdt, what):
    """Kernel 6 as the training step runs it: EmbeddingUpdater.update of
    ``table`` (one sweep carrying the rows of the batch ``X``'s big-field
    ids, with the small fields' gradient) from seeded gradients and ``mdt``
    moments, on the card and on the CPU's plain path: one launch of the
    pass and its sum's finish, no other port kernel, the result held to
    the CPU's (:func:`held_to_plain`).  -> (table max abs err, its largest
    share of the limit's scale, sumsq rel err, the moments m, v it started
    from)."""
    from tpurec_torch.config import TrainConfig
    from tpurec_torch.ops.fused_adam import (fused_decay_adam,
                                             fused_sparse_adam)
    from tpurec_torch.train.hybrid import EmbeddingUpdater
    from tpurec_torch.train.sparse import SparseEmbedState

    V, D = table.shape
    B = len(X)
    upd = EmbeddingUpdater(dims, TrainConfig(
        bs=B, embedding_moments_dtype=str(mdt).removeprefix("torch.")), L2)
    x = torch.from_numpy(X)
    gen6 = torch.Generator().manual_seed(SEED + 6)
    gr = torch.randn(B * len(dims), D, generator=gen6)
    m0 = (torch.randn(V, D, generator=gen6) * 0.01).to(mdt)
    v0 = (torch.rand(V, D, generator=gen6) * 1e-4).to(mdt)
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
                  f"{what}: launches (rows, sweep) {before} -> {after}")
        res[where] = [p.cpu(), st.m.cpu(), st.v.cpu(), sq.cpu()]
        if where == "cuda":
            kernels = update_port_kernels(
                lambda: upd.update(p, st, x.to(where), gr.to(where), 5), p)
        del p, st
    check(kernels == dict.fromkeys(SWEEP_SYMS, 1),
          f"{what}: port kernels launched {kernels}, want the sweep "
          f"carrying the rows and its sum's finish once each")
    got, want = res["cuda"], res["cpu"]
    tc = upd.tcfg
    step = sweep_step(table, m0, v0, upd.small_field_grads(
        x, gr.reshape(B, len(dims), D)), 5, lr=tc.lr,
        coef=upd.coef, b1=tc.adam_b1, b2=tc.adam_b2, eps=tc.adam_eps)
    return (*held_to_plain(got, want, step, what), m0, v0)


def train_kernel_checks(dev, rng, flat, table, emb_of):
    """Phase 7: the training kernels against their plain versions on the
    card.  -> max abs errors by kernel name."""
    from tpurec_torch.ops.attention import keep_mask
    from tpurec_torch.ops.fused_adam import (fused_decay_adam,
                                             fused_decay_adam_reference,
                                             fused_sparse_adam,
                                             fused_sparse_adam_reference)
    from tpurec_torch.nn.core import EmbeddingLayout

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

    bs = bwd_batches(dev)
    err_f, err_b = attention_train_checks(dev, flat, emb_of, bs, L, H, seed)
    errs["field_attention_train"], errs["field_attention_bwd"] = err_f, err_b

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
    X = random_ids(rng, 512)
    X[:256, 0] = X[256:, 0]
    err6, worst6, r6, m0, v0 = table_update_vs_cpu(
        FIELD_DIMS, table, X, torch.bfloat16, "table update")
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
        card = capture_records(prof)[0]
        ran = device_kernels(card)
        out = {}
        for key, (count, _) in card.items():
            for name in names:
                if port_kernel(key, name):
                    out[name] = out.get(name, 0) + count
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


def schedule_launches(steps, forwards):
    """The launches a hybrid training path makes: #1 and #2 a step and a
    forward (an eval, a probe eval), #3 and #6/7's pass a step."""
    return {"embedding_gather": forwards, "field_attention_train": forwards,
            "field_attention_bwd": steps, "fused_decay_adam": steps,
            "fused_sparse_adam": steps}


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
    with a 0-dim second operand: ``|pi| <= epsilon``), and the attention
    stack's own ReLU, which the card runs inside kernels #2/#3: its
    branch is read from the stack's output (y > 0) as the card returns
    it, and replayed on the CPU's plain version's ``torch.relu`` (counted
    apart, as "attention"; a replay on the card only counts it).  Calls of
    other shapes compute as usual.  A value within
    rounding of a branch's edge may take either side on two devices, and
    a gradient (or, at a routing or a pruner edge, a logit) then parts by
    that unit's whole contribution; replaying the card's branches on the
    CPU leaves rounding alone between the two."""

    def __init__(self, masks, record):
        self.masks, self.record = masks, record
        self.used = self.flipped = self.inputs = 0
        self.flips = {"relu": 0, "argmax": 0, "where": 0, "attention": 0}

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
        return n

    def __call__(self, x):
        if self.record:
            self.masks.append(("relu", (x > 0).cpu()))
            return self.relu(x)
        mask = self._next("relu", x.shape)
        if mask is None:
            return self.relu(x)
        mask = mask.to(x.device)
        n = self._count("relu", x > 0, mask)
        if self.masks[self.used - 1][2:] == ("attention",):
            self.flips["attention"] += n
        return x * mask

    def field_attention(self, *args, **kwargs):
        y = self._field_attention(*args, **kwargs)
        if not y.is_cuda:
            return y            # the plain version's torch.relu replays
        if self.record:
            self.masks.append(("relu", (y > 0).cpu(), "attention"))
        elif self.used < len(self.masks) \
                and self.masks[self.used][2:] == ("attention",):
            # a replay on the card: the kernel takes its own branch
            rec = self.masks[self.used][1].to(y.device)
            self.used += 1
            self.flips["attention"] += self._count("relu", y > 0, rec)
        return y

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
        from tpurec_torch.nn import interactions

        self.relu, torch.relu = torch.relu, self
        self._argmax, torch.argmax = torch.argmax, self.argmax
        self._where, torch.where = torch.where, self.where
        self._field_attention = interactions.field_attention
        interactions.field_attention = self.field_attention
        return self

    def __exit__(self, *exc):
        from tpurec_torch.nn import interactions

        torch.relu = self.relu
        torch.argmax = self._argmax
        torch.where = self._where
        interactions.field_attention = self._field_attention


def row_grad_vs_cpu(name, model_kw, table_scale, tcfg, batch,
                    rtol=ROW_GRAD_RTOL, update="hybrid"):
    """Step 1's gradient of the gathered rows (``loss_and_grads``'s,
    before Adam and before wd reaches anything) on the card against the
    CPU's plain path, from train_vs_cpu's seeded weights and first batch,
    the CPU on the card's branches (:class:`relu_branches`); held to
    ``rtol`` (ROW_GRAD_RTOL) of its largest value.  One branch is held:
    the card's, replayed.  Kernel #3 takes the attention stack's last ReLU
    from kernel #2's output, so the card's backward follows the branches
    its forward took, and so does the CPU's replay.  A wrong table
    gradient that Adam's sign amplification or PLE's wd would hide shows
    here.  Under the "dense" update the whole table's gradient is held
    instead: the rows' gradients through the lookup's backward
    (``index_add_``, by atomics on the card, in index order on the CPU)
    plus the table's L2.  -> summary dict."""
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


def vs_cpu_config(wd=TRAIN_WD, compute_dtype="float32"):
    """The TrainConfig of :func:`train_vs_cpu`'s steps."""
    from tpurec_torch.config import TrainConfig

    return TrainConfig(bs=512, embedding_moments_dtype="bfloat16", wd=wd,
                       compute_dtype=compute_dtype)


def three_steps(where, name, model_kw, table_scale, tcfg, batches,
                update="hybrid", branches=None):
    """3 steps of model ``name`` with dropout 0 on ``where`` from the
    seeded weights, the table scaled by ``table_scale``, over ``batches``,
    inside ``branches`` (a :class:`relu_branches`) when given.  -> (the
    losses, the losses before the table's L2 (``loss_and_grads``'), the
    table after step 1, the cluster centres after step 3 or None)."""
    from tpurec_torch.config import ModelConfig
    from tpurec_torch.models import build_model

    model = build_model(name, FIELD_DIMS, towers(name), DOMAIN_IDX,
                        ModelConfig(**model_kw, **NO_DROPOUT), device=where,
                        generator=torch.Generator().manual_seed(SEED + 3))
    with torch.no_grad():
        model.embedding.table.mul_(table_scale)
    ts = train_state(model, tcfg, where, update)
    step = train_step_of(model, tcfg, name, update)
    losses, data_losses, table1 = [], [], None
    loss_and_grads = step.loss_and_grads

    def record(*args):
        out = loss_and_grads(*args)
        data_losses.append(float(out[0] if isinstance(out, tuple) else out))
        return out

    step.loss_and_grads = record
    if branches is not None:
        branches.__enter__()
    try:
        for i in range(3):
            losses.append(float(step(ts, {k: v[i] for k, v in
                                          batches.items()}, None)))
            if i == 0:
                table1 = model.embedding.table.detach().cpu().clone()
    finally:
        if branches is not None:
            branches.__exit__(None, None, None)
    centres = (model.cluster_centers.detach().cpu().clone()
               if hasattr(model, "cluster_centers") else None)
    return losses, data_losses, table1, centres


def train_vs_cpu(dev, rng, name="mmoe", model_kw=MODEL, table_scale=0.01,
                 wd=TRAIN_WD, compute_dtype="float32", replay=False,
                 loss_rtol=CPU_LOSS_RTOL, grad_rtol=ROW_GRAD_RTOL,
                 table_share=CPU_TABLE_SHARE, update="hybrid"):
    """Phase 9 (phase 13 for DCN, 18 for CDC's other bases): 3 full-width
    steps of model ``name`` with dropout 0 on the card and on the CPU's
    plain path, from the same seeded weights and batches
    (:func:`three_steps`).  The table is
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
    :func:`row_grad_vs_cpu`.  ``replay`` (phases 18 and 19) runs the 3
    steps on the card's branches too (:class:`relu_branches`: a ReLU
    input within rounding of 0 parts the losses and the table, the routed
    models' argmax and pruner edges the losses themselves;
    ``scripts/row_grad_flips.py --phase18`` prints what it removes) and
    holds ADL's centres after them to CENTRE_TOL; ``compute_dtype`` runs
    the steps in that precision, held to ``loss_rtol``, ``grad_rtol`` and
    ``table_share``.  ``update`` (phase 20) steps the table under that
    embedding update: the loss held is then the one its step returns (the
    whole loss under "dense", the loss before the table's L2 under
    "sparse"), and the "dense" one's row gradient is the table's
    (:func:`row_grad_vs_cpu`).  -> summary dict."""
    tcfg = vs_cpu_config(wd, compute_dtype)
    batches = train_batches(rng, 3, "cpu")
    out, masks, branches = {}, [], None
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        if replay:
            branches = relu_branches(masks, record=where == "cuda")
        out[where] = three_steps(where, name, model_kw, table_scale, tcfg,
                                 batches, update, branches)
        print(f"{name}: 3 steps on {where}: losses {out[where][0]} "
              f"({time.perf_counter() - t0:.1f} s)")
    (lg, dg, tg, cg), (lc, dc, tc, cc) = out["cuda"], out["cpu"]
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
    if cg is not None:
        centre_err = (cg - cc).abs().max().item()
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


def step_profile(dev, ts, single, batches, gen, tag, step_ms, syms=(),
                 by_op=True):
    """Where a training step's time goes: host-clock phases (each ended by
    a synchronize), peak memory, and a profile of single steps (device busy
    share, launches per step, device time by kernel; with ``by_op``, by
    launching op and host time by op, which need torch.profiler's event
    tree, seconds a capture: phases 18-20 leave them out).  ``syms``: the
    model's own port kernels, each launched once a step, beside the
    gather and #6's pass.  -> (device us by kernel name, summary)."""
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
        ("gather_kernel",) + SWEEP_SYMS + tuple(syms), record_shapes=by_op)
    op_top, host_top = [], []
    if by_op:
        evs = prof.key_averages()
        # which host op launched the device time (by op and input shapes)
        op_top = sorted(((f"{e.key} {e.input_shapes}",
                          e.self_device_time_total / n_prof)
                         for e in prof.key_averages(group_by_input_shape=True)
                         if not str(e.device_type).endswith("CUDA")
                         and not getattr(e, "is_user_annotation", False)
                         and e.self_device_time_total > 0),
                        key=lambda kv: -kv[1])[:8]
        host_top = sorted(((e.key, e.self_cpu_time_total / n_prof)
                           for e in evs
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
          + ("\n  device time by the host op that launched it:"
             + "".join(f"\n    {us:9.1f} us  {name[:160]}"
                       for name, us in op_top)
             + "\n  host, self CPU time per step (profiled):"
             + "".join(f"\n    {us:9.1f} us  {name[:90]}"
                       for name, us in host_top) if by_op else ""))
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
    recorded = device_kernels(capture_records(prof)[0]) / n
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
                                            field_attention_fwd,
                                            keep_threshold)
    from tpurec_torch.ops.fused_adam import (fused_decay_adam,
                                             fused_decay_adam_reference)

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
    seed = torch.tensor(12345, device=dev)
    rows = attention_timing_rows([emb], flat, L, H, seed, ("train", "bwd"))
    y_k, saved = field_attention_fwd(emb, flat, L, H, DROPOUT, seed, True)
    dy = torch.randn(512, F, A, device=dev)
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
            emb.data_ptr(), dy.data_ptr(), saved.data_ptr(),
            y_k.data_ptr(), ptrs, 512, r,
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
    r, fused = table_pass_timing(p, m, v, ids, g_ids, g_small, plain=True)
    r.update(
        pass_alone_ms=r.pop("device_ms"),
        library="none: torch.optim.SparseAdam steps only the touched rows, "
                "with no coef * p (L2 / weight decay) term and float32 "
                "moments, so it computes another function",
        all_equal_alone_ms=kernel_alone_ms(lambda: fused(same), *SWEEP_SYMS,
                                           n=20),
        sweep_alone_ms=kernel_alone_ms(lambda: fused_decay_adam(
            p, m, v, g_small, 5, **kw), *SWEEP_SYMS, n=20))
    rows["fused_sparse_adam"] = r
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
    # 3 takes kernel 2's branch, the layered path torch.relu's of its own
    # forward)
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


def capture_records(prof):
    """A capture's records summed by name from its raw events -> (card:
    {name: [count, device us]}, host: {name: count}), user annotations
    left out.  These are ``prof.key_averages()``'s names, counts and
    device times (``scripts/profile_capture_cost.py`` holds them equal on
    the card), without the event tree that key_averages builds, which
    takes most of a capture's seconds."""
    from torch.autograd import DeviceType

    card, host, names = {}, {}, {}
    for e in prof.profiler.kineto_results.events():
        raw = e.name()
        name = names.get(raw)
        if name is None:
            name = names[raw] = (torch._C._demangle(raw) if len(raw) > 1
                                 else raw)
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            r = card.setdefault(name, [0, 0.0])
            r[0] += 1
            r[1] += e.duration_ns() / 1e3
        else:
            host[name] = host.get(name, 0) + 1
    return card, host


def device_kernels(card):
    """Kernel records in a capture's card records, the markers' left out
    (copies and memsets are not kernels)."""
    return sum(c for name, (c, _) in card.items()
               if not name.startswith(("Memcpy", "Memset"))
               and not is_marker(name))


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
        card, host = capture_records(prof)
        evs = {k: r for k, r in card.items()
               if r[1] > 0 and not is_marker(k)}
        got = {s: sum(c for k, (c, _) in evs.items() if port_kernel(k, s))
               for s in syms}
        launched = (sum(host.get(k, 0) for k in LAUNCH_KEYS) - MARKERS
                    if cpu else None)
        unrecorded = (max(0, launched - device_kernels(card)) if cpu
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
    for k, (_, us) in evs.items():
        s = next((s for s in syms if port_kernel(k, s)), None)
        scale = want / got[s] if s in short else 1
        dev_us[k] = us * scale / n
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
STREAM_TOL = {"total_auc": 2e-4, "total_loss": 1e-5, "mean_auc": 5e-4}
LOAD_TOL = 1e-5                 # Predictor.load_from_trainer vs predict
RECIPE_AUC_MIN = 0.7            # the small recipe, 2 epochs
PROFILE_STEPS = 16


def _record_steps(tr):
    """Wrap a Trainer's step callables -> the list they fill, in call
    order, with (the callable's name, its losses on the device)."""
    out = []
    for attr in ("scan_steps_idx", "scan_steps", "train_step"):
        orig = getattr(tr, attr)

        def wrapped(*a, _orig=orig, _attr=attr):
            r = _orig(*a)
            out.append((_attr, r.detach().reshape(-1).clone()))
            return r

        setattr(tr, attr, wrapped)
    return out


def _losses(rec, lo=0):
    """The step losses of :func:`_record_steps`' ``rec[lo:]`` on the
    host."""
    return torch.cat([l for _, l in rec[lo:]]).cpu()


def harness_main_path(dev, tag, keep=None):
    """Phase 16: the training harness at full width.  make_synthetic at
    the flagship schema -> Trainer(...).fit(train, valid, test) through
    the device-resident (indexed) epoch, with the kernel counters read
    around the fit; then a profile of 16 indexed steps from the same
    initial state, streaming against exact eval, Predictor.load_from_trainer, a
    checkpoint through predictor_from_checkpoint and a fresh Trainer, and
    the small drive recipe.  ``keep``: a path the checkpoint is copied to
    (phase 28 serves it).  -> (launches, summary)."""
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
    want = schedule_launches(n_steps, n_steps + n_eval)
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
    step_loss_idx = _losses(steps_idx)
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

    # a second trainer from the same initial state for the profile (phase
    # 27 (a) holds the host-batching epoch against the indexed one)
    tr2 = trainer()
    tr2.restore(snap0)

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
        if keep is not None:
            shutil.copyfile(path, keep)
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
CDC_EPOCHS = 2
# causal-mask rows of phases 17 and 18's fits, cut from CDCConfig()'s 50
# to keep the script inside its time limit (phase 25 (b) runs the 50)
CDC_CAUSAL = 4


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


def populate_row_vs_cpu(cfg, X, y, dims, n_domain, blob, d2g, row, lanes,
                        tag, what, domain_idx=DOMAIN_IDX):
    """One populate row of CDC at ``cfg``, from the card's state ``blob``
    (at its update's entry) with the clustering ``d2g``: ``row`` =
    (bidx [K, W], bmask [K, W], bvalid [K], eidx [D, ebs], emask [D,
    ebs]), schedules into the host split ``X``, ``y``, gathered into one
    window as the "stream" placement's ``_feed`` does.  Its treatment
    burst and probe eval run on the card and on the CPU's plain path,
    serially (``lanes`` 0) or as lane 0 of ``lanes``, the CPU on the
    card's branches (:class:`relu_branches`), #1, #2, #3 and #6/7's pass
    counted on the card: the [D] row within CDC_ROW_TOL of max(1, |x|),
    the steps' losses (serial) within CPU_LOSS_RTOL, the table after the
    burst (the lane's under lanes) within 2 lr and CPU_TABLE_SHARE of it
    beyond 1e-6.  ``cfg`` takes dropout 0, wd CDC_CHECK_WD and float32
    moments (see :func:`cdc_row_vs_cpu`).  -> summary."""
    import dataclasses

    from tpurec_torch.cdc import CDCTrainer
    from tpurec_torch.cdc.algorithm import CDCClusterState

    cfg = dataclasses.replace(cfg, cdc=dataclasses.replace(
        cfg.cdc, parallel_rows=lanes))
    bidx, bmask, bvalid, eidx, emask = row
    flat = np.concatenate([bidx.ravel(), eidx.ravel()]).astype(np.int64)
    Xw, yw = np.ascontiguousarray(X[flat]), np.ascontiguousarray(y[flat])
    pos = np.arange(flat.size, dtype=np.int32)
    bpos = pos[:bidx.size].reshape(bidx.shape)
    epos = pos[bidx.size:].reshape(eidx.shape)
    masks, out = [], {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        t = CDCTrainer(cfg, dims, n_domain, domain_idx, device=where)
        t.restore_bytes(blob)
        t.cluster = CDCClusterState.create(n_domain, cfg.cdc.n_cluster,
                                           cfg.cdc)
        t.cluster.domain2group = np.asarray(d2g, np.int64)
        dev = t.device
        Xs, ys = (torch.from_numpy(Xw).to(dev), torch.from_numpy(yw).to(dev))
        bi, ei = torch.from_numpy(bpos).to(dev), torch.from_numpy(epos).to(dev)
        bm = torch.from_numpy(bmask).to(dev)
        em = torch.from_numpy(emask).to(dev)
        counters = train_counters(cfg.cdc.base_model)
        for fn in counters.values():
            fn.launches = 0
        with relu_branches(masks, record=where == "cuda") as branches:
            if lanes:
                r = t._run_populate_lanes(Xs, ys, bi[None], bm[None],
                                          bvalid[None], ei[None], em[None])[0]
                losses = []
                table = t._lanes.table[:t._lanes.V]
            else:
                losses = [float(v) for v in t._steps("split", Xs, ys, bi, bm,
                                                      bvalid)]
                r = t._eval_rows(Xs, ys, ei, em)
                table = t.model.embedding.table
            r = r.cpu().double()
        out[where] = {"row": r, "losses": losses,
                      "table": table.detach().cpu().clone(),
                      "launches": {k: fn.launches
                                   for k, fn in counters.items()}}
        print(f"{what} on {where}: {int((bvalid > 0).sum())} steps of "
              f"{bidx.shape[1]} rows, probe eval of {eidx.size} rows "
              f"({time.perf_counter() - t0:.1f} s)")
        del t, Xs, ys, bi, ei, table
        torch.cuda.empty_cache()
    g, c = out["cuda"], out["cpu"]
    n = int((bvalid > 0).sum())
    check(branches.used == len(masks) > 0, f"{what}: the CPU replayed "
          f"{branches.used} of the card's {len(masks)} ReLU calls")
    check(g["launches"] == schedule_launches(n, n + 1),
          f"{what}: launches {g['launches']} for {n} steps and a probe eval")
    row_err = ((g["row"] - c["row"]).abs()
               / torch.clamp(c["row"].abs(), min=1.0)).max().item()
    diff = (g["table"] - c["table"]).abs()
    share = (diff > 1e-6).float().mean().item()
    loss_rel = max((abs(a / b - 1) for a, b in zip(g["losses"],
                                                   c["losses"])), default=0.0)
    print(f"{tag} {what}, card vs CPU plain path on the card's branches "
          f"(dropout 0, wd {CDC_CHECK_WD}, float32 moments; "
          f"{branches.flips} inputs on the other branch on the CPU): [D] "
          f"probe row max err {row_err:.3g} of max(1, |x|) (tol "
          f"{CDC_ROW_TOL}); step loss max rel err {loss_rel:.3g}; table "
          f"after the burst max abs err {diff.max().item():.3g} (tol 2 lr), "
          f"share beyond 1e-6 {share:.3g} (tol {CPU_TABLE_SHARE})")
    check(row_err <= CDC_ROW_TOL, f"{what}: row max err {row_err}")
    check(loss_rel <= CPU_LOSS_RTOL, f"{what}: loss rel err {loss_rel}")
    check(diff.max().item() <= 2 * cfg.train.lr + 1e-6
          and share <= CPU_TABLE_SHARE, f"{what}: table max abs err "
          f"{diff.max().item()}, share beyond 1e-6 {share}")
    return {"row_err": row_err, "loss_rel_err": loss_rel,
            "table_max_abs_err": diff.max().item(),
            "table_share_beyond_1e-6": share, "steps": n,
            "flips": branches.flips, "launches": g["launches"]}


def cdc_row_vs_cpu(data, blob, d2g, tag, base="mmoe"):
    """Check 3 of phase 17: one mask row (CDC_TREAT domains, one pass, so
    2 treatment steps at W = 3,584 with masked rows) and its all-domain
    probe eval (D * 512 = 25,600 rows), scheduled as a fresh trainer on
    ``data`` schedules it, from the fitted state ``blob`` with dropout 0,
    on the card and on the CPU's plain path (:func:`populate_row_vs_cpu`).
    The table's moments are held in float32 here (the fitted bfloat16
    ones convert exactly): from a trained state a float32 moment one
    rounding apart lands in another bfloat16 value on either side, and
    the second step then differs by about 0.4% of its size (5.6e-6 on 68
    of 26M entries on an H100); phases 7 and 9 hold the bfloat16 moments.
    ``base``: CDC's base model (phase 18)."""
    from tpurec_torch.cdc import CDCTrainer

    cfg = cdc_config(dropout=0.0, wd=CDC_CHECK_WD, base=base,
                     embedding_moments_dtype="float32")
    t = CDCTrainer(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX, device="cpu")
    t.setup_data(data.train)
    bidx, bmask, bvalid = t._multi_burst_sched(list(range(CDC_TREAT)), 1, 2)
    eidx, emask = t._eval_sched()
    del t
    check(int(bvalid.sum()) == 2 and bidx.shape[1] == 7 * 512,
          f"the checked row runs {int(bvalid.sum())} steps of "
          f"{bidx.shape[1]} rows")
    X, y = data.train
    what = "cdc" if base == "mmoe" else f"cdc {base}"
    out = populate_row_vs_cpu(
        cfg, X, y, FIELD_DIMS, N_DOMAIN, blob, d2g,
        (bidx, bmask, bvalid, eidx, emask), 0, tag, f"{what} populate row")
    return {**out, "masked_rows": int((bmask[bvalid > 0] == 0).sum())}


def cdc_profile(tr, tag, n=PROFILE_STEPS, n_domain=N_DOMAIN):
    """Check 6 of phase 17: where a treatment step's time goes, at W =
    3,584 (7 domains a step) and at 512 (one domain), from the fitted
    trainer: device busy share of the profiled window, launches a step,
    device time by kernel."""
    out = {}
    for width in (7 * 512, 512):
        if width == 512:
            pairs = [tr._next_idx_padded(d % n_domain, 512)
                     for d in range(n + 2)]
            idxs = np.stack([p[0] for p in pairs])
            masks = np.stack([p[1] for p in pairs])
        else:
            idxs, masks, _ = tr._multi_burst_sched(
                list(range(n_domain)), 3, n + 2)
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


def cdc_main_path(dev, tag, base="mmoe", phase=17, profile=True,
                  n_causal_mask=None, keep=None):
    """Phase 17: the CDC engine on the flagship MMoE at full width.
    make_synthetic(131,072 rows, the flagship schema, 4 antipodal domain
    clusters) -> CDCTrainer(...).fit(train, valid, test): the warmup, one
    matrix update (mask, A and B blocks, the clustering) and the
    split-mode epoch, with the kernel counters read around the fit against
    the schedule the trainer built; then one populate row against the
    CPU's plain path, the rollback (checked inside the fit), a checkpoint
    through a fresh CDCTrainer and predictor_from_checkpoint, and a
    profile of treatment steps (when ``profile``).  Phase 18 runs it on
    another ``base``, with ``n_causal_mask`` mask rows (None: the
    reference's 50); ``keep``: a path the checkpoint is copied to (phase
    28 serves it).  -> (launches, summary)."""
    import os
    import tempfile

    from tpurec_torch.cdc import CDCTrainer
    from tpurec_torch.serve import predictor_from_checkpoint

    t_phase = time.perf_counter()
    data = cdc_data()
    cfg = cdc_config(base=base)
    if n_causal_mask is not None:
        import dataclasses

        cfg = dataclasses.replace(cfg, cdc=dataclasses.replace(
            cfg.cdc, n_causal_mask=n_causal_mask))
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
    want = schedule_launches(n_steps, n_fwd)
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
        if keep is not None:
            shutil.copyfile(path, keep)
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
    its profile, and 3 steps against the CPU's plain path on the card's
    branches.  -> {name: summary}."""
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
                                  f"{tag} {name}", timing["step_ms_host"],
                                  by_op=False)
        del ts, single, batches
        torch.cuda.empty_cache()
        # a ReLU input within rounding of 0 can take either side on the
        # card and the CPU, and a flip in step 1 parts the losses and the
        # table (phase 18 alone from fresh draws: PLE's loss before the
        # table's L2 1.41e-4, over CPU_LOSS_RTOL; STAR's table 2 lr apart
        # in 7e-6 of its values, over CPU_TABLE_SHARE): the steps run on
        # the card's branches (scripts/row_grad_flips.py --phase18 prints
        # them on the CPU's own)
        vs_cpu = train_vs_cpu(dev, rng, name, kw,
                              *PLE_VS_CPU if name == "ple" else (),
                              replay=True)
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
                                  f"{tag} {name}", timing["step_ms_host"],
                                  by_op=False)
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
                                  f"{tag} {name}", timing["step_ms_host"],
                                  by_op=False)
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


SORT_DEDUP_SHARE = CPU_TABLE_SHARE     # table values beyond 1e-6 a step


def sort_dedup_on_card(dev, rng, tag):
    """Phase 20 (b)'s "sparse" leg on the flagship MMoE again under
    LazyAdamRows' "sort" dedup (set on the step's updater, which picks
    "scatter" at this table's 1.6M rows): from one seeded state, the same
    8 steps (one call of the K=8 loop, dropout 0.2, bf16 moments) under
    "scatter" and then "sort".  Both sum a row's gradients with
    ``index_add_``, in another order (the atomics' on the card, the
    sorted order), so each of scatter's 8 table updates is replayed from
    its recorded entry under both dedups and held: the table within 2 lr
    (a sum near 0 whose sign the order sets takes Adam's step either way,
    as train_vs_cpu's table), at most SORT_DEDUP_SHARE of it beyond
    1e-6, the moments as :func:`check_moments`.  After the 8 whole steps:
    step 1's loss bitwise, every row no batch touched and its moments
    bitwise the initial state's under both, the tables within 2 lr a
    step.  Then one more timed call of each: ms a step.  -> summary."""
    from tpurec_torch.config import ModelConfig, TrainConfig
    from tpurec_torch.models import build_model
    from tpurec_torch.nn.core import EmbeddingLayout
    from tpurec_torch.train.sparse import LazyAdamRows, SparseEmbedState

    tcfg = TrainConfig(bs=512, embedding_moments_dtype="bfloat16")
    batches = train_batches(rng, TRAIN_K, dev)
    counters = train_counters("mmoe", "sparse")
    runs = {}
    for dedup in ("scatter", "sort"):
        model = build_model("mmoe", FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                            ModelConfig(**MODEL, dropout=DROPOUT),
                            generator=torch.Generator().manual_seed(SEED + 7))
        ts = train_state(model, tcfg, dev, "sparse")
        scan = train_step_of(model, tcfg, "mmoe", "sparse", TRAIN_K)
        check(scan.rows_update.dedup == "scatter", f"the flagship's "
              f"{scan.rows_update.vocab}-row table took "
              f"{scan.rows_update.dedup!r}")
        scan.rows_update.dedup = dedup
        table = model.embedding.table
        start = (table.detach().clone(), ts.emb_opt.m.clone(),
                 ts.emb_opt.v.clone())
        entries, update = [], scan.rows_update.update

        def recorded(table, emb_opt, x, rows, g_rows, step, shard=None,
                     _update=update, _out=entries):
            _out.append((table.clone(), emb_opt.m.clone(), emb_opt.v.clone(),
                         x.clone(), rows.clone(), g_rows.clone(), step))
            return _update(table, emb_opt, x, rows, g_rows, step, shard)

        if dedup == "scatter":
            scan.rows_update.update = recorded
        gen = torch.Generator(device=dev).manual_seed(SEED + 8)
        for fn in counters.values():
            fn.launches = 0
        loss = scan(ts, batches, gen)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        check(all(n == TRAIN_K for n in launches.values()),
              f"mmoe sparse/{dedup}: launches {launches} in {TRAIN_K} steps")
        after = (table.detach().clone(), ts.emb_opt.m.clone(),
                 ts.emb_opt.v.clone())
        scan.rows_update.update = update
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        ev0.record()
        scan(ts, batches, gen)
        ev1.record()
        torch.cuda.synchronize()
        runs[dedup] = dict(start=start, after=after, loss=loss.cpu(),
                           entries=entries, launches=launches,
                           step_ms_host=(time.perf_counter() - t0)
                           / TRAIN_K * 1e3,
                           step_ms_events=ev0.elapsed_time(ev1) / TRAIN_K)
        del model, ts, scan
        torch.cuda.empty_cache()
    sc, so = runs["scatter"], runs["sort"]
    check(all(torch.equal(a, b) for a, b in zip(sc["start"], so["start"])),
          "the two sparse runs did not start from one state")
    check(len(sc["entries"]) == TRAIN_K,
          f"{len(sc['entries'])} table updates recorded in {TRAIN_K} steps")
    lr = tcfg.lr
    replay = {"table_max_abs": 0.0, "table_share_beyond_1e-6": 0.0}
    for i, (p, m, v, x, rows, g_rows, step) in enumerate(sc["entries"]):
        got = {}
        for dedup in ("scatter", "sort"):
            upd = LazyAdamRows(FIELD_DIMS, tcfg, L2, dedup)
            st = SparseEmbedState(m=m.clone(), v=v.clone())
            q = p.clone()
            upd.update(q, st, x, rows, g_rows, step)
            got[dedup] = (q, st.m, st.v)
        diff = (got["sort"][0] - got["scatter"][0]).abs()
        err, share = diff.max().item(), (diff > 1e-6).float().mean().item()
        check(err <= 2 * lr + 1e-6 and share <= SORT_DEDUP_SHARE,
              f"sort vs scatter, table update {i + 1}: max abs {err}, "
              f"share beyond 1e-6 {share}")
        check_moments(got["sort"], got["scatter"],
                      f"sort vs scatter, table update {i + 1}")
        replay["table_max_abs"] = max(replay["table_max_abs"], err)
        replay["table_share_beyond_1e-6"] = max(
            replay["table_share_beyond_1e-6"], share)
    off = torch.as_tensor(EmbeddingLayout(FIELD_DIMS).offsets,
                          dtype=torch.int64, device=dev)
    touched = torch.zeros(sc["start"][0].shape[0], dtype=torch.bool,
                          device=dev)
    touched[(batches["x"].long() + off).reshape(-1)] = True
    for dedup, r in runs.items():
        check(all(torch.equal(a[~touched], b[~touched])
                  for a, b in zip(r["after"], r["start"])),
              f"sparse/{dedup}: an untouched row or its moments changed")
        moved = (r["after"][0][touched] != r["start"][0][touched]).any(
            dim=1).float().mean().item()
        check(moved == 1.0, f"sparse/{dedup}: {moved} of the touched rows "
              "moved")
    check(torch.equal(sc["loss"][0], so["loss"][0]),
          f"step 1's loss {sc['loss'][0].item()} under scatter, "
          f"{so['loss'][0].item()} under sort")
    end = (sc["after"][0] - so["after"][0]).abs()
    end_err = end.max().item()
    end_share = (end > 1e-6).float().mean().item()
    loss_rel = ((so["loss"] - sc["loss"]).abs() / sc["loss"].abs()).max()
    check(end_err <= 2 * lr * TRAIN_K + 1e-6, f"sort vs scatter after "
          f"{TRAIN_K} steps: table max abs {end_err}")
    print(f"{tag} mmoe sparse, dedup \"sort\" against \"scatter\" "
          f"(the flagship's {int(touched.numel())}-row table, B=512, "
          f"{TRAIN_K} steps from one state): each table update replayed "
          f"from scatter's entry under both, table max abs "
          f"{replay['table_max_abs']:.3g} (tol 2 lr), share beyond 1e-6 "
          f"{replay['table_share_beyond_1e-6']:.3g} (tol "
          f"{SORT_DEDUP_SHARE}), moments within check_moments; the whole "
          f"steps: step 1's loss bitwise, losses max rel "
          f"{loss_rel.item():.3g}, table after {TRAIN_K} steps max abs "
          f"{end_err:.3g}, share beyond 1e-6 {end_share:.3g}; "
          f"{int((~touched).sum())} untouched rows and their moments "
          f"bitwise the start under both; launches {so['launches']}; "
          f"ms a step scatter {sc['step_ms_host']:.3f} host / "
          f"{sc['step_ms_events']:.3f} events, sort "
          f"{so['step_ms_host']:.3f} / {so['step_ms_events']:.3f}")
    return {"replay": replay, "loss_max_rel": loss_rel.item(),
            "table_after_max_abs": end_err,
            "table_after_share_beyond_1e-6": end_share,
            "untouched_rows": int((~touched).sum()),
            "launches": so["launches"],
            **{f"{d}_step_ms_{k}": runs[d][f"step_ms_{k}"]
               for d in runs for k in ("host", "events")}}


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
    each of the three updates; and "sparse"'s "sort" dedup on the
    flagship MMoE against its "scatter" (:func:`sort_dedup_on_card`).
    -> summary dict."""
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
    out["mmoe/sparse sort"] = sort_dedup_on_card(dev, rng, tag)
    t0 = time.perf_counter()
    data = make_synthetic(n_rows=FIT_ROWS, n_fields=len(FIELD_DIMS),
                          n_domain=N_DOMAIN, field_dims=FIELD_DIMS,
                          domain_idx=DOMAIN_IDX, seed=1)
    print(f"zoo fit data: make_synthetic({FIT_ROWS} rows) in "
          f"{time.perf_counter() - t0:.2f} s")
    out["fit"] = {f"deepfm/{u}": zoo_fit(tag, data, u)
                  for u in ("hybrid", "sparse", "dense")}
    return out


# -- the CLI on the card (phase 21) -------------------------------------------

CLI_ROWS = 131072               # (a) and (e): phase 16's rows
CLI_SMALL_ROWS = 32768          # (b)-(d): the CDC fits and the options
CLI_MMOE = ["--model", "mmoe", "--dataset_name", "synthetic", "--n_rows",
            str(CLI_ROWS), "--n_domain", "6", "--bs", "512"]   # (a), (c)
CLI_MMOE_EPOCHS = 2             # (a)
CLI_AUC_MIN = 0.65              # as phase 16
CLI_TRACE_STEPS = 8
CLI_SYMS = ("gather_kernel", "field_attention_kernel",
            "field_attention_bwd_kernel")          # #1, #2, #3
CLI_BASES = ("pepnet", "epnet", "star")
# the CLI's Ali-CCP columns (tpurec_torch/cli.py load_dataset), in
# FIELD_DIMS' order
CLI_ALICCP_FIELDS = ("userid", "121", "122", "124", "125", "126", "127",
                     "128", "129", "itemid", "domain", "207", "210", "216",
                     "508", "509", "702", "853", "109_14", "110_14",
                     "127_14", "150_14", "301")
# (e) is in because the card's machine has pandas (3.0.2 there): the CLI
# reads a preprocessed CSV with pandas, as the JAX package's does


class _CliRecorder:
    """Around one ``tpurec_torch.cli.main`` call: the trainers it builds
    (``Trainer`` and ``CDCTrainer`` replaced by subclasses that keep
    themselves, the split ``fit`` gets and each ``train_epoch``'s host
    seconds, synchronized), the kernel counters zeroed before and read
    after, and the call's stdout and stderr."""

    def __init__(self, counters):
        self.counters = counters
        self.trainers = []

    def _sub(self, base):
        rec = self

        class Recorded(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.cli_epoch_s, self.cli_split = [], None
                rec.trainers.append(self)

            def fit(self, train, valid, test=None, **k):
                self.cli_split = train
                self.cli_valid, self.cli_test = valid[1], test[1]
                return super().fit(train, valid, test=test, **k)

            def train_epoch(self, *a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = super().train_epoch(*a, **k)
                torch.cuda.synchronize()
                self.cli_epoch_s.append(time.perf_counter() - t0)
                return r

        return Recorded

    def run(self, argv):
        """-> (main's output, launches, stdout lines, seconds)."""
        import contextlib
        import io

        import tpurec_torch.cdc
        import tpurec_torch.train
        from tpurec_torch import cli

        saved = (tpurec_torch.train.Trainer, tpurec_torch.cdc.CDCTrainer)
        tpurec_torch.train.Trainer = self._sub(saved[0])
        tpurec_torch.cdc.CDCTrainer = self._sub(saved[1])
        out_buf, err_buf = io.StringIO(), io.StringIO()
        for fn in self.counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out_buf), \
                    contextlib.redirect_stderr(err_buf):
                out = cli.main(argv)
            torch.cuda.synchronize()
        finally:
            tpurec_torch.train.Trainer, tpurec_torch.cdc.CDCTrainer = saved
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in self.counters.items()}
        lines = out_buf.getvalue().splitlines()
        check(bool(lines) and json.loads(lines[-1]).get("checkpoint")
              == out.get("checkpoint"),
              f"cli {argv[:2]}: the last line printed is not the result")
        return out, launches, lines, secs


def cli_counters():
    """Every kernel wrapper's launch counter, by the kernels line's names
    (``field_attention_train`` counts the stack's eval launches too)."""
    from tpurec_torch.ops.attention import (attention_layer_bwd,
                                            fused_attention_layer)
    from tpurec_torch.ops.cross_network import (cross_network,
                                                cross_network_bwd)

    return {**train_counters("mmoe"), "cross_network": cross_network,
            "cross_network_bwd": cross_network_bwd,
            "attention_layer": fused_attention_layer,
            "attention_layer_bwd": attention_layer_bwd}


def _cli_argv(tmp, name, seed, opts):
    import os

    return opts + ["--mesh_data", "-1", "--is_set_seed", "1", "--seed",
                   str(seed), "--save_path", os.path.join(tmp, name),
                   "--log_path", os.path.join(tmp, f"{name}.jsonl")]


def _cli_log(tmp, name):
    import os

    with open(os.path.join(tmp, f"{name}.jsonl")) as f:
        return [json.loads(line) for line in f]


def _cli_fit_checks(tr, out, log, launches, n_domain, what):
    """(a) and (e)'s checks on a Trainer run of the CLI.  -> summary."""
    import os

    valid, test = out["valid"], out["test"]
    check(valid is not None, f"{what}: no valid result (mean_auc NaN in "
          "every epoch)")
    for split, r in (("valid", valid), ("test", test)):
        check(np.isfinite(r["total_auc"]),
              f"{what}: {split} total_auc {r['total_auc']} not finite")
        check(sorted(r["domain_auc"]) == list(range(n_domain)),
              f"{what}: {split} domain_auc keys {sorted(r['domain_auc'])}")
    check(valid["total_auc"] >= CLI_AUC_MIN,
          f"{what}: valid total_auc {valid['total_auc']} < {CLI_AUC_MIN}")
    steps_log = [r for r in log if "it" in r]
    evals = [r for r in log if "total_auc" in r]
    check(len(steps_log) == len(evals) == len(tr.cli_epoch_s) >= 1
          and all(np.isfinite(r["train_loss"]) for r in steps_log),
          f"{what}: the JSONL log holds {len(steps_log)} train_loss and "
          f"{len(evals)} eval records for {len(tr.cli_epoch_s)} epochs")
    check(os.path.exists(out["checkpoint"]),
          f"{what}: no checkpoint at {out['checkpoint']}")
    bs = tr.cfg.train.bs
    n_train = len(tr.cli_split[1])
    n_steps = -(-n_train // bs)
    n_epochs = len(evals)

    def n_eval(split):
        return tr._padded_index_batches(len(split), bs,
                                        tr.EVAL_CHUNK)[0].shape[0]

    fwd = n_epochs * n_eval(tr.cli_valid) + n_eval(tr.cli_test)
    # #6's rows ride in the sweep only where the schema has big fields
    big = bool(tr.model.embedding.layout.big_fields)
    want = {"embedding_gather": n_epochs * n_steps + fwd,
            "field_attention_train": n_epochs * n_steps + fwd,
            "field_attention_bwd": n_epochs * n_steps,
            "fused_decay_adam": n_epochs * n_steps,
            "fused_sparse_adam": n_epochs * n_steps if big else 0}
    want.update({k: 0 for k in launches if k not in want})
    check(launches == want, f"{what}: kernel launches {launches}, expected "
          f"{want} ({n_epochs} epochs of {n_steps} steps, a forward per "
          f"eval batch; big fields {big})")
    step_ms = [s / n_steps * 1e3 for s in tr.cli_epoch_s]
    return {"valid_total_auc": valid["total_auc"],
            "valid_mean_auc": valid["mean_auc"],
            "valid_total_loss": valid["total_loss"],
            "test_total_auc": test["total_auc"],
            "valid_auc_by_epoch": [r["total_auc"] for r in evals],
            "train_rows": n_train, "epochs": n_epochs, "steps": n_steps,
            "step_ms": step_ms, "launches": launches}


def _aliccp_csv(path, rng, n):
    """A preprocessed Ali-CCP table written with numpy: the CLI's 23
    feature columns at FIELD_DIMS (each field's largest id present), a
    ``click`` that depends on the small fields and the domain, and
    ``train_tag`` 0/1/2 at about 90/5/5%."""
    X = np.stack([rng.integers(0, d, n) for d in FIELD_DIMS], 1)
    X[np.arange(len(FIELD_DIMS)), np.arange(len(FIELD_DIMS))] = \
        np.asarray(FIELD_DIMS) - 1
    logit = np.zeros(n)
    for f, d in enumerate(FIELD_DIMS):
        if d <= 5000:
            logit += rng.normal(0.0, 0.8, d)[X[:, f]]
    click = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int64)
    tag = rng.choice(3, n, p=[0.9, 0.05, 0.05])
    np.savetxt(path, np.column_stack([X, click, tag]), fmt="%d",
               delimiter=",", comments="",
               header=",".join(CLI_ALICCP_FIELDS + ("click", "train_tag")))


def cli_main_path(dev, tag):
    """Phase 21: ``tpurec_torch.cli.main`` on the card, in-process, with the
    kernel counters read around each run: (a) MMoE at ModelConfig's
    widths, 2 epochs of 131,072 synthetic rows; (b) CDC on PEPNet, EPNet
    and STAR with one matrix update each; (c) --resume, --domain_filter
    with --hash_buckets on DeepFM, bf16 compute on MMoE; (d) the CLI and
    the serving CLI as subprocesses, a torch.profiler trace of 8 of (a)'s
    steps through utils.profiling; (e) the CSV branch on a preprocessed
    Ali-CCP table at the flagship's fields.  -> (launches by run,
    summary)."""
    import os
    import pickle
    import shutil
    import subprocess as sp
    import tempfile

    from tpurec_torch.data.preprocess import AliCCPPreprocessor
    from tpurec_torch.serve import predictor_from_checkpoint
    from tpurec_torch.utils.profiling import StepTimer, trace

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="cli_")
    rng = np.random.default_rng(SEED + 21)
    launches, summary = {}, {}

    def run(name, opts, seed=SEED + 21):
        rec = _CliRecorder(cli_counters())
        out, n, lines, secs = rec.run(_cli_argv(tmp, name, seed, opts))
        launches[name] = n
        check(all(t.device.type == "cuda" for t in rec.trainers),
              f"cli {name}: a trainer was not built on the card")
        return out, rec.trainers[-1], n, _cli_log(tmp, name), secs

    # (a) MMoE, 2 epochs, at ModelConfig's widths
    mmoe = list(CLI_MMOE)
    out_a, tr_a, n, log, secs = run(
        "mmoe", mmoe + ["--epoch", str(CLI_MMOE_EPOCHS)])
    Xtr, ytr = tr_a.cli_split
    summary["a_mmoe"] = a = {**_cli_fit_checks(tr_a, out_a, log, n, 6,
                                               "cli mmoe"), "seconds": secs}
    print(f"{tag} cli (a) mmoe: {a['epochs']} epochs of {a['steps']} steps "
          f"({a['train_rows']} train rows) at "
          + ", ".join(f"{m:.3f}" for m in a["step_ms"])
          + f" ms a step (host clock); valid total_auc "
          f"{a['valid_total_auc']:.5f} (by epoch "
          + ", ".join(f"{v:.5f}" for v in a["valid_auc_by_epoch"])
          + f"), test {a['test_total_auc']:.5f}; launches {n}; main "
          f"{secs:.2f} s")

    # (b) CDC on PEPNet, EPNet, STAR: one matrix update each
    summary["b_cdc"] = {}
    for base in CLI_BASES:
        name = f"cdc_{base}"
        out, tr, n, log, secs = run(name, [
            "--model", "cdc", "--base_model", base, "--dataset_name",
            "synthetic", "--n_rows", str(CLI_SMALL_ROWS), "--n_domain", "6",
            "--epoch", "1", "--bs", "512", "--warmup_step", "10",
            "--update_interval", "100000", "--n_causal_mask", "4"])
        upd = [r["cdc_update_seconds"] for r in log
               if "cdc_update_seconds" in r]
        auc = out["valid"]["total_auc"]
        check(len(upd) == 1, f"cli {name}: {len(upd)} matrix updates")
        check(np.isfinite(auc), f"cli {name}: valid total_auc {auc}")
        check(n["embedding_gather"] > 0 and n["fused_decay_adam"] > 0,
              f"cli {name}: kernel launches {n}")
        pred = predictor_from_checkpoint(out["checkpoint"])
        check(pred.device.type == "cuda",
              f"cli {name}: the checkpoint's Predictor is not on the card")
        Xs = tr.cli_split[0][:2000]
        p_card = pred(Xs)
        p_cpu = predictor_from_checkpoint(out["checkpoint"],
                                          device="cpu")(Xs)
        err = float(np.max(np.abs(p_card - p_cpu)))
        check(p_card.shape == (len(Xs),) and np.all(np.isfinite(p_card))
              and err <= PRED_TOL, f"cli {name}: checkpoint served on the "
              f"card vs the CPU: max abs err {err}")
        summary["b_cdc"][base] = {
            "domain2group": out["domain2group_list"],
            "s_group2domain": out["s_group2domain_list"],
            "valid_total_auc": auc, "test_total_auc":
            out["test"]["total_auc"], "update_seconds": upd[0],
            "launches": n, "serve_err": err, "seconds": secs}
        print(f"{tag} cli (b) cdc on {base}: clustering "
              f"{out['domain2group_list']} (groups "
              f"{out['s_group2domain_list']}); matrix update {upd[0]:.3f} "
              f"s; valid total_auc {auc:.5f}; checkpoint served on the card "
              f"vs CPU max abs err {err:.3g}; launches {n}; main "
              f"{secs:.2f} s")
        del pred, tr

    # (c) --resume, --domain_filter + --hash_buckets, bf16 compute
    out, tr, n, log, secs = run("resume", mmoe + [
        "--epoch", "1", "--resume", out_a["checkpoint"]])
    step0 = int(tr.state.step) - len(tr.cli_epoch_s) * -(
        -len(tr.cli_split[1]) // 512)
    check(step0 == 2 * a["steps"], f"cli resume: started at step {step0}, "
          f"(a) ended at {2 * a['steps']}")
    check(np.isfinite(out["valid"]["total_auc"]),
          "cli resume: valid total_auc not finite")
    summary["c_resume"] = {"valid_total_auc": out["valid"]["total_auc"],
                           "start_step": step0, "launches": n}
    print(f"{tag} cli (c) --resume (a)'s checkpoint at step {step0}: 1 "
          f"epoch, valid total_auc {out['valid']['total_auc']:.5f}")
    del tr
    out, tr, n, log, secs = run("deepfm_filter", [
        "--dataset_name", "synthetic", "--n_rows", str(CLI_SMALL_ROWS),
        "--n_domain", "6", "--epoch", "1", "--domain_filter", "[0,2,4]",
        "--hash_buckets", "{0: 16}"])
    keys = sorted(out["valid"]["domain_auc"])
    check(keys == [0, 1, 2] and sorted(out["test"]["domain_auc"]) == keys,
          f"cli deepfm --domain_filter: domain_auc keys {keys}")
    check(tr.model.field_dims[0] == 16 and tr.n_domain == 3,
          f"cli deepfm --hash_buckets: field dims {tr.model.field_dims}")
    check(np.isfinite(out["valid"]["total_auc"]) and n["embedding_gather"]
          > 0, f"cli deepfm: valid {out['valid']['total_auc']}, {n}")
    summary["c_filter"] = {"valid_total_auc": out["valid"]["total_auc"],
                           "domain_auc_keys": keys, "launches": n}
    print(f"{tag} cli (c) deepfm --domain_filter [0,2,4] --hash_buckets "
          f"{{0: 16}}: domain_auc keys {keys}, valid total_auc "
          f"{out['valid']['total_auc']:.5f}")
    del tr
    out, tr, n, log, secs = run("mmoe_bf16", mmoe + [
        "--epoch", "1", "--compute_dtype", "bfloat16"])
    check(tr.cfg.train.compute_dtype == "bfloat16" and np.isfinite(
        out["valid"]["total_auc"]), "cli bf16: not run in bf16, or no AUC")
    bf16_ms = tr.cli_epoch_s[0] / -(-len(tr.cli_split[1]) // 512) * 1e3
    summary["c_bf16"] = {"valid_total_auc": out["valid"]["total_auc"],
                         "f32_epoch0_valid_auc": a["valid_auc_by_epoch"][0],
                         "step_ms": bf16_ms, "launches": n}
    print(f"{tag} cli (c) mmoe --compute_dtype bfloat16: 1 epoch, valid "
          f"total_auc {out['valid']['total_auc']:.5f} beside (a)'s epoch 0 "
          f"{a['valid_auc_by_epoch'][0]:.5f} (float32); {bf16_ms:.3f} ms a "
          "step")
    del tr

    # (d) the CLI and the serving CLI as subprocesses; a trace of 8 steps
    t0 = time.perf_counter()
    argv = _cli_argv(tmp, "sub", SEED + 22, [
        "--dataset_name", "synthetic", "--n_rows", str(CLI_SMALL_ROWS),
        "--n_domain", "6", "--epoch", "1"])
    proc = sp.run([sys.executable, "-m", "tpurec_torch.cli", *argv],
                  cwd=root, capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m tpurec_torch.cli exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    res = json.loads(proc.stdout.splitlines()[-1])
    ck = res["checkpoint"]
    check(os.path.exists(ck) and res["valid"] is not None
          and np.isfinite(res["valid"]["total_auc"]),
          f"python -m tpurec_torch.cli: result {str(res)[:300]}")
    with open(ck, "rb") as f:
        fd = pickle.load(f)["field_dims"]
    Xs = np.stack([rng.integers(0, d, N_ROWS) for d in fd], 1)
    xin, pout = os.path.join(tmp, "X.npy"), os.path.join(tmp, "p.npy")
    np.save(xin, Xs)
    t0 = time.perf_counter()
    proc = sp.run([sys.executable, "-m", "tpurec_torch.serve", "--ckpt", ck,
                   "--input", xin, "--output", pout], cwd=root,
                  capture_output=True, text=True, timeout=600)
    serve_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m tpurec_torch.serve exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    p_card = np.load(pout)
    p_cpu = predictor_from_checkpoint(ck, device="cpu")(Xs)
    serve_err = float(np.max(np.abs(p_card - p_cpu)))
    check(p_card.shape == (N_ROWS,) and serve_err <= PRED_TOL,
          f"the serving CLI on the card vs the CPU: max abs err {serve_err}")
    print(f"{tag} cli (d) python -m tpurec_torch.cli (deepfm, 1 epoch) rc 0 "
          f"in {sub_s:.2f} s, valid total_auc "
          f"{res['valid']['total_auc']:.5f}; python -m tpurec_torch.serve "
          f"{N_ROWS} rows in {serve_s:.2f} s, card vs CPU max abs err "
          f"{serve_err:.3g} (tol {PRED_TOL})")

    Xdev, ydev, d2g = tr_a._device_dataset(Xtr, ytr)
    idx = torch.as_tensor(rng.integers(0, len(ytr), (CLI_TRACE_STEPS + 2,
                                                     512), dtype=np.int32),
                          device=dev)
    ones = torch.ones((CLI_TRACE_STEPS + 2, 512), device=dev)

    def step(i):
        tr_a.scan_steps_idx(tr_a.state, Xdev, ydev, d2g, idx[i:i + 1],
                            ones[i:i + 1], tr_a.dropout_gen)
        torch.cuda.synchronize()

    step(0)
    step(1)
    timer = StepTimer(warmup=0)
    tdir = os.path.join(tmp, "trace")
    with trace(tdir):
        open_capture_window()
        for i in range(2, CLI_TRACE_STEPS + 2):
            with timer:
                step(i)
    files = sorted(os.listdir(tdir))
    check(len(files) == 1 and files[0].endswith(".pt.trace.json"),
          f"utils.profiling.trace wrote {files}")
    with open(os.path.join(tdir, files[0])) as f:
        text = f.read()
    seen = {s: text.count(s) for s in CLI_SYMS}
    check(all(seen.values()), f"the trace names kernels {seen}")
    steps = timer.summary()
    check(steps.get("steps") == CLI_TRACE_STEPS, f"StepTimer {steps}")
    print(f"{tag} cli (d) utils.profiling.trace of {CLI_TRACE_STEPS} of (a)'s "
          f"steps: {files[0]} ({len(text) / 1e6:.1f} MB) names "
          + ", ".join(f"{s} x{c}" for s, c in seen.items())
          + "; StepTimer " + json.dumps(steps))
    summary["d_serving"] = {"subprocess_seconds": sub_s,
                            "serve_seconds": serve_s, "serve_err": serve_err,
                            "trace_kernels": seen, "step_timer": steps}
    del tr_a, Xdev, ydev, d2g
    torch.cuda.empty_cache()

    # (e) the CSV branch at the flagship's fields
    t0 = time.perf_counter()
    data_dir = os.path.join(tmp, "aliccp")
    os.makedirs(data_dir)
    _aliccp_csv(AliCCPPreprocessor(data_dir).preprocess_path, rng, CLI_ROWS)
    csv_s = time.perf_counter() - t0
    out, tr, n, log, secs = run("aliccp", [
        "--model", "mmoe", "--dataset_name", "aliccp", "--data_path",
        data_dir, "--epoch", "1", "--bs", "512"])
    check(tuple(tr.model.field_dims) == FIELD_DIMS and tr.n_domain ==
          N_DOMAIN, f"cli aliccp: field dims {tr.model.field_dims}, "
          f"{tr.n_domain} domains")
    e = summary["e_aliccp"] = {
        **_cli_fit_checks(tr, out, log, n, N_DOMAIN, "cli aliccp"),
        "seconds": secs, "csv_write_seconds": csv_s,
        "table_rows": int(sum(FIELD_DIMS))}
    print(f"{tag} cli (e) mmoe on a preprocessed Ali-CCP CSV "
          f"({CLI_ROWS} rows, the flagship's {e['table_rows']}-row table): "
          f"{e['steps']} steps at {e['step_ms'][0]:.3f} ms a step (host "
          f"clock); valid total_auc {e['valid_total_auc']:.5f}; launches "
          f"{n}; main {secs:.2f} s (CSV written in {csv_s:.2f} s)")
    del tr
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    summary["phase_seconds"] = time.perf_counter() - t_phase
    print(f"cli phase: {summary['phase_seconds']:.1f} s")
    return launches, summary


# -- the (data, model) mesh (phase 22) ----------------------------------------

MESH_SHAPE = (2, 2)             # (b), (c): 4 ranks on the one card, gloo
MESH_STEPS = 3
MESH_LOSS_RTOL = 2e-5           # tpurec's own limits for its mesh
MESH_TABLE_ATOL = 2e-5          # (tests/test_sharding.py:57-82)
# (b) runs at the default wd and at CDC_CHECK_WD.  Its table, at every
# wd, is within MESH_TABLE_ATOL of the one-device update replayed on the
# mesh's own row gradients: the update on the shard is exact.  Against
# the one-device run the table is held to MESH_TABLE_ATOL at wd 1e-3
# only.  At the default wd a dense value whose step-1 gradient lies near
# Adam's eps steps by lr g / (|g| + eps) on the rounding of g, and a ReLU
# input within a rounding of 0 can take the other branch, so the mesh's
# model parts from one device's after step 1 and the row gradients of
# steps 2-3 part with it; on an H100 (700 W) three batch draws parted
# 24, 0 and 18,268 of the 26M table values by more than MESH_TABLE_ATOL
# (`--phase 22 --draws 3`).  No bound fits that, so there the phase
# prints the parting by step (row gradients, dense values after step 1,
# each table value beyond) and holds the loss and the replay.  Draws past
# the first are diagnostics: the one-device table check holds on draw 0
MESH_WDS = {"default": TRAIN_WD, "wd1e-3": CDC_CHECK_WD}
MESH_DRAWS = 1                  # (b)'s batch draws at each wd
MESH_PARTED = 1e-6              # a dense value parted after step 1
MESH_AUC_TOL = 0.01             # (c) vs phase 16, (d) vs phase 21 (a)
MESH_EVAL_TOL = 1e-6            # (c)'s state restored onto one device
MESH_TIMEOUT = 600
RANK_GRACE_S = 30               # a failed rank's peers are ended after this
PG_TIMEOUT_ENV = "CHIP_SMOKE_PG_TIMEOUT"    # a spawned rank's group timeout
# what a rank that leaves its process group to interpreter exit can print
EXIT_FAULTS = ("terminate called", "process group has NOT been destroyed")


def expected_placement(local_rank, local_world, n_cards=None):
    """(backend, device) that ``init_distributed`` gives rank
    ``local_rank`` of ``local_world`` ranks on a host of ``n_cards`` cards
    (None: this host's): ``choose_backend``'s pick on card ``local_rank %
    n_cards``.  4 ranks on one card: gloo on cuda:0; on four: NCCL on
    cuda:r."""
    from tpurec_torch.parallel.mesh import choose_backend

    n = torch.cuda.device_count() if n_cards is None else n_cards
    dev = torch.device("cuda", local_rank % n)
    return choose_backend(dev, local_world, n)[0], str(dev)


def check_placement(recs, world, what):
    """Each rank record's backend and device are the ones this host
    gives a rank of ``world`` (:func:`expected_placement`)."""
    for r in recs:
        want = expected_placement(r["rank"], world)
        check((r["backend"], r["device"]) == want,
              f"{what} rank {r['rank']}: {r['backend']} on {r['device']}, "
              f"expected {want[0]} on {want[1]}")


def _join_rank():
    """``init_distributed`` for a rank this script started, with the
    process-group timeout (seconds) its starter put in PG_TIMEOUT_ENV
    (unset: the backend's default)."""
    import os

    from tpurec_torch.parallel import init_distributed

    t = os.environ.get(PG_TIMEOUT_ENV)
    return init_distributed(timeout=None if t is None else float(t))


def mesh_config(dropout, wd=TRAIN_WD):
    """Phase 16's settings (B=512, bfloat16 moments) with the async
    versioned backend."""
    from tpurec_torch.config import Config, ModelConfig, TrainConfig

    return Config(model=ModelConfig(**MODEL, dropout=dropout),
                  train=TrainConfig(bs=512, epoch=1, seed=0, wd=wd,
                                    embedding_moments_dtype="bfloat16",
                                    checkpoint_backend="orbax"))


def mesh_trainer(cfg, mesh=None):
    from tpurec_torch.train import Trainer

    return Trainer(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                   domain2group=np.arange(N_DOMAIN) % N_TOWER, mesh=mesh)


def mesh_batches(dev, rows=slice(None), draw=0):
    """(b)'s MESH_STEPS global batches of 512 rows (this data rank's
    ``rows``), as tensors on ``dev``; ``draw`` picks another draw."""
    rng = np.random.default_rng(SEED + 22 + 1000 * draw)
    d2g = np.arange(N_DOMAIN) % N_TOWER
    out = []
    for _ in range(MESH_STEPS):
        X = random_ids(rng, 512)
        b = {"x": X, "y": rng.integers(0, 2, 512).astype(np.float32),
             "group": d2g[X[:, DOMAIN_IDX]].astype(np.int32),
             "mask": np.ones(512, np.float32)}
        out.append({k: torch.from_numpy(v[rows]).to(dev)
                    for k, v in b.items()})
    return out


def mesh_fit_data():
    from tpurec_torch.data import make_synthetic

    return make_synthetic(n_rows=FIT_ROWS, n_fields=len(FIELD_DIMS),
                          n_domain=N_DOMAIN, field_dims=FIELD_DIMS,
                          domain_idx=DOMAIN_IDX, seed=1)


def mesh_rank(out_dir, draws=MESH_DRAWS, shape=MESH_SHAPE):
    """One rank of phase 22 (b) and (c), started by :func:`mesh_ranks_path`
    with RANK/WORLD_SIZE/LOCAL_RANK/MASTER_* set: (b) MESH_STEPS hybrid
    steps of the flagship (dropout 0) on ``shape``, the table gathered
    to rank 0 (``draws`` batch draws at each wd); (c) Trainer.fit
    of one epoch at phase 16's settings, the exact valid eval, the async
    backend's save and the pickle checkpoint.  Writes ``rank_<r>.json``
    (and rank 0 the gathered tables)."""
    import os

    from tpurec_torch.parallel import make_mesh
    from tpurec_torch.parallel.collectives import STATS, reset_stats

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    j = _join_rank()
    mesh = make_mesh(*shape)
    dev = mesh.device
    bl = 512 // mesh.n_data
    rows = slice(mesh.d * bl, (mesh.d + 1) * bl)
    rec = {"rank": j.rank, "backend": j.backend, "device": str(dev),
           "coords": [mesh.d, mesh.m]}
    counters = train_counters("mmoe")

    # (b) MESH_STEPS steps, dropout 0, at each of MESH_WDS
    rec["b_losses"] = {}
    for name, wd, draw in mesh_b_runs(draws):
        key = f"{name}_{draw}"
        tr = mesh_trainer(mesh_config(0.0, wd), mesh)
        updates = record_updates(tr)
        for fn in counters.values():
            fn.launches = 0
        losses = []
        for t, b in enumerate(mesh_batches(dev, rows, draw)):
            losses.append(float(tr.train_step(tr.state, b, tr.dropout_gen)))
            if t == 0 and j.rank == 0:
                np.savez(os.path.join(out_dir, f"dense1_{key}.npz"),
                         **dense_values(tr))
        rec["b_losses"][key] = losses
        rec["b_launches"] = {k: fn.launches for k, fn in counters.items()}
        emb = tr.model.embedding
        table = emb.shard.gather(emb.table.detach())
        if j.rank == 0:
            np.save(os.path.join(out_dir, f"table_{key}.npy"),
                    table.cpu().numpy())
            np.savez(os.path.join(out_dir, f"rows_{key}.npz"),
                     x=np.stack([r["x"] for r in updates]),
                     g=np.stack([r["g"] for r in updates]))
        del tr, table, emb, updates
        torch.cuda.empty_cache()

    # (c) one fit epoch at phase 16's settings
    data = mesh_fit_data()
    Xva, yva = data.valid
    w = data.domain_cnt_weight()
    tr = mesh_trainer(mesh_config(DROPOUT), mesh)
    n_steps = -(-len(data.train[1]) // 512)
    n_eval = tr._padded_index_batches(len(yva), 512,
                                      tr.EVAL_CHUNK)[0].shape[0]
    for fn in counters.values():
        fn.launches = 0
    marks = {}

    def log_fn(r):
        torch.cuda.synchronize()
        if "it" in r:
            marks["train_end"] = time.perf_counter()
            marks["coll"] = dict(STATS)

    torch.cuda.synchronize()
    reset_stats()
    t0 = time.perf_counter()
    out = tr.fit(data.train, data.valid, domain_cnt_weight=w, log_fn=log_fn)
    torch.cuda.synchronize()
    rec["c_launches"] = {k: fn.launches for k, fn in counters.items()}
    rec["c_schedule"] = {"steps": n_steps, "eval_batches": n_eval}
    train_s = marks["train_end"] - t0
    rec["c_train_s"] = train_s
    rec["c_step_ms"] = train_s / n_steps * 1e3
    rec["c_collectives"] = marks["coll"]
    rec["c_valid"] = {k: out["valid"][k] for k in
                      ("total_auc", "mean_auc", "total_loss", "train_loss")}
    exact = tr.evaluate(Xva, yva, w)
    rec["c_exact"] = {k: exact[k] for k in ("total_auc", "total_loss")}
    be = tr.make_checkpointer(os.path.join(out_dir, "ck"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.save_versioned(be, 1, extra={"phase": 22})
    rec["c_save_return_s"] = time.perf_counter() - t0
    be.wait_until_finished()
    rec["c_save_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr.save_checkpoint(os.path.join(out_dir, "mesh.pkl"))
    rec["c_pickle_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"rank_{j.rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()
    return 0


def mesh_b_runs(draws):
    """(b)'s runs: (name of the wd, wd, batch draw)."""
    return [(name, wd, draw) for name, wd in MESH_WDS.items()
            for draw in range(draws)]


def record_updates(trainer):
    """Have ``trainer``'s table update record, at each step, its global
    batch: the ids ``x`` [B, F] and row gradients ``g`` [B*F, D] (on a
    mesh, the data ranks' exchanged in global order, as the update
    gathers them); and, on one device, every table value's update u =
    coef p + g and its terms |coef p| + the sum of |g| over the batch rows
    that read it (``u``, ``a``, on the card), with the medians over the
    touched values of |u| and of |u| / terms.  -> the list of dicts it
    appends to, one a step."""
    upd = trainer.scan_steps.upd
    update, out = upd.update, []

    def recorded(table, emb_opt, x, g_rows, step, shard=None):
        B, F = x.shape
        xg, gg = x, g_rows.reshape(B, F, -1).float()
        if shard is not None:
            xg, gg = shard.exchange(xg, gg)
        gg = gg.reshape(-1, gg.shape[-1])
        rec = {"x": xg.cpu().numpy(), "g": gg.cpu().numpy()}
        if shard is None:
            V, D = table.shape
            offsets, _ = upd.layout.device_arrays(table.device, V)
            ids = (xg.long() + offsets.long()[None]).reshape(-1)
            u = torch.zeros_like(table).index_add_(0, ids, gg)
            a = torch.zeros_like(table).index_add_(0, ids, gg.abs())
            touched = a > 0
            u.add_(upd.coef * table)
            a.add_(upd.coef * table.abs())
            ut = u[touched].abs()
            rec.update(u=u, a=a, median_u=float(ut.median()),
                       median_ratio=float((ut / a[touched]).median()))
        out.append(rec)
        return update(table, emb_opt, x, g_rows, step, shard)

    upd.update = recorded
    return out


def dense_values(trainer):
    """{name: a copy of the values} of every parameter but the table, on
    the host."""
    return {n: p.detach().to("cpu", copy=True).numpy()
            for n, p in trainer.model.named_parameters()
            if n != "embedding.table"}


def _spawn_ranks(world, out_dir, timeout=MESH_TIMEOUT, draws=MESH_DRAWS,
                 flag="--mesh-rank", args=(), pg_timeout=None):
    """Start ``world`` copies of this script (``flag`` names the rank's
    part: ``--mesh-rank`` phase 22's, ``--ep-rank`` phase 23's,
    ``--lanes-rank`` phase 24's, ``--group-rank`` phase 29's; ``args``
    follow it) as ranks of one process group on localhost, each joining
    with ``pg_timeout`` seconds (None: the backend's default), and wait
    for all.  Once a rank fails, the others are ended RANK_GRACE_S later
    (a peer left inside a collective would wait out its timeout).  -> their
    exit codes (None: ended; "exit fault": 0, but its log shows one of
    EXIT_FAULTS) and log tails."""
    import os
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    me = os.path.abspath(__file__)
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        if pg_timeout is not None:
            env[PG_TIMEOUT_ENV] = str(pg_timeout)
        log = open(os.path.join(out_dir, f"rank_{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, me, flag, out_dir, "--draws", str(draws),
             *map(str, args)], env=env,
            cwd=os.path.dirname(me), stdout=log, stderr=subprocess.STDOUT))
    rcs = [None] * world
    deadline, failed = time.monotonic() + timeout, None
    try:
        while True:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs):
                break
            now = time.monotonic()
            if failed is None and any(rc not in (None, 0) for rc in rcs):
                failed = now
            if now > deadline or (failed is not None
                                  and now - failed > RANK_GRACE_S):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    tails = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank_{r}.log")) as f:
            text = f.read()
        if rcs[r] == 0 and any(x in text for x in EXIT_FAULTS):
            rcs[r] = "exit fault"
        tails.append(f"--- rank {r} (rc={rcs[r]}) ---\n"
                     + "".join(text.splitlines(True)[-25:]))
    return rcs, "\n".join(tails)


def _auc_text(auc):
    return "(not run: not compared)" if auc is None else f"{auc:.5f}"


def mesh_main_path(dev, tag, fit_auc, cli_auc0, draws=MESH_DRAWS,
                   cli=True):
    """Phase 22: the (data, model) mesh.  (a) a world of 1 over NCCL: the
    mesh Trainer's MESH_STEPS flagship steps against the mesh-less ones,
    bit for bit; (b) 4 ranks on the card over gloo, MESH_SHAPE, dropout 0:
    MESH_STEPS hybrid steps against the one-device card step, each rank's
    launches of #1, #2, #3 and #7's pass with #6's rows a step; (c) one
    Trainer.fit epoch on MESH_SHAPE at phase 16's settings: the valid AUC
    beside phase 16's, ms a step, the collectives' share, the async
    backend's save against the pickle write, its checkpoint restored onto
    one device; (d) the CLI under torch.distributed.run, 2 ranks on the
    card, phase 21 (a)'s configuration for one epoch
    (:func:`mesh_cli_ranks`; with ``cli`` only: the default run leaves it
    to ``--phase 22``).  ``fit_auc`` (phase 16's AUC) is None when the
    phase runs alone: (c) then prints its AUC uncompared; ``cli_auc0``
    is phase 21 (a)'s first epoch's AUC, which (d) is held to.
    ``draws``: (b)'s batch draws at each wd.  -> (launches, summary)."""
    import os
    import shutil
    import tempfile

    from tpurec_torch.parallel import (init_distributed, make_mesh,
                                       shutdown_distributed)

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    counters = train_counters("mmoe")
    summary, launches = {}, {}

    # (a) a world of one over NCCL
    j = init_distributed()
    check(j.world == 1 and j.backend == "nccl",
          f"a world of one on the card chose {j.backend} ({j.reason})")
    mesh = make_mesh(1, 1)
    cfg = mesh_config(DROPOUT)
    on, off = mesh_trainer(cfg, mesh), mesh_trainer(cfg)
    batches = mesh_batches(dev)
    for fn in counters.values():
        fn.launches = 0
    l_on = torch.stack([on.train_step(on.state, b, on.dropout_gen)
                        for b in batches])
    launches["a_world1"] = {k: fn.launches for k, fn in counters.items()}
    l_off = torch.stack([off.train_step(off.state, b, off.dropout_gen)
                         for b in batches])
    same = (torch.equal(l_on, l_off)
            and torch.equal(on.model.embedding.table,
                            off.model.embedding.table)
            and torch.equal(on.state.emb_opt.m, off.state.emb_opt.m)
            and torch.equal(on.state.emb_opt.v, off.state.emb_opt.v))
    check(same, f"(1, 1) mesh vs no mesh: losses {l_on.tolist()} vs "
          f"{l_off.tolist()}, table max abs err "
          f"{(on.model.embedding.table - off.model.embedding.table).abs().max().item()}")
    check(launches["a_world1"] == {k: MESH_STEPS for k in counters},
          f"(a) launches {launches['a_world1']}")
    print(f"{tag} mesh (a) world of 1, backend {j.backend} ({j.reason}): "
          f"{MESH_STEPS} flagship steps (dropout {DROPOUT}) on mesh (1, 1) "
          f"bit for bit the mesh-less steps (losses, table, moments); "
          f"launches {launches['a_world1']}")
    summary["a"] = {"backend": j.backend, "bitwise": True,
                    "launches": launches["a_world1"]}
    del on, off, batches
    torch.cuda.empty_cache()

    # (b) and (c): 4 ranks sharing the card over gloo
    tmp = tempfile.mkdtemp(prefix="mesh_")
    more, parts = mesh_ranks_path(dev, tag, tmp, fit_auc, draws)
    launches.update(more)
    summary.update(parts)
    if cli:
        summary["d"] = mesh_cli_ranks(tag, tmp, root, cli_auc0)
    shutil.rmtree(tmp, ignore_errors=True)
    shutdown_distributed()
    summary["phase_seconds"] = time.perf_counter() - t_phase
    print(f"mesh phase: {summary['phase_seconds']:.1f} s")
    return launches, summary


def mesh_ranks_path(dev, tag, tmp, fit_auc, draws=MESH_DRAWS,
                    shape=MESH_SHAPE, pg_timeout=None):
    """Phase 22 (b) and (c) (see :func:`mesh_main_path`) on ``shape``, a
    rank a place of the mesh (this script with ``--mesh-rank``), their
    files in ``tmp``; each rank's backend and card are the ones this host
    gives (:func:`expected_placement`), and joins with ``pg_timeout``.
    -> (launches, summary) of (b) and (c)."""
    import os

    counters = train_counters("mmoe")
    summary, launches = {}, {}
    world = shape[0] * shape[1]
    t0 = time.perf_counter()
    rcs, tails = _spawn_ranks(world, tmp, draws=draws, args=(
        "--shape", f"{shape[0]}x{shape[1]}"), pg_timeout=pg_timeout)
    ranks_s = time.perf_counter() - t0
    check(rcs == [0] * world, f"mesh ranks exited {rcs}:\n{tails}")
    recs = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank_{r}.json")) as f:
            recs.append(json.load(f))
    check_placement(recs, world, "mesh")
    for r in recs:
        check(r["b_launches"] == {k: MESH_STEPS for k in counters},
              f"(b) rank {r['rank']} launches {r['b_launches']}, expected "
              f"{MESH_STEPS} of each")
        sch = r["c_schedule"]
        want = schedule_launches(sch["steps"],
                                 sch["steps"] + sch["eval_batches"])
        check(r["c_launches"] == want, f"(c) rank {r['rank']} launches "
              f"{r['c_launches']}, expected {want} (a step each, a forward "
              "per eval batch of the fit's streaming eval)")
        # every rank returns the global loss and eval: the same AUC (the
        # histograms' counts are exact) and losses; the eval's loss sums
        # are float atomics (index_add_), so they may part in last bits
        v, v0 = r["c_valid"], recs[0]["c_valid"]
        check(r["b_losses"] == recs[0]["b_losses"]
              and v["total_auc"] == v0["total_auc"]
              and v["train_loss"] == v0["train_loss"]
              and abs(v["total_loss"] - v0["total_loss"]) <= 1e-6,
              f"rank {r['rank']} disagrees with rank 0: (b) losses "
              f"{r['b_losses']} vs {recs[0]['b_losses']}; (c) {v} vs {v0}")
    print(f"{tag} mesh (b)/(c): {world} ranks, {recs[0]['backend']} on "
          + ", ".join(sorted({r['device'] for r in recs})) + f", mesh "
          f"{shape}, ran in {ranks_s:.1f} s (start-up included); "
          f"every rank exited 0")
    launches["b_steps"] = recs[0]["b_launches"]
    launches["c_fit"] = recs[0]["c_launches"]

    # (b) against the one-device card step
    summary["b"] = {"launches": launches["b_steps"]}
    for name, wd, draw in mesh_b_runs(draws):
        key = f"{name}_{draw}"
        cfg = mesh_config(0.0, wd)
        table = np.load(os.path.join(tmp, f"table_{key}.npy"))
        # the one-device table update replayed on the mesh's row gradients
        with np.load(os.path.join(tmp, f"rows_{key}.npz")) as z:
            xs, gs = z["x"], z["g"]
        rep = mesh_trainer(cfg)
        rt = rep.model.get_parameter("embedding.table").detach()
        for t in range(MESH_STEPS):
            rep.scan_steps.upd.update(rt, rep.state.emb_opt,
                                      torch.from_numpy(xs[t]).to(dev),
                                      torch.from_numpy(gs[t]).to(dev), t + 1)
        replay = np.abs(table - rt.cpu().numpy())
        del rep, rt
        # the one-device run
        ref = mesh_trainer(cfg)
        updates = record_updates(ref)
        l_ref = []
        for t, b in enumerate(mesh_batches(dev, draw=draw)):
            l_ref.append(float(ref.train_step(ref.state, b, ref.dropout_gen)))
            if t == 0:
                dense1 = dense_values(ref)
                grad1 = {n: p.grad.to("cpu", copy=True).numpy()
                         for n, p in ref.model.named_parameters()
                         if n in dense1 and p.grad is not None}
        want_t = ref.model.embedding.table.detach().cpu().numpy()
        del ref
        l_mesh = recs[0]["b_losses"][key]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_mesh, l_ref))
        diff = np.abs(table - want_t)
        t_err = float(diff.max())
        where = np.argwhere(diff > MESH_TABLE_ATOL)
        beyond = len(where)
        share = beyond / diff.size
        g_rel = [float(np.abs(gs[t] - r["g"]).max() / np.abs(r["g"]).max())
                 for t, r in enumerate(updates)]
        with np.load(os.path.join(tmp, f"dense1_{key}.npz")) as z:
            dpart = {n: np.abs(z[n] - dense1[n]) for n in dense1}
        parted = {n: d > MESH_PARTED for n, d in dpart.items()}
        n_parted = int(sum(m.sum() for m in parted.values()))
        d_max = max(float(d.max()) for d in dpart.values())
        g_parted = max([float(np.abs(grad1[n][m]).max())
                        for n, m in parted.items() if m.any() and n in grad1]
                       or [0.0])
        g_med = float(np.median(np.concatenate(
            [np.abs(g).ravel() for g in grad1.values()])))
        print(f"{tag} mesh (b) {MESH_STEPS} hybrid steps on {shape} vs "
              f"one device, wd {wd}, batch draw {draw}: losses {l_mesh} vs "
              f"{l_ref} (max rel err {loss_rel:.3g}, tol {MESH_LOSS_RTOL}); "
              f"the table gathered to rank 0 against the one-device update "
              f"replayed on the mesh's row gradients: max abs err "
              f"{float(replay.max()):.3g} (tol {MESH_TABLE_ATOL}); against "
              f"the one-device run: max abs err {t_err:.3g}, {beyond} of "
              f"{diff.size} values beyond {MESH_TABLE_ATOL} (share "
              f"{share:.3g})")
        print(f"{tag} mesh (b) wd {wd}, draw {draw}: the mesh's row "
              f"gradients against one device's, max abs err of max |g| by "
              f"step {[float(f'{x:.3g}') for x in g_rel]}; the dense "
              f"parameters after step 1: {n_parted} values parted by more "
              f"than {MESH_PARTED} (max {d_max:.3g}), their largest "
              f"one-device step-1 |g| {g_parted:.3g} (Adam's eps 1e-8; "
              f"the median |g| {g_med:.3g})")
        check(loss_rel <= MESH_LOSS_RTOL, f"(b) wd {wd} draw {draw}: loss "
              f"rel err {loss_rel}")
        check(float(replay.max()) <= MESH_TABLE_ATOL, f"(b) wd {wd} draw "
              f"{draw}: the mesh's table update is not one device's on the "
              f"same row gradients: max abs err {float(replay.max())}")
        rec = {"wd": wd, "draw": draw, "losses": l_mesh,
               "one_device_losses": l_ref, "loss_rel_err": loss_rel,
               "replay_abs_err": float(replay.max()),
               "table_abs_err": t_err, "table_values_beyond_atol": beyond,
               "share_beyond": share, "row_grad_rel_err": g_rel,
               "dense_parted_step1": n_parted, "dense_max_err_step1": d_max,
               "dense_parted_max_grad": g_parted}
        if wd != TRAIN_WD:
            # held on the main run's draw; the others measure how often
            # a ReLU that flips at step 1 parts the runs here too
            check(draw > 0 or t_err <= MESH_TABLE_ATOL, f"(b) wd {wd}: "
                  f"table abs err {t_err}")
        else:
            meds = [(float(f"{r['median_u']:.3g}"),
                     float(f"{r['median_ratio']:.3g}")) for r in updates]
            print(f"{tag} mesh (b) wd {wd}, draw {draw}: the touched "
                  f"values' median |u| and |u| / (|coef p| + sum |g|) by "
                  f"step {meds}; each value beyond {MESH_TABLE_ATOL}: "
                  f"[row, col, |u| by step, least ratio, |mesh - one|]"
                  f"{' (the first 64)' if beyond > 64 else ''}:")
            r_, c_ = (torch.from_numpy(np.ascontiguousarray(where[:, i]))
                      .to(dev) for i in (0, 1))
            u = torch.stack([x["u"][r_, c_].abs() for x in updates])
            ratio = (u / torch.stack([x["a"][r_, c_] for x in updates])
                     ).min(0)[0].cpu().numpy()
            u = u.cpu().numpy()
            for k in range(min(beyond, 64)):
                print(f"    [{where[k, 0]}, {where[k, 1]}, "
                      f"{[float(f'{x:.3g}') for x in u[:, k]]}, "
                      f"{ratio[k]:.3g}, {diff[where[k, 0], where[k, 1]]:.3g}]")
            rec["touched_median_u_ratio"] = meds
        summary["b"][key] = rec
        del updates, table, want_t, replay, diff, dense1, grad1, dpart
        torch.cuda.empty_cache()

    # (c) the fit's numbers, and its checkpoint onto one device
    r0 = recs[0]
    auc = r0["c_valid"]["total_auc"]
    coll = r0["c_collectives"]
    shares = [r["c_collectives"]["seconds"] / r["c_train_s"] for r in recs]
    print(f"{tag} mesh (c) Trainer.fit 1 epoch on {shape} "
          f"({r0['c_schedule']['steps']} steps of 512, dropout {DROPOUT}): "
          f"valid total_auc {auc:.5f} (streaming) beside phase 16's "
          f"{_auc_text(fit_auc)} (tol {MESH_AUC_TOL}); "
          + ", ".join(f"rank {r['rank']} {r['c_step_ms']:.3f}" for r in recs)
          + " ms a step (host clock); collectives "
          + ", ".join(f"{100 * x:.1f}%" for x in shares)
          + f" of the epoch ({coll['calls']} calls, "
          f"{coll['bytes'] / 1e6:.1f} MB on rank 0; host time inside "
          f"torch.distributed, {r0['backend']}"
          + ("; NCCL returns once a collective is queued, so this reads "
             "the enqueue: phase 29 (e) reads the device time"
             if r0["backend"] == "nccl" else "") + ")")
    print(f"{tag} mesh (c) checkpoints: async save returned in "
          + ", ".join(f"{r['c_save_return_s'] * 1e3:.1f}" for r in recs)
          + " ms, written in "
          + ", ".join(f"{r['c_save_write_s'] * 1e3:.1f}" for r in recs)
          + " ms; pickle (gathered, rank 0 writes) "
          + ", ".join(f"{r['c_pickle_s'] * 1e3:.1f}" for r in recs) + " ms")
    check(fit_auc is None or abs(auc - fit_auc) <= MESH_AUC_TOL,
          f"(c) valid AUC {auc} vs phase 16's {fit_auc}")
    data = mesh_fit_data()
    one = mesh_trainer(mesh_config(DROPOUT))
    meta = one.load_versioned(one.make_checkpointer(os.path.join(tmp, "ck")))
    ev = one.evaluate(*data.valid, data.domain_cnt_weight())
    ev_err = {k: abs(ev[k] - r0["c_exact"][k]) for k in r0["c_exact"]}
    print(f"{tag} mesh (c) the async checkpoint restored onto one device: "
          f"exact valid eval vs the mesh's {ev_err} (tol {MESH_EVAL_TOL})")
    check(meta["extra"] == {"phase": 22}, f"(c) checkpoint extra {meta}")
    check(all(v <= MESH_EVAL_TOL for v in ev_err.values()),
          f"(c) restored eval differs: {ev_err}")
    del one, data
    torch.cuda.empty_cache()
    summary["c"] = {
        "valid": r0["c_valid"], "phase16_valid_total_auc": fit_auc,
        "step_ms": [r["c_step_ms"] for r in recs],
        "collective_share": shares, "collectives_rank0": coll,
        "save_return_ms": [r["c_save_return_s"] * 1e3 for r in recs],
        "save_write_ms": [r["c_save_write_s"] * 1e3 for r in recs],
        "pickle_ms": [r["c_pickle_s"] * 1e3 for r in recs],
        "restore_eval_err": ev_err, "launches": launches["c_fit"],
        "ranks_seconds": ranks_s}

    return launches, summary


def mesh_cli_ranks(tag, tmp, root, cli_auc0):
    """Phase 22 (d) (see :func:`mesh_main_path`).  -> summary."""
    import os
    import subprocess as sp

    argv = ["--model", "mmoe", "--dataset_name", "synthetic", "--n_rows",
            str(CLI_ROWS), "--n_domain", "6", "--bs", "512", "--epoch", "1",
            "--mesh_data", "2", "--is_set_seed", "1", "--seed",
            str(SEED + 21), "--save_path", os.path.join(tmp, "cli"),
            "--log_path", os.path.join(tmp, "cli.jsonl")]
    t0 = time.perf_counter()
    proc = sp.run([sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc_per_node", "2", "-m",
                   "tpurec_torch.cli", *argv], cwd=root, capture_output=True,
                  text=True, timeout=MESH_TIMEOUT)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"torch.distributed.run -m tpurec_torch.cli "
          f"exited {proc.returncode}: {proc.stderr[-3000:]}")
    results = [json.loads(x) for x in proc.stdout.splitlines()
               if x.startswith("{") and '"valid"' in x]
    check(len(results) == 1, f"(d) {len(results)} result lines (rank 0 "
          "alone prints one)")
    with open(os.path.join(tmp, "cli.jsonl")) as f:
        log = [json.loads(x) for x in f]
    mrec = [r for r in log if "mesh" in r]
    check(len(mrec) == 1 and mrec[0]["mesh"] == [2, 1]
          and mrec[0]["backend"] == expected_placement(0, 2)[0],
          f"(d) the mesh record {mrec}")
    cli_auc = results[0]["valid"]["total_auc"]
    check(os.path.exists(results[0]["checkpoint"]),
          "(d) no checkpoint from rank 0")
    print(f"{tag} mesh (d) python -m torch.distributed.run --nproc_per_node "
          f"2 -m tpurec_torch.cli (mesh {mrec[0]['mesh']}, backend "
          f"{mrec[0]['backend']}): exit 0 in {cli_s:.1f} s; valid total_auc "
          f"{cli_auc:.5f} beside phase 21 (a)'s epoch 0 "
          f"{_auc_text(cli_auc0)} (tol "
          f"{MESH_AUC_TOL})")
    check(cli_auc0 is None or abs(cli_auc - cli_auc0) <= MESH_AUC_TOL,
          f"(d) valid AUC {cli_auc} vs phase 21 (a)'s {cli_auc0}")
    return {"valid_total_auc": cli_auc, "phase21_epoch0": cli_auc0,
            "seconds": cli_s, "backend": mrec[0]["backend"]}


# -- CDC on the mesh and expert parallelism (phase 23) ------------------------

EP_STEPS = MESH_STEPS
# (a) runs at CDC_CHECK_WD, where the banks and the table are held to one
# device's, and at the default wd, where a bias feeding a training
# BatchNorm (the experts' own) steps by up to lr on the rounding of its
# zero gradient and the parting prints (phase 22 (b)'s reason)
EP_WDS = {"wd1e-3": CDC_CHECK_WD, "default": TRAIN_WD}
EP_BANK = "experts"             # the flagship MMoE's bank: 4 -> 2 a rank
# (b) phase 17's configuration (cdc_config) on phase 21 (b)'s data and
# schedule (32,768 rows, 6 domains, warmup_step 10, one matrix update of
# 4 causal-mask rows)
EP_CDC_DOMAINS = 6
EP_CDC_DIMS = FIELD_DIMS[:DOMAIN_IDX] + (EP_CDC_DOMAINS,) \
    + FIELD_DIMS[DOMAIN_IDX + 1:]
EP_CDC_CAUSAL = 4
EP_CDC_ATOL = 5e-5              # tests/test_cdc_e2e.py:213-244's limit
# 23 (b), 24 (c) and 26 (b) hold one fixed draw, the schedule's row order,
# at EP_CDC_ATOL.  It reads below the median: over 4 row orders (2, 2)'s
# A block parted from one device by 1.0e-5 / 5.4e-5 / 1.8e-4 (min /
# median / max, --phase 23's witness on an H100 80GB HBM3, 700 W), so a
# change of the data or of its order is expected to fail these checks
# with no fault in the port.
EP_CDC_STAGES = ("warmup", "mask", "A", "B", "span")
EP_TIE_DRAWS = 32               # matrices moved by +-EP_CDC_ATOL, reclustered


def ep_cdc_config():
    """(b)'s CDC configuration: cdc_config at CDC_CHECK_WD, dropout 0, one
    epoch, the streaming eval on both sides, the async backend."""
    import dataclasses

    cfg = cdc_config(dropout=0.0, epoch=1, wd=CDC_CHECK_WD,
                     eval_streaming=True, checkpoint_backend="orbax")
    return dataclasses.replace(cfg, cdc=dataclasses.replace(
        cfg.cdc, warmup_step=10, update_interval=100000,
        n_causal_mask=EP_CDC_CAUSAL))


def ep_cdc_data():
    from tpurec_torch.data import make_synthetic

    return make_synthetic(
        n_rows=CLI_SMALL_ROWS, n_fields=len(EP_CDC_DIMS),
        n_domain=EP_CDC_DOMAINS, field_dims=EP_CDC_DIMS,
        domain_idx=DOMAIN_IDX, seed=1, domain_cluster_k=N_TOWER,
        domain_cluster_conflict=True)


def _trace_cdc(tr, on_block=None, reorder=None):
    """Record each hybrid step's loss of ``tr.fit`` by stage
    (EP_CDC_STAGES: the warmup, the update's three populate blocks, the
    split-mode spans; a later update's stages numbered), the k-means
    seed of each clustering and the raw matrices it was given; call
    ``on_block(i)`` at the entry of populate block i.  With ``reorder``
    (a seed) each step takes its rows in a permutation drawn from it (one
    a width): the same sums in another order; on a mesh the data ranks
    then take their columns of the permuted rows.  -> {stage: [loss
    tensors], "seeds": [k-means seeds], "updates": [{mask, A, B, seed}]};
    ``undo()`` of the second value
    takes the wrappers off ``tr`` (they hold it: left on, they would keep
    a dropped trainer on the card until a collection) and puts the
    engine's update_group back."""
    import tpurec_torch.cdc.engine as eng

    trace = {"warmup": [], "seeds": [], "updates": []}
    stage, n_block, perms = ["warmup"], [0], {}
    steps, populate, span = tr._steps, tr._run_populate_async, tr._train_span
    update_group = eng.update_group

    def steps_(mode, Xsrc, ysrc, idxs, masks, valids=None):
        if reorder is not None:
            W = idxs.shape[1]
            if W not in perms:
                perms[W] = torch.randperm(W, generator=torch.Generator()
                                          .manual_seed(reorder)).to(
                                              idxs.device)
            idxs, masks = idxs[:, perms[W]], masks[:, perms[W]]
        out = steps(mode, Xsrc, ysrc, idxs, masks, valids)
        trace[stage[0]].extend(out)
        return out

    def populate_(*args):
        i = n_block[0]
        n_block[0] += 1
        # a later update's blocks, and the spans after it, are numbered
        stage[0] = EP_CDC_STAGES[1 + i % 3] + (f" {i // 3 + 1}" if i >= 3
                                                else "")
        trace[stage[0]] = []
        if on_block is not None:
            on_block(i)
        return populate(*args)

    def span_(seq, lo, hi):
        if not stage[0].startswith("span"):
            stage[0] = "span" + (f" {n_block[0] // 3}" if n_block[0] > 3
                                 else "")
            trace[stage[0]] = []
        return span(seq, lo, hi)

    def update_group_(st, cfg, w, kmeans_seed=None):
        trace["seeds"].append(kmeans_seed)
        trace["updates"].append({"mask": st.matrix_mask.copy(),
                                 "A": st.matrix_A.copy(),
                                 "B": st.matrix_B.copy(),
                                 "seed": kmeans_seed})
        return update_group(st, cfg, w, kmeans_seed=kmeans_seed)

    tr._steps, tr._run_populate_async, tr._train_span = (steps_, populate_,
                                                          span_)
    eng.update_group = update_group_

    def undo():
        for name in ("_steps", "_run_populate_async", "_train_span"):
            delattr(tr, name)
        eng.update_group = update_group

    return trace, undo


class _SplitLinear(torch.autograd.Function):
    """``x @ w (+ b)`` (a Linear: ``eq`` None) or ``einsum(eq, x, w) (+
    b[None])`` (a StackedLinear), computed as the layer computes it; the
    backward sums w's and b's gradients over ``n`` row blocks apart, then
    the blocks' sums in order, as ``n`` data ranks sum theirs.  With
    ``rows`` the products themselves (forward, and the input's gradient)
    run a row block at a time, at a data rank's row count."""

    @staticmethod
    def forward(ctx, x, w, b, n, eq, rows=False):
        ctx.save_for_backward(x, w)
        ctx.n, ctx.eq, ctx.has_b, ctx.rows = n, eq, b is not None, rows

        def prod(xi):
            return (torch.matmul(xi, w) if eq is None
                    else torch.einsum(eq, xi, w))

        y = torch.cat([prod(xi) for xi in x.chunk(n)]) if rows else prod(x)
        if b is None:
            return y
        return y + (b if eq is None else b[None])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        n, eq = ctx.n, ctx.eq
        xs, dys = x.chunk(n), dy.chunk(n)
        if eq is None:
            def dprod(d):
                return torch.matmul(d, w.transpose(-1, -2))
            dw = sum(xi.reshape(-1, xi.shape[-1]).T
                     @ di.reshape(-1, di.shape[-1])
                     for xi, di in zip(xs, dys))
            dims = tuple(range(dy.dim() - 1))
        else:
            src, out = eq.split("->")[0].split(",")[0], eq.split("->")[1]

            def dprod(d):
                return torch.einsum(f"{out},tio->{src}", d, w)
            dw = sum(torch.einsum(f"{src},{out}->tio", xi, di)
                     for xi, di in zip(xs, dys))
            dims = (0,)
        dx = torch.cat([dprod(d) for d in dys]) if ctx.rows else dprod(dy)
        db = (sum(di.sum(dim=dims) for di in dys) if ctx.has_b else None)
        return dx, dw, db, None, None, None


class _SplitAffine(torch.autograd.Function):
    """BatchNorm's ``xhat * scale + bias``; the backward sums scale's and
    bias's gradients over ``n`` row blocks apart, then in order."""

    @staticmethod
    def forward(ctx, xhat, scale, bias, n):
        ctx.save_for_backward(xhat, scale)
        ctx.n = n
        return xhat * scale + bias

    @staticmethod
    def backward(ctx, dy):
        xhat, scale = ctx.saved_tensors
        dims = tuple(range(dy.dim() - 1))
        pairs = list(zip(xhat.chunk(ctx.n), dy.chunk(ctx.n)))
        return (dy * scale, sum((d * x).sum(dim=dims) for x, d in pairs),
                sum(d.sum(dim=dims) for _, d in pairs), None)


class mesh_split_sums:
    """Inside, a one-device training step makes its batch sums as a mesh
    of ``n`` data ranks makes them: each of ``n`` contiguous row blocks
    (data rank d's rows) summed apart, then the blocks' sums in order.
    That covers the BatchNorm statistics' sums (the masked sum, the count
    and the centred sum of squares, ``global_moments``) and the dense
    parameters' gradients: the Linears' and StackedLinears' weights and
    biases, the BatchNorms' scale and bias, and the attention stack's
    weights (kernel #3 run on each block, its weight gradients summed).
    With ``rows`` the Linears' and StackedLinears' products (forward and
    the input's gradient, in training and in the probe evals) and
    BatchNorm's normalisation run a row block at a time too, at a data
    rank's row count, where a library product may take another algorithm
    than at the whole batch's.  The rest computes as on one device (the
    other reductions of activation gradients inside a backward, the
    loss's sum, the model axis' split).  float32 compute only (no bf16
    casts)."""

    def __init__(self, n, rows=False):
        self.n, self.rows = n, rows

    def __enter__(self):
        import tpurec_torch.nn.core as core
        import tpurec_torch.ops.attention as att

        n = self.n
        self.saved = (core.global_moments, core.Linear.forward,
                      core.StackedLinear.forward, core.BatchNorm.forward,
                      att.field_attention_bwd)
        bwd = att.field_attention_bwd

        def moments(x, mask, mesh):
            stat = x.shape[1:]
            xs = x.chunk(n)
            if mask is None:
                ws = [None] * n
                s = sum(xi.sum(dim=0) for xi in xs)
                n_l = torch.full(stat, float(x.shape[0]), dtype=x.dtype,
                                 device=x.device)
            else:
                m = mask.to(x.dtype)
                w = m.reshape(m.shape + (1,) * (x.dim() - m.dim()))
                ws = w.chunk(n)
                s = sum((wi * xi).sum(dim=0) for wi, xi in zip(ws, xs))
                n_l = sum(wi.sum(dim=0) for wi in ws).expand_as(s)
            n_safe = torch.clamp(n_l.detach(), min=1.0)
            mean = s / n_safe
            q = sum((sq if wi is None else wi * sq).sum(dim=0)
                    for wi, sq in zip(ws, (torch.square(xi - mean)
                                            for xi in xs)))
            return mean, q / n_safe, n_l.detach()

        rows = self.rows

        def linear(mod, x):
            return _SplitLinear.apply(x, mod.weight, mod.bias, n, None, rows)

        def stacked(mod, x):
            eq = {2: "bi,tio->bto", 3: "bti,tio->bto"}[x.dim()]
            return _SplitLinear.apply(x, mod.weight, mod.bias, n, eq, rows)

        def batch_norm(mod, x, train=False, mask=None):
            if not train or (x.shape[0] * n == 1 and mask is None):
                return self.saved[3](mod, x, train, mask)
            mean, var, cnt = moments(x, mask, None)
            with torch.no_grad():
                mo = mod.momentum
                unbiased = var * (cnt / torch.clamp(cnt - 1.0, min=1.0))
                if mask is None:
                    mod.mean.copy_((1 - mo) * mod.mean + mo * mean)
                    mod.var.copy_((1 - mo) * mod.var + mo * unbiased)
                else:
                    has_rows = (cnt > 0).to(x.dtype)
                    mod.mean.add_(mo * has_rows * (mean - mod.mean))
                    mod.var.add_(mo * has_rows * (unbiased - mod.var))
                mod.num_batches_tracked.add_(1)
            inv = torch.rsqrt(var + mod.eps)
            xhat = (torch.cat([(xi - mean) * inv for xi in x.chunk(n)])
                    if rows else (x - mean) * inv)
            return _SplitAffine.apply(xhat, mod.scale, mod.bias, n)

        def attention_bwd(emb, dy, saved, y, flat_w, *args):
            parts = [bwd(e, d, sv, yy, flat_w, *args) for e, d, sv, yy in
                     zip(emb.chunk(n), dy.chunk(n), saved.chunk(n, dim=1),
                         y.chunk(n))]
            grads = [None if parts[0][1][i] is None
                     else sum(p[1][i] for p in parts)
                     for i in range(len(flat_w))]
            return torch.cat([p[0] for p in parts]), grads

        # the wrapper counts its launches on the name it is called by
        attention_bwd.launches = bwd.launches
        core.global_moments = moments
        core.Linear.forward = linear
        core.StackedLinear.forward = stacked
        core.BatchNorm.forward = batch_norm
        att.field_attention_bwd = attention_bwd
        return self

    def __exit__(self, *exc):
        import tpurec_torch.nn.core as core
        import tpurec_torch.ops.attention as att

        self.saved[4].launches = att.field_attention_bwd.launches
        (core.global_moments, core.Linear.forward,
         core.StackedLinear.forward, core.BatchNorm.forward,
         att.field_attention_bwd) = self.saved


def _trace_floats(trace):
    """A trace's losses, as floats, stage by stage in their order."""
    return {k: [float(x) for x in v] for k, v in trace.items()
            if k not in ("seeds", "updates")}


def _parting(a, b):
    """{stage: [|a - b| by step]} of two traces (_trace_floats)."""
    return {k: [abs(x - y) for x, y in zip(v, b[k])]
            for k, v in a.items() if k in b}


def _parting_line(part):
    """The parting by step, a stage at a time: the warmup's every step,
    then each later stage's first, largest and last."""
    out = []
    for k, v in part.items():
        if not v:
            continue
        if k == "warmup":
            out.append(f"warmup [{', '.join(f'{x:.1e}' for x in v)}]")
        else:
            out.append(f"{k} ({len(v)} steps) first {v[0]:.1e} max "
                       f"{max(v):.1e} last {v[-1]:.1e}")
    return "; ".join(out)


def clustering_tie(mask, n_cluster, seed, atol, draws=EP_TIE_DRAWS):
    """The first update's clustering (k-means on the causal distances of
    ``mask``, st.matrix_mask after the affinity transform, with the
    update's seed) of ``mask`` and of ``draws`` copies moved by +-atol
    (signs from a seeded draw) -> (labels, {labels: count}).  More than
    one labelling among the copies: the clustering is a tie that the
    matrices' tolerance does not decide."""
    from collections import Counter

    from tpurec_torch.cdc.algorithm import calc_causal_matrix, kmeans_group

    def labels(m):
        causal = np.arccos(np.clip(calc_causal_matrix(m.T), -1.0, 1.0))
        return tuple(int(g) for g in kmeans_group(causal, n_cluster,
                                                   seed=seed))

    rng = np.random.default_rng(SEED)
    moved = Counter(labels(mask + atol * rng.choice((-1.0, 1.0), mask.shape))
                    for _ in range(draws))
    return labels(mask), dict(moved)


def ep_bank(model):
    """{name: value} of the experts bank's state, whole (a split leaf
    gathered over the model group: every rank must call)."""
    from tpurec_torch.parallel.experts import expert_leaf_shards

    shards = expert_leaf_shards(model)
    out = {}
    for k, t in model.state_dict().items():
        if k.split(".")[0] == EP_BANK:
            t = shards[k].gather(t) if k in shards else t
            out[k] = t.detach().to("cpu", torch.float32).numpy()
    return out


def ep_rank(out_dir):
    """One rank of phase 23 (a) and (b), started by :func:`ep_main_path`
    with RANK/WORLD_SIZE/LOCAL_RANK/MASTER_* set, on MESH_SHAPE with
    Shardings(expert_parallel=True): (a) EP_STEPS hybrid steps of the
    flagship MMoE (dropout 0) at each of EP_WDS, the table and the
    experts gathered to rank 0; (b) CDCTrainer.fit of (b)'s configuration
    (its losses traced, rank 0 writing the state at each populate block's
    entry), the exact valid eval and the async backend's save, then the
    fit again with the split streamed.  Writes ``ep_rank_<r>.json`` (and
    rank 0 the gathered values)."""
    import dataclasses
    import os

    from tpurec_torch.cdc import CDCTrainer
    from tpurec_torch.parallel import Shardings, make_mesh
    from tpurec_torch.parallel.collectives import STATS, reset_stats
    from tpurec_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    j = _join_rank()
    mesh = make_mesh(*MESH_SHAPE)
    sh = Shardings(mesh, expert_parallel=True)
    dev = mesh.device
    bl = 512 // mesh.n_data
    rows = slice(mesh.d * bl, (mesh.d + 1) * bl)
    rec = {"rank": j.rank, "backend": j.backend, "device": str(dev),
           "coords": [mesh.d, mesh.m]}
    counters = train_counters("mmoe")

    # (a) EP_STEPS steps at each wd
    rec["a_losses"] = {}
    for name, wd in EP_WDS.items():
        tr = Trainer(mesh_config(0.0, wd), FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                     domain2group=np.arange(N_DOMAIN) % N_TOWER,
                     shardings=sh)
        for fn in counters.values():
            fn.launches = 0
        rec["a_losses"][name] = [
            float(tr.train_step(tr.state, b, tr.dropout_gen))
            for b in mesh_batches(dev, rows)]
        rec["a_launches"] = {k: fn.launches for k, fn in counters.items()}
        rec["a_bank_shapes"] = {
            k: list(t.shape) for k, t in tr.model.state_dict().items()
            if k.split(".")[0] == EP_BANK}
        bank = ep_bank(tr.model)
        emb = tr.model.embedding
        table = emb.shard.gather(emb.table.detach())
        if j.rank == 0:
            np.savez(os.path.join(out_dir, f"ep_{name}.npz"),
                     table=table.cpu().numpy(), **bank)
        del tr, table, emb, bank
        torch.cuda.empty_cache()

    # (b) CDC on the mesh with the experts split
    data = ep_cdc_data()
    tr = CDCTrainer(ep_cdc_config(), EP_CDC_DIMS, EP_CDC_DOMAINS, DOMAIN_IDX,
                    shardings=sh)
    check(tr.device.type == "cuda" and tr.model.experts.expert_shard
          is not None, f"rank {j.rank}: CDCTrainer on {tr.device}, experts "
          "not split")
    sched = {"warmup_steps": 0, "blocks": [], "probe_forwards": 0,
             "warmup_seconds": 0.0, "span_seconds": 0.0, "span_steps": 0}
    _observe_schedule(tr, sched)
    observed_span, coll = tr._train_span, {"seconds": 0.0, "calls": 0,
                                           "bytes": 0}

    def span(seq, lo, hi):
        before = dict(STATS)
        out = observed_span(seq, lo, hi)
        for k in coll:
            coll[k] += STATS[k] - before[k]
        return out

    tr._train_span = span

    def block(i):
        # each populate block's entry state, gathered, for one device's
        blob = tr.snapshot_bytes()
        if j.rank == 0:
            with open(os.path.join(out_dir, f"block_{i}.msgpack"), "wb") as f:
                f.write(blob)

    trace, undo = _trace_cdc(tr, on_block=block)
    for fn in counters.values():
        fn.launches = 0
    reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = tr.fit(data.train, data.valid)
    torch.cuda.synchronize()
    rec["b_fit_s"] = time.perf_counter() - t0
    rec["b_peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    undo()
    rec["b_trace"], rec["b_seeds"] = _trace_floats(trace), trace["seeds"]
    rec["b_fit_collectives"] = dict(STATS)
    rec["b_launches"] = {k: fn.launches for k, fn in counters.items()}
    n_steps = (sched["warmup_steps"]
               + sum(b["valid_steps"] for b in sched["blocks"])
               + sched["span_steps"])
    n_eval = tr._padded_split(tr.valid_batcher)[6]
    rec["b_schedule"] = {"steps": n_steps, "eval_batches": n_eval,
                         "probe_forwards": sched["probe_forwards"],
                         "span_steps": sched["span_steps"],
                         "warmup_steps": sched["warmup_steps"],
                         "blocks": sched["blocks"]}
    rec["b_step_ms"] = sched["span_seconds"] / sched["span_steps"] * 1e3
    rec["b_span_collective_share"] = coll["seconds"] / sched["span_seconds"]
    rec["b_span_collectives"] = coll
    st = tr.cluster
    rec["b_cluster"] = {"mask": st.matrix_mask.tolist(),
                        "A": st.matrix_A.tolist(), "B": st.matrix_B.tolist(),
                        "d2g": [int(g) for g in st.domain2group_list]}
    rec["b_valid"] = {k: out["valid"][k] for k in
                      ("total_auc", "mean_auc", "total_loss", "train_loss")}
    # the resident fit as a :func:`stream_fit` record, for _fits_bitwise
    resident = {"losses": [x for v in rec["b_trace"].values() for x in v],
                "updates": [dict(u, d2g=rec["b_cluster"]["d2g"])
                            for u in trace["updates"]],
                "state": tr.snapshot_bytes()}
    exact = tr.evaluate(tr.valid_batcher)
    rec["b_exact"] = {k: exact[k] for k in ("total_auc", "total_loss")}
    be = tr.make_checkpointer(os.path.join(out_dir, "cdc_ck"))
    tr.save_versioned(be, 1, extra={"phase": 23})
    be.wait_until_finished()
    del tr, st, trace
    torch.cuda.empty_cache()
    # (b)'s fit again with the split in host memory (every rank holds the
    # split; "auto" would keep 32,768 rows on the card): bitwise the
    # resident fit, launches against the schedule
    cfg = ep_cdc_config()
    cfg = dataclasses.replace(cfg, cdc=dataclasses.replace(
        cfg.cdc, data_placement="stream"))
    stream = stream_fit(data, counters, cfg, shardings=sh, min_updates=1,
                        what=f"(b) rank {j.rank}")
    u, = stream["updates"]
    rec["b_stream"] = {
        "bitwise": _fits_bitwise(resident, stream), "d2g": u["d2g"],
        "launches": stream["launches"], "fit_seconds": stream["fit_seconds"],
        "peak_gb": stream["peak_gb"],
        "update": {k: u[k] for k in ("seconds", "feed_seconds",
                                     "coll_seconds", "peak_gb",
                                     "valid_steps")}}
    del stream
    with open(os.path.join(out_dir, f"ep_rank_{j.rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()
    return 0


def ep_main_path(dev, tag, cli_cdc_aucs=None, witness=False, cli=True,
                 pg_timeout=None):
    """Phase 23: CDC on the (data, model) mesh and expert parallelism, 4
    ranks sharing the card over gloo (:func:`ep_rank`).  (a) EP_STEPS
    hybrid steps of the flagship MMoE on MESH_SHAPE with its 4 experts
    split 2 a rank, against the one-device card run: losses at
    MESH_LOSS_RTOL at both wds, the gathered experts (weights, biases,
    BatchNorm statistics) and the table at MESH_TABLE_ATOL at
    CDC_CHECK_WD, the parting printed at the default wd; each rank's bank
    shapes and launches of #1, #2, #3 and #6/#7 a step.  (b)
    CDCTrainer.fit on MESH_SHAPE with expert parallelism against
    one-device CDCTrainer.fit runs on the card, each step's loss traced:
    the fit that takes the mesh's state at the entry of each populate
    block and, ``witness`` only, the whole fit, each of these also with
    every step's rows in another order (a summation order alone).  The
    matrices are printed against each and held at EP_CDC_ATOL against
    the mesh's-state fit, with its domain2group unless the clustering
    ties within that tolerance (:func:`clustering_tie`); the loss
    parting by step and the valid AUCs printed; the async checkpoint
    restored onto one device (exact eval within MESH_EVAL_TOL), ms a
    step and the collectives' share; the ranks' fit again with the split
    streamed (:func:`stream_fit`) bitwise the resident one
    (:func:`_fits_bitwise`).  (c) the
    CLI under torch.distributed.run on 2 ranks: CDC on PLE with
    --mesh_model 2 --mesh_expert_parallel for one epoch; its AUC beside
    ``cli_cdc_aucs`` (phase 21 (b)'s, None when the phase runs alone).
    ``witness`` (``--phase 23`` only) adds (b)'s witness on three meshes
    (:func:`ep_witness_draws`); without ``cli`` (c) does not run.  Each
    rank's backend and card are the ones this host gives
    (:func:`expected_placement`: phase 29 runs (a) and (b) a rank a card
    over NCCL), and it joins with ``pg_timeout``.  -> (launches,
    summary)."""
    import os
    import shutil
    import subprocess as sp
    import tempfile

    from tpurec_torch.cdc import CDCTrainer

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    counters = train_counters("mmoe")
    summary, launches = {}, {}
    tmp = tempfile.mkdtemp(prefix="ep_")
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    t0 = time.perf_counter()
    rcs, tails = _spawn_ranks(world, tmp, flag="--ep-rank",
                              pg_timeout=pg_timeout)
    ranks_s = time.perf_counter() - t0
    check(rcs == [0] * world, f"phase 23 ranks exited {rcs}:\n{tails}")
    recs = []
    for r in range(world):
        with open(os.path.join(tmp, f"ep_rank_{r}.json")) as f:
            recs.append(json.load(f))
    from tpurec_torch.config import ModelConfig

    E = ModelConfig(**MODEL).mmoe_n_expert
    check_placement(recs, world, "ep")
    for r in recs:
        check(r["a_launches"] == {k: EP_STEPS for k in counters},
              f"(a) rank {r['rank']} launches {r['a_launches']}, expected "
              f"{EP_STEPS} of each")
        shapes = r["a_bank_shapes"]
        check(shapes[f"{EP_BANK}.linear_0.weight"][0] == E // MESH_SHAPE[1]
              and shapes[f"{EP_BANK}.bn_0.mean"][0] == E // MESH_SHAPE[1]
              and len(shapes[f"{EP_BANK}.bn_0.scale"]) == 1,
              f"rank {r['rank']}: bank shapes {shapes}")
        sch = r["b_schedule"]
        n_fwd = sch["steps"] + sch["probe_forwards"] + sch["eval_batches"]
        want = schedule_launches(sch["steps"], n_fwd)
        check(r["b_launches"] == want, f"(b) rank {r['rank']} launches "
              f"{r['b_launches']}, expected {want} (a step each, a forward "
              "per probe eval and streaming-eval batch)")
        check(r["b_cluster"]["d2g"] == recs[0]["b_cluster"]["d2g"]
              and r["a_losses"] == recs[0]["a_losses"],
              f"rank {r['rank']} disagrees with rank 0")
        bs = r["b_stream"]
        check(all(bs["bitwise"].values())
              and bs["d2g"] == recs[0]["b_cluster"]["d2g"]
              and bs["launches"] == r["b_launches"],
              f"(b) rank {r['rank']}: the fit with the split streamed "
              f"against the resident fit: bitwise {bs['bitwise']}, "
              f"clustering {bs['d2g']}, launches {bs['launches']} "
              f"(resident {r['b_launches']})")
    print(f"{tag} ep: {world} ranks, {recs[0]['backend']} on "
          + ", ".join(sorted({r['device'] for r in recs})) + ", mesh "
          f"{MESH_SHAPE}, Shardings(expert_parallel=True), ran in "
          f"{ranks_s:.1f} s (start-up included); every rank exited 0; "
          + "; ".join(f"rank {r['rank']} {tuple(r['coords'])} holds "
                      f"{EP_BANK}.linear_0.weight "
                      f"{r['a_bank_shapes'][f'{EP_BANK}.linear_0.weight']}"
                      for r in recs))
    launches["a_steps"] = recs[0]["a_launches"]
    launches["b_cdc_fit"] = recs[0]["b_launches"]

    # (a) against the one-device card steps
    summary["a"] = {"launches": launches["a_steps"],
                    "bank_shapes": recs[0]["a_bank_shapes"]}
    for name, wd in EP_WDS.items():
        ref = mesh_trainer(mesh_config(0.0, wd))
        l_ref = [float(ref.train_step(ref.state, b, ref.dropout_gen))
                 for b in mesh_batches(dev)]
        want_t = ref.model.embedding.table.detach().cpu().numpy()
        want_b = ep_bank(ref.model)
        del ref
        torch.cuda.empty_cache()
        l_mesh = recs[0]["a_losses"][name]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_mesh, l_ref))
        with np.load(os.path.join(tmp, f"ep_{name}.npz")) as z:
            t_err = float(np.abs(z["table"] - want_t).max())
            beyond = int((np.abs(z["table"] - want_t) > MESH_TABLE_ATOL)
                         .sum())
            b_err = {k: float(np.abs(z[k] - v).max())
                     for k, v in want_b.items()}
        worst = max(b_err, key=b_err.get)
        print(f"{tag} ep (a) {EP_STEPS} hybrid steps on {MESH_SHAPE}, "
              f"experts split, wd {wd}: losses {l_mesh} vs one device "
              f"{l_ref} (max rel err {loss_rel:.3g}, tol {MESH_LOSS_RTOL}); "
              f"gathered table max abs err {t_err:.3g} ({beyond} values "
              f"beyond {MESH_TABLE_ATOL}); experts' leaves max abs err "
              f"{b_err[worst]:.3g} ({worst}; by leaf "
              + ", ".join(f"{k.split('.', 1)[1]} {v:.2g}"
                          for k, v in b_err.items()) + ")")
        check(loss_rel <= MESH_LOSS_RTOL, f"(a) wd {wd}: loss rel err "
              f"{loss_rel}")
        if wd != TRAIN_WD:
            check(t_err <= MESH_TABLE_ATOL and b_err[worst] <=
                  MESH_TABLE_ATOL, f"(a) wd {wd}: table abs err {t_err}, "
                  f"{worst} abs err {b_err[worst]}")
        summary["a"][name] = {"wd": wd, "losses": l_mesh,
                              "one_device_losses": l_ref,
                              "loss_rel_err": loss_rel,
                              "table_abs_err": t_err,
                              "table_values_beyond_atol": beyond,
                              "bank_abs_err": b_err}

    # (b) against one-device CDCTrainer.fit runs on the card, each traced
    # step by step: "blocks", which takes the mesh's state (gathered) at
    # the entry of each populate block, so that each block compares from
    # one state; "blocks_reordered", that with the rows in another order
    # (the parting of a summation order from one state); with ``witness``
    # also "whole" from the seeded start, as the mesh, and "reordered",
    # that in another order (the parting over a whole fit)
    r0 = recs[0]
    data = ep_cdc_data()
    n_cluster = ep_cdc_config().cdc.n_cluster
    mesh_run = {"trace": r0["b_trace"], "seeds": r0["b_seeds"],
                "d2g": r0["b_cluster"]["d2g"],
                **{m: r0["b_cluster"][m] for m in ("mask", "A", "B")}}
    runs = {}
    for name in ("blocks", "blocks_reordered") + (
            ("whole", "reordered") if witness else ()):
        one = CDCTrainer(ep_cdc_config(), EP_CDC_DIMS, EP_CDC_DOMAINS,
                         DOMAIN_IDX)

        def from_mesh(i, one=one):
            with open(os.path.join(tmp, f"block_{i}.msgpack"), "rb") as f:
                one.restore_bytes(f.read())

        trace, undo = _trace_cdc(
            one, on_block=from_mesh if name.startswith("blocks") else None,
            reorder=SEED if name.endswith("reordered") else None)
        t0 = time.perf_counter()
        try:
            out1 = one.fit(data.train, data.valid)
            torch.cuda.synchronize()
        finally:
            undo()
        st = one.cluster
        runs[name] = {"seconds": time.perf_counter() - t0,
                      "trace": _trace_floats(trace), "seeds": trace["seeds"],
                      "d2g": [int(g) for g in st.domain2group_list],
                      "mask": st.matrix_mask, "A": st.matrix_A,
                      "B": st.matrix_B, "auc": out1["valid"]["total_auc"]}
        del one, st
        torch.cuda.empty_cache()

    def m_err(a, b):
        return {m: float(np.abs(np.asarray(a[m]) - np.asarray(b[m])).max())
                for m in ("mask", "A", "B")}

    counts = {k: len(v) for k, v in mesh_run["trace"].items()}
    check(tuple(counts) == EP_CDC_STAGES and all(
        {k: len(v) for k, v in r["trace"].items()} == counts
        for r in runs.values()), f"(b) steps by stage: mesh {counts}, "
          + ", ".join(f"{k} {[len(v) for v in r['trace'].values()]}"
                      for k, r in runs.items()))
    pairs = {"mesh_vs_blocks": (mesh_run, runs["blocks"]),
             "blocks_reordered_vs_blocks": (runs["blocks_reordered"],
                                            runs["blocks"])}
    if witness:
        pairs.update({"mesh_vs_whole": (mesh_run, runs["whole"]),
                      "reordered_vs_whole": (runs["reordered"],
                                             runs["whole"])})
    errs = {k: m_err(a, b) for k, (a, b) in pairs.items()}
    parts = {k: _parting(a["trace"], b["trace"])
             for k, (a, b) in pairs.items()}
    sch = r0["b_schedule"]
    auc = r0["b_valid"]["total_auc"]
    print(f"{tag} ep (b) CDCTrainer.fit on {MESH_SHAPE} with the experts "
          f"split ({EP_CDC_DOMAINS} domains, {sch['warmup_steps']} warmup "
          f"steps, one matrix update of {len(sch['blocks'])} blocks "
          f"{[(b['rows'], b['valid_steps'], b['width']) for b in sch['blocks']]}"
          f" (rows, valid steps, width), {sch['span_steps']} split-mode "
          f"steps, wd {CDC_CHECK_WD}) against one-device fits: "
          + "; ".join(f"{k} matrices max abs err {v}" for k, v in errs.items())
          + f" (tol {EP_CDC_ATOL}, held on mesh_vs_blocks); domain2group "
          f"mesh {mesh_run['d2g']}, "
          + ", ".join(f"{k} {r['d2g']}" for k, r in runs.items())
          + f"; valid total_auc {auc:.5f} (streaming) beside "
          + ", ".join(f"{k} {r['auc']:.5f}" for k, r in runs.items())
          + f"; launches {r0['b_launches']}")
    for k, v in parts.items():
        print(f"{tag} ep (b) {k}, |loss difference| by step: "
              f"{_parting_line(v)}")
    mx = {k: max(v.values()) for k, v in errs.items()}
    aucs = [r["auc"] for r in runs.values()]
    print(f"{tag} ep (b) "
          + (f"over the whole fit the mesh parts from one device by "
             f"{mx['mesh_vs_whole']:.3g} in the matrices, one device from "
             f"itself by {mx['reordered_vs_whole']:.3g} when only each "
             f"step's row order changes; " if witness else "")
          + f"from each block's state {mx['mesh_vs_blocks']:.3g} and "
          f"{mx['blocks_reordered_vs_blocks']:.3g}; by matrix (mask, A, B) "
          f"the mesh {errs['mesh_vs_blocks']}, the reordered rows "
          f"{errs['blocks_reordered_vs_blocks']}.  "
          "The valid AUC after the split-mode steps is printed, not held: "
          "the one-device fits that differ by rounding alone spread by "
          f"{max(aucs) - min(aucs):.4f}")
    # the clustering of the held comparison: its domain2group is held
    # unless matrices within the tolerance of one device's cluster
    # otherwise (a tie), and each side's is its own matrices' clustering
    seed = runs["blocks"]["seeds"]
    check(mesh_run["seeds"] == seed and len(seed) == 1,
          f"(b) k-means seeds: mesh {mesh_run['seeds']}, one device {seed}")
    own, moved = clustering_tie(np.asarray(runs["blocks"]["mask"]),
                                n_cluster, seed[0], EP_CDC_ATOL)
    mesh_own, _ = clustering_tie(np.asarray(mesh_run["mask"]), n_cluster,
                                 seed[0], EP_CDC_ATOL, draws=0)
    tied = len(moved) > 1
    print(f"{tag} ep (b) the clustering of one device's matrices moved by "
          f"+-{EP_CDC_ATOL} ({EP_TIE_DRAWS} draws): {moved} ("
          + ("a tie the tolerance does not decide: domain2group compared, "
             "not held" if tied else "decided: domain2group held") + ")")
    check(own == tuple(runs["blocks"]["d2g"])
          and mesh_own == tuple(mesh_run["d2g"]),
          f"(b) reclustering gives {own} (one device's "
          f"{runs['blocks']['d2g']}), {mesh_own} (the mesh's "
          f"{mesh_run['d2g']})")
    check(all(v <= EP_CDC_ATOL for v in errs["mesh_vs_blocks"].values()),
          f"(b) matrices vs one device by block: {errs['mesh_vs_blocks']}")
    check(tied or mesh_run["d2g"] == runs["blocks"]["d2g"],
          f"(b) domain2group {mesh_run['d2g']} vs one device's "
          f"{runs['blocks']['d2g']}")
    shares = [r["b_span_collective_share"] for r in recs]
    print(f"{tag} ep (b) split-mode steps: "
          + ", ".join(f"rank {r['rank']} {r['b_step_ms']:.3f}" for r in recs)
          + " ms a step (host clock, 256 rows a data rank); collectives "
          + ", ".join(f"{100 * x:.1f}%" for x in shares)
          + f" of the span ({r0['b_span_collectives']['calls']} calls, "
          f"{r0['b_span_collectives']['bytes'] / 1e6:.1f} MB on rank 0; host "
          f"time inside torch.distributed, {r0['backend']}); the fit "
          f"{r0['b_fit_s']:.1f}"
          f" s on the mesh, {runs['blocks']['seconds']:.1f} s on one device")
    ups = [r["b_stream"]["update"] for r in recs]
    print(f"{tag} ep (b) the same fit with data_placement=\"stream\" (each "
          f"rank gathers the whole window of a block or span from its own "
          f"copy of the split and copies it to the card): bitwise the "
          f"resident fit on every rank (every step's loss, the matrices, "
          f"the k-means seed, the clustering, the whole gathered state) "
          f"and its launches ({r0['b_stream']['launches']} on "
          f"rank 0); fit {r0['b_stream']['fit_seconds']:.1f} s beside "
          f"{r0['b_fit_s']:.1f} s resident; the update "
          + ", ".join(f"rank {r['rank']} {u['seconds']:.3f} s (_feed "
                      f"{u['feed_seconds']:.3f} s, "
                      f"{100 * u['feed_seconds'] / u['seconds']:.1f}%; "
                      f"collectives {100 * u['coll_seconds'] / u['seconds']:.1f}%)"
                      for r, u in zip(recs, ups))
          + "; peak device memory a rank, resident / stream: "
          + ", ".join(f"{r['b_peak_gb']:.2f} / "
                      f"{r['b_stream']['peak_gb']:.2f} GiB" for r in recs))
    one = CDCTrainer(ep_cdc_config(), EP_CDC_DIMS, EP_CDC_DOMAINS, DOMAIN_IDX)
    one.setup_data(data.train, data.valid)
    meta = one.load_versioned(one.make_checkpointer(os.path.join(tmp,
                                                                 "cdc_ck")))
    ev = one.evaluate(one.valid_batcher)
    ev_err = {k: abs(ev[k] - r0["b_exact"][k]) for k in r0["b_exact"]}
    print(f"{tag} ep (b) the async checkpoint restored onto one device: "
          f"exact valid eval vs the mesh's {ev_err} (tol {MESH_EVAL_TOL}); "
          f"clustering {one.cluster.domain2group_list}")
    check(meta["extra"] == {"phase": 23}, f"(b) checkpoint extra {meta}")
    check(all(v <= MESH_EVAL_TOL for v in ev_err.values())
          and one.cluster.domain2group_list == r0["b_cluster"]["d2g"],
          f"(b) restored eval differs: {ev_err}")
    del one, data
    torch.cuda.empty_cache()
    summary["b"] = {
        "matrix_abs_err": errs, "loss_parting_by_step": parts,
        "clustering_moved": {str(list(k)): n for k, n in moved.items()},
        "domain2group": mesh_run["d2g"],
        "one_device_domain2group": {k: r["d2g"] for k, r in runs.items()},
        "valid": r0["b_valid"],
        "one_device_valid_total_auc": {k: r["auc"] for k, r in runs.items()},
        "schedule": sch, "step_ms": [r["b_step_ms"] for r in recs],
        "span_collective_share": shares,
        "span_collectives_rank0": r0["b_span_collectives"],
        "fit_seconds": r0["b_fit_s"],
        "one_device_fit_seconds": {k: r["seconds"] for k, r in runs.items()},
        "restore_eval_err": ev_err, "launches": launches["b_cdc_fit"],
        "stream": {"bitwise": r0["b_stream"]["bitwise"],
                   "launches": r0["b_stream"]["launches"],
                   "fit_seconds": r0["b_stream"]["fit_seconds"],
                   "update": ups, "peak_gb": {
                       "resident": [r["b_peak_gb"] for r in recs],
                       "stream": [r["b_stream"]["peak_gb"] for r in recs]}}}
    if witness:
        summary["b_witness"] = ep_witness_draws(tag)

    if not cli:
        shutil.rmtree(tmp, ignore_errors=True)
        summary["ranks_seconds"] = ranks_s
        summary["phase_seconds"] = time.perf_counter() - t_phase
        return launches, summary

    # (c) the CLI: CDC on PLE with the experts split, 2 ranks
    argv = ["--model", "cdc", "--base_model", "ple", "--mesh_model", "2",
            "--mesh_expert_parallel", "--dataset_name", "synthetic",
            "--n_rows", str(CLI_SMALL_ROWS), "--n_domain", "6", "--epoch",
            "1", "--bs", "512", "--warmup_step", "10", "--update_interval",
            "100000", "--n_causal_mask", "4", "--is_set_seed", "1", "--seed",
            str(SEED + 23), "--save_path", os.path.join(tmp, "cli"),
            "--log_path", os.path.join(tmp, "cli.jsonl")]
    t0 = time.perf_counter()
    proc = sp.run([sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc_per_node", "2", "-m",
                   "tpurec_torch.cli", *argv], cwd=root, capture_output=True,
                  text=True, timeout=MESH_TIMEOUT)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"(c) torch.distributed.run -m "
          f"tpurec_torch.cli exited {proc.returncode}: {proc.stderr[-3000:]}")
    results = [json.loads(x) for x in proc.stdout.splitlines()
               if x.startswith("{") and '"valid"' in x]
    check(len(results) == 1, f"(c) {len(results)} result lines (rank 0 "
          "alone prints one)")
    with open(os.path.join(tmp, "cli.jsonl")) as f:
        log = [json.loads(x) for x in f]
    mrec = [r for r in log if "mesh" in r]
    split = [x for x in proc.stdout.splitlines()
             if "expert parallelism over the model axis" in x]
    check(len(mrec) == 1 and mrec[0]["mesh"] == [1, 2]
          and mrec[0]["backend"] == expected_placement(0, 2)[0],
          f"(c) the mesh record {mrec}")
    check(len(split) == 1 and "experts_specific (8 -> 4 a rank)" in split[0],
          f"(c) the split printed: {split}")
    cli_auc = results[0]["valid"]["total_auc"]
    check(np.isfinite(cli_auc) and os.path.exists(results[0]["checkpoint"]),
          f"(c) valid AUC {cli_auc}, checkpoint from rank 0")
    print(f"{tag} ep (c) python -m torch.distributed.run --nproc_per_node 2 "
          f"-m tpurec_torch.cli --model cdc --base_model ple --mesh_model 2 "
          f"--mesh_expert_parallel (backend {mrec[0]['backend']}; "
          f"{split[0].split(': ', 1)[1]}): exit 0 in {cli_s:.1f} s; "
          f"clustering {results[0]['domain2group_list']}; valid total_auc "
          f"{cli_auc:.5f} beside phase 21 (b)'s CDC runs "
          + ("(not run: not compared)" if cli_cdc_aucs is None else
             ", ".join(f"{b} {a:.5f}" for b, a in cli_cdc_aucs.items())))
    summary["c"] = {"valid_total_auc": cli_auc, "seconds": cli_s,
                    "domain2group": results[0]["domain2group_list"],
                    "split": split[0], "phase21_cdc": cli_cdc_aucs}
    shutil.rmtree(tmp, ignore_errors=True)
    summary["ranks_seconds"] = ranks_s
    summary["phase_seconds"] = time.perf_counter() - t_phase
    print(f"ep phase: {summary['phase_seconds']:.1f} s")
    return launches, summary


# (b)'s witness (``--phase 23``): the fit on three meshes, each over
# WITNESS_DRAWS row orders, against one device from each block's state
WITNESS_MESHES = (((2, 1), False),   # the data split alone
                  ((1, 2), False),   # the table's row shards alone
                  ((2, 2), True))    # (b) itself, the experts split
WITNESS_DRAWS = 4
WITNESS_ORDER = 1000            # one device's own row orders: this + draw


def witness_order(draw):
    """The row order of a witness draw: draw 0 takes the schedule's own
    (as (b)), draw d a permutation seeded SEED + d."""
    return None if draw == 0 else SEED + draw


def witness_rank(out_dir):
    """One rank of phase 23 (b)'s witness, started by :func:`ep_witness_
    draws` with ``witness.json`` in ``out_dir`` (the mesh's shape,
    expert parallelism, the draws): (b)'s CDCTrainer.fit once a draw,
    each step's rows in the draw's order (:func:`witness_order`), every
    step's loss traced, rank 0 writing the gathered state at each
    populate block's entry (``draw_<d>_block_<i>.msgpack``).  Writes
    ``witness_rank_<r>.json``."""
    import os

    from tpurec_torch.cdc import CDCTrainer
    from tpurec_torch.parallel import Shardings, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(out_dir, "witness.json")) as f:
        w = json.load(f)
    j = _join_rank()
    mesh = make_mesh(*w["shape"])
    sh = Shardings(mesh, expert_parallel=w["expert_parallel"])
    data = ep_cdc_data()
    rec = {"rank": j.rank, "draws": []}
    for d in range(w["draws"]):
        tr = CDCTrainer(ep_cdc_config(), EP_CDC_DIMS, EP_CDC_DOMAINS,
                        DOMAIN_IDX, shardings=sh)

        def block(i, d=d, tr=tr):
            blob = tr.snapshot_bytes()
            if j.rank == 0:
                with open(os.path.join(out_dir, f"draw_{d}_block_{i}"
                                       ".msgpack"), "wb") as f:
                    f.write(blob)

        trace, undo = _trace_cdc(tr, on_block=block,
                                 reorder=witness_order(d))
        t0 = time.perf_counter()
        try:
            tr.fit(data.train, data.valid)
        finally:
            undo()
        st = tr.cluster
        rec["draws"].append({
            "seconds": time.perf_counter() - t0,
            "trace": _trace_floats(trace), "seeds": trace["seeds"],
            "mask": st.matrix_mask.tolist(), "A": st.matrix_A.tolist(),
            "B": st.matrix_B.tolist(),
            "d2g": [int(g) for g in st.domain2group_list]})
        del tr, st
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"witness_rank_{j.rank}.json"),
              "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()
    return 0


def _spread(xs):
    """min / median / max of ``xs``, as text."""
    return (f"{min(xs):.3g} / {float(np.median(xs)):.3g} / "
            f"{max(xs):.3g}")


def ep_witness_draws(tag):
    """Phase 23 (b)'s witness (``--phase 23``): where does the mesh's A
    block part from one device more than a summation order does?  For
    each mesh of WITNESS_MESHES, ranks on the card (:func:`witness_rank`)
    fit (b) WITNESS_DRAWS times, each draw in its own row order; for each
    draw, one-device fits that take the mesh's state at each populate
    block's entry: "one" in the draw's row order (the mesh's parting),
    "order" in another (a summation order's parting), and on a mesh with
    a data split "sums", "one" with the batch sums made in the data ranks'
    row blocks (:class:`mesh_split_sums`), and "rows", that with the
    products and BatchNorm's normalisation in the row blocks too.  Each
    block's matrix (mask, A, B) and A's loss parting print as min /
    median / max over the draws.  -> summary."""
    import os
    import shutil
    import tempfile

    from tpurec_torch.cdc import CDCTrainer

    t_phase = time.perf_counter()
    data = ep_cdc_data()
    out = {}
    mats = ("mask", "A", "B")
    for shape, ep in WITNESS_MESHES:
        key = f"{shape[0]}x{shape[1]}" + (" ep" if ep else "")
        tmp = tempfile.mkdtemp(prefix="witness_")
        with open(os.path.join(tmp, "witness.json"), "w") as f:
            json.dump({"shape": list(shape), "expert_parallel": ep,
                       "draws": WITNESS_DRAWS}, f)
        world = shape[0] * shape[1]
        t0 = time.perf_counter()
        rcs, tails = _spawn_ranks(world, tmp, timeout=2 * MESH_TIMEOUT,
                                  flag="--witness-rank")
        ranks_s = time.perf_counter() - t0
        check(rcs == [0] * world, f"witness {key} ranks exited {rcs}:\n"
              f"{tails}")
        recs = []
        for r in range(world):
            with open(os.path.join(tmp, f"witness_rank_{r}.json")) as f:
                recs.append(json.load(f))
        check(all([d["d2g"] for d in r["draws"]]
                  == [d["d2g"] for d in recs[0]["draws"]] for r in recs),
              f"witness {key}: the ranks' clusterings differ")
        kinds = ("one", "order") + (("sums", "rows") if shape[0] > 1
                                    else ())
        errs = {k: [] for k in kinds}
        a_loss = {k: [] for k in kinds}
        for d, mesh_run in enumerate(recs[0]["draws"]):
            runs = {}
            for kind in kinds:
                one = CDCTrainer(ep_cdc_config(), EP_CDC_DIMS,
                                 EP_CDC_DOMAINS, DOMAIN_IDX)

                def from_mesh(i, one=one, d=d):
                    with open(os.path.join(tmp, f"draw_{d}_block_{i}"
                                           ".msgpack"), "rb") as f:
                        one.restore_bytes(f.read())

                order = (WITNESS_ORDER + d if kind == "order"
                         else witness_order(d))
                trace, undo = _trace_cdc(one, on_block=from_mesh,
                                         reorder=order)
                split = (mesh_split_sums(shape[0], rows=kind == "rows")
                         if kind in ("sums", "rows")
                         else contextlib.nullcontext())
                try:
                    with split:
                        one.fit(data.train, data.valid)
                    torch.cuda.synchronize()
                finally:
                    undo()
                st = one.cluster
                runs[kind] = {"trace": _trace_floats(trace),
                              **{m: getattr(st, f"matrix_{m}") for m in mats}}
                del one, st
                torch.cuda.empty_cache()
            one_run = runs["one"]
            for kind in kinds:
                other = one_run if kind == "order" else mesh_run
                ref = runs["order"] if kind == "order" else runs[kind]
                errs[kind].append({m: float(np.abs(
                    np.asarray(other[m]) - np.asarray(ref[m])).max())
                    for m in mats})
                a_loss[kind].append(max(
                    abs(x - y) for x, y in zip(other["trace"]["A"],
                                               ref["trace"]["A"])))
        shutil.rmtree(tmp, ignore_errors=True)
        names = {"one": "the mesh vs one device",
                 "order": "one device vs itself in another row order",
                 "sums": "the mesh vs one device summing in the data "
                 "ranks' row blocks",
                 "rows": "the mesh vs one device with its sums, products "
                 "and normalisation in the row blocks"}
        print(f"{tag} ep (b) witness on {shape}"
              + (" with the experts split" if ep else ", experts whole")
              + f" ({world} ranks, {WITNESS_DRAWS} row orders, "
              f"{ranks_s:.1f} s), each block from the mesh's state at its "
              "entry, max abs err min / median / max over the draws: "
              + "; ".join(f"{names[k]}: " + ", ".join(
                  f"{m} {_spread([e[m] for e in errs[k]])}" for m in mats)
                  + f", A's step loss {_spread(a_loss[k])}" for k in kinds))
        out[key] = {"matrix_abs_err": errs, "a_loss_parting": a_loss,
                    "ranks_seconds": ranks_s,
                    "mesh_fit_seconds": [d["seconds"]
                                         for d in recs[0]["draws"]]}
    order_a = [e["A"] for v in out.values() for e in v["matrix_abs_err"][
        "order"]]
    verdict = {k: {"A_median": float(np.median(
        [e["A"] for e in v["matrix_abs_err"]["one"]])),
        "beyond_order_max": float(np.median(
            [e["A"] for e in v["matrix_abs_err"]["one"]])) > max(order_a)}
        for k, v in out.items()}
    print(f"{tag} ep (b) witness: A's parting from one device, median over "
          "the draws, "
          + ", ".join(f"{k} {v['A_median']:.3g}" for k, v in verdict.items())
          + f"; a summation order's over all {len(order_a)} draws "
          f"{_spread(order_a)}; beyond its largest: "
          + ", ".join(f"{k} {v['beyond_order_max']}"
                      for k, v in verdict.items()))
    out["verdict"] = verdict
    out["order_A"] = order_a
    out["seconds"] = time.perf_counter() - t_phase
    print(f"ep (b) witness: {out['seconds']:.1f} s")
    return out


# -- CDC's row lanes (phase 24) ----------------------------------------------

LANES = 4                       # cdc.parallel_rows of (b) and (c)
LANE_STEPS = (3, 7, 11, 1)      # (a): each lane's Adam step
LANE_DEMOTE = 100               # (a): fields over this many ids take the
#                                 row path, so some row ids lie in the
#                                 small-field prefix
LANE_ROW_GAP = 1e-6             # (b): lane row 0 vs serial row 0
LANES_CAUSAL = 4                # (b): mask rows, cut from phase 17's 50
#                                 (phases 21 and 23 run 4) to keep the
#                                 script inside its time limit
LANES_TURNS = (LANES, 0)        # (b): the lanes, then the serial rows
#                                 (the updates, and (c), with --phase 24
#                                 alone: phase 25 (a) holds lane updates
#                                 bitwise repeatable, fit against fit, and
#                                 phase 26 (b) the lanes on the mesh)


def lanes_update_checks(dev):
    """Phase 24 (a): EmbeddingUpdater.update_stacked on the card at the
    flagship table, LANES lanes at steps LANE_STEPS, bf16 and float32
    moments, against LANES updates of the plain version on the CPU (each
    lane's block as phase 7 holds the table update): 512 rows a lane with
    duplicate big-field ids, row ids in the small-field prefix (fields
    over LANE_DEMOTE ids on the row path), ids past the table and below
    0; bitwise repeatable; a lane left out of ``active`` keeps its block
    bitwise; one sweep launch a lane.  -> max abs error."""
    from tpurec_torch.config import TrainConfig
    from tpurec_torch.nn.core import EmbeddingLayout
    from tpurec_torch.ops.fused_adam import (fused_decay_adam,
                                             fused_sparse_adam)
    from tpurec_torch.train.hybrid import EmbeddingUpdater
    from tpurec_torch.train.sparse import SparseEmbedState

    N, F = len(LANE_STEPS), len(FIELD_DIMS)
    V, D = EmbeddingLayout(FIELD_DIMS).vocab, MODEL["embed_dim"]
    gen = torch.Generator().manual_seed(SEED + 24)
    rng = np.random.default_rng(SEED + 24)
    table = torch.randn(V, D, generator=gen) * 0.01
    x = np.stack([random_ids(rng, 512) for _ in range(N)])
    x[:, :256, 0] = x[:, 256:, 0]                   # duplicates
    big = int(np.argmax(FIELD_DIMS))
    x[1, ::3, big] = FIELD_DIMS[big] + 10**7        # past the table
    off = int(EmbeddingLayout(FIELD_DIMS).offsets[big])
    x[2, ::5, big] = -off - 5                       # row -5: below 0
    x = torch.from_numpy(x)
    g = torch.randn(N, 512 * F, D, generator=gen)
    err, worst_all = 0.0, 0.0
    for mdt in (torch.bfloat16, torch.float32):
        upd = EmbeddingUpdater(FIELD_DIMS, TrainConfig(
            bs=512, embedding_moments_dtype=str(mdt)[6:]), L2, LANE_DEMOTE)
        check(any(f not in upd.small and FIELD_DIMS[f] <= 8192
                  for f in range(F)), "no layout-small field on the row path")
        m0 = (torch.randn(N * V, D, generator=gen) * 0.01).to(mdt)
        v0 = (torch.rand(N * V, D, generator=gen) * 1e-4).to(mdt)
        outs = []
        for active in (None, None, [0, 2, 3]):
            p = table.repeat(N, 1).to(dev)
            st = SparseEmbedState(m=m0.to(dev, copy=True),
                                  v=v0.to(dev, copy=True))
            on = list(range(N)) if active is None else active
            before = (fused_decay_adam.launches, fused_sparse_adam.launches)
            sq = upd.update_stacked(p, st, x[on].to(dev), g[on].to(dev),
                                    [LANE_STEPS[l] for l in on], lanes=N,
                                    active=active)
            torch.cuda.synchronize()
            check((fused_decay_adam.launches - before[0],
                   fused_sparse_adam.launches - before[1]) == (len(on),)
                  * 2, f"update_stacked ({mdt}): one pass a lane expected")
            outs.append(([p.cpu(), st.m.cpu(), st.v.cpu()], sq.cpu()))
            del p, st
        (a, sa), (b, sb), (c, sc) = outs
        check(all(torch.equal(u, w) for u, w in zip(a, b))
              and torch.equal(sa, sb), f"update_stacked ({mdt}): two calls "
              "differ")
        one = slice(V, 2 * V)
        check(torch.equal(c[0][one], table) and torch.equal(c[1][one],
                                                            m0[one])
              and torch.equal(c[2][one], v0[one]),
              f"update_stacked ({mdt}): lane 1, not active, was written")
        for l, i in ((0, 0), (2, 1), (3, 2)):
            rows = slice(l * V, (l + 1) * V)
            check(all(torch.equal(u[rows], w[rows]) for u, w in zip(a, c))
                  and torch.equal(sa[l], sc[i]),
                  f"update_stacked ({mdt}): lane {l} differs with lane 1 "
                  "left out")
        for l in range(N):
            rows = slice(l * V, (l + 1) * V)
            pw = table.clone()
            sw = SparseEmbedState(m=m0[rows].clone(), v=v0[rows].clone())
            sqw = upd.update(pw, sw, x[l], g[l], LANE_STEPS[l])
            xr = x[l]
            ids, gr = upd.big_rows(xr, g[l].reshape(512, F, D))
            gs = upd.small_field_grads(xr, g[l].reshape(512, F, D))
            tc = upd.tcfg
            step = sweep_step(table, m0[rows], v0[rows],
                              dense_grad(V, ids, gr, gs), LANE_STEPS[l],
                              lr=tc.lr, coef=upd.coef, b1=tc.adam_b1,
                              b2=tc.adam_b2, eps=tc.adam_eps)
            e, worst, _ = held_to_plain(
                [a[0][rows], a[1][rows], a[2][rows], sa[l]],
                [pw, sw.m, sw.v, sqw], step,
                f"update_stacked lane {l} ({str(mdt)[6:]} moments)")
            err, worst_all = max(err, e), max(worst_all, worst)
        del outs, a, b, c, m0, v0
    print(f"update_stacked at {N} x {V} x {D} (lanes at steps "
          f"{list(LANE_STEPS)}, 512 rows a lane, duplicate ids, row ids in "
          f"the small-field prefix, ids past the table and below 0; bf16 and "
          f"f32 moments) vs {N} plain-version updates on the CPU: table "
          f"{worst_all:.3g} x max(1, |p'|, step) (tol {ROWS_TOL}), m/v as "
          f"phase 7, max abs err {err:.3g}; one pass a lane, bitwise "
          f"repeatable, a lane left out keeps its block")
    return err


def _cdc_state(tr):
    """Every tensor of a CDCTrainer's state (cloned, by name) and its
    step."""
    out = {f"model/{k}": t.detach().clone()
           for k, t in tr.model.state_dict().items()}
    out["emb/m"] = tr.state.emb_opt.m.clone()
    out["emb/v"] = tr.state.emb_opt.v.clone()
    for i, st in enumerate(tr.state.optimizer.state.values()):
        out.update({f"adam/{i}/{k}": v.clone() for k, v in st.items()})
    return out, tr.state.step


def _keep_schedule(tr):
    """The schedule generators, the batcher's cursors and the clustering
    of ``tr`` (the split's arrays shared, not copied), and its dropout
    generator's state."""
    import copy

    b = tr.train_batcher
    memo = {id(a): a for a in b.dom_X + b.dom_y + b.dom_rows}
    return (copy.deepcopy((tr.np_rng, b, tr.cluster), memo),
            tr.dropout_gen.get_state())


def _put_schedule(tr, kept):
    (tr.np_rng, tr.train_batcher, tr.cluster), gen = kept
    tr.dropout_gen.set_state(gen)


def _lanes_update(tr, lanes, counters):
    """One update_matrix_cdc of ``tr`` from its state with ``lanes`` row
    lanes (0: serial); every generator, the batcher, the clustering and
    (serial) the train state are put back after.  -> {matrices, seconds
    (host clock, synchronized), peak device memory, launches, the
    schedule's valid steps and probe forwards}."""
    import dataclasses

    kept = _keep_schedule(tr)
    blob = None if lanes else tr.snapshot_bytes()
    tr.cfg = dataclasses.replace(tr.cfg, cdc=dataclasses.replace(
        tr.cfg.cdc, parallel_rows=lanes))
    sched = {"steps": 0, "probe": 0}
    populate, baseline = tr._run_populate_async, tr.eval_all_domains

    def populate_(bidx, bmask, bvalid, eidx, emask):
        sched["steps"] += int((bvalid > 0).sum())
        sched["probe"] += int(bidx.shape[0])
        return populate(bidx, bmask, bvalid, eidx, emask)

    def baseline_(idx, mask):
        sched["probe"] += 1
        return baseline(idx, mask)

    tr._run_populate_async, tr.eval_all_domains = populate_, baseline_
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        tr.update_matrix_cdc(tr._scaled_update_matrix_step())
        torch.cuda.synchronize()
    finally:
        del tr._run_populate_async, tr.eval_all_domains
    seconds = time.perf_counter() - t0
    st = tr.cluster
    out = {"mask": st.matrix_mask.copy(), "A": st.matrix_A.copy(),
           "B": st.matrix_B.copy(), "d2g": list(st.domain2group_list),
           "seconds": seconds, "peak_gb": torch.cuda.max_memory_allocated()
           / 2**30, "launches": {k: fn.launches
                                 for k, fn in counters.items()},
           "valid_steps": sched["steps"], "probe_forwards": sched["probe"]}
    _put_schedule(tr, kept)
    if blob is not None:
        tr.restore_bytes(blob)
    return out


def lanes_row_vs_cpu(data, blob, d2g, tag):
    """Phase 24 (b)'s row checks: one mask row (CDC_TREAT domains, 2
    treatment steps at W = 3,584, its probe eval of D * 512 rows) run as
    lane 0 of LANES from the fitted state, dropout 0, wd CDC_CHECK_WD,
    float32 moments (as phase 17's :func:`cdc_row_vs_cpu`), on the card
    and on the CPU's plain path on the card's branches: the row within
    CDC_ROW_TOL of max(1, |x|) and the lane's table after the burst as
    phase 17 holds the table; on
    the card, the serial path's row from the same state against the lane's
    (bitwise expected, LANE_ROW_GAP)."""
    import dataclasses

    from tpurec_torch.cdc import CDCTrainer

    cfg = cdc_config(dropout=0.0, wd=CDC_CHECK_WD,
                     embedding_moments_dtype="float32")
    cfg = dataclasses.replace(cfg, cdc=dataclasses.replace(
        cfg.cdc, parallel_rows=LANES))
    out, masks = {}, []
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        t = CDCTrainer(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX, device=where)
        t.restore_bytes(blob)
        t.setup_data(data.train)
        t.cluster.domain2group = np.asarray(d2g, np.int64)
        bidx, bmask, bvalid = t._multi_burst_sched(
            list(range(CDC_TREAT)), 1, 2)
        eidx, emask = t._eval_sched()
        block = (bidx[None], bmask[None], bvalid[None], eidx[None],
                 emask[None])
        with relu_branches(masks, record=where == "cuda") as branches:
            row = t._run_populate_async(*block)[0].cpu().double()
        V = t.model.embedding.table.shape[0]
        table = t._lanes.table[:V].cpu().clone()
        out[where] = {"row": row, "table": table}
        if where == "cuda":
            t.cfg = dataclasses.replace(t.cfg, cdc=dataclasses.replace(
                t.cfg.cdc, parallel_rows=0))
            out[where]["serial"] = t._run_populate_async(*block)[0].cpu(
                ).double()
        print(f"cdc lane row on {where}: {int(bvalid.sum())} steps of "
              f"{bidx.shape[1]} rows, probe eval of {eidx.size} rows "
              f"({time.perf_counter() - t0:.1f} s)")
        del t
        torch.cuda.empty_cache()
    g, c = out["cuda"], out["cpu"]
    check(branches.used == len(masks) > 0, f"lane row: the CPU replayed "
          f"{branches.used} of the card's {len(masks)} ReLU calls")
    row_err = ((g["row"] - c["row"]).abs()
               / torch.clamp(c["row"].abs(), min=1.0)).max().item()
    diff = (g["table"] - c["table"]).abs()
    share = (diff > 1e-6).float().mean().item()
    gap = (g["row"] - g["serial"]).abs().max().item()
    print(f"{tag} cdc lane row, card vs CPU plain path on the card's "
          f"branches ({branches.flips} inputs on the other branch on the "
          f"CPU; dropout 0, wd "
          f"{CDC_CHECK_WD}, float32 moments): [D] probe row max err "
          f"{row_err:.3g} of max(1, |x|) (tol {CDC_ROW_TOL}); the lane's "
          f"table after the burst max abs err {diff.max().item():.3g} (tol 2 "
          f"lr), share beyond 1e-6 {share:.3g} (tol {CPU_TABLE_SHARE}); "
          f"lane row 0 vs serial row 0 on the card: max abs gap {gap:.3g} "
          f"({'bitwise' if gap == 0 else 'not bitwise'}; tol {LANE_ROW_GAP})")
    check(row_err <= CDC_ROW_TOL, f"lane row: max err {row_err}")
    check(diff.max().item() <= 2 * cfg.train.lr + 1e-6
          and share <= CPU_TABLE_SHARE, f"lane row: table max abs err "
          f"{diff.max().item()}, share beyond 1e-6 {share}")
    check(gap <= LANE_ROW_GAP, f"lane row 0 vs serial row 0: {gap}")
    return {"row_err": row_err, "table_max_abs_err": diff.max().item(),
            "table_share_beyond_1e-6": share, "lane_vs_serial_row0": gap}


def lanes_cdc_config(**train):
    """(b)'s configuration: phase 17's (cdc_config) for one epoch, with
    LANES_CAUSAL causal-mask rows."""
    import dataclasses

    cfg = cdc_config(epoch=1, **train)
    return dataclasses.replace(cfg, cdc=dataclasses.replace(
        cfg.cdc, n_causal_mask=LANES_CAUSAL))


def lanes_rank(out_dir):
    """One rank of phase 24 (c), started by :func:`lanes_main_path` as
    phase 23 starts its ranks: phase 23 (b)'s CDCTrainer on MESH_SHAPE
    with the experts split, LANES row lanes, the split in "stream" (as a
    mesh places a train split over MESH_RESIDENT_BUDGET); its warmup, the
    gathered state (rank 0 writes it), one update_matrix_cdc with the
    launches counted.  Writes ``lanes_rank_<r>.json``."""
    import dataclasses
    import os

    import tpurec_torch.cdc.engine as eng
    from tpurec_torch.cdc import CDCTrainer
    from tpurec_torch.parallel import Shardings, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    j = _join_rank()
    mesh = make_mesh(*MESH_SHAPE)
    cfg = ep_cdc_config()
    cfg = dataclasses.replace(cfg, cdc=dataclasses.replace(
        cfg.cdc, parallel_rows=LANES, data_placement="stream"))
    data = ep_cdc_data()
    tr = CDCTrainer(cfg, EP_CDC_DIMS, EP_CDC_DOMAINS, DOMAIN_IDX,
                    shardings=Shardings(mesh, expert_parallel=True))
    tr.setup_data(data.train, data.valid)
    tr._run_steps("warmup", *tr._warmup_sched())
    blob = tr.snapshot_bytes()
    if j.rank == 0:
        with open(os.path.join(out_dir, "lanes_entry.msgpack"), "wb") as f:
            f.write(blob)
    counters = train_counters("mmoe")
    seeds, update_group = [], eng.update_group

    def update_group_(st, c, w, kmeans_seed=None):
        seeds.append(kmeans_seed)
        return update_group(st, c, w, kmeans_seed=kmeans_seed)

    eng.update_group = update_group_
    try:
        up = _lanes_update(tr, LANES, counters)
    finally:
        eng.update_group = update_group
    rec = {"rank": j.rank, "seeds": seeds, "step": tr.state.step,
           "resident": tr._resident,
           **{k: (v.tolist() if isinstance(v, np.ndarray) else v)
              for k, v in up.items()}}
    with open(os.path.join(out_dir, f"lanes_rank_{j.rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()
    return 0


def lanes_main_path(dev, tag, alone=False):
    """Phase 24: CDC's row lanes.  (a) :func:`lanes_update_checks`.  (b)
    phase 17's configuration (the flagship MMoE as CDC's base, 4
    antipodal domain clusters, B=512, dropout 0.2, bf16 moments) through
    its warmup; ``alone`` (``--phase 24``), update_matrix_cdc from that
    state in LANES lanes, then serially (LANES_TURNS): each update's
    seconds and peak memory printed, finite matrices, the trainer's
    state bitwise unchanged by the lane update, and the kernels'
    launches against the schedule (#1, #2 a valid step and a probe eval,
    #3 and #6/#7's pass a valid step); then :func:`lanes_row_vs_cpu`
    from the state reached.  (c) phase 23 (b)'s configuration on
    MESH_SHAPE over gloo with the experts split and the split streamed
    (:func:`lanes_rank`): one lane update against one device's lanes
    from the mesh's state, matrices at EP_CDC_ATOL, the clustering held
    unless it ties.  -> (launches a rank of (c)'s lane update, summary)."""
    t_phase = time.perf_counter()
    summary = {"a_max_abs_err": lanes_update_checks(dev)}
    summary["b"] = lanes_updates(tag, LANES_TURNS if alone else ())
    summary["c"] = lanes_on_mesh(tag)
    summary["phase_seconds"] = time.perf_counter() - t_phase
    print(f"lanes phase: {summary['phase_seconds']:.1f} s")
    return summary["c"]["launches"], summary


def lanes_updates(tag, turns=LANES_TURNS):
    """Phase 24 (b) (see :func:`lanes_main_path`): the update in each of
    ``turns`` (lanes, 0 = serial; none: the row check from the warmed
    state).  -> summary."""
    from tpurec_torch.cdc import CDCTrainer

    data = cdc_data()
    tr = CDCTrainer(lanes_cdc_config(), FIELD_DIMS, N_DOMAIN, DOMAIN_IDX)
    tr.setup_data(data.train, data.valid, data.test)
    tr._run_steps("warmup", *tr._warmup_sched())
    torch.cuda.synchronize()
    counters = train_counters("mmoe")
    runs = []
    for lanes in turns:
        before, step0 = _cdc_state(tr)
        runs.append(_lanes_update(tr, lanes, counters))
        if lanes:
            after, step1 = _cdc_state(tr)
            moved = [k for k in before if not torch.equal(before[k],
                                                          after[k])]
            check(step1 == step0 and not moved and before.keys()
                  == after.keys(), f"a lane update moved the trainer's "
                  f"state: step {step0} -> {step1}, {moved[:5]}")
            del after
        del before
    summary = {"mask_rows": LANES_CAUSAL}
    if not runs:
        blob, d2g = tr.snapshot_bytes(), list(tr.cluster.domain2group_list)
        del tr
        torch.cuda.empty_cache()
        summary["row"] = lanes_row_vs_cpu(data, blob, d2g, tag)
        return summary
    for lanes, r in zip(turns, runs):
        want = schedule_launches(r["valid_steps"],
                                 r["valid_steps"] + r["probe_forwards"])
        what = f"{lanes} lanes" if lanes else "serial"
        check(r["launches"] == want, f"(b) {what}: launches "
              f"{r['launches']}, expected {want}")
        check(all(np.all(np.isfinite(r[m])) for m in ("mask", "A", "B")),
              f"(b) {what}: a matrix is not finite")
    l1, ser = runs[0], (runs[1] if len(runs) > 1 else None)
    gaps = None if ser is None else {
        m: float(np.abs(l1[m] - ser[m]).max()) for m in ("mask", "A", "B")}
    print(f"{tag} lanes (b) update_matrix_cdc of phase 17's configuration "
          f"({LANES_CAUSAL} mask rows; {l1['valid_steps']} valid steps, "
          f"{l1['probe_forwards']} probe evals), in turns (host clock, "
          f"synchronized): " + ", ".join(
              f"{'lanes' if n else 'serial'} {r['seconds']:.3f} s (peak "
              f"{r['peak_gb']:.2f} GiB)" for n, r in zip(turns, runs))
          + f"; the trainer's state bitwise unchanged by the lanes; "
          f"launches {l1['launches']} (= the schedule); domain2group lanes "
          f"{l1['d2g']}"
          + ("" if ser is None else
             f", serial {ser['d2g']}; lanes vs serial (the documented "
             f"divergence: each row its own moments) max abs {gaps}"))
    summary.update({
        "valid_steps": l1["valid_steps"],
        "probe_forwards": l1["probe_forwards"],
        "seconds": {"lanes" if n else "serial": r["seconds"]
                    for n, r in zip(turns, runs)},
        "peak_gb": {"lanes" if n else "serial": r["peak_gb"]
                    for n, r in zip(turns, runs)},
        "launches": l1["launches"], "lanes_vs_serial": gaps,
        "domain2group": {"lanes" if n else "serial": r["d2g"]
                         for n, r in zip(turns, runs)}})
    blob, d2g = tr.snapshot_bytes(), list(tr.cluster.domain2group_list)
    del tr, runs, l1, ser
    torch.cuda.empty_cache()
    summary["row"] = lanes_row_vs_cpu(data, blob, d2g, tag)
    return summary


def lanes_on_mesh(tag):
    """Phase 24 (c) (see :func:`lanes_main_path`).  -> summary."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from tpurec_torch.cdc import CDCTrainer

    tmp = tempfile.mkdtemp(prefix="lanes_")
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    t0 = time.perf_counter()
    rcs, tails = _spawn_ranks(world, tmp, flag="--lanes-rank")
    ranks_s = time.perf_counter() - t0
    check(rcs == [0] * world, f"phase 24 ranks exited {rcs}:\n{tails}")
    recs = []
    for r in range(world):
        with open(os.path.join(tmp, f"lanes_rank_{r}.json")) as f:
            recs.append(json.load(f))
    cfg = ep_cdc_config()
    cfg = dataclasses.replace(cfg, cdc=dataclasses.replace(
        cfg.cdc, parallel_rows=LANES))
    ep_data = ep_cdc_data()
    one = CDCTrainer(cfg, EP_CDC_DIMS, EP_CDC_DOMAINS, DOMAIN_IDX)
    one.setup_data(ep_data.train, ep_data.valid)
    one._run_steps("warmup", *one._warmup_sched())
    with open(os.path.join(tmp, "lanes_entry.msgpack"), "rb") as f:
        one.restore_bytes(f.read())
    ref = _lanes_update(one, LANES, train_counters("mmoe"))
    r0 = recs[0]
    for r in recs:
        want = schedule_launches(r["valid_steps"],
                                 r["valid_steps"] + r["probe_forwards"])
        check(not r["resident"], f"(c) rank {r['rank']}: the split resident")
        check(r["launches"] == want and r["d2g"] == r0["d2g"],
              f"(c) rank {r['rank']}: launches {r['launches']} (expected "
              f"{want}), clustering {r['d2g']} (rank 0's {r0['d2g']})")
    errs = {m: float(np.abs(np.asarray(r0[m]) - ref[m]).max())
            for m in ("mask", "A", "B")}
    n_cluster = cfg.cdc.n_cluster
    seed = r0["seeds"]
    check(len(seed) == 1, f"(c) k-means seeds {seed}")
    own, moved = clustering_tie(ref["mask"], n_cluster, seed[0], EP_CDC_ATOL)
    tied = len(moved) > 1
    print(f"{tag} lanes (c) update_matrix_cdc in {LANES} lanes on "
          f"{MESH_SHAPE} over gloo with the experts split and the split "
          f"streamed on every rank ({world} ranks in "
          f"{ranks_s:.1f} s, start-up included; {r0['valid_steps']} valid "
          f"lane-steps, {r0['seconds']:.3f} s) against one device's lanes "
          f"from the mesh's state ({ref['seconds']:.3f} s): matrices max abs "
          f"err {errs} (tol {EP_CDC_ATOL}); domain2group mesh {r0['d2g']}, "
          f"one device {ref['d2g']}; moved by +-{EP_CDC_ATOL}: {moved} ("
          + ("a tie: compared, not held" if tied else "held") + f"); "
          f"launches a rank {r0['launches']}")
    check(all(v <= EP_CDC_ATOL for v in errs.values()),
          f"(c) matrices vs one device's lanes: {errs}")
    check(own == tuple(ref["d2g"]), f"(c) reclustering gives {own}, one "
          f"device's {ref['d2g']}")
    check(tied or r0["d2g"] == ref["d2g"], f"(c) domain2group {r0['d2g']} "
          f"vs one device's {ref['d2g']}")
    del one, ep_data
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"matrix_abs_err": errs, "domain2group": r0["d2g"],
            "one_device_domain2group": ref["d2g"],
            "clustering_moved": {str(list(k)): n for k, n in moved.items()},
            "launches": r0["launches"], "seconds": r0["seconds"],
            "one_device_seconds": ref["seconds"], "ranks_seconds": ranks_s}


# -- CDC as its users run it: "stream", three updates a fit (phase 25) --------

STREAM_CAUSAL = EP_CDC_CAUSAL   # (a): causal-mask rows (CDCConfig(): 50)
STREAM_WARMUP = 10              # (a): warmup_step, 20 steps of 512 rows
STREAM_INTERVAL = 10            # (a): update_interval: a boundary every 20
#                                 steps, so the epoch of about 58 steps
#                                 updates before steps 0, 19 and 39
STREAM_MIN_UPDATES = 3
# (a)'s fits, one initial state: (name, data_placement, parallel_rows,
# compute_dtype); (ii) must equal (i) and (iv) equal (iii) bitwise
STREAM_FITS = (("i", "resident", 0, "float32"),
               ("ii", "stream", 0, "float32"),
               ("iii", "resident", LANES, "float32"),
               ("iv", "stream", LANES, "float32"),
               ("v", "stream", LANES, "bfloat16"))
STREAM_CHECKED = (1, 2)         # (a): updates 2 and 3, rows vs the CPU
STREAM_ROWS = 52_000_000        # (b): make_synthetic rows; the 46.8M-row
#                                 train split (4.49 GB) is over
#                                 CDCTrainer.RESIDENT_BUDGET (4 GiB)
STREAM_SPAN = 1999              # (b): steps 0-1998, then the update before
#                                 step 1999 (update_interval 1000 x 1024 /
#                                 512 = 2000 steps)
STREAM_RESIDENT_SPAN = 1024     # (b): steps with the split on the card, then
#                                 as many back in host memory
SINGLES = ("pepnet-single", "epnet-single")


def stream_config(placement="auto", lanes=0, cut=True, **train):
    """Phase 25's configuration: CDCConfig()'s defaults on PLE at
    ModelConfig()'s widths (:func:`cdc_config` with base "ple"), one
    epoch, the split at ``placement`` and ``lanes`` row lanes; ``cut``
    ((a)) takes STREAM_CAUSAL mask rows, STREAM_WARMUP and
    STREAM_INTERVAL."""
    import dataclasses

    cfg = cdc_config(base="ple", epoch=1, **train)
    cut_kw = (dict(n_causal_mask=STREAM_CAUSAL, warmup_step=STREAM_WARMUP,
                   update_interval=STREAM_INTERVAL) if cut else {})
    return dataclasses.replace(cfg, cdc=dataclasses.replace(
        cfg.cdc, data_placement=placement, parallel_rows=lanes, **cut_kw))


def _observe_updates(tr, X, counters, keep=(), on_block=None,
                     domain_idx=DOMAIN_IDX):
    """Wrap ``tr``'s entry points for phases 25 and 26 -> (record, undo).
    The record holds every hybrid step's loss (tensors; the lanes' steps
    discard theirs), the warmup's and the spans' steps and the spans'
    seconds, the peak device memory over the run, and per matrix update:
    its seconds (host clock, synchronized), the seconds of its ``_feed``
    calls inside (the host window's gather and copy under "stream", the
    index copies under "resident"; each synchronized), the collectives'
    calls and host seconds inside (``collectives.STATS``; none without a
    mesh), peak device memory, the launches of ``counters`` beside its
    schedule (valid steps, probe forwards), the raw matrices and k-means
    seed update_group received and the clustering it gave, and the
    domains each B row trained (from the host split ``X``).  For an
    update whose index is in ``keep``: its entry state (gathered on a
    mesh: every rank keeps) and clustering, its mask row with the fewest
    valid steps (the cheapest to replay on the CPU), its mask row 0 and
    its B row with the most.  ``on_block(tr, u, i, record)`` runs at the
    entry of update u's populate block i (``record``: the update's so
    far)."""
    import tpurec_torch.cdc.engine as eng
    from tpurec_torch.parallel.collectives import STATS

    rec = {"losses": [], "updates": [], "feed_seconds": 0.0,
           "warmup_steps": 0, "span_steps": 0, "span_seconds": 0.0,
           "peak_gb": 0.0}
    steps, populate, baseline, feed = (tr._steps, tr._run_populate_async,
                                       tr.eval_all_domains, tr._feed)
    update, span, warmup = (tr.update_matrix_cdc, tr._train_span,
                            tr._warmup_sched)
    update_group = eng.update_group
    cur = {}

    def steps_(mode, *args):
        out = steps(mode, *args)
        rec["losses"].extend(out)
        return out

    def feed_(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = feed(*args)
        torch.cuda.synchronize()
        rec["feed_seconds"] += time.perf_counter() - t0
        return out

    def populate_(bidx, bmask, bvalid, eidx, emask):
        u = cur["u"]
        block = len(u["blocks"])
        valid = bvalid > 0
        n = valid.sum(1)
        u["blocks"].append([int(bidx.shape[0]), int(n.sum()),
                            int(bidx.shape[-1])])
        u["valid_steps"] += int(n.sum())
        u["probe_forwards"] += int(bidx.shape[0])

        def row(r):
            return tuple(a[r].copy() for a in (bidx, bmask, bvalid, eidx,
                                               emask))

        if block == 2:
            u["b_rows"] = [sorted({int(d) for d in X[bidx[r][valid[r]][
                bmask[r][valid[r]] > 0], domain_idx]})
                for r in range(bidx.shape[0])]
        if u["keep"] and block == 0:
            r = int(np.argmin(np.where(n > 0, n, 1 << 30)))
            u["mask_row"] = (r, row(r))
            u["row0"] = row(0)
        if u["keep"] and block == 2:
            r = int(np.argmax(n))
            u["b_row"] = (r, row(r))
        if on_block is not None:
            on_block(tr, len(rec["updates"]), block, u)
        return populate(bidx, bmask, bvalid, eidx, emask)

    def baseline_(idx, mask):
        cur["u"]["probe_forwards"] += 1
        return baseline(idx, mask)

    def update_group_(st, cfg, w, kmeans_seed=None):
        cur["u"].update(mask=st.matrix_mask.copy(), A=st.matrix_A.copy(),
                        B=st.matrix_B.copy(), seed=kmeans_seed)
        return update_group(st, cfg, w, kmeans_seed=kmeans_seed)

    def update_(k):
        u = {"valid_steps": 0, "probe_forwards": 0, "blocks": [],
             "keep": len(rec["updates"]) in keep}
        if u["keep"]:
            u["entry"] = tr.snapshot_bytes()
            u["entry_d2g"] = list(tr.cluster.domain2group_list)
        cur["u"] = u
        before = {n: fn.launches for n, fn in counters.items()}
        f0, c0 = rec["feed_seconds"], dict(STATS)
        torch.cuda.synchronize()
        rec["peak_gb"] = max(rec["peak_gb"],
                             torch.cuda.max_memory_allocated() / 2**30)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        update(k)
        torch.cuda.synchronize()
        u["seconds"] = time.perf_counter() - t0
        u["feed_seconds"] = rec["feed_seconds"] - f0
        u["coll_seconds"] = STATS["seconds"] - c0["seconds"]
        u["coll_calls"] = STATS["calls"] - c0["calls"]
        u["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
        rec["peak_gb"] = max(rec["peak_gb"], u["peak_gb"])
        u["launches"] = {n: fn.launches - before[n]
                         for n, fn in counters.items()}
        u["d2g"] = [int(g) for g in tr.cluster.domain2group_list]
        rec["updates"].append(u)

    def span_(seq, lo, hi):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = span(seq, lo, hi)               # ends in its loss fetch
        rec["span_seconds"] += time.perf_counter() - t0
        rec["span_steps"] += hi - lo
        return out

    def warmup_():
        out = warmup()
        rec["warmup_steps"] += len(out[0])
        return out

    names = ("_steps", "_feed", "_run_populate_async", "eval_all_domains",
             "update_matrix_cdc", "_train_span", "_warmup_sched")
    for name, fn in zip(names, (steps_, feed_, populate_, baseline_,
                                update_, span_, warmup_)):
        setattr(tr, name, fn)
    eng.update_group = update_group_

    def undo():
        for name in names:
            delattr(tr, name)
        eng.update_group = update_group
        rec["peak_gb"] = max(rec["peak_gb"],
                             torch.cuda.max_memory_allocated() / 2**30)

    return rec, undo


def _check_update_launches(u, what):
    want = schedule_launches(u["valid_steps"],
                              u["valid_steps"] + u["probe_forwards"])
    check(u["launches"] == want, f"{what}: launches {u['launches']}, the "
          f"schedule {want}")
    check(all(np.all(np.isfinite(u[m])) for m in ("mask", "A", "B")),
          f"{what}: a matrix is not finite")


def _update_line(u):
    return (f"{u['seconds']:.3f} s (_feed {u['feed_seconds']:.3f} s, "
            f"{100 * u['feed_seconds'] / u['seconds']:.1f}%; peak "
            f"{u['peak_gb']:.2f} GiB; {u['valid_steps']} valid steps, "
            f"{u['probe_forwards']} probe evals) -> {u['d2g']}")


def stream_fit(data, counters, cfg, keep=(), shardings=None, on_block=None,
               what="(a)", min_updates=STREAM_MIN_UPDATES):
    """One of phase 25 (a)'s (or 26 (b)'s, or 23 (b)'s streamed) fits:
    CDCTrainer.fit(train, valid) at ``cfg`` on phase 23 (b)'s data, on
    the mesh of ``shardings`` if given, observed
    (:func:`_observe_updates`, ``keep`` and ``on_block`` passed on), at
    least ``min_updates`` matrix updates, the counters read around it
    against the schedule, fit-wide and update by update.  -> record."""
    from tpurec_torch.cdc import CDCTrainer

    placement, lanes = cfg.cdc.data_placement, cfg.cdc.parallel_rows
    tr = CDCTrainer(cfg, EP_CDC_DIMS, EP_CDC_DOMAINS, DOMAIN_IDX,
                    shardings=shardings)
    rec, undo = _observe_updates(tr, data.train[0], counters, keep,
                                 on_block)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = tr.fit(data.train, data.valid)
        torch.cuda.synchronize()
    finally:
        undo()
    rec["fit_seconds"] = time.perf_counter() - t0
    what = (f"{what} {placement}, {f'{lanes} lanes' if lanes else 'serial'}"
            f", {cfg.train.compute_dtype}")
    check(tr._resident == (placement == "resident"),
          f"{what}: resident {tr._resident}")
    ups = rec["updates"]
    check(len(ups) >= min_updates, f"{what}: {len(ups)} updates")
    for i, u in enumerate(ups):
        _check_update_launches(u, f"{what}, update {i + 1}")
    n_steps = (rec["warmup_steps"] + sum(u["valid_steps"] for u in ups)
               + rec["span_steps"])
    n_fwd = (n_steps + sum(u["probe_forwards"] for u in ups)
             + tr._padded_split(tr.valid_batcher)[6])
    rec["launches"] = {k: fn.launches for k, fn in counters.items()}
    want = schedule_launches(n_steps, n_fwd)
    check(rec["launches"] == want, f"{what}: the fit's launches "
          f"{rec['launches']}, the schedule {want}")
    rec["losses"] = [float(x) for x in rec["losses"]]
    rec["state"] = tr.snapshot_bytes()
    rec["auc"] = out["valid"]["total_auc"]
    rec["cluster_matrices"] = {"mask": tr.cluster.matrix_mask,
                               "A": tr.cluster.matrix_A,
                               "B": tr.cluster.matrix_B}
    del tr
    torch.cuda.empty_cache()
    return rec


def _fits_bitwise(A, B):
    """Which of two :func:`stream_fit` records are bitwise equal: every
    loss, each update's matrices, the k-means seeds and clusterings, the
    final state."""
    return {
        "losses": A["losses"] == B["losses"],
        "matrices": len(A["updates"]) == len(B["updates"]) and all(
            np.array_equal(ua[m], ub[m]) for ua, ub in
            zip(A["updates"], B["updates"]) for m in ("mask", "A", "B")),
        "clusterings": [u["d2g"] for u in A["updates"]]
        == [u["d2g"] for u in B["updates"]]
        and [u["seed"] for u in A["updates"]]
        == [u["seed"] for u in B["updates"]],
        "state": A["state"] == B["state"]}


def stream_fits(tag):
    """Phase 25 (a) (see :func:`stream_main_path`).  -> (launches by fit,
    summary)."""
    data = ep_cdc_data()
    X, y = data.train
    counters = train_counters("ple")
    fits = {}
    for key, placement, lanes, dtype in STREAM_FITS:
        fits[key] = f = stream_fit(
            data, counters, stream_config(placement, lanes,
                                          compute_dtype=dtype),
            STREAM_CHECKED if key in ("ii", "iv") else ())
        print(f"{tag} stream (a) ({key}) CDCTrainer.fit of PLE, "
              f"{placement}, {f'{lanes} lanes' if lanes else 'serial'}, "
              f"{dtype}: "
              f"{f['warmup_steps']} warmup steps, {len(f['updates'])} "
              f"updates, {f['span_steps']} split-mode steps "
              f"({f['span_seconds'] / f['span_steps'] * 1e3:.3f} ms a step), "
              f"fit {f['fit_seconds']:.2f} s, valid total_auc "
              f"{f['auc']:.5f}; launches {f['launches']} (= the schedule)")
        for i, u in enumerate(f["updates"]):
            print(f"    update {i + 1}: {_update_line(u)}; B rows trained "
                  + ", ".join(f"{r}: {d}" for r, d in enumerate(u["b_rows"])
                              if d))
    same = {}
    for a, b in (("i", "ii"), ("iii", "iv")):
        same[f"{b}_vs_{a}"] = s = _fits_bitwise(fits[a], fits[b])
        check(all(s.values()), f"(a) ({b}) stream vs ({a}) resident: {s}")
    ratio = {k: [fits[b]["updates"][i]["seconds"]
                 / fits[a]["updates"][i]["seconds"]
                 for i in range(len(fits[a]["updates"]))]
             for k, (a, b) in (("serial", ("i", "ii")),
                               ("lanes", ("iii", "iv")))}
    print(f"{tag} stream (a) \"stream\" bitwise \"resident\" over "
          f"{len(fits['i']['updates'])} updates (every loss, the matrices, "
          f"the clusterings and the final state), serially and in {LANES} "
          f"lanes; stream's update seconds over resident's: serial "
          + ", ".join(f"{x:.3f}" for x in ratio["serial"]) + "; lanes "
          + ", ".join(f"{x:.3f}" for x in ratio["lanes"]))
    rows = {}
    check_cfg = stream_config(dropout=0.0, wd=CDC_CHECK_WD,
                              embedding_moments_dtype="float32")
    for key, lanes in (("ii", 0), ("iv", LANES)):
        for i in STREAM_CHECKED:
            u = fits[key]["updates"][i]
            r, row = u["mask_row" if lanes == 0 else "b_row"]
            what = (f"cdc ple update {i + 1} "
                    + (f"mask row {r}" if lanes == 0
                       else f"B row {r} as lane 0 of {LANES}"))
            rows[f"{key}_update{i + 1}"] = populate_row_vs_cpu(
                check_cfg, X, y, EP_CDC_DIMS, EP_CDC_DOMAINS, u["entry"],
                u["entry_d2g"], row, lanes, tag, what)
    v = fits["v"]
    check(np.isfinite(v["auc"]) and all(
        np.all(np.isfinite(m)) for m in v["cluster_matrices"].values()),
        f"(a) (v) bf16: valid AUC {v['auc']}, matrices finite?")
    print(f"{tag} stream (a) (v) bf16 compute, stream, {LANES} lanes: "
          f"finite matrices; valid total_auc {v['auc']:.5f} beside (iv)'s "
          f"float32 {fits['iv']['auc']:.5f}")
    summary = {
        "bitwise": same, "stream_over_resident_update_seconds": ratio,
        "rows_vs_cpu": rows,
        "fits": {k: {"placement": p, "lanes": n, "dtype": d,
                     "valid_total_auc": fits[k]["auc"],
                     "fit_seconds": fits[k]["fit_seconds"],
                     "warmup_steps": fits[k]["warmup_steps"],
                     "span_steps": fits[k]["span_steps"],
                     "span_ms_a_step": fits[k]["span_seconds"]
                     / fits[k]["span_steps"] * 1e3,
                     "launches": fits[k]["launches"],
                     "updates": [{x: u[x] for x in (
                         "seconds", "feed_seconds", "peak_gb",
                         "valid_steps", "probe_forwards", "blocks", "d2g",
                         "b_rows", "launches")} for u in fits[k]["updates"]]}
                 for k, p, n, d in STREAM_FITS}}
    launches = {k: fits[k]["launches"] for k, *_ in STREAM_FITS}
    del fits
    return launches, summary


def single_row_vs_cpu(name, tag):
    """Phase 18 (d): ``pepnet-single`` and ``epnet-single``, which CDC
    takes as no base in either package (``CDC_BASE_MODELS``: a base has a
    tower a cluster), through phase 18 (c)'s check with their own hybrid
    step: from the seeded weights at ModelConfig's widths, every vector
    that starts at zero (the biases and shifts) drawn N(0, 0.1**2) as
    phase 18 (c) draws STAR's shifts (a zero bias before a training
    BatchNorm has a gradient that is rounding alone, which wd * bias then
    outweighs), dropout 0, wd CDC_CHECK_WD, float32 moments: a burst of 2 steps at W = 3,584 rows
    (7 domains' batches each, from phase 17's data) and the per-domain
    probe loss (cdc.engine.probe_loss) of one 512-row batch a domain
    (25,600 rows), on the card and on the CPU's plain path on the card's
    branches: the [D] row within CDC_ROW_TOL of max(1, |x|), the losses
    within CPU_LOSS_RTOL, the table after the burst within 2 lr
    (CPU_TABLE_SHARE beyond 1e-6); #1, #2 a step and the eval forward,
    #3 and #6/7's pass a step.  -> summary."""
    from tpurec_torch.cdc.engine import probe_loss
    from tpurec_torch.config import ModelConfig, TrainConfig
    from tpurec_torch.data.loader import DomainBatcher
    from tpurec_torch.models import build_model

    Xtr, ytr = cdc_data().train
    batcher = DomainBatcher(Xtr, ytr, DOMAIN_IDX, N_DOMAIN, 512,
                            rng=np.random.default_rng(SEED + 25))
    W, ebs = 7 * 512, 512
    bidx, bmask = np.zeros((2, W), np.int64), np.zeros((2, W), np.float32)
    for s in range(2):
        idx = np.concatenate([batcher.next_idx(d)
                              for d in range(7 * s, 7 * s + 7)])
        bidx[s, :len(idx)], bmask[s, :len(idx)] = idx, 1.0
    eidx = np.zeros((N_DOMAIN, ebs), np.int64)
    emask = np.zeros((N_DOMAIN, ebs), np.float32)
    for d in range(N_DOMAIN):
        idx = batcher.next_idx(d)
        eidx[d, :len(idx)], emask[d, :len(idx)] = idx, 1.0
    tcfg = TrainConfig(bs=512, wd=CDC_CHECK_WD,
                       embedding_moments_dtype="float32")
    masks, out = [], {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                            ModelConfig(model=name, **NO_DROPOUT),
                            device=where,
                            generator=torch.Generator().manual_seed(SEED + 25))
        gen = torch.Generator().manual_seed(SEED + 26)
        with torch.no_grad():
            for p in model.parameters():
                if p.dim() == 1 and not p.any():
                    p.copy_(0.1 * torch.randn(p.shape, generator=gen))
        dev = model.embedding.table.device
        ts = train_state(model, tcfg, dev)
        step = train_step_of(model, tcfg, name)
        counters = train_counters(name)
        for fn in counters.values():
            fn.launches = 0

        def batch(idx, mask, dev=dev):
            x = torch.from_numpy(Xtr[idx]).to(dev)
            return {"x": x, "y": torch.from_numpy(ytr[idx]).to(dev),
                    "group": x[:, DOMAIN_IDX] % N_TOWER,
                    "mask": torch.from_numpy(mask).to(dev)}

        with relu_branches(masks, record=where == "cuda") as branches:
            losses = [float(step(ts, batch(bidx[s], bmask[s]), None))
                      for s in range(2)]
            e = batch(eidx.ravel(), emask.ravel())
            model.eval()
            with torch.no_grad():
                vals = model(e["x"], group=e["group"], train=False)
            row = probe_loss(vals.reshape(N_DOMAIN, ebs),
                             e["y"].reshape(N_DOMAIN, ebs),
                             e["mask"].reshape(N_DOMAIN, ebs))
        check(vals.shape == (N_DOMAIN * ebs,), f"{name}: eval logits "
              f"{tuple(vals.shape)}, one tower expected")
        out[where] = {"row": row.cpu().double(), "losses": losses,
                      "table": model.embedding.table.detach().cpu().clone(),
                      "launches": {k: fn.launches
                                   for k, fn in counters.items()}}
        print(f"{name} burst on {where}: 2 steps of {W} rows "
              f"({int((bmask == 0).sum())} masked), losses {losses}, probe "
              f"eval of {eidx.size} rows ({time.perf_counter() - t0:.1f} s)")
        del model, ts, step, e, vals
        torch.cuda.empty_cache()
    g, c = out["cuda"], out["cpu"]
    check(branches.used == len(masks) > 0, f"{name}: the CPU replayed "
          f"{branches.used} of the card's {len(masks)} ReLU calls")
    check(g["launches"] == schedule_launches(2, 3),
          f"{name}: launches {g['launches']} for 2 steps and an eval")
    row_err = ((g["row"] - c["row"]).abs()
               / torch.clamp(c["row"].abs(), min=1.0)).max().item()
    diff = (g["table"] - c["table"]).abs()
    share = (diff > 1e-6).float().mean().item()
    loss_rel = max(abs(a / b - 1) for a, b in zip(g["losses"], c["losses"]))
    print(f"{tag} {name} burst row (phase 18 (c)'s check through its own "
          f"step), card vs CPU plain path on the card's branches "
          f"({branches.flips} inputs on the other branch on the CPU): [D] "
          f"probe row max err {row_err:.3g} of max(1, |x|) (tol "
          f"{CDC_ROW_TOL}); step loss max rel err {loss_rel:.3g}; table "
          f"after the burst max abs err {diff.max().item():.3g} (tol 2 lr), "
          f"share beyond 1e-6 {share:.3g} (tol {CPU_TABLE_SHARE}); "
          f"launches {g['launches']}")
    check(row_err <= CDC_ROW_TOL, f"{name}: row max err {row_err}")
    check(loss_rel <= CPU_LOSS_RTOL, f"{name}: loss rel err {loss_rel}")
    check(diff.max().item() <= 2 * tcfg.lr + 1e-6
          and share <= CPU_TABLE_SHARE, f"{name}: table max abs err "
          f"{diff.max().item()}, share beyond 1e-6 {share}")
    return {"row_err": row_err, "loss_rel_err": loss_rel,
            "table_max_abs_err": diff.max().item(),
            "table_share_beyond_1e-6": share, "launches": g["launches"],
            "flips": branches.flips}


def stream_at_scale(tag, rows=STREAM_ROWS):
    """Phase 25 (b), ``--phase 25 [--rows N]``: CDC on PLE at CDCConfig()'s
    defaults with the train split over the card's budget.
    make_synthetic(``rows``) at the flagship schema (50 domains, 4
    antipodal clusters); CDCTrainer's "auto" placement must choose
    "stream".  Driven in train_cdc_epoch's own order through its first
    interval: the warmup, the update before step 0, steps 0-1998, the
    update before step 1999 serially, then the same update in LANES lanes
    from the same state; then in turns STREAM_RESIDENT_SPAN steps with
    the split moved onto the card (the "resident" placement, 4.49 GB of
    80) and as many with it back in host memory.  Each update's seconds, its host window's share, peak device
    memory and launches against its schedule; finite matrices; the valid
    AUC after the second update; one of its mask rows against the CPU
    (:func:`populate_row_vs_cpu`); the spans' ms a step; host peak RSS.
    -> summary."""
    import dataclasses
    import resource

    from tpurec_torch.cdc import CDCTrainer
    from tpurec_torch.data import make_synthetic

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    data = make_synthetic(
        n_rows=rows, n_fields=len(FIELD_DIMS), n_domain=N_DOMAIN,
        field_dims=FIELD_DIMS, domain_idx=DOMAIN_IDX, seed=1,
        domain_cluster_k=N_TOWER, domain_cluster_conflict=True)
    train, valid = data.train, data.valid
    del data
    data_s = time.perf_counter() - t0
    nbytes = train[0].nbytes + train[1].nbytes
    tr = CDCTrainer(stream_config(cut=False), FIELD_DIMS, N_DOMAIN,
                    DOMAIN_IDX)
    t0 = time.perf_counter()
    tr.setup_data(train, valid)
    setup_s = time.perf_counter() - t0
    check(tr._resident is False, f"(b) a {nbytes / 1e9:.2f} GB train split "
          f"stayed resident (budget {tr.RESIDENT_BUDGET / 2**30:.3g} GiB)")
    print(f"{tag} stream (b) make_synthetic({rows} rows) {data_s:.1f} s; "
          f"train split {len(train[1])} rows = {nbytes / 1e9:.3f} GB, over "
          f"the {tr.RESIDENT_BUDGET / 2**30:.3g} GiB budget: \"auto\" chose "
          f"\"stream\"; setup_data {setup_s:.1f} s")
    counters = train_counters("ple")
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rec, undo = _observe_updates(tr, train[0], counters, keep=(1,))
    k = tr._scaled_update_matrix_step()
    try:
        # train_cdc_epoch(0)'s order (tpurec_torch/cdc/engine.py)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr._run_steps("warmup", *tr._warmup_sched())
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        seq = tr.train_batcher.epoch_seq()
        interval = (tr.cfg.cdc.update_interval * 1024) // tr.cfg.train.bs
        check((STREAM_SPAN + 1) % interval == 0
              and len(seq) >= STREAM_SPAN + 2 * STREAM_RESIDENT_SPAN,
              f"(b) step {STREAM_SPAN} is no boundary of {interval} or the "
              f"epoch has {len(seq)} steps")
        tr.update_matrix_cdc(k)
        tr._train_span(seq, 0, 1)
        tr._train_span(seq, 1, STREAM_SPAN)
        kept = _keep_schedule(tr)
        tr.update_matrix_cdc(k)                   # serial
        t0 = time.perf_counter()
        ev = tr.evaluate(tr.valid_batcher)
        eval_s = time.perf_counter() - t0
        n_eval = tr._padded_split(tr.valid_batcher)[6]
        _put_schedule(tr, kept)
        tr.restore_bytes(rec["updates"][1]["entry"])
        tr.cfg = dataclasses.replace(tr.cfg, cdc=dataclasses.replace(
            tr.cfg.cdc, parallel_rows=LANES))
        tr.update_matrix_cdc(k)                   # the same, in lanes
        # in turns, the split on the card, then in host memory again
        span_s, span_n = rec["span_seconds"], rec["span_steps"]
        tr.Xdev, tr.ydev = tr._dev(train[0]), tr._dev(train[1])
        tr._resident = True
        lo = STREAM_SPAN
        tr._train_span(seq, lo, lo + STREAM_RESIDENT_SPAN)
        res_s = rec["span_seconds"] - span_s
        tr.Xdev = tr.ydev = None
        tr._resident = False
        lo += STREAM_RESIDENT_SPAN
        tr._train_span(seq, lo, lo + STREAM_RESIDENT_SPAN)
        again_s = rec["span_seconds"] - span_s - res_s
    finally:
        undo()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    u1, u2, u2l = rec["updates"]
    for u, what in ((u1, "update 1"), (u2, "update 2 serial"),
                    (u2l, f"update 2 in {LANES} lanes")):
        _check_update_launches(u, f"(b) {what}")
    check(u2l["valid_steps"] == u2["valid_steps"]
          and u2l["blocks"] == u2["blocks"],
          f"(b) the lane update ran {u2l['blocks']}, the serial {u2['blocks']}")
    n_steps = (rec["warmup_steps"] + rec["span_steps"]
               + sum(u["valid_steps"] for u in rec["updates"]))
    check(rec["warmup_steps"] == 400 and span_n == STREAM_SPAN,
          f"(b) {rec['warmup_steps']} warmup and {span_n} span steps")
    launches = {name: fn.launches for name, fn in counters.items()}
    want = schedule_launches(n_steps, n_steps + n_eval + sum(
        u["probe_forwards"] for u in rec["updates"]))
    check(launches == want, f"(b) launches {launches}, the schedule {want}")
    auc = ev["total_auc"]
    check(np.isfinite(auc), f"(b) valid total_auc {auc}")
    span_ms = span_s / span_n * 1e3
    resident_ms = res_s / STREAM_RESIDENT_SPAN * 1e3
    again_ms = again_s / STREAM_RESIDENT_SPAN * 1e3
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"{tag} stream (b) warmup {rec['warmup_steps']} steps "
          f"{warm_s:.2f} s; update 1 {_update_line(u1)}; steps 0-"
          f"{STREAM_SPAN - 1}: {span_ms:.3f} ms a step (host clock); in "
          f"turns, {STREAM_RESIDENT_SPAN} steps with the split moved onto "
          f"the card {resident_ms:.3f}, then {STREAM_RESIDENT_SPAN} back in "
          f"host memory {again_ms:.3f}; update 2 serial {_update_line(u2)}; update 2 in {LANES} "
          f"lanes {_update_line(u2l)}; valid total_auc after update 2 "
          f"{auc:.5f} ({len(valid[1])} rows, {eval_s:.1f} s); device peak "
          f"{peak_gb:.2f} GiB; host peak RSS {rss_gb:.2f} GiB; "
          f"{n_steps} hybrid steps, launches {launches} against the "
          "schedule, update by update too")
    r, row = u2["mask_row"]
    row_check = populate_row_vs_cpu(
        stream_config(cut=False, dropout=0.0, wd=CDC_CHECK_WD,
                      embedding_moments_dtype="float32"),
        train[0], train[1], FIELD_DIMS, N_DOMAIN, u2["entry"],
        u2["entry_d2g"], row, 0, tag, f"cdc ple (b) update 2 mask row {r}")
    summary = {
        "rows": rows, "train_rows": len(train[1]), "train_gb": nbytes / 1e9,
        "data_seconds": data_s, "setup_seconds": setup_s,
        "warmup_seconds": warm_s, "span_ms_a_step": span_ms,
        "resident_ms_a_step": resident_ms, "stream_again_ms_a_step":
        again_ms, "launches": launches,
        "valid_total_auc": auc,
        "valid_rows": len(valid[1]), "eval_seconds": eval_s,
        "device_peak_gb": peak_gb, "host_peak_rss_gb": rss_gb,
        "updates": {w: {x: u[x] for x in (
            "seconds", "feed_seconds", "peak_gb", "valid_steps",
            "probe_forwards", "blocks", "d2g", "launches")}
            for w, u in (("1", u1), ("2_serial", u2), ("2_lanes", u2l))},
        "row_vs_cpu": row_check}
    del tr, rec, train, valid
    torch.cuda.empty_cache()
    summary["phase_seconds"] = time.perf_counter() - t_phase
    print(f"stream (b): {summary['phase_seconds']:.1f} s")
    return summary


def stream_main_path(dev, tag):
    """Phase 25: CDC as its users run it, on CDCConfig()'s default base
    PLE.  (a) phase 23 (b)'s data (32,768 rows, 6 domains, 4 antipodal
    clusters) through five CDCTrainer.fit runs from one initial state at
    CDCConfig()'s defaults but STREAM_CAUSAL mask rows, STREAM_WARMUP and
    STREAM_INTERVAL (at least three matrix updates a fit): (i)
    "resident" serial, (ii) "stream" serial, (iii) "resident" in LANES
    lanes, (iv) "stream" in lanes, (v) (iv) in bf16 compute.  (ii) holds
    (i) and (iv) holds (iii) bitwise: every loss, each update's matrices,
    k-means seed and clustering, and the final state; #1, #2, #3 and
    #6/7's pass against the schedule, update by update; at the entry of
    updates 2 and 3 a serial mask row and a lane B row against the CPU
    (:func:`populate_row_vs_cpu`); (v) finite.  Each update's seconds,
    its _feed seconds and peak memory, each clustering and the domains
    each B row trained print.  (b), the split over the card's budget, is
    :func:`stream_at_scale`, run alone.  -> (launches by fit, summary)."""
    t_phase = time.perf_counter()
    launches, summary = stream_fits(tag)
    summary["phase_seconds"] = time.perf_counter() - t_phase
    print(f"stream phase: {summary['phase_seconds']:.1f} s")
    return launches, summary


# -- CDC's cadence on the mesh (phase 26, run alone) --------------------------

# (b): phase 25 (a)'s configuration on MESH_SHAPE with the experts split,
# dropout 0 and CDC_CHECK_WD (as 23 (b)); four fits from one initial state
CADENCE_FITS = (("i", "resident", 0), ("ii", "stream", 0),
                ("iii", "resident", LANES), ("iv", "stream", LANES))
CADENCE_TIMEOUT = 1100
# (c): a row's limit against one device where a row order alone parts one
# device from itself by more than EP_CDC_ATOL: this many times that
# parting (the mesh also moves each row's products, at a rank's row
# count, which a row order does not; on an H100 80GB HBM3, 23 (b)'s
# witness read the mesh at 1.2-1.5x a row order's median parting on (2, 1))
ORDER_FACTOR = 2
# (c): row 0's first steps on the mesh against one device from the same
# state, at a fixed limit: step 1 holds the lookup and the forward, step 2
# also step 1's backward, the exchange and the update, before training
# amplifies a summation order.  The limit is 8 float32 ulps of the loss,
# which the table's L2 term dominates: tpurec's MESH_LOSS_RTOL (2e-5)
# let a planted fault pass (the last data rank's rows left out of step 1
# parted steps 1-2 by 1.14e-5 and 3.29e-6 at 4M rows on an H100 80GB
# HBM3, where the mesh read 0 and 0), so the fault is replayed in every
# run and must part them by more than the limit
CADENCE_STEPS_HELD = 2
CADENCE_STEP_RTOL = 1e-6


def cadence_config(placement="auto", lanes=0, cut=True):
    """Phase 26's configuration: :func:`stream_config` (PLE at
    CDCConfig()'s defaults; ``cut``: phase 25 (a)'s mask rows, warmup and
    interval) at dropout 0 and CDC_CHECK_WD, where the mesh is held to
    one device."""
    return stream_config(placement, lanes, cut=cut, dropout=0.0,
                         wd=CDC_CHECK_WD)


def cadence_rank(out_dir):
    """One rank of phase 26 on MESH_SHAPE with the experts split, started
    by :func:`cadence_main_path` or :func:`cadence_at_scale` with
    ``cadence.json`` in ``out_dir`` (``rows``: None for (b), the
    synthetic rows of (c)).  Writes ``cadence_rank_<r>.json``."""
    import os

    from tpurec_torch.parallel import Shardings, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(out_dir, "cadence.json")) as f:
        w = json.load(f)
    j = _join_rank()
    sh = Shardings(make_mesh(*MESH_SHAPE), expert_parallel=True)
    rec = (cadence_fits_rank(out_dir, j, sh) if w["rows"] is None
           else cadence_scale_rank(out_dir, j, sh, w["rows"],
                                   w.get("profile", False)))
    rec.update(rank=j.rank, backend=j.backend, device=str(sh.mesh.device))
    with open(os.path.join(out_dir, f"cadence_rank_{j.rank}.json"),
              "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()
    return 0


def _update_record(u):
    return {k: u[k] for k in (
        "seconds", "feed_seconds", "coll_seconds", "coll_calls", "peak_gb",
        "valid_steps", "probe_forwards", "blocks", "d2g", "seed",
        "launches")}


def cadence_fits_rank(out_dir, j, sh):
    """Phase 26 (b) on one rank: the CADENCE_FITS fits of
    :func:`cadence_config` on phase 23 (b)'s data (:func:`stream_fit`:
    at least STREAM_MIN_UPDATES updates, launches against the schedule
    update by update), "stream" against "resident" bitwise serially and
    in lanes (:func:`_fits_bitwise`), and in fit (iv) at each update the
    serial row 0 from the update's entry state against lane row 0
    (bitwise).  Rank 0 writes fit (i)'s state at the entry of each
    populate block of its first update (``block_<i>.msgpack``).
    -> record."""
    import os

    from tpurec_torch.cdc import CDCTrainer
    from tpurec_torch.parallel.collectives import reset_stats

    data = ep_cdc_data()
    counters = train_counters("ple")

    def block(tr, u, i, _):
        if u == 0:
            blob = tr.snapshot_bytes()
            if j.rank == 0:
                with open(os.path.join(out_dir, f"block_{i}.msgpack"),
                          "wb") as f:
                    f.write(blob)

    fits = {}
    for key, placement, lanes in CADENCE_FITS:
        reset_stats()
        fits[key] = stream_fit(
            data, counters, cadence_config(placement, lanes),
            keep=range(1 << 10) if key == "iv" else (), shardings=sh,
            on_block=block if key == "i" else None,
            what=f"(b) rank {j.rank} ({key})")
    same = {f"{b}_vs_{a}": _fits_bitwise(fits[a], fits[b])
            for a, b in (("i", "ii"), ("iii", "iv"))}
    check(all(all(v.values()) for v in same.values()),
          f"(b) rank {j.rank}: stream vs resident {same}")
    # lane row 0 against the serial row 0 from each update's entry state
    t = CDCTrainer(cadence_config("stream", 0), EP_CDC_DIMS,
                   EP_CDC_DOMAINS, DOMAIN_IDX, shardings=sh)
    t.setup_data(data.train, data.valid)
    gaps = []
    for u in fits["iv"]["updates"]:
        t.restore_bytes(u["entry"])
        t.cluster.domain2group = np.asarray(u["entry_d2g"], np.int64)
        row = t._run_populate_async(*(a[None] for a in u["row0"]))[0]
        gaps.append(float(np.abs(row.cpu().double().numpy()
                                 - u["mask"][0]).max()))
    del t
    torch.cuda.empty_cache()
    check(all(g == 0.0 for g in gaps), f"(b) rank {j.rank}: lane row 0 vs "
          f"serial row 0 by update {gaps}")
    u0 = fits["i"]["updates"][0]
    return {
        "bitwise": same, "row0_gaps": gaps,
        "first_update": {m: u0[m].tolist() for m in ("mask", "A", "B")},
        "fits": {k: {"updates": [_update_record(u) for u in f["updates"]],
                     "fit_seconds": f["fit_seconds"],
                     "peak_gb": f["peak_gb"],
                     "warmup_steps": f["warmup_steps"],
                     "span_steps": f["span_steps"],
                     "span_ms_a_step": f["span_seconds"]
                     / f["span_steps"] * 1e3,
                     "valid_total_auc": f["auc"],
                     "launches": f["launches"]}
                 for k, f in fits.items()}}


def _spawn_cadence(rows, timeout, profile=False, pg_timeout=None):
    """Start phase 26's ranks (``profile``: (c) profiles a mask row's
    steps on every rank; ``pg_timeout``: their group timeout) -> (their
    records, the directory)."""
    import os
    import tempfile

    tmp = tempfile.mkdtemp(prefix="cadence_")
    with open(os.path.join(tmp, "cadence.json"), "w") as f:
        json.dump({"rows": rows, "profile": profile}, f)
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    t0 = time.perf_counter()
    rcs, tails = _spawn_ranks(world, tmp, timeout=timeout,
                              flag="--cadence-rank", pg_timeout=pg_timeout)
    ranks_s = time.perf_counter() - t0
    check(rcs == [0] * world, f"phase 26 ranks exited {rcs}:\n{tails}")
    recs = []
    for r in range(world):
        with open(os.path.join(tmp, f"cadence_rank_{r}.json")) as f:
            recs.append(json.load(f))
    check_placement(recs, world, "cadence")
    return recs, tmp, ranks_s


def cadence_main_path(tag):
    """Phase 26 (b), ``--phase 26``: CDC's cadence on the mesh.  4 ranks
    on MESH_SHAPE over gloo with the experts split
    (:func:`cadence_fits_rank`): four CDCTrainer.fit runs of
    :func:`cadence_config` from one initial state, "resident" and
    "stream", serially and in LANES row lanes, each with at least
    STREAM_MIN_UPDATES matrix updates; on every rank "stream" bitwise
    "resident", lane row 0 bitwise the serial row 0 at each update, #1,
    #2, #3 and #6/7's pass against the schedule update by update; every
    rank holding rank 0's clustering after each update; the first
    update's matrices against a one-device fit that takes the mesh's
    state at each of its populate blocks' entry (EP_CDC_ATOL, the
    clustering held unless it ties).  Per update: seconds, ``_feed``'s
    seconds and share, the collectives' share, peak device memory a rank.
    -> summary."""
    import os
    import shutil

    from tpurec_torch.cdc import CDCTrainer

    t_phase = time.perf_counter()
    recs, tmp, ranks_s = _spawn_cadence(None, CADENCE_TIMEOUT)
    r0 = recs[0]
    for k, *_ in CADENCE_FITS:
        d2g = [u["d2g"] for u in r0["fits"][k]["updates"]]
        check(all([u["d2g"] for u in r["fits"][k]["updates"]] == d2g
                  for r in recs), f"(b) ({k}): the ranks' clusterings "
              + "; ".join(str([u["d2g"] for u in r["fits"][k]["updates"]])
                          for r in recs))
    print(f"{tag} cadence (b) {len(recs)} ranks on {MESH_SHAPE} over gloo, "
          f"the experts split, ran in {ranks_s:.1f} s (start-up "
          "included); every rank exited 0: \"stream\" bitwise \"resident\" "
          "serially and in lanes (every loss, each update's matrices, "
          "k-means seed and clustering, the final state), lane row 0 "
          "bitwise the serial row 0 at each update, launches = the "
          "schedule update by update, every rank holding rank 0's "
          "clustering after each update")
    for key, placement, lanes in CADENCE_FITS:
        f = r0["fits"][key]
        print(f"{tag} cadence (b) ({key}) {placement}, "
              f"{f'{lanes} lanes' if lanes else 'serial'}: "
              f"{f['warmup_steps']} warmup steps, {len(f['updates'])} "
              f"updates, {f['span_steps']} split-mode steps "
              f"({f['span_ms_a_step']:.3f} ms a step), fit "
              f"{f['fit_seconds']:.2f} s, valid total_auc "
              f"{f['valid_total_auc']:.5f}; launches {f['launches']}; peak "
              "a rank " + ", ".join(f"{r['fits'][key]['peak_gb']:.2f}"
                                    for r in recs) + " GiB")
        for i, u in enumerate(f["updates"]):
            print(f"    update {i + 1}: {u['seconds']:.3f} s (_feed "
                  f"{u['feed_seconds']:.3f} s, "
                  f"{100 * u['feed_seconds'] / u['seconds']:.1f}%; "
                  f"collectives {u['coll_calls']} calls, "
                  f"{100 * u['coll_seconds'] / u['seconds']:.1f}%; "
                  f"{u['valid_steps']} valid steps, {u['probe_forwards']} "
                  f"probe evals; peak a rank "
                  + ", ".join(f"{r['fits'][key]['updates'][i]['peak_gb']:.2f}"
                              for r in recs)
                  + f" GiB) -> {u['d2g']}")
    # update 1 against one device from the mesh's state at each block
    data = ep_cdc_data()
    one = CDCTrainer(cadence_config("resident", 0), EP_CDC_DIMS,
                     EP_CDC_DOMAINS, DOMAIN_IDX)

    def from_mesh(tr, u, i, _):
        if u == 0:
            with open(os.path.join(tmp, f"block_{i}.msgpack"), "rb") as fh:
                tr.restore_bytes(fh.read())

    rec, undo = _observe_updates(one, data.train[0], train_counters("ple"),
                                 on_block=from_mesh)
    try:
        one.fit(data.train, data.valid)
        torch.cuda.synchronize()
    finally:
        undo()
    del one
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    u1 = rec["updates"][0]
    mine = r0["fits"]["i"]["updates"][0]
    errs = {m: float(np.abs(np.asarray(r0["first_update"][m])
                            - u1[m]).max()) for m in ("mask", "A", "B")}
    check(mine["seed"] == u1["seed"], f"(b) k-means seeds: mesh "
          f"{mine['seed']}, one device {u1['seed']}")
    # update_group clusters the mask rows less the warm baseline (A's
    # last row: affinity "minus", nothing blended at the first update)
    n_cluster = cadence_config().cdc.n_cluster
    mesh_m = {m: np.asarray(r0["first_update"][m]) for m in ("mask", "A")}
    own, moved = clustering_tie(u1["mask"] - u1["A"][-1], n_cluster,
                                u1["seed"], EP_CDC_ATOL)
    mesh_own, _ = clustering_tie(mesh_m["mask"] - mesh_m["A"][-1],
                                 n_cluster, u1["seed"], EP_CDC_ATOL,
                                 draws=0)
    tied = len(moved) > 1
    print(f"{tag} cadence (b) update 1 of (i) against one device from the "
          f"mesh's state at each block's entry: matrices max abs err "
          f"{errs} (tol {EP_CDC_ATOL}); clustering mesh {mine['d2g']}, one "
          f"device {u1['d2g']}; one device's matrices moved by "
          f"+-{EP_CDC_ATOL} ({EP_TIE_DRAWS} draws) cluster {moved} ("
          + ("a tie: compared, not held" if tied else "decided: held") + ")")
    check(all(v <= EP_CDC_ATOL for v in errs.values()),
          f"(b) update 1 vs one device: {errs}")
    check(own == tuple(u1["d2g"]) and mesh_own == tuple(mine["d2g"]),
          f"(b) reclustering gives {own} (one device's {u1['d2g']}), "
          f"{mesh_own} (the mesh's {mine['d2g']})")
    check(tied or mine["d2g"] == u1["d2g"], f"(b) clustering "
          f"{mine['d2g']} vs one device's {u1['d2g']}")
    summary = {"ranks_seconds": ranks_s,
               "bitwise": r0["bitwise"], "row0_gaps": r0["row0_gaps"],
               "update1_vs_one_device": errs,
               "clustering_moved": {str(list(k)): n for k, n in
                                    moved.items()},
               "fits": {k: {**r0["fits"][k], "peak_gb_by_rank": [
                   r["fits"][k]["peak_gb"] for r in recs],
                   "update_peak_gb_by_rank": [
                       [u["peak_gb"] for u in r["fits"][k]["updates"]]
                       for r in recs]}
                   for k, *_ in CADENCE_FITS}}
    summary["phase_seconds"] = time.perf_counter() - t_phase
    print(f"cadence (b): {summary['phase_seconds']:.1f} s")
    return summary


def cadence_scale_rank(out_dir, j, sh, rows, profile=False):
    """Phase 26 (c) on one rank: make_synthetic(``rows``) at the
    flagship schema (phase 25 (b)'s draw), CDCTrainer on the mesh of
    ``sh`` at :func:`cadence_config` uncut ("auto" placement), which must
    stream the split; the warmup and the first matrix update (the epoch
    after it cut), observed (:func:`_observe_updates`), launches against
    the schedule, the exact valid eval.  Rank 0 writes what one-device
    replays of two of the update's mask rows need, row 0 and the row with
    the fewest valid steps (``rows.npz``: the state at each row's start,
    the clustering, each row's schedule, its window of the split, the
    mesh's row, and row 0's step losses).  ``profile``: the steps of the
    update's mask row 1 run inside torch.profiler on every rank
    (:func:`card_window`: busy, NCCL's device share).  -> record."""
    import os
    import resource

    from tpurec_torch.cdc import CDCTrainer
    from tpurec_torch.data import make_synthetic
    from tpurec_torch.parallel.collectives import reset_stats

    t0 = time.perf_counter()
    data = make_synthetic(
        n_rows=rows, n_fields=len(FIELD_DIMS), n_domain=N_DOMAIN,
        field_dims=FIELD_DIMS, domain_idx=DOMAIN_IDX, seed=1,
        domain_cluster_k=N_TOWER, domain_cluster_conflict=True)
    train, valid = data.train, data.valid
    del data
    data_s = time.perf_counter() - t0
    tr = CDCTrainer(cadence_config(cut=False), FIELD_DIMS, N_DOMAIN,
                    DOMAIN_IDX, shardings=sh)
    t0 = time.perf_counter()
    tr.setup_data(train, valid)
    setup_s = time.perf_counter() - t0
    nbytes = train[0].nbytes + train[1].nbytes
    check(tr._resident is False, f"(c) rank {j.rank}: a {nbytes / 1e9:.3f}"
          f" GB split stayed resident (mesh budget "
          f"{tr.MESH_RESIDENT_BUDGET / 2**20:.0f} MiB)")
    counters = train_counters("ple")
    for fn in counters.values():
        fn.launches = 0
    # a serial block's row r starts from the block's entry parameters and
    # the moments rows 0..r-1 left: the state at the fewest-steps mask
    # row's start is taken there (the r-th row's steps of block 0)
    arm, starts = {"row": -1, "calls": -1}, {}

    def on_block(tr_, u, i, urec):
        arm["calls"] = 0 if (u, i) == (0, 0) else -1
        if arm["calls"] == 0:
            arm["row"] = urec["mask_row"][0]

    rec, undo = _observe_updates(tr, train[0], counters, keep=(0,),
                                 on_block=on_block)
    steps = tr._steps

    def steps_(mode, *args):
        row0 = arm["calls"] == 0
        row1 = profile and arm["calls"] == 1
        if arm["calls"] >= 0:
            if arm["calls"] == arm["row"]:
                starts["few"] = tr.snapshot_bytes()
            arm["calls"] += 1
        if not row1:
            out = steps(mode, *args)
        else:
            from torch.profiler import ProfilerActivity, profile as prof_

            torch.cuda.synchronize()
            with prof_(activities=[ProfilerActivity.CUDA]) as prof:
                open_capture_window()
                t0 = time.perf_counter()
                out = steps(mode, *args)
                torch.cuda.synchronize()
                window_s = time.perf_counter() - t0
            starts["row1_profile"] = card_window(card_intervals(prof),
                                                 window_s, len(out))
        if row0:
            starts["row0_losses"] = [float(x) for x in out]
        return out

    tr._steps = steps_
    reset_stats()
    torch.cuda.reset_peak_memory_stats()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr._run_steps("warmup", *tr._warmup_sched())
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        tr.update_matrix_cdc(tr._scaled_update_matrix_step())
        t0 = time.perf_counter()
        ev = tr.evaluate(tr.valid_batcher)
        eval_s = time.perf_counter() - t0
    finally:
        undo()
    u, = rec["updates"]
    _check_update_launches(u, f"(c) rank {j.rank} update 1")
    n_eval = tr._padded_split(tr.valid_batcher)[6]
    n_steps = rec["warmup_steps"] + u["valid_steps"]
    launches = {k: fn.launches for k, fn in counters.items()}
    want = schedule_launches(n_steps, n_steps + u["probe_forwards"] + n_eval)
    check(launches == want, f"(c) rank {j.rank}: launches {launches}, the "
          f"schedule {want}")
    check(np.isfinite(ev["total_auc"]), f"(c) valid AUC {ev['total_auc']}")
    if j.rank == 0:
        rows_out = {"row0_entry": np.frombuffer(u["entry"], np.uint8),
                    "few_entry": np.frombuffer(starts["few"], np.uint8),
                    "d2g": np.asarray(u["entry_d2g"]),
                    "row0_losses": np.asarray(starts["row0_losses"])}
        r_few, few = u["mask_row"]
        for key, r, row in (("row0", 0, u["row0"]), ("few", r_few, few)):
            bidx, bmask, bvalid, eidx, emask = row
            flat = np.concatenate([bidx.ravel(), eidx.ravel()]).astype(
                np.int64)
            rows_out.update({f"{key}_{k}": v for k, v in (
                ("index", r), ("bmask", bmask), ("bvalid", bvalid),
                ("emask", emask), ("bshape", bidx.shape),
                ("eshape", eidx.shape), ("X", train[0][flat]),
                ("y", train[1][flat]), ("row", u["mask"][r]))})
        np.savez(os.path.join(out_dir, "rows.npz"), **rows_out)
    out = {"rows": rows, "train_rows": len(train[1]),
           "train_gb": nbytes / 1e9, "resident": tr._resident,
           "data_seconds": data_s, "setup_seconds": setup_s,
           "warmup_steps": rec["warmup_steps"], "warmup_seconds": warm_s,
           "update": _update_record(u), "launches": launches,
           "valid_total_auc": ev["total_auc"], "valid_rows": len(valid[1]),
           "eval_seconds": eval_s,
           "row1_profile": starts.get("row1_profile"),
           "device_peak_gb": max(rec["peak_gb"],
                                 torch.cuda.max_memory_allocated() / 2**30),
           "host_peak_rss_gb": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss / 2**20}
    del tr, rec, train, valid
    torch.cuda.empty_cache()
    return out


def _replay_row(rows, key, order=None, split=False, drop=False):
    """One of phase 26 (c)'s mask rows (``key`` "row0" or "few" in
    ``rows``, :func:`cadence_scale_rank`'s) on one device from the mesh's
    state at the row's start: its treatment steps, each step's rows in
    the order drawn from seed ``order`` (None: the schedule's), then its
    probe eval; ``split`` makes the sums and products in MESH_SHAPE's
    data ranks' row blocks (:class:`mesh_split_sums`); ``drop`` (a
    planted fault) leaves the last data rank's columns out of the first
    step, as a mesh that lost that rank's rows there would.  -> (the [D]
    row, the steps' losses)."""
    from tpurec_torch.cdc import CDCTrainer
    from tpurec_torch.cdc.algorithm import CDCClusterState

    def a(name):
        return rows[f"{key}_{name}"]

    cfg = cadence_config(cut=False)
    t = CDCTrainer(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX)
    t.restore_bytes(a("entry").tobytes())
    t.cluster = CDCClusterState.create(N_DOMAIN, cfg.cdc.n_cluster, cfg.cdc)
    t.cluster.domain2group = np.asarray(rows["d2g"], np.int64)
    dev = t.device
    nb = int(np.prod(a("bshape")))
    pos = torch.arange(len(a("y")), dtype=torch.int32, device=dev)
    Xs = torch.from_numpy(a("X")).to(dev)
    ys = torch.from_numpy(a("y")).to(dev)
    bi = pos[:nb].reshape(tuple(a("bshape")))
    bm = torch.from_numpy(a("bmask")).to(dev)
    if order is not None:
        perm = torch.randperm(bi.shape[1], generator=torch.Generator()
                              .manual_seed(order)).to(dev)
        bi, bm = bi[:, perm], bm[:, perm]
    if drop:
        s0 = int(np.flatnonzero(a("bvalid"))[0])
        bm = bm.clone()
        bm[s0, bm.shape[1] - bm.shape[1] // MESH_SHAPE[0]:] = 0
    ei = pos[nb:].reshape(tuple(a("eshape")))
    with (mesh_split_sums(MESH_SHAPE[0], rows=True) if split
          else contextlib.nullcontext()):
        losses = [float(x) for x in t._steps("split", Xs, ys, bi, bm,
                                             a("bvalid"))]
        row = t._eval_rows(Xs, ys, ei, torch.from_numpy(a("emask"))
                           .to(dev)).cpu().double().numpy()
    del t, Xs, ys
    torch.cuda.empty_cache()
    return row, losses


def row0_steps(rows_in, losses, tag):
    """Phase 26 (c): row 0's step losses on the mesh (``rows_in``)
    against one device's replay (``losses``), relative; the first
    CADENCE_STEPS_HELD held at CADENCE_STEP_RTOL; beside them the replay
    with a planted fault (:func:`_replay_row`'s ``drop``), which the
    limit must see.  -> summary."""
    mesh = rows_in["row0_losses"]

    def parting(xs):
        check(len(xs) == len(mesh), f"(c) row 0: {len(xs)} steps on one "
              f"device, {len(mesh)} on the mesh")
        return [abs(x - m) / abs(m) for x, m in zip(xs, mesh)]

    err = parting(losses)
    fault = parting(_replay_row(rows_in, "row0", drop=True)[1])
    n, tol = CADENCE_STEPS_HELD, CADENCE_STEP_RTOL
    print(f"{tag} cadence (c) mask row 0's step losses, the mesh against "
          f"one device from the same state (relative): steps 1-{n} "
          + ", ".join(f"{x:.3g}" for x in err[:n])
          + f" (tol {tol}), all {len(err)} steps max {max(err):.3g}; "
          f"with a planted fault (the last data rank's rows left out of "
          f"step 1) steps 1-{n} " + ", ".join(f"{x:.3g}" for x in fault[:n])
          + " (must exceed the tol)")
    check(max(err[:n]) <= tol, f"(c) row 0's first {n} step losses vs "
          f"one device: {err[:n]} (tol {tol})")
    check(max(fault[:n]) > tol, f"(c) the planted fault parts row 0's "
          f"first {n} step losses by {fault[:n]}, within the tol {tol}")
    return {"held": err[:n], "tol": tol, "max": max(err),
            "planted_fault": fault[:n]}


def cadence_at_scale(tag, rows, profile=False, pg_timeout=None):
    """Phase 26 (c), ``--phase 26 --rows N``: CDC on the mesh at a size
    its users run, 4 ranks on MESH_SHAPE with the experts split
    (:func:`cadence_scale_rank`): every rank's "auto" must stream the
    split, the warmup and the first update run to their end with finite
    matrices and one clustering on every rank; two mask rows of that
    update replayed on one device from the mesh's state at the row's
    start (row 0 and the fewest steps'), beside one device in two other
    row orders: each within EP_CDC_ATOL or, where one device parts from
    itself by more under a row order, within ORDER_FACTOR times that
    parting; row 0's first step losses at a fixed limit
    (:func:`row0_steps`).  Each rank's data and set-up seconds, the update's seconds,
    valid steps, ``_feed``'s and the collectives' shares, host peak RSS
    and device peak memory, the valid AUC; with ``profile`` (phase 29) a
    mask row's steps profiled on every rank: its device busy and NCCL's
    device share.  -> summary."""
    import os
    import shutil

    t_phase = time.perf_counter()
    recs, tmp, ranks_s = _spawn_cadence(rows, CADENCE_TIMEOUT, profile,
                                        pg_timeout)
    r0 = recs[0]
    check(all(r["update"]["d2g"] == r0["update"]["d2g"] for r in recs),
          "(c) the ranks' clusterings: "
          + "; ".join(str(r["update"]["d2g"]) for r in recs))
    for r in recs:
        u = r["update"]
        print(f"{tag} cadence (c) rank {r['rank']}: make_synthetic({rows} "
              f"rows) {r['data_seconds']:.1f} s, a {r['train_rows']}-row "
              f"split of {r['train_gb']:.3f} GB: \"auto\" streams it; "
              f"setup_data {r['setup_seconds']:.1f} s; warmup "
              f"{r['warmup_steps']} steps {r['warmup_seconds']:.1f} s; "
              f"update {u['seconds']:.1f} s ({u['valid_steps']} valid "
              f"steps, {u['probe_forwards']} probe evals; _feed "
              f"{u['feed_seconds']:.2f} s, "
              f"{100 * u['feed_seconds'] / u['seconds']:.1f}%; collectives "
              f"{u['coll_calls']} calls, "
              f"{100 * u['coll_seconds'] / u['seconds']:.1f}%) -> "
              f"{u['d2g']}; valid total_auc {r['valid_total_auc']:.5f} "
              f"({r['valid_rows']} rows, {r['eval_seconds']:.1f} s); host "
              f"peak RSS {r['host_peak_rss_gb']:.2f} GiB, device peak "
              f"{r['device_peak_gb']:.2f} GiB; launches {r['launches']}")
        p = r.get("row1_profile")
        if p is not None:
            print(f"{tag} cadence (c) rank {r['rank']}: the update's mask "
                  f"row 1 profiled, {p['step_ms']:.3f} ms a step, device "
                  f"busy {100 * p['busy_share']:.1f}%, NCCL kernels "
                  f"{p['nccl_ms']:.3f} ms a step "
                  f"({100 * p['nccl_share']:.1f}% of the row; "
                  f"{p['nccl_launches']:.1f} launches a step), records on "
                  f"cards {p['devices']}")
            check(set(p["devices"]) <= {int(r["device"].split(":")[1])},
                  f"(c) rank {r['rank']}: records on cards {p['devices']}")
    with np.load(os.path.join(tmp, "rows.npz")) as z:
        rows_in = {k: z[k] for k in z.files}
    shutil.rmtree(tmp, ignore_errors=True)
    # each row against one device; the parting a summation order alone
    # makes on one device (two other row orders); one device with its
    # sums, products and normalisation in the data ranks' row blocks
    checked = {}
    for key in ("row0", "few"):
        t0 = time.perf_counter()
        want = rows_in[f"{key}_row"]
        row, losses = _replay_row(rows_in, key)
        err = float(np.abs(row - want).max())
        order = [float(np.abs(_replay_row(rows_in, key, SEED + d)[0]
                              - row).max()) for d in range(1, 3)]
        split = float(np.abs(_replay_row(rows_in, key, split=True)[0]
                             - want).max())
        if key == "row0":
            steps_held = row0_steps(rows_in, losses, tag)
        steps = int((rows_in[f"{key}_bvalid"] > 0).sum())
        checked[key] = {"row": int(rows_in[f"{key}_index"]), "steps": steps,
                        "vs_one_device": err, "order_partings": order,
                        "vs_split_rows": split}
        print(f"{tag} cadence (c) mask row {checked[key]['row']} of the "
              f"update ({steps} steps of {int(rows_in[f'{key}_bshape'][1])}"
              f" rows, a probe eval of "
              f"{int(np.prod(rows_in[f'{key}_eshape']))} rows), replayed "
              f"on one device from the mesh's state at the row's start: "
              f"max abs err {err:.3g}; one device against itself with each "
              f"step's rows in another order "
              + ", ".join(f"{x:.3g}" for x in order)
              + f"; the mesh against one device with its sums, products and "
              f"normalisation in the data ranks' row blocks {split:.3g} "
              f"({time.perf_counter() - t0:.1f} s)")
    # each row at EP_CDC_ATOL, unless a row order alone parts one device
    # from itself by more on that row (at 4M rows it does, 4.8e-4 to 9.1e-3
    # on an H100 80GB HBM3), where EP_CDC_ATOL cannot tell a
    # fault from rounding; then within ORDER_FACTOR of that spread
    for c in checked.values():
        c["tol"] = max(EP_CDC_ATOL, ORDER_FACTOR * max(c["order_partings"]))
        check(c["vs_one_device"] <= c["tol"], f"(c) mask row {c['row']} "
              f"({c['steps']} steps) vs one device: {c['vs_one_device']} "
              f"(tol {c['tol']}; one device's own row orders "
              f"{c['order_partings']})")
    print(f"{tag} cadence (c) the rows held at "
          + ", ".join(f"{c['tol']:.3g} (row {c['row']})"
                      for c in checked.values())
          + f": EP_CDC_ATOL, or {ORDER_FACTOR}x one device's parting from "
          "itself under a row order where that is larger")
    summary = {"ranks_seconds": ranks_s, "rows_vs_one_device": checked,
               "row0_steps": steps_held, "ranks": recs}
    summary["phase_seconds"] = time.perf_counter() - t_phase
    print(f"cadence (c): {summary['phase_seconds']:.1f} s")
    return summary


def phase26_main(rows) -> int:
    """Phase 26 alone, after the build: (b) CDC's cadence on the mesh, or
    with ``rows`` (c) the mesh at that many synthetic rows."""
    start = _phase_alone("phase 26")
    if start is None:
        return 1
    _, tag = start
    t0 = time.perf_counter()
    if rows is None:
        print(json.dumps({"cadence_b": cadence_main_path(tag)}))
    else:
        print(json.dumps({"cadence_c": cadence_at_scale(tag, rows)}))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


# -- the training harness as its users run it (phase 27) ---------------------

CADENCE_FIT_SEED = 1            # (a): phase 16's data, FIT_ROWS rows
CADENCE_WINDOW_ROWS = 2048      # (a): the windowed eval's rows a window
CADENCE_WINDOW_TOL = 1e-6       # (a): windowed vs resident streaming eval
FIT_OVER_TIMEOUT = 600          # (a): the fit over the budget's process
HARNESS_CUT_CHUNKS = 8          # (b): the epoch cut after 8 logs of 512 steps
HARNESS_TURN_CHUNKS = 2         # (b): in turns, 1,024 steps a run
HARNESS_RESIDENT_BYTES = 5 << 30    # (b): a budget the split fits
RESULT_KEYS = ("total_auc", "total_loss", "mean_auc", "mean_loss",
               "domain_auc", "domain_loss")


class _Cut(Exception):
    """Raised by phase 27's log_fn to cut an epoch, as a user's would."""


def _cut_after(chunks, marks):
    """A log_fn that keeps each training log's step count and synchronized
    host clock in ``marks`` and raises _Cut at the ``chunks``-th."""
    def log_fn(r):
        if "it" not in r:
            return
        torch.cuda.synchronize()
        marks.append((r["it"], time.perf_counter()))
        if len(marks) == chunks:
            raise _Cut(f"cut after {r['it']} steps")
    return log_fn


def _cut_epoch(tr, X, y, epoch_i, chunks):
    """``tr.train_epoch`` cut by :func:`_cut_after` -> its marks, the
    start's synchronized host clock first."""
    torch.cuda.synchronize()
    marks = [(0, time.perf_counter())]
    try:
        tr.train_epoch(X, y, epoch_i, log_fn=_cut_after(chunks + 1, marks))
    except _Cut:
        return marks
    raise SmokeFailure(f"epoch {epoch_i} ended before its cut")


def _host_rss_gb():
    """This process's resident set now (not its peak), GiB."""
    import os

    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30


def _results_repr(r):
    """A result's keys as text: equal text, bitwise equal values (NaN
    too)."""
    return repr({k: r[k] for k in RESULT_KEYS if k in r})


def _timed(fn, out, keep=False):
    """``fn`` wrapped to append its synchronized host-clock seconds to
    ``out`` (with ``keep``, (its result, the seconds))."""
    def wrapped(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a, **k)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        out.append((r, s) if keep else s)
        return r
    return wrapped


@contextlib.contextmanager
def _windows_of(tr):
    """Inside, the list of the rows each window of ``tr``'s streaming
    eval runs, in order."""
    windows, index_batches = [], tr._padded_index_batches

    def counted(n, bs, chunk):
        windows.append(n)
        return index_batches(n, bs, chunk)

    tr._padded_index_batches = counted
    try:
        yield windows
    finally:
        del tr._padded_index_batches


def harness_config(epoch=None):
    """Phase 16's settings: the flagship MMoE, B=512, dropout 0.2, bf16
    table moments; TrainConfig's own epoch (10) and early_stop (2) unless
    ``epoch``."""
    from tpurec_torch.config import Config, ModelConfig, TrainConfig

    train = dict(bs=512, seed=0, embedding_moments_dtype="bfloat16")
    if epoch is not None:
        train["epoch"] = epoch
    return Config(model=ModelConfig(**MODEL, dropout=DROPOUT),
                  train=TrainConfig(**train))


def cadence_data():
    """Phase 27 (a)'s data: phase 16's make_synthetic at the flagship
    schema -> (train, valid, test, domain_cnt_weight)."""
    from tpurec_torch.data import make_synthetic

    data = make_synthetic(n_rows=FIT_ROWS, n_fields=len(FIELD_DIMS),
                          n_domain=N_DOMAIN, field_dims=FIELD_DIMS,
                          domain_idx=DOMAIN_IDX, seed=CADENCE_FIT_SEED)
    return data.train, data.valid, data.test, data.domain_cnt_weight()


def cadence_fit(tr, placement, data):
    """One of phase 27 (a)'s fits: ``tr.fit`` of ``data`` with every step
    loss, each epoch's training seconds, each snapshot and restore
    recorded and the kernel counters read around it.  Held here: the
    launches against the schedule (a step each, a forward per eval batch
    of this placement), the epoch path ("resident": the indexed epoch,
    "over": the host-batching one), the state after the fit bitwise the
    best epoch's snapshot, evaluate(valid) after it the stopper's best
    result.  -> record: "epochs" (each epoch's valid result), "losses",
    "after" (the state's bytes), "best", "test", "launches", seconds."""
    train, valid, test, w = data
    bs = tr.cfg.train.bs
    n_batch = -(-len(train[1]) // bs)
    path = {"resident": "scan_steps_idx", "over": "scan_steps"}[placement]
    counters = train_counters("mmoe")
    rec = {"steps": _record_steps(tr), "epoch_seconds": [], "snaps": [],
           "restores": []}
    tr.train_epoch = _timed(tr.train_epoch, rec["epoch_seconds"])
    tr.snapshot = _timed(tr.snapshot, rec["snaps"], keep=True)
    tr.restore = _timed(tr.restore, rec["restores"])
    logs = []
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tr.fit(train, valid, test, domain_cnt_weight=w, log_fn=logs.append)
    torch.cuda.synchronize()
    rec["fit_seconds"] = time.perf_counter() - t0
    rec["launches"] = {k: fn.launches for k, fn in counters.items()}
    for attr in ("train_epoch", "snapshot", "restore"):
        delattr(tr, attr)              # the class's methods again
    rec["epochs"] = [r for r in logs if "epoch_seconds" in r]
    n_ep = len(rec["epochs"])
    if placement == "resident":
        def n_eval(n):
            return tr._padded_index_batches(n, bs, tr.EVAL_CHUNK)[0].shape[0]
    else:
        def n_eval(n):
            return -(-n // bs)
    steps = n_ep * n_batch
    want = schedule_launches(steps, steps + n_ep * n_eval(len(valid[1]))
                             + n_eval(len(test[1])))
    check(rec["launches"] == want, f"(a) {placement} fit: launches "
          f"{rec['launches']}, the schedule {want}")
    called = {a for a, _ in rec["steps"]}
    check(called == {path}, f"(a) {placement} fit trained through "
          f"{sorted(called)}, not {path}")
    rec["losses"] = _losses(rec.pop("steps"))
    check(rec["losses"].numel() == steps
          and bool(torch.isfinite(rec["losses"]).all()),
          f"(a) {placement} fit: {rec['losses'].numel()} step losses for "
          f"{steps} steps")
    rec["best"], rec["test"] = out["valid"], out["test"]
    check(rec["best"] is not None, f"(a) {placement} fit kept no best state")
    rec["after"] = tr.snapshot()
    check(rec["after"] == rec["snaps"][-1][0], f"(a) {placement} fit: the "
          "state after the fit is not the best epoch's snapshot")
    rec["snaps"] = [(len(b), s) for b, s in rec["snaps"]]
    ev = tr.evaluate(*valid, w)
    check(_results_repr(ev) == _results_repr(rec["best"]), f"(a) "
          f"{placement} fit: evaluate(valid) after the fit "
          f"{_results_repr(ev)}, the best result {_results_repr(rec['best'])}")
    return rec


def _cadence_line(tag, placement, rec, n_rows):
    return (f"{tag} fit cadence (a) {placement}: {len(rec['epochs'])} epochs, "
            f"best epoch {rec['best']['epoch']}; valid mean / total AUC by "
            "epoch " + ", ".join(f"{r['epoch']}: {r['mean_auc']:.5f} / "
                                 f"{r['total_auc']:.5f}"
                                 for r in rec["epochs"])
            + "; epoch training seconds "
            + ", ".join(f"{s:.3f}" for s in rec["epoch_seconds"])
            + f" ({n_rows / np.median(rec['epoch_seconds']):.0f} examples/s "
            "at the median); snapshots "
            + ", ".join(f"{n / 1e6:.1f} MB {s:.3f} s" for n, s in rec["snaps"])
            + "; restore " + ", ".join(f"{s:.3f} s" for s in rec["restores"])
            + f"; fit {rec['fit_seconds']:.2f} s; launches {rec['launches']} "
            "(the schedule)")


def fit_over_rank(out_dir):
    """Phase 27 (a)'s fit over the budget, started by
    :func:`fit_cadence_main_path` in a process of its own: from the
    initial state in ``out_dir``/init.bin, every split over the
    instance's DEVICE_RESIDENT_BYTES (:func:`cadence_fit`).  Writes
    over.json, over_losses.npy and over_after.bin there."""
    import os

    from tpurec_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = cadence_data()
    tr = Trainer(harness_config(), FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                 domain2group=np.arange(N_DOMAIN) % N_TOWER)
    with open(os.path.join(out_dir, "init.bin"), "rb") as f:
        tr.restore(f.read())
    tr.DEVICE_RESIDENT_BYTES = min(X.nbytes + y.nbytes
                                   for X, y in data[:3]) - 1
    rec = cadence_fit(tr, "over", data)
    np.save(os.path.join(out_dir, "over_losses.npy"), rec.pop("losses").numpy())
    with open(os.path.join(out_dir, "over_after.bin"), "wb") as f:
        f.write(rec.pop("after"))
    rec["epochs_repr"] = [_results_repr(r) for r in rec["epochs"]]
    rec["test_repr"] = _results_repr(rec["test"])
    rec["epochs"] = [{k: r[k] for k in ("epoch", "mean_auc", "total_auc")}
                     for r in rec["epochs"]]
    rec["best"] = {"epoch": rec["best"]["epoch"]}
    rec["test"] = {"total_auc": rec["test"]["total_auc"]}
    with open(os.path.join(out_dir, "over.json"), "w") as f:
        json.dump(rec, f)
    return 0


def _spawn_fit_over(out_dir):
    """Start :func:`fit_over_rank` in a process of its own (this script
    with ``--fit-over``), its output in ``out_dir``/over.log."""
    import os

    me = os.path.abspath(__file__)
    log = open(os.path.join(out_dir, "over.log"), "w")
    try:
        return subprocess.Popen([sys.executable, me, "--fit-over", out_dir],
                                cwd=os.path.dirname(me), stdout=log,
                                stderr=subprocess.STDOUT)
    finally:
        log.close()


def fit_cadence_main_path(dev, tag):
    """Phase 27 (a): Trainer.fit as run.py runs it, at full width:
    phase 16's data and settings with TrainConfig's own epoch 10 and
    early_stop 2, two fits from one initial state at once: (i) resident
    (the indexed epoch, the exact eval by index on the card) in this
    process, (ii) with the instance's DEVICE_RESIDENT_BYTES below the
    smallest split, so train, valid and test all go over it (the
    host-batching epoch, predict's batch path), in a process of its own
    (:func:`fit_over_rank`; the host, not the card, bounds a step, so the
    two share the card).  Held (with :func:`cadence_fit`'s checks of each
    fit): every step loss bitwise across the two, each epoch's valid
    result bitwise, the same stop and best epoch, a stop before the 10th
    epoch at a best epoch before the last, the restored states equal,
    the test results equal.  Then on the restored state: the streaming
    eval through CADENCE_WINDOW_ROWS-row windows (at least 3, the tail
    padded) within CADENCE_WINDOW_TOL of the resident streaming eval and
    within STREAM_TOL of the exact one.  -> (launches by fit, summary)."""
    import os
    import tempfile

    from tpurec_torch.train import Trainer

    t_phase = time.perf_counter()
    data = cadence_data()
    train, valid = data[0], data[1]
    w = data[3]
    cfg = harness_config()
    check(cfg.train.epoch == 10 and cfg.train.early_stop == 2,
          f"TrainConfig's epoch {cfg.train.epoch}, early_stop "
          f"{cfg.train.early_stop}")
    tr = Trainer(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                 domain2group=np.arange(N_DOMAIN) % N_TOWER)
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        with open(os.path.join(tmp, "init.bin"), "wb") as f:
            f.write(tr.snapshot())
        proc = _spawn_fit_over(tmp)
        try:
            res = cadence_fit(tr, "resident", data)
            rc = proc.wait(timeout=FIT_OVER_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        with open(os.path.join(tmp, "over.log")) as f:
            tail = "".join(f.readlines()[-25:])
        check(rc == 0, f"(a) the fit over the budget exited {rc}:\n{tail}")
        with open(os.path.join(tmp, "over.json")) as f:
            over = json.load(f)
        over_losses = torch.from_numpy(np.load(os.path.join(
            tmp, "over_losses.npy")))
        with open(os.path.join(tmp, "over_after.bin"), "rb") as f:
            over_after = f.read()
    print(_cadence_line(tag, "resident", res, len(train[1])))
    print(_cadence_line(tag, "over", over, len(train[1])))
    stop = len(res["epochs"]) - 1
    best_ep = res["best"]["epoch"]
    check(len(over["epochs"]) - 1 == stop
          and over["best"]["epoch"] == best_ep,
          f"(a) the fits stopped at epochs {stop}, {len(over['epochs']) - 1} "
          f"with best {best_ep}, {over['best']['epoch']}")
    check(stop < cfg.train.epoch - 1 and best_ep < stop,
          f"(a) the fit ran {stop + 1} of {cfg.train.epoch} epochs with best "
          f"epoch {best_ep}: no early stop")
    check(torch.equal(res["losses"], over_losses),
          f"(a) step losses part: max abs "
          f"{(res['losses'] - over_losses).abs().max().item()}")
    for r, text in zip(res["epochs"], over["epochs_repr"]):
        check(_results_repr(r) == text, f"(a) epoch {r['epoch']}'s valid "
              f"result parts: {_results_repr(r)} vs {text}")
    check(res["after"] == over_after, "(a) the restored states differ")
    check(_results_repr(res["test"]) == over["test_repr"],
          "(a) the test results differ")

    # the streaming eval of the restored state, resident and in windows
    exact = tr.evaluate(*valid, w)
    stream = tr.evaluate_streaming(*valid, w)
    tr.DEVICE_RESIDENT_BYTES = CADENCE_WINDOW_ROWS * (4 * len(FIELD_DIMS)
                                                      + 4)
    try:
        with _windows_of(tr) as windows:
            windowed = tr.evaluate_streaming(*valid, w)
    finally:
        tr.DEVICE_RESIDENT_BYTES = Trainer.DEVICE_RESIDENT_BYTES
    check(len(windows) >= 3 and windows[-1] < CADENCE_WINDOW_ROWS
          and all(n == CADENCE_WINDOW_ROWS for n in windows[:-1]),
          f"(a) windows of {windows} rows")
    keys = ("total_auc", "total_loss", "mean_auc", "mean_loss")
    win_err = {k: abs(windowed[k] - stream[k]) for k in keys}
    exact_err = {k: abs(windowed[k] - exact[k]) for k in STREAM_TOL}
    check(all(v <= CADENCE_WINDOW_TOL for v in win_err.values()),
          f"(a) windowed vs resident streaming eval {win_err}")
    check(all(exact_err[k] <= STREAM_TOL[k] for k in STREAM_TOL),
          f"(a) windowed streaming vs exact eval {exact_err}")
    phase_s = time.perf_counter() - t_phase
    print(f"{tag} fit cadence (a): both fits stop after epoch {stop} at "
          f"best epoch {best_ep}; {res['losses'].numel()} step losses, "
          f"every epoch's valid result, the restored state and the test "
          f"result bitwise equal across the placements; valid through "
          f"{len(windows)} windows of {windows} rows: vs resident streaming "
          f"{win_err} (tol {CADENCE_WINDOW_TOL}), vs exact {exact_err} (tol "
          f"{STREAM_TOL}); phase {phase_s:.1f} s (the fits at once)")
    summary = {
        "rows": {"train": len(train[1]), "valid": len(valid[1]),
                 "test": len(data[2][1])},
        "stop_epoch": stop, "best_epoch": best_ep,
        "valid_by_epoch": [{k: r[k] for k in ("epoch", "mean_auc",
                                              "total_auc", "total_loss")}
                           for r in res["epochs"]],
        "test_total_auc": res["test"]["total_auc"],
        "windows": windows, "windowed_vs_resident": win_err,
        "windowed_vs_exact": exact_err, "phase_seconds": phase_s}
    for name, rec in (("resident", res), ("over", over)):
        summary[name] = {
            "epoch_train_seconds": rec["epoch_seconds"],
            "examples_per_s_median": len(train[1]) / float(
                np.median(rec["epoch_seconds"])),
            "snapshot_mb_seconds": [(n / 1e6, s) for n, s in rec["snaps"]],
            "restore_seconds": rec["restores"],
            "fit_seconds": rec["fit_seconds"], "launches": rec["launches"]}
    launches = {"resident": res["launches"], "over": over["launches"]}
    del tr, res
    torch.cuda.empty_cache()
    return launches, summary


def _window_copy_seconds(tr, X, y, w0, W):
    """The host side of evaluate_streaming's window at row ``w0``, timed
    apart: the rows as int32, the tail zero-padded to W rows, both copied
    to the card (synchronized host clock)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Xw = np.asarray(X[w0:w0 + W], dtype=np.int32)
    yw = y[w0:w0 + W].astype(np.float32)
    nw = Xw.shape[0]
    if nw < W:
        Xw = np.concatenate([Xw, np.zeros((W - nw, X.shape[1]), np.int32)])
        yw = np.concatenate([yw, np.zeros(W - nw, np.float32)])
    Xd = torch.as_tensor(Xw, device=tr.device)
    yd = torch.as_tensor(yw, device=tr.device)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    del Xd, yd, Xw, yw
    return s, nw


def harness_at_scale(tag, rows=STREAM_ROWS):
    """Phase 27 (b), ``--phase 27 [--rows N]``: the training harness with
    the train split over DEVICE_RESIDENT_BYTES.  Phase 25 (b)'s
    make_synthetic(``rows``) at the flagship schema; a Trainer at phase
    16's settings, whose "auto" placement must take the host-batching
    epoch for the train split and keep valid and test resident.  The
    epoch is cut by a raising log_fn after HARNESS_CUT_CHUNKS chunks of
    512 steps; then the prefetch worker must have ended and the batch
    stream been let go (host RSS before, after the cut and after a
    collection).  The same cut epoch from the same initial state with the
    instance's budget at HARNESS_RESIDENT_BYTES (the split on the card):
    every step loss and the state bitwise.  The valid AUC after the cut;
    then in turns 1,024 steps of each placement twice (host, resident,
    resident, host; the losses bitwise pairwise); launches against the
    schedule; the device busy of 16 steps of each.  Eval of the train
    split as a stand-in for a test split of its size: the exact evaluate
    (predict's batch path) and evaluate_streaming (its windows), their
    seconds and rows/s, the first and the tail window's copies, streaming
    within STREAM_TOL of exact.  -> summary."""
    import gc
    import resource
    import threading
    import weakref

    import tpurec_torch.train.loop as loop
    from tpurec_torch.data import make_synthetic
    from tpurec_torch.train import Trainer

    t_phase = time.perf_counter()
    rss0 = _host_rss_gb()
    t0 = time.perf_counter()
    data = make_synthetic(
        n_rows=rows, n_fields=len(FIELD_DIMS), n_domain=N_DOMAIN,
        field_dims=FIELD_DIMS, domain_idx=DOMAIN_IDX, seed=1,
        domain_cluster_k=N_TOWER, domain_cluster_conflict=True)
    (X, y), valid = data.train, data.valid
    test_bytes = sum(a.nbytes for a in data.test)
    w = data.domain_cnt_weight()
    del data
    gc.collect()
    data_s = time.perf_counter() - t0
    nbytes = X.nbytes + y.nbytes
    cfg = harness_config(epoch=1)
    bs = cfg.train.bs
    d2g = np.arange(N_DOMAIN) % N_TOWER
    torch.cuda.reset_peak_memory_stats()
    host = Trainer(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX, domain2group=d2g)
    budget = host.DEVICE_RESIDENT_BYTES
    valid_bytes = valid[0].nbytes + valid[1].nbytes
    check(nbytes > budget, f"(b) a {nbytes / 1e9:.3f} GB train split is "
          f"within the {budget / 2**30:.3g} GiB budget")
    check(max(valid_bytes, test_bytes) <= budget, f"(b) valid "
          f"{valid_bytes / 1e9:.3f} GB or test {test_bytes / 1e9:.3f} GB is "
          "over the budget")
    print(f"{tag} harness (b) make_synthetic({rows} rows) {data_s:.1f} s: "
          f"train {len(y)} rows = {nbytes / 1e9:.3f} GB, over the "
          f"{budget / 2**30:.3g} GiB budget (the host-batching epoch); valid "
          f"{len(valid[1])} rows {valid_bytes / 1e9:.3f} GB and test "
          f"{test_bytes / 1e9:.3f} GB resident; host RSS "
          f"{_host_rss_gb():.2f} GiB (at the phase's start {rss0:.2f})")
    init = host.snapshot()
    rec = {"host": _record_steps(host)}
    counters = train_counters("mmoe")
    for fn in counters.values():
        fn.launches = 0

    # the cut epoch, "auto": the host-batching path
    made = []
    batcher = loop.ArrayBatcher

    class Watched(batcher):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(weakref.ref(self))

    threads0 = threading.active_count()
    rss_before = _host_rss_gb()
    loop.ArrayBatcher = Watched
    try:
        marks = _cut_epoch(host, X, y, 0, HARNESS_CUT_CHUNKS)
    finally:
        loop.ArrayBatcher = batcher
    rss_cut = _host_rss_gb()
    threads_cut = threading.active_count()
    gc.collect()
    rss_after = _host_rss_gb()
    threads_after = threading.active_count()
    held = [r for r in made if r() is not None]
    n_cut = HARNESS_CUT_CHUNKS * cfg.train.steps_per_dispatch
    host_loss = _losses(rec["host"])
    check({a for a, _ in rec["host"]} == {"scan_steps"}
          and host_loss.numel() == n_cut,
          f"(b) the cut epoch ran {host_loss.numel()} steps through "
          f"{sorted({a for a, _ in rec['host']})}")
    check(len(made) == 1 and not held, f"(b) {len(held)} of the cut "
          f"epoch's {len(made)} batch streams still alive")
    check(threads_after == threads0, f"(b) {threads_after - threads0} "
          "prefetch workers outlived the cut")
    host_s = marks[-1][1] - marks[0][1]
    chunk_s = [b[1] - a[1] for a, b in zip(marks, marks[1:])]
    print(f"{tag} harness (b) host-batching epoch cut after {n_cut} steps "
          f"by log_fn: {host_s:.2f} s = {n_cut * bs / host_s:.0f} examples/s "
          f"(the epoch's start included); chunks of "
          f"{cfg.train.steps_per_dispatch} steps "
          + ", ".join(f"{s:.2f}" for s in chunk_s)
          + f" s; after the cut {threads_cut} threads ({threads0} before, "
          f"{threads_after} after a collection), the batch stream let go; "
          f"host RSS "
          f"{rss_before:.2f} GiB before the epoch, {rss_cut:.2f} after the "
          f"cut, {rss_after:.2f} after a collection")

    # the same cut epoch with the split on the card
    res = Trainer(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX, domain2group=d2g)
    res.restore(init)
    res.DEVICE_RESIDENT_BYTES = HARNESS_RESIDENT_BYTES
    check(nbytes <= res.DEVICE_RESIDENT_BYTES, "(b) the split is over "
          f"{HARNESS_RESIDENT_BYTES / 2**30:.3g} GiB")
    rec["resident"] = _record_steps(res)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res._device_dataset(X, y)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    marks_r = _cut_epoch(res, X, y, 0, HARNESS_CUT_CHUNKS)
    res_loss = _losses(rec["resident"])
    check({a for a, _ in rec["resident"]} == {"scan_steps_idx"},
          f"(b) the resident epoch ran through "
          f"{sorted({a for a, _ in rec['resident']})}")
    check(torch.equal(res_loss, host_loss), f"(b) {n_cut} step losses "
          f"part: resident vs host max abs "
          f"{(res_loss - host_loss).abs().max().item() if res_loss.shape == host_loss.shape else res_loss.shape}")
    check(res.snapshot() == host.snapshot(), "(b) the states after the cut "
          "epochs differ")
    res_s = marks_r[-1][1] - marks_r[0][1]
    chunk_r = [b[1] - a[1] for a, b in zip(marks_r, marks_r[1:])]
    t0 = time.perf_counter()
    ev = host.evaluate(*valid, w)
    valid_s = time.perf_counter() - t0
    n_valid = host._padded_index_batches(len(valid[1]), bs,
                                         host.EVAL_CHUNK)[0].shape[0]
    print(f"{tag} harness (b) the same cut epoch resident (budget "
          f"{HARNESS_RESIDENT_BYTES / 2**30:.3g} GiB; the split copied to the "
          f"card in {copy_s:.2f} s): {res_s:.2f} s = "
          f"{n_cut * bs / res_s:.0f} examples/s; chunks "
          + ", ".join(f"{s:.2f}" for s in chunk_r)
          + f" s; {n_cut} step losses and the state bitwise the host "
          f"epoch's; valid total_auc {ev['total_auc']:.5f}, mean_auc "
          f"{ev['mean_auc']:.5f} ({len(valid[1])} rows, {valid_s:.1f} s)")

    # in turns: host, resident, resident, host; 1,024 steps a run
    turns = []
    for name, tr, epoch_i in (("host", host, 1), ("resident", res, 1),
                              ("resident", res, 2), ("host", host, 2)):
        lo = len(rec[name])
        m = _cut_epoch(tr, X, y, epoch_i, HARNESS_TURN_CHUNKS)
        n = HARNESS_TURN_CHUNKS * cfg.train.steps_per_dispatch
        turns.append({"placement": name, "epoch": epoch_i,
                      "seconds": m[-1][1] - m[0][1],
                      "last_chunk_seconds": m[-1][1] - m[-2][1],
                      "losses": _losses(rec[name], lo)})
        turns[-1]["examples_per_s"] = n * bs / turns[-1]["seconds"]
        turns[-1]["last_chunk_examples_per_s"] = (
            cfg.train.steps_per_dispatch * bs / turns[-1]["last_chunk_seconds"])
    for e in (1, 2):
        a, b = (t["losses"] for t in turns if t["epoch"] == e)
        check(torch.equal(a, b), f"(b) epoch {e}'s 1,024 steps part between "
              "the placements")
    steps = 2 * n_cut + sum(t["losses"].numel() for t in turns)
    launches = {k: fn.launches for k, fn in counters.items()}
    want = schedule_launches(steps, steps + n_valid)
    check(launches == want, f"(b) launches {launches}, the schedule {want}")
    print(f"{tag} harness (b) in turns, "
          f"{HARNESS_TURN_CHUNKS * cfg.train.steps_per_dispatch} steps a run "
          "(the epoch's start included; then its last chunk alone): "
          + "; ".join(f"{t['placement']} epoch {t['epoch']} "
                      f"{t['examples_per_s']:.0f} examples/s, "
                      f"{t['last_chunk_examples_per_s']:.0f}"
                      for t in turns)
          + f"; losses bitwise pairwise; {steps} steps, launches {launches} "
          "against the schedule")

    # where a step's time goes: 16 steps of each placement
    busy = {}
    Xdev, ydev, d2g_dev = res._device_dataset(X, y)
    rng = np.random.default_rng(SEED + 27)
    idx = torch.as_tensor(rng.integers(0, len(y), (PROFILE_STEPS, bs),
                                       dtype=np.int32), device=res.device)
    ones = torch.ones((PROFILE_STEPS, bs), device=res.device)
    Xs, ys = X[:PROFILE_STEPS * bs], y[:PROFILE_STEPS * bs]

    def host_steps():
        host._host_epoch(iter(batcher(
            Xs, ys, bs, group=host._group_of(Xs), shuffle=True,
            rng=np.random.default_rng(SEED))), 0, None)

    for name, run in (("resident", lambda: res.scan_steps_idx(
            res.state, Xdev, ydev, d2g_dev, idx, ones, res.dropout_gen)),
                      ("host", host_steps)):
        run()
        torch.cuda.synchronize()
        _, dev_us, window_s, per = profile_calls(
            run, PROFILE_STEPS, f"{tag} harness (b) {name} profile")
        us = sum(dev_us.values()) * PROFILE_STEPS
        check(us > 0, f"(b) the {name} profile shows no device time")
        busy[name] = {"busy_us_per_step": us / PROFILE_STEPS,
                      "busy_share": us / 1e6 / window_s,
                      "window_ms_per_step": window_s * 1e3 / PROFILE_STEPS,
                      "launches_per_step": per}
    print(f"{tag} harness (b) profiles of {PROFILE_STEPS} steps: "
          + "; ".join(f"{k} device busy {v['busy_us_per_step']:.1f} us a "
                      f"step, {100 * v['busy_share']:.1f}% of the window's "
                      f"{v['window_ms_per_step']:.3f} ms a step"
                      for k, v in busy.items()))
    del res, Xdev, ydev, d2g_dev, idx, ones
    gc.collect()
    torch.cuda.empty_cache()

    # eval at size: the train split as a stand-in for a test split
    check(X.nbytes + 4 * len(y) > host.DEVICE_RESIDENT_BYTES,
          "(b) predict would take the resident path")
    for fn in counters.values():
        fn.launches = 0
    predict_s = []
    host.predict = _timed(host.predict, predict_s)
    t0 = time.perf_counter()
    exact = host.evaluate(X, y, w)
    exact_s = time.perf_counter() - t0
    del host.predict
    exact_launches = {k: fn.launches for k, fn in counters.items()}
    n_exact = -(-len(y) // bs)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _windows_of(host) as windows:
        stream = host.evaluate_streaming(X, y, w)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    stream_launches = {k: fn.launches for k, fn in counters.items()}
    n_stream = sum(host._padded_index_batches(n, bs, host.EVAL_CHUNK)[0]
                   .shape[0] for n in windows)
    W = max(bs, (host.DEVICE_RESIDENT_BYTES // (4 * X.shape[1] + 4))
            // bs * bs)
    check(windows[:-1] == [W] * (len(windows) - 1)
          and sum(windows) == len(y) and len(windows) == -(-len(y) // W),
          f"(b) windows of {windows} rows, W = {W}")
    for what, got, n in (("exact", exact_launches, n_exact),
                         ("streaming", stream_launches, n_stream)):
        want = schedule_launches(0, n)
        check(got == want, f"(b) {what} eval launches {got}, the schedule "
              f"{want}")
    copies = {name: _window_copy_seconds(host, X, y, w0, W)
              for name, w0 in (("first", 0),
                               ("tail", (len(windows) - 1) * W))}
    err = {k: abs(stream[k] - exact[k]) for k in STREAM_TOL}
    check(all(err[k] <= STREAM_TOL[k] for k in STREAM_TOL),
          f"(b) streaming vs exact eval over {len(y)} rows: {err}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    rss_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"{tag} harness (b) eval of the {len(y)}-row train split: exact "
          f"{exact_s:.1f} s = {len(y) / exact_s:.0f} rows/s (predict's batch "
          f"path {predict_s[0]:.1f} s, {n_exact} batches; the metrics "
          f"{exact_s - predict_s[0]:.1f} s), total_auc "
          f"{exact['total_auc']:.5f}, mean_auc {exact['mean_auc']:.5f}; "
          f"streaming {stream_s:.1f} s = {len(y) / stream_s:.0f} rows/s "
          f"through {len(windows)} windows of {windows} rows ({n_stream} "
          f"batches); a window's host side and copy, timed apart: first "
          f"{copies['first'][0]:.2f} s, tail ({copies['tail'][1]} rows "
          f"padded to {W}) {copies['tail'][0]:.2f} s; streaming vs exact "
          f"{err} (tol {STREAM_TOL}); device peak {peak_gb:.2f} GiB, host "
          f"peak RSS {rss_peak:.2f} GiB")
    summary = {
        "rows": rows, "train_rows": len(y), "train_gb": nbytes / 1e9,
        "valid_rows": len(valid[1]), "data_seconds": data_s,
        "cut_steps": n_cut,
        "host_cut": {"seconds": host_s, "examples_per_s": n_cut * bs / host_s,
                     "chunk_seconds": chunk_s},
        "resident_cut": {"seconds": res_s,
                         "examples_per_s": n_cut * bs / res_s,
                         "chunk_seconds": chunk_r, "copy_seconds": copy_s},
        "rss_gb": {"before_epoch": rss_before, "after_cut": rss_cut,
                   "after_collect": rss_after},
        "valid_after_cut": {k: ev[k] for k in ("total_auc", "mean_auc",
                                               "total_loss")},
        "turns": [{k: v for k, v in t.items() if k != "losses"}
                  for t in turns],
        "launches": launches, "busy": busy,
        "eval": {"exact_seconds": exact_s, "predict_seconds": predict_s[0],
                 "exact_rows_per_s": len(y) / exact_s,
                 "streaming_seconds": stream_s,
                 "streaming_rows_per_s": len(y) / stream_s,
                 "windows": windows, "window_copy_seconds": {
                     k: v[0] for k, v in copies.items()},
                 "streaming_vs_exact": err,
                 "exact_total_auc": exact["total_auc"],
                 "launches_exact": exact_launches,
                 "launches_streaming": stream_launches},
        "device_peak_gb": peak_gb, "host_peak_rss_gb": rss_peak}
    del host
    torch.cuda.empty_cache()
    summary["phase_seconds"] = time.perf_counter() - t_phase
    print(f"harness (b): {summary['phase_seconds']:.1f} s")
    return summary


def phase27_main(rows: int) -> int:
    """Phase 27 (b) alone, after the build: the harness with ``rows``
    synthetic rows, the train split over the card's budget
    (:func:`harness_at_scale`)."""
    start = _phase_alone("phase 27")
    if start is None:
        return 1
    _, tag = start
    t0 = time.perf_counter()
    print(json.dumps({"harness_b": harness_at_scale(tag, rows)}))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


# -- serving as its users run it (phase 28) -------------------------------------

SERVE_BS = 4096                 # the host's --bs; it pads as tpurec's does
#                                 (tpurec/server.py:171-172): a 1-row request
#                                 is scored as one 4,096-row chunk
SERVE_DTYPE = "bfloat16"        # (a), the turns and the soak
SERVE_CLIENTS = 4               # (a): client threads, a keep-alive
#                                 connection each
SERVE_SMALL = 25                # (a): a client's 1-row and 512-row requests
SERVE_BIG = 10_000              # (a): the one large request, 3 chunks
SERVE_CPU_ROWS = 1000           # (a): rows held against the CPU's plain path
SERVE_START_S = 300             # a host's start: checkpoint, table, warm()
SERVE_STOP_S = 10               # SIGINT to the process's end
SERVE_RECORD_S = 120            # a signal to the wrapper's record
# (b): (--bs, table dtypes, request rows); every cell at each GRID_CLIENTS
GRID = ((SERVE_BS, ("float32", "bfloat16", "int8"), (1, 512, 4096)),
        (512, ("float32", "bfloat16", "int8"), (1, 512)))
GRID_CLIENTS = (1, 4, 16)
GRID_REQUESTS = 128             # timed requests a cell, shared by its clients
GRID_PROFILED = 32              # then timed inside the host's profiler window
TURNS = ("parent", "change", "change", "parent") * 2
TURN_CELLS = ((1, 1), (1, 16), (4096, 1), (4096, 16))  # (rows, clients)
SOAK_CLIENTS = 16               # a new connection every request
SOAK_SECONDS = 120
SOAK_SETTLE = 10                # memory_reserved may not grow after this
SOAK_SIZES = (1, 37, 512, 4096)
SOAK_POOL = 32                  # distinct requests, their replies known

# The host as ``python -m tpurec_torch.server`` runs it, in a process of
# its own started with ``python -c SERVE_WRAPPER OUT_DIR <server argv>``
# from the root of the tree whose package it serves.
SERVE_WRAPPER = r'''
import json
import os
import signal
import sys
import threading
import time

import torch

import tpurec_torch
from tpurec_torch import serve, server
from tpurec_torch.ops.attention import field_attention
from tpurec_torch.ops.embedding import embedding_gather

# SIGUSR1 opens a CUDA profiler window, SIGUSR2 closes it, SIGHUP takes a
# snapshot; each writes OUT/rec<k>.json, its k-th record.  At SIGINT the
# host ends and the last line is "server exit {json}".  Every record
# holds the host seconds spent so far in Predictor.predict_async (the
# submission, under the host's lock) and in its fetch.
OUT, ARGV = sys.argv[1], sys.argv[2:]
MARKERS = @MARKERS@
SYMS = {"embedding_gather": "gather_kernel",
        "field_attention": "field_attention_kernel"}
state = {"k": 0}
timing = {"submit_s": 0.0, "fetch_s": 0.0, "fetches": 0}
timing_lock = threading.Lock()
submit = serve.Predictor.predict_async


def timed_predict_async(self, X):
    t0 = time.perf_counter()
    fetch = submit(self, X)
    t1 = time.perf_counter()

    def timed_fetch():
        t2 = time.perf_counter()
        out = fetch()
        t3 = time.perf_counter()
        with timing_lock:
            timing["submit_s"] += t1 - t0
            timing["fetch_s"] += t3 - t2
            timing["fetches"] += 1
        return out

    return timed_fetch


serve.Predictor.predict_async = timed_predict_async


def launches():
    return {"embedding_gather": embedding_gather.launches,
            "field_attention": field_attention.launches}


def write(kind, **rec):
    with open("/proc/self/status") as f:
        st = dict(line.split(":", 1) for line in f if ":" in line)
    state["k"] += 1
    rec.update(kind=kind, rss_bytes=int(st["VmRSS"].split()[0]) * 1024,
               threads=int(st["Threads"]),
               memory_reserved=torch.cuda.memory_reserved(),
               max_memory_reserved=torch.cuda.max_memory_reserved(),
               launches=launches())
    with timing_lock:
        rec.update(timing)
    path = os.path.join(OUT, "rec%d.json" % state["k"])
    with open(path + ".tmp", "w") as f:
        json.dump(rec, f)
    os.replace(path + ".tmp", path)


def open_window(signum, frame):
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    # a capture drops its first kernels' records: spin kernels take that
    for _ in range(MARKERS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    state["prof"], state["t0"] = prof, time.perf_counter()
    write("opened")


def close_window(signum, frame):
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    window_s = time.perf_counter() - state["t0"]
    prof = state.pop("prof")
    prof.__exit__(None, None, None)
    busy_us, n, kernels = 0.0, 0, dict.fromkeys(SYMS, 0)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        name = torch._C._demangle(e.name()).removeprefix("void ")
        if "spin_kernel" in name:
            continue
        busy_us += e.duration_ns() / 1e3
        n += 1
        for k, sym in SYMS.items():
            kernels[k] += name.startswith("(anonymous namespace)::" + sym)
    write("window", window_s=window_s, busy_us=busy_us, records=n,
          kernel_records=kernels)


signal.signal(signal.SIGUSR1, open_window)
signal.signal(signal.SIGUSR2, close_window)
signal.signal(signal.SIGHUP, lambda signum, frame: write("state"))
print("server package "
      + os.path.realpath(os.path.dirname(tpurec_torch.__file__)), flush=True)
try:
    server.main(ARGV)
except KeyboardInterrupt:
    pass
print("server exit " + json.dumps({
    "launches": launches(), "memory_reserved": torch.cuda.memory_reserved(),
    "max_memory_reserved": torch.cuda.max_memory_reserved()}), flush=True)
'''


def _here():
    import os

    return os.path.dirname(os.path.abspath(__file__))


@functools.lru_cache(maxsize=None)
def _serve_load():
    """scripts/serve_load.py, the clients of phase 28."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "serve_load", os.path.join(_here(), "scripts", "serve_load.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class ServedHost:
    """``python -m tpurec_torch.server --ckpt CKPT --port 0 --bs BS
    --table_dtype DTYPE`` through SERVE_WRAPPER, in a process of its own
    started from ``tree`` (default: this checkout), its output gathered by
    a thread.  A host that dies fails the phase."""

    def __init__(self, ckpt, bs, dtype, out_dir, what, tree=None):
        import os

        self.tree = tree or _here()
        self.out_dir, self.what, self.bs = out_dir, what, bs
        os.makedirs(out_dir)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             SERVE_WRAPPER.replace("@MARKERS@", str(MARKERS)), out_dir,
             "--ckpt", ckpt, "--port", "0", "--bs", str(bs),
             "--table_dtype", dtype],
            cwd=self.tree, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env={**os.environ, "PYTHONPATH": self.tree})
        self.lines = []
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        self.records = 0
        self.url = None

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def _alive(self, doing):
        if self.proc.poll() is not None:
            self.reader.join(timeout=10)
            raise SmokeFailure(
                f"{self.what}: the host died (rc {self.proc.returncode}) "
                f"{doing}:\n" + "\n".join(self.lines[-40:]))

    def wait_ready(self):
        """-> its URL, from the startup line (the port it bound)."""
        import os
        import re

        deadline = self.t0 + SERVE_START_S
        while self.url is None:
            for line in list(self.lines):
                m = re.match(r"serving \S+ on (http://[\d.]+:\d+) \(", line)
                if m:
                    self.url = m.group(1)
            if self.url is None:
                self._alive("before its startup line")
                check(time.perf_counter() < deadline, f"{self.what}: no "
                      f"startup line in {SERVE_START_S} s")
                time.sleep(0.05)
        self.start_s = time.perf_counter() - self.t0
        pkg = os.path.realpath(os.path.join(self.tree, "tpurec_torch"))
        check(f"server package {pkg}" in self.lines,
              f"{self.what} does not serve {pkg}: {self.lines[:3]}")
        return self.url

    def record(self, sig):
        """Send ``sig`` to the wrapper -> the record it writes."""
        import os

        self._alive("before a signal")
        self.records += 1
        path = os.path.join(self.out_dir, f"rec{self.records}.json")
        self.proc.send_signal(sig)
        deadline = time.perf_counter() + SERVE_RECORD_S
        while not os.path.exists(path):
            self._alive(f"before its record {self.records}")
            check(time.perf_counter() < deadline,
                  f"{self.what}: no record {self.records} in "
                  f"{SERVE_RECORD_S} s")
            time.sleep(0.01)
        with open(path) as f:
            return json.load(f)

    def get(self, route):
        import urllib.request

        with urllib.request.urlopen(self.url + route, timeout=60) as r:
            return r.read()

    def stop(self):
        """SIGINT -> (rc, seconds to the end, the wrapper's exit record);
        the rc must be 0 within SERVE_STOP_S."""
        import signal

        self._alive("before SIGINT")
        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGINT)
        try:
            rc = self.proc.wait(timeout=SERVE_STOP_S)
        except subprocess.TimeoutExpired:
            self.kill()
            raise SmokeFailure(f"{self.what}: still running {SERVE_STOP_S} s "
                               "after SIGINT (killed)")
        stop_s = time.perf_counter() - t0
        self.reader.join(timeout=30)
        ends = [line for line in self.lines
                if line.startswith("server exit ")]
        check(rc == 0 and len(ends) == 1, f"{self.what}: rc {rc} after "
              "SIGINT:\n" + "\n".join(self.lines[-40:]))
        return rc, stop_s, json.loads(ends[0][len("server exit "):])

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self.reader.join(timeout=30)


def _mb(n):
    return f"{n / 2**20:.1f} MiB"


def served_checkpoint(tag, name, path, host):
    """Phase 28 (a) on one checkpoint, its host started already: a card
    Predictor of it in this process (--bs's one size, the host's table
    dtype) takes a SERVE_BIG-row predict_async under
    set_sync_debug_mode("error") and three requests fetched out of order;
    then SERVE_CLIENTS clients on the host, every reply bitwise that
    Predictor's, SERVE_CPU_ROWS rows within PRED_TOL of the CPU's plain
    path, the counters exact, #1 and #2's launches the chunks sent plus
    warm()'s, the end at SIGINT.  -> summary."""
    import signal

    from tpurec_torch.serve import predictor_from_checkpoint

    sl = _serve_load()
    t0 = time.perf_counter()
    pred = predictor_from_checkpoint(path, batch_sizes=(SERVE_BS,),
                                     table_dtype=SERVE_DTYPE).warm()
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 28)
    reqs = [[random_ids(rng, n) for _ in range(SERVE_SMALL) for n in (1, 512)]
            for _ in range(SERVE_CLIENTS)]
    big = random_ids(rng, SERVE_BIG)
    reqs[0].insert(SERVE_SMALL, big)
    want = [[pred(X) for X in r] for r in reqs]

    # the submission waits for nothing: no sync, and its host time
    chunks = -(-SERVE_BIG // SERVE_BS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t1 = time.perf_counter()
        fetch = pred.predict_async(big)
        submit_ms = (time.perf_counter() - t1) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    t1 = time.perf_counter()
    p_big = fetch()
    fetch_ms = (time.perf_counter() - t1) * 1e3
    check(np.array_equal(p_big, want[0][SERVE_SMALL]),
          f"{name}: the submission under sync debug differs")
    _, dev_us, _, n_launch = profile_calls(
        lambda: pred.predict_async(big)(), 1,
        f"{tag} serving {name} {SERVE_BIG} rows",
        ("gather_kernel", "field_attention_kernel"), per=chunks)
    device_ms = sum(dev_us.values()) / 1e3
    print(f"{tag} serving {name}: predict_async of {SERVE_BIG} rows "
          f"({chunks} chunks at B={SERVE_BS}) under set_sync_debug_mode("
          f"'error'): returned in {submit_ms:.3f} ms of host time, no sync; "
          f"its chunks {device_ms:.3f} ms of device time over "
          f"{n_launch:.0f} kernel launches (torch.profiler, copies "
          f"included); the fetch then waited {fetch_ms:.3f} ms")
    # three requests fetched in another order than submitted, one twice
    seq = {"A": want[0][SERVE_SMALL], "B": want[1][0], "C": want[1][1]}
    fetches = {"A": pred.predict_async(big),
               "B": pred.predict_async(reqs[1][0]),
               "C": pred.predict_async(reqs[1][1])}
    got = {k: fetches[k]() for k in "CAB"}
    check(all(np.array_equal(got[k], seq[k]) for k in seq)
          and np.array_equal(fetches["A"](), seq["A"]),
          f"{name}: requests fetched C, A, B (A twice) differ from their "
          "sequential results")
    print(f"{tag} serving {name}: A ({SERVE_BIG} rows), B (1), C (512) "
          "submitted A, B, C and fetched C, A, B, A again: bitwise their "
          "sequential results")

    url = host.wait_ready()
    warm = host.record(signal.SIGHUP)
    check(warm["launches"] == {"embedding_gather": 1, "field_attention": 1},
          f"{name}: the host's launches after warm() {warm['launches']}")
    bodies = [[(sl.body_of(X), len(X)) for X in r] for r in reqs]
    replies = {}

    def on_reply(i, j, reply):
        replies[i, j] = np.asarray(reply["predictions"], np.float32)

    n_req = sum(len(r) for r in reqs)
    n_rows = sum(len(X) for r in reqs for X in r)
    cell = sl.run_cell(url, bodies.__getitem__, SERVE_CLIENTS,
                       n_requests=n_req, on_reply=on_reply)
    differ = sorted(k for k, p in replies.items()
                    if not np.array_equal(p, want[k[0]][k[1]]))
    check(len(replies) == n_req and not differ, f"{name}: {len(replies)} "
          f"replies of {n_req}; not bitwise the Predictor's: {differ[:8]}")
    health = json.loads(host.get("/healthz"))
    metrics = host.get("/metrics").decode()
    check(health["n_requests"] == n_req and health["n_rows"] == n_rows
          and f"tpurec_requests_total {n_req}\n" in metrics
          and f"tpurec_rows_total {n_rows}\n" in metrics,
          f"{name}: /healthz {health}, /metrics {metrics!r}; sent {n_req} "
          f"requests, {n_rows} rows")
    cpu = predictor_from_checkpoint(path, batch_sizes=(SERVE_BS,),
                                    table_dtype=SERVE_DTYPE, device="cpu")
    cpu_err = float(np.max(np.abs(replies[0, SERVE_SMALL][:SERVE_CPU_ROWS]
                                  - cpu(big[:SERVE_CPU_ROWS]))))
    del cpu, pred
    torch.cuda.empty_cache()
    check(cpu_err <= PRED_TOL, f"{name}: served vs the CPU's plain path "
          f"max abs err {cpu_err}")
    rc, stop_s, end = host.stop()
    sent = sum(-(-len(X) // SERVE_BS) for r in reqs for X in r)
    check(end["launches"] == {"embedding_gather": sent + 1,
                              "field_attention": sent + 1},
          f"{name}: the host launched {end['launches']}, {sent} chunks sent "
          "and warm()'s 1 each")
    lat = {n: sl.summary(cell, rows=n) for n in (1, 512, SERVE_BIG)}
    print(f"{tag} serving {name} (python -m tpurec_torch.server --bs "
          f"{SERVE_BS} --table_dtype {SERVE_DTYPE}, up in {host.start_s:.1f} "
          f"s; this process's Predictor {load_s:.1f} s): {SERVE_CLIENTS} "
          f"clients, {n_req} requests, {n_rows} rows: every reply bitwise "
          f"the card Predictor's; {SERVE_CPU_ROWS} rows vs the CPU's plain "
          f"path {cpu_err:.3g} (tol {PRED_TOL}); /healthz and /metrics "
          f"{n_req} requests, {n_rows} rows; #1, #2 launched {sent} + 1 "
          f"(warm); SIGINT: rc {rc} in {stop_s:.2f} s; device peak "
          f"(max_memory_reserved) {_mb(end['max_memory_reserved'])}")
    print(f"{tag} serving {name} latency (host clock, keep-alive, "
          f"{SERVE_CLIENTS} clients at once): "
          + "; ".join(f"{n} rows p50 {r['p50_ms']:.3f} ms p99 "
                      f"{r['p99_ms']:.3f} ms ({r['requests']} requests)"
                      for n, r in lat.items())
          + f"; a 1-row request is scored as a {SERVE_BS}-row chunk (--bs "
          f"{SERVE_BS} pads as tpurec/server.py:171-172 does)")
    return {"requests": n_req, "rows": n_rows, "cpu_err": cpu_err,
            "launches": end["launches"], "chunks_sent": sent,
            "rc": rc, "stop_seconds": stop_s, "start_seconds": host.start_s,
            "max_memory_reserved": end["max_memory_reserved"],
            "submit_ms": submit_ms, "device_ms": device_ms,
            "launches_per_request": n_launch,
            "fetch_ms": fetch_ms, "latency": {str(n): r
                                              for n, r in lat.items()}}


def serving_main_path(tag, ckpts):
    """Phase 28 (a): each checkpoint of ``ckpts`` ({name: path}) served by
    its own host (:func:`served_checkpoint`); the hosts start at once."""
    import os
    import tempfile

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(dir=_here()) as tmp, \
            contextlib.ExitStack() as stack:
        hosts = {}
        for name, path in ckpts.items():
            hosts[name] = ServedHost(path, SERVE_BS, SERVE_DTYPE,
                                     os.path.join(tmp, name), name)
            stack.callback(hosts[name].kill)
        for name, path in ckpts.items():
            out[name] = served_checkpoint(tag, name, path, hosts[name])
    out["phase_seconds"] = time.perf_counter() - t0
    print(f"serving phase: {out['phase_seconds']:.1f} s")
    return out


def serving_checkpoint(path, tag):
    """Phase 16's fit (its data, the flagship MMoE at its settings, one
    epoch), its checkpoint written to ``path`` (``--phase 28``)."""
    from tpurec_torch.train import Trainer

    t0 = time.perf_counter()
    train, valid, _, w = cadence_data()
    tr = Trainer(harness_config(epoch=1), FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                 domain2group=np.arange(N_DOMAIN) % N_TOWER)
    out = tr.fit(train, valid, domain_cnt_weight=w)
    tr.save_checkpoint(path, extra={"phase": 28})
    del tr
    torch.cuda.empty_cache()
    print(f"{tag} serving: phase 16's fit, valid total_auc "
          f"{out['valid']['total_auc']:.5f}, checkpoint written in "
          f"{time.perf_counter() - t0:.1f} s")


def load_cell(tag, host, bodies, rows, clients, what):
    """One cell on ``host``: ``clients`` keep-alive clients, client i
    sending ``bodies[i]`` (``rows`` rows), serve_load.WARM untimed
    requests each, then GRID_REQUESTS timed (p50, p99, requests/s, rows/s; the
    host's seconds in the submission and in the fetch a request, from
    snapshots around them); then GRID_PROFILED more inside a profiler
    window of the host's (its device busy share; #1 and #2 must show in
    it).  -> summary."""
    import signal

    sl = _serve_load()
    marks = {}

    def mark(key, sig):
        return lambda: marks.update({key: host.record(sig)})

    def requests_of(i):
        return [(bodies[i], rows)]

    cell = sl.run_cell(host.url, requests_of, clients,
                       n_requests=GRID_REQUESTS, warm=sl.WARM,
                       before=mark("a", signal.SIGHUP))
    mark("b", signal.SIGHUP)()
    prof = sl.run_cell(host.url, requests_of, clients,
                       n_requests=GRID_PROFILED, warm=1,
                       before=mark("opened", signal.SIGUSR1))
    mark("closed", signal.SIGUSR2)()
    per = -(-rows // host.bs)
    for x, y, n in (("a", "b", GRID_REQUESTS),
                    ("opened", "closed", GRID_PROFILED)):
        got = {k: marks[y]["launches"][k] - marks[x]["launches"][k]
               for k in marks[y]["launches"]}
        check(all(v == n * per for v in got.values())
              and marks[y]["fetches"] - marks[x]["fetches"] == n,
              f"{what}: launches {got}, fetches "
              f"{marks[y]['fetches'] - marks[x]['fetches']}: {n} requests "
              f"of {per} chunks")
    a, b, closed = marks["a"], marks["b"], marks["closed"]
    check(all(v > 0 for v in closed["kernel_records"].values()),
          f"{what}: the host's profile saw {closed['kernel_records']}")
    s = sl.summary(cell)
    p = sl.summary(prof)
    s.update(submit_ms=(b["submit_s"] - a["submit_s"]) / GRID_REQUESTS * 1e3,
             fetch_ms=(b["fetch_s"] - a["fetch_s"]) / GRID_REQUESTS * 1e3,
             busy_share=closed["busy_us"] / 1e6 / closed["window_s"],
             busy_us_per_request=closed["busy_us"] / GRID_PROFILED,
             profiled={k: p[k] for k in ("p50_ms", "p99_ms",
                                         "requests_per_s")},
             kernel_records=closed["kernel_records"])
    print(f"{tag} {what} rows={rows} clients={clients}: p50 "
          f"{s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms, "
          f"{s['requests_per_s']:.1f} requests/s, {s['rows_per_s']:.0f} "
          f"rows/s; the host's submission {s['submit_ms']:.3f} ms and fetch "
          f"{s['fetch_ms']:.3f} ms a request; profiled ({GRID_PROFILED} "
          f"requests): device busy {100 * s['busy_share']:.1f}% "
          f"({s['busy_us_per_request']:.1f} us a request), p50 "
          f"{p['p50_ms']:.3f} ms, {p['requests_per_s']:.1f} requests/s")
    return s


def serving_load(tag, parent=None):
    """Phase 28 (b), ``--phase 28 [--parent DIR]``: phase 16's fit, its
    checkpoint served by a host per (--bs, table dtype) of GRID, all
    started at once; every cell of the grid (:func:`load_cell`); with
    ``parent`` (an unpacked tree of the parent commit) the corners
    TURN_CELLS on its host and on this tree's in TURNS; the soak: SOAK_CLIENTS
    clients on a new connection every request for SOAK_SECONDS, every
    reply bitwise the card Predictor's, the host's RSS, threads and
    memory_reserved at the start, after SOAK_SETTLE s and at the end
    (memory_reserved not above its SOAK_SETTLE s value).  -> summary."""
    import os
    import signal
    import tempfile

    from tpurec_torch.serve import predictor_from_checkpoint

    sl = _serve_load()
    t_phase = time.perf_counter()
    out = {"grid": [], "turns": []}
    with tempfile.TemporaryDirectory(dir=_here()) as tmp, \
            contextlib.ExitStack() as stack:
        ckpt = os.path.join(tmp, "mmoe.pkl")
        serving_checkpoint(ckpt, tag)
        hosts = {}

        def start(key, what, tree=None):
            bs, dtype = key[-2:]
            h = ServedHost(ckpt, bs, dtype, os.path.join(tmp, "_".join(
                map(str, key))), what, tree)
            stack.callback(h.kill)
            hosts[key] = h

        for bs, dtypes, _ in GRID:
            for dtype in dtypes:
                start(("change", bs, dtype), f"host bs={bs} {dtype}")
        if parent is not None:      # it builds its kernels at warm()
            start(("parent", SERVE_BS, SERVE_DTYPE),
                  f"parent host bs={SERVE_BS} {SERVE_DTYPE}", parent)
        for h in hosts.values():
            h.wait_ready()
        print(f"{tag} serving: {len(hosts)} hosts up in "
              + ", ".join(f"{h.start_s:.1f}" for h in hosts.values())
              + " s (started at once)")

        rng = np.random.default_rng(SEED + 280)
        bodies = {n: [sl.body_of(random_ids(rng, n))
                      for _ in range(max(GRID_CLIENTS))]
                  for n in sorted({n for _, _, rows in GRID for n in rows}
                                  | {n for n, _ in TURN_CELLS})}
        for bs, dtypes, rows in GRID:
            for dtype in dtypes:
                h = hosts["change", bs, dtype]
                for n in rows:
                    for c in GRID_CLIENTS:
                        s = load_cell(tag, h, bodies[n], n, c,
                                      f"grid bs={bs} {dtype}")
                        out["grid"].append({"bs": bs, "table_dtype": dtype,
                                            "rows": n, "clients": c, **s})
        if parent is not None:
            for turn, tree in enumerate(TURNS):
                h = hosts[tree, SERVE_BS, SERVE_DTYPE]
                for n, c in TURN_CELLS:
                    s = load_cell(tag, h, bodies[n], n, c,
                                  f"turn {turn} {tree}")
                    out["turns"].append({"turn": turn, "tree": tree,
                                         "rows": n, "clients": c, **s})

        # the soak
        h = hosts["change", SERVE_BS, SERVE_DTYPE]
        pred = predictor_from_checkpoint(ckpt, batch_sizes=(SERVE_BS,),
                                         table_dtype=SERVE_DTYPE)
        pool = [random_ids(rng, SOAK_SIZES[k % len(SOAK_SIZES)])
                for k in range(SOAK_POOL)]
        want = [pred(X) for X in pool]
        del pred
        torch.cuda.empty_cache()
        pool_bodies = [(sl.body_of(X), len(X)) for X in pool]
        orders = [rng.permutation(SOAK_POOL) for _ in range(SOAK_CLIENTS)]
        chunks = []

        def on_reply(i, j, reply):
            k = orders[i][j]
            p = np.asarray(reply["predictions"], np.float32)
            check(np.array_equal(p, want[k]), f"soak: a reply to request "
                  f"{k} ({len(pool[k])} rows) is not the Predictor's")
            chunks.append(-(-len(pool[k]) // SERVE_BS))

        recs = {"start": h.record(signal.SIGHUP)}

        def settle():
            time.sleep(SOAK_SETTLE)
            recs["settled"] = h.record(signal.SIGHUP)

        timer = threading.Thread(target=settle, daemon=True)
        cell = sl.run_cell(h.url, lambda i: [pool_bodies[k]
                                             for k in orders[i]],
                           SOAK_CLIENTS, seconds=SOAK_SECONDS,
                           keepalive=False, on_reply=on_reply,
                           before=timer.start)
        timer.join(timeout=SERVE_RECORD_S)
        recs["end"] = h.record(signal.SIGHUP)
        check("settled" in recs, "soak: no record after "
              f"{SOAK_SETTLE} s")
        n = {k: recs["end"]["launches"][k] - recs["start"]["launches"][k]
             for k in recs["end"]["launches"]}
        check(all(v == sum(chunks) for v in n.values()),
              f"soak: launches {n}, {sum(chunks)} chunks served")
        grew = (recs["end"]["memory_reserved"]
                - recs["settled"]["memory_reserved"])
        lat = {r: sl.summary(cell, rows=r) for r in SOAK_SIZES}
        print(f"{tag} soak: {SOAK_CLIENTS} clients, a new connection "
              f"(urllib) every request, {SOAK_SECONDS} s: {cell['requests']} "
              f"requests, {cell['rows']} rows, every reply bitwise the card "
              f"Predictor's; "
              + "; ".join(f"{r} rows p50 {s['p50_ms']:.3f} ms p99 "
                          f"{s['p99_ms']:.3f} ms" for r, s in lat.items())
              + "; the host at the start / after "
              f"{SOAK_SETTLE} s / at the end: RSS "
              + " / ".join(_mb(r["rss_bytes"]) for r in recs.values())
              + ", threads "
              + " / ".join(str(r["threads"]) for r in recs.values())
              + ", memory_reserved "
              + " / ".join(_mb(r["memory_reserved"]) for r in recs.values()))
        check(grew <= 0, f"soak: memory_reserved grew {grew} B after the "
              f"first {SOAK_SETTLE} s")
        out["soak"] = {"requests": cell["requests"], "rows": cell["rows"],
                       "requests_per_s": cell["requests"] / cell["wall_s"],
                       "latency": {str(r): s for r, s in lat.items()},
                       "records": {k: {f: r[f] for f in (
                           "rss_bytes", "threads", "memory_reserved",
                           "max_memory_reserved")}
                           for k, r in recs.items()}}
        ends = {}
        for key, h in hosts.items():
            rc, stop_s, end = h.stop()
            ends["_".join(map(str, key))] = {
                "rc": rc, "stop_seconds": stop_s, "start_seconds": h.start_s,
                "max_memory_reserved": end["max_memory_reserved"]}
        print(f"{tag} serving hosts: SIGINT, rc 0 each in "
              + ", ".join(f"{e['stop_seconds']:.2f}" for e in ends.values())
              + " s; device peak (max_memory_reserved) "
              + ", ".join(f"{k} {_mb(e['max_memory_reserved'])}"
                          for k, e in ends.items()))
        out["hosts"] = ends
    out["phase_seconds"] = time.perf_counter() - t_phase
    return out


def phase28_main(parent=None) -> int:
    """Phase 28 (b) alone, after the build (:func:`serving_load`)."""
    import os

    if parent is not None and not os.path.isfile(
            os.path.join(parent, "tpurec_torch", "server.py")):
        print(f"chip_smoke: --parent {parent} holds no tpurec_torch",
              file=sys.stderr)
        return 1
    start = _phase_alone("phase 28")
    if start is None:
        return 1
    _, tag = start
    t0 = time.perf_counter()
    print(json.dumps({"serving_load": serving_load(
        tag, None if parent is None else os.path.abspath(parent))}))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


# -- the mesh on four cards, a rank a card over NCCL (phase 29) ---------------

P29_CARDS = 4
P29_SHAPES = ((2, 2), (4, 1))   # (b): the harness on each
P29_PG_TIMEOUT = 300            # s: every phase-29 rank's group timeout
# (e): the flagship at 512 rows a data rank on one card (no mesh: phase 22
# (a) holds a world of one bitwise the mesh-less steps; every card runs
# its own at once, so the host is shared as in the mesh's turns), on
# (4, 1) and on (2, 2), P29_TURNS rounds in turns of P29_STEPS steps
P29_TIMED = (("1x1", (1, 1)), ("4x1", (4, 1)), ("2x2", (2, 2)))
P29_TURNS = 3
P29_STEPS = 64                  # (e): timed steps a turn, the fit's K loop
P29_PROFILED = 8                # (e): steps in each rank's profile
P29_SYMS = CLI_SYMS + SWEEP_SYMS[:1]    # #1, #2, #3, #6/#7's pass
P29_GLOO_MS = (65, 121)         # 4 gloo ranks on card 0 (PERF.md §5)
NCCL_PREFIX = "nccl"            # NCCL's kernels: ncclDevKernel_*, ncclKernel_*


def card_intervals(prof):
    """A capture's records on the card (kernels, copies, memsets) as
    (name, device index, start ns, end ns) in start order, user
    annotations and the capture window's markers left out."""
    from torch.autograd import DeviceType

    out, names = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        raw = e.name()
        name = names.get(raw)
        if name is None:
            name = names[raw] = (torch._C._demangle(raw) if len(raw) > 1
                                 else raw)
        if not is_marker(name):
            out.append((name, e.device_index(), e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    return sorted(out, key=lambda r: r[2])


def card_window(recs, window_s, n):
    """What :func:`card_intervals` of a window of ``n`` steps (``window_s``
    host seconds, synchronized) shows: the devices its records ran on,
    the card's busy share (the union of the records' spans), NCCL's
    kernels' device ms a step and share of the window (a collective's
    kernel runs from its launch until every peer's data is in: it
    includes the wait for the slowest rank), launches of P29_SYMS."""
    busy, end = 0, None
    for _, _, a, b in recs:
        if end is None or a >= end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    nccl = [(name, b - a) for name, _, a, b in recs
            if name.startswith(NCCL_PREFIX)]
    ns = sum(d for _, d in nccl)
    return {"devices": sorted({r[1] for r in recs}),
            "step_ms": window_s / n * 1e3,
            "busy_share": busy / 1e9 / window_s,
            "nccl_ms": ns / 1e6 / n, "nccl_share": ns / 1e9 / window_s,
            "nccl_launches": len(nccl) / n,
            "nccl_kernels": sorted({name.split("(")[0] for name, _ in nccl}),
            "records": len(recs),
            "port": {s: sum(1 for r in recs if port_kernel(r[0], s))
                     for s in P29_SYMS}}


def rank_profile(run, n, dev):
    """torch.profiler over ``run()`` (``n`` steps) on every rank at once
    (each rank's capture is its own process's), taken again on every rank
    while any rank's capture lacks a launch of P29_SYMS (records are lost
    at random, :func:`profile_calls`), up to CAPTURE_ATTEMPTS.  ->
    :func:`card_window` of the fullest capture."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from tpurec_torch.parallel import barrier

    best = None
    for attempt in range(CAPTURE_ATTEMPTS):
        barrier(dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            open_capture_window()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        CAPTURES["taken" if attempt == 0 else "retaken"] += 1
        win = card_window(card_intervals(prof), window_s, n)
        score = sum(min(c, n) for c in win["port"].values())
        if best is None or score > best[0]:
            best = (score, win)
        short = torch.tensor([int(score < n * len(P29_SYMS))], device=dev)
        dist.all_reduce(short)
        if int(short) == 0:
            break
    return best[1]


def _exact(name, got, want, done):
    """Hold a collective's result to ``want`` exactly (dtype, shape,
    values)."""
    got = torch.as_tensor(got).cpu()
    want = torch.as_tensor(want).cpu()
    check(got.dtype == want.dtype and got.shape == want.shape
          and torch.equal(got, want), f"(a) {name}: {got.tolist()} "
          f"({got.dtype}) vs {want.tolist()} ({want.dtype})")
    done.append(name)


def group_collectives(meshes, dev):
    """Phase 29 (a)'s collectives on known inputs, every result held
    exactly (small integers and eighths: their sums are exact in any
    order): ``broadcast_`` over the world; on each group of each mesh
    ``all_reduce_`` and ``all_gather`` (float32 and int64),
    ``all_reduce_grads`` on the data groups; on (2, 2) the autograd rules
    (``data_all_reduce``, ``model_all_reduce``, ``copy_to_model``,
    ``gather_from_model``, ``scatter_to_model``: forward and backward),
    ``check_replicas`` (the same rows pass, other rows raise) and
    ``data_totals`` (float64) on both meshes.  -> the names held."""
    import torch.distributed as dist

    from tpurec_torch.parallel import barrier
    from tpurec_torch.parallel.collectives import (
        all_gather, all_reduce_, all_reduce_grads, broadcast_,
        copy_to_model, data_all_reduce, gather_from_model,
        model_all_reduce, scatter_to_model)
    from tpurec_torch.parallel.feed import GlobalBatchFeed
    from tpurec_torch.train.loop import data_totals

    r = dist.get_rank()
    done = []
    for dt in (torch.float32, torch.int64):
        t = (torch.arange(6, device=dev) * (r + 1)).to(dt)
        _exact(f"broadcast_ {dt}", broadcast_(t, 0),
               torch.arange(6).to(dt), done)
    for key, mesh in meshes.items():
        for axis, group, ranks, index in (
                ("data", mesh.data_group, mesh.data_ranks, mesh.d),
                ("model", mesh.model_group, mesh.model_ranks, mesh.m)):
            if group is None:
                continue
            tot = float(sum(q + 1 for q in ranks))
            t = torch.full((5,), float(r + 1), device=dev)
            _exact(f"all_reduce_ {key} {axis}", all_reduce_(t, group),
                   torch.full((5,), tot), done)
            for dt in (torch.float32, torch.int64):
                t = (torch.arange(6, device=dev).reshape(2, 3) + 10 * r
                     ).to(dt)
                want = torch.cat([(torch.arange(6).reshape(2, 3) + 10 * q
                                   ).to(dt) for q in ranks])
                _exact(f"all_gather {key} {axis} {dt}",
                       all_gather(t, group, len(ranks), index), want, done)
        if mesh.data_group is not None:
            lin = torch.nn.Linear(3, 2).to(dev)
            for i, p in enumerate(lin.parameters()):
                p.grad = torch.full_like(p, float(r + 1 + i))
            s1, s2 = all_reduce_grads(
                lin.parameters(), mesh.data_group,
                torch.tensor(0.5 * (r + 1), device=dev),
                torch.tensor(float(r), device=dev))
            tot = float(sum(q + 1 for q in mesh.data_ranks))
            n = len(mesh.data_ranks)
            for i, p in enumerate(lin.parameters()):
                _exact(f"all_reduce_grads {key} grad {i}", p.grad,
                       torch.full(tuple(p.shape), tot + i * n), done)
            _exact(f"all_reduce_grads {key} scalars",
                   torch.stack([s1, s2]),
                   torch.tensor([0.5 * tot, float(sum(mesh.data_ranks))]),
                   done)
        totals = (np.arange(4) * 0.125 * (mesh.d + 1),
                  np.array([0.5 * (r + 1)]))
        got = data_totals(totals, mesh, dev)
        qs = mesh.data_ranks
        want = (np.arange(4) * 0.125 * sum(q // mesh.n_model + 1 for q in qs),
                np.array([0.5 * sum(q + 1 for q in qs)]))
        for i, (g, w) in enumerate(zip(got, want)):
            _exact(f"data_totals {key} {i}", torch.from_numpy(g),
                   torch.from_numpy(w), done)

    m = meshes["2x2"]
    d_tot = float(sum(q + 1 for q in m.data_ranks))
    m_tot = float(sum(q + 1 for q in m.model_ranks))
    for name, fn, fwd, bwd in (
            ("data_all_reduce", data_all_reduce, d_tot, d_tot),
            ("model_all_reduce", model_all_reduce, m_tot, float(r + 1)),
            ("copy_to_model", copy_to_model, float(r + 1), m_tot)):
        x = torch.full((3,), float(r + 1), device=dev, requires_grad=True)
        y = fn(x, m)
        (y * (r + 1)).sum().backward()
        _exact(name, y.detach(), torch.full((3,), fwd), done)
        _exact(f"{name} backward", x.grad, torch.full((3,), bwd), done)
    cols = slice(2 * m.m, 2 * m.m + 2)
    x = torch.full((2, 2), float(r), device=dev, requires_grad=True)
    y = gather_from_model(x, m, axis=1)
    w = torch.arange(8.0, device=dev).reshape(2, 4)
    (y * w).sum().backward()
    _exact("gather_from_model", y.detach(), torch.cat(
        [torch.full((2, 2), float(q)) for q in m.model_ranks], 1), done)
    _exact("gather_from_model backward", x.grad, w[:, cols], done)
    x = torch.arange(8.0, device=dev).reshape(2, 4).requires_grad_()
    y = scatter_to_model(x, m, axis=1)
    (y * (r + 1)).sum().backward()
    _exact("scatter_to_model", y.detach(), x.detach()[:, cols], done)
    _exact("scatter_to_model backward", x.grad, torch.cat(
        [torch.full((2, 2), float(q + 1)) for q in m.model_ranks], 1), done)

    feed = GlobalBatchFeed(m)
    X = np.arange(12, dtype=np.int32).reshape(4, 3) + 100 * m.d
    feed.check_replicas(X)          # the model replicas' rows agree
    try:
        feed.check_replicas(X + m.m)
        raised = False
    except ValueError:
        raised = True
    check(raised, f"(a) check_replicas took rank {r}'s other rows")
    done.append("check_replicas")
    barrier(dev)
    done.append("barrier")
    return done


P29_GATHER_CALLS = 50            # (a): calls a timing of an all-gather


def gather_timings(meshes, dev):
    """Phase 29 (a): ``collectives.all_gather`` (an all-reduce of n slots,
    all zero but this rank's) against ``all_gather_into_tensor`` (n times
    fewer bytes) on each group of each mesh, at the table update's
    exchange (the ids [512 / n_data, 23] int32 and their rows' gradients
    [512 / n_data, 23, 16] float32, the data group) and the expert banks'
    gather (``gather_from_model`` of the MMoE bank's outputs, 2 stacks a
    rank: [2, 512 / n_data, 64] float32, the model group): the two
    bitwise equal, then CUDA events around
    P29_GATHER_CALLS calls of each in turns (ours, real, real, ours).
    -> {case: {ours_ms, real_ms, bytes}}."""
    import torch.distributed as dist

    from tpurec_torch.parallel import barrier
    from tpurec_torch.parallel.collectives import all_gather

    F, D, H = len(FIELD_DIMS), MODEL["embed_dim"], MODEL[
        "mmoe_expert_dims"][-1]
    out = {}
    for key, mesh in meshes.items():
        b = 512 // mesh.n_data
        cases = [("data", mesh.data_group, mesh.n_data, mesh.d,
                  "ids", torch.arange(b * F, dtype=torch.int32, device=dev
                                      ).reshape(b, F) + mesh.rank),
                 ("data", mesh.data_group, mesh.n_data, mesh.d, "rows",
                  torch.randn(b, F, D, device=dev)),
                 ("model", mesh.model_group, mesh.n_model, mesh.m, "bank",
                  torch.randn(2, b, H, device=dev))]
        for axis, group, n, index, what, t in cases:
            if group is None:
                continue
            full = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                               dtype=t.dtype, device=dev)

            def ours():
                return all_gather(t, group, n, index)

            def real():
                dist.all_gather_into_tensor(full, t, group=group)
                return full

            check(torch.equal(ours(), real()), f"(a) {key} {axis} {what}: "
                  "the all-gather as an all-reduce is not the all-gather")
            ms = {"ours": [], "real": []}
            for name in ("ours", "real", "real", "ours"):
                fn = ours if name == "ours" else real
                for _ in range(3):
                    fn()
                barrier(dev)
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(P29_GATHER_CALLS):
                    fn()
                e1.record()
                torch.cuda.synchronize()
                ms[name].append(e0.elapsed_time(e1) / P29_GATHER_CALLS)
            out[f"{key} {axis} {what}"] = {
                "ours_ms": ms["ours"], "real_ms": ms["real"],
                "shape": list(t.shape), "dtype": str(t.dtype),
                "ours_bytes": n * t.numel() * t.element_size(),
                "real_bytes": t.numel() * t.element_size()}
    return out


def group_timings(meshes, dev):
    """Phase 29 (e) on one rank: the trainers of P29_TIMED at phase 16's
    settings (dropout 0.2, bf16 moments) with 512 rows a data rank, each
    step through the fit's indexed K-step loop (``scan_steps_idx``) on
    rows drawn from phase 16's train split; P29_TURNS rounds, the three
    in turns, of P29_STEPS steps (host clock, synchronized; the bytes
    the collectives reduced, :data:`collectives.STATS`; #1, #2, #3 and
    #6/7's pass launched once a step), then a profile of P29_PROFILED
    steps of each (:func:`rank_profile`).  -> record."""
    import dataclasses

    from tpurec_torch.parallel import barrier
    from tpurec_torch.parallel.collectives import STATS, reset_stats
    from tpurec_torch.train import Trainer

    data = mesh_fit_data()
    X, y = data.train
    counters = train_counters("mmoe")
    rng = np.random.default_rng(SEED + 29)      # every rank draws alike
    trainers, dsets = {}, {}
    for key, shape in P29_TIMED:
        cfg = mesh_config(DROPOUT)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, bs=512 * shape[0]))
        mesh = meshes.get(key)
        trainers[key] = (mesh_trainer(cfg, mesh) if mesh is not None else
                         Trainer(cfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                                 domain2group=np.arange(N_DOMAIN) % N_TOWER,
                                 device=dev))
        dsets[key] = trainers[key]._device_dataset(X, y)

    def draw(key, steps):
        tr = trainers[key]
        bs = tr.cfg.train.bs
        cols = tr._local_rows(bs)
        idx = rng.integers(0, len(y), (steps, bs))[:, cols]
        return (torch.as_tensor(idx.astype(np.int32), device=dev),
                torch.ones(idx.shape, device=dev))

    def run(key, idx, mask):
        tr = trainers[key]
        return tr.scan_steps_idx(tr.state, *dsets[key], idx, mask,
                                 tr.dropout_gen)

    for key, _ in P29_TIMED:                    # the first calls' set-up
        run(key, *draw(key, TRAIN_K))
    torch.cuda.synchronize()
    ms = {key: [] for key, _ in P29_TIMED}
    coll, launches, losses = {}, {}, {}
    for _ in range(P29_TURNS):
        for key, _ in P29_TIMED:
            idx, mask = draw(key, P29_STEPS)
            barrier(dev)
            torch.cuda.synchronize()
            reset_stats()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            out = run(key, idx, mask)
            torch.cuda.synchronize()
            ms[key].append((time.perf_counter() - t0) / P29_STEPS * 1e3)
            coll[key] = {"calls": STATS["calls"] / P29_STEPS,
                         "bytes": STATS["bytes"] / P29_STEPS,
                         "host_ms": STATS["seconds"] / P29_STEPS * 1e3}
            launches[key] = {k: fn.launches for k, fn in counters.items()}
            losses[key] = float(out.float().mean())
            check(np.isfinite(losses[key]), f"(e) {key}: loss {losses[key]}")
            check(launches[key] == {k: P29_STEPS for k in counters},
                  f"(e) {key}: launches {launches[key]} in {P29_STEPS} steps")
    prof = {}
    for key, _ in P29_TIMED:
        idx, mask = draw(key, P29_PROFILED)
        prof[key] = rank_profile(lambda: run(key, idx, mask), P29_PROFILED,
                                 dev)
    return {"ms": ms, "collectives": coll, "launches": launches,
            "mean_loss": losses, "profile": prof,
            "rows_a_step": {key: trainers[key].cfg.train.bs
                            for key, _ in P29_TIMED}}


def group_rank(out_dir):
    """One rank of phase 29 (a) and (e), started by
    :func:`group_main_path`: its backend, card and the card's UUID, the
    collectives on known inputs (:func:`group_collectives`) and the
    timings (:func:`group_timings`).  Writes ``group_rank_<r>.json``."""
    import os

    from tpurec_torch.parallel import make_mesh, shutdown_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    j = _join_rank()
    dev = j.device
    props = torch.cuda.get_device_properties(dev)
    rec = {"rank": j.rank, "backend": j.backend, "device": str(dev),
           "reason": j.reason, "uuid": str(props.uuid),
           "current_device": torch.cuda.current_device()}
    meshes = {"4x1": make_mesh(4, 1), "2x2": make_mesh(2, 2)}
    rec["a"] = group_collectives(meshes, dev)
    rec["gather"] = gather_timings(meshes, dev)
    rec["e"] = group_timings(meshes, dev)
    with open(os.path.join(out_dir, f"group_rank_{j.rank}.json"), "w") as f:
        json.dump(rec, f)
    shutdown_distributed()
    return 0


def group_main_path(tag):
    """Phase 29 (a) and (e): P29_CARDS ranks, one a card
    (:func:`group_rank`).  (a) every rank NCCL on its own card (four
    distinct UUIDs), every collective exact on known inputs, and in each
    rank's profiles every record on its own card with #1, #2, #3 and
    #6/7's pass among them; (e) ms a step, examples/s, each rank's busy
    share, NCCL's device share and the bytes reduced a step, one card
    against (4, 1) and (2, 2).  -> summary."""
    import os
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="group_")
    t0 = time.perf_counter()
    rcs, tails = _spawn_ranks(P29_CARDS, tmp, flag="--group-rank",
                              pg_timeout=P29_PG_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    check(rcs == [0] * P29_CARDS, f"(a) ranks exited {rcs}:\n{tails}")
    recs = []
    for r in range(P29_CARDS):
        with open(os.path.join(tmp, f"group_rank_{r}.json")) as f:
            recs.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    check_placement(recs, P29_CARDS, "(a)")
    check(all(r["backend"] == "nccl" and r["current_device"] == r["rank"]
              for r in recs), "(a) backends "
          + ", ".join(f"{r['backend']} on {r['device']} (current "
                      f"{r['current_device']})" for r in recs))
    uuids = [r["uuid"] for r in recs]
    check(len(set(uuids)) == P29_CARDS, f"(a) card UUIDs {uuids}")
    check(all(r["a"] == recs[0]["a"] for r in recs),
          "(a) the ranks held different collectives")
    for r in recs:
        for key, p in r["e"]["profile"].items():
            check(p["devices"] == [r["rank"]], f"(a) rank {r['rank']} "
                  f"{key}: its profile's records on cards {p['devices']}")
            check(all(c > 0 for c in p["port"].values()),
                  f"(a) rank {r['rank']} {key}: the profile's launches of "
                  f"{P29_SYMS}: {p['port']}")
    print(f"{tag} (a) {P29_CARDS} ranks, one a card: "
          + "; ".join(f"rank {r['rank']} {r['backend']} on {r['device']} "
                      f"({r['uuid'][:13]}...)" for r in recs)
          + f"; {len(recs[0]['a'])} collectives exact on known inputs on "
          f"every rank ({', '.join(recs[0]['a'])}); in every rank's "
          f"profiles each record ran on the rank's own card, #1, #2, #3 "
          f"and #6/7's pass among them ({ranks_s:.1f} s with start-up)")
    for case in recs[0]["gather"]:
        g = [r["gather"][case] for r in recs]
        print(f"{tag} (a) all_gather {case} {g[0]['shape']} "
              f"{g[0]['dtype']}: as an all-reduce "
              f"({g[0]['ours_bytes'] / 1e3:.1f} kB a rank) "
              + ", ".join(f"{min(x['ours_ms']):.4f}" for x in g)
              + f" ms a call by rank, all_gather_into_tensor "
              f"({g[0]['real_bytes'] / 1e3:.1f} kB) "
              + ", ".join(f"{min(x['real_ms']):.4f}" for x in g)
              + f" ms (CUDA events, the least of 2 turns of "
              f"{P29_GATHER_CALLS} calls each; bitwise equal)")
    out = {"ranks_seconds": ranks_s, "uuids": uuids,
           "collectives": recs[0]["a"], "by_config": {},
           "all_gather": {case: [r["gather"][case] for r in recs]
                          for case in recs[0]["gather"]}}
    for key, shape in P29_TIMED:
        rows = recs[0]["e"]["rows_a_step"][key]
        ms0 = recs[0]["e"]["ms"][key]
        per_card = key == "1x1"
        eps = [rows / (x / 1e3) for x in ms0]
        profs = [r["e"]["profile"][key] for r in recs]
        coll = recs[0]["e"]["collectives"][key]
        print(f"{tag} (e) {key}"
              + (" (no mesh, each card its own, all four at once)"
                 if per_card else f" {shape}")
              + f", {rows} rows a step: ms a step (host clock, "
              f"{P29_TURNS} turns of {P29_STEPS} steps; min / median / "
              f"max) "
              + "; ".join(f"rank {r['rank']} {_spread(r['e']['ms'][key])}"
                          for r in recs)
              + f"; examples/s {'a card' if per_card else 'the mesh'} "
              f"(rank 0) {_spread(eps)}; device busy "
              + ", ".join(f"{100 * p['busy_share']:.1f}%" for p in profs)
              + "; NCCL kernels "
              + ", ".join(f"{p['nccl_ms']:.3f} ms ({100 * p['nccl_share']:.1f}%)"
                          for p in profs)
              + f" a step by rank ({profs[0]['nccl_launches']:.1f} launches:"
              f" {profs[0]['nccl_kernels']}); collectives {coll['calls']:.1f}"
              f" a step, {coll['bytes'] / 1e6:.3f} MB reduced a step on "
              f"rank 0, host time in their calls {coll['host_ms']:.3f} ms "
              f"(under NCCL the enqueue); launches of {P29_STEPS} steps "
              f"{recs[0]['e']['launches'][key]}")
        out["by_config"][key] = {
            "rows_a_step": rows,
            "ms": {r["rank"]: r["e"]["ms"][key] for r in recs},
            "examples_per_s_rank0": eps,
            "busy_share": [p["busy_share"] for p in profs],
            "nccl_ms": [p["nccl_ms"] for p in profs],
            "nccl_share": [p["nccl_share"] for p in profs],
            "profile_step_ms": [p["step_ms"] for p in profs],
            "nccl_kernels": profs[0]["nccl_kernels"],
            "collectives_rank0": coll,
            "launches": recs[0]["e"]["launches"][key]}
    lo, hi = P29_GLOO_MS
    print(f"{tag} (e) beside 4 gloo ranks sharing card 0: {lo}-{hi} ms a "
          f"step at 512 rows a step (PERF.md §5)")
    return out


def _torchrun_cli(n, argv, timeout=MESH_TIMEOUT):
    """``python -m torch.distributed.run --standalone --nproc_per_node n
    -m tpurec_torch.cli argv``, its whole process group ended at
    ``timeout``.  -> (exit code, stdout, stderr)."""
    import os
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), "-m", "tpurec_torch.cli", *argv],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        check(False, f"torch.distributed.run -m tpurec_torch.cli {argv} "
              f"ran past {timeout} s: {err[-3000:]}")
    return p.returncode, out, err


# (d): phase 22 (d)'s and phase 23 (c)'s CLI configurations on four ranks
P29_CLI_RUNS = (
    ("mmoe", (4, 1), ["--model", "mmoe", "--dataset_name", "synthetic",
                      "--n_rows", str(CLI_ROWS), "--n_domain", "6", "--bs",
                      "512", "--epoch", "1", "--is_set_seed", "1", "--seed",
                      str(SEED + 29)]),
    ("cdc", (2, 2), ["--model", "cdc", "--base_model", "ple",
                     "--mesh_model", "2", "--mesh_expert_parallel",
                     "--dataset_name", "synthetic", "--n_rows",
                     str(CLI_SMALL_ROWS), "--n_domain", "6", "--epoch", "1",
                     "--bs", "512", "--warmup_step", "10",
                     "--update_interval", "100000", "--n_causal_mask", "4",
                     "--is_set_seed", "1", "--seed", str(SEED + 30)]))


def cli_checkpoint_eval(argv, seed, ckpt):
    """The CLI's checkpoint ``ckpt`` of a run with ``argv`` (its config
    at ``seed``, rank 0's) loaded on one device, its streaming eval of
    the run's valid split (the CLI's data, remade as ``cli.main`` makes
    it).  -> the eval's result."""
    import pickle

    from tpurec_torch import cli

    args = cli.parse_args(argv)
    args.seed = seed
    cfg = cli.build_config(args)
    np.random.seed(cfg.train.seed)
    train, valid, _, field_dims, n_domain, domain_idx = cli.load_dataset(cfg)
    if "cdc" in cfg.model.model:
        from tpurec_torch.cdc import CDCTrainer

        one = CDCTrainer(cfg, field_dims, n_domain, domain_idx)
        one.setup_data(train, valid)
        one.load_checkpoint(ckpt)
        return one.evaluate_streaming(one.valid_batcher)
    from tpurec_torch.train import Trainer

    with open(ckpt, "rb") as f:
        d2g = pickle.load(f)["domain2group"]
    one = Trainer(cfg, field_dims, n_domain, domain_idx, domain2group=d2g)
    one.load_checkpoint(ckpt)
    cnt = np.bincount(train[0][:, domain_idx], minlength=n_domain)
    return one.evaluate_streaming(*valid, cnt / cnt.sum())


def p29_cli(tag):
    """Phase 29 (d): the CLI under torch.distributed.run on P29_CARDS
    ranks, one a card (P29_CLI_RUNS): exit 0, no rank's exit fault
    (EXIT_FAULTS), every rank NCCL on its own card, the mesh record the
    run's shape, one result line; the checkpoint evaluated on one device
    within MESH_EVAL_TOL of the mesh's valid eval.  -> summary."""
    import os
    import shutil
    import tempfile

    out = {}
    for name, shape, argv in P29_CLI_RUNS:
        tmp = tempfile.mkdtemp(prefix="cli29_")
        argv = argv + ["--save_path", os.path.join(tmp, "ck"),
                       "--log_path", os.path.join(tmp, "log.jsonl")]
        t0 = time.perf_counter()
        rc, so, se = _torchrun_cli(P29_CARDS, argv)
        secs = time.perf_counter() - t0
        text = so + se
        check(rc == 0, f"(d) {name}: torch.distributed.run exited {rc}: "
              f"{se[-3000:]}")
        faults = [x for x in EXIT_FAULTS if x in text]
        check(not faults, f"(d) {name}: a rank printed {faults}: "
              f"{se[-3000:]}")
        joins = [f"rank {r} of {P29_CARDS} on cuda:{r}, backend nccl"
                 for r in range(P29_CARDS)]
        missing = [x for x in joins if x not in text]
        check(not missing, f"(d) {name}: no line {missing}")
        results = [json.loads(x) for x in so.splitlines()
                   if x.startswith("{") and '"valid"' in x]
        check(len(results) == 1, f"(d) {name}: {len(results)} result lines")
        with open(os.path.join(tmp, "log.jsonl")) as f:
            mrec = [r for r in map(json.loads, f) if "mesh" in r]
        check(len(mrec) == 1 and mrec[0]["mesh"] == list(shape)
              and mrec[0]["backend"] == "nccl"
              and mrec[0]["device"] == "cuda:0", f"(d) {name}: the mesh "
              f"record {mrec}")
        res = results[0]
        t1 = time.perf_counter()
        ev = cli_checkpoint_eval(argv, mrec[0]["seed"], res["checkpoint"])
        err = {k: abs(ev[k] - res["valid"][k])
               for k in ("total_auc", "total_loss")}
        print(f"{tag} (d) python -m torch.distributed.run --nproc_per_node "
              f"{P29_CARDS} -m tpurec_torch.cli {' '.join(argv[:8])} ...: "
              f"mesh {mrec[0]['mesh']}, every rank NCCL on its own card, "
              f"exit 0 in {secs:.1f} s, no rank printed {EXIT_FAULTS}; "
              f"valid total_auc {res['valid']['total_auc']:.5f}"
              + (f", clustering {res['domain2group_list']}"
                 if "domain2group_list" in res else "")
              + f"; its checkpoint on one device: streaming valid eval vs "
              f"the mesh's {err} (tol {MESH_EVAL_TOL}; "
              f"{time.perf_counter() - t1:.1f} s)")
        check(all(v <= MESH_EVAL_TOL for v in err.values()),
              f"(d) {name}: the checkpoint's eval on one device differs: "
              f"{err}")
        out[name] = {"mesh": mrec[0]["mesh"], "seconds": secs,
                     "valid": res["valid"], "one_device_err": err}
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase29_main(rows=None, parts="abcd") -> int:
    """Phase 29 alone: the mesh on P29_CARDS cards, one rank a card over
    NCCL.  ``parts``: (a) with (e)'s turns (:func:`group_main_path`), (b)
    the harness on P29_SHAPES (:func:`mesh_ranks_path`), (c) expert
    parallelism and CDC on (2, 2) (:func:`ep_main_path`), (d) the CLI
    (:func:`p29_cli`); ``rows``: also phase 26 (c) on the cards at that
    many rows, a mask row's steps profiled on every rank.  Fails on a host
    with fewer cards: it never falls back to gloo, shared cards or the
    CPU."""
    import shutil
    import tempfile

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    n = torch.cuda.device_count()
    if n < P29_CARDS:
        print(f"chip_smoke: phase 29 runs one rank on each of {P29_CARDS} "
              f"cards over NCCL, and torch.cuda.device_count() is {n}: it "
              "does not run on fewer cards", file=sys.stderr)
        return 1
    start = _phase_alone("phase 29")
    if start is None:
        return 1
    dev, _ = start
    gpus = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()
    print(f"{len(gpus)} cards: " + "; ".join(gpus))
    shm = (sh(["df", "-h", "/dev/shm"]).splitlines() or ["?"])[-1]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{torch.cuda.nccl.version()}; /dev/shm: {shm}")
    tag = f"[{gpus[0]}, {n} cards]"
    t0 = time.perf_counter()
    summary = {"cards": gpus}
    if "a" in parts or "e" in parts:
        summary["a_e"] = group_main_path(tag)
    if "b" in parts:
        for shape in P29_SHAPES:
            tmp = tempfile.mkdtemp(prefix="mesh29_")
            _, summary[f"b_{shape[0]}x{shape[1]}"] = mesh_ranks_path(
                dev, tag, tmp, None, MESH_DRAWS, shape, P29_PG_TIMEOUT)
            shutil.rmtree(tmp, ignore_errors=True)
    if "c" in parts:
        launches, summary["c"] = ep_main_path(dev, tag, cli=False,
                                              pg_timeout=P29_PG_TIMEOUT)
        summary["c"]["launches"] = launches
    if "d" in parts:
        summary["d"] = p29_cli(tag)
    if rows:
        summary["e_rows"] = cadence_at_scale(tag, rows, profile=True,
                                             pg_timeout=P29_PG_TIMEOUT)
    summary["seconds"] = time.perf_counter() - t0
    print(json.dumps({"mesh_cards": summary}))
    print(f"total {summary['seconds']:.1f} s")
    return 0


# -- Amazon as its users run it (phase 30) ------------------------------------

AMAZON_FIELDS = ("userid", "itemid", "weekday", "domain", "sales_chart",
                 "sales_rank", "brand", "price")
AMAZON_DOMAIN_IDX = 3
AMAZON_N_DOMAIN = 25
AMAZON_ROWS = 1_000_000         # (b): raw ratings, the JAX package's Amazon
#                                 "at real shape" (README)
AMAZON_SCALE_ROWS = 60_000_000  # (c): scripts/bench_amazon_scale.py's size
# (a): the dims (b)'s preprocessing of AMAZON_ROWS raw ratings drawn from
# SEED gives (809,117 rows in 25 domains; (b) holds them)
AMAZON_DIMS = (106071, 49845, 7, 25, 28, 11, 2, 10)
AMAZON_TREAT = 14               # (a): the checked burst's domains, 2 steps
AMAZON_UPDATES = 3              # (b), (c): matrix updates of the fit
AMAZON_WARMUP = 100             # (b): --warmup_step, 200 steps of 512
AMAZON_REQUESTS = (1,) * 8 + (SERVE_BS,) * 2    # (b): the served requests
AMAZON_TIMEOUT = 1800           # (b), (c): a user command's subprocess
# the user's command, as SURVEY.md and docs/MIGRATION.md give it
AMAZON_ARGV = ("--model", "cdc", "--dataset_name", "amazon", "--base_model",
               "ple", "--epoch", "1")

# (b), (c): AmazonPreprocessor in a process of its own, ``python -c
# AMAZON_PREPROCESS ROOT RATINGS META MODE``: MODE "main" makes the user's
# call, "stages" the same stages one by one; a line "stage" and a JSON
# [stage, seconds, rows] as each ends
AMAZON_PREPROCESS = r'''
import json
import os
import sys
import time

from tpurec_torch.data.preprocess import AmazonPreprocessor

root, ratings, meta, mode = sys.argv[1:5]
pre = AmazonPreprocessor(root)
t0 = time.perf_counter()


def done(stage, n):
    global t0
    print("stage " + json.dumps([stage, time.perf_counter() - t0, n]),
          flush=True)
    t0 = time.perf_counter()


if mode == "main":
    done("main", len(pre.main(ratings, meta)))
else:
    df = pre.load_ratings(ratings)
    done("load_ratings", len(df))
    df = pre.merge_metadata(df, meta)
    done("k-core + merge_metadata", len(df))
    out = pre.finalize(df)
    del df
    done("finalize", len(out))
    out.to_csv(pre.preprocess_path, index=False)
    done("write csv", os.path.getsize(pre.preprocess_path))
'''

# (b): ``python -m tpurec_torch.cli`` with the kernels' launch counters
# printed at exit ("launches" and a JSON object)
CLI_WRAPPER = r'''
import atexit
import json
import runpy

from tpurec_torch.ops.attention import field_attention, field_attention_bwd
from tpurec_torch.ops.embedding import embedding_gather
from tpurec_torch.ops.fused_adam import fused_decay_adam, fused_sparse_adam

COUNTERS = {"embedding_gather": embedding_gather,
            "field_attention_train": field_attention,
            "field_attention_bwd": field_attention_bwd,
            "fused_decay_adam": fused_decay_adam,
            "fused_sparse_adam": fused_sparse_adam}
atexit.register(lambda: print("launches " + json.dumps(
    {k: f.launches for k, f in COUNTERS.items()}), flush=True))
runpy.run_module("tpurec_torch.cli", run_name="__main__", alter_sys=True)
'''


def _digits(a, n):
    """The n decimal digits of each of ``a`` (int64, < 10**n) as ASCII."""
    p = 10 ** np.arange(n - 1, -1, -1, dtype=np.int64)
    return (a[:, None] // p % 10 + 48).astype(np.uint8)


def _power_law_ids(rng, n, vocab):
    """scripts/bench_amazon_scale.py's heavy-tailed id draw."""
    return np.minimum(np.floor(vocab * rng.random(n) ** 2.2).astype(np.int64),
                      vocab - 1)


def amazon_raw(root, rows, seed=SEED, chunk=5_000_000):
    """Raw Amazon input in ``root`` from ``default_rng(seed)``, in
    scripts/bench_amazon_scale.py's schema and distributions (that script
    imports the JAX package): a headerless ``itemid,userid,rating,
    timestamp`` CSV of ``rows`` ratings over rows / 20 items and 2 rows /
    15 users (its 60M, 3M, 8M), power-law ids, 85% of the timestamps in
    the 12 months before the dataset's end and the rest in the year
    before them, ratings 1-5 at .05/.07/.13/.25/.5; and a JSON-lines
    metadata file, one line an item: its domain of 25, a brand of 30,000
    (0 none), price and sales rank (in one of the 25 charts or 2 more)
    missing for 25% and 20%.  The ratings are written as bytes from
    digits (35 a line).  -> (ratings path, meta path, seconds)."""
    import os
    from datetime import timedelta

    from tpurec_torch.data.preprocess import (AMAZON_DOMAIN2ENCODER,
                                              AmazonPreprocessor)

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    n_items, n_users = rows // 20, rows * 2 // 15
    end = AmazonPreprocessor(root).end_date
    start = end - int(timedelta(days=365).total_seconds())
    ratings = os.path.join(root, "ratings.csv")
    with open(ratings, "wb") as f:
        for lo in range(0, rows, chunk):
            m = min(chunk, rows - lo)
            ts = np.where(rng.random(m) < 0.85, rng.integers(start, end, m),
                          rng.integers(start - 3 * 10**7, start, m))
            item = _power_law_ids(rng, m, n_items)
            user = _power_law_ids(rng, m, n_users)
            r = rng.choice(np.arange(1, 6), m, p=[.05, .07, .13, .25, .5])
            line = np.empty((m, 35), np.uint8)
            line[:, [0, 10, 9, 19, 21, 22, 23, 34]] = np.frombuffer(
                b"AU,,.0,\n", np.uint8)
            line[:, 1:9] = _digits(item, 8)
            line[:, 11:19] = _digits(user, 8)
            line[:, 20] = 48 + r
            line[:, 24:34] = _digits(ts, 10)
            f.write(line.tobytes())
    domains = list(AMAZON_DOMAIN2ENCODER)
    charts = domains + ["Beauty & Personal Care", "Health & Household"]
    meta = os.path.join(root, "meta.json")
    with open(meta, "w") as f:
        for lo in range(0, n_items, 250_000):
            m = min(250_000, n_items - lo)
            dom = rng.integers(0, len(domains), m)
            chart = rng.integers(0, len(charts), m)
            brand = rng.integers(0, 30000, m)
            price = np.round(rng.lognormal(2.5, 1.0, m), 2)
            rank = rng.integers(1, 3_000_000, m)
            has_price, has_rank = rng.random(m) > 0.25, rng.random(m) > 0.2
            lines = []
            for j in range(m):
                rec = ('{"asin": "A%08d", "brand": "%s", "category": '
                       '["%s", "sub", "subsub"]' % (
                           lo + j, f"brand_{brand[j]}" if brand[j] else "",
                           domains[dom[j]]))
                if has_price[j]:
                    rec += ', "price": "$%.2f"' % price[j]
                if has_rank[j]:
                    rec += (f', "rank": "#{rank[j]:,} in {charts[chart[j]]} '
                            '(See Top 100)"')
                lines.append(rec + "}")
            f.write("\n".join(lines) + "\n")
    return ratings, meta, time.perf_counter() - t0


def _amazon_preprocess(root, ratings, meta, mode):
    """AMAZON_PREPROCESS in a process of its own, its resident memory read
    from /proc every 20 ms (the child's own ru_maxrss starts from this
    process's, whose image it is spawned from, and the card's machine
    shows no VmHWM) -> [stage, seconds, rows, peak RSS GiB so far] a
    stage."""
    import os

    proc = subprocess.Popen(
        [sys.executable, "-c", AMAZON_PREPROCESS, root, ratings, meta, mode],
        cwd=_here(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": _here()})
    lines, err = [], []
    readers = [threading.Thread(target=lambda f=f, to=to: to.extend(f),
                                daemon=True)
               for f, to in ((proc.stdout, lines), (proc.stderr, err))]
    for r in readers:
        r.start()
    peak_kb, stages = 0, []
    deadline = time.perf_counter() + AMAZON_TIMEOUT
    while True:
        done = proc.poll() is not None
        try:
            with open(f"/proc/{proc.pid}/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        peak_kb = max(peak_kb, int(line.split()[1]))
        except (OSError, ValueError):
            pass
        if done:
            for r in readers:
                r.join(timeout=30)
        for line in lines[len(stages):]:
            check(line.startswith("stage "), f"AmazonPreprocessor: {line}")
            stages.append(json.loads(line[6:]) + [peak_kb / 2**20])
        if done:
            break
        if time.perf_counter() > deadline:
            proc.kill()
            raise SmokeFailure(f"AmazonPreprocessor ({mode}) ran over "
                               f"{AMAZON_TIMEOUT} s")
        time.sleep(0.02)
    check(proc.returncode == 0 and stages, f"AmazonPreprocessor ({mode}) "
          f"exited {proc.returncode}: {''.join(err)[-3000:]}")
    return stages


def amazon_ids(rng, n, dims=AMAZON_DIMS):
    return np.stack([rng.integers(0, d, n) for d in dims], 1).astype(np.int32)


def amazon_kernels(dev, tag):
    """Phase 30 (a), the kernels at Amazon's shapes (8 fields, domain at
    field 3, AMAZON_DIMS' table, the flagship's D=16, A=64, H=2, L=3):
    #1 bitwise its plain version at B = 1, 512, 4096, 4097 with ids out
    of range; #2 in eval within ATTN_TOL at B = 1, R - 1, R, R + 1 (R=12
    at 4096: 96 stacked rows), 512, 513, 4096, 4097, bitwise repeatable;
    #2 in training and #3 (:func:`attention_train_checks`); #7's pass
    carrying #6 on a batch's ids with duplicates, f32 moments (the CLI's
    default) against the CPU (:func:`table_update_vs_cpu`).  Then each
    kernel's time at B = 512 and 4096 beside its plain version, the
    library call and its bound, recomputed for F=8.  -> (max errors by
    kernel name, timings by kernel name and batch)."""
    from tpurec_torch.nn.core import EmbeddingLayout
    from tpurec_torch.nn.initializers import init_module
    from tpurec_torch.nn.interactions import FieldAttention
    from tpurec_torch.ops.attention import (_sm_count, bwd_config,
                                            field_attention,
                                            field_attention_reference,
                                            fwd_config)
    from tpurec_torch.ops.embedding import embedding_gather_reference
    from tpurec_torch.train.hybrid import EmbeddingUpdater
    from tpurec_torch.config import TrainConfig

    rng = np.random.default_rng(SEED + 30)
    gen = torch.Generator().manual_seed(SEED + 30)
    layout = EmbeddingLayout(AMAZON_DIMS)
    F, D = len(AMAZON_DIMS), MODEL["embed_dim"]
    A, H, L = (MODEL["atten_embed_dim"], MODEL["att_head_num"],
               MODEL["att_layer_num"])
    table = torch.randn(layout.vocab, D, generator=gen)
    table[layout.n_rows:] = 0.0
    q = table.to(dev)
    offsets, limits = layout.device_arrays(dev, layout.vocab)
    g = layout.gather(q)
    errs = {"embedding_gather": 0.0}
    for B in (1, 512, 4096, 4097):
        X = amazon_ids(rng, B)
        X[0, 2] = -1                     # wraps inside the small prefix
        X[-1, 0] = 10**8                 # past the table -> fill
        ids = torch.from_numpy(X).to(dev)
        got, want = g(ids), embedding_gather_reference(q, ids, offsets,
                                                       limits)
        torch.cuda.synchronize()
        check(got.shape == (B, F, D) and nan_equal(got, want),
              f"amazon gather B={B} differs")

    def emb_of(B):
        return g(torch.from_numpy(amazon_ids(rng, B)).to(dev))

    head = init_module(FieldAttention(D, A, L, H), gen).to(dev)
    flat = [w.detach() for w in head.flat_weights()]
    n_sm = _sm_count(dev)
    R = fwd_config(4096, F, D, A, H, n_sm)[0]
    check((R, fwd_config(512, F, D, A, H, n_sm)[0],
           bwd_config(512, F, D, A, H, n_sm)[0]) == (12, 4, 2),
          f"amazon attention: rows a block {R} at 4096")
    err = 0.0
    bs = sorted({1, R - 1, R, R + 1, 512, 513, 4096, 4097})
    for B in bs:
        emb = emb_of(B)
        got = field_attention(emb, flat, L, H)
        again = field_attention(emb, flat, L, H)
        want = field_attention_reference(emb, flat, L, H)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"amazon attention B={B}: two calls "
              "differ")
        e = (got - want).abs().max().item()
        check(e <= ATTN_TOL, f"amazon attention B={B}: max abs err {e}")
        err = max(err, e)
    errs["field_attention"] = err
    print(f"{tag} amazon #1 bitwise its plain version at B=1,512,4096,4097 "
          f"(ids out of range included); #2 eval max abs err {err:.3g} (tol "
          f"{ATTN_TOL}) at B={','.join(map(str, bs))}, F={F}: {R} rows a "
          f"block at 4096 ({R * F} stacked), 4 at 512; bitwise repeatable")
    seed = torch.tensor(4242, device=dev)
    errs["field_attention_train"], errs["field_attention_bwd"] = \
        attention_train_checks(dev, flat, emb_of, sorted({1, 2, 3, 512, 4096,
                                                          4097}), L, H, seed,
                               f" (amazon, F={F})")
    X = amazon_ids(rng, 512)
    X[:256, 0] = X[256:, 0]              # duplicate user ids
    err6, worst6, r6, _, _ = table_update_vs_cpu(
        AMAZON_DIMS, table, X, torch.float32, "amazon table update")
    errs["fused_sparse_adam"] = errs["fused_decay_adam"] = err6
    print(f"{tag} amazon table update ({layout.vocab} x {D}, f32 moments, "
          f"{len(layout.big_fields)} big fields after "
          f"{len(layout.small_fields)} small ones, {layout.small_rows} small "
          f"rows): one launch of the pass carrying the rows and its sum's "
          f"finish; {worst6:.3g} x max(1, |p'|, step) vs the CPU (tol "
          f"{ROWS_TOL}), sumsq rel err {r6:.3g}")

    # times at F=8 (CUDA events; device: torch.profiler, launched alone)
    rows = {k: {} for k in ("field_attention", "field_attention_train",
                            "field_attention_bwd", "fused_sparse_adam")}
    for B in BATCH_SIZES:
        by_name = attention_timing_rows([emb_of(B) for _ in range(4)], flat,
                                        L, H, seed, alone=True)
        for name, r in by_name.items():
            rows[name][B] = r
        # the table pass with the batch's big-field ids, f32 moments
        upd = EmbeddingUpdater(AMAZON_DIMS, TrainConfig(bs=B), L2)
        x = torch.from_numpy(amazon_ids(rng, B)).to(dev)
        ids, g_ids = upd.big_rows(x, torch.randn(B, F, D, device=dev))
        p = q.clone()
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        rows["fused_sparse_adam"][B] = table_pass_timing(
            p, m, v, ids, g_ids, torch.randn(upd.S, D, device=dev),
            plain=True)[0]
        del p, m, v
    for name, by_b in rows.items():
        for B, r in by_b.items():
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
            print(f"{tag} amazon {name} B={B}, F={F}: kernel {r['ms']:.4f} ms"
                  f" (device {r['device_ms']:.4f} ms launched alone), plain "
                  f"{r['plain_ms']:.4f} ms, library {lib}, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return errs, {k: {str(b): r for b, r in v.items()}
                  for k, v in rows.items()}


def amazon_steps(tag):
    """Phase 30 (a), the steps: CDC on PLE at full width
    (:func:`cdc_config` with base "ple") on Amazon's schema, make_synthetic
    rows at AMAZON_DIMS with 25 domains at field 3: a fresh trainer's
    treatment burst of AMAZON_TREAT domains (2 hybrid steps at W = 3,584)
    and its 25-domain probe eval, on the card and on the CPU's plain path
    on the card's branches from step 0 (:func:`populate_row_vs_cpu`: the
    losses within CPU_LOSS_RTOL).  -> summary, its launches included."""
    from tpurec_torch.cdc import CDCTrainer
    from tpurec_torch.data import make_synthetic

    data = make_synthetic(
        n_rows=65536, n_fields=len(AMAZON_DIMS), n_domain=AMAZON_N_DOMAIN,
        field_dims=AMAZON_DIMS, domain_idx=AMAZON_DOMAIN_IDX, seed=1)
    cfg = cdc_config(dropout=0.0, wd=CDC_CHECK_WD, base="ple",
                     embedding_moments_dtype="float32")
    tr = CDCTrainer(cfg, AMAZON_DIMS, AMAZON_N_DOMAIN, AMAZON_DOMAIN_IDX)
    blob = tr.snapshot_bytes()
    del tr
    torch.cuda.empty_cache()
    t = CDCTrainer(cfg, AMAZON_DIMS, AMAZON_N_DOMAIN, AMAZON_DOMAIN_IDX,
                   device="cpu")
    t.setup_data(data.train)
    bidx, bmask, bvalid = t._multi_burst_sched(list(range(AMAZON_TREAT)), 1,
                                               2)
    eidx, emask = t._eval_sched()
    del t
    check(int(bvalid.sum()) == 2 and bidx.shape[1] == 7 * 512,
          f"amazon: the checked burst runs {int(bvalid.sum())} steps of "
          f"{bidx.shape[1]} rows")
    X, y = data.train
    return populate_row_vs_cpu(
        cfg, X, y, AMAZON_DIMS, AMAZON_N_DOMAIN, blob,
        np.arange(AMAZON_N_DOMAIN) % N_TOWER,
        (bidx, bmask, bvalid, eidx, emask), 0, tag,
        "amazon cdc ple burst", domain_idx=AMAZON_DOMAIN_IDX)


def amazon_main_path(dev, tag):
    """Phase 30 (a), in the default run: :func:`amazon_kernels` and
    :func:`amazon_steps`.  -> (launches of the steps, summary)."""
    t_phase = time.perf_counter()
    errs, timings = amazon_kernels(dev, tag)
    steps = amazon_steps(tag)
    summary = {"errors": errs, "timings": timings, "steps": steps,
               "phase_seconds": time.perf_counter() - t_phase}
    print(f"amazon phase: {summary['phase_seconds']:.1f} s")
    return steps["launches"], summary


def _amazon_split_steps(train, bs=512):
    """A CDC epoch's steps: each domain's train rows in batches of bs."""
    counts = np.bincount(train[0][:, AMAZON_DOMAIN_IDX],
                         minlength=AMAZON_N_DOMAIN)
    return int(np.sum(-(-counts // bs)))


def _post(url, X):
    """POST ``X``'s rows to a host's /predict -> its predictions."""
    import urllib.request

    req = urllib.request.Request(url + "/predict",
                                 data=_serve_load().body_of(X))
    with urllib.request.urlopen(req, timeout=120) as r:
        check(r.status == 200, f"/predict {r.status}")
        return np.asarray(json.loads(r.read())["predictions"], np.float32)


def amazon_cli_path(tag, rows=AMAZON_ROWS):
    """Phase 30 (b), ``--phase 30``: the user's commands, each in a process
    of its own.  Raw ratings and metadata (:func:`amazon_raw`, ``rows``
    ratings); ``AmazonPreprocessor(root).main(ratings, meta)``; then
    ``python -m tpurec_torch.cli --model cdc --dataset_name amazon
    --base_model ple --epoch 1`` (through CLI_WRAPPER, which prints the
    kernels' launches at exit) with --warmup_step AMAZON_WARMUP and the
    --update_interval that gives the epoch AMAZON_UPDATES matrix updates:
    rc 0 and no exit fault, 25 domains at field 3 and AMAZON_DIMS, a
    finite valid AUC for every domain, the clustering decided (in the
    log, once an update) and saved in the checkpoint, #1 = #2 and #3 =
    #6 = #7 launched; then ``python -m tpurec_torch.server --ckpt`` that
    checkpoint, its replies to 1-row and SERVE_BS-row requests within
    PRED_TOL of the checkpoint's Predictor on the CPU, #1 and #2 launched
    once a chunk.  -> summary."""
    import os
    import pickle
    import tempfile

    from tpurec_torch import cli
    from tpurec_torch.serve import predictor_from_checkpoint

    t_phase = time.perf_counter()
    out = {"raw_ratings": rows}
    with tempfile.TemporaryDirectory(dir=_here()) as root, \
            contextlib.ExitStack() as stack:
        ratings, meta, out["raw_seconds"] = amazon_raw(root, rows)
        t0 = time.perf_counter()
        out["preprocess"] = _amazon_preprocess(root, ratings, meta, "main")
        out["preprocess_seconds"] = time.perf_counter() - t0
        argv = list(AMAZON_ARGV) + ["--data_path", root]
        train, valid, test, dims, n_domain, di = cli.load_dataset(
            cli.build_config(cli.parse_args(argv)))
        check((dims, n_domain, di) == (AMAZON_DIMS, AMAZON_N_DOMAIN,
                                       AMAZON_DOMAIN_IDX),
              f"amazon (b): field_dims {dims}, {n_domain} domains, domain at "
              f"field {di}; (a) ran at {AMAZON_DIMS}")
        n_steps = _amazon_split_steps(train)
        interval = -(-n_steps // 5)      # 2 x 1024 / 512 x this steps apart
        save, log = os.path.join(root, "save"), os.path.join(root, "log.jsonl")
        argv += ["--warmup_step", str(AMAZON_WARMUP), "--update_interval",
                 str(interval), "--save_path", save, "--log_path", log]
        split = [len(s[1]) for s in (train, valid, test)]
        del train, valid, test
        print(f"{tag} amazon (b) {rows} raw ratings written in "
              f"{out['raw_seconds']:.1f} s; AmazonPreprocessor.main in "
              f"{out['preprocess_seconds']:.1f} s -> "
              f"{out['preprocess'][0][2]} rows (peak RSS "
              f"{out['preprocess'][0][3]:.2f} GiB); the timestamp split "
              f"{split} rows, field_dims {dims}, an epoch of {n_steps} steps")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", CLI_WRAPPER] + argv, cwd=_here(),
            capture_output=True, text=True, timeout=AMAZON_TIMEOUT,
            env={**os.environ, "PYTHONPATH": _here()})
        out["cli_seconds"] = time.perf_counter() - t0
        check(proc.returncode == 0, f"amazon (b): python -m tpurec_torch.cli "
              f"exited {proc.returncode}: {proc.stderr[-3000:]}")
        faults = [f for f in EXIT_FAULTS if f in proc.stderr + proc.stdout]
        check(not faults, f"amazon (b): exit fault {faults}")
        lines = proc.stdout.splitlines()
        res = json.loads([x for x in lines if x.startswith("{")][-1])
        launches = json.loads([x for x in lines
                               if x.startswith("launches ")][-1][9:])
        with open(log) as f:
            recs = [json.loads(x) for x in f if x.strip()]
        ups = [r for r in recs if "cdc_update_seconds" in r]
        aucs = res["valid"]["domain_auc"] if res.get("valid") else {}
        check(len(aucs) == AMAZON_N_DOMAIN
              and all(np.isfinite(float(a)) for a in aucs.values()),
              f"amazon (b): valid per-domain AUC {aucs}")
        check(len(ups) == AMAZON_UPDATES, f"amazon (b): {len(ups)} matrix "
              f"updates, want {AMAZON_UPDATES}")
        with open(res["checkpoint"], "rb") as f:
            payload = pickle.load(f)
        check(tuple(payload["field_dims"]) == AMAZON_DIMS
              and payload["n_domain"] == AMAZON_N_DOMAIN
              and payload["domain_idx"] == AMAZON_DOMAIN_IDX
              and len(res["domain2group_list"]) == AMAZON_N_DOMAIN
              and payload["domain2group_list"] == res["domain2group_list"],
              f"amazon (b): the checkpoint's schema and clustering "
              f"{payload['field_dims']}, {payload['domain2group_list']}; "
              f"the run's {res['domain2group_list']}")
        n = launches
        check(n["embedding_gather"] == n["field_attention_train"]
              > n["field_attention_bwd"] == n["fused_decay_adam"]
              == n["fused_sparse_adam"] > 0, f"amazon (b): launches {n}")
        out.update(
            split_rows=split, epoch_steps=n_steps, update_interval=interval,
            launches=launches, update_seconds=[r["cdc_update_seconds"]
                                               for r in ups],
            clusterings=[r["domain2group"] for r in ups],
            valid=res["valid"], test=res.get("test"),
            domain2group=res["domain2group_list"])
        epoch = [r for r in recs if "epoch_seconds" in r][-1]
        print(f"{tag} amazon (b) python -m tpurec_torch.cli "
              f"{' '.join(AMAZON_ARGV)} --warmup_step {AMAZON_WARMUP} "
              f"--update_interval {interval}: rc 0 in {out['cli_seconds']:.1f}"
              f" s (the epoch {epoch['epoch_seconds']:.1f} s, "
              f"{AMAZON_UPDATES} updates "
              + ", ".join(f"{s:.1f}" for s in out["update_seconds"])
              + f" s); valid total_auc {res['valid']['total_auc']:.5f}, "
              f"mean_auc {res['valid']['mean_auc']:.5f}, per-domain "
              f"{min(map(float, aucs.values())):.4f}-"
              f"{max(map(float, aucs.values())):.4f}; test total_auc "
              f"{res['test']['total_auc']:.5f}; clustering "
              f"{res['domain2group_list']} saved; launches {launches}")

        ckpt = res["checkpoint"]
        host = ServedHost(ckpt, SERVE_BS, "float32",
                          os.path.join(root, "host"), "amazon")
        stack.callback(host.kill)
        cpu = predictor_from_checkpoint(ckpt, batch_sizes=(SERVE_BS,),
                                        device="cpu")
        url = host.wait_ready()
        rng = np.random.default_rng(SEED + 31)
        err = 0.0
        for n_rows in AMAZON_REQUESTS:
            X = amazon_ids(rng, n_rows, dims)
            got = _post(url, X)
            check(got.shape == (n_rows,) and np.all(np.isfinite(got)),
                  f"amazon (b): a {n_rows}-row reply {got.shape}")
            err = max(err, float(np.max(np.abs(got - cpu(X)))))
        check(err <= PRED_TOL, f"amazon (b): served vs the CPU's Predictor "
              f"max abs err {err}")
        rc, stop_s, end = host.stop()
        sent = len(AMAZON_REQUESTS)
        check(end["launches"] == {"embedding_gather": sent + 1,
                                  "field_attention": sent + 1},
              f"amazon (b): the host launched {end['launches']} for {sent} "
              "chunks and warm()'s")
        out["served"] = {"requests": sent, "cpu_err": err,
                         "launches": end["launches"], "rc": rc,
                         "start_seconds": host.start_s,
                         "stop_seconds": stop_s}
        print(f"{tag} amazon (b) python -m tpurec_torch.server --ckpt "
              f"{os.path.basename(ckpt)} (up in {host.start_s:.1f} s): "
              f"{AMAZON_REQUESTS.count(1)} 1-row and "
              f"{AMAZON_REQUESTS.count(SERVE_BS)} {SERVE_BS}-row requests "
              f"within {err:.3g} of the CPU's Predictor (tol {PRED_TOL}); "
              f"#1, #2 launched {end['launches']}; SIGINT rc {rc}")
    out["phase_seconds"] = time.perf_counter() - t_phase
    print(f"amazon (b): {out['phase_seconds']:.1f} s")
    return out


def amazon_at_scale(tag, rows):
    """Phase 30 (c), ``--phase 30 --rows N``: the JAX package's scale proof
    (scripts/bench_amazon_scale.py, 60M raw ratings) on the card's host.
    The raw pair; AmazonPreprocessor's stages one by one in a process of
    its own, each stage's seconds and the peak RSS after it; the CLI's
    load_dataset in this process; then CDCTrainer.fit as the CLI builds it
    (the user's argv, --update_interval at its default, 1,000) with the
    epoch cut by a log_fn that raises after the AMAZON_UPDATES-th matrix
    update, as phase 27 (b) cuts its epoch: the train split resident,
    each update's seconds and launches against its schedule, ms a step
    of the spans between updates; then where a step's time goes at W =
    3,584 and 512 (:func:`cdc_profile`: device busy, the top device
    operations) and the table pass at this table against its bound.  ->
    summary."""
    import os
    import resource
    import tempfile

    from tpurec_torch import cli
    from tpurec_torch.cdc import CDCTrainer
    from tpurec_torch.nn.core import EmbeddingLayout
    from tpurec_torch.train.hybrid import EmbeddingUpdater

    t_phase = time.perf_counter()
    out = {"raw_ratings": rows}
    with tempfile.TemporaryDirectory(dir=_here()) as root:
        ratings, meta, out["raw_seconds"] = amazon_raw(root, rows)
        out["raw_bytes"] = [os.path.getsize(ratings), os.path.getsize(meta)]
        print(f"{tag} amazon (c) {rows} raw ratings ({out['raw_bytes'][0]} "
              f"B) and {rows // 20} items' metadata ({out['raw_bytes'][1]} "
              f"B) written in {out['raw_seconds']:.1f} s", flush=True)
        out["stages"] = _amazon_preprocess(root, ratings, meta, "stages")
        for stage, s, n, rss in out["stages"]:
            print(f"{tag} amazon (c) {stage}: {s:.1f} s -> {n} "
                  f"{'B' if stage == 'write csv' else 'rows'} (peak RSS "
                  f"{rss:.2f} GiB)", flush=True)
        os.remove(ratings)
        os.remove(meta)
        argv = list(AMAZON_ARGV) + ["--data_path", root]
        cfg = cli.build_config(cli.parse_args(argv))
        t0 = time.perf_counter()
        train, valid, test, dims, n_domain, di = cli.load_dataset(cfg)
        out["load_seconds"] = time.perf_counter() - t0
    del test
    layout = EmbeddingLayout(dims)
    out.update(field_dims=dims, n_domain=n_domain, table_rows=layout.vocab,
               split_rows=[len(train[1]), len(valid[1])],
               resident_bytes=train[0].nbytes + train[1].nbytes,
               host_rss_gb=resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss / 2**20)
    print(f"{tag} amazon (c) load_dataset {out['load_seconds']:.1f} s: "
          f"field_dims {dims}, {n_domain} domains; the table {layout.vocab} "
          f"x {MODEL['embed_dim']}; train {len(train[1])} rows = "
          f"{out['resident_bytes'] / 1e9:.3f} GB of ids and labels, valid "
          f"{len(valid[1])}; host peak RSS {out['host_rss_gb']:.2f} GiB",
          flush=True)
    check(n_domain == AMAZON_N_DOMAIN and di == AMAZON_DOMAIN_IDX,
          f"amazon (c): {n_domain} domains, domain at field {di}")

    tr = CDCTrainer(cfg, dims, n_domain, di)
    counters = train_counters("ple")
    rec, undo = _observe_updates(tr, train[0], counters,
                                 domain_idx=AMAZON_DOMAIN_IDX)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()

    def cut(r):
        if "cdc_update_seconds" in r and len(rec["updates"]) \
                == AMAZON_UPDATES:
            raise _Cut(f"cut after update {AMAZON_UPDATES}")

    t0 = time.perf_counter()
    try:
        tr.fit(train, valid, log_fn=cut)
        raise SmokeFailure("amazon (c): the epoch ended before its cut")
    except _Cut:
        torch.cuda.synchronize()
    finally:
        undo()
    out["fit_seconds"] = time.perf_counter() - t0
    check(tr._resident, "amazon (c): the train split did not stay resident")
    ups = rec["updates"]
    for i, u in enumerate(ups):
        _check_update_launches(u, f"amazon (c) update {i + 1}")
    n_steps = (rec["warmup_steps"] + rec["span_steps"]
               + sum(u["valid_steps"] for u in ups))
    launches = {k: fn.launches for k, fn in counters.items()}
    want = schedule_launches(n_steps, n_steps + sum(u["probe_forwards"]
                                                    for u in ups))
    check(launches == want, f"amazon (c): launches {launches}, the "
          f"schedule {want}")
    step_ms = rec["span_seconds"] / rec["span_steps"] * 1e3
    out.update(fit_launches=launches, warmup_steps=rec["warmup_steps"],
               span_steps=rec["span_steps"], span_ms_a_step=step_ms,
               device_peak_gb=rec["peak_gb"],
               updates=[{x: u[x] for x in ("seconds", "peak_gb",
                                            "valid_steps", "probe_forwards",
                                            "blocks", "d2g", "launches")}
                        for u in ups])
    print(f"{tag} amazon (c) CDCTrainer.fit cut after update "
          f"{AMAZON_UPDATES} ({out['fit_seconds']:.1f} s, the split "
          f"resident): warmup {rec['warmup_steps']} steps; "
          f"{rec['span_steps']} steps between updates at {step_ms:.3f} ms a "
          f"step (host clock); updates "
          + "; ".join(_update_line(u) for u in ups)
          + f"; device peak {rec['peak_gb']:.2f} GiB; launches {launches} "
          "against the schedule", flush=True)
    out["profile"] = cdc_profile(tr, f"{tag} amazon (c)",
                                 n_domain=AMAZON_N_DOMAIN)

    # the table pass at this table (f32 moments, the CLI's), a step's ids
    upd = EmbeddingUpdater(dims, cfg.train, L2)
    F, D = len(dims), MODEL["embed_dim"]
    p = tr.model.embedding.table.detach()
    V, S = p.shape[0], upd.S
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    x = torch.from_numpy(train[0][:512]).to(p.device)
    ids, g_ids = upd.big_rows(x, torch.randn(512, F, D, device=p.device))
    row, _ = table_pass_timing(p, m, v, ids, g_ids,
                               torch.randn(S, D, device=p.device), iters=20)
    out["table_pass"] = dict(row, rows=V)
    r = out["table_pass"]
    print(f"{tag} amazon (c) table pass (#7 carrying #6, {V} x {D}, f32 "
          f"moments, {ids.shape[0]} ids): {r['ms']:.4f} ms (CUDA events), "
          f"device {r['device_ms']:.4f} ms launched alone, bound "
          f"{r['bound_ms']:.4f} ms (bytes)")
    del tr, m, v, train, valid
    torch.cuda.empty_cache()
    out["phase_seconds"] = time.perf_counter() - t_phase
    print(f"amazon (c): {out['phase_seconds']:.1f} s")
    return out


def phase30_main(rows=None) -> int:
    """Phase 30 alone, after the build: (a), then (b), or with ``rows``
    (c) at that many raw ratings."""
    start = _phase_alone("phase 30")
    if start is None:
        return 1
    dev, tag = start
    t0 = time.perf_counter()
    launches, summary = amazon_main_path(dev, tag)
    print(json.dumps({"launches_amazon": launches}))
    if rows is None:
        summary["b"] = amazon_cli_path(tag)
    else:
        summary["c"] = amazon_at_scale(tag, rows)
    print(json.dumps({"amazon": summary}, default=str))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


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
    gather_window_checks(dev, layout, tables)

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
        # a (., 2) mesh's shard: the window of the table's first half
        g_win = layout.gather(q32[:-(-q32.shape[0] // 2)].contiguous(),
                              window=(0, q32.shape[0]))
        win_ms = cuda_ms(lambda: g_win(pick(id_sets)))
        win_host_us = host_enqueue_us(lambda: g_win(id_sets[0]))
        win_alone = kernel_alone_ms(lambda: g_win(pick(id_sets)),
                                    "gather_kernel")
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
            rows_per_block=GATHER_THREADS * GATHER_PIECES / (F * D / 4),
            window_ms=win_ms, window_host_enqueue_us=win_host_us,
            window_device_alone_ms=win_alone)
        print(f"{tag} embedding_gather B={B}: prepared {ms:.4f} ms, "
              f"index_select {lib:.4f} ms, one-shot {one_shot:.4f} ms (CUDA "
              f"events); host enqueue {host_us:.2f} us a call, index_select "
              f"{lib_host_us:.2f} us (perf_counter_ns over 1000 calls, no "
              f"synchronize); device "
              + ("not seen" if alone is None else f"{alone:.5f} ms")
              + " a launch back to back (torch.profiler, 50 launches)")
        print(f"{tag} embedding_gather B={B} with a row window (half the "
              f"table): prepared {win_ms:.4f} ms (CUDA events), host "
              f"enqueue {win_host_us:.2f} us a call, device "
              + ("not seen" if win_alone is None else f"{win_alone:.5f} ms")
              + " a launch back to back")

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
    # phase 28 serves the checkpoints of phases 16 and 18 (b)
    import os
    import tempfile

    kept = tempfile.TemporaryDirectory(dir=_here())
    ckpts = {"mmoe": os.path.join(kept.name, "mmoe.pkl"),
             "cdc_ple": os.path.join(kept.name, "cdc_ple.pkl")}
    fit_launches, fit_summary = harness_main_path(dev, tag,
                                                  keep=ckpts["mmoe"])

    # -- 17. the CDC engine ---------------------------------------------------
    cdc_launches, cdc_summary = cdc_main_path(dev, tag,
                                              n_causal_mask=CDC_CAUSAL)

    # -- 18. CDC's other base models ------------------------------------------
    t18 = time.perf_counter()
    bases = bases_main_path(dev, rng, tag)
    ple_launches, ple_cdc = cdc_main_path(dev, tag, base="ple", phase=18,
                                          profile=False,
                                          n_causal_mask=CDC_CAUSAL,
                                          keep=ckpts["cdc_ple"])
    star_row = star_cdc_row(tag)
    single_rows = {name: single_row_vs_cpu(name, tag) for name in SINGLES}
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

    # -- 21. the CLI on the card ------------------------------------------------
    cli_launches, cli = cli_main_path(dev, tag)

    # -- 22. the (data, model) mesh --------------------------------------------
    # (d), the CLI under torch.distributed.run, runs with --phase 22
    mesh_launches, mesh = mesh_main_path(
        dev, tag, fit_summary["valid"]["total_auc"],
        cli["a_mmoe"]["valid_auc_by_epoch"][0], cli=False)

    # -- 23. CDC on the mesh and expert parallelism ---------------------------
    ep_launches, ep = ep_main_path(
        dev, tag, {b: r["valid_total_auc"] for b, r in cli["b_cdc"].items()})

    # -- 24. CDC's row lanes ----------------------------------------------------
    lanes_launches, lanes = lanes_main_path(dev, tag)

    # -- 25. CDC as its users run it: "stream", three updates a fit ----------
    stream_launches, stream = stream_main_path(dev, tag)

    # -- 27. the training harness as its users run it: fit to its stop -------
    cadence_launches, fit_cadence = fit_cadence_main_path(dev, tag)

    # -- 28. serving as its users run it: the host under concurrent clients --
    serving = serving_main_path(tag, ckpts)
    kept.cleanup()

    # -- 30. Amazon as its users run it: (a), the kernels at its shapes ------
    amazon_launches, amazon = amazon_main_path(dev, tag)

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
        key = ("field_attention_train" if k["name"] == "field_attention"
               else k["name"])
        k["launches_cli"] = {run: n[key] for run, n in cli_launches.items()}
        k["launches_mesh"] = {run: n.get(key)
                              for run, n in mesh_launches.items()}
        k["launches_ep"] = {run: n.get(key)
                            for run, n in ep_launches.items()}
        k["launches_lanes"] = lanes_launches.get(key)
        k["launches_stream"] = {fit: n.get(key)
                                for fit, n in stream_launches.items()}
        k["launches_fit_cadence"] = {fit: n.get(key)
                                     for fit, n in cadence_launches.items()}
        k["launches_amazon"] = amazon_launches.get(key)
        if k["name"] in ("embedding_gather", "field_attention"):
            k["launches_serving"] = {
                c: r["launches"][k["name"]] for c, r in serving.items()
                if c != "phase_seconds"}
    print(json.dumps({"harness": fit_summary}))
    print(json.dumps({"cdc": cdc_summary}))
    print(json.dumps({"bases": bases, "cdc_ple": ple_cdc,
                      "cdc_star_row": star_row, "single_rows": single_rows,
                      "phase_seconds": bases_s}))
    print(json.dumps({"routed": routed, "bf16": bf16,
                      "phase_seconds": routed_s}))
    print(json.dumps({"zoo": zoo, "updates": updates,
                      "phase_seconds": zoo_s}))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"expert": ep}))
    print(json.dumps({"lanes": lanes}))
    print(json.dumps({"stream": stream}))
    print(json.dumps({"fit_cadence": fit_cadence}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"amazon": amazon}))
    print(json.dumps({"profiler_captures": CAPTURES}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def cli_epoch0_auc(tag):
    """Phase 21 (a) alone, in this process, with its checks: the CLI's
    MMoE at CLI_MMOE for CLI_MMOE_EPOCHS epochs from phase 21's seed.
    -> its first epoch's valid total_auc, the one phase 22 (d) is held
    to."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="cli_")
    rec = _CliRecorder(cli_counters())
    out, n, _, secs = rec.run(_cli_argv(
        tmp, "mmoe", SEED + 21,
        CLI_MMOE + ["--epoch", str(CLI_MMOE_EPOCHS)]))
    a = _cli_fit_checks(rec.trainers[-1], out, _cli_log(tmp, "mmoe"), n, 6,
                        "cli mmoe")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"{tag} cli (a) mmoe, (d)'s baseline: valid total_auc by epoch "
          + ", ".join(f"{v:.5f}" for v in a["valid_auc_by_epoch"])
          + f"; main {secs:.2f} s")
    return a["valid_auc_by_epoch"][0]


def phase22_main(draws: int) -> int:
    """Phase 22 alone, after the build and phase 3's check of kernel 1's
    row window; (b) at each wd over ``draws`` batch draws.  Phase 16
    does not run, so (c) prints its AUC uncompared; phase 21 (a) runs
    first (:func:`cli_epoch0_auc`) and (d) is held to its first
    epoch."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tpurec_torch.nn.core import EmbeddingLayout
    from tpurec_torch.ops import _build
    from tpurec_torch.serve import quantize_table

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    gpu = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    print(gpu)
    built = _build.build()
    print(f"built {sorted(built)} in {time.perf_counter() - t_start:.1f} s")
    layout = EmbeddingLayout(FIELD_DIMS)
    gen = torch.Generator().manual_seed(SEED)
    table = torch.randn(layout.vocab, MODEL["embed_dim"], generator=gen)
    table[layout.n_rows:] = 0.0
    tables = {}
    for dtype in ("float32", "bfloat16", "int8"):
        q, sc = quantize_table(table, dtype)
        tables[dtype] = (q.to(dev), None if sc is None else sc.to(dev))
    gather_window_checks(dev, layout, tables)
    del tables, table
    tag = f"[{gpu}]"
    launches, summary = mesh_main_path(dev, tag, None, cli_epoch0_auc(tag),
                                       draws)
    print(json.dumps({"launches_mesh": launches}))
    print(json.dumps({"mesh": summary}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    return 0


def _phase_alone(name):
    """The start of a phase run alone: the card's name and power limit,
    the kernels built.  -> (dev, tag), or None without a card."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpurec_torch.ops import _build

    t0 = time.perf_counter()
    gpu = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    print(gpu)
    built = _build.build()
    print(f"{name}: built {sorted(built)} in {time.perf_counter() - t0:.1f} "
          "s")
    return torch.device("cuda"), f"[{gpu}]"


def phase18_main(seed: int) -> int:
    """Phase 18 (a) alone, after the build: CDC's other bases with their
    batches drawn from ``default_rng(seed)`` (in the whole run the draw
    follows the earlier phases')."""
    start = _phase_alone("phase 18")
    if start is None:
        return 1
    dev, tag = start
    t0 = time.perf_counter()
    bases = bases_main_path(dev, np.random.default_rng(seed), tag)
    print(json.dumps({"bases": bases, "seed": seed}))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


def phase19_main(seed: int) -> int:
    """Phase 19 (a) alone, after the build: the routed models with their
    batches drawn from ``default_rng(seed)`` (in the whole run the draw
    follows the earlier phases')."""
    start = _phase_alone("phase 19")
    if start is None:
        return 1
    dev, tag = start
    t0 = time.perf_counter()
    routed = routed_main_path(dev, np.random.default_rng(seed), tag)
    print(json.dumps({"routed": routed, "seed": seed}))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


def phase24_main() -> int:
    """Phase 24 alone, after the build."""
    start = _phase_alone("phase 24")
    if start is None:
        return 1
    dev, tag = start
    t0 = time.perf_counter()
    launches, summary = lanes_main_path(dev, tag, alone=True)
    print(json.dumps({"launches_lanes": launches}))
    print(json.dumps({"lanes": summary}))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


def phase23_main() -> int:
    """Phase 23 alone, after the build, with (b)'s witness on three
    meshes.  Phase 21 does not run, so (c) prints its AUC uncompared."""
    start = _phase_alone("phase 23")
    if start is None:
        return 1
    dev, tag = start
    t0 = time.perf_counter()
    launches, summary = ep_main_path(dev, tag, None, witness=True)
    print(json.dumps({"launches_ep": launches}))
    print(json.dumps({"expert": summary}))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


def phase25_main(rows: int) -> int:
    """Phase 25 (b) alone, after the build: CDC with ``rows`` synthetic
    rows, the train split in host memory (:func:`stream_at_scale`)."""
    start = _phase_alone("phase 25")
    if start is None:
        return 1
    dev, tag = start
    t0 = time.perf_counter()
    summary = stream_at_scale(tag, rows)
    print(json.dumps({"stream_b": summary}))
    print(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="The port on the card: every "
                                 "phase, with no arguments.")
    ap.add_argument("--phase", type=int,
                    choices=[18, 19, 22, 23, 24, 25, 26, 27, 28, 29, 30],
                    help="run this phase alone (after the build; 18: its "
                    "part (a), CDC's other bases; 19: its "
                    "routed models; 23: with (b)'s witness on three "
                    "meshes; 25: its part (b), the split over the card's "
                    "budget; 26: CDC's cadence on the mesh, (b), or with "
                    "--rows (c); 27: its part (b), the harness with the "
                    "train split over the card's budget; 28: its part (b), "
                    "serving under load; 29: the mesh on four cards, a "
                    "rank a card over NCCL; 30: Amazon, (a) and the user's "
                    "commands (b), or with --rows the scale proof (c))")
    ap.add_argument("--draws", type=int, default=MESH_DRAWS,
                    help="phase 22 (b)'s batch draws at each wd")
    ap.add_argument("--seed", type=int, default=SEED,
                    help="phase 18 (a)'s or 19's batch draw (with --phase "
                    "18 or 19)")
    ap.add_argument("--rows", type=int, default=None,
                    help="synthetic rows of phase 25 (b) or 27 (b) "
                    f"(default {STREAM_ROWS}) or phase 26 (c) (with "
                    "--phase 29: phase 26 (c) on the four cards); with "
                    "--phase 30, the raw ratings of its part (c) "
                    f"(scripts/bench_amazon_scale.py's {AMAZON_SCALE_ROWS})")
    ap.add_argument("--parts", default="abcd",
                    help="phase 29's parts: a (with e's turns), b, c, d")
    ap.add_argument("--mesh-rank", metavar="DIR",
                    help="one rank of phase 22 (b)/(c) or 29 (b), started "
                    "by the phase itself")
    ap.add_argument("--shape", default="x".join(map(str, MESH_SHAPE)),
                    help="--mesh-rank's mesh, n_data x n_model")
    ap.add_argument("--group-rank", metavar="DIR",
                    help="one rank of phase 29 (a)/(e), started by the "
                    "phase itself")
    ap.add_argument("--ep-rank", metavar="DIR",
                    help="one rank of phase 23 (a)/(b), started by the "
                    "phase itself")
    ap.add_argument("--lanes-rank", metavar="DIR",
                    help="one rank of phase 24 (c), started by the phase "
                    "itself")
    ap.add_argument("--witness-rank", metavar="DIR",
                    help="one rank of phase 23 (b)'s witness, started by "
                    "the phase itself")
    ap.add_argument("--fit-over", metavar="DIR",
                    help="phase 27 (a)'s fit over the budget, started by "
                    "the phase itself")
    ap.add_argument("--parent", metavar="DIR",
                    help="phase 28 (b): an unpacked tree of the parent "
                    "commit, its host served in turns with this tree's")
    ap.add_argument("--cadence-rank", metavar="DIR",
                    help="one rank of phase 26, started by the phase "
                    "itself")
    opts = ap.parse_args()
    try:
        if opts.mesh_rank:
            sys.exit(mesh_rank(opts.mesh_rank, opts.draws, tuple(
                int(x) for x in opts.shape.split("x"))))
        if opts.group_rank:
            sys.exit(group_rank(opts.group_rank))
        if opts.ep_rank:
            sys.exit(ep_rank(opts.ep_rank))
        if opts.lanes_rank:
            sys.exit(lanes_rank(opts.lanes_rank))
        if opts.witness_rank:
            sys.exit(witness_rank(opts.witness_rank))
        if opts.cadence_rank:
            sys.exit(cadence_rank(opts.cadence_rank))
        if opts.fit_over:
            sys.exit(fit_over_rank(opts.fit_over))
        if opts.phase == 18:
            sys.exit(phase18_main(opts.seed))
        if opts.phase == 19:
            sys.exit(phase19_main(opts.seed))
        if opts.phase == 22:
            sys.exit(phase22_main(opts.draws))
        if opts.phase == 23:
            sys.exit(phase23_main())
        if opts.phase == 24:
            sys.exit(phase24_main())
        if opts.phase == 25:
            sys.exit(phase25_main(opts.rows or STREAM_ROWS))
        if opts.phase == 26:
            sys.exit(phase26_main(opts.rows))
        if opts.phase == 27:
            sys.exit(phase27_main(opts.rows or STREAM_ROWS))
        if opts.phase == 28:
            sys.exit(phase28_main(opts.parent))
        if opts.phase == 29:
            sys.exit(phase29_main(opts.rows, opts.parts))
        if opts.phase == 30:
            sys.exit(phase30_main(opts.rows))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)

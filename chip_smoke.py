#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's training, serving, bulk-scoring, kNN and
LM serving paths on an H100 and check them.

Run from the root of a checkout, on a machine with one Hopper card:

    python3 chip_smoke.py

It builds the port's twelve CUDA kernels from
`src/repro_torch/kernels/csrc/` and then, with the kernel launch counts set
to 0 before each path and read after it:

  * trains `boosting.fit` on the card at the full width of the paper's
    Covertype workload (325,360 rows, 54 features, 7 classes, MultiClass,
    depth 8, lr 0.5, 63 borders, 1,000 trees) and prints its
    `TrainingMetrics`;
  * serves the trained model from a pool on soa (`GBDTServer`) over the
    139,440-row test split: rows/s and test accuracy;
  * bulk-scores 1,115,520 rows (the test split served 8 times over by
    `SyntheticSource`) with `BulkScorer` through three plans of one
    schema (the trained model, its first 500 trees, and both halves put
    back together with `concat_ensembles`), auto chunking (synchronous:
    the prefetch worker pays only from 65,536-row chunks), uint8 pools,
    into an `NpySink`, a `StatsSink` and a `TopKSink`: the first run and
    the median of 3 more, then float chunks (`fused_predict`), 65,536-row
    chunks with a prefetch worker two chunks ahead on a side stream, a
    run killed at half its chunks and resumed, raw scores, and one
    profiled run;
  * drives the main path's other entry points: `raw_predict`, a CatBoost
    JSON export of the trained model read back through
    `Predictor.from_catboost_json`, `ModelRegistry.predict_multi` over the
    model and its first half, `GBDTServer.score_source`;
  * trains 20 trees with `GBDTTrainer.fit_source` from the training split
    streamed by a `SyntheticSource`, then runs `python3 -m
    repro_torch.launch.score --dataset covertype --scale 0.05 --models 2
    --check` in a process of its own;
  * the training remainders on the Covertype training split: 100 trees
    with rsm = 0.5, with ordered boosting and with both, beside a plain
    fit, each also checkpointed at 50 trees and resumed; JAX's
    permutation on the card; `boosting.fit_scan` on the 400 x 6 case of
    tests/test_differential.py, plain and with rsm = 0.5 and ordered
    boosting; then `repro_torch.launch.train_gbdt --rsm 0.5 --ordered
    --check`, `repro_torch.launch.serve` (gbdt mode with 3 variants, and
    `--show-kernels`) and the three `examples/torch/` scripts, each in a
    process of its own (`python3 chip_smoke.py --launcher NAME`, as the
    scoring CLI is), three at a time;
  * serves the trained model, with a tenth of its trees truncated (8 depth
    groups), on each layout in turn (soa, depth_major, depth_grouped,
    bitpacked), then the untruncated model on bitpacked (one group, whose
    fused route is its own kernel): single requests, `predict_batch` over
    the test split, `quantize` + `predict_pool` and a staged `proba` call;
  * the multi-device slice on `make_local_mesh(4)` (four logical shards,
    dealt round robin over the machine's cards: all on cuda:0 with one):
    each serving path's fused and staged plans row-sharded (pool, float,
    the ragged 139,437 rows, 2 rows), tree-sharded and on the (2, 2)
    hybrid mesh; 2 models x 2 replicas in a `ModelRegistry`, a
    `GBDTServer(mesh=)`, `BulkScorer(mesh=)` with the prefetch worker over
    the test split twice, the traced `sharded/pool` span, rows/s sharded
    against single-device;
  * runs the paper's image-embeddings workload (2,808 train and 2,841 test
    embeddings of K = 512, 20 classes): kNN features (k = 16) of both
    splits with the `l2sq_matrix` kernel, of the test split again with one
    `l2sq` dispatch and one `l2sq_rowwise` launch a query (both counted),
    a 1,000-tree MultiClass head (depth 4,
    lr 0.05) trained on the 533 augmented columns with `boosting.fit`, and
    `EmbeddingGBDTPipeline.predict` on the test split: accuracy and rows/s;
  * then the caps phase: the shapes the kernels once refused (33
    outputs, rows past the old 48 KB bins tiles and past the opt-in limit,
    66 histogram stats), numpy-seeded random models, against the plain
    versions;
  * the contracts phase: the contract checker (`repro_torch.analysis`)
    walks the registry, the plans and the row-sharded entries abstractly,
    then each `cuda` cell's canonical, bucket, bulk, distance and 66-stat
    calls run for real with the library's resource record on;
  * the lm phase (plain PyTorch, no hand-written kernel): the ten LM
    architectures' smoke configs on the card and on the CPU from one set
    of seeded f32 weights, while `repro_torch.launch.serve --mode lm
    --arch glm4-9b` and `--arch whisper-small` run, each in a process of
    its own; then glm4-9b (9.40 B parameters) and zamba2-1.2b at full
    width, f32 weights from a seeded generator on the card served by an
    `LMServer` in bf16, 2 prompts of 32 (zamba2: 64, its SSD chunk) tokens
    and 16 new tokens: prefill, decode and `generate` times, a profiled
    decode step and prefill, peak memory and the decode step's bytes bound;
  * last the lm_train phase (autograd through the same plain models): one
    AdamW train step of the ten smoke configs on the card and on the CPU,
    while `repro_torch.launch.train --steps 4` and
    `examples/torch/train_lm.py --steps 20` run, each in a process of its
    own; then internvl2-1b and zamba2-1.2b trained at full width by the
    `Trainer` on `make_local_mesh(1)`: 10 steps at B = 2, S = 4,096 (the
    train_4k length) from `TokenSource`, remat on, checkpoints every 5
    steps, the mid-run checkpoint restored and run to the end: step ms
    (CUDA events) against the step's FLOP bound, tokens/s, peak memory,
    checkpoint and restore seconds, a profiled step; glm4-9b's f32
    training state (150 GB) against the card's memory, not allocated;
  * after the lm_dist phase, the dryrun phase in a process of its own
    (`python3 chip_smoke.py --dryrun`, outputs under build/): the
    `dryrun_gbdt` cells on the 16 x 16 fake group (both ok); one
    device's predict-1m shard (65,536 rows, 625 seeded trees) run for
    real through its plan, its launches equal to the trace's in name
    and shapes, each kernel's first launch held to its plain version
    (integers exactly, sums within `sum_limit`) and timed again on CUDA
    events beside its cost bound and the cell's memory term; the
    internlm2-20b decode_32k cell at full width (ok); internvl2-1b's
    remat train step at B = 2, S = 4,096 traced on one device, its
    products' FLOPs against `lm_train_flops` part by part; `perf --cell
    gbdt-predict --force`, the four variants' microseconds a call and
    their raws (the tree-order routes bit for bit alike, the tree-blocked
    one within `sum_limit`).

It checks:

  * each path launched exactly its kernels, and every kernel was launched;
  * training: the loss decreases; `history["final_raw"]` equals a fresh
    staged soa plan's `raw(pool)` bit for bit; no binarize dispatch while
    boosting; at most 8 first calls of a level histogram shape; a 20-tree
    run equals a 10-tree run checkpointed and resumed to 20 trees, and the
    first 20 trees of the full run, bit for bit; on the first 5 trees each
    level's split from the kernel's histogram equals the split from the
    plain histogram, unless their gains lie within the gains' rounding
    bound (counted);
  * the split kernel (`split_level`) gives the plain version's bits on
    the CPU (masked gains, f*, b*, refined leaf ids; NaN equal to NaN): on
    the tie scenario's levels, on the benchmark's Covertype levels at 129
    bins for d = 0..7 (in-order and window plans; each timed beside the
    plain version on the card), with an rsm mask, with every border
    masked ((0, 0)) and on int32 bins at 301 bins; the telemetry fit makes
    a `dispatch/split_level` span a level, each with its 3 launches;
  * the histogram kernel at every level shape of a depth-8 tree (uint8,
    plus int32 at the deepest level and the first 1,000 and 17 rows) and
    at the leaf sums (one bin, 256 leaves) equals the plain fixed-point
    version `ref.histogram_fixed` bit for bit, in both of its variants,
    gives the same bits on two launches and lies within `hist_limits` of
    its f32 and f64 plain versions;
  * bulk: one `binarize` launch a chunk (one schema), at most 2 chunk
    shapes and 2 first calls of each pool entry; the model's scores equal
    its plan's one-shot `proba` bit for bit (65,536 rows a call), the
    joined model's top rows and raw scores equal the model's, float
    chunks and the worker's chunks give the pool route's bits in all
    three sinks, the resumed run the whole run's; its raw scores against
    the CPU plan on 1,024 rows (class ids where the margin is clear, the
    float limit); then, for each chunk size, chunk 0 and the tail chunk
    as the scorer's prefetch transform builds them, through every plan:
    the pool's bins and `leaf_index` equal their plain versions,
    `leaf_gather` and `fused_predict` the tree-order float32 sum, bit for
    bit;
  * entry points: `raw_predict` and the JSON plan give the plan's raw
    scores bit for bit; `predict_multi` launches `binarize` once and
    equals each model's `predict_batch`; `score_source` equals
    `predict_batch`;
  * `fit_source`: its borders equal `compute_borders_chunked` on the
    CPU, its pool `quantize_pool` of the whole matrix, its ensemble
    `fit_pool` on that pool, bit for bit; its chunk metrics are filled;
    the scoring CLI's `--check` passes;
  * the remainders: each fit's loss decreases, its `final_raw` equals a
    fresh staged soa plan's `raw(pool)` bit for bit, no binarize while
    boosting; with rsm every tree splits only on features of its mask
    (`prng.permutation` of the tree's key, exactly max(1, int(F * rsm))
    features); 50 + 50 resumed trees equal 100 uninterrupted, bit for
    bit, and the checkpoint's key is the key split 50 times on the host;
    `prng.permutation` on the card equals the CPU's at 54 and at 325,360
    rows; `fit_scan` gives the same bits twice, `fit`'s splits, and leaf
    values and losses within rtol = atol = 1e-4 of `fit`'s;
  * each launcher and example process (the scoring CLI's too) exits 0,
    launches exactly its `PATH_KERNELS` (counts set to 0 in that process
    before its `main`), and holds the first two launches of every kernel
    at every input shape it gives that kernel to the plain version on CPU
    copies of the inputs: binarize, leaf_index and the histogram
    (`ref.histogram_fixed`) exactly, leaf_gather and fused_predict within
    `sum_limit`, l2sq_matrix within the distance rule; a kernel launched
    but never compared fails; quickstart's staged and fused routes agree
    within 1e-4 and its float and pool predictions are equal, serve_gbdt
    answers every request;
  * serving: the fused, pool and staged routes of each path classify the
    same; depth_major gives soa's scores bit for bit on every route,
    bitpacked gives depth_grouped's, and one-group bitpacked fused gives
    soa fused's on the untruncated model; depth_grouped and bitpacked agree
    with soa within `sum_limit` and in class on rows with a clear margin;
    the card agrees with the plain PyTorch plan on the CPU, on every
    layout; each serving kernel agrees with its plain version at every row
    count the main path gives it, within `sum_limit`, which a bf16 leaf
    table must fail; binarize equals its plain versions exactly there, also
    on a border table with a shuffled column, duplicate borders and a NaN
    border, against x holding NaN, +inf, -inf and values equal to borders;
  * mesh: row-sharded scores equal the single-device plan's bit for bit on
    every path, plan and route, the pool route launches no binarize, each
    kernel launches exactly 4 times the single-device count; tree-sharded
    and hybrid scores lie within `sum_limit`; `predict_multi` over the
    replica groups launches binarize once; the mesh server equals a local
    staged server, the mesh bulk run the run without a mesh in all three
    sinks;
  * kNN: each distance kernel gives the same bits on two launches, no
    negative value, and lies within the distance rule of its plain version
    (`l2dist.matrix_limit` / `rowwise_limit`) on both splits and every test
    query, the matrix kernel (3xTF32 on the tensor cores) also at 4,096 x
    22,464 and at ragged shapes (one tile, K = 90 and 533, a slice one row
    into its buffer, M = 3 against the references, one column), the
    rowwise kernel bit for bit its summation order
    (`ref.l2sq_rowwise_lanes`) on every test query and at ragged shapes
    (`ROWWISE_RAGGED`: K % 4 != 0, a slice one row in, K = 1, N = 1, a
    ragged N, rows not 16-byte aligned, K = 1,028 and 60,000: all three
    routes of `tuning.rowwise_plan`; N past one wave of warps at K = 128,
    256, 512 and 1,028: the blocks striding), the route's `out=` rows
    equal to lone launches; the two forms within the sum of their limits;
    each route's features obey the feature rule against the plain
    distances' (exempt queries counted); the head's training contracts
    as above, its first 5 trees' splits, and the histogram at 533 features
    x 40 stats for depths 0-3; the fused kernel at C = 20 and F = 533
    within `sum_limit`; the pipeline's class ids equal to a CPU
    pipeline's on 1,024 test rows where the rows bin alike and the margin
    is clear;
  * leaf_gather's staged and direct routes, at every row count above and
    at C = 33, equal the tree-order float32 sum bit for bit (and the fused
    kernels equal it at C = 33); so do fused_predict's spread and row
    routes (so each equals the other) at every row count above, at the
    kNN head's C = 20 and at C = 33, and each route that takes a caps
    shape past the feature caps gives the plan's route's bits; so do
    fused_predict_dm's spread and row routes, each also equal to soa's
    route of the same name on the same model, at every row count above and
    at C = 33, and each dm route that takes a caps shape past the feature
    caps gives soa's plan's bits; so do fused_predict_bp's, on the
    one-group model with uint8 and int32 planes, from uint8 and int32 bins
    (the border table padded with +inf rows), at every row count above and
    at C = 33 (also at 61 trees, T % 4 != 0), each also equal to soa's
    route of the same name, and past the feature caps wherever its spread
    route fits;
  * leaf_index and leaf_index_dm (one kernel body) equal their plain
    versions bit for bit at the edges of its design (1, 31, 33, 255 and
    257 trees at depth 1 and 16, numpy-seeded splits with padded trees and
    thresholds past the last bin and past 255) and on each depth group of
    the truncated model, at 1,024, 16 and 1 rows, on uint8 and int32 bins;
  * caps: at C = 33 the fused, pool and staged routes of every layout
    give the same bits, depth_major = soa, bitpacked = depth_grouped and
    one-group bitpacked fused = soa fused; every index kernel equals its
    plain version exactly and every fused kernel lies within `sum_limit`
    of its own, uint8 and int32 bins and planes, one feature past each
    old cap and past the opt-in limit (both routes exercised); the
    histogram at 66 stats (two launches, depths 0 and 3, uint8 and int32
    bins, 20,000 and 17 rows) equals `ref.histogram_fixed` bit for bit;
  * lm: each smoke config's forward and its prefill + 16 greedy decode
    steps (along the CPU's tokens) on the card within rtol = atol = 1e-4
    of the CPU's logits (TF32 off), `pos` equal, and the card's
    `LMServer.generate` tokens the CPU's up to the first step whose top-two
    margin is 2e-4 or less; at full width the decode logits at the prompt's
    end within the bf16 limit (`bf16_limit`: 8·sqrt(12L + 2)·2^-8 times
    the row's rms, L the blocks on the path) of `forward`'s, two `generate`
    calls equal, every logit finite, `pos` advanced; both launcher
    processes exit 0 and print JAX's `[serve:lm]` line; the launch counts
    do not move across the phase;
  * lm_train: each smoke config's gradients within rtol = atol = 1e-4 of
    the CPU's, its step's loss and grad_norm within 1e-4, its parameters
    after the step within `lm_param_rule` (the gradient rule through the
    first AdamW update); at full width finite losses whose mean over
    steps 6-10 is below that over 1-5, the resumed run's losses,
    parameters and optimizer state the uninterrupted run's bit for bit
    (else the first op that differs between two runs is named and the
    run held to a stated bound); both processes exit 0 and print JAX's
    lines; the launch counts do not move across the phase;
  * contracts: the checker's report has no unsuppressed finding and is
    byte for byte the committed results/analysis_torch/contract-report.json;
    every real call makes the launches its walk recorded, launcher for
    launcher; every recorded launch's dynamic plus static shared memory
    lies within the opt-in limit and its `kernels.tuning` plan; each of
    the twelve kernels was launched; it prints the per-kernel resources
    (registers, shared bytes, local bytes, ptxas spills) with the card.

Then it times each kernel beside its plain version, one PyTorch library
call where one computes the same function, and the least time the card
could take (`bound_ms`, from the leaf rows the inputs touch): the serving
kernels at the bulk shape and the 1,024-row bucket, the histogram at each
level, the distance kernels at the test split's shape (the matrix also at
4,096 x 22,464, with its split pass alone, its device time behind a
spacer, its product's bound in fp32 and on the tensor cores, the time
its own three TF32 products would take there, and its kernels' `-Xptxas
-v` registers and spills; TF32 off for its `addmm` yardstick; the
rowwise kernel also as its device time behind a spacer, beside its plan
and ptxas report, and the test split back to back as lone calls and
through the route's own call, on events and on the host clock),
leaf_gather on both of its routes at both shapes, the three fused
kernels on both of their
routes at both shapes and at the 16-row bucket (each also as the
kernel's device time: CUDA events opened behind a spacer kernel, and
`torch.profiler`'s where it sees the card), fused_predict also at the
kNN head;
leaf_index and leaf_index_dm at the bulk shape, the largest and the
smallest bucket and each depth group (int32 bins, as that layout
binarizes), each also as its device time behind a spacer and beside the
plan's choice, with their ptxas registers and spills a template
instantiation;
profiles 10 training trees; the bulk path's rows/s, chunk shape, quantize
share and the card's busy share over one run;
and times the soa tree-looping kernels once more on a model padded to a
multiple of 32 trees.  The last three lines of output are the `kernels`
JSON, the serving and training JSON (with the lm phase's record) and the
result line.  Any failed
check exits non-zero before the result line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, at the full 700 W power limit: HBM3
# bandwidth and the fp32 rate outside the tensor cores (the compares,
# adds and index arithmetic of these kernels are all non-tensor work).
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12
TF32_TENSOR_OPS_PER_S = 495e12    # dense TF32 on the tensor cores

SEED = 0
N_TREES = 1000          # CatBoost's default `iterations`
DEPTH = 8               # Covertype's depth (configs/gbdt_workloads.py)
MAX_BINS = 64           # BoostingParams.max_bins: 63 borders
MAX_BATCH = 1024
N_CLIENTS, N_REQUESTS = 8, 64
N_LAYOUT_REQUESTS = 16  # single requests on each path after soa
STAGED_REPEATS = 5      # bulk staged calls timed after the first
N_REFERENCE = 1024      # rows compared with the CPU plan
U = 2.0 ** -24          # unit roundoff of float32
K_SIGMA = 8.0           # width of the float limit, in rounding walks
TREE_TILE = 32          # the padding the tree-padding timings try
PAIR_ROUNDS = 7         # alternating rounds when timing two versions
SPACER_CYCLES = 2_000_000   # about 1 ms of card clock ahead of a timed launch
FUSED_ROUTES = ("spread", "row")   # the soa and dm fused kernels' routes
RESUME_TREES, RESUME_AT = 20, 10   # a run checkpointed at 10 and resumed
SPLIT_CHECK_TREES = 5   # trees whose splits are checked level by level
HIST_SMALL_ROWS = (1000, 17)       # partial row chunks and blocks


def fail(message: str) -> None:
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, message: str) -> None:
    if not ok:
        fail(message)


def sum_limit(idx, leaf_values, base=None):
    """Per-(row, output) limit on how far two float32 sums of the same T
    leaf values, added in different orders, may differ.

    Each add rounds by at most u * S, where S = sum_t |leaf| of that row
    and output, and T such roundings walk about sqrt(T) * u * S apart;
    K_SIGMA walks leave room for the largest of a million outputs.  When
    `base` is given, both sides add it last: two more roundings of at most
    u * (S + |base|) each.  A leaf table read in bf16 misses each leaf by
    up to 2^-9 of it, a walk about 30 times as long, which lands past the
    limit (`main` checks that it does)."""
    from repro_torch.kernels import ref
    s = ref.leaf_gather(idx, leaf_values.abs())
    limit = K_SIGMA * math.sqrt(leaf_values.shape[0]) * U * s
    if base is not None:
        limit = limit + 2 * U * (s + base.abs()[None, :])
    return limit


def compare_sums(name: str, got, want, limit) -> tuple[float, float]:
    """Fail unless `got` is within `limit` of `want` everywhere; return the
    largest difference and the largest share of its limit."""
    err = (got - want).abs()
    worst = float((err / limit).max())
    check(worst <= 1.0, f"{name} differs from its plain version by "
          f"{float(err.max())}, {worst:.3g} times its limit")
    return float(err.max()), worst


def truncated(full):
    """The trained model with a tenth of its trees truncated to shallower
    depths (numpy-seeded), so PAD_SPLIT_BIN is on the path and the model
    lowers to several depth groups."""
    from repro_torch.core.trees import truncate_tree_depths
    rng = np.random.default_rng(SEED)
    t = full.n_trees
    depths = np.full(t, full.depth)
    cut = rng.choice(t, t // 10, replace=False)
    depths[cut] = rng.integers(0, full.depth, cut.size)
    return truncate_tree_depths(full, depths)


def serve(ens, x_test: np.ndarray, layout: str, n_requests: int):
    """One serving path: single requests, a bulk batch, a pool, a staged
    plan, all on `layout`.  Returns (probas by route, phase stats, the
    server's fused plan, the staged plan, the buckets)."""
    import torch
    from repro_torch.core.predictor import Predictor
    from repro_torch.serving.engine import GBDTServer

    server = GBDTServer(ens, device="cuda", max_batch=MAX_BATCH,
                        layout=layout)
    check(server.metrics.layout == layout,
          f"server reports layout {server.metrics.layout}, not {layout}")
    phases = {}
    try:
        # the first request pays the kernels' first launch on the card
        t0 = time.perf_counter()
        server.predict(x_test[0])
        phases["first_request_ms"] = (time.perf_counter() - t0) * 1e3

        def request(i):
            t0 = time.perf_counter()
            y = server.predict(x_test[i])
            return y, time.perf_counter() - t0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(N_CLIENTS) as pool:
            replies = list(pool.map(request, range(n_requests)))
        lat = np.array([dt for _, dt in replies]) * 1e3
        phases["requests"] = {
            "rows": n_requests, "clients": N_CLIENTS,
            "seconds": time.perf_counter() - t0,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}
        single = np.stack([y for y, _ in replies])

        def timed(name, fn):
            server.metrics.reset()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            snap = server.metrics.snapshot()
            phases[name] = {"rows": len(x_test), "seconds": secs,
                            "rows_per_s": len(x_test) / secs,
                            "batch_p50_ms": snap["batch_p50_ms"],
                            "batch_p99_ms": snap["batch_p99_ms"]}
            return out

        fused = timed("predict_batch", lambda: server.predict_batch(x_test))
        pooled = timed("quantize+predict_pool", lambda: server.predict_pool(
            server.quantize(x_test)))
        staged_plan = Predictor.build(ens, device="cuda", strategy="staged",
                                      layout=layout)
        staged = timed("staged_proba", lambda: staged_plan.proba(x_test))
        phases["staged_proba"].pop("batch_p50_ms")
        phases["staged_proba"].pop("batch_p99_ms")
        # the bulk call again: its first call also pays the first launch
        # of the int32-bins kernels and the allocations of its (N, T) idx
        repeats = []
        for _ in range(STAGED_REPEATS):
            t0 = time.perf_counter()
            staged_plan.proba(x_test)
            torch.cuda.synchronize()
            repeats.append(time.perf_counter() - t0)
        phases["staged_proba"].update(
            repeat_seconds=repeats,
            repeat_rows_per_s=len(x_test) / float(np.median(repeats)))
    finally:
        server.close()
    return ({"single": single, "fused": fused, "pool": pooled,
             "staged": staged.cpu().numpy()}, phases, server.predictor,
            staged_plan, server.buckets)


def time_ms(fn, reps: int, flush) -> float:
    """Median CUDA-event time of `fn`, with L2 flushed before each run
    (the serving path finds its inputs cold)."""
    import torch
    fn()
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, flush, reps: int = 10, key: str = "fused"
              ) -> tuple[float, float | None]:
    """Device time of the kernels `fn` launches, L2 flushed before each
    call: the kernels alone.  `time_ms`'s event window also holds the
    host's work before the launch, which at a serving bucket is about as
    long as the kernel.

    Returns the median of CUDA event windows that open only once the
    launch is queued: a `torch.cuda._sleep` spacer keeps the card busy
    while the host does the wrapper's work, and a sample whose start event
    had already fired when the host returned is dropped and the spacer
    doubled.  Beside it, the mean kernel time `torch.profiler` reports,
    or None where the profiler sees no device events (another tool may
    hold the card's tracing), summed over the kernels whose names hold
    `key`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    times, cycles = [], SPACER_CYCLES
    while len(times) < reps:
        flush.zero_()
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        late = start.query()
        end.record()
        end.synchronize()
        if late:
            cycles *= 2
            check(cycles <= 64 * SPACER_CYCLES, "the host never queued a "
                  f"{key} launch before its spacer ran out")
            continue
        times.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if key in e.key)
    return float(np.median(times)), (total / reps / 1e3 if total else None)


def ptxas_report(source: str, instances: bool = False) -> dict | None:
    """Registers, stack and spills of each kernel in `source`, from the
    build's `-Xptxas -v` output, which `_build` keeps beside the library
    and reads back when an earlier process built it (None without it);
    with `instances`, one entry a template instantiation, named with its
    arguments (`analysis.resources.ptxas_report`)."""
    from repro_torch.analysis import resources
    from repro_torch.kernels import _build
    return resources.ptxas_report(_build.build_info.get("log", ""), source,
                                  instances)


def bound(bytes_moved: float, operations: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = operations / NON_TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_and_time_kernels(x_test: np.ndarray, plan, launches,
                           check_rows: tuple[int, ...]):
    """Hold every kernel against its plain version on the card at each row
    count in `check_rows`, then time kernel, plain version and library
    call at the bulk shape and at the largest serving bucket.  Returns the
    kernel rows and the tolerance control."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.binarize import binarize
    from repro_torch.kernels.fused_predict import fused_predict
    from repro_torch.kernels.leaf_gather import leaf_gather
    from repro_torch.kernels.leaf_index import leaf_index
    # a value's bin costs a binary search's compares, whatever the scan
    from repro_torch.launch.hlo_analysis import compares

    low = plan.lowered
    sf, sb, lv, borders = (low.split_features, low.split_bins,
                           low.leaf_values, low.borders)
    dev = plan.device
    x = torch.as_tensor(x_test, device=dev)
    t, d = sf.shape
    n_leaves, c = lv.shape[1:]
    bins = binarize(x, borders, out_dtype=torch.uint8)
    idx = leaf_index(bins, sf, sb)

    # --- agreement at every row count the main path runs (integers
    # exactly, sums within sum_limit); a partial last block is among them
    errs = {"binarize": 0.0, "leaf_index": 0.0, "leaf_gather": 0.0,
            "fused_predict": 0.0}
    of_limit = {"leaf_gather": 0.0, "fused_predict": 0.0}
    for n in check_rows:
        xn = x[:n]
        b8, b32 = ref.binarize_u8(xn, borders), ref.binarize(xn, borders)
        check(torch.equal(binarize(xn, borders, out_dtype=torch.uint8), b8),
              f"binarize (uint8) differs from its plain version at {n} rows")
        check(torch.equal(binarize(xn, borders, out_dtype=torch.int32), b32),
              f"binarize (int32) differs from its plain version at {n} rows")
        want_idx = ref.leaf_index(b32, sf, sb)
        check(torch.equal(leaf_index(b8, sf, sb), want_idx),
              f"leaf_index (uint8 bins) differs from its plain version at "
              f"{n} rows")
        check(torch.equal(leaf_index(b32, sf, sb), want_idx),
              f"leaf_index (int32 bins) differs from its plain version at "
              f"{n} rows")
        want = ref.leaf_gather(want_idx, lv)
        limit = sum_limit(want_idx, lv)
        # both of leaf_gather's routes, whichever the plan picks here, are
        # the tree-order sum bit for bit
        exact = tree_order_sum(want_idx, lv)
        for staged in (True, False):
            check(torch.equal(leaf_gather(want_idx, lv, staged=staged),
                              exact),
                  f"leaf_gather ({'staged' if staged else 'direct'}) at {n} "
                  "rows is not the tree-order sum")
        # and both of fused_predict's routes (so they equal each other)
        for route in FUSED_ROUTES:
            check(torch.equal(fused_predict(xn, borders, sf, sb, lv,
                                            route=route), exact),
                  f"fused_predict ({route}) at {n} rows is not the "
                  "tree-order sum")
        del exact
        got = {"leaf_gather": leaf_gather(want_idx, lv),
               "fused_predict": fused_predict(xn, borders, sf, sb, lv)}
        plain = {"leaf_gather": want,
                 "fused_predict": ref.fused_predict(xn, borders, sf, sb, lv)}
        for name in got:
            err, share = compare_sums(f"{name} at {n} rows", got[name],
                                      plain[name], limit)
            errs[name] = max(errs[name], err)
            of_limit[name] = max(of_limit[name], share)
        del got, plain
        del b8, b32, want_idx, want, limit
    odd_tables = check_binarize_odd_tables(x, borders, check_rows)
    torch.cuda.synchronize()

    # --- the control: the same sums over a bf16-rounded leaf table must
    # fall outside the limit
    limit = sum_limit(idx, lv)
    rounded = leaf_gather(idx, lv.to(torch.bfloat16).to(torch.float32))
    control_err = (rounded - leaf_gather(idx, lv)).abs()
    outside = float((control_err > limit).float().mean())
    check(outside > 0.0, "a bf16 leaf table stays within the float limit: "
          "the limit is too loose to catch it")
    control = {"kernel_err_over_limit": of_limit,
               "leaf_table": "bfloat16", "rows": len(x),
               "max_abs_err": float(control_err.max()),
               "share_outside_limit": outside,
               "limit_max": float(limit.max()),
               "limit_median": float(limit.median())}
    del rounded, control_err, limit

    # --- timing at the bulk shape (the whole test split in one call, as
    # quantize and the staged plan run it) and at the largest serving
    # bucket (as predict_batch and predict_pool run it)
    xt, bt = x.t().contiguous(), borders.t().contiguous()
    check(torch.equal(torch.searchsorted(bt, xt, out_int32=True).t(),
                      bins.to(torch.int32)),
          "searchsorted yardstick computes other bins")
    flat_idx = idx.long() + torch.arange(t, device=dev) * n_leaves
    flat_lv = lv.reshape(t * n_leaves, c)
    compare_sums("embedding_bag yardstick",
                 F.embedding_bag(flat_idx, flat_lv, mode="sum"),
                 ref.leaf_gather(idx, lv), sum_limit(idx, lv))

    def cases(n: int, sf=sf, sb=sb, lv=lv) -> dict:
        """Kernel, plain version, library call, bytes and operations of
        each kernel on the first `n` rows (the leaf rows the rows touch,
        not the whole table)."""
        t = sf.shape[0]
        xn, bn, ixn = x[:n], bins[:n], idx[:n]
        n_feat, n_b = x.shape[1], borders.shape[0]
        leaf_bytes = leaf_rows_touched(ixn, n_leaves) * c * 4
        table_bytes = leaf_bytes + sf.numel() * 8
        return {
            "binarize": dict(
                kernel=lambda: binarize(xn, borders, out_dtype=torch.uint8),
                plain=lambda: ref.binarize_u8(xn, borders),
                library=lambda: torch.searchsorted(bt, xt[:, :n],
                                                   out_int32=True),
                bytes=n * n_feat * 4 + n_b * n_feat * 4 + n * n_feat,
                ops=n * n_feat * compares(n_b)),
            "leaf_index": dict(
                kernel=lambda: leaf_index(bn, sf, sb),
                plain=lambda: ref.leaf_index(bn, sf, sb),
                library=None,
                bytes=n * n_feat + sf.numel() * 8 + n * t * 4,
                ops=n * t * d),
            "leaf_gather": dict(
                kernel=lambda: leaf_gather(ixn, lv),
                plain=lambda: ref.leaf_gather(ixn, lv),
                library=lambda: F.embedding_bag(flat_idx[:n], flat_lv,
                                                mode="sum"),
                bytes=n * t * 4 + leaf_bytes + n * c * 4,
                ops=n * t * c),
            "fused_predict": dict(
                kernel=lambda: fused_predict(xn, borders, sf, sb, lv),
                plain=lambda: ref.fused_predict(xn, borders, sf, sb, lv),
                library=None,
                bytes=n * n_feat * 4 + n_b * n_feat * 4 + table_bytes
                + n * c * 4,
                ops=n * n_feat * compares(n_b) + n * t * d + n * t * c),
        }

    sources = {
        "binarize": "src/repro/kernels/binarize.py:55",
        "leaf_index": "src/repro/kernels/leaf_index.py:64",
        "leaf_gather": "src/repro/kernels/leaf_gather.py:58",
        "fused_predict": "src/repro/kernels/fused_predict.py:112",
    }
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    bulk, bucket = cases(len(x)), cases(MAX_BATCH)
    rows = []
    for name, case in bulk.items():
        bound_ms, bound_by = bound(case["bytes"], case["ops"])
        small = bucket[name]
        bucket_bound_ms, bucket_bound_by = bound(small["bytes"], small["ops"])
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": sources[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": time_ms(case["kernel"], 20, flush),
            "plain_ms": time_ms(case["plain"], 5, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": (time_ms(case["library"], 10, flush)
                           if case["library"] else None),
            "n_rows": len(x), "n_trees": t,
            "bucket_rows": MAX_BATCH,
            "bucket_ms": time_ms(small["kernel"], 50, flush),
            "bucket_bound_ms": bucket_bound_ms,
            "bucket_bound_by": bucket_bound_by,
            **({"odd_tables": odd_tables} if name == "binarize" else {}),
        })
    # fused_predict's two routes at the bulk shape, the largest bucket and
    # the single-request bucket, and the one its plan picks at each
    from repro_torch.kernels.tuning import fused_plan, gather_plan
    fused = next(row for row in rows if row["name"] == "fused_predict")
    fused["routes"] = {}
    for label, n in (("bulk", len(x)), ("bucket", MAX_BATCH),
                     ("single", check_rows[-1])):
        xn = x[:n]
        small = cases(n)["fused_predict"]
        timing = {"rows": n, "plan": fused_plan(
            n, t, d, c, x.shape[1], borders.shape[0] <= 255).route,
            "bound_ms": bound(small["bytes"], small["ops"])[0]}
        for route in FUSED_ROUTES:
            fn = (lambda xn=xn, r=route: fused_predict(xn, borders, sf, sb,
                                                       lv, route=r))
            timing[f"{route}_ms"] = time_ms(fn, 20 if label == "bulk"
                                            else 50, flush)
            (timing[f"{route}_device_ms"],
             timing[f"{route}_profiled_ms"]) = device_ms(fn, flush)
        fused["routes"][label] = timing
    fused["single_ms"] = fused["routes"]["single"][
        f"{fused['routes']['single']['plan']}_ms"]

    # leaf_gather's two routes at both shapes, and the one its plan picks
    gather = next(row for row in rows if row["name"] == "leaf_gather")
    for label, n in (("bulk", len(x)), ("bucket", MAX_BATCH)):
        ixn = idx[:n]
        gather[f"{label}_route"] = ("staged" if gather_plan(
            n, t, n_leaves, c).staged else "direct")
        for route in ("staged", "direct"):
            gather[f"{label}_{route}_ms"] = time_ms(
                lambda ixn=ixn, r=route: leaf_gather(ixn, lv,
                                                     staged=r == "staged"),
                20 if label == "bulk" else 50, flush)

    # --- the tree axis padded to a multiple of TREE_TILE (always-left,
    # zero-leaf trees) against the plan's unpadded arrays, on the three
    # kernels that loop over trees; the padded sums must be bit-identical
    from repro_torch.kernels.ops import PAD_SPLIT_BIN, pad_dim
    tp = -(-t // TREE_TILE) * TREE_TILE
    padded = dict(sf=pad_dim(sf, 0, tp), sb=pad_dim(sb, 0, tp, PAD_SPLIT_BIN),
                  lv=pad_dim(lv, 0, tp))
    check(torch.equal(fused_predict(x, borders, padded["sf"], padded["sb"],
                                    padded["lv"]),
                      fused_predict(x, borders, sf, sb, lv)),
          "padded trees change the fused sums")
    tree_padding = {"trees": [t, tp], "rounds": PAIR_ROUNDS}
    for label, n in (("bulk", len(x)), ("bucket", MAX_BATCH)):
        plain_cases, pad_cases = cases(n), cases(n, **padded)
        pad_cases["leaf_gather"]["kernel"] = (
            lambda ip=pad_dim(idx[:n], 1, tp): leaf_gather(ip, padded["lv"]))
        for name in ("leaf_index", "leaf_gather", "fused_predict"):
            rounds = [(time_ms(plain_cases[name]["kernel"], 20, flush),
                       time_ms(pad_cases[name]["kernel"], 20, flush))
                      for _ in range(PAIR_ROUNDS)]
            unpadded, padded_ms = zip(*rounds)
            tree_padding[f"{name}_{label}"] = {
                "unpadded_ms": float(np.median(unpadded)),
                "padded_ms": float(np.median(padded_ms)),
                "unpadded_range_ms": [min(unpadded), max(unpadded)],
                "padded_range_ms": [min(padded_ms), max(padded_ms)]}
    return rows, control, tree_padding


def leaf_rows_touched(idx, n_leaves: int) -> int:
    """Distinct (tree, leaf) rows of the leaf table that `idx` reads."""
    import torch
    t = idx.shape[1]
    seen = torch.zeros(t * n_leaves, dtype=torch.bool, device=idx.device)
    seen[idx.long() + torch.arange(t, device=idx.device) * n_leaves] = True
    return int(seen.sum())


def check_binarize_odd_tables(x, borders, check_rows):
    """The binarize kernel on border tables that the port never builds,
    against both plain versions at each row count: column 0 shuffled
    (counted with the compare loop), column 1 with runs of duplicate
    borders, column 2 with a NaN border, and x holding NaN, +inf, -inf
    and values equal to borders; also on a misaligned slice, a row count
    with N * F % 4 != 0, and tables too large for shared memory (972
    features; 60,000 borders, one column shuffled).  Returns the cases
    and the columns made unsorted by construction."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.binarize import binarize
    rng = np.random.default_rng(SEED)
    odd = borders.clone()
    odd[:, 0] = odd[torch.as_tensor(rng.permutation(odd.shape[0]),
                                    device=odd.device), 0]
    dup = torch.as_tensor(np.sort(rng.choice(odd.shape[0] - 1, 20,
                                             replace=False)),
                          device=odd.device)
    odd[dup + 1, 1] = odd[dup, 1]
    odd[odd.shape[0] // 2, 2] = float("nan")
    xo = x.clone()
    n, f = xo.shape
    pick = torch.as_tensor(rng.integers(0, n, (4, 2048)), device=xo.device)
    cols = torch.as_tensor(rng.integers(0, f, (4, 2048)), device=xo.device)
    xo[pick[0], cols[0]] = float("nan")
    xo[pick[1], cols[1]] = float("inf")
    xo[pick[2], cols[2]] = -float("inf")
    at = torch.as_tensor(rng.integers(0, odd.shape[0], 2048),
                         device=xo.device)
    xo[pick[3], cols[3]] = odd[at, cols[3]]
    # the first rows carry every kind of odd value in the odd columns
    for j, v in enumerate((float("nan"), float("inf"), -float("inf"))):
        xo[j, :3] = v
    xo[3:3 + odd.shape[0], :3] = odd[:, :3]
    # a slice one row in (x not aligned for 16-byte loads: one element a
    # step) and N * F % 4 != 0 (the tail after the 4-element steps)
    cases = [(f"{rows} rows", xo[:rows], odd) for rows in check_rows]
    cases += [("1,023 rows from row 1", xo[1:1024], odd),
              ("1,023 rows", xo[:1023], odd)]
    # tables past a block's shared memory, read from global memory:
    # 18 copies of the columns (972 features), and 60,000 borders
    wide = odd.repeat(1, 18)
    cases += [(f"{rows:,} rows x {wide.shape[1]} features",
               xo[:rows].repeat(1, 18), wide) for rows in (1024, 17)]
    long_col = torch.as_tensor(
        np.sort(rng.normal(size=(60_000, 2)), axis=0).astype(np.float32),
        device=xo.device)
    long_col[:, 1] = long_col[torch.as_tensor(rng.permutation(60_000),
                                              device=xo.device), 1]
    cases.append(("257 rows x 60,000 borders",
                  torch.as_tensor(rng.normal(size=(257, 2)).astype(
                      np.float32), device=xo.device), long_col))
    for what, xn, table in cases:
        check(torch.equal(binarize(xn, table, out_dtype=torch.int32),
                          ref.binarize(xn, table)),
              f"binarize (int32) differs from its plain version on an odd "
              f"border table at {what}")
        if table.shape[0] <= ref.MAX_U8_BORDERS:
            check(torch.equal(binarize(xn, table, out_dtype=torch.uint8),
                              ref.binarize_u8(xn, table)),
                  f"binarize (uint8) differs from its plain version on an "
                  f"odd border table at {what}")
    return {"cases": [what for what, _, _ in cases], "shuffled_column": 0,
            "duplicate_column": 1, "duplicates": int(dup.numel()),
            "nan_border_column": 2}


def check_and_time_layout_kernels(x_test: np.ndarray, soa, dm, bp, bp_one,
                                  soa_one, launches,
                                  check_rows: tuple[int, ...]):
    """Hold the depth_major and bitpacked kernels against their plain
    versions on the card at each row count in `check_rows`, then time
    them at the bulk shape and at the largest serving bucket.

    `soa`, `dm` and `bp` are the truncated model's soa, depth_major and
    bitpacked layouts (8 depth groups, uint8 threshold planes except the
    int32 group of the clamped depth-0 trees), `bp_one` and `soa_one` the
    untruncated model's bitpacked (one group, the trees in model order)
    and soa layouts.  leaf_index_bp runs on every group of `bp` and on the
    one group with its planes as uint8 and widened to int32, each from
    uint8 and int32 bins.  fused_predict_dm's spread and row routes must
    each give the tree-order sum and soa's routes' scores bit for bit; so
    must fused_predict_bp's on the one group, with both plane dtypes, from
    uint8 bins and from int32 bins (the border table padded past 255 with
    +inf rows, which bin every x alike).  Both kernels' routes are timed
    at the bulk shape, the largest bucket and the smallest, beside the
    route the plan picks."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.binarize import binarize
    from repro_torch.kernels.fused_predict import (fused_predict,
                                                   fused_predict_bp,
                                                   fused_predict_dm)
    from repro_torch.kernels.leaf_index import leaf_index_bp, leaf_index_dm
    from repro_torch.kernels.tuning import fused_plan
    from repro_torch.launch.hlo_analysis import compares

    dev = dm.borders.device
    x = torch.as_tensor(x_test, device=dev)
    borders = dm.borders
    one = bp_one.groups[0]
    dm_planes = (dm.split_features_dm, dm.split_bins_dm, dm.pow2)
    bp_planes = [(g.split_features_bp, g.split_bins_bp) for g in bp.groups]
    bp_planes += [(one.split_features_bp, one.split_bins_bp),
                  (one.split_features_bp, one.split_bins_bp.int())]
    plane_dtypes = sorted({str(sb.dtype) for _, sb in bp_planes})
    check(plane_dtypes == ["torch.int32", "torch.uint8"],
          f"bitpacked planes cover {plane_dtypes}, not uint8 and int32")
    bins8 = binarize(x, borders, out_dtype=torch.uint8)
    # the same bins as int32: no x passes an +inf border
    wide = torch.cat([borders, torch.full(
        (ref.MAX_U8_BORDERS + 1 - borders.shape[0], borders.shape[1]),
        math.inf, device=dev)])

    errs = dict.fromkeys(("leaf_index_dm", "leaf_index_bp",
                          "fused_predict_dm", "fused_predict_bp"), 0.0)
    of_limit = {"fused_predict_dm": 0.0, "fused_predict_bp": 0.0}
    for n in check_rows:
        xn, b8 = x[:n], bins8[:n]
        for bins in (b8, b8.int()):
            kind = f"{str(bins.dtype)[6:]} bins at {n} rows"
            check(torch.equal(leaf_index_dm(bins, *dm_planes),
                              ref.leaf_index_depth_major(bins, *dm_planes)),
                  f"leaf_index_dm ({kind}) differs from its plain version")
            for sf, sb in bp_planes:
                check(torch.equal(leaf_index_bp(bins, sf, sb),
                                  ref.leaf_index_bitpacked(bins, sf, sb)),
                      f"leaf_index_bp ({str(sb.dtype)[6:]} planes of "
                      f"depth {sf.shape[0]}, {kind}) differs from its "
                      "plain version")
        idx = ref.leaf_index_depth_major(b8, *dm_planes)
        # both of fused_predict_dm's routes are the tree-order sum and
        # soa's routes, bit for bit
        exact = tree_order_sum(idx, dm.leaf_values)
        for route in FUSED_ROUTES:
            got = fused_predict_dm(xn, borders, *dm_planes, dm.leaf_values,
                                   route=route)
            check(torch.equal(got, exact), f"fused_predict_dm ({route}) at "
                  f"{n} rows is not the tree-order sum")
            check(torch.equal(got, fused_predict(
                xn, borders, soa.split_features, soa.split_bins,
                soa.leaf_values, route=route)),
                  f"fused_predict_dm ({route}) at {n} rows differs from soa "
                  "fused_predict's")
        del exact, got
        err, share = compare_sums(
            f"fused_predict_dm at {n} rows",
            fused_predict_dm(xn, borders, *dm_planes, dm.leaf_values),
            ref.fused_predict_depth_major(xn, borders, *dm_planes,
                                          dm.leaf_values),
            sum_limit(idx, dm.leaf_values))
        errs["fused_predict_dm"] = max(errs["fused_predict_dm"], err)
        of_limit["fused_predict_dm"] = max(of_limit["fused_predict_dm"],
                                           share)
        idx = ref.leaf_index_bitpacked(b8, *bp_planes[-2])
        # both of fused_predict_bp's routes, both plane dtypes, uint8 and
        # int32 bins: the tree-order sum and soa's routes, bit for bit
        exact = tree_order_sum(idx, one.leaf_values)
        for table in (borders, wide):
            for route in FUSED_ROUTES:
                want = fused_predict(xn, table, soa_one.split_features,
                                     soa_one.split_bins,
                                     soa_one.leaf_values, route=route)
                check(torch.equal(want, exact), f"fused_predict ({route}) "
                      f"at {n} rows, {table.shape[0]} borders is not the "
                      "tree-order sum")
                for sf, sb in bp_planes[-2:]:
                    kind = (f"({route}, {str(sb.dtype)[6:]} planes, "
                            f"{table.shape[0]} borders) at {n} rows")
                    got = fused_predict_bp(xn, table, sf, sb,
                                           one.leaf_values, route=route)
                    check(torch.equal(got, exact),
                          f"fused_predict_bp {kind} is not the tree-order "
                          "sum")
                    check(torch.equal(got, want), f"fused_predict_bp "
                          f"{kind} differs from soa fused_predict's")
        del exact, got, want
        for sf, sb in bp_planes[-2:]:
            err, share = compare_sums(
                f"fused_predict_bp ({str(sb.dtype)[6:]} planes) at {n} rows",
                fused_predict_bp(xn, borders, sf, sb, one.leaf_values),
                ref.fused_predict_bitpacked(xn, borders, sf, sb,
                                            one.leaf_values),
                sum_limit(idx, one.leaf_values))
            errs["fused_predict_bp"] = max(errs["fused_predict_bp"], err)
            of_limit["fused_predict_bp"] = max(
                of_limit["fused_predict_bp"], share)
        del idx
    torch.cuda.synchronize()

    n_feat, n_b = x.shape[1], borders.shape[0]
    c = dm.leaf_values.shape[2]

    def cases(n: int) -> dict:
        """Kernel, plain version, bytes and operations of each kernel on
        the first `n` rows: the dm kernels on the main path's model, the
        bp kernels on the one-group model (uint8 planes)."""
        xn, bn = x[:n], bins8[:n]
        sf, sb = bp_planes[-2]
        out = {}
        for name, planes, lv, index_k, index_ref, fused_k, fused_ref in (
                ("dm", dm_planes, dm.leaf_values, leaf_index_dm,
                 ref.leaf_index_depth_major, fused_predict_dm,
                 ref.fused_predict_depth_major),
                ("bp", (sf, sb), one.leaf_values, leaf_index_bp,
                 ref.leaf_index_bitpacked, fused_predict_bp,
                 ref.fused_predict_bitpacked)):
            d, t = planes[0].shape
            plane_bytes = sum(p.numel() * p.element_size() for p in planes)
            leaf_bytes = leaf_rows_touched(index_ref(bn, *planes),
                                           lv.shape[1]) * c * 4
            out[f"leaf_index_{name}"] = dict(
                kernel=lambda k=index_k, p=planes: k(bn, *p),
                plain=lambda k=index_ref, p=planes: k(bn, *p),
                bytes=n * n_feat + plane_bytes + n * t * 4,
                ops=n * t * d, n_trees=t)
            out[f"fused_predict_{name}"] = dict(
                kernel=lambda k=fused_k, p=planes, lv=lv:
                    k(xn, borders, *p, lv),
                routed=lambda r, k=fused_k, p=planes, lv=lv:
                    k(xn, borders, *p, lv, route=r),
                plain=lambda k=fused_ref, p=planes, lv=lv:
                    k(xn, borders, *p, lv),
                bytes=n * n_feat * 4 + n_b * n_feat * 4 + plane_bytes
                + leaf_bytes + n * c * 4,
                ops=n * n_feat * compares(n_b) + n * t * d + n * t * c,
                n_trees=t,
                depth=d)
        return out

    sources = {
        "leaf_index_dm": "src/repro/kernels/leaf_index.py:122",
        "fused_predict_dm": "src/repro/kernels/fused_predict.py:210",
        "leaf_index_bp": "src/repro/kernels/leaf_index.py:216",
        "fused_predict_bp": "src/repro/kernels/fused_predict.py:329",
    }
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    bulk, bucket = cases(len(x)), cases(MAX_BATCH)
    rows = []
    for name in sources:
        case, small = bulk[name], bucket[name]
        bound_ms, bound_by = bound(case["bytes"], case["ops"])
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": sources[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": time_ms(case["kernel"], 20, flush),
            "plain_ms": time_ms(case["plain"], 5, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "n_rows": len(x), "n_trees": case["n_trees"],
            "bucket_rows": MAX_BATCH,
            "bucket_ms": time_ms(small["kernel"], 50, flush),
            "bucket_plain_ms": time_ms(small["plain"], 5, flush),
            "bucket_bound_ms": bound(small["bytes"], small["ops"])[0],
            "bucket_bound_by": bound(small["bytes"], small["ops"])[1],
        })
    # the dm and bp fused kernels' two routes at the bulk shape, the
    # largest bucket and the single-request bucket, and the one each plan
    # picks at each
    for name, splits in (("fused_predict_dm", "planes"),
                         ("fused_predict_bp", "bitpacked")):
        fused = next(row for row in rows if row["name"] == name)
        fused["routes"] = {}
        for label, n in (("bulk", len(x)), ("bucket", MAX_BATCH),
                         ("single", check_rows[-1])):
            small = cases(n)[name]
            timing = {"rows": n, "plan": fused_plan(
                n, small["n_trees"], small["depth"], c, n_feat, n_b <= 255,
                splits=splits).route,
                "bound_ms": bound(small["bytes"], small["ops"])[0]}
            for route in FUSED_ROUTES:
                fn = (lambda k=small["routed"], r=route: k(r))
                timing[f"{route}_ms"] = time_ms(fn, 20 if label == "bulk"
                                                else 50, flush)
                (timing[f"{route}_device_ms"],
                 timing[f"{route}_profiled_ms"]) = device_ms(fn, flush)
            fused["routes"][label] = timing
        fused["single_ms"] = fused["routes"]["single"][
            f"{fused['routes']['single']['plan']}_ms"]
    return rows, of_limit


# The leaf-index body's edges: one tree, a lane short of and past a warp's
# 32-tree tile, a lane short of and past a 256-tree round; depth 1 and 16.
INDEX_EDGE_TREES = (1, 31, 33, 255, 257)
INDEX_EDGE_DEPTHS = (1, 16)


def check_and_time_index_kernels(x_test: np.ndarray, soa, grouped, rows,
                                 small_rows: int) -> dict:
    """leaf_index and leaf_index_dm, one kernel body (csrc/leaf_index.cuh),
    against their plain versions bit for bit at the edges of its design:
    INDEX_EDGE_TREES x INDEX_EDGE_DEPTHS on numpy-seeded splits (a padded
    tree every 7th, thresholds 0, past the last bin and past 255), each
    depth group of the truncated model (`grouped`), at the bucket, at
    `small_rows` and at one row, on uint8 and int32 bins.  Then each
    kernel's time beside its device time (spacer events) and the plan's
    choice, at the bulk shape, the bucket, `small_rows` and each depth
    group at the bucket (int32 bins, as the grouped layout binarizes),
    and its ptxas registers and spills a template instantiation: put in
    `rows`' two entries under "device" and "ptxas".  Returns the checks."""
    import torch
    from repro_torch.kernels import ref, tuning
    from repro_torch.kernels.binarize import binarize
    from repro_torch.kernels.leaf_index import leaf_index, leaf_index_dm
    from repro_torch.kernels.ops import PAD_SPLIT_BIN

    dev = soa.borders.device
    x = torch.as_tensor(x_test, device=dev)
    bins8 = binarize(x, soa.borders, out_dtype=torch.uint8)
    n_feat, n_bins = bins8.shape[1], soa.borders.shape[0] + 1

    def pow2(d):
        return (2.0 ** torch.arange(d, dtype=torch.float32, device=dev)
                ).reshape(d, 1)

    def held(what, sf, sb):
        for n in (MAX_BATCH, small_rows, 1):
            for bins in (bins8[:n], bins8[:n].int()):
                want = ref.leaf_index(bins, sf, sb)
                kind = f"{what}, {str(bins.dtype)[6:]} bins, {n} rows"
                check(torch.equal(leaf_index(bins, sf, sb), want),
                      f"leaf_index differs from its plain version at {kind}")
                check(torch.equal(leaf_index_dm(
                    bins, sf.t().contiguous(), sb.t().contiguous(),
                    pow2(sf.shape[1])), want),
                      f"leaf_index_dm differs from its plain version at "
                      f"{kind}")

    rng = np.random.default_rng(SEED + 22)
    checked = []
    for t in INDEX_EDGE_TREES:
        for d in INDEX_EDGE_DEPTHS:
            sf = rng.integers(0, n_feat, (t, d)).astype(np.int32)
            sb = rng.integers(-1, n_bins + 2, (t, d)).astype(np.int32)
            sb[rng.random((t, d)) < 0.05] = 300
            sb[::7] = PAD_SPLIT_BIN
            held(f"T = {t}, depth {d}", torch.as_tensor(sf, device=dev),
                 torch.as_tensor(sb, device=dev))
            checked.append(f"T={t} D={d}")
    for g in grouped.groups:
        held(f"the depth-{g.depth} group ({g.n_trees} trees)",
             g.split_features, g.split_bins)
        checked.append(f"group D={g.depth} T={g.n_trees}")
    torch.cuda.synchronize()

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    shapes = [("bulk", bins8, soa.split_features, soa.split_bins),
              ("bucket", bins8[:MAX_BATCH], soa.split_features,
               soa.split_bins),
              ("single", bins8[:small_rows], soa.split_features,
               soa.split_bins)]
    shapes += [(f"group_d{g.depth}", bins8[:MAX_BATCH].int(),
                g.split_features, g.split_bins) for g in grouped.groups]
    for name, source in (("leaf_index", "leaf_index.cu"),
                         ("leaf_index_dm", "leaf_index_dm.cu")):
        row = next(r for r in rows if r["name"] == name)
        row["device"] = {}
        for label, bins, sf, sb in shapes:
            (n, f), (t, d) = bins.shape, sf.shape
            if name == "leaf_index":
                fn = (lambda b=bins, sf=sf, sb=sb: leaf_index(b, sf, sb))
            else:
                planes = (sf.t().contiguous(), sb.t().contiguous(), pow2(d))
                fn = (lambda b=bins, p=planes: leaf_index_dm(b, *p))
            plan = tuning.index_plan(n, t, d, f, bins.element_size())
            bound_ms, bound_by = bound(
                n * f * bins.element_size() + t * d * 8 + n * t * 4,
                n * t * d)
            dev_ms, profiled = device_ms(fn, flush, key="leaf_index")
            row["device"][label] = {
                "rows": n, "trees": t, "depth": d,
                "bins": str(bins.dtype)[6:],
                "plan": {"rows": plan.tile.rows, "route": plan.tile.route,
                         "tree_groups": plan.n_tree_groups,
                         "rounds_per_group": plan.rounds_per_group,
                         "blocks": plan.n_blocks},
                "ms": time_ms(fn, 20 if label == "bulk" else 50, flush),
                "device_ms": dev_ms, "profiled_ms": profiled,
                "bound_ms": bound_ms, "bound_by": bound_by}
        row["ptxas"] = ptxas_report(source, instances=True)
    return {"edges": checked, "rows": [MAX_BATCH, small_rows, 1],
            "bins": ["uint8", "int32"]}


# --------------------------------------------------------------------------
# The training path
# --------------------------------------------------------------------------
def train_model(data):
    """`boosting.fit` on the card at full width: Covertype, MultiClass,
    depth 8, lr 0.5, 64 bins, N_TREES trees.  Returns the ensemble, the
    history, the params and the wall seconds."""
    import torch
    from repro_torch.core import boosting
    from repro_torch.core.losses import MultiClass
    params = dataclasses.replace(data.params, n_trees=N_TREES,
                                 max_bins=MAX_BINS, seed=SEED)
    t0 = time.perf_counter()
    ens, history = boosting.fit(
        data.x_train, data.y_train, params=params, device="cuda",
        loss=MultiClass(n_classes=data.n_classes))
    torch.cuda.synchronize()
    return ens, history, params, time.perf_counter() - t0


def check_training(ens, history, params, x_train):
    """The trainer's own contracts; returns the training pool, quantized
    again by a fresh plan."""
    from repro_torch.core.predictor import Predictor
    loss = history["train_loss"]
    check(len(loss) == params.n_trees and bool(np.isfinite(loss).all()),
          f"train loss has {len(loss)} values, not {params.n_trees} finite")
    check(loss[-1] < loss[0], f"train loss did not decrease: {loss[0]} -> "
          f"{loss[-1]}")
    plan = Predictor.build(ens, device="cuda", strategy="staged",
                           layout="soa")
    pool = plan.quantize(x_train)
    check(np.array_equal(plan.raw(pool).cpu().numpy(), history["final_raw"]),
          "final_raw differs from a fresh staged soa plan's raw(pool)")
    check(history["dispatch_delta"].get("binarize", 0) == 0,
          f"binarize dispatched while boosting: {history['dispatch_delta']}")
    # eager code: the level shapes a fit launches, `depth` by construction
    check(0 < history["hist_first_calls"] <= params.depth,
          f"{history['hist_first_calls']} first calls of a level histogram "
          f"shape, more than depth {params.depth}")
    return pool, {"loss_rises": int((np.diff(loss) > 0).sum()),
                  "first_loss": float(loss[0]), "last_loss": float(loss[-1]),
                  "serve_drift": check_serve_drift(ens, pool, history),
                  "dispatch_delta": history["dispatch_delta"],
                  "hist_first_calls": history["hist_first_calls"]}


DRIFT_ROWS = 65536      # rows of the training pool replayed at a time


def check_serve_drift(ens, pool, history):
    """The trainer's `final_raw` (the leaf_index and leaf_gather kernels
    on the training pool) against the plain accumulation the trainer
    carries, raw0 + w_t[leaf_t] tree by tree, replayed here from the
    ensemble with the plain leaf index: within `sum_limit` per output,
    widened for the base the trainer adds first (so each of its T
    roundings is up to u * (S + |base|)).  The replay must give the
    trainer's own `serve_drift`, the largest difference, exactly."""
    import torch
    from repro_torch.kernels import ref
    dev = pool.bins.device
    on_dev = ens.to(dev)
    base = on_dev.base_score
    final = torch.from_numpy(history["final_raw"]).to(dev)
    n_trees = on_dev.n_trees
    drift, worst = 0.0, 0.0
    for lo in range(0, final.shape[0], DRIFT_ROWS):
        bins = pool.bins[lo:lo + DRIFT_ROWS]
        idx = ref.leaf_index(bins, on_dev.split_features, on_dev.split_bins)
        raw = base[None, :].expand(bins.shape[0], -1).clone()
        for t in range(n_trees):
            raw = raw + on_dev.leaf_values[t][idx[:, t].long()]
        limit = sum_limit(idx, on_dev.leaf_values, base) \
            + K_SIGMA * math.sqrt(n_trees) * U * base.abs()[None, :]
        err, share = compare_sums(
            "final_raw against the trainer's accumulated raw",
            final[lo:lo + DRIFT_ROWS], raw, limit)
        drift, worst = max(drift, err), max(worst, share)
        del idx, raw, limit
    check(drift == history["serve_drift"],
          f"replayed serve drift {drift} is not the trainer's "
          f"{history['serve_drift']}")
    return {"max_abs": drift, "of_limit": worst}


def check_resume(pool, y, full, params):
    """A RESUME_TREES-tree run equals a RESUME_AT-tree run checkpointed
    and resumed to RESUME_TREES, bit for bit, and both equal the first
    trees of the full run."""
    from repro_torch.core.losses import MultiClass
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.gbdt import GBDTTrainer

    def fit(n_trees, **kw):
        trainer = GBDTTrainer(MultiClass(n_classes=full.n_outputs),
                              dataclasses.replace(params, n_trees=n_trees))
        return trainer.fit_pool(pool, y, borders=full.borders,
                                n_borders=full.n_borders, **kw)

    ens, hist = fit(RESUME_TREES)
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        ck = CheckpointManager(tmp)
        fit(RESUME_AT, checkpoint=ck, checkpoint_every=RESUME_AT // 2)
        check(ck.latest() == RESUME_AT, f"checkpoint at {ck.latest()}")
        resumed, hist_r = fit(RESUME_TREES, checkpoint=ck, resume_from=-1)
    head = full.slice_trees(0, RESUME_TREES)
    for field in ("split_features", "split_bins", "leaf_values"):
        check(torch_equal(getattr(resumed, field), getattr(ens, field)),
              f"resumed run's {field} differ from the uninterrupted run's")
        check(torch_equal(getattr(ens, field), getattr(head, field)),
              f"{RESUME_TREES}-tree run's {field} differ from the first "
              f"trees of the {full.n_trees}-tree run")
    for key in ("train_loss", "final_raw"):
        check(np.array_equal(hist_r[key], hist[key]),
              f"resumed run's {key} differs from the uninterrupted run's")
    return {"trees": RESUME_TREES, "checkpointed_at": RESUME_AT,
            "bit_identical": True}


PROFILE_TREES = 10      # trees of the profiled training window


def profile_training(pool, y, full, params):
    """Device time by kernel over PROFILE_TREES training trees
    (`torch.profiler`, after one warm-up run; the window includes the
    fit's closing serve-plan handoff), and the device's busy share of the
    window's wall time: the sum of every kernel's, copy's and memset's own
    device time over the host clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.losses import MultiClass
    from repro_torch.training.gbdt import GBDTTrainer

    def fit():
        GBDTTrainer(MultiClass(n_classes=full.n_outputs),
                    dataclasses.replace(params, n_trees=PROFILE_TREES)) \
            .fit_pool(pool, y, borders=full.borders, n_borders=full.n_borders)

    fit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = {}
    for e in prof.key_averages():
        # the kernels, copies and memsets themselves, not the host ops
        # that launched them (those report their children's time again)
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            device[e.key[:80]] = device.get(e.key[:80], 0.0) \
                + e.self_device_time_total / 1e3
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:12]
    return {"trees": PROFILE_TREES, "wall_ms": wall_ms,
            "device_ms": busy, "busy_share": busy / wall_ms if busy else None,
            "top_kernels_ms": dict(top)}


def torch_equal(a, b) -> bool:
    import torch
    return torch.equal(a.cpu(), b.cpu())


def fixed_point_quantum(gh):
    """(S,) f64 quantum of the histogram kernel's fixed point per stat:
    2^-e with e from `ref.stat_exponent`; 0 for an all-zero stat."""
    import torch
    from repro_torch.kernels import ref
    m = gh.abs().amax(0)
    q = torch.tensor([math.ldexp(1.0, -e) for e in ref.stat_exponent(gh)],
                     dtype=torch.float64, device=gh.device)
    return torch.where(m > 0, q, torch.zeros_like(q))


def hist_limits(bins_t, leaf, gh, n_bins, n_leaves):
    """Per-cell limits on how far the kernel may lie from the plain
    version: from its f64 evaluation, the §2 rule 8*sqrt(n)*u*sum|gh| over
    the cell's n rows plus n half-quanta of the kernel's fixed point; from
    the f32 plain version, that plus the f32 version's own worst case,
    (n + 1)*u*sum|gh| (with 5% for the u^2 terms): float atomics of
    constant addends round with a bias, so its error grows as n, not
    sqrt(n)."""
    import torch
    from repro_torch.kernels import ref
    ones = torch.ones((gh.shape[0], 1), dtype=torch.float64,
                      device=gh.device)
    count = ref.histogram(bins_t, leaf, ones, n_bins=n_bins,
                          n_leaves=n_leaves)
    abs_sum = ref.histogram(bins_t, leaf, gh.abs().double(), n_bins=n_bins,
                            n_leaves=n_leaves)
    quantum = fixed_point_quantum(gh)
    lim64 = 8 * count.clamp(min=1).sqrt() * U * abs_sum + count * quantum / 2
    lim32 = lim64 + 1.05 * (count + 1) * U * abs_sum
    return lim64, lim32


def over_limit(err, limit) -> float:
    """Largest err / limit; a cell with a zero limit must be exact."""
    import torch
    exact = (limit == 0) & (err > 0)
    if bool(exact.any()):
        return math.inf
    return float((err / limit.clamp(min=1e-300)).max())


def split_gains(hist, lim, valid, n_bins, l2):
    """f64 gains (F, B) of a level histogram as `_split_level` computes
    them (invalid splits -inf), and a bound on how far a gain can move
    when each cell moves by at most `lim`, the f32 cumsum and the f32
    gain arithmetic included."""
    import torch
    import torch.nn.functional as F
    n_feat, segments, c2 = hist.shape
    n_leaves, c = segments // n_bins, c2 // 2
    h = hist.double().view(n_feat, n_leaves, n_bins, c2)
    e = lim.double().view(n_feat, n_leaves, n_bins, c2)
    inc = h.cumsum(2)
    einc = e.cumsum(2) + n_bins * U * h.abs().cumsum(2)
    left = F.pad(inc[:, :, :-1], (0, 0, 1, 0))
    eleft = F.pad(einc[:, :, :-1], (0, 0, 1, 0))
    right, eright = inc[:, :, -1:] - left, einc[:, :, -1:] + eleft

    def term(side, err):
        g, hs, eg, eh = side[..., :c], side[..., c:], err[..., :c], \
            err[..., c:]
        d = hs + l2
        d_low = (d - eh).clamp(min=l2)    # true hessian sums are >= 0
        return g * g / d, (2 * g.abs() + eg) * eg / d_low \
            + g * g * eh / (d_low * d)

    tl, el = term(left, eleft)
    tr, er = term(right, eright)
    gain = (tl + tr).sum((1, 3))
    bound = (el + er).sum((1, 3)) + 2 * (n_leaves * c + 4) * U * gain
    nonempty = (left[..., c:].sum((1, 3)) > 0) \
        & (right[..., c:].sum((1, 3)) > 0)
    return torch.where(valid & nonempty, gain, -math.inf), bound


def replay_splits(full, pool, y, params):
    """Grow the first SPLIT_CHECK_TREES trees again with the trainer's
    stage functions, taking each level's split from the kernel's
    histogram as the trainer does, beside the split the f64 plain
    histogram of the same (leaf, gh) gives.  They must agree, except
    where the two gains lie within the bound the kernel's per-cell limit
    puts on them (counted).  Each tree's leaf sums are held against their
    plain version too.  The replayed trees must equal the trained ones
    bit for bit.  Returns the first tree's leaf ids per level, its gh,
    and the counts."""
    import torch
    from repro_torch.core.losses import MultiClass
    from repro_torch.kernels import ref
    from repro_torch.kernels.histogram import histogram
    from repro_torch.kernels.split_level import split_level_plain
    from repro_torch.training import gbdt

    dev = pool.bins.device
    bins_t = pool.bins.t().contiguous()
    n = bins_t.shape[1]
    n_bins = full.borders.shape[0] + 1
    b = torch.arange(n_bins, device=dev)
    valid = (b[None, :] >= 1) & (b[None, :] <= full.n_borders.to(dev)[:, None])
    loss = MultiClass(n_classes=full.n_outputs)
    yt = torch.as_tensor(y, device=dev)
    raw = loss.init_raw(yt)
    leaf_bins = torch.zeros((1, n), dtype=torch.uint8, device=dev)
    n_leaves = 1 << params.depth
    c = full.n_outputs
    levels, first_gh = [], None
    stats = {"levels": 0, "differ_within_bound": 0,
             "top_two_within_bound": 0, "max_gap_over_bound": 0.0,
             "leaf_sums_over_limit": 0.0, "leaf_sums_fixed_identical": 0}
    for t in range(SPLIT_CHECK_TREES):
        gh = gbdt._grad_stack(raw, yt, loss=loss)
        first_gh = gh if t == 0 else first_gh
        leaf = torch.zeros((n,), dtype=torch.int32, device=dev)
        sf, sb = [], []
        for d in range(params.depth):
            if t == 0:
                levels.append(leaf)
            kw = dict(n_bins=n_bins, n_leaves=1 << d)
            hk = histogram(bins_t, leaf, gh, **kw)
            # the plain split and the true gains from the f64 plain
            # histogram, bounded by the kernel's own limit against it
            hp = ref.histogram(bins_t, leaf, gh.double(), **kw)
            fk, bk, new_leaf = gbdt._split_level(
                hk, valid, bins_t, leaf, n_bins=n_bins, d=d, l2=params.l2_reg)
            fp, bp, _ = split_level_plain(
                hp, valid, bins_t, leaf, n_bins=n_bins, d=d, l2=params.l2_reg)
            gains, bound = split_gains(
                hp, hist_limits(bins_t, leaf, gh, **kw)[0], valid, n_bins,
                params.l2_reg)
            flat, flat_b = gains.reshape(-1), bound.reshape(-1)
            top = int(torch.argmax(flat))
            below = torch.where(flat < flat[top], flat, -math.inf)
            second = int(torch.argmax(below))
            if float(flat[top] - below[second]) <= float(flat_b[top]
                                                        + flat_b[second]):
                stats["top_two_within_bound"] += 1
            k = int(fk) * n_bins + int(bk)
            p = int(fp) * n_bins + int(bp)
            if k != p:
                gap = float(flat[p] - flat[k])
                share = gap / float(flat_b[p] + flat_b[k])
                stats["max_gap_over_bound"] = max(stats["max_gap_over_bound"],
                                                  share)
                check(share <= 1.0,
                      f"tree {t} level {d}: the kernel's split ({int(fk)}, "
                      f"{int(bk)}) differs from the plain split ({int(fp)}, "
                      f"{int(bp)}) by {gap}, {share:.3g} times the gains' "
                      "rounding bound")
                stats["differ_within_bound"] += 1
            stats["levels"] += 1
            leaf = new_leaf
            sf.append(fk)
            sb.append(bk)
        # the leaf sums: the kernel at one all-zero feature and one bin,
        # bit-identical across launches and within its limit of the f64
        # plain version; the trained tree's leaf values come from them
        kw = dict(n_bins=1, n_leaves=n_leaves)
        sums = histogram(leaf_bins, leaf, gh, **kw)
        check(torch.equal(sums, histogram(leaf_bins, leaf, gh, **kw)),
              f"tree {t}: leaf sums differ between two launches")
        check(torch.equal(sums, ref.histogram_fixed(leaf_bins, leaf, gh,
                                                    **kw)),
              f"tree {t}: leaf sums differ from the plain fixed-point "
              "version")
        stats["leaf_sums_fixed_identical"] += 1
        share = over_limit(
            (sums.double() - ref.histogram(leaf_bins, leaf, gh.double(),
                                           **kw)).abs(),
            hist_limits(leaf_bins, leaf, gh, **kw)[0])
        check(share <= 1.0, f"tree {t}: leaf sums differ from their plain "
              f"version, {share:.3g} times the limit")
        stats["leaf_sums_over_limit"] = max(stats["leaf_sums_over_limit"],
                                            share)
        raw, w, _ = gbdt._finish_plain(
            raw, yt, gh, leaf, leaf_bins, loss=loss, n_leaves=n_leaves,
            lr=params.learning_rate, l2=params.l2_reg, backend="cuda")
        check(torch.equal(w, -params.learning_rate * sums[0, :, :c]
                          / (sums[0, :, c:] + params.l2_reg)),
              f"tree {t}: leaf values are not the checked leaf sums'")
        check(torch_equal(torch.stack(sf), full.split_features[t])
              and torch_equal(torch.stack(sb), full.split_bins[t])
              and torch_equal(w, full.leaf_values[t]),
              f"replayed tree {t} differs from the trained one")
    return levels, first_gh, stats


def check_and_time_histogram(bins_t, levels, gh, n_bins, launches):
    """Hold the histogram kernel against its plain versions at every level
    shape of a tree (the first tree's leaf ids and gh) on the full uint8
    pool, on int32 bins at the deepest level and on the first
    HIST_SMALL_ROWS rows: it equals `ref.histogram_fixed` bit for bit, two
    launches give the same bits, and it lies within `hist_limits` of the
    f32 and f64 plain versions.  Then time kernel, plain version and the
    `index_add_` library call at each level.  Returns the kernels row."""
    import torch
    from repro_torch.kernels import ref, tuning
    from repro_torch.kernels.histogram import histogram

    dev = bins_t.device
    n_feat, n = bins_t.shape
    c2 = gh.shape[1]
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    per_level = []

    def held(name, bt, leaf, g, n_leaves):
        """The kernel's output at one case, its shares of the limits, its
        largest difference from the f32 plain version, the f64 plain
        version and the limit from an f32 sum."""
        kw = dict(n_bins=n_bins, n_leaves=n_leaves)
        a, b = histogram(bt, leaf, g, **kw), histogram(bt, leaf, g, **kw)
        check(torch.equal(a, b), f"histogram ({name}) differs between two "
              "launches on the same inputs")
        check(torch.equal(a, ref.histogram_fixed(bt, leaf, g, **kw)),
              f"histogram ({name}) differs from the plain fixed-point "
              "version")
        p32 = ref.histogram(bt, leaf, g, **kw)
        p64 = ref.histogram(bt, leaf, g.double(), **kw)
        lim64, lim32 = hist_limits(bt, leaf, g, **kw)
        e64 = (a.double() - p64).abs()
        e32 = (a.double() - p32.double()).abs()
        shares = {"over_limit_f64": over_limit(e64, lim64),
                  "over_limit_f32": over_limit(e32, lim32),
                  # the f32 plain version against the §2 rule alone
                  "plain_f32_over_rule": over_limit(
                      (p32.double() - p64).abs(), lim64)}
        check(shares["over_limit_f64"] <= 1.0 and
              shares["over_limit_f32"] <= 1.0,
              f"histogram ({name}) differs from its plain version: "
              f"{shares}")
        return a, shares, float(e32.max()), p64, lim32

    for d, leaf in enumerate(levels):
        n_leaves = 1 << d
        segments = n_leaves * n_bins
        a, shares, err, p64, lim32 = held(f"uint8, level {d}", bins_t,
                                          leaf, gh, n_leaves)
        small_err = max(held(f"uint8, {rows} rows, level {d}",
                             bins_t[:, :rows].contiguous(), leaf[:rows],
                             gh[:rows].contiguous(), n_leaves)[2]
                        for rows in HIST_SMALL_ROWS)
        ids = (torch.arange(n_feat, device=dev)[:, None] * segments
               + leaf.long()[None, :] * n_bins + bins_t.long()).reshape(-1)
        gh_rep = gh.repeat(n_feat, 1)
        library = torch.zeros((n_feat * segments, c2), device=dev) \
            .index_add_(0, ids, gh_rep).view(a.shape)
        check(over_limit((library.double() - p64).abs(), lim32) <= 1.0,
              "index_add_ yardstick computes another histogram")
        del library, p64, lim32
        kw = dict(n_bins=n_bins, n_leaves=n_leaves)
        bound_ms, bound_by = bound(
            n_feat * n + n * 4 + n * c2 * 4 + n_feat * segments * c2 * 4,
            n_feat * n * c2)
        plan = tuning.hist_plan(n_feat, n, n_leaves, n_bins, c2)
        per_level.append({
            "d": d, "leaves": n_leaves,
            "plan": {"feats_per_block": plan.feats_per_block,
                     "tiles": plan.n_tiles, "chunks": plan.row_chunks,
                     "blocks": plan.n_blocks},
            "ms": time_ms(lambda: histogram(bins_t, leaf, gh, **kw), 20,
                          flush),
            "plain_ms": time_ms(lambda: ref.histogram(bins_t, leaf, gh, **kw),
                                5, flush),
            "library_ms": time_ms(
                lambda: torch.zeros((n_feat * segments, c2), device=dev)
                .index_add_(0, ids, gh_rep), 10, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err, "small_rows_max_abs_err": small_err,
            **shares})
        del a, ids, gh_rep
    deepest = len(levels) - 1
    wide = bins_t.int()
    a32, shares32, err32, _, _ = held("int32 bins, deepest level", wide,
                                      levels[deepest], gh, 1 << deepest)
    check(torch.equal(a32, histogram(bins_t, levels[deepest], gh,
                                     n_bins=n_bins,
                                     n_leaves=1 << deepest)),
          "histogram differs between int32 and uint8 bins")
    int32_ms = time_ms(lambda: histogram(wide, levels[deepest], gh,
                                         n_bins=n_bins,
                                         n_leaves=1 << deepest), 20, flush)
    del wide, a32
    total = {k: sum(lv[k] for lv in per_level)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {
        "name": "histogram", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/histogram.cu",
        "replaces": "src/repro/kernels/histogram.py:85",
        "launches": launches,
        "max_abs_err": max([err32] + [max(lv["max_abs_err"],
                                          lv["small_rows_max_abs_err"])
                                      for lv in per_level]),
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("bytes" if all(lv["bound_by"] == "bytes"
                                    for lv in per_level) else "operations"),
        "library_ms": total["library_ms"],
        "fixed_point_identical": True,
        "per": f"one tree: the sum over its {len(levels)} level launches",
        "library_call": "torch.zeros + index_add_ over prebuilt flat "
                        "(feature, leaf, bin) ids and a per-feature copy "
                        "of gh",
        "n_rows": n, "n_features": n_feat, "n_stats": c2,
        "levels": per_level, "int32_deepest_ms": int32_ms,
        "int32_over_limit": shares32,
        "small_rows_checked": list(HIST_SMALL_ROWS)}


def serve_trained(ens, x_test, y_test):
    """The trained model behind `GBDTServer(layout="soa")`: the test split
    quantized once and scored through `predict_pool`."""
    import torch
    from repro_torch.serving.engine import GBDTServer
    server = GBDTServer(ens, device="cuda", max_batch=MAX_BATCH, layout="soa")
    try:
        t0 = time.perf_counter()
        proba = server.predict_pool(server.quantize(x_test))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        snap = server.metrics.snapshot()
    finally:
        server.close()
    check(proba.shape == (len(x_test), ens.n_outputs)
          and bool(np.isfinite(proba).all()), "trained model's proba")
    return {"rows": len(x_test), "seconds": secs,
            "rows_per_s": len(x_test) / secs,
            "batch_p50_ms": snap["batch_p50_ms"],
            "batch_p99_ms": snap["batch_p99_ms"],
            "test_accuracy": float((proba.argmax(1) == y_test).mean())}


# --------------------------------------------------------------------------
# The bulk path, the main path's other entry points, fit_source, the CLI
# --------------------------------------------------------------------------
BULK_REPEAT = 8          # SyntheticSource repeat: 8 x 139,440 = 1,115,520 rows
BULK_TIMED_RUNS = 3      # runs timed after the first
BULK_STEP = 65536        # rows a one-shot call the bulk output is held to
BULK_TOP_K = 100
FIT_SOURCE_TREES = 20


class Interrupted(Exception):
    """Raised by `InterruptingSink`: a run killed part-way."""


class InterruptingSink:
    """A sink that dies at the first write at or past row `stop_row`, as a
    killed process would, after flushing what it wrote."""

    def __init__(self, inner, stop_row: int):
        self.inner, self.stop_row = inner, stop_row

    def open(self, n_rows: int, n_cols: int) -> None:
        self.inner.open(n_rows, n_cols)

    def write(self, start: int, scores) -> None:
        if start >= self.stop_row:
            self.inner.close()
            raise Interrupted(start)
        self.inner.write(start, scores)

    def close(self):
        return self.inner.close()


def device_profile(run, top: int = 0) -> dict | None:
    """One call of `run` under `torch.profiler`: the share of its wall
    time in which the card ran any kernel, copy or memset (the union of
    their intervals, so the two streams' overlap counts once), that busy
    time, the wall time and the device operations, and with `top` the
    `top` operation names that took the most device time; None where the
    profiler sees no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    out = {"busy_share": busy / wall_us, "busy_ms": busy / 1e3,
           "wall_ms": wall_us / 1e3, "device_ops": len(spans)}
    if top:
        by_name = Counter()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name[:80]] += e.time_range.elapsed_us() / 1e3
        out["top_ms"] = dict(by_name.most_common(top))
    return out


def device_busy_share(run) -> float | None:
    """`device_profile(run)`'s busy share."""
    prof = device_profile(run)
    return None if prof is None else prof["busy_share"]


def run_bulk_path(full, x_test, tmp: str):
    """The paper's headline workload: `BulkScorer` sweeping 1,115,520 rows
    (the test split served 8 times over by `SyntheticSource`) through three
    plans that share one schema: `full`, `half` (its first 500 trees) and
    `joined` (`concat_ensembles` of both halves: `full`'s trees in
    `full`'s order), on soa, auto chunking, prefetch depth 2 (no worker
    at the auto chunk: `tuning.prefetch_depth`), uint8 pools, proba out;
    into an `NpySink`, a `StatsSink` and a `TopKSink`.  Then the same with
    float chunks (the `fused_predict` route), with chunks large enough for
    the prefetch worker on its side stream, a run killed at half its
    chunks and resumed, raw scores of `full` and `joined`, and one run
    under the profiler.  Returns the phase's line, the plans and the
    source."""
    import torch
    from repro_torch.core.predictor import Predictor
    from repro_torch.core.trees import concat_ensembles
    from repro_torch.kernels import ops, tuning
    from repro_torch.scoring import (ArraySink, BulkScorer, NpySink,
                                     ScoreConfig, StatsSink,
                                     SyntheticSource, TopKSink,
                                     plan_chunks)
    t_phase = time.perf_counter()
    half = full.slice_trees(0, full.n_trees // 2)
    joined = concat_ensembles(half, full.slice_trees(full.n_trees // 2,
                                                     full.n_trees))
    plans = {name: Predictor.build(e, device="cuda", layout="soa")
             for name, e in (("full", full), ("half", half),
                             ("joined", joined))}
    source = SyntheticSource("covertype", split="test", repeat=BULK_REPEAT)
    check(source.base_rows == len(x_test), "the bulk source is not the "
          "test split")
    cfg = ScoreConfig(output="proba", prefetch_depth=2, prequantize=True)
    scorer = BulkScorer(plans, cfg)
    chunk_rows = scorer.resolve_chunk_rows(source.n_rows)
    spans = plan_chunks(source.n_rows, chunk_rows)
    n_chunks = len(spans)
    print(f"bulk: {source.n_rows} rows x {source.n_features} in "
          f"{n_chunks} chunks of {chunk_rows} rows, 3 plans", flush=True)
    full_path = os.path.join(tmp, "full.npy")

    def sinks(path):
        return {"full": NpySink(path), "half": StatsSink(),
                "joined": TopKSink(BULK_TOP_K)}

    def run(config, out_sinks, plans_=plans):
        t0 = time.perf_counter()
        res = BulkScorer(plans_, config).score(source, out_sinks)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    first, first_s = run(cfg, sinks(full_path))
    launches = ops.launch_counts()
    check(launches["binarize"] == n_chunks,
          f"bulk: {launches['binarize']} binarize launches for {n_chunks} "
          "chunks of one schema")
    check(launches["fused_predict"] == 0,
          "bulk: the pool route launched fused_predict")
    check(first.chunk_rows == chunk_rows and len(first.chunk_shapes) <= 2,
          f"bulk: chunk shapes {first.chunk_shapes}")
    check(first.metrics["prefetch_depth"] == tuning.prefetch_depth(
        cfg.prefetch_depth, chunk_rows, n_chunks,
        scorer.device.type == "cuda"),
          f"bulk: prefetch depth {first.metrics['prefetch_depth']}")
    for name, plan in plans.items():
        traces = plan.stats["traces"]
        check(traces.get("raw_pool", 0) <= 2
              and traces.get("proba_pool", 0) <= 2
              and traces.get("proba", 0) == 0,
              f"bulk: {name}'s first calls {traces}")
    check(sum(p.stats["traces"].get("quantize", 0)
              for p in plans.values()) == 1,
          "bulk: more than one plan quantized")
    timed = []
    for i in range(BULK_TIMED_RUNS):
        res, _ = run(cfg, sinks(os.path.join(tmp, f"timed{i}.npy")))
        timed.append(res.metrics["rows_per_s"])

    # the pool route against the plan's own float entry (fused_predict)
    got = np.load(full_path, mmap_mode="r")
    check(got.shape == (source.n_rows, full.n_outputs),
          f"bulk: full's output shape {got.shape}")
    for s in range(0, source.n_rows, BULK_STEP):
        stop = min(s + BULK_STEP, source.n_rows)
        want = plans["full"].proba(source.read(s, stop)).cpu().numpy()
        check(np.array_equal(got[s:stop], want),
              f"bulk: full's scores of rows [{s}, {stop}) differ from the "
              "plan's one-shot proba")
    check(bool(np.isfinite(got).all())
          and bool(np.allclose(got.sum(1), 1.0, atol=1e-5)),
          "bulk: full's probabilities")
    order = np.argsort(-got[:, 0], kind="stable")[:BULK_TOP_K]
    top = first.outputs["joined"]
    check(np.array_equal(top["indices"], order)
          and np.array_equal(top["scores"], got[order]),
          "bulk: joined's top rows differ from full's")
    stats = first.outputs["half"]
    check(stats["count"] == source.n_rows
          and bool(np.isfinite(stats["mean"]).all()),
          "bulk: half's stats")

    # float chunks: the fused route, the same bits
    float_path = os.path.join(tmp, "float.npy")
    second, second_s = run(dataclasses.replace(cfg, prequantize=False),
                           sinks(float_path))
    check(np.array_equal(np.load(float_path), np.load(full_path)),
          "bulk: prequantize=False scores differ from the pool route's")
    check(np.array_equal(second.outputs["joined"]["indices"],
                         top["indices"])
          and all(np.array_equal(second.outputs["half"][k], stats[k])
                  for k in ("mean", "std", "min", "max")),
          "bulk: prequantize=False streaming sinks differ")

    # chunks large enough for the prefetch worker: the side stream and the
    # worker's binarize launches, the same bits
    worker_rows = max(chunk_rows, tuning.PREFETCH_MIN_CHUNK_ROWS)
    worker_chunks = len(plan_chunks(source.n_rows, worker_rows))
    worker_cfg = dataclasses.replace(cfg, chunk_rows=worker_rows)
    worker_path = os.path.join(tmp, "worker.npy")
    before = ops.launch_counts()["binarize"]
    worker, worker_s = run(worker_cfg, sinks(worker_path))
    check(worker.metrics["prefetch_depth"] == cfg.prefetch_depth,
          f"bulk: {worker_rows}-row chunks ran without the prefetch worker")
    check(ops.launch_counts()["binarize"] - before == worker_chunks,
          f"bulk: the worker's binarize launches for {worker_chunks} chunks")
    check(np.array_equal(np.load(worker_path), np.load(full_path)),
          f"bulk: full's scores in {worker_rows}-row chunks with the "
          "prefetch worker differ from the auto chunks'")
    check(np.array_equal(worker.outputs["joined"]["indices"], top["indices"])
          and np.array_equal(worker.outputs["joined"]["scores"],
                             top["scores"]),
          f"bulk: joined's top rows in {worker_rows}-row chunks differ")
    # StatsSink merges a chunk's float64 moments at a time (Chan), so the
    # mean and std move with the chunk boundaries by float64 rounding
    got_stats = worker.outputs["half"]
    check(got_stats["count"] == stats["count"]
          and all(np.array_equal(got_stats[k], stats[k])
                  for k in ("min", "max"))
          and all(np.allclose(got_stats[k], stats[k], rtol=1e-12, atol=0)
                  for k in ("mean", "std")),
          f"bulk: half's stats in {worker_rows}-row chunks differ")
    worker_timed = [run(worker_cfg, sinks(worker_path))[0]
                    .metrics["rows_per_s"] for _ in range(BULK_TIMED_RUNS)]

    # killed at half its chunks, then resumed into the same file
    k = n_chunks // 2
    part_path = os.path.join(tmp, "resumed.npy")
    only_full = {"full": plans["full"]}
    try:
        run(cfg, InterruptingSink(NpySink(part_path), spans[k].start),
            only_full)
        fail("bulk: the interrupted run was not interrupted")
    except Interrupted:
        pass
    resumed = BulkScorer(only_full, cfg).score(
        source, NpySink(part_path, resume=True), resume_from=k)
    check(resumed.metrics["resumed_from"] == k
          and resumed.metrics["rows"] == source.n_rows - spans[k].start,
          f"bulk: resumed run {resumed.metrics}")
    check(np.array_equal(np.load(part_path), np.load(full_path)),
          f"bulk: the run resumed at chunk {k} differs from the whole run")

    # raw scores: joined sums full's trees in full's order
    raw, _ = run(dataclasses.replace(cfg, output="raw"),
                 {"full": ArraySink(), "joined": ArraySink()},
                 {"full": plans["full"], "joined": plans["joined"]})
    raw_full = raw.outputs["full"]
    check(np.array_equal(raw.outputs["joined"], raw_full),
          "bulk: joined's raw scores differ from full's")

    # the card against the plain plan on the CPU: class ids on rows whose
    # margin clears twice the float limit
    from repro_torch.core.predictor import classify_from_raw
    from repro_torch.kernels import ops as ops_mod
    xs = x_test[:N_REFERENCE]
    cpu_plan = Predictor.build(full, device="cpu", layout="soa")
    raw_cpu = cpu_plan.raw(xs)
    idx = ops_mod.leaf_index(cpu_plan.quantize(xs).bins,
                             cpu_plan.ensemble.split_features,
                             cpu_plan.ensemble.split_bins)
    limit = sum_limit(idx, cpu_plan.ensemble.leaf_values,
                      cpu_plan.ensemble.base_score)
    raw_gpu = torch.from_numpy(raw_full[:N_REFERENCE])
    err, share = compare_sums("bulk: card vs CPU raw scores", raw_gpu,
                              raw_cpu, limit)
    top2 = raw_cpu.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * limit.max(dim=1).values
    c = full.n_outputs
    agree = classify_from_raw(raw_gpu, c) == classify_from_raw(raw_cpu, c)
    check(bool(agree[clear].all()), "bulk: card and CPU classify "
          "differently")

    busy = device_busy_share(
        lambda: BulkScorer(plans, cfg).score(
            source, sinks(os.path.join(tmp, "profiled.npy"))))
    m = first.metrics
    return {
        "rows": source.n_rows, "features": source.n_features,
        "plans": {n: p.ensemble.n_trees for n, p in plans.items()},
        "chunk_rows": chunk_rows, "chunk_shapes": list(first.chunk_shapes),
        "n_chunks": n_chunks, "binarize_launches": launches["binarize"],
        "first_run": {"seconds": first_s, "rows_per_s": m["rows_per_s"],
                      "quantize_s": m["quantize_s"],
                      "score_s": m["score_s"],
                      "quantize_frac": m["quantize_frac"],
                      "chunk_p50_ms": m["chunk_p50_ms"],
                      "chunk_p99_ms": m["chunk_p99_ms"],
                      "compiles": m["compiles"]},
        "rows_per_s_runs": timed,
        "rows_per_s_median": float(np.median(timed)),
        "prefetch_depth": m["prefetch_depth"],
        "float_route": {"seconds": second_s,
                        "rows_per_s": second.metrics["rows_per_s"],
                        "quantize_frac": second.metrics["quantize_frac"]},
        "worker_route": {"chunk_rows": worker_rows,
                         "n_chunks": worker_chunks,
                         "prefetch_depth": worker.metrics["prefetch_depth"],
                         "seconds": worker_s,
                         "rows_per_s": worker.metrics["rows_per_s"],
                         "rows_per_s_runs": worker_timed,
                         "rows_per_s_median": float(np.median(worker_timed)),
                         "quantize_frac": worker.metrics["quantize_frac"]},
        "resumed_from_chunk": k,
        "card_vs_cpu": {"max_abs_err": err, "err_over_limit": share,
                        "rows_compared": int(clear.sum())},
        "device_busy_share": busy,
        "seconds": time.perf_counter() - t_phase}, plans, source


def check_bulk_kernels(plans, source, chunk_sizes) -> list:
    """The bulk path's kernels against their plain versions at the shapes
    that path gives them: for each chunk size it ran, chunk 0 and the
    tail chunk, each built by the scorer's own prefetch transform
    (`BulkScorer._prepare`: the copy through the pinned buffer on the side
    stream, the pool quantized at the full chunk shape and the tail's pool
    sliced and re-padded to its bucket, the float chunk zero-padded).  The
    pool's bins and `leaf_index` equal the plain versions, `leaf_gather`
    and `fused_predict` the tree-order float32 sum, bit for bit, on every
    plan's lowered arrays.  Its launches are comparisons: the caller reads
    the path's counts before it."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.scoring import BulkScorer, ScoreConfig, plan_chunks
    from repro_torch.scoring.scorer import _FLOAT, ScoringMetrics, _ChunkIO
    checked = []
    for chunk_rows in chunk_sizes:
        spans = plan_chunks(source.n_rows, chunk_rows)
        for span in (spans[0], spans[-1]):
            x = np.asarray(source.read(span.start, span.stop), np.float32)
            payload = {}
            for prequantize in (True, False):
                scorer = BulkScorer(plans, ScoreConfig(
                    chunk_rows=chunk_rows, prequantize=prequantize))
                io = _ChunkIO(scorer.device, max(chunk_rows, span.padded),
                              scorer.n_features)
                _, got, event = scorer._prepare(ScoringMetrics(), io,
                                                chunk_rows)((span, x))
                io.receive(got, event)
                payload.update(got)
            torch.cuda.synchronize()
            xf = payload.pop(_FLOAT)
            (pool,) = payload.values()
            borders = next(iter(plans.values())).lowered.borders
            xd = torch.zeros((max(chunk_rows, span.padded), x.shape[1]),
                             device=borders.device)
            xd[:span.n_valid] = torch.from_numpy(x).to(borders.device)
            what = (f"{span.padded} rows ({span.n_valid} valid) of chunk "
                    f"{span.index} of {chunk_rows}")
            check(torch.equal(xf, xd[:span.padded]),
                  f"bulk: the float chunk at {what} is not the source's rows")
            want_bins = ref.binarize_u8(xd[:chunk_rows], borders)
            if span.padded != chunk_rows:
                want_bins = ops.pad_dim(want_bins[:span.n_valid], 0,
                                        span.padded)
            check(torch.equal(pool.bins, want_bins),
                  f"bulk: binarize's pool at {what} differs from its plain "
                  "version")
            for name, plan in plans.items():
                low = plan.lowered
                blocks = low.tree_blocks or ((low.split_features,
                                              low.split_bins,
                                              low.leaf_values),)
                for sf, sb, lv in blocks:
                    idx = ops.leaf_index(pool.bins, sf, sb)
                    check(torch.equal(idx, ref.leaf_index(pool.bins, sf, sb)),
                          f"bulk: leaf_index ({name}, {sf.shape[0]} trees) "
                          f"at {what} differs from its plain version")
                    check(torch.equal(ops.leaf_gather(idx, lv),
                                      tree_order_sum(idx, lv)),
                          f"bulk: leaf_gather ({name}) at {what} is not the "
                          "tree-order sum")
                want = tree_order_sum(
                    ref.leaf_index(ref.binarize(xf, low.borders),
                                   low.split_features, low.split_bins),
                    low.leaf_values)
                check(torch.equal(ops.fused_predict(
                    xf, low.borders, low.split_features, low.split_bins,
                    low.leaf_values), want),
                      f"bulk: fused_predict ({name}) at {what} is not the "
                      "tree-order sum")
            checked.append({"chunk_rows": chunk_rows, "chunk": span.index,
                            "rows": span.padded, "valid": span.n_valid})
    return checked


def catboost_json(ens) -> dict:
    """`ens` as a CatBoost JSON model export (the subset
    `load_catboost_json` reads).  float32 values print as the shortest
    decimal of their double and parse back to the same float32."""
    from repro_torch.kernels.ops import PAD_SPLIT_BIN
    sf = ens.split_features.cpu().numpy()
    sb = ens.split_bins.cpu().numpy()
    lv = ens.leaf_values.cpu().numpy()
    borders = ens.borders.cpu().numpy()
    nb = ens.n_borders.cpu().numpy()
    depths = ens.true_depths
    trees = []
    for t in range(ens.n_trees):
        d = int(depths[t])
        check(bool(((sb[t, :d] >= 1) & (sb[t, :d] <= nb[sf[t, :d]])
                    & (sb[t, :d] != PAD_SPLIT_BIN)).all()),
              f"tree {t} has a split no CatBoost border expresses")
        trees.append({
            "splits": [{"split_type": "FloatFeature",
                        "float_feature_index": int(sf[t, j]),
                        "border": float(borders[sb[t, j] - 1, sf[t, j]])}
                       for j in range(d)],
            "leaf_values": [float(v) for v in lv[t, :1 << d].reshape(-1)]})
    return {"features_info": {"float_features": [
                {"flat_feature_index": f,
                 "borders": [float(v) for v in borders[:nb[f], f]]}
                for f in range(ens.n_features)]},
            "oblivious_trees": trees,
            "scale_and_bias": [1.0, [float(v) for v in
                                     ens.base_score.cpu().numpy()]]}


def run_entry_points(full, x_test, tmp: str) -> dict:
    """The main path's other entry points on the card: the one-shot API,
    a CatBoost JSON export of `full` read back, `ModelRegistry` with
    `full` and `half`, and `GBDTServer.score_source`."""
    import torch
    from repro_torch.core.predict import raw_predict
    from repro_torch.core.predictor import Predictor
    from repro_torch.kernels import ops
    from repro_torch.scoring import ArraySource
    from repro_torch.serving.engine import ModelRegistry
    t_phase = time.perf_counter()
    xs = x_test[:N_REFERENCE]
    plan = Predictor.build(full, device="cuda")
    want = plan.raw(xs)
    check(torch.equal(raw_predict(full, xs), want),
          "raw_predict differs from Predictor.build(full).raw")

    path = os.path.join(tmp, "full.json")
    with open(path, "w") as fh:
        json.dump(catboost_json(full), fh)
    json_plan = Predictor.from_catboost_json(path)
    check(json_plan.device == plan.device, "the JSON plan is off the card")
    check(torch.equal(json_plan.raw(xs), want),
          "the CatBoost JSON export read back scores differently")

    reg = ModelRegistry(device="cuda", max_batch=MAX_BATCH)
    try:
        reg.register("full", full)
        reg.register("half", full.slice_trees(0, full.n_trees // 2))
        before = ops.launch_counts()["binarize"]
        multi = reg.predict_multi(xs)
        multi_binarize = ops.launch_counts()["binarize"] - before
        check(multi_binarize == 1, f"predict_multi launched binarize "
              f"{multi_binarize} times for one schema")
        for name in reg.names():
            check(np.array_equal(multi[name], reg.predict_batch(name, xs)),
                  f"predict_multi differs from {name}'s predict_batch")
        server = reg.get("full")
        t0 = time.perf_counter()
        res = server.score_source(ArraySource(x_test))
        score_source_s = time.perf_counter() - t0
        check(np.array_equal(res.output, server.predict_batch(x_test)),
              "score_source differs from predict_batch")
    finally:
        reg.close()
    return {"rows": len(x_test), "score_source_s": score_source_s,
            "score_source_rows_per_s": res.metrics["rows_per_s"],
            "predict_multi_binarize_launches": multi_binarize,
            "json_bytes": os.path.getsize(path),
            "seconds": time.perf_counter() - t_phase}


def run_fit_source(data, params) -> dict:
    """`GBDTTrainer.fit_source` on the training split streamed from a
    `SyntheticSource`, FIT_SOURCE_TREES trees, against the same pieces
    made in core."""
    import torch
    from repro_torch.core import quantize
    from repro_torch.core.losses import MultiClass
    from repro_torch.scoring import SyntheticSource, iter_chunks
    from repro_torch.training.gbdt import GBDTTrainer
    t_phase = time.perf_counter()
    source = SyntheticSource("covertype", split="train")
    check(source.n_rows == len(data.x_train), "fit_source's source is not "
          "the training split")
    p = dataclasses.replace(params, n_trees=FIT_SOURCE_TREES)

    def trainer():
        return GBDTTrainer(MultiClass(n_classes=data.n_classes), p,
                           device="cuda")

    tr = trainer()
    t0 = time.perf_counter()
    ens, hist = tr.fit_source(source, data.y_train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    snap = tr.metrics.snapshot()
    chunk_rows = hist["chunk_rows"]
    n_chunks = -(-source.n_rows // chunk_rows)
    check(snap["n_chunks"] == hist["n_chunks"] == n_chunks > 1
          and snap["chunk_rows"] == chunk_rows and snap["quantize_s"] > 0,
          f"fit_source's metrics {snap}")
    borders, n_borders = quantize.compute_borders_chunked(
        iter_chunks(source, chunk_rows), p.max_bins)
    check(torch.equal(ens.borders.cpu(), borders)
          and torch.equal(ens.n_borders.cpu(), n_borders),
          "fit_source's borders differ from compute_borders_chunked's")
    pool = quantize.quantize_pool(
        torch.as_tensor(data.x_train, device=tr.device),
        borders.to(tr.device))
    check(torch.equal(pool.bins, tr.pool_.bins),
          "fit_source's pool differs from quantize_pool of the matrix")
    ens_p, _ = trainer().fit_pool(pool, data.y_train, borders=borders,
                                  n_borders=n_borders)
    for f in ("split_features", "split_bins", "leaf_values", "base_score"):
        check(torch.equal(getattr(ens, f).cpu(), getattr(ens_p, f).cpu()),
              f"fit_source's {f} differ from fit_pool's")
    return {"rows": source.n_rows, "trees": ens.n_trees,
            "chunk_rows": chunk_rows, "n_chunks": n_chunks,
            "quantize_s": snap["quantize_s"], "fit_s": fit_s,
            "final_train_loss": snap["final_train_loss"],
            "seconds": time.perf_counter() - t_phase}


def run_score_cli() -> dict:
    """`python3 -m repro_torch.launch.score ... --check` in a process of
    its own (`run_launcher`): it trains a model on the card, bulk-scores
    the test split through two plans and holds the output to the plans'
    own entries."""
    out, lines = read_launcher(*launch_process("score_cli"))
    del out["result"]
    metrics = json.loads(lines[-1])
    return {**out, "rows": metrics["rows"], "chunks": metrics["chunks"],
            "rows_per_s": metrics["rows_per_s"]}


# --------------------------------------------------------------------------
# The training remainders: rsm < 1, ordered boosting, the carried key,
# fit_scan; then the launchers and the examples
# --------------------------------------------------------------------------
REMAINDER_TREES = 100    # of the Covertype model's 1,000: the time limit
REMAINDER_HALF = 50      # trees checkpointed before the resumed half
REMAINDER_RSM = 0.5
REMAINDER_FITS = {"rsm": {"rsm": REMAINDER_RSM},
                  "ordered": {"ordered": True},
                  "rsm_ordered": {"rsm": REMAINDER_RSM, "ordered": True}}
PERMUTATION_REPS = 10    # permutations of the training rows timed


def run_training_remainders(data, full, params) -> dict:
    """`GBDTTrainer.fit_pool` with rsm = 0.5, ordered boosting and both,
    REMAINDER_TREES trees on the training split quantized under the full
    model's borders, beside a plain fit; JAX's RNG stream on the card."""
    import torch
    from repro_torch.core import prng, quantize
    from repro_torch.core.losses import MultiClass
    from repro_torch.core.predictor import Predictor
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.gbdt import GBDTTrainer, TrainState
    t_phase = time.perf_counter()
    pool = quantize.quantize_pool(
        torch.as_tensor(data.x_train, device="cuda"), full.borders.cuda())
    n_rows, n_feat = pool.bins.shape
    base = dataclasses.replace(params, n_trees=REMAINDER_TREES)

    def fit(p, **kw):
        trainer = GBDTTrainer(MultiClass(n_classes=data.n_classes), p,
                              device="cuda")
        t0 = time.perf_counter()
        ens, hist = trainer.fit_pool(pool, data.y_train,
                                     borders=full.borders,
                                     n_borders=full.n_borders, **kw)
        torch.cuda.synchronize()
        return ens, hist, time.perf_counter() - t0

    def stages(hist):
        m = hist["metrics"]
        return {k: m[k] for k in ("iter_p50_ms", "hist_p50_ms",
                                  "split_p50_ms", "leaf_p50_ms")}

    _, hist, plain_s = fit(base)
    out = {"trees": REMAINDER_TREES, "rows": n_rows,
           "plain": {"s_per_tree": plain_s / REMAINDER_TREES,
                     **stages(hist)}}
    keep = max(1, int(n_feat * REMAINDER_RSM))
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    for name, options in REMAINDER_FITS.items():
        p = dataclasses.replace(base, **options)
        ens, hist, secs = fit(p)
        loss = hist["train_loss"]
        check(len(loss) == p.n_trees and bool(np.isfinite(loss).all())
              and loss[-1] < loss[0],
              f"{name}: train loss {loss[0]} -> {loss[-1]} over "
              f"{len(loss)} trees")
        plan = Predictor.build(ens, device="cuda", strategy="staged",
                               layout="soa")
        check(np.array_equal(plan.raw(pool).cpu().numpy(),
                             hist["final_raw"]),
              f"{name}: final_raw differs from a fresh staged soa plan's "
              "raw(pool)")
        check(hist["dispatch_delta"].get("binarize", 0) == 0,
              f"{name}: binarize dispatched while boosting")
        check(0 < hist["hist_first_calls"] <= p.depth,
              f"{name}: {hist['hist_first_calls']} level histogram shapes")
        used = set()
        if p.rsm < 1.0:
            key = prng.initial_key(p.seed)
            for t, tree in enumerate(ens.split_features.numpy()):
                key, sub, _ = prng.split(key, 3)
                mask = set(prng.permutation(sub, n_feat)[:keep].tolist())
                check(len(mask) == keep and set(tree.tolist()) <= mask,
                      f"{name}: tree {t} splits on {sorted(set(tree))} "
                      f"outside its {keep}-feature mask")
                used |= set(tree.tolist())
        # REMAINDER_HALF trees checkpointed, then resumed to the end
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            ck = CheckpointManager(tmp)
            fit(dataclasses.replace(p, n_trees=REMAINDER_HALF),
                checkpoint=ck, checkpoint_every=REMAINDER_HALF)
            state = TrainState.from_tree(ck.restore(REMAINDER_HALF))
            key = prng.initial_key(p.seed)
            for _ in range(REMAINDER_HALF):
                key = prng.split(key, 3)[0]
            check(np.array_equal(state.key, key),
                  f"{name}: checkpoint key {state.key} is not the key "
                  f"split {REMAINDER_HALF} times on the host, {key}")
            resumed, hist_r, _ = fit(p, checkpoint=ck, resume_from=-1)
        for field in ("split_features", "split_bins", "leaf_values"):
            check(torch_equal(getattr(resumed, field), getattr(ens, field)),
                  f"{name}: the resumed run's {field} differ from the "
                  "uninterrupted run's")
        for k in ("train_loss", "final_raw"):
            check(np.array_equal(hist_r[k], hist[k]),
                  f"{name}: the resumed run's {k} differs from the "
                  "uninterrupted run's")
        out[name] = {"s_per_tree": secs / p.n_trees, **stages(hist),
                     "first_loss": float(loss[0]),
                     "last_loss": float(loss[-1]),
                     "serve_drift": hist["serve_drift"],
                     "features_split_on": len(used) if used else None,
                     "resumed_bit_identical": True}
    # the card's permutation is the CPU's, at the feature width and at
    # the training rows (sort keys tie there)
    key = prng.split(prng.initial_key(SEED), 3)[2]
    for n in (n_feat, n_rows):
        check(torch.equal(prng.permutation(key, n, "cuda").cpu(),
                          prng.permutation(key, n)),
              f"prng.permutation on the card differs from the CPU's at "
              f"n = {n}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PERMUTATION_REPS):
        prng.permutation(key, n_rows, "cuda")
    torch.cuda.synchronize()
    out["permutation_ms"] = (time.perf_counter() - t0) * 1e3 \
        / PERMUTATION_REPS
    out["seconds"] = time.perf_counter() - t_phase
    return out


FIT_SCAN_FITS = {"plain": {}, "rsm_ordered": {"rsm": REMAINDER_RSM,
                                              "ordered": True}}


def run_fit_scan() -> dict:
    """The seed float trainer on tests/test_differential.py's case (400 x
    6 rows, 8 trees, depth 3, 16 bins, seed 3): two runs give the same
    bits, their splits equal `fit`'s, leaf values and losses lie within
    rtol = atol = 1e-4 of `fit`'s."""
    import torch
    from repro_torch.core import boosting
    from repro_torch.core.losses import make_loss
    rng = np.random.default_rng(5)
    x = rng.normal(size=(400, 6)).astype(np.float32)
    y = (x[:, 0] - 2.0 * x[:, 2] + 0.3 * rng.normal(size=400)
         ).astype(np.float32)
    loss = make_loss("rmse")
    out = {}
    for name, options in FIT_SCAN_FITS.items():
        params = boosting.BoostingParams(n_trees=8, depth=3, max_bins=16,
                                         seed=3, **options)
        t0 = time.perf_counter()
        a, ha = boosting.fit_scan(x, y, loss=loss, params=params,
                                  device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        b, hb = boosting.fit_scan(x, y, loss=loss, params=params,
                                  device="cuda")
        for f in ("split_features", "split_bins", "leaf_values",
                  "base_score"):
            check(torch.equal(getattr(a, f), getattr(b, f)),
                  f"fit_scan {name}: two runs give different {f}")
        check(np.array_equal(ha["train_loss"], hb["train_loss"]),
              f"fit_scan {name}: two runs give different losses")
        e, he = boosting.fit(x, y, loss=loss, params=params, device="cuda")
        for f in ("split_features", "split_bins"):
            check(torch.equal(getattr(a, f), getattr(e, f)),
                  f"fit_scan {name}: {f} differ from fit's")
        leaf_err = float((a.leaf_values - e.leaf_values).abs().max())
        loss_err = float(np.abs(ha["train_loss"] - he["train_loss"]).max())
        check(bool(np.allclose(a.leaf_values.numpy(), e.leaf_values.numpy(),
                               rtol=1e-4, atol=1e-4))
              and bool(np.allclose(ha["train_loss"], he["train_loss"],
                                   rtol=1e-4, atol=1e-4)),
              f"fit_scan {name}: leaf values ({leaf_err}) or losses "
              f"({loss_err}) outside 1e-4 of fit's")
        out[name] = {"seconds": secs, "leaf_max_abs_vs_fit": leaf_err,
                     "loss_max_abs_vs_fit": loss_err,
                     "final_loss": float(ha["train_loss"][-1])}
    return out


# --------------------------------------------------------------------------
# The split step on exact ties, and the telemetry slice
# --------------------------------------------------------------------------
SPLIT_SEEDS = (7, 8, 9)     # the tie scenario's seeds, plain and ordered


def split_scenario():
    """600 x 9 rows with a rounded and a NaN-holed column, LogLoss labels:
    levels 4-5 of its trees repeat earlier splits, so gains tie exactly."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(600, 9)).astype(np.float32)
    x[:, 3] = np.round(x[:, 3])
    x[rng.random(600) < 0.05, 2] = np.nan
    y = (x[:, 0] - 2 * x[:, 1] + 0.5 * np.nan_to_num(x[:, 2]) * x[:, 3]
         > 0).astype(np.float32)
    return x, y


def same_bits(a, b) -> bool:
    """Equal bit for bit, a NaN equal to any NaN: the card's division
    gives 0x7fffffff where the CPU's gives 0xffc00000."""
    import torch
    a, b = a.cpu(), b.cpu()
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def held_split(what: str, args, kw) -> tuple:
    """The split kernel on one level against the plain version on CPU
    copies: the (F, B) masked gains, f*, b* and the refined leaf ids must
    have the same bits.  Returns the kernel's (f*, b*, leaf ids)."""
    from repro_torch.kernels import split_level as split_k
    got = split_k.split_level(*args, **kw, return_gains=True)
    want = split_k.split_level_plain(*(a.cpu() for a in args), **kw,
                                     return_gains=True)
    for name, w, g in zip(("f*", "b*", "leaf ids", "masked gains"), want,
                          got):
        check(same_bits(w, g), f"split_level {what}: the kernel's {name} "
              "differ from the plain version's")
    return got[:3]


def split_kernel_ms(fn, reps: int = 10) -> dict:
    """Mean device ms of each split kernel over `reps` calls of `fn`, as
    `torch.profiler` sees them ({} where it sees no device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in ("split_terms", "split_choose", "split_refine"):
            if name in e.key:
                out[name] = out.get(name, 0.0) \
                    + e.device_time_total / reps / 1e3
    return out


SPLIT_COV_BORDERS = 128     # the benchmark's Covertype levels: 129 bins
SPLIT_WIDE_BORDERS = 300    # int32 bins past 255 borders
SPLIT_TIMED = 20            # calls timed a level


def check_splits(data) -> dict:
    """The split step on the card gives the CPU's bits.  The tie
    scenario's level histograms, made in f32 by the CPU trainer (8 trees
    of depth 6 at 32 bins, seeds 7-9, plain and ordered), go through
    `split_sums.level_gains` and `_split_level` (the kernel) on the card
    and through the plain version on the CPU: gains (bit for bit), the
    mass test, f*, b*, the refined leaf ids and the kernel's masked gains
    must be identical.  Then the kernel against the plain version on the
    benchmark's Covertype levels (128 borders, 129 bins, 7 classes, the
    histograms of a tree grown by the kernel, d = 0..7: in-order and
    window plans), with an rsm mask, with every border masked, and on
    int32 bins at 301 bins; each Covertype level timed, the kernel
    (`device_ms`: the kernels alone; `call_ms`: the call's window) beside
    the plain version on the card (`plain_ms`), L2 warm as the trainer
    leaves it."""
    import torch
    from repro_torch.core import boosting, losses, quantize, split_sums
    from repro_torch.core.losses import MultiClass
    from repro_torch.kernels import ref
    from repro_torch.kernels import split_level as split_k
    from repro_torch.training import gbdt
    x, y = split_scenario()
    borders, n_borders = quantize.compute_borders(x, 32)
    pool = quantize.quantize_pool(x, borders)
    calls, real = [], gbdt._split_level

    def recording(hist, valid, bins_t, leaf, **kw):
        calls.append((hist, valid, bins_t, leaf, kw))
        return real(hist, valid, bins_t, leaf, **kw)

    gbdt._split_level = recording
    try:
        for seed in SPLIT_SEEDS:
            for ordered in (False, True):
                gbdt.GBDTTrainer(
                    losses.make_loss("logloss"), boosting.BoostingParams(
                        n_trees=8, depth=6, max_bins=32, seed=seed,
                        learning_rate=0.3, ordered=ordered),
                    device="cpu").fit_pool(pool, y, borders=borders,
                                           n_borders=n_borders)
    finally:
        gbdt._split_level = real
    t0 = time.perf_counter()
    for hist, valid, bins_t, leaf, kw in calls:
        n_feat, segs, c2 = hist.shape
        h4 = hist.view(n_feat, segs // kw["n_bins"], kw["n_bins"], c2)
        gain, mass = split_sums.level_gains(h4, kw["l2"])
        gain_c, mass_c = split_sums.level_gains(h4.cuda(), kw["l2"])
        check(torch.equal(gain.view(torch.int32),
                          gain_c.cpu().view(torch.int32))
              and torch.equal(mass, mass_c.cpu()),
              f"split gains at level {kw['d']} differ between the card "
              "and the CPU")
        want = real(hist, valid, bins_t, leaf, **kw)
        got = real(hist.cuda(), valid.cuda(), bins_t.cuda(), leaf.cuda(),
                   **kw)
        check(all(torch.equal(a, b.cpu()) for a, b in zip(want, got)),
              f"_split_level at level {kw['d']} picks differently on the "
              f"card: {[int(v) for v in got[:2]]} vs "
              f"{[int(v) for v in want[:2]]}")
        held_split(f"on the tie scenario at level {kw['d']}",
                   (hist.cuda(), valid.cuda(), bins_t.cuda(), leaf.cuda()),
                   kw)
    torch.cuda.synchronize()
    ties_s = time.perf_counter() - t0

    # the benchmark's Covertype levels, grown by the kernel's own splits
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cov_borders, cov_nb = quantize.compute_borders(data.x_train,
                                                   SPLIT_COV_BORDERS)
    x_dev = torch.as_tensor(data.x_train, device=dev)
    bins_t = quantize.quantize_pool(x_dev, torch.as_tensor(
        cov_borders).to(dev)).bins.t().contiguous()
    n_bins = SPLIT_COV_BORDERS + 1
    n_feat, n = bins_t.shape
    b = torch.arange(n_bins, device=dev)
    valid = (b[None, :] >= 1) & (b[None, :] <= torch.as_tensor(
        cov_nb).to(dev)[:, None])
    loss = MultiClass(n_classes=data.n_classes)
    yt = torch.as_tensor(data.y_train, device=dev)
    gh = gbdt._grad_stack(loss.init_raw(yt), yt, loss=loss)
    l2 = boosting.BoostingParams().l2_reg
    leaf = torch.zeros((n,), dtype=torch.int32, device=dev)
    flush = torch.empty((1,), dtype=torch.uint8, device=dev)
    levels, sums_plans = [], []
    for d in range(8):
        hist = ref.histogram_fixed(bins_t, leaf, gh, n_bins=n_bins,
                                   n_leaves=1 << d)
        kw = dict(n_bins=n_bins, d=d, l2=l2)
        args = (hist, valid, bins_t, leaf)
        f_star, b_star, new_leaf = held_split(f"at Covertype level {d}",
                                              args, kw)
        kernel_ms, profiled_ms = device_ms(
            lambda: split_k.split_level(*args, **kw), flush,
            reps=SPLIT_TIMED, key="split_")
        levels.append({
            "d": d, "split": [int(f_star), int(b_star)],
            "device_ms": kernel_ms, "profiled_ms": profiled_ms,
            "kernels_ms": split_kernel_ms(
                lambda: split_k.split_level(*args, **kw)),
            "call_ms": time_ms(lambda: split_k.split_level(*args, **kw),
                               SPLIT_TIMED, flush),
            "plain_ms": time_ms(lambda: split_k.split_level_plain(
                *args, **kw), SPLIT_TIMED, flush),
            "plan": dataclasses.asdict(split_sums.leaf_sum_plan(
                1 << d, n_bins, data.n_classes))})
        sums_plans.append(levels[-1]["plan"]["windows"])
        if d == 3:
            # an rsm mask (half the features), then every border masked
            keep = torch.zeros(n_feat, dtype=torch.bool)
            keep[torch.randperm(n_feat, generator=torch.Generator()
                                .manual_seed(d))[:n_feat // 2]] = True
            held_split("with an rsm mask", (hist, valid & keep.to(dev)[:, None],
                                            bins_t, leaf), kw)
            got = held_split("with every border masked",
                             (hist, torch.zeros_like(valid), bins_t, leaf),
                             kw)
            check([int(v) for v in got[:2]] == [0, 0],
                  "split_level: an all-masked level did not pick (0, 0)")
        leaf = new_leaf
    check(sums_plans[6:] == [1, 1], f"split_level: Covertype's 64 and 128 "
          f"leaves took window rounds {sums_plans[6:]}")
    cov_s = time.perf_counter() - t0

    # int32 bins past 255 borders (301 bins: the scan's block totals past
    # 16 blocks), at level 3
    # (quantile borders of each column; `compute_borders` stops at 255)
    wide_borders = np.nanquantile(data.x_train, np.linspace(
        0.0, 1.0, SPLIT_WIDE_BORDERS + 2)[1:-1], axis=0)
    wide_borders = np.ascontiguousarray(wide_borders, dtype=np.float32)
    wide_nb = np.full(n_feat, SPLIT_WIDE_BORDERS, np.int32)
    wide = quantize.binarize_matrix(x_dev, torch.as_tensor(
        wide_borders).to(dev)).t().contiguous()
    check(wide.dtype == torch.int32, f"bins past 255 borders are {wide.dtype}")
    wide_bins = SPLIT_WIDE_BORDERS + 1
    b = torch.arange(wide_bins, device=dev)
    wide_valid = (b[None, :] >= 1) & (b[None, :] <= torch.as_tensor(
        wide_nb).to(dev)[:, None])
    leaf3 = torch.randint(0, 8, (n,), dtype=torch.int32, device=dev,
                          generator=torch.Generator(dev).manual_seed(3))
    held_split("on int32 bins at 301 bins", (
        ref.histogram_fixed(wide, leaf3, gh, n_bins=wide_bins, n_leaves=8),
        wide_valid, wide, leaf3), dict(n_bins=wide_bins, d=3, l2=l2))
    torch.cuda.synchronize()
    return {"fits": 2 * len(SPLIT_SEEDS), "levels": len(calls),
            "card_seconds": ties_s, "covertype_seconds": cov_s,
            "covertype_levels": levels,
            "tree_device_ms": sum(lv["device_ms"] for lv in levels),
            "tree_call_ms": sum(lv["call_ms"] for lv in levels),
            "tree_plain_ms": sum(lv["plain_ms"] for lv in levels)}


TELEMETRY_TREES = 10     # trees of the traced fit
TELEMETRY_REPEATS = 50   # predict_batch calls timed with tracing off and on
TELEMETRY_CHUNK = 65536  # bulk chunk rows: the prefetch worker's route
SPAN_ARGS = {"dispatch/": {"op", "impl", "layout", "dtype", "shapes",
                           "device_ms"},
             "train/level": {"iteration", "level", "leaves", "hist_ms",
                             "split_ms", "device_ms"},
             "train/iteration": {"iteration", "rows", "hist_ms", "split_ms",
                                 "leaf_ms", "loss", "device_ms"},
             "serve/batch": {"model", "rows", "device_ms"},
             "plan/h2d": {"rows", "bytes", "pinned", "device_ms"},
             "trainer/split": {"iteration", "level"},
             "trainer/sync": {"iteration"},
             "bulk/quantize": {"chunk", "rows", "padded"},
             "bulk/score": {"chunk", "rows", "padded", "models",
                            "device_ms"},
             "bulk/sink": {"chunk", "rows"},
             "compile/": {"entry", "layout", "batch"}}


def check_trace_schema(obj: dict) -> Counter:
    """The exported Chrome JSON against its schema; the count of each
    event name."""
    check(set(obj) == {"traceEvents", "displayTimeUnit", "otherData"}
          and obj["otherData"]["dropped_events"] == 0,
          f"trace header {sorted(obj)} / {obj.get('otherData')}")
    names = Counter()
    for e in obj["traceEvents"]:
        ph = e["ph"]
        check(ph in ("X", "i", "C", "M") and e["pid"] == 1
              and isinstance(e["tid"], int) and isinstance(e["name"], str)
              and isinstance(e["args"], dict), f"trace event {e}")
        names[e["name"]] += 1
        if ph == "M":
            check(e["name"] == "thread_name" and "name" in e["args"],
                  f"metadata row {e}")
            continue
        check(isinstance(e["ts"], float) and e["ts"] >= 0,
              f"event time {e}")
        if ph == "X":
            check(isinstance(e["dur"], float) and e["dur"] >= 0,
                  f"span duration {e}")
            want = next((v for k, v in SPAN_ARGS.items()
                         if e["name"].startswith(k)), set())
            check(want <= set(e["args"]),
                  f"{e['name']} lacks {sorted(want - set(e['args']))}")
            if "device_ms" in e["args"]:
                check(e["args"]["device_ms"] >= 0, f"device time {e}")
        elif ph == "i":
            check(e["s"] == "t" and SPAN_ARGS["compile/"] <= set(e["args"]),
                  f"instant {e}")
        else:
            check(all(isinstance(v, float) for v in e["args"].values()),
                  f"counter {e}")
    return names


def run_telemetry(data, full, params, tmp: str) -> dict:
    """The traced main path on the Covertype model: a 10-tree fit, a
    GBDTServer on soa and a bulk run with the prefetch worker, under the
    tracer, each against the same run untraced (bit for bit).  The fit
    makes one `torch.cuda.synchronize` a tree (counted) and the export
    one more; each level's device time is within its iteration's; a
    `trainer/split` span a level and a `trainer/sync` a tree; the
    `dispatch/<op>` spans equal the registry's counts and the kernels'
    launches; each served batch's rows are one `plan/h2d` copy; the
    exported JSON holds to its schema.  `predict_batch` p50 with tracing
    off and on."""
    import torch
    from repro_torch.core import quantize
    from repro_torch.core.losses import MultiClass
    from repro_torch.core.predictor import Predictor
    from repro_torch.kernels import ops, registry
    from repro_torch.kernels.split_level import KERNELS_A_LEVEL
    from repro_torch.obs.trace import get_tracer, tracing
    from repro_torch.scoring import (ArraySink, BulkScorer, ScoreConfig,
                                     SyntheticSource)
    from repro_torch.serving.engine import GBDTServer
    from repro_torch.training.gbdt import GBDTTrainer

    tracer = get_tracer()
    p = dataclasses.replace(params, n_trees=TELEMETRY_TREES)
    pool = quantize.quantize_pool(data.x_train, full.borders.cuda())

    def fit():
        return GBDTTrainer(MultiClass(n_classes=data.n_classes), p,
                           device="cuda").fit_pool(
            pool, data.y_train, borders=full.borders,
            n_borders=full.n_borders)

    server = GBDTServer(full, device="cuda", layout="soa",
                        max_batch=MAX_BATCH)
    xs = data.x_test[:MAX_BATCH]
    plan = Predictor.build(full, device="cuda", layout="soa")
    source = SyntheticSource("covertype", split="test")
    cfg = ScoreConfig(chunk_rows=TELEMETRY_CHUNK, output="proba")

    def bulk():
        res = BulkScorer({"m": plan}, cfg).score(source, {"m": ArraySink()})
        return res.outputs["m"], res.metrics

    t0 = time.perf_counter()
    plain, plain_hist = fit()
    plain_s = time.perf_counter() - t0
    served = server.predict_batch(xs)
    scored, _ = bulk()

    syncs = []
    real_sync = torch.cuda.synchronize

    def counted_sync(*args, **kwargs):
        syncs.append(time.perf_counter())
        return real_sync(*args, **kwargs)

    launches0 = ops.launch_counts()
    registry.reset_call_stats()
    torch.cuda.synchronize = counted_sync
    try:
        with tracing(tracer, clear=True):
            t0 = time.perf_counter()
            traced, traced_hist = fit()
            traced_s = time.perf_counter() - t0
            fit_syncs = len(syncs)
            served_t = server.predict_batch(xs)
            scored_t, bulk_metrics = bulk()
            path = os.path.join(tmp, "telemetry.json")
            before_export = len(syncs)
            t0 = time.perf_counter()
            obj = tracer.export_chrome(path)
            export_s = time.perf_counter() - t0
            export_syncs = len(syncs) - before_export
    finally:
        torch.cuda.synchronize = real_sync
    launched = {k: v - launches0[k] for k, v in ops.launch_counts().items()}
    calls = registry.call_stats()

    for f in ("split_features", "split_bins", "leaf_values", "base_score"):
        check(torch.equal(getattr(plain, f), getattr(traced, f)),
              f"telemetry: the traced fit's {f} differ from the untraced")
    check(np.array_equal(plain_hist["final_raw"], traced_hist["final_raw"])
          and np.array_equal(plain_hist["train_loss"],
                             traced_hist["train_loss"]),
          "telemetry: the traced fit's losses or raw scores differ")
    check(np.array_equal(served, served_t),
          "telemetry: traced predict_batch differs from untraced")
    check(np.array_equal(scored, scored_t),
          "telemetry: the traced bulk run differs from the untraced")
    check(fit_syncs == TELEMETRY_TREES,
          f"telemetry: the traced {TELEMETRY_TREES}-tree fit called "
          f"torch.cuda.synchronize {fit_syncs} times (one a tree)")
    check(export_syncs == 1,
          f"telemetry: the export synchronized {export_syncs} times")
    check(bulk_metrics["prefetch_depth"] > 0,
          "telemetry: the bulk run took no prefetch worker")

    names = check_trace_schema(json.loads(open(path).read()))
    check(names["train/level"] == TELEMETRY_TREES * params.depth
          and names["train/iteration"] == TELEMETRY_TREES,
          f"telemetry: {names['train/level']} train/level and "
          f"{names['train/iteration']} train/iteration events")
    events = [e for e in obj["traceEvents"] if e["ph"] != "M"]
    iters = {e["args"]["iteration"]: e["args"]["device_ms"] for e in events
             if e["name"] == "train/iteration"}
    levels = [e["args"] for e in events if e["name"] == "train/level"]
    check(all(lv["device_ms"] <= iters[lv["iteration"]] for lv in levels),
          "telemetry: a level's device time exceeds its iteration's")
    threads = {e["tid"]: e["args"]["name"] for e in obj["traceEvents"]
               if e["ph"] == "M"}
    q_tids = {e["tid"] for e in events if e["name"] == "bulk/quantize"}
    s_tids = {e["tid"] for e in events if e["name"] == "bulk/score"}
    check(q_tids and s_tids and not q_tids & s_tids
          and {threads[t] for t in q_tids} == {"prefetcher"},
          f"telemetry: bulk/quantize on {q_tids}, bulk/score on {s_tids}")
    check(names["serve/batch"] > 0 and names["bulk/sink"] > 0
          and any(n.startswith("compile/") for n in names),
          f"telemetry: spans {dict(names)}")
    check(names["trainer/split"] == TELEMETRY_TREES * params.depth
          and names["trainer/sync"] == TELEMETRY_TREES,
          f"telemetry: {names['trainer/split']} trainer/split and "
          f"{names['trainer/sync']} trainer/sync spans")
    split_spans = [e["args"] for e in events
                   if e["name"] == "dispatch/split_level"]
    check(len(split_spans) == TELEMETRY_TREES * params.depth
          and all(a["launches"] == KERNELS_A_LEVEL for a in split_spans),
          f"telemetry: {len(split_spans)} dispatch/split_level spans for "
          f"{TELEMETRY_TREES} trees of depth {params.depth}, launches "
          f"{sorted({a.get('launches') for a in split_spans})}")
    check(names["plan/h2d"] == names["serve/batch"],
          f"telemetry: {names['plan/h2d']} plan/h2d spans for "
          f"{names['serve/batch']} served batches")
    counts = Counter(e["args"]["op"] for e in events
                     if e["name"].startswith("dispatch/"))
    check(counts == Counter(calls),
          f"telemetry: dispatch spans {dict(counts)} vs the registry's "
          f"{calls}")
    check(all(launched[op] == n for op, n in calls.items())
          and sum(launched.values()) == sum(calls.values()),
          f"telemetry: dispatches {calls} vs launches {launched}")
    dispatch_ms = Counter()
    for e in events:
        if e["name"].startswith("dispatch/"):
            dispatch_ms[e["args"]["op"]] += e["args"]["device_ms"]

    def p50_ms(on: bool) -> tuple[float, float]:
        times = []
        with tracing(tracer, clear=True) if on else contextlib.nullcontext():
            for _ in range(TELEMETRY_REPEATS):
                t0 = time.perf_counter()
                server.predict_batch(xs)
                times.append((time.perf_counter() - t0) * 1e3)
            per_batch = sum(1 for e in tracer.events()
                            if e["name"].startswith("dispatch/")) \
                / TELEMETRY_REPEATS if on else 0
        return float(np.median(times)), per_batch

    off_ms, _ = p50_ms(False)
    on_ms, dispatches = p50_ms(True)
    off2_ms, _ = p50_ms(False)
    tracer.clear()
    return {"fit_untraced_s": plain_s, "fit_traced_s": traced_s,
            "fit_syncs": fit_syncs, "export_syncs": export_syncs,
            "export_s": export_s, "events": len(events),
            "trace_bytes": os.path.getsize(path),
            "span_counts": {k: v for k, v in sorted(names.items())},
            "dispatch_device_ms": dict(dispatch_ms),
            "train_level_device_ms_p50": float(np.median(
                [lv["device_ms"] for lv in levels])),
            "train_iteration_device_ms_p50": float(np.median(
                list(iters.values()))),
            "predict_batch_rows": len(xs),
            "predict_batch_p50_ms_off": off_ms,
            "predict_batch_p50_ms_on": on_ms,
            "predict_batch_p50_ms_off_again": off2_ms,
            "dispatches_per_batch": dispatches,
            "traced_cost_ms_per_dispatch": (on_ms - (off_ms + off2_ms) / 2)
            / max(dispatches, 1)}


# --------------------------------------------------------------------------
# The launchers and the examples, each in a process of its own
# --------------------------------------------------------------------------
# What `python3 chip_smoke.py --launcher NAME` runs: a module's or a
# script's `main` and its arguments, at the JAX package's own sizes (the
# examples' defaults).
def obs_flags(name: str) -> tuple[str, ...]:
    """`--trace-out` / `--metrics-out` (Prometheus) under build/obs/."""
    return ("--trace-out", f"build/obs/{name}.json",
            "--metrics-out", f"build/obs/{name}.prom")


LAUNCHERS = {
    "score_cli": ("repro_torch.launch.score", (
        "--dataset", "covertype", "--scale", "0.05", "--models", "2",
        "--check", *obs_flags("score_cli"))),
    "train_gbdt": ("repro_torch.launch.train_gbdt", (
        "--dataset", "covertype", "--scale", "0.01", "--repeat", "4",
        "--trees", "20", "--rsm", "0.5", "--ordered", "--check",
        *obs_flags("train_gbdt"))),
    "serve": ("repro_torch.launch.serve", ("--trees", "30", "--multi", "3",
                                           *obs_flags("serve"))),
    "show_kernels": ("repro_torch.launch.serve", ("--show-kernels",)),
    "quickstart": ("examples/torch/quickstart.py", ()),
    "serve_gbdt": ("examples/torch/serve_gbdt.py", ()),
    "embeddings_knn": ("examples/torch/embeddings_knn.py", ()),
    # the lm phase's (`run_lm_phase`)
    "serve_lm_glm4": ("repro_torch.launch.serve", ("--mode", "lm", "--arch",
                                                   "glm4-9b")),
    "serve_lm_whisper": ("repro_torch.launch.serve", (
        "--mode", "lm", "--arch", "whisper-small")),
    # the lm_train phase's (`run_lm_train_phase`), each with a checkpoint
    # directory of its own that the phase empties first
    "train_lm": ("repro_torch.launch.train", (
        "--steps", "4", "--ckpt-dir", "build/lm_train/launcher")),
    "train_lm_example": ("examples/torch/train_lm.py", (
        "--steps", "20", "--ckpt-dir", "build/lm_train/example")),
}
LAUNCHER_WORKERS = 3     # processes at a time
# the spans and the metric-name prefix each traced launcher's files hold
OBS_OUTPUTS = {
    "score_cli": ({"bulk/quantize", "bulk/score", "bulk/sink",
                   "dispatch/binarize", "dispatch/leaf_index",
                   "train/level"}, ("repro_scoring_bulk_",)),
    "train_gbdt": ({"train/level", "train/iteration", "dispatch/histogram",
                    "dispatch/binarize", "compile/raw_pool"},
                   ("repro_training_gbdt_covertype_",)),
    "serve": ({"serve/batch", "train/level", "dispatch/fused_predict"},
              ("repro_serving_santander_",)),
}
PLAIN_CHECKS = 2         # launches of a kernel at one input shape held to
#                          its plain version in a launcher's process
QUICKSTART_DEVIATION = 1e-4   # examples/torch/quickstart.py's MISMATCH


def plain_versions() -> dict:
    """Kernel -> (its plain version, its limit or None where it must be
    exact), each taking the launch's arguments and keywords on the CPU:
    `leaf_gather` and `fused_predict` sum floats in another order
    (`sum_limit`), the distance kernels obey the distance rule, the
    histogram equals the plain fixed-point version, the split search its
    plain version (f*, b* and the leaf ids)."""
    import torch
    from repro_torch.kernels import l2dist, ref
    from repro_torch.kernels.split_level import split_level_plain

    def fused_limit(a, kw):
        x, borders, sf, sb, lv = a
        return sum_limit(ref.leaf_index(ref.binarize(x, borders), sf, sb), lv)

    return {
        "binarize": (lambda a, kw: (
            ref.binarize_u8 if kw.get("out_dtype") == torch.uint8
            else ref.binarize)(*a), None),
        "leaf_index": (lambda a, kw: ref.leaf_index(*a), None),
        "histogram": (lambda a, kw: ref.histogram_fixed(*a, **kw), None),
        "split_level": (lambda a, kw: split_level_plain(*a, **kw), None),
        "leaf_gather": (lambda a, kw: ref.leaf_gather(*a),
                        lambda a, kw: sum_limit(*a)),
        "fused_predict": (lambda a, kw: ref.fused_predict(*a), fused_limit),
        "l2sq_matrix": (lambda a, kw: ref.l2sq_matrix(*a),
                        lambda a, kw: l2dist.matrix_limit(*a)),
        "l2sq_rowwise": (lambda a, kw: ref.l2sq_rowwise(*a),
                         lambda a, kw: l2dist.rowwise_limit(*a)),
    }


PLAIN_KEYWORDS = ("out_dtype", "n_bins", "n_leaves", "d", "l2")   # the
# rest pick routes


def held_to_plain(name: str, fn, plain, report: dict, failures: list):
    """`fn`, a kernel's wrapper, whose first PLAIN_CHECKS launches at each
    input shape are held to `plain` on CPU copies of their inputs; the
    outcome goes into `report[name]` and any miss into `failures` (a
    launch may come from a server's thread, so nothing raises here)."""
    import threading

    import torch
    want_fn, limit_fn = plain
    seen: dict = {}
    lock = threading.Lock()

    def wrapper(*args, **kw):
        result = fn(*args, **kw)
        # the split search returns (f*, b*, leaf ids): held together
        outs = result if isinstance(result, tuple) else (result,)
        got = outs[-1]
        if got.device.type != "cuda" or not got.numel():
            return result
        kw = {k: v for k, v in kw.items() if k in PLAIN_KEYWORDS}
        key = (tuple((tuple(a.shape), str(a.dtype)) if torch.is_tensor(a)
                     else a for a in args), tuple(sorted(kw.items())))
        with lock:
            if seen.get(key, 0) >= PLAIN_CHECKS:
                return result
            seen[key] = seen.get(key, 0) + 1
        cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
        want, got_cpu = want_fn(cpu, kw), got.cpu()
        if isinstance(result, tuple):
            wants = want
            want = want[-1]
        if limit_fn is None:
            exact = torch_equal(got_cpu, want) and (
                not isinstance(result, tuple) or all(
                    torch_equal(g, w) for g, w in zip(outs, wants)))
            err, share = (0.0, 0.0) if exact else (
                float((got_cpu.double() - want.double()).abs().max()),
                math.inf)
        else:
            diff = (got_cpu.double() - want.double()).abs()
            err, share = float(diff.max()), over_limit(diff,
                                                       limit_fn(cpu, kw))
        with lock:
            rec = report.setdefault(name, {"checked": 0, "shapes": 0,
                                           "max_abs_err": 0.0,
                                           "worst_over_limit": 0.0})
            rec["checked"] += 1
            rec["shapes"] = len(seen)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["worst_over_limit"] = max(rec["worst_over_limit"], share)
            if share > 1.0:
                shapes = ", ".join(
                    "x".join(map(str, a.shape)) + f" {a.dtype}"
                    if torch.is_tensor(a) else str(a) for a in args)
                failures.append(f"{name}({shapes}; {kw}) differs from its "
                                f"plain version by {err}, {share:.3g} times "
                                "its limit")
        return result

    return wrapper


def run_launcher(name: str) -> None:
    """`python3 chip_smoke.py --launcher NAME`: LAUNCHERS[NAME]'s `main` in
    this process, on the card, with the launch counts set to 0 just before
    it and every kernel of `plain_versions` held to its plain version
    (`held_to_plain`).  Its last line is a JSON object with what `main`
    returned, the launch counts and the comparisons; a nonzero return,
    a comparison outside its limit, or a kernel launched but never
    compared exits 1."""
    import importlib
    import importlib.util

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device; this script measures the port on the card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import ops
    report, failures = {}, []
    for kernel, plain in plain_versions().items():
        fn = ops.KERNELS[kernel]
        wrapper = held_to_plain(kernel, fn, plain, report, failures)
        # the wrapper's own `launches += 1` now lands on `wrapper`
        setattr(sys.modules[fn.__module__], fn.__name__, wrapper)
        ops.KERNELS[kernel] = wrapper
    target, argv = LAUNCHERS[name]
    if target.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            f"launched_{name}", os.path.join(ROOT, target))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(target)
    ops.reset_launch_counts()
    result = module.main(list(argv))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(json.dumps({"launcher": name, "result": result,
                      "launches": counts, "plain": report}, default=float),
          flush=True)
    check(not isinstance(result, int) or result == 0,
          f"{name}: main returned {result}")
    check(not failures, f"{name}: " + "; ".join(failures[:5]))
    for kernel, count in counts.items():
        check(count == 0 or kernel in report,
              f"{name} launched {kernel} {count} times and none was held to "
              "its plain version")


def launch_process(name: str):
    """LAUNCHERS[name] in a process of its own (`run_launcher`)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--launcher",
         name], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    return name, proc, time.perf_counter() - t0


def read_launcher(name: str, proc, secs: float):
    """Print a launcher process's last lines; it must have exited 0 and
    launched exactly PATH_KERNELS[name].  Returns its record and the
    launcher's own stdout lines."""
    lines = proc.stdout.strip().splitlines()
    for line in lines[-7:-1]:
        print(f"  {name}: {line[:400]}")
    for line in proc.stderr.strip().splitlines()[-3:]:
        print(f"  {name} stderr: {line[:400]}")
    check(proc.returncode == 0, f"chip_smoke.py --launcher {name} ("
          f"{' '.join(LAUNCHERS[name][1])}) exited {proc.returncode}")
    report = json.loads(lines[-1])
    counts = report["launches"]
    print(f"{name} launches: {counts}", flush=True)
    obs = read_obs_outputs(name) if name in OBS_OUTPUTS else None
    for kernel, count in counts.items():
        check((count > 0) == (kernel in PATH_KERNELS[name]),
              f"the {name} process launched {kernel} {count} times; it "
              f"launches exactly {sorted(PATH_KERNELS[name])}")
    out = {"wall_s": secs, "args": " ".join(LAUNCHERS[name][1]),
           "launches": {k: c for k, c in counts.items() if c},
           "plain": report["plain"], "result": report["result"]}
    if obs is not None:
        out["obs"] = obs
    return out, lines[:-1]


def read_obs_outputs(name: str) -> dict:
    """A traced launcher's `--trace-out` and `--metrics-out` files: a
    Chrome trace that holds to its schema with the launcher's spans, and
    Prometheus gauges in the launcher's namespace."""
    spans, prefixes = OBS_OUTPUTS[name]
    trace_path, prom_path = (os.path.join(ROOT, f"build/obs/{name}.{ext}")
                             for ext in ("json", "prom"))
    check(os.path.getsize(trace_path) > 0 and os.path.getsize(prom_path)
          > 0, f"{name} wrote an empty trace or metrics file")
    names = check_trace_schema(json.loads(open(trace_path).read()))
    check(spans <= set(names),
          f"{name}'s trace lacks {sorted(spans - set(names))}")
    gauges = [line.split("{")[0].split()[0]
              for line in open(prom_path).read().splitlines()
              if line and not line.startswith("#")]
    check(gauges and all(g.startswith(prefixes) for g in gauges),
          f"{name}'s metrics {gauges[:5]} are not under {prefixes}")
    return {"events": sum(names.values()), "gauges": len(gauges),
            "trace_bytes": os.path.getsize(trace_path)}


def run_launchers() -> dict:
    """Every launcher and example of LAUNCHERS but the scoring CLI, each in
    a process of its own, LAUNCHER_WORKERS at a time (so each wall time
    holds the others' contention and the plain comparisons).  Besides
    `read_launcher`'s checks: quickstart's strategies agree and its float
    and pool predictions are equal; serve_gbdt answers every request."""
    names = [name for name in LAUNCHERS if name != "score_cli"
             and name not in LM_LAUNCHERS + LM_TRAIN_LAUNCHERS]
    with ThreadPoolExecutor(LAUNCHER_WORKERS) as workers:
        results = list(workers.map(launch_process, names))
    out = {}
    for name, proc, secs in results:
        out[name], lines = read_launcher(name, proc, secs)
        out[name]["concurrent_wall_s"] = out[name].pop("wall_s")
        result = out[name].pop("result")
        if name == "train_gbdt":
            metrics = json.loads("\n".join(lines[next(
                i for i, line in enumerate(lines) if line == "{"):]))
            out[name]["metrics"] = {k: metrics[k] for k in (
                "rows", "n_chunks", "trees", "train_s", "serve_rows_per_s",
                "final_metric", "serve_parity_max_abs", "dispatch_delta")}
        elif isinstance(result, dict):
            out[name]["result"] = result
        if name == "quickstart":
            check(result["staged_vs_fused"] < QUICKSTART_DEVIATION
                  and result["float_equals_pool"],
                  f"quickstart: staged vs fused {result['staged_vs_fused']},"
                  f" float == pool {result['float_equals_pool']}")
        if name == "serve_gbdt":
            check(result["answered"] == result["requests"],
                  f"serve_gbdt answered {result['answered']} of "
                  f"{result['requests']} requests")
    return out


# --------------------------------------------------------------------------
# The kNN path: embeddings -> kNN features -> GBDT head
# --------------------------------------------------------------------------
KNN_K = 16              # neighbours (examples/embeddings_knn.py): 21 features
KNN_BULK_SCALE = 8      # image_embeddings(scale=8): 22,464 references
KNN_BULK_QUERIES = 4096  # KNNFeaturizer.transform's default chunk
KNN_SMALL_ROWS = 17     # a ragged row count for the C = 20 fused kernel
KNN_PREDICT_REPEATS = 3  # pipeline calls timed after the path's own
# The matrix kernel's ragged shapes (M, N, K, rows of `a` skipped at the
# start of its buffer): one tile, K = 90 and 533, a slice one row in
# (4-byte aligned rows), a partial tile on both sides, one column.
MATRIX_RAGGED = ((64, 128, 32, 0), (37, 61, 90, 0), (50, 300, 533, 1),
                 (300, 257, 256, 0), (129, 1, 7, 1))
# The rowwise kernel's ragged shapes (N, K, floats the refs start into
# their buffer): K % 4 != 0, a slice one row in at K = 533, K = 1, N = 1,
# N not a multiple of a block's rows, K % 4 == 0 one float in (rows not
# 16-byte aligned: the scalar route), the walk route (K > 1,024), K past
# the old shared-memory cap of 57,856, and N past one wave of warps (the
# blocks stride over the rows) at J = 4, 2, 1 and on the walk route.
ROWWISE_RAGGED = ((37, 90, 0), (300, 533, 533), (64, 1, 0), (1, 512, 0),
                  (2807, 512, 0), (300, 512, 1), (1000, 1028, 0),
                  (5, 60_000, 0), (7000, 512, 0), (7000, 256, 0),
                  (13000, 128, 0), (4000, 1028, 0))
LANES_CHUNK = 64        # test queries a ref.l2sq_rowwise_lanes call


def run_knn_path(data):
    """The paper's image-embeddings workload through the port's entry
    points, on the card: featurize the train split (matrix kernel) and the
    test split (matrix kernel, then the rowwise kernel one query at a
    time: one `l2sq` dispatch and one launch a query, counted), train the
    N_TREES-tree MultiClass head on the 533 augmented columns with
    `boosting.fit`, and classify the test split with
    `EmbeddingGBDTPipeline.predict`.  Returns what the checks read and the
    wall seconds of each phase."""
    import torch
    from repro_torch.core import boosting
    from repro_torch.core.knn import KNNFeaturizer, augment_with_knn
    from repro_torch.core.losses import MultiClass
    from repro_torch.kernels import l2dist, registry
    from repro_torch.serving.engine import EmbeddingGBDTPipeline

    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    feat = KNNFeaturizer(data.emb_train, data.y_train, data.n_classes,
                         k=KNN_K, device="cuda")
    x_train = timed("featurize_train", lambda: augment_with_knn(
        data.x_train, data.emb_train, feat))
    feats = timed("featurize_test", lambda: feat.transform(data.emb_test))
    dispatched = registry.call_stats().get("l2sq", 0)
    launched = l2dist.l2sq_rowwise.launches
    feats_rw = timed("featurize_test_rowwise", lambda: feat.transform(
        data.emb_test, rowwise=True))
    rowwise_counts = {
        "queries": len(data.emb_test),
        "dispatches": registry.call_stats()["l2sq"] - dispatched,
        "launches": l2dist.l2sq_rowwise.launches - launched}
    check(rowwise_counts["dispatches"] == rowwise_counts["launches"]
          == len(data.emb_test),
          f"a rowwise transform of {len(data.emb_test)} queries made "
          f"{rowwise_counts}: one l2sq dispatch and one launch a query")
    params = dataclasses.replace(data.params, n_trees=N_TREES,
                                 max_bins=MAX_BINS, seed=SEED)
    ens, history = timed("train", lambda: boosting.fit(
        x_train, data.y_train, params=params, device="cuda",
        loss=MultiClass(n_classes=data.n_classes)))
    pipeline = EmbeddingGBDTPipeline(feat, ens)
    pred = timed("predict", lambda: pipeline.predict(data.emb_test))
    return {"feat": feat, "x_train": x_train, "feats": feats,
            "feats_rw": feats_rw, "ens": ens, "history": history,
            "params": params, "pipeline": pipeline, "pred": pred,
            "seconds": seconds, "rowwise_counts": rowwise_counts}


def feature_rule(feat, got_feats, got_d, want_d, limit, what):
    """The feature rule of PERF.md §2, on the card: a query whose plain
    distances have a gap between the k-th and (k+1)-th smallest wider than
    twice its largest limit must have the plain neighbour set, the plain
    class fractions bit for bit and a mean distance within that limit.
    `got_feats` must be the features of `got_d` exactly.  Returns the
    count of exempt queries, and of those whose neighbours or fractions
    did differ."""
    import torch
    c = feat.n_classes
    check(torch.equal(got_feats, feat._features_from_dists(got_d)),
          f"{what}: the path's features are not those of the kernel's "
          "distances")
    srt = torch.sort(want_d.double(), dim=1).values
    row_limit = limit.max(dim=1).values
    checked = srt[:, feat.k] - srt[:, feat.k - 1] > 2 * row_limit
    want = feat._features_from_dists(want_d)
    gi = feat.neighbours(got_d)[1].sort(dim=1).values
    wi = feat.neighbours(want_d)[1].sort(dim=1).values
    same_set = (gi == wi).all(dim=1)
    same_frac = (got_feats[:, :c] == want[:, :c]).all(dim=1)
    mean_ok = (got_feats[:, c].double() - want[:, c].double()).abs() \
        <= row_limit
    bad = checked & ~(same_set & same_frac & mean_ok)
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} queries outside "
          "the exemption differ from the plain features")
    return {"queries": len(checked), "exempt": int((~checked).sum()),
            "exempt_and_differ": int((~checked & ~(same_set & same_frac))
                                     .sum())}


def check_and_time_knn(data, run, flush):
    """Hold the kNN path against its plain versions on the card, then time
    the two distance kernels.  Returns (the kernels rows without their
    launch counts, the checks)."""
    import torch
    from repro_torch.core.knn import KNNFeaturizer
    from repro_torch.data.synthetic import image_embeddings
    from repro_torch.kernels import l2dist, ops, ref, tuning
    from repro_torch.kernels.fused_predict import fused_predict
    from repro_torch.serving.engine import EmbeddingGBDTPipeline

    feat = run["feat"]
    refs = feat.train_embeddings
    dev = refs.device
    c = data.n_classes
    checks, errs = {}, {"l2sq_matrix": 0.0, "l2sq_rowwise": 0.0}
    of_limit = {"l2sq_matrix": 0.0, "l2sq_rowwise": 0.0}

    def held(kernel, case, got, again, want, limit):
        """Same bits on two launches, non-negative, within the rule of the
        plain version."""
        name = f"{kernel} ({case})"
        check(torch.equal(got, again),
              f"{name} differs between two launches on the same inputs")
        check(bool((got >= 0).all()), f"{name} has a negative distance")
        err = (got.double() - want.double()).abs()
        share = float((err / limit).max())
        check(share <= 1.0, f"{name} differs from its plain version by "
              f"{float(err.max())}, {share:.3g} times its limit")
        errs[kernel] = max(errs[kernel], float(err.max()))
        of_limit[kernel] = max(of_limit[kernel], share)
        return share

    # --- the matrix kernel on both splits, the rowwise kernel on every
    # test query, and the features each route gave the path
    q_test = torch.as_tensor(data.emb_test, device=dev)
    x_train = torch.as_tensor(run["x_train"], device=dev)
    check(torch.equal(x_train[:, :refs.shape[1]], refs),
          "the augmented train pool does not start with the embeddings")
    exempt = {}
    for split, q, got_feats in (("train", refs, x_train[:, refs.shape[1]:]),
                                ("test", q_test, run["feats"])):
        got = l2dist.l2sq_matrix(q, refs)
        want = ref.l2sq_matrix(q, refs)
        limit = l2dist.matrix_limit(q, refs)
        held("l2sq_matrix", f"{split} split", got,
             l2dist.l2sq_matrix(q, refs), want, limit)
        exempt[f"matrix_{split}"] = feature_rule(
            feat, got_feats, got, want, limit, f"{split} features")
        if split == "test":
            mat, mat_limit = got, limit
        del got, want
    rw = torch.stack([l2dist.l2sq_rowwise(q, refs) for q in q_test])
    again = torch.stack([l2dist.l2sq_rowwise(q, refs) for q in q_test])
    rw_want = torch.stack([ref.l2sq_rowwise(q, refs) for q in q_test])
    rw_limit = torch.stack([l2dist.rowwise_limit(q, refs) for q in q_test])
    held("l2sq_rowwise", "every test query", rw, again, rw_want, rw_limit)
    check(all(torch.equal(rw[i:i + LANES_CHUNK], ref.l2sq_rowwise_lanes(
        q_test[i:i + LANES_CHUNK], refs))
        for i in range(0, len(q_test), LANES_CHUNK)),
        "l2sq_rowwise (every test query) is not the kernel's summation "
        "order (ref.l2sq_rowwise_lanes) bit for bit")
    rw_err = errs["l2sq_rowwise"], of_limit["l2sq_rowwise"]
    exempt["rowwise_test"] = feature_rule(
        feat, run["feats_rw"], rw, rw_want, rw_limit, "rowwise features")
    routes = (mat.double() - rw.double()).abs()
    share = float((routes / (mat_limit + rw_limit)).max())
    check(share <= 1.0, f"matrix and rowwise kernels differ by "
          f"{float(routes.max())}, {share:.3g} times the sum of their limits")
    checks["features"] = exempt
    checks["matrix_vs_rowwise"] = {"max_abs": float(routes.max()),
                                   "of_limits": share}
    del again, rw_want, routes
    # the row's error columns are the two splits'; the rest go to checks
    splits_err = errs["l2sq_matrix"], of_limit["l2sq_matrix"]

    # --- the matrix kernel at ragged shapes (numpy-seeded): one tile, K
    # not a multiple of 32, a slice one row into its buffer (rows 4-byte
    # aligned only), M < 64 against the real references; then at one
    # transform chunk against a reference set 8x the paper's
    rng = np.random.default_rng(SEED)
    ragged = {}
    for m_, n_, k_, sliced in MATRIX_RAGGED:
        a_all = torch.as_tensor(rng.normal(size=(m_ + sliced, k_)).astype(
            np.float32), device=dev)
        a = a_all[sliced:]
        b = torch.as_tensor(rng.normal(size=(n_, k_)).astype(np.float32),
                            device=dev)
        case = f"{m_} x {n_} x {k_}" + (", one row in" if sliced else "")
        ragged[case] = held("l2sq_matrix", case, l2dist.l2sq_matrix(a, b),
                            l2dist.l2sq_matrix(a, b), ref.l2sq_matrix(a, b),
                            l2dist.matrix_limit(a, b))
    q3 = q_test[:3]
    ragged["3 test queries"] = held(
        "l2sq_matrix", "3 test queries", l2dist.l2sq_matrix(q3, refs),
        l2dist.l2sq_matrix(q3, refs), ref.l2sq_matrix(q3, refs),
        l2dist.matrix_limit(q3, refs))
    bulk = image_embeddings(scale=KNN_BULK_SCALE)
    bq = torch.as_tensor(bulk.emb_test[:KNN_BULK_QUERIES], device=dev)
    br = torch.as_tensor(bulk.emb_train, device=dev)
    del bulk
    got = l2dist.l2sq_matrix(bq, br)
    bulk_of_limit = held("l2sq_matrix", f"{len(bq)} x {len(br)}", got,
                         l2dist.l2sq_matrix(bq, br), ref.l2sq_matrix(bq, br),
                         l2dist.matrix_limit(bq, br))
    del got
    checks["matrix_ragged_of_limit"] = ragged

    # --- the rowwise kernel at ragged shapes (numpy-seeded), each also
    # bit for bit its summation order, and every route of its plan taken
    rw_ragged = {}
    for n_, k_, offset in ROWWISE_RAGGED:
        buf = torch.as_tensor(rng.normal(size=offset + n_ * k_).astype(
            np.float32), device=dev)
        rr = buf[offset:].view(n_, k_)
        qq = torch.as_tensor(rng.normal(size=k_).astype(np.float32),
                             device=dev)
        case = f"{n_} x {k_}" + (f", {offset} floats in" if offset else "")
        got = l2dist.l2sq_rowwise(qq, rr)
        share = held("l2sq_rowwise", case, got, l2dist.l2sq_rowwise(qq, rr),
                     ref.l2sq_rowwise(qq, rr), l2dist.rowwise_limit(qq, rr))
        check(torch.equal(got, ref.l2sq_rowwise_lanes(qq, rr)),
              f"l2sq_rowwise ({case}) is not its summation order "
              "(ref.l2sq_rowwise_lanes) bit for bit")
        plan = tuning.rowwise_plan(n_, k_, l2dist._vec_ok(k_, qq, rr))
        rw_ragged[case] = {"plan": dataclasses.asdict(plan),
                           "of_limit": share}
        del buf, rr, got
    check({c["plan"]["route"] for c in rw_ragged.values()}
          == set(tuning.ROWWISE_ROUTES),
          f"the rowwise ragged shapes took routes {rw_ragged}")
    strided = {(c["plan"]["route"], c["plan"]["chunks"])
               for c in rw_ragged.values()
               if c["plan"]["blocks"] * c["plan"]["warps"]
               == tuning.SM_COUNT * tuning.ROWWISE_WAVE_WARPS}
    check(strided >= {("registers", j) for j in (1, 2, 4)} | {("walk", 8)},
          f"the rowwise ragged shapes strode past one wave only at "
          f"{sorted(strided)}")
    checks["rowwise_ragged"] = rw_ragged
    checks["rowwise_route_counts"] = run["rowwise_counts"]
    torch.cuda.empty_cache()

    # --- the fused kernel at C = 20 outputs and F = 533 columns (its
    # 32-output instance), as the pipeline's plan runs it
    plan = run["pipeline"].predictor
    low = plan.lowered
    x_aug = torch.cat([q_test, run["feats"]], dim=1)
    fused = {}
    args = (low.borders, low.split_features, low.split_bins,
            low.leaf_values)
    for n in (len(x_aug), KNN_SMALL_ROWS):
        xn = x_aug[:n]
        idx = ref.leaf_index(ref.binarize(xn, low.borders),
                             low.split_features, low.split_bins)
        exact = tree_order_sum(idx, low.leaf_values)
        for route in FUSED_ROUTES:
            check(torch.equal(fused_predict(xn, *args, route=route), exact),
                  f"fused_predict ({route}, C = {c}) at {n} rows is not the "
                  "tree-order sum")
        del exact
        err, share = compare_sums(
            f"fused_predict (C = {c}, F = {x_aug.shape[1]}) at {n} rows",
            fused_predict(xn, low.borders, low.split_features,
                          low.split_bins, low.leaf_values),
            ref.fused_predict(xn, low.borders, low.split_features,
                              low.split_bins, low.leaf_values),
            sum_limit(idx, low.leaf_values))
        fused[f"rows_{n}"] = {"max_abs_err": err, "of_limit": share}
    fused["ms"] = time_ms(lambda: fused_predict(x_aug, *args), 20, flush)
    fused["plan"] = tuning.fused_plan(
        len(x_aug), *low.split_features.shape, c, x_aug.shape[1],
        low.borders.shape[0] <= 255).route
    for route in FUSED_ROUTES:
        fused[f"{route}_ms"] = time_ms(
            lambda r=route: fused_predict(x_aug, *args, route=r), 20, flush)
    checks["fused_predict_c20"] = fused
    checks["binarize"] = check_and_time_knn_binarize(
        x_train, x_aug, low.borders, flush)

    # --- the card's pipeline against the plain one on the CPU, on the
    # first N_REFERENCE test rows: class ids equal where the augmented rows
    # bin alike and the top two raw scores clear twice the tree-sum limit
    ens = run["ens"]
    xs = data.emb_test[:N_REFERENCE]
    cpu_feat = KNNFeaturizer(data.emb_train, data.y_train, c, k=KNN_K,
                             device="cpu")
    cpu_pipe = EmbeddingGBDTPipeline(cpu_feat, ens, device="cpu")
    cpu_pred = cpu_pipe.predict(xs)
    x_cpu = torch.cat([torch.from_numpy(xs), cpu_feat.transform(xs)], dim=1)
    cpu_low = cpu_pipe.predictor.lowered
    bins = ref.binarize(x_cpu, cpu_low.borders)
    same_bins = (bins == ref.binarize(x_aug[:N_REFERENCE].cpu(),
                                      cpu_low.borders)).all(dim=1)
    raw = cpu_pipe.predictor.raw(x_cpu)
    limit = sum_limit(ref.leaf_index(bins, cpu_low.split_features,
                                     cpu_low.split_bins),
                      cpu_low.leaf_values, cpu_pipe.predictor.ensemble
                      .base_score)
    top2 = raw.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * limit.max(dim=1).values
    ok = (same_bins & clear).numpy()
    check(np.array_equal(run["pred"][:N_REFERENCE][ok], cpu_pred[ok]),
          "the card's pipeline classifies differently from the CPU's")
    checks["card_vs_cpu"] = {"rows": len(xs), "compared": int(ok.sum()),
                             "bins_differ": int((~same_bins).sum()),
                             "agree_all": bool(np.array_equal(
                                 run["pred"][:N_REFERENCE], cpu_pred))}

    # --- timing: the test split's matrix (the path's shape), a bulk
    # matrix, and one rowwise query against the train split, each beside
    # its plain version and a library call (TF32 off)
    a_sq, b_sq = (q_test * q_test).sum(1), (refs * refs).sum(1)

    def addmm(a, b, a_sq, b_sq):
        return torch.addmm(a_sq[:, None] + b_sq[None, :], a, b.T,
                           alpha=-2).clamp_min_(0)

    check(bool(((addmm(q_test, refs, a_sq, b_sq).double()
                 - ref.l2sq_matrix(q_test, refs).double()).abs()
                <= 2 * mat_limit).all()),
          "addmm yardstick computes other distances")
    m, k = q_test.shape
    n = refs.shape[0]

    def matrix_bounds(prefix, m, n, k):
        """The matrix form's bounds: bytes (each input and the output
        once) against the function's product, 2·M·N·K operations, at the
        card's fastest rate for it (the tensor cores'; `fp32_bound_ms`
        is the same work outside them).  `design_3xtf32_ms` is the
        kernel's own three TF32 products at that rate: a note on the
        design, not a bound, since a design with fewer products could
        beat it."""
        bytes_ms, _ = bound(4 * (m + n) * k + 4 * (m + n) + 4 * m * n, 0)
        fp32_ms = (2 * m * n * k + 2 * (m + n) * k + 3 * m * n) \
            / NON_TENSOR_OPS_PER_S * 1e3
        tensor_ms = 2 * m * n * k / TF32_TENSOR_OPS_PER_S * 1e3
        ops_ms = min(fp32_ms, tensor_ms)
        return {f"{prefix}bound_ms": max(bytes_ms, ops_ms),
                f"{prefix}bound_by": "bytes" if bytes_ms >= ops_ms
                else "operations",
                f"{prefix}fp32_bound_ms": fp32_ms,
                f"{prefix}tensor_bound_ms": tensor_ms,
                f"{prefix}bytes_bound_ms": bytes_ms,
                f"{prefix}design_3xtf32_ms": 3 * tensor_ms}

    def matrix_times(prefix, a, b, reps):
        plan = tuning.matrix_plan(len(a), len(b), a.shape[1])
        dev_ms, profiled = device_ms(lambda: l2dist.l2sq_matrix(a, b),
                                     flush, reps, key="l2sq")
        return {f"{prefix}ms": time_ms(lambda: l2dist.l2sq_matrix(a, b),
                                       reps, flush),
                f"{prefix}split_ms": time_ms(lambda: l2dist.split_pass(
                    a, b, plan.k_pad), reps, flush),
                f"{prefix}device_ms": dev_ms,
                f"{prefix}profiled_ms": profiled}

    bq_sq, br_sq = (bq * bq).sum(1), (br * br).sum(1)
    matrix_row = {
        "name": "l2sq_matrix", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/l2sq_matrix.cu",
        "replaces": "src/repro/kernels/l2dist.py:100",
        "max_abs_err": splits_err[0],
        **matrix_times("", q_test, refs, 20),
        "plain_ms": time_ms(lambda: ref.l2sq_matrix(q_test, refs), 10,
                            flush),
        **matrix_bounds("", m, n, k),
        "library_ms": time_ms(lambda: addmm(q_test, refs, a_sq, b_sq), 10,
                              flush),
        "library_call": "torch.addmm(a_sq + b_sq, a, b.T, alpha=-2)"
                        ".clamp_min_(0), norms precomputed, TF32 off",
        "shape": [m, n, k], "err_over_limit": splits_err[1],
        "bulk_shape": [len(bq), len(br), k],
        "bulk_err_over_limit": bulk_of_limit,
        **matrix_times("bulk_", bq, br, 10),
        "bulk_plain_ms": time_ms(lambda: ref.l2sq_matrix(bq, br), 5, flush),
        "bulk_library_ms": time_ms(lambda: addmm(bq, br, bq_sq, br_sq), 5,
                                   flush),
        **matrix_bounds("bulk_", len(bq), len(br), k),
        "plan": dataclasses.asdict(tuning.matrix_plan(m, n, k)),
        "ptxas": ptxas_report("l2sq_matrix.cu")}
    del bq, br, bq_sq, br_sq
    q0 = q_test[0]

    def cdist(q):
        return torch.cdist(q[None, :], refs,
                           compute_mode="donot_use_mm_for_euclid_dist"
                           )[0].square_()

    check(bool(((cdist(q0).double() - ref.l2sq_rowwise(q0, refs).double())
                .abs() <= 2 * l2dist.rowwise_limit(q0, refs)).all()),
          "cdist yardstick computes other distances")
    rw_bound, rw_by = bound(4 * n * k + 4 * k + 4 * n, 3 * n * k)
    # every test query back to back, refs in L2: lone calls, then the
    # route's own call (one dispatch a query into a preallocated row, the
    # queries and refs checked once), on events and on the host clock
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    lone_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        start.record()
        for q in q_test:
            l2dist.l2sq_rowwise(q, refs)
        end.record()
        end.synchronize()
        lone_ms.append(start.elapsed_time(end) / len(q_test))
    batch = ops.rowwise_batch(q_test, refs)
    dists = torch.empty((len(q_test), n), dtype=torch.float32, device=dev)
    route = {"ms": [], "host_ms": []}
    for _ in range(3):
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        for i in range(len(q_test)):
            ops.l2sq_rowwise(q_test[i], refs, out=dists[i], batch=batch)
        route["host_ms"].append((time.perf_counter() - t0) * 1e3
                                / len(q_test))
        end.record()
        end.synchronize()
        route["ms"].append(start.elapsed_time(end) / len(q_test))
    check(torch.equal(dists, rw), "the route's out= rows differ from lone "
          "launches")
    del dists
    rw_device, rw_profiled = device_ms(lambda: l2dist.l2sq_rowwise(q0, refs),
                                       flush, 20, key="l2sq_rowwise")
    rowwise_row = {
        "name": "l2sq_rowwise", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/l2sq_rowwise.cu",
        "replaces": "src/repro/kernels/l2dist.py:50",
        "max_abs_err": rw_err[0],
        "ms": time_ms(lambda: l2dist.l2sq_rowwise(q0, refs), 50, flush),
        "device_ms": rw_device, "profiled_ms": rw_profiled,
        "plain_ms": time_ms(lambda: ref.l2sq_rowwise(q0, refs), 20, flush),
        "bound_ms": rw_bound, "bound_by": rw_by,
        "library_ms": time_ms(lambda: cdist(q0), 20, flush),
        "library_call": "torch.cdist(q[None], refs, compute_mode="
                        "'donot_use_mm_for_euclid_dist').square_()",
        "shape": [n, k], "err_over_limit": rw_err[1],
        "back_to_back_ms_per_query": lone_ms,
        "route_back_to_back_ms_per_query": route["ms"],
        "route_host_ms_per_query": route["host_ms"],
        "plan": dataclasses.asdict(tuning.rowwise_plan(
            n, k, l2dist._vec_ok(k, q0, refs))),
        "ptxas": ptxas_report("l2sq_rowwise.cu", instances=True),
        "per": "one query against the train split"}
    return [matrix_row, rowwise_row], checks


def check_and_time_knn_binarize(x_train, x_aug, borders, flush):
    """The binarize kernel at the kNN head's shape (533 columns: the
    staged table is 136 KB): both splits' augmented rows, KNN_SMALL_ROWS
    rows and a slice one row in, equal to both plain versions.  Then time
    kernel, plain version and `searchsorted` on the train split."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.binarize import binarize
    from repro_torch.launch.hlo_analysis import compares
    cases = {"train split": x_train, "test split": x_aug,
             f"{KNN_SMALL_ROWS} rows": x_aug[:KNN_SMALL_ROWS],
             "test split from row 1": x_aug[1:]}
    for what, xn in cases.items():
        check(torch.equal(binarize(xn, borders, out_dtype=torch.uint8),
                          ref.binarize_u8(xn, borders)),
              f"binarize (uint8) differs from its plain version on the kNN "
              f"head's {what}")
        check(torch.equal(binarize(xn, borders, out_dtype=torch.int32),
                          ref.binarize(xn, borders)),
              f"binarize (int32) differs from its plain version on the kNN "
              f"head's {what}")
    xt, bt = x_train.t().contiguous(), borders.t().contiguous()
    check(torch.equal(torch.searchsorted(bt, xt, out_int32=True).t(),
                      ref.binarize(x_train, borders)),
          "searchsorted yardstick computes other bins")
    n, f = x_train.shape
    nb = borders.shape[0]
    bound_ms, bound_by = bound(n * f * 4 + nb * f * 4 + n * f,
                               n * f * compares(nb))
    return {
        "checked": list(cases), "rows": n, "features": f, "borders": nb,
        "ms": time_ms(lambda: binarize(x_train, borders,
                                       out_dtype=torch.uint8), 20, flush),
        "plain_ms": time_ms(lambda: ref.binarize_u8(x_train, borders), 5,
                            flush),
        "library_ms": time_ms(lambda: torch.searchsorted(bt, xt,
                                                         out_int32=True),
                              10, flush),
        "bound_ms": bound_ms, "bound_by": bound_by}


def knn_phases(run, data):
    """The kNN path's wall seconds, its head's training metrics, the
    pipeline's test accuracy and rows/s (the path's own first call and the
    median of KNN_PREDICT_REPEATS more)."""
    snap = run["history"]["metrics"]
    pred = run["pred"]
    check(pred.shape == (len(data.emb_test),) and pred.dtype == np.int32
          and bool(((pred >= 0) & (pred < data.n_classes)).all()),
          f"pipeline class ids {pred.dtype} {pred.shape}")
    repeats = []
    for _ in range(KNN_PREDICT_REPEATS):
        t0 = time.perf_counter()
        again = run["pipeline"].predict(data.emb_test)
        repeats.append(time.perf_counter() - t0)
        check(np.array_equal(again, pred), "the pipeline classifies "
              "differently on a second call")
    n = len(data.emb_test)
    return {"rows": n, "train_rows": len(data.emb_train),
            "features": run["x_train"].shape[1], "k": KNN_K,
            "seconds": run["seconds"],
            "rows_per_s": n / run["seconds"]["predict"],
            "repeat_rows_per_s": n / float(np.median(repeats)),
            "test_accuracy": float((pred == data.y_test).mean()),
            "trees": run["ens"].n_trees, "depth": run["ens"].depth,
            "training": {k: snap[k] for k in (
                "iter_p50_ms", "iter_p99_ms", "hist_p50_ms", "hist_frac",
                "split_frac", "leaf_frac", "first_train_loss",
                "final_train_loss")}}


# --------------------------------------------------------------------------
# The former caps: 33 outputs, rows past the old shared tiles, 66 stats
# --------------------------------------------------------------------------
CAPS_OUTPUTS = 33
CAPS_ROWS = (2048, 17)             # whole and partial blocks
CAPS_WIDE_ROWS = (1024, 17)
# (features, borders): one feature past each kernel's old cap with uint8
# bins (63 borders) and int32 bins (300), and rows past the opt-in limit
# (the global route of every index and fused kernel)
CAPS_FEATURES = ((1005, 63), (1021, 63), (1533, 63), (6145, 63),
                 (252, 300), (256, 300), (384, 300), (1537, 300),
                 (30_000, 63), (7_500, 300))
CAPS_STATS = 66
CAPS_ODD_TREES = 61                # T % 4 = 1 for the bp spread route


def random_ensemble(n_trees, depth, n_features, n_borders, n_outputs,
                    seed, n_rows):
    """A numpy-seeded ensemble on the card and `n_rows` rows of x (5% NaN)
    for it."""
    import torch
    from repro_torch import convert
    rng = np.random.default_rng(seed)
    ens = convert.ensemble_from_numpy({
        "split_features": rng.integers(0, n_features, (n_trees, depth))
        .astype(np.int32),
        "split_bins": rng.integers(1, n_borders + 1, (n_trees, depth))
        .astype(np.int32),
        "leaf_values": (0.1 * rng.normal(size=(n_trees, 1 << depth,
                                               n_outputs))).astype(np.float32),
        "borders": np.sort(rng.normal(size=(n_borders, n_features)), 0)
        .astype(np.float32),
        "n_borders": np.full((n_features,), n_borders, np.int32),
        "base_score": rng.normal(scale=0.1, size=(n_outputs,))
        .astype(np.float32)})
    x = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    return ens.to("cuda"), torch.as_tensor(x, device="cuda")


def tree_order_sum(idx, leaf_values):
    """sum_t leaf_values[t, idx[:, t]] in tree order, one float32 add a
    tree from 0: the order of every gather and fused kernel."""
    import torch
    acc = torch.zeros((idx.shape[0], leaf_values.shape[2]),
                      device=idx.device)
    for t in range(idx.shape[1]):
        acc += leaf_values[t][idx[:, t].long()]
    return acc


def spread_fits(n_rows: int, n_features: int, u8: bool,
                splits: str = "rows") -> bool:
    """Whether the spread route of the soa fused kernel (or the dm one,
    `splits="planes"`, or the bp one, "bitpacked") takes a caps model (48
    trees of depth 8, 3 outputs) at this shape."""
    from repro_torch.kernels import tuning
    try:
        tuning.fused_plan(n_rows, 48, 8, 3, n_features, u8, route="spread",
                          splits=splits)
    except ValueError:
        return False
    return True


def check_caps() -> dict:
    """The shapes the kernels once refused, each against its plain
    version: C = 33 on every route and layout (fused = pool = staged,
    depth_major = soa, bitpacked = depth_grouped, one-group bitpacked
    fused = soa fused, bit for bit), leaf_gather's staged and direct
    routes and the three fused kernels' spread and row routes bit for bit
    against the tree-order sum (bp with uint8 and int32 planes, also on
    61 of the trees, whose uint8 plane rows start off 4-byte words); every
    index and fused kernel one feature past its old cap and past the
    opt-in limit, uint8 and int32 bins and planes (each soa, dm and bp
    fused route that takes the shape giving soa's plan's bits); the
    histogram at 66 stats (two launches) bit for bit against
    `ref.histogram_fixed`.  Returns what was run."""
    import torch
    from repro_torch.core import layout as tlayout
    from repro_torch.core.predictor import Predictor
    from repro_torch.core.trees import truncate_tree_depths
    from repro_torch.kernels import ref, tuning
    from repro_torch.kernels.fused_predict import (fused_predict,
                                                   fused_predict_bp,
                                                   fused_predict_dm)
    from repro_torch.kernels.histogram import histogram
    from repro_torch.kernels.leaf_gather import leaf_gather
    from repro_torch.kernels.leaf_index import (leaf_index, leaf_index_bp,
                                                leaf_index_dm)
    out = {"outputs": CAPS_OUTPUTS, "rows": list(CAPS_ROWS)}
    worst = {}

    def held(name, got, want, limit):
        err, share = compare_sums(name, got, want, limit)
        key = name.split(" ")[0]
        worst[key] = max(worst.get(key, 0.0), share)

    # --- C = 33: every route and layout, then the kernels
    full, x = random_ensemble(64, 6, 54, 63, CAPS_OUTPUTS, SEED + 33,
                              max(CAPS_ROWS))
    rng = np.random.default_rng(SEED + 33)
    mixed = truncate_tree_depths(full.to("cpu"), rng.integers(
        0, 7, full.n_trees)).to("cuda")
    raw = {}
    for model_name, model in (("mixed", mixed), ("full", full)):
        for layout in ("soa", "depth_major", "depth_grouped", "bitpacked"):
            fused = Predictor.build(model, device="cuda", strategy="fused",
                                    layout=layout)
            staged = Predictor.build(model, device="cuda", strategy="staged",
                                     layout=layout)
            routes = {"fused": fused.raw(x),
                      "pool": fused.raw(fused.quantize(x)),
                      "staged": staged.raw(x)}
            for route in ("pool", "staged"):
                check(torch.equal(routes[route], routes["fused"]),
                      f"C = {CAPS_OUTPUTS}, {model_name} model, {layout}: "
                      f"{route} scores differ from fused")
            raw[model_name, layout] = routes["fused"]
        for a, b in (("depth_major", "soa"), ("bitpacked", "depth_grouped")):
            check(torch.equal(raw[model_name, a], raw[model_name, b]),
                  f"C = {CAPS_OUTPUTS}, {model_name} model: {a} scores "
                  f"differ from {b}'s")
    check(torch.equal(raw["full", "bitpacked"], raw["full", "soa"]),
          f"C = {CAPS_OUTPUTS}: one-group bitpacked fused differs from soa")
    out["groups"] = len(tlayout.lower(mixed, "depth_grouped").groups)
    check(out["groups"] > 1, "the truncated C = 33 model has one group")

    soa = tlayout.lower(full, "soa")
    dm = tlayout.lower(full, "depth_major")
    (bp,) = tlayout.lower(full, "bitpacked").groups
    sf, sb, lv, borders = (soa.split_features, soa.split_bins,
                           soa.leaf_values, soa.borders)
    dm_planes = (dm.split_features_dm, dm.split_bins_dm, dm.pow2)
    for n in CAPS_ROWS:
        xn = x[:n]
        idx = ref.leaf_index(ref.binarize(xn, borders), sf, sb)
        exact = tree_order_sum(idx, lv)
        limit = sum_limit(idx, lv)
        for staged in (True, False):
            got = leaf_gather(idx, lv, staged=staged)
            check(torch.equal(got, exact),
                  f"leaf_gather ({'staged' if staged else 'direct'}) at "
                  f"C = {CAPS_OUTPUTS}, {n} rows is not the tree-order sum")
            held(f"leaf_gather at C = {CAPS_OUTPUTS}, {n} rows", got,
                 ref.leaf_gather(idx, lv), limit)
        for name, got, want in (
                ("fused_predict", fused_predict(xn, borders, sf, sb, lv),
                 ref.fused_predict(xn, borders, sf, sb, lv)),
                ("fused_predict_dm",
                 fused_predict_dm(xn, borders, *dm_planes, dm.leaf_values),
                 ref.fused_predict_depth_major(xn, borders, *dm_planes,
                                               dm.leaf_values)),
                *((f"fused_predict_bp ({str(p.dtype)[6:]} planes)",
                   fused_predict_bp(xn, borders, bp.split_features_bp, p,
                                    bp.leaf_values),
                   ref.fused_predict_bitpacked(xn, borders,
                                               bp.split_features_bp, p,
                                               bp.leaf_values))
                  for p in (bp.split_bins_bp, bp.split_bins_bp.int()))):
            check(torch.equal(got, exact),
                  f"{name} at C = {CAPS_OUTPUTS}, {n} rows is not the "
                  "tree-order sum")
            held(f"{name} at C = {CAPS_OUTPUTS}, {n} rows", got, want, limit)
        for route in FUSED_ROUTES:
            got = fused_predict(xn, borders, sf, sb, lv, route=route)
            check(torch.equal(got, exact),
                  f"fused_predict ({route}) at C = {CAPS_OUTPUTS}, {n} rows "
                  "is not the tree-order sum")
            check(torch.equal(fused_predict_dm(xn, borders, *dm_planes,
                                               dm.leaf_values, route=route),
                              got),
                  f"fused_predict_dm ({route}) at C = {CAPS_OUTPUTS}, {n} "
                  "rows differs from soa's")
            for p in (bp.split_bins_bp, bp.split_bins_bp.int()):
                check(torch.equal(fused_predict_bp(
                    xn, borders, bp.split_features_bp, p, bp.leaf_values,
                    route=route), got),
                      f"fused_predict_bp ({route}, {str(p.dtype)[6:]} "
                      f"planes) at C = {CAPS_OUTPUTS}, {n} rows differs "
                      "from soa's")
    # a tree count that is no multiple of 4: rows of a uint8 plane start
    # off 4-byte boundaries, so the bp spread route stages them by bytes
    odd = full.slice_trees(0, CAPS_ODD_TREES)
    (odd_bp,) = tlayout.lower(odd, "bitpacked").groups
    check(odd_bp.split_bins_bp.dtype == torch.uint8,
          "the odd-tree caps model lowers to int32 planes")
    for n in CAPS_ROWS:
        xn = x[:n]
        exact = tree_order_sum(ref.leaf_index(ref.binarize(xn, borders),
                                              odd.split_features,
                                              odd.split_bins),
                               odd.leaf_values)
        for route in FUSED_ROUTES:
            for p in (odd_bp.split_bins_bp, odd_bp.split_bins_bp.int()):
                check(torch.equal(fused_predict_bp(
                    xn, borders, odd_bp.split_features_bp, p,
                    odd_bp.leaf_values, route=route), exact),
                      f"fused_predict_bp ({route}, {str(p.dtype)[6:]} "
                      f"planes) at {CAPS_ODD_TREES} trees, {n} rows is not "
                      "the tree-order sum")
    out["odd_trees"] = CAPS_ODD_TREES
    del exact

    # --- rows past each old cap and past the opt-in limit
    cases = []
    for n_features, n_borders in CAPS_FEATURES:
        ens, x = random_ensemble(48, 8, n_features, n_borders, 3,
                                 SEED + n_features, max(CAPS_WIDE_ROWS))
        soa = tlayout.lower(ens, "soa")
        dm = tlayout.lower(ens, "depth_major")
        (bp,) = tlayout.lower(ens, "bitpacked").groups
        borders, lv = soa.borders, soa.leaf_values
        dm_planes = (dm.split_features_dm, dm.split_bins_dm, dm.pow2)
        u8 = n_borders <= ref.MAX_U8_BORDERS
        bin_bytes = 1 if u8 else 4
        for n in CAPS_WIDE_ROWS:
            xn = x[:n]
            what = f"{n_features} features, {n_borders} borders, {n} rows"
            bins = ref.binarize(xn, borders)
            if u8:
                bins = bins.to(torch.uint8)
            idx = ref.leaf_index(bins, soa.split_features, soa.split_bins)
            check(torch.equal(leaf_index(bins, soa.split_features,
                                         soa.split_bins), idx),
                  f"leaf_index differs from its plain version at {what}")
            check(torch.equal(leaf_index_dm(bins, *dm_planes),
                              ref.leaf_index_depth_major(bins, *dm_planes)),
                  f"leaf_index_dm differs from its plain version at {what}")
            planes = [bp.split_bins_bp, bp.split_bins_bp.int()]
            for p in planes:
                check(torch.equal(
                    leaf_index_bp(bins, bp.split_features_bp, p),
                    ref.leaf_index_bitpacked(bins, bp.split_features_bp, p)),
                    f"leaf_index_bp ({str(p.dtype)[6:]} planes) differs "
                    f"from its plain version at {what}")
            limit = sum_limit(idx, lv)
            want = ref.fused_predict(xn, borders, soa.split_features,
                                     soa.split_bins, lv)
            # the plan's route, then each route that takes the shape
            got = fused_predict(xn, borders, soa.split_features,
                                soa.split_bins, lv)
            held(f"fused_predict at {what}", got, want, limit)
            for route in FUSED_ROUTES:
                if route == "spread" and not spread_fits(n, n_features, u8):
                    continue
                check(torch.equal(fused_predict(
                    xn, borders, soa.split_features, soa.split_bins, lv,
                    route=route), got),
                      f"fused_predict ({route}) at {what} differs from the "
                      "plan's route")
            held(f"fused_predict_dm at {what}",
                 fused_predict_dm(xn, borders, *dm_planes, dm.leaf_values),
                 ref.fused_predict_depth_major(xn, borders, *dm_planes,
                                               dm.leaf_values), limit)
            # every dm route that takes the shape gives soa's plan's bits
            for route in FUSED_ROUTES:
                if route == "spread" and not spread_fits(n, n_features, u8,
                                                         "planes"):
                    continue
                check(torch.equal(fused_predict_dm(
                    xn, borders, *dm_planes, dm.leaf_values, route=route),
                    got), f"fused_predict_dm ({route}) at {what} differs "
                          "from soa's")
            for p in planes:
                held(f"fused_predict_bp at {what}",
                     fused_predict_bp(xn, borders, bp.split_features_bp, p,
                                      bp.leaf_values),
                     ref.fused_predict_bitpacked(
                         xn, borders, bp.split_features_bp, p,
                         bp.leaf_values), limit)
                # every bp route that takes the shape gives soa's plan's
                # bits (one group, the trees in model order)
                for route in FUSED_ROUTES:
                    if route == "spread" and not spread_fits(
                            n, n_features, u8, "bitpacked"):
                        continue
                    check(torch.equal(fused_predict_bp(
                        xn, borders, bp.split_features_bp, p,
                        bp.leaf_values, route=route), got),
                          f"fused_predict_bp ({route}, {str(p.dtype)[6:]} "
                          f"planes) at {what} differs from soa's")
            del got, want, bins, idx, limit
        cases.append({
            "features": n_features, "borders": n_borders,
            "routes": {
                "leaf_index": tuning.index_plan(
                    max(CAPS_WIDE_ROWS), 48, 8, n_features,
                    bin_bytes).tile.route,
                "leaf_index_bp": tuning.bp_plan(
                    max(CAPS_WIDE_ROWS), 48, 8, n_features,
                    bin_bytes).tile.route,
                "fused_predict": tuning.tile_shape(n_features, u8).route,
                "fused_predict_plan": {
                    n: tuning.fused_plan(n, 48, 8, 3, n_features, u8).route
                    for n in CAPS_WIDE_ROWS},
                "fused_predict_dm_plan": {
                    n: tuning.fused_plan(n, 48, 8, 3, n_features, u8,
                                         splits="planes").route
                    for n in CAPS_WIDE_ROWS},
                "fused_predict_bp_plan": {
                    n: tuning.fused_plan(n, 48, 8, 3, n_features, u8,
                                         splits="bitpacked").route
                    for n in CAPS_WIDE_ROWS},
                "fused_planes": tuning.tile_shape(n_features, u8,
                                                  planes=True).route}})
        del ens, x, soa, dm, bp
        torch.cuda.empty_cache()
    out["features"] = cases
    check({r for c in cases for k, r in c["routes"].items()
           if not k.endswith("_plan")} == {"shared", "global"},
          "the feature cases miss a route")

    # --- the histogram past 64 stats: one launch a stat group
    rng = np.random.default_rng(SEED + CAPS_STATS)
    n, n_feat = 20_000, 54
    bins_t = rng.integers(0, 64, (n_feat, n)).astype(np.uint8)
    bins_t[:, rng.random(n) < 0.4] = 0          # a crowded bin
    gh = (rng.normal(size=(n, CAPS_STATS))
          * np.logspace(-3, 2, CAPS_STATS)).astype(np.float32)
    bins_t = torch.as_tensor(bins_t, device="cuda")
    gh = torch.as_tensor(gh, device="cuda")
    hist_cases = []
    for depth in (0, 3):
        leaf = torch.as_tensor(rng.integers(0, 1 << depth, n)
                               .astype(np.int32), device="cuda")
        for rows in (n, 17):
            for bt in (bins_t, bins_t.int()):
                bt_n = bt[:, :rows].contiguous()
                kw = dict(n_bins=64, n_leaves=1 << depth)
                before = histogram.launches
                got = histogram(bt_n, leaf[:rows], gh[:rows].contiguous(),
                                **kw)
                check(histogram.launches - before
                      == len(tuning.stat_groups(CAPS_STATS)),
                      "the histogram did not launch once a stat group")
                check(torch.equal(got, ref.histogram_fixed(
                    bt_n, leaf[:rows], gh[:rows].contiguous(), **kw)),
                      f"histogram at {CAPS_STATS} stats, depth {depth}, "
                      f"{rows} rows, {bt.dtype} bins differs from the plain "
                      "fixed-point version")
                hist_cases.append(f"d={depth} rows={rows} {bt.dtype}")
    out["histogram"] = {"stats": CAPS_STATS,
                        "groups": tuning.stat_groups(CAPS_STATS),
                        "cases": hist_cases, "fixed_point_identical": True}
    out["err_over_limit"] = worst
    torch.cuda.synchronize()
    return out


# The kernels each path launches, and no others.
MESH_SHARDS = 4          # make_local_mesh(4): logical shards on the cards
MESH_RAGGED_CUT = 3      # 139,437 rows: no multiple of the shard count
MESH_BULK_REPEAT = 2     # SyntheticSource repeat of the mesh's bulk run
MESH_TIMED = 5           # event-timed calls a rate is the median of


def events_ms(fn, reps: int = MESH_TIMED) -> float:
    """Median CUDA-event time of `fn` after one untimed call: the host's
    launches and the card's work, as a caller waits for them."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def run_mesh_path(paths: dict, full, x_test: np.ndarray, tmp: str) -> dict:
    """The multi-device slice on `make_local_mesh(4)`: four logical shards
    dealt round robin over the machine's cards (all on cuda:0 with one
    card).  On each of the five serving paths, the fused plan and the
    staged plan are row-sharded on the pool and the float route, the
    ragged test split (139,437 rows) and 2 rows too: each result equals
    the single-device plan's bit for bit, the pool route launches no
    binarize, and each kernel launches exactly 4 times the single-device
    count; tree sharding and the (2, 2) hybrid mesh stay within
    `sum_limit`.  Then a `ModelRegistry` of 2 models x 2 replicas
    (`predict_multi` launches binarize once for the one schema), a
    `GBDTServer(mesh=)` against a local staged server, `BulkScorer(mesh=)`
    with the prefetch worker over the test split twice against the run
    without a mesh in all three sinks, the traced `sharded/pool` span,
    and rows/s sharded against single-device at the bulk shape and the
    1,024-row bucket (one card's numbers: no scaling claim)."""
    import torch
    from repro_torch.core.predictor import Predictor
    from repro_torch.core.trees import concat_ensembles
    from repro_torch.kernels import ops, tuning
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.obs.trace import get_tracer, tracing
    from repro_torch.scoring import (BulkScorer, NpySink, ScoreConfig,
                                     StatsSink, SyntheticSource, TopKSink)
    from repro_torch.serving.engine import GBDTServer, ModelRegistry

    t_phase = time.perf_counter()
    mesh = make_local_mesh(MESH_SHARDS)
    hybrid = make_local_mesh(MESH_SHARDS, model=2)
    n = len(x_test)
    ragged = n - MESH_RAGGED_CUT

    def counted(fn):
        torch.cuda.synchronize()
        before = ops.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        after = ops.launch_counts()
        return out, {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}

    limits = {}

    def limit_of(rec):
        """`sum_limit` of a path's model, from its plan's copy on the
        card (one a distinct model)."""
        key = id(rec["model"])
        if key not in limits:
            model = rec["plan"].ensemble
            bins = ops.binarize_u8(torch.as_tensor(
                x_test, device=model.borders.device), model.borders)
            idx = ops.leaf_index(bins, model.split_features,
                                 model.split_bins)
            limits[key] = sum_limit(idx, model.leaf_values,
                                    model.base_score)
            del bins, idx
        return limits[key]

    rows_checks, sum_errs = {}, {}
    for path, rec in paths.items():
        for kind, plan in (("fused", rec["plan"]), ("staged", rec["staged"])):
            name = f"{path}_{kind}"
            fn = plan.sharded(mesh, shard_axis="rows")
            pool = plan.quantize(x_test)
            record = {}
            for route, data, part in (
                    ("pool", pool, pool.slice_rows(0, ragged)),
                    ("float", x_test, x_test[:ragged])):
                want, single = counted(lambda: plan.raw(data))
                got, sharded = counted(lambda: fn(data))
                check(torch.equal(got, want), f"mesh: {name} row-sharded "
                      f"{route} scores differ from the single-device plan's")
                check(sharded == {k: MESH_SHARDS * v
                                  for k, v in single.items()},
                      f"mesh: {name} {route} launched {sharded} on "
                      f"{MESH_SHARDS} shards against {single} on one")
                if route == "pool":
                    check("binarize" not in sharded,
                          f"mesh: {name}'s pool route launched binarize")
                check(torch.equal(fn(part), want[:ragged]),
                      f"mesh: {name} ragged {route} ({ragged} rows) "
                      "differs from the single-device plan's")
                record[route] = {"single": single, "sharded": sharded}
            small = x_test[:2]
            check(torch.equal(fn(small), plan.raw(small)),
                  f"mesh: {name} on 2 rows over {MESH_SHARDS} shards")
            rows_checks[name] = record
            limit = limit_of(rec)
            want = plan.raw(pool)
            for axis, sharded_fn in (
                    ("trees", plan.sharded(mesh, shard_axis="trees")),
                    ("hybrid", plan.sharded(hybrid))):
                for route, data in (("pool", pool), ("float", x_test)):
                    err, share = compare_sums(
                        f"mesh: {name} {axis} {route}", sharded_fn(data),
                        want, limit)
                    sum_errs[f"{name}_{axis}_{route}"] = {
                        "max_abs_err": err, "err_over_limit": share}
            del pool
    copies = {p: len(rec["plan"]._replicas) for p, rec in paths.items()}

    # replicas: 2 models x 2 replicas on the 4 shards; one schema
    ens = paths["soa"]["model"]
    half = ens.slice_trees(0, ens.n_trees // 2)
    xs = x_test[:4 * MAX_BATCH]
    reg = ModelRegistry(mesh=mesh, device="cuda", max_batch=MAX_BATCH)
    try:
        groups = {"model": reg.register("model", ens, replicas=2),
                  "half": reg.register("half", half, replicas=2)}
        check(all(len(g.servers) == 2 and all(s.mesh.size == 2
                                               for s in g.servers)
                  for g in groups.values()),
              "mesh: replica groups are not 2 servers of 2 shards")
        multi, launched = counted(lambda: reg.predict_multi(xs))
        check(launched.get("binarize", 0) == 1,
              f"mesh: predict_multi over 2 replica groups launched "
              f"binarize {launched.get('binarize', 0)} times for one "
              "schema")
        for name, group in groups.items():
            check(np.array_equal(multi[name], group.predict_batch(xs)),
                  f"mesh: predict_multi differs from {name}'s "
                  "predict_batch")
        registry_metrics = reg.metrics()
        check(all(m["replicas"] == 2 for m in registry_metrics.values()),
              "mesh: the registry's metrics do not count 2 replicas")
    finally:
        reg.close()

    # a mesh server against a local one on the same (staged) pipeline
    meshed = GBDTServer(ens, device="cuda", mesh=mesh, max_batch=MAX_BATCH,
                        layout="soa")
    local = GBDTServer(ens, device="cuda", max_batch=MAX_BATCH,
                       layout="soa", strategy="staged")
    try:
        t0 = time.perf_counter()
        got = meshed.predict_batch(x_test)
        torch.cuda.synchronize()
        server_s = time.perf_counter() - t0
        check(np.array_equal(got, local.predict_batch(x_test)),
              "mesh: GBDTServer(mesh=) predict_batch differs from a local "
              "server's")
        check(np.array_equal(meshed.predict(x_test[5]),
                             local.predict(x_test[5])),
              "mesh: GBDTServer(mesh=) predict differs")
        server_recompiles = meshed.metrics.snapshot()["recompiles"]
    finally:
        meshed.close()
        local.close()

    # BulkScorer(mesh=) with the prefetch worker, in all three sinks
    joined = concat_ensembles(full.slice_trees(0, full.n_trees // 2),
                              full.slice_trees(full.n_trees // 2,
                                               full.n_trees))
    plans = {name: Predictor.build(e, device="cuda", layout="soa")
             for name, e in (
        ("full", full), ("half", full.slice_trees(0, full.n_trees // 2)),
        ("joined", joined))}
    source = SyntheticSource("covertype", split="test",
                             repeat=MESH_BULK_REPEAT)
    cfg = ScoreConfig(output="proba", prefetch_depth=2,
                      chunk_rows=tuning.PREFETCH_MIN_CHUNK_ROWS)
    bulk = {}
    for label, m in (("single", None), ("mesh", mesh)):
        out_sinks = {"full": NpySink(os.path.join(tmp, f"{label}.npy")),
                     "half": StatsSink(), "joined": TopKSink(BULK_TOP_K)}
        t0 = time.perf_counter()
        res = BulkScorer(plans, cfg, mesh=m).score(source, out_sinks)
        torch.cuda.synchronize()
        bulk[label] = {"result": res, "seconds": time.perf_counter() - t0}
    got, want = bulk["mesh"]["result"], bulk["single"]["result"]
    check(got.metrics["prefetch_depth"] == cfg.prefetch_depth,
          "mesh: the bulk run ran without the prefetch worker")
    check(got.chunk_shapes == want.chunk_shapes,
          f"mesh: bulk chunk shapes {got.chunk_shapes}")
    check(np.array_equal(np.load(os.path.join(tmp, "mesh.npy")),
                         np.load(os.path.join(tmp, "single.npy"))),
          "mesh: BulkScorer(mesh=) scores differ in the NpySink")
    check(all(np.array_equal(got.outputs["half"][k], want.outputs["half"][k])
              for k in want.outputs["half"]),
          "mesh: BulkScorer(mesh=) stats differ in the StatsSink")
    check(all(np.array_equal(got.outputs["joined"][k],
                             want.outputs["joined"][k])
              for k in ("indices", "scores")),
          "mesh: BulkScorer(mesh=) top rows differ in the TopKSink")

    # the traced sharded/pool span
    plan = paths["soa"]["plan"]
    pool = plan.quantize(x_test)
    fn = plan.sharded(mesh, shard_axis="rows")
    tracer = get_tracer()
    with tracing(tracer, clear=True):
        fn(pool)
        events = tracer.events()
    spans = [e for e in events if e["name"] == "sharded/pool"]
    check(len(spans) == 1 and {k: spans[0]["args"][k] for k in (
        "shard_axis", "devices", "rows", "layout")} == {
            "shard_axis": "rows", "devices": MESH_SHARDS, "rows": n,
            "layout": "soa"},
          f"mesh: the traced sharded/pool span {spans}")

    # rows/s, sharded against single-device, at the bulk shape and at the
    # 1,024-row bucket
    rates = {}
    for label, rows in (("bulk", n), ("bucket_1024", MAX_BATCH)):
        p, x = pool.slice_rows(0, rows), x_test[:rows]
        x_dev = torch.as_tensor(x, device=plan.device)
        for route, data in (("pool", p), ("float", x_dev)):
            single_ms = events_ms(lambda: plan.raw(data))
            sharded_ms = events_ms(lambda: fn(data))
            rates[f"{label}_{route}"] = {
                "rows": rows, "single_ms": single_ms,
                "sharded_ms": sharded_ms,
                "single_rows_per_s": rows / single_ms * 1e3,
                "sharded_rows_per_s": rows / sharded_ms * 1e3}
    del pool
    return {
        "shards": MESH_SHARDS,
        "devices": sorted({str(d) for d in mesh.device_list}),
        "model_copies_per_plan": copies,
        "rows_exact": sorted(rows_checks), "launches": rows_checks,
        "ragged_rows": ragged, "trees_and_hybrid": sum_errs,
        "predict_multi_binarize_launches": launched.get("binarize", 0),
        "registry_replicas": {k: m["replicas"]
                              for k, m in registry_metrics.items()},
        "server": {"rows": n, "seconds": server_s,
                   "rows_per_s": n / server_s,
                   "recompiles": server_recompiles},
        "bulk": {label: {"rows": source.n_rows, "seconds": r["seconds"],
                         "rows_per_s": r["result"].metrics["rows_per_s"],
                         "chunk_rows": r["result"].chunk_rows,
                         "prefetch_depth":
                             r["result"].metrics["prefetch_depth"]}
                 for label, r in bulk.items()},
        "rates": rates,
        "span": spans[0]["args"],
        "seconds": time.perf_counter() - t_phase}


# --------------------------------------------------------------------------
# The contract checker: the abstract walk, then the cuda cells for real
# --------------------------------------------------------------------------
# The variants of each `cuda` cell launched for real: the canonical call
# (the distance op's three), the 1,024-row bucket, the bulk shape (the row
# routes and the staged gather), the histogram's two stat groups.
CONTRACT_REAL_LABELS = ("canonical", "bucket", "bulk", "matrix", "rowwise",
                        "batch", "stats66")
CONTRACT_SEED = 7
# The launchers each of the twelve kernel wrappers calls.
WRAPPER_LAUNCHERS = {
    "binarize": ("repro_binarize",), "leaf_index": ("repro_leaf_index",),
    "leaf_gather": ("repro_leaf_gather",),
    "fused_predict": ("repro_fused_predict", "repro_fused_predict_spread"),
    "leaf_index_dm": ("repro_leaf_index_dm",),
    "fused_predict_dm": ("repro_fused_predict_dm",
                         "repro_fused_predict_dm_spread"),
    "leaf_index_bp": ("repro_leaf_index_bp",),
    "fused_predict_bp": ("repro_fused_predict_bp",
                         "repro_fused_predict_bp_spread"),
    "histogram": ("repro_histogram",),
    "l2sq_rowwise": ("repro_l2sq_rowwise",),
    "l2sq_matrix": ("repro_l2sq_matrix",),
    "split_level": ("repro_split_level",)}


def contract_inputs(cell, variant, gen):
    """Real CUDA tensors for a variant's specs, with what each argument's
    role needs: sorted borders, split features below F, leaf ids below L
    (2^d for a split level), bins below n_bins, level weights 2^d, random
    booleans for valid borders, random floats elsewhere."""
    import torch
    from repro_torch.analysis.trace_tools import Spec
    specs = variant.args
    kw = dict(variant.kwargs)

    def ints(spec, high):
        return torch.randint(0, max(int(high), 1), spec.shape,
                             generator=gen, device=spec.device,
                             dtype=torch.int32).to(spec.dtype)

    out = []
    for i, spec in enumerate(specs):
        if not isinstance(spec, Spec):
            out.append(spec)
            continue
        if spec.dtype.is_floating_point:
            t = torch.randn(spec.shape, generator=gen, device=spec.device)
            if cell.op in ("binarize", "fused_predict") and i == 1:
                t = t.sort(dim=0).values
            if cell.impl.endswith("_dm") and \
                    (cell.op, i) in (("leaf_index", 3), ("fused_predict", 4)):
                t = torch.pow(2.0, torch.arange(
                    spec.shape[0], dtype=torch.float32,
                    device=spec.device))[:, None]
        elif cell.op == "leaf_gather":
            t = ints(spec, specs[1].shape[1])
        elif cell.op == "histogram":
            t = ints(spec, kw["n_bins"] if i == 0 else kw["n_leaves"])
        elif cell.op == "split_level":   # valid, bins, leaf ids below 2^d
            t = ints(spec, (2, kw["n_bins"], 1 << kw["d"])[i - 1])
        elif cell.op == "leaf_index":
            n_feat = specs[0].shape[1]
            t = ints(spec, 10 if i != 1 else n_feat)
        else:                          # fused_predict's split arrays
            n_feat = specs[0].shape[1]
            t = ints(spec, n_feat if i == 2 else specs[1].shape[0] + 1)
        out.append(t.to(spec.device))
    return out, kw


def run_contracts() -> dict:
    """The contract checker (`repro_torch.analysis`) on the card: the
    abstract walk must give the committed report byte for byte with no
    unsuppressed finding; then each `cuda` cell's real variants
    (`CONTRACT_REAL_LABELS`) launch once with the resource record on, and
    each must make the launches its walk recorded, launcher for launcher;
    the record's shared memory goes through the smem-budget and
    smem-model rules, and becomes the per-kernel resource table."""
    import torch
    from repro_torch.analysis import checker, matrix, passes, resources
    from repro_torch.analysis.report import default_report_path
    from repro_torch.kernels import _build, ops, registry

    t0 = time.perf_counter()
    report = checker.run_check()
    walk_s = time.perf_counter() - t0
    check(report.ok, "contract check: unsuppressed findings\n"
          + report.format())
    with open(default_report_path(), encoding="utf-8") as f:
        committed = f.read()
    check(report.dumps() == committed,
          "the contract report on the card differs from the committed "
          "results/analysis_torch/contract-report.json")

    lib = _build.library()
    gen = torch.Generator(device="cuda").manual_seed(CONTRACT_SEED)
    done: dict[tuple, list] = {}
    entries_all, findings, cells_run = [], [], 0
    t0 = time.perf_counter()
    resources.set_record(lib, True)
    try:
        for cell in matrix.enumerate_cells():
            if cell.family != "cuda":
                continue
            cells_run += 1
            for variant in matrix.cell_variants(cell):
                if variant.label not in CONTRACT_REAL_LABELS:
                    continue
                key = matrix.trace_key(cell, variant)
                walk = [e.record.name for e in
                        matrix.trace_variant(cell, variant).launches()]
                if key in done:
                    continue
                args, kw = contract_inputs(cell, variant, gen)
                fn = registry.get(cell.op, cell.impl).fn
                resources.set_record(lib, True)
                with _build.recording_launches(execute=True) as recs:
                    if variant.call is not None:
                        variant.call(fn, *args, **kw)
                    else:
                        fn(*args, **kw)
                torch.cuda.synchronize()
                entries = resources.read_record(lib)
                real = [r for r in recs if r.kind == "launch"]
                check([r.name for r in real] == walk,
                      f"{cell} {variant.label}: real launches "
                      f"{[r.name for r in real]} differ from the walk's "
                      f"{walk}")
                pairs = resources.attribute(real, entries)
                check(sum(len(m) for _, m in pairs) == len(entries),
                      f"{cell} {variant.label}: {len(entries)} recorded "
                      f"kernel launches, {sum(len(m) for _, m in pairs)} "
                      "attributed to its launchers")
                findings += passes.card_findings(cell, pairs)
                entries_all += entries
                done[key] = [r.name for r in real]
    finally:
        resources.set_record(lib, False)
    real_s = time.perf_counter() - t0
    for f in findings:
        print(f"  contract {f.format()}")
    check(not findings, f"{len(findings)} shared-memory findings from the "
          "resource record")
    table = resources.resource_table(entries_all,
                                     _build.build_info.get("log", ""))
    launched = {name for names in done.values() for name in names}
    for wrapper in ops.KERNELS:
        check(any(name in launched for name in WRAPPER_LAUNCHERS[wrapper]),
              f"no real launch of {wrapper} in the contracts phase")
    check(all(e["mangled"] for e in entries_all),
          "the resource record has a launch without its kernel's name")
    return {"walk_s": walk_s, "real_s": real_s,
            "cells": report.cells, "traces": report.traces,
            "walk_launches": report.kernels,
            "suppressed": len(report.suppressed),
            "cuda_cells": cells_run, "real_calls": len(done),
            "real_launches": sum(len(v) for v in done.values()),
            "recorded_kernel_launches": len(entries_all),
            "smem_findings": len(findings), "resources": table}


# --------------------------------------------------------------------------
# The LM serving slice: the ten smoke configs on the card against the CPU,
# glm4-9b and zamba2-1.2b at full width, the LM launcher
# --------------------------------------------------------------------------
LM_BATCH = 2
LM_SMOKE_PROMPT = 32
LM_SMOKE_DECODE = 16     # greedy steps compared, card against CPU
LM_PARITY = 1e-4         # rtol = atol on f32 logits, card against CPU
LM_MARGIN = 2e-4         # tokens compared where the top-two gap exceeds it
LM_FULL = {"glm4-9b": 32, "zamba2-1.2b": 64}   # prompt (zamba2: its chunk)
LM_NEW = 16              # tokens generated at full width
LM_TIMED = 3             # prefill calls timed after the first
LM_LAUNCHERS = ("serve_lm_glm4", "serve_lm_whisper")
U_BF16 = 2.0 ** -8       # unit roundoff of bfloat16
ROUNDINGS_PER_LAYER = 12  # bf16 roundings a block puts on a logit's path
BF16_TENSOR_OPS_PER_S = 989e12   # dense bf16 on the tensor cores


def bf16_limit(n_layers: int, want):
    """Per-row bound on |logits - reference| of two bf16 evaluations of
    one model (the port's tests use the same rule): a walk of n = 12 L + 2
    bf16 roundings, each of relative size u = 2^-8 of the row's scale (the
    rms of the reference row), widened K_SIGMA = 8 times."""
    n = ROUNDINGS_PER_LAYER * n_layers + 2
    rms = want.double().square().mean(dim=-1, keepdim=True).sqrt()
    return K_SIGMA * math.sqrt(n) * U_BF16 * rms


def lm_path_layers(cfg) -> int:
    """Blocks on a decoded token's path: the stack's, and a hybrid's
    shared-attention applications."""
    from repro_torch.models import transformer as tf
    return cfg.n_layers + (tf.hybrid_n_apps(cfg) if cfg.family == "hybrid"
                           else 0)


def lm_inputs(cfg, prompt: int, extra: int, seed: int):
    """Numpy prompt tokens (B, prompt + extra) and, for vlm / audio, zero
    frontend embeddings, as the launcher sends them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size,
                        (LM_BATCH, prompt + extra)).astype(np.int32)
    fe = (np.zeros((LM_BATCH, cfg.frontend_seq, cfg.d_model), np.float32)
          if cfg.frontend else None)
    return toks, fe


def lm_batch(toks, fe, device):
    import torch
    batch = {"tokens": torch.as_tensor(toks, device=device)}
    if fe is not None:
        batch["frontend_embeds"] = torch.as_tensor(fe, device=device)
    return batch


def lm_greedy_path(cfg, params, toks, fe, max_seq: int, device,
                   path=None):
    """Prefill, then LM_SMOKE_DECODE decode steps, each fed the argmax of
    the step before or, given `path` (another device's run), that run's
    tokens: each step's last-position logits on the CPU, the tokens fed
    and the final `pos`."""
    import torch
    from repro_torch.models import transformer as tf
    logits, cache = tf.prefill(cfg, params, lm_batch(toks, fe, device),
                               max_seq)
    out, fed = [logits[:, -1].cpu()], []
    for step in range(LM_SMOKE_DECODE):
        tok = (path[step] if path is not None else
               torch.argmax(out[-1], -1)[:, None].to(torch.int32))
        fed.append(tok)
        logits, cache = tf.decode_step(cfg, params, cache, tok.to(device))
        out.append(logits[:, -1].cpu())
    return out, fed, int(cache["pos"])


def run_lm_smokes(card: str) -> dict:
    """(a) Each architecture's smoke config from one seeded set of f32
    weights, on the card and on the CPU: forward, and prefill + 16 greedy
    decode steps along the CPU's path, logits within LM_PARITY; the card's
    `LMServer.generate` gives the CPU's tokens up to the first step whose
    top-two margin is within LM_MARGIN on the CPU."""
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import LMServer
    out = {}
    for seed, name in enumerate(configs.ARCHS):
        cfg = configs.get(name, smoke=True)
        params = tf.init_params(cfg, torch.Generator().manual_seed(seed),
                                max_positions=256, device="cpu")
        on_card = tf.params_on(cfg, params, card)
        toks, fe = lm_inputs(cfg, LM_SMOKE_PROMPT, 0, seed)
        max_seq = 128 + (cfg.frontend_seq if cfg.family == "vlm" else 0)
        rec = {}
        with torch.inference_mode():
            want, _ = tf.forward(cfg, params, lm_batch(toks, fe, "cpu"))
            got, _ = tf.forward(cfg, on_card, lm_batch(toks, fe, card))
            errs = [(got.cpu() - want).abs().max().item()]
            check(torch.allclose(got.cpu(), want, rtol=LM_PARITY,
                                 atol=LM_PARITY),
                  f"{name}: card forward differs from the CPU's by "
                  f"{errs[0]}")
            cpu_path, fed, cpu_pos = lm_greedy_path(cfg, params, toks, fe,
                                                    max_seq, "cpu")
            card_path, _, card_pos = lm_greedy_path(cfg, on_card, toks, fe,
                                                    max_seq, card, fed)
            check(card_pos == cpu_pos, f"{name}: pos {card_pos} != {cpu_pos}")
            for step, (g, w) in enumerate(zip(card_path, cpu_path)):
                errs.append((g - w).abs().max().item())
                check(torch.allclose(g, w, rtol=LM_PARITY, atol=LM_PARITY),
                      f"{name}: step {step} logits differ from the CPU's "
                      f"by {errs[-1]}")
            tokens = LMServer(cfg, on_card, max_seq=max_seq,
                              device=card).generate(toks, LM_SMOKE_DECODE,
                                                    fe)
        compared = 0
        for row in range(LM_BATCH):
            for step in range(LM_SMOKE_DECODE):
                top2 = cpu_path[step][row].topk(2).values
                if float(top2[0] - top2[1]) <= LM_MARGIN:
                    break
                want_tok = int(torch.argmax(cpu_path[step][row]))
                check(int(tokens[row, step]) == want_tok,
                      f"{name}: generated token {step} of row {row} is "
                      f"{int(tokens[row, step])}, the CPU's {want_tok}")
                compared += 1
        rec.update(max_abs_err=max(errs), tokens_compared=compared,
                   pos=card_pos)
        out[name] = rec
    return out


def lm_bytes(params: dict, cache: dict) -> int:
    """Bytes a decode step must move: every parameter but the embedding
    read once (the embedding: B rows), and the cache read once."""
    from repro_torch.models import transformer as tf
    total = sum(t.numel() * t.element_size()
                for path, t in tf.tree_leaves(params) if path != "embed")
    emb = params["embed"]
    total += LM_BATCH * emb.shape[1] * emb.element_size()
    return total + sum(t.numel() * t.element_size() for t in cache.values())


def run_lm_full(name: str, prompt: int, card: str) -> dict:
    """(b), (c) One architecture at full width: f32 weights from a seeded
    generator on the card, served by an `LMServer` in bf16 (the f32 tree
    freed once the server holds its copy), B = 2 prompts.  Checks: the
    decode logits at position `prompt` lie within `bf16_limit` of
    `forward`'s there; two `generate` calls give the same tokens; every
    logit is finite and `pos` advanced.  Times: prefill (CUDA events,
    median of LM_TIMED), each decode step (events; the median), a
    `generate` of LM_NEW tokens on the host clock; one decode step and one
    prefill under `torch.profiler` (`device_profile`); peak memory."""
    import gc

    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import LMServer
    cfg = configs.get(name)
    rec = {"arch": name, "param_count": cfg.param_count(), "prompt": prompt,
           "batch": LM_BATCH, "new": LM_NEW,
           "compute_dtype": cfg.compute_dtype}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=card).manual_seed(
        SEED), device=card)
    rec["params"] = sum(t.numel() for _, t in tf.tree_leaves(params))
    server = LMServer(cfg, params, max_seq=prompt + LM_NEW + 1, device=card)
    del params
    gc.collect()
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    toks, fe = lm_inputs(cfg, prompt, 1, SEED)
    p, max_seq = server.params, server.max_seq
    with torch.inference_mode():
        pre = lm_batch(toks[:, :prompt], fe, card)
        logits, cache = tf.prefill(cfg, p, pre, max_seq)
        finite = bool(torch.isfinite(logits).all())
        dec, cache = tf.decode_step(cfg, p, cache, torch.as_tensor(
            toks[:, prompt:], device=card))
        finite &= bool(torch.isfinite(dec).all())
        check(int(cache["pos"]) == prompt + 1,
              f"{name}: pos {int(cache['pos'])} after a decode step")
        fwd, _ = tf.forward(cfg, p, lm_batch(toks, fe, card))
        finite &= bool(torch.isfinite(fwd).all())
        check(finite, f"{name}: non-finite logits")
        want = fwd[:, prompt].double().cpu()
        limit = bf16_limit(lm_path_layers(cfg), want)
        err = (dec[:, 0].double().cpu() - want).abs()
        over = float((err / limit).max())
        rec["decode_vs_forward"] = {
            "max_abs_err": float(err.max()), "limit_min": float(limit.min()),
            "err_over_limit": over,
            "prefill_last_max_abs_err": float(
                (logits[:, 0].double().cpu()
                 - fwd[:, prompt - 1].double().cpu()).abs().max())}
        check(over <= 1.0, f"{name}: decode logits at {prompt} differ from "
              f"forward's by {float(err.max())}, {over:.3g} times the bf16 "
              "limit")
        bytes_moved = lm_bytes(p, cache)
        del fwd, dec, logits, cache
        rec["prefill_ms"] = events_ms(lambda: tf.prefill(cfg, p, pre,
                                                         max_seq), LM_TIMED)
        _, cache = tf.prefill(cfg, p, pre, max_seq)
        tok = torch.as_tensor(toks[:, prompt:], device=card)
        steps = []
        for _ in range(LM_NEW):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, cache = tf.decode_step(cfg, p, cache, tok)
            end.record()
            end.synchronize()
            steps.append(start.elapsed_time(end))
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        # one more step (the cache's last slot) and a prefill, profiled
        rec["decode_profile"] = device_profile(
            lambda: tf.decode_step(cfg, p, cache, tok))
        rec["prefill_profile"] = device_profile(
            lambda: tf.prefill(cfg, p, pre, max_seq))
        del cache
    rec["decode_ms"] = float(np.median(steps))
    rec["decode_ms_min_max"] = [float(min(steps)), float(max(steps))]
    rec["decode_bound_ms"], rec["decode_bound_by"] = (
        bytes_moved / HBM_BYTES_PER_S * 1e3, "bytes")
    rec["decode_bytes"] = bytes_moved
    n_tok = LM_BATCH * prompt
    rec["prefill_bound_ms"] = max(
        bytes_moved / HBM_BYTES_PER_S,
        2 * cfg.param_count() * n_tok / BF16_TENSOR_OPS_PER_S) * 1e3
    generated = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generated.append(server.generate(toks[:, :prompt], LM_NEW, fe))
        rec["generate_s"] = time.perf_counter() - t0
    check(np.array_equal(*generated), f"{name}: two generate calls differ")
    check(generated[0].shape == (LM_BATCH, LM_NEW),
          f"{name}: generated {generated[0].shape}")
    rec["tokens_per_s"] = LM_BATCH * LM_NEW / rec["generate_s"]
    rec["decode_tokens_per_s"] = LM_BATCH / rec["decode_ms"] * 1e3
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del server, p
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def run_lm_phase(card_name: str, card: str = "cuda") -> dict:
    """The `lm` phase: (a) the smoke configs, card against CPU, while (d)
    the LM launcher serves a decoder and the encoder-decoder, each in a
    process of its own; then, alone on the card, (b) glm4-9b and (c)
    zamba2-1.2b at full width.  No hand-written kernel runs in it."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LM_LAUNCHERS)) as workers:
        procs = [workers.submit(launch_process, name)
                 for name in LM_LAUNCHERS]
        out = {"smokes": run_lm_smokes(card)}
        out["smokes_s"] = time.perf_counter() - t0
        results = [future.result() for future in procs]
    out["launchers"] = {}
    for name, proc, secs in results:
        rec, printed = read_launcher(name, proc, secs)
        check(any(line.startswith("[serve:lm] ") and " generated (2, 16) "
                  in line for line in printed),
              f"{name} printed no [serve:lm] line")
        out["launchers"][name] = {k: rec[k] for k in ("wall_s", "args",
                                                      "launches")}
    for name, prompt in LM_FULL.items():
        out[name] = run_lm_full(name, prompt, card)
        print(f"lm {name} ({card_name}): {json.dumps(out[name])}",
              flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out



# --------------------------------------------------------------------------
# The LM training slice: one train step of the ten smoke configs on the
# card against the CPU, internvl2-1b and zamba2-1.2b trained at full width
# through the `Trainer`, the training launcher and example
# --------------------------------------------------------------------------
LM_TRAIN_SEQ = 32        # smoke batches: B = LM_BATCH, S = 32
LM_TRAIN_LR = 1e-3       # adamw(lr=1e-3), as tests/test_torch_lm_train_step.py
LM_TRAIN_FULL = {"internvl2-1b": 4096, "zamba2-1.2b": 4096}   # train_4k
LM_TRAIN_STEPS = 10
LM_TRAIN_CKPT_EVERY = 5
LM_TRAIN_TIMED_FROM = 3  # steps whose CUDA-event times are the median
LM_TRAIN_LAUNCHERS = ("train_lm", "train_lm_example")
LM_TRAIN_CKPT_DIRS = ("build/lm_train/launcher", "build/lm_train/example")
LM_TRAIN_STATE_BYTES = 16    # f32 params, grads and AdamW's two moments
LM_TRAIN_FIT_ARCH = "glm4-9b"
LM_TRAIN_FRONTEND_SEED = 1000   # + step: the full-width runs' image embeddings


def lm_param_rule(grads: dict, params: dict, grad_norm: float) -> dict:
    """Per-element bound on |p_card - p_cpu| after one AdamW step from the
    same parameters (tests/test_torch_lm_train_step.py's `param_rule`,
    where it is derived): the gradient rule |dg| <= LM_PARITY (1 + |g|)
    carried through the first update -lr g' / (|g'| + eps), g' the
    clipped gradient, plus the roundings of the update and of p + u."""
    eps, clip = 1e-8, 1.0
    g = {k: v.double().abs() for k, v in grads.items()}
    dn = math.sqrt(sum(float(((LM_PARITY + LM_PARITY * v) ** 2).sum())
                       for v in g.values()))
    s = min(1.0, clip / (grad_norm + 1e-9))
    ds = max(0.0, min(1.0, clip / max(grad_norm - dn, 1e-30)) - s)
    out = {}
    for k, gk in g.items():
        d = s * (LM_PARITY + LM_PARITY * gk) + gk * ds
        m = (s * gk - d).clamp(min=0.0)
        out[k] = (LM_TRAIN_LR * (d * eps / (m + eps) ** 2).clamp(max=2.0)
                  + 2 * U * (params[k].double().abs() + 2 * LM_TRAIN_LR))
    return out


def lm_train_batch(cfg, seed: int) -> dict:
    """Numpy tokens, next-token-free random labels and, for vlm / audio,
    normal frontend embeddings, as the tests draw them."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (
        LM_BATCH, LM_TRAIN_SEQ)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (
            LM_BATCH, LM_TRAIN_SEQ)).astype(np.int32)}
    if cfg.frontend:
        batch["frontend_embeds"] = rng.normal(size=(
            LM_BATCH, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return batch


def lm_grads(cfg, params: dict, batch: dict) -> dict:
    """{path: gradient} of `steps.loss_fn` by autograd."""
    import torch
    from repro_torch.models import steps
    from repro_torch.models import transformer as tf
    leaves = dict(tf.tree_leaves(params))
    diff = {k: v.detach().requires_grad_() for k, v in leaves.items()}
    loss, _ = steps.loss_fn(cfg, tf.unflatten(diff), batch)
    return dict(zip(diff, torch.autograd.grad(loss, list(diff.values()))))


def lm_frontend(cfg, step: int) -> np.ndarray:
    """Seeded normal frontend embeddings for a full-width step, the ViT
    stub's stand-in (as the tests draw them).  All-zero embeddings, the
    launcher's, keep the image positions at exactly 0 through every
    block, where each rms_norm backward scales the gradient by
    1 / sqrt(eps): over internvl2-1b's 24 blocks it overflows f32, in the
    JAX package too (tests/test_torch_lm_train_step.py)."""
    return np.random.default_rng(LM_TRAIN_FRONTEND_SEED + step) \
        .standard_normal((LM_BATCH, cfg.frontend_seq, cfg.d_model),
                         dtype=np.float32)


def run_lm_train_smokes(card: str) -> dict:
    """(a) Each architecture's smoke config: one `make_train_step` on the
    card and on the CPU from one seeded set of f32 weights and one batch
    (TF32 off).  The gradients within rtol = atol = LM_PARITY, the step's
    loss and grad_norm within LM_PARITY, the parameters after the step
    within `lm_param_rule`."""
    import torch
    from repro_torch import configs
    from repro_torch.models import steps
    from repro_torch.models import transformer as tf
    from repro_torch.training import optimizer as opt
    out = {}
    for seed, name in enumerate(configs.ARCHS):
        cfg = configs.get(name, smoke=True)
        params = tf.init_params(cfg, torch.Generator().manual_seed(seed),
                                max_positions=LM_TRAIN_SEQ, device="cpu")
        batch = lm_train_batch(cfg, seed)
        runs = {}
        for device in ("cpu", card):
            p = {k: v.to(device, copy=True) for k, v in
                 tf.tree_leaves(params)}
            b = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
            grads = lm_grads(cfg, tf.unflatten(p), b)
            o = opt.adamw(lr=LM_TRAIN_LR)
            new, state, metrics = steps.make_train_step(cfg, o)(
                tf.unflatten(p), o.init(tf.unflatten(p)), b)
            runs[device] = (
                {k: v.cpu() for k, v in grads.items()},
                {k: v.cpu() for k, v in tf.tree_leaves(new)},
                {k: float(v) for k, v in metrics.items()})
        (g_cpu, p_cpu, m_cpu), (g_card, p_card, m_card) = runs["cpu"], \
            runs[card]
        grad_err = max(float((g_card[k] - g_cpu[k]).abs().max())
                       for k in g_cpu)
        for k in g_cpu:
            check(torch.allclose(g_card[k], g_cpu[k], rtol=LM_PARITY,
                                 atol=LM_PARITY),
                  f"{name}: card gradient {k} differs from the CPU's by "
                  f"{float((g_card[k] - g_cpu[k]).abs().max())}")
        for key in ("loss", "grad_norm", "ce", "aux"):
            check(abs(m_card[key] - m_cpu[key]) <= LM_PARITY * (
                1 + abs(m_cpu[key])), f"{name}: card {key} "
                f"{m_card[key]} against the CPU's {m_cpu[key]}")
        rule = lm_param_rule(g_cpu, p_cpu, m_cpu["grad_norm"])
        over, moved = 0.0, 0
        for k in p_cpu:
            err = (p_card[k].double() - p_cpu[k].double()).abs()
            over = max(over, float((err / rule[k]).max()))
            moved += int((err > 1e-5).sum())
        check(over <= 1.0, f"{name}: parameters after a card step differ "
              f"from the CPU's by {over:.3g} times the derived rule")
        out[name] = {"loss": m_card["loss"], "grad_max_abs_err": grad_err,
                     "loss_abs_err": abs(m_card["loss"] - m_cpu["loss"]),
                     "grad_norm_abs_err": abs(m_card["grad_norm"]
                                              - m_cpu["grad_norm"]),
                     "params_err_over_rule": over,
                     "params_moved_past_1e-5": moved}
    return out


def lm_train_flops(cfg, seq: int) -> tuple[float, dict]:
    """FLOPs of one remat train step at LM_BATCH x seq text tokens: 8 N T
    for the block weights (forward, the remat's second forward, and the
    backward's two products), T counting a vlm's frontend positions too;
    6 N T for the output head (outside the remat) over text tokens; and
    each attention application's score and value products, 4 B H S^2 hd
    a forward (the full masked square, as the port computes it), 4 times.
    The SSD's intra-chunk products and the embedding gather are left
    out."""
    from repro_torch.models import transformer as tf
    shapes = dict(tf.tree_leaves(tf.param_shapes(cfg)))
    size = {k: math.prod(v) for k, v in shapes.items()}
    head = size.get("lm_head", size["embed"] if cfg.tie_embeddings else 0)
    blocks = sum(v for k, v in size.items()
                 if k.startswith(("blocks/", "shared_attn/")))
    pos = seq + (cfg.frontend_seq if cfg.family == "vlm" else 0)
    apps = (tf.hybrid_n_apps(cfg) if cfg.family == "hybrid"
            else cfg.n_layers if cfg.n_heads else 0)
    shared = (sum(v for k, v in size.items() if k.startswith("shared_attn/"))
              * (apps - 1) if cfg.family == "hybrid" else 0)
    parts = {"blocks": 8 * (blocks + shared) * LM_BATCH * pos,
             "head": 6 * head * LM_BATCH * seq,
             "attention": 16 * LM_BATCH * cfg.n_heads * pos ** 2
             * cfg.resolved_head_dim * apps}
    return float(sum(parts.values())), parts


def first_differing_op(step, params, opt_state, batch) -> str | None:
    """Run `step` twice from copies of (`params`, `opt_state`), keeping for
    every floating tensor an op makes (op name, the sum of its float64
    values) on the device, and name the first op whose result differs
    between the runs, or None."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models import transformer as tf

    class Sums(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names, self.sums = [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                if torch.is_tensor(t) and t.is_floating_point():
                    self.names.append(str(func))
                    self.sums.append(t.detach().double().sum())
            return out

    def copy(tree):
        return tf.unflatten({k: v.clone() for k, v in tf.tree_leaves(tree)})

    runs = []
    for _ in range(2):
        p, o = copy(params), copy(opt_state)
        with Sums() as mode:
            step(p, o, batch)
        torch.cuda.synchronize()
        runs.append((mode.names, torch.stack(mode.sums).cpu()))
        del p, o
    (names, a), (_, b) = runs
    diff = (a != b) & ~(a.isnan() & b.isnan())
    return names[int(diff.nonzero()[0])] if bool(diff.any()) else None


ADAM_STEP_RATIO = 1.2    # |mhat| / sqrt(vhat) over AdamW's first ten steps


def run_lm_train_full(name: str, seq: int, card: str) -> dict:
    """(b), (c) One architecture trained at full width by the `Trainer` on
    `make_local_mesh(1)`: LM_TRAIN_STEPS steps at B = LM_BATCH, S = seq
    from `TokenSource` (vlm: `lm_frontend`'s embeddings), checkpoints every
    LM_TRAIN_CKPT_EVERY steps in a temporary directory.  Checks: finite
    losses, a lower mean over the second half than over the first; a
    fresh `Trainer` restored from the mid-run checkpoint and run to the
    end gives the uninterrupted run's losses, parameters and optimizer
    state bit for bit.  Where it does not, the first op whose result
    differs between two runs of one step is named, the losses are held to
    LM_PARITY and the parameters to sum_t 2 lr_t (1.2 + wd |p|): by
    Cauchy-Schwarz |mhat| / sqrt(vhat) <= 1.2 over AdamW's first ten steps
    (b1 = 0.9, b2 = 0.95), so one step moves a parameter by at most
    lr_t (1.2 + wd |p|).  Times: each step's CUDA events (the median from
    step LM_TRAIN_TIMED_FROM), tokens/s, peak memory, each checkpoint's
    save on the caller (the host copy) and the waits for its background
    write, the restore, one profiled step (its top operations by device
    time); the step's FLOP bound.  A vlm also records which gradient
    leaves go non-finite with all-zero frontend embeddings (`lm_frontend`:
    in either package)."""
    import gc
    import shutil

    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenSource
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import warmup_cosine
    from repro_torch.training.trainer import Trainer, TrainerConfig
    cfg = configs.get(name)
    positions = seq + (cfg.frontend_seq if cfg.family == "vlm" else 0)
    rec = {"arch": name, "batch": LM_BATCH, "seq": seq, "positions":
           positions, "steps": LM_TRAIN_STEPS, "remat": cfg.remat,
           "compute_dtype": cfg.compute_dtype}
    tcfg = TrainerConfig(total_steps=LM_TRAIN_STEPS,
                         ckpt_every=LM_TRAIN_CKPT_EVERY)
    ts = TokenSource(cfg.vocab_size, seq, LM_BATCH)

    def stream():
        step = 0
        while True:
            b = ts.next_batch(step)
            if cfg.frontend:
                b["frontend_embeds"] = lm_frontend(cfg, step)
            yield b
            step += 1

    def timed_trainer(ckpt_dir):
        """A `Trainer` whose steps record CUDA events, whose saves record
        their time on the caller (the host copy) and whose waits for a
        save's background write record how long they waited (the last:
        the whole write of the final checkpoint)."""
        tr = Trainer(cfg, make_local_mesh(1), ckpt_dir, tcfg)
        real_step, real_save = tr._step, tr.ckpt.save
        real_wait = tr.ckpt.wait
        tr.events, tr.save_s, tr.wait_s = [], [], []

        def step(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real_step(*args)
            end.record()
            tr.events.append((start, end))
            return out

        def save(step_no, tree, *, blocking=False):
            tr.ckpt.wait()
            t0 = time.perf_counter()
            real_save(step_no, tree, blocking=blocking)
            tr.save_s.append({"step": step_no, "blocking": blocking,
                              "s": time.perf_counter() - t0})

        def wait():
            pending = tr.ckpt._thread is not None
            t0 = time.perf_counter()
            real_wait()
            if pending:
                tr.wait_s.append(time.perf_counter() - t0)

        tr._step, tr.ckpt.save, tr.ckpt.wait = step, save, wait
        return tr, real_step

    def host(tree):
        return {k: v.cpu() for k, v in tf.tree_leaves(tree)}

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        tr, real_step = timed_trainer(run_dir)
        tr.init_or_restore()
        torch.cuda.synchronize()
        rec["init_s"] = time.perf_counter() - t0
        rec["params"] = sum(t.numel() for _, t in tf.tree_leaves(tr.params))
        rec["state_gb"] = LM_TRAIN_STATE_BYTES * rec["params"] / 1e9
        t0 = time.perf_counter()
        hist = tr.train(stream())
        rec["train_s"] = time.perf_counter() - t0
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        losses = [h["loss"] for h in hist]
        rec["losses"] = losses
        rec["grad_norms"] = [h["grad_norm"] for h in hist]
        half = LM_TRAIN_STEPS // 2
        check(len(losses) == LM_TRAIN_STEPS and all(
            math.isfinite(x) for x in losses), f"{name}: losses {losses}, "
            f"grad norms {rec['grad_norms']}")
        check(np.mean(losses[half:]) < np.mean(losses[:half]),
              f"{name}: the loss did not fall: {losses}")
        steps_ms = [a.elapsed_time(b) for a, b in tr.events]
        rec["step_ms_each"] = steps_ms
        rec["step_ms"] = float(np.median(steps_ms[LM_TRAIN_TIMED_FROM - 1:]))
        rec["tokens_per_s"] = LM_BATCH * seq / rec["step_ms"] * 1e3
        rec["saves"] = tr.save_s
        rec["write_waits_s"] = tr.wait_s
        rec["straggler_steps"] = tr.straggler_steps
        flops, parts = lm_train_flops(cfg, seq)
        rec["step_flops"], rec["step_flops_parts"] = flops, parts
        rec["step_bound_ms"] = flops / BF16_TENSOR_OPS_PER_S * 1e3
        rec["step_bound_by"] = "operations"
        rec["step_over_bound"] = rec["step_ms"] / rec["step_bound_ms"]
        want_params, want_state = host(tr.params), host(tr.opt_state)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        # resume from the mid-run checkpoint: the later ones go
        for later in range(half + 1, LM_TRAIN_STEPS + 1):
            shutil.rmtree(os.path.join(run_dir, f"step_{later:09d}"),
                          ignore_errors=True)
        tr2, real_step = timed_trainer(run_dir)
        t0 = time.perf_counter()
        tr2.init_or_restore()
        torch.cuda.synchronize()
        rec["restore_s"] = time.perf_counter() - t0
        check(tr2.step == half, f"{name}: resumed at step {tr2.step}")
        resumed = [h["loss"] for h in tr2.train(stream())]
        got_params, got_state = host(tr2.params), host(tr2.opt_state)
        same = resumed == losses[half:] and all(
            torch.equal(v, want_params[k]) for k, v in got_params.items()) \
            and all(torch.equal(v, want_state[k])
                    for k, v in got_state.items())
        rec["resume_bit_identical"] = same
        batch = tr2._batch(next(iter(stream())))
        if not same:
            rec["first_differing_op"] = first_differing_op(
                real_step, tr2.params, tr2.opt_state, batch)
            sched = warmup_cosine(tcfg.peak_lr, min(1000, LM_TRAIN_STEPS
                                                    // 10), LM_TRAIN_STEPS)
            lrs = [float(sched(torch.tensor(c))) for c in range(
                half + 1, LM_TRAIN_STEPS + 1)]
            over = 0.0
            for k, v in got_params.items():
                limit = sum(2 * lr * (ADAM_STEP_RATIO + 0.1 * want_params[k]
                                      .double().abs()) for lr in lrs)
                over = max(over, float(((v.double() - want_params[k]
                                         .double()).abs() / limit).max()))
            rec["resume_params_over_limit"] = over
            check(all(abs(a - b) <= LM_PARITY * (1 + abs(b))
                      for a, b in zip(resumed, losses[half:])),
                  f"{name}: resumed losses {resumed} against "
                  f"{losses[half:]}")
            check(over <= 1.0, f"{name}: resumed parameters {over:.3g} "
                  "times past sum_t 2 lr_t (1.2 + wd |p|)")
        del want_params, want_state, got_params, got_state
        if cfg.frontend:
            zero = {**batch, "frontend_embeds": torch.zeros_like(
                batch["frontend_embeds"])}
            grads = lm_grads(cfg, tr2.params, zero)
            rec["zero_frontend_nonfinite_leaves"] = sorted(
                k for k, v in grads.items() if not bool(torch.isfinite(v)
                                                       .all()))
            del grads, zero
        rec["profile"] = device_profile(
            lambda: real_step(tr2.params, tr2.opt_state, batch), top=8)
        del tr2, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def lm_train_fit(card_bytes: int) -> dict:
    """(e) The full training state of LM_TRAIN_FIT_ARCH (f32 params,
    grads and AdamW's two moments) against the card's memory, from its
    abstract parameters: nothing is allocated."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    cfg = configs.get(LM_TRAIN_FIT_ARCH)
    n = sum(t.numel() for _, t in tf.tree_leaves(tf.abstract_params(cfg)))
    need = LM_TRAIN_STATE_BYTES * n
    return {"arch": LM_TRAIN_FIT_ARCH, "params": n, "state_bytes": need,
            "card_bytes": card_bytes, "fits_one_card": need < card_bytes,
            "needs": "several cards: the lm_dist phase, "
            "scripts/lm_dist_probe.py"}


def run_lm_train_phase(card_name: str, card: str = "cuda") -> dict:
    """The `lm_train` phase: (a) the smoke configs' train step, card
    against CPU, while (d) the training launcher and example run, each in
    a process of its own; then, alone on the card, (b) internvl2-1b and
    (c) zamba2-1.2b trained at full width; (e) glm4-9b's training state
    against the card.  No hand-written kernel runs in it."""
    import shutil

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    for path in LM_TRAIN_CKPT_DIRS:
        shutil.rmtree(os.path.join(ROOT, path), ignore_errors=True)
    with ThreadPoolExecutor(len(LM_TRAIN_LAUNCHERS)) as workers:
        procs = [workers.submit(launch_process, name)
                 for name in LM_TRAIN_LAUNCHERS]
        out = {"smokes": run_lm_train_smokes(card)}
        out["smokes_s"] = time.perf_counter() - t0
        results = [future.result() for future in procs]
    out["launchers"] = {}
    for name, proc, secs in results:
        rec, printed = read_launcher(name, proc, secs)
        want = ("[train] glm4-9b-smoke: step 4, loss " if name == "train_lm"
                else "loss ")
        check(any(line.startswith(want) and (name == "train_lm"
                                              or " over 20 steps" in line)
                  for line in printed),
              f"{name} printed no {want!r} line")
        out["launchers"][name] = {k: rec[k] for k in ("wall_s", "args",
                                                      "launches")}
        out["launchers"][name]["line"] = next(
            line for line in printed if line.startswith(want))
    for path in LM_TRAIN_CKPT_DIRS:
        shutil.rmtree(os.path.join(ROOT, path), ignore_errors=True)
    for name, seq in LM_TRAIN_FULL.items():
        out[name] = run_lm_train_full(name, seq, card)
        print(f"lm_train {name} ({card_name}): {json.dumps(out[name])}",
              flush=True)
    out["fit"] = lm_train_fit(torch.cuda.get_device_properties(0)
                              .total_memory)
    out["seconds"] = time.perf_counter() - t0
    return out

LM_DIST_MAX_RANKS = 4    # one rank a visible card, at most this many
LM_DIST_RUN_ARCH = "glm4-9b"   # the smoke config of the 4-step run
LM_DIST_RUN_STEPS = 4
LM_DIST_RUN_EVERY = 2    # the checkpoint the elastic restore starts from
LM_DIST_DIR = "build/lm_dist"
LM_DIST_TIMEOUT = 600    # seconds a rank process may take
# (rtol, atol in lr) of the sharded step's parameters and optimizer state
# against the one-device update of the same gradients: the sums over
# sharded dims (the norm, Adafactor's means) round in another order
LM_DIST_REPLAY = {"params": (2 * U, 1e-4), "state": (1e-5, 0.0)}


def lm_dist_shapes(world: int) -> tuple:
    """The phase's mesh and the one its run is restored onto: (W // 2, 2)
    and (1, W) on an even W >= 2, else (1, W) both ways."""
    if world >= 2 and world % 2 == 0:
        return (world // 2, 2), (1, world)
    return (1, world), (1, world)


def lm_dist_optimizer(cfg, lr: float, kind: str = ""):
    """A constant-rate optimizer of `kind`, by default the kind the
    config's trainer makes (`optimizer.make`), without weight decay."""
    from repro_torch.training import optimizer as opt
    kind = kind or opt.make(cfg).kind
    return {"adamw": opt.adamw, "adafactor": opt.adafactor,
            "sgd": opt.sgd}[kind](lr=lr)


def lm_dist_step_pair(cfg, mesh, params: dict, batch: dict, optimizer,
                      seq: int) -> dict:
    """One step of `make_train_step` on one device and the same step on
    DTensor leaves placed by the trainer's specs on `mesh`, from the same
    parameters (`params`: {path: tensor}, alike on every rank, on this
    rank's device) and numpy `batch`:

      one:     gradients, parameters, optimizer state and metrics of the
               one-device step;
      sharded: the same of the sharded step (each tensor gathered whole),
               its metrics' types and `count`;
      replay:  the one-device optimizer update applied to the sharded
               step's gradients (parameters and state), which holds the
               sharded optimizer to the plain one on equal gradients.

    `chip_smoke.py`'s lm_dist phase and the CPU tests
    (`tests/torch_dist_worker.py`) both compare through this."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import steps
    from repro_torch.models import transformer as tf
    device = next(iter(params.values())).device
    o, step = optimizer, steps.make_train_step(cfg, optimizer)

    def flat(tree) -> dict:
        return {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                for k, v in tf.tree_leaves(tree)}

    def plain_step(grads: dict | None) -> dict:
        p = tf.unflatten({k: v.clone() for k, v in params.items()})
        if grads is None:
            new, state, metrics = step(p, o.init(p), b)
            return {"params": flat(new), "state": flat(state),
                    "metrics": {k: float(v) for k, v in metrics.items()}}
        with torch.no_grad():
            u, state = o.update(tf.unflatten(grads), o.init(p), p)
            u = dict(tf.tree_leaves(u))
            new = {k: v + u[k].to(v.dtype) for k, v in tf.tree_leaves(p)}
        return {"params": new, "state": flat(state)}

    b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    one = {"grads": lm_grads(cfg, tf.unflatten(params), b),
           **plain_step(None)}
    specs = dict(tf.tree_leaves(shd.param_specs(cfg, mesh,
                                                max_positions=seq)))
    placed = {k: shd.place(v.clone(), mesh, specs[k], src_data_rank=None)
              for k, v in params.items()}
    sb = shard_batch(batch, mesh, shd.P(shd.dp_axes(mesh)))
    with implicit_replication():
        grads = {k: g.redistribute(placed[k].device_mesh,
                                   placed[k].placements).full_tensor()
                 for k, g in lm_grads(cfg, tf.unflatten(placed),
                                      sb).items()}
    p = tf.unflatten(placed)
    new, state, metrics = step(p, o.init(p), sb)
    sharded = {"grads": grads, "params": flat(new), "state": flat(state),
               "metrics": {k: float(v) for k, v in metrics.items()},
               "metric_types": sorted({type(v).__name__
                                       for v in metrics.values()}),
               "count": int(state["count"].full_tensor())}
    return {"one": one, "sharded": sharded, "replay": plain_step(grads)}


# the models' mesh branches (ROADMAP A11c-ii): each smoke config with the
# branches JAX's perf variants name (`launch/perf.py`): ring attention
# with sequence parallelism in the dense / moe / vlm stacks (mixtral's
# sliding window keeps the plain attention), flash decode in every family
# with a KV cache
LM_MESH_CASES = (("glm4-9b", "ring"), ("kimi-k2-1t-a32b", "ring"),
                 ("internvl2-1b", "ring"), ("mixtral-8x22b", "ring"),
                 ("glm4-9b", "flash"), ("zamba2-1.2b", "flash"),
                 ("whisper-small", "flash"))
LM_MESH_VARIANTS = {"ring": {"attention_impl": "ring",
                             "sequence_parallel": True},
                    "flash": {"flash_decode": True}}
LM_MESH_DECODE = 3       # decode steps after the prefill
LM_MESH_MAX_SEQ = 64     # the serving cache: S + 32, split 2 and 4 ways


def lm_mesh_config(name: str, variant: str):
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get(name, smoke=True),
                               **LM_MESH_VARIANTS[variant])


def lm_mesh_pair(cfg, mesh, params: dict, batch: dict, decode: np.ndarray,
                 plain_mesh: bool = False) -> dict:
    """`cfg`'s mesh branches on `mesh` against mesh=None, from the same
    parameters ({path: tensor}, alike on every rank, on this rank's
    device), numpy `batch` (tokens, labels, frontend) and `decode`
    tokens (steps, B, 1).  Each side's record: forward's logits, the
    `loss_fn` gradients (what `make_train_step` differentiates), one
    SGD `make_train_step`'s loss and grad_norm, then `make_prefill_step`'s
    logits, each `make_decode_step`'s logits and the cache after them,
    every tensor whole on this rank.

      one:   mesh=None on plain tensors;
      mesh:  mesh=mesh on DTensor leaves placed by the trainer's specs,
             the batch over the data axes (the prefill's cache placed by
             `cache_specs`);
      plain_mesh (with `plain_mesh`): mesh=mesh on the plain tensors
             (each collective takes and returns whole values).

    `chip_smoke.py`'s lm_dist phase and the CPU tests
    (`tests/torch_dist_worker.py`) both compare through this."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import steps
    from repro_torch.models import transformer as tf
    from repro_torch.training import optimizer as opt
    device = next(iter(params.values())).device
    seq = batch["tokens"].shape[1]

    def whole(x):
        if isinstance(x, dict):
            return {k: whole(v) for k, v in x.items()}
        return (x.full_tensor() if isinstance(x, DTensor) else x).detach()

    def side(tree, b, m, place_batch) -> dict:
        cast = (lambda a: shard_batch(a, m, shd.P(shd.dp_axes(m)))) \
            if place_batch else (lambda a: {
                k: torch.as_tensor(v, device=device) for k, v in a.items()})
        bt = cast(b)
        rec = {}
        with implicit_replication():
            rec["logits"] = whole(tf.forward(cfg, tree, bt, mesh=m)[0])
            leaves = dict(tf.tree_leaves(tree))
            diff = {k: v.detach().requires_grad_()
                    for k, v in leaves.items()}
            loss, _ = steps.loss_fn(cfg, tf.unflatten(diff), bt, mesh=m)
            rec["grads"] = {k: whole(g) for k, g in zip(diff, torch.autograd
                                                         .grad(loss, list(
                                                             diff.values())))}
        o = opt.sgd(lr=LM_TRAIN_LR)
        p = tf.unflatten({k: v.clone() for k, v in leaves.items()})
        _, _, metrics = steps.make_train_step(cfg, o, mesh=m)(
            p, o.init(p), bt)
        rec["metrics"] = {k: float(v) for k, v in metrics.items()}
        prompt = {k: v for k, v in b.items() if k != "labels"}
        logits, cache = steps.make_prefill_step(cfg, LM_MESH_MAX_SEQ,
                                                mesh=m)(tree, cast(prompt))
        rec["prefill"] = whole(logits)
        rec["cache_placements"] = {
            k: [repr(p) for p in v.placements] for k, v in cache.items()
            if isinstance(v, DTensor)}
        step = steps.make_decode_step(cfg, mesh=m)
        rec["decode"] = []
        for tokens in decode:
            logits, cache = step(tree, cache,
                                 cast({"tokens": tokens})["tokens"])
            rec["decode"].append(whole(logits))
        rec["cache"] = whole(cache)
        return rec

    plain = tf.unflatten(params)
    out = {"one": side(plain, batch, None, False)}
    specs = dict(tf.tree_leaves(shd.param_specs(cfg, mesh,
                                                max_positions=seq)))
    placed = tf.unflatten({k: shd.place(v.clone(), mesh, specs[k],
                                        src_data_rank=None)
                           for k, v in params.items()})
    out["mesh"] = side(placed, batch, mesh, True)
    if plain_mesh:
        out["plain_mesh"] = side(plain, batch, mesh, False)
    return out


def lm_mesh_inputs(cfg, seed: int) -> tuple:
    """(params {path: tensor on the CPU}, numpy batch, decode tokens) of
    one mesh case: f32 weights drawn by `init_params`, the batch of the
    step checks and LM_MESH_DECODE steps of one token a row."""
    import torch
    from repro_torch.models import transformer as tf
    params = dict(tf.tree_leaves(tf.init_params(
        cfg, torch.Generator().manual_seed(seed),
        max_positions=LM_MESH_MAX_SEQ, device="cpu")))
    decode = np.random.default_rng(seed + 100).integers(
        0, cfg.vocab_size, (LM_MESH_DECODE, LM_BATCH, 1)).astype(np.int32)
    return params, lm_train_batch(cfg, seed), decode


def lm_dist_step_checks(mesh, device, world: int) -> dict:
    """Each smoke config's sharded step held to the one-device step on
    this rank's device from the same parameters and batch
    (`lm_dist_step_pair`), with the optimizer its trainer makes (AdamW),
    and kimi-k2 once more with its full config's Adafactor and glm4-9b
    with SGD: at world 1 bit for bit,
    gradients, parameters, optimizer state and metrics; else the
    gradients, loss and grad_norm within rtol = atol = LM_PARITY, AdamW's
    parameters within `lm_param_rule`, and every optimizer's parameters
    and state within rounding of the one-device update replayed on the
    sharded gradients (LM_DIST_REPLAY)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    out = {}
    cases = [(name, "") for name in configs.ARCHS] + [
        ("kimi-k2-1t-a32b", "adafactor"), (LM_DIST_RUN_ARCH, "sgd")]
    for seed, (name, kind) in enumerate(cases):
        cfg = configs.get(name, smoke=True)
        params = {k: v.to(device) for k, v in tf.tree_leaves(tf.init_params(
            cfg, torch.Generator().manual_seed(seed),
            max_positions=LM_TRAIN_SEQ, device="cpu"))}
        o = lm_dist_optimizer(cfg, LM_TRAIN_LR, kind)
        pair = lm_dist_step_pair(cfg, mesh, params,
                                 lm_train_batch(cfg, seed), o, LM_TRAIN_SEQ)
        one, got, replay = pair["one"], pair["sharded"], pair["replay"]
        key = f"{name}/{o.kind}"
        errs = {what: max(float((got[what][k] - one[what][k]).abs().max())
                          for k in one[what] if one[what][k].numel())
                for what in ("grads", "params", "state")}
        check(got["metric_types"] == ["Tensor"] and got["count"] == 1,
              f"lm_dist {key}: metrics {got['metric_types']}, count "
              f"{got['count']}")
        if world == 1:
            for what in ("grads", "params", "state"):
                for k, want in one[what].items():
                    check(torch.equal(got[what][k], want),
                          f"lm_dist {key}: world-1 {what} {k} differs "
                          f"from the one-device step's by "
                          f"{errs[what]}")
            check(got["metrics"] == one["metrics"],
                  f"lm_dist {key}: world-1 metrics {got['metrics']} "
                  f"against the one-device step's {one['metrics']}")
            over = 0.0
        else:
            for k, want in one["grads"].items():
                check(torch.allclose(got["grads"][k], want, rtol=LM_PARITY,
                                     atol=LM_PARITY),
                      f"lm_dist {key}: sharded gradient {k} differs from "
                      f"the one-device step's by {errs['grads']}")
            for m in ("loss", "grad_norm", "ce", "aux"):
                check(abs(got["metrics"][m] - one["metrics"][m])
                      <= LM_PARITY * (1 + abs(one["metrics"][m])),
                      f"lm_dist {key}: sharded {m} {got['metrics'][m]} "
                      f"against the one-device step's {one['metrics'][m]}")
            for what in ("params", "state"):
                rtol, atol = LM_DIST_REPLAY[what]
                for k, want in replay[what].items():
                    check(torch.allclose(got[what][k], want, rtol=rtol,
                                         atol=atol * LM_TRAIN_LR),
                          f"lm_dist {key}: sharded {what} {k} against the "
                          f"one-device update of the same gradients")
            over = None
            if o.kind == "adamw":
                rule = lm_param_rule(
                    {k: v.cpu() for k, v in one["grads"].items()},
                    {k: v.cpu() for k, v in one["params"].items()},
                    one["metrics"]["grad_norm"])
                over = max(float(((got["params"][k] - v).double().abs()
                                  .cpu() / rule[k]).max())
                           for k, v in one["params"].items())
                check(over <= 1.0, f"lm_dist {key}: parameters after the "
                      f"sharded step differ by {over:.3g} times the rule")
        out[key] = {"loss": got["metrics"]["loss"],
                    "grad_max_abs_err": errs["grads"],
                    "param_max_abs_err": errs["params"],
                    "state_max_abs_err": errs["state"],
                    "bit_for_bit": not any(errs.values())
                    and got["metrics"] == one["metrics"],
                    "params_err_over_rule": over}
    return out


LM_MESH_SUM_TOL = 1e-6   # a collective against its one-process emulation
#                          where a sum over the shards rounds in another
#                          order (flash decode's two SUM all-reduces)
LM_MESH_MM_TOL = 1e-3    # the ring matmul against x @ W (JAX's test's)
LM_MESH_BODIES = 4       # shards the one-card body checks emulate


def lm_mesh_errors(got: dict, want: dict) -> dict:
    """Largest |got - want| of each field of two `lm_mesh_pair` sides."""
    def err(a, b):
        return float((a.double() - b.double()).abs().max()) if a.numel() \
            else 0.0
    return {"logits": err(got["logits"], want["logits"]),
            "grads": max(err(got["grads"][k], v)
                         for k, v in want["grads"].items()),
            "prefill": err(got["prefill"], want["prefill"]),
            "decode": max(err(a, b) for a, b in zip(got["decode"],
                                                    want["decode"])),
            "cache": max(err(got["cache"][k], v)
                         for k, v in want["cache"].items()),
            "loss": abs(got["metrics"]["loss"] - want["metrics"]["loss"]),
            "grad_norm": abs(got["metrics"]["grad_norm"]
                             - want["metrics"]["grad_norm"])}


def lm_mesh_within(got: dict, want: dict, tol: float) -> bool:
    """Every tensor of `got` within rtol = atol = `tol` of `want`'s."""
    import torch

    def close(a, b):
        return torch.allclose(a.double(), b.double(), rtol=tol, atol=tol)
    pairs = [(got["logits"], want["logits"]), (got["prefill"],
                                               want["prefill"])]
    pairs += [(got["grads"][k], v) for k, v in want["grads"].items()]
    pairs += list(zip(got["decode"], want["decode"]))
    pairs += [(got["cache"][k], v) for k, v in want["cache"].items()]
    metrics = all(abs(got["metrics"][m] - want["metrics"][m])
                  <= tol * (1 + abs(want["metrics"][m]))
                  for m in ("loss", "grad_norm"))
    return metrics and all(close(a, b) for a, b in pairs)


def lm_mesh_checks(mesh, device, world: int) -> dict:
    """Each LM_MESH_CASES config's mesh branches on `mesh`
    (`lm_mesh_pair`): forward, gradients, a train step, prefill and
    decode steps within rtol = atol = LM_PARITY of mesh=None; at world 1
    also the DTensor path bit for bit the plain tensors' mesh path.  (At
    world 1 the ring and flash decode still run their online softmax, as
    JAX's do at model = 1, so they round otherwise than mesh=None's
    softmax.)"""
    out = {}
    for seed, (name, variant) in enumerate(LM_MESH_CASES):
        cfg = lm_mesh_config(name, variant)
        params, batch, decode = lm_mesh_inputs(cfg, seed)
        params = {k: v.to(device) for k, v in params.items()}
        pair = lm_mesh_pair(cfg, mesh, params, batch, decode,
                            plain_mesh=world == 1)
        key = f"{name}/{variant}"
        errs = lm_mesh_errors(pair["mesh"], pair["one"])
        check(lm_mesh_within(pair["mesh"], pair["one"], LM_PARITY),
              f"lm_dist mesh {key}: the mesh branches differ from "
              f"mesh=None by {errs}")
        rec = {"vs_one": errs}
        if world == 1:
            rec["vs_plain_mesh"] = lm_mesh_errors(pair["mesh"],
                                                  pair["plain_mesh"])
            check(not any(rec["vs_plain_mesh"].values()),
                  f"lm_dist mesh {key}: at world 1 the DTensor path "
                  f"differs from the plain mesh path by "
                  f"{rec['vs_plain_mesh']}")
        out[key] = rec
    return out


# the MoE expert products (`moe._expert_product`): each smoke MoE config
# by its own placements, and the layouts whose weights share a mesh dim
# with the tokens (mixtral with FSDP, kimi-k2 as expert2d)
LM_MOE_CASES = (("mixtral-8x22b", {}), ("mixtral-8x22b", {"fsdp": True}),
                ("kimi-k2-1t-a32b", {}),
                ("kimi-k2-1t-a32b", {"moe_shard": "expert2d"}))
LM_MOE_TOKENS = 256      # 4 routing groups of the smoke configs' 64


def lm_moe_key(name: str, over: dict) -> str:
    return name + "".join(f"/{k}={v}" for k, v in over.items())


def lm_moe_config(name: str, over: dict):
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get(name, smoke=True), **over)


def lm_moe_run(cfg, weights: dict, x, dy) -> dict:
    """`moe_ffn` forward and backward under an op counter: the output
    and the gradients of x and the weights (whole, as numpy), and the
    FLOPs of the expert products a device: the batched products whose
    batch dim is the experts or a shard of them (the combine's is the
    tokens)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import hlo_analysis as hlo
    from repro_torch.models import moe, steps

    def whole(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().cpu().numpy().copy()
    leaves = {k: v.detach().requires_grad_() for k, v in
              {"x": x, **weights}.items()}
    with steps._replicating(weights), hlo.counting() as counter:
        y, _ = moe.moe_ffn(leaves["x"], leaves["router"], leaves["w_gate"],
                           leaves["w_in"], leaves["w_out"],
                           top_k=cfg.experts_per_token,
                           group_size=cfg.moe_group_size,
                           capacity_factor=cfg.moe_capacity_factor)
        y = y.full_tensor() if isinstance(y, DTensor) else y
        (y * dy).sum().backward()
    return {"y": whole(y), "grads": {k: whole(v.grad)
                                     for k, v in leaves.items()},
            "flops": sum(f for (name, shapes), f in counter.products.items()
                         if name == "bmm"
                         and cfg.n_experts % shapes[0][0] == 0)}


def lm_moe_pair(cfg, mesh, seed: int, device) -> dict:
    """`cfg`'s `moe_ffn` (one block's weights, LM_MOE_TOKENS tokens, seeded)
    on one device and on `mesh`, the weights placed by `param_specs` and
    the tokens sharded on data: {"one", "sharded": `lm_moe_run`,
    "placements"}."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tf
    specs = shd.param_specs(cfg, mesh)["blocks"]
    shapes = tf.param_shapes(cfg)["blocks"]
    gen = torch.Generator().manual_seed(seed)
    weights = {k: 0.1 * torch.randn(tuple(shapes[k])[1:], generator=gen)
               for k in ("router", "w_gate", "w_in", "w_out")}
    x, dy = (torch.randn((LM_MOE_TOKENS, cfg.d_model), generator=gen)
             for _ in range(2))
    placed = {k: shd.place(v, mesh, shd.P(*tuple(specs[k])[1:]),
                           src_data_rank=None) for k, v in weights.items()}
    return {"one": lm_moe_run(cfg, {k: v.to(device)
                                    for k, v in weights.items()},
                              x.to(device), dy.to(device)),
            "sharded": lm_moe_run(cfg, placed, shd.place(
                x, mesh, shd.P("data", None), src_data_rank=None),
                dy.to(device)),
            "placements": {k: [repr(p) for p in v.placements]
                           for k, v in placed.items()}}


def lm_moe_checks(mesh, world: int, device) -> dict:
    """Each LM_MOE_CASES config's `lm_moe_pair`: output and gradients
    within rtol = atol = LM_PARITY of the one-device run, and the expert
    products' FLOPs a device the one-device run's over `world` (no
    weight dim gathered where the work could stay split)."""
    import numpy as np
    out = {}
    for seed, (name, over) in enumerate(LM_MOE_CASES):
        key = lm_moe_key(name, over)
        pair = lm_moe_pair(lm_moe_config(name, over), mesh, seed, device)
        one, sharded = pair["one"], pair["sharded"]
        errs = {k: float(np.abs(sharded["grads"][k] - v).max())
                for k, v in one["grads"].items()}
        errs["y"] = float(np.abs(sharded["y"] - one["y"]).max())
        within = np.allclose(sharded["y"], one["y"], rtol=LM_PARITY,
                             atol=LM_PARITY) and all(
            np.allclose(sharded["grads"][k], v, rtol=LM_PARITY,
                        atol=LM_PARITY) for k, v in one["grads"].items())
        check(within, f"lm_dist moe {key}: the sharded moe_ffn differs "
              f"from one device's by {errs}")
        check(sharded["flops"] * world == one["flops"] > 0,
              f"lm_dist moe {key}: {sharded['flops']} expert FLOPs a "
              f"device on {world} ranks against {one['flops']} on one")
        out[key] = {"errs": errs, "flops": sharded["flops"],
                    "one_flops": one["flops"],
                    "placements": pair["placements"]}
    return out


def lm_collective_checks(mesh, device, world: int) -> dict:
    """The four collectives on the rank's mesh at the glm4-9b smoke
    shapes, f32: each against the one-process emulation of its shard
    bodies at the mesh's shard count (the rings bit for bit, flash decode
    within LM_MESH_SUM_TOL; at world 1 bit for bit) and against the plain
    function (the attentions and ring attention's gradient within
    LM_PARITY, the matmul within LM_MESH_MM_TOL); the int8 all-reduce
    over "data", two steps with the residuals carried, bit for bit its
    emulation (shared scale, int32 sums)."""
    import torch
    from repro_torch import configs
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import runtime
    from repro_torch.models import layers as ll
    cfg = configs.get("glm4-9b", smoke=True)
    B, S, H, KVH = LM_BATCH, LM_TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads
    Dh = cfg.resolved_head_dim
    n, data = mesh.shape["model"], mesh.shape["data"]
    idx = runtime.rank() % n                     # the rank's "model" index
    gen = torch.Generator(device=device).manual_seed(SEED)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def err(a, b):
        return float((a.double() - b.double()).abs().max())

    out = {}
    q, k, v, ct = rand(B, S, H, Dh), rand(B, S, KVH, Dh), \
        rand(B, S, KVH, Dh), rand(B, S, H, Dh)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    got = C.ring_attention(mesh)(*qkv)
    grads = torch.autograd.grad((got * ct).sum(), qkv)
    plain_in = [t.clone().requires_grad_() for t in (q, k, v)]
    want = ll.attention(*plain_in)
    want_grads = torch.autograd.grad((want * ct).sum(), plain_in)
    got, want = got.detach(), want.detach()
    emulated = C.emulate_ring_attention(q, k, v, n)
    out["ring_attention"] = {"vs_emulated": err(got, emulated),
                             "vs_plain": err(got, want),
                             "grad_vs_plain": max(map(err, grads,
                                                      want_grads))}
    check(torch.equal(got, emulated), f"lm_dist ring_attention differs "
          f"from its emulation by {err(got, emulated)}")
    check(torch.allclose(got, want, rtol=LM_PARITY, atol=LM_PARITY),
          f"lm_dist ring_attention: {out['ring_attention']}")
    check(all(torch.allclose(a, b, rtol=LM_PARITY, atol=LM_PARITY)
              for a, b in zip(grads, want_grads)),
          f"lm_dist ring_attention's gradient: {out['ring_attention']}")

    qd = q[:, 0].contiguous()
    valid = torch.tensor(S - 7, dtype=torch.int32, device=device)
    got = C.flash_decode(mesh)(qd, k, v, valid)
    emulated = C.emulate_flash_decode(qd, k, v, valid, n)
    want = ll.decode_attention(qd[:, None], k, v, valid)[:, 0]
    out["flash_decode"] = {"vs_emulated": err(got, emulated),
                           "vs_plain": err(got, want)}
    check(torch.equal(got, emulated) if world == 1 else torch.allclose(
        got, emulated, rtol=LM_MESH_SUM_TOL, atol=LM_MESH_SUM_TOL),
        f"lm_dist flash_decode against its emulation: "
        f"{out['flash_decode']}")
    check(torch.allclose(got, want, rtol=LM_PARITY, atol=LM_PARITY),
          f"lm_dist flash_decode: {out['flash_decode']}")

    x, w = rand(4 * B, cfg.d_model), rand(cfg.d_model, cfg.d_ff)
    got = C.ring_allgather_matmul(mesh)(x, w)
    emulated = C.emulate_ring_allgather_matmul(x, w, n)[idx]
    out["ring_allgather_matmul"] = {"vs_emulated": err(got, emulated),
                                    "vs_plain": err(got, x @ w)}
    check(torch.equal(got, emulated), f"lm_dist ring_allgather_matmul "
          f"against its emulation: {out['ring_allgather_matmul']}")
    check(torch.allclose(got, x @ w, rtol=LM_MESH_MM_TOL,
                         atol=LM_MESH_MM_TOL),
          f"lm_dist ring_allgather_matmul: {out['ring_allgather_matmul']}")

    # every rank draws every data shard's gradients; its own is row
    # rank // n, as the "data" index of a (data, model) mesh
    g_all = [rand(data, cfg.d_model) for _ in range(2)]
    me = runtime.rank() // n
    resid = {"w": torch.zeros(cfg.d_model, device=device)}
    resid_all = torch.zeros(data, cfg.d_model, device=device)
    worst = 0.0
    for g in g_all:
        mean, resid = C.compressed_psum_grads({"w": g[me]}, resid,
                                              mesh=mesh, axis="data")
        local = g + resid_all
        scale = local.abs().amax() / 127.0 + 1e-12
        q8 = torch.clamp(torch.round(local / scale), -127, 127) \
            .to(torch.int8)
        want_mean = q8.to(torch.int32).sum(0).to(torch.float32) \
            * scale / data
        resid_all = local - q8.to(torch.float32) * scale
        worst = max(worst, err(mean["w"], want_mean),
                    err(resid["w"], resid_all[me]))
    out["compressed_psum_grads"] = {"vs_emulated": worst}
    check(worst == 0.0, f"lm_dist compressed_psum_grads differs from its "
          f"emulation by {worst}")
    return out


def lm_shard_body_checks(device) -> dict:
    """Each collective's shard bodies at n = LM_MESH_BODIES on this one
    card, fed the blocks in the order each ring delivers them
    (`collectives.emulate_*`), at the glm4-9b smoke shapes in bf16 and
    f32, against the plain attention, the plain decode attention and the
    plain product: f32 within LM_PARITY (the matmul LM_MESH_MM_TOL), bf16
    within the bf16 rule of one block (`bf16_limit(1, ...)`)."""
    import torch
    from repro_torch import configs
    from repro_torch.distributed import collectives as C
    from repro_torch.models import layers as ll
    cfg = configs.get("glm4-9b", smoke=True)
    B, S, H, KVH = LM_BATCH, LM_TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads
    Dh, n = cfg.resolved_head_dim, LM_MESH_BODIES
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        def rand(*shape):
            return torch.randn(shape, generator=gen,
                               device=device).to(dtype)
        q, k, v = rand(B, S, H, Dh), rand(B, S, KVH, Dh), rand(B, S, KVH, Dh)
        x, w = rand(4 * B, cfg.d_model), rand(cfg.d_model, cfg.d_ff)
        valid = torch.tensor(S - 7, dtype=torch.int32, device=device)
        cases = {
            "ring_attention": ([C.emulate_ring_attention(q, k, v, n)],
                               ll.attention(q, k, v), LM_PARITY),
            "flash_decode": ([C.emulate_flash_decode(q[:, 0], k, v, valid,
                                                     n)],
                             ll.decode_attention(q[:, :1], k, v,
                                                 valid)[:, 0], LM_PARITY),
            "ring_allgather_matmul": (
                C.emulate_ring_allgather_matmul(x, w, n),
                (x.float() @ w.float()), LM_MESH_MM_TOL)}
        rec = {}
        for name, (gots, want, tol) in cases.items():
            want = want.float()
            limit = bf16_limit(1, want) if dtype == torch.bfloat16 else \
                tol + tol * want.abs()
            over = max(float(((got.float() - want).abs() / limit).max())
                       for got in gots)
            rec[name] = {"max_abs_err": max(float((got.float() - want)
                                                  .abs().max())
                                            for got in gots),
                         "err_over_limit": over}
            check(over <= 1.0, f"lm_dist shard body {name} ({dtype}, n = "
                  f"{n}) is {over:.3g} times its limit from the plain "
                  f"function")
        out[str(dtype).replace("torch.", "")] = rec
    return out


def lm_dist_run(shape_a, shape_b, device_type: str, world: int,
                ckpt: str) -> dict:
    """LM_DIST_RUN_ARCH's smoke config trained LM_DIST_RUN_STEPS steps by
    the sharded `Trainer` on `shape_a`, checkpointing every
    LM_DIST_RUN_EVERY; the first checkpoint restored by a `Trainer` on
    `shape_b` with FSDP on (other specs: an elastic restore) and run to
    the end.  Its losses within LM_PARITY of the uninterrupted run's (at
    world 1, where both meshes are (1, 1), bit for bit, and so are the
    parameters); its parameters within 2 lr a step of them."""
    import dataclasses
    import shutil

    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenSource
    from repro_torch.distributed import runtime
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.training.trainer import Trainer, TrainerConfig
    cfg = configs.get(LM_DIST_RUN_ARCH, smoke=True)
    tcfg = TrainerConfig(total_steps=LM_DIST_RUN_STEPS,
                         ckpt_every=LM_DIST_RUN_EVERY, peak_lr=LM_TRAIN_LR)
    ts = TokenSource(cfg.vocab_size, LM_TRAIN_SEQ, LM_BATCH)

    def batches():
        step = 0
        while True:
            yield ts.next_batch(step)
            step += 1

    first, second = os.path.join(ckpt, "a"), os.path.join(ckpt, "b")
    t0 = time.perf_counter()
    whole = Trainer(cfg, make_local_mesh(model=shape_a[1],
                                         device=device_type), first, tcfg)
    whole.init_or_restore()
    want = {h["step"]: h["loss"] for h in whole.train(batches())}
    whole_params = {k: v.full_tensor() for k, v in
                    tf.tree_leaves(whole.params)}
    if runtime.is_primary():
        shutil.copytree(os.path.join(first, f"step_{LM_DIST_RUN_EVERY:09d}"),
                        os.path.join(second,
                                     f"step_{LM_DIST_RUN_EVERY:09d}"))
    runtime.barrier()
    fsdp = dataclasses.replace(cfg, fsdp=True)
    resumed = Trainer(fsdp, make_local_mesh(model=shape_b[1],
                                            device=device_type),
                      second, tcfg)
    check(resumed.restore() and resumed.step == LM_DIST_RUN_EVERY,
          "lm_dist: the elastic restore found no checkpoint")
    got = {h["step"]: h["loss"] for h in resumed.train(batches())}
    check(sorted(got) == list(range(LM_DIST_RUN_EVERY + 1,
                                    LM_DIST_RUN_STEPS + 1)),
          f"lm_dist: the resumed run ran steps {sorted(got)}")
    loss_err = max(abs(got[s] - want[s]) for s in got)
    params = {k: v.full_tensor() for k, v in tf.tree_leaves(resumed.params)}
    param_err = max(float((params[k] - whole_params[k]).abs().max())
                    for k in params)
    steps_left = LM_DIST_RUN_STEPS - LM_DIST_RUN_EVERY
    if world == 1:
        check(got == {s: want[s] for s in got} and param_err == 0.0,
              f"lm_dist: the world-1 resumed run differs from the "
              f"uninterrupted one (losses {loss_err}, parameters "
              f"{param_err})")
    else:
        check(loss_err <= LM_PARITY * (1 + max(abs(v) for v in got.values())),
              f"lm_dist: resumed losses {got} against {want}")
        check(param_err <= 2 * LM_TRAIN_LR * steps_left + 1e-6,
              f"lm_dist: resumed parameters differ by {param_err}")
    return {"arch": cfg.name, "mesh": list(shape_a),
            "restored_onto": list(shape_b), "fsdp_after_restore": True,
            "losses": want, "resumed_losses": got,
            "loss_max_abs_err": loss_err,
            "param_max_abs_err": param_err,
            "seconds": time.perf_counter() - t0}


def run_lm_dist_rank(rank: int, world: int, rendezvous: str,
                     out_dir: str, device_type: str = "cuda") -> None:
    """`python3 chip_smoke.py --lm-dist-rank RANK WORLD FILE DIR`: one
    rank of the lm_dist phase, on its card (`LOCAL_RANK`; NCCL, or gloo
    with ``device_type="cpu"``, a rehearsal).  Prints its record as its
    last line; any failed check exits 1 (`check`)."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if device_type == "cuda" and not torch.cuda.is_available():
        fail("no CUDA device; this script measures the port on the card")
    from repro_torch.distributed import runtime
    from repro_torch.launch.mesh import make_local_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    runtime.initialize(f"file://{rendezvous}", world, rank,
                       device=device_type)
    shape_a, shape_b = lm_dist_shapes(world)
    mesh = make_local_mesh(model=shape_a[1], device=device_type)
    device = mesh.device_list[rank]
    out = {"rank": rank, "world": world, "device": str(device),
           "mesh": list(shape_a), "backend": torch.distributed.get_backend()}
    t1 = time.perf_counter()
    out["steps"] = lm_dist_step_checks(mesh, device, world)
    out["steps_s"] = time.perf_counter() - t1
    # the models' mesh branches and the collectives: no hand-written
    # kernel runs on them
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    out["mesh_branches"] = lm_mesh_checks(mesh, device, world)
    out["collectives"] = lm_collective_checks(mesh, device, world)
    out["moe"] = lm_moe_checks(mesh, world, device)
    out["shard_bodies"] = lm_shard_body_checks(device)
    out["mesh_s"] = time.perf_counter() - t1
    out["mesh_launches"] = ops.launch_counts()
    for name, count in out["mesh_launches"].items():
        check((count > 0) == (name in PATH_KERNELS["lm_collectives"]),
              f"the lm_collectives path launched {name} {count} times")
    out["run"] = lm_dist_run(shape_a, shape_b, device_type, world,
                             os.path.join(out_dir, "ckpt"))
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else None)
    out["seconds"] = time.perf_counter() - t0
    runtime.shutdown()
    print(json.dumps(out), flush=True)


def run_lm_dist_phase(card_name: str) -> dict:
    """The `lm_dist` phase: one process a visible card (at most
    LM_DIST_MAX_RANKS) joined over NCCL, each running `run_lm_dist_rank`;
    on one card that is world 1 on a (1, 1) mesh.  Ranks cannot share a
    card: NCCL refuses two ranks on one device, and DTensor's collectives
    over gloo on CUDA tensors crash (`PERF.md`, PR 31's card facts).
    Every rank must exit 0 and all must agree on the run's losses; the
    phase catches nothing."""
    import shutil

    import torch
    world = min(torch.cuda.device_count(), LM_DIST_MAX_RANKS)
    print(f"lm_dist: {world} card(s)", flush=True)
    out_dir = os.path.join(ROOT, LM_DIST_DIR)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--lm-dist-rank", str(rank), str(world),
         os.path.join(out_dir, "rendezvous"), out_dir],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "LOCAL_RANK": str(rank),
                        "PYTHONPATH": os.path.join(ROOT, "src")})
        for rank in range(world)]
    ranks, failed = [], []
    for rank, proc in enumerate(procs):
        try:
            stdout, stderr = proc.communicate(timeout=LM_DIST_TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            fail(f"lm_dist rank {rank} took over {LM_DIST_TIMEOUT} s")
        if proc.returncode != 0:
            failed.append(f"rank {rank} exited {proc.returncode}: "
                          + " | ".join((stdout + stderr).strip()
                                       .splitlines()[-6:]))
            continue
        ranks.append(json.loads(stdout.strip().splitlines()[-1]))
    check(not failed, f"lm_dist ({world} ranks): " + "; ".join(failed))
    first = ranks[0]
    for rec in ranks[1:]:
        check(rec["run"]["losses"] == first["run"]["losses"],
              f"lm_dist: rank {rec['rank']} saw other losses than rank 0")
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"cards": world, "ranks": world, "card": card_name,
            "backend": first["backend"], "mesh": first["mesh"],
            "steps": first["steps"],
            "mesh_branches": first["mesh_branches"],
            "collectives": first["collectives"],
            "moe": {k: {"errs": v["errs"], "flops": v["flops"],
                        "one_flops": v["one_flops"]}
                    for k, v in first["moe"].items()},
            "shard_bodies": first["shard_bodies"],
            "mesh_s": [r["mesh_s"] for r in ranks],
            "run": first["run"],
            "peak_bytes": [r["peak_bytes"] for r in ranks],
            "rank_seconds": [r["seconds"] for r in ranks],
            "seconds": time.perf_counter() - t0}


# --------------------------------------------------------------------------
# The dry run: the launchers traced on a fake process group
# --------------------------------------------------------------------------
DRYRUN_LM_CELL = ("internlm2-20b", "decode_32k")   # perf.py's decode cell
DRYRUN_TRAIN_ARCH = "internvl2-1b"   # the lm_train phase's step, B = LM_BATCH
DRYRUN_TRAIN_SEQ = 4096
DRYRUN_TIMED = 20        # event-timed relaunches of a recorded launch
DRYRUN_TIMEOUT = 600     # seconds the --dryrun process may take


def relaunch(rec) -> None:
    """A recorded launch made again, its tensor arguments the record's
    own tensors (no wrapper: the launch counts do not move)."""
    from repro_torch.kernels import _build
    tensors = iter(rec.tensors)
    _build.launch(rec.name, rec.device, *[
        next(tensors) if isinstance(a, _build.TensorArg) else a
        for a in rec.args])


def hold_launch(rec) -> dict:
    """One launch's output, after the launch, against the plain version
    of its own inputs: binarize and leaf_index exactly, sums within
    `sum_limit`."""
    import torch
    from repro_torch.kernels import ref
    name = rec.name.removeprefix("repro_")
    t = rec.tensors
    if name == "binarize":
        x, borders, out = t
        want = (ref.binarize_u8 if out.dtype == torch.uint8
                else ref.binarize)(x, borders)
        check(torch.equal(out, want), "binarize at the predict-1m shard "
              "differs from its plain version")
        return {"max_abs_err": 0.0}
    if name == "leaf_index":
        bins, sf, sb, out = t
        check(torch.equal(out, ref.leaf_index(bins, sf, sb)),
              "leaf_index at the predict-1m shard differs from its plain "
              "version")
        return {"max_abs_err": 0.0}
    if name == "leaf_gather":
        idx, lv, out = t
        err, share = compare_sums("leaf_gather at the predict-1m shard", out,
                                  ref.leaf_gather(idx, lv),
                                  sum_limit(idx, lv))
        return {"max_abs_err": err, "of_limit": share}
    if name in ("fused_predict", "fused_predict_spread"):
        x, borders, sf, sb, lv, out = t[:6]
        idx = ref.leaf_index(ref.binarize(x, borders), sf, sb)
        err, share = compare_sums(
            f"{name} at the predict-1m shard", out,
            ref.fused_predict(x, borders, sf, sb, lv), sum_limit(idx, lv))
        return {"max_abs_err": err, "of_limit": share}
    fail(f"the predict-1m shard launched {rec.name}, which the dry-run "
         "phase does not hold to a plain version")


def dryrun_predict_shard(cell: dict, card: str) -> dict:
    """(b) One device's predict-1m shard for real: the seeded 625-tree
    ensemble on 65,536 rows through its plan, every launch recorded and
    made; the launches equal the trace's (names and shapes), each
    kernel's first launch is held to its plain version and timed again
    on CUDA events, beside its cost bound and the cell's memory term."""
    import torch
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import dryrun_gbdt as dg
    from repro_torch.launch import hlo_analysis as hlo
    from repro_torch.core.predictor import Predictor
    rows, trees, _ = dg.shard_shape(False)
    plan = Predictor.build(dg.random_ensemble(trees), device="cuda")
    x = torch.as_tensor(dg.random_rows(rows), device="cuda")
    ops.reset_launch_counts()
    with _build.recording_launches(execute=True) as records:
        plan.raw(x)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    launches = [r for r in records if r.kind == "launch"]
    got = [(r.name, [list(s) for _, s in hlo.launch_shapes(r)[1]])
           for r in launches]
    want = [(r["name"], r["shapes"]) for r in cell["launches"]]
    check(got == want, f"the predict-1m shard launched {got}; its trace "
          f"recorded {want}")
    check(sum(counts.values()) == len(launches), f"the shard's launch "
          f"counts {counts} are not its {len(launches)} launches")
    out, seen = [], set()
    for rec, row in zip(launches, cell["launches"]):
        if rec.name in seen:
            continue
        seen.add(rec.name)
        held = hold_launch(rec)
        ms = events_ms(lambda rec=rec: relaunch(rec), DRYRUN_TIMED)
        out.append({"name": rec.name, **held, "ms": ms,
                    "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "cell_memory_ms": cell["memory_s"] * 1e3,
                    "card": card})
    return {"rows": rows, "trees": trees, "launches": counts,
            "kernels": out}


def dryrun_train_flops() -> dict:
    """(d) internvl2-1b's remat train step at B = LM_BATCH, S = 4,096
    traced on one device: its products' FLOPs by part beside
    `lm_train_flops`.  Head: a product with a vocabulary dim; attention:
    the other batched products; blocks: the rest.  Head and attention
    equal the formula's; the blocks fall short of it by exactly each
    block's last product (w_out), whose forward the remat does not run
    again (`torch.utils.checkpoint` stops recomputing once every saved
    tensor is back), and by the norm scales the formula counts as
    weights."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    cfg = configs.get(DRYRUN_TRAIN_ARCH)
    t0 = time.perf_counter()
    traced = dryrun.trace_cell(
        cfg, ShapeConfig("train_4k", DRYRUN_TRAIN_SEQ, LM_BATCH, "train"),
        (1,), ("data",))
    parts = {"blocks": 0, "head": 0, "attention": 0}
    for (name, shapes), flops in traced["counter"].products.items():
        if any(cfg.vocab_size in s for s in shapes):
            parts["head"] += flops
        elif name == "bmm":
            parts["attention"] += flops
        else:
            parts["blocks"] += flops
    total, want = lm_train_flops(cfg, DRYRUN_TRAIN_SEQ)
    pos = DRYRUN_TRAIN_SEQ + (cfg.frontend_seq if cfg.family == "vlm"
                              else 0)
    from repro_torch.models import transformer as tf
    tokens = LM_BATCH * pos
    # the formula's 8 N T counts the blocks' norm scales (L x D leaves)
    # as weights of a product; no product takes them
    vectors = sum(math.prod(v) for k, v in tf.tree_leaves(
        tf.param_shapes(cfg)) if k.startswith("blocks/") and len(v) == 2)
    named = {"w_out forwards the remat does not run again":
             cfg.n_layers * 2 * tokens * cfg.d_ff * cfg.d_model,
             "norm scales counted as weights": 8 * tokens * vectors}
    for part in ("head", "attention"):
        check(parts[part] == want[part], f"the traced {part} products "
              f"({parts[part]}) are not lm_train_flops' ({want[part]})")
    short = want["blocks"] - parts["blocks"]
    check(short in (sum(named.values()), named["norm scales counted as "
                                               "weights"]),
          f"the traced block products ({parts['blocks']}) fall short of "
          f"lm_train_flops' ({want['blocks']}) by {short}, not by {named}")
    return {"arch": cfg.name, "batch": LM_BATCH, "seq": DRYRUN_TRAIN_SEQ,
            "traced": parts, "formula": want, "formula_total": total,
            "traced_total": traced["costs"]["flops"],
            "blocks_short_by": short, "named": named,
            "trace_s": time.perf_counter() - t0}


def dryrun_gbdt_predict(card: str) -> dict:
    """(e) `perf --cell gbdt-predict --force` on the card, then the four
    variants' raws: the staged routes that sum in tree order bit for bit
    alike, the tree-blocked one within `sum_limit` of them."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.launch import perf
    perf.run("gbdt-predict", force=True, device="cuda")
    rows = {name: json.loads((perf.RESULTS / f"gbdt-predict__{name}.json")
                             .read_text())
            for name, _, _ in perf.CELLS["gbdt-predict"]["variants"]}
    for name, res in rows.items():
        check(res["status"] == "ok", f"perf gbdt-predict {name}: "
              f"{res.get('error')}")
    ens, x = perf.gbdt_workload("cuda")
    raws = {name: perf.gbdt_predict_fn(ens, x, overrides, "cuda")(x)
            for name, overrides, _ in perf.CELLS["gbdt-predict"]["variants"]}
    for name in ("kwarg-path", "prequantized"):
        check(torch.equal(raws[name], raws["prepared-plan"]),
              f"perf gbdt-predict {name} differs from prepared-plan")
    ens = ens.to(x.device)
    idx = ref.leaf_index(ref.binarize(x, ens.borders), ens.split_features,
                         ens.split_bins)
    err, share = compare_sums(
        "perf gbdt-predict prepared-tree-block",
        raws["prepared-tree-block"], raws["prepared-plan"],
        sum_limit(idx, ens.leaf_values, ens.base_score))
    return {"us_per_call": {n: r["us_per_call"] for n, r in rows.items()},
            "batch": rows["prepared-plan"]["batch"],
            "tree_block_max_abs_err": err, "tree_block_of_limit": share,
            "card": card}


def run_dryrun() -> None:
    """`python3 chip_smoke.py --dryrun`: the dry-run launchers on the card
    in a process of their own (the fake group must not live in the smoke's
    main process: `runtime.is_distributed()` changes `make_local_mesh`).
    Outputs go under build/.  Its last line is a JSON object of (a)-(e);
    any cell not ok or check missed exits 1."""
    import pathlib

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device; this script measures the port on the card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch import dryrun, dryrun_gbdt, perf
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build = pathlib.Path(ROOT) / "build"
    dryrun.RESULTS = dryrun_gbdt.RESULTS = build / "dryrun_torch"
    perf.RESULTS = build / "perf_torch"
    t0 = time.perf_counter()
    out = {"card": card}
    # (a) the GBDT cells on the single-pod mesh
    check(dryrun_gbdt.main(["--single-pod", "--force"]) == 0,
          "a dryrun_gbdt cell is not ok")
    cells = {name: dryrun_gbdt.run_cell(name, False)
             for name in dryrun_gbdt.CELLS}
    out["gbdt_cells"] = {name: {k: c[k] for k in (
        "status", "trace_seconds", "compute_s", "memory_s", "collective_s",
        "dominant", "bytes_per_device", "collective_bytes")}
        for name, c in cells.items()}
    # (b) one device's predict-1m shard, for real
    out["predict_shard"] = dryrun_predict_shard(cells["predict-1m"], card)
    # (c) the decode cell at full width
    arch, shape = DRYRUN_LM_CELL
    check(dryrun.main(["--arch", arch, "--shape", shape, "--single-pod",
                       "--force"]) == 0, f"dryrun {arch} {shape} is not ok")
    lm = dryrun.run_and_save(arch, shape, multi_pod=False)
    out["lm_cell"] = {k: lm[k] for k in (
        "arch", "shape", "status", "trace_seconds", "device_type",
        "compute_s", "memory_s", "collective_s", "dominant",
        "collective_bytes", "ops_per_device", "memory_analysis")}
    # (d) the one-device train step against lm_train_flops
    out["train_flops"] = dryrun_train_flops()
    # (e) the gbdt-predict perf cell
    out["gbdt_predict"] = dryrun_gbdt_predict(card)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out, default=float), flush=True)


def run_dryrun_phase() -> dict:
    """The dry-run phase in a process of its own (`run_dryrun`)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--dryrun"],
        cwd=ROOT, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    for line in proc.stdout.strip().splitlines()[-8:-1]:
        print(f"  dryrun: {line[:400]}")
    for line in proc.stderr.strip().splitlines()[-5:]:
        print(f"  dryrun stderr: {line[:400]}")
    check(proc.returncode == 0,
          f"chip_smoke.py --dryrun exited {proc.returncode}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["wall_s"] = time.perf_counter() - t0
    return out


PATH_KERNELS = {
    "soa": {"binarize", "leaf_index", "leaf_gather", "fused_predict"},
    "depth_major": {"binarize", "leaf_index_dm", "leaf_gather",
                    "fused_predict_dm"},
    "depth_grouped": {"binarize", "leaf_index", "leaf_gather"},
    "bitpacked": {"binarize", "leaf_index_bp", "leaf_gather"},
    "bitpacked_one_group": {"binarize", "leaf_index_bp", "leaf_gather",
                            "fused_predict_bp"},
    "training": {"binarize", "histogram", "split_level", "leaf_index",
                 "leaf_gather"},
    "trained_soa_pool": {"binarize", "leaf_index", "leaf_gather"},
    "bulk": {"binarize", "leaf_index", "leaf_gather", "fused_predict"},
    "entry_points": {"binarize", "leaf_index", "leaf_gather",
                     "fused_predict"},
    "fit_source": {"binarize", "histogram", "split_level", "leaf_index",
                   "leaf_gather"},
    "training_remainders": {"binarize", "histogram", "split_level",
                            "leaf_index", "leaf_gather"},
    "fit_scan": {"binarize", "histogram", "split_level", "leaf_index",
                 "leaf_gather"},
    "splits": {"binarize", "split_level"},
    "telemetry": {"binarize", "histogram", "split_level", "leaf_index",
                  "leaf_gather", "fused_predict"},
    "knn": {"l2sq_matrix", "l2sq_rowwise", "binarize", "histogram",
            "split_level", "leaf_index", "leaf_gather", "fused_predict"},
    "mesh": {"binarize", "leaf_index", "leaf_index_dm", "leaf_index_bp",
             "leaf_gather", "fused_predict", "fused_predict_dm",
             "fused_predict_bp"},
    # the launcher and example processes (`read_launcher`)
    "score_cli": {"binarize", "histogram", "split_level", "leaf_index",
                  "leaf_gather", "fused_predict"},
    "train_gbdt": {"binarize", "histogram", "split_level", "leaf_index",
                   "leaf_gather"},
    "serve": {"binarize", "histogram", "split_level", "leaf_index",
              "leaf_gather", "fused_predict"},
    "show_kernels": set(),
    "quickstart": {"binarize", "histogram", "split_level", "leaf_index",
                   "leaf_gather", "fused_predict"},
    "serve_gbdt": {"binarize", "histogram", "split_level", "leaf_index",
                   "leaf_gather", "fused_predict"},
    "embeddings_knn": {"l2sq_matrix", "binarize", "histogram",
                       "split_level", "leaf_index", "leaf_gather",
                       "fused_predict"},
    "serve_lm_glm4": set(),
    "serve_lm_whisper": set(),
    "train_lm": set(),
    "train_lm_example": set(),
    # the lm_dist ranks' mesh branches and collectives (`run_lm_dist_rank`)
    "lm_collectives": set(),
}


def routes_raw(plan, staged, x):
    """Raw scores of a path's three routes at the bulk shape."""
    return {"fused": plan.raw(x), "pool": plan.raw(plan.quantize(x)),
            "staged": staged.raw(x)}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device; this script measures the port on the card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        fail(f"needs a Hopper (sm_90) card, found "
             f"{torch.cuda.get_device_name(0)}")
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail("run from a checkout: src/repro_torch is not next to this file")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.predictor import Predictor, classify_from_raw
    from repro_torch.data.synthetic import covertype, image_embeddings
    from repro_torch.kernels import _build, ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [line.strip() for line in _build.build_info.get("log", "")
             .splitlines()
             if any(k in line for k in ("registers", "Compiling", "spill"))]
    print(f"kernels built in {build_s:.1f} s: {_build.build_info['path']}")
    for line in ptxas:
        print(f"  ptxas {line}")

    data = covertype(scale=1.0, seed=SEED)
    x_test = data.x_test

    def path_launch_counts(path: str) -> dict:
        """Launches since the counts were set to 0, which must be exactly
        the path's kernels."""
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        print(f"{path} launches: {counts}", flush=True)
        for name, count in counts.items():
            check((count > 0) == (name in PATH_KERNELS[path]),
                  f"the {path} path launched {name} {count} times; it "
                  f"launches exactly {sorted(PATH_KERNELS[path])}")
        return counts

    # --- the training path, with the launch counts set to 0 before it
    # and read after it
    ops.reset_launch_counts()
    full, history, params, train_s = train_model(data)
    path_launches = {"training": path_launch_counts("training")}
    snapshot = history["metrics"]
    print(f"trained {full.n_trees} trees of depth {full.depth} on "
          f"{len(data.x_train)} rows in {train_s:.1f} s: " + json.dumps(
              {k: snapshot[k] for k in (
                  "iter_p50_ms", "iter_p99_ms", "hist_p50_ms",
                  "split_p50_ms", "leaf_p50_ms", "hist_frac", "split_frac",
                  "leaf_frac", "rows_per_s", "first_train_loss",
                  "final_train_loss")}), flush=True)
    pool, training_checks = check_training(full, history, params,
                                           data.x_train)
    training_checks["resume"] = check_resume(pool, data.y_train, full,
                                             params)
    levels, gh0, training_checks["splits"] = replay_splits(
        full, pool, data.y_train, params)
    training_profile = profile_training(pool, data.y_train, full, params)
    print(f"training profile: {json.dumps(training_profile)}", flush=True)
    print(f"training checks: {json.dumps(training_checks)}", flush=True)
    hist_row = check_and_time_histogram(
        pool.bins.t().contiguous(), levels, gh0, full.borders.shape[0] + 1,
        path_launches["training"]["histogram"])
    del pool, levels, gh0
    torch.cuda.empty_cache()

    # --- the split kernel against the plain version on the CPU: the split
    # step on exact ties and the benchmark's Covertype levels, with the
    # launch counts set to 0 before it and read after it
    ops.reset_launch_counts()
    splits = check_splits(data)
    path_launches["splits"] = path_launch_counts("splits")
    print(f"splits: {json.dumps(splits)}", flush=True)

    # --- the trained model served from a pool on soa
    ops.reset_launch_counts()
    trained_serving = serve_trained(full, x_test, data.y_test)
    path_launches["trained_soa_pool"] = path_launch_counts(
        "trained_soa_pool")
    print(f"trained model served: {json.dumps(trained_serving)}",
          flush=True)

    # --- the bulk path, the other entry points and fit_source, each with
    # the launch counts set to 0 before it and read after it; then the
    # scoring CLI in a process of its own
    with tempfile.TemporaryDirectory() as tmp:
        ops.reset_launch_counts()
        bulk, bulk_plans, bulk_source = run_bulk_path(full, x_test, tmp)
        path_launches["bulk"] = path_launch_counts("bulk")
        t0 = time.perf_counter()
        bulk["kernels_vs_plain"] = check_bulk_kernels(
            bulk_plans, bulk_source, sorted(
                {bulk["chunk_rows"], bulk["worker_route"]["chunk_rows"]}))
        bulk["kernels_vs_plain_s"] = time.perf_counter() - t0
        del bulk_plans
        print(f"bulk path: {json.dumps(bulk)}", flush=True)
        ops.reset_launch_counts()
        entry_points = run_entry_points(full, x_test, tmp)
        path_launches["entry_points"] = path_launch_counts("entry_points")
        print(f"entry points: {json.dumps(entry_points)}", flush=True)
    ops.reset_launch_counts()
    fit_source = run_fit_source(data, params)
    path_launches["fit_source"] = path_launch_counts("fit_source")
    print(f"fit_source: {json.dumps(fit_source)}", flush=True)
    score_cli = run_score_cli()
    print(f"score_cli: {json.dumps(score_cli)}", flush=True)
    torch.cuda.empty_cache()

    # --- the training remainders and fit_scan, each with the launch
    # counts set to 0 before it and read after it; then the launchers and
    # the examples, each in a process of its own
    ops.reset_launch_counts()
    remainders = run_training_remainders(data, full, params)
    path_launches["training_remainders"] = path_launch_counts(
        "training_remainders")
    print(f"training_remainders: {json.dumps(remainders)}", flush=True)
    ops.reset_launch_counts()
    fit_scan = run_fit_scan()
    path_launches["fit_scan"] = path_launch_counts("fit_scan")
    print(f"fit_scan: {json.dumps(fit_scan)}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ops.reset_launch_counts()
        telemetry = run_telemetry(data, full, params, tmp)
        path_launches["telemetry"] = path_launch_counts("telemetry")
    print(f"telemetry: {json.dumps(telemetry)}", flush=True)
    launchers = run_launchers()
    print(f"launchers: {json.dumps(launchers)}", flush=True)
    torch.cuda.empty_cache()

    ens = truncated(full)
    print(f"model: T={ens.n_trees} D={ens.depth} C={ens.n_outputs} "
          f"F={ens.n_features} B={ens.borders.shape[0]}; "
          f"{len(x_test)} test rows")

    # --- the serving paths, each with the launch counts set to 0 before
    # it and read after it
    path_specs = {"soa": (ens, "soa", N_REQUESTS),
                  "depth_major": (ens, "depth_major", N_LAYOUT_REQUESTS),
                  "depth_grouped": (ens, "depth_grouped", N_LAYOUT_REQUESTS),
                  "bitpacked": (ens, "bitpacked", N_LAYOUT_REQUESTS),
                  "bitpacked_one_group": (full, "bitpacked",
                                          N_LAYOUT_REQUESTS)}
    paths, buckets = {}, None
    for path, (model, layout, n_requests) in path_specs.items():
        ops.reset_launch_counts()
        out, phases, plan, staged, buckets = serve(model, x_test, layout,
                                                   n_requests)
        path_launches[path] = path_launch_counts(path)
        paths[path] = dict(out=out, phases=phases, plan=plan, staged=staged,
                           model=model, n_requests=n_requests)
    # --- the multi-device slice on make_local_mesh(4), with the launch
    # counts set to 0 before it and read after it
    with tempfile.TemporaryDirectory() as tmp:
        ops.reset_launch_counts()
        mesh_path = run_mesh_path(paths, full, x_test, tmp)
        path_launches["mesh"] = path_launch_counts("mesh")
    print(f"mesh path: {json.dumps(mesh_path)}", flush=True)
    torch.cuda.empty_cache()

    # --- the kNN path, with the launch counts set to 0 before it and read
    # after it
    emb_data = image_embeddings(scale=1.0)
    ops.reset_launch_counts()
    knn_run = run_knn_path(emb_data)
    path_launches["knn"] = path_launch_counts("knn")
    knn_serving = knn_phases(knn_run, emb_data)
    print(f"knn path: {json.dumps(knn_serving)}", flush=True)

    launches = {name: sum(c[name] for c in path_launches.values())
                for name in ops.KERNELS}
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the main path")
    n_groups = {p: len(paths[p]["plan"].lowered.groups)
                for p in ("depth_grouped", "bitpacked", "bitpacked_one_group")}
    print(f"depth groups: {n_groups}")
    check(n_groups["depth_grouped"] == n_groups["bitpacked"] > 1
          and n_groups["bitpacked_one_group"] == 1,
          f"depth groups {n_groups}")

    n, c = len(x_test), ens.n_outputs
    recompiles = {}
    for path, rec in paths.items():
        out = rec["out"]
        for name, proba in out.items():
            rows = rec["n_requests"] if name == "single" else n
            check(proba.shape == (rows, c),
                  f"{path} {name} proba shape {proba.shape}")
            check(bool(np.isfinite(proba).all()),
                  f"{path} {name} proba not finite")
            check(bool(np.allclose(proba.sum(1), 1.0, atol=1e-5)),
                  f"{path} {name} proba rows do not sum to 1")
        classes = {k: v.argmax(1) for k, v in out.items()}
        check(np.array_equal(classes["fused"], classes["pool"]),
              f"{path}: fused and pool routes classify differently")
        check(np.array_equal(classes["fused"], classes["staged"]),
              f"{path}: fused and staged routes classify differently")
        check(np.array_equal(classes["single"],
                             classes["fused"][:rec["n_requests"]]),
              f"{path}: single requests classify differently from the "
              "batch")
        recompiles[path] = rec["plan"].stats["traces"]
        check(all(recompiles[path].get(e, 0) <= len(buckets)
                  for e in ("proba", "proba_pool")),
              f"{path}: more first calls than the {len(buckets)} buckets: "
              f"{recompiles[path]}")
    out = paths["soa"]["out"]
    path_diff = max(float(np.abs(out["fused"] - out[k]).max())
                    for k in ("pool", "staged"))

    # --- agreement between layouts: the routes' raw scores at the bulk
    # shape, and the served probabilities
    raw = {p: routes_raw(rec["plan"], rec["staged"], x_test)
           for p, rec in paths.items()}
    for a, b in (("depth_major", "soa"), ("bitpacked", "depth_grouped")):
        for route in ("fused", "pool", "staged"):
            check(torch.equal(raw[a][route], raw[b][route]),
                  f"{a} {route} scores differ from {b}'s")
            check(np.array_equal(paths[a]["out"][route],
                                 paths[b]["out"][route]),
                  f"{a} served {route} probabilities differ from {b}'s")
    soa_full = Predictor.build(full, device="cuda", layout="soa")
    check(torch.equal(raw["bitpacked_one_group"]["fused"],
                      soa_full.raw(x_test)),
          "one-group bitpacked fused scores differ from soa fused")
    low = paths["soa"]["plan"].lowered
    x_dev = torch.as_tensor(x_test, device=paths["soa"]["plan"].device)
    soa_idx = ops.leaf_index(ops.binarize_u8(x_dev, low.borders),
                             low.split_features, low.split_bins)
    limit = sum_limit(soa_idx, low.leaf_values, paths["soa"]["plan"]
                      .ensemble.base_score)
    del soa_idx
    top2 = raw["soa"]["fused"].topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * limit.max(dim=1).values
    soa_class = classify_from_raw(raw["soa"]["fused"], c)
    layout_err = {}
    for path in ("depth_grouped", "bitpacked"):
        for route in ("fused", "pool", "staged"):
            err, share = compare_sums(f"{path} {route} vs soa",
                                      raw[path][route], raw["soa"][route],
                                      limit)
            layout_err[f"{path}_{route}"] = {"max_abs_err": err,
                                             "err_over_limit": share}
            agree = classify_from_raw(raw[path][route], c) == soa_class
            check(bool(agree[clear].all()),
                  f"{path} {route} classifies differently from soa")
    layout_err["rows_with_clear_margin"] = int(clear.sum())
    del raw, limit, top2, clear, soa_class

    # --- the card against the plain plan on the CPU, on a small input,
    # on every layout
    xs = x_test[:N_REFERENCE]
    card_vs_cpu = {}
    for path, rec in paths.items():
        model = rec["model"]
        cpu_plan = Predictor.build(model, device="cpu",
                                   layout=rec["plan"].config.layout)
        raw_cpu = cpu_plan.raw(xs)
        raw_gpu = rec["plan"].raw(xs).cpu()
        idx_cpu = ops.leaf_index(cpu_plan.quantize(xs).bins,
                                 model.split_features, model.split_bins)
        limit = sum_limit(idx_cpu, model.leaf_values, model.base_score)
        ref_err, ref_share = compare_sums(f"{path}: card vs CPU raw scores",
                                          raw_gpu, raw_cpu, limit)
        top2 = raw_cpu.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * limit.max(dim=1).values
        agree = classify_from_raw(raw_gpu, c) == classify_from_raw(raw_cpu,
                                                                   c)
        check(bool(agree[clear].all()),
              f"{path}: card and CPU classify differently")
        card_vs_cpu[path] = {"max_abs_err": ref_err,
                             "err_over_limit": ref_share,
                             "rows_compared": int(clear.sum())}

    check_rows = (n, MAX_BATCH, buckets[0])
    kernels, control, tree_padding = check_and_time_kernels(
        x_test, paths["soa"]["plan"], launches, check_rows)
    layout_kernels, layout_of_limit = check_and_time_layout_kernels(
        x_test, paths["soa"]["plan"].lowered,
        paths["depth_major"]["plan"].lowered,
        paths["bitpacked"]["plan"].lowered,
        paths["bitpacked_one_group"]["plan"].lowered, soa_full.lowered,
        launches, check_rows)
    kernels += layout_kernels
    index_checks = check_and_time_index_kernels(
        x_test, paths["soa"]["plan"].lowered,
        paths["depth_grouped"]["plan"].lowered, kernels, buckets[0])
    hist_row["launches"] = launches["histogram"]
    kernels += [hist_row]
    control["kernel_err_over_limit"].update(layout_of_limit)

    # --- the kNN path's checks: its training contracts and the histogram
    # at 533 features x 40 stats, then its kernels
    knn_pool, knn_checks = check_training(
        knn_run["ens"], knn_run["history"], knn_run["params"],
        knn_run["x_train"])
    levels, gh0, knn_checks["splits"] = replay_splits(
        knn_run["ens"], knn_pool, emb_data.y_train, knn_run["params"])
    knn_checks["histogram"] = check_and_time_histogram(
        knn_pool.bins.t().contiguous(), levels, gh0,
        knn_run["ens"].borders.shape[0] + 1, launches["histogram"])
    del knn_pool, levels, gh0
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    knn_kernels, knn_checks["path"] = check_and_time_knn(emb_data, knn_run,
                                                         flush)
    del flush
    for row in knn_kernels:
        row["launches"] = launches[row["name"]]
    kernels += knn_kernels
    next(row for row in kernels if row["name"] == "binarize")[
        "knn_shape"] = knn_checks["path"]["binarize"]
    torch.cuda.synchronize()

    # --- the former caps: 33 outputs, wide rows, 66 stats
    t0 = time.perf_counter()
    caps = check_caps()
    caps["seconds"] = time.perf_counter() - t0
    print(f"caps: {json.dumps(caps)}", flush=True)

    # --- the contract checker: the abstract walk (the committed report,
    # byte for byte), then the cuda cells launched for real with the
    # resource record on (after every timed phase: the record is off for
    # them)
    t0 = time.perf_counter()
    contracts = run_contracts()
    contracts["seconds"] = time.perf_counter() - t0
    print(f"contract resources ({card}): "
          f"{json.dumps(contracts.pop('resources'))}", flush=True)
    print(f"contracts: {json.dumps(contracts)}", flush=True)

    # --- the LM serving slice: plain PyTorch, no hand-written kernel, so
    # the launch counts must not move across it
    torch.cuda.empty_cache()
    before = ops.launch_counts()
    lm = run_lm_phase(card)
    torch.cuda.synchronize()
    check(ops.launch_counts() == before,
          f"the lm phase launched hand-written kernels: {before} -> "
          f"{ops.launch_counts()}")
    print(f"lm: {json.dumps(lm)}", flush=True)

    # --- the LM training slice: plain PyTorch through autograd, no
    # hand-written kernel, so the launch counts must not move across it
    torch.cuda.empty_cache()
    before = ops.launch_counts()
    lm_train = run_lm_train_phase(card)
    torch.cuda.synchronize()
    check(ops.launch_counts() == before,
          f"the lm_train phase launched hand-written kernels: {before} -> "
          f"{ops.launch_counts()}")
    print(f"lm_train: {json.dumps(lm_train)}", flush=True)

    # --- the distributed LM trainer: one process a card, DTensor over
    # NCCL; plain PyTorch in other processes, so no kernel is launched
    torch.cuda.empty_cache()
    before = ops.launch_counts()
    lm_dist = run_lm_dist_phase(card)
    check(ops.launch_counts() == before,
          f"the lm_dist phase launched hand-written kernels: {before} -> "
          f"{ops.launch_counts()}")
    print(f"lm_dist: {json.dumps(lm_dist)}", flush=True)

    # --- the dry-run launchers: traced on a fake process group, in a
    # process of their own; its real launches do not touch these counts
    before = ops.launch_counts()
    dry = run_dryrun_phase()
    check(ops.launch_counts() == before,
          f"the dryrun phase moved this process's launch counts: {before} "
          f"-> {ops.launch_counts()}")
    print(f"dryrun: {json.dumps(dry)}", flush=True)

    print(json.dumps({"checks": {
        "paths_max_abs_diff": path_diff,
        "layouts_vs_soa": layout_err,
        "card_vs_cpu": card_vs_cpu,
        "first_calls": recompiles, "kernel_rows_compared": list(check_rows),
        "float_limit": f"{K_SIGMA:g}*sqrt(T)*u*sum|leaf| per output",
        "histogram_limit": f"{K_SIGMA:g}*sqrt(n)*u*sum|gh| + n*quantum/2 "
                           "per cell from the f64 plain version; plus "
                           "1.05*(n+1)*u*sum|gh| from the f32 one",
        "tolerance_control": control, "tree_padding": tree_padding,
        "index_edges": index_checks,
        "training": training_checks, "knn": knn_checks, "caps": caps,
        "contracts": contracts,
        "distance_limit": f"matrix {K_SIGMA:g}*sqrt(K)*u*(|a|^2 + |b|^2 + "
                          f"2*sum|a_k*b_k|), rowwise {K_SIGMA:g}*sqrt(K)*u*"
                          "sum(r_k - q_k)^2 per distance"}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serving": {p: rec["phases"]
                                  for p, rec in paths.items()},
                      "trained_soa_pool": trained_serving,
                      "training": {"seconds": train_s, "trees": full.n_trees,
                                   "rows": len(data.x_train),
                                   "metrics": snapshot,
                                   "profile": training_profile},
                      "knn": knn_serving, "bulk": bulk,
                      "mesh": mesh_path,
                      "entry_points": entry_points,
                      "fit_source": fit_source, "score_cli": score_cli,
                      "training_remainders": remainders,
                      "fit_scan": fit_scan, "launchers": launchers,
                      "splits": splits, "telemetry": telemetry, "lm": lm,
                      "lm_train": lm_train, "lm_dist": lm_dist,
                      "dryrun": dry, "launches": path_launches, "card": card,
                      "build_seconds": build_s}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--launcher"] and len(sys.argv) == 3:
        run_launcher(sys.argv[2])
    elif sys.argv[1:] == ["--lm-dist"]:
        # the lm_dist phase alone, on the card (a quick first call)
        sys.path.insert(0, os.path.join(ROOT, "src"))
        print(json.dumps(run_lm_dist_phase(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0])), flush=True)
    elif sys.argv[1:] == ["--dryrun"]:
        run_dryrun()
    elif sys.argv[1:2] == ["--lm-dist-rank"] and len(sys.argv) == 6:
        run_lm_dist_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                         sys.argv[5])
    else:
        main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on an H100 and check it.

Run from the root of a checkout, on a machine with one Hopper card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/`,
serves a random-weight oblivious-tree model at the full width of the
paper's Covertype workload (54 features, 7 classes, depth 8, 63 borders,
1,000 trees) through `GBDTServer`, and checks:

  * every kernel of the path was launched by the serving phases;
  * the fused, pool and staged paths classify the same;
  * the card's scores agree with the plain PyTorch plan on the CPU;
  * each kernel agrees with its plain version on the card at every row
    count the main path gives it (the whole test split, the largest and
    the smallest serving bucket): integers exactly, float sums within the
    rounding limit of `sum_limit`, which a bf16 leaf table must fail.

Then it times each kernel at the serving path's bulk shape beside its
plain version, one PyTorch library call where one computes the same
function, and the least time the card could take (`bound_ms`), and times
the tree-looping kernels once more on a model padded to a multiple of 32
trees.  The last three lines of output are the `kernels` JSON, the
serving JSON and the result line.  Any failed check exits non-zero before
the result line.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, at the full 700 W power limit: HBM3
# bandwidth and the fp32 rate outside the tensor cores (the compares,
# adds and index arithmetic of these kernels are all non-tensor work).
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12

SEED = 0
N_TREES = 1000          # CatBoost's default `iterations`
DEPTH = 8               # Covertype's depth (configs/gbdt_workloads.py)
MAX_BINS = 64           # BoostingParams.max_bins: 63 borders
MAX_BATCH = 1024
N_CLIENTS, N_REQUESTS = 8, 64
N_REFERENCE = 1024      # rows compared with the CPU plan
U = 2.0 ** -24          # unit roundoff of float32
K_SIGMA = 8.0           # width of the float limit, in rounding walks
TREE_TILE = 32          # the padding the tree-padding timings try
PAIR_ROUNDS = 7         # alternating rounds when timing two versions


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


def make_model(x_train: np.ndarray, n_outputs: int):
    """Covertype-width ensemble with numpy-seeded splits and leaves, a
    tenth of its trees truncated (so PAD_SPLIT_BIN is on the path)."""
    from repro_torch.core.quantize import compute_borders
    from repro_torch.core.trees import ObliviousEnsemble, truncate_tree_depths
    borders, n_borders = compute_borders(x_train, MAX_BINS)
    rng = np.random.default_rng(SEED)
    n_feat = borders.shape[1]
    sf = rng.integers(0, n_feat, (N_TREES, DEPTH))
    # split bins in [1, n_borders[f]]: every split can go either way
    width = np.maximum(n_borders.numpy()[sf], 1)
    sb = 1 + (rng.random((N_TREES, DEPTH)) * width).astype(np.int64)
    lv = rng.normal(scale=0.1, size=(N_TREES, 1 << DEPTH, n_outputs))
    base = rng.normal(scale=0.1, size=(n_outputs,))
    ens = ObliviousEnsemble(sf, sb, lv, borders, n_borders, base)
    depths = np.full(N_TREES, DEPTH)
    cut = rng.choice(N_TREES, N_TREES // 10, replace=False)
    depths[cut] = rng.integers(0, DEPTH, cut.size)
    return truncate_tree_depths(ens, depths)


def serve(ens, x_test: np.ndarray):
    """The main path: single requests, a bulk batch, a pool, a staged
    plan.  Returns (probas by path, phase stats, the server's plan, its
    buckets)."""
    import torch
    from repro_torch.core.predictor import Predictor
    from repro_torch.serving.engine import GBDTServer

    server = GBDTServer(ens, device="cuda", max_batch=MAX_BATCH)
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
            replies = list(pool.map(request, range(N_REQUESTS)))
        lat = np.array([dt for _, dt in replies]) * 1e3
        phases["requests"] = {
            "rows": N_REQUESTS, "clients": N_CLIENTS,
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
        staged_plan = Predictor.build(ens, device="cuda", strategy="staged")
        staged = timed("staged_proba", lambda: staged_plan.proba(x_test))
        phases["staged_proba"].pop("batch_p50_ms")
        phases["staged_proba"].pop("batch_p99_ms")
    finally:
        server.close()
    return ({"single": single, "fused": fused, "pool": pooled,
             "staged": staged.cpu().numpy()}, phases, server.predictor,
            server.buckets)


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
        each kernel on the first `n` rows."""
        t = sf.shape[0]
        xn, bn, ixn = x[:n], bins[:n], idx[:n]
        n_feat, n_b = x.shape[1], borders.shape[0]
        table_bytes = lv.numel() * 4 + sf.numel() * 8
        return {
            "binarize": dict(
                kernel=lambda: binarize(xn, borders, out_dtype=torch.uint8),
                plain=lambda: ref.binarize_u8(xn, borders),
                library=lambda: torch.searchsorted(bt, xt[:, :n],
                                                   out_int32=True),
                bytes=n * n_feat * 4 + n_b * n_feat * 4 + n * n_feat,
                ops=n * n_feat * n_b),
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
                bytes=n * t * 4 + lv.numel() * 4 + n * c * 4,
                ops=n * t * c),
            "fused_predict": dict(
                kernel=lambda: fused_predict(xn, borders, sf, sb, lv),
                plain=lambda: ref.fused_predict(xn, borders, sf, sb, lv),
                library=None,
                bytes=n * n_feat * 4 + n_b * n_feat * 4 + table_bytes
                + n * c * 4,
                ops=n * n_feat * n_b + n * t * d + n * t * c),
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
            "bucket_bound_ms": bound(small["bytes"], small["ops"])[0],
        })

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
    from repro_torch.data.synthetic import covertype
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
             .splitlines() if "registers" in line or "Compiling" in line]
    print(f"kernels built in {build_s:.1f} s: {_build.build_info['path']}")
    for line in ptxas:
        print(f"  ptxas {line}")

    data = covertype(scale=1.0, seed=SEED)
    ens = make_model(data.x_train, data.n_classes)
    x_test = data.x_test
    print(f"model: T={ens.n_trees} D={ens.depth} C={ens.n_outputs} "
          f"F={ens.n_features} B={ens.borders.shape[0]}; "
          f"{len(x_test)} test rows")

    ops.reset_launch_counts()
    out, phases, plan, buckets = serve(ens, x_test)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"main-path launches: {launches}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the main path")

    n, c = len(x_test), ens.n_outputs
    for name, proba in out.items():
        rows = N_REQUESTS if name == "single" else n
        check(proba.shape == (rows, c), f"{name} proba shape {proba.shape}")
        check(bool(np.isfinite(proba).all()), f"{name} proba not finite")
        check(bool(np.allclose(proba.sum(1), 1.0, atol=1e-5)),
              f"{name} proba rows do not sum to 1")
    classes = {k: v.argmax(1) for k, v in out.items()}
    check(np.array_equal(classes["fused"], classes["pool"]),
          "fused and pool paths classify differently")
    check(np.array_equal(classes["fused"], classes["staged"]),
          "fused and staged paths classify differently")
    check(np.array_equal(classes["single"], classes["fused"][:N_REQUESTS]),
          "single requests classify differently from the batch")
    path_diff = max(float(np.abs(out["fused"] - out[k]).max())
                    for k in ("pool", "staged"))
    recompiles = plan.stats["traces"]
    check(all(recompiles.get(e, 0) <= len(buckets)
              for e in ("proba", "proba_pool")),
          f"more first calls than the {len(buckets)} buckets: {recompiles}")

    # the card against the plain plan on the CPU, on a small input
    cpu_plan = Predictor.build(ens, device="cpu")
    xs = x_test[:N_REFERENCE]
    raw_cpu = cpu_plan.raw(xs)
    raw_gpu = plan.raw(xs).cpu()
    low = cpu_plan.lowered
    idx_cpu = ops.leaf_index(cpu_plan.quantize(xs).bins, low.split_features,
                             low.split_bins)
    limit = sum_limit(idx_cpu, low.leaf_values, cpu_plan.ensemble.base_score)
    ref_err, ref_share = compare_sums("card vs CPU raw scores", raw_gpu,
                                      raw_cpu, limit)
    top2 = raw_cpu.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * limit.max(dim=1).values
    agree = classify_from_raw(raw_gpu, c) == classify_from_raw(raw_cpu, c)
    check(bool(agree[clear].all()), "card and CPU classify differently")

    kernels, control, tree_padding = check_and_time_kernels(
        x_test, plan, launches, (n, MAX_BATCH, buckets[0]))
    torch.cuda.synchronize()

    print(json.dumps({"checks": {
        "paths_max_abs_diff": path_diff,
        "card_vs_cpu_max_abs_err": ref_err,
        "card_vs_cpu_err_over_limit": ref_share,
        "card_vs_cpu_rows_compared": int(clear.sum()),
        "first_calls": recompiles, "kernel_rows_compared": [
            n, MAX_BATCH, buckets[0]],
        "float_limit": f"{K_SIGMA:g}*sqrt(T)*u*sum|leaf| per output",
        "tolerance_control": control, "tree_padding": tree_padding}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serving": phases, "card": card,
                      "build_seconds": build_s}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

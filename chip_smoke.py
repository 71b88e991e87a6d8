#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on an H100 and check it.

Run from the root of a checkout, on a machine with one Hopper card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/`,
serves a random-weight oblivious-tree model at the full width of the
paper's Covertype workload (54 features, 7 classes, depth 8, 63 borders,
1,000 trees, a tenth of them truncated: 8 depth groups) through
`GBDTServer` on each layout in turn (soa, depth_major, depth_grouped,
bitpacked), then the same model untruncated (one depth group) on
bitpacked, whose fused route is its own kernel.  Each of these serving
paths runs single requests, `predict_batch` over the test split,
`quantize` + `predict_pool` and one staged `proba` call, with the kernel
launch counts set to 0 before it and read after it.  It checks:

  * each path launched exactly the kernels of its layout, and every one
    of the eight kernels was launched;
  * the fused, pool and staged routes of each path classify the same;
  * depth_major gives soa's scores bit for bit on every route, bitpacked
    gives depth_grouped's, and one-group bitpacked fused gives soa fused's
    on the untruncated model (the same trees summed in the same order);
    depth_grouped and bitpacked agree with soa within `sum_limit` (the
    group sums reassociate) and in class on rows with a clear margin;
  * the card's scores agree with the plain PyTorch plan on the CPU, on
    every layout;
  * each kernel agrees with its plain version on the card at every row
    count the main path gives it (the whole test split, the largest and
    the smallest serving bucket): integers exactly, float sums within the
    rounding limit of `sum_limit`, which a bf16 leaf table must fail.

Then it times each kernel at the serving path's bulk shape and at the
1,024-row bucket beside its plain version, one PyTorch library call where
one computes the same function, and the least time the card could take
(`bound_ms`), and times the soa tree-looping kernels once more on a model
padded to a multiple of 32 trees.  The last three lines of output are the
`kernels` JSON, the serving JSON and the result line.  Any failed check
exits non-zero before the result line.
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
N_LAYOUT_REQUESTS = 16  # single requests on each path after soa
STAGED_REPEATS = 5      # bulk staged calls timed after the first
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
    """Covertype-width ensemble with numpy-seeded splits and leaves: the
    uniform depth-8 model and the same model with a tenth of its trees
    truncated (so PAD_SPLIT_BIN is on the path, and depth groups are)."""
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
    return ens, truncate_tree_depths(ens, depths)


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


def check_and_time_layout_kernels(x_test: np.ndarray, dm, bp, bp_one,
                                  launches, check_rows: tuple[int, ...]):
    """Hold the depth_major and bitpacked kernels against their plain
    versions on the card at each row count in `check_rows`, then time
    them at the bulk shape and at the largest serving bucket.

    `dm` and `bp` are the truncated model's depth_major and bitpacked
    layouts (8 depth groups, uint8 threshold planes except the int32
    group of the clamped depth-0 trees), `bp_one` the untruncated model's
    bitpacked layout (one group).  leaf_index_bp runs on every group of
    `bp` and on the one group with its planes as uint8 and widened to
    int32, each from uint8 and int32 bins; fused_predict_bp on the one
    group with both plane dtypes."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.binarize import binarize
    from repro_torch.kernels.fused_predict import (fused_predict_bp,
                                                   fused_predict_dm)
    from repro_torch.kernels.leaf_index import leaf_index_bp, leaf_index_dm

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
            out[f"leaf_index_{name}"] = dict(
                kernel=lambda k=index_k, p=planes: k(bn, *p),
                plain=lambda k=index_ref, p=planes: k(bn, *p),
                bytes=n * n_feat + plane_bytes + n * t * 4,
                ops=n * t * d, n_trees=t)
            out[f"fused_predict_{name}"] = dict(
                kernel=lambda k=fused_k, p=planes, lv=lv:
                    k(xn, borders, *p, lv),
                plain=lambda k=fused_ref, p=planes, lv=lv:
                    k(xn, borders, *p, lv),
                bytes=n * n_feat * 4 + n_b * n_feat * 4 + plane_bytes
                + lv.numel() * 4 + n * c * 4,
                ops=n * n_feat * n_b + n * t * d + n * t * c, n_trees=t)
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
        })
    return rows, of_limit


# The kernels each serving path launches, and no others.
PATH_KERNELS = {
    "soa": {"binarize", "leaf_index", "leaf_gather", "fused_predict"},
    "depth_major": {"binarize", "leaf_index_dm", "leaf_gather",
                    "fused_predict_dm"},
    "depth_grouped": {"binarize", "leaf_index", "leaf_gather"},
    "bitpacked": {"binarize", "leaf_index_bp", "leaf_gather"},
    "bitpacked_one_group": {"binarize", "leaf_index_bp", "leaf_gather",
                            "fused_predict_bp"},
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
    full, ens = make_model(data.x_train, data.n_classes)
    x_test = data.x_test
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
    paths, path_launches, buckets = {}, {}, None
    for path, (model, layout, n_requests) in path_specs.items():
        ops.reset_launch_counts()
        out, phases, plan, staged, buckets = serve(model, x_test, layout,
                                                   n_requests)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        print(f"{path} launches: {counts}", flush=True)
        for name, count in counts.items():
            check((count > 0) == (name in PATH_KERNELS[path]),
                  f"the {path} path launched {name} {count} times; it "
                  f"launches exactly {sorted(PATH_KERNELS[path])}")
        paths[path] = dict(out=out, phases=phases, plan=plan, staged=staged,
                           model=model, n_requests=n_requests)
        path_launches[path] = counts
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
        x_test, paths["depth_major"]["plan"].lowered,
        paths["bitpacked"]["plan"].lowered,
        paths["bitpacked_one_group"]["plan"].lowered, launches, check_rows)
    kernels += layout_kernels
    control["kernel_err_over_limit"].update(layout_of_limit)
    torch.cuda.synchronize()

    print(json.dumps({"checks": {
        "paths_max_abs_diff": path_diff,
        "layouts_vs_soa": layout_err,
        "card_vs_cpu": card_vs_cpu,
        "first_calls": recompiles, "kernel_rows_compared": list(check_rows),
        "float_limit": f"{K_SIGMA:g}*sqrt(T)*u*sum|leaf| per output",
        "tolerance_control": control, "tree_padding": tree_padding}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serving": {p: rec["phases"]
                                  for p, rec in paths.items()},
                      "launches": path_launches, "card": card,
                      "build_seconds": build_s}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

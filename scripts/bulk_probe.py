#!/usr/bin/env python3
"""Where a bulk-scoring chunk's time goes on the card.

Runs `BulkScorer` over the smoke's bulk source (the Covertype test split
served 8 times over: 1,115,520 rows x 54) with a numpy-seeded random model
of the smoke's shape (1,000 trees, depth 8, 7 outputs, the 63 borders
`compute_borders` gives on the training split), and prints one JSON object:

  * `runs`: rows/s and the metrics' per-chunk split for each chunk size in
    `--chunks`, each prefetch depth in `--depths` (and the depth the
    scorer used: `tuning.prefetch_depth`), one plan and the
    smoke's three (full, its first half, the two halves joined), pools and
    float chunks;
  * `host_us`: the time of each piece of one chunk, called alone in a
    loop on the host clock with no synchronization, so the larger of the
    host's and the card's time a call (the source's read, the worker's
    copy and quantize with its event wait, one plan's pool entry with and
    without a copy back, each sink's write), at every chunk size;
  * `device_ms`: the card's time for one chunk's kernels, CUDA events
    around 20 chunks' worth.

Run from the root of a checkout on a machine with one Hopper card:

    python3 scripts/bulk_probe.py [--chunks 4096,16384,65536] [--depths 0,2]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def model(seed: int = 0):
    import torch
    from repro_torch.core.quantize import compute_borders
    from repro_torch.core.trees import ObliviousEnsemble
    from repro_torch.data.synthetic import covertype
    data = covertype(scale=1.0, seed=0)
    borders, n_borders = compute_borders(data.x_train, 64)
    rng = np.random.default_rng(seed)
    t, d, c = 1000, 8, 7
    sf = rng.integers(0, 54, (t, d)).astype(np.int32)
    nb = np.maximum(n_borders.numpy()[sf], 1)
    sb = (1 + rng.random((t, d)) * nb).astype(np.int32)
    return ObliviousEnsemble(
        torch.from_numpy(sf), torch.from_numpy(sb),
        torch.from_numpy(rng.normal(scale=0.1, size=(t, 1 << d, c))
                         .astype(np.float32)),
        borders, n_borders)


def loop_us(fn, reps: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", default="4096,16384,65536")
    ap.add_argument("--depths", default="0,2")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("bulk_probe: no CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.predictor import Predictor
    from repro_torch.core.trees import concat_ensembles
    from repro_torch.scoring import (ArraySink, BulkScorer, NpySink,
                                     ScoreConfig, StatsSink,
                                     SyntheticSource, TopKSink)
    from repro_torch.scoring.scorer import _ChunkIO

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    full = model()
    half = full.slice_trees(0, 500)
    joined = concat_ensembles(half, full.slice_trees(500, 1000))
    plans = {n: Predictor.build(e, device="cuda", layout="soa")
             for n, e in (("full", full), ("half", half),
                          ("joined", joined))}
    source = SyntheticSource("covertype", split="test", repeat=8)
    chunks = [int(c) for c in args.chunks.split(",")]
    depths = [int(d) for d in args.depths.split(",")]
    out = {"card": card, "rows": source.n_rows, "runs": [],
           "host_us": {}, "device_ms": {}}

    with tempfile.TemporaryDirectory() as tmp:
        def three_sinks():
            return {"full": NpySink(os.path.join(tmp, "full.npy")),
                    "half": StatsSink(), "joined": TopKSink(100)}

        for chunk in chunks:
            for depth in depths:
                for prequantize in (True, False):
                    for which in ("one", "three"):
                        cfg = ScoreConfig(chunk_rows=chunk, output="proba",
                                          prefetch_depth=depth,
                                          prequantize=prequantize)
                        ps = plans if which == "three" \
                            else {"full": plans["full"]}
                        rates = []
                        for _ in range(3):
                            if which == "three":
                                sinks = three_sinks()
                            else:
                                sinks = {"full": ArraySink()}
                            res = BulkScorer(ps, cfg).score(source, sinks)
                            torch.cuda.synchronize()
                            rates.append(res.metrics["rows_per_s"])
                        m = res.metrics
                        out["runs"].append({
                            "chunk_rows": chunk, "prefetch_depth": depth,
                            "prefetch_used": m["prefetch_depth"],
                            "prequantize": prequantize, "plans": which,
                            "rows_per_s": rates,
                            "chunk_p50_ms": m["chunk_p50_ms"],
                            "quantize_s": m["quantize_s"],
                            "score_s": m["score_s"], "wall_s": m["wall_s"]})
                        print(json.dumps(out["runs"][-1]), flush=True)

        for chunk in chunks:
            x = source.read(0, chunk)
            xd = torch.as_tensor(x, device="cuda")
            io = _ChunkIO(torch.device("cuda", 0), chunk, 54)
            rep = plans["full"]
            host = {}
            host["source_read"] = loop_us(lambda: source.read(0, chunk), 50)

            def worker():
                with io.side_stream():
                    pool = rep.quantize(io.to_device(x, chunk))
                    io.finish()
                return pool
            host["worker_prepare"] = loop_us(worker, 50)
            pool = worker()
            torch.cuda.synchronize()
            host["plan_proba_pool"] = loop_us(lambda: rep.proba(pool), 50)
            torch.cuda.synchronize()
            host["plan_proba_pool_copy_back"] = loop_us(
                lambda: io.to_host("full", rep.proba(pool)), 50)
            torch.cuda.synchronize()
            ys = rep.proba(pool).cpu().numpy()
            for name, sink in (("npy", NpySink(os.path.join(tmp, "s.npy"))),
                               ("stats", StatsSink()),
                               ("topk", TopKSink(100)),
                               ("array", ArraySink())):
                sink.open(chunk * 60, 7)
                host[f"sink_{name}"] = loop_us(
                    lambda: sink.write(0, np.array(ys, np.float32)), 50)
                sink.close()
            out["host_us"][chunk] = host

            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            for name, entry in (("pool_3_plans", lambda: [
                    p.proba(pool) for p in plans.values()]),
                    ("float_3_plans", lambda: [
                        p.proba(xd) for p in plans.values()]),
                    ("quantize", lambda: rep.quantize(xd))):
                entry()
                torch.cuda.synchronize()
                start.record()
                for _ in range(20):
                    entry()
                end.record()
                end.synchronize()
                out["device_ms"].setdefault(chunk, {})[name] = \
                    start.elapsed_time(end) / 20
            print(json.dumps({chunk: {"host_us": host,
                                      "device_ms": out["device_ms"][chunk]}}),
                  flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

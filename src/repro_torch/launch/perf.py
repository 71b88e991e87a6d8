"""The "SSPerf" runner: the port's counterpart of
`src/repro/launch/perf.py`, with the same cells, variants and overrides.

Runs named optimization variants on the three LM cells through the dry
run (`launch/dryrun.analyze_cell`: traced on a fake 256-rank group,
costed on the H100's hardware model), and the `gbdt-predict` cell's four
ways of issuing repeated predicts against one model on a device (the card
by default, a CUDA sync around each call).  Each variant records
hypothesis -> change -> result into results/perf_torch/.

  python -m repro_torch.launch.perf --cell kimi-train [--variant expert2d]
  python -m repro_torch.launch.perf --all [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "perf_torch"
GBDT_BATCH = 256          # rows a predict call
GBDT_CALLS = 20           # timed calls a variant, after one warm call

# (variant name, cfg overrides, hypothesis text)
CELLS = {
    "kimi-train": {
        "arch": "kimi-k2-1t-a32b", "shape": "train_4k",
        "variants": [
            ("baseline", {},
             "paper-faithful baseline: EP(model) + FSDP(data) experts"),
            ("expert2d", {"moe_shard": "expert2d"},
             "FSDP all-gathers ~2 GB of expert weights per layer per step;"
             " sharding d_ff over 'data' (weights fully sharded, never"
             " gathered) trades them for smaller activation reshards:"
             " expect collective bytes to drop several x"),
            ("no-remat", {"remat": False},
             "remat recomputes the fwd pass inside bwd: expect ~25% fewer"
             " FLOPs and fewer memory ops, at higher live-activation"
             " memory (temp bytes up)"),
            ("remat-dots", {"remat_policy": "dots"},
             "middle ground: save matmul outputs, recompute elementwise"
             " only - expect most of no-remat's byte win while keeping"
             " live activations bounded"),
            ("moe-group-4096", {"moe_group_size": 4096},
             "larger routing groups -> fewer groups x bigger capacity"
             " slack: slightly fewer dispatch ops, bigger slot buffers;"
             " expect small memory-term change, informative either way"),
        ],
    },
    "internvl2-prefill": {
        "arch": "internvl2-1b", "shape": "prefill_32k",
        "variants": [
            ("baseline", {},
             "paper-faithful baseline: q-chunked attention, chunk=1024"),
            ("chunk-4096", {"attn_chunk": 4096},
             "14 heads don't shard on the 16-way model axis, so every"
             " device re-runs full attention; bigger q-chunks amortize"
             " per-chunk mask/softmax overheads and intermediate"
             " materialization: expect memory term down"),
            ("chunk-512", {"attn_chunk": 512},
             "counter-probe: smaller chunks shrink live buffers but add"
             " per-chunk overhead ops; expect memory term UP (confirms"
             " the chunk-size direction)"),
            ("no-remat", {"remat": False},
             "prefill is inference: remat buys nothing (no bwd) but the"
             " policy still wraps the scan body; expect fewer bytes"),
            ("ring-attention", {"attention_impl": "ring"},
             "the correct sequence-parallel attention: Q/K/V sharded on S"
             " over 'model', KV blocks ppermute around the ring with an"
             " online softmax. Each shard computes S/16 of the queries -"
             " the 16x replication disappears: expect compute AND"
             " memory terms down ~an order of magnitude"),
            ("seq-parallel", {"sequence_parallel": True},
             "diagnosis: 14 heads cannot shard the 16-way model axis, so"
             " the whole forward is REPLICATED on every model shard."
             " Sequence parallelism shards the 32k sequence over 'model'"
             " between blocks: expect compute and memory terms to drop"
             " up to ~16x (attention still gathers around the block)"),
        ],
    },
    "internlm2-decode": {
        "arch": "internlm2-20b", "shape": "decode_32k",
        "variants": [
            ("baseline", {},
             "paper-faithful baseline: plain decode attention; the"
             " seq-sharded KV cache is all-gathered every layer"),
            ("flash-decode", {"flash_decode": True},
             "beyond-paper: flash-decode computes partial softmax per KV"
             " shard and combines via LSE all-reduces - the 32k-token KV"
             " all-gather disappears; expect collective bytes down >10x"
             " and memory term down (no gathered-KV materialization)."
             " Mirrors the paper's lesson inverted: keep data where it"
             " lives, move the tiny reduction"),
        ],
    },
    # The paper's own workload, driven through the prediction API: each
    # variant is one way of issuing repeated predicts against a fixed
    # model (runner="gbdt" -> timed on a device in-process, not a mesh
    # dry run).
    "gbdt-predict": {
        "runner": "gbdt",
        "variants": [
            ("kwarg-path", {"mode": "kwarg"},
             "seed behaviour: kwarg-threaded raw_predict re-resolves"
             " auto strategy/backend and re-pads the model arrays on"
             " every call - per-call work the paper hoists"),
            ("prepared-plan", {"mode": "prepared"},
             "Predictor.build resolves + pads once and dispatches"
             " through a shape-cached entry: expect per-call time to"
             " drop to the kernel cost alone"),
            ("prepared-tree-block", {"mode": "prepared", "tree_block": 16},
             "CalcTreesBlockedImpl on the prepared plan: tree-block"
             " slices cut at build time; expect parity or better at"
             " equal math (blocks only pay off once leaf tables"
             " outgrow cache)"),
            ("prequantized", {"mode": "pool"},
             "quantized-first evaluation: plan.quantize(x) binarizes"
             " once into a uint8 QuantizedPool, plan.raw(pool) skips"
             " BinarizeFloatsNonSse entirely - the paper's evaluators"
             " never touch float features; expect per-call time to"
             " drop by the binarize share of the pipeline"),
        ],
    },
}


def gbdt_workload(device: str = "cuda"):
    """The gbdt-predict cell's model and batch: 60 MultiClass trees of
    depth 5 trained on synthetic Covertype at scale 0.003, and 256 test
    rows (repeated up to that count), on `device`."""
    from repro_torch.core import boosting, losses
    from repro_torch.core.boosting import BoostingParams
    from repro_torch.data import synthetic

    ds = synthetic.load("covertype", scale=0.003)
    loss = losses.make_loss("multiclass", n_classes=7)
    ens, _ = boosting.fit(ds.x_train, ds.y_train, loss=loss,
                          params=BoostingParams(n_trees=60, depth=5,
                                                learning_rate=0.3),
                          device=device)
    xs = np.asarray(ds.x_test, np.float32)
    while len(xs) < GBDT_BATCH:
        xs = np.concatenate([xs, xs])
    return ens, torch.as_tensor(xs[:GBDT_BATCH], device=device)


def gbdt_predict_fn(ens, x: torch.Tensor, overrides: dict,
                    device: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The variant's predict call (the batch in, raw scores out); the
    pool variant binarizes `x` once, here."""
    from repro_torch.core import predict
    from repro_torch.core.predictor import PredictConfig, Predictor

    tree_block = int(overrides.get("tree_block", 0))
    if overrides.get("mode") == "pool":
        plan = Predictor.build(ens, PredictConfig(strategy="staged"),
                               device=device)
        pool = plan.quantize(x)              # binarize ONCE, outside loop
        return lambda _xb: plan.raw(pool)
    if overrides.get("mode") == "prepared":
        plan = Predictor.build(ens, PredictConfig(strategy="staged",
                                                  tree_block=tree_block),
                               device=device)
        return plan.raw
    return lambda xb: predict.raw_predict(ens, xb, strategy="staged",
                                          tree_block=tree_block,
                                          device=device)


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _run_gbdt_variant(overrides: dict, device: str = "cuda",
                      workload=None) -> dict:
    """Time one predict-path variant: the median of `GBDT_CALLS` calls
    after a warm one, each between two syncs."""
    ens, x = workload or gbdt_workload(device)
    fn = gbdt_predict_fn(ens, x, overrides, device)
    fn(x)                                   # warm: builds, first calls
    _sync(device)
    ts = []
    for _ in range(GBDT_CALLS):
        t0 = time.perf_counter()
        fn(x)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    name = (torch.cuda.get_device_name(torch.device(device))
            if torch.device(device).type == "cuda" else "cpu")
    return {"status": "ok", "us_per_call": float(np.median(ts)) * 1e6,
            "batch": int(x.shape[0]), "n_trees": ens.n_trees,
            "device": name}


def run(cell: str, only_variant: Optional[str] = None, force: bool = False,
        device: str = "cuda") -> list[dict]:
    from repro_torch.launch import dryrun
    spec = CELLS[cell]
    RESULTS.mkdir(parents=True, exist_ok=True)
    out = []
    workload = None
    for name, overrides, hypothesis in spec["variants"]:
        if only_variant and name != only_variant:
            continue
        path = RESULTS / f"{cell}__{name}.json"
        if path.exists() and not force:
            out.append(json.loads(path.read_text()))
            continue
        try:
            if spec.get("runner") == "gbdt":
                workload = workload or gbdt_workload(device)
                res = _run_gbdt_variant(overrides, device, workload)
            else:
                res = dryrun.analyze_cell(spec["arch"], spec["shape"],
                                          multi_pod=False,
                                          cfg_overrides=overrides)
        except Exception as e:   # record failures too: refuted != broken
            res = {"status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
        res["variant"] = name
        res["hypothesis"] = hypothesis
        res["overrides"] = overrides
        path.write_text(json.dumps(res, indent=1, default=str))
        out.append(res)
        if res.get("status") != "ok":
            print(f"{cell:20s} {name:16s} ERROR {res.get('error','')[:120]}",
                  flush=True)
        elif "us_per_call" in res:
            print(f"{cell:20s} {name:16s} {res['us_per_call']:.0f}us/call "
                  f"batch={res['batch']} on {res['device']}", flush=True)
        else:
            print(f"{cell:20s} {name:16s} comp={res['compute_s']:.3g}s "
                  f"mem={res['memory_s']:.3g}s coll={res['collective_s']:.3g}s"
                  f" dom={res['dominant']}", flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(CELLS))
    ap.add_argument("--variant")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the gbdt-predict cell runs (cuda or cpu)")
    args = ap.parse_args(argv)
    cells = list(CELLS) if args.all or not args.cell else [args.cell]
    failed = 0
    for c in cells:
        failed += sum(r.get("status") != "ok"
                      for r in run(c, args.variant, args.force, args.device))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

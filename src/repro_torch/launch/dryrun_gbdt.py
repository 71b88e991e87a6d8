"""Production-mesh dry run of the paper's OWN model: a CatBoost-scale GBDT
ensemble served at batch on 256 / 512 cards.  The port's counterpart of
`src/repro/launch/dryrun_gbdt.py`, at its sizes.

Cells:
  gbdt-predict-1m   1,048,576 x 54 rows, 10k trees of depth 8, 7 classes,
                    255 borders: rows shard over (pod, data), trees over
                    model, the partial scores summed over model
  gbdt-train-iter   one boosting iteration (gradients, the level
                    histograms and splits, leaf values) on the rows of one
                    (pod, data) shard

Each cell traces what one device runs, under `FakeTensorMode`:

  * predict-1m runs one shard (65,536 rows and 625 trees on 16 x 16;
    32,768 rows on 2 x 16 x 16) through the port's serving path, a
    `Predictor` plan on a fake card (`Predictor.trace_entries`), so it
    counts the hand kernels the card runs, each launch costed from its
    shapes (`hlo_analysis.launch_cost`).  JAX's cell runs the plain `ref`
    chain inside `shard_map`; the JSON names the difference.  The
    collective is the sum of the (rows, classes) partial scores over
    model, one all-reduce, counted from its shape;
  * train-iter runs `core.boosting._build_tree` on one device's rows.
    JAX's GSPMD sums each segment sum (each level's histogram, then the
    leaf sums) over the data axes; the port counts each as one all-reduce
    of its result.

  python -m repro_torch.launch.dryrun_gbdt [--multi-pod] [--single-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import time
import traceback
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import convert
from repro_torch.analysis import trace_tools as tt
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch.dryrun import DEPTH as TRACED_DEPTH, HARDWARE
from repro_torch.launch.mesh import PRODUCTION_SHAPES

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"

N_ROWS, N_FEATS = 1_048_576, 54
N_TREES, DEPTH, N_CLASSES, N_BINS = 10_000, 8, 7, 255
MAX_BINS, L2 = 64, 3.0                     # train-iter, as JAX's
SEED = 0
CELLS = ("predict-1m", "train-iter")
ROUTE_NOTE = ("the port's serving plan and its hand kernels on one "
              "device's shard; JAX's cell runs the plain ref chain "
              "(binarize, leaf_index, leaf_gather) in shard_map")
LEAF_NOTE = ("leaf_gather and the fused kernels' bytes count the whole "
             "leaf table, an upper bound: the rows a batch touches depend "
             "on the data")
# the cells' work is fp32 compares, adds and gathers off the tensor cores
# (no product): priced at the fp32 rate, as the launches' bounds are, not
# at the LM cells' bf16 tensor-core peak
COMPUTE_RATE = hlo.FP32_FLOPS
RATE_NOTE = ("compute_s and roofline_fraction at the fp32 rate off the "
             "tensor cores (67 TFLOP/s), as each launch's bound; JAX's "
             "cell divides by its bf16 peak")
PSUM_NOTE = ("each segment sum over the device's rows (the 8 level "
             "histograms, the leaf sums) is one all-reduce of its result "
             "over the data axes: JAX's GSPMD inserts it, the port counts "
             "it")


def mesh_sizes(multi_pod: bool) -> dict:
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return dict(zip(axes, shape))


def shard_shape(multi_pod: bool) -> tuple[int, int, int]:
    """(rows, trees, devices) of one device's predict shard."""
    sizes = mesh_sizes(multi_pod)
    dp = math.prod(s for a, s in sizes.items() if a in ("pod", "data"))
    return N_ROWS // dp, N_TREES // sizes["model"], math.prod(sizes.values())


def random_ensemble(n_trees: int, seed: int = SEED):
    """A numpy-seeded ensemble of the cell's width on the CPU: depth 8,
    54 features, 255 borders, 7 classes, base score 0 (a tree shard's
    partial score, as JAX's `local` sums it)."""
    rng = np.random.default_rng(seed)
    return convert.ensemble_from_numpy({
        "split_features": rng.integers(0, N_FEATS, (n_trees, DEPTH))
        .astype(np.int32),
        "split_bins": rng.integers(1, N_BINS + 1, (n_trees, DEPTH))
        .astype(np.int32),
        "leaf_values": (0.1 * rng.normal(size=(n_trees, 1 << DEPTH,
                                               N_CLASSES)))
        .astype(np.float32),
        "borders": np.sort(rng.normal(size=(N_BINS, N_FEATS)), 0)
        .astype(np.float32),
        "n_borders": np.full((N_FEATS,), N_BINS, np.int32),
        "base_score": np.zeros((N_CLASSES,), np.float32)})


def random_rows(n_rows: int, seed: int = SEED + 1) -> np.ndarray:
    """`n_rows` x 54 rows of x, 5% NaN."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_rows, N_FEATS)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    return x


def trace_predict(multi_pod: bool) -> dict:
    """One device's predict-1m shard through a plan on a fake card."""
    from repro_torch.analysis.checker import fake_cuda_plan

    rows, trees, n_dev = shard_shape(multi_pod)
    ens = random_ensemble(trees)
    mode = tt.new_fake_mode()
    plan = fake_cuda_plan(ens, mode)
    # the aten ops counted as every other cell counts them, the launches
    # recorded (not made) and costed from their shapes
    with tt.recording(mode) as trace, hlo.counting() as counter:
        plan.raw(torch.empty((rows, N_FEATS), device=plan.device))
    launches = [dict(hlo.launch_cost(e.record),
                     shapes=[list(s) for _, s in hlo.launch_shapes(
                         e.record)[1]])
                for e in trace.launches()]
    costs = counter.costs()
    costs.update(flops=costs["flops"] + sum(r["ops"] for r in launches),
                 bytes=costs["bytes"] + sum(r["bytes"] for r in launches),
                 op_bytes=costs["bytes"], launches=launches)
    partial = rows * N_CLASSES * 4          # (rows, classes) f32, psum
    args = sum(t.numel() * t.element_size() for t in (
        ens.split_features, ens.split_bins, ens.leaf_values, ens.borders)) \
        + rows * N_FEATS * 4
    return {"costs": costs, "coll": {"all-reduce": partial},
            "argument_bytes": args, "rows": rows, "trees": trees,
            "n_devices": n_dev,
            "plan": {"strategy": plan.config.strategy,
                     "layout": plan.config.layout,
                     "backend": plan.config.backend}}


class _BoundedBincount(TorchDispatchMode):
    """`bincount(ids, minlength=n)` answered as n counts: the segment ids
    `boosting._segment_sum` passes lie in [0, n), so its output has n
    entries, which a fake tensor cannot tell from its (absent) data."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten.bincount.default:
            n = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
            return torch.empty((n,), dtype=torch.int64, device=args[0].device)
        return func(*args, **kwargs)


@contextlib.contextmanager
def _psums_counted(counter: hlo.OpCounter) -> Iterator[None]:
    """Count each `boosting._segment_sum` result as one all-reduce."""
    from repro_torch.core import boosting

    segment_sum = boosting._segment_sum

    def counted(values, segments, n_segments):
        out = segment_sum(values, segments, n_segments)
        counter.add_collective("all-reduce", hlo.nbytes(out))
        return out
    boosting._segment_sum = counted
    try:
        yield
    finally:
        boosting._segment_sum = segment_sum


def trace_train_iter(multi_pod: bool, device: str = "cuda") -> dict:
    """One boosting iteration on one device's rows (JAX's `one_iter`)."""
    from repro_torch.core import boosting, losses

    rows, _, n_dev = shard_shape(multi_pod)
    loss = losses.MultiClass(n_classes=N_CLASSES)
    with tt.cardless_devices(), tt.new_fake_mode(), tt._FakeDeviceMode():
        bins = torch.empty((rows, N_FEATS), dtype=torch.int32, device=device)
        y = torch.empty((rows,), dtype=torch.int32, device=device)
        raw = torch.empty((rows, N_CLASSES), dtype=torch.float32,
                          device=device)
        n_borders = torch.full((N_FEATS,), N_BINS - 1, dtype=torch.int32,
                               device=device)
        with _BoundedBincount(), hlo.counting() as counter, \
                _psums_counted(counter):
            g, h = loss.grad_hess(raw, y)
            sf, sb, sum_g, sum_h, leaf = boosting._build_tree(
                bins, g, h, n_borders, None, depth=DEPTH,
                max_bins=MAX_BINS, l2=L2, rsm=1.0)
            w = -0.5 * sum_g / (sum_h + L2)
            raw = raw + w[leaf]
    args = rows * N_FEATS * 4 + rows * 4 + rows * N_CLASSES * 4
    return {"costs": counter.costs(), "coll": dict(counter.coll),
            "calls": {k: v for k, v in counter.coll_calls.items() if v},
            "argument_bytes": args, "rows": rows, "n_devices": n_dev}


def model_flops(name: str) -> int:
    """binarize compares + index + gather adds (predict); the histogram
    work (train), as JAX counts them, but for the compares: a binary
    search's over the 255 borders (`hlo_analysis.compares`, 8), where
    JAX counts a scan of all 255."""
    if name == "predict-1m":
        return N_ROWS * (N_FEATS * hlo.compares(N_BINS) + N_TREES * DEPTH
                         + N_TREES * N_CLASSES)
    return N_ROWS * N_FEATS * DEPTH * 2 * N_CLASSES


def analyze(name: str, multi_pod: bool) -> dict:
    t0 = time.perf_counter()
    traced = (trace_predict(multi_pod) if name == "predict-1m"
              else trace_train_iter(multi_pod))
    trace_s = time.perf_counter() - t0
    costs, n_dev = traced["costs"], traced["n_devices"]
    coll = hlo.collective_bytes(traced["coll"])
    flops_dev, bytes_dev = costs["flops"], costs["bytes"]
    mf = model_flops(name)
    # JAX's formulas (the collective term divides one device's bytes by
    # the device count a second time)
    terms = {"compute_s": flops_dev / COMPUTE_RATE,
             "memory_s": bytes_dev / hlo.HBM_BW,
             "collective_s": coll["total"] / (n_dev * hlo.LINK_BW)}
    res = {
        "arch": f"gbdt-{name}", "shape": "paper", "multi_pod": multi_pod,
        "n_devices": n_dev, "trace_seconds": round(trace_s, 1),
        "depth": TRACED_DEPTH, "hardware": HARDWARE,
        "compute_rate": RATE_NOTE,
        "rows_per_device": traced["rows"],
        "flops_per_device": flops_dev, "bytes_per_device": bytes_dev,
        "collective_bytes": coll,
        "memory_analysis": {"argument_bytes": traced["argument_bytes"]},
        "model_flops": mf,
        "useful_flops_ratio": (mf / (flops_dev * n_dev)
                               if flops_dev else 0.0),
        **terms,
        "dominant": max(terms, key=terms.get),
        "roofline_fraction": (mf / (n_dev * COMPUTE_RATE)
                              / max(terms.values())
                              if max(terms.values()) > 0 else 0.0),
        "status": "ok",
    }
    if name == "predict-1m":
        launches = costs["launches"]
        res.update({
            "trees_per_device": traced["trees"], "plan": traced["plan"],
            "route": ROUTE_NOTE, "leaf_bytes": LEAF_NOTE,
            "launches": launches,
            "kernel_bound_s": sum(r["bound_ms"] for r in launches) / 1e3,
            "collective": "the partial scores' sum over model, one "
                          "all-reduce of (rows, classes) f32"})
    else:
        res.update({"collective": PSUM_NOTE,
                    "collective_calls": traced["calls"]})
    return res


def cell_path(name: str, multi_pod: bool) -> pathlib.Path:
    pod = "multipod" if multi_pod else "singlepod"
    return RESULTS / f"gbdt-{name}__paper__{pod}.json"


def run_cell(name: str, multi_pod: bool, force: bool = False) -> dict:
    path = cell_path(name, multi_pod)
    if path.exists() and not force:
        return json.loads(path.read_text())
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        res = analyze(name, multi_pod)
    except Exception as e:          # a cell that fails is a result
        res = {"arch": f"gbdt-{name}", "shape": "paper",
               "multi_pod": multi_pod, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-3000:]}
    path.write_text(json.dumps(res, indent=1, default=str))
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    pods = ([True] if args.multi_pod else []) + \
        ([False] if args.single_pod or not args.multi_pod else [])
    failed = 0
    for mp in pods:
        for cell in CELLS:
            r = run_cell(cell, mp, args.force)
            failed += r["status"] != "ok"
            print(f"[{'2x16x16' if mp else '16x16'}] gbdt-{cell:12s} "
                  f"{r['status']} dom={r.get('dominant', '-')} "
                  f"trace={r.get('trace_seconds', '-')}s "
                  f"{r.get('error', '')[:100]}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Multi-pod dry run: trace every (architecture x input shape) cell on the
production meshes and read the roofline terms from the trace.  The port's
counterpart of `src/repro/launch/dryrun.py`.

Where JAX lowers and compiles a cell on 256 / 512 forced host devices,
the port joins a fake process group of 256 / 512 ranks as rank 0
(`distributed.runtime.fake_group`), places every leaf as a DTensor of
fake local shards by the cell's partition specs, and runs one step under
`FakeTensorMode`: nothing is computed and no memory is taken, but every
local op and collective rank 0 would issue is dispatched, and counted
(`hlo_analysis.OpCounter`) at its local shapes on the H100's hardware
model.  A sharding the models cannot run, or an unsupported collective,
fails here as it would on the cards.

Every layer is traced, so the costs are the full depth's ("traced at full
depth"): JAX's shallow probe compiles and their extrapolation exist only
because XLA counts a `while` body once.

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-20b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod|--single-pod]

Cells are cached as JSON under results/dryrun_torch/; `--force` traces
them again.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import pathlib
import time
import traceback
from typing import Iterator, Optional, Sequence

import torch

from repro_torch import configs
from repro_torch.analysis import trace_tools as tt
from repro_torch.configs.base import SHAPES, ShapeConfig, applicable_shapes
from repro_torch.distributed import runtime
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.mesh import make_mesh
from repro_torch.launch.hlo_analysis import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                             counting, nbytes)
from repro_torch.launch.mesh import PRODUCTION_SHAPES
from repro_torch.models import layers
from repro_torch.models import steps as steps_lib
from repro_torch.models import transformer as tf
from repro_torch.training import optimizer as opt_lib

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"
DEPTH = "traced at full depth"
HARDWARE = (f"NVIDIA H100 SXM5: {PEAK_FLOPS / 1e12:g} TFLOP/s dense bf16, "
            f"{HBM_BW / 1e12:g} TB/s HBM3, {LINK_BW / 1e9:g} GB/s NVLink "
            "(one direction)")


def input_specs(arch: str, shape_name: str) -> dict:
    """`trace_tools.Spec` stand-ins (shape, dtype) for every model input
    of the cell: JAX's `input_specs`."""
    return _input_specs(configs.get(arch), SHAPES[shape_name])


def _input_specs(cfg, shape: ShapeConfig) -> dict:
    """`input_specs` of any config (the tests' smoke configs too)."""
    B, S = shape.global_batch, shape.seq_len
    spec = tt.Spec
    if shape.kind == "decode":
        return {"tokens": spec((B, 1), torch.int32)}
    out = {}
    if shape.kind == "train":
        out["tokens"] = spec((B, S), torch.int32)
        out["labels"] = spec((B, S), torch.int32)
    else:
        out["tokens"] = spec((B, S - (cfg.frontend_seq
                                      if cfg.family == "vlm" else 0)),
                             torch.int32)
    if cfg.frontend:
        out["frontend_embeds"] = spec((B, cfg.frontend_seq, cfg.d_model),
                                      torch.float32)
    return out


def model_flops(cfg, shape: ShapeConfig) -> int:
    """MODEL_FLOPS: 6 N_active D (train), 2 N_active D (prefill), 2
    N_active B (decode: one token), as JAX counts them."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2 * n_active * shape.tokens
    return 2 * n_active * shape.global_batch


# --------------------------------------------------------------------------
# Fake leaves
# --------------------------------------------------------------------------
def fake_leaf(shape: Sequence[int], dtype: torch.dtype, spec, dm,
              device: str):
    """A DTensor of global `shape` on `dm`, placed by `spec` fitted to the
    shape, whose local shard is a fake tensor of this rank's local shape.
    Call inside the fake tensor mode."""
    shape = tuple(int(d) for d in shape)
    placements = shd.placements(shd.fit_specs(
        spec, torch.empty(shape, device="meta"), dm), dm)
    local, _ = layers.local_shape_and_offset(shape, dm, placements)
    return layers.from_local(torch.empty(local, dtype=dtype, device=device),
                             dm, placements, shape)


def fake_tree(tree, spec_tree, *, dm, device: str):
    """`fake_leaf` of every leaf of `tree` (anything with a shape and a
    dtype: `meta` tensors, `Spec`s) by the matching spec."""
    if isinstance(tree, dict):
        return {k: fake_tree(v, spec_tree[k] if isinstance(spec_tree, dict)
                             else spec_tree, dm=dm, device=device)
                for k, v in tree.items()}
    return fake_leaf(tree.shape, tree.dtype, spec_tree, dm, device)


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in `tree`."""
    leaves, _ = torch.utils._pytree.tree_flatten(tree)
    return sum(nbytes(t.to_local() if hasattr(t, "to_local") else t)
               for t in leaves if isinstance(t, torch.Tensor))


def make_dry_mesh(shape: tuple, axes: tuple, device: str):
    """The port's `Mesh` of `shape` whose every entry names `device` (one
    entry a fake rank)."""
    return make_mesh(shape, axes,
                     devices=[torch.device(device)] * math.prod(shape))


@contextlib.contextmanager
def _placement(mesh_shape: tuple, axes: tuple) -> Iterator[tuple]:
    """(mesh, place) for a trace on `mesh_shape`: inside a fake group of
    its size, the port's `Mesh` and a `place(leaves, specs)` that makes
    fake DTensor shards; on one device, no group, no mesh, and plain fake
    tensors."""
    n = math.prod(mesh_shape)
    if n == 1:
        device = runtime.dry_run_device_type()

        def place(tree, spec_tree=None):
            if isinstance(tree, dict):
                return {k: place(v) for k, v in tree.items()}
            return torch.empty(tuple(tree.shape), dtype=tree.dtype,
                               device=device)
        yield None, place, device
        return
    with runtime.fake_group(n) as device:
        mesh = make_dry_mesh(mesh_shape, axes, device)
        dm = runtime.device_mesh(mesh)          # before any fake mode
        yield mesh, functools.partial(fake_tree, dm=dm, device=device), \
            device


def trace_cell(cfg, shape: ShapeConfig, mesh_shape: tuple, axes: tuple
               ) -> dict:
    """Trace one step of the cell on a fake group of the mesh's size (one
    device: plain tensors, no mesh): its costs on rank 0, the local bytes
    of its arguments and outputs, and the trace's wall seconds.  JAX's
    `lower_cell` and `_cell_costs`."""
    n = math.prod(mesh_shape)
    t0 = time.perf_counter()
    with _placement(mesh_shape, axes) as (mesh, place, device):
        max_pos = shape.seq_len
        p_abs = tf.abstract_params(cfg, max_positions=max_pos)
        batch_abs = _input_specs(cfg, shape)
        if mesh is None:                    # one device: nothing to shard
            p_specs, b_specs = None, {"tokens": None}
        else:
            p_specs = shd.param_specs(cfg, mesh, max_positions=max_pos)
            b_specs = shd.batch_specs(cfg, shape, mesh)
        with tt.cardless_devices(), tt.new_fake_mode(), \
                tt._FakeDeviceMode():
            params = place(p_abs, p_specs)
            batch = {k: place(v, b_specs.get(k, b_specs["tokens"]))
                     for k, v in batch_abs.items()}
            if shape.kind == "train":
                opt = opt_lib.make(cfg)
                o_abs = opt.init(p_abs)
                opt_state = place(o_abs, p_specs and shd.opt_state_specs(
                    p_specs, opt.kind))
                args = (params, opt_state, batch)
                fn = steps_lib.make_train_step(cfg, opt, mesh=mesh)
            elif shape.kind == "prefill":
                args = (params, batch)
                fn = steps_lib.make_prefill_step(cfg, max_seq=shape.seq_len,
                                                 mesh=mesh)
            else:
                cache_abs = tf.init_cache(cfg, shape.global_batch,
                                          shape.seq_len, abstract=True)
                cache = place(cache_abs, mesh and shd.fit_specs(
                    shd.cache_specs(cfg, shape, mesh), cache_abs, mesh))
                args = (params, cache, batch["tokens"])
                fn = steps_lib.make_decode_step(cfg, mesh=mesh)
            argument_bytes = local_bytes(args)
            with counting() as counter:
                out = fn(*args)
            output_bytes = local_bytes(out)
    return {"mesh_shape": tuple(mesh_shape), "n_devices": n,
            "device_type": device, "costs": counter.costs(),
            "counter": counter,
            "collective_calls": {k: v for k, v in
                                 counter.coll_calls.items() if v},
            "memory_analysis": {"argument_bytes": argument_bytes,
                                "output_bytes": output_bytes},
            "trace_seconds": time.perf_counter() - t0}


def analyze_cell(arch: str, shape_name: str, *, multi_pod: bool,
                 cfg_overrides: Optional[dict] = None) -> dict:
    """One cell traced on its production mesh: its JSON record (JAX's
    `analyze_cell`)."""
    cfg = dataclasses.replace(configs.get(arch), **(cfg_overrides or {}))
    shape = SHAPES[shape_name]
    mesh_shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return cell_record(arch, cfg, shape, multi_pod,
                       trace_cell(cfg, shape, mesh_shape, axes))


def cell_record(arch: str, cfg, shape: ShapeConfig, multi_pod: bool,
                traced: dict) -> dict:
    """A traced cell's JSON record, with every key of JAX's that
    `roofline.render` and `report` read, on JAX's formulas."""
    n_dev = traced["n_devices"]
    costs = traced["costs"]
    mf = model_flops(cfg, shape)
    flops_global = costs["flops"] * n_dev
    bytes_global = costs["bytes"] * n_dev
    coll_total = costs["coll"].get("total", 0)
    compute_s = flops_global / (n_dev * PEAK_FLOPS)
    memory_s = bytes_global / (n_dev * HBM_BW)
    # JAX's formula: one device's collective bytes over (n_dev x link
    # rate), the device count divided out a second time
    coll_s = coll_total / (n_dev * LINK_BW)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    return {
        "arch": arch, "shape": shape.name, "multi_pod": multi_pod,
        "mesh": list(traced["mesh_shape"]), "n_devices": n_dev,
        "trace_seconds": round(traced["trace_seconds"], 1),
        "depth": DEPTH, "device_type": traced["device_type"],
        "hardware": HARDWARE,
        "flops_per_device": costs["flops"],
        "bytes_per_device": costs["bytes"],
        "ops_per_device": costs["ops"],
        "top_ops_by_bytes": costs["top_bytes"],
        "top_ops_by_flops": costs["top_flops"],
        "collective_bytes": costs["coll"],
        "collective_calls": traced["collective_calls"],
        "memory_analysis": traced["memory_analysis"],
        "model_flops": mf,
        "useful_flops_ratio": (mf / flops_global if flops_global else 0.0),
        **terms,
        "dominant": dominant,
        "roofline_fraction": (mf / (n_dev * PEAK_FLOPS)
                              / max(terms.values())
                              if max(terms.values()) > 0 else 0.0),
        "status": "ok",
    }


def cell_path(arch: str, shape_name: str, multi_pod: bool) -> pathlib.Path:
    pod = "multipod" if multi_pod else "singlepod"
    return RESULTS / f"{arch}__{shape_name}__{pod}.json"


def run_and_save(arch: str, shape_name: str, *, multi_pod: bool,
                 force: bool = False) -> dict:
    path = cell_path(arch, shape_name, multi_pod)
    if path.exists() and not force:
        return json.loads(path.read_text())
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        res = analyze_cell(arch, shape_name, multi_pod=multi_pod)
    except Exception as e:          # a cell that fails is a result
        res = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    path.write_text(json.dumps(res, indent=1, default=str))
    return res


def all_cells() -> list[tuple[str, str]]:
    return [(arch, shp) for arch, cfg in configs.ARCHS.items()
            for shp in applicable_shapes(cfg)]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    pods = []
    if args.multi_pod or not args.single_pod:
        pods.append(True)
    if args.single_pod or not args.multi_pod:
        pods.append(False)
    pods = sorted(set(pods))                 # False (single) first

    if args.all:
        cells = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    failed = 0
    for mp in pods:
        for arch, shp in cells:
            res = run_and_save(arch, shp, multi_pod=mp, force=args.force)
            ok = res.get("status")
            failed += ok != "ok"
            dom = res.get("dominant", "-")
            print(f"[{'2x16x16' if mp else '16x16'}] {arch:20s} {shp:12s} "
                  f"{ok:5s} dominant={dom} "
                  f"trace={res.get('trace_seconds', '-')}s", flush=True)
            if ok != "ok":
                print("   ", res.get("error"), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

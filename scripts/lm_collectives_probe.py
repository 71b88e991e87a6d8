#!/usr/bin/env python3
"""The models' mesh branches at full width across the machine's cards.

One process a card (every visible card, at most `--ranks`), joined over
NCCL through a file rendezvous, on `make_local_mesh(model=--model)`, bf16
compute, seeded weights (each rank keeps only the bf16 shard of each
leaf that the partition specs give it):

  1. internvl2-1b (`prefill_32k`, the JAX package's ring-attention cell)
     with `attention_impl="ring"` and `sequence_parallel`, all 24 layers:
     a prefill of `--vlm-text` tokens after the 256 image positions at
     B = `--vlm-batch` (St = 32,768 by default: it splits over the ring
     and into the one-card reference's 1,024-query chunks).  Its
     last-position logits are held to the same prefill without a mesh on
     rank 0's card, within the bf16 rule (`chip_smoke.bf16_limit`);
  2. internlm2-20b (`decode_32k`, the JAX package's flash-decode cell)
     with `flash_decode`: a KV cache of `--cache` positions a row at
     B = `--lm-batch`, each rank drawing its own sequence shard from a
     seeded generator (no prefill), `pos` near its end.  First at
     `--check-layers` layers, where the whole cache fits one card: the
     decode logits held to the same step without a mesh on rank 0's card
     (the cache gathered), within the bf16 rule; then at all 48 layers,
     `--steps` decode steps timed.

It prints, and writes to `--out` (build/lm_collectives_probe.json), one
JSON object: the cards' name and power limit, each phase's times (CUDA
events on rank 0, the median after the first call), its bound (FLOPs
over the cards' dense bf16 peak for the prefill, bytes read a card over
3.35 TB/s for a decode step), tokens/s, each card's peak memory, the
largest difference from the one-card reference and its ratio to the rule.

    python3 scripts/lm_collectives_probe.py          # on four cards
    python3 scripts/lm_collectives_probe.py --device cpu --ranks 4 \\
        --smoke                                      # a CPU rehearsal

Any failed rank or check exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_DENSE_OPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
SEED = 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=0)
    ap.add_argument("--model", type=int, default=4)
    ap.add_argument("--vlm-batch", type=int, default=2)
    ap.add_argument("--vlm-text", type=int, default=32512)
    ap.add_argument("--vlm-timed", type=int, default=2,
                    help="prefills timed after the first")
    ap.add_argument("--lm-batch", type=int, default=8)
    ap.add_argument("--cache", type=int, default=32768)
    ap.add_argument("--check-layers", type=int, default=12)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--profile", action="store_true",
                    help="one more prefill and decode step under "
                         "torch.profiler on each rank")
    ap.add_argument("--timeout", type=float, default=1500.0)
    ap.add_argument("--dir", default=os.path.join(
        ROOT, "build", "lm_collectives_probe"))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "lm_collectives_probe.json"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: a rehearsal over gloo (with --smoke)")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' smoke configs in bf16 (a rehearsal; "
                         "pass small --vlm-text / --cache)")
    ap.add_argument("--rank", type=int, default=-1)
    ap.add_argument("--world", type=int, default=0)
    return ap.parse_args(argv)


# -- ranks --------------------------------------------------------------------
class Clock:
    """CUDA events around a call on the card (read after it), the host
    clock in a rehearsal on the CPU."""

    def __init__(self, device):
        import torch
        self.torch, self.on_card = torch, device.type == "cuda"

    def __call__(self, fn):
        torch = self.torch
        if not self.on_card:
            t0 = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t0) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)


def profiled(fn, device) -> dict:
    """`fn()` once under `torch.profiler` (CPU and, on the card, CUDA
    activity): the host wall ms, the aten ops dispatched and their summed
    self host ms (the rest of the wall is Python: DTensor's dispatch and
    the model's), the card's busy ms (the union of its kernels'
    intervals) and share of the wall, the NCCL kernels' summed ms, and
    the ops that took the most host time (self CPU ms, calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    if on_card:
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if on_card:
            torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
    busy, last = 0.0, float("-inf")
    for start, end, _ in kernels:
        busy += max(end - max(start, last), 0.0)
        last = max(last, end)
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    top = sorted(ops, key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"wall_ms": wall, "aten_calls": sum(e.count for e in ops),
            "aten_self_host_ms": sum(e.self_cpu_time_total
                                     for e in ops) / 1e3,
            "kernels": len(kernels),
            "device_busy_ms": busy / 1e3 if on_card else None,
            "device_busy_share": busy / 1e3 / wall if on_card else None,
            "nccl_kernel_ms": sum(end - start for start, end, name
                                  in kernels if "nccl" in name.lower())
            / 1e3 if on_card else None,
            "top_host_ops": [[e.key, e.self_cpu_time_total / 1e3, e.count]
                             for e in top[:8]]}


def config(name: str, smoke: bool, **variant):
    from repro_torch import configs
    return dataclasses.replace(configs.get(name, smoke=smoke),
                               compute_dtype="bfloat16", **variant)


def bf16_params(cfg, mesh, device, keep_whole: bool):
    """Seeded weights in bf16, drawn leaf by leaf on this rank's device
    (the f32 leaf dropped as soon as its shard is kept): (DTensor tree,
    whole bf16 tree or None)."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as ll
    from repro_torch.models import transformer as tf
    specs = dict(tf.tree_leaves(shd.param_specs(cfg, mesh)))
    whole = {}

    def place(path, leaf):
        leaf = leaf.to(torch.bfloat16)
        if keep_whole:
            whole[path] = leaf
        dt = shd.place(leaf, mesh, specs[path], src_data_rank=None)
        return ll.from_local(dt.to_local().clone(), dt.device_mesh,
                             dt.placements, leaf.shape)

    gen = torch.Generator(device=device).manual_seed(SEED)
    params = tf.init_params(cfg, gen, device=device, place=place)
    return params, (tf.unflatten(whole) if keep_whole else None)


def peak(device):
    import torch
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None


def reset_peak(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def rule(cfg, got, want) -> tuple[float, float]:
    """(largest |got - want|, its largest ratio to `bf16_limit` a row)."""
    from chip_smoke import bf16_limit, lm_path_layers
    want = want.float().reshape(-1, want.shape[-1])
    got = got.float().reshape(want.shape)
    limit = bf16_limit(lm_path_layers(cfg), want)
    err = (got - want).abs()
    return float(err.max()), float((err.double() / limit).max())


def prefill_phase(args, mesh, device, clock) -> dict:
    import numpy as np
    import torch
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.distributed import runtime
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import steps
    cfg = config("internvl2-1b", args.smoke, attention_impl="ring",
                 sequence_parallel=True)
    St = args.vlm_text + cfg.frontend_seq
    rec = {"arch": cfg.name, "layers": cfg.n_layers,
           "batch": args.vlm_batch, "text": args.vlm_text,
           "positions": St, "attention_impl": cfg.attention_impl,
           "sequence_parallel": cfg.sequence_parallel}
    reset_peak(device)
    params, whole = bf16_params(cfg, mesh, device, runtime.is_primary())
    rng = np.random.default_rng(SEED)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (
        args.vlm_batch, args.vlm_text)).astype(np.int32),
        "frontend_embeds": rng.standard_normal(
            (args.vlm_batch, cfg.frontend_seq, cfg.d_model),
            dtype=np.float32)}
    sb = shard_batch(batch, mesh, shd.P(shd.dp_axes(mesh)))
    step = steps.make_prefill_step(cfg, St, mesh=mesh)
    times = []
    with torch.no_grad():
        for _ in range(1 + args.vlm_timed):
            (logits, cache), ms = clock(lambda: step(params, sb))
            times.append(ms)
            del cache
        if args.profile:
            rec["profile"] = profiled(lambda: step(params, sb), device)
    rec["prefill_ms"] = times
    rec["prefill_ms_median"] = sorted(times[1:] or times)[
        len(times[1:] or times) // 2]
    rec["peak_bytes"] = peak(device)
    got = logits.full_tensor()
    rec["logits_finite"] = bool(torch.isfinite(got).all())
    # the FLOP bound: 2 N a position for the block weights, the head at
    # the last position, and the causal half of the score and value
    # products (4 B H St^2 hd / 2 a layer)
    from repro_torch.models import transformer as tf
    blocks = sum(math.prod(s) for k, s in tf.tree_leaves(
        tf.param_shapes(cfg)) if k.startswith("blocks/"))
    flops = 2 * blocks * args.vlm_batch * St \
        + 2 * cfg.d_model * cfg.vocab_size * args.vlm_batch \
        + 2 * args.vlm_batch * cfg.n_heads * St ** 2 \
        * cfg.resolved_head_dim * cfg.n_layers
    rec["flops"] = flops
    rec["bound_ms"] = flops / (mesh.size * BF16_DENSE_OPS_PER_S) * 1e3
    del params
    runtime.barrier()
    if runtime.is_primary():
        # the reference: the same prefill without a mesh on this card
        plain = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        reset_peak(device)
        with torch.no_grad():
            (want, _), ms = clock(lambda: steps.make_prefill_step(
                cfg, St)(whole, plain))
        rec["reference_ms"] = ms
        rec["reference_peak_bytes"] = peak(device)
        rec["max_abs_err"], rec["err_over_rule"] = rule(cfg, got, want)
        del whole, want
    runtime.barrier()
    return rec


def decode_cache(cfg, mesh, device, batch: int, positions: int,
                 pos: int):
    """A serving cache placed by `cache_specs`, each rank's sequence
    shard of k / v drawn from a generator seeded by its shard index (the
    whole cache is never built)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import runtime
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as ll
    from repro_torch.models import transformer as tf
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    abstract = tf.init_cache(cfg, batch, positions, abstract=True)
    specs = shd.fit_specs(shd.cache_specs(cfg, ShapeConfig(
        "decode", positions, batch, "decode"), mesh), abstract, mesh)
    dm = runtime.device_mesh(mesh)
    cache = {}
    for key, leaf in abstract.items():
        placements = shd.placements(specs[key], dm)
        shape, offset = compute_local_shape_and_global_offset(
            leaf.shape, dm, placements)
        if key == "pos":
            local = torch.full((), pos, dtype=torch.int32, device=device)
        else:
            gen = torch.Generator(device=device).manual_seed(
                SEED + 1000 * (1 + list(abstract).index(key))
                + offset[2] // max(shape[2], 1))
            local = torch.randn(shape, generator=gen, device=device,
                                dtype=torch.float32).to(leaf.dtype)
        cache[key] = ll.from_local(local, dm, placements, leaf.shape)
    return cache


def decode_bytes(cfg, params, cache) -> int:
    """Bytes a decode step reads on one card: this rank's shards of the
    weights and of the KV cache, each once."""
    from repro_torch.models import transformer as tf
    weights = sum(v.to_local().numel() * v.element_size()
                  for _, v in tf.tree_leaves(params))
    kv = sum(cache[k].to_local().numel() * cache[k].element_size()
             for k in ("k", "v"))
    return weights + kv


def decode_phase(args, mesh, device, clock) -> dict:
    import numpy as np
    import torch
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.distributed import runtime
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import steps
    from repro_torch.models import transformer as tf
    full = config("internlm2-20b", args.smoke, flash_decode=True)
    pos = args.cache - args.steps - 2
    rng = np.random.default_rng(SEED + 1)
    tokens = rng.integers(0, full.vocab_size, (
        1 + args.steps, args.lm_batch, 1)).astype(np.int32)

    def run(cfg, params, cache, n_steps: int):
        step = steps.make_decode_step(cfg, mesh=mesh)
        out, times = [], []
        with torch.no_grad():
            for t in tokens[:n_steps]:
                sb = shard_batch({"tokens": t}, mesh,
                                 shd.P(shd.dp_axes(mesh)))["tokens"]
                (logits, cache), ms = clock(lambda: step(params, cache, sb))
                out.append(logits.full_tensor())
                times.append(ms)
        return out, times

    # the check at a depth whose whole cache fits one card
    cut = dataclasses.replace(full, n_layers=min(args.check_layers,
                                                 full.n_layers))
    rec = {"arch": full.name, "batch": args.lm_batch,
           "cache_positions": args.cache, "pos": pos,
           "check_layers": cut.n_layers}
    reset_peak(device)
    params, _ = bf16_params(cut, mesh, device, False)
    cache = decode_cache(cut, mesh, device, args.lm_batch, args.cache, pos)
    whole = (dict(tf.tree_leaves(params)), cache)
    whole = [{k: v.full_tensor() for k, v in part.items()} for part in whole]
    got, _ = run(cut, params, cache, 1)
    del params, cache
    runtime.barrier()
    if runtime.is_primary():
        with torch.no_grad():
            want, _ = steps.make_decode_step(cut)(
                tf.unflatten(whole[0]), whole[1],
                torch.as_tensor(tokens[0], device=device))
        rec["check_max_abs_err"], rec["check_err_over_rule"] = rule(
            cut, got[0], want)
        del want
    del whole
    runtime.barrier()

    # the full depth, timed
    reset_peak(device)
    params, _ = bf16_params(full, mesh, device, False)
    cache = decode_cache(full, mesh, device, args.lm_batch, args.cache, pos)
    rec["bytes_per_card"] = decode_bytes(full, params, cache)
    logits, times = run(full, params, cache, 1 + args.steps)
    if args.profile:
        sb = shard_batch({"tokens": tokens[-1]}, mesh,
                         shd.P(shd.dp_axes(mesh)))["tokens"]
        step = steps.make_decode_step(full, mesh=mesh)
        with torch.no_grad():
            rec["profile"] = profiled(lambda: step(params, cache, sb), device)
    rec["layers"] = full.n_layers
    rec["step_ms"] = times
    rec["step_ms_median"] = sorted(times[1:])[len(times[1:]) // 2]
    rec["tokens_per_s"] = args.lm_batch / (rec["step_ms_median"] / 1e3)
    rec["bound_ms"] = rec["bytes_per_card"] / HBM_BYTES_PER_S * 1e3
    rec["peak_bytes"] = peak(device)
    rec["logits_finite"] = all(bool(torch.isfinite(x).all())
                               for x in logits)
    rec["greedy"] = [x[:, -1].argmax(-1).tolist() for x in logits]
    return rec


def rank_main(args) -> None:
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    from repro_torch.distributed import runtime
    from repro_torch.launch.mesh import make_local_mesh
    runtime.initialize(f"file://{args.dir}/rendezvous", args.world,
                       args.rank, device=args.device, timeout_s=600)
    device = runtime.local_device(args.device)
    mesh = make_local_mesh(model=args.model, device=args.device)
    clock = Clock(device)
    rec = {"rank": args.rank, "world": args.world,
           "mesh": list(mesh.devices.shape),
           "backend": torch.distributed.get_backend()}
    t0 = time.perf_counter()
    rec["prefill"] = prefill_phase(args, mesh, device, clock)
    rec["prefill"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["decode"] = decode_phase(args, mesh, device, clock)
    rec["decode"]["seconds"] = time.perf_counter() - t0
    runtime.shutdown()
    print(json.dumps(rec), flush=True)


# -- the parent ---------------------------------------------------------------
def main(argv=None) -> int:
    args = parse_args(argv)
    if args.rank >= 0:
        rank_main(args)
        return 0
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("lm_collectives_probe: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines() \
        if args.device == "cuda" else ["cpu"]
    shutil.rmtree(args.dir, ignore_errors=True)
    os.makedirs(args.dir)
    world = args.ranks or torch.cuda.device_count()
    out = {"cards": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "world": world}
    print(json.dumps(out), flush=True)
    cmd = [sys.executable, os.path.abspath(__file__), "--world", str(world),
           "--model", str(args.model), "--vlm-batch", str(args.vlm_batch),
           "--vlm-text", str(args.vlm_text), "--vlm-timed",
           str(args.vlm_timed), "--lm-batch", str(args.lm_batch),
           "--cache", str(args.cache), "--check-layers",
           str(args.check_layers), "--steps", str(args.steps),
           "--device", args.device, "--dir", args.dir, "--out", args.out] \
        + (["--smoke"] if args.smoke else []) \
        + (["--profile"] if args.profile else [])
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        cmd + ["--rank", str(r)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "LOCAL_RANK": str(r),
             "PYTHONPATH": os.path.join(ROOT, "src")})
        for r in range(world)]
    ranks, failed = [], []
    for r, proc in enumerate(procs):
        try:
            stdout, stderr = proc.communicate(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            failed.append(f"rank {r} timed out")
            continue
        if proc.returncode != 0:
            failed.append(f"rank {r} exited {proc.returncode}: " + " | ".join(
                (stdout + stderr).strip().splitlines()[-8:]))
            continue
        ranks.append(json.loads(stdout.strip().splitlines()[-1]))
    out["seconds"] = time.perf_counter() - t0
    out["ranks"] = ranks
    shutil.rmtree(args.dir, ignore_errors=True)
    if len(ranks) == world:
        first = ranks[0]
        for phase, key in (("prefill", "err_over_rule"),
                           ("decode", "check_err_over_rule")):
            if not first[phase][key] <= 1.0:
                failed.append(f"{phase}: {first[phase][key]} times the "
                              f"bf16 rule from the one-card reference")
            if not first[phase]["logits_finite"]:
                failed.append(f"{phase}: non-finite logits")
        for rec in ranks[1:]:
            if rec["decode"]["greedy"] != first["decode"]["greedy"]:
                failed.append(f"rank {rec['rank']} decoded other tokens")
    out["failed"] = failed
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

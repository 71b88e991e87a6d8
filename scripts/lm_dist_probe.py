#!/usr/bin/env python3
"""The sharded LM `Trainer` at full width across the machine's cards.

One process a card (at most `--ranks`, default every visible card), joined
over NCCL through a file rendezvous.  glm4-9b (9.40 B parameters, f32
weights and AdamW state, bf16 compute, remat) trains on
`make_local_mesh(model=--model)` from `TokenSource` at B = `--batch`,
S = `--seq`, seeded weights:

  1. `--steps // 2` steps, the checkpoint the `Trainer` writes there
     (every rank gathers a leaf at a time, rank 0 writes it), then on to
     `--steps`: the uninterrupted run;
  2. a new `Trainer` with FSDP on, on the `--restore-shape` mesh,
     restores the mid-run checkpoint (an elastic restore onto other
     specs) and runs to `--steps`: its losses are held to the
     uninterrupted run's (`--loss-rule`, relative).

It prints, and writes to `--out` (build/lm_dist_probe.json), one JSON
object (rank 0 also appends each phase's record to the file of the same
name ending `_progress.jsonl` as it ends):
the card's name and power limit, `df` and `free` where the checkpoints
go, the checkpoint's bytes, the layers trained (cut from 40 only where
`--ckpt-budget`, by default the free space there, cannot hold two
checkpoints at once: the `Trainer` always ends a run with a save, and the
older one is pruned after the newer is written), each step's loss and CUDA-event time on rank 0, tokens/s, each
card's peak memory, the save and restore seconds, and the step's FLOP
bound (`chip_smoke.lm_train_flops` over the cards at the card's dense
bf16 peak).

    python3 scripts/lm_dist_probe.py              # on four cards

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
STATE_BYTES = 12                # a checkpoint: f32 params and two moments


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--ranks", type=int, default=0)
    ap.add_argument("--model", type=int, default=4)
    ap.add_argument("--restore-shape", default="2,2")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--layers", type=int, default=0,
                    help="train this many layers (0: as many as the disk "
                         "allows, at most the config's)")
    ap.add_argument("--loss-rule", type=float, default=1e-2)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        ROOT, "build", "lm_dist_probe"))
    ap.add_argument("--ckpt-budget", type=float, default=0.0,
                    help="bytes the checkpoints may take (default: the "
                         "free space where they go); a tmpfs such as "
                         "/dev/shm is bounded by host memory instead, and "
                         "a machine may cap what a run writes to disk")
    ap.add_argument("--timeout", type=float, default=3000.0)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "lm_dist_probe.json"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: a rehearsal over gloo (with --smoke)")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (a rehearsal)")
    ap.add_argument("--rank", type=int, default=-1)
    ap.add_argument("--world", type=int, default=0)
    return ap.parse_args(argv)


def disk(path: str) -> dict:
    usage = shutil.disk_usage(path)
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":")
            mem[key] = int(value.split()[0]) * 1024
    return {"path": path, "disk_total": usage.total, "disk_free": usage.free,
            "host_mem_total": mem["MemTotal"],
            "host_mem_available": mem["MemAvailable"]}


def layers_that_fit(cfg, free_bytes: int) -> tuple[int, int]:
    """(layers, checkpoint bytes): the most layers whose two checkpoints
    fit in `free_bytes` with a tenth to spare."""
    from repro_torch.models import transformer as tf
    for layers in range(cfg.n_layers, 0, -1):
        c = dataclasses.replace(cfg, n_layers=layers)
        n = sum(math.prod(s) for _, s in tf.tree_leaves(tf.param_shapes(c)))
        if 2 * STATE_BYTES * n <= 0.9 * free_bytes:
            return layers, STATE_BYTES * n
    raise RuntimeError(f"not even one layer's checkpoints fit in "
                       f"{free_bytes} bytes")


# -- ranks --------------------------------------------------------------------
def train_rank(args) -> dict:
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import TokenSource
    from repro_torch.distributed import runtime
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.training.trainer import Trainer, TrainerConfig
    from chip_smoke import lm_train_flops

    runtime.initialize(f"file://{args.ckpt_dir}/rendezvous", args.world,
                       args.rank, device=args.device, timeout_s=300)
    device = runtime.local_device(args.device)
    on_card = device.type == "cuda"
    cfg = configs.get(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    half = args.steps // 2
    ckpt = os.path.join(args.ckpt_dir, "ckpt")
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=half,
                         keep_ckpts=2)
    ts = TokenSource(cfg.vocab_size, args.seq, args.batch)

    def batches():
        step = 0
        while True:
            yield ts.next_batch(step)
            step += 1

    def timed(tr, record: list):
        """Wrap the trainer's step with CUDA events (read after it; the
        host clock in a rehearsal on the CPU)."""
        step = tr._step

        def run(*a):
            if not on_card:
                t0 = time.perf_counter()
                out = step(*a)
                ms = (time.perf_counter() - t0) * 1e3
                record.append(lambda: ms)
                return out
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(*a)
            end.record()
            record.append(lambda: start.elapsed_time(end))
            return out
        tr._step = run

    def timed_saves(tr, record: list):
        save = tr.ckpt.save

        def run(step, tree, **kw):
            t0 = time.perf_counter()
            save(step, tree, **kw)
            record.append({"step": step, "s": time.perf_counter() - t0})
        tr.ckpt.save = run

    rec = {"arch": cfg.name, "layers": cfg.n_layers, "batch": args.batch,
           "seq": args.seq, "steps": args.steps, "remat": cfg.remat,
           "world": args.world, "backend": torch.distributed.get_backend()}
    mesh = make_local_mesh(model=args.model, device=args.device)
    rec["mesh"] = list(mesh.devices.shape)
    cuda = torch.cuda if on_card else None
    if cuda:
        cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    tr = Trainer(cfg, mesh, ckpt, tcfg)
    tr.initialize()
    if cuda:
        cuda.synchronize(device)
    rec["init_s"] = time.perf_counter() - t0
    rec["state_bytes_per_card"] = (cuda.memory_allocated(device) if cuda
                                   else None)
    progress(args, {k: rec[k] for k in ("arch", "layers", "mesh", "init_s",
                                  "state_bytes_per_card")})
    events, saves = [], []
    timed(tr, events)
    timed_saves(tr, saves)
    hist = tr.train(batches(), num_steps=half)
    hist += tr.train(batches(), num_steps=args.steps)
    rec["losses"] = {h["step"]: h["loss"] for h in hist}
    rec["grad_norms"] = {h["step"]: h["grad_norm"] for h in hist}
    rec["step_ms"] = [read() for read in events]
    progress(args, rec)
    rec["step_wall_s"] = tr.step_times
    rec["stragglers"] = tr.straggler_steps
    rec["saves"] = saves
    rec["peak_bytes"] = cuda.max_memory_allocated(device) if cuda else None
    flops, parts = lm_train_flops(cfg, args.seq)
    rec["flops"] = flops * args.batch / 2     # lm_train_flops is at B = 2
    rec["flop_bound_ms"] = rec["flops"] / (args.world * BF16_DENSE_OPS_PER_S
                                           ) * 1e3
    steady = sorted(rec["step_ms"][2:]) or rec["step_ms"]
    rec["step_ms_median"] = steady[len(steady) // 2]
    rec["tokens_per_s"] = args.batch * args.seq / (
        rec["step_ms_median"] / 1e3)
    del tr, hist
    if cuda:
        cuda.empty_cache()

    # the elastic restore: FSDP on, another mesh, from the mid-run save
    if runtime.is_primary():
        shutil.rmtree(os.path.join(ckpt, f"step_{args.steps:09d}"))
    runtime.barrier()
    shape = tuple(int(s) for s in args.restore_shape.split(","))
    fsdp = dataclasses.replace(cfg, fsdp=True)
    if cuda:
        cuda.reset_peak_memory_stats(device)
    tr = Trainer(fsdp, make_local_mesh(model=shape[1], device=args.device),
                 ckpt, tcfg)
    t0 = time.perf_counter()
    ok = tr.restore()
    if cuda:
        cuda.synchronize(device)
    rec["restore_s"] = time.perf_counter() - t0
    if not ok or tr.step != half:
        raise RuntimeError(f"the elastic restore found step {tr.step}")
    progress(args, {"restore_s": rec["restore_s"]})
    saves = []
    timed_saves(tr, saves)
    resumed = {h["step"]: h["loss"] for h in tr.train(batches())}
    rec["restored_onto"] = list(shape)
    rec["resumed_losses"] = resumed
    rec["resumed_saves"] = saves
    rec["resumed_peak_bytes"] = (cuda.max_memory_allocated(device) if cuda
                                 else None)
    rec["resumed_loss_max_rel_err"] = max(
        abs(resumed[s] - rec["losses"][s]) / abs(rec["losses"][s])
        for s in resumed)
    runtime.shutdown()
    return rec


def progress(args, rec: dict) -> None:
    """Rank 0 appends `rec` to `--out`'s `_progress.jsonl` file: what a
    run that is cut short still leaves."""
    from repro_torch.distributed import runtime
    if runtime.is_primary():
        path = os.path.splitext(args.out)[0] + "_progress.jsonl"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")


def rank_main(args) -> None:
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    print(json.dumps(train_rank(args)), flush=True)


# -- the parent ---------------------------------------------------------------
def main(argv=None) -> int:
    args = parse_args(argv)
    if args.rank >= 0:
        rank_main(args)
        return 0
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("lm_dist_probe: no CUDA device")
    from repro_torch import configs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines() \
        if args.device == "cuda" else ["cpu"]
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    os.makedirs(args.ckpt_dir)
    out = {"cards": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, **disk(args.ckpt_dir)}
    world = args.ranks or torch.cuda.device_count()
    flags = ["--device", args.device] + (["--smoke"] if args.smoke else [])
    cfg = configs.get(args.arch, smoke=args.smoke)
    out["ckpt_budget"] = args.ckpt_budget or out["disk_free"]
    layers, _ = layers_that_fit(cfg, out["ckpt_budget"])
    out["checkpoint_bytes_full_width"] = layers_that_fit(cfg, 10 ** 18)[1]
    layers = min(layers, args.layers or layers)
    out["layers"] = layers
    out["layers_cut"] = layers < cfg.n_layers
    out["checkpoint_bytes"] = layers_that_fit(
        dataclasses.replace(cfg, n_layers=layers), 10 ** 18)[1]
    cmd = [sys.executable, os.path.abspath(__file__), "--world", str(world),
           "--arch", args.arch, "--model", str(args.model),
           "--restore-shape", args.restore_shape, "--batch",
           str(args.batch), "--seq", str(args.seq), "--steps",
           str(args.steps), "--layers", str(layers), *flags,
           "--ckpt-dir", args.ckpt_dir, "--out", args.out]
    print(json.dumps(out), flush=True)
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
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    if ranks:
        first = ranks[0]
        losses = list(first["losses"].values())
        if not all(math.isfinite(v) for v in losses):
            failed.append(f"non-finite losses {losses}")
        if first["resumed_loss_max_rel_err"] > args.loss_rule:
            failed.append("the elastic restore's losses differ by "
                          f"{first['resumed_loss_max_rel_err']}")
        for rec in ranks[1:]:
            if rec["losses"] != first["losses"]:
                failed.append(f"rank {rec['rank'] if 'rank' in rec else '?'}"
                              " saw other losses than rank 0")
    out["failed"] = failed
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

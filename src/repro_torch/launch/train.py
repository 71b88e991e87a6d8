"""LM training launcher: the port's counterpart of
`src/repro/launch/train.py`, on the card unless ``--device cpu``.

    python -m repro_torch.launch.train --arch glm4-9b --steps 50

It trains the smoke config of `--arch` (``--smoke`` is on by default, as
in the JAX launcher) on the synthetic `TokenSource` stream, vlm / audio
configs with zero frontend embeddings, through the fault-tolerant
`Trainer`: a run resumes from the latest checkpoint in ``--ckpt-dir``.

One process a shard: ``--coordinator HOST:PORT --num-processes N
--process-id I`` (JAX's flags; any `init_method` URL also works, such as
``file:///shared/path``) joins N processes, and so does starting under
torchrun, which sets the environment instead:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --model 2

Each process takes one card (gloo and one process a shard with
``--device cpu``) and the trainer runs on an (N // model, model)
("data", "model") mesh, or the production mesh on 256 or more ranks.
Without either, it runs on `make_local_mesh()` of one shard.  Only rank
0 prints the `[train]` line.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--process-id", type=int, default=-1)
    ap.add_argument("--num-processes", type=int, default=0)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--model", type=int, default=1,
                    help="the mesh's model axis in a multi-process run")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (the card by default)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from repro_torch.distributed import runtime

    joined = runtime.is_distributed()
    if args.coordinator and args.num_processes > 0:
        runtime.initialize(args.coordinator, args.num_processes,
                           args.process_id, device=args.device)
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        runtime.initialize(device=args.device)
    try:
        return _train(args)
    finally:
        if not joined:
            runtime.shutdown()


def _train(args) -> int:
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import Prefetcher, TokenSource
    from repro_torch.distributed import runtime
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = configs.get(args.arch, smoke=args.smoke)
    if runtime.is_distributed():
        local = make_local_mesh(model=args.model, device=args.device)
        mesh = (make_production_mesh(multi_pod=args.multi_pod,
                                     devices=local.device_list)
                if runtime.world_size() >= 256 else local)
    else:
        n_local = torch.cuda.device_count() if args.device == "cuda" else 1
        mesh = (make_production_mesh(multi_pod=args.multi_pod)
                if n_local >= 256 else make_local_mesh(device=args.device))

    ts = TokenSource(cfg.vocab_size, args.seq_len, args.batch)

    def stream():
        step = 0
        while True:
            b = ts.next_batch(step)
            if cfg.frontend:
                b["frontend_embeds"] = np.zeros(
                    (args.batch, cfg.frontend_seq, cfg.d_model), np.float32)
            yield b
            step += 1

    tr = Trainer(cfg, mesh, args.ckpt_dir,
                 TrainerConfig(total_steps=args.steps, ckpt_every=25))
    tr.init_or_restore()
    batches = Prefetcher(stream(), depth=2)
    try:
        hist = tr.train(batches)
    finally:
        batches.close()
    if hist and runtime.is_primary():
        print(f"[train] {cfg.name}: step {tr.step}, "
              f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, "
              f"stragglers {len(tr.straggler_steps)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

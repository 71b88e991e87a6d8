"""LM training launcher: the port's counterpart of
`src/repro/launch/train.py`, on the card unless ``--device cpu``.

    python -m repro_torch.launch.train --arch glm4-9b --steps 50

It trains the smoke config of `--arch` (``--smoke`` is on by default, as
in the JAX launcher) on the synthetic `TokenSource` stream, vlm / audio
configs with zero frontend embeddings, through the fault-tolerant
`Trainer`: a run resumes from the latest checkpoint in ``--ckpt-dir``.
The mesh is the production mesh on 256 or more devices, else
`make_local_mesh()`; the trainer runs on a mesh of one shard, and a
multi-host run (``--coordinator`` with ``--num-processes``) needs the
distributed LM slice (ROADMAP A11c).
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
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (the card by default)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.coordinator and args.num_processes > 0:
        print("a multi-process run needs the distributed LM slice "
              "(ROADMAP A11c)", file=sys.stderr)
        return 2

    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import Prefetcher, TokenSource
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = configs.get(args.arch, smoke=args.smoke)
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
    if hist:
        print(f"[train] {cfg.name}: step {tr.step}, "
              f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, "
              f"stragglers {len(tr.straggler_steps)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

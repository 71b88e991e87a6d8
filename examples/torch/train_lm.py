"""Train a reduced LM backbone (any of the 10 assigned archs) for a few
hundred steps with the PyTorch port's fault-tolerant trainer.

The port's counterpart of `examples/train_lm.py`, on the card unless
``--device cpu``.

Run:  PYTHONPATH=src python examples/torch/train_lm.py [--arch glm4-9b]
      [--steps 200] [--device cpu]

A run resumes from the latest checkpoint in ``--ckpt-dir``.
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch import configs
from repro_torch.data.pipeline import Prefetcher, TokenSource
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.training.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch, smoke=True)
    mesh = make_local_mesh(device=args.device)
    ts = TokenSource(cfg.vocab_size, seq_len=64, batch_size=8)

    def stream():
        step = 0
        while True:
            b = ts.next_batch(step)
            if cfg.frontend:
                b["frontend_embeds"] = np.zeros(
                    (8, cfg.frontend_seq, cfg.d_model), np.float32)
            yield b
            step += 1

    tr = Trainer(cfg, mesh, args.ckpt_dir,
                 TrainerConfig(total_steps=args.steps, ckpt_every=50,
                               peak_lr=3e-3))
    tr.init_or_restore()
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M(smoke) "
          f"start step={tr.step}")
    batches = Prefetcher(stream(), depth=2)
    try:
        hist = tr.train(batches)
    finally:
        batches.close()
    first, last = hist[0], hist[-1]
    print(f"loss {first['loss']:.3f} -> {last['loss']:.3f} over "
          f"{len(hist)} steps; stragglers={len(tr.straggler_steps)}")
    return {"arch": cfg.name, "steps": len(hist), "first_loss":
            first["loss"], "last_loss": last["loss"],
            "stragglers": len(tr.straggler_steps)}


if __name__ == "__main__":
    main()

"""Fault-tolerant LM training loop: the port's counterpart of
`src/repro/training/trainer.py`.

  * the train step (`models.steps.make_train_step`) runs on the mesh's
    one device, updating params and optimizer state in place (JAX donates
    both); the partition specs are computed as JAX's trainer computes
    them, and a mesh of several shards raises until the distributed LM
    slice (ROADMAP A11c) places tensors by them;
  * checkpoint/restart: periodic atomic saves in the JAX package's format
    (`{"params", "opt_state", "meta": {"step"}}`, so either package
    resumes the other's run), a blocking save of the last step when a run
    ends (where the periodic save already holds that step, the run waits
    for it instead of writing it again), auto-resume from the latest, the
    data position replayed on resume, injected failures (`fail_at`);
  * straggler mitigation: a per-step wall-time EMA; steps slower than
    `straggler_factor` x EMA are counted (the first step, which holds the
    first calls' set-up, stays out of the EMA, and no step is flagged
    before the fourth).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import steps as steps_lib
from repro_torch.models import transformer as tf
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.checkpoint import CheckpointManager


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    peak_lr: float = 3e-4
    straggler_factor: float = 3.0
    keep_ckpts: int = 3


def _mesh_device(mesh) -> torch.device:
    if mesh.size != 1:
        raise NotImplementedError(
            f"the port's LM trainer runs on one device; a mesh of "
            f"{mesh.size} shards needs the distributed LM slice "
            "(ROADMAP A11c)")
    device = mesh.device_list[0]
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the trainer runs on the card "
                           "unless its mesh is made with device='cpu'")
    return device


class Trainer:
    def __init__(self, cfg: ModelConfig, mesh, ckpt_dir: str,
                 tcfg: TrainerConfig = TrainerConfig(), *,
                 max_positions: int = 0, seed: int = 0):
        self.cfg = cfg
        self.mesh = mesh
        self.device = _mesh_device(mesh)
        self.tcfg = tcfg
        self.optimizer = opt_lib.make(cfg, tcfg.total_steps, tcfg.peak_lr)
        self.ckpt = CheckpointManager(ckpt_dir, keep_last=tcfg.keep_ckpts)
        self.max_positions = max_positions

        self.p_specs = shd.param_specs(cfg, mesh,
                                       max_positions=max_positions)
        self.o_specs = shd.opt_state_specs(self.p_specs,
                                           self.optimizer.kind)
        self._step = steps_lib.make_train_step(cfg, self.optimizer)
        self._seed = seed
        self.step = 0
        self.params = None
        self.opt_state = None
        self._saved_step: Optional[int] = None
        # telemetry
        self.step_times: list[float] = []
        self.straggler_steps: list[int] = []
        self._ema: Optional[float] = None

    # -- state -------------------------------------------------------------
    def initialize(self):
        generator = torch.Generator(device=self.device).manual_seed(
            self._seed)
        self.params = tf.init_params(self.cfg, generator,
                                     max_positions=self.max_positions,
                                     device=self.device)
        self.opt_state = self.optimizer.init(self.params)
        self.step = 0

    def restore(self) -> bool:
        """Auto-resume from the latest checkpoint. True if restored."""
        latest = self.ckpt.latest()
        if latest is None:
            return False
        state = self.ckpt.restore(latest)
        self.params = convert.lm_params_from_numpy(state["params"],
                                                   self.device)
        self.opt_state = convert.lm_opt_state_from_numpy(
            state["opt_state"], self.device)
        self.step = int(state["meta"]["step"][()])
        self._saved_step = self.step
        return True

    def init_or_restore(self):
        if not self.restore():
            self.initialize()

    def save(self, blocking: bool = False):
        self.ckpt.save(self.step, {
            "params": self.params,
            "opt_state": self.opt_state,
            "meta": {"step": np.asarray(self.step)},
        }, blocking=blocking)
        self._saved_step = self.step

    def _batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    # -- loop --------------------------------------------------------------
    def train(self, batches: Iterator[dict], *, num_steps: int | None = None,
              fail_at: Optional[int] = None) -> list[dict]:
        """Run steps; `fail_at` injects a simulated crash (tests).  Each
        step's metrics are read back to the host (one wait a step), as
        JAX's trainer reads them."""
        if self.params is None:
            raise RuntimeError("call init_or_restore() first")
        num_steps = num_steps or self.tcfg.total_steps
        history = []
        it = iter(batches)
        # replay data position on resume (deterministic sources index by
        # step; stream sources skip consumed batches)
        for _ in range(self.step):
            next(it, None)

        while self.step < num_steps:
            batch = next(it, None)
            if batch is None:
                break
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self._step(
                self.params, self.opt_state, self._batch(batch))
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            # the first step includes first-call set-up: exclude it from
            # the straggler EMA or it poisons the baseline
            if len(self.step_times) >= 2:
                if self._ema is None:
                    self._ema = dt
                if dt > self.tcfg.straggler_factor * self._ema \
                        and len(self.step_times) > 3:
                    self.straggler_steps.append(self.step)
                self._ema = 0.9 * self._ema + 0.1 * dt

            self.step += 1
            metrics["step"] = self.step
            history.append(metrics)
            if self.step % self.tcfg.ckpt_every == 0:
                self.save()
            if fail_at is not None and self.step >= fail_at:
                self.ckpt.wait()
                raise RuntimeError(f"injected failure at step {self.step}")
        if self._saved_step == self.step:
            self.ckpt.wait()
        else:
            self.save(blocking=True)
        return history

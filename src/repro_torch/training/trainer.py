"""Fault-tolerant LM training loop: the port's counterpart of
`src/repro/training/trainer.py`.

  * the train step (`models.steps.make_train_step`) updates params and
    optimizer state in place (JAX donates both).  On a mesh of one shard
    with no process group it runs on that device, on plain tensors.  In a
    process group (`distributed.runtime`, one process a shard, the mesh
    one entry a rank) every leaf is a DTensor placed by the partition
    specs JAX's trainer computes, the batch is sharded over the data
    axes, and the same step runs shard by shard with DTensor's
    collectives: the port's counterpart of JAX's jit with in/out
    shardings under GSPMD.  A mesh of several shards without a process
    group raises;
  * checkpoint/restart: periodic atomic saves in the JAX package's format
    (`{"params", "opt_state", "meta": {"step"}}`, so either package
    resumes the other's run), a blocking save of the last step when a run
    ends (where the periodic save already holds that step, the run waits
    for it instead of writing it again), auto-resume from the latest, the
    data position replayed on resume, injected failures (`fail_at`);
  * straggler mitigation: a per-step wall-time EMA; steps slower than
    `straggler_factor` x EMA are counted (the first step, which holds the
    first calls' set-up, stays out of the EMA, and no step is flagged
    before the fourth).  In a process group each step's time is the
    slowest rank's, so every rank flags the same steps;
  * elastic scaling: checkpoints hold whole logical arrays, and a sharded
    trainer restores one onto whatever mesh it was built with.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import shard_batch
from repro_torch.distributed import runtime
from repro_torch.distributed import sharding as shd
from repro_torch.models import steps as steps_lib
from repro_torch.models import transformer as tf
from repro_torch.obs.trace import get_tracer
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.checkpoint import CheckpointManager

_TRACER = get_tracer()


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20        # 0: no checkpoint, not even at the end
    log_every: int = 10
    peak_lr: float = 3e-4
    straggler_factor: float = 3.0
    keep_ckpts: int = 3


def _mesh_device(mesh) -> torch.device:
    """This process's device on `mesh`: its rank's entry in a process
    group, else the one entry of a one-shard mesh."""
    if runtime.is_distributed():
        if mesh.size != runtime.world_size():
            raise ValueError(f"a mesh of {mesh.size} shards in a group of "
                             f"{runtime.world_size()} ranks: one a rank")
        device = mesh.device_list[runtime.rank()]
    elif mesh.size != 1:
        raise RuntimeError(
            f"a mesh of {mesh.size} shards trains one process a shard: "
            "join a process group first (distributed.runtime.initialize, "
            "or torchrun)")
    else:
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
        self.sharded = runtime.is_distributed()
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
        """Parameters drawn leaf by leaf from one generator seeded with
        `seed`, on this rank's device; sharded, each rank draws every leaf
        as a one-device trainer would and keeps its own slice (same bits
        as a one-device init on the same kind of device), so no rank holds
        more than one whole leaf."""
        generator = torch.Generator(device=self.device).manual_seed(
            self._seed)
        place = None
        if self.sharded:
            specs = dict(tf.tree_leaves(self.p_specs))

            def place(path, leaf):
                return shd.place(leaf, self.mesh, specs[path],
                                 src_data_rank=None)
        self.params = tf.init_params(self.cfg, generator,
                                     max_positions=self.max_positions,
                                     device=self.device, place=place)
        self.opt_state = self.optimizer.init(self.params)
        if self.sharded:
            self.opt_state = shd.shard_tree(self.opt_state, self.mesh,
                                            self.o_specs)
        self.step = 0

    def restore(self) -> bool:
        """Auto-resume from the latest checkpoint. True if restored.
        Sharded, the checkpoint is placed onto this trainer's mesh,
        whatever mesh wrote it."""
        latest = self.ckpt.latest()
        if latest is None:
            return False
        if self.sharded:
            state = self.ckpt.restore_sharded(
                self.mesh, {"params": self.p_specs,
                            "opt_state": self.o_specs}, latest)
            self.params, self.opt_state = state["params"], state[
                "opt_state"]
        else:
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
        if self.sharded:
            rows = len(next(iter(batch.values())))
            dp = shd.dp_axes(self.mesh)
            spec = shd.P(dp) if dp and rows % shd.mesh_size(
                self.mesh, dp) == 0 else shd.P()
            return shard_batch(batch, self.mesh, spec)
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def _step_time(self, dt: float) -> float:
        """This step's wall time: in a process group, the slowest rank's."""
        if not self.sharded:
            return dt
        t = torch.tensor([dt], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t[0])

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
            with _TRACER.span("train/step", "train", device=self.device,
                              step=self.step):
                self.params, self.opt_state, metrics = self._step(
                    self.params, self.opt_state, self._batch(batch))
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = self._step_time(time.perf_counter() - t0)
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
            if self.tcfg.ckpt_every and self.step % self.tcfg.ckpt_every == 0:
                self.save()
            if fail_at is not None and self.step >= fail_at:
                self.ckpt.wait()
                raise RuntimeError(f"injected failure at step {self.step}")
        if self._saved_step == self.step or not self.tcfg.ckpt_every:
            self.ckpt.wait()
        else:
            self.save(blocking=True)
        return history

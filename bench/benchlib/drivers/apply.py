"""Apply a model to a dataset: `predict_proba` on a test split, call after
call, by one caller (a closed loop).

Traffic parameters:
  rows_key      the configuration's key of the row count scored a call
  shard         "none": one `Predictor` on one card; "rows": the plan's
                `sharded` entry over a local mesh of every card of the run,
                rows split evenly (`Predictor.sharded`, `make_local_mesh`;
                staged: no cell of `BENCHMARK.json` runs it yet)
  kept_calls    how many calls besides the first and the last keep their
                outputs to be judged (drawn from the seed)
  limits        {check name: limit}

Each call hands the program the test split as an ordinary numpy float32
array in host memory (pageable, as numpy allocates it) and takes its
probabilities back to host memory, as a user of CatBoost's `predict_proba`
does: the host copies, and how the program stages them, are part of the
call.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchlib import data
from benchlib.drivers import common

import reference


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, devices,
                 seconds: float):
        self.cfg, self.mix, self.seed = config, traffic, seed
        self.devices, self.seconds = devices, seconds
        self.n_rows = int(config[traffic["rows_key"]])
        self.kept: dict[int, np.ndarray] = {}

    def setup(self) -> None:
        from repro_torch.core.predictor import Predictor, proba_from_raw
        from repro_torch.core.trees import ObliviousEnsemble

        dev = self.devices[0]
        parts = self.setup_parts = {}
        with common.phase(parts, "inputs"):
            g = data.generator(self.seed, dev)
            self.arrays = data.ensemble_arrays(self.cfg, g, dev)
            x = data.rows(self.n_rows, self.cfg["features"],
                          self.cfg["nan_share"], g, dev)
            self.x_host = np.array(x.cpu().numpy())
            del x
        with common.phase(parts, "plan"):
            plan = Predictor.build(ObliviousEnsemble(**self.arrays),
                                   device=dev)
        self.layout = plan.config.layout
        if self.mix["shard"] == "rows":
            from repro_torch.launch.mesh import make_local_mesh
            mesh = make_local_mesh(len(self.devices),
                                   device=common.mesh_device(self.devices))
            sharded = plan.sharded(mesh, shard_axis="rows")
            n_out = plan.ensemble.n_outputs
            self.call = lambda x: proba_from_raw(sharded(x), n_out)
        else:
            self.call = plan.proba
        self.plan = plan
        with common.phase(parts, "warm"):
            self.call(self.x_host).cpu()             # the one shape
        self.warm_call_s = parts["warm"]

    def window(self) -> dict:
        seconds = self.seconds
        est = max(2, int(seconds / max(self.warm_call_s, 1e-3)))
        rng = np.random.default_rng(self.seed)
        keep = {0, *rng.integers(1, est, self.mix["kept_calls"]).tolist()}
        calls = 0
        t0 = time.perf_counter()
        while True:
            with common.host_span("apply/call"):
                out = self.call(self.x_host).cpu().numpy()
            if calls in keep:
                self.kept[calls] = out
            calls += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        self.kept[calls - 1] = out
        cfg = self.cfg
        return {
            "window_s": elapsed, "attempted": calls, "failed": 0,
            "e2e": {"apply_rows_per_s": calls * self.n_rows / elapsed},
            "facts": {"calls": calls, "rows_per_call": self.n_rows,
                      "call_s": elapsed / calls, "layout": self.layout,
                      "model": common.model_shape(cfg)},
        }

    def release(self) -> None:
        del self.call, self.plan

    def _reference_raw(self, dtype, leaf_dtype=None) -> torch.Tensor:
        a = self.arrays
        x = torch.from_numpy(self.x_host).to(a["borders"].device)
        bins = reference.binarize(x, a["borders"])
        return reference.raw_scores(bins, a["split_features"],
                                    a["split_bins"], a["leaf_values"],
                                    a["base_score"], dtype=dtype,
                                    leaf_dtype=leaf_dtype,
                                    row_block=(self.n_rows
                                               if dtype != torch.float64
                                               else 8192))

    def use_control(self, dtype, leaf_dtype) -> None:
        raw = self._reference_raw(dtype, leaf_dtype)
        p = reference.proba(raw).float().cpu().numpy()
        self.kept = {k: p for k in self.kept}

    def check(self) -> dict:
        want = reference.proba(self._reference_raw(torch.float64))
        want = want.cpu().numpy()
        worst = max(common.max_abs_err(got, want)
                    for got in self.kept.values())
        return {"proba_max_err": (worst, self.mix["limits"]["proba_max_err"])}

"""Training: one boosting fit through `GBDTTrainer.fit_pool`, its
iterations filling the window.

Traffic parameters:
  rows_key       the configuration's key of the training rows
  warm_trees     trees of the set-up fit, which launches every shape the
                 window's fit launches (each level's histogram, the leaf
                 sums, the closing plan's kernels) and times an iteration
  min_trees      the fewest trees the window's fit grows
  start_trees    trees the reference follows from the start on its own
                 scores
  sampled_trees  further trees (drawn from the seed, the last one always
                 among them) it checks from the program's own state
  limits         {check name: limit}

Set-up makes labelled rows and their quantile borders from the seed,
quantizes the rows once into a pool (the program's binarize) and runs a
short fit.  The window is one fit of as many trees as the set-up fit's
median iteration says fill `seconds` (at least `min_trees`); the time per
step is the fit's wall time over its trees.

The check.  Growing a tree is a chain of choices, so the reference follows
the program's splits and judges each: at every level it works out every
split's gain from its own float64 histogram and reads how far the
program's split falls below the best (`split_gain_gap`, a share of the
best gain); at the leaves it works out the Newton values of the program's
partition (`leaf_value_err`, the largest difference over the checked
trees as a share of their largest value, which the first trees set: a
later tree's values shrink as the fit converges while the float32
rounding of its gradients does not, so a share of its own largest value
would swing from seed to seed).  For the first `start_trees` trees it
scores the rows itself from its own leaf values; for the sampled trees it
scores them from the program's earlier trees (the program's own state: the
stage this skips, adding up the trees, is checked by `raw_err` on the whole
fit, the program's raw scores of every training row against the
reference's sum of the program's trees, as a share of the largest).
"""
from __future__ import annotations

import dataclasses
import sys
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
        self.n_bins = int(config["border_count"]) + 1

    def setup(self) -> None:
        from repro_torch.core import losses, quantize
        from repro_torch.core.boosting import BoostingParams
        from repro_torch.training.gbdt import GBDTTrainer

        cfg, dev = self.cfg, self.devices[0]
        parts = self.setup_parts = {}
        with common.phase(parts, "inputs"):
            g = data.generator(self.seed, dev)
            self.x, self.y = data.labelled_rows(self.n_rows, cfg, g, dev)
            self.borders = data.quantile_borders(self.x,
                                                 cfg["border_count"])
        with common.phase(parts, "pool"):
            self.pool = quantize.quantize_pool(self.x, self.borders)
        params = BoostingParams(n_trees=int(self.mix["warm_trees"]),
                                depth=cfg["depth"],
                                learning_rate=cfg["learning_rate"],
                                l2_reg=cfg["l2_leaf_reg"],
                                max_bins=self.n_bins)
        with common.phase(parts, "warm fit"):
            self.trainer = GBDTTrainer(losses.MultiClass(
                n_classes=cfg["n_outputs"]), params, device=dev)
            self.trainer.fit_pool(self.pool, self.y, borders=self.borders)
        iter_s = self.trainer.metrics.snapshot()["iter_p50_ms"] / 1e3
        self.n_trees = max(int(self.mix["min_trees"]),
                           int(round(self.seconds / max(iter_s, 1e-4))))
        self.trainer.params = dataclasses.replace(params,
                                                  n_trees=self.n_trees)

    def window(self) -> dict:
        from repro_torch.training.gbdt import TrainingMetrics

        self.trainer.metrics = TrainingMetrics()
        t0 = time.perf_counter()
        with common.host_span("train/fit"):
            ens, history = self.trainer.fit_pool(self.pool, self.y,
                                                 borders=self.borders)
        elapsed = time.perf_counter() - t0
        self.fit = {"split_features": ens.split_features,
                    "split_bins": ens.split_bins,
                    "leaf_values": ens.leaf_values,
                    "base_score": ens.base_score,
                    "raw": torch.as_tensor(history["final_raw"])}
        cfg = self.cfg
        return {
            "window_s": elapsed, "attempted": self.n_trees, "failed": 0,
            "e2e": {"train_step_ms": elapsed / self.n_trees * 1e3},
            "facts": {"steps": self.n_trees, "step_s": elapsed / self.n_trees,
                      "training": self.trainer.metrics.snapshot(),
                      "train": {"rows": self.n_rows,
                                "features": cfg["features"],
                                "bins": self.n_bins, "depth": cfg["depth"],
                                "outputs": cfg["n_outputs"]}},
        }

    def release(self) -> None:
        del self.trainer, self.pool

    # -- the check ---------------------------------------------------------
    def _tree(self, bins, raw, sf, sb, lv):
        """(worst gain gap, largest leaf value difference, the reference's
        leaf values, the rows' leaves) of one tree grown from scores
        `raw`."""
        cfg = self.cfg
        gh = reference.grad_hess_multiclass(raw, self.y)
        n_borders = torch.full((bins.shape[1],), self.n_bins - 1,
                               device=bins.device)
        leaf = torch.zeros(bins.shape[0], dtype=torch.int64,
                           device=bins.device)
        worst = 0.0
        for d in range(sf.shape[0]):
            hist = reference.level_histogram(bins, leaf, gh,
                                             n_leaves=1 << d,
                                             n_bins=self.n_bins)
            gain = reference.split_gains(hist, n_borders,
                                         cfg["l2_leaf_reg"])
            f, b = int(sf[d]), int(sb[d])
            best = float(gain.max())
            inside = 0 <= f < gain.shape[0] and 0 <= b < gain.shape[1]
            mine = float(gain[f, b]) if inside else -np.inf
            if best == mine:
                gap = 0.0
            elif np.isfinite(mine) and best > 0:
                gap = (best - mine) / best
            else:
                gap = np.inf
            worst = max(worst, gap)
            if inside:
                leaf |= (bins[:, f] >= b).long() << d
        w = reference.leaf_values(gh, leaf, n_leaves=1 << sf.shape[0],
                                  learning_rate=cfg["learning_rate"],
                                  l2=cfg["l2_leaf_reg"])
        return worst, float((lv.to(w) - w).abs().max()), w, leaf

    def _judge(self, fit: dict) -> dict:
        dev = self.x.device
        sf, sb = fit["split_features"].to(dev), fit["split_bins"].to(dev)
        lv = fit["leaf_values"].to(dev)
        base = fit["base_score"].to(dev)
        bins = reference.binarize(self.x, self.borders)
        n_trees = sf.shape[0]
        start = min(int(self.mix["start_trees"]), n_trees)
        rng = np.random.default_rng(self.seed)
        later = range(start, n_trees)
        picked = rng.choice(later, size=min(len(later),
                                            int(self.mix["sampled_trees"])),
                            replace=False) if len(later) else []
        sampled = sorted(set(np.asarray(picked).tolist())
                         | ({n_trees - 1} if len(later) else set()))
        gap = err = scale = 0.0

        def judge(k, raw):
            nonlocal gap, err, scale
            g_k, e_k, w, leaf = self._tree(bins, raw, sf[k], sb[k], lv[k])
            w_max = float(w.abs().max())
            gap, err, scale = max(gap, g_k), max(err, e_k), max(scale, w_max)
            print(f"tree {k}: gain gap {g_k:.3e}, leaf difference "
                  f"{e_k:.3e}, largest leaf {w_max:.3e}", file=sys.stderr)
            return w, leaf

        raw = base.double().expand(bins.shape[0], -1).clone()
        for k in range(start):
            w, leaf = judge(k, raw)
            raw = raw + w[leaf]
        zero = torch.zeros_like(base)

        def summed(t0, t1):
            return reference.raw_scores(bins, sf[t0:t1], sb[t0:t1],
                                        lv[t0:t1], zero)
        at = 0
        raw = base.double().expand(bins.shape[0], -1).clone()
        for k in sampled:
            raw = raw + summed(at, k)
            at = k
            judge(k, raw)
        want = raw + summed(at, n_trees)
        got = fit["raw"].to(dev).double()
        raw_err = (float((got - want).abs().max()
                         / want.abs().max().clamp_min(1e-300))
                   if got.shape == want.shape and torch.isfinite(got).all()
                   else np.inf)
        lim = self.mix["limits"]
        return {"split_gain_gap": (gap, lim["split_gain_gap"]),
                "leaf_value_err": (err / max(scale, 1e-300),
                                   lim["leaf_value_err"]),
                "raw_err": (raw_err, lim["raw_err"])}

    def use_control(self, dtype, leaf_dtype) -> None:
        """The reference's own trainer in `dtype`, its leaf values kept in
        `leaf_dtype`, grows as many trees as the program did, and its trees
        and raw scores are judged instead."""
        cfg = self.cfg
        bins = reference.binarize(self.x, self.borders)
        n, depth = bins.shape[0], cfg["depth"]
        n_borders = torch.full((bins.shape[1],), self.n_bins - 1,
                               device=bins.device)
        raw = torch.zeros((n, cfg["n_outputs"]), dtype=dtype,
                          device=bins.device)
        sfs, sbs, lvs = [], [], []
        for _ in range(self.n_trees):
            gh = reference.grad_hess_multiclass(raw, self.y)
            leaf = torch.zeros(n, dtype=torch.int64, device=bins.device)
            sf, sb = [], []
            for d in range(depth):
                gain = reference.split_gains(
                    reference.level_histogram(bins, leaf, gh,
                                              n_leaves=1 << d,
                                              n_bins=self.n_bins),
                    n_borders, cfg["l2_leaf_reg"])
                flat = int(torch.argmax(gain.reshape(-1)))
                f, b = divmod(flat, gain.shape[1])
                leaf |= (bins[:, f] >= b).long() << d
                sf.append(f)
                sb.append(b)
            w = reference.leaf_values(gh, leaf, n_leaves=1 << depth,
                                      learning_rate=cfg["learning_rate"],
                                      l2=cfg["l2_leaf_reg"])
            w = w.to(leaf_dtype).to(dtype)
            raw = raw + w[leaf]
            sfs.append(sf)
            sbs.append(sb)
            lvs.append(w.float())
        self.fit = {"split_features": torch.tensor(sfs, dtype=torch.int32),
                    "split_bins": torch.tensor(sbs, dtype=torch.int32),
                    "leaf_values": torch.stack(lvs),
                    "base_score": torch.zeros(cfg["n_outputs"]),
                    "raw": raw.float()}

    def check(self) -> dict:
        return self._judge(self.fit)

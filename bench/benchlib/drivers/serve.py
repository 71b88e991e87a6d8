"""Online scoring: independent users send requests into one `GBDTServer`
on an open-loop schedule.

Traffic parameters:
  rows_key           the configuration's key of the rows requests draw from
  rate_per_s         requests a second, fixed (found by `sweep_serve.py`)
  max_request_rows   request sizes are log-uniform in [1, this]
  block_s            the length of the block whose requests every block of
                     the window repeats in an order of its own
  base_seed          seeds the block's multiset of sizes and gaps; the
                     run's seed only orders them and picks the rows, so
                     every seed offers the same work each second
  server             `GBDTServer` keyword arguments
  checked_requests   how many requests (drawn from the seed) are judged
  grace_s            how long past the window's close a request may finish
  limits             {check name: limit}

A request of k rows is k rows submitted together to the server's batcher
(`GBDTServer.batcher.submit`, its one-row entry); it is done when its last
row's answer is back.  The batcher answers in submission order, so one
collector thread waits on each request's last row in turn.  A request's
latency runs from when it was due, not when it was sent, so a late
generator counts against the server; one that never finishes counts as
the whole wait.  Gaps are exponential within a block, scaled so that each
block's requests fill it: the offered rate is exactly `rate_per_s`.

Staged: no cell of `BENCHMARK.json` drives this yet (yearmsd-serve was
proved correct and left out; `PERF.md`, Open questions), so the
benchmark's check never runs it.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from benchlib import data
from benchlib.drivers import common

import reference


def schedule(mix: dict, seed: int, seconds: float, n_rows: int,
             rate: float) -> dict:
    """Due times, sizes and first rows of the window's requests.

    The base seed draws one block's requests: `rate * block_s` exponential
    gaps, scaled to fill the block exactly, and as many log-uniform sizes.
    Every block of the window offers that same multiset, each in an order
    of its own drawn from the run's seed (gaps and sizes apart), so every
    second of every run offers the same work and only its order varies."""
    block = float(mix["block_s"])
    per = max(1, int(round(rate * block)))
    top = int(mix["max_request_rows"])
    base = np.random.default_rng(mix["base_seed"])
    gaps = base.exponential(1.0, per)
    gaps *= block / gaps.sum()
    sizes = np.clip(np.exp(base.uniform(0.0, np.log(top), per)).astype(int),
                    1, top)
    rng = np.random.default_rng(seed)
    n_blocks = int(np.ceil(seconds / block))
    gaps = np.concatenate([rng.permutation(gaps) for _ in range(n_blocks)])
    sizes = np.concatenate([rng.permutation(sizes) for _ in range(n_blocks)])
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    keep = due < seconds
    due, sizes = due[keep], sizes[keep]
    n = len(due)
    starts = rng.integers(0, n_rows - sizes + 1)
    checked = rng.choice(n, size=min(n, int(mix["checked_requests"])),
                         replace=False)
    return {"due": due, "sizes": sizes, "starts": starts,
            "checked": set(checked.tolist())}


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, devices,
                 seconds: float):
        self.cfg, self.mix, self.seed = config, traffic, seed
        self.devices, self.seconds = devices, seconds
        self.n_rows = int(config[traffic["rows_key"]])
        self.rate = float(traffic["rate_per_s"])
        self.outputs: dict[int, np.ndarray] = {}

    def setup(self) -> None:
        from repro_torch.core.trees import ObliviousEnsemble
        from repro_torch.serving.engine import GBDTServer

        dev = self.devices[0]
        parts = self.setup_parts = {}
        with common.phase(parts, "inputs"):
            g = data.generator(self.seed, dev)
            self.arrays = data.ensemble_arrays(self.cfg, g, dev)
            self.x_host = data.rows(self.n_rows, self.cfg["features"],
                                    self.cfg["nan_share"], g,
                                    dev).cpu().numpy()
        with common.phase(parts, "server"):
            self.server = GBDTServer(ObliviousEnsemble(**self.arrays),
                                     device=dev, **self.mix["server"])
        with common.phase(parts, "warm"):
            for bucket in self.server.buckets:      # every batch shape
                self.server.predict_batch(self.x_host[:bucket])
            for j in range(8):                      # the batcher's path
                self.server.predict(self.x_host[j])

    def window(self) -> dict:
        seconds = self.seconds
        plan = schedule(self.mix, self.seed, seconds, self.n_rows, self.rate)
        due, sizes, starts = plan["due"], plan["sizes"], plan["starts"]
        checked = plan["checked"]
        n = len(due)
        done = np.full(n, np.nan)
        late = np.zeros(n)
        pending: queue.Queue = queue.Queue()
        close = [float("inf")]
        grace = float(self.mix["grace_s"])
        outputs = self.outputs

        def collect():
            while True:
                item = pending.get()
                if item is None:
                    return
                i, futs = item
                wait = min(close[0] + grace - time.perf_counter(),
                           seconds + grace)
                try:
                    last = futs[-1].get(timeout=max(wait, 0.0))
                except queue.Empty:
                    continue
                done[i] = time.perf_counter()
                if i in checked:
                    outputs[i] = np.stack([f.get_nowait() for f in futs[:-1]]
                                          + [last])

        self.server.metrics.reset()
        collector = threading.Thread(target=collect, name="bench-collector",
                                     daemon=True)
        collector.start()
        submit = self.server.batcher.submit
        x = self.x_host
        t0 = time.perf_counter()
        for i in range(n):
            target = t0 + due[i]
            now = time.perf_counter()
            if now < target:
                time.sleep(target - now)
            with common.host_span("client/submit"):
                s = int(starts[i])
                late[i] = time.perf_counter() - target
                pending.put((i, [submit(i, x[s + j])
                                 for j in range(int(sizes[i]))]))
        close[0] = t0 + seconds
        pending.put(None)
        collector.join(timeout=seconds + grace + 5.0)
        failed = int(np.isnan(done).sum())
        done = np.where(np.isnan(done), close[0] + grace, done)
        lat_ms = (done - (t0 + due)) * 1e3
        snap = self.server.metrics.snapshot()
        self.plan = plan
        return {
            "window_s": seconds, "attempted": n, "failed": failed,
            "e2e": {"serve_p95_ms": float(np.percentile(lat_ms, 95))},
            "facts": {"requests": n, "rows": int(sizes.sum()),
                      "latency_ms": lat_ms, "late_s": late,
                      "served_rows": self.server.metrics.served_rows,
                      "batches": snap["batches"],
                      "pad_overhead": snap["pad_overhead"],
                      "model": common.model_shape(self.cfg)},
        }

    def release(self) -> None:
        self.server.close()
        del self.server

    def _checked_rows(self) -> tuple[list[int], np.ndarray]:
        ids = sorted(self.plan["checked"])
        starts, sizes = self.plan["starts"], self.plan["sizes"]
        idx = np.concatenate([np.arange(starts[i], starts[i] + sizes[i])
                              for i in ids])
        return ids, self.x_host[idx]

    def _reference(self, dtype, leaf_dtype=None
                   ) -> tuple[list[int], np.ndarray]:
        ids, rows = self._checked_rows()
        a = self.arrays
        x = torch.from_numpy(rows).to(a["borders"].device)
        raw = reference.raw_scores(reference.binarize(x, a["borders"]),
                                   a["split_features"], a["split_bins"],
                                   a["leaf_values"], a["base_score"],
                                   dtype=dtype, leaf_dtype=leaf_dtype,
                                   row_block=(len(rows)
                                              if dtype != torch.float64
                                              else 8192))
        return ids, reference.proba(raw).double().cpu().numpy()

    def _split(self, ids, flat) -> dict[int, np.ndarray]:
        out, at = {}, 0
        for i in ids:
            k = int(self.plan["sizes"][i])
            out[i] = flat[at:at + k]
            at += k
        return out

    def use_control(self, dtype, leaf_dtype) -> None:
        ids, p = self._reference(dtype, leaf_dtype)
        self.outputs = self._split(ids, p)

    def check(self) -> dict:
        ids, want = self._reference(torch.float64)
        want = self._split(ids, want)
        worst = max(common.max_abs_err(self.outputs.get(i), want[i])
                    if i in self.outputs else float("inf") for i in ids)
        return {"proba_max_err": (worst, self.mix["limits"]["proba_max_err"])}

"""One run of one cell: set-up, the measured window, the trace, the check.

`run_cell` is what `run.py` calls after its own checks of the machine; the
tests call it on the CPU with smaller sizes (`overrides`) and the
program's plain versions.
"""
from __future__ import annotations

import gc
import sys
import time

import torch

from benchlib import drivers, spec

# the controls of a configuration's stated precision, each the reference put
# in the program's place as (the precision it computes and sums in, the one
# it keeps its leaf values in): "bf16", the precision below the stated one
# throughout; "bf16_leaves", the leaf table kept a step below under sums in
# the stated precision (the shortcut that halves a table past L2)
CONTROLS = {"float32": {"bf16": (torch.bfloat16, torch.bfloat16),
                        "bf16_leaves": (torch.float32, torch.bfloat16)}}


def devices_for(chips: int, kind: str) -> list[torch.device]:
    if kind == "cpu":
        return [torch.device("cpu")] * chips
    return [torch.device("cuda", i) for i in range(chips)]


def _sync(devs) -> None:
    for d in {d for d in devs if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def settle() -> None:
    """End set-up as a long-running Python service does after warm-up:
    collect, then move every object alive (the interpreter's, torch's, the
    program's, the model's) into the collector's permanent generation, so
    that a full collection in the window walks only what the window made.
    Left as it is, a full collection walks torch's objects too, 130-175 ms
    each on the card's host, and lands in a serve cell's tail."""
    gc.collect()
    gc.freeze()


def build(cell: spec.Cell, seed: int, seconds: float, kind: str,
          overrides: dict | None = None, mix: dict | None = None):
    """The cell's driver over its devices, not yet set up; `overrides` and
    `mix` replace keys of its configuration and traffic mix (the tests'
    small sizes)."""
    config = {**cell.config, **(overrides or {})}
    traffic = {**cell.traffic, **(mix or {})}
    devs = devices_for(cell.chips, kind)
    return drivers.load(traffic["driver"])(config, traffic, seed, devs,
                                           seconds), devs


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
             kind: str = "cuda", started: float | None = None,
             overrides: dict | None = None, mix: dict | None = None,
             control: str | None = None) -> dict:
    """The result line's fields (and `checks`, {name: (number, limit)}).
    With `control` (a name in `CONTROLS`) that control's outputs are
    judged in the program's place."""
    started = time.perf_counter() if started is None else started
    driver, devs = build(cell, seed, seconds, kind, overrides, mix)
    on_card = kind == "cuda"
    driver.setup()
    _sync(devs)
    settle()
    setup_s = time.perf_counter() - started
    if on_card:
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)
    prof = tracer = None
    if trace:
        from repro_torch.kernels import ops
        from repro_torch.obs.trace import get_tracer

        from benchlib import profile
        ops.reset_launch_counts()
        tracer = get_tracer()
        tracer.clear()
        tracer.enable()
        if on_card:
            prof = profile.start()
    t0 = time.perf_counter()
    try:
        got = driver.window()
        _sync(devs)
    finally:
        traced_s = time.perf_counter() - t0
        if tracer is not None:
            tracer.disable()
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = max((torch.cuda.max_memory_allocated(d) for d in devs),
               default=0) if on_card else 0
    facts = dict(got["facts"], window_s=got["window_s"], traced_s=traced_s,
                 chips=cell.chips, on_card=on_card)
    if trace:
        from repro_torch.kernels import ops
        facts["launches"] = sum(ops.launch_counts().values())
        facts["events"] = tracer.events()
        facts["dropped_events"] = tracer.dropped
        if prof is not None:
            from benchlib import profile
            facts["profile"] = profile.summarize(prof, cell.chips)
    driver.release()
    gc.unfreeze()
    if on_card:
        torch.cuda.empty_cache()
    if control:
        driver.use_control(*CONTROLS[cell.config["dtype"]][control])
    checks = driver.check()
    correct = all(v <= lim for v, lim in checks.values())
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name(devs[0]) if on_card
                       else "cpu"),
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(facts)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out_profile = facts.get("profile")
        if out_profile is not None:
            device["busy_s"] = out_profile["busy_s"]
            device["window_s"] = traced_s
    else:
        values = dict(got["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": bool(correct), "attempted": int(got["attempted"]),
              "failed": int(got["failed"]), "metrics": metrics,
              "device": device}
    if trace and facts.get("profile") is not None:
        result["breakdown"] = {"device_ops": facts["profile"]["device_ops"],
                               "idle_gaps": facts["profile"]["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    facts["setup_parts"] = getattr(driver, "setup_parts", {})
    result["facts"] = facts
    return result


def loaded_jax() -> list[str]:
    """Modules of `sys.modules` whose top-level name is JAX's, its
    libraries' or the JAX package's (`repro`; not `repro_torch`)."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in banned)

"""`BENCHMARK.json` and the files a cell is made of, found by name.

  configuration  `configs/<config>.json` (the file `BENCHMARK.json` names)
  traffic mix    `traffic/<traffic>.json`: its `driver` (a module of
                 `benchlib.drivers`) and the parameters that driver reads
  metric         `metrics/<name>.py`, else `metrics/<name up to its first
                 dot>.py`: a `read(ctx)` that returns a number or None
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list


def load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: pathlib.Path) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, with its configuration and
    traffic mix read and the metrics it reports."""
    spec = load_json(root / "BENCHMARK.json")
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in spec['workloads']]}")
    work = found[0]
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    config = load_json(root / conf["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{work['traffic']}.json")
    return Cell(name=name, chips=int(work["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _applies(m, name)])


def metric_reader(name: str):
    """The `read` function of per-layer metric `name`."""
    folder = BENCH_DIR / "metrics"
    for stem in (name, name.split(".")[0]):
        path = folder / f"{stem}.py"
        if path.exists():
            mod_spec = importlib.util.spec_from_file_location(
                f"bench_metric_{stem.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(mod_spec)
            mod_spec.loader.exec_module(module)
            return module.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {folder}")

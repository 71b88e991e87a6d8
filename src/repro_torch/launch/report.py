"""Assemble the experiments report from the port's results JSONs: the
counterpart of `src/repro/launch/report.py`, with its sections, rendering
only what the port's cells hold (`results/dryrun_torch/`,
`results/perf_torch/`).

  PYTHONPATH=src python -m repro_torch.launch.report > EXPERIMENTS_torch.md
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
from typing import Optional, Sequence

from repro_torch import configs
from repro_torch.configs.base import SUBQUADRATIC, applicable_shapes
from repro_torch.launch import roofline as rl
from repro_torch.launch.hlo_analysis import HBM_BW, LINK_BW, PEAK_FLOPS

ROOT = pathlib.Path(__file__).resolve().parents[3]
RESULTS = ROOT / "results"
MESHES = ((False, "single-pod 16×16 (256 cards)"),
          (True, "multi-pod 2×16×16 (512 cards)"))


def _load(path: pathlib.Path):
    return json.loads(path.read_text()) if path.exists() else None


def _fmt_bytes(b):
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def card() -> Optional[str]:
    """The card as `nvidia-smi` names it with its power limit, or None
    where there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def card_memory() -> Optional[int]:
    """The card's memory in bytes, or None without a card."""
    import torch
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(0).total_memory)


def dryrun_section(results: pathlib.Path,
                   memory: Optional[int]) -> list[str]:
    out = ["## §Dry-run", ""]
    out.append(
        "Every applicable (architecture × shape) cell was traced on a fake "
        "process group of the production mesh's size — 16×16 = 256 ranks "
        "(`data`,`model`) and 2×16×16 = 512 (`pod`,`data`,`model`) — as "
        "rank 0 under `FakeTensorMode`, every leaf a DTensor of fake local "
        "shards placed by the partition specs (`launch/dryrun.py`). "
        "`long_500k` runs for the sub-quadratic archs "
        f"{sorted(SUBQUADRATIC)} only. `train_*` traces `make_train_step` "
        "(forward, backward, optimizer), `prefill_*` the cache-filling "
        "prefill, `decode_*`/`long_*` one decode step against the cache. "
        "Every layer is traced: the costs are the full depth's.")
    out.append("")
    for mp, label in MESHES:
        out.append(f"### Mesh {label}")
        out.append("")
        out.append("| arch | shape | status | trace | ops/dev | args "
                   "bytes/dev | collectives seen |")
        out.append("|---|---|---|---|---|---|---|")
        n_ok = n_total = 0
        over = []
        for arch, cfg in configs.ARCHS.items():
            for shp in applicable_shapes(cfg):
                n_total += 1
                pod = "multipod" if mp else "singlepod"
                c = _load(results / "dryrun_torch" /
                          f"{arch}__{shp}__{pod}.json")
                if c is None:
                    out.append(f"| {arch} | {shp} | MISSING | | | | |")
                    continue
                if c.get("status") != "ok":
                    out.append(f"| {arch} | {shp} | ERROR | "
                               f"{str(c.get('error', ''))[:70]} | | | |")
                    continue
                n_ok += 1
                args = c.get("memory_analysis", {}).get("argument_bytes", 0)
                if memory is not None and args > memory:
                    over.append(f"{arch}/{shp} ({_fmt_bytes(args)})")
                kinds = [k for k in c["collective_bytes"]
                         if k != "total" and c["collective_bytes"][k] > 0]
                out.append(
                    f"| {arch} | {shp} | ok | {c['trace_seconds']}s | "
                    f"{c.get('ops_per_device', '-')} | {_fmt_bytes(args)} | "
                    f"{', '.join(sorted(kinds)) or '-'} |")
        out.append("")
        out.append(f"**{n_ok}/{n_total} cells trace.**")
        if memory is None:
            out.append("Fit: not measured (no card to read its memory "
                       "from).")
        else:
            out.append(f"Fit against the card's {_fmt_bytes(memory)} "
                       f"(`args bytes/dev`: params, optimizer state and "
                       f"inputs, this rank's shards): "
                       f"{', '.join(over) or 'every traced cell fits'}"
                       f"{' do not fit' if over else ''}.")
        out.append("")
    out.append("### The paper's own model at production scale")
    out.append("")
    out.append(
        "1M×54 rows against a 10k-tree depth-8 7-class ensemble: rows "
        "shard over (pod, data), trees over `model`, the partial scores "
        "summed over `model`; plus one boosting iteration on one "
        "(pod, data) shard of rows (`launch/dryrun_gbdt.py`).")
    out.append("")
    out.append("| cell | mesh | status | compute | memory | collective |"
               " useful ratio | kernels |")
    out.append("|---|---|---|---|---|---|---|---|")
    for cell in ("predict-1m", "train-iter"):
        for pod, label in (("singlepod", "16×16"), ("multipod", "2×16×16")):
            c = _load(results / "dryrun_torch" /
                      f"gbdt-{cell}__paper__{pod}.json")
            if not c:
                continue
            if c.get("status") != "ok":
                out.append(f"| gbdt-{cell} | {label} | ERROR | | | | | |")
                continue
            kernels = ", ".join(r["name"].removeprefix("repro_")
                                for r in c.get("launches", [])) or "-"
            out.append(
                f"| gbdt-{cell} | {label} | ok | {c['compute_s']*1e3:.3f}ms"
                f" | {c['memory_s']*1e3:.3f}ms | "
                f"{c['collective_s']*1e6:.2f}µs | "
                f"{c['useful_flops_ratio']:.3f} | {kernels} |")
    out.append("")
    return out


def roofline_section(results: pathlib.Path,
                     card_name: Optional[str]) -> list[str]:
    out = ["## §Roofline", ""]
    out.append(
        f"Hardware model (NVIDIA H100 SXM5 per card, "
        f"`launch/hlo_analysis.py`): {PEAK_FLOPS/1e12:.0f} TFLOP/s dense "
        f"bf16, {HBM_BW/1e12:.2f} TB/s HBM3, {LINK_BW/1e9:.0f} GB/s NVLink "
        f"(one direction); card: {card_name or 'not measured'}. Terms, as "
        "the JAX package computes them: `compute = FLOPs/(cards·peak)`, "
        "`memory = bytes/(cards·HBM_bw)`, `collective = "
        "collective_bytes/(cards·link_bw)` (one card's collective bytes, "
        "divided by the card count a second time). FLOPs are the "
        "matmul-family ops' at local shard shapes; bytes every aten op's "
        "input plus output bytes, with no fusion modelled (an upper "
        "bound); collective bytes the result bytes of each collective "
        "rank 0 issues. MODEL_FLOPS = 6·N_active·D (train), "
        "2·N_active·D (prefill/decode).")
    out.append("")
    out.append("### Single-pod baselines")
    out.append("")
    cells = rl.load_cells(False, results / "dryrun_torch")
    out.append(rl.render(cells))
    out.append("")
    ok = [c for c in cells if c.get("status") == "ok"]
    if ok:
        worst = min((c for c in ok if c["shape"] != "long_500k"),
                    key=lambda c: c["useful_flops_ratio"], default=ok[0])
        coll = max(ok, key=lambda c: c["collective_s"])
        out.append(f"- Worst useful-FLOPs ratio: **{worst['arch']}/"
                   f"{worst['shape']}** ({worst['useful_flops_ratio']:.2f})")
        out.append(f"- Most collective-bound: **{coll['arch']}/"
                   f"{coll['shape']}** ({rl._fmt_s(coll['collective_s'])})")
    out.append("")
    out.append("### Multi-pod (512-card) deltas")
    out.append("")
    out.append("| arch | shape | collective Δ vs single-pod | compute/dev Δ |")
    out.append("|---|---|---|---|")
    for arch, cfg in configs.ARCHS.items():
        for shp in applicable_shapes(cfg):
            a = _load(results / "dryrun_torch" /
                      f"{arch}__{shp}__singlepod.json")
            b = _load(results / "dryrun_torch" /
                      f"{arch}__{shp}__multipod.json")
            if not (a and b and a.get("status") == b.get("status") == "ok"):
                continue
            d_coll = (b["collective_s"] / a["collective_s"]
                      if a["collective_s"] > 1e-12 else float("nan"))
            d_comp = (b["flops_per_device"] / a["flops_per_device"]
                      if a["flops_per_device"] else float("nan"))
            out.append(f"| {arch} | {shp} | {d_coll:.2f}× | {d_comp:.2f}× |")
    out.append("")
    return out


def perf_section(results: pathlib.Path) -> list[str]:
    from repro_torch.launch.perf import CELLS

    out = ["## §Perf — variants", ""]
    out.append(
        "Three LM cells (kimi-k2/train_4k, internvl2/prefill_32k, "
        "internlm2/decode_32k), each variant traced on the single-pod "
        "mesh, and the paper's predict path's four ways of calling "
        "(`launch/perf.py`). Each variant records hypothesis → change → "
        "result → verdict against the baseline's dominant term.")
    out.append("")
    perf_dir = results / "perf_torch"
    if not perf_dir.exists():
        out.append("_(perf results pending)_")
        return out
    for cell, spec in CELLS.items():
        runner = spec.get("runner")
        title = "gbdt predict path" if runner == "gbdt" else \
            f"{spec['arch']} × {spec['shape']}"
        out.append(f"### {cell} ({title})")
        out.append("")
        rows = []
        base = None
        for name, _, hyp in spec["variants"]:
            r = _load(perf_dir / f"{cell}__{name}.json")
            if r is None:
                continue
            if r.get("status") != "ok":
                rows.append((name, hyp, None, r.get("error", "?")))
                continue
            if base is None:
                base = r
            rows.append((name, hyp, r, None))
        if runner == "gbdt":
            out.append("| variant | µs a call | batch | device |")
            out.append("|---|---|---|---|")
            for name, hyp, r, err in rows:
                out.append(f"| {name} | ERROR {err[:60]} | | |" if r is None
                           else f"| {name} | {r['us_per_call']:.1f} | "
                           f"{r['batch']} | {r['device']} |")
        else:
            out.append("| variant | compute | memory | collective | vs "
                       "baseline dominant | verdict |")
            out.append("|---|---|---|---|---|---|")
            for name, hyp, r, err in rows:
                if r is None:
                    out.append(f"| {name} | - | - | - | - | ERROR "
                               f"{err[:60]} |")
                    continue
                if r is base:
                    delta, verdict = "—", "baseline"
                else:
                    dom = base["dominant"]
                    d = r[dom] / base[dom] if base[dom] > 1e-12 else 1.0
                    delta = f"{(1-d)*100:+.1f}% {dom[:-2]}"
                    verdict = ("**confirmed**" if d < 0.95 else
                               ("refuted (regression)" if d > 1.05
                                else "≈neutral"))
                out.append(f"| {name} | {r['compute_s']:.3g}s | "
                           f"{r['memory_s']:.3g}s | "
                           f"{r['collective_s']:.3g}s | {delta} | "
                           f"{verdict} |")
        out.append("")
        for name, hyp, r, err in rows:
            out.append(f"- **{name}** — hypothesis: {hyp}")
        out.append("")
    return out


def bench_section() -> list[str]:
    return ["## §Paper tables", "",
            "The port's benchmarks (`benchmarks/*_bench.py` run on the "
            "card, with `perf_gate.py`'s baselines) wait for the benchmark "
            "PR: nothing here is measured by them yet.", ""]


def render(results: Optional[pathlib.Path] = None,
           card_name: Optional[str] = None,
           memory: Optional[int] = None) -> str:
    results = RESULTS if results is None else pathlib.Path(results)
    lines = ["# EXPERIMENTS (PyTorch/CUDA port)", ""]
    lines.append(
        "Reproduction and performance report of the CatBoost RVV "
        "vectorization paper's PyTorch/CUDA port for the NVIDIA H100, "
        "rendered from the port's results JSONs.")
    lines.append("")
    lines += bench_section()
    lines += dryrun_section(results, memory)
    lines += roofline_section(results, card_name)
    lines += perf_section(results)
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=str(RESULTS))
    args = ap.parse_args(argv)
    print(render(pathlib.Path(args.results), card(), card_memory()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

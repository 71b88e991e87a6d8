"""Roofline report: reads the dry run's JSON cells and renders the
roofline table.  The port's counterpart of `src/repro/launch/roofline.py`:
the same table, byte for byte, from the same cell keys, over the port's
cells (`results/dryrun_torch/`, `launch/dryrun.py`).

Usage:  python -m repro_torch.launch.roofline [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Optional, Sequence

from repro_torch import configs
from repro_torch.configs.base import applicable_shapes

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"


def load_cells(multi_pod: bool, results: Optional[pathlib.Path] = None
               ) -> list[dict]:
    results = RESULTS if results is None else pathlib.Path(results)
    out = []
    pod = "multipod" if multi_pod else "singlepod"
    for arch, cfg in configs.ARCHS.items():
        for shp in applicable_shapes(cfg):
            p = results / f"{arch}__{shp}__{pod}.json"
            if p.exists():
                out.append(json.loads(p.read_text()))
            else:
                out.append({"arch": arch, "shape": shp,
                            "status": "missing"})
    return out


def _fmt_s(x) -> str:
    if x is None:
        return "-"
    if x >= 0.1:
        return f"{x:.2f}s"
    if x >= 1e-4:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def render(cells: list[dict], markdown: bool = True) -> str:
    lines = []
    if markdown:
        lines.append("| arch | shape | compute | memory | collective |"
                     " dominant | MODEL/HLO FLOPs | roofline frac |")
        lines.append("|---|---|---|---|---|---|---|---|")
    for c in cells:
        if c.get("status") != "ok":
            lines.append(f"| {c['arch']} | {c['shape']} | "
                         f"{c.get('status')} {str(c.get('error',''))[:60]} |"
                         " | | | | |" if markdown else
                         f"{c['arch']} {c['shape']} {c.get('status')}")
            continue
        dom = c["dominant"].replace("_s", "")
        row = (c["arch"], c["shape"], _fmt_s(c["compute_s"]),
               _fmt_s(c["memory_s"]), _fmt_s(c["collective_s"]), dom,
               f"{c['useful_flops_ratio']:.2f}",
               f"{c['roofline_fraction']*100:.1f}%")
        if markdown:
            lines.append("| " + " | ".join(row) + " |")
        else:
            lines.append("  ".join(f"{v:>14s}" for v in row))
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    cells = load_cells(args.multi_pod)
    print(render(cells))
    ok = [c for c in cells if c.get("status") == "ok"]
    if ok:
        worst = min(ok, key=lambda c: c["roofline_fraction"])
        collective = max(ok, key=lambda c: c["collective_s"])
        print(f"\nworst roofline fraction: {worst['arch']}/{worst['shape']}"
              f" ({worst['roofline_fraction']*100:.2f}%)")
        print(f"most collective-bound: {collective['arch']}/"
              f"{collective['shape']} ({_fmt_s(collective['collective_s'])})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

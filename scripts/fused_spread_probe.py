#!/usr/bin/env python3
"""Where one block of the soa or bp fused kernel's spread route spends its
time.

    python3 scripts/fused_spread_probe.py [--layout soa|bitpacked]
        [--out build/probe.jsonl]

Copies `src/repro_torch/kernels/csrc/` into `build/fused_spread_probe/`,
adds `clock64()` stamps to `fused_spread_kernel` (`fused_spread.cuh`;
read back through two functions added to the layout's kernel source,
`fused_predict.cu` for soa, `fused_predict_bp.cu` for bitpacked, whose
model is soa's splits as one group's (D, T) planes with uint8
thresholds; block 0, thread 0: after
stage 1's binarize, after the first chunk's index, and in each chunk after
the copies are issued, after the sum of the chunk before, after each of
the two barriers' waits and the next chunk's index), builds that copy
with the port's own `_build`, and runs it on the same numpy-seeded models
as scripts/fused_route_sweep.py: Covertype's serving shape at 1, 16 and
1,024 rows, the kNN head's at 2,841, each with L2 flushed and warm.
Prints per phase the SM cycles of block 0, as one JSON object a line;
the last line is the card.  Needs one CUDA card; the repo's own kernels
and their build are untouched.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
STAMPS = 512


def patched_source(text: str) -> str:
    """The spread route's header with the stamps in.  The stamps are
    `static`: each source that includes the header has its own."""
    head = text.index("namespace {\n")
    text = (text[:head] + f"""static __device__ unsigned long long g_probe[{STAMPS}];
#define STAMP(k) do {{ if (blockIdx.x == 0 && threadIdx.x == 0 && \\
  (k) < {STAMPS}) g_probe[(k)] = clock64(); }} while (0)
""" + text[head:])
    edits = (
        ("  const int n_chunks = (n_trees + chunk - 1) / chunk;\n",
         "  const int n_chunks = (n_trees + chunk - 1) / chunk;\n"
         "  STAMP(0);\n"),
        ("  // A chunk's splits, as a (D, chunk) plane",
         "  STAMP(1);\n  // A chunk's splits, as a (D, chunk) plane"),
        ("    index_chunk(0);\n    __syncthreads();\n",
         "    index_chunk(0);\n    __syncthreads();\n    STAMP(2);\n"),
        ("      gather_chunk(k);\n      if (k > 0) sum_chunk(k - 1);\n",
         "      gather_chunk(k);\n      STAMP(3 + 5 * k);\n"
         "      if (k > 0) sum_chunk(k - 1);\n      STAMP(4 + 5 * k);\n"),
        ("chunk k's idx read\n",
         "chunk k's idx read\n      STAMP(5 + 5 * k);\n"),
        ("      if (k + 1 < n_chunks) index_chunk(k + 1);\n",
         "      if (k + 1 < n_chunks) index_chunk(k + 1);\n"
         "      STAMP(6 + 5 * k);\n"),
        ("and k + 1's idx\n",
         "and k + 1's idx\n      STAMP(7 + 5 * k);\n"),
        ("    sum_chunk(n_chunks - 1);\n",
         f"    sum_chunk(n_chunks - 1);\n    STAMP({STAMPS - 1});\n"),
    )
    for anchor, new in edits:
        if text.count(anchor) != 1:
            sys.exit(f"fused_spread_probe: the kernel source changed; "
                     f"no single anchor {anchor!r}")
        text = text.replace(anchor, new)
    return text


# The stamps of the kernels in the source they are added to, read and
# cleared from the host.
READERS = f"""
extern "C" int repro_probe_read(void* dst) {{
  return (int)cudaMemcpyFromSymbol(dst, g_probe, sizeof(g_probe));
}}
extern "C" int repro_probe_clear() {{
  static const unsigned long long zero[{STAMPS}] = {{}};
  return (int)cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
}}
"""


def phases(cycles: dict[int, int]) -> dict:
    """Cycles of each phase from the stamps."""
    n_chunks = max((k - 3) // 5 for k in cycles if 3 <= k < STAMPS - 1) + 1
    chunk = np.array([[cycles[3 + 5 * k] - cycles[2 + 5 * k],
                       cycles[4 + 5 * k] - cycles[3 + 5 * k],
                       cycles[5 + 5 * k] - cycles[4 + 5 * k],
                       cycles[6 + 5 * k] - cycles[5 + 5 * k],
                       cycles[7 + 5 * k] - cycles[6 + 5 * k]]
                      for k in range(n_chunks)])
    last = cycles[7 + 5 * (n_chunks - 1)]
    return {"chunks": n_chunks, "binarize": cycles[1],
            "splits_and_first_index": cycles[2] - cycles[1],
            "chunk_mean": dict(zip(("issue_copies", "sum_previous",
                                    "wait_splits", "index_next",
                                    "wait_copies"),
                                   chunk.mean(0).round().astype(int)
                                   .tolist())),
            "last_sum": cycles[STAMPS - 1] - last,
            "total": cycles[STAMPS - 1]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--layout", default="soa",
                        choices=("soa", "bitpacked"))
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    source = {"soa": "fused_predict.cu",
              "bitpacked": "fused_predict_bp.cu"}[args.layout]
    import torch
    if not torch.cuda.is_available():
        sys.exit("fused_spread_probe: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "scripts"))
    import fused_route_sweep as sweep
    from repro_torch.kernels import _build, tuning
    from repro_torch.kernels.fused_predict import (fused_predict,
                                                   fused_predict_bp)

    src = ROOT / "build" / "fused_spread_probe" / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    header = src / "fused_spread.cuh"
    header.write_text(patched_source(header.read_text()))
    with open(src / source, "a") as fh:
        fh.write(READERS)
    _build.CSRC, _build.BUILD_DIR = src, src.parent / "lib"
    lib = _build.library()
    lib.repro_probe_read.argtypes = [ctypes.c_void_p]
    log = _build.build_info["log"]
    for line in log[log.index(f"== {source}"):].splitlines()[:40]:
        if "spill" in line or "registers" in line:
            print(f"ptxas {line.strip()}")

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    lines = []
    for shape, counts in (("covertype", (1, 16, 1024)), ("knn", (2841,))):
        a = {k: torch.as_tensor(v, device="cuda") for k, v in sweep.model(
            **sweep.SHAPES[shape], n=max(counts)).items()}
        if args.layout == "soa":
            kernel, splits = fused_predict, "rows"
            model = (a["sf"], a["sb"], a["lv"])
        else:
            kernel, splits = fused_predict_bp, "bitpacked"
            model = (a["sf"].t().contiguous(),
                     a["sb"].t().contiguous().to(torch.uint8), a["lv"])
        for n in counts:
            args_n = (a["x"][:n], a["borders"], *model)
            plan = tuning.fused_plan(n, *a["sf"].shape, a["lv"].shape[2],
                                     a["x"].shape[1], True, "spread",
                                     splits=splits)
            for warm in (False, True):
                kernel(*args_n, route="spread")
                torch.cuda.synchronize()
                if not warm:
                    flush.zero_()
                stamps = np.zeros(STAMPS, np.uint64)
                lib.repro_probe_clear()
                kernel(*args_n, route="spread")
                torch.cuda.synchronize()
                lib.repro_probe_read(stamps.ctypes.data)
                t0 = int(stamps[0])
                cycles = {k: int(v) - t0 for k, v in enumerate(stamps)
                          if v}
                line = {"layout": args.layout, "shape": shape, "rows": n,
                        "l2": "warm" if warm
                        else "flushed", "rows_a_block": plan.rows,
                        "trees_a_chunk": plan.trees_per_chunk,
                        "threads": plan.threads, **phases(cycles)}
                print(json.dumps(line), flush=True)
                lines.append(line)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            for line in lines:
                fh.write(json.dumps({**line, "card": card}) + "\n")
    print(json.dumps({"card": card}))


if __name__ == "__main__":
    main()

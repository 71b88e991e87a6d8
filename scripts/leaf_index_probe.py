#!/usr/bin/env python3
"""What bounds the leaf-index kernel body (`csrc/leaf_index.cuh`, the
kernel of `leaf_index` and `leaf_index_dm`), and how it compares with the
body it replaced.

    python3 scripts/leaf_index_probe.py [--parent DIR] [--rounds 3]
        [--check-only] [--out build/leaf_index_probe.json]

Builds copies of the kernel into `build/leaf_index_probe/` (the repo's
kernels and their build are untouched), each a shared library of its
own:

  full       the kernel as it is: a transposed (F + 1, rows + 4) tile, a
             shared word holding 4 rows' bins of a feature, uint8 bins
             compared 4 at a time inside the word (SWAR);
  bytes      the same tile and word, each of its 4 bytes taken out and
             compared in int32 (the transposed tile without SWAR);
  rows       a row-major (rows, F + 1) tile: 4 rows at once, one shared
             byte load a row (several rows' chains, no transposed tile);
  no_store   full, but an index is stored only if it is depth << 20
             (never, and not provably so to the compiler): staging and
             compares alone;
  store_only full with no compare: the staging, the split pairs and the
             (N, T) stores alone;
  no_cap     full without the launch bound's blocks an SM (kMinBlocks),
             so ptxas takes the registers it likes;
  six_blocks full with 6 blocks an SM in the launch bound (40 registers);
  weights_first  full with dm's level weights checked before the rows
             are staged (the loads a trip to memory of their own), not
             after;
  weights_at_barrier  full with dm's level weights checked at the first
             round's barrier, a level a thread, not before the rounds;
  parent     with `--parent DIR` (an unpacked checkout of an earlier
             commit): that commit's `leaf_index.cu` / `leaf_index_dm.cu`
             and its `tuning.tile_rows` plan.

and times each on numpy-seeded Covertype-width data (54 features, bins
in [0, 64), splits over every feature with thresholds in [1, 63]) at the
shapes the main path gives the kernel: the bulk shape (139,440 rows,
1,000 trees, depth 8), the 1,024-row bucket and 16 rows of 1,000 trees,
and one small depth group (12 trees of depth 5 at 1,024 rows), on uint8
and int32 bins (at the bulk shape also int32 bins and thresholds moved
past 255), through both launchers (soa (T, D) splits and depth_major
(D, T) planes).  `full` also runs with 128 rows a block and each row
tile of `tuning.INDEX_ROWS` on uint8 bins.  The variants other than
`full` and `parent` run on uint8 bins only.  Each time is the median of CUDA events around the launch
with L2 flushed (`chip_smoke.py`'s `time_ms`) and the device time behind
a spacer kernel (`chip_smoke.py`'s `device_ms`); variants alternate
round by round, in reverse order every other round.  Every variant but
no_store and store_only is first checked against the plain version
(`ref.leaf_index`) bit for bit at every shape.  `--check-only` builds,
checks and prints the ptxas report, and times nothing.  One JSON object a
line; the last line is the card.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import device_ms, time_ms  # noqa: E402  the smoke's timing

SOURCES = ("leaf_index.cu", "leaf_index_dm.cu", "leaf_index.cuh",
           "common.cuh", "runtime.cu")
STEP = """      // bit 7 of each byte of t: low 7 bits of a >= those of b
      const uint32_t t = (a[g] | 0x80808080u) - low;
      // bit 7 of each byte: a >= b (one 3-input op: the majority of a's
      // top bit, b's top bit inverted and t's)
      const uint32_t ge = (a[g] & ~b) | (~(a[g] ^ b) & t);
"""
BYTES_STEP = """      uint32_t ge = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ge |= static_cast<uint32_t>(((a[g] >> (8 * k)) & 0xffu) >=
                                    (b & 0xffu)) << (8 * k + 7);
      }
"""
STAGE_STORE = "      tile[f * pitch + r] = static_cast<TileT>(load.val[u]);"
STAGE_TAIL = ("    tile[(i - r * n_feat) * pitch + r] = "
              "static_cast<TileT>(src[i]);")
ZERO_ROW = """  for (int i = threadIdx.x; i < pitch; i += blockDim.x) {
    tile[n_feat * pitch + i] = 0;
  }"""
ROWS_ZERO = """  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    tile[i * (n_feat + 1) + n_feat] = 0;
  }"""
FSTEP = "  const int fstep = kStaged ? pitch : 1;"
FETCH = ("    if (kStaged) return *reinterpret_cast<const uint32_t*>"
         "(base + at + r);")
ROWS_FETCH = """    if (kStaged) {
      uint32_t w = 0u;
#pragma unroll
      for (int k = 0; k < kGroupRows; ++k) {
        w |= static_cast<uint32_t>(base[(r + k) * (n_feat + 1) + at])
             << (8 * k);
      }
      return w;
    }"""
STORE = """          dst[static_cast<long long>(g * kGroupRows + k) * n_trees] =
              static_cast<int32_t>(W::bits(acc, g, k));"""
LEVELS = (("      if (d < depth) {\n        level<kStaged, G>(",
           "      if (d < 0) {\n        level<kStaged, G>("),
          ("    for (int d = 8; d < depth; ++d) {",
           "    for (int d = 8; d < 0; ++d) {"))
WEIGHTS_LOAD = """  // dm's level weights, read now and checked once the rows are staged
  float weight[kMaxDepth];
#pragma unroll
  for (int d = 0; d < kMaxDepth; ++d) {
    weight[d] = kWeights && d < depth ? __ldg(pow2 + d) : 0.f;
  }"""
WEIGHTS_CHECK = """  bool plain = true;
  if (kWeights) {
#pragma unroll
    for (int d = 0; d < kMaxDepth; ++d) {
      if (d < depth) plain &= __float2int_rz(weight[d]) == (1 << d);
    }
  }"""
VARIANTS = {
    "full": (),
    "bytes": ((STEP, BYTES_STEP),),
    "rows": ((STAGE_STORE, "      tile[r * (n_feat + 1) + f] = "
                           "static_cast<TileT>(load.val[u]);"),
             (STAGE_TAIL, "    tile[r * (n_feat + 1) + i - r * n_feat] = "
                          "static_cast<TileT>(src[i]);"),
             (ZERO_ROW, ROWS_ZERO), (FSTEP, "  const int fstep = 1;"),
             (FETCH, ROWS_FETCH)),
    "no_store": ((STORE, "          if (W::bits(acc, g, k) == "
                         "static_cast<uint32_t>(depth) << 20) "
                         + STORE[10:]),),
    "store_only": LEVELS,
    "no_cap": (("__launch_bounds__(kIndexWarps * 32, kMinBlocks)",
                "__launch_bounds__(kIndexWarps * 32)"),),
    "six_blocks": (("constexpr int kMinBlocks = 4;",
                    "constexpr int kMinBlocks = 6;"),),
    # dm's weights checked before the rows are staged (a trip of its own)
    "weights_first": (
        (WEIGHTS_LOAD, WEIGHTS_LOAD + "\n" + WEIGHTS_CHECK.replace(
            "weight[d]", "__ldg(pow2 + d)")),
        (WEIGHTS_CHECK, "")),
    # dm's weights checked at the first round's barrier, one a thread
    "weights_at_barrier": (
        (WEIGHTS_LOAD, "  const float weight = kWeights && tid < depth ? "
                       "__ldg(pow2 + tid) : 0.f;"),
        (WEIGHTS_CHECK, "  bool plain = true;"),
        ("    __syncthreads();  // the rows are staged and the round's pairs"
         " too",
         "    if (kWeights && round == first) {\n"
         "      plain = __syncthreads_and(tid >= depth ||\n"
         "          __float2int_rz(weight) == (1 << tid));\n"
         "    } else {\n      __syncthreads();\n    }")),
}
# the variants timed on uint8 bins only (rows breaks the int32 walk)
UINT8_ONLY = ("bytes", "rows", "no_store", "store_only", "no_cap",
              "six_blocks", "weights_first",
              "weights_at_barrier")
# bins each shape is timed on: int32 whose values fit a byte (the depth
# groups' and the staged route's, narrowed to a uint8 tile), and at the
# bulk shape int32 past 255 (the int32 walk)
KINDS = {"group": ("uint8", "int32"), "single": ("uint8", "int32"),
         "bucket": ("uint8", "int32"),
         "bulk": ("uint8", "int32", "int32_wide")}
N_FEATURES, N_BINS = 54, 64
SHAPES = {            # rows, trees, depth
    "group": (1024, 12, 5),
    "single": (16, 1000, 8),
    "bucket": (1024, 1000, 8),
    "bulk": (139_440, 1000, 8),
}


def build(name: str, csrc: pathlib.Path, out: pathlib.Path, nvcc: str,
          flags, patches) -> tuple[ctypes.CDLL, str]:
    work = out / name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    for f in SOURCES:
        shutil.copy(csrc / f, work / f)
    header = (work / "leaf_index.cuh").read_text()
    for old, new in patches:
        if old not in header:
            sys.exit(f"leaf_index_probe: the {name} patch no longer matches "
                     "csrc/leaf_index.cuh")
        header = header.replace(old, new)
    (work / "leaf_index.cuh").write_text(header)
    lib = work / f"libprobe_{name}.so"
    jobs = {src: subprocess.Popen(
        [nvcc, *flags, "-c", str(work / src), "-o", str(work / (src + ".o"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in ("leaf_index.cu", "leaf_index_dm.cu", "runtime.cu")}
    objs, log = [], []
    for src, proc in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"leaf_index_probe: nvcc failed on {name}/{src}:\n"
                     f"{text}")
        log.append(text)
        objs.append(str(work / (src + ".o")))
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-o", str(lib), *objs], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib)), "\n".join(log)


def ptxas(log: str) -> list[dict]:
    """Registers and spills of each compiled kernel in a build log."""
    found = []
    for entry in log.split("Compiling entry function '")[1:]:
        name = entry.split("'")[0]
        regs = re.search(r"Used (\d+) registers", entry)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", entry)
        if regs and spills:
            found.append({"kernel": name, "registers": int(regs.group(1)),
                          "spill_stores": int(spills.group(1)),
                          "spill_loads": int(spills.group(2))})
    return found


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--check-only", action="store_true")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("leaf_index_probe: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ref, tuning
    nvcc = _build.nvcc_path()
    out_dir = _build.BUILD_DIR.parent / "leaf_index_probe"
    flags = _build.COMPILE_FLAGS
    builds = {name: (_build.CSRC, patches)
              for name, patches in VARIANTS.items()}
    parent_rows = None
    if args.parent:
        parent = pathlib.Path(args.parent).resolve()
        builds["parent"] = (parent / "src/repro_torch/kernels/csrc", ())
    with ThreadPoolExecutor(len(builds)) as pool:
        built = dict(zip(builds, pool.map(
            lambda item: build(item[0], item[1][0], out_dir, nvcc, flags,
                               item[1][1]), builds.items())))
    libs = {name: dll for name, (dll, _) in built.items()}
    report = {name: ptxas(log) for name, (_, log) in built.items()}
    if args.parent:
        spec = importlib.util.spec_from_file_location(
            "parent_tuning", parent / "src/repro_torch/kernels/tuning.py")
        parent_tuning = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = parent_tuning    # for its dataclasses
        spec.loader.exec_module(parent_tuning)
        parent_rows = parent_tuning.tile_rows
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, dll in libs.items():
        extra = 0 if name == "parent" else 2
        dll.repro_leaf_index.argtypes = [P] * 4 + [L] + [I] * (6 + extra) \
            + [I, P]
        dll.repro_leaf_index_dm.argtypes = [P] * 5 + [L] \
            + [I] * (6 + extra) + [I, P]
        dll.repro_leaf_index.restype = I
        dll.repro_leaf_index_dm.restype = I
    for name, kernels in report.items():
        print(json.dumps({"variant": name, "ptxas": kernels}), flush=True)

    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    bins_all = torch.as_tensor(
        rng.integers(0, N_BINS, (SHAPES["bulk"][0], N_FEATURES))
        .astype(np.uint8), device=dev)

    def call(name, layout, bins, sf, sb, pow2, out, rows=None):
        """One launch of variant `name` through the soa or dm launcher."""
        dll = libs[name]
        n, f = bins.shape
        t, d = out.shape[1], sf.shape[1] if layout == "soa" else sf.shape[0]
        u8 = int(bins.dtype == torch.uint8)
        if name == "parent":
            tile = parent_rows(f, 1 if u8 else 4)
            plan_args = (tile.rows, int(tile.route == "global"))
        else:
            plan = tuning.index_plan(n, t, d, f, 1 if u8 else 4)
            r = rows or plan.tile.rows
            rounds = -(-t // tuning.INDEX_ROUND_TREES)
            groups, per = plan.n_tree_groups, plan.rounds_per_group
            if rows:     # the plan's grouping rule at this row tile
                row_tiles = -(-n // r)
                need = -(-tuning.SM_COUNT // row_tiles)
                per = 1 if need >= rounds else rounds // need
                groups = -(-rounds // per)
            plan_args = (r, int(plan.tile.route == "global"), groups, per)
        if layout == "soa":
            status = dll.repro_leaf_index(
                bins.data_ptr(), sf.data_ptr(), sb.data_ptr(),
                out.data_ptr(), n, f, t, d, u8, *plan_args, dev.index,
                stream)
        else:
            status = dll.repro_leaf_index_dm(
                bins.data_ptr(), sf.data_ptr(), sb.data_ptr(),
                pow2.data_ptr(), out.data_ptr(), n, f, t, d, u8, *plan_args,
                dev.index, stream)
        if status:
            sys.exit(f"leaf_index_probe: {name} ({layout}) launch failed "
                     f"with CUDA error {status}")

    cases = []
    for shape, (n, t, d) in SHAPES.items():
        sf = torch.as_tensor(rng.integers(0, N_FEATURES, (t, d))
                             .astype(np.int32), device=dev)
        sb = torch.as_tensor(rng.integers(1, N_BINS, (t, d))
                             .astype(np.int32), device=dev)
        pow2 = (2.0 ** torch.arange(d, device=dev, dtype=torch.float32)
                ).reshape(d, 1)
        for kind in KINDS[shape]:
            # int32_wide: the bins and thresholds moved up by 200, so every
            # block holds bins past 255 and walks int32 words
            shift = 200 if kind == "int32_wide" else 0
            bins = bins_all[:n].to(torch.uint8 if kind == "uint8"
                                   else torch.int32) + shift
            kind_sb = sb + shift
            planes = {"soa": (sf, kind_sb),
                      "dm": (sf.t().contiguous(), kind_sb.t().contiguous())}
            want = ref.leaf_index(bins, sf, kind_sb)
            out = torch.empty((n, t), dtype=torch.int32, device=dev)
            for name in libs:
                if name in ("no_store", "store_only") or (
                        kind != "uint8" and name in UINT8_ONLY):
                    continue
                for layout in ("soa", "dm"):
                    print(f"checking {name} ({layout}) at {shape}, {kind}",
                          file=sys.stderr, flush=True)
                    out.fill_(-1)
                    call(name, layout, bins, *planes[layout], pow2, out)
                    torch.cuda.synchronize()
                    if not torch.equal(out, want):
                        sys.exit(f"leaf_index_probe: {name} ({layout}) "
                                 f"differs from ref.leaf_index at {shape}, "
                                 f"{kind}")
            cases.append((shape, kind, bins, planes, pow2, out))
    print(json.dumps({"checked": [f"{c[0]} {c[1]}" for c in cases],
                      "variants": sorted(libs)}), flush=True)

    rows = []
    if not args.check_only:
        for shape, kind, bins, planes, pow2, out in cases:
            n, t, d = SHAPES[shape]
            runs = [(name, layout, None) for name in libs
                    for layout in ("soa", "dm")
                    if (layout == "soa"
                        or name in ("full", "parent", "weights_first",
                                "weights_at_barrier"))
                    and (kind == "uint8" or name not in UINT8_ONLY)]
            if kind == "uint8":
                runs += [("full", "soa", r) for r in (128,
                                                      *tuning.INDEX_ROWS)]
            times = {run: {"ms": [], "device_ms": []} for run in runs}
            for k in range(args.rounds):
                for run in (runs if k % 2 == 0 else runs[::-1]):
                    name, layout, r = run

                    def launch(name=name, layout=layout, r=r):
                        call(name, layout, bins, *planes[layout], pow2, out,
                             rows=r)
                    times[run]["ms"].append(time_ms(launch, args.reps, flush))
                    times[run]["device_ms"].append(
                        device_ms(launch, flush, key="leaf_index")[0])
            bin_bytes = bins.element_size()
            plan = tuning.index_plan(n, t, d, N_FEATURES, bin_bytes)
            for (name, layout, r), got in times.items():
                rows.append({
                    "shape": shape, "rows": n, "trees": t, "depth": d,
                    "bins": kind, "variant": name, "layout": layout,
                    "rows_per_block": r or (
                        parent_rows(N_FEATURES, bin_bytes).rows
                        if name == "parent" else plan.tile.rows),
                    "plan": None if name == "parent" or r else {
                        "rows": plan.tile.rows,
                        "tree_groups": plan.n_tree_groups,
                        "rounds_per_group": plan.rounds_per_group,
                        "blocks": plan.n_blocks},
                    **got, "out_bytes": n * t * 4,
                    "out_tb_per_s": [n * t * 4 / (ms * 1e-3) / 1e12
                                     for ms in got["device_ms"]]})
                print(json.dumps(rows[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            {"rows": rows, "ptxas": report, "card": card}))
    print(json.dumps({"card": card}))


if __name__ == "__main__":
    main()

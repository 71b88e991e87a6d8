#!/usr/bin/env python3
"""Where the time of the rowwise distance kernel (`csrc/l2sq_rowwise.cu`)
and of its one route (`KNNFeaturizer.transform(..., rowwise=True)`) goes,
on one card, at the kNN path's shape (2,808 references x 2,841 queries of
K = 512, `image_embeddings(scale=1.0)`).

    python3 scripts/l2sq_rowwise_probe.py [--parent DIR | --parent REV]
        [--rounds 3] [--reps 20] [--check-only] [--out FILE]
    python3 scripts/l2sq_rowwise_probe.py --lone SRC [--rounds 3]

Builds, each a shared library of its own under `build/l2sq_rowwise_probe/`
(the repo's kernels and their build are untouched):

  change  the kernel as it is (q in registers, a row a warp with every
          load in flight, `tuning.rowwise_plan`);
  l2_256  the change, each row load asking L2 for its 256-byte sector
          group (`ld.global.nc.L2::256B`);
  bulk    the other design tried: a block's W x R rows, contiguous in
          memory, brought into shared memory by one 1-D bulk copy
          (`cp.async.bulk` completing on an `mbarrier`), q in registers,
          the same summation order;
  parent  with `--parent`: the earlier kernel (q staged in shared memory,
          a warp a row), from DIR/src/repro_torch/kernels/csrc (an
          unpacked checkout, e.g. `git archive HEAD~1 | tar -x -C DIR`) or,
          where DIR is not a directory, from `git show REV:...`.

checks each against `ref.l2sq_rowwise_lanes` (all but parent bit for bit)
or `ref.l2sq_rowwise` (parent, within `rowwise_limit`), then times, each
time the median of CUDA events around the launch with L2 flushed
(`chip_smoke.py`'s `time_ms`) and the device time behind a spacer kernel
(`chip_smoke.py`'s `device_ms`), versions alternating round by round:

  * parent, change, l2_256 and bulk at 2,808 x 512 (the plan's R and
    warps);
  * the change at warps 1, 2, 4, 8 a block, and bulk at four tiles;
  * the floor: the change on one row, L2 flushed; parent and change with
    the refs in L2 (no flush); floor, parent and change after a flush that
    reads 256 MB instead of writing it (L2 left clean): device time only;
  * 2,841 queries back to back with the refs in L2: CUDA events around
    the raw launches (what the host can issue) and around the replay of a
    CUDA graph of them (the card's time a query);
  * the host's time a query, by stage, each a loop of 2,841 on the host
    clock: `registry.resolve`, the lone wrapper's checks
    (`check_cuda_tensors`, `_vec_ok`), `torch.empty`, the stream lookup,
    the row views, a raw ctypes launch, the lone wrapper, the wrapper with
    `batch=`, the route's per-query call (`ops.l2sq_rowwise(..., out=,
    batch=)`), the stacked lone route of the earlier code, and the whole
    `transform(rowwise=True)` (and the matrix route's) with a sync;
  * with `--parent DIR`: the lone wrapper `l2dist.l2sq_rowwise(q, refs)`
    of the parent and of the change, 2,841 calls back to back with the
    refs in L2 (CUDA events, as `chip_smoke.py`'s
    `back_to_back_ms_per_query`, and the host clock), each in a process
    of its own (`--lone SRC`: SRC the `src` directory whose `repro_torch`
    it imports), parent, change, change, parent.

`--check-only` builds, checks and prints the ptxas report, and times
nothing.  One JSON object a line; the last line is the card.  Needs one
CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import device_ms, time_ms  # noqa: E402  the smoke's timing

SUPPORT = ("common.cuh", "runtime.cu")
SWEEP_WARPS = (1, 2, 4, 8)
BULK_TILES = ((2, 1), (2, 4), (1, 8), (2, 8))     # (R, warps)
# l2_256: the change with each row load asking L2 to fetch the 256-byte
# sector group around it (`ld.global.nc.L2::256B`).
L2_LOAD = "rv[j] = __ldg(refs4 + row * k4 + (i < k4 ? i : k4 - 1));"
L2_256_LOAD = L2_LOAD.replace("__ldg(", "ldg_l2_256(")
L2_256_HELPER = r"""
__device__ __forceinline__ float4 ldg_l2_256(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}
"""
# The bulk-copy design: the change's arithmetic, its rows staged by one
# cp.async.bulk a block.
BULK_SOURCE = r"""
#include "common.cuh"
namespace {
constexpr int kChunk = 32;
constexpr long long kWaitLimitCycles = 4000000000LL;

__device__ __forceinline__ float sq_diff4(float acc, float4 r, float4 q) {
  float d = r.x - q.x;
  acc = fmaf(d, d, acc);
  d = r.y - q.y;
  acc = fmaf(d, d, acc);
  d = r.z - q.z;
  acc = fmaf(d, d, acc);
  d = r.w - q.w;
  return fmaf(d, d, acc);
}

__device__ __forceinline__ bool try_wait(uint32_t bar) {
  uint32_t done;
  asm volatile("{\n.reg .pred p;\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
               "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(bar)
               : "memory");
  return done != 0;
}

template <int R, int J>
__global__ void __launch_bounds__(256)
    l2sq_rowwise_bulk_kernel(const float4* __restrict__ q4,
                             const float4* __restrict__ refs4,
                             float* __restrict__ out, long long n_rows,
                             int k4) {
  extern __shared__ __align__(128) float4 rows_s[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float sums_s[8 * R];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * warps * R;
  const long long left = n_rows - base;
  const int rows = left < warps * R ? static_cast<int>(left) : warps * R;
  const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
  float4 qv[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = lane + kChunk * j;
    qv[j] = i < k4 ? __ldg(q4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const uint32_t bytes = static_cast<uint32_t>(rows) * k4 * 16;
    asm volatile("{\n.reg .b64 st;\n"
                 "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}"
                 ::"r"(b), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(static_cast<uint32_t>(
            __cvta_generic_to_shared(rows_s))),
        "l"(refs4 + base * k4), "r"(bytes), "r"(b) : "memory");
  }
  __syncthreads();
  if (!try_wait(b)) {
    const long long t0 = clock64();
    while (!try_wait(b))
      if (clock64() - t0 > kWaitLimitCycles) __trap();
  }
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r] = 0.f;
    const int row = warp * R + r;
    if (row < rows) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int i = lane + kChunk * j;
        if (i < k4) acc[r] = sq_diff4(acc[r], rows_s[row * k4 + i], qv[j]);
      }
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], offset);
  }
  float mine = acc[0];
#pragma unroll
  for (int r = 1; r < R; ++r) {
    if (lane == r) mine = acc[r];
  }
  if (lane < R) sums_s[warp * R + lane] = mine;
  __syncthreads();
  if (threadIdx.x < rows) out[base + threadIdx.x] = sums_s[threadIdx.x];
}

template <int R, int J>
int launch(const void* q, const void* refs, void* out, long long n, int k,
           int warps, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(warps) * R * k * 4;
  cudaError_t err = allow_shared_memory(l2sq_rowwise_bulk_kernel<R, J>,
                                        smem, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tile = static_cast<long long>(warps) * R;
  l2sq_rowwise_bulk_kernel<R, J><<<static_cast<unsigned>((n + tile - 1) /
                                                         tile),
                                   warps * 32, smem, s>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(refs),
      static_cast<float*>(out), n, k / 4);
  return launch_status();
}
}  // namespace

// K % 4 == 0, K <= 128 J, 16-byte aligned rows; R in {1, 2}, J = 4.
extern "C" int probe_bulk(const void* q, const void* refs, void* out,
                          long long n, int k, int rows, int warps,
                          int device, void* stream) {
  cudaError_t err = select_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k % 4 || k > 512) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 1) return launch<1, 4>(q, refs, out, n, k, warps, s);
  if (rows == 2) return launch<2, 4>(q, refs, out, n, k, warps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
"""


def build(name: str, sources: dict[str, str], out: pathlib.Path, nvcc: str,
          flags) -> tuple[ctypes.CDLL, str]:
    """Compile `sources` (file name -> text) into lib<name>.so."""
    work = out / name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    for fname, text in sources.items():
        (work / fname).write_text(text)
    units = [f for f in sources if f.endswith(".cu")]
    jobs = {src: subprocess.Popen(
        [nvcc, *flags, "-c", str(work / src), "-o", str(work / (src + ".o"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in units}
    objs, log = [], []
    for src, proc in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"l2sq_rowwise_probe: nvcc failed on {name}/{src}:\n"
                     f"{text}")
        log.append(text)
        objs.append(str(work / (src + ".o")))
    lib = work / f"libprobe_{name}.so"
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


def parent_sources(parent: str) -> dict[str, str]:
    """The earlier kernel's sources, from an unpacked checkout or git."""
    names = ("l2sq_rowwise.cu", *SUPPORT)
    where = pathlib.Path(parent)
    if where.is_dir():
        csrc = where / "src/repro_torch/kernels/csrc"
        return {n: (csrc / n).read_text() for n in names}
    return {n: subprocess.run(
        ["git", "-C", str(ROOT), "show",
         f"{parent}:src/repro_torch/kernels/csrc/{n}"],
        check=True, capture_output=True, text=True).stdout for n in names}


def host_us(fn, count: int) -> float:
    """Microseconds a call of `fn(i)` for i < count on the host clock; the
    card is synchronised before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(count):
        fn(i)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / count * 1e6


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", default=None)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--check-only", action="store_true")
    parser.add_argument("--out", default=None)
    parser.add_argument("--lone", default=None)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("l2sq_rowwise_probe: needs a CUDA card")
    if args.lone:
        print(json.dumps(lone_back_to_back(args.lone, args.rounds)))
        return
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.knn import KNNFeaturizer
    from repro_torch.data.synthetic import image_embeddings
    from repro_torch.kernels import _build, l2dist, ops, ref, registry, tuning
    nvcc = _build.nvcc_path()
    out_dir = _build.BUILD_DIR.parent / "l2sq_rowwise_probe"
    csrc = _build.CSRC
    support = {n: (csrc / n).read_text() for n in SUPPORT}
    change_src = (csrc / "l2sq_rowwise.cu").read_text()
    if L2_LOAD not in change_src:
        sys.exit("l2sq_rowwise_probe: the l2_256 patch no longer matches "
                 "csrc/l2sq_rowwise.cu")
    builds = {"change": {"l2sq_rowwise.cu": change_src, **support},
              "l2_256": {"l2sq_rowwise.cu": change_src.replace(
                  L2_LOAD, L2_256_LOAD).replace(
                  "namespace {\n", "namespace {\n" + L2_256_HELPER, 1),
                  **support},
              "bulk": {"bulk.cu": BULK_SOURCE, **support}}
    if args.parent:
        builds["parent"] = parent_sources(args.parent)
    with ThreadPoolExecutor(len(builds)) as pool:
        built = dict(zip(builds, pool.map(
            lambda item: build(item[0], item[1], out_dir, nvcc,
                               _build.COMPILE_FLAGS), builds.items())))
    libs = {name: dll for name, (dll, _) in built.items()}
    for name, (_, log) in built.items():
        print(json.dumps({"variant": name, "ptxas": ptxas(log)}), flush=True)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("change", "l2_256"):
        libs[name].repro_l2sq_rowwise.argtypes = [P] * 3 + [L] + [I] * 5 \
            + [I, P]
    libs["bulk"].probe_bulk.argtypes = [P] * 3 + [L] + [I] * 3 + [I, P]
    if "parent" in libs:
        libs["parent"].repro_l2sq_rowwise.argtypes = [P] * 3 + [L] + [I] * 2 \
            + [I, P]
    for dll in libs.values():
        for fn in ("repro_l2sq_rowwise", "probe_bulk"):
            if hasattr(dll, fn):
                getattr(dll, fn).restype = I

    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    data = image_embeddings(scale=1.0)
    refs = torch.as_tensor(data.emb_train, device=dev).contiguous()
    queries = torch.as_tensor(data.emb_test, device=dev).contiguous()
    n, k = refs.shape
    q0 = queries[0]
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    plan = tuning.rowwise_plan(n, k)

    def launcher(name, rows=None, warps=None):
        """One raw launch of `name` for query row i (a closure on i);
        `rows` a warp for bulk only."""
        ptr_r, ptr_o = refs.data_ptr(), out.data_ptr()
        if name in ("change", "l2_256"):
            p = plan if warps is None else tuning.RowwisePlan(
                plan.route, plan.chunks, warps, -(-n // warps))
            fn, tail = libs[name].repro_l2sq_rowwise, (n, k, *p.launch_args)
        elif name == "bulk":
            fn = libs[name].probe_bulk
            tail = (n, k, rows or 2, warps or 1)
        else:
            fn, tail = libs[name].repro_l2sq_rowwise, (n, k, 1)
        q_ptrs = [q.data_ptr() for q in queries]

        def call(i=0):
            status = fn(q_ptrs[i], ptr_r, ptr_o, *tail, dev.index, stream)
            if status:
                sys.exit(f"l2sq_rowwise_probe: {name} launch failed with "
                         f"CUDA error {status}")
        return call

    # --- checks: every version on q0 and a few more queries
    runs = [("change", None, None), ("parent", None, None),
            ("l2_256", None, None)] + [
        ("change", None, w) for w in SWEEP_WARPS] + [
        ("bulk", r, w) for r, w in BULK_TILES]
    runs = [r for r in runs if r[0] in libs]
    checked = []
    for i in (0, 1, len(queries) - 1):
        lanes = ref.l2sq_rowwise_lanes(queries[i], refs)
        plain = ref.l2sq_rowwise(queries[i], refs)
        limit = l2dist.rowwise_limit(queries[i], refs)
        for name, r, w in runs:
            out.fill_(float("nan"))
            launcher(name, r, w)(i)
            torch.cuda.synchronize()
            if name == "parent":
                ok = bool(((out.double() - plain.double()).abs()
                           <= limit).all())
            else:
                ok = torch.equal(out, lanes)
            if not ok:
                sys.exit(f"l2sq_rowwise_probe: {name} (R={r}, warps={w}) "
                         f"differs on query {i}")
            checked.append(f"{name} R={r} W={w} q{i}")
    print(json.dumps({"checked": len(checked), "plan": plan.__dict__}),
          flush=True)

    rows = []
    if not args.check_only:
        times = {run: {"ms": [], "device_ms": []} for run in runs}
        for rnd in range(args.rounds):
            for run in (runs if rnd % 2 == 0 else runs[::-1]):
                fn = launcher(*run)
                times[run]["ms"].append(time_ms(fn, args.reps, flush))
                times[run]["device_ms"].append(
                    device_ms(fn, flush, key="l2sq")[0])
        for (name, r, w), got in times.items():
            rows.append({"what": "flushed", "variant": name,
                         "rows_per_warp": r, "warps": w, **got,
                         "gb_per_s": [n * k * 4 / (ms * 1e-3) / 1e9
                                      for ms in got["device_ms"]]})
            print(json.dumps(rows[-1]), flush=True)

        # --- the floor of a flushed launch (one row: no bytes to speak
        # of), and the parent and change with the refs left in L2
        no_flush = torch.empty(1, dtype=torch.uint8, device=dev)
        one_row = libs["change"].repro_l2sq_rowwise
        one_plan = tuning.rowwise_plan(1, k)

        def floor():
            one_row(q0.data_ptr(), refs.data_ptr(), out.data_ptr(), 1, k,
                    *one_plan.launch_args, dev.index, stream)
        clean = ReadFlush(flush)
        extra = {("floor", "flushed"): (floor, flush),
                 ("floor", "flushed_clean"): (floor, clean)}
        for name in [v for v in ("parent", "change") if v in libs]:
            extra[(name, "in_l2")] = (launcher(name), no_flush)
            extra[(name, "flushed_clean")] = (launcher(name), clean)
        got = {key: [] for key in extra}
        for rnd in range(args.rounds):
            for key, (fn, fl) in extra.items():
                got[key].append(device_ms(fn, fl, key="l2sq")[0])
        for (name, where), times_ in got.items():
            rows.append({"what": where, "variant": name,
                         "device_ms": times_})
            print(json.dumps(rows[-1]), flush=True)

        # --- back to back, refs in L2: the host's issue rate, and the
        # card's time a query from a CUDA graph of the same launches
        q_count = len(queries)
        for name in [v for v in ("parent", "change") if v in libs]:
            fn = launcher(name)
            got = {"what": "back_to_back", "variant": name,
                   "queries": q_count, "events_ms_per_query": [],
                   "graph_ms_per_query": []}
            for _ in range(args.rounds):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for i in range(q_count):
                    fn(i)
                end.record()
                end.synchronize()
                got["events_ms_per_query"].append(
                    start.elapsed_time(end) / q_count)
            try:
                graph = torch.cuda.CUDAGraph()
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    captured = launcher_on(libs, name, side, refs, out,
                                           queries, plan, n, k, dev)
                    with torch.cuda.graph(graph, stream=side):
                        for i in range(q_count):
                            captured(i)
                torch.cuda.current_stream().wait_stream(side)
                for _ in range(args.rounds):
                    graph.replay()
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    graph.replay()
                    end.record()
                    end.synchronize()
                    got["graph_ms_per_query"].append(
                        start.elapsed_time(end) / q_count)
                del graph
            except RuntimeError as err:   # a graph is a measurement aid
                got["graph_error"] = str(err)
            rows.append(got)
            print(json.dumps(got), flush=True)

        # --- the host's time a query, by stage
        run = l2dist.rowwise_batch(queries, refs)
        dists = torch.empty((q_count, n), dtype=torch.float32, device=dev)
        raw = launcher("change")
        stages = {
            "resolve": lambda i: registry.resolve(
                "l2sq", "auto", device=queries.device, dtype="float32"),
            "lone_checks": lambda i: (_build.check_cuda_tensors(
                "l2sq_rowwise", q=(queries[i], torch.float32),
                refs=(refs, torch.float32)),
                l2dist._vec_ok(k, queries[i], refs)),
            "empty": lambda i: torch.empty((n,), dtype=torch.float32,
                                           device=dev),
            "stream": lambda i: torch.cuda.current_stream(dev).cuda_stream,
            "views": lambda i: (queries[i], dists[i]),
            "raw_launch": raw,
            "lone_wrapper": lambda i: l2dist.l2sq_rowwise(queries[i], refs),
            "batch_wrapper": lambda i: l2dist.l2sq_rowwise(
                queries[i], refs, out=dists[i], batch=run),
            "route_call": lambda i: ops.l2sq_rowwise(
                queries[i], refs, out=dists[i], batch=run),
            "lone_route_call": lambda i: ops.l2sq_rowwise(queries[i], refs),
        }
        host = {name: [] for name in stages}
        host["stacked_lone_route"] = []
        for _ in range(args.rounds):
            for name, fn in stages.items():
                host[name].append(host_us(fn, q_count))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.stack([ops.l2sq_rowwise(q, refs) for q in queries])
            torch.cuda.synchronize()
            host["stacked_lone_route"].append(
                (time.perf_counter() - t0) / q_count * 1e6)
        feat = KNNFeaturizer(data.emb_train, data.y_train, data.n_classes,
                             k=16, device="cuda")
        seconds = {"rowwise": [], "matrix": []}
        for _ in range(args.rounds):
            for route in seconds:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                feat.transform(data.emb_test, rowwise=route == "rowwise")
                torch.cuda.synchronize()
                seconds[route].append(time.perf_counter() - t0)
        rows.append({"what": "host_us_per_query", "queries": q_count,
                     **host})
        print(json.dumps(rows[-1]), flush=True)
        rows.append({"what": "transform_seconds", **seconds})
        print(json.dumps(rows[-1]), flush=True)
        if args.parent and pathlib.Path(args.parent).is_dir():
            del flush, dists, run
            torch.cuda.empty_cache()
            srcs = {"parent": pathlib.Path(args.parent).resolve() / "src",
                    "change": ROOT / "src"}
            for name in ("parent", "change", "change", "parent"):
                got = subprocess.run(
                    [sys.executable, __file__, "--lone", str(srcs[name]),
                     "--rounds", str(args.rounds)], check=True,
                    capture_output=True, text=True).stdout
                rows.append({"what": "lone_back_to_back", "variant": name,
                             **json.loads(got.splitlines()[-1])})
                print(json.dumps(rows[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            {"rows": rows, "card": card,
             "ptxas": {k: ptxas(v[1]) for k, v in built.items()}}))
    print(json.dumps({"card": card}))


def lone_back_to_back(src: str, rounds: int) -> dict:
    """The lone wrapper of the `repro_torch` under `src`, 2,841 test
    queries back to back against the train split (refs in L2): CUDA events
    around the loop and the host clock, ms a query, `rounds` times; then
    again (`after_*`) after the GPU work of `chip_smoke.py`'s bit-for-bit
    check of every test query, which precedes its lone loop (the
    differences of 64 queries against the refs at a time, 368 MB each,
    then `torch.cuda.empty_cache()`), plain PyTorch the same for both;
    then the host time of each stage of a lone call (`stages_us`)."""
    import torch
    sys.path.insert(0, src)
    from repro_torch.data.synthetic import image_embeddings
    from repro_torch.kernels import l2dist
    data = image_embeddings(scale=1.0)
    dev = torch.device("cuda", torch.cuda.current_device())
    refs = torch.as_tensor(data.emb_train, device=dev).contiguous()
    queries = torch.as_tensor(data.emb_test, device=dev).contiguous()
    rows = [queries[i] for i in range(len(queries))]
    for q in rows[:32]:                 # builds the library, warms up
        l2dist.l2sq_rowwise(q, refs)
    got = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for phase in ("", "after_"):
        if phase:
            for i in range(0, len(queries), 64):
                d = refs - queries[i:i + 64, None, :]
                (d * d).sum(dim=-1)
            del d
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        events, host = [], []
        for _ in range(rounds):
            torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
            for q in rows:
                l2dist.l2sq_rowwise(q, refs)
            t1 = time.perf_counter()
            end.record()
            end.synchronize()
            events.append(start.elapsed_time(end) / len(rows))
            host.append((t1 - t0) * 1e3 / len(rows))
        got[phase + "events_ms_per_query"] = events
        got[phase + "host_ms_per_query"] = host
    # where a lone call's host time goes (µs a call, the fastest of
    # `rounds` loops over the test queries): the whole wrapper, the shared
    # checks, the output's allocation, the stream lookup, the launch helper
    # with this version's arguments, and its C launcher called directly
    from repro_torch.kernels import _build
    n, k = refs.shape
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if hasattr(l2dist, "_rowwise_launch"):
        tail = l2dist._rowwise_launch(n, k, l2dist._vec_ok(k, queries,
                                                            refs))[1]
    else:                               # the parent: n, k, float4 flag
        tail = (n, k, int(l2dist._vec_ok(k, refs)))
    fn = _build.library().repro_l2sq_rowwise
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr_r, ptr_o = refs.data_ptr(), out.data_ptr()
    q_ptrs = [q.data_ptr() for q in rows]
    stages = {
        "wrapper": lambda i: l2dist.l2sq_rowwise(rows[i], refs),
        "checks": lambda i: _build.check_cuda_tensors(
            "l2sq_rowwise", q=(rows[i], torch.float32),
            refs=(refs, torch.float32)),
        "empty": lambda i: torch.empty((n,), dtype=torch.float32,
                                       device=dev),
        "stream": lambda i: torch.cuda.current_stream(dev).cuda_stream,
        "launch": lambda i: _build.launch("repro_l2sq_rowwise", dev,
                                          rows[i], refs, out, *tail),
        "raw": lambda i: fn(q_ptrs[i], ptr_r, ptr_o, *tail, dev.index,
                            stream),
    }
    got["stages_us"] = {name: min(host_us(f, len(rows))
                                  for _ in range(rounds))
                        for name, f in stages.items()}
    got["module"] = l2dist.__file__
    return got


class ReadFlush:
    """A flush that reads the buffer instead of writing it: L2 is left
    holding clean lines, so the timed call's misses evict nothing that
    must be written back.  `zero_` is the name `device_ms` calls."""

    def __init__(self, buf):
        self.buf = buf

    def zero_(self):
        self.buf.amax()


def launcher_on(libs, name, stream, refs, out, queries, plan, n, k, dev):
    """A raw launcher of `name` on `stream` (for a graph's capture)."""
    fn = libs[name].repro_l2sq_rowwise
    tail = (n, k, *plan.launch_args) if name == "change" else (n, k, 1)
    ptr_r, ptr_o, s = refs.data_ptr(), out.data_ptr(), stream.cuda_stream
    q_ptrs = [q.data_ptr() for q in queries]

    def call(i):
        if fn(q_ptrs[i], ptr_r, ptr_o, *tail, dev.index, s):
            raise RuntimeError(f"{name} launch failed during capture")
    return call


if __name__ == "__main__":
    main()

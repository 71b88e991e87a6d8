#!/usr/bin/env python3
"""What bounds the distance-matrix product kernel: its TMA stream or its
tensor cores.

    python3 scripts/l2sq_matrix_probe.py [--rounds 3]
        [--out build/l2sq_probe.json]

Builds five copies of `src/repro_torch/kernels/csrc/l2sq_matrix.cu` into
`build/l2sq_matrix_probe/` (the repo's kernels and their build are
untouched), each a shared library of its own:

  full      the kernel as it is;
  loads     the consumers wait for each stage and release it, but issue
            no wgmma: the TMA stream from L2 (or HBM) alone;
  compute   the producer loads the first ring of stages only, then marks
            each later stage full without a copy: the wgmma work, the
            promotion adds and the epilogue on stale stages, with no
            traffic in the main loop;
  mainloop  compute without the epilogue: the sums are added up and
            stored only if they come to 12345;
  direct    the kernel with each thread storing its fragment, the
            epilogue the kernel keeps for N % 4 != 0, in place of the
            TMA store through shared memory.

and times the product kernel of each on the same split (made by the
repo's split pass) at `chip_smoke.py`'s two shapes: the test split of
`image_embeddings(scale=1.0, seed=4)` against its train split, and 4,096
queries of `scale=8` against its 22,464 references.  Median CUDA-event
times with L2 flushed (`chip_smoke.py`'s `time_ms`), variants alternated
round by round; beside them the bytes the ring moves (a 64 KB stage for
each 32 K values of each tile) and the rate that makes.
One JSON object a line; the last line is the card.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys


ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import time_ms  # noqa: E402  the smoke's event timing

CONSUMER = """      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKBlock / 8; ++kk) {
        const uint32_t off = kk * 32;  // 8 fp32 along the swizzle row
        wgmma_tf32(part, smem_desc(a_hi + off), smem_desc(b_hi + off),
                   kk > 0);  // the stage's first product overwrites
        wgmma_tf32(part, smem_desc(a_hi + off), smem_desc(b_lo + off), 1);
        wgmma_tf32(part, smem_desc(a_lo + off), smem_desc(b_hi + off), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
"""
PRODUCER = """        mbar_expect_tx(full + 8 * s, kStage);
        tma_load(stage, &a_map, full + 8 * s, kb * kKBlock, m0);
        tma_load(stage + kABytes, &b_map, full + 8 * s, kb * kKBlock, n0);
"""
NO_LOADS = (PRODUCER, "        if (kb >= stages) {\n"
            "          mbar_arrive(full + 8 * s);\n"
            "          continue;\n"
            "        }\n" + PRODUCER)
EPILOGUE = "    if (tma_out) {\n"
# In place of the epilogue: the sums stay live (ptxas drops a wgmma whose
# results nothing reads), and the store almost never happens.
SINK = """    {
      float sink = 0.f;
#pragma unroll
      for (int i = 0; i < kTileN / 2; ++i) sink += acc[i];
      if (sink == 12345.f) out[0] = sink;
      return;
    }
"""
VARIANTS = {
    "full": (),
    "loads": ((CONSUMER, "      (void)a_lo; (void)b_lo;\n"),),
    "compute": (NO_LOADS,),
    "mainloop": (NO_LOADS, (EPILOGUE, SINK + EPILOGUE)),
    "direct": ((EPILOGUE, "    if (tma_out && false) {\n"),),
}


def build(name: str, csrc: pathlib.Path, out: pathlib.Path, nvcc: str,
          flags) -> ctypes.CDLL:
    work = out / name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    for f in ("l2sq_matrix.cu", "runtime.cu", "common.cuh"):
        shutil.copy(csrc / f, work / f)
    src = (work / "l2sq_matrix.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            sys.exit(f"l2sq_matrix_probe: the {name} patch no longer "
                     "matches csrc/l2sq_matrix.cu")
        src = src.replace(old, new)
    (work / "l2sq_matrix.cu").write_text(src)
    lib = work / f"libprobe_{name}.so"
    subprocess.run([nvcc, *flags, "-shared", "-o", str(lib),
                    str(work / "l2sq_matrix.cu"), str(work / "runtime.cu")],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    fn = dll.repro_l2sq_matrix
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return dll


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("l2sq_matrix_probe: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.synthetic import image_embeddings
    from repro_torch.kernels import _build, l2dist, tuning
    nvcc = _build.nvcc_path()
    out_dir = _build.BUILD_DIR.parent / "l2sq_matrix_probe"
    libs = {name: build(name, _build.CSRC, out_dir, nvcc,
                        _build.COMPILE_FLAGS) for name in VARIANTS}
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    small, bulk = image_embeddings(scale=1.0), image_embeddings(scale=8)
    shapes = {"test_split": (small.emb_test, small.emb_train),
              "bulk": (bulk.emb_test[:4096], bulk.emb_train)}
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []
    for shape, (qa, qb) in shapes.items():
        a = torch.as_tensor(qa, device=dev)
        b = torch.as_tensor(qb, device=dev)
        (m, k), n = a.shape, b.shape[0]
        plan = tuning.matrix_plan(m, n, k)
        split = l2dist.split_pass(a, b, plan.k_pad)
        out = torch.empty((m, n), device=dev)
        ptrs = [t.data_ptr() for t in (*split, out)]
        ring_bytes = plan.grid * (plan.k_pad // tuning.MATRIX_K_BLOCK) \
            * tuning.MATRIX_STAGE_BYTES
        times = {name: [] for name in VARIANTS}
        for _ in range(args.rounds):
            for name, dll in libs.items():
                def launch():
                    status = dll.repro_l2sq_matrix(
                        *ptrs, m, n, plan.k_pad, plan.stages,
                        plan.smem_bytes, dev.index, stream)
                    if status:
                        sys.exit(f"l2sq_matrix_probe: {name} launch "
                                 f"failed with CUDA error {status}")
                times[name].append(time_ms(launch, args.reps, flush))
        for name, ms in times.items():
            rows.append({
                "shape": shape, "m": m, "n": n, "k": k, "variant": name,
                "ms": ms, "ring_bytes": ring_bytes,
                "ring_tb_per_s": [ring_bytes / (t * 1e-3) / 1e12
                                  for t in ms]})
            print(json.dumps(rows[-1]), flush=True)
        del a, b, split, out
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps({"rows": rows,
                                                      "card": card}))
    print(json.dumps({"card": card}))


if __name__ == "__main__":
    main()

"""Run one cell of the benchmark of `repro_torch` on this machine's cards.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration and its traffic
mix are found by name through `BENCHMARK.json`.  With `--trace 0` the
result holds the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, read from the program's tracer and `torch.profiler` over the
window.  Every run judges what its window produced against the plain
reference (`bench/reference`); the numbers compared and their limits are
the last lines of standard error and the result's last key.  The last line
of standard output is the result, one JSON object.

Exits with 2, printing no result, where the machine has fewer CUDA cards
than the cell asks for or the program is not in the checkout, and with 3
where a module of JAX or of the JAX package was loaded.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every cache the program or a library writes stays in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    import torch

    from benchlib import harness, spec

    cell = spec.cell(args.workload, ROOT)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"the program is not in this checkout: {exc}", file=sys.stderr)
        return 2
    imported = time.perf_counter() - STARTED
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), started=STARTED)
    parts = result.pop("facts")["setup_parts"]
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                [("imports", imported),
                                 *parts.items()]), file=sys.stderr)
    loaded = harness.loaded_jax()
    if loaded:
        print(f"JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

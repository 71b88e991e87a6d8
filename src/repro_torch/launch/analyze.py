"""Kernel contract checker CLI.

    python -m repro_torch.launch.analyze             # report + artifact
    python -m repro_torch.launch.analyze --check     # exit 1 on violations
    python -m repro_torch.launch.analyze -v          # show suppressed ones

The port's counterpart of `python -m repro.launch.analyze`.  Verifies
every registry capability claim statically (`repro_torch.analysis`): it
traces the whole (op x impl x layout x bin dtype) matrix under
`FakeTensorMode`, with every aten op and kernel launch recorded, and lints
the traces for uint8 widening, the bitpacked integer pipeline, each
launch's shared memory against the opt-in limit and its tuning plan, plan
transfers and retraces, row-sharded entries and capability consistency.
Nothing is executed, launched or compiled, and no card is needed.

By default the run writes results/analysis_torch/contract-report.json,
the committed artifact `registry.format_table()`'s `verified` column
reads.  `--check --no-write` verifies without touching the tree.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import checker


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.analyze",
        description="statically verify the port's kernel registry "
                    "contracts")
    p.add_argument("--check", action="store_true",
                   help="exit 1 if any unsuppressed finding remains")
    p.add_argument("--no-write", action="store_true",
                   help="do not write the contract-report.json artifact")
    p.add_argument("--out", default=None,
                   help="artifact path (default: results/analysis_torch/"
                        "contract-report.json)")
    p.add_argument("--json", action="store_true",
                   help="print the report as JSON instead of text")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="also show suppressed findings")
    p.add_argument("--ops", default=None,
                   help="comma-separated op filter (skips the "
                        "unused-suppression check)")
    p.add_argument("--impls", default=None,
                   help="comma-separated op:impl filter")
    p.add_argument("--no-plan", action="store_true",
                   help="skip the Predictor plan-entry walk")
    p.add_argument("--no-shard", action="store_true",
                   help="skip the row-sharded entries' shard-parity pass "
                        "(a mesh of four fake cards)")
    p.add_argument("--no-tuning", action="store_true",
                   help="skip the chunk/layout tuning-model audits")
    args = p.parse_args(argv)

    result = checker.run_check(
        ops_filter=args.ops.split(",") if args.ops else None,
        impls_filter=args.impls.split(",") if args.impls else None,
        include_plan=not args.no_plan,
        include_shard=not args.no_shard,
        include_tuning=not args.no_tuning)

    if args.json:
        sys.stdout.write(result.dumps())
    else:
        print(result.format(verbose=args.verbose))

    if not args.no_write:
        path = result.save(args.out)
        if not args.json:
            print(f"wrote {path}")

    return 0 if (result.ok or not args.check) else 1


if __name__ == "__main__":
    sys.exit(main())

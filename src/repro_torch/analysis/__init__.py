"""Static contract checking for the port's kernel registry.

The port's counterpart of `src/repro/analysis/`.  Traces every (op x impl
x layout x bin dtype) capability claim of `repro_torch.kernels.registry`
abstractly, under `FakeTensorMode` with every aten op and kernel launch
recorded (nothing is computed, launched or compiled), and lints the
traces for the contracts the paper's vectorization depends on: uint8
widening discipline, the bitpacked integer pipeline, each launch's shared
memory against the opt-in limit and its tuning plan, plan-entry transfers
and retraces, row-sharded entries that keep their panels, and registry
capability consistency.  `python -m repro_torch.launch.analyze` is the CLI.
"""
from repro_torch.analysis.checker import run_check
from repro_torch.analysis.matrix import Cell, enumerate_cells
from repro_torch.analysis.report import (ContractReport, Finding, RULES,
                                         default_report_path,
                                         parse_suppressions)

__all__ = ["run_check", "Cell", "enumerate_cells", "ContractReport",
           "Finding", "RULES", "default_report_path",
           "parse_suppressions"]

"""Findings, suppressions and the contract-report artifact.

The port's counterpart of `src/repro/analysis/report.py`.  The contract
checker (`repro_torch.analysis.checker`) reduces every lint pass to a flat
list of `Finding`s.  A finding is addressed to the registry implementation
it was raised against, so declared suppressions (the
`suppressions=("rule: reason", ...)` of `registry.register`) match
mechanically: a finding whose rule its implementation suppresses is
reported as suppressed, never fatal, and a suppression that matches no
finding is itself a finding (`unused-suppression`), so stale exceptions
cannot linger.

The JSON artifact (results/analysis_torch/contract-report.json) is
committed: deterministic (no timestamps, findings sorted), so a diff shows
exactly which claims changed verdict, and a run on the card must give the
same bytes as one on the CPU (the walk is abstract).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Iterable, Optional

# The rule catalog: the JAX package's names where the meaning carries over;
# its VMEM rules are the Hopper shared-memory ones here.
RULES: dict[str, str] = {
    "widening": "uint8 bins widened to a wider dtype outside the "
                "sanctioned gather/index contract, or a launch fed "
                "widened bins",
    "int-pipeline": "bitpacked leaf-index pipeline converted an integer "
                    "value to float before the leaf gather",
    "smem-model": "the shared memory a launcher requests exceeds its "
                  "kernels.tuning plan's model (the planner would "
                  "mis-plan)",
    "smem-budget": "a launch's dynamic plus static shared memory exceeds "
                   "SMEM_OPTIN_LIMIT",
    "capability": "registry capability claim diverges from behavior "
                  "(declared combo fails to trace, or an undeclared "
                  "combo or device is not rejected by resolve)",
    "transfer": "plan entry copies between host and device beyond its "
                "own input and output, or syncs the host on a value",
    "shard-parity": "row-sharded entry moves a shard's panel off its "
                    "device, or reads the whole panel on one device",
    "retrace": "calls under one first-call key (entry, shape) with "
               "another input dtype make other launches: a plan change "
               "no compile/ count sees",
    "chunk-model": "best_chunk_rows plans a chunk whose working set "
                   "breaks CHUNK_BUDGET_BYTES or the pow2/clamp contract",
    "layout-cost": "layout_costs diverges from the bytes actually "
                   "lowered (the layout selector would mis-rank)",
    "unused-suppression": "declared suppression matched no finding",
    "trace-error": "internal: a lint pass itself failed on a trace",
}


@dataclasses.dataclass
class Finding:
    """One rule violation, addressed to a registry implementation
    (`op:impl`; plan-level findings use op="plan", impl=entry name)."""
    rule: str
    op: str
    impl: str
    layout: str = ""
    dtype: str = ""
    message: str = ""
    suppressed: bool = False

    @property
    def cell(self) -> str:
        tail = "/".join(p for p in (self.layout, self.dtype) if p)
        return f"{self.op}:{self.impl}" + (f" [{tail}]" if tail else "")

    def format(self) -> str:
        mark = "suppressed" if self.suppressed else "FAIL"
        return f"{mark:10s} {self.rule:18s} {self.cell}: {self.message}"

    def sort_key(self) -> tuple:
        return (self.op, self.impl, self.layout, self.dtype, self.rule,
                self.message)

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Finding":
        return cls(**d)


def parse_suppressions(entries: Iterable[str]) -> dict[str, str]:
    """("rule: reason", ...) -> {rule: reason}.  A bare "rule" (no colon)
    suppresses with an empty reason; an unknown rule name raises: a typo
    in a suppression must not silently disable nothing."""
    out: dict[str, str] = {}
    for entry in entries:
        rule, _, reason = entry.partition(":")
        rule = rule.strip()
        if rule not in RULES:
            raise ValueError(f"unknown suppression rule {rule!r} in "
                             f"{entry!r}; known: {sorted(RULES)}")
        out[rule] = reason.strip()
    return out


def _repo_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[3]


def default_report_path() -> pathlib.Path:
    return _repo_root() / "results" / "analysis_torch" / \
        "contract-report.json"


@dataclasses.dataclass
class ContractReport:
    """The checker's full output: findings, coverage counters and the
    per-impl verdict map the registry's `verified` column displays."""
    findings: list[Finding]
    cells: int = 0                 # capability-matrix cells enumerated
    traces: int = 0                # unique abstract traces linted
    trace_cache_hits: int = 0      # cells served from the trace cache
    kernels: int = 0               # recorded kernel launches audited
    verified: dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.findings = sorted(self.findings, key=Finding.sort_key)

    @property
    def unsuppressed(self) -> list[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> list[Finding]:
        return [f for f in self.findings if f.suppressed]

    @property
    def ok(self) -> bool:
        return not self.unsuppressed

    def to_json(self) -> dict[str, Any]:
        return {
            "schema": 1,
            "cells": self.cells,
            "traces": self.traces,
            "trace_cache_hits": self.trace_cache_hits,
            "kernels": self.kernels,
            "unsuppressed_count": len(self.unsuppressed),
            "suppressed_count": len(self.suppressed),
            "verified": dict(sorted(self.verified.items())),
            "findings": [f.to_json() for f in self.findings],
        }

    def dumps(self) -> str:
        """The artifact's bytes."""
        return json.dumps(self.to_json(), indent=2) + "\n"

    def save(self, path: Optional[pathlib.Path] = None) -> pathlib.Path:
        path = pathlib.Path(path) if path else default_report_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.dumps(), encoding="utf-8")
        return path

    @classmethod
    def load(cls, path: Optional[pathlib.Path] = None) -> "ContractReport":
        path = pathlib.Path(path) if path else default_report_path()
        d = json.loads(path.read_text(encoding="utf-8"))
        return cls(findings=[Finding.from_json(f) for f in d["findings"]],
                   cells=d.get("cells", 0), traces=d.get("traces", 0),
                   trace_cache_hits=d.get("trace_cache_hits", 0),
                   kernels=d.get("kernels", 0),
                   verified=dict(d.get("verified", {})))

    def format(self, verbose: bool = False) -> str:
        lines = [
            f"contract check: {self.cells} cells, {self.traces} traces "
            f"({self.trace_cache_hits} cache hits), "
            f"{self.kernels} kernel launches audited",
            f"findings: {len(self.unsuppressed)} unsuppressed, "
            f"{len(self.suppressed)} suppressed",
        ]
        shown = self.findings if verbose else self.unsuppressed
        lines += ["  " + f.format() for f in shown]
        if not verbose and self.suppressed:
            lines.append(f"  ({len(self.suppressed)} suppressed findings "
                         "hidden; -v shows them)")
        fails = sorted(k for k, v in self.verified.items() if v == "FAIL")
        if fails:
            lines.append("failing impls: " + ", ".join(fails))
        lines.append("RESULT: " + ("OK" if self.ok else "FAIL"))
        return "\n".join(lines)

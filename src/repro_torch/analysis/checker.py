"""The contract checker: run every pass over the capability matrix.

The port's counterpart of `src/repro/analysis/checker.py`.  `run_check()`
is the one entry point (`repro_torch.launch.analyze` is its CLI):

  1. enumerate cells from `registry.table()` and trace each abstractly
     (`matrix.trace_cell`: fake tensors, every op and launch recorded; the
     cache collapses layout-identical calls);
  2. lint every trace: widening, int-pipeline, and the shared memory of
     every recorded launch against the opt-in limit and its tuning plan;
  3. capability negatives: `resolve` must reject or re-route every
     (layout, dtype) an implementation does not claim, and refuse each
     family on the other device's data;
  4. plan walk: `Predictor.trace_entries` of staged and fused plans on
     the CPU and on a fake `cuda:0`, linted for transfers (CUDA plans)
     and retraces (float64 rows, int32 bins);
  4b. shard-parity: the row-sharded entries of a fake CUDA plan per
     layout over a mesh of four fake cards;
  5. tuning consistency: the chunk planner and the layout-cost model;
  6. apply declared suppressions, flag unused ones, and derive the
     per-impl `verified` map the registry table shows.

Filters (`ops_filter`, `impls_filter`, `include_plan`, `include_shard`,
`include_tuning`) narrow a run for tests; unused-suppression detection
runs only on an unfiltered matrix (a narrowed run cannot know a
suppression is stale).  Nothing is launched, compiled or counted: the
launch and dispatch counts and every plan's first-call counts are as they
were after a run.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.analysis import matrix, passes, trace_tools
from repro_torch.analysis.report import ContractReport, Finding, \
    parse_suppressions
from repro_torch.kernels import registry

PLAN_DEVICES = ("cpu", "cuda:0")
MESH_DEVICES = tuple(f"cuda:{i}" for i in range(4))
# The retrace lint's other input dtypes: float64 rows for the float
# entries, int32 bins for the pool entries.
RETRACE = ((("raw", "proba", "classify", "quantize"), torch.float64),
           (("raw_pool", "proba_pool", "classify_pool"), torch.int32))


def _trace_cell_findings(cell: matrix.Cell) -> tuple[list[Finding], int]:
    """All per-cell findings and the launches audited."""
    try:
        traced = matrix.trace_cell(cell)
    except Exception as e:  # a declared combo must trace: that is the claim
        return [Finding(rule="capability", op=cell.op, impl=cell.impl,
                        layout=cell.layout, dtype=cell.dtype,
                        message=f"declared combo failed to trace: "
                                f"{type(e).__name__}: {e}")], 0
    findings: list[Finding] = []
    launches = 0
    for _, trace in traced:
        findings += passes.widening_lint(cell, trace)
        findings += passes.integer_pipeline_lint(cell, trace)
        smem, n = passes.smem_audit(cell, trace)
        findings += smem
        launches += n
    return passes._unique(findings), launches


def _capability_negatives(rows: list[dict]) -> list[Finding]:
    """Every (layout, dtype) an impl does not claim must be rejected by
    `resolve`, or routed to a sibling that claims it; the universe is
    what the registry claims as a whole.  And each family refuses the
    other device: the plain versions on CUDA data, the kernels on CPU
    data."""
    out: list[Finding] = []
    all_rows = registry.table()
    universe_lay = {l for r in all_rows for l in r["layouts"].split("/")}
    universe_dt = {d for r in all_rows for d in r["dtypes"].split("/")}
    for row in rows:
        op, name = row["op"], row["impl"]
        home = "cuda" if row["devices"] == "cuda" else "cpu"
        claimed_lay = set(row["layouts"].split("/"))
        claimed_dt = set(row["dtypes"].split("/"))
        probes = [(f"layout {lay!r}", dict(layout=lay))
                  for lay in sorted(universe_lay - claimed_lay)]
        probes += [(f"dtype {dt!r}", dict(dtype=dt))
                   for dt in sorted(universe_dt - claimed_dt)]
        for what, kw in probes:
            try:
                resolved = registry.resolve(op, name, device=home, **kw)
            except (ValueError, KeyError):
                continue
            if resolved == name:
                out.append(Finding(
                    rule="capability", op=op, impl=name,
                    layout=kw.get("layout", ""), dtype=kw.get("dtype", ""),
                    message=f"resolve accepted undeclared {what} without "
                            "re-routing"))
        other = "cpu" if home == "cuda" else "cuda"
        try:
            registry.resolve(op, name, device=other)
        except (ValueError, KeyError):
            continue
        out.append(Finding(
            rule="capability", op=op, impl=name,
            message=f"resolve accepted {other} data for a {home} "
                    "implementation"))
    return out


def fake_cuda_plan(ensemble, mode, device: str = "cuda:0", **config):
    """A plan of the `cuda` family on a fake `device` (no card needed):
    the model lowered on the CPU, then moved under `mode`.  Its entries
    run only under `mode` (`Predictor.trace_entries` finds it)."""
    from repro_torch.core import layout as layout_mod
    from repro_torch.core.predictor import PredictConfig, Predictor

    dev = torch.device(device)
    cfg = PredictConfig(backend="cuda", **config).resolve(ensemble, dev)
    lowered = layout_mod.lower(
        ensemble, cfg.layout,
        tree_block=cfg.tree_block if cfg.strategy == "staged" else 0)
    plan = Predictor(ensemble, cfg, lowered, dev)   # fingerprint on the CPU
    with trace_tools.cardless_devices(), mode:
        plan.ensemble = ensemble.to(dev)
        plan.lowered = layout_mod.to_device(lowered, dev)
        plan._replicas = {dev: plan.lowered}
    return plan


def _plans(ens, strategies=("staged", "fused"), **config):
    """(label, plan) for each device of PLAN_DEVICES and strategy."""
    from repro_torch.core.predictor import Predictor
    out = []
    mode = trace_tools.new_fake_mode()
    for device in PLAN_DEVICES:
        for strategy in strategies:
            if device == "cpu":
                plan = Predictor.build(ens, device="cpu", strategy=strategy,
                                       **config)
            else:
                plan = fake_cuda_plan(ens, mode, device, strategy=strategy,
                                      **config)
            out.append((f"{device}:{strategy}", plan))
    return out


def _plan_findings(batch_sizes: Sequence[int]) -> list[Finding]:
    """Walk a canonical plan's entries per device and strategy and lint
    each trace; also assert that the walk counted no first call."""
    ens, _ = matrix.canonical_ensemble()
    out: list[Finding] = []
    for label, plan in _plans(ens):
        entries = plan.trace_entries(batch_sizes=batch_sizes)
        on_card = plan.device.type == "cuda"
        for name, trace in entries.items():
            out += passes.entry_findings(f"{label}:{name}", trace,
                                         on_card=on_card)
        for names, alt_dtype in RETRACE:
            names = [n for n in names if f"{n}@{batch_sizes[0]}" in entries]
            alt = plan.trace_entries(batch_sizes=batch_sizes,
                                     entries=names, input_dtype=alt_dtype)
            for key in (f"{n}@{b}" for n in names for b in batch_sizes):
                out += passes.retrace_findings(
                    f"{label}:{key}", entries[key], alt.get(key),
                    trace_tools.dtype_name(alt_dtype))
        if plan.stats["total_traces"]:
            out.append(Finding(
                rule="trace-error", op="plan", impl=label,
                message=f"trace_entries counted first calls "
                        f"{plan.stats['traces']}: the walk must stay "
                        "abstract"))
    return out


def shard_parity_findings(batch_sizes: Sequence[int] = (8,)
                          ) -> list[Finding]:
    """The row-sharded entries of a fake CUDA plan per layout over a mesh
    of four fake cards (`make_mesh((4,), ("data",), devices=cuda:0..3)`),
    linted for shard-parity."""
    from repro_torch.distributed.mesh import make_mesh

    ens, _ = matrix.canonical_ensemble()
    mesh = make_mesh((len(MESH_DEVICES),), ("data",),
                     devices=[torch.device(d) for d in MESH_DEVICES])
    mode = trace_tools.new_fake_mode()
    plans = [(lay, fake_cuda_plan(ens, mode, strategy="staged", layout=lay))
             for lay in ("soa", "depth_major", "depth_grouped",
                         "bitpacked")]
    return passes.shard_findings(plans, mesh, batch_sizes)


def _apply_suppressions(findings: list[Finding], rows: list[dict],
                        check_unused: bool) -> list[Finding]:
    """Mark findings covered by declared suppressions; append
    unused-suppression findings for stale declarations."""
    declared = {}
    for row in rows:
        if row["suppressions"]:
            declared[(row["op"], row["impl"])] = parse_suppressions(
                row["suppressions"].split(" ; "))
    used: set[tuple] = set()
    for f in findings:
        rules = declared.get((f.op, f.impl))
        if rules is not None and f.rule in rules:
            f.suppressed = True
            used.add((f.op, f.impl, f.rule))
    if check_unused:
        for (op, name), rules in sorted(declared.items()):
            for rule, reason in sorted(rules.items()):
                if (op, name, rule) not in used:
                    findings.append(Finding(
                        rule="unused-suppression", op=op, impl=name,
                        message=f"declared suppression {rule!r} "
                                f"({reason or 'no reason'}) matched no "
                                "finding: remove it"))
    return findings


def run_check(*, ops_filter: Optional[Sequence[str]] = None,
              impls_filter: Optional[Sequence[str]] = None,
              include_plan: bool = True,
              include_shard: bool = True,
              include_tuning: bool = True,
              check_unused: Optional[bool] = None,
              batch_sizes: Sequence[int] = (8,)) -> ContractReport:
    """Run the contract check; see the module docstring."""
    ops_filter = set(ops_filter) if ops_filter is not None else None
    impls_filter = set(impls_filter) if impls_filter is not None else None
    filtered = ops_filter is not None or impls_filter is not None
    if check_unused is None:
        check_unused = not filtered

    rows = [r for r in registry.table()
            if (ops_filter is None or r["op"] in ops_filter)
            and (impls_filter is None
                 or f"{r['op']}:{r['impl']}" in impls_filter)]

    before = matrix.cache_stats()
    cells = matrix.enumerate_cells(ops_filter=ops_filter,
                                   impls_filter=impls_filter)
    findings: list[Finding] = []
    kernels = 0
    for cell in cells:
        cell_findings, n = _trace_cell_findings(cell)
        findings += cell_findings
        kernels += n

    findings += _capability_negatives(rows)
    if include_plan:
        findings += _plan_findings(batch_sizes)
    if include_shard:
        findings += shard_parity_findings(batch_sizes)
    if include_tuning:
        findings += passes.chunk_model_findings()
        findings += passes.layout_cost_findings()

    findings = _apply_suppressions(findings, rows, check_unused)

    verified: dict[str, str] = {}
    for row in rows:
        key = f"{row['op']}:{row['impl']}"
        mine = [f for f in findings
                if (f.op, f.impl) == (row["op"], row["impl"])]
        if any(not f.suppressed for f in mine):
            verified[key] = "FAIL"
        elif mine:
            verified[key] = f"ok ({len(mine)} suppressed)"
        else:
            verified[key] = "ok"

    after = matrix.cache_stats()
    return ContractReport(
        findings=findings,
        cells=len(cells),
        traces=after["misses"] - before["misses"],
        trace_cache_hits=after["hits"] - before["hits"],
        kernels=kernels,
        verified=verified)

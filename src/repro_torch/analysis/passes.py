"""The lint passes: rules applied to abstract traces.

The port's counterpart of `src/repro/analysis/passes.py`.  Every pass
takes a `matrix.Cell` (or a plan-entry name) and a `trace_tools.Trace`
and returns `report.Finding`s.  Nothing here executes traced code.

The paper's observation is that the compiler vectorizes none of
CatBoost's scalar loop: the win was engineered by hand and can rot
quietly.  The uint8 bin stream, the bitpacked integer pipeline and the
shared-memory plans are such engineered contracts, and PyTorch will run a
widened or promoted version that still returns the right values while it
quadruples the panel a kernel streams.  A lint on the trace catches that
before a benchmark has to.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.analysis import resources
from repro_torch.analysis import trace_tools as tt
from repro_torch.analysis.matrix import Cell
from repro_torch.analysis.report import Finding
from repro_torch.kernels import tuning

# Where a widened uint8 value may go: the index argument of a gather (the
# counterpart of the JAX package's dot_general/gather contract).  A gather
# indexed by a widened value reads the narrow panel; gathering from a
# widened panel, or computing with it, means the panel is resident wide.
INDEX_ARGS = {
    "index_select": (2,), "gather": (2,), "embedding": (1,),
    "index": (1,), "index_put": (1,), "index_put_": (1,),
    "_index_put_impl_": (1,), "index_add": (2,), "index_add_": (2,),
    "scatter": (2,), "scatter_": (2,), "scatter_add": (2,),
    "scatter_add_": (2,), "take": (1,), "take_along_dim": (1,),
}
SANCTIONED_SINKS = ("gather", "index_select", "embedding", "index "
                    "arguments")

# The argument of each launcher that carries the bin stream (the output
# of binarize; the scratch of a fused row route on its global route).
BINS_ARG = {"repro_binarize": 2, "repro_leaf_index": 0,
            "repro_leaf_index_dm": 0, "repro_leaf_index_bp": 0,
            "repro_histogram": 0, "repro_fused_predict": 6,
            "repro_fused_predict_dm": 7, "repro_fused_predict_bp": 6,
            "repro_split_level": 2}


def _finding(cell: Cell, rule: str, msg: str) -> Finding:
    return Finding(rule=rule, op=cell.op, impl=cell.impl,
                   layout=cell.layout, dtype=cell.dtype, message=msg)


def _unique(findings: list[Finding]) -> list[Finding]:
    """One finding per (rule, message): a loop over levels or features
    makes the same one each pass."""
    seen, out = set(), []
    for f in findings:
        if (f.rule, f.message) not in seen:
            seen.add((f.rule, f.message))
            out.append(f)
    return out


def _sanctioned(event: tt.Event, pos: Any) -> bool:
    return event.kind == "op" and pos in INDEX_ARGS.get(event.name, ())


def _converts(event: tt.Event) -> bool:
    return event.kind == "op" and event.name in ("_to_copy", "copy_")


def _source(event: tt.Event) -> Optional[int]:
    want = tt.moved_source(event)
    return next((v for p, v in event.inputs if p == want), None)


# --------------------------------------------------------------------------
# Pass 1a: uint8 widening discipline
# --------------------------------------------------------------------------
def widening_lint(cell: Cell, trace: tt.Trace) -> list[Finding]:
    """Flag uint8 values widened outside the gather/index contract.

    For every conversion (`_to_copy`, `copy_`) of a uint8 value to a wider
    dtype, the widened value's terminal consumers (through view and move
    ops) must all take it as an index.  Any other consumer (a compare, an
    add, a launch) means a widened panel is live element by element: the
    histogram bug the lint exists for (uint8 pool bins promoted to an
    int32 segment-id panel).  On the `cuda` family every recorded launch
    must also still get uint8 bins."""
    if cell.dtype != "uint8":
        return []
    out: list[Finding] = []
    cmap = tt.consumers_map(trace)
    for e in trace.events:
        if not _converts(e) or not e.outputs:
            continue
        src_id = _source(e)
        if src_id is None:
            continue
        src, dst = trace.values[src_id], trace.values[e.outputs[0]]
        if src.dtype != torch.uint8 or dst.dtype.itemsize <= 1:
            continue
        bad = [(t, p) for t, p in tt.terminal_consumers(
                   trace, e.outputs[0], cmap) if not _sanctioned(t, p)]
        if bad:
            sinks = sorted({t.name if t.kind == "op" else
                            f"{t.kind}:{t.name}" for t, _ in bad})
            out.append(_finding(
                cell, "widening",
                f"uint8 {src.short()} widened to "
                f"{tt.dtype_name(dst.dtype)} and consumed by "
                f"{'/'.join(sinks)} (sanctioned sinks: "
                f"{'/'.join(SANCTIONED_SINKS)})"))
    for e in trace.launches():
        k = BINS_ARG.get(e.record.name)
        arg = e.record.args[k] if k is not None else None
        if arg is not None and getattr(arg, "dtype", None) != torch.uint8:
            out.append(_finding(
                cell, "widening",
                f"{e.record.name} launched with {arg} bins in a uint8 "
                "cell"))
    return _unique(out)


# --------------------------------------------------------------------------
# Pass 1b: bitpacked integer-pipeline discipline
# --------------------------------------------------------------------------
def integer_pipeline_lint(cell: Cell, trace: tt.Trace) -> list[Finding]:
    """The bitpacked layout's reason to exist is an index pipeline with no
    float excursion (the paper's vmsgeu/bit-plane loop): flag any integer
    value converted to float, by a conversion or by an op that takes an
    integer operand (not an index argument) and gives a float, in a
    bitpacked leaf_index / fused_predict trace.  bool -> float is allowed
    (a mask), and so is every op from the leaf gather on (an index
    argument, then float sums)."""
    if cell.layout != "bitpacked" \
            or cell.op not in ("leaf_index", "fused_predict"):
        return []
    out: list[Finding] = []

    def is_int(v: tt.Value) -> bool:
        return not v.dtype.is_floating_point and v.dtype != torch.bool \
            and not v.dtype.is_complex

    for e in trace.ops():
        if not e.outputs:
            continue
        dst = trace.values[e.outputs[0]]
        if not dst.dtype.is_floating_point:
            continue
        if _converts(e):
            srcs = [_source(e)]
        else:
            srcs = [v for p, v in e.inputs if not _sanctioned(e, p)]
        for vid in srcs:
            if vid is not None and is_int(trace.values[vid]):
                src = trace.values[vid]
                out.append(_finding(
                    cell, "int-pipeline",
                    f"{tt.dtype_name(src.dtype)} {src.short()} converted "
                    f"to {tt.dtype_name(dst.dtype)} by {e.name} inside "
                    "the bitpacked pipeline"))
    return _unique(out)


# --------------------------------------------------------------------------
# Pass 2: shared-memory audit of every recorded launch
# --------------------------------------------------------------------------
def smem_audit(cell: Cell, trace: tt.Trace) -> tuple[list[Finding], int]:
    """Each recorded launch's shared memory, as its launcher will request
    it from the ints it is passed (`resources.requested_smem`), against
    the opt-in limit (`smem-budget`) and against the `kernels.tuning`
    plan's model (`smem-model`, SMEM_SLACK).  Returns (findings, launches
    audited)."""
    out: list[Finding] = []
    launches = trace.launches()
    for e in launches:
        name, args = e.record.name, e.record.args
        try:
            dynamic, static = resources.requested_smem(name, args)
            model = resources.model_smem(name, args)
        except (KeyError, ValueError, IndexError, TypeError) as err:
            out.append(_finding(
                cell, "trace-error",
                f"shared-memory model of {name} failed on "
                f"{[str(a) for a in args]}: {err}"))
            continue
        total = dynamic + static
        if total > tuning.SMEM_OPTIN_LIMIT:
            out.append(_finding(
                cell, "smem-budget",
                f"{name} requests {dynamic} B dynamic + {static} B static "
                f"shared memory, past SMEM_OPTIN_LIMIT "
                f"{tuning.SMEM_OPTIN_LIMIT} B"))
        if model is not None and total > resources.SMEM_SLACK * model:
            out.append(_finding(
                cell, "smem-model",
                f"{name} requests {total} B of shared memory, "
                f"{total / max(model, 1):.2f}x its tuning plan's {model} B "
                f"(slack {resources.SMEM_SLACK}x): the planner would "
                "mis-plan this launch"))
    return _unique(out), len(launches)


def card_findings(cell: Cell, pairs) -> list[Finding]:
    """The record the card made of real launches (`resources.attribute`
    pairs): each kernel's dynamic plus static shared memory against the
    opt-in limit, and the launcher's main kernel against its plan's
    model."""
    out: list[Finding] = []
    for rec, entries in pairs:
        model = resources.model_smem(rec.name, rec.args)
        for e in entries:
            total = e["dynamic_bytes"] + e["static_bytes"]
            if total > tuning.SMEM_OPTIN_LIMIT:
                out.append(_finding(
                    cell, "smem-budget",
                    f"{e['kernel']} launched with {e['dynamic_bytes']} B "
                    f"dynamic + {e['static_bytes']} B static shared "
                    f"memory, past {tuning.SMEM_OPTIN_LIMIT} B"))
            if model is not None and \
                    total > resources.SMEM_SLACK * model:
                out.append(_finding(
                    cell, "smem-model",
                    f"{e['kernel']} launched with {total} B of shared "
                    f"memory; its tuning plan models {model} B"))
    return _unique(out)


# --------------------------------------------------------------------------
# Pass 3: plan-entry transfer / retrace lints
# --------------------------------------------------------------------------
def entry_findings(name: str, trace: tt.Trace, *,
                   on_card: bool = True) -> list[Finding]:
    """Lint one Predictor plan entry's trace (`transfer`): inside an entry
    of a CUDA plan, no copy between the host and a device other than the
    entry's own input and output, and no host sync on a value
    (`_local_scalar_dense`: `.item()`, `int(t)`, `.tolist()`)."""
    cell = Cell("plan", name, "", "")
    out: list[Finding] = []
    if not on_card:
        return out
    own = set(trace.inputs) | set(trace.outputs)
    for e in trace.ops():
        if e.name == "_local_scalar_dense":
            src = trace.values[e.inputs[0][1]]
            out.append(_finding(
                cell, "transfer",
                f"host sync on {src.short()} ({e.name}: .item() or "
                "int()) inside the entry: the host waits on the card "
                "every call"))
            continue
        if e.name not in ("_to_copy", "copy_") or not e.outputs:
            continue
        src_id = _source(e)
        if src_id is None:
            continue
        src, dst = trace.values[src_id], trace.values[e.outputs[0]]
        crosses = (src.device.type == "cpu") != (dst.device.type == "cpu")
        if crosses and not ({src_id, e.outputs[0]} & own):
            out.append(_finding(
                cell, "transfer",
                f"{src.short()} copied {src.device} -> {dst.device} "
                "inside the entry: a host<->device transfer every call"))
    return _unique(out)


def retrace_findings(name: str, base: tt.Trace,
                     alt: Optional[tt.Trace], alt_dtype: str
                     ) -> list[Finding]:
    """`retrace`: a call under the same first-call key (entry, shape) with
    input dtype `alt_dtype` must make the launches `base` makes (or be
    refused, `alt` None): a plan that changes without a compile/ count
    would run an unplanned shape."""
    if alt is None or alt.launch_signature() == base.launch_signature():
        return []
    cell = Cell("plan", name, "", "")
    return [_finding(cell, "retrace",
                     f"a {alt_dtype} input under the same (entry, shape) "
                     "key makes other launches "
                     f"({len(alt.launches())} against "
                     f"{len(base.launches())}, or other arguments): a "
                     "plan change no compile/ count sees")]


# --------------------------------------------------------------------------
# Pass 3b: row-sharded entries (shard-parity)
# --------------------------------------------------------------------------
def sharded_entry_findings(name: str, trace: tt.Trace,
                           n_shards: int) -> list[Finding]:
    """Lint one row-sharded entry's trace: each shard works on its own
    (N/k, F) panel on its own device.  Flags a copy of an (N/k, F) panel
    from a device to another that is not the entry's scatter of its own
    input (a view of it), and any op or launch that reads the whole
    (N, F) panel other than by a view.  The shards' results copied to the
    mesh's first device and summed there are the sanctioned counterpart
    of the JAX package's psum."""
    cell = Cell("plan", name, "", "")
    out: list[Finding] = []
    if not trace.inputs:
        return out
    panel = trace.values[trace.inputs[0]]
    n, rest = panel.shape[0], panel.shape[1:]
    shard = (n // n_shards,) + rest
    scatter = tt.views_of(trace, trace.inputs[0])
    for e in trace.events:
        if e.kind == "op" and e.name in tt.VIEW_OPS:
            continue
        if e.kind == "op" and e.name in ("_to_copy", "copy_") \
                and e.outputs:
            src_id = _source(e)
            src = trace.values[src_id] if src_id is not None else None
            dst = trace.values[e.outputs[0]]
            if src is not None and src.device != dst.device \
                    and src.shape == shard and src.dtype == panel.dtype \
                    and src_id not in scatter:
                out.append(_finding(
                    cell, "shard-parity",
                    f"a shard's {src.short()} panel moved {src.device} -> "
                    f"{dst.device} inside a row-sharded entry: the panel "
                    "must stay on its shard"))
                continue
        if tt.is_move(e, trace.values) and _source(e) in scatter:
            continue                  # the input placed, whole or a slice
        for pos, vid in e.inputs:
            v = trace.values[vid]
            if v.shape == panel.shape and v.dtype == panel.dtype:
                out.append(_finding(
                    cell, "shard-parity",
                    f"{e.name} reads the whole {v.short()} panel on "
                    f"{v.device} inside a row-sharded entry: a shard "
                    "reads only its rows"))
                break
    return _unique(out)


# --------------------------------------------------------------------------
# Pass 4: tuning-model consistency (chunk planner, layout selector)
# --------------------------------------------------------------------------
CHUNK_SHAPES = (  # (n_features, n_outputs, kwargs): the JAX package's
    (10, 1, {}),
    (54, 7, dict(n_borders=254, n_trees=100, n_leaves=64)),
    (784, 10, dict(n_borders=255, n_trees=500, n_leaves=64)),
    (2000, 1, dict(n_borders=255, n_trees=1000, n_leaves=64)),
)


def chunk_model_findings() -> list[Finding]:
    """`best_chunk_rows` must keep its own contract at the JAX package's
    four model shapes: pow2 rows in [MIN, MAX], the working set within
    budget unless pinned at the MIN floor, small datasets capped at the
    first covering pow2."""
    cell = Cell("tuning", "best_chunk_rows", "", "")
    out: list[Finding] = []
    for f, c, kw in CHUNK_SHAPES:
        rows = tuning.best_chunk_rows(f, c, **kw)
        per_row = tuning.chunk_row_bytes(f, c, **kw)
        desc = f"F={f} C={c} {kw or ''}".strip()
        if rows & (rows - 1) or not (tuning.MIN_CHUNK_ROWS <= rows
                                     <= tuning.MAX_CHUNK_ROWS):
            out.append(_finding(
                cell, "chunk-model",
                f"{desc}: rows={rows} not a pow2 in "
                f"[{tuning.MIN_CHUNK_ROWS}, {tuning.MAX_CHUNK_ROWS}]"))
        elif rows * per_row > tuning.CHUNK_BUDGET_BYTES \
                and rows > tuning.MIN_CHUNK_ROWS:
            out.append(_finding(
                cell, "chunk-model",
                f"{desc}: rows={rows} x {per_row} B/row = "
                f"{rows * per_row} B exceeds CHUNK_BUDGET_BYTES "
                f"{tuning.CHUNK_BUDGET_BYTES} above the MIN floor"))
        capped = tuning.best_chunk_rows(f, c, n_rows=1000, **kw)
        cover = tuning.MIN_CHUNK_ROWS
        while cover < 1000:
            cover *= 2
        if capped > max(cover, tuning.MIN_CHUNK_ROWS):
            out.append(_finding(
                cell, "chunk-model",
                f"{desc}: n_rows=1000 cap ignored (rows={capped})"))
    return out


def lowered_bytes(ens) -> dict[str, int]:
    """The bytes each layout lowers for `ens`, under `layout_costs`'
    keys.  The port's depth_major lowers no one-hot (its kernels read the
    bins at the split feature), so that key has no lowered counterpart
    and is not audited."""
    from repro_torch.core import layout as layout_mod
    lowered = {lay: layout_mod.lower(ens, lay)
               for lay in ("soa", "depth_grouped", "bitpacked")}
    return {
        "soa_leaf_bytes": lowered["soa"].leaf_table_bytes(),
        "depth_grouped_leaf_bytes":
            lowered["depth_grouped"].leaf_table_bytes(),
        "bitpacked_leaf_bytes": lowered["bitpacked"].leaf_table_bytes(),
        "bitpacked_plane_bytes": lowered["bitpacked"].plane_bytes(),
    }


def layout_cost_findings() -> list[Finding]:
    """`tuning.layout_costs` (what `best_layout` ranks on) against the
    bytes each layout lowers for the canonical mixed-depth ensemble.
    Loose bounds, the JAX package's: the model is pre-padding and the
    lowering may narrow bitpacked planes to uint8; a model off by more
    than 4x either way would mis-rank layouts."""
    from repro_torch.analysis.matrix import canonical_ensemble

    cell = Cell("tuning", "layout_costs", "", "")
    ens, true_depths = canonical_ensemble()
    costs = tuning.layout_costs(true_depths, ens.n_outputs,
                                ens.n_features)
    actual = lowered_bytes(ens)
    out: list[Finding] = []
    for key, model in costs.items():
        got = actual.get(key)
        if got is None:
            continue
        if not (model / 4 <= got <= model * 4 + 65536):
            out.append(_finding(
                cell, "layout-cost",
                f"{key}: model {model} B vs lowered {got} B: outside "
                "the 4x mis-rank bound"))
    return out


def shard_findings(plans: Sequence[tuple[str, Any]], mesh,
                   batch_sizes: Sequence[int] = (8,)) -> list[Finding]:
    """Walk the row-sharded entries of each (label, plan) over `mesh` and
    lint them; also re-assert that the walk counted no first call."""
    out: list[Finding] = []
    k = mesh.size
    sizes = [n for n in batch_sizes if n % k == 0] or [8]
    for label, plan in plans:
        traces = plan.trace_entries(
            batch_sizes=sizes, mesh=mesh,
            entries=("sharded_raw", "sharded_raw_pool"))
        for entry, trace in traces.items():
            out += sharded_entry_findings(f"{label}:{entry}", trace, k)
        if plan.stats["total_traces"]:
            out.append(Finding(
                rule="trace-error", op="plan", impl=f"{label}:sharded",
                message="the sharded walk counted a first call: it must "
                        "stay abstract"))
    return out

"""The port's contract checker (`repro_torch.analysis`): the tests of
tests/test_analysis.py on the port, and parity with the JAX package's
checker on the CPU.

The full matrix must verify clean, and each lint must fire: proven with
deliberately broken toy implementations registered (and unregistered)
around each test, one seeded fault a rule, each giving its rule and only
that rule.  The walk is abstract: fake tensors, every op and launch
recorded, nothing launched, compiled or counted.  Tests write only to
`tmp_path`."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (checker, matrix, passes,  # noqa: E402
                                  report, resources, trace_tools)
from repro_torch.analysis.trace_tools import Spec  # noqa: E402
from repro_torch.core.predictor import Predictor  # noqa: E402
from repro_torch.distributed.mesh import make_mesh  # noqa: E402
from repro_torch.kernels import _build, ops, registry, tuning  # noqa: E402
from repro_torch.launch import analyze  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARTIFACT = ROOT / "results" / "analysis_torch" / "contract-report.json"
JAX_ARTIFACT = ROOT / "results" / "analysis" / "contract-report.json"
CUDA4 = [torch.device(f"cuda:{i}") for i in range(4)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def full_run():
    """One full run from a fresh trace cache, with `_build.library`
    counting its calls and the launch and dispatch counts set beforehand:
    (report, library calls, counts before, counts after)."""
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "library", lambda: calls.append(1))
        for fn in ops.KERNELS.values():
            mp.setattr(fn, "launches", 3)
        registry.reset_call_stats({"binarize": 5})
        before = (ops.launch_counts(), registry.call_stats())
        matrix.reset_cache()
        r = checker.run_check()
        after = (ops.launch_counts(), registry.call_stats())
    registry.reset_call_stats()
    return r, calls, before, after


def _family_map(impl: str) -> str:
    """A JAX implementation's name as the port's: pallas* -> cuda*,
    ref* -> torch_ref*, the `_u8` siblings folded into their dtypes."""
    impl = impl.replace("_u8", "")
    if impl.startswith("pallas"):
        return "cuda" + impl[len("pallas"):]
    return "torch_ref" + impl[len("ref"):]


# --------------------------------------------------------------------------
# The shipped matrix verifies clean
# --------------------------------------------------------------------------
def test_full_matrix_clean(full_run):
    r = full_run[0]
    assert r.ok, "\n" + r.format(verbose=True)
    assert r.cells == 92
    assert r.kernels >= 200       # every recorded launch audited
    assert r.traces > 0
    assert r.trace_cache_hits > 0  # layout-identical calls collapse


def test_declared_suppressions_are_exercised(full_run):
    """The four shipped suppressions (the plain leaf_index, its
    depth-major sibling, the plain histogram and the plain split search)
    all match real widening findings, on uint8 cells only; depth_grouped
    is among torch_ref's."""
    sup = full_run[0].suppressed
    assert all(f.rule == "widening" and f.dtype == "uint8" for f in sup)
    assert {(f.op, f.impl) for f in sup} == {
        ("leaf_index", "torch_ref"), ("leaf_index", "torch_ref_dm"),
        ("histogram", "torch_ref"), ("split_level", "torch_ref")}
    assert "depth_grouped" in {f.layout for f in sup
                               if f.impl == "torch_ref"
                               and f.op == "leaf_index"}


def test_suppressed_set_matches_the_jax_report(full_run):
    """The JAX package's committed report's six suppressed findings
    (histogram ref uint8 x 4 layouts, leaf_index ref uint8 x soa /
    depth_grouped), under the family map, are the port's; the port has
    more, its own: the depth-major plain version compares the gathered
    bytes in int32, where the JAX package's gathers through a one-hot
    matmul (a sink its checker sanctions), and the plain split search
    (an op the JAX package does not register: its split step is plain
    jnp) compares the chosen column in int32 on every layout.  Nothing is
    unsuppressed."""
    jax_report = json.loads(JAX_ARTIFACT.read_text())
    want = {(f["rule"], f["op"], _family_map(f["impl"]), f["layout"],
             f["dtype"]) for f in jax_report["findings"] if f["suppressed"]}
    assert len(want) == 6 and jax_report["unsuppressed_count"] == 0
    r = full_run[0]
    got = {(f.rule, f.op, f.impl, f.layout, f.dtype) for f in r.suppressed}
    assert got == want | {("widening", "leaf_index", "torch_ref_dm",
                           "depth_major", "uint8")} | {
        ("widening", "split_level", "torch_ref", lay, "uint8")
        for lay in ("soa", "depth_major", "depth_grouped", "bitpacked")}
    assert not r.unsuppressed


def test_verified_map_covers_every_impl(full_run):
    r = full_run[0]
    rows = registry.table()
    assert len(rows) == 22
    assert set(r.verified) == {f"{x['op']}:{x['impl']}" for x in rows}
    for key, verdict in r.verified.items():
        assert verdict.startswith("ok"), (key, verdict)
    assert r.verified["leaf_index:torch_ref"] == "ok (2 suppressed)"
    assert r.verified["histogram:torch_ref"] == "ok (4 suppressed)"
    assert r.verified["split_level:torch_ref"] == "ok (4 suppressed)"


def test_walk_launches_and_counts_nothing(full_run):
    """The walk never loads the kernel library, leaves the launch and
    dispatch counts as they were, and leaves no recorder active."""
    _, calls, before, after = full_run
    assert calls == []
    assert before == after
    assert after[0] == {name: 3 for name in ops.KERNELS}
    assert not _build.recording()


def test_report_roundtrip_and_committed_artifact(full_run, tmp_path):
    r = full_run[0]
    path = r.save(tmp_path / "r.json")
    loaded = report.ContractReport.load(path)
    assert loaded.verified == r.verified
    assert len(loaded.findings) == len(r.findings)
    assert loaded.ok == r.ok
    again = loaded.save(tmp_path / "r2.json")
    assert again.read_bytes() == path.read_bytes()
    # the committed artifact is this run's bytes, and a second run from a
    # fresh cache gives them again
    assert path.read_bytes() == ARTIFACT.read_bytes()
    matrix.reset_cache()
    assert checker.run_check().dumps().encode() == ARTIFACT.read_bytes()


# --------------------------------------------------------------------------
# Parity with the JAX package's checker
# --------------------------------------------------------------------------
def test_cells_match_jax_under_the_family_map():
    """The port's cells are the JAX package's, under the family map, and
    the split search's: an op the JAX package does not register (its
    split step is plain jnp), on both families, both bin dtypes and every
    layout, as the histogram's."""
    from repro.analysis import matrix as jmatrix
    jax_cells = sorted((c.op, _family_map(c.impl), c.layout, c.dtype)
                       for c in jmatrix.enumerate_cells())
    port = sorted((c.op, c.impl, c.layout, c.dtype)
                  for c in matrix.enumerate_cells())
    split = [c for c in port if c[0] == "split_level"]
    assert len(port) == 92 and [c for c in port if c[0] != "split_level"] \
        == jax_cells
    assert split == sorted(("split_level", impl, lay, dt)
                           for impl, lay, dt in (
                               (c[1], c[2], c[3]) for c in jax_cells
                               if c[0] == "histogram"))


def test_canonical_ensemble_matches_jax():
    from repro.analysis import matrix as jmatrix
    ens, depths = matrix.canonical_ensemble()
    jens, jdepths = jmatrix.canonical_ensemble()
    np.testing.assert_array_equal(depths, jdepths)
    for name in ("split_features", "split_bins", "leaf_values", "borders",
                 "n_borders"):
        np.testing.assert_array_equal(getattr(ens, name).numpy(),
                                      np.asarray(getattr(jens, name)))


def test_capability_negatives_agree_with_jax():
    """For every implementation and every layout the registry knows,
    `resolve` rejects or re-routes as the JAX package's does (its `_u8`
    siblings take the same layouts); the split search, which the JAX
    package does not register, as its histogram does."""
    from repro.kernels import registry as jregistry
    layouts = sorted({lay for r in registry.table()
                      for lay in r["layouts"].split("/")})
    jnames = {(r["op"], _family_map(r["impl"])): r["impl"]
              for r in jregistry.table() if "_u8" not in r["impl"]}

    def outcome(fn, *a, **kw):
        try:
            return fn(*a, **kw)
        except (ValueError, KeyError):
            return "rejected"
    for row in registry.table():
        op, name = row["op"], row["impl"]
        home = "cuda" if row["devices"] == "cuda" else "cpu"
        jop = "histogram" if op == "split_level" else op
        jname = jnames[jop, name]
        for lay in layouts:
            got = outcome(registry.resolve, op, name, device=home,
                          layout=lay)
            want = outcome(jregistry.resolve, jop, jname, layout=lay)
            want = want if want == "rejected" else _family_map(want)
            assert got == want, (op, name, lay)
    assert not checker._capability_negatives(registry.table())


def test_tuning_audits_match_jax():
    from repro.analysis import matrix as jmatrix
    from repro.analysis import passes as jpasses
    from repro.kernels import tuning as jtuning

    def key(fs):
        return [(f.rule, f.op, f.impl, f.message) for f in fs]
    assert key(passes.chunk_model_findings()) == \
        key(jpasses.chunk_model_findings()) == []
    assert key(passes.layout_cost_findings()) == \
        key(jpasses.layout_cost_findings()) == []
    ens, depths = matrix.canonical_ensemble()
    jens, jdepths = jmatrix.canonical_ensemble()
    assert tuning.layout_costs(depths, ens.n_outputs, ens.n_features) == \
        jtuning.layout_costs(jdepths, jens.n_outputs, jens.n_features)
    # the lowered bytes the audit holds the model to
    assert passes.lowered_bytes(ens)["bitpacked_plane_bytes"] > 0


# --------------------------------------------------------------------------
# Each lint fires on its seeded fault, and only it
# --------------------------------------------------------------------------
def _narrow_check(impls, **kw):
    return checker.run_check(impls_filter=impls, include_plan=False,
                             include_shard=False, include_tuning=False,
                             **kw)


def _rules(r):
    return {f.rule for f in r.unsuppressed}


@pytest.fixture
def toy():
    """Register toy implementations; unregister them afterwards."""
    made = []

    def register(op, name, **kw):
        def deco(fn):
            registry.register(op, name, **kw)(fn)
            made.append((op, name))
            return fn
        return deco
    yield register
    for op, name in made:
        registry.unregister(op, name)


def test_widening_lint_fires_on_toy_kernel(toy):
    """A uint8 leaf_index that widens the bins panel and gathers from it
    (data, not index) must be flagged."""
    @toy("leaf_index", "torch_ref_toy_widen", dtypes=("uint8",),
         layouts=("soa",))
    def _toy(bins, sf, sb):
        wide = bins.to(torch.int32)                    # the violation
        t, d = sf.shape
        gathered = torch.index_select(wide, 1, sf.reshape(-1).long())
        go = gathered.reshape(bins.shape[0], t, d) >= sb.unsqueeze(0)
        return (go.to(torch.int32)
                << torch.arange(d, dtype=torch.int32)).sum(dim=2)

    r = _narrow_check({"leaf_index:torch_ref_toy_widen"})
    assert _rules(r) == {"widening"}, r.format(verbose=True)
    assert "index_select" in r.unsuppressed[0].message
    assert r.verified["leaf_index:torch_ref_toy_widen"] == "FAIL"


def test_int32_segment_id_histogram_widening_regression(toy):
    """The histogram widening bug in a fixture: uint8 pool bins promoted
    to an int32 segment-id panel (`leaf * n_bins + bins`) before the
    one-hot.  The lint fires on the add; the shipped CUDA histogram on
    uint8 bins stays clean."""
    @toy("histogram", "torch_ref_toy_segments", dtypes=("uint8",),
         layouts=("soa",))
    def _toy(bins_t, leaf, g, *, n_bins, n_leaves):
        seg = leaf.unsqueeze(0) * n_bins + bins_t.to(torch.int32)
        onehot = (seg.unsqueeze(2) == torch.arange(n_leaves * n_bins)
                  ).to(g.dtype)
        return torch.einsum("fns,nc->fsc", onehot, g)

    r = _narrow_check({"histogram:torch_ref_toy_segments"})
    assert _rules(r) == {"widening"}, r.format(verbose=True)
    assert "consumed by add" in r.unsuppressed[0].message
    clean = _narrow_check({"histogram:cuda"})
    assert clean.ok, clean.format(verbose=True)


def test_widening_lint_reads_the_launched_bins(toy):
    """A CUDA wrapper that widens uint8 bins before its launch: the
    widened value reaches the launch (not an index), and the launch's
    bins argument is no longer uint8."""
    from repro_torch.kernels import leaf_index as li

    @toy("leaf_index", "cuda_toy_widen", dtypes=("uint8",),
         layouts=("soa",))
    def _toy(bins, sf, sb):
        return li.leaf_index(bins.to(torch.int32), sf, sb)

    r = _narrow_check({"leaf_index:cuda_toy_widen"})
    assert _rules(r) == {"widening"}, r.format(verbose=True)
    msgs = " ".join(f.message for f in r.unsuppressed)
    assert "consumed by check:leaf_index/launch:repro_leaf_index" in msgs
    assert "repro_leaf_index launched with int32" in msgs


def test_int_pipeline_lint_fires_on_float_excursion(toy):
    """A bitpacked leaf_index that builds the index through floats (the
    matmul habit) defeats the layout's integer pipeline."""
    @toy("leaf_index", "torch_ref_bp_toy_float", dtypes=("int32",),
         layouts=("bitpacked",))
    def _toy(bins, sf_bp, sb_bp):
        d = sf_bp.shape[0]
        cols = torch.stack([torch.index_select(bins, 1, sf_bp[i].long())
                            for i in range(d)], dim=1)
        go = (cols >= sb_bp.unsqueeze(0)).to(torch.float32)
        weights = 2.0 ** torch.arange(d)             # the violation
        return (go * weights[None, :, None]).sum(dim=1).to(torch.int32)

    r = _narrow_check({"leaf_index:torch_ref_bp_toy_float"})
    assert _rules(r) == {"int-pipeline"}, r.format(verbose=True)
    assert "int64" in r.unsuppressed[0].message


def test_smem_audit_fires_on_understated_plan(toy):
    """A CUDA leaf_index whose launch asks for twice its plan's rows a
    block: the launcher's shared memory passes its tuning model (within
    the opt-in limit at every uint8 shape the card runs)."""
    from repro_torch.kernels import leaf_index as li

    @toy("leaf_index", "cuda_toy_smem", dtypes=("uint8",), layouts=("soa",))
    def _toy(bins, sf, sb):
        _build.check_cuda_tensors("leaf_index", bins=(bins, bins.dtype),
                                  split_features=(sf, torch.int32),
                                  split_bins=(sb, torch.int32))
        n, f = bins.shape
        t, d = sf.shape
        out = torch.empty((n, t), dtype=torch.int32, device=bins.device)
        plan = tuning.index_plan(n, t, d, f, 1)
        _build.launch("repro_leaf_index", bins.device, bins, sf, sb, out,
                      n, f, t, d, 1, 2 * plan.tile.rows,   # the violation
                      int(plan.tile.route == "global"), plan.n_tree_groups,
                      plan.rounds_per_group)
        return out

    r = _narrow_check({"leaf_index:cuda_toy_smem"})
    assert _rules(r) == {"smem-model"}, r.format(verbose=True)
    assert "mis-plan" in r.unsuppressed[0].message
    assert li.leaf_index.launches == ops.launch_counts()["leaf_index"]


def test_smem_budget_and_model_on_every_launch():
    """Every launch the cuda cells record stays within the opt-in limit
    and its plan's model, the global routes past the opt-in limit
    included; the request mirrors the plan exactly where the plan is the
    launcher's only input."""
    cell = matrix.Cell("fused_predict", "cuda", "soa", "uint8")
    seen = set()
    for variant, trace in matrix.trace_cell(cell):
        for e in trace.launches():
            dyn, static = resources.requested_smem(e.record.name,
                                                   e.record.args)
            model = resources.model_smem(e.record.name, e.record.args)
            assert dyn + static <= tuning.SMEM_OPTIN_LIMIT
            assert dyn + static == model, (variant.label, e.record.name)
            seen.add((variant.label, e.record.name))
    assert ("bulk", "repro_fused_predict") in seen
    assert ("bucket", "repro_fused_predict_spread") in seen
    # past the opt-in limit (30,000 uint8 features): the bulk fused launch
    # takes the row route's scratch array, the index kernel its global
    # route, reading the bins where they lie: neither stages a bins tile
    bulk = tuning.fused_plan(matrix.BULK_ROWS, matrix.COV_T, matrix.COV_D,
                             matrix.COV_C, matrix.WIDE_U8_F, True)
    assert bulk.route == "row" and bulk.tile.route == "global"
    index = matrix.Cell("leaf_index", "cuda", "soa", "uint8")
    (launch,) = [t for v, t in matrix.trace_cell(index)
                 if v.label == "past_optin"][0].launches()
    assert launch.record.args[10] == 1          # from_global
    assert resources.requested_smem(launch.record.name,
                                    launch.record.args) == \
        (matrix.COV_D * tuning.INDEX_ROUND_TREES * tuning.INDEX_PAIR_BYTES,
         0)


def test_suppression_demotes_finding(toy):
    @toy("leaf_index", "torch_ref_toy_sup", dtypes=("uint8",),
         layouts=("soa",), suppressions=("widening: test fixture",))
    def _toy(bins, sf, sb):
        wide = bins.to(torch.int32)
        t, d = sf.shape
        gathered = torch.index_select(wide, 1, sf.reshape(-1).long())
        go = gathered.reshape(bins.shape[0], t, d) >= sb.unsqueeze(0)
        return go.to(torch.int32).sum(dim=2)

    r = _narrow_check({"leaf_index:torch_ref_toy_sup"})
    assert r.ok, r.format(verbose=True)
    assert len(r.suppressed) >= 1
    assert r.verified["leaf_index:torch_ref_toy_sup"].startswith("ok (")


def test_unused_suppression_is_flagged(toy):
    @toy("leaf_gather", "torch_ref_toy_stale", layouts=("soa",),
         suppressions=("widening: no longer needed",))
    def _toy(idx, lv):
        return ops._ref.leaf_gather(idx, lv)

    # narrowed runs skip the stale check by default...
    r = _narrow_check({"leaf_gather:torch_ref_toy_stale"})
    assert not [f for f in r.findings if f.rule == "unused-suppression"]
    # ...and flag it, alone, when asked
    r = _narrow_check({"leaf_gather:torch_ref_toy_stale"},
                      check_unused=True)
    assert _rules(r) == {"unused-suppression"}, r.format(verbose=True)
    assert not r.ok


def test_unknown_suppression_rule_rejected():
    with pytest.raises(ValueError, match="unknown suppression rule"):
        report.parse_suppressions(("not-a-rule: whatever",))
    with pytest.raises(ValueError, match="unknown suppression rule"):
        report.parse_suppressions(("vmem-budget: the TPU's name",))
    assert report.parse_suppressions(("smem-budget",)) == \
        {"smem-budget": ""}


# --------------------------------------------------------------------------
# Plan walk: transfers, retraces, shard parity
# --------------------------------------------------------------------------
def _cuda_plan(**config):
    ens, _ = matrix.canonical_ensemble(n_features=8, n_trees=4)
    mode = trace_tools.new_fake_mode()
    return checker.fake_cuda_plan(ens, mode, **config)


def test_trace_cache_no_retrace():
    cell = matrix.Cell("binarize", "torch_ref", "soa", "int32")
    matrix.trace_cell(cell)
    before = matrix.cache_stats()
    matrix.trace_cell(cell)
    after = matrix.cache_stats()
    assert after["misses"] == before["misses"]
    assert after["hits"] > before["hits"]


@pytest.mark.parametrize("device", ["cpu", "cuda:0"])
def test_plan_walk_never_counts_and_caches(device):
    ens, _ = matrix.canonical_ensemble(n_features=8, n_trees=4)
    plan = Predictor.build(ens, device="cpu", strategy="staged") \
        if device == "cpu" else _cuda_plan(strategy="staged")
    entries = plan.trace_entries(batch_sizes=(4, 8))
    assert "raw@4" in entries and "raw_pool@8" in entries
    stats = plan.stats
    assert stats["total_traces"] == 0          # no first call counted
    misses = stats["abstract_trace_misses"]
    assert misses == len(entries)
    plan.trace_entries(batch_sizes=(4, 8))     # second walk: all cached
    assert plan.stats["abstract_trace_misses"] == misses
    for name, trace in entries.items():
        assert not passes.entry_findings(name, trace)
    launched = [e.record.name for e in entries["raw@8"].launches()]
    assert launched == ([] if device == "cpu" else
                        ["repro_binarize", "repro_leaf_index",
                         "repro_leaf_gather"])


def test_transfer_lint_fires_on_a_host_sync_and_a_host_copy(monkeypatch):
    """`.item()` and a copy to the host inside an entry of a CUDA plan."""
    plan = _cuda_plan(strategy="fused")
    raw = plan._entries["raw"]

    def synced(x):
        scale = float(x.abs().max().item())         # the violation
        return raw(x) * scale
    monkeypatch.setitem(plan._entries, "raw", synced)
    monkeypatch.setitem(plan._entries, "proba",
                        lambda x: raw(x).cpu().softmax(-1))
    traces = plan.trace_entries(entries=("raw", "proba"))
    sync = passes.entry_findings("raw", traces["raw@8"])
    copy = passes.entry_findings("proba", traces["proba@8"])
    assert {f.rule for f in sync} == {"transfer"} and \
        "_local_scalar_dense" in sync[0].message
    assert {f.rule for f in copy} == {"transfer"} and \
        "cuda:0 -> cpu" in copy[0].message
    # the same entries of a CPU plan copy nothing across
    assert plan.stats["total_traces"] == 0


def test_retrace_lint_fires_on_a_dtype_dependent_plan(monkeypatch):
    """float64 rows under the float32 rows' (entry, shape) key must make
    the same launches; a plan that doubles them does not."""
    plan = _cuda_plan(strategy="staged")
    base = plan.trace_entries(entries=("raw",))
    rows = plan._float_rows
    monkeypatch.setattr(plan, "_float_rows", lambda x: rows(
        torch.cat([x, x]) if x.dtype == torch.float64 else x))
    alt = plan.trace_entries(entries=("raw",), input_dtype=torch.float64)
    found = passes.retrace_findings("raw@8", base["raw@8"], alt["raw@8"],
                                    "float64")
    assert {f.rule for f in found} == {"retrace"}
    monkeypatch.undo()
    plan = _cuda_plan(strategy="staged")
    clean = plan.trace_entries(entries=("raw",), input_dtype=torch.float64)
    assert not passes.retrace_findings("raw@8", base["raw@8"],
                                       clean["raw@8"], "float64")
    # int32 bins are refused at the pool's door: no trace, no finding
    assert plan.trace_entries(entries=("raw_pool",),
                              input_dtype=torch.int32) == {}


def test_shard_parity_fires_on_a_panel_moved_to_the_first_card(
        monkeypatch):
    """A row-sharded entry whose shards all compute on cuda:0 moves each
    shard's panel off its card; the shipped one keeps every panel home
    and copies only the shard results to cuda:0."""
    mesh = make_mesh((4,), ("data",), devices=CUDA4)
    plan = _cuda_plan(strategy="staged", layout="soa")
    clean = passes.shard_findings([("soa", plan)], mesh)
    assert clean == []
    first = plan.lowered
    monkeypatch.setattr(plan, "_shard_raw", lambda lw, data, kind, cfg:
                        Predictor._shard_raw(plan, first,
                                             data.to("cuda:0"), kind, cfg))
    plan._abstract_traces.clear()
    found = passes.shard_findings([("soa", plan)], mesh)
    assert {f.rule for f in found} == {"shard-parity"}
    assert any("moved cuda:1 -> cuda:0" in f.message for f in found)
    assert plan.stats["total_traces"] == 0
    # the walk left no fake replica or closure on the plan
    assert set(plan._replicas) == {torch.device("cuda", 0)}
    assert plan._sharded_cache == {}


def test_shard_parity_fires_on_a_whole_panel_read():
    """An op on one card reading all N rows of the panel."""
    trace = trace_tools.Trace()
    with trace_tools.recording() as trace:
        x = torch.empty((8, 5), dtype=torch.uint8, device="cuda:0")
        parts = [x.narrow(0, 2 * i, 2).to(f"cuda:{i}") for i in range(4)]
        y = x.to(torch.int32).sum(dim=1)            # the violation
        trace_tools.mark_io(trace, [x], [y] + parts)
    found = passes.sharded_entry_findings("toy", trace, 4)
    assert {f.rule for f in found} == {"shard-parity"}
    assert "reads the whole uint8[8,5] panel" in found[0].message


# --------------------------------------------------------------------------
# Registry surface, recorder structure, CLI
# --------------------------------------------------------------------------
def test_format_table_has_verified_column():
    txt = registry.format_table({"binarize:torch_ref": "ok"})
    header = txt.splitlines()[0]
    assert "verified" in header and "layouts" in header
    row = next(line for line in txt.splitlines()
               if "| binarize" in line and "| torch_ref " in line)
    assert "| ok " in row
    blank = registry.format_table({})
    assert "| - " in blank
    # by default the committed report's verdicts
    assert registry.load_verified() == json.loads(
        ARTIFACT.read_text())["verified"]
    assert "ok (4 suppressed)" in registry.format_table()


def test_unregister_unknown_raises():
    with pytest.raises(KeyError):
        registry.unregister("binarize", "nope")


def test_launch_records_carry_shapes():
    """A recorded launch keeps the launcher, its device and its
    arguments: tensors as dtype, shape and device, ints as passed (the
    counterpart of the JAX test pinning pallas refs' block shapes)."""
    cell = matrix.Cell("fused_predict", "cuda", "soa", "uint8")
    trace = matrix.trace_variant(cell, matrix.cell_variants(cell)[0])
    (launch,) = trace.launches()
    rec = launch.record
    assert rec.name == "repro_fused_predict_spread"
    assert rec.device == torch.device("cuda", 0)
    x = rec.args[0]
    assert (x.dtype, x.shape, str(x.device)) == \
        (torch.float32, (matrix.N, matrix.F), "cuda:0")
    assert rec.args[6:13] == (matrix.N, matrix.F, matrix.B, matrix.T,
                              matrix.D, matrix.C, 1)   # u8 flag: 1
    checks = [e for e in trace.events if e.kind == "check"]
    assert [name for name, _ in checks[0].record.args] == [
        "x", "borders", "split_features", "split_bins", "leaf_values"]


def test_recording_is_explicit_and_thread_local():
    """Outside the context `launch` goes to the library; inside, it only
    records, on the recording thread."""
    import threading
    assert not _build.recording()
    with _build.recording_launches() as recs:
        assert _build.recording()
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            _build.recording()))
        t.start()
        t.join()
        assert seen == [False]
        _build.launch("repro_binarize", torch.device("cuda", 0), 1, 2)
    assert [(r.kind, r.name, r.args) for r in recs] == [
        ("launch", "repro_binarize", (1, 2))]
    assert not _build.recording()


def test_fake_device_indexing_spells_views():
    """Python indexing, copy_ and contiguous of fake CUDA tensors go
    through the aten ops they stand for."""
    def f(x):
        y = x[None, :, 1:3]
        z = x[:, 0].contiguous()
        x[:, 2] = 0.0
        w = x[torch.zeros(2, dtype=torch.long, device=x.device)]
        return y, z, w
    trace = trace_tools.trace_abstract(f, Spec((4, 5), torch.float32,
                                               "cuda:0"))
    shapes = [trace.values[v].shape for v in trace.outputs]
    assert shapes == [(1, 4, 2), (4,), (2, 5)]
    names = {e.name for e in trace.ops()}
    assert {"unsqueeze", "slice", "select", "fill_", "index"} <= names


def test_cli_check_exit_codes(toy):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.analyze", "--check",
         "--no-write"], cwd=ROOT, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RESULT: OK" in proc.stdout and "92 cells" in proc.stdout

    @toy("leaf_index", "torch_ref_toy_cli", dtypes=("uint8",),
         layouts=("soa",))
    def _toy(bins, sf, sb):
        return ops._ref.leaf_index(bins.to(torch.int32), sf, sb) \
            + bins.to(torch.int32).sum()
    assert analyze.main(["--check", "--no-write", "--no-plan",
                         "--no-shard", "--no-tuning", "--impls",
                         "leaf_index:torch_ref_toy_cli"]) == 1

"""The port's telemetry (`repro_torch.obs`), on the CPU.

The 17 tests of `tests/test_obs.py` on the port: the span tracer
(disabled overhead, ring eviction, Chrome-trace schema, cross-thread
spans), a traced BulkScorer run, the deadline-SLO accounting of
`ServerMetrics` and the `MetricsHub` exports.  Then parity with the JAX
package: the same snapshots give byte-identical Prometheus text and
equal JSON; a traced fit and a traced bulk run record the same events
in both packages; the `compile/*` instants are the plan's first calls;
the `dispatch/<op>` spans follow `registry.call_stats()`; tracing
changes no result.  The port's own spans: a call's copy of host rows to
the card (`plan/h2d`), the trainer's split search and its host work
after a tree's synchronization (`trainer/split`, `trainer/sync`), and
the benchmark's readers of them.  The profiler bridge: every live span
is a `torch.profiler` range of its name, placed on the profiler's clock
by `epoch_unix_ns`.  And the card's mechanism, with stand-in CUDA
events: a span's events are read at export after one synchronization,
never before.
"""
import importlib.util
import json
import pathlib
import statistics
import threading
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import boosting as jboosting  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import quantize as jquantize  # noqa: E402
from repro.core.predictor import PredictConfig as JConfig  # noqa: E402
from repro.core.predictor import Predictor as JPredictor  # noqa: E402
from repro.core.trees import ObliviousEnsemble as JEnsemble  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import scoring as jscoring  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.training import gbdt as jgbdt  # noqa: E402
from repro_torch.core import boosting, losses, quantize  # noqa: E402
from repro_torch.core import predictor as predictor_mod  # noqa: E402
from repro_torch.core.predictor import PredictConfig, Predictor  # noqa: E402
from repro_torch.core.trees import ObliviousEnsemble  # noqa: E402
from repro_torch.kernels import registry, tuning  # noqa: E402
from repro_torch.obs import MetricsHub  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.obs.trace import Tracer, get_tracer, tracing  # noqa: E402
from repro_torch.scoring import (ArraySink, ArraySource,  # noqa: E402
                                 BulkScorer, ScoreConfig)
from repro_torch.serving.metrics import ServerMetrics  # noqa: E402
from repro_torch.training import gbdt  # noqa: E402

torch.set_num_threads(1)


def _arrays(seed=3, n_trees=9, depth=4, n_features=7, n_borders=9,
            n_outputs=1):
    rng = np.random.default_rng(seed)
    return {
        "split_features": rng.integers(0, n_features, (n_trees, depth))
        .astype(np.int32),
        "split_bins": rng.integers(1, n_borders, (n_trees, depth))
        .astype(np.int32),
        "leaf_values": rng.normal(size=(n_trees, 2 ** depth, n_outputs))
        .astype(np.float32),
        "borders": np.sort(rng.normal(size=(n_borders, n_features)), 0)
        .astype(np.float32),
        "n_borders": np.full((n_features,), n_borders, np.int32),
    }


def _rand_ensemble(**kw):
    return ObliviousEnsemble(**_arrays(**kw))


def _plan(ens, **kw):
    return Predictor.build(ens, PredictConfig(strategy="staged", **kw),
                           device="cpu")


# --------------------------------------------------------------------------
# Tracer core
# --------------------------------------------------------------------------
def test_disabled_span_is_shared_noop_and_records_nothing():
    tr = Tracer()
    s1 = tr.span("a", "cat", big_attr="x" * 100)
    s2 = tr.span("b", device=torch.device("cpu"))
    assert s1 is s2                       # singleton: no allocation
    with s1:
        pass
    tr.instant("i")
    tr.counter("c", v=1.0)
    tr.complete("x", start_ns=0, duration_ns=1)
    tr.annotate(route="spread")
    assert len(tr) == 0


def test_disabled_overhead_is_small():
    # a disabled span() call is an attribute load and a bool test; the
    # loose wall-clock bound catches allocation or locking, not ns
    tr = Tracer()
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        with tr.span("hot"):
            pass
    dt = time.perf_counter() - t0
    assert dt / n < 5e-6, f"{dt / n * 1e9:.0f}ns per disabled span"


def test_ring_eviction_is_fifo_and_counts_drops():
    tr = Tracer(capacity=4)
    tr.enable()
    for i in range(7):
        tr.instant(f"e{i}")
    assert len(tr) == 4
    assert [e["name"] for e in tr.events()] == ["e3", "e4", "e5", "e6"]
    assert tr.dropped == 3


def test_span_records_duration_and_attrs():
    tr = Tracer()
    tr.enable()
    with tr.span("work", "cat", rows=128) as sp:
        sp.set(result="ok")
        tr.annotate(route="row")              # the innermost open span
        time.sleep(0.002)
    (e,) = tr.events()
    assert e["ph"] == "X" and e["name"] == "work"
    assert e["dur_us"] >= 2000
    assert e["args"] == {"rows": 128, "result": "ok", "route": "row"}


def test_complete_event_matches_span_timebase():
    tr = Tracer()
    tr.enable()
    t0 = time.perf_counter_ns()
    tr.complete("pre-timed", "train", start_ns=t0, duration_ns=5000,
                level=2)
    with tr.span("live"):
        pass
    pre, live = tr.events()
    assert pre["dur_us"] == 5.0 and pre["args"] == {"level": 2}
    assert pre["ts_us"] <= live["ts_us"]


def test_chrome_export_schema(tmp_path):
    tr = Tracer()
    tr.enable()
    with tr.span("dispatch/leaf_index", "kernel", op="leaf_index"):
        pass
    tr.instant("compile/raw", "compile", batch=64)
    tr.counter("dispatch_count", "kernel", leaf_index=1.0)
    path = tmp_path / "trace.json"
    obj = tr.export_chrome(path)
    loaded = json.loads(path.read_text())
    assert loaded == json.loads(json.dumps(obj))
    evs = loaded["traceEvents"]
    metas = [e for e in evs if e["ph"] == "M"]
    assert metas and metas[0]["name"] == "thread_name"
    x = next(e for e in evs if e["ph"] == "X")
    assert {"name", "cat", "ts", "dur", "pid", "tid", "args"} <= set(x)
    assert isinstance(x["ts"], float) and x["pid"] == 1
    assert x["tid"] == 0                  # idents remapped to small ints
    i = next(e for e in evs if e["ph"] == "i")
    assert i["s"] == "t"
    c = next(e for e in evs if e["ph"] == "C")
    assert c["args"] == {"leaf_index": 1.0}
    assert loaded["otherData"]["dropped_events"] == 0
    assert loaded["otherData"]["epoch_unix_ns"] == tr.epoch_unix_ns


def test_export_names_threads_that_already_exited(tmp_path):
    tr = Tracer()
    tr.enable()

    def work():
        with tr.span("bg-span"):
            pass

    t = threading.Thread(target=work, name="my-worker")
    t.start()
    t.join()                    # the thread is dead before export
    obj = tr.export_chrome(tmp_path / "t.json")
    names = [e["args"]["name"] for e in obj["traceEvents"]
             if e["ph"] == "M"]
    assert "my-worker" in names


def test_export_names_a_reused_thread_ident_by_its_newest_thread(tmp_path):
    """A thread's ident is reused once it ends: the label follows the
    thread that holds it now, not the first that held it."""
    tr = Tracer()
    tr.enable()

    def record():
        tr._append(("i", "ev", "", time.perf_counter_ns(), 0, 4242, {}))

    for name in ("old-worker", "prefetcher"):
        t = threading.Thread(target=record, name=name)
        t.start()
        t.join()
    obj = tr.export_chrome(tmp_path / "t.json")
    names = [e["args"]["name"] for e in obj["traceEvents"]
             if e["ph"] == "M"]
    assert names == ["prefetcher"]


def test_tracing_context_restores_prior_state():
    tr = Tracer()
    with tracing(tr):
        assert tr.enabled
        with tracing(tr):
            pass
        assert tr.enabled            # inner exit restores True
    assert not tr.enabled


# --------------------------------------------------------------------------
# Instrumentation integration: a traced BulkScorer run
# --------------------------------------------------------------------------
def _bulk_events(x, ens, tracer, **cfg):
    plan = _plan(ens)
    with tracing(tracer, clear=True):
        scorer = BulkScorer({"m": plan}, ScoreConfig(**cfg))
        result = scorer.score(ArraySource(x), {"m": ArraySink()})
        events = tracer.events()
    return events, result


def test_bulk_scorer_trace_shows_prefetch_overlap(tmp_path):
    ens = _rand_ensemble()
    x = np.random.default_rng(0).normal(
        size=(700, ens.n_features)).astype(np.float32)
    tracer = get_tracer()
    events, _ = _bulk_events(x, ens, tracer, chunk_rows=256,
                             prequantize=True)
    by_name: dict = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    assert len(by_name["bulk/quantize"]) == len(by_name["bulk/score"])
    assert len(by_name["bulk/quantize"]) >= 3
    assert "bulk/sink" in by_name
    disp = [e for n, evs in by_name.items() if n.startswith("dispatch/")
            for e in evs]
    assert disp and all({"op", "impl", "layout"} <= set(e["args"])
                        for e in disp)
    # quantize on the worker's thread, scoring on the caller's
    q_tids = {e["tid"] for e in by_name["bulk/quantize"]}
    s_tids = {e["tid"] for e in by_name["bulk/score"]}
    assert q_tids and s_tids and not (q_tids & s_tids)
    obj = tracer.export_chrome(tmp_path / "bulk.json")
    thread_labels = {e["args"]["name"] for e in obj["traceEvents"]
                     if e["ph"] == "M"}
    assert "prefetcher" in thread_labels
    assert not tracer.enabled        # context restored


# --------------------------------------------------------------------------
# Deadline-SLO accounting
# --------------------------------------------------------------------------
def test_server_metrics_slo_math():
    m = ServerMetrics("m", deadline_ms=10.0)
    m.note_batch(4, 8, 0.005)        # 5ms: hit, 4 rows
    m.note_batch(2, 2, 0.020)        # 20ms: miss, 2 rows
    m.note_shed(3)
    s = m.snapshot()
    assert s["deadline_hits"] == 4 and s["deadline_misses"] == 2
    assert s["deadline_attainment"] == pytest.approx(4 / 6)
    assert s["shed_requests"] == 3
    assert s["shed_rate"] == pytest.approx(3 / 9)
    assert s["p99_under_deadline_ms"] == pytest.approx(5.0)
    assert s["batch_p99_ms"] > 5.0


def test_server_metrics_slo_disabled_is_vacuous():
    m = ServerMetrics("m")
    m.note_batch(4, 4, 0.5)
    s = m.snapshot()
    assert s["deadline_ms"] is None
    assert s["deadline_attainment"] == 1.0
    assert s["deadline_hits"] == 0 and s["deadline_misses"] == 0
    assert s["shed_rate"] == 0.0


def test_server_metrics_interval_rates_and_reset():
    m = ServerMetrics("m")
    m.note_batch(10, 10, 0.001)
    s1 = m.snapshot()
    assert s1["interval_requests_per_s"] > 0
    s2 = m.snapshot()                 # nothing since the last poll
    assert s2["interval_requests_per_s"] == 0.0
    assert s2["requests_per_s"] > 0
    m.reset()
    s3 = m.snapshot()
    assert s3["requests"] == 0 and s3["batch_p99_ms"] == 0.0


def test_server_metrics_merge_does_not_consume_intervals():
    a, b = ServerMetrics("m", deadline_ms=5.0), \
        ServerMetrics("m", deadline_ms=5.0)
    a.note_batch(3, 4, 0.001)
    b.note_batch(5, 8, 0.009)
    fleet = ServerMetrics.merge([a, b])
    assert fleet["replicas"] == 2 and fleet["requests"] == 8
    assert fleet["deadline_hits"] == 3 and fleet["deadline_misses"] == 5
    assert fleet["deadline_attainment"] == pytest.approx(3 / 8)
    assert a.snapshot()["interval_requests_per_s"] > 0
    assert b.snapshot()["interval_requests_per_s"] > 0


# --------------------------------------------------------------------------
# MetricsHub
# --------------------------------------------------------------------------
def test_hub_register_forms_and_snapshot():
    hub = MetricsHub()
    m = ServerMetrics("m")
    hub.register("serving/m", m)                       # .snapshot()
    hub.register("adhoc", lambda: {"x": 1})            # callable
    hub.register("static", {"y": 2.5})                 # mapping
    with pytest.raises(KeyError):
        hub.register("adhoc", lambda: {})              # no silent shadow
    hub.register("adhoc", lambda: {"x": 9}, replace=True)
    snap = hub.snapshot()
    assert snap["adhoc"] == {"x": 9} and snap["static"] == {"y": 2.5}
    assert snap["serving/m"]["requests"] == 0
    assert hub.namespaces() == ["adhoc", "serving/m", "static"]


def test_hub_failing_source_is_isolated():
    hub = MetricsHub()

    def boom():
        raise RuntimeError("dead model")

    hub.register("bad", boom)
    hub.register("good", {"ok": 1})
    snap = hub.snapshot()
    assert snap["good"] == {"ok": 1}
    assert "RuntimeError" in snap["bad"]["error"]


def test_hub_prometheus_format(tmp_path):
    hub = MetricsHub(prefix="repro")
    hub.register("scoring/bulk", {"rows_per_s": 1234.5, "rows": 10,
                                  "model": "cover type", "exact": True,
                                  "nested": {"raw": 3},
                                  "skipme": [1, 2]})
    text = hub.export_prometheus(tmp_path / "m.prom")
    assert (tmp_path / "m.prom").read_text() == text
    assert "# TYPE repro_scoring_bulk_rows_per_s gauge" in text
    assert 'model="cover type"' in text
    assert "repro_scoring_bulk_rows_per_s" in text
    assert "repro_scoring_bulk_exact" in text          # bool -> gauge
    assert "repro_scoring_bulk_nested_raw" in text     # one-level flatten
    assert "skipme" not in text                        # lists skipped


def test_hub_json_export(tmp_path):
    hub = MetricsHub()
    hub.register("a", {"v": 1})
    obj = hub.export_json(tmp_path / "m.json")
    loaded = json.loads((tmp_path / "m.json").read_text())
    assert loaded["metrics"]["a"]["v"] == 1
    assert "collected_at" in loaded and "collected_at" in obj


# --------------------------------------------------------------------------
# Parity with the JAX package
# --------------------------------------------------------------------------
SNAPSHOTS = {
    "serving/gbdt": {"requests": 12, "rows_per_s": 1234.5678,
                     "model": 'co"ver\\type\n', "layout": "soa",
                     "deadline_ms": None, "exact": False,
                     "traces": {"raw": 2, "proba": 1, "ok": True},
                     "batch_sizes": [1, 2], "p99": 1e-7, "big": 3e12},
    "scoring/bulk": {"rows": 10, "quantize_frac": 0.25, "nan": float("nan"),
                     "inf": float("inf"), "neg": -0.0},
    "training/gbdt-covertype": {"iterations": 3, "hist_ms": 12.5},
    "9lives": {"x": 1},
}


def _hubs():
    hubs = MetricsHub(), jobs.MetricsHub()
    for hub in hubs:
        for ns, snap in SNAPSHOTS.items():
            hub.register(ns, snap)
        hub.register("bad", lambda: 1 / 0)
    return hubs


def test_hub_prometheus_text_byte_identical_to_jax(tmp_path):
    ours, theirs = _hubs()
    assert ours.format_prometheus() == theirs.format_prometheus()
    a = ours.export_prometheus(tmp_path / "a.prom")
    b = theirs.export_prometheus(tmp_path / "b.prom")
    assert (tmp_path / "a.prom").read_bytes() == \
        (tmp_path / "b.prom").read_bytes() and a == b


def test_hub_json_equals_jax(tmp_path):
    ours, theirs = _hubs()
    a = ours.export_json(tmp_path / "a.json")
    b = theirs.export_json(tmp_path / "b.json")
    assert json.dumps(a["metrics"], sort_keys=True, default=float) == \
        json.dumps(b["metrics"], sort_keys=True, default=float)
    la = json.loads((tmp_path / "a.json").read_text())["metrics"]
    lb = json.loads((tmp_path / "b.json").read_text())["metrics"]
    assert json.dumps(la, sort_keys=True) == json.dumps(lb, sort_keys=True)


def _fit_data(n=400, f=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (x[:, 0] - x[:, 1] > 0).astype(np.float32)
    return x, y


def _port_fit(x, y):
    params = boosting.BoostingParams(n_trees=3, depth=3, max_bins=16)
    b, nb = quantize.compute_borders(x, 16)
    return gbdt.GBDTTrainer(losses.make_loss("logloss"), params,
                            device="cpu").fit_pool(
        quantize.quantize_pool(x, b), y, borders=b, n_borders=nb)


def _train_keys(events):
    return Counter((e["name"], e["args"]["iteration"],
                    e["args"].get("level"))
                   for e in events if e["name"].startswith("train/"))


def test_traced_fit_records_jax_train_events_and_same_bits():
    x, y = _fit_data()
    plain, plain_hist = _port_fit(x, y)
    tracer = get_tracer()
    with tracing(tracer, clear=True):
        ens, hist = _port_fit(x, y)
        events = tracer.events()
    jtracer = jtrace.get_tracer()
    jb, jnb = jquantize.compute_borders(x, 16)
    with jtrace.tracing(jtracer, clear=True):
        jgbdt.GBDTTrainer(jlosses.make_loss("logloss"),
                          jboosting.BoostingParams(n_trees=3, depth=3,
                                                   max_bins=16)).fit_pool(
            jquantize.quantize_pool(jnp.asarray(x), jb), y, borders=jb,
            n_borders=jnb)
        jevents = jtracer.events()
    assert _train_keys(events) == _train_keys(jevents)
    assert sum(_train_keys(events).values()) == 3 * 3 + 3
    for e in events:
        if e["name"] == "train/iteration":
            want = {k for e2 in jevents if e2["name"] == "train/iteration"
                    for k in e2["args"]}
            assert set(e["args"]) == want
    # tracing changes no bit
    for name in ("split_features", "split_bins", "leaf_values"):
        assert torch.equal(getattr(ens, name), getattr(plain, name))
    assert np.array_equal(hist["final_raw"], plain_hist["final_raw"])


def test_traced_bulk_run_records_jax_chunks_and_same_bits():
    arrays = _arrays(n_outputs=2)
    ens = ObliviousEnsemble(**arrays)
    jens = JEnsemble(**{k: jnp.asarray(v) for k, v in arrays.items()})
    x = np.random.default_rng(1).normal(
        size=(1000, ens.n_features)).astype(np.float32)
    cfg = dict(chunk_rows=256, prequantize=True, output="proba")
    plain = BulkScorer({"m": _plan(ens)}, ScoreConfig(**cfg)).score(
        ArraySource(x), {"m": ArraySink()})
    events, traced = _bulk_events(x, ens, get_tracer(), **cfg)
    jplan = JPredictor.build(jens, JConfig(strategy="staged",
                                           backend="ref"))
    jtracer = jtrace.get_tracer()
    with jtrace.tracing(jtracer, clear=True):
        jscoring.BulkScorer({"m": jplan}, jscoring.ScoreConfig(**cfg)) \
            .score(jscoring.ArraySource(x), {"m": jscoring.ArraySink()})
        jevents = jtracer.events()

    def chunks(evs):
        return Counter((e["name"], e["args"]["chunk"]) for e in evs
                       if e["name"].startswith("bulk/"))
    assert chunks(events) == chunks(jevents)
    assert np.array_equal(traced.outputs["m"], plain.outputs["m"])


def test_worker_quantize_overlaps_scoring_on_the_timeline():
    """With the prefetch worker, some chunk's `bulk/quantize` (worker
    thread) runs while another chunk's `bulk/score` (main thread) does."""
    ens = _rand_ensemble(n_trees=200, depth=6)
    x = np.random.default_rng(2).normal(
        size=(16 * 2048, ens.n_features)).astype(np.float32)
    events, _ = _bulk_events(x, ens, get_tracer(), chunk_rows=2048,
                             prequantize=True, prefetch_depth=2)

    def spans(name):
        return [(e["ts_us"], e["ts_us"] + e["dur_us"], e["tid"])
                for e in events if e["name"] == name]
    quant, score = spans("bulk/quantize"), spans("bulk/score")
    assert len(quant) == len(score) == 16
    assert {t for *_, t in quant}.isdisjoint({t for *_, t in score})
    assert any(q0 < s1 and s0 < q1 for q0, q1, _ in quant
               for s0, s1, _ in score)


def test_compile_instants_are_the_plans_first_calls():
    ens = _rand_ensemble()
    plan = _plan(ens)
    tracer = get_tracer()
    rng = np.random.default_rng(0)
    with tracing(tracer, clear=True):
        for n in (5, 9, 5, 9, 17):
            plan.raw(rng.normal(size=(n, ens.n_features)).astype(
                np.float32))
            plan.proba(rng.normal(size=(n, ens.n_features)).astype(
                np.float32))
        events = tracer.events()
    firsts = [e for e in events if e["name"].startswith("compile/")]
    assert len(firsts) == plan.stats["total_traces"] == 6
    assert Counter(e["args"]["entry"] for e in firsts) == \
        Counter(plan.stats["traces"])
    assert all(e["args"]["layout"] == plan.config.layout and
               e["args"]["batch"] in (5, 9, 17) for e in firsts)


def test_dispatch_spans_follow_call_stats():
    ens = _rand_ensemble()
    plan = _plan(ens, layout="soa")
    x = np.random.default_rng(0).normal(
        size=(33, ens.n_features)).astype(np.float32)
    tracer = get_tracer()
    registry.reset_call_stats()
    with tracing(tracer, clear=True):
        plan.raw(x)
        plan.raw(plan.quantize(x))
        events = tracer.events()
    assert registry.call_stats()
    spans = Counter(e["name"] for e in events
                    if e["name"].startswith("dispatch/"))
    assert spans == Counter({f"dispatch/{op}": n for op, n in
                             registry.call_stats().items()})


# --------------------------------------------------------------------------
# The port's own spans: the input copy, the split search, the sync
# --------------------------------------------------------------------------
def test_host_rows_copied_to_the_card_are_one_plan_h2d_span(monkeypatch):
    assert predictor_mod._host_to_card(torch.zeros(2, 3),
                                       torch.device("cuda"))
    assert not predictor_mod._host_to_card(torch.zeros(2, 3),
                                           torch.device("cpu"))
    ens = _rand_ensemble()
    plan = _plan(ens)
    x = np.random.default_rng(0).normal(
        size=(33, ens.n_features)).astype(np.float32)
    tracer = get_tracer()
    with tracing(tracer, clear=True):
        plan.proba(x)                   # a CPU plan: nothing is copied
        assert not [e for e in tracer.events() if e["name"] == "plan/h2d"]
    pool = plan.quantize(x)
    # the plan as if on a card: its rows cross, a pool already there not
    monkeypatch.setattr(predictor_mod, "_host_to_card",
                        lambda rows, device: True)
    with tracing(tracer, clear=True):
        plan.proba(x)
        plan.proba(pool)
        events = tracer.events()
    (h2d,) = [e for e in events if e["name"] == "plan/h2d"]
    assert h2d["cat"] == "plan"
    assert h2d["args"] == {"rows": 33, "bytes": 33 * ens.n_features * 4,
                           "pinned": False}
    # the copy comes before the call's kernels
    first = min(e["ts_us"] for e in events
                if e["name"].startswith("dispatch/"))
    assert h2d["ts_us"] + h2d["dur_us"] <= first


def test_traced_fit_times_each_split_search_and_each_sync():
    x, y = _fit_data()
    plain, plain_hist = _port_fit(x, y)
    tracer = get_tracer()
    with tracing(tracer, clear=True):
        ens, hist = _port_fit(x, y)
        events = tracer.events()
    split = [e for e in events if e["name"] == "trainer/split"]
    sync = [e for e in events if e["name"] == "trainer/sync"]
    assert Counter((e["args"]["iteration"], e["args"]["level"])
                   for e in split) == Counter(
        {(i, d): 1 for i in range(3) for d in range(3)})
    assert sorted(e["args"]["iteration"] for e in sync) == [0, 1, 2]
    assert all(e["cat"] == "trainer" and e["dur_us"] >= 0
               for e in split + sync)
    # a tree's splits are issued before its sync stretch starts
    for e in split:
        (s,) = [s for s in sync
                if s["args"]["iteration"] == e["args"]["iteration"]]
        assert e["ts_us"] + e["dur_us"] <= s["ts_us"]
    # tracing changes no bit
    for name in ("split_features", "split_bins", "leaf_values"):
        assert torch.equal(getattr(ens, name), getattr(plain, name))
    assert np.array_equal(hist["final_raw"], plain_hist["final_raw"])
    assert np.array_equal(hist["train_loss"], plain_hist["train_loss"])


# the profiler's range starts a few microseconds before the span's ts; a
# clock on another base is off by seconds or more
CLOCK_MEDIAN_US = 1000.0
CLOCK_MAX_US = 50_000.0


def _profiled_ranges(work) -> dict[str, int]:
    """{name: start in Unix-epoch ns} of the host ranges a CPU profile of
    `work()` records."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        work()
    return {e.name(): e.start_ns()
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()}


def test_live_spans_are_profiler_ranges_on_its_clock():
    tr = Tracer()
    tr.enable()
    names = [f"dispatch/op{i}" for i in range(10)] + [
        "plan/h2d", "trainer/split", "trainer/sync"]

    def work():
        for name in names:
            with tr.span(name, "test", i=1):
                with tr.span(name + "/inner"):
                    pass
        tr.complete("train/level", start_ns=time.perf_counter_ns(),
                    duration_ns=10)

    ranges = _profiled_ranges(work)
    spans = {e["name"]: tr.epoch_unix_ns + e["ts_us"] * 1e3
             for e in tr.events()}
    live = [n for n in spans if n != "train/level"]
    assert set(live) <= set(ranges)
    assert "train/level" not in ranges      # written after the fact
    offsets = [abs(spans[n] - ranges[n]) / 1e3 for n in live]
    assert statistics.median(offsets) < CLOCK_MEDIAN_US, offsets
    assert max(offsets) < CLOCK_MAX_US, offsets
    # the epoch moves with clear(), on both clocks
    tr.clear()
    assert abs(tr.epoch_unix_ns - time.time_ns()) < 1e9
    # disabled, a span opens no range
    tr.disable()

    def quiet():
        with tr.span("quiet"):
            pass
    assert "quiet" not in _profiled_ranges(quiet)


# --------------------------------------------------------------------------
# The benchmark's readers of these spans
# --------------------------------------------------------------------------
METRICS = pathlib.Path(__file__).resolve().parents[1] / "bench" / "metrics"


def _reader(stem: str):
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{stem}", METRICS / f"{stem}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _x(name, dur_us=1.0, **args):
    return {"ph": "X", "name": name, "cat": "", "ts_us": 0.0,
            "dur_us": dur_us, "tid": 1, "args": args}


def test_input_copy_reader_is_device_ms_a_call():
    read = _reader("input_copy_ms")
    copy = dict(rows=10, bytes=40, pinned=False)
    events = [_x("plan/h2d", device_ms=5.0, **copy),
              _x("plan/h2d", device_ms=6.5, **copy),
              _x("plan/h2d", **copy),          # a CPU span: no device time
              _x("dispatch/fused_predict", device_ms=17.0),
              {"ph": "i", "name": "plan/h2d", "args": {"device_ms": 9.0}}]
    assert read({"events": events, "calls": 2}) == pytest.approx(5.75)
    assert read({"events": events[2:], "calls": 2}) is None
    assert read({"events": [], "calls": 3}) is None   # no such span
    assert read({"window_s": 1.0}) is None


def test_split_host_reader_counts_the_trees_its_spans_name():
    read = _reader("split_host_ms")
    # the ring dropped trees 0-4: trees 5-7 remain, 3 levels each
    events = [_x("trainer/split", 1000.0 * (d + 1), iteration=i, level=d)
              for i in range(5, 8) for d in range(3)]
    events += [_x("trainer/sync", 5e5, iteration=7),
               _x("dispatch/histogram", 7e3, device_ms=7.0)]
    assert read({"events": events, "steps": 8}) == pytest.approx(6.0)
    assert read({"events": events[-2:], "steps": 8}) is None
    assert read({"window_s": 1.0}) is None


def test_split_launches_reader_is_launches_a_level():
    read = _reader("split_launches_per_level")
    # 2 trees of 3 levels: each level one trainer/split span holding its
    # dispatch/split_level span, annotated with the kernel's launches
    events = []
    for i in range(2):
        for d in range(3):
            events += [_x("trainer/split", 50.0, iteration=i, level=d),
                       _x("dispatch/split_level", 20.0, op="split_level",
                          launches=3, device_ms=0.02)]
    events += [_x("dispatch/histogram", 7e3, device_ms=7.0),
               {"ph": "i", "name": "dispatch/split_level",
                "args": {"launches": 9}}]
    assert read({"events": events}) == pytest.approx(3.0)
    # the parent's split search: library ops, no dispatch/split_level span
    parent = [e for e in events if e["name"] != "dispatch/split_level"]
    assert read({"events": parent}) is None
    assert read({"events": [_x("dispatch/split_level", launches=3)]}) is None
    assert read({"window_s": 1.0}) is None


def test_plan_attrs_flatten_a_launch_plan():
    plan = tuning.fused_plan(1024, 100, 6, 1, 54, True, None)
    attrs = trace.plan_attrs(plan)
    assert attrs["route"] in ("spread", "row")
    assert all(isinstance(v, (bool, int, str)) for v in attrs.values())
    nested = trace.plan_attrs(tuning.index_plan(1024, 100, 6, 54, 1))
    assert "tile_rows" in nested and "tile_route" in nested


# --------------------------------------------------------------------------
# The card's mechanism, with stand-in CUDA events
# --------------------------------------------------------------------------
class _FakeEvent:
    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream):
        _FakeEvent.clock += 1.5
        self.t = _FakeEvent.clock

    def elapsed_time(self, other):
        return other.t - self.t


def test_cuda_spans_read_events_at_export_after_one_sync(monkeypatch,
                                                          tmp_path):
    syncs = []
    monkeypatch.setattr(trace, "_cuda_stream", lambda device: "stream")
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(a))
    tr = Tracer()
    tr.enable()
    for i in range(3):
        with tr.span("dispatch/histogram", "kernel", device="cuda", i=i):
            pass
    tr.instant("host-only")
    assert syncs == []                        # nothing read on the way
    obj = tr.export_chrome(tmp_path / "t.json")
    assert len(syncs) == 1
    xs = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    assert [e["args"]["device_ms"] for e in xs] == [1.5, 1.5, 1.5]
    assert all("_cuda_events" not in e["args"] for e in xs)
    tr.events()
    assert len(syncs) == 1                    # already read: no second

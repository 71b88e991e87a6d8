"""The harness on the CPU at small sizes, through the program's plain
versions: every cell's run comes out correct; its control (the reference in
the precision below the configuration's, in the program's place) and each
fault a cell can have, planted under the timed path, come out not correct;
`BENCHMARK.json` keeps the contract's form; a new cell, configuration,
traffic mix and metric come in as new files alone."""
import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchlib import harness, spec

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
SEED = 2 ** 31 + 12345          # past 32 signed bits, as the driver's are

# small sizes a test run can hold; the traffic and the path are the cell's
# (leaf values of standard deviation 1/sqrt(trees), the configurations' rule)
SMALL = {
    "covertype-apply": ({"trees": 64, "leaf_scale": 0.125, "test_rows": 600},
                        {}),
    "covertype-apply-mesh4": ({"trees": 64, "leaf_scale": 0.125,
                               "test_rows": 600}, {}),
    "yearmsd-serve": ({"trees": 64, "leaf_scale": 0.125, "test_rows": 900},
                      {"rate_per_s": 400, "checked_requests": 60,
                       "grace_s": 20}),
    "covertype-train": ({"train_rows": 1500, "border_count": 15},
                        {"min_trees": 6}),
}
SECONDS = 0.3


# cells specified and kept runnable, not (yet) in BENCHMARK.json:
# (configuration, traffic mix, chips, end-to-end metric, per-layer metrics)
STAGED = {
    "yearmsd-serve": ("year_msd", "serve_poisson", 1, ("serve_p95_ms", "ms"),
                      ("serve_rows_per_batch", "serve_pad_share",
                       "fused_predict_roofline.serve", "serve_mfu",
                       "device_idle_pct.serve")),
    "covertype-apply-mesh4": ("covertype", "apply_test_split_rows4", 4,
                              ("apply_rows_per_s", "rows/s"),
                              ("launches_per_call.apply",
                               "fused_predict_roofline.apply",
                               "predict_mfu", "device_idle_pct.apply")),
}


def _cell(name):
    if name not in STAGED:
        return spec.cell(name, ROOT)
    config, traffic, chips, (metric, unit), layers = STAGED[name]
    return spec.Cell(
        name=name, chips=chips,
        config=spec.load_json(BENCH / "configs" / f"{config}.json"),
        traffic=spec.load_json(BENCH / "traffic" / f"{traffic}.json"),
        end_to_end=[{"name": metric, "unit": unit},
                    {"name": "setup_s", "unit": "s"}],
        per_layer=[{"name": m, "unit": "-"} for m in layers])


def _run(name, *, trace=False, control=None, seed=SEED):
    overrides, mix = SMALL[name]
    return harness.run_cell(_cell(name), seed, SECONDS, trace,
                            kind="cpu", overrides=overrides, mix=mix,
                            control=control)


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_has_a_small_size():
    assert sorted(SMALL) == sorted([w["name"] for w in _spec()["workloads"]]
                                   + list(STAGED))


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_the_cpu(name, trace):
    r = _run(name, trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    cell = _cell(name)
    if trace:
        for m in cell.per_layer:      # card metrics read nothing here
            if m["name"] in r["metrics"]:
                assert r["metrics"][m["name"]]["value"] >= 0
    else:
        assert sorted(r["metrics"]) == sorted(m["name"]
                                              for m in cell.end_to_end)
        assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("control", list(harness.CONTROLS["float32"]))
def test_the_control_is_not_correct(name, control):
    """Each control fails the check: the reference a step below float32
    throughout, and its leaf table kept in bfloat16 under float32 sums
    (the shortcut that halves a table past L2)."""
    r = _run(name, control=control)
    assert not r["correct"], r["checks"]


# -- faults planted under the timed path -----------------------------------
def _alter_answer(monkeypatch):
    from repro_torch.core import predictor
    original = predictor.proba_from_raw

    def altered(raw, n_outputs):
        out = original(raw, n_outputs).clone()
        out[0, 0] += 0.25
        return out
    monkeypatch.setattr(predictor, "proba_from_raw", altered)


def _half_the_rows(monkeypatch):
    from repro_torch.core import predictor
    original = predictor.Predictor._raw_impl

    def half(self, x):
        raw = original(self, x[: max(1, x.shape[0] // 2)])
        rest = raw.mean(0, keepdim=True).expand(x.shape[0] - raw.shape[0],
                                                -1)
        return torch.cat([raw, rest])
    monkeypatch.setattr(predictor.Predictor, "_raw_impl", half)
    monkeypatch.setattr(predictor.Predictor, "_shard_raw",
                        lambda self, lw, data, kind, cfg: half(
                            self, data) - self.ensemble.base_score)


def _drop_a_shard(monkeypatch):
    from repro_torch.core import predictor
    original = predictor.Predictor._shard_raw
    calls = [0]

    def dropped(self, lw, data, kind, cfg):
        calls[0] += 1
        out = original(self, lw, data, kind, cfg)
        return torch.zeros_like(out) if calls[0] % 4 == 0 else out
    monkeypatch.setattr(predictor.Predictor, "_shard_raw", dropped)


def _state_unchanged(monkeypatch):
    from repro_torch.training import gbdt

    def unchanged(raw, y, gh, leaf, leaf_bins, *, loss, n_leaves, lr, l2,
                  backend):
        w = torch.zeros((n_leaves, raw.shape[1]), device=raw.device)
        return raw, w, loss.value(raw, y)
    monkeypatch.setattr(gbdt, "_finish_plain", unchanged)


def _half_the_batch(monkeypatch):
    from repro_torch.training import gbdt
    original = gbdt._grad_stack

    def half(raw, y, *, loss):
        gh = original(raw, y, loss=loss)
        keep = gh.shape[0] // 2
        return torch.cat([2 * gh[:keep], torch.zeros_like(gh[keep:])])
    monkeypatch.setattr(gbdt, "_grad_stack", half)


def _alter_leaf(monkeypatch):
    from repro_torch.training import gbdt
    original = gbdt._finish_plain

    def altered(*args, **kw):
        raw, w, val = original(*args, **kw)
        w = w.clone()
        w[0, 0] += 0.25
        return raw, w, val
    monkeypatch.setattr(gbdt, "_finish_plain", altered)


FAULTS = [
    ("covertype-apply", _alter_answer), ("covertype-apply", _half_the_rows),
    ("covertype-apply-mesh4", _alter_answer),
    ("covertype-apply-mesh4", _half_the_rows),
    ("covertype-apply-mesh4", _drop_a_shard),
    ("yearmsd-serve", _alter_answer), ("yearmsd-serve", _half_the_rows),
    ("covertype-train", _state_unchanged),
    ("covertype-train", _half_the_batch), ("covertype-train", _alter_leaf),
]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_fault_under_the_timed_path_is_not_correct(name, fault,
                                                     monkeypatch):
    fault(monkeypatch)
    r = _run(name)
    assert not r["correct"], r["checks"]


# -- BENCHMARK.json's form -------------------------------------------------
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contracts_form():
    s = _spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["bench"] and 1 <= s["run_seconds"] <= 51
    assert (ROOT / s["command"][1]).is_file()
    names = {c["name"] for c in s["configs"]}
    assert names == {w["config"] for w in s["workloads"]}
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and NAME.match(c["name"])
        assert spec.load_json(ROOT / c["file"])["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in s["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(s["workloads"]) // 4)
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    cells = {w["name"] for w in s["workloads"]}
    metrics = s["end_to_end"] + s["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    for m in s["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert callable(spec.metric_reader(m["name"]))
    for name in cells:
        cell = spec.cell(name, ROOT)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        assert {m["moves"] for m in cell.per_layer} <= reported


def test_readers_read_nothing_from_nothing():
    for m in _spec()["per_layer"]:
        assert spec.metric_reader(m["name"])({"window_s": 1.0}) is None


def test_roofline_reader_reads_a_span():
    import costs
    shapes = str([(100, 54), (128, 54), (50, 8), (50, 8), (50, 256, 7)])
    ev = {"ph": "X", "name": "dispatch/fused_predict",
          "args": {"shapes": shapes, "device_ms": 1.0}}
    got = spec.metric_reader("fused_predict_roofline.apply")(
        {"events": [ev]})
    need = costs.bound_s(*costs.fused_predict(100, 54, 128, 50, 8, 7))
    assert got == pytest.approx(100 * need / 1e-3)


# -- data-driven: a cell comes in as new files only -------------------------
def test_a_new_cell_needs_only_new_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    s = _spec()
    s["configs"].append({"name": "tiny", "source": "https://example.org/x",
                         "file": "bench/configs/tiny.json", "reduced": [],
                         "why": "a throwaway"})
    s["workloads"].append({"name": "tiny-apply", "config": "tiny",
                           "traffic": "tiny_mix", "chips": 1,
                           "why": "a throwaway"})
    s["end_to_end"][0]["workloads"].append("tiny-apply")
    s["per_layer"].append({"name": "calls_seen", "unit": "count",
                           "better": "higher", "source": "program_counter",
                           "layer": "plan", "moves": "apply_rows_per_s",
                           "workloads": ["tiny-apply"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    cfg = json.loads((BENCH / "configs" / "covertype.json").read_text())
    cfg.update(name="tiny", trees=5, test_rows=50)
    (tmp_path / "bench" / "configs" / "tiny.json").write_text(
        json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "apply_test_split.json")
                     .read_text())
    (tmp_path / "bench" / "traffic" / "tiny_mix.json").write_text(
        json.dumps(mix))
    (tmp_path / "bench" / "metrics" / "calls_seen.py").write_text(
        "def read(facts):\n    return facts.get('calls')\n")
    code = f"""
import sys, pathlib
sys.path[:0] = [{str(tmp_path / 'bench')!r}, {str(ROOT / 'src')!r}]
from benchlib import harness, spec
cell = spec.cell('tiny-apply', pathlib.Path({str(tmp_path)!r}))
for trace in (False, True):
    r = harness.run_cell(cell, 3, 0.05, trace, kind='cpu')
    assert r['correct'], r['checks']
    print(sorted(r['metrics']))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[:2] == [
        "['apply_rows_per_s', 'setup_s']", "['calls_seen']"]


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"),
                          "--workload", "covertype-apply", "--seed",
                          str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr

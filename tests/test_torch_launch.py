"""The port's launchers and examples, on the CPU at tiny sizes.

  * `repro_torch.launch.train_gbdt` with `--rsm 0.5 --ordered --check`
    exits 0 and prints the JAX launcher's JSON keys (both launchers run
    here); each of the five `--check` contracts fails when broken;
  * `repro_torch.launch.serve`: gbdt mode with tree-slice variants and
    `predict_multi`, `--show-kernels` (the registry's `format_table`, the
    layout table, the resolved layouts), `--mode lm --arch` for a
    decoder and for the encoder-decoder (JAX's line);
  * `examples/torch/{quickstart,serve_gbdt,embeddings_knn}.py`;
  * each launcher's `--trace-out x.json --metrics-out y.prom`: a Chrome
    trace that loads, with the launcher's spans, and the JAX launchers'
    metric namespaces (`training/<name>`, `serving/<name>`,
    `scoring/bulk`).

Each runs with ``--device cpu``; without it they run on the card.
"""
import importlib.util
import json
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import train_gbdt as jtrain_gbdt  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import score, serve, train_gbdt  # noqa: E402
from repro_torch.obs.trace import get_tracer  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAIN = ["--dataset", "covertype", "--scale", "0.002", "--repeat", "3",
         "--trees", "4", "--depth", "3", "--max-bins", "16", "--chunk",
         "256", "--rsm", "0.5", "--ordered", "--check"]


def _json(out: str) -> dict:
    return json.loads(out[out.index("{"):])


def test_train_gbdt_checks_and_prints_the_jax_keys(capsys):
    assert train_gbdt.main(TRAIN + ["--device", "cpu"]) == 0
    captured = capsys.readouterr()
    got = _json(captured.out)
    assert "CHECK OK" in captured.err
    assert got["serve_parity_max_abs"] == 0.0
    assert got["n_chunks"] > 1 and "binarize" not in got["dispatch_delta"]
    assert got["metrics"]["iterations"] == 4
    assert jtrain_gbdt.main(TRAIN + ["--backend", "ref"]) == 0
    want = _json(capsys.readouterr().out)
    assert set(got) == set(want)
    assert set(got["metrics"]) == set(want["metrics"])


def test_train_gbdt_resumes_from_its_checkpoint(tmp_path, capsys):
    ck = ["--ckpt-dir", str(tmp_path), "--device", "cpu"]
    assert train_gbdt.main(TRAIN + ck + ["--ckpt-every", "2"]) == 0
    whole = _json(capsys.readouterr().out)
    assert train_gbdt.main(TRAIN + ck + ["--resume-from", "2"]) == 0
    resumed = _json(capsys.readouterr().out)
    assert resumed["final_metric"] == whole["final_metric"]
    assert resumed["metrics"]["iterations"] == 2
    with pytest.raises(SystemExit):
        train_gbdt.main(TRAIN + ["--resume-from", "2", "--device", "cpu"])


def test_train_gbdt_check_names_each_broken_contract():
    args = types.SimpleNamespace(depth=3)
    source = types.SimpleNamespace(n_rows=100)
    good = {"dispatch_delta": {"histogram": 12}, "hist_first_calls": 3,
            "chunk_rows": 50, "train_loss": np.array([2.0, 1.0])}
    assert train_gbdt.check_failures(args, source, good, 0.0) == []
    bad = {"dispatch_delta": {"binarize": 1}, "hist_first_calls": 4,
           "chunk_rows": 100, "train_loss": np.array([1.0, 1.0])}
    failures = train_gbdt.check_failures(args, source, bad, 1e-3)
    assert [f.split()[0] for f in failures] == [
        "train->serve", "boosting", "the", "source", "train"]


def test_serve_gbdt_mode_on_the_cpu(capsys):
    assert serve.main(["--scale", "0.002", "--trees", "6", "--multi", "3",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "200 sequential requests" in out
    assert "predict_multi(" in out and "x 3 models" in out
    metrics = json.loads(out.split("[serve:gbdt] metrics: ")[1])
    assert metrics["requests"] >= 200


def test_serve_show_kernels(capsys):
    assert serve.main(["--show-kernels", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert registry.format_table() in out
    assert "| layout" in out and "ROADMAP A10" in out
    assert "uniform-depth -> soa, mixed-depth -> depth_grouped, " \
        "huge-mixed -> bitpacked" in out
    assert serve.main(["--show-kernels", "--layout", "bitpacked"]) == 0
    assert "resolved layout: bitpacked" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["glm4-9b", "whisper-small"])
def test_serve_lm_mode_generates_on_the_cpu(arch, capsys):
    # the arch's smoke config, as the JAX launcher serves it
    assert serve.main(["--mode", "lm", "--arch", arch, "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"[serve:lm] {arch}-smoke generated (2, 16) "
                          "tokens in ")


def test_serve_lm_arch_defaults_to_jax_default():
    assert serve.parse_args(["--mode", "lm"]).arch == "glm4-9b"
    with pytest.raises(KeyError, match="unknown arch"):
        serve.main(["--mode", "lm", "--arch", "llama-7b", "--device",
                    "cpu"])


def test_format_table_has_a_row_per_implementation():
    lines = registry.format_table().splitlines()
    assert lines[0].split("|")[1].strip() == "op"
    # the contract checker's verdict sits beside the dispatch count
    cols = [c.strip() for c in lines[0].split("|")[1:-1]]
    assert cols.index("verified") + 1 == cols.index("dispatch_count")
    assert len(lines) == 2 + len(registry.table())
    assert all("| ok" in line for line in lines[2:])


def _example(name: str):
    path = ROOT / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_example(capsys):
    got = _example("quickstart").main(["--device", "cpu", "--scale",
                                       "0.002", "--trees", "5"])
    assert got["float_equals_pool"] and got["staged_vs_fused"] < 1e-4
    assert "staged vs fused max deviation" in capsys.readouterr().out


def test_serve_gbdt_example(capsys):
    got = _example("serve_gbdt").main(["--device", "cpu", "--trees", "5",
                                       "--clients", "3", "--per-client",
                                       "4"])
    assert got["answered"] == got["requests"] == 12
    assert 0 < got["first_calls"] <= got["buckets"]
    out = capsys.readouterr().out
    assert "req/s" in out and "p99=" in out


def test_embeddings_knn_example(capsys):
    got = _example("embeddings_knn").main(["--device", "cpu", "--scale",
                                           "0.05", "--trees", "3"])
    assert 0.0 <= got["accuracy_without_knn"] <= 1.0
    assert 0.0 <= got["accuracy"] <= 1.0
    out = capsys.readouterr().out
    assert "(+21 KNN features)" in out and "without KNN features" in out


def test_launchers_and_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run")
    runs = [lambda: train_gbdt.main(TRAIN),
            lambda: serve.main(["--scale", "0.002", "--trees", "2"]),
            lambda: _example("quickstart").main(["--scale", "0.002",
                                                 "--trees", "2"]),
            lambda: _example("serve_gbdt").main(["--trees", "2"]),
            lambda: _example("embeddings_knn").main(["--scale", "0.05",
                                                     "--trees", "2"])]
    for run in runs:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()


def _obs_run(main, argv, tmp_path):
    """Run a launcher with both obs flags; the trace's event names and
    the metric names of the Prometheus file."""
    trace, prom = tmp_path / "x.json", tmp_path / "y.prom"
    assert main(argv + ["--device", "cpu", "--trace-out", str(trace),
                        "--metrics-out", str(prom)]) == 0
    assert not get_tracer().enabled         # the launcher turned it off
    obj = json.loads(trace.read_text())
    assert obj["otherData"]["dropped_events"] == 0
    names = {e["name"] for e in obj["traceEvents"]}
    gauges = [ln.split("{")[0].split()[0] for ln in
              prom.read_text().splitlines() if not ln.startswith("#")]
    assert gauges
    return names, gauges


@pytest.mark.parametrize("launcher", ["train_gbdt", "serve", "score"])
def test_launcher_obs_flags_write_trace_and_metrics(launcher, tmp_path,
                                                    capsys):
    if launcher == "train_gbdt":
        names, gauges = _obs_run(train_gbdt.main, TRAIN, tmp_path)
        want_spans = {"train/level", "train/iteration",
                      "dispatch/histogram"}
        prefix = "repro_training_gbdt_covertype_"
    elif launcher == "serve":
        names, gauges = _obs_run(serve.main, [
            "--scale", "0.002", "--trees", "6", "--multi", "2"], tmp_path)
        want_spans = {"serve/batch", "train/level", "dispatch/binarize"}
        prefix = "repro_serving_santander_"
        assert any(g.startswith("repro_serving_santander_v1_")
                   for g in gauges)
    else:
        names, gauges = _obs_run(score.main, [
            "--scale", "0.002", "--trees", "4", "--models", "2",
            "--chunk", "256", "--check"], tmp_path)
        want_spans = {"bulk/quantize", "bulk/score", "bulk/sink",
                      "dispatch/binarize", "dispatch/leaf_index"}
        prefix = "repro_scoring_bulk_"
    assert want_spans <= names
    assert "dispatch_count" in names and "thread_name" in names
    assert all(g.startswith(prefix) or g.startswith(prefix[:-1])
               for g in gauges)
    assert "[obs]" in capsys.readouterr().err


def test_launchers_take_the_jax_obs_flags():
    for parse in (lambda a: train_gbdt.parse_args(a)[1], serve.parse_args,
                  score.parse_args):
        args = parse(["--trace-out", "t.json", "--metrics-out", "m.json"])
        assert (args.trace_out, args.metrics_out) == ("t.json", "m.json")
        assert parse([]).trace_out == "" == parse([]).metrics_out

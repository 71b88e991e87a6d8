"""The port's bulk-scoring path against the JAX package's, on the CPU.

Both packages get the same numpy-seeded inputs and the same model, written
by the JAX `ObliviousEnsemble.save` and read by the port's `load`; the JAX
`BulkScorer` scores through the staged `ref` plan, the port's through its
CPU plan.  Integers, bins, borders, chunk spans and class ids must be
equal; floats within rtol = atol = 1e-4 (`tests/test_differential.py:88`:
the two packages sum trees in other orders).  Within the port, a bulk run
equals its own plan's one-shot entry bit for bit.

Carries over the scenarios of `tests/test_scoring.py`: sources, sinks,
`plan_chunks` and `Prefetcher`; the chunked quantizers; `BulkScorer`'s
contracts (<= 2 chunk shapes, one binarize dispatch a chunk a schema,
resume by chunk index, zero rows, a 1-row tail, multi-model fan-out);
`GBDTServer.score_source` and `ModelRegistry.predict_multi`.  The port is
eager, so where the JAX package counts one binarize trace a run the port
counts one binarize dispatch a chunk a schema, never one from a scoring
entry.  `tests/test_torch_scoring_card.py` runs the side-stream pipeline
on the card.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import quantize as jquantize  # noqa: E402
from repro.core import trees as jtrees  # noqa: E402
from repro.core.predictor import PredictConfig as JConfig  # noqa: E402
from repro.core.predictor import Predictor as JPredictor  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro import scoring as jscoring  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.core import quantize  # noqa: E402
from repro_torch.core.predictor import Predictor  # noqa: E402
from repro_torch.core.quantize import QuantizedPool  # noqa: E402
from repro_torch.core.trees import ObliviousEnsemble  # noqa: E402
from repro_torch.data.pipeline import Prefetcher  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.scoring import (ArraySink, ArraySource,  # noqa: E402
                                 BulkScorer, NpyMemmapSource, NpySink,
                                 ScoreConfig, ScoringMetrics, StatsSink,
                                 SyntheticSource, TopKSink, iter_chunks,
                                 plan_chunks)
from repro_torch.serving.engine import GBDTServer, ModelRegistry  # noqa: E402
from repro_torch.serving.metrics import PercentileReservoir  # noqa: E402

torch.set_num_threads(1)

RTOL = ATOL = 1e-4


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _arrays(seed=3, n_trees=13, depth=4, n_features=11, n_borders=9,
            n_outputs=2):
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
        "base_score": rng.normal(scale=0.1, size=(n_outputs,))
        .astype(np.float32),
    }


def _models(tmp_path, **kw):
    """(JAX ensemble, port ensemble) through one `.npz` the JAX package
    saved."""
    jens = jtrees.ObliviousEnsemble(**{k: jnp.asarray(v)
                                       for k, v in _arrays(**kw).items()})
    path = tmp_path / f"model_{abs(hash(tuple(sorted(kw.items()))))}.npz"
    jens.save(path)
    return jens, ObliviousEnsemble.load(path)


def _rand_x(n_features, n=37, seed=0):
    rng = np.random.default_rng(seed)
    return np.asarray(rng.normal(size=(n, n_features)), np.float32)


def _jplan(jens):
    return JPredictor.build(jens, JConfig(strategy="staged", backend="ref"))


def _plan(ens):
    return Predictor.build(ens, device="cpu")


# --------------------------------------------------------------------------
# Prefetcher
# --------------------------------------------------------------------------
def _bad_source():
    yield 1
    yield 2
    raise RuntimeError("disk on fire")


@pytest.mark.parametrize("make,transform,error", [
    (_bad_source, None, RuntimeError),
    (lambda: iter(range(5)), lambda i: 1 // (i - 2), ZeroDivisionError),
    (lambda: iter(range(7)), lambda i: i * i, None),
], ids=["source_raises", "transform_raises", "normal"])
def test_prefetcher_matches_jax(make, transform, error):
    """Items before an error arrive in order, then the worker's exception
    reaches the consumer; a clean stream arrives whole.  Both packages
    deliver the same items."""
    streams = []
    for cls in (Prefetcher, jpipeline.Prefetcher):
        got = []
        pf = cls(make(), depth=2, transform=transform)
        if error is None:
            got = list(pf)
        else:
            with pytest.raises(error):
                for item in pf:
                    got.append(item)
        streams.append(got)
    assert streams[0] == streams[1]
    if error is None:
        assert streams[0] == [i * i for i in range(7)]


def test_prefetcher_close_stops_the_worker():
    """`close` mid-stream leaves no worker behind, even one blocked on a
    full queue."""
    started = threading.Event()

    def endless():
        i = 0
        while True:
            started.set()
            yield i
            i += 1

    pf = Prefetcher(endless(), depth=2)
    assert started.wait(timeout=10)
    it = iter(pf)
    assert next(it) == 0
    pf.close()
    assert not pf.thread.is_alive()
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(iter(()), depth=0)


# --------------------------------------------------------------------------
# Chunked quantization helpers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [1, 16, 103])
def test_quantize_pool_chunked_bins_equal_jax(tmp_path, chunk):
    jens, ens = _models(tmp_path)
    x = _rand_x(ens.n_features, 103)
    want = jquantize.quantize_pool_chunked(
        (x[s:s + chunk] for s in range(0, len(x), chunk)), jens.borders)
    seen = []

    def watched():
        for s in range(0, len(x), chunk):
            seen.append(len(x[s:s + chunk]))
            yield x[s:s + chunk]

    got = quantize.quantize_pool_chunked(watched(), ens.borders,
                                         device="cpu")
    assert max(seen) <= chunk               # never a dataset-sized slab
    assert got.fingerprint == want.fingerprint
    assert got.bins.dtype == torch.uint8
    np.testing.assert_array_equal(got.bins.numpy(), np.asarray(want.bins))
    full = quantize.quantize_pool(torch.from_numpy(x), ens.borders)
    assert torch.equal(got.bins, full.bins)


def test_quantize_pool_chunked_validates(tmp_path):
    _, ens = _models(tmp_path)
    with pytest.raises(ValueError, match="match"):
        quantize.quantize_pool_chunked(
            iter([np.zeros((4, ens.n_features + 1), np.float32)]),
            ens.borders, device="cpu")
    empty = quantize.quantize_pool_chunked(iter([]), ens.borders,
                                           device="cpu")
    assert empty.n_rows == 0 and empty.n_features == ens.n_features
    with pytest.raises(ValueError, match="uint8"):
        quantize.quantize_pool_chunked(
            iter([]), torch.zeros((256, 2)), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            quantize.quantize_pool_chunked(iter([]), ens.borders)


@pytest.mark.parametrize("n,chunk,sample_rows,max_bins", [
    (150, 40, 1024, 16),       # under the sample cap: exact
    (500, 100, 128, 8),        # over it: the reservoir's draws
    (700, 33, 64, 64),
])
def test_compute_borders_chunked_equals_jax(n, chunk, sample_rows,
                                            max_bins):
    x = _rand_x(5, n, seed=5)
    got_b, got_c = quantize.compute_borders_chunked(
        (x[s:s + chunk] for s in range(0, n, chunk)), max_bins,
        sample_rows=sample_rows)
    want_b, want_c = jquantize.compute_borders_chunked(
        (x[s:s + chunk] for s in range(0, n, chunk)), max_bins,
        sample_rows=sample_rows)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    if n <= sample_rows:
        b, c = quantize.compute_borders(x, max_bins)
        assert torch.equal(got_b, b) and torch.equal(got_c, c)
    with pytest.raises(ValueError, match="non-empty"):
        quantize.compute_borders_chunked(iter([]))


# --------------------------------------------------------------------------
# Sources
# --------------------------------------------------------------------------
def test_array_and_memmap_sources_match_jax(tmp_path):
    x = np.random.default_rng(0).normal(size=(23, 5)).astype(np.float32)
    path = tmp_path / "x.npy"
    np.save(path, x)
    for ours, theirs in ((ArraySource(x), jscoring.ArraySource(x)),
                         (NpyMemmapSource(path),
                          jscoring.NpyMemmapSource(path))):
        assert (ours.n_rows, ours.n_features) == (23, 5)
        np.testing.assert_array_equal(ours.read(4, 9), theirs.read(4, 9))
        got = list(iter_chunks(ours, 4, start_row=2))
        want = list(jscoring.iter_chunks(theirs, 4, start_row=2))
        assert [c.shape for c in got] == [c.shape for c in want]
        np.testing.assert_array_equal(np.concatenate(got), x[2:])
        with pytest.raises(ValueError, match="span"):
            ours.read(5, 24)
    with pytest.raises(ValueError, match="chunk_rows"):
        list(iter_chunks(ArraySource(x), 0))


@pytest.mark.parametrize("split", ["train", "test", "all"])
def test_synthetic_source_matches_jax(split):
    src = SyntheticSource("covertype", scale=0.001, split=split, repeat=3)
    jsrc = jscoring.SyntheticSource("covertype", scale=0.001, split=split,
                                    repeat=3)
    base = src.base_rows
    assert (src.n_rows, base) == (jsrc.n_rows, jsrc.base_rows)
    assert src.n_rows == 3 * base
    # a span crossing the tile boundary stitches correctly
    np.testing.assert_array_equal(src.read(base - 2, base + 2),
                                  jsrc.read(base - 2, base + 2))
    np.testing.assert_array_equal(src.read(base, base + 5), src.read(0, 5))
    assert src.read(3, 3).shape == (0, 54)
    with pytest.raises(ValueError, match="repeat"):
        SyntheticSource("covertype", scale=0.001, repeat=0)


# --------------------------------------------------------------------------
# Sinks
# --------------------------------------------------------------------------
def test_npy_sink_write_and_resume(tmp_path):
    path = tmp_path / "scores.npy"
    sink = NpySink(path)
    sink.open(6, 2)
    sink.write(0, np.ones((3, 2), np.float32))
    assert sink.close() == path
    sink2 = NpySink(path, resume=True)
    sink2.open(6, 2)
    sink2.write(3, 2 * np.ones((3, 2), np.float32))
    sink2.close()
    out = np.load(path)
    np.testing.assert_array_equal(out[:3], 1.0)
    np.testing.assert_array_equal(out[3:], 2.0)
    with pytest.raises(ValueError, match="resume"):
        NpySink(path, resume=True).open(7, 2)


@pytest.mark.parametrize("make", [
    lambda m: m.StatsSink(),
    lambda m: m.TopKSink(5, column=1),
    lambda m: m.TopKSink(3, column=1, largest=False),
], ids=["stats", "top5", "bottom3"])
def test_streaming_sinks_match_jax(make):
    import repro_torch.scoring as tscoring

    rng = np.random.default_rng(2)
    ys = rng.normal(size=(70, 2)).astype(np.float32) * [1, 10]
    outs = []
    for mod in (tscoring, jscoring):
        sink = make(mod)
        sink.open(70, 2)
        for s in range(0, 70, 9):
            sink.write(s, ys[s:s + 9])
        outs.append(sink.close())
    got, want = outs
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))


def test_sink_write_validation():
    sink = ArraySink()
    with pytest.raises(ValueError, match="before"):
        sink.write(0, np.zeros((1, 2), np.float32))
    sink.open(4, 2)
    with pytest.raises(ValueError, match="width"):
        sink.write(0, np.zeros((1, 3), np.float32))
    with pytest.raises(ValueError, match="span"):
        sink.write(3, np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="k must"):
        TopKSink(0)


# --------------------------------------------------------------------------
# Chunk planning
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_rows,chunk_rows", [
    (0, 32), (1, 32), (33, 32), (100, 32), (10_000, 1024), (5, 256),
    (1_115_520, 4096), (70, 100)])
def test_plan_chunks_equals_jax(n_rows, chunk_rows):
    got = plan_chunks(n_rows, chunk_rows)
    want = jscoring.plan_chunks(n_rows, chunk_rows)
    assert [(s.index, s.start, s.stop, s.padded) for s in got] == \
        [(s.index, s.start, s.stop, s.padded) for s in want]
    assert len({s.padded for s in got}) <= 2
    assert all(s.n_valid <= s.padded for s in got)


# --------------------------------------------------------------------------
# BulkScorer: parity with JAX and with the port's own plan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("output", ["raw", "proba", "classify"])
@pytest.mark.parametrize("prequantize", [True, False],
                         ids=["pool", "float"])
@pytest.mark.parametrize("depth", [0, 2])
def test_bulk_scorer_matches_jax_and_one_shot(tmp_path, output,
                                              prequantize, depth):
    jens, ens = _models(tmp_path, n_outputs=3)
    x = _rand_x(ens.n_features, 150)
    cfg = dict(chunk_rows=64, output=output, prequantize=prequantize,
               prefetch_depth=depth)
    plan = _plan(ens)
    res = BulkScorer(plan, ScoreConfig(**cfg)).score(ArraySource(x))
    want = jscoring.BulkScorer(_jplan(jens), jscoring.ScoreConfig(**cfg)) \
        .score(jscoring.ArraySource(x))
    assert res.chunk_shapes == want.chunk_shapes == (32, 64)
    assert res.output.shape == want.output.shape
    # on the CPU the worker runs at the configured depth at any chunk size
    assert res.metrics["prefetch_depth"] == depth
    if output == "classify":
        np.testing.assert_array_equal(res.output, want.output)
    else:
        _close(res.output, want.output)
    # each entry saw at most the two padded shapes
    assert all(v <= 2 for k, v in plan.stats["traces"].items()
               if k != "quantize")
    one_shot = getattr(plan, output)(x).numpy().astype(np.float32)
    np.testing.assert_array_equal(res.output,
                                  one_shot.reshape(res.output.shape))


def test_bulk_scorer_one_binarize_dispatch_a_chunk_on_the_pool_path(
        tmp_path):
    """The prequantized pipeline binarizes only through the worker's
    quantize entry: one binarize dispatch a chunk (the tail quantized at
    the full chunk shape, then sliced), never one from a scoring entry,
    and the float entry unused."""
    _, ens = _models(tmp_path)
    plan = _plan(ens)
    x = _rand_x(ens.n_features, 150)
    registry.reset_call_stats()
    res = BulkScorer(plan, ScoreConfig(chunk_rows=64, output="raw")) \
        .score(ArraySource(x))
    stats = registry.call_stats()
    assert res.metrics["chunks"] == 3
    assert stats.get("binarize", 0) == 3, stats
    assert stats.get("leaf_index", 0) == 3, stats
    assert plan.stats["traces"].get("quantize", 0) == 1
    assert plan.stats["traces"].get("raw", 0) == 0
    assert plan.stats["traces"].get("raw_pool", 0) == 2
    assert res.chunk_shapes == (32, 64)
    assert res.metrics["compiles"] == 3


@pytest.mark.parametrize("n,chunk,shapes", [
    (0, 32, ()), (5, 256, (16,)), (33, 32, (16, 32)), (1, 32, (16,))],
    ids=["zero_rows", "sub_chunk", "one_row_tail", "one_row"])
def test_degenerate_sources(tmp_path, n, chunk, shapes):
    jens, ens = _models(tmp_path)
    plan = _plan(ens)
    x = _rand_x(ens.n_features, n)
    res = BulkScorer(plan, ScoreConfig(chunk_rows=chunk, output="raw")) \
        .score(ArraySource(x))
    assert res.output.shape == (n, 2)
    assert res.chunk_shapes == shapes
    assert res.metrics["chunks"] == len(plan_chunks(n, chunk))
    assert plan.stats["traces"].get("raw_pool", 0) <= 2
    if n:
        np.testing.assert_array_equal(res.output, plan.raw(x).numpy())
        _close(res.output, np.asarray(_jplan(jens).raw(jnp.asarray(x))))
    else:
        assert res.metrics["compiles"] == 0        # no call for no data


def test_predict_pool_on_zero_row_pool(tmp_path):
    _, ens = _models(tmp_path)
    server = GBDTServer(ens, device="cpu", max_batch=32)
    try:
        pool = QuantizedPool(torch.zeros((0, ens.n_features),
                                         dtype=torch.uint8),
                             server.schema_fingerprint)
        assert server.predict_pool(pool).shape == (0, 2)
    finally:
        server.close()


def test_multi_model_quantizes_once_a_schema(tmp_path):
    jens, ens = _models(tmp_path, n_trees=12)
    names = ("full", "head", "tail")
    cuts = ((0, 12), (0, 6), (6, 12))
    plans = {n: _plan(ens.slice_trees(a, b)) for n, (a, b) in
             zip(names, cuts)}
    x = _rand_x(ens.n_features, 64)
    registry.reset_call_stats()
    res = BulkScorer(plans, ScoreConfig(chunk_rows=32, output="raw")) \
        .score(ArraySource(x))
    # 3 plans, 1 shared schema, 2 chunks -> 2 binarize dispatches
    assert registry.call_stats().get("binarize", 0) == 2
    q = {n: p.stats["traces"].get("quantize", 0) for n, p in plans.items()}
    assert sum(q.values()) == 1, q
    jres = jscoring.BulkScorer(
        {n: _jplan(jens.slice_trees(a, b)) for n, (a, b) in
         zip(names, cuts)},
        jscoring.ScoreConfig(chunk_rows=32, output="raw")) \
        .score(jscoring.ArraySource(x))
    for n in names:
        _close(res.outputs[n], jres.outputs[n])
    base = ens.base_score.numpy()
    _close(res.outputs["head"] + res.outputs["tail"] - base,
           res.outputs["full"])


@pytest.mark.parametrize("depth", [0, 2])
def test_pool_and_float_groups_in_one_run(tmp_path, depth):
    """A model past 255 borders has no uint8 pool and takes the float
    route beside a pooled one, also where the tail's bucket outgrows a
    chunk that is not a power of two (170 rows in chunks of 100: the tail
    pads to 128)."""
    jwide, wide = _models(tmp_path, seed=4, n_borders=300, n_features=11)
    jens, ens = _models(tmp_path)
    x = _rand_x(11, 170)
    plans = {"wide": _plan(wide), "pooled": _plan(ens)}
    registry.reset_call_stats()
    res = BulkScorer(plans, ScoreConfig(chunk_rows=100, output="raw",
                                        prefetch_depth=depth)) \
        .score(ArraySource(x))
    assert res.chunk_shapes == (100, 128)
    for name, p in plans.items():
        np.testing.assert_array_equal(res.outputs[name], p.raw(x).numpy())
    assert plans["wide"].stats["traces"].get("raw_pool", 0) == 0
    assert plans["pooled"].stats["traces"]["quantize"] == 1
    _close(res.outputs["wide"],
           np.asarray(_jplan(jwide).raw(jnp.asarray(x))))


def test_scorer_rejects_bad_plans_config_and_sinks(tmp_path):
    _, a = _models(tmp_path, n_features=11)
    _, b = _models(tmp_path, seed=7, n_features=9)
    plan = _plan(a)
    with pytest.raises(ValueError, match="feature count"):
        BulkScorer({"a": plan, "b": _plan(b)})
    with pytest.raises(ValueError, match="output"):
        ScoreConfig(output="logits")
    with pytest.raises(TypeError, match="not both"):
        BulkScorer(plan, ScoreConfig(), chunk_rows=64)
    with pytest.raises(ValueError, match="at least one"):
        BulkScorer({})
    with pytest.raises(TypeError, match="Predictor"):
        BulkScorer({"a": a})
    with pytest.raises(NotImplementedError, match="A7"):
        BulkScorer(plan, mesh=object())
    scorer = BulkScorer({"a": plan, "b": plan})
    with pytest.raises(ValueError, match="no sink"):
        scorer.score(ArraySource(_rand_x(11, 8)), {"a": ArraySink()})
    with pytest.raises(ValueError, match="single"):
        scorer.score(ArraySource(_rand_x(11, 8)), ArraySink())
    with pytest.raises(ValueError, match="features"):
        scorer.score(ArraySource(_rand_x(9, 8)))


def test_resume_by_chunk_index(tmp_path):
    jens, ens = _models(tmp_path)
    plan = _plan(ens)
    x = _rand_x(ens.n_features, 100)
    path = tmp_path / "scores.npy"
    cfg = ScoreConfig(chunk_rows=32, output="raw")
    BulkScorer(plan, cfg).score(ArraySource(x), NpySink(path))
    want = np.load(path).copy()
    jpath = tmp_path / "jax_scores.npy"
    jscoring.BulkScorer(_jplan(jens), jscoring.ScoreConfig(
        chunk_rows=32, output="raw")).score(jscoring.ArraySource(x),
                                            jscoring.NpySink(jpath))
    _close(want, np.load(jpath))

    # an interrupted run: chunks 0-1 (rows [0, 64)) landed, then the
    # process died; resume at chunk 2 into the surviving file
    partial = tmp_path / "resumed.npy"
    mm = np.lib.format.open_memmap(partial, mode="w+", dtype=np.float32,
                                   shape=want.shape)
    mm[:64] = want[:64]
    mm.flush()
    del mm
    res = BulkScorer(plan, cfg).score(
        ArraySource(x), NpySink(partial, resume=True), resume_from=2)
    assert res.metrics["resumed_from"] == 2
    assert res.metrics["rows"] == 100 - 64
    np.testing.assert_array_equal(np.load(partial), want)
    with pytest.raises(ValueError, match="resume_from"):
        BulkScorer(plan, cfg).score(ArraySource(x), resume_from=99)


class _FailingSource(ArraySource):
    def read(self, start, stop):
        if start >= 64:
            raise OSError("disk on fire")
        return super().read(start, stop)


@pytest.mark.parametrize("depth", [0, 2])
def test_a_worker_error_reaches_the_caller(tmp_path, depth):
    """A failed read on the prefetch worker ends the run with its error,
    never as a clean, shorter stream."""
    _, ens = _models(tmp_path)
    sink = ArraySink()
    with pytest.raises(OSError, match="disk on fire"):
        BulkScorer(_plan(ens), ScoreConfig(chunk_rows=32, output="raw",
                                           prefetch_depth=depth)) \
            .score(_FailingSource(_rand_x(ens.n_features, 150)), sink)
    assert sink.rows_written <= 64


def test_bulk_scorer_through_streaming_sinks(tmp_path):
    _, ens = _models(tmp_path)
    plan = _plan(ens)
    x = _rand_x(ens.n_features, 80)
    want = plan.raw(x).numpy()
    res = BulkScorer(plan, ScoreConfig(chunk_rows=32, output="raw")) \
        .score(ArraySource(x), StatsSink())
    assert res.output["count"] == 80
    np.testing.assert_allclose(res.output["mean"], want.mean(0),
                               rtol=1e-6, atol=1e-6)
    top = BulkScorer(plan, ScoreConfig(chunk_rows=32, output="raw")) \
        .score(ArraySource(x), TopKSink(4, column=0))
    np.testing.assert_array_equal(top.output["indices"],
                                  np.argsort(-want[:, 0],
                                             kind="stable")[:4])


# --------------------------------------------------------------------------
# score_source, ModelRegistry, metrics
# --------------------------------------------------------------------------
def test_server_score_source_matches_predict_batch_and_jax(tmp_path):
    jens, ens = _models(tmp_path, n_outputs=3)
    server = GBDTServer(ens, device="cpu", max_batch=32)
    jserver = jengine.GBDTServer(jens, config=JConfig(strategy="staged",
                                                      backend="ref"),
                                 max_batch=32)
    try:
        x = _rand_x(ens.n_features, 70)
        res = server.score_source(ArraySource(x), chunk_rows=32)
        np.testing.assert_array_equal(res.output, server.predict_batch(x))
        _close(res.output, jserver.score_source(jscoring.ArraySource(x),
                                                chunk_rows=32).output)
        assert "rows_per_s" in res.metrics
        assert "rows_per_s" in server.metrics.snapshot()
        with pytest.raises(TypeError, match="not both"):
            server.score_source(ArraySource(x), config=ScoreConfig(),
                                chunk_rows=32)
    finally:
        server.close()
        jserver.close()


def test_model_registry_predict_multi_quantizes_once(tmp_path):
    jens, ens = _models(tmp_path, n_trees=12, n_outputs=3)
    reg = ModelRegistry(device="cpu", max_batch=32)
    jreg = jengine.ModelRegistry(config=JConfig(strategy="staged",
                                                backend="ref"),
                                 max_batch=32)
    try:
        for name, (a, b) in (("full", (0, 12)), ("half", (0, 6))):
            reg.register(name, ens.slice_trees(a, b))
            jreg.register(name, jens.slice_trees(a, b))
        _, other = _models(tmp_path, seed=9, n_trees=5, n_outputs=3)
        path = tmp_path / "other.npz"
        other.save(path)
        reg.load("other", path)
        assert reg.names() == ["full", "half", "other"]
        x = _rand_x(ens.n_features, 40)
        registry.reset_call_stats()
        got = reg.predict_multi(x)
        # two schemas -> two binarize dispatches for three models
        assert registry.call_stats().get("binarize", 0) == 2
        want = jreg.predict_multi(x)
        for name in ("full", "half"):
            np.testing.assert_array_equal(got[name],
                                          reg.predict_batch(name, x))
            _close(got[name], want[name])
        np.testing.assert_array_equal(got["other"],
                                      reg.predict_batch("other", x))
        _close(reg.predict("half", x[0]), want["half"][0])
        assert set(reg.metrics()) == {"full", "half", "other"}
        with pytest.raises(KeyError, match="already"):
            reg.register("full", ens)
        reg.register("full", ens.slice_trees(0, 3), replace=True)
        np.testing.assert_array_equal(
            reg.predict_batch("full", x),
            GBDTServer(ens.slice_trees(0, 3), device="cpu",
                       max_batch=32).predict_batch(x))
        reg.unregister("other")
        with pytest.raises(KeyError, match="unknown"):
            reg.get("other")
        with pytest.raises(NotImplementedError, match="A7"):
            reg.register("r", ens, replicas=2)
    finally:
        reg.close()
        jreg.close()
    assert reg.names() == []


def test_scoring_metrics_snapshot():
    m = ScoringMetrics("job")
    m.start()
    m.note_quantize(0.01)
    m.note_chunk(100, 128, 0.02)
    m.stop()
    snap = m.snapshot()
    assert snap["rows"] == 100 and snap["chunks"] == 1
    assert snap["rows_per_s"] > 0
    assert 0.0 < snap["quantize_frac"] < 1.0
    assert snap["pad_overhead"] == pytest.approx(28 / 128)
    assert isinstance(m._chunk_lat, PercentileReservoir)
    # a second snapshot's interval rate counts only rows since the first
    assert m.snapshot()["interval_rows_per_s"] == 0.0

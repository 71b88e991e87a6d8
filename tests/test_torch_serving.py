"""The port's `GBDTServer` against the JAX package's, on the CPU.

Both servers get the same numpy-seeded Covertype-shaped model (F = 54,
C = 7, depth 4, 24 trees); the JAX one scores through the staged `ref`
plan on the `soa` layout, the port's through its CPU plan.  Probabilities
match within rtol = atol = 1e-4 (trees summed in another order); the
bucketing layer keeps the port's first-call counter within the bucket
count, as it keeps the JAX package's trace counter.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import trees as jtrees  # noqa: E402
from repro.core.predictor import PredictConfig as JConfig  # noqa: E402
from repro.serving import batching as jbatching  # noqa: E402
from repro.serving import metrics as jmetrics  # noqa: E402
from repro.serving.engine import GBDTServer as JServer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.quantize import compute_borders  # noqa: E402
from repro_torch.data.synthetic import covertype  # noqa: E402
from repro_torch.serving import batching, metrics  # noqa: E402
from repro_torch.serving.engine import GBDTServer  # noqa: E402

torch.set_num_threads(1)

F, C, D, T = 54, 7, 4, 24


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    """(JAX ensemble, port ensemble, test rows) from one numpy seed."""
    data = covertype(scale=0.003, seed=1)
    borders, n_borders = compute_borders(data.x_train, 64)
    rng = np.random.default_rng(2)
    sf = rng.integers(0, F, (T, D)).astype(np.int32)
    sb = (1 + rng.random((T, D)) * np.maximum(n_borders.numpy()[sf], 1)
          ).astype(np.int32)
    arrays = {"split_features": sf, "split_bins": sb,
              "leaf_values": rng.normal(scale=0.3, size=(T, 1 << D, C))
              .astype(np.float32),
              "borders": borders.numpy(), "n_borders": n_borders.numpy(),
              "base_score": rng.normal(scale=0.1, size=(C,))
              .astype(np.float32)}
    jens = jtrees.ObliviousEnsemble(**{k: jnp.asarray(v)
                                       for k, v in arrays.items()})
    return jens, convert.ensemble_from_numpy(arrays), data.x_test[:150]


@pytest.fixture
def servers(model):
    jens, tens, _ = model
    jserver = JServer(jens, config=JConfig(strategy="staged", backend="ref",
                                           layout="soa"), max_batch=64)
    server = GBDTServer(tens, device="cpu", max_batch=64)
    yield jserver, server
    jserver.close()
    server.close()


def test_predict_batch_matches_jax(model, servers):
    _, _, x = model
    jserver, server = servers
    got = server.predict_batch(x)          # chunks of 64, 64, 22
    assert got.shape == (len(x), C) and got.dtype == np.float32
    _close(got, jserver.predict_batch(x))
    assert server.metrics.snapshot()["batches"] == 3
    assert server.predict_batch(x[:0]).shape == (0, C)


def test_single_requests_match_jax(model, servers):
    _, _, x = model
    jserver, server = servers
    for i in (0, 7, 42):
        got = server.predict(x[i])
        assert got.shape == (C,)
        _close(got, jserver.predict(x[i]))


def test_predict_pool_matches_jax(model, servers):
    _, _, x = model
    jserver, server = servers
    pool = server.quantize(x)
    jpool = jserver.quantize(x)
    np.testing.assert_array_equal(pool.bins.numpy(), np.asarray(jpool.bins))
    assert pool.fingerprint == jpool.fingerprint == server.schema_fingerprint
    got = server.predict_pool(pool)
    _close(got, jserver.predict_pool(jpool))
    _close(got, server.predict_batch(x))
    assert server.predict_pool(pool.slice_rows(0, 0)).shape == (0, C)


def test_recompiles_bounded_by_buckets(model):
    _, tens, x = model
    server = GBDTServer(tens, device="cpu", max_batch=64, buckets=(16, 64))
    try:
        sizes = (3, 5, 9, 16, 17, 33, 50, 64, 2, 40)
        for n in sizes:
            assert server.predict_batch(x[:n]).shape == (n, C)
        server.predict_pool(server.quantize(x[:70]))     # 64 + 6 rows
        snap = server.metrics.snapshot()
        # proba and proba_pool, each at most once per bucket, + quantize
        assert snap["recompiles"] <= 2 * len(server.buckets) + 1, snap
        assert server.predictor.stats["traces"]["proba"] <= \
            len(server.buckets)
        assert snap["batches"] == len(sizes) + 2
        assert snap["requests"] == sum(sizes) + 70
    finally:
        server.close()


def test_server_config_and_refusals(model):
    _, tens, _ = model
    server = GBDTServer(tens, device="cpu", max_batch=32, strategy="fused")
    try:
        assert (server.config.strategy, server.config.backend,
                server.config.layout) == ("fused", "torch_ref", "soa")
        assert server.buckets == (16, 32)
        assert server.metrics.layout == "soa"
    finally:
        server.close()
    # not a mesh: fails as in the JAX package, with no axis sizes to read
    with pytest.raises(AttributeError, match="shape"):
        GBDTServer(tens, device="cpu", mesh=object())


@pytest.mark.parametrize("max_batch,min_bucket",
                         [(256, 16), (100, 16), (1, 4), (5, 1)])
def test_batching_helpers_match_jax(max_batch, min_bucket):
    buckets = batching.pow2_buckets(max_batch, min_bucket)
    assert buckets == jbatching.pow2_buckets(max_batch, min_bucket)
    for n in range(1, buckets[-1] + 1):
        assert batching.bucket_for(n, buckets) == \
            jbatching.bucket_for(n, buckets)
    assert list(batching.chunks(2 * max_batch + 3, max_batch)) == \
        list(jbatching.chunks(2 * max_batch + 3, max_batch))
    xs = np.ones((1, 3), np.float32)
    np.testing.assert_array_equal(batching.pad_rows(xs, buckets[-1]),
                                  jbatching.pad_rows(xs, buckets[-1]))


def test_metrics_snapshot_keys_match_jax():
    snaps = []
    for mod in (metrics, jmetrics):
        m = mod.ServerMetrics("m", deadline_ms=5.0)
        m.note_batch(3, 16, 0.002)
        m.note_batch(20, 32, 0.010)
        m.note_trace()
        m.note_shed()
        snaps.append(m.snapshot())
    assert set(snaps[0]) == set(snaps[1])
    for k in ("requests", "batches", "recompiles", "deadline_attainment",
              "shed_rate"):
        assert snaps[0][k] == snaps[1][k], k

"""The port's prediction plan against the JAX package's, on the CPU.

A small Covertype-shaped model (F = 54, C = 7, depth 4, 24 trees, a third
of them truncated) is built once from a numpy seed and handed to both
packages.  The JAX plan is `Predictor(strategy="staged", backend="ref",
layout="soa")`.  Integer outputs (pool bins, classify, fingerprints) match
exactly; raw scores and probabilities within rtol = atol = 1e-4, since the
port sums trees in another order than XLA.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import quantize as jquantize  # noqa: E402
from repro.core import trees as jtrees  # noqa: E402
from repro.core.predictor import Predictor as JPredictor  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import quantize as tquantize  # noqa: E402
from repro_torch.core import trees as ttrees  # noqa: E402
from repro_torch.core.predictor import (PredictConfig,  # noqa: E402
                                        Predictor)
from repro_torch.data import synthetic as tsynthetic  # noqa: E402
from repro_torch.serving.engine import GBDTServer  # noqa: E402

torch.set_num_threads(1)

F, C, D, T, N = 54, 7, 4, 24, 300
FIELDS = ("split_features", "split_bins", "leaf_values", "borders",
          "n_borders", "base_score")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def _arrays(ens):
    return {k: np.asarray(getattr(ens, k)) for k in FIELDS}


def _models(n_outputs=C, seed=5):
    """(JAX ensemble, port ensemble, x) from one numpy seed: borders from
    the synthetic Covertype train split, random splits and leaves, a
    third of the trees truncated, 2% NaN in x."""
    data = tsynthetic.covertype(scale=0.003, seed=seed)
    borders, n_borders = tquantize.compute_borders(data.x_train, 64)
    rng = np.random.default_rng(seed)
    sf = rng.integers(0, F, (T, D)).astype(np.int32)
    width = np.maximum(n_borders.numpy()[sf], 1)
    sb = (1 + rng.random((T, D)) * width).astype(np.int32)
    lv = rng.normal(scale=0.3, size=(T, 1 << D, n_outputs))
    base = rng.normal(scale=0.1, size=(n_outputs,))
    jens = jtrees.ObliviousEnsemble(
        jnp.asarray(sf), jnp.asarray(sb), jnp.asarray(lv, jnp.float32),
        jnp.asarray(borders.numpy()), jnp.asarray(n_borders.numpy()),
        jnp.asarray(base, jnp.float32))
    depths = np.full(T, D)
    cut = rng.choice(T, T // 3, replace=False)
    depths[cut] = rng.integers(0, D, cut.size)
    jens = jtrees.truncate_tree_depths(jens, depths)
    tens = convert.ensemble_from_numpy(_arrays(jens))
    x = data.x_test[:N].copy()
    x[rng.random(x.shape) < 0.02] = np.nan
    return jens, tens, x


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def jax_plan(models):
    return JPredictor.build(models[0], strategy="staged", backend="ref",
                            layout="soa")


@pytest.mark.parametrize("strategy,backend", [
    ("auto", "auto"), ("fused", "torch_ref"), ("staged", "torch_ref"),
    ("fused", "auto")])
def test_plan_matches_jax_staged_ref(models, jax_plan, strategy, backend):
    _, tens, x = models
    plan = Predictor.build(tens, device="cpu", strategy=strategy,
                           backend=backend)
    _close(plan.raw(x), jax_plan.raw(x))
    _close(plan.proba(x), jax_plan.proba(x))
    got = plan.classify(x)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_plan.classify(x)))


def test_auto_resolves_to_staged_plain_soa_on_cpu(models):
    plan = Predictor.build(models[1], device="cpu")
    cfg = plan.config
    assert (cfg.strategy, cfg.backend, cfg.layout) == ("staged",
                                                       "torch_ref", "soa")
    assert plan.lowered.split_features.shape[0] == T     # no padding
    with pytest.raises(ValueError, match="CPU"):
        Predictor.build(models[1], device="cpu", backend="cuda")


def test_pool_bins_scores_and_fingerprint_match_jax(models, jax_plan):
    _, tens, x = models
    plan = Predictor.build(tens, device="cpu")
    pool = plan.quantize(x)
    jpool = jax_plan.quantize(x)
    assert pool.bins.dtype == torch.uint8
    np.testing.assert_array_equal(pool.bins.numpy(), np.asarray(jpool.bins))
    assert isinstance(pool.fingerprint, str)
    assert pool.fingerprint == jpool.fingerprint == jax_plan.schema_fingerprint
    assert plan.schema_fingerprint == jax_plan.schema_fingerprint
    _close(plan.raw(pool), jax_plan.raw(jpool))
    np.testing.assert_array_equal(plan.classify(pool).numpy(),
                                  np.asarray(jax_plan.classify(jpool)))
    # the pools are interchangeable: each package scores the other's
    _close(jax_plan.raw(jquantize.QuantizedPool(
        jnp.asarray(pool.bins.numpy()), pool.fingerprint)), plan.raw(pool))
    standalone = tquantize.quantize_pool(x, tens.borders)
    assert standalone.fingerprint == pool.fingerprint
    assert torch.equal(standalone.bins, pool.bins)


def test_fingerprint_hashes_the_numpy_shape(models):
    jens, tens, _ = models
    assert tquantize.borders_fingerprint(tens.borders) == \
        jquantize.borders_fingerprint(jens.borders)
    assert tquantize.borders_fingerprint(tens.borders.numpy()) == \
        tquantize.borders_fingerprint(tens.borders)


def test_fingerprint_mismatch_raises(models):
    _, tens, x = models
    plan = Predictor.build(tens, device="cpu")
    other = Predictor.build(
        ttrees.ObliviousEnsemble(tens.split_features, tens.split_bins,
                                 tens.leaf_values, tens.borders + 0.5,
                                 tens.n_borders, tens.base_score),
        device="cpu")
    assert other.schema_fingerprint != plan.schema_fingerprint
    pool = plan.quantize(x)
    for entry in (other.raw, other.proba, other.classify):
        with pytest.raises(ValueError, match="fingerprint"):
            entry(pool)


def test_jax_npz_loads_in_the_port_and_back(models, tmp_path):
    jens, tens, x = models
    jens.save(tmp_path / "jax.npz")
    loaded = convert.ensemble_from_jax_npz(tmp_path / "jax.npz")
    for k, want in _arrays(jens).items():
        got = getattr(loaded, k).numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    # and the port writes what the JAX package reads
    loaded.save(tmp_path / "port.npz")
    back = jtrees.ObliviousEnsemble.load(tmp_path / "port.npz")
    for k, want in _arrays(jens).items():
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), want)
    _close(Predictor.build(loaded, device="cpu").raw(x),
           Predictor.build(tens, device="cpu").raw(x))


def test_ensemble_from_numpy_refuses_unknown_fields(models):
    with pytest.raises(ValueError, match="unknown"):
        convert.ensemble_from_numpy({**_arrays(models[0]), "depth": 4})


def test_ensemble_structure_matches_jax(models):
    jens, tens, _ = models
    assert (tens.n_trees, tens.depth, tens.n_outputs, tens.n_features) == \
        (jens.n_trees, jens.depth, jens.n_outputs, jens.n_features)
    np.testing.assert_array_equal(tens.true_depths,
                                  np.asarray(jens.true_depths))
    assert tens.describe() == jens.describe()
    for start, stop in ((0, T), (3, 11), (7, 7)):
        want = _arrays(jens.slice_trees(start, stop))
        got = tens.slice_trees(start, stop)
        for k in ("split_features", "split_bins", "leaf_values"):
            np.testing.assert_array_equal(getattr(got, k).numpy(), want[k])
    with pytest.raises(ValueError):
        tens.slice_trees(5, T + 1)
    depths = np.arange(T) % (D + 1)
    want = _arrays(jtrees.truncate_tree_depths(jens, depths))
    got = ttrees.truncate_tree_depths(tens, depths)
    for k in ("split_bins", "leaf_values"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), want[k])
    with pytest.raises(ValueError):
        ttrees.truncate_tree_depths(tens, np.full(T, D + 1))


def test_synthetic_covertype_and_borders_bit_identical():
    for seed in (0, 3):
        want = jsynthetic.covertype(scale=0.002, seed=seed)
        got = tsynthetic.covertype(scale=0.002, seed=seed)
        for k in ("x_train", "y_train", "x_test", "y_test"):
            a, b = getattr(got, k), getattr(want, k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
        assert (got.name, got.loss, got.n_classes) == \
            (want.name, want.loss, want.n_classes)
        assert got.params.depth == want.params.depth
        assert got.params.learning_rate == want.params.learning_rate
        assert got.params.max_bins == want.params.max_bins
        for max_bins in (2, 64, 256):
            tb, tn = tquantize.compute_borders(got.x_train, max_bins)
            jb, jn = jquantize.compute_borders(want.x_train, max_bins)
            assert tb.numpy().tobytes() == np.asarray(jb).tobytes()
            assert tn.numpy().tobytes() == np.asarray(jn).tobytes()


def test_compute_borders_edge_columns_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(50, 4)).astype(np.float32)
    x[:, 1] = 2.5                      # constant
    x[:, 2] = np.nan                   # all NaN
    x[::3, 3] = np.inf                 # some inf
    tb, tn = tquantize.compute_borders(x, 16)
    jb, jn = jquantize.compute_borders(x, 16)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tn.tolist()[1:3] == [0, 0]
    with pytest.raises(ValueError):
        tquantize.compute_borders(x, 257)


def test_binary_model_proba_and_classify_match_jax():
    jens, tens, x = _models(n_outputs=1, seed=9)
    jplan = JPredictor.build(jens, strategy="staged", backend="ref",
                             layout="soa")
    plan = Predictor.build(tens, device="cpu", strategy="fused")
    proba = plan.proba(x)
    assert proba.shape == (N, 2)
    _close(proba, jplan.proba(x))
    np.testing.assert_array_equal(plan.classify(x).numpy(),
                                  np.asarray(jplan.classify(x)))


def test_first_calls_count_entry_and_batch_shape(models):
    _, tens, x = models
    seen = []
    plan = Predictor.build(tens, device="cpu",
                           on_trace=lambda: seen.append(1))
    for n in (4, 8, 4, 8, 16):
        plan.proba(x[:n])
    plan.classify(x[:4])
    plan.raw(plan.quantize(x[:4]))
    plan.raw_uncached(x[:32])
    stats = plan.stats
    assert stats["traces"] == {"proba": 3, "classify": 1, "quantize": 1,
                               "raw_pool": 1}
    assert stats["total_traces"] == len(seen) == 6
    assert stats["layout"] == "soa"


def test_config_refuses_what_is_not_ported(models):
    # tree_block belongs to soa, as in the JAX package
    for layout in ("depth_major", "depth_grouped", "bitpacked"):
        with pytest.raises(ValueError, match="tree_block"):
            PredictConfig(layout=layout, tree_block=8)
    with pytest.raises(ValueError, match="tree_block"):
        PredictConfig(tree_block=-1)
    with pytest.raises(ValueError, match="layout"):
        PredictConfig(layout="blocked")
    for backend in ("pallas", "ref"):
        with pytest.raises(ValueError, match="backend"):
            PredictConfig(backend=backend)
    tens = models[1]
    with pytest.raises(ValueError, match="plain"):
        PredictConfig(backend="torch_ref").resolve(tens, "cuda")
    cfg = PredictConfig().resolve(tens, "cuda")
    assert (cfg.strategy, cfg.backend, cfg.layout) == ("fused", "cuda",
                                                       "soa")
    assert PredictConfig(tree_block=8).resolve(tens, "cpu").layout == "soa"
    with pytest.raises(TypeError):
        Predictor.build(None, PredictConfig(), device="cpu",
                        strategy="fused")
    # an object that is not a mesh fails as in the JAX package: it has
    # no axis sizes to read
    with pytest.raises(AttributeError, match="shape"):
        GBDTServer(tens, device="cpu", mesh=object())


def test_wrong_width_input_raises(models):
    plan = Predictor.build(models[1], device="cpu")
    with pytest.raises(ValueError, match="features"):
        plan.raw(np.zeros((3, F + 1), np.float32))

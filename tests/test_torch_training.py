"""The port's trainer against the JAX package's, on the CPU.

The same numpy inputs go through `repro` and `repro_torch`:

  * the plain `histogram` against `repro.kernels.histogram.histogram_ref`
    and the Pallas kernel in interpret mode (rtol 1e-5, atol 1e-4, the
    tolerance of tests/test_kernels.py), for uint8 and int32 bins;
  * each loss's `init_raw`, `grad_hess`, `value` and `metric` (atol 1e-6:
    the two frameworks' softmax, log and mean round differently);
  * `_split_level` on one histogram: f*, b* and leaf ids exactly;
  * `boosting.fit` / `GBDTTrainer.fit_bins`: split features and bins
    exactly, leaf values, loss and final raw within rtol = atol = 1e-4
    (the gradients differ in the last bits, as the losses do);
  * checkpoint and resume: bit-identical in the port, and a checkpoint
    the JAX trainer wrote finishes to the JAX trainer's ensemble; the
    checkpointed key is JAX's carried key, split once a tree.

The CUDA histogram kernel runs only on the card, where `chip_smoke.py`
holds it against the plain version and checks determinism and resume.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import boosting as jboosting  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import quantize as jquantize  # noqa: E402
from repro.kernels import histogram as jhist  # noqa: E402
from repro.training import checkpoint as jcheckpoint  # noqa: E402
from repro.training import gbdt as jgbdt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import boosting, losses, prng, quantize  # noqa: E402
from repro_torch.core.predictor import Predictor  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import histogram as hist_k  # noqa: E402
from repro_torch.serving.engine import GBDTServer  # noqa: E402
from repro_torch.training import gbdt  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402

torch.set_num_threads(1)

PARAMS = dict(n_trees=6, depth=3, max_bins=16, seed=1)
N_CLASSES = 4


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _data(n=300, f=6, seed=0):
    """Features with an integer-valued column (repeated bins) and the
    targets of each loss, from one seed."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[:, -1] = np.round(x[:, -1] * 2)
    lin = x[:, 0] - 2.0 * x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    ys = {"rmse": (lin + 0.2 * rng.normal(size=n)).astype(np.float32),
          "mae": (lin + 0.2 * rng.normal(size=n)).astype(np.float32),
          "logloss": (lin > 0).astype(np.float32),
          "multiclass": np.digitize(lin, [-1, 0, 1]).astype(np.int32)}
    return x, ys


def _pool(x, max_bins=16):
    borders, n_borders = quantize.compute_borders(x, max_bins)
    return quantize.quantize_pool(x, borders), borders, n_borders


def _jax_pool(x, max_bins=16):
    borders, n_borders = jquantize.compute_borders(x, max_bins)
    return jquantize.quantize_pool(jnp.asarray(x), borders), borders, \
        n_borders


def _trainer(name, **params):
    return gbdt.GBDTTrainer(
        losses.make_loss(name, n_classes=N_CLASSES),
        boosting.BoostingParams(**{**PARAMS, **params}), device="cpu")


def _jax_trainer(name, **params):
    return jgbdt.GBDTTrainer(
        jlosses.make_loss(name, n_classes=N_CLASSES),
        jboosting.BoostingParams(**{**PARAMS, **params}))


def _same_model(ens, jens, jhist_, hist_):
    np.testing.assert_array_equal(ens.split_features.numpy(),
                                  np.asarray(jens.split_features))
    np.testing.assert_array_equal(ens.split_bins.numpy(),
                                  np.asarray(jens.split_bins))
    _close(ens.leaf_values, jens.leaf_values)
    _close(hist_["train_loss"], jhist_["train_loss"])
    _close(hist_["final_raw"], jhist_["final_raw"])


# --------------------------------------------------------------------------
# histogram
# --------------------------------------------------------------------------
HIST_SHAPES = [(8, 256, 1, 16, 8), (6, 100, 7, 32, 4), (16, 512, 3, 8, 16)]


def _hist_inputs(shape, dtype):
    f, n, c, b, n_leaves = shape
    rng = np.random.default_rng(7)
    bins_t = rng.integers(0, b, (f, n)).astype(dtype)
    leaf = rng.integers(0, n_leaves, (n,)).astype(np.int32)
    g = rng.normal(size=(n, c)).astype(np.float32)
    return bins_t, leaf, g


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("shape", HIST_SHAPES)
def test_plain_histogram_matches_jax_ref(shape, dtype):
    f, n, c, b, n_leaves = shape
    bins_t, leaf, g = _hist_inputs(shape, dtype)
    want = jhist.histogram_ref(jnp.asarray(bins_t), jnp.asarray(leaf),
                               jnp.asarray(g), n_bins=b, n_leaves=n_leaves)
    args = [torch.from_numpy(a) for a in (bins_t, leaf, g)]
    got = ref.histogram(*args, n_bins=b, n_leaves=n_leaves)
    assert got.shape == (f, n_leaves * b, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    # the op and the kernel wrapper take the plain version on the CPU
    hist_k.histogram.launches = 0
    for out in (ops.histogram(*args, n_bins=b, n_leaves=n_leaves),
                hist_k.histogram(*args, n_bins=b, n_leaves=n_leaves)):
        assert torch.equal(out, got)
    assert hist_k.histogram.launches == 0


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("shape", HIST_SHAPES)
def test_plain_histogram_matches_pallas_interpret(shape, dtype):
    # as tests/test_kernels.py runs the kernel: pre-padded to its blocks,
    # padded samples carrying g == 0
    f, n, c, b, n_leaves = shape
    bins_t, leaf, g = _hist_inputs(shape, dtype)
    fp, n_pad = -(-f // 8) * 8, -(-n // 256) * 256
    bt = np.zeros((fp, n_pad), dtype)
    bt[:f, :n] = bins_t
    lf = np.zeros((n_pad,), np.int32)
    lf[:n] = leaf
    gg = np.zeros((n_pad, c), np.float32)
    gg[:n] = g
    want = jhist.histogram(jnp.asarray(bt), jnp.asarray(lf), jnp.asarray(gg),
                           n_bins=b, n_leaves=n_leaves, interpret=True)[:f]
    got = ref.histogram(*(torch.from_numpy(a) for a in (bins_t, leaf, g)),
                        n_bins=b, n_leaves=n_leaves)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def _loss_case(name):
    """(port loss, JAX loss, raw, y) on one seed."""
    rng = np.random.default_rng(3)
    n = 40
    if name == "multiclass":
        raw = rng.normal(size=(n, N_CLASSES)).astype(np.float32)
        y = rng.integers(0, N_CLASSES, n).astype(np.int32)
    else:
        raw = rng.normal(size=(n, 1)).astype(np.float32)
        y = rng.normal(size=n).astype(np.float32)
    kw = {"n_classes": N_CLASSES}
    if name == "logloss":
        y = (y > 0).astype(np.float32)
    elif name == "mae_odd":
        name, y = "mae", y[:-1]
        raw = raw[:-1]
    elif name == "quantile":
        kw["alpha"] = 0.3
    elif name == "pairlogit":
        y = rng.integers(0, 3, n).astype(np.float32)
        gi = -np.ones((5, 9), np.int32)
        perm = rng.permutation(n)
        for g in range(5):
            size = 8 - g
            gi[g, :size] = perm[g * 8:g * 8 + size]
        kw["group_index"] = gi
    return (losses.make_loss(name, **kw), jlosses.make_loss(name, **kw),
            raw, y)


@pytest.mark.parametrize("name", ["rmse", "mae", "mae_odd", "quantile",
                                  "logloss", "multiclass", "pairlogit"])
def test_loss_matches_jax(name):
    tloss, jloss, raw, y = _loss_case(name)
    tr, ty = torch.from_numpy(raw), torch.from_numpy(y)
    jr, jy = jnp.asarray(raw), jnp.asarray(y)
    if name != "pairlogit":
        got = tloss.init_raw(ty)
        assert got.shape == (len(y), tloss.n_raw(0)) \
            and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(jloss.init_raw(jy)),
                                   rtol=0, atol=1e-6)
    for t, j in zip(tloss.grad_hess(tr, ty), jloss.grad_hess(jr, jy)):
        assert t.shape == j.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-6)
    for fn in ("value", "metric"):
        np.testing.assert_allclose(float(getattr(tloss, fn)(tr, ty)),
                                   float(getattr(jloss, fn)(jr, jy)),
                                   rtol=0, atol=1e-6)


def test_mae_base_score_averages_the_middle_pair():
    y = torch.tensor([1.0, 4.0, 2.0, 10.0])
    assert losses.MAE().init_raw(y)[0, 0].item() == 3.0
    assert float(jlosses.MAE().init_raw(jnp.asarray(y.numpy()))[0, 0]) == 3.0


def test_make_loss_refuses_unknown_names():
    with pytest.raises(ValueError, match="unknown loss"):
        losses.make_loss("huber")


# --------------------------------------------------------------------------
# the split search
# --------------------------------------------------------------------------
def _split_case(case):
    """(hist, valid, bins_t, leaf, n_bins, d): level d = 2 of a tree over
    5 features and 8 bins, C = 2."""
    rng = np.random.default_rng(5)
    f, n, n_bins, d, c = 5, 64, 8, 2, 2
    bins_t = rng.integers(0, n_bins, (f, n)).astype(np.uint8)
    leaf = rng.integers(0, 1 << d, n).astype(np.int32)
    g = np.concatenate([rng.normal(size=(n, c)),
                        rng.uniform(0.1, 1.0, (n, c))], 1).astype(np.float32)
    n_borders = np.array([7, 7, 3, 0, 7], np.int32)
    if case == "all_masked":
        n_borders[:] = 0          # no valid border: argmax of all NEG_INF
    if case == "exact_tie":
        # bins 3 and 4 of every feature empty: borders 3, 4 and 5 split
        # alike, and their gains tie exactly
        bins_t[(bins_t == 3) | (bins_t == 4)] = 2
    hist = ref.histogram(*(torch.from_numpy(a) for a in (bins_t, leaf, g)),
                         n_bins=n_bins, n_leaves=1 << d).numpy()
    b = np.arange(n_bins)
    valid = (b[None, :] >= 1) & (b[None, :] <= n_borders[:, None])
    return hist, valid, bins_t, leaf, n_bins, d


@pytest.mark.parametrize("case", ["random", "all_masked", "exact_tie"])
def test_split_level_matches_jax(case):
    hist, valid, bins_t, leaf, n_bins, d = _split_case(case)
    want = jgbdt._split_level(jnp.asarray(hist), jnp.asarray(valid),
                              jnp.asarray(bins_t), jnp.asarray(leaf),
                              n_bins=n_bins, d=d, l2=3.0)
    got = gbdt._split_level(*(torch.from_numpy(a) for a in
                              (hist, valid, bins_t, leaf)),
                            n_bins=n_bins, d=d, l2=3.0)
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    f_star, b_star, new_leaf = (t.numpy() for t in got)
    if case == "all_masked":
        assert (f_star, b_star) == (0, 0)
        assert (new_leaf >> d == 1).all()      # every sample goes right
    if case == "exact_tie":
        assert (f_star, b_star) == (0, 3)      # the first of a tied run


# --------------------------------------------------------------------------
# boosting against the JAX trainer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["rmse", "logloss", "multiclass", "mae"])
def test_fit_matches_jax(name):
    x, ys = _data()
    y = ys[name]
    jloss = jlosses.make_loss(name, n_classes=N_CLASSES)
    tloss = losses.make_loss(name, n_classes=N_CLASSES)
    jens, jh = jboosting.fit(x, y, loss=jloss,
                             params=jboosting.BoostingParams(**PARAMS))
    ens, h = boosting.fit(x, y, loss=tloss,
                          params=boosting.BoostingParams(**PARAMS),
                          device="cpu")
    _same_model(ens, jens, jh, h)
    np.testing.assert_allclose(ens.base_score.numpy(),
                               np.asarray(jens.base_score), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(ens.borders.numpy(),
                                  np.asarray(jens.borders))
    assert h["train_loss"][-1] < h["train_loss"][0]
    _close(h["final_metric"], jh["final_metric"])


def test_fit_bins_int32_matches_jax():
    # 255 borders through the int32 escape hatch on both sides
    x, ys = _data()
    y = ys["rmse"]
    jb, jnb = jquantize.compute_borders(x, 256)
    jbins = jquantize.binarize_matrix(jnp.asarray(x), jb)
    jens, jh = _jax_trainer("rmse", max_bins=256).fit_bins(
        jbins, y, borders=jb, n_borders=jnb)
    tb, tnb = quantize.compute_borders(x, 256)
    bins = quantize.binarize_matrix(torch.from_numpy(x), tb)
    assert tb.shape[0] == 255 and bins.dtype == torch.int32
    ens, h = _trainer("rmse", max_bins=256).fit_bins(bins, y, borders=tb,
                                                     n_borders=tnb)
    _same_model(ens, jens, jh, h)
    assert "binarize" not in h["dispatch_delta"]


def test_trainer_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default trainer runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gbdt.GBDTTrainer(losses.RMSE(), boosting.BoostingParams())
    with pytest.raises(ValueError, match="CPU"):
        gbdt.GBDTTrainer(losses.RMSE(), boosting.BoostingParams(),
                         device="cpu", backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        gbdt.GBDTTrainer(losses.RMSE(), boosting.BoostingParams(),
                         device="cpu", backend="pallas")


# --------------------------------------------------------------------------
# checkpoints and resume
# --------------------------------------------------------------------------
def test_resume_is_bit_identical(tmp_path):
    x, ys = _data(seed=2)
    y = ys["multiclass"]
    pool, borders, n_borders = _pool(x)
    ens_full, h_full = _trainer("multiclass").fit_pool(
        pool, y, borders=borders, n_borders=n_borders)
    ck = CheckpointManager(tmp_path / "ck", async_save=False)
    _trainer("multiclass", n_trees=4).fit_pool(
        pool, y, borders=borders, n_borders=n_borders, checkpoint=ck,
        checkpoint_every=2)
    assert ck.latest() == 4
    ens, h = _trainer("multiclass").fit_pool(
        pool, y, borders=borders, n_borders=n_borders, checkpoint=ck,
        resume_from=-1)
    for field in ("split_features", "split_bins", "leaf_values"):
        assert torch.equal(getattr(ens, field), getattr(ens_full, field))
    for key in ("train_loss", "final_raw"):
        np.testing.assert_array_equal(h[key], h_full[key])


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    # the JAX trainer checkpoints 3 of 6 trees; the port finishes them
    x, ys = _data(seed=4)
    y = ys["rmse"]
    jpool, jb, jnb = _jax_pool(x)
    jens, jh = _jax_trainer("rmse").fit_pool(jpool, y, borders=jb,
                                             n_borders=jnb)
    jck = jcheckpoint.CheckpointManager(tmp_path / "ck", async_save=False)
    _jax_trainer("rmse", n_trees=3).fit_pool(
        jpool, y, borders=jb, n_borders=jnb, checkpoint=jck,
        checkpoint_every=3)
    state = convert.train_state_from_jax(tmp_path / "ck")
    assert state.iteration == 3 and state.key.dtype == np.uint32

    pool, borders, n_borders = _pool(x)
    assert pool.fingerprint == jpool.fingerprint
    ck = CheckpointManager(tmp_path / "ck", async_save=False)
    ens, h = _trainer("rmse").fit_pool(pool, y, borders=borders,
                                       n_borders=n_borders, checkpoint=ck,
                                       resume_from=-1)
    _same_model(ens, jens, jh, h)
    np.testing.assert_array_equal(h["train_loss"][:3], jh["train_loss"][:3])


def test_port_checkpoint_has_the_jax_format(tmp_path):
    x, ys = _data(seed=6)
    pool, borders, n_borders = _pool(x)
    ck = CheckpointManager(tmp_path / "ck", keep_last=2)
    _trainer("rmse", n_trees=4).fit_pool(
        pool, ys["rmse"], borders=borders, n_borders=n_borders,
        checkpoint=ck, checkpoint_every=1)
    assert ck.all_steps() == [3, 4]          # keep_last prunes
    tree = jcheckpoint.CheckpointManager(tmp_path / "ck").restore()
    state = jgbdt.TrainState.from_tree(tree)
    assert state.iteration == 4
    # the carried key, split once a tree: JAX's own checkpoint key at
    # iteration 4
    jpool, jb, jnb = _jax_pool(x)
    jck = jcheckpoint.CheckpointManager(tmp_path / "jck", async_save=False)
    _jax_trainer("rmse", n_trees=4).fit_pool(
        jpool, ys["rmse"], borders=jb, n_borders=jnb, checkpoint=jck,
        checkpoint_every=4)
    np.testing.assert_array_equal(
        state.key, jgbdt.TrainState.from_tree(jck.restore()).key)
    np.testing.assert_array_equal(state.key, [2783477504, 2669311029])
    assert state.split_features.shape == (4, 3)
    assert {k: v.dtype for k, v in tree.items()} == \
        {k: v.dtype for k, v in gbdt.TrainState.from_tree(tree).tree()
         .items()}


def test_train_state_from_jax_tree_and_step_dir(tmp_path):
    st = jgbdt.TrainState(iteration=3, key=np.array([1, 2], np.uint32),
                          split_features=np.zeros((3, 2), np.int32),
                          split_bins=np.ones((3, 2), np.int32),
                          leaf_values=np.zeros((3, 4, 1), np.float32),
                          raw=np.zeros((10, 1), np.float32),
                          train_loss=np.zeros((3,), np.float32))
    got = convert.train_state_from_jax(st.tree())
    assert isinstance(got, gbdt.TrainState) and got.iteration == 3
    ck = jcheckpoint.CheckpointManager(tmp_path, async_save=False)
    ck.save(3, st.tree())
    for source in (tmp_path, tmp_path / "step_000000003"):
        back = convert.train_state_from_jax(source)
        for k, v in st.tree().items():
            np.testing.assert_array_equal(back.tree()[k], v)
            assert back.tree()[k].dtype == v.dtype
    with pytest.raises(FileNotFoundError):
        convert.train_state_from_jax(tmp_path / "missing")


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1])
def test_initial_key_is_jax_prng_key(seed):
    np.testing.assert_array_equal(prng.initial_key(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


def test_resume_rejects_wrong_shape(tmp_path):
    x, ys = _data()
    pool, borders, n_borders = _pool(x)
    ck = CheckpointManager(tmp_path / "ck", async_save=False)
    _trainer("rmse").fit_pool(pool, ys["rmse"], borders=borders,
                              n_borders=n_borders, checkpoint=ck,
                              checkpoint_every=6)
    x2, ys2 = _data(n=120)
    pool2, borders2, n_borders2 = _pool(x2)
    with pytest.raises(ValueError, match="does not match"):
        _trainer("rmse").fit_pool(pool2, ys2["rmse"], borders=borders2,
                                  n_borders=n_borders2, checkpoint=ck,
                                  resume_from=-1)


def test_pool_fingerprint_guard():
    x, ys = _data()
    pool, _, _ = _pool(x)
    other, _ = quantize.compute_borders(x, 8)
    with pytest.raises(ValueError, match="different schema"):
        _trainer("rmse").fit_pool(pool, ys["rmse"], borders=other)


# --------------------------------------------------------------------------
# the closed train -> serve loop, dispatches and metrics
# --------------------------------------------------------------------------
def test_serve_handoff_exact():
    x, ys = _data(seed=5)
    pool, borders, n_borders = _pool(x)
    ens, h = _trainer("multiclass").fit_pool(pool, ys["multiclass"],
                                             borders=borders,
                                             n_borders=n_borders)
    plan = Predictor.build(ens, device="cpu", strategy="staged",
                           layout="soa")
    np.testing.assert_array_equal(plan.raw(pool).numpy(), h["final_raw"])
    server = GBDTServer(ens, device="cpu", max_batch=64, layout="soa")
    try:
        assert server.schema_fingerprint == pool.fingerprint
        want = torch.softmax(torch.from_numpy(h["final_raw"]), -1).numpy()
        np.testing.assert_allclose(server.predict_pool(pool), want,
                                   rtol=1e-5, atol=1e-5)
    finally:
        server.close()
    assert h["serve_drift"] < 1e-5


def test_ensemble_round_trips_through_numpy():
    x, ys = _data()
    pool, borders, n_borders = _pool(x)
    ens, _ = _trainer("rmse").fit_pool(pool, ys["rmse"], borders=borders,
                                       n_borders=n_borders)
    arrays = convert.ensemble_to_numpy(ens)
    assert set(arrays) == set(convert.FIELDS)
    back = convert.ensemble_from_numpy(arrays)
    for field in convert.FIELDS:
        assert torch.equal(getattr(back, field), getattr(ens, field))


def test_pool_boosting_dispatches_and_first_calls():
    # zero binarize dispatches while boosting; a histogram dispatch per
    # level and one for the leaf sums, a split_level dispatch per level;
    # `depth` level shapes a fit, on a refit too (eager code keeps no
    # trace cache)
    x, ys = _data(seed=3, n=257)
    pool, borders, n_borders = _pool(x)
    _, h = _trainer("rmse").fit_pool(pool, ys["rmse"], borders=borders,
                                     n_borders=n_borders)
    depth, trees = PARAMS["depth"], PARAMS["n_trees"]
    assert h["dispatch_delta"] == {"histogram": (depth + 1) * trees,
                                   "split_level": depth * trees,
                                   "leaf_index": 1, "leaf_gather": 1}
    assert h["hist_first_calls"] == depth
    _, h2 = _trainer("rmse").fit_pool(pool, ys["rmse"], borders=borders,
                                      n_borders=n_borders)
    assert h2["hist_first_calls"] == depth
    assert h2["metrics"]["hist_dispatches"] == depth


def test_metrics_snapshot():
    x, ys = _data()
    pool, borders, n_borders = _pool(x)
    tr = gbdt.GBDTTrainer(losses.RMSE(), boosting.BoostingParams(**PARAMS),
                          device="cpu", name="snap-test")
    tr.fit_pool(pool, ys["rmse"], borders=borders, n_borders=n_borders)
    snap = tr.metrics.snapshot()
    assert set(snap) == set(jgbdt.TrainingMetrics().snapshot())
    assert snap["model"] == "snap-test"
    assert snap["iterations"] == PARAMS["n_trees"]
    assert snap["rows_trained"] == PARAMS["n_trees"] * len(x)
    assert snap["rows_per_s"] > 0
    for frac in ("hist_frac", "split_frac", "leaf_frac"):
        assert 0.0 <= snap[frac] <= 1.0
    assert (snap["hist_frac"] + snap["split_frac"] + snap["leaf_frac"]
            <= 1.0 + 1e-6)
    assert snap["final_train_loss"] < snap["first_train_loss"]
    assert snap["hist_dispatches"] <= PARAMS["depth"]
    empty = gbdt.TrainingMetrics("idle").snapshot()
    assert empty["iterations"] == 0 and np.isnan(empty["final_train_loss"])


def test_boosting_params_is_shared_with_the_workloads():
    from repro_torch.data import synthetic
    assert synthetic.BoostingParams is boosting.BoostingParams
    assert dataclasses.asdict(boosting.BoostingParams()) == \
        dataclasses.asdict(jboosting.BoostingParams())

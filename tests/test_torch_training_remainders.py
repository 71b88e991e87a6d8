"""The training remainders against the JAX package, on the CPU: feature
subsampling (`rsm < 1`), ordered boosting, the carried RNG key and the
seed float trainer `fit_scan`.

The same numpy inputs go through `repro` and `repro_torch`.  Split
features and bins must match exactly; leaf values, losses and raw
predictions within rtol = atol = 1e-4 (tests/test_differential.py:88),
as the two frameworks' gradients and f32 prefix sums round differently
in the last bits.

JAX's own `fit_scan` raises for `rsm < 1` under jax 0.9.0 (its
`_build_tree` slices a permutation by a traced `keep`), so the port's
`fit_scan` with `rsm < 1` is held to JAX's `GBDTTrainer`, which draws
the same stream.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import boosting as jboosting  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import quantize as jquantize  # noqa: E402
from repro.training import checkpoint as jcheckpoint  # noqa: E402
from repro.training import gbdt as jgbdt  # noqa: E402
from repro_torch.core import boosting, losses, prng, quantize  # noqa: E402
from repro_torch.training import gbdt  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402

torch.set_num_threads(1)

PARAMS = dict(n_trees=6, depth=3, max_bins=16, seed=1)
N_CLASSES = 4
MODES = {"rsm": dict(rsm=0.5), "ordered": dict(ordered=True),
         "both": dict(rsm=0.5, ordered=True)}


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _data(n=300, f=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[:, -1] = np.round(x[:, -1] * 2)
    lin = x[:, 0] - 2.0 * x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    ys = {"rmse": (lin + 0.2 * rng.normal(size=n)).astype(np.float32),
          "logloss": (lin > 0).astype(np.float32),
          "multiclass": np.digitize(lin, [-1, 0, 1]).astype(np.int32)}
    return x, ys


def _pools(x):
    jb, jnb = jquantize.compute_borders(x, PARAMS["max_bins"])
    tb, tnb = quantize.compute_borders(x, PARAMS["max_bins"])
    return ((jquantize.quantize_pool(jnp.asarray(x), jb), jb, jnb),
            (quantize.quantize_pool(x, tb), tb, tnb))


def _params(pkg, **kw):
    return pkg.BoostingParams(**{**PARAMS, **kw})


def _trainer(name, **kw):
    return gbdt.GBDTTrainer(losses.make_loss(name, n_classes=N_CLASSES),
                            _params(boosting, **kw), device="cpu")


def _jax_trainer(name, **kw):
    return jgbdt.GBDTTrainer(jlosses.make_loss(name, n_classes=N_CLASSES),
                             _params(jboosting, **kw))


def _same_model(ens, jens, hist=None, jhist=None):
    np.testing.assert_array_equal(np.asarray(ens.split_features),
                                  np.asarray(jens.split_features))
    np.testing.assert_array_equal(np.asarray(ens.split_bins),
                                  np.asarray(jens.split_bins))
    _close(ens.leaf_values, jens.leaf_values)
    if hist is not None:
        _close(hist["train_loss"], jhist["train_loss"])


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", ["rmse", "multiclass"])
def test_fit_pool_matches_jax(name, mode):
    x, ys = _data()
    (jpool, jb, jnb), (pool, tb, tnb) = _pools(x)
    jens, jh = _jax_trainer(name, **MODES[mode]).fit_pool(
        jpool, ys[name], borders=jb, n_borders=jnb)
    ens, h = _trainer(name, **MODES[mode]).fit_pool(
        pool, ys[name], borders=tb, n_borders=tnb)
    _same_model(ens, jens, h, jh)
    _close(h["final_raw"], jh["final_raw"])
    _close(h["serve_drift"], jh["serve_drift"])
    assert "binarize" not in h["dispatch_delta"]


def test_rsm_splits_lie_in_each_trees_mask():
    x, ys = _data(n=400, f=12, seed=3)
    _, (pool, tb, tnb) = _pools(x)
    ens, _ = _trainer("rmse", rsm=0.25, n_trees=10).fit_pool(
        pool, ys["rmse"], borders=tb, n_borders=tnb)
    keep = max(1, int(12 * 0.25))
    key = prng.initial_key(PARAMS["seed"])
    for tree in ens.split_features.numpy():
        key, sub, _ = prng.split(key, 3)
        mask = set(prng.permutation(sub, 12)[:keep].tolist())
        assert len(mask) == keep and set(tree.tolist()) <= mask


def test_ordered_update_matches_jax():
    rng = np.random.default_rng(11)
    n, c = 3000, 3
    leaf = rng.integers(0, 8, n).astype(np.int32)
    g = rng.normal(size=(n, c)).astype(np.float32)
    h = rng.uniform(0.1, 1.0, size=(n, c)).astype(np.float32)
    key = prng.split(prng.initial_key(2), 3)[2]
    want = jax.jit(jboosting._ordered_update, static_argnums=(4, 5, 6))(
        jnp.asarray(leaf), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(key), 0.3, 3.0, 8)
    got = boosting._ordered_update(torch.from_numpy(leaf),
                                   torch.from_numpy(g), torch.from_numpy(h),
                                   key, 0.3, 3.0)
    _close(got, want)


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 5000])
def test_prefix_sum_is_a_cumsum(n):
    """JAX's f32 cumsum bit for bit (XLA's blocked order: ordered
    boosting's prefix statistics then match JAX's exactly)."""
    x = torch.from_numpy(np.random.default_rng(n).normal(
        size=(n, 2)).astype(np.float32))
    got = boosting._prefix_sum(x).numpy()
    want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=0))(
        jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_segment_sum_sums_each_segment():
    rng = np.random.default_rng(4)
    seg = torch.from_numpy(rng.integers(0, 9, 500))
    values = torch.from_numpy(rng.normal(size=(500, 3)).astype(np.float32))
    got = boosting._segment_sum(values, seg, 12)
    want = torch.zeros(12, 3).index_add_(0, seg, values)
    assert got.shape == (12, 3) and not got[9:].any()
    _close(got, want, tol=1e-5)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_checkpoint_key_at_each_step_is_jax(tmp_path, mode):
    x, ys = _data(seed=5)
    (jpool, jb, jnb), (pool, tb, tnb) = _pools(x)
    ck = CheckpointManager(tmp_path / "port", keep_last=0,
                           async_save=False)
    _trainer("multiclass", **MODES[mode]).fit_pool(
        pool, ys["multiclass"], borders=tb, n_borders=tnb, checkpoint=ck,
        checkpoint_every=1)
    jck = jcheckpoint.CheckpointManager(tmp_path / "jax", keep_last=0,
                                        async_save=False)
    _jax_trainer("multiclass", **MODES[mode]).fit_pool(
        jpool, ys["multiclass"], borders=jb, n_borders=jnb, checkpoint=jck,
        checkpoint_every=1)
    assert ck.all_steps() == jck.all_steps() == list(
        range(1, PARAMS["n_trees"] + 1))
    for step in ck.all_steps():
        got = gbdt.TrainState.from_tree(ck.restore(step))
        want = jgbdt.TrainState.from_tree(jck.restore(step))
        np.testing.assert_array_equal(got.key, want.key)
        assert got.key.dtype == np.uint32
        _close(got.raw, want.raw)


def test_jax_checkpoint_resumes_in_the_port_and_back(tmp_path):
    # rsm = 0.5 and ordered boosting: every tree after the checkpoint
    # reads the carried key
    x, ys = _data(seed=6)
    y = ys["multiclass"]
    mode = MODES["both"]
    (jpool, jb, jnb), (pool, tb, tnb) = _pools(x)
    jens, jh = _jax_trainer("multiclass", **mode).fit_pool(
        jpool, y, borders=jb, n_borders=jnb)

    # JAX checkpoints 3 of 6 trees; the port finishes them
    jck = jcheckpoint.CheckpointManager(tmp_path / "jax", async_save=False)
    _jax_trainer("multiclass", n_trees=3, **mode).fit_pool(
        jpool, y, borders=jb, n_borders=jnb, checkpoint=jck,
        checkpoint_every=3)
    ens, h = _trainer("multiclass", **mode).fit_pool(
        pool, y, borders=tb, n_borders=tnb,
        checkpoint=CheckpointManager(tmp_path / "jax", async_save=False),
        resume_from=-1)
    _same_model(ens, jens, h, jh)
    np.testing.assert_array_equal(h["train_loss"][:3], jh["train_loss"][:3])

    # the port checkpoints 3 of 6 trees; JAX finishes them
    ck = CheckpointManager(tmp_path / "port", async_save=False)
    _trainer("multiclass", n_trees=3, **mode).fit_pool(
        pool, y, borders=tb, n_borders=tnb, checkpoint=ck,
        checkpoint_every=3)
    jens2, jh2 = _jax_trainer("multiclass", **mode).fit_pool(
        jpool, y, borders=jb, n_borders=jnb,
        checkpoint=jcheckpoint.CheckpointManager(tmp_path / "port",
                                                 async_save=False),
        resume_from=-1)
    _same_model(jens2, jens, jh2, jh)


def _fit_scan_pair(x, y, loss, kw):
    want = jboosting.fit_scan(x, y, loss=jlosses.make_loss(
        loss, n_classes=N_CLASSES), params=_params(jboosting, **kw))
    got = boosting.fit_scan(x, y, loss=losses.make_loss(
        loss, n_classes=N_CLASSES), params=_params(boosting, **kw),
        device="cpu")
    return got, want


@pytest.mark.parametrize("mode", ["plain", "ordered"])
@pytest.mark.parametrize("name", ["rmse", "multiclass"])
def test_fit_scan_matches_jax_fit_scan(name, mode):
    x, ys = _data(seed=7)
    (ens, h), (jens, jh) = _fit_scan_pair(x, ys[name], name,
                                          MODES.get(mode, {}))
    _same_model(ens, jens, h, jh)
    _close(ens.base_score, jens.base_score)
    _close(h["final_metric"], jh["final_metric"])


@pytest.mark.parametrize("mode", ["rsm", "both"])
def test_fit_scan_with_rsm_matches_jax_trainer(mode):
    x, ys = _data(seed=8)
    y = ys["multiclass"]
    jens, jh = jboosting.fit(x, y, loss=jlosses.make_loss(
        "multiclass", n_classes=N_CLASSES),
        params=_params(jboosting, **MODES[mode]))
    ens, h = boosting.fit_scan(x, y, loss=losses.make_loss(
        "multiclass", n_classes=N_CLASSES),
        params=_params(boosting, **MODES[mode]), device="cpu")
    _same_model(ens, jens, h, jh)


@pytest.mark.parametrize("mode", ["plain", "rsm", "ordered", "both"])
def test_fit_matches_fit_scan(mode):
    # tests/test_differential.py's scenario: 400 x 6 rows, 8 trees
    rng = np.random.default_rng(5)
    x = rng.normal(size=(400, 6)).astype(np.float32)
    y = (x[:, 0] - 2.0 * x[:, 2] + 0.3 * rng.normal(size=400)
         ).astype(np.float32)
    params = boosting.BoostingParams(n_trees=8, depth=3, max_bins=16,
                                     seed=3, **MODES.get(mode, {}))
    loss = losses.make_loss("rmse")
    ens_f, hist_f = boosting.fit_scan(x, y, loss=loss, params=params,
                                      device="cpu")
    ens_p, hist_p = boosting.fit(x, y, loss=loss, params=params,
                                 device="cpu")
    assert torch.equal(ens_p.split_features, ens_f.split_features)
    assert torch.equal(ens_p.split_bins, ens_f.split_bins)
    np.testing.assert_allclose(ens_p.leaf_values.numpy(),
                               ens_f.leaf_values.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(hist_p["train_loss"], hist_f["train_loss"],
                               rtol=0, atol=1e-6)
    assert hist_p["dispatch_delta"].get("binarize", 0) == 0
    assert hist_p["dispatch_delta"].get("histogram", 0) > 0


def test_fit_scan_gives_the_same_bits_twice():
    x, ys = _data(seed=9)
    params = _params(boosting, **MODES["both"])
    loss = losses.make_loss("multiclass", n_classes=N_CLASSES)
    a, ha = boosting.fit_scan(x, ys["multiclass"], loss=loss, params=params,
                              device="cpu")
    b, hb = boosting.fit_scan(x, ys["multiclass"], loss=loss, params=params,
                              device="cpu")
    for f in ("split_features", "split_bins", "leaf_values"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(ha["train_loss"], hb["train_loss"])


def test_fit_scan_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default fit_scan runs")
    x, ys = _data(n=20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        boosting.fit_scan(x, ys["rmse"], loss=losses.make_loss("rmse"),
                          params=_params(boosting))

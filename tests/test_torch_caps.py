"""Shapes the CUDA kernels once refused, on the CPU.

The port's kernels once took at most 32 outputs, at most 64
histogram stats, and only as many features as a 48 KB shared bins tile
held (leaf_index 6,144 uint8 / 1,536 int32; the soa fused kernel 1,532 /
383; the dm and bp fused kernels 1,020 / 255; leaf_index_bp 1,004 / 251),
where the JAX package takes any.  Now:

  * the launch plans (`kernels/tuning.py`) never raise where JAX takes the
    shape: hypothesis grids up to F = 20,000, C = 200 and S = 400 check
    that output slabs and stat groups cover C and S exactly once, that
    shared memory stays within the 227 KB opt-in limit, and that the
    route is shared up to the old caps and global only where not even the
    fewest rows fit that limit;
  * every CUDA wrapper, called on "meta" tensors with the launch recorded
    instead of made, plans and launches at C = 33 and one feature past
    each old cap;
  * the port equals the JAX package there: a 33-output ensemble through
    `Predictor` on all four layouts, fused and staged; 1,533 and 6,145
    uint8 features and 1,537 int32 features through the index, gather and
    fused ops; a 3-tree, 33-class MultiClass fit (66 stats), splits
    exactly.  Integers exactly, floats within rtol = atol = 1e-4
    (tests/test_differential.py:88);
  * a stat group's fixed-point histogram is the whole one's, bit for bit.

On the CPU the wrappers take the plain versions; the `cuda`-marked test
runs the kernels at the same shapes and skips without a card
(`chip_smoke.py`'s caps phase holds them on the H100).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import boosting as jboosting  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import quantize as jquantize  # noqa: E402
from repro.core import trees as jtrees  # noqa: E402
from repro.core.predictor import Predictor as JPredictor  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.training import gbdt as jgbdt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import boosting, layout as tlayout, losses  # noqa: E402
from repro_torch.core import quantize  # noqa: E402
from repro_torch.core.predictor import Predictor  # noqa: E402
from repro_torch.kernels import _build, ops, ref, tuning  # noqa: E402
from repro_torch.kernels import fused_predict as fused_k  # noqa: E402
from repro_torch.kernels import histogram as hist_k  # noqa: E402
from repro_torch.kernels import leaf_gather as gather_k  # noqa: E402
from repro_torch.kernels import leaf_index as index_k  # noqa: E402
from repro_torch.training import gbdt  # noqa: E402

torch.set_num_threads(1)

LAYOUTS = ("soa", "depth_major", "depth_grouped", "bitpacked")
FIELDS = ("split_features", "split_bins", "leaf_values", "borders",
          "n_borders", "base_score")
# Features past which a 48 KB tile raised, (uint8, int32) bins, by kernel.
OLD_CAPS = {"leaf_index": (6144, 1536), "fused_predict": (1532, 383),
            "fused_planes": (1020, 255), "leaf_index_bp": (1004, 251)}
GRID = settings(max_examples=200, deadline=None)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def _covers(spans, n):
    """`spans` are consecutive [start, stop) slices covering range(n)."""
    return [i for a, b in spans for i in range(a, b)] == list(range(n)) \
        and all(b > a for a, b in spans)


def _tiles(n_features, bin_bytes, depth=8):
    """Each capped kernel's tile plan, and the bytes of its fewest rows
    with the kernel's other shared memory.  The leaf_index tile is
    transposed: F + 1 feature columns `stride` rows apart (`_lines`)."""
    odd = ((n_features * bin_bytes + 3) // 4 | 1) * 4
    bp = tuning.bp_plan(139_440, 1000, depth, n_features, bin_bytes).tile
    index = tuning.index_plan(139_440, 1000, depth, n_features, bin_bytes)
    return {
        "leaf_index": (index.tile,
                       tuning.index_tile_bytes(min(tuning.INDEX_ROWS),
                                               n_features, bin_bytes)
                       + depth * tuning.INDEX_ROUND_TREES
                       * tuning.INDEX_PAIR_BYTES),
        "fused_predict": (tuning.tile_shape(n_features, bin_bytes == 1),
                          32 * odd),
        "fused_planes": (tuning.tile_shape(n_features, bin_bytes == 1,
                                           planes=True),
                         32 * odd + tuning.PLANE_BYTES),
        "leaf_index_bp": (bp, 32 * odd + tuning.BP_TRANSPOSE_BYTES
                          + depth * tuning.BP_ROUND_TREES * 8)}


def _lines(name, plan, n_features):
    """The lines a staged tile holds and the bins each must hold: rows of
    F bins, or for leaf_index F + 1 feature columns of `rows` bins."""
    if name == "leaf_index":
        return n_features + 1, plan.rows
    return plan.rows, n_features


# --------------------------------------------------------------------------
# The plans
# --------------------------------------------------------------------------
@GRID
@given(n_features=st.integers(1, 20_000), u8=st.booleans())
def test_tile_plans_take_any_width(n_features, u8):
    bin_bytes = 1 if u8 else 4
    for name, (plan, least) in _tiles(n_features, bin_bytes).items():
        assert plan.rows >= 8 and plan.smem_bytes <= tuning.SMEM_OPTIN_LIMIT
        assert plan.route in ("shared", "global")
        if n_features <= OLD_CAPS[name][0 if u8 else 1]:
            assert plan.route == "shared", name
        assert (plan.route == "global") == (least > tuning.SMEM_OPTIN_LIMIT)
        lines, length = _lines(name, plan, n_features)
        if plan.route == "shared":
            assert plan.tile_bytes == lines * plan.stride * bin_bytes
            assert plan.stride >= length
        else:
            assert plan.tile_bytes == 0 and plan.stride == n_features


def test_one_feature_past_each_old_cap_opts_in():
    for name, (cap8, cap32) in OLD_CAPS.items():
        for n_features, bin_bytes in ((cap8, 1), (cap32, 4)):
            plan, _ = _tiles(n_features, bin_bytes)[name]
            assert plan.route == "shared"
            plan, _ = _tiles(n_features + 1, bin_bytes)[name]
            assert plan.route == "shared" and plan.opt_in, name
    # 1,533 / 6,145 uint8 and 1,537 int32 features
    assert tuning.tile_shape(1533, True).rows == 128
    assert tuning.index_plan(139_440, 1000, 8, 6145, 1).tile.rows == 16
    assert tuning.index_plan(139_440, 1000, 8, 1537, 4).tile.rows == 16


@GRID
@given(n_outputs=st.integers(1, 200), n_rows=st.integers(1, 400_000),
       n_trees=st.integers(1, 2000), depth=st.integers(1, 16))
def test_gather_plan_takes_any_outputs(n_outputs, n_rows, n_trees, depth):
    spans = tuning.output_slabs(n_outputs)
    assert _covers(spans, n_outputs)
    assert all(b - a <= tuning.SLAB_OUTPUTS for a, b in spans)
    for staged in (None, False):
        plan = tuning.gather_plan(n_rows, n_trees, 1 << depth, n_outputs,
                                  staged)
        assert plan.n_slabs == len(spans) and plan.slab == spans[0][1]
        assert plan.slab <= plan.lanes <= 32 and 32 % plan.lanes == 0
        assert plan.n_row_blocks * plan.rows_per_block >= n_rows
        assert plan.smem_bytes <= tuning.SMEM_OPTIN_LIMIT
        if plan.staged:
            assert 1 <= plan.trees_per_chunk <= tuning.GATHER_MAX_CHUNK
            assert plan.smem_bytes == tuning.gather_stage_bytes(
                plan.trees_per_chunk, 1 << depth, plan.slab,
                plan.rows_per_block)
            assert 1 <= plan.rows_per_thread <= \
                tuning.GATHER_MAX_ROWS_PER_THREAD


@GRID
@given(n_stats=st.integers(1, 400), n_features=st.integers(1, 600),
       depth=st.integers(0, 8))
def test_histogram_plan_takes_any_stats(n_stats, n_features, depth):
    plan = tuning.hist_plan(n_features, 5000, 1 << depth, 64, n_stats)
    assert _covers(plan.stat_groups, n_stats)
    width = max(b - a for a, b in plan.stat_groups)
    assert width <= tuning.HIST_MAX_STATS
    assert len(plan.stat_groups) == -(-n_stats // tuning.HIST_MAX_STATS)
    assert plan.tile_bytes == plan.seg_tile * width * tuning.HIST_CELL_BYTES
    assert plan.smem_bytes <= tuning.SMEM_OPTIN_LIMIT


@GRID
@given(n_rows=st.integers(1, 400_000), n_trees=st.integers(1, 2000),
       depth=st.integers(1, 16), n_features=st.integers(1, 20_000),
       u8=st.booleans())
def test_bitpacked_plan_fills_the_card(n_rows, n_trees, depth, n_features,
                                       u8):
    plan = tuning.bp_plan(n_rows, n_trees, depth, n_features, 1 if u8 else 4)
    rounds = -(-n_trees // tuning.BP_ROUND_TREES)
    assert plan.tile.rows == tuning.BP_ROWS
    assert plan.n_row_tiles * plan.tile.rows >= n_rows
    assert plan.n_tree_groups * plan.rounds_per_group >= rounds
    assert (plan.n_tree_groups - 1) * plan.rounds_per_group < rounds
    assert plan.tile.smem_bytes <= tuning.SMEM_OPTIN_LIMIT
    if plan.n_row_tiles >= tuning.SM_COUNT:
        assert plan.n_tree_groups == 1


def test_the_documented_plans():
    bulk = tuning.gather_plan(139_440, 1000, 256, 7)
    assert (bulk.staged, bulk.lanes, bulk.rows_per_thread,
            bulk.trees_per_chunk, bulk.n_row_blocks) == (True, 8, 9, 19, 122)
    bucket = tuning.gather_plan(1024, 1000, 256, 7)
    assert (bucket.staged, bucket.threads, bucket.n_row_blocks) == \
        (False, 64, 128)
    plan = tuning.bp_plan(139_440, 1000, 8, 54, 1)
    assert (plan.tile.rows, plan.n_row_tiles, plan.n_tree_groups,
            plan.rounds_per_group) == (32, 4358, 1, 4)
    plan = tuning.bp_plan(1024, 1000, 8, 54, 1)
    assert (plan.n_row_tiles, plan.n_tree_groups, plan.rounds_per_group) \
        == (32, 4, 1)
    assert tuning.output_slabs(33) == ((0, 17), (17, 33))
    assert tuning.stat_groups(66) == ((0, 33), (33, 66))


# --------------------------------------------------------------------------
# The CUDA wrappers plan and launch at the former caps
# --------------------------------------------------------------------------
@pytest.fixture
def launches(monkeypatch):
    """Record each launch on "meta" tensors instead of making it."""
    made = []
    monkeypatch.setattr(_build, "check_cuda_tensors", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch",
                        lambda name, device, *a: made.append((name, a)))
    ops.reset_launch_counts()
    return made


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrappers_launch_at_33_outputs(launches):
    n, t, d, f, c = 1024, 8, 3, 7, 33
    i32 = torch.int32
    out = gather_k.leaf_gather(_meta(n, t, dtype=i32), _meta(t, 8, c))
    assert out.shape == (n, c)
    (name, args), = launches
    plan = tuning.gather_plan(n, t, 8, c)
    assert name == "repro_leaf_gather" and args[7:] == (
        17, 32, 0, plan.threads, 1, 0, plan.n_row_blocks)
    x, borders = _meta(n, f), _meta(9, f)
    fused_k.fused_predict(x, borders, _meta(t, d, dtype=i32),
                          _meta(t, d, dtype=i32), _meta(t, 8, c))
    fused_k.fused_predict_dm(x, borders, _meta(d, t, dtype=i32),
                             _meta(d, t, dtype=i32), _meta(d, 1),
                             _meta(t, 8, c))
    for route in (None, "row"):
        fused_k.fused_predict_bp(x, borders, _meta(d, t, dtype=i32),
                                 _meta(d, t, dtype=torch.uint8),
                                 _meta(t, 8, c), route=route)
    assert [a[-1] for _, a in launches[1:]] == [17, 17, 17, 17]  # the slab
    # a 1,024-row bucket takes the three fused kernels' spread routes,
    # which have no scratch argument; the bp kernel's row route tile needs
    # no scratch
    assert launches[1][0] == "repro_fused_predict_spread" and not any(
        isinstance(a, torch.Tensor) for a in launches[1][1][6:])
    assert launches[2][0] == "repro_fused_predict_dm_spread" and not any(
        isinstance(a, torch.Tensor) for a in launches[2][1][7:])
    assert launches[3][0] == "repro_fused_predict_bp_spread" and not any(
        isinstance(a, torch.Tensor) for a in launches[3][1][6:])
    assert launches[4][0] == "repro_fused_predict_bp"
    assert launches[4][1][6] is None
    assert sum(ops.launch_counts().values()) == 5


def test_wrappers_launch_past_the_feature_caps(launches):
    i32, u8 = torch.int32, torch.uint8
    n, t, d = 64, 40, 8
    for f, dtype in ((6145, u8), (1537, i32), (30_000, u8)):
        bins = _meta(n, f, dtype=dtype)
        planes = (_meta(d, t, dtype=i32), _meta(d, t, dtype=i32))
        index_k.leaf_index(bins, _meta(t, d, dtype=i32),
                           _meta(t, d, dtype=i32))
        index_k.leaf_index_dm(bins, *planes, _meta(d, 1))
        index_k.leaf_index_bp(bins, *planes)
        plan = tuning.index_plan(n, t, d, f, dtype.itemsize)
        assert launches[-3][1][-4:] == (
            plan.tile.rows, int(plan.tile.route == "global"),
            plan.n_tree_groups, plan.rounds_per_group)
        assert launches[-2][1][-4:] == launches[-3][1][-4:]
        bp = tuning.bp_plan(n, t, d, f, dtype.itemsize)
        assert launches[-1][1][-4:] == (
            bp.tile.stride, int(bp.tile.route == "global"),
            bp.n_tree_groups, bp.rounds_per_group)
    assert [a[-3] for _, a in launches[::3]] == [0, 0, 1]   # global
    for f, n_borders in ((1533, 63), (1021, 63), (384, 300), (60_000, 63)):
        x, borders = _meta(n, f), _meta(n_borders, f)
        lv = _meta(t, 1 << d, 7)
        # the plan's route at 64 rows is spread (one row of bins a block
        # fits shared memory); the row route keeps the global scratch
        for route in (None, "row"):
            fused_k.fused_predict(x, borders, _meta(t, d, dtype=i32),
                                  _meta(t, d, dtype=i32), lv, route=route)
        for route in (None, "row"):
            fused_k.fused_predict_bp(x, borders, _meta(d, t, dtype=i32),
                                     _meta(d, t, dtype=u8), lv, route=route)
        assert launches[-4][0] == "repro_fused_predict_spread"
        assert launches[-2][0] == "repro_fused_predict_bp_spread"
        assert launches[-2][1][6:8] == (n, f)
        global_route = f == 60_000
        for _, row in (launches[-3], launches[-1]):    # the row routes
            scratch = row[6]
            assert (scratch is not None) == global_route
            if global_route:
                assert scratch.shape == (n, f) and scratch.dtype == u8
                assert row[-3:-1] == (f, 128)
    assert ops.launch_counts()["fused_predict_bp"] == 8


def test_histogram_launches_once_a_stat_group(launches):
    f, n, s = 3, 40, 66
    out = hist_k.histogram(_meta(f, n, dtype=torch.uint8),
                           _meta(n, dtype=torch.int32), _meta(n, s),
                           n_bins=6, n_leaves=2)
    assert out.shape == (f, 12, s)
    assert [a[10] for _, a in launches] == [33, 33]     # stats a launch
    assert [a[2].shape for _, a in launches] == [(n, 33), (n, 33)]
    assert hist_k.histogram.launches == 2


def test_a_stat_group_is_the_whole_histogram_bit_for_bit():
    rng = np.random.default_rng(4)
    bins_t = torch.from_numpy(rng.integers(0, 6, (3, 500)).astype(np.uint8))
    leaf = torch.from_numpy(rng.integers(0, 4, (500,)).astype(np.int32))
    g = torch.from_numpy((rng.normal(size=(500, 66))
                          * np.logspace(-3, 3, 66)).astype(np.float32))
    whole = ref.histogram_fixed(bins_t, leaf, g, n_bins=6, n_leaves=4)
    for a, b in tuning.stat_groups(66):
        part = ref.histogram_fixed(bins_t, leaf, g[:, a:b].contiguous(),
                                   n_bins=6, n_leaves=4)
        assert torch.equal(part, whole[:, :, a:b])


# --------------------------------------------------------------------------
# The port against the JAX package at those shapes
# --------------------------------------------------------------------------
def _ensembles(n_trees, depth, n_features, n_borders, n_outputs, seed=5,
               depths=None):
    rng = np.random.default_rng(seed)
    arrays = {
        "split_features": rng.integers(0, n_features, (n_trees, depth))
        .astype(np.int32),
        "split_bins": rng.integers(1, n_borders + 1, (n_trees, depth))
        .astype(np.int32),
        "leaf_values": rng.normal(size=(n_trees, 1 << depth, n_outputs))
        .astype(np.float32),
        "borders": np.sort(rng.normal(size=(n_borders, n_features)), 0)
        .astype(np.float32),
        "n_borders": np.full((n_features,), n_borders, np.int32),
        "base_score": rng.normal(scale=0.1, size=(n_outputs,))
        .astype(np.float32)}
    jens = jtrees.ObliviousEnsemble(**{k: jnp.asarray(v)
                                       for k, v in arrays.items()})
    if depths is not None:
        jens = jtrees.truncate_tree_depths(jens, np.array(depths))
    tens = convert.ensemble_from_numpy(
        {k: np.asarray(getattr(jens, k)) for k in FIELDS})
    x = rng.normal(size=(29, n_features)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    return jens, tens, x


@pytest.fixture(scope="module")
def outputs_33():
    return _ensembles(8, 3, 6, 9, 33)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("strategy", ("staged", "fused"))
@pytest.mark.parametrize("inputs", ("floats", "pool"))
def test_33_outputs_match_jax(outputs_33, layout, strategy, inputs):
    jens, tens, x = outputs_33
    jplan = JPredictor.build(jens, strategy=strategy, backend="ref",
                             layout=layout)
    plan = Predictor.build(tens, device="cpu", strategy=strategy,
                           layout=layout)
    jx = x
    if inputs == "pool":
        x, jx = plan.quantize(x), jplan.quantize(x)
        np.testing.assert_array_equal(x.bins.numpy(), np.asarray(jx.bins))
    raw = plan.raw(x)
    assert raw.shape == (29, 33)
    _close(raw, jplan.raw(jx))
    np.testing.assert_array_equal(plan.classify(x).numpy(),
                                  np.asarray(jplan.classify(jx)))


@pytest.mark.parametrize("n_features,n_borders", [(1533, 63), (6145, 63),
                                                  (1537, 300)])
def test_wide_rows_match_jax(n_features, n_borders):
    jens, tens, x = _ensembles(6, 4, n_features, n_borders, 3, seed=9)
    xt = torch.from_numpy(x)
    u8 = n_borders <= ref.MAX_U8_BORDERS
    bins = (ops.binarize_u8 if u8 else ops.binarize)(xt, tens.borders)
    assert bins.dtype == (torch.uint8 if u8 else torch.int32)
    jbins = jref.binarize(jnp.asarray(x), jens.borders)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jbins))
    idx = ops.leaf_index(bins, tens.split_features, tens.split_bins)
    jidx = jref.leaf_index(jbins, jens.split_features, jens.split_bins)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(ops.leaf_gather(idx, tens.leaf_values),
           jref.leaf_gather(jidx, jens.leaf_values))
    _close(ops.fused_predict(xt, tens.borders, tens.split_features,
                             tens.split_bins, tens.leaf_values),
           jref.fused_predict(jnp.asarray(x), jens.borders,
                              jens.split_features, jens.split_bins,
                              jens.leaf_values))
    for layout in ("depth_major", "bitpacked"):
        jplan = JPredictor.build(jens, strategy="staged", backend="ref",
                                 layout=layout)
        plan = Predictor.build(tens, device="cpu", strategy="staged",
                               layout=layout)
        _close(plan.raw(x), jplan.raw(x))
        if u8:                        # a pool holds uint8 bins only
            _close(plan.raw(plan.quantize(x)), jplan.raw(jplan.quantize(x)))


def test_multiclass_33_fit_matches_jax():
    rng = np.random.default_rng(6)
    n, f, k = 660, 5, 33
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (np.digitize(x[:, 0] + 0.5 * x[:, 1], np.linspace(-2, 2, k - 1))
         .astype(np.int32))
    assert len(np.unique(y)) == k
    params = dict(n_trees=3, depth=3, max_bins=16, seed=2)
    jborders, jnb = jquantize.compute_borders(x, 16)
    jens, jh = jgbdt.GBDTTrainer(
        jlosses.make_loss("multiclass", n_classes=k),
        jboosting.BoostingParams(**params), backend="ref").fit_pool(
            jquantize.quantize_pool(jnp.asarray(x), jborders), y,
            borders=jborders, n_borders=jnb)
    borders, nb = quantize.compute_borders(x, 16)
    ens, h = gbdt.GBDTTrainer(
        losses.make_loss("multiclass", n_classes=k),
        boosting.BoostingParams(**params), device="cpu").fit_pool(
            quantize.quantize_pool(x, borders), y, borders=borders,
            n_borders=nb)
    assert ens.leaf_values.shape == (3, 8, k)
    np.testing.assert_array_equal(ens.split_features.numpy(),
                                  np.asarray(jens.split_features))
    np.testing.assert_array_equal(ens.split_bins.numpy(),
                                  np.asarray(jens.split_bins))
    _close(ens.leaf_values, jens.leaf_values)
    _close(h["train_loss"], jh["train_loss"])
    assert h["train_loss"][-1] < h["train_loss"][0]


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode "
                    "(chip_smoke.py's caps phase holds them on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_former_caps_on_the_card(card, outputs_33):
    _, tens, x = outputs_33
    for layout in LAYOUTS:
        plans = [Predictor.build(tens, device="cuda", strategy=s,
                                 layout=layout) for s in ("fused", "staged")]
        raws = [plans[0].raw(x), plans[0].raw(plans[0].quantize(x)),
                plans[1].raw(x)]
        assert all(torch.equal(r, raws[0]) for r in raws[1:])
        _close(raws[0].cpu(), Predictor.build(tens, device="cpu",
                                              layout=layout).raw(x))
    for n_features, n_borders in ((1533, 63), (6145, 63), (1537, 300)):
        _, tens, x = _ensembles(6, 4, n_features, n_borders, 3, seed=9)
        low = tlayout.lower(tens, "soa")
        args = [a.to(card) for a in (torch.from_numpy(x), low.borders,
                                     low.split_features, low.split_bins,
                                     low.leaf_values)]
        got = fused_k.fused_predict(*args)
        _close(got.cpu(), ref.fused_predict(torch.from_numpy(x), low.borders,
                                            low.split_features,
                                            low.split_bins, low.leaf_values))
        bins = (ops.binarize_u8 if n_borders <= ref.MAX_U8_BORDERS
                else ops.binarize)(args[0], args[1])
        assert torch.equal(index_k.leaf_index(bins, *args[2:4]).cpu(),
                           ref.leaf_index(bins.cpu(), *(a.cpu()
                                                        for a in args[2:4])))
    rng = np.random.default_rng(4)
    bins_t = torch.from_numpy(rng.integers(0, 6, (3, 500)).astype(np.uint8))
    leaf = torch.from_numpy(rng.integers(0, 4, (500,)).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(500, 66)).astype(np.float32))
    got = hist_k.histogram(bins_t.to(card), leaf.to(card), g.to(card),
                           n_bins=6, n_leaves=4)
    assert torch.equal(got.cpu(), ref.histogram_fixed(bins_t, leaf, g,
                                                      n_bins=6, n_leaves=4))

"""The port's four physical layouts against the JAX package's, on the CPU.

Each scenario is a numpy-seeded model handed to both packages:

  rand      `tests/test_layouts.py:_rand_ensemble`: 13 trees of depth 4,
            11 features, 9 borders, 2 outputs (one depth group)
  mixed     the same trees cut by `_mixed_depth` to depths 1, 2, 3, 4
  diff      the "mixed" scenario of tests/test_differential.py: a depth-0
            tree, NaN features, 21 rows
  edge      its "edge" scenario: 255 borders, bins 0 and 255, T = 1
  midpad    `rand` with a pad level between two real levels of tree 0
            (true depth stays 4) and an all-pad tree 1 (depth 0)

The port's lowered arrays equal `repro.core.layout.lower(..., backend=
"ref")` exactly, dtypes included (the depth_major one-hot, which the port
does not lower, is rebuilt from its split-feature planes).  Plans of
every layout, strategy and input match the JAX plans of the same
configuration: class ids and bins exactly, raw scores within rtol = atol
= 1e-4 (tests/test_differential.py:88; the group sums reassociate).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import layout as jlayout  # noqa: E402
from repro.core import trees as jtrees  # noqa: E402
from repro.core.predictor import Predictor as JPredictor  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import tuning as jtuning  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import layout as tlayout  # noqa: E402
from repro_torch.core.predictor import Predictor  # noqa: E402
from repro_torch.kernels import ops, ref, registry, tuning  # noqa: E402
from repro_torch.serving.engine import GBDTServer  # noqa: E402

torch.set_num_threads(1)

SCENARIOS = ("rand", "mixed", "diff", "edge", "midpad")
LAYOUTS = ("soa", "depth_major", "depth_grouped", "bitpacked")
FIELDS = ("split_features", "split_bins", "leaf_values", "borders",
          "n_borders", "base_score")
PAD = ops.PAD_SPLIT_BIN


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def _same(got, want):
    """Equal values and equal dtypes."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _arrays(seed=3, n_trees=13, depth=4, n_features=11, n_borders=9,
            n_outputs=2, n_rows=37):
    rng = np.random.default_rng(seed)
    borders = np.sort(rng.normal(size=(n_borders, n_features)),
                      0).astype(np.float32)
    arrays = {
        "split_features": rng.integers(0, n_features, (n_trees, depth))
        .astype(np.int32),
        "split_bins": rng.integers(1, max(n_borders, 2), (n_trees, depth))
        .astype(np.int32),
        "leaf_values": rng.normal(size=(n_trees, 1 << depth, n_outputs))
        .astype(np.float32),
        "borders": borders,
        "n_borders": np.full((n_features,), n_borders, np.int32),
        "base_score": rng.normal(scale=0.1, size=(n_outputs,))
        .astype(np.float32)}
    x = np.random.default_rng(0).normal(size=(n_rows, n_features)).astype(
        np.float32)
    return arrays, x


def _scenario(name):
    """(JAX ensemble, port ensemble, x) for one scenario."""
    if name == "diff":
        rng = np.random.default_rng(11)
        n, f, b, t, d, c = 21, 7, 9, 6, 4, 2
        x = rng.normal(size=(n, f)).astype(np.float32)
        x[rng.random((n, f)) < 0.08] = np.nan
        arrays = {
            "borders": np.sort(rng.normal(size=(b, f)), 0).astype(np.float32),
            "split_features": rng.integers(0, f, (t, d)).astype(np.int32),
            "split_bins": rng.integers(1, b + 1, (t, d)).astype(np.int32),
            "leaf_values": rng.normal(size=(t, 1 << d, c)).astype(np.float32),
            "n_borders": np.full((f,), b, np.int32)}
        depths = [0, 1, 2, 4, 3, 4]
    elif name == "edge":
        rng = np.random.default_rng(23)
        f, b, t, d, c = 3, 255, 1, 2, 1
        borders = np.sort(rng.normal(size=(b, f)), 0).astype(np.float32)
        x = np.array([[borders[0, 0] - 1.0, borders[-1, 1] + 1.0, np.nan]],
                     np.float32)
        arrays = {"borders": borders,
                  "split_features": np.array([[1, 0]], np.int32),
                  "split_bins": np.array([[255, 1]], np.int32),
                  "leaf_values": rng.normal(size=(t, 1 << d, c))
                  .astype(np.float32),
                  "n_borders": np.full((f,), b, np.int32)}
        depths = None
    else:
        arrays, x = _arrays()
        depths = None
        if name == "mixed":
            depths = [(1, 2, 3, 4)[t % 4] for t in range(13)]
        elif name == "midpad":
            arrays["split_bins"][0, 1] = PAD
            arrays["split_bins"][1, :] = PAD
    jens = jtrees.ObliviousEnsemble(**{k: jnp.asarray(v)
                                       for k, v in arrays.items()})
    if depths is not None:
        jens = jtrees.truncate_tree_depths(jens, np.array(depths))
    tens = convert.ensemble_from_numpy(
        {k: np.asarray(getattr(jens, k)) for k in FIELDS})
    return jens, tens, x


@pytest.fixture(scope="module", params=SCENARIOS)
def scenario(request):
    return (request.param,) + _scenario(request.param)


# --------------------------------------------------------------------------
# lowering
# --------------------------------------------------------------------------
@pytest.mark.parametrize("layout", LAYOUTS + ("soa_tree_block",))
def test_lowered_arrays_match_jax_ref_lowering(scenario, layout):
    name, jens, tens, _ = scenario
    tree_block = 4 if layout == "soa_tree_block" else 0
    layout = layout.replace("_tree_block", "")
    want = jlayout.lower(jens, layout, backend="ref", tree_block=tree_block)
    got = tlayout.lower(tens, layout, tree_block=tree_block)
    assert got.layout_name == want.layout_name == layout
    _same(got.borders, want.borders)
    if layout == "soa":
        for k in ("split_features", "split_bins", "leaf_values"):
            _same(getattr(got, k), getattr(want, k))
        if tree_block and jens.n_trees > tree_block:
            assert len(got.tree_blocks) == len(want.tree_blocks) == \
                -(-jens.n_trees // tree_block)
            for gb, wb in zip(got.tree_blocks, want.tree_blocks):
                for g, w in zip(gb, wb):
                    _same(g, w)
        else:
            assert got.tree_blocks is None and want.tree_blocks is None
    elif layout == "depth_major":
        _same(got.split_bins_dm, want.split_bins_dm)
        _same(got.pow2, want.pow2)
        _same(got.leaf_values, want.leaf_values)
        # the one-hot the JAX lowering holds, rebuilt from the port's planes
        f_ids = torch.arange(tens.n_features, dtype=torch.int32)
        onehot = (f_ids[None, None, :]
                  == got.split_features_dm.t()[:, :, None]).to(torch.float32)
        _same(onehot, want.onehot)
    else:
        assert [g.depth for g in got.groups] == \
            [g.depth for g in want.groups]
        keys = (("split_features", "split_bins", "leaf_values")
                if layout == "depth_grouped" else
                ("split_features_bp", "split_bins_bp", "leaf_values"))
        for g, w in zip(got.groups, want.groups):
            assert g.n_trees == w.n_trees
            for k in keys:
                _same(getattr(g, k), getattr(w, k))
    if layout == "bitpacked":
        assert got.binary_split == want.binary_split
        assert got.n_features == want.n_features
        assert got.plane_bytes() == want.plane_bytes()
        assert got.describe() == want.describe()
    if layout == "depth_grouped":
        assert got.describe() == want.describe()
    assert got.leaf_table_bytes() == want.leaf_table_bytes()


def test_plane_dtypes_follow_the_sentinel():
    # uint8 where every threshold of a group fits a byte; int32 where the
    # group holds PAD_SPLIT_BIN: a depth-0 tree clamped to one level, or a
    # pad level between real levels
    _, tens, _ = _scenario("midpad")
    groups = {g.depth: g for g in tlayout.lower(tens, "bitpacked").groups}
    assert sorted(groups) == [1, 4]
    assert groups[1].split_bins_bp.dtype == torch.int32
    assert groups[1].split_bins_bp.tolist() == [[PAD]]
    assert groups[4].split_bins_bp.dtype == torch.int32
    _, tens, _ = _scenario("mixed")
    for g in tlayout.lower(tens, "bitpacked").groups:
        assert g.split_bins_bp.dtype == torch.uint8
    _, tens, _ = _scenario("edge")
    (g,) = tlayout.lower(tens, "bitpacked").groups
    assert g.split_bins_bp.dtype == torch.uint8
    assert g.split_bins_bp[:, 0].tolist() == [255, 1]


def test_lower_refuses_unknown_layout_and_foreign_tree_block():
    _, tens, _ = _scenario("rand")
    with pytest.raises(ValueError, match="unknown layout"):
        tlayout.lower(tens, "blocked")
    with pytest.raises(ValueError, match="tree_block"):
        tlayout.lower(tens, "depth_major", tree_block=4)


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("strategy", ("staged", "fused"))
@pytest.mark.parametrize("inputs", ("floats", "pool"))
def test_plan_matches_jax_plan(scenario, layout, strategy, inputs):
    _, jens, tens, x = scenario
    jplan = JPredictor.build(jens, strategy=strategy, backend="ref",
                             layout=layout)
    plan = Predictor.build(tens, device="cpu", strategy=strategy,
                           layout=layout)
    assert plan.config.layout == plan.stats["layout"] == layout
    assert plan.describe()["lowered"]["layout"] == layout
    if inputs == "pool":
        pool, jpool = plan.quantize(x), jplan.quantize(x)
        _same(pool.bins, jpool.bins)
        x, jx = pool, jpool
    else:
        jx = x
    _close(plan.raw(x), jplan.raw(jx))
    _close(plan.proba(x), jplan.proba(jx))
    _same(plan.classify(x), jplan.classify(jx))


@pytest.mark.parametrize("inputs", ("floats", "pool"))
def test_tree_block_plan_matches_jax(scenario, inputs):
    _, jens, tens, x = scenario
    jplan = JPredictor.build(jens, strategy="staged", backend="ref",
                             layout="soa", tree_block=4)
    plan = Predictor.build(tens, device="cpu", strategy="staged",
                           tree_block=4)
    assert plan.config.layout == "soa"
    blocks = plan.lowered.describe()["tree_blocks"]
    assert blocks == (-(-tens.n_trees // 4) if tens.n_trees > 4 else 0)
    if inputs == "pool":
        x, jx = plan.quantize(x), jplan.quantize(x)
    else:
        jx = x
    _close(plan.raw(x), jplan.raw(jx))
    _same(plan.classify(x), jplan.classify(jx))


def test_fused_strategy_ignores_tree_block():
    _, tens, _ = _scenario("rand")
    plan = Predictor.build(tens, device="cpu", strategy="fused",
                           tree_block=4)
    assert plan.lowered.tree_blocks is None


def _routes(tens, x, layout):
    plan = Predictor.build(tens, device="cpu", layout=layout,
                           strategy="fused")
    staged = Predictor.build(tens, device="cpu", layout=layout,
                             strategy="staged")
    return {"fused": plan.raw(x), "pool": plan.raw(plan.quantize(x)),
            "staged": staged.raw(x)}


def test_depth_major_bit_identical_to_soa(scenario):
    # same trees in the same order, same leaf indexes: every route of
    # depth_major gives soa's sums bit for bit
    _, _, tens, x = scenario
    soa, dm = _routes(tens, x, "soa"), _routes(tens, x, "depth_major")
    for route in soa:
        assert torch.equal(dm[route], soa[route]), route


def test_bitpacked_bit_identical_to_depth_grouped(scenario):
    _, _, tens, x = scenario
    dg, bp = _routes(tens, x, "depth_grouped"), _routes(tens, x, "bitpacked")
    for route in dg:
        if route == "fused" and len(
                tlayout.lower(tens, "bitpacked").groups) == 1:
            continue        # one group: the fused bp route, checked below
        assert torch.equal(bp[route], dg[route]), route


def test_one_group_bitpacked_fused_matches_soa_fused():
    _, tens, x = _scenario("rand")
    assert len(tlayout.lower(tens, "bitpacked").groups) == 1
    ops.reset_launch_counts()
    registry.reset_call_stats()
    got = Predictor.build(tens, device="cpu", layout="bitpacked",
                          strategy="fused").raw(x)
    assert registry.call_stats() == {"fused_predict": 1}
    assert torch.equal(got, _routes(tens, x, "soa")["fused"])


def test_pool_path_dispatches_by_layout():
    _, tens, x = _scenario("mixed")
    for layout, n_groups in (("soa", 1), ("depth_major", 1),
                             ("depth_grouped", 4), ("bitpacked", 4)):
        plan = Predictor.build(tens, device="cpu", layout=layout)
        pool = plan.quantize(x)
        registry.reset_call_stats()
        plan.raw(pool)
        assert registry.call_stats() == {"leaf_index": n_groups,
                                         "leaf_gather": n_groups}, layout


# --------------------------------------------------------------------------
# auto layout, packing, layout table, serving
# --------------------------------------------------------------------------
HISTOGRAMS = {
    "uniform": [6] * 40,
    "mixed": [1, 2, 3, 8] * 10,
    "few_shallow": [8] * 30 + [7] * 3,
    "with_depth0": [0, 0, 8, 8, 2, 2],
    "empty": [],
    "huge_mixed": [2, 8] * 40_000,
}


@pytest.mark.parametrize("hist", HISTOGRAMS)
@pytest.mark.parametrize("n_outputs,n_features", [(1, 11), (7, 54),
                                                  (3, 400)])
def test_best_layout_matches_jax_ref(hist, n_outputs, n_features):
    depths = np.array(HISTOGRAMS[hist], np.int32)
    assert tuning.layout_costs(depths, n_outputs, n_features) == \
        jtuning.layout_costs(depths, n_outputs, n_features)
    want = jtuning.best_layout(depths, n_outputs, n_features, backend="ref")
    assert tuning.best_layout(depths, n_outputs, n_features) == want
    assert tuning.best_layout(depths, n_outputs, n_features,
                              device="cuda") == "soa"


def test_best_layout_histograms_cover_every_cpu_choice():
    got = {tuning.best_layout(np.array(h), 7, 54)
           for h in HISTOGRAMS.values()}
    assert got == {"soa", "depth_grouped", "bitpacked"}
    assert tuning.GROUPED_MIN_SAVINGS == jtuning.GROUPED_MIN_SAVINGS
    assert tuning.DEPTH_MAJOR_MAX_ONEHOT_BYTES == \
        jtuning.DEPTH_MAJOR_MAX_ONEHOT_BYTES
    assert tuning.REFERENCE_ONEHOT_LIMIT_BYTES == jtuning.VMEM_BUDGET


def test_auto_layout_on_cpu_follows_best_layout():
    _, tens, _ = _scenario("mixed")
    plan = Predictor.build(tens, device="cpu")
    assert plan.config.layout == "depth_grouped" == tuning.best_layout(
        tens.true_depths, tens.n_outputs, tens.n_features)


def test_pack_pool_u1_round_trip_matches_jax():
    rng = np.random.default_rng(4)
    for n, f in ((1, 1), (5, 31), (9, 32), (17, 70)):
        bins = rng.integers(0, 2, (n, f)).astype(np.uint8)
        planes = tlayout.pack_pool_u1(torch.from_numpy(bins))
        want = jlayout.pack_pool_u1(jnp.asarray(bins))
        _same(planes, want)
        assert planes.shape == (n, -(-f // 32))
        back = tlayout.unpack_pool_u1(planes, f)
        _same(back, jlayout.unpack_pool_u1(want, f))
        np.testing.assert_array_equal(back.numpy(), bins)


def test_binary_split_pool_shrinks_and_scores_the_same():
    arrays, x = _arrays(n_borders=1)
    tens = convert.ensemble_from_numpy(arrays)
    plan = Predictor.build(tens, device="cpu", layout="bitpacked")
    desc = plan.lowered.describe()
    assert desc["binary_split"] and desc["pool_shrink_x"] == 11 / 4
    pool = plan.quantize(x)
    back = tlayout.unpack_pool_u1(tlayout.pack_pool_u1(pool.bins), 11)
    repacked = dataclasses.replace(pool, bins=back.to(torch.uint8))
    assert torch.equal(plan.raw(repacked), plan.raw(pool))


def test_layout_table_lists_every_layout_with_kernels():
    table = tlayout.format_layout_table()
    assert table.count("\n") == len(tlayout.LAYOUTS) + 1
    for name, spec in tlayout.LAYOUTS.items():
        assert f"| {name}" in table
        for op in spec.claimed_ops:
            impls = registry.impls_for_layout(op, name)
            assert {i.split("_")[0] for i in impls} >= {"cuda", "torch"}, \
                (name, op, impls)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_server_reports_and_serves_the_layout(layout):
    jens, tens, x = _scenario("mixed")
    server = GBDTServer(tens, device="cpu", layout=layout, max_batch=16)
    try:
        assert server.metrics.layout == server.config.layout == layout
        got = server.predict_batch(x)
        pooled = server.predict_pool(server.quantize(x))
        assert server.metrics.snapshot()["layout"] == layout
    finally:
        server.close()
    want = np.asarray(JPredictor.build(jens, strategy="staged",
                                       backend="ref", layout=layout).proba(x))
    _close(got, want)
    _close(pooled, want)


def test_via_words_is_the_identity(scenario):
    _, _, tens, x = scenario
    bins = ref.binarize(torch.from_numpy(x), tens.borders).to(torch.uint8)
    for g in tlayout.lower(tens, "bitpacked").groups:
        direct = ref.leaf_index_bitpacked(bins, g.split_features_bp,
                                          g.split_bins_bp)
        words = ref.leaf_index_bitpacked(bins, g.split_features_bp,
                                         g.split_bins_bp, via_words=True)
        assert torch.equal(direct, words)
        _same(direct, jref.leaf_index_bitpacked(
            jnp.asarray(bins.numpy()), jnp.asarray(g.split_features_bp),
            jnp.asarray(g.split_bins_bp), via_words=True))

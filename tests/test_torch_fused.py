"""The three fused kernels' two routes (`csrc/fused_predict.cu`,
`csrc/fused_predict_dm.cu`, `csrc/fused_predict_bp.cu`, whose spread
routes share `csrc/fused_spread.cuh`), on the CPU.

Each kernel takes a serving bucket on its `spread` route (a few rows a
block, so the bucket fills the card; the trees in chunks whose leaf values
are copied into shared memory and summed in tree order) and many rows on
its `row` route (a thread a row).  The CPU cannot run either, so these
tests pin what decides and launches them:

  * `tuning.fused_plan` on hypothesis grids (N up to 200,000, T up to
    2,000, depth up to 16, C up to 200, F up to 30,000, uint8 and int32
    bins), for soa, for dm (`splits="planes"`) and for bp
    (`splits="bitpacked"`): its blocks cover every row once, its slabs
    every output once, its shared memory stays within the opt-in limit
    less the runtime's share (and, on dm, the level weights' static
    bytes; bp has none, so its spread plan is soa's), spread gives at
    least min(N, SM_COUNT) blocks where it is chosen, and row is chosen
    wherever spread's smallest chunk does not fit beside the block's rows
    of bins; the dm and bp row routes' tile is
    `tile_shape(..., planes=True)`;
  * each wrapper's launch, recorded on "meta" tensors, at 1, 16, 1,024
    and 139,440 rows and C = 7 and 33 (bp with uint8 and int32
    thresholds), on the plan's route and on the forced other one, and a
    forced spread that does not fit refused before any launch;
  * on the CPU each wrapper is the plain version on either route, equal to
    the JAX package's `fused_predict` / `fused_predict_dm` /
    `fused_predict_bp` within rtol = atol = 1e-4
    (tests/test_differential.py:88: the port sums trees in another order
    than XLA); dm and bp also against the JAX Pallas kernel in interpret
    mode on a tiny case.

The `cuda`-marked tests hold both routes against each other and against
the tree-order float32 sum bit for bit on the card, dm's and bp's also
against soa's on the same model, and skip here (`chip_smoke.py` holds
them on the H100).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import layout as jlayout  # noqa: E402
from repro.core import trees as jtrees  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import registry as jregistry  # noqa: E402
from repro_torch.core import layout as tlayout  # noqa: E402
from repro_torch.core import trees as ttrees  # noqa: E402
from repro_torch.kernels import _build, ops, ref, tuning  # noqa: E402
from repro_torch.kernels import fused_predict as fused_k  # noqa: E402

torch.set_num_threads(1)

GRID = settings(max_examples=200, deadline=None)
LIMIT = tuning.SMEM_OPTIN_LIMIT - tuning.SMEM_RESERVED_PER_BLOCK


def _covers(spans, n):
    return [i for a, b in spans for i in range(a, b)] == list(range(n)) \
        and all(b > a for a, b in spans)


def _spread_fits(n_rows, depth, n_outputs, n_features, u8, splits="rows"):
    slab = tuning.output_slabs(n_outputs)[0][1]
    rows = min(tuning.SPREAD_MAX_BLOCK_ROWS,
               tuning.SPREAD_MAX_ACC * tuning.SPREAD_THREADS // slab,
               max(1, n_rows // tuning.SM_COUNT))
    # the dm kernel's level weights are static shared memory
    static = tuning.SPREAD_WEIGHT_BYTES if splits == "planes" else 0
    return tuning.spread_smem_bytes(rows, 1, slab, depth, n_features,
                                    1 if u8 else 4) + static <= LIMIT


# --------------------------------------------------------------------------
# The plan
# --------------------------------------------------------------------------
@GRID
@given(n_rows=st.integers(1, 200_000), n_trees=st.integers(1, 2000),
       depth=st.integers(1, 16), n_outputs=st.integers(1, 200),
       n_features=st.integers(1, 30_000), u8=st.booleans())
def test_fused_plan_covers_rows_and_outputs(n_rows, n_trees, depth,
                                            n_outputs, n_features, u8):
    plan = tuning.fused_plan(n_rows, n_trees, depth, n_outputs, n_features,
                             u8)
    spans = tuning.output_slabs(n_outputs)
    assert _covers(spans, n_outputs)
    assert plan.n_slabs == len(spans) and plan.slab == spans[0][1]
    assert plan.n_blocks * plan.rows >= n_rows
    assert (plan.n_blocks - 1) * plan.rows < n_rows
    fits = _spread_fits(n_rows, depth, n_outputs, n_features, u8)
    assert (plan.route == "spread") == (fits and n_rows
                                        <= tuning.SPREAD_MAX_ROWS)
    if plan.route == "spread":
        assert plan.smem_bytes <= LIMIT
        assert plan.smem_bytes == tuning.spread_smem_bytes(
            plan.rows, plan.trees_per_chunk, plan.slab, depth, n_features,
            1 if u8 else 4)
        assert plan.n_blocks >= min(n_rows, tuning.SM_COUNT)
        assert 1 <= plan.rows <= tuning.SPREAD_MAX_BLOCK_ROWS
        assert 1 <= plan.trees_per_chunk <= n_trees
        assert plan.rows * plan.trees_per_chunk <= max(
            tuning.SPREAD_PAIRS, plan.rows)
        assert plan.threads % 32 == 0
        assert plan.rows * plan.slab <= tuning.SPREAD_MAX_ACC * plan.threads
        assert plan.tile is None
    else:
        assert plan.tile == tuning.tile_shape(n_features, u8)
        assert plan.rows == plan.threads == plan.tile.rows
        assert plan.smem_bytes == plan.tile.smem_bytes
        assert plan.smem_bytes <= tuning.SMEM_OPTIN_LIMIT


@GRID
@given(n_rows=st.integers(1, 200_000), n_trees=st.integers(1, 2000),
       depth=st.integers(1, 16), n_outputs=st.integers(1, 200),
       n_features=st.integers(1, 30_000), u8=st.booleans())
def test_fused_plan_forced_routes(n_rows, n_trees, depth, n_outputs,
                                  n_features, u8):
    row = tuning.fused_plan(n_rows, n_trees, depth, n_outputs, n_features,
                            u8, route="row")
    assert row.route == "row" and row.trees_per_chunk == n_trees
    if _spread_fits(n_rows, depth, n_outputs, n_features, u8):
        plan = tuning.fused_plan(n_rows, n_trees, depth, n_outputs,
                                 n_features, u8, route="spread")
        assert plan.route == "spread" and plan.smem_bytes <= LIMIT
        assert plan.n_blocks >= min(n_rows, tuning.SM_COUNT)
    else:
        with pytest.raises(ValueError, match="spread route"):
            tuning.fused_plan(n_rows, n_trees, depth, n_outputs, n_features,
                              u8, route="spread")


def test_the_documented_fused_plans():
    bucket = tuning.fused_plan(1024, 1000, 8, 7, 54, True)
    assert (bucket.route, bucket.rows, bucket.n_blocks,
            bucket.trees_per_chunk) == ("spread", 7, 147, 128)
    single = tuning.fused_plan(16, 1000, 8, 7, 54, True)
    assert (single.route, single.rows, single.n_blocks,
            single.trees_per_chunk) == ("spread", 1, 16, 1000)
    bulk = tuning.fused_plan(139_440, 1000, 8, 7, 54, True)
    assert (bulk.route, bulk.rows, bulk.n_blocks) == ("row", 128, 1090)
    knn = tuning.fused_plan(2841, 1000, 4, 20, 533, True)
    assert (knn.route, knn.rows, knn.n_blocks) == ("spread", 21, 136)
    assert tuning.spread_pitch(128, 7) % 32 == 7
    with pytest.raises(ValueError, match="route"):
        tuning.fused_plan(16, 10, 3, 7, 5, True, route="wide")


def test_one_int32_row_past_shared_memory_keeps_the_row_route():
    # 60,000 int32 bins are 240 KB: not one row fits beside a chunk
    plan = tuning.fused_plan(16, 100, 8, 7, 60_000, False)
    assert plan.route == "row" and plan.tile.route == "global"
    # 30,000 int32 bins (120 KB) fit one row a block
    assert tuning.fused_plan(16, 100, 8, 7, 30_000, False).route == "spread"
    assert tuning.fused_plan(1024, 100, 8, 7, 30_000, False).route == "row"


@GRID
@given(n_rows=st.integers(1, 200_000), n_trees=st.integers(1, 2000),
       depth=st.integers(1, 16), n_outputs=st.integers(1, 200),
       n_features=st.integers(1, 30_000), u8=st.booleans())
def test_dm_fused_plan_covers_rows_and_outputs(n_rows, n_trees, depth,
                                               n_outputs, n_features, u8):
    plan = tuning.fused_plan(n_rows, n_trees, depth, n_outputs, n_features,
                             u8, splits="planes")
    spans = tuning.output_slabs(n_outputs)
    assert plan.n_slabs == len(spans) and plan.slab == spans[0][1]
    assert plan.n_blocks * plan.rows >= n_rows
    assert (plan.n_blocks - 1) * plan.rows < n_rows
    fits = _spread_fits(n_rows, depth, n_outputs, n_features, u8,
                        "planes")
    assert (plan.route == "spread") == (fits and n_rows
                                        <= tuning.SPREAD_MAX_ROWS_DM)
    if plan.route == "spread":
        assert plan.smem_bytes + tuning.SPREAD_WEIGHT_BYTES <= LIMIT
        assert plan.smem_bytes == tuning.spread_smem_bytes(
            plan.rows, plan.trees_per_chunk, plan.slab, depth, n_features,
            1 if u8 else 4)
        assert plan.n_blocks >= min(n_rows, tuning.SM_COUNT)
        assert 1 <= plan.rows <= tuning.SPREAD_MAX_BLOCK_ROWS
        assert 1 <= plan.trees_per_chunk <= n_trees
        assert plan.rows * plan.trees_per_chunk <= max(
            tuning.SPREAD_PAIRS, plan.rows)
        assert plan.threads % 32 == 0
        assert plan.rows * plan.slab <= tuning.SPREAD_MAX_ACC * plan.threads
        assert plan.tile is None
        # the spread half is soa's, but for the weights' 64 bytes
        soa = tuning.fused_plan(n_rows, n_trees, depth, n_outputs,
                                n_features, u8, route="spread")
        assert (soa.rows, soa.threads, soa.n_blocks, soa.slab) == (
            plan.rows, plan.threads, plan.n_blocks, plan.slab)
        assert soa.trees_per_chunk >= plan.trees_per_chunk
    else:
        assert plan.tile == tuning.tile_shape(n_features, u8, planes=True)
        assert plan.rows == plan.threads == plan.tile.rows
        assert plan.smem_bytes == plan.tile.smem_bytes
        assert plan.smem_bytes <= tuning.SMEM_OPTIN_LIMIT
        assert plan.trees_per_chunk == n_trees


@GRID
@given(n_rows=st.integers(1, 200_000), n_trees=st.integers(1, 2000),
       depth=st.integers(1, 16), n_outputs=st.integers(1, 200),
       n_features=st.integers(1, 30_000), u8=st.booleans())
def test_dm_fused_plan_forced_routes(n_rows, n_trees, depth, n_outputs,
                                     n_features, u8):
    row = tuning.fused_plan(n_rows, n_trees, depth, n_outputs, n_features,
                            u8, route="row", splits="planes")
    assert row.route == "row" and row.trees_per_chunk == n_trees
    assert row.tile == tuning.tile_shape(n_features, u8, planes=True)
    if _spread_fits(n_rows, depth, n_outputs, n_features, u8, "planes"):
        plan = tuning.fused_plan(n_rows, n_trees, depth, n_outputs,
                                 n_features, u8, route="spread",
                                 splits="planes")
        assert plan.route == "spread"
        assert plan.smem_bytes + tuning.SPREAD_WEIGHT_BYTES <= LIMIT
        assert plan.n_blocks >= min(n_rows, tuning.SM_COUNT)
    else:
        with pytest.raises(ValueError, match="spread route"):
            tuning.fused_plan(n_rows, n_trees, depth, n_outputs, n_features,
                              u8, route="spread", splits="planes")


def test_the_documented_dm_fused_plans():
    def plan(n, *args, **kw):
        return tuning.fused_plan(n, 1000, 8, 7, 54, True, *args,
                                 splits="planes", **kw)
    bucket = plan(1024)
    assert (bucket.route, bucket.rows, bucket.n_blocks, bucket.threads,
            bucket.trees_per_chunk) == ("spread", 7, 147, 512, 128)
    single = plan(16)
    assert (single.route, single.rows, single.n_blocks,
            single.trees_per_chunk) == ("spread", 1, 16, 1000)
    bulk = plan(139_440)
    assert (bulk.route, bulk.rows, bulk.n_blocks) == ("row", 128, 1090)
    assert bulk.tile == tuning.tile_shape(54, True, planes=True)
    # dm's threshold is its own (set from the route sweep on the card)
    assert tuning.SPREAD_MAX_ROWS_DM == 32_768 > tuning.SPREAD_MAX_ROWS
    assert plan(tuning.SPREAD_MAX_ROWS_DM).route == "spread"
    assert plan(tuning.SPREAD_MAX_ROWS_DM + 1).route == "row"
    assert tuning.fused_plan(tuning.SPREAD_MAX_ROWS + 1, 1000, 8, 7, 54,
                             True).route == "row"
    # on the spread route dm's plan is soa's at these shapes
    for n in (16, 1024):
        assert plan(n) == tuning.fused_plan(n, 1000, 8, 7, 54, True)
    knn = tuning.fused_plan(2841, 1000, 4, 20, 533, True, splits="planes")
    assert (knn.route, knn.rows, knn.n_blocks) == ("spread", 21, 136)
    with pytest.raises(ValueError, match="route"):
        tuning.fused_plan(16, 10, 3, 7, 5, True, route="wide",
                          splits="planes")


@GRID
@given(n_rows=st.integers(1, 200_000), n_trees=st.integers(1, 2000),
       depth=st.integers(1, 16), n_outputs=st.integers(1, 200),
       n_features=st.integers(1, 30_000), u8=st.booleans())
def test_bp_fused_plan_covers_rows_and_outputs(n_rows, n_trees, depth,
                                               n_outputs, n_features, u8):
    plan = tuning.fused_plan(n_rows, n_trees, depth, n_outputs, n_features,
                             u8, splits="bitpacked")
    spans = tuning.output_slabs(n_outputs)
    assert plan.n_slabs == len(spans) and plan.slab == spans[0][1]
    assert plan.n_blocks * plan.rows >= n_rows
    assert (plan.n_blocks - 1) * plan.rows < n_rows
    fits = _spread_fits(n_rows, depth, n_outputs, n_features, u8,
                        "bitpacked")
    assert (plan.route == "spread") == (fits and n_rows
                                        <= tuning.SPREAD_MAX_ROWS_BP)
    if plan.route == "spread":
        # no weights: the whole limit is the block's
        assert plan.smem_bytes <= LIMIT
        assert plan.smem_bytes == tuning.spread_smem_bytes(
            plan.rows, plan.trees_per_chunk, plan.slab, depth, n_features,
            1 if u8 else 4)
        assert plan.n_blocks >= min(n_rows, tuning.SM_COUNT)
        assert 1 <= plan.rows <= tuning.SPREAD_MAX_BLOCK_ROWS
        assert 1 <= plan.trees_per_chunk <= n_trees
        assert plan.rows * plan.trees_per_chunk <= max(
            tuning.SPREAD_PAIRS, plan.rows)
        assert plan.threads % 32 == 0
        assert plan.rows * plan.slab <= tuning.SPREAD_MAX_ACC * plan.threads
        assert plan.tile is None
        # the same (D, chunk) pairs in the same limit: soa's spread plan
        assert plan == tuning.fused_plan(n_rows, n_trees, depth, n_outputs,
                                         n_features, u8, route="spread")
    else:
        assert plan.tile == tuning.tile_shape(n_features, u8, planes=True)
        assert plan.rows == plan.threads == plan.tile.rows
        assert plan.smem_bytes == plan.tile.smem_bytes
        assert plan.smem_bytes <= tuning.SMEM_OPTIN_LIMIT
        assert plan.trees_per_chunk == n_trees


@GRID
@given(n_rows=st.integers(1, 200_000), n_trees=st.integers(1, 2000),
       depth=st.integers(1, 16), n_outputs=st.integers(1, 200),
       n_features=st.integers(1, 30_000), u8=st.booleans())
def test_bp_fused_plan_forced_routes(n_rows, n_trees, depth, n_outputs,
                                     n_features, u8):
    row = tuning.fused_plan(n_rows, n_trees, depth, n_outputs, n_features,
                            u8, route="row", splits="bitpacked")
    assert row.route == "row" and row.trees_per_chunk == n_trees
    assert row.tile == tuning.tile_shape(n_features, u8, planes=True)
    if _spread_fits(n_rows, depth, n_outputs, n_features, u8, "bitpacked"):
        plan = tuning.fused_plan(n_rows, n_trees, depth, n_outputs,
                                 n_features, u8, route="spread",
                                 splits="bitpacked")
        assert plan.route == "spread" and plan.smem_bytes <= LIMIT
        assert plan.n_blocks >= min(n_rows, tuning.SM_COUNT)
    else:
        with pytest.raises(ValueError, match="spread route"):
            tuning.fused_plan(n_rows, n_trees, depth, n_outputs, n_features,
                              u8, route="spread", splits="bitpacked")


def test_the_documented_bp_fused_plans():
    def plan(n, *args, **kw):
        return tuning.fused_plan(n, 1000, 8, 7, 54, True, *args,
                                 splits="bitpacked", **kw)
    bucket = plan(1024)
    assert (bucket.route, bucket.rows, bucket.n_blocks, bucket.threads,
            bucket.trees_per_chunk) == ("spread", 7, 147, 512, 128)
    single = plan(16)
    assert (single.route, single.rows, single.n_blocks,
            single.trees_per_chunk) == ("spread", 1, 16, 1000)
    bulk = plan(139_440)
    assert (bulk.route, bulk.rows, bulk.n_blocks) == ("row", 128, 1090)
    assert bulk.tile == tuning.tile_shape(54, True, planes=True)
    # bp's threshold is its own (set from the route sweep on the card)
    assert plan(tuning.SPREAD_MAX_ROWS_BP).route == "spread"
    assert plan(tuning.SPREAD_MAX_ROWS_BP + 1).route == "row"
    # on the spread route bp's plan is soa's and dm's at these shapes
    for n in (16, 1024):
        assert plan(n) == tuning.fused_plan(n, 1000, 8, 7, 54, True)
        assert plan(n) == tuning.fused_plan(n, 1000, 8, 7, 54, True,
                                            splits="planes")
    knn = tuning.fused_plan(2841, 1000, 4, 20, 533, True, splits="bitpacked")
    assert (knn.route, knn.rows, knn.n_blocks) == ("spread", 21, 136)
    with pytest.raises(ValueError, match="route"):
        plan(16, route="wide")
    with pytest.raises(ValueError, match="splits"):
        tuning.fused_plan(16, 10, 3, 7, 5, True, splits="bp")


def _fits_one_row(n_features, splits):
    return tuning.fused_plan(16, 100, 8, 7, n_features, True,
                             splits=splits).route == "spread"


def _widest_one_row():
    """The widest uint8 row a one-row soa spread block takes."""
    return max(f for f in range(225_000, 232_448)
               if _spread_fits(16, 8, 7, f, True))


def test_the_dm_weights_take_their_bytes_from_the_limit():
    # the widest uint8 row a one-row soa spread block takes, past it dm's
    widest = _widest_one_row()
    assert _fits_one_row(widest, "rows")
    assert not _fits_one_row(widest + 1, "rows")
    assert not _fits_one_row(widest, "planes")
    assert _fits_one_row(widest - 64, "planes")


def test_bp_has_no_weights_to_take_from_the_limit():
    # the bp spread kernel declares no static shared memory, so its plan
    # takes soa's widest row and no more, where dm's stops 64 bytes short
    widest = _widest_one_row()
    assert _fits_one_row(widest, "bitpacked")
    assert not _fits_one_row(widest + 1, "bitpacked")
    assert not _fits_one_row(widest, "planes")


# --------------------------------------------------------------------------
# The wrapper's launch
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


@pytest.mark.parametrize("n_rows", (1, 16, 1024, 139_440))
@pytest.mark.parametrize("n_outputs", (7, 33))
def test_wrapper_launches_the_plan(launches, n_rows, n_outputs):
    t, d, f, n_borders = 1000, 8, 54, 63
    i32 = torch.int32
    args = (_meta(n_rows, f), _meta(n_borders, f), _meta(t, d, dtype=i32),
            _meta(t, d, dtype=i32), _meta(t, 1 << d, n_outputs))
    plan = tuning.fused_plan(n_rows, t, d, n_outputs, f, True)
    other = "row" if plan.route == "spread" else "spread"
    for route in (None, other):
        out = fused_k.fused_predict(*args, route=route)
        assert out.shape == (n_rows, n_outputs)
    (first, a), (second, b) = launches
    assert a[:5] == args and b[:5] == args
    assert a[5].shape == (n_rows, n_outputs)
    slab = tuning.output_slabs(n_outputs)[0][1]
    spread = tuning.fused_plan(n_rows, t, d, n_outputs, f, True, "spread")
    tile = tuning.tile_shape(f, True)
    want = {"repro_fused_predict_spread": (
                n_rows, f, n_borders, t, d, n_outputs, 1, spread.rows,
                spread.threads, spread.trees_per_chunk, slab),
            "repro_fused_predict": (
                None, n_rows, f, n_borders, t, d, n_outputs, 1, tile.stride,
                tile.rows, slab)}
    name = {"spread": "repro_fused_predict_spread",
            "row": "repro_fused_predict"}
    assert (first, second) == (name[plan.route], name[other])
    assert a[6:] == want[first] and b[6:] == want[second]
    assert plan.route == ("spread" if n_rows <= 1024 else "row")
    assert fused_k.fused_predict.launches == 2


def test_wrapper_refuses_a_spread_that_does_not_fit(launches):
    i32 = torch.int32
    args = (_meta(16, 60_000), _meta(300, 60_000), _meta(4, 3, dtype=i32),
            _meta(4, 3, dtype=i32), _meta(4, 8, 7))
    with pytest.raises(ValueError, match="spread route"):
        fused_k.fused_predict(*args, route="spread")
    fused_k.fused_predict(*args)
    (name, a), = launches
    assert name == "repro_fused_predict" and a[6].shape == (16, 60_000)
    assert fused_k.fused_predict.launches == 1


@pytest.mark.parametrize("n_rows", (1, 16, 1024, 139_440))
@pytest.mark.parametrize("n_outputs", (7, 33))
def test_dm_wrapper_launches_the_plan(launches, n_rows, n_outputs):
    t, d, f, n_borders = 1000, 8, 54, 63
    i32 = torch.int32
    args = (_meta(n_rows, f), _meta(n_borders, f), _meta(d, t, dtype=i32),
            _meta(d, t, dtype=i32), _meta(d, 1), _meta(t, 1 << d, n_outputs))
    plan = tuning.fused_plan(n_rows, t, d, n_outputs, f, True,
                             splits="planes")
    other = "row" if plan.route == "spread" else "spread"
    for route in (None, other):
        out = fused_k.fused_predict_dm(*args, route=route)
        assert out.shape == (n_rows, n_outputs)
    (first, a), (second, b) = launches
    assert a[:6] == args and b[:6] == args
    assert a[6].shape == (n_rows, n_outputs)
    slab = tuning.output_slabs(n_outputs)[0][1]
    spread = tuning.fused_plan(n_rows, t, d, n_outputs, f, True, "spread",
                               splits="planes")
    tile = tuning.tile_shape(f, True, planes=True)
    want = {"repro_fused_predict_dm_spread": (
                n_rows, f, n_borders, t, d, n_outputs, 1, spread.rows,
                spread.threads, spread.trees_per_chunk, slab),
            "repro_fused_predict_dm": (
                None, n_rows, f, n_borders, t, d, n_outputs, 1, tile.stride,
                tile.rows, slab)}
    name = {"spread": "repro_fused_predict_dm_spread",
            "row": "repro_fused_predict_dm"}
    assert (first, second) == (name[plan.route], name[other])
    assert a[7:] == want[first] and b[7:] == want[second]
    assert plan.route == ("spread" if n_rows <= 1024 else "row")
    assert fused_k.fused_predict_dm.launches == 2
    assert fused_k.fused_predict.launches == 0


def test_dm_wrapper_refuses_a_spread_that_does_not_fit(launches):
    i32 = torch.int32
    args = (_meta(16, 60_000), _meta(300, 60_000), _meta(3, 4, dtype=i32),
            _meta(3, 4, dtype=i32), _meta(3, 1), _meta(4, 8, 7))
    with pytest.raises(ValueError, match="spread route"):
        fused_k.fused_predict_dm(*args, route="spread")
    with pytest.raises(ValueError, match="route"):
        fused_k.fused_predict_dm(*args, route="wide")
    assert launches == []
    fused_k.fused_predict_dm(*args)
    (name, a), = launches
    assert name == "repro_fused_predict_dm" and a[7].shape == (16, 60_000)
    assert a[7].dtype == torch.int32
    assert fused_k.fused_predict_dm.launches == 1


@pytest.mark.parametrize("n_rows", (1, 16, 1024, 139_440))
@pytest.mark.parametrize("n_outputs", (7, 33))
@pytest.mark.parametrize("plane", (torch.uint8, torch.int32))
def test_bp_wrapper_launches_the_plan(launches, n_rows, n_outputs, plane):
    t, d, f, n_borders = 1000, 8, 54, 63
    args = (_meta(n_rows, f), _meta(n_borders, f),
            _meta(d, t, dtype=torch.int32), _meta(d, t, dtype=plane),
            _meta(t, 1 << d, n_outputs))
    plan = tuning.fused_plan(n_rows, t, d, n_outputs, f, True,
                             splits="bitpacked")
    other = "row" if plan.route == "spread" else "spread"
    for route in (None, other):
        out = fused_k.fused_predict_bp(*args, route=route)
        assert out.shape == (n_rows, n_outputs)
    (first, a), (second, b) = launches
    assert a[:5] == args and b[:5] == args
    assert a[5].shape == (n_rows, n_outputs)
    slab = tuning.output_slabs(n_outputs)[0][1]
    spread = tuning.fused_plan(n_rows, t, d, n_outputs, f, True, "spread",
                               splits="bitpacked")
    tile = tuning.tile_shape(f, True, planes=True)
    u8_planes = int(plane == torch.uint8)
    want = {"repro_fused_predict_bp_spread": (
                n_rows, f, n_borders, t, d, n_outputs, 1, u8_planes,
                spread.rows, spread.threads, spread.trees_per_chunk, slab),
            "repro_fused_predict_bp": (
                None, n_rows, f, n_borders, t, d, n_outputs, 1, u8_planes,
                tile.stride, tile.rows, slab)}
    name = {"spread": "repro_fused_predict_bp_spread",
            "row": "repro_fused_predict_bp"}
    assert (first, second) == (name[plan.route], name[other])
    assert a[6:] == want[first] and b[6:] == want[second]
    assert plan.route == ("spread" if n_rows <= 1024 else "row")
    assert fused_k.fused_predict_bp.launches == 2
    assert fused_k.fused_predict.launches == 0
    assert fused_k.fused_predict_dm.launches == 0


def test_bp_wrapper_refuses_a_spread_that_does_not_fit(launches):
    args = (_meta(16, 60_000), _meta(300, 60_000),
            _meta(3, 4, dtype=torch.int32), _meta(3, 4, dtype=torch.uint8),
            _meta(4, 8, 7))
    with pytest.raises(ValueError, match="spread route"):
        fused_k.fused_predict_bp(*args, route="spread")
    with pytest.raises(ValueError, match="route"):
        fused_k.fused_predict_bp(*args, route="wide")
    assert launches == []
    fused_k.fused_predict_bp(*args)
    (name, a), = launches
    assert name == "repro_fused_predict_bp" and a[6].shape == (16, 60_000)
    assert a[6].dtype == torch.int32
    assert fused_k.fused_predict_bp.launches == 1


# --------------------------------------------------------------------------
# On the CPU: the plain version on either route, against the JAX package
# --------------------------------------------------------------------------
def _case(n, f, n_borders, t, d, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    borders = np.sort(rng.normal(size=(n_borders, f)), 0).astype(np.float32)
    sf = rng.integers(0, f, (t, d)).astype(np.int32)
    sb = rng.integers(1, n_borders + 1, (t, d)).astype(np.int32)
    sb[rng.random(sb.shape) < 0.1] = ops.PAD_SPLIT_BIN
    lv = rng.normal(size=(t, 1 << d, c)).astype(np.float32)
    return x, borders, sf, sb, lv


@pytest.mark.parametrize("n_outputs", (1, 7, 20, 33))
@pytest.mark.parametrize("n_borders", (9, 300))
def test_both_routes_match_jax_on_the_cpu(n_outputs, n_borders):
    arrays = _case(17, 6, n_borders, 11, 4, n_outputs, seed=n_outputs)
    want = np.asarray(jref.fused_predict(*map(jnp.asarray, arrays)))
    tens = [torch.from_numpy(a) for a in arrays]
    plain = ref.fused_predict(*tens)
    for route in (None, "spread", "row"):
        got = fused_k.fused_predict(*tens, route=route)
        assert torch.equal(got, plain)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="route"):
        fused_k.fused_predict(*tens, route="wide")


def _dm_layouts(x, borders, sf, sb, lv):
    """The JAX package's depth_major lowering (backend "ref") and the
    port's, of one model."""
    n_borders = np.full((borders.shape[1],), borders.shape[0], np.int32)
    jens = jtrees.ObliviousEnsemble(*map(jnp.asarray, (sf, sb, lv, borders,
                                                       n_borders)))
    tens = ttrees.ObliviousEnsemble(*(torch.from_numpy(a) for a in (
        sf, sb, lv, borders, n_borders)))
    return (jlayout.lower(jens, "depth_major", backend="ref"),
            tlayout.lower(tens, "depth_major"))


def _dm_args(dm, x):
    return (torch.from_numpy(x), dm.borders, dm.split_features_dm,
            dm.split_bins_dm, dm.pow2, dm.leaf_values)


@pytest.mark.parametrize("n_outputs", (1, 7, 20, 33))
@pytest.mark.parametrize("n_borders", (9, 300))
def test_dm_routes_match_jax_on_the_cpu(n_outputs, n_borders):
    arrays = _case(17, 6, n_borders, 11, 4, n_outputs, seed=n_outputs + 50)
    jdm, dm = _dm_layouts(*arrays)
    x = arrays[0]
    want = np.asarray(jref.fused_predict_depth_major(
        jnp.asarray(x), jdm.borders, jdm.onehot, jdm.split_bins_dm, jdm.pow2,
        jdm.leaf_values))
    args = _dm_args(dm, x)
    plain = ref.fused_predict_depth_major(*args)
    # depth_major is soa's function on soa's model
    soa = ref.fused_predict(*(torch.from_numpy(a) for a in arrays))
    assert torch.equal(plain, soa)
    launched = fused_k.fused_predict_dm.launches
    for route in (None, "spread", "row"):
        got = fused_k.fused_predict_dm(*args, route=route)
        assert torch.equal(got, plain)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert fused_k.fused_predict_dm.launches == launched   # no kernel


@pytest.mark.parametrize("n_borders", (9, 300))
def test_dm_routes_match_pallas_interpret(n_borders):
    # tiny: Pallas interprets on the CPU (<= 10 trees, depth <= 3, <= 8 rows)
    arrays = _case(8, 5, n_borders, 10, 3, 7, seed=n_borders)
    jdm, dm = _dm_layouts(*arrays)
    x = arrays[0]
    want = np.asarray(jregistry.get("fused_predict", "pallas_dm").fn(
        jnp.asarray(x), jdm.borders, jdm.onehot, jdm.split_bins_dm, jdm.pow2,
        jdm.leaf_values))
    args = _dm_args(dm, x)
    for route in (None, "spread", "row"):
        np.testing.assert_allclose(
            fused_k.fused_predict_dm(*args, route=route).numpy(), want,
            rtol=1e-4, atol=1e-4)


def _bp_case(n, f, n_borders, t, d, c, seed):
    """`_case` with every tree at full depth (no pad on the last level), so
    that the bitpacked lowering keeps one group, the trees in model order.
    With <= 255 borders and no pad at all its thresholds are uint8; with
    more, int32, pads between real levels included."""
    x, borders, sf, sb, lv = _case(n, f, n_borders, t, d, c, seed)
    rng = np.random.default_rng(seed + 1)
    if n_borders <= 255:
        pad = sb == ops.PAD_SPLIT_BIN
    else:
        pad = np.zeros_like(sb, bool)
        pad[:, -1] = sb[:, -1] == ops.PAD_SPLIT_BIN
    sb[pad] = rng.integers(1, n_borders + 1, int(pad.sum()))
    return x, borders, sf, sb, lv


def _bp_layouts(x, borders, sf, sb, lv):
    """The one group of the JAX package's bitpacked lowering (backend
    "ref") and of the port's, of one model."""
    n_borders = np.full((borders.shape[1],), borders.shape[0], np.int32)
    jens = jtrees.ObliviousEnsemble(*map(jnp.asarray, (sf, sb, lv, borders,
                                                       n_borders)))
    tens = ttrees.ObliviousEnsemble(*(torch.from_numpy(a) for a in (
        sf, sb, lv, borders, n_borders)))
    (jg,) = jlayout.lower(jens, "bitpacked", backend="ref").groups
    (g,) = tlayout.lower(tens, "bitpacked").groups
    return jg, g


def _bp_planes(g):
    """The group's thresholds as lowered and, when uint8, widened to int32:
    the kernel's two threshold types on one model."""
    planes = [g.split_bins_bp]
    if g.split_bins_bp.dtype == torch.uint8:
        planes.append(g.split_bins_bp.int())
    return planes


@pytest.mark.parametrize("n_outputs", (1, 7, 20, 33))
@pytest.mark.parametrize("n_borders", (9, 300))
def test_bp_routes_match_jax_on_the_cpu(n_outputs, n_borders):
    arrays = _bp_case(17, 6, n_borders, 11, 4, n_outputs,
                      seed=n_outputs + 70)
    jg, g = _bp_layouts(*arrays)
    assert g.split_bins_bp.dtype == (torch.uint8 if n_borders <= 255
                                     else torch.int32)
    x = torch.from_numpy(arrays[0])
    borders = torch.from_numpy(arrays[1])
    want = np.asarray(jref.fused_predict_bitpacked(
        jnp.asarray(arrays[0]), jnp.asarray(arrays[1]), jg.split_features_bp,
        jg.split_bins_bp, jg.leaf_values))
    # one-group bitpacked is soa's function on soa's model, trees in order
    soa = ref.fused_predict(*(torch.from_numpy(a) for a in arrays))
    launched = fused_k.fused_predict_bp.launches
    for sb in _bp_planes(g):
        args = (x, borders, g.split_features_bp, sb, g.leaf_values)
        plain = ref.fused_predict_bitpacked(*args)
        assert torch.equal(plain, soa)
        for route in (None, "spread", "row"):
            got = fused_k.fused_predict_bp(*args, route=route)
            assert torch.equal(got, plain)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=1e-4)
    assert fused_k.fused_predict_bp.launches == launched   # no kernel


@pytest.mark.parametrize("n_borders", (9, 300))
def test_bp_routes_match_pallas_interpret(n_borders):
    # tiny and pre-padded: 8 rows and 16 trees of depth 3 (Pallas
    # interprets on the CPU; block_n 32 and block_t 16 need no padding of
    # the trees)
    arrays = _bp_case(8, 5, n_borders, 16, 3, 7, seed=n_borders + 1)
    jg, g = _bp_layouts(*arrays)
    x = arrays[0]
    want = np.asarray(jregistry.get("fused_predict", "pallas_bp").fn(
        jnp.asarray(x), jnp.asarray(arrays[1]), jg.split_features_bp,
        jg.split_bins_bp, jg.leaf_values, block_n=32, block_t=16))
    for sb in _bp_planes(g):
        args = (torch.from_numpy(x), torch.from_numpy(arrays[1]),
                g.split_features_bp, sb, g.leaf_values)
        for route in (None, "spread", "row"):
            np.testing.assert_allclose(
                fused_k.fused_predict_bp(*args, route=route).numpy(), want,
                rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(chip_smoke.py holds both routes on the H100)")
    return torch.device("cuda")


def _tree_order_sum(idx, lv):
    acc = torch.zeros((idx.shape[0], lv.shape[2]), device=idx.device)
    for t in range(idx.shape[1]):
        acc += lv[t][idx[:, t].long()]
    return acc


@pytest.mark.cuda
@pytest.mark.parametrize("n_outputs", (1, 7, 20, 33))
@pytest.mark.parametrize("n_borders", (63, 300))
def test_both_routes_are_the_tree_order_sum_on_the_card(card, n_outputs,
                                                        n_borders):
    x, borders, sf, sb, lv = (torch.from_numpy(a).to(card) for a in _case(
        1024, 54, n_borders, 300, 8, n_outputs, seed=n_borders))
    for n in (1, 16, 17, 1024):
        xn = x[:n]
        idx = ref.leaf_index(ref.binarize(xn, borders), sf, sb)
        exact = _tree_order_sum(idx, lv)
        routes = [fused_k.fused_predict(xn, borders, sf, sb, lv, route=r)
                  for r in ("spread", "row")]
        assert torch.equal(routes[0], exact) and torch.equal(routes[1],
                                                             exact)
        np.testing.assert_allclose(
            routes[0].cpu().numpy(),
            ref.fused_predict(*(a.cpu() for a in (xn, borders, sf, sb, lv)))
            .numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n_outputs", (1, 7, 20, 33))
@pytest.mark.parametrize("n_borders", (63, 300))
def test_dm_routes_are_soa_and_the_tree_order_sum_on_the_card(
        card, n_outputs, n_borders):
    arrays = _case(1024, 54, n_borders, 300, 8, n_outputs, seed=n_borders)
    _, dm = _dm_layouts(*arrays)
    x, borders, sf, sb, lv = (torch.from_numpy(a).to(card) for a in arrays)
    planes = [a.to(card) for a in (dm.split_features_dm, dm.split_bins_dm,
                                   dm.pow2, dm.leaf_values)]
    for n in (1, 16, 17, 1024):
        xn = x[:n]
        idx = ref.leaf_index(ref.binarize(xn, borders), sf, sb)
        exact = _tree_order_sum(idx, lv)
        for route in ("spread", "row"):
            got = fused_k.fused_predict_dm(xn, borders, *planes, route=route)
            assert torch.equal(got, exact), (route, n)
            assert torch.equal(got, fused_k.fused_predict(
                xn, borders, sf, sb, lv, route=route)), (route, n)


@pytest.mark.cuda
@pytest.mark.parametrize("n_outputs", (1, 7, 20, 33))
@pytest.mark.parametrize("n_borders", (63, 300))
def test_bp_routes_are_soa_and_the_tree_order_sum_on_the_card(
        card, n_outputs, n_borders):
    arrays = _bp_case(1024, 54, n_borders, 300, 8, n_outputs,
                      seed=n_borders)
    _, g = _bp_layouts(*arrays)
    x, borders, sf, sb, lv = (torch.from_numpy(a).to(card) for a in arrays)
    sf_bp, lv_bp = g.split_features_bp.to(card), g.leaf_values.to(card)
    for n in (1, 16, 17, 1024):
        xn = x[:n]
        idx = ref.leaf_index(ref.binarize(xn, borders), sf, sb)
        exact = _tree_order_sum(idx, lv)
        for plane in _bp_planes(g):
            for route in ("spread", "row"):
                got = fused_k.fused_predict_bp(xn, borders, sf_bp,
                                               plane.to(card), lv_bp,
                                               route=route)
                assert torch.equal(got, exact), (route, n, plane.dtype)
                assert torch.equal(got, fused_k.fused_predict(
                    xn, borders, sf, sb, lv, route=route)), (route, n)

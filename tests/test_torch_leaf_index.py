"""The leaf-index kernel body of `leaf_index` and `leaf_index_dm`
(`src/repro_torch/kernels/csrc/leaf_index.cuh`), on the CPU.

The CUDA kernel runs only on the card (`chip_smoke.py` holds both
launchers against their plain versions there, and the `cuda`-marked test
below does where there is one).  Here:

  * `tuning.index_plan` on a hypothesis grid (N to 400,000, T to 2,000,
    depth 1-16, F to 20,000, uint8 and int32 bins): its row blocks and
    tree groups cover every (row, tree) exactly once, it launches at least
    SM_COUNT blocks wherever N and T allow that many, and its shared
    memory fits the opt-in limit or it takes the global route;
  * `walk`, the kernel's walk written in plain PyTorch: a block's rows
    staged as a transposed (F + 1, rows + 4) tile with a zero column last,
    int32 bins narrowed to bytes where all of a block's fit, rounds of 256
    trees a lane each, the round's (feature, threshold) int2 pairs staged
    from (T, D) rows or (D, T) planes, tree groups, passes of G 4-row words
    spread over 8 warps (each (row, tree) stored once), uint8 words
    compared 4 bytes at a time (SWAR) and int32 words row by row.  It
    equals `ref.leaf_index`, `ref.leaf_index_depth_major` and the JAX
    package's `leaf_index` / `leaf_index_u8` / `leaf_index_dm` in Pallas
    interpret mode, exactly, on numpy-seeded inputs: T = 1, 31, 33, 255,
    257 and depth 1 and 16, padded trees, thresholds at and past the byte's
    ends;
  * each wrapper launches with the plan's arguments.

JAX is imported inside the one test that runs it, so `python -m pytest -m
cuda tests/test_torch_leaf_index.py` runs the card's test where JAX is not
installed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.kernels import _build, ops, ref, tuning  # noqa: E402
from repro_torch.kernels import leaf_index as index_k  # noqa: E402

torch.set_num_threads(1)

PAD = ops.PAD_SPLIT_BIN
WARPS = tuning.INDEX_WARPS
ROUND = tuning.INDEX_ROUND_TREES
U32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# The plan
# --------------------------------------------------------------------------
def _spans(n, width, count):
    """[start, stop) of each of `count` pieces of `width` over range(n)."""
    return [(i * width, min(n, (i + 1) * width)) for i in range(count)]


def _tiles_once(spans, n):
    return spans[0][0] == 0 and spans[-1][1] == n and all(
        a < b for a, b in spans) and all(
        spans[i][1] == spans[i + 1][0] for i in range(len(spans) - 1))


@settings(max_examples=300, deadline=None)
@given(n_rows=st.integers(1, 400_000), n_trees=st.integers(1, 2000),
       depth=st.integers(1, 16), n_features=st.integers(1, 20_000),
       u8=st.booleans())
def test_plan_covers_every_row_and_tree_once(n_rows, n_trees, depth,
                                             n_features, u8):
    bin_bytes = 1 if u8 else 4
    plan = tuning.index_plan(n_rows, n_trees, depth, n_features, bin_bytes)
    rows = plan.tile.rows
    # the kernel takes 8, 16 or a multiple of 32 rows a block
    assert rows in tuning.INDEX_ROWS and (rows in (8, 16) or rows % 32 == 0)
    # row blocks x tree groups (of rounds of 256 trees) tile N x T: every
    # (row, tree) in exactly one block
    rounds = -(-n_trees // ROUND)
    assert _tiles_once(_spans(n_rows, rows, plan.n_row_tiles), n_rows)
    groups = _spans(rounds, plan.rounds_per_group, plan.n_tree_groups)
    assert _tiles_once(groups, rounds)
    assert plan.n_tree_groups <= tuning.GRID_DIM_LIMIT
    # at least SM_COUNT blocks wherever the finest split has that many
    fits = [r for r in tuning.INDEX_ROWS
            if plan.tile.static_bytes + tuning.index_tile_bytes(
                r, n_features, bin_bytes) <= tuning.SMEM_OPTIN_LIMIT]
    finest = -(-n_rows // min(fits or tuning.INDEX_ROWS)) * rounds
    assert plan.n_blocks >= min(finest, tuning.SM_COUNT)
    if plan.n_row_tiles >= tuning.SM_COUNT:
        assert plan.n_tree_groups == 1
    # shared memory within the opt-in limit, or the global route
    assert plan.tile.static_bytes == depth * ROUND * tuning.INDEX_PAIR_BYTES
    assert plan.tile.smem_bytes <= tuning.SMEM_OPTIN_LIMIT
    assert (plan.tile.route == "shared") == bool(fits)
    if plan.tile.route == "shared":
        assert plan.tile.stride == rows + tuning.INDEX_PITCH_PAD
        assert plan.tile.tile_bytes == (n_features + 1) * plan.tile.stride \
            * bin_bytes
    else:
        assert plan.tile.tile_bytes == 0
        assert plan.tile.stride == n_features


def test_the_documented_plans():
    # Covertype width, 54 uint8 features, depth 8 (tuning.index_plan)
    def shape(*args):
        plan = tuning.index_plan(*args)
        return (plan.tile.rows, plan.n_row_tiles, plan.n_tree_groups,
                plan.rounds_per_group)
    assert shape(139_440, 1000, 8, 54, 1) == (64, 2179, 1, 4)
    assert shape(1024, 1000, 8, 54, 1) == (16, 64, 4, 1)
    assert shape(16, 1000, 8, 54, 1) == (8, 2, 4, 1)
    assert shape(1024, 12, 5, 54, 1) == (8, 128, 1, 1)
    assert tuning.index_plan(139_440, 1000, 8, 54, 1).tile.smem_bytes \
        == 16_384 + 55 * 68


# --------------------------------------------------------------------------
# The walk, in plain PyTorch
# --------------------------------------------------------------------------
def _swar_ge(word, thr):
    """Bit 7 of each byte: that byte of `word` >= that byte of `thr`
    (every byte of `thr` the same), as the kernel computes it."""
    low = thr & 0x7F7F7F7F
    t = ((word | 0x80808080) - low) & U32
    return ((word & ~thr) | (~(word ^ thr) & t)) & U32


def _round_idx(block, col, thr, depth, bytes_):
    """(rows, 256) index bits of one block's rows for one round's pairs
    (`col`, `thr`: (D, 256) int64), by 4-row words."""
    g = block.shape[0] // 4
    # (D, 256, groups, 4): the words' 4 rows of each pair's column
    vals = block.T[col].reshape(depth, ROUND, g, 4)
    if not bytes_:
        bits = (vals >= thr[:, :, None, None]).long()
        weights = (1 << torch.arange(depth)).reshape(depth, 1, 1, 1)
        return (bits * weights).sum(0).permute(1, 2, 0).reshape(-1, ROUND)
    word = (vals << (8 * torch.arange(4))).sum(-1)              # (D, 256, g)
    ge = _swar_ge(word, (thr * 0x01010101)[:, :, None])
    lo = torch.zeros((ROUND, g), dtype=torch.int64)
    hi = torch.zeros_like(lo)
    for d in range(depth):
        bit = d % 8
        part = (ge[d] >> (7 - bit)) & (0x01010101 << bit)
        if d < 8:
            lo |= part
        else:
            hi |= part
    k = 8 * torch.arange(4)
    idx = ((lo[..., None] >> k) & 0xFF) | (((hi[..., None] >> k) & 0xFF)
                                           << 8)
    return idx.permute(1, 2, 0).reshape(-1, ROUND)


def walk(bins, sf, sb, pow2=None, *, layout="soa", plan=None):
    """The kernel's idx, computed block by block as it computes it.

    `layout` "soa": (T, D) splits, tree t's level d at t * D + d; "dm":
    (D, T) planes at d * T + t, with `pow2` the level weights."""
    n, n_feat = bins.shape
    if layout == "soa":
        n_trees, depth = sf.shape
        tree_stride, level_stride = depth, 1
    else:
        depth, n_trees = sf.shape
        tree_stride, level_stride = 1, n_trees
    plan = plan or tuning.index_plan(n, n_trees, depth, n_feat,
                                     bins.element_size())
    rows_per_block = plan.tile.rows
    staged = plan.tile.route == "shared"
    weights = None
    if pow2 is not None:
        w = pow2[:, 0].to(torch.int32).long()
        if not torch.equal(w, 1 << torch.arange(depth)):
            weights = w
    sf_flat, sb_flat = sf.reshape(-1).long(), sb.reshape(-1).long()
    rounds = -(-n_trees // ROUND)
    out = torch.full((n, n_trees), -1, dtype=torch.int64)
    stores = torch.zeros((n, n_trees), dtype=torch.int64)
    g_words = min(tuning.INDEX_WARPS, rows_per_block // 4)    # G
    pass_rows = 4 * g_words
    for bx in range(plan.n_row_tiles):
        row0 = bx * rows_per_block
        rows = min(rows_per_block, n - row0)
        # the block's bins, (rows_per_block, F + 1): the zero column last,
        # rows past the last zero (the kernel's hold anything; never stored)
        block = torch.zeros((rows_per_block, n_feat + 1), dtype=torch.int64)
        block[:rows, :n_feat] = bins[row0:row0 + rows].long()
        # uint8 words for uint8 bins, and for a staged block of int32 bins
        # that all fit a byte
        bytes_ = bins.dtype == torch.uint8 or (staged and bool(
            ((block[:rows] >= 0) & (block[:rows] <= 255)).all()))
        for by in range(plan.n_tree_groups):
            first = by * plan.rounds_per_group
            for rnd in range(first, min(rounds, first + plan.rounds_per_group)):
                t0 = rnd * ROUND
                nt = min(ROUND, n_trees - t0)
                lane = torch.arange(ROUND)
                at = (t0 + lane)[None, :] * tree_stride \
                    + torch.arange(depth)[:, None] * level_stride
                live = (lane < nt)[None, :]
                # the int2 pairs; past the last tree feature 0, threshold 0
                feat = torch.where(live, sf_flat[at.clamp(max=sf.numel() - 1)],
                                   0)
                thr = torch.where(live, sb_flat[at.clamp(max=sb.numel() - 1)],
                                  0)
                if bytes_:
                    never = thr > 255       # the zero column against 1
                    feat = torch.where(never, n_feat, feat)
                    thr = torch.where(never, 1, thr.clamp(min=0))
                idx = _round_idx(block, feat, thr, depth, bytes_)
                if weights is not None:
                    bits = (idx[..., None] >> torch.arange(depth)) & 1
                    idx = (bits * weights).sum(-1)
                # (tree tile, pass) items over the 8 warps: each stores its
                # lanes' live trees for its pass's rows below `rows`
                n_tiles = -(-nt // 32)
                n_passes = -(-rows // pass_rows)
                for warp in range(WARPS):
                    for item in range(warp, n_tiles * n_passes, WARPS):
                        j0 = (item % n_tiles) * 32
                        r0 = (item // n_tiles) * pass_rows
                        r1 = min(rows, r0 + pass_rows)
                        j1 = min(nt, j0 + 32)
                        out[row0 + r0:row0 + r1, t0 + j0:t0 + j1] = \
                            idx[r0:r1, j0:j1]
                        stores[row0 + r0:row0 + r1, t0 + j0:t0 + j1] += 1
    assert bool((stores == 1).all()), "a (row, tree) stored other than once"
    return out.to(torch.int32)


def _case(n, n_trees, depth, n_feat, dtype, seed, hi=256):
    """numpy-seeded bins and splits: bins over [0, hi) with the byte's
    edges (0, 127, 128, 255) common, thresholds over [-2, hi + 2) with 0,
    1, 128, 255, 256 and PAD_SPLIT_BIN common, and a padded (all-PAD) tree
    at every 7th."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, hi, (n, n_feat))
    pick = rng.random(bins.shape)
    for k, v in enumerate((0, 127, 128, hi - 1)):
        bins[(pick >= 0.05 * k) & (pick < 0.05 * (k + 1))] = v
    sf = rng.integers(0, n_feat, (n_trees, depth))
    sb = rng.integers(-2, hi + 2, (n_trees, depth))
    pick = rng.random(sb.shape)
    for k, v in enumerate((0, 1, 128, 255, 256, PAD)):
        sb[(pick >= 0.05 * k) & (pick < 0.05 * (k + 1))] = v
    sb[::7] = PAD
    return (torch.from_numpy(bins.astype(dtype)),
            torch.from_numpy(sf.astype(np.int32)),
            torch.from_numpy(sb.astype(np.int32)))


def _pow2(depth):
    return (2.0 ** torch.arange(depth, dtype=torch.float32)).reshape(depth, 1)


EDGE_TREES = (1, 31, 33, 255, 257)


@pytest.mark.parametrize("n_trees", EDGE_TREES)
@pytest.mark.parametrize("depth", (1, 8, 16))
@pytest.mark.parametrize("dtype", (np.uint8, np.int32))
def test_walk_equals_the_plain_versions(n_trees, depth, dtype):
    bins, sf, sb = _case(77, n_trees, depth, 11, dtype, seed=n_trees + depth)
    want = ref.leaf_index(bins, sf, sb)
    assert torch.equal(walk(bins, sf, sb), want)
    sf_dm, sb_dm = sf.T.contiguous(), sb.T.contiguous()
    assert torch.equal(ref.leaf_index_depth_major(bins, sf_dm, sb_dm,
                                                  _pow2(depth)), want)
    assert torch.equal(walk(bins, sf_dm, sb_dm, _pow2(depth), layout="dm"),
                       want)


@pytest.mark.parametrize("rows", tuning.INDEX_ROWS + (128,))
@pytest.mark.parametrize("route", ("shared", "global"))
def test_walk_at_every_row_tile_and_route(rows, route):
    # a few whole and one partial block, 2 rounds in 2 tree groups
    bins, sf, sb = _case(3 * rows + 5, 300, 9, 13, np.uint8, seed=rows)
    base = tuning.index_plan(3 * rows + 5, 300, 9, 13, 1)
    tile = tuning.TilePlan(rows, rows + 4 if route == "shared" else 13,
                           route, base.tile.tile_bytes, base.tile.static_bytes)
    plan = tuning.IndexPlan(tile, -(-(3 * rows + 5) // rows), 2, 1)
    want = ref.leaf_index(bins, sf, sb)
    assert torch.equal(walk(bins, sf, sb, plan=plan), want)
    assert torch.equal(walk(bins.int(), sf, sb, plan=plan), want)


def test_walk_narrows_int32_bins_block_by_block():
    # int32 bins: the blocks whose bins all fit a byte walk uint8 words,
    # the others (a bin of 300, a negative bin) int32 words
    bins, sf, sb = _case(200, 40, 8, 9, np.int32, seed=3)
    bins[70, 2] = 300
    bins[150, 0] = -1
    sb[0, 0] = 300
    plan = tuning.index_plan(200, 40, 8, 9, 4)
    assert plan.tile.rows == 8 and plan.n_row_tiles == 25
    assert torch.equal(walk(bins, sf, sb), ref.leaf_index(bins, sf, sb))


def test_walk_takes_weights_other_than_pow2():
    # the dm kernel sums its layout's weights, truncated to int, wherever
    # they are not 2^d (no lowering gives such weights)
    bins, sf, sb = _case(40, 20, 5, 7, np.uint8, seed=4)
    pow2 = torch.tensor([[1.0], [2.9], [0.0], [7.5], [100.25]])
    sf_dm, sb_dm = sf.T.contiguous(), sb.T.contiguous()
    assert torch.equal(walk(bins, sf_dm, sb_dm, pow2, layout="dm"),
                       ref.leaf_index_depth_major(bins, sf_dm, sb_dm, pow2))


def _pad(bins, sf, sb, block_n, block_t):
    """Rows padded with bin 0 and trees with PAD_SPLIT_BIN to the block
    multiples the Pallas kernels take."""
    n, t = bins.shape[0], sf.shape[0]
    np_, tp = -(-n // block_n) * block_n, -(-t // block_t) * block_t
    bins_p = torch.cat([bins, torch.zeros((np_ - n, bins.shape[1]),
                                          dtype=bins.dtype)])
    sf_p = torch.cat([sf, torch.zeros((tp - t, sf.shape[1]),
                                      dtype=torch.int32)])
    sb_p = torch.cat([sb, torch.full((tp - t, sb.shape[1]), PAD,
                                     dtype=torch.int32)])
    return bins_p, sf_p, sb_p


@pytest.mark.parametrize("n_trees", EDGE_TREES)
@pytest.mark.parametrize("depth", (1, 16))
@pytest.mark.parametrize("dtype", (np.uint8, np.int32))
def test_walk_equals_jax_pallas_interpret(n_trees, depth, dtype):
    # JAX only here, so that `pytest -m cuda` runs this file on a machine
    # with the card and no JAX
    import jax.numpy as jnp
    from repro.kernels import leaf_index as jindex
    n, n_feat = 20, 6
    bins, sf, sb = _case(n, n_trees, depth, n_feat, dtype,
                         seed=100 + n_trees + depth)
    # the Pallas kernels take padded rows and trees; one grid step
    bins_p, sf_p, sb_p = _pad(bins, sf, sb, 8, 16)
    npad, tpad = bins_p.shape[0], sf_p.shape[0]
    fn = jindex.leaf_index_u8 if dtype == np.uint8 else jindex.leaf_index
    got = np.asarray(fn(jnp.asarray(bins_p.numpy()),
                        jnp.asarray(sf_p.numpy()), jnp.asarray(sb_p.numpy()),
                        block_n=npad, block_t=tpad, interpret=True))
    want = walk(bins_p, sf_p, sb_p)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got[:n, :n_trees],
                                  walk(bins, sf, sb).numpy())
    # depth_major: the JAX kernel's precomputed (T, D, F) one-hot, (D, T)
    # thresholds and (D, 1) weights; the port's (D, T) planes
    onehot = np.zeros((tpad, depth, n_feat), np.float32)
    np.put_along_axis(onehot, sf_p.numpy()[:, :, None].astype(np.int64), 1.0,
                      axis=2)
    sf_dm, sb_dm = sf_p.T.contiguous(), sb_p.T.contiguous()
    got_dm = np.asarray(jindex.leaf_index_dm(
        jnp.asarray(bins_p.numpy()), jnp.asarray(onehot),
        jnp.asarray(sb_dm.numpy()), jnp.asarray(_pow2(depth).numpy()),
        block_n=npad, block_t=tpad, interpret=True))
    np.testing.assert_array_equal(
        got_dm, walk(bins_p, sf_dm, sb_dm, _pow2(depth), layout="dm").numpy())
    np.testing.assert_array_equal(got_dm, got)


# --------------------------------------------------------------------------
# The wrappers launch with the plan's arguments
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


def _meta(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("n,t,d,f", [(139_440, 1000, 8, 54),
                                     (1024, 1000, 8, 54), (16, 1000, 8, 54),
                                     (1024, 12, 5, 54), (64, 40, 8, 30_000)])
@pytest.mark.parametrize("dtype", (torch.uint8, torch.int32))
def test_wrappers_launch_the_plan(launches, n, t, d, f, dtype):
    bins = _meta(n, f, dtype=dtype)
    index_k.leaf_index(bins, _meta(t, d), _meta(t, d))
    index_k.leaf_index_dm(bins, _meta(d, t), _meta(d, t),
                          _meta(d, 1, dtype=torch.float32))
    plan = tuning.index_plan(n, t, d, f, dtype.itemsize)
    want = (n, f, t, d, int(dtype == torch.uint8), plan.tile.rows,
            int(plan.tile.route == "global"), plan.n_tree_groups,
            plan.rounds_per_group)
    (soa, soa_args), (dm, dm_args) = launches
    assert (soa, dm) == ("repro_leaf_index", "repro_leaf_index_dm")
    assert soa_args[4:] == want and dm_args[5:] == want
    assert ops.launch_counts()["leaf_index"] == 1
    assert ops.launch_counts()["leaf_index_dm"] == 1


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(chip_smoke.py holds it against ref on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_trees", EDGE_TREES)
@pytest.mark.parametrize("depth", (1, 16))
def test_kernels_equal_the_plain_versions_on_the_card(card, n_trees, depth):
    for dtype in (np.uint8, np.int32):
        bins, sf, sb = _case(1000, n_trees, depth, 54, dtype, seed=depth)
        want = ref.leaf_index(bins, sf, sb)
        bins, sf, sb = bins.to(card), sf.to(card), sb.to(card)
        assert torch.equal(index_k.leaf_index(bins, sf, sb).cpu(), want)
        assert torch.equal(index_k.leaf_index_dm(
            bins, sf.T.contiguous(), sb.T.contiguous(),
            _pow2(depth).to(card)).cpu(), want)

"""Split choices on exact gain ties, against the JAX package, on the CPU.

When a level repeats an earlier split, every candidate that leaves the
partition as it is has the same gain in exact arithmetic, and f32
rounding picks the winner.  The port's `core.split_sums` adds the
split search's sums in the order of the JAX package's compiled split
step (the blocked scan of `jnp.cumsum`, the vectorized (leaf, stat)
reduce), so the choices must be equal bit for bit: split features and
bins exactly, gains bit for bit, no near-tie exempted.

The scenario is the one that first showed the fault: 600 x 9 rows,
LogLoss, 8 trees of depth 6 at 32 bins, seeds 7-9, plain and ordered.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import boosting as jboosting  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import quantize as jquantize  # noqa: E402
from repro.training import gbdt as jgbdt  # noqa: E402
from repro_torch.core import boosting, losses, quantize  # noqa: E402
from repro_torch.core import split_sums  # noqa: E402
from repro_torch.training import gbdt  # noqa: E402

torch.set_num_threads(1)

_PROBE = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
    "split_order_probe.py"
_spec = importlib.util.spec_from_file_location("split_order_probe", _PROBE)
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)

SEEDS = (7, 8, 9)


def _scenario():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(600, 9)).astype(np.float32)
    x[:, 3] = np.round(x[:, 3])
    x[rng.random(600) < 0.05, 2] = np.nan
    y = (x[:, 0] - 2 * x[:, 1] + 0.5 * np.nan_to_num(x[:, 2]) * x[:, 3]
         > 0).astype(np.float32)
    return x, y


def _params(pkg, seed, ordered):
    return pkg.BoostingParams(n_trees=8, depth=6, max_bins=32, seed=seed,
                              learning_rate=0.3, ordered=ordered)


def _same_splits(ens, jens):
    np.testing.assert_array_equal(np.asarray(ens.split_features),
                                  np.asarray(jens.split_features))
    np.testing.assert_array_equal(np.asarray(ens.split_bins),
                                  np.asarray(jens.split_bins))


@pytest.mark.parametrize("ordered", [False, True], ids=["plain", "ordered"])
@pytest.mark.parametrize("seed", SEEDS)
def test_fit_pool_splits_equal_jax_on_exact_ties(seed, ordered):
    x, y = _scenario()
    jb, jnb = jquantize.compute_borders(x, 32)
    tb, tnb = quantize.compute_borders(x, 32)
    jens, _ = jgbdt.GBDTTrainer(
        jlosses.make_loss("logloss"), _params(jboosting, seed, ordered)
    ).fit_pool(jquantize.quantize_pool(jnp.asarray(x), jb), y,
               borders=jb, n_borders=jnb)
    ens, _ = gbdt.GBDTTrainer(
        losses.make_loss("logloss"), _params(boosting, seed, ordered),
        device="cpu").fit_pool(quantize.quantize_pool(x, tb), y,
                               borders=tb, n_borders=tnb)
    _same_splits(ens, jens)


@pytest.mark.parametrize("ordered", [False, True], ids=["plain", "ordered"])
@pytest.mark.parametrize("seed", SEEDS)
def test_fit_scan_splits_equal_jax_on_exact_ties(seed, ordered):
    x, y = _scenario()
    jens, _ = jboosting.fit_scan(x, y, loss=jlosses.make_loss("logloss"),
                                 params=_params(jboosting, seed, ordered))
    ens, _ = boosting.fit_scan(x, y, loss=losses.make_loss("logloss"),
                               params=_params(boosting, seed, ordered),
                               device="cpu")
    _same_splits(ens, jens)


def _tied_level(n_bins, depth, n_stats=1, n_feat=6, n=3000, seed=0):
    """A level histogram whose leaves come from `depth` earlier splits, so
    repeating any of them ties exactly: (hist (F, L * B, 2C) f32, bins_t
    (F, N) uint8, leaf (N,) int32)."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins, size=(n, n_feat)).astype(np.uint8)
    leaf = np.zeros(n, np.int32)
    for d in range(depth):
        f = rng.integers(0, n_feat)
        b = rng.integers(1, n_bins)
        leaf |= (bins[:, f] >= b).astype(np.int32) << d
    g = rng.normal(size=(n, n_stats)).astype(np.float32)
    h = rng.uniform(0.1, 1.0, size=(n, n_stats)).astype(np.float32)
    gh = np.concatenate([g, h], axis=1)
    n_leaves = 1 << depth
    hist = np.zeros((n_feat, n_leaves * n_bins, 2 * n_stats), np.float32)
    for f in range(n_feat):
        np.add.at(hist[f], leaf * n_bins + bins[:, f], gh)
    return hist, np.ascontiguousarray(bins.T), leaf


@pytest.mark.parametrize("n_leaves", [1, 8, 32])
@pytest.mark.parametrize("n_bins", [17, 32, 255])
def test_split_level_gains_bit_equal_jax(n_bins, n_leaves):
    depth = n_leaves.bit_length() - 1
    hist, bins_t, leaf = _tied_level(n_bins, depth)
    valid = np.ones((hist.shape[0], n_bins), bool)
    valid[:, 0] = False
    want, _ = probe.jax_gains(jnp.asarray(hist), jnp.asarray(valid),
                         n_bins=n_bins, l2=3.0)
    gain, nonempty = split_sums.level_gains(
        torch.from_numpy(hist).view(hist.shape[0], n_leaves, n_bins, -1),
        3.0)
    got = torch.where(torch.from_numpy(valid) & nonempty, gain,
                      boosting.NEG_INF).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.asarray(want).view(np.int32))
    # and the choice itself, through both packages' split step
    jf, jb, jleaf = jgbdt._split_level(
        jnp.asarray(hist), jnp.asarray(valid), jnp.asarray(bins_t),
        jnp.asarray(leaf), n_bins=n_bins, d=depth, l2=3.0)
    f, b, new_leaf = gbdt._split_level(
        torch.from_numpy(hist), torch.from_numpy(valid),
        torch.from_numpy(bins_t), torch.from_numpy(leaf), n_bins=n_bins,
        d=depth, l2=3.0)
    assert (int(f), int(b)) == (int(jf), int(jb))
    np.testing.assert_array_equal(new_leaf.numpy(), np.asarray(jleaf))


@pytest.mark.parametrize("seed", range(8))
def test_split_level_picks_jax_split_among_repeated_splits(seed):
    """Many tie-heavy levels at the scenario's shape (32 bins, up to 32
    leaves): the first maximum must be JAX's every time."""
    rng = np.random.default_rng(100 + seed)
    depth = int(rng.integers(2, 6))
    hist, bins_t, leaf = _tied_level(32, depth, n_feat=4, seed=seed)
    valid = np.ones((hist.shape[0], 32), bool)
    valid[:, 0] = False
    jf, jb, _ = jgbdt._split_level(
        jnp.asarray(hist), jnp.asarray(valid), jnp.asarray(bins_t),
        jnp.asarray(leaf), n_bins=32, d=depth, l2=3.0)
    f, b, _ = gbdt._split_level(
        torch.from_numpy(hist), torch.from_numpy(valid),
        torch.from_numpy(bins_t), torch.from_numpy(leaf), n_bins=32,
        d=depth, l2=3.0)
    assert (int(f), int(b)) == (int(jf), int(jb))


@pytest.mark.parametrize("lengths", [range(1, 129), range(129, 257)],
                         ids=["1-128", "129-256"])
def test_blocked_cumsum_bit_equal_jnp_cumsum(lengths):
    """Every length of a bin axis: one jitted module of all the scans,
    each its own reduce-window, as in the split step."""
    rng = np.random.default_rng(lengths.start)
    arrays = [rng.normal(size=(3, n, 2)).astype(np.float32)
              for n in lengths]
    wants = jax.jit(lambda xs: [jnp.cumsum(a, axis=1) for a in xs])(
        [jnp.asarray(a) for a in arrays])
    for a, want in zip(arrays, wants):
        got = split_sums.blocked_cumsum(torch.from_numpy(a), dim=1).numpy()
        want = np.asarray(want)
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
            a.shape[1]


@pytest.mark.parametrize("n", [257, 4097, 65537, 600_000])
def test_blocked_cumsum_over_rows_bit_equal_jnp_cumsum(n):
    """Ordered boosting's prefix sums over rows: more than 16 blocks,
    scanned blocked again."""
    a = np.random.default_rng(n).normal(size=(n, 2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=0))(
        jnp.asarray(a)))
    got = boosting._prefix_sum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# one shape of each plan in `split_sums.leaf_sum_plan`'s table, and
# shapes that add in order; past 32 leaves, windows whose first round runs
# in 8 lanes (bins x stats of at most 8 floats a leaf) and in order
@pytest.mark.parametrize("n_leaves,n_bins,n_stats", [
    (8, 32, 1), (4, 9, 2), (8, 16, 2), (16, 3, 1), (16, 64, 1),
    (16, 100, 1), (16, 2, 2), (32, 32, 1), (32, 9, 1), (32, 128, 1),
    (32, 9, 3), (64, 17, 2), (512, 33, 1), (64, 2, 2), (128, 3, 2),
    (256, 2, 3), (1024, 4, 2), (2048, 2, 4), (64, 3, 3)])
def test_leaf_sum_plan_is_xla_order_on_this_host(n_leaves, n_bins, n_stats):
    plan = split_sums.leaf_sum_plan(n_leaves, n_bins, n_stats)
    assert plan in probe.probe(n_leaves, n_bins, n_stats)


def test_split_sums_run_in_one_order_on_any_device_shape():
    """`leaf_stat_sum` follows its plan: the vectorized order differs
    from the in-order sum on random terms (so the table matters) and
    equals a hand-written lane sum."""
    t = torch.from_numpy(np.random.default_rng(0).uniform(
        0.5, 2.0, size=(2, 32, 5, 1)).astype(np.float32))
    plan = split_sums.LeafSumPlan(lanes=8, vector_leaves=24)
    got = split_sums.leaf_stat_sum(t, plan)
    lanes = t[:, 0:8, :, 0] + t[:, 8:16, :, 0] + t[:, 16:24, :, 0]
    lanes = lanes[:, :4] + lanes[:, 4:]
    lanes = lanes[:, :2] + lanes[:, 2:]
    want = lanes[:, 0] + lanes[:, 1]
    for leaf in range(24, 32):
        want = want + t[:, leaf, :, 0]
    assert torch.equal(got, want)
    seq = split_sums.leaf_stat_sum(t, split_sums.LeafSumPlan())
    assert not torch.equal(got, seq)


def test_window_lanes_add_as_written():
    """A first window round in 8 lanes: lane j takes window leaves j, j +
    8, j + 16 (stats inner), the lanes are added in halves, then leaves
    24-31 in order; the windows' sums then add in order."""
    t = torch.from_numpy(np.random.default_rng(1).uniform(
        0.5, 2.0, size=(2, 64, 3, 2)).astype(np.float32))
    got = split_sums.leaf_stat_sum(
        t, split_sums.LeafSumPlan(windows=1, window_lanes=8))
    windows = []
    for w in range(2):
        lane = [None] * 8
        for j in range(8):
            for leaf in range(32 * w + j, 32 * w + 24, 8):
                for s in range(2):
                    term = t[:, leaf, :, s]
                    lane[j] = term if lane[j] is None else lane[j] + term
        lane = [lane[j] + lane[j + 4] for j in range(4)]
        lane = [lane[j] + lane[j + 2] for j in range(2)]
        acc = lane[0] + lane[1]
        for leaf in range(32 * w + 24, 32 * w + 32):
            for s in range(2):
                acc = acc + t[:, leaf, :, s]
        windows.append(acc)
    assert torch.equal(got, windows[0] + windows[1])
    assert not torch.equal(got, split_sums.leaf_stat_sum(
        t, split_sums.LeafSumPlan(windows=1)))

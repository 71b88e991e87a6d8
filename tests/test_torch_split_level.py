"""The split search of one tree level: `kernels/split_level.py` and its
kernel, `csrc/split_level.cu`.

On the CPU the registered op runs the plain version (the trainer's
`_split_level` tests, tests/test_torch_training.py and
tests/test_torch_split_ties.py, hold it to the JAX package); here: its
launch plan at every shape the trainer sends, the launcher's arguments
as the wrapper passes them (recorded on fake CUDA tensors, nothing
launched), what the wrapper refuses, and the source's constants.  The
`cuda`-marked test holds the kernel to the plain version bit for bit on
the card, over every form of `split_sums.leaf_sum_plan`; it imports no
JAX, so `python -m pytest -m cuda tests/test_torch_split_level.py` runs
there."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import trace_tools  # noqa: E402
from repro_torch.analysis.trace_tools import Spec  # noqa: E402
from repro_torch.core import split_sums  # noqa: E402
from repro_torch.kernels import _build, ops, registry, tuning  # noqa: E402
from repro_torch.kernels import split_level as split_k  # noqa: E402
from repro_torch.training import gbdt  # noqa: E402

# The benchmark's Covertype levels: 54 features, 128 borders, 7 classes.
COV_F, COV_BINS, COV_C, COV_ROWS = 54, 129, 7, 325_360


def _level(seed, n_feat, n_leaves, n_bins, n_out, n_rows, *,
           bins_dtype=torch.uint8, empty=0.2, mask=0.1, l2=3.0):
    """A random level: (hist, valid, bins_t, leaf) and its keywords.
    `empty` of the histogram's cells hold no hessian (nor gradient),
    `mask` of the borders are not valid."""
    rng = np.random.default_rng(seed)
    shape = (n_feat, n_leaves * n_bins, n_out)
    g = rng.normal(size=shape).astype(np.float32)
    h = rng.uniform(0.0, 2.0, size=shape).astype(np.float32)
    hole = rng.random(shape) < empty
    g[hole], h[hole] = 0.0, 0.0
    hist = torch.from_numpy(np.concatenate([g, h], axis=2))
    valid = torch.from_numpy(rng.random((n_feat, n_bins)) >= mask)
    valid[:, 0] = False
    bins_t = torch.from_numpy(rng.integers(0, n_bins, (n_feat, n_rows))) \
        .to(bins_dtype)
    d = max(n_leaves - 1, 0).bit_length()
    leaf = torch.from_numpy(rng.integers(0, n_leaves, n_rows)) \
        .to(torch.int32)
    return (hist, valid, bins_t, leaf), dict(n_bins=n_bins, d=d, l2=l2)


# --------------------------------------------------------------------------
# The registered op and the plain version
# --------------------------------------------------------------------------
def test_registry_lists_split_level_on_both_families():
    impls = registry.implementations("split_level")
    assert {name: impl.family for name, impl in impls.items()} == {
        "torch_ref": "torch_ref", "cuda": "cuda"}
    assert "split_level" in registry.CORE_OPS
    assert registry.resolve("split_level", device="cpu") == "torch_ref"
    assert registry.resolve("split_level", device="cuda") == "cuda"
    assert ops.KERNELS["split_level"] is split_k.split_level


def test_trainer_dispatches_the_plain_version_on_the_cpu(monkeypatch):
    args, kw = _level(0, 4, 2, 17, 3, 50)
    seen = []
    real = split_k.split_level_plain
    monkeypatch.setattr(split_k, "split_level_plain",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    registry.reset_call_stats()
    got = gbdt._split_level(*args, **kw)
    assert seen == [1] and registry.call_stats() == {"split_level": 1}
    want = real(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("bins_dtype", [torch.uint8, torch.int32])
def test_plain_gains_choose_and_refine(bins_dtype):
    args, kw = _level(1, 6, 4, 33, 2, 200, bins_dtype=bins_dtype)
    f, b, leaf, gains = split_k.split_level(*args, **kw, return_gains=True)
    assert gains.shape == (6, 33) and gains.dtype == torch.float32
    flat = int(torch.argmax(gains.reshape(-1)))
    assert (int(f), int(b)) == divmod(flat, 33)
    assert not bool(gains[~args[1]].ne(split_sums.NEG_INF).any())
    column = args[2][int(f)].to(torch.int64)
    assert torch.equal(leaf, args[3] | ((column >= int(b)).to(torch.int32)
                                        << kw["d"]))
    assert f.dtype == b.dtype == torch.int32 and f.ndim == b.ndim == 0


def test_all_masked_level_picks_zero_zero():
    args, kw = _level(2, 3, 2, 9, 1, 40)
    args[1][:] = False
    f, b, leaf = split_k.split_level(*args, **kw)
    assert (int(f), int(b)) == (0, 0)
    assert torch.equal(leaf, args[3] | (1 << kw["d"]))


# --------------------------------------------------------------------------
# The launch plan
# --------------------------------------------------------------------------
def test_plan_at_covertype_width():
    plan = tuning.split_plan(COV_F, 128, COV_BINS, COV_C, COV_ROWS, 1)
    assert (plan.pairs_per_block, plan.staged, plan.slots,
            plan.choose_blocks, plan.refine_blocks) == (28, True, 4, 436, 80)
    assert plan.term_blocks == -(-COV_F * 128 * COV_C // 28)
    cells = COV_F * 128 * COV_C * COV_BINS
    assert plan.gains_offset == 4 * cells
    assert plan.scratch_bytes == 4 * cells + 27_872 + 2 * 1744 + cells
    assert plan.terms_smem == 28 * (2 * 10 * 4 + 5 * COV_BINS)
    assert plan.smem_bytes == plan.terms_smem
    # in-order levels take a choose thread a border
    for d, slots in ((0, 1), (5, 1), (6, 2)):
        windows = split_sums.leaf_sum_plan(1 << d, COV_BINS, COV_C).windows
        assert tuning.split_plan(COV_F, 1 << d, COV_BINS, COV_C, COV_ROWS,
                                 windows).slots == slots


@pytest.mark.parametrize("n_bins,floats", [
    (1, 1), (16, 1), (17, 3), (129, 10), (256, 17), (257, 20),
    (4096, 256 + 16 + 1), (4097, 257 + 17 + 2 + 1),
    (65_536, 4096 + 256 + 16 + 1)])
def test_scan_floats_are_the_levels_of_block_totals(n_bins, floats):
    assert tuning.split_scan_floats(n_bins) == floats


@pytest.mark.parametrize("n_bins", [2, 33, 129, 257, 4097, 65_536])
@pytest.mark.parametrize("n_out", [1, 7, 20, 33])
def test_plan_fits_a_terms_block(n_bins, n_out):
    for n_leaves in (1, 64, 1 << 12):
        windows = split_sums.leaf_sum_plan(n_leaves, n_bins, n_out).windows
        plan = tuning.split_plan(3, n_leaves, n_bins, n_out, 1000, windows)
        blocks = -(-n_bins // tuning.SPLIT_SCAN_BLOCK)
        assert plan.terms_smem <= tuning.SPLIT_TERMS_SMEM
        assert plan.pairs_per_block * blocks <= tuning.SPLIT_THREADS \
            or plan.pairs_per_block == 1
        assert plan.term_blocks * plan.pairs_per_block \
            >= 3 * n_leaves * n_out
        assert 1 <= plan.choose_blocks <= tuning.SPLIT_CHOOSE_BLOCKS
        assert tuning.SPLIT_CHOOSE_THREADS % plan.slots == 0
        # staged wherever a pair's terms fit; 65,536 bins never do
        assert plan.staged == (n_bins < 9000)


def test_every_sum_plan_fits_the_kernel():
    """The kernel keeps at most 16 lanes and 4 rounds of windows."""
    src = (_build.CSRC / "split_level.cu").read_text()
    max_lanes = int(re.search(r"kMaxLanes = (\d+);", src).group(1))
    max_windows = int(re.search(r"kMaxWindows = (\d+);", src).group(1))
    for d in range(17):
        for n_bins in (2, 3, 4, 17, 33, 64, 129, 256, 257):
            for n_out in (1, 2, 3, 4, 7, 20):
                plan = split_sums.leaf_sum_plan(1 << d, n_bins, n_out)
                assert plan.lanes <= max_lanes
                assert plan.window_lanes <= max_lanes
                assert plan.windows <= max_windows
                assert (1 << d) % split_sums.LEAF_WINDOW ** plan.windows \
                    == 0


def test_source_constants_are_the_plans():
    src = (_build.CSRC / "split_level.cu").read_text()
    for name, value in (("kThreads", tuning.SPLIT_THREADS),
                        ("kChooseThreads", tuning.SPLIT_CHOOSE_THREADS),
                        ("kMaxSlots", tuning.SPLIT_MAX_SLOTS),
                        ("kScanBlock", split_sums.SCAN_BLOCK),
                        ("kLeafWindow", split_sums.LEAF_WINDOW),
                        ("kRowsPerThread", tuning.SPLIT_ROWS_PER_THREAD)):
        assert f"constexpr int {name} = {value};" in src
    assert "constexpr int kTermsSmem = 48 * 1024;" in src
    assert tuning.SPLIT_TERMS_SMEM == 48 * 1024
    assert "constexpr float kNegInf = -1e30f;" in src
    assert split_sums.NEG_INF == -1e30
    assert tuning.SPLIT_SCAN_BLOCK == split_sums.SCAN_BLOCK
    # the gain term's arithmetic is never contracted into an fma
    term = src.split("float gain_term(", 1)[1].split("}", 1)[0]
    assert "__fdiv_rn(__fmul_rn(g, g), __fadd_rn(h, l2))" in term


# --------------------------------------------------------------------------
# The launch, recorded on fake CUDA tensors
# --------------------------------------------------------------------------
def _record(n_feat, n_leaves, n_bins, n_out, n_rows, bins_dtype):
    d = max(n_leaves - 1, 0).bit_length()
    trace = trace_tools.trace_abstract(
        split_k.split_level,
        Spec((n_feat, n_leaves * n_bins, 2 * n_out), torch.float32,
             "cuda:0"),
        Spec((n_feat, n_bins), torch.bool, "cuda:0"),
        Spec((n_feat, n_rows), bins_dtype, "cuda:0"),
        Spec((n_rows,), torch.int32, "cuda:0"),
        n_bins=n_bins, d=d, l2=3.0)
    return trace, d


LEVELS = ([(COV_F, 1 << d, COV_BINS, COV_C, COV_ROWS, torch.uint8)
           for d in range(8)]
          + [(9, 16, 33, 1, 600, torch.uint8),        # a lanes plan
             (6, 8, 257, 7, 1000, torch.int32)])      # the blocked totals


@pytest.mark.parametrize("level", LEVELS,
                         ids=[f"F{f}_L{l}_B{b}_C{c}" for f, l, b, c, *_ in
                              LEVELS])
def test_wrapper_launches_the_plan(level):
    n_feat, n_leaves, n_bins, n_out, n_rows, bins_dtype = level
    before = split_k.split_level.launches
    trace, d = _record(*level)
    (launch,) = trace.launches()
    assert len(trace.launches()) <= 4
    rec = launch.record
    assert rec.name == "repro_split_level"
    assert len(rec.args) == len(_build._SIGNATURES[rec.name])
    sums = split_sums.leaf_sum_plan(n_leaves, n_bins, n_out)
    plan = tuning.split_plan(n_feat, n_leaves, n_bins, n_out, n_rows,
                             sums.windows)
    assert rec.args[8:] == (
        n_rows, n_feat, n_leaves, n_bins, n_out, d,
        int(bins_dtype == torch.uint8), plan.pairs_per_block,
        plan.choose_blocks, plan.refine_blocks, int(plan.staged),
        sums.windows, sums.lanes, sums.vector_leaves, sums.window_lanes,
        3.0)
    scratch, out, f_out, b_out = rec.args[4:8]
    assert scratch.shape == (plan.scratch_bytes,)
    assert out.shape == (n_rows,) and out.dtype == torch.int32
    assert f_out.shape == b_out.shape == () \
        and f_out.dtype == b_out.dtype == torch.int32
    assert rec.args[2].dtype == bins_dtype
    # the walk leaves the count as it was
    assert split_k.split_level.launches == before
    if (n_leaves, n_out) == (16, 1):
        assert (sums.lanes, sums.vector_leaves) == (8, 8)
    if n_leaves >= 64:
        assert sums.windows == 1


def _cuda_args(n_feat=3, n_leaves=2, n_bins=9, n_out=2, n_rows=40):
    dev = "cuda:0"
    return [torch.empty((n_feat, n_leaves * n_bins, 2 * n_out),
                        device=dev),
            torch.empty((n_feat, n_bins), dtype=torch.bool, device=dev),
            torch.empty((n_feat, n_rows), dtype=torch.uint8, device=dev),
            torch.empty((n_rows,), dtype=torch.int32, device=dev)]


@pytest.mark.parametrize("case,match", [
    ("hist_f64", "float32"), ("leaf_i64", "int32"), ("valid_u8", "bool"),
    ("bins_i16", "uint8 or int32"), ("valid_shape", "do not match"),
    ("hist_rank", "takes hist"), ("odd_stats", "2C"),
    ("bins_rows", "do not match"), ("cpu_leaf", "CUDA tensors"),
    ("level", "level")])
def test_wrapper_refuses(case, match):
    def call():
        a = _cuda_args()
        kw = dict(n_bins=9, d=1, l2=3.0)
        if case == "hist_f64":
            a[0] = a[0].double()
        elif case == "leaf_i64":
            a[3] = a[3].long()
        elif case == "valid_u8":
            a[1] = a[1].to(torch.uint8)
        elif case == "bins_i16":
            a[2] = a[2].to(torch.int16)
        elif case == "valid_shape":
            a[1] = a[1][:, :5]
        elif case == "hist_rank":
            a[0] = a[0][0]
        elif case == "odd_stats":
            a[0] = a[0][:, :, :3]
        elif case == "bins_rows":
            a[2] = a[2][:, :30]
        elif case == "cpu_leaf":
            a[3] = torch.zeros(40, dtype=torch.int32, device="cpu")
        elif case == "level":
            kw["d"] = 31
        return split_k.split_level(*a, **kw)
    with pytest.raises(ValueError, match=match):
        trace_tools.trace_abstract(call)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(chip_smoke.py holds it to the plain version on the "
                    "H100)")
    return torch.device("cuda")


# (features, leaves, bins, outputs, rows, bins dtype, l2): every form of
# leaf_sum_plan (in order; lanes with and without an epilogue; windows in
# order and in lanes; two window rounds), scans past 16, 256 and 4,096
# bins (terms staged in shared memory, and at 10,000 bins not), rows past
# and short of a 16-row chunk on both bin types, and l2 = 0 (NaN gains,
# which argmax ranks above every number).
CARD_LEVELS = [
    (5, 1, 129, 7, 1000, torch.uint8, 3.0),
    (5, 8, 129, 7, 1024, torch.uint8, 3.0),
    (4, 128, 129, 7, 4096, torch.uint8, 3.0),
    (6, 16, 33, 1, 1001, torch.uint8, 3.0),
    (6, 32, 65, 1, 999, torch.uint8, 3.0),
    (6, 4, 10, 2, 500, torch.uint8, 3.0),
    (6, 64, 3, 2, 700, torch.uint8, 3.0),
    (3, 2048, 2, 1, 4000, torch.uint8, 3.0),
    (5, 8, 257, 3, 1003, torch.int32, 3.0),
    (2, 2, 4500, 1, 5000, torch.int32, 3.0),
    (2, 2, 10_000, 1, 2048, torch.int32, 3.0),
    (4, 4, 300, 2, 1024, torch.int32, 3.0),
    (7, 4, 17, 4, 300, torch.uint8, 0.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("level", CARD_LEVELS)
def test_kernel_equals_the_plain_version_on_the_card(card, level, seed):
    n_feat, n_leaves, n_bins, n_out, n_rows, bins_dtype, l2 = level
    args, kw = _level(seed, n_feat, n_leaves, n_bins, n_out, n_rows,
                      bins_dtype=bins_dtype, l2=l2)
    want = split_k.split_level_plain(*args, **kw, return_gains=True)
    got = split_k.split_level(*(a.to(card) for a in args), **kw,
                              return_gains=True)
    for name, w, g in zip(("f*", "b*", "leaf", "gains"), want, got):
        g = g.cpu()
        # bit for bit, a NaN equal to any NaN: the card's division gives
        # 0x7fffffff where the CPU's gives 0xffc00000
        nan = torch.isnan(w) if w.is_floating_point() else w != w
        assert torch.equal(nan, torch.isnan(g) if g.is_floating_point()
                           else g != g), name
        assert torch.equal(w[~nan].view(torch.int32),
                           g[~nan].view(torch.int32)), name

"""The distance-matrix kernel's design on the CPU, and the kernel on a card.

`csrc/l2sq_matrix.cu` takes the cross term from the tensor cores as
3xTF32: a split pass writes each operand's TF32 hi part (rounded to
nearest, ties away) and lo = x - hi, K padded to a multiple of 32, and
the product sums a_hi.b_hi + a_hi.b_lo + a_lo.b_hi in fp32.  Here:

  * `ref.tf32_split` / `tf32_truncate`: hi has 13 zero low bits, hi + lo
    is x exactly, |lo| <= 2^-11 |x|, ties round away from zero;
  * the arithmetic, emulated (`ref.l2sq_matrix_tf32`) on 256 test queries
    of `image_embeddings(scale=1.0, seed=4)` against all 2,808 references:
    3xTF32 stays within a tenth of the distance rule (`l2dist.
    matrix_limit`, PERF.md §2) of the plain version and of the JAX
    package's `ref.l2sq_matrix`; one TF32 product breaks it;
  * `tuning.matrix_plan` on a hypothesis grid, and the wrapper's two
    launches recorded on "meta" tensors;
  * on a card (`cuda`-marked, skipped without one): the split kernel bit
    for bit against the plain split, and the product at ragged shapes
    within the rule, non-negative, NaN kept, the same bits on two
    launches and at every ring depth.

JAX is imported only inside the test that compares with it, so the
`cuda`-marked tests also run on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_l2sq.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build, l2dist, ops, ref, tuning  # noqa: E402,E501

torch.set_num_threads(1)

N_QUERIES = 256
# 3xTF32 must keep this share of the distance rule (the emulation gives
# about 0.03, the plain version against float64 about 0.02); one TF32
# product gives about 5.4.
RULE_SHARE_3X = 0.1
# Ragged shapes for the card: one tile, K not a multiple of 32 (90, 533),
# M < 64 against the reference set, partial tiles on both sides; N % 4 ==
# 0 takes the TMA-store epilogue, the others the direct stores.
CARD_SHAPES = [(64, 128, 32), (37, 61, 90), (50, 300, 533),
               (3, 2808, 512), (300, 257, 256), (129, 1, 7)]


@pytest.fixture(scope="module")
def embeddings():
    data = synthetic.image_embeddings(scale=1.0, seed=4)
    return (torch.from_numpy(data.emb_test[:N_QUERIES]),
            torch.from_numpy(data.emb_train))


def _rule_share(got, want, a, b) -> float:
    err = (got.double() - want.double()).abs()
    return float((err / l2dist.matrix_limit(a, b)).max())


def _bits(t):
    return t.contiguous().view(torch.int32)


# --------------------------------------------------------------------------
# The TF32 split
# --------------------------------------------------------------------------
def _values(kind: str) -> torch.Tensor:
    rng = np.random.default_rng(11)
    if kind == "normal":
        x = rng.normal(size=4096)
    elif kind == "wide":        # magnitudes 1e-30 .. 1e30, both signs
        x = rng.choice([-1.0, 1.0], 4096) * 10.0 ** rng.uniform(-30, 30, 4096)
    else:                       # embeddings: post-ReLU, zeros included
        x = synthetic.image_embeddings(scale=0.05, seed=4).emb_train.ravel()
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("kind", ["normal", "wide", "embeddings"])
def test_tf32_split_is_exact_and_rounded_to_nearest(kind):
    x = _values(kind)
    hi, lo = ref.tf32_split(x)
    assert bool(((_bits(hi) & 0x1FFF) == 0).all())
    assert torch.equal(hi + lo, x)
    assert bool((lo.abs() <= 2.0 ** -11 * x.abs()).all())
    # to nearest: no other TF32 value lies closer to x
    unit = torch.ldexp(torch.ones_like(x), torch.frexp(hi)[1] - 11).abs()
    assert bool((lo.abs() <= unit / 2).all())
    assert torch.equal(ref.tf32_truncate(hi), hi)


def test_tf32_split_rounds_ties_away_from_zero():
    base = torch.tensor([1.0, -1.0, 3.0, -768.0], dtype=torch.float32)
    tie = (_bits(base) + 0x1000).view(torch.float32)   # half a TF32 unit
    below = (_bits(base) + 0xFFF).view(torch.float32)
    hi, _ = ref.tf32_split(torch.cat([tie, below]))
    away = (_bits(base) + 0x2000).view(torch.float32)
    assert torch.equal(hi, torch.cat([away, base]))


def test_tf32_truncate_clears_the_low_bits_and_keeps_specials():
    x = torch.tensor([1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -12), float("nan"),
                      float("inf"), -float("inf"), 0.0])
    t = ref.tf32_truncate(x)
    assert torch.equal(t[:2], torch.tensor([1.0, -1.0]))
    assert bool(t[2].isnan()) and torch.equal(t[3:], x[3:])
    hi, _ = ref.tf32_split(x[2:5])
    assert bool(hi[0].isnan()) and torch.equal(hi[1:], x[3:5])


# --------------------------------------------------------------------------
# The 3xTF32 arithmetic under the distance rule
# --------------------------------------------------------------------------
def test_3xtf32_holds_the_distance_rule(embeddings):
    a, b = embeddings
    got = ref.l2sq_matrix_tf32(a, b, products=3)
    assert got.shape == (N_QUERIES, b.shape[0])
    assert bool((got >= 0).all())
    assert _rule_share(got, ref.l2sq_matrix(a, b), a, b) <= RULE_SHARE_3X


def test_1xtf32_breaks_the_distance_rule(embeddings):
    # why the kernel takes three products: one keeps 11 bits an operand
    a, b = embeddings
    got = ref.l2sq_matrix_tf32(a, b, products=1)
    assert _rule_share(got, ref.l2sq_matrix(a, b), a, b) > 1.0


def test_3xtf32_holds_the_distance_rule_of_the_jax_reference(embeddings):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    a, b = embeddings
    want = torch.from_numpy(np.array(jref.l2sq_matrix(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))))
    got = ref.l2sq_matrix_tf32(a, b, products=3)
    assert _rule_share(got, want, a, b) <= RULE_SHARE_3X


def test_products_must_be_one_or_three():
    a = torch.ones((2, 3))
    with pytest.raises(ValueError, match="products"):
        ref.l2sq_matrix_tf32(a, a, products=2)


@pytest.mark.parametrize("k", [0, 1, 32, 90, 533])
def test_plain_split_pass_pads_and_splits(k):
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.normal(size=(5, k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(7, k)).astype(np.float32))
    k_pad = tuning.matrix_plan(5, 7, k).k_pad
    sa, sb, a_sq, b_sq = l2dist.split_pass(a, b, k_pad)
    for x, split, sq in ((a, sa, a_sq), (b, sb, b_sq)):
        assert split.shape == (2, len(x), k_pad)
        assert torch.equal(split[0, :, :k] + split[1, :, :k], x)
        assert not split[:, :, k:].any()
        assert torch.equal(split[0], ref.tf32_split(split[0])[0])
        assert torch.allclose(sq, (x.double() ** 2).sum(1).float())


# --------------------------------------------------------------------------
# The launch plan and the launch
# --------------------------------------------------------------------------
@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 50_000), n=st.integers(1, 50_000),
       k=st.integers(0, 2_048))
def test_matrix_plan_covers_the_output_and_fits(m, n, k):
    plan = tuning.matrix_plan(m, n, k)
    assert plan.k_pad >= max(k, 1) and plan.k_pad % 32 == 0
    assert plan.k_pad - k < 32 or k == 0
    assert plan.m_tiles * tuning.MATRIX_TILE_M >= m
    assert (plan.m_tiles - 1) * tuning.MATRIX_TILE_M < m
    assert plan.n_tiles * tuning.MATRIX_TILE_N >= n
    assert (plan.n_tiles - 1) * tuning.MATRIX_TILE_N < n
    assert plan.stages == tuning.matrix_max_stages() >= 2
    assert plan.smem_bytes >= tuning.MATRIX_ALIGN + plan.stages * (
        tuning.MATRIX_STAGE_BYTES + tuning.MATRIX_BARRIER_BYTES)
    assert plan.smem_bytes <= tuning.SMEM_OPTIN_LIMIT \
        - tuning.SMEM_RESERVED_PER_BLOCK
    assert 1 <= plan.grid <= tuning.GRID_X_LIMIT


def test_matrix_plan_at_the_smoke_shapes():
    assert tuning.MATRIX_STAGE_BYTES == 64 * 1024
    plan = tuning.matrix_plan(2841, 2808, 512)
    assert (plan.k_pad, plan.stages, plan.smem_bytes) == (512, 3, 197_680)
    assert (plan.m_tiles, plan.n_tiles, plan.grid) == (23, 22, 506)
    bulk = tuning.matrix_plan(4096, 22464, 512)
    assert (bulk.m_tiles, bulk.n_tiles) == (32, 176)
    # M < 64: one tile row, TMA fills the other 125 rows with zeros
    assert tuning.matrix_plan(3, 2808, 512).m_tiles == 1


@pytest.mark.parametrize("kwargs,match", [
    ({"m": 2 ** 31}, "int32"), ({"n": 2 ** 31}, "int32"),
    ({"m": 2 ** 30, "n": 2 ** 30}, "grid"),
])
def test_matrix_plan_refuses(kwargs, match):
    args = {"m": 8, "n": 8, "k": 8, **kwargs}
    with pytest.raises(ValueError, match=match):
        tuning.matrix_plan(**args)


@pytest.mark.parametrize("extra,fits", [(0, True), (1, False)])
def test_matrix_ring_is_the_deepest_that_fits(extra, fits):
    stages = tuning.matrix_max_stages() + extra
    room = tuning.SMEM_OPTIN_LIMIT - tuning.SMEM_RESERVED_PER_BLOCK
    assert (tuning.matrix_smem_bytes(stages) <= room) is fits


@pytest.fixture
def launches(monkeypatch):
    """Record each launch on "meta" tensors instead of making it."""
    made = []
    monkeypatch.setattr(_build, "check_cuda_tensors", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch",
                        lambda name, device, *a: made.append((name, a)))
    ops.reset_launch_counts()
    return made


@pytest.mark.parametrize("m,n,k", [
    (2841, 2808, 512), (3, 2808, 512), (64, 128, 32), (37, 61, 90),
    (4096, 22464, 512), (5, 3, 0)])
def test_wrapper_launches_split_then_product(launches, m, n, k):
    a = torch.empty((m, k), device="meta")
    b = torch.empty((n, k), device="meta")
    out = l2dist.l2sq_matrix(a, b)
    assert out.shape == (m, n) and out.dtype == torch.float32
    plan = tuning.matrix_plan(m, n, k)
    (split, split_args), (product, args) = launches
    assert split == "repro_l2sq_split" and product == "repro_l2sq_matrix"
    assert split_args[0] is a and split_args[1] is b
    sa, sb, a_sq, b_sq = split_args[2:6]
    assert sa.shape == (2, m, plan.k_pad) and sb.shape == (2, n, plan.k_pad)
    assert a_sq.shape == (m,) and b_sq.shape == (n,)
    assert split_args[6:] == (m, n, k, plan.k_pad)
    assert args[:4] == (sa, sb, a_sq, b_sq) and args[4].shape == (m, n)
    assert args[5:] == (m, n, plan.k_pad, plan.stages, plan.smem_bytes)
    assert len(_build._SIGNATURES[split]) == len(split_args)
    assert len(_build._SIGNATURES[product]) == len(args)
    assert ops.launch_counts()["l2sq_matrix"] == 1


def test_wrapper_launches_nothing_for_an_empty_side(launches):
    a = torch.empty((0, 16), device="meta")
    b = torch.empty((9, 16), device="meta")
    assert l2dist.l2sq_matrix(a, b).shape == (0, 9)
    assert l2dist.l2sq_matrix(b, a).shape == (9, 0)
    assert launches == [] and ops.launch_counts()["l2sq_matrix"] == 0


def test_kernel_source_is_the_tensor_core_design():
    # the tile constants: tests/test_torch_knn.py
    src = (_build.CSRC / "l2sq_matrix.cu").read_text()
    assert f"constexpr int kTileN = {tuning.MATRIX_TILE_N};" in src
    assert "m64n128k8.f32.tf32.tf32" in src
    assert "cp.async.bulk.tensor.3d" in src and "mbarrier.try_wait" in src
    assert "cp.async.bulk.tensor.2d.global.shared::cta" in src  # TMA store
    assert src.count("wgmma_tf32(part,") == 3   # three products a k8 step
    assert "cvt.rna.tf32.f32" in src
    # one route: the FFMA kernel and its vector flag are gone
    assert "fmaf(av" not in src and "int vec" not in src


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the l2sq_matrix kernels have no CPU "
                    "mode (chip_smoke.py holds them on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(37, 61, 90), (3, 2808, 512),
                                   (129, 1, 533)])
def test_split_kernel_matches_the_plain_split(m, n, k, card):
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    k_pad = tuning.matrix_plan(m, n, k).k_pad
    got = l2dist.split_pass(a.to(card), b.to(card), k_pad)
    want = l2dist.split_pass(a, b, k_pad)
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g.cpu(), w)
    for g, x in zip(got[2:], (a, b)):
        exact = (x.double() ** 2).sum(1)
        limit = l2dist.K_SIGMA * k ** 0.5 * l2dist.U * exact
        assert bool(((g.cpu().double() - exact).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", CARD_SHAPES)
def test_product_kernel_holds_the_rule_at_ragged_shapes(m, n, k, card):
    rng = np.random.default_rng(m * n + k)
    # a slice one row in: 16-byte misaligned rows whenever 4 k % 16 != 0
    a_all = torch.from_numpy(rng.normal(size=(m + 1, k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    a = a_all[1:]
    ga, gb = a_all.to(card)[1:], b.to(card)
    got = l2dist.l2sq_matrix(ga, gb)
    assert torch.equal(got, l2dist.l2sq_matrix(ga, gb))
    assert bool((got >= 0).all())
    assert _rule_share(got.cpu(), ref.l2sq_matrix(a, b), a, b) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(300, 257, 256), (37, 61, 90)])
def test_product_kernel_gives_the_same_bits_at_every_ring_depth(m, n, k,
                                                                card):
    # the ring only stages K blocks: each output's sum order is fixed
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(card)
    outs = []
    plan = tuning.matrix_plan(m, n, k)
    split = l2dist.split_pass(a, b, plan.k_pad)
    for depth in range(2, plan.stages + 1):
        out = torch.empty((m, n), device=card)
        _build.launch("repro_l2sq_matrix", a.device, *split, out, m, n,
                      plan.k_pad, depth, tuning.matrix_smem_bytes(depth))
        outs.append(out)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.equal(outs[0], l2dist.l2sq_matrix(a, b))


@pytest.mark.cuda
def test_product_kernel_keeps_nan(card):
    a = torch.ones((3, 40), device=card)
    a[1, 7] = float("nan")
    out = l2dist.l2sq_matrix(a, torch.zeros((5, 40), device=card))
    assert bool(out[1].isnan().all())
    assert torch.equal(out[0::2].cpu(), torch.full((2, 5), 40.0))

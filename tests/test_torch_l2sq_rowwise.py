"""The rowwise distance kernel (`src/repro_torch/kernels/csrc/l2sq_rowwise.cu`)
and its route through `KNNFeaturizer.transform(..., rowwise=True)`, on
the CPU.

The CUDA kernel runs only on the card (`chip_smoke.py` holds it against
its plain versions there, and the `cuda`-marked test below does where
there is one).  Here:

  * `tuning.rowwise_plan` on a hypothesis grid (N to 400,000, K to
    100,000, aligned or not): one wave of blocks, J instantiated in the
    source, the scalar route exactly where float4 loads cannot go, any K;
  * `ref.fmaf` (CUDA's fmaf) against exact rational arithmetic;
  * `kernel_copy`, the kernel's walk in plain PyTorch: blocks striding
    over tiles of a row a warp, passes of J chunks of 128 columns, a
    float4 a lane a chunk, fmaf in column order, the xor butterfly.  For
    every plan it equals `ref.l2sq_rowwise_lanes` bit for bit (warps,
    blocks and chunks do not change the bits), gives the
    same bits twice, and lies within `rowwise_limit` of `ref.l2sq_rowwise`
    and of the JAX package's `l2sq_rowwise` (its ref and its Pallas
    kernel in interpret mode);
  * the `out=` / `batch=` route: on the CPU it writes the plain version's
    bits, a rowwise transform of Q queries makes exactly Q `l2sq`
    dispatches, and on "meta" tensors the bound launcher is called once a
    query with the plan's arguments;
  * K past the old shared-memory cap (57,856) runs.

JAX is imported inside the one test that runs it, so `python -m pytest -m
cuda tests/test_torch_l2sq_rowwise.py` runs the card's test where JAX is
not installed.
"""
import re
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.core import knn  # noqa: E402
from repro_torch.kernels import _build, l2dist, ops, ref, registry  # noqa: E402,E501
from repro_torch.kernels import tuning  # noqa: E402

torch.set_num_threads(1)

OLD_MAX_K = (tuning.SMEM_OPTIN_LIMIT - tuning.SMEM_RESERVED_PER_BLOCK) // 4
WAVE = tuning.SM_COUNT * tuning.ROWWISE_WAVE_WARPS
# (N, K, offset of refs into their buffer in floats): K % 4 != 0, a slice
# one row in at K = 533, K = 1, N = 1, N not a multiple of a block's rows,
# K % 4 == 0 one float in (misaligned), the walk route, past the old cap
RAGGED = [(37, 90, 0), (30, 533, 533), (64, 1, 0), (1, 512, 0),
          (45, 512, 0), (17, 512, 1), (5, 1028, 0), (3, 60_000, 0)]
# Past one wave of warps (N > WAVE): the blocks stride over the rows, on
# each route J (K = 512, 256, 128) and on the walk route (K = 1,028)
PAST_ONE_WAVE = [(7000, 512, 0), (7000, 256, 0), (4000, 1028, 0),
                 (13000, 128, 0)]


def _kernel_instances():
    """(route, J) of every `launch_vec` instantiation in the source."""
    src = (_build.CSRC / "l2sq_rowwise.cu").read_text()
    return {("walk" if walk == "true" else "registers", int(j))
            for j, walk in re.findall(r"launch_vec<(\d+), (true|false)>",
                                      src)}


# --------------------------------------------------------------------------
# The plan
# --------------------------------------------------------------------------
@settings(max_examples=400, deadline=None)
@given(n=st.integers(1, 400_000), k=st.integers(1, 100_000),
       aligned=st.booleans())
def test_rowwise_plan_fills_one_wave_within_the_register_budget(n, k,
                                                                aligned):
    plan = tuning.rowwise_plan(n, k, aligned)
    vec = aligned and k % 4 == 0
    assert plan.route == ("scalar" if not vec else
                          "registers" if k <= 8 * tuning.ROWWISE_CHUNK
                          else "walk")
    assert plan.warps in tuning.ROWWISE_WARPS and plan.blocks >= 1
    # one wave: every warp of the grid resident at once
    assert plan.blocks * plan.warps <= WAVE
    if n <= WAVE:       # a row a warp, one pass, no idle block
        assert (plan.blocks - 1) * plan.warps < n <= plan.blocks * plan.warps
    else:               # the whole wave strides
        assert plan.blocks * plan.warps == WAVE
    if plan.route == "scalar":
        assert plan.chunks == 1
        return
    assert (plan.route, plan.chunks) in _kernel_instances()
    if plan.route == "registers":
        # the fewest chunks (a power of two) that cover K
        assert plan.chunks * tuning.ROWWISE_CHUNK >= k
        assert plan.chunks == 1 or \
            plan.chunks // 2 * tuning.ROWWISE_CHUNK < k
    else:
        assert plan.chunks == tuning.ROWWISE_CHUNKS[-1]


def test_rowwise_plan_at_the_knn_shape():
    # 2,808 x 512: q in 16 registers (J = 4), the 2,808 warps in one wave,
    # 2 warps a block (the busiest SM 22 warps, against 24 with 8-warp
    # blocks), about 43 KB of rows in flight an SM
    plan = tuning.rowwise_plan(2808, 512)
    assert plan == tuning.RowwisePlan("registers", 4, 2, 1404)
    assert plan.launch_args == (0, 4, 2, 1404)
    busiest = -(-plan.blocks // tuning.SM_COUNT) * plan.warps
    assert busiest == 22
    in_flight = 2808 * 512 * 4 / tuning.SM_COUNT
    assert in_flight >= 20 * 1024
    assert tuning.rowwise_warps(2808) == 2
    assert tuning.rowwise_plan(2808, 533).route == "scalar"
    assert tuning.rowwise_plan(2808, 512, aligned=False).route == "scalar"
    assert tuning.rowwise_plan(3, 60_000).route == "walk"
    # past one wave: a wave of 8-warp blocks strides
    assert tuning.rowwise_plan(7000, 512) == tuning.RowwisePlan(
        "registers", 4, 8, WAVE // 8)


def test_kernel_source_matches_the_plan_constants():
    src = (_build.CSRC / "l2sq_rowwise.cu").read_text()
    assert f"constexpr int kMaxWarps = {max(tuning.ROWWISE_WARPS)};" in src
    assert "constexpr int kChunk = 32;" in src     # float4s: 128 columns
    assert tuning.ROWWISE_CHUNK == 32 * 4
    assert ("constexpr int kRegisters = 0, kWalk = 1, kScalar = 2;"
            in src) and tuning.ROWWISE_ROUTES == ("registers", "walk",
                                                  "scalar")
    want = {("registers", j) for j in tuning.ROWWISE_CHUNKS}
    want.add(("walk", tuning.ROWWISE_CHUNKS[-1]))
    assert _kernel_instances() == want
    # q, refs, out, n; k; the plan's four
    assert len(_build._SIGNATURES["repro_l2sq_rowwise"]) == 4 + 1 + 4


# --------------------------------------------------------------------------
# The kernel's arithmetic in plain PyTorch
# --------------------------------------------------------------------------
def _exact_f32(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even."""
    f = np.float32(float(x))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - x),
                                    int(np.array(v).view(np.int32)) & 1))


def test_fmaf_rounds_once():
    rng = np.random.default_rng(5)
    n = 400
    a = (rng.normal(size=n) * 2.0 ** rng.integers(-30, 30, n)).astype(
        np.float32)
    b = (rng.normal(size=n) * 2.0 ** rng.integers(-30, 30, n)).astype(
        np.float32)
    c = (rng.normal(size=n) * 2.0 ** rng.integers(-30, 30, n)).astype(
        np.float32)
    got = ref.fmaf(*map(torch.from_numpy, (a, b, c))).numpy()
    for i in range(n):
        want = _exact_f32(Fraction(float(a[i])) * Fraction(float(b[i]))
                          + Fraction(float(c[i])))
        assert got[i] == want, (a[i], b[i], c[i])


def kernel_copy(q: torch.Tensor, refs: torch.Tensor,
                plan: tuning.RowwisePlan) -> torch.Tensor:
    """`csrc/l2sq_rowwise.cu` as it walks: each block strides over tiles of
    a row a warp; a warp's row takes passes of J chunks (one pass on the
    registers route), a chunk a float4 a lane, q's float4 for the same
    columns; zeros past K; fmaf in column order within a float4; the xor
    butterfly; the tile's sums stored in row order."""
    n, k = refs.shape
    out = torch.full((n,), float("nan"))
    lanes = torch.arange(32)
    per_pass = 32 * 4 * plan.chunks
    k_pad = -(-k // per_pass) * per_pass
    q_pad = torch.nn.functional.pad(q, (0, k_pad - k))
    for block in range(plan.blocks):
        for base in range(block * plan.warps, n, plan.blocks * plan.warps):
            for row in range(base, min(base + plan.warps, n)):
                r_pad = torch.nn.functional.pad(refs[row], (0, k_pad - k))
                acc = torch.zeros(32)
                for at in range(0, k_pad, per_pass):
                    for j in range(plan.chunks):
                        cols = at + 128 * j + 4 * lanes
                        for c in range(4):
                            d = r_pad[cols + c] - q_pad[cols + c]
                            acc = ref.fmaf(d, d, acc)
                for offset in (16, 8, 4, 2, 1):
                    acc = acc + acc[lanes ^ offset]
                assert torch.equal(acc, acc[:1].expand(32))
                out[row] = acc[0]
    return out


def _plans(n, k, aligned=True):
    """The plan and others around it: warps, blocks (a striding grid)."""
    plan = tuning.rowwise_plan(n, k, aligned)
    return [plan] + [tuning.RowwisePlan(plan.route, plan.chunks, w, b)
                     for w in (1, 8) for b in (1, 3)]


@pytest.mark.parametrize("n,k,offset", RAGGED[:-1] + [(40, 256, 0),
                                                      (9, 1024, 0)])
def test_kernel_copy_is_the_lanes_order_on_every_plan(n, k, offset):
    rng = np.random.default_rng(n * 1000 + k)
    q = torch.from_numpy(rng.normal(size=k).astype(np.float32))
    buf = torch.from_numpy(rng.normal(size=offset + n * k).astype(
        np.float32))
    refs = buf[offset:].view(n, k)
    want = ref.l2sq_rowwise_lanes(q, refs)
    for plan in _plans(n, k, aligned=offset % 4 == 0):
        assert torch.equal(kernel_copy(q, refs, plan), want), plan
    assert torch.equal(ref.l2sq_rowwise_lanes(q, refs), want)
    limit = l2dist.rowwise_limit(q, refs)
    err = (want.double() - ref.l2sq_rowwise(q, refs).double()).abs()
    assert (err <= limit).all() and (want >= 0).all()


@pytest.mark.parametrize("against", ["ref", "pallas"])
@pytest.mark.parametrize("n,k", [(256, 128), (100, 512), (37, 90), (8, 8)])
def test_lanes_order_matches_jax(n, k, against):
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    rng = np.random.default_rng(3)
    q = rng.normal(size=(k,)).astype(np.float32)
    refs = rng.normal(size=(n, k)).astype(np.float32)
    tq, tr = torch.from_numpy(q), torch.from_numpy(refs)
    got = ref.l2sq_rowwise_lanes(tq, tr)
    assert torch.equal(kernel_copy(tq, tr, tuning.rowwise_plan(n, k)), got)
    want = np.array(jops.l2sq_rowwise(jnp.asarray(q), jnp.asarray(refs),
                                      backend=against))
    limit = l2dist.rowwise_limit(tq, tr).numpy()
    assert (np.abs(got.numpy().astype(np.float64) - want) <= limit).all()


def test_k_past_the_old_shared_memory_cap_runs():
    k = 60_000
    assert k > OLD_MAX_K
    assert not hasattr(l2dist, "ROWWISE_MAX_K")
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.normal(size=k).astype(np.float32))
    refs = torch.from_numpy(rng.normal(size=(3, k)).astype(np.float32))
    want = ref.l2sq_rowwise(q, refs)
    assert torch.equal(l2dist.l2sq_rowwise(q, refs), want)
    lanes = ref.l2sq_rowwise_lanes(q, refs)
    assert ((lanes.double() - want.double()).abs()
            <= l2dist.rowwise_limit(q, refs)).all()
    plan = tuning.rowwise_plan(3, k)
    assert plan.route == "walk"
    assert torch.equal(kernel_copy(q, refs, plan), lanes)
    feat = knn.KNNFeaturizer(refs, torch.arange(3, dtype=torch.int32), 3,
                             k=2, device="cpu")
    got = feat.transform(q[None, :], rowwise=True)
    assert torch.equal(got, feat._features_from_dists(want[None, :]))


# --------------------------------------------------------------------------
# The route: out=, batch=, one dispatch a query
# --------------------------------------------------------------------------
def _knn_case(q_rows=23, m=40, k=24, seed=2):
    rng = np.random.default_rng(seed)
    refs = rng.normal(size=(m, k)).astype(np.float32)
    labels = rng.integers(0, 4, m).astype(np.int32)
    queries = rng.normal(size=(q_rows, k)).astype(np.float32)
    return refs, labels, queries


def test_out_route_on_the_cpu_equals_the_stacked_one():
    refs, labels, queries = _knn_case()
    tr, tq = torch.from_numpy(refs), torch.from_numpy(queries)
    stacked = torch.stack([ref.l2sq_rowwise(q, tr) for q in tq])
    buf = torch.full(stacked.shape, float("nan"))
    run = ops.rowwise_batch(tq, tr)
    for i in range(len(tq)):
        got = ops.l2sq_rowwise(tq[i], tr, out=buf[i], batch=run)
        assert got.data_ptr() == buf[i].data_ptr()
    assert torch.equal(buf, stacked)
    buf2 = torch.empty_like(stacked)
    for i in range(len(tq)):        # a lone call with out=
        l2dist.l2sq_rowwise(tq[i], tr, out=buf2[i])
    assert torch.equal(buf2, stacked)
    feat = knn.KNNFeaturizer(refs, labels, 4, k=5, device="cpu")
    want = feat._features_from_dists(stacked)
    for batch_size in (7, 4096):
        assert torch.equal(feat.transform(queries, rowwise=True,
                                          batch_size=batch_size), want)


@pytest.mark.parametrize("batch_size", [5, 4096])
def test_rowwise_transform_dispatches_once_a_query(batch_size):
    refs, labels, queries = _knn_case()
    feat = knn.KNNFeaturizer(refs, labels, 4, k=5, device="cpu")
    registry.reset_call_stats()
    feat.transform(queries, rowwise=True, batch_size=batch_size)
    assert registry.call_stats() == {"l2sq": len(queries)}
    registry.reset_call_stats()
    feat.transform(queries, batch_size=batch_size)
    assert registry.call_stats() == {"l2sq": -(-len(queries) // batch_size)}


def test_out_and_batch_are_checked():
    q, refs = torch.ones(4), torch.zeros((3, 4))
    for bad in (torch.empty(3, dtype=torch.float64), torch.empty(4),
                torch.empty(6)[::2]):
        with pytest.raises(ValueError, match="out"):
            l2dist.l2sq_rowwise(q, refs, out=bad)
    run = l2dist.rowwise_batch(q[None, :], refs)
    assert run.launch is None and run.plan == tuning.rowwise_plan(3, 4)
    with pytest.raises(ValueError, match="batch"):
        l2dist.l2sq_rowwise(q, refs.clone(), out=torch.empty(3), batch=run)
    with pytest.raises(ValueError, match="batch"):
        l2dist.l2sq_rowwise(q, refs, batch=run)
    with pytest.raises(ValueError, match="batch"):
        l2dist.l2sq_rowwise(q[:3], refs, out=torch.empty(3), batch=run)
    with pytest.raises(ValueError, match="batch"):
        l2dist.l2sq_rowwise(q, refs, out=torch.empty(6)[::2], batch=run)
    with pytest.raises(ValueError, match="batch"):
        l2dist.l2sq_rowwise(torch.ones(8)[::2], refs, out=torch.empty(3),
                            batch=run)
    # q and out on the batch's device: a query elsewhere is refused
    with pytest.raises(ValueError, match="batch was checked on cpu"):
        l2dist.l2sq_rowwise(q.to("meta"), refs, out=torch.empty(3),
                            batch=run)
    with pytest.raises(ValueError, match="batch was checked on cpu"):
        l2dist.l2sq_rowwise(q, refs, out=torch.empty(3, device="meta"),
                            batch=run)
    with pytest.raises(ValueError):
        l2dist.rowwise_batch(q, refs)
    with pytest.raises(ValueError, match="rowwise"):
        ops._l2sq_ref(refs, refs, out=torch.empty(3))
    with pytest.raises(ValueError, match="CUDA"):
        ops.rowwise_batch(q[None, :], refs, backend="cuda")


def test_batch_on_the_card_launches_once_a_query(monkeypatch):
    # "meta" tensors stand in for the card's: the batch checks them once
    # and binds the launcher once; each query is one call of it with the
    # plan's arguments, counted
    queries = torch.empty((6, 12), device="meta")
    refs = torch.empty((7, 12), device="meta")
    checked, bound, calls = [], [], []
    monkeypatch.setattr(_build, "check_cuda_tensors",
                        lambda op, **t: checked.append(sorted(t)))
    monkeypatch.setattr(_build, "bind", lambda name, device: (
        bound.append(name), lambda *args: calls.append(args))[1])
    run = l2dist.rowwise_batch(queries, refs)
    out = torch.empty((6, 7), device="meta")
    ops.reset_launch_counts()
    for i in range(6):
        l2dist.l2sq_rowwise(queries[i], refs, out=out[i], batch=run)
    assert checked == [["queries", "refs"]]
    assert bound == ["repro_l2sq_rowwise"]
    plan = tuning.rowwise_plan(7, 12)
    sig = _build._SIGNATURES["repro_l2sq_rowwise"]
    for args in calls:      # the fixed ints built once, as ctypes values
        assert [type(a) for a in args[3:]] == list(sig[3:])
    assert [tuple(a.value for a in args[3:]) for args in calls] == \
        [(7, 12, *plan.launch_args)] * 6
    assert len({id(args[3]) for args in calls}) == 1
    assert ops.launch_counts()["l2sq_rowwise"] == 6


def test_fixed_args_take_the_launchers_types():
    sig = _build._SIGNATURES["repro_l2sq_rowwise"]
    got = _build.fixed_args("repro_l2sq_rowwise", 3, 2808, 512, 0, 4, 2,
                            1404)
    assert [type(a) for a in got] == list(sig[3:])
    assert [a.value for a in got] == [2808, 512, 0, 4, 2, 1404]
    with pytest.raises(ValueError):      # one value a remaining argument
        _build.fixed_args("repro_l2sq_rowwise", 3, 2808, 512)
    plan, tail = l2dist._rowwise_launch(2808, 512, True)
    assert plan == tuning.rowwise_plan(2808, 512)
    assert [a.value for a in tail] == [2808, 512, *plan.launch_args]


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rowwise kernel has no CPU mode "
                    "(chip_smoke.py holds it on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,offset",
                         RAGGED + PAST_ONE_WAVE + [(2808, 512, 0)])
def test_rowwise_kernel_on_the_card_is_the_lanes_order(n, k, offset, card):
    rng = np.random.default_rng(n + k)
    q = torch.from_numpy(rng.normal(size=k).astype(np.float32))
    buf = torch.from_numpy(rng.normal(size=offset + n * k).astype(
        np.float32))
    refs = buf[offset:].view(n, k)
    gq, grefs = q.to(card), buf.to(card)[offset:].view(n, k)
    got = l2dist.l2sq_rowwise(gq, grefs)
    assert torch.equal(got, l2dist.l2sq_rowwise(gq, grefs))
    assert torch.equal(got.cpu(), ref.l2sq_rowwise_lanes(q, refs))
    err = (got.cpu().double() - ref.l2sq_rowwise(q, refs).double()).abs()
    assert (err <= l2dist.rowwise_limit(q, refs)).all()

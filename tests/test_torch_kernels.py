"""The port's kernel ops against the JAX package, on the CPU.

Each of the eight kernels of the serving path (binarize, leaf_index,
leaf_gather, fused_predict, and the depth_major and bitpacked siblings
leaf_index_dm, fused_predict_dm, leaf_index_bp, fused_predict_bp) is
checked three ways on the "mixed" and "edge" scenarios of
tests/test_differential.py:

  * its plain PyTorch version against the JAX reference (`repro.kernels.ref`);
  * its kernel wrapper, called on CPU tensors (where it takes the plain
    version and launches nothing), on the model as a plan lowers it;
  * against the JAX Pallas kernel in interpret mode, on a tiny case.

The CUDA kernels themselves run only on the card (chip_smoke.py holds
them against these plain versions there).  Integer outputs match exactly;
float sums within rtol = atol = 1e-4 (tests/test_differential.py:88): the
port sums trees in another order than XLA.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import layout as jlayout  # noqa: E402
from repro.core import trees as jtrees  # noqa: E402
from repro.kernels import histogram as jhist  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import registry as jregistry  # noqa: E402
from repro_torch.core import layout as tlayout  # noqa: E402
from repro_torch.core import trees as ttrees  # noqa: E402
from repro_torch.kernels import _build, ops, ref, registry  # noqa: E402
from repro_torch.kernels import tuning  # noqa: E402
from repro_torch.kernels import binarize as binarize_k  # noqa: E402
from repro_torch.kernels import fused_predict as fused_k  # noqa: E402
from repro_torch.kernels import histogram as hist_k  # noqa: E402
from repro_torch.kernels import leaf_gather as gather_k  # noqa: E402
from repro_torch.kernels import leaf_index as index_k  # noqa: E402

torch.set_num_threads(1)

SCENARIOS = ("mixed", "edge")


def _scenario(name):
    """(x, borders, sf, sb, lv) numpy arrays; the scenarios of
    tests/test_differential.py:40-70, truncation included."""
    if name == "mixed":
        rng = np.random.default_rng(11)
        n, f, b, t, d, c = 21, 7, 9, 6, 4, 2
        x = rng.normal(size=(n, f)).astype(np.float32)
        x[rng.random((n, f)) < 0.08] = np.nan
        borders = np.sort(rng.normal(size=(b, f)), 0).astype(np.float32)
        sf = rng.integers(0, f, (t, d)).astype(np.int32)
        sb = rng.integers(1, b + 1, (t, d)).astype(np.int32)
        lv = rng.normal(size=(t, 1 << d, c)).astype(np.float32)
        ens = jtrees.ObliviousEnsemble(
            jnp.asarray(sf), jnp.asarray(sb), jnp.asarray(lv),
            jnp.asarray(borders), jnp.full((f,), b, jnp.int32))
        ens = jtrees.truncate_tree_depths(ens, np.array([0, 1, 2, 4, 3, 4]))
        sb, lv = np.asarray(ens.split_bins), np.asarray(ens.leaf_values)
    else:  # "edge": 255 borders, bins 0 and 255, T = 1, one row
        rng = np.random.default_rng(23)
        f, b, t, d, c = 3, 255, 1, 2, 1
        borders = np.sort(rng.normal(size=(b, f)), 0).astype(np.float32)
        x = np.array([[borders[0, 0] - 1.0, borders[-1, 1] + 1.0,
                       np.nan]], np.float32)
        sf = np.array([[1, 0]], np.int32)
        sb = np.array([[255, 1]], np.int32)
        lv = rng.normal(size=(t, 1 << d, c)).astype(np.float32)
    return x, borders, sf, sb, lv


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _int_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def _jax_outputs(x, borders, sf, sb, lv):
    bins = jref.binarize(jnp.asarray(x), jnp.asarray(borders))
    idx = jref.leaf_index(bins, jnp.asarray(sf), jnp.asarray(sb))
    return {"binarize": bins,
            "binarize_u8": jref.binarize_u8(jnp.asarray(x),
                                            jnp.asarray(borders)),
            "leaf_index": idx,
            "leaf_gather": jref.leaf_gather(idx, jnp.asarray(lv)),
            "fused_predict": jref.fused_predict(
                jnp.asarray(x), jnp.asarray(borders), jnp.asarray(sf),
                jnp.asarray(sb), jnp.asarray(lv))}


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("op", ["binarize", "binarize_u8", "leaf_index",
                                "leaf_index_u8", "leaf_gather",
                                "fused_predict"])
def test_plain_version_matches_jax_ref(op, scenario):
    x, borders, sf, sb, lv = _scenario(scenario)
    want = _jax_outputs(x, borders, sf, sb, lv)
    xt, bt, sft, sbt, lvt = _t(x, borders, sf, sb, lv)
    if op == "binarize":
        got = ref.binarize(xt, bt)
        assert got.dtype == torch.int32
        _int_equal(got, want["binarize"])
    elif op == "binarize_u8":
        got = ref.binarize_u8(xt, bt)
        assert got.dtype == torch.uint8
        _int_equal(got, want["binarize_u8"])
    elif op.startswith("leaf_index"):
        bins = ref.binarize(xt, bt)
        if op == "leaf_index_u8":
            bins = bins.to(torch.uint8)
        got = ref.leaf_index(bins, sft, sbt)
        assert got.dtype == torch.int32
        _int_equal(got, want["leaf_index"])
    elif op == "leaf_gather":
        idx = torch.from_numpy(np.array(want["leaf_index"]))
        _close(ref.leaf_gather(idx, lvt), want["leaf_gather"])
    else:
        _close(ref.fused_predict(xt, bt, sft, sbt, lvt),
               want["fused_predict"])


def _lowered_model(scenario):
    """The scenario's model as a plan lowers it: the exact arrays, with no
    tree padding (the kernels mask their own edges)."""
    x, borders, sf, sb, lv = _scenario(scenario)
    ens = ttrees.ObliviousEnsemble(*_t(sf, sb, lv, borders),
                                   torch.full((borders.shape[1],),
                                              borders.shape[0]))
    low = tlayout.lower(ens, "soa")
    assert low.split_features.shape == sf.shape
    assert low.leaf_values.shape == lv.shape
    return torch.from_numpy(x), low, _jax_outputs(x, borders, sf, sb, lv)


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("op", ["binarize", "leaf_index", "leaf_gather",
                                "fused_predict"])
def test_cuda_entry_on_cpu_tensors_matches_jax_ref(op, scenario):
    # The kernel wrappers, called on CPU tensors, take their plain
    # versions; through the registry the cuda family refuses CPU data.
    x, low, want = _lowered_model(scenario)
    sf, sb, lv = low.split_features, low.split_bins, low.leaf_values
    bins = ref.binarize_u8(x, low.borders)
    idx = torch.from_numpy(np.array(want["leaf_index"]))
    ops.reset_launch_counts()
    if op == "binarize":
        _int_equal(binarize_k.binarize(x, low.borders), want["binarize"])
        got = binarize_k.binarize(x, low.borders, out_dtype=torch.uint8)
        assert got.dtype == torch.uint8
        _int_equal(got, want["binarize_u8"])
        call = lambda: ops.binarize_u8(x, low.borders, backend="cuda")
    elif op == "leaf_index":
        _int_equal(index_k.leaf_index(bins, sf, sb), want["leaf_index"])
        call = lambda: ops.leaf_index(bins, sf, sb, backend="cuda")
    elif op == "leaf_gather":
        _close(gather_k.leaf_gather(idx, lv), want["leaf_gather"])
        call = lambda: ops.leaf_gather(idx, lv, backend="cuda")
    else:
        _close(fused_k.fused_predict(x, low.borders, sf, sb, lv),
               want["fused_predict"])
        call = lambda: low.fused_raw(x, backend="cuda")
    # CPU tensors take the plain versions: no kernel was launched
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    with pytest.raises(ValueError, match="CPU"):
        call()


def _pallas(op, *args):
    """The JAX Pallas kernel, in interpret mode off-TPU."""
    return jregistry.get(op, "pallas").fn(*(jnp.asarray(a) for a in args))


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("op", ["binarize", "leaf_index", "leaf_gather",
                                "fused_predict"])
def test_plain_version_matches_pallas_interpret(op, scenario):
    x, borders, sf, sb, lv = _scenario(scenario)
    x = x[:8]                            # tiny: Pallas interprets on CPU
    xt, bt, sft, sbt, lvt = _t(x, borders, sf, sb, lv)
    bins = ref.binarize(xt, bt)
    if op == "binarize":
        _int_equal(ref.binarize(xt, bt), _pallas("binarize", x, borders))
    elif op == "leaf_index":
        _int_equal(ref.leaf_index(bins, sft, sbt),
                   _pallas("leaf_index", bins.numpy(), sf, sb))
    elif op == "leaf_gather":
        idx = ref.leaf_index(bins, sft, sbt)
        _close(ref.leaf_gather(idx, lvt),
               _pallas("leaf_gather", idx.numpy(), lv))
    else:
        _close(ref.fused_predict(xt, bt, sft, sbt, lvt),
               _pallas("fused_predict", x, borders, sf, sb, lv))


def test_sentinel_survives_uint8_bins():
    # bin 255 against a PAD_SPLIT_BIN level: narrowing the split bin to
    # uint8 would make it 0 and send the level right
    bins = torch.tensor([[255, 0]], dtype=torch.uint8)
    sf = torch.tensor([[0, 0]], dtype=torch.int32)
    sb = torch.tensor([[255, ops.PAD_SPLIT_BIN]], dtype=torch.int32)
    assert ops.leaf_index(bins, sf, sb).tolist() == [[1]]


def test_registry_resolves_by_device():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert registry.known_backends() == ("cuda", "torch_ref")
    assert registry.resolve("binarize", "auto", device=cpu) == "torch_ref"
    assert registry.resolve("binarize", "auto", device=cuda) == "cuda"
    assert registry.resolve("binarize", "auto", device=cuda,
                            dtype="uint8") == "cuda"
    assert registry.resolve("binarize", "torch_ref", device=cpu,
                            dtype="uint8") == "torch_ref"
    assert registry.resolve("leaf_index", "cuda", device=cuda,
                            dtype="uint8") == "cuda"
    with pytest.raises(ValueError, match="dtype"):
        registry.resolve("leaf_gather", "cuda", device=cuda, dtype="uint8")
    with pytest.raises(ValueError, match="plain"):
        registry.resolve("leaf_gather", "torch_ref", device=cuda)
    with pytest.raises(ValueError, match="CPU"):
        registry.resolve("leaf_gather", "cuda", device=cpu)
    with pytest.raises(KeyError):
        registry.resolve("leaf_gather", "pallas", device=cpu)
    assert {r["op"] for r in registry.table()} == set(registry.CORE_OPS)


def test_dispatch_counts_calls():
    registry.reset_call_stats()
    x = torch.zeros((2, 3))
    ops.binarize_u8(x, torch.zeros((4, 3)))
    ops.binarize(x, torch.zeros((4, 3)))
    assert registry.call_stats() == {"binarize": 2}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((2, 3))
    sf = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="255"):
        binarize_k.binarize(x, torch.zeros((256, 3)), out_dtype=torch.uint8)
    with pytest.raises(ValueError):
        binarize_k.binarize(x, torch.zeros((4, 5)))
    with pytest.raises(ValueError):
        index_k.leaf_index(torch.zeros((2, 3)), sf, sf)  # f32 bins
    with pytest.raises(ValueError):
        gather_k.leaf_gather(torch.zeros((2, 4), dtype=torch.int32),
                             torch.zeros((3, 4, 1)))
    with pytest.raises(ValueError):
        fused_k.fused_predict(x, torch.zeros((4, 3)), sf, sf,
                              torch.zeros((5, 4, 1)))


def test_shared_memory_tiles_fit_and_avoid_bank_conflicts():
    # Covertype width in bulk: 64 rows of 54 uint8 or int32 bins, staged
    # as a transposed tile whose feature columns are an odd number of
    # words (uint8) or of 16-byte chunks (int32) apart
    for bin_bytes in (1, 4):
        tile = tuning.index_plan(139_440, 1000, 8, 54, bin_bytes).tile
        assert (tile.rows, tile.route) == (64, "shared")
        assert tile.stride % 4 == 0 and (tile.stride // 4) % 2 == 1
        assert tile.tile_bytes == 55 * tile.stride * bin_bytes
        assert tile.smem_bytes <= tuning.SMEM_DEFAULT_BYTES
    for n_feat, u8 in [(f, u8) for f in (1, 3, 54, 200) for u8 in (0, 1)] \
            + [(512, 1)]:
            plan = fused_k.tile_shape(n_feat, u8)
            rows, stride = plan.rows, plan.stride
            bin_bytes = 1 if u8 else 4
            assert stride >= n_feat and rows % 32 == 0
            assert (stride * bin_bytes // 4) % 2 == 1    # odd word stride
            assert plan.route == "shared" and not plan.opt_in
            assert rows * stride * bin_bytes == plan.tile_bytes \
                <= tuning.SMEM_DEFAULT_BYTES
    # rows too wide for the opt-in limit are read from global memory
    for plan in (tuning.index_plan(64, 40, 8, 10_000, 4).tile,
                 fused_k.tile_shape(10_000, False)):
        assert plan.route == "global" and plan.tile_bytes == 0
        assert plan.stride == 10_000


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_failed_nvcc_build_raises(monkeypatch, tmp_path):
    # a compiler that exits non-zero stands in for nvcc refusing a source
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build._compile(tmp_path / "lib.so")
    assert not (tmp_path / "lib.so").exists()


def test_nonzero_launch_status_raises(monkeypatch):
    class Lib:
        def repro_binarize(self, *args):
            return 9

        def repro_cuda_error_string(self, code):
            return b"invalid configuration argument"

    monkeypatch.setattr(_build, "library", Lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.launch("repro_binarize", torch.device("cuda", 0), 1, 2)


def test_build_hash_covers_every_source():
    sources = {p.name for p in _build.CSRC.glob("*.cu*")}
    assert {"binarize.cu", "leaf_index.cu", "leaf_gather.cu",
            "fused_predict.cu", "common.cuh", "leaf_index_dm.cu",
            "leaf_index_bp.cu", "fused_predict_dm.cu", "fused_predict_bp.cu",
            "fused_planes.cuh", "fused_spread.cuh", "leaf_index.cuh",
            "histogram.cu"} <= sources
    assert _build.source_hash() == _build.source_hash()
    assert "arch=compute_90a,code=sm_90a" in _build.COMPILE_FLAGS


# --------------------------------------------------------------------------
# The depth_major and bitpacked kernels
# --------------------------------------------------------------------------
NEW_OPS = ("leaf_index_dm", "fused_predict_dm", "leaf_index_bp",
           "fused_predict_bp")


def _layouts(scenario):
    """(x, JAX depth_major and bitpacked lowerings, the port's) of a
    scenario's model; the JAX ones from `lower(..., backend="ref")`."""
    x, borders, sf, sb, lv = _scenario(scenario)
    jens = jtrees.ObliviousEnsemble(
        jnp.asarray(sf), jnp.asarray(sb), jnp.asarray(lv),
        jnp.asarray(borders), jnp.full((borders.shape[1],),
                                       borders.shape[0], jnp.int32))
    tens = ttrees.ObliviousEnsemble(*_t(sf, sb, lv, borders),
                                    torch.full((borders.shape[1],),
                                               borders.shape[0]))
    return x, {name: (jlayout.lower(jens, name, backend="ref"),
                      tlayout.lower(tens, name))
               for name in ("depth_major", "bitpacked")}


def _j(t):
    return jnp.asarray(np.asarray(t))


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("op", NEW_OPS + ("pack_bits",))
def test_new_plain_versions_match_jax_ref(op, scenario):
    x, lows = _layouts(scenario)
    xt = torch.from_numpy(x)
    jdm, dm = lows["depth_major"]
    jbp, bp = lows["bitpacked"]
    bins = ref.binarize(xt, dm.borders)
    jbins = jref.binarize(jnp.asarray(x), jdm.borders)
    if op == "leaf_index_dm":
        want = jref.leaf_index_depth_major(jbins, jdm.onehot,
                                           jdm.split_bins_dm, jdm.pow2)
        for b in (bins, bins.to(torch.uint8)):
            got = ref.leaf_index_depth_major(b, dm.split_features_dm,
                                             dm.split_bins_dm, dm.pow2)
            assert got.dtype == torch.int32
            _int_equal(got, want)
    elif op == "fused_predict_dm":
        _close(ref.fused_predict_depth_major(
            xt, dm.borders, dm.split_features_dm, dm.split_bins_dm, dm.pow2,
            dm.leaf_values), jref.fused_predict_depth_major(
            jnp.asarray(x), jdm.borders, jdm.onehot, jdm.split_bins_dm,
            jdm.pow2, jdm.leaf_values))
    elif op == "leaf_index_bp":
        for jg, g in zip(jbp.groups, bp.groups):
            want = jref.leaf_index_bitpacked(jbins, jg.split_features_bp,
                                             jg.split_bins_bp)
            for b in (bins, bins.to(torch.uint8)):
                got = ref.leaf_index_bitpacked(b, g.split_features_bp,
                                               g.split_bins_bp)
                assert got.dtype == torch.int32
                _int_equal(got, want)
    elif op == "fused_predict_bp":
        for jg, g in zip(jbp.groups, bp.groups):
            _close(ref.fused_predict_bitpacked(
                xt, bp.borders, g.split_features_bp, g.split_bins_bp,
                g.leaf_values), jref.fused_predict_bitpacked(
                jnp.asarray(x), jbp.borders, jg.split_features_bp,
                jg.split_bins_bp, jg.leaf_values))
    else:
        bits = (bins > 2).to(torch.int32)
        words = ref.pack_bits(bits)
        assert words.dtype == torch.uint32
        assert words.shape == (-(-bits.shape[0] // 32), bits.shape[1])
        _int_equal(words, jref.pack_bits(_j(bits)))
        _int_equal(ref.unpack_bits(words, bits.shape[0]), bits)


def _pallas_new(op, jlow, jgroup, x, bins):
    """The JAX Pallas kernel of a new op, in interpret mode off-TPU, on
    the JAX lowering's arrays."""
    if op == "leaf_index_dm":
        fn = jregistry.get("leaf_index", "pallas_dm").fn
        return fn(bins, jlow.onehot, jlow.split_bins_dm, jlow.pow2,
                  block_t=jlow.onehot.shape[0])
    if op == "fused_predict_dm":
        fn = jregistry.get("fused_predict", "pallas_dm").fn
        return fn(x, jlow.borders, jlow.onehot, jlow.split_bins_dm,
                  jlow.pow2, jlow.leaf_values)
    if op == "leaf_index_bp":
        fn = jregistry.get("leaf_index", "pallas_bp").fn
        return fn(bins, jgroup.split_features_bp, jgroup.split_bins_bp)
    fn = jregistry.get("fused_predict", "pallas_bp").fn
    return fn(x, jlow.borders, jgroup.split_features_bp,
              jgroup.split_bins_bp, jgroup.leaf_values)


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("op", NEW_OPS)
def test_new_plain_versions_match_pallas_interpret(op, scenario):
    x, lows = _layouts(scenario)
    x = x[:8]                            # tiny: Pallas interprets on CPU
    xt = torch.from_numpy(x)
    layout = "depth_major" if op.endswith("_dm") else "bitpacked"
    jlow, low = lows[layout]
    bins = ref.binarize(xt, low.borders).to(torch.uint8)
    groups = (list(zip(jlow.groups, low.groups)) if layout == "bitpacked"
              else [(None, None)])
    for jg, g in groups:
        want = _pallas_new(op, jlow, jg, jnp.asarray(x), _j(bins))
        if op == "leaf_index_dm":
            _int_equal(ref.leaf_index_depth_major(
                bins, low.split_features_dm, low.split_bins_dm, low.pow2),
                want)
        elif op == "fused_predict_dm":
            _close(ref.fused_predict_depth_major(
                xt, low.borders, low.split_features_dm, low.split_bins_dm,
                low.pow2, low.leaf_values), want)
        elif op == "leaf_index_bp":
            _int_equal(ref.leaf_index_bitpacked(
                bins, g.split_features_bp, g.split_bins_bp, via_words=True),
                want)
        else:
            _close(ref.fused_predict_bitpacked(
                xt, low.borders, g.split_features_bp, g.split_bins_bp,
                g.leaf_values), want)


def _new_kernel_calls(x, lows):
    """(wrapper, args, plain version) for each new kernel on the port's
    lowered arrays: every bitpacked group, uint8 and int32 bins."""
    dm = lows["depth_major"][1]
    bp = lows["bitpacked"][1]
    bins = ref.binarize(x, dm.borders)
    calls = []
    for b in (bins, bins.to(torch.uint8)):
        calls.append((index_k.leaf_index_dm,
                      (b, dm.split_features_dm, dm.split_bins_dm, dm.pow2),
                      ref.leaf_index_depth_major))
        for g in bp.groups:
            calls.append((index_k.leaf_index_bp,
                          (b, g.split_features_bp, g.split_bins_bp),
                          ref.leaf_index_bitpacked))
    calls.append((fused_k.fused_predict_dm,
                  (x, dm.borders, dm.split_features_dm, dm.split_bins_dm,
                   dm.pow2, dm.leaf_values), ref.fused_predict_depth_major))
    for g in bp.groups:
        calls.append((fused_k.fused_predict_bp,
                      (x, bp.borders, g.split_features_bp, g.split_bins_bp,
                       g.leaf_values), ref.fused_predict_bitpacked))
    return calls


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_new_cuda_entries_on_cpu_tensors_take_plain_versions(scenario):
    x, lows = _layouts(scenario)
    x = torch.from_numpy(x)
    ops.reset_launch_counts()
    for wrapper, args, plain in _new_kernel_calls(x, lows):
        got, want = wrapper(*args), plain(*args)
        assert got.dtype == want.dtype
        assert torch.equal(got, want), wrapper.__name__
    # CPU tensors take the plain versions: no kernel was launched
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    dm = lows["depth_major"][1]
    g = lows["bitpacked"][1].groups[0]
    bins = ref.binarize_u8(x, dm.borders)
    for call in (lambda: dm.leaf_sum(bins, backend="cuda"),
                 lambda: dm.fused_raw(x, backend="cuda"),
                 lambda: ops.leaf_index_bp(bins, g.split_features_bp,
                                           g.split_bins_bp, backend="cuda"),
                 lambda: ops.fused_predict_bp(
                     x, dm.borders, g.split_features_bp, g.split_bins_bp,
                     g.leaf_values, backend="cuda")):
        with pytest.raises(ValueError, match="CPU"):
            call()


def _meta(args):
    return tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.mark.parametrize("op", NEW_OPS)
def test_new_wrappers_on_cuda_typed_tensors_launch_or_raise(op,
                                                            monkeypatch):
    # Off the CPU a wrapper never takes its plain version: a tensor that
    # is not on the card is refused, and one that passes the device check
    # goes to the kernel's launcher (stubbed here) and is counted.
    x, lows = _layouts("mixed")
    calls = [c for c in _new_kernel_calls(torch.from_numpy(x), lows)
             if c[0].__name__ == op]
    wrapper, args, _ = calls[-1]
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*_meta(args))
    assert wrapper.launches == 0
    launched = []
    monkeypatch.setattr(_build, "check_cuda_tensors", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch",
                        lambda name, device, *a: launched.append(name))
    out = wrapper(*_meta(args))
    assert out.device.type == "meta"
    # a few rows take the dm and bp fused kernels' spread routes
    assert launched == [f"repro_{op}_spread" if op.startswith("fused")
                        else f"repro_{op}"]
    assert ops.launch_counts() == {k: int(k == op) for k in ops.KERNELS}


def test_registry_routes_by_layout():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for layout, suffix in (("depth_major", "dm"), ("bitpacked", "bp")):
        for op in ("leaf_index", "fused_predict"):
            assert registry.resolve(op, "auto", device=cuda,
                                    layout=layout) == f"cuda_{suffix}"
            assert registry.resolve(op, "torch_ref", device=cpu,
                                    layout=layout) == f"torch_ref_{suffix}"
            assert registry.impls_for_layout(op, layout) == \
                [f"cuda_{suffix}", f"torch_ref_{suffix}"]
        assert registry.resolve("leaf_index", "cuda", device=cuda,
                                dtype="uint8", layout=layout) == \
            f"cuda_{suffix}"
        assert registry.resolve("leaf_gather", "cuda", device=cuda,
                                layout=layout) == "cuda"
        with pytest.raises(ValueError, match="plain"):
            registry.resolve("leaf_index", "torch_ref", device=cuda,
                             layout=layout)
    assert registry.resolve("leaf_index", "cuda", device=cuda,
                            layout="depth_grouped") == "cuda"
    with pytest.raises(ValueError, match="layout"):
        registry.resolve("fused_predict", "cuda_dm", device=cuda,
                         layout="bitpacked")
    assert registry.known_backends() == ("cuda", "torch_ref")
    assert set(ops.KERNELS) == {"binarize", "leaf_index", "leaf_gather",
                                "fused_predict", *NEW_OPS, "histogram",
                                "split_level", "l2sq_rowwise",
                                "l2sq_matrix"}


def test_new_kernel_tiles_fit_shared_memory():
    # the bitpacked index kernel's bins tile beside its 32 x 33 transpose
    # tiles and split pairs, the plane kernels' beside their staged planes
    for n_feat in (1, 3, 54, 200, 2000, 8000):
        for bin_bytes in (1, 4):
            tile = tuning.bp_plan(139_440, 1000, 8, n_feat, bin_bytes).tile
            assert tile.smem_bytes <= tuning.SMEM_OPTIN_LIMIT
            assert tile.static_bytes == tuning.BP_TRANSPOSE_BYTES \
                + 8 * tuning.BP_ROUND_TREES * 8
            row_bytes = ((n_feat * bin_bytes + 3) // 4 | 1) * 4
            if 32 * row_bytes + tile.static_bytes > tuning.SMEM_OPTIN_LIMIT:
                assert tile.route == "global" and tile.tile_bytes == 0
                continue
            assert tile.route == "shared" and tile.rows == 32
            assert (tile.stride * bin_bytes // 4) % 2 == 1
            assert tile.tile_bytes == 32 * row_bytes
            plan = fused_k.tile_shape(n_feat, bin_bytes == 1, planes=True)
            assert plan.smem_bytes <= tuning.SMEM_OPTIN_LIMIT
            assert plan.static_bytes == tuning.PLANE_BYTES
    # Covertype width: 32 rows of a uint8 pool for the bitpacked kernel
    # (4 blocks an SM), 128 for the plane kernels within 48 KB
    tile = tuning.bp_plan(139_440, 1000, 8, 54, 1).tile
    assert (tile.rows, tile.stride, tile.route) == (32, 60, "shared")
    assert 4 * (tile.smem_bytes + tuning.SMEM_RESERVED_PER_BLOCK) \
        <= tuning.SMEM_PER_SM
    plan = fused_k.tile_shape(54, True, planes=True)
    assert (plan.rows, plan.stride, plan.opt_in) == (128, 60, False)


# --------------------------------------------------------------------------
# The training histogram
# --------------------------------------------------------------------------
def test_histogram_is_a_core_op_of_both_families():
    assert "histogram" in registry.CORE_OPS
    impls = registry.implementations("histogram")
    assert {name: impl.family for name, impl in impls.items()} == \
        {"cuda": "cuda", "torch_ref": "torch_ref"}
    for impl in impls.values():
        assert impl.dtypes == ("int32", "uint8")
        assert impl.layouts == ops.ALL_LAYOUTS
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for dtype in ("uint8", "int32"):
        assert registry.resolve("histogram", "auto", device=cuda,
                                dtype=dtype) == "cuda"
        assert registry.resolve("histogram", "auto", device=cpu,
                                dtype=dtype) == "torch_ref"
    assert ops.KERNELS["histogram"] is hist_k.histogram


def _hist_args(device="cpu", f=3, n=40, c=4):
    rng = np.random.default_rng(1)
    return (torch.from_numpy(rng.integers(0, 6, (f, n)).astype(np.uint8)),
            torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)),
            torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)))


def test_histogram_cuda_family_refuses_cpu_tensors():
    bins_t, leaf, g = _hist_args()
    with pytest.raises(ValueError, match="CPU"):
        ops.histogram(bins_t, leaf, g, n_bins=6, n_leaves=2, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        hist_k.histogram(*(a.to("meta") for a in (bins_t, leaf, g)),
                         n_bins=6, n_leaves=2)
    with pytest.raises(ValueError):
        hist_k.histogram(bins_t.float(), leaf, g, n_bins=6, n_leaves=2)
    with pytest.raises(ValueError):
        hist_k.histogram(bins_t, leaf[:-1], g, n_bins=6, n_leaves=2)


def test_histogram_launch_counter_ticks(monkeypatch):
    bins_t, leaf, g = _hist_args()
    ops.reset_launch_counts()
    launched = []
    monkeypatch.setattr(_build, "check_cuda_tensors", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch",
                        lambda name, device, *a: launched.append((name, a)))
    out = hist_k.histogram(*(a.to("meta") for a in (bins_t, leaf, g)),
                           n_bins=6, n_leaves=2)
    assert out.shape == (3, 12, 4) and out.device.type == "meta"
    name, args = launched[0]
    assert name == "repro_histogram" and len(launched) == 1
    plan = tuning.hist_plan(3, 40, 2, 6, 4)
    assert args[6:] == (40, 3, 6, 2, 4, 1, plan.seg_tile,
                        plan.feats_per_block, plan.row_chunks)
    assert ops.launch_counts() == {k: int(k == "histogram")
                                   for k in ops.KERNELS}


def test_histogram_plan_fits_shared_memory_at_every_level():
    # Covertype width: 54 features, 325,360 rows, 64 bins, 2C = 14
    for d in range(8):
        plan = tuning.hist_plan(54, 325_360, 1 << d, 64, 14)
        assert plan.smem_bytes < 227 * 1024
        assert plan.smem_bytes + tuning.SMEM_RESERVED_PER_BLOCK \
            <= tuning.SMEM_PER_SM                   # one block an SM
        assert plan.tile_bytes == plan.seg_tile * 14 * 8
        assert plan.n_tiles * plan.seg_tile >= (1 << d) * 64
        assert (plan.n_tiles - 1) * plan.seg_tile < (1 << d) * 64
        assert plan.n_blocks >= 0.8 * plan.waves * tuning.SM_COUNT
    assert tuning.hist_plan(54, 325_360, 1, 64, 14).n_tiles == 1
    assert tuning.hist_plan(54, 325_360, 128, 64, 14).n_tiles == 37
    # few rows: one chunk; the widest stats and bins still fit
    assert tuning.hist_plan(54, 17, 128, 64, 14).row_chunks == 1
    assert tuning.hist_plan(1, 10, 1 << 12, 256, 64).smem_bytes \
        < 227 * 1024
    # past 64 stats, one launch a group, the grid planned for the widest
    plan = tuning.hist_plan(54, 100, 2, 64, 65)
    assert plan.stat_groups == ((0, 33), (33, 65))
    assert plan.tile_bytes == plan.seg_tile * 33 * 8
    with pytest.raises(ValueError):
        tuning.hist_plan(54, 100, 2, 64, 0)


# --------------------------------------------------------------------------
# The CUDA histogram's exact function: ref.histogram_fixed
# --------------------------------------------------------------------------
U32 = 2.0 ** -24      # unit roundoff of float32


def _fixed_inputs(n=300, f=3, c=4, n_bins=5, n_leaves=4, seed=5):
    rng = np.random.default_rng(seed)
    bins_t = rng.integers(0, n_bins, (f, n)).astype(np.uint8)
    bins_t[:, rng.random(n) < 0.4] = 0        # a crowded bin, as ReLU gives
    leaf = rng.integers(0, n_leaves, n).astype(np.int32)
    g = rng.normal(size=(n, c)).astype(np.float32)
    return bins_t, leaf, g


def _fixed_limit(bins_t, leaf, g, n_bins, n_leaves):
    """Per cell: the sqrt(n) rule of PERF.md section 2 plus n half-quanta
    of the fixed point, against the f64 sum; plus the f32 sum's own worst
    case (n + 1) u sum|g| against an f32 sum."""
    kw = dict(n_bins=n_bins, n_leaves=n_leaves)
    t = [torch.from_numpy(a) for a in (bins_t, leaf)]
    count = ref.histogram(*t, torch.ones((g.shape[0], 1), dtype=torch.float64),
                          **kw)
    abs_sum = ref.histogram(*t, torch.from_numpy(np.abs(g)).double(), **kw)
    quantum = torch.tensor([2.0 ** -e for e in
                            ref.stat_exponent(torch.from_numpy(g))],
                           dtype=torch.float64)
    lim64 = 8 * count.clamp(min=1).sqrt() * U32 * abs_sum \
        + count * quantum / 2
    return lim64, lim64 + 1.05 * (count + 1) * U32 * abs_sum


def _fixed(bins_t, leaf, g, **kw):
    return ref.histogram_fixed(*(torch.from_numpy(np.ascontiguousarray(a))
                                 for a in (bins_t, leaf, g)), **kw)


@pytest.mark.parametrize("seed", [5, 6])
def test_fixed_histogram_is_order_free(seed):
    bins_t, leaf, g = _fixed_inputs(seed=seed)
    kw = dict(n_bins=5, n_leaves=4)
    want = _fixed(bins_t, leaf, g, **kw)
    perm = np.random.default_rng(seed).permutation(g.shape[0])
    assert torch.equal(_fixed(bins_t[:, perm], leaf[perm], g[perm], **kw),
                       want)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_fixed_histogram_within_rounding_of_f64_and_jax_ref(dtype):
    bins_t, leaf, g = _fixed_inputs()
    bins_t = bins_t.astype(dtype)
    kw = dict(n_bins=5, n_leaves=4)
    got = _fixed(bins_t, leaf, g, **kw).double()
    lim64, lim32 = _fixed_limit(bins_t, leaf, g, **kw)
    f64 = ref.histogram(*(torch.from_numpy(a) for a in (bins_t, leaf)),
                        torch.from_numpy(g).double(), **kw)
    assert bool(((got - f64).abs() <= lim64).all())
    jax_ref = np.array(jhist.histogram_ref(
        jnp.asarray(bins_t), jnp.asarray(leaf), jnp.asarray(g), **kw))
    assert bool(((got - torch.from_numpy(jax_ref).double()).abs()
                 <= lim32).all())


def test_fixed_histogram_keeps_an_all_zero_stat_exact():
    bins_t, leaf, g = _fixed_inputs()
    g[:, 1] = 0.0
    out = _fixed(bins_t, leaf, g, n_bins=5, n_leaves=4)
    assert ref.stat_exponent(torch.from_numpy(g))[1] == 0
    assert bool((out[..., 1] == 0).all())
    assert not bool((out[..., 0] == 0).all())


@pytest.mark.parametrize("n", [256, 255, 1024, 1023])
def test_fixed_histogram_scale_at_and_below_a_power_of_two(n):
    bins_t, leaf, g = _fixed_inputs(n=n)
    e = ref.stat_exponent(torch.from_numpy(g))
    m = np.abs(g).max(axis=0)
    # N < 2^lg and |g| < 2^ex: every partial sum stays below 2^62
    lg = int(n).bit_length()
    assert n < 2 ** lg
    for k, ek in enumerate(e):
        ex = int(np.frexp(m[k])[1])
        assert ek == 62 - lg - ex
        assert n * float(m[k]) * 2.0 ** ek < 2.0 ** 62
    kw = dict(n_bins=5, n_leaves=4)
    got = _fixed(bins_t, leaf, g, **kw).double()
    lim64, _ = _fixed_limit(bins_t, leaf, g, **kw)
    f64 = ref.histogram(*(torch.from_numpy(a) for a in (bins_t, leaf)),
                        torch.from_numpy(g).double(), **kw)
    assert bool(((got - f64).abs() <= lim64).all())


def test_fixed_histogram_multiclass_hessian_floor():
    # MultiClass floors its hessians at 1e-12 beside values near 0.25: the
    # floor is a handful of quanta, kept within n half-quanta of exact
    n = 2000
    rng = np.random.default_rng(9)
    h = np.where(rng.random(n) < 0.5, 1e-12, 0.25).astype(np.float32)
    g = np.stack([rng.normal(size=n).astype(np.float32), h], axis=1)
    bins_t = rng.integers(0, 3, (1, n)).astype(np.uint8)
    leaf = rng.integers(0, 2, n).astype(np.int32)
    kw = dict(n_bins=3, n_leaves=2)
    got = _fixed(bins_t, leaf, g, **kw).double()
    quantum = 2.0 ** -ref.stat_exponent(torch.from_numpy(g))[1]
    assert 1e-12 / quantum > 1.0          # the floor does not round to 0
    lim64, _ = _fixed_limit(bins_t, leaf, g, **kw)
    f64 = ref.histogram(*(torch.from_numpy(a) for a in (bins_t, leaf)),
                        torch.from_numpy(g).double(), **kw)
    assert bool(((got - f64).abs() <= lim64).all())
    # cells of floor hessians only
    only = np.zeros((1, n), np.uint8)
    floor_rows = h == np.float32(1e-12)
    small = _fixed(only[:, floor_rows], leaf[floor_rows], g[floor_rows],
                   **kw).double()[0, :, 1]
    exact = torch.zeros(6, dtype=torch.float64)
    for lf in (0, 1):
        exact[lf * 3] = float(np.float32(1e-12)) * int(
            (leaf[floor_rows] == lf).sum())
    assert bool(((small - exact).abs()
                 <= (exact / float(np.float32(1e-12))) * quantum / 2
                 + 8 * U32 * exact).all())


# --------------------------------------------------------------------------
# The histogram plan at the two shapes and at every stat width
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_stats", [1, 14, 40, 64])
@pytest.mark.parametrize("shape", [(54, 325_360, 8), (533, 2808, 4)])
def test_histogram_plan_fits_the_card(shape, n_stats):
    n_features, n_rows, depth = shape
    for d in list(range(depth)) + [8]:
        n_leaves = 1 << d
        for n_bins in (64, 1):
            plan = tuning.hist_plan(n_features, n_rows, n_leaves, n_bins,
                                    n_stats)
            segs = n_leaves * n_bins
            assert plan.smem_bytes <= tuning.SMEM_OPTIN_LIMIT
            assert plan.block_bytes == plan.feats_per_block * plan.seg_tile \
                * n_stats * tuning.HIST_CELL_BYTES
            assert max(plan.n_groups, plan.n_tiles) <= tuning.GRID_DIM_LIMIT
            assert 1 <= plan.feats_per_block <= \
                tuning.HIST_MAX_FEATS_PER_BLOCK
            assert plan.n_groups == -(-n_features // plan.feats_per_block)
            assert plan.n_tiles * plan.seg_tile >= segs
            assert (plan.n_tiles - 1) * plan.seg_tile < segs
            assert plan.row_chunks == 1 or \
                -(-n_rows // plan.row_chunks) >= tuning.HIST_MIN_CHUNK_ROWS
            tiles = plan.n_groups * plan.n_tiles
            # chunks fill one wave, or balance a feature's several tiles
            limit = tuning.SM_COUNT if plan.n_tiles == 1 else \
                tuning.HIST_BALANCE_WAVES * tuning.SM_COUNT
            assert plan.row_chunks == 1 or (plan.row_chunks - 1) * tiles \
                < limit


def test_histogram_plan_is_the_documented_one():
    def grid(*args):
        plans = [tuning.hist_plan(*args[:2], 1 << d, 64, args[3])
                 for d in range(args[2])]
        return ([p.feats_per_block for p in plans],
                [p.n_tiles for p in plans], [p.row_chunks for p in plans])
    assert grid(54, 325_360, 8, 14) == ([8, 8, 8, 8, 7, 8, 8, 8],
                                        [1, 1, 1, 2, 4, 8, 16, 37],
                                        [18, 18, 18, 38, 33, 19, 10, 5])
    assert grid(533, 2808, 4, 40) == ([5, 5, 8, 8], [1, 1, 3, 7],
                                      [1, 1, 1, 1])
    assert all(tuning.hist_plan(533, 2808, 1 << d, 64, 40).direct
               for d in range(4))


# --------------------------------------------------------------------------
# Binarize: the CUDA kernel's search over sorted border columns
# --------------------------------------------------------------------------
def _search_bins(x, borders):
    """csrc/binarize.cu on sorted columns, vectorized: the number of
    borders `< x` found by a binary search over each column (steps of the
    largest power of two <= B, halving), NaN included."""
    nb = borders.shape[0]
    pos = torch.zeros(x.shape, dtype=torch.int64)
    cols = torch.arange(x.shape[1])[None, :].expand_as(x)
    step = 1 << (nb.bit_length() - 1) if nb else 0
    while step:
        nxt = pos + step
        probe = borders[(nxt - 1).clamp(max=nb - 1), cols]
        pos = torch.where((nxt <= nb) & (probe < x), nxt, pos)
        step >>= 1
    return pos.to(torch.int32)


def _is_sorted(borders):
    return bool((borders[:-1] <= borders[1:]).all()) if len(borders) else True


VALUES = [-np.inf, -2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, np.inf]
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
import hypothesis.strategies as st  # noqa: E402


@st.composite
def _tables(draw):
    """(x, sorted borders): columns of duplicate-prone values drawn from
    VALUES and the normal, each padded with +inf; x drawn from the same
    values, NaN and the borders themselves."""
    n_feat = draw(st.integers(1, 4))
    n_real = draw(st.integers(0, 10))
    pad = draw(st.integers(0, 3))
    value = st.one_of(st.sampled_from(VALUES),
                      st.floats(-3, 3, width=32))
    cols = []
    for _ in range(n_feat):
        col = sorted(draw(st.lists(value, min_size=n_real,
                                   max_size=n_real)))
        cols.append(col + [np.inf] * pad)
    borders = np.array(cols, np.float32).T.reshape(n_real + pad, n_feat)
    pool = VALUES + [np.nan] + [float(v) for v in borders.ravel()]
    n_rows = draw(st.integers(1, 6))
    x = np.array(draw(st.lists(st.sampled_from(pool) | value,
                               min_size=n_rows * n_feat,
                               max_size=n_rows * n_feat)),
                 np.float32).reshape(n_rows, n_feat)
    return torch.from_numpy(x), torch.from_numpy(borders)


@settings(max_examples=150, deadline=None)
@given(_tables())
def test_search_over_sorted_columns_equals_the_count(table):
    x, borders = table
    assert all(_is_sorted(borders[:, f]) for f in range(borders.shape[1]))
    assert torch.equal(_search_bins(x, borders), ref.binarize(x, borders))


def test_search_edge_values():
    borders = torch.tensor([[-1.0, 0.0], [0.0, 0.0], [0.0, 1.0],
                            [2.0, np.inf], [np.inf, np.inf]])
    x = torch.tensor([[np.nan, np.nan], [-np.inf, -np.inf],
                      [np.inf, np.inf], [0.0, 0.0], [-1.0, 1.0],
                      [0.5, 0.5], [2.0, 2.0]])
    want = torch.tensor([[0, 0], [0, 0], [4, 3], [1, 0], [0, 2], [3, 2],
                         [3, 3]], dtype=torch.int32)
    assert torch.equal(ref.binarize(x, borders), want)
    assert torch.equal(_search_bins(x, borders), want)


def test_unsorted_column_is_still_counted():
    # the search would miscount a shuffled column; the plain version (and
    # the kernel's compare loop for such a column) count every border
    borders = torch.tensor([[2.0], [-1.0], [0.5], [1.0], [-2.0]])
    x = torch.tensor([[0.75], [1.5], [-1.5], [np.nan], [3.0]])
    want = (x[:, None, :] > borders[None]).sum(1).to(torch.int32)
    assert torch.equal(ref.binarize(x, borders), want)
    assert torch.equal(want[:, 0], torch.tensor([3, 4, 1, 0, 5],
                                                dtype=torch.int32))
    assert not _is_sorted(borders[:, 0])
    assert not torch.equal(_search_bins(x, borders), want)


def test_binarize_wrapper_passes_any_border_count(monkeypatch):
    # a table past a block's shared memory goes to the kernel too (read
    # from global memory there), not to a refusal
    launched = []
    monkeypatch.setattr(_build, "check_cuda_tensors", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch",
                        lambda name, device, *a: launched.append((name, a)))
    monkeypatch.setattr(binarize_k.binarize, "launches", 0)
    x = torch.zeros((2, 3), device="meta")
    out = binarize_k.binarize(x, torch.zeros((60_000, 3), device="meta"))
    assert out.shape == (2, 3) and out.dtype == torch.int32
    assert [(n, a[3:]) for n, a in launched] == [
        ("repro_binarize", (2, 3, 60_000, 0))]
    assert binarize_k.binarize.launches == 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the binarize and histogram kernels "
                    "have no CPU mode (chip_smoke.py holds them on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_redesigned_kernels_on_the_card(card):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1000, 6)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    borders = np.sort(rng.normal(size=(9, 6)), 0).astype(np.float32)
    borders[-2:, 1] = np.inf
    borders[3, 2] = borders[2, 2]                  # a duplicate border
    borders[:, 3] = rng.permutation(borders[:, 3])  # an unsorted column
    x[:9, 2] = borders[:, 2]                       # values equal to borders
    xt, bt = torch.from_numpy(x), torch.from_numpy(borders)
    # the whole table, a slice one row in (unaligned, 5,994 elements: a
    # tail after the 4-element steps), and a table past shared memory
    wide = torch.from_numpy(np.sort(rng.normal(size=(300, 900)), 0)
                            .astype(np.float32))
    cases = [(xt, bt), (xt[1:], bt), (xt[:5].repeat(1, 150), wide)]
    for dtype, plain in ((torch.uint8, ref.binarize_u8),
                         (torch.int32, ref.binarize)):
        for xc, bc in cases:
            if dtype == torch.uint8 and bc.shape[0] > ref.MAX_U8_BORDERS:
                continue
            got = binarize_k.binarize(xc.to(card), bc.to(card),
                                      out_dtype=dtype)
            assert torch.equal(got.cpu(), plain(xc, bc))
    bins_t, leaf, g = _fixed_inputs(n=5000)
    args = [torch.from_numpy(a).to(card) for a in (bins_t, leaf, g)]
    got = hist_k.histogram(*args, n_bins=5, n_leaves=4)
    assert torch.equal(got.cpu(), _fixed(bins_t, leaf, g, n_bins=5,
                                         n_leaves=4))

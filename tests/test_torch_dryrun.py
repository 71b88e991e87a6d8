"""The port's dry-run, roofline, perf and report launchers
(`repro_torch.launch.{hlo_analysis,dryrun,dryrun_gbdt,roofline,perf,
report}`) against the JAX package's, on the CPU.

JAX's `dryrun`, `dryrun_gbdt` and `perf` set XLA_FLAGS when imported:
`dryrun` is read in a subprocess, `perf` imported with the variable put
back after.  Every fake process group (`runtime.fake_group`) is left
before its test ends, and every output goes under `tmp_path`.  Exact
unless a tolerance is named:

  * the cell list, every cell's `input_specs` (names, shapes, dtypes) and
    `model_flops` equal JAX's, all 33 cells in one JAX subprocess;
  * `roofline.render` / `_fmt_s` equal JAX's byte for byte on ok, error
    and missing cells;
  * `collective_bytes` on a fake 4-rank group: an S(0) -> R redistribute
    of f32[128, 256] (131,072 B of all-gather), a `dist.all_reduce`, one
    ring step (collective-permute) and a Shard(0) -> Shard(1) all-to-all,
    as tests/test_sharding.py:99-116 counts JAX's;
  * a DTensor product sharded four ways counts a quarter of the one-device
    FLOPs and bytes;
  * the launch costs reproduce PERF.md's Bound column at its shapes;
  * a smoke config's train, prefill and decode cells trace to ok on a
    fake (2, 2) group, `argument_bytes` the local shards' bytes;
  * `dryrun_gbdt` at a reduced size traces to ok with the plan's launches;
    its shard function on the plain versions equals JAX's `ref` chain
    summed over the model shards (bins and leaf indexes exact, raw within
    rtol = atol = 1e-4);
  * `perf.CELLS` names, variants and overrides equal JAX's; the
    `gbdt-predict` modes agree on the CPU with one another and with JAX's
    `raw_predict` within 1e-4;
  * `report` renders from a temporary results directory with no TPU
    constant in its output.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.core import predict as jpredict  # noqa: E402
from repro.core import trees as jtrees  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.analysis import trace_tools as tt  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.predictor import Predictor  # noqa: E402
from repro_torch.distributed import collectives, runtime  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import dryrun, dryrun_gbdt  # noqa: E402
from repro_torch.launch import hlo_analysis as hlo  # noqa: E402
from repro_torch.launch import perf, report, roofline  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.training import optimizer as opt_lib  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE_SHAPES = {"train": ShapeConfig("train_4k", 64, 8, "train"),
                "prefill": ShapeConfig("prefill_32k", 64, 4, "prefill"),
                "decode": ShapeConfig("decode_32k", 64, 8, "decode")}

JAX_CELLS = r"""
import json
from repro import configs
from repro.configs.base import SHAPES, applicable_shapes
from repro.launch import dryrun
out = []
for arch, cfg in configs.ARCHS.items():
    for shp in applicable_shapes(cfg):
        shape = SHAPES[shp]
        n = cfg.active_param_count()
        mf = (6 * n * shape.tokens if shape.kind == "train" else
              2 * n * shape.tokens if shape.kind == "prefill" else
              2 * n * shape.global_batch)
        specs = {k: [list(v.shape), str(v.dtype)]
                 for k, v in dryrun.input_specs(arch, shp).items()}
        out.append([arch, shp, specs, mf])
print(json.dumps(out))
"""


def test_cells_input_specs_and_model_flops_match_jax():
    out = subprocess.run([sys.executable, "-c", JAX_CELLS], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                              "JAX_PLATFORMS": "cpu"},
                         capture_output=True, text=True, check=True)
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = []
    for arch, shp in dryrun.all_cells():
        specs = {k: [list(v.shape), tt.dtype_name(v.dtype)]
                 for k, v in dryrun.input_specs(arch, shp).items()}
        got.append([arch, shp, specs, dryrun.model_flops(
            configs.get(arch), dryrun.SHAPES[shp])])
    assert len(got) == 33
    assert got == want


def _cells():
    ok = {"arch": "glm4-9b", "shape": "train_4k", "status": "ok",
          "compute_s": 0.1234, "memory_s": 2.5e-4, "collective_s": 3e-7,
          "dominant": "compute_s", "useful_flops_ratio": 0.6789,
          "roofline_fraction": 0.01234}
    tiny = dict(ok, shape="decode_32k", compute_s=5e-5, memory_s=0.05,
                collective_s=0.0, dominant="memory_s",
                useful_flops_ratio=0.001, roofline_fraction=0.0)
    err = {"arch": "kimi-k2-1t-a32b", "shape": "train_4k",
           "status": "error", "error": "ValueError: " + "x" * 80}
    missing = {"arch": "whisper-small", "shape": "decode_32k",
               "status": "missing"}
    return [ok, tiny, err, missing]


def test_roofline_render_matches_jax_byte_for_byte():
    cells = _cells()
    for markdown in (True, False):
        assert roofline.render(cells, markdown) == \
            jroofline.render(cells, markdown)
    for x in (None, 0.0, 5e-7, 1e-4, 0.05, 0.1, 12.5):
        assert roofline._fmt_s(x) == jroofline._fmt_s(x)


def test_roofline_load_cells_reads_the_ports_directory(tmp_path):
    cell = dict(_cells()[0], arch="glm4-9b", shape="decode_32k")
    (tmp_path / "glm4-9b__decode_32k__singlepod.json").write_text(
        json.dumps(cell))
    cells = roofline.load_cells(False, tmp_path)
    assert len(cells) == 33
    assert [c for c in cells if c["status"] == "ok"] == [cell]
    assert roofline.RESULTS.name == "dryrun_torch"


def test_collective_bytes_on_a_fake_group():
    from torch.distributed.tensor import placement_types as pt
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    patched = (ShardingPropagator._propagate_tensor_meta_non_cached,
               pt.shard_dim_alltoall)
    with runtime.fake_group(4) as dev:
        mesh = dryrun.make_dry_mesh((1, 4), ("data", "model"), dev)
        dm = runtime.device_mesh(mesh)
        with tt.new_fake_mode(), tt._FakeDeviceMode():
            a = dryrun.fake_leaf((128, 256), torch.float32,
                                 shd.P("model"), dm, dev)
            b = dryrun.fake_leaf((128, 256), torch.float32,
                                 shd.P("model"), dm, dev)
            axis = collectives._Axis(mesh, "model")
            x = torch.empty((32, 16), device=dev)
            t = torch.empty((64,), device=dev)
            with hlo.counting() as counter:
                a.redistribute(dm, [Replicate(), Replicate()])
                gathered = dict(counter.coll)
                dist.all_reduce(t, group=axis.group)
                axis.shift(x)
                b.redistribute(dm, [Replicate(), Shard(1)])
    assert not dist.is_initialized()
    # DTensor is put back as it was
    assert (ShardingPropagator._propagate_tensor_meta_non_cached,
            pt.shard_dim_alltoall) == patched
    assert gathered["all-gather"] == 128 * 256 * 4 == 131072
    assert hlo.collective_bytes(counter.coll) == {
        "all-gather": 131072, "all-reduce": 64 * 4,
        "collective-permute": 32 * 16 * 4, "all-to-all": 128 * 64 * 4,
        "total": 131072 + 256 + 2048 + 32768}
    assert counter.coll_calls == {
        "all-gather": 1, "all-reduce": 1, "reduce-scatter": 0,
        "all-to-all": 1, "collective-permute": 1}


def test_a_product_sharded_four_ways_counts_a_quarter():
    shape_a, shape_b = (8, 64, 32), (8, 32, 16)
    with tt.new_fake_mode():
        a, b = torch.empty(shape_a), torch.empty(shape_b)
        with hlo.counting() as whole:
            torch.bmm(a, b)
    with runtime.fake_group(4) as dev:
        mesh = dryrun.make_dry_mesh((4,), ("data",), dev)
        dm = runtime.device_mesh(mesh)
        with tt.new_fake_mode(), tt._FakeDeviceMode():
            da = dryrun.fake_leaf(shape_a, torch.float32, shd.P("data"),
                                  dm, dev)
            db = dryrun.fake_leaf(shape_b, torch.float32, shd.P("data"),
                                  dm, dev)
            with hlo.counting() as local:
                out = torch.bmm(da, db)
            assert out.placements == (Shard(0),)
    assert whole.flops == 2 * 8 * 64 * 32 * 16
    assert local.flops * 4 == whole.flops
    assert local.bytes * 4 == whole.bytes
    assert local.coll == hlo.empty_collectives()


def _launches(fn, *specs, **kwargs):
    return tt.trace_abstract(fn, *specs, **kwargs).launches()


def _bound(fn, *specs, **kwargs) -> list[dict]:
    return [hlo.launch_cost(e.record) for e in _launches(fn, *specs,
                                                         **kwargs)]


def test_launch_costs_reproduce_the_bound_column():
    """PERF.md §6 at 139,440 rows x 1,000 trees of depth 8, 54 features,
    63 borders, 7 classes (rows 1-8), 325,360 rows a tree of 8 levels of
    64 bins (row 9), a 2,808 x 512 query (row 10), 2,841 x 2,808 x 512
    (row 11), printed to four digits.  A value's bin costs a binary
    search's ceil(log2(64)) = 6 compares (`hlo_analysis.compares`)."""
    from repro_torch.kernels import binarize, fused_predict, histogram
    from repro_torch.kernels import l2dist, leaf_gather, leaf_index
    spec = tt.Spec
    n, f, nb, t, d, c = 139_440, 54, 63, 1000, 8, 7
    x = spec((n, f), torch.float32, "cuda")
    borders = spec((nb, f), torch.float32, "cuda")
    bins = spec((n, f), torch.uint8, "cuda")
    sf = spec((t, d), torch.int32, "cuda")
    lv = spec((t, 1 << d, c), torch.float32, "cuda")
    idx = spec((n, t), torch.int32, "cuda")

    def ms(rows):
        assert len(rows) == 1
        return float(f"{rows[0]['bound_ms']:.4g}"), rows[0]["bound_by"]

    assert ms(_bound(binarize.binarize, x, borders,
                     out_dtype=torch.uint8)) == (0.01124, "bytes")
    assert ms(_bound(leaf_index.leaf_index, bins, sf, sf)) == \
        (0.1688, "bytes")
    planes = spec((d, t), torch.int32, "cuda")
    pow2 = spec((d, 1), torch.float32, "cuda")
    assert ms(_bound(leaf_index.leaf_index_dm, bins, planes, planes,
                     pow2)) == (0.1688, "bytes")
    assert ms(_bound(fused_predict.fused_predict_dm, x, borders, planes,
                     planes, pow2, lv)) == (0.03189, "operations")
    # the whole leaf table: above the row's 0.1685 (the rows touched)
    gather = _bound(leaf_gather.leaf_gather, idx, lv)[0]
    assert f"{gather['bound_ms']:.4g}" == "0.1698"
    touched = gather["bytes"] - t * (1 << d) * c * 4 + 100_000 * c * 4
    assert f"{touched / hlo.HBM_BW * 1e3:.4g}" == "0.1685"
    assert ms(_bound(fused_predict.fused_predict, x, borders, sf, sf,
                     lv)) == (0.03189, "operations")
    # row 9: one tree, a launch a level
    rows = 325_360
    per_tree = 0.0
    for level in range(d):
        per_tree += _bound(
            histogram.histogram, spec((f, rows), torch.uint8, "cuda"),
            spec((rows,), torch.int32, "cuda"),
            spec((rows, 2 * c), torch.float32, "cuda"), n_bins=64,
            n_leaves=1 << level)[0]["bound_ms"]
    assert f"{per_tree:.4g}" == "0.1033"
    rowwise = _bound(l2dist.l2sq_rowwise, spec((512,), torch.float32,
                                               "cuda"),
                     spec((2808, 512), torch.float32, "cuda"))
    assert f"{rowwise[0]['bound_ms']:.3g}" == "0.00172"
    assert rowwise[0]["bound_by"] == "bytes"
    matrix = _bound(l2dist.l2sq_matrix, spec((2841, 512), torch.float32,
                                             "cuda"),
                    spec((2808, 512), torch.float32, "cuda"))
    assert [r["name"] for r in matrix] == ["repro_l2sq_split",
                                           "repro_l2sq_matrix"]
    assert ms(matrix[1:]) == (0.0165, "operations")


def test_the_bins_cost_a_binary_search_at_the_predict_1m_shard():
    """A value's bin among n sorted borders costs ceil(log2(n + 1))
    compares; the predict-1m shard's launches (65,536 rows, 625 trees,
    255 borders) count 8 a value, and its cell prices them at the fp32
    rate, as the launch bound does."""
    assert [hlo.compares(n) for n in (1, 2, 3, 63, 64, 255, 256)] == \
        [1, 2, 2, 6, 7, 8, 9]
    traced = dryrun_gbdt.trace_predict(False)
    rows, trees = traced["rows"], traced["trees"]
    ops = sum(r["ops"] for r in traced["costs"]["launches"])
    assert ops == rows * (54 * 8 + trees * 8 + trees * 7)
    assert traced["costs"]["flops"] == ops      # no aten op is a product
    res = dryrun_gbdt.analyze("predict-1m", False)
    assert res["compute_s"] == ops / hlo.FP32_FLOPS
    assert res["kernel_bound_s"] == pytest.approx(res["compute_s"])


def _expected_local_bytes(tree, spec_tree, mesh_sizes: dict) -> int:
    """Rank 0's shard bytes of every leaf, from the specs alone: each
    sharded dim cut to ceil(size / axis size), axis by axis."""
    if isinstance(tree, dict):
        return sum(_expected_local_bytes(
            v, spec_tree[k] if isinstance(spec_tree, dict) else spec_tree,
            mesh_sizes) for k, v in tree.items())
    shape = list(tree.shape)
    spec = shd.fit_specs(spec_tree, torch.empty(shape, device="meta"),
                         _SizesMesh(mesh_sizes))
    for dim, part in enumerate(spec):
        for axis in (part if isinstance(part, tuple) else (part,)):
            if axis is not None:
                shape[dim] = -(-shape[dim] // mesh_sizes[axis])
    return math.prod(shape) * tree.dtype.itemsize


@dataclasses.dataclass
class _SizesMesh:
    sizes: dict

    @property
    def shape(self):
        return self.sizes

    @property
    def axis_names(self):
        return tuple(self.sizes)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_cells_trace_on_a_fake_2x2_group(kind):
    cfg = configs.get("glm4-9b", smoke=True)
    shape = SMOKE_SHAPES[kind]
    res = dryrun.cell_record("glm4-9b", cfg, shape, False, dryrun.trace_cell(
        cfg, shape, (2, 2), ("data", "model")))
    assert not dist.is_initialized()
    assert res["status"] == "ok" and res["n_devices"] == 4
    assert res["mesh"] == [2, 2] and res["depth"] == dryrun.DEPTH
    assert res["flops_per_device"] > 0 and res["bytes_per_device"] > 0
    assert res["collective_bytes"]["total"] == sum(
        v for k, v in res["collective_bytes"].items() if k != "total")
    sizes = {"data": 2, "model": 2}
    mesh = _SizesMesh(sizes)
    p_abs = tf.abstract_params(cfg, max_positions=shape.seq_len)
    p_specs = shd.param_specs(cfg, mesh, max_positions=shape.seq_len)
    want = _expected_local_bytes(p_abs, p_specs, sizes)
    b_specs = shd.batch_specs(cfg, shape, mesh)
    inputs = dryrun._input_specs(cfg, shape)
    if kind == "decode":
        cache = tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                              abstract=True)
        want += _expected_local_bytes(
            cache, shd.cache_specs(cfg, shape, mesh), sizes)
        inputs = {"tokens": inputs["tokens"]}
    if kind == "train":
        opt = opt_lib.make(cfg)
        want += _expected_local_bytes(
            opt.init(p_abs), shd.opt_state_specs(p_specs, opt.kind), sizes)
    want += sum(_expected_local_bytes(v, b_specs.get(k, b_specs["tokens"]),
                                      sizes) for k, v in inputs.items())
    assert res["memory_analysis"]["argument_bytes"] == want


@pytest.fixture
def reduced_gbdt(monkeypatch, tmp_path):
    """dryrun_gbdt at 4,096 rows and 160 trees (16 rows and 10 trees a
    single-pod device), results under tmp_path."""
    monkeypatch.setattr(dryrun_gbdt, "N_ROWS", 4096)
    monkeypatch.setattr(dryrun_gbdt, "N_TREES", 160)
    monkeypatch.setattr(dryrun_gbdt, "RESULTS", tmp_path)
    return dryrun_gbdt


def test_dryrun_gbdt_traces_at_a_reduced_size(reduced_gbdt):
    mod = reduced_gbdt
    assert mod.shard_shape(False) == (256, 10, 256)
    assert mod.shard_shape(True) == (128, 10, 512)
    res = mod.run_cell("predict-1m", False, force=True)
    assert res["status"] == "ok"
    assert mod.cell_path("predict-1m", False).exists()
    assert res["collective_bytes"] == {"all-reduce": 256 * 7 * 4,
                                       "total": 256 * 7 * 4}
    # the launches are the plan's on a fake card, costed from the shapes
    plan = __import__("repro_torch.analysis.checker", fromlist=["x"]) \
        .fake_cuda_plan(mod.random_ensemble(10), tt.new_fake_mode())
    trace = plan.trace_entries((256,), ("raw",))["raw@256"]
    want = [hlo.launch_shapes(e.record) for e in trace.launches()]
    assert want and [r["name"] for r in res["launches"]] == \
        [w[0] for w in want]
    assert [r["shapes"] for r in res["launches"]] == \
        [[list(s) for _, s in w[1]] for w in want]
    assert res["flops_per_device"] == sum(r["ops"] for r in res["launches"])
    train = mod.run_cell("train-iter", True, force=True)
    assert train["status"] == "ok"
    assert train["collective_calls"] == {"all-reduce": mod.DEPTH + 1}
    level = 54 * 256 * mod.MAX_BINS * 14 * 4
    assert train["collective_bytes"]["all-reduce"] == \
        mod.DEPTH * level + 256 * 14 * 4


def test_dryrun_gbdt_shard_function_matches_jax_ref_chain(reduced_gbdt):
    mod = reduced_gbdt
    rows, trees, _ = mod.shard_shape(False)
    n_shards = 4
    ens = mod.random_ensemble(trees * n_shards)
    arrays = convert.ensemble_to_numpy(ens)
    x = mod.random_rows(rows)
    xt = torch.from_numpy(x)
    total = torch.zeros((rows, mod.N_CLASSES))
    want = np.zeros((rows, mod.N_CLASSES), np.float32)
    jborders = jnp.asarray(arrays["borders"])
    jbins = jref.binarize(jnp.asarray(x), jborders)
    bins = ref.binarize(xt, ens.borders)
    assert np.array_equal(bins.numpy(), np.asarray(jbins))
    for s in range(n_shards):
        cut = slice(s * trees, (s + 1) * trees)
        shard = convert.ensemble_from_numpy({
            k: (v[cut] if k in ("split_features", "split_bins",
                                "leaf_values") else v)
            for k, v in arrays.items()})
        # the shard function: the tree shard's serving plan
        total += Predictor.build(shard, device="cpu").raw(xt)
        jidx = jref.leaf_index(jbins, jnp.asarray(arrays["split_features"]
                                                  [cut]),
                               jnp.asarray(arrays["split_bins"][cut]))
        idx = ref.leaf_index(bins, shard.split_features, shard.split_bins)
        assert np.array_equal(idx.numpy(), np.asarray(jidx))
        want += np.asarray(jref.leaf_gather(
            jidx, jnp.asarray(arrays["leaf_values"][cut])))
    np.testing.assert_allclose(total.numpy(), want, rtol=1e-4, atol=1e-4)


def test_perf_cells_match_jax():
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import perf as jperf
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    assert list(perf.CELLS) == list(jperf.CELLS)
    for name, spec in perf.CELLS.items():
        jspec = jperf.CELLS[name]
        assert {k: v for k, v in spec.items() if k != "variants"} == \
            {k: v for k, v in jspec.items() if k != "variants"}
        assert [(v, o) for v, o, _ in spec["variants"]] == \
            [(v, o) for v, o, _ in jspec["variants"]]
    text = " ".join(h for spec in perf.CELLS.values()
                    for _, _, h in spec["variants"])
    assert "v5e" not in text and "GB/dev" not in text


def test_gbdt_predict_modes_agree_with_each_other_and_jax():
    ens, x = perf.gbdt_workload("cpu")
    outs = {}
    for name, overrides, _ in perf.CELLS["gbdt-predict"]["variants"]:
        outs[name] = perf.gbdt_predict_fn(ens, x, overrides, "cpu")(x)
    jens = jtrees.ObliviousEnsemble(**{
        k: jnp.asarray(v) for k, v in convert.ensemble_to_numpy(ens).items()})
    want = np.asarray(jpredict.raw_predict(jens, jnp.asarray(x.numpy()),
                                           strategy="staged", backend="ref"))
    for name, got in outs.items():
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(got.numpy(), outs["kwarg-path"].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    res = perf._run_gbdt_variant({"mode": "pool"}, "cpu", (ens, x))
    assert res["status"] == "ok" and res["batch"] == 256
    assert res["device"] == "cpu" and res["us_per_call"] > 0


def test_report_renders_without_tpu_constants(tmp_path):
    dry = tmp_path / "dryrun_torch"
    dry.mkdir()
    cells = [dict(c, trace_seconds=1.5, ops_per_device=10,
                  memory_analysis={"argument_bytes": 2 ** 30},
                  collective_bytes={"all-gather": 5, "total": 5},
                  flops_per_device=1.0) for c in _cells()[:2]] + \
        _cells()[2:]
    for c in cells[:3]:
        (dry / f"{c['arch']}__{c['shape']}__singlepod.json").write_text(
            json.dumps(c))
    (dry / "gbdt-predict-1m__paper__singlepod.json").write_text(json.dumps(
        {"status": "ok", "compute_s": 1e-6, "memory_s": 7e-6,
         "collective_s": 1e-8, "useful_flops_ratio": 0.4,
         "launches": [{"name": "repro_fused_predict"}]}))
    perf_dir = tmp_path / "perf_torch"
    perf_dir.mkdir()
    (perf_dir / "gbdt-predict__prepared-plan.json").write_text(json.dumps(
        {"status": "ok", "us_per_call": 12.5, "batch": 256,
         "device": "NVIDIA H100 80GB HBM3"}))
    (perf_dir / "internlm2-decode__baseline.json").write_text(json.dumps(
        dict(cells[0], variant="baseline")))
    text = report.render(tmp_path, "NVIDIA H100 80GB HBM3, 700.00 W",
                         80 * 2 ** 30)
    assert "| glm4-9b | train_4k | ok | 1.5s | 10 | 1.0GB |" in text
    assert "ERROR" in text and "MISSING" in text
    assert "fused_predict" in text and "12.5" in text
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in text
    assert "989 TFLOP/s" in text and "3.35 TB/s" in text
    for tpu in ("TPU", "v5e", "197 TFLOP", "819 GB", "16 GB", "ICI"):
        assert tpu not in text, tpu
    assert "not measured" in report.render(tmp_path)

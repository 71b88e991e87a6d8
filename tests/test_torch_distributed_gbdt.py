"""The port's multi-device slice against the JAX package's, on the CPU.

The port's counterparts of `tests/test_distributed_gbdt.py` (all but its
two shard-parity lint tests, which belong to the contract checker) and
of `tests/test_distributed.py::test_sharded_gbdt_predict_psum`.  A mesh
of the port may name one device several times (logical shards), so every
case here runs a 4-shard mesh on "cpu" in this process; JAX's own
sharded path runs in a subprocess on 4 forced host devices.

Contracts:

* row-sharded pool / float / ragged scores equal the port's
  single-device plan bit for bit on all four layouts, with zero binarize
  dispatches on the pool route; against the JAX package's single-device
  `ref` plan (which sums trees in another order than the port's plain
  versions) and its sharded path they agree within 1e-6 of the raw
  scale, the rule JAX's own test gives its tree-sharded sums;
* tree sharding stays within that rule, the (2, 2) hybrid mesh within
  1e-4;
* `shard_trees` pads with neutral trees, `best_shard_axis` and
  `shard_count` decide as JAX's, `replica_submeshes` validates as JAX's;
* replicas round-robin and `predict_multi` quantizes once per schema;
* `GBDTServer(mesh=)` and `BulkScorer(mesh=)` equal their single-device
  selves bit for bit; the `sharded/*` span and `compile/sharded_*`
  instants carry JAX's names and attributes; a shard's launches carry
  its device index.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.compat import make_mesh as jmake_mesh  # noqa: E402
from repro.core import layout as jlayout  # noqa: E402
from repro.core import predict as jpredict  # noqa: E402
from repro.core.predictor import Predictor as JPredictor  # noqa: E402
from repro.core.trees import ObliviousEnsemble as JEnsemble  # noqa: E402
from repro.distributed.gbdt import \
    replica_submeshes as jreplica_submeshes  # noqa: E402
from repro.kernels import tuning as jtuning  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.scoring.scorer import ScoringMetrics as JScoringMetrics  # noqa
from repro_torch import convert  # noqa: E402
from repro_torch.core import boosting, losses, predict  # noqa: E402
from repro_torch.core import layout as tlayout  # noqa: E402
from repro_torch.core.predictor import (PredictConfig,  # noqa: E402
                                        Predictor)
from repro_torch.distributed.gbdt import replica_submeshes  # noqa: E402
from repro_torch.core.quantize import QuantizedPool  # noqa: E402
from repro_torch.distributed.mesh import Mesh, make_mesh  # noqa: E402
from repro_torch.kernels import _build, registry, tuning  # noqa: E402
from repro_torch.kernels.ops import PAD_SPLIT_BIN  # noqa: E402
from repro_torch.launch.mesh import (make_local_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.obs.trace import get_tracer, tracing  # noqa: E402
from repro_torch.scoring import (ArraySink, ArraySource,  # noqa: E402
                                 BulkScorer, ScoreConfig, ScoringMetrics)
from repro_torch.serving.engine import (GBDTServer,  # noqa: E402
                                        ModelRegistry, ReplicaGroup)
from repro_torch.serving.metrics import (PercentileReservoir,  # noqa: E402
                                         ServerMetrics)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = ("soa", "depth_major", "depth_grouped", "bitpacked")
FIELDS = ("split_features", "split_bins", "leaf_values", "borders",
          "n_borders", "base_score")


def _arrays(T, D, F, B, C, seed=0):
    """The JAX test's `make_ens` as numpy: mixed true depths 2..D."""
    rng = np.random.default_rng(seed)
    depths = rng.integers(2, D + 1, size=T)
    sf = rng.integers(0, F, size=(T, D)).astype(np.int32)
    sb = rng.integers(1, B + 1, size=(T, D)).astype(np.int32)
    for t in range(T):
        sb[t, depths[t]:] = PAD_SPLIT_BIN
    lv = rng.normal(size=(T, 1 << D, C)).astype(np.float32)
    borders = np.sort(rng.normal(size=(B, F)).astype(np.float32), axis=0)
    return {"split_features": sf, "split_bins": sb, "leaf_values": lv,
            "borders": borders, "n_borders": np.full((F,), B, np.int32),
            "base_score": rng.normal(scale=0.1, size=C).astype(np.float32)}


def _jens(a):
    return JEnsemble(*(jnp.asarray(a[k]) for k in FIELDS))


def _x(n, f, seed=7):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(
        np.float32)


def _tol(want):
    # JAX's tree-sharded rule: 1e-6 of the raw scale, four times over
    return 1e-6 * max(float(np.abs(np.asarray(want)).max()), 1.0) * 4


def _binarize_calls():
    return sum(v for k, v in registry.call_stats().items()
               if k.startswith("binarize"))


@pytest.fixture(scope="module")
def small():
    """30 trees of depth <= 5, F = 20, 60 borders, C = 3; 136 rows."""
    a = _arrays(30, 5, 20, 60, 3)
    return a, convert.ensemble_from_numpy(a), _x(136, 20)


@pytest.fixture(scope="module")
def mesh4():
    return make_local_mesh(4, device="cpu")


# --------------------------------------------------------------------------
# Predictor.sharded: rows, trees, hybrid
# --------------------------------------------------------------------------
@pytest.mark.parametrize("layout", LAYOUTS)
def test_row_sharded_parity_all_layouts(small, mesh4, layout):
    a, ens, x = small
    plan = Predictor.build(ens, device="cpu", strategy="staged",
                           layout=layout)
    pool = plan.quantize(x)
    want_pool, want_float = plan.raw(pool), plan.raw(x)
    fn = plan.sharded(mesh4)
    registry.reset_call_stats()
    got_pool = fn(pool)
    assert _binarize_calls() == 0
    assert torch.equal(got_pool, want_pool)
    assert torch.equal(fn(x), want_float)
    # 131 % 4 != 0: padded to a shardable count and sliced back
    got_uneven = fn(pool.slice_rows(0, 131))
    assert got_uneven.shape[0] == 131
    assert torch.equal(got_uneven, want_pool[:131])
    # fewer rows than shards
    assert torch.equal(fn(x[:2]), want_float[:2])
    assert fn(x[:0]).shape == (0, 3)
    # the JAX package's single-device reference plan
    jplan = JPredictor.build(_jens(a), strategy="staged", backend="ref",
                             layout=layout)
    jraw = np.asarray(jplan.raw(x))
    np.testing.assert_allclose(got_pool.numpy(), jraw, rtol=0,
                               atol=_tol(jraw))
    # a fused plan shards its own fused route, still exact
    fused = Predictor.build(ens, device="cpu", strategy="fused",
                            layout=layout)
    assert torch.equal(fused.sharded(mesh4)(x), fused.raw(x))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tree_sharded_psum_parity(mesh4, layout):
    a = _arrays(256, 5, 20, 60, 3, seed=3)
    ens = convert.ensemble_from_numpy(a)
    x = _x(64, 20, seed=11)
    plan = Predictor.build(ens, device="cpu", strategy="staged",
                           layout=layout)
    pool = plan.quantize(x)
    want = plan.raw(pool).numpy()
    fn = plan.sharded(mesh4, shard_axis="trees")
    registry.reset_call_stats()
    got = fn(pool).numpy()
    assert _binarize_calls() == 0
    gotf = fn(x).numpy()
    tol = _tol(want)
    assert np.abs(got - want).max() <= tol
    assert np.abs(gotf - want).max() <= tol
    jraw = np.asarray(JPredictor.build(_jens(a), strategy="staged",
                                       backend="ref", layout=layout).raw(x))
    assert np.abs(got - jraw).max() <= tol


def test_hybrid_mesh_parity(small):
    a, ens, x = small
    mesh = make_local_mesh(4, model=2, device="cpu")
    assert mesh.shape == {"data": 2, "model": 2}
    jraw = np.asarray(JPredictor.build(_jens(a), strategy="staged",
                                       backend="ref").raw(x))
    for layout in LAYOUTS:
        plan = Predictor.build(ens, device="cpu", strategy="staged",
                               layout=layout)
        got = plan.sharded(mesh)(x[:131]).numpy()
        assert got.shape == (131, 3)
        assert np.abs(got - jraw[:131]).max() < 1e-4, layout


def test_sharded_gbdt_predict_psum():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(256, 12)).astype(np.float32)
    y = (x[:, 0] + x[:, 3] > 0).astype(np.float32)
    ens, _ = boosting.fit(x, y, loss=losses.make_loss("logloss"),
                          params=boosting.BoostingParams(
                              n_trees=16, depth=3, learning_rate=0.3),
                          device="cpu")
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    got = predict.predict_sharded(ens, x[:64], mesh, device="cpu")
    jens = _jens({k: getattr(ens, k).numpy() for k in FIELDS})
    want = np.asarray(jpredict.raw_predict(jens, jnp.asarray(x[:64]),
                                           strategy="staged", backend="ref"))
    assert float(np.abs(got.numpy() - want).max()) < 1e-4


def test_auto_axis_and_first_calls(mesh4):
    a = _arrays(1100, 3, 8, 15, 2, seed=4)
    ens = convert.ensemble_from_numpy(a)
    plan = Predictor.build(ens, device="cpu", strategy="staged",
                           layout="soa")
    fn = plan.sharded(mesh4)
    assert plan.sharded(mesh4) is fn             # cached per closure key
    x = _x(64, 8)
    want = plan.raw(x)
    # 64 rows split 4 ways exactly: rows; 2 rows: the tree axis pads less
    assert tuning.best_shard_axis(64, 1100, mesh4) == "rows"
    assert tuning.best_shard_axis(2, 1100, mesh4) == "trees"
    assert torch.equal(fn(x), want)
    assert np.abs(fn(x[:2]).numpy() - want[:2].numpy()).max() \
        <= _tol(want[:2].numpy())
    fn(x)
    traces = plan.stats["traces"]
    assert traces["sharded_float"] == 2          # one a (mode, shape)
    with pytest.raises(ValueError, match="shard_axis"):
        plan.sharded(mesh4, shard_axis="cols")
    with pytest.raises(ValueError, match="strategy"):
        plan.sharded(mesh4, strategy="eager")
    with pytest.raises(ValueError, match="features"):
        fn(np.zeros((4, 9), np.float32))


def test_sharded_matches_jax_sharded_path(small, tmp_path):
    """JAX's `plan.sharded` on 4 forced host devices, in a subprocess
    (XLA fixes the device count at first use), against the port's."""
    a, ens, x = small
    big = _arrays(256, 5, 20, 60, 3, seed=3)
    np.savez(tmp_path / "in.npz", x=x,
             **{f"a_{k}": v for k, v in a.items()},
             **{f"b_{k}": v for k, v in big.items()})
    body = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = \
            "--xla_force_host_platform_device_count=4"
        import jax.numpy as jnp
        import numpy as np
        from repro.compat import make_mesh
        from repro.core.predictor import Predictor
        from repro.core.trees import ObliviousEnsemble
        FIELDS = {FIELDS!r}
        z = np.load({str(tmp_path / "in.npz")!r})
        x = z["x"]
        def ens(p):
            return ObliviousEnsemble(*(jnp.asarray(z[p + k])
                                       for k in FIELDS))
        mesh = make_mesh((4,), ("data",))
        out = {{}}
        for layout in {LAYOUTS!r}:
            plan = Predictor.build(ens("a_"), strategy="staged",
                                   backend="ref", layout=layout)
            pool = plan.quantize(x)
            fn = plan.sharded(mesh)
            out[layout + "_pool"] = np.asarray(fn(pool))
            out[layout + "_float"] = np.asarray(fn(x))
            out[layout + "_uneven"] = np.asarray(
                fn(pool.slice_rows(0, 131)))
        plan = Predictor.build(ens("b_"), strategy="staged", backend="ref")
        out["trees"] = np.asarray(
            plan.sharded(mesh, shard_axis="trees")(plan.quantize(x[:64])))
        np.savez({str(tmp_path / "out.npz")!r}, **out)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", body], capture_output=True,
                         text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    mesh = make_local_mesh(4, device="cpu")
    for layout in LAYOUTS:
        plan = Predictor.build(ens, device="cpu", strategy="staged",
                               layout=layout)
        fn, pool = plan.sharded(mesh), plan.quantize(x)
        for kind, got in (("pool", fn(pool)), ("float", fn(x)),
                          ("uneven", fn(pool.slice_rows(0, 131)))):
            ref = want[f"{layout}_{kind}"]
            assert got.shape == ref.shape
            assert np.abs(got.numpy() - ref).max() <= _tol(ref), \
                (layout, kind)
    plan = Predictor.build(convert.ensemble_from_numpy(big), device="cpu",
                           strategy="staged")
    got = plan.sharded(mesh, shard_axis="trees")(plan.quantize(x[:64]))
    assert np.abs(got.numpy() - want["trees"]).max() <= _tol(want["trees"])


def test_shard_inputs_feed_sharded_unchanged(small, mesh4):
    _, ens, x = small
    plan = Predictor.build(ens, device="cpu", strategy="staged")
    chunks = predict.shard_inputs(x, mesh4)
    assert [tuple(c.shape) for c in chunks] == [(34, 20)] * 4
    assert all(c.device.type == "cpu" for c in chunks)
    assert torch.equal(plan.sharded(mesh4)(chunks), plan.raw(x))
    # chunks that do not fit the closure's shards are joined and recut
    hybrid = make_local_mesh(4, model=2, device="cpu")
    assert len(predict.shard_inputs(x, hybrid)) == 2
    assert plan.sharded(hybrid)(chunks).shape == (136, 3)
    with pytest.raises(ValueError, match="divide"):
        predict.shard_inputs(x[:131], mesh4)


# --------------------------------------------------------------------------
# shard_trees, stack_tree_shards, unstack_tree_shard
# --------------------------------------------------------------------------
def _tree_arrays(lw):
    """(name, array, tree axis, pad split bin) of each tree-axis array."""
    if isinstance(lw, tlayout.SoaLayout):
        return [("sf", lw.split_features, 0, None),
                ("sb", lw.split_bins, 0, PAD_SPLIT_BIN),
                ("lv", lw.leaf_values, 0, None)]
    if isinstance(lw, tlayout.DepthMajorLayout):
        return [("sf", lw.split_features_dm, 1, None),
                ("sb", lw.split_bins_dm, 1, PAD_SPLIT_BIN),
                ("lv", lw.leaf_values, 0, None)]
    out = []
    for g in lw.groups:
        if isinstance(g, tlayout.DepthGroup):
            out += [("sf", g.split_features, 0, None),
                    ("sb", g.split_bins, 0, PAD_SPLIT_BIN),
                    ("lv", g.leaf_values, 0, None)]
        else:
            pad = 0 if g.split_bins_bp.dtype == torch.uint8 \
                else PAD_SPLIT_BIN
            out += [("sf", g.split_features_bp, 1, None),
                    ("sb", g.split_bins_bp, 1, pad),
                    ("lv", g.leaf_values, 0, None)]
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
def test_shard_trees_shapes_and_neutral_padding(small, layout):
    a, ens, x = small
    plan = Predictor.build(ens, device="cpu", strategy="staged",
                           layout=layout)
    lowered, k = plan.lowered, 4
    shards = tlayout.shard_trees(lowered, k,
                                 t_align=tlayout.STAGED_TREE_ALIGN)
    assert len(shards) == k
    assert tlayout.shard_trees(lowered, 1) == [lowered]
    whole = _tree_arrays(lowered)
    parts = [_tree_arrays(s) for s in shards]
    for i, (name, arr, axis, pad) in enumerate(whole):
        n = arr.shape[axis]
        total, per = tlayout._shard_bounds(n, k, tlayout.STAGED_TREE_ALIGN)
        assert (total, per) == jlayout._shard_bounds(
            n, k, jlayout.STAGED_TREE_ALIGN)
        got = [p[i][1] for p in parts]
        assert all(g.shape == got[0].shape and g.is_contiguous()
                   for g in got)
        assert got[0].shape[axis] == per
        joined = torch.cat(got, dim=axis)
        assert torch.equal(joined.narrow(axis, 0, n), arr)
        tail = joined.narrow(axis, n, total - n)
        fill = 0 if pad is None else pad
        assert bool((tail == fill).all()), (name, fill)
    bins = plan.quantize(x).bins
    want = lowered.leaf_sum(bins, backend="torch_ref").numpy()
    got = sum(s.leaf_sum(bins, backend="torch_ref") for s in shards)
    assert np.abs(got.numpy() - want).max() <= _tol(want)
    # stacking puts a leading shard axis on every array; shard k comes
    # back as it was
    stacked = tlayout.stack_tree_shards(shards)
    for i, (_, arr, _, _) in enumerate(_tree_arrays(stacked)):
        assert arr.shape == (k,) + tuple(parts[0][i][1].shape)
    for j, shard in enumerate(shards):
        back = tlayout.unstack_tree_shard(stacked, j)
        assert type(back) is type(shard)
        for (_, b, _, _), (_, s, _, _) in zip(_tree_arrays(back),
                                              _tree_arrays(shard)):
            assert torch.equal(b, s)
    one = tlayout.stack_tree_shards(shards[:1])
    assert torch.equal(tlayout.unstack_tree_shard(one).borders,
                       lowered.borders)


def test_shard_trees_refuses_a_tree_blocked_plan(small):
    _, ens, _ = small
    plan = Predictor.build(ens, device="cpu", strategy="staged",
                           tree_block=8)
    assert plan.lowered.tree_blocks is not None
    with pytest.raises(ValueError, match="tree-blocked"):
        tlayout.shard_trees(plan.lowered, 2)


# --------------------------------------------------------------------------
# tuning: the shard-axis rule
# --------------------------------------------------------------------------
def test_best_shard_axis_cost_model():
    # serving-sized batches with few trees: rows
    assert tuning.best_shard_axis(16384, 100, 4) == "rows"
    # giant ensemble, tiny batch: trees
    assert tuning.best_shard_axis(2, 4096, 4) == "trees"
    # replicating an enormous leaf table is the tree-shard trigger
    assert tuning.best_shard_axis(
        16384, 8192, 4, leaf_table_bytes=40 << 20) == "trees"
    # a 1-way mesh never tree-shards
    assert tuning.best_shard_axis(2, 8192, 1) == "rows"
    assert (tuning.TREE_SHARD_MIN_TREES,
            tuning.TREE_REPLICATION_BUDGET_BYTES) == (
        jtuning.TREE_SHARD_MIN_TREES, jtuning.TREE_REPLICATION_BUDGET_BYTES)
    for n in (0, 1, 2, 3, 5, 64, 1000, 16384):
        for t in (10, 1023, 1024, 1025, 4096, 8191):
            for k in (1, 2, 3, 4, 8):
                for leaf in (0, 1 << 20, 40 << 20):
                    assert tuning.best_shard_axis(
                        n, t, k, leaf_table_bytes=leaf) == \
                        jtuning.best_shard_axis(n, t, k,
                                                leaf_table_bytes=leaf)
                assert tuning._pad_utilization(n, k) == \
                    jtuning._pad_utilization(n, k)


def test_shard_count_of_meshes():
    jmesh = jmake_mesh((1, 1), ("data", "model"))
    assert tuning.shard_count(make_local_mesh(4, model=2, device="cpu")) \
        == 4
    assert tuning.shard_count(make_mesh((1, 1), ("data", "model"),
                                        devices=["cpu"])) == \
        jtuning.shard_count(jmesh) == 1
    for k in (-1, 0, 1, 7):
        assert tuning.shard_count(k) == jtuning.shard_count(k)


# --------------------------------------------------------------------------
# Meshes and replica groups
# --------------------------------------------------------------------------
def test_mesh_construction(monkeypatch):
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert isinstance(mesh, Mesh)
    assert (mesh.axis_names, mesh.shape, mesh.size) == (
        ("data", "model"), {"data": 2, "model": 2}, 4)
    assert mesh.device_list == [torch.device("cpu")] * 4
    assert mesh.shard_devices(("data",), ("model",)) == \
        [[torch.device("cpu")] * 2] * 2
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="axis names"):
        make_mesh((4,), ("data", "model"), devices=["cpu"] * 4)
    # the shards are dealt round robin over the cards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    local = make_local_mesh(4, model=2)
    assert [str(d) for d in local.device_list] == \
        ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    assert make_local_mesh().shape == {"data": 2, "model": 1}
    assert make_local_mesh(3, device="cuda:1").device_list == \
        [torch.device("cuda", 1)] * 3
    with pytest.raises(ValueError, match="model=2"):
        make_local_mesh(3, model=2, device="cpu")
    # the production layouts, and no invented devices
    with pytest.raises(ValueError, match="256 devices"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 devices"):
        make_production_mesh(multi_pod=True, devices=["cpu"] * 256)
    prod = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}
    assert make_production_mesh(devices=["cpu"] * 256).axis_names == \
        ("data", "model")


def test_replica_submeshes_validation():
    mesh = make_mesh((1,), ("data",), devices=["cpu"])
    subs = replica_submeshes(mesh, 1)
    assert len(subs) == 1 and subs[0].axis_names == ("data",)
    jmesh = jmake_mesh((1,), ("data",))
    for n in (2, 0):
        with pytest.raises(ValueError) as got:
            replica_submeshes(mesh, n)
        with pytest.raises(ValueError) as want:
            jreplica_submeshes(jmesh, n)
        assert str(got.value) == str(want.value)
    four = make_mesh((2, 2), ("data", "model"),
                     devices=["cpu", "meta", "cpu", "meta"])
    halves = replica_submeshes(four, 2)
    assert [(h.axis_names, h.shape) for h in halves] == \
        [(("data",), {"data": 2})] * 2
    assert [str(d) for d in halves[0].device_list] == ["cpu", "meta"]
    assert replica_submeshes(four, 4, axis_name="r")[3].axis_names == \
        ("r",)


def test_registry_replicas_and_predict_multi(mesh4):
    a = _arrays(12, 4, 10, 30, 3, seed=1)
    ens_a = convert.ensemble_from_numpy(a)
    # model b: other trees on the same feature schema (same borders)
    ens_b = dataclasses.replace(
        convert.ensemble_from_numpy(_arrays(12, 4, 10, 30, 3, seed=2)),
        borders=ens_a.borders, n_borders=ens_a.n_borders)
    xs = _x(40, 10, seed=5)
    reg = ModelRegistry(mesh=mesh4, device="cpu")
    try:
        ga = reg.register("a", ens_a, replicas=2)
        gb = reg.register("b", ens_b, replicas=2)
        assert isinstance(ga, ReplicaGroup) and len(ga.servers) == 2
        assert all(s.mesh.size == 2 for s in ga.servers)
        assert ga.mesh is ga.servers[0].mesh
        want_a = Predictor.build(ens_a, device="cpu").proba(xs).numpy()
        want_b = Predictor.build(ens_b, device="cpu").proba(xs).numpy()
        jwant = np.asarray(JPredictor.build(_jens(a), backend="ref")
                           .proba(xs))
        q_cost = []
        for g in (ga, gb):
            registry.reset_call_stats()
            g.quantize(xs)
            q_cost.append(_binarize_calls())
        registry.reset_call_stats()
        out = reg.predict_multi(xs)
        multi_bin = _binarize_calls()
        assert np.array_equal(out["a"], want_a)
        assert np.array_equal(out["b"], want_b)
        assert np.allclose(out["a"], jwant, atol=1e-6)
        # quantized once for the one schema
        assert len({ga.schema_fingerprint, gb.schema_fingerprint}) == 1
        assert multi_bin == q_cost[0] == 1
        for _ in range(4):
            assert np.array_equal(ga.predict_batch(xs), want_a)
        np.testing.assert_allclose(ga.predict(xs[0]), want_a[0],
                                   rtol=1e-6, atol=1e-6)
        batches = [s.metrics.snapshot()["batches"] for s in ga.servers]
        assert all(b > 0 for b in batches)
        m = reg.metrics()
        assert m["a"]["replicas"] == 2 and m["a"]["model"] == "a"
        assert m["a"]["requests"] > 0 and m["a"]["layout"] != "mixed"
        result = gb.score_source(ArraySource(xs), chunk_rows=16)
        assert np.array_equal(result.output, want_b)
        with pytest.raises(ValueError, match="needs a mesh"):
            ModelRegistry(device="cpu").register("r", ens_a, replicas=2)
        with pytest.raises(ValueError, match="equal replica groups"):
            reg.register("c", ens_a, replicas=3)
    finally:
        reg.close()
    assert reg.names() == []


# --------------------------------------------------------------------------
# Metrics merges
# --------------------------------------------------------------------------
def test_percentile_reservoir_merge():
    a = PercentileReservoir(max_samples=64, seed=1)
    b = PercentileReservoir(max_samples=64, seed=2)
    for v in range(100):
        a.add(float(v))
    for v in range(300):
        b.add(1000.0 + v)
    a.merge(b)
    assert a.seen == 400
    assert len(a) <= a.max_samples
    assert a.percentile(50) > 500.0
    with pytest.raises(TypeError):
        a.merge([1.0, 2.0])


def test_server_metrics_merge():
    parts = []
    for i in range(3):
        m = ServerMetrics(f"m/r{i}")
        m.layout = "soa"
        for _ in range(10 * (i + 1)):
            m.note_batch(4, 8, 0.002 * (i + 1))
        parts.append(m)
    merged = ServerMetrics.merge(parts)
    assert merged["replicas"] == 3
    assert merged["requests"] == 4 * (10 + 20 + 30)
    assert merged["batches"] == 60
    assert merged["layout"] == "soa"
    assert merged["pad_overhead"] == pytest.approx(0.5)
    assert merged["batch_p99_ms"] == pytest.approx(6.0, rel=0.2)
    parts[1].layout = "bitpacked"
    assert ServerMetrics.merge(parts)["layout"] == "mixed"
    with pytest.raises(ValueError):
        ServerMetrics.merge([])


def _fill(metrics_cls, i):
    m = metrics_cls(f"w{i}")
    m.start()
    for _ in range(5):
        m.note_chunk(100, 128, 0.01)
    m.note_quantize(0.05)
    m.stop()
    return m


def test_scoring_metrics_merge():
    parts = [_fill(ScoringMetrics, i) for i in range(2)]
    jparts = [_fill(JScoringMetrics, i) for i in range(2)]
    merged = ScoringMetrics.merge(parts)
    jmerged = JScoringMetrics.merge(jparts)
    assert set(merged) == set(jmerged)
    # the host clock's fields aside, the merge is JAX's
    timed = {"wall_s", "rows_per_s", "interval_rows_per_s"}
    assert {k: v for k, v in merged.items() if k not in timed} == \
        pytest.approx({k: v for k, v in jmerged.items() if k not in timed})
    assert merged["rows"] == 1000
    assert merged["chunks"] == 10
    assert merged["quantize_s"] == pytest.approx(0.1)
    assert merged["score_s"] == pytest.approx(0.1)
    # concurrent workers: the fleet's wall is the slowest part's
    assert merged["wall_s"] <= sum(p.snapshot()["wall_s"] for p in parts)
    assert merged["chunk_p50_ms"] == pytest.approx(10.0, rel=0.05)
    with pytest.raises(ValueError):
        ScoringMetrics.merge([])


# --------------------------------------------------------------------------
# Consumers: GBDTServer(mesh=) and BulkScorer(mesh=)
# --------------------------------------------------------------------------
def test_server_with_mesh_equals_local_server(small, mesh4):
    _, ens, x = small
    meshed = GBDTServer(ens, device="cpu", mesh=mesh4, max_batch=64)
    local = GBDTServer(ens, device="cpu", max_batch=64)
    try:
        assert meshed.mesh is mesh4 and local.mesh is None
        assert meshed.metrics.layout == local.metrics.layout
        assert np.array_equal(meshed.predict_batch(x), local.predict_batch(x))
        pool = meshed.quantize(x)
        registry.reset_call_stats()
        assert np.array_equal(meshed.predict_pool(pool),
                              local.predict_pool(pool))
        assert registry.call_stats().get("binarize", 0) == 0
        assert np.array_equal(meshed.predict(x[3]), local.predict(x[3]))
        snap = meshed.metrics.snapshot()
        assert 0 < snap["recompiles"] <= 2 * len(meshed.buckets)
        got = meshed.score_source(ArraySource(x), chunk_rows=32)
        want = local.score_source(ArraySource(x), chunk_rows=32)
        assert np.array_equal(got.output, want.output)
    finally:
        meshed.close()
        local.close()


@pytest.mark.parametrize("output", ["raw", "proba", "classify"])
def test_bulk_scorer_with_mesh_equals_without(small, mesh4, output):
    a, ens, x = small
    plans = {"soa": Predictor.build(ens, device="cpu", layout="soa"),
             "bp": Predictor.build(ens, device="cpu", layout="bitpacked")}
    for prequantize in (True, False):
        for depth in (0, 2):
            cfg = ScoreConfig(chunk_rows=48, output=output,
                              prefetch_depth=depth, prequantize=prequantize)
            want = BulkScorer(plans, cfg).score(ArraySource(x))
            registry.reset_call_stats()
            got = BulkScorer(plans, cfg, mesh=mesh4).score(ArraySource(x))
            # one binarize a chunk (the pool) or a chunk a shard a plan
            n_bin = registry.call_stats().get("binarize", 0)
            assert n_bin == (3 if prequantize else 3 * 4 * 2)
            assert got.chunk_shapes == want.chunk_shapes
            for name in plans:
                assert np.array_equal(got.outputs[name],
                                      want.outputs[name]), name
    # resume lands the remaining chunks where the whole run put them
    sinks = {n: ArraySink() for n in plans}
    cfg = ScoreConfig(chunk_rows=48, output=output)
    whole = BulkScorer(plans, cfg, mesh=mesh4).score(ArraySource(x))
    part = BulkScorer(plans, cfg, mesh=mesh4).score(ArraySource(x), sinks,
                                                    resume_from=1)
    for name in plans:
        assert np.array_equal(part.outputs[name][48:],
                              whole.outputs[name][48:])


def test_mesh_object_fails_as_jax(small):
    _, ens, x = small
    plan = Predictor.build(ens, device="cpu")
    with pytest.raises(AttributeError):
        GBDTServer(ens, device="cpu", mesh=object())
    with pytest.raises(AttributeError):
        BulkScorer(plan, mesh=object()).score(ArraySource(x))


# --------------------------------------------------------------------------
# Trace hooks and device placement
# --------------------------------------------------------------------------
def _sharded_events(events, prefix):
    return {e["name"]: set(e["args"]) for e in events
            if e["name"].startswith(prefix)}


def test_sharded_span_and_instant_match_jax(small):
    a, ens, x = small
    mesh = make_mesh((1,), ("data",), devices=["cpu"])
    plan = Predictor.build(ens, device="cpu", strategy="staged")
    tracer = get_tracer()
    with tracing(tracer, clear=True):
        fn = plan.sharded(mesh)
        fn(plan.quantize(x))
        fn(x)
        events = tracer.events()
    jplan = JPredictor.build(_jens(a), strategy="staged", backend="ref")
    jtracer = jtrace.get_tracer()
    with jtrace.tracing(jtracer, clear=True):
        jfn = jplan.sharded(jmake_mesh((1,), ("data",)))
        jfn(jplan.quantize(x))
        jfn(jnp.asarray(x))
        jevents = jtracer.events()
    for prefix in ("sharded/", "compile/sharded_"):
        got = _sharded_events(events, prefix)
        assert got == _sharded_events(jevents, prefix)
        assert len(got) == 2
    span = next(e for e in events if e["name"] == "sharded/pool")
    assert span["args"] == {"shard_axis": "rows", "devices": 1,
                            "rows": 136, "layout": plan.config.layout}
    inst = next(e for e in events if e["name"] == "compile/sharded_pool")
    assert {k: inst["args"][k] for k in ("shard_mode", "row_shards",
                                         "tree_shards", "batch")} == \
        {"shard_mode": "rows", "row_shards": 1, "tree_shards": 1,
         "batch": 136}


def test_shard_launches_carry_their_device_index(small, monkeypatch):
    """Fake CUDA tensors (meta storage, a device index each) through a
    plan of the cuda family on a 4-card mesh: every launch is recorded
    with the device of the shard that made it, and each shard's plan is
    built for its own device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _, ens, x = small
    made = []
    monkeypatch.setattr(_build, "check_cuda_tensors", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda name, device, *a:
                        made.append((name, device, a[0].device)))
    lowered = tlayout.lower(ens, "soa")
    plan = Predictor(ens, PredictConfig(strategy="staged", backend="cuda",
                                        layout="soa"), lowered,
                     torch.device("cpu"))
    mesh = make_mesh((4,), ("data",),
                     devices=[f"cuda:{i}" for i in range(4)])
    with FakeTensorMode(allow_non_fake_inputs=True):
        bins = torch.zeros((136, 20), dtype=torch.uint8, device="cuda:0")
        out = plan.sharded(mesh)(QuantizedPool(bins,
                                               plan.schema_fingerprint))
        assert out.device == torch.device("cuda", 0)
        assert out.shape == (136, 3)
        rows = [(n, str(d), str(t)) for n, d, t in made]
        made.clear()
        plan.sharded(mesh, shard_axis="trees")(
            QuantizedPool(bins, plan.schema_fingerprint))
        trees = [(n, str(d), str(t)) for n, d, t in made]
    want = [(name, f"cuda:{i}", f"cuda:{i}") for i in range(4)
            for name in ("repro_leaf_index", "repro_leaf_gather")]
    assert [r for r in rows if r[0] in ("repro_leaf_index",
                                        "repro_leaf_gather")] == want
    assert {r[1] for r in trees} == {f"cuda:{i}" for i in range(4)}
    # one copy of the model a distinct device, the plan's own on its own
    assert set(plan._replicas) == {torch.device("cpu")} | {
        torch.device("cuda", i) for i in range(4)}
    assert plan._replicas[torch.device("cpu")] is lowered


def test_launch_on_a_shard_card_keeps_the_current_device(monkeypatch):
    """A launcher selects its card (`cudaSetDevice`) and leaves it
    selected; `_build.launch` and `bind` select the caller's card again,
    so a shard's launch on cuda:3 does not move later `device="cuda"`
    work there."""
    import types

    selected = {"device": 0}

    class Lib:
        def repro_binarize(self, *args):
            selected["device"] = args[-2]          # what cudaSetDevice does
            return 0

    monkeypatch.setattr(_build, "library", Lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: selected["device"])
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: selected.update(device=d))
    _build.launch("repro_binarize", torch.device("cuda", 3), 1, 2)
    assert selected["device"] == 0
    bound = _build.bind("repro_binarize", torch.device("cuda", 2))
    bound(1, 2)
    bound(1, 2)
    assert selected["device"] == 0

"""The port's main-path entry points against the JAX package's, on the CPU.

The one-shot API (`core/predict.py`), CatBoost JSON import
(`load_catboost_json`, `Predictor.from_catboost_json`), the ensemble
helpers (`concat_ensembles`, `empty_ensemble`, `describe_json`, `lower`),
the synthetic datasets (`synthetic.load`), the bulk scorer's chunk planner
(`tuning.best_chunk_rows`) and `GBDTTrainer.fit_source`.  Both packages
get the same numpy-seeded inputs.  Integers, model arrays, dataset arrays,
class ids and splits must be equal; floats within rtol = atol = 1e-4
(`tests/test_differential.py:88`).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import predict as jpredict  # noqa: E402
from repro.core import predictor as jpredictor  # noqa: E402
from repro.core import quantize as jquantize  # noqa: E402
from repro.core import trees as jtrees  # noqa: E402
from repro.core.losses import make_loss as jmake_loss  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.kernels import tuning as jtuning  # noqa: E402
from repro.scoring import sources as jsources  # noqa: E402
from repro.training.gbdt import GBDTTrainer as JTrainer  # noqa: E402
from repro_torch.core import boosting, layout, predict, quantize  # noqa: E402
from repro_torch.core.losses import make_loss  # noqa: E402
from repro_torch.core.predictor import (Predictor,  # noqa: E402
                                        load_catboost_json)
from repro_torch.core.trees import (ObliviousEnsemble,  # noqa: E402
                                    concat_ensembles, empty_ensemble)
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import tuning  # noqa: E402
from repro_torch.kernels.ops import PAD_SPLIT_BIN  # noqa: E402
from repro_torch.scoring import SyntheticSource  # noqa: E402
from repro_torch.training.gbdt import GBDTTrainer  # noqa: E402

torch.set_num_threads(1)

FIELDS = ("split_features", "split_bins", "leaf_values", "borders",
          "n_borders", "base_score")
GRID = settings(max_examples=200, deadline=None)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def _arrays(seed=1, n_trees=9, depth=4, n_features=7, n_borders=9,
            n_outputs=3):
    rng = np.random.default_rng(seed)
    return {
        "split_features": rng.integers(0, n_features, (n_trees, depth))
        .astype(np.int32),
        "split_bins": rng.integers(1, n_borders, (n_trees, depth))
        .astype(np.int32),
        "leaf_values": rng.normal(size=(n_trees, 2 ** depth, n_outputs))
        .astype(np.float32),
        "borders": np.sort(rng.normal(size=(n_borders, n_features)), 0)
        .astype(np.float32),
        "n_borders": np.full((n_features,), n_borders, np.int32),
        "base_score": rng.normal(scale=0.1, size=(n_outputs,))
        .astype(np.float32),
    }


def _pair(**kw):
    a = _arrays(**kw)
    return (jtrees.ObliviousEnsemble(**{k: jnp.asarray(v)
                                        for k, v in a.items()}),
            ObliviousEnsemble(**{k: torch.from_numpy(v)
                                 for k, v in a.items()}))


def _x(n_features, n=40, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, n_features)).astype(np.float32)


def _assert_same_model(ens, jens):
    for f in FIELDS:
        got, want = getattr(ens, f).numpy(), np.asarray(getattr(jens, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


# --------------------------------------------------------------------------
# The one-shot API
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fn", ["raw_predict", "predict_proba",
                                "predict_class"])
@pytest.mark.parametrize("strategy,tree_block", [
    ("auto", 0), ("staged", 0), ("staged", 4), ("fused", 0)])
@pytest.mark.parametrize("n_outputs", [1, 3])
def test_one_shot_api_matches_jax_and_the_plan(fn, strategy, tree_block,
                                               n_outputs):
    jens, ens = _pair(n_outputs=n_outputs)
    x = _x(ens.n_features)
    got = getattr(predict, fn)(ens, x, strategy=strategy,
                               tree_block=tree_block, device="cpu")
    want = np.asarray(getattr(jpredict, fn)(
        jens, jnp.asarray(x), strategy="staged" if strategy == "auto"
        else strategy, backend="ref", tree_block=tree_block))
    assert got.device.type == "cpu"
    if fn == "predict_class":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _close(got, want)
    plan = Predictor.build(ens, device="cpu", strategy=strategy,
                           tree_block=tree_block)
    entry = {"raw_predict": plan.raw, "predict_proba": plan.proba,
             "predict_class": plan.classify}[fn]
    assert torch.equal(got, entry(x))
    assert plan.stats["total_traces"] == 1       # only the entry's call


def test_one_shot_api_takes_a_pool_and_refuses_block_sizes():
    jens, ens = _pair()
    x = _x(ens.n_features)
    pool = quantize.quantize_pool(torch.from_numpy(x), ens.borders)
    jpool = jquantize.quantize_pool(jnp.asarray(x), jens.borders)
    got = predict.raw_predict(ens, pool, device="cpu")
    _close(got, jpredict.raw_predict(jens, jpool, strategy="staged",
                                     backend="ref"))
    assert torch.equal(got, predict.raw_predict(ens, x, device="cpu"))
    for kw in ({"block_n": 128}, {"block_t": 8}):
        with pytest.raises(ValueError, match="fused_plan"):
            predict.raw_predict(ens, x, device="cpu", **kw)
        with pytest.raises(ValueError, match="fused_plan"):
            predict.predict_proba(ens, x, device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            predict.raw_predict(ens, x)


# --------------------------------------------------------------------------
# CatBoost JSON import (the JSON is built here, as tests/test_predictor.py
# builds it: no model file is read from outside)
# --------------------------------------------------------------------------
def _catboost_model():
    return {
        "features_info": {"float_features": [
            {"flat_feature_index": 0, "borders": [0.0, 1.0]},
            {"flat_feature_index": 1, "borders": [0.5]},
        ]},
        "oblivious_trees": [
            {"splits": [
                {"split_type": "FloatFeature", "float_feature_index": 0,
                 "border": 1.0},
                {"split_type": "FloatFeature", "float_feature_index": 1,
                 "border": 0.5},
            ], "leaf_values": [1.0, 2.0, 3.0, 4.0]},
            # a shallower tree: the importer pads it to the ensemble depth
            {"splits": [
                {"split_type": "FloatFeature", "float_feature_index": 0,
                 "border": 0.0},
            ], "leaf_values": [10.0, 20.0]},
        ],
        "scale_and_bias": [2.0, [0.25]],
    }


def _multiclass_model():
    return {
        "features_info": {"float_features": [
            {"flat_feature_index": 0, "borders": [0.0]},
        ]},
        "oblivious_trees": [
            {"splits": [
                {"split_type": "FloatFeature", "float_feature_index": 0,
                 "border": 0.0},
            ], "leaf_values": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]},
        ],
        "scale_and_bias": [0.5, [0.1, 0.2, 0.3]],
    }


def _mixed_depth_model():
    b = {"split_type": "FloatFeature", "float_feature_index": 0}
    return {
        "features_info": {"float_features": [
            {"flat_feature_index": 0, "borders": [0.0, 1.0, 2.0]},
        ]},
        "oblivious_trees": [
            {"splits": [dict(b, border=0.0), dict(b, border=1.0),
                        dict(b, border=2.0)],
             "leaf_values": [float(v) for v in range(8)]},
            {"splits": [dict(b, border=1.0)],
             "leaf_values": [10.0, 20.0]},
            {"splits": [dict(b, border=0.0), dict(b, border=2.0)],
             "leaf_values": [1.0, 2.0, 3.0, 4.0]},
        ],
    }


def _write(tmp_path, model, name="model.json"):
    path = tmp_path / name
    path.write_text(json.dumps(model))
    return path


@pytest.mark.parametrize("make", [_catboost_model, _multiclass_model,
                                  _mixed_depth_model],
                         ids=["binary", "multiclass", "mixed_depth"])
def test_load_catboost_json_equals_jax(tmp_path, make):
    path = _write(tmp_path, make())
    ens = load_catboost_json(path)
    _assert_same_model(ens, jpredictor.load_catboost_json(path))
    assert ens.device.type == "cpu"
    x = _x(ens.n_features, 16) * 2
    plan = Predictor.from_catboost_json(path, device="cpu")
    jplan = jpredictor.Predictor.from_catboost_json(
        path, jpredictor.PredictConfig(strategy="staged", backend="ref"))
    assert plan.config.layout == jplan.config.layout
    _close(plan.raw(x), jplan.raw(jnp.asarray(x)))


def test_from_catboost_json_hand_computed(tmp_path):
    path = _write(tmp_path, _catboost_model())
    ens = load_catboost_json(path)
    np.testing.assert_array_equal(ens.split_bins.numpy(),
                                  [[2, 1], [1, PAD_SPLIT_BIN]])
    x = np.array([[-1.0, 0.0], [0.5, 0.9], [2.0, 0.9], [2.0, 0.0]],
                 np.float32)
    plan = Predictor.from_catboost_json(path, device="cpu",
                                        strategy="fused")
    # raw = 2*(tree0 leaf + tree1 leaf) + 0.25: tree0 bit0 = x0 > 1.0,
    # bit1 = x1 > 0.5; tree1 bit0 = x0 > 0.0
    expect = np.array([2 * (1 + 10), 2 * (3 + 20), 2 * (4 + 20),
                       2 * (2 + 20)], np.float32) + 0.25
    np.testing.assert_allclose(plan.raw(x).numpy()[:, 0], expect,
                               rtol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Predictor.from_catboost_json(path)


def _break(mutate):
    def make():
        model = _catboost_model()
        mutate(model)
        return model
    return make


def _split(model):
    return model["oblivious_trees"][0]["splits"][0]


@pytest.mark.parametrize("make,match", [
    (lambda: {"oblivious_trees": []}, "float_features"),
    (_break(lambda m: m.update(oblivious_trees=[])), "oblivious_trees"),
    (_break(lambda m: m["oblivious_trees"][1].pop("splits")), "missing"),
    (_break(lambda m: m["oblivious_trees"][0].update(
        leaf_values=[1.0, 2.0, 3.0])), "multiple"),
    (_break(lambda m: m["oblivious_trees"][1].update(
        leaf_values=[1.0])), "leaf values"),
    (_break(lambda m: _split(m).update(split_type="OneHotFeature")),
     "FloatFeature"),
    (_break(lambda m: _split(m).update(float_feature_index=5)), "outside"),
    (_break(lambda m: _split(m).pop("border")), "no border"),
    (_break(lambda m: _split(m).update(border=0.33)), "not found"),
    (_break(lambda m: m["features_info"]["float_features"][0].update(
        borders=[])), "no borders"),
    (_break(lambda m: m.update(scale_and_bias=[1.0, [0.1, 0.2]])),
     "scale_and_bias"),
], ids=["not_an_export", "no_trees", "truncated", "leaf_count",
        "leaf_count_tree1", "split_type", "feature_range", "no_border",
        "border_value", "feature_without_borders", "bias_width"])
def test_load_catboost_json_rejects_what_jax_rejects(tmp_path, make, match):
    path = _write(tmp_path, make(), "bad.json")
    with pytest.raises(ValueError, match=match):
        load_catboost_json(path)
    with pytest.raises(ValueError, match=match):
        jpredictor.load_catboost_json(path)


# --------------------------------------------------------------------------
# Ensemble helpers
# --------------------------------------------------------------------------
def test_concat_ensembles_equals_jax():
    jens, ens = _pair()
    got = concat_ensembles(ens.slice_trees(0, 4), ens.slice_trees(4, 9))
    _assert_same_model(got, jens)
    _assert_same_model(concat_ensembles(ens, ens),
                       jtrees.concat_ensembles(jens, jens))
    x = _x(ens.n_features)
    assert torch.equal(Predictor.build(got, device="cpu").raw(x),
                       Predictor.build(ens, device="cpu").raw(x))


@pytest.mark.parametrize("other,match", [
    (dict(depth=3), "depth"), (dict(n_outputs=5), "n_outputs"),
    (dict(seed=2, n_borders=7), "border tables"),
    (dict(seed=99), "border values")])
def test_concat_ensembles_refuses_what_jax_refuses(other, match):
    jens, ens = _pair()
    jb, b = _pair(**other)
    with pytest.raises(ValueError, match=match):
        concat_ensembles(ens, b)
    with pytest.raises(ValueError, match=match):
        jtrees.concat_ensembles(jens, jb)


def test_empty_ensemble_describe_json_and_lower():
    jens, ens = _pair()
    empty = empty_ensemble(ens.n_features, 4, 3, ens.borders, ens.n_borders)
    jempty = jtrees.empty_ensemble(jens.n_features, 4, 3, jens.borders,
                                   jens.n_borders)
    _assert_same_model(empty, jempty)
    assert empty.describe_json() == jempty.describe_json()
    assert json.loads(ens.describe_json()) == json.loads(
        jens.describe_json())
    _assert_same_model(concat_ensembles(empty, ens),
                       jtrees.concat_ensembles(jempty, jens))
    x = torch.from_numpy(_x(ens.n_features))
    bins = quantize.quantize_pool(x, ens.borders).bins
    want = layout.lower(ens, "soa").leaf_sum(bins, backend="torch_ref")
    for name in layout.LAYOUT_NAMES:
        lowered = ens.lower(name)
        assert type(lowered) is type(layout.lower(ens, name))
        _close(lowered.leaf_sum(bins, backend="torch_ref"), want)
    with pytest.raises(ValueError, match="layout"):
        ens.lower("nope")


# --------------------------------------------------------------------------
# Synthetic datasets
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(jsynthetic.REGISTRY))
@pytest.mark.parametrize("seed", [None, 11])
def test_synthetic_load_bit_for_bit(name, seed):
    assert sorted(synthetic.REGISTRY) == sorted(jsynthetic.REGISTRY)
    got = synthetic.load(name, scale=0.002, seed=seed)
    want = jsynthetic.load(name, scale=0.002, seed=seed)
    assert (got.name, got.loss, got.n_classes) == \
        (want.name, want.loss, want.n_classes)
    assert got.params == boosting.BoostingParams(
        **{k: getattr(want.params, k)
           for k in boosting.BoostingParams.__dataclass_fields__})
    for f in ("x_train", "y_train", "x_test", "y_test", "group_index_train",
              "group_index_test", "emb_train", "emb_test"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


# --------------------------------------------------------------------------
# The bulk scorer's chunk planner
# --------------------------------------------------------------------------
def test_best_chunk_rows_at_the_smokes_shape():
    """The 1,000-tree depth-8 Covertype model: the port counts 4,298 bytes
    a row (4F float, F bins, 4T index, 4C output) and picks 4,096 rows;
    the JAX package's staged panels would pin it at 256."""
    kw = dict(n_borders=63, n_trees=1000, n_leaves=256)
    assert tuning.chunk_row_bytes(54, 7, **kw) == 4298
    assert tuning.best_chunk_rows(54, 7, **kw) == 4096
    assert tuning.best_chunk_rows(54, 7, **kw, n_rows=1_115_520) == 4096
    assert jtuning.best_chunk_rows(54, 7, **kw) == tuning.MIN_CHUNK_ROWS
    assert (tuning.CHUNK_BUDGET_BYTES, tuning.MIN_CHUNK_ROWS,
            tuning.MAX_CHUNK_ROWS) == (jtuning.CHUNK_BUDGET_BYTES,
                                       jtuning.MIN_CHUNK_ROWS,
                                       jtuning.MAX_CHUNK_ROWS)
    # without model dimensions both packages count the same bytes
    assert tuning.best_chunk_rows(54, 1) == jtuning.best_chunk_rows(54, 1)


@pytest.mark.parametrize("depth,chunk_rows,n_chunks,on_card,want", [
    (2, 4096, 273, True, 0),          # the smoke's auto chunk on the card
    (2, 1 << 16, 18, True, 2),        # the smallest chunk the worker pays at
    (2, (1 << 16) - 1, 18, True, 0),
    (3, 1 << 17, 9, True, 3),
    (2, 64, 3, False, 2),             # the CPU: any chunk
    (2, 1 << 16, 1, True, 0),         # one chunk: nothing to overlap
    (2, 64, 1, False, 0),
    (0, 1 << 17, 9, True, 0),         # the caller asked for none
])
def test_prefetch_depth_rule(depth, chunk_rows, n_chunks, on_card, want):
    assert tuning.PREFETCH_MIN_CHUNK_ROWS == 65536
    assert tuning.prefetch_depth(depth, chunk_rows, n_chunks,
                                 on_card) == want


@GRID
@given(n_features=st.integers(1, 30_000), n_outputs=st.integers(1, 200),
       n_trees=st.integers(0, 20_000),
       budget=st.integers(1, 1 << 30),
       n_rows=st.one_of(st.none(), st.integers(0, 10_000_000)))
def test_best_chunk_rows_grid(n_features, n_outputs, n_trees, budget,
                              n_rows):
    rows = tuning.best_chunk_rows(n_features, n_outputs, n_trees=n_trees,
                                  budget_bytes=budget, n_rows=n_rows)
    per_row = tuning.chunk_row_bytes(n_features, n_outputs, n_trees=n_trees)
    assert rows & (rows - 1) == 0                        # a power of two
    assert tuning.MIN_CHUNK_ROWS <= rows <= tuning.MAX_CHUNK_ROWS
    # the largest that fits, unless the clamp or the cover rule cut it
    if rows > tuning.MIN_CHUNK_ROWS:
        assert rows * per_row <= budget
    if n_rows:
        cover = max(tuning.MIN_CHUNK_ROWS, 1 << (n_rows - 1).bit_length())
        assert rows <= cover
        assert rows == cover or rows * 2 > tuning.MAX_CHUNK_ROWS \
            or rows * 2 * per_row > budget
    elif rows < tuning.MAX_CHUNK_ROWS:
        assert rows * 2 * per_row > budget


# --------------------------------------------------------------------------
# fit_source
# --------------------------------------------------------------------------
@pytest.mark.parametrize("sample_rows", [65536, 300],
                         ids=["exact_borders", "reservoir"])
def test_fit_source_matches_jax(sample_rows):
    source = SyntheticSource("covertype", scale=0.003, split="train",
                             repeat=2)
    jsource = jsources.SyntheticSource("covertype", scale=0.003,
                                       split="train", repeat=2)
    ds = source.dataset
    y = np.tile(np.asarray(ds.y_train), 2)[:source.n_rows]
    params = boosting.BoostingParams(n_trees=4, depth=3, max_bins=16,
                                     seed=0)
    chunk = 256
    assert source.n_rows > chunk                  # genuinely multi-chunk
    trainer = GBDTTrainer(make_loss(ds.loss, n_classes=ds.n_classes),
                          params, device="cpu")
    ens, hist = trainer.fit_source(source, y, chunk_rows=chunk,
                                   sample_rows=sample_rows)
    jtrainer = JTrainer(jmake_loss(ds.loss, n_classes=ds.n_classes),
                        _jparams(params))
    jens, jhist = jtrainer.fit_source(jsource, y, chunk_rows=chunk,
                                      sample_rows=sample_rows)
    n_chunks = -(-source.n_rows // chunk)
    assert (hist["n_chunks"], hist["chunk_rows"]) == \
        (jhist["n_chunks"], jhist["chunk_rows"]) == (n_chunks, chunk)
    snap = trainer.metrics.snapshot()
    assert (snap["n_chunks"], snap["chunk_rows"]) == (n_chunks, chunk)
    assert snap["quantize_s"] > 0
    # the borders and the pool are JAX's bit for bit, so the splits are
    np.testing.assert_array_equal(trainer.pool_.bins.numpy(),
                                  np.asarray(jtrainer.pool_.bins))
    assert trainer.pool_.fingerprint == jtrainer.pool_.fingerprint
    np.testing.assert_array_equal(ens.borders.numpy(),
                                  np.asarray(jens.borders))
    np.testing.assert_array_equal(ens.split_features.numpy(),
                                  np.asarray(jens.split_features))
    np.testing.assert_array_equal(ens.split_bins.numpy(),
                                  np.asarray(jens.split_bins))
    _close(ens.leaf_values, jens.leaf_values)
    # in core: the same rows as one matrix give the same model, bit for bit
    x_full = np.concatenate([source.read(s, min(s + chunk, source.n_rows))
                             for s in range(0, source.n_rows, chunk)])
    if sample_rows >= source.n_rows:
        borders, n_borders = quantize.compute_borders(x_full,
                                                      params.max_bins)
        assert torch.equal(borders, ens.borders)
    else:
        borders, n_borders = ens.borders, ens.n_borders
    pool = quantize.quantize_pool(torch.from_numpy(x_full), borders)
    assert torch.equal(pool.bins, trainer.pool_.bins)
    ens_p, _ = GBDTTrainer(make_loss(ds.loss, n_classes=ds.n_classes),
                           params, device="cpu").fit_pool(
        pool, y, borders=borders, n_borders=n_borders)
    for f in ("split_features", "split_bins", "leaf_values"):
        assert torch.equal(getattr(ens, f), getattr(ens_p, f)), f


def _jparams(params):
    from repro.core.boosting import BoostingParams as JParams
    return JParams(**{k: getattr(params, k)
                      for k in boosting.BoostingParams.__dataclass_fields__})


def test_trainer_refusal_names_the_roadmap_item():
    params = boosting.BoostingParams(rsm=0.5)
    with pytest.raises(NotImplementedError, match="A5"):
        GBDTTrainer(make_loss("rmse"), params, device="cpu")

"""The port's kNN slice against the JAX package's, on the CPU.

The same numpy inputs go through `repro` and `repro_torch`:

  * the plain `l2sq_rowwise` / `l2sq_matrix` against JAX `ref` and the
    Pallas kernels in interpret mode, at the shapes of
    tests/test_kernels.py, within the distance rule of PERF.md §2 (per
    element 8 sqrt(K) u (||a||^2 + ||b||^2 + 2 sum|a_k b_k|) for the
    matrix form, 8 sqrt(K) u sum (r_k - q_k)^2 for the rowwise form; the
    1e-4 of tests/test_differential.py cannot hold for distances of
    several hundred);
  * `image_embeddings` bit for bit;
  * `KNNFeaturizer.transform` on both routes and `augment_with_knn`
    under the feature rule: a query whose JAX distances have a gap
    between the k-th and (k+1)-th smallest wider than twice its largest
    limit has the same neighbour set, bit-identical class fractions and a
    mean distance within that limit; the other queries are exempt and
    counted;
  * exact ties (duplicated reference rows, integer data): lower index
    first, as `jax.lax.top_k`, and features bit for bit;
  * `EmbeddingGBDTPipeline.predict` on one ensemble carried across with
    `ensemble_from_jax_npz`: class ids equal on rows whose bins agree and
    whose top-two margin exceeds twice the tree-sum limit.

The CUDA kernels run only on the card: `chip_smoke.py` holds them against
these plain versions there, and the `cuda`-marked test below does when a
card is present.
"""
import math
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import knn as jknn  # noqa: E402
from repro.core import quantize as jquantize  # noqa: E402
from repro.core import trees as jtrees  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.serving.engine import EmbeddingGBDTPipeline as JPipeline  # noqa: E402,E501
from repro_torch import convert  # noqa: E402
from repro_torch.core import knn  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build, l2dist, ops, ref, registry  # noqa: E402,E501
from repro_torch.serving.engine import EmbeddingGBDTPipeline  # noqa: E402

torch.set_num_threads(1)

K_NEIGHBOURS = 16
SCALE = 0.05           # 140 train and 142 test embeddings
BATCH = 50             # smaller than Q: the transform's chunks meet
ROWWISE_SHAPES = [(256, 128), (100, 512), (37, 90), (8, 8)]
MATRIX_SHAPES = [(128, 128, 128), (100, 200, 512), (37, 61, 90),
                 (300, 50, 256)]


def _np(t):
    """A writable numpy copy of a JAX array."""
    return np.array(t)


# --------------------------------------------------------------------------
# (a) the plain versions against JAX ref and the Pallas kernels
# --------------------------------------------------------------------------
@pytest.mark.parametrize("against", ["ref", "pallas"])
@pytest.mark.parametrize("n,k", ROWWISE_SHAPES)
def test_l2sq_rowwise_plain_matches_jax(n, k, against):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(k,)).astype(np.float32)
    refs = rng.normal(size=(n, k)).astype(np.float32)
    tq, tr = torch.from_numpy(q), torch.from_numpy(refs)
    got = ref.l2sq_rowwise(tq, tr)
    # the registry's CPU route and the wrapper on CPU tensors are the
    # plain version itself
    assert torch.equal(ops.l2sq_rowwise(tq, tr), got)
    assert torch.equal(l2dist.l2sq_rowwise(tq, tr), got)
    want = _np(jops.l2sq_rowwise(jnp.asarray(q), jnp.asarray(refs),
                                 backend=against))
    limit = l2dist.rowwise_limit(tq, tr).numpy()
    assert got.shape == (n,) and got.dtype == torch.float32
    assert (got.numpy() >= 0).all()
    assert (np.abs(got.numpy().astype(np.float64) - want) <= limit).all()


@pytest.mark.parametrize("against", ["ref", "pallas"])
@pytest.mark.parametrize("m,n,k", MATRIX_SHAPES)
def test_l2sq_matrix_plain_matches_jax(m, n, k, against):
    rng = np.random.default_rng(4)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(n, k)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = ref.l2sq_matrix(ta, tb)
    assert torch.equal(ops.l2sq_matrix(ta, tb), got)
    assert torch.equal(l2dist.l2sq_matrix(ta, tb), got)
    want = _np(jops.l2sq_matrix(jnp.asarray(a), jnp.asarray(b),
                                backend=against))
    limit = l2dist.matrix_limit(ta, tb).numpy()
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert (got.numpy() >= 0).all()
    assert (np.abs(got.numpy().astype(np.float64) - want) <= limit).all()


def test_matrix_limit_covers_cancellation_of_a_self_distance():
    # the matrix form of a row against itself lands near 0, not at it;
    # the limit scales with the norms, so that stays inside it
    emb = synthetic.image_embeddings(scale=SCALE).emb_train
    t = torch.from_numpy(emb)
    got = ref.l2sq_matrix(t, t).diagonal().double()
    limit = l2dist.matrix_limit(t, t).diagonal()
    assert (got <= limit).all()
    exact = ref.l2sq_rowwise(t[0], t)
    assert float(exact[0]) == 0.0


# --------------------------------------------------------------------------
# (b) the data
# --------------------------------------------------------------------------
@pytest.mark.parametrize("scale,seed", [(SCALE, 4), (0.02, 9)])
def test_image_embeddings_bit_identical(scale, seed):
    mine = synthetic.image_embeddings(scale=scale, seed=seed)
    theirs = jsynthetic.image_embeddings(scale=scale, seed=seed)
    for field in ("x_train", "y_train", "x_test", "y_test", "emb_train",
                  "emb_test"):
        a, b = getattr(mine, field), getattr(theirs, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (mine.name, mine.loss, mine.n_classes) == \
        (theirs.name, theirs.loss, theirs.n_classes)
    assert (mine.params.depth, mine.params.learning_rate) == \
        (theirs.params.depth, theirs.params.learning_rate)
    assert mine.emb_train.shape[1] == 512 and (mine.emb_train >= 0).all()


# --------------------------------------------------------------------------
# (c) the featurizer under the feature rule
# --------------------------------------------------------------------------
def _featurizers(ds, k=K_NEIGHBOURS):
    jfeat = jknn.KNNFeaturizer(jnp.asarray(ds.emb_train),
                               jnp.asarray(ds.y_train),
                               n_classes=ds.n_classes, k=k)
    tfeat = convert.knn_featurizer_from_numpy(
        _np(jfeat.train_embeddings), _np(jfeat.train_labels),
        ds.n_classes, k=k, device="cpu")
    return jfeat, tfeat


def _dists(route, queries, refs):
    """(JAX dists, port dists, per-element limit) of one route."""
    jq, jr = jnp.asarray(queries), jnp.asarray(refs)
    tq, tr = torch.from_numpy(queries), torch.from_numpy(refs)
    if route == "matrix":
        return (_np(jops.l2sq_matrix(jq, jr)),
                ops.l2sq_matrix(tq, tr).numpy(),
                l2dist.matrix_limit(tq, tr).numpy())
    return (np.stack([_np(jops.l2sq_rowwise(jq[i], jr))
                      for i in range(len(queries))]),
            torch.stack([ops.l2sq_rowwise(tq[i], tr)
                         for i in range(len(queries))]).numpy(),
            torch.stack([l2dist.rowwise_limit(tq[i], tr)
                         for i in range(len(queries))]).numpy())


def _feature_rule(want_dists, limit, k):
    """(checked (Q,) bool, the row's largest limit (Q,)): a query is checked
    when the gap between its k-th and (k+1)-th smallest reference distance
    exceeds twice its largest limit."""
    d = np.sort(want_dists.astype(np.float64), axis=1)
    row_limit = limit.max(axis=1)
    if d.shape[1] == k:
        return np.ones(len(d), bool), row_limit
    return d[:, k] - d[:, k - 1] > 2 * row_limit, row_limit


def _hold_features(got, want, got_idx, want_idx, checked, row_limit,
                   n_classes, what):
    for q in np.flatnonzero(checked):
        assert set(got_idx[q].tolist()) == set(want_idx[q].tolist()), \
            f"{what}: query {q} has other neighbours"
    assert np.array_equal(got[checked, :n_classes],
                          want[checked, :n_classes]), what
    err = np.abs(got[:, n_classes].astype(np.float64) - want[:, n_classes])
    assert (err[checked] <= row_limit[checked]).all(), what
    print(f"{what}: {int((~checked).sum())} of {len(checked)} queries "
          "exempt (k-th gap within twice the limit)")


@pytest.mark.parametrize("route", ["matrix", "rowwise"])
def test_transform_matches_jax_under_the_feature_rule(route):
    ds = synthetic.image_embeddings(scale=SCALE)
    jfeat, tfeat = _featurizers(ds)
    rowwise = route == "rowwise"
    want = _np(jfeat.transform(jnp.asarray(ds.emb_test), rowwise=rowwise,
                               batch_size=BATCH))
    got = tfeat.transform(ds.emb_test, rowwise=rowwise, batch_size=BATCH)
    assert got.shape == (len(ds.emb_test), tfeat.n_features) == want.shape
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    jd, td, limit = _dists(route, ds.emb_test, ds.emb_train)
    assert (np.abs(td.astype(np.float64) - jd) <= limit).all()
    checked, row_limit = _feature_rule(jd, limit, tfeat.k)
    assert checked.mean() >= 0.9
    want_idx = _np(jax.lax.top_k(-jnp.asarray(jd), tfeat.k)[1])
    got_idx = tfeat.neighbours(torch.from_numpy(td))[1].numpy()
    _hold_features(got.numpy(), want, got_idx, want_idx, checked,
                   row_limit, ds.n_classes, route)


def test_augment_with_knn_matches_jax():
    ds = synthetic.image_embeddings(scale=SCALE)
    jfeat, tfeat = _featurizers(ds)
    want = jknn.augment_with_knn(ds.x_train, ds.emb_train, jfeat,
                                 batch_size=BATCH)
    got = knn.augment_with_knn(ds.x_train, ds.emb_train, tfeat,
                               batch_size=BATCH)
    assert got.shape == want.shape == (len(ds.x_train),
                                       512 + ds.n_classes + 1)
    assert got.dtype == np.float32
    assert np.array_equal(got[:, :512], want[:, :512])
    jd, td, limit = _dists("matrix", ds.emb_train, ds.emb_train)
    checked, row_limit = _feature_rule(jd, limit, tfeat.k)
    want_idx = _np(jax.lax.top_k(-jnp.asarray(jd), tfeat.k)[1])
    got_idx = tfeat.neighbours(torch.from_numpy(td))[1].numpy()
    _hold_features(got[:, 512:], want[:, 512:], got_idx, want_idx, checked,
                   row_limit, ds.n_classes, "augment")


def test_rowwise_and_matrix_routes_agree_within_both_limits():
    ds = synthetic.image_embeddings(scale=SCALE)
    _, md, mlim = _dists("matrix", ds.emb_test, ds.emb_train)
    _, rd, rlim = _dists("rowwise", ds.emb_test, ds.emb_train)
    assert (np.abs(md.astype(np.float64) - rd) <= mlim + rlim).all()


@pytest.mark.parametrize("k", [3, 5, 7, 16])
def test_class_fractions_are_jax_means_bit_for_bit(k):
    # jnp.mean divides by multiplying with 1/k: k = 7 shows the difference
    ds = synthetic.image_embeddings(scale=SCALE)
    jfeat, tfeat = _featurizers(ds, k=k)
    jd = _np(jops.l2sq_matrix(jnp.asarray(ds.emb_test),
                              jnp.asarray(ds.emb_train)))
    want = _np(jfeat._features_from_dists(jnp.asarray(jd)))
    got = tfeat._features_from_dists(torch.from_numpy(jd)).numpy()
    assert np.array_equal(got[:, :-1], want[:, :-1])


# --------------------------------------------------------------------------
# (d) exact ties: lower index first
# --------------------------------------------------------------------------
def _tied_reference(seed=5):
    """Integer embeddings in [0, 3], every reference row present four
    times: every distance is an exact integer in every evaluation order,
    so ties are exact in both packages."""
    rng = np.random.default_rng(seed)
    unique = rng.integers(0, 4, size=(10, 8)).astype(np.float32)
    rows = rng.permutation(np.repeat(np.arange(10), 4))
    refs = unique[rows]
    labels = rng.integers(0, 3, size=len(refs)).astype(np.int32)
    queries = rng.integers(0, 4, size=(12, 8)).astype(np.float32)
    return refs, labels, queries


@pytest.mark.parametrize("route", ["matrix", "rowwise"])
def test_exact_ties_pick_the_lower_index_first(route):
    refs, labels, queries = _tied_reference()
    k = 6          # cuts through groups of four equal distances
    jfeat = jknn.KNNFeaturizer(jnp.asarray(refs), jnp.asarray(labels),
                               n_classes=3, k=k)
    tfeat = knn.KNNFeaturizer(torch.from_numpy(refs),
                              torch.from_numpy(labels), 3, k=k,
                              device="cpu")
    jd, td, _ = _dists(route, queries, refs)
    assert np.array_equal(jd, td)
    srt = np.sort(td, axis=1)
    assert (srt[:, k - 1] == srt[:, k]).all()     # a tie at every cut
    want_idx = _np(jax.lax.top_k(-jnp.asarray(jd), k)[1])
    got_d, got_idx = tfeat.neighbours(torch.from_numpy(td))
    assert np.array_equal(got_idx.numpy(), want_idx)
    assert np.array_equal(got_d.numpy(), np.take_along_axis(jd, want_idx,
                                                            axis=1))
    rowwise = route == "rowwise"
    want = _np(jfeat.transform(jnp.asarray(queries), rowwise=rowwise,
                               batch_size=5))
    got = tfeat.transform(queries, rowwise=rowwise, batch_size=5).numpy()
    assert np.array_equal(got, want)


# --------------------------------------------------------------------------
# (e) the pipeline, on one ensemble carried across from the JAX package
# --------------------------------------------------------------------------
def _jax_head(x_aug, n_classes, n_emb, seed=6, n_trees=4, depth=4):
    """A JAX ensemble over the augmented columns: borders from its own
    `compute_borders`, most levels split on a kNN column."""
    rng = np.random.default_rng(seed)
    borders, n_borders = jquantize.compute_borders(x_aug, max_bins=16)
    nb = _np(n_borders)
    usable = np.flatnonzero(nb > 0)
    knn_cols = usable[usable >= n_emb]
    sf = np.where(rng.random((n_trees, depth)) < 0.75,
                  rng.choice(knn_cols, (n_trees, depth)),
                  rng.choice(usable, (n_trees, depth))).astype(np.int32)
    sb = (1 + (rng.random((n_trees, depth)) * nb[sf]).astype(np.int32))
    lv = rng.normal(size=(n_trees, 1 << depth, n_classes)).astype(
        np.float32)
    return jtrees.ObliviousEnsemble(
        jnp.asarray(sf), jnp.asarray(sb.astype(np.int32)), jnp.asarray(lv),
        jnp.asarray(borders), jnp.asarray(n_borders))


def _tree_sum_limit(ens, bins):
    """§2's float limit on the trees' raw sums, per row and output."""
    idx = ref.leaf_index(bins, ens.split_features, ens.split_bins)
    s = ref.leaf_gather(idx, ens.leaf_values.abs()).double()
    t = ens.leaf_values.shape[0]
    return 8 * math.sqrt(t) * 2.0 ** -24 * s \
        + 2 * 2.0 ** -24 * (s + ens.base_score.abs().double()[None, :])


def test_pipeline_predict_matches_jax(tmp_path: pathlib.Path):
    ds = synthetic.image_embeddings(scale=SCALE)
    jfeat, tfeat = _featurizers(ds)
    x_aug = jknn.augment_with_knn(ds.x_train, ds.emb_train, jfeat)
    jens = _jax_head(x_aug, ds.n_classes, ds.emb_train.shape[1])
    jens.save(tmp_path / "head.npz")
    tens = convert.ensemble_from_jax_npz(tmp_path / "head.npz")

    want = JPipeline(jfeat, jens).predict(ds.emb_test)
    pipe = EmbeddingGBDTPipeline(tfeat, tens, device="cpu")
    assert pipe.predictor.device.type == "cpu"
    got = pipe.predict(ds.emb_test)
    assert got.dtype == np.int32 and got.shape == want.shape

    # exempt: rows whose kNN features bin differently, and rows whose top
    # two raw scores lie within twice the tree-sum limit
    emb = torch.from_numpy(ds.emb_test)
    x_port = torch.cat([emb, tfeat.transform(emb)], dim=1)
    x_jax = torch.from_numpy(np.concatenate(
        [ds.emb_test, _np(jfeat.transform(jnp.asarray(ds.emb_test)))], 1))
    borders = pipe.predictor.lowered.borders
    bins = ref.binarize(x_port, borders)
    same_bins = (bins == ref.binarize(x_jax, borders)).all(dim=1)
    raw = pipe.predictor.raw(x_port)
    top2 = raw.topk(2, dim=1).values
    limit = _tree_sum_limit(pipe.predictor.ensemble, bins)
    clear = (top2[:, 0] - top2[:, 1]).double() > 2 * limit.max(dim=1).values
    checked = (same_bins & clear).numpy()
    assert checked.mean() >= 0.9
    assert np.array_equal(got[checked], want[checked])
    print(f"pipeline: {int((~checked).sum())} of {len(checked)} rows "
          "exempt")


# --------------------------------------------------------------------------
# (f) registry, refusals and defaults
# --------------------------------------------------------------------------
def test_l2sq_is_a_core_op_dispatched_on_rank():
    assert "l2sq" in registry.CORE_OPS
    impls = registry.implementations("l2sq")
    assert {n: i.family for n, i in impls.items()} == \
        {"cuda": "cuda", "torch_ref": "torch_ref"}
    assert all(i.dtypes == ("float32",) and i.layouts == ops.ALL_LAYOUTS
               for i in impls.values())
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert registry.resolve("l2sq", "auto", device=cuda,
                            dtype="float32") == "cuda"
    assert registry.resolve("l2sq", "auto", device=cpu,
                            dtype="float32") == "torch_ref"
    with pytest.raises(ValueError, match="dtype"):
        registry.resolve("l2sq", "auto", device=cpu, dtype="uint8")
    with pytest.raises(ValueError, match="plain"):
        registry.resolve("l2sq", "torch_ref", device=cuda)
    assert registry.known_backends() == ("cuda", "torch_ref")
    # rank picks the form
    q, refs = torch.ones(4), torch.zeros((3, 4))
    registry.reset_call_stats()
    assert ops.l2sq_rowwise(q, refs).tolist() == [4.0, 4.0, 4.0]
    assert ops.l2sq_matrix(q[None, :], refs).shape == (1, 3)
    assert registry.call_stats() == {"l2sq": 2}
    assert ops.KERNELS["l2sq_rowwise"] is l2dist.l2sq_rowwise
    assert ops.KERNELS["l2sq_matrix"] is l2dist.l2sq_matrix


def test_cuda_family_refuses_cpu_tensors():
    q, refs = torch.ones(4), torch.zeros((3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ops.l2sq_rowwise(q, refs, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.l2sq_matrix(refs, refs, backend="cuda")
    f = knn.KNNFeaturizer(refs, torch.zeros(3, dtype=torch.int32), 2, k=2,
                          device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        f.transform(refs, backend="cuda")


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        l2dist.l2sq_rowwise(torch.ones((2, 4)), torch.ones((3, 4)))
    with pytest.raises(ValueError):
        l2dist.l2sq_rowwise(torch.ones(5), torch.ones((3, 4)))
    with pytest.raises(ValueError):
        l2dist.l2sq_matrix(torch.ones(4), torch.ones((3, 4)))
    with pytest.raises(ValueError):
        l2dist.l2sq_matrix(torch.ones((2, 5)), torch.ones((3, 4)))
    with pytest.raises(ValueError, match="k must"):
        knn.KNNFeaturizer(torch.ones((3, 4)), torch.zeros(3), 2, k=4,
                          device="cpu")
    f = knn.KNNFeaturizer(torch.ones((3, 4)), torch.zeros(3), 2, k=2,
                          device="cpu")
    with pytest.raises(ValueError, match="queries"):
        f.transform(torch.ones((2, 5)))
    assert f.transform(np.zeros((0, 4), np.float32)).shape == (0, 3)


@pytest.mark.parametrize("name", ["l2sq_rowwise", "l2sq_matrix"])
def test_wrappers_off_the_cpu_launch_or_raise(name, monkeypatch):
    # Off the CPU a wrapper never takes its plain version: a tensor that is
    # not on the card is refused, and one that passes the device check goes
    # to the kernel's launcher (stubbed here) and is counted.
    wrapper = ops.KERNELS[name]
    a = torch.empty((5, 12), device="meta")
    first = a[0] if name == "l2sq_rowwise" else a
    b = torch.empty((7, 12), device="meta")
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(first, b)
    assert wrapper.launches == 0
    launched = []
    monkeypatch.setattr(_build, "check_cuda_tensors", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch",
                        lambda n, device, *args: launched.append(
                            (n, tuple(getattr(a, "value", a) for a in args
                                      if not isinstance(a, torch.Tensor)))))
    out = wrapper(first, b)
    assert out.device.type == "meta"
    assert out.shape == ((7,) if name == "l2sq_rowwise" else (5, 7))
    from repro_torch.kernels import tuning
    if name == "l2sq_rowwise":   # (N, K) and the plan: K = 12, float4s
        plan = tuning.rowwise_plan(7, 12)
        assert plan.route == "registers"
        assert launched == [("repro_l2sq_rowwise", (7, 12,
                                                    *plan.launch_args))]
    else:   # the split pass (K padded to 32), then the product kernel
        plan = tuning.matrix_plan(5, 7, 12)
        assert launched == [("repro_l2sq_split", (5, 7, 12, 32)), (
            "repro_l2sq_matrix", (5, 7, 32, plan.stages, plan.smem_bytes))]
    assert ops.launch_counts() == {k: int(k == name) for k in ops.KERNELS}


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default featurizer runs")
    refs = np.ones((3, 4), np.float32)
    labels = np.zeros(3, np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        knn.KNNFeaturizer(refs, labels, 2, k=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.knn_featurizer_from_numpy(refs, labels, 2, k=2)
    cpu = knn.KNNFeaturizer(refs, labels, 2, k=2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EmbeddingGBDTPipeline(cpu, None)


def test_pipeline_refuses_a_featurizer_on_another_device():
    from repro_torch.core.trees import ObliviousEnsemble
    ens = ObliviousEnsemble(
        torch.zeros((1, 1), dtype=torch.int32),
        torch.ones((1, 1), dtype=torch.int32), torch.zeros((1, 2, 2)),
        torch.zeros((1, 7)), torch.ones((7,), dtype=torch.int32))
    cpu = knn.KNNFeaturizer(np.ones((3, 4), np.float32),
                            np.zeros(3, np.int32), 2, k=2, device="cpu")
    pipe = EmbeddingGBDTPipeline(cpu, ens, embed_fn=lambda x: x[:, :4],
                                 device="cpu")
    assert pipe.predict(np.ones((2, 9), np.float32)).tolist() == [0, 0]
    cpu.device = torch.device("cuda", 0)     # as if it lived on a card
    with pytest.raises(ValueError, match="featurizer"):
        EmbeddingGBDTPipeline(cpu, ens, device="cpu")


def test_matrix_tiling_constants_match_the_kernel_source():
    from repro_torch.kernels import tuning
    src = (_build.CSRC / "l2sq_matrix.cu").read_text()
    for name, value in (("kTileM", tuning.MATRIX_TILE_M),
                        ("kTileN", tuning.MATRIX_TILE_N),
                        ("kKBlock", tuning.MATRIX_K_BLOCK),
                        ("kThreads", tuning.MATRIX_THREADS)):
        assert f"constexpr int {name} = {value};" in src
    assert {"l2sq_rowwise.cu", "l2sq_matrix.cu"} <= {
        p.name for p in _build._sources()}
    assert set(_build._SIGNATURES) >= {"repro_l2sq_rowwise",
                                       "repro_l2sq_split",
                                       "repro_l2sq_matrix"}


def test_head_shapes_fit_the_fused_and_histogram_kernels():
    # the kNN head: C = 20 outputs over F = 533 columns (the fused
    # kernel's 32-output instance), and a depth-4 level histogram of 533
    # features x 40 stats (20 gradients, 20 hessians) at 2,808 rows
    from repro_torch.kernels import fused_predict as fused_k
    from repro_torch.kernels import tuning
    plan = fused_k.tile_shape(533, True)
    assert (plan.rows, plan.stride, plan.route) == (64, 540, "shared")
    assert plan.tile_bytes <= tuning.SMEM_DEFAULT_BYTES
    assert tuning.output_slabs(20) == ((0, 20),)    # one slab of 32 lanes
    assert tuning.gather_plan(2841, 1000, 16, 20).lanes == 32
    for d in range(4):
        plan = tuning.hist_plan(533, 2808, 1 << d, 64, 40)
        assert plan.tile_bytes <= tuning.HIST_TILE_BYTES
        assert plan.smem_bytes <= tuning.SMEM_OPTIN_LIMIT
        assert plan.seg_tile * plan.n_tiles >= (1 << d) * 64


# --------------------------------------------------------------------------
# (g) on the card
# --------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the l2sq kernels have no CPU mode "
                    "(chip_smoke.py holds them on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sliced", [False, True],
                         ids=["whole", "one_row_in"])
@pytest.mark.parametrize("m,n,k", MATRIX_SHAPES + [
    (3, 2808, 512), (64, 128, 32), (50, 70, 533)])
def test_kernels_on_the_card_match_their_plain_versions(m, n, k, sliced,
                                                        card):
    # sliced: `a` starts one row into its buffer, 16-byte misaligned
    # whenever 4 k % 16 != 0 (K = 90, 533)
    rng = np.random.default_rng(7)
    a_all = torch.from_numpy(rng.normal(size=(m + 1, k)).astype(np.float32))
    a = a_all[1:] if sliced else a_all[:m]
    b = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    ga = a_all.to(card)[1:] if sliced else a.to(card)
    gb = b.to(card)
    got = l2dist.l2sq_matrix(ga, gb)
    assert torch.equal(got, l2dist.l2sq_matrix(ga, gb))
    assert (got >= 0).all()
    err = (got.cpu().double() - ref.l2sq_matrix(a, b).double()).abs()
    assert (err <= l2dist.matrix_limit(a, b)).all()
    # the rowwise kernel on all of b, on b one row in (16-byte misaligned
    # whenever 4 k % 16 != 0: the scalar route) and on one row: the same
    # bits twice, the kernel's lanes order bit for bit, the distance rule
    for rows, grows in ((b, gb), (b[1:], gb[1:]), (b[:1], gb[:1])):
        row = l2dist.l2sq_rowwise(ga[0], grows)
        assert torch.equal(row, l2dist.l2sq_rowwise(ga[0], grows))
        assert torch.equal(row.cpu(), ref.l2sq_rowwise_lanes(a[0], rows))
        err = (row.cpu().double()
               - ref.l2sq_rowwise(a[0], rows).double()).abs()
        assert (err <= l2dist.rowwise_limit(a[0], rows)).all()

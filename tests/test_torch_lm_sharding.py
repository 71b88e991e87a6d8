"""The port's sharding rule engine (`repro_torch.distributed.sharding`)
against the JAX package's, as metadata: no device is touched.

  * for all twenty configs (the ten architectures at full width and
    their smoke configs), on a (16, 16) ("data", "model") mesh and a
    (2, 16, 16) ("pod", "data", "model") mesh: `param_specs`, `fit_specs`
    of them over the abstract parameters, `opt_state_specs` (adamw,
    adafactor, sgd), and `batch_specs` / `cache_specs` at every workload
    shape equal JAX's spec for spec, path for path.  The port's meshes
    name "cpu" for every shard; JAX's are `repro.compat.abstract_mesh`;
  * specs compare through `_same`, which holds the port's
    `PartitionSpec` to JAX's equality: `test_partition_spec_equality_is_jaxs`
    pins that (no trailing-None normalisation under jax 0.9, one-name
    tuples stored as the name);
  * the assertions of tests/test_sharding.py, on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.compat import abstract_mesh  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.mesh import make_mesh  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CONFIGS = [(name, smoke) for name in jconfigs.ARCHS for smoke in (False,
                                                                  True)]
MAX_POS = 32768


def fake_mesh(shape=(16, 16), axes=("data", "model")):
    """The port's mesh: every shard on the CPU (metadata only)."""
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _same(ours, theirs) -> bool:
    """JAX's equality between a port spec and a JAX spec."""
    return isinstance(ours, P) and JP(*ours) == theirs \
        and tuple(ours) == tuple(theirs)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _jflat(tree):
    is_spec = lambda x: isinstance(x, JP)  # noqa: E731
    return [("/".join(str(p.key) for p in path), spec) for path, spec in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_spec)]


def _assert_same_tree(ours, theirs, what):
    want = _jflat(theirs)
    got = list(_flat(ours))
    assert [p for p, _ in got] == [p for p, _ in want], what
    for (path, a), (_, b) in zip(got, want):
        assert _same(a, b), (what, path, a, b)


def test_partition_spec_equality_is_jaxs():
    cases = [((None, "a", None), (None, "a")), ((("data",), None),
                                                ("data", None)),
             ((["a", "b"],), (("a", "b"),)), ((), ()), ((None,), ()),
             (("a",), ("a",))]
    for left, right in cases:
        assert (P(*left) == P(*right)) == (JP(*left) == JP(*right)), left
        assert tuple(P(*left)) == tuple(JP(*left)), left
    assert P("a") == ("a",)
    assert shd.normalized(P(None, "a", None)) == shd.normalized(
        P(None, "a")) == (None, "a")
    assert shd.normalized(P(None, None)) == ()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name,smoke", CONFIGS,
                         ids=[f"{n}{'-smoke' if s else ''}"
                              for n, s in CONFIGS])
def test_specs_equal_jax(name, smoke, mesh_name):
    shape, axes = MESHES[mesh_name]
    cfg, jcfg = configs.get(name, smoke=smoke), jconfigs.get(name,
                                                            smoke=smoke)
    mesh, jmesh = fake_mesh(shape, axes), abstract_mesh(shape, axes)
    ps = shd.param_specs(cfg, mesh, max_positions=MAX_POS)
    jps = jshd.param_specs(jcfg, jmesh, max_positions=MAX_POS)
    _assert_same_tree(ps, jps, "param_specs")
    abstract = tf.abstract_params(cfg, max_positions=MAX_POS)
    jabstract = jax.eval_shape(lambda: jtf.init_params(
        jcfg, jax.random.PRNGKey(0), max_positions=MAX_POS))
    _assert_same_tree(shd.fit_specs(ps, abstract, mesh),
                      jshd.fit_specs(jps, jabstract, jmesh), "fit_specs")
    for kind in ("adamw", "adafactor", "sgd"):
        _assert_same_tree(shd.opt_state_specs(ps, kind),
                          jshd.opt_state_specs(jps, kind), kind)
    for shape_name, wshape in SHAPES.items():
        from repro.configs.base import SHAPES as JSHAPES
        _assert_same_tree(shd.batch_specs(cfg, wshape, mesh),
                          jshd.batch_specs(jcfg, JSHAPES[shape_name], jmesh),
                          f"batch {shape_name}")
        _assert_same_tree(shd.cache_specs(cfg, wshape, mesh),
                          jshd.cache_specs(jcfg, JSHAPES[shape_name], jmesh),
                          f"cache {shape_name}")
    with pytest.raises(ValueError):
        shd.opt_state_specs(ps, "lion")


# --------------------------------------------------------------------------
# tests/test_sharding.py on the port
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_specs_cover_params_and_divide(arch):
    cfg = configs.get(arch)
    mesh = fake_mesh()
    shapes = dict(_flat(tf.param_shapes(cfg, max_positions=MAX_POS)))
    specs = dict(_flat(shd.param_specs(cfg, mesh, max_positions=MAX_POS)))
    assert shapes.keys() == specs.keys()
    for path, spec in specs.items():
        shape = shapes[path]
        assert len(spec) <= len(shape), (path, spec, shape)
        for i, ax in enumerate(spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            size = int(np.prod([mesh.shape[a] for a in axes]))
            assert shape[i] % size == 0, (path, shape, spec)


def test_tp_axes_on_dense_weights():
    cfg = configs.get("internlm2-20b")
    specs = shd.param_specs(cfg, fake_mesh())
    b = specs["blocks"]
    assert b["wq"] == P(None, "data", "model")     # fsdp + TP
    assert b["wo"] == P(None, "model", "data")
    assert b["w_gate"] == P(None, "data", "model")
    assert b["w_out"] == P(None, "model", "data")
    assert specs["embed"] == P(None, "model")


def test_moe_expert_vs_ffn_sharding():
    kimi = shd.param_specs(configs.get("kimi-k2-1t-a32b"), fake_mesh())
    assert kimi["blocks"]["w_gate"] == P(None, "model", "data", None)
    mixtral = shd.param_specs(configs.get("mixtral-8x22b"), fake_mesh())
    # 8 experts < 16-way axis -> TP inside expert ffn
    assert mixtral["blocks"]["w_gate"] == P(None, None, "data", "model")
    assert mixtral["blocks"]["w_out"] == P(None, None, "model", "data")


def test_kv_heads_not_divisible_fall_back():
    cfg = configs.get("glm4-9b")                    # kv=2 < 16
    specs = shd.param_specs(cfg, fake_mesh())
    assert specs["blocks"]["wk"] == P(None, None, None)
    assert specs["blocks"]["wq"] == P(None, None, "model")


def test_uneven_vocab_not_sharded():
    cfg = configs.get("internvl2-1b")               # vocab 151655
    specs = shd.param_specs(cfg, fake_mesh())
    assert specs["lm_head"][-1] is None


def test_batch_and_cache_specs():
    mesh = fake_mesh((2, 16, 16), ("pod", "data", "model"))
    cfg = configs.get("internlm2-20b")
    bs = shd.batch_specs(cfg, SHAPES["train_4k"], mesh)
    assert bs["tokens"] == P(("pod", "data"), None)
    bs1 = shd.batch_specs(cfg, SHAPES["long_500k"], mesh)
    assert bs1["tokens"] == P(None, None)           # batch 1: replicated
    cs = shd.cache_specs(cfg, SHAPES["decode_32k"], mesh)
    assert cs["k"][2] == "model"                    # sequence-sharded KV


def test_opt_state_specs_mirror_params():
    cfg = configs.get("glm4-9b")
    ps = shd.param_specs(cfg, fake_mesh())
    adam = shd.opt_state_specs(ps, "adamw")
    assert adam["m"]["blocks"]["wq"] == ps["blocks"]["wq"]
    fact = shd.opt_state_specs(ps, "adafactor")
    wq = ps["blocks"]["wq"]
    assert fact["vr"]["blocks"]["wq"] == P(*wq[:-1])
    assert fact["vc"]["blocks"]["wq"] == P(*wq[:-2], wq[-1])


"""The port's LM configs (`repro_torch.configs`) against the JAX package's:
every architecture and smoke config field for field, the parameter
counts, the workload shapes and their applicability, the registry's
lookup and its error, and the paper's GBDT workloads.  All exact."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.configs import gbdt_workloads as jworkloads  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import gbdt_workloads  # noqa: E402

NAMES = ([("full", n) for n in jconfigs.ARCHS]
         + [("smoke", n) for n in jconfigs.SMOKES])


def test_registry_lists_the_same_archs_in_order():
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    assert list(configs.SMOKES) == list(jconfigs.SMOKES)
    assert len(configs.ARCHS) == 10


@pytest.mark.parametrize("kind,name", NAMES,
                         ids=[f"{k}-{n}" for k, n in NAMES])
def test_config_and_param_counts_equal_jax(kind, name):
    smoke = kind == "smoke"
    got, want = configs.get(name, smoke), jconfigs.get(name, smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.resolved_head_dim == want.resolved_head_dim
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert configs.applicable_shapes(got) == jconfigs.applicable_shapes(want)


def test_glm4_9b_is_the_published_width():
    cfg = configs.get("glm4-9b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (40, 4096, 32, 2, 13696, 151552)
    assert cfg.param_count() == 9_399_435_264


def test_shapes_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert {k: v.tokens for k, v in configs.SHAPES.items()} \
        == {k: v.tokens for k, v in jconfigs.SHAPES.items()}
    assert configs.SUBQUADRATIC == jconfigs.SUBQUADRATIC


@pytest.mark.parametrize("smoke", [False, True])
def test_unknown_arch_raises_jax_key_error(smoke):
    with pytest.raises(KeyError) as got:
        configs.get("llama-7b", smoke)
    with pytest.raises(KeyError) as want:
        jconfigs.get("llama-7b", smoke)
    assert str(got.value) == str(want.value)


def test_gbdt_workloads_equal_jax():
    assert list(gbdt_workloads.WORKLOADS) == list(jworkloads.WORKLOADS)
    for name in jworkloads.WORKLOADS:
        got, want = gbdt_workloads.get(name), jworkloads.get(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)

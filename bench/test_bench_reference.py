"""The plain reference (`bench/reference`) against the program's own plain
versions on the CPU at a small size, and what the benchmark imports: no
module under `bench/` imports JAX or the JAX package (`repro`), and the
reference imports nothing of the program (`repro_torch`) either.
Top-level module names are compared whole, so `repro_torch` is not
`repro`."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import reference

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
JAX_NAMES = {"jax", "jaxlib", "flax", "repro"}


def _model(seed, t=37, d=5, f=9, b=15, c=3, n=301):
    g = torch.Generator().manual_seed(seed)
    borders = torch.sort(torch.randn((b, f), generator=g), dim=0).values
    arrays = dict(
        split_features=torch.randint(0, f, (t, d), generator=g,
                                     dtype=torch.int32),
        split_bins=torch.randint(1, b + 1, (t, d), generator=g,
                                 dtype=torch.int32),
        leaf_values=torch.randn((t, 1 << d, c), generator=g),
        borders=borders, n_borders=torch.full((f,), b, dtype=torch.int32),
        base_score=torch.randn((c,), generator=g))
    x = torch.randn((n, f), generator=g)
    x[torch.rand((n, f), generator=g) < 0.05] = torch.nan
    x[0, :] = borders[3]            # values equal to a border
    return arrays, x


@pytest.mark.parametrize("c", [1, 3, 7])
def test_apply_equals_the_programs_cpu_plan(c):
    from repro_torch.core.predictor import Predictor
    from repro_torch.core.trees import ObliviousEnsemble
    from repro_torch.kernels import ref

    a, x = _model(c, c=c)
    bins = reference.binarize(x, a["borders"])
    assert torch.equal(bins, ref.binarize(x, a["borders"]).long())
    idx = reference.leaf_index(bins, a["split_features"], a["split_bins"])
    assert torch.equal(idx, ref.leaf_index(bins.int(), a["split_features"],
                                           a["split_bins"]).long())
    plan = Predictor.build(ObliviousEnsemble(**a), device="cpu")
    want = reference.raw_scores(bins, a["split_features"], a["split_bins"],
                                a["leaf_values"], a["base_score"],
                                row_block=64, tree_block=8)
    np.testing.assert_allclose(plan.raw(x).numpy(), want.numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(plan.proba(x).numpy(),
                               reference.proba(want).numpy(), rtol=0,
                               atol=1e-6)


def test_lower_precision_sums_tree_by_tree():
    a, x = _model(5, t=200)
    bins = reference.binarize(x, a["borders"])
    args = (bins, a["split_features"], a["split_bins"], a["leaf_values"],
            a["base_score"])
    exact = reference.raw_scores(*args)
    f32 = reference.raw_scores(*args, dtype=torch.float32)
    bf16 = reference.raw_scores(*args, dtype=torch.bfloat16)
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert (f32.double() - exact).abs().max() < 1e-4
    assert (bf16.double() - exact).abs().max() > 1e-2


def test_tree_growing_pieces_equal_the_programs():
    """Histogram, split gains and leaf values against the program's plain
    histogram, `split_sums.level_gains` and Newton step."""
    from repro_torch.core import losses, split_sums
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(3)
    n, f, nb, c, leaves = 500, 6, 17, 3, 4
    bins = torch.randint(0, nb, (n, f), generator=g)
    leaf = torch.randint(0, leaves, (n,), generator=g)
    raw = torch.randn((n, c), generator=g)
    y = torch.randint(0, c, (n,), generator=g, dtype=torch.int32)
    gh = reference.grad_hess_multiclass(raw.double(), y)
    mg, mh = losses.MultiClass(n_classes=c).grad_hess(raw, y)
    np.testing.assert_allclose(gh.numpy(), torch.cat([mg, mh], 1).numpy(),
                               rtol=1e-6, atol=1e-7)
    hist = reference.level_histogram(bins, leaf, gh, n_leaves=leaves,
                                     n_bins=nb, feature_block=4)
    theirs = ref.histogram(bins.t().contiguous().to(torch.uint8),
                           leaf.int(), gh.float(), n_bins=nb,
                           n_leaves=leaves)
    np.testing.assert_allclose(hist.reshape(f, leaves * nb, 2 * c).numpy(),
                               theirs.numpy(), rtol=1e-5, atol=1e-4)
    n_borders = torch.full((f,), nb - 1)
    gain = reference.split_gains(hist, n_borders, 3.0)
    their_gain, nonempty = split_sums.level_gains(
        theirs.view(f, leaves, nb, 2 * c), 3.0)
    valid = torch.isfinite(gain)
    assert torch.equal(valid[:, 1:], nonempty[:, 1:])
    np.testing.assert_allclose(gain[valid].numpy(),
                               their_gain[valid].numpy(), rtol=1e-4)
    w = reference.leaf_values(gh, leaf, n_leaves=leaves, learning_rate=0.5,
                              l2=3.0)
    sums = torch.zeros((leaves, 2 * c), dtype=torch.float64).index_add_(
        0, leaf, gh)
    np.testing.assert_allclose(w.numpy(), (-0.5 * sums[:, :c]
                                           / (sums[:, c:] + 3.0)).numpy())


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not _imports(path) & JAX_NAMES, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert _imports(path) <= {"__future__", "torch", "numpy",
                                  "reference"}, path


def test_a_run_loads_no_jax_module():
    """A whole run of a cell, in a fresh process, leaves no module of JAX
    or the JAX package in `sys.modules`; the reference alone loads none of
    the program."""
    code = f"""
import sys, pathlib
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]
import reference
assert not [m for m in sys.modules if m.split('.')[0] == 'repro_torch']
from benchlib import harness, spec
cell = spec.cell('covertype-apply', pathlib.Path({str(ROOT)!r}))
r = harness.run_cell(cell, 7, 0.05, True, kind='cpu',
                     overrides={{'trees': 8, 'test_rows': 64}})
assert r['correct'], r['checks']
print(harness.loaded_jax())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

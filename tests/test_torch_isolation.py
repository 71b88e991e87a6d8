"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.predictor import Predictor  # noqa: E402
from repro_torch.kernels import binarize as binarize_k  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.serving.engine import GBDTServer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "repro")


def test_fresh_import_loads_no_jax_and_no_repro_module():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, check=True)
    loaded = out.stdout.split()
    assert "repro_torch.serving.engine" in loaded
    assert "repro_torch.kernels._build" in loaded
    assert "repro_torch.distributed.mesh" in loaded
    assert "repro_torch.analysis.checker" in loaded
    assert "repro_torch.launch.analyze" in loaded
    assert "repro_torch.configs" in loaded
    assert "repro_torch.models.transformer" in loaded
    assert "repro_torch.models.ssm" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         sorted((ROOT / "examples" / "torch").glob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), \
            f"{path.name}:{node.lineno} imports {names}"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default plan runs")
    ens = _tiny_ensemble()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor.build(ens)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GBDTServer(ens)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_local_mesh()
    assert Predictor.build(ens, device="cpu").device.type == "cpu"


def test_wrapper_off_the_cpu_launches_or_raises():
    # a tensor that is neither on the CPU nor on the card never reaches
    # the plain version
    x = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        binarize_k.binarize(x, torch.empty((2, 3), device="meta"))
    assert binarize_k.binarize.launches == 0


def _tiny_ensemble():
    from repro_torch.core.trees import ObliviousEnsemble
    return ObliviousEnsemble(
        torch.zeros((2, 1), dtype=torch.int32),
        torch.ones((2, 1), dtype=torch.int32),
        torch.zeros((2, 2, 1)), torch.zeros((1, 3)),
        torch.ones((3,), dtype=torch.int32))

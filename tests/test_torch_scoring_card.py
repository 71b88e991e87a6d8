"""The bulk scorer's side-stream pipeline on the card.

On a CUDA plan `BulkScorer`'s prefetch worker copies each chunk to the
card and binarizes it on a side stream, and the main thread orders its
stream after the worker's event and copies scores back through pinned
buffers (`src/repro_torch/scoring/scorer.py`).  None of that has a CPU
mode, so this test skips without a card; it imports no JAX, so
`python -m pytest -m cuda tests/test_torch_scoring_card.py` runs where
JAX is not installed.  The CPU parity tests are in
`tests/test_torch_scoring.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.predictor import Predictor  # noqa: E402
from repro_torch.core.trees import ObliviousEnsemble  # noqa: E402
from repro_torch.kernels import ops, registry, tuning  # noqa: E402
from repro_torch.scoring import (ArraySource, BulkScorer,  # noqa: E402
                                 ScoreConfig)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the side-stream prefetch and the "
                    "kernels it launches have no CPU mode (chip_smoke.py "
                    "drives the bulk path on the H100)")
    return torch.device("cuda")


def _ensemble(seed=3, n_trees=40, depth=6, n_features=30, n_borders=9,
              n_outputs=3):
    rng = np.random.default_rng(seed)
    return ObliviousEnsemble(
        torch.from_numpy(rng.integers(0, n_features, (n_trees, depth))
                         .astype(np.int32)),
        torch.from_numpy(rng.integers(1, n_borders, (n_trees, depth))
                         .astype(np.int32)),
        torch.from_numpy(rng.normal(size=(n_trees, 2 ** depth, n_outputs))
                         .astype(np.float32)),
        torch.from_numpy(np.sort(rng.normal(size=(n_borders, n_features)),
                                 0).astype(np.float32)),
        torch.full((n_features,), n_borders, dtype=torch.int32))


CHUNK = tuning.PREFETCH_MIN_CHUNK_ROWS     # the worker's smallest chunk


class _FailingSource(ArraySource):
    def read(self, start, stop):
        if start >= CHUNK:
            raise OSError("disk on fire")
        return super().read(start, stop)


@pytest.mark.cuda
@pytest.mark.parametrize("output", ["raw", "proba", "classify"])
@pytest.mark.parametrize("prequantize", [True, False],
                         ids=["pool", "float"])
def test_side_stream_pipeline_on_the_card(output, prequantize, card):
    """prefetch_depth=2 (the side stream, a worker thread) gives the bits
    of prefetch_depth=0 (no worker), of chunks too small for the worker
    (synchronous on the card) and of the plan's own entry; one binarize
    launch a chunk on the pool route; a worker's error reaches the
    caller."""
    plan = Predictor.build(_ensemble(), device=card)
    x = np.random.default_rng(0).normal(size=(5 * CHUNK, 30)) \
        .astype(np.float32)
    runs = []
    for chunk, depth, used in ((CHUNK, 2, 2), (CHUNK, 0, 0),
                               (CHUNK // 2, 2, 0)):
        registry.reset_call_stats()
        ops.reset_launch_counts()
        cfg = ScoreConfig(chunk_rows=chunk, output=output,
                          prequantize=prequantize, prefetch_depth=depth)
        runs.append(BulkScorer(plan, cfg).score(ArraySource(x)))
        torch.cuda.synchronize()
        assert runs[-1].metrics["prefetch_depth"] == used
        n_chunks = len(x) // chunk
        launches = ops.launch_counts()
        assert launches["binarize"] == (n_chunks if prequantize else 0)
        assert launches["fused_predict"] == (0 if prequantize else n_chunks)
    assert runs[0].chunk_shapes == (CHUNK,)
    for run in runs[1:]:
        np.testing.assert_array_equal(runs[0].output, run.output)
    want = getattr(plan, output)(x).cpu().numpy().astype(np.float32)
    np.testing.assert_array_equal(runs[0].output,
                                  want.reshape(runs[0].output.shape))
    with pytest.raises(OSError, match="disk on fire"):
        BulkScorer(plan, ScoreConfig(chunk_rows=CHUNK, output=output,
                                     prequantize=prequantize)) \
            .score(_FailingSource(x[:2 * CHUNK + 100]))

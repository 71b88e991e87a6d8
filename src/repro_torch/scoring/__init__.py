"""Bulk scoring: streaming out-of-core dataset apply on the card.

The port's counterpart of `src/repro/scoring/`: the offline half of
`repro_torch.serving`, applying one or many prepared `Predictor` plans to
datasets that never fit in one batch (or in memory), at O(chunk) host
memory.

    from repro_torch.scoring import (BulkScorer, ScoreConfig,
                                     NpyMemmapSource, NpySink)

    result = BulkScorer(plan, ScoreConfig(output="raw")).score(
        NpyMemmapSource("features.npy"), NpySink("scores.npy"))
"""
from repro_torch.scoring import scorer, sinks, sources  # noqa: F401
from repro_torch.scoring.scorer import (BulkScorer, ChunkSpan,  # noqa: F401
                                        ScoreConfig, ScoreResult,
                                        ScoringMetrics, plan_chunks)
from repro_torch.scoring.sinks import (ArraySink, NpySink,  # noqa: F401
                                       ScoreSink, StatsSink, TopKSink)
from repro_torch.scoring.sources import (ArraySource,  # noqa: F401
                                         NpyMemmapSource, RowSource,
                                         SyntheticSource, iter_chunks)

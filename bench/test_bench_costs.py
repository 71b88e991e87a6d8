"""`bench/costs.py`, the frozen copy of the program's cost formulas, against
`repro_torch.launch.hlo_analysis.launch_cost` of the launches each cell's
timed path makes, recorded on a fake card (nothing runs), at the cells'
own shapes."""
import pathlib

import pytest
import torch

import costs
from benchlib import spec

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _config(name):
    return spec.load_json(ROOT / "bench" / "configs" / f"{name}.json")


def _ensemble(cfg):
    from repro_torch.core.trees import ObliviousEnsemble
    t, d, f = cfg["trees"], cfg["depth"], cfg["features"]
    b, c = cfg["border_count"], cfg["n_outputs"]
    return ObliviousEnsemble(
        split_features=torch.zeros((t, d), dtype=torch.int32),
        split_bins=torch.ones((t, d), dtype=torch.int32),
        leaf_values=torch.zeros((t, 1 << d, c)),
        borders=torch.arange(b * f, dtype=torch.float32).view(b, f),
        n_borders=torch.full((f,), b, dtype=torch.int32))


def _launches(fn):
    from repro_torch.analysis import trace_tools as tt
    with tt.recording() as trace:
        fn()
    return [e.record for e in trace.launches()]


@pytest.mark.parametrize("config,rows", [
    ("covertype", 139440),          # covertype-apply's call
    ("covertype", 34860),           # a shard of covertype-apply-mesh4's
    *[("year_msd", b) for b in (16, 32, 64, 128, 256)],   # serve buckets
])
def test_fused_predict_cost_matches_the_program(config, rows):
    from repro_torch.analysis.checker import fake_cuda_plan
    from repro_torch.analysis import trace_tools as tt
    from repro_torch.launch import hlo_analysis as hlo

    cfg = _config(config)
    mode = tt.new_fake_mode()
    plan = fake_cuda_plan(_ensemble(cfg), mode)
    assert (plan.config.strategy, plan.config.layout) == ("fused", "soa")
    with tt.recording(mode) as trace:
        plan.proba(torch.empty((rows, cfg["features"]), device=plan.device))
    recs = [e.record for e in trace.launches()]
    assert [r.name.startswith("repro_fused_predict") for r in recs] == [True]
    got = hlo.launch_cost(recs[0])
    want = costs.fused_predict(rows, cfg["features"], cfg["border_count"],
                               cfg["trees"], cfg["depth"], cfg["n_outputs"])
    assert (got["bytes"], got["ops"]) == want
    assert costs.bound_s(*want) * 1e3 == pytest.approx(got["bound_ms"],
                                                       rel=1e-12)


@pytest.mark.parametrize("n_leaves,n_bins,features", [
    *[(1 << d, 129, 54) for d in range(8)],      # the levels of a tree
    (256, 1, 1),                                 # the leaf sums
])
def test_histogram_cost_matches_the_program(n_leaves, n_bins, features):
    from repro_torch.kernels import ops
    from repro_torch.launch import hlo_analysis as hlo

    rows, stats = 325360, 14

    def launch():
        dev = torch.device("cuda", 0)
        ops.histogram(torch.empty((features, rows), dtype=torch.uint8,
                                  device=dev),
                      torch.empty((rows,), dtype=torch.int32, device=dev),
                      torch.empty((rows, stats), device=dev),
                      n_bins=n_bins, n_leaves=n_leaves, backend="cuda")
    recs = _launches(launch)
    assert [r.name for r in recs] == ["repro_histogram"]
    got = hlo.launch_cost(recs[0])
    want = costs.histogram(features, rows, n_leaves, n_bins, stats)
    assert (got["bytes"], got["ops"]) == want


def test_compares_is_a_binary_search():
    from repro_torch.launch import hlo_analysis as hlo
    for n in (0, 1, 2, 3, 127, 128, 255, 256, 60000):
        assert costs.compares(n) == hlo.compares(n)
    assert (costs.FP32_FLOPS, costs.HBM_BW) == (hlo.FP32_FLOPS, hlo.HBM_BW)


def test_train_iteration_counts_its_histograms():
    """The iteration's count holds each level's histogram, the leaf sums,
    and the split, gradient and update work on top."""
    rows, f, bins, depth, c = 325360, 54, 129, 8, 7
    moved, ops = costs.train_iteration(rows, f, bins, depth, c)
    hist = [costs.histogram(f, rows, 1 << d, bins, 2 * c)
            for d in range(depth)] + [costs.histogram(1, rows, 1 << depth,
                                                      1, 2 * c)]
    assert moved > sum(m for m, _ in hist)
    assert ops > sum(o for _, o in hist)
    split_ops = sum(8 * f * (1 << d) * bins * c for d in range(depth))
    assert ops == sum(o for _, o in hist) + split_ops + 9 * rows * c


def test_apply_call_adds_the_transform():
    m, o = costs.fused_predict(10, 54, 128, 100, 8, 7)
    assert costs.apply_call(10, 54, 128, 100, 8, 7) == (m, o + 5 * 10 * 7)
    m1, o1 = costs.fused_predict(10, 90, 128, 100, 6, 1)
    assert costs.apply_call(10, 90, 128, 100, 6, 1) == (m1 + 4 * 10,
                                                        o1 + 5 * 10)

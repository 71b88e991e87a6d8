"""The port's sharded MoE expert products (`models/moe._expert_product`)
on gloo ranks spawned through `tests/torch_dist_worker.py`, on the CPU
(`chip_smoke.lm_moe_pair`, which the smoke's `lm_dist` ranks also run on
the cards):

  * every pair of placements of the activations (whole, or sharded on
    groups, experts or the contraction) and of the weights (whole, or
    sharded on experts, contraction or output) on each dim of a (2, 2)
    mesh: the output and both gradients equal the plain einsum's within
    1e-12 (float64);
  * `moe_ffn` of the smoke MoE configs (mixtral-8x22b with its d_ff
    sharded over model, also with FSDP; kimi-k2 with its experts over
    model, also as expert2d), weights placed by `param_specs` and tokens
    sharded on data, on (2, 2) and (1, 4): output and gradients within
    rtol = atol = 1e-4 of the one-device run, and the expert products'
    FLOPs a device (forward and backward, by `hlo_analysis.OpCounter`)
    exactly a quarter of the one-device run's: no weight dim is gathered
    where the work could stay split.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from test_torch_lm_distributed import result, spawn_group  # noqa: E402

TOL = 1e-4              # moe_ffn against the one-device run (rtol = atol)
EXACT = 1e-12           # a float64 product against the plain einsum
CASES = [chip_smoke.lm_moe_key(name, over)
         for name, over in chip_smoke.LM_MOE_CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_group("moe", 4, str(tmp_path_factory.mktemp("moe")))


def test_every_placement_pair_gives_the_plain_product(runs):
    errs = result(runs, "products_2x2")
    assert len(errs) == 16 * 16
    worst = max(errs, key=errs.get)
    assert errs[worst] <= EXACT, (worst, errs[worst])


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("case", CASES)
def test_moe_ffn_sharded_equals_one_device_at_a_quarter_of_the_flops(
        runs, mesh, case):
    rec = result(runs, f"moe_{mesh}")[case]
    one, sharded = rec["one"], rec["sharded"]
    np.testing.assert_allclose(sharded["y"], one["y"], rtol=TOL, atol=TOL)
    for name, want in one["grads"].items():
        np.testing.assert_allclose(sharded["grads"][name], want, rtol=TOL,
                                   atol=TOL, err_msg=name)
    assert one["flops"] > 0
    assert sharded["flops"] * 4 == one["flops"], rec["placements"]

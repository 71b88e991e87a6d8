"""The LM training cell (`kimi-k2-train-8k`) on the CPU at small sizes,
through the harness as `test_bench_harness.py` runs its cells: the run
comes out correct, traced and untraced; each control (the reference a
step below float32, and its parameters kept in bfloat16 under float32
sums) and each fault planted under the timed path come out not correct;
`costs_lm` at the cell's shapes; the readers of its per-layer metrics on
hand-made spans."""
import pathlib

import pytest
import torch

from benchlib import harness, spec

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
SEED = 2 ** 31 + 12345
CELL = "kimi-k2-train-8k"

# every width cut to a CPU test's size; 16 experts, 4 held (4 .. 7), 4 a
# token; the traffic the cell's, on 2 sequences of 64
SMALL_CONFIG = {
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
    "q_lora_rank": 48, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 96,
    "moe_intermediate_size": 24, "n_routed_experts": 4,
    "router_experts": 16, "expert_offset": 4, "num_experts_per_tok": 4,
    "num_hidden_layers": 3, "vocab_size": 256,
    "rope_scaling": {"beta_fast": 1, "beta_slow": 1, "factor": 32,
                     "mscale": 1, "mscale_all_dim": 1,
                     "original_max_position_embeddings": 16,
                     "type": "yarn"}}
SMALL_MIX = {"seq_len": 64, "doc_median": 20, "min_steps": 3,
             "sample_elements": 1000}
SECONDS = 0.3

# `test_bench_harness.SMALL` holds a small size for every cell of
# BENCHMARK.json; this cell's is the one above, and its checks are here
import test_bench_harness                               # noqa: E402
test_bench_harness.SMALL.setdefault(CELL, (SMALL_CONFIG, SMALL_MIX))


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(*, trace=False, control=None, seed=SEED):
    return harness.run_cell(spec.cell(CELL, ROOT), seed, SECONDS, trace,
                            kind="cpu", overrides=SMALL_CONFIG,
                            mix=SMALL_MIX, control=control)


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct_on_the_cpu(trace):
    r = _run(trace=trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= SMALL_MIX["min_steps"] and r["failed"] == 0
    cell = spec.cell(CELL, ROOT)
    if trace:
        # the card's metrics read nothing here
        assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert sorted(r["metrics"]) == ["setup_s", "train_step_ms"]
        assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("control", list(harness.CONTROLS["float32"]))
def test_each_control_is_not_correct(control):
    r = _run(control=control)
    assert not r["correct"], r["checks"]
    assert r["checks"]["param_update_err"]["value"] > \
        r["checks"]["param_update_err"]["limit"]


def _no_scaling(monkeypatch):
    """The routed experts' weights left unscaled (routed_scaling_factor
    left out)."""
    from repro_torch.models import moe
    original = moe.sigmoid_route

    def unscaled(*args, **kw):
        return original(*args, **{**kw, "scaling": 1.0})
    monkeypatch.setattr(moe, "sigmoid_route", unscaled)


def _no_update(monkeypatch):
    """The optimizer's update computed and not applied."""
    from repro_torch.training import optimizer
    original = optimizer.adamw

    def lazy(*args, **kw):
        opt = original(*args, **kw)

        def update(grads, state, params, *, inplace=False):
            upd, new = opt.update(grads, state, params, inplace=inplace)
            return {k: torch.zeros_like(v) if not isinstance(v, dict) else
                    _zeros(v) for k, v in upd.items()}, new
        return optimizer.Optimizer(opt.init, update, opt.kind,
                                   opt.global_norm)
    monkeypatch.setattr(optimizer, "adamw", lazy)


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _halve_the_held_load(monkeypatch):
    """Each held expert computes only the first half of its selections (a
    capacity that drops the rest)."""
    from repro_torch.models import moe
    original = moe.hold

    def dropping(route, offset, n_held):
        held = original(route, offset, n_held)
        rows = [r // 2 for r in held.rows]
        start = torch.cumsum(torch.tensor([0] + held.rows[:-1]), 0)
        keep = torch.cat([torch.arange(s, s + r) for s, r in
                          zip(start.tolist(), rows)]).long()
        return held._replace(selections=held.selections[keep],
                             tokens=held.tokens[keep], rows=rows)
    monkeypatch.setattr(moe, "hold", dropping)


def _no_routed_experts(monkeypatch):
    """The held experts' part left out of the layer's output."""
    from repro_torch.models import moe
    original = moe.routed_held_ffn

    def none(x, *args, **kw):
        return original(x, *args, **kw) * 0
    monkeypatch.setattr(moe, "routed_held_ffn", none)


def _router_cut_from_the_loss(monkeypatch):
    """The routing weights detached: the router learns from the balance
    loss alone."""
    from repro_torch.models import moe
    original = moe.sigmoid_route

    def detached(*args, **kw):
        route = original(*args, **kw)
        return route._replace(weights=route.weights.detach())
    monkeypatch.setattr(moe, "sigmoid_route", detached)


FAULTS = [_no_scaling, _no_update, _halve_the_held_load,
          _no_routed_experts, _router_cut_from_the_loss]


@pytest.mark.parametrize("fault", FAULTS,
                         ids=[f.__name__[1:] for f in FAULTS])
def test_a_fault_under_the_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = _run()
    assert not r["correct"], r["checks"]


def test_an_expert_no_token_chose_reads_no_error():
    """A sampled held expert that neither side routed a row to has a zero
    first moment on both sides: no error, where 0 / 0 would read 1."""
    from benchlib.drivers.lm_train import size_err, update_err
    zero = torch.zeros(5)
    assert update_err(zero, zero)[0] == 0.0
    assert update_err(torch.ones(5), zero)[0] == float("inf")
    assert update_err(zero, torch.ones(5))[0] == 1.0
    assert size_err(torch.tensor(0.0), torch.tensor(0.0)) == 0.0
    assert size_err(torch.tensor(1.0), torch.tensor(2.827)) == \
        pytest.approx(1 - 1 / 2.827)


# -- the yardstick ----------------------------------------------------------
def test_costs_at_the_cells_shapes():
    import costs_lm
    cell = spec.cell(CELL, ROOT)
    c, mix = cell.config, cell.traffic
    B, S = mix["batch"], mix["seq_len"]
    moved, ops = costs_lm.mla_attention(B, S, 64, 192, 128)
    assert ops == 2 * B * 64 * (S * (S + 1) // 2) * 320
    assert moved == 2 * B * S * 64 * (2 * 192 + 2 * 128)
    # ~2.75 TFLOP of forward: 2.8 ms at the bfloat16 peak
    assert costs_lm.bound_s(moved, ops) == pytest.approx(2.78e-3, rel=0.01)
    rows = [341] * 8
    moved, ops = costs_lm.expert_product(rows, 7168, 2048)
    assert ops == 6 * 8 * 341 * 7168 * 2048
    assert moved == 2 * (3 * 8 * 7168 * 2048 + 2 * 8 * 341 * 7168)
    lm = {"batch": B, "seq_len": S, "d_model": c["hidden_size"],
          "heads": 64, "q_lora": 1536, "kv_lora": 512, "nope": 128,
          "rope": 64, "v_dim": 128, "d_ff": 18432, "moe_d_ff": 2048,
          "shared": 1, "experts": 384, "dense_layers": 1, "layers": 5,
          "vocab": c["vocab_size"]}
    assert costs_lm.mla_params(lm) == 101_122_048
    held = B * S * 8 * 8 / 384 * 4
    step = costs_lm.train_step(lm, held)
    # 6 x tokens x the matrix parameters a token touches here (the held
    # experts by their rows), plus 3 x five causal attention forwards
    mla = 101_122_048
    dense = mla + 3 * 7168 * 18432                  # 497.5 M
    moe = mla + 3 * 7168 * 2048 + 7168 * 384        # shared and router
    per_token = dense + 4 * moe + 7168 * 20480      # and the head
    attn = 2 * B * 64 * (S * (S + 1) // 2) * 320
    assert step == int(6 * B * S * per_token + 6 * held * 3 * 7168 * 2048
                       + 3 * 5 * attn)
    assert 1.6e14 < step < 1.7e14


def test_readers_read_their_spans():
    import costs_lm
    shapes = str([(2, 8192, 64, 192), (2, 8192, 64, 192),
                   (2, 8192, 64, 128)])
    events = [
        {"ph": "X", "name": "dispatch/mla_attention",
         "args": {"shapes": shapes, "device_ms": 5.0}},
        {"ph": "X", "name": "dispatch/expert_product",
         "args": {"rows": [300, 0, 400], "D": 7168, "F": 2048,
                  "device_ms": 1.0}},
        {"ph": "X", "name": "train/moe_layer", "args": {"device_ms": 30.0}},
        {"ph": "X", "name": "train/moe_layer", "args": {"device_ms": 20.0}},
        {"ph": "X", "name": "train/step", "args": {"device_ms": 500.0}}]
    facts = {"events": events}
    got = spec.metric_reader("mla_attention_roofline.kimi")(facts)
    need = costs_lm.bound_s(*costs_lm.mla_attention(2, 8192, 64, 192, 128))
    assert got == pytest.approx(100 * need / 5e-3)
    got = spec.metric_reader("expert_product_roofline.kimi")(facts)
    need = costs_lm.bound_s(*costs_lm.expert_product([300, 0, 400], 7168,
                                                     2048))
    assert got == pytest.approx(100 * need / 1e-3)
    assert spec.metric_reader("moe_share.kimi")(facts) == pytest.approx(10)
    lm = {"batch": 2, "seq_len": 64, "d_model": 64, "heads": 4,
          "q_lora": 48, "kv_lora": 32, "nope": 16, "rope": 8, "v_dim": 16,
          "d_ff": 96, "moe_d_ff": 24, "shared": 1, "experts": 16,
          "dense_layers": 1, "layers": 3, "vocab": 256}
    facts = {"on_card": True, "lm": lm, "steps": 2, "step_s": 0.5,
             "held_selections": [100.0, 140.0]}
    want = 100 * costs_lm.train_step(lm, 120.0) / costs_lm.BF16_FLOPS / 0.5
    assert spec.metric_reader("lm_train_mfu")(facts) == pytest.approx(want)

"""The mla_moe training step's spans (`obs/trace.py`), on the CPU at
Kimi-K2-Instruct's smoke configuration: while traced, every step records
`train/step`, each layer `train/mla_layer` and `dispatch/mla_attention`
(with its q / k / v shapes), each MoE layer `train/moe_layer`, `moe/route`
(tokens, selections held, the largest and smallest held load, no dropped
selection, and the count of those a cut leaves out) and `dispatch/expert_product` (each held expert's rows, D and
F); remat's recomputation records the layer's inner spans again.  The
step's outputs (metrics, parameters, optimizer state) are the same bits
traced and untraced."""
import ast
import dataclasses

import pytest
import torch

from repro_torch.configs import kimi_k2_instruct as kk
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import transformer as tf
from repro_torch.obs.trace import get_tracer
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)


def _batches(cfg):
    g = torch.Generator().manual_seed(4)
    while True:
        t = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
        yield {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _train(cfg, tmp_path, traced: bool, steps: int = 2):
    trainer = Trainer(cfg, make_local_mesh(1, device="cpu"),
                      str(tmp_path / f"ckpt{int(traced)}"),
                      TrainerConfig(total_steps=50, ckpt_every=0,
                                    peak_lr=1e-2), seed=5)
    trainer.initialize()
    tracer = get_tracer()
    tracer.clear()
    if traced:
        tracer.enable()
    try:
        history = trainer.train(_batches(cfg), num_steps=steps)
    finally:
        tracer.disable()
    return trainer, history, tracer.events()


@pytest.mark.parametrize("remat", [False, True])
def test_spans_while_traced(tmp_path, remat):
    cfg = dataclasses.replace(kk.SMOKE, remat=remat)
    _, history, events = _train(cfg, tmp_path, True)
    names = [e["name"] for e in events if e["ph"] == "X"]
    n_moe = cfg.n_layers - cfg.first_k_dense
    passes = 2 if remat else 1          # the forward, and remat's again
    assert names.count("train/step") == 2
    assert names.count("train/mla_layer") == 2 * passes * cfg.n_layers
    assert names.count("dispatch/mla_attention") == \
        2 * passes * cfg.n_layers
    for name in ("train/moe_layer", "moe/route", "dispatch/expert_product"):
        assert names.count(name) == 2 * passes * n_moe, name
    routes = [e["args"] for e in events if e["name"] == "moe/route"]
    products = [e["args"] for e in events
                if e["name"] == "dispatch/expert_product"]
    for r, p in zip(routes, products):
        assert r["tokens"] == 32 and r["dropped"] == 0
        assert r["selections_held"] == sum(p["rows"])
        assert r["load_max"] == max(p["rows"])
        assert r["load_min"] == min(p["rows"])
        assert len(p["rows"]) == cfg.held
        assert (p["D"], p["F"]) == (cfg.d_model, cfg.moe_d_ff)
    held = sum(r["selections_held"] for r in routes[:passes * n_moe:passes]
               ) if not remat else None
    if held is not None:
        assert held == history[0]["held_selections"]
    attn = next(e["args"] for e in events
                if e["name"] == "dispatch/mla_attention")
    q, k, v = ast.literal_eval(attn["shapes"])
    assert q == (2, 16, cfg.n_heads, cfg.qk_head_dim) and q == k
    assert v == (2, 16, cfg.n_heads, cfg.v_head_dim)


def test_a_step_is_the_same_traced_and_untraced(tmp_path):
    cfg = dataclasses.replace(kk.SMOKE, remat=True)
    plain, h0, events = _train(cfg, tmp_path, False)
    assert events == []
    traced, h1, _ = _train(cfg, tmp_path, True)
    assert h0 == h1
    for (path, a), (_, b) in zip(tf.tree_leaves(plain.params),
                                 tf.tree_leaves(traced.params)):
        assert torch.equal(a, b), path
    for (path, a), (_, b) in zip(tf.tree_leaves(plain.opt_state),
                                 tf.tree_leaves(traced.opt_state)):
        assert torch.equal(a, b), path


def test_the_route_span_counts_selections_a_held_expert_left_out(
        tmp_path, monkeypatch):
    """`moe/route`'s `dropped` is the route's selections of the held
    experts less the ones `hold` hands on: 0 dropless, and what a cut
    (here each held expert's second half) leaves out."""
    from repro_torch.models import moe
    original, cut = moe.hold, []

    def halved(route, offset, n_held):
        held = original(route, offset, n_held)
        rows = [r // 2 for r in held.rows]
        keep = torch.cat([torch.arange(s, s + r) for s, r in zip(
            [sum(held.rows[:e]) for e in range(n_held)], rows)]).long()
        cut.append(sum(held.rows) - sum(rows))
        return held._replace(selections=held.selections[keep],
                             tokens=held.tokens[keep], rows=rows)
    monkeypatch.setattr(moe, "hold", halved)
    cfg = dataclasses.replace(kk.SMOKE, remat=False)
    _, _, events = _train(cfg, tmp_path, True, steps=1)
    dropped = [e["args"]["dropped"] for e in events
               if e["name"] == "moe/route"]
    assert dropped == cut and sum(cut) > 0

"""The port's Kimi-K2-Instruct (`configs/kimi_k2_instruct.py`, family
mla_moe) against the benchmark's plain reference (`bench/reference/
kimi_k2.py`), on the CPU at small sizes, float32 compute unless a test
says otherwise:

  * YaRN's frequencies and MLA's softmax scale at the published settings;
  * the MLA block, the dense layer, the routing (experts, weights, loads,
    the sequence-wise balance loss) under a correction bias, and the held
    experts' dropless layer under a skewed load, and under no load;
  * every selection of a held expert is computed, none dropped;
  * the share test: 16 experts in 4 shares of 4, the shares' routed parts
    plus the shared expert once equal the uncut reference layer;
  * the loss and every gradient of a full step, remat on and off, and two
    `make_train_step` steps (AdamW from `optimizer.make`, the bias rule)
    against the reference's steps;
  * the configuration stays out of `ARCHS` / `SMOKES`, its sizes at the
    published widths, and a one-card `Trainer` runs it without a
    checkpoint.
"""
import dataclasses
import json
import pathlib
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.configs import kimi_k2_instruct as kk
from repro_torch.models import layers as ll
from repro_torch.models import moe
from repro_torch.models import steps
from repro_torch.models import transformer as tf
from repro_torch.training import optimizer as opt

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "bench"))
from reference import kimi_k2 as ref  # noqa: E402

torch.set_num_threads(1)

SMALL = {"hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 4, "q_lora_rank": 48, "kv_lora_rank": 32,
         "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
         "intermediate_size": 96, "moe_intermediate_size": 24,
         "n_routed_experts": 4, "router_experts": 16, "expert_offset": 4,
         "num_experts_per_tok": 4, "num_hidden_layers": 3,
         "vocab_size": 256, "rope_scaling": {
             "beta_fast": 1, "beta_slow": 1, "factor": 32, "mscale": 1,
             "mscale_all_dim": 1, "original_max_position_embeddings": 16,
             "type": "yarn"}}
SEED = 2 ** 31 + 77
B, S = 2, 24


def _config(**over) -> dict:
    c = json.loads((ROOT / "bench/configs/kimi_k2_instruct.json")
                   .read_text())
    return {**c, **SMALL, "compute_dtype": "float32", "remat": False,
            **over}


def _program(c: dict):
    return kk.from_published(c)


def _params(c: dict, seed: int = SEED) -> dict:
    return ref.init_params(c, seed, "cpu")


def _nested(flat: dict) -> dict:
    return tf.unflatten({k: v.clone() for k, v in flat.items()})


def _tokens(c: dict, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, c["vocab_size"], (B, S + 1), generator=g)
    return t[:, :-1], t[:, 1:]


def _layer(flat: dict, prefix: str, i: int) -> dict:
    return {k[len(prefix):]: v[i] for k, v in flat.items()
            if k.startswith(prefix)}


def test_yarn_and_scale_at_the_published_settings():
    c = json.loads((ROOT / "bench/configs/kimi_k2_instruct.json")
                   .read_text())
    cfg = kk.CONFIG
    got = ll.yarn_frequencies(64, cfg.rope_theta, cfg.rope_factor,
                              cfg.rope_original_max_positions,
                              cfg.rope_beta_fast, cfg.rope_beta_slow)
    torch.testing.assert_close(got, ref.yarn_frequencies(c, "cpu"))
    base = 1.0 / 50000.0 ** (torch.arange(0, 64, 2) / 64)
    # beta_fast = beta_slow = 1 over 4,096 positions: the first 20 pairs
    # keep theta's frequency, the last 12 are divided by the factor 32
    torch.testing.assert_close(got[:20], base[:20])
    torch.testing.assert_close(got[20:], base[20:] / 32)
    want = 192 ** -0.5 * (0.1 * torch.log(torch.tensor(32.0)) + 1) ** 2
    assert cfg.softmax_scale == pytest.approx(float(want), rel=1e-6)
    assert ref.softmax_scale(c) == pytest.approx(cfg.softmax_scale)


def test_mla_block_matches_the_reference():
    c = _config()
    cfg = _program(c)
    flat = _params(c)
    x = torch.randn(B, S, c["hidden_size"],
                    generator=torch.Generator().manual_seed(3))
    p = _layer(flat, "blocks/", 1)
    got = tf._mla_attn_block(cfg, x, p, tf._positions(S, "cpu"))
    want = ref.mla(c, x, p, ref.yarn_frequencies(c, "cpu"))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fused_attention_is_the_plain_softmax():
    g = torch.Generator().manual_seed(4)
    q, k = (torch.randn(2, 40, 3, 12, generator=g) for _ in range(2))
    v = torch.randn(2, 40, 3, 8, generator=g)
    got = ll.fused_causal_attention(q, k, v, 0.3)
    want = ref.attention(q, k, v, 0.3, block=16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _skewed(c: dict, flat: dict, layer: int = 0) -> dict:
    """The correction bias pushes most tokens onto two held experts and
    none onto a third."""
    flat = dict(flat)
    bias = flat["blocks/e_score_correction_bias"].clone()
    o = c["expert_offset"]
    bias[layer, o] += 3.0
    bias[layer, o + 1] += 1.0
    bias[layer, o + 2] -= 5.0
    flat["blocks/e_score_correction_bias"] = bias
    return flat


def _routed(c, flat, layer=0, seed=5):
    h = torch.randn(B * S, c["hidden_size"],
                    generator=torch.Generator().manual_seed(seed))
    p = _layer(flat, "blocks/", layer)
    return h, p


def test_routing_matches_the_reference():
    c = _config()
    flat = _skewed(c, _params(c))
    h, p = _routed(c, flat)
    got = moe.sigmoid_route(h, p["router"], p["e_score_correction_bias"],
                            top_k=c["num_experts_per_tok"],
                            scaling=c["routed_scaling_factor"], n_seqs=B)
    e, w, aux, load = ref.route(c, h, p["router"],
                                p["e_score_correction_bias"], B)
    assert torch.equal(got.experts, e)
    torch.testing.assert_close(got.weights, w)
    torch.testing.assert_close(got.aux_loss, aux)
    assert torch.equal(got.load, load)
    # the weights are the chosen sigmoid scores, normalised, times 2.827
    torch.testing.assert_close(got.weights.sum(-1), torch.full(
        (B * S,), c["routed_scaling_factor"]))


def test_dropless_held_layer_under_a_skewed_load():
    c = _config()
    flat = _skewed(c, _params(c))
    h, p = _routed(c, flat)
    route = moe.sigmoid_route(h, p["router"], p["e_score_correction_bias"],
                              top_k=c["num_experts_per_tok"],
                              scaling=c["routed_scaling_factor"], n_seqs=B)
    held = moe.hold(route, c["expert_offset"], c["n_routed_experts"])
    assert held.rows[2] == 0 and max(held.rows) > 3 * sum(held.rows) / 4 / 2
    got = moe.routed_held_ffn(h, route, held, p["w_gate"], p["w_in"],
                              p["w_out"])
    want = ref.held_experts(c, h, route.experts, route.weights, p)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_a_layer_whose_held_experts_no_token_chose_adds_nothing():
    """No selection of a held expert: the held part is zero, and the
    experts' weights stay in the graph with a zero gradient."""
    c = _config()
    flat = _params(c)
    bias = flat["blocks/e_score_correction_bias"].clone()
    o, G = c["expert_offset"], c["n_routed_experts"]
    bias[0, o:o + G] -= 10.0
    h, p = _routed(c, {**flat, "blocks/e_score_correction_bias": bias})
    route = moe.sigmoid_route(h, p["router"], p["e_score_correction_bias"],
                              top_k=c["num_experts_per_tok"],
                              scaling=c["routed_scaling_factor"], n_seqs=B)
    held = moe.hold(route, o, G)
    assert held.rows == [0] * G and held.chosen == 0
    w = {k: p[k].clone().requires_grad_() for k in ("w_gate", "w_in",
                                                    "w_out")}
    got = moe.routed_held_ffn(h, route, held, w["w_gate"], w["w_in"],
                              w["w_out"])
    assert got.shape == h.shape and not got.any()
    grads = torch.autograd.grad(got.sum(), list(w.values()))
    assert all(g.shape == w[k].shape and not g.any()
               for k, g in zip(w, grads))


def test_every_selection_of_a_held_expert_is_computed():
    c = _config()
    flat = _skewed(c, _params(c))
    h, p = _routed(c, flat)
    route = moe.sigmoid_route(h, p["router"], p["e_score_correction_bias"],
                              top_k=c["num_experts_per_tok"],
                              scaling=c["routed_scaling_factor"], n_seqs=B)
    o, G = c["expert_offset"], c["n_routed_experts"]
    held = moe.hold(route, o, G)
    e = route.experts.reshape(-1)
    mine = ((e >= o) & (e < o + G)).nonzero()[:, 0]
    assert sorted(held.selections.tolist()) == mine.tolist()
    assert held.rows == [int((e == o + i).sum()) for i in range(G)]
    assert torch.equal(held.tokens,
                       held.selections // route.experts.shape[1])


def test_the_shares_add_up_to_the_uncut_layer():
    """16 experts in 4 shares of 4: each card's held part, plus the shared
    expert once, is the whole layer of the reference."""
    whole = _config(n_routed_experts=16, expert_offset=0)
    flat = _params(whole)
    x = torch.randn(B, S, whole["hidden_size"],
                    generator=torch.Generator().manual_seed(6))
    p = _layer(flat, "blocks/", 0)
    want, _, _ = ref.moe(whole, x, p)
    h = ll.rms_norm(x, p["mlp_norm"], whole["rms_norm_eps"])
    shared = ll.swiglu(h, p["shared_gate"], p["shared_in"],
                       p["shared_out"])
    total = x + shared
    for o in range(0, 16, 4):
        share = _program({**whole, "n_routed_experts": 4,
                          "expert_offset": o})
        ps = {**p, **{k: p[k][o:o + 4] for k in ("w_gate", "w_in",
                                                 "w_out")}}
        y, _, load = tf._held_moe_block(share, x, ps, p["router"],
                                        p["e_score_correction_bias"])
        total = total + (y - x - shared)
        assert int(load.sum()) == B * S * whole["num_experts_per_tok"]
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)


def test_dense_layer_matches_the_reference():
    c = _config()
    cfg = _program(c)
    flat = _params(c)
    tokens, _ = _tokens(c)
    x = flat["embed"][tokens]
    p = _layer(flat, "dense/", 0)
    h = tf._mla_attn_block(cfg, x, p, tf._positions(S, "cpu"))
    got = h + ll.swiglu(ll.rms_norm(h, p["mlp_norm"], cfg.rms_norm_eps),
                        p["w_gate"], p["w_in"], p["w_out"])
    inv = ref.yarn_frequencies(c, "cpu")
    hr = ref.mla(c, x, p, inv)
    want = hr + ref._swiglu(ref._rms(hr, p["mlp_norm"], c["rms_norm_eps"]),
                            p["w_gate"], p["w_in"], p["w_out"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_the_reference(remat):
    c = _config(remat=remat)
    cfg = _program(c)
    flat = _params(c)
    tokens, labels = _tokens(c)
    names = [n for n in flat if not ref.is_buffer(n)]
    leaves = {n: flat[n].clone().requires_grad_() for n in names}
    total, parts = steps.loss_fn(cfg, _nested({**flat, **leaves}),
                                 {"tokens": tokens, "labels": labels})
    got = torch.autograd.grad(total, [leaves[n] for n in names])
    rl = {n: flat[n].clone().requires_grad_() for n in names}
    rtotal, ce, aux, loads = ref.loss(c, {**flat, **rl}, tokens, labels)
    want = torch.autograd.grad(rtotal, [rl[n] for n in names])
    torch.testing.assert_close(total, rtotal, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(parts["ce"], ce, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(parts["aux"], aux, rtol=1e-5, atol=1e-6)
    assert torch.equal(parts["expert_load"], loads)
    for n, g, w in zip(names, got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6, msg=n)


def test_two_train_steps_match_the_reference():
    """`make_train_step` (AdamW from `optimizer.make`, the bias rule)
    against `reference.step`, two steps from the same weights: losses and
    gradient norms, every parameter within the first AdamW steps' rule
    (a gradient rounded across zero moves its parameter by up to 2 lr),
    and the correction bias bit for bit."""
    c = _config()
    cfg = _program(c)
    a = c["adamw"]
    flat = _params(c)
    params = _nested(flat)
    optimizer = opt.make(cfg, a["total_steps"], a["peak_lr"])
    state = optimizer.init(params)
    step = steps.make_train_step(cfg, optimizer)
    rparams, rstate = dict(flat), {}
    for i in range(2):
        tokens, labels = _tokens(c, seed=10 + i)
        params, state, m = step(params, state, {"tokens": tokens,
                                                "labels": labels})
        r = ref.step(c, rparams, rstate, tokens, labels, i + 1)
        assert float(m["ce"]) == pytest.approx(r["ce"], rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(r["grad_norm"],
                                                      rel=1e-4)
        held = r["loads"][:, 4:8].sum()
        assert float(m["held_selections"]) == float(held)
    lr = ref.learning_rate(c, 1) + ref.learning_rate(c, 2)
    for path, leaf in tf.tree_leaves(params):
        if ref.is_buffer(path):
            assert torch.equal(leaf, rparams[path])
            assert not torch.equal(leaf, flat[path])
        else:
            assert (leaf - rparams[path]).abs().max() <= 2 * lr * 1.01, path


def test_the_configuration_stays_out_of_jax_s_tables():
    assert kk.CONFIG.name not in configs.ARCHS
    assert kk.SMOKE.name not in configs.SMOKES
    assert len(configs.ARCHS) == 10
    assert configs.ARCHS["kimi-k2-1t-a32b"].family == "moe"
    assert not isinstance(configs.ARCHS["kimi-k2-1t-a32b"], kk.MLAMoEConfig)


def test_sizes_at_the_published_widths():
    full = kk.CONFIG
    card = dataclasses.replace(full, n_layers=5, vocab_size=20480,
                               experts_held=8)
    assert card.mla_params() == 101_122_048
    assert card.param_count() == 2_792_030_208
    # the whole published model: ~1.03 T parameters, ~32.9 B a token
    assert 1.02e12 < full.param_count() < 1.04e12
    assert 32.5e9 < full.active_param_count() < 33.2e9
    shapes = dict(tf.tree_leaves(tf.param_shapes(card)))
    assert shapes["blocks/w_gate"] == (4, 8, 7168, 2048)
    assert shapes["blocks/router"] == (4, 7168, 384)
    assert shapes["dense/w_gate"] == (1, 7168, 18432)
    assert shapes["blocks/wq_b"] == (4, 1536, 64 * 192)
    assert shapes["blocks/wkv_b"] == (4, 512, 64 * 256)


def test_a_one_card_trainer_runs_it_without_a_checkpoint(tmp_path):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.training.trainer import Trainer, TrainerConfig
    cfg = kk.SMOKE
    trainer = Trainer(cfg, make_local_mesh(1, device="cpu"),
                      str(tmp_path / "ckpt"),
                      TrainerConfig(total_steps=50, ckpt_every=0,
                                    peak_lr=1e-2), seed=3)
    trainer.initialize()
    bias0 = trainer.params["blocks"]["e_score_correction_bias"].clone()

    def batches():
        g = torch.Generator().manual_seed(2)
        while True:
            t = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
            yield {"tokens": t[:, :-1], "labels": t[:, 1:]}
    history = trainer.train(batches(), num_steps=3)
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all(h["held_selections"] > 0 for h in history)
    bias = trainer.params["blocks"]["e_score_correction_bias"]
    assert (bias - bias0).abs().max() == pytest.approx(
        3 * cfg.bias_update_speed)
    assert list((tmp_path / "ckpt").iterdir()) == []


def test_the_embedding_gradient_adds_up_in_f32_under_bf16_compute():
    """bfloat16 products, one token id 4,096 times: the embedding's
    gradient row, a sum over every occurrence, adds up in f32 (on the card
    a bfloat16 sum made the whole embedding's gradient norm 28% short at
    the benchmark's size)."""
    c = _config(compute_dtype="bfloat16", num_hidden_layers=2)
    cfg = _program(c)
    flat = _params(c)
    tokens = torch.full((2, 2048), 7)
    labels = torch.randint(0, c["vocab_size"], (2, 2048),
                           generator=torch.Generator().manual_seed(8))
    leaf = flat["embed"].clone().requires_grad_()
    total, _ = steps.loss_fn(cfg, _nested({**flat, "embed": leaf}),
                             {"tokens": tokens, "labels": labels})
    got, = torch.autograd.grad(total, [leaf])
    rleaf = flat["embed"].clone().requires_grad_()
    want, = torch.autograd.grad(
        ref.loss(c, {**flat, "embed": rleaf}, tokens, labels)[0], [rleaf])
    # 0.034 from the bfloat16 rounding of each occurrence's gradient; the
    # same sum taken in bfloat16 reads 0.17 here
    assert float((got[7] - want[7]).norm() / want[7].norm()) < 0.08

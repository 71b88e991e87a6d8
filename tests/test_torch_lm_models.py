"""The port's LM models (`repro_torch.models.transformer`, `models.steps`,
`serving.engine.LMServer`) against the JAX package's, on the CPU at each
architecture's smoke config, from JAX's own `init_params` weights carried
across by `convert.lm_params_from_numpy`:

  * parameter shapes, cache shapes and dtypes, `hybrid_n_apps`: exact;
  * `forward`'s logits and aux, `prefill`'s logits and every cache entry,
    four `decode_step`s' logits and caches, `loss_fn`'s ce and aux:
    rtol = atol = 1e-4 (f32); `pos` exact;
  * `LMServer.generate`'s greedy tokens: exact;
  * mixtral-smoke at a 40-token prompt (longer than its 32-token window,
    not a multiple of it): the port equals JAX, and both miss `forward`,
    which pins the port to JAX's slot rule;
  * full-width mamba2 refuses a 32-token prefill (its chunk is 64) in both
    packages;
  * glm4-9b-smoke computing in bf16, within the bound `bf16_limit`.

One JAX run per architecture is shared by the tests through a
module-scoped fixture."""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving.engine import LMServer as JLMServer  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import steps  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving.engine import LMServer  # noqa: E402

torch.set_num_threads(1)

ARCHS = list(jconfigs.ARCHS)
B, S, N_DECODE, N_NEW = 2, 32, 4, 6
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(torch.as_tensor(got).detach().double()
                               .numpy(), np.asarray(want, np.float64),
                               **(tol or TOL))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(jcfg, seed, prompt=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size,
                        (B, prompt + N_DECODE)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (B, prompt)).astype(np.int32)
    fe = (rng.normal(size=(B, jcfg.frontend_seq, jcfg.d_model))
          .astype(np.float32) if jcfg.frontend else None)
    return toks, labels, fe


def _batches(toks, fe, labels=None):
    jb = {"tokens": toks}
    if fe is not None:
        jb["frontend_embeds"] = fe
    if labels is not None:
        jb["labels"] = labels
    return jb, {k: _t(v) for k, v in jb.items()}


def _jax_decode(jserver, jp, cache, toks, prompt):
    """JAX's logits and caches (numpy) after each of N_DECODE steps fed
    `toks[:, prompt + i]`."""
    out = []
    for i in range(N_DECODE):
        logits, cache = jserver._decode(jp, cache,
                                        toks[:, prompt + i:prompt + i + 1])
        out.append((np.asarray(logits), _numpy_tree(cache)))
    return out


def _jax_init(jcfg, seed, **kw):
    return jax.jit(functools.partial(jtf.init_params, jcfg, **kw))(
        jax.random.PRNGKey(seed))


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """One JAX run of an architecture's smoke config: weights, forward,
    loss, prefill, four decode steps and a greedy generation."""
    arch = request.param
    seed = ARCHS.index(arch)
    jcfg, cfg = jconfigs.get(arch, smoke=True), configs.get(arch, smoke=True)
    jp = _jax_init(jcfg, seed, max_positions=S + 8)
    toks, labels, fe = _inputs(jcfg, seed)
    jb, _ = _batches(toks[:, :S], fe, labels)
    max_seq = S + 8 + (jcfg.frontend_seq if jcfg.family == "vlm" else 0)
    jserver = JLMServer(jcfg, jp, max_seq=max_seq)

    def forward_and_loss(p, b):     # one compile for both
        return (jtf.forward(jcfg, p, {k: v for k, v in b.items()
                                      if k != "labels"}),
                jsteps.loss_fn(jcfg, p, b))

    (logits, aux), (loss, parts) = jax.jit(forward_and_loss)(jp, jb)
    jb.pop("labels")
    pre_logits, cache = jserver._prefill(jp, jb)
    return dict(
        arch=arch, cfg=cfg, jcfg=jcfg, jp=jp,
        params=convert.lm_params_from_numpy(_numpy_tree(jp)),
        toks=toks, labels=labels, fe=fe, max_seq=max_seq,
        forward=(np.asarray(logits), float(aux)),
        loss=(float(loss), float(parts["ce"]), float(parts["aux"])),
        prefill=(np.asarray(pre_logits), _numpy_tree(cache)),
        decode=_jax_decode(jserver, jp, cache, toks, S),
        generate=jserver.generate(toks[:, :S], N_NEW, fe))


DETERMINISTIC = ("norm", "norm_scale", "D_skip", "scale", "_bias", "b_in",
                 "b_out", "conv_b", "dt_bias")


def _check_cache(got: dict, want: dict):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert tuple(g.shape) == w.shape, key
        assert str(g.dtype).split(".")[-1] == str(w.dtype), key
        if key == "pos":
            assert int(g) == int(w)
        else:
            _close(g, w)


def _port_prefill(run):
    _, tb = _batches(run["toks"][:, :S], run["fe"])
    return tf.prefill(run["cfg"], run["params"], tb, run["max_seq"])


# --------------------------------------------------------------------------
# per architecture
# --------------------------------------------------------------------------
def test_params_equal_jax_in_shape_and_rule(run):
    cfg, jcfg = run["cfg"], run["jcfg"]
    assert tf.param_shapes(cfg, max_positions=S + 8) == \
        jtf.param_shapes(jcfg, max_positions=S + 8)
    want = dict(jax.tree_util.tree_flatten_with_path(run["jp"])[0])
    want = {"/".join(p.key for p in path): np.asarray(v)
            for path, v in want.items()}
    mine = tf.init_params(cfg, torch.Generator().manual_seed(0),
                          max_positions=S + 8, device="cpu")
    abstract = tf.abstract_params(cfg, max_positions=S + 8)
    got = dict(tf.tree_leaves(mine))
    assert set(got) == set(want) == set(dict(tf.tree_leaves(abstract)))
    for path, w in want.items():
        g, a = got[path], dict(tf.tree_leaves(abstract))[path]
        assert tuple(g.shape) == w.shape == tuple(a.shape), path
        assert g.dtype == a.dtype == torch.float32 and a.is_meta, path
        if path.endswith("A_log"):
            # XLA's f32 linspace and log may differ in the last bit
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)
        elif path.endswith(DETERMINISTIC):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
        else:                                   # normal x min(0.02, ...)
            fan_in = w.shape[-2] if w.ndim >= 2 else w.shape[-1]
            scale = min(0.02, fan_in ** -0.5)
            assert float(g.std()) == pytest.approx(scale, rel=0.25), path


def test_forward_equals_jax(run):
    jb, tb = _batches(run["toks"][:, :S], run["fe"])
    logits, aux = tf.forward(run["cfg"], run["params"], tb)
    assert logits.dtype == torch.float32
    _close(logits, run["forward"][0])
    _close(aux, run["forward"][1])


def test_prefill_logits_and_cache_equal_jax(run):
    logits, cache = _port_prefill(run)
    _close(logits, run["prefill"][0])
    _check_cache(cache, run["prefill"][1])


def test_four_decode_steps_equal_jax(run):
    _, cache = _port_prefill(run)
    toks = run["toks"]
    for i, (want_logits, want_cache) in enumerate(run["decode"]):
        logits, cache = tf.decode_step(run["cfg"], run["params"], cache,
                                       _t(toks[:, S + i:S + i + 1]))
        _close(logits, want_logits)
        _check_cache(cache, want_cache)
        assert int(cache["pos"]) == S + i + 1 + (
            run["cfg"].frontend_seq if run["cfg"].family == "vlm" else 0)


def test_generate_equals_jax_tokens(run):
    server = LMServer(run["cfg"], run["params"], max_seq=run["max_seq"],
                      device="cpu")
    got = server.generate(run["toks"][:, :S], N_NEW, run["fe"])
    assert got.dtype == np.int32 and got.shape == (B, N_NEW)
    np.testing.assert_array_equal(got, run["generate"])


def test_loss_equals_jax(run):
    _, tb = _batches(run["toks"][:, :S], run["fe"], run["labels"])
    total, parts = steps.loss_fn(run["cfg"], run["params"], tb)
    want_total, want_ce, want_aux = run["loss"]
    _close(parts["ce"], want_ce)
    _close(parts["aux"], want_aux)
    _close(total, want_total)
    evaluated = steps.make_eval_step(run["cfg"])(run["params"], tb)
    assert set(evaluated) == {"loss", "ce", "aux"}
    _close(evaluated["loss"], want_total)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_and_hybrid_schedule_equal_jax(arch, smoke):
    jcfg, cfg = jconfigs.get(arch, smoke), configs.get(arch, smoke)
    if cfg.family == "hybrid":                  # no schedule elsewhere
        assert tf.hybrid_n_apps(cfg) == jtf.hybrid_n_apps(jcfg)
    want = jtf.init_cache(jcfg, 3, 96, abstract=True)
    got = tf.init_cache(cfg, 3, 96, abstract=True)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].is_meta
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key


# --------------------------------------------------------------------------
# the sliding-window slot rule, the SSD refusal, the mesh refusal
# --------------------------------------------------------------------------
def test_mixtral_prompt_40_pins_jax_slot_rule():
    """Past its 32-token window, a 40-token prefill leaves slots 0..31 to
    positions 8..39; the first decoded token (position 40) goes to slot
    40 % 32 = 8, overwriting position 16, which is still in its window.
    JAX and the port both do so, so both differ from `forward`."""
    prompt = 40
    jcfg = dataclasses.replace(jconfigs.get("mixtral-8x22b", smoke=True),
                               moe_capacity_factor=64.0)
    cfg = dataclasses.replace(configs.get("mixtral-8x22b", smoke=True),
                              moe_capacity_factor=64.0)
    jp = _jax_init(jcfg, 11)
    params = convert.lm_params_from_numpy(_numpy_tree(jp))
    toks, _, _ = _inputs(jcfg, 11, prompt)
    full_j, full_t = _batches(toks[:, :prompt + 1], None)
    want_forward, _ = jax.jit(functools.partial(jtf.forward, jcfg))(
        jp, full_j)
    jserver = JLMServer(jcfg, jp, max_seq=64)
    _, jcache = jserver._prefill(jp, {"tokens": toks[:, :prompt]})
    want_logits = np.asarray(jserver._decode(
        jp, jcache, toks[:, prompt:prompt + 1])[0])
    _, cache = tf.prefill(cfg, params, {"tokens": _t(toks[:, :prompt])}, 64)
    assert tuple(cache["k"].shape)[2] == cfg.sliding_window
    logits, _ = tf.decode_step(cfg, params, cache,
                               _t(toks[:, prompt:prompt + 1]))
    _close(logits, want_logits)
    fwd = np.asarray(want_forward)[:, prompt, :]

    def rel(x):
        return np.abs(x[:, 0, :] - fwd).max() / np.abs(fwd).max()

    assert rel(want_logits) > 0.02 and rel(logits.numpy()) > 0.02
    _close(tf.forward(cfg, params, full_t)[0][:, prompt, :], fwd)


def test_full_width_mamba2_refuses_a_cached_prefill_in_both():
    jcfg, cfg = jconfigs.get("mamba2-1.3b"), configs.get("mamba2-1.3b")
    assert tf._eff_chunk(cfg, 32) == 64
    tokens = jax.ShapeDtypeStruct((B, 32), jnp.int32)
    with pytest.raises(AssertionError, match="S % chunk"):
        jax.eval_shape(functools.partial(jtf.prefill, jcfg, max_seq=64),
                       jtf.abstract_params(jcfg), {"tokens": tokens})
    with pytest.raises(ValueError, match="S % chunk"):
        tf.prefill(cfg, tf.abstract_params(cfg),
                   {"tokens": torch.empty((B, 32), dtype=torch.int32,
                                          device="meta")}, 64)


def test_a_mesh_is_refused_naming_the_roadmap_item():
    """The mesh branches (ROADMAP A11c-ii, `distributed/collectives.py`)
    take a mesh of several shards only in a process group of as many
    ranks: forward and prefill (ring attention) and decode_step (flash
    decode) refuse one outside a group."""
    from repro_torch.launch.mesh import make_local_mesh
    cfg = dataclasses.replace(configs.get("glm4-9b", smoke=True),
                              attention_impl="ring", flash_decode=True)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    mesh = make_local_mesh(2, model=2, device="cpu")
    cache = tf.prefill(cfg, params, batch, 8)[1]
    for call in (lambda: tf.forward(cfg, params, batch, mesh=mesh),
                 lambda: tf.prefill(cfg, params, batch, 8, mesh=mesh),
                 lambda: tf.decode_step(cfg, params, cache,
                                        batch["tokens"][:, :1], mesh=mesh)):
        with pytest.raises(RuntimeError, match="process group"):
            call()


# --------------------------------------------------------------------------
# the server, the step factories, the converter
# --------------------------------------------------------------------------
def test_server_casts_once_and_needs_a_card_unless_told():
    cfg = dataclasses.replace(configs.get("glm4-9b", smoke=True),
                              compute_dtype="bfloat16")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    server = LMServer(cfg, params, max_seq=16, device="cpu")
    held = dict(tf.tree_leaves(server.params))
    assert {t.dtype for t in held.values()} == {torch.bfloat16}
    recast = dict(tf.tree_leaves(tf._cast_params(cfg, server.params)))
    assert all(recast[k] is held[k] for k in held)
    assert params["embed"].dtype == torch.float32     # the caller's copy
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LMServer(cfg, params)


def test_step_factories_equal_the_functions():
    cfg = configs.get("stablelm-12b", smoke=True)
    params = tf.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, 8),
                                     generator=torch.Generator()
                                     .manual_seed(4), dtype=torch.int32)}
    logits, cache = steps.make_prefill_step(cfg, 16)(params, batch)
    want_logits, want_cache = tf.prefill(cfg, params, batch, 16)
    assert torch.equal(logits, want_logits)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    step = steps.make_decode_step(cfg)
    got, _ = step(params, {k: v.clone() for k, v in cache.items()}, tok)
    want, _ = tf.decode_step(cfg, params, want_cache, tok)
    assert torch.equal(got, want)


def test_convert_round_trips_the_tree():
    jcfg = jconfigs.get("zamba2-1.2b", smoke=True)
    tree = _numpy_tree(jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    back = convert.lm_params_to_numpy(convert.lm_params_from_numpy(tree))
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)
    bf = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = convert.lm_params_from_numpy({"w": bf})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), bf.astype(np.float32))


# --------------------------------------------------------------------------
# bf16: glm4-9b-smoke at the dtype the card serves at full width
# --------------------------------------------------------------------------
K_SIGMA = 8.0               # width of the limit, in rounding walks
U_BF16 = 2.0 ** -8          # unit roundoff of bfloat16
ROUNDINGS_PER_LAYER = 12    # bf16 roundings a block puts on a logit's path
N_BF16_STEPS = 16           # greedy steps compared (the launcher's n_new)


def bf16_limit(n_layers: int, want: np.ndarray) -> np.ndarray:
    """Per-row bound on |logits - reference| of two bf16 evaluations of
    one model, stated before either ran: a walk of n = 12 L + 2 bf16
    roundings (norms, projections, rope, attention, activations and
    residual adds of each block; the embedding and final norm), each of
    relative size u = 2^-8 of the row's scale, the rms of the reference
    row, widened K_SIGMA = 8 times: 8 * sqrt(n) * u * rms(row)."""
    n = ROUNDINGS_PER_LAYER * n_layers + 2
    rms = np.sqrt(np.mean(np.square(want, dtype=np.float64), axis=-1,
                          keepdims=True))
    return K_SIGMA * math.sqrt(n) * U_BF16 * rms


def test_glm4_smoke_in_bf16_within_the_bound():
    jcfg = dataclasses.replace(jconfigs.get("glm4-9b", smoke=True),
                               compute_dtype="bfloat16")
    cfg = dataclasses.replace(configs.get("glm4-9b", smoke=True),
                              compute_dtype="bfloat16")
    jp = _jax_init(jcfg, 5)
    params = convert.lm_params_from_numpy(_numpy_tree(jp))
    toks, _, _ = _inputs(jcfg, 5)
    jserver = JLMServer(jcfg, jp, max_seq=S + N_BF16_STEPS)
    server = LMServer(cfg, params, max_seq=S + N_BF16_STEPS, device="cpu")

    def within(got, want):
        got = got.detach().double().numpy()
        limit = bf16_limit(cfg.n_layers, want)
        assert (np.abs(got - want) <= limit).all(), \
            float((np.abs(got - want) / limit).max())

    want_fwd, _ = jax.jit(functools.partial(jtf.forward, jcfg))(
        jp, {"tokens": toks[:, :S]})
    within(tf.forward(cfg, server.params, {"tokens": _t(toks[:, :S])})[0],
           np.asarray(want_fwd, np.float64))
    # prefill and decode along JAX's greedy path, fed to both: each step's
    # logits within the limit, and the port's greedy token JAX's on every
    # row where JAX's top-two margin exceeds twice the limit
    want_logits, jcache = jserver._prefill(jp, {"tokens": toks[:, :S]})
    logits, cache = tf.prefill(cfg, server.params,
                               {"tokens": _t(toks[:, :S])},
                               S + N_BF16_STEPS)
    compared = 0
    for _ in range(N_BF16_STEPS):
        want = np.asarray(want_logits, np.float64)[:, -1, :]
        within(logits[:, -1, :], want)
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * bf16_limit(cfg.n_layers,
                                                           want)[:, 0]
        tok = np.argmax(want, -1)[:, None].astype(np.int32)
        got_tok = torch.argmax(logits[:, -1, :], -1).numpy()
        np.testing.assert_array_equal(got_tok[clear], tok[clear, 0])
        compared += int(clear.sum())
        want_logits, jcache = jserver._decode(jp, jcache, tok)
        logits, cache = tf.decode_step(cfg, server.params, cache, _t(tok))
    assert compared >= 1

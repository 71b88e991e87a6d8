"""The port's optimizers (`repro_torch.training.optimizer`) against the
JAX package's, on the CPU.

  * AdamW (with and without clipping, with weight decay), Adafactor
    (factored and unfactored leaves) and SGD, each with a constant rate
    and with `warmup_cosine`, over 5 updates of the same numpy params and
    grads (grads growing 10x a step): every update and every state leaf
    within rtol = 1e-5, atol = 1e-8 of JAX's, plus, for AdamW, the slack
    `AdamwSlack` derives.  The two packages compute the same f32
    operations in the same order; they part where a reduction sums in
    another order (the global norm, Adafactor's means), a transcendental
    (`cos`, `pow`) rounds its last bit differently, or XLA contracts
    ``b1 * m + (1 - b1) * g`` into one fused multiply-add.  Each is a few
    units of f32 roundoff u = 2^-24 of the terms, which is far inside
    1e-5 of the result unless the terms cancel: AdamW's moments do when
    the gradient's sign flips under a growing scale, so their rule is
    derived from the terms' magnitudes (`AdamwSlack`).  The functional
    update and the in-place one give the same bits;
  * `warmup_cosine` within the same rule at every step to past `total`;
  * the optimizer cases of tests/test_training.py on the port: a
    quadratic is minimised, AdamW's clipping bounds the update, Adafactor's
    state is factored, the schedule's values; `make`'s defaults.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.training import optimizer as jopt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402

torch.set_num_threads(1)

RULE = dict(rtol=1e-5, atol=1e-8)
U = 2.0 ** -24          # unit roundoff of float32
N_UPDATES = 5
B1, B2, EPS = 0.9, 0.95, 1e-8    # adamw's defaults, which the cases keep
SHAPES = {"blocks": {"w": (3, 16, 8), "norm": (3, 16), "col": (4, 1)},
          "embed": (32, 16), "bias": (7,)}


def _tree(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _tree(v, fn) for k, v in shapes.items()}
    return fn(shapes)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _assert_tree_close(got, want, what, slack=None):
    """Every leaf within RULE of JAX's, plus `slack[path]` where given."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys(), what
    for path, g in got.items():
        g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(want[path])
        assert g.shape == w.shape and g.dtype == w.dtype, (what, path)
        extra = (slack or {}).get(path, 0.0)
        limit = RULE["atol"] + RULE["rtol"] * np.abs(w) + extra
        err = np.abs(g.astype(np.float64) - w)
        assert (err <= limit).all(), (what, path, float(err.max()),
                                      float((err / limit).max()))


class AdamwSlack:
    """The derived slack of AdamW's moments and update, per element, on top
    of RULE.  A moment is a sum of two products, b * m + (1 - b) * t
    (t = g' or g'^2, g' the clipped gradient, itself a few roundings off
    between the packages through the global norm): each package rounds
    each product, the sum and g' once or not at all, so one step adds at
    most 4u of the terms' magnitudes, and the slack carried from the last
    step decays by b:

        s_m(t) = b1 s_m(t-1) + 4u (b1 |m(t-1)| + (1 - b1) |g'|)
        s_v(t) = b2 s_v(t-1) + 4u (b2 v(t-1) + 2 (1 - b2) g'^2)

    The update -lr (mhat / (sqrt(vhat) + eps) + wd p), mhat = m / c1,
    vhat = v / c2, moves by at most

        lr [ (s_m / c1) / (r + eps) + |mhat| ds / (r + eps)^2
             + 8u (|mhat| / (r + eps) + wd |p|) ],
        r = sqrt(vhat),  ds = min(sqrt(s_v / c2), (s_v / c2) / (2 r)),

    the last term the roundings of the quotient and of lr (sqrt is
    1/2-Hoelder, hence the min).  All of it in float64 from JAX's values.
    """

    def __init__(self, lr_fn, wd, clip):
        self.lr_fn, self.wd, self.clip = lr_fn, wd, clip
        self.sm, self.sv = {}, {}

    def step(self, count, grads, state, new_state, params):
        g = {k: np.asarray(v, np.float64) for k, v in _leaves(grads)}
        norm = np.sqrt(sum(float(np.sum(v * v)) for v in g.values()))
        scale = min(1.0, self.clip / (norm + 1e-9)) if self.clip else 1.0
        lr = abs(float(self.lr_fn(jnp.asarray(count, jnp.int32))))
        c1, c2 = 1 - B1 ** count, 1 - B2 ** count
        m0, v0 = dict(_leaves(state["m"])), dict(_leaves(state["v"]))
        m1, v1 = dict(_leaves(new_state["m"])), dict(_leaves(new_state["v"]))
        p = dict(_leaves(params))
        slack = {}
        for k, gk in g.items():
            gs = gk * scale
            self.sm[k] = B1 * self.sm.get(k, 0.0) + 4 * U * (
                B1 * np.abs(np.asarray(m0[k], np.float64))
                + (1 - B1) * np.abs(gs))
            self.sv[k] = B2 * self.sv.get(k, 0.0) + 4 * U * (
                B2 * np.asarray(v0[k], np.float64) + 2 * (1 - B2) * gs * gs)
            mhat = np.abs(np.asarray(m1[k], np.float64)) / c1
            r = np.sqrt(np.asarray(v1[k], np.float64) / c2)
            sv = self.sv[k] / c2
            ds = np.minimum(np.sqrt(sv), sv / np.maximum(2 * r, 1e-300))
            slack[f"m/{k}"] = self.sm[k]
            slack[f"v/{k}"] = self.sv[k]
            slack[k] = lr * ((self.sm[k] / c1) / (r + EPS)
                             + mhat * ds / (r + EPS) ** 2
                             + 8 * U * (mhat / (r + EPS) + self.wd
                                        * np.abs(np.asarray(p[k]))))
        return slack


WD = {"adamw": 0.1, "adamw_noclip": 0.0}
MAKERS = {
    "adamw": (lambda m, lr: m.adamw(lr=lr, weight_decay=WD["adamw"])),
    "adamw_noclip": (lambda m, lr: m.adamw(lr=lr, clip_norm=0.0)),
    "adafactor": (lambda m, lr: m.adafactor(lr=lr, weight_decay=0.01)),
    "sgd": (lambda m, lr: m.sgd(lr=lr)),
}


@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine"])
@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_updates_and_state_match_jax(kind, schedule):
    rng = np.random.default_rng(len(kind))
    params = _tree(SHAPES, lambda s: rng.normal(size=s).astype(np.float32))
    if schedule == "constant":
        jo, po = MAKERS[kind](jopt, 3e-2), MAKERS[kind](opt, 3e-2)
        lr_fn = lambda count: 3e-2  # noqa: E731
    else:
        jo = MAKERS[kind](jopt, jopt.warmup_cosine(3e-2, 2, 6))
        po = MAKERS[kind](opt, opt.warmup_cosine(3e-2, 2, 6))
        lr_fn = jopt.warmup_cosine(3e-2, 2, 6)
    adam = (AdamwSlack(lr_fn, WD[kind], 0.0 if kind == "adamw_noclip"
                       else 1.0) if kind in WD else None)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = _torch_tree(params)
    js, ts = jo.init(jp), po.init(tp)
    _assert_tree_close(ts, js, "init")
    assert ts["count"].dtype == torch.int32 and ts["count"].shape == ()
    jupdate = jax.jit(jo.update)
    for step in range(N_UPDATES):
        grads = _tree(SHAPES, lambda s: (rng.normal(size=s) * 10.0 ** (
            step - 2)).astype(np.float32))
        js_prev = js
        ju, js = jupdate(jax.tree_util.tree_map(jnp.asarray, grads), js, jp)
        slack = (adam.step(step + 1, grads, _numpy_tree(js_prev),
                           _numpy_tree(js), _numpy_tree(jp))
                 if adam else None)
        tg = _torch_tree(grads)
        tu, ts2 = po.update(tg, ts, tp)
        # the in-place form writes the same bits into the old state
        before = {k: v.clone() for k, v in _leaves(ts)}
        iu, its = po.update(tg, ts, tp, inplace=True)
        for path, v in _leaves(ts2):
            assert torch.equal(dict(_leaves(its))[path], v), path
        for (path, a), (_, b) in zip(_leaves(iu), _leaves(tu)):
            assert torch.equal(a, b), path
        assert any(not torch.equal(before[p], v) for p, v in _leaves(its)
                   if p != "count")
        ts = its
        _assert_tree_close(tu, _numpy_tree(ju), f"step {step} updates",
                           slack)
        _assert_tree_close(ts, _numpy_tree(js), f"step {step} state",
                           slack)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tp = _torch_tree(_numpy_tree(jp))


def test_warmup_cosine_matches_jax():
    for peak, warmup, total in ((3e-4, 10, 100), (1.0, 10, 110),
                                (2e-3, 0, 7)):
        js = jax.jit(jopt.warmup_cosine(peak, warmup, total))
        ps = opt.warmup_cosine(peak, warmup, total)
        for count in range(0, total + 5):
            got = ps(torch.tensor(count, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(
                got.numpy(), np.asarray(js(jnp.asarray(count, jnp.int32))),
                **RULE)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(3)
    tree = _tree(SHAPES, lambda s: rng.normal(size=s).astype(np.float32))
    np.testing.assert_allclose(
        opt.global_norm(_torch_tree(tree)).numpy(),
        np.asarray(jopt.global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                           tree))), **RULE)


@pytest.mark.parametrize("make", [
    lambda: opt.adamw(lr=0.1),
    lambda: opt.adafactor(lr=0.5),
    lambda: opt.sgd(lr=0.05),
], ids=["adamw", "adafactor", "sgd"])
def test_optimizer_minimizes_quadratic(make):
    o = make()
    params = {"w": torch.full((4, 3), 5.0), "b": torch.full((3,), -4.0)}
    state = o.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)

    l0 = float(loss(params))
    for _ in range(60):
        grads = {k: 2 * v for k, v in params.items()}
        updates, state = o.update(grads, state, params)
        params = {k: params[k] + updates[k] for k in params}
    assert float(loss(params)) < 0.2 * l0


def test_adamw_clips_gradient_norm():
    o = opt.adamw(lr=1e-3, clip_norm=1.0)
    params = {"w": torch.zeros((10,))}
    state = o.init(params)
    updates, state = o.update({"w": torch.full((10,), 1e6)}, state, params)
    # clipped: update magnitude bounded by ~lr
    assert float(updates["w"].abs().max()) < 2e-3


def test_adafactor_state_is_factored():
    o = opt.adafactor()
    st = o.init({"big": torch.zeros((64, 32)), "vec": torch.zeros((7,))})
    assert st["vr"]["big"].shape == (64,)
    assert st["vc"]["big"].shape == (32,)
    assert st["vr"]["vec"].shape == (7,)
    assert st["vc"]["vec"].shape == (0,)


def test_warmup_cosine_schedule():
    s = opt.warmup_cosine(1.0, warmup=10, total=110)
    assert float(s(torch.tensor(5))) == pytest.approx(0.5, rel=1e-3)
    assert float(s(torch.tensor(10))) == pytest.approx(1.0, rel=1e-2)
    assert float(s(torch.tensor(110))) == pytest.approx(0.1, rel=1e-2)


@pytest.mark.parametrize("arch", ["glm4-9b", "kimi-k2-1t-a32b"])
def test_make_follows_the_config_and_jax_defaults(arch):
    from repro import configs as jconfigs
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    po, jo = opt.make(cfg, total_steps=50), jopt.make(jcfg, total_steps=50)
    assert po.kind == jo.kind == cfg.optimizer
    params = {"w": np.ones((6, 4), np.float32)}
    grads = {"w": np.full((6, 4), 0.5, np.float32)}
    ps, js = po.init(_torch_tree(params)), jo.init(
        jax.tree_util.tree_map(jnp.asarray, params))
    for _ in range(3):
        tu, ps = po.update(_torch_tree(grads), ps, _torch_tree(params))
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, grads), js,
                           jax.tree_util.tree_map(jnp.asarray, params))
        _assert_tree_close(tu, _numpy_tree(ju), "make")

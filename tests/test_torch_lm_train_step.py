"""The port's LM train step (`models.steps.make_train_step`, autograd
through `models.transformer`) against the JAX package's, on the CPU at
each architecture's smoke config, from JAX's `init_params(PRNGKey(1))`
carried across by `convert.lm_params_from_numpy`, B = 2, S = 32, and one
AdamW(lr = 1e-3) step:

  * every gradient leaf within rtol = atol = 1e-4 of `jax.value_and_grad`
    of JAX's `loss_fn`;
  * the step's `loss`, `ce`, `aux` and `grad_norm` within 1e-4;
  * the parameters after the step within `param_rule`, which carries the
    gradient rule through the first AdamW update (derived there: where
    |g| is near AdamW's eps the update g / (|g| + eps) turns a rounding of
    the gradient into a move of up to 2 lr);
  * JAX's `test_train_step` on the port: the same batch twice, the loss
    falls and the parameters move;
  * `cfg.remat` on (full, and the "dots" policy) gives the bits of remat
    off, loss and every gradient, and the backward really recomputes;
  * at internvl2-1b's width and depth, all-zero frontend embeddings
    overflow the gradient in both packages (a fact of the reference), and
    seeded normal ones do not.

One JAX run per architecture is shared through a module-scoped fixture."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import steps  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402

torch.set_num_threads(1)

ARCHS = list(jconfigs.ARCHS)
B, S = 2, 32
TOL = 1e-4              # rtol = atol, gradients and metrics
LR, EPS, CLIP = 1e-3, 1e-8, 1.0   # adamw(lr=1e-3)'s rate, eps and clip
U = 2.0 ** -24          # unit roundoff of float32


def _batch(jcfg, rng):
    batch = {"tokens": rng.integers(0, jcfg.vocab_size,
                                    (B, S)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab_size,
                                    (B, S)).astype(np.int32)}
    if jcfg.frontend:
        batch["frontend_embeds"] = rng.normal(
            size=(B, jcfg.frontend_seq, jcfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else tree.clone()


def _grads(cfg, params, batch):
    """(loss, {path: grad}) of the port's `loss_fn`."""
    leaves = dict(tf.tree_leaves(params))
    diff = {k: v.detach().requires_grad_() for k, v in leaves.items()}
    loss, _ = steps.loss_fn(cfg, tf.unflatten(diff), batch)
    grads = torch.autograd.grad(loss, list(diff.values()))
    return loss.detach(), dict(zip(diff, grads))


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """One JAX value_and_grad and one JAX train step (one compile), and the
    port's gradients and train step from the same weights and batch."""
    arch = request.param
    jcfg, cfg = jconfigs.get(arch, smoke=True), configs.get(arch, smoke=True)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(1), max_positions=S)
    batch = _batch(jcfg, np.random.default_rng(1))
    jo = jopt.adamw(lr=LR)
    jstep = jsteps.make_train_step(jcfg, jo)

    def both(p, s, b):
        (loss, parts), grads = jax.value_and_grad(
            lambda q: jsteps.loss_fn(jcfg, q, b), has_aux=True)(p)
        new_p, _, metrics = jstep(p, s, b)
        return loss, grads, new_p, metrics

    loss, jgrads, jnew, jmetrics = jax.jit(both)(jp, jo.init(jp), batch)
    params = convert.lm_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jp))
    tbatch = _torch_batch(batch)
    ploss, pgrads = _grads(cfg, params, tbatch)
    po = opt.adamw(lr=LR)
    new, state, metrics = steps.make_train_step(cfg, po)(
        _clone(params), po.init(params), tbatch)
    return dict(
        arch=arch, cfg=cfg, params=params, batch=tbatch,
        jloss=float(loss), jmetrics={k: float(v) for k, v in
                                     jmetrics.items()},
        jgrads=dict(tf.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                          jgrads))),
        jnew=dict(tf.tree_leaves(jax.tree_util.tree_map(np.asarray, jnew))),
        ploss=float(ploss), pgrads={k: v.numpy() for k, v in
                                    pgrads.items()},
        new=dict(tf.tree_leaves(new)), state=state, metrics=metrics)


def test_grads_match_jax(run):
    assert run["pgrads"].keys() == run["jgrads"].keys()
    for path, want in run["jgrads"].items():
        np.testing.assert_allclose(run["pgrads"][path], want, rtol=TOL,
                                   atol=TOL, err_msg=f"{run['arch']} {path}")
    np.testing.assert_allclose(run["ploss"], run["jloss"], rtol=TOL,
                               atol=TOL)


def test_step_metrics_match_jax(run):
    got = run["metrics"]
    assert set(got) == set(run["jmetrics"]) == {"loss", "ce", "aux",
                                                "grad_norm"}
    for k, want in run["jmetrics"].items():
        assert torch.is_tensor(got[k]) and got[k].shape == ()
        np.testing.assert_allclose(float(got[k]), want, rtol=TOL, atol=TOL,
                                   err_msg=f"{run['arch']} {k}")
    assert int(run["state"]["count"]) == 1


def param_rule(grads: dict, params: dict, grad_norm: float) -> dict:
    """Per-element bound on |p_port - p_jax| after the first AdamW step
    (weight decay 0), from the gradient rule |dg| <= TOL + TOL |g|.

    The clipped gradient is g' = s g, s = min(1, CLIP / |g|).  Each
    package's s follows from its own norm, which the rule moves by at most
    dn = sqrt(sum (TOL + TOL |g|)^2), so s moves by at most
    ds = min(1, CLIP / (|g| - dn)) - s, and g' by at most
    D = s (TOL + TOL |g|) + |g| ds.  The first update is exactly
    u = -lr g' / (|g'| + eps) up to roundings of a few u (the bias
    corrections cancel: mhat = g', vhat = g'^2), and f(x) = x / (|x| +
    eps) has slope eps / (|x| + eps)^2, so on [g' - D, g' + D], whose
    point nearest 0 is m = max(|g'| - D, 0), f moves by at most
    D eps / (m + eps)^2, and never by more than 2 (|f| < 1).  With the
    roundings of u and of p + u in f32:

        |dp| <= lr min(2, D eps / (m + eps)^2) + 2u (|p| + 2 lr).

    Where |g'| >> TOL this is a few units of roundoff of p; within ~TOL
    of 0 it is 2 lr: such elements (13 of zamba2-smoke's 821,656 move by
    more than 1e-5 here) are free."""
    g = {k: np.abs(np.asarray(v, np.float64)) for k, v in grads.items()}
    dn = np.sqrt(sum(float(np.sum((TOL + TOL * v) ** 2)) for v in
                     g.values()))
    s = min(1.0, CLIP / (grad_norm + 1e-9))
    ds = max(0.0, min(1.0, CLIP / max(grad_norm - dn, 1e-30)) - s)
    out = {}
    for k, gk in g.items():
        d = s * (TOL + TOL * gk) + gk * ds
        m = np.maximum(s * gk - d, 0.0)
        out[k] = (LR * np.minimum(2.0, d * EPS / (m + EPS) ** 2)
                  + 2 * U * (np.abs(np.asarray(params[k], np.float64))
                             + 2 * LR))
    return out


def test_params_after_one_step_within_the_derived_rule(run):
    before = dict(tf.tree_leaves(run["params"]))
    rule = param_rule(run["jgrads"], run["jnew"],
                      run["jmetrics"]["grad_norm"])
    moved = 0
    for path, want in run["jnew"].items():
        got = run["new"][path].numpy().astype(np.float64)
        err = np.abs(got - want)
        assert (err <= rule[path]).all(), (
            run["arch"], path, float(err.max()),
            float((err / rule[path]).max()))
        moved += int((err > 1e-5).sum())
        assert not torch.equal(run["new"][path], before[path]) or \
            not np.any(run["jgrads"][path])
    # the rule is tight where the gradient is not near eps: almost every
    # element sits within 1e-5 of JAX's
    assert moved <= 1e-4 * sum(v.size for v in run["jnew"].values())


def test_same_batch_twice_the_loss_falls(run):
    cfg = run["cfg"]
    po = opt.adamw(lr=LR)
    params = _clone(run["params"])
    state = po.init(params)
    step = steps.make_train_step(cfg, po)
    p1, s1, m1 = step(params, state, run["batch"])
    assert p1 is params            # updated in place, as JAX donates
    _, _, m2 = step(p1, s1, run["batch"])
    assert np.isfinite(float(m1["loss"])) and np.isfinite(float(m2["loss"]))
    assert float(m2["loss"]) < float(m1["loss"])
    delta = sum(float((a - b).abs().sum()) for (_, a), (_, b) in zip(
        tf.tree_leaves(p1), tf.tree_leaves(run["params"])))
    assert delta > 0


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        self.mm += func in (torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


def _counted_grads(cfg, params, batch):
    leaves = dict(tf.tree_leaves(params))
    diff = {k: v.detach().requires_grad_() for k, v in leaves.items()}
    loss, _ = steps.loss_fn(cfg, tf.unflatten(diff), batch)
    with _OpCount() as count:
        grads = torch.autograd.grad(loss, list(diff.values()))
    return loss.detach(), grads, count


def test_remat_on_and_off_give_the_same_bits(run):
    off = dataclasses.replace(run["cfg"], remat=False)
    loss0, grads0, count0 = _counted_grads(off, run["params"], run["batch"])
    for policy in ("full", "dots"):
        on = dataclasses.replace(off, remat=True, remat_policy=policy)
        loss, grads, count = _counted_grads(on, run["params"], run["batch"])
        assert torch.equal(loss, loss0), policy
        for a, b in zip(grads, grads0):
            assert torch.equal(a, b), policy
        # the backward recomputes the layers: more ops than without remat;
        # "dots" keeps the matrix products' outputs instead of rerunning
        assert count.ops > count0.ops, policy
        if policy == "full":
            assert count.mm > count0.mm
        else:
            assert count.mm == count0.mm


def test_zero_frontend_embeddings_overflow_the_gradient_in_both_packages():
    """internvl2-1b's width and depth (d 896, 14 heads, kv 2, 24 layers) at
    the smoke config's vocab, d_ff and 16 image positions, B = 1, S = 16.
    With all-zero frontend embeddings the image positions stay exactly 0
    through every block (no biases; attention over zero values, swiglu of
    zero), so each block's rms_norm backward at them scales the gradient
    by 1 / sqrt(eps) ~ 316, and over 24 blocks it overflows f32: JAX's
    gradient and the port's are both non-finite in the blocks and the
    embedding, and finite in the head.  (At the smoke's d 128 it stays
    finite.)  Seeded normal embeddings, the ViT stub's stand-in, give
    finite gradients within the gradient rule."""
    jcfg = dataclasses.replace(jconfigs.get("internvl2-1b", smoke=True),
                               n_layers=24, d_model=896, n_heads=14,
                               n_kv_heads=2)
    cfg = dataclasses.replace(configs.get("internvl2-1b", smoke=True),
                              n_layers=24, d_model=896, n_heads=14,
                              n_kv_heads=2)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(2))
    params = convert.lm_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jp))
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (1, 16)).astype(
        np.int32), "labels": rng.integers(0, jcfg.vocab_size, (1, 16))
        .astype(np.int32)}
    grad_fn = jax.jit(jax.grad(lambda p, b: jsteps.loss_fn(jcfg, p, b)[0]))
    shape = (1, jcfg.frontend_seq, jcfg.d_model)
    for frontend in (np.zeros(shape, np.float32),
                     rng.normal(size=shape).astype(np.float32)):
        b = {**batch, "frontend_embeds": frontend}
        want = dict(tf.tree_leaves(jax.tree_util.tree_map(
            np.asarray, grad_fn(jp, b))))
        _, got = _grads(cfg, params, _torch_batch(b))
        bad = {k for k, v in want.items() if not np.isfinite(v).all()}
        assert bad == {k for k, v in got.items()
                       if not torch.isfinite(v).all()}
        if frontend.any():
            assert not bad
            for k, v in want.items():
                np.testing.assert_allclose(got[k].numpy(), v, rtol=TOL,
                                           atol=TOL, err_msg=k)
        else:
            assert "embed" in bad and "blocks/wq" in bad
            assert not bad & {"lm_head", "final_norm"}

"""The port's LM layers (`repro_torch.models.{layers,moe,ssm}`) against the
JAX package's on the same numpy inputs, on the CPU: norms, RoPE (odd
tail too), positions, attention (causal, sliding window, chunked,
cross), decode attention, the MLPs, MoE with ties and drops, the SSD
block (padded, cache handoff, softplus past its threshold) and its
decode step.  f32 within rtol = atol = 1e-4; integers exact.

Then the JAX package's own layer properties (`tests/test_layers.py`),
run on the port alone.  The JAX functions run under `jax.jit` (one
compile a case instead of one an operation)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jll  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import layers as ll  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import ssm as ssm_lib  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


# --------------------------------------------------------------------------
# norms, RoPE, positions, MLPs
# --------------------------------------------------------------------------
def test_norms_equal_jax():
    rng = np.random.default_rng(0)
    x, s, b = _normal(rng, 3, 5, 24), _normal(rng, 24), _normal(rng, 24)
    _close(ll.rms_norm(_t(x), _t(s)), jll.rms_norm(x, s))
    _close(ll.layer_norm(_t(x), _t(s), _t(b)), jll.layer_norm(x, s, b))
    # f32 inside, the input's dtype out
    xb = _t(x).to(torch.bfloat16)
    got = ll.rms_norm(xb, _t(s))
    assert got.dtype == torch.bfloat16
    want = jll.rms_norm(jnp.asarray(x, jnp.bfloat16), s)
    _close(got.float(), np.asarray(want, np.float32), rtol=8e-3, atol=8e-3)


@pytest.mark.parametrize("head_dim", [16, 15])
@pytest.mark.parametrize("batched_positions", [False, True])
def test_rope_equals_jax(head_dim, batched_positions):
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, 7, 3, head_dim)
    pos = (rng.integers(0, 500, (2, 7)) if batched_positions
           else np.arange(3, 10)).astype(np.int32)
    _close(ll.rope_frequencies(head_dim, 1e4),
           jll.rope_frequencies(head_dim, 1e4))
    got = ll.apply_rope(_t(x), _t(pos), 1e4)
    _close(got, jll.apply_rope(x, pos, 1e4))
    if head_dim % 2:                        # the odd tail passes unrotated
        np.testing.assert_array_equal(got[..., -1].numpy(), x[..., -1])


def test_sinusoidal_positions_equal_jax():
    _close(ll.sinusoidal_positions(40, 24), jll.sinusoidal_positions(40, 24))
    _close(ll.sinusoidal_positions(9, 7), jll.sinusoidal_positions(9, 7))


def test_mlps_equal_jax():
    rng = np.random.default_rng(2)
    x = _normal(rng, 2, 5, 16)
    wg, wi, wo = (_normal(rng, 16, 24, scale=0.3),
                  _normal(rng, 16, 24, scale=0.3),
                  _normal(rng, 24, 16, scale=0.3))
    bi, bo = _normal(rng, 24), _normal(rng, 16)
    _close(ll.swiglu(_t(x), _t(wg), _t(wi), _t(wo)),
           jll.swiglu(x, wg, wi, wo))
    # gelu with the tanh approximation, as jax.nn.gelu(approximate=True)
    _close(ll.gelu_mlp(_t(x), _t(wi), _t(bi), _t(wo), _t(bo)),
           jll.gelu_mlp(x, wi, bi, wo, bo))


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def _qkv(rng, B=2, S=16, H=4, KVH=2, Dh=8, Sk=None):
    Sk = Sk or S
    return (_normal(rng, B, S, H, Dh), _normal(rng, B, Sk, KVH, Dh),
            _normal(rng, B, Sk, KVH, Dh))


@pytest.mark.parametrize("sq,sk,off,causal,window",
                         [(8, 8, 0, True, 0), (4, 12, 8, True, 0),
                          (6, 6, 0, True, 3), (5, 9, 2, False, 4),
                          (3, 3, 0, False, 0)])
def test_mask_equals_jax(sq, sk, off, causal, window):
    got = ll._mask(sq, sk, off, causal=causal, window=window)
    want = jll._mask(sq, sk, off, causal=causal, window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("causal,window,q_chunk",
                         [(True, 0, 0), (True, 5, 0), (False, 0, 0),
                          (True, 0, 4), (True, 5, 4), (False, 0, 8),
                          (True, 0, 5)])       # 16 % 5: the plain route
def test_attention_equals_jax(causal, window, q_chunk):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng)
    got = ll.attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                       q_chunk=q_chunk)
    want = jll.attention(q, k, v, causal=causal, window=window,
                         q_chunk=q_chunk)
    _close(got, want)


def test_cross_attention_block_equals_jax():
    # Sq != Sk, no mask: the encoder-decoder route
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, S=6, Sk=11)
    qg = q.reshape(2, 6, 2, 2, 8)
    _close(ll._attend_block(_t(qg), _t(k), _t(v), None),
           jll._attend_block(qg, k, v, None))


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_decode_attention_equals_jax(window, as_tensor):
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, S=1, Sk=12)
    for cur in (1, 7, 12):
        pos = torch.tensor(cur, dtype=torch.int32) if as_tensor else cur
        got = ll.decode_attention(_t(q), _t(k), _t(v), pos, window=window)
        want = jll.decode_attention(q, k, v, jnp.int32(cur), window=window)
        _close(got, want)


def test_attention_bf16_keeps_dtype():
    rng = np.random.default_rng(6)
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(rng))
    out = ll.attention(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16
    want = jll.attention(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                           for a in (q, k, v)), causal=True)
    _close(out.float(), np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
def _moe_weights(rng, E, D, F):
    return (_normal(rng, D, E, scale=0.3), _normal(rng, E, D, F, scale=0.1),
            _normal(rng, E, D, F, scale=0.1), _normal(rng, E, F, D, scale=0.1))


def _moe_pair(x, weights, **kw):
    got_y, got_m = moe_lib.moe_ffn(_t(x), *map(_t, weights), **kw)
    want_y, want_m = jax.jit(functools.partial(jmoe.moe_ffn, **kw))(
        x, *weights)
    _close(got_y, want_y)
    _close(got_m.aux_loss, want_m.aux_loss)
    assert float(got_m.drop_frac) == pytest.approx(float(want_m.drop_frac),
                                                   abs=1e-7)
    return got_m


@pytest.mark.parametrize("T,group,cap", [(32, 32, 8.0), (64, 16, 1.25),
                                         (48, 64, 2.0)])
def test_moe_equals_jax(T, group, cap):
    rng = np.random.default_rng(7)
    weights = _moe_weights(rng, 4, 16, 24)
    x = _normal(rng, T, 16)
    _moe_pair(x, weights, top_k=2, group_size=group, capacity_factor=cap)


def test_moe_with_drops_equals_jax():
    rng = np.random.default_rng(8)
    weights = _moe_weights(rng, 4, 8, 16)
    x = np.ones((64, 8), np.float32)        # every token to the same experts
    m = _moe_pair(x, weights, top_k=2, group_size=64, capacity_factor=0.25)
    assert float(m.drop_frac) > 0.3


def test_moe_ties_route_to_the_lower_expert():
    rng = np.random.default_rng(9)
    _, wg, wi, wo = _moe_weights(rng, 4, 8, 16)
    router = np.zeros((8, 4), np.float32)   # every expert ties
    x = _normal(rng, 16, 8)
    _moe_pair(x, (router, wg, wi, wo), top_k=2, group_size=16,
              capacity_factor=8.0)
    probs = np.tile(np.float32([0.2, 0.3, 0.3, 0.2]), (5, 1))
    got_p, got_e = moe_lib.stable_top_k(_t(probs), 3)
    want_p, want_e = jax.lax.top_k(probs, 3)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


# --------------------------------------------------------------------------
# SSD (mamba2)
# --------------------------------------------------------------------------
def _jssd(jp, u, dims, **kw):
    return jax.jit(functools.partial(jssm.ssd_forward, dims=dims, **kw))(
        jp, u)


def _ssm_case(rng, D=16, headdim=4, d_state=4, dt_shift=0.0):
    dims = ssm_lib.ssm_dims(D, headdim=headdim, d_state=d_state)
    jparams = jssm.init_ssm_params(jax.random.PRNGKey(1), D, dims)
    jparams = jparams._replace(dt_bias=jparams.dt_bias + dt_shift,
                               conv_b=jnp.asarray(_normal(rng, dims[
                                   "conv_dim"], scale=0.1)))
    tparams = ssm_lib.SSMParams(*(_t(a) for a in jparams))
    return dims, jparams, tparams


def test_ssm_dims_and_init_equal_jax():
    assert ssm_lib.ssm_dims(128, expand=2, headdim=32, d_state=16) == \
        jssm.ssm_dims(128, expand=2, headdim=32, d_state=16)
    dims = ssm_lib.ssm_dims(16, headdim=4, d_state=4)
    got = ssm_lib.init_ssm_params(torch.Generator().manual_seed(0), 16, dims)
    want = jssm.init_ssm_params(jax.random.PRNGKey(0), 16, dims)
    for field in got._fields:
        assert tuple(getattr(got, field).shape) == getattr(want,
                                                           field).shape
    for field in ("conv_b", "D_skip", "dt_bias", "norm_scale"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    np.testing.assert_allclose(got.A_log.numpy(), np.asarray(want.A_log),
                               rtol=1e-6)
    assert float(got.in_proj.std()) == pytest.approx(0.02, rel=0.2)


def test_depthwise_conv_and_split_equal_jax():
    rng = np.random.default_rng(10)
    x, w, b = _normal(rng, 2, 9, 6), _normal(rng, 4, 6), _normal(rng, 6)
    _close(ssm_lib._depthwise_causal_conv(_t(x), _t(w), _t(b)),
           jssm._depthwise_causal_conv(x, w, b))
    dims = ssm_lib.ssm_dims(16, headdim=4, d_state=4)
    z = _normal(rng, 2, 3, 2 * 32 + 8 + 8)
    for got, want in zip(ssm_lib._split_proj(_t(z), dims),
                         jssm._split_proj(z, dims)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S,chunk", [(32, 8), (16, 16), (13, 8), (5, 8)])
def test_ssd_forward_equals_jax(S, chunk):
    rng = np.random.default_rng(11)
    dims, jp, tp = _ssm_case(rng)
    u = _normal(rng, 2, S, 16, scale=0.5)
    _close(ssm_lib.ssd_forward(tp, _t(u), dims, chunk=chunk),
           _jssd(jp, u, dims, chunk=chunk))


def test_ssd_forward_cache_equals_jax():
    rng = np.random.default_rng(12)
    dims, jp, tp = _ssm_case(rng)
    u = _normal(rng, 2, 24, 16, scale=0.5)
    got_y, got_c = ssm_lib.ssd_forward(tp, _t(u), dims, chunk=8,
                                       return_cache=True)
    want_y, want_c = _jssd(jp, u, dims, chunk=8, return_cache=True)
    _close(got_y, want_y)
    _close(got_c.h, want_c.h)
    _close(got_c.conv, want_c.conv)


def test_ssd_padded_cache_is_refused_by_both():
    rng = np.random.default_rng(13)
    dims, jp, tp = _ssm_case(rng)
    u = _normal(rng, 1, 13, 16)
    with pytest.raises(ValueError, match="S % chunk"):
        ssm_lib.ssd_forward(tp, _t(u), dims, chunk=8, return_cache=True)
    with pytest.raises(AssertionError, match="S % chunk"):
        jax.eval_shape(functools.partial(jssm.ssd_forward, dims=dims,
                                         chunk=8, return_cache=True), jp, u)


@pytest.mark.parametrize("dt_shift", [0.0, 24.0])
def test_ssd_decode_step_equals_jax(dt_shift):
    # dt_shift 24 puts every softplus input past torch's threshold of 20,
    # where torch returns its input and JAX log1p(exp(x)): equal to f32
    rng = np.random.default_rng(14)
    dims, jp, tp = _ssm_case(rng, dt_shift=dt_shift)
    jc = jssm.init_ssm_cache(2, dims)
    tc = ssm_lib.init_ssm_cache(2, dims)
    assert [tuple(a.shape) for a in tc] == [a.shape for a in jc]
    jc = jc._replace(h=jnp.asarray(_normal(rng, *jc.h.shape, scale=0.1)),
                     conv=jnp.asarray(_normal(rng, *jc.conv.shape)))
    tc = ssm_lib.SSMCache(_t(jc.h), _t(jc.conv))
    step = jax.jit(functools.partial(jssm.ssd_decode_step, dims=dims))
    for _ in range(3):
        u = _normal(rng, 2, 1, 16, scale=0.5)
        got_y, tc = ssm_lib.ssd_decode_step(tp, _t(u), tc, dims)
        want_y, jc = step(jp, u, jc)
        _close(got_y, want_y)
        _close(tc.h, jc.h)
        _close(tc.conv, jc.conv)
    if dt_shift:
        u = _normal(rng, 2, 8, 16, scale=0.5)
        _close(ssm_lib.ssd_forward(tp, _t(u), dims, chunk=8),
               _jssd(jp, u, dims, chunk=8))


# --------------------------------------------------------------------------
# the JAX package's layer properties (tests/test_layers.py), on the port
# --------------------------------------------------------------------------
def test_port_attention_causal():
    rng = np.random.default_rng(0)
    q, k, v = (_t(a) for a in _qkv(rng))
    out1 = ll.attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] += 10.0
    v2[:, -1] -= 5.0
    out2 = ll.attention(q, k2, v2, causal=True)
    np.testing.assert_allclose(out1[:, :-1].numpy(), out2[:, :-1].numpy(),
                               atol=1e-6)
    assert (out1[:, -1] - out2[:, -1]).abs().max() > 1e-3


def test_port_attention_chunked_equals_plain():
    rng = np.random.default_rng(1)
    q, k, v = (_t(a) for a in _qkv(rng, S=64, KVH=4))
    plain = ll.attention(q, k, v, causal=True)
    chunked = ll.attention(q, k, v, causal=True, q_chunk=16)
    np.testing.assert_allclose(plain.numpy(), chunked.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_port_sliding_window_masks_older():
    rng = np.random.default_rng(2)
    q, k, v = (_t(a) for a in _qkv(rng, B=1, S=32, H=2, KVH=2))
    out1 = ll.attention(q, k, v, causal=True, window=8)
    v2 = v.clone()
    v2[:, 0] += 100.0                 # outside the window of position 31
    out2 = ll.attention(q, k, v2, causal=True, window=8)
    np.testing.assert_allclose(out1[:, -1].numpy(), out2[:, -1].numpy(),
                               atol=1e-5)


def test_port_rope_preserves_norm_and_relative_angle():
    rng = np.random.default_rng(3)
    x = _t(_normal(rng, 1, 8, 1, 16))
    q = _t(_normal(rng, 1, 8, 1, 16))
    pos = torch.arange(8)
    rot = ll.apply_rope(x, pos, 1e4)
    np.testing.assert_allclose(rot.norm(dim=-1).numpy(),
                               x.norm(dim=-1).numpy(), rtol=1e-5)
    d1 = (ll.apply_rope(q, pos, 1e4) * rot).sum(-1)
    d2 = (ll.apply_rope(q, pos + 5, 1e4)
          * ll.apply_rope(x, pos + 5, 1e4)).sum(-1)
    np.testing.assert_allclose(d1.numpy(), d2.numpy(), rtol=1e-4, atol=1e-4)


def test_port_moe_matches_dense_mixture_when_capacity_ample():
    rng = np.random.default_rng(4)
    T, D, E, F, k = 32, 16, 4, 24, 2
    router, wg, wi, wo = map(_t, _moe_weights(rng, E, D, F))
    x = _t(_normal(rng, T, D))
    y, metrics = moe_lib.moe_ffn(x, router, wg, wi, wo, top_k=k,
                                 group_size=T, capacity_factor=8.0)
    probs = torch.softmax(x @ router, -1)
    top_p, top_e = moe_lib.stable_top_k(probs, k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    dense = torch.zeros_like(x)
    for e in range(E):
        ye = (torch.nn.functional.silu(x @ wg[e]) * (x @ wi[e])) @ wo[e]
        w = torch.where(top_e == e, top_p, 0.0).sum(-1)
        dense = dense + w[:, None] * ye
    np.testing.assert_allclose(y.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert float(metrics.drop_frac) == 0.0


def test_port_moe_drops_overflow_but_stays_finite():
    rng = np.random.default_rng(5)
    router, wg, wi, wo = map(_t, _moe_weights(rng, 4, 8, 16))
    x = torch.ones((64, 8))
    y, metrics = moe_lib.moe_ffn(x, router, wg, wi, wo, top_k=2,
                                 group_size=64, capacity_factor=0.25)
    assert float(metrics.drop_frac) > 0.3
    assert bool(torch.isfinite(y).all())


def test_port_ssd_matches_naive_recurrence_and_cache_handoff():
    rng = np.random.default_rng(6)
    B, S, D = 2, 32, 16
    dims = ssm_lib.ssm_dims(D, headdim=4, d_state=8)
    params = ssm_lib.init_ssm_params(torch.Generator().manual_seed(0), D,
                                     dims)
    u = _t(_normal(rng, B, S, D, scale=0.5))
    chunked, cache_fwd = ssm_lib.ssd_forward(params, u, dims, chunk=8,
                                             return_cache=True)
    cache = ssm_lib.init_ssm_cache(B, dims)
    outs = []
    for t in range(S):
        y, cache = ssm_lib.ssd_decode_step(params, u[:, t:t + 1], cache,
                                           dims)
        outs.append(y)
    naive = torch.cat(outs, dim=1)
    np.testing.assert_allclose(chunked.numpy(), naive.numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(cache_fwd.h.numpy(), cache.h.numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(cache_fwd.conv.numpy(), cache.conv.numpy(),
                               rtol=1e-4, atol=1e-4)

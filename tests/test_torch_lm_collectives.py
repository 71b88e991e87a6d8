"""The port's collectives (`repro_torch.distributed.collectives`) and the
models' mesh branches (ring attention, `_sp`, flash decode) against the
plain functions, the one-device path and the JAX package, on the CPU:
gloo ranks spawned through `tests/torch_dist_worker.py` (one start-up for
many checks), beside one JAX subprocess on 8 forced host devices (as
tests/test_distributed.py runs it), from the same numpy seeds:

  * JAX's four collective tests on the port at their shapes and meshes
    (flash decode, ring matmul and ring attention on (2, 4), the int8
    all-reduce on (8,) "data"): flash decode and ring attention within
    1e-4 of the plain function and of JAX's output, the matmul within
    1e-3; the int8 all-reduce within JAX's two bounds, its mean and
    residuals within rtol 1e-6 of JAX's over two steps (the residuals
    carried), its int32 sums equal to JAX's; bf16 mode within rtol 1e-6;
  * each collective against the one-process emulation of its shard
    bodies (`collectives.emulate_*`): bit for bit where nothing is summed
    across shards (the rings), within 1e-6 otherwise; DTensor inputs give
    the plain inputs' values on the shard_map's out-specs;
  * ring attention's gradient (q, k, v) within 1e-4 of the plain
    attention's and of JAX's ring gradient;
  * the smoke configs with `attention_impl="ring"` + `sequence_parallel`
    (glm4-9b, kimi-k2, internvl2, and mixtral, whose sliding window keeps
    the plain attention) and with `flash_decode` (glm4-9b, zamba2,
    whisper) on (2, 2) gloo meshes, some on (1, 4): forward's logits, the
    `make_train_step(mesh=)` gradients, loss and grad_norm, `prefill`
    and three `decode_step`s' logits and the cache after them held to
    mesh=None and to JAX's `forward` / `prefill` / `decode_step` with
    mesh= within rtol = atol = 1e-4; the prefill's cache placed by
    `cache_specs`; at world 1 the DTensor path bit for bit the plain
    tensors' mesh path;
  * the branch conditions, counted against JAX's: which blocks take the
    ring and which decode steps flash decode;
  * refusals: several shards without a process group.
"""
import concurrent.futures
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
import torch_dist_worker as worker  # noqa: E402
from test_torch_lm_distributed import (expected_placements,  # noqa: E402
                                       jax_process, result, spawn_group)

from repro_torch import configs  # noqa: E402
from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.distributed import runtime  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import layers as ll  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ATTN_TOL = 1e-4        # the two attentions, and the models (rtol = atol)
MM_TOL = 1e-3          # the ring matmul
SUM_TOL = 1e-6         # a collective against its emulation, where a sum
#                        over the shards rounds in another order
RTOL_INT8 = 1e-6       # the compressed all-reduce against JAX's
MODEL_CASES = [("2x2", c) for c in chip_smoke.LM_MESH_CASES] + \
    [("1x4", c) for c in worker.MESH_1X4_CASES]

JAX_BODY = """
import dataclasses
from functools import partial
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, os.path.join(sys.argv[2], "tests"))
sys.path.insert(0, sys.argv[2])
import chip_smoke
import torch_dist_worker as worker
from repro.compat import shard_map
from repro.distributed import collectives as C
inp = worker.collective_inputs()
out = {}
mesh = make_mesh((2, 4), ("data", "model"))
q, k, v = inp["fd"]
with mesh:
    out["flash_decode"] = C.flash_decode(mesh)(
        q, k, v, jnp.asarray(worker.FD_VALID, jnp.int32))
    out["matmul"] = C.ring_allgather_matmul(mesh, axis="model")(*inp["mm"])
    ring = C.ring_attention(mesh)
    out["ring"] = ring(*inp["ring"])
    loss = lambda q, k, v: jnp.sum(ring(q, k, v) * inp["ring_ct"])
    for i, g in enumerate(jax.grad(loss, argnums=(0, 1, 2))(*inp["ring"])):
        out[f"ring_grad_{i}"] = g
mesh8 = make_mesh((8,), ("data",))

def step(g, r, mode):
    mean, r2 = C.compressed_psum_grads({"w": g[0]}, {"w": r[0]}, "data",
                                       mode=mode)
    return mean["w"][None], r2["w"][None]

def int_sum(g, r):
    g = g[0] + r[0]
    scale = jax.lax.pmax(jnp.max(jnp.abs(g)), "data") / 127.0 + 1e-12
    q = jnp.clip(jnp.round(g / scale), -127, 127).astype(jnp.int8)
    return jax.lax.psum(q.astype(jnp.int32), "data")[None]

specs = dict(mesh=mesh8, in_specs=(P("data"), P("data")))
resid = np.zeros_like(inp["grads"][0])
with mesh8:
    for i, g in enumerate(inp["grads"]):
        out[f"int8_sum_{i}"] = shard_map(int_sum, out_specs=P("data"),
                                         **specs)(g, resid)
        out[f"int8_mean_{i}"], resid = shard_map(
            partial(step, mode="int8"), out_specs=(P("data"), P("data")),
            **specs)(g, resid)
        out[f"int8_resid_{i}"] = resid
    out["bf16_mean"], out["bf16_resid"] = shard_map(
        partial(step, mode="bf16"), out_specs=(P("data"), P("data")),
        **specs)(inp["grads"][0], np.zeros_like(inp["grads"][0]))
cases = [("2x2", c) for c in chip_smoke.LM_MESH_CASES] + \\
    [("1x4", c) for c in worker.MESH_1X4_CASES]
for key, (name, variant) in cases:
    shape = (2, 2) if key == "2x2" else (1, 4)
    mesh = make_mesh(shape, ("data", "model"), devices=jax.devices()[:4])
    cfg = dataclasses.replace(configs.get(name, smoke=True),
                              **chip_smoke.LM_MESH_VARIANTS[variant])
    seed = chip_smoke.LM_MESH_CASES.index((name, variant))
    params, batch, decode = chip_smoke.lm_mesh_inputs(
        chip_smoke.lm_mesh_config(name, variant), seed)
    tree = {}
    for path, leaf in params.items():
        *heads, last = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(leaf.numpy())
    b = {kk: jnp.asarray(vv) for kk, vv in batch.items()}
    prompt = {kk: vv for kk, vv in b.items() if kk != "labels"}
    tag = f"{key}/{name}/{variant}"
    with mesh:
        out[tag + "/logits"] = jax.jit(
            lambda p, b: tf.forward(cfg, p, b, mesh=mesh)[0])(tree, b)
        out[tag + "/prefill"], cache = jax.jit(lambda p, b: tf.prefill(
            cfg, p, b, chip_smoke.LM_MESH_MAX_SEQ, mesh=mesh))(tree, prompt)
        dec = jax.jit(lambda p, c, t: tf.decode_step(cfg, p, c, t,
                                                     mesh=mesh))
        for i, t in enumerate(decode):
            out[f"{tag}/decode_{i}"], cache = dec(tree, cache,
                                                  jnp.asarray(t))
np.savez(sys.argv[1], **{kk: np.asarray(vv) for kk, vv in out.items()})
print(json.dumps({"keys": len(out)}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's values in a subprocess beside the 8-rank collectives group,
    the 4-rank model group and a 1-rank group."""
    tmp = tmp_path_factory.mktemp("lm_collectives")
    npz = str(tmp / "jax.npz")
    jax = jax_process(JAX_BODY, npz, REPO)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        one = pool.submit(spawn_group, "mesh_one", 1, str(tmp / "mesh_one"))
        groups = {"collectives": spawn_group("collectives", 8,
                                             str(tmp / "collectives")),
                  "mesh_models": spawn_group("mesh_models", 4,
                                             str(tmp / "mesh_models")),
                  "mesh_one": one.result()}
    stdout, stderr = jax.communicate(timeout=300)
    assert jax.returncode == 0, stderr[-3000:]
    with np.load(npz) as f:
        groups["jax"] = dict(f)
    return groups


def _close(got, want, tol, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, **kw)


def _collectives(runs, rank=0) -> dict:
    return result(runs["collectives"], "collectives", rank)


def test_flash_decode_matches_reference_and_jax(runs):
    got = _collectives(runs)["flash_decode"]
    _close(got["got"], got["plain"], ATTN_TOL)
    _close(got["got"], runs["jax"]["flash_decode"], ATTN_TOL)
    _close(got["got"], got["emulated"], SUM_TOL)
    # DTensor inputs (q and k on heads, v on its head dim): the same
    # values, on the out-spec P("data", None, None)
    np.testing.assert_array_equal(got["dtensor"], got["got"])
    assert got["dtensor_placements"] == ["Shard(dim=0)", "Replicate()"]


def test_compressed_allreduce_error_feedback(runs):
    jax = runs["jax"]
    g = worker.collective_inputs()["grads"][0]
    true_mean = g.mean(0)
    ranks = [_collectives(runs, r)["compressed"] for r in range(8)]
    # JAX's own bounds (tests/test_distributed.py), on the first step
    err = max(float(np.abs(r["int8_0"]["mean"] - true_mean).max())
              for r in ranks)
    assert err <= float(np.abs(true_mean).max()) * 0.05 + 0.02
    rmax = max(float(np.abs(r["int8_0"]["resid"]).max()) for r in ranks)
    assert rmax <= float(np.abs(g).max(axis=1).mean()) / 100.0
    for step in range(2):
        for r, rec in enumerate(ranks):
            got = rec[f"int8_{step}"]
            # the int32 sums exact, and the mean is theirs rescaled
            np.testing.assert_array_equal(got["sum"],
                                          jax[f"int8_sum_{step}"][r])
            np.testing.assert_array_equal(got["mean"], got["sum"].astype(
                np.float32) * np.float32(got["scale"]) / np.float32(8))
            np.testing.assert_allclose(got["mean"],
                                       jax[f"int8_mean_{step}"][r],
                                       rtol=RTOL_INT8, atol=0)
            np.testing.assert_allclose(got["resid"],
                                       jax[f"int8_resid_{step}"][r],
                                       rtol=RTOL_INT8, atol=1e-12)
    for r, rec in enumerate(ranks):
        np.testing.assert_allclose(rec["bf16"]["mean"], jax["bf16_mean"][r],
                                   rtol=RTOL_INT8, atol=0)
        np.testing.assert_allclose(rec["bf16"]["resid"],
                                   jax["bf16_resid"][r], rtol=RTOL_INT8,
                                   atol=1e-12)


def test_ring_allgather_matmul(runs):
    for r in range(8):
        got = _collectives(runs, r)["matmul"]
        _close(got["got"], got["plain"], MM_TOL)
        # each shard's own sum, in its ring's order
        np.testing.assert_array_equal(got["got"], got["emulated"])
    _close(_collectives(runs)["matmul"]["got"], runs["jax"]["matmul"],
           MM_TOL)


def test_ring_attention_matches_plain(runs):
    got = _collectives(runs)["ring_attention"]
    _close(got["got"], got["plain"], ATTN_TOL)
    _close(got["got"], runs["jax"]["ring"], ATTN_TOL)
    np.testing.assert_array_equal(got["got"], got["emulated"])
    np.testing.assert_array_equal(got["whole_batch"], got["emulated"])
    # heads-sharded DTensors in, a sequence-sharded DTensor out
    np.testing.assert_array_equal(got["dtensor"], got["got"])
    assert got["dtensor_type"] == "DTensor"
    assert got["dtensor_placements"] == ["Shard(dim=0)", "Shard(dim=1)"]


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_ring_attention_gradient(runs, which):
    i = "qkv".index(which)
    got = _collectives(runs)["ring_attention"]
    _close(got["got_grads"][i], got["plain_grads"][i], ATTN_TOL)
    _close(got["whole_batch_grads"][i], got["plain_grads"][i], ATTN_TOL)
    _close(got["got_grads"][i], runs["jax"][f"ring_grad_{i}"], ATTN_TOL)


def _pair(runs, mesh: str, case) -> dict:
    name, variant = case
    return result(runs["mesh_models"], f"models_{mesh}")[
        f"{name}/{variant}"]


@pytest.mark.parametrize("mesh,case", MODEL_CASES,
                         ids=[f"{m}-{n}-{v}" for m, (n, v) in MODEL_CASES])
def test_mesh_branches_match_one_device_and_jax(runs, mesh, case):
    pair = _pair(runs, mesh, case)
    one, got = pair["one"], pair["mesh"]
    tag = f"{mesh}/{case[0]}/{case[1]}"
    jax = runs["jax"]
    _close(got["logits"], one["logits"], ATTN_TOL, err_msg="forward")
    _close(got["logits"], jax[tag + "/logits"], ATTN_TOL, err_msg="jax")
    for path, want in one["grads"].items():
        _close(got["grads"][path], want, ATTN_TOL, err_msg=path)
    for k in ("loss", "grad_norm"):
        _close(got["metrics"][k], one["metrics"][k], ATTN_TOL, err_msg=k)
    _close(got["prefill"], one["prefill"], ATTN_TOL, err_msg="prefill")
    _close(got["prefill"], jax[tag + "/prefill"], ATTN_TOL,
           err_msg="jax prefill")
    for i, (g, w) in enumerate(zip(got["decode"], one["decode"])):
        _close(g, w, ATTN_TOL, err_msg=f"decode {i}")
        _close(g, jax[f"{tag}/decode_{i}"], ATTN_TOL,
               err_msg=f"jax decode {i}")
    for key, want in one["cache"].items():
        if key == "pos":
            np.testing.assert_array_equal(got["cache"][key], want)
        else:
            _close(got["cache"][key], want, ATTN_TOL, err_msg=key)


@pytest.mark.parametrize("mesh,case", MODEL_CASES,
                         ids=[f"{m}-{n}-{v}" for m, (n, v) in MODEL_CASES])
def test_prefill_cache_placed_by_cache_specs(runs, mesh, case):
    got = _pair(runs, mesh, case)["mesh"]["cache_placements"]
    cfg = chip_smoke.lm_mesh_config(*case)
    fake = _FakeMesh({"data": 2, "model": 2} if mesh == "2x2"
                     else {"data": 1, "model": 4})
    cache = tf.init_cache(cfg, chip_smoke.LM_BATCH,
                          chip_smoke.LM_MESH_MAX_SEQ, abstract=True)
    specs = shd.fit_specs(shd.cache_specs(cfg, configs.ShapeConfig(
        "cache", 0, chip_smoke.LM_BATCH, "decode"), fake), cache, fake)
    assert got.keys() == cache.keys()
    for key, spec in specs.items():
        want = expected_placements(
            [list(a) if isinstance(a, tuple) else a for a in spec],
            ["data", "model"])
        assert got[key] == want, (key, spec)


class _FakeMesh:
    """What the spec rules read of a mesh: its axis names and sizes."""

    def __init__(self, sizes: dict):
        self.shape = sizes
        self.axis_names = tuple(sizes)


@pytest.mark.parametrize("case", worker.MESH_1X1_CASES,
                         ids=[f"{n}-{v}" for n, v in worker.MESH_1X1_CASES])
def test_world_one_mesh_path_is_the_plain_mesh_path(runs, case):
    pair = result(runs["mesh_one"], "models_1x1")[f"{case[0]}/{case[1]}"]
    got, plain, one = pair["mesh"], pair["plain_mesh"], pair["one"]
    np.testing.assert_array_equal(got["logits"], plain["logits"])
    for path, want in plain["grads"].items():
        np.testing.assert_array_equal(got["grads"][path], want)
    np.testing.assert_array_equal(got["prefill"], plain["prefill"])
    for g, w in zip(got["decode"], plain["decode"]):
        np.testing.assert_array_equal(g, w)
    assert got["metrics"] == plain["metrics"]
    _close(got["logits"], one["logits"], ATTN_TOL)
    for g, w in zip(got["decode"], one["decode"]):
        _close(g, w, ATTN_TOL)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_shard_bodies_match_plain_functions(n, dtype):
    """Each collective's shard bodies fed the blocks in their ring's
    order (the smoke's one-card check at n = 4): f32 within the CPU
    rules, bf16 within the bf16 rule of one block (`bf16_limit`)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(n)
    q, k, v = (torch.randn(s, generator=gen).to(dt) for s in (
        (2, 32, 8, 16), (2, 32, 2, 16), (2, 32, 2, 16)))

    def within(got, want, tol):
        if dt == torch.float32:
            _close(got.float(), want.float(), tol)
        else:
            limit = chip_smoke.bf16_limit(1, want.float())
            assert ((got.float() - want.float()).abs() <= limit).all()

    within(C.emulate_ring_attention(q, k, v, n), ll.attention(q, k, v),
           ATTN_TOL)
    qd, valid = q[:, 0], torch.tensor(20, dtype=torch.int32)
    within(C.emulate_flash_decode(qd, k, v, valid, n),
           ll.decode_attention(qd[:, None], k, v, valid)[:, 0], ATTN_TOL)
    x, w = torch.randn(16, 32, generator=gen).to(dt), \
        torch.randn(32, 8, generator=gen).to(dt)
    for got in C.emulate_ring_allgather_matmul(x, w, n):
        within(got, x.float() @ w.float(), MM_TOL)


def _count(monkeypatch, module, name) -> list:
    calls = []
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, counted)
    return calls


ARCHS = list(configs.ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_branch_conditions_match_jax(monkeypatch, arch):
    """On a one-shard mesh (no process group in the port, one host device
    in JAX) with ring attention, sequence parallelism and flash decode
    all asked for: the port builds a ring in exactly the blocks JAX does
    (dense / moe / vlm only, and not under mixtral's sliding window) and
    flash-decodes exactly the attention layers JAX does, with values
    within 1e-4 of JAX's."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.compat import make_mesh
    from repro.distributed import collectives as JC
    from repro.models import transformer as jtf
    variants = {"attention_impl": "ring", "sequence_parallel": True,
                "flash_decode": True}
    cfg = dataclasses.replace(configs.get(arch, smoke=True), **variants)
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), **variants)
    seq = 64 if cfg.family in ("ssm", "hybrid") else 32
    params = dict(tf.tree_leaves(tf.init_params(
        cfg, torch.Generator().manual_seed(0), max_positions=seq + 8,
        device="cpu")))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, seq))
             .astype(np.int32)}
    if cfg.frontend:
        batch["frontend_embeds"] = rng.normal(
            size=(2, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    token = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    max_seq = seq + cfg.frontend_seq * (cfg.family == "vlm") + 8
    counts = {}
    for side, mod, model, mesh, tensors, run in (
            ("port", C, tf, make_local_mesh(1, device="cpu"),
             lambda a: torch.as_tensor(np.asarray(a)), lambda f: f),
            ("jax", JC, jtf, make_mesh((1, 1), ("data", "model"),
                                       devices=jax.devices()[:1]),
             jnp.asarray, jax.jit)):
        ring = _count(monkeypatch, mod, "ring_attention")
        fd = _count(monkeypatch, mod, "flash_decode")
        c = cfg if side == "port" else jcfg
        p = tf.unflatten({k: tensors(v.numpy()) for k, v in params.items()})
        b = {k: tensors(v) for k, v in batch.items()}
        logits, _ = run(lambda p, b: model.forward(c, p, b, mesh=mesh))(p, b)
        forward_rings = len(ring)
        _, cache = run(lambda p, b: model.prefill(c, p, b, max_seq,
                                                  mesh=mesh))(p, b)
        out, _ = run(lambda p, c_, t: model.decode_step(c, p, c_, t,
                                                        mesh=mesh))(
            p, cache, tensors(token))
        counts[side] = {"forward_rings": forward_rings,
                        "prefill_rings": len(ring) - forward_rings,
                        "flash_decodes": len(fd),
                        "logits": np.asarray(logits),
                        "decode": np.asarray(out)}
    port, want = counts["port"], counts["jax"]
    # JAX traces a scanned block once, so it counts whether, not how often
    for key in ("forward_rings", "prefill_rings", "flash_decodes"):
        assert (port[key] > 0) == (want[key] > 0), (key, port, want)
    rings = cfg.n_layers if cfg.family in ("dense", "moe", "vlm") \
        and not cfg.sliding_window else 0
    assert port["forward_rings"] == port["prefill_rings"] == rings
    attends = {"hybrid": tf.hybrid_n_apps(cfg) if cfg.family == "hybrid"
               else 0, "ssm": 0}.get(cfg.family, cfg.n_layers)
    assert port["flash_decodes"] == attends
    _close(port["logits"], want["logits"], ATTN_TOL)
    _close(port["decode"], want["decode"], ATTN_TOL)


def test_several_shards_without_a_group_are_refused():
    assert not runtime.is_distributed()
    mesh = make_local_mesh(4, model=4, device="cpu")
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(RuntimeError, match="process group"):
        C.ring_attention(mesh)(q, q, q)
    with pytest.raises(RuntimeError, match="process group"):
        C.flash_decode(mesh)(q[:, 0], q, q, torch.tensor(3))
    with pytest.raises(RuntimeError, match="process group"):
        C.ring_allgather_matmul(mesh)(torch.zeros(2, 8), torch.zeros(8, 2))
    with pytest.raises(RuntimeError, match="process group"):
        C.compressed_psum_grads({"w": q}, {"w": q}, mesh=mesh, axis="model")
    cfg = chip_smoke.lm_mesh_config("glm4-9b", "ring")
    params, batch, _ = chip_smoke.lm_mesh_inputs(cfg, 0)
    with pytest.raises(RuntimeError, match="process group"):
        tf.forward(cfg, tf.unflatten(params),
                   {k: torch.as_tensor(v) for k, v in batch.items()},
                   mesh=mesh)

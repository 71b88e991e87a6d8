"""One rank of the distributed LM tests (`test_torch_lm_distributed.py`),
run as its own process on the CPU over gloo:

    python tests/torch_dist_worker.py GROUP RANK WORLD STORE OUT [ARGS...]

GROUP names the checks the rank runs (`_checks`); it joins the process
group through the `file://` STORE, runs them, and pickles {check: result
or the error's text} to OUT/rank_RANK.pkl, so each test reads its own
check's result and one failure does not hide the others.  Only the torch
port is imported here: the JAX side runs in the test's own subprocesses.
"""
from __future__ import annotations

import os
import pickle
import shutil
import sys
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.data.pipeline import TokenSource, shard_batch  # noqa: E402
from repro_torch.distributed import runtime  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.trainer import Trainer, TrainerConfig  # noqa: E402
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset  # noqa: E402

ARCHS = list(configs.ARCHS)
# the step checks: each smoke config with the optimizer its trainer makes
# (AdamW), kimi-k2 with its full config's Adafactor, glm4-9b with SGD
STEP_CASES = ARCHS + ["kimi-k2-1t-a32b:adafactor", "glm4-9b:sgd"]
SEQ, BATCH = 32, 4          # the step checks' batch: B splits over data
LR = 1e-3                   # constant rate, as test_torch_lm_train_step
RUN_ARCH = "glm4-9b"
TCFG = dict(peak_lr=1e-3)


def _mesh(shape):
    return make_local_mesh(shape[0] * shape[1], model=shape[1],
                           device="cpu")


def _init(cfg, seed: int) -> dict:
    return dict(tf.tree_leaves(tf.init_params(
        cfg, torch.Generator().manual_seed(seed), max_positions=SEQ,
        device="cpu")))


def _local(t) -> dict:
    """A DTensor's placements, global offset, local shape and values."""
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return {"placements": [repr(p) for p in t.placements],
            "offset": list(offset), "shape": list(shape),
            "local": t.to_local().numpy().copy()}


def check_placements(shape) -> dict:
    """Every param and opt-state leaf of the ten smoke configs placed by
    the trainer's specs on `shape`: {arch: {"params"|"opt_state": {path:
    `_local`}}} (values only for glm4-9b's, to keep the file small)."""
    mesh = _mesh(shape)
    out = {}
    for seed, name in enumerate(ARCHS):
        cfg = configs.get(name, smoke=True)
        p_specs = shd.param_specs(cfg, mesh, max_positions=SEQ)
        # the optimizer of the full config (kimi-k2: Adafactor)
        o = getattr(opt, configs.get(name).optimizer)()
        o_specs = shd.opt_state_specs(p_specs, o.kind)
        params = shd.shard_tree(tf.unflatten(_init(cfg, seed)), mesh,
                                p_specs)
        state = shd.shard_tree(o.init(params), mesh, o_specs)
        rec = {}
        for what, tree, specs in (("params", params, p_specs),
                                  ("opt_state", state, o_specs)):
            rec[what] = {}
            named = dict(tf.tree_leaves(shd.named(mesh, shd.fit_specs(
                specs, tree, mesh))))
            for path, leaf in tf.tree_leaves(tree):
                info = _local(leaf)
                info["named"] = [repr(p) for p in named[path].placements]
                if name != RUN_ARCH:
                    del info["local"]
                rec[what][path] = info
        out[name] = rec
    return out


def check_shard_batch(shape) -> dict:
    mesh = _mesh(shape)
    batch = TokenSource(512, 16, 8).next_batch(3)
    out = {k: _local(v) for k, v in shard_batch(batch, mesh).items()}
    out["replicated"] = _local(shard_batch(batch, mesh, shd.P())["tokens"])
    return out


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
             .astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
             .astype(np.int32)}
    if cfg.frontend:
        batch["frontend_embeds"] = rng.normal(
            size=(BATCH, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return batch


def _numpy(x):
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_numpy(v) for v in x]
    return x.numpy() if torch.is_tensor(x) else x


def check_steps(shape) -> dict:
    """Each STEP_CASES entry's sharded step on `shape` and the one-device
    step from the same parameters and batch (every rank runs both; rank
    0's kept), by `chip_smoke.lm_dist_step_pair`: {case: its "one",
    "sharded" and "replay" records as numpy}."""
    mesh = _mesh(shape)
    out = {}
    for seed, case in enumerate(STEP_CASES):
        name, _, kind = case.partition(":")
        cfg = configs.get(name, smoke=True)
        o = chip_smoke.lm_dist_optimizer(cfg, LR, kind)
        out[case] = _numpy(chip_smoke.lm_dist_step_pair(
            cfg, mesh, _init(cfg, seed), _batch(cfg, seed), o, SEQ))
    return out


def _stream(cfg, batch: int, seq: int = 16):
    ts = TokenSource(cfg.vocab_size, seq, batch)
    step = 0
    while True:
        yield ts.next_batch(step)
        step += 1


def check_elastic_first(ckpt: str) -> dict:
    """JAX's test_elastic_reshard_8_to_4, part one: 4 steps of glm4-9b's
    smoke config on (4, 2), a checkpoint every 2 (run by 8 ranks)."""
    cfg = configs.get(RUN_ARCH, smoke=True)
    tr = Trainer(cfg, _mesh((4, 2)), ckpt,
                 TrainerConfig(total_steps=4, ckpt_every=2))
    tr.init_or_restore()
    hist = tr.train(_stream(cfg, 8))
    return {"steps": [h["step"] for h in hist],
            "losses": [h["loss"] for h in hist]}


def check_elastic_second(ckpt: str) -> dict:
    """Part two, on 4 ranks: the checkpoint restored onto (2, 2) and run
    to step 6."""
    cfg = configs.get(RUN_ARCH, smoke=True)
    tr = Trainer(cfg, _mesh((2, 2)), ckpt,
                 TrainerConfig(total_steps=6, ckpt_every=2))
    restored = tr.restore()
    step = tr.step
    hist = tr.train(_stream(cfg, 8))
    return {"restored": restored, "resume_step": step, "final": tr.step,
            "losses": [h["loss"] for h in hist]}


def check_from_jax(jax_ckpt: str, port_ckpt: str) -> dict:
    """JAX's step-0 checkpoint (glm4-9b smoke, written on a (2, 2) JAX
    mesh) restored by the sharded `Trainer` on (2, 2) and on (1, 4), each
    run 2 steps; the (2, 2) run's step-2 checkpoint is left in
    `port_ckpt` and the run continued to step 4."""
    cfg = configs.get(RUN_ARCH, smoke=True)
    out = {}
    for shape in ((2, 2), (1, 4)):
        ckpt = f"{port_ckpt}_{shape[0]}x{shape[1]}"
        if runtime.is_primary():
            shutil.copytree(jax_ckpt, ckpt)
        runtime.barrier()
        tr = Trainer(cfg, _mesh(shape), ckpt,
                     TrainerConfig(total_steps=4, ckpt_every=100, **TCFG))
        restored = tr.restore()
        restored_params = dict(tf.tree_leaves(
            convert.lm_params_to_numpy(tr.params)))   # leaf by leaf
        hist = tr.train(_stream(cfg, 4), num_steps=2)
        rec = {"restored": restored, "params0": restored_params,
               "losses": [h["loss"] for h in hist]}
        if shape == (2, 2):
            if runtime.is_primary():
                shutil.copytree(ckpt, port_ckpt)
            runtime.barrier()
            rec["tail"] = [h["loss"] for h in tr.train(_stream(cfg, 4))]
        out[shape] = rec
    return out


def check_pod_data() -> dict:
    """A ("pod", "data")-sharded leaf on a (2, 2, 2) ("pod", "data",
    "model") mesh (8 ranks): its placements and this rank's slice."""
    from repro_torch.distributed.mesh import make_mesh
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                     devices=["cpu"] * 8)
    x = torch.arange(16 * 6, dtype=torch.float32).reshape(16, 6)
    out = {}
    for name, spec in (("pod_data", shd.P(("pod", "data"), "model")),
                       ("data", shd.P("data", None))):
        out[name] = _local(shd.place(x, mesh, spec, src_data_rank=None))
    try:
        shd.placements(shd.P(("data", "pod")), mesh)
        out["reversed"] = None
    except ValueError as e:
        out["reversed"] = str(e)
    return out


def check_raises() -> dict:
    """A mesh the group does not match is refused."""
    out = {}
    try:
        make_local_mesh(runtime.world_size() * 2, device="cpu")
        out["mesh"] = None
    except ValueError as e:
        out["mesh"] = str(e)
    return out


# the mesh cases run on (1, 4) and at world 1 (every case runs on (2, 2))
MESH_1X4_CASES = (("internvl2-1b", "ring"), ("whisper-small", "flash"))
MESH_1X1_CASES = (("glm4-9b", "ring"), ("zamba2-1.2b", "flash"))

# the collectives at the JAX tests' shapes (tests/test_distributed.py)
FD_SHAPE = (4, 32, 8, 2, 16)       # flash decode: B, S, H, KVH, Dh
FD_VALID = 20
RING_SHAPE = (2, 32, 6, 2, 8)      # ring attention: 6 heads, not 4-divisible
MM_SHAPE = (16, 32, 8)             # x (16, 32) @ W (32, 8)
GRAD_SIZE = 64                     # compressed all-reduce: 8 ranks x 64


def collective_inputs() -> dict:
    """The JAX tests' inputs (their numpy seeds), the ring's cotangent and
    two steps of gradients for the compressed all-reduce."""
    B, S, H, KVH, Dh = FD_SHAPE
    rng = np.random.default_rng(0)
    fd = [rng.normal(size=s).astype(np.float32)
          for s in ((B, H, Dh), (B, S, KVH, Dh), (B, S, KVH, Dh))]
    grads = np.random.default_rng(1).normal(size=(8, GRAD_SIZE)) \
        .astype(np.float32)
    rng = np.random.default_rng(2)
    M, K, N = MM_SHAPE
    mm = [rng.normal(size=(M, K)).astype(np.float32),
          rng.normal(size=(K, N)).astype(np.float32)]
    B, S, H, KVH, Dh = RING_SHAPE
    rng = np.random.default_rng(4)
    ring = [rng.normal(size=s).astype(np.float32)
            for s in ((B, S, H, Dh), (B, S, KVH, Dh), (B, S, KVH, Dh))]
    extra = np.random.default_rng(5)
    return {"fd": fd, "grads": [grads, extra.normal(size=grads.shape)
                                .astype(np.float32)],
            "mm": mm, "ring": ring,
            "ring_ct": extra.normal(size=ring[0].shape).astype(np.float32)}


def _int8_sum(local: torch.Tensor, group) -> tuple:
    """The int8 all-reduce spelled out: the shared scale, this rank's int8
    values and their int32 sum over `group`."""
    scale = local.abs().max().clone()
    torch.distributed.all_reduce(scale, torch.distributed.ReduceOp.MAX,
                                 group=group)
    scale = scale / 127.0 + 1e-12
    q = torch.clamp(torch.round(local / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    torch.distributed.all_reduce(total, group=group)
    return scale, q, total


def check_collectives() -> dict:
    """The four collectives on JAX's meshes (8 ranks): flash decode, the
    ring matmul and ring attention (with its gradient) on (2, 4), the
    compressed all-reduce on (8,) "data" (int8 two steps, with the
    residuals carried, and bf16), each beside the one-process emulation
    of its shard bodies and the plain function; flash decode and ring
    attention also on DTensor inputs."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.models import layers as ll
    inp = collective_inputs()
    mesh = _mesh((2, 4))
    rank = runtime.rank()
    idx = rank % 4                                   # index on "model"
    out = {}
    t = {k: [torch.from_numpy(a) for a in v] for k, v in inp.items()
         if isinstance(v, list)}
    q, k, v = t["fd"]
    valid = torch.tensor(FD_VALID, dtype=torch.int32)
    placed = [shd.place(a, mesh, spec, src_data_rank=None) for a, spec in
              ((q, shd.P("data", "model")), (k, shd.P("data", "model")),
               (v, shd.P(None, None, "model")))]
    dt = C.flash_decode(mesh)(*placed, valid)
    out["flash_decode"] = {
        "got": C.flash_decode(mesh)(q, k, v, valid).numpy(),
        "dtensor": dt.full_tensor().numpy(),
        "dtensor_placements": [repr(p) for p in dt.placements],
        "emulated": C.emulate_flash_decode(q, k, v, valid, 4).numpy(),
        "plain": ll.decode_attention(q[:, None], k, v, valid)[:, 0].numpy()}

    x, w = t["mm"]
    out["matmul"] = {
        "got": C.ring_allgather_matmul(mesh, axis="model")(x, w).numpy(),
        "emulated": C.emulate_ring_allgather_matmul(x, w, 4)[idx].numpy(),
        "plain": (x @ w).numpy()}

    q, k, v = (a.requires_grad_() for a in t["ring"])
    ct = torch.from_numpy(inp["ring_ct"])
    rec = {}
    for name, fn in (("got", C.ring_attention(mesh)),
                     ("whole_batch", C.ring_attention(mesh, dp=None)),
                     ("plain", lambda *a: ll.attention(*a, causal=True))):
        o = fn(q, k, v)
        rec[name] = o.detach().numpy()
        rec[name + "_grads"] = [g.numpy() for g in torch.autograd.grad(
            (o * ct).sum(), (q, k, v))]
    with torch.no_grad():
        rec["emulated"] = C.emulate_ring_attention(q, k, v, 4).numpy()
        heads = [shd.place(a, mesh, shd.P("data", None, "model"),
                           src_data_rank=None) for a in (q, k, v)]
        dt = C.ring_attention(mesh)(*heads)
    rec["dtensor"] = dt.full_tensor().numpy()
    rec["dtensor_placements"] = [repr(p) for p in dt.placements]
    rec["dtensor_type"] = type(dt).__name__
    out["ring_attention"] = rec

    mesh8 = make_mesh((8,), ("data",), devices=["cpu"] * 8)
    group = runtime.device_mesh(mesh8).get_group("data")
    rec = {}
    resid = {"w": torch.zeros(GRAD_SIZE)}
    for i, g in enumerate(inp["grads"]):
        local = torch.from_numpy(g[rank])
        spelled = _int8_sum(local + resid["w"], group)
        mean, resid = C.compressed_psum_grads({"w": local}, resid,
                                              mesh=mesh8, axis="data")
        rec[f"int8_{i}"] = {"mean": mean["w"].numpy(),
                            "resid": resid["w"].numpy(),
                            "scale": float(spelled[0]),
                            "q": spelled[1].numpy(),
                            "sum": spelled[2].numpy()}
    g = torch.from_numpy(inp["grads"][0][rank])
    mean, resid = C.compressed_psum_grads({"w": g}, {"w": torch.zeros_like(
        g)}, group, mode="bf16")
    rec["bf16"] = {"mean": mean["w"].numpy(), "resid": resid["w"].numpy()}
    out["compressed"] = rec
    return out


def check_mesh_models(shape, cases) -> dict:
    """Each (arch, variant) of `cases` (`chip_smoke.LM_MESH_CASES`) on
    `shape` through `chip_smoke.lm_mesh_pair`: forward, gradients, a
    train step, prefill and decode steps, with mesh=None and on the
    mesh: {case: record as numpy}."""
    mesh = _mesh(shape)
    out = {}
    for name, variant in cases:
        seed = chip_smoke.LM_MESH_CASES.index((name, variant))
        cfg = chip_smoke.lm_mesh_config(name, variant)
        params, batch, decode = chip_smoke.lm_mesh_inputs(cfg, seed)
        pair = chip_smoke.lm_mesh_pair(cfg, mesh, params, batch, decode,
                                       plain_mesh=shape == (1, 1))
        out[f"{name}/{variant}"] = _numpy(pair)
    return out


def check_moe(shape) -> dict:
    """Each `chip_smoke.LM_MOE_CASES` config's `moe_ffn` on `shape` and
    on one device (`chip_smoke.lm_moe_pair`): {case: the pair}."""
    mesh = _mesh(shape)
    return {chip_smoke.lm_moe_key(name, over): chip_smoke.lm_moe_pair(
        chip_smoke.lm_moe_config(name, over), mesh, seed, "cpu")
        for seed, (name, over) in enumerate(chip_smoke.LM_MOE_CASES)}


def check_expert_products(shape) -> dict:
    """`moe._expert_product` on every pair of placements of a (whole, or
    sharded on g, e or x) and w (whole, or sharded on e, x or y) on each
    mesh dim, in float64: {(a's, w's placements): the largest difference
    of the output and of each gradient from the plain einsum's}."""
    import itertools

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import moe
    mesh = shd._device_mesh(_mesh(shape))
    gen = torch.Generator().manual_seed(0)
    a0, w0, dy = (torch.randn(s, generator=gen, dtype=torch.float64)
                  for s in ((4, 4, 3, 8), (4, 8, 12), (4, 4, 3, 12)))
    a1, w1 = a0.clone().requires_grad_(), w0.clone().requires_grad_()
    (torch.einsum("gecx,exy->gecy", a1, w1) * dy).sum().backward()
    a_places = (Replicate(), Shard(0), Shard(1), Shard(3))
    w_places = (Replicate(), Shard(0), Shard(1), Shard(2))
    out = {}
    for pa in itertools.product(a_places, repeat=mesh.ndim):
        for pw in itertools.product(w_places, repeat=mesh.ndim):
            a = distribute_tensor(a0, mesh, pa).detach().requires_grad_()
            w = distribute_tensor(w0, mesh, pw).detach().requires_grad_()
            y = moe._expert_product(a, w).full_tensor()
            (y * dy).sum().backward()
            out[repr((pa, pw))] = max(
                float((got - want).abs().max()) for got, want in (
                    (y, torch.einsum("gecx,exy->gecy", a0, w0)),
                    (a.grad.full_tensor(), a1.grad),
                    (w.grad.full_tensor(), w1.grad)))
    return out


def main(argv) -> None:
    group, rank, world, store, out = argv[:5]
    torch.set_num_threads(1)
    runtime.initialize(f"file://{store}", int(world), int(rank),
                       device="cpu", timeout_s=300)
    results = {}
    for name, fn in _checks(group, argv[5:]):
        try:
            results[name] = fn()
        except Exception:               # noqa: BLE001 — reported per check
            results[name] = {"error": traceback.format_exc()}
            break                       # the ranks may now be out of step
    with open(os.path.join(out, f"rank_{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    runtime.shutdown()


def _checks(group: str, args: list):
    """(name, thunk) pairs of GROUPS[group], run in order."""
    table = {
        "eight": [("pod_data", check_pod_data),
                  ("placements_4x2", lambda: check_placements((4, 2))),
                  ("shard_batch_4x2", lambda: check_shard_batch((4, 2))),
                  ("elastic_first", lambda: check_elastic_first(args[0]))],
        "four": [("placements_2x2", lambda: check_placements((2, 2))),
                 ("placements_1x4", lambda: check_placements((1, 4))),
                 ("shard_batch_2x2", lambda: check_shard_batch((2, 2))),
                 ("raises", check_raises),
                 ("steps_2x2", lambda: check_steps((2, 2))),
                 ("elastic_second", lambda: check_elastic_second(args[0])),
                 ("from_jax", lambda: check_from_jax(args[1], args[2]))],
        "collectives": [("collectives", check_collectives)],
        "mesh_models": [
            ("models_2x2", lambda: check_mesh_models(
                (2, 2), chip_smoke.LM_MESH_CASES)),
            ("models_1x4", lambda: check_mesh_models(
                (1, 4), MESH_1X4_CASES))],
        "mesh_one": [("models_1x1", lambda: check_mesh_models(
            (1, 1), MESH_1X1_CASES))],
        "moe": [("products_2x2", lambda: check_expert_products((2, 2))),
                ("moe_2x2", lambda: check_moe((2, 2))),
                ("moe_1x4", lambda: check_moe((1, 4)))],
    }
    return table[group]


if __name__ == "__main__":
    main(sys.argv[1:])

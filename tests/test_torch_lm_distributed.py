"""The port's distributed LM trainer (one process a shard, DTensor leaves
placed by the partition specs) against the one-device step and the JAX
package, on the CPU: gloo ranks spawned from the test, each a process of
`tests/torch_dist_worker.py` running a group of checks (one start-up for
many checks), beside JAX on forced host devices in subprocesses (as
tests/test_distributed.py runs it):

  * every param and opt-state leaf of the ten smoke configs on (4, 2),
    (2, 2) and (1, 4): its placements are the spec's (an axis on dim i is
    `Shard(i)` on that mesh dim) and each rank's slice is the one JAX's
    `NamedSharding` gives that device (glm4-9b's values too);
    ``P(("pod", "data"))`` splits pod-major, as JAX does;
  * `shard_batch`: the leading dim over "data", or whole with ``P()``;
  * the ten smoke configs' sharded step on (2, 2) against the one-device
    step, each with its trainer's optimizer (AdamW), kimi-k2 also with
    Adafactor and glm4-9b with SGD (`chip_smoke.lm_dist_step_pair`):
    gradients, loss and grad_norm within rtol = atol = 1e-4, AdamW's
    parameters within `param_rule` (tests/test_torch_lm_train_step.py),
    every optimizer's parameters and state within rounding of the
    one-device update of the same gradients, metrics plain replicated
    0-d tensors;
  * glm4-9b-smoke from one JAX checkpoint: JAX's `Trainer` on a (2, 2)
    mesh and the port's on (2, 2) and on (1, 4), 2 steps each, losses
    within 1e-4; the port's checkpoint then restored by JAX's `Trainer`
    on a (1, 4) mesh and run on: its losses within 1e-4 of the port's;
  * JAX's test_elastic_reshard_8_to_4 on the port: 8 ranks train and
    save, 4 ranks restore onto (2, 2) and run on;
  * a mesh of several shards without a process group, or larger than the
    group, is refused.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.distributed import runtime  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.training.trainer import Trainer  # noqa: E402
from test_torch_lm_train_step import LR, param_rule  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
ARCHS = list(configs.ARCHS)
STEP_CASES = ARCHS + ["kimi-k2-1t-a32b:adafactor", "glm4-9b:sgd"]  # worker's
MESHES = {"4x2": (4, 2), "2x2": (2, 2), "1x4": (1, 4)}
TOL = 1e-4
GROUP_TIMEOUT = 300     # seconds a spawned group may take


def spawn_group(group: str, world: int, out: str, *args) -> list:
    """`world` ranks of the worker's `group`; their results, rank order.
    A rank that fails or outlasts GROUP_TIMEOUT fails the caller."""
    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, "store")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, group, str(r), str(world), store, out,
         *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GROUP_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}: {logs[r][-3000:]}"
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank_{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


JAX_PRELUDE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, shutil, sys
import jax
import numpy as np
from jax.sharding import NamedSharding
from repro import configs
from repro.compat import make_mesh
from repro.data.pipeline import TokenSource
from repro.distributed import sharding as shd
from repro.models import transformer as tf
from repro.training.trainer import Trainer, TrainerConfig
TCFG = dict(peak_lr=1e-3)

def stream(cfg, batch, seq=16):
    ts = TokenSource(cfg.vocab_size, seq, batch)
    step = 0
    while True:
        yield ts.next_batch(step)
        step += 1
"""

JAX_FIRST = """
out = {"slices": {}}
shapes = {"4x2": (4, 2), "2x2": (2, 2), "1x4": (1, 4)}
for key, shape in shapes.items():
    mesh = make_mesh(shape, ("data", "model"),
                     devices=jax.devices()[:shape[0] * shape[1]])
    rec = out["slices"][key] = {}
    for name in configs.ARCHS:
        cfg = configs.get(name, smoke=True)
        p_specs = shd.param_specs(cfg, mesh, max_positions=32)
        kind = "adafactor" if name.startswith("kimi") else "adamw"
        o_specs = shd.opt_state_specs(p_specs, kind)
        shapes_p = tf.param_shapes(cfg, max_positions=32)
        is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
        leaves = {}
        for what, specs in (("params", p_specs), ("opt_state", o_specs)):
            for path, spec in jax.tree_util.tree_leaves_with_path(
                    specs, is_leaf=is_spec):
                keys = [p.key for p in path]
                leaves[what + ":" + "/".join(keys)] = list(spec)
        rec[name] = {k: [None if a is None else list(a) if isinstance(a, tuple)
                         else a for a in v] for k, v in leaves.items()}
        devs = {d: i for i, d in enumerate(mesh.devices.flat)}
        idx = {}
        for path, spec in jax.tree_util.tree_leaves_with_path(
                p_specs, is_leaf=is_spec):
            keys = [p.key for p in path]
            shape_ = shapes_p
            for k in keys:
                shape_ = shape_[k]
            m = NamedSharding(mesh, spec).devices_indices_map(tuple(shape_))
            idx["/".join(keys)] = {devs[d]: [[s.start or 0, s.stop if s.stop
                                              is not None else n]
                                             for s, n in zip(sl, shape_)]
                                   for d, sl in m.items()}
        rec[name] = {"specs": rec[name], "slices": idx}
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
devs = {d: i for i, d in enumerate(mesh.devices.flat)}
m = NamedSharding(mesh, jax.sharding.PartitionSpec(("pod", "data"), "model")
                  ).devices_indices_map((16, 6))
out["pod_data"] = {devs[d]: [[s.start or 0, s.stop or n] for s, n in
                             zip(sl, (16, 6))] for d, sl in m.items()}

cfg = configs.get("glm4-9b", smoke=True)
mesh = make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
tr = Trainer(cfg, mesh, sys.argv[1], TrainerConfig(total_steps=4,
             ckpt_every=100, **TCFG))
tr.initialize()
tr.save(blocking=True)
shutil.copytree(os.path.join(sys.argv[1], "step_000000000"), sys.argv[2])
hist = tr.train(stream(cfg, 4), num_steps=2)
out["losses"] = [h["loss"] for h in hist]
print(json.dumps(out))
"""

JAX_SECOND = """
cfg = configs.get("glm4-9b", smoke=True)
mesh = make_mesh((1, 4), ("data", "model"), devices=jax.devices()[:4])
tr = Trainer(cfg, mesh, sys.argv[1], TrainerConfig(total_steps=4,
             ckpt_every=100, **TCFG))
ok = tr.restore()
step = tr.step
hist = tr.train(stream(cfg, 4))
print(json.dumps({"restored": ok, "step": step,
                  "losses": [h["loss"] for h in hist]}))
"""


def jax_process(body: str, *args) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_PRELUDE + body), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def jax_result(proc: subprocess.Popen) -> dict:
    stdout, stderr = proc.communicate(timeout=GROUP_TIMEOUT)
    assert proc.returncode == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's slices and trainer run beside the 8-rank group, then the
    4-rank group on their checkpoints, then JAX on the port's."""
    tmp = tmp_path_factory.mktemp("lm_dist")
    jax_first = jax_process(JAX_FIRST, str(tmp / "jax_run"),
                            str(tmp / "jax_step0" / "step_000000000"))
    eight = spawn_group("eight", 8, str(tmp / "eight"),
                        str(tmp / "elastic"))
    jax = jax_result(jax_first)
    four = spawn_group("four", 4, str(tmp / "four"), str(tmp / "elastic"),
                       str(tmp / "jax_step0"), str(tmp / "port"))
    jax["second"] = jax_result(jax_process(JAX_SECOND, str(tmp / "port")))
    return {"jax": jax, "eight": eight, "four": four,
            "jax_step0": str(tmp / "jax_step0" / "step_000000000")}


def result(ranks: list, check: str, rank: int = 0):
    got = ranks[rank].get(check)
    assert got is not None, f"{check} did not run: {ranks[rank]}"
    assert not (isinstance(got, dict) and "error" in got), got["error"]
    return got


def expected_placements(spec, axes) -> list:
    out = ["Replicate()"] * len(axes)
    for dim, part in enumerate(spec):
        for a in ([] if part is None else part if isinstance(part, list)
                  else [part]):
            out[axes.index(a)] = f"Shard(dim={dim})"
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_placed_by_the_specs_as_jax_slices_them(runs, arch, mesh):
    ranks = runs["eight"] if mesh == "4x2" else runs["four"]
    jax = runs["jax"]["slices"][mesh][arch]
    want_p = dict(tf_leaves(torch_init(arch)))
    for r, rank in enumerate(ranks):
        got = result(ranks, f"placements_{mesh}", r)[arch]
        for what in ("params", "opt_state"):
            for path, info in got[what].items():
                spec = jax["specs"][f"{what}:{path}"]
                assert info["placements"] == expected_placements(
                    spec, ["data", "model"]), (r, what, path, spec)
                assert info["named"] == info["placements"], (r, path)
                if what != "params":
                    continue
                sl = jax["slices"][path][str(r)]
                assert info["offset"] == [a for a, _ in sl], (r, path)
                assert info["shape"] == [b - a for a, b in sl], (r, path)
                if "local" in info:
                    np.testing.assert_array_equal(
                        info["local"], want_p[path][tuple(
                            slice(a, b) for a, b in sl)], err_msg=path)


def torch_init(arch: str) -> dict:
    from repro_torch.models import transformer as tf
    cfg = configs.get(arch, smoke=True)
    return tf.init_params(cfg, torch.Generator().manual_seed(
        ARCHS.index(arch)), max_positions=32, device="cpu")


def tf_leaves(tree):
    from repro_torch.models import transformer as tf
    return [(k, v.numpy()) for k, v in tf.tree_leaves(tree)]


def test_pod_data_splits_pod_major_as_jax(runs):
    ranks = runs["eight"]
    x = np.arange(16 * 6, dtype=np.float32).reshape(16, 6)
    for r in range(8):
        got = result(ranks, "pod_data", r)
        sl = runs["jax"]["pod_data"][str(r)]
        info = got["pod_data"]
        assert info["placements"] == ["Shard(dim=0)", "Shard(dim=0)",
                                      "Shard(dim=1)"]
        assert info["offset"] == [a for a, _ in sl]
        np.testing.assert_array_equal(info["local"], x[tuple(
            slice(a, b) for a, b in sl)])
        assert got["data"]["placements"] == ["Replicate()", "Shard(dim=0)",
                                             "Replicate()"]
        assert "order" in got["reversed"]


@pytest.mark.parametrize("mesh", ["4x2", "2x2"])
def test_shard_batch(runs, mesh):
    ranks = runs["eight"] if mesh == "4x2" else runs["four"]
    shape = MESHES[mesh]
    from repro_torch.data.pipeline import TokenSource
    batch = TokenSource(512, 16, 8).next_batch(3)
    rows = 8 // shape[0]
    for r, rank in enumerate(ranks):
        got = result(ranks, f"shard_batch_{mesh}", r)
        lo = (r // shape[1]) * rows
        for k, v in batch.items():
            assert got[k]["placements"] == ["Shard(dim=0)", "Replicate()"]
            np.testing.assert_array_equal(got[k]["local"], v[lo:lo + rows])
        whole = got["replicated"]
        assert whole["placements"] == ["Replicate()", "Replicate()"]
        np.testing.assert_array_equal(whole["local"], batch["tokens"])


@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_equals_the_one_device_step(runs, case):
    got = result(runs["four"], "steps_2x2")[case]
    one, sharded, replay = got["one"], got["sharded"], got["replay"]
    for path, want in one["grads"].items():
        np.testing.assert_allclose(sharded["grads"][path], want, rtol=TOL,
                                   atol=TOL, err_msg=f"{case} {path}")
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(sharded["metrics"][k], one["metrics"][k],
                                   rtol=TOL, atol=TOL, err_msg=f"{case} {k}")
    assert sharded["metric_types"] == ["Tensor"] and sharded["count"] == 1
    assert sharded["state"].keys() == one["state"].keys()
    # the sharded optimizer (AdamW, Adafactor with vr / vc over sharded
    # dims, SGD) against the one-device update of its gradients
    for what in ("params", "state"):
        rtol, atol = chip_smoke.LM_DIST_REPLAY[what]
        for path, want in replay[what].items():
            np.testing.assert_allclose(sharded[what][path], want, rtol=rtol,
                                       atol=atol * LR,
                                       err_msg=f"{case} {what} {path}")
    if ":" in case or configs.get(case, smoke=True).optimizer != "adamw":
        return
    rule = param_rule(one["grads"], one["params"],
                      one["metrics"]["grad_norm"])
    for path, want in one["params"].items():
        err = np.abs(sharded["params"][path].astype(np.float64) - want)
        assert (err <= rule[path]).all(), (case, path, float(err.max()))


def test_glm4_smoke_matches_jax_trainer_on_2x2(runs):
    got = result(runs["four"], "from_jax")
    want = runs["jax"]["losses"]
    assert len(want) == 2
    for shape in ((2, 2), (1, 4)):
        rec = got[shape]
        assert rec["restored"]
        np.testing.assert_allclose(rec["losses"], want, rtol=TOL, atol=TOL,
                                   err_msg=str(shape))


def test_checkpoint_crosses_packages_both_ways(runs):
    from repro_torch.models import transformer as tf
    from repro_torch.training.checkpoint import load_step
    got = result(runs["four"], "from_jax")
    # JAX -> port: JAX's step-0 checkpoint (written on a JAX (2, 2) mesh)
    # placed on (2, 2) and on (1, 4) holds its leaves bit for bit
    saved = dict(tf.tree_leaves(load_step(runs["jax_step0"])["params"]))
    for shape in ((2, 2), (1, 4)):
        params0 = got[shape]["params0"]
        assert params0.keys() == saved.keys()
        for path, want in saved.items():
            np.testing.assert_array_equal(params0[path], want, err_msg=path)
    # port -> JAX: JAX's Trainer on a (1, 4) mesh resumes the port's
    # step-2 checkpoint (written by 4 ranks on (2, 2)) and runs on
    second = runs["jax"]["second"]
    assert second["restored"] and second["step"] == 2
    np.testing.assert_allclose(second["losses"], got[(2, 2)]["tail"],
                               rtol=TOL, atol=TOL)


def test_elastic_reshard_8_to_4(runs):
    first = result(runs["eight"], "elastic_first")
    assert first["steps"] == [1, 2, 3, 4]
    for r in range(4):
        res = result(runs["four"], "elastic_second", r)
        assert res["restored"] and res["resume_step"] == 4
        assert res["final"] == 6 and len(res["losses"]) == 2
        assert all(np.isfinite(res["losses"]))


def test_mesh_larger_than_the_group_or_without_one_is_refused(runs,
                                                              tmp_path):
    assert "one a rank" in result(runs["four"], "raises")["mesh"]
    assert not runtime.is_distributed()
    cfg = configs.get("glm4-9b", smoke=True)
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(cfg, make_local_mesh(4, model=2, device="cpu"), tmp_path)
    with pytest.raises(RuntimeError, match="process group"):
        runtime.device_mesh(make_local_mesh(2, device="cpu"))
    with pytest.raises(RuntimeError, match="process group"):
        shd.named(make_local_mesh(2, device="cpu"),
                  shd.P("data", None))

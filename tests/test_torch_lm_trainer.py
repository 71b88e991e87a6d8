"""The port's LM trainer (`repro_torch.training.trainer`), its token
pipeline and its checkpoints, against the JAX package's, on the CPU at
internvl2-1b's smoke config (the dense GQA decoder behind 16 image
positions, zero frontend embeddings, as the launcher feeds it):

  * cross-package resume, both ways: one package's `Trainer` runs 3
    steps and saves; the other's restores that checkpoint and runs to 5,
    while the first continues to 5 from a copy.  The step-4 losses come
    from identical parameters and must agree within rtol = atol = 1e-4
    (the forward's rule); so must the step-5 losses: step 4's AdamW update
    may move the few parameters whose gradient lies within ~1e-4 of 0 by
    up to 2 lr (tests/test_torch_lm_train_step.py, `param_rule`), which
    moves the loss by at most their |g| x 2 lr each, far below 1e-4.
    The restored state equals the checkpoint bit for bit;
  * the port's own crash at `fail_at=5` and resume from step 3 give the
    uninterrupted run's losses, parameters and optimizer state bit for
    bit;
  * JAX's straggler test on the port;
  * `TokenSource` and `BatchIterator` batches equal JAX's exactly, and
    JAX's pipeline tests on the port;
  * the optimizer-state converter and the checkpoint's bfloat16 refusal;
  * the trainer's specs equal JAX's trainer's; a mesh of several shards
    is refused without a process group, and in a group of 2 gloo ranks
    the sharded trainer's init is the one-device init bit for bit; a
    card-less "cuda" mesh is refused.
"""
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.compat import make_mesh as jmake_mesh  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.trainer import Trainer as JTrainer  # noqa: E402
from repro.training.trainer import TrainerConfig as JTrainerConfig  # noqa
from repro_torch import configs, convert  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training.trainer import Trainer, TrainerConfig  # noqa: E402

torch.set_num_threads(1)

ARCH = "internvl2-1b"
SEQ, BATCH = 16, 2
LOSS_RULE = dict(rtol=1e-4, atol=1e-4)
TCFG = dict(total_steps=5, ckpt_every=3, peak_lr=1e-3)


def _batches(cfg, source_cls):
    ts = source_cls(cfg.vocab_size, SEQ, BATCH)
    step = 0
    while True:
        b = ts.next_batch(step)
        if cfg.frontend:
            b["frontend_embeds"] = np.zeros(
                (BATCH, cfg.frontend_seq, cfg.d_model), np.float32)
        yield b
        step += 1


def _jax_trainer(ckpt):
    cfg = jconfigs.get(ARCH, smoke=True)
    tr = JTrainer(cfg, jmake_mesh((1, 1), ("data", "model")), ckpt,
                  JTrainerConfig(**TCFG))
    tr.init_or_restore()
    return tr, lambda: _batches(cfg, jpipeline.TokenSource)


def _port_trainer(ckpt, **kw):
    cfg = configs.get(ARCH, smoke=True)
    tr = Trainer(cfg, make_local_mesh(device="cpu"), ckpt,
                 TrainerConfig(**{**TCFG, **kw}))
    tr.init_or_restore()
    return tr, lambda: _batches(cfg, pipeline.TokenSource)


def _losses(history):
    return {h["step"]: h["loss"] for h in history}


@pytest.mark.parametrize("first", ["jax", "port"])
def test_resume_across_the_packages(first, tmp_path):
    make = {"jax": _jax_trainer, "port": _port_trainer}
    second = "port" if first == "jax" else "jax"
    a, batches = make[first](tmp_path / "a")
    head = _losses(a.train(batches(), num_steps=3))
    assert sorted(head) == [1, 2, 3] and a.step == 3
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    b, batches_b = make[second](tmp_path / "b")
    assert b.step == 3
    saved = CheckpointManager(tmp_path / "a").restore(3)
    for (path, got), (_, want) in zip(
            tf.tree_leaves(convert.lm_params_to_numpy(b.params)
                           if second == "port" else
                           jax.tree_util.tree_map(np.asarray, b.params)),
            tf.tree_leaves(saved["params"])):
        np.testing.assert_array_equal(got, want, err_msg=path)
    tail_b = _losses(b.train(batches_b()))
    tail_a = _losses(a.train(batches()))
    assert sorted(tail_a) == sorted(tail_b) == [4, 5]
    for step in (4, 5):
        np.testing.assert_allclose(tail_b[step], tail_a[step], **LOSS_RULE,
                                   err_msg=f"step {step}")
    assert tail_a[5] != tail_a[4]


def test_crash_and_resume_give_the_uninterrupted_bits(tmp_path):
    whole, batches = _port_trainer(tmp_path / "whole", total_steps=8)
    want = _losses(whole.train(batches()))
    tr, batches = _port_trainer(tmp_path / "crash", total_steps=8)
    with pytest.raises(RuntimeError, match="injected"):
        tr.train(batches(), fail_at=5)
    # restart from scratch objects: it must resume from step 3's checkpoint
    tr2, batches = _port_trainer(tmp_path / "crash", total_steps=8)
    assert tr2.step == 3
    got = _losses(tr2.train(batches()))
    assert tr2.step == 8 and sorted(got) == [4, 5, 6, 7, 8]
    assert {s: want[s] for s in got} == got
    for (path, a), (_, b) in zip(tf.tree_leaves(tr2.params),
                                 tf.tree_leaves(whole.params)):
        assert torch.equal(a, b), path
    for (path, a), (_, b) in zip(tf.tree_leaves(tr2.opt_state),
                                 tf.tree_leaves(whole.opt_state)):
        assert torch.equal(a, b), path


def test_straggler_detection(tmp_path):
    """Artificially slow step is recorded as a straggler."""
    cfg = configs.get("glm4-9b", smoke=True)
    ts = pipeline.TokenSource(cfg.vocab_size, 16, 2)
    tr = Trainer(cfg, make_local_mesh(device="cpu"), tmp_path,
                 TrainerConfig(total_steps=6, ckpt_every=100,
                               straggler_factor=2.0))
    tr.init_or_restore()
    real_step = tr._step
    calls = {"n": 0}

    def slow_step(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 6:            # injected straggler on step 6
            time.sleep(max(2.5 * 2.0 * (sum(tr.step_times) /
                                        max(len(tr.step_times), 1)), 0.2))
        return real_step(*a, **kw)

    tr._step = slow_step

    def batches():
        s = 0
        while True:
            yield ts.next_batch(s)
            s += 1

    tr.train(batches())
    assert len(tr.step_times) == 6
    assert 5 in tr.straggler_steps, (tr.straggler_steps, tr.step_times)


def test_token_source_and_batch_iterator_equal_jax():
    for vocab, seq, batch, seed in ((100, 16, 4, 0), (512, 33, 3, 7)):
        ours = pipeline.TokenSource(vocab, seq, batch, seed=seed)
        theirs = jpipeline.TokenSource(vocab, seq, batch, seed=seed)
        for step in (None, 0, 5, None):
            a, b = ours.next_batch(step), theirs.next_batch(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        for a, b, _ in zip(ours, theirs, range(3)):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
    arrays = {"x": np.arange(103), "y": np.arange(103) * 2.0}
    for kw in ({}, {"shuffle": False}, {"drop_remainder": False},
               {"seed": 3}):
        ours = pipeline.BatchIterator(arrays, 10, **kw)
        theirs = jpipeline.BatchIterator(arrays, 10, **kw)
        for _ in range(2):                # two epochs of each stream
            got, want = list(ours), list(theirs)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                for k in arrays:
                    np.testing.assert_array_equal(a[k], b[k])


def test_batch_iterator_covers_epoch():
    arrays = {"x": np.arange(103), "y": np.arange(103) * 2}
    it = pipeline.BatchIterator(arrays, batch_size=10, seed=0)
    seen = np.concatenate([b["x"] for b in it])
    assert len(seen) == 100 and len(np.unique(seen)) == 100
    for b in pipeline.BatchIterator(arrays, batch_size=10, seed=0):
        np.testing.assert_array_equal(b["y"], b["x"] * 2)
    with pytest.raises(ValueError, match="ragged"):
        pipeline.BatchIterator({"x": np.arange(3), "y": np.arange(4)}, 2)


def test_token_source_deterministic_by_step():
    ts = pipeline.TokenSource(100, 16, 4)
    a = ts.next_batch(7)
    b = ts.next_batch(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].max() < 100
    # next-token labels
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


@pytest.mark.parametrize("kind", ["adamw", "adafactor", "sgd"])
def test_opt_state_converts_both_ways(kind):
    params = {"blocks": {"w": np.ones((2, 3, 4), np.float32)},
              "b": np.zeros((5,), np.float32)}
    jo, po = getattr(jopt, kind)(), getattr(opt, kind)()
    jstate = jax.tree_util.tree_map(np.asarray, jo.init(
        jax.tree_util.tree_map(jax.numpy.asarray, params)))
    ours = convert.lm_opt_state_from_numpy(jstate)
    want = po.init(convert.lm_params_from_numpy(params))
    for (pa, a), (pb, b) in zip(tf.tree_leaves(ours), tf.tree_leaves(want)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
    back = convert.lm_opt_state_to_numpy(ours)
    for (pa, a), (_, b) in zip(tf.tree_leaves(back), tf.tree_leaves(jstate)):
        assert a.dtype == b.dtype, pa
        np.testing.assert_array_equal(a, b)


def test_checkpoint_refuses_bfloat16(tmp_path):
    cm = CheckpointManager(tmp_path, async_save=False)
    with pytest.raises(TypeError, match="bfloat16"):
        cm.save(1, {"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert cm.latest() is None


SHARDED_TRAINER = """
import sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
from repro_torch import configs
from repro_torch.distributed import runtime
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import transformer as tf
from repro_torch.training.trainer import Trainer
torch.set_num_threads(1)
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
runtime.initialize("file://" + store, 2, rank, device="cpu")
tr = Trainer(configs.get({arch!r}, smoke=True),
             make_local_mesh(model=2, device="cpu"), out)
tr.initialize()
specs = dict(tf.tree_leaves(tr.p_specs))
whole = {{}}
for path, leaf in tf.tree_leaves(tr.params):
    assert leaf.placements == shd.placements(specs[path], tr.mesh), path
    whole[path.replace("/", ".")] = leaf.full_tensor().numpy()
for path, leaf in tf.tree_leaves(tr.opt_state):
    assert leaf.placements[0].is_replicate(), path
if runtime.is_primary():
    np.savez(out + "/params.npz", **whole)
runtime.shutdown()
"""


def test_trainer_specs_equal_jax_and_one_shard_only(tmp_path):
    cfg, jcfg = configs.get(ARCH), jconfigs.get(ARCH)
    jtr = JTrainer(jcfg, jmake_mesh((1, 1), ("data", "model")),
                   tmp_path / "j", JTrainerConfig())
    tr = Trainer(cfg, make_local_mesh(device="cpu"), tmp_path / "p")
    for mine, theirs in ((tr.p_specs, jtr.p_specs), (tr.o_specs,
                                                     jtr.o_specs)):
        flat = dict(tf.tree_leaves(mine))
        is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
        want = jax.tree_util.tree_leaves_with_path(theirs, is_leaf=is_spec)
        assert len(flat) == len(want)
        for path, spec in want:
            key = "/".join(p.key for p in path)
            assert tuple(flat[key]) == tuple(spec), key
    # a mesh of several shards trains one process a shard: refused
    # without a process group, and in a group of 2 gloo ranks its leaves
    # are DTensors placed by those specs whose whole values are the
    # one-device trainer's init, bit for bit
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(cfg, make_local_mesh(2, device="cpu"), tmp_path / "q")
    one = Trainer(configs.get(ARCH, smoke=True),
                  make_local_mesh(device="cpu"), tmp_path / "one")
    one.initialize()
    want = {k: v.numpy() for k, v in tf.tree_leaves(one.params)}
    code = SHARDED_TRAINER.format(src=str(pathlib.Path(__file__).parents[1]
                                          / "src"), arch=ARCH)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(tmp_path / "store"),
         str(tmp_path / "q")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    got = np.load(tmp_path / "q" / "params.npz")
    assert sorted(got.files) == sorted(k.replace("/", ".") for k in want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k.replace("/", ".")], v,
                                      err_msg=k)
    if not torch.cuda.is_available():
        from repro_torch.distributed.mesh import make_mesh
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(cfg, make_mesh((1, 1), ("data", "model"),
                                   devices=["cuda"]), tmp_path / "r")

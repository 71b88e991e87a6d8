"""LM training: the program's `Trainer` on a one-card mesh, its steps
(`models.steps.make_train_step`, `training.optimizer.make`) filling the
window.

Traffic parameters:
  batch, seq_len       sequences a step and tokens a sequence
  doc_median, doc_sigma
                       document lengths, log-normal (median, sigma)
  zipf_s               token ids drawn Zipf(s) over ids 1 .. V - 1 by
                       rank; id 0 ends a document
  warm_steps           steps of set-up, which run every shape the window
                       runs and time a step
  min_steps            the fewest steps of the window
  sampled_leaves       leaves whose update the check reads, each at a layer
                       drawn from the seed
  sample_elements      elements drawn from each of them
  own_moment_limit     {sampled leaf: check name}: leaves whose first
                       moment is judged apart, under a limit of its own
                       (a leaf of the held experts by its whole size)
  limits               {check name: limit}

Set-up builds the trainer, gives it the weights made from the seed
(`reference.kimi_k2.init_leaf`, the reference's own rule, in place of the
trainer's draw), runs the warm steps on batches of their own, sizes the
window from the last warm step's time, then puts the weights and the
optimizer state back to the seeded start (step 0).  The window is
`Trainer.train` over as many steps as fill `seconds`, no checkpoint among
them; the time a step is the window over its steps.  After the window's
second step the sampled elements of the sampled leaves, and the correction
bias, are copied aside.

The check replays the window's first two steps in the reference (float32,
the same seeded weights and batches, AdamW at the same warmup rates) and
compares, for each step, the cross entropy (`ce_rel_err`, relative) and
the global gradient norm (`grad_norm_rel_err`, relative), and after the
second step the sampled parameters' updates (`param_update_err`, the
largest over the sampled leaves of `update_err`: the update's direction
and size against the reference's).  The update is judged as a whole
because AdamW's first steps move each parameter by about the rate times
the sign of its gradient: where a gradient lies within the rounding of
zero the program and the reference move it by +-lr, a largest difference
of twice the largest update whatever else is right.  Since that update
also forgets the gradient's size, the same leaves' AdamW first moment
after the second step (a weighted sum of the two steps' clipped
gradients) is judged the same way (`moment_err`): a gradient off by a
factor moves no other number.  The leaves of `own_moment_limit` are
judged apart, each under its own limit: the router (`router_moment_err`),
whose gradient moves with every near-tied top-8 choice that rounding
flips, the same way; a leaf of the held experts (`expert_moment_err`) by
the size alone of its whole first moment, every layer and held expert
(|norm ratio - 1|), since a flipped choice moves rows between experts
and leaves the sum's size (the routed experts' weights left unscaled
read 1 - 1 / 2.827, the lower precision's clip scale ~0.08).  It also
reports, without a limit, the selections the held experts computed a step
against the reference's, the correction-bias entries that differ after
two steps (each a load that fell on the other side of the mean: a top-8
choice flipped between near-tied experts), and, for a sampled leaf of the
held experts, each expert's own first-moment reading beside the loads the
reference gave it in the two steps (an expert that near-tied choices
leave with a few rows reads far more than the layer's experts together).
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchlib import spec
from benchlib.drivers import common

from reference import kimi_k2 as ref

def packed_batch(rng: np.random.Generator, mix: dict, vocab: int
                 ) -> np.ndarray:
    """(batch, seq_len + 1) token ids: documents of log-normal lengths,
    each ended by id 0, packed back to back; ids Zipf over 1 .. V - 1."""
    B, S = mix["batch"], mix["seq_len"] + 1
    ranks = np.arange(1, vocab)
    p = ranks ** -float(mix["zipf_s"])
    out = rng.choice(ranks, size=(B, S), p=p / p.sum())
    for b in range(B):
        end = -1
        while True:
            end += 1 + max(1, int(round(rng.lognormal(
                np.log(mix["doc_median"]), mix["doc_sigma"]))))
            if end >= S:
                break
            out[b, end] = 0
    return out


def _expert_norms(tree: dict, plan: dict) -> dict:
    """{path: (layers, held experts) norms} of the sampled leaves of
    `tree` ({path: tensor}) that have a held-expert axis."""
    return {p: tree[p].float().norm(dim=(-2, -1)).cpu() for p in plan
            if tree[p].dim() == 4}


def update_err(got: torch.Tensor, want: torch.Tensor
               ) -> tuple[float, float, float]:
    """(error, cosine, norm ratio) of update `got` against the reference's
    `want`: the larger of 1 - their cosine (the direction) and |their norm
    ratio - 1| (the size).  Under AdamW's first, sign-like steps a share f
    of gradients rounded across zero reads about 2 f; an update left out or
    doubled reads 1; a precision that cannot hold the update, far more."""
    got, want = got.double(), want.double()
    if not want.any():                   # e.g. an expert no token chose
        return (0.0 if not got.any() else float("inf")), 1.0, 1.0
    size = float(got.norm() / want.norm())
    cos = float(got @ want / (got.norm() * want.norm()).clamp_min(1e-300))
    e = max(1.0 - cos, abs(size - 1.0))
    return (e if np.isfinite(e) else float("inf")), cos, size


def size_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got / want - 1| of two norms (0 where both are 0)."""
    got, want = float(got), float(want)
    if not want:
        return 0.0 if not got else float("inf")
    return abs(got / want - 1.0)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, devices,
                 seconds: float):
        self.c, self.mix, self.seed = config, traffic, seed
        self.dev, self.seconds = devices[0], seconds

    # -- inputs ------------------------------------------------------------
    def _batches(self, kind: int, n: int) -> list[dict]:
        out = []
        for i in range(n):
            rng = np.random.default_rng([self.seed, kind, i])
            t = torch.as_tensor(packed_batch(rng, self.mix,
                                             self.c["vocab_size"]),
                                device=self.dev)
            out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
        return out

    def _sample_plan(self) -> dict:
        """{path: (index of the slice, flat element indices)}: each sampled
        leaf at a layer drawn from the seed (a routed expert's leaf over
        all the layer's held experts: one alone may have no token)."""
        rng = np.random.default_rng([self.seed, 2])
        shapes = ref.param_shapes(self.c)
        plan = {}
        for path in self.mix["sampled_leaves"]:
            shape = shapes[path]
            at = (int(rng.integers(shape[0])),)
            size = int(np.prod(shape[1:]))
            n = min(size, int(self.mix["sample_elements"]))
            idx = torch.as_tensor(rng.choice(size, n, replace=False),
                                  device=self.dev)
            plan[path] = (at, idx)
        return plan

    def _take(self, leaves: dict) -> dict:
        """The sampled elements of `leaves` ({path: tensor}), and the
        buffers (the correction bias) where they are among them."""
        out = {path: leaves[path][at].reshape(-1)[idx].float().clone()
               for path, (at, idx) in self.plan.items()}
        out.update({path: leaf.float().clone()
                    for path, leaf in leaves.items() if ref.is_buffer(path)})
        return out

    # -- the program -------------------------------------------------------
    def _seeded_start(self) -> None:
        """The trainer at step 0, its weights the seeded ones and its
        optimizer state zero."""
        from repro_torch.models import transformer as tf
        t = self.trainer
        t.params = t.opt_state = None
        gc.collect()
        t.initialize()
        leaves = dict(tf.tree_leaves(t.params))
        if sorted(leaves) != sorted(ref.param_shapes(self.c)):
            raise ValueError("the program's parameters are not the "
                             "reference's layout")
        with torch.no_grad():
            for path, leaf in leaves.items():
                leaf.copy_(ref.init_leaf(self.c, self.seed, path, self.dev))

    def setup(self) -> None:
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.training.trainer import Trainer, TrainerConfig

        a = self.c["adamw"]
        parts = self.setup_parts = {}
        from repro_torch.configs import kimi_k2_instruct
        with common.phase(parts, "trainer"):
            self.cfg = kimi_k2_instruct.from_published(self.c)
            self.trainer = Trainer(
                self.cfg, make_local_mesh(1, device=self.dev),
                str(spec.BENCH_DIR.parent / "build" / "lm_train_ckpt"),
                TrainerConfig(total_steps=a["total_steps"], ckpt_every=0,
                              peak_lr=a["peak_lr"]), seed=self.seed)
        with common.phase(parts, "weights"):
            self._seeded_start()
        warm_steps = int(self.mix["warm_steps"])
        with common.phase(parts, "inputs"):
            warm = self._batches(0, warm_steps)
        with common.phase(parts, "warm steps"):
            self.trainer.train(iter(warm), num_steps=warm_steps)
        step_s = self.trainer.step_times[-1]
        self.n_steps = max(int(self.mix["min_steps"]),
                           int(round(self.seconds / max(step_s, 1e-4))))
        with common.phase(parts, "inputs"):
            self.batches = self._batches(1, self.n_steps)
            self.plan = self._sample_plan()
        with common.phase(parts, "weights"):
            self._seeded_start()

    def window(self) -> dict:
        from repro_torch.models import transformer as tf
        t = self.trainer
        t0 = time.perf_counter()
        with common.host_span("train/window"):
            history = t.train(iter(self.batches), num_steps=2)
            after = self._take(dict(tf.tree_leaves(t.params)))
            moment = self._take(dict(tf.tree_leaves(t.opt_state["m"])))
            moment_norms = _expert_norms(dict(tf.tree_leaves(
                t.opt_state["m"])), self.plan)
            history += t.train(iter(self.batches), num_steps=self.n_steps)
        elapsed = time.perf_counter() - t0
        self.out = {"ce": [h["ce"] for h in history[:2]],
                    "grad_norm": [h["grad_norm"] for h in history[:2]],
                    "held": [h["held_selections"] for h in history[:2]],
                    "after": after, "moment": moment,
                    "moment_norms": moment_norms}
        n = len(history)
        c = self.c
        return {
            "window_s": elapsed, "attempted": self.n_steps,
            "failed": self.n_steps - n,
            "e2e": {"train_step_ms": elapsed / n * 1e3},
            "facts": {"steps": n, "step_s": elapsed / n,
                      "held_selections": [h["held_selections"]
                                          for h in history],
                      "lm": {"batch": self.mix["batch"],
                             "seq_len": self.mix["seq_len"],
                             "d_model": c["hidden_size"],
                             "heads": c["num_attention_heads"],
                             "q_lora": c["q_lora_rank"],
                             "kv_lora": c["kv_lora_rank"],
                             "nope": c["qk_nope_head_dim"],
                             "rope": c["qk_rope_head_dim"],
                             "v_dim": c["v_head_dim"],
                             "d_ff": c["intermediate_size"],
                             "moe_d_ff": c["moe_intermediate_size"],
                             "shared": c["n_shared_experts"],
                             "experts": c["router_experts"],
                             "dense_layers": c["first_k_dense_replace"],
                             "layers": c["num_hidden_layers"],
                             "vocab": c["vocab_size"]}},
        }

    def release(self) -> None:
        del self.trainer

    # -- the check ---------------------------------------------------------
    def _replay(self, dtype, leaf_dtype) -> dict:
        """The reference's two steps from the seeded start on the window's
        first two batches, in `dtype` with the leaves kept in
        `leaf_dtype`: the outputs the check reads."""
        params = {p: v.to(leaf_dtype) for p, v in
                  ref.init_params(self.c, self.seed, self.dev).items()}
        state: dict = {}
        ce, gn, held, loads = [], [], [], []
        G, off = self.c["n_routed_experts"], self.c["expert_offset"]
        for i in range(2):
            b = self.batches[i]
            r = ref.step(self.c, params, state, b["tokens"], b["labels"],
                         i + 1, dtype, leaf_dtype)
            ce.append(r["ce"])
            gn.append(r["grad_norm"])
            held.append(float(r["loads"][:, off:off + G].sum()))
            loads.append(r["loads"][:, off:off + G].cpu())
        moment = {p: m for p, (m, _) in state.items()}
        return {"ce": ce, "grad_norm": gn, "held": held,
                "loads": torch.stack(loads, -1),
                "after": self._take(params), "moment": self._take(moment),
                "moment_norms": _expert_norms(moment, self.plan)}

    def use_control(self, dtype, leaf_dtype) -> None:
        """The reference in `dtype`, its parameters kept in `leaf_dtype`,
        in the program's place."""
        self.out = self._replay(dtype, leaf_dtype)

    def check(self) -> dict:
        got = self.out
        want = self._replay(torch.float32, torch.float32)
        start = {p: ref.init_leaf(self.c, self.seed, p, self.dev)[at]
                 .reshape(-1)[idx] for p, (at, idx) in self.plan.items()}
        ce_err = gn_err = 0.0
        for i in range(2):
            ce_err = max(ce_err, abs(got["ce"][i] - want["ce"][i])
                         / abs(want["ce"][i]))
            gn_err = max(gn_err, abs(got["grad_norm"][i]
                                     - want["grad_norm"][i])
                         / want["grad_norm"][i])
            print(f"step {i + 1}: cross entropy {got['ce'][i]!r} "
                  f"(reference {want['ce'][i]!r}), gradient norm "
                  f"{got['grad_norm'][i]!r} (reference "
                  f"{want['grad_norm'][i]!r}), held selections "
                  f"{got['held'][i]:.0f} (reference {want['held'][i]:.0f})",
                  file=sys.stderr)
        own = self.mix["own_moment_limit"]
        upd_err, m_err = 0.0, {"moment_err": 0.0, **dict.fromkeys(
            own.values(), 0.0)}
        for p, p0 in start.items():
            e, cos, size = update_err(got["after"][p] - p0,
                                      want["after"][p] - p0)
            em, cos_m, size_m = update_err(got["moment"][p],
                                           want["moment"][p])
            upd_err = max(upd_err, e)
            name = own.get(p, "moment_err")
            if p in want["moment_norms"]:          # the whole leaf's size
                em = size_err(got["moment_norms"][p].norm(),
                              want["moment_norms"][p].norm())
            m_err[name] = max(m_err[name], em)
            print(f"{p}: update cosine {cos:.4f}, norm {size:.4f} of the "
                  f"reference's; first moment cosine {cos_m:.4f}, norm "
                  f"{size_m:.4f} ({name} {em:.4g})", file=sys.stderr)
        self._report_experts(got, want, start)
        for p in filter(ref.is_buffer, want["after"]):
            flips = int((got["after"][p] != want["after"][p]).sum())
            print(f"{p} entries that differ after two steps: {flips} of "
                  f"{want['after'][p].numel()}", file=sys.stderr)
        lim = self.mix["limits"]
        finite = all(np.isfinite(v) for v in (*got["ce"], *got["grad_norm"]))
        inf = float("inf")
        return {"ce_rel_err": (ce_err if finite else inf, lim["ce_rel_err"]),
                "grad_norm_rel_err": (gn_err if finite else inf,
                                      lim["grad_norm_rel_err"]),
                "param_update_err": (upd_err, lim["param_update_err"]),
                **{k: (v, lim[k]) for k, v in m_err.items()}}

    def _report_experts(self, got: dict, want: dict, start: dict) -> None:
        """For each sampled leaf of the held experts, each expert's own
        update and first-moment readings at the sampled layer, the loads
        the reference gave it in the two steps, and the held experts of
        every layer whose first moment is zero on one side only (no row in
        either step there, rows on the other side)."""
        shapes = ref.param_shapes(self.c)
        loads = want["loads"]
        for p, (at, idx) in self.plan.items():
            if len(shapes[p]) != 4:
                continue
            per = int(np.prod(shapes[p][2:]))
            expert = (idx // per).cpu()
            rows = []
            for e in range(shapes[p][1]):
                mine = (expert == e).nonzero()[:, 0].to(idx.device)
                ue = update_err(got["after"][p][mine] - start[p][mine],
                                want["after"][p][mine] - start[p][mine])[0]
                me = update_err(got["moment"][p][mine],
                                want["moment"][p][mine])[0]
                rows.append(f"{e}: loads {loads[at[0], e].tolist()}, "
                            f"update {ue:.4g}, moment {me:.4g}")
            print(f"{p} at layer {at[0]}, each held expert: "
                  + "; ".join(rows), file=sys.stderr)
            gz = got["moment_norms"][p] == 0
            wz = want["moment_norms"][p] == 0
            for layer, e in (gz != wz).nonzero().tolist():
                print(f"{p}: layer {layer} expert {e}: first moment zero "
                      f"in the {'program' if gz[layer, e] else 'reference'}"
                      f" only; the reference's loads "
                      f"{loads[layer, e].tolist()}", file=sys.stderr)

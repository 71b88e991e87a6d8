"""Read, shape by shape, the order in which the JAX package's compiled
split step adds its gain over (leaf, stat), and hold the port's
`repro_torch.core.split_sums.leaf_sum_plan` to it.

XLA's CPU backend emits that reduce as a loop that LLVM vectorizes, or
not, by its cost model, so the order depends on the leaves, the bins
and the stats.  For each shape this script jits the JAX package's gain
math (the body of `repro.training.gbdt._split_level`, returning the
masked gains), feeds it a histogram drawn from a numpy seed, and finds
which `LeafSumPlan` gives the same bits through `split_sums.leaf_stat_sum`
on the same per-(leaf, stat) terms.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/split_order_probe.py \\
        --leaves 16,32 --bins 2-256 --stats 1

prints one line a shape (the matching plans, `table` where the port's
plan is among them) and, at the end, the shapes whose port plan does
not match.  The results hold for the host it runs on: the table in
`split_sums` was read on an x86-64 host with AVX-512, where LLVM keeps
to 256-bit vectors unless 512 bits pay.
"""
from __future__ import annotations

import argparse
import itertools
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.core.boosting import NEG_INF, _gain_term
from repro_torch.core import split_sums


def _parts(h4, l2):
    C = h4.shape[-1] // 2
    incl = jnp.cumsum(h4, axis=2)
    total = incl[:, :, -1:, :]
    left = jnp.pad(incl[:, :, :-1, :], ((0, 0), (0, 0), (1, 0), (0, 0)))
    right = total - left
    terms = (_gain_term(left[..., :C], left[..., C:], l2)
             + _gain_term(right[..., :C], right[..., C:], l2))
    return terms, left[..., C:], right[..., C:]


@partial(jax.jit, static_argnames=("n_bins", "l2"))
def jax_gains(hist, valid, *, n_bins, l2):
    """`_split_level`'s gain, masked, and its argmax, as that function
    compiles them."""
    F, S, C2 = hist.shape
    terms, lh, rh = _parts(hist.reshape(F, S // n_bins, n_bins, C2), l2)
    gain = terms.sum(axis=(1, 3))
    nonempty = (lh.sum(axis=(1, 3)) > 0) & (rh.sum(axis=(1, 3)) > 0)
    gain = jnp.where(valid & nonempty, gain, NEG_INF)
    return gain, jnp.argmax(gain.reshape(-1))


@partial(jax.jit, static_argnames=("n_bins", "l2"))
def jax_terms(hist, *, n_bins, l2):
    F, S, C2 = hist.shape
    return _parts(hist.reshape(F, S // n_bins, n_bins, C2), l2)[0]


def candidates(n_leaves: int):
    windows = 0
    while n_leaves > split_sums.LEAF_WINDOW:
        n_leaves //= split_sums.LEAF_WINDOW
        windows += 1
    yield split_sums.LeafSumPlan(windows=windows)
    for lanes in (2, 4, 8, 16):
        for tail in sorted({0, lanes, 8, 16}):
            nv = n_leaves - tail
            if nv >= lanes and nv % lanes == 0:
                yield split_sums.LeafSumPlan(windows=windows, lanes=lanes,
                                             vector_leaves=nv)


def probe(n_leaves, n_bins, n_stats, n_feat=9, seed=0):
    rng = np.random.default_rng(seed)
    hist = rng.normal(size=(n_feat, n_leaves * n_bins, 2 * n_stats)
                      ).astype(np.float32)
    hist[..., n_stats:] = np.abs(hist[..., n_stats:])
    valid = np.ones((n_feat, n_bins), bool)
    gain, _ = jax_gains(jnp.asarray(hist), jnp.asarray(valid),
                        n_bins=n_bins, l2=3.0)
    gain = np.asarray(gain)
    terms = torch.from_numpy(np.array(jax_terms(
        jnp.asarray(hist), n_bins=n_bins, l2=3.0)))
    live = gain > NEG_INF / 2
    found = []
    for plan in candidates(n_leaves):
        got = split_sums.leaf_stat_sum(terms, plan).numpy()
        if np.array_equal(got[live].view(np.int32),
                          gain[live].view(np.int32)):
            found.append(plan)
    return found


def _ints(spec: str) -> list[int]:
    out: list[int] = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--leaves", default="1,2,4,8,16,32,64")
    ap.add_argument("--bins", default="2-256")
    ap.add_argument("--stats", default="1")
    args = ap.parse_args(argv)
    wrong = []
    for n_leaves, n_bins, n_stats in itertools.product(
            _ints(args.leaves), _ints(args.bins), _ints(args.stats)):
        found = probe(n_leaves, n_bins, n_stats)
        ours = split_sums.leaf_sum_plan(n_leaves, n_bins, n_stats)
        ok = ours in found
        wrong += [] if ok else [(n_leaves, n_bins, n_stats)]
        print(n_leaves, n_bins, n_stats,
              "table" if ok else "MISMATCH",
              [(p.windows, p.lanes, p.vector_leaves) for p in found],
              flush=True)
    print("mismatches:", len(wrong), wrong[:50])
    return 1 if wrong else 0


if __name__ == "__main__":
    raise SystemExit(main())

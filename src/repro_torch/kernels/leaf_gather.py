"""Leaf-value accumulation (paper: CalculateLeafValues[Multi]) on Hopper.

The kernel is `csrc/leaf_gather.cu`; it replaces the TPU kernel
`src/repro/kernels/leaf_gather.py:leaf_gather`.  Its plain version is
`ref.leaf_gather`.  It takes any number of outputs (slabs of at most 32,
`tuning.output_slabs`), and stages the leaf values in shared memory or
reads them from L2 as `tuning.gather_plan` picks.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.tuning import gather_plan
from repro_torch.obs.trace import get_tracer, plan_attrs

_TRACER = get_tracer()


def leaf_gather(idx: torch.Tensor, leaf_values: torch.Tensor, *,
                staged: bool | None = None) -> torch.Tensor:
    """pred[n, c] = sum_t leaf_values[t, idx[n, t], c] -> (N, C) float32,
    each sum in tree order.  Every idx must lie in [0, L): `leaf_index`
    guarantees it.  `staged` forces the kernel's route (None: the plan's
    choice); both give the same bits.

    A tensor on the CPU goes through the plain version; a CUDA tensor
    launches the kernel (and adds one to `leaf_gather.launches`)."""
    if idx.ndim != 2 or leaf_values.ndim != 3 \
            or idx.shape[1] != leaf_values.shape[0]:
        raise ValueError(f"leaf_gather takes idx (N, T) and leaf values "
                         f"(T, L, C), got {tuple(idx.shape)} and "
                         f"{tuple(leaf_values.shape)}")
    if idx.device.type == "cpu":
        return ref.leaf_gather(idx, leaf_values)
    _build.check_cuda_tensors("leaf_gather", idx=(idx, torch.int32),
                              leaf_values=(leaf_values, torch.float32))
    n, t = idx.shape
    _, n_leaves, c = leaf_values.shape
    out = torch.empty((n, c), dtype=torch.float32, device=idx.device)
    if n and c:
        plan = gather_plan(n, t, n_leaves, c, staged)
        if _TRACER.enabled:
            _TRACER.annotate(**plan_attrs(plan))
        _build.launch("repro_leaf_gather", idx.device, idx, leaf_values, out,
                      n, t, n_leaves, c, plan.slab, plan.lanes,
                      int(plan.staged), plan.threads, plan.rows_per_thread,
                      plan.trees_per_chunk, plan.n_row_blocks)
        leaf_gather.launches += 1
    return out


leaf_gather.launches = 0

"""Leaf-value accumulation (paper: CalculateLeafValues[Multi]) on Hopper.

The kernel is `csrc/leaf_gather.cu`; it replaces the TPU kernel
`src/repro/kernels/leaf_gather.py:leaf_gather`.  Its plain version is
`ref.leaf_gather`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# Outputs a row's registers hold (csrc/leaf_gather.cu and
# csrc/fused_predict.cu instantiate 8 and 32 accumulators).
MAX_OUTPUTS = 32


def leaf_gather(idx: torch.Tensor, leaf_values: torch.Tensor) -> torch.Tensor:
    """pred[n, c] = sum_t leaf_values[t, idx[n, t], c] -> (N, C) float32.
    Every idx must lie in [0, L): `leaf_index` guarantees it.

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
    if c > MAX_OUTPUTS:
        raise ValueError(f"leaf_gather takes <= {MAX_OUTPUTS} outputs, "
                         f"got {c}")
    out = torch.empty((n, c), dtype=torch.float32, device=idx.device)
    if n and c:
        _build.launch("repro_leaf_gather", idx.device, idx, leaf_values, out,
                      n, t, n_leaves, c)
        leaf_gather.launches += 1
    return out


leaf_gather.launches = 0

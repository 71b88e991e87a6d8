"""Feature binarization (paper: BinarizeFloatsNonSse) on Hopper.

The kernel is `csrc/binarize.cu`; it replaces the TPU kernel
`src/repro/kernels/binarize.py:binarize`.  Its plain version is
`ref.binarize` (`ref.binarize_u8` for uint8 bins).  The kernel counts a
sorted border column with a binary search for the borders `< x` and any
other column with the compare-sum; both give the plain version's bins.
It takes any number of borders: a table too large for a block's shared
memory is read from global memory and counted with the compare-sum.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def binarize(x: torch.Tensor, borders: torch.Tensor, *,
             out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """bins[n, f] = #{b : x[n, f] > borders[b, f]} -> (N, F) `out_dtype`
    (int32, or uint8 when B <= 255).

    A tensor on the CPU goes through the plain version; a CUDA tensor
    launches the kernel (and adds one to `binarize.launches`)."""
    if x.ndim != 2 or borders.ndim != 2 or x.shape[1] != borders.shape[1]:
        raise ValueError(f"binarize takes x (N, F) and borders (B, F), got "
                         f"{tuple(x.shape)} and {tuple(borders.shape)}")
    if out_dtype not in (torch.int32, torch.uint8):
        raise ValueError(f"bins are int32 or uint8, not {out_dtype}")
    u8 = out_dtype == torch.uint8
    if u8 and borders.shape[0] > ref.MAX_U8_BORDERS:
        raise ValueError(f"uint8 bins need <= {ref.MAX_U8_BORDERS} "
                         f"borders, got {borders.shape[0]}")
    if x.device.type == "cpu":
        return ref.binarize_u8(x, borders) if u8 else ref.binarize(x, borders)
    _build.check_cuda_tensors("binarize", x=(x, torch.float32),
                              borders=(borders, torch.float32))
    n, f = x.shape
    out = torch.empty((n, f), dtype=out_dtype, device=x.device)
    if n and f:
        _build.launch("repro_binarize", x.device, x, borders, out, n, f,
                      borders.shape[0], int(u8))
        binarize.launches += 1
    return out


binarize.launches = 0

"""Squared L2 distances (paper: L2SqrDistance) on Hopper.

Two kernels, one for each form the kNN featurizer uses:

  l2sq_rowwise  `csrc/l2sq_rowwise.cu`: one query against many reference
                rows (the paper-faithful form), q in registers, a row a
                warp with all its loads in flight, any K; the launch
                plan is `tuning.rowwise_plan` (routes `registers`,
                `walk`, `scalar`).  Replaces
                `src/repro/kernels/l2dist.py:l2sq_rowwise`.  Plain
                version `ref.l2sq_rowwise`; `ref.l2sq_rowwise_lanes` is
                the kernel's own summation order, bit for bit.  A run of
                queries against one reference set checks it once
                (`rowwise_batch`) and writes each query's row of a
                preallocated output (`out=`).
  l2sq_matrix   `csrc/l2sq_matrix.cu`: the (M, N) matrix
                max(||a||^2 + ||b||^2 - 2 a.b^T, 0) with the cross term
                on the tensor cores as 3xTF32 (`wgmma` fed by TMA: a_hi.b_hi
                + a_hi.b_lo + a_lo.b_hi into one fp32 accumulator); a split
                pass first writes each operand's TF32 hi and lo parts, K
                padded to a multiple of 32, and its row norms.  Replaces
                `src/repro/kernels/l2dist.py:l2sq_matrix`.  Plain version
                `ref.l2sq_matrix` (full fp32); `ref.l2sq_matrix_tf32`
                emulates the kernel's arithmetic.  Its launch plan is
                `tuning.matrix_plan`.

Both sum each output in a fixed order, so two launches give the same
bits.  `rowwise_limit` and `matrix_limit` are the distance rule of
PERF.md §2: how far two float32 evaluations of the same distances, summed
in different orders, may lie apart.  One TF32 product breaks the matrix
rule about 5x; three stay within a tenth of it (tests/test_torch_l2sq.py).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from repro_torch.kernels import _build, ref, tuning
from repro_torch.obs.trace import get_tracer, plan_attrs

U = 2.0 ** -24            # unit roundoff of float32
K_SIGMA = 8.0             # width of the limit, in rounding walks
_TRACER = get_tracer()


def rowwise_limit(q: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """(N,) float64 limit of the rowwise form: 8 sqrt(K) u sum_k (r_k -
    q_k)^2.  K non-negative terms summed in any order walk about sqrt(K)
    roundings of u times their sum apart."""
    d = refs.double() - q.double()[None, :]
    return K_SIGMA * math.sqrt(refs.shape[1]) * U * (d * d).sum(dim=1)


def matrix_limit(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, N) float64 limit of the matrix form: 8 sqrt(K) u (||a||^2 +
    ||b||^2 + 2 sum_k |a_k b_k|).  The result cancels down from those
    magnitudes (a self-distance lands near 0, not at it), so the limit
    scales with them and not with the distance."""
    a64, b64 = a.double(), b.double()
    mag = (a64 * a64).sum(dim=1)[:, None] + (b64 * b64).sum(dim=1)[None, :] \
        + 2.0 * (a64.abs() @ b64.abs().T)
    return K_SIGMA * math.sqrt(a.shape[1]) * U * mag


def _vec_ok(k: int, *tensors: torch.Tensor) -> bool:
    """float4 loads: K a multiple of 4 and every row 16-byte aligned."""
    return k % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


@functools.lru_cache(maxsize=1024)
def _rowwise_launch(n: int, k: int, aligned: bool
                    ) -> tuple[tuning.RowwisePlan, tuple]:
    """The plan for refs (n, k) and the launcher's arguments after its
    three pointers, (n, k, *plan.launch_args), converted to their ctypes
    types once a shape: ctypes would convert each int at every launch."""
    plan = tuning.rowwise_plan(n, k, aligned)
    return plan, _build.fixed_args("repro_l2sq_rowwise", 3, n, k,
                                   *plan.launch_args)


def _check_out(out: torch.Tensor, n: int, device: torch.device) -> None:
    if out.device != device or out.dtype != torch.float32 or \
            tuple(out.shape) != (n,) or not out.is_contiguous():
        raise ValueError(f"l2sq_rowwise: out must be a contiguous ({n},) "
                         f"float32 tensor on {device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")


@dataclasses.dataclass(frozen=True, eq=False)
class RowwiseBatch:
    """A run of rowwise launches against one reference set, checked once
    by `rowwise_batch`: the refs, their launch plan, and on the card
    `launch(q_ptr, out_ptr)`, the launcher bound to the device, its
    current stream, the refs and the plan (None on the CPU)."""
    refs: torch.Tensor
    plan: tuning.RowwisePlan
    launch: Callable[[int, int], None] | None


def rowwise_batch(queries: torch.Tensor, refs: torch.Tensor
                  ) -> RowwiseBatch:
    """Check queries (Q, K) and refs (N, K) once for a run of
    `l2sq_rowwise(queries[i], refs, out=..., batch=...)` calls: what a lone
    call checks every time (devices, dtypes, contiguity, alignment) is
    checked here, the plan made and the stream looked up."""
    if queries.ndim != 2 or refs.ndim != 2 or \
            queries.shape[1] != refs.shape[1]:
        raise ValueError(f"rowwise_batch takes queries (Q, K) and refs (N, "
                         f"K), got {tuple(queries.shape)} and "
                         f"{tuple(refs.shape)}")
    n, k = refs.shape
    if queries.device.type == "cpu":
        return RowwiseBatch(refs, tuning.rowwise_plan(n, k), None)
    _build.check_cuda_tensors("l2sq_rowwise", queries=(queries,
                                                       torch.float32),
                              refs=(refs, torch.float32))
    plan, tail = _rowwise_launch(n, k, _vec_ok(k, queries, refs))
    bound = _build.bind("repro_l2sq_rowwise", refs.device)
    refs_ptr = refs.data_ptr()

    def launch(q_ptr: int, out_ptr: int) -> None:
        bound(q_ptr, refs_ptr, out_ptr, *tail)
    return RowwiseBatch(refs, plan, launch)


def l2sq_rowwise(q: torch.Tensor, refs: torch.Tensor, *,
                 out: torch.Tensor | None = None,
                 batch: RowwiseBatch | None = None) -> torch.Tensor:
    """out[n] = sum_k (refs[n, k] - q[k])^2 -> (N,) float32, written into
    `out` when given (a contiguous (N,) float32 tensor on q's device).

    A tensor on the CPU goes through the plain version; a CUDA tensor
    launches the kernel as `tuning.rowwise_plan` plans it (and adds one to
    `l2sq_rowwise.launches`).  With `batch` (from `rowwise_batch`, on these
    refs), q must be a row of the queries it checked and `out` a row of a
    float32 buffer on their device: the per-call checks shrink to shapes,
    dtypes, devices, contiguity and q's alignment."""
    if batch is not None:
        return _rowwise_in_batch(q, refs, out, batch)
    if q.ndim != 1 or refs.ndim != 2 or refs.shape[1] != q.shape[0]:
        raise ValueError(f"l2sq_rowwise takes q (K,) and refs (N, K), got "
                         f"{tuple(q.shape)} and {tuple(refs.shape)}")
    n, k = refs.shape
    if out is not None:
        _check_out(out, n, q.device)
    if q.device.type == "cpu":
        if out is None:
            return ref.l2sq_rowwise(q, refs)
        return out.copy_(ref.l2sq_rowwise(q, refs))
    _build.check_cuda_tensors("l2sq_rowwise", q=(q, torch.float32),
                              refs=(refs, torch.float32))
    if out is None:
        out = torch.empty((n,), dtype=torch.float32, device=q.device)
    if n and not k:
        return out.zero_()
    if n:
        _build.launch("repro_l2sq_rowwise", q.device, q, refs, out,
                      *_rowwise_launch(n, k, _vec_ok(k, q, refs))[1])
        l2sq_rowwise.launches += 1
    return out


l2sq_rowwise.launches = 0


def _rowwise_in_batch(q, refs, out, batch):
    n, k = refs.shape
    if refs is not batch.refs or out is None or q.shape != (k,) or \
            out.shape != (n,) or q.dtype != torch.float32 or \
            out.dtype != torch.float32 or not q.is_contiguous() or \
            not out.is_contiguous():
        raise ValueError("l2sq_rowwise with a batch takes its refs, q a row "
                         "of its queries and out a contiguous (N,) float32 "
                         "row")
    if q.device != refs.device or out.device != refs.device:
        raise ValueError(f"l2sq_rowwise: the batch was checked on "
                         f"{refs.device}; q and out must be there too")
    if batch.launch is None:
        return out.copy_(ref.l2sq_rowwise(q, refs))
    if n and not k:
        return out.zero_()
    if n:
        q_ptr = q.data_ptr()
        if q_ptr % 16 and batch.plan.route != "scalar":
            raise ValueError("l2sq_rowwise: q is not a row of the batch's "
                             "queries (not 16-byte aligned)")
        batch.launch(q_ptr, out.data_ptr())
        l2sq_rowwise.launches += 1
    return out


def split_pass(a: torch.Tensor, b: torch.Tensor, k_pad: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The matrix kernel's first pass: (a_split, b_split, a_sq, b_sq), each
    split (2, rows, k_pad) float32 holding the TF32 hi part of the rows,
    then the lo part, K padded with zeros; a_sq and b_sq the row norms.

    A tensor on the CPU goes through the plain version; on CUDA tensors it
    launches `csrc/l2sq_matrix.cu`'s split kernel (counted by the caller,
    `l2sq_matrix`, not here)."""
    m, k = a.shape
    if a.device.type == "cpu":
        def parts(x):
            hi, lo = ref.tf32_split(
                torch.nn.functional.pad(x, (0, k_pad - k)))
            return torch.stack([hi, lo]), (x * x).sum(dim=1)
        (sa, a_sq), (sb, b_sq) = parts(a), parts(b)
        return sa, sb, a_sq, b_sq
    n = b.shape[0]
    sa = torch.empty((2, m, k_pad), dtype=torch.float32, device=a.device)
    sb = torch.empty((2, n, k_pad), dtype=torch.float32, device=a.device)
    a_sq = torch.empty((m,), dtype=torch.float32, device=a.device)
    b_sq = torch.empty((n,), dtype=torch.float32, device=a.device)
    _build.launch("repro_l2sq_split", a.device, a, b, sa, sb, a_sq, b_sq,
                  m, n, k, k_pad)
    return sa, sb, a_sq, b_sq


def l2sq_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[m, n] = max(||a[m]||^2 + ||b[n]||^2 - 2 a[m].b[n], 0) -> (M, N)
    float32, the cross term as 3xTF32 on the tensor cores, launched as
    `tuning.matrix_plan` plans it.

    A tensor on the CPU goes through the plain version; a CUDA tensor
    launches the split pass and the product kernel (and adds one to
    `l2sq_matrix.launches`)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"l2sq_matrix takes a (M, K) and b (N, K), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type == "cpu":
        return ref.l2sq_matrix(a, b)
    _build.check_cuda_tensors("l2sq_matrix", a=(a, torch.float32),
                              b=(b, torch.float32))
    m, k = a.shape
    n = b.shape[0]
    plan = tuning.matrix_plan(m, n, k)
    if _TRACER.enabled:
        _TRACER.annotate(**plan_attrs(plan))
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m and n:
        sa, sb, a_sq, b_sq = split_pass(a, b, plan.k_pad)
        _build.launch("repro_l2sq_matrix", a.device, sa, sb, a_sq, b_sq, out,
                      m, n, plan.k_pad, plan.stages, plan.smem_bytes)
        l2sq_matrix.launches += 1
    return out


l2sq_matrix.launches = 0

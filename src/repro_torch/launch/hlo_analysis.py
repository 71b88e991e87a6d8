"""The hardware model and the cost accounting of a dry run: the port's
counterpart of `src/repro/launch/hlo_analysis.py`.

The name is kept so that the counterpart is easy to find; nothing here
reads HLO.  A dry run (`launch/dryrun.py`, `launch/dryrun_gbdt.py`) runs a
step under `FakeTensorMode` on a fake process group
(`distributed.runtime.fake_group`) and reads the trace:

  * `OpCounter`, a dispatch mode, counts what one device does, at its
    local shard shapes.  A DTensor op is not counted as such: the mode
    hands it back to DTensor (`NotImplemented`, as `CommDebugMode` does)
    and counts the local ops and collectives it turns into, so no op is
    counted at both levels.  The port's shard-by-shard ops run on plain
    local tensors and are counted as they are.
      - FLOPs: matmul-family ops by `torch.utils.flop_counter`'s formulas
        (`mm`, `bmm`, `addmm`, `baddbmm`, convolutions, attention); the
        rest count none, as in XLA's cost analysis of a GEMM-dominated
        step;
      - bytes: every aten op's input plus output bytes, views and the
        wait on a collective excepted.  No fusion is modelled: the same
        unfused bias as XLA-CPU's "bytes accessed", so the memory term is
        a pessimistic upper bound;
      - collectives (`collective_bytes`): the result bytes of each
        collective the device issues, per kind, under JAX's HLO kind
        names, and their `total`: DTensor's `_c10d_functional` ops, the
        c10d ops `distributed/collectives.py` issues (`dist.all_reduce`),
        and the ring's `batch_isend_irecv` steps, which no dispatch mode
        sees (`collectives.recording_ring_steps`) and which are counted
        as collective-permutes.
  * `launch_cost` gives each hand-kernel launch recorded under the fake
    mode (`kernels._build.recording_launches`: nothing runs) its bytes
    and operations from its shapes, by the formulas of `chip_smoke.py`'s
    `bound` (PERF.md §6, Bound column): the least work of the function,
    so a value's bin costs a binary search's compares (`compares`).

Import-side-effect-free, as the JAX module is.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 SXM5 (per card), at its 700 W power limit
PEAK_FLOPS = 989e12        # dense bf16 on the tensor cores
HBM_BW = 3.35e12           # bytes/s, HBM3
LINK_BW = 450e9            # bytes/s, NVLink 4, one direction
FP32_FLOPS = 67e12         # fp32 off the tensor cores (the GBDT kernels)
TF32_FLOPS = 495e12        # dense TF32 on the tensor cores (l2sq_matrix)

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# aten-level collective op (packet name) -> JAX's HLO kind
_COLLECTIVES = {
    # DTensor's functional collectives
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    # the eager c10d ops `torch.distributed` dispatches
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}

# Ops that move no bytes: views and metadata, and the wait on a collective
_FREE = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "permute",
    "transpose", "t", "expand", "select", "slice", "narrow", "squeeze",
    "unsqueeze", "alias", "detach", "as_strided", "lift_fresh",
    "unbind", "split", "split_with_sizes", "chunk", "view_as_real",
    "view_as_complex", "wait_tensor", "_local_scalar_dense", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided",
})


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x: Any) -> list[torch.Tensor]:
    leaves, _ = tree_flatten(x)
    return [t for t in leaves if isinstance(t, torch.Tensor)]


def empty_collectives() -> dict:
    return {k: 0 for k in COLLECTIVE_KINDS}


def collective_bytes(per_kind: dict) -> dict:
    """The per-kind result bytes with their `total`, in JAX's form (kinds
    that carried nothing are left out, as JAX's HLO parse leaves them)."""
    out = {k: int(v) for k, v in per_kind.items() if v}
    out["total"] = sum(out.values())
    return out


class OpCounter(TorchDispatchMode):
    """Counts one device's FLOPs, bytes and collective bytes (module
    docstring).  `ops` is the number of local aten ops counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.coll = empty_collectives()
        self.coll_calls = {k: 0 for k in COLLECTIVE_KINDS}
        self.by_op: dict[str, list] = {}     # name -> [calls, flops, bytes]
        # (name, operand shapes) -> FLOPs, for the ops with a FLOP formula
        self.products: dict[tuple, int] = {}

    def add_collective(self, kind: str, result_bytes: int) -> None:
        self.coll[kind] += int(result_bytes)
        self.coll_calls[kind] += 1

    def ring_step(self, received: torch.Tensor) -> None:
        """A ring step (`collectives.recording_ring_steps`): one
        collective-permute of the tensor received, which is also read
        and written once."""
        self.add_collective("collective-permute", nbytes(received))
        self.bytes += 2 * nbytes(received)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # count the local ops it becomes
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == "prim" or name in _FREE:
            return out
        self.ops += 1
        outs = _tensors(out)
        if name in _COLLECTIVES:
            self.add_collective(_COLLECTIVES[name], sum(nbytes(t)
                                                        for t in outs)
                                or sum(nbytes(t) for t in _tensors(args)))
        formula = self._flop_registry.get(func.overloadpacket)
        flops = int(formula(*args, **kwargs, out_val=out)) if formula \
            else 0
        moved = sum(nbytes(t) for t in _tensors((args, kwargs))) + \
            sum(nbytes(t) for t in outs)
        self.flops += flops
        self.bytes += moved
        if flops:
            key = (name, tuple(tuple(t.shape) for t in _tensors(args)))
            self.products[key] = self.products.get(key, 0) + flops
        row = self.by_op.setdefault(name, [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += moved
        return out

    def top_ops(self, n: int = 8, key: int = 2) -> list:
        """The `n` op names with the most bytes (key 2) or FLOPs (key 1):
        [name, calls, flops, bytes]."""
        rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][key])
        return [[name, *row] for name, row in rows[:n]]

    def costs(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "coll": collective_bytes(self.coll), "ops": self.ops,
                "top_bytes": self.top_ops(8, 2),
                "top_flops": self.top_ops(4, 1)}


@contextlib.contextmanager
def counting() -> Iterator[OpCounter]:
    """An `OpCounter` over the block, the ring steps included.  Enter it
    inside the fake tensor mode."""
    from repro_torch.distributed import collectives

    counter = OpCounter()
    with collectives.recording_ring_steps(counter.ring_step), counter:
        yield counter


# --------------------------------------------------------------------------
# The hand kernels' launches
# --------------------------------------------------------------------------
def _shape(rec, i: int) -> tuple:
    return tuple(rec.args[i].shape)


def _elem(rec, i: int) -> int:
    return torch.empty((), dtype=rec.args[i].dtype).element_size()


def _size(rec, i: int) -> int:
    return math.prod(_shape(rec, i)) * _elem(rec, i)


def compares(n_borders: int) -> int:
    """Compares that find a value's bin among `n_borders` sorted borders:
    a binary search, ceil(log2(n_borders + 1)) (what `searchsorted`
    does), the least the function needs whatever the kernel's scan."""
    return int(n_borders).bit_length()


def _binarize(rec) -> tuple[int, int]:
    # x (N, F) f32, borders (B, F) f32 -> bins (N, F) uint8 / int32
    n, f = _shape(rec, 0)
    n_b = _shape(rec, 1)[0]
    return (_size(rec, 0) + _size(rec, 1) + _size(rec, 2),
            n * f * compares(n_b))


# where a leaf_index launcher's output sits (the split planes before it,
# the depth four places after it)
_INDEX_OUT = {"repro_leaf_index": 3, "repro_leaf_index_dm": 4,
              "repro_leaf_index_bp": 3}


def _leaf_index(rec) -> tuple[int, int]:
    # bins (N, F), the split planes -> idx (N, T) int32
    out = _INDEX_OUT[rec.name]
    n, t = _shape(rec, out)
    depth = int(rec.args[out + 4])
    planes = sum(_size(rec, i) for i in range(1, out))
    return _size(rec, 0) + planes + _size(rec, out), n * t * depth


def _leaf_gather(rec) -> tuple[int, int]:
    # idx (N, T) int32, leaf values (T, L, C) f32 -> (N, C) f32: the
    # whole leaf table, an upper bound (the rows a batch touches depend
    # on the data)
    n, t = _shape(rec, 0)
    c = _shape(rec, 1)[2]
    return _size(rec, 0) + _size(rec, 1) + _size(rec, 2), n * t * c


def _fused(rec) -> tuple[int, int]:
    # x, borders, the split planes, leaf values, out (N, C), ... : the
    # whole leaf table (as leaf_gather)
    tensors = [i for i, a in enumerate(rec.args) if hasattr(a, "shape")]
    lv = next(i for i in tensors if len(rec.args[i].shape) == 3)
    out = tensors[tensors.index(lv) + 1]
    n, f = _shape(rec, 0)
    n_b = _shape(rec, 1)[0]
    c = _shape(rec, lv)[2]
    # n, f, n_borders, t, d follow the output (and the row route's
    # scratch buffer)
    t, d = [a for a in rec.args[out + 1:] if isinstance(a, int)][3:5]
    planes = sum(_size(rec, i) for i in tensors[2:tensors.index(lv)])
    moved = (_size(rec, 0) + _size(rec, 1) + planes + _size(rec, lv)
             + _size(rec, out))
    return moved, n * f * compares(n_b) + n * t * d + n * t * c


def _histogram(rec) -> tuple[int, int]:
    # bins_t (F, N), leaf (N,), g (N, S) -> out (F, leaves x bins, S)
    f, n = _shape(rec, 0)
    s = _shape(rec, 2)[1]
    return (_size(rec, 0) + _size(rec, 1) + _size(rec, 2) + _size(rec, 5),
            f * n * s)


def _l2sq_rowwise(rec) -> tuple[int, int]:
    # q (K,), refs (N, K) -> (N,)
    n, k = _shape(rec, 1)
    return _size(rec, 0) + _size(rec, 1) + _size(rec, 2), 3 * n * k


def _l2sq_split(rec) -> tuple[int, int]:
    # a (M, K), b (N, K) -> the tf32 splits and the norms
    moved = sum(_size(rec, i) for i, a in enumerate(rec.args)
                if hasattr(a, "shape"))
    m, k = _shape(rec, 0)
    n = _shape(rec, 1)[0]
    return moved, 2 * (m + n) * k


def _l2sq_matrix(rec) -> tuple[int, int]:
    # the splits, the norms -> (M, N)
    tensors = [i for i, a in enumerate(rec.args) if hasattr(a, "shape")]
    out = tensors[-1]
    m, n = _shape(rec, out)
    k = _shape(rec, tensors[0])[-1]
    return (4 * (m + n) * k + 4 * (m + n) + _size(rec, out),
            2 * m * n * k)


LAUNCH_COSTS = {
    "repro_binarize": _binarize,
    "repro_leaf_index": _leaf_index,
    "repro_leaf_index_dm": _leaf_index,
    "repro_leaf_index_bp": _leaf_index,
    "repro_leaf_gather": _leaf_gather,
    "repro_fused_predict": _fused,
    "repro_fused_predict_spread": _fused,
    "repro_fused_predict_dm": _fused,
    "repro_fused_predict_dm_spread": _fused,
    "repro_fused_predict_bp": _fused,
    "repro_fused_predict_bp_spread": _fused,
    "repro_histogram": _histogram,
    "repro_l2sq_rowwise": _l2sq_rowwise,
    "repro_l2sq_split": _l2sq_split,
    "repro_l2sq_matrix": _l2sq_matrix,
}


def launch_cost(rec) -> dict:
    """Bytes, operations and the bound in ms of one recorded launch: the
    larger of its bytes over `HBM_BW` and its operations over the card's
    rate for them (TF32 on the tensor cores for the distance product,
    fp32 off them for the rest)."""
    moved, ops = LAUNCH_COSTS[rec.name](rec)
    rate = TF32_FLOPS if rec.name == "repro_l2sq_matrix" else FP32_FLOPS
    t_bytes = moved / HBM_BW * 1e3
    t_ops = ops / rate * 1e3
    return {"name": rec.name, "bytes": int(moved), "ops": int(ops),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def launch_shapes(rec) -> tuple:
    """A launch as (launcher, the shapes and dtypes of its tensors): what
    a real run's launches are held to."""
    return (rec.name, tuple((str(a.dtype).removeprefix("torch."),
                             tuple(a.shape)) for a in rec.args
                            if hasattr(a, "shape")))

"""Distributed-optimization building blocks: the port's counterpart of
`src/repro/distributed/collectives.py`, one process a shard.

* compressed_psum_grads — int8/bf16 quantized gradient all-reduce with
  error feedback (residual carried across steps).
* ring_allgather_matmul — a ring that passes the weight shards round
  while each shard multiplies its resident one (compute/comm overlap
  instead of a blocking all-gather).
* ring_attention — causal GQA attention with q, k and v sharded on the
  sequence: the KV blocks go round the ring while each shard accumulates
  its query block with an online softmax.
* flash_decode — sequence-sharded decode attention: each shard attends
  over its slice of the KV cache and the partial softmaxes combine
  exactly with log-sum-exp weights (one MAX, two SUM all-reduces).

JAX runs each body inside `shard_map` with `ppermute` / `psum` / `pmax`.
Here each rank runs the body on its own shards (`to_local`) and exchanges
over the axis's subgroup of the process group (`distributed.runtime`):
`dist.batch_isend_irecv` for a ring step (a `torch.autograd.Function`, so
a gradient goes round the other way, as `ppermute`'s transpose does),
`dist.all_reduce` for the sums and maxima.  The arithmetic of each body
is a plain function of local tensors (`ring_attention_update`,
`flash_decode_partial` / `flash_decode_combine`, `ring_matmul_update`),
and `emulate_*` runs the bodies of n shards in one process, feeding each
shard the blocks in the order its ring delivers them: the distributed
version gives the emulation's values (bit for bit where nothing is
summed across shards).

The factories take the port's `Mesh` (or a `DeviceMesh`).  Their callables
take DTensors, placed anew by the shard_map's in-specs and returned as
DTensors on its out-specs, or plain tensors holding the whole value on
every rank, returned whole.  A one-shard mesh runs without a process
group; several shards need a group of as many ranks
(`runtime.device_mesh` raises otherwise).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.distributed import runtime
from repro_torch.distributed import sharding as shd
from repro_torch.models.layers import NEG_INF, from_local

_P2P = threading.local()


@contextlib.contextmanager
def recording_ring_steps(sink: Callable[[torch.Tensor], None]
                         ) -> Iterator[None]:
    """Pass the tensor each ring step of this thread receives to `sink`
    (what a dry run counts as a collective-permute: a point-to-point
    batch is not an op a dispatch mode sees)."""
    prev = getattr(_P2P, "sink", None)
    _P2P.sink = sink
    try:
        yield
    finally:
        _P2P.sink = prev


# --------------------------------------------------------------------------
# The ring of one mesh axis
# --------------------------------------------------------------------------
class _Axis:
    """This rank's place on one axis of a mesh: the axis size `n`, its
    index `idx`, the subgroup and the global ranks of the next (idx + 1)
    and previous (idx - 1) shards.  A one-shard mesh outside a process
    group is its own axis of one (no group, no `DeviceMesh`)."""

    def __init__(self, mesh, axis: str):
        self.dm = None if _alone(mesh) else _device_mesh(mesh)
        if self.dm is None:
            self.n, self.idx, self.group = 1, 0, None
            return
        dim = self.dm.mesh_dim_names.index(axis)
        self.n = self.dm.size(dim)
        self.idx = self.dm.get_local_rank(axis)
        self.group = self.dm.get_group(axis) if self.n > 1 else None
        coord = list(self.dm.get_coordinate())

        def rank_at(i: int) -> int:
            at = list(coord)
            at[dim] = i % self.n
            # the mesh's rank table is a host tensor: read it outside any
            # fake tensor mode (a dry run)
            with _disable_current_modes():
                return int(self.dm.mesh[tuple(at)])
        self.next, self.prev = rank_at(self.idx + 1), rank_at(self.idx - 1)

    def send_recv(self, x: torch.Tensor, to: int, frm: int) -> torch.Tensor:
        """`x` sent to rank `to` while a tensor like it is received from
        rank `frm`, in one batch (a ring of blocking pairs deadlocks)."""
        x = x.contiguous()
        out = torch.empty_like(x)
        sink = getattr(_P2P, "sink", None)
        if sink is not None:
            sink(out)
        ops = [dist.P2POp(dist.isend, x, to, self.group),
               dist.P2POp(dist.irecv, out, frm, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """One ring step, `ppermute` with (i, i + 1): this shard's `x`
        goes to the next shard and the previous one's arrives."""
        return _RingShift.apply(x, self)

    def all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        """`x` reduced over the axis (a new tensor; `x` is left alone)."""
        x = x.clone(memory_format=torch.contiguous_format)
        if self.n > 1:
            dist.all_reduce(x, op=op, group=self.group)
        return x


class _RingShift(torch.autograd.Function):
    """The ring step as an autograd op: forward to idx + 1, the gradient
    back to idx - 1 (the transpose of `ppermute`)."""

    @staticmethod
    def forward(ctx, x, ax: _Axis):
        ctx.ax = ax
        return ax.send_recv(x, ax.next, ax.prev)

    @staticmethod
    def backward(ctx, grad):
        ax = ctx.ax
        return ax.send_recv(grad, ax.prev, ax.next), None


def _alone(mesh) -> bool:
    size = mesh.size() if isinstance(mesh, DeviceMesh) else mesh.size
    return size == 1 and not runtime.is_distributed()


def _device_mesh(mesh) -> DeviceMesh:
    return mesh if isinstance(mesh, DeviceMesh) else \
        runtime.device_mesh(mesh)


def _local(x: torch.Tensor, dm: DeviceMesh, spec) -> torch.Tensor:
    """This rank's shard of `x` under `spec`: a DTensor redistributed, a
    plain tensor (the whole value, alike on every rank) sliced through a
    replicated DTensor, so its gradient is gathered whole again."""
    placements = shd.placements(spec, dm)
    if not isinstance(x, DTensor):
        x = from_local(x, dm, [Replicate()] * dm.ndim, x.shape)
    return x.redistribute(dm, placements).to_local().contiguous()


def _global(local: torch.Tensor, dm: DeviceMesh, spec, shape,
            whole: bool) -> torch.Tensor:
    """The DTensor of this rank's `local` shard under `spec`, or, with
    `whole`, its whole value on every rank as a plain tensor."""
    out = from_local(local.contiguous(), dm, shd.placements(spec, dm), shape)
    return out.full_tensor() if whole else out


def _sharded(mesh, axis: str, fn: Callable, specs: tuple, out_spec,
             out_shape: Callable) -> Callable:
    """`fn(ax, *locals)` as a shard_map over `mesh`: the arguments placed
    by `specs` (None: a 0-d value taken as it is), the result returned on
    `out_spec`; inputs that are not DTensors come back whole."""
    def run(*args):
        ax = _Axis(mesh, axis)
        if ax.dm is None:
            return fn(ax, *args)
        whole = not any(isinstance(a, DTensor) for a in args)
        local = [a.to_local() if spec is None and isinstance(a, DTensor)
                 else a if spec is None else _local(a, ax.dm, spec)
                 for a, spec in zip(args, specs)]
        return _global(fn(ax, *local), ax.dm, out_spec, out_shape(*args),
                       whole)
    return run


def _blocks(x: torch.Tensor, n: int, dim: int) -> list[torch.Tensor]:
    """x's n shards along `dim`, each contiguous as a rank holds it."""
    return [b.contiguous() for b in torch.chunk(x, n, dim=dim)]


# --------------------------------------------------------------------------
# Gradient compression with error feedback
# --------------------------------------------------------------------------
def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_grads(grads, residuals, group=None, mode: str = "int8",
                          *, mesh=None, axis: str = "data"):
    """The mean of this rank's `grads` over `group` (or over `axis` of
    `mesh`) with compression and error feedback: (mean grads, residuals),
    each a tree like `grads`, as JAX's does inside `shard_map`.

    int8: the shards agree on one scale (a MAX all-reduce of max |g|),
    round half to even, and sum the int8 values widened to int32.  bf16:
    the f32 sum of the bf16-rounded values.  Without a group (and on a
    one-shard mesh outside a process group) the axis has one shard."""
    if group is None and mesh is not None and not _alone(mesh):
        group = _device_mesh(mesh).get_group(axis)
    n = dist.get_world_size(group) if group is not None else 1

    def reduce(x: torch.Tensor, op) -> torch.Tensor:
        x = x.clone(memory_format=torch.contiguous_format)
        if group is not None:
            dist.all_reduce(x, op=op, group=group)
        return x

    def one(g, r):
        g = g.to(torch.float32) + r
        if mode == "bf16":
            sent = g.to(torch.bfloat16)
            recon = sent.to(torch.float32)
            reduced = reduce(sent.to(torch.float32), dist.ReduceOp.SUM)
        else:
            scale = reduce(torch.max(torch.abs(g)), dist.ReduceOp.MAX) \
                / 127.0 + 1e-12
            q = torch.clamp(torch.round(g / scale), -127, 127) \
                .to(torch.int8)
            recon = q.to(torch.float32) * scale
            reduced = reduce(q.to(torch.int32), dist.ReduceOp.SUM) \
                .to(torch.float32) * scale
        return reduced / n, g - recon

    def walk(g, r, i):
        if isinstance(g, dict):
            return {k: walk(g[k], r[k], i) for k in g}
        return one(g, r)[i]

    with torch.no_grad():
        return walk(grads, residuals, 0), walk(grads, residuals, 1)


# --------------------------------------------------------------------------
# Overlapped ring all-gather matmul
# --------------------------------------------------------------------------
def ring_matmul_update(acc: torch.Tensor, x: torch.Tensor,
                       w_cur: torch.Tensor, src: int) -> torch.Tensor:
    """One ring step: `acc` plus the product of x's columns for the rows
    of W that shard `src` holds with that shard `w_cur`."""
    k_per = w_cur.shape[0]
    return acc + x[:, src * k_per:(src + 1) * k_per] @ w_cur


def _ring_matmul_local(ax: _Axis, x: torch.Tensor, w: torch.Tensor
                       ) -> torch.Tensor:
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=x.dtype,
                      device=x.device)
    src = ax.idx
    for i in range(ax.n):
        acc = ring_matmul_update(acc, x, w, src)
        if i < ax.n - 1:                 # JAX's last ppermute is unused
            w = ax.shift(w)
        src = (src - 1) % ax.n
    return acc


def ring_allgather_matmul(mesh, axis: str = "model") -> Callable:
    """y = x @ W with W row-sharded over `axis`; the ring passes the W
    shards on while multiplying the resident one.  x: (B, K) replicated,
    W: (K, N) sharded on K; y replicated."""
    return _sharded(mesh, axis, _ring_matmul_local,
                    (shd.P(None, None), shd.P(axis, None)),
                    shd.P(None, None),
                    lambda x, w: (x.shape[0], w.shape[1]))


def emulate_ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor,
                                  n: int) -> list[torch.Tensor]:
    """Each of n shards' product, from `ring_matmul_update` fed the W
    shards in its ring's order, in one process."""
    blocks = _blocks(w, n, 0)
    out = []
    for idx in range(n):
        acc = torch.zeros((x.shape[0], w.shape[1]), dtype=x.dtype,
                          device=x.device)
        for j in range(n):
            src = (idx - j) % n
            acc = ring_matmul_update(acc, x, blocks[src], src)
        out.append(acc)
    return out


# --------------------------------------------------------------------------
# Ring attention: sequence-sharded full attention (prefill / train)
# --------------------------------------------------------------------------
def ring_attention_state(qg: torch.Tensor) -> tuple:
    """(o, m, l) before the first block: zeros, the mask value, zeros."""
    B, S, KVH, G, Dh = qg.shape
    o = torch.zeros((B, KVH, G, S, Dh), dtype=torch.float32,
                    device=qg.device)
    m = torch.full((B, KVH, G, S), NEG_INF, dtype=torch.float32,
                   device=qg.device)
    return o, m, torch.zeros_like(m)


def ring_attention_update(o, m, l, qg, kc, vc, q_off: int, k_off: int
                          ) -> tuple:
    """One ring step's online-softmax update of (o, m, l) by one KV block.

    qg: (B, S_q, KVH, G, Dh) queries at positions q_off + i; kc / vc:
    (B, S_k, KVH, Dh) keys at k_off + j.  f32 scores times Dh^-0.5, masked
    causally with -1e30 (a fully masked row stays finite), the value
    product on p in v's dtype accumulated in f32."""
    scale = qg.shape[-1] ** -0.5
    qpos = q_off + torch.arange(qg.shape[1], device=qg.device)
    kpos = k_off + torch.arange(kc.shape[1], device=qg.device)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), kc.float()) * scale
    s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + torch.sum(p, dim=-1)
    pv = torch.einsum("bhgqs,bshd->bhgqd", p.to(vc.dtype).float(),
                      vc.float())
    return o * corr[..., None] + pv, m_new, l


def ring_attention_finish(o, l, dtype: torch.dtype) -> torch.Tensor:
    """o / max(l, 1e-30), back to (B, S, H, Dh) in `dtype`."""
    B, KVH, G, S, Dh = o.shape
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, KVH * G, Dh).to(dtype)


def _group(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    B, S, H, Dh = q.shape
    return q.reshape(B, S, kv_heads, H // kv_heads, Dh)


def _ring_attention_local(ax: _Axis, q, k, v) -> torch.Tensor:
    S_loc = q.shape[1]
    qg = _group(q, k.shape[2])
    o, m, l = ring_attention_state(qg)
    for j in range(ax.n):
        src = (ax.idx - j) % ax.n        # origin shard of the block held
        o, m, l = ring_attention_update(o, m, l, qg, k, v, ax.idx * S_loc,
                                        src * S_loc)
        if j < ax.n - 1:                 # JAX's last ppermute is unused
            k, v = ax.shift(k), ax.shift(v)
    return ring_attention_finish(o, l, q.dtype)


def ring_attention(mesh, *, axis: str = "model",
                   dp=("data",)) -> Callable:
    """Causal GQA attention with q, k, v sharded on the SEQUENCE dim over
    `axis` (the batch over `dp`, or whole with None): the KV blocks go
    round the ring while each shard accumulates its query block with an
    online softmax; step j holds the block of shard (idx - j) % n, so the
    diagonal block comes first and every later block masked for a row
    adds exactly zero to it.  No head count needs to divide the axis.

    q, k, v: (B, S, H|KVH, Dh); the result (B, S, H, Dh), differentiable
    (the gradient goes round the ring the other way)."""
    spec = shd.P(dp, axis, None, None)
    return _sharded(mesh, axis, _ring_attention_local, (spec,) * 3, spec,
                    lambda q, k, v: q.shape)


def emulate_ring_attention(q, k, v, n: int) -> torch.Tensor:
    """n shards' ring attention in one process: each query block updated
    by `ring_attention_update` with the KV blocks in its ring's order."""
    qs, ks, vs = (_blocks(t, n, 1) for t in (q, k, v))
    S_loc = q.shape[1] // n
    out = []
    for idx in range(n):
        qg = _group(qs[idx], k.shape[2])
        o, m, l = ring_attention_state(qg)
        for j in range(n):
            src = (idx - j) % n
            o, m, l = ring_attention_update(o, m, l, qg, ks[src], vs[src],
                                            idx * S_loc, src * S_loc)
        out.append(ring_attention_finish(o, l, q.dtype))
    return torch.cat(out, dim=1)


# --------------------------------------------------------------------------
# Flash-decode: sequence-sharded decode attention
# --------------------------------------------------------------------------
def flash_decode_partial(q, k, v, valid_len, offset: int) -> tuple:
    """One shard's partial softmax over its KV slice: (m, l, o), the row
    maxima, the sums of exp(s - m) and the f32 value products.

    q: (B, H, Dh); k / v: (B, S_loc, KVH, Dh) at positions offset + j;
    valid_len: the global count of valid positions (an int or a 0-d
    tensor on k's device: no host sync)."""
    B, H, Dh = q.shape
    S_loc, KVH = k.shape[1], k.shape[2]
    qg = q.reshape(B, KVH, H // KVH, Dh)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(), k.float()) \
        * (Dh ** -0.5)
    kpos = offset + torch.arange(S_loc, device=k.device)
    scores = torch.where(kpos < valid_len, scores, NEG_INF)
    m = torch.amax(scores, dim=-1)                          # (B,KVH,G)
    p = torch.exp(scores - m[..., None])
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype).float(), v.float())
    return m, torch.sum(p, dim=-1), o


def flash_decode_combine(m, l, o, m_glob) -> tuple:
    """A shard's (l, o) rescaled to the global maximum, ready to sum."""
    corr = torch.exp(m - m_glob)
    return l * corr, o * corr[..., None]


def flash_decode_finish(l_glob, o_glob, dtype: torch.dtype) -> torch.Tensor:
    B, KVH, G, Dh = o_glob.shape
    out = o_glob / torch.clamp(l_glob[..., None], min=1e-30)
    return out.reshape(B, KVH * G, Dh).to(dtype)


def _flash_decode_local(ax: _Axis, q, k, v, valid_len) -> torch.Tensor:
    m, l, o = flash_decode_partial(q, k, v, valid_len, ax.idx * k.shape[1])
    m_glob = ax.all_reduce(m, dist.ReduceOp.MAX)
    l, o = flash_decode_combine(m, l, o, m_glob)
    return flash_decode_finish(ax.all_reduce(l, dist.ReduceOp.SUM),
                               ax.all_reduce(o, dist.ReduceOp.SUM), q.dtype)


def flash_decode(mesh, *, axis: str = "model",
                 dp: tuple = ("data",)) -> Callable:
    """One-token GQA attention with the KV cache sharded on the sequence
    dim: each shard's partial softmax over its S/n slice, combined
    exactly (a MAX all-reduce of m, SUM all-reduces of l·corr and
    o·corr); no KV all-gather.

    q: (B, H, Dh) replicated over `axis`; k / v: (B, S, KVH, Dh) sharded
    on S; valid_len: the global count of valid positions (0-d)."""
    return _sharded(mesh, axis, _flash_decode_local,
                    (shd.P(dp, None, None), shd.P(dp, axis, None, None),
                     shd.P(dp, axis, None, None), None),
                    shd.P(dp, None, None), lambda q, k, v, n: q.shape)


def emulate_flash_decode(q, k, v, valid_len, n: int) -> torch.Tensor:
    """n shards' flash decode in one process: each slice's partial, the
    maximum over the shards, the rescaled partials summed in shard
    order."""
    ks, vs = _blocks(k, n, 1), _blocks(v, n, 1)
    parts = [flash_decode_partial(q, ks[i], vs[i], valid_len,
                                  i * ks[0].shape[1]) for i in range(n)]
    m_glob = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    scaled = [flash_decode_combine(m, l, o, m_glob) for m, l, o in parts]
    l_glob, o_glob = scaled[0]
    for l, o in scaled[1:]:
        l_glob, o_glob = l_glob + l, o_glob + o
    return flash_decode_finish(l_glob, o_glob, q.dtype)

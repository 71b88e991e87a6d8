"""Shared LM building blocks: norms, RoPE, attention (GQA/SWA/chunked),
MLPs.  Pure functions on tensors over explicit parameter dicts; the
dtype policy is the JAX package's (`models/layers.py`): parameters stored
in `param_dtype`, compute in `compute_dtype`, softmax and norms in f32.

Where JAX asks XLA for an f32 product of low-precision operands
(`preferred_element_type=jnp.float32`), the product here is taken on f32
copies of the operands: a bf16 x bf16 product is exact in f32, so this is
JAX's f32 accumulation.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.utils._python_dispatch import _disable_current_modes

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def from_local(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """A DTensor of global `shape` (contiguous) from this rank's shard."""
    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=torch.empty(
                                  shape, device="meta").stride())


def local_shape_and_offset(shape, mesh, placements) -> tuple:
    """This rank's shard shape and its offset in the global tensor, for a
    DTensor of `shape` on `mesh` by `placements`.

    DTensor's helper builds small index tensors on the host; it runs here
    outside every mode, so that under a fake tensor mode (a dry run) they
    hold values and no op counter sees them."""
    with _disable_current_modes():
        return compute_local_shape_and_global_offset(shape, mesh, placements)


def settle(x: DTensor) -> DTensor:
    """`x` with each pending sum (a `Partial` placement, left by a product
    sharded over its contraction) reduce-scattered onto its first or last
    dimension where one is free and divides, else all-reduced."""
    mesh, placements = x.device_mesh, list(x.placements)
    if not any(p.is_partial() for p in placements):
        return x
    for i, p in enumerate(placements):
        if not p.is_partial():
            continue
        placements[i] = Replicate()
        for dim in (0, x.ndim - 1):
            taken = [q for q in placements if q.is_shard(dim)]
            size = x.shape[dim] // math.prod(
                mesh.size(j) for j, q in enumerate(placements)
                if q.is_shard(dim))
            if not taken and size % mesh.size(i) == 0:
                placements[i] = Shard(dim)
                break
    return x.redistribute(mesh, placements)


def batch_placements(x: DTensor) -> list:
    """x's placements with only its batch (dim 0) shards kept."""
    return [p if p.is_shard(0) else Replicate() for p in x.placements]


def batch_sharded(x: torch.Tensor) -> torch.Tensor:
    """`x` as it is, or, for a DTensor, sharded on its batch dimension
    (dim 0) only: any other shard gathered, any pending sum reduced."""
    if not isinstance(x, DTensor):
        return x
    want = batch_placements(x)
    return x if list(x.placements) == want else x.redistribute(
        x.device_mesh, want)


def regroup(x: torch.Tensor, shape: tuple) -> torch.Tensor:
    """`x.reshape(shape)` where the leading dimension changes size but
    stays split the same way: for a DTensor, each shard of the batch
    dimension reshapes its own rows (and its gradient is brought back to
    the same placements in the backward); where the new leading
    dimension does not split into those shards, `x` is gathered first.

    Explicit redistribution: DTensor's view rules give a wrong local
    shape for the gradient of such a reshape of a tensor sharded on two
    dimensions, and refuse one that drops a sharded dimension of size 1,
    so the regrouping is done shard by shard."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    x = batch_sharded(x)
    mesh = x.device_mesh
    split = [i for i, p in enumerate(x.placements)
             if p.is_shard(0) and mesh.size(i) > 1]
    parts = math.prod(mesh.size(i) for i in split)
    if shape[0] % parts:
        x = x.redistribute(mesh, [Replicate()] * mesh.ndim)
        split, parts = [], 1
    local = x.to_local(grad_placements=x.placements).reshape(
        (shape[0] // parts,) + tuple(shape[1:]))
    return from_local(local, mesh, [Shard(0) if i in split else Replicate()
                                    for i in range(mesh.ndim)], shape)


def batch_local(fn, x: torch.Tensor, *weights: torch.Tensor
                ) -> torch.Tensor:
    """``fn(x, *weights)`` for a computation that is independent from one
    batch row to the next.  For a DTensor `x` each shard of its batch
    runs `fn` on its own rows with the weights gathered whole (their
    gradient a sum over the batch shards), and the result (or each
    tensor of a tuple of results) is sharded as `x` is; `fn` must keep
    the batch dimension first.

    Explicit placement: the SSD block (`models/ssm.py`) reshapes, pads and
    slices its activations in ways DTensor's rules under torch 2.11 cannot
    propagate; its weights are never sharded but by FSDP, so each shard
    runs it whole on its rows.

    On a plain `x`, `fn` takes a view of it, so that x's gradient adds
    fn's own contributions up first and the rest to their sum, as the
    DTensor branch does (through `to_local`): with x used three times or
    more the order changes the rounding, and a (1, 1) mesh would not give
    the one-device step's bits."""
    if not isinstance(x, DTensor):
        return fn(x.view_as(x), *weights)
    x = batch_sharded(x)
    mesh = x.device_mesh
    grad = [Partial() if p.is_shard(0) else Replicate()
            for p in x.placements]
    local = [w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grad) if isinstance(w, DTensor) else w
        for w in weights]
    y = fn(x.to_local(), *local)

    def out(t: torch.Tensor) -> DTensor:
        return from_local(t.contiguous(), mesh, x.placements,
                          (x.shape[0],) + tuple(t.shape[1:]))
    return tuple(map(out, y)) if isinstance(y, tuple) else out(y)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]`: rows of an embedding table.  For a DTensor table each
    shard looks up its own ids in its own columns: the rows are gathered
    whole first where the table shards them (FSDP), and its gradient is a
    sum over the shards that split the ids (`Partial`).

    Explicit placement: DTensor's rule for the backward of this indexing
    (`index_put` into a column-sharded table) fails under torch 2.11."""
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = distribute_tensor(ids, mesh, [Replicate()] * mesh.ndim,
                                src_data_rank=None)
    ids = ids.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in ids.placements])
    keep, out, grad = [], [], []
    for i, (t, d) in enumerate(zip(table.placements, ids.placements)):
        if d.is_shard():
            keep.append(Replicate())
            out.append(d)
            grad.append(Partial())
        elif t.is_shard(1):
            keep.append(t)
            out.append(Shard(ids.ndim))
            grad.append(t)
        else:
            keep.append(Replicate())
            out.append(Replicate())
            grad.append(Replicate())
    table = table.redistribute(mesh, keep)
    rows = table.to_local(grad_placements=grad)[ids.to_local()]
    return from_local(rows.contiguous(), mesh, out,
                      tuple(ids.shape) + (table.shape[1],))


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, Dh), positions: (B, S) or (S,)."""
    dt = x.dtype
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)   # (half,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]                      # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:2 * half].float()
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if x.shape[-1] > 2 * half:                               # odd tail passes
        rot = torch.cat([rot, x[..., 2 * half:].float()], dim=-1)
    return rot.to(dt)


def yarn_frequencies(dim: int, theta: float, factor: float,
                     original_max_positions: int, beta_fast: float,
                     beta_slow: float, device: torch.device | str = "cpu"
                     ) -> torch.Tensor:
    """The (dim // 2,) inverse frequencies of DeepSeek-V3's YaRN rotary
    embedding (`DeepseekV3YarnRotaryEmbedding`): theta's own frequencies
    below the correction range of `beta_fast` / `beta_slow` rotations over
    `original_max_positions`, those over `factor` above it, a linear ramp
    between.  With mscale = mscale_all_dim its cos / sin carry no factor."""
    def correction_dim(rotations: float) -> float:
        return (dim * math.log(original_max_positions
                               / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=device) / dim
    extra = 1.0 / theta ** exponent
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    keep = 1.0 - ramp                      # 1: theta's own frequency
    return extra / factor * (1 - keep) + extra * keep


def apply_rope_freqs(x: torch.Tensor, positions: torch.Tensor,
                     inv_freq: torch.Tensor) -> torch.Tensor:
    """`apply_rope` with given inverse frequencies: rotate-half pairs
    (x[:half], x[half:]) of the last axis, angles in f32.  x: (B, S, H,
    Dh); positions: (S,) or (B, S)."""
    dt = x.dtype
    half = x.shape[-1] // 2
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, :, None].float() * inv_freq[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(dt)


def sinusoidal_positions(seq: int, dim: int,
                         device: torch.device | str = "cpu") -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / half)
    ang = pos * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
def _attend_block(q, k, v, mask):
    """q: (B, Sq, KVH, G, Dh); k/v: (B, Sk, KVH, Dh); mask: (Sq, Sk) or None.

    f32 scores and softmax; the value product on the probabilities cast to
    v's dtype, accumulated in f32.
    """
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhgd,bshd->bhgqs", q.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask[None, None, None, :, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def _mask(sq: int, sk: int, q_off: int, *, causal: bool, window: int,
          device: torch.device | str = "cpu") -> torch.Tensor:
    """(sq, sk) boolean mask. q position = q_off + row."""
    qpos = q_off + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_chunk: int = 0
              ) -> torch.Tensor:
    """GQA attention.  q: (B, S, H, Dh), k/v: (B, S, KVH, Dh).

    `q_chunk > 0` enables row-blocked execution: exact softmax per query
    block, O(S * q_chunk) score memory instead of O(S^2).
    """
    if isinstance(q, DTensor):
        return _sharded_attention(q, k, v, causal=causal, window=window,
                                  q_chunk=q_chunk)
    B, S, H, Dh = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q.reshape(B, S, KVH, G, Dh)

    if q_chunk and S > q_chunk and S % q_chunk == 0:
        outs = []
        for off in range(0, S, q_chunk):
            m = (_mask(q_chunk, k.shape[1], off, causal=causal,
                       window=window, device=q.device)
                 if (causal or window) else None)
            outs.append(_attend_block(qg[:, off:off + q_chunk], k, v, m))
        out = torch.cat(outs, dim=1)
    else:
        m = _mask(S, S, 0, causal=causal, window=window,
                  device=q.device) if (causal or window) else None
        out = _attend_block(qg, k, v, m)
    return out.reshape(B, S, H, Dh)


def fused_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal attention that never holds the (H, S, S) scores: PyTorch's
    fused `scaled_dot_product_attention`, softmax in f32 inside the
    kernel.  q / k: (B, S, H, Dqk), v: (B, S, H, Dv); Dv may differ from
    Dqk (MLA's 128 against 192).  On the card only cuDNN's fused kernel
    is allowed: it takes the two widths as they are (flash attention
    needs v padded to 192 and took 2.4x as long at 2 x 8,192 x 64 heads
    on an H100), and the unfused math path, which would hold the
    scores, never runs."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 scale=scale)
    else:
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             scale=scale)
    return out.transpose(1, 2)


def _heads_on(x: DTensor, n_heads: int) -> list:
    """x's placements for attention: the batch (dim 0) keeps its shards,
    the heads (dim 2) are sharded over each other mesh dim that divides
    them, every other dim whole."""
    mesh, out, left = x.device_mesh, [], n_heads
    for i, p in enumerate(x.placements):
        if p.is_shard(0):
            out.append(p)
        elif left % mesh.size(i) == 0:
            out.append(Shard(2))
            left //= mesh.size(i)
        else:
            out.append(Replicate())
    return out


def _sharded_attention(q: DTensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool, window: int, q_chunk: int) -> DTensor:
    """`attention` of DTensors, each shard on its own heads.

    Explicit redistribution: GQA regroups q's heads as (KVH, G), which
    DTensor cannot keep sharded when the shards split a kv head's group
    (glm4-9b: 32 heads and 2 kv heads on model = 4); it would gather q
    and replicate the scores.  Instead q keeps its heads sharded (each
    shard a run of whole heads), k and v their own heads where the kv
    head count divides the shards and are whole otherwise, and each shard
    attends its q heads to the kv heads they read.  The gradient of a
    whole k / v is a sum over the shards (`Partial`)."""
    mesh = q.device_mesh
    H, KVH = q.shape[2], k.shape[2]
    G = H // KVH
    qp = _heads_on(q, H)
    kp = _heads_on(k, KVH) if isinstance(k, DTensor) else None
    if kp is not None:
        # k / v take q's batch shards and the head shards both can keep
        kp = [qp[i] if qp[i].is_shard(0) or kp[i] == qp[i] else Replicate()
              for i in range(len(qp))]
    else:
        kp = [p if p.is_shard(0) else Replicate() for p in qp]
        k, v = (distribute_tensor(t, mesh, [Replicate()] * mesh.ndim,
                                  src_data_rank=None) for t in (k, v))
    q = q.redistribute(mesh, qp)
    k, v = k.redistribute(mesh, kp), v.redistribute(mesh, kp)
    kv_grad = [Partial() if p.is_shard(2) and not kp[i].is_shard(2)
               else kp[i] for i, p in enumerate(qp)]
    ql = q.to_local()
    kl, vl = (t.to_local(grad_placements=kv_grad) for t in (k, v))
    h_local, kv_local = ql.shape[2], kl.shape[2]
    if kv_local * G != h_local:
        # k / v whole on some head shards: this shard's q heads read the
        # kv heads h // G of its global heads [h0, h0 + h_local)
        _, offset = local_shape_and_offset(q.shape, mesh, q.placements)
        h0, k_off = offset[2], local_shape_and_offset(
            k.shape, mesh, k.placements)[1][2]
        if h_local % G and G % h_local:
            raise ValueError(f"{h_local} heads a shard split GQA groups "
                             f"of {G} unevenly")
        first = h0 // G - k_off
        n_kv = max(h_local // G, 1)
        kl, vl = kl[:, :, first:first + n_kv], vl[:, :, first:first + n_kv]
    out = attention(ql, kl, vl, causal=causal, window=window,
                    q_chunk=q_chunk).contiguous()
    return from_local(out, mesh, qp, q.shape)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_pos, *, window: int = 0
                     ) -> torch.Tensor:
    """One-token attention over a (possibly longer-than-valid) KV cache.

    q: (B, 1, H, Dh); caches: (B, S, KVH, Dh); cur_pos: an int or a 0-d
    integer tensor on the caches' device — the number of valid cache
    positions (the new token's k/v already written).
    """
    if isinstance(k_cache, DTensor):
        return _sharded_decode_attention(q, k_cache, v_cache, cur_pos,
                                         window=window)
    B, _, H, Dh = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qg = q.reshape(B, 1, KVH, G, Dh)
    scale = Dh ** -0.5
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg.float(),
                          k_cache.float()) * scale
    kpos = torch.arange(S, device=q.device)[None, None, None, None, :]
    valid = kpos < cur_pos
    if window > 0:
        valid = valid & (kpos > cur_pos - 1 - window)
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def _sharded_decode_attention(q: torch.Tensor, k_cache: DTensor,
                              v_cache: DTensor, cur_pos, *, window: int
                              ) -> DTensor:
    """`decode_attention` over a DTensor cache: each batch shard of the
    cache attends its rows over the whole sequence, gathered from the
    sequence shards (what GSPMD does for JAX's plain decode attention
    over a cache that `cache_specs` shards on S).

    Explicit redistribution: DTensor would keep the scores sharded on S
    and gather them for the softmax."""
    mesh, rows = k_cache.device_mesh, batch_placements(k_cache)
    if not isinstance(q, DTensor):
        q = from_local(q, mesh, [Replicate()] * mesh.ndim, q.shape)
    if isinstance(cur_pos, DTensor):
        cur_pos = cur_pos.to_local()
    ql, kl, vl = (t.redistribute(mesh, rows).to_local()
                  for t in (q, k_cache, v_cache))
    out = decode_attention(ql, kl, vl, cur_pos, window=window)
    return from_local(out.contiguous(), mesh, rows, q.shape)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
           w_out: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_in)
    return h @ w_out


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    h = x @ w_in
    if isinstance(h, DTensor):
        # explicit redistribution: on an x sharded over d_model the
        # product is a pending sum, and torch 2.11's DTensor cannot turn
        # the d_ff-sharded bias into one (granite-34b and whisper-small
        # at the production mesh, `launch/dryrun.py`)
        h = settle(h)
    return F.gelu(h + b_in, approximate="tanh") @ w_out + b_out

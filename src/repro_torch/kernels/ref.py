"""Plain PyTorch versions of the port's kernels.

Each CUDA kernel in `csrc/` computes the function of the same name here.
The CPU path and the tests run these; `chip_smoke.py` holds every kernel
against them on the card.  They mirror `src/repro/kernels/ref.py`.

Conventions (CatBoost's oblivious-tree model):
  x              (N, F)  float32   raw feature matrix
  borders        (B, F)  float32   per-feature bin borders, padded with +inf
  bins           (N, F)  int32 | uint8  #borders strictly below x
  split_features (T, D)  int32     feature id used at depth d of tree t
  split_bins     (T, D)  int32     border id; go right iff bins[f] >= split_bin
  leaf_values    (T, 2^D, C) float32
  leaf index     idx[n, t] = sum_d 2^d * [bins[n, sf[t, d]] >= sb[t, d]]

The depth_major and bitpacked layouts hold the splits as (D, T) planes
(row d = every tree's level-d split); their `_depth_major` / `_bitpacked`
functions compute the same leaf index from them.

Training (`histogram`):
  bins_t         (F, N)  int32 | uint8  feature-major bins
  leaf           (N,)    int32     current leaf id of each sample
  g              (N, S)  float32   per-sample stats (gradients, hessians)
  hist[f, l * n_bins + b, s] = sum_n g[n, s] [leaf[n] = l] [bins_t[f, n] = b]
  (`histogram_fixed`: the same sum in the CUDA kernel's int64 fixed point)

kNN features (`l2sq_rowwise`, `l2sq_matrix`): squared L2 distances in
float32, the paper's L2SqrDistance, one query at a time or as a matrix.
`l2sq_rowwise_lanes` is the rowwise kernel's own summation order (lanes,
fmaf, a butterfly), bit for bit; `fmaf` the fused multiply-add it uses.
The CUDA matrix kernel takes its cross term from the tensor cores as
3xTF32; `tf32_split` and `l2sq_matrix_tf32` emulate that on the CPU.
"""
from __future__ import annotations

import math

import torch

# Largest border count whose bin ids fit one byte (CatBoost's 255-border
# cap: ids span [0, B]).
MAX_U8_BORDERS = 255


def binarize(x: torch.Tensor, borders: torch.Tensor) -> torch.Tensor:
    """bins[n, f] = #{b : x[n, f] > borders[b, f]} -> (N, F) int32.

    Strict `>`: NaN compares false and lands in bin 0; +inf padding
    borders are never crossed."""
    return (x[:, None, :] > borders[None, :, :]).sum(dim=1,
                                                     dtype=torch.int32)


def binarize_u8(x: torch.Tensor, borders: torch.Tensor) -> torch.Tensor:
    """`binarize` as the one-byte quantized-pool stream (B <= 255).

    The same compare-sum as `binarize`, so NaN needs no mask (a
    `searchsorted` form would sort NaN past +inf and has to mask it)."""
    if borders.shape[0] > MAX_U8_BORDERS:
        raise ValueError(f"uint8 bins need <= {MAX_U8_BORDERS} borders, got "
                         f"{borders.shape[0]}")
    return binarize(x, borders).to(torch.uint8)


def leaf_index(bins: torch.Tensor, split_features: torch.Tensor,
               split_bins: torch.Tensor) -> torch.Tensor:
    """idx[n, t] = sum_d 2^d * [bins[n, sf[t, d]] >= sb[t, d]] -> (N, T)
    int32.  `bins` may be int32 or uint8.

    The compare runs in int32, so the 2^30 PAD_SPLIT_BIN of padded trees
    and truncated levels never goes right."""
    n = bins.shape[0]
    t, d = split_features.shape
    idx = torch.zeros((n, t), dtype=torch.int32, device=bins.device)
    for level in range(d):
        gathered = torch.index_select(bins, 1,
                                      split_features[:, level].long())
        go_right = gathered.to(torch.int32) >= split_bins[:, level]
        idx |= go_right.to(torch.int32) << level
    return idx


def leaf_index_depth_major(bins: torch.Tensor,
                           split_features_dm: torch.Tensor,
                           split_bins_dm: torch.Tensor,
                           pow2: torch.Tensor) -> torch.Tensor:
    """`leaf_index` over the depth-major arrays -> (N, T) int32.

    `split_features_dm` and `split_bins_dm` are the (D, T) int32 planes
    (row d holds every tree's level-d split) and `pow2` the (D, 1) f32
    per-level weights 2^d, summed as integers.  The JAX package gathers
    with a (T, D, F) one-hot matmul instead; the port lowers no one-hot."""
    d, t = split_features_dm.shape
    weights = pow2[:, 0].to(torch.int32)
    idx = torch.zeros((bins.shape[0], t), dtype=torch.int32,
                      device=bins.device)
    for level in range(d):
        gathered = torch.index_select(bins, 1, split_features_dm[level].long())
        go_right = gathered.to(torch.int32) >= split_bins_dm[level]
        idx += go_right.to(torch.int32) * weights[level]
    return idx


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a 0/1 plane along axis 0 into uint32 words -> (ceil(N/32), ...).

    Bit k of word w is row 32*w + k; rows past N are 0 (the paper's
    32-doc `vmsgeu` mask word).  Shifts run in int64: PyTorch has no
    uint32 shift on the CPU."""
    n = bits.shape[0]
    words = -(-max(n, 1) // 32)
    b = bits.to(torch.int64)
    pad = torch.zeros((words * 32 - n,) + tuple(b.shape[1:]),
                      dtype=torch.int64, device=b.device)
    b = torch.cat([b, pad]).reshape((words, 32) + tuple(b.shape[1:]))
    shifts = torch.arange(32, device=b.device).reshape(
        (1, 32) + (1,) * (b.ndim - 2))
    return (b << shifts).sum(dim=1).to(torch.uint32)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of `pack_bits`: uint32 words -> the first `n` 0/1 rows
    (int32)."""
    shifts = torch.arange(32, device=words.device).reshape(
        (1, 32) + (1,) * (words.ndim - 1))
    bits = (words.to(torch.int64)[:, None] >> shifts) & 1
    out = bits.reshape((words.shape[0] * 32,) + tuple(words.shape[1:]))
    return out[:n].to(torch.int32)


def leaf_index_bitpacked(bins: torch.Tensor, split_features_bp: torch.Tensor,
                         split_bins_bp: torch.Tensor, *,
                         via_words: bool = False) -> torch.Tensor:
    """`leaf_index` over the bitpacked (D, T) planes -> (N, T) int32.

    `split_bins_bp` is uint8 where every threshold fits a byte, else
    int32.  uint8 bins compare against a uint8 plane as bytes; any int32
    side makes the compare int32, so PAD_SPLIT_BIN never goes right.
    Each level's compare is one bit per row, or'ed in at bit d.
    `via_words=True` routes every level's bits through `pack_bits` /
    `unpack_bits` (the 32-row word round trip the kernels make), which
    is the identity."""
    d, t = split_features_bp.shape
    n = bins.shape[0]
    idx = torch.zeros((n, t), dtype=torch.int32, device=bins.device)
    for level in range(d):
        gathered = torch.index_select(bins, 1, split_features_bp[level].long())
        bit = gathered >= split_bins_bp[level]
        if via_words:
            bit = unpack_bits(pack_bits(bit), n)
        idx |= bit.to(torch.int32) << level
    return idx


def leaf_gather(idx: torch.Tensor, leaf_values: torch.Tensor) -> torch.Tensor:
    """pred[n, c] = sum_t leaf_values[t, idx[n, t], c] -> (N, C) float32."""
    t, n_leaves, c = leaf_values.shape
    flat = leaf_values.reshape(t * n_leaves, c)
    offsets = torch.arange(t, device=idx.device) * n_leaves
    return flat[idx.long() + offsets].sum(dim=1)


def fused_predict(x: torch.Tensor, borders: torch.Tensor,
                  split_features: torch.Tensor, split_bins: torch.Tensor,
                  leaf_values: torch.Tensor) -> torch.Tensor:
    """binarize -> leaf_index -> leaf_gather as one function -> (N, C)."""
    bins = binarize(x, borders)
    return leaf_gather(leaf_index(bins, split_features, split_bins),
                       leaf_values)


def fused_predict_depth_major(x: torch.Tensor, borders: torch.Tensor,
                              split_features_dm: torch.Tensor,
                              split_bins_dm: torch.Tensor, pow2: torch.Tensor,
                              leaf_values: torch.Tensor) -> torch.Tensor:
    """`fused_predict` over the depth-major arrays -> (N, C)."""
    bins = binarize(x, borders)
    return leaf_gather(leaf_index_depth_major(bins, split_features_dm,
                                              split_bins_dm, pow2),
                       leaf_values)


def fused_predict_bitpacked(x: torch.Tensor, borders: torch.Tensor,
                            split_features_bp: torch.Tensor,
                            split_bins_bp: torch.Tensor,
                            leaf_values: torch.Tensor) -> torch.Tensor:
    """`fused_predict` over the bitpacked planes -> (N, C)."""
    bins = binarize(x, borders)
    return leaf_gather(leaf_index_bitpacked(bins, split_features_bp,
                                            split_bins_bp),
                       leaf_values)


def histogram(bins_t: torch.Tensor, leaf: torch.Tensor, g: torch.Tensor, *,
              n_bins: int, n_leaves: int) -> torch.Tensor:
    """Segment-sum of `g` over (feature, leaf, bin) -> (F, n_leaves *
    n_bins, S) in g's dtype (float32 on the training path).

    Segment ids are `leaf * n_bins + bins_t[f]`, widened to int64 for
    `index_add_`.  On the CPU `index_add_` adds the rows in sample order,
    as the JAX package's `segment_sum` does, so both give the same bits;
    on the card it adds with float atomics, in no fixed order."""
    f, _ = bins_t.shape
    segments = n_leaves * n_bins
    out = torch.zeros((f, segments, g.shape[1]), dtype=g.dtype,
                      device=g.device)
    base = leaf.long() * n_bins
    for j in range(f):
        out[j].index_add_(0, base + bins_t[j].long(), g)
    return out


def stat_exponent(g: torch.Tensor) -> list[int]:
    """Per-stat exponent e of the histogram kernel's fixed-point scale
    2^e (csrc/histogram.cu `stat_exponent`): e = 62 - lg - ex, with lg
    the bit length of N and ex the `frexp` exponent of the stat's largest
    |g|, so N scaled terms never reach 2^62; 0 for an all-zero stat."""
    n, s = g.shape
    if n == 0:
        return [0] * s
    m = g.detach().abs().amax(dim=0).to(torch.float32).cpu()
    _, ex = torch.frexp(m)
    lg = int(n).bit_length()
    return [62 - lg - int(e) if float(v) > 0 else 0
            for v, e in zip(m.tolist(), ex.tolist())]


def histogram_fixed(bins_t: torch.Tensor, leaf: torch.Tensor,
                    g: torch.Tensor, *, n_bins: int,
                    n_leaves: int) -> torch.Tensor:
    """`histogram` in the kernel's 64-bit fixed point -> (F, n_leaves *
    n_bins, S) float32, the same bits as the CUDA kernel.

    Each term is rint(g * 2^e) as int64 (e from `stat_exponent`); the
    integers are summed exactly (`index_add_` in int64, in any order),
    converted to f64, scaled by 2^-e (exact) and rounded once to f32."""
    f, _ = bins_t.shape
    e = stat_exponent(g)
    scale = torch.tensor([math.ldexp(1.0, k) for k in e],
                         dtype=torch.float64, device=g.device)
    inv = torch.tensor([math.ldexp(1.0, -k) for k in e],
                       dtype=torch.float64, device=g.device)
    q = torch.round(g.double() * scale).to(torch.int64)
    acc = torch.zeros((f, n_leaves * n_bins, g.shape[1]), dtype=torch.int64,
                      device=g.device)
    base = leaf.long() * n_bins
    for j in range(f):
        acc[j].index_add_(0, base + bins_t[j].long(), q)
    return (acc.double() * inv).to(torch.float32)


def l2sq_rowwise(q: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """Paper-faithful L2SqrDistance: out[n] = sum_k (refs[n, k] - q[k])^2
    -> (N,) float32."""
    d = refs - q[None, :]
    return (d * d).sum(dim=-1)


def fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as CUDA's fmaf.  a * b is exact in
    float64; the float64 sum is taken round-to-odd (its exact error from
    TwoSum moves an inexact even result one ulp toward the true sum), and
    a round-to-odd value of 53 bits rounds to 24 as the exact sum would."""
    x = a.double() * b.double()
    y = c.double()
    s = x + y
    t = s - x
    err = (x - (s - t)) + (y - t)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def l2sq_rowwise_lanes(q: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """`l2sq_rowwise` in the CUDA kernel's order, the same bits on every
    route of `csrc/l2sq_rowwise.cu`: lane l (of 32) sums columns 4i ..
    4i + 3 for i = l, l + 32, l + 64, ... in that order with fmaf, then a
    butterfly adds lane l ^ 16, ^ 8, ^ 4, ^ 2, ^ 1 in turn (float32).
    q (K,) gives (N,); q (Q, K) gives each query's row, (Q, N)."""
    n, k = refs.shape
    k_pad = -(-k // 128) * 128
    d = torch.nn.functional.pad(refs - q[..., None, :], (0, k_pad - k))
    d = d.reshape(*d.shape[:-1], k_pad // 128, 32, 4)   # pass, lane, column
    acc = torch.zeros(d.shape[:-3] + (32,), dtype=torch.float32,
                      device=refs.device)
    for i in range(k_pad // 128):
        for c in range(4):
            acc = fmaf(d[..., i, :, c], d[..., i, :, c], acc)
    lanes = torch.arange(32, device=refs.device)
    for offset in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ offset]
    return acc[..., 0].contiguous()


def l2sq_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise distances (M, N): max(||a||^2 + ||b||^2 - 2 a.b^T, 0), the
    cross term as one float32 `a @ b.T`."""
    a_sq = (a * a).sum(dim=-1)[:, None]
    b_sq = (b * b).sum(dim=-1)[None, :]
    cross = a @ b.T
    return torch.clamp_min(a_sq + b_sq - 2.0 * cross, 0.0)


# TF32 keeps 10 of float32's 23 mantissa bits: the low 13 are dropped.
TF32_DROPPED_BITS = 13
_TF32_MASK = ~((1 << TF32_DROPPED_BITS) - 1)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared: what a tensor core reads
    of a float32 operand in TF32.  NaN and +-inf pass through."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(torch.isfinite(x),
                       (bits & _TF32_MASK).view(torch.float32), x)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 x, as the matrix kernel's split pass makes them:
    hi = x rounded to TF32, to nearest with ties away from zero
    (`cvt.rna.tf32.f32`: half a TF32 unit added to the magnitude bits,
    then truncated), and lo = x - hi, exact in float32."""
    bits = x.contiguous().view(torch.int32)
    half = 1 << (TF32_DROPPED_BITS - 1)
    hi = torch.where(torch.isfinite(x),
                     ((bits + half) & _TF32_MASK).view(torch.float32), x)
    return hi, x - hi


def l2sq_matrix_tf32(a: torch.Tensor, b: torch.Tensor,
                     products: int = 3) -> torch.Tensor:
    """`l2sq_matrix` with its cross term as the tensor cores give it, in
    the CUDA kernel's epilogue order.  products=3 is 3xTF32: a_hi.b_hi +
    a_hi.b_lo + a_lo.b_hi, lo read as TF32; products=1 is a_hi.b_hi alone.
    Products of TF32 values are exact in float32, so one float32 matmul
    over the concatenated parts models one float32 accumulator."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    if products == 1:
        cross = a_hi @ b_hi.T
    elif products == 3:
        cross = torch.cat([a_hi, a_hi, tf32_truncate(a_lo)], dim=1) \
            @ torch.cat([b_hi, tf32_truncate(b_lo), b_hi], dim=1).T
    else:
        raise ValueError(f"products must be 1 or 3, got {products}")
    a_sq = (a * a).sum(dim=-1)[:, None]
    b_sq = (b * b).sum(dim=-1)[None, :]
    return torch.clamp_min((-2.0 * cross + a_sq) + b_sq, 0.0)

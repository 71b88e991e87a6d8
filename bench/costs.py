"""The yardstick's arithmetic: the bytes and operations a piece of work
needs, and the least time an NVIDIA H100 could take for them.

The formulas are a frozen copy of the program's
(`repro_torch.launch.hlo_analysis.compares` and `launch_cost`, as they
stood when this benchmark was written), so that no later change to the
program moves the bounds its rooflines are read against; `test_bench_costs`
holds them equal at every cell's shapes.  Each input byte is read once and
each output byte written once, whatever a kernel reads again; a value's bin
costs a binary search's compares, `bit_length(n_borders)`; a tree costs its
depth in compares and C adds for each row.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit: 67 TFLOP/s
of float32 off the tensor cores (every GBDT kernel's arithmetic) and 3.35
TB/s of HBM3.
"""
from __future__ import annotations

FP32_FLOPS = 67e12
HBM_BW = 3.35e12
F32 = 4


def compares(n_borders: int) -> int:
    """Compares that find a value's bin among `n_borders` sorted borders."""
    return int(n_borders).bit_length()


def bound_s(moved: float, ops: float, chips: int = 1) -> float:
    """The least seconds `chips` cards take to move `moved` bytes and do
    `ops` float32 operations."""
    return max(moved / HBM_BW, ops / FP32_FLOPS) / chips


def fused_predict(rows: int, features: int, borders: int, trees: int,
                  depth: int, outputs: int) -> tuple[int, int]:
    """(bytes, operations) of binarize + leaf index + leaf sum in one pass:
    the rows, the borders, the (T, D) split features and bins (int32), the
    whole leaf table and the (N, C) scores."""
    moved = F32 * (rows * features + borders * features + 2 * trees * depth
                   + trees * (1 << depth) * outputs + rows * outputs)
    ops = (rows * features * compares(borders) + rows * trees * depth
           + rows * trees * outputs)
    return moved, ops


def apply_call(rows: int, features: int, borders: int, trees: int,
               depth: int, outputs: int) -> tuple[int, int]:
    """(bytes, operations) of one `proba` call: the fused pass, then the
    output transform (5 operations an output: max, subtract, exp, sum,
    divide), whose probabilities are the bytes written."""
    moved, ops = fused_predict(rows, features, borders, trees, depth,
                               outputs)
    width = max(outputs, 2)
    moved += F32 * rows * (width - outputs)
    return moved, ops + 5 * rows * outputs


def histogram(features: int, rows: int, leaves: int, bins: int, stats: int,
              bin_bytes: int = 1) -> tuple[int, int]:
    """(bytes, operations) of one level histogram: the (F, N) bins, the (N,)
    int32 leaf ids and (N, S) stats read, the (F, leaves x bins, S) sums
    written; one add a (feature, row, stat)."""
    moved = (features * rows * bin_bytes + F32 * rows + F32 * rows * stats
             + F32 * features * leaves * bins * stats)
    return moved, features * rows * stats


def train_iteration(rows: int, features: int, bins: int, depth: int,
                    outputs: int) -> tuple[int, int]:
    """(bytes, operations) of one boosting iteration of an oblivious tree
    under a C-output loss with Newton leaves (2C stats a row):

      gradients   read the (N, C) scores and labels, write (N, 2C); 8
                  operations a row and output (softmax 5, g 1, h 2)
      each level  its histogram over 2^d leaves; the split search reads it
                  once and does 8 operations a (feature, leaf, bin, output)
                  (a scan of g and h, then a square, an add and a divide on
                  each side)
      leaves      the per-leaf sums (one feature, one bin), then the scores
                  read and written with one add a row and output
    """
    s = 2 * outputs
    moved = F32 * (rows * outputs + rows + rows * s)
    ops = 8 * rows * outputs
    for d in range(depth):
        m, o = histogram(features, rows, 1 << d, bins, s)
        moved += m + F32 * features * (1 << d) * bins * s
        ops += o + 8 * features * (1 << d) * bins * outputs
    m, o = histogram(1, rows, 1 << depth, 1, s)
    moved += m + 2 * F32 * rows * outputs
    ops += o + rows * outputs
    return moved, ops

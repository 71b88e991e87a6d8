"""The plain reference the benchmark judges the program's outputs by.

Plain PyTorch (no kernels, no caches, no batching), in float64 unless a
caller asks for a lower precision (the controls).  It imports nothing but
`torch` and `numpy`: not the program, not its JAX original, not JAX.  It
works everything out again from what the benchmark made (the model's
arrays, the rows, the labels, the borders): bins, leaf indices, tree-order
sums, the output transform, gradients, histograms, split gains and leaf
values.
"""
from reference.gbdt import (binarize, grad_hess_multiclass, leaf_index,
                            leaf_values, level_histogram, proba, raw_scores,
                            split_gains)

__all__ = ["binarize", "grad_hess_multiclass", "leaf_index", "leaf_values",
           "level_histogram", "proba", "raw_scores", "split_gains"]

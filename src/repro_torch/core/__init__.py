"""Model structure, quantization, layout, prediction plans, losses,
boosting, and the kNN embedding featurizer (`knn`)."""
from repro_torch.core import knn  # noqa: F401

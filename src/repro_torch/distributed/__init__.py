"""Multi-device GBDT prediction: a single-controller `Mesh` and the
replica groups built from it (`Predictor.sharded` is the consumer)."""
from repro_torch.distributed.gbdt import replica_submeshes  # noqa: F401
from repro_torch.distributed.mesh import Mesh, make_mesh  # noqa: F401

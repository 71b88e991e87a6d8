"""Distribution substrate: the single-controller GBDT mesh (`Mesh`,
replica groups) and, one process a shard, the collectives of the LM
models' mesh branches."""
from repro_torch.distributed import collectives  # noqa: F401
from repro_torch.distributed.gbdt import replica_submeshes  # noqa: F401
from repro_torch.distributed.mesh import Mesh, make_mesh  # noqa: F401

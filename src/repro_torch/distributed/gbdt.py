"""Replica-group meshes for GBDT serving.

The port's counterpart of `src/repro/distributed/gbdt.py`.  A registry
serving K models from one mesh can trade data parallelism for request
parallelism: split the mesh into R disjoint submeshes ("replica groups")
and round-robin requests across them.  Each replica still runs the full
sharded predict path over its own shards, so within a replica the
row-sharding parity contract holds unchanged; across replicas the only
shared state is the ensemble and its quantizer (pools remain shareable:
same borders, same fingerprint).

`repro_torch.serving.engine.ModelRegistry.register(..., replicas=R)` is
the consumer: it builds one `GBDTServer` per submesh and merges their
metrics with `ServerMetrics.merge`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.distributed.mesh import Mesh, make_mesh


def replica_submeshes(mesh: Mesh, n_replicas: int, *,
                      axis_name: str = None) -> list[Mesh]:
    """Split a mesh into ``n_replicas`` disjoint 1-D submeshes.

    Shards are taken in the mesh's flattened order and dealt out in
    contiguous runs, so a replica's devices stay as close as the parent
    mesh laid them.  Every submesh is 1-D over ``axis_name`` (default:
    the parent's first axis name): replica groups are a data-parallel
    construct; a caller that wants hybrid row x tree sharding inside a
    replica can still pass the submesh to `Predictor.sharded` with
    ``model_axis`` naming an axis of size 1, which degrades to pure row
    sharding.

    Raises ``ValueError`` unless the shard count divides evenly:
    silently uneven replicas would skew round-robin load balancing.
    """
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    devices = np.asarray(mesh.devices).reshape(-1)
    if len(devices) % n_replicas:
        raise ValueError(
            f"cannot split {len(devices)} devices into {n_replicas} "
            "equal replica groups")
    per = len(devices) // n_replicas
    axis = axis_name if axis_name is not None else mesh.axis_names[0]
    return [make_mesh((per,), (axis,),
                      devices=devices[i * per:(i + 1) * per])
            for i in range(n_replicas)]

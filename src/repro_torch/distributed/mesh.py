"""A single-controller device mesh: the port's counterpart of
`jax.sharding.Mesh` and `repro.compat.make_mesh`.

One Python process drives every shard of a mesh, as `shard_map` does in
the JAX package: `Predictor.sharded` walks the mesh's devices, launches
each shard's kernels on its device and combines the results.  There is
no process group; the GBDT path's only collective, the sum of
tree-sharded partial scores, is an addition on the mesh's first device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """An n-d array of `torch.device`s with one name per axis.

      devices     object ndarray of `torch.device`, one entry a shard
      axis_names  tuple of axis names, one per array dimension
      shape       ordered {axis name: size}, as ``dict(mesh.shape)``
                  reads on a JAX mesh
      size        number of shards

    Unlike a JAX mesh, a device may appear more than once.  Each entry
    is a logical shard: it takes its own slice of the rows or trees and
    runs its own kernel launches, on whichever device it names.  So a
    4-shard mesh may lie on ``"cpu"`` four times (the tests), or on one
    card four times (``cuda:0``), and behaves as it would on four
    devices, bar the speed.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        axis_names = tuple(axis_names)
        grid = np.vectorize(torch.device, otypes=[object])(
            np.array(devices, dtype=object))
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device array needs "
                             f"{grid.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = grid
        self.axis_names = axis_names

    @property
    def shape(self) -> dict[str, int]:
        return {a: int(s) for a, s in zip(self.axis_names,
                                          self.devices.shape)}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> list[torch.device]:
        """The devices in the mesh's flattened (row-major) order."""
        return list(self.devices.reshape(-1))

    def shard_devices(self, row_axes: Sequence[str] = (),
                      tree_axes: Sequence[str] = ()
                      ) -> list[list[torch.device]]:
        """devices[i][j]: the device of row shard i and tree shard j, the
        shards counted row-major over `row_axes` and over `tree_axes`;
        index 0 on the axes that split neither (what ``P(row_axes)``
        leaves replicated, computed once)."""
        sizes = self.shape

        def coords(i: int, axes) -> dict:
            if not axes:
                return {}
            at = np.unravel_index(i, [sizes[a] for a in axes])
            return {a: int(c) for a, c in zip(axes, at)}

        def count(axes) -> int:
            return int(np.prod([sizes[a] for a in axes], dtype=int))

        out = []
        for i in range(count(row_axes)):
            row = []
            for j in range(count(tree_axes)):
                at = {**coords(i, row_axes), **coords(j, tree_axes)}
                row.append(self.devices[tuple(at.get(a, 0)
                                              for a in self.axis_names)])
            out.append(row)
        return out

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({axes}; {sorted({str(d) for d in self.device_list})})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              devices: Optional[Sequence] = None) -> Mesh:
    """A `Mesh` of `shape` over `devices` (flat, in row-major order;
    entries may repeat).  Without `devices`, every CUDA device once, so
    `shape` must multiply to `torch.cuda.device_count()`."""
    shape = tuple(int(s) for s in shape)
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    flat = np.array(devices, dtype=object).reshape(-1)
    if flat.size != int(np.prod(shape)):
        raise ValueError(f"a {shape} mesh needs {int(np.prod(shape))} "
                         f"devices, got {flat.size}")
    return Mesh(flat.reshape(shape), axis_names)

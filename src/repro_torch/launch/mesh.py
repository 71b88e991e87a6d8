"""Mesh construction: the port's counterpart of `src/repro/launch/mesh.py`.

Functions, not module-level constants, so importing touches no device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.distributed import runtime
from repro_torch.distributed.mesh import Mesh, make_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """The production layout: (16, 16) ("data", "model") over 256
    devices, or (2, 16, 16) with the slowest "pod" axis first over 512.
    Raises `ValueError` unless given exactly that many devices (the
    default is every CUDA device of this process)."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return make_mesh(shape, axes, devices=devices)


def make_local_mesh(n_shards: Optional[int] = None, model: int = 1,
                    device: torch.device | str = "cuda") -> Mesh:
    """A small (n_shards // model, model) ("data", "model") mesh for
    tests, examples and one machine.

    Inside a process group (`distributed.runtime.initialize`) each entry
    is a rank, in rank order: `n_shards` defaults to the world size and
    must equal it, and entry i names rank i's device (its card,
    ``cuda:LOCAL_RANK`` on one machine, or ``cpu``).

    Outside one, on ``device="cuda"``, `n_shards` defaults to the card
    count and the shards are dealt round robin over the cards, so more
    shards than cards put several logical shards on one card.  A device
    with an index ("cuda:1") or ``"cpu"`` puts every shard there."""
    device = torch.device(device)
    if runtime.is_distributed():
        n = n_shards or runtime.world_size()
        if n != runtime.world_size():
            raise ValueError(f"{n} shards in a group of "
                             f"{runtime.world_size()} ranks: one a rank")
        if device.type == "cuda":
            n_cards = max(torch.cuda.device_count(), 1)
            devices = [torch.device("cuda", r % n_cards) for r in range(n)]
            devices[runtime.rank()] = runtime.local_device("cuda")
        else:
            devices = [device] * n
    elif device.type == "cuda" and device.index is None:
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("no CUDA device: the mesh runs on the card "
                               "unless the caller passes device='cpu'")
        n = n_shards or n_cards
        devices = [torch.device("cuda", i % n_cards) for i in range(n)]
    else:
        n = n_shards or 1
        devices = [device] * n
    if n % model:
        raise ValueError(f"{n} shards do not split into model={model}")
    return make_mesh((n // model, model), ("data", "model"),
                     devices=devices)

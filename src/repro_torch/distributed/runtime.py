"""One process a shard: the port's counterpart of
`jax.distributed.initialize`, and the bridge from the port's `Mesh` to a
`torch.distributed` `DeviceMesh`.

    runtime.initialize(coordinator, num_processes, process_id,
                       device="cuda")      # or the environment torchrun sets
    mesh = make_local_mesh(model=2)        # one entry a rank
    dm = runtime.device_mesh(mesh)         # its DeviceMesh, made once

The LM trainer runs one process a card (NCCL) or, on the CPU, one process
a logical shard (gloo).  Each process holds its own shard of every leaf
as a DTensor placed by the `PartitionSpec`s of `distributed.sharding`; the
collectives are DTensor's.  A mesh of more than one shard needs a process
group of as many ranks: nothing here falls back to one process.
"""
from __future__ import annotations

import contextlib
import datetime
import functools
import os
from typing import Iterator

import torch
import torch.distributed as dist

_DEVICE_MESHES: dict = {}


def initialize(coordinator: str = "", num_processes: int = 0,
               process_id: int = -1, *, device: str = "cuda",
               timeout_s: float = 600.0) -> None:
    """Join the process group: NCCL for ``device="cuda"``, gloo for
    ``"cpu"``.  One rank a card: NCCL refuses two ranks on one device.

    With `coordinator` ("host:port", or any `init_method` URL such as
    ``file:///path``), `num_processes` and `process_id` it rendezvouses
    there, as `jax.distributed.initialize` does; without them it reads
    RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT, which `torchrun` sets.
    On the card each rank takes ``cuda:LOCAL_RANK`` (else rank modulo the
    card count).  A second call in a joined process does nothing."""
    if dist.is_initialized():
        return
    device_type = torch.device(device).type
    if coordinator:
        if num_processes <= 0 or not 0 <= process_id < num_processes:
            raise ValueError(
                f"--coordinator needs --num-processes > 0 and 0 <= "
                f"--process-id < it (got {num_processes}, {process_id})")
        url = coordinator if "://" in coordinator else \
            f"tcp://{coordinator}"
        kw = dict(init_method=url, world_size=num_processes,
                  rank=process_id)
    else:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "no rendezvous: pass a coordinator, the process count and "
                "this process's id, or start under torchrun")
        kw = dict(init_method="env://")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: a process group on the "
                               "card needs one (use device='cpu')")
        torch.cuda.set_device(local_device("cuda", kw.get("rank")))
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, timeout=datetime.timedelta(
        seconds=timeout_s), **kw)


def local_device(device_type: str = "cuda", rank_: int | None = None
                 ) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (else the rank modulo the
    card count) on the card, ``cpu`` otherwise."""
    if device_type != "cuda":
        return torch.device(device_type)
    r = int(os.environ.get("LOCAL_RANK", rank() if rank_ is None
                           else rank_))
    return torch.device("cuda", r % max(torch.cuda.device_count(), 1))


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_primary() -> bool:
    return rank() == 0


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def device_mesh(mesh):
    """The `DeviceMesh` of the port's `Mesh`: its shape and axis names
    over the process group's ranks, in row-major order (entry i is rank
    i).  Made once a (shape, names, device type) and reused: building one
    is a collective over every rank."""
    from torch.distributed.device_mesh import init_device_mesh

    if not is_distributed():
        raise RuntimeError(
            f"a mesh of {mesh.size} shards needs a process group of "
            f"{mesh.size} ranks: call runtime.initialize first")
    if mesh.size != world_size():
        raise ValueError(f"a mesh of {mesh.size} shards needs "
                         f"{mesh.size} ranks, the group has {world_size()}")
    device_type = mesh.device_list[rank()].type
    key = (tuple(mesh.devices.shape), tuple(mesh.axis_names), device_type)
    if key not in _DEVICE_MESHES:
        _DEVICE_MESHES[key] = init_device_mesh(
            device_type, tuple(mesh.devices.shape),
            mesh_dim_names=tuple(mesh.axis_names))
    return _DEVICE_MESHES[key]


def shutdown() -> None:
    """Leave the process group (the meshes made in it go with it)."""
    _DEVICE_MESHES.clear()
    if is_distributed():
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# A fake group for a dry run
# --------------------------------------------------------------------------
def dry_run_device_type() -> str:
    """The device type a dry run's tensors and `DeviceMesh` take: "cuda"
    where PyTorch is built for CUDA (no card is needed: the tensors are
    fake), else "cpu".  A CPU-only build cannot take the backward of a
    fake CUDA tensor (autograd asks for a CUDA device guard), so there the
    dry run is traced on "cpu", with `_dry_run_dtensor` keeping DTensor's
    all-to-all what it is on the card."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _host_side(fn):
    """`fn` run outside every dispatch mode (a fake tensor mode too)."""
    from torch.utils._python_dispatch import _disable_current_modes

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return run


def _alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's `shard_dim_alltoall` as it runs on a CUDA mesh: the
    all-to-all op itself, never the CPU group's all-gather and chunk."""
    from torch.distributed import _functional_collectives as funcol
    group = funcol._resolve_group((mesh, mesh_dim))
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, funcol._group_or_group_name(group))


@contextlib.contextmanager
def _dry_run_dtensor(device_type: str) -> Iterator[None]:
    """DTensor as a dry run needs it, put back on leaving:

      * `_StridedShard.local_shard_size_and_offset` (the placement a
        reshape of a doubly sharded dim leaves) runs outside the fake
        mode: it reads an index tensor on the host, which a fake tensor
        cannot give (`DataDependentOutputException`);
      * the sharding propagator's output-shape probe, which runs each new
        op once at its global shapes, runs outside every mode, so an op
        counter sees only the local ops;
      * on a CPU mesh, DTensor's Shard(i) -> Shard(j) is the all-to-all
        it is on the card, not the gloo fallback's all-gather and chunk.
    """
    from torch.distributed.tensor import placement_types as pt
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    wanted = [(ShardingPropagator, "_propagate_tensor_meta_non_cached")]
    strided = getattr(pt, "_StridedShard", None)
    if strided is not None:
        wanted += [(strided, "local_shard_size_and_offset"),
                   (strided, "_local_shard_size_and_offset")]
    patched = []
    for owner, name in wanted:            # torch versions differ: the
        raw = owner.__dict__.get(name)    # names present are patched
        if raw is None:
            continue
        patched.append((owner, name, raw))
        setattr(owner, name, staticmethod(_host_side(raw.__func__))
                if isinstance(raw, staticmethod) else _host_side(raw))
    if device_type == "cpu" and "shard_dim_alltoall" in pt.__dict__:
        patched.append((pt, "shard_dim_alltoall", pt.shard_dim_alltoall))
        pt.shard_dim_alltoall = _alltoall
    try:
        yield
    finally:
        for owner, name, raw in reversed(patched):
            setattr(owner, name, raw)


@contextlib.contextmanager
def fake_group(n: int, device_type: str | None = None) -> Iterator[str]:
    """Join a fake process group of `n` ranks as rank 0 for the block, and
    leave it after: the port's counterpart of JAX's
    ``--xla_force_host_platform_device_count``.  Collectives on it move
    nothing and return at once, so one process traces what rank 0 of an
    `n`-card run would do.  Yields the device type (`dry_run_device_type`
    by default).

    Build every `DeviceMesh` (`device_mesh`) inside the block and before
    any fake tensor mode is entered: building one under a fake mode reads
    fake tensors.  Refuses to run inside a real group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if is_distributed():
        raise RuntimeError("a fake group inside a process group")
    device_type = device_type or dry_run_device_type()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        with _dry_run_dtensor(device_type):
            yield device_type
    finally:
        shutdown()

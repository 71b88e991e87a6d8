"""Sharding rule engine: parameter / batch / cache / optimizer-state
partition specs for the production meshes, as metadata.

The port's counterpart of `src/repro/distributed/sharding.py`, rule for
rule.  The spec rules read only a mesh's `.shape` and `.axis_names`, so
they run on the port's `Mesh` (whose devices may repeat) without a
device.  `placements`, `named` and `shard_tree` place tensors by the
specs as DTensors over the mesh's `DeviceMesh`, one process a shard
(`distributed.runtime`): a spec's axis on tensor dim i is `Shard(i)` on
that mesh dimension, every other mesh dimension `Replicate()`.

Strategy:
  * batch dims shard over ("pod", "data")   [data parallel]
  * TP over "model": attention head projections (when head counts divide
    the axis), MLP d_ff, vocab logits
  * MoE: expert axis over "model" (EP) when n_experts divides it, else
    d_ff inside experts (TP) — cfg.moe_shard
  * FSDP (cfg.fsdp): weights additionally shard over "data" on the
    non-TP matrix dim; optimizer state follows
  * decode KV caches shard the *sequence* dim over "model" (GQA kv-head
    counts of 1/2/8 cannot divide a 16-way axis; sequence always can)
  * SSM block weights stay DP/FSDP-only (d_inner sharding would split
    the B/C state projections across shards); the decode state shards
    over heads instead.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as tf


class PartitionSpec(tuple):
    """One mesh axis name (or a tuple of names, or None) per tensor
    dimension: JAX's `PartitionSpec`, a tuple with tuple equality, so
    ``P(None, "model") != P(None, "model", None)`` as under jax 0.9
    (`normalized` drops trailing Nones where a caller wants them equal).
    As JAX's, it stores a list of names as a tuple and a one-name tuple
    as the name: ``P(("data",), None) == P("data", None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_part(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _part(part):
    if isinstance(part, (list, tuple)):
        part = tuple(part)
        return part[0] if len(part) == 1 else part
    return part


def normalized(spec) -> tuple:
    """`spec` as a plain tuple without trailing Nones: the form two specs
    that shard every dimension alike share."""
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in _names(mesh))


def _shape(mesh) -> dict:
    """{axis name: size} of the port's `Mesh` or of a `DeviceMesh`."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return mesh.shape


def mesh_size(mesh, axes) -> int:
    return math.prod(_shape(mesh)[a] for a in axes) if axes else 1


def _model_size(mesh) -> int:
    return _shape(mesh).get("model", 1)


def param_specs(cfg: ModelConfig, mesh, *, max_positions: int = 0):
    """Spec tree matching `transformer.param_shapes(cfg)`."""
    shapes = tf.param_shapes(cfg, max_positions=max_positions)
    ms = _model_size(mesh)
    fsdp = "data" if (cfg.fsdp and "data" in _names(mesh)) else None
    q_ok = cfg.n_heads and cfg.n_heads % ms == 0
    kv_ok = cfg.n_kv_heads and cfg.n_kv_heads % ms == 0
    ep_ok = cfg.n_experts and cfg.n_experts % ms == 0 \
        and cfg.moe_shard in ("expert", "expert2d")

    def spec_for(path: str) -> P:
        stacked = path.startswith(("blocks/", "enc_blocks/", "dec_blocks/"))
        lead = (None,) if stacked else ()
        name = path.split("/")[-1]
        if name.startswith("x_"):
            name = name[2:]
        if name == "embed":
            return P(None, "model")
        if name == "lm_head":
            return P(fsdp, "model")
        if name in ("wq", "wo") and not q_ok:
            return P(*lead, fsdp, None) if name == "wq" \
                else P(*lead, None, fsdp)
        if name in ("wk", "wv") and not kv_ok:
            return P(*lead, fsdp, None)
        if name in ("wq", "wk", "wv"):
            return P(*lead, fsdp, "model")
        if name == "wo":
            return P(*lead, "model", fsdp)
        if name == "router":
            return P(*lead, fsdp, None)
        if name in ("w_gate", "w_in") and cfg.n_experts and stacked:
            if ep_ok and cfg.moe_shard == "expert2d":
                # EP on model x d_ff on data: weights fully sharded, no
                # FSDP all-gather; activations reshard instead
                return P(*lead, "model", None, "data")
            return (P(*lead, "model", fsdp, None) if ep_ok
                    else P(*lead, None, fsdp, "model"))
        if name == "w_out" and cfg.n_experts and stacked:
            if ep_ok and cfg.moe_shard == "expert2d":
                return P(*lead, "model", "data", None)
            return (P(*lead, "model", None, fsdp) if ep_ok
                    else P(*lead, None, "model", fsdp))
        if name in ("w_gate", "w_in"):
            return P(*lead, fsdp, "model")
        if name == "w_out":
            return P(*lead, "model", fsdp)
        if name == "b_in":
            return P(*lead, "model")
        if name == "in_proj":                    # ssm: DP/FSDP only
            return P(*lead, fsdp, None)
        if name == "out_proj":
            return P(*lead, None, fsdp)
        return P()                               # norms, biases, A_log, ...

    def fit(spec: P, shape: tuple) -> P:
        """Drop sharding on dims the axis sizes don't divide evenly."""
        out = []
        for i, ax in enumerate(spec):
            if ax is None or i >= len(shape):
                out.append(None if i >= len(shape) else ax)
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            out.append(ax if shape[i] % mesh_size(mesh, axes) == 0
                       else None)
        return P(*out[:len(shape)])

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        return fit(spec_for(prefix[:-1]), tree)

    return walk(shapes)


def _batch_axis(shape: ShapeConfig, mesh):
    dp = dp_axes(mesh)
    ok = dp and shape.global_batch % max(mesh_size(mesh, dp), 1) == 0
    return dp if ok else None


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    bspec = _batch_axis(shape, mesh)
    out = {"tokens": P(bspec, None), "labels": P(bspec, None)}
    if cfg.frontend:
        out["frontend_embeds"] = P(bspec, None, None)
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Specs matching `transformer.init_cache`.  Sequence dims shard over
    "model" (flash-decode style); batch over the data axes."""
    bspec = _batch_axis(shape, mesh)
    ms = _model_size(mesh)
    seq_ok = "model" if ms > 1 else None
    specs: dict = {"pos": P()}
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        specs["k"] = P(None, bspec, seq_ok, None, None)
        specs["v"] = P(None, bspec, seq_ok, None, None)
    if cfg.family == "audio":
        specs["xk"] = P(None, bspec, seq_ok, None, None)
        specs["xv"] = P(None, bspec, seq_ok, None, None)
    if cfg.family in ("ssm", "hybrid"):
        dims = tf.ssm_dims(cfg)
        h_ok = "model" if dims["n_heads"] % ms == 0 else None
        specs["h"] = P(None, bspec, h_ok, None, None)
        specs["conv"] = P(None, bspec, None, None)
    if cfg.family == "hybrid":
        specs["ak"] = P(None, bspec, seq_ok, None, None)
        specs["av"] = P(None, bspec, seq_ok, None, None)
    return specs


def fit_specs(spec_tree, shape_tree, mesh):
    """Drop sharding on any dim the mesh axes don't divide evenly.
    `shape_tree` leaves: anything with a `.shape` (tensors, `meta`
    tensors), matching spec_tree."""
    def fit(spec, leaf):
        shape = leaf.shape
        out = []
        for i in range(len(shape)):
            ax = spec[i] if i < len(spec) else None
            if ax is None:
                out.append(None)
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            out.append(ax if shape[i] % mesh_size(mesh, axes) == 0 else None)
        return P(*out)

    if _is_spec(spec_tree):
        return fit(spec_tree, shape_tree)
    return {k: fit_specs(v, shape_tree[k], mesh)
            for k, v in spec_tree.items()}


def opt_state_specs(p_specs, kind: str):
    """Optimizer-state spec tree mirroring `repro_torch.training.optimizer`."""
    if kind in ("adamw", "sgd"):
        trees = {"m": p_specs} if kind == "sgd" else {"m": p_specs,
                                                      "v": p_specs}
        return {**trees, "count": P()}
    if kind == "adafactor":
        def vr(spec):
            return P(*spec[:-1]) if len(spec) >= 2 else spec

        def vc(spec):
            return P(*spec[:-2], spec[-1]) if len(spec) >= 2 else P()

        return {"vr": _map_specs(vr, p_specs), "vc": _map_specs(vc, p_specs),
                "count": P()}
    raise ValueError(kind)


# --------------------------------------------------------------------------
# Placing tensors: specs -> DTensor placements
# --------------------------------------------------------------------------
def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names if isinstance(mesh, DeviceMesh)
                 else mesh.axis_names)


def placements(spec, mesh) -> tuple[Placement, ...]:
    """The DTensor placements of `spec` on `mesh` (the port's `Mesh` or a
    `DeviceMesh` with dim names): one a mesh dimension, `Shard(i)` where
    the spec puts that axis on tensor dim i, else `Replicate()`.

    A tuple of axes on one dim, ``P(("pod", "data"))``, shards that dim
    over each of them with the first named the outer (slowest) split, as
    JAX does; DTensor splits in mesh-dimension order, so the tuple must
    name the axes in the mesh's order."""
    names = _names(mesh)
    out: list[Placement] = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{part} names mesh axes out of the mesh's "
                             f"order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {names[i]!r} shards two dims of "
                                 f"{spec}")
            out[i] = Shard(dim)
    return tuple(out)


class NamedSharding(NamedTuple):
    """JAX's `NamedSharding`: a `DeviceMesh` and the placements of one
    spec on it."""
    mesh: object
    placements: tuple


def _device_mesh(mesh) -> DeviceMesh:
    from repro_torch.distributed import runtime
    return mesh if isinstance(mesh, DeviceMesh) else \
        runtime.device_mesh(mesh)


def named(mesh, spec_tree):
    """The spec tree as `NamedSharding`s on `mesh`'s `DeviceMesh`."""
    dm = _device_mesh(mesh)
    return _map_specs(lambda s: NamedSharding(dm, placements(s, dm)),
                      spec_tree)


def place(leaf, mesh, spec, *, src_data_rank: int | None = 0) -> DTensor:
    """One leaf as a DTensor on `mesh` by `spec` (fitted to its shape).

    With ``src_data_rank=0`` rank 0's values are scattered (the other
    ranks' `leaf` gives only the shape and dtype); with None every rank
    holds the same values and keeps its own slice, with no collective
    (the slice may share memory with `leaf`).  A numpy leaf is copied to
    this rank's device first."""
    dm = _device_mesh(mesh)
    device = torch.device(dm.device_type, torch.cuda.current_device()) \
        if dm.device_type == "cuda" else torch.device(dm.device_type)
    if isinstance(leaf, DTensor):
        return leaf.redistribute(dm, placements(
            fit_specs(spec, leaf, dm), dm))
    if not torch.is_tensor(leaf):
        leaf = _from_numpy(np.asarray(leaf))
    leaf = leaf.to(device)
    return distribute_tensor(leaf, dm, placements(
        fit_specs(spec, leaf, dm), dm), src_data_rank=src_data_rank)


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def shard_tree(tree, mesh, spec_tree, *, src_data_rank: int | None = 0):
    """JAX's `shard_tree`: every leaf of `tree` (tensors or numpy arrays)
    placed by the matching spec, leaf by leaf: each leaf is scattered
    from rank 0 and dropped before the next, so no rank holds more than
    one whole leaf at a time beside its shards."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, mesh, spec_tree[k],
                              src_data_rank=src_data_rank)
                for k, v in tree.items()}
    return place(tree, mesh, spec_tree, src_data_rank=src_data_rank)

"""Carry a model, or a training run, across from the JAX package.

`ensemble_from_numpy` takes the JAX ensemble's fields as numpy arrays
(`{k: np.asarray(v)}` over `split_features`, `split_bins`, `leaf_values`,
`borders`, `n_borders` and optionally `base_score`);
`ensemble_from_jax_npz` reads the `.npz` its `ObliviousEnsemble.save`
writes.  Both give an `ObliviousEnsemble` on the CPU; `ensemble_to_numpy`
is their inverse.

`knn_featurizer_from_numpy` carries a JAX `KNNFeaturizer`'s state (its
reference embeddings and labels, as numpy) into the port's.

`train_state_from_jax` reads a JAX trainer's `TrainState.tree()`, or a
checkpoint it wrote, into the port's `TrainState`: both packages write the
same keys, dtypes and files.

`lm_params_from_numpy` carries an LM parameter tree (the JAX package's
`init_params` output as nested dicts of numpy arrays) into the port's
nested dict of tensors, key for key; `lm_params_to_numpy` is its inverse.
`lm_opt_state_from_numpy` / `lm_opt_state_to_numpy` do the same for an
optimizer state, so both packages can start from one state.  LM
checkpoints need no converter: both trainers write the same
`leaves.npz` keys and dtypes.

Sharded trees (DTensor leaves, one process a shard) convert leaf by leaf:
`lm_params_to_numpy` gathers each leaf (`full_tensor`, a collective every
rank calls) and copies it to the host before the next, and
`distributed.sharding.shard_tree(tree, mesh, specs)` places a numpy tree
on the mesh by its specs, so no rank holds more of the tree than one
whole leaf beside its shards.
"""
from __future__ import annotations

import pathlib
from typing import Mapping, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.knn import KNNFeaturizer
from repro_torch.core.trees import ObliviousEnsemble
from repro_torch.training.checkpoint import CheckpointManager, load_step
from repro_torch.training.gbdt import TrainState

FIELDS = ("split_features", "split_bins", "leaf_values", "borders",
          "n_borders", "base_score")


def ensemble_from_numpy(arrays: Mapping[str, np.ndarray]
                        ) -> ObliviousEnsemble:
    unknown = set(arrays) - set(FIELDS)
    if unknown:
        raise ValueError(f"unknown ensemble fields {sorted(unknown)}; "
                         f"expected {FIELDS}")
    return ObliviousEnsemble(**{k: torch.from_numpy(np.array(v))
                                for k, v in arrays.items()})


def ensemble_to_numpy(ensemble: ObliviousEnsemble) -> dict[str, np.ndarray]:
    """Every field as a numpy array, the dict `ensemble_from_numpy`
    takes (and the JAX `ObliviousEnsemble(**...)` takes after
    `jnp.asarray`)."""
    return {k: getattr(ensemble, k).detach().cpu().numpy() for k in FIELDS}


def ensemble_from_jax_npz(path: str | pathlib.Path) -> ObliviousEnsemble:
    return ObliviousEnsemble.load(path)


def knn_featurizer_from_numpy(train_embeddings: np.ndarray,
                              train_labels: np.ndarray, n_classes: int,
                              k: int = 16,
                              device: torch.device | str = "cuda"
                              ) -> KNNFeaturizer:
    """The port's featurizer over a JAX featurizer's reference set
    (`np.asarray(feat.train_embeddings)`, `np.asarray(feat.train_labels)`),
    on `device`."""
    return KNNFeaturizer(
        torch.from_numpy(np.array(train_embeddings, np.float32)),
        torch.from_numpy(np.array(train_labels, np.int32)),
        n_classes=n_classes, k=k, device=device)


def train_state_from_jax(source: Mapping[str, np.ndarray] | str
                         | pathlib.Path, step: Optional[int] = None
                         ) -> TrainState:
    """The port's `TrainState` from a JAX `TrainState.tree()` (numpy or
    JAX arrays), a checkpoint directory (its step `step`, else the
    latest) or one `step_N` directory of it."""
    if isinstance(source, Mapping):
        return TrainState.from_tree({k: np.asarray(v)
                                     for k, v in source.items()})
    path = pathlib.Path(source)
    if (path / "leaves.npz").exists():
        return TrainState.from_tree(load_step(path))
    if not path.is_dir():
        raise FileNotFoundError(f"no checkpoint directory at {path}")
    return TrainState.from_tree(CheckpointManager(path).restore(step))


def lm_params_from_numpy(tree: Mapping,
                         device: torch.device | str = "cpu") -> dict:
    """Nested dict of numpy arrays -> the same dict of tensors (copies) on
    `device`.  A bfloat16 array (the `ml_dtypes` type JAX hands numpy)
    keeps its bits."""
    if isinstance(tree, Mapping):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_to_numpy(params: Mapping) -> dict:
    """The port's parameter dict -> nested dict of numpy arrays (copies,
    which a later in-place step leaves alone), key for key; bfloat16
    tensors come back as float32 (exact: numpy has no bfloat16)."""
    if isinstance(params, Mapping):
        return {k: lm_params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, DTensor):
        params = params.full_tensor()
    t = params.detach()
    t = t.float() if t.dtype == torch.bfloat16 else t
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


def lm_opt_state_from_numpy(tree: Mapping,
                            device: torch.device | str = "cpu") -> dict:
    """A JAX optimizer state as numpy (`{"m", "v", "count"}` for AdamW,
    `{"vr", "vc", "count"}` for Adafactor, `{"m", "count"}` for SGD) ->
    the port's, key for key, on `device`: the moments f32 tensors and
    `count` an int32 0-d tensor, as `repro_torch.training.optimizer`
    keeps them."""
    return lm_params_from_numpy(tree, device)


def lm_opt_state_to_numpy(state: Mapping) -> dict:
    """The port's optimizer state -> nested dict of numpy arrays (the
    dtypes JAX's optimizer keeps: f32 moments, an int32 count)."""
    return lm_params_to_numpy(state)

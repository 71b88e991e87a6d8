"""Fault-tolerant checkpoints of a training run.

The port's counterpart of `src/repro/training/checkpoint.py`, with the
same on-disk format, so a checkpoint written by the JAX trainer loads
here and one written here loads there:

  * `step_N/leaves.npz` holds the flattened tree of numpy arrays (keys
    joined with "."), `step_N/manifest.json` the keys, shapes and dtypes;
  * a save writes `step_N.tmp/`, fsyncs the manifest and renames it to
    `step_N/` in one step, so a crash mid-save never corrupts the latest
    checkpoint;
  * the serialization and the rename run on a background thread (the copy
    to the host stays on the caller's), one save in flight at a time, and
    an error there is raised by the next `wait`;
  * `keep_last` prunes old steps; `latest` finds the step to resume from.

Sharded state (DTensor leaves, one process a shard) is saved in the same
format, one leaf at a time: every rank gathers the leaf (`full_tensor`,
a collective), rank 0 writes it as the next `.npy` entry of the npz and
drops it, so no host ever holds more than one leaf; then every rank waits
at a barrier.  Such a save blocks (its collectives would race the train
step's on a worker thread).  `restore_sharded` places a checkpoint onto
any mesh, leaf by leaf, reading each entry lazily on rank 0 and
scattering it.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
import zipfile
from typing import Any, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten(v, f"{prefix}{k}."))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _host(value) -> np.ndarray:
    """A host copy of a leaf.  A tensor is copied even on the CPU: the
    LM train step updates its tensors in place while the save's worker
    still writes the copy.  numpy has no bfloat16, so a bfloat16 tensor
    is refused rather than widened (its restore would change dtype)."""
    if hasattr(value, "detach"):        # a torch tensor, on any device
        if value.dtype == torch.bfloat16:
            raise TypeError(
                "a bfloat16 tensor cannot be checkpointed: numpy has no "
                "bfloat16; keep param_dtype float32 to checkpoint a run")
        return value.detach().to("cpu", copy=True).numpy()
    return np.asarray(value)


def _write_manifest(directory: pathlib.Path, step: int, meta: dict):
    manifest = {"step": step, "keys": sorted(meta),
                "shapes": {k: v[0] for k, v in meta.items()},
                "dtypes": {k: v[1] for k, v in meta.items()}}
    with open(directory / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())


def load_step(path: str | pathlib.Path) -> Any:
    """The tree of numpy arrays in one `step_N` directory."""
    with np.load(pathlib.Path(path) / "leaves.npz") as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, *, keep_last: int = 3,
                 async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save --------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        self.wait()                      # one in-flight save at a time
        flat = _flatten(tree)
        if any(isinstance(v, DTensor) for v in flat.values()):
            self._save_sharded(step, flat)
            return
        host = {k: _host(v) for k, v in flat.items()}

        def work():
            try:
                tmp, final = self._begin(step)
                np.savez(tmp / "leaves.npz", **host)
                _write_manifest(tmp, step, {
                    k: (list(v.shape), str(v.dtype))
                    for k, v in host.items()})
                self._commit(tmp, final)
            except BaseException as e:      # surfaced on next wait()
                self._error = e

        if self.async_save and not blocking:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_pending()

    def _begin(self, step: int):
        tmp = self.dir / f"step_{step:09d}.tmp"
        final = self.dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        return tmp, final

    def _commit(self, tmp: pathlib.Path, final: pathlib.Path):
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._prune()

    def _save_sharded(self, step: int, flat: dict) -> None:
        """Every rank calls it.  Each leaf is gathered by every rank in key
        order and written by rank 0 as the next `.npy` entry of the npz
        (as `np.savez` lays them out), then dropped; then a barrier.  An
        error on rank 0 stops its writing, not the gathers, so no rank is
        left waiting in a collective; it is raised after the barrier."""
        from repro_torch.distributed import runtime

        primary, error, meta, zf = runtime.is_primary(), None, {}, None
        if primary:
            try:
                tmp, final = self._begin(step)
                zf = zipfile.ZipFile(tmp / "leaves.npz", mode="w",
                                     compression=zipfile.ZIP_STORED,
                                     allowZip64=True)
            except BaseException as e:      # raised after the barrier
                error = e
        for key in sorted(flat):
            value = flat[key]
            if isinstance(value, DTensor):
                value = value.full_tensor()
            if zf is not None and error is None:
                try:
                    arr = _host(value)
                    with zf.open(key + ".npy", "w", force_zip64=True) as f:
                        np.lib.format.write_array(f, arr, allow_pickle=False)
                    meta[key] = (list(arr.shape), str(arr.dtype))
                    del arr
                except BaseException as e:
                    error = e
            del value
        if zf is not None:
            try:
                zf.close()
                if error is None:
                    _write_manifest(tmp, step, meta)
                    self._commit(tmp, final)
            except BaseException as e:
                error = error or e
        runtime.barrier()
        if error is not None:
            raise error

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _prune(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # -- load --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Any:
        if step is None:
            step = self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return load_step(self.dir / f"step_{step:09d}")

    def restore_sharded(self, mesh, spec_tree, step: Optional[int] = None
                        ) -> Any:
        """Elastic restore: the checkpoint placed onto `mesh` (any shape)
        by `spec_tree`, leaf by leaf.  Every rank calls it; rank 0 reads
        one npz entry at a time and scatters it.  A leaf with no spec
        (the step counter) comes back as the numpy array every rank
        reads."""
        from repro_torch.distributed import runtime
        from repro_torch.distributed import sharding as shd

        if step is None:
            step = self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:09d}"
        with open(path / "manifest.json") as f:
            manifest = json.load(f)
        specs = {k: v for k, v in _flatten(spec_tree).items()}
        out = {}
        primary = runtime.is_primary()
        with np.load(path / "leaves.npz") as z:
            for key in manifest["keys"]:
                spec = specs.get(key)
                if spec is None:
                    out[key] = z[key]
                    continue
                if primary:
                    leaf = torch.from_numpy(z[key])
                else:
                    leaf = torch.empty(manifest["shapes"][key],
                                       dtype=_TORCH[manifest["dtypes"][key]])
                out[key] = shd.place(leaf, mesh, spec, src_data_rank=0)
                del leaf
        return _unflatten(out)


_TORCH = {"float32": torch.float32, "int32": torch.int32,
          "int64": torch.int64, "float64": torch.float64,
          "float16": torch.float16}

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

`restore_sharded`, which places a checkpoint onto a mesh, comes with the
distributed LM slice (ROADMAP A11c).
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


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
        host = {k: _host(v) for k, v in _flatten(tree).items()}

        def work():
            try:
                tmp = self.dir / f"step_{step:09d}.tmp"
                final = self.dir / f"step_{step:09d}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir()
                np.savez(tmp / "leaves.npz", **host)
                manifest = {"step": step,
                            "keys": sorted(host.keys()),
                            "shapes": {k: list(v.shape)
                                       for k, v in host.items()},
                            "dtypes": {k: str(v.dtype)
                                       for k, v in host.items()}}
                with open(tmp / "manifest.json", "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                if final.exists():
                    shutil.rmtree(final)
                os.replace(tmp, final)
                self._prune()
            except BaseException as e:      # surfaced on next wait()
                self._error = e

        if self.async_save and not blocking:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_pending()

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

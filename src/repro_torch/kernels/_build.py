"""Build the port's CUDA kernels with nvcc and load them through ctypes.

`library()` compiles every `csrc/*.cu` for `sm_90a` at first use, one
`nvcc` process per source, all started together, links the objects into
one shared library with a plain C interface under
`build/repro_torch_kernels/` at the root of the checkout, and loads it.
The library's name carries a hash of the sources and flags, so an edited
source builds a new library and an unchanged one is loaded as it is.

Nothing here runs at import: the CPU tests import every module of the
port on a machine with no `nvcc`.  A failed build raises, and so does a
launch whose CUDA status is not 0 (`launch`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Any, Callable

import torch

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# -Xptxas -v prints each kernel's registers, shared memory and spills;
# the output is kept in `build_info["log"]`.
COMPILE_FLAGS = ARCH_FLAGS + ("-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v")

_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Every launcher ends with (device index, stream).
_SIGNATURES = {
    "repro_binarize": (_PTR, _PTR, _PTR, _LONG, _INT, _INT, _INT),
    "repro_leaf_index": (_PTR,) * 4 + (_LONG,) + (_INT,) * 8,
    "repro_leaf_gather": (_PTR,) * 3 + (_LONG,) + (_INT,) * 10,
    "repro_fused_predict": (_PTR,) * 7 + (_LONG,) + (_INT,) * 9,
    "repro_fused_predict_spread": (_PTR,) * 6 + (_LONG,) + (_INT,) * 10,
    "repro_leaf_index_dm": (_PTR,) * 5 + (_LONG,) + (_INT,) * 8,
    "repro_leaf_index_bp": (_PTR,) * 4 + (_LONG,) + (_INT,) * 9,
    "repro_fused_predict_dm": (_PTR,) * 8 + (_LONG,) + (_INT,) * 9,
    "repro_fused_predict_dm_spread": (_PTR,) * 7 + (_LONG,) + (_INT,) * 10,
    "repro_fused_predict_bp": (_PTR,) * 7 + (_LONG,) + (_INT,) * 10,
    "repro_fused_predict_bp_spread": (_PTR,) * 6 + (_LONG,) + (_INT,) * 11,
    "repro_histogram": (_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _LONG, _INT,
                        _INT, _INT, _INT, _INT, _INT, _INT, _INT),
    "repro_l2sq_rowwise": (_PTR, _PTR, _PTR, _LONG) + (_INT,) * 5,
    "repro_l2sq_split": (_PTR,) * 6 + (_INT,) * 4,
    "repro_l2sq_matrix": (_PTR,) * 5 + (_INT,) * 5,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Filled by the build: seconds, library path and the compiler's output.
build_info: dict[str, Any] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = pathlib.Path(home, "bin", "nvcc")
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda; "
            "the port's CUDA kernels are built from source at first use")
    return str(path)


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(COMPILE_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(target: pathlib.Path) -> None:
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = pathlib.Path(tmp, src.stem + ".o")
            proc = subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, obj, proc))
        logs, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        staged = pathlib.Path(tmp, target.name)
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged),
             *(str(obj) for _, obj, _ in jobs)],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(staged, target)    # atomic: no reader sees half a file
    build_info.update(seconds=time.perf_counter() - t0, log="\n".join(logs))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"librepro_torch_kernels_{source_hash()}.so"
            if not target.exists():
                _compile(target)
            build_info["path"] = str(target)
            lib = ctypes.CDLL(str(target))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [*args, _INT, _PTR]
                fn.restype = _INT
            lib.repro_cuda_error_string.argtypes = [_INT]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_cuda_tensors(op: str, **tensors: tuple[torch.Tensor, torch.dtype]
                       ) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of its
    dtype, all on one device: what the kernels take."""
    devices = set()
    for name, (t, dtype) in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{op}: {name} is on {t.device}; the kernel "
                             "takes CUDA tensors")
        if t.dtype != dtype:
            raise ValueError(f"{op}: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"{op}: tensors on several devices {devices}")


def fixed_args(name: str, start: int, *values: int) -> tuple:
    """`values` as the ctypes types of launcher `name`'s arguments from
    `start` on: a caller that passes the same ints at every launch builds
    them once, where ctypes would convert each Python int at every call."""
    return tuple(c_type(v) for c_type, v in zip(_SIGNATURES[name][start:],
                                                 values, strict=True))


def _launch_failed(lib: ctypes.CDLL, name: str, status: int) -> None:
    text = lib.repro_cuda_error_string(status).decode()
    raise RuntimeError(f"{name} launch failed: CUDA error {status} "
                       f"({text})")


def bind(name: str, device: torch.device) -> Callable[..., None]:
    """Launcher `name` bound to `device` and its current stream, both
    looked up now: for a route that launches it many times in a row.
    Call the result with data pointers and ints; it raises on a non-zero
    CUDA status."""
    lib = library()
    fn = getattr(lib, name)
    index = device.index
    stream = torch.cuda.current_stream(device).cuda_stream
    current = torch.cuda.current_device()

    def call(*c_args: int) -> None:
        status = fn(*c_args, index, stream)
        # a launcher selects its device and leaves it selected
        if index != current:
            torch.cuda.set_device(current)
        if status:
            _launch_failed(lib, name, status)
    return call


def launch(name: str, device: torch.device, *args: Any) -> None:
    """Call launcher `name` on `device`'s current stream; tensors are
    passed as their data pointers.  The process's current device is the
    same after the call.  Raises on a non-zero CUDA status."""
    lib = library()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    current = torch.cuda.current_device()
    status = getattr(lib, name)(*c_args, device.index, stream)
    # a launcher selects its device and leaves it selected: a launch on a
    # mesh shard's card must not move later `device="cuda"` work there
    if device.index != current:
        torch.cuda.set_device(current)
    if status:
        _launch_failed(lib, name, status)

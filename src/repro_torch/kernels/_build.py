"""Build the port's CUDA kernels with nvcc and load them through ctypes.

`library()` compiles every `csrc/*.cu` for `sm_90a` at first use, one
`nvcc` process per source, all started together, links the objects into
one shared library with a plain C interface under
`build/repro_torch_kernels/` at the root of the checkout, and loads it.
The library's name carries a hash of the sources and flags, so an edited
source builds a new library and an unchanged one is loaded as it is.
Beside it lies the compiler's `-Xptxas -v` output (the same name, `.log`),
which a later process reads back into `build_info["log"]`.

Nothing here runs at import: the CPU tests import every module of the
port on a machine with no `nvcc`.  A failed build raises, and so does a
launch whose CUDA status is not 0 (`launch`).

`recording_launches()` is the contract checker's view of the launchers
(`repro_torch.analysis`): inside it, on the thread that entered it,
`check_cuda_tensors`, `bind` and `launch` append what they were asked to
do to a list (launcher, device, arguments; tensors as dtype, shape and
device) and launch nothing, and `library()` is never loaded.  Outside it
they behave as they always do: no kernel is replaced on any path.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Any, Callable, Optional

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
_FLOAT = ctypes.c_float
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
    "repro_split_level": (_PTR,) * 8 + (_LONG,) + (_INT,) * 14 + (_FLOAT,),
}
# The resource record (csrc/runtime.cu): its switch, and one launch's
# entry read back by index.
_RECORD_SIGNATURES = {
    "repro_resource_record": ((_INT,), _INT),
    "repro_resource_record_count": ((), _INT),
    "repro_resource_record_entry": ((_INT, _PTR), _INT),
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


def log_path(target: pathlib.Path) -> pathlib.Path:
    """Where the compiler's output of library `target` is kept."""
    return target.with_suffix(".log")


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
        staged_log = pathlib.Path(tmp, log_path(target).name)
        staged_log.write_text("\n".join(logs))
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged),
             *(str(obj) for _, obj, _ in jobs)],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        # atomic: no reader sees half a file; the log first, so a library
        # that exists has its log beside it
        os.replace(staged_log, log_path(target))
        os.replace(staged, target)
    build_info.update(seconds=time.perf_counter() - t0, log="\n".join(logs))


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"librepro_torch_kernels_{source_hash()}.so"
            if not target.exists():
                _compile(target)
            elif "log" not in build_info and log_path(target).exists():
                build_info["log"] = log_path(target).read_text()
            build_info["path"] = str(target)
            lib = ctypes.CDLL(str(target))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [*args, _INT, _PTR]
                fn.restype = _INT
            lib.repro_cuda_error_string.argtypes = [_INT]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            for name, (args, res) in _RECORD_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = res
            _lib = lib
        return _lib


@dataclasses.dataclass(frozen=True)
class TensorArg:
    """A tensor argument as a record keeps it."""
    dtype: torch.dtype
    shape: tuple[int, ...]
    device: torch.device

    def __str__(self) -> str:
        return (f"{str(self.dtype).removeprefix('torch.')}"
                f"[{','.join(str(d) for d in self.shape)}]@{self.device}")


@dataclasses.dataclass(frozen=True)
class LaunchRecord:
    """One call `recording_launches` saw: `kind` "check" (the tensors a
    wrapper checked, `args` (name, TensorArg) pairs), "bind" (a launcher
    bound, no arguments) or "launch" (a launcher called, `args` as passed:
    ints, None, TensorArg; a bound launcher's pointers are ints).
    `tensors` holds the tensor objects themselves, for callers that follow
    them through a trace."""
    kind: str
    name: str
    device: Optional[torch.device]
    args: tuple
    tensors: tuple = dataclasses.field(default=(), compare=False,
                                       repr=False)

    def tensor_args(self) -> list[tuple[int, TensorArg]]:
        """(position, TensorArg) of every tensor argument of a launch."""
        return [(i, a) for i, a in enumerate(self.args)
                if isinstance(a, TensorArg)]


_RECORDING = threading.local()


def _describe(a: Any) -> Any:
    if isinstance(a, torch.Tensor):
        return TensorArg(a.dtype, tuple(int(d) for d in a.shape), a.device)
    if isinstance(a, ctypes._SimpleCData):
        return a.value
    return a


def _record(kind: str, name: str, device, args: tuple,
            tensors: tuple = ()) -> bool:
    """Append a record when this thread is recording; True when the call
    must not go on to the library."""
    state = getattr(_RECORDING, "state", None)
    if state is None:
        return False
    records, sink, execute = state
    rec = LaunchRecord(kind, name, device, args, tensors)
    records.append(rec)
    if sink is not None:
        sink(rec)
    return not execute


@contextlib.contextmanager
def recording_launches(sink: Optional[Callable[[LaunchRecord], None]] = None,
                       *, execute: bool = False):
    """Record every `check_cuda_tensors`, `bind` and `launch` this thread
    makes inside the block into the list it yields (and pass each record
    to `sink` as it is made).  Launches are not made and `library()` is
    not loaded, unless `execute`: then each call is recorded and made as
    usual (what `chip_smoke.py` holds against a recorded walk)."""
    records: list[LaunchRecord] = []
    prev = getattr(_RECORDING, "state", None)
    _RECORDING.state = (records, sink, execute)
    try:
        yield records
    finally:
        _RECORDING.state = prev


def recording() -> bool:
    """Whether this thread is inside `recording_launches`."""
    return getattr(_RECORDING, "state", None) is not None


def check_cuda_tensors(op: str, **tensors: tuple[torch.Tensor, torch.dtype]
                       ) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of its
    dtype, all on one device: what the kernels take."""
    if recording():
        _record("check", op, None,
                tuple((name, _describe(t)) for name, (t, _) in
                      tensors.items()),
                tuple(t for t, _ in tensors.values()))
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
    if recording():
        skip = _record("bind", name, device, ())
        if skip:
            return lambda *c_args: _record(
                "launch", name, device,
                tuple(_describe(a) for a in c_args))
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

    if not recording():
        return call

    def recorded(*c_args: int) -> None:
        _record("launch", name, device, tuple(_describe(a) for a in c_args))
        call(*c_args)
    return recorded


def launch(name: str, device: torch.device, *args: Any) -> None:
    """Call launcher `name` on `device`'s current stream; tensors are
    passed as their data pointers.  The process's current device is the
    same after the call.  Raises on a non-zero CUDA status."""
    if recording() and _record(
            "launch", name, device, tuple(_describe(a) for a in args),
            tuple(a for a in args if isinstance(a, torch.Tensor))):
        return
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

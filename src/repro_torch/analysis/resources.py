"""Shared memory, registers and spills of the port's kernels.

Three sources, one per question:

  * what a launcher will request, from the ints a wrapper passes it
    (`requested_smem`): the dynamic bytes each `csrc/` launcher derives
    (a Python copy of its arithmetic) and the static bytes of the kernel
    it launches, from the source constants `kernels.tuning` mirrors;
  * what the `kernels.tuning` plan of that launch models (`model_smem`);
  * what the card reports (`read_record`): the library's resource record
    (csrc/runtime.cu), which, while it is on, notes each launch's
    `cudaFuncGetAttributes` (registers, static shared memory, local bytes,
    threads a block at most) and the dynamic bytes it requested; and the
    build's `-Xptxas -v` log (`ptxas_report`), kept beside the library.

The `smem-budget` and `smem-model` rules (`passes.smem_audit`) compare
them: on the CPU the request against the budget and the model, on the card
the record against both (`card_findings`).
"""
from __future__ import annotations

import ctypes
import re
from typing import Any, Optional

from repro_torch.kernels import tuning

# The launcher may never ask for more than its plan's model: a model that
# understates would let the planner pass the opt-in limit at a larger
# shape.  The model may overstate (bp's uint8 planes take a quarter of
# the int32 plane the model counts).
SMEM_SLACK = 1.0

# Static shared memory of each kernel, from its source: fused_planes.cuh's
# staged planes and level weights (2,048 int32 split features, 2,048
# thresholds of the plane's type, 16 int32 weights), the dm spread
# kernel's weights, the histogram's scales and row order, the rowwise
# kernel's per-warp sums (8 floats).
PLANE_WORDS = 2048
ROWWISE_STATIC_BYTES = 8 * 4


def _planes_static(threshold_bytes: int) -> int:
    return 4 * PLANE_WORDS + threshold_bytes * PLANE_WORDS + 4 * 16


# Each launcher, the kernels it launches (their `*_kernel` names) and the
# kernel's source (the ptxas log's sections).
LAUNCHER_KERNELS = {
    "repro_binarize": ("binarize.cu", ("binarize_kernel",)),
    "repro_leaf_index": ("leaf_index.cu", ("leaf_index_kernel",)),
    "repro_leaf_index_dm": ("leaf_index_dm.cu", ("leaf_index_kernel",)),
    "repro_leaf_index_bp": ("leaf_index_bp.cu", ("leaf_index_bp_kernel",)),
    "repro_leaf_gather": ("leaf_gather.cu", ("gather_staged_kernel",
                                             "gather_direct_kernel")),
    "repro_fused_predict": ("fused_predict.cu", ("fused_predict_kernel",)),
    "repro_fused_predict_spread": ("fused_predict.cu",
                                   ("fused_spread_kernel",)),
    "repro_fused_predict_dm": ("fused_predict_dm.cu",
                               ("fused_planes_kernel",)),
    "repro_fused_predict_dm_spread": ("fused_predict_dm.cu",
                                      ("fused_spread_kernel",)),
    "repro_fused_predict_bp": ("fused_predict_bp.cu",
                               ("fused_planes_kernel",)),
    "repro_fused_predict_bp_spread": ("fused_predict_bp.cu",
                                      ("fused_spread_kernel",)),
    "repro_histogram": ("histogram.cu", ("hist_absmax_kernel",
                                         "hist_accumulate_kernel",
                                         "hist_round_kernel")),
    "repro_l2sq_rowwise": ("l2sq_rowwise.cu", ("l2sq_rowwise_kernel",
                                               "l2sq_rowwise_scalar_kernel")),
    "repro_l2sq_split": ("l2sq_matrix.cu", ("l2sq_split_kernel",)),
    "repro_l2sq_matrix": ("l2sq_matrix.cu", ("l2sq_matrix_kernel",)),
    "repro_split_level": ("split_level.cu", ("split_terms_kernel",
                                             "split_choose_kernel",
                                             "split_refine_kernel")),
}


def _bb(u8: Any) -> int:
    return 1 if u8 else 4


def _a16(n: int) -> int:
    return -(-n // 16) * 16


def requested_smem(name: str, a: tuple) -> tuple[int, int]:
    """(dynamic, static) shared bytes a block of launcher `name`'s main
    kernel takes for the arguments `a` a wrapper passes (tensors first,
    as `_build.launch` takes them), as the launcher's source computes
    them."""
    if name == "repro_binarize":
        n, f, nb, _ = a[3:7]
        table = (4 * nb + 4) * f
        return (table if table <= tuning.SMEM_OPTIN_LIMIT else 0), 0
    if name in ("repro_leaf_index", "repro_leaf_index_dm"):
        k = 4 if name == "repro_leaf_index" else 5
        _, f, _, d, u8, rows, glob = a[k:k + 7]
        tile = 0 if glob else (f + 1) * (rows + tuning.INDEX_PITCH_PAD) \
            * _bb(u8)
        return d * tuning.INDEX_ROUND_TREES * tuning.INDEX_PAIR_BYTES \
            + tile, 0
    if name == "repro_leaf_index_bp":
        _, _, _, d, u8, _, stride, glob = a[4:12]
        tile = 0 if glob else tuning.BP_ROWS * stride * _bb(u8)
        return (tuning.BP_TRANSPOSE_BYTES
                + d * tuning.BP_ROUND_TREES * 8 + tile), 0
    if name == "repro_leaf_gather":
        _, _, n_leaves, _, slab, lanes, staged, threads, rpt, chunk = a[3:13]
        if not staged:
            return 0, 0
        rows = threads // lanes * rpt
        return (_a16(chunk * n_leaves * slab * 4)
                + rows * -(-chunk // 4) * 16), 0
    if name in ("repro_fused_predict", "repro_fused_predict_dm",
                "repro_fused_predict_bp"):
        k = {"repro_fused_predict": 6, "repro_fused_predict_dm": 7,
             "repro_fused_predict_bp": 6}[name]
        scratch, u8 = a[k], a[k + 7]
        stride, rows = a[k + 8:k + 10] if name != "repro_fused_predict_bp" \
            else a[k + 9:k + 11]
        dynamic = 0 if scratch is not None else rows * stride * _bb(u8)
        static = {"repro_fused_predict": 0,
                  "repro_fused_predict_dm": _planes_static(4),
                  "repro_fused_predict_bp": _planes_static(
                      1 if a[k + 8] else 4)}[name]
        return dynamic, static
    if name in ("repro_fused_predict_spread",
                "repro_fused_predict_dm_spread",
                "repro_fused_predict_bp_spread"):
        k = 7 if name == "repro_fused_predict_dm_spread" else 6
        _, f, _, _, d, _, u8 = a[k:k + 7]
        tail = a[k + 7:] if name != "repro_fused_predict_bp_spread" \
            else a[k + 8:]
        rows, _, chunk, slab = tail
        static = tuning.SPREAD_WEIGHT_BYTES \
            if name == "repro_fused_predict_dm_spread" else 0
        return tuning.spread_smem_bytes(rows, chunk, slab, d, f,
                                        _bb(u8)), static
    if name == "repro_histogram":
        s, _, seg_tile, fpb = a[10], a[11], a[12], a[13]
        return (tuning.HIST_CELL_BYTES * fpb * seg_tile * s,
                tuning.HIST_STATIC_BYTES)
    if name == "repro_l2sq_matrix":
        return a[9], 0
    if name == "repro_split_level":
        n_bins, ppb, staged = a[11], a[15], a[18]
        return tuning.split_terms_smem(ppb, n_bins, bool(staged)), 0
    if name == "repro_l2sq_rowwise":
        return 0, ROWWISE_STATIC_BYTES
    if name == "repro_l2sq_split":
        return 0, 0
    raise KeyError(f"no shared-memory model of launcher {name!r}")


def model_smem(name: str, a: tuple) -> Optional[int]:
    """Dynamic plus static shared bytes the launch's `kernels.tuning` plan
    models, or None for a launch no plan sizes (binarize sizes its border
    table itself; the rowwise and split kernels take none)."""
    if name in ("repro_leaf_index", "repro_leaf_index_dm"):
        k = 4 if name == "repro_leaf_index" else 5
        n, f, t, d, u8 = a[k:k + 5]
        return tuning.index_plan(n, t, d, f, _bb(u8)).tile.smem_bytes
    if name == "repro_leaf_index_bp":
        n, f, t, d, u8 = a[4:9]
        return tuning.bp_plan(n, t, d, f, _bb(u8)).tile.smem_bytes
    if name == "repro_leaf_gather":
        n, t, n_leaves, c = a[3:7]
        return tuning.gather_plan(n, t, n_leaves, c,
                                  staged=bool(a[9])).smem_bytes
    splits = {"repro_fused_predict": "rows",
              "repro_fused_predict_spread": "rows",
              "repro_fused_predict_dm": "planes",
              "repro_fused_predict_dm_spread": "planes",
              "repro_fused_predict_bp": "bitpacked",
              "repro_fused_predict_bp_spread": "bitpacked"}
    if name in splits:
        k = {"repro_fused_predict": 7, "repro_fused_predict_dm": 8,
             "repro_fused_predict_bp": 7}.get(name)
        if k is None:
            k = 7 if name == "repro_fused_predict_dm_spread" else 6
        n, f, nb, t, d, c = a[k:k + 6]
        route = "spread" if name.endswith("_spread") else "row"
        plan = tuning.fused_plan(n, t, d, c, f, nb <= 255, route,
                                 splits=splits[name])
        extra = tuning.SPREAD_WEIGHT_BYTES \
            if name == "repro_fused_predict_dm_spread" else 0
        return plan.smem_bytes + extra
    if name == "repro_histogram":
        n, f, n_bins, n_leaves, s = a[6:11]
        return tuning.hist_plan(f, n, n_leaves, n_bins, s).smem_bytes
    if name == "repro_l2sq_matrix":
        m, n, k_pad = a[5:8]
        return tuning.matrix_plan(m, n, k_pad).smem_bytes
    if name == "repro_split_level":
        n, f, n_leaves, n_bins, n_out = a[8:13]
        return tuning.split_plan(f, n_leaves, n_bins, n_out, n,
                                 a[19]).smem_bytes
    return None


# --------------------------------------------------------------------------
# The build's ptxas log
# --------------------------------------------------------------------------
def kernel_name(mangled: str) -> str | None:
    """The `*_kernel` identifier in a mangled name, whose identifiers
    each follow their length in digits."""
    i = 0
    while i < len(mangled):
        if not mangled[i].isdigit():
            i += 1
            continue
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        part = mangled[j:j + int(mangled[i:j])]
        if part.endswith("_kernel"):
            return part
        i = j + len(part)
    return None


TEMPLATE_ARGS = {"h": "uint8", "i": "int32"}
# csrc/fused_spread.cuh's `Splits` enumerators, by value.
SPLITS_NAMES = ("rows", "planes", "bitpacked")


def _literal(kind: str, value: str) -> str:
    """A template argument `L<kind><value>E` spelled out: a bool, an int,
    a `Splits` enumerator."""
    if kind == "b":
        return "true" if value == "1" else "false"
    if "Splits" in kind and value.isdigit() and \
            int(value) < len(SPLITS_NAMES):
        return SPLITS_NAMES[int(value)]
    return value.replace("n", "-", 1) if value.startswith("n") else value


def template_args(mangled: str, name: str) -> str:
    """`<...>` of the template arguments that follow `name` in a mangled
    name (bins type, ints, bools and enumerators spelled out), or "" for
    no template."""
    rest = mangled.split(name, 1)[1]
    if not rest.startswith("I"):
        return ""
    args, i = [], 1
    while i < len(rest) and rest[i] != "E":
        if rest[i] == "L":
            j = i + 1
            if rest[j] == "N":            # a nested name: N ... E
                j = rest.index("E", j) + 1
            elif rest[j] == "S":          # a substitution: S_ or S<n>_
                j = rest.index("_", j) + 1
            else:                         # a builtin type's one letter
                j += 1
            end = rest.index("E", j)
            args.append(_literal(rest[i + 1:j], rest[j:end]))
            i = end + 1
        else:
            args.append(TEMPLATE_ARGS.get(rest[i], rest[i]))
            i += 1
    return "<" + ", ".join(args) + ">"


def instance_name(mangled: str) -> str:
    """`name<args>` of a mangled kernel name (the mangled name itself
    when it holds no `*_kernel`)."""
    name = kernel_name(mangled)
    return name + template_args(mangled, name) if name else mangled


def ptxas_report(log: str, source: str, instances: bool = False
                 ) -> dict | None:
    """Registers, stack and spills of each kernel of `source` in a build's
    `-Xptxas -v` log (None when the log has no such section); with
    `instances`, one entry a template instantiation, named with its
    arguments."""
    if f"== {source}" not in log:
        return None
    section = log.split(f"== {source}", 1)[1].split("\n== ", 1)[0]
    report = {}
    for entry in section.split("Compiling entry function '")[1:]:
        mangled = entry.split("'")[0]
        name = kernel_name(mangled)
        regs = re.search(r"Used (\d+) registers", entry)
        spills = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                           r"stores, (\d+) bytes spill loads", entry)
        if name and instances:
            name += template_args(mangled, name)
        if name and regs and spills:
            report[name] = {
                "registers": int(regs.group(1)),
                "stack_bytes": int(spills.group(1)),
                "spill_stores": int(spills.group(2)),
                "spill_loads": int(spills.group(3))}
    return report


# --------------------------------------------------------------------------
# The card's resource record
# --------------------------------------------------------------------------
class ResourceEntry(ctypes.Structure):
    """csrc/runtime.cu's ResourceEntry, field for field."""
    _fields_ = [("name", ctypes.c_char * 240),
                ("registers", ctypes.c_int),
                ("static_bytes", ctypes.c_int),
                ("local_bytes", ctypes.c_int),
                ("max_threads", ctypes.c_int),
                ("dynamic_bytes", ctypes.c_longlong)]


def set_record(lib, on: bool) -> None:
    """Turn the library's resource record on (emptied) or off."""
    size = lib.repro_resource_record(int(on))
    if size != ctypes.sizeof(ResourceEntry):
        raise RuntimeError(f"resource record entries are {size} bytes; "
                           f"this reader takes "
                           f"{ctypes.sizeof(ResourceEntry)}")


def read_record(lib) -> list[dict[str, Any]]:
    """The record's entries in launch order: kernel (instance name),
    mangled name, registers, static / dynamic shared bytes, local bytes a
    thread, threads a block at most."""
    out = []
    entry = ResourceEntry()
    for i in range(lib.repro_resource_record_count()):
        if lib.repro_resource_record_entry(i, ctypes.byref(entry)):
            break
        mangled = entry.name.decode()
        out.append({"kernel": instance_name(mangled), "mangled": mangled,
                    "registers": entry.registers,
                    "static_bytes": entry.static_bytes,
                    "dynamic_bytes": entry.dynamic_bytes,
                    "local_bytes": entry.local_bytes,
                    "max_threads": entry.max_threads})
    return out


def resource_table(entries: list[dict], log: str = "") -> dict[str, dict]:
    """Per kernel instance: registers, static and the most dynamic shared
    memory it was launched with, local bytes, launches; with the ptxas
    log, its spill stores and loads."""
    table: dict[str, dict] = {}
    ptxas: dict[str, dict] = {}
    for source, _ in LAUNCHER_KERNELS.values():
        ptxas.update(ptxas_report(log, source, instances=True) or {})
    for e in entries:
        row = table.setdefault(e["kernel"], {
            "registers": e["registers"], "static_bytes": e["static_bytes"],
            "dynamic_bytes": 0, "local_bytes": e["local_bytes"],
            "max_threads": e["max_threads"], "launches": 0})
        row["dynamic_bytes"] = max(row["dynamic_bytes"], e["dynamic_bytes"])
        row["launches"] += 1
        spills = ptxas.get(e["kernel"])
        if spills is not None:
            row["spill_stores"] = spills["spill_stores"]
            row["spill_loads"] = spills["spill_loads"]
    return table


def attribute(records: list, entries: list[dict]
              ) -> list[tuple[Any, list[dict]]]:
    """Pair each launch record (`_build.LaunchRecord`, launch order) with
    the record entries its launcher made: consecutive entries whose
    kernel belongs to it."""
    pairs, i = [], 0
    for rec in records:
        kernels = LAUNCHER_KERNELS[rec.name][1]
        mine = []
        while i < len(entries) and kernel_name(
                entries[i]["mangled"]) in kernels:
            mine.append(entries[i])
            i += 1
        pairs.append((rec, mine))
    return pairs

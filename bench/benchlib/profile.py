"""The device's busy time and the host's idle gaps, from `torch.profiler`.

A traced run profiles its whole window (CPU and CUDA activity, no shapes,
no stacks).  Busy time is the union of the intervals in which a kernel,
copy or set ran on a card, averaged over the cards the run uses.  The
breakdown keeps the ten device operations with the most time and, of the
200 longest idle gaps of the first card, the host range that was open at
each gap's middle (the innermost one; "host" where none was), summed by
name.
"""
from __future__ import annotations

import collections

import numpy as np
import torch
from torch.autograd import DeviceType

N_GAPS = 200
TOP = 10


def start() -> torch.profiler.profile:
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _events(prof: torch.profiler.profile) -> list[tuple]:
    """(device type, device index, start us, end us, name, is a host
    range) of every event of a stopped profile, read from the profiler's
    raw results: building `prof.events()` walks every event in Python, some
    minutes for a training window's millions of launches."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() / 1e3
        out.append((ev.device_type(), ev.device_index(), start,
                    start + ev.duration_ns() / 1e3, ev.name(),
                    ev.is_user_annotation()))
    return out


def summarize(prof: torch.profiler.profile, n_devices: int) -> dict:
    """{"busy_s", "device_ops", "idle_gaps", "device_events"} of a stopped
    profile (times in seconds)."""
    device: dict[int, list] = collections.defaultdict(list)
    by_name: dict[str, float] = collections.defaultdict(float)
    host = []
    events = _events(prof)
    # a host range (`record_function`) also shows on the device's timeline;
    # it ran nothing there
    ranges = {name for *_, name, annotation in events if annotation}
    for kind, index, start, end, name, annotation in events:
        if kind == DeviceType.CUDA:
            if annotation or name in ranges:
                continue
            device[max(index, 0)].append((start, end))
            by_name[name] += (end - start) / 1e6
        elif kind == DeviceType.CPU:
            host.append((start, end, name))
    busy = {d: _union(iv) for d, iv in device.items()}
    busy_s = sum(sum(e - s for s, e in iv) for iv in busy.values()) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = []
    if busy:
        first = busy[min(busy)]
        gaps = sorted(((s1 - e0, e0, s1) for (_, e0), (s1, _)
                       in zip(first, first[1:])), reverse=True)[:N_GAPS]
    idle: dict[str, float] = collections.defaultdict(float)
    if gaps and host:
        h_start = np.array([h[0] for h in host])
        h_end = np.array([h[1] for h in host])
        names = [h[2] for h in host]
        for length, e0, s1 in gaps:
            mid = (e0 + s1) / 2
            open_ = np.flatnonzero((h_start <= mid) & (h_end >= mid))
            name = "host"
            if open_.size:
                inner = open_[np.argmin(h_end[open_] - h_start[open_])]
                name = names[inner]
            idle[name] += length / 1e6
    return {"busy_s": busy_s / max(n_devices, 1),
            "device_events": sum(len(v) for v in device.values()),
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:TOP]]}

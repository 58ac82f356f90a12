"""Reduce one profiled wave (``torch.profiler``, CPU and CUDA) to numbers,
in memory: device busy seconds, kernel seconds by name, launches, and the
idle gaps between device operations named by what the host was doing.

The wave is the span of the ``kvbench.wave`` annotation the harness puts
around it. Device time is the union of kernel, copy and memset intervals
inside that span. Every gap between device operations is labelled by the
innermost host operation (aten op or CUDA runtime call) of the wave's
thread running at its midpoint, or ``host python`` where none is.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

WAVE = "kvbench.wave"
# CUPTI's synchronisation records lie on the device's timeline but are
# waits, not work
DEVICE_WAITS = ("Event Sync", "Stream Sync", "Context Sync",
                "Stream Wait Event")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
            "cudaGraphLaunch")
TOP = 10
NAME_CHARS = 160


def _merge(iv: np.ndarray) -> np.ndarray:
    """Union of [start, end) rows, sorted and disjoint."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.int64)


def rows(events) -> List[Tuple[bool, str, int, int, int]]:
    """(on the device, name, start ns, duration ns, host thread) of each
    kineto event of the profiler (``prof.profiler.kineto_results
    .events()``)."""
    from torch.autograd import DeviceType
    out = []
    for e in events:
        if hasattr(e, "start_ns"):
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = int(e.start_us() * 1000), int(e.duration_us() * 1000)
        tid = e.start_thread_id() if hasattr(e, "start_thread_id") else 0
        out.append((e.device_type() != DeviceType.CPU, e.name(), s, d, tid))
    return out


def summarize(events, kernel_groups: Dict[str, Tuple[str, ...]]
              ) -> Dict:
    """``events``: ``rows`` of the profiled wave. ``kernel_groups`` maps a
    group name to substrings of kernel names; each group's device seconds
    are returned under ``groups``."""
    wave = [e for e in events if e[1] == WAVE and not e[0]]
    if not wave:
        raise RuntimeError(f"no {WAVE} span in the trace")
    t0 = wave[0][2]
    t1 = t0 + wave[0][3]
    thread = wave[0][4]
    dev, host = [], []
    by_name: Dict[str, float] = defaultdict(float)
    groups = {g: 0.0 for g in kernel_groups}
    launches = 0
    for on_dev, name, s, d, tid in events:
        if s + d < t0 or s > t1 or name == WAVE:
            continue
        if on_dev:
            if name.startswith(DEVICE_WAITS):
                continue
            dev.append((max(s, t0), min(s + d, t1)))
            by_name[name[:NAME_CHARS]] += d * 1e-9
            for g, keys in kernel_groups.items():
                if any(k in name for k in keys):
                    groups[g] += d * 1e-9
        else:
            if name in LAUNCHES:
                launches += 1
            if tid == thread:
                host.append((s, s + d, name))
    busy = _merge(np.asarray(dev, dtype=np.int64).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9 if len(busy) \
        else 0.0
    window_s = (t1 - t0) * 1e-9
    edges = np.concatenate([[t0], busy.ravel(), [t1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "launches": launches,
        "groups": groups,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": _label_gaps(gaps, host),
    }


def _innermost(host: List[tuple], points: np.ndarray) -> np.ndarray:
    """Index into ``host`` of the innermost operation running at each
    point, -1 where none is: a sweep over the operations' starts and
    ends that keeps the stack of open ones."""
    if not host:
        return np.full(len(points), -1)
    n = len(host)
    t = np.asarray([h[0] for h in host] + [h[1] for h in host],
                   dtype=np.int64)
    kind = np.repeat([1, 0], n)           # ends sort before starts
    order = np.lexsort((kind, t))
    stack: List[int] = []
    top = np.empty(2 * n, dtype=np.int64)
    for j, b in enumerate(order.tolist()):
        i = b % n
        if b < n:
            stack.append(i)
        elif stack and stack[-1] == i:
            stack.pop()
        elif i in stack:
            stack.remove(i)
        top[j] = stack[-1] if stack else -1
    at = np.searchsorted(t[order], points, side="right") - 1
    return np.where(at >= 0, top[np.maximum(at, 0)], -1)


def _label_gaps(gaps: np.ndarray, host: List[tuple]
                ) -> List[Tuple[str, float]]:
    """Idle seconds by the host operation under each gap's midpoint."""
    if not len(gaps):
        return []
    length = (gaps[:, 1] - gaps[:, 0]) * 1e-9
    inner = _innermost(host, (gaps[:, 0] + gaps[:, 1]) // 2)
    idle: Dict[str, float] = defaultdict(float)
    for i, sec in zip(inner.tolist(), length.tolist()):
        idle[host[i][2][:NAME_CHARS] if i >= 0 else "host python"] += sec
    return sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]

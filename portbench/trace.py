"""The traced part of a run: ``torch.profiler`` around whole solves, and the
reduction of its Chrome trace to device time by kernel, busy and idle time,
and the idle gaps by what the host was doing.

A frozen copy of the split that ``chip_smoke.loop_split`` / ``trace_split``
make: device events are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; the device is busy where any of them runs.  Here the
window is the profiled solves' own span (each solve is a
``record_function`` span named ``SOLVE_SPAN``), from the call with a host
``b`` to ``x`` back on the host, so the host's vector path between the
loops counts as idle device time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Tuple

import numpy as np

SOLVE_SPAN = "portbench.solve"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MIN_GAP_US = 1.0      # idle stretches shorter than this are not gaps
TOP = 10              # entries of each breakdown list

# kernels that PyTorch and the CUDA libraries launch (elementwise passes,
# reductions, cuBLAS dots); every other kernel is the program's own
LIBRARY_MARKS = ("at::", "cublas", "cub::", "cutlass", "cusparse", "gemv",
                 "gemm", "nvjet", "dot_kernel", "reduce_1Block_kernel")


ANON = "(anonymous namespace)::"


def short(name: str, width: int = 120) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    parameter list, cut to ``width``."""
    head = name.strip()
    if head.startswith("void "):
        head = head[5:]
    head = head.replace(ANON, "")
    depth, cut = 0, len(head)
    for i, ch in enumerate(head):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return head[:cut][:width]


def kernel_id(name: str) -> str:
    """A kernel's identifier: its name without namespaces, template
    arguments and parameters (``const_stencil_spmv_kernel``)."""
    return short(name, len(name)).split("<", 1)[0].split("::")[-1].strip()


def is_library(name: str) -> bool:
    return any(m in name.replace(ANON, "") for m in LIBRARY_MARKS)


@dataclasses.dataclass
class Summary:
    kernels: Dict[str, float]      # full kernel name -> device seconds
    launches: Dict[str, int]       # full kernel name -> launches
    busy_s: float                  # device busy (kernels and copies)
    window_s: float                # the profiled solves' span
    gaps: Dict[str, float]         # host op during each idle gap -> seconds

    def seconds(self, ids) -> float:
        """Device seconds of the kernels whose identifier is in ``ids``."""
        return sum(s for k, s in self.kernels.items() if kernel_id(k) in ids)

    def library_seconds(self) -> float:
        return sum(s for k, s in self.kernels.items() if is_library(k))

    def breakdown(self) -> dict:
        ops: Dict[str, float] = {}
        for k, s in self.kernels.items():
            ops[short(k)] = ops.get(short(k), 0.0) + s
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


@contextlib.contextmanager
def profiled(device_type: str):
    """Profile the block; yields a list that receives the Summary (None
    when the trace holds no profiled solve or no device work)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out: list = []
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            yield out
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        out.append(summarize(path))


def solve_span():
    import torch

    return torch.profiler.record_function(SOLVE_SPAN)


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for t0, t1 in sorted(spans):
        if merged and t0 <= merged[-1][1]:
            if t1 > merged[-1][1]:
                merged[-1] = (merged[-1][0], t1)
        else:
            merged.append((t0, t1))
    return merged


def summarize(path: str):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    solves = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == SOLVE_SPAN and "dur" in e]
    if not solves:
        return None
    w0 = min(e["ts"] for e in solves)
    w1 = max(e["ts"] + e["dur"] for e in solves)
    kernels: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    spans = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        t0, t1 = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t1 <= t0:
            continue
        spans.append((t0, t1))
        if e["cat"] == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + (t1 - t0) / 1e6
            launches[e["name"]] = launches.get(e["name"], 0) + 1
    if not spans:
        return None                 # no device: nothing to attribute
    busy = _merge(spans)
    idle, end = [], w0
    for t0, t1 in busy:
        if t0 - end >= MIN_GAP_US:
            idle.append((end, t0))
        end = max(end, t1)
    if w1 - end >= MIN_GAP_US:
        idle.append((end, w1))
    return Summary(kernels, launches,
                   busy_s=sum(t1 - t0 for t0, t1 in busy) / 1e6,
                   window_s=(w1 - w0) / 1e6,
                   gaps=_host_during(events, idle))


def _host_during(events, idle) -> Dict[str, float]:
    """Seconds of idle device time by the innermost host op running at each
    gap's middle (``host (between ops)`` where none is)."""
    ops = [e for e in events if e.get("cat") == "cpu_op" and "dur" in e]
    starts = np.array([e["ts"] for e in ops], dtype=np.float64)
    ends = starts + np.array([e["dur"] for e in ops], dtype=np.float64)
    out: Dict[str, float] = {}
    for t0, t1 in idle:
        mid = (t0 + t1) / 2
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = (ops[int(inside[np.argmin(ends[inside] - starts[inside])])]
                ["name"] if inside.size else "host (between ops)")
        out[name] = out.get(name, 0.0) + (t1 - t0) / 1e6
    return out

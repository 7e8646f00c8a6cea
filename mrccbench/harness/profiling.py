"""The traced window: ``torch.profiler`` over a few units, its Chrome trace
read back into device intervals and host operations.

``device`` intervals are the kernels, copies and memsets that ran on the
card; the window is the span of the ``mrccbench.window`` annotation, which
ends after a device synchronise.  From these: the device's busy seconds
(the union of its intervals inside the window), the device operations that
took most time, and the idle gaps, each named by the innermost host
operation that was running when the gap began.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "mrccbench.window"
TOP = 10
NAME_CHARS = 120  # of a templated kernel's name, in the breakdown


@contextlib.contextmanager
def traced():
    """Profile the body on the CPU and the card; yields a dict that holds
    the parsed trace (:func:`parse`) once the body has run."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    result = {}
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield result
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    result.update(parse(events))


def parse(trace) -> Dict:
    """``{"window": (t0, t1) us, "device": [(name, t0, t1)] clipped to the
    window, "host": [(name, t0, t1, tid)]}`` of a Chrome trace dict."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    win = None
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, t0 = e.get("cat", ""), float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        if cat == "user_annotation" and e["name"] == WINDOW:
            win = (t0, t1, e.get("tid"))
        if cat in DEVICE_CATS:
            device.append((e["name"], t0, t1))
        elif cat in HOST_CATS:
            host.append((e["name"], t0, t1, e.get("tid")))
    if win is None:
        raise RuntimeError("the trace has no window annotation")
    w0, w1, tid = win
    device = [(n, max(a, w0), min(b, w1)) for n, a, b in device
              if b > w0 and a < w1]
    host = [h for h in host if h[3] == tid and h[0] != WINDOW]
    return {"window": (w0, w1), "device": device, "host": host}


def _union(intervals: List[Tuple[float, float]]):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(parsed) -> float:
    return sum(b - a for a, b in _union([(a, b) for _, a, b
                                         in parsed["device"]])) * 1e-6


def window_seconds(parsed) -> float:
    w0, w1 = parsed["window"]
    return (w1 - w0) * 1e-6


def device_seconds(parsed, patterns) -> float:
    """Summed device time of the operations whose name holds any of
    ``patterns``."""
    return sum(b - a for n, a, b in parsed["device"]
               if any(p in n for p in patterns)) * 1e-6


def top_device_ops(parsed, top=TOP):
    by = defaultdict(float)
    for n, a, b in parsed["device"]:
        by[n[:NAME_CHARS]] += (b - a) * 1e-6
    return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:top]


def idle_gaps(parsed, top=TOP):
    """Idle seconds of the device inside the window, summed by the
    innermost host operation running when each gap began."""
    w0, w1 = parsed["window"]
    busy = _union([(a, b) for _, a, b in parsed["device"]])
    gaps, at = [], w0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if w1 > at:
        gaps.append((at, w1))
    # host operations of one thread nest: sweep them with a stack whose top
    # is the innermost one still open
    host = sorted(parsed["host"], key=lambda h: (h[1], -h[2]))
    by = defaultdict(float)
    stack, j = [], 0
    for g0, g1 in gaps:
        while j < len(host) and host[j][1] <= g0:
            while stack and stack[-1][2] <= host[j][1]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][2] <= g0:
            stack.pop()
        by[stack[-1][0] if stack else "host, no operation"] += (g1 - g0) * 1e-6
    return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:top]

"""What a ``torch.profiler`` trace of the window says: the device's busy
time (the union of kernel, copy and set intervals), each kernel's device
time, and the longest idle gaps with what the host was doing in each.

The harness marks each pass with ``record_function(PASS_SPAN)``; the
traced window runs from the first such span's start to the last one's
end."""

from __future__ import annotations

import json
import re
from collections import defaultdict

PASS_SPAN = "portbench.pass"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def short(name: str) -> str:
    """A kernel's name without its argument list."""
    return re.sub(r"^void\s+", "", name.split("(")[0]).strip()


def union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The window's device and host events of an exported Chrome trace."""

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("name") == PASS_SPAN and "dur" in e
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise ValueError("no pass span in the trace")
        self.t0 = min(s for s, _ in spans)
        self.t1 = max(e for _, e in spans)
        self.device = []          # (start, end, category, name)
        self.host = []            # (start, end, name)
        for e in events:
            if "dur" not in e or e.get("ph") != "X":
                continue
            s, end = e["ts"], e["ts"] + e["dur"]
            if end <= self.t0 or s >= self.t1:
                continue
            s, end = max(s, self.t0), min(end, self.t1)
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append((s, end, cat, e.get("name", "")))
            elif cat in HOST_CATS and e.get("name") != PASS_SPAN:
                self.host.append((s, end, e.get("name", "")))
        self.busy = union((s, e) for s, e, _, _ in self.device)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for s, e, cat, name in self.device
                   if cat == "kernel" and rx.search(name)) * 1e-6

    def device_ops(self, top: int = 10):
        """[[name, seconds]] of the device operations that took most time."""
        total = defaultdict(float)
        for s, e, cat, name in self.device:
            total[short(name) if cat == "kernel" else cat] += (e - s) * 1e-6
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """[[what the host was doing, seconds]] of the longest gaps with no
        device operation: the innermost host operation or span (the
        shells' stages are spans ``stage.<name>``) at the gap's middle."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        out = []
        for length, start in gaps:
            mid = start + length / 2
            inner = [(e - s, name) for s, e, name in self.host
                     if s <= mid <= e]
            what = min(inner)[1] if inner else "host: Python between ops"
            out.append([what, length * 1e-6])
        return out

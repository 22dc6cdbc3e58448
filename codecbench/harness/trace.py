"""The traced window: torch.profiler around whole calls, the codec's
probe boundaries as profiler ranges, and what the readers read from it.

Each call runs inside a range "codecbench.<phase>"; inside it the
probe closes and opens ranges "codecbench.span" at each boundary the
codec reports (after synchronising the card, so a span holds its own
host and device work), and the names are kept in order: the k-th span
range of the trace is the k-th name. Device operations (kernels, copies,
sets) are assigned to the call whose range holds their start.
"""

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import List, Tuple

import torch
from torch.autograd.profiler import record_function

from . import arith

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class SpanProbe:
    """The codec's `probe` for the traced window: synchronises, then
    closes the current span range and opens the next."""

    def __init__(self):
        self.names: List[Tuple[str, str]] = []  # (phase, boundary name)
        self._open = None
        self._phase = None

    def start(self, phase: str):
        self._phase = phase
        self._open = record_function("codecbench.span")
        self._open.__enter__()

    def __call__(self, name, tensor=None):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._open.__exit__(None, None, None)
        self.names.append((self._phase, name))
        self._open = record_function("codecbench.span")
        self._open.__enter__()

    def stop(self):
        self._open.__exit__(None, None, None)
        self.names.append((self._phase, "tail"))
        self._open = None


class Trace:
    """What the profiler saw of the traced window, by phase."""

    def __init__(self, events: list, span_names: List[Tuple[str, str]]):
        calls = defaultdict(list)
        spans = []
        self.device = []   # (name, t0, t1, cat), microseconds
        self.launches = []  # (name, t)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            t0 = float(e["ts"])
            t1 = t0 + float(e.get("dur", 0))
            if cat in DEVICE_CATS:
                self.device.append((name, t0, t1, cat))
            elif cat in ("cuda_runtime", "cuda_driver") and name in LAUNCH_CALLS:
                self.launches.append((name, t0))
            elif cat == "user_annotation" and name.startswith("codecbench."):
                if name == "codecbench.span":
                    spans.append((t0, t1))
                else:
                    calls[name.split(".", 1)[1]].append((t0, t1))
        self.calls = {p: sorted(v) for p, v in calls.items()}
        spans.sort()
        if len(spans) != len(span_names):
            raise RuntimeError(f"trace holds {len(spans)} probe spans, the "
                               f"probe recorded {len(span_names)}")
        # (phase, name, t0, t1)
        self.spans = [(p, n, a, b) for (p, n), (a, b) in zip(span_names, spans)]
        self.device.sort(key=lambda d: d[1])
        self._starts = [d[1] for d in self.device]

    def device_ops(self, phase: str):
        """(name, t0, t1, cat) of the device operations in `phase`'s calls,
        each clipped to its call."""
        out = []
        for a, b in self.calls.get(phase, []):
            i = bisect.bisect_left(self._starts, a)
            while i < len(self.device) and self.device[i][1] <= b:
                name, t0, t1, cat = self.device[i]
                out.append((name, t0, min(t1, b), cat))
                i += 1
        return out

    def wall_us(self, phase: str) -> float:
        return sum(b - a for a, b in self.calls.get(phase, []))

    def busy_us(self, phase: str) -> float:
        return arith.union_length((t0, t1) for _, t0, t1, _ in self.device_ops(phase))

    def launch_count(self, phase: str) -> int:
        return sum(1 for _, t in self.launches
                   if any(a <= t <= b for a, b in self.calls.get(phase, [])))

    def span_us(self, phase: str, names) -> float:
        return sum(b - a for p, n, a, b in self.spans if p == phase and n in names)

    def window(self) -> Tuple[float, float]:
        ranges = [r for v in self.calls.values() for r in v]
        return min(a for a, _ in ranges), max(b for _, b in ranges)

    def top_ops(self, k: int = 10) -> List[list]:
        lo, hi = self.window()
        by = defaultdict(float)
        for name, t0, t1, _ in self.device:
            if lo <= t0 <= hi:
                by[name] += (min(t1, hi) - t0) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The k longest stretches of the window with no device operation,
        each named by the phase and the probe span the host was in."""
        lo, hi = self.window()
        found = []
        for a, b in arith.gaps(((t0, t1) for _, t0, t1, _ in self.device), lo, hi):
            where = "between calls"
            for p, n, s0, s1 in self.spans:
                if s0 <= a < s1:
                    where = f"{p}:{n}"
                    break
            found.append([where, (b - a) / 1e6])
        return sorted(found, key=lambda g: -g[1])[:k]


def profile(fn, tmpdir=None):
    """Run fn() under torch.profiler (CPU and CUDA activity) and return
    (fn's result, the trace's events). The Chrome trace is written under
    `tmpdir` (TMPDIR by default) and removed once read."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return result, events

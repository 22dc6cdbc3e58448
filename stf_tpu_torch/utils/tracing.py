"""Spans and counters inside the codec's calls, kept only while a torch
profiler records.

A call of `Codec.compress` or `Codec.decompress` (wrapped by `traced`) is
cut into top-level spans at the phase boundaries its probe reports
(`boundary`): each span is named by the boundary that closes it, as the
probe names it, and the span from the last boundary to the return is
"tail". Child spans (`span`) split a top-level span where it holds more
than one kind of work. Every span has a kind:

  * "host": the thread computes (stream assembly and packing, rANS,
    staging a buffer);
  * "wait": the thread is blocked on the device (a `.cpu()` fetch);
  * "launch": the thread launches a captured CUDA graph (tens of
    microseconds alone; a device tracer's own cost of a graph lands here);
  * "stage": a top-level span, or a decompress run inside a compress (the
    fused tier's self-check), which hold all of these.

A call's record (`Call`) keeps its spans (name, kind, parent, phase, start
and end on `time.perf_counter_ns`), the outcome of its fused path (one of
`OUTCOMES`, the most severe reported; None where the codec takes no fused
path), and on encode the lane stream's framing bytes, and the stream bytes
and images of its result. It also sums the FLOPs (2 M N K) of the port's
`Conv2d` calls by route: `conv_kernel_flops` those that launched the
3xTF32 kernel, `conv_library_flops` those that took `F.conv2d`; the
FLOPs (2 x input pixels x C_in x C_out x taps) of its `ConvTranspose2d`
calls likewise, `deconv_kernel_flops` and `deconv_library_flops`; and the
FLOPs (4 N B H W C, N tokens a window) of kernel B1's launches by design:
`b1_head_group_flops` the head group's, `b1_window_flops` one block a
(window, head). A CUDA graph's capture keeps the sums of the calls it
captured (`capturing`, always on, since a graph is captured once and
replayed in later calls), and each replay adds them to the record
(`replayed`). A decompress run inside a compress adds its spans to the
compress's record, under the span that holds it, and keeps no record of
its own.

Recording follows torch's profiler: a call records exactly when it starts
while `torch.autograd.profiler._is_profiler_enabled` is set, the flag the
profiler sets on start and clears on stop and that torch's own Python
checks before profiler-only work. Then every span also enters a profiler
range "stf_tpu_torch.<phase>.<span>" (on the profiler's clock, so each
idle stretch of the device trace lies inside a named span), and the
finished call goes into a ring of the last `RING` calls that `calls()`
reads. A top-level span's range is entered when the span opens, under the
boundary the call's path expects to close it; where a fallback closes it
with another boundary, the record keeps that boundary's name. Off, a call
costs one read of the flag, a boundary the probe's own test, a child span
one test; nothing is allocated, entered or kept.
"""

import collections
import contextlib
import functools
import itertools
import threading
import time

from torch.autograd import profiler as _profiler

RING = 1024
# the fused path's outcomes, least severe first: a graph replayed, run
# eagerly on CPU tensors, captured in this call; the tier skipped by its
# size guard, left after a segment overflowed B3's side channel, a
# decompress that left the fused walk on an index-hash mismatch, a tier
# dropped after its self-check failed
OUTCOMES = ("replay", "eager", "capture", "size_guard", "side_overflow",
            "hash_fallback", "demoted")
_RANK = {name: i for i, name in enumerate(OUTCOMES)}

_ring = collections.deque(maxlen=RING)
_ids = itertools.count()
_NULL = contextlib.nullcontext()


class _State(threading.local):
    call = None  # the innermost open Call of this thread
    capture = None  # the FlopSums of a CUDA-graph capture in progress


_state = _State()


class Span:
    """One span of a call: name, kind, the index of its parent span in the
    call's `spans` (None at the top level), phase, and start and end in
    `time.perf_counter_ns` nanoseconds. Its profiler range encloses it."""

    __slots__ = ("name", "kind", "parent", "phase", "t0", "t1", "_range")

    def __init__(self, name, kind, parent, phase):
        self.name, self.kind, self.parent, self.phase = name, kind, parent, phase
        self._range = _profiler.record_function(f"stf_tpu_torch.{phase}.{name}")
        self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        self.t1 = None

    def close(self):
        self.t1 = time.perf_counter_ns()
        self._range.__exit__(None, None, None)
        self._range = None


class Call:
    """The record of one codec call while recording, and the probe the
    codec's body gets in place of the caller's (`boundary` calls it)."""

    def __init__(self, phase, probe, first, outer=None):
        self.phase = phase
        self._probe = probe
        self._outer = outer
        root = self if outer is None else outer._root
        self._root = root
        if outer is None:
            self.id = next(_ids)
            self.spans = []
            self.outcome = None
            self.framing_bytes = 0
            self.y_bytes = self.z_bytes = self.images = 0
            self.conv_kernel_flops = self.conv_library_flops = 0
            self.deconv_kernel_flops = self.deconv_library_flops = 0
            self.b1_head_group_flops = self.b1_window_flops = 0
            self._stack = []  # indexes of the open spans, innermost last
        self._open(first, "stage")

    def _open(self, name, kind):
        root = self._root
        stack = root._stack
        root.spans.append(Span(name, kind, stack[-1] if stack else None,
                               self.phase))
        stack.append(len(root.spans) - 1)

    def _close(self, name=None):
        root = self._root
        span = root.spans[root._stack.pop()]
        span.close()
        if name is not None:
            span.name = name

    def boundary(self, name, tensor, then):
        self._close(name)
        try:
            if self._probe is not None:
                self._probe(name, tensor)
        finally:
            self._open(then, "stage")

    def set_outcome(self, name):
        if self.outcome is None or _RANK[name] > _RANK[self.outcome]:
            self.outcome = name

    def _end(self, out):
        """Closes the call's last span ("tail"); a top-level call keeps its
        result's sizes and goes into the ring."""
        self._close("tail")
        self._probe = None
        if self._outer is not None:
            return
        if isinstance(out, dict):
            self.images = int(out["symbols"][0].shape[0])
            if "strings" in out:
                self.y_bytes = sum(len(s) for s in out["strings"][0])
                self.z_bytes = sum(len(s) for s in out["strings"][1])
        _ring.append(self)


def traced(phase: str, first: str):
    """Wraps a codec method that takes `probe=`: while recording, the body
    gets a `Call` of `phase` as its probe, whose first span is expected to
    close at boundary `first`; otherwise the method runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def method(self, *args, probe=None, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(self, *args, probe=probe, **kwargs)
            outer = _state.call
            call = Call(phase, probe, first, outer)
            _state.call = call
            out = None
            try:
                out = fn(self, *args, probe=call, **kwargs)
                return out
            finally:
                _state.call = outer
                call._end(out)
        return method
    return wrap


def boundary(probe, name: str, tensor=None, then: str = "tail"):
    """A phase boundary of a codec call: `probe(name, tensor)`. While
    recording, `probe` is the call's `Call`: it closes the open top-level
    span under `name`, calls the caller's probe, if any, and opens the
    next span, expected to close at boundary `then`."""
    if probe is not None:
        if probe.__class__ is Call:
            probe.boundary(name, tensor, then)
        else:
            probe(name, tensor)


class _Child:
    __slots__ = ("call", "name", "kind")

    def __init__(self, call, name, kind):
        self.call, self.name, self.kind = call, name, kind

    def __enter__(self):
        self.call._open(self.name, self.kind)

    def __exit__(self, *exc):
        self.call._close()
        return False


def span(name: str, kind: str):
    """A context manager: a child span `name` of `kind` ("host", "wait",
    "launch" or "stage") inside the open span of the thread's open call;
    nothing where no call records."""
    call = _state.call
    return _NULL if call is None else _Child(call, name, kind)


def current():
    """The record of the thread's open top-level call while it records,
    else None (also inside a decompress that a compress runs)."""
    call = _state.call
    return call if call is not None and call._outer is None else None


def outcome(name: str):
    """Reports the fused path's outcome `name` to the open call's record."""
    call = current()
    if call is not None:
        call.set_outcome(name)


class FlopSums:
    """The FLOPs counted while a CUDA graph was captured: Conv2d's and
    ConvTranspose2d's by route and B1's by design (the names of a `Call`'s
    sums)."""

    __slots__ = ("conv_kernel_flops", "conv_library_flops",
                 "deconv_kernel_flops", "deconv_library_flops",
                 "b1_head_group_flops", "b1_window_flops")

    def __init__(self):
        self.conv_kernel_flops = self.conv_library_flops = 0
        self.deconv_kernel_flops = self.deconv_library_flops = 0
        self.b1_head_group_flops = self.b1_window_flops = 0


# the name the benchmark's tests construct a capture's sums by
ConvFlops = FlopSums


def flop_counter():
    """Where a Conv2d or ConvTranspose2d call's or a B1 launch's FLOPs go
    (`count_conv`, `count_deconv`, `count_b1`): the CUDA-graph capture in
    progress, else the record of
    the thread's open call while it records (a decompress inside a
    compress: the compress's), else None."""
    if _state.capture is not None:
        return _state.capture
    call = _state.call
    return None if call is None else call._root


# the name the benchmark's tests call it by
conv_counter = flop_counter


def count_conv(counter, kernel: bool, flops: int):
    """Adds one Conv2d call's FLOPs to `counter` (`flop_counter()`), under
    its route: the kernel, else the library."""
    if kernel:
        counter.conv_kernel_flops += flops
    else:
        counter.conv_library_flops += flops


def count_deconv(counter, kernel: bool, flops: int):
    """Adds one ConvTranspose2d call's FLOPs to `counter`
    (`flop_counter()`), under its route: the kernel, else the library."""
    if kernel:
        counter.deconv_kernel_flops += flops
    else:
        counter.deconv_library_flops += flops


def count_b1(counter, head_group: bool, flops: int):
    """Adds one B1 launch's FLOPs to `counter` (`flop_counter()`), under
    its design: the head group's, else one block a (window, head)."""
    if head_group:
        counter.b1_head_group_flops += flops
    else:
        counter.b1_window_flops += flops


@contextlib.contextmanager
def capturing(sums: FlopSums):
    """While a CUDA graph is captured: the captured Conv2d and
    ConvTranspose2d calls and B1 launches count into `sums`, in place of any open call's record (a
    capture computes nothing; each replay adds them, `replayed`)."""
    outer = _state.capture
    _state.capture = sums
    try:
        yield sums
    finally:
        _state.capture = outer


def replayed(sums):
    """Adds a captured graph's FLOPs (`capturing`'s `FlopSums`) to the
    record of the thread's open call, for one replay."""
    counter = flop_counter()
    if counter is not None:
        for name in FlopSums.__slots__:
            setattr(counter, name, getattr(counter, name) + getattr(sums, name))


def profiler_range(name: str):
    """A context manager: a profiler range `name` while a profiler records,
    nothing otherwise (ranges outside the codec's calls)."""
    return _profiler.record_function(name) if _profiler._is_profiler_enabled else _NULL


def calls():
    """The records of the last `RING` calls made while recording, oldest
    first."""
    return list(_ring)

"""Spans at the program's stage boundaries: where a frame's host time goes.

One tracer per process, `TRACER`; `span`, `stage`, `frame`, `spanned`,
`enable`, `disable` and `drain` below act on it. Spans are opened on the
frame loop's thread only, and nest.

- `span(name)`: off (the default), returns one shared null context: it
  records nothing, allocates nothing and adds no device operation or
  device->host read; the whole cost is a flag check.
- `stage(name)`: a span that is timed whether or not tracing is on, and
  adds its seconds to `TRACER.stage_s[name]`. The frame's `timings`
  columns are read from these (`PinSLAMSystem.process_frame`).
- `frame(frame_id)`: the root span of one frame. It clears `stage_s`, and
  every span opened inside it carries its frame id.

On (`enable()`), every span appends a `SpanRecord` (name, start and end on
`time.perf_counter_ns`, its id, its parent's id, its frame id) to
`TRACER.records`, which `drain()` hands over and clears: nothing is written
to disk. While a `torch.profiler` is recording, a span also opens a
`pin_slam.<name>` range, so that it lies in the same trace, on the same
clock, as the device work it launched. The range is a host range
(`_RecordFunctionFast`), not a user annotation like `record_function`'s:
the profiler gives each kernel to the innermost user annotation only, so
nested annotations would take the kernels from the benchmark's own
`slambench.*` ranges on the device's timeline.

Spans go at stage boundaries only, never per probe chunk, per kernel or per
point batch: some 80 in a steady frame of the default configuration.
"""

from __future__ import annotations

import functools
import time
from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

PREFIX = "pin_slam."
_NULL = nullcontext()


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int                 # -1: no enclosing span
    frame: Optional[int]        # None: opened outside any frame


class _Span:
    """One span; `seconds` holds its duration once it has closed. `stage`
    spans add their seconds to the tracer's `stage_s`; a root (`frame_id`
    given) clears it and sets the frame id."""

    __slots__ = ("_tr", "_name", "_stage", "_frame_id", "_on", "_id",
                 "_parent", "_range", "_t0", "seconds")

    def __init__(self, tracer: "Tracer", name: str, stage: bool,
                 frame_id: Optional[int] = None):
        self._tr = tracer
        self._name = name
        self._stage = stage
        self._frame_id = frame_id

    def __enter__(self):
        tr = self._tr
        if self._frame_id is not None:
            tr.stage_s.clear()
            tr.frame_id = self._frame_id
        self._on = tr.on
        self._range = None
        if self._on:
            self._id = tr._next_id
            tr._next_id += 1
            self._parent = tr._stack[-1] if tr._stack else -1
            tr._stack.append(self._id)
            if _autograd_profiler._is_profiler_enabled:
                self._range = _RecordFunctionFast(PREFIX + self._name)
                self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self._tr
        self.seconds = (t1 - self._t0) * 1e-9
        if self._stage:
            tr.stage_s[self._name] = (tr.stage_s.get(self._name, 0.0)
                                      + self.seconds)
        if self._on:
            if self._range is not None:
                self._range.__exit__(*exc)
            tr._stack.pop()
            tr.records.append(SpanRecord(self._name, self._t0, t1, self._id,
                                         self._parent, tr.frame_id))
        if self._frame_id is not None:
            tr.frame_id = None
        return False


class Tracer:
    def __init__(self):
        self.on = False
        self.records: List[SpanRecord] = []
        # seconds of each stage span since the current frame opened
        self.stage_s: Dict[str, float] = {}
        self.frame_id: Optional[int] = None
        self._stack: List[int] = []
        self._next_id = 0

    def span(self, name: str):
        if not self.on:
            return _NULL
        return _Span(self, name, False)

    def stage(self, name: str) -> _Span:
        return _Span(self, name, True)

    def frame(self, frame_id: int) -> _Span:
        return _Span(self, "frame", False, int(frame_id))

    def enable(self):
        self.on = True

    def disable(self):
        self.on = False

    def drain(self) -> List[SpanRecord]:
        out, self.records = self.records, []
        return out


TRACER = Tracer()
span = TRACER.span
stage = TRACER.stage
frame = TRACER.frame
enable = TRACER.enable
disable = TRACER.disable
drain = TRACER.drain


def spanned(name: str, is_stage: bool = False):
    """Decorator: each call runs inside `span(name)` (`stage(name)` with
    `is_stage`)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with (TRACER.stage(name) if is_stage else TRACER.span(name)):
                return fn(*args, **kwargs)
        return inner
    return wrap

"""Spans and counters of the port's host work, kept in memory.

The recorder is on exactly while a ``torch.profiler`` session is on, in every
thread of the process: it reads the flag that torch sets when a profiler
starts and clears when it stops (``torch.autograd.profiler.
_is_profiler_enabled``). So a profiled window records, and nothing else
does; there is no setting of its own. Off, :func:`span` hands back one
shared object that does nothing and :func:`count` returns at once.

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
        predictor.predict_case(case)
    spans, counts, dropped = trace.take()

A span is a :class:`Span`: its name, its start and end on ``time.time_ns``
(the clock of the profiler's device events), its thread as
``threading.get_ident()``, its id, its parent's id (the innermost span open
on the same thread, ``None`` for a root): a root is a case or a step, and
the spans under it are its parts. At most :data:`MAX_SPANS` spans are kept; the rest are
counted as dropped. ``docs/tracing.md`` lists the port's spans.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch.autograd.profiler as _profiler

# spans kept between two calls of take(), ~250 bytes each; a traced
# 30-s window of the benchmark records a few thousand
MAX_SPANS = 100_000


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: Optional[int]


def enabled() -> bool:
    """Whether a ``torch.profiler`` session is on (in any thread)."""
    return _profiler._is_profiler_enabled


class _Off:
    """The span handed out while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


OFF = _Off()


class Recorder:
    """A bounded list of finished spans and a table of counters, filled
    from any thread."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self.max_spans = max_spans
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self.dropped = 0
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def span(self, name: str):
        if not _profiler._is_profiler_enabled:
            return OFF
        return _Open(self, name)

    def count(self, name: str, n: int = 1) -> None:
        if not _profiler._is_profiler_enabled:
            return
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) < self.max_spans:
                self.spans.append(span)
            else:
                self.dropped += 1

    def take(self) -> Tuple[List[Span], Dict[str, int], int]:
        """``(spans, counts, dropped)`` recorded so far, spans in the order
        they ended; the recorder starts empty again."""
        with self._lock:
            out = (self.spans, self.counts, self.dropped)
            self.spans, self.counts, self.dropped = [], {}, 0
        return out


class _Open:
    """A span being recorded."""

    __slots__ = ("rec", "name", "id", "parent", "start")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        stack = self.rec._stack()
        self.id = next(self.rec._ids)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        self.rec._stack().pop()
        self.rec._add(Span(self.name, self.start, end, threading.get_ident(), self.id,
                           self.parent))


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
take = RECORDER.take

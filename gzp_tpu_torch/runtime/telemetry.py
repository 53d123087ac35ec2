"""Spans of the port's pipelines, recorded only while a torch profiler
records.

``with span("gzp.compress.fetch", batch):`` marks one step of one batch.
While no ``torch.profiler.profile`` records, :func:`span` reads one flag
(``torch.autograd.profiler._is_profiler_enabled``, the module global torch
sets while a profiler records) and returns one shared no-op context, so a
span site costs a function call and an attribute read. While a profiler
records, the span enters ``record_function("<name>#<batch>")``, so it lands
in the profiler's trace as a ``user_annotation`` on the clock of the
kernels and copies (the batch goes into the name because the chrome trace
drops ``record_function``'s argument), and adds its duration to an
in-memory table. A span with no ``batch`` takes its parent's: the spans of
one batch share its number. Writing the spans out is the profiler's job
(``export_chrome_trace``).

:func:`totals` gives, per span name, ``count``, ``total_s`` and ``self_s``
(the duration less the part covered by child spans on the same thread);
:func:`reset` clears them. Spans opened on pool threads reach the totals;
whether they reach the trace is up to the profiler. Counters kept beside
the spans (``parallel.compress.stored_stats``: blocks emitted and those
rewritten stored; ``parallel.compress.halo_stats``: rows dispatched with a
dictionary, their bytes and their dictionaries' bytes) count only while
:func:`recording`, so that they cover the same span of work.
"""

from __future__ import annotations

import contextlib
import threading
import time

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

OFF = contextlib.nullcontext()  # the one context a span site gets while no profiler records

_lock = threading.Lock()
_totals: dict[str, dict] = {}
_local = threading.local()  # .stack: this thread's open spans


def span(name: str, batch: int | None = None):
    """A context that records step ``name`` of ``batch`` while a profiler
    records, else :data:`OFF`."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Span(name, batch)


def recording() -> bool:
    """Whether a profiler records: the condition under which spans and the
    counters beside them record."""
    return _profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "batch", "parent", "child_ns", "t0", "_range")

    def __init__(self, name: str, batch: int | None):
        self.name, self.batch = name, batch

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        if self.batch is None and self.parent is not None:
            self.batch = self.parent.batch
        self.child_ns = 0
        self._range = record_function(f"{self.name}#{self.batch}")
        self._range.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _local.stack.pop()
        self._range.__exit__(*exc)
        ns = time.perf_counter_ns() - self.t0
        if self.parent is not None:
            self.parent.child_ns += ns
        with _lock:
            t = _totals.setdefault(self.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
            t["count"] += 1
            t["total_s"] += ns / 1e9
            t["self_s"] += (ns - self.child_ns) / 1e9
        return False


def totals() -> dict[str, dict]:
    """A copy of the table: span name -> ``count``, ``total_s``, ``self_s``."""
    with _lock:
        return {k: dict(v) for k, v in _totals.items()}


def reset() -> None:
    """Clear the table."""
    with _lock:
        _totals.clear()

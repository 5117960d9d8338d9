# -*- coding: utf-8 -*-
"""Spans: named ranges of the port's work, on the profiler's clock and in a
bounded log in memory.

``with span("drin.serve.prepare"): ...``

A span is on only while ``torch.profiler`` records: the benchmark's
``--trace 1``, the training CLI's ``profiling=true``
(:class:`~drin_tpu_torch.train.trainer.WindowedProfiler`), an operator's own
profiler.  There is no other switch.  Off, :func:`span` reads one flag and
returns a shared object that does nothing.  On, it enters a
``record_function`` range named ``name`` (the profiler's C++ one,
``_RecordFunctionFast``: the range ``torch.profiler.record_function`` makes, at
a tenth of its cost), which puts the range on the profiler's CPU timeline (and
CUPTI shows it on the device's row under the same name), and when it closes it
writes its name, start and end to the log.

The flag is the profiler's process-wide one (``torch._C._autograd.
_profiler_enabled()`` answers for the calling thread only).  Times are
``time.perf_counter_ns()``; a reader maps them onto the profiler's clock
through a range whose start it knows on both clocks (the benchmark's
``portbench.window``: ``portbench/spans.py``).

The log is a ring of flat arrays: a closed span leaves behind no object the
garbage collector tracks, since a log of tuples set off collections over the
whole heap inside the traced loop and slowed it.  :func:`spans` builds the
:class:`Span` tuples when a reader asks.
"""

from __future__ import annotations

import threading
import time
from array import array
from typing import NamedTuple

from torch._C._profiler import _RecordFunctionFast as _record_function
from torch.autograd import profiler as _profiler

LOG_SIZE = 65536


class Span(NamedTuple):
    """One closed span, its times in ``perf_counter`` nanoseconds."""

    name: str
    start_ns: int
    end_ns: int


_lock = threading.Lock()
_names: list = [None] * LOG_SIZE
_times = array("q", bytes(16 * LOG_SIZE))  # start_ns, end_ns
_written = 0  # spans closed since the last clear()


class _Off:
    """The span of a run the profiler does not record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _On:
    __slots__ = ("name", "start_ns", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = _record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _written
        end_ns = time.perf_counter_ns()
        self._range.__exit__(*exc)
        with _lock:
            i = _written % LOG_SIZE
            _written += 1
            _names[i] = self.name
            _times[2 * i], _times[2 * i + 1] = self.start_ns, end_ns
        return False


def span(name: str):
    """A context manager for one range of work named ``name`` (``drin.``...)."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _On(name)


def spans() -> list:
    """The closed spans in the log, in the order they closed (at most
    ``LOG_SIZE``, the newest)."""
    with _lock:
        return [Span(_names[i], _times[2 * i], _times[2 * i + 1])
                for i in (k % LOG_SIZE for k in range(max(0, _written - LOG_SIZE), _written))]


def clear() -> None:
    global _written
    with _lock:
        _written = 0
        _names[:] = [None] * LOG_SIZE

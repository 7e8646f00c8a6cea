"""Spans and counters of the program, the one tracing system of the port.

A span marks where the host does a piece of the program's work
(``mrcc.<name>``).  It is the profiler's own record of a range, entered
only while a profiler records: tracing is on exactly when a
``torch.profiler`` session is on, and off it costs one check of the
profiler's state.  The profiler keeps the spans with the kernels it traces,
on the same clock, and writes them out when its session ends, so each idle
gap of the card lines up with what the host was doing.

:class:`span` is a ``torch.profiler.record_function`` annotation, which the
profiler also copies onto the card's timeline.  :class:`launch_span`, around
each hand-written kernel launch, is the profiler's fast record function
instead: on an H100's host with a profiler on it costs about 4 us where an
annotation costs about 19 us, and a step launches about 190 kernels; it has
no copy on the card's timeline (its trace category is ``cpu_op``), where the
kernel's own name already stands.

A counter is a plain integer of one kind of event, kept in this module's
registry under a unique name: :class:`LaunchCounter` for a kernel wrapper's
launches, :class:`Counter` for the program's own events
(``train_batches``, each sparse train step's ``prepare``).  :func:`counts`
reads them all.

    with span("train.step"):        # or @span("train.step") on a function
        ...
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import record_function

PREFIX = "mrcc."

_recording = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_COUNTERS: Dict[str, "Counter"] = {}


class span:
    """Span ``mrcc.<name>`` around a block (``with span(name):``) or around
    every call of a function (``@span(name)``)."""

    __slots__ = ("name", "_cm")

    def __init__(self, name: str):
        self.name = PREFIX + name

    def _open(self):
        """The profiler's annotation while a profiler records, else the one
        shared null context."""
        return record_function(self.name) if _recording() else _NULL

    def __enter__(self):
        self._cm = self._open()
        return self._cm.__enter__()

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self._open():
                return fn(*args, **kwargs)

        return spanned


class launch_span(span):
    """Span ``mrcc.<name>`` around one kernel launch, on the profiler's fast
    record function."""

    __slots__ = ()

    def _open(self):
        return _RecordFunctionFast(self.name) if _recording() else _NULL


class Counter:
    """Plain integer count of one kind of the program's events, registered
    under ``name``; a second counter of the same name raises."""

    def __init__(self, name: str):
        if name in _COUNTERS:
            raise ValueError(f"a counter named {name!r} exists already")
        self.name = name
        self.count = 0
        _COUNTERS[name] = self


class LaunchCounter(Counter):
    """Count of one wrapper's kernel launches: the wrapper adds one to
    ``launches`` where it launches its kernel and nowhere else."""

    @property
    def launches(self) -> int:
        return self.count

    @launches.setter
    def launches(self, n: int):
        self.count = n


def counts(kind: type = Counter) -> Dict[str, int]:
    """``{name: count}`` of every registered counter of ``kind``."""
    return {name: c.count for name, c in _COUNTERS.items()
            if isinstance(c, kind)}

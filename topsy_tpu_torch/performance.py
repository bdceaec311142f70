"""Profiling and tracing hooks.

Counterpart of ``topsy_tpu/performance.py`` on ``torch.profiler``: the
same lightweight event API, and ``start_trace`` / ``stop_trace`` /
``trace(log_dir)``, which capture the host's and the card's activity of
what runs between them and write it as a Chrome trace
(``<log_dir>/trace.json``, open in ``chrome://tracing`` or Perfetto).

The port marks where its work happens with ``signposter.use_interval``
(or the ``traced`` decorator): the frame's render and presentation, the
kernel calls and the parts of set-up, named ``topsy.<span>``.  While
tracing is on (``set_tracing``; ``TOPSY_TPU_TRACE`` sets its starting
value, and a running ``start_trace`` holds it on) each interval

* opens a ``torch.profiler.record_function`` range, ``topsy.<span>#<n>``
  inside the n-th ``Visualizer.draw`` and ``topsy.<span>`` outside a draw,
  so that a trace ties each device operation, through its launch, to the
  innermost interval it was launched in;
* appends an ``Interval`` (name, draw, enclosing interval, start and end
  on ``time.perf_counter_ns``) to ``signposter.intervals``, kept in memory
  (at most ``MAX_INTERVALS``) until ``signposter.clear()``.

With tracing off an interval costs one attribute check.  ``counters``
(name -> count, always on) counts the kernels' launches and the particles
the renderers hand to the deposit.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import logging
import os
import time
import types
from typing import NamedTuple

import torch

logger = logging.getLogger(__name__)

DEFAULT_LOG_DIR = os.path.join("build", "topsy_tpu_torch_trace")

#: the most intervals ``signposter.intervals`` keeps; once it is full,
#: intervals open their ranges and record nothing until ``clear()``
MAX_INTERVALS = 1 << 18

#: always-on counts: ``k1_launches``, ``k2_launches``, ``k3_launches`` and
#: ``k3_plan_launches`` (CUDA launches, made only where a kernel is
#: launched) and ``particles_deposited`` (the particles of the blocks the
#: progression hands a renderer, summed on the host)
counters: collections.Counter = collections.Counter()


class Interval(NamedTuple):
    """A closed interval; ``frame`` is the draw it ran in (None outside a
    draw), ``parent`` the index in ``signposter.intervals`` of the
    interval it ran inside (-1 for none)."""
    name: str
    frame: int | None
    parent: int
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Off:
    """The interval of tracing off: nothing at all."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """One interval while tracing is on: its range and its record.  It
    keeps the list and stack it entered, so a ``clear()`` while it is open
    leaves the new record untouched."""
    __slots__ = ("_sp", "_name", "_frame", "_range", "_list", "_stack",
                 "_index", "_parent", "_start")

    def __init__(self, sp, name):
        self._sp = sp
        self._name = name

    def __enter__(self):
        sp = self._sp
        self._frame = frame = sp.frame
        self._range = torch.profiler.record_function(
            self._name if frame is None else f"{self._name}#{frame}")
        self._range.__enter__()
        self._list, self._stack = sp.intervals, sp._stack
        self._index = len(self._list)
        if self._index < MAX_INTERVALS:
            self._parent = self._stack[-1] if self._stack else -1
            self._list.append(None)
            self._stack.append(self._index)
        else:
            self._index = -1
        self._start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self._index >= 0:
            self._stack.pop()
            self._list[self._index] = Interval(
                self._name, self._frame, self._parent, self._start, end)
        self._range.__exit__(*exc)
        return False


class _Draw:
    """The scope of one draw: its sequence number is the frame of the
    intervals inside it."""
    __slots__ = ("_sp", "_outer")

    def __init__(self, sp):
        self._sp = sp

    def __enter__(self):
        sp = self._sp
        self._outer = sp.frame
        sp.draws += 1
        sp.frame = sp.draws
        return sp.frame

    def __exit__(self, *exc):
        self._sp.frame = self._outer
        return False


class _Signposter:
    """Event/interval emitter; the reference's signposter surface."""

    def __init__(self):
        self.tracing = os.environ.get("TOPSY_TPU_TRACE", "0") not in (
            "0", "", "false")
        #: draws begun so far, and the one in progress (None outside one)
        self.draws = 0
        self.frame: int | None = None
        #: the intervals recorded while tracing, in the order they opened
        #: (an open one is None until it closes)
        self.intervals: list[Interval | None] = []
        self._stack: list[int] = []

    def emit_event(self, name: str):
        if self.tracing:
            logger.debug("event: %s", name)

    def use_interval(self, name: str):
        """A context manager timing its block as the interval ``name``
        while tracing is on."""
        if not self.tracing:
            return _OFF
        return _Open(self, name)

    def draw(self):
        """A context manager numbering one draw (``Visualizer.draw``)."""
        return _Draw(self)

    def clear(self):
        """Forget every recorded interval."""
        self.intervals = []
        self._stack = []


signposter = _Signposter()


def traced(name: str):
    """Decorator: each call of the function is the interval ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not signposter.tracing:
                return fn(*args, **kw)
            with _Open(signposter, name):
                return fn(*args, **kw)
        return call
    return wrap


def set_tracing(on: bool) -> bool:
    """Turn tracing on or off; returns the previous setting."""
    was, signposter.tracing = signposter.tracing, bool(on)
    return was


# the trace in progress: (profiler, log_dir, tracing before it), or None
_running = None


def trace_file(log_dir: str = DEFAULT_LOG_DIR) -> str:
    return os.path.join(log_dir, "trace.json")


def start_trace(log_dir: str = DEFAULT_LOG_DIR):
    """Begin capturing the host's activity and, where a CUDA device is
    present, the card's kernels and copies; tracing is on until
    ``stop_trace``."""
    global _running
    from torch.profiler import ProfilerActivity, profile
    if _running is not None:
        raise RuntimeError("a trace is already running")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _running = (prof, log_dir, set_tracing(True))
    logger.info("Profiling to %s", trace_file(log_dir))


def stop_trace():
    """Stop the running trace (waiting for the card's queued work), write
    it and put tracing back as it was; returns the profiler, whose
    ``events()`` hold the trace."""
    global _running
    if _running is None:
        raise RuntimeError("no trace is running")
    (prof, log_dir, was), _running = _running, None
    set_tracing(was)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(trace_file(log_dir))
    return prof


@contextlib.contextmanager
def trace(log_dir: str = DEFAULT_LOG_DIR):
    """Trace the block; yields a namespace whose ``profiler`` is set once
    the block has ended and the trace is written."""
    result = types.SimpleNamespace(profiler=None)
    start_trace(log_dir)
    try:
        yield result
    finally:
        result.profiler = stop_trace()

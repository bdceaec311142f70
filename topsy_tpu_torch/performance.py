"""Profiling and tracing hooks.

Counterpart of ``topsy_tpu/performance.py`` on ``torch.profiler``: the
same lightweight event API, whose intervals become
``torch.profiler.record_function`` ranges (visible in a trace) when
``TOPSY_TPU_TRACE`` is set, and ``start_trace`` / ``stop_trace`` /
``trace(log_dir)``, which capture the host's and the card's activity of
what runs between them and write it as a Chrome trace
(``<log_dir>/trace.json``, open in ``chrome://tracing`` or Perfetto).
"""

from __future__ import annotations

import contextlib
import logging
import os
import types

logger = logging.getLogger(__name__)

_TRACE_ANNOTATIONS = os.environ.get("TOPSY_TPU_TRACE", "0") not in (
    "0", "", "false")

DEFAULT_LOG_DIR = os.path.join("build", "topsy_tpu_torch_trace")


class _Signposter:
    """Event/interval emitter; the reference's signposter surface."""

    def emit_event(self, name: str):
        if _TRACE_ANNOTATIONS:
            logger.debug("event: %s", name)

    @contextlib.contextmanager
    def use_interval(self, name: str):
        if _TRACE_ANNOTATIONS:
            from torch.profiler import record_function
            with record_function(name):
                yield
        else:
            yield


signposter = _Signposter()


# the trace in progress: (profiler, log_dir), or None
_running = None


def trace_file(log_dir: str = DEFAULT_LOG_DIR) -> str:
    return os.path.join(log_dir, "trace.json")


def start_trace(log_dir: str = DEFAULT_LOG_DIR):
    """Begin capturing the host's activity and, where a CUDA device is
    present, the card's kernels and copies."""
    global _running
    import torch
    from torch.profiler import ProfilerActivity, profile
    if _running is not None:
        raise RuntimeError("a trace is already running")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _running = (prof, log_dir)
    logger.info("Profiling to %s", trace_file(log_dir))


def stop_trace():
    """Stop the running trace (waiting for the card's queued work) and
    write it; returns the profiler, whose ``events()`` hold the trace."""
    global _running
    import torch
    if _running is None:
        raise RuntimeError("no trace is running")
    (prof, log_dir), _running = _running, None
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

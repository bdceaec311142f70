"""Device barriers and per-frame device timing.

Counterpart of ``topsy_tpu/util.py``.  On a CUDA device the barrier is
``torch.cuda.synchronize`` and block timing uses CUDA events, so the
accumulated figure is device time; on the CPU the barrier is a no-op and
blocks are timed on the host clock (PyTorch's CPU ops run synchronously).
``FrameClock`` times a barrier-free interactive frame from its first launch
to the end of its presentation readback.  ``is_inside_ipython`` and
``is_jupyter`` are copies of the original's.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def device_sync(x=None) -> None:
    """Barrier: return only after the queued work producing ``x`` (a
    tensor, a tuple of tensors, or None for the current CUDA device) has
    run.  No-op for CPU tensors."""
    if x is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    tensors = x if isinstance(x, (tuple, list)) else (x,)
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


class TimeDeviceOperation:
    """Context manager accumulating per-frame device-execution time.

    Enqueue work inside ``with timer:`` blocks.  On a CUDA device each block
    records a pair of CUDA events; ``sync()`` waits for the device and
    converts the recorded pairs into elapsed device seconds.  On the CPU
    each block is timed on the host clock."""

    def __init__(self, n_frames_smooth: int = 10, device="cpu"):
        self.n_frames_smooth = n_frames_smooth
        self._cuda = torch.device(device).type == "cuda"
        self._recent: list[float] = []
        self._pending: list = []
        self._current_frame_duration = 0.0
        self.last_duration = 0.0

    def __enter__(self):
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._block_start = time.perf_counter()
        return self

    def __exit__(self, *args):
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pending.append((self._start, end))
        else:
            self._current_frame_duration += (time.perf_counter()
                                             - self._block_start)

    def sync(self, x=None) -> None:
        """Wait for the device, then charge the recorded blocks' device
        time to the current frame."""
        device_sync(x)
        if self._cuda:
            torch.cuda.synchronize()
            for start, end in self._pending:
                self._current_frame_duration += start.elapsed_time(end) / 1e3
            self._pending.clear()

    def end_frame(self, record: bool = True):
        """Close the frame.  ``record=False`` (barrier-free EXPORT frames)
        discards the measurement instead of feeding the running mean."""
        if not record:
            self._pending.clear()
            self._current_frame_duration = 0.0
            return
        self.sync()
        self.last_duration = self._current_frame_duration
        self._current_frame_duration = 0.0
        self._recent.append(self.last_duration)
        if len(self._recent) > self.n_frames_smooth:
            self._recent.pop(0)

    def record_external(self, duration: float):
        """Record a frame duration measured outside this timer (a
        barrier-free interactive frame, timed by its ``FrameClock`` once the
        presentation readback has landed); feeds the same running mean as
        the frames this timer closes itself."""
        self.last_duration = max(0.0, duration)
        self._recent.append(self.last_duration)
        if len(self._recent) > self.n_frames_smooth:
            self._recent.pop(0)

    def total_time_in_frame(self) -> float:
        """Device time charged so far in this frame (blocks not yet
        synchronised are not included)."""
        return self._current_frame_duration

    @property
    def running_mean_duration(self) -> float:
        if not self._recent:
            return 0.0
        return float(np.mean(self._recent))


class FrameClock:
    """The span of one barrier-free interactive frame: ``start()`` before
    the frame's first launch, ``stop()`` after the presentation's readback
    has been enqueued.  On a CUDA device both are CUDA events on the
    current stream and ``stop()`` always waits for its event, so the
    readback's host buffer is ready, and ``seconds()`` is the device's
    span; on the CPU both read ``time.perf_counter``."""

    def __init__(self, device="cpu"):
        self._cuda = torch.device(device).type == "cuda"
        self._start = self._end = None

    def start(self):
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()
        self._end = None

    def stop(self):
        if self._cuda:
            self._end = torch.cuda.Event(enable_timing=True)
            self._end.record()
            self._end.synchronize()
        else:
            self._end = time.perf_counter()

    def seconds(self) -> float | None:
        """The last started frame's span, or None before ``stop()``."""
        if self._start is None or self._end is None:
            return None
        if self._cuda:
            return self._start.elapsed_time(self._end) / 1e3
        return self._end - self._start


def is_inside_ipython() -> bool:
    try:
        __IPYTHON__  # type: ignore[name-defined]  # noqa: B018
        return True
    except NameError:
        return False


def is_jupyter() -> bool:
    """True when running inside a Jupyter kernel."""
    try:
        from IPython import get_ipython
    except ImportError:
        return False
    ip = get_ipython()
    return ip is not None and ip.has_trait("kernel")

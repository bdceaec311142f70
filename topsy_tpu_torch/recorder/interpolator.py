"""Timestream samplers for movie replay.

A pinned copy of ``topsy_tpu/recorder/interpolator.py``.  A *timestream*
is a list of ``(time, value)`` events recorded live (see
``recorder.VisualizationRecorder``).  Replay samples each stream at the
frame clock, in four flavours: piecewise-linear, rotation (nearest
orthogonal matrix), change-only steps, and Gaussian-smoothed variants of
each.

Event times live in a sorted numpy array and every lookup is a
``searchsorted``; Gaussian smoothing is a stream->stream transform
(:func:`gaussian_smooth`) applied at construction, so the smoothed classes
are ordinary subclasses that rebuild their stream once.
"""

from __future__ import annotations

import numpy as np


def _nearest_rotation(m):
    """Project a near-rotation matrix onto the orthogonal group (via SVD)."""
    u, _, vh = np.linalg.svd(m)
    return u @ vh


def gaussian_smooth(sample, t_end, smoothing, fps):
    """Low-pass a sampler into a dense timestream.

    ``sample`` (callable t -> value) is evaluated on the uniform grid
    ``i / fps`` for ``i < floor(t_end * fps)``; each component is then
    convolved with a normalized Gaussian of standard deviation ``smoothing``
    seconds (support +-3 sigma, edges held constant).  Returns the smoothed
    ``(time, value)`` list on the same grid.
    """
    # streams for properties never touched while recording end at their
    # single t=0 event; clamp so the dense grid is never empty
    n = max(1, int(np.floor(t_end * fps)))
    dense = np.asarray([sample(i / fps) for i in range(n)], dtype=float)
    shape = dense.shape[1:]

    half = max(1, int(np.floor(3.0 * smoothing * fps)))
    taps = np.arange(-half, half + 1, dtype=float)
    kern = np.exp(-0.5 * (taps / (smoothing * fps)) ** 2)
    kern /= kern.sum()

    flat = dense.reshape(n, -1)
    held = np.concatenate([np.repeat(flat[:1], half, axis=0), flat,
                           np.repeat(flat[-1:], half, axis=0)])
    cols = [np.convolve(held[:, j], kern, mode="valid")
            for j in range(flat.shape[1])]
    smooth = np.stack(cols, axis=1).reshape((-1,) + shape)

    if shape == ():
        return [(i / fps, float(v)) for i, v in enumerate(smooth)]
    return [(i / fps, v) for i, v in enumerate(smooth)]


class Interpolator:
    """Base sampler over a timestream of ``(time, value)`` events.

    ``no_value`` is the sentinel returned when a sampler has nothing to
    report (past the end of the stream, or an unchanged step value).
    """

    no_value = object()

    def __init__(self, timestream):
        self._times = np.asarray([t for t, _ in timestream], dtype=float)
        self._values = [v for _, v in timestream]

    def __call__(self, t):
        raise NotImplementedError


class LinearInterpolator(Interpolator):
    """Piecewise-linear sampling; clamps before the first event and returns
    ``no_value`` after the last."""

    def __call__(self, t):
        times = self._times
        i = int(np.searchsorted(times, t, side="left"))
        if i == len(times):
            return self.no_value
        if i == 0:
            return self._values[0]
        v0 = np.asarray(self._values[i - 1], dtype=float)
        v1 = np.asarray(self._values[i], dtype=float)
        w = (t - times[i - 1]) / (times[i] - times[i - 1])
        out = v0 + (v1 - v0) * w
        return float(out) if out.ndim == 0 else out


class RotationInterpolator(LinearInterpolator):
    """Linear matrix interpolation projected back onto a rotation."""

    def __call__(self, t):
        m = super().__call__(t)
        if m is self.no_value:
            return m
        return _nearest_rotation(m)


class SmoothedLinearInterpolator(LinearInterpolator):
    """Linear sampling of the Gaussian-smoothed stream.

    Streams with fewer than two events are constant — smoothing is an
    identity there, so they pass through untouched (every recorded stream
    opens with one t=0 event; a property never changed afterwards must not
    crash the dense-grid machinery)."""

    def __init__(self, timestream, smoothing=0.25, fps=30):
        if len(timestream) > 1:
            timestream = gaussian_smooth(LinearInterpolator(timestream),
                                         timestream[-1][0], smoothing, fps)
        super().__init__(timestream)


class SmoothedRotationInterpolator(RotationInterpolator):
    """Smoothed matrix stream, re-orthogonalized at every sample."""

    def __init__(self, timestream, smoothing=0.25, fps=30):
        if len(timestream) > 1:
            timestream = gaussian_smooth(LinearInterpolator(timestream),
                                         timestream[-1][0], smoothing, fps)
        super().__init__(timestream)


class StepInterpolator(Interpolator):
    """Reports a value only when it changes.

    Stateful by nature (it must remember what it already reported), so the
    frame clock has to visit it in non-decreasing time order.
    """

    def __init__(self, timestream):
        super().__init__(timestream)
        self._clock = -np.inf
        self._reported = Interpolator.no_value

    def __call__(self, t):
        if t < self._clock:
            raise ValueError("StepInterpolator must be accessed sequentially")
        self._clock = t
        i = int(np.searchsorted(self._times, t, side="right")) - 1
        if i < 0:
            return self.no_value
        value = self._values[i]
        if self._reported is not self.no_value and value == self._reported:
            return self.no_value
        self._reported = value
        return value


class SmoothedStepInterpolator(StepInterpolator):
    """Step changes ramped linearly over ``smoothing`` seconds.

    For numeric streams only (vmin/vmax/gamma transitions).  While a ramp is
    live every sample returns the blend; a change detected mid-stream first
    re-reports the old value and opens a ramp to the new one.
    """

    def __init__(self, timestream, smoothing=0.25):
        super().__init__(timestream)
        self._smoothing = smoothing
        self._ramp = None  # (t_start, t_end, v_from, v_to)

    def __call__(self, t):
        if self._ramp is not None:
            t0, t1, v0, v1 = self._ramp
            if t < t1:
                return v0 + (v1 - v0) * (t - t0) / (t1 - t0)
            self._ramp = None
            return v1

        before = self._reported
        value = super().__call__(t)
        if value is self.no_value or value is None:
            return self.no_value
        if before is self.no_value or before is None:
            return value  # nothing to ramp from
        self._ramp = (t, t + self._smoothing, before, value)
        return before

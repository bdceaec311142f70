"""N-way property mirroring between visualizers.

A pinned copy of ``topsy_tpu/view_synchronizer.py``: any property path
(including dotted paths and ``name[key]`` item access) is mirrored between
registered views, with loop-prevention bookkeeping so an update reflected
to view B is not echoed back to view A.  Also powers the recorder (which
registers itself as a fake view whose setter records events).
"""

from __future__ import annotations

import weakref
from typing import Callable, Optional

from .drawreason import DrawReason


def _resolve_path_get(source, var):
    value = source
    for p in var.split("."):
        if "[" in p:
            attr, key = p.split("[")
            value = getattr(value, attr)[key.rstrip("]")]
        else:
            value = getattr(value, p)
    return value


def _resolve_path_set(target, var, value):
    path = var.split(".")
    for p in path[:-1]:
        target = getattr(target, p)
    last = path[-1]
    if "[" in last:
        attr, key = last.split("[")
        getattr(target, attr)[key.rstrip("]")] = value
    else:
        setattr(target, last, value)


class ViewSynchronizer:
    def __init__(self, synchronize=("rotation_matrix", "scale", "position_offset")):
        self._views: list[weakref.ReferenceType] = []
        self._requires_update: list[weakref.ReferenceType] = []
        self._synchronize = list(synchronize)
        self._setters: dict[int, Callable] = {}
        self._getters: dict[int, Callable] = {}

    def perpetuate_update(self, source):
        """Push source's state to all other views (loop-protected)."""
        pending = [ref() for ref in self._requires_update]
        if source in pending:
            # this call is itself the delivery of an update; don't echo it
            del self._requires_update[pending.index(source)]
            return

        getter = self._getters[id(source)]
        for view_ref in self._views:
            view = view_ref()
            if view is None or view is source or view_ref in self._requires_update:
                continue
            setter = self._setters[id(view)]
            self._requires_update.append(view_ref)
            for var in self._synchronize:
                setter(view, var, getter(source, var))

    def update_completed(self, view):
        """A view acknowledges it will not re-broadcast a received update."""
        pending = [ref() for ref in self._requires_update]
        if view in pending:
            del self._requires_update[pending.index(view)]

    def add_view(self, view, setter: Optional[Callable] = None,
                 getter: Optional[Callable] = None):
        self._views.append(weakref.ref(view))
        view._view_synchronizer = self
        self._setters[id(view)] = setter or _resolve_path_set
        self._getters[id(view)] = getter or _resolve_path_get

    def remove_view(self, view):
        self._views.remove(weakref.ref(view))
        del view._view_synchronizer
        del self._setters[id(view)]
        del self._getters[id(view)]


class SynchronizationMixin:
    """Visualizer mixin broadcasting state after relevant draws
    (reference: view_synchronizer.py:108-135)."""

    def draw(self, reason, target=None):
        result = super().draw(reason, target)
        if hasattr(self, "_view_synchronizer") and reason not in (
                DrawReason.REFINE, DrawReason.PRESENTATION_CHANGE):
            self._view_synchronizer.perpetuate_update(self)
        return result

    def synchronize_with(self, other):
        if hasattr(self, "_view_synchronizer") and hasattr(other, "_view_synchronizer"):
            raise RuntimeError("Both visualizers are already synchronizing")
        if hasattr(self, "_view_synchronizer"):
            self._view_synchronizer.add_view(other)
        elif hasattr(other, "_view_synchronizer"):
            other._view_synchronizer.add_view(self)
        else:
            vs = ViewSynchronizer()
            vs.add_view(self)
            vs.add_view(other)

    def stop_synchronizing(self):
        if hasattr(self, "_view_synchronizer"):
            self._view_synchronizer.remove_view(self)

    def is_synchronizing(self):
        return hasattr(self, "_view_synchronizer")

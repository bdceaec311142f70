"""Device-resident particle storage for the presorted EXPORT paths.

Counterpart of ``topsy_tpu/render/store.py`` (``ParticleStore`` with the
host presort).  The snapshot stays in host numpy until the presort is built
(``ops.morton.build_presorted``, once per snapshot); the transposed
presorted fields, channel values and the giant candidate pool then live on
``device`` (``convert.state_from_reference``), with flat (n_out, .) views
for the surface path.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .. import convert
from ..loaders import AbstractDataLoader
from ..ops import morton

logger = logging.getLogger(__name__)


class ParticleStore:
    """Owns the device particle state for one loader."""

    def __init__(self, data_loader: AbstractDataLoader, device="cuda"):
        self._loader = data_loader
        self.device = torch.device(device)
        self.n = len(data_loader)
        self._quantity_name: str | None = None
        self.values_version = 0
        self._mass = data_loader.get_mass().astype(np.float32)
        cell_ids = data_loader.get_cell_ids()
        if cell_ids is None:
            self.n_cells = 1
            self._cell_ids = None
        else:
            self.n_cells = int(cell_ids.max()) + 1 if len(cell_ids) else 1
            self._cell_ids = cell_ids.astype(np.int32)
        self._all_cells_mask = torch.ones(self.n_cells, dtype=torch.bool,
                                          device=self.device)
        self._layout = None
        self._state = None
        self._values = {}

    # -- channel buffers -------------------------------------------------------

    @property
    def quantity_name(self) -> str | None:
        return self._quantity_name

    @quantity_name.setter
    def quantity_name(self, name: str | None):
        if name == self._quantity_name:
            return
        self._quantity_name = name
        self.values_version += 1
        logger.info("Quantity channel now %r", name)

    def host_values_for(self, buffer_name: str) -> np.ndarray:
        """(n, C) host channel values: (mass, mass * quantity) for
        ``mass_and_quantity``, (mass, raw quantity) for ``surface_values``
        (the surface winner displays the quantity itself), the three band
        masses of ``loader.get_rgb_masses()`` for ``rgb``."""
        if buffer_name == "rgb":
            return self._loader.get_rgb_masses().astype(np.float32)
        if buffer_name not in ("mass_and_quantity", "surface_values"):
            raise KeyError(buffer_name)
        if self._quantity_name is None:
            q = np.zeros_like(self._mass)
        else:
            q = self._loader.get_named_quantity(
                self._quantity_name).astype(np.float32)
            if buffer_name == "mass_and_quantity":
                q = self._mass * q
        return np.stack([self._mass, q], axis=1)

    # -- presorted state --------------------------------------------------------

    def ensure_presorted(self):
        """Build the static (smoothing-bucket, Morton) layout on the host
        and move the presorted state to the device; once per snapshot."""
        if self._layout is not None:
            return
        ps = self._loader.get_pos_smooth().astype(np.float32)
        layout = morton.build_presorted(ps)
        state = convert.state_from_reference(
            layout, ps, self.host_values_for("mass_and_quantity"),
            self.device, cell_ids=self._cell_ids)
        self._layout = layout
        self._state = state
        self.n_presorted = layout.n_out
        self._values = {("mass_and_quantity", self.values_version):
                        (state["values_cm"], state["giant_values"])}
        logger.info("Built presorted (bucket, Morton) order: %d -> %d slots",
                    self.n, self.n_presorted)

    @property
    def presorted_layout(self):
        return self._layout

    def presorted_fields(self):
        """(x, y, z, h) as (n_groups, pad_group) device matrices."""
        self.ensure_presorted()
        return self._state["fields"]

    @property
    def pos_smooth_presorted(self) -> torch.Tensor:
        """(n_out, 4) presorted positions and smoothing, a transposed view of
        one stacked copy of the fields (built on first use)."""
        self.ensure_presorted()
        flat = self._state.get("pos_smooth_flat")
        if flat is None:
            flat = torch.stack([f.reshape(-1) for f in self._state["fields"]])
            self._state["pos_smooth_flat"] = flat
        return flat.t()

    def presorted_values_for(self, buffer_name: str) -> torch.Tensor:
        """(n_out, C) presorted channel values, a transposed view of the
        channel-major values."""
        vals = self.presorted_values_cm_for(buffer_name)
        return vals.reshape(vals.shape[0], -1).t()

    @property
    def presorted_buckets(self) -> torch.Tensor:
        """(n_out,) int32 smoothing bucket of every presorted slot."""
        self.ensure_presorted()
        return self._state["buckets"]

    @property
    def presorted_group_buckets(self) -> torch.Tensor:
        self.ensure_presorted()
        return self._state["group_buckets"]

    @property
    def cell_ids_presorted(self) -> torch.Tensor:
        self.ensure_presorted()
        return self._state["cell_ids_presorted"]

    def _values_pair(self, buffer_name: str):
        """(channel-major presorted values, giant pool values) of one
        buffer, converted and uploaded once per (buffer, values version):
        alternating buffers (an RGB view and its depth pick) stay cached,
        and a quantity switch drops the superseded versions."""
        self.ensure_presorted()
        key = (buffer_name, self.values_version)
        got = self._values.get(key)
        if got is None:
            got = convert.values_from_reference(
                self._layout, self.host_values_for(buffer_name),
                self.giant_meta()[0], self.device)
            self._values = {k: v for k, v in self._values.items()
                            if k[1] == self.values_version}
            self._values[key] = got
        return got

    def presorted_values_cm_for(self, buffer_name: str) -> torch.Tensor:
        """Channel-major presorted values (C, n_groups, pad_group)."""
        return self._values_pair(buffer_name)[0]

    # -- giant-splat candidate pool ----------------------------------------------

    def giant_meta(self):
        """Host candidate metadata (slots, slot buckets, bucket histogram)."""
        self.ensure_presorted()
        return self._state["giant_meta"]

    def giant_candidates(self, size: int) -> dict:
        """The last ``size`` pool candidates: dict(pos (size, 4), buckets
        (size,), cell_ids (size,)) on the device."""
        self.ensure_presorted()
        m = len(self._state["giant_meta"][0])
        s = self._state
        return dict(pos=s["giant_pos"][m - size:],
                    buckets=s["giant_buckets"][m - size:],
                    cell_ids=s["giant_cell_ids"][m - size:])

    def giant_values_for(self, buffer_name: str, size: int) -> torch.Tensor:
        """(size, C) candidate channel values."""
        vals = self._values_pair(buffer_name)[1]
        return vals[vals.shape[0] - size:]

    def cell_mask_table(self, selected_mask: np.ndarray | None):
        """Device bool table over cells (True = render)."""
        if selected_mask is None:
            return self._all_cells_mask
        return torch.as_tensor(np.asarray(selected_mask, dtype=bool),
                               device=self.device)

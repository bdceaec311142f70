"""Device-resident particle storage.

Counterpart of ``topsy_tpu/render/store.py``.  The positions and
smoothing, masses, quantities and cell ids live on ``device``: a device
loader's tensors (``loaders.AbstractDataLoader.device_arrays``) are
adopted in place, a host loader's arrays are uploaded once (a quantity when
it is selected, the RGB band masses when first read).  The presort is
built on the device (``ops.morton_device.build_presorted_device``); the
host presort (``ops.morton.build_presorted``) runs only where the device
build returns None.  Every presorted array is a device gather through the
layout (``convert``): the transposed fields, the channel-major values per
(buffer, values version), the cell ids, the flat copies of the surface
path and the giant candidate pool.  ``ensure_column_mips`` builds the
decimation-mip tiers of the interactive LOD over a device layout.  The
flat arrays of the per-frame-sorted block path (``flat_pos_smooth``,
``flat_values_for``, ``flat_cell_ids``: the snapshot's order, zero-padded
to ``n_pad`` rows, as the reference's store holds them) are device copies
built on first use, so the presorted paths never pay for them; the block
path renders pieces of ``bucket_size`` rows of them.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .. import config, convert
from ..loaders import AbstractDataLoader
from ..ops import morton, morton_device, splat_giant
from ..performance import signposter

logger = logging.getLogger(__name__)

PAD_MULTIPLE = 512
MIN_BUCKET = 4096
MAX_BUCKET = 1 << 22


def bucket_size(n: int, n_max: int) -> int:
    """Smallest power-of-two bucket >= n, in [MIN_BUCKET, min(n_max,
    MAX_BUCKET)]: the length of a block path's piece."""
    b = MIN_BUCKET
    while b < n and b < MAX_BUCKET:
        b *= 2
    return min(b, n_max, MAX_BUCKET)


class ParticleStore:
    """Owns the device particle state for one loader."""

    def __init__(self, data_loader: AbstractDataLoader, device="cuda"):
        self._loader = data_loader
        self.device = torch.device(device)
        self.n = len(data_loader)
        self.n_pad = max(MIN_BUCKET, -(-self.n // PAD_MULTIPLE)
                         * PAD_MULTIPLE)
        self._quantity_name: str | None = None
        self._quantity = None
        self.values_version = 0
        dev = data_loader.device_arrays()
        if dev is not None:
            # a device loader: adopt its tensors in place
            self.pos_smooth = self._adopt(dev["pos_smooth"])
            self._mass = self._adopt(dev["mass"])
            self._dev_quantities = {k: self._adopt(v) for k, v in
                                    dev.get("quantities", {}).items()}
        else:
            self.pos_smooth = self._put(data_loader.get_pos_smooth(),
                                        np.float32)
            self._mass = self._put(data_loader.get_mass(), np.float32)
            self._dev_quantities = None
        self._rgb = None
        cell_ids = data_loader.get_cell_ids()
        if cell_ids is None:
            self.n_cells = 1
            self.cell_ids = None
        else:
            self.n_cells = int(cell_ids.max()) + 1 if len(cell_ids) else 1
            self.cell_ids = self._put(cell_ids, np.int32)
        self._all_cells_mask = torch.ones(self.n_cells, dtype=torch.bool,
                                          device=self.device)
        self._layout = None
        self._main = None
        self._mip_tiers = None
        self._giant_meta = None
        self._giant_candidates = {}
        self._giant_values = {}
        self._flat = {}

    def _adopt(self, t: torch.Tensor) -> torch.Tensor:
        dev = self.device
        if t.device.type != dev.type or (dev.index is not None
                                         and t.device.index != dev.index):
            raise ValueError(f"the loader's device arrays live on {t.device}"
                             f", the store on {dev}")
        return t.to(torch.float32)

    def _put(self, arr: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(
            self.device)

    # -- channel buffers -------------------------------------------------------

    @property
    def quantity_name(self) -> str | None:
        return self._quantity_name

    @quantity_name.setter
    def quantity_name(self, name: str | None):
        """Select the quantity channel (on the device: adopted from a device
        loader, uploaded once from a host loader)."""
        if name == self._quantity_name:
            return
        if name is None:
            self._quantity = None
        elif self._dev_quantities is not None:
            self._quantity = self._dev_quantities[name]
        else:
            self._quantity = self._put(self._loader.get_named_quantity(name),
                                       np.float32)
        self._quantity_name = name
        self.values_version += 1
        logger.info("Quantity channel now %r", name)

    @property
    def rgb(self) -> torch.Tensor:
        """(n, 3) band masses of ``loader.get_rgb_masses()``, uploaded once."""
        if self._rgb is None:
            self._rgb = self._put(self._loader.get_rgb_masses(), np.float32)
        return self._rgb

    def values_for(self, buffer_name: str) -> torch.Tensor:
        """(n, C) device channel values: (mass, mass * quantity) for
        ``mass_and_quantity``, (mass, raw quantity) for ``surface_values``
        (the surface winner displays the quantity itself), the three band
        masses for ``rgb``."""
        if buffer_name == "rgb":
            return self.rgb
        if buffer_name not in ("mass_and_quantity", "surface_values"):
            raise KeyError(buffer_name)
        m = self._mass
        if self._quantity is None:
            q = torch.zeros_like(m)
        elif buffer_name == "mass_and_quantity":
            q = m * self._quantity
        else:
            q = self._quantity
        return torch.stack([m, q], dim=1)

    # -- flat arrays of the block path --------------------------------------------

    def _pad_rows(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` zero-padded to ``n_pad`` rows on the device."""
        pad = self.n_pad - t.shape[0]
        if pad == 0:
            return t.contiguous()
        return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])

    @property
    def flat_pos_smooth(self) -> torch.Tensor:
        """(n_pad, 4) positions and smoothing, zero rows past n."""
        got = self._flat.get("pos")
        if got is None:
            got = self._flat["pos"] = self._pad_rows(self.pos_smooth)
        return got

    def flat_values_for(self, buffer_name: str) -> torch.Tensor:
        """(n_pad, C) channel values of ``values_for``, zero rows past n,
        built once per (buffer, values version)."""
        key = (buffer_name, self.values_version)
        got = self._flat.get(key)
        if got is None:
            for k in [k for k in self._flat if isinstance(k, tuple)
                      and k[1] != self.values_version]:
                del self._flat[k]
            got = self._flat[key] = self._pad_rows(
                self.values_for(buffer_name))
        return got

    @property
    def surface_values(self) -> torch.Tensor:
        """(n_pad, 2) (mass, raw quantity) of the surface mode."""
        return self.flat_values_for("surface_values")

    @property
    def flat_cell_ids(self) -> torch.Tensor:
        """(n_pad,) int32 cell id per row (zeros without cells)."""
        got = self._flat.get("cells")
        if got is None:
            ids = (torch.zeros(self.n, dtype=torch.int32, device=self.device)
                   if self.cell_ids is None else self.cell_ids)
            got = self._flat["cells"] = self._pad_rows(ids)
        return got

    # -- presorted state --------------------------------------------------------

    def ensure_presorted(self):
        """Build the static (smoothing-bucket, Morton) layout once per
        snapshot: on the device, from the positions already there, or by
        the host presort where the device build returns None."""
        if self._layout is not None:
            return
        with signposter.use_interval("topsy.presort"):
            layout = morton_device.build_presorted_device(self.pos_smooth,
                                                          n_real=self.n)
            gather = layout
            if layout is None:
                logger.warning("Device presort unavailable: host presort "
                               "fallback")
                layout = morton.build_presorted(
                    self._loader.get_pos_smooth().astype(np.float32))
                gather = convert.device_layout_from_host(layout,
                                                         self.device)
            self._layout = layout
            self._main = PresortedMipTier(self, gather)
        self.n_presorted = layout.n_out
        logger.info("Built presorted (bucket, Morton) order: %d -> %d slots",
                    self.n, self.n_presorted)

    @property
    def main_tier(self) -> "PresortedMipTier":
        """The main layout's arrays: the last tier of the interactive LOD
        and the one EXPORT frames render."""
        self.ensure_presorted()
        return self._main

    @property
    def presorted_layout(self):
        """The main layout: a ``DevicePresortedLayout``, or the host
        ``PresortedLayout`` of the fallback."""
        return self._layout

    def presorted_fields(self):
        """(x, y, z, h) as (n_groups, pad_group) device matrices."""
        self.ensure_presorted()
        return self._main.fields()

    @property
    def pos_smooth_presorted(self) -> torch.Tensor:
        """(n_out, 4) presorted positions and smoothing, a transposed view of
        the fields' one (4, n_out) tensor."""
        self.ensure_presorted()
        return self._main.pos_smooth

    def presorted_values_cm_for(self, buffer_name: str) -> torch.Tensor:
        """Channel-major presorted values (C, n_groups, pad_group)."""
        self.ensure_presorted()
        return self._main.values_cm_for(buffer_name)

    def presorted_values_for(self, buffer_name: str) -> torch.Tensor:
        """(n_out, C) presorted channel values, a transposed view of the
        channel-major values."""
        self.ensure_presorted()
        return self._main.values_for(buffer_name)

    @property
    def presorted_buckets(self) -> torch.Tensor:
        """(n_out,) int32 smoothing bucket of every presorted slot."""
        self.ensure_presorted()
        return self._main.buckets

    @property
    def presorted_group_buckets(self) -> torch.Tensor:
        self.ensure_presorted()
        return self._main.group_buckets

    @property
    def cell_ids_presorted(self) -> torch.Tensor:
        self.ensure_presorted()
        return self._main.cell_ids

    # -- giant-splat candidate pool ----------------------------------------------

    def giant_meta(self):
        """Host candidate metadata (slots, slot buckets, bucket histogram)
        of the main layout, once per layout."""
        self.ensure_presorted()
        if self._giant_meta is None:
            self._giant_meta = splat_giant.candidate_slots(self._layout)
            self._giant_slots = self._put(self._giant_meta[0], np.int64)
        return self._giant_meta

    def giant_candidates(self, size: int) -> dict:
        """The last ``size`` pool candidates: dict(pos (size, 4), buckets
        (size,), cell_ids (size,)), device gathers cached per size (the
        power-of-two plan steps, ``splat_giant.plan_sizes``)."""
        cache = self._giant_candidates
        got = cache.get(size)
        if got is None:
            slots, buckets = self.giant_meta()[:2]
            sl = self._giant_slots[len(slots) - size:]
            got = cache[size] = dict(
                pos=convert.gather_presorted_rows(self._main.layout,
                                                  self.pos_smooth, sl),
                buckets=self._put(buckets[len(buckets) - size:], np.int32),
                cell_ids=self.cell_ids_presorted.index_select(0, sl))
        return got

    def giant_values_for(self, buffer_name: str, size: int) -> torch.Tensor:
        """(size, C) candidate channel values, cached per (buffer, size) of
        the current values version."""
        cache = self._giant_values
        key = (buffer_name, size, self.values_version)
        got = cache.get(key)
        if got is None:
            slots = self.giant_meta()[0]
            got = convert.gather_presorted_rows(
                self._main.layout, self.values_for(buffer_name),
                self._giant_slots[len(slots) - size:])
            for k in [k for k in cache if k[2] != self.values_version]:
                del cache[k]
            cache[key] = got
        return got

    # -- decimation-mip tiers for interactive LOD below the 1/8 floor ----------

    def ensure_column_mips(self) -> list["PresortedMipTier"]:
        """Lazily build the chain of decimation-mip tiers (deepest first).

        Each tier is a presorted layout over the particles in the first
        min_slice_width columns of its parent, a spatially fair 1/8
        subsample (``ops.morton_device.build_mip_layout``).  Tiers are
        chained until the smallest interactive column block drops below
        ``config.COLUMN_MIP_FLOOR_TARGET``; the host layout of the fallback
        has none."""
        if self._mip_tiers is not None:
            return self._mip_tiers
        self.ensure_presorted()
        tiers = []
        layout = self._layout
        if isinstance(layout, morton_device.DevicePresortedLayout):
            with signposter.use_interval("topsy.mips"):
                while len(tiers) < config.COLUMN_MIP_MAX_TIERS:
                    w = morton.min_slice_width(layout)
                    floor = int(layout.real_per_column[
                        :min(w, layout.pad_group)].sum())
                    if floor <= config.COLUMN_MIP_FLOOR_TARGET:
                        break
                    mip = morton_device.build_mip_layout(layout,
                                                         self.pos_smooth)
                    if mip is None:
                        break
                    tiers.insert(0, PresortedMipTier(self, mip))
                    logger.info("Built column-mip tier %d: %d real "
                                "particles", len(tiers),
                                int(mip.real_per_column.sum()))
                    layout = mip
        self._mip_tiers = tiers
        return tiers

    def cell_mask_table(self, selected_mask: np.ndarray | None):
        """Device bool table over cells (True = render)."""
        if selected_mask is None:
            return self._all_cells_mask
        return torch.as_tensor(np.asarray(selected_mask, dtype=bool),
                               device=self.device)


class PresortedMipTier:
    """The device arrays of one presorted gather layout, built lazily by
    device gathers over the store's arrays: a decimation tier's (its gidx
    composes to the ORIGINAL arrays), or the store's main layout's.  The
    fields (the feed kernel's layout) and the flat (n_out, .) views (the
    surface path) share one copy."""

    def __init__(self, store: ParticleStore,
                 layout: morton_device.DevicePresortedLayout):
        self._store = store
        self.layout = layout
        self.n_out = layout.n_out
        self._positions = None
        self._fields = None
        self._group_buckets = None
        self._cell_ids = None
        self._values = {}

    @property
    def buckets(self) -> torch.Tensor:
        return self.layout.buckets

    def fields(self):
        """(x, y, z, h) as (n_groups, pad_group) matrices: views of one
        (4, n_out) gather."""
        if self._fields is None:
            self._positions = convert.presorted_positions(
                self.layout, self._store.pos_smooth)
            G = self.layout.pad_group
            self._fields = tuple(f.reshape(self.n_out // G, G)
                                 for f in self._positions)
        return self._fields

    @property
    def pos_smooth(self) -> torch.Tensor:
        """(n_out, 4) presorted positions and smoothing (a view)."""
        self.fields()
        return self._positions.t()

    @property
    def group_buckets(self) -> torch.Tensor:
        """(n_groups,) smoothing bucket per group (constant within groups:
        runs are padded to pad_group multiples)."""
        if self._group_buckets is None:
            G = self.layout.pad_group
            self._group_buckets = self.buckets.reshape(
                self.n_out // G, G)[:, 0].contiguous()
        return self._group_buckets

    @property
    def cell_ids(self) -> torch.Tensor:
        if self._cell_ids is None:
            self._cell_ids = convert.presorted_cell_ids(self.layout,
                                                        self._store.cell_ids)
        return self._cell_ids

    def values_cm_for(self, buffer_name: str) -> torch.Tensor:
        """Channel-major values (C, n_groups, pad_group), gathered once per
        (buffer, values version): alternating buffers (an RGB view and its
        depth pick) stay cached, a quantity switch drops the superseded
        versions."""
        version = self._store.values_version
        key = (buffer_name, version)
        got = self._values.get(key)
        if got is None:
            got = convert.presorted_values_cm(
                self.layout, self._store.values_for(buffer_name))
            self._values = {k: v for k, v in self._values.items()
                            if k[1] == version}
            self._values[key] = got
        return got

    def values_for(self, buffer_name: str) -> torch.Tensor:
        """(n_out, C) values, a transposed view of the channel-major ones."""
        vals = self.values_cm_for(buffer_name)
        return vals.reshape(vals.shape[0], -1).t()

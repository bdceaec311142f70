"""The renderers over a particle mesh.

Counterpart of ``topsy_tpu/render/distributed.py``: the standard render
loops of ``render/sph.py``, ``render/surface.py`` and
``render/periodic.py`` with every splat launch made by a
``parallel.DistributedSplatter`` over the mesh (pass ``mesh=`` to the
Visualizer).  LOD blocks, cell culling, the giant layer, quantity switching
and the photometric scale behave as on one device; each EXPORT, column or
block launch is split over the shards and their partial framebuffers are
combined on the mesh's first device, which is the store's.  The lazy
EXPORT policy is the single device's: a first EXPORT without slabs renders
the strided block path (``DistributedSplatter.render``), later ones the
presorted slabs.  Two degradations are logged, as in the reference: a
splatter that kept no rows to presort falls back to the block path
(``_warn_presorted_unavailable``), and a surface renderer without the
column path renders on the store's device alone.
"""

from __future__ import annotations

import copy
import logging

import torch

from .. import config
from ..drawreason import DrawReason
from ..parallel.render_step import DistributedSplatter
from .periodic import PeriodicSPHRenderer
from .sph import SPHRenderer
from .store import ParticleStore
from .surface import SurfaceSPHRenderer, _max_composite

logger = logging.getLogger(__name__)


def same_device(a, b) -> bool:
    """Whether two torch devices name the same device (a CUDA device
    without an index is the current one)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device() if torch.cuda.is_available() else 0
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


class MeshSplatterMixin:
    """The mesh plumbing of the distributed renderers: the
    ``DistributedSplatter`` (rebuilt when the channel buffer or the values
    change) and the mesh's column progression."""

    def __init__(self, store: ParticleStore, render_progression,
                 resolution: int, mesh, wrapping: bool = False,
                 backend: str | None = None, share_render_progression=None):
        if not same_device(mesh.first_device, store.device):
            raise ValueError(f"the mesh's first shard is on "
                             f"{mesh.first_device}, the store on "
                             f"{store.device}: they must agree")
        super().__init__(store, render_progression, resolution,
                         wrapping=wrapping, backend=backend,
                         share_render_progression=share_render_progression)
        self._mesh = mesh
        self._splatter = None
        self._splatter_version = None
        self._column_mip_count = 0

    def _get_splatter(self) -> DistributedSplatter:
        version = (self._buffer_name, self._store.values_version)
        if self._splatter is None or self._splatter_version != version:
            store = self._store
            self._splatter = DistributedSplatter(
                self._mesh, store.pos_smooth,
                store.values_for(self._buffer_name), self._resolution,
                cell_ids=store.cell_ids, depth_channel=self._depth_channel)
            self._splatter_version = version
        return self._splatter

    def _maybe_activate_columns(self, draw_reason) -> bool:
        """Column LOD over the mesh: each shard renders the column range of
        its slab (the within-group shuffle is per layout, so the union of
        the shards' columns is the same fair subsample as one device's),
        with the mesh's decimation-mip tiers."""
        from ..ops.morton import min_slice_width
        from ..progression import RenderProgressionColumns
        if isinstance(self._render_progression, RenderProgressionColumns):
            return True
        if draw_reason in (DrawReason.REFINE, DrawReason.EXPORT):
            return False
        if self._backend != "atlas" or not config.INTERACTIVE_USE_PRESORTED:
            return False
        splatter = self._get_splatter()
        if not splatter.supports_presorted():
            splatter._warn_presorted_unavailable(
                "interactive sort-free column LOD")
            return False
        layout = splatter.presorted_layout
        if layout is None or layout.real_per_column is None:
            return False
        mips = splatter.presorted_mip_layouts()
        self._column_mip_count = len(mips)
        self._render_progression = RenderProgressionColumns(
            layout.real_per_column,
            cell_layout=getattr(self._render_progression, "cell_layout", None),
            col_quantum=min_slice_width(layout),
            mip_tiers=[(m.real_per_column, min_slice_width(m))
                       for m in mips])
        return True

    def _block_particles(self, col0: int, ncols: int) -> int:
        """The real particles in columns [col0, col0 + ncols) of the mesh's
        tier of the progression's last block."""
        splatter = self._get_splatter()
        ti = self._column_tier()
        layout = (splatter.presorted_layout if ti is None
                  else splatter.presorted_mip_layouts()[ti])
        return int(layout.real_per_column[col0:col0 + ncols].sum())

    def _column_tier(self):
        """The splatter's tier of the progression's last block (None = the
        main layout)."""
        ti = self._render_progression.last_block_tier
        return ti if ti < self._column_mip_count else None


class DistributedSPHRenderer(MeshSplatterMixin, SPHRenderer):
    """Density / weighted-quantity renderer over a particle mesh."""

    def _use_presorted(self) -> bool:
        """The lazy EXPORT policy over the splatter's own slabs: once they
        exist or once exports repeat."""
        if self._backend != "atlas":
            return False
        splatter = self._get_splatter()
        if not splatter.supports_presorted():
            splatter._warn_presorted_unavailable("sort-free EXPORT")
            return False
        if splatter.has_presorted():
            return True
        return self._export_renders >= 1

    def _render_presorted(self, matrix, scale, first_block: bool):
        """The single device's contract: the frame's exact giant layer
        planned and rendered once, the giants excluded from every shard's
        slab deposit."""
        splatter = self._get_splatter()
        mask = self._render_progression.get_selected_cell_mask()
        self._prepare_giants(matrix, scale, keep=False)
        with self._render_timer:
            im, dropped = splatter.render_presorted(
                matrix, scale, cell_mask=mask,
                giant_bucket=self._giant_bucket)
            self._dropped_splats = dropped
            self._image = im if first_block else self._image + im

    def _launch_block(self, matrix, scale, start: int, count: int,
                      bucket: int) -> torch.Tensor:
        mask = self._render_progression.get_selected_cell_mask()
        return self._get_splatter().render(matrix, scale, start, count,
                                           cell_mask=mask)

    def _render_columns_range(self, matrix, scale, col0: int, ncols: int,
                              first_block: bool) -> bool:
        """One column launch over the mesh for the progression's tier, the
        view's giants excluded (the render loop planned their layer)."""
        splatter = self._get_splatter()
        mask = self._render_progression.get_selected_cell_mask()
        with self._render_timer:
            im, dropped = splatter.render_columns(
                matrix, scale, col0, ncols, cell_mask=mask,
                tier=self._column_tier(), giant_bucket=self._giant_bucket)
            self.last_column_ranges.append((col0, ncols))
            self._dropped_splats = (dropped if self._dropped_splats is None
                                    else self._dropped_splats + dropped)
            if first_block:
                self._image = im
                first_block = False
            else:
                self._image = self._image + im
        return first_block

    def _get_depth_renderer(self):
        """The cached depth renderer over the same mesh (a fresh one per
        pick would rebuild its splatter's slabs)."""
        r = getattr(self, "_depth_renderer", None)
        if r is None:
            r = DistributedDepthSPHRenderer(
                self._store, None, self._resolution, self._mesh,
                wrapping=self._wrapping, backend=self._backend,
                share_render_progression=copy.copy(self._render_progression))
            self._depth_renderer = r
        r._render_progression = copy.copy(self._render_progression)
        r.rotation_matrix = self.rotation_matrix
        r.position_offset = self.position_offset
        r.scale = self.scale
        return r


class DistributedRGBSPHRenderer(DistributedSPHRenderer):
    _buffer_name = "rgb"


class DistributedDepthSPHRenderer(DistributedSPHRenderer):
    _depth_channel = True


class DistributedSurfaceSPHRenderer(MeshSplatterMixin, SurfaceSPHRenderer):
    """Front-most surface renderer over a particle mesh: each shard
    z-splats its slab's column range (K3) and the shards combine by the
    depth arg-max (``render_step.combine``).  It needs the presorted
    column path; without it the frame renders on the store's device
    alone, with a warning."""

    def _maybe_activate_columns(self, draw_reason) -> bool:
        ok = MeshSplatterMixin._maybe_activate_columns(self, draw_reason)
        if not ok:
            logger.warning("distributed surface mode needs the presorted "
                           "column path; rendering on one device")
        return ok

    def _render_columns_surface(self, matrix, scale, cut, col0: int,
                                ncols: int, first_block: bool) -> bool:
        splatter = self._get_splatter()
        mask = self._render_progression.get_selected_cell_mask()
        with self._render_timer:
            im, dropped = splatter.render_columns_surface(
                matrix, scale, cut, col0, ncols, cell_mask=mask,
                tier=self._column_tier(), giant_bucket=self._giant_bucket)
            self.last_column_ranges.append((col0, ncols))
            self._dropped_splats = (dropped if self._dropped_splats is None
                                    else self._dropped_splats + dropped)
            if first_block:
                self._image = im
                first_block = False
            else:
                self._image = _max_composite(self._image, im)
        return first_block


class DistributedPeriodicSPHRenderer(PeriodicSPHRenderer,
                                     DistributedSPHRenderer):
    """Periodic tiling of the panel rendered over the mesh: the panel's
    launches are ``DistributedSPHRenderer``'s, the lattice composite runs
    on the combined panel."""

    def __init__(self, store: ParticleStore, render_progression,
                 resolution: int, mesh, periodicity_scale: float,
                 backend: str | None = None):
        # PeriodicSPHRenderer.__init__ hands ``mesh`` on through its
        # keywords to MeshSplatterMixin, the next class of the MRO
        super().__init__(store, render_progression, resolution,
                         periodicity_scale=periodicity_scale,
                         backend=backend, mesh=mesh)

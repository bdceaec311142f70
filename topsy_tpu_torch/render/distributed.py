"""The renderers over a particle mesh.

Counterpart of ``topsy_tpu/render/distributed.py``: the frame loop of
``render/sph.py`` with the renderers of ``render/sph.py``,
``render/surface.py`` and ``render/periodic.py``, every splat launch made
by a ``parallel.DistributedSplatter`` over the mesh (pass ``mesh=`` to the
Visualizer): the mesh overrides only the deposit hooks and the column
path's layouts.  LOD blocks, cell culling, the giant layer, quantity
switching and the photometric scale behave as on one device; each EXPORT,
column or block launch is split over the shards and their partial
framebuffers are combined on the mesh's first device, which is the
store's.  The lazy
EXPORT policy is the single device's: a first EXPORT without slabs renders
the strided block path (``DistributedSplatter.render``), later ones the
presorted slabs.  Two degradations are logged, as in the reference: a
splatter that kept no rows to presort falls back to the block path
(``_warn_presorted_unavailable``), and a surface renderer without the
column path renders on the store's device alone.
"""

from __future__ import annotations

import logging

import torch

from ..parallel.render_step import DistributedSplatter
from .periodic import PeriodicSPHRenderer
from .sph import SPHRenderer
from .store import ParticleStore
from .surface import SurfaceSPHRenderer

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

    def _column_layouts(self):
        """The mesh's column path: its splatter's main layout and mip
        layouts (each shard renders the column range of its slab; the
        within-group shuffle is per layout, so the union of the shards'
        columns is the same fair subsample as one device's); (None, []),
        with a warning, for a splatter that kept no rows to presort."""
        splatter = self._get_splatter()
        if not splatter.supports_presorted():
            splatter._warn_presorted_unavailable(
                "interactive sort-free column LOD")
            return None, []
        return splatter.presorted_layout, splatter.presorted_mip_layouts()

    def _column_tier(self):
        """The splatter's tier of the progression's last block (None = the
        main layout)."""
        ti = self._render_progression.last_block_tier
        return ti if ti < len(self._column_layouts()[1]) else None


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

    def _render_presorted(self, matrix, scale) -> list:
        """The single device's contract: the frame's exact giant layer
        planned and rendered once, then one launch over the mesh's slabs
        with the giants excluded from every shard's deposit."""
        splatter = self._get_splatter()
        mask = self._render_progression.get_selected_cell_mask()
        self._prepare_giants(matrix, scale)
        return [lambda: splatter.render_presorted(
            matrix, scale, cell_mask=mask, giant_bucket=self._giant_bucket)]

    def _launch_block(self, matrix, scale, start: int, count: int,
                      bucket: int):
        mask = self._render_progression.get_selected_cell_mask()
        return self._get_splatter().render(matrix, scale, start, count,
                                           cell_mask=mask), None

    def _launch_columns(self, matrix, scale, col0: int, ncols: int):
        """One column launch over the mesh for the progression's tier, the
        view's giants excluded (the render loop planned their layer)."""
        mask = self._render_progression.get_selected_cell_mask()
        return self._get_splatter().render_columns(
            matrix, scale, col0, ncols, cell_mask=mask,
            tier=self._column_tier(), giant_bucket=self._giant_bucket)

    def _new_depth_renderer(self, **kw):
        """The depth renderer over the same mesh (a fresh one per pick
        would rebuild its splatter's slabs)."""
        return DistributedDepthSPHRenderer(self._store, None,
                                           self._resolution, self._mesh, **kw)


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
        ok = super()._maybe_activate_columns(draw_reason)
        if not ok:
            logger.warning("distributed surface mode needs the presorted "
                           "column path; rendering on one device")
        return ok

    def _launch_columns(self, matrix, scale, cut, col0: int, ncols: int):
        mask = self._render_progression.get_selected_cell_mask()
        return self._get_splatter().render_columns_surface(
            matrix, scale, cut, col0, ncols, cell_mask=mask,
            tier=self._column_tier(), giant_bucket=self._giant_bucket)


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

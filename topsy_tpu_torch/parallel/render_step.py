"""Multi-GPU rendering: particle-sharded splatting with a framebuffer
reduction.

Counterpart of ``topsy_tpu/parallel/render_step.py``.  Each shard of the
mesh (``parallel/mesh.py``) splats its particles into a full-resolution
partial framebuffer through the single-device kernels (K1 and K2 for the
additive modes, K3 for the surface), and ``combine`` reduces the partials
onto the mesh's first device: a sum for the additive modes, a depth
arg-max for the surface (the front-most depth over the shards, then the
largest payload among the shards holding it).  With a process group the
local reduction is followed by ``torch.distributed.all_reduce`` (SUM, or
MAX of the depth then MAX of the masked payload).  Every shard's launches
run under ``device_guard`` of its device: the kernels launch in the
current device's context.

Particles are sharded round-robin (``strided_shard``: shard d owns the
global indices i with i % D == d), so an LOD prefix [0, K) is balanced
over the shards and is a contiguous local prefix on each; ``render``
renders such a range through the per-frame-sorted ``splat_atlas``, in
pieces of ``store.MAX_BUCKET`` rows per shard as the reference does.  The
presorted paths (``render_presorted``, ``render_columns``,
``render_columns_surface``) cut one (bucket, Morton) layout, built on the
mesh's first device, into contiguous per-shard slabs, each with its
decimation-mip tiers; ``from_process_local`` builds each process's
layout over its own rows, negotiating the padded slab length (and which
mip tiers exist) over the process group.

Not ported: the reference's feed-off mesh steps (``_build_presorted_step``,
``_build_columns_step``) and their ``_use_feed`` switch, which exist there
because off the TPU its feed kernel runs interpreted (the port's feed runs
on every device it supports); the power-of-two ``slice_widths``
decomposition of ``render_columns`` (the port's column launch takes any
width); the ``SPLAT_COLUMNS_GROUP_CAP`` chunking of the surface step
beyond what the single-device column launch does; the ``backend``
argument, which only chose between those engines.
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

from .. import config, convert
from ..ops import morton, morton_device, splat_atlas, splat_giant
from ..render import sph as sph_module
from ..render import surface as surface_module
from ..render.store import MAX_BUCKET, MIN_BUCKET
from .mesh import Mesh

logger = logging.getLogger(__name__)

#: the presorted layout's length quantum per shard (``pad_total`` of the
#: presort is this times the shard count)
PAD_QUANTUM = 4096


def strided_shard(arr, n_devices: int):
    """(N, ...) to (D, ceil(N / D), ...) with round-robin rows, out[d, j] =
    arr[j * D + d], zero-padded; numpy arrays or torch tensors."""
    n = len(arr)
    per = -(-n // n_devices)
    tail = tuple(arr.shape[1:])
    if isinstance(arr, torch.Tensor):
        padded = arr.new_zeros((per * n_devices,) + tail)
        padded[:n] = arr
        return padded.reshape((per, n_devices) + tail).transpose(
            0, 1).contiguous()
    padded = np.zeros((per * n_devices,) + tail, dtype=arr.dtype)
    padded[:n] = arr
    return np.ascontiguousarray(
        padded.reshape((per, n_devices) + tail).swapaxes(0, 1))


def unstride(arr):
    """Inverse of ``strided_shard`` (up to the padding)."""
    d, per = arr.shape[:2]
    tail = tuple(arr.shape[2:])
    if isinstance(arr, torch.Tensor):
        return arr.transpose(0, 1).reshape((d * per,) + tail)
    return arr.swapaxes(0, 1).reshape((d * per,) + tail)


def _giant_mode(giant_bucket):
    """The raw API's giant contract as (auto, bucket threshold): None (the
    default) renders each shard's giants exactly in the call
    (``giants="auto"``: each particle lives on one shard, so the sum of the
    shards' exact layers is exact); ``"none"`` keeps the truncated windowed
    deposit; an int smoothing-bucket threshold excludes the giants for a
    dense layer the caller owns."""
    if giant_bucket is None:
        return True, splat_giant.BUCKET_DISABLED
    if isinstance(giant_bucket, str):
        if giant_bucket != "none":
            raise ValueError(f"giant_bucket {giant_bucket!r} invalid "
                             "(None, 'none', or a bucket threshold)")
        return False, splat_giant.BUCKET_DISABLED
    return False, int(giant_bucket)


def local_bucket_size(count_hint: int, local_n: int) -> int:
    """Power-of-two local bucket covering a global range on one shard."""
    b = MIN_BUCKET
    while b < count_hint and b < MAX_BUCKET:
        b *= 2
    return min(b, local_n, MAX_BUCKET)


def device_guard(device):
    """The context a shard's launches run in: its CUDA device made current
    (the kernels launch in the current device's context), nothing for a
    CPU shard."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def combine(partials, mesh: Mesh, mode: str = "sum"):
    """Reduce per-shard ``(image, dropped)`` partials onto the mesh's first
    device, then over its process group: ``mode="sum"`` adds the images
    (the additive modes); ``"depth_argmax"`` keeps per pixel the largest
    depth (the last channel) and, among the shards holding it, the largest
    payload (ties go to the larger value).  ``dropped`` (None or 0-dim
    tensors) is summed and stays on the device.  Cross-device moves are
    peer copies with ``non_blocking=True``.  Returns (image, dropped)."""
    target = mesh.first_device
    images = [im.to(target, non_blocking=True) for im, _ in partials]
    drops = [d for _, d in partials if d is not None]
    if mode == "sum":
        image = images[0]
        for im in images[1:]:
            image = image + im
    elif mode == "depth_argmax":
        if len(images) == 1:
            image = images[0]
        else:
            stacked = torch.stack(images)
            depth = stacked[..., -1].amax(dim=0)
            payload = torch.where((stacked[..., -1] == depth)[..., None],
                                  stacked[..., :-1], -torch.inf).amax(dim=0)
            image = torch.cat([payload, depth[..., None]], dim=-1)
    else:
        raise ValueError(f"unknown combine mode {mode!r}")
    dropped = None
    if drops:
        dropped = torch.stack([torch.as_tensor(d).to(target, torch.int64)
                               for d in drops]).sum()
    if mesh.group is not None:
        import torch.distributed as dist
        if mode == "sum":
            image = image.contiguous()
            dist.all_reduce(image, op=dist.ReduceOp.SUM, group=mesh.group)
        else:
            depth = image[..., -1].contiguous()
            dist.all_reduce(depth, op=dist.ReduceOp.MAX, group=mesh.group)
            payload = torch.where((image[..., -1] == depth)[..., None],
                                  image[..., :-1], -torch.inf).contiguous()
            dist.all_reduce(payload, op=dist.ReduceOp.MAX, group=mesh.group)
            image = torch.cat([payload, depth[..., None]], dim=-1)
        if dropped is None:
            dropped = torch.zeros((), dtype=torch.int64, device=target)
        dist.all_reduce(dropped, op=dist.ReduceOp.SUM, group=mesh.group)
    return image, dropped


class _Slab:
    """One shard's contiguous slab of a presorted tier, on its device: the
    (x, y, z, h) field matrices of the feed path (views of one (4, ln)
    tensor), the channel-major values, the buckets and cell ids, and the
    flat (ln, .) views of the surface path."""

    def __init__(self, device, positions, values_cm, buckets, cell_ids,
                 pad_group: int):
        self.device = device
        ln = positions.shape[1]
        ngl = ln // pad_group
        self.positions = positions.to(device).contiguous()
        self.fields = tuple(self.positions[k].reshape(ngl, pad_group)
                            for k in range(4))
        self.values_cm = values_cm.to(device).reshape(
            values_cm.shape[0], ngl, pad_group).contiguous()
        self.buckets = buckets.to(device).contiguous()
        self.group_buckets = self.buckets.reshape(ngl, pad_group)[:, 0] \
            .contiguous()
        self.cell_ids = cell_ids.to(device).contiguous()
        self.mask_cache = None

    @property
    def pos_smooth(self) -> torch.Tensor:
        """(ln, 4) positions and smoothing, a view."""
        return self.positions.t()

    @property
    def values(self) -> torch.Tensor:
        """(ln, C) values, a view."""
        return self.values_cm.reshape(self.values_cm.shape[0], -1).t()


def _build_layout(ps: torch.Tensor, pad_total: int):
    """The (bucket, Morton) layout of ``ps`` on its device: the device
    presort, or the host presort's as a gather layout where the device
    build returns None."""
    layout = morton_device.build_presorted_device(ps, pad_total=pad_total)
    if layout is None:
        logger.warning("Device presort unavailable: host presort fallback")
        layout = convert.device_layout_from_host(
            morton.build_presorted(ps.cpu().numpy(), pad_total=pad_total),
            ps.device)
    return layout


def _as_tensor(arr, dtype, device) -> torch.Tensor:
    """A numpy array or tensor as a ``dtype`` tensor on ``device``."""
    if not isinstance(arr, torch.Tensor):
        arr = torch.as_tensor(np.asarray(arr))
    return arr.to(device=device, dtype=dtype)


class DistributedSplatter:
    """Owns the particle shards of a mesh and renders them: the strided
    LOD-range path (``render``), the presorted slabs (``render_presorted``,
    ``render_columns``, ``render_columns_surface``), cell culling and the
    optional depth channel."""

    def __init__(self, mesh: Mesh, pos_smooth, values, resolution: int,
                 cell_ids=None, depth_channel: bool = False):
        self.mesh = mesh
        self.n_devices = mesh.n_devices
        self.resolution = resolution
        self.n = len(pos_smooth)
        self.local_n = -(-self.n // self.n_devices)
        self._depth_channel = depth_channel
        dev = mesh.first_device
        ps = _as_tensor(pos_smooth, torch.float32, dev)
        vals = _as_tensor(values, torch.float32, dev)
        if vals.ndim == 1:
            vals = vals[:, None]
        if cell_ids is None:
            self.n_cells = 1
            cids = torch.zeros(self.n, dtype=torch.int32, device=dev)
        else:
            cids = _as_tensor(cell_ids, torch.int32, dev)
            self.n_cells = int(cids.max()) + 1 if self.n else 1
        # the full arrays, on the first device: the presort's source and
        # the strided shards' (built on first use)
        self._src = (ps, vals, cids)
        self._local_rows = None
        self._shards = None
        self._presorted = None

    @classmethod
    def from_process_local(cls, mesh: Mesh, local_pos_smooth, local_values,
                           resolution: int, global_n: int,
                           **kwargs) -> "DistributedSplatter":
        """Construction from this process's rows only: the rows its shards
        own (global indices i with i % D one of its shards), already padded
        to ``len(mesh.devices) * ceil(global_n / D)`` rows, shard-major.
        No process holds the whole snapshot.  Pass ``n_cells`` with
        ``cell_ids`` when culling: the local rows see only some cells.  The
        presorted paths build each process's layout over its own rows
        (``ensure_presorted``), exact for the additive render because the
        processes' layouts permute disjoint subsets."""
        self = cls.__new__(cls)
        self.mesh = mesh
        self.n_devices = mesh.n_devices
        self.resolution = resolution
        self.n = int(global_n)
        self.local_n = -(-self.n // self.n_devices)
        self._depth_channel = kwargs.get("depth_channel", False)
        dev = mesh.first_device
        nl = len(mesh.devices)
        ps = _as_tensor(local_pos_smooth, torch.float32, dev)
        vals = _as_tensor(local_values, torch.float32, dev)
        if vals.ndim == 1:
            vals = vals[:, None]
        if ps.shape[0] != nl * self.local_n:
            raise ValueError(f"{ps.shape[0]} local rows, expected "
                             f"{nl} x {self.local_n}")
        cell_ids = kwargs.get("cell_ids")
        if cell_ids is None:
            self.n_cells = kwargs.get("n_cells", 1)
            cids = torch.zeros(ps.shape[0], dtype=torch.int32, device=dev)
        else:
            cids = _as_tensor(cell_ids, torch.int32, dev)
            self.n_cells = kwargs.get(
                "n_cells", int(cids.max()) + 1 if cids.numel() else 1)
        self._src = None
        self._local_rows = (ps, vals, cids)
        self._shards = None
        self._presorted = None
        return self

    # -- the strided shards of the LOD-range path ----------------------------

    def _strided(self) -> list:
        """(pos (local_n, 4), values, cell ids) of each local shard on its
        device: rows j * D + d of the snapshot for shard d."""
        if self._shards is None:
            mesh = self.mesh
            if self._src is not None:
                off = mesh.shard_offset
                arrays = [strided_shard(a, self.n_devices) for a in self._src]
                rows = [tuple(a[off + k] for a in arrays)
                        for k in range(len(mesh.devices))]
            else:
                rows = [tuple(a.reshape((len(mesh.devices), self.local_n)
                                        + tuple(a.shape[1:]))[k]
                              for a in self._local_rows)
                        for k in range(len(mesh.devices))]
            self._shards = [tuple(a.to(dev).contiguous() for a in r)
                            for dev, r in zip(mesh.devices, rows)]
        return self._shards

    def _cell_table(self, cell_mask, device) -> torch.Tensor:
        if cell_mask is None:
            return torch.ones(self.n_cells, dtype=torch.bool, device=device)
        return torch.as_tensor(np.asarray(cell_mask, dtype=bool),
                               device=device)

    def render(self, matrix, scale, start: int = 0, count: int | None = None,
               cell_mask=None) -> torch.Tensor:
        """The global LOD range [start, start + count) across the mesh
        through the per-frame-sorted ``splat_atlas`` (giants exact in each
        shard's call); a range wider than one launch per shard is rendered
        in pieces of ``MAX_BUCKET * D / 2`` rows and summed.  Returns the
        image on the mesh's first device."""
        matrix, scale = _host_view(matrix, scale)
        if count is None:
            count = self.n
        start, count = int(start), int(count)
        D = self.n_devices
        local_needed = -(-count // D) + 2
        if local_needed > MAX_BUCKET:
            piece = MAX_BUCKET * D // 2
            total = None
            for s in range(start, start + count, piece):
                im = self.render(matrix, scale, s,
                                 min(piece, start + count - s), cell_mask)
                total = im if total is None else total + im
            return total
        bucket = local_bucket_size(local_needed, self.local_n)
        off = self.mesh.shard_offset
        partials = []
        for k, (dev, (pos, vals, cids)) in enumerate(zip(self.mesh.devices,
                                                         self._strided())):
            d = off + k
            with device_guard(dev):
                lstart = (start - d + D - 1) // D
                sl = min(max(lstart, 0), self.local_n - bucket)
                gidx = (sl + torch.arange(bucket, device=dev)) * D + d
                rows = slice(sl, sl + bucket)
                table = self._cell_table(cell_mask, dev)
                mask = ((gidx >= start) & (gidx < start + count)
                        & table[cids[rows].long()])
                im, _ = splat_atlas.splat_atlas(
                    pos[rows], vals[rows], matrix, self.resolution, scale,
                    extra_mask=mask, depth_channel=self._depth_channel)
            partials.append((im, None))
        return combine(partials, self.mesh)[0]

    # -- presorted slabs -----------------------------------------------------

    def supports_presorted(self) -> bool:
        """True when construction kept rows to presort (the whole snapshot,
        or this process's rows); False only for a splatter that kept none,
        whose fast paths then fall back to the block path, loudly
        (``_warn_presorted_unavailable``)."""
        if self.has_presorted():
            return True
        return self._src is not None or self._local_rows is not None

    def _warn_presorted_unavailable(self, what: str):
        """One-shot warning when a fast path drops to the unsorted block
        renderer (an order-of-magnitude loss at scale is never silent)."""
        if getattr(self, "_warned_presorted", False):
            return
        self._warned_presorted = True
        logger.warning(
            "presorted Morton slabs unavailable (construction kept no "
            "rows): %s falls back to the unsorted block renderer (~10x "
            "slower at scale)", what)

    def has_presorted(self) -> bool:
        return self._presorted is not None

    def _tier_dict(self, layout, rows, ln: int, first: int) -> dict:
        """The slabs of ``layout`` (over ``rows``, (pos, values, cell
        ids) on the layout's device) for the local shards: slab ``first +
        k`` of ``ln`` slots for local shard k, the layout padded at its end
        with inactive slots where it is shorter."""
        ps, vals, cids = rows
        G = layout.pad_group
        pos = convert.presorted_positions(layout, ps)
        vcm = layout.apply(vals.to(torch.float32)).t()
        bks = layout.buckets
        cid = convert.presorted_cell_ids(layout, cids)
        nl = len(self.mesh.devices)
        extra = (first + nl) * ln - layout.n_out
        if extra > 0:
            pos = torch.cat([pos, pos.new_full((4, extra), morton.PAD_POS)],
                            dim=1)
            vcm = torch.cat([vcm, vcm.new_zeros((vcm.shape[0], extra))],
                            dim=1)
            bks = torch.cat([bks, bks.new_zeros(extra)])
            cid = torch.cat([cid, cid.new_zeros(extra)])
        slabs = []
        for k, dev in enumerate(self.mesh.devices):
            cols = slice((first + k) * ln, (first + k + 1) * ln)
            slabs.append(_Slab(dev, pos[:, cols], vcm[:, cols], bks[cols],
                               cid[cols], G))
        return dict(local_n=ln, layout=layout, slabs=slabs)

    def adopt_presorted(self, layout, mips=()):
        """Slab the given main layout and decimation-mip layouts (deepest
        first; ``morton_device.DevicePresortedLayout`` over the snapshot's
        rows, on the mesh's first device) over the mesh, as
        ``ensure_presorted`` slabs the ones it builds: how ``convert`` gives
        this splatter another's layout."""
        if self._src is None:
            raise ValueError("adopt_presorted needs the whole snapshot "
                             "(the standard constructor)")
        D = self.n_devices
        off = self.mesh.shard_offset
        self._presorted = self._tier_dict(layout, self._src,
                                          layout.n_out // D, off)
        self._presorted["mips"] = [
            self._tier_dict(m, self._src, m.n_out // D, off) for m in mips]

    def ensure_presorted(self, padded_local_len: int | None = None):
        """Build and slab the static (bucket, Morton) order once.

        The whole snapshot: one layout on the mesh's first device, cut into
        contiguous slabs, one per shard of the mesh.  Process-local rows:
        this process's layout over its own rows, cut into its shards' slabs;
        with more than one process the padded slab length is negotiated
        (``_group_max``; a caller that agreed on a length passes
        ``padded_local_len``), and so is the set of mip tiers, all or
        nothing.  Each layout is ``morton_device.build_presorted_device``'s
        with ``pad_total = 4096 *`` its slab count (``_build_layout``), and
        decimation-mip tiers are chained over the parent's floor columns
        while the floor exceeds ``COLUMN_MIP_FLOOR_TARGET`` per slab."""
        if self._presorted is not None:
            return
        whole = self._src is not None
        rows = self._src if whole else self._local_rows
        if rows is None:
            return  # construction kept no rows: nothing to presort
        # the whole snapshot is cut into every shard's slab, process-local
        # rows into this process's shards' slabs
        parts = self.n_devices if whole else len(self.mesh.devices)
        first = self.mesh.shard_offset if whole else 0
        layout = _build_layout(rows[0], PAD_QUANTUM * parts)
        natural = layout.n_out // parts
        if padded_local_len is None:
            ln = natural if whole else self._group_max(natural)[0]
        elif padded_local_len < natural or padded_local_len % PAD_QUANTUM:
            raise ValueError(
                f"padded_local_len {padded_local_len} invalid (needs a "
                f"multiple of {PAD_QUANTUM} >= {natural})")
        else:
            ln = int(padded_local_len)
        self.natural_local_len = natural
        self._presorted = self._tier_dict(layout, rows, ln, first)
        # A tier exists only if every process could build it and at least
        # one wants it.  The local floors differ, so both decisions are
        # collective: a process-local break would leave the other
        # processes waiting in a collective this one never enters
        mips = []
        lay = layout
        while len(mips) < config.COLUMN_MIP_MAX_TIERS:
            w = morton.min_slice_width(lay)
            floor = int(lay.real_per_column[:min(w, lay.pad_group)].sum())
            if not self._group_max(
                    int(floor > config.COLUMN_MIP_FLOOR_TARGET * parts))[0]:
                break
            mip = morton_device.build_mip_layout(
                lay, rows[0], pad_total=PAD_QUANTUM * parts)
            if self._group_max(int(mip is None))[0]:
                break
            nat_m = mip.n_out // parts
            ln_m = nat_m if whole else self._group_max(nat_m)[0]
            mips.insert(0, self._tier_dict(mip, rows, ln_m, first))
            lay = mip
        self._presorted["mips"] = mips

    def _group_max(self, *values: int) -> list[int]:
        """The maxima of ``values`` over the mesh's process group
        (``all_reduce`` MAX of an int64), or the values themselves in one
        process.  Slab lengths are multiples of 4096, so their maximum is
        one too."""
        group = self.mesh.group
        import torch.distributed as dist
        if group is None or dist.get_world_size(group) == 1:
            return list(values)
        # the collective's own tensor: NCCL takes the card only
        dev = (self.mesh.first_device if dist.get_backend(group) == "nccl"
               else torch.device("cpu"))
        t = torch.tensor(values, dtype=torch.int64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return t.tolist()

    def presorted_mip_layouts(self) -> list:
        """The mip tiers' layouts, deepest first (the progression's tier
        order); [] without tiers or slabs."""
        if not self.supports_presorted():
            self._warn_presorted_unavailable("decimation-mip tiers")
            return []
        self.ensure_presorted()
        if not self._presorted:
            return []
        return [m["layout"] for m in self._presorted.get("mips", [])]

    def _tier(self, tier: int | None) -> dict:
        """The tier dict of ``tier`` (None = the main layout, else an index
        into the deepest-first mips)."""
        if tier is None:
            return self._presorted
        return self._presorted.get("mips", [])[tier]

    @property
    def presorted_layout(self):
        """The main layout backing the slabs (built on first use); None
        when construction kept no rows to presort."""
        if not self.supports_presorted():
            self._warn_presorted_unavailable("presorted_layout")
            return None
        self.ensure_presorted()
        return self._presorted["layout"] if self._presorted else None

    def _feed_mask(self, cell_mask, slab: _Slab, pad_group: int):
        """A slab's (n_groups, pad_group) f32 cull mask, rebuilt only when
        the cell selection changes; None without culling."""
        if cell_mask is None:
            return None
        mask_np = np.asarray(cell_mask, dtype=bool)
        key = hash(mask_np.tobytes())
        if slab.mask_cache is not None and slab.mask_cache[0] == key:
            return slab.mask_cache[1]
        table = torch.as_tensor(mask_np, device=slab.device)
        m = table[slab.cell_ids.long()].to(torch.float32).reshape(
            -1, pad_group)
        slab.mask_cache = (key, m)
        return m

    # -- the presorted renders -----------------------------------------------

    def render_presorted(self, matrix, scale, cell_mask=None,
                         giant_bucket=None):
        """Every particle across the mesh through the presorted slabs: each
        shard's piece loop of ``splat_atlas_fields`` (K1, then K2), pieces
        of at most ``config.SPLAT_FEED_LAUNCH_CAP`` particles.  Returns
        (image, dropped summed over shards and pieces) on the first
        device; ``giant_bucket`` as ``_giant_mode``."""
        matrix, scale = _host_view(matrix, scale)
        self.ensure_presorted()
        ps = self._presorted
        ln = ps["local_n"]
        G = ps["layout"].pad_group
        ngl = ln // G
        piece_g = max(8, min(ngl, config.SPLAT_FEED_LAUNCH_CAP // G))
        auto, thresh = _giant_mode(giant_bucket)
        partials = []
        for dev, slab in zip(self.mesh.devices, ps["slabs"]):
            with device_guard(dev):
                mask = self._feed_mask(cell_mask, slab, G)
                image = dropped = None
                for g0 in range(0, ngl, piece_g):
                    pg = min(piece_g, ngl - g0)
                    im, d = splat_atlas.splat_atlas_fields(
                        slab.fields, slab.values_cm, matrix,
                        self.resolution, scale, slab.group_buckets,
                        mask=mask, depth_channel=self._depth_channel,
                        piece=None if pg == ngl else (g0, pg),
                        giants="auto" if auto else thresh)
                    image = im if image is None else image + im
                    dropped = d if dropped is None else dropped + d
            partials.append((image, dropped))
        return combine(partials, self.mesh)

    def render_columns(self, matrix, scale, col0: int, ncols: int,
                       cell_mask=None, tier=None, giant_bucket=None):
        """Columns [col0, col0 + ncols) of every shard's slab of ``tier``
        (None = the main layout, else a deepest-first mip index) in one
        column launch per shard (``render.sph._render_block_columns_fields``:
        an un-merged slice at any width, K1 then K2); returns (image,
        dropped) on the first device.  ``giant_bucket`` as
        ``_giant_mode``."""
        matrix, scale = _host_view(matrix, scale)
        self.ensure_presorted()
        ps = self._tier(tier)
        G = ps["layout"].pad_group
        auto, thresh = _giant_mode(giant_bucket)
        partials = []
        for dev, slab in zip(self.mesh.devices, ps["slabs"]):
            with device_guard(dev):
                partials.append(sph_module._render_block_columns_fields(
                    slab.fields, slab.values_cm, slab.group_buckets,
                    self._feed_mask(cell_mask, slab, G), matrix, scale,
                    col0, "auto" if auto else thresh,
                    resolution=self.resolution, width=ncols,
                    depth_channel=self._depth_channel))
        return combine(partials, self.mesh)

    def render_columns_surface(self, matrix, scale, density_cut, col0: int,
                               ncols: int, cell_mask=None, tier=None,
                               giant_bucket=None):
        """Front-most surface render of columns [col0, col0 + ncols) of
        every shard's slab of ``tier`` (``render.surface.
        _render_block_columns_surface``: K3), combined by the depth
        arg-max; returns ((res, res, 2) image, dropped).  ``giant_bucket``:
        an int threshold excludes giants for the caller's dense hemisphere
        layer; None or 'none' keep the windowed hemisphere (the z-buffered
        deposit has no in-call exact mode)."""
        matrix, scale = _host_view(matrix, scale)
        self.ensure_presorted()
        ps = self._tier(tier)
        G = ps["layout"].pad_group
        gb = (splat_giant.BUCKET_DISABLED if giant_bucket in (None, "none")
              else int(giant_bucket))
        partials = []
        for dev, slab in zip(self.mesh.devices, ps["slabs"]):
            with device_guard(dev):
                table = (None if cell_mask is None
                         else self._cell_table(cell_mask, dev))
                partials.append(
                    surface_module._render_block_columns_surface(
                        slab.pos_smooth, slab.values, slab.buckets,
                        None if table is None else slab.cell_ids, table,
                        matrix, scale, density_cut, col0, gb,
                        resolution=self.resolution, width=ncols,
                        pad_group=G))
        return combine(partials, self.mesh, mode="depth_argmax")


def _host_view(matrix, scale):
    """The (4, 4) float32 host matrix and the float32 scale the kernels'
    front ends take (float32 arithmetic for px_per_world, as the
    reference's)."""
    return np.asarray(matrix, np.float32), np.float32(scale)


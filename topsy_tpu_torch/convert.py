"""Presorted state as device gathers, and the reference's layouts carried
over to the port's tensors (a single device's, and a mesh splatter's
with ``splatter_layout_from_reference``).

Every presorted array of the port is one row gather through a
``morton_device.DevicePresortedLayout`` (``gidx``, the source row of every
output slot): the transposed fields, the channel-major values, the cell
ids and the giant candidate pool.  The host presort
(``ops.morton.build_presorted``, or the reference's own layouts, taken
duck-typed with numpy or jax fields) becomes such a layout through
``device_layout_from_host`` and ``device_layout_from_reference``.  The
store builds its state with these functions, and the tests use them to
give both packages one and the same layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import morton, splat_giant
from .ops.morton_device import DevicePresortedLayout


def _gather_layout(gidx, layout, device) -> DevicePresortedLayout:
    return DevicePresortedLayout(
        gidx=torch.from_numpy(np.array(gidx, np.int32)).to(device),
        buckets=torch.from_numpy(np.array(layout.buckets, np.int32)).to(
            device),
        n_out=int(layout.n_out), pad_group=int(layout.pad_group),
        run_quantum=int(layout.run_quantum),
        real_per_column=np.asarray(layout.real_per_column, np.int64),
        n_real=int(layout.n_real))


def device_layout_from_host(layout, device) -> DevicePresortedLayout:
    """A host ``PresortedLayout`` (``order``, ``dst``) as a gather layout
    on ``device``: slot ``dst[i]`` gathers source row ``order[i]``, every
    other slot the sentinel ``n_real``."""
    gidx = np.full(layout.n_out, layout.n_real, np.int32)
    gidx[np.asarray(layout.dst)] = np.asarray(layout.order)
    return _gather_layout(gidx, layout, device)


def device_layout_from_reference(layout, device) -> DevicePresortedLayout:
    """The reference's ``DevicePresortedLayout`` (its ``gidx`` and
    ``buckets`` device arrays, ``real_per_column`` numpy) as the port's, on
    ``device``."""
    return _gather_layout(np.asarray(layout.gidx), layout, device)


def layout_from_reference(layout, device) -> DevicePresortedLayout:
    """A reference layout of either kind, its device build's (``gidx``) or
    its host presort's (``order``, ``dst``), as the port's on ``device``."""
    if hasattr(layout, "gidx"):
        return device_layout_from_reference(layout, device)
    return device_layout_from_host(layout, device)


def splatter_layout_from_reference(splatter, ref_splatter):
    """Give a port ``parallel.DistributedSplatter`` the presorted layout
    and decimation-mip layouts of the reference's splatter over the same
    snapshot (built there on first use), so that both packages cut one
    layout into their slabs (the device presort's shuffle draws from
    torch's generator, not ``jax.random``)."""
    ref_splatter.ensure_presorted()
    ps = ref_splatter._presorted
    dev = splatter.mesh.first_device
    splatter.adopt_presorted(
        layout_from_reference(ps["layout"], dev),
        [layout_from_reference(m["layout"], dev)
         for m in ps.get("mips", [])])


def presorted_positions(layout: DevicePresortedLayout,
                        pos_smooth: torch.Tensor) -> torch.Tensor:
    """(4, n_out) presorted x, y, z, h rows (pads at PAD_POS)."""
    return layout.apply(pos_smooth.to(torch.float32),
                        fill=morton.PAD_POS).t().contiguous()


def presorted_values_cm(layout: DevicePresortedLayout,
                        values: torch.Tensor) -> torch.Tensor:
    """Channel-major presorted values (C, n_groups, pad_group), pads 0."""
    G = layout.pad_group
    vals = layout.apply(values.to(torch.float32)).t().contiguous()
    return vals.reshape(vals.shape[0], layout.n_out // G, G)


def presorted_cell_ids(layout: DevicePresortedLayout,
                       cell_ids: torch.Tensor | None) -> torch.Tensor:
    """(n_out,) int32 cell id per slot (0 without cells and for pads)."""
    if cell_ids is None:
        return torch.zeros(layout.n_out, dtype=torch.int32,
                           device=layout.gidx.device)
    return layout.apply(cell_ids.to(torch.int32))


def gather_presorted_rows(layout: DevicePresortedLayout, arr: torch.Tensor,
                          slots: torch.Tensor) -> torch.Tensor:
    """Rows of the presorted order of ``arr`` (original order) at the given
    real ``slots``, without building the whole presorted copy."""
    return arr.index_select(0, layout.gidx.index_select(0, slots))


def state_from_layout(layout: DevicePresortedLayout, pos_smooth, values,
                      cell_ids=None) -> dict:
    """The port's presorted state over a gather layout, by device gathers.

    pos_smooth: (n, 4) float32, values: (n, C), cell_ids: optional (n,),
    tensors on the layout's device.  Returns dict(fields=(x, y, z,
    h) each (n_groups, G), values_cm (C, n_groups, G), group_buckets
    (n_groups,) int32, buckets (n_out,) int32, giant_meta (host tuple, see
    ``splat_giant.candidate_slots``), giant_pos (m, 4), giant_buckets (m,)
    int32, giant_values (m, C), giant_cell_ids (m,) int32,
    cell_ids_presorted (n_out,) int32)."""
    G = layout.pad_group
    ng = layout.n_out // G
    meta = splat_giant.candidate_slots(layout)
    slots = torch.from_numpy(meta[0].astype(np.int64)).to(
        layout.gidx.device)
    pos = presorted_positions(layout, pos_smooth)
    cells = presorted_cell_ids(layout, cell_ids)
    return dict(
        fields=tuple(pos[k].reshape(ng, G) for k in range(4)),
        values_cm=presorted_values_cm(layout, values),
        group_buckets=layout.buckets.reshape(ng, G)[:, 0].contiguous(),
        buckets=layout.buckets, giant_meta=meta,
        giant_pos=gather_presorted_rows(layout, pos_smooth.to(torch.float32),
                                        slots),
        giant_buckets=torch.from_numpy(meta[1].astype(np.int32)).to(
            layout.gidx.device),
        giant_values=gather_presorted_rows(layout, values.to(torch.float32),
                                           slots),
        giant_cell_ids=cells.index_select(0, slots),
        cell_ids_presorted=cells)


def state_from_reference(layout, pos_smooth: np.ndarray, values: np.ndarray,
                         device, cell_ids: np.ndarray | None = None) -> dict:
    """``state_from_layout`` for a host ``PresortedLayout`` and host arrays:
    pos_smooth (n, 4), values (n, C), cell_ids optional (n,)."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return state_from_layout(
        device_layout_from_host(layout, device), put(pos_smooth, np.float32),
        put(values, np.float32),
        None if cell_ids is None else put(cell_ids, np.int32))

"""Carry the reference's host presort state over to the port's tensors.

The host presort (``ops.morton.build_presorted``, or the reference's own
``PresortedLayout``, taken duck-typed as a plain object with numpy fields)
plus host particle arrays become the port's device state.  The port's store
builds its state through it, and the tests use it to give both packages
identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import morton, splat_giant


def values_from_reference(layout, values: np.ndarray, slots: np.ndarray,
                          device):
    """Presorted channel values: (values_cm (C, n_groups, G) on ``device``,
    giant pool values (m, C) on ``device``) for host values (n, C)."""
    G = layout.pad_group
    ng = layout.n_out // G
    vals_p = layout.apply(np.asarray(values, dtype=np.float32))
    values_cm = torch.from_numpy(
        np.ascontiguousarray(vals_p.T).reshape(vals_p.shape[1], ng, G))
    giant_values = torch.from_numpy(np.ascontiguousarray(vals_p[slots]))
    return values_cm.to(device), giant_values.to(device)


def state_from_reference(layout, pos_smooth: np.ndarray, values: np.ndarray,
                         device, cell_ids: np.ndarray | None = None) -> dict:
    """The port's presorted state from a host ``PresortedLayout``.

    pos_smooth: (n, 4) f32 host positions + smoothing; values: (n, C) host
    channel values; cell_ids: optional (n,) host cell index per particle.
    Returns dict(fields=(x, y, z, h) each (n_groups, G), values_cm (C,
    n_groups, G), group_buckets (n_groups,) int32, buckets (n_out,) int32,
    giant_meta (host tuple, see ``splat_giant.candidate_slots``), giant_pos
    (m, 4), giant_buckets
    (m,) int32, giant_values (m, C), giant_cell_ids (m,) int32,
    cell_ids_presorted (n_out,) int32), all tensors on ``device``."""
    G = layout.pad_group
    ng = layout.n_out // G
    ps_p = layout.apply(np.asarray(pos_smooth, dtype=np.float32),
                        fill=morton.PAD_POS)
    fields = tuple(
        torch.from_numpy(np.ascontiguousarray(ps_p[:, k]).reshape(ng, G))
        .to(device) for k in range(4))
    group_buckets = torch.from_numpy(
        np.ascontiguousarray(layout.buckets.reshape(ng, G)[:, 0])
        .astype(np.int32)).to(device)
    meta = splat_giant.candidate_slots(layout)
    slots = meta[0]
    values_cm, giant_values = values_from_reference(layout, values, slots,
                                                    device)
    if cell_ids is None:
        cell_p = np.zeros(layout.n_out, np.int32)
    else:
        cell_p = layout.apply(np.asarray(cell_ids, dtype=np.int32))
    return dict(
        fields=fields, values_cm=values_cm, group_buckets=group_buckets,
        buckets=torch.from_numpy(np.asarray(layout.buckets, np.int32)).to(
            device),
        giant_meta=meta,
        giant_pos=torch.from_numpy(np.ascontiguousarray(ps_p[slots])).to(device),
        giant_buckets=torch.from_numpy(meta[1].astype(np.int32)).to(device),
        giant_values=giant_values,
        giant_cell_ids=torch.from_numpy(cell_p[slots]).to(device),
        cell_ids_presorted=torch.from_numpy(cell_p).to(device))

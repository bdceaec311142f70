"""The (bucket, Morton) presort built on the device.

Counterpart of ``topsy_tpu/ops/morton_device.py``: the same layout as the
host build ``ops/morton.build_presorted`` (same bucket quantization, Morton
key, run padding and within-group shuffle semantics), built with a few
sorts and O(n) passes of plain torch on the positions' own device.  Only
the tie order inside equal (bucket, Morton) keys and the shuffle's random
draws differ from the host build; the layout contract does not depend on
either (see ``morton.PresortedLayout``).

Algorithm (three sorts, the rest elementwise and cumulative passes):

1. one int64 key per particle, ``(bucket - bmin) << 48 | hi24 << 24 |
   lo24`` (buckets span at most 2,032 values, so the key has 59 bits;
   capacity padding particles take bucket ``bmax + 1`` and sort last), and
   a stable ``torch.sort`` with the particle index as the permutation;
2. run starts by neighbour comparison, each position's run start from the
   run table (step 3), run padding by a cumulative sum of per-run pad
   deltas placed at run starts: monotone destinations ``dst0``;
3. the run table (at most ``R_CAP`` runs) compacted by a scatter of each
   run start to its run index (the count of run starts before it), then
   each slot's run by a binary search of the runs' output starts, and its
   realness and bucket by a gather from the table;
4. slot -> source rank: ``cumsum(real) - 1``;
5. the within-group shuffle: a row-wise sort of random keys drawn from a
   generator seeded with ``seed`` (pads keyed 2.0 stay at the group tail);
6. compose with the sort permutation -> ``gidx``, the source row of every
   output slot (the sentinel ``n_real`` for pads).

The run stage's ``n_out`` and run count are read back once, before the
slot stage, which then runs at the exact ``n_out`` (the reference's static
capacity and its retry at a larger one exist for XLA's static shapes);
``real_per_column`` is read back once at the end.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from .morton import DELTA_OCTAVE, PAD_POS, min_slice_width

logger = logging.getLogger(__name__)

R_CAP = 2048          # max runs (f32 smoothing supports <= 2032 buckets)


def _spread8(v: torch.Tensor) -> torch.Tensor:
    """Interleave the low 8 bits of v to stride 3 (bits 0..21)."""
    x = v & 0xFF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton_keys(pos: torch.Tensor, real: torch.Tensor):
    """(hi24, lo24) int64 Morton key halves over the real bounding box."""
    inf = torch.tensor(float("inf"), dtype=pos.dtype, device=pos.device)
    lo = torch.where(real[:, None], pos, inf).amin(dim=0)
    hi = torch.where(real[:, None], pos, -inf).amax(dim=0)
    span = hi - lo + 1e-30
    q = torch.clamp((pos - lo) / span * 65535.0, 0.0, 65535.0).to(
        torch.int64)
    lo24 = (_spread8(q[:, 0]) | (_spread8(q[:, 1]) << 1)
            | (_spread8(q[:, 2]) << 2))
    hi24 = (_spread8(q[:, 0] >> 8) | (_spread8(q[:, 1] >> 8) << 1)
            | (_spread8(q[:, 2] >> 8) << 2))
    return hi24, lo24


def _ceil_to(x, q):
    return ((x + q - 1) // q) * q


def smoothing_buckets(h: torch.Tensor) -> torch.Tensor:
    """int32 1/8-octave bucket of each smoothing length, in float32 as the
    reference's device build computes it."""
    h = torch.clamp(h.to(torch.float32), min=1e-30)
    return torch.floor(torch.log2(h) * (1.0 / DELTA_OCTAVE)).to(torch.int32)


def _sort_stage(ps: torch.Tensor, n_real: int):
    """Keys and the stable sort: (sorted buckets int64, permutation)."""
    n_cap = ps.shape[0]
    real_in = torch.arange(n_cap, device=ps.device) < n_real
    buckets = smoothing_buckets(ps[:, 3]).to(torch.int64)
    big = torch.iinfo(torch.int64).max
    bmin = torch.where(real_in, buckets, big).amin()
    bmax = torch.where(real_in, buckets, -big).amax()
    b_rel = torch.where(real_in, buckets - bmin, bmax - bmin + 1)
    hi24, lo24 = _morton_keys(ps[:, :3], real_in)
    key = (b_rel << 48) | torch.where(real_in, (hi24 << 24) | lo24, 0)
    key_sorted, perm = torch.sort(key, stable=True)
    return (key_sorted >> 48) + bmin, perm


def _run_stage(b_sorted: torch.Tensor, n_real: int, run_quantum: int,
               pad_total: int):
    """Run boundaries, padded destinations and the compacted run table:
    (run output starts (R_CAP,), run buckets, run lengths, n_out and the
    run count as 0-dim tensors)."""
    n_cap = b_sorted.shape[0]
    dev = b_sorted.device
    pos = torch.arange(n_cap, device=dev)
    real_in = pos < n_real
    is_start = torch.ones(n_cap, dtype=torch.bool, device=dev)
    is_start[1:] = b_sorted[1:] != b_sorted[:-1]
    # the run table: each run's start scattered to its run index (the real
    # runs, then the capacity padding's run; runs past R_CAP share the
    # last entry, and the caller then falls back); unused entries n_cap
    ridx = torch.clamp(torch.cumsum(is_start, 0) - 1, max=R_CAP + 1)
    starts = torch.full((R_CAP + 2,), n_cap, dtype=torch.int64,
                        device=dev).scatter_(
        0, torch.where(is_start, ridx, R_CAP + 1), pos)
    run_start = starts[ridx]
    # padding added before each run: at run starts (pos > 0), the previous
    # run [prev_start, pos) is padded to a run_quantum multiple
    rs_prev = torch.cat([run_start.new_zeros(1), run_start[:-1]])
    len_prev = pos - rs_prev
    pad_prev = torch.where(is_start & (pos > 0),
                           _ceil_to(len_prev, run_quantum) - len_prev, 0)
    dst0 = pos + torch.cumsum(pad_prev, 0)

    # actual output length: end of the last real run, padded
    last = n_real - 1
    len_last = n_real - run_start[last]
    n_out = _ceil_to(dst0[last] + 1 + _ceil_to(len_last, run_quantum)
                     - len_last, pad_total)
    n_runs = (is_start & real_in).sum()

    # per run: output start, bucket and real length (0 past the real runs:
    # the padding's run starts at n_real, unused entries at n_cap)
    starts_r = starts[:R_CAP]
    at = torch.clamp(starts_r, max=n_cap - 1)
    len_r = (torch.clamp(starts[1:R_CAP + 1], max=n_real)
             - torch.clamp(starts_r, max=n_real))
    return dst0[at], b_sorted[at], len_r, n_out, n_runs


def _slot_stage(perm, os_r, bucket_r, len_r, *, n_real: int, n_out: int,
                n_runs: int, pad_group: int, seed: int):
    """Per-slot realness and bucket, the within-group shuffle and the
    gather map: (gidx, buckets, real, per-column real counts)."""
    dev = perm.device
    n_cap = perm.shape[0]

    # ---- per-slot run (the real runs' output starts ascend from 0), then
    # realness and bucket by a gather from the run table -------------------
    slot = torch.arange(n_out, device=dev)
    run = torch.searchsorted(os_r[:n_runs], slot, right=True) - 1
    real = slot < (os_r + len_r)[run]
    buckets_slot = bucket_r[run]

    # ---- source rank per slot, then within-group shuffle ------------------
    src_rank = torch.cumsum(real, 0) - 1
    n_groups = n_out // pad_group
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = torch.rand(n_out, generator=gen, device=dev)
    shuf_key = torch.where(real, rnd, 2.0).reshape(n_groups, pad_group)
    order = torch.sort(shuf_key, dim=1, stable=True).indices
    rank_shuf = src_rank.reshape(n_groups, pad_group).gather(1, order)
    rank_shuf = rank_shuf.reshape(n_out)

    # compose with the sort permutation -> original-array source index
    # (sentinel n_real for pads: real gather targets are < n_real, so
    # apply() only appends a single fill row)
    gidx = torch.where(real, perm[torch.clamp(rank_shuf, 0, n_cap - 1)],
                       n_real)
    # per-column real counts across groups: real slots are group prefixes,
    # so counts[c] == number of groups with more than c real members
    counts = real.reshape(n_groups, pad_group).sum(dim=0)
    return (gidx.to(torch.int32), buckets_slot.to(torch.int32), real,
            counts)


@dataclass(frozen=True)
class DevicePresortedLayout:
    """Device-resident presorted layout: per-slot gather index + buckets.

    ``gidx[s]`` is the source row of output slot s (``n_real`` for pads:
    ``apply`` appends a fill row so the gather is branch-free); the rest of
    the interface mirrors ``morton.PresortedLayout`` where the renderers
    need it."""

    gidx: torch.Tensor     # (n_out,) int32, sentinel == n_real for pads
    buckets: torch.Tensor  # (n_out,) int32, on the device
    n_out: int
    pad_group: int
    run_quantum: int
    real_per_column: np.ndarray   # (pad_group,) int64, host
    n_real: int

    def apply(self, arr: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        """``arr`` (rows >= n_real, on the layout's device) in the padded
        presorted order: one row gather."""
        if arr.shape[0] < self.n_real:
            raise ValueError(f"{arr.shape[0]} rows < n_real {self.n_real}")
        fill_row = torch.full((1,) + tuple(arr.shape[1:]), fill,
                              dtype=arr.dtype, device=arr.device)
        base = torch.cat([arr[:self.n_real], fill_row])
        return base.index_select(0, self.gidx)


def build_presorted_device(ps: torch.Tensor, pad_group: int = 512,
                           pad_total: int = 4096,
                           run_quantum: int | None = None, seed: int = 1337,
                           n_real: int | None = None
                           ) -> DevicePresortedLayout | None:
    """Build the presorted layout on ``ps``'s device.

    ps: (n, 4) [x, y, z, h] tensor.  ``n_real`` (default: all rows) marks
    rows >= n_real as padding whose contents are ignored (they must still
    be finite, e.g. PAD_POS rows).  Returns None when the snapshot needs the
    host fallback (more runs than R_CAP)."""
    if n_real is None:
        n_real = int(ps.shape[0])
    n = n_real
    if run_quantum is None:
        run_quantum = 8 * pad_group if n >= (1 << 23) else 4 * pad_group
    run_quantum = max(run_quantum, pad_group)

    # inputs padded to a power-of-two capacity with PAD_POS rows, which sort
    # after every real particle and form a trailing run never addressed
    n_cap = max(pad_total, 1 << (max(int(ps.shape[0]), 1) - 1).bit_length())
    ps = ps.to(torch.float32)
    if ps.shape[0] != n_cap:
        ps = torch.cat([ps, ps.new_full((n_cap - ps.shape[0], 4), PAD_POS)])

    b_sorted, perm = _sort_stage(ps, n)
    os_r, bucket_r, len_r, n_out, n_runs = _run_stage(
        b_sorted, n, run_quantum, pad_total)
    n_out, n_runs = (int(v) for v in torch.stack([n_out, n_runs]).tolist())
    if n_runs > R_CAP:
        logger.warning("Device presort fallback: %d runs > %d", n_runs, R_CAP)
        return None
    gidx, buckets_slot, _, counts = _slot_stage(
        perm, os_r, bucket_r, len_r, n_real=n, n_out=n_out, n_runs=n_runs,
        pad_group=pad_group, seed=seed)
    return DevicePresortedLayout(
        gidx=gidx, buckets=buckets_slot, n_out=n_out, pad_group=pad_group,
        run_quantum=run_quantum,
        real_per_column=counts.cpu().numpy().astype(np.int64), n_real=n)


def build_mip_layout(layout: DevicePresortedLayout, pos_smooth: torch.Tensor,
                     seed: int = 1337, pad_total: int = 4096
                     ) -> DevicePresortedLayout | None:
    """Decimation-mip layout: a presorted layout over the particles in the
    first ``min_slice_width`` columns of ``layout``, a spatially fair
    1/(pad_group/w) subsample thanks to the within-group shuffle.

    The mip's gidx composes back to the ORIGINAL arrays (the parent's
    sentinel semantics), so it is itself a DevicePresortedLayout over the
    snapshot and can be chained.  The union of the mip and the parent's
    columns [w, pad_group) is exactly the snapshot, so an interactive
    progression can render mip columns first and continue into parent
    columns with every particle rendered exactly once.

    ``pos_smooth``: (>= layout.n_real, 4) positions in the ORIGINAL order,
    on the layout's device.  Returns None when no subsample builds (a
    layout without column slicing, a degenerate subsample, the host
    fallback cases)."""
    w = min_slice_width(layout)
    if w >= layout.pad_group:
        return None  # no safe column slicing: nothing to decimate
    ng = layout.n_out // layout.pad_group
    sub = layout.gidx.reshape(ng, layout.pad_group)[:, :w].reshape(-1)
    n_full = layout.n_real
    sub_real = sub[sub < n_full]       # real slots compacted, in slot order
    m_real = int(sub_real.shape[0])
    if m_real < 2 * layout.pad_group:
        return None  # degenerate subsample: not worth a tier
    ps_sub = pos_smooth.to(torch.float32).index_select(0, sub_real)
    inner = build_presorted_device(ps_sub, pad_group=layout.pad_group,
                                   pad_total=pad_total, seed=seed,
                                   n_real=m_real)
    if inner is None:
        return None
    # compose the inner gather (into the compacted subsample) with the
    # subsample's source indices: inner pads carry the sentinel m_real,
    # which the appended entry maps to the parent's sentinel n_full
    ext = torch.cat([sub_real, sub_real.new_full((1,), n_full)])
    return DevicePresortedLayout(
        gidx=ext.index_select(0, inner.gidx), buckets=inner.buckets,
        n_out=inner.n_out, pad_group=inner.pad_group,
        run_quantum=inner.run_quantum,
        real_per_column=inner.real_per_column, n_real=n_full)

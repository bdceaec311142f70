"""Static (smoothing-bucket, Morton) particle ordering for sort-free splats.

A pinned copy of ``topsy_tpu/ops/morton.py``: the host presort, the
store's fallback where the device build (``ops/morton_device.py``, with the
decimation-mip layouts) returns None.

The atlas splatter needs particle groups whose projected (row band, column)
span fits a bounded accumulation window.  The interactive path gets this
from a per-frame ``lax.sort`` — the dominant cost of large renders (~9 ms
per million particles on v5e).  For full renders (EXPORT and the headline
benchmark) the sort can be eliminated entirely with a *static*, camera-
independent order computed once per snapshot:

* primary key: smoothing length quantized to 1/8-octave buckets.  Pyramid
  levels are then derived *from the bucket* (upper-edge representative)
  instead of the exact smoothing, so a bucket run always maps to a single
  level — groups never straddle atlas level regions — while preserving
  ``h_eff <= SPLAT_MAX_HALF_SIZE_PX`` exactly (the representative is an
  upper bound);
* secondary key: 3-D Morton code.  Any run of consecutive particles is then
  spatially local, and orthographic projection (the reference's camera
  model, reference: src/topsy/sph.py:268-299) preserves that locality under
  arbitrary rotation: measured fit rates on the GMM test snapshot are
  99.4-99.99% for 512-particle groups, the remainder handled exactly by the
  spill tiers;
* bucket runs are padded to the group size so no group straddles two levels.

The order is host-side numpy, computed lazily once per snapshot and cached
by the particle store.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DELTA_OCTAVE = 0.125  # smoothing-bucket width in octaves (see levels_from_buckets)
PAD_POS = 1.0e30      # padding sentinel: projects far outside any viewport
MORTON_BITS = 16      # per-axis quantization of positions


def morton_codes(pos: np.ndarray) -> np.ndarray:
    """Interleaved 3x16-bit Morton codes over the positions' bounding box."""
    pos = np.asarray(pos, dtype=np.float64)
    lo = pos.min(axis=0)
    span = pos.max(axis=0) - lo + 1e-300
    q = ((pos - lo) / span * ((1 << MORTON_BITS) - 1)).astype(np.uint64)

    def spread(x):
        x = x & np.uint64(0xFFFF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
        x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
        x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
        return x

    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))


def smoothing_buckets(h: np.ndarray) -> np.ndarray:
    """Absolute 1/8-octave bucket index of each smoothing length."""
    return np.floor(np.log2(np.maximum(np.asarray(h, dtype=np.float64),
                                       1e-300)) / DELTA_OCTAVE).astype(np.int32)


@dataclass(frozen=True)
class PresortedLayout:
    """The static order plus run padding.

    ``order[i]`` is the source index of the i-th sorted particle and
    ``dst[i]`` its destination slot in the padded output of length
    ``n_out``; slots not covered by ``dst`` are padding.  ``buckets`` gives
    the (absolute) smoothing bucket of every output slot, padding included
    (a padding slot carries its run's bucket so its derived level stays in
    the run's atlas region).

    Particles are additionally *shuffled within each pad_group-slot group*
    (pads stay at the group tail): the set per group — hence spans, window
    anchors and deposits — is unchanged, but any column slice of the
    (n_out/pad_group, pad_group) matrix becomes a spatially fair random
    subsample.  ``real_per_column[c]`` counts the real (non-pad) particles
    in column c, so LOD mass scale-factors stay exact.
    """

    order: np.ndarray    # (n,) int64
    dst: np.ndarray      # (n,) int64
    n_out: int
    buckets: np.ndarray  # (n_out,) int32
    pad_group: int = 512
    run_quantum: int = 512       # run padding quantum; k*pad_group lets
                                 # (pad_group/k)-wide column slices merge
                                 # into pad_group-particle groups without
                                 # straddling a (single-level) run boundary
    real_per_column: np.ndarray | None = None   # (pad_group,) int64
    n_real: int = 0

    def apply(self, arr: np.ndarray, fill: float = 0.0) -> np.ndarray:
        out = np.full((self.n_out,) + arr.shape[1:], fill, dtype=arr.dtype)
        out[self.dst] = arr[self.order]
        return out


def min_slice_width(layout: "PresortedLayout", floor: int = 64) -> int:
    """Smallest safe column-slice width for a layout.

    Slicing ``width`` columns merges ``m = pad_group/width`` adjacent
    groups into one splat group; the merged group stays single-level only
    if no m-aligned window of m groups straddles a run boundary.  Run
    padding to ``k*pad_group`` guarantees that exactly when m divides k,
    so the safe merges are the powers of two *dividing* k (not merely
    <= k: k=3 pads runs to 3-group multiples, whose boundaries 2-aligned
    windows do straddle).
    """
    pg = layout.pad_group
    if layout.run_quantum % pg:
        return pg
    ratio = layout.run_quantum // pg
    p = 1
    while ratio % (p * 2) == 0:
        p *= 2
    return max(pg // p, floor)


def slice_widths(layout: "PresortedLayout", floor: int = 64) -> list[int]:
    """Descending power-of-two column-slice widths for decomposing a column
    range: ``[pad_group, pad_group/2, ..., min_slice_width]``.  The single
    source of truth for every column-LOD render path (single-chip, surface,
    and both mesh variants)."""
    widths = []
    w = layout.pad_group
    lo = min_slice_width(layout, floor)
    while w >= lo:
        widths.append(w)
        w //= 2
    return widths


def build_presorted(pos_smooth: np.ndarray, pad_group: int = 512,
                    pad_total: int = 4096, run_quantum: int | None = None,
                    seed: int = 1337) -> PresortedLayout:
    """Compute the (bucket, Morton) order with runs padded to ``run_quantum``
    and the total padded to a ``pad_total`` multiple, then shuffle within
    groups (see PresortedLayout).

    The default run quantum is scale-adaptive: large snapshots pay for
    8*pad_group padding (enabling 64-wide interactive column slices, i.e. a
    1/8-coverage LOD floor) because the per-run waste is negligible there;
    small snapshots keep 4*pad_group (1/4 floor) where the same waste would
    cost several percent of full-render throughput.
    """
    pos_smooth = np.asarray(pos_smooth)
    if run_quantum is None:
        run_quantum = 8 * pad_group if len(pos_smooth) >= (1 << 23) \
            else 4 * pad_group
    run_quantum = max(run_quantum, pad_group)
    from .. import native
    nat = native.presort_order(pos_smooth, DELTA_OCTAVE)
    if nat is not None:
        buckets, order = nat
    else:
        buckets = smoothing_buckets(pos_smooth[:, 3])
        codes = morton_codes(pos_smooth[:, :3])
        # single combined u64 key (bucket in the high bits above the 48-bit
        # morton code): one argsort is ~2x faster than a two-key lexsort,
        # and this runs once per snapshot on the host
        b_rel = (buckets - buckets.min()).astype(np.uint64)
        order = np.argsort((b_rel << np.uint64(48)) | codes, kind="stable")
    b_sorted = buckets[order]

    # run boundaries of equal buckets in the sorted stream
    change = np.flatnonzero(np.diff(b_sorted)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(b_sorted)]])
    lens = ends - starts
    padded = ((lens + run_quantum - 1) // run_quantum) * run_quantum
    out_starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    n_out = int(padded.sum())
    n_out = ((n_out + pad_total - 1) // pad_total) * pad_total

    dst = np.empty(len(order), dtype=np.int64)
    tail_bucket = int(b_sorted[-1]) if len(b_sorted) else 0
    buckets_out = np.full(n_out, tail_bucket, dtype=np.int32)
    for s, e, os_, p, b in zip(starts, ends, out_starts, padded,
                               b_sorted[starts]):
        dst[s:e] = os_ + np.arange(e - s)
        buckets_out[os_:os_ + p] = b

    # within-group shuffle of the real slots (pads keep the group tail):
    # reassign the ascending real slots of each group to its particles in
    # random order
    g_id = dst // pad_group
    rnd = np.random.RandomState(seed).random_sample(len(dst))
    o2 = np.lexsort((rnd, g_id))
    dst_shuffled = np.empty_like(dst)
    dst_shuffled[o2] = dst  # dst is ascending and grouped, o2 is grouped
    dst = dst_shuffled

    n_groups = n_out // pad_group
    counts = np.bincount(g_id, minlength=n_groups)
    counts_sorted = np.sort(counts)
    real_per_column = (n_groups - np.searchsorted(
        counts_sorted, np.arange(pad_group), side="right")).astype(np.int64)

    return PresortedLayout(order=order, dst=dst, n_out=n_out,
                           buckets=buckets_out, pad_group=pad_group,
                           run_quantum=run_quantum,
                           real_per_column=real_per_column,
                           n_real=len(order))

"""Exact k-nearest-neighbour smoothing lengths on the device.

Counterpart of ``topsy_tpu/ops/knn_device.py`` in plain PyTorch: h = 0.5 *
the distance to the nn-th neighbour (pynbody's convention), exact for every
particle, with the reference's algorithm and its per-query proof:

1. **Morton order** (one stable sort of the (high, low) 24-bit halves of
   the 48-bit code as one 64-bit key: the reference's two-key sort).
2. **Tiles** of ``TILE`` sorted particles and their bounding boxes.
3. **Local pass**: per query block of ``BLOCK`` consecutive sorted
   particles, the nn-th distance among the block's own +-1 tiles, an upper
   bound of each query's radius.
4. **Selected-tile pass**: a tile is *needed* by query i when its bbox gap
   to i is within i's local radius; a block whose needed tiles all lie in
   its local window is exact already, the others (selected by a mask) take
   the nn-th distance over their ``initial_tiles`` nearest needed tiles
   (``torch.topk(largest=False)``).
5. **Per-query proof**: a query is exact when no needed tile left out of
   the selection lies within its radius; the others carry the flag in the
   sign of their output (``-kth``: the reference stores ``-(kth + 1)``,
   which rounds kth's low bits away, and its decoded value seeds the
   finishing pass as an upper bound).
6. **Finishing pass**: each flagged query measures every tile whose bbox
   gap to it is within its bound; the nn-th distance over them, capped by
   the bound, is exact.

Snapshots of at most ``BLOCK`` particles are brute-forced.

The reference walks the blocks with ``lax.scan`` and skips the selected-tile
pass with ``lax.cond``.  Here every stage runs over many blocks at once, in
steps whose largest float32 temporary holds at most ``STEP_ELEMS``
elements.  The reference measures every query against every tile; here a
tile is measured only when its gap to the block's bounding box is within
the block's largest local radius.  No other tile can be needed nor fail a
proof (its gap to each query is no smaller, in float32 too, since rounding
is monotone), so needs, selections, flags and results are the reference's,
and the reference's fill-in tiles (the nearest unneeded ones, which hold no
neighbour of any query) are not measured.  The finishing pass measures per
query the tiles within its own bound, where the reference streams per
block the chunks of BRUTE_CHUNK particles between the block's first and
last relevant chunk (no other particle can lower a seeded bound, and
flagged queries are scattered, so a block's chunks are far more than a
query's tiles); its queries are batched, with a host readback per step,
where the reference loops over blocks.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)

BLOCK = 512       # queries per block
TILE = 256        # candidate tile size
BIG = 3.0e38
#: the reference's finishing-pass chunk, here the padding quantum of the
#: sorted positions (it sets the tile count, hence the tile budget)
BRUTE_CHUNK = 4096
#: float32 elements of a step's largest temporary: 2^26, 256 MiB (the
#: reference's one-block selected-tile matrix, 512 x 64 * 256, is 2^23)
STEP_ELEMS = 1 << 26
#: device memory of ``knn_smooth_device`` over n positions is at most
#: FIXED_BYTES + BYTES_PER_PARTICLE * n (``device_bytes``): the steps'
#: temporaries and the per-particle arrays (positions, Morton keys and
#: their sort, the permutation, the per-slot distances), upper bounds that
#: the card's peak allocation is held to (chip_smoke.py, phase A)
FIXED_BYTES = 24 * 4 * STEP_ELEMS
BYTES_PER_PARTICLE = 160


def _spread8(v: torch.Tensor) -> torch.Tensor:
    x = v & 0xFF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_order(pos: torch.Tensor) -> torch.Tensor:
    """Permutation sorting ``pos`` along a 16-bit-per-axis Morton curve,
    ties in the input order."""
    lo = pos.amin(dim=0)
    hi = pos.amax(dim=0)
    span = torch.clamp((hi - lo).amax(), min=1e-30)
    q = torch.clamp((pos - lo) / span * 65535.0, 0.0, 65535.0).to(
        torch.int32)
    lo24 = (_spread8(q[:, 0]) | (_spread8(q[:, 1]) << 1)
            | (_spread8(q[:, 2]) << 2))
    hi24 = (_spread8(q[:, 0] >> 8) | (_spread8(q[:, 1] >> 8) << 1)
            | (_spread8(q[:, 2] >> 8) << 2))
    key = (hi24.to(torch.int64) << 24) | lo24.to(torch.int64)
    return torch.sort(key, stable=True).indices


def _sq_dist(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(..., Q, M) squared distances of q (..., Q, 3) to c (..., M, 3),
    summed x, y, z in order as the reference sums them, capped at BIG."""
    d2 = None
    for a in range(3):
        d = q[..., :, None, a] - c[..., None, :, a]
        d2 = d * d if d2 is None else d2 + d * d
    return torch.clamp(d2, max=BIG)


def _gap2(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
          ) -> torch.Tensor:
    """(..., Q, M) squared bbox gaps of points q (..., Q, 3) to boxes
    lo/hi (..., M, 3), capped at BIG."""
    g2 = None
    for a in range(3):
        qa = q[..., :, None, a]
        g = torch.clamp(torch.maximum(lo[..., None, :, a] - qa,
                                      qa - hi[..., None, :, a]), min=0.0)
        g2 = g * g if g2 is None else g2 + g * g
    return torch.clamp(g2, max=BIG)


def _kth(d2: torch.Tensor, nn: int) -> torch.Tensor:
    """The nn-th smallest along the last axis (BIG when fewer)."""
    m = d2.shape[-1]
    if m < nn:
        return torch.full(d2.shape[:-1], BIG, dtype=d2.dtype,
                          device=d2.device)
    return torch.topk(d2, nn, dim=-1, largest=False).values[..., nn - 1]


def _local_pass(pos_sorted, nn: int, n_real: int) -> torch.Tensor:
    """(n,) nn-th squared distance of each sorted slot among its block's
    own +-1 tiles (B + 2S candidates)."""
    n = pos_sorted.shape[0]
    B, S = BLOCK, TILE
    W = B + 2 * S
    dev = pos_sorted.device
    padded = torch.cat([torch.full((S, 3), -1e19, device=dev),
                        pos_sorted, torch.full((S, 3), 1e19, device=dev)])
    out = torch.empty(n, dtype=torch.float32, device=dev)
    nblocks = n // B
    step = max(1, STEP_ELEMS // (B * W))
    ar_b, ar_w = torch.arange(B, device=dev), torch.arange(W, device=dev)
    for b0 in range(0, nblocks, step):
        nb = min(step, nblocks - b0)
        s0 = b0 * B
        q = pos_sorted[s0:s0 + nb * B].reshape(nb, B, 3)
        win = padded[s0:s0 + nb * B + 2 * S].unfold(0, W, B).transpose(1, 2)
        d2 = _sq_dist(q, win)                                  # (nb, B, W)
        starts = s0 + B * torch.arange(nb, device=dev)
        qidx = starts[:, None] + ar_b                          # (nb, B)
        lidx = starts[:, None] - S + ar_w                      # (nb, W)
        bad = (qidx[:, :, None] == lidx[:, None, :]) \
            | ((lidx < 0) | (lidx >= n_real))[:, None, :]
        out[s0:s0 + nb * B] = _kth(d2.masked_fill_(bad, BIG), nn).reshape(-1)
    return out


def _candidates(q, q_real, kth_local, t_lo, t_hi):
    """(nb, ntiles) bool: the tiles whose gap to a block's bounding box
    (its real queries') is within the block's largest local radius, a
    superset of every tile a query of the block needs."""
    big = torch.tensor(3.0e38, device=q.device)
    lo = torch.where(q_real[..., None], q, big).amin(dim=1)
    hi = torch.where(q_real[..., None], q, -big).amax(dim=1)
    r = torch.where(q_real, kth_local, -1.0).amax(dim=1)       # (nb,)
    g2 = None
    for a in range(3):
        g = torch.clamp(torch.maximum(t_lo[None, :, a] - hi[:, None, a],
                                      lo[:, None, a] - t_hi[None, :, a]),
                        min=0.0)
        g2 = g * g if g2 is None else g2 + g * g
    return torch.clamp(g2, max=BIG) <= r[:, None]


def _selected_pass(pos_sorted, kth_local, cand_rows, blocks, T: int,
                   nn: int, n_real: int, t_lo, t_hi):
    """The selected-tile pass and the per-query proof for the query
    blocks ``blocks`` (k,) whose candidate tiles are ``cand_rows`` (k,
    Cm) (-1 pads).  Returns (k, B) sign-encoded kth and (k,) whether each
    block took the selected-tile pass."""
    B, S = BLOCK, TILE
    dev = pos_sorted.device
    k, cm = cand_rows.shape
    ar_b = torch.arange(B, device=dev)
    qidx = blocks[:, None] * B + ar_b                          # (k, B)
    q = pos_sorted[qidx]                                       # (k, B, 3)
    q_real = qidx < n_real
    kl = kth_local[qidx]
    valid = cand_rows >= 0
    tiles = cand_rows.clamp(min=0)
    qt = _gap2(q, t_lo[tiles], t_hi[tiles])                    # (k, B, Cm)
    qt.masked_fill_(~valid[:, None, :], float("inf"))
    needed = ((qt <= kl[:, :, None]) & q_real[:, :, None]).any(dim=1)
    ts = (blocks * (B // S))[:, None]
    own = (tiles >= ts - 1) & (tiles <= ts + B // S)
    main = (needed & ~own).any(dim=1)                          # (k,)
    kth = kl.clone()
    flag = torch.zeros_like(q_real)
    if bool(main.any()):
        mi = torch.nonzero(main).flatten()
        score = torch.where(needed[mi], qt[mi].amin(dim=1), float("inf"))
        n_sel = min(T, int(needed[mi].sum(dim=1).amax()))
        sel = torch.topk(score, n_sel, dim=1, largest=False).indices
        sel_ok = torch.gather(needed[mi], 1, sel)              # (km, n_sel)
        sel_tiles = torch.gather(tiles[mi], 1, sel)
        # the proof: a needed tile left out, within the query's radius
        left = needed[mi].clone()
        left.scatter_(1, sel, False)
        step = max(1, STEP_ELEMS // (B * n_sel * S))
        for j0 in range(0, mi.numel(), step):
            j = slice(j0, j0 + step)
            rows = (sel_tiles[j, :, None] * S
                    + torch.arange(S, device=dev)).reshape(
                        sel_tiles[j].shape[0], -1)             # (kj, n_sel*S)
            ok = sel_ok[j, :, None].expand(-1, -1, S).reshape(rows.shape)
            d2 = _sq_dist(q[mi[j]], pos_sorted[rows])
            bad = ((qidx[mi[j]][:, :, None] == rows[:, None, :])
                   | ~(ok & (rows < n_real))[:, None, :])
            top = _kth(d2.masked_fill_(bad, BIG), nn)
            kj = torch.minimum(top, kl[mi[j]])
            kth[mi[j]] = kj
            miss = torch.where(left[j][:, None, :], qt[mi[j]],
                               float("inf")).amin(dim=2)
            flag[mi[j]] = q_real[mi[j]] & (miss <= kj)
    # a flagged query with kth 0 is exact (0 bounds it below too)
    flag &= kth > 0.0
    return torch.where(flag, -kth, kth), main


def _tiled_kth_d2(pos_sorted, *, T: int, nn: int, n_real: int):
    """Per sorted slot the nn-th squared distance, negative where the
    per-query proof failed (the value is then an upper bound), and the
    number of blocks that took the selected-tile pass.

    ``pos_sorted``: (N, 3) Morton-sorted, N a multiple of BLOCK and TILE,
    padded past ``n_real`` with far sentinels."""
    n = pos_sorted.shape[0]
    B, S = BLOCK, TILE
    dev = pos_sorted.device
    tiles = pos_sorted.reshape(n // S, S, 3)
    t_lo, t_hi = tiles.amin(dim=1), tiles.amax(dim=1)
    kth_local = _local_pass(pos_sorted, nn, n_real)
    out = torch.empty_like(kth_local)
    nblocks = n // B
    n_main = 0
    ar_b = torch.arange(B, device=dev)
    step = max(1, STEP_ELEMS // (3 * (n // S)))
    for b0 in range(0, nblocks, step):
        blocks = torch.arange(b0, min(nblocks, b0 + step), device=dev)
        qidx = blocks[:, None] * B + ar_b
        cand = _candidates(pos_sorted[qidx], qidx < n_real,
                           kth_local[qidx], t_lo, t_hi)
        counts = cand.sum(dim=1)
        order = torch.argsort(counts)
        cnt = counts[order]
        bi, ti = torch.nonzero(cand[order], as_tuple=True)
        offs = torch.cumsum(cnt, 0) - cnt
        col = torch.arange(bi.numel(), device=dev) - offs[bi]
        cnt_h, offs_h = cnt.tolist(), offs.tolist()
        # sub-batches of blocks in the order of their candidate counts,
        # each (blocks, B, candidates) gap matrix within the step budget
        i = 0
        while i < len(cnt_h):
            j = i + 1
            while j < len(cnt_h) and (j + 1 - i) * B * max(1, cnt_h[j]) \
                    <= STEP_ELEMS:
                j += 1
            e0, e1 = offs_h[i], offs_h[j - 1] + cnt_h[j - 1]
            rows = torch.full((j - i, max(1, cnt_h[j - 1])), -1,
                              dtype=torch.int64, device=dev)
            rows[bi[e0:e1] - i, col[e0:e1]] = ti[e0:e1]
            sub = blocks[order[i:j]]
            enc, main = _selected_pass(pos_sorted, kth_local, rows, sub, T,
                                       nn, n_real, t_lo, t_hi)
            out[(sub[:, None] * B + ar_b).reshape(-1)] = enc.reshape(-1)
            n_main += int(main.sum())
            i = j
    return out, n_main


def _brute_kth_d2(pos_sorted, uidx, kth_ub, *, nn: int, n_real: int):
    """The exact nn-th squared distance of the query slots ``uidx``, the
    finishing pass: each query measures every tile whose bbox gap to it is
    within its upper bound ``kth_ub``, and its result, min(the nn-th
    distance over those tiles, its bound), is exact.

    The queries form blocks of BLOCK in their sorted order.  Per step of
    blocks (one host readback), a block's tiles are first narrowed to
    those within its largest bound of its bounding box (``_candidates``);
    per batch of blocks (one readback), each query keeps the tiles of its
    own, and queries with similar tile counts are measured together, as
    many per launch as ``STEP_ELEMS`` holds."""
    n = pos_sorted.shape[0]
    B, S = BLOCK, TILE
    dev = pos_sorted.device
    tiles = pos_sorted.reshape(n // S, S, 3)
    t_lo, t_hi = tiles.amin(dim=1), tiles.amax(dim=1)
    nu = uidx.shape[0]
    nblk = -(-nu // B)
    pad = nblk * B - nu
    # padding queries have bound -1: no tile is theirs
    slots = torch.cat([uidx, uidx.new_zeros(pad)]).reshape(nblk, B)
    ub = torch.cat([kth_ub, kth_ub.new_full((pad,), -1.0)]).reshape(nblk, B)
    qp = pos_sorted[slots]                                     # (nblk, B, 3)
    out = ub.clone()
    ar_s = torch.arange(S, device=dev)

    def finish(blks, rows):
        """The queries of blocks ``blks`` (k,) over their blocks' tiles
        ``rows`` (k, U) (-1 pads)."""
        k, U = rows.shape
        g2 = _gap2(qp[blks], t_lo[rows.clamp(min=0)],
                   t_hi[rows.clamp(min=0)])                    # (k, B, U)
        own = ((g2 <= ub[blks][:, :, None])
               & (rows >= 0)[:, None, :]).reshape(k * B, U)
        cnt = own.sum(dim=1)
        qord = torch.argsort(cnt)
        cq = cnt[qord].tolist()
        rank = torch.empty_like(qord)
        rank[qord] = torch.arange(k * B, device=dev)
        qi, ui = torch.nonzero(own, as_tuple=True)
        pr, perm = torch.sort(rank[qi], stable=True)
        tq = rows.reshape(-1)[(qi // B) * U + ui][perm]        # tile per pair
        offs = np.concatenate([[0], np.cumsum(cq)]).tolist()
        col = torch.arange(pr.numel(), device=dev) - torch.as_tensor(
            offs[:-1], device=dev)[pr]
        q_all, s_all = qp[blks].reshape(-1, 3), slots[blks].reshape(-1)
        res = ub[blks].reshape(-1).clone()
        a = next((i for i, c in enumerate(cq) if c), len(cq))
        while a < len(cq):
            c = a + 1
            while c < len(cq) and (c + 1 - a) * cq[c] * S <= STEP_ELEMS:
                c += 1
            qs = qord[a:c]
            trows = torch.full((c - a, cq[c - 1]), -1, dtype=torch.int64,
                               device=dev)
            trows[pr[offs[a]:offs[c]] - a, col[offs[a]:offs[c]]] = \
                tq[offs[a]:offs[c]]
            cand = (trows.clamp(min=0)[:, :, None] * S + ar_s).reshape(
                c - a, -1)                                     # (kq, m * S)
            ok = (trows >= 0)[:, :, None].expand(-1, -1, S).reshape(
                cand.shape)
            d2 = _sq_dist(q_all[qs][:, None, :], pos_sorted[cand])[:, 0]
            bad = (s_all[qs][:, None] == cand) | ~(ok & (cand < n_real))
            res[qs] = torch.minimum(_kth(d2.masked_fill_(bad, BIG), nn),
                                    res[qs])
            a = c
        out[blks] = res.reshape(k, B)

    step = max(1, STEP_ELEMS // (3 * (n // S)))
    for b0 in range(0, nblk, step):
        blocks = torch.arange(b0, min(nblk, b0 + step), device=dev)
        cand = _candidates(qp[blocks], ub[blocks] >= 0.0, ub[blocks], t_lo,
                           t_hi)
        counts = cand.sum(dim=1)
        order = torch.argsort(counts)
        bi, ti = torch.nonzero(cand[order], as_tuple=True)
        cnt_h = counts[order].tolist()
        offs_h = np.concatenate([[0], np.cumsum(cnt_h)]).tolist()
        col = torch.arange(bi.numel(), device=dev) - torch.as_tensor(
            offs_h[:-1], device=dev)[bi]
        i = next((k for k, c in enumerate(cnt_h) if c), len(cnt_h))
        while i < len(cnt_h):
            j = i + 1
            while j < len(cnt_h) and (j + 1 - i) * B * cnt_h[j] \
                    <= STEP_ELEMS:
                j += 1
            rows = torch.full((j - i, cnt_h[j - 1]), -1, dtype=torch.int64,
                              device=dev)
            rows[bi[offs_h[i]:offs_h[j]] - i, col[offs_h[i]:offs_h[j]]] = \
                ti[offs_h[i]:offs_h[j]]
            finish(blocks[order[i:j]], rows)
            i = j
    return out.reshape(-1)[:nu]


def device_bytes(n: int) -> int:
    """An upper bound of the device memory ``knn_smooth_device`` allocates
    over n positions."""
    return FIXED_BYTES + BYTES_PER_PARTICLE * n


def fits_device(n: int, device) -> bool:
    """Whether ``knn_smooth_device`` over n positions fits the free memory
    of the CUDA ``device``: the array loader's routing."""
    free, _ = torch.cuda.mem_get_info(torch.device(device))
    return device_bytes(n) <= free


def knn_smooth_device(positions, nn: int = 32, initial_tiles: int = 64,
                      device="cuda") -> torch.Tensor:
    """Exact smoothing lengths h = 0.5 * d_nn (pynbody's convention) of
    (n, 3) positions: a tensor, on its own device, or numpy, put on
    ``device``.  Returns (n,) float32 on that device, in the input
    order.  ``initial_tiles``: the selected-tile pass's tile budget per
    block; the queries it cannot prove exact take the finishing pass."""
    return knn_smooth_device_stats(positions, nn, initial_tiles, device)[0]


def knn_smooth_device_stats(positions, nn: int = 32, initial_tiles: int = 64,
                            device="cuda"):
    """``knn_smooth_device``'s (h, stats): stats counts the particles
    (``n``), the query blocks (``blocks``), those that took the
    selected-tile pass (``selected_blocks``) and the queries that took the
    finishing pass (``finishing``)."""
    if isinstance(positions, torch.Tensor):
        pos = positions.to(torch.float32)
    else:
        pos = torch.as_tensor(np.asarray(positions, np.float32),
                              device=device)
    pos = pos.contiguous()
    n = pos.shape[0]
    dev = pos.device
    if n <= BLOCK:
        # a small snapshot: brute force is exact and cheaper than sorting
        k = min(nn, n - 1)
        d2 = _sq_dist(pos, pos)
        d2.fill_diagonal_(BIG)
        kth = torch.topk(d2, k, dim=1, largest=False).values[:, k - 1]
        return 0.5 * torch.sqrt(kth), dict(n=n, blocks=1, selected_blocks=0,
                                          finishing=0)

    perm = morton_order(pos)
    quantum = max(BLOCK, TILE, BRUTE_CHUNK)
    npad = -(-n // quantum) * quantum
    sorted_pos = pos[perm]
    if npad > n:
        sorted_pos = torch.cat([sorted_pos, torch.full(
            (npad - n, 3), 1e19, dtype=torch.float32, device=dev)])
    T = min(initial_tiles, npad // TILE)
    enc, n_main = _tiled_kth_d2(sorted_pos, T=T, nn=nn, n_real=n)
    kth_sorted = torch.abs(enc)
    uidx = torch.nonzero(enc[:n] < 0.0).flatten()
    if uidx.numel():
        logger.info("knn_smooth_device: brute-force finishing pass for "
                    "%d/%d queries", uidx.numel(), n)
        kth_sorted[uidx] = _brute_kth_d2(sorted_pos, uidx, kth_sorted[uidx],
                                         nn=nn, n_real=n)
    kth = torch.empty(n, dtype=torch.float32, device=dev)
    kth[perm] = kth_sorted[:n]
    return 0.5 * torch.sqrt(kth), dict(n=n, blocks=npad // BLOCK,
                                      selected_blocks=n_main,
                                      finishing=int(uidx.numel()))

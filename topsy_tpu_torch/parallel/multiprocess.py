"""Multi-process rendering over ``torch.distributed``: a launcher and its
worker.

Counterpart of ``examples/multiprocess_render.py``.  ``launch`` starts N
worker processes on a free localhost port; each joins one process group
(NCCL where every rank has a card of its own, gloo on the CPU and where
ranks share a card; the choice is logged, and a backend that fails to
start raises), holds one shard of a mesh over the group and builds a
``DistributedSplatter.from_process_local`` over its own rows only.  The
synthetic snapshot's rows are split unequally (rank 0 takes ``share`` of
them, the others the rest), so each process's natural presorted slab
length differs and ``ensure_presorted`` negotiates the padded one.  Each
worker renders the block path (``render``), the presorted EXPORT
(``render_presorted``), the full-width column launch and, where tiers
formed, the deepest mip tier's columns (with its share of the snapshot's
mass); rank 0 writes them with the ranks' natural and negotiated slab
lengths to an ``.npz``.  ``scene`` and
``split_rows`` give a caller the same rows for the single-process
comparison: the block path over the interleaved rows on a one-process
mesh of N shards holds the same shards.

    python -m topsy_tpu_torch.parallel.multiprocess [n] [nproc] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

RESOLUTION = 64
SCALE = 50.0
SEED = 1337


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def backend_for(device_type: str, world_size: int) -> str:
    """NCCL where every rank has a card of its own, else gloo (the CPU, or
    ranks sharing a card: gloo's all_reduce takes CUDA tensors)."""
    if device_type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, rank: int, backend: str) -> torch.device:
    if device_type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank if backend == "nccl" else 0)


def scene(n: int, seed: int = SEED):
    """The seeded synthetic snapshot: (pos_smooth (n, 4), values (n, 2) =
    (mass, mass * test-quantity)) float32."""
    from ..loaders import TestDataLoader
    loader = TestDataLoader(n, seed=seed)
    ps = loader.get_pos_smooth().astype(np.float32)
    mass = loader.get_mass().astype(np.float32)
    qty = loader.get_named_quantity("test-quantity").astype(np.float32)
    return ps, np.stack([mass, mass * qty], axis=1)


def split_rows(ps: np.ndarray, vals: np.ndarray, nproc: int, share: float):
    """The snapshot's rows split unequally over ``nproc`` ranks: rank 0
    takes the first ``share`` of them, the others equal parts of the rest,
    each zero-padded to the longest part ``local_n``.  Returns (per-rank
    (pos, values) rows, the interleaved (pos, values) of a one-process
    mesh whose strided shards are exactly these rows (row j * nproc + r is
    rank r's row j), the global length nproc * local_n)."""
    n = len(ps)
    n0 = int(round(share * n)) if nproc > 1 else n
    rest = np.array_split(np.arange(n0, n), max(nproc - 1, 1))
    parts = [np.arange(n0)] + (list(rest) if nproc > 1 else [])
    local_n = max(len(p) for p in parts)
    rows = []
    for p in parts:
        rp = np.zeros((local_n, 4), np.float32)
        rv = np.zeros((local_n, vals.shape[1]), np.float32)
        rp[:len(p)] = ps[p]
        rv[:len(p)] = vals[p]
        rows.append((rp, rv))
    from .render_step import unstride
    glob = tuple(unstride(np.stack([r[i] for r in rows])) for i in (0, 1))
    return rows, glob, nproc * local_n


def worker(cfg: dict):
    """One rank: join the group, render this rank's rows, rank 0 writes
    the images to ``cfg["out"]``."""
    import torch.distributed as dist
    from .. import camera, config
    from . import make_mesh
    from .render_step import DistributedSplatter
    rank, nproc = cfg["rank"], cfg["nproc"]
    if cfg.get("threads"):
        torch.set_num_threads(cfg["threads"])
    if cfg.get("mip_floor") is not None:
        config.COLUMN_MIP_FLOOR_TARGET = cfg["mip_floor"]
    backend = backend_for(cfg["device"], nproc)
    dev = rank_device(cfg["device"], rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    print(json.dumps({"rank": rank, "backend": backend,
                      "device": str(dev)}), flush=True)
    dist.init_process_group(backend,
                            init_method=f"tcp://localhost:{cfg['port']}",
                            world_size=nproc, rank=rank)
    # the collectives' own tensors: NCCL takes the card's only
    cdev = dev if backend == "nccl" else torch.device("cpu")
    try:
        ps, vals = scene(cfg["n"], cfg.get("seed", SEED))
        rows, _, global_n = split_rows(ps, vals, nproc, cfg["share"])
        mesh = make_mesh(nproc, devices=[dev], group=dist.group.WORLD)
        res, scale = cfg.get("resolution", RESOLUTION), cfg.get("scale",
                                                              SCALE)
        matrix = camera.world_to_clip_matrix(np.eye(3), np.zeros(3), scale)
        ds = DistributedSplatter.from_process_local(
            mesh, rows[rank][0], rows[rank][1], res, global_n)
        t0 = time.perf_counter()
        block = ds.render(matrix, scale).cpu().numpy()
        ds.ensure_presorted()
        pre, d_pre = ds.render_presorted(matrix, scale)
        G = ds.presorted_layout.pad_group
        col, d_col = ds.render_columns(matrix, scale, 0, G)
        mips = ds.presorted_mip_layouts()
        out = dict(block=block, pre=pre.cpu().numpy(),
                   col=col.cpu().numpy(), dropped_pre=int(d_pre.item()),
                   dropped_col=int(d_col.item()))
        if mips:
            mip, _ = ds.render_columns(matrix, scale, 0, mips[0].pad_group,
                                       tier=0)
            out["mip"] = mip.cpu().numpy()
            # the deepest tier's share of the snapshot's mass (the zero
            # padding rows count as particles of the layout, not as mass)
            mass = torch.from_numpy(rows[rank][1][:, 0].astype(np.float64))
            g = mips[0].gidx.cpu().long()
            shares = torch.tensor([float(mass[g[g < len(mass)]].sum()),
                                   float(mass.sum())], dtype=torch.float64,
                                  device=cdev)
            dist.all_reduce(shares, group=dist.group.WORLD)
            out["mip_mass_share"] = float(shares[0] / shares[1])
        lens = torch.zeros((2, nproc), dtype=torch.int64, device=cdev)
        lens[0, rank] = ds.natural_local_len
        lens[1, rank] = ds._presorted["local_n"]
        dist.all_reduce(lens, group=dist.group.WORLD)
        seconds = time.perf_counter() - t0
        lens = lens.cpu()
        if rank == 0:
            np.savez(cfg["out"], natural=lens[0].numpy(),
                     negotiated=lens[1].numpy(), n_mips=len(mips),
                     global_n=global_n, backend=backend, **out)
        from ..ops import splat_accum, splat_feed
        print(json.dumps({"rank": rank, "natural": int(lens[0, rank]),
                          "launches": {
                              "splat_feed": splat_feed.launches,
                              "accumulate_groups": splat_accum.launches},
                          "negotiated": int(lens[1, rank]),
                          "mips": len(mips), "seconds": seconds,
                          "block_sum": float(block[..., 0].sum()),
                          "pre_sum": float(out["pre"][..., 0].sum())}),
              flush=True)
    finally:
        dist.destroy_process_group()


def launch(n: int, nproc: int, out: str, *, device: str = "cuda",
           share: float = 0.4, timeout: float = 600.0, **cfg) -> dict:
    """Run ``nproc`` workers over ``n`` synthetic particles and wait for
    them (killing all at ``timeout`` seconds); raises unless every worker
    exits 0.  Each worker's output goes to a file beside ``out`` (a pipe
    could fill while its reader waits on another rank).  Returns rank 0's
    arrays and every worker's standard output."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; "
                           "pass device='cpu' to render on the CPU")
    port = free_port()
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    logs = [(f"{out}.rank{rank}.out", f"{out}.rank{rank}.err")
            for rank in range(nproc)]
    procs = []
    try:
        for rank, (so, se) in enumerate(logs):
            conf = dict(cfg, rank=rank, nproc=nproc, n=n, port=port, out=out,
                        device=device, share=share)
            with open(so, "w") as fo, open(se, "w") as fe:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "topsy_tpu_torch.parallel.multiprocess", "--worker",
                     json.dumps(conf)], env=env, cwd=root, stdout=fo,
                    stderr=fe))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outputs = []
    for p, (so, se) in zip(procs, logs):
        with open(so) as fo, open(se) as fe:
            outputs.append((p.returncode, fo.read(), fe.read()))
    failed = [(r, so, se) for r, so, se in outputs if r != 0]
    if failed:
        raise RuntimeError("worker failed: " + "\n".join(
            f"exit {r}\n{so}\n{se[-4000:]}" for r, so, se in failed))
    with np.load(out) as got:
        result = {k: got[k] for k in got.files}
    result["stdout"] = [so for _, so, _ in outputs]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=200_000)
    ap.add_argument("nproc", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--share", type=float, default=0.4)
    ap.add_argument("--out", default="multiprocess_render.npz")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(json.loads(args.worker))
        return 0
    got = launch(args.n, args.nproc, args.out, device=args.device,
                 share=args.share)
    print(f"natural slab lengths {got['natural'].tolist()}, negotiated "
          f"{got['negotiated'].tolist()}, backend {got['backend']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Two real processes rendering one mesh over ``torch.distributed`` (gloo
on the CPU), mirroring tests/test_multiprocess.py through the port's
launcher ``topsy_tpu_torch/parallel/multiprocess.py`` (the counterpart of
examples/multiprocess_render.py).  The snapshot's rows are split
unequally (a quarter to rank 0), so the ranks' natural presorted slab
lengths differ and ``ensure_presorted`` pads both to the negotiated
maximum.  Against one process: the block path over the same shards bit
for bit; the presorted EXPORT and the full-width column launch within
rtol 1e-5 of the same two process-local layouts rendered in one process
(only the order of the final sum differs), and at the cross-process
tolerance of examples/multiprocess_render.py (rtol 1e-3, atol 1e-5 of the
maximum) against the one-process mesh's own layout; the deepest mip tier
holds its share of the mass (rel 0.1, as there)."""

import contextlib
import signal

import numpy as np
import pytest
import torch

from topsy_tpu_torch import camera
from topsy_tpu_torch.parallel import DistributedSplatter, make_mesh
from topsy_tpu_torch.parallel import multiprocess

N = 20000
SHARE = 0.25
MIP_FLOOR = 300
LIMIT_S = 120


@contextlib.contextmanager
def time_limit(seconds):
    """Fail the test once it has run ``seconds`` seconds."""
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def test_two_process_gloo_render_matches_single_process(tmp_path,
                                                        monkeypatch):
    with time_limit(LIMIT_S):
        check_two_process_render(tmp_path, monkeypatch)


def check_two_process_render(tmp_path, monkeypatch):
    got = multiprocess.launch(N, 2, str(tmp_path / "mp.npz"), device="cpu",
                              share=SHARE, threads=1, mip_floor=MIP_FLOOR, timeout=100)
    assert str(got["backend"]) == "gloo"
    natural, negotiated = got["natural"], got["negotiated"]
    assert natural[0] != natural[1], natural
    assert (negotiated == natural.max()).all(), (natural, negotiated)
    assert int(got["dropped_pre"]) == int(got["dropped_col"]) == 0

    from topsy_tpu_torch import config
    monkeypatch.setattr(config, "COLUMN_MIP_FLOOR_TARGET", MIP_FLOOR)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ps, vals = multiprocess.scene(N)
        rows, (g_ps, g_vals), global_n = multiprocess.split_rows(
            ps, vals, 2, SHARE)
        assert int(got["global_n"]) == global_n
        scale = multiprocess.SCALE
        matrix = camera.world_to_clip_matrix(np.eye(3), np.zeros(3), scale)
        res = multiprocess.RESOLUTION
        one = DistributedSplatter(make_mesh(2, devices=["cpu"] * 2), g_ps,
                                  g_vals, res)
        np.testing.assert_array_equal(got["block"],
                                      one.render(matrix, scale).numpy())
        # the two ranks' own layouts, rendered and summed in this process
        pre = col = None
        for rp, rv in rows:
            r = DistributedSplatter.from_process_local(
                make_mesh(1, devices=["cpu"]), rp, rv, res, len(rp))
            r.ensure_presorted(padded_local_len=int(negotiated.max()))
            p = r.render_presorted(matrix, scale)[0].numpy()
            c = r.render_columns(matrix, scale, 0, 512)[0].numpy()
            pre = p if pre is None else pre + p
            col = c if col is None else col + c
        np.testing.assert_allclose(got["pre"], pre, rtol=1e-5,
                                   atol=1e-7 * np.abs(pre).max())
        np.testing.assert_allclose(got["col"], col, rtol=1e-5,
                                   atol=1e-7 * np.abs(col).max())
        want, _ = one.render_presorted(matrix, scale)
        want = want.numpy()
    finally:
        torch.set_num_threads(threads)
    for key in ("pre", "col"):
        np.testing.assert_allclose(got[key], want, rtol=1e-3,
                                   atol=1e-5 * np.abs(want).max())
    assert int(got["n_mips"]) >= 1
    frac = float(got["mip_mass_share"])
    assert 0 < frac < 1, frac
    assert got["mip"][..., 0].sum() == pytest.approx(
        want[..., 0].sum() * frac, rel=0.1)

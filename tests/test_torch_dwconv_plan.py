"""The launch plan of K7 and K8 (csrc/dwconv_stats.cu) through its Python
mirror, and K7's tiled statistics reduction emulated on the CPU. Pure
torch: no JAX import, a few seconds."""

import bisect
import re

import numpy as np
import pytest
import torch

from vfm_vae_tpu_torch.ops.kernels import dwconv_stats as dws
from vfm_vae_tpu_torch.ops.kernels._build import CSRC
from tests.torch_threads import one_torch_thread  # noqa: F401

# (C, H = W, k) of the flagship decode's 38 ConvNeXt dwconvs
# (entry.kernel_sites(G, 256)), and ragged maps off the tiles: (C, H, W, k).
FLAGSHIP = [(512, 8, 5), (512, 16, 5), (512, 32, 7), (512, 64, 7), (256, 128, 7), (128, 256, 7)]
RAGGED = [(128, 17, 16, 7), (256, 33, 40, 7), (512, 2, 2, 5), (64, 5, 70, 5), (256, 8, 8, 7),
          (64, 1, 3, 3), (512, 9, 8, 5), (192, 20, 7, 3)]
SITES = [(c, h, h, k) for c, h, k in FLAGSHIP] + RAGGED
STATS_REL = 1e-5  # chip_smoke.STATS_REL: fp32 sums against fp64


def _modes(k):
    return (True, False) if k in (5, 7) else (False,)


@pytest.mark.parametrize("B", [2, 3, 32])
def test_plan_covers_every_output_once(B):
    """Over the CTAs' runs of tiles, every (sample, output pixel, channel
    block) is one tile's exactly once, each CTA walks a non-empty run, and
    the runs are consecutive; one launch a call."""
    for C, H, W, k in SITES:
        if B == 32 and H * W * C > 256 * 256 * 128 // 4 and (H, C) != (256, 128):
            continue  # the top site stands for the large maps at B=32
        for stats in _modes(k):
            p = dws.plan(B, H, W, C, k, stats)
            assert p["launches"] == 1 and p["ctas"] == min(p["tiles"], 132)
            hits = np.zeros((B, p["tiles_h"] * p["th"], p["tiles_w"] * p["tw"], p["n_cb"]),
                            np.int32)
            nxt = 0
            for cta in range(p["ctas"]):
                run = dws.cta_tiles(p, cta)
                assert len(run) > 0 and run.start == nxt
                nxt = run.stop
                for t in run:
                    b, cb, th, tw = dws.tile_work(p, t)
                    hits[b, th * p["th"]:(th + 1) * p["th"], tw * p["tw"]:(tw + 1) * p["tw"],
                         cb] += 1
            assert nxt == p["tiles"] == B * p["n_cb"] * p["tiles_h"] * p["tiles_w"]
            assert (hits == 1).all(), (B, C, H, W, k)
            assert p["tiles_h"] * p["th"] - H < p["th"] and p["tiles_w"] * p["tw"] - W < p["tw"]


def test_plan_fits_shared_memory_and_tma():
    """232,448 bytes of shared memory a block and a ring of 2-3 stages; a
    stage holds the tile's cb / 64 boxes of 64 channels x (tw + k - 1) x
    (th + k - 1) bf16 (TMA box dimensions within 256) and K7's fp32 noise,
    each 128-byte aligned; 16 compute warps cover the tile in 8 x 4 pixel
    blocks of one channel a thread."""
    for C, H, W, k in SITES + [(1024, 300, 3, 7), (256, 1, 1, 3)]:
        for B in (1, 32):
            for stats in _modes(k):
                p = dws.plan(B, H, W, C, k, stats)
                ih, iw = p["th"] + k - 1, p["tw"] + k - 1
                assert 2 <= p["stages"] <= dws.MAX_STAGES and p["smem_bytes"] <= dws.SMEM_MAX
                assert p["x_bytes"] == p["cb"] // 64 * ih * iw * 64 * 2
                noise = p["stage_bytes"] - p["x_bytes"]
                assert noise == (-(-p["th"] * p["tw"] * 4 // 128) * 128 if stats else 0)
                assert p["stage_bytes"] % 128 == 0 and max(ih, iw) <= 256
                fixed = dws.ALIGN + dws.BAR_BYTES + (dws.RED_BYTES if stats else 0)
                assert p["smem_bytes"] == fixed + p["stages"] * p["stage_bytes"]
                assert p["smem_bytes"] + p["stage_bytes"] > dws.SMEM_MAX or p["stages"] == 3
                warps = (p["cb"] // 32) * (p["th"] // dws.ROWS) * (p["tw"] // dws.COLS)
                assert warps * 32 == dws.THREADS == p["threads"]


def test_plan_picks_the_tiles_of_the_design():
    """64 channels x 16 x 16 pixels, three stages, at every flagship site but
    the H = 8 one, which takes one 256 x 8 x 8 tile per channel block (two
    stages beside K7's buffers); 132 CTAs wherever the tiles fill them; K8
    has no workspace."""
    want = {8: (256, 8, 2), 16: (64, 16, 3), 32: (64, 16, 3), 64: (64, 16, 3),
            128: (64, 16, 3), 256: (64, 16, 3)}
    for C, H, k in FLAGSHIP:
        p = dws.plan(32, H, H, C, k, True)
        assert (p["cb"], p["th"], p["stages"]) == want[H], (C, H, p)
        assert p["ctas"] == min(132, p["tiles"])
        q = dws.plan(32, H, H, C, k, False)
        assert q["part_floats"] == q["counters"] == 0 and q["tiles"] == p["tiles"]
    assert dws.plan(32, 256, 256, 128, 7, True)["tiles"] == 32 * 2 * 16 * 16
    assert dws.plan(2, 8, 8, 512, 5, True)["ctas"] == 4


def test_plan_refuses_what_the_kernel_does_not_take():
    for args in ((2, 8, 8, 96, 5, True), (2, 8, 8, 128, 3, True), (2, 8, 8, 128, 9, False),
                 (0, 8, 8, 128, 5, True), (2, 8, 0, 128, 5, False)):
        with pytest.raises(ValueError):
            dws.plan(*args)


def test_workspace_holds_every_partial_once():
    """K7's workspace: 2 x B x C x tiles_h x tiles_w fp32 partials laid out
    (moment, sample, channel block, tile, channel), one slot per (moment,
    sample, channel, tile), and a counter per (sample, channel block)."""
    for C, H, W, k in SITES:
        if k == 3:
            continue
        B = 3
        p = dws.plan(B, H, W, C, k, True)
        nsp = p["tiles_h"] * p["tiles_w"]
        assert p["part_floats"] == 2 * B * C * nsp and p["counters"] == B * p["n_cb"]
        slots = np.zeros(p["part_floats"], np.int32)
        m, b, cb, j, c = np.meshgrid(np.arange(2), np.arange(B), np.arange(p["n_cb"]),
                                     np.arange(nsp), np.arange(p["cb"]), indexing="ij")
        idx = (((m * B + b) * p["n_cb"] + cb) * nsp + j) * p["cb"] + c
        np.add.at(slots, idx.ravel(), 1)
        assert (slots == 1).all()


def _c_segment_starts(t0: int, nsp: int, tiles: int, ctas: int):
    """The segment starts of the block [t0, t0 + nsp) as the kernel computes
    them (run_start, seg_lo, seg_hi in csrc/dwconv_stats.cu)."""
    lo = ((t0 + 1) * ctas + tiles - 1) // tiles
    hi = ((t0 + nsp) * ctas + tiles - 1) // tiles - 1
    return [t0] + [k * tiles // ctas for k in range(lo, hi + 1)]


@pytest.mark.parametrize("B", [2, 3, 32])
def test_segments_partition_each_block_in_run_order(B):
    """A block's segments cover its tiles once, in tile order, each inside
    one CTA's run and cut only where a run starts; the kernel's integer
    arithmetic for the cuts gives the same starts; the summation order
    depends on the shape and the CTA count only."""
    for C, H, W, k in SITES:
        if k == 3:
            continue
        for sms in (132, 114):
            p = dws.plan(B, H, W, C, k, True, sms)
            nsp = p["tiles_h"] * p["tiles_w"]
            starts = [dws.cta_tiles(p, c).start for c in range(p["ctas"])]
            for blk in range(B * p["n_cb"]):
                segs = dws.segments(p, blk)
                assert [j for j0, n in segs for j in range(j0, j0 + n)] == list(range(nsp))
                for j0, n in segs:
                    t = blk * nsp + j0
                    run = dws.cta_tiles(p, bisect.bisect_right(starts, t) - 1)
                    assert t + n <= run.stop and (j0 == 0 or t == run.start)
                    assert (j0 + n == nsp) or (t + n == run.stop)
                got = _c_segment_starts(blk * nsp, nsp, p["tiles"], p["ctas"])
                assert got == [blk * nsp + j0 for j0, _ in segs], (C, H, W, k, blk)


def test_constants_match_the_kernel_source():
    """The mirror's constants are the kernel's (csrc/dwconv_stats.cu)."""
    src = (CSRC / "dwconv_stats.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kR"), const("kWT")) == (dws.ROWS, dws.COLS)
    assert const("kThreads") == dws.THREADS and const("kMaxStages") == dws.MAX_STAGES
    assert const("kSmemMax") == dws.SMEM_MAX
    assert const("kAlign") == dws.ALIGN and const("kBarBytes") == dws.BAR_BYTES
    assert "sum_partials_kernel" not in src and "partials.cuh" not in src


@pytest.mark.parametrize("B,H,W,C,k,sms", [(2, 17, 16, 128, 7, 132), (1, 33, 40, 64, 5, 3),
                                           (2, 2, 2, 256, 5, 132), (3, 8, 8, 256, 7, 2),
                                           (2, 40, 33, 64, 7, 5)])
def test_emulated_statistics_match_the_twin(B, H, W, C, k, sms):
    """K7's reduction emulated as the kernel orders it (fp32 per thread and
    tile, fp64 over a segment and over a block's segments) on the twin's own
    t: s1 within STATS_REL of sum |t| and s2 within STATS_REL relative,
    against the twin's statistics and against fp64 sums. Few SMs make
    segments of several tiles and blocks cut between CTAs."""
    r = np.random.default_rng(B * 100 + H)
    x = torch.from_numpy(r.standard_normal((B, H, W, C)).astype(np.float32) + 0.5)
    x = x.to(torch.bfloat16)
    w = torch.from_numpy(r.standard_normal((k, k, C)).astype(np.float32) / k)
    b = torch.from_numpy(r.standard_normal(C).astype(np.float32))
    noise = torch.from_numpy(r.standard_normal((H, W)).astype(np.float32) * 0.3)
    t, s1, s2 = dws.dwconv_noise_stats_reference(x, w, b, noise)
    e1, e2 = dws.emulate_stats(t, dws.plan(B, H, W, C, k, True, sms))
    td = t.double()
    a1, x1, x2 = td.abs().sum((1, 2)), td.sum((1, 2)), td.square().sum((1, 2))
    for got in ((e1, e2), (s1, s2)):
        assert float(((got[0].double() - x1).abs() / a1).max()) <= STATS_REL
        assert float(((got[1].double() - x2).abs() / x2).max()) <= STATS_REL
    assert float(((e1.double() - s1.double()).abs() / a1).max()) <= STATS_REL
    assert float(((e2.double() - s2.double()).abs() / x2).max()) <= STATS_REL

"""The launch plan of K2 (csrc/fused_upsample.cu) through its Python mirror,
and the kernel's tiled decomposition of the function emulated on the CPU.
Pure torch: no JAX import, a few seconds."""

import numpy as np
import pytest
import torch

from vfm_vae_tpu_torch.ops.kernels import fused_upsample as fu
from tests.torch_threads import one_torch_thread  # noqa: F401

# (Ci, Co, H, taps) of the flagship decode's K2 sites (the separate and the
# last upsample of blocks 1-5: entry.kernel_sites), of the stage-0 EQ
# decodes (z of 4, 8 and 12 px: a quarter, a half and three quarters of
# each flagship H) and the card test's sites (Ci=256, Co=128; H x W below).
FLAGSHIP = [(768, 512, 8, 3), (512, 512, 8, 3), (640, 512, 16, 3), (512, 512, 16, 3),
            (640, 512, 32, 5), (512, 512, 32, 5), (512, 256, 64, 5), (256, 128, 128, 5)]
EQ = [(ci, co, h * f // 4, kb) for ci, co, h, kb in FLAGSHIP for f in (1, 2, 3)]
SITES = sorted({(ci, co, h, h, kb) for ci, co, h, kb in FLAGSHIP + EQ}
               | {(256, 128, h, w, 5) for h, w in ((8, 8), (5, 70), (1, 3))})
SMEM_MAX = 232448


@pytest.mark.parametrize("B", [2, 4, 32])
def test_plan_covers_every_sample_pixel_and_channel_once(B):
    """Over the CTAs of the grid, every (sample, output pixel, output
    channel) is stored by exactly one CTA, at every K2 site; one launch."""
    for Ci, Co, H, W, kb in SITES:
        p = fu.plan(B, H, W, Ci, Co, kb)
        assert p["ctas"] == p["tiles"] * p["split"] and p["launches"] == 1
        hits = np.zeros((B, 2 * H, 2 * W, Co // 32), np.int32)
        for cta in range(p["ctas"]):
            b, h0, h1, w0, w1, c0, c1 = fu.cta_work(p, H, W, Co, cta)
            assert h0 < h1 and w0 < w1 and c0 < c1, (Ci, Co, H, W, cta)
            hits[b, 2 * h0:2 * h1, 2 * w0:2 * w1, c0 // 32:c1 // 32] += 1
        assert (hits == 1).all(), (B, Ci, Co, H, W)


def test_plan_fits_shared_memory_and_the_operands():
    """232,448 bytes of shared memory a block, a ring of at least two 16 KB
    stages; the tile and its one-pixel ring fit the padded GEMM rows (one
    warpgroup of 64 at Ci > 512, else two of one or two 64-row blocks), A at
    most 128 KB, the x boxes' dimensions within TMA's 256."""
    for B in (1, 2, 32):
        for Ci, Co, H, W, kb in SITES + [(1024, 64, 9, 9, 3), (544, 32, 3, 40, 1),
                                         (1088, 32, 5, 7, 3), (96, 96, 300, 2, 5),
                                         (32, 32, 1, 1, 1)]:
            p = fu.plan(B, H, W, Ci, Co, kb)
            assert p["smem_bytes"] <= SMEM_MAX and p["stages"] >= 2, (Ci, H, W, p)
            assert (p["rows"] + 2) * (p["cols"] + 2) <= p["mpad"] in (64, 128, 256)
            assert (p["mpad"] == 64) == (Ci > 512)
            assert p["mpad"] * p["kc"] * 2 <= fu.A_BUDGET and p["kc"] % 64 == 0
            assert p["chunks"] * p["kc"] >= Ci > (p["chunks"] - 1) * p["kc"]
            assert (p["chunks"] == 1) == (p["mpad"] * (-(-Ci // 64) * 64) * 2 <= fu.A_BUDGET)
            assert max(p["rows"], p["cols"]) + 4 <= 256 and p["threads"] == 384
            assert p["xc"] == 64 or p["xc"] == 32


def test_plan_picks_the_tiles_of_the_design():
    """The flagship sites' tiles (rows x cols of input pixels, GEMM rows):
    4 x 8 (60 of 64 rows for 32 pixels) at Ci > 512, 8 x 8 (100 of 128 for
    64) at Ci=512 and H=8 and 16, 5 x 16 (126 of 128 for 80) at H=32 and 64,
    12 x 16 (252 of 256 for 192) at Ci=256; the N walk split only where the
    tiles leave SMs idle."""
    for Ci, Co, H, kb in FLAGSHIP:
        want = ((4, 8, 64) if Ci > 512 else (8, 8, 128) if H <= 16 else
                (12, 16, 256) if Ci == 256 else (5, 16, 128))
        for B in (2, 32):
            p = fu.plan(B, H, H, Ci, Co, kb)
            assert (p["rows"], p["cols"], p["mpad"]) == want, (Ci, H, p)
            assert p["chunks"] == 1
            if 2 * p["tiles"] > 132:
                assert p["split"] == 1
            else:
                assert p["split"] == Co // 32 or 2 * p["tiles"] * p["split"] > 132


@pytest.mark.parametrize("bad", [dict(Ci=48), dict(Co=40), dict(kb=4), dict(kb=7), dict(B=0),
                                 dict(H=0)])
def test_plan_refuses_what_the_kernel_does_not_take(bad):
    args = dict(B=2, H=8, W=8, Ci=64, Co=64, kb=3)
    with pytest.raises(ValueError):
        fu.plan(**dict(args, **bad))


def _dyadic(B, H, W, Ci, Co, seed):
    """Inputs whose fp32 sums are exact (small dyadic rationals: every sum of
    the stencil and the product fits fp32's 24 bits), so that the stencil
    and the product give the same bits in any summation order, while the
    bf16 rounding points still round; the blurs' sums are emulated in the
    twin's order."""
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16

    def q(lo, hi, den, shape, dt=torch.float32):
        return torch.from_numpy(rng.integers(lo, hi + 1, shape) / den).float().to(dt)

    return dict(x=q(-8, 8, 8, (B, H, W, Ci), bf), a=q(2, 6, 4, (B, Ci)), c=q(-8, 8, 16, (B, Ci)),
                dw=q(-8, 8, 8, (Ci, 3, 3)), pw=q(-8, 8, 16, (4 * Co, Ci), bf))


def _emulate(x, a, c, dw, pw, taps, rows, cols):
    """The kernel's decomposition in fp32 on the CPU, tile by tile: the x box
    with two pixels of halo (zero outside the image, as TMA fills it), the
    affine, then zeros outside the image (the depthwise's SAME padding), the
    3x3 stencil over the tile and its one-pixel ring, bf16; the product,
    bf16; the product buffer indexed as the kernel indexes it (pixel, then
    subpixel 2 (Y & 1) + (X & 1)); the horizontal leg over the 5-tap frame
    with clamped columns for the rows the vertical leg reads, bf16; the
    vertical leg, bf16; stored for the tile's rows and columns inside the
    image. Every index into the product buffer must fall inside the tile and
    its ring."""
    B, H, W, Ci = x.shape
    Co, dt = pw.shape[0] // 4, x.dtype
    frame = [0.0] * 5
    for j, t in enumerate(taps):
        frame[2 - len(taps) // 2 + j] = float(t)
    out = torch.full((B, 2 * H, 2 * W, Co), float("nan"), dtype=dt)
    Rs, Ws = rows + 2, cols + 2
    for b in range(B):
        for h0 in range(0, H, rows):
            for w0 in range(0, W, cols):
                hh = torch.arange(h0 - 2, h0 + rows + 2)
                ww = torch.arange(w0 - 2, w0 + cols + 2)
                inside = ((hh >= 0) & (hh < H))[:, None] & ((ww >= 0) & (ww < W))[None, :]
                xt = torch.zeros(Rs + 2, Ws + 2, Ci)
                xt[inside] = x[b][hh.clamp(0, H - 1)][:, ww.clamp(0, W - 1)][inside].float()
                n = (xt * a[b] + c[b]).to(dt).float()
                n[~inside] = 0.0
                s = torch.zeros(Rs, Ws, Ci)
                for dy in range(3):
                    for dx in range(3):
                        s = s + n[dy:dy + Rs, dx:dx + Ws] * dw[:, dy, dx]
                t = s.to(dt).float()
                u = (t.reshape(Rs * Ws, Ci) @ pw.float().t()).to(dt).float()
                prod = u.reshape(Rs * Ws, Co, 4)  # [pixel][channel][subpixel]
                X = torch.arange(2 * w0, min(2 * w0 + 2 * cols, 2 * W))
                Y = torch.arange(2 * h0, min(2 * h0 + 2 * rows, 2 * H))

                def at(yc, xc):
                    py, px = (yc >> 1) - (h0 - 1), (xc >> 1) - (w0 - 1)
                    assert (py >= 0).all() and (py < Rs).all() and (px >= 0).all()
                    assert (px < Ws).all()
                    return prod[py[:, None] * Ws + px[None, :], :,
                                (2 * (yc & 1))[:, None] + (xc & 1)[None, :]]

                def hleg(yc):
                    acc = torch.zeros(len(yc), len(X), Co)
                    for j in range(5):
                        acc = acc + at(yc, (X + j - 2).clamp(0, 2 * W - 1)) * frame[j]
                    return acc.to(dt).float()

                acc = torch.zeros(len(Y), len(X), Co)
                for j in range(5):
                    acc = acc + hleg((Y + j - 2).clamp(0, 2 * H - 1)) * frame[j]
                out[b, Y[0]:Y[-1] + 1, X[0]:X[-1] + 1] = acc.to(dt)
    return out


@pytest.mark.parametrize("B,H,W,Ci,Co,kb,tile", [
    (2, 5, 7, 64, 64, 3, (2, 3)),      # interior tiles, ragged last row and column
    (1, 9, 11, 96, 32, 5, (4, 4)),     # half a 64-channel k block
    (2, 1, 3, 32, 64, 5, (1, 2)),      # one input row: every tile at both edges
    (1, 6, 4, 32, 32, 1, (5, 3)),      # one tap
    (1, 9, 17, 64, 32, 5, (4, 8)),     # the 64-row tile of Ci > 512
    (1, 13, 18, 64, 32, 5, None),      # the plan's own tile (one tile)
    (1, 20, 19, 32, 32, 3, None),      # the plan's own tiles (several)
])
def test_tiled_decomposition_matches_the_twin_bit_for_bit(B, H, W, Ci, Co, kb, tile):
    taps = {1: [1.0], 3: [0.25, 0.5, 0.25], 5: [1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16]}[kb]
    i = _dyadic(B, H, W, Ci, Co, seed=H * W + Ci)
    if tile is None:
        p = fu.plan(B, H, W, Ci, Co, kb)
        tile = (p["rows"], p["cols"])
    got = _emulate(**i, taps=taps, rows=tile[0], cols=tile[1])
    ref = fu.fused_upsample_blur_reference(**i, taps=taps)
    assert not torch.isnan(got.float()).any()
    assert torch.equal(got, ref)

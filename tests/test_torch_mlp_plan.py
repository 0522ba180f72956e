"""The launch plan of K1/K9 (csrc/fused_mlp.cu) through its Python mirror,
and the kernel's decomposition of the function emulated on the CPU. Pure
torch: no JAX import, a few seconds."""

import pytest
import torch
import torch.nn.functional as F

from vfm_vae_tpu_torch.ops.kernels import fused_mlp as fm
from tests.torch_threads import one_torch_thread  # noqa: F401

# (C, H) of the flagship decode's K1 sites, of the stage-0 EQ decodes (z of
# 4, 8 and 12 px: H from 2 to 192) and the card test's ragged H x W.
FLAGSHIP = [(512, 8, 8), (512, 16, 16), (512, 32, 32), (512, 64, 64), (256, 128, 128),
            (128, 256, 256)]
EQ = ([(512, h, h) for h in (2, 4, 6, 8, 12, 16, 24, 32, 48)]
      + [(256, h, h) for h in (32, 64, 96)] + [(128, h, h) for h in (64, 128, 192)])
RAGGED = [(C, h, w) for C in (128, 256, 512) for h, w in ((5, 70), (3, 2), (1, 3))]
SITES = sorted(set(FLAGSHIP + EQ + RAGGED))


@pytest.mark.parametrize("B", [2, 4, 32])
def test_plan_covers_every_sample_token_and_hidden_column_once(B):
    """Over the CTAs of the grid, the token tiles of each sample partition
    [0, HW) (a tile never straddles two samples) and, within a tile, the
    split's ranks partition the 4C hidden columns into 64-column chunks, at
    every K1 site: so every (sample, token, hidden column) is computed once."""
    for C, H, W in SITES:
        HW = H * W
        for pipelined in (False, True):
            p = fm.plan(B, HW, C, pipelined)
            assert p["ctas"] == p["tiles"] * p["split"] and p["chunks"] * p["split"] == C // 16
            tiles = {}
            for cta in range(p["ctas"]):
                b, t0, t1, h0, h1 = fm.cta_work(p, HW, cta)
                assert 0 <= b < B and 0 <= t0 < t1 <= HW and t1 - t0 <= p["rows"]
                tiles.setdefault((b, t0, t1), []).append((h0, h1))
            for b in range(B):
                spans = sorted((t0, t1) for (bb, t0, t1) in tiles if bb == b)
                assert spans[0][0] == 0 and spans[-1][1] == HW, (C, H, W, b)
                assert all(a[1] == c[0] for a, c in zip(spans, spans[1:])), (C, H, W, b)
            for key, hs in tiles.items():
                hs.sort()
                assert hs[0][0] == 0 and hs[-1][1] == 4 * C, (C, H, W, key)
                assert all(a[1] == c[0] for a, c in zip(hs, hs[1:])), (C, H, W, key)


@pytest.mark.parametrize("C", [128, 256, 512])
def test_plan_fits_shared_memory_and_the_ring_can_be_walked(C):
    """232,448 bytes of shared memory a block; the ring holds the 2 C / 64
    weight sub-tiles a warpgroup keeps in flight (one chunk's W1 and W2),
    and the space of x, the hidden buffers and the ring holds the
    epilogue's fp32 partial (rows x (C + 8) floats)."""
    for B, HW in ((2, 64), (2, 4096), (32, 65536), (1, 3)):
        p = fm.plan(B, HW, C)
        assert p["smem_bytes"] <= 232448
        assert p["stages"] >= 2 * C // 64
        x = p["rows"] // 64 * C // 64 * fm.SUB_TILE
        hidden = 2 * fm.SUB_TILE if C == 512 else 0
        assert p["rows"] * (C + 8) * 4 <= x + hidden + p["stages"] * fm.SUB_TILE
        assert p["threads"] == 384 and p["consumers"] == 2
        assert p["rows"] == (64 if C == 512 else 128)


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_plan_splits_only_when_the_tiles_leave_sms_idle(sms):
    """split = 1 once 2 x tiles > sms; otherwise split doubles while 2 x
    tiles x split <= sms (up to 8), so the split CTAs fill at most one wave
    and more than half of it (unless the split is at its largest)."""
    for B in (1, 2, 4, 32):
        for C, H, W in SITES:
            p = fm.plan(B, H * W, C, sms=sms)
            tiles, split = p["tiles"], p["split"]
            if 2 * tiles > sms:
                assert split == 1, (B, C, H, W)
                continue
            assert tiles * split <= sms and split & (split - 1) == 0
            assert split == 8 or 2 * tiles * split > sms, (B, C, H, W)
            assert p["chunks"] >= 1


@pytest.mark.parametrize("C", [64, 192, 384, 1024])
def test_plan_refuses_other_widths(C):
    with pytest.raises(ValueError):
        fm.plan(2, 64, C)
    with pytest.raises(ValueError):
        fm.plan(0, 64, 128)


def _emulate(x, x_in, A, d, w1, b1, w2, b2, gamma, sms=132):
    """The kernel's decomposition in fp32 on the CPU: per CTA of the plan, a
    token tile (zero rows past HW) and its hidden chunks of 64 columns:
    GEMM1 over C, d, b1 and the GELU, the hidden rounded to bf16, GEMM2 into
    the tile's fp32 partial; the split's partials summed in rank order; then
    (+ b2) * gamma + x_in, rounded to bf16."""
    B, H, W, C = x.shape
    HW, dt = H * W, x.dtype
    p = fm.plan(B, HW, C, sms=sms)
    rows = p["rows"]
    xf = x.reshape(B, HW, C).float()
    partial = {}
    for cta in range(p["ctas"]):
        b, t0, t1, h0, h1 = fm.cta_work(p, HW, cta)
        xs = torch.zeros(rows, C)
        xs[: t1 - t0] = (xf[b, t0:t1] * A[b]).to(dt).float()
        acc = torch.zeros(rows, C)
        for j in range(h0, h1, 64):
            hcol = slice(j, j + 64)
            h = xs @ w1[hcol].float().t()
            a = F.gelu(torch.addcmul(b1[b, hcol], h, d[b, hcol])).to(dt).float()
            acc += a @ w2[:, hcol].float().t()
        partial.setdefault((b, t0, t1), []).append(acc)
    out = torch.empty(B, HW, C, dtype=dt)
    for (b, t0, t1), parts in partial.items():
        y = parts[0]
        for q in parts[1:]:
            y = y + q
        y = (y[: t1 - t0] + b2) * gamma + x_in.reshape(B, HW, C)[b, t0:t1].float()
        out[b, t0:t1] = y.to(dt)
    return out.reshape(B, H, W, C)


@pytest.mark.parametrize("C,H,W", [(128, 5, 70), (512, 3, 2), (256, 16, 16)])
def test_split_decomposition_matches_the_twin(C, H, W):
    """The chunked, split, rank-ordered decomposition against
    fused_convnext_mlp_reference in bf16: the two round at the same points
    (x * A, the hidden, the output) and differ only in the fp32 order of the
    sums over C, over the hidden's chunks and over the split's partials, so
    a hidden value on a rounding boundary may land one bf16 ulp apart and an
    output value one ulp: max |diff| <= 2^-7 of max |twin| (one ulp at the
    top of the range) and mean |diff| <= 2e-3 of mean |twin|
    (TOLERANCES["fused_convnext_mlp"] of chip_smoke.py)."""
    g = torch.Generator().manual_seed(C + H)
    bf = torch.bfloat16

    def rn(*s, scale=1.0):
        return torch.randn(s, generator=g) * scale

    B = 2
    args = dict(x=rn(B, H, W, C).to(bf), x_in=rn(B, H, W, C).to(bf),
                A=rn(B, C).abs() + 0.5, d=rn(B, 4 * C).abs() + 0.5,
                w1=rn(4 * C, C, scale=C ** -0.5).to(bf), b1=rn(B, 4 * C),
                w2=rn(C, 4 * C, scale=(4 * C) ** -0.5).to(bf), b2=rn(C), gamma=rn(C))
    assert fm.plan(B, H * W, C)["split"] > 1
    got = _emulate(**args).float()
    ref = fm.fused_convnext_mlp_reference(**args).float()
    diff = (got - ref).abs()
    assert float(diff.max()) <= 2.0 ** -7 * float(ref.abs().max())
    assert float(diff.mean()) <= 2e-3 * float(ref.abs().mean())


def test_kernel_gelu_is_within_7e6_of_the_exact_gelu():
    """The kernel's tanh-form GELU, evaluated in fp32 on a dense grid of
    2,400,001 points over [-12, 12] (and at +-1e4), against the exact GELU in
    fp64 (0.5 h (1 + erf(h / sqrt 2))): |err| <= 7e-6, the accuracy class of
    the TPU kernel's own _gelu_poly (whose coefficients measure 7.0e-6 here).
    The kernel's ex2.approx and __fdividef add at most ~2 fp32 ulps (<= 2.4e-7
    |GELU|), inside the margin of this fit (3.4e-6)."""
    h = torch.cat([torch.linspace(-12.0, 12.0, 2_400_001), torch.tensor([-1e4, 1e4])])
    exact = 0.5 * h.double() * (1.0 + torch.erf(h.double() / 2.0 ** 0.5))
    err = (fm.gelu_poly(h).double() - exact).abs()
    assert float(err.max()) <= 7e-6
    assert float(err.max()) <= 4e-6  # the fit's own error, with rounding


"""K2: fused pre-normalized SeparableUpsampleWithFixedBlur: GN affine ->
depthwise 3x3 -> pointwise Ci -> 4Co -> PixelShuffle(2) -> separable
edge-replicate blur (both legs).

Replaces the TPU kernel vfm_vae_tpu/ops/pallas/fused_upsample.py:_fused
(body `_kernel`) and its plain-XLA vertical leg `_vblur`; the plain twin
below follows `_forward_jnp` + `_vblur`.

On the H100 the pointwise product bounds the 512-channel sites (tensor
cores) and the output write bounds the 256 -> 128 top site (memory). The
kernel (csrc/fused_upsample.cu) is one launch: a CTA owns one sample's tile
of R x Wb input pixels, computes the affine and the 3x3 stencil once for
the tile and a one-pixel ring (x by TMA, two pixels of halo) into a
resident bf16 A operand in shared memory, streams pw through a TMA ring and
walks all 4Co GEMM columns in N tiles of 128 on wgmma, and applies the
shuffle and both blur legs to each N tile's bf16 product in shared memory
(the horizontal leg into a second buffer, the vertical leg from it) before
it stores the final (2R, 2Wb, 32) box. No intermediate reaches
device memory. `plan` mirrors the launch plan (vfm_fused_upsample_plan).

Weights use the torch layout: dw (Ci, 3, 3), pw (4Co, Ci) with output
channel c*4 + q for subpixel q.

Gradients: `FusedUpsampleBlur` is the port of the JAX custom VJP
(vfm_vae_tpu/ops/pallas/fused_upsample.py:258-276) widened to both legs,
since the vertical leg is a kernel here: its forward is the K2 kernel, its
backward recomputes the plain twin under autograd and pulls its VJP, as
`_fused_bwd` does with jax.vjp(_forward_jnp).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from ..pixelshuffle import pixel_shuffle
from ._build import call_on, check_all, library, refuse_grad


def edge_blur(s: torch.Tensor, taps: Sequence[float], dim: int) -> torch.Tensor:
    """fp32 edge-replicate 1-D blur of an NHWC map along `dim` (1 or 2),
    taps accumulated in order, rounded back to the input dtype. An even
    number of taps pads one more on the far side, as the JAX package's
    plain form does (convnext.py:302-305)."""
    kb = len(taps)
    hb = (kb - 1) // 2
    n = s.shape[dim]
    idx = torch.clamp(torch.arange(-hb, n + kb - 1 - hb, device=s.device), 0, n - 1)
    sp = s.index_select(dim, idx).float()
    acc = torch.zeros(s.shape, dtype=torch.float32, device=s.device)
    for j in range(kb):
        acc = acc + sp.narrow(dim, j, n) * float(taps[j])
    return acc.to(s.dtype)


def fused_upsample_blur_reference(x, a, c, dw, pw, taps):
    """Plain PyTorch twin with the kernel's rounding points."""
    B, H, W, Ci = x.shape
    Co = pw.shape[0] // 4
    dt = x.dtype
    xn = (x.float() * a[:, None, None, :].float() + c[:, None, None, :].float()).to(dt)
    t = F.conv2d(xn.float().permute(0, 3, 1, 2), dw.float()[:, None], padding=1, groups=Ci)
    t = t.permute(0, 2, 3, 1).to(dt)
    u = (t.float().reshape(B, H * W, Ci) @ pw.to(dt).float().t()).to(dt)
    s = pixel_shuffle(u.reshape(B, H, W, 4 * Co), 2)
    return edge_blur(edge_blur(s, taps, 2), taps, 1)


# The kernel's constants (csrc/fused_upsample.cu): threads a CTA, the
# shared-memory budget, the alignment slack, the barriers' bytes, one ring
# stage (128 pw rows x 64 channels, bf16), the budget of the resident A
# operand and the bytes of an x box's parameters a channel (9 taps, a, c).
THREADS = 384
SMEM_MAX = 232448
SLACK = 1024
BAR_BYTES = 512
STAGE = 128 * 128
A_BUDGET = 131072
PARAM_BYTES = 44
PLAN_KEYS = ("rows", "cols", "tiles_h", "tiles_w", "tiles", "split", "ctas", "mpad", "kc",
             "chunks", "xc", "stages", "smem_bytes", "threads", "launches")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align1k(v: int) -> int:
    return (v + 1023) // 1024 * 1024


def part_channels(mpad: int) -> int:
    """Output channels of an epilogue part: 8 at 256 GEMM rows, else 16."""
    return 8 if mpad == 256 else 16


def plan(B: int, H: int, W: int, Ci: int, Co: int, kb: int, sms: int = 132) -> dict:
    """The launch plan of K2 for x (B, H, W, Ci), pw (4Co, Ci) and `kb` taps on
    a card with `sms` SMs, as the C side computes it (vfm_fused_upsample_plan):
    - a tile of `rows` x `cols` input pixels whose stencil, with a one-pixel
      ring, takes (rows + 2)(cols + 2) GEMM rows padded to `mpad` (128, or
      256 where A fits: Ci <= 256; 64 at Ci > 512, so that A holds up to
      1024 channels); the tile minimizes the padded rows over
      the image (tiles x mpad), then the x pixels loaded ((rows + 4)(cols + 4)
      a tile), the first found in order of rows, then cols;
    - `tiles` = B x tiles_h x tiles_w; the 4Co GEMM columns in Co / 32 N tiles
      of 128, split `split` ways (a power of two, doubled while 2 x split is
      at most the N tiles and 2 x tiles x split <= sms): `ctas` CTAs;
    - A holds `kc` input channels (all of Ci, rounded up to 64, when mpad x
      Ci x 2 bytes fit 128 KB; else 1024 at a time, in `chunks` chunks);
    - the epilogue region holds the product buffer of a part (mpad rows of
      4 x part_channels bf16 + 16 bytes) and Hs (2 rows + 4 output rows x
      2 cols columns of them); x boxes of `xc` channels (64 unless that leaves
      the ring under 3 stages, then 32) with their parameters, in two slots
      that share the epilogue region's space when one chunk holds Ci;
    - the ring of 16 KB pw stages takes what shared memory leaves;
    - one kernel launch a call (`launches`)."""
    if (min(B, H, W, Ci, Co) <= 0 or Ci % 32 or Co % 32 or kb not in (1, 3, 5)
            or sms <= 0):
        raise ValueError(f"fused_upsample_blur plan: B={B} H={H} W={W} Ci={Ci} Co={Co} kb={kb}")
    ci64 = _cdiv(Ci, 64) * 64
    mmax = 256 if ci64 <= 256 else 128 if ci64 <= 512 else 64
    mmin = 64 if mmax == 64 else 128
    best = None
    r = 1
    while r <= H and (r + 2) * 3 <= mmax:
        w = 1
        while w <= W and (r + 2) * (w + 2) <= mmax:
            t = _cdiv(H, r) * _cdiv(W, w)
            key = (t * (mmin if (r + 2) * (w + 2) <= mmin else 256), t * (r + 4) * (w + 4))
            if best is None or key < best[0]:
                best = (key, r, w)
            w += 1
        r += 1
    _, rows, cols = best
    mpad = mmin if (rows + 2) * (cols + 2) <= mmin else 256
    tiles_h, tiles_w = _cdiv(H, rows), _cdiv(W, cols)
    tiles = B * tiles_h * tiles_w
    kc = ci64 if mpad * ci64 * 2 <= A_BUDGET else A_BUDGET // (mpad * 2) // 64 * 64
    chunks = _cdiv(ci64, kc)
    split = 1
    while split * 2 <= Co // 32 and 2 * tiles * split <= sms:
        split *= 2
    a_bytes = mpad * kc * 2
    cg = part_channels(mpad)
    epi = _align1k(mpad * (8 * cg + 16) + (2 * rows + 4) * 2 * cols * cg * 2)
    for xc in (64, 32):
        x_bytes = _align1k((rows + 4) * (cols + 4) * xc * 2 + xc * PARAM_BYTES)
        e_bytes = max(epi, 2 * x_bytes) if chunks == 1 else epi + 2 * x_bytes
        stages = (SMEM_MAX - SLACK - a_bytes - e_bytes - BAR_BYTES) // STAGE
        if stages >= 3:
            break
    return dict(rows=rows, cols=cols, tiles_h=tiles_h, tiles_w=tiles_w, tiles=tiles,
                split=split, ctas=tiles * split, mpad=mpad, kc=kc, chunks=chunks, xc=xc,
                stages=stages, smem_bytes=SLACK + a_bytes + e_bytes + stages * STAGE + BAR_BYTES,
                threads=THREADS, launches=1)


def cta_work(p: dict, H: int, W: int, Co: int, cta: int):
    """(sample, input rows [h0, h1), input columns [w0, w1), output channels
    [c0, c1)) that CTA `cta` of plan `p` stores: CTA c takes tile c // split
    (tiles of one sample row by row, then the next sample) and N tiles
    [r n / split, (r + 1) n / split) of the n = Co / 32 for its rank r =
    c % split; the tile's rows and columns past the image are not stored."""
    tile, rank = divmod(cta, p["split"])
    per_img = p["tiles_h"] * p["tiles_w"]
    b, t = divmod(tile, per_img)
    th, tw = divmod(t, p["tiles_w"])
    h0, w0 = th * p["rows"], tw * p["cols"]
    n = Co // 32
    return (b, h0, min(h0 + p["rows"], H), w0, min(w0 + p["cols"], W),
            32 * (rank * n // p["split"]), 32 * ((rank + 1) * n // p["split"]))


def _launch(x, a, c, dw, pw, taps):
    name = "fused_upsample_blur"
    refuse_grad(name, x, a, c, dw, pw)
    B, H, W, Ci = x.shape
    Co = pw.shape[0] // 4
    if Ci % 32 or Co % 32 or len(taps) not in (1, 3, 5):
        raise ValueError(f"{name}: unsupported Ci={Ci} Co={Co} taps={len(taps)}")
    dev = x.device
    check_all(name, torch.bfloat16, dev, [(x, "x", (B, H, W, Ci)), (pw, "pw", (4 * Co, Ci))])
    check_all(name, torch.float32, dev, [(a, "a", (B, Ci)), (c, "c", (B, Ci)),
                                         (dw, "dw", (Ci, 3, 3))])
    lib = library()
    out = torch.empty((B, 2 * H, 2 * W, Co), dtype=torch.bfloat16, device=dev)
    taps_c = (ctypes.c_float * len(taps))(*taps)
    err = call_on(dev, lib.lib.vfm_fused_upsample_blur, x.data_ptr(), a.data_ptr(), c.data_ptr(),
                  dw.data_ptr(), pw.data_ptr(), ctypes.addressof(taps_c), len(taps),
                  out.data_ptr(), B, H, W, Ci, Co)
    lib.check(err, name)
    fused_upsample_blur.launches += 1
    return out


def _forward(x, a, c, dw, pw, taps, plain: bool):
    if plain or x.device.type == "cpu":
        return fused_upsample_blur_reference(x, a, c, dw, pw, taps)
    return _launch(x, a, c, dw, pw, taps)


class FusedUpsampleBlur(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, c, dw, pw, taps, plain: bool):
        ctx.save_for_backward(x, a, c, dw, pw)
        ctx.taps = taps
        return _forward(x, a, c, dw, pw, taps, plain)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = fused_upsample_blur_reference(*inputs, ctx.taps)
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(got) if t.requires_grad else None for t in inputs), None, None)


def fused_upsample_blur(x, a, c, dw, pw, taps: Sequence[float], *, plain: bool = False):
    """x (B, H, W, Ci); a, c (B, Ci) folded GN affine; dw (Ci, 3, 3); pw
    (4Co, Ci); taps: normalized odd-length 1-D blur (<= 5 taps). Returns
    (B, 2H, 2W, Co). CPU tensors (or plain=True) run the twin; CUDA tensors
    launch the kernel: bf16 x and pw, fp32 a, c, dw, Ci and Co multiples
    of 32. Differentiable through FusedUpsampleBlur."""
    taps = [float(v) for v in taps]
    args = (x, a, c, dw, pw)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedUpsampleBlur.apply(*args, taps, plain)
    return _forward(*args, taps, plain)


fused_upsample_blur.launches = 0

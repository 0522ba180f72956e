"""K7: depthwise k x k SAME convolution + bias + legacy noise, with the fp32
moment sums of its rounded output; K8: the same convolution + bias alone.

K7 replaces the TPU kernel vfm_vae_tpu/ops/pallas/dwconv_stats.py:_fused
(`dwconv_noise_stats` :198); its twin is that file's `_forward_jnp`: the
fp32 accumulator rounded to the activation dtype, then the bias and the
noise added in that dtype, and the statistics taken of the rounded values.
K8 replaces vfm_vae_tpu/ops/pallas/dwconv.py:_dwconv_same
(`depthwise_conv2d_same` :103): the bias added in fp32 before the one
rounding. `dwconv_stats_eligible` and `pallas_dw_eligible` are the JAX
rules without their TPU-backend test.

Neither is wired into the model: the JAX package runs neither on a model
path (both are measured losses on the TPU, kept opt-in), so the port runs
them only as the dwconv probe of chip_smoke.py, at every ConvNeXt dwconv
shape of a decode (entry.kernel_sites).

On the H100 both run on one kernel template (csrc/dwconv_stats.cu), near
the fp32 ridge: 2 k^2 CUDA-core flops per 4 bytes of bf16 traffic. One
launch a call: persistent CTAs walk runs of tiles (64 channels x 16 x 16
pixels, or 256 x 8 x 8 on maps of at most 8 x 8); warp 0 TMA-loads each
tile and its halo into a ring of 2-3 stages, two tiles ahead, and the 16
warps hold one channel's k^2 weights and an 8 x 4 block of outputs per
thread. K7's statistics fold in the same launch: one fp32 partial per
segment (the tiles of a (sample, channel block) that one CTA walks in a
row), added in tile order in fp64 by the CTA that completes the block's
counter. `plan` mirrors the launch plan (vfm_dwconv_plan), `cta_tiles` and
`tile_work` the walk, `segments` the partials' order and `emulate_stats`
the whole reduction on the CPU. The workspace (partials and counters) is
kept per (device, stream), as K5's.

Gradients: `DwconvNoiseStats` carries the JAX custom VJP `_fused_bwd`
(dwconv_stats.py:189: jax.vjp of `_forward_jnp`) as autograd of the twin.
K8 has no custom VJP in the JAX package and is forward only here.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import call_on, check_all, check_tensor, library, refuse_grad, stream_workspace

# The kernel's constants (csrc/dwconv_stats.cu): output rows and columns a
# compute thread, threads a CTA (16 warps, all computing), ring stages,
# shared memory a block, the alignment slack, the statistics' fp64 buffers
# and the barriers.
ROWS, COLS = 8, 4
THREADS = 512
MAX_STAGES = 3
SMEM_MAX = 232448
ALIGN = 128
RED_BYTES = 2 * 2 * THREADS * 8
BAR_BYTES = 64
PLAN_KEYS = ("cb", "th", "tw", "tiles_h", "tiles_w", "n_cb", "tiles", "ctas", "stages",
             "stage_bytes", "smem_bytes", "threads", "part_floats", "counters", "launches")
# (device index, raw stream) -> (fp32 partials, int32 counters): K7's
# workspace, one per stream (calls on a stream run in order).
_WORKSPACES: dict = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, H: int, W: int, C: int, k: int, stats: bool, sms: int = 132) -> dict:
    """The launch plan of K7 (stats) or K8 for x (B, H, W, C) and a k x k
    kernel on a card with `sms` SMs, as the C side computes it
    (vfm_dwconv_plan):
    - a tile is `cb` channels x `th` x `tw` output pixels: 256 x 8 x 8 where
      the map fits one tile (H, W <= 8) and C % 256 == 0, else 64 x 16 x 16;
      `tiles` = B x C / cb x tiles_h x tiles_w, walked with columns fastest,
      then rows, channel blocks and samples;
    - `ctas` = min(tiles, sms) persistent CTAs of `threads` threads (16
      compute warps; warp 0 also fills the ring), CTA i taking the run of tiles
      [i tiles / ctas, (i + 1) tiles / ctas) (cta_tiles);
    - a ring stage holds a tile's input with its k - 1 halo (cb / 64 boxes of
      64 channels x (tw + k - 1) x (th + k - 1), bf16) and, for K7, its fp32
      noise (th x tw, to 128 bytes); up to 3 stages beside the statistics'
      buffer and the barriers;
    - K7's workspace: `part_floats` fp32 partials (2, B, C / cb, tiles_h x
      tiles_w, cb), one slot a tile of which each segment (segments) fills
      the first, and `counters` (B, C / cb) counters;
    - one kernel launch a call."""
    if min(B, H, W, C) <= 0 or C % 64 or k not in ((3, 5, 7) if not stats else (5, 7)) \
            or sms <= 0:
        raise ValueError(f"dwconv plan: B={B} H={H} W={W} C={C} k={k} stats={stats}")
    small = H <= 8 and W <= 8 and C % 256 == 0
    cb, th = (256, 8) if small else (64, 16)
    tw = th
    x_bytes = (cb // 64) * (th + k - 1) * (tw + k - 1) * 64 * 2
    stage = x_bytes + (_cdiv(th * tw * 4, ALIGN) * ALIGN if stats else 0)
    fixed = ALIGN + (RED_BYTES if stats else 0) + BAR_BYTES
    stages = min(MAX_STAGES, (SMEM_MAX - fixed) // stage)
    tiles_h, tiles_w, n_cb = _cdiv(H, th), _cdiv(W, tw), C // cb
    tiles = B * n_cb * tiles_h * tiles_w
    return dict(cb=cb, th=th, tw=tw, tiles_h=tiles_h, tiles_w=tiles_w, n_cb=n_cb, tiles=tiles,
                ctas=min(tiles, sms), stages=stages, stage_bytes=stage,
                smem_bytes=fixed + stages * stage, threads=THREADS,
                part_floats=2 * B * C * tiles_h * tiles_w if stats else 0,
                counters=B * n_cb if stats else 0, launches=1, x_bytes=x_bytes)


def cta_tiles(p: dict, cta: int) -> range:
    """The run of tiles that CTA `cta` of plan `p` walks, in order."""
    return range(cta * p["tiles"] // p["ctas"], (cta + 1) * p["tiles"] // p["ctas"])


def tile_work(p: dict, t: int):
    """(sample, channel block, tile row, tile column) of tile `t`."""
    t, tw = divmod(t, p["tiles_w"])
    t, th = divmod(t, p["tiles_h"])
    b, cb = divmod(t, p["n_cb"])
    return b, cb, th, tw


def segments(p: dict, blk: int):
    """The segments of block `blk` (sample x C / cb + channel block): the runs
    of its tiles [blk nsp, (blk + 1) nsp) that one CTA walks in a row, as
    (first tile, tiles) within the block, in tile order. Each segment's
    partial sits in the slot of its first tile; the block's sums are the
    partials added in this order in fp64."""
    nsp = p["tiles_h"] * p["tiles_w"]
    t0, t1 = blk * nsp, (blk + 1) * nsp
    cuts = sorted({t0} | {k * p["tiles"] // p["ctas"] for k in range(p["ctas"] + 1)
                          if t0 < k * p["tiles"] // p["ctas"] < t1} | {t1})
    return [(a - t0, b - a) for a, b in zip(cuts[:-1], cuts[1:])]


def emulate_stats(t: torch.Tensor, p: dict):
    """K7's statistics of its output t (B, H, W, C) as the kernel adds them
    (CPU): each compute thread sums its ROWS x COLS block's valid outputs of
    a tile in row order in fp32 (s2 by an FMA: t^2 is exact in fp32) and its
    tile sums over a segment (segments) in tile order in fp64; a segment's
    pixel blocks are added in order in fp64 and rounded to an fp32 partial,
    and a block's partials are added in tile order in fp64 (a block of one
    segment keeps its fp64 sum). -> s1, s2 (B, C) fp32."""
    B, H, W, C = t.shape
    th, tw, cb = p["th"], p["tw"], p["cb"]
    TH, TW = p["tiles_h"], p["tiles_w"]
    tp = torch.zeros((B, TH * th, TW * tw, C), dtype=torch.float32)
    tp[:, :H, :W] = t.float()  # outside the map: +0, which adds nothing
    # (B, tile row, block row, row, tile col, block col, col, C)
    v = tp.reshape(B, TH, th // ROWS, ROWS, TW, tw // COLS, COLS, C)
    out = []
    for sq in (False, True):
        acc = torch.zeros((B, TH, th // ROWS, TW, tw // COLS, C), dtype=torch.float32)
        for o in range(ROWS):
            for j in range(COLS):
                e = v[:, :, :, o, :, :, j]
                acc = acc + (e * e if sq else e)
        # (B, tile, pixel block, C): tile = tile row x TW + tile col, pixel
        # block = block row x (tw / COLS) + block col
        thr = acc.permute(0, 1, 3, 2, 4, 5).reshape(B, TH * TW, -1, C).double()
        s = torch.empty((B, C), dtype=torch.float32)
        for b in range(B):
            for k in range(C // cb):
                ch = slice(k * cb, (k + 1) * cb)
                tot = None
                for j0, n in segments(p, b * (C // cb) + k):
                    slots = thr[b, j0, :, ch]
                    for j in range(j0 + 1, j0 + n):
                        slots = slots + thr[b, j, :, ch]
                    d = torch.zeros(cb, dtype=torch.float64)
                    for pb in range(slots.shape[0]):
                        d = d + slots[pb]
                    if n == TH * TW:
                        tot = d
                        break
                    part = d.float().double()
                    tot = part if tot is None else tot + part
                s[b, ch] = tot.float()
        out.append(s)
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def _stats_workspace(B: int, H: int, W: int, C: int, k: int):
    """(partial floats, counters) of K7's plan for this shape."""
    p = plan(B, H, W, C, k, True)
    return p["part_floats"], p["counters"]


def _depthwise_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 depthwise SAME convolution of NHWC x with w (k, k, C)."""
    k, C = w.shape[0], w.shape[-1]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(2, 0, 1)[:, None],
                 padding=k // 2, groups=C)
    return y.permute(0, 2, 3, 1)


def dwconv_noise_stats_reference(x, w, b, noise: Optional[torch.Tensor] = None):
    """Plain twin of K7 (dwconv_stats.py:_forward_jnp): t = round(conv(x,
    round(w))) + b (+ noise), each add in x's dtype; s1, s2 the fp32 sums of t
    and t^2 over (H, W). x (B, H, W, C), w (k, k, C), b (C,), noise (H, W)."""
    dt = x.dtype
    t = _depthwise_fp32(x, w.to(dt)).to(dt)
    t = t + b.to(dt)
    if noise is not None:
        t = t + noise.to(dt)[None, :, :, None]
    tf = t.float()
    return t, tf.sum(dim=(1, 2)), tf.square().sum(dim=(1, 2))


def depthwise_conv2d_same_reference(x, w, b: Optional[torch.Tensor] = None):
    """Plain twin of K8 (dwconv.py:_dw_kernel): fp32 conv (+ fp32 bias),
    rounded once to x's dtype. w (k, k, 1, C) HWIO."""
    y = _depthwise_fp32(x, w[:, :, 0, :])
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def dwconv_stats_eligible(x: torch.Tensor, k: int) -> bool:
    """dwconv_stats.py:dwconv_stats_eligible without its TPU test."""
    if os.environ.get("VFM_VAE_DISABLE_PALLAS_DWSTATS") == "1":
        return False
    return x.shape[-1] % 128 == 0 and k in (5, 7) and x.shape[1] >= k // 2


def pallas_dw_eligible(x: torch.Tensor, kernel_size: int, stride: int, padding, groups: int,
                       in_channels: int, out_channels: int) -> bool:
    """dwconv.py:pallas_dw_eligible without its TPU test."""
    if os.environ.get("VFM_VAE_DISABLE_PALLAS_DW") == "1":
        return False
    if not (groups == in_channels == out_channels):
        return False
    if stride != 1 or kernel_size % 2 == 0 or padding != kernel_size // 2:
        return False
    return x.shape[-1] % 128 == 0 and x.shape[1] >= 8


def _check_x(x, name: str, ks: tuple):
    if x.dim() != 4 or x.dtype != torch.bfloat16 or x.shape[-1] % 64:
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype}; the kernel takes a bf16 "
                         "(B, H, W, C) map with C a multiple of 64")
    if ks[0] != ks[1] or ks[0] not in (3, 5, 7) or (name == "dwconv_noise_stats" and ks[0] == 3):
        raise ValueError(f"{name}: kernel {ks} not covered")
    B, H, W, C = x.shape
    check_tensor(x, "x", torch.bfloat16, (B, H, W, C), x.device)
    return B, H, W, C, x.device


def _launch_stats(x, w, b, noise):
    refuse_grad("dwconv_noise_stats", x, w, b, *(() if noise is None else (noise,)))
    B, H, W, C, dev = _check_x(x, "dwconv_noise_stats", tuple(w.shape[:2]))
    k = w.shape[0]
    check_all("dwconv_noise_stats", torch.float32, dev,
              [(w, "w", (k, k, C)), (b, "b", (C,))]
              + ([] if noise is None else [(noise, "noise", (H, W))]))
    lib = library()
    part, counters = stream_workspace(_WORKSPACES, dev, *_stats_workspace(B, H, W, C, k))
    out = torch.empty_like(x)
    s = torch.empty((2, B, C), dtype=torch.float32, device=dev)
    err = call_on(dev, lib.lib.vfm_dwconv_noise_stats, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                  None if noise is None else noise.data_ptr(), out.data_ptr(), part.data_ptr(),
                  counters.data_ptr(), s.data_ptr(), B, H, W, C, k)
    lib.check(err, "dwconv_noise_stats")
    dwconv_noise_stats.launches += 1
    return out, s[0], s[1]


def _forward_stats(x, w, b, noise, plain: bool):
    if plain or x.device.type == "cpu":
        return dwconv_noise_stats_reference(x, w, b, noise)
    return _launch_stats(x, w, b, noise)


class DwconvNoiseStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, noise, plain: bool):
        ctx.save_for_backward(x, w, b, noise)
        return _forward_stats(x, w, b, noise, plain)

    @staticmethod
    def backward(ctx, gt, g1, g2):
        x, w, b, noise = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() if t is not None else None for t in (x, w, b, noise)]
        inputs = [t for t in leaves if t is not None]
        with torch.enable_grad():
            outs = dwconv_noise_stats_reference(*leaves)
            grads = torch.autograd.grad(outs, inputs, (gt, g1, g2), allow_unused=True)
        grads = list(grads) + [None] * (4 - len(grads))
        return (*grads, None)


def dwconv_noise_stats(x, w, b, noise: Optional[torch.Tensor] = None, *, plain: bool = False):
    """x (B, H, W, C), w (k, k, C) depthwise kernel, b (C,), noise (H, W)
    pre-scaled fp32 map or None -> (t, s1, s2): t in x's dtype, s1 and s2
    (B, C) fp32. CPU tensors (or plain=True) run the twin; CUDA tensors
    launch the kernel: bf16 x, fp32 w, b and noise, C a multiple of 64, k
    in (5, 7). Differentiable through DwconvNoiseStats."""
    args = (x, w, b) + (() if noise is None else (noise,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return DwconvNoiseStats.apply(x, w, b, noise, plain)
    return _forward_stats(x, w, b, noise, plain)


def depthwise_conv2d_same(x, w, b: Optional[torch.Tensor] = None, *, plain: bool = False):
    """x (B, H, W, C), w (k, k, 1, C) HWIO, b (C,) or None -> (B, H, W, C).
    CPU tensors (or plain=True) run the twin; CUDA tensors launch the
    kernel: bf16 x, C a multiple of 64, k in (3, 5, 7). Forward only."""
    if plain or x.device.type == "cpu":
        return depthwise_conv2d_same_reference(x, w, b)
    refuse_grad("depthwise_conv2d_same", x, w, *(() if b is None else (b,)))
    B, H, W, C, dev = _check_x(x, "depthwise_conv2d_same", tuple(w.shape[:2]))
    k = w.shape[0]
    check_tensor(w, "w", w.dtype, (k, k, 1, C), dev)
    if b is not None:
        check_tensor(b, "b", b.dtype, (C,), dev)
    lib = library()
    wf = w.float().reshape(k, k, C).contiguous()
    bf = None if b is None else b.float().contiguous()
    out = torch.empty_like(x)
    err = call_on(dev, lib.lib.vfm_depthwise_conv2d_same, x.data_ptr(), wf.data_ptr(),
                  None if bf is None else bf.data_ptr(), out.data_ptr(), B, H, W, C, k)
    lib.check(err, "depthwise_conv2d_same")
    depthwise_conv2d_same.launches += 1
    return out


dwconv_noise_stats.launches = 0
depthwise_conv2d_same.launches = 0

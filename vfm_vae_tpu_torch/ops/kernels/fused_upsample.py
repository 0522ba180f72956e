"""K2: fused pre-normalized SeparableUpsampleWithFixedBlur: GN affine ->
depthwise 3x3 -> pointwise Ci -> 4Co -> PixelShuffle(2) -> separable
edge-replicate blur (both legs).

Replaces the TPU kernel vfm_vae_tpu/ops/pallas/fused_upsample.py:_fused
(body `_kernel`) and its plain-XLA vertical leg `_vblur`; the plain twin
below follows `_forward_jnp` + `_vblur`.

On the H100 the pointwise product bounds the wider sites (compute) and the
output write bounds the 128-channel top site (memory). The kernel
(csrc/fused_upsample.cu) computes the affine and the stencil while staging
the GEMM's A tile, keeps the bf16 product tile with a one-pixel halo in
shared memory, and applies the shuffle and the horizontal leg there; a
second small kernel applies the vertical leg, which couples rows across
CTAs. The shuffled, horizontally blurred map is the one intermediate that
reaches device memory.

Weights use the torch layout: dw (Ci, 3, 3), pw (4Co, Ci) with output
channel c*4 + q for subpixel q.

Gradients: `FusedUpsampleBlur` is the port of the JAX custom VJP
(vfm_vae_tpu/ops/pallas/fused_upsample.py:258-276) widened to both legs,
since the vertical leg is a kernel here: its forward is the K2 kernels, its
backward recomputes the plain twin under autograd and pulls its VJP, as
`_fused_bwd` does with jax.vjp(_forward_jnp).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from ..pixelshuffle import pixel_shuffle
from ._build import check_tensor, library, refuse_grad


def edge_blur(s: torch.Tensor, taps: Sequence[float], dim: int) -> torch.Tensor:
    """fp32 edge-replicate 1-D blur of an NHWC map along `dim` (1 or 2),
    taps accumulated in order, rounded back to the input dtype."""
    kb = len(taps)
    hb = kb // 2
    n = s.shape[dim]
    idx = torch.clamp(torch.arange(-hb, n + hb, device=s.device), 0, n - 1)
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


def _launch(x, a, c, dw, pw, taps):
    refuse_grad("fused_upsample_blur", x, a, c, dw, pw)
    B, H, W, Ci = x.shape
    Co = pw.shape[0] // 4
    if Ci % 32 or Co % 32 or len(taps) % 2 == 0 or len(taps) > 5:
        raise ValueError(f"fused_upsample_blur: unsupported Ci={Ci} Co={Co} taps={len(taps)}")
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    check_tensor(x, "x", bf, (B, H, W, Ci), dev)
    check_tensor(a, "a", f32, (B, Ci), dev)
    check_tensor(c, "c", f32, (B, Ci), dev)
    check_tensor(dw, "dw", f32, (Ci, 3, 3), dev)
    check_tensor(pw, "pw", bf, (4 * Co, Ci), dev)
    lib = library()
    hblur = torch.empty((B, 2 * H, 2 * W, Co), dtype=bf, device=dev)
    out = torch.empty_like(hblur)
    taps_c = (ctypes.c_float * len(taps))(*taps)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lib.vfm_fused_upsample_blur(
            x.data_ptr(), a.data_ptr(), c.data_ptr(), dw.data_ptr(), pw.data_ptr(),
            ctypes.cast(taps_c, ctypes.c_void_p), len(taps), hblur.data_ptr(), out.data_ptr(),
            B, H, W, Ci, Co, stream,
        )
    lib.check(err, "fused_upsample_blur")
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
    launch the kernels: bf16 x and pw, fp32 a, c, dw, Ci and Co multiples
    of 32. Differentiable through FusedUpsampleBlur."""
    taps = [float(v) for v in taps]
    args = (x, a, c, dw, pw)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedUpsampleBlur.apply(*args, taps, plain)
    return _forward(*args, taps, plain)


fused_upsample_blur.launches = 0

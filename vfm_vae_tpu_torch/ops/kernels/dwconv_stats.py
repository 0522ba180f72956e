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

On the H100 the kernels (csrc/dwconv_stats.cu) sit near the fp32 ridge:
2 k^2 CUDA-core flops per 4 bytes of bf16 traffic. One CTA per (8 x 16
output tile, 64 channels, sample) stages the tile and its halo once in
shared memory; K7's statistics take K5's fixed-order two-stage reduction.

Gradients: `DwconvNoiseStats` carries the JAX custom VJP `_fused_bwd`
(dwconv_stats.py:189: jax.vjp of `_forward_jnp`) as autograd of the twin.
K8 has no custom VJP in the JAX package and is forward only here.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import check_tensor, library, refuse_grad


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
    check_tensor(w, "w", torch.float32, (k, k, C), dev)
    check_tensor(b, "b", torch.float32, (C,), dev)
    if noise is not None:
        check_tensor(noise, "noise", torch.float32, (H, W), dev)
    lib = library()
    tiles = lib.lib.vfm_dwconv_tiles(H, W)
    out = torch.empty_like(x)
    part = torch.empty((2, B, tiles, C), dtype=torch.float32, device=dev)
    s1 = torch.empty((B, C), dtype=torch.float32, device=dev)
    s2 = torch.empty_like(s1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lib.vfm_dwconv_noise_stats(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), None if noise is None else noise.data_ptr(),
            out.data_ptr(), part.data_ptr(), s1.data_ptr(), s2.data_ptr(), B, H, W, C, k, stream)
    lib.check(err, "dwconv_noise_stats")
    dwconv_noise_stats.launches += 1
    return out, s1, s2


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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lib.vfm_depthwise_conv2d_same(
            x.data_ptr(), wf.data_ptr(), None if bf is None else bf.data_ptr(), out.data_ptr(),
            B, H, W, C, k, stream)
    lib.check(err, "depthwise_conv2d_same")
    depthwise_conv2d_same.launches += 1
    return out


dwconv_noise_stats.launches = 0
depthwise_conv2d_same.launches = 0

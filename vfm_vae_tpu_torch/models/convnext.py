"""ConvNeXt-style modulated decoder layers (port of
vfm_vae_tpu/models/convnext.py: ConvNeXtSynthesisLayer, ConvNeXtToRGBLayer,
SeparableUpsampleWithFixedBlur).

One code path on every device: the ConvNeXt layer always folds GroupNorm
and the style into the K1 operands (A = a * style, b1_eff), and every
pre-normalized upsample with the blur on and odd taps folds GroupNorm into
the K2 operands. On the card the wrappers launch the hand-written kernels;
on the CPU they run their plain twins, so the CPU tests also check the
folding against the JAX package's unfused chain.

The decoder's static-int8 MLP (vfm_vae_tpu/models/convnext.py:147
`_int8_mlp`, serving only): a layer with int8 mirrors
(ops/quantized.prequantize_decoder_mlps) at a map of at most 64 x 64 runs
its two products on K6 once its activation scales are calibrated (or,
while calibrating, the fp32 MLP that records them), on the same folded
operands; larger maps stay on K1, as the JAX gate says.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels import (
    fused_convnext_mlp,
    fused_upsample_blur,
    int8_matmul_gelu,
    int8_matmul_residual,
)
from ..ops.kernels.fused_upsample import edge_blur
from ..ops.pixelshuffle import pixel_shuffle
from ..ops.resize import resize_bilinear
from .layers import (
    _INT8_CALIB,
    TRUNC02,
    Conv2d,
    GroupNorm32,
    Module,
    StyleSplit,
    param,
    randn_,
    record_amax,
)
from .modulated import ModulatedPointwiseConv2DLayer, demod_coefs

# Binomial low-pass kernels (convnext_utils.py:190-194).
GAUSSIAN_KERNELS = {"3x3": [1, 2, 1], "4x4": [1, 3, 3, 1], "5x5": [1, 4, 6, 4, 1]}
LAYER_SCALE_INIT = 1e-5
# The decoder MLP's int8 mirrors and static activation scales
# (ops/quantized.py: w1q (4C, C), w2q (C, 4C) int8, ws1, ws2, as_u, as_h fp32).
INT8_BUFFERS = ("w1q", "ws1", "w2q", "ws2", "as_u", "as_h")
INT8_MAX_HW = 64 * 64  # the JAX gate: int8 only at maps of at most 64 x 64 (convnext.py:121)
_INT8_EPS = 1e-8
_NAME_SCOPE: list = []


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Ops run inside the block carry `name` for the "names" remat policy
    (synthesis.remat_policy; the port's counterpart of
    jax.ad_checkpoint.checkpoint_name)."""
    _NAME_SCOPE.append(name)
    try:
        yield
    finally:
        _NAME_SCOPE.pop()


class ConvNeXtSynthesisLayer(Module):
    """dwconv -> (legacy noise) -> GN32 -> modulated pw expand -> GELU ->
    pw contract -> layer scale -> residual (convnext_utils.py:78-142);
    everything after the noise runs in K1, or, with calibrated int8
    mirrors at a map of at most 64 x 64, in K6 (`_int8_mlp`)."""

    def __init__(self, channels: int, w_dim: int, kernel_size: int, block_index: int = 0,
                 legacy: bool = False, device=None):
        super().__init__()
        C = channels
        self.legacy = legacy
        self.plain = False  # select K1's plain twin on the card (comparisons only)
        self.affine_pw1 = StyleSplit(w_dim, C, bias_init=1, device=device)
        self.dwconv = Conv2d(C, C, kernel_size, padding=kernel_size // 2, groups=C,
                             weight_init=TRUNC02, bias_init="zeros", device=device)
        if legacy:
            res = 8 * 2 ** block_index
            self.noise_strength = param(device=device)
            self.register_buffer("noise_const", torch.empty(res, res, device=device))
        self.norm = GroupNorm32(min(32, C // 4), C, device=device)
        self.pwconv1 = ModulatedPointwiseConv2DLayer(C, 4 * C, device=device)
        self.pwconv2 = Conv2d(4 * C, C, 1, weight_init=TRUNC02, bias_init="zeros", device=device)
        self.gamma = param(C, device=device)
        for name in INT8_BUFFERS:
            self.register_buffer(name, None)

    def reset_parameters(self, g):
        if self.legacy:
            self.noise_strength.zero_()
            randn_(self.noise_const, g)
        self.gamma.fill_(LAYER_SCALE_INIT)

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x_in = x
        style = self.affine_pw1(w).float()
        # Named for the "names" remat policy (convnext.py:59-62): the map
        # that K1's backward takes as its residual.
        with checkpoint_name("dwconv_out"):
            x = self.dwconv(x)
        if self.legacy:
            H, W = x.shape[1], x.shape[2]
            noise = (self.noise_const * self.noise_strength)[None, :, :, None]
            if noise.shape[1:3] != (H, W):
                noise = resize_bilinear(noise, size=(H, W))
            x = x + noise.to(dt)
        # gn(x) = x*a + c, so (gn(x)*s) @ W1^T * d + b1 = (x*(a*s)) @ W1^T * d + b1_eff.
        a, c = self.norm.folded_affine(x)
        w1 = self.pwconv1.weight[:, :, 0, 0]  # (4C, C)
        w2 = self.pwconv2.weight[:, :, 0, 0]  # (C, 4C)
        d = demod_coefs(w1, style)
        A = a * style
        b1_eff = ((c * style) @ w1.float().t()) * d + self.pwconv1.bias.float()[None, :]
        if self.int8_route(x):
            return self._int8_mlp(x, x_in, A, d, w1, b1_eff, w2, self.pwconv2.bias.float(),
                                  self.gamma.float()).to(dt)
        return fused_convnext_mlp(
            x, x_in, A.contiguous(), d.contiguous(), w1.to(dt).contiguous(), b1_eff.contiguous(),
            w2.to(dt).contiguous(), self.pwconv2.bias.float().contiguous(),
            self.gamma.float().contiguous(), plain=self.plain,
        ).to(dt)

    def int8_route(self, x: torch.Tensor) -> bool:
        """The JAX gate (convnext.py:121-133): mirrors present, a map of at
        most 64 x 64, and the scales calibrated or calibrating."""
        return (self._buffers["w1q"] is not None and x.shape[1] * x.shape[2] <= INT8_MAX_HW
                and (_INT8_CALIB[0] is not None or self._buffers["as_u"] is not None))

    def _int8_mlp(self, x, x_in, A, d, w1, b1_eff, w2, b2, g):
        """The static-int8 MLP (convnext.py:147-211) on the folded operands.
        Calibrating: the fp32 MLP, recording max |u| and max |h| (u = x * A,
        h the GELU's output). Serving: K6's gelu mode (u quantized with
        as_u, the per-image scale (as_u * ws1) * d and bias b1_eff, the erf
        GELU, h in bf16), then K6's residual mode (h quantized with as_h,
        ws2, b2, the layer scale and the residual in fp32, one rounding to
        x_in's dtype, as JAX rounds the layer's output)."""
        if _INT8_CALIB[0] is not None:
            u = x.float() * A[:, None, None, :]
            record_amax((self, "as_u"), u)
            h = F.gelu((u @ w1.float().t()) * d[:, None, None, :] + b1_eff[:, None, None, :])
            record_amax((self, "as_h"), h)
            y = h @ w2.float().t() + b2
            return x_in.float() + y * g
        s_u = torch.clamp_min(self.as_u, _INT8_EPS)
        s_h = torch.clamp_min(self.as_h, _INT8_EPS)
        e1 = (s_u * self.ws1)[None, :] * d
        h = int8_matmul_gelu(x, A.contiguous(), self.w1q, e1.contiguous(), b1_eff.contiguous(),
                             s_u, plain=self.plain)
        return int8_matmul_residual(h, self.w2q, self.ws2, b2.contiguous(), s_h, g.contiguous(),
                                    x_in, plain=self.plain)


class ConvNeXtToRGBLayer(Module):
    """Modulated 1x1 to-RGB without demodulation (convnext_utils.py:145-187)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, device=None):
        super().__init__()
        self.weight_gain = 1 / math.sqrt(in_channels)
        self.weight = param(out_channels, in_channels, 1, 1, device=device)
        self.bias = param(out_channels, device=device)
        self.affine = StyleSplit(w_dim, in_channels, bias_init=1, device=device)

    def reset_parameters(self, g):
        randn_(self.weight, g, 0.1)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        style = self.affine(w) * self.weight_gain
        xs = x * style[:, None, None, :].to(x.dtype)
        y = xs @ self.weight[:, :, 0, 0].to(x.dtype).t()
        return y + self.bias.to(y.dtype)


class SeparableUpsampleWithFixedBlur(Module):
    """GN -> dw3x3 -> pw1x1 -> PixelShuffle(2) -> normalized binomial blur
    with edge-replicate padding (convnext_utils.py:197-256). The
    pre-normalized form with the blur on and odd taps runs in K2, as the
    JAX package's K2 gate admits it (fused_upsample.py:296-305);
    `pre_normalize=False` (the first block) norms after the shuffle, and it,
    the blur off (`use_gaussian_blur=False`) and even taps (padded one more
    on the far side, convnext.py:302-305) stay plain PyTorch, as they stay
    plain XLA in the JAX package."""

    def __init__(self, in_channels: int, out_channels: int, blur_kernel="3x3",
                 pre_normalize: bool = True, use_gaussian_blur: bool = True, device=None):
        super().__init__()
        self.pre_normalize, self.use_gaussian_blur = pre_normalize, use_gaussian_blur
        self.plain = False  # select K2's plain twin on the card (comparisons only)
        norm_ch = in_channels if pre_normalize else out_channels
        self.norm = GroupNorm32(min(32, norm_ch // 4), norm_ch, device=device)
        self.depthwise = Conv2d(in_channels, in_channels, 3, padding=1, groups=in_channels,
                                bias=False, device=device)
        self.pointwise = Conv2d(in_channels, out_channels * 4, 1, bias=False, device=device)
        taps = np.asarray(GAUSSIAN_KERNELS[blur_kernel] if isinstance(blur_kernel, str)
                          else blur_kernel, np.float64)
        self.taps = [float(t) for t in taps / taps.sum()]

    @property
    def fused(self) -> bool:
        """Whether the call runs K2 (the JAX package's K2 gate)."""
        return self.pre_normalize and self.use_gaussian_blur and len(self.taps) % 2 == 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            a, c = self.norm.folded_affine(x)
            return fused_upsample_blur(
                x, a.contiguous(), c.contiguous(), self.depthwise.weight[:, 0].float().contiguous(),
                self.pointwise.weight[:, :, 0, 0].to(x.dtype).contiguous(), self.taps,
                plain=self.plain,
            )
        if self.pre_normalize:
            x = pixel_shuffle(self.pointwise(self.depthwise(self.norm(x))), 2)
        else:
            x = self.norm(pixel_shuffle(self.pointwise(self.depthwise(x)), 2))
        if not self.use_gaussian_blur:
            return x
        return edge_blur(edge_blur(x, self.taps, 1), self.taps, 2)

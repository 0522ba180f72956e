"""Style-modulated convolutions (port of vfm_vae_tpu/models/modulated.py:
`demod_coefs`, `modulated_conv2d` and `ModulatedPointwiseConv2DLayer`).
The ConvNeXt layer computes its modulated pointwise product through the
folded K1 kernel (models/convnext.py), so that layer here only owns its
parameters; the legacy StyleGAN-T layers (models/synthesis.py) run
`modulated_conv2d`: scale the input channels by the style, one shared
convolution, scale the output channels by the demodulation coefficients
(no per-sample weights)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Module, param, trunc_normal_


def demod_coefs(weight: torch.Tensor, styles: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """dcoef[b, o] = rsqrt(sum_{i,kh,kw} (W[o, i, kh, kw] * s[b, i])^2 + eps), fp32.
    `weight` is torch (O, I) or (O, I, kh, kw); `styles` is (B, I)."""
    w = weight.float()
    w2 = w.square().reshape(w.shape[0], w.shape[1], -1).sum(-1)  # (O, I)
    return torch.rsqrt(styles.float().square() @ w2.t() + eps)


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor, styles: torch.Tensor,
                     padding: int = 0, demodulate: bool = True) -> torch.Tensor:
    """x (B, H, W, I) NHWC, weight (O, I, kh, kw), styles (B, I): the JAX
    order (modulated.py:44), in x's dtype."""
    B = x.shape[0]
    xs = x * styles.reshape(B, 1, 1, -1).to(x.dtype)
    y = F.conv2d(xs.permute(0, 3, 1, 2), weight.to(x.dtype), padding=padding).permute(0, 2, 3, 1)
    if demodulate:
        y = y * demod_coefs(weight, styles).reshape(B, 1, 1, -1).to(y.dtype)
    return y


class ModulatedPointwiseConv2DLayer(Module):
    """(convnext_utils.py:60-75): (out, in, 1, 1) trunc-normal(0.02) weight, zero bias."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.weight = param(out_channels, in_channels, 1, 1, device=device)
        self.bias = param(out_channels, device=device)

    def reset_parameters(self, g):
        trunc_normal_(self.weight, g, 0.02)
        self.bias.zero_()

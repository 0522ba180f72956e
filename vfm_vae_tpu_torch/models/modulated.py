"""Style-modulated pointwise convolution (port of
vfm_vae_tpu/models/modulated.py: `demod_coefs` and
`ModulatedPointwiseConv2DLayer`). The port computes the modulated product
through the folded K1 kernel (models/convnext.py), so the layer here only
owns its parameters."""

from __future__ import annotations

import torch

from .layers import Module, param, trunc_normal_


def demod_coefs(weight: torch.Tensor, styles: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """dcoef[b, o] = rsqrt(sum_{i,kh,kw} (W[o, i, kh, kw] * s[b, i])^2 + eps), fp32.
    `weight` is torch (O, I) or (O, I, kh, kw); `styles` is (B, I)."""
    w = weight.float()
    w2 = w.square().reshape(w.shape[0], w.shape[1], -1).sum(-1)  # (O, I)
    return torch.rsqrt(styles.float().square() @ w2.t() + eps)


class ModulatedPointwiseConv2DLayer(Module):
    """(convnext_utils.py:60-75): (out, in, 1, 1) trunc-normal(0.02) weight, zero bias."""

    def __init__(self, in_channels: int, out_channels: int, device=None):
        super().__init__()
        self.weight = param(out_channels, in_channels, 1, 1, device=device)
        self.bias = param(out_channels, device=device)

    def reset_parameters(self, g):
        trunc_normal_(self.weight, g, 0.02)
        self.bias.zero_()

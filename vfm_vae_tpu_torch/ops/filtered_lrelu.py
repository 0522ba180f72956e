"""Filtered leaky ReLU, StyleGAN3's alias-free op (port of
vfm_vae_tpu/ops/filtered_lrelu.py; reference torch_utils/ops/
filtered_lrelu.py:56-114): bias -> FIR upsample (gain up^2) -> leaky ReLU
x gain -> clamp -> FIR downsample, composed from upfirdn2d as the
reference's ref implementation is. No model path calls it, in either
package."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .upfirdn import _parse_padding, upfirdn2d


def filtered_lrelu(x: torch.Tensor, fu=None, fd=None, b: Optional[torch.Tensor] = None,
                   up: int = 1, down: int = 1, padding=0, gain: float = math.sqrt(2),
                   slope: float = 0.2, clamp: Optional[float] = None,
                   flip_filter: bool = False) -> torch.Tensor:
    """x (B, H, W, C) NHWC; b (C,)."""
    px0, px1, py0, py1 = _parse_padding(padding)
    if b is not None:
        x = x + b.to(x.dtype).reshape(1, 1, 1, -1)
    x = upfirdn2d(x, fu, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                  flip_filter=flip_filter)
    x = F.leaky_relu(x, slope) * gain
    if clamp is not None:
        x = torch.clamp(x, -clamp, clamp)
    return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)

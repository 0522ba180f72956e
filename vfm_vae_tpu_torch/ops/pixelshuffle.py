"""Pixel shuffle / unshuffle on NHWC maps with torch channel order
(port of vfm_vae_tpu/ops/pixelshuffle.py): unshuffle output channel =
c*r^2 + i*r + j for source subpixel (i, j); shuffle is the inverse."""

from __future__ import annotations

import torch


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H*r, W*r, C) -> (B, H, W, C*r*r)."""
    B, Hr, Wr, C = x.shape
    if Hr % r or Wr % r:
        raise ValueError(f"pixel_unshuffle: {tuple(x.shape)} not divisible by {r}")
    H, W = Hr // r, Wr // r
    x = x.reshape(B, H, r, W, r, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, H, W, C * r * r)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C*r*r) -> (B, H*r, W*r, C)."""
    B, H, W, Crr = x.shape
    if Crr % (r * r):
        raise ValueError(f"pixel_shuffle: {Crr} channels not divisible by {r * r}")
    C = Crr // (r * r)
    x = x.reshape(B, H, W, C, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * r, W * r, C)

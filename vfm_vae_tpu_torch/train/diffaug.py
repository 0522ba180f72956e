"""DiffAugment (port of vfm_vae_tpu/train/diffaug.py; reference
training/diffaug.py): color, translation, cutout on NHWC images in [-1, 1].

The random draws are separate from the arithmetic: `sample_draws` takes them
from an explicit torch.Generator, and `diff_augment` applies given draws, so
a test can feed the draws the JAX package made.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Draws = Dict[str, torch.Tensor]


def translation_shift(n: int, ratio: float = 0.125) -> int:
    return int(n * ratio + 0.5)


def cutout_size(n: int, ratio: float = 0.2) -> int:
    return int(n * ratio + 0.5)


def sample_draws(x: torch.Tensor, generator: Optional[torch.Generator]) -> Draws:
    """Every random number one diff_augment call uses, with the ranges of
    the JAX package: uniform [0, 1) per sample for brightness, saturation
    and contrast; integer shifts in [-s, s]; cutout offsets in [0, n + 1 - c % 2)."""
    B, H, W, _ = x.shape
    dev = x.device

    def uniform():
        return torch.rand((B, 1, 1, 1), generator=generator, device=dev)

    def randint(lo, hi):
        return torch.randint(lo, hi, (B, 1, 1), generator=generator, device=dev)

    sh, sw = translation_shift(H), translation_shift(W)
    ch, cw = cutout_size(H), cutout_size(W)
    return dict(
        brightness=uniform(), saturation=uniform(), contrast=uniform(),
        translate_h=randint(-sh, sh + 1), translate_w=randint(-sw, sw + 1),
        cutout_h=randint(0, H + (1 - ch % 2)), cutout_w=randint(0, W + (1 - cw % 2)),
    )


def rand_brightness(x, u):
    return x + (u.to(x.dtype) - 0.5)


def rand_saturation(x, u):
    mean = x.mean(dim=-1, keepdim=True)
    return (x - mean) * (u.to(x.dtype) * 2) + mean


def rand_contrast(x, u):
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * (u.to(x.dtype) + 0.5) + mean


def rand_translation(x, th, tw):
    """Shift by (th, tw) pixels per sample with zero fill (the reference's
    clamp-into-a-zero-pad gather)."""
    B, H, W, C = x.shape
    dev = x.device
    gh = torch.clamp(torch.arange(H, device=dev)[None, :] + th[:, :, 0] + 1, 0, H + 1)  # (B, H)
    gw = torch.clamp(torch.arange(W, device=dev)[None, :] + tw[:, 0, :] + 1, 0, W + 1)  # (B, W)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    bi = torch.arange(B, device=dev)[:, None, None]
    return xp[bi, gh[:, :, None], gw[:, None, :]]


def rand_cutout(x, oh, ow):
    """Zero a (ch, cw) square centred at the offsets, clamped to the image."""
    B, H, W, C = x.shape
    dev = x.device
    ch, cw = cutout_size(H), cutout_size(W)
    gh = torch.clamp(torch.arange(ch, device=dev)[None, :] + oh[:, :, 0] - ch // 2, 0, H - 1)
    gw = torch.clamp(torch.arange(cw, device=dev)[None, :] + ow[:, 0, :] - cw // 2, 0, W - 1)
    mask = torch.ones((B, H, W), dtype=x.dtype, device=dev)
    bi = torch.arange(B, device=dev)[:, None, None].expand(B, ch, cw)
    mask[bi, gh[:, :, None].expand(B, ch, cw), gw[:, None, :].expand(B, ch, cw)] = 0.0
    return x * mask[..., None]


def diff_augment(x: torch.Tensor, draws: Draws) -> torch.Tensor:
    """The policy 'color,translation,cutout' with the given draws."""
    x = rand_brightness(x, draws["brightness"])
    x = rand_saturation(x, draws["saturation"])
    x = rand_contrast(x, draws["contrast"])
    x = rand_translation(x, draws["translate_h"], draws["translate_w"])
    return rand_cutout(x, draws["cutout_h"], draws["cutout_w"])

"""Scaled dot-product attention in the (B, T, N, H) layout (port of
vfm_vae_tpu/ops/attention.py and the eligibility rule of
vfm_vae_tpu/ops/pallas/flash_attention.py:flash_eligible).

`dot_product_attention` serves the ViT tower and the adapter. By default it
runs PyTorch's SDPA, as the JAX package leaves these sites to XLA; where the
flash rule admits a call (opt-in), it runs the hand-written K4 kernel on the
card and K4's plain twin on the CPU. `dot_product_attention_nullkv` (the
GigaGAN decoder sites) routes to K3 on the card and to its twin on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from .kernels import flash_attention_nonull, flash_attention_nullkv


def flash_eligible_shape(Tq: int, Tk: int, d: int, masked: bool, prefer: bool = False) -> bool:
    """The JAX rule without its TPU-backend test: the kill switch
    VFM_VAE_NO_PALLAS_FLASH=1 wins; otherwise opt-in by
    VFM_VAE_USE_PALLAS_FLASH=1 or a call site's `prefer`; no mask; head dim
    64 or 128; Tq, Tk >= 256 and multiples of 128."""
    if os.environ.get("VFM_VAE_NO_PALLAS_FLASH") == "1":
        return False
    if not prefer and os.environ.get("VFM_VAE_USE_PALLAS_FLASH") != "1":
        return False
    if masked or d not in (64, 128):
        return False
    return Tq >= 256 and Tk >= 256 and Tq % 128 == 0 and Tk % 128 == 0


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # bool, True = attend, broadcastable to (B, N, Tq, Tk)
    scale: Optional[float] = None,
    prefer_flash: bool = False,
    *,
    plain: bool = False,
) -> torch.Tensor:
    """Softmax attention. Where the flash rule admits the call (`prefer_flash`
    is the call site's opt-in) K4 runs, its twin for CPU tensors or
    plain=True; every other call runs SDPA."""
    if flash_eligible_shape(q.shape[1], k.shape[1], q.shape[-1], mask is not None, prefer_flash):
        return flash_attention_nonull(q, k, v, scale, plain=plain)
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask, scale=scale
    )
    return out.transpose(1, 2)


def dot_product_attention_nullkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    null_k: torch.Tensor,  # (B, 1, N, H)
    null_v: torch.Tensor,
    scale: Optional[float] = None,
    *,
    plain: bool = False,
) -> torch.Tensor:
    """Attention over [null_k; k], [null_v; v] (gigagan_utils.py:74-78)."""
    return flash_attention_nullkv(q, k, v, null_k, null_v, scale, plain=plain)

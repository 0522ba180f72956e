"""Scaled dot-product attention in the (B, T, N, H) layout (port of
vfm_vae_tpu/ops/attention.py).

`dot_product_attention` serves the ViT tower and the adapter, which run on
XLA's own attention in the JAX package; here they use PyTorch's SDPA.
`dot_product_attention_nullkv` (the GigaGAN decoder sites) routes to the
hand-written K3 kernel on the card and to its plain twin on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .kernels import flash_attention_nullkv


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # bool, True = attend, broadcastable to (B, N, Tq, Tk)
    scale: Optional[float] = None,
) -> torch.Tensor:
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

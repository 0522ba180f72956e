"""Feature-map self-attention with a learned null key/value (port of
vfm_vae_tpu/models/gigagan.py: SelfAttention, FeedForwardChannelFirst,
SelfAttentionBlock). NHWC maps; the attention runs in K3."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.attention import dot_product_attention_nullkv
from .layers import ChannelRMSNorm, Conv2d, Module, param, randn_


class SelfAttention(Module):
    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, device=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.plain = False  # select K3's plain twin on the card (comparisons only)
        self.norm = ChannelRMSNorm(dim, device=device)
        self.to_q = Conv2d(dim, inner, 1, bias=False, device=device)
        self.to_k = Conv2d(dim, inner, 1, bias=False, device=device)
        self.to_v = Conv2d(dim, inner, 1, bias=False, device=device)
        self.null_kv = param(2, heads, dim_head, device=device)
        self.to_out = Conv2d(inner, dim, 1, bias=False, weight_init="zeros", device=device)

    def reset_parameters(self, g):
        randn_(self.null_kv, g, 0.02)

    def forward(self, fmap: torch.Tensor) -> torch.Tensor:
        B, H, W, C = fmap.shape
        h, d = self.heads, self.dim_head
        tokens = self.norm(fmap).reshape(B, H * W, C)
        q, k, v = (tokens @ conv.weight[:, :, 0, 0].to(tokens.dtype).t()
                   for conv in (self.to_q, self.to_k, self.to_v))
        q, k, v = (t.reshape(B, H * W, h, d) for t in (q, k, v))
        nk = self.null_kv[0][None, None].expand(B, 1, h, d).to(k.dtype).contiguous()
        nv = self.null_kv[1][None, None].expand(B, 1, h, d).to(v.dtype).contiguous()
        out = dot_product_attention_nullkv(q, k, v, nk, nv, plain=self.plain)
        out = out.reshape(B, H * W, h * d) @ self.to_out.weight[:, :, 0, 0].to(out.dtype).t()
        return out.reshape(B, H, W, C)


class FeedForwardChannelFirst(Module):
    """ChannelRMSNorm -> 1x1 expand -> GELU -> zero-init 1x1 contract; keys
    0 (norm), 1 and 3 (convs) as the reference's nn.Sequential."""

    def __init__(self, dim: int, mult: int = 4, device=None):
        super().__init__()
        hidden = int(dim * mult)
        self.add_module("0", ChannelRMSNorm(dim, device=device))
        self.add_module("1", Conv2d(dim, hidden, 1, device=device))
        self.add_module("3", Conv2d(hidden, dim, 1, weight_init="zeros", device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm, proj1, proj2 = (self._modules[k] for k in ("0", "1", "3"))
        return proj2(F.gelu(proj1(norm(x))))


class SelfAttentionBlock(Module):
    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, ff_mult: int = 4,
                 device=None):
        super().__init__()
        self.attn = SelfAttention(dim, dim_head, heads, device=device)
        self.ff = FeedForwardChannelFirst(dim, ff_mult, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attn(x) + x
        return self.ff(x) + x

"""SigLIP vision tower in plain PyTorch (port of
vfm_vae_tpu/models/vit.py: SigLIPVisionTower, MultiHeadSelfAttention,
ViTMLP, ViTBlock, MAPHead params, interpolate_pos_embed).

Parameter names follow HF's SiglipVisionTransformer (embeddings.*,
encoder.layers.N.*, post_layernorm.*, head.*), the layout the reference
checkpoints carry. Attention runs through ops.attention: PyTorch's SDPA by
default, as the JAX package leaves it to XLA's, and the K4 flash kernel
where its opt-in rule admits the shape. Under the int8 scope the Linears
run W8A8 through K6 (ops/quantized.py).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_product_attention
from ..ops.bias_act import apply_activation
from ..ops.resize import resize_matrix
from .layers import LayerNormFp32, Linear, Module, holder, param, randn_, uniform_


def interpolate_pos_embed(pos: torch.Tensor, grid_in: int, grid_out_h: int, grid_out_w: int,
                          mode: str = "bicubic", antialias: bool = False) -> torch.Tensor:
    """HF-style pos-embed resize (align_corners=False) as two matrix products."""
    D = pos.shape[-1]
    kind = "cubic" if mode == "bicubic" else "linear"
    mh = torch.from_numpy(resize_matrix(grid_in, grid_out_h, kind, antialias)).to(pos.device)
    mw = torch.from_numpy(resize_matrix(grid_in, grid_out_w, kind, antialias)).to(pos.device)
    p = pos.float().reshape(grid_in, grid_in, D)
    p = torch.einsum("oh,hwd->owd", mh, p)
    p = torch.einsum("ow,hwd->hod", mw, p)
    return p.reshape(grid_out_h * grid_out_w, D).to(pos.dtype)


class MultiHeadSelfAttention(Module):
    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(dim, dim, device=device)
        self.k_proj = Linear(dim, dim, device=device)
        self.v_proj = Linear(dim, dim, device=device)
        self.out_proj = Linear(dim, dim, device=device)
        self.plain = False  # select K4's plain twin on the card (comparisons only)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        h = self.num_heads
        q = self.q_proj(x).reshape(B, N, h, D // h)
        k = self.k_proj(x).reshape(B, N, h, D // h)
        v = self.v_proj(x).reshape(B, N, h, D // h)
        out = dot_product_attention(q, k, v, plain=self.plain)
        return self.out_proj(out.reshape(B, N, D))


class ViTMLP(Module):
    def __init__(self, dim: int, hidden_dim: int, act: str = "gelu_tanh", device=None):
        super().__init__()
        self.act = act
        self.fc1 = Linear(dim, hidden_dim, device=device)
        self.fc2 = Linear(hidden_dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(apply_activation(self.fc1(x), self.act))


class ViTBlock(Module):
    """Pre-LN block (HF SiglipEncoderLayer names); `act` "gelu" is the exact
    GELU of the DINO blocks, "gelu_tanh" SigLIP's."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, eps: float = 1e-6,
                 act: str = "gelu_tanh", device=None):
        super().__init__()
        self.layer_norm1 = LayerNormFp32(dim, eps, device=device)
        self.self_attn = MultiHeadSelfAttention(dim, num_heads, device=device)
        self.layer_norm2 = LayerNormFp32(dim, eps, device=device)
        self.mlp = ViTMLP(dim, mlp_dim, act, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _MultiheadAttentionParams(Module):
    """torch nn.MultiheadAttention's packed in-projection layout."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.in_proj_weight = param(3 * dim, dim, device=device)
        self.in_proj_bias = param(3 * dim, device=device)
        self.out_proj = Linear(dim, dim, device=device)

    def reset_parameters(self, g):
        uniform_(self.in_proj_weight, g, math.sqrt(6.0 / (4 * self.in_proj_weight.shape[1])))
        self.in_proj_bias.zero_()


class MAPHead(Module):
    """SigLIP attention-pooling head. Its parameters are carried so the tree
    matches the checkpoint; encode drops the pooled output, so the slice
    never computes it."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.probe = param(1, 1, dim, device=device)
        self.attention = _MultiheadAttentionParams(dim, device=device)
        self.layernorm = LayerNormFp32(dim, eps, device=device)
        self.mlp = ViTMLP(dim, mlp_dim, device=device)

    def reset_parameters(self, g):
        randn_(self.probe, g)


class _Embedding(Module):
    def __init__(self, num: int, dim: int, device=None):
        super().__init__()
        self.weight = param(num, dim, device=device)

    def reset_parameters(self, g):
        randn_(self.weight, g, 1.0 / math.sqrt(self.weight.shape[1]))


class _PatchEmbedding(Module):
    def __init__(self, channels: int, dim: int, patch: int, device=None):
        super().__init__()
        self.weight = param(dim, channels, patch, patch, device=device)
        self.bias = param(dim, device=device)

    def reset_parameters(self, g):
        randn_(self.weight, g, 1.0 / math.sqrt(self.weight[0].numel()))
        self.bias.zero_()

    def forward(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """NHWC pixels -> (B, gh*gw, D) as one product over flattened patches."""
        B, H, W, Cin = pixels.shape
        D, _, p, _ = self.weight.shape
        gh, gw = H // p, W // p
        x = pixels.reshape(B, gh, p, gw, p, Cin).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, gh * gw, p * p * Cin)
        w = self.weight.to(pixels.dtype).permute(0, 2, 3, 1).reshape(D, p * p * Cin)
        return x @ w.t() + self.bias.to(pixels.dtype), gh, gw


class SigLIPVisionTower(Module):
    """HF SiglipVisionTransformer equivalent. `forward` returns
    (hidden_states, last): hidden-state index 0 is the embeddings output,
    i the output of block i; `last` is the post-LN final sequence."""

    def __init__(self, hidden_size: int = 1024, num_layers: int = 24, num_heads: int = 16,
                 mlp_dim: int = 4096, patch_size: int = 16, image_size: int = 512,
                 eps: float = 1e-6, remat: bool = False, device=None):
        super().__init__()
        # A checkpoint per block where a gradient is recorded (vit.py:401,
        # :446); the frozen tower's encode records none, so there it is idle.
        self.remat = bool(remat)
        self.grid = image_size // patch_size
        self.embeddings = holder(
            patch_embedding=_PatchEmbedding(3, hidden_size, patch_size, device=device),
            position_embedding=_Embedding(self.grid * self.grid, hidden_size, device=device),
        )
        self.encoder = holder(layers=nn.ModuleList(
            ViTBlock(hidden_size, num_heads, mlp_dim, eps, device=device)
            for _ in range(num_layers)))
        self.post_layernorm = LayerNormFp32(hidden_size, eps, device=device)
        self.head = MAPHead(hidden_size, num_heads, mlp_dim, eps, device=device)

    def forward(self, pixels: torch.Tensor, collect: Optional[Sequence[int]] = None
                ) -> Tuple[Dict[int, torch.Tensor], torch.Tensor]:
        x, gh, gw = self.embeddings.patch_embedding(pixels)
        pos = self.embeddings.position_embedding.weight
        if (gh, gw) != (self.grid, self.grid):
            pos = interpolate_pos_embed(pos, self.grid, gh, gw, mode="bicubic")
        x = x + pos.to(x.dtype)[None]
        layers: List[ViTBlock] = list(self.encoder.layers)
        want = set(collect) if collect is not None else set(range(len(layers) + 1))
        hidden: Dict[int, torch.Tensor] = {0: x} if 0 in want else {}
        for i, block in enumerate(layers):
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
            if i + 1 in want:
                hidden[i + 1] = x
        return hidden, self.post_layernorm(x)

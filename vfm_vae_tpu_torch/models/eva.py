"""EVA-02 vision tower in plain PyTorch (port of vfm_vae_tpu/models/eva.py:
eva_rope_table, _rot_pairs, EvaAttention, EvaSwiGLU, EvaBlock, EVATower).

Patch embedding + CLS + a learned position table, 2D axial rotary
embeddings on q and k of every block (patch tokens only; the CLS token
passes through), separate q/k/v projections with a bias-free k, sub-LN
inside the attention output and the SwiGLU. Layer -1 and the pooled CLS
come from the raw last block: the tower has no final norm. Parameter names
follow the layout vfm_vae_tpu/models/eva.py:convert_eva_timm reads
(patch_embed.proj, cls_token, pos_embed, blocks.N.{norm1, attn.{q_proj,
k_proj, v_proj, norm, proj}, norm2, mlp.{w1, w2, ffn_ln, w3}}).
Attention is PyTorch's SDPA (1 + grid^2 tokens: no flash kernel admits
them); under the int8 scope every Linear runs K6.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from .layers import LayerNormFp32, Linear, Module, holder, param, randn_
from .vit import TowerOutput, _PatchEmbedding, collect_set, interpolate_pos_embed, run_blocks


def eva_rope_table(grid_h: int, grid_w: int, head_dim: int, temperature: float = 10000.0,
                   ref_grid: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(N, head_dim) sin and cos of the 2D axial rope (eva.py:33-65): bands
    1/T^(i/b), b = head_dim // 4 a spatial axis, angles [h-bands | w-bands]
    pair-interleaved; positions scaled to the pretrain grid `ref_grid`."""
    quarter = head_dim // 4
    bands = 1.0 / (temperature ** (np.arange(quarter) / quarter))
    rg_h = ref_grid or grid_h
    rg_w = ref_grid or grid_w
    ang_h = np.outer(np.arange(grid_h) / grid_h * rg_h, bands)
    ang_w = np.outer(np.arange(grid_w) / grid_w * rg_w, bands)
    hh = np.repeat(ang_h[:, None, :], grid_w, 1).reshape(-1, quarter)
    ww = np.repeat(ang_w[None, :, :], grid_h, 0).reshape(-1, quarter)
    ang = np.repeat(np.concatenate([hh, ww], axis=-1), 2, axis=-1)
    return np.sin(ang).astype(np.float32), np.cos(ang).astype(np.float32)


def _rot_pairs(x: torch.Tensor) -> torch.Tensor:
    """(-x1, x0, -x3, x2, ...): the pair-interleaved rotation."""
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)


class EvaAttention(Module):
    def __init__(self, dim: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(dim, dim, device=device)
        self.k_proj = Linear(dim, dim, bias=False, device=device)
        self.v_proj = Linear(dim, dim, device=device)
        self.norm = LayerNormFp32(dim, 1e-6, device=device)  # sub-LN
        self.proj = Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        h = self.num_heads
        q = self.q_proj(x).reshape(B, N, h, D // h)
        k = self.k_proj(x).reshape(B, N, h, D // h)
        v = self.v_proj(x).reshape(B, N, h, D // h)
        s, c = sin[None, :, None, :].to(q.dtype), cos[None, :, None, :].to(q.dtype)

        def rot(t):  # patch tokens only: the CLS at index 0 passes through
            rest = t[:, 1:]
            return torch.cat([t[:, :1], rest * c + _rot_pairs(rest) * s], dim=1)

        out = dot_product_attention(rot(q), rot(k), v).reshape(B, N, D)
        return self.proj(self.norm(out))


class EvaSwiGLU(Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.w1 = Linear(dim, hidden, device=device)
        self.w2 = Linear(dim, hidden, device=device)
        self.ffn_ln = LayerNormFp32(hidden, 1e-6, device=device)  # sub-LN
        self.w3 = Linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w3(self.ffn_ln(F.silu(self.w1(x)) * self.w2(x)))


class EvaBlock(Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, device=None):
        super().__init__()
        self.norm1 = LayerNormFp32(dim, 1e-6, device=device)
        self.attn = EvaAttention(dim, num_heads, device=device)
        self.norm2 = LayerNormFp32(dim, 1e-6, device=device)
        self.mlp = EvaSwiGLU(dim, mlp_dim, device=device)

    def forward(self, x, sin, cos):
        x = x + self.attn(self.norm1(x), sin, cos)
        return x + self.mlp(self.norm2(x))


class EVATower(Module):
    """Hidden state 0 is the embeddings output, i the output of block i;
    tokens include the CLS prefix (the facade strips it). `forward` returns
    (hidden, last, pooled) with last the raw last block (eva_utils.py:113-128:
    the reference wrapper never calls the final norm) and pooled its CLS.
    rope_temperature and rope_ref_grid (None: the native grid) as in
    eva.py:140-153."""

    def __init__(self, hidden_size: int = 1024, num_layers: int = 24, num_heads: int = 16,
                 mlp_dim: int = 2730, patch_size: int = 14, image_size: int = 448,
                 rope_temperature: float = 10000.0, rope_ref_grid: Optional[int] = None,
                 device=None):
        super().__init__()
        self.grid = image_size // patch_size
        self.num_heads = num_heads
        self.rope_temperature, self.rope_ref_grid = rope_temperature, rope_ref_grid
        self.patch_embed = holder(proj=_PatchEmbedding(3, hidden_size, patch_size, device=device))
        self.cls_token = param(1, 1, hidden_size, device=device)
        self.pos_embed = param(1, 1 + self.grid * self.grid, hidden_size, device=device)
        self.blocks = nn.ModuleList(EvaBlock(hidden_size, num_heads, mlp_dim, device=device)
                                    for _ in range(num_layers))
        self._rope: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def reset_parameters(self, g):
        self.cls_token.zero_()
        randn_(self.pos_embed, g, 0.02)

    def rope(self, gh: int, gw: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (gh, gw, str(device))
        if key not in self._rope:
            head_dim = self.pos_embed.shape[-1] // self.num_heads
            sin, cos = eva_rope_table(gh, gw, head_dim, self.rope_temperature,
                                      self.rope_ref_grid or self.grid)
            self._rope[key] = (torch.from_numpy(sin).to(device), torch.from_numpy(cos).to(device))
        return self._rope[key]

    def forward(self, pixels: torch.Tensor, collect: Optional[Sequence[int]] = None,
                need_pooled: bool = True) -> TowerOutput:
        x, gh, gw = self.patch_embed.proj(pixels)
        B, _, D = x.shape
        pos = self.pos_embed[0]
        if (gh, gw) != (self.grid, self.grid):
            pos = torch.cat([pos[:1], interpolate_pos_embed(pos[1:], self.grid, gh, gw)], dim=0)
        x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, D), x], dim=1)
        x = x + pos.to(x.dtype)[None]
        sin, cos = self.rope(gh, gw, x.device)
        hidden, x = run_blocks(self.blocks, x, collect_set(collect, len(self.blocks)), sin, cos)
        return hidden, x, x[:, 0] if need_pooled else None

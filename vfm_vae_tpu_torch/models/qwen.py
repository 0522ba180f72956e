"""Qwen2.5-VL vision tower in plain PyTorch (port of
vfm_vae_tpu/models/qwen.py: qwen_window_layout, qwen_rope_table,
_rotate_half, QwenRMSNorm, QwenVisionBlock, QwenVisionTower,
qwen_patchify).

Every image of a batch shares one grid, so HF's concatenated sequence with
cu_seqlens becomes a (B, N) batch: the window permutation, the rope table
and the block-diagonal window mask are numpy constants per grid, and
attention is SDPA with that bool mask (blocks in `fullatt_block_indexes`
attend globally). Block features stay in the window-permuted order the
reference's hooks see; the merger output (layer -1) is put back in spatial
order. Parameter names follow HF's Qwen2_5_VisionTransformerPretrainedModel
(patch_embed.proj, blocks.N.{norm1, attn.{qkv, proj}, norm2,
mlp.{gate_proj, up_proj, down_proj}}, merger.{ln_q, mlp.0, mlp.2}).
Under the int8 scope every Linear runs K6; the patch embedding is a plain
product, as in the JAX tower.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from .layers import Linear, Module, holder, param, randn_
from .vit import TowerOutput, collect_set


def qwen_window_layout(grid_h: int, grid_w: int, patch_size: int, spatial_merge_size: int,
                       window_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(window index over merge units, window sizes in merge units) of one
    image (HF get_window_index; qwen.py:32-51)."""
    m = spatial_merge_size
    llm_h, llm_w = grid_h // m, grid_w // m
    vw = window_size // m // patch_size
    index = np.arange(llm_h * llm_w).reshape(llm_h, llm_w)
    pad_h, pad_w = (-llm_h) % vw, (-llm_w) % vw
    padded = np.full((llm_h + pad_h, llm_w + pad_w), -100, np.int64)
    padded[:llm_h, :llm_w] = index
    nh, nw = (llm_h + pad_h) // vw, (llm_w + pad_w) // vw
    padded = padded.reshape(nh, vw, nw, vw).transpose(0, 2, 1, 3).reshape(nh * nw, vw * vw)
    seqlens = (padded != -100).sum(axis=1)
    flat = padded.reshape(-1)
    return flat[flat != -100], seqlens[seqlens > 0]


def qwen_rope_table(grid_h: int, grid_w: int, spatial_merge_size: int, head_dim: int,
                    theta: float = 10000.0) -> np.ndarray:
    """(N, head_dim / 2) rope angles in merge-unit token order (HF rot_pos_emb)."""
    m = spatial_merge_size

    def merge_order(ids):
        return ids.reshape(grid_h // m, m, grid_w // m, m).transpose(0, 2, 1, 3).reshape(-1)

    h_ids = merge_order(np.arange(grid_h)[:, None].repeat(grid_w, 1))
    w_ids = merge_order(np.arange(grid_w)[None, :].repeat(grid_h, 0))
    dim = head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    return np.concatenate([np.outer(h_ids, inv_freq), np.outer(w_ids, inv_freq)],
                          axis=-1).astype(np.float32)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


class QwenRMSNorm(Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = param(dim, device=device)

    def reset_parameters(self, g):
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        n = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (n * self.weight).to(x.dtype)


class QwenVisionBlock(Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = QwenRMSNorm(dim, device=device)
        self.norm2 = QwenRMSNorm(dim, device=device)
        self.attn = holder(qkv=Linear(dim, 3 * dim, device=device),
                           proj=Linear(dim, dim, device=device))
        self.mlp = holder(gate_proj=Linear(dim, mlp_dim, device=device),
                          up_proj=Linear(dim, mlp_dim, device=device),
                          down_proj=Linear(mlp_dim, dim, device=device))

    def forward(self, x, cos, sin, mask):
        B, N, D = x.shape
        h = self.num_heads
        qkv = self.attn.qkv(self.norm1(x)).reshape(B, N, 3, h, D // h)
        q, k, v = qkv.unbind(2)
        c, s = cos[None, :, None, :].to(q.dtype), sin[None, :, None, :].to(q.dtype)
        q = q * c + _rotate_half(q) * s
        k = k * c + _rotate_half(k) * s
        out = dot_product_attention(q, k, v, mask=mask)
        x = x + self.attn.proj(out.reshape(B, N, D))
        y = self.norm2(x)
        mlp = self.mlp
        return x + mlp.down_proj(F.silu(mlp.gate_proj(y)) * mlp.up_proj(y))


class _Conv3dWeight(Module):
    """HF's patch Conv3d (kernel = stride = the patch volume, no bias): its
    weight (D, C, tp, p, p), applied as one product over flattened patches."""

    def __init__(self, dim: int, patch_dim: Tuple[int, ...], device=None):
        super().__init__()
        self.weight = param(dim, *patch_dim, device=device)

    def reset_parameters(self, g):
        randn_(self.weight, g, self.weight[0].numel() ** -0.5)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(patches.dtype).reshape(self.weight.shape[0], -1)
        return patches @ w.t()


class QwenVisionTower(Module):
    """forward(patches (B, N, C tp p p), grid) -> (hidden, merged (B, N / m^2,
    out_hidden), pooled = the mean of merged)."""

    def __init__(self, hidden_size: int = 1280, depth: int = 32, num_heads: int = 16,
                 mlp_dim: int = 3420, out_hidden_size: int = 3584, patch_size: int = 14,
                 temporal_patch_size: int = 2, spatial_merge_size: int = 2,
                 window_size: int = 112, fullatt_block_indexes: Sequence[int] = (7, 15, 23, 31),
                 in_channels: int = 3, device=None):
        super().__init__()
        D, m = hidden_size, spatial_merge_size
        self.patch_size, self.temporal_patch_size = patch_size, temporal_patch_size
        self.spatial_merge_size, self.window_size = m, window_size
        self.num_heads = num_heads
        self.fullatt_block_indexes = tuple(fullatt_block_indexes)
        self.patch_embed = holder(proj=_Conv3dWeight(
            D, (in_channels, temporal_patch_size, patch_size, patch_size), device=device))
        self.blocks = nn.ModuleList(QwenVisionBlock(D, num_heads, mlp_dim, device=device)
                                    for _ in range(depth))
        unit = m * m * D
        self.merger = holder(ln_q=QwenRMSNorm(D, device=device),
                             mlp=holder(**{"0": Linear(unit, unit, device=device),
                                           "2": Linear(unit, out_hidden_size, device=device)}))
        self._layout: Dict[tuple, tuple] = {}

    def layout(self, gh: int, gw: int, device):
        """(perm, cos, sin, window mask, merger order) of a grid, cached."""
        key = (gh, gw, str(device))
        if key not in self._layout:
            m = self.spatial_merge_size
            unit = m * m
            win_idx, win_sizes = qwen_window_layout(gh, gw, self.patch_size, m, self.window_size)
            head_dim = self.merger.ln_q.weight.shape[0] // self.num_heads
            perm = (win_idx[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)
            rope = qwen_rope_table(gh, gw, m, head_dim)[perm]
            emb = np.concatenate([rope, rope], axis=-1)
            seg = np.repeat(np.arange(len(win_sizes)), win_sizes * unit)
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
            self._layout[key] = (t(perm), t(np.cos(emb)), t(np.sin(emb)),
                                 t(seg[:, None] == seg[None, :])[None, None],
                                 t(np.argsort(win_idx)))
        return self._layout[key]

    def forward(self, patches: torch.Tensor, grid_hw: Tuple[int, int],
                collect: Optional[Sequence[int]] = None) -> TowerOutput:
        B, N, _ = patches.shape
        gh, gw = grid_hw
        if N != gh * gw:
            raise ValueError(f"QwenVisionTower: {N} patches for a {gh} x {gw} grid")
        D = self.merger.ln_q.weight.shape[0]
        unit = self.spatial_merge_size ** 2
        perm, cos, sin, win_mask, order = self.layout(gh, gw, patches.device)
        x = self.patch_embed.proj(patches)[:, perm]
        want = collect_set(collect, len(self.blocks))
        hidden: Dict[int, torch.Tensor] = {0: x} if 0 in want else {}
        for i, block in enumerate(self.blocks):
            x = block(x, cos, sin, None if i in self.fullatt_block_indexes else win_mask)
            if i + 1 in want:
                hidden[i + 1] = x
        mg = self.merger
        y = mg.ln_q(x).reshape(B, N // unit, unit * D)
        y = getattr(mg.mlp, "2")(F.gelu(getattr(mg.mlp, "0")(y)))
        y = y[:, order]
        return hidden, y, y.mean(1)


def qwen_patchify(img: torch.Tensor, patch_size: int, temporal_patch_size: int,
                  spatial_merge_size: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """NHWC image -> (B, N, C tp p p) patches in the HF processor's
    merge-unit-major order, the frame repeated over the temporal patch
    (qwen.py:196-211)."""
    B, H, W, C = img.shape
    p, m, tp = patch_size, spatial_merge_size, temporal_patch_size
    gh, gw = H // p, W // p
    x = img.reshape(B, gh // m, m, p, gw // m, m, p, C).permute(0, 1, 4, 2, 5, 7, 3, 6)
    x = x.reshape(B, gh * gw, C, 1, p, p).expand(-1, -1, -1, tp, -1, -1)
    return x.reshape(B, gh * gw, C * tp * p * p), (gh, gw)

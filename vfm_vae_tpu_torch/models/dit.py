"""Latent diffusion transformer, LightningDiT / SiT family (port of
vfm_vae_tpu/models/dit.py) and the REPA projector of the REG trainer
(tools/preprocess_for_reg/train.py:97-107).

The backbone follows train_lightningdit_xl_1_stage_0.yaml:22-56: patch-size-1
tokens of the f16d32 latent (16 x 16 x 32, NHWC), adaLN-zero conditioning on
the timestep and the class, optional qk-norm, SwiGLU, 2D RoPE and RMSNorm
(the REG SiT turns the last three off), a class-embedding table with a null
row for classifier-free guidance, velocity output.

Parameters follow the JAX module names (`blocks.{i}` for `blocks_{i}`) in
the torch Linear layout ((out, in)); `models/convert.dit_state_dict_from_jax`
maps a JAX parameter tree onto them. adaLN, `final_adaLN` and
`final_linear` start at zero, so a fresh model outputs 0.

The class dropout of training is an argument here (`drop`, a bool mask
over the batch) where the JAX module draws it from its `rng`: the caller
draws it, so a test can pass JAX's draws. Attention runs through
ops/attention.dot_product_attention: SDPA unless the flash rule admits the
shape (head dim 64 or 128 and the opt-in switch); at XL the head dim is
1152 / 16 = 72, so the DiT launches no hand-written kernel.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from .layers import TRUNC02, Linear, Module, param, randn_, trunc_normal_

ZEROS = "zeros"


def f32(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, or in its own dtype where that is wider (float64 checks)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (DiT convention): cos before sin."""
    half = dim // 2
    t = f32(t)
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=t.dtype, device=t.device) / half)
    args = t[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def rope_frequencies(head_dim: int, grid: int, theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """2D axial RoPE over a grid x grid token layout: (cos, sin), each
    (grid^2, head_dim / 2), the y angles before the x angles."""
    quarter = head_dim // 4
    freqs = 1.0 / (theta ** (np.arange(quarter) / quarter))
    ang = np.outer(np.arange(grid), freqs)  # (grid, quarter)
    ys = np.repeat(ang[:, None, :], grid, axis=1).reshape(grid * grid, quarter)
    xs = np.repeat(ang[None, :, :], grid, axis=0).reshape(grid * grid, quarter)
    full = np.concatenate([ys, xs], axis=-1)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, N, H, D): rotate the interleaved (even, odd) pairs."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(x.shape)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale[:, None]) + shift[:, None]


class RMSNormLast(Module):
    """RMS norm over the last axis, computed in fp32 and cast back."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = param(dim, device=device)

    def reset_parameters(self, g):
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = f32(x)
        n = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (n * self.weight).to(x.dtype)


class LayerNormNoAffine(Module):
    """LayerNorm without scale or bias (eps 1e-6), computed in fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(f32(x), x.shape[-1:], eps=1e-6).to(x.dtype)


def _norm(dim: int, rms: bool, device) -> Module:
    return RMSNormLast(dim, device=device) if rms else LayerNormNoAffine()


class DiTAttention(Module):
    def __init__(self, dim: int, num_heads: int, use_qknorm: bool = True, device=None):
        super().__init__()
        self.num_heads = num_heads
        d = dim // num_heads
        self.qkv = Linear(dim, 3 * dim, device=device)
        if use_qknorm:
            self.q_norm = RMSNormLast(d, device=device)
            self.k_norm = RMSNormLast(d, device=device)
        self.use_qknorm = use_qknorm
        self.proj = Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor, rope: Optional[Tuple[torch.Tensor, torch.Tensor]]):
        B, N, D = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, h, D // h)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.use_qknorm:
            q, k = self.q_norm(q), self.k_norm(k)
        if rope is not None:
            q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        out = dot_product_attention(q.contiguous(), k.contiguous(), v.contiguous())
        return self.proj(out.reshape(B, N, D))


class SwiGLU(Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.w1 = Linear(dim, hidden, bias=False, device=device)
        self.w2 = Linear(dim, hidden, bias=False, device=device)
        self.w3 = Linear(hidden, dim, bias=False, device=device)

    def forward(self, x):
        return self.w3(F.silu(self.w1(x)) * self.w2(x))


class GELUMLP(Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, device=device)
        self.fc2 = Linear(hidden, dim, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def swiglu_hidden(dim: int, mlp_ratio: float) -> int:
    """The SwiGLU hidden width: 3072 at dim 1152, ratio 4."""
    return int(dim * mlp_ratio * 2 / 3 / 64) * 64


def silu_fp32(c: torch.Tensor) -> torch.Tensor:
    """The adaLN input: SiLU in fp32, cast back to c's dtype."""
    return F.silu(f32(c)).to(c.dtype)


class DiTBlock(Module):
    """adaLN-zero transformer block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, use_qknorm: bool = True,
                 use_swiglu: bool = True, use_rmsnorm: bool = True, device=None):
        super().__init__()
        self.adaLN = Linear(dim, 6 * dim, weight_init=ZEROS, bias_init=ZEROS, device=device)
        self.norm1 = _norm(dim, use_rmsnorm, device)
        self.attn = DiTAttention(dim, num_heads, use_qknorm, device=device)
        self.norm2 = _norm(dim, use_rmsnorm, device)
        self.mlp = (SwiGLU(dim, swiglu_hidden(dim, mlp_ratio), device=device) if use_swiglu
                    else GELUMLP(dim, int(dim * mlp_ratio), device=device))

    def forward(self, x, c, rope):
        sh1, sc1, g1, sh2, sc2, g2 = self.adaLN(silu_fp32(c)).chunk(6, dim=-1)
        x = x + g1[:, None] * self.attn(modulate(self.norm1(x), sh1, sc1), rope)
        return x + g2[:, None] * self.mlp(modulate(self.norm2(x), sh2, sc2))


class LightningDiT(Module):
    """DiT/SiT backbone over NHWC latent maps, predicting the velocity."""

    def __init__(self, input_size: int = 16, patch_size: int = 1, in_channels: int = 32,
                 hidden_size: int = 1152, depth: int = 28, num_heads: int = 16,
                 mlp_ratio: float = 4.0, num_classes: int = 1000,
                 class_dropout_prob: float = 0.1, use_qknorm: bool = True,
                 use_swiglu: bool = True, use_rope: bool = True, use_rmsnorm: bool = True,
                 learn_sigma: bool = False, return_features_at: Optional[int] = None,
                 device=None):
        super().__init__()
        self.input_size, self.patch_size, self.in_channels = input_size, patch_size, in_channels
        self.hidden_size, self.depth, self.num_heads = hidden_size, depth, num_heads
        self.num_classes, self.class_dropout_prob = num_classes, class_dropout_prob
        self.use_rope, self.use_rmsnorm = use_rope, use_rmsnorm
        self.return_features_at = return_features_at
        D, p = hidden_size, patch_size
        N = self.grid ** 2
        self.x_embedder = Linear(in_channels * p * p, D, device=device)
        self.pos_embed = None if use_rope else param(N, D, device=device)
        self.t_embedder_fc1 = Linear(256, D, device=device)
        self.t_embedder_fc2 = Linear(D, D, device=device)
        self.y_embedding = param(num_classes + 1, D, device=device)
        self.blocks = torch.nn.ModuleList(
            DiTBlock(D, num_heads, mlp_ratio, use_qknorm, use_swiglu, use_rmsnorm, device=device)
            for _ in range(depth))
        self.final_adaLN = Linear(D, 2 * D, weight_init=ZEROS, bias_init=ZEROS, device=device)
        self.final_norm = _norm(D, use_rmsnorm, device)
        self.out_channels = in_channels * p * p * (2 if learn_sigma else 1)
        self.final_linear = Linear(D, self.out_channels, weight_init=ZEROS, bias_init=ZEROS,
                                   device=device)
        if use_rope:
            cos, sin = rope_frequencies(D // num_heads, self.grid)
            self.register_buffer("rope_cos", torch.from_numpy(cos).to(device), persistent=False)
            self.register_buffer("rope_sin", torch.from_numpy(sin).to(device), persistent=False)

    @property
    def grid(self) -> int:
        return self.input_size // self.patch_size

    def reset_parameters(self, g):
        if self.pos_embed is not None:
            trunc_normal_(self.pos_embed, g, TRUNC02[1])
        randn_(self.y_embedding, g, 0.02)

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None,
                drop: Optional[torch.Tensor] = None, force_drop_ids: Optional[torch.Tensor] = None,
                collect_block_features: bool = False):
        """x (B, H, W, C) latents, t (B,) in [0, 1], y (B,) labels (None: the
        null class), drop (B,) bool: the training's class dropout (labels
        replaced by the null class where True), force_drop_ids likewise.
        Returns the velocity (B, H, W, C); with return_features_at, also the
        tokens after that block; with collect_block_features, also
        {embedder, block_i, final_layer: token means; repa_tokens: the
        tapped tokens, when there is a tap}."""
        from ..ops.pixelshuffle import pixel_shuffle, pixel_unshuffle

        B = x.shape[0]
        p, grid = self.patch_size, self.grid
        if p > 1:
            x = pixel_unshuffle(x, p)
        tokens = self.x_embedder(x.reshape(B, grid * grid, -1))
        if self.pos_embed is not None:
            tokens = tokens + self.pos_embed[None].to(tokens.dtype)

        t_emb = self.t_embedder_fc2(F.silu(self.t_embedder_fc1(timestep_embedding(t * 1000.0, 256))))
        if y is None:
            y = torch.full((B,), self.num_classes, dtype=torch.long, device=x.device)
        null = torch.full_like(y, self.num_classes)
        if drop is not None:
            y = torch.where(drop, null, y)
        if force_drop_ids is not None:
            y = torch.where(force_drop_ids.bool(), null, y)
        c = t_emb + self.y_embedding[y].to(t_emb.dtype)

        rope = (self.rope_cos, self.rope_sin) if self.use_rope else None
        tap = None
        feats: Dict[str, torch.Tensor] = {}
        if collect_block_features:
            feats["embedder"] = tokens.mean(1)
        for i, block in enumerate(self.blocks):
            tokens = block(tokens, c, rope)
            if i == self.return_features_at:
                tap = tokens
            if collect_block_features:
                feats[f"block_{i}"] = tokens.mean(1)

        shift, scale = self.final_adaLN(silu_fp32(c)).chunk(2, dim=-1)
        h = self.final_linear(modulate(self.final_norm(tokens), shift, scale))
        if collect_block_features:
            feats["final_layer"] = h.mean(1)
        h = h.reshape(B, grid, grid, self.out_channels)
        if p > 1:
            h = pixel_shuffle(h, p)
        if collect_block_features:
            if tap is not None:
                feats["repa_tokens"] = tap
            return h, feats
        if self.return_features_at is not None:
            return h, tap
        return h


class REPAProjector(Module):
    """REPA projector: DiT tokens (B, T, D) -> VFM feature width (fc1 to
    2 * out_dim, SiLU, fc2)."""

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.fc1 = Linear(in_dim, 2 * out_dim, device=device)
        self.fc2 = Linear(2 * out_dim, out_dim, device=device)

    def forward(self, x):
        return self.fc2(F.silu(self.fc1(x)))


def dit_xl_1(**kw) -> LightningDiT:
    return LightningDiT(hidden_size=1152, depth=28, num_heads=16, patch_size=1, **kw)


def dit_b_1(**kw) -> LightningDiT:
    return LightningDiT(hidden_size=768, depth=12, num_heads=12, patch_size=1, **kw)

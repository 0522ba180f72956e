"""Vision transformer towers in plain PyTorch (port of
vfm_vae_tpu/models/vit.py: SigLIPVisionTower with its MAPHead,
Dinov2Tower, MAETower, MultiHeadSelfAttention, ViTMLP, ViTBlock with its
LayerScale, interpolate_pos_embed, _sincos_pos_embed_2d).

Parameter names follow each tower's checkpoint layout: HF's
SiglipVisionTransformer (embeddings.*, encoder.layers.N.*,
post_layernorm.*, head.*), HF's Dinov2Model (embeddings.*,
encoder.layer.N.{norm1, attention, layer_scale1, norm2, mlp,
layer_scale2}, layernorm.*) and HF's ViTMAEModel (embeddings.*,
encoder.layer.N.{layernorm_before, attention, layernorm_after,
intermediate, output}, layernorm.*). Attention runs through
ops.attention: PyTorch's SDPA by default, as the JAX package leaves it to
XLA's, and the K4 flash kernel where its opt-in rule admits the shape (a
CLS token makes 1 + grid^2 tokens, which it never admits). Under the int8
scope the Linears run W8A8 through K6 (ops/quantized.py).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_product_attention
from ..ops.bias_act import apply_activation
from ..ops.resize import resize_matrix
from .layers import LayerNormFp32, Linear, Module, holder, param, randn_, uniform_

# Hidden states, the last sequence and the pooled output of a tower call.
TowerOutput = Tuple[Dict[int, torch.Tensor], torch.Tensor, Optional[torch.Tensor]]


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


def collect_set(collect: Optional[Sequence[int]], num_layers: int) -> set:
    """The hidden-state indices a tower keeps (all of them for None)."""
    return set(collect) if collect is not None else set(range(num_layers + 1))


class MultiHeadSelfAttention(Module):
    """q/k/v/out projections with biases. `hf` names them as HF's ViT family
    does (attention.{query, key, value}, output.dense) instead of SigLIP's
    (q_proj, k_proj, v_proj, out_proj)."""

    def __init__(self, dim: int, num_heads: int, hf: bool = False, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        lin = [Linear(dim, dim, device=device) for _ in range(4)]
        if hf:
            self.attention = holder(query=lin[0], key=lin[1], value=lin[2])
            self.output = holder(dense=lin[3])
        else:
            self.q_proj, self.k_proj, self.v_proj, self.out_proj = lin
        self.plain = False  # select K4's plain twin on the card (comparisons only)

    def projections(self) -> Tuple[Linear, Linear, Linear, Linear]:
        if hasattr(self, "q_proj"):
            return self.q_proj, self.k_proj, self.v_proj, self.out_proj
        a = self.attention
        return a.query, a.key, a.value, self.output.dense

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        h = self.num_heads
        wq, wk, wv, wo = self.projections()
        q = wq(x).reshape(B, N, h, D // h)
        k = wk(x).reshape(B, N, h, D // h)
        v = wv(x).reshape(B, N, h, D // h)
        out = dot_product_attention(q, k, v, plain=self.plain)
        return wo(out.reshape(B, N, D))


class ViTMLP(Module):
    def __init__(self, dim: int, hidden_dim: int, act: str = "gelu_tanh", device=None):
        super().__init__()
        self.act = act
        self.fc1 = Linear(dim, hidden_dim, device=device)
        self.fc2 = Linear(hidden_dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(apply_activation(self.fc1(x), self.act))


class LayerScale(Module):
    """DINOv2's per-channel residual scale (HF Dinov2LayerScale), ones at init."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.lambda1 = param(dim, device=device)

    def reset_parameters(self, g):
        self.lambda1.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.lambda1.to(x.dtype)


# A block's state_dict names in each checkpoint layout: the norm before the
# attention, the attention, the norm before the MLP.
BLOCK_LAYOUTS = {
    "siglip": ("layer_norm1", "self_attn", "layer_norm2"),
    "dinov2": ("norm1", "attention", "norm2"),
    "mae": ("layernorm_before", "attention", "layernorm_after"),
}


class ViTBlock(Module):
    """Pre-LN block (vit.py:102-129); `act` "gelu" is the exact GELU of the
    DINO and MAE blocks, "gelu_tanh" SigLIP's; `layer_scale` adds DINOv2's
    LayerScale after the attention and after the MLP (layer_scale1,
    layer_scale2). `layout` names the parameters (BLOCK_LAYOUTS; the MAE
    layout keeps the MLP as intermediate.dense and output.dense)."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, eps: float = 1e-6,
                 act: str = "gelu_tanh", layer_scale: bool = False, layout: str = "siglip",
                 device=None):
        super().__init__()
        self.names = BLOCK_LAYOUTS[layout]
        self.act = act
        n1, attn, n2 = self.names
        self.add_module(n1, LayerNormFp32(dim, eps, device=device))
        self.add_module(attn, MultiHeadSelfAttention(dim, num_heads, hf=layout != "siglip",
                                                     device=device))
        self.add_module(n2, LayerNormFp32(dim, eps, device=device))
        if layout == "mae":
            self.intermediate = holder(dense=Linear(dim, mlp_dim, device=device))
            self.output = holder(dense=Linear(mlp_dim, dim, device=device))
        else:
            self.mlp = ViTMLP(dim, mlp_dim, act, device=device)
        if layer_scale:
            self.layer_scale1 = LayerScale(dim, device=device)
            self.layer_scale2 = LayerScale(dim, device=device)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "mlp"):
            return self.mlp(x)
        return self.output.dense(apply_activation(self.intermediate.dense(x), self.act))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n1, attn, n2 = (getattr(self, n) for n in self.names)
        h = attn(n1(x))
        if hasattr(self, "layer_scale1"):
            h = self.layer_scale1(h)
        x = x + h
        h = self._mlp(n2(x))
        if hasattr(self, "layer_scale2"):
            h = self.layer_scale2(h)
        return x + h


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
    """SigLIP attention-pooling head (vit.py MAPHead): a learned probe token
    attends over the sequence through torch MultiheadAttention's packed
    in-projection, then a residual LayerNorm + MLP. It runs only when a
    caller asks the encoder for the pooled output."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.probe = param(1, 1, dim, device=device)
        self.attention = _MultiheadAttentionParams(dim, device=device)
        self.layernorm = LayerNormFp32(dim, eps, device=device)
        self.mlp = ViTMLP(dim, mlp_dim, device=device)

    def reset_parameters(self, g):
        randn_(self.probe, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        h = self.num_heads
        a = self.attention
        wq, wk, wv = a.in_proj_weight.to(x.dtype).chunk(3, dim=0)
        bq, bk, bv = a.in_proj_bias.to(x.dtype).chunk(3, dim=0)
        q = self.probe.to(x.dtype).expand(B, 1, D) @ wq.t() + bq
        k = x @ wk.t() + bk
        v = x @ wv.t() + bv
        out = dot_product_attention(q.reshape(B, 1, h, D // h), k.reshape(B, N, h, D // h),
                                    v.reshape(B, N, h, D // h))
        out = a.out_proj(out.reshape(B, 1, D))
        out = out + self.mlp(self.layernorm(out))
        return out[:, 0]


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
    (hidden_states, last, pooled): hidden-state index 0 is the embeddings
    output, i the output of block i; `last` is the post-LN final sequence;
    `pooled` the MAP head's output (None unless `need_pooled`)."""

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

    def forward(self, pixels: torch.Tensor, collect: Optional[Sequence[int]] = None,
                need_pooled: bool = False) -> TowerOutput:
        x, gh, gw = self.embeddings.patch_embedding(pixels)
        pos = self.embeddings.position_embedding.weight
        if (gh, gw) != (self.grid, self.grid):
            pos = interpolate_pos_embed(pos, self.grid, gh, gw, mode="bicubic")
        x = x + pos.to(x.dtype)[None]
        layers: List[ViTBlock] = list(self.encoder.layers)
        want = collect_set(collect, len(layers))
        hidden: Dict[int, torch.Tensor] = {0: x} if 0 in want else {}
        for i, block in enumerate(layers):
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
            if i + 1 in want:
                hidden[i + 1] = x
        last = self.post_layernorm(x)
        return hidden, last, self.head(last) if need_pooled else None


def run_blocks(blocks: Sequence[nn.Module], x: torch.Tensor, want: set, *args
               ) -> Tuple[Dict[int, torch.Tensor], torch.Tensor]:
    """x through `blocks` (each called as block(x, *args)), keeping the
    hidden states whose index is in `want` (0 the input, i the output of
    block i)."""
    hidden: Dict[int, torch.Tensor] = {0: x} if 0 in want else {}
    for i, block in enumerate(blocks):
        x = block(x, *args)
        if i + 1 in want:
            hidden[i + 1] = x
    return hidden, x


class _ClsEmbeddings(Module):
    """HF ViT-family embeddings: a CLS token, a patch projection
    (patch_embeddings.projection) and, where `learned`, a position table
    (1, 1 + grid^2, D) and DINOv2's mask token (carried: no path masks
    patches)."""

    def __init__(self, dim: int, patch: int, grid: int, learned: bool, device=None):
        super().__init__()
        self.cls_token = param(1, 1, dim, device=device)
        if learned:
            self.mask_token = param(1, dim, device=device)
            self.position_embeddings = param(1, 1 + grid * grid, dim, device=device)
        self.patch_embeddings = holder(projection=_PatchEmbedding(3, dim, patch, device=device))

    def reset_parameters(self, g):
        self.cls_token.zero_()
        if hasattr(self, "mask_token"):
            self.mask_token.zero_()
            randn_(self.position_embeddings, g, 0.02)


class Dinov2Tower(Module):
    """HF Dinov2Model equivalent (vit.py:209-282): CLS token + grid position
    table, bicubic-interpolated in fp32 for other grids; exact-GELU blocks
    with LayerScale; a final LN; pooled = the CLS of the normalized
    sequence. Hidden states carry the CLS prefix (the facade strips it)."""

    def __init__(self, hidden_size: int = 1024, num_layers: int = 24, num_heads: int = 16,
                 mlp_dim: int = 4096, patch_size: int = 14, image_size: int = 518,
                 eps: float = 1e-6, device=None):
        super().__init__()
        self.grid = image_size // patch_size
        self.embeddings = _ClsEmbeddings(hidden_size, patch_size, self.grid, True, device=device)
        self.encoder = holder(layer=nn.ModuleList(
            ViTBlock(hidden_size, num_heads, mlp_dim, eps, "gelu", layer_scale=True,
                     layout="dinov2", device=device) for _ in range(num_layers)))
        self.layernorm = LayerNormFp32(hidden_size, eps, device=device)

    def forward(self, pixels: torch.Tensor, collect: Optional[Sequence[int]] = None,
                need_pooled: bool = True) -> TowerOutput:
        emb = self.embeddings
        x, gh, gw = emb.patch_embeddings.projection(pixels)
        B, _, D = x.shape
        pos = emb.position_embeddings[0]
        if (gh, gw) != (self.grid, self.grid):
            pos = torch.cat([pos[:1], interpolate_pos_embed(pos[1:], self.grid, gh, gw)], dim=0)
        x = torch.cat([emb.cls_token.to(x.dtype).expand(B, 1, D), x], dim=1)
        x = x + pos.to(x.dtype)[None]
        layers = self.encoder.layer
        hidden, x = run_blocks(layers, x, collect_set(collect, len(layers)))
        last = self.layernorm(x)
        return hidden, last, last[:, 0] if need_pooled else None


def _sincos_pos_embed_2d(dim: int, grid: int) -> np.ndarray:
    """MAE's fixed 2D sin-cos position embedding with a zero CLS row (vit.py:366-383)."""

    def get_1d(d, positions):
        omega = np.arange(d // 2, dtype=np.float64) / (d / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", positions.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    coords = np.arange(grid, dtype=np.float64)
    gw, gh = np.meshgrid(coords, coords)
    pos = np.concatenate([get_1d(dim // 2, gh), get_1d(dim // 2, gw)], axis=1)
    return np.concatenate([np.zeros((1, dim)), pos], axis=0).astype(np.float32)


class MAETower(Module):
    """HF ViTMAEModel encoder equivalent (vit.py:285-363): CLS + the fixed
    sin-cos buffer (embeddings.position_embeddings), exact-GELU blocks with
    eps 1e-12, a final LN; pooled = the mean over the patch tokens. No
    dynamic resolution: another input size raises, as the JAX tower asserts.
    `mask_ratio > 0` with a torch.Generator keeps a random
    (1 - mask_ratio) of the patch tokens, as HF's random masking does."""

    def __init__(self, hidden_size: int = 1024, num_layers: int = 24, num_heads: int = 16,
                 mlp_dim: int = 4096, patch_size: int = 16, image_size: int = 224,
                 eps: float = 1e-12, mask_ratio: float = 0.0, device=None):
        super().__init__()
        self.image_size, self.mask_ratio = image_size, mask_ratio
        grid = image_size // patch_size
        self.embeddings = _ClsEmbeddings(hidden_size, patch_size, grid, False, device=device)
        self.embeddings.register_buffer("position_embeddings", torch.from_numpy(
            _sincos_pos_embed_2d(hidden_size, grid))[None].to(device))
        self.encoder = holder(layer=nn.ModuleList(
            ViTBlock(hidden_size, num_heads, mlp_dim, eps, "gelu", layout="mae", device=device)
            for _ in range(num_layers)))
        self.layernorm = LayerNormFp32(hidden_size, eps, device=device)

    def forward(self, pixels: torch.Tensor, collect: Optional[Sequence[int]] = None,
                need_pooled: bool = True, mask_generator: Optional[torch.Generator] = None
                ) -> TowerOutput:
        if tuple(pixels.shape[1:3]) != (self.image_size, self.image_size):
            raise ValueError(f"MAE has no dynamic resolution: input {tuple(pixels.shape[1:3])}, "
                             f"tower {self.image_size} px")
        emb = self.embeddings
        x, _, _ = emb.patch_embeddings.projection(pixels)
        B, N, D = x.shape
        pos = emb.position_embeddings[0]
        x = x + pos[1:].to(x.dtype)[None]
        if self.mask_ratio > 0 and mask_generator is not None:
            keep = torch.rand((B, N), generator=mask_generator, device=x.device).argsort(dim=1)
            keep = keep[:, :int(N * (1 - self.mask_ratio))]
            x = torch.gather(x, 1, keep[:, :, None].expand(-1, -1, D))
        cls = emb.cls_token.to(x.dtype).expand(B, 1, D) + pos[:1].to(x.dtype)
        x = torch.cat([cls, x], dim=1)
        layers = self.encoder.layer
        hidden, x = run_blocks(layers, x, collect_set(collect, len(layers)))
        last = self.layernorm(x)
        return hidden, last, last[:, 1:].mean(1) if need_pooled else None

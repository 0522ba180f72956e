"""LDM adapter (port of vfm_vae_tpu/models/adapter.py: PlainAttention,
GeGluMlp, AttnProjectionBlock, AttnProjection, EquivarianceTransform,
LDMAdapter encode/decode and its training encode). Both compression modes:
continuous (the diagonal Gaussian, with the KL loss) and discrete (the
multi-codebook VQ of models/quantize.py, with the VQ and entropy losses);
both compress and decompress forms: attnproj (attention projections) and
conv (1x1 convolutions on the tokens). Parameter keys follow the reference
(ldm_utils.py): patch_quants.N.0.*, final_quant.*, post_quant.*,
quantizer.codebooks.J.*, linear_proj.weight."""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from ..ops.pixelshuffle import pixel_unshuffle
from ..ops.resize import _adaptive_matrix, adaptive_avg_pool2d
from .dataclasses import EncodeOutput
from .distributions import DiagonalGaussianDistribution
from .layers import TRUNC02, Conv2d, LayerNormFp32, Linear, Module, holder, l2_normalize, param
from .quantize import VectorQuantizerM

XAVIER05 = ("xavier_normal", 0.5)


def tokens_to_map(x: torch.Tensor) -> torch.Tensor:
    B, N, D = x.shape
    s = math.isqrt(N)
    if s * s != N:
        raise ValueError(f"tokens_to_map: {N} tokens are not a square grid")
    return x.reshape(B, s, s, D)


def map_to_tokens(x: torch.Tensor) -> torch.Tensor:
    B, H, W, D = x.shape
    return x.reshape(B, H * W, D)


class PlainAttention(Module):
    """Dimension-changing attention (ldm_utils.py:55-93): qkv biases
    (q_bias, 0, v_bias); for in_dim > out_dim the output is the head mean,
    adaptively pooled to out_dim when the head width differs.

    VFM_VAE_ADAPTER_ATTN picks the form, as in the JAX package
    (adapter.py:63-87): "3mm-xla" (default) three products from slices of
    the packed weight and SDPA; "3mm-flash" the same products with the flash
    path preferred; anything else ("packed") one packed product, a
    contiguous last-axis split into q, k, v and the flash path preferred.
    The flash path (K4) runs where ops.attention's rule admits the shape."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int, device=None):
        super().__init__()
        self.in_dim, self.out_dim, self.num_heads = in_dim, out_dim, num_heads
        self.wide = max(in_dim, out_dim)
        self.qkv = Linear(in_dim, 3 * self.wide, bias=False, weight_init=TRUNC02, device=device)
        self.q_bias = param(self.wide, device=device)
        self.v_bias = param(self.wide, device=device)
        self.proj = Linear(out_dim, out_dim, weight_init=TRUNC02, bias_init="zeros", device=device)
        self.plain = False  # select K4's plain twin on the card (comparisons only)

    def reset_parameters(self, g):
        self.q_bias.zero_()
        self.v_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        wide, heads = self.wide, self.num_heads
        hd = wide // heads
        w = self.qkv.weight.to(x.dtype)
        variant = os.environ.get("VFM_VAE_ADAPTER_ATTN", "3mm-xla")
        if variant.startswith("3mm"):
            q = x @ w[:wide].t() + self.q_bias.to(x.dtype)
            k = x @ w[wide:2 * wide].t()
            v = x @ w[2 * wide:].t() + self.v_bias.to(x.dtype)
            prefer = variant == "3mm-flash"
        else:
            bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
            qkv = x @ w.t() + bias.to(x.dtype)
            # The split's views keep the packed row stride; the kernel takes
            # contiguous operands.
            q, k, v = (t.contiguous() for t in qkv.split(wide, dim=-1))
            prefer = True
        out = dot_product_attention(q.reshape(B, N, heads, hd), k.reshape(B, N, heads, hd),
                                    v.reshape(B, N, heads, hd), prefer_flash=prefer,
                                    plain=self.plain)
        if self.in_dim > self.out_dim:
            out = out.mean(dim=2)
            if hd != self.out_dim:
                m = torch.from_numpy(_adaptive_matrix(hd, self.out_dim)).to(out)
                out = out @ m.t()
        else:
            out = out.reshape(B, N, wide)
        return self.proj(out)


class GeGluMlp(Module):
    """LN -> gelu_tanh(w0 x) * w1 x -> w2 (ldm_utils.py:96-114)."""

    def __init__(self, in_features: int, hidden_features: int, device=None):
        super().__init__()
        self.norm = LayerNormFp32(in_features, eps=1e-6, device=device)
        self.w0 = Linear(in_features, hidden_features, weight_init=TRUNC02, bias_init="zeros",
                         device=device)
        self.w1 = Linear(in_features, hidden_features, weight_init=TRUNC02, bias_init="zeros",
                         device=device)
        self.w2 = Linear(hidden_features, in_features, weight_init=TRUNC02, bias_init="zeros",
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(x)
        return self.w2(F.gelu(self.w0(x), approximate="tanh") * self.w1(x))


class AttnProjectionBlock(Module):
    """x = proj(norm3(x)) + attn(norm1(x)); x = x + mlp(norm2(x)) (ldm_utils.py:117-138)."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int, mlp_ratio: int = 2, device=None):
        super().__init__()
        self.norm1 = LayerNormFp32(in_dim, device=device)
        self.norm2 = LayerNormFp32(out_dim, device=device)
        self.norm3 = LayerNormFp32(in_dim, device=device)
        self.attn = PlainAttention(in_dim, out_dim, num_heads, device=device)
        self.proj = Linear(in_dim, out_dim, weight_init=TRUNC02, bias_init="zeros", device=device)
        self.mlp = GeGluMlp(out_dim, int(out_dim * mlp_ratio), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(self.norm3(x)) + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class AttnProjection(Module):
    """Quant stacks change width in their last block, post-quant stacks in
    their first (ldm_utils.py:140-166)."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int, num_layers: int,
                 is_quant: bool, mlp_ratio: int = 2, device=None):
        super().__init__()
        blocks = []
        for i in range(num_layers):
            if is_quant:
                din, dout = in_dim, (in_dim if i < num_layers - 1 else out_dim)
            else:
                din, dout = (in_dim if i == 0 else out_dim), out_dim
            blocks.append(AttnProjectionBlock(din, dout, num_heads, mlp_ratio, device=device))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


class EquivarianceTransform:
    """Host-side EQ bucket sampler (ldm_utils.py:491-517): returns
    (scale, rot90 angle, is_prior) drawn from an explicit numpy Generator."""

    SCALES = (0.25, 0.5, 0.75, 1.0)
    PRIOR_SCALES = (0.25, 0.5, 0.75)

    def __init__(self, apply: bool = False, p_eq_prior: float = 0.5,
                 p_eq_prior_scale: float = 0.25):
        self.apply = apply
        self.p_eq_prior = p_eq_prior
        self.p_eq_prior_scale = p_eq_prior_scale

    def __call__(self, rng: np.random.Generator, validation: bool = False
                 ) -> Tuple[float, int, bool]:
        if not self.apply or validation:
            return 1.0, 0, False
        if rng.random() < self.p_eq_prior:
            return float(rng.choice(self.SCALES)), int(rng.integers(0, 4)), False
        if rng.random() < self.p_eq_prior_scale:
            return float(rng.choice(self.PRIOR_SCALES)), 0, True
        return 1.0, 0, True


class LDMAdapter(Module):
    """Compress multi-level VFM features into z and decompress (ldm_utils.py:199-488)."""

    def __init__(self, patch_from_layers: Sequence[int], patch_resolutions: Sequence[int],
                 patch_in_dimensions: Sequence[int], patch_out_dimensions: Sequence[int],
                 decompress_factor: int, attnproj_quant_layers: int = 1,
                 attnproj_post_quant_layers: int = 1, z_resolution: int = 16,
                 z_dimension: int = 32, use_vf_loss: bool = False, use_kl_loss: bool = False,
                 distmat_margin: float = 0.0, cos_margin: float = 0.0,
                 distmat_weight: float = 1.0, cos_weight: float = 1.0,
                 compression_mode: str = "continuous", how_to_compress: str = "attnproj",
                 how_to_decompress: str = "attnproj", vocab_width: int = 64,
                 vocab_size: int = 32768, vocab_beta: float = 0.25,
                 use_entropy_loss: bool = False, entropy_temp: float = 0.01,
                 num_codebooks: int = 8, device=None):
        super().__init__()
        for name, v, ok in (("compression_mode", compression_mode, ("continuous", "discrete")),
                            ("how_to_compress", how_to_compress, ("attnproj", "conv")),
                            ("how_to_decompress", how_to_decompress, ("attnproj", "conv"))):
            if v not in ok:
                raise ValueError(f"LDMAdapter: {name} {v!r} is not one of {ok}")
        self.patch_resolutions = list(patch_resolutions)
        self.z_resolution = z_resolution
        self.discrete = compression_mode == "discrete"
        self.how_to_compress = how_to_compress
        self.use_vf_loss, self.use_kl_loss = use_vf_loss, use_kl_loss
        self.distmat_margin, self.cos_margin = distmat_margin, cos_margin
        self.distmat_weight, self.cos_weight = distmat_weight, cos_weight
        self.vf_index = list(patch_from_layers).index(-1) if use_vf_loss else None
        final_in = sum(dout * (res // z_resolution) ** 2 if res > z_resolution else dout
                       for res, dout in zip(patch_resolutions, patch_out_dimensions))
        final_out = vocab_width if self.discrete else 2 * z_dimension

        def compress(din, dout):
            if how_to_compress == "conv":  # a 1x1 convolution on tokens is a product
                return Conv2d(din, dout, 1, weight_init=XAVIER05, bias_init="zeros",
                              device=device)
            return AttnProjection(din, dout, max(1, din // dout), attnproj_quant_layers, True,
                                  device=device)

        self.patch_quants = nn.ModuleList(
            holder(**{"0": compress(din, dout)})
            for din, dout in zip(patch_in_dimensions, patch_out_dimensions))
        self.final_quant = compress(final_in, final_out)
        in_ch = vocab_width if self.discrete else z_dimension
        out_ch = in_ch * decompress_factor
        if how_to_decompress == "conv":
            self.post_quant = Conv2d(in_ch, out_ch, 1, weight_init=XAVIER05, bias_init="zeros",
                                     device=device)
        else:
            self.post_quant = AttnProjection(in_ch, out_ch, max(1, out_ch // in_ch),
                                             attnproj_post_quant_layers, False, device=device)
        if self.discrete:
            self.quantizer = VectorQuantizerM(vocab_size, vocab_width, vocab_beta,
                                              use_entropy_loss, entropy_temp, num_codebooks,
                                              device=device)
        if use_vf_loss:
            vf_dim = patch_in_dimensions[list(patch_from_layers).index(-1)]
            self.linear_proj = Conv2d(in_ch, vf_dim, 1, bias=False, weight_init=XAVIER05,
                                      device=device)

    def moments(self, patch_features: List[torch.Tensor]) -> torch.Tensor:
        """Features -> final_quant's map (B, zr, zr, C): the (mean || logvar)
        moments in continuous mode, z before quantization in discrete mode;
        a smaller EQ-prior grid gives a proportionally smaller zr."""
        mids = []
        for x, pq, res in zip(patch_features, self.patch_quants, self.patch_resolutions):
            x = getattr(pq, "0")(x)
            if res > self.z_resolution:
                x = map_to_tokens(pixel_unshuffle(tokens_to_map(x), res // self.z_resolution))
            mids.append(x)
        return tokens_to_map(self.final_quant(torch.cat(mids, dim=-1)))

    def _latent(self, x_map: torch.Tensor, generator: Optional[torch.Generator],
                update_buffers: bool):
        """final_quant's map -> (z, kl_loss, vq_loss, entropy_loss, usage_pct);
        the losses a mode does not have are zero scalars."""
        zero = x_map.new_zeros(())
        if self.discrete:
            z, vq, ent, usage = self.quantizer(map_to_tokens(x_map), update_buffers)
            return tokens_to_map(z), zero, vq, ent, usage
        dist = DiagonalGaussianDistribution(x_map)
        z = dist.mode() if generator is None else dist.sample(generator)
        kl = dist.kl().mean() if self.use_kl_loss else zero
        return z, kl, zero, zero, zero

    def encode(self, patch_features: List[torch.Tensor],
               generator: Optional[torch.Generator] = None,
               return_z_before_quantize: bool = False) -> torch.Tensor:
        """Features -> z (B, zr, zr, z_dim): the posterior mode or a sample
        drawn with `generator` (continuous), the quantized tokens (discrete;
        the usage buffers do not move); or final_quant's map."""
        x_map = self.moments(patch_features)
        if return_z_before_quantize:
            return x_map
        return self._latent(x_map, generator, False)[0]

    def encode_train(self, patch_features: List[torch.Tensor],
                     generator: Optional[torch.Generator] = None,
                     update_buffers: bool = False) -> EncodeOutput:
        """Training encode (adapter.py:350-404): z (continuous: the mode, or
        a posterior sample drawn with `generator`; discrete: the quantized
        tokens, the usage buffers updated with `update_buffers`), the VF loss
        against the detached last-layer features, and the mode's losses;
        each loss is a zero scalar when off."""
        z, kl_loss, vq_loss, entropy_loss, usage = self._latent(
            self.moments(patch_features), generator, update_buffers)
        vf_loss = z.new_zeros(())
        if self.use_vf_loss:
            aux_map = tokens_to_map(patch_features[self.vf_index].detach())
            ht = z.shape[1]
            if aux_map.shape[1] != ht:
                aux_map = adaptive_avg_pool2d(aux_map, (ht, ht))
            vf_loss = self.vf_loss(self.linear_proj(z), aux_map)
        return EncodeOutput(z, vf_loss, kl_loss, vq_loss, entropy_loss, usage)

    def vf_loss(self, z_map: torch.Tensor, aux_map: torch.Tensor) -> torch.Tensor:
        """Pairwise channel-cosine distance matrix + per-pixel cosine
        (adapter.py:334-347, ldm_utils.py:385-395)."""
        z_n = l2_normalize(map_to_tokens(z_map).float(), dim=-1)
        aux_n = l2_normalize(map_to_tokens(aux_map).float(), dim=-1)
        z_cos = torch.einsum("bic,bjc->bij", z_n, z_n)
        aux_cos = torch.einsum("bic,bjc->bij", aux_n, aux_n)
        loss_1 = torch.relu((z_cos - aux_cos).abs() - self.distmat_margin).mean()
        loss_2 = torch.relu(1.0 - self.cos_margin - (z_n * aux_n).sum(-1)).mean()
        return loss_1 * self.distmat_weight + loss_2 * self.cos_weight

    def vf_anchor(self) -> torch.nn.Parameter:
        """The adaptive VF weight's anchor (adapter.py:406-413): final_quant's
        weight (conv), else the last final-quant block's GeGLU output projection."""
        if self.how_to_compress == "conv":
            return self.final_quant.weight
        return self.final_quant.blocks[-1].mlp.w2.weight

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, H, W, z_dim) -> (B, H, W, z_dim * decompress_factor)."""
        B, H, W, _ = z.shape
        return self.post_quant(map_to_tokens(z)).reshape(B, H, W, -1)

    @torch.no_grad()
    def f_to_idx(self, patch_features: List[torch.Tensor]) -> torch.Tensor:
        """Features -> code indices (B, num_codebooks, zr * zr) (adapter.py:420-425)."""
        return self.quantizer.f_to_idx(map_to_tokens(self.moments(patch_features)))

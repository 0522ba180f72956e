"""Projected discriminator (port of vfm_vae_tpu/models/discriminator.py:
DINOBackbone, SpectralConv1d, BatchNormLocal, DiscBlock, DiscHead, the
PatchGAN branch's BatchNormLocal2d, NLayerDiscriminator and
MultiscaleDiscriminator, and ProjectedDiscriminator; reference
networks/discriminator.py).

StyleGAN-T branch: DiffAugment -> random crop (probability p_crop) or
antialiased resize to the DINO input size -> ImageNet normalisation ->
frozen DINO ViT-S/16 with DPT taps -> one spectral-norm conv1d head per
tap. DINO's parameters never train, but the gradient flows through it to
the image. Token-major (B, N, C) activations. PatchGAN branch (stage 3):
the pix2pixHD three-scale N-layer discriminator on the unaugmented image,
NHWC, with every layer's output as features (get_interm_feat). Class
conditioning (c_dim > 0) and a D without the StyleGAN-T branch are not
ported and raise.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bicubic, resize_bilinear
from ..train.diffaug import diff_augment, sample_draws
from .dataclasses import DiscriminatorForwardOutput
from .layers import Conv2d, Module, init_parameters, l2_normalize, param, randn_, uniform_
from .vit import ViTBlock, _PatchEmbedding, interpolate_pos_embed

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class DINOBackbone(Module):
    """timm vit_small_patch16_224_dino with DPT-style taps (discriminator.py:35-100):
    patch embedding + CLS + bilinear pos-embed resize; activations tapped
    after the position add and after blocks `hooks`; the CLS token is added
    to every other token (AddReadout). Returns (B, N, D) per tap."""

    def __init__(self, hidden_size: int = 384, num_layers: int = 12, num_heads: int = 6,
                 mlp_dim: int = 1536, patch_size: int = 16, image_size: int = 224,
                 hooks: Sequence[int] = (2, 5, 8, 11), hook_patch: bool = True, device=None):
        super().__init__()
        self.hidden_size, self.image_size = hidden_size, image_size
        self.grid = image_size // patch_size
        self.hooks, self.hook_patch = list(hooks), hook_patch
        self.patch_embed = _PatchEmbedding(3, hidden_size, patch_size, device=device)
        self.cls_token = param(1, 1, hidden_size, device=device)
        self.pos_embed = param(1 + self.grid * self.grid, hidden_size, device=device)
        self.blocks = nn.ModuleList(
            ViTBlock(hidden_size, num_heads, mlp_dim, eps=1e-6, act="gelu", device=device)
            for _ in range(num_layers))

    @property
    def n_hooks(self) -> int:
        return len(self.hooks) + int(self.hook_patch)

    def reset_parameters(self, g):
        self.cls_token.zero_()
        randn_(self.pos_embed, g, 0.02)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        B = x.shape[0]
        t, gh, gw = self.patch_embed(x)
        pos = self.pos_embed
        if (gh, gw) != (self.grid, self.grid):
            pos = torch.cat([pos[:1], interpolate_pos_embed(pos[1:], self.grid, gh, gw,
                                                            mode="bilinear")], dim=0)
        cls = self.cls_token.to(t.dtype).expand(B, 1, -1)
        t = torch.cat([cls, t], dim=1) + pos.to(t.dtype)[None]
        taps = [t] if self.hook_patch else []
        for i, blk in enumerate(self.blocks):
            t = blk(t)
            if i in self.hooks:
                taps.append(t)
        return [a[:, 1:] + a[:, :1] for a in taps]


class SpectralConv1d(Module):
    """Conv1d over the token axis with spectral normalisation (torch
    SpectralNorm, dim 0): one power iteration per training forward, its u
    and v buffers replaced out of place and detached, so autograd sees no
    in-place change; sigma = u . (W v) carries the weight's gradient."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 circular: bool = False, device=None):
        super().__init__()
        self.kernel_size, self.circular = kernel_size, circular
        self.weight = param(out_channels, in_channels, kernel_size, device=device)
        self.bias = param(out_channels, device=device)
        self.register_buffer("u", torch.empty(out_channels, device=device))
        self.register_buffer("v", torch.empty(in_channels * kernel_size, device=device))

    def reset_parameters(self, g):
        bound = 1.0 / math.sqrt(self.weight.shape[1] * self.kernel_size)
        uniform_(self.weight, g, bound)
        uniform_(self.bias, g, bound)
        for b in (self.u, self.v):
            randn_(b, g)
            b.div_(b.norm())

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        w_mat = self.weight.reshape(self.weight.shape[0], -1).float()
        u, v = self.u, self.v
        if train:
            with torch.no_grad():
                v = l2_normalize(w_mat.t() @ u, dim=0)
                u = l2_normalize(w_mat @ v, dim=0)
            self.u, self.v = u, v
        sigma = torch.dot(u, w_mat @ v)
        w = (self.weight / sigma).to(x.dtype)
        k = self.kernel_size
        pad = k // 2
        if k > 1 and self.circular:
            x = torch.cat([x[:, -pad:], x, x[:, :pad]], dim=1)
            pad = 0
        y = F.conv1d(x.transpose(1, 2), w, padding=pad).transpose(1, 2)
        return y + self.bias.to(y.dtype)


class BatchNormLocal(Module):
    """Virtual-batch norm over (group, token) per channel (discriminator.py:166-188)."""

    def __init__(self, num_features: int, virtual_bs: int = 8, eps: float = 1e-5, device=None):
        super().__init__()
        self.virtual_bs, self.eps = virtual_bs, eps
        self.weight = param(num_features, device=device)
        self.bias = param(num_features, device=device)

    def reset_parameters(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        groups = -(-B // self.virtual_bs)
        xf = x.float().reshape(groups, -1, N, C)
        mean = xf.mean(dim=(1, 2), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
        xf = ((xf - mean) / torch.sqrt(var + self.eps)).reshape(B, N, C)
        return (xf * self.weight + self.bias).to(x.dtype)


class DiscBlock(Module):
    def __init__(self, channels: int, kernel_size: int, device=None):
        super().__init__()
        self.conv = SpectralConv1d(channels, channels, kernel_size, circular=kernel_size > 1,
                                   device=device)
        self.bn = BatchNormLocal(channels, device=device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return F.leaky_relu(self.bn(self.conv(x, train)), 0.2)


class DiscHead(Module):
    """Spectral conv1d head over the token axis (discriminator.py:207-228),
    unconditional: (B, N, C) -> (B, N) logits."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.main0 = DiscBlock(channels, 1, device=device)
        self.main1 = DiscBlock(channels, 9, device=device)
        self.cls = SpectralConv1d(channels, 1, 1, device=device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        h = self.main0(x, train)
        h = (self.main1(h, train) + h) / math.sqrt(2)
        out = self.cls(h, train)
        return out.reshape(out.shape[0], -1)


class BatchNormLocal2d(Module):
    """Virtual-batch norm over (group batch, H, W) per channel, NHWC
    (discriminator.py:231-254)."""

    def __init__(self, num_features: int, virtual_bs: int = 8, eps: float = 1e-5, device=None):
        super().__init__()
        self.virtual_bs, self.eps = virtual_bs, eps
        self.weight = param(num_features, device=device)
        self.bias = param(num_features, device=device)

    def reset_parameters(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        groups = -(-B // self.virtual_bs)
        xf = x.float().reshape(groups, -1, H, W, C)
        mean = xf.mean(dim=(1, 2, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 2, 3), keepdim=True)
        xf = ((xf - mean) / torch.sqrt(var + self.eps)).reshape(B, H, W, C)
        return (xf * self.weight + self.bias).to(x.dtype)


# pix2pixHD weights_init: normal(0, 0.02) (discriminator.py:257).
PATCHGAN_CONV_INIT = ("normal", 0.02)


class NLayerDiscriminator(Module):
    """pix2pixHD N-layer conv discriminator (discriminator.py:262-303):
    4x4 convolutions padded by 2, strides 2 then 1, leaky ReLU 0.2 and
    BatchNormLocal2d after every convolution but the first and the last."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 get_interm_feat: bool = False, device=None):
        super().__init__()
        self.n_layers, self.get_interm_feat = n_layers, get_interm_feat

        def conv(name, cin, cout, stride):
            self.add_module(name, Conv2d(cin, cout, 4, padding=2, stride=stride,
                                         weight_init=PATCHGAN_CONV_INIT, device=device))

        conv("conv0", input_nc, ndf, 2)
        nf = ndf
        for n in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            conv(f"conv{n}", nf_prev, nf, 2)
            self.add_module(f"bn{n}", BatchNormLocal2d(nf, device=device))
        nf_prev, nf = nf, min(nf * 2, 512)
        conv(f"conv{n_layers}", nf_prev, nf, 1)
        self.add_module(f"bn{n_layers}", BatchNormLocal2d(nf, device=device))
        conv(f"conv{n_layers + 1}", nf, 1, 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = [F.leaky_relu(self.conv0(x), 0.2)]
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv{n}")(feats[-1])
            feats.append(F.leaky_relu(getattr(self, f"bn{n}")(h), 0.2))
        feats.append(getattr(self, f"conv{self.n_layers + 1}")(feats[-1]))
        return feats if self.get_interm_feat else [feats[-1]]


def avg_pool_no_pad_count(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False) on NHWC
    (discriminator.py:306)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1, count_include_pad=False)
    return y.permute(0, 2, 3, 1)


class MultiscaleDiscriminator(Module):
    """Three-scale PatchGAN (discriminator.py:318-341): scale{num_D - 1}
    sees the full image, each next one the image average-pooled once more."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3, num_D: int = 3,
                 get_interm_feat: bool = True, device=None):
        super().__init__()
        self.num_D = num_D
        for i in range(num_D):
            self.add_module(f"scale{num_D - 1 - i}",
                            NLayerDiscriminator(input_nc, ndf, n_layers, get_interm_feat,
                                                device=device))

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        results = []
        for i in range(self.num_D):
            results.append(getattr(self, f"scale{self.num_D - 1 - i}")(x))
            if i != self.num_D - 1:
                x = avg_pool_no_pad_count(x)
        return results


class ProjectedDiscriminator(Module):
    """DiffAug -> crop/resize -> frozen DINO -> DiscHeads, and the PatchGAN
    branch on the raw image when use_patchgan_discriminator is set
    (discriminator.py:344-433)."""

    def __init__(self, c_dim: int = 0, vfm_name: str = "siglip2",
                 use_stylegan_t_discriminator: bool = True, diffaug: bool = True,
                 p_crop: float = 0.5, use_patchgan_discriminator: bool = False,
                 get_interm_feat: bool = False, compute_dtype: torch.dtype = torch.float32,
                 dino_kwargs: Optional[Dict[str, Any]] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bad = [k for k, v in {"c_dim": c_dim > 0,
                              "use_stylegan_t_discriminator": not use_stylegan_t_discriminator}
               .items() if v]
        if bad:
            raise NotImplementedError(f"ProjectedDiscriminator: not ported for {bad}")
        self.diffaug, self.p_crop, self.compute_dtype = diffaug, p_crop, compute_dtype
        self.bicubic = any(k in vfm_name.lower() for k in ("qwen", "dino", "eva"))
        self.dino = DINOBackbone(**(dino_kwargs or {}), device=device)
        self.dino.requires_grad_(False)
        self.heads = nn.ModuleList(DiscHead(self.dino.hidden_size, device=device)
                                   for _ in range(self.dino.n_hooks))
        self.get_interm_feat = get_interm_feat
        self.patchgan = (MultiscaleDiscriminator(get_interm_feat=get_interm_feat, device=device)
                         if use_patchgan_discriminator else None)
        if generator is None:
            generator = torch.Generator(device=torch.device(device or "cpu")).manual_seed(0)
        init_parameters(self, generator)

    def _resize(self, h: torch.Tensor, res: int, antialias: bool) -> torch.Tensor:
        fn = resize_bicubic if self.bicubic else resize_bilinear
        return fn(h, size=(res, res), antialias=antialias)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                train: bool = True) -> DiscriminatorForwardOutput:
        """x (B, H, W, 3) in [-1, 1]. `generator` draws the augmentation and
        the crop; None runs neither (the deterministic path: resize only).
        The PatchGAN branch sees x itself."""
        h = x
        if self.diffaug and generator is not None:
            h = diff_augment(h, sample_draws(h, generator))
        h = (h + 1.0) / 2.0
        res, H = self.dino.image_size, h.shape[1]
        if H > res:
            resized = self._resize(h, res, antialias=True)
            if generator is not None and train:
                dev = h.device
                do_crop = torch.rand((), generator=generator, device=dev) < self.p_crop
                oy = torch.randint(0, H - res + 1, (), generator=generator, device=dev)
                ox = torch.randint(0, H - res + 1, (), generator=generator, device=dev)
                idx = torch.arange(res, device=dev)
                cropped = h.index_select(1, oy + idx).index_select(2, ox + idx)
                h = torch.where(do_crop, cropped, resized)
            else:
                h = resized
        elif H < res:
            h = self._resize(h, res, antialias=False)
        mean = torch.tensor(IMAGENET_MEAN, device=h.device)
        std = torch.tensor(IMAGENET_STD, device=h.device)
        feats = self.dino(((h - mean) / std).to(self.compute_dtype))
        logits = [head(f.float(), train) for head, f in zip(self.heads, feats)]
        out = DiscriminatorForwardOutput(stylegan_t_logits=torch.cat(logits, dim=1))
        if self.patchgan is not None:
            pg = self.patchgan(x)
            out.patchgan_logits = [r[-1] for r in pg]
            out.patchgan_features = pg if self.get_interm_feat else None
        return out

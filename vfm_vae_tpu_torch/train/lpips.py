"""LPIPS perceptual distance (port of vfm_vae_tpu/train/lpips.py and
lpips_util.py; reference training/lpips.py:61-171): VGG16 features through
relu5_3 at the five LPIPS taps, channel unit-norm, 1x1 linear heads, spatial
mean, sum over taps. Frozen; NHWC inputs in [-1, 1], computed in NCHW.

Weights come from a local taming `vgg.pth` (`load_lpips`), or are random
from a seeded torch.Generator when the caller asks for that explicitly
(`allow_random_lpips=True`), as the JAX training loop requires
(train/loop.py:196-215). Nothing is downloaded.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import Module, init_parameters, param, randn_

LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)
LPIPS_CHNS = (64, 128, 256, 512, 512)

# ("conv", (cin, cout)) conv3x3 + ReLU; ("pool", None) max-pool 2; ("tap", None)
# records the activation (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3).
VGG16_LAYERS = [
    ("conv", (3, 64)), ("conv", (64, 64)), ("tap", None), ("pool", None),
    ("conv", (64, 128)), ("conv", (128, 128)), ("tap", None), ("pool", None),
    ("conv", (128, 256)), ("conv", (256, 256)), ("conv", (256, 256)), ("tap", None),
    ("pool", None),
    ("conv", (256, 512)), ("conv", (512, 512)), ("conv", (512, 512)), ("tap", None),
    ("pool", None),
    ("conv", (512, 512)), ("conv", (512, 512)), ("conv", (512, 512)), ("tap", None),
]
# The taming LPIPS checkpoint's names of the 13 convs (net.sliceK.<vgg index>).
TORCH_SLICE_CONV_KEYS = [
    "slice1.0", "slice1.2", "slice2.5", "slice2.7", "slice3.10", "slice3.12", "slice3.14",
    "slice4.17", "slice4.19", "slice4.21", "slice5.24", "slice5.26", "slice5.28",
]
TORCHVISION_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


class _Conv3x3(Module):
    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.weight = param(cout, cin, 3, 3, device=device)
        self.bias = param(cout, device=device)

    def reset_parameters(self, g):
        randn_(self.weight, g, 1.0 / math.sqrt(self.weight[0].numel()))
        self.bias.zero_()


class _Lin(Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = param(1, c, 1, 1, device=device)

    def reset_parameters(self, g):
        randn_(self.weight, g, 1.0 / math.sqrt(self.weight.numel()))


class LPIPS(Module):
    """forward(x, y) -> (B,) distances; parameters net.conv{0..12}.*, lin{0..4}.weight."""

    def __init__(self, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        convs = [cfg for kind, cfg in VGG16_LAYERS if kind == "conv"]
        self.net = nn.Module()
        for i, (cin, cout) in enumerate(convs):
            self.net.add_module(f"conv{i}", _Conv3x3(cin, cout, device=device))
        for k, c in enumerate(LPIPS_CHNS):
            self.add_module(f"lin{k}", _Lin(c, device=device))
        if generator is not None:
            init_parameters(self, generator)
        self.requires_grad_(False)

    def features(self, x: torch.Tensor):
        taps, i = [], 0
        for kind, _ in VGG16_LAYERS:
            if kind == "conv":
                conv = getattr(self.net, f"conv{i}")
                x = F.relu(F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), padding=1))
                i += 1
            elif kind == "pool":
                x = F.max_pool2d(x, 2, 2)
            else:
                taps.append(x)
        return taps

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift = torch.tensor(LPIPS_SHIFT, device=x.device)[None, :, None, None]
        scale = torch.tensor(LPIPS_SCALE, device=x.device)[None, :, None, None]
        f0 = self.features((x.permute(0, 3, 1, 2) - shift) / scale)
        f1 = self.features((y.permute(0, 3, 1, 2) - shift) / scale)
        total = 0.0
        for k, (a, b) in enumerate(zip(f0, f1)):
            # The clamp keeps the sqrt's gradient finite for all-zero channel vectors.
            a = a / (torch.sqrt(torch.clamp(a.square().sum(1, keepdim=True), min=1e-20)) + 1e-10)
            b = b / (torch.sqrt(torch.clamp(b.square().sum(1, keepdim=True), min=1e-20)) + 1e-10)
            w = getattr(self, f"lin{k}").weight.to(a.dtype)
            total = total + F.conv2d((a - b).square(), w).mean(dim=(1, 2, 3))
        return total


@torch.no_grad()
def load_lpips(module: LPIPS, lin_path: str, vgg_path: Optional[str] = None) -> None:
    """Load the taming `vgg.pth` (lin heads, plus net.slice* convs when it
    holds them) and, if it lacks the convs, a torchvision vgg16 state dict."""
    sd = torch.load(lin_path, map_location="cpu")
    if "net.slice1.0.weight" in sd:
        keys = [f"net.{k}" for k in TORCH_SLICE_CONV_KEYS]
        src = sd
    else:
        if vgg_path is None:
            raise ValueError(f"{lin_path} has no VGG weights; give vgg_path")
        src = torch.load(vgg_path, map_location="cpu")
        keys = [f"features.{i}" for i in TORCHVISION_CONV_IDX]
    for i, key in enumerate(keys):
        conv = getattr(module.net, f"conv{i}")
        conv.weight.copy_(src[key + ".weight"])
        conv.bias.copy_(src[key + ".bias"])
    for k in range(len(LPIPS_CHNS)):
        getattr(module, f"lin{k}").weight.copy_(sd[f"lin{k}.model.1.weight"])


def build_lpips(device, lpips_path: Optional[str] = None, vgg_path: Optional[str] = None,
                allow_random_lpips: bool = False,
                generator: Optional[torch.Generator] = None) -> LPIPS:
    """LPIPS on `device` from a local checkpoint, or seeded random weights
    when allow_random_lpips is set; otherwise raise."""
    if lpips_path:
        m = LPIPS(device=device)
        load_lpips(m, lpips_path, vgg_path)
        return m
    if not allow_random_lpips:
        raise RuntimeError("LPIPS weights unavailable: give lpips_path (a local vgg.pth), or "
                           "set allow_random_lpips=True to run with random-init LPIPS")
    if generator is None:
        generator = torch.Generator(device=torch.device(device)).manual_seed(0)
    return LPIPS(device=device, generator=generator)

"""InceptionV3 feature extractor for FID, sFID and IS (port of
vfm_vae_tpu/metrics/inception.py).

The architecture is pytorch-fid's (torchvision's inception_v3 with the
FID-Inception blocks: average-pool branches with count_include_pad=False
and a max-pool branch in Mixed_7c), and so are the module and parameter
names (`<Block>.<branch>.conv.weight`, `.bn.{weight,bias,running_mean,
running_var}`, `fc.weight`, `fc.bias`): the published
pt_inception-2015-12-05 state dict loads with `load_state_dict` as it is
(`load_inception`). As in the JAX package, the input (B, H, W, 3) in
[0, 1] is resized to 299 x 299 by the port's bilinear resize
(ops/resize.resize_bilinear, which matches the JAX package's; torch's
F.interpolate differs at the edges) and mapped to [-1, 1]; each
BatchNorm is applied as (y - mean) * rsqrt(var + 1e-3) * weight + bias.

`forward` returns the 2048-d pool3 features, the 1008-way logits of the
IS head, and the sFID tap: the first 7 channels of Mixed_6e's input
(TF's mixed_6/conv, 17 x 17 x 7), flattened in (H, W, C) order to 2023
dims. InceptionV3 runs as cuDNN convolutions in fp32 (TF32 off), not as a
hand-written kernel: the JAX package runs it as XLA convolutions.
"""

from __future__ import annotations

import sys
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear

BN_EPS = 1e-3


class BasicConv(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        y = ((self.conv(x) - bn.running_mean[:, None, None])
             * torch.rsqrt(bn.running_var + BN_EPS)[:, None, None]
             * bn.weight[:, None, None] + bn.bias[:, None, None])
        return F.relu(y)


def _avg_pool(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1)
        self.branch5x5_1 = BasicConv(cin, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 192, 1)
        self.branch7x7_1 = BasicConv(cin, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, max_pool: bool = False):
        super().__init__()
        self.max_pool = max_pool  # pytorch-fid's FIDInceptionE_2 (Mixed_7c)
        self.branch1x1 = BasicConv(cin, 320, 1)
        self.branch3x3_1 = BasicConv(cin, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, stride=1, padding=1) if self.max_pool else _avg_pool(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Features(nn.Module):
    """Images (B, H, W, 3) in [0, 1] -> (pool3 (B, 2048), logits (B, 1008),
    sFID tap (B, 2023)). Random parameters are drawn from `generator`
    (default: seed 0 on the CPU): normal convolutions scaled by
    (2 / fan_in)^1/2 and a head by fan_in^-1/2, zero head bias, unit
    BatchNorm; `load_inception` puts published weights in."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, max_pool=True)
        self.fc = nn.Linear(2048, 1008)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    # He scale before each ReLU keeps the activations' size
                    # through the ~95 layers; the head is lecun-scaled.
                    gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
                    m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                                   * (gain / m.weight[0].numel()) ** 0.5)
            self.fc.bias.zero_()
        self.requires_grad_(False)
        self.eval()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if x.shape[1] != 299 or x.shape[2] != 299:
            x = resize_bilinear(x, size=(299, 299))
        x = (x * 2.0 - 1.0).permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d"):
            x = getattr(self, name)(x)
        spatial = x[:, :7].permute(0, 2, 3, 1).flatten(1)
        for name in ("Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        pool = x.mean(dim=(2, 3))
        return pool, self.fc(pool), spatial


def load_inception(model: InceptionV3Features, path: str) -> InceptionV3Features:
    """pytorch-fid's pt_inception-2015-12-05 state dict into `model`, as it is."""
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return model


def make_detector(weights: Optional[str], device, tool: str):
    """(model, fn): InceptionV3 on `device` with `weights` (a
    pt_inception-2015-12-05 .pth), or seeded random weights with a warning
    on stderr; fn(images) takes an NHWC uint8 or [0, 1] float batch (numpy
    or torch) and returns (pool, logits, spatial) on `device` in fp32."""
    model = InceptionV3Features()
    if weights:
        load_inception(model, weights)
    else:
        print(f"[warn] {tool}: no --inception-weights: random-init InceptionV3; the values are "
              "NOT comparable to published numbers (plumbing check only)", file=sys.stderr)
    model = model.to(device)

    @torch.no_grad()
    def fn(images):
        x = torch.as_tensor(np.asarray(images)).to(device)
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        return model(x)

    return model, fn

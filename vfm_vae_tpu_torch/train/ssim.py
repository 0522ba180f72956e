"""SSIM (port of vfm_vae_tpu/train/ssim.py; torchmetrics-compatible:
Gaussian window 11, sigma 1.5, reflect padding, so the SSIM map has the
input's size; reference StructuralSimilarityIndexMeasure(data_range=2.0),
training/loss.py:152).

Everything runs in fp32 with fp32 windows, whatever the inputs' dtype:
SSIM's windowed variance is E[x^2] - E[x]^2, which cancels catastrophically
when the window sums round their operands (TF32 or bf16). The
depthwise convolutions are cuDNN's, with TF32 off by the port's precision
policy (entry.configure_precision); 3 x 11 taps a pixel is noise next to
the model.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _filter(x: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Separable depthwise window, valid convolution, on NCHW fp32."""
    C = x.shape[1]
    x = F.conv2d(x, k1d.view(1, 1, -1, 1).expand(C, 1, -1, 1), groups=C)
    return F.conv2d(x, k1d.view(1, 1, 1, -1).expand(C, 1, 1, -1), groups=C)


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 2.0, kernel_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over the batch (a scalar) of NHWC images x and y."""
    pad = (kernel_size - 1) // 2
    x = F.pad(x.float().permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    y = F.pad(y.float().permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    k = torch.from_numpy(gaussian_kernel1d(kernel_size, sigma)).to(x.device)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    # The five windowed means in one depthwise pass.
    mu_x, mu_y, mu_xx, mu_yy, mu_xy = _filter(
        torch.cat([x, y, x * x, y * y, x * y], dim=1), k).chunk(5, dim=1)

    sigma_x = mu_xx - mu_x * mu_x
    sigma_y = mu_yy - mu_y * mu_y
    sigma_xy = mu_xy - mu_x * mu_y

    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return (num / den).mean()

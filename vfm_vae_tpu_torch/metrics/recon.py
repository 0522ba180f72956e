"""Paired reconstruction metrics: PSNR, SSIM and LPIPS over image pairs
(port of vfm_vae_tpu/metrics/recon.py; reference
tools/reconstruct/evaluate.py, torchmetrics-based). SSIM is
train/ssim.py's (fp32 windows) and LPIPS train/lpips.py's."""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ..train.ssim import ssim as ssim_fn


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Per-image PSNR (B,) of NHWC batches; the MSE is clamped at 1e-12, so
    identical images read 10 log10(data_range^2 / 1e-12) (120 dB at 1.0)."""
    mse = (a - b).square().mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))


@torch.no_grad()
def evaluate_pairs(pairs: Iterable[Tuple[np.ndarray, np.ndarray]],
                   lpips_module: Optional[torch.nn.Module] = None, device="cpu") -> dict:
    """pairs: (real, gen) NHWC float batches in [0, 1] (numpy or torch).
    Returns the means over images: psnr, ssim, and lpips with a module."""
    psnr_vals, ssim_sum, lpips_vals, n = [], 0.0, [], 0
    for real, gen in pairs:
        real = torch.as_tensor(real, dtype=torch.float32, device=device)
        gen = torch.as_tensor(gen, dtype=torch.float32, device=device)
        psnr_vals.append(psnr(real, gen).cpu())
        ssim_sum += float(ssim_fn(real, gen, data_range=1.0)) * real.shape[0]
        if lpips_module is not None:
            lpips_vals.append(lpips_module(real * 2 - 1, gen * 2 - 1).float().cpu())
        n += real.shape[0]
    out = {"psnr": float(torch.cat(psnr_vals).mean()), "ssim": ssim_sum / n}
    if lpips_vals:
        out["lpips"] = float(torch.cat(lpips_vals).mean())
    return out

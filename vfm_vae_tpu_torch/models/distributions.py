"""Diagonal Gaussian latent (port of vfm_vae_tpu/models/distributions.py).
Channel-last parameters (B, H, W, 2C): mean = [..., :C], logvar = [..., C:]."""

from __future__ import annotations

from typing import Optional

import torch


class DiagonalGaussianDistribution:
    def __init__(self, parameters: torch.Tensor):
        self.mean, logvar = parameters.chunk(2, dim=-1)
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                            dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL to the standard normal, summed per sample: (B,)."""
        var = torch.exp(self.logvar)
        return 0.5 * (self.mean.square() + var - 1.0 - self.logvar).sum(dim=(1, 2, 3))


def mean_logvar_to_mean_std(moments: torch.Tensor) -> torch.Tensor:
    """(mean || logvar) -> (mean || std) on the last axis, the REG prefetch's
    storage format (distributions.py:59; the logvar clamp of the posterior)."""
    mean, logvar = moments.chunk(2, dim=-1)
    return torch.cat([mean, torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))], dim=-1)

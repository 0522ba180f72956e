"""GroupNorm / LayerNorm with fp32 statistics on NHWC maps (port of
vfm_vae_tpu/ops/groupnorm.py). torch groups consecutive channels. fp32
inputs take the two-pass form; lower-precision inputs the one-pass
E[x^2] - E[x]^2 form with the elementwise apply in the input dtype. Where
the opt-in rule admits a map (VFM_VAE_PALLAS_STATS=1, C % 128 == 0, at
least 32 x 32 positions), the per-channel sums run in K5
(kernels.channel_moments), as the JAX group_stats routes them."""

from __future__ import annotations

from typing import Optional

import torch

from .kernels.group_stats import channel_moments, moments_eligible


def group_stats(x: torch.Tensor, num_groups: int, eps: float = 1e-5, *, plain: bool = False):
    """One-pass per-(sample, group) (mean, rsqrt(var + eps)), both (B, G) fp32.
    `plain` selects K5's twin on the card where K5 would run."""
    B, H, W, C = x.shape
    if C % num_groups:
        raise ValueError(f"group_stats: {C} channels not divisible by {num_groups} groups")
    if moments_eligible(x):
        s1, s2 = channel_moments(x, plain=plain)
    else:
        xf = x.float()
        s1, s2 = xf.sum(dim=(1, 2)), xf.square().sum(dim=(1, 2))
    s1 = s1.reshape(B, num_groups, C // num_groups).sum(-1)
    s2 = s2.reshape(B, num_groups, C // num_groups).sum(-1)
    n = H * W * (C // num_groups)
    m1 = s1 / n
    var = torch.clamp(s2 / n - m1.square(), min=0.0)
    return m1, torch.rsqrt(var + eps)


def group_norm(
    x: torch.Tensor,
    num_groups: int,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    *,
    plain: bool = False,
) -> torch.Tensor:
    """torch F.group_norm semantics on an NHWC map (`plain`: see group_stats)."""
    dt = x.dtype
    B, H, W, C = x.shape
    if dt == torch.float32:
        xg = x.reshape(B, H, W, num_groups, C // num_groups)
        mean = xg.mean(dim=(1, 2, 4), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
        y = ((xg - mean) / torch.sqrt(var + eps)).reshape(B, H, W, C)
    else:
        mean, inv = group_stats(x, num_groups, eps, plain=plain)
        reps = C // num_groups
        mean_c = mean.repeat_interleave(reps, dim=1).to(dt)
        inv_c = inv.repeat_interleave(reps, dim=1).to(dt)
        y = (x - mean_c[:, None, None, :]) * inv_c[:, None, None, :]
    if weight is not None:
        y = y * weight.to(y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.to(dt)


def layer_norm(x: torch.Tensor, weight=None, bias=None, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis: fp32 statistics, apply in the input dtype."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    if dt == torch.float32:
        y = (xf - mean) / torch.sqrt(var + eps)
    else:
        y = (x - mean.to(dt)) * torch.rsqrt(var + eps).to(dt)
    if weight is not None:
        y = y * weight.to(y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.to(dt)

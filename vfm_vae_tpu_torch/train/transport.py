"""Flow-matching transport (port of vfm_vae_tpu/train/transport.py): the
linear path with velocity prediction, lognormal or uniform time sampling,
the cosine loss term and the REPA token-alignment term (LightningDiT
transport config, train_lightningdit_xl_1_stage_0.yaml:57-64), and the
Euler ODE and Euler-Maruyama SDE samplers with classifier-free guidance.

The JAX functions draw from a key; these take the draws as arguments (the
times' normal or uniform draw, the noise, the class-dropout mask, the
sampler's start and step noise), so that a test can pass JAX's numbers.
`draw_flow_matching` and the samplers' `step_noise` callables make them
from a torch.Generator. Scalar times are fp32, as JAX's weakly typed
`i * dt` is.

`model_fn(x, t, y, drop)` returns the velocity, or (velocity, projected
tokens) when REPA targets are given; y None is the null class.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def sample_t(draw: torch.Tensor, use_lognorm: bool = True) -> torch.Tensor:
    """t in (0, 1) from a standard normal draw (lognorm: sigmoid of it,
    concentrated mid-path) or, without lognorm, the uniform draw itself."""
    return torch.sigmoid(draw) if use_lognorm else draw


def linear_interpolate(x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor):
    """x_t = (1 - t) x0 + t x1 with velocity x1 - x0 (noise to data as t
    goes from 0 to 1)."""
    tb = t.reshape(-1, *([1] * (x1.dim() - 1)))
    return (1 - tb) * x0 + tb * x1, x1 - x0


def draw_flow_matching(gen: torch.Generator, shape, use_lognorm: bool, drop_prob: float,
                       device) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(time draw, noise, class-dropout mask or None) for one batch of
    `shape`, in the JAX split's order (t, noise, drop)."""
    B = shape[0]
    t = (torch.randn if use_lognorm else torch.rand)((B,), generator=gen, device=device)
    noise = torch.randn(shape, generator=gen, device=device)
    drop = torch.rand((B,), generator=gen, device=device) < drop_prob if drop_prob > 0 else None
    return t, noise, drop


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(x.square().sum(-1), min=1e-12))


def flow_matching_loss(model_fn: Callable, latents: torch.Tensor, labels: Optional[torch.Tensor],
                       t_draw: torch.Tensor, noise: torch.Tensor,
                       drop: Optional[torch.Tensor] = None, use_lognorm: bool = True,
                       use_cosine_loss: bool = True, repa_targets: Optional[torch.Tensor] = None,
                       repa_weight: float = 0.0):
    """Velocity-matching MSE, plus 1 - cos(pred, velocity) per sample with
    the cosine term, plus repa_weight * (1 - token cosine) of the projected
    tokens against `repa_targets` (B, T, D_vfm). Returns (loss, {"mse"})."""
    B = latents.shape[0]
    t = sample_t(t_draw, use_lognorm)
    xt, vel = linear_interpolate(noise.to(latents.dtype), latents, t)
    out = model_fn(xt, t, labels, drop)
    pred, projected = out if repa_targets is not None else (out, None)
    mse = (pred - vel).square().mean()
    loss = mse
    if repa_targets is not None and repa_weight > 0:
        tgt = repa_targets.to(torch.promote_types(projected.dtype, torch.float32))
        cos_tok = (projected * tgt).sum(-1) / (_norm(projected) * _norm(tgt) + 1e-8)
        loss = loss + repa_weight * (1.0 - cos_tok).mean()
    if use_cosine_loss:
        # The clamp keeps the sqrt's backward finite at the zero-init output.
        p, v = pred.reshape(B, -1), vel.reshape(B, -1)
        cos = (p * v).sum(-1) / (_norm(p) * _norm(v) + 1e-8)
        loss = loss + (1.0 - cos).mean()
    return loss, {"mse": mse}


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(np.float32(x))


def _guided(model_fn, x, t, labels, cfg_scale: float, scale: Optional[torch.Tensor] = None):
    tb = t.to(x.device).expand(x.shape[0])
    v_cond = model_fn(x, tb, labels, None)
    if cfg_scale == 1.0 or labels is None:
        return v_cond
    v_unc = model_fn(x, tb, None, None)
    s = cfg_scale if scale is None else scale.to(x.device)
    return v_unc + s * (v_cond - v_unc)


@torch.no_grad()
def ode_euler_sample(model_fn: Callable, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                     num_steps: int = 50, cfg_scale: float = 1.0,
                     cfg_interval: Optional[Tuple[float, float]] = None) -> torch.Tensor:
    """Euler integration of the velocity field from the start noise `x` at
    t = 0 to t = 1, t = i * dt in fp32, with classifier-free guidance
    (within `cfg_interval` (lo, hi), compared in fp32, if given)."""
    dt = _f32(1.0 / num_steps)
    for i in range(num_steps):
        t = _f32(i) * dt
        scale = None
        if cfg_interval is not None:
            lo, hi = cfg_interval
            on = bool(t >= _f32(lo)) and bool(t <= _f32(hi))
            scale = _f32(cfg_scale if on else 1.0)
        x = x + dt.to(x.device) * _guided(model_fn, x, t, labels, cfg_scale, scale)
    return x


@torch.no_grad()
def sde_sample(model_fn: Callable, x: torch.Tensor, step_noise: Callable[[int], torch.Tensor],
               labels: Optional[torch.Tensor] = None, num_steps: int = 250,
               cfg_scale: float = 1.0, diffusion_coef: float = 1.0,
               last_step_frac: float = 0.04) -> torch.Tensor:
    """Euler-Maruyama integration (REG protocol) from the start noise `x`
    to t_end = 1 - last_step_frac, with step i's noise `step_noise(i)`,
    then one deterministic Euler step to t = 1. The score of the linear
    path is (t v - x) / (1 - t), t clipped to [1e-4, 1 - 1e-4]."""
    t_end = 1.0 - last_step_frac
    dt = _f32(t_end / num_steps)
    dev = x.device
    for i in range(num_steps):
        t = _f32(i) * dt
        v = _guided(model_fn, x, t, labels, cfg_scale)
        tc = torch.clamp(t, 1e-4, 1 - 1e-4).to(dev)
        s = (tc * v - x) / (1.0 - tc)
        w = (diffusion_coef * (1.0 - t)).to(dev)
        drift = v + 0.5 * w * s
        x = x + drift * dt.to(dev) + torch.sqrt(w * dt.to(dev)) * step_noise(i)
    v = _guided(model_fn, x, _f32(t_end), labels, cfg_scale)
    return x + _f32(1.0 - t_end).to(dev) * v

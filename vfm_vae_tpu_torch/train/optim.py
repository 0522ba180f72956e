"""Optimisers and EMA (port of vfm_vae_tpu/train/optim.py; reference
torch.optim.Adam with betas (0, 0.99), eps 1e-8).

Freezing is by construction: frozen parameters get requires_grad_(False)
and are never handed to an optimiser, which is what optax.masked +
set_to_zero does in the JAX package. The EMA copy covers the trainable
parameters only and is updated in place.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import torch


def adam(params: Iterable[torch.nn.Parameter], lr: float = 1e-4, betas=(0.0, 0.99),
         eps: float = 1e-8) -> torch.optim.Adam:
    return torch.optim.Adam(list(params), lr=lr, betas=tuple(betas), eps=eps)


def clean_grads(grads: Sequence[torch.Tensor], clamp: float = 1e5):
    """nan_to_num with +-clamp (training_loop.py:286)."""
    return [torch.nan_to_num(g, nan=0.0, posinf=clamp, neginf=-clamp) for g in grads]


def ema_beta(batch_size: int, cur_nimg: float, ema_kimg: float, ema_rampup: Optional[float]) -> float:
    """(training_loop.py:735-738): optional ramp-up of the EMA horizon."""
    ema_nimg = ema_kimg * 1000
    if ema_rampup is not None:
        ema_nimg = min(ema_nimg, cur_nimg * ema_rampup)
    return 0.5 ** (batch_size / max(ema_nimg, 1e-8))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], beta: float) -> None:
    """p_ema <- beta * p_ema + (1 - beta) * p, for every name in `ema`."""
    for name, e in ema.items():
        e.mul_(beta).add_(params[name].detach(), alpha=1.0 - beta)

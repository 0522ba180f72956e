"""Training statistics as three-moment counters [n, sum(x), sum(x^2)] per
name (port of vfm_vae_tpu/core/stats.py: `report` and `merge`), kept as
detached fp32 tensors on the value's device."""

from __future__ import annotations

from typing import Dict

import torch

Moments = torch.Tensor  # (3,)


def moments_of(value) -> Moments:
    v = torch.as_tensor(value).detach().float()
    return torch.stack([v.new_tensor(float(v.numel())), v.sum(), v.square().sum()])


def report(stats: Dict[str, Moments], name: str, value) -> None:
    """Accumulate the moments of `value` (any shape) under `name`."""
    m = moments_of(value)
    stats[name] = stats[name] + m if name in stats else m


def merge(a: Dict[str, Moments], b: Dict[str, Moments]) -> Dict[str, Moments]:
    out = dict(a)
    for k, v in b.items():
        out[k] = out[k] + v if k in out else v
    return out

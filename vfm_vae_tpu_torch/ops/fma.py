"""Fused multiply-add a * b + c (port of vfm_vae_tpu/ops/fma.py; the
reference's custom-gradient op, which autograd derives here as XLA does)."""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return a * b + c

"""Structured model outputs (port of vfm_vae_tpu/models/dataclasses.py:
GeneratorForwardOutput and DiscriminatorForwardOutput, the fields the
ported configuration fills)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch


@dataclass
class GeneratorForwardOutput:
    gen_img: torch.Tensor
    gen_multiscale_imgs: List[torch.Tensor]
    vf_loss: torch.Tensor
    kl_loss: torch.Tensor
    eq_scale_factor: float = 1.0
    eq_angle_factor: int = 0


@dataclass
class DiscriminatorForwardOutput:
    stylegan_t_logits: Optional[torch.Tensor] = None

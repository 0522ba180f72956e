"""Structured model outputs (port of vfm_vae_tpu/models/dataclasses.py:
EncodeOutput, GeneratorForwardOutput and DiscriminatorForwardOutput, the
fields the ported configurations fill). The adapter's losses are zero
scalars where the compression mode has no such term."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch


@dataclass
class EncodeOutput:
    z: torch.Tensor
    vf_loss: torch.Tensor
    kl_loss: torch.Tensor
    vq_loss: torch.Tensor
    entropy_loss: torch.Tensor
    codebook_usages: torch.Tensor  # the codebooks' mean usage, in percent


@dataclass
class GeneratorForwardOutput:
    gen_img: torch.Tensor
    gen_multiscale_imgs: List[torch.Tensor]
    vf_loss: torch.Tensor
    kl_loss: torch.Tensor
    vq_loss: torch.Tensor
    entropy_loss: torch.Tensor
    codebook_usages: torch.Tensor
    eq_scale_factor: float = 1.0
    eq_angle_factor: int = 0


@dataclass
class DiscriminatorForwardOutput:
    stylegan_t_logits: Optional[torch.Tensor] = None
    # The PatchGAN branch: each scale's last map (largest scale first) and,
    # with get_interm_feat, each scale's maps after every layer.
    patchgan_logits: Optional[List[torch.Tensor]] = None
    patchgan_features: Optional[List[List[torch.Tensor]]] = None

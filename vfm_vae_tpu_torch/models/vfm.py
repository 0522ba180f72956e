"""Frozen vision-foundation-model encoder, SigLIP family (port of
vfm_vae_tpu/models/vfm.py: presets, `vfm_preset` with its local
config.json fallback, `VFMEncoder.preprocess` with the EQ-prior
down-scale, `_hidden_indices` and `encode_image` with the int8 tower
scope). Parameter keys follow the reference wrapper:
encoder.vision_model.vision_model.<HF SiglipVisionTransformer keys>."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Sequence

import torch

from ..ops.quantized import int8_vfm_enabled
from ..ops.resize import resize_bilinear
from . import layers
from .layers import Module, holder
from .vit import SigLIPVisionTower

# config.json geometry of the HF SigLIP2 checkpoints the reference configs name.
VFM_PRESETS: Dict[str, Dict[str, Any]] = {
    "siglip2-large-patch16-512": dict(
        hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=4096,
        patch_size=16, image_size=512, text_hidden_size=1024,
    ),
    "siglip2-large-patch16-256": dict(
        hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=4096,
        patch_size=16, image_size=256, text_hidden_size=1024,
    ),
    "siglip2-base-patch16-256": dict(
        hidden_size=768, num_layers=12, num_heads=12, mlp_dim=3072,
        patch_size=16, image_size=256, text_hidden_size=768,
    ),
    "siglip2-so400m-patch16-512": dict(
        hidden_size=1152, num_layers=27, num_heads=16, mlp_dim=4304,
        patch_size=16, image_size=512, text_hidden_size=1152,
    ),
}

SIGLIP_MEAN_STD = (0.5, 0.5)


def vfm_preset(model_name: str) -> Dict[str, Any]:
    """Preset by name substring, else the `config.json` in the directory `model_name`."""
    base = model_name.rstrip("/").split("/")[-1].lower()
    for key, preset in VFM_PRESETS.items():
        if key in base:
            return preset
    cfg_path = os.path.join(model_name, "config.json")
    if not os.path.isfile(cfg_path):
        raise ValueError(f"no preset or local config for VFM {model_name!r}")
    with open(cfg_path) as f:
        cfg = json.load(f)
    v = cfg.get("vision_config", cfg)
    return dict(
        hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
        num_heads=v["num_attention_heads"], mlp_dim=v["intermediate_size"],
        patch_size=v["patch_size"], image_size=v["image_size"],
        text_hidden_size=cfg.get("text_config", {}).get("hidden_size", v["hidden_size"]),
    )


class VFMEncoder(Module):
    """Frozen SigLIP tower behind the reference's preprocessing and
    layer-index convention (vfm_utils.py:26-123, siglip2_utils.py:94-137)."""

    def __init__(self, model_name: str, scale_factor: float, patch_from_layers: Sequence[int],
                 dtype: torch.dtype = torch.float32, device=None, remat: bool = False):
        super().__init__()
        if "siglip" not in model_name.lower():
            raise NotImplementedError(f"only the SigLIP family is ported: {model_name!r}")
        self.model_name = model_name
        self.preset = vfm_preset(model_name)
        self.scale_factor = scale_factor
        self.patch_from_layers = list(patch_from_layers)
        self.dtype = dtype
        p = self.preset
        tower = SigLIPVisionTower(
            hidden_size=p["hidden_size"], num_layers=p["num_layers"], num_heads=p["num_heads"],
            mlp_dim=p["mlp_dim"], patch_size=p["patch_size"], image_size=p["image_size"],
            remat=remat, device=device,
        )
        self.encoder = holder(vision_model=holder(vision_model=tower))
        self.requires_grad_(False)

    @property
    def tower(self) -> SigLIPVisionTower:
        return self.encoder.vision_model.vision_model

    @property
    def patch_size(self) -> int:
        return self.preset["patch_size"]

    def _hidden_indices(self) -> List[int]:
        """patch_from_layers -> hidden-state indices; -1 is the post-LN output."""
        n = self.preset["num_layers"]
        return [i if i >= 0 else n + (i + 1) for i in self.patch_from_layers if i != -1]

    def preprocess(self, img: torch.Tensor, eq_scale_factor: float = 1.0,
                   is_eq_prior: bool = False) -> torch.Tensor:
        """[0, 1] NHWC -> SigLIP input: for an EQ-prior bucket an antialiased
        bilinear down-scale first (vfm.py:248-267), then bilinear x
        scale_factor, (x - 0.5) / 0.5."""
        if is_eq_prior and eq_scale_factor < 1.0:
            img = resize_bilinear(img, scale_factor=eq_scale_factor, antialias=True)
        if self.scale_factor != 1.0:
            img = resize_bilinear(img, scale_factor=self.scale_factor,
                                  antialias=self.scale_factor < 1.0)
        mean, std = SIGLIP_MEAN_STD
        return (img - mean) / std

    @torch.no_grad()
    def encode_image(self, img: torch.Tensor, eq_scale_factor: float = 1.0,
                     is_eq_prior: bool = False) -> List[torch.Tensor]:
        """(B, H, W, 3) in [0, 1] -> one fp32 (B, N, D) feature per
        patch_from_layers entry. The tower is frozen: no gradient is recorded,
        and a smaller EQ-prior grid interpolates the position embedding.
        The tower runs int8 (ops/quantized.py) when VFM_VAE_INT8_VFM=1 or a
        caller's int8 scope is active (vfm.py:278-292: the env opt-in alone
        must not switch a caller's scope off)."""
        x = self.preprocess(img, eq_scale_factor, is_eq_prior).to(self.dtype)
        with layers.int8_linear_scope(int8_vfm_enabled() or layers._INT8_SCOPE[0]):
            hidden, last = self.tower(x, collect=self._hidden_indices())
        n = self.preset["num_layers"]
        feats = [last if i == -1 else hidden[i if i >= 0 else n + (i + 1)]
                 for i in self.patch_from_layers]
        return [f.float() for f in feats]

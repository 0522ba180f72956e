"""Frozen vision-foundation-model encoder facade (port of
vfm_vae_tpu/models/vfm.py: VFM_PRESETS, VFM_NORMALIZATION,
VFM2INTERPOLATION, infer_patch_size, vfm_family, `vfm_preset` with its
local config.json fallback, and `VFMEncoder`: dispatch by family,
preprocessing with the EQ-prior down-scale, the layer-index convention,
CLS stripping, the Qwen path and the int8 tower scope).

Five tower families: SigLIP2 (models/vit.py SigLIPVisionTower), DINOv2
and MAE (vit.py Dinov2Tower, MAETower), EVA-02 (eva.py) and the
Qwen2.5-VL vision tower (qwen.py). Parameter keys: the SigLIP tower sits
under encoder.vision_model.vision_model (the reference wrapper's
SiglipVisionModel); the other towers sit under encoder, each in its own
checkpoint's layout (HF Dinov2Model, HF ViTMAEModel, EVA-02 as
convert_eva_timm reads it, HF Qwen2.5-VL `visual`).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Sequence, Tuple, Union

import torch

from ..ops.quantized import int8_vfm_enabled
from ..ops.resize import resize_bicubic, resize_bilinear
from . import layers
from .layers import Module, holder
from .eva import EVATower
from .qwen import QwenVisionTower, qwen_patchify
from .vit import Dinov2Tower, MAETower, SigLIPVisionTower

# config.json geometry of the checkpoints the reference configs name (vfm.py:28-80).
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
    "dinov2-large": dict(
        hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=4096,
        patch_size=14, image_size=518, text_hidden_size=1024,
    ),
    "dinov2-base": dict(
        hidden_size=768, num_layers=12, num_heads=12, mlp_dim=3072,
        patch_size=14, image_size=518, text_hidden_size=768,
    ),
    "vit-mae-large": dict(
        hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=4096,
        patch_size=16, image_size=224, text_hidden_size=1024,
    ),
    "vit-mae-base": dict(
        hidden_size=768, num_layers=12, num_heads=12, mlp_dim=3072,
        patch_size=16, image_size=224, text_hidden_size=768,
    ),
    "eva02-large-patch14-448": dict(
        hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=2730,
        patch_size=14, image_size=448, text_hidden_size=1024,
    ),
    # The reference wrapper's default model (eva_utils.py:19).
    "eva02-large-patch14-clip-336": dict(
        hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=2730,
        patch_size=14, image_size=336, text_hidden_size=1024,
    ),
    "eva02-base-patch14-448": dict(
        hidden_size=768, num_layers=12, num_heads=12, mlp_dim=2048,
        patch_size=14, image_size=448, text_hidden_size=768,
    ),
    "qwen2.5-vl-7b": dict(
        hidden_size=1280, num_layers=32, num_heads=16, mlp_dim=3420,
        patch_size=14, image_size=0, text_hidden_size=3584,
        out_hidden_size=3584, temporal_patch_size=2, spatial_merge_size=2,
        window_size=112, fullatt_block_indexes=(7, 15, 23, 31),
    ),
}

# Per-family preprocessing constants (siglip2_utils.py:62-63, dinov2_utils.py:54-57).
VFM_NORMALIZATION = {
    "siglip": ([0.5, 0.5, 0.5], [0.5, 0.5, 0.5]),
    "qwen": ([0.48145466, 0.4578275, 0.40821073], [0.26862954, 0.26130258, 0.27577711]),
    "dinov2": ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
    "mae": ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]),
    "eva": ([0.48145466, 0.4578275, 0.40821073], [0.26862954, 0.26130258, 0.27577711]),
}

# Keyed by a substring of the model name, as the reference's table is: "dino"
# names the DINOv2 family. (The JAX facade looks this table up by family
# name, so its DINOv2 towers resize bilinearly; the port follows the
# reference.)
VFM2INTERPOLATION = {
    "siglip": "bilinear",
    "qwen": "bicubic",
    "dino": "bicubic",
    "mae": "bilinear",
    "eva": "bicubic",
}

FAMILIES_WITH_CLS = ("dinov2", "mae", "eva")


def infer_patch_size(model_name: str, default: int = 16) -> int:
    m = re.search(r"patch(\d+)", model_name.lower())
    return int(m.group(1)) if m else default


def vfm_family(model_name: str) -> str:
    n = model_name.lower()
    for fam in ("qwen", "siglip", "dinov2", "mae", "eva"):
        if fam in n:
            return fam
    raise ValueError(f"unknown VFM family for {model_name!r}")


def interpolation(model_name: str) -> str:
    """The family's resize kind, by substring of the name."""
    n = model_name.lower()
    return next((kind for key, kind in VFM2INTERPOLATION.items() if key in n), "bilinear")


def vfm_preset(model_name: str) -> Dict[str, Any]:
    """Preset by name substring, else the `config.json` in the directory
    `model_name` (vision_config where present; DINOv2 configs give
    mlp_ratio in place of intermediate_size)."""
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
    mlp_dim = v.get("intermediate_size")
    if mlp_dim is None:
        mlp_dim = int(v["hidden_size"] * v.get("mlp_ratio", 4))
    return dict(
        hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
        num_heads=v["num_attention_heads"], mlp_dim=mlp_dim,
        patch_size=v["patch_size"], image_size=v["image_size"],
        text_hidden_size=cfg.get("text_config", {}).get("hidden_size", v["hidden_size"]),
    )


def build_tower(family: str, p: Dict[str, Any], remat: bool = False, device=None) -> Module:
    """The tower of `family` at preset `p` (vfm.py:174-225)."""
    common = dict(hidden_size=p["hidden_size"], num_heads=p["num_heads"], mlp_dim=p["mlp_dim"],
                  patch_size=p["patch_size"], device=device)
    if family == "qwen":
        return QwenVisionTower(
            depth=p["num_layers"], out_hidden_size=p["out_hidden_size"],
            temporal_patch_size=p.get("temporal_patch_size", 2),
            spatial_merge_size=p.get("spatial_merge_size", 2),
            window_size=p.get("window_size", 112),
            fullatt_block_indexes=tuple(p.get("fullatt_block_indexes", (7, 15, 23, 31))),
            **common)
    common.update(num_layers=p["num_layers"], image_size=p["image_size"])
    if family == "siglip":
        return SigLIPVisionTower(remat=remat, **common)
    if family == "dinov2":
        return Dinov2Tower(**common)
    if family == "mae":
        return MAETower(**common)
    return EVATower(rope_temperature=p.get("rope_temperature", 10000.0),
                    rope_ref_grid=p.get("rope_ref_grid"), **common)


class VFMEncoder(Module):
    """Frozen tower behind the reference's preprocessing and layer-index
    convention (vfm_utils.py:26-123). `remat` (a checkpoint per block where
    a gradient is recorded) is SigLIP's only, as in the JAX facade."""

    def __init__(self, model_name: str, scale_factor: float, patch_from_layers: Sequence[int],
                 dtype: torch.dtype = torch.float32, device=None, remat: bool = False):
        super().__init__()
        self.model_name = model_name
        self.family = vfm_family(model_name)
        self.preset = vfm_preset(model_name)
        self.scale_factor = scale_factor
        self.patch_from_layers = list(patch_from_layers)
        self.dtype = dtype
        tower = build_tower(self.family, self.preset, remat, device)
        if self.family == "siglip":
            self.encoder = holder(vision_model=holder(vision_model=tower))
        else:
            self.encoder = tower
        self._mean_std: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.requires_grad_(False)

    @property
    def tower(self) -> Module:
        return self.encoder.vision_model.vision_model if self.family == "siglip" else self.encoder

    @property
    def patch_size(self) -> int:
        return self.preset["patch_size"]

    @property
    def has_cls_prefix(self) -> bool:
        return self.family in FAMILIES_WITH_CLS

    def _hidden_indices(self) -> List[int]:
        """patch_from_layers -> hidden-state indices; -1 is the last sequence
        (post-LN; EVA's raw last block; Qwen's merger output)."""
        n = self.preset["num_layers"]
        return [i if i >= 0 else n + (i + 1) for i in self.patch_from_layers if i != -1]

    def preprocess(self, img: torch.Tensor, eq_scale_factor: float = 1.0,
                   is_eq_prior: bool = False) -> torch.Tensor:
        """[0, 1] NHWC -> tower input (vfm.py:248-267): for an EQ-prior
        bucket an antialiased down-scale first, then x scale_factor (bicubic
        for DINOv2, EVA and Qwen, bilinear for SigLIP and MAE), then the
        family's mean and std."""
        resize = resize_bicubic if interpolation(self.model_name) == "bicubic" else resize_bilinear
        if is_eq_prior and eq_scale_factor < 1.0:
            img = resize(img, scale_factor=eq_scale_factor, antialias=True)
        if self.scale_factor != 1.0:
            img = resize(img, scale_factor=self.scale_factor, antialias=self.scale_factor < 1.0)
        key = (img.device, img.dtype)
        if key not in self._mean_std:  # made once: a host copy per call would sync the stream
            self._mean_std[key] = tuple(torch.tensor(v, dtype=img.dtype, device=img.device)
                                        for v in VFM_NORMALIZATION[self.family])
        mean, std = self._mean_std[key]
        return (img - mean) / std

    @torch.no_grad()
    def encode_image(self, img: torch.Tensor, eq_scale_factor: float = 1.0,
                     is_eq_prior: bool = False, return_pooled: bool = False
                     ) -> Union[List[torch.Tensor], Tuple[List[torch.Tensor], torch.Tensor]]:
        """(B, H, W, 3) in [0, 1] -> one fp32 (B, N, D) feature per
        patch_from_layers entry (the CLS token stripped), and with
        `return_pooled` the fp32 pooled output (SigLIP's MAP head, DINOv2's
        and EVA's CLS, MAE's and Qwen's token mean) as a second value. The
        tower is frozen: no gradient is recorded, and a smaller EQ-prior grid
        interpolates the position embedding (MAE refuses it). The tower runs
        int8 (ops/quantized.py) when VFM_VAE_INT8_VFM=1 or a caller's int8
        scope is active (vfm.py:278-292: the env opt-in alone must not switch
        a caller's scope off)."""
        x = self.preprocess(img, eq_scale_factor, is_eq_prior).to(self.dtype)
        n = self.preset["num_layers"]
        with layers.int8_linear_scope(int8_vfm_enabled() or layers._INT8_SCOPE[0]):
            if self.family == "qwen":
                p = self.preset
                patches, grid = qwen_patchify(x, p["patch_size"], p.get("temporal_patch_size", 2),
                                              p.get("spatial_merge_size", 2))
                hidden, last, pooled = self.tower(patches, grid, collect=self._hidden_indices())
            else:
                hidden, last, pooled = self.tower(x, collect=self._hidden_indices(),
                                                  need_pooled=return_pooled)
        feats = [last if i == -1 else hidden[i if i >= 0 else n + (i + 1)]
                 for i in self.patch_from_layers]
        if self.has_cls_prefix:
            feats = [f[:, 1:] for f in feats]  # dinov2_utils.py:119-126
        feats = [f.float() for f in feats]
        return (feats, pooled.float()) if return_pooled else feats

"""VFM-VAE Generator, tokenizer API (port of vfm_vae_tpu/models/generator.py:
`encode` and `decode`): frozen SigLIP encoder -> LDM adapter -> diagonal
Gaussian z; z -> adapter decompress -> mapping -> ConvNeXt synthesis.

Constructor keywords are the JAX Generator's. The slice ports the
unconditional, continuous, attnproj, ConvNeXt, multiscale configuration;
other values raise. The training-only keywords of the flagship and tiny
configurations (use_kl_loss, num_fp16_res, conv_clamp, label_dim) are
accepted and have no effect on encode/decode.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from .adapter import LDMAdapter
from .layers import Module, init_parameters
from .synthesis import MappingNetwork, SynthesisNetwork, pooled_z
from .vfm import VFMEncoder

# Keywords of the flagship and tiny configurations that only training reads.
_TRAINING_ONLY = {"use_kl_loss", "num_fp16_res", "conv_clamp", "label_dim"}


class Generator(Module):
    def __init__(
        self,
        *,
        conditional: bool = False,
        label_type: str = "cls2text",
        vfm_name: str = "siglip2-large-patch16-512",
        scale_factor: float = 2.0,
        patch_from_layers: Sequence[int] = (0, 12, -1),
        patch_in_dimensions: Sequence[int] = (1024, 1024, 1024),
        patch_out_dimensions: Sequence[int] = (64, 64, 64),
        compression_mode: str = "continuous",
        how_to_compress: str = "attnproj",
        how_to_decompress: str = "attnproj",
        decompress_factor: int = 16,
        attnproj_quant_layers: int = 1,
        attnproj_post_quant_layers: int = 1,
        resolution_compression_factor: int = 16,
        z_dimension: int = 32,
        z_pooled_resolution: int = 1,
        z_dim_for_mapping_mlp_output: int = 128,
        concat_z_block_indices: Sequence[int] = (),
        concat_z_mapped_dims: Sequence[int] = (),
        how_to_process_concat_z: str = "unshuffle",
        activation_for_concat_z: str = "gelu",
        use_multiscale_output: bool = True,
        attn_block_indices: Sequence[int] = (),
        attn_depths: Sequence[int] = (),
        use_self_attn: bool = True,
        use_cross_attn: bool = False,
        use_convnext: bool = True,
        use_gaussian_blur: bool = True,
        add_additional_convnext: bool = True,
        img_resolution: int = 256,
        img_channels: int = 3,
        num_blocks: int = 6,
        legacy: bool = False,
        synthesis_kwargs: Optional[Dict[str, Any]] = None,
        use_vf_loss: bool = False,
        dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
        **training_only,
    ):
        super().__init__()
        unknown = set(training_only) - _TRAINING_ONLY
        if unknown:
            raise TypeError(f"Generator: unknown keywords {sorted(unknown)}")
        unsupported = {
            "conditional": conditional, "label_type": label_type != "cls2text",
            "compression_mode": compression_mode != "continuous",
            "how_to_compress": how_to_compress != "attnproj",
            "how_to_decompress": how_to_decompress != "attnproj",
            "use_cross_attn": use_cross_attn, "use_convnext": not use_convnext,
            "use_multiscale_output": not use_multiscale_output,
            "use_gaussian_blur": not use_gaussian_blur,
            "how_to_process_concat_z": how_to_process_concat_z != "unshuffle",
            "concat_z_mapped_dims": bool(concat_z_block_indices) and not concat_z_mapped_dims,
            "architecture": (synthesis_kwargs or {}).get("architecture", "skip") != "skip",
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"Generator: not ported for {bad}")
        sk = dict(synthesis_kwargs or {})
        self.z_pooled_resolution = z_pooled_resolution
        z_resolution = img_resolution // resolution_compression_factor
        z_dim_concat = z_dimension * decompress_factor

        self.vfm_encoder = VFMEncoder(vfm_name, scale_factor, patch_from_layers, dtype, device)
        patch = self.vfm_encoder.patch_size
        if (img_resolution * scale_factor) % patch:
            raise ValueError("img_resolution * scale_factor must be a multiple of the patch size")
        patch_res = int(img_resolution * scale_factor // patch)
        self.ldm_adapter = LDMAdapter(
            patch_from_layers, [patch_res] * len(patch_from_layers), patch_in_dimensions,
            patch_out_dimensions, decompress_factor, attnproj_quant_layers,
            attnproj_post_quant_layers, z_resolution, z_dimension, use_vf_loss, device=device,
        )
        self.synthesis = SynthesisNetwork(
            w_dim=z_dim_for_mapping_mlp_output, img_resolution=img_resolution,
            img_channels=img_channels, channel_base=sk.get("channel_base", 32768),
            channel_max=sk.get("channel_max", 512), num_blocks=num_blocks,
            num_res_blocks=sk.get("num_res_blocks", 3), z_resolution=z_resolution,
            z_dim=z_dim_concat, concat_z_block_indices=concat_z_block_indices,
            concat_z_mapped_dims=concat_z_mapped_dims,
            activation_for_concat_z=activation_for_concat_z,
            attn_block_indices=attn_block_indices if use_self_attn else (),
            attn_depths=attn_depths if use_self_attn else (),
            add_additional_convnext=add_additional_convnext,
            legacy=legacy, dtype=dtype, device=device,
        )
        self.mapping = MappingNetwork(
            z_dim_concat * z_pooled_resolution ** 2, z_dim_for_mapping_mlp_output,
            self.synthesis.num_ws, device=device,
        )
        if generator is None:
            generator = torch.Generator(device=torch.device(device or "cpu")).manual_seed(0)
        init_parameters(self, generator)

    @torch.no_grad()
    def encode(self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
               return_z_before_quantize: bool = False) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> z (B, zr, zr, z_dim) NHWC: the posterior
        mode, or a sample drawn with `generator`."""
        feats = self.vfm_encoder.encode_image(img)
        return self.ldm_adapter.encode(feats, generator, return_z_before_quantize)

    @torch.no_grad()
    def decode(self, z: torch.Tensor, truncation_psi: float = 1.0) -> torch.Tensor:
        """z (B, zr, zr, z_dim) -> image (B, H, W, 3) in [-1, 1], fp32."""
        z = self.ldm_adapter.decode(z)
        ws = self.mapping(pooled_z(z, self.z_pooled_resolution), truncation_psi)
        return self.synthesis(z, ws)

    def use_plain_kernels(self, plain: bool = True) -> None:
        """Route every K1-K3 site to its plain PyTorch twin (comparison runs)."""
        for m in self.modules():
            if hasattr(m, "plain"):
                m.plain = plain

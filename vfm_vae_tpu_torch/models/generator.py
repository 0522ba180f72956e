"""VFM-VAE Generator (port of vfm_vae_tpu/models/generator.py): the
tokenizer API `encode` and `decode` (frozen VFM encoder of any family ->
LDM adapter -> z, the diagonal Gaussian's or the multi-codebook VQ's; z ->
adapter decompress -> mapping -> synthesis), the training `forward` with
equivariance regularisation and the adapter's VF, KL, VQ and entropy
losses, and the train_mode freezing rules (`trainable_path_predicates`,
`trainable_names`).

Constructor keywords are the JAX Generator's. The port builds every
unconditional Generator the JAX package builds: either compression mode
(continuous, discrete), either adapter form (attnproj, conv), either
concat-z injector (unshuffle, pooling), the ConvNeXt or the legacy
StyleGAN-T decoder (`use_convnext`), the Fourier first block (block 0
without concat-z), multiscale or skip/orig images (`use_multiscale_output`,
`synthesis_kwargs["architecture"]`), the blur on or off, and the unshuffle
default concat widths (`concat_z_mapped_dims` empty). Conditioning
(`conditional`, labels other than cls2text, `use_cross_attn`) raises by
name. Keywords that no computation of the port's Generator reads
(num_fp16_res, label_dim; use_adaptive_vf_loss, which the loss reads;
train_mode and the equivariance settings, which the training loop reads)
are accepted; `conv_clamp` clamps the legacy layers, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch

from ..ops.resize import resize_bilinear, rot90
from .adapter import LDMAdapter
from .dataclasses import GeneratorForwardOutput
from .layers import Module, init_parameters
from .synthesis import MappingNetwork, SynthesisNetwork, pooled_z, remat_policy
from .vfm import VFMEncoder

# Keywords of the flagship and tiny configurations that no port computation reads.
_TRAINING_ONLY = {"num_fp16_res", "label_dim", "use_adaptive_vf_loss",
                  "train_mode", "use_equivariance_regularization",
                  "equivariance_regularization_p_prior",
                  "equivariance_regularization_p_prior_scale"}


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
        conv_clamp: Optional[float] = 256,
        legacy: bool = False,
        synthesis_kwargs: Optional[Dict[str, Any]] = None,
        use_vf_loss: bool = False,
        use_kl_loss: bool = False,
        vocab_width: int = 64,
        vocab_size: int = 32768,
        vocab_beta: float = 0.25,
        use_entropy_loss: bool = False,
        entropy_temp: float = 0.01,
        num_codebooks: int = 8,
        distmat_margin: float = 0.0,
        cos_margin: float = 0.0,
        distmat_weight: float = 1.0,
        cos_weight: float = 1.0,
        remat=False,
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
            "use_cross_attn": use_cross_attn,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"Generator: not ported for {bad}")
        sk = dict(synthesis_kwargs or {})
        # Rematerialisation (generator.py:93-96): the policy checkpoints each
        # ConvNeXt layer (synthesis.remat_policy); the tower takes any truthy
        # value as a checkpoint per ViT block.
        self.remat = remat_policy(remat)
        self.z_pooled_resolution = z_pooled_resolution
        z_resolution = img_resolution // resolution_compression_factor
        # z's width: the Gaussian's channels, or the VQ token width (generator.py:105-110).
        z_dim = vocab_width if compression_mode == "discrete" else z_dimension
        z_dim_concat = z_dim * decompress_factor

        self.vfm_encoder = VFMEncoder(vfm_name, scale_factor, patch_from_layers, dtype, device,
                                      remat=self.remat is not None)
        patch = self.vfm_encoder.patch_size
        if (img_resolution * scale_factor) % patch:
            raise ValueError("img_resolution * scale_factor must be a multiple of the patch size")
        if self.vfm_encoder.family == "qwen" and -1 in patch_from_layers:
            # The merger output is at half the tower's grid and the adapter
            # reads every layer at one patch resolution: with other layers the
            # JAX Generator fails to concatenate them, alone it builds a z at
            # half the configured resolution.
            raise ValueError("Generator: Qwen's layer -1 (the merger output) is at half the "
                             "tower's grid; take block layers only")
        patch_res = int(img_resolution * scale_factor // patch)
        self.ldm_adapter = LDMAdapter(
            patch_from_layers, [patch_res] * len(patch_from_layers), patch_in_dimensions,
            patch_out_dimensions, decompress_factor, attnproj_quant_layers,
            attnproj_post_quant_layers, z_resolution, z_dimension, use_vf_loss, use_kl_loss,
            distmat_margin, cos_margin, distmat_weight, cos_weight,
            compression_mode=compression_mode, how_to_compress=how_to_compress,
            how_to_decompress=how_to_decompress, vocab_width=vocab_width,
            vocab_size=vocab_size, vocab_beta=vocab_beta, use_entropy_loss=use_entropy_loss,
            entropy_temp=entropy_temp, num_codebooks=num_codebooks, device=device,
        )
        self.synthesis = SynthesisNetwork(
            w_dim=z_dim_for_mapping_mlp_output, img_resolution=img_resolution,
            img_channels=img_channels, channel_base=sk.get("channel_base", 32768),
            channel_max=sk.get("channel_max", 512), num_blocks=num_blocks,
            num_res_blocks=sk.get("num_res_blocks", 3), z_resolution=z_resolution,
            z_dim=z_dim_concat, concat_z_block_indices=concat_z_block_indices,
            concat_z_mapped_dims=concat_z_mapped_dims,
            how_to_process_concat_z=how_to_process_concat_z,
            activation_for_concat_z=activation_for_concat_z,
            attn_block_indices=attn_block_indices if use_self_attn else (),
            attn_depths=attn_depths if use_self_attn else (),
            use_convnext=use_convnext, use_multiscale_output=use_multiscale_output,
            use_gaussian_blur=use_gaussian_blur,
            architecture=sk.get("architecture", "skip"), conv_clamp=conv_clamp,
            add_additional_convnext=add_additional_convnext,
            legacy=legacy, dtype=dtype, remat=self.remat, device=device,
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
        mode, or a sample drawn with `generator`; in discrete mode the
        quantized tokens."""
        feats = self.vfm_encoder.encode_image(img)
        return self.ldm_adapter.encode(feats, generator, return_z_before_quantize)

    @torch.no_grad()
    def decode(self, z: torch.Tensor, truncation_psi: float = 1.0) -> torch.Tensor:
        """z (B, zr, zr, z_dim) -> image (B, H, W, 3) in [-1, 1], fp32."""
        z = self.ldm_adapter.decode(z)
        ws = self.mapping(pooled_z(z, self.z_pooled_resolution), truncation_psi)
        return self.synthesis(z, ws)

    def forward(self, img: torch.Tensor, eq: Tuple[float, int, bool] = (1.0, 0, False),
                generator: Optional[torch.Generator] = None,
                update_buffers: bool = False) -> GeneratorForwardOutput:
        """Training forward (generator.py:257-304). img (B, H, W, 3) in [0, 1];
        eq = (scale, rot90 angle, is_prior) from EquivarianceTransform. A prior
        bucket shrinks the tower's input; a latent bucket resizes and rotates
        z. `generator` draws the posterior sample (None: the mode).
        update_buffers advances the mapping's x_avg and the VQ usage
        telemetry, as the G phase does."""
        scale, angle, prior = eq
        feats = self.vfm_encoder.encode_image(img, scale if prior else 1.0, prior)
        enc = self.ldm_adapter.encode_train(feats, generator, update_buffers)
        z = enc.z
        if not prior:
            if scale != 1.0:
                z = resize_bilinear(z, scale_factor=scale)
            z = rot90(z, angle, dims=(2, 1))
        z = self.ldm_adapter.decode(z)
        ws = self.mapping(pooled_z(z, self.z_pooled_resolution), update_x_avg=update_buffers)
        gen_img, gen_ms = self.synthesis(z, ws, return_multiscale=True)
        return GeneratorForwardOutput(gen_img, gen_ms, enc.vf_loss, enc.kl_loss, enc.vq_loss,
                                      enc.entropy_loss, enc.codebook_usages, scale, angle)

    def vf_anchor(self) -> torch.nn.Parameter:
        """The adaptive VF weight's anchor (adapter.py:406-413)."""
        return self.ldm_adapter.vf_anchor()

    def use_plain_kernels(self, plain: bool = True) -> None:
        """Route every kernel site (K1-K6, K9) to its plain PyTorch twin (comparison runs)."""
        for m in self.modules():
            if hasattr(m, "plain"):
                m.plain = plain


def trainable_path_predicates(train_mode: str, block_resolutions: Sequence[int] = (),
                              concat_z_block_indices: Sequence[int] = ()) -> List[str]:
    """Parameter-name prefixes that train under `train_mode`
    (generator.py:338-372) for the unconditional configuration; the VFM
    tower never trains. train_the_second_half_decoder trains the synthesis
    blocks whose output is above 32 px and their z injectors (the JAX
    package's reading of the reference's intent, generator.py:363-369)."""
    if train_mode == "train_all":
        return ["synthesis", "mapping.mlp", "ldm_adapter"]
    if train_mode == "train_decoder":
        return ["synthesis", "mapping.mlp", "ldm_adapter.post_quant"]
    if train_mode == "train_the_second_half_decoder":
        layers = []
        for idx, res in enumerate(block_resolutions):
            if res > 32:
                layers.append(f"synthesis.blocks.{idx}")
                if idx in concat_z_block_indices:
                    layers.append(f"synthesis.z_convs.{idx}")
        return layers
    if train_mode == "train_text_encoder":
        raise NotImplementedError("train_mode 'train_text_encoder' is not ported")
    raise ValueError(f"Unknown train_mode {train_mode}")


def trainable_names(module: torch.nn.Module, predicates: Sequence[str]) -> Set[str]:
    """The port's form of trainable_mask (generator.py:375-387): the set of
    parameter names under one of the prefixes, never inside the VFM."""
    return {name for name, _ in module.named_parameters()
            if any(name == p or name.startswith(p + ".") for p in predicates)
            and not name.startswith("vfm_encoder.")}

"""Port entry points: the flagship f16d32 SigLIP2-L tokenizer and its
stage-0 training step.

`flagship_generator` builds the configuration that the JAX package's
`__graft_entry__.entry()` runs (a 256 px image is resized to 512 px for the frozen
SigLIP2-L/16-512 tower, the attnproj adapter reads layers 0, 12 and -1,
z is 16x16x32, and six ConvNeXt synthesis blocks decode 8 -> 256 px), with
random weights drawn from an explicit torch.Generator.

`dinov2_generator` is the flagship with the frozen DINOv2-L/14 tower in
place of SigLIP2 (DINOV2_G); the other families build the same way, by
`vfm_name`.

`int8_serving_generator` is the flagship with the README's fast serving
configuration: the frozen tower mirrored to int8 and calibrated (W8A8
through K6), the decoder in bf16 (vfm_vae_tpu/ops/quantized.py:
enable_int8_tower); with `decoder_mlp=True` also the decoder's ConvNeXt
MLPs at maps of at most 64 x 64 in static int8 on K6 (off by default, as
in the JAX package).

Every other unconditional decoder the JAX Generator builds is the flagship
with overrides: `flagship_generator(dev, use_convnext=False)` (the legacy
StyleGAN-T layers, `synthesis_kwargs` with `architecture` "orig" for the
orig images), `concat_z_block_indices=[1, 2, 3]` (the Fourier first block),
`use_gaussian_blur=False`, `use_multiscale_output=False`,
`concat_z_mapped_dims=[]` (the unshuffle widths); DECODER_VARIANTS names
those that chip_smoke.py drives.

The discrete (VQ) tokenizer is the flagship with DISCRETE_G's overrides,
`flagship_generator(dev, **DISCRETE_G)`; its stage-0 loss takes
DISCRETE_LOSS over STAGE0_LOSS (the stage YAMLs' loss_kwargs, through the
CLI).

`flagship_trainer` builds stage 0 of the staged recipe
(configs/vfm_vae_f16d32_siglip2_stage_0_strong_alignment.yaml) on the same
generator: the StyleGAN-T projected discriminator, LPIPS, the loss, Adam
and the EMA, as the `STAGE0_*` dicts below copy them from the YAML (the
card's machine may have no yaml reader).

Precision policy: bf16 compute with fp32 normalization statistics. TF32 is
off for fp32 matrix products and convolutions (`configure_precision`):
TF32 operands keep ~3 decimal digits, the same class of error as feeding
an E[x^2] - E[x]^2 variance from low-precision operands.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from .models import layers
from .models.adapter import PlainAttention
from .models.convnext import ConvNeXtSynthesisLayer, SeparableUpsampleWithFixedBlur
from .models.discriminator import ProjectedDiscriminator
from .models.generator import Generator, trainable_names, trainable_path_predicates
from .models.synthesis import SynthesisLayer
from .models.gigagan import SelfAttention
from .models.vit import MultiHeadSelfAttention
from .ops.attention import flash_eligible_shape
from .ops.kernels.dwconv_stats import dwconv_stats_eligible, pallas_dw_eligible
from .ops.kernels.fused_mlp import pipeline_enabled
from .ops.kernels.group_stats import moments_eligible
from .ops.quantized import enable_int8_decoder, enable_int8_tower, int8_vfm_enabled
from .train.loss import TotalLoss
from .train.lpips import build_lpips
from .train.train_step import Trainer

# The keyword arguments of __graft_entry__.flagship_generator (JAX package).
FLAGSHIP_KWARGS = dict(
    conditional=False,
    label_type="cls2text",
    label_dim=None,
    vfm_name="siglip2-large-patch16-512",
    scale_factor=2.0,
    patch_from_layers=[0, 12, -1],
    patch_in_dimensions=[1024, 1024, 1024],
    patch_out_dimensions=[64, 64, 64],
    compression_mode="continuous",
    how_to_compress="attnproj",
    how_to_decompress="attnproj",
    decompress_factor=16,
    resolution_compression_factor=16,
    z_dimension=32,
    z_pooled_resolution=1,
    z_dim_for_mapping_mlp_output=512,
    concat_z_block_indices=[0, 1, 2, 3],
    concat_z_mapped_dims=[512, 256, 128, 128],
    activation_for_concat_z="lrelu",
    use_multiscale_output=True,
    attn_block_indices=[0, 1, 2],
    attn_depths=[2, 2, 2],
    use_self_attn=True,
    use_convnext=True,
    add_additional_convnext=True,
    img_resolution=256,
    num_blocks=6,
    num_fp16_res=3,
    conv_clamp=256,
    legacy=True,
    synthesis_kwargs=dict(channel_base=32768, channel_max=512, num_res_blocks=2,
                          architecture="skip"),
)


# Stage 0 (configs/vfm_vae_f16d32_siglip2_stage_0_strong_alignment.yaml).
# G_kwargs beyond FLAGSHIP_KWARGS: the VF margins and weights (lines 43-46),
# and the loss switches that vfm_vae_tpu/core/config.py:79-81 derives from
# loss_kwargs (kl and vf weights > 0, lines 80-81; adaptive VF, line 82);
# then the EQ-prior probabilities (lines 58-59) and the train mode (line 62).
STAGE0_G = dict(
    use_vf_loss=True, use_kl_loss=True, use_adaptive_vf_loss=True,
    distmat_margin=0.0, cos_margin=0.0, distmat_weight=1.0, cos_weight=1.0,
)
STAGE0_EQ = dict(p_eq_prior=0.5, p_eq_prior_scale=0.25)  # lines 58-59
STAGE0_TRAIN_MODE = "train_all"  # line 62
# D_kwargs (lines 71-75); vfm_name follows G, as train/loop.py:156 sets it.
STAGE0_D = dict(use_stylegan_t_discriminator=True, use_patchgan_discriminator=False,
                get_interm_feat=False)
# DINO ViT-S/16 (timm vit_small_patch16_224_dino) with the DPT taps.
STAGE0_DINO = dict(hidden_size=384, num_layers=12, num_heads=6, mlp_dim=1536, patch_size=16,
                   image_size=224, hooks=(2, 5, 8, 11), hook_patch=True)
# loss_kwargs (lines 77-96).
STAGE0_LOSS = dict(
    compression_mode="continuous", kl_loss_weight=1e-6, vf_loss_weight=5.0,
    use_adaptive_vf_loss=True, l1_pixel_loss_weight=1.0, l2_pixel_loss_weight=0.0,
    perceptual_loss_weight=10.0, ssim_loss_weight=0.0,
    multiscale_block_indices=[0, 1, 2, 3, 4],
    multiscale_pixel_loss_weights=[0.1, 0.1, 0.1, 0.1, 0.1],
    multiscale_pixel_loss_start_kimg=0, multiscale_pixel_loss_end_kimg=5000,
    stylegan_t_discriminator_loss_weight=1.0, patchgan_discriminator_loss_weight=0.0,
    feature_matching_loss_weight=0.0, use_stylegan_t_disc_warmup=False,
    use_patchgan_disc_warmup=False, use_equivariance_regularization=True,
)
# Discrete mode (configs/vfm_vae_details.yaml:34, :44-50): the multi-codebook
# VQ in place of the diagonal Gaussian, z 16x16x64 (eight codebooks of 4096
# codes, 8 wide). Overrides of FLAGSHIP_KWARGS and STAGE0_LOSS; the loss's
# VQ and entropy weights are the JAX TotalLoss's defaults (the YAMLs name
# neither).
DISCRETE_G = dict(compression_mode="discrete", vocab_width=64, vocab_size=32768,
                  vocab_beta=0.25, use_entropy_loss=False, entropy_temp=0.01, num_codebooks=8)
DISCRETE_LOSS = dict(compression_mode="discrete", vq_loss_weight=1.0, entropy_loss_weight=0.0)
# The DINOv2 tokenizer: the flagship with the DINOv2-L/14 tower
# (configs/vfm_vae_details.yaml:28 names the family) at the scale that gives
# the flagship's 32 x 32 grid (256 x 1.75 / 14).
DINOV2_G = dict(vfm_name="dinov2-large", scale_factor=1.75)
# The unconditional decoders beside the flagship's, as overrides of
# FLAGSHIP_KWARGS: the legacy StyleGAN-T layers with skip and orig images,
# the Fourier first block (block 0 without concat-z; concat_z_mapped_dims
# is indexed by block index), the blur off, the skip images in place of the
# multiscale ones.
DECODER_VARIANTS = {
    "legacy_skip": dict(use_convnext=False),
    "legacy_orig": dict(use_convnext=False, synthesis_kwargs=dict(
        FLAGSHIP_KWARGS["synthesis_kwargs"], architecture="orig")),
    "fourier": dict(concat_z_block_indices=[1, 2, 3]),
    "blur_off": dict(use_gaussian_blur=False),
    "multiscale_off": dict(use_multiscale_output=False),
}
# G_opt_kwargs / D_opt_kwargs (lines 98-108) and the EMA (lines 116-117).
STAGE0_OPT = dict(lr=1e-4, betas=(0.0, 0.99), eps=1e-8)
STAGE0_EMA = dict(ema_kimg=160.0, ema_rampup=0.05)


def configure_precision() -> None:
    """Full-fp32 matrix products and convolutions where fp32 is asked for."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def flagship_generator(device, dtype: torch.dtype = torch.bfloat16,
                       generator: Optional[torch.Generator] = None, **overrides) -> Generator:
    """The flagship tokenizer on `device`, parameters drawn from `generator`
    (default: a generator on `device` seeded 0). Sets the precision policy."""
    configure_precision()
    kwargs = dict(FLAGSHIP_KWARGS, **overrides)
    return Generator(**kwargs, dtype=dtype, device=device, generator=generator).eval()


def dinov2_generator(device, dtype: torch.dtype = torch.bfloat16,
                     generator: Optional[torch.Generator] = None, **overrides) -> Generator:
    """The flagship tokenizer on a DINOv2-L/14 tower (DINOV2_G): a 256 px
    image resized x1.75 to 448 px, a 32 x 32 grid of 1024-wide tokens, so
    the adapter and the decoder are the flagship's."""
    return flagship_generator(device, dtype, generator, **dict(DINOV2_G, **overrides))


def int8_serving_generator(device, calib_imgs: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
                           generator: Optional[torch.Generator] = None,
                           decoder_mlp: bool = False, **overrides) -> Generator:
    """flagship_generator + enable_int8_tower: the tower's Linears mirrored to
    int8 and their static activation scales calibrated on `calib_imgs`
    ((B, H, W, 3) in [0, 1] on `device`); sets VFM_VAE_INT8_VFM=1 for the
    process. decoder_mlp=True (enable_int8_decoder): the decoder's ConvNeXt
    MLPs mirrored too, their scales calibrated through a decode of the
    serving encode of `calib_imgs`; the layers at maps of at most 64 x 64
    then run both MLP products on K6. The flash switches (VFM_VAE_USE_PALLAS_FLASH,
    VFM_VAE_ADAPTER_ATTN) are the caller's."""
    G = flagship_generator(device, dtype, generator, **overrides)
    (enable_int8_decoder if decoder_mlp else enable_int8_tower)(G, calib_imgs)
    return G


def flagship_trainer(device, batch_size: int, generator: torch.Generator,
                     dtype: torch.dtype = torch.bfloat16, lpips_path: Optional[str] = None,
                     allow_random_lpips: bool = False, **overrides) -> Trainer:
    """The stage-0 trainer on `device`: the flagship G (train_all: the
    tower frozen; `overrides` of FLAGSHIP_KWARGS, such as DINOV2_G), the
    StyleGAN-T D with a frozen DINO ViT-S/16, LPIPS (a local vgg.pth, or
    seeded random weights behind allow_random_lpips), the loss, Adam for G
    and D and the EMA, all drawn from `generator`. `batch_size` sets the EMA
    horizon's batch."""
    configure_precision()
    G = Generator(**dict(FLAGSHIP_KWARGS, **overrides), **STAGE0_G, dtype=dtype,
                  device=device, generator=generator)
    D = ProjectedDiscriminator(vfm_name=G.vfm_encoder.model_name, compute_dtype=dtype,
                               dino_kwargs=STAGE0_DINO, device=device, generator=generator,
                               **STAGE0_D)
    lpips = build_lpips(device, lpips_path, allow_random_lpips=allow_random_lpips,
                        generator=generator)
    loss = TotalLoss(G, D, vfm_name=G.vfm_encoder.model_name, lpips_module=lpips,
                     **STAGE0_LOSS)
    g_trainable = trainable_names(G, trainable_path_predicates(STAGE0_TRAIN_MODE))
    d_trainable = {n for n, _ in D.named_parameters() if not n.startswith("dino.")}
    return Trainer(loss, g_trainable, d_trainable, STAGE0_OPT, STAGE0_OPT,
                   batch_size=batch_size, **STAGE0_EMA)


def tower_linears(enc, grid: int) -> List[tuple]:
    """(Linear, rows per image) of every tower Linear that one encode_image
    of a `grid` x `grid` patch grid runs: 1 + grid^2 rows with a CLS token,
    a quarter of grid^2 at Qwen's merger (one row a 2 x 2 merge unit);
    SigLIP's MAP head only runs for the pooled output, and is left out."""
    T = grid * grid + int(enc.has_cls_prefix)
    unit = enc.preset.get("spatial_merge_size", 2) ** 2
    return [(m, T // unit if name.startswith("merger.") else T)
            for name, m in enc.tower.named_modules()
            if isinstance(m, layers.Linear) and not name.startswith("head.")]


def kernel_sites(G: Generator, hw: int) -> Dict[str, List[dict]]:
    """Every kernel call of one decode whose image is `hw` pixels a side (the
    configured size, or an EQ bucket's: z scaled by 0.25 to 0.75 gives a
    proportionally smaller image), and of one encode of an `hw`-pixel image,
    with the shapes they are given (batch excluded) and how many times they
    run, as the process is set now:
    - the decode's K2 and K3 sites always run; K1's run as K1, or as K9
      ("fused_convnext_mlp_pipelined") under VFM_VAE_MLP_PIPELINE=1;
    - K5 ("channel_moments") at every GroupNorm statistic of the decode
      that the opt-in rule admits (VFM_VAE_PALLAS_STATS=1, C % 128 == 0,
      H * W >= 1024): the ConvNeXt layers' and the pre-normalized
      upsamples' folded GroupNorm, and a bf16 GroupNorm after block 0's
      upsample (the z injectors normalize in the adapter's fp32, which
      takes the two-pass form);
    - the encode's K6 ("int8_matmul", M = tokens per image: 1 + grid^2
      with a CLS token, a quarter of the grid at Qwen's merger) at every tower
      Linear when the tower's int8 path is on (VFM_VAE_INT8_VFM=1, or a
      caller's int8 scope), and K4 ("flash_attention_nonull") at every
      tower and adapter attention that the flash rule admits (the flash
      switches), and at the adapter's post_quant on the decode side
      ("at": "post_quant"); K4's backward kernels at the adapter's K4 sites,
      which train (the tower is frozen);
    - K7 ("dwconv_noise_stats", with the layer's legacy noise) and K8
      ("depthwise_conv2d_same") at every ConvNeXt dwconv their rules
      admit. No model path runs them: they are the dwconv probe's sites;
    - at a ConvNeXt layer whose calibrated int8 mirrors the int8 gate admits
      (enable_int8_decoder; maps of at most 64 x 64), K6's gelu mode
      ("int8_matmul_gelu", M = H * W rows an image, K = C, N = 4C) and its
      residual mode ("int8_matmul_residual", M = H * W, K = 4C, N = C) in
      place of K1;
    - the legacy StyleGAN-T layers, the first block's upsample and the
      upsamples with the blur off or even taps run no kernel but K5 (at
      their GroupNorms, where its rule admits them)."""
    names = ("fused_convnext_mlp", "fused_convnext_mlp_pipelined", "fused_upsample_blur",
             "flash_attention_nullkv", "channel_moments", "flash_attention_nonull",
             "flash_attention_nonull_bwd_dkv", "flash_attention_nonull_bwd_dq", "int8_matmul",
             "dwconv_noise_stats", "depthwise_conv2d_same", "int8_matmul_gelu",
             "int8_matmul_residual")
    sites: Dict[str, Dict[tuple, int]] = {name: {} for name in names}

    def add(name, key):
        sites[name][key] = sites[name].get(key, 0) + 1

    def stats(C, H, dtype=torch.bfloat16):
        if dtype != torch.float32 and moments_eligible(torch.empty((1, H, H, C), device="meta")):
            add("channel_moments", (("C", C), ("H", H)))

    mlp = "fused_convnext_mlp_pipelined" if pipeline_enabled() else "fused_convnext_mlp"
    top = G.synthesis.block_resolutions[-1]
    for block, res in zip(G.synthesis.blocks, G.synthesis.block_resolutions):
        res = res * hw // top
        for m in block.modules():
            if isinstance(m, ConvNeXtSynthesisLayer):
                C, k = m.norm.weight.shape[0], m.dwconv.weight.shape[-1]
                if m.int8_route(torch.empty((1, res, res, C), device="meta")):
                    add("int8_matmul_gelu", (("M", res * res), ("K", C), ("N", 4 * C)))
                    add("int8_matmul_residual", (("M", res * res), ("K", 4 * C), ("N", C)))
                else:
                    add(mlp, (("C", C), ("H", res)))
                stats(C, res)
                x = torch.empty((1, res, res, C), device="meta")
                key = (("C", C), ("H", res), ("k", k), ("noise", m.legacy))
                if dwconv_stats_eligible(x, k):
                    add("dwconv_noise_stats", key)
                if pallas_dw_eligible(x, k, 1, k // 2, C, C, C):
                    add("depthwise_conv2d_same", key[:3])
            elif isinstance(m, SeparableUpsampleWithFixedBlur) and m.fused:
                ci = m.depthwise.weight.shape[0]
                co = m.pointwise.weight.shape[0] // 4
                add("fused_upsample_blur",
                    (("Ci", ci), ("Co", co), ("H", res // 2), ("taps", tuple(m.taps))))
                stats(ci, res // 2)
            elif isinstance(m, SeparableUpsampleWithFixedBlur):
                # GroupNorm before (a plain upsample) or after the shuffle.
                stats(m.norm.weight.shape[0], res // 2 if m.pre_normalize else res, block.dtype)
            elif isinstance(m, SynthesisLayer) and m.residual:
                stats(m.norm.weight.shape[0], res, block.dtype)
            elif isinstance(m, SelfAttention):
                add("flash_attention_nullkv", (("T", res * res), ("N", m.heads), ("D", m.dim_head)))

    enc = G.vfm_encoder
    grid = int(hw * enc.scale_factor) // enc.patch_size
    T = grid * grid + int(enc.has_cls_prefix)
    for m in enc.tower.modules():
        if isinstance(m, MultiHeadSelfAttention) and flash_eligible_shape(T, T, m.head_dim,
                                                                          False):
            add("flash_attention_nonull",
                (("T", T), ("N", m.num_heads), ("D", m.head_dim), ("at", "tower")))
    if int8_vfm_enabled() or layers._INT8_SCOPE[0]:
        for m, M in tower_linears(enc, grid):
            add("int8_matmul", (("M", M), ("K", m.weight.shape[1]), ("N", m.weight.shape[0]),
                                ("static", m._buffers["as"] is not None)))
    ad = G.ldm_adapter
    quants = [(getattr(pq, "0"), grid * grid) for pq in ad.patch_quants]  # the CLS stripped
    quants.append((ad.final_quant, (grid * ad.z_resolution // ad.patch_resolutions[0]) ** 2))
    variant = os.environ.get("VFM_VAE_ADAPTER_ATTN", "3mm-xla")
    prefer = variant == "3mm-flash" or not variant.startswith("3mm")
    # post_quant decodes the z of an `hw`-pixel decode (32-wide heads in the
    # continuous flagship, never admitted; 64-wide in discrete mode, T=256
    # N=16 at the full image).
    quants.append((ad.post_quant, (hw * ad.z_resolution // top) ** 2))
    for proj, tokens in quants:
        at = "post_quant" if proj is ad.post_quant else "adapter"
        for m in proj.modules():
            if isinstance(m, PlainAttention):
                d = m.wide // m.num_heads
                if flash_eligible_shape(tokens, tokens, d, False, prefer):
                    key = (("T", tokens), ("N", m.num_heads), ("D", d), ("at", at))
                    for name in ("flash_attention_nonull", "flash_attention_nonull_bwd_dkv",
                                 "flash_attention_nonull_bwd_dq"):
                        add(name, key)
    return {name: [dict(dict(k), count=n) for k, n in d.items()] for name, d in sites.items()}


def eq_image_size(G: Generator, eq) -> int:
    """Side of the image that G decodes for an EQ bucket (scale, angle,
    is_prior): a latent bucket resizes z by the scale, a prior bucket
    shrinks the tower's grid and so z by the same factor, and the decoder
    keeps its image-to-z ratio. The `hw` of kernel_sites."""
    zr = G.ldm_adapter.z_resolution
    return int(zr * eq[0]) * (G.synthesis.block_resolutions[-1] // zr)

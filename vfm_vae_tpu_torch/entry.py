"""Port entry points: the flagship f16d32 SigLIP2-L tokenizer.

`flagship_generator` builds the configuration that the JAX package's
`__graft_entry__.entry()` runs (a 256 px image is resized to 512 px for the frozen
SigLIP2-L/16-512 tower, the attnproj adapter reads layers 0, 12 and -1,
z is 16x16x32, and six ConvNeXt synthesis blocks decode 8 -> 256 px), with
random weights drawn from an explicit torch.Generator.

Precision policy: bf16 compute with fp32 normalization statistics. TF32 is
off for fp32 matrix products and convolutions (`configure_precision`):
TF32 operands keep ~3 decimal digits, the same class of error as feeding
an E[x^2] - E[x]^2 variance from low-precision operands.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .models.convnext import ConvNeXtSynthesisLayer, SeparableUpsampleWithFixedBlur
from .models.generator import Generator
from .models.gigagan import SelfAttention

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


def kernel_sites(G: Generator, hw: int) -> Dict[str, List[dict]]:
    """Every K1/K2/K3 call of one decode at image size `hw`, with the shapes
    the decode gives it (batch excluded) and how many times it runs."""
    sites: Dict[str, Dict[tuple, int]] = {"fused_convnext_mlp": {}, "fused_upsample_blur": {},
                                          "flash_attention_nullkv": {}}
    scale = hw // G.synthesis.block_resolutions[-1]
    for block, res in zip(G.synthesis.blocks, G.synthesis.block_resolutions):
        res = res * scale
        for m in block.modules():
            if isinstance(m, ConvNeXtSynthesisLayer):
                key = (("C", m.norm.weight.shape[0]), ("H", res))
                name = "fused_convnext_mlp"
            elif isinstance(m, SeparableUpsampleWithFixedBlur) and m.pre_normalize:
                ci = m.depthwise.weight.shape[0]
                co = m.pointwise.weight.shape[0] // 4
                key = (("Ci", ci), ("Co", co), ("H", res // 2), ("taps", tuple(m.taps)))
                name = "fused_upsample_blur"
            elif isinstance(m, SelfAttention):
                key = (("T", res * res), ("N", m.heads), ("D", m.dim_head))
                name = "flash_attention_nullkv"
            else:
                continue
            sites[name][key] = sites[name].get(key, 0) + 1
    return {name: [dict(dict(k), count=n) for k, n in d.items()] for name, d in sites.items()}

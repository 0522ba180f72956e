"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

Each wrapper runs its plain twin for CPU tensors (the tests' path) and
launches its kernel for CUDA tensors, or raises; ``plain=True`` selects the
twin on the card explicitly, for comparisons. Every launch adds one to the
wrapper's ``launches`` counter. The decoder's forward wrappers (K1-K3) are
differentiable through their autograd Functions; K3's Function runs its
backward (pre-pass, dK/dV and dQ kernels) in one library call, which counts
one launch of each of the two backward wrappers. K4 (flash attention
without a null token) is differentiable through its Function, whose
backward does the same with K4's two backward wrappers. K5 (GroupNorm
moments) runs where its opt-in rule admits a map, and K9 (K1 pipelined) in
K1's place under VFM_VAE_MLP_PIPELINE=1. K6 (fused
int8 quantize + GEMM) and K10 (its bare int8 GEMM) are forward only. K7 and
K8 (depthwise conv + statistics, and without) are not on a model path: they
run only as the dwconv probe.
"""

from .dwconv_stats import (
    DwconvNoiseStats,
    depthwise_conv2d_same,
    depthwise_conv2d_same_reference,
    dwconv_noise_stats,
    dwconv_noise_stats_reference,
)
from .flash_attention import (
    FlashAttentionNoNull,
    FlashAttentionNullKV,
    flash_attention_nonull,
    flash_attention_nonull_bwd_dkv,
    flash_attention_nonull_bwd_dkv_reference,
    flash_attention_nonull_bwd_dq,
    flash_attention_nonull_bwd_dq_reference,
    flash_attention_nonull_bwd_reference,
    flash_attention_nullkv,
    flash_attention_nullkv_bwd_dkv,
    flash_attention_nullkv_bwd_dkv_reference,
    flash_attention_nullkv_bwd_dq,
    flash_attention_nullkv_bwd_dq_reference,
    flash_attention_nullkv_bwd_reference,
    flash_attention_nullkv_reference,
    flash_attention_nonull_reference,
)
from .fused_mlp import (
    FusedConvNeXtMLP,
    fused_convnext_mlp,
    fused_convnext_mlp_backward,
    fused_convnext_mlp_pipelined,
    fused_convnext_mlp_reference,
)
from .fused_upsample import FusedUpsampleBlur, fused_upsample_blur, fused_upsample_blur_reference
from .group_stats import ChannelMoments, channel_moments, channel_moments_reference
from .int8_matmul import int8_matmul, int8_matmul_raw, int8_matmul_reference

# The decoder's forward kernels (one per decode site), K3's backward
# kernels, the encoder's kernels with K4's backward, the opt-in decoder
# kernels (K5, K9), and the dwconv probe's (K7, K8).
WRAPPERS = (fused_convnext_mlp, fused_upsample_blur, flash_attention_nullkv)
BACKWARD_WRAPPERS = (flash_attention_nullkv_bwd_dkv, flash_attention_nullkv_bwd_dq)
NONULL_BACKWARD_WRAPPERS = (flash_attention_nonull_bwd_dkv, flash_attention_nonull_bwd_dq)
ALL_WRAPPERS = (WRAPPERS + BACKWARD_WRAPPERS
                + (flash_attention_nonull, int8_matmul, int8_matmul_raw)
                + NONULL_BACKWARD_WRAPPERS + (channel_moments, fused_convnext_mlp_pipelined)
                + (dwconv_noise_stats, depthwise_conv2d_same))


def reset_launch_counts() -> None:
    for fn in ALL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in ALL_WRAPPERS}


__all__ = [
    "ALL_WRAPPERS",
    "BACKWARD_WRAPPERS",
    "ChannelMoments",
    "DwconvNoiseStats",
    "FlashAttentionNoNull",
    "FlashAttentionNullKV",
    "FusedConvNeXtMLP",
    "FusedUpsampleBlur",
    "NONULL_BACKWARD_WRAPPERS",
    "WRAPPERS",
    "channel_moments",
    "channel_moments_reference",
    "depthwise_conv2d_same",
    "depthwise_conv2d_same_reference",
    "dwconv_noise_stats",
    "dwconv_noise_stats_reference",
    "flash_attention_nonull",
    "flash_attention_nonull_bwd_dkv",
    "flash_attention_nonull_bwd_dkv_reference",
    "flash_attention_nonull_bwd_dq",
    "flash_attention_nonull_bwd_dq_reference",
    "flash_attention_nonull_bwd_reference",
    "flash_attention_nullkv",
    "flash_attention_nullkv_bwd_dkv",
    "flash_attention_nullkv_bwd_dkv_reference",
    "flash_attention_nullkv_bwd_dq",
    "flash_attention_nullkv_bwd_dq_reference",
    "flash_attention_nullkv_bwd_reference",
    "flash_attention_nullkv_reference",
    "flash_attention_nonull_reference",
    "fused_convnext_mlp",
    "fused_convnext_mlp_backward",
    "fused_convnext_mlp_pipelined",
    "fused_convnext_mlp_reference",
    "fused_upsample_blur",
    "fused_upsample_blur_reference",
    "int8_matmul",
    "int8_matmul_raw",
    "int8_matmul_reference",
    "launch_counts",
    "reset_launch_counts",
]

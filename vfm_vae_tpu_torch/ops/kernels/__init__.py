"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

Each wrapper runs its plain twin for CPU tensors (the tests' path) and
launches its kernel for CUDA tensors, or raises; ``plain=True`` selects the
twin on the card explicitly, for comparisons. Every launch adds one to the
wrapper's ``launches`` counter. The decoder's forward wrappers (K1-K3) are
differentiable through their autograd Functions; K3's Function launches the
two backward wrappers. The encoder's kernels (K4 flash attention without a
null token, K6 fused int8 quantize + GEMM, and K10, K6's bare int8 GEMM) are
forward only.
"""

from .flash_attention import (
    FlashAttentionNullKV,
    flash_attention_nonull,
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
    fused_convnext_mlp_reference,
)
from .fused_upsample import FusedUpsampleBlur, fused_upsample_blur, fused_upsample_blur_reference
from .int8_matmul import int8_matmul, int8_matmul_raw, int8_matmul_reference

# The decoder's forward kernels (one per decode site), their backward kernels,
# and the encoder's kernels.
WRAPPERS = (fused_convnext_mlp, fused_upsample_blur, flash_attention_nullkv)
BACKWARD_WRAPPERS = (flash_attention_nullkv_bwd_dkv, flash_attention_nullkv_bwd_dq)
ALL_WRAPPERS = WRAPPERS + BACKWARD_WRAPPERS + (flash_attention_nonull, int8_matmul, int8_matmul_raw)


def reset_launch_counts() -> None:
    for fn in ALL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in ALL_WRAPPERS}


__all__ = [
    "ALL_WRAPPERS",
    "BACKWARD_WRAPPERS",
    "FlashAttentionNullKV",
    "FusedConvNeXtMLP",
    "FusedUpsampleBlur",
    "WRAPPERS",
    "flash_attention_nonull",
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
    "fused_convnext_mlp_reference",
    "fused_upsample_blur",
    "fused_upsample_blur_reference",
    "int8_matmul",
    "int8_matmul_raw",
    "int8_matmul_reference",
    "launch_counts",
    "reset_launch_counts",
]

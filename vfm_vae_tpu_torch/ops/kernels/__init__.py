"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

Each wrapper runs its plain twin for CPU tensors (the tests' path) and
launches its kernel for CUDA tensors, or raises; ``plain=True`` selects the
twin on the card explicitly, for comparisons. Every launch adds one to the
wrapper's ``launches`` counter. The forward wrappers are differentiable
through their autograd Functions; K3's Function launches the two backward
wrappers.
"""

from .flash_attention import (
    FlashAttentionNullKV,
    flash_attention_nullkv,
    flash_attention_nullkv_bwd_dkv,
    flash_attention_nullkv_bwd_dkv_reference,
    flash_attention_nullkv_bwd_dq,
    flash_attention_nullkv_bwd_dq_reference,
    flash_attention_nullkv_bwd_reference,
    flash_attention_nullkv_reference,
)
from .fused_mlp import (
    FusedConvNeXtMLP,
    fused_convnext_mlp,
    fused_convnext_mlp_backward,
    fused_convnext_mlp_reference,
)
from .fused_upsample import FusedUpsampleBlur, fused_upsample_blur, fused_upsample_blur_reference

WRAPPERS = (fused_convnext_mlp, fused_upsample_blur, flash_attention_nullkv)
ALL_WRAPPERS = WRAPPERS + (flash_attention_nullkv_bwd_dkv, flash_attention_nullkv_bwd_dq)


def reset_launch_counts() -> None:
    for fn in ALL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in ALL_WRAPPERS}


__all__ = [
    "ALL_WRAPPERS",
    "FlashAttentionNullKV",
    "FusedConvNeXtMLP",
    "FusedUpsampleBlur",
    "WRAPPERS",
    "flash_attention_nullkv",
    "flash_attention_nullkv_bwd_dkv",
    "flash_attention_nullkv_bwd_dkv_reference",
    "flash_attention_nullkv_bwd_dq",
    "flash_attention_nullkv_bwd_dq_reference",
    "flash_attention_nullkv_bwd_reference",
    "flash_attention_nullkv_reference",
    "fused_convnext_mlp",
    "fused_convnext_mlp_backward",
    "fused_convnext_mlp_reference",
    "fused_upsample_blur",
    "fused_upsample_blur_reference",
    "launch_counts",
    "reset_launch_counts",
]

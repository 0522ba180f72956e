"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

Each wrapper runs its plain twin for CPU tensors (the tests' path) and
launches its kernel for CUDA tensors, or raises; ``plain=True`` selects the
twin on the card explicitly, for comparisons. Every launch adds one to the
wrapper's ``launches`` counter.
"""

from .flash_attention import flash_attention_nullkv, flash_attention_nullkv_reference
from .fused_mlp import fused_convnext_mlp, fused_convnext_mlp_reference
from .fused_upsample import fused_upsample_blur, fused_upsample_blur_reference

WRAPPERS = (fused_convnext_mlp, fused_upsample_blur, flash_attention_nullkv)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


__all__ = [
    "WRAPPERS",
    "flash_attention_nullkv",
    "flash_attention_nullkv_reference",
    "fused_convnext_mlp",
    "fused_convnext_mlp_reference",
    "fused_upsample_blur",
    "fused_upsample_blur_reference",
    "launch_counts",
    "reset_launch_counts",
]

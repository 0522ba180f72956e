"""conv2d with fused up/downsampling (port of vfm_vae_tpu/ops/resample.py;
reference torch_utils/ops/conv2d_resample.py:46), used by the legacy
StyleGAN-T SynthesisLayer: FIR upsample -> convolution -> FIR downsample
with the reference's padding arithmetic, the JAX package's generic
decomposition."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .upfirdn import _get_filter_size, _parse_padding, upfirdn2d


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f=None, up: int = 1, down: int = 1,
                    padding=0, flip_weight: bool = True) -> torch.Tensor:
    """x (B, H, W, I) NHWC; w (O, I, kh, kw), torch's layout; f an FIR
    filter (upfirdn.setup_filter). flip_weight=False runs a true
    convolution (the kernel flipped), as the transposed conv of the
    reference's up=2 path computes."""
    fw, fh = _get_filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
    x = upfirdn2d(x, f if up > 1 else None, up=up, padding=[px0, px1, py0, py1], gain=up ** 2)
    if not flip_weight:
        w = w.flip(2, 3)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype)).permute(0, 2, 3, 1)
    if down > 1:
        y = upfirdn2d(y, f, down=down)
    return y

"""upfirdn2d: zero-insertion upsample -> pad (negative: crop) -> FIR filter
-> downsample -> gain, on NHWC maps (port of vfm_vae_tpu/ops/upfirdn.py:
`setup_filter`, `upfirdn2d`, `filter2d`, `upsample2d`, `downsample2d`;
semantics of the reference's torch_utils/ops/upfirdn2d.py:118).

Plain PyTorch: the filter is a fixed depthwise `F.conv2d`, the padding
`F.pad`. None of these is a TPU kernel in the JAX package (one XLA
convolution there). A 1-D (separable) filter runs as a vertical pass, then
a horizontal one, as in the JAX package; a 2-D filter as one convolution.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Filter = Optional[Union[np.ndarray, Sequence[float], float]]


def _parse_scaling(scaling) -> Tuple[int, int]:
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    if sx < 1 or sy < 1:
        raise ValueError(f"upfirdn2d: scaling {scaling}")
    return int(sx), int(sy)


def _parse_padding(padding) -> Tuple[int, int, int, int]:
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    padx0, padx1, pady0, pady1 = padding
    return int(padx0), int(padx1), int(pady0), int(pady1)


def _get_filter_size(f) -> Tuple[int, int]:
    if f is None:
        return 1, 1
    f = np.asarray(f)
    return int(f.shape[-1]), int(f.shape[0])


def setup_filter(f: Filter, normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1.0, separable: Optional[bool] = None) -> np.ndarray:
    """An FIR filter as a float32 numpy array, 1-D if separable, else 2-D
    (upfirdn.py:46; reference upfirdn2d.py:70): None is [1]; a 1-D filter
    of fewer than 8 taps becomes its outer product; normalized to sum 1,
    flipped, scaled by gain^(ndim / 2)."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    if f.ndim not in (0, 1, 2) or f.size == 0:
        raise ValueError(f"setup_filter: shape {f.shape}")
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    if f.ndim != (1 if separable else 2):
        raise ValueError("setup_filter: a separable filter must be 1-D")
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[tuple(slice(None, None, -1) for _ in range(f.ndim))]
    f = f * (gain ** (f.ndim / 2))
    return np.ascontiguousarray(f, dtype=np.float32)


def _depthwise(x: torch.Tensor, k: np.ndarray, pad, up, down) -> torch.Tensor:
    """NCHW x: insert up - 1 zeros after every sample, pad (x0, x1, y0, y1)
    with zeros or crop, correlate with the 2-D kernel k per channel, keep
    every down-th output."""
    B, C, H, W = x.shape
    upx, upy = up
    if upx > 1 or upy > 1:
        x = x.reshape(B, C, H, 1, W, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(B, C, H * upy, W * upx)
    x = F.pad(x, list(pad))
    w = torch.tensor(k.copy(), dtype=x.dtype, device=x.device)
    w = w[None, None].expand(C, 1, *k.shape).contiguous()
    return F.conv2d(x, w, stride=(down[1], down[0]), groups=C)


def upfirdn2d(x: torch.Tensor, f: Filter, up=1, down=1, padding=0, flip_filter: bool = False,
              gain: float = 1.0) -> torch.Tensor:
    """Upsample by zero insertion, pad (negative: crop) the upsampled map,
    convolve with `f` (flip_filter=False: a true convolution), keep every
    `down`-th pixel, scale by `gain` (upfirdn.py:86). x (B, H, W, C)."""
    if x.dim() != 4:
        raise ValueError("upfirdn2d: expected an NHWC map")
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    f = np.ones((1, 1), np.float32) if f is None else np.asarray(f, dtype=np.float32)
    if not flip_filter:  # F.conv2d correlates: flip for a true convolution
        f = f[tuple(slice(None, None, -1) for _ in range(f.ndim))]
    xc = x.permute(0, 3, 1, 2)
    if f.ndim == 1:
        y = _depthwise(xc, f[:, None], (0, 0, pady0, pady1), (1, upy), (1, downy))
        y = _depthwise(y, f[None, :], (padx0, padx1, 0, 0), (upx, 1), (downx, 1))
    else:
        y = _depthwise(xc, f, (padx0, padx1, pady0, pady1), (upx, upy), (downx, downy))
    if gain != 1.0:
        y = y * gain
    return y.permute(0, 2, 3, 1).to(x.dtype)


def filter2d(x, f, padding=0, flip_filter: bool = False, gain: float = 1.0):
    """Same-size FIR filtering (upfirdn.py:184)."""
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + fw // 2, padx1 + (fw - 1) // 2, pady0 + fh // 2, pady1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter: bool = False, gain: float = 1.0):
    """FIR upsample (upfirdn.py:192)."""
    upx, upy = _parse_scaling(up)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + (fw + upx - 1) // 2, padx1 + (fw - upx) // 2,
         pady0 + (fh + upy - 1) // 2, pady1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter: bool = False, gain: float = 1.0):
    """FIR downsample (upfirdn.py:206)."""
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + (fw - downx + 1) // 2, padx1 + (fw - downx) // 2,
         pady0 + (fh - downy + 1) // 2, pady1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)

"""Resampling with torch's F.interpolate / adaptive-pool conventions as
matrix products (port of vfm_vae_tpu/ops/resize.py: bilinear, bicubic,
adaptive average pooling and the integer-angle rot90; the resampling
matrices are the JAX package's, built with numpy on the host). The angle of
`rot90` is a host integer: eager PyTorch takes the host-sampled EQ angle, so
the JAX package's traced-angle variant has no counterpart here."""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )


def _linear_kernel(x: np.ndarray) -> np.ndarray:
    return np.clip(1.0 - np.abs(x), 0.0, None)


@lru_cache(maxsize=256)
def resize_matrix(
    in_size: int,
    out_size: int,
    kind: str = "linear",
    antialias: bool = False,
    a: Optional[float] = None,
) -> np.ndarray:
    """(out_size, in_size) float32 resampling matrix, torch conventions
    (half-pixel sampling; edge-clamped fixed taps, or PIL-style antialias)."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    scale = in_size / out_size
    M = np.zeros((out_size, in_size), dtype=np.float64)
    if antialias:
        if kind == "linear":
            support, kern = 1.0, _linear_kernel
        else:
            aa = -0.5 if a is None else a
            support, kern = 2.0, lambda v: _cubic_kernel(v, aa)
        kscale = max(scale, 1.0)
        ss = support * kscale
        for i in range(out_size):
            center = (i + 0.5) * scale
            xmin = max(0, int(center - ss + 0.5))
            xmax = min(in_size, int(center + ss + 0.5))
            idx = np.arange(xmin, xmax)
            w = kern((idx - center + 0.5) / kscale)
            s = w.sum()
            if s != 0:
                w = w / s
            M[i, xmin:xmax] = w
    else:
        for i in range(out_size):
            src = (i + 0.5) * scale - 0.5
            i0 = int(np.floor(src))
            t = src - i0
            if kind == "linear":
                taps = ((i0, 1 - t), (i0 + 1, t))
            else:
                offs = np.array([-1, 0, 1, 2])
                taps = zip(i0 + offs, _cubic_kernel(offs - t, -0.75 if a is None else a))
            for tap, w in taps:
                M[i, min(max(int(tap), 0), in_size - 1)] += w
    return M.astype(np.float32)


@lru_cache(maxsize=64)
def _adaptive_matrix(in_size: int, out_size: int) -> np.ndarray:
    """adaptive_avg_pool1d bins: bin i = [floor(i*I/O), ceil((i+1)*I/O))."""
    M = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -((-(i + 1) * in_size) // out_size)
        M[i, lo:hi] = 1.0 / (hi - lo)
    return M


def _apply_hw(x: torch.Tensor, Mh: np.ndarray, Mw: np.ndarray) -> torch.Tensor:
    """Two fp32 matrix products over the spatial axes of an NHWC map."""
    mh = torch.from_numpy(Mh).to(x.device)
    mw = torch.from_numpy(Mw).to(x.device)
    y = torch.einsum("oh,bhwc->bowc", mh, x.float())
    y = torch.einsum("ow,bhwc->bhoc", mw, y)
    return y.to(x.dtype)


def _out_hw(shape, size, scale_factor) -> Tuple[int, int]:
    if size is not None:
        return (size, size) if isinstance(size, int) else (int(size[0]), int(size[1]))
    if scale_factor is None:
        raise ValueError("resize: give size or scale_factor")
    sf_h = sf_w = float(scale_factor) if np.ndim(scale_factor) == 0 else None
    if sf_h is None:
        sf_h, sf_w = float(scale_factor[0]), float(scale_factor[1])
    return int(int(shape[1]) * sf_h), int(int(shape[2]) * sf_w)


def resize_bilinear(x: torch.Tensor, size=None, scale_factor=None, antialias: bool = False):
    """F.interpolate(mode='bilinear', align_corners=False) on NHWC."""
    oh, ow = _out_hw(x.shape, size, scale_factor)
    Mh = resize_matrix(int(x.shape[1]), oh, "linear", antialias)
    Mw = resize_matrix(int(x.shape[2]), ow, "linear", antialias)
    return _apply_hw(x, Mh, Mw)


def resize_bicubic(x: torch.Tensor, size=None, scale_factor=None, antialias: bool = False):
    """F.interpolate(mode='bicubic', align_corners=False) on NHWC; with
    antialias, PIL's support-scaled cubic (a = -0.5)."""
    oh, ow = _out_hw(x.shape, size, scale_factor)
    Mh = resize_matrix(int(x.shape[1]), oh, "cubic", antialias)
    Mw = resize_matrix(int(x.shape[2]), ow, "cubic", antialias)
    return _apply_hw(x, Mh, Mw)


def rot90(x: torch.Tensor, k: int, dims=(2, 1)) -> torch.Tensor:
    """jnp.rot90(x, k, axes=dims) for a host integer k (identity when k % 4 == 0)."""
    k = int(k) % 4
    return torch.rot90(x, k, dims=list(dims)) if k else x


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    """F.adaptive_avg_pool2d on NHWC."""
    oh, ow = (output_size, output_size) if isinstance(output_size, int) else output_size
    return _apply_hw(x, _adaptive_matrix(int(x.shape[1]), int(oh)),
                     _adaptive_matrix(int(x.shape[2]), int(ow)))

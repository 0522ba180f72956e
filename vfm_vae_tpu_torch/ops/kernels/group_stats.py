"""K5: per-(sample, channel) fp32 moments (sum of x, sum of x^2) of a
(B, H, W, C) map, the GroupNorm statistics.

Replaces the TPU kernel vfm_vae_tpu/ops/pallas/group_stats.py:_moments
(`channel_moments` :73); the plain twin below is that file's
`channel_moments_reference`, and `moments_eligible` its opt-in rule
without the TPU-backend test.

On the H100 the kernel (csrc/group_stats.cu) is bound by the one read of x.
Its design is a fixed-order reduction in one launch: CTAs over (sample, row
chunk, 128-channel block) write fp32 partials to a workspace, and the last
CTA of each (sample, channel block) to arrive, found through a counter,
adds the block's partials in chunk order in fp64. No float atomics, so two
launches on the same input give the same bits (the training step's
determinism gate pairs quantities across calls). The workspace (partials
and counters) is kept per (device, stream) and grows as needed; the kernel
leaves its counters at 0, and calls on one stream run in order, so no two
kernels ever share it. A call allocates only its output, s1 and s2 as
views of one (2, B, C) tensor.

Gradients: `ChannelMoments` carries the JAX custom VJP `_bwd` (:82) in
PyTorch: dx = g1 + 2 x g2 in fp32, cast to x's dtype.
"""

from __future__ import annotations

import math
import os

import torch

from ._build import call_on, check_all, library, refuse_grad, stream_workspace

# CTAs the chunk count aims at (132 SMs x 4 CTAs of 256 threads, each
# thread with four 16-byte loads in flight), and the fewest rows a chunk
# takes.
_TARGET_CTAS = 132 * 4
_MIN_ROWS = 128
# (device index, raw stream) -> (fp32 partials, int32 counters): the
# kernel's workspace, one per stream (calls on a stream run in order).
_WORKSPACES: dict = {}


def moments_eligible(x: torch.Tensor) -> bool:
    """vfm_vae_tpu/ops/pallas/group_stats.py:moments_eligible without its TPU
    test: opt-in by VFM_VAE_PALLAS_STATS=1, lane-aligned C (a multiple of
    128) and at least 32 x 32 positions."""
    if os.environ.get("VFM_VAE_PALLAS_STATS") != "1":
        return False
    _, H, W, C = x.shape
    return C % 128 == 0 and H * W >= 32 * 32


def channel_moments_reference(x: torch.Tensor):
    """Plain twin: fp32 sums of x and x^2 over (H, W), each (B, C)."""
    xf = x.float()
    return xf.sum(dim=(1, 2)), xf.square().sum(dim=(1, 2))


def num_chunks(B: int, HW: int, C: int) -> int:
    """Row chunks per (sample, channel block) of the first pass: enough CTAs
    to fill the card, at least _MIN_ROWS rows each. A function of the shape
    only, so the summation order is fixed for a shape."""
    blocks = B * math.ceil(C / 128)
    return max(1, min(math.ceil(_TARGET_CTAS / blocks), math.ceil(HW / _MIN_ROWS)))


def _launch(x: torch.Tensor):
    refuse_grad("channel_moments", x)
    if x.dim() != 4:
        raise ValueError(f"channel_moments: expected (B, H, W, C), got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"channel_moments: {x.dtype}; the kernel takes bf16 or fp32")
    if C % (16 // x.element_size()) or B * H * W == 0:
        raise ValueError(f"channel_moments: shape {tuple(x.shape)}; C must be a multiple of "
                         f"{16 // x.element_size()} and the map non-empty")
    dev = x.device
    check_all("channel_moments", x.dtype, dev, [(x, "x", (B, H, W, C))])
    lib = library()
    nchunk = num_chunks(B, H * W, C)
    part, counters = stream_workspace(_WORKSPACES, dev, 2 * B * nchunk * C,
                                      B * math.ceil(C / 128))
    s = torch.empty((2, B, C), dtype=torch.float32, device=dev)
    err = call_on(dev, lib.lib.vfm_channel_moments, x.data_ptr(), part.data_ptr(),
                  counters.data_ptr(), s.data_ptr(), B, H * W, C, nchunk,
                  int(x.dtype == torch.float32))
    lib.check(err, "channel_moments")
    channel_moments.launches += 1
    return s[0], s[1]


def _forward(x: torch.Tensor, plain: bool):
    if plain or x.device.type == "cpu":
        return channel_moments_reference(x)
    return _launch(x)


class ChannelMoments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plain: bool):
        ctx.save_for_backward(x)
        return _forward(x, plain)

    @staticmethod
    def backward(ctx, g1, g2):
        (x,) = ctx.saved_tensors
        dx = g1.float()[:, None, None, :] + 2.0 * x.float() * g2.float()[:, None, None, :]
        return dx.to(x.dtype), None


def channel_moments(x: torch.Tensor, *, plain: bool = False):
    """x (B, H, W, C) -> (sum, sum of squares), both (B, C) fp32. CPU tensors
    (or plain=True) run the twin; CUDA tensors launch the kernel: bf16 or
    fp32, contiguous. Differentiable through ChannelMoments."""
    if torch.is_grad_enabled() and x.requires_grad:
        return ChannelMoments.apply(x, plain)
    return _forward(x, plain)


channel_moments.launches = 0

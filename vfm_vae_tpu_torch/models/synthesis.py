"""Synthesis decoder (port of vfm_vae_tpu/models/synthesis.py: ZConv,
MappingNetwork (cls2text, unconditional), SynthesisInput, the legacy
StyleGAN-T SynthesisLayer and ToRGBLayer, SynthesisBlock (ConvNeXt or
legacy; multiscale, skip or orig), SynthesisNetwork, synthesis_channels).
Keys follow the reference: blocks.N.*, z_convs.N.* (nn.Sequential
indices)."""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.checkpoint import checkpoint

from ..ops.bias_act import activation_funcs, apply_activation, bias_act
from ..ops.pixelshuffle import pixel_shuffle, pixel_unshuffle
from ..ops.resample import conv2d_resample
from ..ops.resize import adaptive_avg_pool2d
from ..ops.upfirdn import setup_filter, upsample2d
from .convnext import (
    _NAME_SCOPE,
    LAYER_SCALE_INIT,
    ConvNeXtSynthesisLayer,
    ConvNeXtToRGBLayer,
    SeparableUpsampleWithFixedBlur,
)
from .gigagan import SelfAttentionBlock
from .layers import (
    MLP,
    Conv2d,
    FullyConnectedLayer,
    GroupNorm32,
    Module,
    StyleSplit,
    holder,
    normalize_2nd_moment,
    param,
    randn_,
)
from .modulated import demod_coefs, modulated_conv2d


def remat_policy(remat) -> Optional[str]:
    """The remat knob (synthesis.py:43-68) as None, "full", "dots" or "names":
      False / None / "none" -- no rematerialisation;
      True / "full"         -- every activation of a ConvNeXt layer recomputed
                               in the backward;
      "dots"                -- the outputs of plain products (mm, addmm, bmm,
                               baddbmm) kept, the rest recomputed;
      "names"               -- the dwconv's outputs kept (what runs inside
                               checkpoint_name("dwconv_out"): the convolution,
                               its NHWC copy and the bias add), the rest
                               recomputed.
    Unknown values raise, as in the JAX package."""
    if remat is None or remat is False or remat == "none":
        return None
    if remat is True or remat == "full":
        return "full"
    if remat in ("dots", "names"):
        return remat
    raise ValueError(f"unknown remat policy: {remat!r}")


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.baddbmm.default)


def _dots_saveable(op) -> bool:
    return op in _DOTS


def _dwconv_out_saveable(op) -> bool:
    # Views (detach among them) are recomputed: they cost no work, and a kept
    # view cannot be handed back as a fresh tensor.
    return bool(_NAME_SCOPE) and _NAME_SCOPE[-1] == "dwconv_out" and not op.is_view


_SELECTIVE = {"dots": _dots_saveable, "names": _dwconv_out_saveable}


class _Keep(TorchDispatchMode):
    """The forward of a checkpointed layer: the outputs of the ops that the
    policy selects are kept, in order, per op."""

    def __init__(self, saveable, kept: dict):
        super().__init__()
        self.saveable, self.kept = saveable, kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.saveable(func):
            self.kept.setdefault(func, []).append(
                tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor) else t, out))
        return out


class _Replay(TorchDispatchMode):
    """The recompute in a backward: the selected ops hand back what the
    forward kept, every other op runs again. Each backward pass that
    reaches the layer replays it from the start (the G step's anchor pull
    and its training pull both do), which torch's own selective checkpoint
    refuses."""

    def __init__(self, saveable, kept: dict):
        super().__init__()
        self.saveable, self.kept, self.seen = saveable, kept, {}

    def __enter__(self):
        self.seen = {}
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.saveable(func):
            return func(*args, **(kwargs or {}))
        i = self.seen.get(func, 0)
        self.seen[func] = i + 1
        return tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor) else t,
                        self.kept[func][i])


def _selective_contexts(saveable):
    kept: dict = {}
    return _Keep(saveable, kept), _Replay(saveable, kept)


def run_checkpointed(fn, policy: Optional[str], *args):
    """fn(*args) under torch.utils.checkpoint (non-reentrant) with `policy`
    (remat_policy's values), where a gradient is recorded; else plainly.

    The hand-written kernels are torch.autograd.Functions over ctypes
    launches, which no aten-level policy sees: under every policy K1's
    forward runs again in the backward of each checkpointed layer (its
    Function saves its inputs, not its output), where JAX's "dots" and
    "names" keep the Pallas call's residuals. The selective policies keep
    what their aten ops produce and hand it back in the recompute, so the
    numbers do not depend on the policy; torch replays every other op of
    the layer, where XLA drops the ones whose results are not needed. No
    random draw and no buffer update lies inside a ConvNeXt layer (the
    legacy noise is the noise_const buffer, read only), so the replay needs
    none of the explicit generators' states."""
    if policy is None or not torch.is_grad_enabled():
        return fn(*args)
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(_selective_contexts, _SELECTIVE[policy]))


def synthesis_channels(img_resolution: int, num_blocks: int, channel_base: int, channel_max: int):
    """(block resolutions, {block index: channels}) (generator.py:694-700)."""
    res_start = img_resolution // (2 ** (num_blocks - 1))
    block_resolutions = [res_start * (2 ** i) for i in range(num_blocks)]
    scale = img_resolution / 256
    channels = {idx: min(channel_base // int(res / scale), channel_max)
                for idx, res in enumerate(block_resolutions)}
    return block_resolutions, channels


def _conv3x3(cin: int, cout: int, device) -> nn.Module:
    return holder(**{
        "0": Conv2d(cin, cin, 3, padding=1, groups=cin, bias=False, device=device),
        "1": Conv2d(cin, cout, 1, bias=False, device=device),
        "2": GroupNorm32(min(32, cout), cout, device=device),
    })


def _conv1x1(cin: int, cout: int, device) -> nn.Module:
    return holder(**{
        "0": Conv2d(cin, cout, 1, bias=False, device=device),
        "1": GroupNorm32(min(32, cout), cout, device=device),
    })


class ZConv(Module):
    """Concat-z injector for one block (generator.py:726-784, 839-868;
    synthesis.py:416-460): below 2x the z resolution, pixel unshuffle
    ("unshuffle") or adaptive average pooling ("pooling") -> 3x3 -> 1x1; at
    it 3x3 -> 1x1; above it 3x3 -> shuffle -> 1x1."""

    def __init__(self, z_dim: int, out_dim: int, block_resolution: int, z_resolution: int,
                 how: str = "unshuffle", activation: str = "gelu", device=None):
        super().__init__()
        if how not in ("unshuffle", "pooling"):
            raise ValueError(f"ZConv: how_to_process_concat_z {how!r} is not unshuffle or pooling")
        self.activation, self.how = activation, how
        res, zres = block_resolution, z_resolution
        if res < zres * 2:
            self.kind, self.r = "down", int(zres / res * 2)
            cin = z_dim * self.r ** 2 if how == "unshuffle" else z_dim
            self.add_module("1", _conv3x3(cin, out_dim, device))
            self.add_module("2", _conv1x1(out_dim, out_dim, device))
        elif res == zres * 2:
            self.kind, self.r = "same", 1
            self.add_module("0", _conv3x3(z_dim, out_dim, device))
            self.add_module("1", _conv1x1(out_dim, out_dim, device))
        else:
            self.kind, self.r = "up", int(res / zres / 2)
            self.add_module("0", _conv3x3(z_dim, out_dim * self.r ** 2, device))
            self.add_module("2", _conv1x1(out_dim, out_dim, device))

    def _conv(self, key: str, x: torch.Tensor, act: bool) -> torch.Tensor:
        seq = self._modules[key]
        mods = [seq._modules[k] for k in sorted(seq._modules)]
        for m in mods:
            x = m(x)
        if act:
            x = apply_activation(x.float(), self.activation).to(x.dtype)
        return x

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        if self.kind == "down":
            if self.how == "unshuffle":
                z = pixel_unshuffle(z, self.r)
            else:
                z = adaptive_avg_pool2d(z, (max(1, int(z.shape[1] / self.r)),
                                            max(1, int(z.shape[2] / self.r))))
            z = self._conv("1", z, True)
            return self._conv("2", z, False)
        if self.kind == "same":
            return self._conv("1", self._conv("0", z, True), False)
        z = pixel_shuffle(self._conv("0", z, True), self.r)
        return self._conv("2", z, False)


class MappingNetwork(Module):
    """Pooled z -> w (cls2text, unconditional; generator.py:582-652): two
    lrelu FC layers with lr multiplier 0.01, the last one linear."""

    def __init__(self, z_dim_input: int, z_dim_output: int, num_ws: int, device=None):
        super().__init__()
        self.num_ws = num_ws
        self.mlp = MLP([z_dim_input] * 2 + [z_dim_output], activation="lrelu",
                       lr_multiplier=0.01, linear_out=True, device=device)
        self.register_buffer("x_avg", torch.zeros(z_dim_output, device=device))

    def forward(self, z: torch.Tensor, truncation_psi: float = 1.0,
                update_x_avg: bool = False) -> torch.Tensor:
        """update_x_avg: the training forward's moving average of the mapped
        latent (beta 0.995, synthesis.py:497-500), replaced out of place."""
        x = self.mlp(normalize_2nd_moment(z))
        if update_x_avg:
            self.x_avg = (x.detach().float().mean(0) * (1 - 0.995) + self.x_avg * 0.995)
        if truncation_psi != 1:
            x = self.x_avg[None] + truncation_psi * (x - self.x_avg[None])
        return x[:, None, :].expand(-1, self.num_ws, -1)


class SynthesisInput(Module):
    """Fourier-feature input grid (synthesis.py:71; generator.py:106-187):
    the first block's input when it takes no concat-z. Buffers `freqs`
    (C, 2), `phases` (C,) and `transform` (3, 3); the affine maps w to a
    rotation and a translation of the grid."""

    def __init__(self, w_dim: int, channels: int, size: int, sampling_rate: int,
                 bandwidth: float, device=None):
        super().__init__()
        self.channels, self.size = channels, int(size)
        self.sampling_rate, self.bandwidth = sampling_rate, bandwidth
        self.weight = param(channels, channels, device=device)
        self.affine = FullyConnectedLayer(w_dim, 4, weight_init=0.0, bias_init=[1, 0, 0, 0],
                                          device=device)
        self.register_buffer("freqs", torch.empty(channels, 2, device=device))
        self.register_buffer("phases", torch.empty(channels, device=device))
        self.register_buffer("transform", torch.eye(3, device=device))

    def reset_parameters(self, g):
        freqs = torch.randn(self.freqs.shape, generator=g, device=self.freqs.device)
        radii = freqs.square().sum(1, keepdim=True).sqrt()
        self.freqs.copy_(freqs / (radii * torch.exp(radii.square()) ** 0.25) * self.bandwidth)
        self.phases.copy_(torch.rand(self.phases.shape, generator=g,
                                     device=self.phases.device) - 0.5)
        self.transform.copy_(torch.eye(3, device=self.transform.device))
        randn_(self.weight, g)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        B, C = w.shape[0], self.channels
        t = self.affine(w)
        t = t / torch.linalg.vector_norm(t[:, :2], dim=1, keepdim=True)
        eye = torch.eye(3, device=w.device, dtype=t.dtype)
        m_r = eye[None].repeat(B, 1, 1)
        m_r[:, 0, 0], m_r[:, 0, 1], m_r[:, 1, 0], m_r[:, 1, 1] = t[:, 0], -t[:, 1], t[:, 1], t[:, 0]
        m_t = eye[None].repeat(B, 1, 1)
        m_t[:, 0, 2], m_t[:, 1, 2] = -t[:, 2], -t[:, 3]
        transforms = m_r @ m_t @ self.transform[None]
        ph = self.phases[None] + torch.einsum("cd,bde->bce", self.freqs,
                                              transforms[:, :2, 2:])[..., 0]
        fr = torch.einsum("cd,bde->bce", self.freqs, transforms[:, :2, :2])
        amplitudes = torch.clamp(
            1 - (torch.linalg.vector_norm(fr, dim=2) - self.bandwidth)
            / (self.sampling_rate / 2 - self.bandwidth), 0, 1)
        # F.affine_grid(align_corners=False) sampling positions.
        S = self.size
        coords = (2 * np.arange(S) + 1) / S - 1
        gx = coords[None, :] * (0.5 * S / self.sampling_rate)
        gy = coords[:, None] * (0.5 * S / self.sampling_rate)
        grid = torch.from_numpy(np.stack(np.broadcast_arrays(gx, gy), -1).astype(np.float32))
        x = torch.einsum("hwd,bcd->bhwc", grid.to(w.device), fr) + ph[:, None, None, :]
        x = torch.sin(x * (2 * math.pi)) * amplitudes[:, None, None, :]
        return x @ (self.weight.t() / math.sqrt(C)).to(x.dtype)


# The legacy layers' FIR filter for the up=2 conv and the skip images, as
# every JAX SynthesisBlock builds them (setup_filter([1, 3, 3, 1]): 4 x 4).
RESAMPLE_FILTER = setup_filter([1, 3, 3, 1])


class SynthesisLayer(Module):
    """Legacy StyleGAN-T modulated conv layer (synthesis.py:136;
    generator.py:190-281) as the JAX blocks build it: a style-modulated 3x3
    conv (up=2 through conv2d_resample with RESAMPLE_FILTER), demodulation,
    the constant noise map, bias + lrelu + gain + clamp; `residual`
    GroupNorms the input first and returns (gamma * y + norm(x)) * sqrt(2),
    gamma starting at 1e-5."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 up: int = 1, conv_clamp: Optional[float] = None, residual: bool = False,
                 gn_groups: int = 32, device=None):
        super().__init__()
        if residual and out_channels % gn_groups:
            # The JAX GroupNorm asserts C % groups == 0 when it runs (groupnorm.py:64).
            raise ValueError(f"SynthesisLayer: residual GroupNorm of {out_channels} channels "
                             f"in {gn_groups} groups")
        self.up, self.conv_clamp, self.residual = up, conv_clamp, residual
        self.affine = StyleSplit(w_dim, in_channels, bias_init=1, device=device)
        if residual:
            self.norm = GroupNorm32(gn_groups, out_channels, device=device)
        self.weight = param(out_channels, in_channels, 3, 3, device=device)
        self.bias = param(out_channels, device=device)
        self.register_buffer("noise_const", torch.empty(resolution, resolution, device=device))
        self.noise_strength = param(device=device)
        if residual:
            self.gamma = param(out_channels, device=device)

    def reset_parameters(self, g):
        randn_(self.weight, g)
        self.bias.zero_()
        randn_(self.noise_const, g)
        self.noise_strength.zero_()
        if self.residual:
            self.gamma.fill_(LAYER_SCALE_INIT)

    def forward(self, x: torch.Tensor, w: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        dt = x.dtype
        B = x.shape[0]
        styles = self.affine(w)
        if self.residual:
            x = self.norm(x)
        xs = x * styles.reshape(B, 1, 1, -1).to(dt)
        y = conv2d_resample(xs, self.weight.to(dt), f=RESAMPLE_FILTER, up=self.up, padding=1,
                            flip_weight=self.up == 1)
        y = y * demod_coefs(self.weight, styles).reshape(B, 1, 1, -1).to(y.dtype)
        y = y + (self.noise_const * self.noise_strength)[None, :, :, None].to(y.dtype)
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        y = bias_act(y.to(dt), self.bias, act="lrelu",
                     gain=activation_funcs["lrelu"].def_gain * gain, clamp=act_clamp)
        if self.residual:
            y = (self.gamma.to(dt) * y + x) * math.sqrt(2)
        return y


class ToRGBLayer(Module):
    """Legacy to-RGB (synthesis.py:207; generator.py:284-313): a modulated
    1x1 conv without demodulation, bias, clamp."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 conv_clamp: Optional[float] = None, device=None):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.weight_gain = 1 / math.sqrt(in_channels)
        self.weight = param(out_channels, in_channels, 1, 1, device=device)
        self.bias = param(out_channels, device=device)
        self.affine = StyleSplit(w_dim, in_channels, bias_init=1, device=device)

    def reset_parameters(self, g):
        randn_(self.weight, g, 0.1)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w) * self.weight_gain
        y = modulated_conv2d(x, self.weight, styles, padding=0, demodulate=False)
        return bias_act(y, self.bias, clamp=self.conv_clamp)


class SynthesisBlock(Module):
    """One resolution stage (synthesis.py:222; generator.py:322-579): the
    Fourier input (no input channels: the first block without concat-z),
    then ConvNeXt layers (upsample + conv0 + convs1) or the legacy StyleGAN-T
    layers (conv0 with up=2 + convs1, residual every second), GigaGAN
    self-attention with 8 heads and FF multiplier 4, and the image: the
    multiscale to-RGB of the running upsampled sum, or, with multiscale off,
    the skip image upsampled by RESAMPLE_FILTER plus this block's to-RGB
    (`skip`, or the last block of `orig`)."""

    def __init__(self, block_index: int, in_channels: int, out_channels: int,
                 last_out_channels: Optional[int], w_dim: int, resolution: int,
                 img_channels: int, is_first: bool, is_last: bool, num_res_blocks: int,
                 attn_depth: int, use_convnext: bool = True, use_multiscale_output: bool = True,
                 use_gaussian_blur: bool = True, architecture: str = "skip",
                 conv_clamp: Optional[float] = None, add_additional_convnext: bool = False,
                 legacy: bool = False, dtype: torch.dtype = torch.float32, remat=None,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.remat = remat_policy(remat)
        self.use_convnext, self.use_multiscale_output = use_convnext, use_multiscale_output
        kernel_size = 5 if block_index <= 1 else 7
        blur = "3x3" if block_index <= 2 else "5x5"
        if in_channels == 0:
            self.input = SynthesisInput(w_dim, out_channels, resolution, resolution, 2,
                                        device=device)
        if use_convnext:
            per_res = 3 if (block_index <= 3 and add_additional_convnext) else 2
            layer = dict(w_dim=w_dim, kernel_size=kernel_size, block_index=block_index,
                         legacy=legacy, device=device)
            if in_channels != 0:
                self.seperate_upsample_conv = SeparableUpsampleWithFixedBlur(
                    in_channels, out_channels, blur, pre_normalize=not is_first,
                    use_gaussian_blur=use_gaussian_blur, device=device)
                self.conv0 = ConvNeXtSynthesisLayer(out_channels, **layer)
            self.convs1 = nn.ModuleList(ConvNeXtSynthesisLayer(out_channels, **layer)
                                        for _ in range(per_res * num_res_blocks))
        else:
            layer = dict(conv_clamp=conv_clamp, device=device)
            if in_channels != 0:
                self.conv0 = SynthesisLayer(in_channels, out_channels, w_dim, resolution, up=2,
                                            **layer)
            self.convs1 = nn.ModuleList(
                SynthesisLayer(out_channels, out_channels, w_dim, resolution,
                               residual=i % 2 == 1, **layer)
                for i in range(2 * num_res_blocks))
        self.self_attns = nn.ModuleList(
            SelfAttentionBlock(out_channels, out_channels // 8, 8, 4, device=device)
            for _ in range(attn_depth))
        num_torgb = 1 if (is_last or architecture == "skip") else 0
        if use_multiscale_output or num_torgb:
            self.torgb = (ConvNeXtToRGBLayer(out_channels, img_channels, w_dim, device=device)
                          if use_convnext else
                          ToRGBLayer(out_channels, img_channels, w_dim, conv_clamp=conv_clamp,
                                     device=device))
        self.last_upsample_conv = None
        if use_multiscale_output and last_out_channels is not None:
            self.last_upsample_conv = SeparableUpsampleWithFixedBlur(
                last_out_channels, out_channels, blur, use_gaussian_blur=use_gaussian_blur,
                device=device)
        # One w for the input or conv0, one a convs1 layer, one for the to-RGB
        # that the architecture counts (synthesis.py:268-276).
        self.num_ws = 1 + len(self.convs1) + num_torgb

    def forward(self, x, x_sum, img, ws):
        w_idx = 0

        def next_w():
            # Past the block's slice (the multiscale to-RGB of a non-last
            # `orig` block, which the count leaves out) the JAX package's
            # index clamps to the slice's last w; every w of the
            # unconditional mapping is the same.
            nonlocal w_idx
            w = ws[:, min(w_idx, ws.shape[1] - 1)]
            w_idx += 1
            return w

        if hasattr(self, "input"):
            x = self.input(next_w())
        x = x.to(self.dtype)
        if self.use_convnext:
            if hasattr(self, "conv0"):
                x = self.seperate_upsample_conv(x)
                x = run_checkpointed(self.conv0, self.remat, x, next_w())
            for layer in self.convs1:
                x = run_checkpointed(layer, self.remat, x, next_w())
        else:
            if hasattr(self, "conv0"):
                x = self.conv0(x, next_w())
            for layer in self.convs1:
                x = layer(x, next_w(), gain=math.sqrt(0.5))
        for blk in self.self_attns:
            x = blk(x)
        x = x.to(self.dtype)
        if self.use_multiscale_output:
            x_sum = x if self.last_upsample_conv is None else self.last_upsample_conv(x_sum) + x
            img = self.torgb(x_sum, next_w()).float()
        else:
            if img is not None:
                img = upsample2d(img, RESAMPLE_FILTER)
            if hasattr(self, "torgb"):
                y = self.torgb(x, next_w()).float()
                img = img + y if img is not None else y
        return x, x_sum, img


class SynthesisNetwork(Module):
    """Stack of synthesis blocks with concat-z injection (synthesis.py:514;
    generator.py:655-912). concat_z_mapped_dims is indexed by block index,
    as in the JAX package (synthesis.py:590-595); empty, each injected
    block takes the unshuffle widths (:606-612)."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int = 3,
                 channel_base: int = 32768, channel_max: int = 512, num_blocks: int = 6,
                 num_res_blocks: int = 3, z_resolution: int = 16, z_dim: int = 8,
                 concat_z_block_indices: Sequence[int] = (),
                 concat_z_mapped_dims: Sequence[int] = (),
                 how_to_process_concat_z: str = "unshuffle", activation_for_concat_z: str = "gelu",
                 attn_block_indices: Sequence[int] = (), attn_depths: Sequence[int] = (),
                 use_convnext: bool = True, use_multiscale_output: bool = True,
                 use_gaussian_blur: bool = True, architecture: str = "skip",
                 conv_clamp: Optional[float] = None, add_additional_convnext: bool = False,
                 legacy: bool = False, dtype: torch.dtype = torch.float32, remat=None,
                 device=None):
        super().__init__()
        if architecture not in ("skip", "orig"):
            raise ValueError(f"SynthesisNetwork: architecture {architecture!r} is not skip or orig")
        block_res, channels = synthesis_channels(img_resolution, num_blocks, channel_base,
                                                 channel_max)
        self.concat_z = list(concat_z_block_indices)
        self.block_resolutions = block_res
        blocks, zconvs = [], {}
        for idx in range(num_blocks):
            in_ch = channels[idx - 1] if idx > 0 else 0
            if idx in self.concat_z:
                if concat_z_mapped_dims:
                    zc = list(concat_z_mapped_dims)[idx]
                elif block_res[idx] < z_resolution * 2:
                    zc = int(z_dim * (z_resolution / block_res[idx] * 2) ** 2)
                else:
                    zc = z_dim
                in_ch += zc
                zconvs[str(idx)] = ZConv(z_dim, zc, block_res[idx], z_resolution,
                                         how_to_process_concat_z, activation_for_concat_z,
                                         device=device)
            depth = (list(attn_depths)[list(attn_block_indices).index(idx)]
                     if idx in list(attn_block_indices) else 0)
            blocks.append(SynthesisBlock(
                idx, in_ch, channels[idx], channels[idx - 1] if idx > 0 else None, w_dim,
                block_res[idx], img_channels, idx == 0, idx == num_blocks - 1, num_res_blocks,
                depth, use_convnext=use_convnext, use_multiscale_output=use_multiscale_output,
                use_gaussian_blur=use_gaussian_blur, architecture=architecture,
                conv_clamp=conv_clamp, add_additional_convnext=add_additional_convnext,
                legacy=legacy, dtype=dtype, remat=remat, device=device))
        self.blocks = nn.ModuleList(blocks)
        self.z_convs = nn.ModuleDict(zconvs)
        self.num_ws = sum(b.num_ws for b in blocks)

    def forward(self, z: torch.Tensor, ws: torch.Tensor, return_multiscale: bool = False):
        """z (B, zr, zr, z_dim), ws (B, num_ws, w_dim) -> the last block's
        image, fp32; with return_multiscale also the other blocks' images,
        largest first (synthesis.py:686-711): with multiscale off, the
        running skip images (None for the non-last blocks of `orig`)."""
        ws = ws.float()
        x = x_sum = img = None
        multiscale = []
        w_idx = 0
        for idx, block in enumerate(self.blocks):
            if idx in self.concat_z:
                zc = self.z_convs[str(idx)](z)
                x = zc if x is None else torch.cat([x, zc.to(x.dtype)], dim=-1)
            x, x_sum, img = block(x, x_sum, img, ws[:, w_idx:w_idx + block.num_ws])
            w_idx += block.num_ws
            if idx != len(self.blocks) - 1:
                multiscale.append(img)
        return (img, multiscale[::-1]) if return_multiscale else img


def pooled_z(z: torch.Tensor, resolution: int) -> torch.Tensor:
    """adaptive_avg_pool2d to (r, r), flattened to (B, r*r*C)."""
    return adaptive_avg_pool2d(z, (resolution, resolution)).reshape(z.shape[0], -1)


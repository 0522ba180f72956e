"""ConvNeXt synthesis decoder (port of vfm_vae_tpu/models/synthesis.py:
ZConv, MappingNetwork (cls2text, unconditional), SynthesisBlock (ConvNeXt
and multiscale branch), SynthesisNetwork, synthesis_channels). Keys follow
the reference: blocks.N.*, z_convs.N.* (nn.Sequential indices)."""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn as nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.checkpoint import checkpoint

from ..ops.bias_act import apply_activation
from ..ops.pixelshuffle import pixel_shuffle, pixel_unshuffle
from ..ops.resize import adaptive_avg_pool2d
from .convnext import (
    _NAME_SCOPE,
    ConvNeXtSynthesisLayer,
    ConvNeXtToRGBLayer,
    SeparableUpsampleWithFixedBlur,
)
from .gigagan import SelfAttentionBlock
from .layers import MLP, Conv2d, GroupNorm32, Module, holder, normalize_2nd_moment


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


class SynthesisBlock(Module):
    """One resolution stage, ConvNeXt layers + multiscale to-RGB
    (generator.py:322-579); self-attention with 8 heads, FF multiplier 4."""

    def __init__(self, block_index: int, in_channels: int, out_channels: int,
                 last_out_channels: Optional[int], w_dim: int, img_channels: int,
                 is_first: bool, num_res_blocks: int, attn_depth: int,
                 add_additional_convnext: bool = False, legacy: bool = False,
                 dtype: torch.dtype = torch.float32, remat=None, device=None):
        super().__init__()
        if in_channels == 0:
            raise NotImplementedError("the Fourier SynthesisInput first block is not ported")
        self.dtype = dtype
        self.remat = remat_policy(remat)
        kernel_size = 5 if block_index <= 1 else 7
        blur = "3x3" if block_index <= 2 else "5x5"
        per_res = 3 if (block_index <= 3 and add_additional_convnext) else 2
        self.seperate_upsample_conv = SeparableUpsampleWithFixedBlur(
            in_channels, out_channels, blur, pre_normalize=not is_first, device=device)
        layer = dict(w_dim=w_dim, kernel_size=kernel_size, block_index=block_index,
                     legacy=legacy, device=device)
        self.conv0 = ConvNeXtSynthesisLayer(out_channels, **layer)
        self.convs1 = nn.ModuleList(ConvNeXtSynthesisLayer(out_channels, **layer)
                                    for _ in range(per_res * num_res_blocks))
        self.self_attns = nn.ModuleList(
            SelfAttentionBlock(out_channels, out_channels // 8, 8, 4, device=device)
            for _ in range(attn_depth))
        self.torgb = ConvNeXtToRGBLayer(out_channels, img_channels, w_dim, device=device)
        if last_out_channels is not None:
            self.last_upsample_conv = SeparableUpsampleWithFixedBlur(
                last_out_channels, out_channels, blur, device=device)
        else:
            self.last_upsample_conv = None
        self.num_ws = 2 + len(self.convs1)  # conv0 + convs1 + torgb

    def forward(self, x, x_sum, ws):
        x = self.seperate_upsample_conv(x.to(self.dtype))
        x = run_checkpointed(self.conv0, self.remat, x, ws[:, 0])
        for i, layer in enumerate(self.convs1):
            x = run_checkpointed(layer, self.remat, x, ws[:, 1 + i])
        for blk in self.self_attns:
            x = blk(x)
        x = x.to(self.dtype)
        x_sum = x if self.last_upsample_conv is None else self.last_upsample_conv(x_sum) + x
        img = self.torgb(x_sum, ws[:, -1]).float()
        return x, x_sum, img


class SynthesisNetwork(Module):
    """Stack of synthesis blocks with concat-z injection (generator.py:655-912)."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int = 3,
                 channel_base: int = 32768, channel_max: int = 512, num_blocks: int = 6,
                 num_res_blocks: int = 3, z_resolution: int = 16, z_dim: int = 8,
                 concat_z_block_indices: Sequence[int] = (),
                 concat_z_mapped_dims: Sequence[int] = (),
                 how_to_process_concat_z: str = "unshuffle", activation_for_concat_z: str = "gelu",
                 attn_block_indices: Sequence[int] = (), attn_depths: Sequence[int] = (),
                 add_additional_convnext: bool = False,
                 legacy: bool = False, dtype: torch.dtype = torch.float32, remat=None,
                 device=None):
        super().__init__()
        block_res, channels = synthesis_channels(img_resolution, num_blocks, channel_base,
                                                 channel_max)
        self.concat_z = list(concat_z_block_indices)
        self.block_resolutions = block_res
        blocks, zconvs = [], {}
        for idx in range(num_blocks):
            in_ch = channels[idx - 1] if idx > 0 else 0
            if idx in self.concat_z:
                zc = list(concat_z_mapped_dims)[idx]
                in_ch += zc
                zconvs[str(idx)] = ZConv(z_dim, zc, block_res[idx], z_resolution,
                                         how_to_process_concat_z, activation_for_concat_z,
                                         device=device)
            depth = (list(attn_depths)[list(attn_block_indices).index(idx)]
                     if idx in list(attn_block_indices) else 0)
            blocks.append(SynthesisBlock(
                idx, in_ch, channels[idx], channels[idx - 1] if idx > 0 else None, w_dim,
                img_channels, idx == 0, num_res_blocks, depth,
                add_additional_convnext=add_additional_convnext, legacy=legacy, dtype=dtype,
                remat=remat, device=device))
        self.blocks = nn.ModuleList(blocks)
        self.z_convs = nn.ModuleDict(zconvs)
        self.num_ws = sum(b.num_ws for b in blocks)

    def forward(self, z: torch.Tensor, ws: torch.Tensor, return_multiscale: bool = False):
        """z (B, zr, zr, z_dim), ws (B, num_ws, w_dim) -> the last block's
        image, fp32; with return_multiscale also the other blocks' images,
        largest first (synthesis.py:686-711)."""
        ws = ws.float()
        x = x_sum = img = None
        multiscale = []
        w_idx = 0
        for idx, block in enumerate(self.blocks):
            if idx in self.concat_z:
                zc = self.z_convs[str(idx)](z)
                x = zc if x is None else torch.cat([x, zc.to(x.dtype)], dim=-1)
            x, x_sum, img = block(x, x_sum, ws[:, w_idx:w_idx + block.num_ws])
            w_idx += block.num_ws
            if idx != len(self.blocks) - 1:
                multiscale.append(img)
        return (img, multiscale[::-1]) if return_multiscale else img


def pooled_z(z: torch.Tensor, resolution: int) -> torch.Tensor:
    """adaptive_avg_pool2d to (r, r), flattened to (B, r*r*C)."""
    return adaptive_avg_pool2d(z, (resolution, resolution)).reshape(z.shape[0], -1)


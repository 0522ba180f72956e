"""Shared building blocks (port of vfm_vae_tpu/models/layers.py).

Parameters keep the reference torch layout and names (Linear (out, in),
Conv2d (O, I/groups, kh, kw)) so a reference state_dict loads directly.
They are stored in fp32; each op casts them to its input's dtype, as the
JAX package does, so the input dtype sets the compute dtype. Activations
are NHWC. Every module here derives from `Module`, whose
`reset_parameters(generator)` draws the module's own parameters with the
JAX package's initializers from an explicit torch.Generator.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bias_act import apply_activation
from ..ops.groupnorm import group_norm, group_stats, layer_norm
from ..ops.quantized import int8_linear, int8_linear_prequant, int8_linear_prequant_static


class Module(nn.Module):
    """nn.Module with an explicit-generator initializer for its own parameters."""

    def reset_parameters(self, g: torch.Generator) -> None:  # noqa: D401 - default: no params
        pass


def init_parameters(module: nn.Module, g: torch.Generator) -> None:
    """Draw every parameter of `module` from `g` (module order, deterministic)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Module):
                m.reset_parameters(g)


def param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


def randn_(p: torch.Tensor, g: torch.Generator, std: float = 1.0) -> None:
    p.copy_(torch.randn(p.shape, generator=g, device=p.device) * std)


def uniform_(p: torch.Tensor, g: torch.Generator, bound: float) -> None:
    p.copy_((torch.rand(p.shape, generator=g, device=p.device) * 2 - 1) * bound)


def trunc_normal_(p: torch.Tensor, g: torch.Generator, std: float = 0.02) -> None:
    """trunc_normal_(std) truncated at +-2 absolute, as the JAX init."""
    p.copy_(torch.nn.init.trunc_normal_(torch.empty_like(p), std=std, a=-2.0, b=2.0, generator=g))


def xavier_normal_(p: torch.Tensor, g: torch.Generator, gain: float) -> None:
    """Torch fan convention: (out, in, kh, kw) -> fan_in = in*kh*kw."""
    rf = int(np.prod(p.shape[2:])) if p.dim() > 2 else 1
    fan_in, fan_out = p.shape[1] * rf, p.shape[0] * rf
    randn_(p, g, gain * math.sqrt(2.0 / (fan_in + fan_out)))


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize semantics (clamped norm)."""
    n2 = x.square().sum(dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(n2, min=eps * eps))


class FullyConnectedLayer(Module):
    """StyleGAN FC layer: the stored weight is pre-divided by lr_multiplier
    and scaled by lr_multiplier / sqrt(in) at use (shared.py:33-105)."""

    def __init__(self, in_features: int, out_features: int,
                 activation: str = "linear", lr_multiplier: float = 1.0,
                 weight_init: float = 1.0, bias_init: Union[float, Sequence[float]] = 0.0,
                 device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight_init = weight_init
        self.bias_init = bias_init
        self.weight = param(out_features, in_features, device=device)
        self.bias = param(out_features, device=device)

    def reset_parameters(self, g):
        randn_(self.weight, g, self.weight_init / self.lr_multiplier)
        b = np.broadcast_to(np.asarray(self.bias_init, np.float32), (self.out_features,))
        self.bias.copy_(torch.from_numpy(b / self.lr_multiplier))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype) * (self.lr_multiplier / math.sqrt(self.in_features))
        y = x @ w.t() + self.bias.to(x.dtype) * self.lr_multiplier
        if self.activation != "linear":
            y = apply_activation(y, self.activation)
        return y


class MLP(Module):
    """Stack of FullyConnectedLayers fc0, fc1, ... (shared.py:108-162)."""

    def __init__(self, features_list: Sequence[int], activation: str = "linear",
                 lr_multiplier: float = 1.0, linear_out: bool = False, device=None):
        super().__init__()
        n = len(features_list) - 1
        for idx in range(n):
            act = "linear" if (linear_out and idx == n - 1) else activation
            self.add_module(f"fc{idx}", FullyConnectedLayer(
                features_list[idx], features_list[idx + 1], activation=act,
                lr_multiplier=lr_multiplier, device=device))
        self.n = n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        for idx in range(self.n):
            x = getattr(self, f"fc{idx}")(x)
        return x.reshape(*shape[:-1], -1)


class StyleSplit(Module):
    """3-way style projection m1*m2 + m3 (shared.py:170-178)."""

    def __init__(self, in_channels: int, out_channels: int, bias_init: float = 0.0, device=None):
        super().__init__()
        self.proj = FullyConnectedLayer(in_channels, 3 * out_channels, bias_init=bias_init,
                                        device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m1, m2, m3 = self.proj(x).chunk(3, dim=-1)
        return m1 * m2 + m3


class GroupNorm32(Module):
    """GroupNorm with fp32 statistics (shared.py:165-167)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.plain = False  # select K5's plain twin on the card (comparisons only)
        self.weight = param(num_channels, device=device)
        self.bias = param(num_channels, device=device)

    def reset_parameters(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.num_groups, self.weight, self.bias, self.eps, plain=self.plain)

    def folded_affine(self, x: torch.Tensor):
        """GN as a per-(sample, channel) fp32 affine: gn(x) = x * a + c."""
        mean, rstd = group_stats(x, self.num_groups, self.eps, plain=self.plain)
        reps = x.shape[-1] // self.num_groups
        a = rstd.repeat_interleave(reps, dim=1) * self.weight[None, :]
        c = self.bias[None, :] - (mean * rstd).repeat_interleave(reps, dim=1) * self.weight[None, :]
        return a, c


class LayerNormFp32(Module):
    """nn.LayerNorm with fp32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = param(dim, device=device)
        self.bias = param(dim, device=device)

    def reset_parameters(self, g):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class ChannelRMSNorm(Module):
    """RMS norm over the channels of an NHWC map; gamma is (dim, 1, 1) as in
    gigagan_utils.py:31-39."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.dim = dim
        self.gamma = param(dim, 1, 1, device=device)

    def reset_parameters(self, g):
        self.gamma.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        normed = l2_normalize(x.float(), dim=-1)
        return (normed * math.sqrt(self.dim) * self.gamma.reshape(-1)).to(x.dtype)


class RMSNorm(Module):
    """RMS norm over the last axis (gigagan_utils.py:42-50)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.dim = dim
        self.gamma = param(dim, device=device)

    def reset_parameters(self, g):
        self.gamma.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        normed = l2_normalize(x.float(), dim=-1)
        return (normed * math.sqrt(self.dim) * self.gamma).to(x.dtype)


class Conv2d(Module):
    """nn.Conv2d on NHWC maps with torch default init (U(+-1/sqrt(fan_in)))
    unless `weight_init` names another: 'zeros', ('trunc_normal', std) or
    ('normal', std)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, groups: int = 1, bias: bool = True,
                 weight_init=None, bias_init=None, stride: int = 1, device=None):
        super().__init__()
        self.padding, self.groups, self.stride = padding, groups, stride
        self.weight_init, self.bias_init = weight_init, bias_init
        self.fan_in = (in_channels // groups) * kernel_size * kernel_size
        self.weight = param(out_channels, in_channels // groups, kernel_size, kernel_size,
                            device=device)
        self.bias = param(out_channels, device=device) if bias else None

    def reset_parameters(self, g):
        bound = 1.0 / math.sqrt(self.fan_in)
        _init(self.weight, g, self.weight_init, bound)
        if self.bias is not None:
            _init(self.bias, g, self.bias_init, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if w.shape[2] == 1 and self.groups == 1 and self.stride == 1:
            y = x @ w[:, :, 0, 0].t()
        else:
            y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.stride, padding=self.padding,
                         groups=self.groups)
            y = y.permute(0, 2, 3, 1).contiguous()
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


# Inside an int8_linear_scope() every Linear runs as a W8A8 int8 matmul
# (ops/quantized.py): the frozen tower at serving time (VFM_VAE_INT8_VFM=1).
# Under int8_calibration_scope() the mirrored Linears also record the absmax
# of their input into the dict the scope yields, and the ConvNeXt layers
# with decoder MLP mirrors record the absmax of their two quantized
# activations (models/convnext.py). Eager and single-threaded, as the JAX
# package's trace-time flags are.
_INT8_SCOPE = [False]
_INT8_CALIB: list = [None]


@contextlib.contextmanager
def int8_linear_scope(enabled: bool = True):
    prev = _INT8_SCOPE[0]
    _INT8_SCOPE[0] = enabled
    try:
        yield
    finally:
        _INT8_SCOPE[0] = prev


def record_amax(key, x: torch.Tensor) -> None:
    """Fold max |x| (fp32) into the calibration dict under `key`: a
    Linear, whose scale is `as`, or (module, scale name)."""
    calib = _INT8_CALIB[0]
    amax = x.detach().abs().amax().float()
    calib[key] = amax if key not in calib else torch.maximum(calib[key], amax)


@contextlib.contextmanager
def int8_calibration_scope(linears: bool = True):
    """int8 scope on (unless `linears` is False: then the Linears keep the
    scope they have), and each mirrored Linear's input absmax (fp32, the max
    over its calls) collected into the yielded dict, keyed by the Linear;
    the ConvNeXt layers' two activation absmaxes under (layer, "as_u") and
    (layer, "as_h")."""
    prev_s, prev_c = _INT8_SCOPE[0], _INT8_CALIB[0]
    amax: Dict[object, torch.Tensor] = {}
    _INT8_SCOPE[0], _INT8_CALIB[0] = True if linears else prev_s, amax
    try:
        yield amax
    finally:
        _INT8_SCOPE[0], _INT8_CALIB[0] = prev_s, prev_c


class Linear(Module):
    """nn.Linear ((out, in) weight); torch default init unless given.

    An int8 mirror (ops/quantized.prequantize_linears) adds the buffers `wq`
    int8 (out, in) and `ws` fp32 (out,), and calibration `as` fp32 (); they
    are None until then. Inside the int8 scope the layer picks its path as
    the JAX Linear does (layers.py:309-341): mirror and calibrating: record
    the absmax, then the dynamic path; mirror with `as`: the static path;
    mirror alone: the dynamic path; no mirror: per-call weight quantization.
    Each of these is K6 on the card (its twin on the CPU, or with `plain`)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 weight_init=None, bias_init=None, device=None):
        super().__init__()
        self.in_features = in_features
        self.weight_init, self.bias_init = weight_init, bias_init
        self.weight = param(out_features, in_features, device=device)
        self.bias = param(out_features, device=device) if bias else None
        for name in ("wq", "ws", "as"):
            self.register_buffer(name, None)
        self.plain = False  # select K6's plain twin on the card (comparisons only)

    def reset_parameters(self, g):
        bound = 1.0 / math.sqrt(self.in_features)
        _init(self.weight, g, self.weight_init, bound)
        if self.bias is not None:
            _init(self.bias, g, self.bias_init, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _INT8_SCOPE[0]:
            return self._int8_forward(x)
        y = x @ self.weight.to(x.dtype).t()
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def _int8_forward(self, x: torch.Tensor) -> torch.Tensor:
        wq, ws, a_s = self._buffers["wq"], self._buffers["ws"], self._buffers["as"]
        if wq is None:
            return int8_linear(x, self.weight, self.bias, plain=self.plain)
        if _INT8_CALIB[0] is not None:
            record_amax(self, x)
        elif a_s is not None:
            return int8_linear_prequant_static(x, wq, ws, a_s, self.bias, plain=self.plain)
        return int8_linear_prequant(x, wq, ws, self.bias, plain=self.plain)


def _init(p: torch.Tensor, g: torch.Generator, how, bound: float) -> None:
    if how is None:
        uniform_(p, g, bound)
    elif how == "zeros":
        p.zero_()
    elif how[0] == "trunc_normal":
        trunc_normal_(p, g, how[1])
    elif how[0] == "normal":
        randn_(p, g, how[1])
    elif how[0] == "xavier_normal":
        xavier_normal_(p, g, how[1])
    else:
        raise ValueError(f"unknown initializer {how!r}")


TRUNC02 = ("trunc_normal", 0.02)


def holder(**modules: Optional[nn.Module]) -> nn.Module:
    """A parameterless container that only fixes state_dict key prefixes."""
    m = nn.Module()
    for name, sub in modules.items():
        m.add_module(name, sub)
    return m

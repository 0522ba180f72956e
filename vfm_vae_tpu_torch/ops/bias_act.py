"""Bias + activation + gain + clamp with the reference's default alpha and
gain per function (port of vfm_vae_tpu/ops/bias_act.py: `activation_funcs`,
`apply_activation` and `bias_act`). An elementwise chain: PyTorch runs it as
it stands, as XLA fuses it in the JAX package; no TPU kernel stands behind
it."""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


class Activation(NamedTuple):
    func: Callable[[torch.Tensor, float], torch.Tensor]
    def_alpha: float
    def_gain: float


# The JAX table (bias_act.py:21-43): torch's GELU default is the erf form.
activation_funcs = {
    "linear": Activation(lambda x, alpha: x, 0.0, 1.0),
    "relu": Activation(lambda x, alpha: F.relu(x), 0.0, math.sqrt(2)),
    "lrelu": Activation(lambda x, alpha: F.leaky_relu(x, alpha), 0.2, math.sqrt(2)),
    "tanh": Activation(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": Activation(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": Activation(lambda x, alpha: F.elu(x), 0.0, 1.0),
    "selu": Activation(lambda x, alpha: F.selu(x), 0.0, 1.0),
    "softplus": Activation(lambda x, alpha: F.softplus(x), 0.0, 1.0),
    "swish": Activation(lambda x, alpha: torch.sigmoid(x) * x, 0.0, math.sqrt(2)),
    "gelu": Activation(lambda x, alpha: F.gelu(x), 0.0, 1.0),
    "gelu_tanh": Activation(lambda x, alpha: F.gelu(x, approximate="tanh"), 0.0, 1.0),
    "silu": Activation(lambda x, alpha: F.silu(x), 0.0, 1.0),
    "quick_gelu": Activation(lambda x, alpha: x * torch.sigmoid(1.702 * x), 0.0, 1.0),
}


def apply_activation(x: torch.Tensor, act: str, alpha: Optional[float] = None) -> torch.Tensor:
    spec = activation_funcs[act]
    return spec.func(x, spec.def_alpha if alpha is None else alpha)


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = -1,
             act: str = "linear", alpha: Optional[float] = None, gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    """Add the bias along `dim` (the channels of an NHWC map by default),
    apply `act` with its default alpha, scale by `gain` (the function's
    default gain when None), clamp to +-clamp, in that order (bias_act.py:51)."""
    spec = activation_funcs[act]
    a = spec.def_alpha if alpha is None else alpha
    g = spec.def_gain if gain is None else gain
    if b is not None:
        shape = [1] * x.dim()
        shape[dim] = b.shape[0]
        x = x + b.to(x.dtype).reshape(shape)
    x = spec.func(x, a)
    if g != 1.0:
        x = x * g
    if clamp is not None:
        if clamp < 0:
            raise ValueError(f"bias_act: clamp {clamp} < 0")
        x = torch.clamp(x, -clamp, clamp)
    return x

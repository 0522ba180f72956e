"""Activation table with the reference's default alpha and gain per function
(port of vfm_vae_tpu/ops/bias_act.py: `activation_funcs` and
`apply_activation`)."""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


class Activation(NamedTuple):
    func: Callable[[torch.Tensor, float], torch.Tensor]
    def_alpha: float
    def_gain: float


# The entries the ported slice uses (mapping MLP, ZConv, ViT MLP).
activation_funcs = {
    "linear": Activation(lambda x, alpha: x, 0.0, 1.0),
    "lrelu": Activation(lambda x, alpha: F.leaky_relu(x, alpha), 0.2, math.sqrt(2)),
    "gelu": Activation(lambda x, alpha: F.gelu(x), 0.0, 1.0),
    "gelu_tanh": Activation(lambda x, alpha: F.gelu(x, approximate="tanh"), 0.0, 1.0),
}


def apply_activation(x: torch.Tensor, act: str, alpha: Optional[float] = None) -> torch.Tensor:
    spec = activation_funcs[act]
    return spec.func(x, spec.def_alpha if alpha is None else alpha)

"""Training statistics as three-moment counters [n, sum(x), sum(x^2)] per
name (port of vfm_vae_tpu/core/stats.py): `report` and `merge` keep them as
detached fp32 tensors on the value's device; the host `Collector` drains
them per tick."""

from __future__ import annotations

import math
import re
from typing import Dict

import numpy as np
import torch

Moments = torch.Tensor  # (3,)


def moments_of(value) -> Moments:
    v = torch.as_tensor(value).detach().float()
    return torch.stack([v.new_tensor(float(v.numel())), v.sum(), v.square().sum()])


def report(stats: Dict[str, Moments], name: str, value) -> None:
    """Accumulate the moments of `value` (any shape) under `name`."""
    m = moments_of(value)
    stats[name] = stats[name] + m if name in stats else m


def merge(a: Dict[str, Moments], b: Dict[str, Moments]) -> Dict[str, Moments]:
    out = dict(a)
    for k, v in b.items():
        out[k] = out[k] + v if k in out else v
    return out


def sync_across_processes(stats: Dict[str, Moments]) -> Dict[str, Moments]:
    """The moments summed over the processes (reference:
    training_stats.py:234 _sync; JAX core/stats.py:104): one all-reduce of
    the stacked [n, sum(x), sum(x^2)] rows. Every process must hold the same
    names. The identity without a process group."""
    from ..parallel.mesh import active

    if not active() or not stats:
        return stats
    import torch.distributed as dist

    names = sorted(stats)
    stacked = torch.stack([torch.as_tensor(stats[n]).detach().double().reshape(3)
                           for n in names])
    dev = torch.device("cpu")
    if dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    stacked = stacked.to(dev)
    dist.all_reduce(stacked)
    stacked = stacked.cpu()
    return {n: stacked[i] for i, n in enumerate(names)}


class Collector:
    """Host-side drain of accumulated moments (reference:
    training_stats.py:113). `update(stats)` ingests a {name: (3,)} dict of
    tensors or arrays; `mean` and `std` cover everything ingested since the
    last `reset`."""

    def __init__(self, regex: str = ".*"):
        self._regex = re.compile(regex)
        self._moments: Dict[str, np.ndarray] = {}
        self._cumulative: Dict[str, np.ndarray] = {}

    def update(self, stats: Dict[str, Moments]) -> None:
        for name, m in stats.items():
            if not self._regex.fullmatch(name):
                continue
            if isinstance(m, torch.Tensor):
                m = m.detach().cpu().double().numpy()
            m = np.asarray(m, np.float64)
            self._moments[name] = self._moments.get(name, np.zeros(3)) + m
            self._cumulative[name] = self._cumulative.get(name, np.zeros(3)) + m

    def names(self):
        return list(self._moments.keys())

    def num(self, name: str) -> int:
        return int(self._moments.get(name, np.zeros(3))[0])

    def mean(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0:
            return float("nan")
        return float(m[1] / m[0])

    def std(self, name: str) -> float:
        m = self._moments.get(name)
        if m is None or m[0] == 0 or not np.isfinite(m[1]):
            return float("nan")
        if m[0] == 1:
            return 0.0
        mean = m[1] / m[0]
        raw_var = m[2] / m[0]
        return float(math.sqrt(max(raw_var - mean * mean, 0.0)))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"num": self.num(name), "mean": self.mean(name), "std": self.std(name)}
            for name in self.names()
        }

    def reset(self) -> None:
        self._moments.clear()


"""Phase timing and memory telemetry (port of vfm_vae_tpu/core/profiling.py;
reference training_loop.py:630-635 CUDA-event phase timing and :753-768
memory telemetry).

`PhaseTimer` records a CUDA event pair around each phase on a card (the
device time of the work queued inside the phase, read at `mean`, so the
host never waits inside a step) and host wall time on the CPU.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch


class PhaseTimer:
    """Per-phase times in seconds: CUDA events on a card, host clock otherwise."""

    def __init__(self, device="cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self._spans: Dict[str, List] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            end.record()
            self._spans.setdefault(name, []).append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._spans.setdefault(name, []).append(time.perf_counter() - t0)

    def times(self, name: str) -> List[float]:
        t = []
        for s in self._spans.get(name, []):
            if isinstance(s, tuple):
                s[1].synchronize()
                s = s[0].elapsed_time(s[1]) / 1e3
            t.append(s)
        return t

    def mean(self, name: str) -> float:
        t = self.times(name)
        return sum(t) / max(len(t), 1)

    def total(self, name: str) -> float:
        return sum(self.times(name))

    def reset(self):
        self._spans.clear()


def device_memory_stats(device=None) -> Dict[str, float]:
    """The card's memory in GiB: allocated now, the peak since the last
    torch.cuda.reset_peak_memory_stats, and the card's total; {} without one."""
    if not torch.cuda.is_available():
        return {}
    device = torch.device(device or "cuda")
    if device.type != "cuda":
        return {}
    scale = 1 / 2**30
    return {
        "Resources/hbm_in_use_gb": torch.cuda.memory_allocated(device) * scale,
        "Resources/hbm_peak_gb": torch.cuda.max_memory_allocated(device) * scale,
        "Resources/hbm_limit_gb": torch.cuda.get_device_properties(device).total_memory * scale,
    }


def host_memory_stats() -> Dict[str, float]:
    try:
        import psutil

        rss = psutil.Process().memory_info().rss
        return {"Resources/cpu_mem_gb": rss / 2**30}
    except ImportError:
        return {}

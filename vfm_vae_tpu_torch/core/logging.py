"""Logging utilities (port of vfm_vae_tpu/core/logging.py; reference
dnnlib/util.py:55 Logger, :139 format_time, torch_utils/distributed.py:75
print0). The process's rank and the world size come from torch.distributed
when it is initialised, else 0 and 1."""

from __future__ import annotations

import sys
from typing import Optional


def _dist():
    try:
        import torch.distributed as dist
    except ImportError:  # pragma: no cover
        return None
    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    d = _dist()
    return d.get_rank() if d is not None else 0


def process_count() -> int:
    d = _dist()
    return d.get_world_size() if d is not None else 1


def print0(*args, **kwargs) -> None:
    """Print only on process 0."""
    if process_index() == 0:
        print(*args, **kwargs)


def format_time(seconds: float) -> str:
    """'1d 02h' style durations (reference: dnnlib/util.py:139)."""
    s = int(round(seconds))
    if s < 60:
        return f"{s}s"
    if s < 3600:
        return f"{s // 60}m {s % 60:02d}s"
    if s < 86400:
        return f"{s // 3600}h {(s // 60) % 60:02d}m"
    return f"{s // 86400}d {(s // 3600) % 24:02d}h"


class Logger:
    """Tee stdout and stderr to a log file (reference: dnnlib/util.py:55)."""

    def __init__(self, file_name: Optional[str] = None, mode: str = "w", should_flush: bool = True):
        self.file = open(file_name, mode) if file_name is not None else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self
        sys.stderr = self

    def write(self, text: str) -> None:
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self) -> None:
        self.flush()
        if sys.stdout is self:
            sys.stdout = self.stdout
        if sys.stderr is self:
            sys.stderr = self.stderr
        if self.file is not None:
            self.file.close()
            self.file = None

    def isatty(self) -> bool:
        return False

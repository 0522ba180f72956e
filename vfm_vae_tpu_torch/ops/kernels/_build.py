"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled with nvcc, one process per source and all at once,
then linked into one shared library with a plain C interface and loaded with
ctypes; nothing includes PyTorch's headers, so a build takes seconds. The
library lands in ``csrc/build/`` (git-ignored), named by a hash of the
sources and flags, and is built at first use.
Nothing is compiled or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("fused_mlp.cu", "fused_upsample.cu", "flash_attention_nullkv.cu",
           "flash_attention_nullkv_bwd.cu", "int8_matmul.cu", "group_stats.cu", "dwconv_stats.cu")
HEADERS = ("common.cuh", "partials.cuh", "hopper.cuh", "flash.cuh", "tf32x3.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "vfm_fused_convnext_mlp": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "vfm_fused_convnext_mlp_pipelined": [_P] * 10 + [_I, _I, _I, _P],
    "vfm_fused_mlp_plan": [_I, _I, _I, _I, _I, _P],
    "vfm_fused_upsample_blur": [_P] * 6 + [_I, _P, _I, _I, _I, _I, _I, _P],
    "vfm_fused_upsample_plan": [_I] * 7 + [_P],
    "vfm_flash_attention_nullkv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "vfm_flash_attention_nullkv_bwd": [_P] * 15 + [_I, _I, _I, _I, _F, _P],
    "vfm_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    "vfm_flash_fwd_plan": [_I, _I, _I, _I, _I, _P],
    "vfm_flash_fwd_f32_plan": [_I, _I, _I, _I, _I, _P],
    "vfm_flash_attention_bwd": [_P] * 10 + [_I, _I, _I, _I, _I, _F, _I, _P],
    "vfm_flash_bwd_plan": [_I, _I, _I, _I, _I, _I, _P],
    "vfm_flash_bwd_f32_plan": [_I, _I, _I, _I, _I, _I, _P],
    "vfm_int8_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vfm_int8_matmul_plan": [_I, _I, _I, _I, _I, _P],
    "vfm_channel_moments": [_P] * 4 + [_I] * 5 + [_P],
    "vfm_dwconv_tiles": [_I, _I],
    "vfm_dwconv_noise_stats": [_P] * 8 + [_I, _I, _I, _I, _I, _P],
    "vfm_depthwise_conv2d_same": [_P] * 4 + [_I, _I, _I, _I, _I, _P],
}


class KernelLibrary:
    """The loaded library plus what its build printed and how long it took."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.log = log

    def check(self, err: int, name: str) -> None:
        if err != 0:
            msg = self.lib.vfm_error_string(err).decode()
            raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


_lock = threading.Lock()
_loaded: Optional[KernelLibrary] = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{s}:\n{log}" for s, p, log in zip(SOURCES, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = os.path.join(tmpdir, "lib.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
        os.replace(tmp, out)  # atomic: a half-written library is never loaded
    return "".join(logs) + link.stdout + link.stderr


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would record through a raw kernel launch: the
    kernel's output has no grad_fn, so its inputs would get no gradient. The
    launch belongs inside its torch.autograd.Function."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: raw kernel launch on tensors that require grad; "
                           "call it through its autograd.Function")


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of this dtype and shape on `device`."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_all(name: str, dtype, dev, specs) -> None:
    """One pass over (tensor, label, shape): raise ValueError unless each is
    a contiguous tensor of `dtype` and `shape` on the CUDA device `dev`."""
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    for t, label, shape in specs:
        if t.device != dev or t.dtype != dtype or t.shape != shape or not t.is_contiguous():
            check_tensor(t, label, dtype, shape, dev)  # raises with the reason


def call_on(dev, fn, *args) -> int:
    """fn(*args, stream) with `dev`'s current raw stream; switches the
    current device only when `dev` is not it already."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))


def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _loaded
    if _loaded is not None:  # the launch path's common case: no lock
        return _loaded
    with _lock:
        if _loaded is None:
            path = BUILD_DIR / f"libvfm_kernels_{_digest()}.so"
            t0 = time.perf_counter()
            log = "" if path.exists() else _build(path)
            seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vfm_error_string.argtypes = [ctypes.c_int]
            lib.vfm_error_string.restype = ctypes.c_char_p
            _loaded = KernelLibrary(lib, path, seconds, log)
        return _loaded

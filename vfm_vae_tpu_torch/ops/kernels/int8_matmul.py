"""K6: fused int8 quantize -> int8 GEMM (int32 accumulation) -> rescale +
bias, for the frozen SigLIP tower's Linears at serving time; K10: the bare
int8 x int8 -> int32 GEMM with `>> 8` narrowing, K6's ceiling probe.

K6 replaces the TPU kernel vfm_vae_tpu/ops/pallas/int8_matmul.py:
_int8_matmul_2d (per-row dynamic absmax scale, the path of
vfm_vae_tpu/ops/quantized.py:int8_linear_prequant) and runs the static
per-tensor scale of quantized.py:int8_linear_prequant_static as a second
mode: that one is an XLA int8 dot in the JAX package, and PyTorch has no
int8 matmul on the card to stand in for it. K10 replaces the Pallas kernel
`raw_int8` of tools/bench_int8_kernel.py. All three are modes of one CUDA
kernel (csrc/int8_matmul.cu), bound by its int8 tensor-core products; it
quantizes each row tile once into shared memory and streams the weight.

The plain twin `int8_matmul_reference` repeats the JAX formulas step by step:
true divisions, half-to-even rounding, the products in the JAX order, the
int32 sum computed exactly in float64 (|sum| <= K * 127^2 < 2^53). The
kernel performs the same operations in the same order, so the two agree bit
for bit.

Weights are int8 (N, K), K contiguous: the transpose of the JAX package's
(K, N). No backward: the tower is frozen; inputs that require grad are
refused.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import check_tensor, library, refuse_grad

MODES = {"dynamic": 0, "static": 1, "raw": 2}


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    """A tensor operand: torch divides by a Python scalar through its
    reciprocal on the card, which is not the JAX package's true division."""
    return torch.full_like(like, value)


def quantize_activations(x: torch.Tensor, mode: str, a_s: Optional[torch.Tensor] = None):
    """(xq, s): x (..., K) quantized to integer-valued fp32 and its scale.
    dynamic: s = max(max|x_row| / 127, 1e-8) per row, xq = round(x / s)
    (quantized.py:96-98); static: xq = clip(round(x * (1 / max(as, 1e-8))),
    -127, 127) and s = as (quantized.py:124-127)."""
    xf = x.float()
    if mode == "dynamic":
        amax = xf.abs().amax(dim=-1, keepdim=True)
        s = torch.clamp_min(amax / _full(amax, 127.0), 1e-8)
        return torch.round(xf / s), s
    if mode == "static":
        a_s = a_s.float()
        inv = _full(a_s, 1.0) / torch.clamp_min(a_s, 1e-8)
        return torch.clamp(torch.round(xf * inv), -127.0, 127.0), a_s
    raise ValueError(f"quantize_activations: mode {mode!r}")


def _int_sum(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int32 sum xq @ wq^T as float64 (exact for K <= 2^53 / 127^2)."""
    return xq.double() @ wq.double().t()


def int8_matmul_reference(x, wq, ws, b, mode: str, a_s=None):
    """Plain twin of all three modes. dynamic and static: y = (acc * s) * ws
    + b, respectively y = acc * (as * ws) + b, in fp32, cast to x's dtype;
    raw: int8(acc >> 8) with two's-complement wrap (x is then int8, ws and b
    unused)."""
    if mode == "raw":
        acc = _int_sum(x, wq).to(torch.int64)
        return (acc >> 8).to(torch.int8)
    xq, s = quantize_activations(x, mode, a_s)
    acc = _int_sum(xq, wq).float()
    y = acc * s * ws.float() if mode == "dynamic" else acc * (s * ws.float())
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _launch(x2, wq, ws, b, a_s, mode: str):
    """x2 (M, K) -> (M, N); every input checked against what the kernel takes."""
    M, K = x2.shape
    N = wq.shape[0]
    dev = x2.device
    if K % 32 or N % 8 or M == 0:
        raise ValueError(f"int8_matmul: M={M}, K={K}, N={N}; the kernel needs M > 0, "
                         "K a multiple of 32 and N a multiple of 8")
    raw = mode == "raw"
    check_tensor(x2, "x", torch.int8 if raw else torch.bfloat16, (M, K), dev)
    check_tensor(wq, "wq", torch.int8, (N, K), dev)
    if not raw:
        check_tensor(ws, "ws", torch.float32, (N,), dev)
        if b is not None:
            check_tensor(b, "b", torch.float32, (N,), dev)
    if mode == "static":
        check_tensor(a_s, "a_s", torch.float32, (), dev)
    lib = library()
    out = torch.empty((M, N), dtype=torch.int8 if raw else torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lib.vfm_int8_matmul(
            x2.data_ptr(), wq.data_ptr(), None if raw else ws.data_ptr(),
            None if raw or b is None else b.data_ptr(),
            a_s.data_ptr() if mode == "static" else None, out.data_ptr(), M, N, K, MODES[mode],
            stream)
    lib.check(err, "int8_matmul")
    return out


def int8_matmul(x, wq, ws, b=None, a_s=None, *, plain: bool = False):
    """y = x @ (wq * ws)^T + b with x quantized per row (a_s None: dynamic,
    K6) or with the calibrated scale a_s (static). x (..., K) float; wq
    (N, K) int8; ws (N,) and b (N,) fp32; a_s () fp32. CPU tensors (or
    plain=True) run the twin; CUDA tensors launch the kernel: bf16 x,
    contiguous, K a multiple of 32, N of 8."""
    mode = "dynamic" if a_s is None else "static"
    if plain or x.device.type == "cpu":
        return int8_matmul_reference(x, wq, ws, b, mode, a_s)
    refuse_grad("int8_matmul", x, wq, ws, *(t for t in (b, a_s) if t is not None))
    lead, K = x.shape[:-1], x.shape[-1]
    y = _launch(x.reshape(-1, K), wq, ws, b, a_s, mode)
    int8_matmul.launches += 1
    return y.reshape(*lead, wq.shape[0])


def int8_matmul_raw(xq, wq, *, plain: bool = False):
    """K10: int8 (M, K) x int8 (N, K)^T -> int32 -> `>> 8` -> int8 (M, N),
    no quantize and no epilogue. CPU tensors (or plain=True) run the twin."""
    if plain or xq.device.type == "cpu":
        return int8_matmul_reference(xq, wq, None, None, "raw")
    y = _launch(xq, wq, None, None, None, "raw")
    int8_matmul_raw.launches += 1
    return y


int8_matmul.launches = 0
int8_matmul_raw.launches = 0

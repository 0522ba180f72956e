"""K6: fused int8 quantize -> int8 GEMM (int32 accumulation) -> rescale +
bias, for the frozen tower's Linears at serving time (every family; a K off
32, such as EVA-02's 2730 and Qwen2.5-VL's 3420, through a quantize
pre-pass into int8 rows of a multiple of 32, an N off 8 through rows of a
multiple of 8 that TMA stores) and for the decoder's static-int8 ConvNeXt
MLP (the "gelu" mode, `int8_matmul_gelu`: a pre-pass quantizes x times the
per-image GroupNorm and style fold, the epilogue applies a per-image scale
and bias with rows grouped by image, then the erf GELU, into bf16; the
"residual" mode, `int8_matmul_residual`: the MLP's second product, K6's
static mode with the layer scale and the residual added in fp32 before
the one rounding to bf16); K10: the bare
int8 x int8 -> int32 GEMM with `>> 8` narrowing, K6's ceiling probe.

K6 replaces the TPU kernel vfm_vae_tpu/ops/pallas/int8_matmul.py:
_int8_matmul_2d (per-row dynamic absmax scale, the path of
vfm_vae_tpu/ops/quantized.py:int8_linear_prequant) and runs the static
per-tensor scale of quantized.py:int8_linear_prequant_static as a second
mode: that one is an XLA int8 dot in the JAX package, and PyTorch has no
int8 matmul on the card to stand in for it. K10 replaces the Pallas kernel
`raw_int8` of tools/bench_int8_kernel.py. All three are modes of one
persistent wgmma s8 GEMM (csrc/int8_matmul.cu): TMA fills a ring of x and
weight stages, two consumer warpgroups multiply (K6 quantizes its bf16 x
stages in registers on the way), the epilogue stores by TMA. `plan` mirrors
the kernel's launch plan.

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

from ._build import call_on, check_all, library, refuse_grad

MODES = {"dynamic": 0, "static": 1, "raw": 2, "gelu": 5, "residual": 6}
SQRT1_2 = 0.7071067811865476


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


def quantize_scaled(x: torch.Tensor, A: torch.Tensor, s: torch.Tensor, hw: int) -> torch.Tensor:
    """The gelu mode's pre-pass: x (M, K) with rows grouped by image (row //
    hw), A (images, K) fp32, s () fp32 -> the integer-valued fp32 codes
    clip(round((x * A[img]) * (1 / max(s, 1e-8))), -127, 127): the product
    in fp32 first (vfm_vae_tpu/models/convnext.py:186-188)."""
    u = x.float() * A.float().repeat_interleave(hw, dim=0)
    return quantize_activations(u, "static", s)[0]


def gelu_erf(v: torch.Tensor) -> torch.Tensor:
    """The exact GELU in the kernel's order: (v * 0.5) * (1 + erf(v * sqrt(1/2)))."""
    return (v * _full(v, 0.5)) * (_full(v, 1.0) + torch.erf(v * _full(v, SQRT1_2)))


def int8_matmul_gelu_reference(x, A, wq, e, b, s):
    """Plain twin of the gelu mode: x (B, H, W, K) float, A (B, K), wq (N, K)
    int8, e and b (B, N), s () -> (h (B, H, W, N) bf16, the codes (B, H, W,
    K) int8): h = gelu_erf(acc * e[img] + b[img]) (convnext.py:195-199)."""
    B, H, W, K = x.shape
    hw = H * W
    uq = quantize_scaled(x.reshape(-1, K), A, s, hw)
    acc = _int_sum(uq, wq).float()
    v = acc * e.float().repeat_interleave(hw, dim=0) + b.float().repeat_interleave(hw, dim=0)
    h = gelu_erf(v).to(torch.bfloat16)
    return h.reshape(B, H, W, -1), uq.to(torch.int8).reshape(B, H, W, K)


def int8_matmul_residual_reference(x, wq, ws, b, a_s, g, x_in):
    """Plain twin of the residual mode: x_in + ((acc * (as * ws)) + b) * g
    in fp32 (convnext.py:207-211), in x_in's dtype."""
    xq, s = quantize_activations(x, "static", a_s)
    y = _int_sum(xq.reshape(-1, x.shape[-1]), wq).float() * (s * ws.float()) + b.float()
    y = y.reshape(*x_in.shape) * g.float()
    return (x_in.float() + y).to(x_in.dtype)


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


# The GEMM's tile rows, K values per ring stage, consumer warpgroups,
# threads, shared-memory budget, epilogue buffers (two chunks of 64 rows x
# 128 bytes per consumer warpgroup) and alignment slack, as in
# csrc/int8_matmul.cu.
TILE_M = 128
STAGE_K = 128
CONSUMERS = 2
THREADS = 128 * (CONSUMERS + 1)
SMEM_MAX = 232448
EPILOGUE_BYTES = CONSUMERS * 2 * 64 * 128
SLACK = 1024


def padded_k(K: int) -> int:
    """The K of K6's GEMM for an x of K columns: the next multiple of 32."""
    return -(-K // 32) * 32


def pad_weight(wq: torch.Tensor) -> torch.Tensor:
    """wq (N, K) int8 -> (N, padded_k(K)) with zero columns past K, made once
    per weight tensor (kept on the tensor with its version) and returned as
    it is where K is already a multiple of 32."""
    K = wq.shape[1]
    if K % 32 == 0:
        return wq
    cached = getattr(wq, "_k6_padded", None)
    if cached is None or cached[0] != wq._version:
        wp = torch.zeros((wq.shape[0], padded_k(K)), dtype=wq.dtype, device=wq.device)
        wp[:, :K] = wq
        cached = wq._k6_padded = (wq._version, wp)
    return cached[1]


def plan(M: int, N: int, K: int, mode: str, sms: int = 132) -> dict:
    """The launch plan for x (M, K) and wq (N, K) in `mode` on a card with
    `sms` SMs, as the C side computes it (vfm_int8_matmul_plan): tiles of 128
    rows x 256 columns, or x 128 where 128 x 256 tiles would fill fewer than
    half the SMs; a ring of K stages of 128 values (x int8 for raw, bf16
    otherwise, plus the weight tile) as deep as shared memory allows beside
    the epilogue buffers; min(tiles, SMs) persistent CTAs; the epilogue
    stores by TMA unless raw int8 rows of N bytes are not 16-byte aligned
    (bf16 rows of an N off 8 are stored into rows of a multiple of 8);
    dynamic mode runs the row-scale pre-pass first; K6 at a K off 32, and
    the gelu mode at every K, run the quantize pre-pass instead (`pad`: x
    into int8 of padded_k(K) columns) and read int8 stages. K10 takes
    K % 32 == 0 and N % 8 == 0 only, as does the residual mode (static's
    plan)."""
    raw = mode == "raw"
    if (M <= 0 or N <= 0 or K <= 0 or mode not in MODES
            or (mode in ("raw", "residual") and (K % 32 or N % 8))):
        raise ValueError(f"int8_matmul plan: M={M}, K={K}, N={N}, mode={mode!r}")
    pad = mode == "gelu" or (not raw and K % 32 != 0)
    m_tiles = -(-M // TILE_M)
    bn = 256 if 2 * m_tiles * -(-N // 256) >= sms else 128
    stage = TILE_M * STAGE_K * (1 if raw or pad else 2) + bn * STAGE_K
    stages = (SMEM_MAX - EPILOGUE_BYTES - SLACK) // (stage + 16)
    tiles = m_tiles * -(-N // bn)
    return dict(tile_m=TILE_M, tile_n=bn, stage_k=STAGE_K, stages=stages, consumers=CONSUMERS,
                ctas=min(tiles, sms), threads=THREADS,
                smem_bytes=stages * (stage + 16) + EPILOGUE_BYTES + SLACK,
                direct_store=raw and N % 16 != 0, prepass=mode == "dynamic" or pad,
                tiles=tiles, pad=pad)


PLAN_KEYS = ("tile_m", "tile_n", "stage_k", "stages", "consumers", "ctas", "threads",
             "smem_bytes", "direct_store", "prepass", "tiles", "pad")


def _launch(x2, wq, ws, b, a_s, mode: str):
    """x2 (M, K) -> (M, N) in one library call (the pre-passes and the GEMM);
    every input checked against what the kernel takes."""
    M, K = x2.shape
    N = wq.shape[0]
    dev = x2.device
    raw = mode == "raw"
    if M == 0 or (raw and (K % 32 or N % 8)):
        raise ValueError(f"int8_matmul: M={M}, K={K}, N={N}; the kernel needs M > 0 (K10: "
                         "K a multiple of 32 and N a multiple of 8)")
    check_all("int8_matmul", torch.int8 if raw else torch.bfloat16, dev, [(x2, "x", (M, K))])
    check_all("int8_matmul", torch.int8, dev, [(wq, "wq", (N, K))])
    if not raw:
        check_all("int8_matmul", torch.float32, dev,
                  [(ws, "ws", (N,))] + ([] if b is None else [(b, "b", (N,))])
                  + ([(a_s, "a_s", ())] if mode == "static" else []))
    pad = not raw and K % 32 != 0
    if (not pad and x2.data_ptr() % 16) or wq.data_ptr() % 16:  # TMA reads them
        raise ValueError("int8_matmul: x and wq must be 16-byte aligned")
    lib = library()
    if mode == "dynamic":  # the pre-pass writes the row scales here
        a_s = torch.empty((M,), dtype=torch.float32, device=dev)
    args = (None if raw else ws.data_ptr(), None if raw or b is None else b.data_ptr(),
            None if raw else a_s.data_ptr())
    if raw or not (pad or N % 8):
        out = torch.empty((M, N), dtype=torch.int8 if raw else torch.bfloat16, device=dev)
        err = call_on(dev, lib.lib.vfm_int8_matmul, x2.data_ptr(), wq.data_ptr(), *args,
                      out.data_ptr(), M, N, K, MODES[mode])
    else:  # a K off 32 (x quantized into int8 of K' columns) or an N off 8
        ldo = -(-N // 8) * 8  # TMA stores rows of a multiple of 16 bytes
        buf = torch.empty((M, ldo), dtype=torch.bfloat16, device=dev)
        xq = torch.empty((M, padded_k(K)), dtype=torch.int8, device=dev) if pad else None
        err = call_on(dev, lib.lib.vfm_int8_matmul_tails, x2.data_ptr(),
                      None if xq is None else xq.data_ptr(), pad_weight(wq).data_ptr(), *args,
                      buf.data_ptr(), M, N, K, ldo, MODES[mode])
        out = buf[:, :N]
    lib.check(err, "int8_matmul")
    return out


def int8_matmul(x, wq, ws, b=None, a_s=None, *, plain: bool = False):
    """y = x @ (wq * ws)^T + b with x quantized per row (a_s None: dynamic,
    K6) or with the calibrated scale a_s (static). x (..., K) float; wq
    (N, K) int8; ws (N,) and b (N,) fp32; a_s () fp32. CPU tensors (or
    plain=True) run the twin; CUDA tensors launch the kernel: bf16 x,
    contiguous (16-byte aligned where K is a multiple of 32), any K and N.
    At an N off 8 the result is the first N columns of rows of a multiple
    of 8 (a view whose rows are not contiguous)."""
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


def int8_matmul_gelu(x, A, wq, e, b, s, *, plain: bool = False, return_codes: bool = False):
    """The expand product of the decoder's static-int8 ConvNeXt MLP (K6's
    gelu mode): h = gelu_erf(acc * e[img] + b[img]) in bf16, where acc =
    q(x * A[img]) @ wq^T in int32 and q quantizes with the static scale s.
    x (B, H, W, K) (bf16 on the card, contiguous), A (B, K) fp32, wq (N, K)
    int8 (N a multiple of 8), e and b (B, N) fp32, s () fp32 -> (B, H, W, N)
    bf16; with return_codes also the int8 codes (B, H, W, K) of the
    pre-pass. CPU tensors (or plain=True) run the twin; CUDA tensors launch
    the pre-pass and the GEMM in one library call, or raise."""
    if plain or x.device.type == "cpu":
        h, uq = int8_matmul_gelu_reference(x, A, wq, e, b, s)
        return (h, uq) if return_codes else h
    refuse_grad("int8_matmul_gelu", x, A, e, b, s)
    B, H, W, K = x.shape
    M, N, dev = B * H * W, wq.shape[0], x.device
    if N % 8:
        raise ValueError(f"int8_matmul_gelu: N={N} is not a multiple of 8")
    check_all("int8_matmul_gelu", torch.bfloat16, dev, [(x, "x", (B, H, W, K))])
    check_all("int8_matmul_gelu", torch.int8, dev, [(wq, "wq", (N, K))])
    check_all("int8_matmul_gelu", torch.float32, dev,
              [(A, "A", (B, K)), (e, "e", (B, N)), (b, "b", (B, N)), (s, "s", ())])
    wp = pad_weight(wq)
    if wp.data_ptr() % 16:
        raise ValueError("int8_matmul_gelu: wq must be 16-byte aligned")
    xq = torch.empty((B, H, W, padded_k(K)), dtype=torch.int8, device=dev)
    out = torch.empty((B, H, W, N), dtype=torch.bfloat16, device=dev)
    lib = library()
    err = call_on(dev, lib.lib.vfm_int8_matmul_gelu, x.data_ptr(), A.data_ptr(), xq.data_ptr(),
                  wp.data_ptr(), e.data_ptr(), b.data_ptr(), s.data_ptr(), out.data_ptr(),
                  M, N, K, H * W)
    lib.check(err, "int8_matmul_gelu")
    int8_matmul_gelu.launches += 1
    return (out, xq[..., :K]) if return_codes else out


def int8_matmul_residual(x, wq, ws, b, a_s, g, x_in, *, plain: bool = False):
    """The contract product of the decoder's static-int8 ConvNeXt MLP (K6's
    residual mode): x_in + ((q(x) @ wq^T) * (a_s * ws) + b) * g, x quantized
    with the static scale a_s as K6 static does. x (..., K) (bf16 on the
    card), wq (N, K) int8, ws, b, g (N,) and a_s () fp32, x_in (..., N) ->
    x_in's shape and dtype. CPU tensors (or plain=True) run the twin; CUDA
    tensors launch the kernel (K % 32 == 0, N % 8 == 0, all contiguous), or
    raise."""
    if plain or x.device.type == "cpu":
        return int8_matmul_residual_reference(x, wq, ws, b, a_s, g, x_in)
    refuse_grad("int8_matmul_residual", x, ws, b, a_s, g, x_in)
    K, N, dev = x.shape[-1], wq.shape[0], x.device
    M = x.numel() // K
    if K % 32 or N % 8:
        raise ValueError(f"int8_matmul_residual: K={K}, N={N}; the kernel needs K a multiple "
                         "of 32 and N a multiple of 8")
    check_all("int8_matmul_residual", torch.bfloat16, dev,
              [(x, "x", x.shape), (x_in, "x_in", (*x.shape[:-1], N))])
    check_all("int8_matmul_residual", torch.int8, dev, [(wq, "wq", (N, K))])
    check_all("int8_matmul_residual", torch.float32, dev,
              [(ws, "ws", (N,)), (b, "b", (N,)), (g, "g", (N,)), (a_s, "a_s", ())])
    if x.data_ptr() % 16 or wq.data_ptr() % 16 or x_in.data_ptr() % 4:
        raise ValueError("int8_matmul_residual: x and wq must be 16-byte aligned")
    out = torch.empty_like(x_in)
    lib = library()
    err = call_on(dev, lib.lib.vfm_int8_matmul_residual, x.data_ptr(), wq.data_ptr(),
                  ws.data_ptr(), b.data_ptr(), a_s.data_ptr(), g.data_ptr(), x_in.data_ptr(),
                  out.data_ptr(), M, N, K)
    lib.check(err, "int8_matmul_residual")
    int8_matmul_residual.launches += 1
    return out


int8_matmul.launches = 0
int8_matmul_raw.launches = 0
int8_matmul_gelu.launches = 0
int8_matmul_residual.launches = 0

"""K1: fused ConvNeXt MLP (modulated pw-expand -> exact GELU -> pw-contract
-> layer scale -> residual) without writing the 4C hidden.

Replaces the TPU kernel vfm_vae_tpu/ops/pallas/fused_mlp.py:_fused (body
`_kernel`); the plain twin below follows that file's `_forward_jnp`.

On the H100 the kernel (csrc/fused_mlp.cu) is bound by its two chained
tensor-core GEMMs (~2C flops per byte of activation traffic once the hidden
stays on chip) and, at C = 128, nearly as much by the GELU on the CUDA
cores, which it evaluates in the TPU kernel's tanh form with refit
coefficients (`gelu_poly`, within 3.4e-6 of the exact GELU; the twin keeps
exact erf). Its design: CTAs of a producer warp and two consumer
warpgroups on 64-token tiles of one sample (two tiles a CTA at C <= 256,
one at C = 512 with the output columns split); x arrives once by TMA and
is scaled by A in place; W1 and W2 stream through a TMA ring of 64 x 64
sub-tiles; wgmma
GEMM1 -> demodulate, bias, GELU in registers -> bf16 -> wgmma GEMM2 (the
hidden as a register operand, or through shared memory at C = 512), the
output accumulator in registers across the walk over the hidden. Where the
token tiles leave SMs idle the hidden is split across a cluster of up to 8
CTAs whose fp32 partials are summed in rank order through distributed
shared memory (bit-identical on repeat). `plan` mirrors the launch plan.

Weights use the torch Linear layout: w1 (4C, C), w2 (C, 4C).

Gradients: `FusedConvNeXtMLP` is the port of the JAX custom VJP `_fused_op`
(vfm_vae_tpu/ops/pallas/fused_mlp.py:298-379). Its forward is the kernel on
the card and the twin on the CPU; its backward is a line-by-line port of
`_fused_bwd`, which is plain XLA in the JAX package and plain PyTorch here:
it recomputes the hidden chain (stored in bf16 unless VFM_VAE_MLP_BWD_BF16
is "0", the JAX rule) and returns gradients for all nine inputs.

K9 (`fused_convnext_mlp_pipelined`) replaces the TPU kernel
vfm_vae_tpu/ops/pallas/fused_mlp.py:_fused_pipelined, K1 software-pipelined
and bit-exact with it. It is the same kernel with one change in issue
order: chunk j's GEMM1 is committed with chunk j-1's GEMM2 and chunk j's
GELU runs while that GEMM2 is in flight (the plan, the split and every
accumulator's sequence of products are K1's). Under
VFM_VAE_MLP_PIPELINE=1, read per call as the JAX package reads it
(fused_mlp.py:302-307), every forward launch on the card is K9 instead of
K1; the twin and the backward are K1's.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from ._build import call_on, check_all, library, refuse_grad


def fused_convnext_mlp_reference(x, x_in, A, d, w1, b1, w2, b2, gamma):
    """Plain PyTorch twin: bf16(x*A) @ W1^T (fp32 accumulation) * d + b1 ->
    exact GELU -> bf16 -> @ W2^T (fp32 accumulation) -> (+b2)*gamma + x_in."""
    dt = x.dtype
    B, H, W, C = x.shape
    xs = (x.float() * A[:, None, None, :].float()).to(dt).reshape(B, H * W, C)
    h = xs.float() @ w1.to(dt).float().t()
    h = h * d[:, None, :].float() + b1[:, None, :].float()
    a = F.gelu(h).to(dt)
    y = a.float() @ w2.to(dt).float().t()
    y = (y + b2.float()) * gamma.float()
    return (y + x_in.float().reshape(B, H * W, C)).to(dt).reshape(B, H, W, C)


# The kernel's GELU (csrc/fused_mlp.cu:gelu_poly): GELU(h) = h / (1 + 2^(-2 u
# log2 e)), u = hc p(hc^2), hc = clip(h, -6, 6), with these coefficients of p
# (highest degree first), refit from the TPU kernel's _gelu_poly
# (vfm_vae_tpu/ops/pallas/fused_mlp.py:95-113) to 3.4e-6 of the exact GELU in
# fp32 (tests/test_torch_mlp_plan.py). The twin keeps the exact GELU.
GELU_POLY = (1.1126417260746574e-06, -3.046736235069902e-05, -1.2547544078316894e-04,
             0.036469929776638176, 0.7978275766980556)


def gelu_poly(h: torch.Tensor) -> torch.Tensor:
    """The kernel's GELU in fp32 torch operations (exp2 and a true division
    where the kernel has ex2.approx and __fdividef, both within 2 ulp)."""
    h = h.float()
    hc = h.clamp(-6.0, 6.0)
    s = hc * hc
    p = torch.full_like(s, GELU_POLY[0])
    for c in GELU_POLY[1:]:
        p = p * s + c
    return h / (1.0 + torch.exp2(hc * p * -2.8853900817779268))


# The kernel's constants (csrc/fused_mlp.cu): one 64 x 64 bf16 sub-tile of
# the weight ring, threads and consumer warpgroups a CTA, the shared-memory
# budget, the alignment slack and the largest cluster (the split).
SUB_TILE = 64 * 128
THREADS = 384
CONSUMERS = 2
SMEM_MAX = 232448
SLACK = 1024
MAX_SPLIT = 8
PLAN_KEYS = ("rows", "tiles", "split", "chunks", "ctas", "stages", "smem_bytes", "threads",
             "consumers")


def plan(B: int, HW: int, C: int, pipelined: bool = False, sms: int = 132) -> dict:
    """The launch plan of K1 and K9 (the same for both, so that K9 stays
    bit-exact with K1) for x (B, HW, C) on a card with `sms` SMs, as the C
    side computes it (vfm_fused_mlp_plan): token tiles of `rows` tokens of
    one sample (128 at C <= 256, 64 at C = 512); the 4C hidden in C / 16
    chunks of 64 columns, split `split` ways (a power of two <= 8, doubled
    while 2 x tiles x split <= sms) over a cluster of CTAs, each walking
    `chunks` consecutive chunks; a ring of 8 KB weight sub-tiles as deep as
    shared memory allows beside the resident x (and, at C = 512, two hidden
    buffers)."""
    if C not in (128, 256, 512) or B <= 0 or HW <= 0:
        raise ValueError(f"fused_convnext_mlp plan: B={B}, HW={HW}, C={C}")
    del pipelined  # K9 runs K1's plan
    rows = 64 if C == 512 else 128
    tiles = B * -(-HW // rows)
    nch = C // 16
    split = 1
    while split * 2 <= MAX_SPLIT and split * 2 <= nch and 2 * tiles * split <= sms:
        split *= 2
    fixed = rows // 64 * (C // 64) * SUB_TILE + (2 * SUB_TILE if C == 512 else 0) + SLACK + 8
    stages = (SMEM_MAX - fixed) // (SUB_TILE + 16)
    return dict(rows=rows, tiles=tiles, split=split, chunks=nch // split, ctas=tiles * split,
                stages=stages, smem_bytes=fixed + stages * (SUB_TILE + 16), threads=THREADS,
                consumers=CONSUMERS)


def cta_work(p: dict, HW: int, cta: int):
    """(sample, first token, end token, first hidden column, end hidden
    column) of CTA `cta` under plan `p`: CTA c takes token tile c // split
    (tiles of one sample in order, then the next sample) and hidden chunks
    [r chunks, (r + 1) chunks) for its rank r = c % split; tokens past HW
    are zero-filled and never stored."""
    tile, rank = divmod(cta, p["split"])
    b, t = divmod(tile, -(-HW // p["rows"]))
    tok0, h0 = t * p["rows"], rank * p["chunks"] * 64
    return b, tok0, min(tok0 + p["rows"], HW), h0, h0 + p["chunks"] * 64


def pipeline_enabled() -> bool:
    """VFM_VAE_MLP_PIPELINE=1 selects K9 (the JAX rule, fused_mlp.py:302-307)."""
    return os.environ.get("VFM_VAE_MLP_PIPELINE") == "1"


def _launch(x, x_in, A, d, w1, b1, w2, b2, gamma, pipelined: bool = False):
    name = "fused_convnext_mlp_pipelined" if pipelined else "fused_convnext_mlp"
    refuse_grad(name, x, x_in, A, d, w1, b1, w2, b2, gamma)
    B, H, W, C = x.shape
    if C not in (128, 256, 512):
        raise ValueError(f"{name}: C={C} not in (128, 256, 512)")
    dev = x.device
    check_all(name, torch.bfloat16, dev, [(x, "x", (B, H, W, C)), (x_in, "x_in", (B, H, W, C)),
                                          (w1, "w1", (4 * C, C)), (w2, "w2", (C, 4 * C))])
    check_all(name, torch.float32, dev, [(A, "A", (B, C)), (d, "d", (B, 4 * C)),
                                         (b1, "b1", (B, 4 * C)), (b2, "b2", (C,)),
                                         (gamma, "gamma", (C,))])
    lib = library()
    out = torch.empty_like(x)
    err = call_on(dev, getattr(lib.lib, "vfm_" + name), x.data_ptr(), x_in.data_ptr(),
                  A.data_ptr(), d.data_ptr(), b1.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                  b2.data_ptr(), gamma.data_ptr(), out.data_ptr(), B, H * W, C)
    lib.check(err, name)
    (fused_convnext_mlp_pipelined if pipelined else fused_convnext_mlp).launches += 1
    return out


def _forward(x, x_in, A, d, w1, b1, w2, b2, gamma, plain: bool):
    if plain or x.device.type == "cpu":
        return fused_convnext_mlp_reference(x, x_in, A, d, w1, b1, w2, b2, gamma)
    return _launch(x, x_in, A, d, w1, b1, w2, b2, gamma, pipeline_enabled())


def fused_convnext_mlp_backward(g, x, A, d, w1, b1, w2, b2, gamma):
    """Port of vfm_vae_tpu/ops/pallas/fused_mlp.py:_fused_bwd (weights in the
    torch layout). Returns (dx, dx_in, dA, dd, dw1, db1, dw2, db2, dgamma)."""
    B, H, W, C = x.shape
    x4 = x
    x = x.reshape(B, H * W, C)
    g = g.reshape(B, H * W, C)
    f32 = torch.float32
    dt = x.dtype
    bwd_bf16 = os.environ.get("VFM_VAE_MLP_BWD_BF16", "1") != "0" and dt != f32
    hdt = dt if bwd_bf16 else f32  # storage dtype of the hidden chain
    gf = g.float()
    w1d, w2d = w1.to(dt), w2.to(dt)
    # Recompute forward intermediates.
    xs = (x.float() * A[:, None, :].float()).to(dt)
    h1 = _matmul(xs, w1d.t(), hdt)
    h = h1.float() * d[:, None, :].float() + b1[:, None, :].float()
    a = F.gelu(h).to(hdt)
    y_pre = _matmul(a.to(dt), w2d.t(), hdt)
    # out = (y_pre + b2) * gamma + x_in; gradient sums stay fp32.
    dgamma = (gf * (y_pre.float() + b2.float())).sum((0, 1))
    dy = gf * gamma.float()
    db2 = dy.sum((0, 1))
    da = _matmul(dy.to(dt), w2d, f32)
    dw2 = torch.einsum("bnh,bnc->ch", a.to(dt).float(), dy.to(dt).float())
    # d GELU (erf form): 0.5 * (1 + erf(h / sqrt 2)) + h * pdf(h)
    pdf = torch.exp(-0.5 * h * h) * (1.0 / math.sqrt(2.0 * math.pi))
    dh = da * (0.5 * (1.0 + torch.erf(h * math.sqrt(0.5))) + h * pdf)
    db1 = dh.sum(1)  # (B, 4C): b1 is per sample at this boundary
    dd = (dh * h1.float()).sum(1)
    dh1 = dh * d[:, None, :].float()
    dxs = _matmul(dh1.to(dt), w1d, f32)
    dw1 = torch.einsum("bnc,bnh->hc", xs.float(), dh1.to(dt).float())
    dx = (dxs * A[:, None, :].float()).to(dt)
    dA = (dxs * x.float()).sum(1)
    return (dx.reshape(x4.shape), g.reshape(x4.shape).to(dt), dA.to(A.dtype), dd.to(d.dtype),
            dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype),
            dgamma.to(gamma.dtype))


def _matmul(a, b, out_dtype):
    """a @ b with fp32 accumulation, rounded to `out_dtype` (XLA's
    preferred_element_type): in the operands' dtype when that is the output
    dtype, else in fp32."""
    if a.dtype == out_dtype:
        return a @ b
    return (a.float() @ b.float()).to(out_dtype)


class FusedConvNeXtMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, x_in, A, d, w1, b1, w2, b2, gamma, plain: bool):
        ctx.save_for_backward(x, A, d, w1, b1, w2, b2, gamma)
        return _forward(x, x_in, A, d, w1, b1, w2, b2, gamma, plain)

    @staticmethod
    def backward(ctx, g):
        grads = fused_convnext_mlp_backward(g.contiguous(), *ctx.saved_tensors)
        return (*grads, None)


def fused_convnext_mlp(x, x_in, A, d, w1, b1, w2, b2, gamma, *, plain: bool = False):
    """x, x_in (B, H, W, C); A (B, C); d, b1 (B, 4C); w1 (4C, C); w2 (C, 4C);
    b2, gamma (C,). CPU tensors (or plain=True) run the twin; CUDA tensors
    launch the kernel (K1, or K9 under VFM_VAE_MLP_PIPELINE=1): bf16
    activations and weights, fp32 vectors, C in {128, 256, 512}.
    Differentiable through FusedConvNeXtMLP."""
    args = (x, x_in, A, d, w1, b1, w2, b2, gamma)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedConvNeXtMLP.apply(*args, plain)
    return _forward(*args, plain)


fused_convnext_mlp.launches = 0


def fused_convnext_mlp_pipelined(x, x_in, A, d, w1, b1, w2, b2, gamma, *, plain: bool = False):
    """K9 explicitly, whatever VFM_VAE_MLP_PIPELINE says (comparisons with
    K1); same arguments and twin as fused_convnext_mlp, forward only."""
    if plain or x.device.type == "cpu":
        return fused_convnext_mlp_reference(x, x_in, A, d, w1, b1, w2, b2, gamma)
    return _launch(x, x_in, A, d, w1, b1, w2, b2, gamma, pipelined=True)


fused_convnext_mlp_pipelined.launches = 0

"""K1: fused ConvNeXt MLP (modulated pw-expand -> exact GELU -> pw-contract
-> layer scale -> residual) without writing the 4C hidden.

Replaces the TPU kernel vfm_vae_tpu/ops/pallas/fused_mlp.py:_fused (body
`_kernel`); the plain twin below follows that file's `_forward_jnp`.

On the H100 the kernel (csrc/fused_mlp.cu) is bound by its two chained
tensor-core GEMMs (~2C flops per byte of activation traffic once the hidden
stays on chip). Its design keeps each 64-column hidden chunk in shared memory
and the (32, C) output accumulator in registers, one CTA per (sample,
32-token tile), with mma.sync bf16 tiles and fp32 accumulation.

Weights use the torch Linear layout: w1 (4C, C), w2 (C, 4C).

Gradients: `FusedConvNeXtMLP` is the port of the JAX custom VJP `_fused_op`
(vfm_vae_tpu/ops/pallas/fused_mlp.py:298-379). Its forward is the kernel on
the card and the twin on the CPU; its backward is a line-by-line port of
`_fused_bwd`, which is plain XLA in the JAX package and plain PyTorch here:
it recomputes the hidden chain (stored in bf16 unless VFM_VAE_MLP_BWD_BF16
is "0", the JAX rule) and returns gradients for all nine inputs.

K9 (`fused_convnext_mlp_pipelined`) replaces the TPU kernel
vfm_vae_tpu/ops/pallas/fused_mlp.py:_fused_pipelined, K1 software-pipelined
and bit-exact with it. It is a second kernel of the same source: chunk
j+1's expand is issued before chunk j's GELU and contract, and the W1/W2
chunk tiles are double-buffered with cp.async. Under
VFM_VAE_MLP_PIPELINE=1, read per call as the JAX package reads it
(fused_mlp.py:302-307), every forward launch on the card is K9 instead of
K1; the twin and the backward are K1's.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from ._build import check_tensor, library, refuse_grad


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


def pipeline_enabled() -> bool:
    """VFM_VAE_MLP_PIPELINE=1 selects K9 (the JAX rule, fused_mlp.py:302-307)."""
    return os.environ.get("VFM_VAE_MLP_PIPELINE") == "1"


def _launch(x, x_in, A, d, w1, b1, w2, b2, gamma, pipelined: bool = False):
    name = "fused_convnext_mlp_pipelined" if pipelined else "fused_convnext_mlp"
    refuse_grad(name, x, x_in, A, d, w1, b1, w2, b2, gamma)
    B, H, W, C = x.shape
    if C not in (128, 256, 512):
        raise ValueError(f"{name}: C={C} not in (128, 256, 512)")
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    check_tensor(x, "x", bf, (B, H, W, C), dev)
    check_tensor(x_in, "x_in", bf, (B, H, W, C), dev)
    check_tensor(A, "A", f32, (B, C), dev)
    check_tensor(d, "d", f32, (B, 4 * C), dev)
    check_tensor(b1, "b1", f32, (B, 4 * C), dev)
    check_tensor(w1, "w1", bf, (4 * C, C), dev)
    check_tensor(w2, "w2", bf, (C, 4 * C), dev)
    check_tensor(b2, "b2", f32, (C,), dev)
    check_tensor(gamma, "gamma", f32, (C,), dev)
    lib = library()
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib.lib, "vfm_" + name)(
            x.data_ptr(), x_in.data_ptr(), A.data_ptr(), d.data_ptr(), b1.data_ptr(),
            w1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(), out.data_ptr(),
            B, H * W, C, stream,
        )
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

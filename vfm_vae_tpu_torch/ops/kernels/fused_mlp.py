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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_tensor, library


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


def fused_convnext_mlp(x, x_in, A, d, w1, b1, w2, b2, gamma, *, plain: bool = False):
    """x, x_in (B, H, W, C); A (B, C); d, b1 (B, 4C); w1 (4C, C); w2 (C, 4C);
    b2, gamma (C,). CPU tensors (or plain=True) run the twin; CUDA tensors
    launch the kernel: bf16 activations and weights, fp32 vectors,
    C in {128, 256, 512}."""
    if plain or x.device.type == "cpu":
        return fused_convnext_mlp_reference(x, x_in, A, d, w1, b1, w2, b2, gamma)
    B, H, W, C = x.shape
    if C not in (128, 256, 512):
        raise ValueError(f"fused_convnext_mlp: C={C} not in (128, 256, 512)")
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
        err = lib.lib.vfm_fused_convnext_mlp(
            x.data_ptr(), x_in.data_ptr(), A.data_ptr(), d.data_ptr(), b1.data_ptr(),
            w1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(), out.data_ptr(),
            B, H * W, C, stream,
        )
    lib.check(err, "fused_convnext_mlp")
    fused_convnext_mlp.launches += 1
    return out


fused_convnext_mlp.launches = 0

"""K3: flash attention over [null_k; k], [null_v; v] (GigaGAN's learned
null token), forward and backward; K4: flash attention without a null
token, forward.

Forward replaces the TPU kernel vfm_vae_tpu/ops/pallas/flash_attention.py:
flash_attention_nullkv (jax's library Pallas flash kernel behind a
pad-to-128 and segment-id mask); the plain twin below is that file's CPU
path, concat + softmax attention (vfm_vae_tpu/ops/attention.py:68-70).
Backward replaces the library's two backward Pallas kernels that the JAX
K3 reaches through its custom VJP (jax flash_attention.py:
_flash_attention_bwd_dkv and _flash_attention_bwd_dq).

On the H100 the kernels (csrc/flash_attention_nullkv.cu and
csrc/flash_attention_nullkv_bwd.cu) are bound by their tensor-core products
(~T/2 flops per byte at d=64); the (T, T+1) logits never reach device
memory. The null key and value are read as key 0 of the walk from their own
pointer, and their gradients are written per sample to their own outputs,
so no concat, padding or mask tensor exists and every T runs. In training
the forward also writes the per-row log-sum-exp, from which the backward
recomputes the probabilities.

`flash_attention_nullkv` is the entry point: when autograd records, it runs
through `FlashAttentionNullKV`, whose forward and backward launch the
kernels on the card and run the twins on the CPU.

K4 (`flash_attention_nonull`) replaces vfm_vae_tpu/ops/pallas/flash_attention.py:
flash_attention, the library kernel with full-sequence blocks that the JAX
package routes the SigLIP tower and the adapter's AttnProjections to when
ops/attention.py's eligibility rule admits them. It is a mode of the same
CUDA source: null pointers for the null token, so the key walk starts at
key 0 of k; head dims 64 and 128; bf16 operands on the tensor cores, or
fp32 operands (the adapter computes in fp32) with fp32 FMA on the CUDA cores
and no TF32. Its backward (`FlashAttentionNoNull`, K4-dkv and K4-dq)
replaces the same two library backward kernels as K3's: no-null modes of
K3's backward kernels in bf16 (d = 64, 128) and an fp32 FMA variant, from
the per-row log-sum-exp that K4's forward writes when autograd records.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import check_tensor, library, refuse_grad


def flash_attention_nullkv_reference(q, k, v, null_k, null_v, scale: Optional[float] = None,
                                     return_lse: bool = False):
    """Concat the null token, fp32 logits and softmax, probabilities rounded
    to the input dtype, fp32-accumulated product (jax.nn.dot_product_attention).
    With return_lse, also the fp32 (B, N, T) log-sum-exp of the logits."""
    dt = q.dtype
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    k = torch.cat([null_k, k], dim=1)
    v = torch.cat([null_v, v], dim=1)
    logits = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(dt)
    out = torch.einsum("bnts,bsnh->btnh", probs.float(), v.float()).to(dt)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _probs_and_dp(q, k, v, null_k, null_v, dout, lse, scale):
    """fp32 [null; k] (k alone without a null token), P = exp(S - L) from
    the saved log-sum-exp, and dO V^T."""
    kf = (k if null_k is None else torch.cat([null_k, k], dim=1)).float()
    vf = (v if null_v is None else torch.cat([null_v, v], dim=1)).float()
    s = torch.einsum("btnh,bsnh->bnts", q.float(), kf) * scale
    p = torch.exp(s - lse[..., None])
    return kf, p, torch.einsum("btnh,bsnh->bnts", dout.float(), vf)


def flash_attention_nullkv_bwd_dkv_reference(q, k, v, null_k, null_v, out, lse, dout,
                                             scale: Optional[float] = None):
    """Plain twin of the dK/dV kernel, with its formula: D = rowsum(dO * O),
    dS = P (dO V^T - D); P and dS rounded to the input dtype before the
    products that consume them. Returns (dk, dv, d null_k, d null_v, D)."""
    dt = q.dtype
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    _, p, dp = _probs_and_dp(q, k, v, null_k, null_v, dout, lse, scale)
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()  # (B, N, T)
    dv = torch.einsum("bnts,btnh->bsnh", p.to(dt).float(), dout.float())
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dk = torch.einsum("bnts,btnh->bsnh", ds, q.float()) * scale
    if null_k is None:
        return dk.to(dt), dv.to(dt), None, None, delta
    return dk[:, 1:].to(dt), dv[:, 1:].to(dt), dk[:, :1].to(dt), dv[:, :1].to(dt), delta


def flash_attention_nullkv_bwd_dq_reference(q, k, v, null_k, null_v, dout, lse, delta,
                                            scale: Optional[float] = None):
    """Plain twin of the dQ kernel: dQ = dS [null; k] * scale."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    kf, p, dp = _probs_and_dp(q, k, v, null_k, null_v, dout, lse, scale)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    return (torch.einsum("bnts,bsnh->btnh", ds, kf) * scale).to(q.dtype)


def flash_attention_nullkv_bwd_reference(q, k, v, null_k, null_v, out, lse, dout,
                                         scale: Optional[float] = None):
    """Both backward twins: (dq, dk, dv, d null_k, d null_v, D)."""
    dk, dv, dnk, dnv, delta = flash_attention_nullkv_bwd_dkv_reference(
        q, k, v, null_k, null_v, out, lse, dout, scale)
    dq = flash_attention_nullkv_bwd_dq_reference(q, k, v, null_k, null_v, dout, lse, delta, scale)
    return dq, dk, dv, dnk, dnv, delta


def _check_qkv(q, k, v, null_k, null_v, name: str):
    B, T, N, D = q.shape
    if D != 64:
        raise ValueError(f"{name}: head dim {D} != 64")
    dev, bf = q.device, torch.bfloat16
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        check_tensor(t, n, bf, (B, T, N, D), dev)
    check_tensor(null_k, "null_k", bf, (B, 1, N, D), dev)
    check_tensor(null_v, "null_v", bf, (B, 1, N, D), dev)
    return B, T, N, D, dev


def _launch_forward(q, k, v, null_k, null_v, scale: float, with_lse: bool):
    refuse_grad("flash_attention_nullkv", q, k, v, null_k, null_v)
    B, T, N, D, dev = _check_qkv(q, k, v, null_k, null_v, "flash_attention_nullkv")
    lib = library()
    out = torch.empty_like(q)
    lse = torch.empty((B, N, T), dtype=torch.float32, device=dev) if with_lse else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lib.vfm_flash_attention_nullkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), null_k.data_ptr(), null_v.data_ptr(),
            out.data_ptr(), lse.data_ptr() if with_lse else None, B, T, N, D, scale, stream,
        )
    lib.check(err, "flash_attention_nullkv")
    flash_attention_nullkv.launches += 1
    return out, lse


def flash_attention_nullkv_bwd_dkv(q, k, v, null_k, null_v, out, dout, lse,
                                   scale: Optional[float] = None):
    """dk, dv (B, T, N, 64), d null_k, d null_v (B, 1, N, 64) and D = rowsum(dO * O)
    (B, N, T). CPU tensors run the twin; CUDA tensors launch the D pre-pass and
    the dK/dV kernel: bf16 q, k, v, null_k, null_v, out, dout and fp32 lse."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_nullkv_bwd_dkv_reference(q, k, v, null_k, null_v, out, lse, dout,
                                                        scale)
    refuse_grad("flash_attention_nullkv_bwd_dkv", q, k, v, null_k, null_v, out, dout)
    B, T, N, D, dev = _check_qkv(q, k, v, null_k, null_v, "flash_attention_nullkv_bwd_dkv")
    check_tensor(out, "out", torch.bfloat16, (B, T, N, D), dev)
    check_tensor(dout, "dout", torch.bfloat16, (B, T, N, D), dev)
    check_tensor(lse, "lse", torch.float32, (B, N, T), dev)
    lib = library()
    delta = torch.empty((B, N, T), dtype=torch.float32, device=dev)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dnk, dnv = torch.empty_like(null_k), torch.empty_like(null_v)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lib.vfm_flash_attention_nullkv_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), null_k.data_ptr(), null_v.data_ptr(),
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dnk.data_ptr(), dnv.data_ptr(), B, T, N, D, scale, stream,
        )
    lib.check(err, "flash_attention_nullkv_bwd_dkv")
    flash_attention_nullkv_bwd_dkv.launches += 1
    return dk, dv, dnk, dnv, delta


def flash_attention_nullkv_bwd_dq(q, k, v, null_k, null_v, dout, lse, delta,
                                  scale: Optional[float] = None):
    """dq (B, T, N, 64) from the D that flash_attention_nullkv_bwd_dkv returns.
    CPU tensors run the twin's dQ; CUDA tensors launch the dQ kernel."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_nullkv_bwd_dq_reference(q, k, v, null_k, null_v, dout, lse, delta,
                                                       scale)
    refuse_grad("flash_attention_nullkv_bwd_dq", q, k, v, null_k, null_v, dout)
    B, T, N, D, dev = _check_qkv(q, k, v, null_k, null_v, "flash_attention_nullkv_bwd_dq")
    check_tensor(dout, "dout", torch.bfloat16, (B, T, N, D), dev)
    check_tensor(lse, "lse", torch.float32, (B, N, T), dev)
    check_tensor(delta, "delta", torch.float32, (B, N, T), dev)
    lib = library()
    dq = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lib.vfm_flash_attention_nullkv_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), null_k.data_ptr(), null_v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, T, N, D, scale,
            stream,
        )
    lib.check(err, "flash_attention_nullkv_bwd_dq")
    flash_attention_nullkv_bwd_dq.launches += 1
    return dq


class FlashAttentionNullKV(torch.autograd.Function):
    """The forward saves q, k, v, the null token, the output and the
    log-sum-exp; the backward returns per-sample gradients for the null
    token, which the caller's `expand` sums to its parameter."""

    @staticmethod
    def forward(ctx, q, k, v, null_k, null_v, scale: float, plain: bool):
        if plain or q.device.type == "cpu":
            out, lse = flash_attention_nullkv_reference(q, k, v, null_k, null_v, scale,
                                                        return_lse=True)
        else:
            out, lse = _launch_forward(q, k, v, null_k, null_v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, null_k, null_v, out, lse)
        ctx.scale, ctx.plain = scale, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, null_k, null_v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if ctx.plain or q.device.type == "cpu":
            dq, dk, dv, dnk, dnv, _ = flash_attention_nullkv_bwd_reference(
                q, k, v, null_k, null_v, out, lse, dout, ctx.scale)
        else:
            dk, dv, dnk, dnv, delta = flash_attention_nullkv_bwd_dkv(
                q, k, v, null_k, null_v, out, dout, lse, ctx.scale)
            dq = flash_attention_nullkv_bwd_dq(q, k, v, null_k, null_v, dout, lse, delta,
                                               ctx.scale)
        return dq, dk, dv, dnk, dnv, None, None


def flash_attention_nullkv(q, k, v, null_k, null_v, scale: Optional[float] = None, *,
                           plain: bool = False):
    """q, k, v (B, T, N, 64); null_k, null_v (B, 1, N, 64) -> (B, T, N, 64).
    CPU tensors (or plain=True) run the twin; CUDA tensors launch the kernel:
    bf16, contiguous, head dim 64. Differentiable through FlashAttentionNullKV."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, null_k, null_v)):
        return FlashAttentionNullKV.apply(q, k, v, null_k, null_v, scale, plain)
    if plain or q.device.type == "cpu":
        return flash_attention_nullkv_reference(q, k, v, null_k, null_v, scale)
    return _launch_forward(q, k, v, null_k, null_v, scale, with_lse=False)[0]


flash_attention_nullkv.launches = 0
flash_attention_nullkv_bwd_dkv.launches = 0
flash_attention_nullkv_bwd_dq.launches = 0


def flash_attention_nonull_reference(q, k, v, scale: Optional[float] = None,
                                     return_lse: bool = False):
    """Plain twin of K4: fp32 logits and softmax, probabilities rounded to
    the input dtype, fp32-accumulated product (jax.nn.dot_product_attention).
    With return_lse, also the fp32 (B, N, Tq) log-sum-exp of the logits."""
    dt = q.dtype
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(dt)
    out = torch.einsum("bnts,bsnh->btnh", probs.float(), v.float()).to(dt)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def flash_attention_nonull_bwd_dkv_reference(q, k, v, out, lse, dout,
                                             scale: Optional[float] = None):
    """Plain twin of K4's dK/dV kernel: K3's formula without the null token.
    Returns (dk, dv, D)."""
    dk, dv, _, _, delta = flash_attention_nullkv_bwd_dkv_reference(q, k, v, None, None, out, lse,
                                                                   dout, scale)
    return dk, dv, delta


def flash_attention_nonull_bwd_dq_reference(q, k, v, dout, lse, delta,
                                            scale: Optional[float] = None):
    """Plain twin of K4's dQ kernel: dQ = dS k * scale."""
    return flash_attention_nullkv_bwd_dq_reference(q, k, v, None, None, dout, lse, delta, scale)


def flash_attention_nonull_bwd_reference(q, k, v, out, lse, dout,
                                         scale: Optional[float] = None):
    """Both of K4's backward twins: (dq, dk, dv, D)."""
    dk, dv, delta = flash_attention_nonull_bwd_dkv_reference(q, k, v, out, lse, dout, scale)
    dq = flash_attention_nonull_bwd_dq_reference(q, k, v, dout, lse, delta, scale)
    return dq, dk, dv, delta


def _check_nonull(q, k, v, name: str):
    """(B, Tq, Tk, N, D, dev) of K4's operands, or raise where no kernel mode
    covers them: head dim 64 or 128, bf16 or fp32, Tq, Tk > 0, contiguous."""
    B, Tq, N, D = q.shape
    Tk = k.shape[1]
    if D not in (64, 128) or q.dtype not in (torch.bfloat16, torch.float32) or Tk == 0 or Tq == 0:
        raise ValueError(f"{name}: head dim {D}, {q.dtype}, Tq={Tq}, Tk={Tk}; the kernel takes "
                         "D in (64, 128), bf16 or fp32 and Tq, Tk > 0")
    dev = q.device
    check_tensor(q, "q", q.dtype, (B, Tq, N, D), dev)
    check_tensor(k, "k", q.dtype, (B, Tk, N, D), dev)
    check_tensor(v, "v", q.dtype, (B, Tk, N, D), dev)
    return B, Tq, Tk, N, D, dev


def _launch_nonull(q, k, v, scale: float, with_lse: bool):
    refuse_grad("flash_attention_nonull", q, k, v)
    B, Tq, Tk, N, D, dev = _check_nonull(q, k, v, "flash_attention_nonull")
    lib = library()
    out = torch.empty_like(q)
    lse = torch.empty((B, N, Tq), dtype=torch.float32, device=dev) if with_lse else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lib.vfm_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                          out.data_ptr(), lse.data_ptr() if with_lse else None,
                                          B, Tq, Tk, N, D, scale, int(q.dtype == torch.float32),
                                          stream)
    lib.check(err, "flash_attention_nonull")
    flash_attention_nonull.launches += 1
    return out, lse


def flash_attention_nonull_bwd_dkv(q, k, v, out, dout, lse, scale: Optional[float] = None):
    """dk, dv (B, Tk, N, D) and D = rowsum(dO * O) (B, N, Tq). CPU tensors run
    the twin; CUDA tensors launch the D pre-pass and the dK/dV kernel: q, k,
    v, out, dout of one dtype (bf16 or fp32), D in (64, 128), fp32 lse."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_nonull_bwd_dkv_reference(q, k, v, out, lse, dout, scale)
    refuse_grad("flash_attention_nonull_bwd_dkv", q, k, v, out, dout)
    B, Tq, Tk, N, D, dev = _check_nonull(q, k, v, "flash_attention_nonull_bwd_dkv")
    check_tensor(out, "out", q.dtype, (B, Tq, N, D), dev)
    check_tensor(dout, "dout", q.dtype, (B, Tq, N, D), dev)
    check_tensor(lse, "lse", torch.float32, (B, N, Tq), dev)
    lib = library()
    delta = torch.empty((B, N, Tq), dtype=torch.float32, device=dev)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lib.vfm_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Tq, Tk, N, D,
            scale, int(q.dtype == torch.float32), stream)
    lib.check(err, "flash_attention_nonull_bwd_dkv")
    flash_attention_nonull_bwd_dkv.launches += 1
    return dk, dv, delta


def flash_attention_nonull_bwd_dq(q, k, v, dout, lse, delta, scale: Optional[float] = None):
    """dq (B, Tq, N, D) from the D that flash_attention_nonull_bwd_dkv returns.
    CPU tensors run the twin's dQ; CUDA tensors launch the dQ kernel."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_nonull_bwd_dq_reference(q, k, v, dout, lse, delta, scale)
    refuse_grad("flash_attention_nonull_bwd_dq", q, k, v, dout)
    B, Tq, Tk, N, D, dev = _check_nonull(q, k, v, "flash_attention_nonull_bwd_dq")
    check_tensor(dout, "dout", q.dtype, (B, Tq, N, D), dev)
    check_tensor(lse, "lse", torch.float32, (B, N, Tq), dev)
    check_tensor(delta, "delta", torch.float32, (B, N, Tq), dev)
    lib = library()
    dq = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lib.vfm_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), B, Tq, Tk, N, D, scale,
            int(q.dtype == torch.float32), stream)
    lib.check(err, "flash_attention_nonull_bwd_dq")
    flash_attention_nonull_bwd_dq.launches += 1
    return dq


class FlashAttentionNoNull(torch.autograd.Function):
    """K4 with its backward: the forward saves q, k, v, the output and the
    log-sum-exp; the backward launches K4-dkv and K4-dq on the card and runs
    their twins on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, plain: bool):
        if plain or q.device.type == "cpu":
            out, lse = flash_attention_nonull_reference(q, k, v, scale, return_lse=True)
        else:
            out, lse = _launch_nonull(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.plain = scale, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if ctx.plain or q.device.type == "cpu":
            dq, dk, dv, _ = flash_attention_nonull_bwd_reference(q, k, v, out, lse, dout,
                                                                 ctx.scale)
        else:
            dk, dv, delta = flash_attention_nonull_bwd_dkv(q, k, v, out, dout, lse, ctx.scale)
            dq = flash_attention_nonull_bwd_dq(q, k, v, dout, lse, delta, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_nonull(q, k, v, scale: Optional[float] = None, *, plain: bool = False):
    """q (B, Tq, N, D), k and v (B, Tk, N, D) -> (B, Tq, N, D). CPU tensors
    (or plain=True) run the twin; CUDA tensors launch the kernel: bf16 or
    fp32, contiguous, D in (64, 128); any other operand raises.
    Differentiable through FlashAttentionNoNull."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionNoNull.apply(q, k, v, scale, plain)
    if plain or q.device.type == "cpu":
        return flash_attention_nonull_reference(q, k, v, scale)
    return _launch_nonull(q, k, v, scale, with_lse=False)[0]


flash_attention_nonull.launches = 0
flash_attention_nonull_bwd_dkv.launches = 0
flash_attention_nonull_bwd_dq.launches = 0

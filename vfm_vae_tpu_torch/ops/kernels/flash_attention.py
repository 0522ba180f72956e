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
memory. The null key and value come from their own pointer and stay out of
the tile walk: the bf16 forward (wgmma and TMA, persistent; forward_plan
below mirrors its launch plan) starts each row's online softmax from the
null token, and the bf16 backward (the same machinery; backward_plan)
computes the null token's per-query terms beside the walk and writes its
gradients per sample to their own outputs, so no concat, padding or mask
tensor exists and every T runs. In training the forward also writes the
per-row log-sum-exp, from which the backward recomputes the probabilities.
A backward is one call into the library (`_launch_backward`): one
validation pass, one allocation, the pre-pass, dK/dV and dQ kernels.

`flash_attention_nullkv` is the entry point: when autograd records, it runs
through `FlashAttentionNullKV`, whose forward and backward launch the
kernels on the card and run the twins on the CPU.

K4 (`flash_attention_nonull`) replaces vfm_vae_tpu/ops/pallas/flash_attention.py:
flash_attention, the library kernel with full-sequence blocks that the JAX
package routes the SigLIP tower and the adapter's AttnProjections to when
ops/attention.py's eligibility rule admits them. It is a mode of the same
CUDA source: null pointers for the null token, so the key walk starts at
key 0 of k; head dims 64 and 128; bf16 operands on the tensor cores, or
fp32 operands (the adapter computes in fp32) with every product on the
tensor cores as 3xTF32 (wgmma fed by TMA, each operand split into TF32 hi
and lo parts, fp32 accumulation in short chains: fp32's accuracy, not
TF32's; forward_plan_f32 mirrors its launch plan). Its backward (`FlashAttentionNoNull`, K4-dkv and K4-dq)
replaces the same two library backward kernels as K3's: no-null modes of
K3's backward kernels in bf16 (d = 64, 128), and in fp32 two kernels of
their own with every product on the tensor cores as 3xTF32 (mma.sync, each
operand split into TF32 hi and lo parts, fp32 accumulation: fp32's accuracy,
not TF32's; backward_plan_f32 mirrors their launch plan), from the per-row
log-sum-exp that K4's forward writes when autograd records.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import call_on, check_all, check_tensor, library, refuse_grad


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


# The bf16 forward kernel's key tile and ring of K/V stages
# (csrc/flash_attention_nullkv.cu).
KEY_TILE = 128
STAGES = 3


def forward_plan(B: int, Tq: int, N: int, D: int, sms: int = 132) -> dict:
    """The bf16 forward kernel's launch plan for q (B, Tq, N, D) on a card
    with `sms` SMs, as the C side computes it (vfm_flash_fwd_plan): two
    consumer warpgroups of 64 query rows per CTA unless B * N * ceil(Tq /
    128) CTAs would leave an SM without one, then one; K/V tiles of 128 keys
    in a ring of three stages; TMA boxes of 64 columns (two per row at
    d=128); a producer warpgroup. The kernel is persistent: min(work_tiles,
    SMs x the CTAs one SM holds) CTAs walk the (query block, head, sample)
    work tiles."""
    if D not in (64, 128):
        raise ValueError(f"head dim {D}: the bf16 forward takes 64 or 128")
    wgs = 2 if B * N * -(-Tq // 128) >= sms else 1
    rows, boxes = 64 * wgs, D // 64
    tile = boxes * KEY_TILE * 128  # bytes of one K or V tile
    smem = boxes * rows * 128 + 2 * STAGES * tile + 8 * (2 + 3 * STAGES) + 1024
    return dict(wgs=wgs, query_tile=rows, key_tile=KEY_TILE, stages=STAGES,
                threads=wgs * 128 + 128, smem_bytes=smem, work_tiles=-(-Tq // rows) * N * B,
                q_box=(64, 1, rows, 1), kv_box=(64, 1, KEY_TILE, 1), boxes_per_row=boxes)


# The fp32 forward kernel's ring of K/V stages (csrc/flash_attention_nullkv.cu).
F32_STAGES = 2


def forward_plan_f32(B: int, Tq: int, N: int, D: int, sms: int = 132) -> dict:
    """The fp32 forward kernel's launch plan (3xTF32 on wgmma) for q (B, Tq,
    N, D) on a card with `sms` SMs, as the C side computes it
    (vfm_flash_fwd_f32_plan): one CTA per block of 64 x wgs queries of one
    (sample, head), two consumer warpgroups at d=64 when B * N * ceil(Tq /
    128) CTAs give every SM one, else one (always one at d=128); K/V tiles of
    4096 / D keys (64 at d=64, 32 at d=128) in a ring of two stages, each
    holding K (split in place), K's lo plane, V as loaded and the hi and lo
    planes of its transpose; Q's hi and lo planes; TMA boxes of 32 fp32
    columns; a producer warpgroup (one TMA lane, three splitting warps)."""
    if D not in (64, 128):
        raise ValueError(f"head dim {D}: the fp32 forward takes 64 or 128")
    wgs = 2 if D == 64 and B * N * -(-Tq // 128) >= sms else 1
    rows, key_tile = 64 * wgs, 4096 // D
    plane, tile = rows * D * 4, key_tile * D * 4  # bytes of one Q plane, one K/V plane
    smem = 2 * plane + F32_STAGES * 5 * tile + 8 * (2 + 3 * F32_STAGES) + 1024
    return dict(wgs=wgs, query_tile=rows, key_tile=key_tile, stages=F32_STAGES,
                threads=wgs * 128 + 128, smem_bytes=smem, ctas=-(-Tq // rows) * N * B,
                q_box=(32, 1, rows, 1), kv_box=(32, 1, key_tile, 1), boxes_per_row=D // 32)


# The bf16 backward kernels' streamed tile (64 queries for dK/dV, 64 keys
# for dQ; also the rows of one resident TMA box), their ring stages, and the
# query rows of one pre-pass CTA (csrc/flash_attention_nullkv_bwd.cu).
BWD_TILE = 64
BWD_STAGES = 4
PREPASS_ROWS = 64


def backward_plan(B: int, Tq: int, Tk: int, N: int, D: int, sms: int = 132) -> dict:
    """The bf16 backward's launch plan for q (B, Tq, N, D), k (B, Tk, N, D)
    on a card with `sms` SMs, as the C side computes it (vfm_flash_bwd_plan).
    `dkv`: work tiles of 64 x wgs keys (K and V resident), 64-query tiles of
    q and dO streamed, with each stage's L and D rows; `dq`: work tiles of
    64 x wgs queries (q and dO resident), 64-key tiles of K and V streamed.
    Each takes two consumer warpgroups unless 64-row blocks fit on the SMs in
    one wave, has a producer warpgroup, four ring stages and TMA boxes of
    (64, 1, 64, 1), and is persistent: min(work tiles, SMs) CTAs. Key tiles
    start at row 0 of k, the null token being outside the walk: its
    gradients are the sums of `null_chunks` pre-pass partials of
    PREPASS_ROWS queries each."""
    if D not in (64, 128):
        raise ValueError(f"head dim {D}: the bf16 backward takes 64 or 128")
    boxes = D // 64
    tile = boxes * BWD_TILE * 128  # bytes of one streamed tile

    def kernel(T: int, T_walk: int, row_floats: int) -> dict:
        wgs = 2 if B * N * -(-T // 64) > sms else 1
        rows = 64 * wgs
        smem = (2 * boxes * rows * 128 + 2 * BWD_STAGES * tile + 8 * (2 + 3 * BWD_STAGES)
                + BWD_STAGES * row_floats * 4 + 1024)
        work = -(-T // rows) * N * B
        return dict(wgs=wgs, rows=rows, tile=BWD_TILE, stages=BWD_STAGES, threads=wgs * 128 + 128,
                    smem_bytes=smem, work_tiles=work, grid=min(work, sms),
                    walk_tiles=-(-T_walk // BWD_TILE))

    return dict(dkv=kernel(Tk, Tq, 2 * BWD_TILE), dq=kernel(Tq, Tk, 0), box=(64, 1, BWD_TILE, 1),
                boxes_per_row=boxes, prepass_rows=PREPASS_ROWS,
                null_chunks=-(-Tq // PREPASS_ROWS))


def backward_plan_f32(B: int, Tq: int, Tk: int, N: int, D: int, sms: int = 132) -> dict:
    """The fp32 backward's launch plan (3xTF32 on mma.sync) for q (B, Tq, N,
    D), k (B, Tk, N, D) on a card with `sms` SMs, as the C side computes it
    (vfm_flash_bwd_f32_plan). `dkv`: one CTA per block of 16 x warps keys (K
    and V resident), q, dO, L and D streamed in tiles of 32 queries, q and
    dO held as hi and lo planes; `dq`: one CTA per block of 16 x warps
    queries (q and dO resident), K and V streamed in tiles of 64 keys. Four
    warps per CTA unless B * N * ceil(T / 64) < `sms`, then two; two
    cp.async stages; shared memory in rows of D + 4 floats."""
    if D not in (64, 128):
        raise ValueError(f"head dim {D}: the fp32 backward takes 64 or 128")
    ld = D + 4

    def kernel(T: int, T_walk: int, dkv: bool) -> dict:
        warps = 4 if B * N * -(-T // 64) >= sms else 2
        rows, walk = 16 * warps, 32 if dkv else 64
        stage = 4 * walk * ld + 2 * walk if dkv else 2 * walk * ld
        return dict(warps=warps, rows=rows, tile=walk, stages=2, threads=32 * warps,
                    smem_bytes=4 * (2 * rows * ld + 2 * stage), ctas=-(-T // rows) * N * B,
                    walk_tiles=-(-T_walk // walk))

    return dict(dkv=kernel(Tk, Tq, True), dq=kernel(Tq, Tk, False))


def _launch_forward(q, k, v, null_k, null_v, scale: float, with_lse: bool):
    refuse_grad("flash_attention_nullkv", q, k, v, null_k, null_v)
    B, T, N, D = q.shape
    if D != 64:
        raise ValueError(f"flash_attention_nullkv: head dim {D} != 64")
    dev, shape, nshape = q.device, q.shape, (B, 1, N, D)
    check_all("flash_attention_nullkv", torch.bfloat16, dev,
                   ((q, "q", shape), (k, "k", shape), (v, "v", shape),
                    (null_k, "null_k", nshape), (null_v, "null_v", nshape)))
    lib = library()
    out = torch.empty_like(q)
    lse = torch.empty((B, N, T), dtype=torch.float32, device=dev) if with_lse else None
    err = call_on(dev, lib.lib.vfm_flash_attention_nullkv, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), null_k.data_ptr(), null_v.data_ptr(), out.data_ptr(),
                   lse.data_ptr() if with_lse else None, B, T, N, D, scale)
    lib.check(err, "flash_attention_nullkv")
    flash_attention_nullkv.launches += 1
    return out, lse


def _launch_backward(q, k, v, null_k, null_v, out, dout, lse, scale: float, *,
                     dq: bool = True, dkv: bool = True, delta=None):
    """The backward kernels in one library call: the pre-pass (D = rowsum(dO
    O), and the null token's partial sums) when `out` is given, else `delta`
    is read; the dK/dV kernel with `dkv`, the dQ kernel with `dq`. K3 with
    null_k, null_v (bf16, d=64, Tq = Tk), else K4 (bf16 or fp32, d 64 or
    128). One validation pass and one allocation for every output and D.
    Returns (dq, dk, dv, d null_k, d null_v, D), None where not computed; D
    only when computed here without dq, for a later dQ call to read."""
    null = null_k is not None
    name = "flash_attention_nullkv_bwd" if null else "flash_attention_nonull_bwd"
    B, Tq, N, D = q.shape
    Tk, dt, dev = k.shape[1], q.dtype, q.device
    if null and (D != 64 or Tk != Tq):
        raise ValueError(f"{name}: head dim {D} != 64 or Tq={Tq} != Tk={Tk}")
    if D not in (64, 128) or dt not in (torch.bfloat16, torch.float32) or Tk == 0 or Tq == 0:
        _check_nonull(q, k, v, name)  # raises with the reason
    qs, ks, ns, rows = (B, Tq, N, D), (B, Tk, N, D), (B, 1, N, D), (B, N, Tq)
    specs = [(q, "q", qs), (k, "k", ks), (v, "v", ks), (dout, "dout", qs)]
    if null:
        specs += [(null_k, "null_k", ns), (null_v, "null_v", ns)]
    if out is not None:
        specs.append((out, "out", qs))
    check_all(name, torch.bfloat16 if null else dt, dev, specs)
    check_all(name, torch.float32, dev,
                   [(lse, "lse", rows)] + ([] if delta is None else [(delta, "delta", rows)]))
    if out is None and delta is None:
        raise ValueError(f"{name}: needs `out` (to compute D) or `delta`")
    if null and dkv and out is None:
        raise ValueError(f"{name}: the null token's gradients need `out` (the pre-pass)")
    # One allocation, in q's dtype units: dq, dk, dv, d null_k, d null_v, then
    # the fp32 D and the null token's partial sums (B, N, ceil(Tq / 64), 2, D);
    # the outputs are strided views of it, the fp32 part only a pointer.
    size = q.element_size()
    per_f32 = 4 // size
    n_q, n_k, n_n = B * Tq * N * D if dq else 0, B * Tk * N * D if dkv else 0, B * N * D
    n_n = n_n if null and dkv else 0
    n_rows = B * N * Tq if out is not None else 0
    n_part = B * N * -(-Tq // PREPASS_ROWS) * 2 * D if null and dkv else 0
    at = n_q + 2 * n_k + 2 * n_n  # start of the fp32 part (even: every size is a multiple of D)
    buf = torch.empty(at + (n_rows + n_part) * per_f32, dtype=dt, device=dev)
    tok = (N * D, D, 1)
    g_q = buf.as_strided(qs, (Tq * N * D,) + tok) if dq else None
    g_k = g_v = g_nk = g_nv = None
    if dkv:
        g_k = buf.as_strided(ks, (Tk * N * D,) + tok, n_q)
        g_v = buf.as_strided(ks, (Tk * N * D,) + tok, n_q + n_k)
    if n_n:
        g_nk = buf.as_strided(ns, (N * D,) + tok, n_q + 2 * n_k)
        g_nv = buf.as_strided(ns, (N * D,) + tok, n_q + 2 * n_k + n_n)
    work = buf.data_ptr() + at * size
    if out is None:
        delta_ptr = delta.data_ptr()
    else:
        delta_ptr = work
        delta = None if dq else buf.view(torch.float32).as_strided(rows, (N * Tq, Tq, 1),
                                                                     at // per_f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = library()
    if null:
        err = call_on(dev, lib.lib.vfm_flash_attention_nullkv_bwd, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), null_k.data_ptr(), null_v.data_ptr(), ptr(out),
                       dout.data_ptr(), lse.data_ptr(), delta_ptr,
                       work + 4 * n_rows if n_part else None, ptr(g_q), ptr(g_k),
                       ptr(g_v), ptr(g_nk), ptr(g_nv), B, Tq, N, D, scale)
        lib.check(err, name)
        counters = (flash_attention_nullkv_bwd_dkv, flash_attention_nullkv_bwd_dq)
    else:
        err = call_on(dev, lib.lib.vfm_flash_attention_bwd, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), ptr(out), dout.data_ptr(), lse.data_ptr(),
                       delta_ptr, ptr(g_q), ptr(g_k), ptr(g_v), B, Tq, Tk, N, D, scale,
                       int(dt == torch.float32))
        lib.check(err, name)
        counters = (flash_attention_nonull_bwd_dkv, flash_attention_nonull_bwd_dq)
    if dkv:
        counters[0].launches += 1
    if dq:
        counters[1].launches += 1
    return g_q, g_k, g_v, g_nk, g_nv, delta


def flash_attention_nullkv_bwd_dkv(q, k, v, null_k, null_v, out, dout, lse,
                                   scale: Optional[float] = None):
    """dk, dv (B, T, N, 64), d null_k, d null_v (B, 1, N, 64) and D = rowsum(dO * O)
    (B, N, T). CPU tensors run the twin; CUDA tensors launch the pre-pass and
    the dK/dV kernel: bf16 q, k, v, null_k, null_v, out, dout and fp32 lse."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_nullkv_bwd_dkv_reference(q, k, v, null_k, null_v, out, lse, dout,
                                                        scale)
    refuse_grad("flash_attention_nullkv_bwd_dkv", q, k, v, null_k, null_v, out, dout)
    return _launch_backward(q, k, v, null_k, null_v, out, dout, lse, scale, dq=False)[1:]


def flash_attention_nullkv_bwd_dq(q, k, v, null_k, null_v, dout, lse, delta,
                                  scale: Optional[float] = None):
    """dq (B, T, N, 64) from the D that flash_attention_nullkv_bwd_dkv returns.
    CPU tensors run the twin's dQ; CUDA tensors launch the dQ kernel."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_nullkv_bwd_dq_reference(q, k, v, null_k, null_v, dout, lse, delta,
                                                       scale)
    refuse_grad("flash_attention_nullkv_bwd_dq", q, k, v, null_k, null_v, dout)
    return _launch_backward(q, k, v, null_k, null_v, None, dout, lse, scale, dkv=False,
                            delta=delta)[0]


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
            dq, dk, dv, dnk, dnv, _ = _launch_backward(q, k, v, null_k, null_v, out, dout, lse,
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
    B, Tq, N, D = q.shape
    Tk, dt, dev = k.shape[1], q.dtype, q.device
    if D not in (64, 128) or dt not in (torch.bfloat16, torch.float32) or Tk == 0 or Tq == 0:
        _check_nonull(q, k, v, "flash_attention_nonull")  # raises with the reason
    kshape = (B, Tk, N, D)
    check_all("flash_attention_nonull", dt, dev,
                   ((q, "q", q.shape), (k, "k", kshape), (v, "v", kshape)))
    lib = library()
    out = torch.empty_like(q)
    lse = torch.empty((B, N, Tq), dtype=torch.float32, device=dev) if with_lse else None
    err = call_on(dev, lib.lib.vfm_flash_attention, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   out.data_ptr(), lse.data_ptr() if with_lse else None, B, Tq, Tk, N, D, scale,
                   int(dt == torch.float32))
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
    _, dk, dv, _, _, delta = _launch_backward(q, k, v, None, None, out, dout, lse, scale,
                                              dq=False)
    return dk, dv, delta


def flash_attention_nonull_bwd_dq(q, k, v, dout, lse, delta, scale: Optional[float] = None):
    """dq (B, Tq, N, D) from the D that flash_attention_nonull_bwd_dkv returns.
    CPU tensors run the twin's dQ; CUDA tensors launch the dQ kernel."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_nonull_bwd_dq_reference(q, k, v, dout, lse, delta, scale)
    refuse_grad("flash_attention_nonull_bwd_dq", q, k, v, dout)
    return _launch_backward(q, k, v, None, None, None, dout, lse, scale, dkv=False,
                            delta=delta)[0]


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
            dq, dk, dv = _launch_backward(q, k, v, None, None, out, dout, lse, ctx.scale)[:3]
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

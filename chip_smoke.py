#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vfm_vae_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from vfm_vae_tpu_torch/csrc/ into
   vfm_vae_tpu_torch/csrc/build/ and prints the build time.
2. Builds the flagship f16d32 SigLIP2-L tokenizer on the card (bf16, random
   weights from a torch.Generator seeded 0).
3. Kernel phases: each forward kernel (K1 fused ConvNeXt MLP, K2 fused
   upsample + blur, K3 null-KV flash attention) runs against its plain
   PyTorch twin at every shape one flagship decode gives it (B=2, bf16, O(1)
   random inputs) and against an fp32 evaluation of the same function;
   prints the errors, the kernel's, twin's and (K3) SDPA's times and the
   bound, and fails past the tolerances below. The same checks run at the
   shapes of the stage-0 EQ buckets (z 4, 8 and 12 px a side), and the K1
   and K2 autograd Functions' gradients are held against an fp32 autograd
   evaluation. K3's backward kernels (dK/dV and dQ) run against their
   plain twin and fp32 autograd at the flagship and EQ sequence lengths,
   and are timed beside the twin and SDPA's forward+backward.
4. Slice phase: answers three encode -> decode requests of B=4 random
   256x256 images through the kernels, checks shapes, finiteness and the
   launch counts per decode, reruns one request with the plain twins
   selected and once more in fp32, prints the latent and pixel agreement,
   and prints the round trip's images/s at two batch sizes.
5. Training phase: the stage-0 trainer (entry.flagship_trainer: full-width,
   full-depth G with the 24-layer SigLIP2-L, the StyleGAN-T D with a
   12-layer DINO ViT-S/16, random-weight LPIPS) takes 1 warm-up and 3 timed
   [D, G] steps at B=4 over EQ buckets drawn from a seeded numpy generator
   plus the three forced kinds; gates on finite losses, nonzero gradients,
   changed trainable and unchanged frozen parameters, a moving EMA and the
   launch counts that entry.kernel_sites predicts; prints ms per D and G
   step, peak memory and a profile of one G step. One deterministic step
   then runs with the kernels, with the plain twins and in fp32, and its
   loss terms and per-module gradient norms are compared.

It needs a CUDA device and exits non-zero without one. The second-to-last
line is the kernel summary JSON; the last line is the device JSON.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Kernel vs plain twin, as fractions of the twin's output scale:
# max |kernel - twin| / max |twin| and mean |kernel - twin| / mean |twin|.
# Both round the same values to bf16 at the same points but sum in another
# order, so a value near a rounding boundary may land one bf16 ulp (2^-8
# relative) apart at each rounding point.
TOLERANCES = {
    # Rounding points x*A, GELU output, output: one output ulp at the top of
    # the range is 2^-7 of the max; hidden flips add noise far below it.
    "fused_convnext_mlp": (2e-2, 2e-3),
    # Five rounding points (affine, depthwise, pointwise, horizontal leg,
    # output); an early flip propagates through the blur.
    "fused_upsample_blur": (3e-2, 3e-3),
    # The kernel rounds unnormalized probabilities to bf16 for the PV
    # product, the twin the normalized ones: two independent ~2^-9 relative
    # roundings per probability plus the output rounding give a mean floor
    # near 2e-3 (measured 2.1e-3 to 2.2e-3 on an H100 at the flagship shapes), so the
    # mean bound is twice that floor.
    "flash_attention_nullkv": (2e-2, 4e-3),
}
# Against the fp32 evaluation (no intermediate rounding) the kernel's mean
# error may exceed the bf16 twin's by at most this factor: the kernel must be
# as close to the exact function as the plain bf16 path is.
TRUTH_FACTOR = 1.5
# End to end, bf16 kernel decode vs bf16 plain decode: mean |diff| / mean
# |plain|. 54 kernel calls chained through 38 residual layers; per-call
# differences are ~1e-3 of scale (above) and add up along the chain.
DECODE_REL_L1 = 3e-2

SOURCES = {
    "fused_convnext_mlp": ("vfm_vae_tpu_torch/csrc/fused_mlp.cu",
                           "vfm_vae_tpu/ops/pallas/fused_mlp.py:229"),
    "fused_upsample_blur": ("vfm_vae_tpu_torch/csrc/fused_upsample.cu",
                            "vfm_vae_tpu/ops/pallas/fused_upsample.py:123"),
    "flash_attention_nullkv": ("vfm_vae_tpu_torch/csrc/flash_attention_nullkv.cu",
                               "vfm_vae_tpu/ops/pallas/flash_attention.py:91"),
    # The library kernels that the JAX K3's custom VJP calls (jax 0.9.0).
    "flash_attention_nullkv_bwd_dkv": (
        "vfm_vae_tpu_torch/csrc/flash_attention_nullkv_bwd.cu",
        "jax/experimental/pallas/ops/tpu/flash_attention.py:941"),
    "flash_attention_nullkv_bwd_dq": (
        "vfm_vae_tpu_torch/csrc/flash_attention_nullkv_bwd.cu",
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1287"),
}
PER_DECODE = {"fused_convnext_mlp": 38, "fused_upsample_blur": 10, "flash_attention_nullkv": 6}
# K3's backward against its twin: the same bounds as the forward (P and dS
# rounded to bf16 at the same points, summed in another order).
BWD_TOLERANCE = TOLERANCES["flash_attention_nullkv"]
# Stage-0 EQ buckets (scale, rot90 angle, is_prior) that the training phase
# forces beside the drawn one: identity, a latent bucket, a prior bucket.
FORCED_BUCKETS = [(1.0, 0, False), (0.5, 1, False), (0.75, 0, True)]
# H100 SXM data-sheet peaks (dense bf16 tensor cores, HBM3), for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-launch CUDA-event times."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def kernel_inputs(name: str, site: dict, B: int, gen, dev):
    import torch

    bf, f32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def uniform(*shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    if name == "fused_convnext_mlp":
        C, H = site["C"], site["H"]
        return dict(
            x=randn(B, H, H, C), x_in=randn(B, H, H, C),
            A=uniform(B, C, lo=0.5, hi=1.5), d=uniform(B, 4 * C, lo=0.5, hi=1.5),
            w1=randn(4 * C, C, scale=C ** -0.5), b1=randn(B, 4 * C, scale=0.5, dtype=f32),
            w2=randn(C, 4 * C, scale=(4 * C) ** -0.5), b2=randn(C, scale=0.1, dtype=f32),
            gamma=randn(C, dtype=f32),
        )
    if name == "fused_upsample_blur":
        Ci, Co, H = site["Ci"], site["Co"], site["H"]
        return dict(
            x=randn(B, H, H, Ci), a=uniform(B, Ci, lo=0.5, hi=1.5),
            c=randn(B, Ci, scale=0.5, dtype=f32), dw=randn(Ci, 3, 3, scale=1 / 3, dtype=f32),
            pw=randn(4 * Co, Ci, scale=Ci ** -0.5), taps=site["taps"],
        )
    T, N, D = site["T"], site["N"], site["D"]
    return dict(
        q=randn(B, T, N, D), k=randn(B, T, N, D), v=randn(B, T, N, D),
        null_k=randn(B, 1, N, D), null_v=randn(B, 1, N, D),
    )


def site_label(site: dict) -> str:
    return " ".join(f"{k}={v if k != 'taps' else len(v)}" for k, v in site.items() if k != "count")


def rel_errors(got, ref):
    diff = (got.float() - ref.float()).abs()
    return (float(diff.max()), float(diff.max()) / max(float(ref.float().abs().max()), 1e-30),
            float(diff.mean()) / max(float(ref.float().abs().mean()), 1e-30))


def work(name: str, site: dict, B: int):
    """(operations, bytes) one call needs: every input read once and every
    output written once; the tensor-core products (K1, K3) or the
    depthwise, pointwise and blur arithmetic (K2)."""
    bf, f4 = 2, 4
    if name == "fused_convnext_mlp":
        C, n = site["C"], B * site["H"] ** 2
        ops = 2 * 2 * n * C * 4 * C
        byts = 3 * n * C * bf + 2 * 4 * C * C * bf + B * (C + 8 * C) * f4 + 2 * C * f4
        return ops, byts
    if name == "fused_upsample_blur":
        Ci, Co, n, kb = site["Ci"], site["Co"], B * site["H"] ** 2, len(site["taps"])
        ops = n * Ci * (2 + 2 * 9 + 2 * 4 * Co) + 2 * 2 * kb * 4 * n * Co
        byts = n * Ci * bf + 4 * n * Co * bf + 4 * Co * Ci * bf + Ci * 9 * f4 + 2 * B * Ci * f4
        return ops, byts
    T, N, D = site["T"], site["N"], site["D"]
    pair = 2 * B * N * T * (T + 1) * D  # one (T x T+1 x D) product
    tok, null, row = B * T * N * D * bf, B * N * D * bf, B * N * T * f4
    if name == "flash_attention_nullkv":  # S = qK^T, O = PV; reads q, k, v, null; writes O
        return 2 * pair, 4 * tok + 2 * null
    if name == "flash_attention_nullkv_bwd_dkv":  # S, dP, dV, dK; D pre-pass; writes dk, dv, D
        return 4 * pair, 7 * tok + 4 * null + 2 * row
    # dq: S, dP, dQ; reads q, k, v, null, dO, L, D; writes dq
    return 3 * pair, 5 * tok + 2 * null + 2 * row


def bound(name: str, sites, B: int):
    """(least ms, "operations" or "bytes") for one call at each site times its count."""
    t_ops = t_bytes = total = 0.0
    for site in sites:
        ops, byts = work(name, site, B)
        a, b = ops / PEAK_BF16_FLOPS * 1e3, byts / PEAK_BYTES_PER_S * 1e3
        total += max(a, b) * site["count"]
        t_ops += a * site["count"]
        t_bytes += b * site["count"]
    return total, ("operations" if t_ops >= t_bytes else "bytes")


def sdpa_inputs(q, k, v, null_k, null_v):
    """(B, N, T, D) views of q and of the concatenated [null; k], [null; v]."""
    import torch

    return (q.transpose(1, 2), torch.cat([null_k, k], dim=1).transpose(1, 2),
            torch.cat([null_v, v], dim=1).transpose(1, 2))


def kernel_phase(sites: dict, B: int = 2, label: str = "kernel", timed: bool = True) -> dict:
    """Kernel vs twin (and vs fp32) at every site; with `timed`, the
    kernel's, twin's and (K3) SDPA's times and the bound."""
    import torch
    import torch.nn.functional as F

    from vfm_vae_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    summary, failed = {}, []
    for fn in kernels.WRAPPERS:
        name = fn.__name__
        tol_max, tol_mean = TOLERANCES[name]
        worst_abs = worst_max = worst_mean = 0.0
        ms_total = plain_total = lib_total = 0.0
        for site in sites[name]:
            args = kernel_inputs(name, site, B, gen, dev)
            got = fn(**args)
            ref = fn(**args, plain=True)
            truth = fn(**{k: (v.float() if torch.is_tensor(v) else v) for k, v in args.items()},
                       plain=True)
            torch.cuda.synchronize()
            max_abs, max_rel, mean_rel = rel_errors(got, ref)
            k_truth, p_truth = rel_errors(got, truth)[2], rel_errors(ref, truth)[2]
            finite = bool(torch.isfinite(got.float()).all())
            ok = (finite and max_rel <= tol_max and mean_rel <= tol_mean
                  and k_truth <= TRUTH_FACTOR * p_truth + 1e-6)
            times = ""
            if timed:
                ms = cuda_time_ms(lambda: fn(**args))
                plain_ms = cuda_time_ms(lambda: fn(**args, plain=True))
                bound_ms, by = bound(name, [dict(site, count=1)], B)
                times = f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({by})"
                if name == "flash_attention_nullkv":
                    qkv = sdpa_inputs(**args)
                    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(*qkv))
                    lib_total += lib_ms * site["count"]
                    times += f" sdpa_ms={lib_ms:.4f}"
                ms_total += ms * site["count"]
                plain_total += plain_ms * site["count"]
            print(f"[{label}] {name} {site_label(site)} B={B}: max_abs={max_abs:.3e} "
                  f"max_rel={max_rel:.3e} (tol {tol_max:g}) mean_rel={mean_rel:.3e} "
                  f"(tol {tol_mean:g}) vs_fp32 kernel={k_truth:.3e} plain={p_truth:.3e} "
                  f"finite={finite} {times} x{site['count']}/decode {'OK' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failed.append(f"{name} {site_label(site)}")
            worst_abs = max(worst_abs, max_abs)
            worst_max, worst_mean = max(worst_max, max_rel), max(worst_mean, mean_rel)
        bound_ms, by = bound(name, sites[name], B)
        summary[name] = dict(max_abs_err=worst_abs, ms=ms_total, plain_ms=plain_total,
                             bound_ms=bound_ms, bound_by=by,
                             library_ms=lib_total if name == "flash_attention_nullkv" else None)
        if timed:
            print(f"[{label}] {name}: all sites of one decode at B={B}: kernel {ms_total:.4f} ms, "
                  f"plain {plain_total:.4f} ms, bound {bound_ms:.4f} ms ({by})"
                  + (f", sdpa {lib_total:.4f} ms" if name == "flash_attention_nullkv" else ""),
                  flush=True)
    if failed:
        raise SystemExit(f"chip_smoke: {label} phase FAILED at {failed}")
    return summary


def function_grad_phase(flagship_sites: dict, eq_sites: dict, B: int = 2) -> None:
    """The K1 and K2 autograd Functions (kernel forward, ported backward) on
    bf16 inputs against fp32 autograd of the plain twin and against the
    all-plain bf16 Function, at one flagship and one EQ site each."""
    import torch

    from vfm_vae_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    failed = []
    for fn in (kernels.fused_convnext_mlp, kernels.fused_upsample_blur):
        name = fn.__name__
        for tag, site in (("flagship", flagship_sites[name][-1]), ("eq", eq_sites[name][0])):
            args = kernel_inputs(name, site, B, gen, dev)
            keys = [k for k, v in args.items() if torch.is_tensor(v)]
            extra = {k: v for k, v in args.items() if not torch.is_tensor(v)}

            def grads(plain: bool, fp32: bool):
                leaves = {k: (args[k].float() if fp32 else args[k]).detach().requires_grad_()
                          for k in keys}
                out = fn(**leaves, **extra, plain=plain)
                if out.grad_fn is None:
                    raise SystemExit(f"chip_smoke: {name} output has no grad_fn")
                g = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(5),
                                device=dev).to(out.dtype)
                return torch.autograd.grad(out, list(leaves.values()), g)

            before = fn.launches
            kern, plain, truth = grads(False, False), grads(True, False), grads(True, True)
            torch.cuda.synchronize()
            if fn.launches != before + 1:
                raise SystemExit(f"chip_smoke: {name} Function did not launch its kernel")
            for k, a, b, c in zip(keys, kern, plain, truth):
                k32, p32 = rel_errors(a, c)[2], rel_errors(b, c)[2]
                finite = bool(torch.isfinite(a.float()).all())
                ok = finite and k32 <= TRUTH_FACTOR * p32 + 1e-6
                print(f"[grad] {name} {tag} {site_label(site)} d{k}: vs_fp32 kernel={k32:.3e} "
                      f"plain={p32:.3e} finite={finite} {'OK' if ok else 'FAIL'}", flush=True)
                if not ok:
                    failed.append(f"{name} {tag} d{k}")
    if failed:
        raise SystemExit(f"chip_smoke: Function gradient phase FAILED at {failed}")


def k3_backward_phase(flagship_sites, eq_T, B: int = 2) -> dict:
    """K3's backward kernels against their plain twin and fp32 autograd at
    every flagship and EQ sequence length; times of the kernels, the twins,
    and forward+backward of the K3 Function and of SDPA over [null; k]."""
    import torch
    import torch.nn.functional as F

    from vfm_vae_tpu_torch.ops import kernels
    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    tol_max, tol_mean = BWD_TOLERANCE
    names = ("dq", "dk", "dv", "dnull_k", "dnull_v")
    flag_T = {s["T"] for s in flagship_sites}
    sites = list(flagship_sites) + [dict(flagship_sites[0], T=T, count=0)
                                    for T in sorted(set(eq_T) - flag_T)]
    acc = {n: dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0) for n in
           ("flash_attention_nullkv_bwd_dkv", "flash_attention_nullkv_bwd_dq")}
    fb = dict(ms=0.0, library_ms=0.0)
    failed = []
    for site in sites:
        args = kernel_inputs("flash_attention_nullkv", site, B, gen, dev)
        q, k, v, nk, nv = (args[n] for n in ("q", "k", "v", "null_k", "null_v"))
        dout = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        out, lse = fa._launch_forward(q, k, v, nk, nv, 0.125, True)
        dk, dv, dnk, dnv, delta = kernels.flash_attention_nullkv_bwd_dkv(
            q, k, v, nk, nv, out, dout, lse)
        dq = kernels.flash_attention_nullkv_bwd_dq(q, k, v, nk, nv, dout, lse, delta)
        twin = kernels.flash_attention_nullkv_bwd_reference(q, k, v, nk, nv, out, lse, dout)
        leaves = [t.float().requires_grad_() for t in (q, k, v, nk, nv)]
        truth = torch.autograd.grad(kernels.flash_attention_nullkv_reference(*leaves),
                                    leaves, dout.float())
        torch.cuda.synchronize()
        line = []
        for n, a, b, c in zip(names, (dq, dk, dv, dnk, dnv), twin[:5], truth):
            max_abs, max_rel, mean_rel = rel_errors(a, b)
            k32, p32 = rel_errors(a, c)[2], rel_errors(b, c)[2]
            finite = bool(torch.isfinite(a.float()).all())
            ok = (finite and max_rel <= tol_max and mean_rel <= tol_mean
                  and k32 <= TRUTH_FACTOR * p32 + 1e-6)
            line.append(f"{n} max_rel={max_rel:.3e} mean_rel={mean_rel:.3e} "
                        f"vs_fp32 kernel={k32:.3e} plain={p32:.3e}{'' if ok else ' FAIL'}")
            if not ok:
                failed.append(f"T={site['T']} {n}")
            key = "flash_attention_nullkv_bwd_dq" if n == "dq" else "flash_attention_nullkv_bwd_dkv"
            acc[key]["max_abs_err"] = max(acc[key]["max_abs_err"], max_abs)
        dkv_ms = cuda_time_ms(lambda: kernels.flash_attention_nullkv_bwd_dkv(
            q, k, v, nk, nv, out, dout, lse))
        dq_ms = cuda_time_ms(lambda: kernels.flash_attention_nullkv_bwd_dq(
            q, k, v, nk, nv, dout, lse, delta))
        dkv_plain = cuda_time_ms(lambda: kernels.flash_attention_nullkv_bwd_dkv_reference(
            q, k, v, nk, nv, out, lse, dout))
        dq_plain = cuda_time_ms(lambda: kernels.flash_attention_nullkv_bwd_dq_reference(
            q, k, v, nk, nv, dout, lse, delta))
        kl = [t.detach().requires_grad_() for t in (q, k, v, nk, nv)]
        fb_ms = cuda_time_ms(lambda: torch.autograd.grad(
            kernels.flash_attention_nullkv(*kl), kl, dout))
        sl = [t.detach().requires_grad_() for t in sdpa_inputs(q, k, v, nk, nv)]
        sdpa_fb = cuda_time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*sl), sl, dout.transpose(1, 2)))
        n_call = site["count"]
        for key, ms, pm in (("flash_attention_nullkv_bwd_dkv", dkv_ms, dkv_plain),
                            ("flash_attention_nullkv_bwd_dq", dq_ms, dq_plain)):
            acc[key]["ms"] += ms * n_call
            acc[key]["plain_ms"] += pm * n_call
        fb["ms"] += fb_ms * n_call
        fb["library_ms"] += sdpa_fb * n_call
        b_dkv = bound("flash_attention_nullkv_bwd_dkv", [dict(site, count=1)], B)
        b_dq = bound("flash_attention_nullkv_bwd_dq", [dict(site, count=1)], B)
        print(f"[k3-bwd] T={site['T']} B={B} N={site['N']}: " + "; ".join(line), flush=True)
        print(f"[k3-bwd] T={site['T']} B={B}: dkv_ms={dkv_ms:.4f} (plain {dkv_plain:.4f}, bound "
              f"{b_dkv[0]:.4f} {b_dkv[1]}) dq_ms={dq_ms:.4f} (plain {dq_plain:.4f}, bound "
              f"{b_dq[0]:.4f} {b_dq[1]}) fwd+bwd: K3 {fb_ms:.4f} ms, sdpa {sdpa_fb:.4f} ms "
              f"x{n_call}/decode", flush=True)
    if failed:
        raise SystemExit(f"chip_smoke: K3 backward phase FAILED at {failed}")
    for key in acc:
        acc[key]["bound_ms"], acc[key]["bound_by"] = bound(key, flagship_sites, B)
        acc[key]["library_ms"] = None
    print(f"[k3-bwd] all flagship sites of one decode at B={B}: dkv "
          f"{acc['flash_attention_nullkv_bwd_dkv']['ms']:.4f} ms, dq "
          f"{acc['flash_attention_nullkv_bwd_dq']['ms']:.4f} ms; forward+backward K3 "
          f"{fb['ms']:.4f} ms, sdpa {fb['library_ms']:.4f} ms", flush=True)
    return acc, fb


def randomize_zero_init_branches(G, seed: int) -> None:
    """Give the zero/tiny-initialised branches (layer scale, legacy noise
    strength, attention/FF output projections, null KV) O(0.1-1) values, so
    that every kernel's output reaches the decoded image."""
    import torch

    gen = torch.Generator(device=next(G.parameters()).device).manual_seed(seed)

    def zero_init(name: str) -> bool:
        layer_scale = name.endswith(".gamma") and (".conv0." in name or ".convs1." in name)
        return (layer_scale or name.endswith((".noise_strength", ".null_kv", ".to_out.weight"))
                or (".ff.3." in name and name.endswith(".weight")))

    with torch.no_grad():
        for name, p in G.named_parameters():
            if zero_init(name):
                u = torch.rand(p.shape, generator=gen, device=p.device) * 0.9 + 0.1
                sign = torch.randint(0, 2, p.shape, generator=gen, device=p.device) * 2 - 1
                fan = p.shape[1] if p.dim() == 4 else 1
                p.copy_(u * sign / math.sqrt(fan))


def psnr(a, b, peak: float = 2.0) -> float:
    mse = float((a.float() - b.float()).square().mean())
    return float("inf") if mse == 0 else 10 * math.log10(peak * peak / mse)


def rel_l1(a, b) -> float:
    return float((a.float() - b.float()).abs().mean()) / max(float(b.float().abs().mean()), 1e-30)


def slice_phase(G, card: str) -> dict:
    """Three requests through the kernels, launch counts, plain and fp32 reruns, img/s."""
    import torch

    from vfm_vae_tpu_torch.entry import FLAGSHIP_KWARGS
    from vfm_vae_tpu_torch.models.generator import Generator
    from vfm_vae_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    B, n_req = 4, 3
    requests = [torch.rand((B, 256, 256, 3), generator=gen, device=dev) for _ in range(n_req)]

    kernels.reset_launch_counts()
    outs = []
    for img in requests:
        z = G.encode(img)
        outs.append((z, G.decode(z)))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"[slice] launches over {n_req} requests: {launches}", flush=True)
    for name, per in PER_DECODE.items():
        if launches[name] != per * n_req:
            raise SystemExit(f"chip_smoke: {name} launched {launches[name]} times, "
                             f"expected {per} per decode x {n_req}")
    for i, (z, x) in enumerate(outs):
        if tuple(z.shape) != (B, 16, 16, 32) or tuple(x.shape) != (B, 256, 256, 3):
            raise SystemExit(f"chip_smoke: request {i}: shapes {tuple(z.shape)} {tuple(x.shape)}")
        if not (torch.isfinite(z).all() and torch.isfinite(x).all()):
            raise SystemExit(f"chip_smoke: request {i}: non-finite output")
    print(f"[slice] {n_req} requests OK: z {tuple(outs[0][0].shape)} img {tuple(outs[0][1].shape)}"
          f" img mean|x| {float(outs[0][1].abs().mean()):.4f}", flush=True)

    # The same request with the plain twins selected, and in fp32.
    z_k, x_k = outs[0]
    G.use_plain_kernels(True)
    z_p = G.encode(requests[0])
    x_p = G.decode(z_k)
    G.use_plain_kernels(False)
    G32 = Generator(**FLAGSHIP_KWARGS, dtype=torch.float32, device=dev)
    G32.load_state_dict(G.state_dict())
    G32.use_plain_kernels(True)
    z_32 = G32.encode(requests[0])
    x_32 = G32.decode(z_k.float())
    torch.cuda.synchronize()
    del G32
    torch.cuda.empty_cache()
    dec_kp = rel_l1(x_k, x_p)
    dec_k32, dec_p32 = rel_l1(x_k, x_32), rel_l1(x_p, x_32)
    print(f"[slice] latent rel-L1: kernel path vs plain {rel_l1(z_k, z_p):.3e}, "
          f"bf16 vs fp32 {rel_l1(z_k, z_32):.3e}", flush=True)
    print(f"[slice] decode: kernel vs plain rel-L1 {dec_kp:.3e} (tol {DECODE_REL_L1:g}) "
          f"PSNR {psnr(x_k, x_p):.2f} dB; vs fp32 rel-L1 kernel {dec_k32:.3e} plain {dec_p32:.3e}, "
          f"PSNR kernel {psnr(x_k, x_32):.2f} dB plain {psnr(x_p, x_32):.2f} dB", flush=True)
    if not (dec_kp <= DECODE_REL_L1 and dec_k32 <= TRUTH_FACTOR * dec_p32 + 1e-6):
        raise SystemExit("chip_smoke: kernel decode disagrees with the plain / fp32 decode")

    for bs in (4, 32):
        img = torch.rand((bs, 256, 256, 3), generator=gen, device=dev)
        G.decode(G.encode(img))
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            G.decode(G.encode(img))
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        print(f"[slice] round trip B={bs}: {dt * 1e3:.1f} ms/batch, {bs / dt:.2f} img/s "
              f"on {card} (first reading, random weights)", flush=True)
    profile_round_trip(G, img)
    return launches


def profile_round_trip(G, img, top: int = 15) -> None:
    """Device time by kernel over one round trip (torch.profiler / CUPTI)."""
    profile_device(lambda: G.decode(G.encode(img)), f"round trip B={img.shape[0]}", top)


def profile_device(fn, label: str, top: int = 15) -> None:
    """Wall time, device busy time, idle share and the top device ops of one
    call of `fn` (torch.profiler / CUPTI)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if busy_ms == 0:
        print("[profile] no device time recorded: device breakdown not measured", flush=True)
        return
    print(f"[profile] {label}: wall {wall_ms:.1f} ms (profiler on), device "
          f"busy {busy_ms:.1f} ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"[profile] {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{e.count:<4d} {e.key[:100]}",
              flush=True)


def bn_fed_bias(name: str) -> bool:
    """A D head's conv bias that feeds BatchNormLocal: the mean subtraction
    makes its gradient exactly zero in exact arithmetic (rounding noise on
    the card), so the gradient gates hold it apart."""
    return name.startswith("D.heads.") and name.endswith((".main0.conv.bias",
                                                          ".main1.conv.bias"))


def predicted_launches(G, buckets) -> dict:
    """Launches of one [D, G] step per bucket: G runs forward in the D phase
    and in the G phase (K1-K3 forward at each site of that bucket's decode),
    and two backward passes reach the decoder in the G phase (the adaptive
    VF weight's pull of the reconstruction terms and the training pull), each
    running K3's two backward kernels at every attention site. The VF pull
    stops at z; K1 and K2 backward are PyTorch."""
    from vfm_vae_tpu_torch.entry import eq_image_size, kernel_sites
    from vfm_vae_tpu_torch.ops import kernels

    want = {fn.__name__: 0 for fn in kernels.ALL_WRAPPERS}
    for eq in buckets:
        sites = kernel_sites(G, eq_image_size(G, eq))
        for name, ss in sites.items():
            want[name] += 2 * sum(s["count"] for s in ss)
        n_att = sum(s["count"] for s in sites["flash_attention_nullkv"])
        want["flash_attention_nullkv_bwd_dkv"] += 2 * n_att
        want["flash_attention_nullkv_bwd_dq"] += 2 * n_att
    return want


def named_params(tr) -> dict:
    return {**{"G." + n: p for n, p in tr.G.named_parameters()},
            **{"D." + n: p for n, p in tr.D.named_parameters()},
            **{"L." + n: p for n, p in tr.loss.lpips.named_parameters()}}


def train_phase(card: str, B: int = 4):
    """Stage-0 [D, G] steps at flagship width through entry.flagship_trainer."""
    import numpy as np
    import torch

    from vfm_vae_tpu_torch.entry import STAGE0_EQ, flagship_trainer
    from vfm_vae_tpu_torch.models.adapter import EquivarianceTransform
    from vfm_vae_tpu_torch.ops import kernels
    from vfm_vae_tpu_torch.train.train_step import G_STAT_NAMES

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    t0 = time.perf_counter()
    tr = flagship_trainer(dev, B, gen, allow_random_lpips=True)
    randomize_zero_init_branches(tr.G, seed=2)
    torch.cuda.synchronize()
    params = named_params(tr)
    trainable = {"G." + n for n in tr.g_params} | {"D." + n for n in tr.d_params}
    frozen = [n for n in params if n not in trainable]
    n_all = sum(p.numel() for p in params.values())
    n_tr = sum(params[n].numel() for n in trainable)
    print(f"[train] stage-0 trainer: {n_all / 1e6:.1f} M parameters ({n_tr / 1e6:.1f} M "
          f"trainable: {len(tr.g_params)} G and {len(tr.d_params)} D tensors), built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if any(n.startswith(("G.vfm_encoder.", "D.dino.", "L.")) for n in trainable):
        raise SystemExit("chip_smoke: a SigLIP, DINO or LPIPS parameter is trainable")

    eqt = EquivarianceTransform(True, **STAGE0_EQ)
    buckets = [eqt(np.random.default_rng(5))] + FORCED_BUCKETS
    res = tr.G.synthesis.block_resolutions[-1]
    reals = [torch.rand((B, res, res, 3), generator=gen, device=dev) for _ in buckets]
    before = {n: p.detach().clone() for n, p in params.items()}
    state = tr.init_state()
    ema0 = {k: v.clone() for k, v in state.ema.items()}
    want = predicted_launches(tr.G, buckets)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    tr.record_grad_norms = True
    d_ms, g_ms, first_norms = [], [], None
    for i, (eq, img) in enumerate(zip(buckets, reals)):
        t0 = time.perf_counter()
        state, d_stats, d_total = tr.d_step(state, img, eq, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, g_stats, g_total = tr.g_step(state, img, eq, gen)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        d_ms.append((t1 - t0) * 1e3)
        g_ms.append((t2 - t1) * 1e3)
        if i == 0:
            first_norms, tr.record_grad_norms = dict(tr.grad_norms), False
        stats = {**d_stats, **g_stats}
        vals = torch.stack([v for v in stats.values()] + [d_total.reshape(1).expand(3),
                                                          g_total.reshape(1).expand(3)])
        if not bool(torch.isfinite(vals).all()):
            raise SystemExit(f"chip_smoke: step {i}: a loss term is not finite")
        mean = {k: float(v[1] / v[0]) for k, v in stats.items()}
        terms = " ".join(f"{n}={mean[G_STAT_NAMES[n]]:.4g}" for n in
                         ("l1_pixel_loss", "perceptual_loss", "multiscale_pixel_loss",
                          "stylegan_t_gen_loss", "vf_loss", "kl_loss"))
        print(f"[train] step {i} ({'warm-up' if i == 0 else 'timed'}) eq={eq} z "
              f"{tr.G.ldm_adapter.z_resolution * eq[0]:g} px: D {d_ms[-1]:.1f} ms G "
              f"{g_ms[-1]:.1f} ms; D total {float(d_total):.4g} G total {float(g_total):.4g} "
              f"{terms} vf_w={mean['Loss/G/cur_vf_loss_weight']:.4g}", flush=True)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[train] launches over {len(buckets)} [D, G] steps: {launches}; predicted {want}",
          flush=True)
    if launches != want:
        raise SystemExit("chip_smoke: training launch counts differ from kernel_sites' prediction")
    print(f"[train] B={B} on {card}: D step {statistics.median(d_ms[1:]):.1f} ms, G step "
          f"{statistics.median(g_ms[1:]):.1f} ms (median of the 3 timed steps; D "
          f"{', '.join(f'{x:.1f}' for x in d_ms[1:])}, G {', '.join(f'{x:.1f}' for x in g_ms[1:])}); "
          f"peak memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated)", flush=True)

    after = named_params(tr)
    zero = sorted(n for n in trainable if first_norms[n] == 0 and not bn_fed_bias(n))
    unchanged = sorted(n for n in trainable
                       if torch.equal(before[n], after[n]) and not bn_fed_bias(n))
    moved = sorted(n for n in frozen if not torch.equal(before[n], after[n]))
    still = sorted(k for k in state.ema if torch.equal(ema0[k], state.ema[k]))
    bn = sorted(n for n in trainable if bn_fed_bias(n))
    print(f"[train] first step: {sum(first_norms[n] > 0 for n in trainable)}/{len(trainable)} "
          f"trainable tensors with a nonzero gradient (min "
          f"{min(first_norms[n] for n in trainable if not bn_fed_bias(n)):.3e}); "
          f"{len(bn)} BatchNormLocal-fed head biases (zero in exact arithmetic) had norms up to "
          f"{max(first_norms[n] for n in bn):.3e}", flush=True)
    print(f"[train] after {len(buckets)} steps: {len(trainable) - len(unchanged)}/{len(trainable)} "
          f"trainable tensors changed, {len(frozen) - len(moved)}/{len(frozen)} frozen (SigLIP, "
          f"DINO, LPIPS) unchanged bit for bit, {len(state.ema) - len(still)}/{len(state.ema)} "
          f"EMA tensors moved, cur_nimg {state.cur_nimg}", flush=True)
    if zero or unchanged or moved or still or state.cur_nimg != B * len(buckets):
        raise SystemExit(f"chip_smoke: training gates failed: zero grad {zero[:4]}, unchanged "
                         f"{unchanged[:4]}, frozen moved {moved[:4]}, EMA still {still[:4]}")
    del before, ema0
    profile_device(lambda: tr.g_step(state, reals[1], buckets[1], gen),
                   f"G step B={B} eq={buckets[1]}")
    return tr, state, reals[0], launches


def determinism_phase(tr, state, real, eq=(1.0, 0, False)) -> None:
    """One [D, G] step with no random draws (posterior mode, no DiffAugment,
    D resizes instead of cropping), without the update: the kernel path, the
    plain-twin path (bf16) and an fp32 plain copy on the same weights and
    batch. Each loss term and each module's gradient norm of the kernel path
    must be as close to fp32 as the plain bf16 path is: TRUTH_FACTOR on the
    median relative error. The median, because a few quantities (a D head's
    gradient, which hangs on the statistics of four images) move by several
    percent between any two bf16 evaluations and would decide a mean alone."""
    import torch

    from vfm_vae_tpu_torch.entry import flagship_trainer
    from vfm_vae_tpu_torch.train.loss import G_TERMS

    dev = real.device
    bufs = {"G": {k: v.clone() for k, v in tr.G.named_buffers()},
            "D": {k: v.clone() for k, v in tr.D.named_buffers()}}

    def run(t, st):
        for mod, key in ((t.G, "G"), (t.D, "D")):  # spectral-norm u/v and x_avg as they were
            for k, v in mod.named_buffers():
                v.copy_(bufs[key][k])
        t.record_grad_norms, t.grad_norms = True, {}
        _, d_total, aux = t.d_gradients(st, real, eq)
        _, terms, _, _, g_total = t.g_gradients(st, real, eq, update_buffers=False)
        t.record_grad_norms = False
        out = {"D total": float(d_total), "G total": float(g_total)}
        out.update({"G " + n: float(v) for n, v in zip(G_TERMS, terms) if float(v) != 0.0})
        groups = {}
        for n, v in t.grad_norms.items():
            key = ".".join(n.split(".")[:4])
            groups[key] = groups.get(key, 0.0) + v * v
        out.update({"|grad| " + k: math.sqrt(v) for k, v in groups.items()})
        return out

    kern = run(tr, state)
    tr.G.use_plain_kernels(True)
    plain = run(tr, state)
    tr.G.use_plain_kernels(False)
    tr32 = flagship_trainer(dev, real.shape[0], torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.float32, allow_random_lpips=True)
    tr32.G.load_state_dict(tr.G.state_dict())
    tr32.D.load_state_dict(tr.D.state_dict())
    tr32.loss.lpips.load_state_dict(tr.loss.lpips.state_dict())
    tr32.G.use_plain_kernels(True)
    exact = run(tr32, tr32.init_state())
    del tr32
    torch.cuda.empty_cache()
    keys = [k for k in exact if exact[k] != 0.0]
    ek = [abs(kern[k] - exact[k]) / abs(exact[k]) for k in keys]
    ep = [abs(plain[k] - exact[k]) / abs(exact[k]) for k in keys]
    for k, a, b in zip(keys, ek, ep):
        print(f"[determinism] {k}: fp32 {exact[k]:.6g} kernel {kern[k]:.6g} (rel {a:.2e}) "
              f"plain {plain[k]:.6g} (rel {b:.2e})", flush=True)
    mk, mp = statistics.median(ek), statistics.median(ep)
    ok = mk <= TRUTH_FACTOR * mp + 1e-6
    print(f"[determinism] {len(keys)} quantities (loss terms, per-module gradient norms): median "
          f"relative error vs fp32 kernel {mk:.3e} plain {mp:.3e} (limit {TRUTH_FACTOR} x plain; "
          f"means {sum(ek) / len(ek):.3e} and {sum(ep) / len(ep):.3e}) {'OK' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit("chip_smoke: the kernel training step is further from fp32 than the "
                         "plain bf16 step")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "vfm_vae_tpu_torch")):
        raise SystemExit("chip_smoke: the vfm_vae_tpu_torch package is not beside this script")
    sys.path.insert(0, HERE)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from vfm_vae_tpu_torch.entry import flagship_generator, kernel_sites
    from vfm_vae_tpu_torch.ops.kernels._build import library

    card = gpu_line()
    print(card, flush=True)  # nvidia-smi's name and power limit, verbatim
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    lib = library()
    print(f"[build] {lib.path.name} in {lib.build_seconds:.1f} s", flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    G = flagship_generator(dev, torch.bfloat16, torch.Generator(device=dev).manual_seed(0))
    randomize_zero_init_branches(G, seed=1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in G.parameters())
    print(f"[slice] flagship Generator: {n_params / 1e6:.1f} M parameters, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    sites = kernel_sites(G, 256)
    for name, per in PER_DECODE.items():
        n = sum(s["count"] for s in sites[name])
        if n != per:
            raise SystemExit(f"chip_smoke: {name}: {n} sites per decode, expected {per}")
    summary = kernel_phase(sites)
    # The stage-0 EQ buckets shrink z to 4, 8 or 12 px a side (scale 0.25,
    # 0.5, 0.75): odd sizes and partial tiles for every kernel.
    eq_sites = {hw: kernel_sites(G, hw) for hw in (64, 128, 192)}
    for hw, s in eq_sites.items():
        kernel_phase(s, label=f"kernel-eq{hw}", timed=False)
    function_grad_phase(sites, eq_sites[64])
    eq_T = sorted({s["T"] for ss in eq_sites.values() for s in ss["flash_attention_nullkv"]})
    bwd, k3_fb = k3_backward_phase(sites["flash_attention_nullkv"], eq_T)
    summary.update(bwd)
    summary["flash_attention_nullkv"].update(
        fwd_bwd_ms=k3_fb["ms"], library_fwd_bwd_ms=k3_fb["library_ms"])

    launches = {"round_trip": slice_phase(G, card)}
    del G
    torch.cuda.empty_cache()
    tr, state, real, launches["train_step"] = train_phase(card)
    determinism_phase(tr, state, real)

    entries = []
    for name, s in summary.items():
        by_path = {path: counts.get(name, 0) for path, counts in launches.items()}
        entries.append(dict(name=name, route="cuda", source=SOURCES[name][0],
                            replaces=SOURCES[name][1], launches=sum(by_path.values()),
                            launches_by_path=by_path, **s))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

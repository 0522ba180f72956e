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
   The encoder's kernels: K6 (fused int8 quantize + GEMM, dynamic and
   static scale) and K10 (its bare int8 GEMM) against their plain twins,
   bit for bit and bit-identical on repeat, at every tower Linear shape of
   one encode at B=2 and B=32, at two ragged shapes and on a constructed
   case of exact halves (half to even), with the kernel's events and
   device times, the twin's, K6 static beside cuBLAS bf16 and K10 beside
   torch._int_mm + >>8 in turns, TOP/s and the fraction of the bound; K4
   (flash attention without a null token) against its twin and a float64
   evaluation at the tower's bf16 site, the adapter's fp32 sites and one
   d=128 shape, with SDPA's time and the bound. The K3 and K4 flash rows
   print CUDA-event and device times of the kernel and of SDPA on the same
   inputs, TFLOP/s and the fraction of the bound; the bf16 forward is also
   held and timed at the offline batch B=32 at its device-bound shapes (the
   tower's, d=128, K3's T=1024 site), and so is the bf16 backward (one
   library call: pre-pass, dK/dV and dQ kernels; bit-identical on repeat),
   with each kernel's device time and fraction of its bound beside SDPA's
   backward alone. The K3 and K4 backward rows carry the kernels' device
   times and SDPA's backward time.
   K1 and K9 ([kernel-mlp]) are held (twin, fp32, bit-identical repeats,
   K9 == K1) and timed at every flagship K1 site at B=2 and B=32: events
   and device time, the fraction of the bound (tensor cores, bytes and the
   GELU on the CUDA cores, its SASS instruction count read from the built
   library) and, in turns, a cuBLAS composition (two cuBLAS bf16 GEMMs and
   PyTorch elementwise steps that store the hidden: a yardstick, not the
   same function).
   K2 ([kernel-upsample]) is held at every flagship K2 site at B=2 and
   B=32: against its twin and fp32, bit-identical on a second call, one
   launch a call (the wrapper's counter and the profiler's kernel count),
   with its events and device time beside the bound. K4's fp32 forward
   (3xTF32 on wgmma; its SASS is checked for TF32 HGMMA and no FFMA main
   loop at the build) is held at the adapter's sites at B=2 and B=32, at
   ragged Tq != Tk and at d=128: against its twin (FLASH_FP32_MAX_REL, max
   and mean), its log-sum-exp against the twin's, against float64
   (TRUTH_FACTOR), bit-identical on repeat, one launch a call by the
   wrapper's counter and one kernel a call by the profiler; and it is timed
   against SDPA's fp32 forward in turns (events and device time) at the
   adapter's sites at B=2 and B=32, with the fraction of its 3xTF32 bound.
4. Slice phase: answers three encode -> decode requests of B=4 random
   256x256 images through the kernels, checks shapes, finiteness and the
   launch counts per decode, reruns one request with the plain twins
   selected and once more in fp32, prints the latent and pixel agreement,
   and prints the round trip's images/s at two batch sizes.
5. Int8 serving phase (the README's fast serving configuration, bench.py's
   run_int8): with VFM_VAE_USE_PALLAS_FLASH=1 and VFM_VAE_ADAPTER_ATTN=
   3mm-flash, enable_int8_tower calibrates the tower on 32 random images,
   three encode -> decode requests of B=4 run through K6, K4 and K1-K3;
   gates on shapes, finiteness and the launch counts entry.kernel_sites
   predicts. K10 then runs once at each served K6 shape as K6's ceiling
   probe, counted as a path of its own (serving never runs it). One more
   int8 encode holds every K6 and K4 site against its twin on that site's
   own inputs, and the int8 moments' and decode's distance from fp32 is
   held against the all-plain int8 path's; prints the int8-vs-bf16 drift,
   encode-only and round-trip img/s with the bf16 and the int8 tower at
   B=4 and B=32, and a profile of one int8 encode.
6. Training phase: the stage-0 trainer (entry.flagship_trainer: full-width,
   full-depth G with the 24-layer SigLIP2-L, the StyleGAN-T D with a
   12-layer DINO ViT-S/16, random-weight LPIPS) takes 1 warm-up and 3 timed
   [D, G] steps at B=4 over EQ buckets drawn from a seeded numpy generator
   plus the three forced kinds; gates on finite losses, a nonzero gradient
   and a move in some step for every trainable tensor, unchanged frozen
   parameters, a moving EMA and the launch counts that
   entry.kernel_sites predicts; prints ms per D and G
   step, peak memory and a profile of one G step. One deterministic step
   then runs with the kernels, with the plain twins and in fp32, and its
   loss terms and per-module gradient norms are compared quantity by
   quantity (--determinism-trials N repeats it on N batches).
7. The opt-in kernels and K4's backward: K5 (GroupNorm moments) against
   its twin and fp64 sums at every K5 site of a decode and the EQ shapes,
   repeatable bit for bit, one kernel a call by the profiler's count; K9
   (K1 pipelined) against K1 at every K1 site, 0 ulps, and each
   bit-identical on repeat; K7 and K8 (depthwise conv + statistics, and without) against
   their twins at every ConvNeXt dwconv shape; K4's backward against its
   twin and fp64 at the training path's sites (the adapter's fp32 sites,
   3xTF32 kernels, held to FLASH_FP32_MAX_REL against the twin) at B=2 and
   at the stage-0 step's B=4, at ragged fp32 shapes and d=128, bit for bit
   on repeat, the one-call backward timed against SDPA's backward in turns
   (CUDA events and device time, SDPA's kernels by name). With every
   opt-in switch of the JAX package on (ALL_SWITCHES), three round-trip
   requests and the stage-0 steps run under the gates above, with img/s
   and step times beside the default path in turns; the dwconv probe
   launches K7 and K8 at the 38 dwconvs of a decode in a window of their
   own.

It needs a CUDA device and exits non-zero without one. The second-to-last
line is the kernel summary JSON; the last line is the device JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
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
    # K4, K6 and K10 (the encoder's kernels).
    "flash_attention_nonull": ("vfm_vae_tpu_torch/csrc/flash_attention_nullkv.cu",
                               "vfm_vae_tpu/ops/pallas/flash_attention.py:53"),
    "int8_matmul": ("vfm_vae_tpu_torch/csrc/int8_matmul.cu",
                    "vfm_vae_tpu/ops/pallas/int8_matmul.py:60"),
    "int8_matmul_raw": ("vfm_vae_tpu_torch/csrc/int8_matmul.cu", "tools/bench_int8_kernel.py:132"),
    # K4's backward (the library kernels behind the JAX K4's custom VJP), K5,
    # K9, and the dwconv probe's K7 and K8.
    "flash_attention_nonull_bwd_dkv": (
        "vfm_vae_tpu_torch/csrc/flash_attention_nullkv_bwd.cu",
        "jax/experimental/pallas/ops/tpu/flash_attention.py:941"),
    "flash_attention_nonull_bwd_dq": (
        "vfm_vae_tpu_torch/csrc/flash_attention_nullkv_bwd.cu",
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1287"),
    "channel_moments": ("vfm_vae_tpu_torch/csrc/group_stats.cu",
                        "vfm_vae_tpu/ops/pallas/group_stats.py:44"),
    "fused_convnext_mlp_pipelined": ("vfm_vae_tpu_torch/csrc/fused_mlp.cu",
                                     "vfm_vae_tpu/ops/pallas/fused_mlp.py:150"),
    "dwconv_noise_stats": ("vfm_vae_tpu_torch/csrc/dwconv_stats.cu",
                           "vfm_vae_tpu/ops/pallas/dwconv_stats.py:107"),
    "depthwise_conv2d_same": ("vfm_vae_tpu_torch/csrc/dwconv_stats.cu",
                              "vfm_vae_tpu/ops/pallas/dwconv.py:53"),
}
# kernel_sites' entries that no forward pass launches: the dwconv probe's
# kernels, and K4's backward (one launch per training pull through the adapter).
PROBE_KERNELS = ("dwconv_noise_stats", "depthwise_conv2d_same")
K4_BWD = ("flash_attention_nonull_bwd_dkv", "flash_attention_nonull_bwd_dq")
ENCODE_KERNELS = ("flash_attention_nonull", "int8_matmul") + K4_BWD
# K5 and K7's statistics against fp64 sums: |s2 - exact| <= STATS_REL * exact
# and |s1 - exact| <= STATS_REL * sum |x| (fp32 sums over up to 65,536 rows).
STATS_REL = 1e-5
# K7 and K8 against their twins: the same rounding points, the k^2 taps
# summed in another order in the fp32 accumulator: one bf16 ulp of t.
DWCONV_ULPS = 1.0
PER_DECODE = {"fused_convnext_mlp": 38, "fused_upsample_blur": 10, "flash_attention_nullkv": 6}
# SASS instructions of one GELU evaluation in the built K1 (main() reads it
# from the library with cuobjdump; probes/fused_mlp.py:gelu_instructions).
GELU_INSTRUCTIONS = {"count": None}
# K3's backward against its twin: the same bounds as the forward (P and dS
# rounded to bf16 at the same points, summed in another order).
BWD_TOLERANCE = TOLERANCES["flash_attention_nullkv"]
# Stage-0 EQ buckets (scale, rot90 angle, is_prior) that the training phase
# forces beside the drawn one: identity, a latent bucket, a prior bucket.
FORCED_BUCKETS = [(1.0, 0, False), (0.5, 1, False), (0.75, 0, True)]
# H100 SXM data-sheet peaks (dense bf16, TF32 and int8 tensor cores, fp32
# outside the tensor cores, HBM3), for the bounds. fp32 flash work (K4 at the
# adapter) is bound at the 3xTF32 rate, three TF32 products per fp32
# product, with the FMA bound beside it: K4's fp32 forward and backward run
# as 3xTF32.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES_PER_S = 3.35e12
# K6 and K10 against their twins: the same quantize, exact int32 sums and the
# same fp32 epilogue order, so the two agree bit for bit (torch.equal), and
# so do two runs of the kernel; INT8_RAGGED are the card test's shapes off
# the tiles (rows, columns, K steps; N=136 takes K10's direct-store route).
# K4 in bf16 takes K3's bounds; in
# fp32 the kernel and the twin differ in summation order, exp2 vs exp and
# the 3xTF32 products' splits (within 2^-21 of each product): max |kernel -
# twin| <= 1e-5 of max |twin|, and the mean likewise, forward and backward.
INT8_RAGGED = ((77, 4096, 1024), (300, 96, 136))
FLASH_FP32_MAX_REL = 1e-5
# int8 serving holds each K6 and K4 site to the bounds above on that site's
# own inputs (site_checks), not the kernel path's latents to the all-plain
# path's: K4 and its twin round the probabilities at other points (one bf16
# ulp apart, as K3), and the static int8 grid after every attention turns
# such differences into other quantized values downstream, so two paths that
# agree site by site still end as far apart as the int8 tower is from the
# bf16 tower (random weights). End to end, the kernel path is held to fp32
# by TRUTH_FACTOR against the all-plain path.


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def kernel_name(ptxas_line: str) -> str:
    """The kernel and its integer template arguments from ptxas' "Compiling
    entry function '<mangled name>'" line, e.g. flash_fwd_kernel<64, 2>:
    walks the mangled name's length-prefixed parts to the one ending in
    "kernel"."""
    mangled = ptxas_line.split("'")[1] if ptxas_line.count("'") >= 2 else ptxas_line
    pos = 3 if mangled.startswith("_ZN") else 2
    while (m := re.match(r"\d+", mangled[pos:])):
        start = pos + m.end()
        name, pos = mangled[start:start + int(m.group())], start + int(m.group())
        if name.endswith("kernel"):
            args = re.match(r"I((?:Li-?\d+E)+)", mangled[pos:])
            return name + (f"<{', '.join(re.findall(r'Li(-?[0-9]+)E', args.group(1)))}>"
                           if args else "")
    return mangled


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


def in_turns(fn_a, fn_b):
    """CUDA-event times of two alternatives measured in turns (a, b, b, a),
    each the mean of its two medians: this host's speed drifts within a call."""
    a1, b1, b2, a2 = (cuda_time_ms(f) for f in (fn_a, fn_b, fn_b, fn_a))
    return (a1 + a2) / 2, (b1 + b2) / 2


def device_kernels(fn, reps: int = 10):
    """Device time per call of `fn` and of each kernel it launches: the self
    device time of every kernel over `reps` calls in a profiler window
    (torch.profiler / CUPTI), without the host's time between them. Returns
    (ms or None if the profiler saw no device time, {kernel name: ms},
    largest first). The CUDA-event times above include the host's when a
    call's kernels are shorter than its Python and launch overhead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            per[e.key] = per.get(e.key, 0.0) + e.self_device_time_total / 1e3 / reps
    busy = sum(per.values())
    return (busy if busy else None), dict(sorted(per.items(), key=lambda kv: -kv[1]))


def device_ms(fn, reps: int = 10):
    """Device time per call of `fn` (device_kernels), or None."""
    return device_kernels(fn, reps)[0]


def device_launches(fn, reps: int = 5, windows: int = 6) -> dict:
    """{kernel name: launches per call} of `fn` on the card, from the
    profiler's kernel counts over `reps` calls in the active step of a
    profiler schedule (a warm-up step first: CUPTI can miss the first
    kernels of a window). A dropped event can only lower a count, so up to
    `windows` windows are read and the first whose counts are whole numbers
    a call is returned (else the last)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()  # the warm-up step ends; the window closes inside the active one
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = {e.key: e.count / reps for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total
               and not e.key.startswith("ProfilerStep")}  # the step's own range
        if per and all(v == int(v) for v in per.values()):
            return per
    return per


def kernel_ms(per: dict, part: str):
    """Device ms of the kernels in `per` whose name contains `part`, or None."""
    hits = [ms for name, ms in per.items() if part in name]
    return sum(hits) if hits else None


def sdpa_backward(args, dout):
    """A function that runs SDPA's backward alone (dQ, dK and dV in one op)
    on `args` (B, N, T, D) and the output gradient `dout` (B, T, N, D)."""
    import torch
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_() for t in args]
    out = F.scaled_dot_product_attention(*leaves)
    g = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


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


def mlp_terms(site: dict, B: int):
    """K1's three bounds in ms for one call: the tensor-core products at the
    bf16 peak, the bytes at 3.35 TB/s, and the GELU on the CUDA cores: T 4C
    evaluations of GELU_INSTRUCTIONS SASS instructions each (read from the
    built library) over 132 x 128 lanes at the fp32 peak's clock (67 TFLOP/s
    = 2 x 132 x 128 x 1.98 GHz; the special-function unit's lower rate for
    its instructions is not counted)."""
    ops, byts = work("fused_convnext_mlp", site, B)
    lanes = B * site["H"] ** 2 * 4 * site["C"] * GELU_INSTRUCTIONS["count"]
    return (ops / PEAK_BF16_FLOPS * 1e3, byts / PEAK_BYTES_PER_S * 1e3,
            lanes / (PEAK_FP32_FLOPS / 2) * 1e3)


def bound(name: str, sites, B: int):
    """(least ms, "operations" or "bytes") for one call at each site times
    its count; K1 and K9's operations include the GELU (mlp_terms)."""
    t_ops = t_bytes = total = 0.0
    for site in sites:
        ops, byts = work(name, site, B)
        a, b = ops / PEAK_BF16_FLOPS * 1e3, byts / PEAK_BYTES_PER_S * 1e3
        if name == "fused_convnext_mlp":
            a = max(a, mlp_terms(site, B)[2])
        total += max(a, b) * site["count"]
        t_ops += a * site["count"]
        t_bytes += b * site["count"]
    return total, ("operations" if t_ops >= t_bytes else "bytes")


def sdpa_inputs(q, k, v, null_k, null_v):
    """(B, N, T, D) views of q and of the concatenated [null; k], [null; v]."""
    import torch

    return (q.transpose(1, 2), torch.cat([null_k, k], dim=1).transpose(1, 2),
            torch.cat([null_v, v], dim=1).transpose(1, 2))


def add_or_none(total, ms, count: int):
    """total + ms * count, or None once either is None (not measured)."""
    return None if total is None or ms is None else total + ms * count


def flash_rate_text(ms, dev_ms, flops, bound_ms, sdpa_ms, sdpa_dev_ms) -> str:
    """A flash row's times: CUDA-event and device time of the kernel and of
    SDPA on the same inputs, achieved TFLOP/s (by CUDA events and by device
    time) and the fraction of the bound (bound / time)."""
    def rate(t):
        return "not measured" if t is None else f"{flops / t / 1e9:.1f}"

    return (f"device_ms={ms_text(dev_ms)} tflops={rate(ms)} (device {rate(dev_ms)}) "
            f"of_bound={bound_ms / ms:.3f} (device "
            f"{'not measured' if dev_ms is None else f'{bound_ms / dev_ms:.3f}'}) "
            f"sdpa_ms={sdpa_ms:.4f} sdpa_device_ms={ms_text(sdpa_dev_ms)}")


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
        ms_total = plain_total = lib_total = dev_total = 0.0
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
                    dev_ms = device_ms(lambda: fn(**args))
                    times += " " + flash_rate_text(
                        ms, dev_ms, work(name, site, B)[0], bound_ms, lib_ms,
                        device_ms(lambda: F.scaled_dot_product_attention(*qkv)))
                    dev_total = add_or_none(dev_total, dev_ms, site["count"])
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
        if name == "flash_attention_nullkv" and timed:
            summary[name]["device_ms"] = dev_total
        if timed:
            print(f"[{label}] {name}: all sites of one decode at B={B}: kernel {ms_total:.4f} ms, "
                  f"plain {plain_total:.4f} ms, bound {bound_ms:.4f} ms ({by})"
                  + (f", sdpa {lib_total:.4f} ms, kernel device {ms_text(dev_total)} ms"
                     if name == "flash_attention_nullkv" else ""), flush=True)
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
    every flagship and EQ sequence length; CUDA-event and device times of
    the kernels (the dK/dV wrapper with its pre-pass, the dQ wrapper, and
    the one-call backward of the Function), the twins, SDPA's backward alone
    over [null; k], and forward+backward of the K3 Function and of SDPA."""
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
    acc = {n: dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, device_ms=0.0, library_ms=0.0)
           for n in ("flash_attention_nullkv_bwd_dkv", "flash_attention_nullkv_bwd_dq")}
    fb = dict(ms=0.0, library_ms=0.0, bwd_ms=0.0, bwd_device_ms=0.0)
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
        dkv_dev = device_ms(lambda: kernels.flash_attention_nullkv_bwd_dkv(
            q, k, v, nk, nv, out, dout, lse))
        dq_dev = device_ms(lambda: kernels.flash_attention_nullkv_bwd_dq(
            q, k, v, nk, nv, dout, lse, delta))
        one_call = lambda: fa._launch_backward(q, k, v, nk, nv, out, dout, lse, 0.125)  # noqa: E731
        bwd_dev = device_ms(one_call)
        sdpa_bwd_fn = sdpa_backward(sdpa_inputs(q, k, v, nk, nv), dout)
        bwd_ms, sdpa_bwd = in_turns(one_call, sdpa_bwd_fn)
        sdpa_bwd_dev = device_ms(sdpa_bwd_fn)
        kl = [t.detach().requires_grad_() for t in (q, k, v, nk, nv)]
        sl = [t.detach().requires_grad_() for t in sdpa_inputs(q, k, v, nk, nv)]
        fb_ms, sdpa_fb = in_turns(
            lambda: torch.autograd.grad(kernels.flash_attention_nullkv(*kl), kl, dout),
            lambda: torch.autograd.grad(F.scaled_dot_product_attention(*sl), sl,
                                        dout.transpose(1, 2)))
        n_call = site["count"]
        for key, ms, pm, dm in (("flash_attention_nullkv_bwd_dkv", dkv_ms, dkv_plain, dkv_dev),
                                ("flash_attention_nullkv_bwd_dq", dq_ms, dq_plain, dq_dev)):
            acc[key]["ms"] += ms * n_call
            acc[key]["plain_ms"] += pm * n_call
            acc[key]["device_ms"] = add_or_none(acc[key]["device_ms"], dm, n_call)
            acc[key]["library_ms"] += sdpa_bwd * n_call
        fb["ms"] += fb_ms * n_call
        fb["library_ms"] += sdpa_fb * n_call
        fb["bwd_ms"] += bwd_ms * n_call
        fb["bwd_device_ms"] = add_or_none(fb["bwd_device_ms"], bwd_dev, n_call)
        b_dkv = bound("flash_attention_nullkv_bwd_dkv", [dict(site, count=1)], B)
        b_dq = bound("flash_attention_nullkv_bwd_dq", [dict(site, count=1)], B)
        print(f"[k3-bwd] T={site['T']} B={B} N={site['N']}: " + "; ".join(line), flush=True)
        print(f"[k3-bwd] T={site['T']} B={B}: dkv_ms={dkv_ms:.4f} (device {ms_text(dkv_dev)}, "
              f"plain {dkv_plain:.4f}, bound {b_dkv[0]:.4f} {b_dkv[1]}) dq_ms={dq_ms:.4f} (device "
              f"{ms_text(dq_dev)}, plain {dq_plain:.4f}, bound {b_dq[0]:.4f} {b_dq[1]}) one-call "
              f"bwd {bwd_ms:.4f} ms (device {ms_text(bwd_dev)}), sdpa bwd {sdpa_bwd:.4f} ms "
              f"(device {ms_text(sdpa_bwd_dev)}) fwd+bwd: K3 {fb_ms:.4f} ms, sdpa {sdpa_fb:.4f} ms "
              f"x{n_call}/decode", flush=True)
    if failed:
        raise SystemExit(f"chip_smoke: K3 backward phase FAILED at {failed}")
    for key in acc:
        acc[key]["bound_ms"], acc[key]["bound_by"] = bound(key, flagship_sites, B)
    print(f"[k3-bwd] all flagship sites of one decode at B={B}: dkv "
          f"{acc['flash_attention_nullkv_bwd_dkv']['ms']:.4f} ms (device "
          f"{ms_text(acc['flash_attention_nullkv_bwd_dkv']['device_ms'])}), dq "
          f"{acc['flash_attention_nullkv_bwd_dq']['ms']:.4f} ms (device "
          f"{ms_text(acc['flash_attention_nullkv_bwd_dq']['device_ms'])}); one-call backward "
          f"{fb['bwd_ms']:.4f} ms (device {ms_text(fb['bwd_device_ms'])}), sdpa backward "
          f"{acc['flash_attention_nullkv_bwd_dq']['library_ms']:.4f} ms; forward+backward K3 "
          f"{fb['ms']:.4f} ms, sdpa {fb['library_ms']:.4f} ms", flush=True)
    return acc, fb


def bf16_ulps(got, ref) -> float:
    """max |got - ref| in units of one bf16 ulp of the twin's value (2^-7 of
    its binade; the smallest normal's ulp below it)."""
    import torch

    r = ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    _, e = torch.frexp(r)
    ulp = torch.ldexp(torch.ones_like(r), e - 8)
    return float(((got.float() - ref.float()).abs() / ulp).max())


def int8_work(M: int, K: int, N: int, raw: bool):
    """(operations, bytes) of one K6 (or K10) call: x read once (bf16, raw
    int8), the int8 weight once, ws and b once, y written once (bf16, raw int8)."""
    ops = 2 * M * N * K
    if raw:
        return ops, M * K + N * K + M * N
    return ops, 2 * M * K + N * K + 8 * N + 2 * M * N


def int8_bound(M, K, N, raw=False):
    ops, byts = int8_work(M, K, N, raw)
    a, b = ops / PEAK_INT8_OPS * 1e3, byts / PEAK_BYTES_PER_S * 1e3
    return max(a, b), ("operations" if a >= b else "bytes")


def kernel_int8_phase(sites, batches=(2, 32)) -> dict:
    """K6 (dynamic and static) and K10 against their twins, bit for bit and
    bit-identical on repeat, at every tower Linear shape of one encode at
    B=2 and B=32 (M = B x 1024 tokens) and at the card test's ragged shapes
    (INT8_RAGGED); a constructed-ties case. Times at the encode's shapes:
    CUDA events and device time (profiler) of the kernel, the twin, the
    library (torch._int_mm with the quantize and rescale as PyTorch ops,
    timed and never used); K6 static beside cuBLAS bf16 and K10 beside
    torch._int_mm + `>> 8`, each pair in turns; TOP/s and the fraction of
    the bound."""
    import torch

    from vfm_vae_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(808)
    failed = []

    # Ties: absmax 127 (scale 1), entries on .5, identity weight, unit scales:
    # the output is the quantized row itself, which must round half to even.
    K = 1024
    x = torch.randint(-126, 126, (256, K), generator=gen, device=dev).float() + 0.5
    x[:, 0] = 127.0
    eye, ones = torch.eye(K, device=dev).to(torch.int8), torch.ones(K, device=dev)
    xb = x.to(torch.bfloat16)
    for label, args in (("dynamic", ()), ("static", (torch.tensor(1.0, device=dev),))):
        got = kernels.int8_matmul(xb, eye, ones, None, *args)
        twin = kernels.int8_matmul(xb, eye, ones, None, *args, plain=True)
        torch.cuda.synchronize()
        exact = torch.equal(got.float(), torch.round(x)) and torch.equal(got, twin)
        away = int((torch.round(x) != torch.trunc(x + torch.sign(x) * 0.5)).sum())
        print(f"[kernel-int8] ties {label}: 256 x {K} rows with absmax 127, {away} entries "
              f"where half-to-even differs from half-away: kernel == rint(x) == twin {exact} "
              f"{'OK' if exact else 'FAIL'}", flush=True)
        if not exact:
            failed.append(f"ties {label}")

    summary = {"int8_matmul": dict(max_abs_err=0.0), "int8_matmul_raw": dict(max_abs_err=0.0)}

    def inputs(M, K, N):
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (N, K), generator=gen, device=dev, dtype=torch.int8)
        ws = torch.rand(N, generator=gen, device=dev) * 2e-4 + 1e-4
        b = torch.randn(N, generator=gen, device=dev) * 0.1
        a_s = (x.float().abs().amax() / 127 * 0.75).reshape(())  # clips the top quarter
        xq = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
        return x, wq, ws, b, a_s, xq

    def hold(label, fn, twin, name) -> str:
        """Kernel vs twin bit for bit, and the kernel twice bit for bit."""
        got, again, ref = fn(), fn(), twin()
        torch.cuda.synchronize()
        exact, repeat = torch.equal(got, ref), torch.equal(got, again)
        err = float((got.float() - ref.float()).abs().max())
        summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], err)
        ok = exact and repeat and bool(torch.isfinite(got.float()).all())
        if not ok:
            failed.append(label)
        return f"bit-exact {exact} repeat-identical {repeat} max_abs={err:.3e}"

    for M, K, N in INT8_RAGGED:
        x, wq, ws, b, a_s, xq = inputs(M, K, N)
        row = []
        for mode, extra in (("dynamic", ()), ("static", (a_s,))):
            row.append(f"{mode} " + hold(f"{mode} M={M} K={K} N={N}",
                                         lambda: kernels.int8_matmul(x, wq, ws, b, *extra),
                                         lambda: kernels.int8_matmul(x, wq, ws, b, *extra,
                                                                     plain=True), "int8_matmul"))
        row.append("raw " + hold(f"raw M={M} K={K} N={N}", lambda: kernels.int8_matmul_raw(xq, wq),
                                 lambda: kernels.int8_matmul_raw(xq, wq, plain=True),
                                 "int8_matmul_raw"))
        print(f"[kernel-int8] ragged M={M} K={K} N={N}: " + "; ".join(row) +
              f" {'OK' if not failed else 'FAIL'}", flush=True)

    def rate(ops, ms):
        return "not measured" if not ms else f"{ops / ms / 1e9:.0f} TOP/s"

    for B in batches:
        tot = {}
        by, raw_by = {}, {}  # bound ms by what bounds each shape
        for site in sites:
            M, K, N, n = site["M"] * B, site["K"], site["N"], site["count"]
            x, wq, ws, b, a_s, xq = inputs(M, K, N)
            w_bf = torch.randn(N, K, generator=gen, device=dev).to(torch.bfloat16)
            ops = int8_work(M, K, N, False)[0]
            bnd, b_by = int8_bound(M, K, N)
            rbnd, r_by = int8_bound(M, K, N, raw=True)
            by[b_by] = by.get(b_by, 0) + bnd * n
            raw_by[r_by] = raw_by.get(r_by, 0) + rbnd * n
            t = {"bound_ms": bnd, "raw_bound_ms": rbnd}
            bf16 = lambda: x @ w_bf.t()  # noqa: E731
            for mode, extra in (("dynamic", ()), ("static", (a_s,))):
                k6 = lambda: kernels.int8_matmul(x, wq, ws, b, *extra)  # noqa: E731
                held = hold(f"{mode} M={M} K={K} N={N}", k6,
                            lambda: kernels.int8_matmul(x, wq, ws, b, *extra, plain=True),
                            "int8_matmul")
                pre = "" if mode == "dynamic" else "static_"
                if mode == "static":
                    t[pre + "ms"], t["bf16_ms"] = in_turns(k6, bf16)
                    t["bf16_device_ms"] = device_ms(bf16)
                else:
                    t[pre + "ms"] = cuda_time_ms(k6)
                t[pre + "device_ms"] = device_ms(k6)
                t[pre + "plain_ms"] = cuda_time_ms(
                    lambda: kernels.int8_matmul(x, wq, ws, b, *extra, plain=True), reps=5)
                t[pre + "library_ms"] = cuda_time_ms(lambda: int_mm_library(x, wq, ws, b, *extra))
                beside = (f"; cuBLAS bf16 in turns {t['bf16_ms']:.4f} ms (device "
                          f"{ms_text(t['bf16_device_ms'])}), kernel/bf16 "
                          f"{t[pre + 'ms'] / t['bf16_ms']:.3f}") if mode == "static" else ""
                print(f"[kernel-int8] {mode} M={M} K={K} N={N} (B={B}): {held}; kernel "
                      f"{t[pre + 'ms']:.4f} ms (device {ms_text(t[pre + 'device_ms'])}, "
                      f"{rate(ops, t[pre + 'device_ms'])}, "
                      f"{bnd / (t[pre + 'device_ms'] or t[pre + 'ms']):.3f} of the bound "
                      f"{bnd:.4f} ms, {b_by}); plain {t[pre + 'plain_ms']:.4f}, library "
                      f"(_int_mm + PyTorch quantize, rescale) {t[pre + 'library_ms']:.4f}"
                      f"{beside}; x{n}/encode", flush=True)
            k10 = lambda: kernels.int8_matmul_raw(xq, wq)  # noqa: E731
            int_mm = lambda: (torch._int_mm(xq, wq.t()) >> 8).to(torch.int8)  # noqa: E731
            held = hold(f"raw M={M} K={K} N={N}", k10,
                        lambda: kernels.int8_matmul_raw(xq, wq, plain=True), "int8_matmul_raw")
            t["raw_ms"], t["raw_library_ms"] = in_turns(k10, int_mm)
            t["raw_device_ms"], t["raw_library_device_ms"] = device_ms(k10), device_ms(int_mm)
            t["raw_plain_ms"] = cuda_time_ms(lambda: kernels.int8_matmul_raw(xq, wq, plain=True),
                                             reps=5)
            print(f"[kernel-int8] raw (K10) M={M} K={K} N={N} (B={B}): {held}; in turns kernel "
                  f"{t['raw_ms']:.4f} ms vs torch._int_mm + >>8 {t['raw_library_ms']:.4f} "
                  f"({t['raw_ms'] / t['raw_library_ms']:.3f}x); device "
                  f"{ms_text(t['raw_device_ms'])} vs {ms_text(t['raw_library_device_ms'])}; "
                  f"{rate(ops, t['raw_device_ms'])}, "
                  f"{rbnd / (t['raw_device_ms'] or t['raw_ms']):.3f} of the bound {rbnd:.4f} ms "
                  f"({r_by}); plain {t['raw_plain_ms']:.4f}", flush=True)
            for key, val in t.items():
                tot[key] = None if val is None or tot.get(key, 0.0) is None else \
                    tot.get(key, 0.0) + val * n
            del x, wq, xq, w_bf
        print(f"[kernel-int8] all {sum(s['count'] for s in sites)} K6 sites of one encode at "
              f"B={B}, ms (events; device): dynamic {tot['ms']:.4f}; "
              f"{ms_text(tot['device_ms'])} (plain {tot['plain_ms']:.4f}, library "
              f"{tot['library_ms']:.4f}), static {tot['static_ms']:.4f}; "
              f"{ms_text(tot['static_device_ms'])} (library {tot['static_library_ms']:.4f}), "
              f"cuBLAS bf16 {tot['bf16_ms']:.4f}; {ms_text(tot['bf16_device_ms'])}, K10 "
              f"{tot['raw_ms']:.4f}; {ms_text(tot['raw_device_ms'])} (torch._int_mm + >>8 "
              f"{tot['raw_library_ms']:.4f}; {ms_text(tot['raw_library_device_ms'])}); bound "
              f"{tot['bound_ms']:.4f} ms ({max(by, key=by.get)}), K10 "
              f"{tot['raw_bound_ms']:.4f} ({max(raw_by, key=raw_by.get)})", flush=True)
        summary["int8_matmul"].update(
            batch=B, ms=tot["ms"], device_ms=tot["device_ms"], plain_ms=tot["plain_ms"],
            library_ms=tot["library_ms"], static_ms=tot["static_ms"],
            static_device_ms=tot["static_device_ms"], static_plain_ms=tot["static_plain_ms"],
            static_library_ms=tot["static_library_ms"], bf16_ms=tot["bf16_ms"],
            bf16_device_ms=tot["bf16_device_ms"], bound_ms=tot["bound_ms"],
            bound_by=max(by, key=by.get))
        summary["int8_matmul_raw"].update(
            batch=B, ms=tot["raw_ms"], device_ms=tot["raw_device_ms"],
            plain_ms=tot["raw_plain_ms"], library_ms=tot["raw_library_ms"],
            library_device_ms=tot["raw_library_device_ms"], bound_ms=tot["raw_bound_ms"],
            bound_by=max(raw_by, key=raw_by.get))
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"chip_smoke: kernel-int8 phase FAILED at {failed}")
    return summary


def int_mm_library(x, wq, ws, b, a_s=None):
    """The same function as K6 through one library GEMM (torch._int_mm, int8
    x int8 -> int32) with the quantize and the rescale as PyTorch ops."""
    import torch

    xf = x.float()
    if a_s is None:
        s = (xf.abs().amax(-1, keepdim=True) / 127).clamp_min(1e-8)
        xq = torch.round(xf / s).to(torch.int8)
        return (torch._int_mm(xq, wq.t()).float() * s * ws + b).to(x.dtype)
    xq = torch.round(xf * (1 / a_s.clamp_min(1e-8))).clamp(-127, 127).to(torch.int8)
    return (torch._int_mm(xq, wq.t()).float() * (a_s * ws) + b).to(x.dtype)


def flash_work(B, Tq, Tk, N, D, itemsize):
    """(operations, bytes) of one K4 call: S = qK^T and O = PV; q, k, v read
    once, O written once."""
    return 4 * B * N * Tq * Tk * D, (2 * B * Tq * N * D + 2 * B * Tk * N * D) * itemsize


def kernel_flash_phase(sites, B: int = 2) -> dict:
    """K4 against its twin and an fp64 evaluation at every encode site (the
    tower's bf16 T=1024 16 x 64, the adapter's fp32 sites) and at one d=128
    shape; kernel, twin and SDPA times and the bound; at the fp32 sites K4's
    forward and SDPA's fp32 forward also in turns (K4, SDPA, SDPA, K4), by
    CUDA events and on the device."""
    import torch
    import torch.nn.functional as F

    from vfm_vae_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(909)
    cases = [(dict(s), torch.bfloat16 if s["at"] == "tower" else torch.float32) for s in sites]
    cases.append((dict(T=1024, N=8, D=128, at="d128", count=0), torch.bfloat16))
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, fma_bound_ms=0.0,
               device_ms=0.0)
    by, worst_abs, failed = {}, 0.0, []
    for site, dt in cases:
        T, N, D, n = site["T"], site["N"], site["D"], site["count"]
        q, k, v = (torch.randn(B, T, N, D, generator=gen, device=dev).to(dt) for _ in range(3))
        got = kernels.flash_attention_nonull(q, k, v)
        ref = kernels.flash_attention_nonull(q, k, v, plain=True)
        truth = attention_fp64(q, k, v)
        torch.cuda.synchronize()
        max_abs, max_rel, mean_rel = rel_errors(got, ref)
        k_truth, p_truth = rel_errors(got, truth)[2], rel_errors(ref, truth)[2]
        finite = bool(torch.isfinite(got.float()).all())
        if dt == torch.bfloat16:
            tol_max, tol_mean = TOLERANCES["flash_attention_nullkv"]
        else:
            tol_max, tol_mean = FLASH_FP32_MAX_REL, FLASH_FP32_MAX_REL
        ok = (finite and max_rel <= tol_max and mean_rel <= tol_mean
              and k_truth <= TRUTH_FACTOR * p_truth + 1e-7)
        if dt == torch.float32:
            f32_ok, f32_text, _ = k4_f32_gates(q, k, v)
            print(f"[kernel-flash] {site['at']} float32 T={T} N={N} D={D} B={B} gates: {f32_text} "
                  f"{'OK' if f32_ok else 'FAIL'}", flush=True)
            ok = ok and f32_ok
        ms = cuda_time_ms(lambda: kernels.flash_attention_nonull(q, k, v))
        plain_ms = cuda_time_ms(lambda: kernels.flash_attention_nonull(q, k, v, plain=True))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        ops, byts = flash_work(B, T, T, N, D, q.element_size())
        peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_3XTF32_FLOPS
        a, bb = ops / peak * 1e3, byts / PEAK_BYTES_PER_S * 1e3
        bnd, b_by = max(a, bb), ("operations" if a >= bb else "bytes")
        fma_bnd = bnd if dt == torch.bfloat16 else max(ops / PEAK_FP32_FLOPS * 1e3, bb)
        fma = "" if dt == torch.bfloat16 else f" (3xTF32; FMA bound {fma_bnd:.4f})"
        dev_ms = device_ms(lambda: kernels.flash_attention_nonull(q, k, v))
        rates = flash_rate_text(ms, dev_ms, ops, bnd, lib_ms, device_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt)))
        if dt == torch.float32:  # K4's fp32 forward and SDPA's, in turns
            kern = lambda: kernels.flash_attention_nonull(q, k, v)  # noqa: E731
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
            k_turn, s_turn = in_turns(kern, sdpa)
            k_dev, s_dev, _, s_per = device_in_turns(kern, sdpa)
            for key, val in (("fp32_turns_ms", k_turn), ("fp32_turns_library_ms", s_turn),
                             ("fp32_turns_device_ms", k_dev),
                             ("fp32_turns_library_device_ms", s_dev)):
                tot[key] = add_or_none(tot.get(key, 0.0), val, n)
            rates += (f"; in turns K4 {k_turn:.4f} vs SDPA {s_turn:.4f} ms (device "
                      f"{ms_text(k_dev)} vs {ms_text(s_dev)}; SDPA's kernels "
                      f"{', '.join(k[:50] for k in s_per)})")
        print(f"[kernel-flash] {site['at']} {str(dt).split('.')[-1]} T={T} N={N} D={D} B={B}: "
              f"max_abs={max_abs:.3e} max_rel={max_rel:.3e} (tol {tol_max:g}) mean_rel="
              f"{mean_rel:.3e} (tol {tol_mean:g}) vs_fp64 kernel={k_truth:.3e} plain="
              f"{p_truth:.3e} finite={finite} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bnd:.4f} ({b_by}){fma} {rates} x{n}/encode {'OK' if ok else 'FAIL'}",
              flush=True)
        tot["device_ms"] = add_or_none(tot["device_ms"], dev_ms, n)
        if not ok:
            failed.append(f"{site['at']} T={T} D={D}")
        worst_abs = max(worst_abs, max_abs)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", bnd), ("fma_bound_ms", fma_bnd)):
            tot[key] += val * n
        by[b_by] = by.get(b_by, 0) + n
    for Bx, Tq, Tk, N, D in K4_F32_EXTRA:
        q = torch.randn(Bx, Tq, N, D, generator=gen, device=dev)
        k, v = (torch.randn(Bx, Tk, N, D, generator=gen, device=dev) for _ in range(2))
        f32_ok, f32_text, _ = k4_f32_gates(q, k, v)
        print(f"[kernel-flash] float32 B={Bx} Tq={Tq} Tk={Tk} N={N} D={D} gates: {f32_text} "
              f"{'OK' if f32_ok else 'FAIL'}", flush=True)
        if not f32_ok:
            failed.append(f"float32 Tq={Tq} Tk={Tk} D={D}")
    if failed:
        raise SystemExit(f"chip_smoke: kernel-flash phase FAILED at {failed}")
    print(f"[kernel-flash] all K4 sites of one encode at B={B}: kernel {tot['ms']:.4f} ms "
          f"(device {ms_text(tot['device_ms'])}), plain {tot['plain_ms']:.4f} ms, sdpa "
          f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms; the fp32 sites in "
          f"turns: K4 {ms_text(tot.get('fp32_turns_ms'))} vs SDPA "
          f"{ms_text(tot.get('fp32_turns_library_ms'))} ms (device "
          f"{ms_text(tot.get('fp32_turns_device_ms'))} vs "
          f"{ms_text(tot.get('fp32_turns_library_device_ms'))})", flush=True)
    return {"flash_attention_nonull": dict(max_abs_err=worst_abs, batch=B,
                                           bound_by=max(by, key=by.get), **tot)}


def flash_batch_phase(k3_sites, k4_sites, B: int = 32) -> dict:
    """The bf16 flash forward (K3 with the null token, K4 without) at the
    offline batch B=32 on its device-bound shapes: the tower's attention,
    the d=128 shape and K3's T=1024 decode site. Held to K3's bounds against
    the twin and against fp32 (TRUTH_FACTOR); the kernel's and SDPA's
    CUDA-event and device times on the same inputs, TFLOP/s and the fraction
    of the bound."""
    import torch
    import torch.nn.functional as F

    from vfm_vae_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3232)
    tol_max, tol_mean = TOLERANCES["flash_attention_nullkv"]
    k3 = max(k3_sites, key=lambda x: x["T"])
    tower = next(x for x in k4_sites if x["at"] == "tower")
    cases = [("flash_attention_nullkv", "k3", k3["T"], k3["N"], k3["D"]),
             ("flash_attention_nonull", "tower", tower["T"], tower["N"], tower["D"]),
             ("flash_attention_nonull", "d128", 1024, 8, 128)]
    out, failed = {}, []
    for name, at, T, N, D in cases:
        q, k, v = (torch.randn(B, T, N, D, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        fn = getattr(kernels, name)
        if name == "flash_attention_nullkv":
            nk, nv = (torch.randn(B, 1, N, D, generator=gen, device=dev).to(torch.bfloat16)
                      for _ in range(2))
            args = (q, k, v, nk, nv)
            sdpa_args = sdpa_inputs(*args)
            flops = work(name, dict(T=T, N=N, D=D), B)[0]
            bnd = bound(name, [dict(T=T, N=N, D=D, count=1)], B)[0]
        else:
            args = (q, k, v)
            sdpa_args = tuple(t.transpose(1, 2) for t in args)
            flops, byts = flash_work(B, T, T, N, D, 2)
            bnd = max(flops / PEAK_BF16_FLOPS, byts / PEAK_BYTES_PER_S) * 1e3
        got, ref = fn(*args), fn(*args, plain=True)
        truth = fn(*(t.float() for t in args), plain=True)
        torch.cuda.synchronize()
        max_abs, max_rel, mean_rel = rel_errors(got, ref)
        k_truth, p_truth = rel_errors(got, truth)[2], rel_errors(ref, truth)[2]
        del ref, truth
        finite = bool(torch.isfinite(got.float()).all())
        ok = (finite and max_rel <= tol_max and mean_rel <= tol_mean
              and k_truth <= TRUTH_FACTOR * p_truth + 1e-6)
        ms = cuda_time_ms(lambda: fn(*args))
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(*sdpa_args))
        dev_ms = device_ms(lambda: fn(*args))
        lib_dev = device_ms(lambda: F.scaled_dot_product_attention(*sdpa_args))
        print(f"[flash-b{B}] {name} {at} T={T} N={N} D={D} B={B}: max_abs={max_abs:.3e} "
              f"max_rel={max_rel:.3e} (tol {tol_max:g}) mean_rel={mean_rel:.3e} (tol "
              f"{tol_mean:g}) vs_fp32 kernel={k_truth:.3e} plain={p_truth:.3e} finite={finite} "
              f"kernel_ms={ms:.4f} bound_ms={bnd:.4f} "
              f"{flash_rate_text(ms, dev_ms, flops, bnd, lib_ms, lib_dev)} "
              f"kernel/sdpa={ms / lib_ms:.3f} {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(f"{name} {at}")
        out.setdefault(name, {})[at] = dict(
            batch=B, T=T, N=N, D=D, ms=ms, device_ms=dev_ms, library_ms=lib_ms,
            library_device_ms=lib_dev, bound_ms=bnd, tflops=flops / ms / 1e9, max_abs_err=max_abs)
        del got, args, sdpa_args, q, k, v
        torch.cuda.empty_cache()
    # K4's fp32 forward at the adapter's sites: its gates, then the kernel and
    # SDPA's fp32 forward in turns (events and device time).
    tot = dict(ms=0.0, library_ms=0.0, device_ms=0.0, library_device_ms=0.0, bound_ms=0.0,
               fma_bound_ms=0.0)
    for site in (x for x in k4_sites if x["at"] == "adapter"):
        T, N, D, n = site["T"], site["N"], site["D"], site["count"]
        q, k, v = (torch.randn(B, T, N, D, generator=gen, device=dev) for _ in range(3))
        ok, text, max_abs = k4_f32_gates(q, k, v)
        sdpa_args = tuple(t.transpose(1, 2) for t in (q, k, v))
        kern = lambda: kernels.flash_attention_nonull(q, k, v)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(*sdpa_args)  # noqa: E731
        ms, lib_ms = in_turns(kern, sdpa)
        dev_ms, lib_dev, _, s_per = device_in_turns(kern, sdpa)
        flops, byts = flash_work(B, T, T, N, D, 4)
        a, bb = flops / PEAK_3XTF32_FLOPS * 1e3, byts / PEAK_BYTES_PER_S * 1e3
        bnd, fma_bnd = max(a, bb), max(flops / PEAK_FP32_FLOPS * 1e3, bb)
        print(f"[flash-b{B}] flash_attention_nonull adapter float32 T={T} N={N} D={D} B={B} "
              f"x{n}/encode: {text} kernel_ms={ms:.4f} bound_ms={bnd:.4f} (3xTF32; FMA bound "
              f"{fma_bnd:.4f}) {flash_rate_text(ms, dev_ms, flops, bnd, lib_ms, lib_dev)} in turns "
              f"(K4, SDPA, SDPA, K4); SDPA's kernels "
              f"{', '.join(x[:50] for x in s_per)} {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(f"flash_attention_nonull adapter float32 T={T}")
        for key, val in (("ms", ms), ("library_ms", lib_ms), ("device_ms", dev_ms),
                         ("library_device_ms", lib_dev), ("bound_ms", bnd),
                         ("fma_bound_ms", fma_bnd)):
            tot[key] = add_or_none(tot[key], val, n)
        out.setdefault("flash_attention_nonull", {})[f"adapter_fp32_T{T}"] = dict(
            batch=B, T=T, N=N, D=D, count=n, ms=ms, device_ms=dev_ms, library_ms=lib_ms,
            library_device_ms=lib_dev, bound_ms=bnd, fma_bound_ms=fma_bnd, max_abs_err=max_abs)
        del q, k, v, sdpa_args
        torch.cuda.empty_cache()
    dev_share = (f"{tot['bound_ms'] / tot['device_ms']:.3f}" if tot["device_ms"] else
                 "not measured")
    print(f"[flash-b{B}] K4 float32 forward, the four adapter sites of one encode: kernel "
          f"{tot['ms']:.4f} ms (device {ms_text(tot['device_ms'])}), SDPA's fp32 forward "
          f"{tot['library_ms']:.4f} ms (device {ms_text(tot['library_device_ms'])}) in turns, "
          f"bound {tot['bound_ms']:.4f} ms (3xTF32; FMA {tot['fma_bound_ms']:.4f}): "
          f"{tot['bound_ms'] / tot['ms']:.3f} of the bound (device {dev_share})", flush=True)
    out.setdefault("flash_attention_nonull", {})["adapter_fp32"] = dict(batch=B, **tot)
    if failed:
        raise SystemExit(f"chip_smoke: flash-b{B} phase FAILED at {failed}")
    return out


def flash_bwd_batch_phase(k3_sites, k4_sites, B: int = 32) -> dict:
    """The bf16 backward, one library call (pre-pass, dK/dV and dQ kernels),
    at the offline batch B=32 on three shapes: K3's T=1024 decode site (null
    token), the tower's attention and the d=128 shape (K4). Held as k3-bwd
    holds it (the twin within BWD_TOLERANCE, fp32 autograd within
    TRUTH_FACTOR of the twin's error) and bit-identical on a second call;
    the call's CUDA-event and device time and each kernel's device time,
    TFLOP/s and fraction of the bound, beside SDPA's backward alone on the
    same inputs (CUDA-event and device time, the names of its kernels)."""
    import torch
    import torch.nn.functional as F

    from vfm_vae_tpu_torch.ops import kernels
    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3233)
    tol_max, tol_mean = BWD_TOLERANCE
    k3 = max(k3_sites, key=lambda x: x["T"])
    tower = next(x for x in k4_sites if x["at"] == "tower")
    cases = [("k3", k3["T"], k3["N"], k3["D"], True),
             ("tower", tower["T"], tower["N"], tower["D"], False), ("d128", 1024, 8, 128, False)]
    rows, failed = {}, []
    for at, T, N, D, null in cases:
        scale = D ** -0.5
        q, k, v, dout = (torch.randn(B, T, N, D, generator=gen, device=dev).to(bf)
                         for _ in range(4))
        if null:
            nk, nv = (torch.randn(B, 1, N, D, generator=gen, device=dev).to(bf) for _ in range(2))
            out, lse = fa._launch_forward(q, k, v, nk, nv, scale, True)
            twin = kernels.flash_attention_nullkv_bwd_reference(q, k, v, nk, nv, out, lse, dout,
                                                                scale)[:5]
            leaves = [t.float().requires_grad_() for t in (q, k, v, nk, nv)]
            truth = torch.autograd.grad(kernels.flash_attention_nullkv_reference(*leaves, scale),
                                        leaves, dout.float())
            sdpa_args = sdpa_inputs(q, k, v, nk, nv)
            names = ("flash_attention_nullkv_bwd_dkv", "flash_attention_nullkv_bwd_dq")
            works = [work(n, dict(T=T, N=N, D=D), B) for n in names]
        else:
            nk = nv = None
            out, lse = fa._launch_nonull(q, k, v, scale, True)
            twin = kernels.flash_attention_nonull_bwd_reference(q, k, v, out, lse, dout, scale)[:3]
            leaves = [t.float().requires_grad_() for t in (q, k, v)]
            truth = torch.autograd.grad(kernels.flash_attention_nonull_reference(*leaves, scale),
                                        leaves, dout.float())
            sdpa_args = tuple(t.transpose(1, 2) for t in (q, k, v))
            names = K4_BWD
            works = [flash_bwd_work(n, B, T, T, N, D, 2) for n in names]
        del leaves

        def call():
            return fa._launch_backward(q, k, v, nk, nv, out, dout, lse, scale)

        got, again = call(), call()
        torch.cuda.synchronize()
        line, worst = [], 0.0
        for nm, a, a2, ref, tr in zip(("dq", "dk", "dv", "dnull_k", "dnull_v"), got, again, twin,
                                      truth):
            max_abs, max_rel, mean_rel = rel_errors(a, ref)
            k32, p32 = rel_errors(a, tr)[2], rel_errors(ref, tr)[2]
            finite, same = bool(torch.isfinite(a.float()).all()), torch.equal(a, a2)
            ok = (finite and same and max_rel <= tol_max and mean_rel <= tol_mean
                  and k32 <= TRUTH_FACTOR * p32 + 1e-6)
            line.append(f"{nm} max_rel={max_rel:.3e} mean_rel={mean_rel:.3e} vs_fp32 "
                        f"kernel={k32:.3e} plain={p32:.3e} repeat="
                        f"{'identical' if same else 'DIFFERS'}{'' if ok else ' FAIL'}")
            if not ok:
                failed.append(f"{at} {nm}")
            worst = max(worst, max_abs)
        del got, again, twin, truth
        torch.cuda.empty_cache()
        sfn = sdpa_backward(sdpa_args, dout)
        ms, lib_ms = in_turns(call, sfn)
        dev_ms, per = device_kernels(call)
        parts = {"dkv": kernel_ms(per, "flash_bwd_dkv_kernel"),
                 "dq": kernel_ms(per, "flash_bwd_dq_kernel"),
                 "pre-pass": kernel_ms(per, "prepass_kernel") or kernel_ms(per, "delta_")}
        lib_dev, lib_per = device_kernels(sfn)
        # Forward + backward through the Function, and through SDPA.
        kl = [t.detach().requires_grad_() for t in ((q, k, v, nk, nv) if null else (q, k, v))]
        fn = kernels.flash_attention_nullkv if null else kernels.flash_attention_nonull
        sl = [t.detach().requires_grad_() for t in sdpa_args]

        def fwd_bwd():
            return torch.autograd.grad(fn(*kl), kl, dout)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(F.scaled_dot_product_attention(*sl), sl,
                                       dout.transpose(1, 2))

        fb_ms, sfb_ms = in_turns(fwd_bwd, sdpa_fwd_bwd)
        fb, sfb = (fb_ms, device_ms(fwd_bwd)), (sfb_ms, device_ms(sdpa_fwd_bwd))
        del kl, sl
        bounds = [max(ops / PEAK_BF16_FLOPS, byts / PEAK_BYTES_PER_S) * 1e3 for ops, byts in works]
        flops = works[0][0] + works[1][0]
        texts = []
        for key, (ops, _), bnd in zip(("dkv", "dq"), works, bounds):
            dm = parts[key]
            texts.append(f"{key} device {ms_text(dm)} ms, bound {bnd:.4f} ms, "
                         + ("not measured" if dm is None else
                            f"{ops / dm / 1e9:.1f} TFLOP/s, of_bound={bnd / dm:.3f}"))
        print(f"[flash-bwd-b{B}] {at} T={T} N={N} D={D} B={B}: " + "; ".join(line), flush=True)
        print(f"[flash-bwd-b{B}] {at} T={T} N={N} D={D} B={B}: backward_ms={ms:.4f} "
              f"device_ms={ms_text(dev_ms)} ({'; '.join(texts)}; pre-pass device "
              f"{ms_text(parts['pre-pass'])} ms) tflops={flops / ms / 1e9:.1f} (device "
              + ("not measured" if dev_ms is None else f"{flops / dev_ms / 1e9:.1f}")
              + f") of_bound={sum(bounds) / ms:.3f} sdpa_bwd_ms={lib_ms:.4f} "
              f"sdpa_bwd_device_ms={ms_text(lib_dev)} sdpa_kernels={list(lib_per)[:3]} "
              f"kernel/sdpa={ms / lib_ms:.3f} (device "
              + ("not measured" if dev_ms is None or lib_dev is None else f"{dev_ms / lib_dev:.3f}")
              + f") fwd+bwd: kernel {fb[0]:.4f} ms (device {ms_text(fb[1])}), sdpa {sfb[0]:.4f} "
              f"ms (device {ms_text(sfb[1])}) "
              f"{'OK' if not any(f.startswith(at + ' ') for f in failed) else 'FAIL'}",
              flush=True)
        for key, name, bnd in zip(("dkv", "dq"), names, bounds):
            rows.setdefault(name, {})[at] = dict(
                batch=B, T=T, N=N, D=D, ms=ms, call_device_ms=dev_ms, device_ms=parts[key],
                bound_ms=bnd, library_ms=lib_ms, library_device_ms=lib_dev,
                library_kernels=list(lib_per)[:3], tflops=flops / ms / 1e9, max_abs_err=worst,
                fwd_bwd_ms=fb[0], fwd_bwd_device_ms=fb[1], library_fwd_bwd_ms=sfb[0],
                library_fwd_bwd_device_ms=sfb[1])
        del q, k, v, dout, out, lse, nk, nv, sdpa_args, sfn
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"chip_smoke: flash-bwd-b{B} phase FAILED at {failed}")
    return rows


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
    if any(n for name, n in launches.items() if name not in PER_DECODE):
        raise SystemExit("chip_smoke: an opt-in kernel launched on the default path")
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
    refs = dict(img=requests[0], z=z_k, x=x_k, x_plain=x_p, x_32=x_32)

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
    return launches, refs


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


def attention_fp64(q, k, v):
    """Softmax attention evaluated in float64: the reference K4 is held to."""
    import torch

    s = torch.einsum("btnh,bsnh->bnts", q.double(), k.double()) * q.shape[-1] ** -0.5
    return torch.einsum("bnts,bsnh->btnh", torch.softmax(s, dim=-1), v.double())


def short_kernel_name(name: str) -> str:
    """A profiler kernel name without its scope and arguments, e.g.
    flash_fwd_f32_kernel<64, 2>; else its first 40 characters."""
    m = re.search(r"(\w+<[^>]*>)\(", name)
    return m.group(1) if m else name[:40]


def mean_rel64(got, truth) -> float:
    """mean |got - truth| / mean |truth|, in float64."""
    return float((got.double() - truth).abs().mean() / truth.abs().mean())


def k4_f32_gates(q, k, v) -> tuple:
    """K4's fp32 forward on fp32 (q, k, v) held to its gates: within
    FLASH_FP32_MAX_REL of the twin (max and mean), its log-sum-exp within
    1e-5 of the twin's (of scale, + 1e-5), within TRUTH_FACTOR x the twin's
    mean error against float64 (+1e-7), bit-identical on repeat (with and
    without the log-sum-exp), one launch a call by the wrapper's counter and
    one kernel a call by the profiler (flash_fwd_f32_kernel, nothing else).
    Returns (ok, the row's text, max |kernel - twin|)."""
    import torch

    from vfm_vae_tpu_torch.ops import kernels
    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa

    scale = q.shape[-1] ** -0.5
    before = kernels.flash_attention_nonull.launches
    out, lse = fa._launch_nonull(q, k, v, scale, True)
    out2, lse2 = fa._launch_nonull(q, k, v, scale, True)
    out3 = kernels.flash_attention_nonull(q, k, v)
    torch.cuda.synchronize()
    one = kernels.flash_attention_nonull.launches - before == 3
    same = torch.equal(out, out2) and torch.equal(lse, lse2) and torch.equal(out, out3)
    del out2, lse2, out3
    ref, ref_lse = kernels.flash_attention_nonull_reference(q, k, v, scale, return_lse=True)
    max_abs, max_rel, mean_rel = rel_errors(out, ref)
    lse_err = float((lse - ref_lse).abs().max())
    lse_ok = lse_err <= 1e-5 * float(ref_lse.abs().max()) + 1e-5
    del ref_lse
    truth = attention_fp64(q, k, v)
    k64, p64 = mean_rel64(out, truth), mean_rel64(ref, truth)
    del truth, ref
    per = device_launches(lambda: kernels.flash_attention_nonull(q, k, v))
    one_kernel = (sum(n for name, n in per.items() if "flash_fwd_f32_kernel" in name) == 1
                  and sum(per.values()) == 1)
    finite = bool(torch.isfinite(out).all())
    ok = (finite and max_rel <= FLASH_FP32_MAX_REL and mean_rel <= FLASH_FP32_MAX_REL and lse_ok
          and k64 <= TRUTH_FACTOR * p64 + 1e-7 and same and one and one_kernel)
    names = ", ".join(f"{short_kernel_name(name)} x{n:g}" for name, n in per.items())
    text = (f"max_abs={max_abs:.3e} max_rel={max_rel:.3e} mean_rel={mean_rel:.3e} (tol "
            f"{FLASH_FP32_MAX_REL:g}) lse_err={lse_err:.3e} vs_fp64 kernel={k64:.3e} "
            f"plain={p64:.3e} (limit {TRUTH_FACTOR} x plain) finite={finite} bit_identical={same} "
            f"launches_a_call={'1' if one else 'not 1'} kernels_a_call=[{names}]")
    return ok, text, max_abs


# K4's fp32 forward off the adapter's sites (B, Tq, Tk, N, D): the card
# test's ragged Tq != Tk shapes (partial query blocks and key tiles) and
# d=128 (one consumer warpgroup, 32-key tiles).
K4_F32_EXTRA = ((2, 77, 130, 4, 64), (2, 300, 1000, 4, 64), (2, 129, 640, 8, 128),
                (2, 1024, 1024, 8, 128))


FLASH_SWITCHES = {"VFM_VAE_USE_PALLAS_FLASH": "1", "VFM_VAE_ADAPTER_ATTN": "3mm-flash"}
# Every opt-in kernel switch of the JAX package: K5, K9 and the flash
# switches (K4, and K4's backward in training).
ALL_SWITCHES = dict(FLASH_SWITCHES, VFM_VAE_PALLAS_STATS="1", VFM_VAE_MLP_PIPELINE="1")
NO_SWITCHES = {k: None for k in ALL_SWITCHES}


class env_vars:
    """The environment variables `want` (None: unset) for the length of a
    `with`; every variable is restored on exit."""

    def __init__(self, want: dict):
        self.want = want

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.want}
        for k, v in self.want.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def serving_env(int8: bool) -> env_vars:
    """The int8 serving switches: the flash switches always,
    VFM_VAE_INT8_VFM as given (enable_int8_tower sets it)."""
    return env_vars(dict(FLASH_SWITCHES, VFM_VAE_INT8_VFM="1" if int8 else None))


def forward_counts(sites: dict) -> dict:
    """Launches of one forward pass (encode + decode) per kernel_sites entry,
    leaving out the probe's kernels and K4's backward."""
    return {name: sum(s["count"] for s in ss) for name, ss in sites.items()
            if name not in PROBE_KERNELS + K4_BWD}


def encode_sites(G, int8: bool) -> list:
    """kernel_sites' K6 and K4 sites of one flagship encode with the serving
    switches on (the int8 ones only when `int8`)."""
    from vfm_vae_tpu_torch.entry import kernel_sites

    with serving_env(int8):
        sites = kernel_sites(G, 256)
    return sites


def predicted_serving(sites: dict, n_req: int) -> dict:
    """Launches of the int8-serving path: the calibration pass runs the
    tower once (K6 dynamic at every Linear, K4 at the tower's attentions);
    each request runs one encode (K6, K4 tower + adapter) and one decode
    (K1-K3). The path never runs K10."""
    from vfm_vae_tpu_torch.ops import kernels

    want = {fn.__name__: 0 for fn in kernels.ALL_WRAPPERS}
    for name, n in forward_counts(sites).items():
        want[name] += n_req * n
    want["int8_matmul"] += sum(s["count"] for s in sites["int8_matmul"])
    want["flash_attention_nonull"] += sum(s["count"] for s in sites["flash_attention_nonull"]
                                          if s["at"] == "tower")
    return want


class site_checks:
    """For the length of a `with`: every K6 call of the int8 Linears and
    every K4 call is followed by its plain twin on the very same inputs (the
    kernel path's own activations, so no difference upstream reaches the
    comparison), and each pair's error is recorded. The twins run with
    plain=True and add no launches."""

    def __init__(self):
        self.k6, self.k4 = [], []

    def __enter__(self):
        import torch

        from vfm_vae_tpu_torch.ops import attention, quantized

        self.saved = k6, k4 = quantized.int8_matmul, attention.flash_attention_nonull

        def k6_checked(x, wq, ws, b=None, a_s=None, *, plain=False):
            y = k6(x, wq, ws, b, a_s, plain=plain)
            ref = k6(x, wq, ws, b, a_s, plain=True)
            self.k6.append((a_s is not None, tuple(wq.shape), bf16_ulps(y, ref),
                            bool(y.isfinite().all()) and torch.equal(y, ref)))
            return y

        def k4_checked(q, k, v, scale=None, *, plain=False):
            y = k4(q, k, v, scale, plain=plain)
            ref = k4(q, k, v, scale, plain=True)
            self.k4.append((q.dtype, tuple(q.shape), *rel_errors(y, ref)[1:],
                            bool(y.isfinite().all())))
            return y

        quantized.int8_matmul, attention.flash_attention_nonull = k6_checked, k4_checked
        return self

    def __exit__(self, *exc):
        from vfm_vae_tpu_torch.ops import attention, quantized

        quantized.int8_matmul, attention.flash_attention_nonull = self.saved

    def failures(self) -> list:
        """Sites past the kernel phases' tolerances: K6 bit for bit, K4 bf16
        K3's bounds, K4 fp32 FLASH_FP32_MAX_REL."""
        import torch

        bad = [f"K6 {'static' if st else 'dynamic'} N,K={shape}: {u:g} ulps"
               for st, shape, u, exact in self.k6 if not exact]
        for dt, shape, max_rel, mean_rel, fin in self.k4:
            tol = (TOLERANCES["flash_attention_nullkv"] if dt == torch.bfloat16
                   else (FLASH_FP32_MAX_REL, FLASH_FP32_MAX_REL))
            if not (fin and max_rel <= tol[0] and mean_rel <= tol[1]):
                bad.append(f"K4 {dt} {shape}: max_rel {max_rel:.3e} mean_rel {mean_rel:.3e}")
        return bad


def ceiling_probes(G, B: int, tokens: int) -> list:
    """K6's ceiling at the served shapes, the port's counterpart of
    tools/bench_int8_kernel.py's raw probe: for each distinct (K, N) of the
    tower's Linears, the first such Linear's int8 mirror and random int8
    activations of the served batch (M = B x tokens) for K10."""
    import torch

    from vfm_vae_tpu_torch.models.layers import Linear

    gen = torch.Generator(device=next(G.parameters()).device).manual_seed(23)
    probes = {}
    for m in G.vfm_encoder.tower.encoder.layers.modules():
        if isinstance(m, Linear) and tuple(m.wq.shape) not in probes:
            N, K = m.wq.shape
            xq = torch.randint(-127, 128, (B * tokens, K), generator=gen, device=m.wq.device,
                               dtype=torch.int8)
            probes[(N, K)] = (m, xq)
    return list(probes.values())


def int8_serving_phase(G, card: str) -> dict:
    """The README's fast serving configuration on the flagship G: the flash
    switches on, enable_int8_tower on 32 seeded random 256 px images
    (bench.py's run_int8), three encode -> decode requests at B=4, gates on
    shapes, finiteness and launch counts; K10 at the served shapes as K6's
    ceiling probe, counted apart; every K6 and K4 site of one int8 encode
    against its twin on that site's own inputs; the int8 encode's and
    decode's distance from fp32 against the all-plain int8 path's; img/s of
    encode-only and round trip with the bf16 and the int8 tower at B=4 and
    B=32; one profiled int8 encode. Returns the launch counts of the
    serving path and of the ceiling probe, by path."""
    import torch

    from vfm_vae_tpu_torch.entry import FLAGSHIP_KWARGS
    from vfm_vae_tpu_torch.models.generator import Generator
    from vfm_vae_tpu_torch.ops import kernels
    from vfm_vae_tpu_torch.ops.quantized import enable_int8_tower

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    B, n_req = 4, 3
    requests = [torch.rand((B, 256, 256, 3), generator=gen, device=dev) for _ in range(n_req)]
    calib = torch.rand((32, 256, 256, 3), generator=gen, device=dev)

    # References before the tower is quantized: the bf16 tower with the flash
    # switches on (kernels, and the plain twins), and an fp32 encode and
    # round trip through the plain twins.
    with serving_env(int8=False):
        m_bf = G.encode(requests[0], return_z_before_quantize=True)
        x_bf = G.decode(G.encode(requests[0]))
        G.use_plain_kernels(True)
        m_bf_p = G.encode(requests[0], return_z_before_quantize=True)
        G.use_plain_kernels(False)
    G32 = Generator(**FLAGSHIP_KWARGS, dtype=torch.float32, device=dev)
    G32.load_state_dict(G.state_dict())
    G32.use_plain_kernels(True)
    m_32 = G32.encode(requests[0], return_z_before_quantize=True)
    x_32 = G32.decode(G32.encode(requests[0]))
    torch.cuda.synchronize()
    del G32
    torch.cuda.empty_cache()

    with serving_env(int8=True):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        n_cal = enable_int8_tower(G, calib)
        torch.cuda.synchronize()
        print(f"[int8] enable_int8_tower: {n_cal} Linears calibrated on {calib.shape[0]} images "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        sites = encode_sites(G, int8=True)
        if not all(s["static"] for s in sites["int8_matmul"]):
            raise SystemExit("chip_smoke: a tower Linear has no calibrated scale")
        outs = []
        for img in requests:
            z = G.encode(img)
            outs.append((z, G.decode(z)))
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        want = predicted_serving(sites, n_req)
        print(f"[int8] launches over calibration + {n_req} requests: {launches}; predicted "
              f"{want}", flush=True)
        if launches != want:
            raise SystemExit("chip_smoke: int8 serving launch counts differ from kernel_sites' "
                             "prediction")
        for i, (z, x) in enumerate(outs):
            if tuple(z.shape) != (B, 16, 16, 32) or tuple(x.shape) != (B, 256, 256, 3):
                raise SystemExit(f"chip_smoke: int8 request {i}: shapes {tuple(z.shape)} "
                                 f"{tuple(x.shape)}")
            if not (torch.isfinite(z).all() and torch.isfinite(x).all()):
                raise SystemExit(f"chip_smoke: int8 request {i}: non-finite output")

        # K6's ceiling probe (tools/bench_int8_kernel.py's raw int8 dot): a
        # path of its own, not part of serving, counted apart.
        probes = ceiling_probes(G, B, sites["int8_matmul"][0]["M"])
        kernels.reset_launch_counts()
        for lin, xq in probes:
            kernels.int8_matmul_raw(xq, lin.wq)
        torch.cuda.synchronize()
        probe_launches = kernels.launch_counts()
        if probe_launches != {fn.__name__: len(probes) if fn is kernels.int8_matmul_raw else 0
                              for fn in kernels.ALL_WRAPPERS}:
            raise SystemExit(f"chip_smoke: ceiling probe launches {probe_launches}")

        # Each K6 and K4 site of one int8 encode against its twin on that
        # site's own inputs.
        with site_checks() as chk:
            m_k = G.encode(requests[0], return_z_before_quantize=True)
        torch.cuda.synchronize()
        n6, n4 = (sum(s["count"] for s in sites[k])
                  for k in ("int8_matmul", "flash_attention_nonull"))
        bad = chk.failures()
        k4_bf = [r for r in chk.k4 if r[0] == torch.bfloat16]
        k4_32 = [r for r in chk.k4 if r[0] != torch.bfloat16]
        print(f"[int8] every site of one int8 encode (B={B}) vs its twin on the same inputs: "
              f"{len(chk.k6)} K6 (expected {n6}), max {max(r[2] for r in chk.k6):g} ulps "
              f"(gate: bit for bit); {len(k4_bf)} K4 bf16 max_rel "
              f"{max(r[2] for r in k4_bf):.3e} mean_rel {max(r[3] for r in k4_bf):.3e} (tol "
              f"{TOLERANCES['flash_attention_nullkv']}); {len(k4_32)} K4 fp32 max_rel "
              f"{max(r[2] for r in k4_32):.3e} (tol {FLASH_FP32_MAX_REL:g})", flush=True)
        if bad or len(chk.k6) != n6 or len(chk.k4) != n4:
            raise SystemExit(f"chip_smoke: int8 serving sites disagree with their twins: {bad}")

        G.use_plain_kernels(True)
        m_p = G.encode(requests[0], return_z_before_quantize=True)
        x_p = G.decode(G.encode(requests[0]))
        m_p_more = [G.encode(img, return_z_before_quantize=True) for img in requests[1:]]
        G.use_plain_kernels(False)
        m_k_more = [G.encode(img, return_z_before_quantize=True) for img in requests[1:]]
        torch.cuda.synchronize()
        x_k = outs[0][1]
        mom_k32, mom_p32 = rel_l1(m_k, m_32), rel_l1(m_p, m_32)
        err_k, err_p = rel_l1(x_k, x_32), rel_l1(x_p, x_32)
        kp = [rel_l1(a, b) for a, b in zip([m_k, *m_k_more], [m_p, *m_p_more])]
        print(f"[int8] latent moments, rel-L1 vs fp32 tower: kernel int8 {mom_k32:.3e}, plain "
              f"int8 {mom_p32:.3e} (limit {TRUTH_FACTOR} x plain); reported, not gated (random "
              f"weights): kernel vs all-plain int8 at the {n_req} requests "
              f"{', '.join(f'{e:.3e}' for e in kp)}, bf16 tower K4 kernel vs twin "
              f"{rel_l1(m_bf, m_bf_p):.3e}, int8 vs bf16 tower {rel_l1(m_k, m_bf):.3e}, bf16 "
              f"tower vs fp32 {rel_l1(m_bf, m_32):.3e}", flush=True)
        print(f"[int8] decode vs fp32 round trip: rel-L1 kernel int8 {err_k:.3e}, plain int8 "
              f"{err_p:.3e} (limit {TRUTH_FACTOR} x plain), bf16-tower kernel "
              f"{rel_l1(x_bf, x_32):.3e}; PSNR int8 vs bf16 tower {psnr(x_k, x_bf):.2f} dB, "
              f"int8 vs fp32 {psnr(x_k, x_32):.2f} dB", flush=True)
        if not (mom_k32 <= TRUTH_FACTOR * mom_p32 + 1e-6 and err_k <= TRUTH_FACTOR * err_p + 1e-6):
            raise SystemExit("chip_smoke: the kernel int8 path is further from fp32 than the "
                             "plain int8 path")
        for lin, xq in probes:
            x = torch.randn(xq.shape, generator=gen, device=dev).to(torch.bfloat16)
            a_s = getattr(lin, "as")
            k6 = cuda_time_ms(lambda: kernels.int8_matmul(x, lin.wq, lin.ws, lin.bias, a_s))
            k10 = cuda_time_ms(lambda: kernels.int8_matmul_raw(xq, lin.wq))
            M, K = xq.shape
            print(f"[int8] served shape M={M} K={K} N={lin.wq.shape[0]} (B={B}): K6 static "
                  f"{k6:.4f} ms, its ceiling K10 {k10:.4f} ms ({100 * k10 / k6:.0f}%)", flush=True)

    for bs in (4, 32):
        img = torch.rand((bs, 256, 256, 3), generator=gen, device=dev)
        line = []
        for tower in ("bf16", "int8"):
            with serving_env(int8=tower == "int8"):
                for what, fn in (("encode", lambda: G.encode(img)),
                                 ("round trip", lambda: G.decode(G.encode(img)))):
                    fn()
                    torch.cuda.synchronize()
                    reps = 5
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
                    dt = (time.perf_counter() - t0) / reps
                    line.append(f"{tower} tower {what} {bs / dt:.2f} img/s ({dt * 1e3:.1f} ms)")
        print(f"[int8] B={bs} on {card}, flash switches on: " + "; ".join(line), flush=True)
    with serving_env(int8=True):
        profile_device(lambda: G.encode(img), f"int8 encode B={img.shape[0]}")
    return {"int8_serving": launches, "int8_ceiling_probe": probe_launches}


def bn_fed_bias(name: str) -> bool:
    """A D head's conv bias that feeds BatchNormLocal: the mean subtraction
    makes its gradient exactly zero in exact arithmetic (rounding noise on
    the card), so the gradient gates hold it apart."""
    return name.startswith("D.heads.") and name.endswith((".main0.conv.bias",
                                                          ".main1.conv.bias"))


def predicted_launches(G, buckets) -> dict:
    """Launches of one [D, G] step per bucket, under the switches set now: G
    runs forward in the D phase and in the G phase (every forward kernel at
    each site of that bucket's encode and decode), and two backward passes
    reach the decoder in the G phase (the adaptive VF weight's pull of the
    reconstruction terms and the training pull), each running K3's two
    backward kernels at every attention site. Both anchor pulls stop at the
    anchor (the last final_quant block's MLP output projection), upstream of
    which lie the encode side's attentions, so only the training pull runs
    K4's backward there, once at each site; post_quant (the decode side)
    lies downstream of it and takes two. A latent bucket encodes the full
    image, a prior bucket the shrunk one. K1/K9's, K2's and K5's backward
    passes are PyTorch."""
    from vfm_vae_tpu_torch.entry import eq_image_size, kernel_sites
    from vfm_vae_tpu_torch.ops import kernels

    want = {fn.__name__: 0 for fn in kernels.ALL_WRAPPERS}
    full = G.synthesis.block_resolutions[-1]
    for eq in buckets:
        # A latent bucket encodes the full image and resizes z; a prior bucket
        # shrinks the tower's input with z.
        dec = kernel_sites(G, eq_image_size(G, eq))
        enc = kernel_sites(G, eq_image_size(G, eq) if eq[2] else full)
        sites = {name: [s for s in (enc if name in ENCODE_KERNELS else dec)[name]
                        if s.get("at") != "post_quant"]
                 + [s for s in dec[name] if name in ENCODE_KERNELS and s["at"] == "post_quant"]
                 for name in dec}
        for name, n in forward_counts(sites).items():
            want[name] += 2 * n
        n_att = sum(s["count"] for s in sites["flash_attention_nullkv"])
        want["flash_attention_nullkv_bwd_dkv"] += 2 * n_att
        want["flash_attention_nullkv_bwd_dq"] += 2 * n_att
        for name in K4_BWD:  # post_quant lies downstream of the anchor: both pulls
            want[name] += sum(s["count"] * (2 if s["at"] == "post_quant" else 1)
                              for s in sites[name])
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

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    t0 = time.perf_counter()
    tr = flagship_trainer(dev, B, gen, allow_random_lpips=True)
    randomize_zero_init_branches(tr.G, seed=2)
    torch.cuda.synchronize()
    params = named_params(tr)
    trainable = {"G." + n for n in tr.g_params} | {"D." + n for n in tr.d_params}
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
    state = tr.init_state()
    state, launches = train_steps(tr, state, buckets, reals, gen, card, "train")
    profile_device(lambda: tr.g_step(state, reals[1], buckets[1], gen),
                   f"G step B={B} eq={buckets[1]}")
    return tr, state, reals[0], launches


GRAD_HISTORY: dict = {}  # tensor name -> ["label:step:raw gradient norm"] over train_steps calls


def train_steps(tr, state, buckets, reals, gen, card: str, label: str):
    """One [D, G] step per bucket (the first a warm-up), timed, with the
    training gates: finite losses, a nonzero gradient in some step for every
    trainable tensor, every trainable tensor moved by some step and every
    frozen one (SigLIP, DINO, LPIPS) bit-identical, every EMA tensor moved,
    and the launch counts predicted_launches gives for the switches set now.
    Returns (state, launches).

    Both gates look at each step, not at the first or at the phase as a
    whole. A D head's cls bias takes the hinge loss's gradient
    (#fake - #real logits inside the margin) / N, exactly zero when the
    counts tie, as they do when every logit lies inside the margin. A
    scalar's Adam steps can sum to less than half its spacing and bring it
    back to its starting bits. A tensor that no step moved, or whose
    gradient was zero in every step, fails with its per-step story."""
    import torch

    from vfm_vae_tpu_torch.ops import kernels
    from vfm_vae_tpu_torch.train.train_step import G_STAT_NAMES

    B = reals[0].shape[0]
    params = named_params(tr)
    trainable = {"G." + n for n in tr.g_params} | {"D." + n for n in tr.d_params}
    frozen = [n for n in params if n not in trainable]
    before = {n: p.detach().clone() for n, p in params.items()}
    ema0 = {k: v.clone() for k, v in state.ema.items()}
    nimg0 = state.cur_nimg
    want = predicted_launches(tr.G, buckets)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    tr.record_grad_norms = True
    d_ms, g_ms = [], []
    step_norms, step_moved = [], []  # per step: raw gradient norms, tensors that moved
    prev = {n: p.detach().clone() for n, p in params.items() if n in trainable}
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
        step_norms.append(dict(tr.grad_norms))
        for n, v in tr.grad_norms.items():
            GRAD_HISTORY.setdefault(n, []).append(f"{label}:{i}:{v:.3e}")
        step_moved.append({n for n in prev if not torch.equal(prev[n], params[n])})
        for n in step_moved[-1]:
            prev[n].copy_(params[n])
        stats = {**d_stats, **g_stats}
        vals = torch.stack([v for v in stats.values()] + [d_total.reshape(1).expand(3),
                                                          g_total.reshape(1).expand(3)])
        if not bool(torch.isfinite(vals).all()):
            raise SystemExit(f"chip_smoke: {label} step {i}: a loss term is not finite")
        mean = {k: float(v[1] / v[0]) for k, v in stats.items()}
        terms = " ".join(f"{n}={mean[G_STAT_NAMES[n]]:.4g}" for n in
                         ("l1_pixel_loss", "perceptual_loss", "multiscale_pixel_loss",
                          "stylegan_t_gen_loss", "vf_loss", "kl_loss"))
        print(f"[{label}] step {i} ({'warm-up' if i == 0 else 'timed'}) eq={eq} z "
              f"{tr.G.ldm_adapter.z_resolution * eq[0]:g} px: D {d_ms[-1]:.1f} ms G "
              f"{g_ms[-1]:.1f} ms; D total {float(d_total):.4g} G total {float(g_total):.4g} "
              f"{terms} vf_w={mean['Loss/G/cur_vf_loss_weight']:.4g}", flush=True)
    tr.record_grad_norms = False
    del prev
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[{label}] launches over {len(buckets)} [D, G] steps: {launches}; predicted {want}",
          flush=True)
    if launches != want:
        raise SystemExit(f"chip_smoke: {label} launch counts differ from kernel_sites' "
                         "prediction")
    n_t = len(buckets) - 1
    print(f"[{label}] B={B} on {card}: D step {statistics.median(d_ms[1:]):.1f} ms, G step "
          f"{statistics.median(g_ms[1:]):.1f} ms (median of the {n_t} timed steps; D "
          f"{', '.join(f'{x:.1f}' for x in d_ms[1:])}, G {', '.join(f'{x:.1f}' for x in g_ms[1:])}); "
          f"peak memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated)", flush=True)

    after = named_params(tr)
    gated = sorted(n for n in trainable if not bn_fed_bias(n))
    zero = [n for n in gated if all(d[n] == 0 for d in step_norms)]
    unchanged = [n for n in gated if not any(n in m for m in step_moved)]
    returned = [n for n in gated if n not in unchanged and torch.equal(before[n], after[n])]
    moved = sorted(n for n in frozen if not torch.equal(before[n], after[n]))
    still = sorted(k for k in state.ema if torch.equal(ema0[k], state.ema[k]))
    bn = sorted(n for n in trainable if bn_fed_bias(n))
    first = step_norms[0]
    print(f"[{label}] gradients: {len(gated) - len(zero)}/{len(gated)} trainable tensors with a "
          f"nonzero gradient in some step ({sum(first[n] > 0 for n in gated)} in the first, min "
          f"{min(first[n] for n in gated):.3e}); {len(bn)} BatchNormLocal-fed head biases (zero "
          f"in exact arithmetic) had norms up to {max(first[n] for n in bn):.3e}", flush=True)
    print(f"[{label}] after {len(buckets)} steps: {len(gated) - len(unchanged)}/{len(gated)} "
          f"trainable tensors moved by some step ({len(returned)} back at their starting bits: "
          f"{returned[:4]}), {len(frozen) - len(moved)}/{len(frozen)} frozen (SigLIP, DINO, "
          f"LPIPS) unchanged bit for bit, {len(state.ema) - len(still)}/{len(state.ema)} EMA "
          f"tensors moved, cur_nimg {state.cur_nimg}", flush=True)

    def story(n: str) -> str:
        """A gated tensor's raw gradient norm and movement per step, its
        Adam state and its gradient norms in the earlier gated phases."""
        p = params[n]
        opt = state.g_opt if n.startswith("G.") else state.d_opt
        st = opt.state.get(p)
        b2 = opt.param_groups[0]["betas"][1]
        rms = (float((st["exp_avg_sq"] / (1 - b2 ** float(st["step"]))).sqrt().max())
               if st else None)
        a = p.detach().abs().float()
        return (f"{n}: raw gradient norm per step {[d[n] for d in step_norms]}, moved "
                f"{[n in m for m in step_moved]}, |p| max {float(a.max()):.4e}, spacing min "
                f"{float((torch.nextafter(a, a + 1) - a).min()):.3e}, Adam step "
                f"{float(st['step']) if st else None}, sqrt(v_hat) max {rms}, history "
                f"{GRAD_HISTORY.get(n)}")

    odd = [n for n in gated if any(not math.isfinite(d[n]) for d in step_norms)]
    for n in sorted(set(zero) | set(unchanged) | set(returned) | set(odd)):
        print(f"[{label}] {story(n)}", flush=True)
    if (zero or unchanged or moved or still
            or state.cur_nimg != nimg0 + B * len(buckets)):
        raise SystemExit(f"chip_smoke: {label} gates failed: zero grad {zero[:4]}, unchanged "
                         f"{unchanged[:4]}, frozen moved {moved[:4]}, EMA still {still[:4]}; "
                         + "; ".join(story(n) for n in sorted(set(zero + unchanged))[:2]))
    return state, launches


def determinism_phase(tr, state, real, trials: int = 1) -> None:
    """[D, G] steps with no random draws (posterior mode, no DiffAugment, D
    resizes instead of cropping), without the update: the kernel path, the
    plain-twin path (bf16) and an fp32 plain copy on the same weights and
    batch. Trial 0 takes the training phase's first batch at the identity
    bucket; trial i > 0 a batch drawn from a generator seeded i at
    FORCED_BUCKETS[i % 3].

    The gate is paired: for each loss term and module gradient norm, the
    kernel path's relative error vs fp32 over the plain path's, and the
    median of these ratios must be at most TRUTH_FACTOR. Most quantities
    carry an error that both bf16 paths share (ratio near 1), a few (a D
    head's gradient, which hangs on the statistics of four images) move by
    several percent between any two bf16 evaluations. Unpaired, the median
    kernel error over the median plain error read 0.86-1.07 in four runs
    of one tree on the H100 and past 1.5 in another: the two medians fall on
    different quantities. The paired median read 0.98-1.00 in the same four
    runs, and 0.96-1.15 over eight batches of a later run whose unpaired
    ratios spread over 0.59-1.70. The unpaired reading is printed beside it."""
    import torch

    from vfm_vae_tpu_torch.entry import flagship_trainer
    from vfm_vae_tpu_torch.train.loss import G_TERMS

    dev = real.device
    bufs = {"G": {k: v.clone() for k, v in tr.G.named_buffers()},
            "D": {k: v.clone() for k, v in tr.D.named_buffers()}}

    def run(t, st, img, eq):
        for mod, key in ((t.G, "G"), (t.D, "D")):  # spectral-norm u/v and x_avg as they were
            for k, v in mod.named_buffers():
                v.copy_(bufs[key][k])
        t.record_grad_norms, t.grad_norms = True, {}
        _, d_total, aux = t.d_gradients(st, img, eq)
        _, terms, _, _, g_total = t.g_gradients(st, img, eq, update_buffers=False)
        t.record_grad_norms = False
        out = {"D total": float(d_total), "G total": float(g_total)}
        out.update({"G " + n: float(v) for n, v in zip(G_TERMS, terms) if float(v) != 0.0})
        groups = {}
        for n, v in t.grad_norms.items():
            key = ".".join(n.split(".")[:4])
            groups[key] = groups.get(key, 0.0) + v * v
        out.update({"|grad| " + k: math.sqrt(v) for k, v in groups.items()})
        return out

    tr32 = flagship_trainer(dev, real.shape[0], torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.float32, allow_random_lpips=True)
    tr32.G.load_state_dict(tr.G.state_dict())
    tr32.D.load_state_dict(tr.D.state_dict())
    tr32.loss.lpips.load_state_dict(tr.loss.lpips.state_dict())
    tr32.G.use_plain_kernels(True)
    state32 = tr32.init_state()
    failed = []
    for trial in range(trials):
        if trial == 0:
            img, eq = real, (1.0, 0, False)
        else:
            gen = torch.Generator(device=dev).manual_seed(trial)
            img = torch.rand(real.shape, generator=gen, device=dev)
            eq = FORCED_BUCKETS[trial % len(FORCED_BUCKETS)]
        kern = run(tr, state, img, eq)
        tr.G.use_plain_kernels(True)
        plain = run(tr, state, img, eq)
        tr.G.use_plain_kernels(False)
        exact = run(tr32, state32, img, eq)
        keys = [k for k in exact if exact[k] != 0.0]
        ek = [abs(kern[k] - exact[k]) / abs(exact[k]) for k in keys]
        ep = [abs(plain[k] - exact[k]) / abs(exact[k]) for k in keys]
        # Below 1e-6 a relative error is fp32's own rounding: equal floors
        # make two such quantities a ratio of 1.
        ratios = [max(a, 1e-6) / max(b, 1e-6) for a, b in zip(ek, ep)]
        lines = [f"[determinism] trial {trial} eq={eq} {k}: fp32 {exact[k]:.6g} kernel "
                 f"{kern[k]:.6g} (rel {a:.2e}) plain {plain[k]:.6g} (rel {b:.2e})"
                 for k, a, b in zip(keys, ek, ep)]
        print("\n".join(lines), flush=True)
        paired, mk, mp = (statistics.median(v) for v in (ratios, ek, ep))
        ok = paired <= TRUTH_FACTOR
        summary = (f"[determinism] trial {trial} eq={eq}: {len(keys)} quantities (loss terms, "
                   f"per-module gradient norms): median of kernel/plain relative errors vs fp32 "
                   f"{paired:.3f} (limit {TRUTH_FACTOR}); kernel worse in "
                   f"{sum(r > 1 for r in ratios)}/{sum(r != 1 for r in ratios)}; unpaired median "
                   f"kernel {mk:.3e} plain {mp:.3e} (ratio {mk / max(mp, 1e-12):.3f}; means "
                   f"{sum(ek) / len(ek):.3e} and {sum(ep) / len(ep):.3e}) {'OK' if ok else 'FAIL'}")
        print(summary, flush=True)
        if not ok:
            print("\n".join(lines + [summary]), file=sys.stderr, flush=True)
            failed.append(trial)
    del tr32, state32
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"chip_smoke: the kernel training step is further from fp32 than the "
                         f"plain bf16 step (trials {failed})")


# ------------------------------------------------------------------ slice 4


def stats_errors(s1, s2, x):
    """K5's bounds: (max |s1 - exact| / sum |x|, max |s2 - exact| / exact)
    per (sample, channel), against fp64 sums of x."""
    xd = x.double()
    e1, e2, a1 = xd.sum((1, 2)), xd.square().sum((1, 2)), xd.abs().sum((1, 2))
    return (float(((s1.double() - e1).abs() / a1.clamp_min(1e-300)).max()),
            float(((s2.double() - e2).abs() / e2.clamp_min(1e-300)).max()))


def plain_bound(ops: float, byts: float, peak: float):
    """(least ms, "operations" or "bytes") of `ops` at `peak` and `byts` at HBM's rate."""
    a, b = ops / peak * 1e3, byts / PEAK_BYTES_PER_S * 1e3
    return max(a, b), ("operations" if a >= b else "bytes")


def kernel_stats_phase(G, batches=(2, 32)) -> dict:
    """K5 against its twin and fp64 sums at every K5 site of a flagship decode
    (VFM_VAE_PALLAS_STATS=1) and, at the first batch, at the EQ decodes'
    shapes, bf16 O(1) inputs with an offset (s1 then cancels); two launches
    on one input must agree bit for bit, and a call must be one kernel on
    the card (the profiler's count); kernel (CUDA events and device time),
    twin and bound times over one decode's sites at each batch."""
    import torch

    from vfm_vae_tpu_torch.entry import kernel_sites
    from vfm_vae_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(55)
    with env_vars({"VFM_VAE_PALLAS_STATS": "1"}):
        flag = kernel_sites(G, 256)["channel_moments"]
        seen = {(s["C"], s["H"]) for s in flag}
        cases = [(s, "flagship") for s in flag]
        for hw in (64, 128, 192):
            for s in kernel_sites(G, hw)["channel_moments"]:
                if (s["C"], s["H"]) not in seen:
                    seen.add((s["C"], s["H"]))
                    cases.append((dict(s, count=0), f"eq{hw}"))
    totals, worst, by, failed = {}, 0.0, {}, []
    for B in batches:
        tot = totals[B] = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, device_ms=0.0)
        for site, tag in cases if B == batches[0] else cases[:len(flag)]:
            C, H, n = site["C"], site["H"], site["count"]
            x = (torch.randn((B, H, H, C), generator=gen, device=dev) * 1.5
                 + 0.5).to(torch.bfloat16)
            s1, s2 = kernels.channel_moments(x)
            r1, r2 = kernels.channel_moments(x)
            t1, t2 = kernels.channel_moments(x, plain=True)
            torch.cuda.synchronize()
            repeat = torch.equal(s1, r1) and torch.equal(s2, r2)
            k1, k2 = stats_errors(s1, s2, x)
            p1, p2 = stats_errors(t1, t2, x)
            finite = bool(torch.isfinite(s1).all() and torch.isfinite(s2).all())
            per_call = device_launches(lambda: kernels.channel_moments(x))
            one = sum(per_call.values()) == 1
            ok = finite and repeat and one and k1 <= STATS_REL and k2 <= STATS_REL
            worst = max(worst, float((s1 - t1).abs().max()), float((s2 - t2).abs().max()))
            line = ""
            if n:
                ms = cuda_time_ms(lambda: kernels.channel_moments(x))
                plain_ms = cuda_time_ms(lambda: kernels.channel_moments(x, plain=True))
                dev_ms = device_ms(lambda: kernels.channel_moments(x))
                bnd, b_by = plain_bound(3 * x.numel(), 2 * x.numel() + 8 * B * C,
                                        PEAK_FP32_FLOPS)
                by[b_by] = by.get(b_by, 0) + n
                for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bnd),
                                 ("device_ms", dev_ms)):
                    tot[key] = None if val is None or tot[key] is None else tot[key] + val * n
                line = (f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bnd:.4f} "
                        f"({b_by}) device_ms={ms_text(dev_ms)} x{n}/decode")
            print(f"[kernel-stats] {tag} C={C} H=W={H} B={B}: s1 err/sum|x| kernel {k1:.2e} "
                  f"twin {p1:.2e}, s2 rel kernel {k2:.2e} twin {p2:.2e} (tol {STATS_REL:g}); "
                  f"two launches bit-identical {repeat}; kernels a call {per_call}; "
                  f"finite={finite}{line} {'OK' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append(f"{tag} C={C} H={H} B={B}")
            del x, s1, s2, r1, r2, t1, t2
        print(f"[kernel-stats] all {sum(s['count'] for s in flag)} K5 sites of one decode at "
              f"B={B}: kernel {tot['ms']:.4f} ms (device {ms_text(tot['device_ms'])}), plain "
              f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms", flush=True)
    if failed:
        raise SystemExit(f"chip_smoke: kernel-stats phase FAILED at {failed}")
    B = batches[0]
    return {"channel_moments": dict(max_abs_err=worst, batch=B, bound_by=max(by, key=by.get),
                                    library_ms=None, **totals[B],
                                    **{f"b{b}": totals[b] for b in batches[1:]})}


def kernel_pipeline_phase(sites: dict, eq_sites: dict, B: int = 2) -> dict:
    """K9 against K1 on the same inputs at every K1 site of a flagship decode
    and of the EQ decodes: 0 ulps (torch.equal), and each bit-identical on a
    second call; K9's, K1's and the twin's
    times over one decode's sites. No PyTorch call computes the function:
    K1 is the comparison."""
    import torch

    from vfm_vae_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(66)
    name = "fused_convnext_mlp"
    cases = [(s, "flagship") for s in sites[name]]
    seen = {(s["C"], s["H"]) for s in sites[name]}
    for hw, ss in eq_sites.items():
        for s in ss[name]:
            if (s["C"], s["H"]) not in seen:
                seen.add((s["C"], s["H"]))
                cases.append((dict(s, count=0), f"eq{hw}"))
    tot = dict(ms=0.0, k1_ms=0.0, plain_ms=0.0)
    worst, failed = 0.0, []
    for site, tag in cases:
        args = kernel_inputs(name, site, B, gen, dev)
        got = kernels.fused_convnext_mlp_pipelined(**args)
        ref = kernels.fused_convnext_mlp(**args)
        k9_again = kernels.fused_convnext_mlp_pipelined(**args)
        k1_again = kernels.fused_convnext_mlp(**args)
        torch.cuda.synchronize()
        repeat = torch.equal(got, k9_again) and torch.equal(ref, k1_again)
        exact = torch.equal(got, ref) and repeat
        diff = float((got.float() - ref.float()).abs().max())
        worst = max(worst, diff)
        line = ""
        if site["count"]:
            ms = cuda_time_ms(lambda: kernels.fused_convnext_mlp_pipelined(**args))
            k1 = cuda_time_ms(lambda: kernels.fused_convnext_mlp(**args))
            pm = cuda_time_ms(lambda: kernels.fused_convnext_mlp(**args, plain=True))
            for key, val in (("ms", ms), ("k1_ms", k1), ("plain_ms", pm)):
                tot[key] += val * site["count"]
            line = f" K9_ms={ms:.4f} K1_ms={k1:.4f} plain_ms={pm:.4f} x{site['count']}/decode"
        print(f"[kernel-pipeline] {tag} C={site['C']} H={site['H']} B={B}: K9 vs K1 max_abs="
              f"{diff:.3e} bit-exact {torch.equal(got, ref)} K1 and K9 repeat-identical "
              f"{repeat}{line} {'OK' if exact else 'FAIL'}", flush=True)
        if not exact:
            failed.append(f"{tag} C={site['C']} H={site['H']}")
    if failed:
        raise SystemExit(f"chip_smoke: kernel-pipeline phase FAILED at {failed}")
    bnd, by = bound(name, sites[name], B)
    print(f"[kernel-pipeline] all K1 sites of one decode at B={B}: K9 {tot['ms']:.4f} ms, K1 "
          f"{tot['k1_ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound {bnd:.4f} ms ({by})",
          flush=True)
    return {"fused_convnext_mlp_pipelined": dict(max_abs_err=worst, batch=B, bound_ms=bnd,
                                                 bound_by=by, library_ms=None, **tot)}


def mlp_batch_phase(sites, batches=(2, 32)) -> dict:
    """K1 and K9 at every K1 site of a flagship decode at B=2 and B=32: K1
    against its twin (TOLERANCES) and fp32 (TRUTH_FACTOR), K1 and K9
    bit-identical on a second call and K9 == K1; CUDA-event and device
    (profiler) times of K1 and K9, the fraction of the bound (its tensor-core,
    byte and GELU terms printed), and the cuBLAS composition in turns with
    K1 (events and device): two cuBLAS bf16 GEMMs and PyTorch's elementwise
    steps, which round and store the hidden, so not the same function: a
    yardstick the port never calls."""
    import torch

    from vfm_vae_tpu_torch.ops import kernels
    from vfm_vae_tpu_torch.probes.fused_mlp import cublas_composition

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    name = "fused_convnext_mlp"
    tol_max, tol_mean = TOLERANCES[name]
    out, failed = {}, []
    for B in batches:
        keys = ("k1_ms", "k1_device_ms", "k9_ms", "k9_device_ms", "composition_ms",
                "composition_device_ms", "bound_ms")
        tot = dict.fromkeys(keys, 0.0)
        rows = []
        for site in sites:
            args = kernel_inputs(name, site, B, gen, dev)
            k1 = lambda: kernels.fused_convnext_mlp(**args)  # noqa: E731
            k9 = lambda: kernels.fused_convnext_mlp_pipelined(**args)  # noqa: E731
            comp = lambda: cublas_composition(**args)  # noqa: E731
            got, again, p9, p9b = k1(), k1(), k9(), k9()
            ref = kernels.fused_convnext_mlp(**args, plain=True)
            truth = kernels.fused_convnext_mlp(
                **{k: v.float() for k, v in args.items()}, plain=True)
            torch.cuda.synchronize()
            _, max_rel, mean_rel = rel_errors(got, ref)
            k_truth, p_truth = rel_errors(got, truth)[2], rel_errors(ref, truth)[2]
            same = (torch.equal(got, again) and torch.equal(p9, p9b) and torch.equal(got, p9))
            ok = (bool(torch.isfinite(got.float()).all()) and max_rel <= tol_max
                  and mean_rel <= tol_mean and k_truth <= TRUTH_FACTOR * p_truth + 1e-6 and same)
            del ref, truth
            ms, ms9 = cuda_time_ms(k1), cuda_time_ms(k9)
            dev_ms, dev9 = device_ms(k1), device_ms(k9)
            k1_turn, comp_ms = in_turns(k1, comp)
            k1_dev_turn, comp_dev, _, _ = device_in_turns(k1, comp)
            t_ops, t_bytes, t_gelu = mlp_terms(site, B)
            bnd = max(t_ops, t_bytes, t_gelu)
            n = site["count"]
            for key, val in zip(keys, (ms, dev_ms, ms9, dev9, comp_ms, comp_dev, bnd)):
                tot[key] = add_or_none(tot[key], val, n)

            def frac(t):
                return "not measured" if t is None else f"{bnd / t:.3f}"

            row = dict(C=site["C"], H=site["H"], count=n, k1_ms=ms, k1_device_ms=dev_ms,
                       k9_ms=ms9, k9_device_ms=dev9, composition_ms=comp_ms,
                       composition_device_ms=comp_dev, bound_ms=bnd,
                       bound_terms_ms=dict(tensor_cores=t_ops, bytes=t_bytes, gelu=t_gelu))
            rows.append(row)
            print(f"[kernel-mlp] C={site['C']} H={site['H']} B={B}: max_rel={max_rel:.3e} "
                  f"mean_rel={mean_rel:.3e} vs_fp32 kernel={k_truth:.3e} plain={p_truth:.3e} "
                  f"K1/K9 repeat-identical, K9 == K1 {same}; K1 ms={ms:.4f} device "
                  f"{ms_text(dev_ms)} of_bound={frac(ms)} (device {frac(dev_ms)}); K9 ms="
                  f"{ms9:.4f} device {ms_text(dev9)}; bound {bnd:.4f} ms (tensor cores "
                  f"{t_ops:.4f}, bytes {t_bytes:.4f}, GELU {t_gelu:.4f}); in turns K1 "
                  f"{k1_turn:.4f} vs cuBLAS composition {comp_ms:.4f} (device {ms_text(k1_dev_turn)}"
                  f" vs {ms_text(comp_dev)}; not the same function) x{n}/decode "
                  f"{'OK' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append(f"C={site['C']} H={site['H']} B={B}")
            del args, got, again, p9, p9b
            torch.cuda.empty_cache()
        print(f"[kernel-mlp] the {sum(s['count'] for s in sites)} K1 sites of one decode at "
              f"B={B}: " + ", ".join(f"{k} {ms_text(v)}" for k, v in tot.items()), flush=True)
        out[B] = dict(sites=rows, **tot)
    if failed:
        raise SystemExit(f"chip_smoke: kernel-mlp phase FAILED at {failed}")
    return out


def upsample_batch_phase(sites, batches=(2, 32)) -> dict:
    """K2 at every flagship K2 site of a decode at B=2 and B=32: against its
    twin (TOLERANCES) and fp32 (TRUTH_FACTOR), bit-identical on a second
    call, one launch a call (the wrapper's counter over two calls, and the
    profiler's kernel count: one kernel); CUDA-event and device (profiler)
    times, the bound and the fraction of it that each reaches, and their sums
    over one decode's sites. No PyTorch call computes the function."""
    import torch

    from vfm_vae_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(77)
    name, fn = "fused_upsample_blur", kernels.fused_upsample_blur
    tol_max, tol_mean = TOLERANCES[name]
    out, failed = {}, []
    for B in batches:
        tot = dict(ms=0.0, device_ms=0.0, bound_ms=0.0)
        rows = []
        worst = 0.0
        for site in sites:
            args = kernel_inputs(name, site, B, gen, dev)
            before = fn.launches
            got, again = fn(**args), fn(**args)
            calls = fn.launches - before
            ref = fn(**args, plain=True)
            truth = fn(**{k: (v.float() if torch.is_tensor(v) else v) for k, v in args.items()},
                       plain=True)
            torch.cuda.synchronize()
            max_abs, max_rel, mean_rel = rel_errors(got, ref)
            k_truth, p_truth = rel_errors(got, truth)[2], rel_errors(ref, truth)[2]
            finite = bool(torch.isfinite(got.float()).all())
            same = torch.equal(got, again)
            del got, again, ref, truth
            torch.cuda.empty_cache()
            per_call = device_launches(lambda: fn(**args))
            one = calls == 2 and sum(per_call.values()) == 1
            ok = (finite and max_rel <= tol_max and mean_rel <= tol_mean
                  and k_truth <= TRUTH_FACTOR * p_truth + 1e-6 and same and one)
            ms, dev_ms = cuda_time_ms(lambda: fn(**args)), device_ms(lambda: fn(**args))
            bnd, by = bound(name, [dict(site, count=1)], B)
            n = site["count"]
            for key, val in (("ms", ms), ("device_ms", dev_ms), ("bound_ms", bnd)):
                tot[key] = add_or_none(tot[key], val, n)
            worst = max(worst, max_abs)

            def frac(t):
                return "not measured" if t is None else f"{bnd / t:.3f}"

            rows.append(dict(Ci=site["Ci"], Co=site["Co"], H=site["H"], taps=len(site["taps"]),
                             count=n, ms=ms, device_ms=dev_ms, bound_ms=bnd, bound_by=by))
            print(f"[kernel-upsample] Ci={site['Ci']} Co={site['Co']} H={site['H']} "
                  f"taps={len(site['taps'])} B={B}: max_rel={max_rel:.3e} (tol {tol_max:g}) "
                  f"mean_rel={mean_rel:.3e} (tol {tol_mean:g}) vs_fp32 kernel={k_truth:.3e} "
                  f"plain={p_truth:.3e} finite={finite} repeat-identical {same}; launches a "
                  f"call {calls / 2:g} (profiler: {per_call}); kernel_ms={ms:.4f} device "
                  f"{ms_text(dev_ms)} bound {bnd:.4f} ({by}) of_bound={frac(ms)} (device "
                  f"{frac(dev_ms)}) x{n}/decode {'OK' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append(f"Ci={site['Ci']} H={site['H']} B={B}")
            del args
            torch.cuda.empty_cache()
        frac_dev = ("not measured" if tot["device_ms"] is None
                    else f"{tot['bound_ms'] / tot['device_ms']:.3f}")
        print(f"[kernel-upsample] the {sum(s['count'] for s in sites)} K2 sites of one decode at "
              f"B={B}: events {tot['ms']:.4f} ms, device {ms_text(tot['device_ms'])}, bound "
              f"{tot['bound_ms']:.4f} (of_bound device {frac_dev})", flush=True)
        out[B] = dict(sites=rows, max_abs_err=worst, **tot)
    if failed:
        raise SystemExit(f"chip_smoke: kernel-upsample phase FAILED at {failed}")
    return out


def dwconv_inputs(site: dict, B: int, gen, dev):
    """x (B, H, H, C) bf16, w (k, k, C) and b (C,) fp32, noise (H, H) fp32."""
    import torch

    C, H, k = site["C"], site["H"], site["k"]
    x = torch.randn((B, H, H, C), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((k, k, C), generator=gen, device=dev) / k
    b = torch.randn(C, generator=gen, device=dev) * 0.5
    noise = torch.randn((H, H), generator=gen, device=dev) * 0.3
    return x, w, b, noise


def kernel_dwconv_phase(sites: dict, B: int = 2) -> dict:
    """K7 (noise on and off) and K8 against their twins at every ConvNeXt
    dwconv shape of a flagship decode: t within DWCONV_ULPS bf16 ulps, K7's
    statistics against fp64 sums of the kernel's own t at K5's bounds."""
    import torch

    from vfm_vae_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(77)
    worst = {"dwconv_noise_stats": 0.0, "depthwise_conv2d_same": 0.0}
    failed = []
    for site in sites["dwconv_noise_stats"]:
        x, w, b, noise = dwconv_inputs(site, B, gen, dev)
        line = []
        for tag, nz in (("noise", noise), ("no noise", None)):
            t, s1, s2 = kernels.dwconv_noise_stats(x, w, b, nz)
            rt, _, _ = kernels.dwconv_noise_stats(x, w, b, nz, plain=True)
            torch.cuda.synchronize()
            ulps = bf16_ulps(t, rt)
            e1, e2 = stats_errors(s1, s2, t)
            ok = bool(torch.isfinite(t.float()).all()) and ulps <= DWCONV_ULPS and max(
                e1, e2) <= STATS_REL
            worst["dwconv_noise_stats"] = max(worst["dwconv_noise_stats"],
                                              float((t.float() - rt.float()).abs().max()))
            line.append(f"K7 {tag} {ulps:g} ulps, stats {e1:.2e} / {e2:.2e}"
                        f"{'' if ok else ' FAIL'}")
            if not ok:
                failed.append(f"K7 {tag} {site_label(site)}")
        w8 = w[:, :, None, :].contiguous()
        got = kernels.depthwise_conv2d_same(x, w8, b)
        ref = kernels.depthwise_conv2d_same(x, w8, b, plain=True)
        torch.cuda.synchronize()
        ulps = bf16_ulps(got, ref)
        worst["depthwise_conv2d_same"] = max(worst["depthwise_conv2d_same"],
                                             float((got.float() - ref.float()).abs().max()))
        line.append(f"K8 {ulps:g} ulps{'' if ulps <= DWCONV_ULPS else ' FAIL'}")
        if ulps > DWCONV_ULPS:
            failed.append(f"K8 {site_label(site)}")
        print(f"[kernel-dwconv] {site_label(site)} B={B}: " + "; ".join(line)
              + f" (tol {DWCONV_ULPS:g} ulp, stats {STATS_REL:g})", flush=True)
    if failed:
        raise SystemExit(f"chip_smoke: kernel-dwconv phase FAILED at {failed}")
    return worst


def dwconv_work(site: dict, B: int, stats: bool):
    """(operations, bytes) of one K7 (stats) or K8 call: x read and t written
    once (bf16), w, b (and K7's noise, s1, s2) once; 2 k^2 flops per output
    (K7 adds the bias, the noise and three statistics flops)."""
    C, H, k = site["C"], site["H"], site["k"]
    n = B * H * H * C
    ops = 2 * k * k * n + (5 * n if stats else n)
    byts = 4 * n + 4 * (k * k * C + C) + ((4 * H * H + 8 * B * C) if stats else 0)
    return ops, byts


def dwconv_probe(G, B: int = 2) -> tuple:
    """The dwconv probe, the port's counterpart of tools/bench_dwstats.py: K7
    and K8 on the weights, bias and legacy noise map of every ConvNeXt layer
    of the flagship decoder, in a launch window of their own (no model path
    runs them); then each shape's kernel, twin and library times (cuDNN's
    depthwise F.conv2d, plus the noise add and the two reductions for K7)."""
    import torch
    import torch.nn.functional as F

    from vfm_vae_tpu_torch.entry import kernel_sites
    from vfm_vae_tpu_torch.models.convnext import ConvNeXtSynthesisLayer
    from vfm_vae_tpu_torch.ops import kernels
    from vfm_vae_tpu_torch.ops.resize import resize_bilinear

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(88)
    sites = kernel_sites(G, 256)
    calls = []
    for block, res in zip(G.synthesis.blocks, G.synthesis.block_resolutions):
        for m in block.modules():
            if isinstance(m, ConvNeXtSynthesisLayer):
                C = m.dwconv.weight.shape[0]
                w = m.dwconv.weight[:, 0].permute(1, 2, 0).float().contiguous()
                noise = (m.noise_const * m.noise_strength).float()
                if noise.shape != (res, res):
                    noise = resize_bilinear(noise[None, :, :, None], size=(res, res))[0, :, :, 0]
                x = torch.randn((B, res, res, C), generator=gen, device=dev).to(torch.bfloat16)
                calls.append((x, w, m.dwconv.bias.float().contiguous(), noise.contiguous()))
    want = {fn.__name__: 0 for fn in kernels.ALL_WRAPPERS}
    for name in PROBE_KERNELS:
        want[name] = sum(s["count"] for s in sites[name])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.no_grad():
        for x, w, b, noise in calls:
            kernels.dwconv_noise_stats(x, w, b, noise)
            kernels.depthwise_conv2d_same(x, w[:, :, None, :], b)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"[dwconv-probe] launches over the {len(calls)} ConvNeXt dwconvs of one decode at "
          f"B={B}: K7 {launches['dwconv_noise_stats']}, K8 {launches['depthwise_conv2d_same']}; "
          f"predicted {want['dwconv_noise_stats']}, {want['depthwise_conv2d_same']}", flush=True)
    if launches != want:
        raise SystemExit(f"chip_smoke: dwconv probe launches {launches}")

    out = {}
    for name in PROBE_KERNELS:
        stats = name == "dwconv_noise_stats"
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, device_ms=0.0)
        by = {}
        for site in sites[name]:
            x, w, b, noise = dwconv_inputs(site, B, gen, dev)
            C, k, n = site["C"], site["k"], site["count"]
            xc = x.permute(0, 3, 1, 2)  # NCHW view, channels-last in memory
            wc = w.permute(2, 0, 1)[:, None].to(torch.bfloat16).contiguous()
            bb = b.to(torch.bfloat16)
            if stats:
                fn = lambda: kernels.dwconv_noise_stats(x, w, b, noise)  # noqa: E731
                pfn = lambda: kernels.dwconv_noise_stats(x, w, b, noise, plain=True)  # noqa: E731
                nz = noise.to(torch.bfloat16)

                def lib():
                    y = (F.conv2d(xc, wc, bb, padding=k // 2, groups=C) + nz).float()
                    return y.sum((2, 3)), y.square().sum((2, 3))
            else:
                w8 = w[:, :, None, :].contiguous()
                fn = lambda: kernels.depthwise_conv2d_same(x, w8, b)  # noqa: E731
                pfn = lambda: kernels.depthwise_conv2d_same(x, w8, b, plain=True)  # noqa: E731
                lib = lambda: F.conv2d(xc, wc, bb, padding=k // 2, groups=C)  # noqa: E731
            ms, plain_ms, lib_ms = cuda_time_ms(fn), cuda_time_ms(pfn), cuda_time_ms(lib)
            dev_ms = device_ms(fn)
            ops, byts = dwconv_work(site, B, stats)
            bnd, b_by = plain_bound(ops, byts, PEAK_FP32_FLOPS)
            by[b_by] = by.get(b_by, 0) + n
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                             ("bound_ms", bnd), ("device_ms", dev_ms)):
                tot[key] = None if val is None or tot[key] is None else tot[key] + val * n
            print(f"[dwconv-probe] {'K7' if stats else 'K8'} C={C} H=W={site['H']} k={k} B={B}: "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                  f"bound_ms={bnd:.4f} ({b_by}) device_ms={ms_text(dev_ms)} {ops / ms / 1e9:.2f} "
                  f"TFLOP/s x{n}/decode",
                  flush=True)
        out[name] = dict(batch=B, bound_by=max(by, key=by.get), **tot)
        print(f"[dwconv-probe] {'K7' if stats else 'K8'}, all dwconvs of one decode at B={B}: "
              f"kernel {tot['ms']:.4f} ms (device {ms_text(tot['device_ms'])}), plain "
              f"{tot['plain_ms']:.4f} ms, library (cuDNN"
              f"{' + reductions' if stats else ''}) {tot['library_ms']:.4f} ms, bound "
              f"{tot['bound_ms']:.4f} ms", flush=True)
    return out, launches


def flash_bwd_work(name: str, B, Tq, Tk, N, D, itemsize):
    """(operations, bytes) of one K4-dkv or K4-dq call, K3's accounting
    without the null token."""
    pair = 2 * B * N * Tq * Tk * D
    q_tok, k_tok, row = B * Tq * N * D * itemsize, B * Tk * N * D * itemsize, B * N * Tq * 4
    if name == "flash_attention_nonull_bwd_dkv":  # S, dP, dV, dK; reads q, k, v, O, dO, L; D
        return 4 * pair, 3 * q_tok + 4 * k_tok + 2 * row
    return 3 * pair, 2 * q_tok + 3 * k_tok + 2 * row  # dq: S, dP, dQ; reads q, k, v, dO, L, D


def device_in_turns(fn_a, fn_b):
    """Device times of two alternatives measured in turns (a, b, b, a), each
    the mean of its two readings (None if the profiler saw no device time),
    and each one's kernels by name from its first reading (device_kernels)."""
    (a1, per_a), (b1, per_b) = device_kernels(fn_a), device_kernels(fn_b)
    b2, a2 = device_kernels(fn_b)[0], device_kernels(fn_a)[0]

    def mean(x, y):
        return None if x is None or y is None else (x + y) / 2

    return mean(a1, a2), mean(b1, b2), per_a, per_b


def k4_backward_phase(enc_sites, B: int = 2) -> tuple:
    """K4's backward kernels against their twin and an fp64 autograd
    evaluation: at every K4 site of the training path (the adapter's fp32
    sites) at B=2, counted per encode, and at the stage-0 step's B=4; at the
    card test's ragged fp32 shapes (Tq != Tk) and at d=128 in fp32; at the
    tower's bf16 shape and one bf16 d=128 shape. fp32 is held to
    FLASH_FP32_MAX_REL against the twin (max and mean), bf16 to K3-bwd's
    bounds; both to <= TRUTH_FACTOR x the twin's mean error against fp64
    (+1e-6) and to bit-identical gradients on a second call. The timed
    cases (the sites and the bf16 shapes) print the kernels' CUDA-event and
    device times, the twins', the one-call backward against SDPA's backward
    alone in turns (CUDA events and device time; SDPA's kernels by name),
    and forward+backward of the K4 Function and of SDPA in turns; fp32
    bounds at the 3xTF32 rate with the FMA bound beside them."""
    import torch
    import torch.nn.functional as F

    from vfm_vae_tpu_torch.ops import kernels
    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa

    dev, f32, bf = torch.device("cuda"), torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4444)
    adapter = [dict(s, Tk=s["T"], B=B, dt=f32, timed=True) for s in enc_sites
               if s["at"] == "adapter"]
    tower = next(s for s in enc_sites if s["at"] == "tower")
    cases = (adapter
             + [dict(s, B=4, at="adapter", count=0) for s in adapter]
             + [dict(T=Tq, Tk=Tk, N=N, D=D, at=at, count=0, B=2, dt=f32, timed=False)
                for Tq, Tk, N, D, at in ((77, 130, 4, 64, "ragged"), (300, 1000, 4, 64, "ragged"),
                                         (129, 640, 8, 128, "ragged"),
                                         (1024, 77, 8, 128, "ragged"),
                                         (1024, 1024, 8, 128, "d128"))]
             + [dict(tower, Tk=tower["T"], count=0, B=B, dt=bf, timed=True),
                dict(T=1024, Tk=1024, N=8, D=128, at="d128", count=0, B=B, dt=bf, timed=True)])
    acc = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, fma_bound_ms=0.0, max_abs_err=0.0,
                   library_ms=0.0, device_ms=0.0, b4={}) for n in K4_BWD}
    by = {n: {} for n in K4_BWD}
    fb = dict(ms=0.0, library_ms=0.0)
    failed = []
    for c in cases:
        Tq, Tk, N, D, Bc, dt, n_call = c["T"], c["Tk"], c["N"], c["D"], c["B"], c["dt"], c["count"]
        label = f"{c['at']} {str(dt).split('.')[-1]} Tq={Tq} Tk={Tk} N={N} D={D} B={Bc}"
        q, dout = (torch.randn(Bc, Tq, N, D, generator=gen, device=dev).to(dt) for _ in range(2))
        k, v = (torch.randn(Bc, Tk, N, D, generator=gen, device=dev).to(dt) for _ in range(2))
        scale = D ** -0.5
        out, lse = fa._launch_nonull(q, k, v, scale, True)

        def wrappers():
            dk, dv, delta = kernels.flash_attention_nonull_bwd_dkv(q, k, v, out, dout, lse)
            return kernels.flash_attention_nonull_bwd_dq(q, k, v, dout, lse, delta), dk, dv

        got, again = wrappers(), wrappers()
        twin = kernels.flash_attention_nonull_bwd_reference(q, k, v, out, lse, dout)
        leaves = [t.double().requires_grad_() for t in (q, k, v)]
        truth = torch.autograd.grad(attention_fp64(*leaves), leaves, dout.double())
        del leaves
        torch.cuda.synchronize()
        tol_max, tol_mean = ((FLASH_FP32_MAX_REL, FLASH_FP32_MAX_REL) if dt == f32
                             else BWD_TOLERANCE)
        line = []
        for nm, a, a2, b, t64 in zip(("dq", "dk", "dv"), got, again, twin[:3], truth):
            max_abs, max_rel, mean_rel = rel_errors(a, b)
            k64, p64 = rel_errors(a, t64)[2], rel_errors(b, t64)[2]
            finite, same = bool(torch.isfinite(a.float()).all()), torch.equal(a, a2)
            ok = (finite and same and max_rel <= tol_max and mean_rel <= tol_mean
                  and k64 <= TRUTH_FACTOR * p64 + 1e-6)
            line.append(f"{nm} max_rel={max_rel:.3e} mean_rel={mean_rel:.3e} (tol {tol_max:g}, "
                        f"{tol_mean:g}) vs_fp64 kernel={k64:.3e} plain={p64:.3e} repeat="
                        f"{'identical' if same else 'DIFFERS'}{'' if ok else ' FAIL'}")
            if not ok:
                failed.append(f"{label} {nm}")
            key = K4_BWD[1] if nm == "dq" else K4_BWD[0]
            acc[key]["max_abs_err"] = max(acc[key]["max_abs_err"], max_abs)
        del got, again, twin, truth
        print(f"[k4-bwd] {label}: " + "; ".join(line), flush=True)
        if not c["timed"]:
            del q, k, v, dout, out, lse
            continue
        dk, dv, delta = kernels.flash_attention_nonull_bwd_dkv(q, k, v, out, dout, lse)
        dkv_ms = cuda_time_ms(lambda: kernels.flash_attention_nonull_bwd_dkv(
            q, k, v, out, dout, lse))
        dq_ms = cuda_time_ms(lambda: kernels.flash_attention_nonull_bwd_dq(
            q, k, v, dout, lse, delta))
        dkv_plain = cuda_time_ms(lambda: kernels.flash_attention_nonull_bwd_dkv_reference(
            q, k, v, out, lse, dout), reps=5)
        dq_plain = cuda_time_ms(lambda: kernels.flash_attention_nonull_bwd_dq_reference(
            q, k, v, dout, lse, delta), reps=5)
        dkv_dev = device_ms(lambda: kernels.flash_attention_nonull_bwd_dkv(
            q, k, v, out, dout, lse))
        dq_dev = device_ms(lambda: kernels.flash_attention_nonull_bwd_dq(
            q, k, v, dout, lse, delta))
        sdpa_bwd_fn = sdpa_backward([t.transpose(1, 2) for t in (q, k, v)], dout)

        def one_call():
            return fa._launch_backward(q, k, v, None, None, out, dout, lse, scale)

        bwd_ms, sdpa_bwd = in_turns(one_call, sdpa_bwd_fn)
        bwd_dev, sdpa_bwd_dev, per, sdpa_per = device_in_turns(one_call, sdpa_bwd_fn)
        kl = [t.detach().requires_grad_() for t in (q, k, v)]
        sl = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
        fb_ms, sdpa_fb = in_turns(
            lambda: torch.autograd.grad(kernels.flash_attention_nonull(*kl), kl, dout),
            lambda: torch.autograd.grad(F.scaled_dot_product_attention(*sl), sl,
                                        dout.transpose(1, 2)))
        del kl, sl
        peak = PEAK_BF16_FLOPS if dt == bf else PEAK_3XTF32_FLOPS
        parts = []
        for key, ms, pm, dm, kname in ((K4_BWD[0], dkv_ms, dkv_plain, dkv_dev, "dkv"),
                                       (K4_BWD[1], dq_ms, dq_plain, dq_dev, "dq")):
            ops, byts = flash_bwd_work(key, Bc, Tq, Tk, N, D, q.element_size())
            bnd, b_by = plain_bound(ops, byts, peak)
            fma_bnd = plain_bound(ops, byts, PEAK_FP32_FLOPS)[0] if dt == f32 else bnd
            kdev = kernel_ms(per, "dkv_f32_kernel" if dt == f32 and kname == "dkv" else
                             "dq_f32_kernel" if dt == f32 else f"flash_bwd_{kname}_kernel")
            parts.append(f"{kname} {ms:.4f} ms (device {ms_text(dm)}; in the one call "
                         f"{ms_text(kdev)}, of_bound "
                         + ("not measured" if kdev is None else f"{bnd / kdev:.3f}")
                         + f"; plain {pm:.4f}; bound {bnd:.4f} {b_by}"
                         + (f", FMA bound {fma_bnd:.4f}" if dt == f32 else "") + ")")
            row = dict(ms=ms, device_ms=dm, call_device_ms=kdev, plain_ms=pm, bound_ms=bnd,
                       fma_bound_ms=fma_bnd, library_ms=sdpa_bwd, library_device_ms=sdpa_bwd_dev,
                       backward_ms=bwd_ms, backward_device_ms=bwd_dev)
            if Bc != B:
                acc[key]["b4"][f"T={Tq} N={N}"] = row
            elif n_call:  # a site of the encode (the bf16 shapes count 0)
                acc[key]["ms"] += ms * n_call
                acc[key]["plain_ms"] += pm * n_call
                acc[key]["device_ms"] = add_or_none(acc[key]["device_ms"], dm, n_call)
                acc[key]["library_ms"] += sdpa_bwd * n_call
                acc[key]["bound_ms"] += bnd * n_call
                acc[key]["fma_bound_ms"] += fma_bnd * n_call
                by[key][b_by] = by[key].get(b_by, 0) + n_call
        if Bc == B:
            fb["ms"] += fb_ms * n_call
            fb["library_ms"] += sdpa_fb * n_call
        ratio = ("not measured" if bwd_dev is None or sdpa_bwd_dev is None
                 else f"{bwd_dev / sdpa_bwd_dev:.3f}")
        print(f"[k4-bwd] {label}: " + "; ".join(parts) + f"; one-call backward {bwd_ms:.4f} ms "
              f"(device {ms_text(bwd_dev)}) vs sdpa backward {sdpa_bwd:.4f} ms (device "
              f"{ms_text(sdpa_bwd_dev)}) in turns: {bwd_ms / sdpa_bwd:.3f}x (device {ratio}); "
              f"sdpa kernels {list(sdpa_per)[:4]}; fwd+bwd: K4 {fb_ms:.4f} ms, sdpa "
              f"{sdpa_fb:.4f} ms x{n_call}/encode", flush=True)
        del q, k, v, dout, out, lse, dk, dv, delta, sdpa_bwd_fn
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"chip_smoke: K4 backward phase FAILED at {failed}")
    for key in K4_BWD:
        acc[key].update(batch=B, bound_by=max(by[key], key=by[key].get))
    print(f"[k4-bwd] all K4 sites of the training path (one encode) at B={B}: dkv "
          f"{acc[K4_BWD[0]]['ms']:.4f} ms (device {ms_text(acc[K4_BWD[0]]['device_ms'])}), dq "
          f"{acc[K4_BWD[1]]['ms']:.4f} ms (device {ms_text(acc[K4_BWD[1]]['device_ms'])}), sdpa "
          f"backward {acc[K4_BWD[1]]['library_ms']:.4f} ms; forward+backward K4 {fb['ms']:.4f} "
          f"ms, sdpa {fb['library_ms']:.4f} ms", flush=True)
    return acc, fb


def round_trip_rate(G, img, reps: int = 5) -> float:
    """Images/s of encode -> decode of `img` (one warm-up, `reps` timed)."""
    import torch

    G.decode(G.encode(img))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        G.decode(G.encode(img))
    torch.cuda.synchronize()
    return img.shape[0] * reps / (time.perf_counter() - t0)


def all_switches_round_trip(G, refs: dict, card: str) -> dict:
    """Three B=4 flagship encode -> decode requests with every opt-in kernel
    switch on (ALL_SWITCHES): launch counts as kernel_sites predicts (K9 at
    every K1 site, K1 never, K5 at every eligible statistic, K4 at the
    tower and the adapter); the decode of slice_phase's latent against the
    default kernel path (DECODE_REL_L1) and against fp32 (TRUTH_FACTOR times
    the plain path's distance); round-trip img/s at B=4 and B=32 beside the
    default path, in turns."""
    import torch

    from vfm_vae_tpu_torch.entry import kernel_sites
    from vfm_vae_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    B, n_req = 4, 3
    requests = [refs["img"]] + [torch.rand((B, 256, 256, 3), generator=gen, device=dev)
                                for _ in range(n_req - 1)]
    with env_vars(ALL_SWITCHES):
        sites = kernel_sites(G, 256)
        want = {fn.__name__: 0 for fn in kernels.ALL_WRAPPERS}
        for name, n in forward_counts(sites).items():
            want[name] = n * n_req
        kernels.reset_launch_counts()
        outs = []
        for img in requests:
            z = G.encode(img)
            outs.append((z, G.decode(z)))
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        print(f"[all-switches] launches over {n_req} requests: {launches}; predicted {want}",
              flush=True)
        if (launches != want or launches["fused_convnext_mlp"] != 0
                or launches["fused_convnext_mlp_pipelined"] != 38 * n_req):
            raise SystemExit("chip_smoke: all-switches launch counts differ from kernel_sites' "
                             "prediction")
        for i, (z, x) in enumerate(outs):
            if tuple(z.shape) != (B, 16, 16, 32) or tuple(x.shape) != (B, 256, 256, 3):
                raise SystemExit(f"chip_smoke: all-switches request {i}: shapes")
            if not (torch.isfinite(z).all() and torch.isfinite(x).all()):
                raise SystemExit(f"chip_smoke: all-switches request {i}: non-finite output")
        x_sw = G.decode(refs["z"])
    torch.cuda.synchronize()
    d_def = rel_l1(x_sw, refs["x"])
    d32, p32 = rel_l1(x_sw, refs["x_32"]), rel_l1(refs["x_plain"], refs["x_32"])
    print(f"[all-switches] latent rel-L1 vs the default kernel path "
          f"{rel_l1(outs[0][0], refs['z']):.3e} (K4 at the tower and adapter; reported); decode "
          f"of the same latent: vs the default kernel path rel-L1 {d_def:.3e} (tol "
          f"{DECODE_REL_L1:g}) PSNR {psnr(x_sw, refs['x']):.2f} dB; vs fp32 rel-L1 {d32:.3e}, "
          f"plain {p32:.3e} (limit {TRUTH_FACTOR} x plain)", flush=True)
    if not (d_def <= DECODE_REL_L1 and d32 <= TRUTH_FACTOR * p32 + 1e-6):
        raise SystemExit("chip_smoke: the all-switches decode disagrees with the default / fp32 "
                         "decode")
    for bs in (4, 32):
        img = torch.rand((bs, 256, 256, 3), generator=gen, device=dev)
        rates = {"default": [], "all switches": []}
        for turn in ("default", "all switches", "all switches", "default"):
            with env_vars(ALL_SWITCHES if turn == "all switches" else NO_SWITCHES):
                rates[turn].append(round_trip_rate(G, img))
        print(f"[all-switches] round trip B={bs} on {card}, in turns: "
              + "; ".join(f"{k} {', '.join(f'{r:.2f}' for r in v)} img/s"
                          for k, v in rates.items()), flush=True)
    return launches


def all_switches_train(tr, state, card: str, B: int = 4):
    """The stage-0 [D, G] step with every opt-in kernel switch on: a warm-up
    and two timed steps over FORCED_BUCKETS on the training phase's trainer,
    under every gate of train_steps (K5, K9 and K4 forward and backward in
    the launch counts)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    res = tr.G.synthesis.block_resolutions[-1]
    reals = [torch.rand((B, res, res, 3), generator=gen, device=dev) for _ in FORCED_BUCKETS]
    with env_vars(ALL_SWITCHES):
        state, launches = train_steps(tr, state, FORCED_BUCKETS, reals, gen, card,
                                      "all-switches-train")
    # The timed buckets again on the warm trainer, the default path and every
    # switch in turns (the training phase's steps ran on a cold one).
    times = {"default": ([], []), "all switches": ([], [])}
    for turn in ("default", "all switches", "all switches", "default"):
        with env_vars(ALL_SWITCHES if turn == "all switches" else NO_SWITCHES):
            for eq, img in zip(FORCED_BUCKETS[1:], reals[1:]):
                t0 = time.perf_counter()
                state, _, _ = tr.d_step(state, img, eq, gen)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, _, _ = tr.g_step(state, img, eq, gen)
                torch.cuda.synchronize()
                times[turn][0].append((t1 - t0) * 1e3)
                times[turn][1].append((time.perf_counter() - t1) * 1e3)
    print(f"[all-switches-train] in turns on the warm trainer, B={B} on {card}, buckets "
          f"{FORCED_BUCKETS[1:]}: " + "; ".join(
              f"{k} D {statistics.median(d):.1f} ms G {statistics.median(g):.1f} ms (G "
              f"{', '.join(f'{x:.1f}' for x in g)})" for k, (d, g) in times.items()), flush=True)
    return state, launches


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--determinism-trials", type=int, default=1,
                    help="batches of the deterministic kernel/plain/fp32 step (default 1)")
    args = ap.parse_args()
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
    from vfm_vae_tpu_torch.probes.fused_mlp import gelu_instructions

    GELU_INSTRUCTIONS["count"] = gelu_instructions(str(lib.path))
    print(f"[build] K1's GELU: {GELU_INSTRUCTIONS['count']} SASS instructions an evaluation",
          flush=True)
    entry = ""
    for line in lib.log.splitlines():
        if "Compiling entry function" in line:
            entry = kernel_name(line)
        if "registers" in line or "spill" in line:
            print(f"[build] {entry}: {line.strip()}", flush=True)
    from vfm_vae_tpu_torch.probes.flash_forward import sass_counts

    # K4's fp32 forward runs its products on the tensor cores (TF32 HGMMA):
    # an FMA main loop would show as thousands of FFMA.
    fwd_f32 = sass_counts(str(lib.path))
    if not fwd_f32:
        raise SystemExit("chip_smoke: no flash_fwd_f32_kernel in the library's SASS")
    for name, c in fwd_f32.items():
        print(f"[build] {name} SASS: {c['HGMMA']} HGMMA, {c['HMMA']} HMMA, {c['FFMA']} FFMA of "
              f"{c['instructions']} instructions", flush=True)
        if c["HGMMA"] == 0 or c["FFMA"] > 512:
            raise SystemExit(f"chip_smoke: {name} is not a tensor-core kernel ({c})")

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
        fwd_bwd_ms=k3_fb["ms"], library_fwd_bwd_ms=k3_fb["library_ms"],
        bwd_one_call_ms=k3_fb["bwd_ms"], bwd_one_call_device_ms=k3_fb["bwd_device_ms"])
    summary.update(kernel_stats_phase(G))
    summary.update(kernel_pipeline_phase(sites, eq_sites))
    mlp = mlp_batch_phase(sites["fused_convnext_mlp"])
    for name, pre in (("fused_convnext_mlp", "k1"), ("fused_convnext_mlp_pipelined", "k9")):
        summary[name].update(device_ms=mlp[2][f"{pre}_device_ms"],
                             composition_ms=mlp[2]["composition_ms"],
                             composition_device_ms=mlp[2]["composition_device_ms"],
                             gelu_instructions=GELU_INSTRUCTIONS["count"],
                             b32={k: v for k, v in mlp[32].items() if k != "sites"})
    summary["fused_convnext_mlp"]["b32"]["sites"] = mlp[32]["sites"]
    up = upsample_batch_phase(sites["fused_upsample_blur"])
    summary["fused_upsample_blur"].update(
        device_ms=up[2]["device_ms"],
        b32={k: v for k, v in up[32].items() if k != "max_abs_err"})
    dw_err = kernel_dwconv_phase(sites)
    enc = encode_sites(G, int8=True)
    summary.update(kernel_int8_phase(enc["int8_matmul"]))
    summary.update(kernel_flash_phase(enc["flash_attention_nonull"]))
    for name, per_site in flash_batch_phase(sites["flash_attention_nullkv"],
                                            enc["flash_attention_nonull"]).items():
        summary[name]["b32"] = per_site
    bwd_b32 = flash_bwd_batch_phase(sites["flash_attention_nullkv"], enc["flash_attention_nonull"])
    k4b, k4_fb = k4_backward_phase(enc["flash_attention_nonull"])
    summary.update(k4b)
    for name, per_site in bwd_b32.items():
        summary[name]["b32"] = per_site
    summary["flash_attention_nonull"].update(
        fwd_bwd_ms=k4_fb["ms"], library_fwd_bwd_ms=k4_fb["library_ms"])

    launches = {}
    launches["round_trip"], refs = slice_phase(G, card)
    launches["all_switches_round_trip"] = all_switches_round_trip(G, refs, card)
    del refs
    probe, launches["dwconv_probe"] = dwconv_probe(G)
    for name, s in probe.items():
        summary[name] = dict(max_abs_err=dw_err[name], **s)
    launches.update(int8_serving_phase(G, card))
    del G
    torch.cuda.empty_cache()
    tr, state, real, launches["train_step"] = train_phase(card)
    determinism_phase(tr, state, real, args.determinism_trials)
    state, launches["all_switches_train_step"] = all_switches_train(tr, state, card)
    del tr, state, real
    torch.cuda.empty_cache()

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

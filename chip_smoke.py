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
   loop at the build) is held at the adapter's sites and at discrete
   mode's post_quant site at B=2 and B=32, at ragged Tq != Tk and at d=128: against its twin (FLASH_FP32_MAX_REL, max
   and mean), its log-sum-exp against the twin's, against float64
   (TRUTH_FACTOR), bit-identical on repeat, one launch a call by the
   wrapper's counter and one kernel a call by the profiler; and it is timed
   against SDPA's fp32 forward in turns (events and device time) at the
   same sites at B=2 and B=32, with the fraction of its 3xTF32 bound.
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
   loss terms and trainable gradient tensors are compared quantity by
   quantity (gate_readings; --determinism-trials N repeats it on N
   batches).
7. The opt-in kernels and K4's backward: K5 (GroupNorm moments) against
   its twin and fp64 sums at every K5 site of a decode and the EQ shapes,
   repeatable bit for bit, one kernel a call by the profiler's count; K9
   (K1 pipelined) against K1 at every K1 site, 0 ulps, and each
   bit-identical on repeat; K7 and K8 (depthwise conv + statistics, and
   without; one kernel template, whose ten instances must build with a
   0-byte stack frame and no spills) against their twins at every ConvNeXt
   dwconv shape at B=2 and B=32, bit-identical on repeat, one kernel a K7
   call by the profiler's count; K4's backward against its
   twin and fp64 at the training path's sites (the adapter's fp32 sites,
   3xTF32 kernels, held to FLASH_FP32_MAX_REL against the twin) at B=2 and
   at the stage-0 step's B=4, at discrete mode's post_quant site at B=2 and
   B=32, at ragged fp32 shapes and d=128, bit for bit
   on repeat, the one-call backward timed against SDPA's backward in turns
   (CUDA events and device time, SDPA's kernels by name). With every
   opt-in switch of the JAX package on (ALL_SWITCHES), three round-trip
   requests and the stage-0 steps run under the gates above, with img/s
   and step times beside the default path in turns; the dwconv probe
   launches K7 and K8 at the 38 dwconvs of a decode in a window of their
   own, then times them at B=2 and B=32 beside cuDNN's chain (events, and
   device time in turns).
8. Recipe phase: the four stage YAMLs (configs/*stage_{0..3}*.yaml) through
   the port's CLI (vfm_vae_tpu_torch.train.cli.main, in process) at full
   flagship width and depth, B=4, three [D, G] steps and one snapshot a
   stage, each stage resuming the previous one's snapshot, on synthetic
   256 px shards written here; then a sixth call that must auto-resume.
   Gates: the handoffs bit for bit, frozen and trainable sets, PatchGAN
   fresh in stage 3, finite logged losses (SSIM, PatchGAN and feature
   matching present where they belong), G_ema's round trip, K1-K3 and K3's
   backward in the active G steps where they lie on the path, and the
   determinism gate on stages 2 and 3; per stage the median D and G step
   ms, peak memory, snapshot bytes and save and load seconds
   (recipe_phase).
9. Batch phase (slice 16, batch_phase): the published batch at flagship
   width and depth. On entry.flagship_trainer at B=4: one stage-0 [D, G]
   step under each remat policy (none, dots, names, full, then back, in
   turns; cuDNN deterministic), gated on the stats and totals bit for bit
   against none, every gradient norm within the two none runs' spread,
   the same tensors moved and the launches that predicted_launches gives
   for the policy (the replayed ConvNeXt layers launch K1 twice more in
   the G phase); step ms and peak memory per policy, and a B=8 step under
   dots and full for a linear memory fit. Trainer(num_accumulation=2) at
   B=8 against two d_gradients and g_gradients calls on the same chunks
   and draws: the summed gradients and the parameters and EMA after the
   step bit for bit. The B=4 step inside init_process_group("nccl",
   world_size=1) against no process group, bit for bit, with
   check_replica_consistency. Then the stage-0 YAML with only
   accumulate_gradients changed (512 / it the largest microbatch the fit
   admits under the remat policy the loop picks) through the CLI: one
   [D, G] step of 512 images, a snapshot, and a second call that
   auto-resumes it and takes one step of a single microbatch (a second
   512-image step took about 85 s of the time limit); gated on
   finite losses, cur_nimg and Progress/kimg,
   tensors moved, each step's launches per bucket and the peak memory;
   ms per D and G step, img/s and peak memory.
10. Tools phase: on the recipe's last snapshot, the offline tools through
   each CLI's main(argv) at flagship width and depth on 72 seeded 256 px
   JPEGs in tar shards (two B=32 batches and a B=8 tail): prefetch (bf16
   tower, features and images stored), prefetch --int8 under the flash
   switches, prefetch_reg, decode_latents_to_images, reconstruct, then
   evaluate, fidelity --fid --isc, save_images_as_npz and evaluate_npz with
   random-weight InceptionV3 and LPIPS. Gates: the shards' file contract,
   the moments and the int8 latents against in-process replays bit for
   bit (the tail included), the PNGs against G.decode, the tail decode
   against the plain twins and fp32, the int8 tail's K6 and K4 sites
   against their twins and its moments against fp32, the launches of every tower, adapter
   and decoder call (K6, K4; K1-K3 at 38/10/6 a decode), InceptionV3 on
   the card against the CPU, FID(x, x) and precision = recall = 1 of a set
   against itself (evaluate_npz), finite figures, the PSNR clamp;
   each tool's img/s with its setup, model (CUDA events) and host split
   (tools_phase).
11. Diffusion phase: on the tools phase's 72 latents and the recipe's last
   snapshot, the latent-diffusion CLIs through main(argv) at full XL width
   and depth, cut in scale only (B=32, 4 steps, a snapshot at step 3, 16
   and 8 samples at 50 steps): lightningdit_train on the stage-0 YAML and
   reg_train on the REG YAML with repa_weight 0.5 (on moments that
   prefetch_reg --store-vfm-features writes here), each gated on finite
   losses, a nonzero gradient and a move for every parameter, a moving
   EMA, its snapshot equal to the trainer bit for bit and no kernel
   launch, with a copy at XL width and depth 2 held against float64 on
   the CPU (the loss and every gradient norm); lightningdit_sample (ODE,
   cfg 1.5) and reg_sample (SDE, cfg 4.0, the REPA snapshot's dit part)
   through the tokenizer: PNGs, the sampled z against an in-process
   replay bit for bit, K1-K3 at 38/10/6 a decode, the decode against the
   plain twins and fp32; alignment_extract in the vae, dit and reg modes
   and alignment_metrics (finite, a set against itself 1). Step ms,
   tokens/s, peak memory, img/s with the DiT and decode shares
   (diffusion_phase).
12. Discrete phase (after the batch phase): the flagship in discrete (VQ)
   mode at B=32, by default and under VFM_VAE_ADAPTER_ATTN=3mm-flash (K4's
   fp32 forward at post_quant, T=256 N=16 d=64; phases 3 and 7 hold
   that site forward and backward against its twin and float64 at B=2 and
   B=32: POST_QUANT_SITE), its launches, decode against the plain
   twins and fp32, the indices round trip, img/s in turns with the
   continuous flagship, the VQ's device time; then the stage-0 YAML in
   discrete mode with both discriminator warm-ups and the D-input blur
   through the CLI, a snapshot and an auto-resumed step (discrete_phase).

13. Towers phase (after int8 serving; towers_phase): the DINOv2-L/14,
   ViT-MAE-L/16, EVA-02-L/14-448 and Qwen2.5-VL-7B vision towers at full
   width on seeded random weights, B=32 at the resolution the tokenizer
   feeds them (256 px x 1.75, MAE x 0.875): shapes under layers [0, 12, -1],
   finite values, each feature against the fp32 tower (TOWER_BF16_REL);
   the int8 scope dynamic and, after calibration, static, with every K6
   call held to its twin bit for bit and the launches against the tower's
   Linears; K6 at its tail shapes (K6_TAILS: K or N 2730 and 3420, a partial
   tile) against its twin and timed beside cuBLAS bf16 and the bound, with
   the aligned SigLIP shapes beside them; the DINOv2 tokenizer's round trip
   at B=32 (K1-K3 per decode, K4-f32 at the adapter's sites under the flash
   switches) and its img/s in turns with the SigLIP flagship; the stage-0
   trainer on the DINOv2 tower over the forced EQ buckets under
   train_steps' gates. launches_by_path gains "towers".

14. Decoders phase (after the towers phase; decoders_phase): the flagship
   with the int8 decoder MLPs (enable_int8_decoder on 32 images under the
   flash switches; K6's gelu and residual modes at the 28 ConvNeXt layers
   of 8-64 px, K1 at the 10 others): three B=4 requests gated on shapes,
   finiteness and kernel_sites' launches; every K6 decoder call of one
   decode against its twin bit for bit (the gelu mode's pre-pass codes and
   h, the residual mode's output) and against a second call; each int8
   site at B=32: events, device time, the fraction of the bound,
   the twins' time, the pair in turns with cuBLAS bf16 of the same two
   products, K1's device time on the same layer; the round trip at B=4 and
   B=32 in turns with the bf16 decode and the PSNR between the two decodes
   of one z. Then every unconditional decoder variant (entry.
   DECODER_VARIANTS) at flagship width decodes one flagship z at B=4 (the
   tower built once), gated on shapes, finiteness and launches, with its
   bf16-vs-fp32 relative L2 and seconds; legacy skip also runs a round
   trip. launches_by_path gains "int8_decoder" and "decoder_variants"; the
   kernels line gains int8_matmul_gelu and int8_matmul_residual.

It needs a CUDA device and exits non-zero without one. The second-to-last
line is the kernel summary JSON; the last line is the device JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# The determinism gate's per-tensor guard (gate_readings): a gradient tensor
# the kernel path gets this far from fp32 (relative L2) ...
GUARD_KERNEL_REL = 0.5
# ... where the plain bf16 path stays within this, fails the step.
GUARD_PLAIN_REL = 0.05
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
    # K6's decoder modes (the static-int8 ConvNeXt MLP, an XLA int8 dot in
    # the JAX package's models/convnext.py:147 _int8_mlp; K6 is the port's
    # counterpart of the TPU's int8 kernel).
    "int8_matmul_gelu": ("vfm_vae_tpu_torch/csrc/int8_matmul.cu",
                         "vfm_vae_tpu/ops/pallas/int8_matmul.py:60"),
    "int8_matmul_residual": ("vfm_vae_tpu_torch/csrc/int8_matmul.cu",
                             "vfm_vae_tpu/ops/pallas/int8_matmul.py:60"),
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
MLP_WRAPPERS = ("fused_convnext_mlp", "fused_convnext_mlp_pipelined")
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
            args = re.match(r"I((?:L[ib]-?\d+E)+)", mangled[pos:])
            return name + (f"<{', '.join(re.findall(r'L[ib](-?[0-9]+)E', args.group(1)))}>"
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


def device_ms_per_launch(fn, reps: int = 10):
    """Device time of a call of `fn` whose kernels each run once a call: the
    sum over its kernels of their mean time a launch, from the profiler's
    own launch counts. CUPTI can drop a window's events late in a long run,
    which lowers device_ms (a total over `reps` calls) but not a mean over
    the launches it recorded. Returns (ms or None, the fewest launches seen
    of a kernel over `reps`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total and e.count]
    if not kern:
        return None, 0
    return (sum(e.self_device_time_total / e.count for e in kern) / 1e3,
            min(e.count for e in kern) / reps)


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
    for site in (x for x in k4_sites if x["at"] in ("adapter", "post_quant")):
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
        print(f"[flash-b{B}] flash_attention_nonull {site['at']} float32 T={T} N={N} D={D} B={B} "
              f"x{n}/encode: {text} kernel_ms={ms:.4f} bound_ms={bnd:.4f} (3xTF32; FMA bound "
              f"{fma_bnd:.4f}) {flash_rate_text(ms, dev_ms, flops, bnd, lib_ms, lib_dev)} in turns "
              f"(K4, SDPA, SDPA, K4); SDPA's kernels "
              f"{', '.join(x[:50] for x in s_per)} {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(f"flash_attention_nonull {site['at']} float32 T={T}")
        for key, val in (("ms", ms), ("library_ms", lib_ms), ("device_ms", dev_ms),
                         ("library_device_ms", lib_dev), ("bound_ms", bnd),
                         ("fma_bound_ms", fma_bnd)):
            tot[key] = add_or_none(tot[key], val, n)
        out.setdefault("flash_attention_nonull", {})[f"{site['at']}_fp32_T{T}"] = dict(
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


# K4-f32's site in discrete mode only: post_quant, AttnProjection(vocab_width
# 64 -> 1024, 16 heads) over the decode's T=256 tokens (head dim 64, which
# flash_eligible_shape admits; the continuous mode's head dim 32 is not).
# Held and timed with the encode's fp32 sites (kernel_flash_phase,
# flash_batch_phase, k4_backward_phase); it runs in no encode (count 0).
POST_QUANT_SITE = dict(at="post_quant", T=256, N=16, D=64, count=0)
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


# The towers phase (towers_phase): every other frozen tower at full width on
# seeded random weights, each encoding TOWER_B images at the resolution the
# tokenizer feeds it (256 px x scale_factor).
TOWER_PRESETS = (("dinov2-large", 1.75), ("vit-mae-large", 0.875),
                 ("eva02-large-patch14-448", 1.75), ("qwen2.5-vl-7b", 1.75))
TOWER_B = 32
TOWER_LAYERS = [0, 12, -1]
# bf16 tower against the same tower in fp32 (plain SDPA, TF32 off), relative
# L2 error of each feature: 24-32 blocks of bf16 roundings (2^-9 relative
# each) add up to a few 1e-2 in the residual stream; a wrong path reads ~1.
TOWER_BF16_REL = 0.1
# The int8 tower against fp32: int8 activations (per row or per tensor) and
# weights (per channel) through every Linear; a sanity bound, the per-site
# check (every K6 call against its twin, bit for bit) is the gate.
TOWER_INT8_REL = 0.5
# K6's shapes off its multiples (K % 32, N % 8: EVA-02-L's SwiGLU 2730,
# Qwen2.5-VL-7B's MLP 3420) at the towers' B=32 rows and at a partial tile,
# beside the aligned SigLIP-L shapes (PERF.md: 0.408-0.493 of the bound).
K6_TAILS = ((32 * 1025, 1024, 2730), (32 * 1025, 2730, 1024), (32 * 1024, 1280, 3420),
            (32 * 1024, 3420, 1280), (300, 2730, 1024), (300, 1280, 3420))
K6_ALIGNED = ((32 * 1024, 1024, 4096), (32 * 1024, 4096, 1024))


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def count_launches(fn):
    """fn()'s result and the kernel launches it made (counts set to 0 first)."""
    import torch

    from vfm_vae_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def k6_tails(card: str) -> dict:
    """K6 (dynamic, static) at K6_TAILS and K6_ALIGNED: bit for bit its twin
    (bf16_ulps 0) and bit-identical on repeat; device time (profiler, a mean
    a launch: device_ms_per_launch) of both modes, static in turns with
    cuBLAS bf16 at the same shape (events and device), the bound
    (int8_bound) and its fraction."""
    import torch

    from vfm_vae_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1818)
    out, failed = {}, []
    for M, K, N in K6_TAILS + K6_ALIGNED:
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (N, K), generator=gen, device=dev, dtype=torch.int8)
        ws = torch.rand(N, generator=gen, device=dev) * 2e-4 + 1e-4
        b = torch.randn(N, generator=gen, device=dev) * 0.1
        a_s = (x.float().abs().amax() / 127 * 0.75).reshape(())
        w_bf = torch.randn(N, K, generator=gen, device=dev).to(torch.bfloat16)
        row = dict(M=M, K=K, N=N, tail=(M, K, N) in K6_TAILS)
        for mode, extra in (("dynamic", ()), ("static", (a_s,))):
            k6 = lambda: kernels.int8_matmul(x, wq, ws, b, *extra)  # noqa: E731
            got, again = k6(), k6()
            ref = kernels.int8_matmul(x, wq, ws, b, *extra, plain=True)
            torch.cuda.synchronize()
            ulps = bf16_ulps(got, ref)
            ok = ulps == 0 and torch.equal(got, again) and bool(torch.isfinite(got).all())
            if not ok:
                failed.append(f"{mode} M={M} K={K} N={N}: {ulps:g} ulps")
            row[f"{mode}_ulps"] = ulps
            row[f"{mode}_device_ms"], seen = device_ms_per_launch(k6)
            row["launches_seen"] = min(row.get("launches_seen", 1.0), seen)
            if mode == "static":
                row["ms"], row["bf16_ms"] = in_turns(k6, lambda: x @ w_bf.t())
                row["bf16_device_ms"], seen = device_ms_per_launch(lambda: x @ w_bf.t())
                row["launches_seen"] = min(row["launches_seen"], seen)
        bnd, by = int8_bound(M, K, N)
        row.update(bound_ms=bnd, bound_by=by)
        dms = row["static_device_ms"] or row["ms"]
        row["fraction_of_bound"] = bnd / dms
        print(f"[towers-k6] M={M} K={K} N={N}{' (tail)' if row['tail'] else ''}: twin "
              f"{row['dynamic_ulps']:g} / {row['static_ulps']:g} ulps (dynamic / static), repeat "
              f"identical; device dynamic {ms_text(row['dynamic_device_ms'])}, static "
              f"{ms_text(row['static_device_ms'])} ms ({row['fraction_of_bound']:.3f} of the "
              f"bound {bnd:.4f} ms, {by}); in turns static {row['ms']:.4f} vs cuBLAS bf16 "
              f"{row['bf16_ms']:.4f} ms (device {ms_text(row['bf16_device_ms'])}), "
              f"kernel/bf16 {row['ms'] / row['bf16_ms']:.3f}; the profiler saw "
              f"{row['launches_seen']:.1f} of each kernel's launches a call at least; on {card}",
              flush=True)
        out[f"{M}x{K}x{N}"] = row
        del x, wq, w_bf
    if failed:
        raise SystemExit(f"chip_smoke: towers K6 tails FAILED at {failed}")
    return out


def tower_encode(name: str, scale: float, card: str, path: dict) -> dict:
    """One preset at full width (bf16, seeded random weights): shapes under
    TOWER_LAYERS, finite values, each feature against the fp32 tower
    (TOWER_BF16_REL); then the int8 scope, dynamic and, after calibration on
    8 images, static: every K6 call against its twin (site_checks), the
    launches against tower_linears, the features against fp32
    (TOWER_INT8_REL); encode times of the three. The counted launches go to
    `path`."""
    import torch

    from vfm_vae_tpu_torch.entry import configure_precision, tower_linears
    from vfm_vae_tpu_torch.models import layers
    from vfm_vae_tpu_torch.models.vfm import VFMEncoder
    from vfm_vae_tpu_torch.ops import kernels, quantized

    configure_precision()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(180)
    t0 = time.perf_counter()
    enc = VFMEncoder(name, scale, TOWER_LAYERS, dtype=torch.bfloat16, device=dev)
    layers.init_parameters(enc, gen)
    img = torch.rand((TOWER_B, 256, 256, 3), generator=gen, device=dev)
    calib = torch.rand((8, 256, 256, 3), generator=gen, device=dev)
    px = int(256 * scale)
    grid = px // enc.patch_size
    lins = tower_linears(enc, grid)
    flops = sum(2 * M * m.weight.shape[0] * m.weight.shape[1] for m, M in lins)
    n_par = sum(p.numel() for p in enc.parameters())

    feats = enc.encode_image(img)
    torch.cuda.synchronize()
    n = enc.preset["num_layers"]
    tokens = grid * grid
    want = [(TOWER_B, tokens, enc.preset["hidden_size"])] * 2 + [
        (TOWER_B, tokens // 4, enc.preset["out_hidden_size"]) if enc.family == "qwen"
        else (TOWER_B, tokens, enc.preset["hidden_size"])]
    shapes = [tuple(f.shape) for f in feats]
    if shapes != want or not all(bool(torch.isfinite(f).all()) for f in feats):
        raise SystemExit(f"chip_smoke: {name}: features {shapes} (expected {want}) or not finite")
    enc.dtype = torch.float32
    f32 = enc.encode_image(img)
    enc.dtype = torch.bfloat16
    errs = [rel_l2(a, b) for a, b in zip(feats, f32)]
    ms_bf16 = cuda_time_ms(lambda: enc.encode_image(img), reps=3, warmup=1)
    print(f"[towers] {name}: {n_par / 1e6:.1f} M parameters, {n} blocks, {px} px -> "
          f"{grid} x {grid} grid{' + CLS' if enc.has_cls_prefix else ''}, features {shapes}; "
          f"GEMMs {flops / 1e12:.4f} TFLOP/image over {len(lins)} Linears; built and run in "
          f"{time.perf_counter() - t0:.1f} s; bf16 vs fp32 rel-L2 by layer {TOWER_LAYERS}: "
          + ", ".join(f"{e:.3e}" for e in errs) + f" (bound {TOWER_BF16_REL:g}); bf16 encode "
          f"B={TOWER_B} {ms_bf16:.1f} ms, {TOWER_B / ms_bf16 * 1e3:.2f} img/s, "
          f"{flops * TOWER_B / ms_bf16 / 1e9:.1f} TFLOP/s of GEMMs on {card}", flush=True)
    if max(errs) > TOWER_BF16_REL:
        raise SystemExit(f"chip_smoke: {name}: bf16 tower {max(errs):.3e} from fp32")

    row = dict(tflop_per_image=flops / 1e12, bf16_ms=ms_bf16, bf16_rel_l2=errs,
               linears=len(lins))
    quantized.prequantize_linears(enc)
    for mode in ("dynamic", "static"):
        if mode == "static":
            quantized.calibrate_int8_act_scales(enc.encode_image, calib)
        with site_checks() as sc, layers.int8_linear_scope(True):
            q, counts = count_launches(lambda: enc.encode_image(img))
        add_counts(path, counts)
        bad = sc.failures()
        statics = {st for st, *_ in sc.k6}
        errs = [rel_l2(a, b) for a, b in zip(q, f32)]
        with layers.int8_linear_scope(True):
            ms = cuda_time_ms(lambda: enc.encode_image(img), reps=3, warmup=1)
        tail = sorted({shape for _, shape, *_ in sc.k6 if shape[0] % 8 or shape[1] % 32})
        print(f"[towers] {name} int8 {mode}: K6 launches {counts['int8_matmul']} (tower "
              f"Linears {len(lins)}), {len(sc.k6)} sites held to the twin ({len(bad)} off, "
              f"0 ulps each), tail (N, K) {tail}; vs fp32 rel-L2 "
              + ", ".join(f"{e:.3e}" for e in errs) + f" (bound {TOWER_INT8_REL:g}); encode "
              f"{ms:.1f} ms, {TOWER_B / ms * 1e3:.2f} img/s on {card}", flush=True)
        row[f"int8_{mode}_ms"], row[f"int8_{mode}_rel_l2"] = ms, errs
        others = {k: v for k, v in counts.items() if k != "int8_matmul" and v}
        if (bad or counts["int8_matmul"] != len(lins) or others
                or statics != {mode == "static"} or max(errs) > TOWER_INT8_REL
                or not all(bool(torch.isfinite(f).all()) for f in q)):
            raise SystemExit(f"chip_smoke: {name} int8 {mode}: {bad[:3]}, launches {counts}, "
                             f"rel-L2 {errs}")
    del enc, feats, f32, q
    torch.cuda.empty_cache()
    return row


def towers_phase(G, card: str) -> tuple:
    """Slice 18: the DINOv2, MAE, EVA-02 and Qwen2.5-VL towers (tower_encode),
    K6 at their tail shapes (k6_tails), the DINOv2 tokenizer's round trip at
    B=32 (K1-K3 per decode as PER_DECODE, K4-f32 at the adapter's sites
    under the flash switches, img/s in turns with the SigLIP flagship `G`)
    and the stage-0 trainer on the DINOv2 tower (train_steps' gates over the
    forced EQ buckets). Returns (the path's launches, the K6 tail rows)."""
    import torch

    from vfm_vae_tpu_torch.entry import (
        DINOV2_G, dinov2_generator, flagship_trainer, kernel_sites)

    t_phase = time.perf_counter()
    path: dict = {}
    rows = {}
    with env_vars(dict(NO_SWITCHES, VFM_VAE_INT8_VFM=None)):
        for name, scale in TOWER_PRESETS:
            rows[name] = tower_encode(name, scale, card, path)
        tails = k6_tails(card)

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(181)
        Gd = dinov2_generator(dev, torch.bfloat16, gen)
        randomize_zero_init_branches(Gd, seed=3)
        img = torch.rand((TOWER_B, 256, 256, 3), generator=gen, device=dev)
        def round_trip():
            z = Gd.encode(img)
            return z, Gd.decode(z)

        with env_vars(FLASH_SWITCHES):
            sites = kernel_sites(Gd, 256)
            (z, x), counts = count_launches(round_trip)
        add_counts(path, counts)
        want = {k: v for k, v in forward_counts(sites).items() if v}
        k4 = [s for s in sites["flash_attention_nonull"] if s["at"] == "adapter"]
        print(f"[towers] DINOv2 round trip B={TOWER_B} (flash switches): launches {counts}; "
              f"kernel_sites {want}; K4-f32 adapter sites {k4}", flush=True)
        if ({k: v for k, v in counts.items() if v} != want
                or any(counts[k] != v for k, v in PER_DECODE.items()) or not k4
                or counts["flash_attention_nonull"] != sum(s["count"] for s in k4)):
            raise SystemExit("chip_smoke: the DINOv2 round trip's launches differ from "
                             "kernel_sites' prediction")
        if (tuple(z.shape) != (TOWER_B, 16, 16, 32) or tuple(x.shape) != (TOWER_B, 256, 256, 3)
                or not (torch.isfinite(z).all() and torch.isfinite(x).all())):
            raise SystemExit(f"chip_smoke: DINOv2 round trip: {tuple(z.shape)} "
                             f"{tuple(x.shape)} or not finite")
        rates = [round_trip_rate(g, img) for g in (Gd, G, G, Gd)]
        print(f"[towers] round trip B={TOWER_B} in turns (DINOv2, SigLIP, SigLIP, DINOv2): "
              + " / ".join(f"{r:.2f}" for r in rates) + f" img/s; DINOv2/SigLIP "
              f"{(rates[0] + rates[3]) / (rates[1] + rates[2]):.3f} on {card}", flush=True)
        profile_round_trip(Gd, img)
        del Gd, z, x, img
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        tr = flagship_trainer(dev, 4, torch.Generator(device=dev).manual_seed(182),
                              allow_random_lpips=True, **DINOV2_G)
        randomize_zero_init_branches(tr.G, seed=4)
        print(f"[towers] stage-0 trainer on the DINOv2 tower built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        res = tr.G.synthesis.block_resolutions[-1]
        reals = [torch.rand((4, res, res, 3), generator=gen, device=dev) for _ in FORCED_BUCKETS]
        _, counts = train_steps(tr, tr.init_state(), FORCED_BUCKETS, reals, gen, card,
                                "towers-train")
        add_counts(path, counts)
        del tr, reals
        torch.cuda.empty_cache()
    print(f"[towers] phase passed in {time.perf_counter() - t_phase:.1f} s; launches {path}",
          flush=True)
    return path, dict(tails=tails, towers=rows)


# ------------------------------------------------------------------ decoders

# The int8 decoder (decoders_phase): the flagship's ConvNeXt layers at maps
# of at most 64 x 64 (blocks 0-3, 8-64 px, C = 512: 7 layers a block) run
# both MLP products on K6 (the gelu and residual modes), the 10 layers of
# blocks 4-5 stay on K1.
INT8_DECODER_PER_DECODE = {"int8_matmul_gelu": 28, "int8_matmul_residual": 28,
                           "fused_convnext_mlp": 10, "fused_upsample_blur": 10,
                           "flash_attention_nullkv": 6}
DECODER_B = 32  # the per-site timings and the offline round trip
VARIANT_B = 4   # the variants' decode (one flagship encode's z)


class decoder_int8_off:
    """For the length of a `with`, the ConvNeXt layers' calibrated int8
    mirrors are set aside (as_u None: the int8 gate closes and the layer
    runs K1, the bf16 decode), and put back on exit."""

    def __init__(self, G):
        from vfm_vae_tpu_torch.models.convnext import ConvNeXtSynthesisLayer

        self.layers = [m for m in G.modules()
                       if isinstance(m, ConvNeXtSynthesisLayer) and m.as_u is not None]

    def __enter__(self):
        self.saved = [m.as_u for m in self.layers]
        for m in self.layers:
            m.as_u = None
        return self

    def __exit__(self, *exc):
        for m, a in zip(self.layers, self.saved):
            m.as_u = a


class decoder_site_checks:
    """For the length of a `with`: every call of K6's gelu and residual
    modes on the decoder path runs twice more, as the kernel (bit-identical
    repeat) and as the plain twin on the very same inputs; the gelu mode's
    pre-pass codes are compared too. The path goes on with the first
    result; the twins add no launches, the repeats do (subtracted by the
    caller)."""

    def __init__(self):
        self.rows = []

    def __enter__(self):
        import torch

        from vfm_vae_tpu_torch.models import convnext

        self.saved = gelu, resid = convnext.int8_matmul_gelu, convnext.int8_matmul_residual

        def gelu_checked(x, A, wq, e, b, s, *, plain=False):
            h, uq = gelu(x, A, wq, e, b, s, return_codes=True)
            h2, uq2 = gelu(x, A, wq, e, b, s, return_codes=True)
            hr, uqr = gelu(x, A, wq, e, b, s, plain=True, return_codes=True)
            self.rows.append(("gelu", tuple(x.shape), torch.equal(uq, uqr),
                              bf16_ulps(h, hr), torch.equal(h, hr) and torch.equal(uq, uq2)
                              and torch.equal(h, h2) and bool(torch.isfinite(h).all())))
            return h

        def resid_checked(x, wq, ws, b, a_s, g, x_in, *, plain=False):
            y = resid(x, wq, ws, b, a_s, g, x_in)
            y2 = resid(x, wq, ws, b, a_s, g, x_in)
            yr = resid(x, wq, ws, b, a_s, g, x_in, plain=True)
            self.rows.append(("residual", tuple(x.shape), True, bf16_ulps(y, yr),
                              torch.equal(y, yr) and torch.equal(y, y2)
                              and bool(torch.isfinite(y).all())))
            return y

        convnext.int8_matmul_gelu, convnext.int8_matmul_residual = gelu_checked, resid_checked
        return self

    def __exit__(self, *exc):
        from vfm_vae_tpu_torch.models import convnext

        convnext.int8_matmul_gelu, convnext.int8_matmul_residual = self.saved


class capture_int8_mlps:
    """For the length of a `with`: the first int8 MLP call of each map size
    keeps its layer and operands (ConvNeXtSynthesisLayer._int8_mlp's x,
    x_in, A, d, w1, b1_eff, w2, b2, gamma) for the per-site timings."""

    def __init__(self):
        self.sites = {}

    def __enter__(self):
        from vfm_vae_tpu_torch.models.convnext import ConvNeXtSynthesisLayer

        self.orig = orig = ConvNeXtSynthesisLayer._int8_mlp
        sites = self.sites

        def keep(layer, *args):
            sites.setdefault(args[0].shape[1], (layer, args))
            return orig(layer, *args)

        ConvNeXtSynthesisLayer._int8_mlp = keep
        return self

    def __exit__(self, *exc):
        from vfm_vae_tpu_torch.models.convnext import ConvNeXtSynthesisLayer

        ConvNeXtSynthesisLayer._int8_mlp = self.orig


def int8_mlp_work(M: int, K: int, N: int, B: int, mode: str):
    """(operations, bytes) of one call of K6's gelu mode (x bf16 and the
    per-image A in, the int8 weight, the per-image scale and bias, h bf16
    out) or residual mode (h bf16 in, the int8 weight, ws, b, g, x_in bf16
    in, y bf16 out): each input read once, each output written once."""
    ops = 2 * M * N * K
    if mode == "gelu":
        return ops, 2 * M * K + 4 * B * K + N * K + 8 * B * N + 2 * M * N
    return ops, 2 * M * K + N * K + 12 * N + 4 * M * N


def int8_mlp_bound(M, K, N, B, mode):
    ops, byts = int8_mlp_work(M, K, N, B, mode)
    a, b = ops / PEAK_INT8_OPS * 1e3, byts / PEAK_BYTES_PER_S * 1e3
    return max(a, b), ("operations" if a >= b else "bytes")


def decoder_site_timings(G, card: str) -> dict:
    """At every int8 decoder site of a B=32 decode (one layer a map size;
    7 layers a size): K6's gelu and residual modes, events and device time,
    the fraction of the bound, the plain twins' time, the same two products
    as cuBLAS bf16 GEMMs in turns with the K6 pair, and K1's device time on
    the same layer's operands (the bf16 kernel this path replaces). Called
    under torch.no_grad. Returns the two kernels' summary entries."""
    import torch

    from vfm_vae_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(191)
    summary = {n: dict(max_abs_err=0.0, sites={}) for n in ("int8_matmul_gelu",
                                                             "int8_matmul_residual")}
    per_size = INT8_DECODER_PER_DECODE["int8_matmul_gelu"] // 4
    for B in (DECODER_B,):
        img = torch.rand((B, 256, 256, 3), generator=gen, device=dev)
        z = G.encode(img)
        with capture_int8_mlps() as cap:
            G.decode(z)
        torch.cuda.synchronize()
        tot = {}
        for H, (layer, (x, x_in, A, d, w1, b1, w2, b2, g)) in sorted(cap.sites.items()):
            Bx, _, _, C = x.shape
            M, N = Bx * H * H, 4 * C
            s_u = torch.clamp_min(layer.as_u, 1e-8)
            s_h = torch.clamp_min(layer.as_h, 1e-8)
            e1 = ((s_u * layer.ws1)[None, :] * d).contiguous()
            A, b1, g, b2 = A.contiguous(), b1.contiguous(), g.contiguous(), b2.contiguous()
            h = kernels.int8_matmul_gelu(x, A, layer.w1q, e1, b1, s_u)
            fns = {
                "int8_matmul_gelu": (
                    lambda: kernels.int8_matmul_gelu(x, A, layer.w1q, e1, b1, s_u),
                    lambda: kernels.int8_matmul_gelu(x, A, layer.w1q, e1, b1, s_u, plain=True),
                    int8_mlp_bound(M, C, N, Bx, "gelu")),
                "int8_matmul_residual": (
                    lambda: kernels.int8_matmul_residual(h, layer.w2q, layer.ws2, b2, s_h, g,
                                                         x_in),
                    lambda: kernels.int8_matmul_residual(h, layer.w2q, layer.ws2, b2, s_h, g,
                                                         x_in, plain=True),
                    int8_mlp_bound(M, N, C, Bx, "residual")),
            }
            w1b, w2b = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
            x2, h2 = x.reshape(M, C), h.reshape(M, N)
            pair = lambda: (fns["int8_matmul_gelu"][0](), fns["int8_matmul_residual"][0]())  # noqa
            bf16 = lambda: (x2 @ w1b.t(), h2 @ w2b.t())  # noqa: E731
            k1 = lambda: kernels.fused_convnext_mlp(x, x_in, A, d, w1b, b1, w2b, b2, g)  # noqa
            pair_ms, bf16_ms = in_turns(pair, bf16)
            k1_dev, _ = device_ms_per_launch(k1)
            bf16_dev, _ = device_ms_per_launch(bf16)
            line = []
            for name, (fn, twin, (bnd, by)) in fns.items():
                got, ref = fn(), twin()
                torch.cuda.synchronize()
                err = float((got.float() - ref.float()).abs().max())
                summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], err)
                ms = cuda_time_ms(fn)
                dms, _ = device_ms_per_launch(fn)
                plain = cuda_time_ms(twin, reps=3, warmup=1)
                row = dict(M=M, K=C if name == "int8_matmul_gelu" else N,
                           N=N if name == "int8_matmul_gelu" else C, ms=ms, device_ms=dms,
                           plain_ms=plain, bound_ms=bnd, bound_by=by,
                           fraction_of_bound=bnd / (dms or ms), count=per_size)
                summary[name]["sites"][f"B{B}_H{H}"] = row
                for k in ("ms", "device_ms", "plain_ms", "bound_ms"):
                    key = (name, B, k)
                    tot[key] = None if row[k] is None or tot.get(key, 0.0) is None else \
                        tot.get(key, 0.0) + row[k] * per_size
                line.append(f"{name[12:]} {ms:.4f} ms (device {ms_text(dms)}, "
                            f"{row['fraction_of_bound']:.3f} of the bound {bnd:.4f} ms, {by}; "
                            f"twin {plain:.4f}, max_abs {err:.3e})")
            for k, v in (("pair_ms", pair_ms), ("bf16_ms", bf16_ms), ("bf16_device_ms", bf16_dev),
                         ("k1_device_ms", k1_dev)):
                key = ("pair", B, k)
                tot[key] = None if v is None or tot.get(key, 0.0) is None else \
                    tot.get(key, 0.0) + v * per_size
            summary["int8_matmul_gelu"]["sites"][f"B{B}_H{H}"].update(
                pair_ms=pair_ms, bf16_ms=bf16_ms, bf16_device_ms=bf16_dev, k1_device_ms=k1_dev)
            print(f"[int8-decoder] site B={B} H={H} C={C} (M={M}, x{per_size} a decode): "
                  + "; ".join(line) + f"; in turns the K6 pair {pair_ms:.4f} ms vs cuBLAS bf16 "
                  f"of the same two products {bf16_ms:.4f} ms (device {ms_text(bf16_dev)}); "
                  f"K1 on the same layer device {ms_text(k1_dev)} ms; on {card}", flush=True)
            del h, e1
        for name in ("int8_matmul_gelu", "int8_matmul_residual"):
            vals = {k: tot[(name, B, k)] for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
            summary[name][f"b{B}"] = vals
        pv = {k: tot[("pair", B, k)] for k in ("pair_ms", "bf16_ms", "bf16_device_ms",
                                                "k1_device_ms")}
        summary["int8_matmul_gelu"][f"b{B}"].update(pv)
        print(f"[int8-decoder] all 28 int8 MLP sites of a decode at B={B} (ms, events; device): "
              f"gelu {summary['int8_matmul_gelu'][f'b{B}']['ms']:.4f}; "
              f"{ms_text(summary['int8_matmul_gelu'][f'b{B}']['device_ms'])}, residual "
              f"{summary['int8_matmul_residual'][f'b{B}']['ms']:.4f}; "
              f"{ms_text(summary['int8_matmul_residual'][f'b{B}']['device_ms'])}; the pair in "
              f"turns {pv['pair_ms']:.4f} vs cuBLAS bf16 {pv['bf16_ms']:.4f} (device "
              f"{ms_text(pv['bf16_device_ms'])}); K1 device {ms_text(pv['k1_device_ms'])}",
              flush=True)
        del cap, z, img
        torch.cuda.empty_cache()
    for name in summary:  # the kernels line reads B=32
        b32 = summary[name][f"b{DECODER_B}"]
        bnd = [r for k, r in summary[name]["sites"].items() if k.startswith(f"B{DECODER_B}_")]
        by = {}
        for r in bnd:
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"] * r["count"]
        summary[name].update(batch=DECODER_B, ms=b32["ms"], device_ms=b32["device_ms"],
                             plain_ms=b32["plain_ms"], bound_ms=b32["bound_ms"],
                             bound_by=max(by, key=by.get), library_ms=None)
    return summary


def int8_decoder_phase(G, card: str) -> tuple:
    """The decoder's static-int8 MLP on the flagship G (its zero-initialised
    branches drawn): with the flash switches on, enable_int8_decoder (what
    entry.int8_serving_generator(decoder_mlp=True) runs) calibrates the
    tower on 32 seeded images, then the decoder MLPs through a decode of
    their serving encode; three B=4 requests then run, gated on shapes, finiteness and the
    launches per decode (INT8_DECODER_PER_DECODE, as kernel_sites predicts);
    one decode holds every K6 gelu and residual call against its twin on its
    own inputs (codes, h and y bit for bit) and against a second call; the
    per-site timings (decoder_site_timings); img/s of the round trip at B=4
    and B=32, int8 tower with the bf16 decode against the int8 decoder MLPs,
    in turns, and the PSNR of the int8 decode against the bf16 decode of
    the same z. Returns (the path's launches, the two kernels' summary)."""
    import torch

    from vfm_vae_tpu_torch.entry import kernel_sites
    from vfm_vae_tpu_torch.ops import kernels
    from vfm_vae_tpu_torch.ops.quantized import enable_int8_decoder

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    B, n_req = 4, 3
    requests = [torch.rand((B, 256, 256, 3), generator=gen, device=dev) for _ in range(n_req)]
    calib = torch.rand((32, 256, 256, 3), generator=gen, device=dev)
    with serving_env(int8=True), torch.no_grad():
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        n_cal = enable_int8_decoder(G, calib)
        torch.cuda.synchronize()
        cal = kernels.launch_counts()
        t_cal = time.perf_counter() - t0
        # The path's own run: the counts set to 0 just before the requests.
        kernels.reset_launch_counts()
        outs = []
        for img in requests:
            z = G.encode(img)
            outs.append((z, G.decode(z)))
        torch.cuda.synchronize()
        req = kernels.launch_counts()
        launches = {k: cal[k] + req[k] for k in req}
        sites = kernel_sites(G, 256)
        per = forward_counts(sites)
        want = {k: n_req * v for k, v in per.items() if v}
        print(f"[int8-decoder] enable_int8_decoder: {n_cal} scales calibrated on "
              f"{calib.shape[0]} images in {t_cal:.1f} s (launches { {k: v for k, v in cal.items() if v} }: "
              f"the int8 MLPs run their fp32 form while calibrating); {n_req} requests of B={B}: "
              f"launches { {k: v for k, v in req.items() if v} }, predicted {want}", flush=True)
        bad = [f"{k}: {per.get(k, 0)} a decode, expected {v}"
               for k, v in INT8_DECODER_PER_DECODE.items() if per.get(k, 0) != v]
        if (bad or {k: v for k, v in req.items() if v} != want
                or cal["int8_matmul_gelu"] or cal["int8_matmul_residual"]):
            raise SystemExit(f"chip_smoke: int8 decoder launches differ from kernel_sites: {bad}")
        for i, (z, x) in enumerate(outs):
            if (tuple(x.shape) != (B, 256, 256, 3) or not torch.isfinite(x).all()
                    or not torch.isfinite(z).all()):
                raise SystemExit(f"chip_smoke: int8 decoder request {i}: {tuple(x.shape)} or "
                                 "not finite")

        z = outs[0][0]
        with decoder_site_checks() as chk:
            x_k = G.decode(z)
        torch.cuda.synchronize()
        fails = [r for r in chk.rows if not (r[2] and r[4])]
        n_g = sum(r[0] == "gelu" for r in chk.rows)
        print(f"[int8-decoder] every K6 site of one decode (B={B}) vs its twin on the same "
              f"inputs: {n_g} gelu (codes and h), {len(chk.rows) - n_g} residual; max "
              f"{max(r[3] for r in chk.rows):g} ulps (gate: bit for bit, and bit-identical on a "
              f"second call): {len(fails)} fail", flush=True)
        if fails or n_g != 28 or len(chk.rows) != 56:
            raise SystemExit(f"chip_smoke: int8 decoder sites disagree: {fails[:4]}")
        with decoder_int8_off(G):
            x_bf = G.decode(z)
        torch.cuda.synchronize()
        print(f"[int8-decoder] int8 decode vs the bf16 decode of the same z (B={B}): rel-L1 "
              f"{rel_l1(x_k, x_bf):.3e}, PSNR {psnr(x_k, x_bf):.2f} dB", flush=True)

        summary = decoder_site_timings(G, card)
        for bs in (B, DECODER_B):
            img = torch.rand((bs, 256, 256, 3), generator=gen, device=dev)
            z = G.encode(img)
            with decoder_int8_off(G):
                x_bf = G.decode(z)
            x_8 = G.decode(z)

            def bf16_rate():
                with decoder_int8_off(G):
                    return round_trip_rate(G, img)

            rates = [bf16_rate(), round_trip_rate(G, img), round_trip_rate(G, img), bf16_rate()]
            print(f"[int8-decoder] round trip B={bs} in turns (int8 tower with the bf16 decode, "
                  f"int8 decoder MLPs, int8, bf16): " + " / ".join(f"{r:.2f}" for r in rates)
                  + f" img/s, int8/bf16 decode {(rates[1] + rates[2]) / (rates[0] + rates[3]):.3f}"
                  f"; PSNR of the int8 decode vs the bf16 decode of the same z "
                  f"{psnr(x_8, x_bf):.2f} dB (rel-L1 {rel_l1(x_8, x_bf):.3e}) on {card}",
                  flush=True)
            summary["int8_matmul_gelu"][f"round_trip_b{bs}"] = dict(
                img_s=rates, psnr_db=psnr(x_8, x_bf))
            del img, z, x_bf, x_8
    from vfm_vae_tpu_torch.models.convnext import INT8_BUFFERS, ConvNeXtSynthesisLayer

    for m in G.modules():  # the decoder mirrors go: later phases decode in bf16
        if isinstance(m, ConvNeXtSynthesisLayer):
            for name in INT8_BUFFERS:
                setattr(m, name, None)
    torch.cuda.empty_cache()
    print(f"[int8-decoder] phase passed in {time.perf_counter() - t_phase:.1f} s on {card}",
          flush=True)
    return launches, summary


def decoder_variants_phase(G, card: str) -> dict:
    """Every other unconditional decoder at flagship width and depth
    (entry.DECODER_VARIANTS: legacy StyleGAN-T layers with skip and orig
    images, the Fourier first block, the blur off, multiscale off), bf16,
    seeded random weights with the zero-initialised branches drawn: each
    variant decodes the z of one flagship encode at B=4 (the variant's own
    tower is set aside for the flagship's, so the tower is built once),
    gated on shapes, finiteness and the launches kernel_sites predicts (K1,
    K2 and K3 where the variant keeps them); its relative L2 from an fp32
    decode of the same variant (plain twins) and its seconds are printed.
    Legacy skip also runs one whole round trip. Returns the launches."""
    import torch

    from vfm_vae_tpu_torch.entry import (
        DECODER_VARIANTS, FLAGSHIP_KWARGS, flagship_generator, kernel_sites)
    from vfm_vae_tpu_torch.models.generator import Generator

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(192)
    img = torch.rand((VARIANT_B, 256, 256, 3), generator=gen, device=dev)
    path: dict = {}
    with env_vars(dict(NO_SWITCHES, VFM_VAE_INT8_VFM=None)), torch.no_grad():
        z = G.encode(img)
        for i, (name, overrides) in enumerate(DECODER_VARIANTS.items()):
            t0 = time.perf_counter()
            Gv = flagship_generator(dev, torch.bfloat16,
                                    torch.Generator(device=dev).manual_seed(1900 + i), **overrides)
            Gv.vfm_encoder = G.vfm_encoder
            randomize_zero_init_branches(Gv, seed=1910 + i)
            sites = forward_counts(kernel_sites(Gv, 256))
            x, counts = count_launches(lambda: Gv.decode(z))
            if name == "legacy_skip":
                (z2, x2), rt = count_launches(lambda: (lambda zz: (zz, Gv.decode(zz)))(
                    Gv.encode(img)))
                add_counts(counts, rt)
                if (tuple(x2.shape) != (VARIANT_B, 256, 256, 3)
                        or not torch.isfinite(x2).all()):
                    raise SystemExit("chip_smoke: legacy round trip: shapes or not finite")
            add_counts(path, counts)
            want = {k: v * (2 if name == "legacy_skip" else 1) for k, v in sites.items() if v}
            G32 = Generator(**dict(FLAGSHIP_KWARGS, **overrides), dtype=torch.float32,
                            device=dev)
            own, sd = G32.state_dict(), Gv.state_dict()  # sd: the flagship tower's int8 mirror too
            if set(own) - set(sd):
                raise SystemExit(f"chip_smoke: {name}: fp32 copy lacks {sorted(set(own) - set(sd))[:4]}")
            G32.load_state_dict({k: sd[k] for k in own})
            G32.use_plain_kernels(True)
            x32 = G32.decode(z.float())
            torch.cuda.synchronize()
            err = rel_l2(x, x32)
            n_legacy = sum(type(m).__name__ == "SynthesisLayer" for m in Gv.modules())
            print(f"[variants] {name} {overrides}: decode of one flagship z at B={VARIANT_B} "
                  f"{tuple(x.shape)}, {n_legacy} legacy layers, launches "
                  f"{ {k: v for k, v in counts.items() if v} } (kernel_sites {want}); bf16 vs "
                  f"fp32 decode rel-L2 {err:.3e}; {time.perf_counter() - t0:.1f} s on {card}",
                  flush=True)
            if (tuple(x.shape) != (VARIANT_B, 256, 256, 3) or not torch.isfinite(x).all()
                    or {k: v for k, v in counts.items() if v} != want):
                raise SystemExit(f"chip_smoke: decoder variant {name}: shapes, finiteness or "
                                 "launches")
            del Gv, G32, x, x32
            torch.cuda.empty_cache()
    print(f"[variants] phase passed in {time.perf_counter() - t_phase:.1f} s; launches "
          f"{ {k: v for k, v in path.items() if v} }", flush=True)
    return path


def decoders_phase(G, card: str) -> tuple:
    """The int8 decoder (int8_decoder_phase), then the decoder
    variants (decoder_variants_phase). Returns (launches by path, the K6
    decoder modes' summary entries)."""
    launches, summary = int8_decoder_phase(G, card)
    return {"int8_decoder": launches, "decoder_variants": decoder_variants_phase(G, card)}, \
        summary


def hinge_count_bias(name: str) -> bool:
    """A D head's logit bias: under the hinge loss its gradient is a count
    of the logits inside the margin over their number, so a logit that one
    bf16 path moves across the margin changes it by a whole count (errors
    of exactly 1/3, 1/2, 2/9 against fp32 on the card) with no kernel at
    fault; the determinism gate's per-tensor guard holds it apart."""
    return re.fullmatch(r"D\.heads\.\d+\.cls\.bias", name) is not None


def bn_fed_bias(name: str) -> bool:
    """A D head's conv bias that feeds BatchNormLocal: the mean subtraction
    makes its gradient exactly zero in exact arithmetic (rounding noise on
    the card), so the gradient gates hold it apart."""
    return name.startswith("D.heads.") and name.endswith((".main0.conv.bias",
                                                          ".main1.conv.bias"))


def predicted_launches(G, buckets, remat: str = "G", n_acc: int = 1) -> dict:
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
    passes are PyTorch.

    Under a remat policy (`remat`: "G" reads G's, else None, "full", "dots"
    or "names") each of the two backward passes replays every ConvNeXt
    layer's forward (synthesis.run_checkpointed), so K1 (K9 under
    VFM_VAE_MLP_PIPELINE=1) launches twice more at each of its sites in the
    G phase; K2 and K3 lie outside the checkpointed layers. The prediction
    covers the default K5 switch only (K5 inside a layer would replay too).
    With `n_acc` microbatches every launch happens once per microbatch."""
    want: dict = {}
    for eq in buckets:
        for phase in ("D", "G"):
            for k, v in phase_launches(G, eq, phase, remat, n_acc).items():
                want[k] = want.get(k, 0) + v
    return want


def phase_launches(G, eq, phase: str, remat: str = "G", n_acc: int = 1) -> dict:
    """predicted_launches' count for one phase ("D" or "G") of one bucket."""
    from vfm_vae_tpu_torch.entry import eq_image_size, kernel_sites
    from vfm_vae_tpu_torch.models.synthesis import remat_policy
    from vfm_vae_tpu_torch.ops import kernels

    policy = G.remat if remat == "G" else remat_policy(remat)
    if policy is not None and os.environ.get("VFM_VAE_PALLAS_STATS") == "1":
        raise SystemExit("chip_smoke: predicted_launches covers remat with K5 off only")
    want = {fn.__name__: 0 for fn in kernels.ALL_WRAPPERS}
    full = G.synthesis.block_resolutions[-1]
    # A latent bucket encodes the full image and resizes z; a prior bucket
    # shrinks the tower's input with z.
    dec = kernel_sites(G, eq_image_size(G, eq))
    enc = kernel_sites(G, eq_image_size(G, eq) if eq[2] else full)
    sites = {name: [s for s in (enc if name in ENCODE_KERNELS else dec)[name]
                    if s.get("at") != "post_quant"]
             + [s for s in dec[name] if name in ENCODE_KERNELS and s["at"] == "post_quant"]
             for name in dec}
    for name, n in forward_counts(sites).items():
        want[name] += n
        if phase == "G" and policy is not None and name in MLP_WRAPPERS:
            want[name] += 2 * n  # the layers replayed by the two backward passes
    if phase == "G":
        n_att = sum(s["count"] for s in sites["flash_attention_nullkv"])
        want["flash_attention_nullkv_bwd_dkv"] += 2 * n_att
        want["flash_attention_nullkv_bwd_dq"] += 2 * n_att
        for name in K4_BWD:  # post_quant lies downstream of the anchor: both pulls
            want[name] += sum(s["count"] * (2 if s["at"] == "post_quant" else 1)
                              for s in sites[name])
    return {k: v * n_acc for k, v in want.items()}


def named_params(tr) -> dict:
    lpips = tr.loss.lpips.named_parameters() if tr.loss.lpips is not None else ()
    return {**{"G." + n: p for n, p in tr.G.named_parameters()},
            **{"D." + n: p for n, p in tr.D.named_parameters()},
            **{"L." + n: p for n, p in lpips}}


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


def gate_readings(kern: dict, plain: dict, exact: dict, gk: dict, gp: dict, g32: dict,
                  maps=None) -> dict:
    """The determinism gate's readings of one batch.

    kern, plain, exact: {quantity: value} of the kernel path, the plain bf16
    path and the fp32 plain copy (loss terms, and the per-module gradient
    norms "|grad| <module>"); gk, gp, g32: {parameter: gradient} of the same
    three runs; maps: {"kernels", "plain", "fp32": noise_maps' maps} of the
    same runs, or None.

    The gated median (since slice 17): the loss terms and every trainable
    gradient tensor, each quantity's relative error against fp32 (a tensor's
    relative L2 error ||g - g32|| / ||g32||) for the kernel path over the
    plain path's, each floored at 1e-6 (fp32's own rounding), and the median
    of these ratios. Tensors whose fp32 gradient is zero and the D heads'
    BatchNormLocal-fed biases (zero in exact arithmetic) are left out.

    The guard, beside the median: no tensor whose kernel-path error is past
    GUARD_KERNEL_REL while the plain path's is under GUARD_PLAIN_REL (a
    gradient that the kernels alone get wrong, which one median over some
    800 tensors cannot see). A legacy noise_strength scalar is read there
    through its noise map when `maps` holds it: its gradient is the map's
    sum weighted by the layer's fixed noise, a projection of the map on a
    random pattern whose terms cancel (conditioning = sum |terms| / |sum|,
    reported; medians 6 to 674 at the flagship), so its relative error swings over
    three decades in either bf16 path alike. The D heads' cls biases are
    left out of the guard (hinge_count_bias). Both were measured on the
    card: PERF.md section 6, PR 17.

    The gain, reported and not gated: a tensor's <g, g32> / ||g32||^2, the
    part of its gradient along fp32's; `gain_p90` is the 90th percentile
    over tensors of |gain - 1| for the kernel path and the plain path. At
    stage 2 both bf16 paths' gains sit about 2% from 1, as far as a kernel
    whose outputs are 1.6% off moves them, so it separates no better than
    the median does (PERF.md section 6).

    The old reading, printed and not gated: the ratio over the loss terms
    and the per-module gradient norms. A norm's error against fp32 is a
    small residual (2-7%) of a 10-40% tensor error that both bf16 paths
    share, and the ratio of two such residuals swung from below 1 to 100x
    between batches (PERF.md section 7), so it failed about one stage-2
    batch in 8 with no kernel at fault."""
    def ratio(a: float, b: float) -> float:
        return max(a, 1e-6) / max(b, 1e-6)

    keys = [k for k in exact if exact[k] != 0.0 and k in kern and k in plain]
    rel = {k: (abs(kern[k] - exact[k]) / abs(exact[k]), abs(plain[k] - exact[k]) / abs(exact[k]))
           for k in keys}
    losses = [k for k in keys if not k.startswith("|grad| ")]
    old = [ratio(*rel[k]) for k in keys]
    tensors, gains = {}, {}
    for n, t32 in g32.items():
        if bn_fed_bias(n) or n not in gk or n not in gp:
            continue
        sq = float(t32.square().sum())
        if sq == 0.0:
            continue
        norm = math.sqrt(sq)
        tensors[n] = (float((gk[n] - t32).norm()) / norm, float((gp[n] - t32).norm()) / norm)
        gains[n] = (float((gk[n] * t32).sum()) / sq, float((gp[n] * t32).sum()) / sq)
    new = {k: ratio(*rel[k]) for k in losses}
    new.update({"tensor " + n: ratio(*e) for n, e in tensors.items()})
    vals = sorted(new.values())
    worst = max(new, key=new.get)
    errs = {**{k: rel[k] for k in losses}, **{"tensor " + n: e for n, e in tensors.items()}}
    noise = {}
    if maps is not None:
        for n, (m32, unit) in maps["fp32"].items():
            if n not in maps["kernels"] or n not in maps["plain"]:
                continue
            terms = unit * m32
            norm = float(m32.norm())
            if norm == 0.0:
                continue
            noise[n] = dict(
                kernel=float((maps["kernels"][n][0] - m32).norm()) / norm,
                plain=float((maps["plain"][n][0] - m32).norm()) / norm,
                conditioning=float(terms.abs().sum()) / max(abs(float(terms.sum())), 1e-30))
    guard_read = {n: e for n, e in tensors.items() if not hinge_count_bias(n)}
    for n, v in noise.items():
        if n + ".noise_strength" in guard_read:
            guard_read[n + ".noise_strength"] = (v["kernel"], v["plain"])
    guard = sorted(n for n, (ek, ep) in guard_read.items()
                   if ek > GUARD_KERNEL_REL and ep < GUARD_PLAIN_REL)
    scalar_guard = sorted(n for n, (ek, ep) in tensors.items() if not hinge_count_bias(n)
                          and ek > GUARD_KERNEL_REL and ep < GUARD_PLAIN_REL)
    dk = sorted(abs(a - 1.0) for a, _ in gains.values())
    dp = sorted(abs(b - 1.0) for _, b in gains.values())
    q = min(len(dk) - 1, int(0.9 * len(dk)))
    return dict(median=statistics.median(vals), p90=vals[min(len(vals) - 1, int(0.9 * len(vals)))],
                worst=worst, worst_ratio=new[worst], worst_errors=errs[worst],
                n=len(vals), n_tensors=len(tensors), kernel_worse=sum(v > 1 for v in vals),
                old_median=statistics.median(old), old_n=len(old), ratios=new, errors=errs,
                old_keys=keys, rel=rel, guard=guard, scalar_guard=scalar_guard, noise=noise,
                gains=gains, gain_median=(statistics.median(dk), statistics.median(dp)),
                gain_p90=(dk[q], dp[q]), gain_shift=statistics.median(
                    a - b for a, b in gains.values()))


def gate_text(r: dict) -> str:
    """One line of gate_readings' figures."""
    ek, ep = r["worst_errors"]
    (mk, mp), (pk, pp) = r["gain_median"], r["gain_p90"]
    noise = r["noise"]
    nz = ""
    if noise:
        kk = sorted(v["kernel"] / max(v["plain"], 1e-6) for v in noise.values())
        nz = (f"; noise maps of {len(noise)} layers: kernel/plain error vs fp32 median "
              f"{statistics.median(kk):.3f}, max {kk[-1]:.3f}, conditioning of the scalars "
              f"median {statistics.median(v['conditioning'] for v in noise.values()):.3g}")
    return (f"gated: median of kernel/plain relative errors vs fp32 over {r['n']} quantities "
            f"({r['n'] - r['n_tensors']} loss terms, {r['n_tensors']} gradient tensors, relative "
            f"L2) {r['median']:.3f} (limit {TRUTH_FACTOR}), 90th percentile {r['p90']:.3f}, "
            f"worst {r['worst']} {r['worst_ratio']:.3f} (kernel {ek:.3e}, plain {ep:.3e}), "
            f"kernel worse in {r['kernel_worse']}/{r['n']}; guard (kernel > {GUARD_KERNEL_REL}"
            f" where plain < {GUARD_PLAIN_REL}): {r['guard'] or 'none'} (on the scalars "
            f"themselves: {r['scalar_guard'] or 'none'}); gain |<g,g32>/|g32|^2 - 1| median "
            f"kernel {mk:.3e} plain {mp:.3e}, 90th percentile kernel {pk:.3e} plain {pp:.3e} "
            f"(ratio {pk / max(pp, 1e-12):.3f}), median kernel-plain gain {r['gain_shift']:.3e}"
            f"{nz}; old reading (loss terms and per-module gradient norms, not gated) median "
            f"{r['old_median']:.3f} over {r['old_n']}"
            f"{' (past the limit)' if r['old_median'] > TRUTH_FACTOR else ''}")


class noise_maps:
    """For the length of a `with`: for every legacy ConvNeXt layer of `G`,
    the gradient reaching its noise in the last backward pass through it
    (the sum over samples and channels of the gradient at its dwconv's
    output, which the noise is added to), fp32 (H, W), with the layer's
    noise for a strength of 1 at that size: `maps` {"G." + layer: (map,
    unit noise)}. The layer's noise_strength gradient is the sum of their
    product."""

    def __init__(self, G):
        from vfm_vae_tpu_torch.models.convnext import ConvNeXtSynthesisLayer

        self.layers = {"G." + n: m for n, m in G.named_modules()
                       if isinstance(m, ConvNeXtSynthesisLayer) and m.legacy}
        self.maps, self.handles = {}, []

    def hook(self, name: str, layer):
        from vfm_vae_tpu_torch.ops.resize import resize_bilinear

        def forward(module, args, out):
            if not out.requires_grad:
                return
            H, W = out.shape[1], out.shape[2]
            unit = layer.noise_const.detach().float()[None, :, :, None]
            if unit.shape[1:3] != (H, W):
                unit = resize_bilinear(unit, size=(H, W))
            unit = unit[0, :, :, 0]

            def backward(g):
                self.maps[name] = (g.detach().float().sum((0, 3)), unit)

            out.register_hook(backward)
        return forward

    def __enter__(self):
        self.handles = [m.dwconv.register_forward_hook(self.hook(n, m))
                        for n, m in self.layers.items()]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def determinism_run(t, st, img, eq, bufs) -> tuple:
    """One [D, G] evaluation without the update on trainer `t` from the
    buffers `bufs` ({"G": ..., "D": ...}): ({quantity: value} of the loss
    terms and per-module gradient norms, {"G."/"D." + parameter: fp32
    gradient}, noise_maps' maps of the G step)."""
    from vfm_vae_tpu_torch.train.loss import G_TERMS

    for mod, key in ((t.G, "G"), (t.D, "D")):  # spectral-norm u/v, x_avg, usage as they were
        for k, v in mod.named_buffers():
            v.copy_(bufs[key][k])
    t.record_grad_norms, t.grad_norms = True, {}
    d_grads, d_total, _ = t.d_gradients(st, img, eq)
    with noise_maps(t.G) as nm:
        g_grads, terms, _, _, g_total = t.g_gradients(st, img, eq, update_buffers=False)
    t.record_grad_norms = False
    out = {"D total": float(d_total), "G total": float(g_total)}
    out.update({"G " + n: float(v) for n, v in zip(G_TERMS, terms) if float(v) != 0.0})
    groups = {}
    for n, v in t.grad_norms.items():
        key = ".".join(n.split(".")[:4])
        groups[key] = groups.get(key, 0.0) + v * v
    out.update({"|grad| " + k: math.sqrt(v) for k, v in groups.items()})
    grads = {**{"D." + n: g.detach().float() for n, g in zip(t.d_params, d_grads)},
             **{"G." + n: g.detach().float() for n, g in zip(t.g_params, g_grads)}}
    return out, grads, nm.maps


def determinism_phase(tr, state, real, trials: int = 1, build_fp32=None,
                      label: str = "determinism") -> None:
    """[D, G] steps with no random draws (posterior mode, no DiffAugment, D
    resizes instead of cropping), without the update: the kernel path, the
    plain-twin path (bf16) and an fp32 plain copy on the same weights and
    batch. Trial 0 takes the training phase's first batch at the identity
    bucket; trial i > 0 a batch drawn from a generator seeded i at
    FORCED_BUCKETS[i % 3].

    The gate is paired and reads the gradient tensors (gate_readings): for
    each loss term and each trainable gradient tensor, the kernel path's
    relative error vs fp32 over the plain path's; the median of these
    ratios must be at most TRUTH_FACTOR, and no tensor may trip the guard
    (the kernel path past GUARD_KERNEL_REL where the plain path is under
    GUARD_PLAIN_REL; noise_strength read through its noise map). Until
    slice 16 it read the loss terms and the per-module gradient norms,
    whose errors are small residuals of an error both bf16 paths share;
    that reading is printed beside the gated one, with the gains. A
    failure prints every quantity to stderr.

    `build_fp32` builds the fp32 trainer of the configuration `tr` runs
    (default: the stage-0 flagship trainer); `label` names the printed lines."""
    import torch

    from vfm_vae_tpu_torch.entry import flagship_trainer

    dev = real.device
    bufs = {"G": {k: v.clone() for k, v in tr.G.named_buffers()},
            "D": {k: v.clone() for k, v in tr.D.named_buffers()}}
    if build_fp32 is None:
        tr32 = flagship_trainer(dev, real.shape[0], torch.Generator(device=dev).manual_seed(0),
                                dtype=torch.float32, allow_random_lpips=True)
    else:
        tr32 = build_fp32()
    tr32.G.load_state_dict(tr.G.state_dict())
    tr32.D.load_state_dict(tr.D.state_dict())
    if tr.loss.lpips is not None:
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
        kern, gk, mk = determinism_run(tr, state, img, eq, bufs)
        tr.G.use_plain_kernels(True)
        plain, gp, mp = determinism_run(tr, state, img, eq, bufs)
        tr.G.use_plain_kernels(False)
        exact, g32, m32 = determinism_run(tr32, state32, img, eq, bufs)
        r = gate_readings(kern, plain, exact, gk, gp, g32,
                          dict(kernels=mk, plain=mp, fp32=m32))
        del gk, gp, g32, mk, mp, m32
        lines = [f"[{label}] trial {trial} eq={eq} {k}: fp32 {exact[k]:.6g} kernel "
                 f"{kern[k]:.6g} (rel {r['rel'][k][0]:.2e}) plain {plain[k]:.6g} (rel "
                 f"{r['rel'][k][1]:.2e})" for k in r["old_keys"]]
        print("\n".join(lines), flush=True)
        ok = r["median"] <= TRUTH_FACTOR and not r["guard"]
        summary = f"[{label}] trial {trial} eq={eq}: {gate_text(r)} {'OK' if ok else 'FAIL'}"
        print(summary, flush=True)
        if not ok:
            detail = [f"[{label}] trial {trial} {k}: kernel/plain {v:.3f} (kernel "
                      f"{r['errors'][k][0]:.3e}, plain {r['errors'][k][1]:.3e})"
                      for k, v in sorted(r["ratios"].items(), key=lambda kv: -kv[1])]
            print("\n".join(lines + detail + [summary]), file=sys.stderr, flush=True)
            failed.append(trial)
    del tr32, state32
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"chip_smoke: {label}: the kernel training step is further from fp32 "
                         f"than the plain bf16 step (trials {failed})")


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


def dwconv_resources(lib_path: str) -> dict:
    """{dwconv instance: (registers, stack frame bytes, local memory bytes)}
    from `cuobjdump -res-usage` of the built library (a spill needs both a
    stack frame and local memory); chip_smoke fails unless every K7/K8
    instance has neither."""
    from vfm_vae_tpu_torch.ops.kernels._build import _nvcc

    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    dump = subprocess.run([tool, "-res-usage", lib_path], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in dump.splitlines():
        if (m := re.search(r"Function (\S+?):?\s*$", line)):
            name = kernel_name(m.group(1)) if "dwconv_kernel" in m.group(1) else None
        elif name and (m := re.search(r"REG:(\d+) STACK:(\d+).*LOCAL:(\d+)", line)):
            out[name] = tuple(int(g) for g in m.groups())
    return out


def kernel_dwconv_phase(sites: dict, batches=(2, 32)) -> dict:
    """K7 (noise on and off) and K8 against their twins at every ConvNeXt
    dwconv shape of a flagship decode, at B=2 and B=32: t within DWCONV_ULPS
    bf16 ulps, K7's statistics against fp64 sums of the kernel's own t at
    K5's bounds; t, s1, s2 and K8's output bit-identical on a second call;
    one wrapper launch a call and, for K7 with noise, one kernel a call on
    the card (the profiler's count). The twins' fp32 conv runs in full fp32
    (cuDNN's TF32 off for the phase)."""
    import torch

    from vfm_vae_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(77)
    worst = {"dwconv_noise_stats": 0.0, "depthwise_conv2d_same": 0.0}
    failed = []
    k7, k8 = kernels.dwconv_noise_stats, kernels.depthwise_conv2d_same
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for B in batches:
            for site in sites["dwconv_noise_stats"]:
                x, w, b, noise = dwconv_inputs(site, B, gen, dev)
                line = []
                for tag, nz in (("noise", noise), ("no noise", None)):
                    before = k7.launches
                    t, s1, s2 = k7(x, w, b, nz)
                    t2, r1, r2 = k7(x, w, b, nz)
                    calls = k7.launches - before
                    rt, _, _ = k7(x, w, b, nz, plain=True)
                    torch.cuda.synchronize()
                    ulps = bf16_ulps(t, rt)
                    e1, e2 = stats_errors(s1, s2, t)
                    same = torch.equal(t, t2) and torch.equal(s1, r1) and torch.equal(s2, r2)
                    ok = (bool(torch.isfinite(t.float()).all()) and ulps <= DWCONV_ULPS
                          and max(e1, e2) <= STATS_REL and same and calls == 2)
                    worst["dwconv_noise_stats"] = max(worst["dwconv_noise_stats"],
                                                      float((t.float() - rt.float()).abs().max()))
                    line.append(f"K7 {tag} {ulps:g} ulps, stats {e1:.2e} / {e2:.2e}, repeat "
                                f"bit-identical {same}, launches a call {calls / 2:g}"
                                f"{'' if ok else ' FAIL'}")
                    if not ok:
                        failed.append(f"K7 {tag} {site_label(site)} B={B}")
                    del t, t2, rt, s1, s2, r1, r2
                per_call = device_launches(lambda: k7(x, w, b, noise), reps=3)
                one = sum(per_call.values()) == 1 and all("dwconv_kernel" in key
                                                          for key in per_call)
                line.append(f"K7 kernels a call {per_call}{'' if one else ' FAIL'}")
                if not one:
                    failed.append(f"K7 one kernel {site_label(site)} B={B}")
                w8 = w[:, :, None, :].contiguous()
                got, again = k8(x, w8, b), k8(x, w8, b)
                ref = k8(x, w8, b, plain=True)
                torch.cuda.synchronize()
                ulps = bf16_ulps(got, ref)
                same = torch.equal(got, again)
                worst["depthwise_conv2d_same"] = max(worst["depthwise_conv2d_same"],
                                                     float((got.float() - ref.float()).abs().max()))
                ok = ulps <= DWCONV_ULPS and same
                line.append(f"K8 {ulps:g} ulps, repeat bit-identical {same}"
                            f"{'' if ok else ' FAIL'}")
                if not ok:
                    failed.append(f"K8 {site_label(site)} B={B}")
                print(f"[kernel-dwconv] {site_label(site)} B={B}: " + "; ".join(line)
                      + f" (tol {DWCONV_ULPS:g} ulp, stats {STATS_REL:g})", flush=True)
                del x, w, b, noise, w8, got, again, ref
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
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


def dwconv_probe(G, batches=(2, 32)) -> tuple:
    """The dwconv probe, the port's counterpart of tools/bench_dwstats.py: K7
    and K8 on the weights, bias and legacy noise map of every ConvNeXt layer
    of the flagship decoder at B=2, in a launch window of their own (no
    model path runs them); then, at B=2 and B=32, each shape's kernel (CUDA
    events and device time), twin (events, B=2) and library times: cuDNN's
    depthwise F.conv2d with a bf16 bias, plus for K7 the noise add and the
    two reductions, by events and by device time in turns with the kernel."""
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
                x = torch.randn((2, res, res, C), generator=gen, device=dev).to(torch.bfloat16)
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
          f"B=2: K7 {launches['dwconv_noise_stats']}, K8 {launches['depthwise_conv2d_same']}; "
          f"predicted {want['dwconv_noise_stats']}, {want['depthwise_conv2d_same']}", flush=True)
    if launches != want:
        raise SystemExit(f"chip_smoke: dwconv probe launches {launches}")
    del calls

    out = {}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms", "library_device_ms")
    for B in batches:
        for name in PROBE_KERNELS:
            stats = name == "dwconv_noise_stats"
            tot = dict.fromkeys(keys, 0.0)
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
                ms, lib_ms = in_turns(fn, lib)
                plain_ms = cuda_time_ms(pfn) if B == batches[0] else None
                dev_ms, lib_dev, _, lib_per = device_in_turns(fn, lib)
                ops, byts = dwconv_work(site, B, stats)
                bnd, b_by = plain_bound(ops, byts, PEAK_FP32_FLOPS)
                by[b_by] = by.get(b_by, 0) + n
                for key, val in zip(keys, (ms, plain_ms, lib_ms, bnd, dev_ms, lib_dev)):
                    tot[key] = add_or_none(tot[key], val, n)
                frac = "not measured" if dev_ms is None else f"{bnd / dev_ms:.3f}"
                print(f"[dwconv-probe] {'K7' if stats else 'K8'} C={C} H=W={site['H']} k={k} B={B}: "
                      f"kernel_ms={ms:.4f} device_ms={ms_text(dev_ms)} library_ms={lib_ms:.4f} "
                      f"library_device_ms={ms_text(lib_dev)} (in turns; "
                      f"{', '.join(short_kernel_name(key) for key in lib_per)}) plain_ms="
                      f"{ms_text(plain_ms)} bound_ms={bnd:.4f} ({b_by}) of_bound device {frac} "
                      f"{ops / ms / 1e9:.2f} TFLOP/s x{n}/decode", flush=True)
                del x, w, b, noise, xc, wc, bb, fn, pfn, lib
                torch.cuda.empty_cache()
            frac = ("not measured" if tot["device_ms"] is None
                    else f"{tot['bound_ms'] / tot['device_ms']:.3f}")
            print(f"[dwconv-probe] {'K7' if stats else 'K8'}, all dwconvs of one decode at B={B}: "
                  f"kernel {tot['ms']:.4f} ms (device {ms_text(tot['device_ms'])}, of_bound "
                  f"{frac}), plain {ms_text(tot['plain_ms'])} ms, library (cuDNN"
                  f"{' + reductions' if stats else ''}) {tot['library_ms']:.4f} ms (device "
                  f"{ms_text(tot['library_device_ms'])}), bound {tot['bound_ms']:.4f} ms",
                  flush=True)
            if B == batches[0]:
                out[name] = dict(batch=B, bound_by=max(by, key=by.get), **tot)
            else:
                out[name][f"b{B}"] = dict(bound_by=max(by, key=by.get), **tot)
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
    sites) at B=2, counted per encode, and at the stage-0 step's B=4; at
    discrete mode's post_quant site (POST_QUANT_SITE) at B=2 and at
    DISCRETE_B, rows under "post_quant"; at the
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
             + [dict(POST_QUANT_SITE, Tk=POST_QUANT_SITE["T"], B=b, dt=f32, timed=True)
                for b in (B, DISCRETE_B)]
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
            if c["at"] == "post_quant":
                acc[key].setdefault("post_quant", {})[f"B={Bc}"] = row
            elif Bc != B:
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


# ------------------------------------------------------------------ slice 13


RECIPE_YAMLS = (
    "configs/vfm_vae_f16d32_siglip2_stage_0_strong_alignment.yaml",
    "configs/vfm_vae_f16d32_siglip2_stage_1_weak_alignment.yaml",
    "configs/vfm_vae_f16d32_siglip2_stage_2_ssim_ft.yaml",
    "configs/vfm_vae_f16d32_siglip2_stage_3_patchgan_ft.yaml",
)
RECIPE_STEPS = 3  # [D, G] steps a stage: a warm-up and two active steps
RECIPE_BATCH = 4
# Each stage must move at least this share of its trainable tensors (the
# D heads' BatchNormLocal-fed biases, zero in exact arithmetic, apart).
RECIPE_MOVED = 0.9


def write_recipe_shards(root: str, n_shards: int = 2, per_shard: int = 16,
                        size: int = 256, seed: int = 0) -> None:
    """WebDataset tar shards of seeded smooth size x size JPEGs (random 8 x 8
    colour fields upsampled, plus noise) with class labels."""
    import io
    import tarfile

    import numpy as np
    import PIL.Image

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    idx = 0
    for s in range(n_shards):
        with tarfile.open(os.path.join(root, f"{s:05d}.tar"), "w") as tf:
            for _ in range(per_shard):
                field = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
                img = np.asarray(PIL.Image.fromarray(field).resize((size, size),
                                                                  PIL.Image.BICUBIC))
                img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
                for ext, data in (("jpg", None), ("cls", str(idx % 10).encode())):
                    if data is None:
                        buf = io.BytesIO()
                        PIL.Image.fromarray(img).save(buf, format="JPEG", quality=90)
                        data = buf.getvalue()
                    info = tarfile.TarInfo(f"{idx:08d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
                idx += 1


class recipe_steps:
    """Wraps Trainer.d_step and Trainer.g_step while the recipe's CLI calls
    run: each step is timed between two synchronizes, each step's EQ bucket
    is kept and its kernel launches are read from the wrappers' counters
    (differences, so the phase's totals stay whole), and the stage's first
    D step records its starting point: every G and D parameter and the EMA
    after the resume, before any update (copied to the host, so that the
    stage's peak memory is the training's own)."""

    def __init__(self):
        self.stage = None

    def begin(self, label: str) -> dict:
        self.stage = dict(label=label, d_ms=[], g_ms=[], d_launches=[], g_launches=[],
                          d_eq=[], g_eq=[], before=None, ema0=None)
        return self.stage

    def __enter__(self):
        import torch

        from vfm_vae_tpu_torch.ops import kernels
        from vfm_vae_tpu_torch.train.train_step import Trainer

        self.orig = (Trainer.d_step, Trainer.g_step)
        d_step, g_step = self.orig
        probe = self

        def timed(fn, tr, args, kwargs, ms):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(tr, *args, **kwargs)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def d_wrapped(tr, state, *args, **kwargs):
            st = probe.stage
            if st["before"] is None:
                st["before"] = host_copy(named_params(tr))
                st["ema0"] = host_copy(state.ema)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            st["d_eq"].append(args[1])
            c0 = kernels.launch_counts()
            out = timed(d_step, tr, (state,) + args, kwargs, st["d_ms"])
            c1 = kernels.launch_counts()
            st["d_launches"].append({k: c1[k] - c0[k] for k in c1})
            return out

        def g_wrapped(tr, *args, **kwargs):
            probe.stage["g_eq"].append(args[2])
            c0 = kernels.launch_counts()
            out = timed(g_step, tr, args, kwargs, probe.stage["g_ms"])
            c1 = kernels.launch_counts()
            probe.stage["g_launches"].append({k: c1[k] - c0[k] for k in c1})
            return out

        Trainer.d_step, Trainer.g_step = d_wrapped, g_wrapped
        return self

    def __exit__(self, *exc):
        from vfm_vae_tpu_torch.train.train_step import Trainer

        Trainer.d_step, Trainer.g_step = self.orig


def host_copy(tensors: dict) -> dict:
    return {n: t.detach().to("cpu", copy=True) for n, t in tensors.items()}


def run_recipe_cli(cfg, path: str, steps: int, counts: dict):
    """One call of the port's CLI on `cfg` (written to `path`), on the card;
    the launches it made are added into `counts`."""
    import yaml

    from vfm_vae_tpu_torch.core.config import to_plain
    from vfm_vae_tpu_torch.ops import kernels
    from vfm_vae_tpu_torch.train import cli

    with open(path, "w") as f:
        yaml.safe_dump(to_plain(cfg), f)
    c0 = kernels.launch_counts()
    out = cli.main(["--config", path, "--max-steps", str(steps)])
    c1 = kernels.launch_counts()
    for k in c1:
        counts[k] = counts.get(k, 0) + c1[k] - c0[k]
    return out


def recipe_phase(card: str, tmp: str) -> tuple:
    """The four-stage recipe (configs/*stage_{0..3}*.yaml) through the port's
    CLI (vfm_vae_tpu_torch.train.cli.main, in process, on the card) at full
    flagship width and depth: every G_kwargs, D_kwargs and loss_kwargs key
    as the YAML has it, random seeded weights. Overrides, printed once:
    run_dir (a temporary directory), training_set_kwargs.path (synthetic
    256 px shards written here), batch_size, kimg_per_tick and
    network_snapshot_ticks (one tick a stage, at its end, with a snapshot),
    --max-steps (RECIPE_STEPS), resume_path/resume_kimg (the chain) and
    allow_random_lpips. Stage N + 1 resumes stage N's snapshot; a sixth call
    on stage 3's run_dir without resume_path must auto-resume its snapshot.

    Gates (tests/test_stage_chain.py's, and more): (1) each stage starts
    exactly where its predecessor ended, every G and D parameter and EMA
    tensor present in both bit for bit (the frozen tower through the whole
    chain), and its cur_nimg goes on; (2) within a stage no frozen parameter
    moves and at least RECIPE_MOVED of the trainable ones do; (3) stage 3's
    resume reports exactly the PatchGAN parameters (and their Adam state)
    fresh, while DINO and the heads load (gate 1); (4) every loss in
    stats.jsonl is finite, with ssim_loss in stage 2 and the PatchGAN and
    feature-matching terms in stage 3 non-zero; (5) stage 3's G_ema
    round-trips a batch to finite pixels; (6) the auto-resume; (7) K1, K2
    and K3 launch in every active G step (after the first) of each stage,
    and K3's two backward kernels exactly where a trainable parameter lies
    upstream of a decoder attention (stages 0-2, not 3); (8) stages 2 and 3
    pass determinism_phase on their own configuration. Everything is
    written under `tmp` (the caller removes it); only the newest snapshot
    stays on disk. Returns the launches of the six CLI calls, the last
    snapshot's path and stage 3's YAML, which the tools phase reads."""
    import gc

    import torch

    from vfm_vae_tpu_torch.core.config import derive_config, load_config
    from vfm_vae_tpu_torch.train.loop import build_trainer, ema_weights

    t_phase = time.perf_counter()
    counts: dict = {}
    try:
        shards = os.path.join(tmp, "shards")
        write_recipe_shards(shards)
        overrides = dict(batch_size=RECIPE_BATCH, kimg_per_tick=1000, network_snapshot_ticks=1,
                         allow_random_lpips=True)
        print(f"[recipe] overrides of every stage YAML: run_dir {tmp}/stage<N>, "
              f"training_set_kwargs.path {shards} (2 shards x 16 seeded 256 px JPEGs), "
              f"{overrides}, --max-steps {RECIPE_STEPS}, resume_path/resume_kimg: the previous "
              f"stage's snapshot, 0", flush=True)
        prev = None  # the previous stage's end: params, EMA, snapshot path, cur_nimg
        probe = recipe_steps()
        with probe:
            for i, rel in enumerate(RECIPE_YAMLS):
                t_stage = time.perf_counter()
                c = derive_config(load_config(os.path.join(HERE, rel)))
                c.run_dir = os.path.join(tmp, f"stage{i}")
                c.training_set_kwargs.path = shards
                c.update(overrides, resume_path=prev and prev["snapshot"], resume_kimg=0)
                st = probe.begin(f"stage{i}")
                res = run_recipe_cli(c, os.path.join(tmp, f"stage{i}.yaml"), RECIPE_STEPS, counts)
                peak = torch.cuda.max_memory_allocated()
                tr, state = res.trainer, res.state
                params = host_copy(named_params(tr))
                trainable = {"G." + n for n in tr.g_params} | {"D." + n for n in tr.d_params}
                fails = []
                # (1) the handoff.
                if prev is not None:
                    if res.resume is None or res.resume["path"] != prev["snapshot"]:
                        fails.append(f"resumed {res.resume and res.resume['path']}, not "
                                     f"{prev['snapshot']}")
                    off = [n for n, v in st["before"].items()
                           if n in prev["params"] and not torch.equal(v, prev["params"][n])]
                    off += [n for n, v in st["ema0"].items()
                            if n in prev["ema"] and not torch.equal(v, prev["ema"][n])]
                    if off:
                        fails.append(f"{len(off)} tensors differ from the previous stage's end: "
                                     f"{off[:4]}")
                    tower = [n for n in params if n.startswith("G.vfm_encoder.")]
                    if not tower or any(n not in prev["params"] for n in tower):
                        fails.append("the tower is missing from the handoff")
                    if state.cur_nimg != prev["cur_nimg"] + RECIPE_BATCH * RECIPE_STEPS:
                        fails.append(f"cur_nimg {state.cur_nimg} after {prev['cur_nimg']}")
                # (2) freezing.
                moved_frozen = [n for n in params if n not in trainable
                                and not torch.equal(st["before"][n], params[n])]
                gated = [n for n in trainable if not bn_fed_bias(n)]
                still = [n for n in gated if torch.equal(st["before"][n], params[n])]
                if moved_frozen:
                    fails.append(f"frozen tensors moved: {moved_frozen[:4]}")
                if len(still) > (1 - RECIPE_MOVED) * len(gated):
                    fails.append(f"{len(still)}/{len(gated)} trainable tensors did not move")
                # (3) PatchGAN fresh in stage 3, nothing else fresh anywhere.
                fresh = set(res.resume["fresh"]) if res.resume else set()
                pg = {n[2:] for n in params if n.startswith("D.patchgan.")}
                want_fresh = ({f"D/{n}" for n in pg}
                              | {f"d_opt/{n}/{k}" for n in pg
                                 for k in ("step", "exp_avg", "exp_avg_sq")})
                if fresh != want_fresh:
                    fails.append(f"fresh after resume {sorted(fresh)[:4]} ({len(fresh)}), want "
                                 f"{len(want_fresh)} PatchGAN entries")
                if i == 3 and not pg:
                    fails.append("stage 3's D has no PatchGAN branch")
                # (4) the logged losses.
                with open(os.path.join(c.run_dir, "stats.jsonl")) as f:
                    entry = json.loads(f.read().splitlines()[-1])
                losses = {k: v for k, v in entry.items() if k.startswith("Loss/")}
                bad = [k for k, v in losses.items() if not math.isfinite(v)]
                need = {2: ["Loss/G/ssim_loss"],
                        3: ["Loss/G/patchgan/loss", "Loss/G/patchgan/feature_matching_loss",
                            "Loss/D/patchgan/loss"]}.get(i, [])
                zero = [k for k in need if not losses.get(k)]
                if bad or zero:
                    fails.append(f"losses not finite {bad[:4]} or missing/zero {zero}")
                # (7) kernels in the active G steps.
                attn = list(c.G_kwargs.attn_block_indices)
                late = tuple(f"synthesis.{p}.{b}." for p in ("blocks", "z_convs")
                             for b in range(max(attn) + 1, c.G_kwargs.num_blocks))
                bwd = any(not n.startswith(late) for n in tr.g_params)
                for j, lc in enumerate(st["g_launches"][1:], start=1):
                    fwd0 = [k for k in ("fused_convnext_mlp", "fused_upsample_blur",
                                        "flash_attention_nullkv") if lc[k] == 0]
                    bwd_n = (lc["flash_attention_nullkv_bwd_dkv"], lc["flash_attention_nullkv_bwd_dq"])
                    if fwd0 or (min(bwd_n) > 0) != bwd or (max(bwd_n) > 0) != bwd:
                        fails.append(f"G step {j}: kernels {fwd0} not launched, K3 backward "
                                     f"{bwd_n} (expected {'some' if bwd else 'none'})")
                snap = res.snapshot
                print(f"[recipe] stage {i} ({os.path.basename(rel)}) on {card}: "
                      f"{len(tr.g_params)} G and {len(tr.d_params)} D tensors trainable, "
                      f"{len(gated) - len(still)}/{len(gated)} moved (not: {sorted(still)}), "
                      f"frozen unchanged; D step "
                      f"{statistics.median(st['d_ms'][1:]):.1f} ms, G step "
                      f"{statistics.median(st['g_ms'][1:]):.1f} ms (median of steps 1-"
                      f"{RECIPE_STEPS - 1}; D {', '.join(f'{x:.1f}' for x in st['d_ms'])}, G "
                      f"{', '.join(f'{x:.1f}' for x in st['g_ms'])}); peak memory "
                      f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated); snapshot "
                      f"{snap['bytes']} bytes saved in {snap['seconds']:.2f} s"
                      + (f", resume {'strict' if res.resume['strict'] else 'loose'} load "
                         f"{res.resume['seconds']:.2f} s, {len(fresh)} entries fresh"
                         if res.resume else "")
                      + f"; active G-step launches "
                      f"{[{k: v for k, v in lc.items() if v} for lc in st['g_launches'][1:]]}; "
                      f"stage {time.perf_counter() - t_stage:.1f} s", flush=True)
                print(f"[recipe] stage {i} losses: " + ", ".join(
                    f"{k[5:]}={v:.4g}" for k, v in sorted(losses.items())
                    if "/is_safe/" not in k and "skipped" not in k), flush=True)
                if fails:
                    raise SystemExit(f"chip_smoke: recipe stage {i}: " + "; ".join(fails))
                res_px = c.training_set_kwargs.resolution
                if i >= 2:  # (8) on this stage's configuration
                    kw = {k: c[k] for k in ("G_kwargs", "D_kwargs", "loss_kwargs",
                                            "G_opt_kwargs", "D_opt_kwargs")}
                    gen = torch.Generator(device="cuda").manual_seed(100 + i)
                    real = torch.rand((RECIPE_BATCH, res_px, res_px, 3), generator=gen,
                                      device="cuda")
                    try:
                        determinism_phase(tr, state, real, build_fp32=lambda: build_trainer(
                            **kw, device="cuda", compute_dtype="float32",
                            batch_size=RECIPE_BATCH, allow_random_lpips=True),
                            label=f"recipe-determinism-stage{i}")
                    except SystemExit:
                        # The weights this stage entered with, kept for
                        # `python determinism_probe.py --entry <path>` (the
                        # run's own temporary directory is removed).
                        kept = tempfile.mkdtemp(prefix=f"vfm_stage{i}_entry_")
                        shutil.copytree(prev["snapshot"], kept, dirs_exist_ok=True)
                        print(f"[recipe] stage {i} entered from {prev['snapshot']}; kept as "
                              f"{kept}", file=sys.stderr, flush=True)
                        raise
                if i == 3:  # (5) the final G_ema
                    real = torch.rand((RECIPE_BATCH, res_px, res_px, 3),
                                      generator=torch.Generator(device="cuda").manual_seed(5),
                                      device="cuda")
                    with ema_weights(tr.G, state.ema):
                        out = tr.G.decode(tr.G.encode(real))
                    if out.shape != real.shape or not bool(torch.isfinite(out).all()):
                        raise SystemExit(f"chip_smoke: recipe: G_ema's round trip {out.shape} "
                                         "is not finite")
                    print(f"[recipe] stage 3 G_ema round trip {tuple(out.shape)}: finite, "
                          f"|x| mean {float(out.abs().mean()):.4f}", flush=True)
                if prev is not None:  # only the newest snapshot stays on disk
                    shutil.rmtree(prev["snapshot"])
                prev = dict(snapshot=snap["path"], cur_nimg=state.cur_nimg, params=params,
                            ema=host_copy(state.ema))
                del res, tr, state, params, st
                gc.collect()
                torch.cuda.empty_cache()

            # (6) the CLI again on stage 3's run_dir, no resume_path.
            c.resume_path = None
            probe.begin("stage3-again")
            res = run_recipe_cli(c, os.path.join(tmp, "stage3_again.yaml"), 1, counts)
            with open(os.path.join(c.run_dir, "log.txt")) as f:
                logged = f"[auto-resume] found {prev['snapshot']}" in f.read()
            if res.resume is None or res.resume["path"] != prev["snapshot"] or not logged:
                raise SystemExit(f"chip_smoke: recipe: the second stage-3 call did not "
                                 f"auto-resume {prev['snapshot']} ({res.resume and res.resume['path']}, "
                                 f"logged {logged})")
            print(f"[recipe] stage 3 again without resume_path: auto-resumed {res.resume['path']} "
                  f"({'strict' if res.resume['strict'] else 'loose'}, "
                  f"{res.resume['seconds']:.2f} s), cur_nimg {res.state.cur_nimg}", flush=True)
            snapshot = prev["snapshot"]
            del res, prev
    finally:
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[recipe] launches over the six CLI calls: "
          f"{ {k: v for k, v in counts.items() if v} }; phase {time.perf_counter() - t_phase:.1f} "
          f"s on {card}", flush=True)
    return counts, snapshot, os.path.join(tmp, "stage3.yaml")


# ------------------------------------------------------------------ slice 16


BATCH_POLICIES = ("none", "dots", "names", "full")
BATCH_B = 4  # the remat and process-group steps; the accumulation step takes 2 x BATCH_B
PUBLISHED_BATCH = 512  # every stage YAML's batch_size (a global batch)
PUBLISHED_YAML = RECIPE_YAMLS[0]
# Microbatches that split the published batch evenly, largest first.
MICRO_CANDIDATES = (256, 128, 64, 32, 16, 8, 4)
# The published step takes the largest microbatch whose peak, by the linear
# fit of the remat steps' peaks at BATCH_B and 2 x BATCH_B, stays under this
# share of the card's memory.
MEMORY_SHARE = 0.85


def set_remat(G, remat) -> None:
    """G's remat policy after construction (as Generator's `remat` sets it)."""
    from vfm_vae_tpu_torch.models.synthesis import remat_policy

    policy = remat_policy(remat)
    G.remat = policy
    for block in G.synthesis.blocks:
        block.remat = policy
    G.vfm_encoder.tower.remat = policy is not None


class trainer_weights:
    """G's and D's parameters and buffers, kept on the card and put back by
    restore() (the spectral-norm vectors and x_avg move in every step)."""

    def __init__(self, tr):
        self.mods = {"G": tr.G, "D": tr.D}
        self.saved = {k: {n: t.detach().clone() for n, t in m.state_dict().items()}
                      for k, m in self.mods.items()}

    def restore(self) -> None:
        import torch

        with torch.no_grad():
            for k, m in self.mods.items():
                own = m.state_dict()
                for n, t in self.saved[k].items():
                    own[n].copy_(t)

    def named(self) -> dict:
        return {f"{k}.{n}": t for k, sd in self.saved.items() for n, t in sd.items()}


def fresh_step(tr, real, eq, seed: int, before=None, keep: bool = False) -> dict:
    """One [D, G] step from fresh optimiser state on the weights as they are,
    its draws from a generator seeded `seed`: times, stats, totals, raw
    gradient norms, launches, peak memory; the trainable tensors that moved
    from `before` ({name: tensor}); with `keep`, the trainable parameters and
    the EMA after the step, on the host (so that no later step's peak holds
    them)."""
    import torch

    from vfm_vae_tpu_torch.ops import kernels

    gen = torch.Generator(device=real.device).manual_seed(seed)
    state = tr.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    tr.record_grad_norms, tr.grad_norms = True, {}
    t0 = time.perf_counter()
    state, d_stats, d_total = tr.d_step(state, real, eq, gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, g_stats, g_total = tr.g_step(state, real, eq, gen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tr.record_grad_norms = False
    params = named_params(tr)
    out = dict(d_ms=(t1 - t0) * 1e3, g_ms=(t2 - t1) * 1e3, stats={**d_stats, **g_stats},
               totals=torch.stack([d_total, g_total]), norms=dict(tr.grad_norms),
               launches=kernels.launch_counts(), peak=torch.cuda.max_memory_allocated())
    if before is not None:
        out["moved"] = {n for n in trainable_names(tr) if n in before
                        and not torch.equal(params[n], before[n])}
    if keep:
        out["params"] = host_copy({n: params[n] for n in trainable_names(tr)})
        out["ema"] = host_copy(state.ema)
    return out


def trainable_names(tr) -> list:
    return sorted({"G." + n for n in tr.g_params} | {"D." + n for n in tr.d_params})


def max_rel(a: dict, b: dict) -> float:
    """The largest relative difference between two {name: number} maps."""
    return max((abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in b), default=0.0)


def differing(a: dict, b: dict) -> list:
    """Names whose tensors differ (or are missing) between two maps."""
    import torch

    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or not torch.equal(a[k], b[k]))


class deterministic_steps:
    """For the length of a `with`: the step's kernels that can run
    deterministically do (cuDNN's deterministic algorithms, PyTorch's
    deterministic implementations, SDPA's math backend: the memory-efficient
    backward of the adapter's fp32 attention sums with atomics), so that two
    runs of one step can be compared bit for bit. Ops with no deterministic
    implementation warn by name. The hand-written kernels are deterministic
    as they are (K3's backward adds its partials in order)."""

    def __enter__(self):
        import torch
        import torch.utils.deterministic
        from torch.nn.attention import SDPBackend, sdpa_kernel

        self.saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
                      torch.are_deterministic_algorithms_enabled(),
                      torch.is_deterministic_algorithms_warn_only_enabled(),
                      torch.utils.deterministic.fill_uninitialized_memory)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False
        self.sdpa = sdpa_kernel([SDPBackend.MATH])
        self.sdpa.__enter__()
        return self

    def __exit__(self, *exc):
        import torch
        import torch.utils.deterministic

        self.sdpa.__exit__(*exc)
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark, on, warn,
         torch.utils.deterministic.fill_uninitialized_memory) = self.saved
        torch.use_deterministic_algorithms(on, warn_only=warn)


def module_norms(norms: dict) -> dict:
    """Raw gradient norms summed in quadrature per module (determinism_phase's
    grouping), without the BatchNormLocal-fed head biases (rounding noise)."""
    groups: dict = {}
    for n, v in norms.items():
        if not bn_fed_bias(n):
            key = ".".join(n.split(".")[:4])
            groups[key] = groups.get(key, 0.0) + v * v
    return {k: math.sqrt(v) for k, v in groups.items()}


def remat_steps(tr, real, real2, eq, card: str) -> tuple:
    """One stage-0 [D, G] step under each remat policy on the same weights,
    batch and draws. A warm-up step first. Then, under deterministic_steps,
    none, dots, names, full and none again; gates: every loss term and D's
    total bit for bit against the first none run, and the per-module
    gradient norms, the adaptive VF weight and G's total within the largest
    relative spread between the two none runs (0 when the step is
    deterministic). Then as the loop runs them (none, dots, names, full and
    back, in turns): step ms and peak memory per policy, and gates on the
    launches phase_launches predicts for the policy and on the same tensors
    moving as under none (at least RECIPE_MOVED of the trainable ones);
    then one step at 2 x BATCH_B under dots and under full for the memory
    fit. Returns ({policy: [timed runs]}, {policy: {B: peak bytes}},
    launches)."""
    import torch

    from vfm_vae_tpu_torch.train.train_step import G_STAT_NAMES

    weights = trainer_weights(tr)
    before = weights.named()
    gated = [n for n in trainable_names(tr) if not bn_fed_bias(n)]
    terms = [k for k in G_STAT_NAMES.values()]
    exact = {p: [] for p in BATCH_POLICIES}
    runs = {p: [] for p in BATCH_POLICIES}
    peaks = {p: {} for p in BATCH_POLICIES}
    launches: dict = {}

    def step(policy, img, seed, **kw):
        weights.restore()
        set_remat(tr.G, policy)
        r = fresh_step(tr, img, eq, seed=seed, **kw)
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
        return r

    try:
        step("none", real, 30)
        with deterministic_steps():
            for policy in BATCH_POLICIES + ("none",):
                exact[policy].append(step(policy, real, 31))
        for policy in BATCH_POLICIES + BATCH_POLICIES[::-1]:
            r = step(policy, real, 31, before=before)
            r["want"] = predicted_launches(tr.G, [eq])
            r["moved"] &= set(gated)
            runs[policy].append(r)
            peaks[policy][real.shape[0]] = max(peaks[policy].get(real.shape[0], 0), r["peak"])
        for policy in ("dots", "full"):
            peaks[policy][real2.shape[0]] = step(policy, real2, 32)["peak"]
    finally:
        set_remat(tr.G, None)
        weights.restore()

    def loose(r):
        """The quantities that hang on the backward's sums."""
        vf = r["stats"]["Loss/G/cur_vf_loss_weight"]
        return {**module_norms(r["norms"]), "vf weight": float(vf[1] / vf[0]),
                "G total": float(r["totals"][1])}

    ref, other = exact["none"]
    spread = max_rel(loose(other), loose(ref))
    fails = []
    for policy, rs in exact.items():
        for turn, r in enumerate(rs):
            tag = f"{policy} (deterministic, run {turn})"
            stats = {k: v for k, v in r["stats"].items() if k.startswith("Loss/D/") or k in terms}
            want = {k: v for k, v in ref["stats"].items() if k in stats}
            off = differing(stats, want)
            if off or not torch.equal(r["totals"][0], ref["totals"][0]):
                fails.append(f"{tag}: loss terms {off[:4]} or D total "
                             f"{float(r['totals'][0])} differ from none's")
            rel = max_rel(loose(r), loose(ref))
            if rel > spread:
                fails.append(f"{tag}: gradient norms, VF weight or G total {rel:.3e} from "
                             f"none's (spread {spread:.3e})")
    ref_moved = runs["none"][0]["moved"]
    for policy, rs in runs.items():
        for turn, r in enumerate(rs):
            tag = f"{policy} (turn {turn})"
            if r["moved"] != ref_moved or len(r["moved"]) < RECIPE_MOVED * len(gated):
                fails.append(f"{tag}: {len(r['moved'])}/{len(gated)} trainable tensors moved "
                             f"(none: {len(ref_moved)})")
            kern = {k: r["launches"][k] for k in r["want"]}
            if kern != r["want"]:
                fails.append(f"{tag}: launches {kern} != predicted {r['want']}")
    for policy, rs in runs.items():
        r0 = rs[0]
        dev = max(max_rel(loose(r), loose(ref)) for r in exact[policy])
        peak_text = ", ".join(f"B={b}: {v / 2 ** 30:.2f} GiB"
                              for b, v in sorted(peaks[policy].items()))
        print(f"[batch-remat] {policy}: B={real.shape[0]} eq={eq} on {card}: D "
              f"{', '.join(f'{r['d_ms']:.1f}' for r in rs)} ms, G "
              f"{', '.join(f'{r['g_ms']:.1f}' for r in rs)} ms (in turns); peak memory "
              f"{peak_text} (max_memory_allocated); K1 {r0['launches']['fused_convnext_mlp']}, K2 "
              f"{r0['launches']['fused_upsample_blur']}, K3 "
              f"{r0['launches']['flash_attention_nullkv']}, K3-dkv/dq "
              f"{r0['launches']['flash_attention_nullkv_bwd_dkv']}/"
              f"{r0['launches']['flash_attention_nullkv_bwd_dq']} a step (predicted "
              f"{r0['want']['fused_convnext_mlp']}, {r0['want']['fused_upsample_blur']}, "
              f"{r0['want']['flash_attention_nullkv']}); deterministic: per-module gradient "
              f"norms, VF weight and G total within {dev:.3e} of none's; "
              f"{len(r0['moved'])}/{len(gated)} trainable tensors moved", flush=True)
    print(f"[batch-remat] deterministic steps: the two none runs' per-module gradient norms, "
          f"VF weight and G total differ by {spread:.3e} at most; the loss terms and D total "
          f"of every policy {'bit for bit' if not fails else 'see failures'} against none",
          flush=True)
    if fails:
        raise SystemExit("chip_smoke: batch remat: " + "; ".join(fails[:6]))
    return peaks, launches


def accumulation_check(tr, real8, eq, card: str) -> dict:
    """Trainer(num_accumulation=2).d_step and .g_step at 2 x BATCH_B against
    two d_gradients and two g_gradients calls on the same chunks, weights
    and draws (the loss state threaded), summed, under deterministic_steps:
    the summed gradients that reach Adam bit for bit, then every trainable
    parameter and EMA tensor after the step bit for bit. Returns the
    launches."""
    import torch

    from vfm_vae_tpu_torch.ops import kernels
    from vfm_vae_tpu_torch.train.train_step import Trainer

    weights = trainer_weights(tr)
    seen: list = []

    def capture(opt, params, grads):
        seen.append([g.clone() for g in grads])
        Trainer._apply(opt, params, grads)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with deterministic_steps():
            weights.restore()
            tr.num_accumulation, tr._apply = 2, capture
            gen = torch.Generator(device=real8.device).manual_seed(41)
            state = tr.init_state()
            state, _, _ = tr.d_step(state, real8, eq, gen)
            state, _, _ = tr.g_step(state, real8, eq, gen)
            params = named_params(tr)
            acc = {n: params[n].detach().clone() for n in trainable_names(tr)}
            acc_ema = {n: e.clone() for n, e in state.ema.items()}
            del tr._apply
            tr.num_accumulation = 1

            weights.restore()
            gen = torch.Generator(device=real8.device).manual_seed(41)
            state = tr.init_state()
            B = real8.shape[0] // 2
            chunks = (real8[:B], real8[B:])
            parts = [tr.d_gradients(state, c, eq, gen)[0] for c in chunks]
            d_sum = [a + b for a, b in zip(*parts)]
            Trainer._apply(state.d_opt, list(tr.d_params.values()), d_sum)
            loss_state, parts = state.loss_state, []
            for c in chunks:
                g, _, loss_state, _, _ = tr.g_gradients(state, c, eq, gen, loss_state=loss_state)
                parts.append(g)
            g_sum = [a + b for a, b in zip(*parts)]
            Trainer._apply(state.g_opt, list(tr.g_params.values()), g_sum)
            from vfm_vae_tpu_torch.train.optim import ema_beta, ema_update

            ema_update(state.ema, tr.g_params, ema_beta(tr.batch_size, state.cur_nimg,
                                                        tr.ema_kimg, tr.ema_rampup))
            params = named_params(tr)
            manual = {n: params[n].detach().clone() for n in trainable_names(tr)}
    finally:
        tr.__dict__.pop("_apply", None)
        tr.num_accumulation = 1
        weights.restore()
    launches = kernels.launch_counts()
    fails = []
    for label, got, want in (("D", seen[0], d_sum), ("G", seen[1], g_sum)):
        off = [i for i, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
        if off or len(got) != len(want):
            fails.append(f"{label}: {len(off)}/{len(want)} summed gradients differ")
    off = differing(acc, manual) + differing(acc_ema, state.ema)
    if off:
        fails.append(f"{len(off)} tensors differ after the step: {off[:4]}")
    print(f"[batch-accumulation] B={real8.shape[0]} as 2 microbatches of {B} on {card}: the "
          f"accumulated D and G gradients ({len(d_sum)} and {len(g_sum)} tensors) "
          f"{'equal' if not fails else 'differ from'} the sums of two d_gradients and two "
          f"g_gradients calls bit for bit, and so do {len(acc)} parameters and {len(acc_ema)} EMA "
          f"tensors after the step; {time.perf_counter() - t0:.1f} s", flush=True)
    if fails:
        raise SystemExit("chip_smoke: batch accumulation: " + "; ".join(fails))
    return launches


def nccl_world1(tr, real, eq, card: str) -> dict:
    """The stage-0 step at BATCH_B without a process group and inside
    init_process_group("nccl", world_size=1), both under deterministic_steps:
    stats, totals, every trainable parameter and EMA tensor bit for bit, and
    check_replica_consistency over them passes. Returns the launches."""
    import datetime

    import torch
    import torch.distributed as dist

    from vfm_vae_tpu_torch.parallel import mesh

    weights = trainer_weights(tr)
    store = tempfile.mkdtemp(prefix="vfm_nccl_")
    launches: dict = {}
    try:
        with deterministic_steps():
            weights.restore()
            alone = fresh_step(tr, real, eq, seed=51, keep=True)
            dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store, "s"), 1),
                                    rank=0, world_size=1,
                                    timeout=datetime.timedelta(seconds=120))
            try:
                weights.restore()
                grouped = fresh_step(tr, real, eq, seed=51, keep=True)
                mesh.check_replica_consistency({**grouped["params"], **{
                    "G_ema." + n: e for n, e in grouped["ema"].items()}})
                backend = dist.get_backend()
            finally:
                dist.destroy_process_group()
            for r in (alone, grouped):
                for k, v in r["launches"].items():
                    launches[k] = launches.get(k, 0) + v
    finally:
        weights.restore()
        shutil.rmtree(store, ignore_errors=True)
    off = (differing(alone["stats"], grouped["stats"])
           + differing(alone["params"], grouped["params"])
           + differing(alone["ema"], grouped["ema"]))
    same = not off and torch.equal(alone["totals"], grouped["totals"])
    print(f"[batch-nccl] B={real.shape[0]} on {card}: world 1 over {backend} against no process "
          f"group: stats, totals, {len(alone['params'])} trainable and {len(alone['ema'])} EMA "
          f"tensors {'bit for bit' if same else 'DIFFER ' + str(off[:4])}; replica check "
          f"passed; G {alone['g_ms']:.1f} ms alone, {grouped['g_ms']:.1f} ms in the group",
          flush=True)
    if not same:
        raise SystemExit(f"chip_smoke: batch nccl: world 1 differs from no group: {off[:4]}")
    return launches


def pick_microbatch(peaks: dict, total: int) -> tuple:
    """The largest microbatch of MICRO_CANDIDATES under the policy the loop
    picks for it (dots up to 12 images, full above) whose peak, by the
    linear fit of that policy's two measured peaks, is at most MEMORY_SHARE
    of `total`; and each policy's largest fitting microbatch."""
    def fit(policy):
        (b0, p0), (b1, p1) = sorted(peaks[policy].items())
        slope = (p1 - p0) / (b1 - b0)
        return lambda m: p0 + slope * (m - b0)

    fits = {p: fit(p) for p in ("dots", "full")}
    largest = {p: next((m for m in MICRO_CANDIDATES if f(m) <= MEMORY_SHARE * total), None)
               for p, f in fits.items()}
    for m in MICRO_CANDIDATES:
        policy = "dots" if m <= 12 else "full"
        if fits[policy](m) <= MEMORY_SHARE * total:
            return m, policy, fits[policy](m), largest
    raise SystemExit(f"chip_smoke: no microbatch of {MICRO_CANDIDATES} fits the fit {peaks}")


def published_batch(card: str, tmp: str, peaks: dict) -> dict:
    """The stage-0 YAML with accumulate_gradients set so that 512 /
    accumulate_gradients is the largest microbatch that fits
    (pick_microbatch) through the port's CLI: one [D, G] step of the
    published 512 images on synthetic 256 px shards, a snapshot, then a
    second call that auto-resumes it and takes one more step of a single
    microbatch (batch_size the microbatch, no accumulation: the resume is
    what that call checks, and a second 512-image step took about 85 s of
    the script's time limit). Overrides as the recipe phase's (run_dir, the
    shards, one tick and one snapshot a call, random LPIPS). Gates: finite
    logged losses, Progress/kimg 0.512 and cur_nimg 512 after the first
    call, RECIPE_MOVED of the trainable tensors moved, every step's
    launches as phase_launches predicts for its bucket, the loop's remat
    and accumulate_gradients microbatches, peak memory under the card's,
    and the auto-resume. Returns the launches."""
    import gc

    import torch

    from vfm_vae_tpu_torch.core.config import derive_config, load_config

    total = torch.cuda.get_device_properties(0).total_memory
    micro, policy, predicted, largest = pick_microbatch(peaks, total)
    n_acc = PUBLISHED_BATCH // micro
    print(f"[batch-published] memory fit (peaks at B=4 and 8, {card}): the largest microbatch "
          f"within {MEMORY_SHARE} of {total / 2 ** 30:.2f} GiB is "
          + ", ".join(f"{p} {m}" for p, m in largest.items())
          + f"; the step takes {n_acc} microbatches of {micro} under {policy!r} (predicted peak "
          f"{predicted / 2 ** 30:.2f} GiB)", flush=True)
    shards = os.path.join(tmp, "shards")
    write_recipe_shards(shards, n_shards=2, per_shard=64, seed=16)
    c = derive_config(load_config(os.path.join(HERE, PUBLISHED_YAML)))
    if c.batch_size != PUBLISHED_BATCH:
        raise SystemExit(f"chip_smoke: {PUBLISHED_YAML} has batch_size {c.batch_size}")
    c.run_dir = os.path.join(tmp, "published")
    c.training_set_kwargs.path = shards
    c.update(accumulate_gradients=n_acc, kimg_per_tick=1000, network_snapshot_ticks=1,
             allow_random_lpips=True)
    print(f"[batch-published] {PUBLISHED_YAML} with accumulate_gradients {n_acc}; overrides as "
          f"the recipe's: run_dir {c.run_dir}, training_set_kwargs.path {shards} (2 shards x 64 "
          f"seeded 256 px JPEGs), kimg_per_tick 1000, network_snapshot_ticks 1, "
          f"allow_random_lpips", flush=True)
    counts: dict = {}
    probe = recipe_steps()
    fails = []
    with probe:
        calls = []
        for call, call_acc in (("first", n_acc), ("auto-resume", 1)):
            t0 = time.perf_counter()
            st = probe.begin(call)
            c.update(batch_size=micro * call_acc, accumulate_gradients=call_acc)
            res = run_recipe_cli(c, os.path.join(tmp, f"published_{call}.yaml"), 1, counts)
            peak = torch.cuda.max_memory_allocated()
            with open(os.path.join(c.run_dir, "stats.jsonl")) as f:
                entry = json.loads(f.read().splitlines()[-1])
            tr = res.trainer
            if tr.num_accumulation != call_acc or tr.G.remat != policy:
                fails.append(f"{call}: the loop ran {tr.num_accumulation} microbatches under "
                             f"{tr.G.remat!r}")
            for phase, eqs, got in (("D", st["d_eq"], st["d_launches"]),
                                    ("G", st["g_eq"], st["g_launches"])):
                for eq, lc in zip(eqs, got):
                    want = phase_launches(tr.G, eq, phase, n_acc=call_acc)
                    if {k: lc[k] for k in want} != want:
                        fails.append(f"{call} {phase} step eq={eq}: launches {lc} != {want}")
            losses = {k: v for k, v in entry.items() if k.startswith("Loss/")}
            if not losses or any(not math.isfinite(v) for v in losses.values()):
                fails.append(f"{call}: logged losses not finite: {losses}")
            if peak >= total:
                fails.append(f"{call}: peak {peak} bytes")
            params = host_copy(named_params(tr))
            gated = [n for n in trainable_names(tr) if not bn_fed_bias(n)]
            moved = [n for n in gated if not torch.equal(st["before"][n], params[n])]
            if len(moved) < RECIPE_MOVED * len(gated):
                fails.append(f"{call}: {len(moved)}/{len(gated)} trainable tensors moved")
            if call == "first":
                if (res.state.cur_nimg != PUBLISHED_BATCH
                        or entry["Progress/kimg"] != PUBLISHED_BATCH / 1000):
                    fails.append(f"cur_nimg {res.state.cur_nimg}, Progress/kimg "
                                 f"{entry['Progress/kimg']}")
                c.resume_path = None  # the second call finds the snapshot itself
                snapshot = res.snapshot["path"]
            else:
                with open(os.path.join(c.run_dir, "log.txt")) as f:
                    logged = f"[auto-resume] found {snapshot}" in f.read()
                if (res.resume is None or res.resume["path"] != snapshot or not logged
                        or res.state.cur_nimg != PUBLISHED_BATCH + micro):
                    fails.append(f"the second call did not auto-resume {snapshot} "
                                 f"({res.resume and res.resume['path']}, logged {logged}, "
                                 f"cur_nimg {res.state.cur_nimg})")
            d_ms, g_ms = st["d_ms"][0], st["g_ms"][0]
            calls.append((d_ms, g_ms))
            n_img = micro * call_acc
            print(f"[batch-published] {call}: one [D, G] step of {n_img} images "
                  f"({call_acc} x {micro}, remat {tr.G.remat!r}) on {card}: D {d_ms:.1f} ms, G "
                  f"{g_ms:.1f} ms, {n_img / ((d_ms + g_ms) / 1e3):.1f} img/s; peak "
                  f"memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated); Progress/kimg "
                  f"{entry['Progress/kimg']}, cur_nimg {res.state.cur_nimg}; "
                  f"{len(moved)}/{len(gated)} trainable tensors moved; buckets D {st['d_eq']} "
                  f"G {st['g_eq']}; snapshot {res.snapshot['path']} "
                  f"({res.snapshot['seconds']:.2f} s)"
                  + (f"; resumed {res.resume['path']}" if res.resume else "")
                  + f"; call {time.perf_counter() - t0:.1f} s", flush=True)
            print(f"[batch-published] {call} losses: " + ", ".join(
                f"{k[5:]}={v:.4g}" for k, v in sorted(losses.items())
                if "/is_safe/" not in k and "skipped" not in k), flush=True)
            del res, tr, params
            gc.collect()
            torch.cuda.empty_cache()
    if fails:
        raise SystemExit("chip_smoke: batch published: " + "; ".join(fails[:6]))
    return counts


def batch_phase(card: str, tmp: str) -> dict:
    """The published batch (slice 16) at flagship width and depth: remat
    policies against none, accumulation against summed microbatches, world
    1 over NCCL against no process group (on entry.flagship_trainer, B=4
    and 8), then the stage-0 YAML's 512 images through the CLI. A world of
    two processes on the one card is not run: NCCL refuses two ranks on
    one device, and the phase's time goes to the published step; the CPU
    tests hold world 2 against world 1 with gloo. Returns the launches."""
    import gc

    import torch

    from vfm_vae_tpu_torch.entry import flagship_trainer

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    tr = flagship_trainer(dev, 2 * BATCH_B, gen, allow_random_lpips=True)
    randomize_zero_init_branches(tr.G, seed=4)
    res = tr.G.synthesis.block_resolutions[-1]
    real8 = torch.rand((2 * BATCH_B, res, res, 3), generator=gen, device=dev)
    eq = (1.0, 0, False)  # the largest activations: no EQ shrink
    counts: dict = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    peaks, c = remat_steps(tr, real8[:BATCH_B], real8, eq, card)
    add(c)
    add(accumulation_check(tr, real8, eq, card))
    add(nccl_world1(tr, real8[:BATCH_B], eq, card))
    del tr, real8
    gc.collect()
    torch.cuda.empty_cache()
    add(published_batch(card, tmp, peaks))
    print(f"[batch] launches: { {k: v for k, v in counts.items() if v} }; phase "
          f"{time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return counts


# ------------------------------------------------------------------ slice 17

# The discrete phase's stage-0 YAML: configs/*stage_0*.yaml with only these
# keys changed (G_kwargs, loss_kwargs). entropy_loss_weight weights the
# entropy term, which use_entropy_loss computes (the JAX default 0 would
# leave it out of the gradient); blur_fade_kimg > 1 turns the D-input blur
# schedule on (sigma 2 at cur_nimg 0).
DISCRETE_YAML_G = dict(compression_mode="discrete", use_entropy_loss=True)
DISCRETE_YAML_LOSS = dict(compression_mode="discrete", entropy_loss_weight=0.1,
                          use_stylegan_t_disc_warmup=True, use_patchgan_disc_warmup=True,
                          blur_fade_kimg=100)
DISCRETE_B = 32
DISCRETE_STEPS = 3
# idx_to_f(f_to_idx(x)) against encode's z: the straight-through sum
# f + (f_hat - f) can round away from f_hat by an fp32 ulp of f (unit-norm
# chunks: below 2^-23), so the two z's agree within DISCRETE_Z_ABS and their
# fp32 decodes within DISCRETE_IDX_REL_L1. The bf16 decodes are held to
# DECODE_REL_L1 instead: a 2e-9 change of z flips bf16 roundings in the
# decoder and reads 5e-3 (rel-L1) at random weights on an H100, as the
# 3mm-flash decode against the default one does.
DISCRETE_Z_ABS = 1e-6
DISCRETE_IDX_REL_L1 = 1e-3


def usage_percent(idx, codes: int) -> float:
    """The codebooks' mean share of codes used above 1% of uniform
    (the quantizer's usage figure) from indices (B, num_codebooks, L)."""
    import torch

    per = []
    for i in range(idx.shape[1]):
        counts = torch.bincount(idx[:, i].reshape(-1), minlength=codes).float()
        prob = counts / counts.sum().clamp_min(1.0)
        per.append(float((prob > 0.01 / codes).float().mean()) * 100.0)
    return sum(per) / len(per)


def discrete_phase(card: str, tmp: str) -> dict:
    """The discrete (VQ) tokenizer at flagship width (slice 17).

    Round trip: the flagship SigLIP2-L/16-512 tower with DISCRETE_G (z
    16 x 16 x 64, eight codebooks of 4096 codes), bf16, seeded random
    weights with the zero-initialised branches randomised, B=32 encode ->
    decode by default and under VFM_VAE_ADAPTER_ATTN=3mm-flash (K4-f32 at
    the adapter's five sites, post_quant's T=256 N=16 d=64 among them),
    each request's launches against kernel_sites' prediction. Gates: shapes
    and finiteness; the decode against the plain twins and fp32 (slice_phase's
    rule, on the first 4 images); f_to_idx's indices equal, bit for bit, to
    the codes encode took (recovered from its z, each token its own nearest
    code) and in range; idx_to_f(indices) within DISCRETE_Z_ABS of
    encode's z, their fp32 decodes within DISCRETE_IDX_REL_L1 and their bf16
    decodes within DECODE_REL_L1 (K4-f32 at the new site is held and timed
    with the encode's fp32 sites: POST_QUANT_SITE). Prints usage_pct, img/s at B=32 of the discrete and the continuous
    flagship, default and 3mm-flash, in turns, and the VQ's device time
    (eight argmax products, gather, bincount) beside the encode's.

    Training: configs/*stage_0*.yaml with only DISCRETE_YAML_G and
    DISCRETE_YAML_LOSS changed (and recipe_phase's overrides) through the
    CLI: DISCRETE_STEPS [D, G] steps and a snapshot, then a call that
    auto-resumes it and takes one more step. Gates: finite logged losses
    with the VQ, entropy and codebook usage terms; every trainable G
    tensor moved; D unchanged while the StyleGAN-T branch waits for its
    warm-up (its loss is 0); K1-K3 and K3's backward in every G step; the
    resume strict and the usage EMAs and record counters carried across it.
    Prints the warm-up machine's state. Returns {"discrete": launches of
    the requests and CLI calls}."""
    import gc

    import numpy as np
    import torch

    from vfm_vae_tpu_torch.core.config import derive_config, load_config
    from vfm_vae_tpu_torch.entry import (
        DISCRETE_G,
        FLAGSHIP_KWARGS,
        flagship_generator,
        kernel_sites,
    )
    from vfm_vae_tpu_torch.models.adapter import map_to_tokens
    from vfm_vae_tpu_torch.models.generator import Generator
    from vfm_vae_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    counts: dict = {}

    def count(fn):
        """Run `fn` on the main path: its launches go into `counts`."""
        c0 = kernels.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        c1 = kernels.launch_counts()
        got = {k: c1[k] - c0[k] for k in c1}
        for k, n in got.items():
            counts[k] = counts.get(k, 0) + n
        return out, got

    Gd = flagship_generator(dev, torch.bfloat16, torch.Generator(device=dev).manual_seed(17),
                            **DISCRETE_G)
    randomize_zero_init_branches(Gd, seed=18)
    ad = Gd.ldm_adapter
    cb = ad.quantizer.codebooks
    codes = cb[0].codebook.weight.shape[0]
    print(f"[discrete] flagship in discrete mode: {sum(p.numel() for p in Gd.parameters()) / 1e6:.1f}"
          f" M parameters; {len(cb)} codebooks of {codes} codes, "
          f"{cb[0].codebook.weight.shape[1]} wide; z {ad.z_resolution}x{ad.z_resolution}x"
          f"{DISCRETE_G['vocab_width']}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(170)
    img = torch.rand((DISCRETE_B, 256, 256, 3), generator=gen, device=dev)
    outs, fails = {}, []
    for name, env in (("default", {"VFM_VAE_ADAPTER_ATTN": None}),
                      ("3mm-flash", {"VFM_VAE_ADAPTER_ATTN": "3mm-flash"})):
        with env_vars(dict(NO_SWITCHES, **env)):
            sites = kernel_sites(Gd, 256)
            want = forward_counts(sites)
            (z, x), got = count(lambda: (lambda z: (z, Gd.decode(z)))(Gd.encode(img)))
        post = [s for s in sites["flash_attention_nonull"] if s["at"] == "post_quant"]
        outs[name] = (z, x)
        print(f"[discrete] {name} request B={DISCRETE_B}: launches {got}; predicted {want}",
              flush=True)
        if any(got.get(k, 0) != n for k, n in want.items()) or any(
                n and k not in want for k, n in got.items()):
            fails.append(f"{name} launches")
        if (name == "3mm-flash") != (post == [dict(T=256, N=16, D=64, at="post_quant",
                                                    count=1)]):
            fails.append(f"{name}: post_quant K4 sites {post}")
        if tuple(z.shape) != (DISCRETE_B, 16, 16, DISCRETE_G["vocab_width"]) or \
                tuple(x.shape) != (DISCRETE_B, 256, 256, 3):
            fails.append(f"{name} shapes {tuple(z.shape)} {tuple(x.shape)}")
        if not (torch.isfinite(z).all() and torch.isfinite(x).all()):
            fails.append(f"{name} non-finite")
    z_k, x_k = outs["default"]
    print(f"[discrete] 3mm-flash vs default: z rel-L1 {rel_l1(outs['3mm-flash'][0], z_k):.3e}, "
          f"decode rel-L1 {rel_l1(outs['3mm-flash'][1], x_k):.3e}", flush=True)

    # The indices: f_to_idx against the codes encode took (each quantized
    # token is its own nearest code), the round trip through idx_to_f.
    with torch.no_grad():
        feats = Gd.vfm_encoder.encode_image(img)
        idx = ad.f_to_idx(feats)
        tok = map_to_tokens(z_k.float()).chunk(len(cb), dim=-1)
        took = torch.stack([(t.reshape(-1, t.shape[-1]) @ q.normalized_codebook().t())
                            .argmax(1).reshape(t.shape[:2]) for t, q in zip(tok, cb)], dim=1)
        z_idx = ad.quantizer.idx_to_f(idx).reshape(z_k.shape).to(z_k.dtype)
        x_idx = Gd.decode(z_idx)
    same = torch.equal(idx, took)
    in_range = int(idx.min()) >= 0 and int(idx.max()) < codes
    dz = float((z_idx.float() - z_k.float()).abs().max())
    idx_rel = rel_l1(x_idx, x_k)
    usage = usage_percent(idx, codes)
    print(f"[discrete] indices {tuple(idx.shape)} in [{int(idx.min())}, {int(idx.max())}] of "
          f"{codes}: f_to_idx == encode's codes {same} ({int((idx != took).sum())} differ); "
          f"usage_pct {usage:.2f}; idx_to_f(idx) vs encode's z max |diff| {dz:.3e} (limit "
          f"{DISCRETE_Z_ABS:g}); bf16 decodes rel-L1 {idx_rel:.3e} (tol {DECODE_REL_L1:g})",
          flush=True)
    if not (same and in_range and dz <= DISCRETE_Z_ABS and idx_rel <= DECODE_REL_L1):
        fails.append("indices round trip")

    # The decode against the plain twins and fp32 (slice_phase's rule).
    zq = z_k[:4]
    Gd.use_plain_kernels(True)
    x_p = Gd.decode(zq)
    Gd.use_plain_kernels(False)
    G32 = Generator(**dict(FLAGSHIP_KWARGS, **DISCRETE_G), dtype=torch.float32, device=dev)
    G32.load_state_dict(Gd.state_dict())
    G32.use_plain_kernels(True)
    x_32 = G32.decode(zq.float())
    idx32 = rel_l1(G32.decode(z_idx[:4].float()), x_32)
    del G32
    torch.cuda.empty_cache()
    print(f"[discrete] fp32 decodes of idx_to_f(idx) and of encode's z: rel-L1 {idx32:.3e} "
          f"(limit {DISCRETE_IDX_REL_L1:g})", flush=True)
    if idx32 > DISCRETE_IDX_REL_L1:
        fails.append("indices round trip in fp32")
    kp, k32, p32 = rel_l1(x_k[:4], x_p), rel_l1(x_k[:4], x_32), rel_l1(x_p, x_32)
    print(f"[discrete] decode: kernel vs plain rel-L1 {kp:.3e} (tol {DECODE_REL_L1:g}); vs fp32 "
          f"kernel {k32:.3e} plain {p32:.3e} (limit {TRUTH_FACTOR} x plain)", flush=True)
    if not (kp <= DECODE_REL_L1 and k32 <= TRUTH_FACTOR * p32 + 1e-6):
        fails.append("decode vs plain / fp32")
    if fails:
        raise SystemExit(f"chip_smoke: discrete phase failed: {fails}")
    del outs, x_p, x_32, feats, z_idx, x_idx

    # Speed, in turns with the continuous flagship in the same call.
    Gc = flagship_generator(dev, torch.bfloat16, torch.Generator(device=dev).manual_seed(0))
    randomize_zero_init_branches(Gc, seed=1)
    rates: dict = {}
    for rep in range(2):
        for env_name, env in (("default", None), ("3mm-flash", "3mm-flash")):
            with env_vars(dict(NO_SWITCHES, VFM_VAE_ADAPTER_ATTN=env)):
                order = (("discrete", Gd), ("continuous", Gc))
                for name, G in (order if rep == 0 else order[::-1]):
                    rates.setdefault(f"{name} {env_name}", []).append(round_trip_rate(G, img))
    for key, r in rates.items():
        print(f"[discrete] round trip B={DISCRETE_B} {key}: "
              f"{', '.join(f'{x:.2f}' for x in r)} img/s in turns on {card}", flush=True)
    del Gc
    torch.cuda.empty_cache()
    with torch.no_grad():
        x_tok = map_to_tokens(ad.encode(Gd.vfm_encoder.encode_image(img),
                                        return_z_before_quantize=True))
    def quantize():
        with torch.no_grad():
            return ad.quantizer(x_tok)

    vq_dev, vq_per = device_kernels(quantize)
    enc_dev = device_ms(lambda: Gd.encode(img), reps=3)
    share = ("not measured" if vq_dev is None or enc_dev is None
             else f"{vq_dev / enc_dev:.4f}")
    print(f"[discrete] VQ device time B={DISCRETE_B}: {ms_text(vq_dev)} ms of the encode's "
          f"{ms_text(enc_dev)} ms (share {share}); its kernels "
          + ", ".join(f"{short_kernel_name(n)} {ms:.4f}" for n, ms in list(vq_per.items())[:6]),
          flush=True)
    del x_tok, Gd, img, z_k, x_k
    gc.collect()
    torch.cuda.empty_cache()

    # Training through the CLI.
    shards = os.path.join(tmp, "shards")
    write_recipe_shards(shards, seed=17)
    c = load_config(os.path.join(HERE, RECIPE_YAMLS[0]))
    c.G_kwargs.update(DISCRETE_YAML_G)
    c.loss_kwargs.update(DISCRETE_YAML_LOSS)
    c = derive_config(c)
    c.run_dir = os.path.join(tmp, "run")
    c.training_set_kwargs.path = shards
    c.update(batch_size=RECIPE_BATCH, kimg_per_tick=1000, network_snapshot_ticks=1,
             allow_random_lpips=True)
    print(f"[discrete] {RECIPE_YAMLS[0]} with G_kwargs {DISCRETE_YAML_G}, loss_kwargs "
          f"{DISCRETE_YAML_LOSS}; batch_size {RECIPE_BATCH}, --max-steps {DISCRETE_STEPS}",
          flush=True)
    probe = recipe_steps()
    t0 = time.perf_counter()
    with probe:
        st = probe.begin("discrete")
        res = run_recipe_cli(c, os.path.join(tmp, "discrete.yaml"), DISCRETE_STEPS, counts)
    first_s = time.perf_counter() - t0
    tr, fsm = res.trainer, res.warmup
    params = host_copy(named_params(tr))
    usage0 = host_copy({n: b for n, b in tr.G.named_buffers() if ".quantizer." in n})
    g_tr = sorted("G." + n for n in tr.g_params)
    d_tr = sorted("D." + n for n in tr.d_params)
    unmoved = [n for n in g_tr if torch.equal(params[n], st["before"][n])]
    d_moved = [n for n in d_tr if not torch.equal(params[n], st["before"][n])]
    with open(os.path.join(c.run_dir, "stats.jsonl")) as f:
        entry = json.loads(f.readline())
    losses = {k: v for k, v in entry.items() if k.startswith("Loss/")}
    step_ok = all(g.get("fused_convnext_mlp", 0) and g.get("fused_upsample_blur", 0)
                  and g.get("flash_attention_nullkv", 0)
                  and g.get("flash_attention_nullkv_bwd_dkv", 0)
                  and g.get("flash_attention_nullkv_bwd_dq", 0) for g in st["g_launches"])
    print(f"[discrete] {DISCRETE_STEPS} [D, G] steps in {first_s:.1f} s: D ms "
          f"{', '.join(f'{x:.1f}' for x in st['d_ms'])}, G ms "
          f"{', '.join(f'{x:.1f}' for x in st['g_ms'])}; vq {losses.get('Loss/G/vq_loss')} "
          f"entropy {losses.get('Loss/G/entropy_loss')} codebook_usages "
          f"{losses.get('Loss/G/codebook_usages')} l1 {losses.get('Loss/G/l1_pixel_loss')} "
          f"vf {losses.get('Loss/G/vf_loss')} D {losses.get('Loss/D/stylegan_t/loss')}; "
          f"{len(g_tr) - len(unmoved)}/{len(g_tr)} trainable G tensors moved "
          f"({unmoved[:4]}), {len(d_moved)}/{len(d_tr)} D tensors moved (StyleGAN-T on: "
          f"{tr.loss.stylegan_t_on}); G steps' launches {st['g_launches']}", flush=True)
    print(f"[discrete] warm-up machine after {DISCRETE_STEPS} steps: active {fsm.active}, "
          f"stylegan_t_on {tr.loss.stylegan_t_on}, patchgan_on {tr.loss.patchgan_on}, pixel "
          f"window {len(fsm.pixel_window)} (mean "
          f"{float(np.mean(fsm.pixel_window)) if fsm.pixel_window else float('nan'):.4f}), "
          f"D window {len(fsm.d_window)}, patience counts {fsm.pixel_cn}/{fsm.d_cn}, "
          f"freeze_triggered {fsm.freeze_triggered}", flush=True)
    counters0 = {n: int(b) for n, b in usage0.items() if n.endswith("usage_record_times")}
    stylegan_on = bool(tr.loss.stylegan_t_on)
    del res, tr, params
    gc.collect()
    torch.cuda.empty_cache()
    with probe:
        st2 = probe.begin("discrete resumed")
        res2 = run_recipe_cli(c, os.path.join(tmp, "discrete.yaml"), 1, counts)
    loaded = {n: b for n, b in res2.trainer.G.named_buffers() if ".quantizer." in n}
    counters1 = {n: int(b) for n, b in loaded.items() if n.endswith("usage_record_times")}
    snap = os.path.join(res2.resume["path"], "G.pt") if res2.resume else None
    saved = torch.load(snap, map_location="cpu", weights_only=True) if snap else {}
    carried = all(torch.equal(saved[n], usage0[n]) for n in usage0
                  if n.endswith("vocab_usage"))
    print(f"[discrete] resumed {res2.resume and res2.resume['path']} (strict "
          f"{res2.resume and res2.resume['strict']}, fresh {res2.resume and res2.resume['fresh']}):"
          f" usage EMAs in the snapshot equal the run's {carried}; record counters "
          f"{sorted(set(counters0.values()))} -> {sorted(set(counters1.values()))} after one "
          f"more step", flush=True)
    if not (all(math.isfinite(v) for v in losses.values())
            and all(k in losses for k in ("Loss/G/vq_loss", "Loss/G/entropy_loss",
                                          "Loss/G/codebook_usages"))
            and losses["Loss/G/vq_loss"] > 0 and not unmoved
            and not d_moved and not stylegan_on and step_ok
            and res2.resume is not None and res2.resume["strict"] and not res2.resume["fresh"]
            and carried and set(counters0.values()) == {DISCRETE_STEPS}
            and set(counters1.values()) == {DISCRETE_STEPS + 1}):
        raise SystemExit("chip_smoke: discrete training gates failed")
    del res2
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[discrete] phase passed in {time.perf_counter() - t_phase:.1f} s; launches "
          f"{counts}", flush=True)
    return {"discrete": counts}


TOOLS_IMAGES = 72  # two B=32 batches and a B=8 tail
TOOLS_BATCH = 32
# InceptionV3 on the card (cuDNN fp32, TF32 off) against the same module on
# the CPU: rel-L1 of the pool features, the logits and the sFID tap (about 95
# fp32 convolutions, each summed in another order).
INCEPTION_CARD_REL = 1e-4
# |FID(x, x)| <= FID_SELF_REL * tr(Sigma): with 72 images the 2048 x 2048
# covariance is singular and scipy's sqrtm of Sigma^2 is accurate to about
# 2e-7 of the trace (1.5e-5 of 66 on random features, on the CPU).
FID_SELF_REL = 1e-5
# The bf16 prefetch and reconstruct encode on PyTorch's path (no kernel); the
# int8 prefetch runs K6 and K4 in the tower and K4 at the adapter; every
# decode K1, K2 and K3.
TOOL_PATHS = ("prefetch", "prefetch_int8", "decode_latents", "reconstruct")


class call_launches:
    """For the length of a `with`: the kernel launches of every call of the
    tower (VFMEncoder.encode_image), the adapter's encode (LDMAdapter.encode)
    and Generator.decode, in call order, as (name, {kernel: launches})."""

    TARGETS = (("vfm_vae_tpu_torch.models.vfm", "VFMEncoder", "encode_image"),
               ("vfm_vae_tpu_torch.models.adapter", "LDMAdapter", "encode"),
               ("vfm_vae_tpu_torch.models.generator", "Generator", "decode"))

    def __enter__(self):
        import importlib

        from vfm_vae_tpu_torch.ops import kernels

        self.calls, self.orig = [], []
        for mod, cls, meth in self.TARGETS:
            klass = getattr(importlib.import_module(mod), cls)
            fn = getattr(klass, meth)
            self.orig.append((klass, meth, fn))

            def wrapped(*args, _fn=fn, _name=f"{cls}.{meth}", **kwargs):
                c0 = kernels.launch_counts()
                out = _fn(*args, **kwargs)
                c1 = kernels.launch_counts()
                self.calls.append((_name, {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}))
                return out

            setattr(klass, meth, wrapped)
        return self

    def __exit__(self, *exc):
        for klass, meth, fn in self.orig:
            setattr(klass, meth, fn)

    def of(self, name: str) -> list:
        return [c for n, c in self.calls if n == name]


def run_tool(tool, argv, path, launches, card):
    """tool.main(argv) on the card; its launches are added to launches[path]
    and its calls recorded. Prints its throughput with the split of its time."""
    from vfm_vae_tpu_torch.ops import kernels

    name = tool.__name__.rsplit(".", 1)[-1]
    c0 = kernels.launch_counts()
    with call_launches() as calls:
        out = tool.main(argv)
    c1 = kernels.launch_counts()
    if path is not None:
        acc = launches.setdefault(path, {})
        for k in c1:
            acc[k] = acc.get(k, 0) + c1[k] - c0[k]
    n, wall = out["images"], out["seconds"]
    other = wall - out["setup_s"] - out["model_s"] - out["host_s"]
    print(f"[tools] {name} on {card}: {n} images in {wall:.2f} s end to end "
          f"({n / wall:.2f} img/s); setup (build, weights) {out['setup_s']:.2f} s, then "
          f"{out['images_per_s']:.2f} img/s: model {out['model_s']:.3f} s by CUDA events "
          f"({out['model_s'] * 1e3 / max(n, 1):.3f} ms an image), host image and file work "
          f"{out['host_s']:.3f} s (host clock), other {other:.3f} s", flush=True)
    return out, calls


def tool_crops(shards: str, resolution: int):
    """(crops uint8 (N, H, W, 3), labels) of the tars as prefetch reads them."""
    import io
    from glob import glob

    import numpy as np
    import PIL.Image

    from vfm_vae_tpu_torch.data.wds import iter_tar_samples
    from vfm_vae_tpu_torch.tools.prefetch import adm_center_crop

    crops, labels = [], []
    for tar in sorted(glob(os.path.join(shards, "**", "*.tar"), recursive=True)):
        for raw in iter_tar_samples(tar):
            crops.append(adm_center_crop(PIL.Image.open(io.BytesIO(raw["jpg"])), resolution))
            labels.append(int(raw["cls"].decode()))
    return np.stack(crops), np.asarray(labels, np.int64)


def tools_phase(card: str, snapshot: str, config: str, root: str) -> dict:
    """The offline tools through each CLI's main(argv), on the card, at the
    flagship width and depth, on the recipe phase's last snapshot (`config`:
    stage 3's YAML as the recipe ran it; bf16) and TOOLS_IMAGES seeded 256 px
    JPEGs in tar shards: prefetch (bf16 tower, features and images stored),
    prefetch --int8 under the flash switches, prefetch_reg,
    decode_latents_to_images of the first prefetch's shards, reconstruct of
    its stored images, then evaluate and fidelity --fid --isc of the
    outputs against the inputs, save_images_as_npz of the inputs and
    evaluate_npz of them against themselves, with random-weight
    InceptionV3 and LPIPS, all at --batch TOOLS_BATCH (a tail batch of 8).

    Gates: (1) the file contract (keys, dtypes, NCHW shapes, every sample
    with its label, latents_stats (1, 32, 1, 1), fp16 features of 256
    tokens, the dataset json, the port's reader on every file); (2)
    prefetch_reg's moments equal G.encode(..., return_z_before_quantize=True)
    -> mean_logvar_to_mean_std of the same crops at the same batch split, bit
    for bit, and that encode repeats bit for bit; (3) the PNGs of
    decode_latents_to_images equal G.decode of the stored latents at the
    same split within one uint8 step; the kernel decode of the tail batch is
    held to DECODE_REL_L1 against the plain twins and to TRUTH_FACTOR
    against fp32; (4) the int8 prefetch's latents (the B=8 tail included)
    equal an int8 replay outside the tool bit for bit (the same calibration
    batch, the same draws), and the B=8 tail's encode holds the int8 serving
    phase's gates: every K6 and K4 site against its twin on its own inputs,
    and the moments no further from the fp32 tower than the all-plain int8
    path's (TRUTH_FACTOR); (5) every tower call of the int8 prefetch
    launches K6 at every Linear and K4 at every tower attention, every
    adapter encode K4 at its sites, every decode K1, K2 and K3 at 38, 10 and
    6, and the bf16 encodes launch nothing; (6) the metrics: InceptionV3 on
    the card against the CPU (INCEPTION_CARD_REL), evaluate_npz's FID(x, x)
    (FID_SELF_REL of tr(Sigma), Sigma from the detector's features of the
    crops) and its precision and recall of a set against itself (1, 1),
    every figure finite, PSNR of identical folders 120 dB (the MSE clamp).
    Returns the launches by path (TOOL_PATHS)."""
    import numpy as np
    import PIL.Image
    import scipy
    import torch

    from vfm_vae_tpu_torch.data.safetensors_io import load_file
    from vfm_vae_tpu_torch.entry import kernel_sites
    from vfm_vae_tpu_torch.metrics.feature_stats import FeatureStats
    from vfm_vae_tpu_torch.metrics.inception import InceptionV3Features, make_detector
    from vfm_vae_tpu_torch.models.distributions import mean_logvar_to_mean_std
    from vfm_vae_tpu_torch.ops.quantized import enable_int8_tower
    from vfm_vae_tpu_torch.tools import (
        decode_latents_to_images, evaluate, evaluate_npz, fidelity, prefetch, prefetch_reg,
        reconstruct, save_images_as_npz)
    from vfm_vae_tpu_torch.tools._generator import build_generator
    from vfm_vae_tpu_torch.tools.decode_latents_to_images import to_uint8

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    launches = {p: {} for p in TOOL_PATHS}
    shards = os.path.join(root, "shards")
    write_recipe_shards(shards, n_shards=2, per_shard=TOOLS_IMAGES // 2, seed=14)
    out = {k: os.path.join(root, k) for k in ("lat", "lat8", "reg", "dec", "rec")}
    base = ["--config", config, "--snapshot", snapshot, "--batch", str(TOOLS_BATCH)]
    pre = base + ["--data", shards]
    fails = []

    def gate(ok: bool, why: str):
        if not ok:
            fails.append(why)

    # ---- the tools
    _, calls_lat = run_tool(prefetch, pre + ["--out", out["lat"], "--store-vfm-features",
                                             "--store-images"], "prefetch", launches, card)
    with serving_env(True):
        _, calls_8 = run_tool(prefetch, pre + ["--out", out["lat8"], "--int8"], "prefetch_int8",
                              launches, card)
    _, calls_reg = run_tool(prefetch_reg, pre + ["--out", out["reg"]], "prefetch", launches, card)
    _, calls_dec = run_tool(decode_latents_to_images, base + [
        "--latents", out["lat"], "--out", out["dec"]], "decode_latents", launches, card)
    _, calls_rec = run_tool(reconstruct, base + [
        "--data", os.path.join(out["lat"], "images"), "--out", out["rec"]], "reconstruct",
        launches, card)
    inputs, outputs = os.path.join(out["rec"], "inputs"), os.path.join(out["rec"], "outputs")
    ev, _ = run_tool(evaluate, ["--inputs", inputs, "--outputs", outputs, "--allow-random-lpips"],
                     None, launches, card)
    ev_same, _ = run_tool(evaluate, ["--inputs", inputs, "--outputs", inputs], None, launches, card)
    fi, _ = run_tool(fidelity, ["--input1", outputs, "--input2", inputs, "--fid", "--isc"], None,
                     launches, card)
    # evaluate_npz of the inputs against themselves: FID(x, x) near 0 and
    # precision = recall = 1; fidelity above scores the outputs against
    # them. (Each Frechet distance costs a 2048 x 2048 sqrtm, 9-26 s of host.)
    npz = os.path.join(root, "inputs.npz")
    save_images_as_npz.main(["--images", inputs, "--out", npz])
    en, _ = run_tool(evaluate_npz, ["--sample-batch", npz, "--ref-batch", npz], None, launches,
                     card)
    t_tools = time.perf_counter() - t_phase

    # ---- (1) the file contract
    crops, labels = tool_crops(shards, 256)
    splits = [(i, min(i + TOOLS_BATCH, TOOLS_IMAGES)) for i in range(0, TOOLS_IMAGES, TOOLS_BATCH)]
    shard = {k: load_file(os.path.join(out[k], "latents_rank00_shard000.safetensors"))
             for k in ("lat", "lat8", "reg")}
    for k, ch in (("lat", 32), ("lat8", 32), ("reg", 64)):
        d = shard[k]
        want = {"latents", "latents_flip", "labels"} | ({"vfm_features"} if k == "lat" else set())
        gate(set(d) == want, f"{k}: keys {sorted(d)}")
        gate(d["latents"].dtype == np.float32 and d["latents_flip"].dtype == np.float32
             and d["labels"].dtype == np.int64, f"{k}: dtypes")
        gate(d["latents"].shape == d["latents_flip"].shape == (TOOLS_IMAGES, ch, 16, 16),
             f"{k}: shape {d['latents'].shape} (the tail encoded?)")
        gate(np.array_equal(d["labels"], labels), f"{k}: labels differ from the shards'")
        gate(bool(np.isfinite(d["latents"]).all() and np.isfinite(d["latents_flip"]).all()),
             f"{k}: non-finite latents")
        lstats = load_file(os.path.join(out[k], "latents_stats.safetensors"))
        gate(all(lstats[s].shape == (1, ch, 1, 1) for s in ("mean", "std")),
             f"{k}: latents_stats shapes")
    feats = shard["lat"].get("vfm_features")
    gate(feats is not None and feats.dtype == np.float16 and feats.shape == (TOOLS_IMAGES, 256, 1024),
         "vfm_features: not fp16 (72, 256, 1024)")
    with open(os.path.join(out["lat"], "images", "dataset_rank0.json")) as f:
        records = json.load(f)["labels"]
    gate(len(records) == TOOLS_IMAGES, f"dataset_rank0.json lists {len(records)} images")
    written = [os.path.join(d, n) for d in out.values() if os.path.isdir(d)
               for n in os.listdir(d) if n.endswith(".safetensors")]
    read = sum(len(load_file(p)) > 0 for p in written)
    gate(read == len(written) == 6, f"the reader read {read} of {len(written)} files")
    print(f"[tools] file contract: {sorted(shard['lat'])} {shard['lat']['latents'].shape} "
          f"{shard['lat']['latents'].dtype}, vfm_features {feats.shape} {feats.dtype}, reg "
          f"{shard['reg']['latents'].shape}; {len(records)} images stored; {read} safetensors "
          f"files read back", flush=True)

    # ---- (2) the moments, (3) the decode: one bf16 G in process
    G, _ = build_generator(config, snapshot, dev)
    x_all = torch.from_numpy(crops).to(dev).float().div_(255.0)
    with torch.no_grad():
        runs = []
        for _ in range(2):
            m = [torch.cat([mean_logvar_to_mean_std(G.encode(x, return_z_before_quantize=True)),
                            mean_logvar_to_mean_std(G.encode(torch.flip(x, [2]),
                                                             return_z_before_quantize=True))], 0)
                 for x in (x_all[a:b] for a, b in splits)]
            runs.append(m)
        repeat = all(torch.equal(a, b) for a, b in zip(*runs))
        mine = np.concatenate([r.float().cpu().numpy()[: r.shape[0] // 2] for r in runs[0]])
        mine_f = np.concatenate([r.float().cpu().numpy()[r.shape[0] // 2:] for r in runs[0]])
    tool_m = shard["reg"]["latents"].transpose(0, 2, 3, 1)
    tool_mf = shard["reg"]["latents_flip"].transpose(0, 2, 3, 1)
    diff = max(float(np.abs(tool_m - mine).max()), float(np.abs(tool_mf - mine_f).max()))
    gate(repeat and diff == 0.0, f"prefetch_reg moments: max |tool - G.encode| {diff:.3e}, "
                                 f"repeat bit-identical {repeat}")
    print(f"[tools] prefetch_reg moments vs G.encode at the same split: max |diff| {diff:.3e} "
          f"(gate: 0); in-process repeat bit-identical {repeat}; mean||std channels "
          f"{tool_m.shape[-1]}, std min {float(tool_m[..., 32:].min()):.3e}", flush=True)

    z_all = shard["lat"]["latents"].transpose(0, 2, 3, 1)
    with torch.no_grad():
        dec = [G.decode(torch.from_numpy(np.ascontiguousarray(z_all[a:b])).to(dev))
               for a, b in splits]
    names = sorted(os.listdir(out["dec"]))
    gate(names == [f"00_{i:08d}.png" for i in range(TOOLS_IMAGES)],
         f"decode wrote {len(names)} files (latents_stats skipped?)")
    pngs = np.stack([np.array(PIL.Image.open(os.path.join(out["dec"], n))) for n in names])
    mine_u8 = np.concatenate([to_uint8(x.float().cpu().numpy()) for x in dec])
    step = int(np.abs(pngs.astype(int) - mine_u8.astype(int)).max())
    tail_step = int(np.abs(pngs[-8:].astype(int) - mine_u8[-8:].astype(int)).max())
    gate(step <= 1, f"decode PNGs vs G.decode: {step} uint8 steps")
    z_tail = torch.from_numpy(np.ascontiguousarray(z_all[-8:])).to(dev)
    x_k = dec[-1]
    G.use_plain_kernels(True)
    x_p = G.decode(z_tail)
    G.use_plain_kernels(False)
    G32, _ = build_generator(config, snapshot, dev, "float32")
    G32.use_plain_kernels(True)
    x_32 = G32.decode(z_tail)
    # The fp32 tower's moments of the tail's crops: (4)'s reference for the
    # int8 tail.
    with torch.no_grad():
        m_32_tail = G32.encode(x_all[-8:], return_z_before_quantize=True)
    del G32
    torch.cuda.empty_cache()
    dec_kp, dec_k32, dec_p32 = rel_l1(x_k, x_p), rel_l1(x_k, x_32), rel_l1(x_p, x_32)
    gate(dec_kp <= DECODE_REL_L1 and dec_k32 <= TRUTH_FACTOR * dec_p32 + 1e-6,
         f"tail decode: kernel vs plain {dec_kp:.3e}, vs fp32 {dec_k32:.3e} (plain {dec_p32:.3e})")
    print(f"[tools] decode_latents PNGs vs G.decode at the same split: max {step} uint8 steps "
          f"(B=8 tail {tail_step}; gate 1); B=8 tail kernel vs plain rel-L1 {dec_kp:.3e} (tol "
          f"{DECODE_REL_L1:g}), vs fp32 kernel {dec_k32:.3e} plain {dec_p32:.3e} (kernel <= "
          f"{TRUTH_FACTOR} x plain)", flush=True)

    # ---- (4) the int8 prefetch replayed outside the tool, (5) its launches
    with serving_env(True), torch.no_grad():
        enable_int8_tower(G, x_all[: TOOLS_BATCH])
        sites = kernel_sites(G, 256)
        gen = torch.Generator(device=dev).manual_seed(0)
        z8, z8f = [], []
        for a, b in splits:
            x = x_all[a:b]
            z8.append(G.ldm_adapter.encode(G.vfm_encoder.encode_image(x), gen).float().cpu().numpy())
            z8f.append(G.encode(torch.flip(x, [2]), gen).float().cpu().numpy())
        # The B=8 tail at the int8 serving phase's tolerance: every K6 and
        # K4 site against its twin on that site's own inputs, and the kernel
        # path no further from the fp32 tower than the all-plain int8 path.
        x_tail = x_all[-8:]
        with site_checks() as chk:
            m8_k = G.encode(x_tail, return_z_before_quantize=True)
        G.use_plain_kernels(True)
        m8_p = G.encode(x_tail, return_z_before_quantize=True)
        G.use_plain_kernels(False)
        torch.cuda.synchronize()
    n6 = sum(s["count"] for s in sites["int8_matmul"])
    n4 = sum(s["count"] for s in sites["flash_attention_nonull"]
             if s["at"] in ("tower", "adapter"))
    bad = chk.failures()
    gate(not bad and len(chk.k6) == n6 and len(chk.k4) == n4,
         f"int8 B=8 tail sites vs twins: {len(chk.k6)} K6 of {n6}, {len(chk.k4)} K4 of {n4}, "
         f"failures {bad}")
    tail_k32, tail_p32 = rel_l1(m8_k, m_32_tail), rel_l1(m8_p, m_32_tail)
    gate(tail_k32 <= TRUTH_FACTOR * tail_p32 + 1e-6,
         f"int8 B=8 tail moments vs fp32: kernel {tail_k32:.3e}, plain {tail_p32:.3e}")
    k4_bf = [r for r in chk.k4 if r[0] == torch.bfloat16]
    k4_32 = [r for r in chk.k4 if r[0] != torch.bfloat16]
    print(f"[tools] int8 B=8 tail, every site vs its twin on the same inputs: {len(chk.k6)} K6, "
          f"max {max((r[2] for r in chk.k6), default=0):g} ulps (gate: bit for bit); "
          f"{len(k4_bf)} K4 bf16 max_rel {max((r[2] for r in k4_bf), default=0):.3e} mean_rel "
          f"{max((r[3] for r in k4_bf), default=0):.3e} (tol "
          f"{TOLERANCES['flash_attention_nullkv']}); {len(k4_32)} K4 fp32 max_rel "
          f"{max((r[2] for r in k4_32), default=0):.3e} (tol {FLASH_FP32_MAX_REL:g}); moments "
          f"rel-L1 vs the fp32 tower: kernel {tail_k32:.3e}, plain int8 {tail_p32:.3e} (limit "
          f"{TRUTH_FACTOR} x plain); kernel vs plain {rel_l1(m8_k, m8_p):.3e} (reported)",
          flush=True)
    z8, z8f = np.concatenate(z8), np.concatenate(z8f)
    t8 = shard["lat8"]["latents"].transpose(0, 2, 3, 1)
    t8f = shard["lat8"]["latents_flip"].transpose(0, 2, 3, 1)
    d8 = max(float(np.abs(t8 - z8).max()), float(np.abs(t8f - z8f).max()))
    d8_tail = max(float(np.abs(t8[-8:] - z8[-8:]).max()), float(np.abs(t8f[-8:] - z8f[-8:]).max()))
    gate(d8 == 0.0, f"int8 prefetch vs the replay: max |diff| {d8:.3e} (tail {d8_tail:.3e})")
    print(f"[tools] int8 prefetch vs a replay outside the tool (same calibration batch, same "
          f"draws; B=32, 32 and the B=8 tail): max |diff| {d8:.3e}, tail {d8_tail:.3e} (gate: 0); "
          f"int8 vs bf16 latents rel-L1 {np.abs(t8 - z_all).mean() / np.abs(z_all).mean():.3e}",
          flush=True)
    del G
    torch.cuda.empty_cache()

    k6 = n6
    k4 = {at: sum(s["count"] for s in sites["flash_attention_nonull"] if s["at"] == at)
          for at in ("tower", "adapter")}
    tower_8 = calls_8.of("VFMEncoder.encode_image")
    adapter_8 = calls_8.of("LDMAdapter.encode")
    gate(k6 == 144 and k4["tower"] > 0 and k4["adapter"] > 0, f"int8 sites: K6 {k6}, K4 {k4}")
    gate(len(tower_8) == 1 + 2 * len(splits) and len(adapter_8) == 2 * len(splits),
         f"int8 prefetch: {len(tower_8)} tower and {len(adapter_8)} adapter calls")
    gate(all(c == {"int8_matmul": k6, "flash_attention_nonull": k4["tower"]} for c in tower_8),
         f"int8 prefetch tower calls: {tower_8}")
    gate(all(c == {"flash_attention_nonull": k4["adapter"]} for c in adapter_8),
         f"int8 prefetch adapter calls: {adapter_8}")
    per_decode = {k: v for k, v in PER_DECODE.items()}
    for label, calls in (("decode_latents", calls_dec), ("reconstruct", calls_rec)):
        decs = calls.of("Generator.decode")
        gate(len(decs) == len(splits) and all(c == per_decode for c in decs),
             f"{label}: decode calls {decs}")
    for label, calls in (("prefetch", calls_lat), ("prefetch_reg", calls_reg),
                         ("reconstruct", calls_rec)):
        enc = [c for n, c in calls.calls if n != "Generator.decode"]
        gate(not any(enc), f"{label}: the bf16 encode launched {enc}")
    print(f"[tools] launches: int8 prefetch per tower call {tower_8[2]} (calibration call "
          f"{tower_8[0]}), per adapter encode {adapter_8[1]}, active batch (the second) "
          f"{tower_8[3:5] + adapter_8[2:4]}; per decode {calls_dec.of('Generator.decode')[1]} "
          f"(decode_latents), {calls_rec.of('Generator.decode')[1]} (reconstruct); totals "
          f"{ {p: {k: v for k, v in c.items() if v} for p, c in launches.items()} }", flush=True)

    # ---- (6) the metrics
    results = {"evaluate": ev["results"], "fidelity": fi["results"], "evaluate_npz": en["results"]}
    flat = {f"{t}.{k}": v for t, r in results.items() for k, v in r.items()}
    gate(all(math.isfinite(v) for v in flat.values()), f"metrics not finite: {flat}")
    gate(set(ev["results"]) == {"psnr", "ssim", "lpips"}, f"evaluate keys {sorted(ev['results'])}")
    gate(set(fi["results"]) == {"rfid", "is_mean", "is_std"}, f"fidelity keys {sorted(fi['results'])}")
    gate(abs(ev_same["results"]["psnr"] - 120.0) < 1e-3, f"PSNR of identical folders "
                                                         f"{ev_same['results']['psnr']}")
    gate(en["results"]["n_samples"] == en["results"]["n_ref"] == TOOLS_IMAGES,
         f"evaluate_npz counted {en['results']['n_samples']}, {en['results']['n_ref']}")
    card_model, detect = make_detector(None, dev, "chip_smoke")
    cpu_model = InceptionV3Features()
    probe = crops[:8]
    with torch.no_grad():
        got = detect(probe)
        want = cpu_model(torch.from_numpy(probe).float() / 255.0)
    inc = {n: rel_l1(g.cpu(), w) for n, g, w in zip(("pool", "logits", "sfid"), got, want)}
    gate(all(v <= INCEPTION_CARD_REL for v in inc.values()), f"InceptionV3 card vs CPU {inc}")
    stats = FeatureStats(capture_mean_cov=True)
    for a, b in splits:
        stats.append(detect(crops[a:b])[0].cpu().numpy())
    sigma = stats.get_mean_cov()[1]
    self_fid = en["results"]["fid"]
    gate(abs(self_fid) <= FID_SELF_REL * np.trace(sigma),
         f"FID(x, x) {self_fid:.3e} with tr(Sigma) {np.trace(sigma):.3e}")
    gate(en["results"]["precision"] == en["results"]["recall"] == 1.0,
         f"precision and recall of a set against itself: {en['results']}")
    del card_model, detect
    torch.cuda.empty_cache()
    print(f"[tools] metrics (random-weight InceptionV3 and LPIPS: plumbing, not published "
          f"figures): {', '.join(f'{k} {v:.6g}' for k, v in flat.items())}; PSNR of identical "
          f"folders {ev_same['results']['psnr']:.4f} dB; InceptionV3 card vs CPU rel-L1 "
          + ", ".join(f"{k} {v:.3e}" for k, v in inc.items())
          + f" (tol {INCEPTION_CARD_REL:g}); evaluate_npz's FID(x, x) {self_fid:.3e}, "
          f"tr(Sigma) {np.trace(sigma):.4g} (tol {FID_SELF_REL:g} of it), precision and recall "
          f"of the set against itself {en['results']['precision']:g}, "
          f"{en['results']['recall']:g}; scipy {scipy.__version__}", flush=True)
    if fails:
        raise SystemExit("chip_smoke: tools: " + "; ".join(fails))
    print(f"[tools] phase {time.perf_counter() - t_phase:.1f} s on {card} (the tools "
          f"{t_tools:.1f} s, the gates the rest)", flush=True)
    return launches


# ------------------------------------------------------------------ slice 15

DIT_YAMLS = {"lightningdit": "tools/preprocess_for_lightningdit/train_lightningdit_xl_1_stage_0.yaml",
             "reg": "tools/preprocess_for_reg/train_reg_sit_xl_1.yaml"}
DIT_BATCH = 32  # global_batch_size (the YAMLs: 1024 and 256)
DIT_STEPS = 4  # the YAMLs: 600 k and 400 k
DIT_CKPT = 3
DIT_SAMPLES, DIT_SAMPLE_BATCH, DIT_SAMPLE_STEPS = 16, 8, 50
REG_SAMPLES = 8
# One flow-matching step of a copy at XL width and depth 2 on the card (fp32,
# TF32 off) against float64 on the CPU, the same weights, batch and draws:
# the loss and every parameter's gradient norm, relative. fp32's rounding
# of sums over 4 x 256 tokens of width 1152 to 4608 is about 1e-6 of them.
DIT_FP64_LOSS_REL = 1e-5
DIT_FP64_GRAD_REL = 1e-4
# CKNNA(x, x) = HSIC / (HSIC + 1e-6) (the metric's own 1e-6 in its
# denominator): within CKNNA_FORM_TOL of that for every set, and within
# CKNNA_SELF_TOL of 1 for the DiT block's features (masked HSIC far above 1).
CKNNA_SELF_TOL = 1e-5
CKNNA_FORM_TOL = 1e-6


def cknna_self_form(path: str, topk: int = 10) -> tuple:
    """(masked unbiased HSIC of a feature file against itself, HSIC / (HSIC + 1e-6))."""
    import numpy as np
    import torch

    from vfm_vae_tpu_torch.metrics import cknna

    f = torch.from_numpy(np.load(path)["features"].astype(np.float32))
    K = f @ f.T
    m = cknna._topk_mask(K, topk, True)
    h = cknna.hsic_unbiased(m * K, m * K)
    return float(h), float(h / (torch.sqrt(h * h) + 1e-6))


class dit_steps:
    """Wraps DiTTrainer.step while a trainer CLI runs: each step timed
    between two synchronizes, every parameter's gradient norm recorded, the
    kernel launches counted, and the parameters and the EMA before the first
    step kept on the host."""

    def __enter__(self):
        import torch

        from vfm_vae_tpu_torch.ops import kernels
        from vfm_vae_tpu_torch.tools._dit import DiTTrainer

        self.orig = DiTTrainer.step
        self.ms, self.grads, self.before, self.ema0, self.launches = [], [], None, None, {}
        probe, orig = self, self.orig

        def step(tr, *args, **kwargs):
            if probe.before is None:
                probe.before = host_copy(dict(tr.net.named_parameters()))
                probe.ema0 = host_copy(tr.ema)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            c0 = kernels.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(tr, *args, **kwargs)
            torch.cuda.synchronize()
            probe.ms.append((time.perf_counter() - t0) * 1e3)
            c1 = kernels.launch_counts()
            for k in c1:
                probe.launches[k] = probe.launches.get(k, 0) + c1[k] - c0[k]
            # The step leaves each gradient in place until the next zero_grad.
            probe.grads.append({n: float(p.grad.norm()) if p.grad is not None else 0.0
                                for n, p in tr.net.named_parameters()})
            return out

        DiTTrainer.step = step
        return self

    def __exit__(self, *exc):
        from vfm_vae_tpu_torch.tools._dit import DiTTrainer

        DiTTrainer.step = self.orig


def dit_train_gates(name: str, res: dict, probe: dit_steps, card: str, tokens: int) -> list:
    """The trainer's gates: finite losses, every parameter with a nonzero
    gradient in some step and moved by the end, the EMA moved, the last
    snapshot equal to the trainer's state bit for bit, no kernel launched."""
    import torch

    from vfm_vae_tpu_torch.train.checkpoint import load_snapshot

    fails = []
    tr = res["trainer"]
    losses = res["losses"]
    if len(losses) != DIT_STEPS or not all(math.isfinite(v) for v in losses):
        fails.append(f"losses {losses}")
    params = host_copy(dict(tr.net.named_parameters()))
    no_grad = [n for n in params if not any(g.get(n, 0.0) > 0.0 for g in probe.grads)]
    still = [n for n in params if torch.equal(params[n], probe.before[n])]
    # The EMA of a norm weight (it starts at 1.0) rounds back to 1.0 in fp32
    # until the weight has moved by about 6e-4 (0.9999 e + 0.0001 p): more
    # than a few AdamW steps at lr 1e-4 move it. Every other EMA must move.
    ema_still = [n for n in params if torch.equal(tr.ema[n].cpu(), probe.ema0[n])]
    ones = [n for n in ema_still if n.endswith("norm.weight")
            and bool((probe.ema0[n] == 1.0).all())]
    if no_grad or still or len(ema_still) > len(ones):
        fails.append(f"no gradient in any step {no_grad[:4]} ({len(no_grad)}), not moved "
                     f"{still[:4]} ({len(still)}), EMA not moved {ema_still[:4]} ({len(ema_still)})")
    first_zero = sum(probe.grads[0][n] == 0.0 for n in params)
    snaps = res["snapshots"]
    want = tr.snapshot_state()

    def flat(t, p=""):
        if not isinstance(t, dict):
            return {p[:-1]: t}
        return {k: v for kk, vv in t.items() for k, v in flat(vv, f"{p}{kk}.").items()}

    if len(snaps) != 1:
        fails.append(f"snapshots {snaps}")
    else:
        got, ref = flat(load_snapshot(snaps[0])), flat(want)
        off = [k for k in ref if k not in got or not torch.equal(got[k], ref[k].cpu())]
        if off or set(got) != set(ref):
            fails.append(f"snapshot differs from the trainer: {off[:4]}")
    launched = {k: v for k, v in probe.launches.items() if v}
    if launched:
        fails.append(f"the DiT launched {launched}")
    step_ms = statistics.median(probe.ms[1:])
    n_params = sum(p.numel() for p in tr.net.parameters())
    print(f"[diffusion] {name} train on {card}: {n_params / 1e6:.1f} M parameters, B={DIT_BATCH}, "
          f"{DIT_STEPS} steps, losses {', '.join(f'{v:.5f}' for v in losses)}; step "
          f"{step_ms:.1f} ms (median of steps 1-{DIT_STEPS - 1}; "
          f"{', '.join(f'{v:.1f}' for v in probe.ms)}), {tokens * DIT_BATCH / step_ms * 1e3:.0f} "
          f"tokens/s; peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"(max_memory_allocated); {len(params)} tensors, all with a nonzero gradient in some "
          f"step ({first_zero} zero at step 0: adaLN-zero) and moved; the EMA moved in "
          f"{len(params) - len(ema_still)} (not: {len(ones)} norm weights at 1.0, "
          f"{sorted(set(ema_still) - set(ones))}); snapshot "
          f"{os.path.basename(snaps[0]) if snaps else None} equal to the trainer bit for bit; "
          f"kernel launches {launched or 'none'}", flush=True)
    return fails


def dit_fp64_check(name: str, cfg: dict, z, y, feats, card: str) -> list:
    """One flow-matching step (loss, gradients) of a copy of the YAML's model
    at XL width and depth 2, zero-initialised Linears drawn at 0.02, on the
    card in fp32 and on the CPU in float64, from the same weights, batch and
    draws."""
    import copy

    import torch

    from vfm_vae_tpu_torch.tools._dit import DiTTrainer, build_dit, build_reg

    cfg = copy.deepcopy(cfg)
    if name == "reg":
        cfg["model"]["depth"] = 2
        cfg["model"]["repa_block"] = 1
        model, proj, _, _, w = build_reg(cfg, device="cpu")
        lognorm = False
    else:
        model, *_ = build_dit(cfg, "cpu", depth=2)
        proj, w = None, 0.0
        lognorm = cfg.get("transport", {}).get("use_lognorm", True)
    gen = torch.Generator().manual_seed(15)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if "adaLN" in n or "final_linear" in n:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    B = z.shape[0]
    draws = (torch.randn((B,), generator=gen) if lognorm else torch.rand((B,), generator=gen),
             torch.randn(z.shape, generator=gen), torch.rand((B,), generator=gen) < 0.1)
    out = {}
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
        m = copy.deepcopy(model).to(dev, dt)
        pr = copy.deepcopy(proj).to(dev, dt) if proj is not None else None
        tr = DiTTrainer(m, pr, 1e-4, (0.9, 0.999), 0.0, lognorm, True, w, None)
        loss = tr.loss(z.to(dev, dt), y.to(dev), feats.to(dev, dt) if feats is not None else None,
                       tuple(d.to(dev) if d.dtype == torch.bool else d.to(dev, dt) for d in draws))
        loss.backward()
        out[dt] = (float(loss.detach()), {n: float(p.grad.double().norm())
                                 for n, p in tr.net.named_parameters()})
    (l32, g32), (l64, g64) = out[torch.float32], out[torch.float64]
    loss_rel = abs(l32 - l64) / abs(l64)
    rel = {n: abs(g32[n] - g64[n]) / g64[n] for n in g64 if g64[n] > 0}
    worst = max(rel, key=rel.get)
    zero = [n for n in g64 if g64[n] == 0]
    print(f"[diffusion] {name} step at XL width, depth 2, B={B}: card fp32 vs CPU float64 loss "
          f"{l32:.7f} vs {l64:.7f} (rel {loss_rel:.2e}, tol {DIT_FP64_LOSS_REL:g}); gradient norms "
          f"of {len(rel)} tensors max rel {rel[worst]:.2e} ({worst}), median "
          f"{statistics.median(rel.values()):.2e} (tol {DIT_FP64_GRAD_REL:g}); zero in float64 "
          f"{zero}; on {card}", flush=True)
    fails = []
    if not loss_rel <= DIT_FP64_LOSS_REL or not rel[worst] <= DIT_FP64_GRAD_REL or zero:
        fails.append(f"{name} fp32 vs float64: loss rel {loss_rel:.2e}, gradient norm rel "
                     f"{rel[worst]:.2e} at {worst}, zero {zero}")
    return fails


def first_batch(data_dir: str, moments: bool):
    """The trainer's first batch of 4 from its stream (seed 0), on the host."""
    import numpy as np
    import torch

    from vfm_vae_tpu_torch.tools import lightningdit_train, reg_train

    if moments:
        x, y, f = next(reg_train.moment_batches(data_dir, 4, np.random.default_rng(0)))
        m = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        mean, std = m.chunk(2, -1)
        z = mean + std * torch.randn(mean.shape, generator=torch.Generator().manual_seed(1))
        return z, torch.from_numpy(y), torch.from_numpy(f)
    x, y = next(lightningdit_train.latent_batches(data_dir, 4, np.random.default_rng(0)))
    st = np.load(os.path.join(data_dir, "latents_stats.npz"))
    x = (x - st["mean"].transpose(0, 2, 3, 1)) / st["std"].transpose(0, 2, 3, 1)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)), torch.from_numpy(y), None


def run_sampler(tool, argv, card, label):
    """tool.main(argv) on the card with the launches of each Generator.decode."""
    from vfm_vae_tpu_torch.ops import kernels

    c0 = kernels.launch_counts()
    with call_launches() as calls:
        out = tool.main(argv)
    c1 = kernels.launch_counts()
    total = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
    run = out["seconds"] - out["setup_s"]
    print(f"[diffusion] {label} on {card}: {out['images']} images in {out['seconds']:.2f} s end to "
          f"end; setup (build, weights) {out['setup_s']:.2f} s, then {out['images_per_s']:.3f} "
          f"img/s: DiT {out['dit_s']:.3f} s ({out['dit_s'] / run:.1%}), decode "
          f"{out['decode_s']:.3f} s ({out['decode_s'] / run:.1%}) by CUDA events, PNG work "
          f"{out['host_s']:.3f} s (host clock)", flush=True)
    return out, calls, total


def diffusion_phase(card: str, snapshot: str, config: str, tools_root: str, root: str) -> dict:
    """The latent-diffusion stack through its CLIs on the card, at full XL
    width and depth, on the tools phase's latent shards (72 samples with
    vfm_features and latents_stats.npz) and the recipe's last snapshot
    (`config`: stage 3's YAML as the recipe ran it). Cuts, in scale only:
    global_batch_size DIT_BATCH, DIT_STEPS steps, a snapshot every DIT_CKPT,
    DIT_SAMPLES and REG_SAMPLES images at DIT_SAMPLE_STEPS steps.

    (1) lightningdit_train on the stage-0 YAML: dit_train_gates and
    dit_fp64_check. (2) lightningdit_sample (ODE Euler, --cfg 1.5, --batch
    8) of its snapshot through the tokenizer: 16 PNGs of 256 x 256, the
    sampled z equal to an in-process replay bit for bit, K1/K2/K3 at
    38/10/6 a decode and nothing else, the last batch's decode against the
    plain twins (DECODE_REL_L1) and fp32 (TRUTH_FACTOR). (3) prefetch_reg
    --store-vfm-features into this phase's directory, reg_train on the REG
    YAML with repa_weight 0.5 (the same gates), reg_sample (SDE, --cfg 4.0)
    of the REPA snapshot. (4) alignment_extract vae (the 72 stored images,
    named as the latents), dit and reg (projector_0), alignment_metrics of
    the vae features against a DiT block: finite, and a set against itself
    1 within CKNNA_SELF_TOL. Returns the launches by path."""
    import copy
    import glob

    import numpy as np
    import PIL.Image
    import torch
    import yaml

    from vfm_vae_tpu_torch.tools import (
        alignment_extract, alignment_metrics, lightningdit_sample, lightningdit_train,
        prefetch_reg, reg_sample, reg_train)
    from vfm_vae_tpu_torch.tools._dit import build_dit, sample_latents, snapshot_params
    from vfm_vae_tpu_torch.tools._generator import build_generator

    t_phase = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    lat = os.path.join(tools_root, "lat")
    fails, launches = [], {}
    cfgs = {}
    for name, rel in DIT_YAMLS.items():
        with open(os.path.join(HERE, rel)) as f:
            cfgs[name] = yaml.safe_load(f)
    dcfg = cfgs["lightningdit"]
    dcfg["data"]["data_path"] = lat
    rcfg = cfgs["reg"]
    rcfg["data"]["data_path"] = os.path.join(root, "reg")
    rcfg["model"]["repa_weight"] = 0.5
    for name, c in cfgs.items():
        c["train"].update(global_batch_size=DIT_BATCH, ckpt_every=DIT_CKPT, log_every=1,
                          output_dir=os.path.join(root, "runs"))
    paths = {}
    for name, c in cfgs.items():
        paths[name] = os.path.join(root, f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(c, f)
    print(f"[diffusion] overrides of {DIT_YAMLS['lightningdit']}: data_path {lat} (the tools "
          f"phase's 72 latents), global_batch_size {DIT_BATCH}, ckpt_every {DIT_CKPT}, log_every 1, "
          f"output_dir {root}/runs, --max-steps {DIT_STEPS}; of {DIT_YAMLS['reg']}: the same, "
          f"data_path {rcfg['data']['data_path']} (prefetch_reg --store-vfm-features here), "
          f"repa_weight 0.5 (the YAML's documented option)", flush=True)

    # ---- (1) LightningDiT-XL/1
    with dit_steps() as probe:
        res = lightningdit_train.main(["--config", paths["lightningdit"], "--max-steps",
                                       str(DIT_STEPS)])
    fails += dit_train_gates("lightningdit", res, probe, card, 256)
    dit_snap = res["snapshots"][-1] if res["snapshots"] else None
    del res, probe
    torch.cuda.empty_cache()
    z4, y4, _ = first_batch(lat, False)
    fails += dit_fp64_check("lightningdit", dcfg, z4, y4, None, card)
    if fails:
        raise SystemExit("chip_smoke: diffusion: " + "; ".join(fails))

    # ---- (2) the ODE sampler through the tokenizer
    out_png = os.path.join(root, "samples")
    argv = ["--config", paths["lightningdit"], "--dit-snapshot", dit_snap, "--vae-config", config,
            "--vae-snapshot", snapshot, "--out", out_png, "--num", str(DIT_SAMPLES), "--batch",
            str(DIT_SAMPLE_BATCH), "--steps", str(DIT_SAMPLE_STEPS), "--cfg", "1.5"]
    samp, calls, total = run_sampler(lightningdit_sample, argv, card, "lightningdit_sample ODE "
                                     f"{DIT_SAMPLE_STEPS} steps, cfg 1.5")
    launches["lightningdit_sample"] = total
    names = sorted(os.listdir(out_png))
    shapes = {np.array(PIL.Image.open(os.path.join(out_png, n))).shape for n in names}
    if names != [f"{i:06d}.png" for i in range(DIT_SAMPLES)] or shapes != {(256, 256, 3)}:
        fails.append(f"sampler wrote {names[:3]}... ({len(names)}) of shapes {shapes}")
    decs = calls.of("Generator.decode")
    n_dec = DIT_SAMPLES // DIT_SAMPLE_BATCH
    summed = {k: sum(c.get(k, 0) for c in decs) for k in total}
    if len(decs) != n_dec or any(c != PER_DECODE for c in decs) or summed != total:
        fails.append(f"sampler launches: decodes {decs}, total {total}")
    model, size, ch, ncls = build_dit(dcfg, "cuda")
    model.load_state_dict(snapshot_params(dit_snap)[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    replay = []
    for _ in range(n_dec):
        yb = torch.randint(0, ncls, (DIT_SAMPLE_BATCH,), generator=gen, device="cuda")
        replay.append(sample_latents(lambda *a: model(*a), gen, yb,
                                     (DIT_SAMPLE_BATCH, size, size, ch), "ode",
                                     DIT_SAMPLE_STEPS, 1.5).cpu())
    same = torch.equal(torch.cat(replay), samp["latents"])
    if not same:
        fails.append("sampled z differs from the in-process replay")
    del model
    st = np.load(os.path.join(lat, "latents_stats.npz"))
    z_tail = (samp["latents"][-DIT_SAMPLE_BATCH:] * torch.from_numpy(st["std"].transpose(0, 2, 3, 1))
              + torch.from_numpy(st["mean"].transpose(0, 2, 3, 1))).cuda()
    G, _ = build_generator(config, snapshot, torch.device("cuda"))
    with torch.no_grad():
        x_k = G.decode(z_tail)
        G.use_plain_kernels(True)
        x_p = G.decode(z_tail)
    del G
    G32, _ = build_generator(config, snapshot, torch.device("cuda"), "float32")
    G32.use_plain_kernels(True)
    with torch.no_grad():
        x_32 = G32.decode(z_tail)
    del G32
    torch.cuda.empty_cache()
    dec_kp, dec_k32, dec_p32 = rel_l1(x_k, x_p), rel_l1(x_k, x_32), rel_l1(x_p, x_32)
    if not (dec_kp <= DECODE_REL_L1 and dec_k32 <= TRUTH_FACTOR * dec_p32 + 1e-6):
        fails.append(f"sample decode: kernel vs plain {dec_kp:.3e}, vs fp32 {dec_k32:.3e} "
                     f"(plain {dec_p32:.3e})")
    print(f"[diffusion] lightningdit_sample on {card}: {len(names)} PNGs {sorted(shapes)}; z equal "
          f"to an in-process replay (same generator) bit for bit {same}; per decode {decs[0]} "
          f"(gate {PER_DECODE}), the DiT launched {({k: total[k] - summed[k] for k in total})}; "
          f"last batch's decode kernel vs plain rel-L1 {dec_kp:.3e} (tol {DECODE_REL_L1:g}), vs "
          f"fp32 kernel {dec_k32:.3e} plain {dec_p32:.3e} (kernel <= {TRUTH_FACTOR} x plain); "
          f"|z| mean {float(samp['latents'].abs().mean()):.4f}", flush=True)
    if fails:
        raise SystemExit("chip_smoke: diffusion: " + "; ".join(fails))

    # ---- (3) REG: moments with features, REPA training, the SDE sampler
    pre = prefetch_reg.main(["--config", config, "--snapshot", snapshot, "--data",
                             os.path.join(tools_root, "shards"), "--out",
                             rcfg["data"]["data_path"], "--batch", str(TOOLS_BATCH),
                             "--store-vfm-features"])
    print(f"[diffusion] prefetch_reg --store-vfm-features on {card}: {pre['samples']} samples, "
          f"{pre['images_per_s']:.2f} img/s after setup", flush=True)
    with dit_steps() as probe:
        res = reg_train.main(["--config", paths["reg"], "--max-steps", str(DIT_STEPS)])
    fails += dit_train_gates("reg (REPA 0.5)", res, probe, card, 256)
    if res["trainer"].projector is None:
        fails.append("reg_train built no projector at repa_weight 0.5")
    reg_snap = res["snapshots"][-1] if res["snapshots"] else None
    del res, probe
    torch.cuda.empty_cache()
    zr, yr, fr = first_batch(rcfg["data"]["data_path"], True)
    fails += dit_fp64_check("reg", rcfg, zr, yr, fr, card)
    reg_png = os.path.join(root, "reg_samples")
    rs, rcalls, rtotal = run_sampler(reg_sample, [
        "--config", paths["reg"], "--dit-snapshot", reg_snap, "--vae-config", config,
        "--vae-snapshot", snapshot, "--out", reg_png, "--num", str(REG_SAMPLES), "--batch",
        str(REG_SAMPLES), "--steps", str(DIT_SAMPLE_STEPS), "--cfg", "4.0"], card,
        f"reg_sample SDE {DIT_SAMPLE_STEPS} steps, cfg 4.0, on the REPA snapshot's dit part")
    launches["reg_sample"] = rtotal
    rdecs = rcalls.of("Generator.decode")
    if (len(os.listdir(reg_png)) != REG_SAMPLES or len(rdecs) != 1 or rdecs[0] != PER_DECODE
            or not bool(torch.isfinite(rs["latents"]).all())):
        fails.append(f"reg_sample: {len(os.listdir(reg_png))} PNGs, decodes {rdecs}")
    if fails:
        raise SystemExit("chip_smoke: diffusion: " + "; ".join(fails))

    # ---- (4) alignment
    with open(os.path.join(lat, "images", "dataset_rank0.json")) as f:
        records = json.load(f)["labels"]
    imgs = os.path.join(root, "images")
    os.makedirs(imgs)
    for i, (rel, _) in enumerate(records):  # the latents' order
        os.symlink(os.path.join(lat, "images", rel), os.path.join(imgs, f"image_{i:06d}.png"))
    t_al = time.perf_counter()
    vae = alignment_extract.main(["vae", "--config", config, "--snapshot", snapshot, "--images",
                                  imgs, "--out", os.path.join(root, "feats_vae.npz")])
    dit = alignment_extract.main(["dit", "--config", paths["lightningdit"], "--snapshot",
                                  dit_snap, "--latents", lat, "--out",
                                  os.path.join(root, "feats_dit"), "--num", str(TOOLS_IMAGES)])
    reg = alignment_extract.main(["reg", "--config", paths["reg"], "--snapshot", reg_snap,
                                  "--latents", rcfg["data"]["data_path"], "--out",
                                  os.path.join(root, "feats_reg"), "--num", str(TOOLS_IMAGES)])
    block = "block_13"
    want_dit = {"embedder", "final_layer"} | {f"block_{i}" for i in range(28)}
    if set(dit) != want_dit or set(reg) != want_dit | {"projector_0"}:
        fails.append(f"feature taps: dit {sorted(dit)[:4]}..., reg {sorted(reg)[:4]}...")
    shapes = {k: np.load(p)["features"].shape for k, p in (("vae", vae["features"]),
                                                           ("dit", dit[block]),
                                                           ("projector_0", reg["projector_0"]))}
    finite = all(np.isfinite(np.load(p)["features"]).all()
                 for p in [vae["features"], *dit.values(), *reg.values()])
    cross = alignment_metrics.main(["--a", vae["features"], "--b", dit[block]])
    sets = {"vae": vae["features"], f"dit {block}": dit[block], "projector_0": reg["projector_0"]}
    selfs = {k: alignment_metrics.main(["--a", p, "--b", p]) for k, p in sets.items()}
    forms = {k: cknna_self_form(p) for k, p in sets.items()}
    if (not finite or not math.isfinite(cross)
            or any(abs(selfs[k] - forms[k][1]) > CKNNA_FORM_TOL for k in sets)
            or abs(selfs[f"dit {block}"] - 1.0) > CKNNA_SELF_TOL
            or shapes != {"vae": (TOOLS_IMAGES, 32), "dit": (TOOLS_IMAGES, 1152),
                          "projector_0": (TOOLS_IMAGES, 1024)}):
        fails.append(f"alignment: finite {finite}, CKNNA vae vs {block} {cross}, self {selfs}, "
                     f"shapes {shapes}")
    print(f"[diffusion] alignment on {card}: features {shapes}, all finite {finite}; CKNNA "
          f"(topk 10) vae vs dit {block} {cross:.6f}; against itself "
          + ", ".join(f"{k} {v:.8f} (HSIC {forms[k][0]:.4g}, HSIC / (HSIC + 1e-6) "
                      f"{forms[k][1]:.8f})" for k, v in selfs.items())
          + f" (tol {CKNNA_FORM_TOL:g} of the form, and {CKNNA_SELF_TOL:g} of 1 for the DiT "
          f"block); {time.perf_counter() - t_al:.1f} s", flush=True)
    if fails:
        raise SystemExit("chip_smoke: diffusion: " + "; ".join(fails))
    print(f"[diffusion] phase {time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--determinism-trials", type=int, default=1,
                    help="batches of the deterministic kernel/plain/fp32 step (default 1)")
    args = ap.parse_args()
    t_start = time.perf_counter()
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
    # K7 and K8: ten instances (k, statistics, tile geometry), none spilling.
    dw_build = dwconv_resources(str(lib.path))
    for name, (regs, stack, local) in sorted(dw_build.items()):
        print(f"[build] {name}: {regs} registers, {stack} bytes stack frame, {local} bytes "
              f"local memory", flush=True)
    if len(dw_build) != 10 or any(v[1:] != (0, 0) for v in dw_build.values()):
        raise SystemExit(f"chip_smoke: a dwconv instance spills or is missing: {dw_build}")

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
    k4_sites = enc["flash_attention_nonull"] + [POST_QUANT_SITE]
    summary.update(kernel_flash_phase(k4_sites))
    for name, per_site in flash_batch_phase(sites["flash_attention_nullkv"], k4_sites).items():
        summary[name]["b32"] = per_site
    bwd_b32 = flash_bwd_batch_phase(sites["flash_attention_nullkv"], enc["flash_attention_nonull"])
    k4b, k4_fb = k4_backward_phase(k4_sites)
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
    launches["towers"], towers = towers_phase(G, card)
    summary["int8_matmul"]["towers"] = towers
    dec_launches, dec_summary = decoders_phase(G, card)
    launches.update(dec_launches)
    summary.update(dec_summary)
    del G
    torch.cuda.empty_cache()
    tr, state, real, launches["train_step"] = train_phase(card)
    determinism_phase(tr, state, real, args.determinism_trials)
    state, launches["all_switches_train_step"] = all_switches_train(tr, state, card)
    del tr, state, real
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="vfm_recipe_")
    try:
        launches["recipe"], snapshot, stage3_yaml = recipe_phase(card, tmp)
        launches["batch"] = batch_phase(card, os.path.join(tmp, "batch"))
        launches.update(discrete_phase(card, os.path.join(tmp, "discrete")))
        launches.update(tools_phase(card, snapshot, stage3_yaml, os.path.join(tmp, "tools")))
        launches.update(diffusion_phase(card, snapshot, stage3_yaml, os.path.join(tmp, "tools"),
                                        os.path.join(tmp, "diffusion")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    entries = []
    for name, s in summary.items():
        by_path = {path: counts.get(name, 0) for path, counts in launches.items()}
        entries.append(dict(name=name, route="cuda", source=SOURCES[name][0],
                            replaces=SOURCES[name][1], launches=sum(by_path.values()),
                            launches_by_path=by_path, **s))
    print(f"[smoke] every phase passed in {time.perf_counter() - t_start:.1f} s on {card}",
          flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

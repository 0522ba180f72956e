#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vfm_vae_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from vfm_vae_tpu_torch/csrc/ into
   vfm_vae_tpu_torch/csrc/build/ and prints the build time.
2. Builds the flagship f16d32 SigLIP2-L tokenizer on the card (bf16, random
   weights from a torch.Generator seeded 0).
3. Kernel phases: each kernel (K1 fused ConvNeXt MLP, K2 fused upsample +
   blur, K3 null-KV flash attention) runs against its plain PyTorch twin at
   every shape one flagship decode gives it (B=2, bf16, O(1) random inputs)
   and against an fp32 evaluation of the same function; prints the errors
   and both times and fails past the tolerances below.
4. Slice phase: answers three encode -> decode requests of B=4 random
   256x256 images through the kernels, checks shapes, finiteness and the
   launch counts per decode, reruns one request with the plain twins
   selected and once more in fp32, prints the latent and pixel agreement,
   and prints the round trip's images/s at two batch sizes.

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
}
PER_DECODE = {"fused_convnext_mlp": 38, "fused_upsample_blur": 10, "flash_attention_nullkv": 6}


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


def kernel_phase(sites: dict, B: int = 2) -> dict:
    """Kernel vs twin (and vs fp32) at every main-path site."""
    import torch

    from vfm_vae_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    summary, failed = {}, []
    for fn in kernels.WRAPPERS:
        name = fn.__name__
        tol_max, tol_mean = TOLERANCES[name]
        worst_abs = worst_max = worst_mean = 0.0
        ms_total = plain_total = 0.0
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
            ms = cuda_time_ms(lambda: fn(**args))
            plain_ms = cuda_time_ms(lambda: fn(**args, plain=True))
            ok = (finite and max_rel <= tol_max and mean_rel <= tol_mean
                  and k_truth <= TRUTH_FACTOR * p_truth + 1e-6)
            print(f"[kernel] {name} {site_label(site)} B={B}: max_abs={max_abs:.3e} "
                  f"max_rel={max_rel:.3e} (tol {tol_max:g}) mean_rel={mean_rel:.3e} "
                  f"(tol {tol_mean:g}) vs_fp32 kernel={k_truth:.3e} plain={p_truth:.3e} "
                  f"finite={finite} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"x{site['count']}/decode {'OK' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append(f"{name} {site_label(site)}")
            worst_abs = max(worst_abs, max_abs)
            worst_max, worst_mean = max(worst_max, max_rel), max(worst_mean, mean_rel)
            ms_total += ms * site["count"]
            plain_total += plain_ms * site["count"]
        summary[name] = dict(max_abs_err=worst_abs, ms=ms_total, plain_ms=plain_total)
        print(f"[kernel] {name}: all sites of one decode at B={B}: kernel {ms_total:.4f} ms, "
              f"plain {plain_total:.4f} ms", flush=True)
    if failed:
        raise SystemExit(f"chip_smoke: kernel phase FAILED at {failed}")
    return summary


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
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        G.decode(G.encode(img))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if busy_ms == 0:
        print("[profile] no device time recorded: device breakdown not measured", flush=True)
        return
    print(f"[profile] round trip B={img.shape[0]}: wall {wall_ms:.1f} ms (profiler on), device "
          f"busy {busy_ms:.1f} ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"[profile] {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{e.count:<4d} {e.key[:100]}",
              flush=True)


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
    launches = slice_phase(G, card)

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCES[name][0], replaces=SOURCES[name][1],
             launches=launches[name], max_abs_err=s["max_abs_err"], ms=s["ms"],
             plain_ms=s["plain_ms"])
        for name, s in summary.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

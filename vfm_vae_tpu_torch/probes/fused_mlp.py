"""What bounds the fused ConvNeXt MLP (K1, K9) on the card: ablations. Run
on a machine with the CUDA toolkit and a card:

    python -m vfm_vae_tpu_torch.probes.fused_mlp

Builds csrc/fused_mlp.cu as it is and in variants, each with one part of the
plan or the kernel changed by a textual edit of a copy of the source: the
hidden never split across a cluster; each CTA walking one hidden chunk
(another function: the fixed cost of a CTA); the weight ring at its least depth
(2 C / 64 sub-tiles, 9 and 5 at C = 256 and 128 to hold the partial); the bf16 hidden through shared memory at C <= 256 (as
at C = 512) instead of registers; erff instead of the tanh-form GELU (the
TPU kernel's vfm_vae_tpu/ops/pallas/fused_mlp.py:_gelu_poly, refit); no GELU at
all (computes another function; timed only, for the GELU's share); "as
built" timed again last. Only the distributed-shared-memory reduction of the
split is built (no workspace route), so there is no reduction ablation.

Times every variant at the flagship decode's K1 sites (C=512 at 8, 16, 32
and 64 px, C=256 at 128 px, C=128 at 256 px) at B=2, 4 and 32 (CUDA events
around 30 back-to-back ctypes calls, the best of three windows), beside the
bound (`work`: products, bytes and the GELU on the CUDA cores) and the
cuBLAS composition (two cuBLAS bf16 GEMMs and PyTorch's elementwise steps,
which round and store the hidden: not the same function, a yardstick); K1
and K9 as built in turns (K1, K9, K9, K1). At B=2 each variant's output is
compared with the twin. Prints the card's name and power limit first, and
the GELU's SASS instruction count of every variant that builds.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

from vfm_vae_tpu_torch.ops.kernels._build import CSRC, NVCC_FLAGS, _nvcc

SOURCE = "fused_mlp.cu"
SPLIT_LOOP = ("  while (p.split * 2 <= kMaxSplit && p.split * 2 <= nch && 2LL * p.tiles * p.split"
              " <= sms)\n    p.split *= 2;\n")
PLAN_STAGES = "  p.stages = (kSmemMax - fixed) / (kSub + 16);"
# name -> [(file, text, replacement)]
ABLATIONS = {
    "as built": [],
    "split forced to 1": [(SOURCE, SPLIT_LOOP, "")],
    "one chunk a CTA (another function)": [
        (SOURCE, "  const int j0 = rank * args.chunks, j1 = j0 + args.chunks;",
         "  const int j0 = rank * args.chunks, j1 = j0 + 1;")],
    # The least ring that K1 and K9 can walk (2 C / 64 sub-tiles) and that
    # leaves room for the epilogue's fp32 partial: 16, 9 and 5 stages.
    "ring at its least depth": [(SOURCE, PLAN_STAGES, "  p.stages = C / 32 + (C < 512);")],
    "hidden through shared memory": [(SOURCE, "constexpr bool kHiddenInSmem = false;",
                                      "constexpr bool kHiddenInSmem = true;")],
    "erff GELU": [(SOURCE, "constexpr bool kPolyGelu = true;",
                   "constexpr bool kPolyGelu = false;")],
    "no GELU (another function)": [(SOURCE, "  return kPolyGelu ? gelu_poly(v) : gelu_erf(v);",
                                    "  return v;")],
    "as built, again": [],
}
# (C, H, launches per decode) of the flagship decode's K1 sites.
SITES = [(512, 8, 7), (512, 16, 7), (512, 32, 7), (512, 64, 7), (256, 128, 5), (128, 256, 5)]
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
P, I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [P] * 10 + [I, I, I, P]


def gelu_instructions(lib_path: str) -> int:
    """SASS instructions of one hidden activation (GELU(acc * d + b1)) in
    the library at `lib_path`: vfm_gelu_count_kernel minus
    vfm_fma_count_kernel (the same kernel with the FMA alone), plus one."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")

    def count(fn: str) -> int:
        out = subprocess.run([tool, "-sass", "-fun", fn, lib_path], capture_output=True,
                             text=True, check=True).stdout
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", out)
        return len(ops[:ops.index("EXIT") + 1]) if "EXIT" in ops else len(ops)

    return count("vfm_gelu_count_kernel") - count("vfm_fma_count_kernel") + 1


def bound_terms(C: int, B: int, HW: int, gelu_instr: int):
    """ms of the three terms of one call's bound on B x HW tokens: 2 x 2 T C
    4C products at the bf16 peak; x, x_in and out, W1 and W2, A, d, b1, b2
    and gamma once at 3.35 TB/s; T 4C GELU evaluations of `gelu_instr` SASS
    instructions over 132 x 128 lanes at the fp32 peak's clock (67 TFLOP/s =
    2 x 132 x 128 x 1.98 GHz)."""
    T = B * HW
    ops = 4 * T * C * 4 * C
    byts = 3 * T * C * 2 + 2 * 4 * C * C * 2 + B * 9 * C * 4 + 2 * C * 4
    return (ops / PEAK_BF16_FLOPS * 1e3, byts / PEAK_BYTES_PER_S * 1e3,
            T * 4 * C * gelu_instr / (PEAK_FP32_FLOPS / 2) * 1e3)


def cublas_composition(x, x_in, A, d, w1, b1, w2, b2, gamma):
    """A yardstick, never called by the port: the MLP as two cuBLAS bf16
    GEMMs and PyTorch's elementwise steps (the hidden is rounded and stored
    in bf16 between them, so it is not the same function bit for bit)."""
    import torch.nn.functional as F

    B, H, W, C = x.shape
    xs = (x * A[:, None, None, :]).to(x.dtype).reshape(B, H * W, C)
    h = F.gelu(xs @ w1.t() * d[:, None, :] + b1[:, None, :]).to(x.dtype)
    y = (h @ w2.t()).float()
    return ((y + b2) * gamma + x_in.reshape(B, H * W, C)).to(x.dtype)


def build_variants(tmp: str) -> dict:
    """{name: (ctypes library, path) or the reason it is missing}, built in parallel."""
    procs, libs = {}, {}
    for i, (name, edits) in enumerate(ABLATIONS.items()):
        d = os.path.join(tmp, f"v{i}")
        shutil.copytree(CSRC, d, ignore=shutil.ignore_patterns("build"))
        missing = []
        for fname, text, repl in edits:
            path = os.path.join(d, fname)
            src = open(path).read()
            if text not in src:
                missing.append(text[:40])
            open(path, "w").write(src.replace(text, repl))
        if missing:
            libs[name] = f"not applicable (source changed: {missing})"
            continue
        procs[name] = (d, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-o", os.path.join(d, "lib.so"),
             os.path.join(d, SOURCE)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (d, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            libs[name] = "build failed: " + log[-300:]
            continue
        path = os.path.join(d, "lib.so")
        lib = ctypes.CDLL(path)
        for fn in (lib.vfm_fused_convnext_mlp, lib.vfm_fused_convnext_mlp_pipelined):
            fn.argtypes = ARGTYPES
            fn.restype = ctypes.c_int
        libs[name] = (lib, path)
    return libs


def launches_ms(fn, reps: int = 30) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(3):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def main() -> int:
    import torch

    from vfm_vae_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        raise SystemExit("fused_mlp probe: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        gelu = {}
        for name, lib in libs.items():
            if isinstance(lib, str):
                print(f"[variant] {name}: {lib}", flush=True)
                continue
            gelu[name] = gelu_instructions(lib[1])
            print(f"[variant] {name}: GELU {gelu[name]} SASS instructions", flush=True)
        g_built = gelu["as built"]
        for B in (2, 4, 32):
            for C, H, count in SITES:
                HW = H * H

                def rn(*s, dt=bf, scale=1.0):
                    return (torch.randn(s, generator=gen, device=dev) * scale).to(dt)

                a = dict(x=rn(B, H, H, C), x_in=rn(B, H, H, C),
                         A=torch.rand(B, C, generator=gen, device=dev) + 0.5,
                         d=torch.rand(B, 4 * C, generator=gen, device=dev) + 0.5,
                         w1=rn(4 * C, C, scale=C ** -0.5), b1=rn(B, 4 * C, dt=f32, scale=0.5),
                         w2=rn(C, 4 * C, scale=(4 * C) ** -0.5), b2=rn(C, dt=f32, scale=0.1),
                         gamma=rn(C, dt=f32))
                out = torch.empty_like(a["x"])
                stream = torch.cuda.current_stream().cuda_stream
                call = tuple(a[k].data_ptr() for k in ("x", "x_in", "A", "d", "b1", "w1", "w2",
                                                       "b2", "gamma")) + (out.data_ptr(), B, HW,
                                                                          C, stream)
                ref = kernels.fused_convnext_mlp(**a, plain=True) if B == 2 else None
                comp = launches_ms(lambda: cublas_composition(**a))
                t_ops, t_bytes, t_gelu = bound_terms(C, B, HW, g_built)
                bnd = max(t_ops, t_bytes, t_gelu)
                row = [f"cuBLAS composition {comp:.4f}"]
                for name, lib in libs.items():
                    if isinstance(lib, str):
                        continue
                    fn = lib[0].vfm_fused_convnext_mlp
                    if fn(*call):
                        row.append(f"{name}: launch failed")
                        continue
                    check = ""
                    if ref is not None:
                        torch.cuda.synchronize()
                        diff = (out.float() - ref.float()).abs()
                        check = f", max_rel {float(diff.max()) / float(ref.float().abs().max()):.2e}"
                    ms = launches_ms(lambda: fn(*call))
                    row.append(f"{name} {ms:.4f} ({bnd / ms:.3f} of bound{check})")
                    totals[(B, name)] = totals.get((B, name), 0.0) + ms * count
                lib = libs["as built"][0]
                k1, k9 = (lambda: lib.vfm_fused_convnext_mlp(*call),
                          lambda: lib.vfm_fused_convnext_mlp_pipelined(*call))
                a1, b1_, b2_, a2 = (launches_ms(f) for f in (k1, k9, k9, k1))
                row.append(f"in turns K1 {(a1 + a2) / 2:.4f} K9 {(b1_ + b2_) / 2:.4f}")
                for key, val in (("cuBLAS composition", comp), ("K1 in turns", (a1 + a2) / 2),
                                 ("K9 in turns", (b1_ + b2_) / 2), ("bound", bnd)):
                    totals[(B, key)] = totals.get((B, key), 0.0) + val * count
                p = kernels.fused_mlp.plan(B, HW, C, sms=torch.cuda.get_device_properties(dev)
                                           .multi_processor_count)
                print(f"[ablation] B={B} C={C} H={H} x{count}/decode (split {p['split']}, "
                      f"{p['ctas']} CTAs; bound {bnd:.4f} ms: tensor cores {t_ops:.4f}, bytes "
                      f"{t_bytes:.4f}, GELU {t_gelu:.4f}), ms: " + "; ".join(row), flush=True)
                del a, out, ref
                torch.cuda.empty_cache()
    for B in (2, 4, 32):
        parts = [f"{name} {ms:.4f}" for (b_, name), ms in totals.items() if b_ == B]
        print(f"[total] the 38 K1 sites of one decode at B={B}, ms: " + "; ".join(parts),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

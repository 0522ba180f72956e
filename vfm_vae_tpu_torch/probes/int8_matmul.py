"""What bounds the int8 GEMM (K6, K10) on the card: ablations and host cost.
Run on a machine with the CUDA toolkit and a card:

    python -m vfm_vae_tpu_torch.probes.int8_matmul

Builds csrc/int8_matmul.cu as it is and in variants, each with one part of
the plan or the kernel changed by a textual edit of a copy of the source
(the "no quantize arithmetic" variant computes the wrong function by
construction and is only timed; K6's two other quantize routes: "transform
warps", three warps beside the producer's lane write int8 x stages that the
consumers read as K10 does, and "separate quantize pass", a pass writes int8 x to device
memory first), and times every variant at the tower's
served Linear shapes (M = 1024 B tokens; (K, N) = (1024, 1024), (1024,
4096), (4096, 1024)) at B=32, 4 and 2: K10 (raw) beside torch._int_mm +
`>> 8`, K6 static beside cuBLAS bf16 (x @ w^T), K6 dynamic as built (CUDA
events around 30 back-to-back launches, the best of three windows), with
TOP/s and the fraction of the bound; at B=2 each variant's output is also
compared with the twin (exact or differs). Then the host cost of a call at B=4
(M=4096) and at M=128: wall time per call over 2000 calls with one
synchronize at the end, for the wrapper, its ctypes call alone,
torch.empty and cuBLAS bf16, beside the device time. Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
import time

from vfm_vae_tpu_torch.ops.kernels._build import CSRC, NVCC_FLAGS, _nvcc, library

SOURCE = "int8_matmul.cu"
PLAN_BN = "p.bn = 2LL * m_tiles * cdiv(N, 256) >= sms ? 256 : 128;"
PLAN_STAGES = "p.stages = (kSmemMax - kEpiBytes - kSlack) / (stage + 16);"
A_LOAD = ("          const uint2 v = *reinterpret_cast<const uint2*>(\n"
          "              stage + (c >> 6) * (kBM * 128) + r * 128 + ((((b >> 4) ^ (r & 7)) << 4) "
          "| (b & 15)));")
# name -> [(file, text, replacement)]
ABLATIONS = {
    "as built": [],
    "tile 128x256": [(SOURCE, PLAN_BN, "p.bn = 256;")],
    "tile 128x128": [(SOURCE, PLAN_BN, "p.bn = 128;")],
    "2 stages": [(SOURCE, PLAN_STAGES, "p.stages = 2;")],
    "3 stages": [(SOURCE, PLAN_STAGES, "p.stages = 3;")],
    "one CTA per tile": [(SOURCE, "p.ctas = std::min(p.tiles, sms);", "p.ctas = p.tiles;")],
    "one K step for all lanes (bank conflicts)": [(SOURCE, "  const int odd = r0 & 1;",
                                                   "  const int odd = 0;")],
    "no quantize arithmetic": [(SOURCE, "  return __byte_perm(__byte_perm(q[0], q[1], 0x0040), "
                                "__byte_perm(q[2], q[3], 0x0040), 0x5410);",
                                "  (void)q;\n  return v.x ^ v.y;")],
    "direct-store epilogue": [(SOURCE, "p.direct = mode == kRaw && N % 16 != 0;",
                               "p.direct = mode == kRaw;")],
    # Where K6's time goes beyond K10's: its shared-memory reads of x, the
    # TMA traffic of x as well (the shared-memory traffic of a design that
    # loads x from global memory into registers), and the output stores.
    "no x shared loads": [(SOURCE, A_LOAD, "          const uint2 v = make_uint2(c, r);")],
    "no x shared loads or x TMA": [
        (SOURCE, A_LOAD, "          const uint2 v = make_uint2(c, r);"),
        (SOURCE, "        vfm::mbar_expect_tx(full(s), C::kStage);",
         "        vfm::mbar_expect_tx(full(s), C::kBf16A ? C::kStage - C::kA : C::kStage);"),
        (SOURCE, "          vfm::tma_load_2d(a, &tx, full(s), kt * kBK, m0);\n"
         "          vfm::tma_load_2d(a + kBM * 128, &tx, full(s), kt * kBK + 64, m0);", "")],
    "no output stores": [(SOURCE, "        vfm::tma_store_2d(&tout, buf, col0, mrow);", "")],
    # K6's third quantize route (static only): a pass quantizes x into an
    # int8 buffer that the variant keeps, then the GEMM reads int8 x from
    # the ring as K10 does (SS) and applies K6's epilogue.
    "separate quantize pass": [
        (SOURCE, "  static constexpr bool kBf16A = MODE != kRaw;",
         "  static constexpr bool kBf16A = false;"),
        (SOURCE, "constexpr int a_bytes(int mode) { return kBM * kBK * (mode == kRaw ? 1 : 2); }",
         "constexpr int a_bytes(int mode) { return kBM * kBK + 0 * mode; }"),
        (SOURCE, "template <int MODE, int BN>\ncudaError_t launch(",
         "__global__ void quantize_pass_kernel(const bf16* x, const float* a_s, int8_t* xq,\n"
         "                                     long long n) {\n"
         "  const float inv = __fdiv_rn(1.f, fmaxf(*a_s, 1e-8f));\n"
         "  const uint32_t hi2 = clamp_bound(inv) * 0x10001u, lo2 = hi2 | 0x80008000u;\n"
         "  for (long long i = (blockIdx.x * 256LL + threadIdx.x) * 8; i < n;\n"
         "       i += gridDim.x * 256LL * 8) {\n"
         "    const uint4 v = *reinterpret_cast<const uint4*>(x + i);\n"
         "    *reinterpret_cast<uint2*>(xq + i) =\n"
         "        make_uint2(quant4<kStatic>(make_uint2(v.x, v.y), inv, lo2, hi2),\n"
         "                   quant4<kStatic>(make_uint2(v.z, v.w), inv, lo2, hi2));\n"
         "  }\n"
         "}\n\n"
         "template <int MODE, int BN>\ncudaError_t launch("),
        (SOURCE, "  if ((err = map_2d(&tx, x, es_in, M, K, C::kBf16A ? 64 : 128, kBM)) != "
         "cudaSuccess) return err;",
         "  static int8_t* xq_buf = nullptr;\n"
         "  static size_t xq_cap = 0;\n"
         "  if (MODE != kRaw) {\n"
         "    if ((size_t)M * K > xq_cap) {\n"
         "      cudaFree(xq_buf);\n"
         "      if ((err = cudaMalloc(&xq_buf, (size_t)M * K)) != cudaSuccess) return err;\n"
         "      xq_cap = (size_t)M * K;\n"
         "    }\n"
         "    quantize_pass_kernel<<<1056, 256, 0, stream>>>(static_cast<const bf16*>(x), a_s,\n"
         "                                                   xq_buf, (long long)M * K);\n"
         "    x = xq_buf;\n"
         "  }\n"
         "  if ((err = map_2d(&tx, x, es_in, M, K, C::kBf16A ? 64 : 128, kBM)) != "
         "cudaSuccess) return err;"),
    ],
    # K6's second quantize route: warps 1-3 of the producer's warpgroup turn
    # each bf16 x stage into a swizzled int8 stage (16-byte loads and
    # stores, consecutive threads on consecutive rows: conflict-free), fence
    # the async proxy and arrive on a third barrier; the consumers wait for
    # it and multiply int8 x from shared memory as K10 does (SS). Registers
    # 96 / 200 / 200; a stage holds bf16 x, the weight and int8 x.
    "transform warps": [
        (SOURCE, "constexpr int kProducerRegs = 40;", "constexpr int kProducerRegs = 96;"),
        (SOURCE, "constexpr int kConsumerRegs = 232;", "constexpr int kConsumerRegs = 200;"),
        (SOURCE, "constexpr int stage_bytes(int mode, int bn) { return a_bytes(mode) + bn * kBK; }",
         "constexpr int stage_bytes(int mode, int bn) {\n"
         "  return a_bytes(mode) + bn * kBK + (mode == kRaw ? 0 : kBM * kBK);\n}"),
        (SOURCE, "(stage + 16)", "(stage + 24)"),
        (SOURCE, "      vfm::mbar_init(empty(s), 4 * kConsumers);  // one arrival per consumer warp",
         "      vfm::mbar_init(empty(s), 4 * kConsumers);\n"
         "      vfm::mbar_init(bars + 8u * (2 * stages + s), 96);"),
        (SOURCE, "        vfm::mbar_expect_tx(full(s), C::kStage);",
         "        vfm::mbar_expect_tx(full(s), C::kA + BN * kBK);"),
        (SOURCE, "    vfm::reg_dealloc<kProducerRegs>();\n    if (threadIdx.x != 0) return;",
         "    vfm::reg_dealloc<kProducerRegs>();\n"
         "    if (threadIdx.x >= 32) {\n"
         "      if constexpr (C::kBf16A) {\n"
         "        const int i = threadIdx.x - 32;\n"
         "        float inv = 0.f;\n"
         "        uint32_t lo2 = 0, hi2 = 0;\n"
         "        if constexpr (MODE == kStatic) {\n"
         "          inv = __fdiv_rn(1.f, fmaxf(*a_s, 1e-8f));\n"
         "          hi2 = clamp_bound(inv) * 0x10001u;\n"
         "          lo2 = hi2 | 0x80008000u;\n"
         "        }\n"
         "        int s = 0;\n"
         "        uint32_t ph = 0;\n"
         "        for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {\n"
         "          const int m0 = (tile / n_tn) * kBM;\n"
         "          for (int kt = 0; kt < nk; ++kt) {\n"
         "            vfm::mbar_wait(full(s), ph);\n"
         "            const unsigned char* src = smem + s * C::kStage;\n"
         "            unsigned char* dst = const_cast<unsigned char*>(src) + C::kA + BN * kBK;\n"
         "            for (int id = i; id < kBM * 8; id += 96) {\n"
         "              const int r = id & (kBM - 1), c = id / kBM;\n"
         "              float f = inv;\n"
         "              if constexpr (MODE == kDynamic) f = m0 + r < M ? a_s[m0 + r] : 1.f;\n"
         "              const unsigned char* row = src + (c >> 2) * (kBM * 128) + r * 128;\n"
         "              const int j = 2 * (c & 3);\n"
         "              const uint4 v0 = *reinterpret_cast<const uint4*>(row + ((j ^ (r & 7)) << 4));\n"
         "              const uint4 v1 =\n"
         "                  *reinterpret_cast<const uint4*>(row + (((j + 1) ^ (r & 7)) << 4));\n"
         "              *reinterpret_cast<uint4*>(dst + r * 128 + ((c ^ (r & 7)) << 4)) = make_uint4(\n"
         "                  quant4<MODE>(make_uint2(v0.x, v0.y), f, lo2, hi2),\n"
         "                  quant4<MODE>(make_uint2(v0.z, v0.w), f, lo2, hi2),\n"
         "                  quant4<MODE>(make_uint2(v1.x, v1.y), f, lo2, hi2),\n"
         "                  quant4<MODE>(make_uint2(v1.z, v1.w), f, lo2, hi2));\n"
         "            }\n"
         "            vfm::fence_proxy_async();\n"
         "            vfm::mbar_arrive(bars + 8u * (2 * stages + s));\n"
         "            if (++s == stages) {\n"
         "              s = 0;\n"
         "              ph ^= 1;\n"
         "            }\n"
         "          }\n"
         "        }\n"
         "      }\n"
         "      return;\n"
         "    }\n"
         "    if (threadIdx.x != 0) return;"),
        (SOURCE, "    quantize_stage<MODE>(af[SET], smem + (a - base), r0, t, f0, f1, lo2, hi2);",
         "    vfm::mbar_wait(bars + 8u * (2 * stages + s), ph);"),
        (SOURCE, "      wgmma_rs(acc, af[SET][kk], db, kt > 0 || kk > 0);",
         "      wgmma_ss(acc, vfm::sw128_desc(b + BN * kBK + wg * 64 * 128 + 32 * kk, 16, 1024), db,\n"
         "               kt > 0 || kk > 0);"),
    ],
    # The first variant timed at a shape reads slow (the card's clocks):
    # "as built" again, last.
    "as built, again": [],
}
# (K, N) of the tower's Linears and their count per encode.
SHAPES = [(1024, 1024, 96), (1024, 4096, 24), (4096, 1024, 24)]
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12


def build_variants(tmp: str) -> dict:
    """{name: ctypes library or the reason it is missing}, built in parallel."""
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
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.vfm_int8_matmul.argtypes = [P, P, P, P, P, P, I, I, I, I, P]
        libs[name] = lib
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


def host_us(fn, n: int = 2000) -> float:
    """Wall time per call over n calls and one synchronize: the host's cost
    where the device work of a call is shorter."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def bound_ms(M: int, K: int, N: int, raw: bool):
    """(ms, what bounds it): 2 M N K int8 operations; x (bf16, raw int8), the
    weight, ws and b read once, out (bf16, raw int8) written once."""
    byts = M * K + N * K + M * N if raw else 2 * M * K + N * K + 8 * N + 2 * M * N
    a, b = 2 * M * N * K / PEAK_INT8_OPS * 1e3, byts / PEAK_BYTES_PER_S * 1e3
    return max(a, b), ("operations" if a >= b else "bytes")


def main() -> int:
    import torch

    from vfm_vae_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        raise SystemExit("int8_matmul probe: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        for B in (32, 4, 2):
            for K, N, count in SHAPES:
                M = 1024 * B
                x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                xq = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
                wq = torch.randint(-127, 128, (N, K), generator=gen, device=dev, dtype=torch.int8)
                ws = torch.rand(N, generator=gen, device=dev) * 2e-4 + 1e-4
                b = torch.randn(N, generator=gen, device=dev) * 0.1
                a_s = (x.float().abs().amax() / 127).reshape(())
                w_bf = torch.randn(N, K, generator=gen, device=dev).to(torch.bfloat16)
                out8 = torch.empty(M, N, dtype=torch.int8, device=dev)
                out16 = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
                scratch = torch.empty(M, dtype=torch.float32, device=dev)
                stream = torch.cuda.current_stream().cuda_stream
                ops = 2 * M * N * K
                lib_raw = launches_ms(lambda: (torch._int_mm(xq, wq.t()) >> 8).to(torch.int8))
                lib_bf16 = launches_ms(lambda: x @ w_bf.t())
                rb, rby = bound_ms(M, K, N, True)
                sb, sby = bound_ms(M, K, N, False)
                twins = {} if B != 2 else {
                    "raw": kernels.int8_matmul_raw(xq, wq, plain=True),
                    "static": kernels.int8_matmul(x, wq, ws, b, a_s, plain=True),
                    "dynamic": kernels.int8_matmul(x, wq, ws, b, plain=True)}
                rows = {"raw": [f"torch._int_mm + >>8 {lib_raw:.4f} ms"],
                        "static": [f"cuBLAS bf16 {lib_bf16:.4f} ms"], "dynamic": []}
                for name, lib in libs.items():
                    if isinstance(lib, str):
                        rows["raw"].append(f"{name}: {lib}")
                        continue
                    calls = {
                        "raw": (xq.data_ptr(), wq.data_ptr(), None, None, None, out8.data_ptr(),
                                M, N, K, 2, stream),
                        "static": (x.data_ptr(), wq.data_ptr(), ws.data_ptr(), b.data_ptr(),
                                   a_s.data_ptr(), out16.data_ptr(), M, N, K, 1, stream),
                        "dynamic": (x.data_ptr(), wq.data_ptr(), ws.data_ptr(), b.data_ptr(),
                                    scratch.data_ptr(), out16.data_ptr(), M, N, K, 0, stream),
                    }
                    for mode, args in calls.items():
                        if mode == "dynamic" and name != "as built":
                            continue
                        if lib.vfm_int8_matmul(*args):
                            rows[mode].append(f"{name}: launch failed")
                            continue
                        exact = ""
                        if mode in twins:  # B=2: does the variant compute the function?
                            torch.cuda.synchronize()
                            got = out8 if mode == "raw" else out16
                            exact = ", exact" if torch.equal(got, twins[mode]) else ", differs"
                        ms = launches_ms(lambda: lib.vfm_int8_matmul(*args))
                        bnd = rb if mode == "raw" else sb
                        ref = lib_raw if mode == "raw" else lib_bf16
                        rows[mode].append(f"{name} {ms:.4f} ms ({ops / ms / 1e9:.0f} TOP/s, "
                                          f"{bnd / ms:.3f} of bound, {ms / ref:.3f}x library"
                                          f"{exact})")
                        key = (B, mode, name)
                        totals[key] = totals.get(key, 0.0) + ms * count
                totals[(B, "library", "_int_mm")] = (totals.get((B, "library", "_int_mm"), 0.0)
                                                     + lib_raw * count)
                totals[(B, "library", "cuBLAS bf16")] = (
                    totals.get((B, "library", "cuBLAS bf16"), 0.0) + lib_bf16 * count)
                for mode, row in rows.items():
                    bnd, by = (rb, rby) if mode == "raw" else (sb, sby)
                    print(f"[ablation] B={B} M={M} K={K} N={N} {mode} (bound {bnd:.4f} ms, {by}):"
                          f" " + "; ".join(row), flush=True)
                del x, xq, wq, w_bf, out8, out16, twins
                torch.cuda.empty_cache()
    for B in (32, 4, 2):
        parts = [f"{mode} {name} {ms:.4f}" for (b_, mode, name), ms in totals.items()
                 if b_ == B and ms]
        print(f"[total] the 144 Linears of one encode at B={B}, ms: " + "; ".join(parts),
              flush=True)

    lib = library().lib
    # At B=4 (M=4096) back-to-back calls are bound by the device; at M=128
    # the device work is a few microseconds and the loop shows the host's.
    for M in (4096, 128):
        K = N = 1024
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (N, K), generator=gen, device=dev, dtype=torch.int8)
        ws, b = torch.rand(N, device=dev) * 1e-3, torch.randn(N, device=dev)
        a_s = (x.float().abs().amax() / 127).reshape(())
        w_bf = torch.randn(N, K, generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), wq.data_ptr(), ws.data_ptr(), b.data_ptr(), a_s.data_ptr(),
                out.data_ptr(), M, N, K, 1, stream)
        cost = {"wrapper": host_us(lambda: kernels.int8_matmul(x, wq, ws, b, a_s)),
                "ctypes call": host_us(lambda: lib.vfm_int8_matmul(*args)),
                "torch.empty": host_us(lambda: torch.empty(M, N, dtype=torch.bfloat16,
                                                           device=dev)),
                "cuBLAS bf16": host_us(lambda: x @ w_bf.t())}
        device = {"K6 static": launches_ms(lambda: lib.vfm_int8_matmul(*args)) * 1e3,
                  "cuBLAS bf16": launches_ms(lambda: x @ w_bf.t()) * 1e3}
        print(f"[host] K6 static M={M} K={K} N={N}, microseconds per call: "
              + ", ".join(f"{a} {v:.2f}" for a, v in cost.items())
              + "; device (events, back to back): "
              + ", ".join(f"{a} {v:.2f}" for a, v in device.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What bounds the bf16 flash forward (K3, K4) on the card: ablations and
host cost. Run on a machine with the CUDA toolkit and a card:

    python -m vfm_vae_tpu_torch.probes.flash_forward

Builds csrc/flash_attention_nullkv.cu as it is and in ablated variants,
each with one part of the kernel removed by a textual edit of a copy of the
source (the results of the ablated variants are wrong by construction and
only timed), and times every variant's launch against SDPA on the same
inputs at the offline batch's device-bound shapes (CUDA events around 30
back-to-back launches, the best of three windows). Then the host cost of a
call at K3's smallest decode sites: wall time per call over 2000 calls with
one synchronize at the end, for the wrapper, its ctypes call alone,
torch.empty_like and SDPA. Prints the card's name and power limit first.
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

SOURCE = "flash_attention_nullkv.cu"
# name -> [(file, text, replacement)]
ABLATIONS = {
    "as built": [],
    "no exponentials": [("hopper.cuh", 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                         "y = x * 0.001f;")],
    "no PV product": [("flash.cuh", "    wgmma_rs<D>(c, a[kk], ",
                       "    if (b_tile == 0xFFFFFFFFu) wgmma_rs<D>(c, a[kk], ")],
    "no K/V reloads": [("flash.cuh", "        mbar_expect_tx(a_full(s), L::kTile);",
                        "        if (gi >= L::kStages) {\n"
                        "          mbar_arrive(a_full(s));\n"
                        "          mbar_arrive(b_full(s));\n"
                        "          continue;\n"
                        "        }\n"
                        "        mbar_expect_tx(a_full(s), L::kTile);")],
    "no turns": [(SOURCE, "if constexpr (NWG > 1) wg == 0 ? vfm::named_sync<1, 256>() : "
                  "vfm::named_sync<2, 256>();", ""),
                 (SOURCE, "if constexpr (NWG > 1) wg == 0 ? vfm::named_arrive<2, 256>() : "
                  "vfm::named_arrive<1, 256>();", ""),
                 (SOURCE, "if (NWG > 1 && wg == 1) vfm::named_arrive<1, 256>();", ""),
                 (SOURCE, "if (NWG > 1 && wg == 0) vfm::named_sync<1, 256>();", "")],
    "setmaxnreg at d=64 too": [(SOURCE, "static constexpr bool kMoveRegisters = D == 128;",
                                "static constexpr bool kMoveRegisters = true;")],
    "no setmaxnreg": [(SOURCE, "static constexpr bool kMoveRegisters = D == 128;",
                       "static constexpr bool kMoveRegisters = false;")],
    "one work tile per CTA": [(SOURCE, "const int grid = (int)(n_work < (long long)per_sm * "
                               "sm_count() ? n_work : per_sm * sm_count());",
                               "const int grid = (int)n_work;")],
}
# (label, B, T, N, D, null token)
SHAPES = [("tower", 32, 1024, 16, 64, False), ("d128", 32, 1024, 8, 128, False),
          ("K3", 32, 1024, 8, 64, True)]


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
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vfm_flash_attention.argtypes = [P, P, P, P, P, I, I, I, I, I, F, I, P]
        lib.vfm_flash_attention_nullkv.argtypes = [P, P, P, P, P, P, P, I, I, I, I, F, P]
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


def main() -> int:
    import torch
    import torch.nn.functional as F

    from vfm_vae_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        raise SystemExit("flash_forward probe: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0], flush=True)
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        for label, B, T, N, D, null in SHAPES:
            q, k, v = (torch.randn(B, T, N, D, generator=gen, device=dev).to(bf) for _ in range(3))
            nk, nv = (torch.randn(B, 1, N, D, generator=gen, device=dev).to(bf) for _ in range(2))
            out, stream = torch.empty_like(q), torch.cuda.current_stream().cuda_stream
            if null:
                sdpa = (q.transpose(1, 2), torch.cat([nk, k], 1).transpose(1, 2),
                        torch.cat([nv, v], 1).transpose(1, 2))
            else:
                sdpa = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
            flops = 4 * B * N * T * (T + null) * D
            sdpa_ms = launches_ms(lambda: F.scaled_dot_product_attention(*sdpa))
            row = [f"SDPA {sdpa_ms:.4f} ms ({flops / sdpa_ms / 1e9:.0f} TFLOP/s)"]
            for name, lib in libs.items():
                if isinstance(lib, str):
                    row.append(f"{name}: {lib}")
                    continue
                if null:
                    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), nk.data_ptr(), nv.data_ptr(),
                            out.data_ptr(), None, B, T, N, D, D ** -0.5, stream)
                    call = lambda: lib.vfm_flash_attention_nullkv(*args)  # noqa: E731
                else:
                    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, B, T,
                            T, N, D, D ** -0.5, 0, stream)
                    call = lambda: lib.vfm_flash_attention(*args)  # noqa: E731
                if call():
                    row.append(f"{name}: launch failed")
                    continue
                ms = launches_ms(call)
                row.append(f"{name} {ms:.4f} ms ({flops / ms / 1e9:.0f} TFLOP/s, "
                           f"{ms / sdpa_ms:.3f}x SDPA)")
            print(f"[ablation] {label} B={B} T={T} N={N} D={D}: " + "; ".join(row), flush=True)
            del q, k, v, nk, nv, out, sdpa
    lib = library().lib
    for T in (64, 256):
        q, k, v = (torch.randn(2, T, 8, 64, generator=gen, device=dev).to(bf) for _ in range(3))
        nk, nv = (torch.randn(2, 1, 8, 64, generator=gen, device=dev).to(bf) for _ in range(2))
        out, stream = torch.empty_like(q), torch.cuda.current_stream().cuda_stream
        sdpa = (q.transpose(1, 2), torch.cat([nk, k], 1).transpose(1, 2),
                torch.cat([nv, v], 1).transpose(1, 2))
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), nk.data_ptr(), nv.data_ptr(),
                out.data_ptr(), None, 2, T, 8, 64, 0.125, stream)
        cost = {"wrapper": host_us(lambda: kernels.flash_attention_nullkv(q, k, v, nk, nv)),
                "ctypes call": host_us(lambda: lib.vfm_flash_attention_nullkv(*args)),
                "torch.empty_like": host_us(lambda: torch.empty_like(q)),
                "SDPA": host_us(lambda: F.scaled_dot_product_attention(*sdpa))}
        print(f"[host] K3 B=2 T={T} N=8 D=64, microseconds per call: "
              + ", ".join(f"{a} {b:.2f}" for a, b in cost.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

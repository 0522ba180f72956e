"""What bounds the flash forward (K3, K4) on the card: ablations and host
cost. Run on a machine with the CUDA toolkit and a card:

    python -m vfm_vae_tpu_torch.probes.flash_forward            # bf16
    python -m vfm_vae_tpu_torch.probes.flash_forward --fp32 [--parent DIR]

--fp32 takes K4's fp32 forward (3xTF32 on wgmma) at the adapter's four
sites (T=1024 N=16 three times, T=256 N=12 once, d=64) at B=2 and B=32: the
kernel as built and with one part removed (the split of K and V into hi and
lo planes, two of the three TF32 products of every fp32 product, the
O += P V product, the online softmax, the exponentials; with one consumer
warpgroup a CTA), each beside SDPA's
fp32 forward, and at B=2 each variant's mean error against fp64 beside the
fp32 twin's. With --parent, the flash forward source of another tree (its
csrc directory, e.g. a `git archive` of the parent commit) is built too and
timed first and last, so a redesign is compared with its parent in one call;
--other LABEL=DIR adds more such builds, timed beside the variants.

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
import re
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
# K4's fp32 forward: name -> [(file, text, replacement)].
F32_ABLATIONS = {
    "as built": [],
    "no split": [(SOURCE, "        vfm::split_plane(st, st + L::kTile, L::kTile, tid, L::kSplitters);\n"
                  "        vfm::split_transpose<D, L::kKT>(", "        if (tid < 0) vfm::split_transpose<D, L::kKT>(")],
    "1xTF32": [(SOURCE, "    vfm::wgmma_tf32_ss<L::kKT>(acc, dql, dkh, hh);\n"
                "    vfm::wgmma_tf32_ss<L::kKT>(acc, dqh, dkl, 1);\n"
                "    vfm::wgmma_tf32_ss<L::kKT>(acc, dqh, dkh, 1);",
                "    vfm::wgmma_tf32_ss<L::kKT>(acc, dqh, dkh, hh);"),
               (SOURCE, "    vfm::wgmma_tf32_rs<D>(acc, pl[kk], dvh, hh);\n"
                "    vfm::wgmma_tf32_rs<D>(acc, ph[kk], dvl, 1);\n"
                "    vfm::wgmma_tf32_rs<D>(acc, ph[kk], dvh, 1);",
                "    vfm::wgmma_tf32_rs<D>(acc, ph[kk], dvh, hh);")],
    "no PV product": [(SOURCE, "      pv_chain<D, L>(zo, c, ph, pl, vh, vl);",
                       "      if (Tk < 0) pv_chain<D, L>(zo, c, ph, pl, vh, vl);")],
    "no softmax": [(SOURCE, "    online_softmax<KT>(sc, m, l, alpha, j * KT, Tk, t, scale_log2);",
                    "    alpha[0] = alpha[1] = 1.f;\n    l[0] = l[1] = 1.f;")],
    "no exponentials": [("hopper.cuh", 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                         "y = x * 0.001f;")],
    "one consumer warpgroup": [(SOURCE, "return D == 64 && (long long)B * N * ((Tq + 127) / 128) >= "
                                "sms ? 2 : 1;", "return D == 64 && B * N * Tq * sms < 0 ? 2 : 1;")],
}
# The adapter's fp32 sites: (T, N, count per encode), d = 64.
F32_SITES = [(1024, 16, 3), (256, 12, 1)]
# (label, B, T, N, D, null token)
SHAPES = [("tower", 32, 1024, 16, 64, False), ("d128", 32, 1024, 8, 128, False),
          ("K3", 32, 1024, 8, 64, True)]


BUILD_LOGS = {}  # variant -> nvcc's output (ptxas -v lines)


def ptxas_lines(log: str, kernel: str) -> list:
    """"<kernel><D, NWG>: <registers>; <stack and spills>" for every instance
    of `kernel` in an nvcc -Xptxas -v log."""
    out, name, stack = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*" + kernel + r"ILi(\d+)ELi(\d+)E", line)
        if "Compiling entry function" in line:
            name = f"{kernel}<{m.group(1)}, {m.group(2)}>" if m else None
        elif name and "stack frame" in line:
            stack = line.strip()
        elif name and "Used" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {stack}")
            name = None
    return out


def build_variants(tmp: str, ablations: dict, extra: dict = None) -> dict:
    """{name: ctypes library or the reason it is missing}, built in parallel
    from edited copies of csrc/ (and from the csrc directories in `extra`,
    {name: path}, as they are)."""
    procs, libs = {}, {}
    sources = [(name, CSRC, edits) for name, edits in ablations.items()]
    sources += [(name, path, []) for name, path in (extra or {}).items()]
    for i, (name, src_dir, edits) in enumerate(sources):
        d = os.path.join(tmp, f"v{i}")
        shutil.copytree(src_dir, d, ignore=shutil.ignore_patterns("build"))
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
        BUILD_LOGS[name] = log
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vfm_flash_attention.argtypes = [P, P, P, P, P, I, I, I, I, I, F, I, P]
        lib.vfm_flash_attention_nullkv.argtypes = [P, P, P, P, P, P, P, I, I, I, I, F, P]
        libs[name] = lib
    return libs


def sass_counts(lib_path: str, kernel: str = "flash_fwd_f32_kernel") -> dict:
    """{"<kernel><D, NWG>": {"HGMMA": n, "HMMA": n, "FFMA": n, "instructions": n}}
    for every instance of `kernel` in the library at `lib_path`, read from
    cuobjdump -sass: the fp32 forward's products show as TF32 HGMMA, and an
    FMA main loop as thousands of FFMA."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                         check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            m = re.search(kernel + r"ILi(\d+)ELi(\d+)E", head.group(1))
            name = f"{kernel}<{m.group(1)}, {m.group(2)}>" if m else None
            if name:
                counts[name] = dict(HGMMA=0, HMMA=0, FFMA=0, instructions=0)
            continue
        op = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name and op:
            c = counts[name]
            c["instructions"] += 1
            if op.group(1) in c:
                c[op.group(1)] += 1
    return counts


def device_ms(fn, reps: int = 10):
    """Device time per call of `fn` from the profiler (the kernels' self
    device time over `reps` calls), or None if it saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps
    return busy or None


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


def fp32_probe(parent, others) -> None:
    """K4's fp32 forward at the adapter's sites: see the module docstring.
    `others`: {label: csrc directory} built as they are, timed after the
    variants."""
    import torch
    import torch.nn.functional as F

    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(32)
    with tempfile.TemporaryDirectory() as tmp:
        extra = dict(others, **({"parent": parent} if parent else {}))
        libs = build_variants(tmp, F32_ABLATIONS, extra)
        order = (["parent"] if parent else []) + list(F32_ABLATIONS) + list(others) + (
            ["as built again", "parent again"] if parent else ["as built again"])
        for name, log in BUILD_LOGS.items():
            print(f"[fp32] {name} ptxas: " + " | ".join(ptxas_lines(log, "flash_fwd_f32_kernel")),
                  flush=True)
        libs["as built again"] = libs["as built"]
        if parent:
            libs["parent again"] = libs["parent"]
        for B in (2, 32):
            totals = {}
            for T, N, count in F32_SITES:
                q, k, v = (torch.randn(B, T, N, 64, generator=gen, device=dev) for _ in range(3))
                out, stream = torch.empty_like(q), torch.cuda.current_stream().cuda_stream
                sdpa = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
                flops = 4 * B * N * T * T * 64
                bound = flops / (495e12 / 3) * 1e3
                truth = ref = None
                if B == 2:
                    s64 = torch.einsum("btnh,bsnh->bnts", q.double(), k.double()) * 0.125
                    truth = torch.einsum("bnts,bsnh->btnh", torch.softmax(s64, -1), v.double())
                    ref = fa.flash_attention_nonull_reference(q, k, v, 0.125)
                    del s64

                def err(x):
                    return float((x.double() - truth).abs().mean() / truth.abs().mean())

                row = []
                for name in order:
                    lib = libs[name]
                    if isinstance(lib, str):
                        row.append(f"{name}: {lib}")
                        continue
                    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, B, T,
                            T, N, 64, 0.125, 1, stream)
                    call = lambda: lib.vfm_flash_attention(*args)  # noqa: E731
                    if call():
                        row.append(f"{name}: launch failed")
                        continue
                    torch.cuda.synchronize()
                    e = f", err {err(out):.3e}" if truth is not None else ""
                    ms = launches_ms(call)
                    dev_text = ""
                    if name.startswith("as built") or name.startswith("parent"):
                        d_ms = device_ms(call)
                        totals[name] = totals.get(name, 0.0) + ms * count
                        key = name + " device"
                        totals[key] = None if d_ms is None or totals.get(key, 0.0) is None else (
                            totals.get(key, 0.0) + d_ms * count)
                        dev_text = f", device {'not measured' if d_ms is None else f'{d_ms:.4f}'}"
                    row.append(f"{name} {ms:.4f} ms ({bound / ms:.3f} of the bound{dev_text}{e})")
                sdpa_fn = lambda: F.scaled_dot_product_attention(*sdpa)  # noqa: E731
                sdpa_ms, sdpa_dev = launches_ms(sdpa_fn), device_ms(sdpa_fn)
                totals["SDPA"] = totals.get("SDPA", 0.0) + sdpa_ms * count
                totals["SDPA device"] = None if sdpa_dev is None or totals.get(
                    "SDPA device", 0.0) is None else totals.get("SDPA device", 0.0) + sdpa_dev * count
                twin = f", twin err {err(ref):.3e}" if truth is not None else ""
                print(f"[fp32] B={B} T={T} N={N} D=64 x{count}: bound {bound:.4f} ms (3xTF32); "
                      f"SDPA {sdpa_ms:.4f} ms (device {'not measured' if sdpa_dev is None else f'{sdpa_dev:.4f}'})"
                      f"{twin}; " + "; ".join(row),
                      flush=True)
                del q, k, v, out, sdpa, truth, ref
            print(f"[fp32] B={B} the four sites (events back to back, and device): " + ", ".join(
                f"{n} {'not measured' if ms is None else f'{ms:.4f}'} ms"
                for n, ms in totals.items()), flush=True)


def main() -> int:
    import argparse

    import torch
    import torch.nn.functional as F

    from vfm_vae_tpu_torch.ops import kernels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fp32", action="store_true", help="K4's fp32 forward at the adapter's sites")
    ap.add_argument("--parent", help="another tree's csrc directory, timed first and last")
    ap.add_argument("--other", action="append", default=[], metavar="LABEL=DIR",
                    help="a csrc directory timed beside the variants (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_forward probe: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0], flush=True)
    if args.fp32:
        fp32_probe(args.parent, dict(o.split("=", 1) for o in args.other))
        return 0
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, ABLATIONS)
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

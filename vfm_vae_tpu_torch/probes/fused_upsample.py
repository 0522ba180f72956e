"""What bounds K2 (the fused upsample + blur) on the card: times and bounds
at the flagship decode's K2 sites, as built and with one part changed. Run
on a machine with the CUDA toolkit and a card:

    python -m vfm_vae_tpu_torch.probes.fused_upsample [--batches 2 32] [--variants]

At each of the (Ci, Co, H, taps) sites of a flagship decode (the separate
and the last upsample of blocks 1-5: ten calls) and each batch, with bf16 O(1) random inputs from a seeded generator: the wrapper's
CUDA-event time (median of 20 single-call windows, as chip_smoke.py times
it), the back-to-back time (30 calls in one event window, best of three:
the host's time hidden when the card is the slower), the device time
(torch.profiler, the self device time of every kernel over 10 calls) and
the kernels it launched by name, the bound (the larger of the operations
at 989 TFLOP/s and the bytes at 3.35 TB/s: x read once, the output written
once) and the fraction of the bound the device time reaches. The launch
plan of every site (tiles, split, CTAs, ring) is printed beside it. Sums
over one decode's ten sites close each batch. The kernel is checked
against its twin at B=2 (max |diff| / max |twin|) before it is timed.

With --variants, csrc/fused_upsample.cu is also built as it is and with one
part changed by a textual edit of a copy of the source (VARIANTS; those
marked "another function" compute something else and are timed only), and
each is timed back to back through its own library at every site and batch
(the same inputs), after a check against the twin at B=2.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import tempfile

SOURCE = "fused_upsample.cu"
# name -> [(text, replacement)] in a copy of csrc/fused_upsample.cu
VARIANTS = {
    "as built": [],
    "blur legs skipped (another function)": [("      hleg();\n", ""), ("      vleg(n, e);\n", "")],
    "epilogue skipped (another function)": [("      if (mma) store_part(acc, e);\n", ""),
                                            ("      hleg();\n", ""), ("      vleg(n, e);\n", "")],
    "products skipped (another function)": [("              vfm::wgmma_ss_m64n128(\n",
                                             "              if (0) vfm::wgmma_ss_m64n128(\n")],
    "stencil arithmetic skipped (another function)": [
        ("        if (live) {\n#pragma unroll\n          for (int dy",
         "        if (0) {\n#pragma unroll\n          for (int dy")],
    "horizontal leg skipped (another function)": [("      hleg();\n", "")],
    "vertical leg skipped (another function)": [("      vleg(n, e);\n", "")],
    "product rows padded to 32 bytes": [(
        "__host__ __device__ constexpr int prod_ld(int mpad) { return 8 * part_channels(mpad) + 16; }",
        "__host__ __device__ constexpr int prod_ld(int mpad) { return 8 * part_channels(mpad) + 32; }")],
    "x boxes of 32 channels": [("  for (p.xc = 64;; p.xc = 32) {", "  for (p.xc = 32;; p.xc = 32) {")],
    "8 output rows a vertical-leg task": [("constexpr int kRG = 4;", "constexpr int kRG = 8;")],
    "N walk never split": [("  while (p.split * 2 <= n_tiles && 2LL * p.tiles * p.split <= sms) "
                            "p.split *= 2;\n", "")],
    "as built, again": [],
}
P, I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [P] * 6 + [I, P, I, I, I, I, I, P]

# (Ci, Co, H = W of the input, taps, calls a decode) of the flagship
# decode's K2 sites (entry.kernel_sites(G, 256)["fused_upsample_blur"]).
FLAGSHIP = [(768, 512, 8, 3, 1), (512, 512, 8, 3, 1), (640, 512, 16, 3, 1),
            (512, 512, 16, 3, 1), (640, 512, 32, 5, 1), (512, 512, 32, 5, 1),
            (512, 256, 64, 5, 2), (256, 128, 128, 5, 2)]
BINOMIAL = {1: [1.0], 3: [1.0, 2.0, 1.0], 5: [1.0, 4.0, 6.0, 4.0, 1.0]}
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def taps(kb: int):
    t = BINOMIAL[kb]
    return [v / sum(t) for v in t]


def work(B: int, Ci: int, Co: int, H: int, kb: int):
    """(operations, bytes) of one call, as chip_smoke.work counts them."""
    n = B * H * H
    ops = n * Ci * (2 + 2 * 9 + 2 * 4 * Co) + 2 * 2 * kb * 4 * n * Co
    byts = n * Ci * 2 + 4 * n * Co * 2 + 4 * Co * Ci * 2 + Ci * 9 * 4 + 2 * B * Ci * 4
    return ops, byts


def bound_ms(B, Ci, Co, H, kb) -> float:
    ops, byts = work(B, Ci, Co, H, kb)
    return max(ops / PEAK_BF16_FLOPS, byts / PEAK_BYTES_PER_S) * 1e3


def inputs(B, Ci, Co, H, kb, gen, dev):
    import torch

    bf, f32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    return dict(x=randn(B, H, H, Ci),
                a=torch.rand((B, Ci), generator=gen, device=dev) + 0.5,
                c=randn(B, Ci, scale=0.5, dtype=f32), dw=randn(Ci, 3, 3, scale=1 / 3, dtype=f32),
                pw=randn(4 * Co, Ci, scale=Ci ** -0.5), taps=taps(kb))


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of single-call CUDA-event windows."""
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


def back_to_back_ms(fn, calls: int = 30, windows: int = 3) -> float:
    """Per call over `calls` calls in one event window, best of `windows`."""
    import torch

    fn()
    best = float("inf")
    for _ in range(windows):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
        best = min(best, s.elapsed_time(e) / calls)
    return best


def device_kernels(fn, reps: int = 10):
    """(device ms per call or None, {kernel name: ms per call}) from the profiler."""
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
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            per[ev.key] = per.get(ev.key, 0.0) + ev.self_device_time_total / 1e3 / reps
    busy = sum(per.values())
    return (busy if busy else None), per


def build_variants(tmp: str) -> dict:
    """{name: ctypes library, or the reason it is missing}, built in parallel."""
    from vfm_vae_tpu_torch.ops.kernels._build import CSRC, NVCC_FLAGS, _nvcc

    procs, libs = {}, {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        d = os.path.join(tmp, f"v{i}")
        shutil.copytree(CSRC, d, ignore=shutil.ignore_patterns("build"))
        path = os.path.join(d, SOURCE)
        src = open(path).read()
        missing = [t[:40] for t, _ in edits if t not in src]
        if missing:
            libs[name] = f"not applicable (source changed: {missing})"
            continue
        for t, r in edits:
            src = src.replace(t, r)
        open(path, "w").write(src)
        procs[name] = (d, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-o", os.path.join(d, "lib.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            libs[name] = "build failed: " + log[-400:]
            continue
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        lib.vfm_fused_upsample_blur.argtypes = ARGTYPES
        lib.vfm_fused_upsample_blur.restype = ctypes.c_int
        libs[name] = lib
    return libs


def variant_call(lib, t, out):
    """One call of a variant's library on the inputs `t` into `out`."""
    import torch

    B, H, W, Ci = t["x"].shape
    Co = t["pw"].shape[0] // 4
    taps_c = (ctypes.c_float * len(t["taps"]))(*t["taps"])
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.vfm_fused_upsample_blur(
            t["x"].data_ptr(), t["a"].data_ptr(), t["c"].data_ptr(), t["dw"].data_ptr(),
            t["pw"].data_ptr(), ctypes.addressof(taps_c), len(t["taps"]), out.data_ptr(), B, H,
            W, Ci, Co, stream)
        if err:
            raise RuntimeError(f"variant call failed: CUDA error {err}")
    return call


def run_variants(batches, gen, dev) -> None:
    import torch

    from vfm_vae_tpu_torch.ops import kernels

    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        for name, lib in libs.items():
            if isinstance(lib, str):
                print(f"[variant] {name}: {lib}", flush=True)
        live = {k: v for k, v in libs.items() if not isinstance(v, str)}
        for B in batches:
            tot = dict.fromkeys(live, 0.0)
            for Ci, Co, H, kb, count in FLAGSHIP:
                t = inputs(B, Ci, Co, H, kb, gen, dev)
                ref = kernels.fused_upsample_blur(**t, plain=True) if B == 2 else None
                row = []
                for name, lib in live.items():
                    out = torch.empty((B, 2 * H, 2 * H, Co), dtype=torch.bfloat16, device=dev)
                    call = variant_call(lib, t, out)
                    call()
                    torch.cuda.synchronize()
                    check = ""
                    if ref is not None:
                        rel = float((out.float() - ref.float()).abs().max()
                                    / ref.float().abs().max())
                        check = f" (max_rel {rel:.2e})"
                    ms = back_to_back_ms(call)
                    tot[name] += count * ms
                    row.append(f"{name} {ms:.4f}{check}")
                print(f"[variant] B={B} Ci={Ci} Co={Co} H={H}: " + "; ".join(row), flush=True)
                del t, ref
                torch.cuda.empty_cache()
            print(f"[variant] B={B} the 10 sites of one decode, ms: "
                  + "; ".join(f"{k} {v:.4f}" for k, v in tot.items()), flush=True)


def text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[2, 32])
    ap.add_argument("--variants", action="store_true",
                    help="also build and time the VARIANTS of the source")
    args = ap.parse_args(argv)

    import torch

    from vfm_vae_tpu_torch.ops import kernels
    from vfm_vae_tpu_torch.ops.kernels import fused_upsample

    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(2024)
    for B in args.batches:
        tot = dict(events=0.0, back_to_back=0.0, device=0.0, bound=0.0)
        for Ci, Co, H, kb, count in FLAGSHIP:
            t = inputs(B, Ci, Co, H, kb, gen, dev)
            fn = lambda: kernels.fused_upsample_blur(**t)  # noqa: E731
            check = ""
            if B == 2:
                got, ref = fn(), kernels.fused_upsample_blur(**t, plain=True)
                torch.cuda.synchronize()
                rel = float((got.float() - ref.float()).abs().max() / ref.float().abs().max())
                check = f" vs twin max_rel={rel:.3e}"
            before = kernels.fused_upsample_blur.launches
            fn()
            calls = kernels.fused_upsample_blur.launches - before
            ev, b2b = event_ms(fn), back_to_back_ms(fn)
            dev_ms, per = device_kernels(fn)
            bnd = bound_ms(B, Ci, Co, H, kb)
            p = fused_upsample.plan(B, H, H, Ci, Co, kb, sms) if hasattr(fused_upsample, "plan") \
                else None
            names = ", ".join(f"{k[:60]} {v:.4f}" for k, v in sorted(per.items(),
                                                                     key=lambda kv: -kv[1]))
            print(f"[k2] B={B} Ci={Ci} Co={Co} H={H} taps={kb}: events {ev:.4f} ms, back-to-back "
                  f"{b2b:.4f}, device {text(dev_ms)}, bound {bnd:.4f} (of_bound device "
                  f"{'not measured' if dev_ms is None else f'{bnd / dev_ms:.3f}'}); wrapper "
                  f"launches a call {calls}; kernels: {names}{check}"
                  + (f"; plan {p}" if p else ""), flush=True)
            tot["events"] += count * ev
            tot["back_to_back"] += count * b2b
            tot["device"] = None if dev_ms is None or tot["device"] is None \
                else tot["device"] + count * dev_ms
            tot["bound"] += count * bnd
            del t
            torch.cuda.empty_cache()
        print(f"[k2] B={B} the 10 sites of one decode: events {tot['events']:.4f} ms, back-to-back "
              f"{tot['back_to_back']:.4f}, device {text(tot['device'])}, bound {tot['bound']:.4f}"
              + ("" if tot["device"] is None else f" (of_bound {tot['bound'] / tot['device']:.3f})"),
              flush=True)
    if args.variants:
        run_variants(args.batches, gen, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

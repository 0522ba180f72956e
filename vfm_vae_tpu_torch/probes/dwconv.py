"""What bounds K7 (depthwise conv + bias + legacy noise + moment sums) and
K8 (the depthwise conv + bias alone) on the card. Run on a machine with the
CUDA toolkit and a card:

    python -m vfm_vae_tpu_torch.probes.dwconv [--batches 2 32] \
        [--variants --parent DIR] [--ablations] [--skip-measure]

At each of the six (C, H, k) dwconv shapes of a flagship decode (38 calls:
entry.kernel_sites(G, 256)) and each batch, with O(1) random bf16 inputs
from a seeded generator, for K7 (noise on) and K8 (bias on): the wrapper's
CUDA-event time (median of 20 single-call windows, as chip_smoke.py times
it), the back-to-back time (30 calls in one event window, best of three:
the host's time hidden when the card is the slower), the device time
(torch.profiler, the self device time of every kernel over 10 calls) with
the kernels launched by name, the bound (chip_smoke.dwconv_work: the
larger of the fp32 operations at 67 TFLOP/s and the bytes at 3.35 TB/s)
and the fraction of it that the device time reaches; the library's device
time in turns with the kernel (kernel, library, library, kernel): cuDNN's
`F.conv2d(groups=C)` with a bf16 bias for K8, and for K7 that conv, the bf16
noise add and the two fp32 reductions; and the launch plan (tiles, CTAs,
ring stages, shared memory) where the wrapper has one. Sums over one
decode's 38 calls close each batch. At B=2 each kernel is checked against
its twin (bf16 ulps) before it is timed.

With --variants, the csrc directory given by --parent (the parent commit's
`dwconv_stats.cu` with its headers, e.g. from `git archive HEAD
vfm_vae_tpu_torch/csrc | tar -x -C _archive/pr11`) is built into a
temporary directory and its K7 and K8 are timed back to back and on the
device (kernels by name) beside the kernel as built, the parent first and
last, on the same inputs.

With --ablations, csrc/dwconv_stats.cu is built as it is and with one part
changed by a textual edit of a copy (ABLATIONS; those marked "another
function" compute something else and are timed only), and each is timed
back to back and on the device at the k = 7 sites at B=32, K8 and K7, "as
built" first and last; the SASS instruction mix of each instance of the
library as built (FFMA, shared loads, global stores, all) is printed first.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import tempfile

# name -> [(text, replacement)] in a copy of csrc/dwconv_stats.cu
ABLATIONS = {
    "as built": [],
    "stores skipped (another function)": [
        ("            op[j * a.C] = bf16_bits(", "            if (acc[o][j] == 1e30f) op[j * a.C] = bf16_bits("),
        ("              op[(j + h) * a.C] = static_cast<unsigned short>(bits);",
         "              if (bits == 0x7fc1u) op[(j + h) * a.C] = static_cast<unsigned short>(bits);")],
    "input conversion skipped (another function)": [
        ("in[j] = bits_float(xs[(ri * IW + j) * 64]);",
         "in[j] = __int_as_float(xs[(ri * IW + j) * 64]);")],
    "half the taps (another function)": [("for (int dx = 0; dx < K; ++dx)",
                                          "for (int dx = 0; dx < K; dx += 2)")],
    "statistics skipped (another function)": [
        ("    if constexpr (kStats) {\n      // Tiles i of one block",
         "    if constexpr (false) {\n      // Tiles i of one block")],
    "two stages": [("constexpr int kMaxStages = 3;", "constexpr int kMaxStages = 2;")],
    "4 x 8 outputs a thread": [("constexpr int kR = 8; ", "constexpr int kR = 4; "),
                               ("constexpr int kWT = 4; ", "constexpr int kWT = 8; ")],
    "as built, again": [],
}
# (C, H = W, k, calls a decode) of the flagship decode's ConvNeXt dwconvs.
FLAGSHIP = [(512, 8, 5, 7), (512, 16, 5, 7), (512, 32, 7, 7), (512, 64, 7, 7),
            (256, 128, 7, 5), (128, 256, 7, 5)]
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
P, I = ctypes.c_void_p, ctypes.c_int


def work(B: int, C: int, H: int, k: int, stats: bool):
    """(operations, bytes) of one call, as chip_smoke.dwconv_work counts them."""
    n = B * H * H * C
    ops = 2 * k * k * n + (5 * n if stats else n)
    byts = 4 * n + 4 * (k * k * C + C) + ((4 * H * H + 8 * B * C) if stats else 0)
    return ops, byts


def bound_ms(B, C, H, k, stats) -> float:
    ops, byts = work(B, C, H, k, stats)
    return max(ops / PEAK_FP32_FLOPS, byts / PEAK_BYTES_PER_S) * 1e3


def inputs(B, C, H, k, gen, dev):
    """x (B, H, H, C) bf16; w (k, k, C), b (C,), noise (H, H) fp32."""
    import torch

    x = torch.randn((B, H, H, C), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((k, k, C), generator=gen, device=dev) / k
    b = torch.randn(C, generator=gen, device=dev) * 0.5
    noise = torch.randn((H, H), generator=gen, device=dev) * 0.3
    return x, w, b, noise


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


def device_in_turns(fn_a, fn_b):
    """Device ms of two alternatives in turns (a, b, b, a), each the mean of
    its two readings (None if the profiler saw none), and b's kernels."""
    a1, _ = device_kernels(fn_a)
    b1, per_b = device_kernels(fn_b)
    b2, _ = device_kernels(fn_b)
    a2, _ = device_kernels(fn_a)

    def mean(x, y):
        return None if x is None or y is None else (x + y) / 2

    return mean(a1, a2), mean(b1, b2), per_b


def library_call(x, w, b, noise, k: int, stats: bool):
    """One PyTorch chain that computes the kernel's function on its inputs
    (a yardstick: the port never calls it): cuDNN's depthwise conv with a
    bf16 bias, and for K7 the bf16 noise add and the two fp32 reductions."""
    import torch
    import torch.nn.functional as F

    C = x.shape[-1]
    xc = x.permute(0, 3, 1, 2)  # NCHW view, channels-last in memory
    wc = w.permute(2, 0, 1)[:, None].to(torch.bfloat16).contiguous()
    bb = b.to(torch.bfloat16)
    nz = noise.to(torch.bfloat16)
    if not stats:
        return lambda: F.conv2d(xc, wc, bb, padding=k // 2, groups=C)

    def chain():
        y = (F.conv2d(xc, wc, bb, padding=k // 2, groups=C) + nz).float()
        return y.sum((2, 3)), y.square().sum((2, 3))
    return chain


def bf16_ulps(got, ref) -> float:
    """max |got - ref| in bf16 ulps of the twin's value."""
    import torch

    r = ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r)[1] - 8)
    return float(((got.float() - ref.float()).abs() / ulp).max())


def text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def build_parent(src_dir: str, tmp: str):
    """The parent's dwconv_stats.cu (and the headers beside it) built alone
    into `tmp`: a ctypes library with its C entries, or the build log."""
    from vfm_vae_tpu_torch.ops.kernels._build import NVCC_FLAGS, _nvcc

    out = os.path.join(tmp, "parent.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", out,
                           os.path.join(src_dir, "dwconv_stats.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        return "build failed: " + (proc.stdout + proc.stderr)[-600:]
    lib = ctypes.CDLL(out)
    lib.vfm_dwconv_tiles.argtypes = [I, I]
    lib.vfm_dwconv_tiles.restype = I
    lib.vfm_dwconv_noise_stats.argtypes = [P] * 8 + [I] * 5 + [P]
    lib.vfm_dwconv_noise_stats.restype = I
    lib.vfm_depthwise_conv2d_same.argtypes = [P] * 4 + [I] * 5 + [P]
    lib.vfm_depthwise_conv2d_same.restype = I
    return lib


def build_ablations(tmp: str) -> dict:
    """{name: ctypes library, or why it is missing}: csrc/dwconv_stats.cu as
    it is and with each ABLATIONS edit, built in parallel."""
    import shutil

    from vfm_vae_tpu_torch.ops.kernels._build import CSRC, NVCC_FLAGS, _nvcc

    procs, libs = {}, {}
    for i, (name, edits) in enumerate(ABLATIONS.items()):
        d = os.path.join(tmp, f"a{i}")
        shutil.copytree(CSRC, d, ignore=shutil.ignore_patterns("build"))
        path = os.path.join(d, "dwconv_stats.cu")
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
        spills = sorted({int(m) for m in __import__("re").findall(r"(\d+) bytes spill stores", log)})
        print(f"[ablation] {name}: spill stores per instance {spills}", flush=True)
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        lib.vfm_dwconv_noise_stats.argtypes = [P] * 8 + [I] * 5 + [P]
        lib.vfm_dwconv_noise_stats.restype = I
        lib.vfm_depthwise_conv2d_same.argtypes = [P] * 4 + [I] * 5 + [P]
        lib.vfm_depthwise_conv2d_same.restype = I
        libs[name] = lib
    return libs


def ablation_call(lib, x, w, b, noise, stats: bool):
    """A call of an ablation's K7 (its own workspace) or K8 on the inputs."""
    import torch

    from vfm_vae_tpu_torch.ops.kernels import dwconv_stats

    B, H, W, C = x.shape
    k = w.shape[0]
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    if stats:
        p = dwconv_stats.plan(B, H, W, C, k, True)
        part = torch.empty(p["part_floats"], dtype=torch.float32, device=x.device)
        counters = torch.zeros(p["counters"], dtype=torch.int32, device=x.device)
        s = torch.empty((2, B, C), dtype=torch.float32, device=x.device)

        def call():
            err = lib.vfm_dwconv_noise_stats(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), noise.data_ptr(), out.data_ptr(),
                part.data_ptr(), counters.data_ptr(), s.data_ptr(), B, H, W, C, k, stream)
            if err:
                raise RuntimeError(f"ablation K7: CUDA error {err}")
    else:
        w8 = w.contiguous()

        def call():
            err = lib.vfm_depthwise_conv2d_same(x.data_ptr(), w8.data_ptr(), b.data_ptr(),
                                                out.data_ptr(), B, H, W, C, k, stream)
            if err:
                raise RuntimeError(f"ablation K8: CUDA error {err}")
    return call


def sass_mix(lib_path: str) -> dict:
    """{dwconv instance: {FFMA, LDS, STG, instructions}} from cuobjdump -sass."""
    import re

    from vfm_vae_tpu_torch.ops.kernels._build import _nvcc

    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                         check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            m = re.search(r"dwconv_kernelILi(\d+)ELb(\d)ELi(\d+)E", head.group(1))
            name = f"dwconv_kernel<{m.group(1)}, {m.group(2)}, {m.group(3)}>" if m else None
            if name:
                counts[name] = dict(FFMA=0, LDS=0, STG=0, instructions=0)
            continue
        op = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name and op:
            c = counts[name]
            c["instructions"] += 1
            if op.group(1) in c:
                c[op.group(1)] += 1
    return counts


def run_ablations(gen, dev) -> None:
    import torch

    from vfm_vae_tpu_torch.ops.kernels._build import library

    for name, c in sass_mix(str(library().path)).items():
        print(f"[sass] {name}: {c}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_ablations(tmp)
        for name, lib in libs.items():
            if isinstance(lib, str):
                print(f"[ablation] {name}: {lib}", flush=True)
        live = {k: v for k, v in libs.items() if not isinstance(v, str)}
        for stats in (False, True):
            tag = "K7" if stats else "K8"
            tot = dict.fromkeys(live, 0.0)
            for C, H, k, count in FLAGSHIP:
                if k != 7:
                    continue
                x, w, b, noise = inputs(32, C, H, k, gen, dev)
                row = []
                for name, lib in live.items():
                    call = ablation_call(lib, x, w, b, noise, stats)
                    call()
                    torch.cuda.synchronize()
                    ms = back_to_back_ms(call)
                    dev_ms, _ = device_kernels(call)
                    tot[name] = None if tot[name] is None or dev_ms is None \
                        else tot[name] + count * dev_ms
                    row.append(f"{name} {ms:.4f} (device {text(dev_ms)})")
                print(f"[ablation] {tag} B=32 C={C} H={H}: " + "; ".join(row), flush=True)
                del x, w, b, noise
                torch.cuda.empty_cache()
            print(f"[ablation] {tag} B=32 the 24 k=7 dwconvs, device ms: "
                  + "; ".join(f"{k} {text(v)}" for k, v in tot.items()), flush=True)


def parent_call(lib, x, w, b, noise, stats: bool):
    """A call of the parent's K7 (its two-launch C interface: workspace,
    s1, s2) or K8 on the given inputs, outputs allocated once."""
    import torch

    B, H, W, C = x.shape
    k = w.shape[0]
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    if stats:
        part = torch.empty((2, B, lib.vfm_dwconv_tiles(H, W), C), dtype=torch.float32,
                           device=x.device)
        s = torch.empty((2, B, C), dtype=torch.float32, device=x.device)

        def call():
            err = lib.vfm_dwconv_noise_stats(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), noise.data_ptr(), out.data_ptr(),
                part.data_ptr(), s[0].data_ptr(), s[1].data_ptr(), B, H, W, C, k, stream)
            if err:
                raise RuntimeError(f"parent K7: CUDA error {err}")
            return out, s[0], s[1]
    else:
        def call():
            err = lib.vfm_depthwise_conv2d_same(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                                out.data_ptr(), B, H, W, C, k, stream)
            if err:
                raise RuntimeError(f"parent K8: CUDA error {err}")
            return out
    return call


def kernel_call(x, w, b, noise, stats: bool):
    from vfm_vae_tpu_torch.ops import kernels

    if stats:
        return lambda: kernels.dwconv_noise_stats(x, w, b, noise)
    w8 = w[:, :, None, :].contiguous()
    return lambda: kernels.depthwise_conv2d_same(x, w8, b)


def names_text(per: dict) -> str:
    return ", ".join(f"{k[:48]} {v:.4f}" for k, v in sorted(per.items(), key=lambda kv: -kv[1]))


def measure(batches, gen, dev, sms: int) -> None:
    import torch

    from vfm_vae_tpu_torch.ops import kernels
    from vfm_vae_tpu_torch.ops.kernels import dwconv_stats

    for B in batches:
        for stats in (True, False):
            tag = "K7" if stats else "K8"
            tot = dict(events=0.0, back_to_back=0.0, device=0.0, library=0.0, bound=0.0)
            for C, H, k, count in FLAGSHIP:
                x, w, b, noise = inputs(B, C, H, k, gen, dev)
                fn = kernel_call(x, w, b, noise, stats)
                lib = library_call(x, w, b, noise, k, stats)
                check = ""
                if B == 2:
                    got = fn()
                    ref = (kernels.dwconv_noise_stats(x, w, b, noise, plain=True) if stats else
                           kernels.depthwise_conv2d_same(x, w[:, :, None, :], b, plain=True))
                    torch.cuda.synchronize()
                    g, r = (got[0], ref[0]) if stats else (got, ref)
                    check = f"; vs twin {bf16_ulps(g, r):g} ulps"
                ev, b2b = event_ms(fn), back_to_back_ms(fn)
                dev_ms, per = device_kernels(fn)
                k_turn, lib_turn, lib_per = device_in_turns(fn, lib)
                bnd = bound_ms(B, C, H, k, stats)
                plan = ""
                if hasattr(dwconv_stats, "plan"):
                    p = dwconv_stats.plan(B, H, H, C, k, stats, sms)
                    plan = "; plan " + " ".join(f"{key}={p[key]}" for key in (
                        "cb", "th", "tw", "tiles", "ctas", "stages", "smem_bytes"))
                frac = "not measured" if dev_ms is None else f"{bnd / dev_ms:.3f}"
                print(f"[{tag}] B={B} C={C} H=W={H} k={k}: events {ev:.4f} ms, back-to-back "
                      f"{b2b:.4f}, device {text(dev_ms)} (of_bound {frac}; bound {bnd:.4f}); in "
                      f"turns device kernel {text(k_turn)} vs library {text(lib_turn)}; "
                      f"kernels: {names_text(per)}; library: {names_text(lib_per)}{check}{plan}",
                      flush=True)
                for key, val in (("events", ev), ("back_to_back", b2b), ("device", dev_ms),
                                 ("library", lib_turn), ("bound", bnd)):
                    tot[key] = None if val is None or tot[key] is None else tot[key] + count * val
                del x, w, b, noise, fn, lib
                torch.cuda.empty_cache()
            frac = ("not measured" if tot["device"] is None
                    else f"{tot['bound'] / tot['device']:.3f}")
            print(f"[{tag}] B={B} the 38 dwconvs of one decode: events {tot['events']:.4f} ms, "
                  f"back-to-back {tot['back_to_back']:.4f}, device {text(tot['device'])}, library "
                  f"device (in turns) {text(tot['library'])}, bound {tot['bound']:.4f} (of_bound "
                  f"device {frac})", flush=True)


def run_variants(parent_dir: str, batches, gen, dev) -> None:
    """The parent's kernels first and last, the kernel as built between, on
    the same inputs: back to back and device time, kernels by name."""
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        lib = build_parent(parent_dir, tmp)
        if isinstance(lib, str):
            print(f"[variant] parent: {lib}", flush=True)
            return
        for B in batches:
            for stats in (True, False):
                tag = "K7" if stats else "K8"
                tot = {"parent": 0.0, "as built": 0.0, "parent, again": 0.0}
                dtot = dict.fromkeys(tot, 0.0)
                for C, H, k, count in FLAGSHIP:
                    x, w, b, noise = inputs(B, C, H, k, gen, dev)
                    old = parent_call(lib, x, w, b, noise, stats)
                    new = kernel_call(x, w, b, noise, stats)
                    o, n = old(), new()
                    torch.cuda.synchronize()
                    same = bf16_ulps(n[0] if stats else n, o[0] if stats else o)
                    row = []
                    for name, fn in (("parent", old), ("as built", new), ("parent, again", old)):
                        ms = back_to_back_ms(fn)
                        dev_ms, per = device_kernels(fn)
                        tot[name] += count * ms
                        dtot[name] = None if dev_ms is None or dtot[name] is None \
                            else dtot[name] + count * dev_ms
                        row.append(f"{name} {ms:.4f} (device {text(dev_ms)}: {names_text(per)})")
                    print(f"[variant] {tag} B={B} C={C} H={H} k={k}: " + "; ".join(row)
                          + f"; new vs parent {same:g} ulps", flush=True)
                    del x, w, b, noise, old, new, o, n
                    torch.cuda.empty_cache()
                print(f"[variant] {tag} B={B} the 38 dwconvs, back to back (device) ms: "
                      + "; ".join(f"{k} {v:.4f} ({text(dtot[k])})" for k, v in tot.items()),
                      flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[2, 32])
    ap.add_argument("--variants", action="store_true",
                    help="also time the parent's kernels (--parent) beside the kernel as built")
    ap.add_argument("--parent", default=None,
                    help="a csrc directory holding the parent's dwconv_stats.cu")
    ap.add_argument("--ablations", action="store_true",
                    help="also build and time the ABLATIONS of the source at B=32")
    ap.add_argument("--skip-measure", action="store_true",
                    help="leave out the per-site measurements")
    args = ap.parse_args(argv)
    if args.variants and not args.parent:
        ap.error("--variants needs --parent DIR")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False  # the twins' fp32 conv in full fp32
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(2025)
    if args.ablations:
        run_ablations(gen, dev)
    if args.variants:
        run_variants(args.parent, args.batches, gen, dev)
    if not args.skip_measure:
        measure(args.batches, gen, dev, sms)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""What bounds the bf16 flash backward (K3's and K4's dK/dV and dQ kernels)
on the card: ablations and host cost. Run on a machine with the CUDA
toolkit and a card:

    python -m vfm_vae_tpu_torch.probes.flash_backward

Builds csrc/flash_attention_nullkv_bwd.cu as it is and in ablated variants,
each with one part removed by a textual edit of a copy of the source (the
ablated variants' results are wrong by construction and only timed): no
exponentials, and one work tile per CTA (not persistent). Times each
variant's one-call backward (pre-pass, dK/dV and dQ), its dK/dV call (with
the pre-pass) and its dQ call, beside SDPA's backward alone on the same
inputs, at the offline batch's device-bound shapes (CUDA events around 30
back-to-back calls, the best of three windows). Then the host cost of one
backward at K3's smallest decode sites: wall time per call over 2000 calls
with one synchronize at the end, through the Function (autograd's backward
of the kernel forward's output), its body (`_launch_backward`: validation,
one allocation, one ctypes call), the bare ctypes call, torch.empty_like and
SDPA's backward; and forward+backward through the Function and through
SDPA. Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

from vfm_vae_tpu_torch.ops.kernels._build import _SIGNATURES, CSRC, NVCC_FLAGS, _nvcc
from vfm_vae_tpu_torch.probes.flash_forward import host_us, launches_ms

SOURCE = "flash_attention_nullkv_bwd.cu"
# name -> [(file, text, replacement)]
ABLATIONS = {
    "as built": [],
    "no exponentials": [("hopper.cuh", 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                         "y = x * 0.001f;")],
    "one work tile per CTA": [(SOURCE, "return (int)(n_work < vfm::sm_count() ? n_work : "
                               "vfm::sm_count());", "return (int)n_work;")],
}
ENTRIES = ("vfm_flash_attention_nullkv_bwd", "vfm_flash_attention_bwd")
# (label, B, T, N, D, null token)
SHAPES = [("K3", 32, 1024, 8, 64, True), ("tower", 32, 1024, 16, 64, False),
          ("d128", 32, 1024, 8, 128, False)]


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
        for entry in ENTRIES:
            getattr(lib, entry).argtypes = _SIGNATURES[entry]
        libs[name] = lib
    return libs


def backward_calls(lib, t: dict, null: bool, stream: int) -> dict:
    """{label: a function that makes one ctypes call of `lib`}: the whole
    backward, dK/dV with the pre-pass, dQ alone."""
    p = {k: (None if v is None else v.data_ptr()) for k, v in t.items()}
    B, T, N, D = t["q"].shape
    scale = D ** -0.5
    if null:
        def call(out, dq, dk):
            return lib.vfm_flash_attention_nullkv_bwd(
                p["q"], p["k"], p["v"], p["nk"], p["nv"], out, p["dout"], p["lse"], p["delta"],
                p["parts"], dq, dk, p["dv"] if dk else None, p["dnk"] if dk else None,
                p["dnv"] if dk else None, B, T, N, D, scale, stream)
    else:
        def call(out, dq, dk):
            return lib.vfm_flash_attention_bwd(
                p["q"], p["k"], p["v"], out, p["dout"], p["lse"], p["delta"], dq, dk,
                p["dv"] if dk else None, B, T, T, N, D, scale, 0, stream)
    return {"backward": lambda: call(p["out"], p["dq"], p["dk"]),
            "dkv": lambda: call(p["out"], None, p["dk"]),
            "dq": lambda: call(None, p["dq"], None)}


def main() -> int:
    import torch

    from vfm_vae_tpu_torch.ops import kernels
    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa
    from vfm_vae_tpu_torch.ops.kernels._build import library

    if not torch.cuda.is_available():
        raise SystemExit("flash_backward probe: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0], flush=True)
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(B, T, N, D, null):
        t = {n: torch.randn(B, T, N, D, generator=gen, device=dev).to(bf)
             for n in ("q", "k", "v", "dout")}
        t["nk"], t["nv"] = ((torch.randn(B, 1, N, D, generator=gen, device=dev).to(bf)
                             for _ in range(2)) if null else (None, None))
        if null:
            t["out"], t["lse"] = fa._launch_forward(t["q"], t["k"], t["v"], t["nk"], t["nv"],
                                                    D ** -0.5, True)
        else:
            t["out"], t["lse"] = fa._launch_nonull(t["q"], t["k"], t["v"], D ** -0.5, True)
        t.update(dq=torch.empty_like(t["q"]), dk=torch.empty_like(t["k"]),
                 dv=torch.empty_like(t["v"]),
                 delta=torch.empty(B, N, T, device=dev),
                 parts=torch.empty(B * N * -(-T // 64) * 2 * D, device=dev) if null else None,
                 dnk=torch.empty_like(t["nk"]) if null else None,
                 dnv=torch.empty_like(t["nv"]) if null else None)
        return t

    def sdpa_leaves(t, null):
        if null:
            args = (t["q"].transpose(1, 2), torch.cat([t["nk"], t["k"]], 1).transpose(1, 2),
                    torch.cat([t["nv"], t["v"]], 1).transpose(1, 2))
        else:
            args = tuple(t[n].transpose(1, 2) for n in ("q", "k", "v"))
        return [a.detach().requires_grad_() for a in args]

    def sdpa_bwd(t, null):
        leaves = sdpa_leaves(t, null)
        o = torch.nn.functional.scaled_dot_product_attention(*leaves)
        g = t["dout"].transpose(1, 2)
        return lambda: torch.autograd.grad(o, leaves, g, retain_graph=True)

    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        for label, B, T, N, D, null in SHAPES:
            t = inputs(B, T, N, D, null)
            flops = {"backward": 14 * B * N * T * (T + null) * D,
                     "dkv": 8 * B * N * T * (T + null) * D, "dq": 6 * B * N * T * (T + null) * D}
            sdpa_ms = launches_ms(sdpa_bwd(t, null))
            sdpa_tflops = flops["backward"] * 5 / 7 / sdpa_ms / 1e9
            row = [f"SDPA backward {sdpa_ms:.4f} ms ({sdpa_tflops:.0f} TFLOP/s of its 5 products)"]
            for name, lib in libs.items():
                if isinstance(lib, str):
                    row.append(f"{name}: {lib}")
                    continue
                calls = backward_calls(lib, t, null, stream)
                if any(fn() for fn in calls.values()):
                    row.append(f"{name}: launch failed")
                    continue
                parts = []
                for part, fn in calls.items():
                    ms = launches_ms(fn)
                    parts.append(f"{part} {ms:.4f} ms ({flops[part] / ms / 1e9:.0f} TFLOP/s)")
                backward = launches_ms(calls["backward"])
                row.append(f"{name}: " + ", ".join(parts)
                           + f", backward/SDPA {backward / sdpa_ms:.3f}x")
            print(f"[ablation] {label} B={B} T={T} N={N} D={D}: " + "; ".join(row), flush=True)
            del t
            torch.cuda.empty_cache()
    lib = library().lib
    for T in (64, 256):
        t = inputs(2, T, 8, 64, True)
        bare = backward_calls(lib, t, True, stream)["backward"]
        leaves = [t[n].detach().requires_grad_() for n in ("q", "k", "v", "nk", "nv")]
        o = kernels.flash_attention_nullkv(*leaves)
        args = [t[n] for n in ("q", "k", "v", "nk", "nv", "out", "dout", "lse")]
        sl, g = sdpa_leaves(t, True), t["dout"].transpose(1, 2)
        cost = {"Function forward+backward": host_us(lambda: torch.autograd.grad(
                    kernels.flash_attention_nullkv(*leaves), leaves, t["dout"])),
                "SDPA forward+backward": host_us(lambda: torch.autograd.grad(
                    torch.nn.functional.scaled_dot_product_attention(*sl), sl, g)),
                "Function backward": host_us(lambda: torch.autograd.grad(
                    o, leaves, t["dout"], retain_graph=True)),
                "_launch_backward": host_us(lambda: fa._launch_backward(*args, 0.125)),
                "ctypes call": host_us(bare),
                "torch.empty_like": host_us(lambda: torch.empty_like(t["q"])),
                "SDPA backward": host_us(sdpa_bwd(t, True))}
        print(f"[host] K3 backward B=2 T={T} N=8 D=64, microseconds per call: "
              + ", ".join(f"{a} {b:.2f}" for a, b in cost.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

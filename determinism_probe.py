"""What moves the recipe's stage-2 determinism gate (chip_smoke.py's
determinism_phase on stage 2's configuration). Run on a machine with the
CUDA toolkit and a card, from the repository's root:

    python determinism_probe.py [--chains 3] [--trials 8] [--entry SNAPSHOT]
                                [--gate-only] [--noise] [--perturb [first] [all]]

Each chain runs the recipe's stages 0, 1 and 2 through the port's CLI as
chip_smoke.py's recipe phase does (flagship width and depth, B=4, three
[D, G] steps a stage, synthetic 256 px shards; the loader's workers order
the batches by timing, so every chain trains other weights), or, with
--entry, resumes stage 2 from a kept stage-2 entry snapshot. On stage 2's
trainer it then evaluates the gate's quantities (loss terms and
per-module gradient norms of one [D, G] step with no random draws) on
--trials batches: in fp32, with every kernel's plain twin, with every
kernel, with one kernel at a time and with two at a time switched to
their twins, forward and backward (K1 the fused ConvNeXt MLP, K2 the fused
upsample, K3 the null-KV attention with its dK/dV and dQ kernels), with
every kernel and K1's backward storing its recomputed hidden in fp32
(VFM_VAE_MLP_BWD_BF16=0), and with every kernel and the SSIM term's weight
at 0 (in all paths). For each path it prints the gate's paired median (the
median over quantities of the path's relative error vs fp32 over the plain
path's; the gate holds the all-kernel path to chip_smoke.TRUTH_FACTOR) and
the synthesis blocks' relative errors. Each path is read both ways
(chip_smoke.gate_readings): the gated reading over the loss terms and
every trainable gradient tensor's relative L2 error, and beside it the
reading the gate took until slice 17, over the loss terms and the
per-module gradient norms.

--stage 0 evaluates chip_smoke's stage-0 trainer (entry.flagship_trainer,
fresh seeded random weights a chain) instead of stage 2.

--gate-only evaluates only the gate's paths (fp32, plain, kernels) on each
batch and revisits none. --perturb adds a deliberately wrong kernel path:
the kernel path with one K1 output and one K3 output scaled by 1 + 2^-6
("first": the first K1 and the first K3 call of every G forward; "all":
every K1 and K3 call), inside the kernel path only (the twins are not
touched). The gate must fail it; the end of the run counts the batches on
which each reading passed or failed, for each path, and how often the
median and the per-tensor guard (chip_smoke.gate_readings) tripped.
--noise (with --gate-only) adds the paths with one kernel on its twin and,
on every batch, each legacy layer's noise_strength gradient and the noise
map it is the noise-weighted sum of, in fp32 and in each path, with the
scalar's conditioning (noise_table).

On each chain's first batch, and on every batch whose all-kernel path
fails the gate, it then (1) evaluates the kernel, plain and fp32 paths
twice more on the same weights and batch, and (2) runs the kernel path
once more with every K1, K2 and K3 call checked against its twins on that
call's own inputs: the forward against the bf16 twin under
chip_smoke.TOLERANCES, and the gradients of the inputs for a fixed
cotangent against the fp32 twin's, each no further from them than the
bf16 twin's times TRUTH_FACTOR (chip_smoke's function_grad_phase rule),
and (3) traces the kernel and plain paths' activations and the gradients
reaching them, module by module through the whole [D, G] evaluation,
against the fp32 path's (trace_blocks): where the kernel path's error first
departs from the plain path's; and, for every module whose gradient norm
the kernel path gets further from fp32 than the gate allows, the
parameters that carry that error (parameter_errors). Prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import gc
import math
import os
import shutil
import statistics
import sys
import tempfile
import time

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
KINDS = ("K1", "K2", "K3")
SINGLE = {f"kernels, {k} twin": (k,) for k in KINDS}
PAIRS = {"kernels, K1+K2 twins": ("K1", "K2"), "kernels, K1+K3 twins": ("K1", "K3"),
         "kernels, K2+K3 twins": ("K2", "K3")}


def kernel_modules(G) -> dict:
    """{K1, K2, K3: the G modules whose `plain` selects that kernel's twin}."""
    from vfm_vae_tpu_torch.models.convnext import (
        ConvNeXtSynthesisLayer, SeparableUpsampleWithFixedBlur)
    from vfm_vae_tpu_torch.models.gigagan import SelfAttention

    kinds = {"K1": ConvNeXtSynthesisLayer, "K2": SeparableUpsampleWithFixedBlur,
             "K3": SelfAttention}
    return {k: [m for m in G.modules() if isinstance(m, cls)] for k, cls in kinds.items()}


class site_twins:
    """For the length of a `with`: every kernel call of K1, K2 and K3 made
    by the models is run again on detached copies of its inputs as the
    kernel, as the bf16 twin and as the fp32 twin, each with the gradients
    of its inputs for one seeded cotangent; each call's errors are kept in
    `sites` as (kind, shape, forward max_rel, forward mean_rel, worst
    gradient kernel/twin ratio, ok)."""

    NAMES = {"K1": "fused_convnext_mlp", "K2": "fused_upsample_blur",
             "K3": "flash_attention_nullkv"}

    def __init__(self):
        self.sites = []

    def __enter__(self):
        from vfm_vae_tpu_torch.models import convnext, gigagan

        self.saved = (convnext.fused_convnext_mlp, convnext.fused_upsample_blur,
                      gigagan.dot_product_attention_nullkv)
        convnext.fused_convnext_mlp = self.wrap("K1", self.saved[0])
        convnext.fused_upsample_blur = self.wrap("K2", self.saved[1])
        gigagan.dot_product_attention_nullkv = self.wrap("K3", self.saved[2])
        return self

    def __exit__(self, *exc):
        from vfm_vae_tpu_torch.models import convnext, gigagan

        (convnext.fused_convnext_mlp, convnext.fused_upsample_blur,
         gigagan.dot_product_attention_nullkv) = self.saved

    def wrap(self, kind, fn):
        def checked(*args, plain=False):
            out = fn(*args, plain=plain)
            if not plain:
                self.sites.append(self.compare(kind, fn, args))
            return out

        return checked

    def compare(self, kind, fn, args):
        import torch

        def run(plain: bool, fp32: bool):
            with torch.enable_grad():
                leaves = [a.detach().float() if fp32 and a.is_floating_point() else a.detach()
                          for a in args if torch.is_tensor(a)]
                for a in leaves:
                    a.requires_grad_(a.is_floating_point())
                it = iter(leaves)
                out = fn(*[next(it) if torch.is_tensor(a) else a for a in args], plain=plain)
                g = torch.randn(out.shape, generator=torch.Generator(device=out.device)
                                .manual_seed(5), device=out.device).to(out.dtype)
                grads = torch.autograd.grad(out, [a for a in leaves if a.requires_grad], g,
                                            allow_unused=True)
            return out.detach(), grads

        (ko, kg), (po, pg), (_, tg) = run(False, False), run(True, False), run(True, True)
        _, max_rel, mean_rel = cs.rel_errors(ko, po)
        tol = cs.TOLERANCES[self.NAMES[kind]]
        worst, ok = 0.0, bool(torch.isfinite(ko.float()).all()) and max_rel <= tol[0] \
            and mean_rel <= tol[1]
        for a, b, c in zip(kg, pg, tg):
            if a is None or c is None:
                continue
            k32, p32 = cs.rel_errors(a, c)[2], cs.rel_errors(b, c)[2]
            worst = max(worst, k32 / max(p32, 1e-6))
            ok = ok and bool(torch.isfinite(a.float()).all()) \
                and k32 <= cs.TRUTH_FACTOR * p32 + 1e-6
        return kind, tuple(args[0].shape), max_rel, mean_rel, worst, ok

    def report(self, label: str) -> list:
        bad = [s for s in self.sites if not s[-1]]
        for kind in KINDS:
            mine = [s for s in self.sites if s[0] == kind]
            if mine:
                print(f"[{label}] {kind} {len(mine)} calls vs twins: forward max_rel "
                      f"{max(s[2] for s in mine):.3e} mean_rel {max(s[3] for s in mine):.3e} "
                      f"(bounds {cs.TOLERANCES[self.NAMES[kind]]}); worst input-gradient "
                      f"kernel/bf16-twin error ratio vs fp32 {max(s[4] for s in mine):.3f} "
                      f"(limit {cs.TRUTH_FACTOR}); past a bound "
                      f"{sum(not s[-1] for s in mine)}", flush=True)
        for s in bad:
            print(f"[{label}] site past its bound: {s}", flush=True)
        return bad


PERTURB = 1.0 + 2.0 ** -6


class perturbed_kernels:
    """For the length of a `with`: K1's and K3's outputs in the kernel path
    scaled by PERTURB ("first": the first call of each in every forward of
    `G`; "all": every call). The twins' calls (plain=True) are untouched."""

    def __init__(self, G, which: str):
        self.G, self.which, self.calls, self.scaled = G, which, {"K1": 0, "K3": 0}, 0

    def __enter__(self):
        from vfm_vae_tpu_torch.models import convnext, gigagan

        self.saved = (convnext.fused_convnext_mlp, gigagan.dot_product_attention_nullkv)
        convnext.fused_convnext_mlp = self.wrap("K1", self.saved[0])
        gigagan.dot_product_attention_nullkv = self.wrap("K3", self.saved[1])
        self.hook = self.G.register_forward_pre_hook(
            lambda *_: self.calls.update(K1=0, K3=0))
        return self

    def __exit__(self, *exc):
        from vfm_vae_tpu_torch.models import convnext, gigagan

        convnext.fused_convnext_mlp, gigagan.dot_product_attention_nullkv = self.saved
        self.hook.remove()

    def wrap(self, kind, fn):
        def scaled(*args, plain=False):
            out = fn(*args, plain=plain)
            if plain:
                return out
            self.calls[kind] += 1
            if self.which == "all" or self.calls[kind] == 1:
                self.scaled += 1
                return out * PERTURB
            return out

        return scaled


def traced_modules(prefix: str, module) -> dict:
    """The modules whose outputs trace_blocks follows: the encoder, the
    adapter's parts, the mapping, every z injector, synthesis block and its
    upsamples (K2), ConvNeXt layers (K1), attentions (K3) and to-RGB, and
    D's backbone and heads."""
    import re

    keep = re.compile(r"(vfm_encoder|ldm_adapter\.[^.]+|mapping|synthesis\.z_convs\.\d+"
                      r"|synthesis\.blocks\.\d+(\.(conv0|convs1\.\d+|self_attns\.\d+"
                      r"|seperate_upsample_conv|last_upsample_conv|torgb))?|dino|heads)")
    return {f"{prefix}.{n}": m for n, m in module.named_modules() if keep.fullmatch(n)}


class trace_blocks:
    """For the length of a `with`: every output of the traced modules of a
    trainer's G and D (traced_modules), by module and call, and the
    gradients that reach each output in each backward pass. With `ref` None
    the values are kept in fp32 (the fp32 path's); otherwise each is
    replaced by its relative L2 distance from the `ref` value of the same
    name ({name: ||x - ref|| / ||ref||})."""

    def __init__(self, tr, ref=None):
        self.mods = {**traced_modules("G", tr.G), **traced_modules("D", tr.D)}
        self.ref, self.values, self.count, self.handles = ref, {}, {}, []

    @staticmethod
    def tensors(out) -> list:
        import torch

        if torch.is_tensor(out):
            return [out]
        if isinstance(out, (tuple, list)):
            return [t for o in out for t in trace_blocks.tensors(o)]
        if hasattr(out, "__dict__"):
            return [t for o in vars(out).values() for t in trace_blocks.tensors(o)]
        return []

    def take(self, key: str, t) -> None:
        t = t.detach().float()
        if self.ref is None:
            self.values[key] = t.clone()
        elif key in self.ref and self.ref[key].shape == t.shape:
            f = self.ref[key]
            self.values[key] = float((t - f).norm() / f.norm().clamp_min(1e-30))

    def hook(self, name: str):
        def forward(module, args, out):
            call = self.count.get(name, 0)
            self.count[name] = call + 1
            for j, t in enumerate(self.tensors(out)):
                key = f"{name}#{call}.{j}"
                self.take(key, t)
                if t.requires_grad:
                    passes = [0]

                    def backward(g, key=key, passes=passes):
                        self.take(f"d {key} pass {passes[0]}", g)
                        passes[0] += 1

                    t.register_hook(backward)
        return forward

    def __enter__(self):
        self.handles = [m.register_forward_hook(self.hook(n)) for n, m in self.mods.items()]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


class Evaluation:
    """The gate's quantities of stage 2's trainer `tr` and an fp32 plain
    copy on the same weights, with the buffers reset before each run."""

    def __init__(self, tr, state, build_fp32, label: str):
        import torch

        self.tr, self.state, self.label, self.grads = tr, state, label, None
        self.plain_grads = self.exact_grads = self.maps = None
        self.plain_maps = self.exact_maps = None
        self.counts = {}
        self.dev = next(tr.G.parameters()).device
        self.bufs = {"G": {k: v.clone() for k, v in tr.G.named_buffers()},
                     "D": {k: v.clone() for k, v in tr.D.named_buffers()}}
        self.tr32 = build_fp32()
        self.tr32.G.load_state_dict(tr.G.state_dict())
        self.tr32.D.load_state_dict(tr.D.state_dict())
        if tr.loss.lpips is not None:
            self.tr32.loss.lpips.load_state_dict(tr.loss.lpips.state_dict())
        self.tr32.G.use_plain_kernels(True)
        self.state32 = self.tr32.init_state()
        self.mods = kernel_modules(tr.G)
        self.ssim_w = (tr.loss.ssim_loss_weight, self.tr32.loss.ssim_loss_weight)
        self.torch = torch
        print(f"[{label}] kernel sites: "
              + ", ".join(f"{k} {len(v)} modules" for k, v in self.mods.items()), flush=True)

    def batch(self, trial: int):
        torch = self.torch
        gen = torch.Generator(device=self.dev).manual_seed(102 if trial == 0 else trial)
        img = torch.rand((cs.RECIPE_BATCH, 256, 256, 3), generator=gen, device=self.dev)
        return img, ((1.0, 0, False) if trial == 0
                     else cs.FORCED_BUCKETS[trial % len(cs.FORCED_BUCKETS)])

    def set_plain(self, which) -> None:
        for k, ms in self.mods.items():
            for m in ms:
                m.plain = k in which

    def run(self, fp32: bool, img, eq) -> dict:
        """The gate's quantities of one path (chip_smoke.determinism_run);
        its gradients by parameter go into self.grads."""
        t, st = (self.tr32, self.state32) if fp32 else (self.tr, self.state)
        out, self.grads, self.maps = cs.determinism_run(t, st, img, eq, self.bufs)
        return out

    def median(self, name, got, plain, exact, trial, eq, grads=None, key=None) -> float:
        """The gated reading (gate_readings) of path `name` on this batch,
        with the old reading beside it; `grads` holds {"kernels", "plain",
        "fp32"} gradient dicts (default: the last run's as the path's, the
        kept plain and fp32 ones, with their noise maps). Returns the gated
        median; the old one goes into self.old. Each reading is counted
        under `key` (default `name`): the median past the limit, the guard
        tripped."""
        g = grads or dict(kernels=self.grads, plain=self.plain_grads, fp32=self.exact_grads)
        maps = None if grads else dict(kernels=self.maps, plain=self.plain_maps,
                                       fp32=self.exact_maps)
        r = cs.gate_readings(got, plain, exact, g["kernels"], g["plain"], g["fp32"], maps)
        c = self.counts.setdefault(key or name, dict(
            batches=0, median=0, guard=0, scalar_guard=0))
        c["batches"] += 1
        c["median"] += r["median"] > cs.TRUTH_FACTOR
        c["guard"] += bool(r["guard"])
        c["scalar_guard"] += bool(r["scalar_guard"])
        synth = [k for k in r["old_keys"] if "synthesis.blocks" in k]
        print(f"[{self.label}] trial {trial} eq={eq} {name}: {cs.gate_text(r)}; synthesis "
              f"blocks' norms rel vs fp32 " + " ".join(f"{r['rel'][k][0]:.2e}" for k in synth)
              + "; plain " + " ".join(f"{r['rel'][k][1]:.2e}" for k in synth), flush=True)
        self.old = r["old_median"]
        return r["median"]

    def trial(self, trial: int, gate_only: bool = False, perturb=(), noise: bool = False) -> dict:
        """{path: (gated median, old median)} on batch `trial`: every path,
        or (gate_only) the kernel path, and for each mode in `perturb` the
        perturbed kernel path; with `noise` (and gate_only) also the paths
        with one kernel on its twin, and every legacy layer's noise_strength
        gradient and noise map in each path (noise_table)."""
        img, eq = self.batch(trial)
        out = {}
        for no_ssim in ((False,) if gate_only else (False, True)):
            self.tr.loss.ssim_loss_weight = 0.0 if no_ssim else self.ssim_w[0]
            self.tr32.loss.ssim_loss_weight = 0.0 if no_ssim else self.ssim_w[1]
            exact = self.run(True, img, eq)
            self.exact_grads, self.exact_maps = self.grads, self.maps
            self.set_plain(KINDS)
            plain = self.run(False, img, eq)
            self.plain_grads, self.plain_maps = self.grads, self.maps
            paths = ({"kernels no-SSIM": ()} if no_ssim
                     else dict({"kernels": ()}, **SINGLE) if gate_only and noise
                     else {"kernels": ()} if gate_only
                     else dict({"kernels": ()}, **SINGLE, **PAIRS))
            table = {}
            for name, twins in paths.items():
                self.set_plain(twins)
                out[name] = (self.median(name, self.run(False, img, eq), plain, exact, trial,
                                         eq), self.old)
                table[name] = (self.grads, self.maps)
            for mode in ([] if no_ssim else perturb):
                self.set_plain(())
                with perturbed_kernels(self.tr.G, mode) as pk:
                    got = self.run(False, img, eq)
                name = f"kernels, K1+K3 outputs x (1 + 2^-6) ({mode}: {pk.scaled} calls)"
                out[f"perturbed ({mode})"] = (self.median(name, got, plain, exact, trial, eq,
                                                          key=f"perturbed ({mode})"), self.old)
            if noise and not no_ssim:
                self.noise_table(trial, eq, table)
            if gate_only:
                break
            if not no_ssim:
                with cs.env_vars({"VFM_VAE_MLP_BWD_BF16": "0"}):
                    for name, twins in (("kernels, K1 bwd fp32 hidden", ()),
                                        ("plain, K1 bwd fp32 hidden", KINDS)):
                        self.set_plain(twins)
                        out[name] = (self.median(name, self.run(False, img, eq), plain, exact,
                                                 trial, eq), self.old)
            self.set_plain(())
        self.tr.loss.ssim_loss_weight, self.tr32.loss.ssim_loss_weight = self.ssim_w
        return out

    def noise_table(self, trial: int, eq, table: dict) -> None:
        """Every legacy layer's noise_strength gradient in fp32 and in each
        path of `table` ({path: (gradients, noise maps)}; the plain path's
        first), each path's relative error against fp32 for the scalar and
        for the noise map it is the weighted sum of, and the scalar's
        conditioning (sum |terms| / |sum| of fp32's map times the noise)."""
        table = dict(plain=(self.plain_grads, self.plain_maps), **table)
        tag = f"[{self.label} trial {trial} noise]"
        for layer, (m32, unit) in self.exact_maps.items():
            pname = layer + ".noise_strength"
            if pname not in self.exact_grads:
                continue
            g32 = float(self.exact_grads[pname])
            terms = unit * m32
            cond = float(terms.abs().sum()) / max(abs(float(terms.sum())), 1e-30)
            check = abs(float(terms.sum()) - g32) / max(abs(g32), 1e-30)
            parts = []
            for path, (grads, maps) in table.items():
                g = float(grads[pname])
                mrel = float((maps[layer][0] - m32).norm() / m32.norm().clamp_min(1e-30))
                parts.append(f"{path} {g:.4e} (rel {abs(g - g32) / max(abs(g32), 1e-30):.2e}, "
                             f"map rel {mrel:.2e})")
            print(f"{tag} {layer} on {eq}: fp32 {g32:.4e} (map sum vs it {check:.1e}, "
                  f"conditioning {cond:.3g}); " + "; ".join(parts), flush=True)

    def revisit(self, trial: int) -> list:
        """Batch `trial` again on the same weights: the kernel, plain and
        fp32 paths twice more, then the kernel path with every kernel call
        checked against its twins. Returns the sites past a bound."""
        img, eq = self.batch(trial)
        for rep in (1, 2):
            exact = self.run(True, img, eq)
            self.exact_grads, self.exact_maps = self.grads, self.maps
            self.set_plain(KINDS)
            plain = self.run(False, img, eq)
            self.plain_grads, self.plain_maps = self.grads, self.maps
            self.set_plain(())
            self.median(f"kernels (repeat {rep})", self.run(False, img, eq), plain, exact,
                        trial, eq)
        with site_twins() as sites:
            self.run(False, img, eq)
        self.trace(trial, img, eq)
        return sites.report(f"{self.label} trial {trial} sites")

    def trace(self, trial: int, img, eq) -> None:
        """The kernel path's and the plain path's activations and the
        gradients reaching them, module by module in the order the [D, G]
        evaluation runs them, against the fp32 path's: each one's relative
        L2 error, and where the kernel path's error first exceeds the plain
        path's by TRUTH_FACTOR (forward, then gradients)."""
        with trace_blocks(self.tr32) as exact:
            self.run(True, img, eq)
        grads = {"fp32": self.grads}
        errs = {}
        for name, twins in (("kernels", ()), ("plain", KINDS)):
            self.set_plain(twins)
            with trace_blocks(self.tr, ref=exact.values) as t:
                self.run(False, img, eq)
            errs[name], grads[name] = t.values, self.grads
        self.set_plain(())
        self.grads = None
        self.parameter_errors(trial, eq, grads)
        keys = [k for k in exact.values if k in errs["kernels"] and k in errs["plain"]]
        del exact
        tag = f"[{self.label} trial {trial} trace]"
        first = {}
        for k in keys:
            ek, ep = errs["kernels"][k], errs["plain"][k]
            ratio = max(ek, 1e-6) / max(ep, 1e-6)
            kind = "gradient" if k.startswith("d ") else "forward"
            if ratio > cs.TRUTH_FACTOR and kind not in first:
                first[kind] = k
            print(f"{tag} {k}: kernels {ek:.3e} plain {ep:.3e} ratio {ratio:.3f}", flush=True)
        print(f"{tag} {len(keys)} outputs and gradients on {eq}; first past {cs.TRUTH_FACTOR}x "
              f"the plain path's error vs fp32: forward {first.get('forward')}, gradient "
              f"{first.get('gradient')}", flush=True)

    def parameter_errors(self, trial: int, eq, grads: dict) -> None:
        """Where the gate's per-module gradient norms part: for every module
        whose norm the kernel path gets further from fp32 than TRUTH_FACTOR
        times the plain path does, its parameters with the largest share of
        the kernel path's norm error (the difference of squared norms), each
        with its own norm's and its tensor's relative errors, kernel and
        plain."""
        f, k, p = grads["fp32"], grads["kernels"], grads["plain"]
        sq = {path: {n: float(g.square().sum()) for n, g in gs.items()}
              for path, gs in grads.items()}
        groups: dict = {}
        for n in f:
            groups.setdefault(".".join(n.split(".")[:4]), []).append(n)
        tag = f"[{self.label} trial {trial} parameters]"
        for key, names in groups.items():
            nf, nk, np_ = (math.sqrt(sum(sq[path][n] for n in names))
                           for path in ("fp32", "kernels", "plain"))
            ek, ep = abs(nk - nf) / max(nf, 1e-30), abs(np_ - nf) / max(nf, 1e-30)
            if max(ek, 1e-6) / max(ep, 1e-6) <= cs.TRUTH_FACTOR:
                continue
            share = sorted(names, key=lambda n: -abs(sq["kernels"][n] - sq["fp32"][n]))
            parts = []
            for n in share[:5]:
                g = f[n].norm().clamp_min(1e-30)
                part = abs(sq["kernels"][n] - sq["fp32"][n]) / max(abs(nk * nk - nf * nf), 1e-30)
                rel_k, rel_p = (abs(math.sqrt(sq[path][n]) - float(g)) / float(g)
                                for path in ("kernels", "plain"))
                parts.append(
                    f"{n} (|g| {float(g):.3e}, share {part:.2f}; norm rel kernels {rel_k:.2e} "
                    f"plain {rel_p:.2e}; tensor rel kernels {float((k[n] - f[n]).norm() / g):.2e} "
                    f"plain {float((p[n] - f[n]).norm() / g):.2e})")
            print(f"{tag} {key} on {eq}: norm rel vs fp32 kernels {ek:.3e} plain {ep:.3e}; "
                  f"largest shares: " + "; ".join(parts), flush=True)

    def close(self) -> None:
        del self.tr32, self.state32
        self.grads = self.plain_grads = self.exact_grads = None
        self.maps = self.plain_maps = self.exact_maps = None
        gc.collect()
        self.torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chains", type=int, default=3)
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--entry", default=None,
                    help="a stage-2 entry snapshot (stage 1's) to resume instead of stages 0-1")
    ap.add_argument("--stage", type=int, choices=(0, 2), default=2,
                    help="2: the recipe's stage 2 (stages 0-2 through the CLI a chain); 0: "
                         "the stage-0 flagship trainer of chip_smoke's training phase, fresh "
                         "random weights a chain")
    ap.add_argument("--gate-only", action="store_true",
                    help="only the gate's paths on each batch, no revisits")
    ap.add_argument("--noise", action="store_true",
                    help="with --gate-only: also the paths with one kernel on its twin, and "
                         "every legacy noise_strength gradient and noise map in each path")
    ap.add_argument("--perturb", choices=("first", "all"), nargs="*", default=(),
                    help="add the kernel path with K1 and K3 outputs scaled by 1 + 2^-6 "
                         "(first: one call of each a G forward; all: every call)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("determinism probe: no CUDA device")

    from vfm_vae_tpu_torch.core.config import derive_config, load_config
    from vfm_vae_tpu_torch.entry import flagship_trainer
    from vfm_vae_tpu_torch.ops.kernels._build import library
    from vfm_vae_tpu_torch.train.loop import build_trainer

    card = cs.gpu_line()
    print(card, flush=True)
    library()
    overrides = dict(batch_size=cs.RECIPE_BATCH, kimg_per_tick=1000, network_snapshot_ticks=1,
                     allow_random_lpips=True)
    chains = 1 if args.entry else args.chains
    failing, bad_sites, readings, totals = [], [], {}, {}
    dev = torch.device("cuda")
    for chain in range(chains):
        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix="vfm_det_")
        label = f"chain {chain}"
        try:
            if args.stage == 0:
                tr = flagship_trainer(dev, cs.RECIPE_BATCH,
                                      torch.Generator(device=dev).manual_seed(100 + chain),
                                      allow_random_lpips=True)
                cs.randomize_zero_init_branches(tr.G, seed=200 + chain)
                ev = Evaluation(tr, tr.init_state(), lambda: flagship_trainer(
                    dev, cs.RECIPE_BATCH, torch.Generator(device=dev).manual_seed(0),
                    dtype=torch.float32, allow_random_lpips=True), label)
                res = tr
            else:
                shards = os.path.join(tmp, "shards")
                cs.write_recipe_shards(shards)
                prev = args.entry
                for i in ((2,) if args.entry else (0, 1, 2)):
                    c = derive_config(load_config(os.path.join(ROOT, cs.RECIPE_YAMLS[i])))
                    c.run_dir = os.path.join(tmp, f"stage{i}")
                    c.training_set_kwargs.path = shards
                    c.update(overrides, resume_path=prev, resume_kimg=0)
                    res = cs.run_recipe_cli(c, os.path.join(tmp, f"stage{i}.yaml"),
                                            cs.RECIPE_STEPS, {})
                    if i == 2:
                        break
                    prev = res.snapshot["path"]
                    del res
                    gc.collect()
                    torch.cuda.empty_cache()
                print(f"[{label}] stages trained in {time.perf_counter() - t0:.1f} s; stage 2 "
                      f"entered from {prev}", flush=True)
                kw = {k: c[k] for k in ("G_kwargs", "D_kwargs", "loss_kwargs", "G_opt_kwargs",
                                        "D_opt_kwargs")}
                ev = Evaluation(res.trainer, res.state, lambda: build_trainer(
                    **kw, device="cuda", compute_dtype="float32", batch_size=cs.RECIPE_BATCH,
                    allow_random_lpips=True), label)
            medians = {}
            for trial in range(args.trials):
                for name, med in ev.trial(trial, args.gate_only, args.perturb,
                                          args.noise).items():
                    medians.setdefault(name, []).append(med)
            print(f"[{label}] on {card}: median over {args.trials} trials of each path's gated "
                  "median: " + "; ".join(
                      f"{n} {statistics.median(m[0] for m in v):.3f} (max "
                      f"{max(m[0] for m in v):.3f}; old reading {statistics.median(m[1] for m in v):.3f},"
                      f" max {max(m[1] for m in v):.3f})" for n, v in medians.items()), flush=True)
            for name, v in medians.items():
                for t, m in enumerate(v):
                    readings.setdefault(name, []).append((chain, t) + m)
            fails = [t for t, m in enumerate(medians["kernels"]) if m[0] > cs.TRUTH_FACTOR]
            failing += [(chain, t) for t in fails]
            for trial in ([] if args.gate_only else sorted({0, *fails})):
                bad_sites += [(chain, trial, s) for s in ev.revisit(trial)]
            for name, c in ev.counts.items():
                counts = totals.setdefault(name, dict.fromkeys(c, 0))
                for k, v in c.items():
                    counts[k] += v
            ev.close()
            del ev, res
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(f"[chain {chain}] {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[determinism-probe] on {card}: (chain, trial) failing the gate: {failing} of "
          f"{chains} x {args.trials}; kernel calls past a twin's bound on the revisited "
          f"batches: {len(bad_sites)}", flush=True)
    for name, c in totals.items():
        print(f"[determinism-probe] {name} on {card}: {c['batches']} readings; the median "
              f"past {cs.TRUTH_FACTOR} on {c['median']}, the guard (noise_strength through "
              f"its map) on {c['guard']}, the guard on the scalars themselves on "
              f"{c['scalar_guard']}", flush=True)
    lim = cs.TRUTH_FACTOR
    for name, rows in readings.items():
        new_fail = [r[:2] for r in rows if r[2] > lim]
        old_fail = [r[:2] for r in rows if r[3] > lim]
        print(f"[determinism-probe] {name} on {card}: {len(rows)} batches; gated reading (loss "
              f"terms, gradient tensors) failed {len(new_fail)} {new_fail}, median "
              f"{statistics.median(r[2] for r in rows):.3f}, max {max(r[2] for r in rows):.3f}; "
              f"old reading (loss terms, per-module gradient norms) failed {len(old_fail)} "
              f"{old_fail}, median {statistics.median(r[3] for r in rows):.3f}, max "
              f"{max(r[3] for r in rows):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

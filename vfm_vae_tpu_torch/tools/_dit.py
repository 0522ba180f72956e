"""What the latent-diffusion tools share: the DiT from a tool YAML (port of
tools/preprocess_for_lightningdit/sample.py:21 build_dit, one size map for
the trainer and the sampler, with the dev size "T"), the REG SiT and its
REPA projector (tools/preprocess_for_reg/train.py:68 build_reg), the
flow-matching trainer (AdamW, EMA 0.9999) and its loop, and the sampler
CLI that both samplers run.

The trainers run in one process or, under torchrun, in several
(parallel/mesh.py, tools/preprocess_for_lightningdit/train.py:107-156):
every process draws the same global batch from the seeded numpy generator
and the same draws (time, noise, class dropout, the posterior's noise) for
the whole of it, takes its 1/world slice, and the gradients are averaged
over the processes; AdamW and the EMA run replicated and rank 0 writes the
snapshots. The JAX trainers hand every process the whole global batch,
which shard_batch then takes as that process's slice (mesh.py:110-127), so
the batch they step is world x global_batch_size with duplicates; the port
steps global_batch_size.

Precision: the JAX trainers compute in fp32, so these tools build fp32
models and keep TF32 off (entry.configure_precision).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

# model_type size -> (hidden, depth, heads); "T" is a dev/test size with no
# reference counterpart.
SIZES = {"XL": (1152, 28, 16), "L": (1024, 24, 16), "B": (768, 12, 12), "T": (64, 2, 4)}
EMA_DECAY, EMA_STEP = 0.9999, 0.0001


def init_model(module: torch.nn.Module, seed: int, device) -> torch.nn.Module:
    """Draw `module`'s parameters from a generator on `device` seeded `seed`."""
    from ..models.layers import init_parameters

    init_parameters(module, torch.Generator(device=device).manual_seed(seed))
    return module


def build_dit(cfg: dict, device="cpu", depth: Optional[int] = None):
    """LightningDiT from a tool YAML (model_type 'LightningDiT-<size>/<p>';
    `depth` overrides the size's), parameters drawn from a generator
    seeded 0. Returns (model, input_size, in_chans, num_classes)."""
    from ..models.dit import LightningDiT

    mcfg, dcfg = cfg.get("model", {}), cfg.get("data", {})
    mt = mcfg.get("model_type", "LightningDiT-XL/1")
    hidden, size_depth, heads = SIZES[mt.split("-")[1].split("/")[0]]
    depth = depth or size_depth
    input_size = dcfg.get("image_size", 256) // cfg.get("vae", {}).get("downsample_ratio", 16)
    in_chans = mcfg.get("in_chans", 32)
    num_classes = dcfg.get("num_classes", 1000)
    model = LightningDiT(
        input_size=input_size, patch_size=int(mt.split("/")[1]), in_channels=in_chans,
        hidden_size=hidden, depth=depth, num_heads=heads, num_classes=num_classes,
        use_qknorm=mcfg.get("use_qknorm", True), use_swiglu=mcfg.get("use_swiglu", True),
        use_rope=mcfg.get("use_rope", True), use_rmsnorm=mcfg.get("use_rmsnorm", True),
        device=device)
    return init_model(model, 0, device), input_size, in_chans, num_classes


def build_reg(cfg: dict, with_projector: Optional[bool] = None, device="cpu"):
    """SiT-style LightningDiT (no SwiGLU, RoPE or RMSNorm; qk-norm) and,
    with REPA, its projector from a REG YAML; the model taps `repa_block`
    when a projector is built. Parameters from generators seeded 0 (model)
    and 1 (projector). Returns (model, projector or None, input_size,
    in_chans, repa_weight)."""
    from ..models.dit import LightningDiT, REPAProjector

    mcfg, dcfg = cfg.get("model", {}), cfg.get("data", {})
    in_chans = mcfg.get("in_chans", 32)
    input_size = mcfg.get("latent_size", 16)
    repa_weight = float(mcfg.get("repa_weight", 0.0))
    if with_projector is None:
        with_projector = repa_weight > 0
    hidden = mcfg.get("hidden_size", 1152)
    model = LightningDiT(
        input_size=input_size, patch_size=1, in_channels=in_chans, hidden_size=hidden,
        depth=mcfg.get("depth", 28), num_heads=mcfg.get("num_heads", 16),
        num_classes=dcfg.get("num_classes", 1000), use_qknorm=mcfg.get("use_qknorm", True),
        use_swiglu=mcfg.get("use_swiglu", False), use_rope=mcfg.get("use_rope", False),
        use_rmsnorm=mcfg.get("use_rmsnorm", False),
        return_features_at=int(mcfg.get("repa_block", 8)) if with_projector else None,
        device=device)
    init_model(model, 0, device)
    projector = None
    if with_projector:
        projector = init_model(REPAProjector(hidden, int(mcfg.get("repa_target_dim", 1024)),
                                             device=device), 1, device)
    return model, projector, input_size, in_chans, repa_weight


def nest(flat: Dict[str, torch.Tensor], split: bool) -> dict:
    """A flat state dict; with `split`, {"dit": ..., "proj": ...} by the
    keys' first component (the REPA trainer's parameter tree)."""
    if not split:
        return dict(flat)
    out: Dict[str, dict] = {"dit": {}, "proj": {}}
    for k, v in flat.items():
        top, _, rest = k.partition(".")
        out[top][rest] = v
    return out


def snapshot_params(path: str):
    """(DiT state dict, projector state dict or None) of a trainer
    snapshot: `ema`, else `params`; a REPA snapshot's {"dit", "proj"} tree
    is split (the JAX LightningDiT sampler hands it to the model whole)."""
    from ..train.checkpoint import load_snapshot

    snap = load_snapshot(os.path.abspath(path))
    params = snap.get("ema") or snap.get("params")
    if params is None:
        raise FileNotFoundError(f"{path} holds neither ema.pt nor params.pt")
    if set(params) == {"dit", "proj"}:
        return params["dit"], params["proj"]
    return params, None


class DiTTrainer:
    """Flow-matching training: the DiT (with the REPA projector, a {"dit",
    "proj"} parameter tree), torch.optim.AdamW (the decoupled decay of
    optax.adamw) and an EMA of every parameter updated after each step as
    ema * 0.9999 + param * 0.0001. Draws (time, noise, class dropout; the
    posterior noise first for moments) come from `draws`, a torch.Generator
    on the device, unless `loss` is given them. Batches are global: under
    several processes each takes its slice after the draws, and the
    parameters start from rank 0's."""

    def __init__(self, model, projector, lr: float, betas: Tuple[float, float],
                 weight_decay: float, use_lognorm: bool, use_cosine_loss: bool,
                 repa_weight: float, draws: torch.Generator):
        from ..parallel.mesh import broadcast_modules

        self.model, self.projector = model, projector
        self.net = (torch.nn.ModuleDict({"dit": model, "proj": projector})
                    if projector is not None else model)
        broadcast_modules([self.net])
        self.opt = torch.optim.AdamW(self.net.parameters(), lr=lr, betas=betas, eps=1e-8,
                                     weight_decay=weight_decay)
        self.ema = {n: p.detach().clone() for n, p in self.net.named_parameters()}
        self.use_lognorm, self.use_cosine_loss = use_lognorm, use_cosine_loss
        self.repa_weight, self.draws = repa_weight, draws

    def model_fn(self, x, t, y, drop):
        if self.projector is not None:
            out, tap = self.model(x, t, y, drop)
            return out, self.projector(tap)
        return self.model(x, t, y, drop)

    def draw(self, z: torch.Tensor):
        from ..train.transport import draw_flow_matching

        return draw_flow_matching(self.draws, z.shape, self.use_lognorm,
                                  self.model.class_dropout_prob, z.device)

    def loss(self, z, y, repa_targets=None, draws=None):
        """The loss of this process's slice of the global batch `z`, `y`
        (and `repa_targets`), with the draws made for the whole of it."""
        from ..parallel.mesh import rank_slice
        from ..train.transport import flow_matching_loss

        t, noise, drop = draws if draws is not None else self.draw(z)
        part = lambda x: None if x is None else rank_slice(x)  # noqa: E731
        targets = repa_targets if self.projector is not None else None
        return flow_matching_loss(self.model_fn, part(z), part(y), part(t), part(noise),
                                  part(drop), self.use_lognorm, self.use_cosine_loss,
                                  part(targets), self.repa_weight)[0]

    def step(self, z, y, repa_targets=None) -> torch.Tensor:
        """One AdamW step on the flow-matching loss of the global batch of
        latents `z` (NHWC) and labels `y`, then the EMA; returns the loss
        (detached; the mean over the processes)."""
        from ..parallel.mesh import mean_across

        loss = self.loss(z, y, repa_targets)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.update()
        return mean_across(loss.detach())

    def update(self) -> None:
        """The gradients averaged over the processes, AdamW, then the EMA."""
        from ..parallel.mesh import all_reduce_mean

        params = [p for p in self.net.parameters() if p.grad is not None]
        for p, g in zip(params, all_reduce_mean([p.grad for p in params])):
            p.grad = g
        self.opt.step()
        with torch.no_grad():
            for n, p in self.net.named_parameters():
                self.ema[n].mul_(EMA_DECAY).add_(p * EMA_STEP)

    def posterior(self, moments: torch.Tensor) -> torch.Tensor:
        """z = mean + std * eps of (mean || std) moments on the last axis,
        eps drawn from `draws`."""
        mean, std = moments.chunk(2, dim=-1)
        return mean + std * torch.randn(mean.shape, generator=self.draws, device=mean.device)

    def snapshot_state(self) -> dict:
        split = self.projector is not None
        params = {n: p.detach() for n, p in self.net.named_parameters()}
        return {"params": nest(params, split), "ema": nest(self.ema, split)}


def start_processes(device: str, tool: str):
    """The trainer's device and whether this call made the process group:
    under torchrun (WORLD_SIZE above 1) the group joins here (NCCL on
    cuda:LOCAL_RANK, gloo on the CPU) and fails loudly when its rendezvous
    cannot be reached, rather than training alone."""
    from ..parallel.mesh import init_processes
    from ._generator import resolve_device

    return init_processes(resolve_device(device, tool))


def train_loop(tool: str, trainer: DiTTrainer, batches: Iterator, step_args: Callable,
               max_steps: int, log_every: int, ckpt_every: int, out_dir: str,
               made_group: bool = False) -> dict:
    """The trainers' loop: step_args(batch) -> the trainer's step arguments,
    a JSON line {"step", "loss", "sec"} at every log_every-th step, a
    snapshot {"params", "ema"} at every ckpt_every-th step after step 0
    (rank 0 writes it, the others wait for it). Under several processes it
    ends with the replica check; a group this call made is taken down.
    Returns {"losses", "snapshots", "out_dir", "trainer"}."""
    from ..core.logging import print0
    from ..parallel import mesh
    from ..train.checkpoint import save_snapshot, snapshot_name

    rank = mesh.rank_and_world()[0]
    dev = next(trainer.net.parameters()).device
    os.makedirs(out_dir, exist_ok=True)
    losses, snapshots = [], []
    t0 = time.time()
    try:
        for step_idx in range(max_steps):
            loss = trainer.step(*step_args(next(batches)))
            losses.append(float(loss))
            if step_idx % log_every == 0:
                print0(json.dumps({"step": step_idx, "loss": losses[-1],
                                   "sec": time.time() - t0}), flush=True)
            if step_idx > 0 and step_idx % ckpt_every == 0:
                if rank == 0:
                    save_snapshot(out_dir, step_idx, trainer.snapshot_state())
                mesh.barrier(dev)
                snapshots.append(os.path.abspath(os.path.join(out_dir,
                                                              snapshot_name(step_idx))))
        mesh.check_replica_consistency({
            **{"params." + n: p for n, p in trainer.net.named_parameters()},
            **{"ema." + n: e for n, e in trainer.ema.items()}})
    finally:
        if made_group:
            import torch.distributed as dist

            dist.destroy_process_group()
    print0(f"{tool}: training done", flush=True)
    return dict(losses=losses, snapshots=snapshots, out_dir=out_dir, trainer=trainer)


def tool_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def sample_parser(description: str, mode: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--config", required=True, help="the DiT's tool YAML")
    ap.add_argument("--dit-snapshot", required=True)
    ap.add_argument("--vae-config", required=True, help="the tokenizer's YAML config")
    ap.add_argument("--vae-snapshot", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--num", type=int, default=50000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--cfg", type=float, default=1.0)
    ap.add_argument("--mode", choices=["ode", "sde"], default=mode)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def sample_latents(model_fn: Callable, gen: torch.Generator, labels: torch.Tensor, shape,
                   mode: str, steps: int, cfg: float) -> torch.Tensor:
    """One batch of the sampler from `gen`: the start noise, then (SDE)
    each step's noise."""
    from ..train.transport import ode_euler_sample, sde_sample

    x = torch.randn(shape, generator=gen, device=labels.device)
    if mode == "ode":
        return ode_euler_sample(model_fn, x, labels, steps, cfg)
    return sde_sample(model_fn, x, lambda i: torch.randn(shape, generator=gen, device=x.device),
                      labels, steps, cfg)


def sample_main(argv: Optional[Sequence[str]], tool: str, reg: bool, mode: str) -> dict:
    """The samplers: DiT from its snapshot (ema, else params; a REPA
    snapshot's "dit" part), velocity -> latents (ODE Euler or SDE), the
    latents back to the tokenizer's space, G.decode, PNGs {idx:06d}.png.

    LightningDiT (reg False) undoes the trainer's normalisation with the
    stats of data.data_path: z / latent_multiplier * std + mean. The REG
    trainer trains on raw posterior samples, so the REG sampler decodes z as
    it is. Indices split across processes by RANK and WORLD_SIZE; labels,
    start noise and step noise come from a torch.Generator on the device
    seeded with the rank. Returns {images, seconds, setup_s, dit_s,
    decode_s, host_s, images_per_s, latents (the sampled z, on the host),
    paths}."""
    import PIL.Image

    from ..core.profiling import PhaseTimer
    from ..parallel.serving import batched, process_shard, rank_and_world
    from ._generator import build_generator, resolve_device
    from .decode_latents_to_images import to_uint8

    args = sample_parser(f"{tool}: sample a DiT and decode through the tokenizer.",
                         mode).parse_args(argv)
    dev = resolve_device(args.device, tool)
    t0 = time.perf_counter()
    cfg = tool_config(args.config)
    sd, _ = snapshot_params(args.dit_snapshot)
    if reg:
        model, _, input_size, in_chans, _ = build_reg(cfg, with_projector=False, device=dev)
        num_classes = cfg.get("data", {}).get("num_classes", 1000)
        mean = std = None
        mult = 1.0
    else:
        model, input_size, in_chans, num_classes = build_dit(cfg, dev)
        mean, std, mult = latent_stats(cfg.get("data", {}), in_chans, dev)
    model.load_state_dict(sd)
    G, _ = build_generator(args.vae_config, args.vae_snapshot, dev)
    setup_s = time.perf_counter() - t0

    rank, _ = rank_and_world()
    gen = torch.Generator(device=dev).manual_seed(rank)
    timer, host = PhaseTimer(dev), PhaseTimer("cpu")
    os.makedirs(args.out, exist_ok=True)
    paths, zs = [], []
    for idx in batched(process_shard(range(args.num)), args.batch):
        shape = (len(idx), input_size, input_size, in_chans)
        with timer.phase("dit"):
            labels = torch.randint(0, num_classes, (len(idx),), generator=gen, device=dev)
            z = sample_latents(lambda x, t, y, d: model(x, t, y, d), gen, labels, shape,
                               args.mode, args.steps, args.cfg)
        zs.append(z.cpu())
        with timer.phase("decode"), torch.no_grad():
            img = G.decode(z if mean is None else z / mult * std + mean).float()
        with host.phase("host"):
            imgs = to_uint8(img.cpu().numpy())
            for j, i in enumerate(idx):
                paths.append(os.path.join(args.out, f"{i:06d}.png"))
                PIL.Image.fromarray(imgs[j]).save(paths[-1])
        print(f"{len(paths)}/{args.num}", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = wall - setup_s
    out = dict(images=len(paths), seconds=wall, setup_s=setup_s, dit_s=timer.total("dit"),
               decode_s=timer.total("decode"), host_s=host.total("host"),
               images_per_s=len(paths) / run if run > 0 else 0.0,
               latents=torch.cat(zs) if zs else None, paths=paths)
    print(f"[{tool}] wrote {len(paths)} samples to {args.out} in {wall:.2f} s: setup "
          f"{setup_s:.2f} s, then {out['images_per_s']:.2f} img/s; DiT {out['dit_s']:.3f} s, "
          f"decode {out['decode_s']:.3f} s ({'cuda events' if dev.type == 'cuda' else 'host clock'}), "
          f"PNG work {out['host_s']:.3f} s", flush=True)
    return out


def latent_stats(dcfg: dict, in_chans: int, device):
    """(mean, std, latent_multiplier) of a LightningDiT data section, as
    NHWC-broadcastable tensors: latents_stats.npz of data_path when it is
    there and latent_norm is on, else 0 and 1."""
    path = os.path.join(dcfg.get("data_path", "."), "latents_stats.npz")
    if os.path.isfile(path) and dcfg.get("latent_norm", True):
        st = np.load(path)
        mean = st["mean"].astype(np.float32).transpose(0, 2, 3, 1)
        std = st["std"].astype(np.float32).transpose(0, 2, 3, 1)
    else:
        mean = np.zeros((1, 1, 1, in_chans), np.float32)
        std = np.ones_like(mean)
    mult = float(dcfg.get("latent_multiplier", 1.0))
    return (torch.from_numpy(np.ascontiguousarray(mean)).to(device),
            torch.from_numpy(np.ascontiguousarray(std)).to(device), mult)

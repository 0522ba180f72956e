"""The training loop (port of vfm_vae_tpu/train/loop.py; reference
training/training_loop.py:462-881).

Per batch a D step and a G step (train_step.Trainer) with EQ buckets drawn
on the host from one numpy generator (eq_d, then eq_g); per tick a status
line, a `stats.jsonl` record with the EQ tally, network snapshots
(train/checkpoint.py) and image grids under `train_samples/`. Resume is
strict first, then the loose merge by name and shape; Adam's state is kept
by parameter name, so a train_mode change between stages carries the
moments and step counts of the parameters that stay trainable.

At each snapshot tick the configured `metrics` run (loop.py:575-636):
`recon_suite` (PSNR, SSIM and, with the loss's LPIPS, LPIPS) over
`in_loop_metric_batches` streamed batches reconstructed by G_ema, written
to metric-<name>.jsonl (and wandb) with the number of images stamped in;
any other name is warned about and skipped (the offline tools run them).

`batch_size` is the global batch (configs/vfm_vae_details.yaml:125-126).
Under several processes (a torch.distributed group, parallel/mesh.py) each
process loads `batch_size // world` images from its own shards and steps
them in `accumulate_gradients` microbatches; G and D start from rank 0's
weights, the gradients are averaged over the processes, and rank 0 alone
writes stats.jsonl, the grids and the snapshots (behind a barrier), while
every process resumes from the same snapshot. The in-loop metrics run in a
single process only, as in the JAX package (loop.py:578-581). The run ends
with check_replica_consistency over G, G_ema and D. D's BatchNormLocal
groups each microbatch by virtual_bs, so a split batch matches the unsplit
one where every process's microbatch is a multiple of it.

G's `remat` defaults as in the JAX loop (loop.py:146-149): "dots" up to 12
images per process and microbatch, "full" above.

The discriminator warm-ups (train/warmup.py) take each step's pixel and
StyleGAN-T generator loss means, summed over the processes first, while a
warm-up waits (loop.py:375-379, 472-481). Each step's D input blur is the
loss's blur_sigma at the step's cur_nimg (the reference's schedule; the
JAX loop leaves it at 0). In discrete mode the snapshot's `G_counters`
entry carries the VQ usage record counters, which are not in the
reference state_dict layout. Not ported, and refused before anything is
built: fused phases.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.logging import format_time, print0, process_count, process_index
from ..core.profiling import PhaseTimer, device_memory_stats, host_memory_stats
from ..core.registry import construct_class_by_name, get_class_by_name
from ..core.stats import Collector, sync_across_processes
from ..core.summary import module_summary
from ..core.wandb_sink import WandbSink
from ..models.adapter import EquivarianceTransform
from ..models.generator import trainable_names, trainable_path_predicates
from ..parallel.mesh import (
    barrier,
    broadcast_modules,
    check_replica_consistency,
    local_device,
)
from .checkpoint import (
    flat_keys,
    grouped_keys,
    load_snapshot,
    merge_loaded,
    report_key_diff,
    save_snapshot,
    snapshot_bytes,
    snapshot_name,
)
from .loss import LossState
from .optim import adam
from .train_step import Trainer, TrainState
from .warmup import WarmupFSM


def save_image_grid(images: np.ndarray, path: str, drange=(-1, 1), grid_wh=None) -> None:
    """(reference: training_loop.py:146-194) NHWC batch -> PNG grid."""
    import PIL.Image

    lo, hi = drange
    img = (images - lo) * (255 / (hi - lo))
    img = np.rint(img).clip(0, 255).astype(np.uint8)
    B, H, W, C = img.shape
    if grid_wh is None:
        gw = int(np.ceil(np.sqrt(B)))
        gh = int(np.ceil(B / gw))
    else:
        gw, gh = grid_wh
    canvas = np.zeros((gh * H, gw * W, C), np.uint8)
    for i in range(B):
        y, x = divmod(i, gw)
        canvas[y * H : (y + 1) * H, x * W : (x + 1) * W] = img[i]
    PIL.Image.fromarray(canvas).save(path)


def make_eq_transform(G_kwargs: Dict[str, Any], loss_kwargs: Dict[str, Any]) -> EquivarianceTransform:
    """The loop's EQ bucket sampler (loop.py:315-319)."""
    return EquivarianceTransform(
        apply=bool(loss_kwargs.get("use_equivariance_regularization", False)),
        p_eq_prior=G_kwargs.get("equivariance_regularization_p_prior", 0.5),
        p_eq_prior_scale=G_kwargs.get("equivariance_regularization_p_prior_scale", 0.25),
    )


def _opt_kwargs(kwargs: Dict[str, Any]) -> dict:
    if get_class_by_name(kwargs.get("class_name", "torch.optim.Adam")) is not adam:
        raise NotImplementedError(f"optimizer {kwargs['class_name']!r} is not ported")
    return dict(lr=float(kwargs.get("lr", 1e-4)), betas=tuple(kwargs.get("betas", (0.0, 0.99))),
                eps=float(kwargs.get("eps", 1e-8)))


def build_trainer(G_kwargs: Dict[str, Any], D_kwargs: Dict[str, Any],
                  loss_kwargs: Dict[str, Any], G_opt_kwargs: Dict[str, Any],
                  D_opt_kwargs: Dict[str, Any], *, device, compute_dtype: str = "bfloat16",
                  random_seed: int = 42, batch_size: int = 512, ema_kimg: float = 160.0,
                  ema_rampup: Optional[float] = 0.05, accumulate_gradients: int = 1,
                  total_kimg: int = 0, lpips_ckpt: Optional[str] = None,
                  allow_random_lpips: bool = False) -> Trainer:
    """G, D, LPIPS, the loss, the trainable sets and the optimiser settings
    from a derived config's kwargs (loop.py:134-272), through the registry.
    G's parameters are drawn from a generator seeded `random_seed`, D's
    from `random_seed` + 1, random LPIPS weights from 0."""
    from ..entry import configure_precision
    from .lpips import build_lpips

    configure_precision()
    dev = torch.device(device)
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    gk = {k: v for k, v in G_kwargs.items() if k != "class_name"}
    G = construct_class_by_name(
        class_name=G_kwargs.get("class_name", "networks.generator.Generator"), dtype=dtype,
        device=dev, generator=torch.Generator(device=dev).manual_seed(random_seed), **gk)
    dk = {k: v for k, v in D_kwargs.items() if k != "class_name"}
    dk.setdefault("c_dim", 0)
    dk.setdefault("vfm_name", G_kwargs.get("vfm_name", "siglip2"))
    D = construct_class_by_name(
        class_name=D_kwargs.get("class_name", "networks.discriminator.ProjectedDiscriminator"),
        compute_dtype=dtype, device=dev,
        generator=torch.Generator(device=dev).manual_seed(random_seed + 1), **dk)

    # class_name is registry plumbing; vfm_name follows G (derive_config
    # back-fills it into loss_kwargs too).
    lk = {k: v for k, v in loss_kwargs.items() if k not in ("class_name", "vfm_name")}
    lpips = None
    if float(lk.get("perceptual_loss_weight", 0.0)) > 0:
        seed0 = torch.Generator(device=dev).manual_seed(0)
        try:
            lpips = build_lpips(dev, lpips_ckpt, generator=seed0)
        except Exception as e:
            # Random LPIPS trains against a meaningless perceptual loss:
            # refuse unless asked for (tests, smoke runs).
            if not allow_random_lpips:
                raise RuntimeError(
                    f"LPIPS weights unavailable ({e}); set lpips_ckpt to a local vgg.pth, or "
                    "allow_random_lpips: true to run with random-init LPIPS") from e
            print0(f"[warn] LPIPS weights unavailable ({e}); allow_random_lpips=True -> "
                   "random-init LPIPS")
            lpips = build_lpips(dev, allow_random_lpips=True, generator=seed0)
    loss = construct_class_by_name(
        G, D, class_name=loss_kwargs.get("class_name", "training.loss.TotalLoss"),
        vfm_name=G_kwargs.get("vfm_name", "siglip2"), lpips_module=lpips,
        total_kimg=total_kimg, **lk)

    # The adaptive VF weight's anchor is Generator.vf_anchor(), the path
    # loop.py:252-261 picks for attnproj compression.
    preds = trainable_path_predicates(
        G_kwargs.get("train_mode", "train_all"),
        block_resolutions=G.synthesis.block_resolutions,
        concat_z_block_indices=G.synthesis.concat_z)
    g_trainable = trainable_names(G, preds)
    d_trainable = {n for n, _ in D.named_parameters() if not n.startswith("dino.")}
    return Trainer(loss, g_trainable, d_trainable, _opt_kwargs(G_opt_kwargs),
                   _opt_kwargs(D_opt_kwargs), batch_size=batch_size, ema_kimg=ema_kimg,
                   ema_rampup=ema_rampup, num_accumulation=accumulate_gradients)


# ------------------------------------------------------------------ state


def g_counters(G: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """G's buffers outside the reference state_dict layout that training
    moves: the VQ codebooks' usage record counters (none in continuous mode)."""
    return {n: b for n, b in G.named_buffers() if n.endswith("usage_record_times")}


def adam_state_by_name(opt: torch.optim.Adam, params: Dict[str, torch.nn.Parameter]) -> dict:
    """Adam's per-parameter state keyed by parameter name (torch keys it by index)."""
    return {n: dict(opt.state[p]) for n, p in params.items() if p in opt.state}


def snapshot_state(trainer: Trainer, state: TrainState) -> dict:
    """What a snapshot holds (the JAX TrainState's fields): G's and D's
    parameters and buffers, G_ema (G with the EMA of its trainable
    parameters), both Adam states by name, the loss state and cur_nimg."""
    g = trainer.G.state_dict()
    return {
        "G": g,
        "G_counters": g_counters(trainer.G),
        "D": trainer.D.state_dict(),
        "G_ema": {**g, **state.ema},
        "g_opt": adam_state_by_name(state.g_opt, trainer.g_params),
        "d_opt": adam_state_by_name(state.d_opt, trainer.d_params),
        "loss_state": {"prev_g_loss": state.loss_state.prev_g_loss,
                       "has_prev": state.loss_state.has_prev},
        "cur_nimg": int(state.cur_nimg),
    }


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _template(trainer: Trainer, state: TrainState) -> dict:
    """The snapshot layout this run expects, with shape-only (meta) leaves:
    after merge_loaded, a leaf still on the meta device came fresh."""
    g = {k: _meta(v) for k, v in trainer.G.state_dict().items()}

    def opt(params):
        return {n: {"step": torch.empty((), device="meta"), "exp_avg": _meta(p),
                    "exp_avg_sq": _meta(p)} for n, p in params.items()}

    return {
        "G": g,
        "G_counters": {k: _meta(v) for k, v in g_counters(trainer.G).items()},
        "D": {k: _meta(v) for k, v in trainer.D.state_dict().items()},
        "G_ema": dict(g),
        "g_opt": opt(trainer.g_params),
        "d_opt": opt(trainer.d_params),
        "loss_state": {"prev_g_loss": _meta(state.loss_state.prev_g_loss),
                       "has_prev": _meta(state.loss_state.has_prev)},
        "cur_nimg": int(state.cur_nimg),
    }


def _is_fresh(v) -> bool:
    return isinstance(v, torch.Tensor) and v.is_meta


@torch.no_grad()
def resume_from(trainer: Trainer, state: TrainState, path: str,
                resume_discriminator: bool = True) -> dict:
    """Load a snapshot into the trainer's modules and `state`: strictly when
    its names and shapes are this run's, else loosely (merge_loaded), each
    tensor where its name and shape match. Returns what happened:
    {path, strict, fresh (names kept as initialised), unexpected, seconds}."""
    t0 = time.perf_counter()
    loaded = load_snapshot(path)
    template = _template(trainer, state)
    want, got = flat_keys(template), flat_keys(loaded)
    strict = set(want) == set(got) and all(np.shape(want[k]) == np.shape(got[k]) for k in want)
    unexpected: List[str] = []
    if not strict:
        print0("[resume] strict restore failed (names or shapes differ); merging loosely")
        _, unexpected = report_key_diff(loaded, template)
    merged = merge_loaded(template, loaded)
    if not resume_discriminator:
        merged["D"], merged["d_opt"] = template["D"], template["d_opt"]

    for key, module in (("G", trainer.G), ("D", trainer.D)):
        own = module.state_dict()
        for k, v in merged[key].items():
            if not _is_fresh(v):
                own[k].copy_(v)
    counters = g_counters(trainer.G)
    for k, v in merged["G_counters"].items():
        if not _is_fresh(v):
            counters[k].copy_(v)
    for n, e in state.ema.items():
        v = merged["G_ema"][n]
        if not _is_fresh(v):
            e.copy_(v)
    for key, opt, params in (("g_opt", state.g_opt, trainer.g_params),
                             ("d_opt", state.d_opt, trainer.d_params)):
        for n, p in params.items():
            st = merged[key][n]
            if not any(_is_fresh(v) for v in st.values()):
                opt.state[p] = {"step": st["step"].detach().to("cpu", torch.float32).clone(),
                                "exp_avg": st["exp_avg"].to(p.device, p.dtype).clone(),
                                "exp_avg_sq": st["exp_avg_sq"].to(p.device, p.dtype).clone()}
    ls = merged["loss_state"]
    if not any(_is_fresh(v) for v in ls.values()):
        dev = state.loss_state.prev_g_loss.device
        state.loss_state = LossState(ls["prev_g_loss"].to(dev), ls["has_prev"].to(dev))
    state.cur_nimg = int(merged["cur_nimg"])
    fresh = sorted(k for k, v in flat_keys(merged).items() if _is_fresh(v))
    return dict(path=path, strict=strict, fresh=fresh, unexpected=unexpected,
                seconds=time.perf_counter() - t0)


@contextlib.contextmanager
def ema_weights(G: torch.nn.Module, ema: Dict[str, torch.Tensor]):
    """G's trainable parameters swapped for their EMA inside the block."""
    params = dict(G.named_parameters())
    saved = {n: params[n].detach().clone() for n in ema}
    with torch.no_grad():
        for n, e in ema.items():
            params[n].copy_(e)
    try:
        yield G
    finally:
        with torch.no_grad():
            for n, v in saved.items():
                params[n].copy_(v)


def in_loop_metrics(metrics, trainer: Trainer, state: TrainState, data_iter, batches: int,
                    run_dir: str, snapshot_path: Optional[str], wandb_sink: WandbSink,
                    step: int) -> None:
    """The snapshot tick's metrics (loop.py:575-636): recon_suite over
    `batches` streamed batches, each reconstructed by G_ema with the
    posterior sampled from a generator seeded 0 (the JAX loop's
    PRNGKey(0)), against the loss's LPIPS when it has one; the record
    carries num_val_images. A small trend, not the offline evaluation."""
    from ..metrics import metric_main

    G = trainer.G
    dev = next(G.parameters()).device
    for name in metrics:
        if not metric_main.is_valid_metric(name):
            print0(f"[warn] unknown metric '{name}'; have {metric_main.list_metrics()}")
            continue
        if name != "recon_suite":
            print0(f"[warn] metric '{name}' is offline-only (vfm_vae_tpu_torch.tools.evaluate, "
                   "fidelity, evaluate_npz); skipped in-loop")
            continue
        pairs = []
        with ema_weights(G, state.ema), torch.no_grad():
            for _ in range(batches):
                imgs, _ = next(data_iter)
                real = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev).float() / 255.0
                gen = G(real, generator=torch.Generator(device=dev).manual_seed(0)).gen_img
                pairs.append((real, (gen.float() + 1) / 2))
        res = metric_main.calc_metric(name, pairs=pairs, lpips_module=trainer.loss.lpips,
                                      device=dev)
        res["results"]["num_val_images"] = int(sum(p[0].shape[0] for p in pairs))
        metric_main.report_metric(res, run_dir=run_dir, snapshot_pkl=snapshot_path)
        wandb_sink.log_metrics(res["results"], step=step)


def warmup_inputs(g_stats) -> tuple:
    """The warm-up machine's inputs from a G step's stats (loop.py:472-481):
    the pixel loss's and the StyleGAN-T generator loss's means, over every
    process (so every process flips at the same step)."""
    names = ("Loss/G/l1_pixel_loss", "Loss/G/l2_pixel_loss", "Loss/G/stylegan_t/loss")
    synced = sync_across_processes({n: g_stats[n] for n in names if n in g_stats})
    pix = synced.get(names[0], synced.get(names[1]))
    dgan = synced.get(names[2])

    def mean(m):
        return float(m[1] / max(float(m[0]), 1)) if m is not None else 0.0

    return mean(pix), mean(dgan)


@dataclass
class LoopResult:
    """What training_loop returns: the trainer (its modules hold the trained
    parameters) and its state, the resume report (None without a resume)
    and the last snapshot ({path, bytes, seconds}), and the warm-up machine."""

    trainer: Trainer
    state: TrainState
    resume: Optional[dict] = None
    snapshot: Optional[dict] = None
    warmup: Optional[WarmupFSM] = None


# ------------------------------------------------------------------ loop


def training_loop(
    run_dir: str,
    training_set_kwargs: Dict[str, Any],
    G_kwargs: Dict[str, Any],
    D_kwargs: Dict[str, Any],
    loss_kwargs: Dict[str, Any],
    G_opt_kwargs: Dict[str, Any],
    D_opt_kwargs: Dict[str, Any],
    batch_size: int = 512,
    accumulate_gradients: int = 1,
    kimg_per_tick: int = 10,
    image_snapshot_ticks: int = 100,
    network_snapshot_ticks: int = 100,
    total_kimg: int = 20000,
    ema_kimg: float = 160.0,
    ema_rampup: Optional[float] = 0.05,
    random_seed: int = 42,
    resume_path: Optional[str] = None,
    resume_kimg: int = 0,
    resume_discriminator: bool = True,
    lpips_ckpt: Optional[str] = None,
    allow_random_lpips: bool = False,
    metrics=(),
    in_loop_metric_batches: int = 2,
    abort_fn=None,
    max_steps: Optional[int] = None,
    data_workers: int = 3,
    device="cuda",
    compute_dtype: str = "bfloat16",
    wandb_project_name: Optional[str] = None,
    wandb_run_name: Optional[str] = None,
    fused_phases: bool = False,
    **unused_kwargs,
) -> LoopResult:
    start_time = time.time()
    rank, num_processes = process_index(), process_count()
    if fused_phases:
        raise NotImplementedError("training_loop: not ported for ['fused_phases']")
    dev = local_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training_loop: no CUDA device; pass device='cpu' to train on the CPU")

    if batch_size % num_processes or (batch_size // num_processes) % accumulate_gradients:
        raise ValueError(f"global batch {batch_size} does not split into {num_processes} "
                         f"processes x {accumulate_gradients} microbatches")
    per_process = batch_size // num_processes
    G_kwargs = dict(G_kwargs)
    G_kwargs.setdefault("remat", "dots" if per_process // accumulate_gradients <= 12 else "full")

    # EQ buckets: one host generator, eq_d then eq_g each step (loop.py:441-452),
    # the same draws on every process; G's and D's own draws (posterior
    # sample, DiffAugment, crop) come from a torch generator on the device,
    # seeded per process as the reference seeds them.
    np_rng = np.random.default_rng(random_seed)
    draws = torch.Generator(device=dev).manual_seed(random_seed * num_processes + rank)

    print0("Loading training set...")
    training_set = construct_class_by_name(**training_set_kwargs)
    data_iter = iter(training_set.loader(batch_size=per_process, workers=data_workers,
                                         base_seed=random_seed, num_processes=num_processes,
                                         process_index=rank))
    stats_file = None
    try:
        print0("Constructing networks...")
        trainer = build_trainer(
            G_kwargs, D_kwargs, loss_kwargs, G_opt_kwargs, D_opt_kwargs, device=dev,
            compute_dtype=compute_dtype, random_seed=random_seed, batch_size=batch_size,
            ema_kimg=ema_kimg, ema_rampup=ema_rampup, accumulate_gradients=accumulate_gradients,
            total_kimg=total_kimg, lpips_ckpt=lpips_ckpt, allow_random_lpips=allow_random_lpips)
        G = trainer.G
        broadcast_modules([G, trainer.D])
        print0(module_summary(G, name="Generator"))
        print0(module_summary(trainer.D, name="Discriminator"))
        print0(f"[batch] {batch_size} images a step: {num_processes} process(es) x "
               f"{accumulate_gradients} microbatch(es) of "
               f"{per_process // accumulate_gradients}; remat {G_kwargs['remat']!r}")
        state = trainer.init_state(cur_nimg=int(resume_kimg * 1000))

        resume = None
        if resume_path:
            print0(f"Resuming from {resume_path} ...")
            resume = resume_from(trainer, state, os.path.abspath(resume_path),
                                 resume_discriminator)
            fresh = resume["fresh"]
            print0(f"[resume] {'strict' if resume['strict'] else 'loose'} load in "
                   f"{resume['seconds']:.2f} s; "
                   + (f"fresh: {grouped_keys(fresh, show=len(fresh))}" if fresh else "none fresh"))

        eq_transform = make_eq_transform(G_kwargs, loss_kwargs)
        warmup_fsm = WarmupFSM(trainer.loss)

        os.makedirs(os.path.join(run_dir, "train_samples"), exist_ok=True)
        stats_file = open(os.path.join(run_dir, "stats.jsonl"), "a") if rank == 0 else None
        collector = Collector()
        wandb_sink = WandbSink(
            wandb_project_name, wandb_run_name, run_dir,
            config={"batch_size_per_process": per_process,
                    "accumulation_steps": accumulate_gradients,
                    "process_count": num_processes, "lr of G": G_opt_kwargs.get("lr"),
                    "lr of D": D_opt_kwargs.get("lr"), "total_kimg": total_kimg},
            enabled=rank == 0)
        timer = PhaseTimer(dev)

        print0(f"Training for {total_kimg} kimg (resume at {resume_kimg})...")
        cur_nimg = int(resume_kimg * 1000)
        cur_tick = 0
        tick_start_nimg = cur_nimg
        tick_start_time = time.time()
        step_count = 0
        first_batch_saved = False
        # EQ-bucket tally per tick ("EQ/<scale>_<rot>_<prior>": count).
        eq_counts: Dict[str, int] = {}
        snapshot = None

        def draw_eq():
            eq = eq_transform(np_rng)
            if eq_transform.apply:
                k = f"EQ/{eq[0]}_{eq[1]}_{int(eq[2])}"
                eq_counts[k] = eq_counts.get(k, 0) + 1
            return eq

        while True:
            images, _ = next(data_iter)
            real = torch.from_numpy(np.ascontiguousarray(images)).to(dev, non_blocking=True)
            if not first_batch_saved and rank == 0:
                save_image_grid(np.asarray(images[:16], np.float32) / 255.0,
                                os.path.join(run_dir, "train_samples", "reals.png"),
                                drange=(0, 1))
                first_batch_saved = True

            blur = trainer.loss.blur_sigma(cur_nimg)
            eq_d = draw_eq()
            with timer.phase("Timing/D"):
                state, d_stats, _ = trainer.d_step(state, real, eq_d, draws, blur)
            eq_g = draw_eq()
            with timer.phase("Timing/G"):
                state, g_stats, _ = trainer.g_step(state, real, eq_g, draws, blur)
            if warmup_fsm.active:
                warmup_fsm.update(*warmup_inputs(g_stats), cur_nimg / 1000)

            step_count += 1
            cur_nimg += images.shape[0] * num_processes
            done = cur_nimg >= total_kimg * 1000 or (
                max_steps is not None and step_count >= max_steps)
            if abort_fn is not None and abort_fn():
                done = True
            if (cur_nimg < tick_start_nimg + kimg_per_tick * 1000) and not done:
                continue

            # ---- tick maintenance (the newest step's stats, as loop.py:500-501,
            # summed over the processes)
            collector.update(sync_across_processes(d_stats))
            collector.update(sync_across_processes(g_stats))
            tick_time = time.time() - tick_start_time
            total_time = time.time() - start_time
            sec_per_kimg = tick_time / max((cur_nimg - tick_start_nimg) / 1000, 1e-8)
            fields = [
                f"tick {cur_tick:<5d}",
                f"kimg {cur_nimg / 1000:<8.1f}",
                f"time {format_time(total_time):<12s}",
                f"sec/tick {tick_time:<7.1f}",
                f"sec/kimg {sec_per_kimg:<7.2f}",
            ]
            for name in ("Loss/G/l1_pixel_loss", "Loss/G/vf_loss", "Loss/D/stylegan_t/loss"):
                if name in collector.names():
                    fields.append(f"{name.split('/')[-1]} {collector.mean(name):.4f}")
            print0(" | ".join(fields))

            entry = {
                "Progress/tick": cur_tick,
                "Progress/kimg": cur_nimg / 1000,
                "Timing/total_sec": total_time,
                "Timing/sec_per_tick": tick_time,
                "Timing/sec_per_kimg": sec_per_kimg,
                "Timing/D": timer.mean("Timing/D"),
                "Timing/G": timer.mean("Timing/G"),
                "timestamp": time.time(),
            }
            entry.update(device_memory_stats(dev))
            entry.update(host_memory_stats())
            entry.update(eq_counts)
            eq_counts.clear()
            timer.reset()
            entry.update({name: collector.mean(name) for name in collector.names()})
            if stats_file is not None:
                stats_file.write(json.dumps(entry) + "\n")
                stats_file.flush()
                wandb_sink.log(entry, step=int(cur_nimg / 1e3))
            collector.reset()

            if network_snapshot_ticks and (cur_tick % network_snapshot_ticks == 0 or done):
                t0 = time.perf_counter()
                name = os.path.join(run_dir, snapshot_name(cur_nimg // 1000))
                if rank == 0:
                    exists = os.path.isdir(name)
                    path = save_snapshot(run_dir, cur_nimg // 1000,
                                         snapshot_state(trainer, state))
                    snapshot = dict(path=path, bytes=snapshot_bytes(path),
                                    seconds=time.perf_counter() - t0)
                    print0(f"Snapshot {path} exists: not written again" if exists else
                           f"Saved snapshot {path} ({snapshot['bytes']} bytes, "
                           f"{snapshot['seconds']:.2f} s)")
                # The others go on once the snapshot is whole on the disk.
                barrier(dev)
                if rank != 0:
                    path = os.path.abspath(name)
                    snapshot = dict(path=path, bytes=snapshot_bytes(path),
                                    seconds=time.perf_counter() - t0)

            if metrics and network_snapshot_ticks and num_processes == 1 and (
                    cur_tick % network_snapshot_ticks == 0 or done):
                in_loop_metrics(metrics, trainer, state, data_iter, in_loop_metric_batches,
                                run_dir, snapshot and snapshot["path"], wandb_sink,
                                step=int(cur_nimg / 1e3))

            if image_snapshot_ticks and (cur_tick % image_snapshot_ticks == 0 or done) \
                    and rank == 0:
                r8 = real[:8].float() / 255.0
                with ema_weights(G, state.ema), torch.no_grad():
                    gen = G(r8).gen_img.float().cpu().numpy()
                grid = np.concatenate([r8.cpu().numpy() * 2 - 1, gen], axis=0)
                save_image_grid(grid, os.path.join(run_dir, "train_samples",
                                                   f"val_gens_{cur_nimg // 1000:06d}.png"),
                                drange=(-1, 1), grid_wh=(r8.shape[0], 2))

            cur_tick += 1
            tick_start_nimg = cur_nimg
            tick_start_time = time.time()
            if done:
                break
        # The reference's check_ddp_consistency (loop.py:688-700): a silent
        # divergence between the replicas fails here.
        check_replica_consistency({
            **{"G." + n: p for n, p in G.named_parameters()},
            **{"G_ema." + n: e for n, e in state.ema.items()},
            **{"D." + n: p for n, p in trainer.D.named_parameters()}})
        if num_processes > 1:
            print0(f"[processes] replica consistency OK ({num_processes} processes)")
        wandb_sink.finish()
    finally:
        if stats_file is not None:
            stats_file.close()
        # Reap the loader's workers while the interpreter is fully alive.
        if hasattr(data_iter, "close"):
            data_iter.close()
    print0(f"Done. Total time: {format_time(time.time() - start_time)}")
    return LoopResult(trainer, state, resume, snapshot, warmup_fsm)

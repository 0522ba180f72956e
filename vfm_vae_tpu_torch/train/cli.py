"""Training CLI of the port (port of the JAX package's train.py; reference
train.py: YAML config, derivation pass, run-dir setup, auto-resume, the
training loop).

    python -m vfm_vae_tpu_torch.train.cli --config configs/<stage>.yaml \
        [--max-steps N] [--no-resume] [--device cuda|cpu]
    python -m torch.distributed.run --nproc-per-node N -m vfm_vae_tpu_torch.train.cli \
        --config configs/<stage>.yaml [--device cuda|cpu]

Under torchrun (WORLD_SIZE above 1) the processes join one group, NCCL on
the cards (process r on cuda:LOCAL_RANK) or gloo with --device cpu, and
the YAML's batch_size is split between them (train/loop.py). Rank 0 writes
log.txt and training_config.yaml; every process resumes the same snapshot.

The run directory (`run_dir` in the YAML) receives log.txt (everything
printed, appended across calls), training_config.yaml (the derived config
as run), stats.jsonl, train_samples/ and the network snapshots. Without
`resume_path` and without --no-resume, the newest snapshot in run_dir is
resumed. The stages chain through `resume_path`: each stage's YAML names
the previous stage's snapshot. --device defaults to the card and fails
without one.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import yaml


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Train the VFM-VAE tokenizer (PyTorch port).")
    parser.add_argument("--config", required=True, help="YAML config path")
    parser.add_argument("--max-steps", type=int, default=None, help="stop after N [D, G] steps")
    parser.add_argument("--no-resume", action="store_true", help="disable auto-resume")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from ..core.config import derive_config, load_config, to_plain
    from ..core.logging import Logger, print0
    from ..parallel import mesh
    from .checkpoint import find_latest_snapshot
    from .loop import training_loop

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train.cli: no CUDA device (--device cpu trains on the CPU)")
    device, made_group = mesh.init_processes(args.device)
    rank = mesh.rank_and_world()[0]
    c = derive_config(load_config(args.config))
    run_dir = c.get("run_dir", "runs/default")
    os.makedirs(run_dir, exist_ok=True)

    # The log tee comes first, so that the auto-resume decision is in
    # run_dir/log.txt: a restarted job's log says what it resumed from.
    logger = Logger(os.path.join(run_dir, "log.txt") if rank == 0 else None, mode="a")
    try:
        if not args.no_resume and not c.get("resume_path"):
            latest = find_latest_snapshot(run_dir)
            if latest is not None:
                c["resume_path"], c["resume_kimg"] = latest
                print0(f"[auto-resume] found {c['resume_path']} at {latest[1]} kimg")

        if rank == 0:
            with open(os.path.join(run_dir, "training_config.yaml"), "w") as f:
                yaml.safe_dump(to_plain(c), f, default_flow_style=False)

        return training_loop(
            run_dir=run_dir,
            training_set_kwargs=c.get("training_set_kwargs", {}),
            G_kwargs=c.get("G_kwargs", {}),
            D_kwargs=c.get("D_kwargs", {}),
            loss_kwargs=c.get("loss_kwargs", {}),
            G_opt_kwargs=c.get("G_opt_kwargs", {}),
            D_opt_kwargs=c.get("D_opt_kwargs", {}),
            batch_size=c.get("batch_size", 512),
            accumulate_gradients=c.get("accumulate_gradients", 1),
            kimg_per_tick=c.get("kimg_per_tick", 10),
            image_snapshot_ticks=c.get("image_snapshot_ticks", 100),
            network_snapshot_ticks=c.get("network_snapshot_ticks", 100),
            total_kimg=c.get("total_kimg", 20000),
            ema_kimg=c.get("ema_kimg", 160.0),
            ema_rampup=c.get("ema_rampup", 0.05),
            random_seed=c.get("random_seed", 42),
            resume_path=c.get("resume_path"),
            resume_kimg=c.get("resume_kimg", 0),
            resume_discriminator=c.get("resume_discriminator", True),
            lpips_ckpt=c.get("lpips_ckpt"),
            allow_random_lpips=c.get("allow_random_lpips", False),
            metrics=c.get("metrics", []),
            in_loop_metric_batches=c.get("in_loop_metric_batches", 2),
            max_steps=args.max_steps,
            compute_dtype=c.get("compute_dtype", "bfloat16"),
            data_workers=c.get("data_workers", 3),
            fused_phases=c.get("fused_phases", False),
            wandb_project_name=c.get("wandb_project_name"),
            wandb_run_name=c.get("wandb_run_name"),
            device=device,
        )
    finally:
        logger.close()
        if made_group:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()

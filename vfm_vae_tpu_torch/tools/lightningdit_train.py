"""LightningDiT trainer over prefetched latents (port of
tools/preprocess_for_lightningdit/train.py).

Reads the safetensors latent shards that `prefetch` writes, normalises
them with latents_stats.npz and latent_multiplier, and trains the DiT of
the YAML's model_type by flow matching (lognorm times and the cosine term
as the YAML's transport section says) with AdamW (lr, 0.9, beta2,
weight_decay 0) and an EMA of 0.9999, in fp32, on one card or on several
under torchrun (tools/_dit.py: each process steps its slice of the global
batch):

    python -m vfm_vae_tpu_torch.tools.lightningdit_train --config <yaml> \\
        [--max-steps N] [--device cuda|cpu]
    python -m torch.distributed.run --nproc-per-node N \\
        -m vfm_vae_tpu_torch.tools.lightningdit_train --config <yaml>

The first batch serves as step 0's batch. A JSON line {step, loss, sec}
is printed every log_every steps, and a snapshot {params, ema} written
under output_dir/exp_name every ckpt_every steps after step 0
(train/checkpoint.save_snapshot) by rank 0.
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from typing import Optional, Sequence

import numpy as np


def shard_files(data_dir: str, what: str = "latent") -> list:
    files = sorted(glob(os.path.join(data_dir, "*.safetensors")))
    files = [f for f in files if "stats" not in os.path.basename(f)]
    assert files, f"no {what} shards in {data_dir}"
    return files


def latent_batches(data_dir: str, batch_size: int, rng: np.random.Generator,
                   use_flip: bool = True):
    """Infinite stream of (latents NHWC, labels) over the shards
    ({latents, latents_flip, labels}), drawn from `rng` as the JAX tool
    draws: the file order shuffled each pass, a permutation a file, a coin
    a sample for the flipped latents."""
    from ..data.safetensors_io import load_file

    files = shard_files(data_dir)
    while True:
        rng.shuffle(files)
        for f in files:
            d = load_file(f)
            lat, flip, labels = d["latents"], d.get("latents_flip"), d["labels"]
            idx = rng.permutation(lat.shape[0])
            for i in range(0, len(idx) - batch_size + 1, batch_size):
                sel = idx[i : i + batch_size]
                x = lat[sel]
                if use_flip and flip is not None:
                    take_flip = rng.random(len(sel)) < 0.5
                    x = np.where(take_flip[:, None, None, None], flip[sel], x)
                yield x.transpose(0, 2, 3, 1), labels[sel]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns {losses, snapshots, out_dir, trainer}."""
    ap = argparse.ArgumentParser(description="LightningDiT trainer over prefetched latents.")
    ap.add_argument("--config", required=True)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..entry import configure_precision
    from ._dit import DiTTrainer, build_dit, latent_stats, start_processes, tool_config, train_loop

    dev, made_group = start_processes(args.device, "lightningdit_train")
    configure_precision()
    cfg = tool_config(args.config)
    tcfg, ocfg = cfg.get("train", {}), cfg.get("optimizer", {})
    pcfg, dcfg = cfg.get("transport", {}), cfg.get("data", {})
    model, _, in_chans, _ = build_dit(cfg, dev)
    mean, std, mult = latent_stats(dcfg, in_chans, dev)

    seed = tcfg.get("global_seed", 0)
    it = latent_batches(dcfg["data_path"], tcfg.get("global_batch_size", 1024),
                        np.random.default_rng(seed))
    first = next(it)  # the JAX tool initialises on it and trains on it at step 0

    def batches():
        yield first
        yield from it

    trainer = DiTTrainer(model, None, ocfg.get("lr", 2e-4), (0.9, ocfg.get("beta2", 0.95)), 0.0,
                         pcfg.get("use_lognorm", True), pcfg.get("use_cosine_loss", True), 0.0,
                         torch.Generator(device=dev).manual_seed(seed))

    def step_args(batch):
        x, y = batch
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
        return (x - mean) / std * mult, torch.from_numpy(np.asarray(y, np.int64)).to(dev)

    return train_loop("lightningdit_train", trainer, batches(), step_args,
                      args.max_steps or tcfg.get("max_steps", 600000), tcfg.get("log_every", 100),
                      tcfg.get("ckpt_every", 10000),
                      os.path.join(tcfg.get("output_dir", "runs/dit"), tcfg.get("exp_name", "exp")),
                      made_group)


if __name__ == "__main__":
    main()

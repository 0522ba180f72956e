"""REG (SiT-XL/1) trainer over prefetched posterior moments (port of
tools/preprocess_for_reg/train.py).

Differences from lightningdit_train: the shards that `prefetch_reg` writes
hold (mean || std) moments, and each step samples z = mean + std * eps; no
stats normalisation; uniform times (no lognorm), the cosine term on;
AdamW(lr, 0.9, 0.999) at optax.adamw's default weight_decay 1e-4
(decoupled decay of every parameter); with model.repa_weight > 0 the REPA
term aligns a projector of block repa_block's tokens with the shards'
vfm_features (prefetch --store-vfm-features), and the parameters are a
{"dit", "proj"} tree. fp32, on one card or on several under torchrun as
lightningdit_train:

    python -m vfm_vae_tpu_torch.tools.reg_train --config <yaml> \\
        [--max-steps N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from .lightningdit_train import shard_files


def moment_batches(data_dir: str, batch_size: int, rng: np.random.Generator):
    """Infinite stream of (moments NHWC, labels, vfm_features fp32 or None),
    drawn from `rng` as the JAX tool draws."""
    from ..data.safetensors_io import load_file

    files = shard_files(data_dir, "moment")
    while True:
        rng.shuffle(files)
        for f in files:
            d = load_file(f)
            mom, flip, labels = d["latents"], d.get("latents_flip"), d["labels"]
            feats = d.get("vfm_features")
            idx = rng.permutation(mom.shape[0])
            for i in range(0, len(idx) - batch_size + 1, batch_size):
                sel = idx[i : i + batch_size]
                x = mom[sel]
                if flip is not None:
                    take = rng.random(len(sel)) < 0.5
                    x = np.where(take[:, None, None, None], flip[sel], x)
                yield (x.transpose(0, 2, 3, 1), labels[sel],
                       feats[sel].astype(np.float32) if feats is not None else None)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns {losses, snapshots, out_dir, trainer}."""
    ap = argparse.ArgumentParser(description="REG SiT trainer over posterior moments.")
    ap.add_argument("--config", required=True)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..entry import configure_precision
    from ._dit import DiTTrainer, build_reg, start_processes, tool_config, train_loop

    dev, made_group = start_processes(args.device, "reg_train")
    configure_precision()
    cfg = tool_config(args.config)
    tcfg, dcfg = cfg.get("train", {}), cfg.get("data", {})
    model, projector, _, _, repa_weight = build_reg(cfg, device=dev)
    seed = tcfg.get("global_seed", 0)
    it = moment_batches(dcfg["data_path"], tcfg.get("global_batch_size", 256),
                        np.random.default_rng(seed))
    trainer = DiTTrainer(model, projector, cfg.get("optimizer", {}).get("lr", 1e-4), (0.9, 0.999),
                         1e-4, False, True, repa_weight,
                         torch.Generator(device=dev).manual_seed(seed))

    def step_args(batch):
        x, y, feats = batch
        if repa_weight > 0 and feats is None:
            raise ValueError("reg_train: repa_weight > 0 needs shards with vfm_features "
                             "(prefetch_reg --store-vfm-features)")
        moments = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
        targets = torch.from_numpy(feats).to(dev) if repa_weight > 0 else None
        return (trainer.posterior(moments), torch.from_numpy(np.asarray(y, np.int64)).to(dev),
                targets)

    return train_loop("reg_train", trainer, it, step_args,
                      args.max_steps or tcfg.get("max_steps", 400000), tcfg.get("log_every", 100),
                      tcfg.get("ckpt_every", 10000),
                      os.path.join(tcfg.get("output_dir", "runs/reg"), tcfg.get("exp_name", "exp")),
                      made_group)


if __name__ == "__main__":
    main()

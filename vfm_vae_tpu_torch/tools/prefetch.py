"""Latent prefetch for LightningDiT training (port of
tools/preprocess_for_lightningdit/prefetch.py).

WebDataset tar shards -> ADM centre crop -> the encoder (sampled z, and z
of the horizontally flipped crop) -> safetensors shards of --shard-size
samples holding latents and latents_flip (F32, NCHW), labels (I64) and,
with --store-vfm-features, the tower's last-layer tokens pooled to the
latent grid (F16, (N, T, C)); then the channel mean and std of the first
shard's latents (up to 10,000 samples) as latents_stats.npz and
latents_stats.safetensors ((1, C, 1, 1) each).

    python -m vfm_vae_tpu_torch.tools.prefetch --config <yaml> \\
        --snapshot <snapshot dir or .pth> --data <dir of .tar> --out <dir> \\
        [--int8] [--store-vfm-features] [--store-images] [--device cuda|cpu]

Tars are split across processes by RANK and WORLD_SIZE (torchrun); the
posterior noise of rank r comes from a torch.Generator seeded r. Every
sample is encoded: the tail batch runs at its own size.
"""

from __future__ import annotations

import argparse
import io
import json
import os
from glob import glob
from typing import List, Optional, Sequence

import numpy as np


def adm_center_crop(img, resolution: int) -> np.ndarray:
    """ADM-style centre crop (reference prefetch.py:113-147): BOX halvings
    while the short side is at least 2 * resolution, a BICUBIC resize of
    the short side to `resolution`, then the centre crop."""
    import PIL.Image

    while min(*img.size) >= 2 * resolution:
        img = img.resize(tuple(x // 2 for x in img.size), resample=PIL.Image.BOX)
    scale = resolution / min(*img.size)
    img = img.resize(tuple(round(x * scale) for x in img.size), resample=PIL.Image.BICUBIC)
    arr = np.array(img.convert("RGB"))
    crop_y = (arr.shape[0] - resolution) // 2
    crop_x = (arr.shape[1] - resolution) // 2
    return arr[crop_y : crop_y + resolution, crop_x : crop_x + resolution]


def pooled_tokens(G, tokens):
    """Last-layer tower tokens (B, T, C) adaptively pooled to the latent
    grid, as tokens (B, zr * zr, C): the REPA alignment targets."""
    from ..models.adapter import map_to_tokens, tokens_to_map
    from ..ops.resize import adaptive_avg_pool2d

    f = tokens_to_map(tokens)
    zr = G.ldm_adapter.z_resolution
    if f.shape[1] != zr:
        f = adaptive_avg_pool2d(f, (zr, zr))
    return map_to_tokens(f)


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--config", required=True, help="the tokenizer's YAML config")
    ap.add_argument("--snapshot", required=True,
                    help="a port snapshot directory or a reference-layout .pth")
    ap.add_argument("--data", required=True, help="directory of .tar shards (searched recursively)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--shard-size", type=int, default=10000)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--store-vfm-features", action="store_true",
                    help="also store the tower's last-layer tokens pooled to the latent grid "
                         "(fp16) as REPA alignment targets")
    ap.add_argument("--store-images", action="store_true",
                    help="also write the cropped inputs as <out>/images/<class>/<key>.png with "
                         "a per-rank dataset json")
    ap.add_argument("--int8", action="store_true",
                    help="serve the frozen tower in static-scale int8 (W8A8), calibrated once "
                         "on the first batch")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None, return_moments: bool = False) -> dict:
    """Returns the time report (ToolClock.report) with `samples` and
    `shards` (the paths written)."""
    tool = "prefetch_reg" if return_moments else "prefetch"
    args = parser("Posterior-moment prefetch for REG training." if return_moments else
                  "Latent prefetch for LightningDiT training.").parse_args(argv)

    import PIL.Image
    import torch

    from ..data.safetensors_io import load_file, save_file
    from ..data.wds import iter_tar_samples
    from ..models.distributions import mean_logvar_to_mean_std
    from ..parallel.serving import batched, process_shard, rank_and_world
    from ._generator import ToolClock, build_generator, resolve_device

    dev = resolve_device(args.device, tool)
    clock = ToolClock(dev)
    with clock.setup():
        G, _ = build_generator(args.config, args.snapshot, dev)
    rank, _ = rank_and_world()
    tars = process_shard(sorted(glob(os.path.join(args.data, "**", "*.tar"), recursive=True)))
    gen = torch.Generator(device=dev).manual_seed(rank)
    os.makedirs(args.out, exist_ok=True)
    images_dir = os.path.join(args.out, "images")
    image_records: List[list] = []

    def samples():
        for tar in tars:
            for raw in iter_tar_samples(tar):
                data = next((raw[e] for e in ("jpg", "jpeg", "png") if e in raw), None)
                if data is None:
                    continue
                crop = adm_center_crop(PIL.Image.open(io.BytesIO(data)), args.resolution)
                label = int(raw.get("cls", b"0").decode() or 0)
                if args.store_images:
                    key = raw.get("__key__", b"").decode() or f"img{len(image_records):08d}"
                    sub = os.path.join(images_dir, f"{label:04d}")
                    os.makedirs(sub, exist_ok=True)
                    PIL.Image.fromarray(crop).save(os.path.join(sub, f"{key}.png"))
                    image_records.append([f"{label:04d}/{key}.png", label])
                yield crop, label

    bufs = {"latents": [], "latents_flip": [], "labels": [], "vfm_features": []}
    shards: List[str] = []

    def flush():
        if not bufs["latents"]:
            return
        # NCHW storage, as the torch consumers of the reference read it.
        payload = {"latents": np.concatenate(bufs["latents"]).transpose(0, 3, 1, 2),
                   "latents_flip": np.concatenate(bufs["latents_flip"]).transpose(0, 3, 1, 2),
                   "labels": np.asarray(bufs["labels"], np.int64)}
        if bufs["vfm_features"]:
            payload["vfm_features"] = np.concatenate(bufs["vfm_features"])
        path = os.path.join(args.out, f"latents_rank{rank:02d}_shard{len(shards):03d}.safetensors")
        save_file(payload, path)
        print(f"wrote {path} ({payload['latents'].shape[0]} samples)", flush=True)
        shards.append(path)
        for v in bufs.values():
            v.clear()

    n = 0
    calibrate = args.int8
    batches = batched(samples(), args.batch)
    while True:
        with clock.host():
            chunk = next(batches, None)
        if chunk is None:
            break
        with clock.model(), torch.no_grad():
            x = torch.from_numpy(np.stack([c for c, _ in chunk])).to(dev).float().div_(255.0)
            if calibrate:  # once, on real data, before that data is encoded
                from ..ops.quantized import enable_int8_tower

                enable_int8_tower(G, x)
                calibrate = False
            feats = G.vfm_encoder.encode_image(x)
            xf = torch.flip(x, [2])  # NHWC: the width axis
            if return_moments:
                a = mean_logvar_to_mean_std(G.ldm_adapter.encode(feats, None, True))
                b = mean_logvar_to_mean_std(G.encode(xf, return_z_before_quantize=True))
            else:
                a = G.ldm_adapter.encode(feats, gen)
                b = G.encode(xf, gen)
            if args.store_vfm_features:
                bufs["vfm_features"].append(
                    pooled_tokens(G, feats[-1]).float().cpu().numpy().astype(np.float16))
            bufs["latents"].append(a.float().cpu().numpy())
            bufs["latents_flip"].append(b.float().cpu().numpy())
        bufs["labels"].extend(label for _, label in chunk)
        n += len(chunk)
        if sum(t.shape[0] for t in bufs["latents"]) >= args.shard_size:
            with clock.host():
                flush()
    with clock.host():
        flush()
        if args.store_images and image_records:
            with open(os.path.join(images_dir, f"dataset_rank{rank}.json"), "w") as f:
                json.dump({"labels": image_records}, f, indent=1)
            print(f"wrote {len(image_records)} images + dataset_rank{rank}.json", flush=True)
        # Channel statistics over the first shard (reference prefetch.py:58-83).
        if rank == 0 and shards:
            first = load_file(shards[0])["latents"][:10000]
            mean = first.mean(axis=(0, 2, 3), keepdims=True)
            std = first.std(axis=(0, 2, 3), keepdims=True)
            np.savez(os.path.join(args.out, "latents_stats.npz"), mean=mean, std=std)
            save_file({"mean": mean.astype(np.float32), "std": std.astype(np.float32)},
                      os.path.join(args.out, "latents_stats.safetensors"))
            print("wrote latents_stats", flush=True)
    return dict(clock.report(tool, n), samples=n, shards=shards)


if __name__ == "__main__":
    main()

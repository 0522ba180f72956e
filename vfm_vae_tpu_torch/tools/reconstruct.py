"""Reconstruction pairs for rFID, PSNR, SSIM and LPIPS (port of
tools/reconstruct/reconstruct.py).

A folder of images (searched recursively, split across processes by RANK
and WORLD_SIZE) -> LANCZOS resize of the short side and a centre crop ->
encode -> decode -> inputs/NAME.png and outputs/NAME.png, NAME being the
image's index in this process's list ({i:08d}; {rank:02d}_{i:08d} when
WORLD_SIZE > 1). z is the posterior mode, or with --sample-posterior a
sample drawn from a torch.Generator seeded with the rank.

    python -m vfm_vae_tpu_torch.tools.reconstruct --config <yaml> \\
        --snapshot <snapshot dir or .pth> --data <image folder> --out <dir> \\
        [--int8] [--sample-posterior] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Iterator, Optional, Sequence

import numpy as np


def iter_image_files(root: str) -> Iterator[str]:
    for dirpath, dirs, files in os.walk(root):
        dirs.sort()
        for f in sorted(files):
            if f.lower().endswith((".png", ".jpg", ".jpeg")):
                yield os.path.join(dirpath, f)


def load_and_crop(path: str, resolution: int) -> np.ndarray:
    """LANCZOS resize of the short side to `resolution`, then the centre crop."""
    import PIL.Image

    img = PIL.Image.open(path).convert("RGB")
    w, h = img.size
    scale = resolution / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), PIL.Image.LANCZOS)
    w, h = img.size
    left, top = (w - resolution) // 2, (h - resolution) // 2
    img = img.crop((left, top, left + resolution, top + resolution))
    return np.array(img, np.uint8)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the time report (ToolClock.report) with `names` (the pairs written)."""
    ap = argparse.ArgumentParser(description="Write input/output reconstruction pairs.")
    ap.add_argument("--config", required=True)
    ap.add_argument("--snapshot", required=True,
                    help="a port snapshot directory or a reference-layout .pth")
    ap.add_argument("--data", required=True, help="image folder (searched recursively)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--sample-posterior", action="store_true",
                    help="sample z from the posterior (default: its mode)")
    ap.add_argument("--int8", action="store_true",
                    help="serve the frozen tower in static-scale int8 (W8A8), calibrated on "
                         "the first 32 images")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import PIL.Image
    import torch

    from ..parallel.serving import batched, process_shard, rank_and_world
    from ._generator import ToolClock, build_generator, resolve_device
    from .decode_latents_to_images import to_uint8

    dev = resolve_device(args.device, "reconstruct")
    clock = ToolClock(dev)
    with clock.setup():
        G, _ = build_generator(args.config, args.snapshot, dev)
    res = G.synthesis.block_resolutions[-1]
    rank, world = rank_and_world()
    files = list(iter_image_files(args.data))[: args.max_images]
    files = process_shard(files)
    for sub in ("inputs", "outputs"):
        os.makedirs(os.path.join(args.out, sub), exist_ok=True)

    def load(chunk):
        return torch.from_numpy(np.stack([load_and_crop(f, res) for f in chunk]))

    if args.int8:
        from ..ops.quantized import enable_int8_tower

        with clock.host():
            calib = load(files[:32])
        with clock.model():
            enable_int8_tower(G, calib.to(dev).float().div_(255.0))
    gen = torch.Generator(device=dev).manual_seed(rank) if args.sample_posterior else None
    print(f"Reconstructing {len(files)} images at {res}px on {dev}", flush=True)
    names = []
    for chunk in batched(files, args.batch):
        with clock.host():
            imgs = load(chunk)
        with clock.model():
            z = G.encode(imgs.to(dev).float().div_(255.0), gen)
            out = to_uint8(G.decode(z).float().cpu().numpy())
        with clock.host():
            for img, rec in zip(imgs.numpy(), out):
                i = len(names)
                name = f"{i:08d}.png" if world == 1 else f"{rank:02d}_{i:08d}.png"
                PIL.Image.fromarray(img).save(os.path.join(args.out, "inputs", name))
                PIL.Image.fromarray(rec).save(os.path.join(args.out, "outputs", name))
                names.append(name)
    print(f"Wrote pairs to {args.out}/inputs and {args.out}/outputs", flush=True)
    return dict(clock.report("reconstruct", len(names)), names=names)


if __name__ == "__main__":
    main()

"""Decode stored latents to PNGs (port of
tools/decode/decode_latents_to_images.py).

The .safetensors files of --latents (not latents_stats*) are split across
processes by RANK and WORLD_SIZE; each file's --key tensor (NCHW) is
decoded in --batch chunks (the last at its own size), and image i of rank
r is written as {r:02d}_{i:08d}.png.

    python -m vfm_vae_tpu_torch.tools.decode_latents_to_images --config <yaml> \\
        --snapshot <snapshot dir or .pth> --latents <dir> --out <dir> [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from typing import List, Optional, Sequence

import numpy as np


def latent_files(latents_dir: str) -> List[str]:
    """The latent shards of a prefetch output, without its latents_stats files."""
    files = sorted(glob(os.path.join(latents_dir, "*.safetensors")))
    return [f for f in files if "stats" not in os.path.basename(f)]


def to_uint8(img) -> np.ndarray:
    """[-1, 1] pixels -> uint8, truncated as the reference's tools do."""
    return ((np.clip(img, -1, 1) + 1) * 127.5).astype(np.uint8)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the time report (ToolClock.report) with `files` (the PNGs written)."""
    ap = argparse.ArgumentParser(description="Decode stored latents to PNGs.")
    ap.add_argument("--config", required=True)
    ap.add_argument("--snapshot", required=True,
                    help="a port snapshot directory or a reference-layout .pth")
    ap.add_argument("--latents", required=True, help="directory of .safetensors shards")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--key", default="latents")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import PIL.Image
    import torch

    from ..data.safetensors_io import load_file
    from ..parallel.serving import process_shard, rank_and_world
    from ._generator import ToolClock, build_generator, resolve_device

    dev = resolve_device(args.device, "decode_latents_to_images")
    clock = ToolClock(dev)
    with clock.setup():
        G, _ = build_generator(args.config, args.snapshot, dev)
    os.makedirs(args.out, exist_ok=True)
    rank, _ = rank_and_world()
    written: List[str] = []
    for path in process_shard(latent_files(args.latents)):
        with clock.host():
            z_all = load_file(path)[args.key]  # NCHW storage
        for i in range(0, z_all.shape[0], args.batch):
            with clock.model():
                z = torch.from_numpy(np.ascontiguousarray(
                    z_all[i : i + args.batch].transpose(0, 2, 3, 1), np.float32)).to(dev)
                out = G.decode(z).float().cpu().numpy()
            with clock.host():
                for img in to_uint8(out):
                    name = os.path.join(args.out, f"{rank:02d}_{len(written):08d}.png")
                    PIL.Image.fromarray(img).save(name)
                    written.append(name)
    print(f"decoded {len(written)} images to {args.out}", flush=True)
    return dict(clock.report("decode_latents_to_images", len(written)), files=written)


if __name__ == "__main__":
    main()

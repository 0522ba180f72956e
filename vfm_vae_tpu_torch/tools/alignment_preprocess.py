"""SE-CKNNA preprocessing (port of tools/evaluate_alignment/preprocess.py):
per-image equivariance transform records and Gaussian-noise image sets,
each image's draws from numpy's RandomState(seed + index), so the records
and images are the JAX tool's bit for bit.

    python -m vfm_vae_tpu_torch.tools.alignment_preprocess equivariance \\
        --input-dir X --output-dir Y
    python -m vfm_vae_tpu_torch.tools.alignment_preprocess noise \\
        --input-dir X --output-dir Y --noise-levels 0.05 0.1
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def apply_noise(image: np.ndarray, noise_level: float, idx: int, seed: int) -> np.ndarray:
    """Gaussian noise keyed by seed + idx, in uint8."""
    rng = np.random.RandomState(seed + idx)
    noise = rng.normal(0, noise_level, image.shape).astype(np.float32)
    return np.clip(image + noise * 255.0, 0, 255).astype(np.uint8)


def get_transformation_params(idx: int, seed: int) -> dict:
    rng = np.random.RandomState(seed + idx)
    rotation = int(rng.choice([0, 90, 180, 270]))
    scale = float(rng.choice([1.0, 0.75, 0.5, 0.25]))
    return {"rotation": rotation, "scale": scale}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the records (equivariance) or {level: directory} (noise)."""
    ap = argparse.ArgumentParser(description="SE-CKNNA preprocessing.")
    ap.add_argument("mode", choices=["equivariance", "noise"])
    ap.add_argument("--input-dir", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--noise-levels", type=float, nargs="+", default=[0.05, 0.1, 0.2])
    args = ap.parse_args(argv)

    import PIL.Image

    paths = sorted(Path(args.input_dir).glob("*.png"), key=lambda p: p.stem)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    if args.mode == "equivariance":
        records = {p.stem: get_transformation_params(i, args.seed) for i, p in enumerate(paths)}
        with open(out / "equivariance_transforms.json", "w") as f:
            json.dump(records, f, indent=2)
        print(f"wrote {len(records)} records to {out / 'equivariance_transforms.json'}")
        return records
    dirs = {}
    for level in args.noise_levels:
        d = out / f"noise_{level:.3f}"
        d.mkdir(exist_ok=True)
        for i, p in enumerate(paths):
            img = PIL.Image.open(p).convert("RGB")
            if img.size != (args.resolution, args.resolution):
                img = img.resize((args.resolution, args.resolution), PIL.Image.LANCZOS)
            arr = apply_noise(np.array(img, np.uint8), level, i, args.seed)
            PIL.Image.fromarray(arr).save(d / p.name)
        dirs[level] = str(d)
        print(f"wrote noise level {level} to {d}")
    return dirs


if __name__ == "__main__":
    main()

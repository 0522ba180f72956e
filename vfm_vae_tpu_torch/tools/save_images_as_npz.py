"""Pack a folder of PNGs into an ADM-evaluator .npz (port of
tools/decode/save_images_as_npz.py): the first --max files in name order,
uint8 (N, H, W, 3) under arr_0.

    python -m vfm_vae_tpu_torch.tools.save_images_as_npz --images <dir> --out samples.npz
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> tuple:
    ap = argparse.ArgumentParser(description="Pack a folder of PNGs into an ADM .npz.")
    ap.add_argument("--images", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--max", type=int, default=50000)
    args = ap.parse_args(argv)

    import PIL.Image

    files = sorted(glob(os.path.join(args.images, "*.png")))[: args.max]
    if not files:
        raise SystemExit(f"save_images_as_npz: no PNGs in {args.images}")
    arr = np.stack([np.array(PIL.Image.open(f).convert("RGB")) for f in files])
    np.savez(args.out, arr_0=arr)
    print(f"wrote {args.out}: {arr.shape}")
    return arr.shape


if __name__ == "__main__":
    main()

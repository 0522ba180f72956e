"""PSNR, SSIM and LPIPS of paired folders (port of
tools/reconstruct/evaluate.py): each file of --inputs against the file of
the same name in --outputs, as reconstruct writes them.

    python -m vfm_vae_tpu_torch.tools.evaluate --inputs <dir> --outputs <dir> \\
        [--lpips-ckpt vgg.pth | --allow-random-lpips] [--device cuda|cpu]

LPIPS needs the taming vgg.pth, which the repository does not hold;
--allow-random-lpips computes it with seeded random weights (a plumbing
check, not a published figure), and without either it is left out.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the time report (ToolClock.report) with `results`."""
    ap = argparse.ArgumentParser(description="PSNR, SSIM and LPIPS of paired folders.")
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--outputs", required=True)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lpips-ckpt", default=None, help="a local taming vgg.pth")
    ap.add_argument("--allow-random-lpips", action="store_true",
                    help="without --lpips-ckpt, LPIPS from seeded random weights")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import PIL.Image

    from ..entry import configure_precision
    from ..metrics.recon import evaluate_pairs
    from ..parallel.serving import batched
    from ..train.lpips import build_lpips
    from ._generator import ToolClock, resolve_device

    dev = resolve_device(args.device, "evaluate")
    configure_precision()
    names = sorted(os.listdir(args.inputs))
    if not names:
        raise SystemExit(f"evaluate: no files in {args.inputs}")
    clock = ToolClock(dev)
    lpips = None
    with clock.setup():
        if args.lpips_ckpt:
            lpips = build_lpips(dev, args.lpips_ckpt)
        elif args.allow_random_lpips:
            print("[warn] evaluate: no --lpips-ckpt: random-init LPIPS; the value is NOT "
                  "comparable to published numbers (plumbing check only)", file=sys.stderr)
            lpips = build_lpips(dev, allow_random_lpips=True)
        else:
            print("[warn] evaluate: no --lpips-ckpt: LPIPS is not computed", file=sys.stderr)

    def load(d, chunk):
        return np.stack([np.array(PIL.Image.open(os.path.join(d, n)).convert("RGB"))
                         for n in chunk]).astype(np.float32) / 255.0

    pairs = ((load(args.inputs, c), load(args.outputs, c)) for c in batched(names, args.batch))
    results = evaluate_pairs(clock.timed(pairs), lpips, device=dev)
    for k, v in results.items():
        print(f"{k}: {v:.4f}")
    return dict(clock.report("evaluate", len(names)), results=results)


if __name__ == "__main__":
    main()

"""Untar WebDataset shards into a flat image folder (port of
tools/reconstruct/extract.py): every .png/.jpg/.jpeg member of the .tar
files under --tars, by its base name.

    python -m vfm_vae_tpu_torch.tools.extract --tars <dir with .tar> --out <dir>
"""

from __future__ import annotations

import argparse
import os
import tarfile
from glob import glob
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Untar shards into a flat image folder.")
    ap.add_argument("--tars", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    tars = sorted(glob(os.path.join(args.tars, "**", "*.tar"), recursive=True))
    count = 0
    for t in tars:
        with tarfile.open(t) as tf:
            for m in tf:
                if m.isfile() and m.name.lower().endswith((".png", ".jpg", ".jpeg")):
                    with open(os.path.join(args.out, os.path.basename(m.name)), "wb") as f:
                        f.write(tf.extractfile(m).read())
                    count += 1
    print(f"Extracted {count} images from {len(tars)} shards to {args.out}")
    return count


if __name__ == "__main__":
    main()

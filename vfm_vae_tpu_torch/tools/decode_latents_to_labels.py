"""The label json that matches decode_latents_to_images' names (port of
tools/decode/decode_latents_to_labels.py): {"{rank:02d}_{idx:08d}.png":
class label} over this rank's share of the latent shards, for the ADM
evaluator.

    python -m vfm_vae_tpu_torch.tools.decode_latents_to_labels --latents <dir> --out labels.json
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description="Write the labels of decoded latents as json.")
    ap.add_argument("--latents", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    args = ap.parse_args(argv)

    from ..data.safetensors_io import load_file
    from .decode_latents_to_images import latent_files

    mapping = {}
    for path in latent_files(args.latents)[args.rank :: args.world]:
        for label in load_file(path)["labels"]:
            mapping[f"{args.rank:02d}_{len(mapping):08d}.png"] = int(label)
    with open(args.out, "w") as f:
        json.dump(mapping, f)
    print(f"wrote {len(mapping)} labels to {args.out}")
    return mapping


if __name__ == "__main__":
    main()

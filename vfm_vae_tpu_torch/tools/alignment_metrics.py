"""CKNNA between two feature files (port of
tools/evaluate_alignment/metrics.py; reference metrics.py:191-238):

    python -m vfm_vae_tpu_torch.tools.alignment_metrics --a feats_a.npz \\
        --b feats_b.npz [--topk 10] [--normalize] [--biased]

Features of the images whose names both files hold, in sorted name order;
names compare without their file extension, so the vae and vfm modes'
image_000123.png pairs with the dit and reg modes' image_000123 (the JAX
tool compares them whole and so pairs no image across the two kinds);
--normalize L2-normalises each feature first; --biased uses the biased
HSIC. Two files that share no name are refused.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def stem(name) -> str:
    """An image's name without its file extension."""
    return os.path.splitext(str(name))[0]


def matched(da, db):
    """(features a, features b, names) of the names both files hold, or
    all rows in file order when a file has no names."""
    fa, fb = da["features"], db["features"]
    if "names" not in da or "names" not in db:
        return fa, fb, None
    ia = {stem(n): i for i, n in enumerate(da["names"])}
    ib = {stem(n): i for i, n in enumerate(db["names"])}
    common = sorted(set(ia) & set(ib))
    if not common:
        raise ValueError("alignment_metrics: the two feature files share no image name")
    return fa[[ia[n] for n in common]], fb[[ib[n] for n in common]], common


def main(argv: Optional[Sequence[str]] = None) -> float:
    ap = argparse.ArgumentParser(description="CKNNA between two feature files.")
    ap.add_argument("--a", required=True)
    ap.add_argument("--b", required=True)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--normalize", action="store_true", help="L2-normalize features")
    ap.add_argument("--biased", action="store_true")
    args = ap.parse_args(argv)

    from ..metrics.cknna import cknna

    fa, fb, common = matched(np.load(args.a), np.load(args.b))
    if common is not None:
        print(f"matched {len(common)} images")
    if args.normalize:
        fa = fa / np.clip(np.linalg.norm(fa, axis=1, keepdims=True), 1e-8, None)
        fb = fb / np.clip(np.linalg.norm(fb, axis=1, keepdims=True), 1e-8, None)
    value = cknna(fa, fb, topk=args.topk, unbiased=not args.biased)
    print(f"CKNNA(topk={args.topk}): {value:.4f}")
    return value


if __name__ == "__main__":
    main()

"""Generation metrics of ADM .npz batches (port of
tools/decode/evaluate_npz.py; the numbers of OpenAI's guided-diffusion
evaluator, reference README.md:365-376):

  fid        Frechet distance of the InceptionV3 pool3 features (2048-d)
  sfid       Frechet distance of the spatial tap (mixed_6/conv, the first 7
             channels of 17 x 17, 2023-d; metrics/inception.py)
  inception_score   exp(mean KL) of the 1008-way softmax, one split per
             5000 samples (ADM's policy)
  precision, recall   Kynkaanniemi k-NN manifolds (k = --nhood) of pool3

    python -m vfm_vae_tpu_torch.tools.evaluate_npz --sample-batch samples.npz \\
        --ref-batch VIRTUAL_imagenet256_labeled.npz [--inception-weights pt_inception.pth]

Images are uint8 (N, H, W, 3) under arr_0 (else the file's first array).
The figures need pytorch-fid's pt_inception-2015-12-05 weights, which the
repository does not hold; without --inception-weights the detector has
seeded random weights (a plumbing check) and a warning goes to stderr.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np


def npz_batches(path: str, batch: int, max_items: Optional[int]):
    data = np.load(path)
    key = "arr_0" if "arr_0" in data else list(data.keys())[0]
    imgs = data[key][:max_items] if max_items else data[key]
    for i in range(0, imgs.shape[0], batch):
        yield imgs[i : i + batch]


def inception_score(probs: np.ndarray, split_size: int = 5000) -> float:
    """ADM's split policy: one split per `split_size` samples (at least one)."""
    splits = max(1, probs.shape[0] // split_size)
    scores = []
    for part in np.array_split(probs, splits):
        kl = part * (np.log(part + 1e-12) - np.log(part.mean(axis=0, keepdims=True) + 1e-12))
        scores.append(float(np.exp(kl.sum(axis=1).mean())))
    return float(np.mean(scores))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the time report (ToolClock.report) with `results`."""
    ap = argparse.ArgumentParser(description="FID, sFID, IS, precision and recall of ADM .npz.")
    ap.add_argument("--sample-batch", required=True)
    ap.add_argument("--ref-batch", required=True)
    ap.add_argument("--inception-weights", default=None,
                    help="pytorch-fid's pt_inception-2015-12-05 .pth; random init otherwise")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--max-items", type=int, default=None)
    ap.add_argument("--nhood", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..entry import configure_precision
    from ..metrics.feature_stats import FeatureStats
    from ..metrics.fid import frechet_distance
    from ..metrics.inception import make_detector
    from ..metrics.precision_recall import compute_pr
    from ._generator import ToolClock, resolve_device

    dev = resolve_device(args.device, "evaluate_npz")
    configure_precision()
    clock = ToolClock(dev)
    with clock.setup():
        _, detect = make_detector(args.inception_weights, dev, "evaluate_npz")

    def run(path: str, want_probs: bool):
        pool_stats = FeatureStats(capture_all=True, capture_mean_cov=True)
        sp_stats = FeatureStats(capture_mean_cov=True)
        probs = []
        for raw in clock.timed(npz_batches(path, args.batch, args.max_items)):
            pool, logits, spatial = detect(raw)
            pool_stats.append(pool.cpu().numpy())
            sp_stats.append(spatial.cpu().numpy())
            if want_probs:
                probs.append(torch.softmax(logits, dim=-1).double().cpu().numpy())
        return pool_stats, sp_stats, np.concatenate(probs) if probs else None

    gen_pool, gen_sp, gen_probs = run(args.sample_batch, want_probs=True)
    ref_pool, ref_sp, _ = run(args.ref_batch, want_probs=False)
    precision, recall = compute_pr(ref_pool.get_all(), gen_pool.get_all(),
                                   nhood_size=args.nhood, device=dev)
    result = {
        "fid": frechet_distance(*gen_pool.get_mean_cov(), *ref_pool.get_mean_cov()),
        "sfid": frechet_distance(*gen_sp.get_mean_cov(), *ref_sp.get_mean_cov()),
        "inception_score": inception_score(gen_probs),
        "precision": precision,
        "recall": recall,
        "n_samples": int(gen_pool.num_items),
        "n_ref": int(ref_pool.num_items),
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return dict(clock.report("evaluate_npz", result["n_samples"] + result["n_ref"]),
                results=result)


if __name__ == "__main__":
    main()

"""Frechet distance (port of vfm_vae_tpu/metrics/fid.py; reference
metrics/frechet_inception_distance.py:20-39) and the streaming feature
accumulation of the rFID protocol (README.md:348-354).

The detector is any callable from an NHWC image batch to a (B, F) feature
array (the InceptionV3 of metrics/inception.py in the tools).
"""

from __future__ import annotations

import sys
from typing import Callable, Iterable, Optional

import numpy as np
import scipy.linalg

from .feature_stats import FeatureStats


# pytorch-fid's and the ADM evaluator's diagonal offset for a product whose
# square root is not finite.
SQRTM_EPS = 1e-6


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """|mu1 - mu2|^2 + tr(S1 + S2 - 2 sqrtm(S1 S2)), in float64. With fewer
    samples than features the covariances are singular and sqrtm returns a
    complex matrix: its real part is kept, as the reference does. Newer
    scipy (which has dropped sqrtm's `disp` argument that the JAX package
    passes) returns NaN for some singular products, where older scipy
    returned a finite root: then, as pytorch-fid and the ADM evaluator do,
    SQRTM_EPS is added to both diagonals, a warning goes to stderr, and the
    root is taken again (a second sqrtm; the value moves by about
    -2 * SQRTM_EPS * dims)."""
    m = np.square(mu1 - mu2).sum()
    s = scipy.linalg.sqrtm(np.dot(sigma1, sigma2))
    if not np.isfinite(s).all():
        print(f"frechet_distance: sqrtm of the covariance product is not finite; adding "
              f"{SQRTM_EPS:g} to both diagonals and taking the root again", file=sys.stderr)
        offset = np.eye(len(sigma1)) * SQRTM_EPS
        s = scipy.linalg.sqrtm(np.dot(sigma1 + offset, sigma2 + offset))
    return float(np.real(m + np.trace(sigma1 + sigma2 - s * 2)))


def compute_fid_from_stats(stats_a: FeatureStats, stats_b: FeatureStats) -> float:
    mu1, s1 = stats_a.get_mean_cov()
    mu2, s2 = stats_b.get_mean_cov()
    return frechet_distance(mu1, s1, mu2, s2)


def accumulate_features(
    detector_fn: Callable[[np.ndarray], np.ndarray],
    batches: Iterable[np.ndarray],
    capture_all: bool = False,
    max_items: Optional[int] = None,
) -> FeatureStats:
    """Stream image batches (NHWC uint8 or float) through the detector."""
    stats = FeatureStats(capture_all=capture_all, capture_mean_cov=True, max_items=max_items)
    for batch in batches:
        if stats.is_full():
            break
        stats.append(np.asarray(detector_fn(batch)))
    return stats


def compute_fid(
    detector_fn,
    real_batches: Iterable[np.ndarray],
    gen_batches: Iterable[np.ndarray],
    max_items: Optional[int] = None,
) -> float:
    real = accumulate_features(detector_fn, real_batches, max_items=max_items)
    gen = accumulate_features(detector_fn, gen_batches, max_items=max_items)
    return compute_fid_from_stats(real, gen)

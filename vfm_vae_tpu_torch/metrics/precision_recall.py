"""Kynkaanniemi improved precision and recall (port of
vfm_vae_tpu/metrics/precision_recall.py; reference
metrics/precision_recall.py): k-NN radii and manifold membership from
pairwise squared distances, computed as blocked fp32 matrix products on
`device` (TF32 off: entry.configure_precision)."""

from __future__ import annotations

import numpy as np
import torch


def _pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a2 = a.square().sum(dim=1, keepdim=True)
    b2 = b.square().sum(dim=1)[None, :]
    return torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=0.0)


def kth_nn_distance(features: np.ndarray, k: int, batch: int = 4096,
                    device="cpu") -> np.ndarray:
    """Squared distance of each row to its k-th nearest neighbour in
    `features`, itself excluded (its own distance 0 is the smallest)."""
    f = torch.as_tensor(np.asarray(features, np.float32), device=device)
    out = [torch.kthvalue(_pairwise_sq_dists(f[i : i + batch], f), k + 1, dim=1).values
           for i in range(0, f.shape[0], batch)]
    return torch.cat(out).cpu().numpy()


def manifold_membership(probes: np.ndarray, manifold: np.ndarray, radii: np.ndarray,
                        batch: int = 4096, device="cpu") -> np.ndarray:
    """probe i is in the manifold iff dist(probe i, x_j) <= radius_j for some j."""
    m = torch.as_tensor(np.asarray(manifold, np.float32), device=device)
    r = torch.as_tensor(np.asarray(radii, np.float32), device=device)
    p = torch.as_tensor(np.asarray(probes, np.float32), device=device)
    out = [(_pairwise_sq_dists(p[i : i + batch], m) <= r[None, :]).any(dim=1)
           for i in range(0, p.shape[0], batch)]
    return torch.cat(out).cpu().numpy()


def compute_pr(real_features: np.ndarray, gen_features: np.ndarray, nhood_size: int = 3,
               device="cpu"):
    """(precision, recall) of the generated features against the real ones."""
    real_radii = kth_nn_distance(real_features, nhood_size, device=device)
    gen_radii = kth_nn_distance(gen_features, nhood_size, device=device)
    precision = manifold_membership(gen_features, real_features, real_radii, device=device).mean()
    recall = manifold_membership(real_features, gen_features, gen_radii, device=device).mean()
    return float(precision), float(recall)

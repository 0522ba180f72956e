"""SE-CKNNA representation-alignment metric (port of
vfm_vae_tpu/metrics/cknna.py; reference tools/evaluate_alignment/
metrics.py:191-266): top-k mutual-nearest-neighbour masked HSIC/CKA between
two feature sets, in fp32 on the CPU.

Where a row of a Gram matrix has ties at its k-th largest value,
`torch.topk` and `jax.lax.top_k` may pick different members; continuous
features have no ties.
"""

from __future__ import annotations

import numpy as np
import torch


def hsic_unbiased(K: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Song et al.'s unbiased HSIC (metrics.py:241-259)."""
    m = K.shape[0]
    K_t = K - torch.diag(torch.diag(K))
    L_t = L - torch.diag(torch.diag(L))
    return ((K_t * L_t.T).sum() + K_t.sum() * L_t.sum() / ((m - 1) * (m - 2))
            - 2 * (K_t @ L_t).sum() / (m - 2)) / (m * (m - 3))


def hsic_biased(K: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    m = K.shape[0]
    H = torch.eye(m, dtype=K.dtype) - 1.0 / m
    return torch.trace(K @ H @ L @ H)


def _topk_mask(G: torch.Tensor, topk: int, exclude_diag: bool) -> torch.Tensor:
    n = G.shape[0]
    eye = torch.eye(n, dtype=torch.bool)
    G_hat = G.masked_fill(eye, float("-inf")) if exclude_diag else G
    idx = torch.topk(G_hat, topk, dim=1).indices
    return torch.zeros((n, n), dtype=G.dtype).scatter_(1, idx, 1.0)


def cknna(feats_a: np.ndarray, feats_b: np.ndarray, topk: int = 10,
          distance_agnostic: bool = False, unbiased: bool = True) -> float:
    """Mutual-kNN-masked CKA similarity, about 0 to 1."""
    assert topk >= 2, "CKNNA requires topk >= 2"
    A = torch.as_tensor(np.asarray(feats_a, np.float32))
    B = torch.as_tensor(np.asarray(feats_b, np.float32))
    K, L = A @ A.T, B @ B.T

    def similarity(K, L):
        mask = _topk_mask(K, topk, unbiased) * _topk_mask(L, topk, unbiased)
        if distance_agnostic:
            return mask.sum()
        return (hsic_unbiased if unbiased else hsic_biased)(mask * K, mask * L)

    sim_kl, sim_kk, sim_ll = similarity(K, L), similarity(K, K), similarity(L, L)
    return float(sim_kl / (torch.sqrt(sim_kk * sim_ll) + 1e-6))

"""Multi-codebook vector quantization (port of vfm_vae_tpu/models/quantize.py;
reference networks/utils/quant_utils.py: VectorQuantizer :58,
VectorQuantizerM :136, the entropy loss :17, the normalized codebook :33).

The nearest code is the argmax of one fp32 (N, vocab) product of the
L2-normalized features and codebook (TF32 stays off: entry.configure_precision).
Each codebook keeps its usage telemetry in buffers: `vocab_usage` (in the
reference's state_dict layout, `codebooks.{j}.vocab_usage`) and the
`usage_record_times` counter that sets the EMA's ramp (1.0 on the first
record, 0.1 until the 100th, 0.01 after). The counter is not in the
reference layout; the training snapshot carries it (train/checkpoint.py).
The buffers move only in a training forward that updates buffers (the G
phase), as the JAX package's 'buffers' collection does.

Under several processes (parallel/mesh.py) the per-code counts are summed
over the processes before the usage figures and the EMA, and the entropy
loss's codebook term takes the mean probability over the global batch:
the JAX package computes both over the sharded global batch.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..parallel.mesh import mean_across_with_grad, sum_across
from .layers import Module, l2_normalize, param, uniform_


def entropy_loss_fn(latent: torch.Tensor, codebook: torch.Tensor, inv_tau: float) -> torch.Tensor:
    """Per-sample entropy minus the codebook entropy (quant_utils.py:17-30)."""
    e_dist = (latent.square().sum(1, keepdim=True) + codebook.square().sum(1)[None, :]
              - 2.0 * latent @ codebook.t())
    logits = -e_dist.float() * inv_tau
    prob = torch.softmax(logits, dim=-1)
    log_prob = torch.log_softmax(logits, dim=-1)
    per_sample_entropy = (-prob * log_prob).sum(-1).mean()
    avg_prob = mean_across_with_grad(prob.mean(0))
    codebook_entropy = (-avg_prob * torch.log(avg_prob + 1e-7)).sum()
    return per_sample_entropy - codebook_entropy


class Codebook(Module):
    """The (vocab_size, vocab_width) table, key `codebook.weight`; drawn as
    the JAX `_codebook_init` (quantize.py:53-58): truncated normal at
    eini > 0, else uniform within |eini| * vocab_width^-0.5 / 36."""

    def __init__(self, vocab_size: int, vocab_width: int, eini: float = -1.0, device=None):
        super().__init__()
        self.eini, self.vocab_width = eini, vocab_width
        self.weight = param(vocab_size, vocab_width, device=device)

    def reset_parameters(self, g):
        if self.eini > 0:
            w = nn.init.trunc_normal_(torch.empty_like(self.weight), std=1.0,
                                      a=-2.0 / self.eini, b=2.0 / self.eini, generator=g)
            self.weight.copy_(w * self.eini)
        else:
            uniform_(self.weight, g, abs(self.eini) * self.vocab_width ** -0.5 / 36)


class VectorQuantizer(Module):
    """One L2-normalized codebook with the commitment loss, the
    straight-through estimator and the EMA'd usage (quant_utils.py:58-133)."""

    def __init__(self, vocab_size: int, vocab_width: int, beta: float = 0.25,
                 use_entropy_loss: bool = False, entropy_temp: float = 0.01,
                 eini: float = -1.0, device=None):
        super().__init__()
        self.vocab_size, self.beta = vocab_size, beta
        self.use_entropy_loss, self.entropy_temp = use_entropy_loss, entropy_temp
        self.codebook = Codebook(vocab_size, vocab_width, eini, device)
        self.register_buffer("vocab_usage", torch.zeros(vocab_size, device=device))
        self.register_buffer("usage_record_times",
                             torch.zeros((), dtype=torch.int64, device=device), persistent=False)

    def normalized_codebook(self) -> torch.Tensor:
        return l2_normalize(self.codebook.weight.float(), dim=-1)

    def forward(self, features: torch.Tensor, update_buffers: bool = False):
        """(B, L, C) -> (f_hat (B, L, C), vq_loss, entropy_loss, usage_pct)."""
        B, L, C = features.shape
        f = l2_normalize(features.reshape(-1, C), dim=-1).float()
        codebook = self.normalized_codebook()
        indices = (f.detach() @ codebook.t()).argmax(dim=1)
        entropy_loss = (entropy_loss_fn(f, codebook, 1.0 / self.entropy_temp)
                        if self.use_entropy_loss else f.new_zeros(()))
        f_hat = codebook[indices]
        vq_loss = (self.beta * (f_hat.detach() - f).square().mean()
                   + (f_hat - f.detach()).square().mean())
        f_hat = f + (f_hat - f).detach()  # straight-through

        with torch.no_grad():
            counts = sum_across(torch.bincount(indices, minlength=self.vocab_size).float())
            prob = counts / counts.sum().clamp_min(1.0)
            usage_pct = (prob > 0.01 / self.vocab_size).float().mean() * 100.0
            if update_buffers:
                t = self.usage_record_times
                alpha = torch.where(t == 0, 1.0, torch.where(t < 100, 0.1, 0.01))
                self.vocab_usage.copy_(self.vocab_usage * (1.0 - alpha) + prob * alpha)
                t.add_(1)
        return f_hat.reshape(B, L, C).to(features.dtype), vq_loss, entropy_loss, usage_pct

    @torch.no_grad()
    def f_to_idx(self, features: torch.Tensor) -> torch.Tensor:
        """(B, L, C) -> the nearest codes (B, L)."""
        B, L, C = features.shape
        f = l2_normalize(features.reshape(-1, C), dim=-1).float()
        return (f @ self.normalized_codebook().t()).argmax(dim=1).reshape(B, L)


class VectorQuantizerM(Module):
    """Channel-split multi-codebook quantizer (quant_utils.py:136-199): the
    width splits into `num_codebooks` chunks of vocab_width / num_codebooks,
    each with a codebook of vocab_size / num_codebooks codes."""

    def __init__(self, vocab_size: int, vocab_width: int, beta: float = 0.25,
                 use_entropy_loss: bool = False, entropy_temp: float = 0.01,
                 num_codebooks: int = 16, device=None):
        super().__init__()
        self.num_codebooks = num_codebooks
        self.codebooks = nn.ModuleList(
            VectorQuantizer(vocab_size // num_codebooks, vocab_width // num_codebooks, beta,
                            use_entropy_loss, entropy_temp, device=device)
            for _ in range(num_codebooks))

    def forward(self, features: torch.Tensor, update_buffers: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        outs, vq, ent, usage = [], 0.0, 0.0, 0.0
        for cb, chunk in zip(self.codebooks, features.chunk(self.num_codebooks, dim=-1)):
            f_hat, vq_i, ent_i, usage_i = cb(chunk, update_buffers)
            outs.append(f_hat)
            vq, ent, usage = vq + vq_i, ent + ent_i, usage + usage_i
        n = self.num_codebooks
        return torch.cat(outs, dim=-1), vq / n, ent / n, usage / n

    def f_to_idx(self, features: torch.Tensor) -> torch.Tensor:
        """(B, L, vocab_width) -> (B, num_codebooks, L)."""
        chunks = features.chunk(self.num_codebooks, dim=-1)
        return torch.stack([cb.f_to_idx(c) for cb, c in zip(self.codebooks, chunks)], dim=1)

    @torch.no_grad()
    def idx_to_f(self, indices: torch.Tensor) -> torch.Tensor:
        """(B, num_codebooks, L) -> (B, L, vocab_width) fp32 embeddings."""
        return torch.cat([cb.normalized_codebook()[indices[:, i]]
                          for i, cb in enumerate(self.codebooks)], dim=-1)

"""The sequential [D, G] training step (port of vfm_vae_tpu/train/train_step.py:
TrainState, _microbatches, Trainer.d_step and Trainer.g_step, :67-77, :165-304).

PyTorch runs eagerly, so each phase is one forward per microbatch, the
gradients the JAX step takes with jax.value_and_grad / jax.vjp, one Adam
step and (G) the EMA. Parameters live in the modules and are updated in
place; the state holds the optimisers, the EMA copy of the trainable G
parameters, the loss state and cur_nimg.

Gradient accumulation (num_accumulation = n): the batch splits into n
contiguous chunks, each chunk's gradients are taken as above and summed
(the JAX package sums, it does not average), the sum is cleaned once and
Adam steps once. D's spectral-norm buffers, G's buffers (x_avg and, in
discrete mode, the VQ usage EMAs and their record counters, which only
the G phase moves, as JAX threads g_bufs) and the loss state thread
through the chunks in order; the adaptive VF weight, the safe-loss
check and the skip gate are per chunk; the stats merge; the returned total
is the chunks' mean.

Several processes (parallel/mesh.py): each process holds its slice of the
global batch and takes chunk i of its own slice as its part of microbatch
i. JAX's vjp runs over the global microbatch, so the port averages over
the processes what the JAX step sees globally: the loss terms before the
safe-loss checks (every process takes the same skip decision), the two
anchor gradients before their norms (the VF weight) and the summed
gradients before Adam (one flat-bucket all-reduce per step). Without a
process group each of these is the identity.

Adaptive VF weight (:226-239): ||d rec / d anchor|| / (||d vf / d anchor|| +
1e-4), clipped to [0, 1e8] and times vf_loss_weight, from two gradients of
the same graph with respect to the anchor parameter (retain_graph); then
one backward of sum(weights * gate * terms). The skip gate multiplies the
gradients by zero and Adam still steps, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from ..core import stats as tstats
from ..parallel.mesh import all_reduce_mean, mean_across, rank_and_world
from .loss import G_TERMS, G_TRACKED, LossState, TotalLoss, init_loss_state
from .optim import adam, clean_grads, ema_beta, ema_update

G_STAT_NAMES = {
    "l1_pixel_loss": "Loss/G/l1_pixel_loss",
    "l2_pixel_loss": "Loss/G/l2_pixel_loss",
    "perceptual_loss": "Loss/G/perceptual_loss",
    "ssim_loss": "Loss/G/ssim_loss",
    "multiscale_pixel_loss": "Loss/G/multiscale_pixel_loss",
    "stylegan_t_gen_loss": "Loss/G/stylegan_t/loss",
    "patchgan_gen_loss": "Loss/G/patchgan/loss",
    "feature_matching_loss": "Loss/G/patchgan/feature_matching_loss",
    "clip_loss": "Loss/G/clip_loss",
    "vf_loss": "Loss/G/vf_loss",
    "kl_loss": "Loss/G/kl_loss",
    "vq_loss": "Loss/G/vq_loss",
    "entropy_loss": "Loss/G/entropy_loss",
}


@dataclass
class TrainState:
    ema: Dict[str, torch.Tensor]  # trainable G parameters only
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    loss_state: LossState
    cur_nimg: int = 0


def as_unit_float(real_img: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] batches are normalised on the device (train_step.py:54-64)."""
    return real_img.float() / 255.0 if real_img.dtype == torch.uint8 else real_img


def microbatches(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    """The leading (batch) axis split into n contiguous chunks (train_step.py:67-77)."""
    B = x.shape[0]
    if B % n:
        raise ValueError(f"batch {B} is not divisible into {n} microbatches")
    m = B // n
    return [x[i * m:(i + 1) * m] for i in range(n)]


def _grads(total: torch.Tensor, params: Sequence[torch.Tensor]) -> Sequence:
    """d total / d params (None where unused). A total that no parameter
    reaches, as D's while every adversarial branch waits for its warm-up,
    has none."""
    if not total.requires_grad:
        return [None] * len(params)
    return torch.autograd.grad(total, params, allow_unused=True)


def _add(a: Optional[List[torch.Tensor]], b: List[torch.Tensor]) -> List[torch.Tensor]:
    return b if a is None else [x + y for x, y in zip(a, b)]


class Trainer:
    """Binds the loss configuration, the trainable sets and the optimiser
    settings. Freezes everything outside the trainable sets
    (requires_grad_(False)); LPIPS is frozen by construction."""

    def __init__(self, loss: TotalLoss, g_trainable: Set[str], d_trainable: Set[str],
                 g_opt_kwargs: Optional[dict] = None, d_opt_kwargs: Optional[dict] = None,
                 batch_size: int = 512, ema_kimg: float = 160.0,
                 ema_rampup: Optional[float] = 0.05, num_accumulation: int = 1):
        if int(num_accumulation) < 1:
            raise ValueError(f"num_accumulation {num_accumulation} < 1")
        self.num_accumulation = int(num_accumulation)
        self.loss = loss
        self.G, self.D = loss.G, loss.D
        self.g_opt_kwargs = dict(g_opt_kwargs or {})
        self.d_opt_kwargs = dict(d_opt_kwargs or {})
        self.batch_size, self.ema_kimg, self.ema_rampup = batch_size, ema_kimg, ema_rampup
        self.g_params = self._freeze(self.G, g_trainable)
        self.d_params = self._freeze(self.D, d_trainable)
        self.record_grad_norms = False
        self.grad_norms: Dict[str, float] = {}

    @staticmethod
    def _freeze(module: torch.nn.Module, trainable: Set[str]) -> Dict[str, torch.nn.Parameter]:
        params = {}
        for name, p in module.named_parameters():
            p.requires_grad_(name in trainable)
            if name in trainable:
                params[name] = p
        missing = set(trainable) - set(params)
        if missing:
            raise KeyError(f"trainable names not in the module: {sorted(missing)[:4]}")
        return params

    def init_state(self, cur_nimg: int = 0) -> TrainState:
        dev = next(iter(self.g_params.values())).device
        return TrainState(
            ema={n: p.detach().clone() for n, p in self.g_params.items()},
            g_opt=adam(self.g_params.values(), **self.g_opt_kwargs),
            d_opt=adam(self.d_params.values(), **self.d_opt_kwargs),
            loss_state=init_loss_state(dev),
            cur_nimg=cur_nimg,
        )

    def _record(self, prefix: str, params: Dict[str, torch.nn.Parameter],
                grads: Sequence[torch.Tensor]) -> None:
        """With record_grad_norms set, keep each gradient's L2 norm (before
        the nan_to_num clean-up) in grad_norms under prefix + name."""
        if self.record_grad_norms:
            norms = torch.stack([g.detach().float().norm() for g in grads]).tolist()
            self.grad_norms.update({prefix + n: v for n, v in zip(params, norms)})

    def _reduce(self, prefix: str, params: Dict[str, torch.nn.Parameter],
                grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The summed gradients averaged over the processes; recorded again
        when they differ from the one microbatch's that d_gradients or
        g_gradients recorded."""
        world = rank_and_world()[1]
        grads = all_reduce_mean(grads)
        if self.num_accumulation > 1 or world > 1:
            self._record(prefix, params, grads)
        return grads

    @staticmethod
    def _apply(opt: torch.optim.Adam, params: Sequence[torch.nn.Parameter],
               grads: Sequence[torch.Tensor]) -> None:
        for p, g in zip(params, clean_grads(grads)):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)

    # -------------------------------------------------------------- D step

    def d_gradients(self, state: TrainState, real_img, eq: Tuple[float, int, bool],
                    generator: Optional[torch.Generator] = None, blur_sigma: float = 0.0):
        """The D loss and its gated gradients in d_params order, without the
        update (train_step.py:180-192): (gradients, total, aux)."""
        params = list(self.d_params.values())
        d_total, aux = self.loss.d_loss(real_img, eq, state.cur_nimg, generator, blur_sigma)
        grads = _grads(d_total, params)
        gate = 1.0 - aux["skip"].float()
        grads = [gate * (g if g is not None else torch.zeros_like(p))
                 for g, p in zip(grads, params)]
        self._record("D.", self.d_params, grads)
        return grads, d_total.detach(), aux

    def d_accumulate(self, state: TrainState, real_img, eq: Tuple[float, int, bool],
                     generator: Optional[torch.Generator] = None, blur_sigma: float = 0.0):
        """D's gradients summed over the step's microbatches and averaged
        over the processes, before the update: (gradients, stats, total; the
        total is the microbatches' and processes' mean)."""
        grads, stats, total = None, {}, 0.0
        for chunk in microbatches(real_img, self.num_accumulation):
            g, d_total, aux = self.d_gradients(state, chunk, eq, generator, blur_sigma)
            grads = _add(grads, g)
            stats = tstats.merge(stats, aux["stats"])
            total = total + d_total
        grads = self._reduce("D.", self.d_params, grads)
        return grads, stats, mean_across(total / self.num_accumulation)

    def d_step(self, state: TrainState, real_img, eq: Tuple[float, int, bool],
               generator: Optional[torch.Generator] = None, blur_sigma: float = 0.0):
        """One D update (train_step.py:165-204). Returns (state, stats, total)."""
        real_img = as_unit_float(real_img)
        grads, stats, total = self.d_accumulate(state, real_img, eq, generator, blur_sigma)
        self._apply(state.d_opt, list(self.d_params.values()), grads)
        return state, stats, total

    # -------------------------------------------------------------- G step

    def g_gradients(self, state: TrainState, real_img, eq: Tuple[float, int, bool],
                    generator: Optional[torch.Generator] = None, blur_sigma: float = 0.0,
                    update_buffers: bool = True, loss_state: Optional[LossState] = None):
        """The G microbatch (train_step.py:208-256) without the update:
        (gradients in g_params order, terms, new loss state, stats, total).
        `loss_state` is the previous microbatch's (default: the state's)."""
        params = list(self.g_params.values())
        terms, aux = self.loss.g_terms(real_img, eq, state.cur_nimg, generator, blur_sigma,
                                       update_buffers)
        skip, safe_marks, new_loss_state = self.loss.g_safe(
            terms, state.loss_state if loss_state is None else loss_state, state.cur_nimg)
        stacked = torch.stack(terms)
        dev = stacked.device
        if self.loss.use_adaptive_vf_loss and self.loss.vf_loss_weight > 0:
            # The two cotangent pulls of :228-237, each through the terms it
            # weighs only: a zero-weight term would send a zero gradient
            # through D or the decoder for nothing (the VF pull stops at z).
            anchor = self.G.vf_anchor()
            rec_w = self.loss.rec_weights().tolist()
            rec = sum(w * t for w, t in zip(rec_w, terms) if w != 0.0)
            g_rec, = torch.autograd.grad(rec, anchor, retain_graph=True, allow_unused=True)
            g_vf, = torch.autograd.grad(terms[G_TERMS.index("vf_loss")], anchor,
                                        retain_graph=True, allow_unused=True)
            zero = torch.zeros_like(anchor)
            g_rec, g_vf = all_reduce_mean([zero if g_rec is None else g_rec,
                                           zero if g_vf is None else g_vf])
            n_rec, n_vf = g_rec.norm(), g_vf.norm()
            cur_vf_w = (torch.clamp(n_rec / (n_vf + 1e-4), 0.0, 1e8)
                        * self.loss.vf_loss_weight).detach()
        else:
            cur_vf_w = torch.tensor(float(self.loss.vf_loss_weight), device=dev)
        weights = self.loss.g_weights(cur_vf_w)
        gate = 1.0 - skip.float()
        total = (weights * stacked).sum()
        grads = _grads((weights * gate * stacked).sum(), params)
        grads = [g if g is not None else torch.zeros_like(p) for g, p in zip(grads, params)]
        self._record("G.", self.g_params, grads)

        stats = dict(aux["stats"])
        tstats.report(stats, "Loss/G/skipped", skip.float())
        for i, name in enumerate(G_TRACKED):
            tstats.report(stats, f"Loss/G/is_safe/{name}", safe_marks[i].float())
        for i, name in enumerate(G_TERMS):
            tstats.report(stats, G_STAT_NAMES[name], terms[i])
        tstats.report(stats, "Loss/G/cur_vf_loss_weight", cur_vf_w)
        return grads, [t.detach() for t in terms], new_loss_state, stats, total.detach()

    def g_accumulate(self, state: TrainState, real_img, eq: Tuple[float, int, bool],
                     generator: Optional[torch.Generator] = None, blur_sigma: float = 0.0):
        """G's gradients summed over the step's microbatches (the loss state
        threaded through them) and averaged over the processes, before the
        update: (gradients, new loss state, stats, total)."""
        grads, stats, total, loss_state = None, {}, 0.0, state.loss_state
        for chunk in microbatches(real_img, self.num_accumulation):
            g, _, loss_state, st, t = self.g_gradients(state, chunk, eq, generator, blur_sigma,
                                                       loss_state=loss_state)
            grads = _add(grads, g)
            stats = tstats.merge(stats, st)
            total = total + t
        grads = self._reduce("G.", self.g_params, grads)
        return grads, loss_state, stats, mean_across(total / self.num_accumulation)

    def g_step(self, state: TrainState, real_img, eq: Tuple[float, int, bool],
               generator: Optional[torch.Generator] = None, blur_sigma: float = 0.0):
        """One G update with EMA (train_step.py:258-304); `real_img` is this
        process's slice of the global batch. Returns (state, stats, total)."""
        real_img = as_unit_float(real_img)
        grads, loss_state, stats, total = self.g_accumulate(state, real_img, eq, generator,
                                                            blur_sigma)
        self._apply(state.g_opt, list(self.g_params.values()), grads)
        beta = ema_beta(self.batch_size, state.cur_nimg, self.ema_kimg, self.ema_rampup)
        ema_update(state.ema, self.g_params, beta)
        state.loss_state = loss_state
        state.cur_nimg += real_img.shape[0] * rank_and_world()[1]
        return state, stats, total

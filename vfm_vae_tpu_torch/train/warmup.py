"""The discriminator warm-up state machine (port of vfm_vae_tpu/train/warmup.py;
reference training/loss.py:381-492 `_update_phase`).

Fed once a step with the pixel loss and the StyleGAN-T generator loss, it
keeps each in a sliding window of 100 and compares the means of the
window's two halves. While the StyleGAN-T warm-up waits, a pixel loss
below `pixel_thresh` whose halves differ by less than `pixel_diff_thresh`
counts one patience step each time the window fills (and then keeps its
later half); `pixel_patience` such steps turn the StyleGAN-T branch on.
The PatchGAN warm-up does the same with the StyleGAN-T loss and turns the
PatchGAN branch on, then turns off the reconstruction and quantization
losses (their flags and weights, loss.py:362-379) once.

It runs on the host between steps and changes the loss in place; eager
PyTorch reads the flags in the next step, where the JAX loop recompiles.
The loop feeds it the means over every process, so each process flips at
the same step. The reference switches the generator to a 'freeze32'
train mode at the PatchGAN flip, a mode its own generator never defines
(generator.py:1100-1124); the JAX package maps it to
'train_the_second_half_decoder', the documented stage-3 intent, and only
records it in `freeze_triggered`. Neither the JAX loop nor the port's acts
on it.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np


class WarmupFSM:
    WINDOW = 100  # two halves of 50 (loss.py:201)

    def __init__(self, loss, pixel_thresh: float = 0.1, pixel_diff_thresh: float = 0.01,
                 pixel_patience: int = 10, d_thresh: float = 0.1, d_diff_thresh: float = 0.05,
                 d_patience: int = 10):
        self.loss = loss  # a TotalLoss, whose flags and weights change in place
        self.pixel_window: deque = deque(maxlen=self.WINDOW)
        self.d_window: deque = deque(maxlen=self.WINDOW)
        self.pixel_thresh, self.pixel_diff_thresh = pixel_thresh, pixel_diff_thresh
        self.pixel_patience = pixel_patience
        self.d_thresh, self.d_diff_thresh, self.d_patience = d_thresh, d_diff_thresh, d_patience
        self.pixel_cn = 0
        self.d_cn = 0
        self.freeze_triggered = False
        self.off_done = False

    @property
    def active(self) -> bool:
        """Whether a warm-up still waits (the loop feeds the machine only then)."""
        l = self.loss
        return ((l.use_stylegan_t_disc_warmup and not l.stylegan_t_on)
                or (l.use_patchgan_disc_warmup and not l.patchgan_on))

    @staticmethod
    def _stable(window: deque) -> Optional[float]:
        """|mean(later half) - mean(earlier half)| of a full window, else None."""
        if len(window) < window.maxlen:
            return None
        vals = list(window)
        half = len(vals) // 2
        return abs(float(np.mean(vals[half:])) - float(np.mean(vals[:half])))

    def _later_half(self, window: deque) -> deque:
        vals = list(window)
        return deque(vals[len(vals) // 2:], maxlen=self.WINDOW)

    def update(self, pixel_loss_now: float, d_loss_now: float, cur_kimg: float) -> bool:
        """Feed one step's means; True if a flag or weight changed."""
        l = self.loss
        changed = False
        self.d_window.append(float(d_loss_now))

        if l.use_stylegan_t_disc_warmup and not l.stylegan_t_on:
            self.pixel_window.append(float(pixel_loss_now))
            if float(np.mean(self.pixel_window)) < self.pixel_thresh:
                diff = self._stable(self.pixel_window)
                if diff is not None:
                    if diff < self.pixel_diff_thresh:
                        self.pixel_cn += 1
                    elif self.pixel_cn > 0:
                        self.pixel_cn = 0
                    self.pixel_window = self._later_half(self.pixel_window)  # loss.py:431
                    if self.pixel_cn >= self.pixel_patience:
                        l.stylegan_t_on = True
                        print(f"[WARM-UP-StyleGAN-T] enabled @ {cur_kimg:.0f} kimg")
                        changed = True

        if l.use_patchgan_disc_warmup and not l.patchgan_on:
            if float(np.mean(self.d_window or [np.inf])) < self.d_thresh:
                diff = self._stable(self.d_window)
                if diff is not None:
                    if diff < self.d_diff_thresh:
                        self.d_cn += 1
                    elif self.d_cn > 0:
                        self.d_cn = 0
                    self.d_window = self._later_half(self.d_window)
                    if self.d_cn >= self.d_patience:
                        l.patchgan_on = True
                        self.freeze_triggered = True
                        print(f"[WARM-UP-PatchGAN] enabled @ {cur_kimg:.0f} kimg")
                        changed = True

        if l.patchgan_on and not self.off_done and l.use_patchgan_disc_warmup:
            self._off_reconstruction_losses()
            self.off_done = True
            changed = True
        return changed

    def _off_reconstruction_losses(self) -> None:
        """(loss.py:362-379)."""
        l = self.loss
        l.perceptual_loss_on = False
        l.ssim_loss_on = False
        l.multiscale_pixel_loss_on = False
        l.pixel_loss_on = False
        l.perceptual_loss_weight = 0.0
        l.ssim_loss_weight = 0.0
        l.multiscale_pixel_loss_weights = [0.0] * len(l.multiscale_pixel_loss_weights)
        l.l1_pixel_loss_weight = 0.0
        l.l2_pixel_loss_weight = 0.0
        l.kl_loss_weight = 0.0
        l.vq_loss_weight = 0.0
        l.vf_loss_weight = 0.0
        print("[Reconstruction & Quantization Losses] off")

"""GAN + reconstruction losses of the four training stages (port of
vfm_vae_tpu/train/loss.py; reference training/loss.py).

`g_terms` returns the vector of raw G loss terms in G_TERMS order (zero for
the terms the configuration turns off); the train step derives the
training gradient from the weighted sum and the adaptive VF weight from
gradients of the rec-weighted sum and of the VF term at the adapter anchor.
The safe-loss checks are tensor operations, as in the JAX package. Value
ranges: real images in [0, 1], generated in [-1, 1].

Stage 2 adds SSIM, stage 3 the PatchGAN terms and feature matching. The
compression mode picks the adapter's terms: the KL loss (continuous), or
the VQ and entropy losses with the codebook usage stat (discrete). Every
image D sees is blurred by `blur_image` at the step's `blur_sigma`, whose
schedule fades from blur_init_sigma to 0 over blur_fade_kimg. The
discriminator warm-ups (train/warmup.py) start with their branch off
(`stylegan_t_on`, `patchgan_on`) and flip these flags and the loss weights
between steps. Not ported, and refused at construction: the CLIP and
matching-aware losses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import stats as tstats
from ..ops.resize import resize_bicubic, resize_bilinear, rot90
from ..parallel.mesh import mean_across
from .ssim import ssim as ssim_fn

G_TERMS = (
    "l1_pixel_loss",
    "l2_pixel_loss",
    "perceptual_loss",
    "ssim_loss",
    "multiscale_pixel_loss",
    "stylegan_t_gen_loss",
    "patchgan_gen_loss",
    "feature_matching_loss",
    "clip_loss",
    "vf_loss",
    "kl_loss",
    "vq_loss",
    "entropy_loss",
)
# Terms subject to the 10x-previous check (loss.py:884); the rest only get
# the finiteness check.
G_REC_TERMS = ("l1_pixel_loss", "l2_pixel_loss", "perceptual_loss", "ssim_loss",
               "multiscale_pixel_loss")
# Terms tracked across steps (loss.py:858-868).
G_TRACKED = G_TERMS[:9]
D_TERMS = (
    "stylegan_t_gen_loss",
    "stylegan_t_real_loss",
    "patchgan_gen_loss",
    "patchgan_real_loss",
    "matching_aware_loss",
)
SAFE_LOSS_CHECKING_START_NIMG = 50_000


@dataclass
class LossState:
    """Cross-step G loss state: the previous tracked terms and whether there are any."""

    prev_g_loss: torch.Tensor  # (len(G_TRACKED),) fp32
    has_prev: torch.Tensor  # () bool


def init_loss_state(device) -> LossState:
    return LossState(torch.zeros(len(G_TRACKED), device=device),
                     torch.zeros((), dtype=torch.bool, device=device))


def blur_image(img: torch.Tensor, blur_sigma: float) -> torch.Tensor:
    """The 2^-x blur of loss.py:83-89 (reference loss.py:224-231) on an NHWC
    batch: taps exp2(-(i / sigma)^2) for |i| <= floor(3 sigma), normalized,
    run down the columns and then along the rows with zero padding (the JAX
    filter2d's separable upfirdn2d). The identity below sigma 1/3."""
    blur_size = int(np.floor(blur_sigma * 3))
    if blur_size <= 0:
        return img
    f = np.exp2(-((np.arange(-blur_size, blur_size + 1) / blur_sigma) ** 2))
    taps = torch.tensor((f / f.sum()).astype(np.float32), dtype=img.dtype, device=img.device)
    C = img.shape[-1]
    x = img.permute(0, 3, 1, 2)
    x = F.conv2d(x, taps.view(1, 1, -1, 1).expand(C, 1, -1, 1), padding=(blur_size, 0),
                 groups=C)
    x = F.conv2d(x, taps.view(1, 1, 1, -1).expand(C, 1, 1, -1), padding=(0, blur_size),
                 groups=C)
    return x.permute(0, 2, 3, 1)


def hinge_d_loss(logits: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "real":
        return torch.relu(1.0 - logits).mean()
    return torch.relu(1.0 + logits).mean()


def _bce_with_logits(pred: torch.Tensor, target: float) -> torch.Tensor:
    return (torch.relu(pred) - pred * target + torch.log1p(torch.exp(-pred.abs()))).mean()


def patchgan_d_loss(preds: Sequence[torch.Tensor], kind: str, loss_type: str) -> torch.Tensor:
    """(loss.py:107): the mean over scales of each scale's last-layer loss."""
    target = 1.0 if kind == "real" else 0.0
    total = 0.0
    for pred in preds:
        if loss_type == "bce":
            total = total + _bce_with_logits(pred, target)
        elif loss_type == "mse":
            total = total + (pred - target).square().mean()
        elif loss_type == "hinge":
            total = total + hinge_d_loss(pred, kind)
        else:
            raise ValueError(loss_type)
    return total / len(preds)


def patchgan_g_loss(preds: Sequence[torch.Tensor], loss_type: str) -> torch.Tensor:
    """(loss.py:129)."""
    total = 0.0
    for pred in preds:
        if loss_type == "bce":
            total = total + _bce_with_logits(pred, 1.0)
        elif loss_type == "mse":
            total = total + (pred - 1.0).square().mean()
        elif loss_type == "hinge":
            total = total + (-pred).mean()
        else:
            raise ValueError(loss_type)
    return total / len(preds)


def feature_matching_loss(real_feats, fake_feats) -> torch.Tensor:
    """pix2pixHD weighting (loss.py:149): every scale's layers but the last,
    the real features held constant."""
    total = 0.0
    d_w = 1.0 / len(real_feats)
    for rf, ff in zip(real_feats, fake_feats):
        feat_w = 4.0 / max(len(rf) - 1, 1)
        for r, f in zip(rf[:-1], ff[:-1]):
            total = total + d_w * feat_w * (f - r.detach()).abs().mean()
    return total


class ImageTransform:
    """EQ alignment of real images and multiscale target resizing
    (loss.py:167-192); the angle is a host integer."""

    def __init__(self, apply_equivariance: bool, interpolation: str):
        self.apply_equivariance = apply_equivariance
        self.interpolation = interpolation

    def _resize(self, img, *, size=None, scale_factor=None):
        fn = resize_bicubic if self.interpolation == "bicubic" else resize_bilinear
        if size is not None:
            return fn(img, size=(size, size), antialias=size < img.shape[1])
        return fn(img, scale_factor=scale_factor, antialias=scale_factor < 1.0)

    def __call__(self, img, eq_scale_factor: float, eq_angle_factor: int):
        if self.apply_equivariance:
            if eq_scale_factor != 1.0:
                img = self._resize(img, scale_factor=eq_scale_factor)
            img = rot90(img, eq_angle_factor, dims=(2, 1))
        return img

    def multiscale(self, img, targets):
        return [self._resize(img, size=int(t.shape[1])) for t in targets]


class TotalLoss:
    """The loss configuration bound to the port's G, D and LPIPS modules.
    Keywords are the JAX TotalLoss's (training/loss.py:77-112)."""

    def __init__(
        self,
        G,
        D,
        vfm_name: str,
        resume_kimg: int = 0,
        use_equivariance_regularization: bool = False,
        lpips_module=None,
        blur_init_sigma: float = 2.0,
        blur_fade_kimg: int = 0,
        l1_pixel_loss_weight: float = 1.0,
        l2_pixel_loss_weight: float = 0.0,
        perceptual_loss_weight: float = 10.0,
        ssim_loss_weight: float = 0.0,
        multiscale_pixel_loss_weights: Sequence[float] = (),
        multiscale_block_indices: Sequence[int] = (),
        multiscale_pixel_loss_start_kimg: int = 0,
        multiscale_pixel_loss_end_kimg: int = 2000,
        vf_loss_weight: float = 0.0,
        use_adaptive_vf_loss: bool = False,
        clip_loss_weight: float = 0.0,
        matching_aware_loss_weight: float = 0.0,
        compression_mode: str = "continuous",
        kl_loss_weight: float = 1e-6,
        entropy_loss_weight: float = 0.0,
        vq_loss_weight: float = 1.0,
        stylegan_t_discriminator_loss_weight: float = 1.0,
        patchgan_discriminator_loss_weight: float = 0.0,
        patchgan_discriminator_loss_type: str = "mse",
        feature_matching_loss_weight: float = 1.0,
        use_stylegan_t_disc_warmup: bool = False,
        use_patchgan_disc_warmup: bool = False,
        total_kimg: int = 0,
    ):
        unsupported = {
            "clip_loss_weight": clip_loss_weight > 0,
            "matching_aware_loss_weight": matching_aware_loss_weight > 0,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"TotalLoss: not ported for {bad}")
        if compression_mode not in ("continuous", "discrete"):
            raise ValueError(f"TotalLoss: compression_mode {compression_mode!r}")
        self.G, self.D, self.lpips = G, D, lpips_module
        name = vfm_name.lower()
        interp = "bicubic" if any(k in name for k in ("qwen", "dino", "eva")) else "bilinear"
        self.img_transform = ImageTransform(use_equivariance_regularization, interp)
        self.resume_kimg = resume_kimg
        self.blur_init_sigma, self.blur_fade_kimg = blur_init_sigma, blur_fade_kimg
        self.compression_mode = compression_mode
        self.l1_pixel_loss_weight = l1_pixel_loss_weight
        self.l2_pixel_loss_weight = l2_pixel_loss_weight
        self.perceptual_loss_weight = perceptual_loss_weight
        self.ssim_loss_weight = ssim_loss_weight
        self.multiscale_pixel_loss_weights = list(multiscale_pixel_loss_weights)
        self.multiscale_block_indices = list(multiscale_block_indices)
        self.multiscale_pixel_loss_start_kimg = multiscale_pixel_loss_start_kimg
        self.multiscale_pixel_loss_end_kimg = multiscale_pixel_loss_end_kimg
        self.vf_loss_weight = vf_loss_weight
        self.use_adaptive_vf_loss = use_adaptive_vf_loss
        self.kl_loss_weight = kl_loss_weight
        self.entropy_loss_weight, self.vq_loss_weight = entropy_loss_weight, vq_loss_weight
        self.stylegan_t_discriminator_loss_weight = stylegan_t_discriminator_loss_weight
        self.patchgan_discriminator_loss_weight = patchgan_discriminator_loss_weight
        self.patchgan_discriminator_loss_type = patchgan_discriminator_loss_type
        self.feature_matching_loss_weight = feature_matching_loss_weight
        self.use_stylegan_t_disc_warmup = use_stylegan_t_disc_warmup
        self.use_patchgan_disc_warmup = use_patchgan_disc_warmup
        # The flags the warm-up machine flips (loss.py:283-288): a branch
        # under warm-up starts off.
        self.stylegan_t_on = (stylegan_t_discriminator_loss_weight > 0
                              and not use_stylegan_t_disc_warmup)
        self.patchgan_on = (patchgan_discriminator_loss_weight > 0
                            and not use_patchgan_disc_warmup)
        self.pixel_loss_on = l1_pixel_loss_weight > 0 or l2_pixel_loss_weight > 0
        self.perceptual_loss_on = perceptual_loss_weight > 0
        self.ssim_loss_on = ssim_loss_weight > 0
        self.multiscale_pixel_loss_on = sum(self.multiscale_pixel_loss_weights) > 0

    @property
    def feature_matching_on(self) -> bool:
        return (self.patchgan_on and self.feature_matching_loss_weight > 0
                and self.patchgan_discriminator_loss_weight > 0)

    def blur_sigma(self, cur_nimg: int) -> float:
        """D's input blur at `cur_nimg` (loss.py:293-299): blur_init_sigma
        fading linearly to 0 over blur_fade_kimg, rounded to 0.25 steps; 0
        when blur_fade_kimg <= 1."""
        if self.blur_fade_kimg > 1:
            s = max(1 - cur_nimg / (self.blur_fade_kimg * 1e3), 0) * self.blur_init_sigma
            return round(s * 4) / 4
        return 0.0

    # ------------------------------------------------------------ G terms

    def g_terms(self, real_img: torch.Tensor, eq: Tuple[float, int, bool], cur_nimg: float,
                generator: Optional[torch.Generator] = None, blur_sigma: float = 0.0,
                update_buffers: bool = True):
        """(terms list in G_TERMS order, aux). Differentiable with respect to
        G's parameters; D runs with its parameters in the graph, so the caller
        takes gradients with respect to G's parameters only (loss.py:317-456).
        `generator` draws the posterior sample and D's augmentation and crop."""
        stats: Dict[str, torch.Tensor] = {}
        gen_out = self.G(real_img, eq, generator=generator, update_buffers=update_buffers)
        gen_img = gen_out.gen_img
        zero = gen_img.new_zeros(())
        terms = {name: zero for name in G_TERMS}

        d_out = None
        if self.stylegan_t_on or self.patchgan_on:
            d_out = self.D(blur_image(gen_img, blur_sigma), generator)
        if self.stylegan_t_on and self.stylegan_t_discriminator_loss_weight > 0:
            logits = d_out.stylegan_t_logits
            terms["stylegan_t_gen_loss"] = (-logits).mean()
            tstats.report(stats, "Loss/G/stylegan_t/fake_scores", logits)
            tstats.report(stats, "Loss/G/stylegan_t/fake_signs", torch.sign(logits))
        if self.patchgan_on and self.patchgan_discriminator_loss_weight > 0 \
                and d_out.patchgan_logits:
            terms["patchgan_gen_loss"] = patchgan_g_loss(d_out.patchgan_logits,
                                                         self.patchgan_discriminator_loss_type)

        eq_scale, eq_angle, _ = eq
        real_t = self.img_transform(real_img, eq_scale, eq_angle)
        real_pm1 = real_t * 2.0 - 1.0

        if self.feature_matching_on and d_out.patchgan_features:
            # D's pass over the real image advances its spectral-norm state as
            # the JAX step's does; its features enter as constants.
            with torch.no_grad():
                real_feats = self.D(blur_image(real_pm1, blur_sigma), generator).patchgan_features
            terms["feature_matching_loss"] = feature_matching_loss(real_feats,
                                                                   d_out.patchgan_features)

        if self.pixel_loss_on and self.l1_pixel_loss_weight > 0:
            terms["l1_pixel_loss"] = (real_pm1 - gen_img).abs().mean()
        if self.pixel_loss_on and self.l2_pixel_loss_weight > 0:
            terms["l2_pixel_loss"] = (real_pm1 - gen_img).square().mean()
        if self.perceptual_loss_on:
            terms["perceptual_loss"] = self.lpips(real_pm1, gen_img).mean()
        if self.ssim_loss_on:
            terms["ssim_loss"] = 1.0 - ssim_fn(gen_img.clamp(-1, 1), real_pm1.clamp(-1, 1),
                                               data_range=2.0)

        if self.multiscale_pixel_loss_on:
            real_ms = self.img_transform.multiscale(real_t, gen_out.gen_multiscale_imgs)
            in_window = float(self.multiscale_pixel_loss_start_kimg * 1e3 <= cur_nimg
                              < self.multiscale_pixel_loss_end_kimg * 1e3)
            ms_total = zero
            for i, gen_ms in enumerate(gen_out.gen_multiscale_imgs):
                w = (self.multiscale_pixel_loss_weights[self.multiscale_block_indices.index(i)]
                     if i in self.multiscale_block_indices else 0.0)
                li = (real_ms[i] * 2 - 1 - gen_ms).abs().mean()
                ms_total = ms_total + w * li
                tstats.report(stats, f"Loss/G/multiscale_pixel_loss_block{i:01d}", li)
            terms["multiscale_pixel_loss"] = ms_total * in_window

        if self.vf_loss_weight > 0:
            terms["vf_loss"] = gen_out.vf_loss
        if self.compression_mode == "continuous":
            terms["kl_loss"] = gen_out.kl_loss
        else:
            terms["vq_loss"] = gen_out.vq_loss
            terms["entropy_loss"] = gen_out.entropy_loss
            tstats.report(stats, "Loss/G/codebook_usages", gen_out.codebook_usages)
        aux = {"stats": stats, "gen_img": gen_img.detach()}
        return [terms[name] for name in G_TERMS], aux

    def g_weights(self, cur_vf_weight) -> torch.Tensor:
        """Weights in G_TERMS order (loss.py:458-475); `cur_vf_weight` may be a tensor."""
        vf = torch.as_tensor(cur_vf_weight, dtype=torch.float32)
        w = self.rec_weights().to(vf.device)
        if self.stylegan_t_on:
            w[G_TERMS.index("stylegan_t_gen_loss")] = self.stylegan_t_discriminator_loss_weight
        if self.patchgan_on:
            w[G_TERMS.index("patchgan_gen_loss")] = self.patchgan_discriminator_loss_weight
            w[G_TERMS.index("feature_matching_loss")] = self.feature_matching_loss_weight
        if self.compression_mode == "continuous":
            w[G_TERMS.index("kl_loss")] = self.kl_loss_weight
        else:
            w[G_TERMS.index("vq_loss")] = self.vq_loss_weight
            w[G_TERMS.index("entropy_loss")] = self.entropy_loss_weight
        w[G_TERMS.index("vf_loss")] = vf
        return w

    def rec_weights(self) -> torch.Tensor:
        """The weights that select main_rec_loss (loss.py:794-810)."""
        w = torch.zeros(len(G_TERMS))
        idx = {n: i for i, n in enumerate(G_TERMS)}
        if self.pixel_loss_on:
            w[idx["l1_pixel_loss"]] = self.l1_pixel_loss_weight
            w[idx["l2_pixel_loss"]] = self.l2_pixel_loss_weight
        if self.perceptual_loss_on:
            w[idx["perceptual_loss"]] = self.perceptual_loss_weight
        if self.ssim_loss_on:
            w[idx["ssim_loss"]] = self.ssim_loss_weight
        if self.multiscale_pixel_loss_on:
            w[idx["multiscale_pixel_loss"]] = 1.0
        return w

    # ------------------------------------------------------------ G safety

    def g_safe(self, terms: Sequence[torch.Tensor], state: LossState, cur_nimg: float):
        """Safe-loss check (loss.py:499-519): (skip, per-term safe marks, new
        state). Under several processes the terms are first averaged over
        them: the JAX step checks the global microbatch's terms, and every
        process must take the same skip decision."""
        vals = mean_across(torch.stack([terms[G_TERMS.index(n)].detach().float()
                                        for n in G_TRACKED]))
        finite = torch.isfinite(vals)
        too_large = (state.prev_g_loss > 1e-6) & (vals > state.prev_g_loss * 10)
        is_rec = torch.tensor([n in G_REC_TERMS for n in G_TRACKED], device=vals.device)
        unsafe = torch.where(is_rec, ~finite | too_large, ~finite)
        active = cur_nimg > self.resume_kimg * 1e3 + SAFE_LOSS_CHECKING_START_NIMG
        unsafe = unsafe & state.has_prev & active
        skip = unsafe.any()
        clean = torch.nan_to_num(vals, nan=0.0, posinf=0.0, neginf=0.0)
        new_state = LossState(torch.where(skip, state.prev_g_loss, clean), state.has_prev | ~skip)
        return skip, (~unsafe).to(torch.int32), new_state

    # ------------------------------------------------------------ D loss

    def d_loss(self, real_img: torch.Tensor, eq: Tuple[float, int, bool], cur_nimg: float,
               generator: Optional[torch.Generator] = None, blur_sigma: float = 0.0):
        """Scalar D loss + aux; G runs without gradient (loss.py:523-546)."""
        with torch.no_grad():
            gen_img = self.G(real_img, eq, generator=generator).gen_img
        return self.d_loss_from_gen(gen_img, real_img, eq, cur_nimg, generator, blur_sigma)

    def d_loss_from_gen(self, gen_img, real_img, eq, cur_nimg: float,
                        generator: Optional[torch.Generator] = None, blur_sigma: float = 0.0):
        """D loss given a generated image (loss.py:548-654), with the safe
        check and nan_to_num of the total."""
        stats: Dict[str, torch.Tensor] = {}
        gen_out = self.D(blur_image(gen_img.detach(), blur_sigma), generator)
        eq_scale, eq_angle, _ = eq
        real_t = self.img_transform(real_img, eq_scale, eq_angle) * 2.0 - 1.0
        real_out = self.D(blur_image(real_t, blur_sigma), generator)
        gen_d, real_d = gen_out.stylegan_t_logits, real_out.stylegan_t_logits
        zero = gen_d.new_zeros(())
        terms = {name: zero for name in D_TERMS}
        if self.stylegan_t_on and self.stylegan_t_discriminator_loss_weight > 0:
            terms["stylegan_t_gen_loss"] = hinge_d_loss(gen_d, "fake")
            terms["stylegan_t_real_loss"] = hinge_d_loss(real_d, "real")
            tstats.report(stats, "Loss/D/stylegan_t/fake_scores", gen_d)
            tstats.report(stats, "Loss/D/stylegan_t/fake_signs", torch.sign(gen_d))
            tstats.report(stats, "Loss/D/stylegan_t/real_scores", real_d)
            tstats.report(stats, "Loss/D/stylegan_t/real_signs", torch.sign(real_d))
        if self.patchgan_on and self.patchgan_discriminator_loss_weight > 0 \
                and gen_out.patchgan_logits:
            kind = self.patchgan_discriminator_loss_type
            terms["patchgan_gen_loss"] = patchgan_d_loss(gen_out.patchgan_logits, "fake", kind)
            terms["patchgan_real_loss"] = patchgan_d_loss(real_out.patchgan_logits, "real", kind)
            for side, out in (("fake", gen_out), ("real", real_out)):
                for i, pred in enumerate(out.patchgan_logits):
                    scores = pred.reshape(pred.shape[0], -1).mean(dim=1)
                    tstats.report(stats, f"Loss/D/patchgan/{side}/scale{i}/{side}_scores",
                                  scores.mean())
                    tstats.report(stats, f"Loss/D/patchgan/{side}/scale{i}/{side}_signs",
                                  torch.sign(scores).mean())
        st = terms["stylegan_t_gen_loss"] + terms["stylegan_t_real_loss"]
        pg = terms["patchgan_gen_loss"] + terms["patchgan_real_loss"]
        d_total = (self.stylegan_t_discriminator_loss_weight * st
                   + self.patchgan_discriminator_loss_weight * pg)

        # The global microbatch's terms decide the skip (see g_safe).
        vals = mean_across(torch.stack([terms[n].detach() for n in D_TERMS]))
        active = cur_nimg > self.resume_kimg * 1e3 + SAFE_LOSS_CHECKING_START_NIMG
        unsafe = (~torch.isfinite(vals) | (vals.abs() > 1e4)) & active
        skip = unsafe.any()
        tstats.report(stats, "Loss/D/stylegan_t/gen_loss", terms["stylegan_t_gen_loss"])
        tstats.report(stats, "Loss/D/stylegan_t/real_loss", terms["stylegan_t_real_loss"])
        tstats.report(stats, "Loss/D/stylegan_t/loss", st)
        if self.patchgan_on:
            tstats.report(stats, "Loss/D/patchgan/gen_loss", terms["patchgan_gen_loss"])
            tstats.report(stats, "Loss/D/patchgan/real_loss", terms["patchgan_real_loss"])
            tstats.report(stats, "Loss/D/patchgan/loss", pg)
        tstats.report(stats, "Loss/D/skipped", skip.float())
        for i, n in enumerate(D_TERMS):
            tstats.report(stats, f"Loss/D/is_safe/{n}", (~unsafe[i]).float())
        d_total = torch.where(skip, zero, torch.nan_to_num(d_total, nan=0.0, posinf=0.0,
                                                            neginf=0.0))
        return d_total, {"stats": stats, "skip": skip}

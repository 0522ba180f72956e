"""The port's discriminator warm-up machine (vfm_vae_tpu_torch.train.warmup)
against the JAX package's, both driving their own package's TotalLoss
(built without modules: the machine reads and writes flags and weights
only). Both are fed the same seeded per-step loss sequences; they must
flip on the same step and leave the same flags and weights after every
step. Pure Python."""

import numpy as np
import pytest

from tests.test_torch_train import LOSS_KW
from vfm_vae_tpu.train.loss import TotalLoss as JaxTotalLoss
from vfm_vae_tpu.train.warmup import WarmupFSM as JaxWarmupFSM
from vfm_vae_tpu_torch.train.loss import TotalLoss
from vfm_vae_tpu_torch.train.warmup import WarmupFSM

WATCHED = ("stylegan_t_on", "patchgan_on", "pixel_loss_on", "perceptual_loss_on",
           "ssim_loss_on", "multiscale_pixel_loss_on", "perceptual_loss_weight",
           "ssim_loss_weight", "multiscale_pixel_loss_weights", "l1_pixel_loss_weight",
           "l2_pixel_loss_weight", "kl_loss_weight", "vq_loss_weight", "vf_loss_weight")
STEPS = 1500


def sequences(kind: str, seed: int):
    """(pixel loss, StyleGAN-T G loss) per step."""
    r = np.random.default_rng(seed)
    t = np.arange(STEPS)
    if kind == "trigger":  # both settle below their thresholds
        pix = 0.05 + 0.3 * np.exp(-t / 60) + 0.002 * r.standard_normal(STEPS)
        dgan = 0.05 + 0.01 * r.standard_normal(STEPS)
    elif kind == "no-trigger":  # the pixel loss stays high, the D loss wanders
        pix = 0.5 + 0.05 * r.standard_normal(STEPS)
        dgan = 0.08 + 0.2 * np.sin(t / 40) + 0.01 * r.standard_normal(STEPS)
    else:  # patchgan-only: the D loss settles late
        pix = 0.2 + 0.01 * r.standard_normal(STEPS)
        dgan = 0.04 + 0.5 * (t < 400) + 0.01 * r.standard_normal(STEPS)
    return pix, dgan


def state(loss) -> dict:
    return {k: getattr(loss, k) for k in WATCHED}


@pytest.mark.parametrize("kind,stylegan,patchgan", [
    ("trigger", True, True), ("no-trigger", True, True), ("patchgan-only", False, True),
    ("trigger", True, False)])
def test_warmup_flips_on_the_same_step_as_jax(kind, stylegan, patchgan):
    kw = dict(LOSS_KW, ssim_loss_weight=0.3, patchgan_discriminator_loss_weight=1.0,
              feature_matching_loss_weight=1.0, use_stylegan_t_disc_warmup=stylegan,
              use_patchgan_disc_warmup=patchgan)
    ours = TotalLoss(None, None, vfm_name="siglip2", **kw)
    theirs = JaxTotalLoss(None, None, vfm_name="siglip2", **kw)
    assert state(ours) == state(theirs)
    assert ours.stylegan_t_on is not stylegan and ours.patchgan_on is not patchgan
    fsm, jfsm = WarmupFSM(ours), JaxWarmupFSM(theirs)
    flips, jflips = [], []
    for step, (p, d) in enumerate(zip(*sequences(kind, seed=len(kind)))):
        if fsm.active:
            if fsm.update(p, d, step * 4 / 1000):
                flips.append(step)
        if jfsm.active:
            if jfsm.update(p, d, step * 4 / 1000):
                jflips.append(step)
        assert state(ours) == state(theirs), step
        assert fsm.active == jfsm.active
    assert flips == jflips
    assert (fsm.pixel_cn, fsm.d_cn, fsm.freeze_triggered, fsm.off_done) == \
        (jfsm.pixel_cn, jfsm.d_cn, jfsm.freeze_triggered, jfsm.off_done)
    if kind == "trigger":
        assert flips and not fsm.active
        if patchgan:  # the PatchGAN flip turns the reconstruction losses off
            assert fsm.off_done and ours.vq_loss_weight == 0.0 and not ours.pixel_loss_on
            assert fsm.freeze_triggered
    if kind == "no-trigger":
        assert not flips and fsm.active and ours.l1_pixel_loss_weight > 0
    if kind == "patchgan-only":
        assert flips and ours.patchgan_on and ours.stylegan_t_on  # StyleGAN-T never waited

"""The port's discriminator, LPIPS, DiffAugment, EQ image transform, VF and
KL terms and the D loss (vfm_vae_tpu_torch) against the JAX package on the
CPU, in fp32: a tiny DINO as tests/test_train_step.py builds it, LPIPS at
32 px, and the D loss of the tiny generator of __graft_entry__._tiny_g_kwargs.
Random draws are made by JAX and handed to the port, or off on both sides.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from __graft_entry__ import _tiny_g_kwargs
from tests.test_torch_generator import jax_variables_from_port, randomize_zero_init, write_tiny_siglip
from vfm_vae_tpu.models.adapter import LDMAdapter as JaxAdapter
from vfm_vae_tpu.models.discriminator import ProjectedDiscriminator as JaxD
from vfm_vae_tpu.models.distributions import DiagonalGaussianDistribution as JaxDist
from vfm_vae_tpu.models.generator import Generator as JaxG
from vfm_vae_tpu.train.diffaug import diff_augment as jax_diff_augment
from vfm_vae_tpu.train.loss import ImageTransform as JaxImageTransform
from vfm_vae_tpu.train.loss import TotalLoss as JaxTotalLoss
from vfm_vae_tpu.train.lpips import LPIPS as JaxLPIPS
from vfm_vae_tpu_torch.models import convert
from vfm_vae_tpu_torch.models.adapter import EquivarianceTransform, LDMAdapter
from vfm_vae_tpu_torch.models.discriminator import ProjectedDiscriminator
from vfm_vae_tpu_torch.models.distributions import DiagonalGaussianDistribution
from vfm_vae_tpu_torch.models.generator import Generator
from vfm_vae_tpu_torch.train.diffaug import cutout_size, diff_augment, translation_shift
from vfm_vae_tpu_torch.train.loss import ImageTransform, TotalLoss
from vfm_vae_tpu_torch.train.lpips import LPIPS
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY_DINO = dict(hidden_size=48, num_layers=2, num_heads=4, mlp_dim=96, patch_size=8,
                 image_size=32, hooks=(0, 1), hook_patch=True)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def fast_jit(fn, *args):
    """jit + run with XLA:CPU's cheap LLVM pipeline (same fp32 arithmetic)."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


@pytest.fixture(scope="module")
def disc():
    jd = JaxD(c_dim=0, vfm_name="siglip2", dino_kwargs=TINY_DINO)
    key = jax.random.key(1, impl="unsafe_rbg")
    dv = fast_jit(lambda r: jd.init({"params": r}, jnp.zeros((1, 32, 32, 3)), train=False), key)
    dp, db = np_tree(dv["params"]), np_tree(dv["buffers"])
    pd = ProjectedDiscriminator(vfm_name="siglip2", dino_kwargs=TINY_DINO)
    convert.load_state_dict_numpy(pd, convert.d_state_dict_from_jax(dp, db))
    return jd, dp, db, pd


@pytest.mark.parametrize("size", [32, 48, 24])
def test_projected_discriminator_matches_jax(disc, size):
    """Logits and the advanced spectral-norm buffers, at the DINO input size
    and through the antialiased down- and plain up-resize."""
    jd, dp, db, pd = disc
    convert.load_state_dict_numpy(pd, convert.d_state_dict_from_jax(dp, db))
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    out, mut = jd.apply({"params": dp, "buffers": db}, jnp.asarray(x), None, rng=None,
                        train=True, mutable=["buffers"])
    got = pd(torch.from_numpy(x))
    want = np.asarray(out.stylegan_t_logits)
    assert got.stylegan_t_logits.shape == want.shape == (2, 3 * 16)
    # fp32, sums in another order through two ViT blocks and the heads.
    np.testing.assert_allclose(got.stylegan_t_logits.detach().numpy(), want, rtol=1e-4, atol=1e-5)
    sd = convert.d_state_dict_from_jax(dp, np_tree(mut["buffers"]))
    for name, buf in pd.named_buffers():
        np.testing.assert_allclose(buf.numpy(), sd[name], rtol=1e-5, atol=1e-6, err_msg=name)


def test_discriminator_gradient_reaches_the_image_not_dino(disc):
    _, dp, db, pd = disc
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
    x.requires_grad_(True)
    pd(x).stylegan_t_logits.sum().backward()
    assert float(x.grad.abs().max()) > 0
    assert all(p.grad is None for p in pd.dino.parameters())
    assert all(p.grad is not None for p in pd.heads.parameters())
    pd.zero_grad(set_to_none=True)


def test_lpips_matches_jax():
    jl = JaxLPIPS()
    r = np.random.default_rng(5)
    x, y = (r.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    key = jax.random.key(2, impl="unsafe_rbg")
    lp = np_tree(fast_jit(lambda k: jl.init(k, jnp.asarray(x), jnp.asarray(y)), key)["params"])
    want = np.asarray(jl.apply({"params": lp}, jnp.asarray(x), jnp.asarray(y)))
    m = LPIPS()
    convert.load_state_dict_numpy(m, convert.lpips_state_dict_from_jax(lp))
    got = m(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2,) and not any(p.requires_grad for p in m.parameters())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


def jax_draws(key, B, H, W):
    """The draws jax diff_augment makes from `key`, in its split order."""
    draws = {}
    for name in ("brightness", "saturation", "contrast", "translation", "cutout"):
        key, sub = jax.random.split(key)
        if name in ("brightness", "saturation", "contrast"):
            draws[name] = jax.random.uniform(sub, (B, 1, 1, 1), jnp.float32)
        elif name == "translation":
            sh, sw = translation_shift(H), translation_shift(W)
            r1, r2 = jax.random.split(sub)
            draws["translate_h"] = jax.random.randint(r1, (B, 1, 1), -sh, sh + 1)
            draws["translate_w"] = jax.random.randint(r2, (B, 1, 1), -sw, sw + 1)
        else:
            ch, cw = cutout_size(H), cutout_size(W)
            r1, r2 = jax.random.split(sub)
            draws["cutout_h"] = jax.random.randint(r1, (B, 1, 1), 0, H + (1 - ch % 2))
            draws["cutout_w"] = jax.random.randint(r2, (B, 1, 1), 0, W + (1 - cw % 2))
    return {k: torch.from_numpy(np.array(v)).long() if v.dtype != jnp.float32
            else torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_diffaug_matches_jax_given_its_draws(seed):
    B, H, W = 3, 16, 12
    x = np.random.default_rng(seed).uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_diff_augment(key, jnp.asarray(x)))
    got = diff_augment(torch.from_numpy(x), jax_draws(key, B, H, W))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
@pytest.mark.parametrize("eq", [(1.0, 0), (0.5, 1), (0.75, 3)])
def test_image_transform_matches_jax(interp, eq):
    x = np.random.default_rng(7).random((2, 32, 32, 3)).astype(np.float32)
    jt, pt = JaxImageTransform(True, interp), ImageTransform(True, interp)
    want = np.asarray(jt(jnp.asarray(x), *eq))
    got = pt(torch.from_numpy(x), *eq)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    wm = jt.multiscale(jnp.asarray(want), [jnp.zeros((1, 8, 8, 3)), jnp.zeros((1, 4, 4, 3))])
    gm = pt.multiscale(got, [torch.zeros(1, 8, 8, 3), torch.zeros(1, 4, 4, 3)])
    for w, g in zip(wm, gm):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_vf_and_kl_terms_match_jax():
    r = np.random.default_rng(9)
    z = r.standard_normal((2, 4, 4, 24)).astype(np.float32)
    aux = r.standard_normal((2, 4, 4, 24)).astype(np.float32)
    kw = dict(patch_from_layers=[-1], patch_resolutions=[4], patch_in_dimensions=[24],
              patch_out_dimensions=[8])
    ja = JaxAdapter(**kw, compression_mode="continuous", how_to_compress="attnproj",
                    how_to_decompress="attnproj", decompress_factor=2, z_resolution=4,
                    z_dimension=8, distmat_margin=0.1, cos_margin=0.05, distmat_weight=0.7,
                    cos_weight=1.3)
    want = float(ja.apply({}, jnp.asarray(z), jnp.asarray(aux), method=ja._compute_vf_loss))
    pa = LDMAdapter(**kw, decompress_factor=2, z_resolution=4, z_dimension=8,
                    distmat_margin=0.1, cos_margin=0.05, distmat_weight=0.7, cos_weight=1.3)
    got = float(pa.vf_loss(torch.from_numpy(z), torch.from_numpy(aux)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    moments = r.standard_normal((2, 4, 4, 16)).astype(np.float32) * 3
    np.testing.assert_allclose(
        DiagonalGaussianDistribution(torch.from_numpy(moments)).kl().numpy(),
        np.asarray(JaxDist(jnp.asarray(moments)).kl()), rtol=1e-5)


def test_equivariance_transform_draws_like_jax():
    from vfm_vae_tpu.models.adapter import EquivarianceTransform as JaxEQ

    a, b = EquivarianceTransform(True, 0.5, 0.25), JaxEQ(True, 0.5, 0.25)
    ra, rb = np.random.default_rng(11), np.random.default_rng(11)
    got = [a(ra) for _ in range(64)]
    assert got == [b(rb) for _ in range(64)]
    assert {g[2] for g in got} == {True, False}
    assert EquivarianceTransform(False)(ra) == (1.0, 0, False)


def test_d_loss_matches_jax(disc, tmp_path):
    """The D loss and the gradient of every trainable D parameter, the
    generator running without gradient, draws off, identity EQ bucket. D's
    variables are the module fixture's (one XLA compile of D's init for the
    file); the port's D is loaded from them afresh."""
    kw = dict(_tiny_g_kwargs(write_tiny_siglip(tmp_path / "siglip2-tiny-patch8-32")),
              use_adaptive_vf_loss=True)
    jd, dp, db, _ = disc
    jg = JaxG(**kw)
    gp, gb = jax_variables_from_port(kw, seed=3)
    gp = randomize_zero_init(gp)
    jloss = JaxTotalLoss(jg, jd, vfm_name="siglip2", use_equivariance_regularization=True)
    real = np.random.default_rng(4).random((2, 32, 32, 3)).astype(np.float32)
    eq = (1.0, 0, False)

    def f(d_params, real):
        return jloss.d_loss(d_params, gp, gb, db, real, None, {}, eq, 0.0)[0]

    total, grads = fast_jit(jax.value_and_grad(f), dp, jnp.asarray(real))
    want_grads = convert.d_state_dict_from_jax(np_tree(grads), db)

    G = Generator(**kw)
    convert.load_state_dict_numpy(G, convert.state_dict_from_jax(
        gp, gb, geometry=convert.geometry_from_kwargs(kw)))
    D = ProjectedDiscriminator(vfm_name="siglip2", dino_kwargs=TINY_DINO)
    convert.load_state_dict_numpy(D, convert.d_state_dict_from_jax(dp, db))
    loss = TotalLoss(G, D, vfm_name="siglip2", use_equivariance_regularization=True)
    names = [n for n, _ in D.named_parameters() if not n.startswith("dino.")]
    params = [dict(D.named_parameters())[n] for n in names]
    got, aux = loss.d_loss(torch.from_numpy(real), eq, 0)
    assert not bool(aux["skip"])
    np.testing.assert_allclose(float(got.detach()), float(total), rtol=1e-4)
    grads = dict(zip(names, torch.autograd.grad(got, params)))
    top = max(float(np.abs(want_grads[n]).max()) for n in names)
    for n, g in grads.items():
        w = want_grads[n].reshape(g.shape)
        # A conv bias that feeds BatchNormLocal has an exactly zero gradient
        # (the mean subtraction removes it); both sides hold rounding noise
        # there, so it is held to the scale of all D gradients.
        before_bn = n.endswith((".main0.conv.bias", ".main1.conv.bias"))
        scale = top if before_bn else float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-3 * scale, err_msg=n)

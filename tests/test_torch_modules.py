"""The port's modules that hold or feed a kernel, against the JAX package's
modules on the CPU in fp32: same numpy inputs, JAX parameters from a seeded
init bridged into the port with the state_dict converters. Zero- and
tiny-initialised branches (layer scale, legacy noise strength, attention and
FF output projections, null KV) are set to O(0.1-1) values first, so a wrong
kernel twin or folding cannot hide behind them."""

import numpy as np
import pytest

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import torch

from vfm_vae_tpu.models import adapter as jad
from vfm_vae_tpu.models import convnext as jcx
from vfm_vae_tpu.models import gigagan as jgg
from vfm_vae_tpu.models import vit as jvit
from vfm_vae_tpu_torch.models import adapter as tad
from vfm_vae_tpu_torch.models import convert
from vfm_vae_tpu_torch.models import convnext as tcx
from vfm_vae_tpu_torch.models import gigagan as tgg
from vfm_vae_tpu_torch.models import vit as tvit
from tests.torch_threads import one_torch_thread  # noqa: F401

RANDOMIZED = ("gamma", "noise_strength", "null_kv")


def randomize_zero_init(params, seed=0):
    """O(0.1-1) values, random sign, for the branches that start at (near) zero."""
    r = np.random.default_rng(seed)
    flat = tu.flatten_dict(jax.tree_util.tree_map(np.asarray, params), sep="/")
    for k, v in flat.items():
        if k.split("/")[-1] in RANDOMIZED or "/to_out/" in k or "/proj2/" in k:
            if k.endswith("norm/gamma"):
                continue
            flat[k] = (r.uniform(0.1, 1.0, v.shape) * r.choice([-1.0, 1.0], v.shape)
                       ).astype(np.float32)
    return tu.unflatten_dict(flat, sep="/")


def init_jax(module, *args, method=None, **kwargs):
    fn = lambda r: module.init({"params": r}, *args, method=method, **kwargs)  # noqa: E731
    v = jax.jit(fn)(jax.random.PRNGKey(0))
    return (jax.tree_util.tree_map(np.asarray, v["params"]),
            jax.tree_util.tree_map(np.asarray, v.get("buffers", {})))


def apply_jax(module, variables, *args, method=None, **kwargs):
    """Jitted apply: one compile beats op-by-op dispatch even at these sizes."""
    fn = lambda v, *a: module.apply(v, *a, method=method, **kwargs)  # noqa: E731
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(variables, *args))


def load(port_module, to_sd, params, *extra):
    sd = {}
    to_sd(sd, params, *extra)
    convert.load_state_dict_numpy(port_module, sd)
    return port_module.requires_grad_(False)


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("hw", [8, 4])
def test_convnext_synthesis_layer_matches_jax(hw):
    """hw=8 uses the legacy noise map as stored; hw=4 resizes it bilinearly."""
    C, w_dim, k = 32, 16, 5
    jm = jcx.ConvNeXtSynthesisLayer(C, w_dim, k, block_index=0, legacy=True)
    x, w = randn(1, 2, hw, hw, C), randn(2, 2, w_dim)
    params, buffers = init_jax(jm, jnp.asarray(x), jnp.asarray(w))
    params = randomize_zero_init(params)
    ref = apply_jax(jm, {"params": params, "buffers": buffers}, jnp.asarray(x), jnp.asarray(w))
    pm = load(tcx.ConvNeXtSynthesisLayer(C, w_dim, k, block_index=0, legacy=True),
              lambda sd, p: convert._convnext_layer(sd, p, buffers, "", True), params)
    got = pm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    # The port folds GN (one-pass fp32 moments) into K1's operands; JAX runs
    # the unfused two-pass chain. Equal in exact arithmetic; fp32 rounding.
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pre_normalize,blur", [(True, "3x3"), (True, "5x5"), (False, "3x3")])
def test_separable_upsample_matches_jax(pre_normalize, blur):
    cin, cout = 32, 16
    jm = jcx.SeparableUpsampleWithFixedBlur(cin, cout, pre_normalize=pre_normalize,
                                            blur_kernel=blur)
    x = randn(3, 2, 5, 6, cin)
    params, _ = init_jax(jm, jnp.asarray(x))
    ref = apply_jax(jm, {"params": params}, jnp.asarray(x))
    pm = load(tcx.SeparableUpsampleWithFixedBlur(cin, cout, blur, pre_normalize=pre_normalize),
              lambda sd, p: convert._separable_upsample(sd, p, ""), params)
    got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10, 12, cout)
    # pre_normalize: GN folded into K2's affine (one-pass moments) vs JAX's
    # unfused chain; otherwise the same plain chain. fp32 rounding only.
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_self_attention_block_matches_jax():
    dim, heads, dim_head = 32, 4, 8
    jm = jgg.SelfAttentionBlock(dim, dim_head=dim_head, heads=heads)
    x = randn(4, 2, 4, 5, dim)
    params, _ = init_jax(jm, jnp.asarray(x))
    params = randomize_zero_init(params)
    ref = apply_jax(jm, {"params": params}, jnp.asarray(x))
    pm = load(tgg.SelfAttentionBlock(dim, dim_head, heads),
              lambda sd, p: convert._self_attention_block(sd, p, ""), params)
    got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)  # fp32, summation order


@pytest.mark.parametrize("size", [16, 24])
def test_siglip_vision_tower_matches_jax(size):
    """size=16 is the tower's own grid; size=24 interpolates the pos-embed (bicubic)."""
    geo = dict(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64, patch_size=4, image_size=16)
    jm = jvit.SigLIPVisionTower(**geo)
    x = randn(5, 2, size, size, 3)
    params, _ = init_jax(jm, jnp.asarray(x))
    hs, last, _ = apply_jax(jm, {"params": params}, jnp.asarray(x))
    pm = load(tvit.SigLIPVisionTower(**geo),
              lambda sd, p: sd.update(convert.tower_state_dict_from_jax(p)), params)
    hidden, got_last, _ = pm(torch.from_numpy(x))
    for i in range(3):
        np.testing.assert_allclose(hidden[i].numpy(), np.asarray(hs[i]), rtol=1e-4, atol=1e-4)
    # fp32 through two transformer blocks; summation order differs.
    np.testing.assert_allclose(got_last.numpy(), np.asarray(last), rtol=1e-4, atol=1e-4)


def test_ldm_adapter_matches_jax():
    geo = dict(patch_from_layers=[0, 1, -1], patch_resolutions=[8, 8, 8],
               patch_in_dimensions=[32, 32, 32], patch_out_dimensions=[8, 8, 8],
               decompress_factor=4, z_resolution=4, z_dimension=4, use_vf_loss=True)
    jm = jad.LDMAdapter(compression_mode="continuous", how_to_compress="attnproj",
                        how_to_decompress="attnproj", **geo)
    feats = [randn(10 + i, 2, 64, 32) for i in range(3)]
    z_in = randn(20, 2, 4, 4, 4)

    def both(m, f, z):
        return m.encode(f, rng=None, return_z_before_quantize=True, train=False).z, m.decode(z)

    jf = [jnp.asarray(f) for f in feats]
    params, _ = init_jax(jm, jf, jnp.asarray(z_in), method=both)
    moments, dec_ref = apply_jax(jm, {"params": params}, jf, jnp.asarray(z_in), method=both)
    pm = load(tad.LDMAdapter(**geo), lambda sd, p: convert._adapter(sd, p, ""), params)
    tf = [torch.from_numpy(f) for f in feats]
    # fp32 attention projections; summation order differs.
    np.testing.assert_allclose(pm.encode(tf, return_z_before_quantize=True).numpy(), moments,
                               rtol=1e-4, atol=1e-4)
    # The posterior mode is the moments' mean half.
    np.testing.assert_allclose(pm.encode(tf).numpy(), moments[..., :4], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pm.decode(torch.from_numpy(z_in)).numpy(), dec_ref,
                               rtol=1e-4, atol=1e-4)

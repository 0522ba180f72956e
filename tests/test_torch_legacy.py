"""The port's unconditional decoders beyond the flagship's against the JAX
package on the CPU, in fp32: the StyleGAN-T ops (bias_act, fma, upfirdn2d
and its wrappers, conv2d_resample, filtered_lrelu), the legacy layers
(SynthesisInput, SynthesisLayer, ToRGBLayer), the upsample with the blur
off and with even taps, and tiny Generators with the legacy layers (skip
and orig), the Fourier first block, the blur off, multiscale off and the
unshuffle default concat widths; then one port-only stage-0 D and G step
on the legacy tiny Generator.

Ops and layers are held to 1e-5 of max |JAX| (fp32, summation order).
Generator parameters are drawn by a seeded port Generator and cross into
JAX through the JAX package's importer (convert_generator, and here the
legacy layers' names, which it has no converter for); the zero-initialised
branches are randomised on the JAX side and the variables come back into
the port through state_dict_from_jax, so JAX's init costs no XLA compile.
Tolerances of tests/test_generator_parity.py: encode moments 5e-4, decoded
pixels and multiscale images 2e-3."""

import importlib
import math

import numpy as np
import pytest

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import torch

from __graft_entry__ import _tiny_g_kwargs
from tests.test_torch_generator import randomize_zero_init, write_tiny_siglip
from tests.test_torch_modules import load
from vfm_vae_tpu.models import convert as jconvert
from vfm_vae_tpu.models import convnext as jcx
from vfm_vae_tpu.models import synthesis as jsyn
from vfm_vae_tpu.models.generator import Generator as JaxGenerator
from vfm_vae_tpu_torch.entry import kernel_sites
from vfm_vae_tpu_torch.models import convert
from vfm_vae_tpu_torch.models import convnext as tcx
from vfm_vae_tpu_torch.models import synthesis as tsyn
from vfm_vae_tpu_torch.models.generator import Generator
from tests.torch_threads import one_torch_thread  # noqa: F401

# The op modules (the JAX package's ops/__init__.py binds some of their
# names to functions).
jba, jfl, jfma, jrs, jup, tba, tfl, tfma, trs, tup = (
    importlib.import_module(f"{pkg}.ops.{name}") for pkg in ("vfm_vae_tpu", "vfm_vae_tpu_torch")
    for name in ("bias_act", "filtered_lrelu", "fma", "resample", "upfirdn"))

TOL = 1e-5  # of max |JAX|, fp32
# XLA:CPU compiles these programs in a fraction of the time without LLVM's
# expensive passes (as tests/test_torch_train.py does); the same fp32.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def compile_fast(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)


def init_jax(module, *args):
    fn = lambda r: module.init({"params": r}, *args)  # noqa: E731
    v = compile_fast(fn, jax.random.PRNGKey(0))(jax.random.PRNGKey(0))
    return (jax.tree_util.tree_map(np.asarray, v["params"]),
            jax.tree_util.tree_map(np.asarray, v.get("buffers", {})))


def apply_jax(module, variables, *args, method=None, **kwargs):
    fn = lambda v, *a: module.apply(v, *a, method=method, **kwargs)  # noqa: E731
    out = compile_fast(fn, variables, *args)(variables, *args)
    return jax.tree_util.tree_map(np.asarray, out)


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= tol * scale, (err, scale)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ ops


@pytest.mark.parametrize("act", sorted(jba.activation_funcs))
@pytest.mark.parametrize("gain,clamp", [(None, None), (0.7, 0.4)])
def test_bias_act_matches_jax(act, gain, clamp):
    x, b = randn(0, 2, 5, 6, 8) * 2, randn(1, 8)
    ref = jba.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, gain=gain, clamp=clamp)
    close(tba.bias_act(t(x), t(b), act=act, gain=gain, clamp=clamp), ref)
    assert tba.activation_funcs[act].def_gain == jba.activation_funcs[act].def_gain
    assert tba.activation_funcs[act].def_alpha == jba.activation_funcs[act].def_alpha


def test_bias_act_alpha_and_axis_match_jax():
    x, b = randn(2, 3, 4, 5), randn(3, 4)
    ref = jba.bias_act(jnp.asarray(x), jnp.asarray(b), axis=1, act="lrelu", alpha=0.1)
    close(tba.bias_act(t(x), t(b), dim=1, act="lrelu", alpha=0.1), ref)


def test_fma_matches_jax():
    a, b, c = randn(4, 3, 5), randn(5, 3, 5), randn(6, 5)
    close(tfma.fma(t(a), t(b), t(c)), jfma.fma(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))


# (filter, setup_filter kwargs, upfirdn2d kwargs): odd, even, separable
# (8 taps) and 2-D filters; up, down, padding with crops, flip, gain.
UPFIRDN = {
    "odd-up2": ([1, 2, 1], {}, dict(up=2, padding=1)),
    "even-up2": ([1, 3, 3, 1], {}, dict(up=2, padding=[2, 1, 2, 1])),
    "even-down2": ([1, 3, 3, 1], {}, dict(down=2, padding=[1, 1, 2, 0])),
    "separable-up2-down2": ([1, 3, 5, 7, 7, 5, 3, 1], {}, dict(up=2, down=2, padding=3)),
    "separable-up3x1": ([1, 2, 3, 4, 4, 3, 2, 1], dict(flip_filter=True),
                        dict(up=[3, 1], padding=[1, 2, 0, 0])),
    "2d-crop-flip-gain": (np.arange(12, dtype=np.float32).reshape(3, 4) + 1, dict(gain=2.0),
                          dict(padding=[-1, 2, 1, -1], flip_filter=True, gain=1.5)),
    "none-down2": (None, {}, dict(down=2)),
}


@pytest.mark.parametrize("case", sorted(UPFIRDN))
def test_upfirdn2d_matches_jax(case):
    f, fkw, kw = UPFIRDN[case]
    ft, fj = tup.setup_filter(f, **fkw), jup.setup_filter(f, **fkw)
    np.testing.assert_array_equal(ft, fj)
    x = randn(7, 2, 9, 7, 3)
    close(tup.upfirdn2d(t(x), ft, **kw), jup.upfirdn2d(jnp.asarray(x), fj, **kw))


@pytest.mark.parametrize("fn", ["filter2d", "upsample2d", "downsample2d"])
@pytest.mark.parametrize("taps", [[1, 2, 1], [1, 3, 3, 1]])
@pytest.mark.parametrize("padding,flip", [(0, False), ([1, 0, 2, 1], True)])
def test_fir_wrappers_match_jax(fn, taps, padding, flip):
    f = jup.setup_filter(taps)
    x = randn(8, 2, 8, 6, 4)
    ref = getattr(jup, fn)(jnp.asarray(x), f, padding=padding, flip_filter=flip, gain=1.25)
    close(getattr(tup, fn)(t(x), f, padding=padding, flip_filter=flip, gain=1.25), ref)


@pytest.mark.parametrize("up,down,k,flip", [(2, 1, 3, False), (1, 2, 3, True), (1, 1, 1, True),
                                            (1, 1, 3, True), (2, 1, 1, False), (1, 2, 1, True)])
def test_conv2d_resample_matches_jax(up, down, k, flip):
    f = jup.setup_filter([1, 3, 3, 1])
    x, w = randn(9, 2, 6, 7, 5), randn(10, k, k, 5, 4)  # HWIO, JAX's layout
    ref = jrs.conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=f, up=up, down=down,
                              padding=k // 2, flip_weight=flip)
    got = trs.conv2d_resample(t(x), t(w.transpose(3, 2, 0, 1)), f=f, up=up, down=down,
                              padding=k // 2, flip_weight=flip)
    close(got, ref)


@pytest.mark.parametrize("up,down,clamp", [(2, 2, 0.5), (1, 1, None), (2, 1, None)])
def test_filtered_lrelu_matches_jax(up, down, clamp):
    fu, fd = jup.setup_filter([1, 3, 3, 1]), jup.setup_filter([1, 2, 1])
    x, b = randn(11, 2, 7, 6, 3), randn(12, 3)
    kw = dict(fu=fu, fd=fd, up=up, down=down, padding=[2, 1, 1, 2], clamp=clamp)
    close(tfl.filtered_lrelu(t(x), b=t(b), **kw), jfl.filtered_lrelu(jnp.asarray(x),
                                                                       b=jnp.asarray(b), **kw))


@pytest.mark.parametrize("k,demodulate", [(3, True), (1, False)])
def test_modulated_conv2d_matches_jax(k, demodulate):
    from vfm_vae_tpu.models.modulated import modulated_conv2d as jmc
    from vfm_vae_tpu_torch.models.modulated import modulated_conv2d as tmc

    x, w, st = randn(26, 2, 6, 5, 8), randn(27, k, k, 8, 4), randn(28, 2, 8)  # w HWIO
    ref = jmc(jnp.asarray(x), jnp.asarray(w), jnp.asarray(st), padding=k // 2,
              demodulate=demodulate)
    close(tmc(t(x), t(w.transpose(3, 2, 0, 1)), t(st), padding=k // 2, demodulate=demodulate),
          ref)


# ------------------------------------------------------------------ layers


def test_synthesis_input_matches_jax():
    C, w_dim, size = 16, 12, 8
    jm = jsyn.SynthesisInput(w_dim=w_dim, channels=C, size=size, sampling_rate=size, bandwidth=2)
    w = randn(13, 2, w_dim)
    params, buffers = init_jax(jm, jnp.asarray(w))
    # The affine starts at zero (the identity transform): draw it, and a
    # transform other than the identity.
    params["affine"]["weight"] = randn(14, w_dim, 4) * 0.3
    buffers = dict(buffers, transform=np.eye(3, dtype=np.float32) + randn(15, 3, 3) * 0.1)
    ref = apply_jax(jm, {"params": params, "buffers": buffers}, jnp.asarray(w))
    pm = load(tsyn.SynthesisInput(w_dim, C, size, size, 2),
              lambda sd, p: convert._synthesis_input(sd, p, buffers, ""), params)
    close(pm(t(w)), ref)


# A residual layer with up=2 adds its input at half the size: JAX cannot
# broadcast it either, and no block builds one.
@pytest.mark.parametrize("up,residual", [(1, False), (2, False), (1, True)])
def test_synthesis_layer_matches_jax(up, residual):
    C, w_dim, res = 32, 12, 8
    jm = jsyn.SynthesisLayer(C, C, w_dim, res, up=up, residual=residual, gn_groups=8,
                             conv_clamp=256)
    x, w = randn(16, 2, res // up, res // up, C), randn(17, 2, w_dim)
    params, buffers = init_jax(jm, jnp.asarray(x), jnp.asarray(w))
    params = randomize_zero_init(params)
    ref = apply_jax(jm, {"params": params, "buffers": buffers}, jnp.asarray(x), jnp.asarray(w))
    pm = load(tsyn.SynthesisLayer(C, C, w_dim, res, up=up, residual=residual, gn_groups=8,
                                  conv_clamp=256),
              lambda sd, p: convert._synthesis_layer(sd, p, buffers, ""), params)
    close(pm(t(x), t(w)), ref)


def test_synthesis_layer_clamps_and_gains_as_jax():
    """conv_clamp scaled by the gain, as the residual stack calls it."""
    C, w_dim, res, gain = 8, 6, 4, math.sqrt(0.5)
    jm = jsyn.SynthesisLayer(C, C, w_dim, res, conv_clamp=0.3)
    x, w = randn(18, 2, res, res, C) * 3, randn(19, 2, w_dim)
    params, buffers = init_jax(jm, jnp.asarray(x), jnp.asarray(w))
    ref = apply_jax(jm, {"params": params, "buffers": buffers}, jnp.asarray(x), jnp.asarray(w),
                    gain=gain)
    assert float(np.abs(ref).max()) == pytest.approx(0.3 * gain)
    pm = load(tsyn.SynthesisLayer(C, C, w_dim, res, conv_clamp=0.3),
              lambda sd, p: convert._synthesis_layer(sd, p, buffers, ""), params)
    close(pm(t(x), t(w), gain=gain), ref)


def test_torgb_layer_matches_jax():
    C, w_dim = 16, 12
    jm = jsyn.ToRGBLayer(C, 3, w_dim, conv_clamp=256)
    x, w = randn(20, 2, 6, 5, C), randn(21, 2, w_dim)
    params, _ = init_jax(jm, jnp.asarray(x), jnp.asarray(w))
    params["bias"] = randn(22, 3)
    ref = apply_jax(jm, {"params": params}, jnp.asarray(x), jnp.asarray(w))

    def to_sd(sd, p):
        sd["weight"], sd["bias"] = convert._conv(p["weight"]), convert._arr(p["bias"])
        convert._style_split(sd, p["affine"], "affine.")

    pm = load(tsyn.ToRGBLayer(C, 3, w_dim, conv_clamp=256), to_sd, params)
    close(pm(t(x), t(w)), ref)


@pytest.mark.parametrize("pre_normalize,blur,use_blur", [
    (True, "4x4", True), (False, "4x4", True), (True, "3x3", False), (False, "5x5", False)])
def test_separable_upsample_even_taps_and_no_blur_match_jax(pre_normalize, blur, use_blur):
    cin, cout = 32, 16
    jm = jcx.SeparableUpsampleWithFixedBlur(cin, cout, pre_normalize=pre_normalize,
                                            blur_kernel=blur, use_gaussian_blur=use_blur)
    x = randn(23, 2, 5, 6, cin)
    params, _ = init_jax(jm, jnp.asarray(x))
    ref = apply_jax(jm, {"params": params}, jnp.asarray(x))
    pm = load(tcx.SeparableUpsampleWithFixedBlur(cin, cout, blur, pre_normalize=pre_normalize,
                                                 use_gaussian_blur=use_blur),
              lambda sd, p: convert._separable_upsample(sd, p, ""), params)
    assert not pm.fused  # K2's gate refuses both, as the JAX gate does
    close(pm(t(x)), ref)


# ------------------------------------------------------------------ Generators

# Widths that are multiples of 32: the legacy residual layer's GroupNorm32
# takes 32 groups (ROADMAP "Faults of the JAX package's facade").
WIDE = dict(channel_base=1 << 20, channel_max=64, num_res_blocks=1)
VARIANTS = {
    "legacy-skip": dict(use_convnext=False, synthesis_kwargs=dict(WIDE, architecture="skip")),
    "legacy-orig": dict(use_convnext=False, synthesis_kwargs=dict(WIDE, architecture="orig")),
    "fourier-convnext": dict(concat_z_block_indices=[1], concat_z_mapped_dims=[32, 16]),
    "fourier-legacy": dict(use_convnext=False, concat_z_block_indices=[1],
                           concat_z_mapped_dims=[32, 16],
                           synthesis_kwargs=dict(WIDE, architecture="skip")),
    "blur-off": dict(use_gaussian_blur=False),
    "multiscale-off": dict(use_multiscale_output=False),
    "multiscale-off-orig": dict(use_convnext=False, use_multiscale_output=False,
                                synthesis_kwargs=dict(WIDE, architecture="orig")),
    "concat-dims-empty": dict(concat_z_mapped_dims=[]),
}


def jax_legacy_layers(pg, sd, params, buffers):
    """The legacy SynthesisLayers of port Generator `pg` (state_dict `sd`)
    into the JAX trees, under the names the JAX SynthesisBlock gives them
    (b{idx}/conv0, b{idx}/convs1_{i}); the reference's key layout, as
    tests/test_legacy_synthesis.py reads it."""
    for name, m in pg.named_modules():
        if not isinstance(m, tsyn.SynthesisLayer):
            continue
        _, _, idx, layer, *i = name.split(".")
        key = layer if not i else f"convs1_{i[0]}"
        pre = name + "."
        p = {"affine": jconvert.convert_style_split(sd, pre + "affine."),
             "weight": jconvert._conv(sd[pre + "weight"]), "bias": sd[pre + "bias"],
             "noise_strength": sd[pre + "noise_strength"]}
        if m.residual:
            p["norm"] = jconvert.convert_groupnorm(sd, pre + "norm.")
            p["gamma"] = sd[pre + "gamma"]
        params["synthesis"][f"b{idx}"][key] = p
        buffers.setdefault("synthesis", {}).setdefault(f"b{idx}", {})[key] = {
            "noise_const": sd[pre + "noise_const"]}


def jax_variables(kw, seed=0):
    pg = Generator(**kw, generator=torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in pg.state_dict().items()}
    geo = convert.geometry_from_kwargs(kw)
    params, buffers = jconvert.convert_generator(
        sd, how_to_compress="attnproj", how_to_decompress="attnproj",
        compression_mode="continuous", use_vf_loss=kw.get("use_vf_loss", False),
        legacy=geo["legacy"], z_resolution=geo["z_resolution"],
        concat_z_block_indices=geo["concat_z_block_indices"],
        block_resolutions=geo["block_resolutions"])
    jax_legacy_layers(pg, sd, params, buffers)
    params = randomize_zero_init(params)
    flat = tu.flatten_dict(params, sep="/")
    r = np.random.default_rng(seed + 1)
    for k in flat:  # the Fourier input's affine starts at zero
        if k.endswith("input/affine/weight"):
            flat[k] = (r.standard_normal(flat[k].shape) * 0.3).astype(np.float32)
    return tu.unflatten_dict(flat, sep="/"), buffers


def _decode(m, z):
    img, ms, _ = m._map_and_synthesize(m.ldm_adapter.decode(z), None, 1.0, False)
    return img, ms


@pytest.fixture(scope="module")
def vfm_dir(tmp_path_factory):
    return write_tiny_siglip(tmp_path_factory.mktemp("vfm") / "siglip2-tiny-patch8-32")


Z = randn(24, 2, 4, 4, 8)
IMG = np.random.default_rng(25).random((2, 32, 32, 3)).astype(np.float32)


def jax_reference(kw, variant):
    """(params, buffers, (decode, multiscale images), encode moments for
    legacy-skip) of one variant, from the JAX Generator."""
    params, buffers = jax_variables(kw)
    jg = JaxGenerator(**kw)
    jv = {"params": params, "buffers": buffers}
    out = apply_jax(jg, jv, jnp.asarray(Z), method=_decode)
    moments = (apply_jax(jg, jv, jnp.asarray(IMG), method=jg.encode,
                         return_z_before_quantize=True) if variant == "legacy-skip" else None)
    return params, buffers, out, moments


@pytest.fixture(scope="module")
def jax_references(vfm_dir):
    """Every variant's JAX programs, compiled in threads at once (XLA
    compiles outside the GIL): those compiles are most of this file's time."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:
        yield {v: pool.submit(jax_reference, dict(_tiny_g_kwargs(vfm_dir), **kw), v)
               for v, kw in VARIANTS.items()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generator_variant_matches_jax(variant, vfm_dir, jax_references):
    kw = dict(_tiny_g_kwargs(vfm_dir), **VARIANTS[variant])
    params, buffers, (img_ref, ms_ref), moments = jax_references[variant].result()
    pg = Generator(**kw)
    convert.load_jax_variables(pg, params, buffers, geometry=convert.geometry_from_kwargs(kw))
    z = Z
    with torch.no_grad():
        zd = pg.ldm_adapter.decode(t(z))
        ws = pg.mapping(tsyn.pooled_z(zd, pg.z_pooled_resolution))
        img, ms = pg.synthesis(zd, ws, return_multiscale=True)
    assert img.shape == (2, 32, 32, 3) and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), img_ref, rtol=2e-3, atol=2e-3)
    assert len(ms) == len(ms_ref) == 3
    for got, ref in zip(ms, ms_ref):
        assert (got is None) == (ref is None)  # orig with multiscale off: no skip images
        if got is not None:
            np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(pg.decode(t(z)).numpy(), img_ref, rtol=2e-3, atol=2e-3)
    # The legacy layers, the first block's upsample and the upsamples with the
    # blur off run no kernel.
    n_mlp = sum(isinstance(m, tcx.ConvNeXtSynthesisLayer) for m in pg.modules())
    n_up = sum(isinstance(m, tcx.SeparableUpsampleWithFixedBlur) and m.fused
               for m in pg.modules())
    counts = {k: sum(s["count"] for s in v) for k, v in kernel_sites(pg, 32).items()}
    assert counts["fused_convnext_mlp"] == n_mlp and counts["fused_upsample_blur"] == n_up
    if moments is not None:  # legacy-skip: one whole round trip, the encode as well
        got = pg.encode(t(IMG), return_z_before_quantize=True)
        np.testing.assert_allclose(got.numpy(), moments, rtol=5e-4, atol=5e-4)


def test_generator_refusals_and_jax_faults(vfm_dir):
    kw = _tiny_g_kwargs(vfm_dir)
    for bad in (dict(conditional=True), dict(label_type="text"), dict(use_cross_attn=True)):
        with pytest.raises(NotImplementedError, match=next(iter(bad))):
            Generator(**dict(kw, **bad))
    # The legacy residual layer's GroupNorm32 needs widths that are multiples
    # of 32: the tiny widths (64, 64, 32, 16) fail in both packages.
    with pytest.raises(ValueError, match="GroupNorm"):
        Generator(**dict(kw, use_convnext=False))
    with pytest.raises(AssertionError):
        jax.eval_shape(lambda: JaxGenerator(**dict(kw, use_convnext=False)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 8)), method=_decode))
    # concat_z_mapped_dims is indexed by block index: [16] for block 1 is out of range.
    with pytest.raises(IndexError):
        Generator(**dict(kw, concat_z_block_indices=[1], concat_z_mapped_dims=[16]))
    with pytest.raises(IndexError):
        jax.eval_shape(lambda: JaxGenerator(**dict(
            kw, concat_z_block_indices=[1], concat_z_mapped_dims=[16])).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 8)), method=_decode))
    with pytest.raises(ValueError, match="architecture"):
        Generator(**dict(kw, synthesis_kwargs=dict(WIDE, architecture="resnet")))


# ------------------------------------------------------------------ training


def test_legacy_stage0_step_trains_every_tensor(tmp_path):
    """Port only: a stage-0 D and G step on the legacy tiny Generator gives
    finite losses and a nonzero gradient on every trainable tensor."""
    from tests.test_torch_train import BUCKETS, RES, port_modules, tiny_kwargs, write_siglip

    kw = dict(tiny_kwargs(write_siglip(tmp_path / "siglip2-tiny-patch8-64", RES)),
              **VARIANTS["legacy-skip"])
    G, D, L, tr = port_modules(kw)
    with torch.no_grad():  # zero-initialised branches would leave their inputs without gradient
        for n, p in G.named_parameters():
            if n.endswith((".to_out.weight", ".ff.3.weight", ".null_kv", ".noise_strength")):
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) * 0.1)
    state = tr.init_state()
    real = torch.from_numpy(np.random.default_rng(3).random((2, RES, RES, 3)).astype(np.float32))
    d_grads, d_total, _ = tr.d_gradients(state, real, BUCKETS[0])
    g_grads, _, _, _, g_total = tr.g_gradients(state, real, BUCKETS[0])
    assert np.isfinite(float(d_total)) and np.isfinite(float(g_total))
    for names, grads in ((tr.d_params, d_grads), (tr.g_params, g_grads)):
        assert len(grads) == len(names)
        for n, g in zip(names, grads):
            assert torch.isfinite(g).all(), n
            # A D head's cls bias takes exactly 0 when its hinge counts tie
            # (ROADMAP Hazards, "The training gates read every step").
            if not (names is tr.d_params and n.endswith(".cls.bias")):
                assert float(g.abs().max()) > 0, n
    assert any(".convs1.1.gamma" in n for n in tr.g_params)  # a residual legacy layer trains

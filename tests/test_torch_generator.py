"""The port's tokenizer slice (vfm_vae_tpu_torch Generator.encode/decode)
against the JAX Generator on the CPU, at the tiny geometry of
__graft_entry__._tiny_g_kwargs (a local SigLIP config.json, no download, no
transformers). JAX parameters come from a seeded init, the zero- and
tiny-initialised branches are randomised so every kernel twin counts, and
the variables cross into the port through state_dict_from_jax."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import torch

from __graft_entry__ import _tiny_g_kwargs
from vfm_vae_tpu.models.convert import convert_generator
from vfm_vae_tpu.models.generator import Generator as JaxGenerator
from vfm_vae_tpu_torch.entry import FLAGSHIP_KWARGS, kernel_sites
from vfm_vae_tpu_torch.models import convert
from vfm_vae_tpu_torch.models.convnext import ConvNeXtSynthesisLayer, SeparableUpsampleWithFixedBlur
from vfm_vae_tpu_torch.models.generator import Generator
from vfm_vae_tpu_torch.models.gigagan import SelfAttention
from vfm_vae_tpu_torch.ops import kernels
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_tiny_siglip(d) -> str:
    """The config.json that __graft_entry__._write_tiny_vfm writes."""
    os.makedirs(d, exist_ok=True)
    cfg = dict(model_type="siglip_vision_model", hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128, image_size=32, patch_size=8,
               num_channels=3, layer_norm_eps=1e-6)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    return str(d)


def randomize_zero_init(params, seed=0):
    r = np.random.default_rng(seed)
    flat = tu.flatten_dict(params, sep="/")
    for k, v in flat.items():
        last = k.split("/")[-1]
        zero_init = (last in ("gamma", "noise_strength", "null_kv") and not k.endswith("norm/gamma")
                     or "/to_out/" in k or "/proj2/" in k)
        if zero_init:
            flat[k] = (r.uniform(0.1, 1.0, v.shape) * r.choice([-1.0, 1.0], v.shape)
                       ).astype(np.float32)
    return tu.unflatten_dict(flat, sep="/")


def jax_variables_from_port(kw, seed=0):
    """JAX (params, buffers) for Generator keyword arguments `kw`, from a
    port Generator drawn from a seeded torch.Generator through the JAX
    package's importer (convert_generator, the bit-exact inverse of
    state_dict_from_jax): JAX's own init costs an XLA compile of the model."""
    pg = Generator(**kw, generator=torch.Generator().manual_seed(seed))
    geo = convert.geometry_from_kwargs(kw)
    return convert_generator(
        {k: v.numpy() for k, v in pg.state_dict().items()}, how_to_compress="attnproj",
        how_to_decompress="attnproj", compression_mode="continuous",
        use_vf_loss=kw.get("use_vf_loss", False), legacy=geo["legacy"],
        z_resolution=geo["z_resolution"], concat_z_block_indices=geo["concat_z_block_indices"],
        block_resolutions=geo["block_resolutions"])


@pytest.fixture(scope="module")
def slice_pair(tmp_path_factory):
    kw = _tiny_g_kwargs(write_tiny_siglip(tmp_path_factory.mktemp("vfm") / "siglip2-tiny-patch8-32"))
    jg = JaxGenerator(**kw)
    img0, z0 = jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 4, 4, 8))

    def both(m, img, z):
        return m.encode(img), m.decode(z)

    # A seeded init through the RngBitGenerator-based key: XLA compiles this
    # ~400-parameter init in about half the time it takes with threefry.
    key = jax.random.key(0, impl="unsafe_rbg")
    v = jax.jit(lambda r: jg.init({"params": r}, img0, z0, method=both))(key)
    params = randomize_zero_init(jax.tree_util.tree_map(np.asarray, v["params"]))
    buffers = jax.tree_util.tree_map(np.asarray, v["buffers"])
    geometry = convert.geometry_from_kwargs(kw)
    pg = Generator(**kw)
    convert.load_jax_variables(pg, params, buffers, geometry=geometry)
    return dict(kw=kw, jg=jg, params=params, buffers=buffers, geometry=geometry, pg=pg)


def test_bridge_round_trip_is_bit_exact(slice_pair):
    s = slice_pair
    sd = convert.state_dict_from_jax(s["params"], s["buffers"], geometry=s["geometry"])
    geo = s["geometry"]
    p2, b2 = convert_generator(
        sd, how_to_compress="attnproj", how_to_decompress="attnproj",
        compression_mode="continuous", use_vf_loss=True, legacy=geo["legacy"],
        z_resolution=geo["z_resolution"], concat_z_block_indices=geo["concat_z_block_indices"],
        block_resolutions=geo["block_resolutions"],
    )
    for want, got in ((s["params"], p2), (s["buffers"], b2)):
        fw, fg = tu.flatten_dict(want, sep="/"), tu.flatten_dict(got, sep="/")
        assert sorted(fw) == sorted(fg)
        for k in fw:
            assert fg[k].shape == fw[k].shape and np.array_equal(fg[k], fw[k]), k
    assert sorted(sd) == sorted(s["pg"].state_dict())


def test_encode_matches_jax(slice_pair):
    s = slice_pair
    img = np.random.default_rng(1).random((2, 32, 32, 3)).astype(np.float32)
    jv = {"params": s["params"], "buffers": s["buffers"]}
    jg = s["jg"]
    moments = np.asarray(jax.jit(lambda v, x: jg.apply(
        v, x, return_z_before_quantize=True, method=jg.encode))(jv, jnp.asarray(img)))
    z_ref = moments[..., :8]  # the posterior mode is the moments' mean half
    pg = s["pg"]
    # Tolerance of tests/test_generator_parity.py (encode moments, fp32).
    np.testing.assert_allclose(pg.encode(torch.from_numpy(img), return_z_before_quantize=True)
                               .numpy(), moments, rtol=5e-4, atol=5e-4)
    z = pg.encode(torch.from_numpy(img))
    assert z.shape == (2, 4, 4, 8)
    np.testing.assert_allclose(z.numpy(), z_ref, rtol=5e-4, atol=5e-4)


def test_decode_matches_jax(slice_pair):
    s = slice_pair
    z = np.random.default_rng(2).standard_normal((2, 4, 4, 8)).astype(np.float32)
    jg = s["jg"]
    ref = np.asarray(jax.jit(lambda v, x: jg.apply(v, x, method=jg.decode))(
        {"params": s["params"], "buffers": s["buffers"]}, jnp.asarray(z)))
    kernels.reset_launch_counts()
    img = s["pg"].decode(torch.from_numpy(z))
    assert img.shape == (2, 32, 32, 3) and img.dtype == torch.float32
    # Tolerance of tests/test_generator_parity.py (decoded pixels, fp32).
    np.testing.assert_allclose(img.numpy(), ref, rtol=2e-3, atol=2e-3)
    # CPU tensors take the plain twins: no kernel launch is counted.
    assert kernels.launch_counts() == {fn.__name__: 0 for fn in kernels.ALL_WRAPPERS}


def test_encode_sample_draws_from_the_generator(slice_pair):
    pg = slice_pair["pg"]
    img = torch.from_numpy(np.random.default_rng(3).random((2, 32, 32, 3)).astype(np.float32))
    moments = pg.encode(img, return_z_before_quantize=True)
    mean, logvar = moments.chunk(2, dim=-1)
    a = pg.encode(img, generator=torch.Generator().manual_seed(5))
    b = pg.encode(img, generator=torch.Generator().manual_seed(5))
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * noise)


def test_kernel_sites_cover_every_kernel_call(slice_pair):
    pg = slice_pair["pg"]
    sites = kernel_sites(pg, 32)
    n_k1 = sum(isinstance(m, ConvNeXtSynthesisLayer) for m in pg.modules())
    n_k2 = sum(isinstance(m, SeparableUpsampleWithFixedBlur) and m.pre_normalize
               for m in pg.modules())
    n_k3 = sum(isinstance(m, SelfAttention) for m in pg.modules())
    counts = {name: sum(s["count"] for s in v) for name, v in sites.items()}
    # The encode's K4 and K6 sites are empty unless the flash switches or the
    # int8 tower are on (tests/test_torch_int8.py), K5's and K9's unless their
    # switches are (tests/test_torch_stats.py), K6's decoder modes unless the
    # int8 decoder is (tests/test_torch_int8_decoder.py); the tiny decoder's 16- to
    # 64-channel dwconvs fail K7's and K8's rules (C % 128 == 0).
    assert counts == {"fused_convnext_mlp": n_k1, "fused_upsample_blur": n_k2,
                      "flash_attention_nullkv": n_k3, "flash_attention_nonull": 0, "int8_matmul": 0,
                      "fused_convnext_mlp_pipelined": 0, "channel_moments": 0,
                      "flash_attention_nonull_bwd_dkv": 0, "flash_attention_nonull_bwd_dq": 0,
                      "dwconv_noise_stats": 0, "depthwise_conv2d_same": 0,
                      "int8_matmul_gelu": 0, "int8_matmul_residual": 0}
    assert (n_k1, n_k2, n_k3) == (16, 6, 1)


def test_flagship_kwargs_match_the_jax_entry(monkeypatch):
    """FLAGSHIP_KWARGS is a copy of __graft_entry__.flagship_generator's kwargs."""
    import __graft_entry__
    import vfm_vae_tpu.models.generator as jgen

    seen = {}
    monkeypatch.setattr(jgen, "Generator", lambda **kw: seen.update(kw))
    __graft_entry__.flagship_generator()
    seen.pop("compute_dtype")
    assert seen == FLAGSHIP_KWARGS


def test_unported_configurations_raise(slice_pair):
    kw = dict(slice_pair["kw"])
    with pytest.raises(NotImplementedError):
        Generator(**dict(kw, use_cross_attn=True))
    with pytest.raises(ValueError):  # discrete and conv are ported; these values are not modes
        Generator(**dict(kw, compression_mode="binary"))
    with pytest.raises(ValueError):
        Generator(**dict(kw, how_to_process_concat_z="nearest"))
    with pytest.raises(TypeError):
        Generator(**dict(kw, no_such_option=1))


def test_port_imports_neither_jax_nor_transformers():
    """Every module of the port, and chip_smoke.py, import with jax, flax,
    transformers and the JAX package blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'flax', 'transformers', 'vfm_vae_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import vfm_vae_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(vfm_vae_tpu_torch.__path__, 'vfm_vae_tpu_torch.')]\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 36

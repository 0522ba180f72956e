"""The port's other frozen towers (DINOv2, MAE, EVA-02, the Qwen2.5-VL
vision tower), the VFMEncoder facade over them, their int8 scope and a tiny
DINOv2 tokenizer, against the JAX package on the CPU in fp32.

JAX parameters are drawn with numpy on jax.eval_shape's tree (norm weights
near one, biases, LayerScale and CLS tokens random: no branch starts at a
value that would hide it; MAE's sin-cos buffer is JAX's own) and cross into
the port through convert.tower_state_dict_from_jax; the port's state_dict
goes back through the JAX package's importers bit for bit, and its keys are
those of the HF models the importers read. The MLP widths (44, 45) are off
K6's multiples of 8 and 32, as EVA-02-L's 2730 and Qwen2.5-VL-7B's 3420 are.
Tolerances: 1e-4 on the towers' fp32 features (two to three blocks, another
summation order), 5e-4 on encode moments and 2e-3 on decoded pixels (those
of tests/test_generator_parity.py).
"""

import importlib
import json
import os

import numpy as np
import pytest

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import torch

from __graft_entry__ import _tiny_g_kwargs
from vfm_vae_tpu.models import convert as jconvert
from vfm_vae_tpu.models import eva as jeva
from vfm_vae_tpu.models import qwen as jqwen
from vfm_vae_tpu.models import vfm as jvfm
from vfm_vae_tpu.models import vit as jvit
from vfm_vae_tpu.models.generator import Generator as JaxGenerator
from vfm_vae_tpu.models.layers import int8_linear_scope as j_int8_scope
from vfm_vae_tpu.ops import quantized as jq
from vfm_vae_tpu_torch.models import convert, layers
from vfm_vae_tpu_torch.models import eva as teva
from vfm_vae_tpu_torch.models import qwen as tqwen
from vfm_vae_tpu_torch.models import vfm as tvfm
from vfm_vae_tpu_torch.models import vit as tvit
from vfm_vae_tpu_torch.models.generator import Generator
from vfm_vae_tpu_torch.ops import quantized
from vfm_vae_tpu_torch.tools import alignment_extract
from tests.torch_threads import one_torch_thread  # noqa: F401

# The K6 module (the package exports its wrapper under the same name).
k6 = importlib.import_module("vfm_vae_tpu_torch.ops.kernels.int8_matmul")
TOL = 1e-4
VIT = dict(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=44, patch_size=4, image_size=16)
EVA = dict(VIT, mlp_dim=45)
QWEN = dict(hidden_size=32, depth=3, num_heads=4, mlp_dim=45, out_hidden_size=24, patch_size=4,
            temporal_patch_size=2, spatial_merge_size=2, window_size=16,
            fullatt_block_indexes=(1,))
# The facade's tiny presets (VFM_PRESETS rows of both packages, for the test).
QWEN_PRESET = dict(hidden_size=32, num_layers=3, num_heads=4, mlp_dim=45, patch_size=4,
                   image_size=0, text_hidden_size=24, out_hidden_size=24, temporal_patch_size=2,
                   spatial_merge_size=2, window_size=16, fullatt_block_indexes=(1,))


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def draw_params(shapes, seed):
    """Numpy values on a JAX parameter tree: 1-D weights 1 + 0.2 N, biases
    and other vectors 0.2 N, LayerScale U(0.1, 1) with a random sign,
    matrices and convolutions N / sqrt(fan in), tables 0.5 N."""
    r = np.random.default_rng(seed)
    out = {}
    for path, s in tu.flatten_dict(shapes).items():
        name, shape = path[-1], s.shape
        if name in ("ls1", "ls2"):
            v = r.uniform(0.1, 1.0, shape) * r.choice([-1.0, 1.0], shape)
        elif name == "weight" and len(shape) == 1:
            v = 1.0 + 0.2 * r.standard_normal(shape)
        elif len(shape) == 1 or name in ("cls_token", "pos_embed", "position_embeddings"):
            v = (0.2 if len(shape) == 1 else 0.5) * r.standard_normal(shape)
        else:
            v = r.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        out[path] = v.astype(np.float32)
    return tu.unflatten_dict(out)


def jax_tower(module, args, seed, **kw):
    """(params, buffers) for `module` called on `args`."""
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)}, *args, **kw))
    params = draw_params(shapes["params"], seed)
    buffers = {}
    if "buffers" in shapes:  # MAE's sin-cos table
        D, grid = module.hidden_size, module.image_size // module.patch_size
        buffers = {"position_embeddings": jvit._sincos_pos_embed_2d(D, grid)}
    return params, buffers


def jax_apply(module, variables, *args, **kw):
    fn = jax.jit(lambda v, *a: module.apply(v, *a, **kw))
    return jax.tree_util.tree_map(np.asarray, fn(variables, *args))


def port_tower(cls, params, buffers=None, int8=None, **geo):
    m = cls(**geo)
    convert.load_state_dict_numpy(m, convert.tower_state_dict_from_jax(params, buffers,
                                                                       int8=int8))
    return m.requires_grad_(False)


def assert_outputs(got, want, tol=TOL):
    """(hidden dict, last, pooled) against JAX's, every collected state."""
    (gh, gl, gp), (wh, wl, wp) = got, want
    assert sorted(gh) == sorted(wh)
    for i in wh:
        np.testing.assert_allclose(gh[i].numpy(), wh[i], rtol=tol, atol=tol, err_msg=f"hidden {i}")
    np.testing.assert_allclose(gl.numpy(), wl, rtol=tol, atol=tol, err_msg="last")
    np.testing.assert_allclose(gp.numpy(), wp, rtol=tol, atol=tol, err_msg="pooled")


# ---------------------------------------------------------------- the towers


@pytest.fixture(scope="module")
def dinov2():
    jm = jvit.Dinov2Tower(**VIT)
    return jm, *jax_tower(jm, (jnp.zeros((1, 16, 16, 3)),), seed=1)


@pytest.fixture(scope="module")
def eva():
    jm = jeva.EVATower(**EVA)
    return jm, *jax_tower(jm, (jnp.zeros((1, 16, 16, 3)),), seed=2)


@pytest.fixture(scope="module")
def mae():
    jm = jvit.MAETower(**VIT)
    return jm, *jax_tower(jm, (jnp.zeros((1, 16, 16, 3)),), seed=3)


@pytest.fixture(scope="module")
def qwen():
    jm = jqwen.QwenVisionTower(**QWEN)
    patches, grid = jqwen.qwen_patchify(jnp.zeros((1, 16, 16, 3)), 4, 2, 2)
    return jm, *jax_tower(jm, (patches, grid), seed=4)


@pytest.mark.parametrize("size", [16, 12, 24])
def test_dinov2_tower_matches_jax(dinov2, size):
    """16 px is the tower's grid; 12 and 24 interpolate the position table
    (bicubic, fp32)."""
    jm, params, _ = dinov2
    x = randn(size, 2, size, size, 3)
    want = jax_apply(jm, {"params": params}, jnp.asarray(x), collect=[0, 1, 2])
    pm = port_tower(tvit.Dinov2Tower, params, **VIT)
    assert_outputs(pm(torch.from_numpy(x), collect=[0, 1, 2]), want)


@pytest.mark.parametrize("size", [16, 12, 24])
def test_eva_tower_matches_jax(eva, size):
    """The axial rope at the native grid and scaled to it from 3x3 and 6x6."""
    jm, params, _ = eva
    x = randn(size + 1, 2, size, size, 3)
    want = jax_apply(jm, {"params": params}, jnp.asarray(x), collect=[0, 2])
    pm = port_tower(teva.EVATower, params, **EVA)
    assert_outputs(pm(torch.from_numpy(x), collect=[0, 2]), want)


def test_mae_tower_matches_jax(mae):
    jm, params, buffers = mae
    x = randn(7, 2, 16, 16, 3)
    want = jax_apply(jm, {"params": params, "buffers": buffers}, jnp.asarray(x),
                     collect=[0, 1, 2])
    pm = port_tower(tvit.MAETower, params, buffers, **VIT)
    np.testing.assert_array_equal(pm.embeddings.position_embeddings[0].numpy(),
                                  buffers["position_embeddings"])
    assert_outputs(pm(torch.from_numpy(x), collect=[0, 1, 2]), want)


def test_mae_refuses_other_sizes_as_jax_does(mae):
    """No dynamic resolution (the reference's README): JAX asserts, the port raises."""
    jm, params, buffers = mae
    x = randn(8, 1, 12, 12, 3)
    with pytest.raises(AssertionError, match="dynamic-resolution"):
        jm.apply({"params": params, "buffers": buffers}, jnp.asarray(x))
    pm = port_tower(tvit.MAETower, params, buffers, **VIT)
    with pytest.raises(ValueError, match="no dynamic resolution"):
        pm(torch.from_numpy(x))


def test_mae_random_masking_keeps_a_share_of_the_patches(mae):
    """mask_ratio > 0 with a torch.Generator: (1 - ratio) of the patch
    tokens plus the CLS, drawn again the same from the same seed."""
    _, params, buffers = mae
    pm = port_tower(tvit.MAETower, params, buffers, **dict(VIT, mask_ratio=0.75))
    x = torch.from_numpy(randn(9, 2, 16, 16, 3))
    a = pm(x, mask_generator=torch.Generator().manual_seed(0))
    b = pm(x, mask_generator=torch.Generator().manual_seed(0))
    assert a[1].shape == (2, 1 + 4, 32) and torch.equal(a[1], b[1])
    assert pm(x)[1].shape == (2, 17, 32)  # no generator: no masking


@pytest.mark.parametrize("size", [16, 24])
def test_qwen_tower_matches_jax(qwen, size):
    """16 px: one window of 2x2 merge units; 24 px: 3x3 units in windows of
    2x2, so three of the four are partial. Block 1 attends globally."""
    jm, params, _ = qwen
    x = randn(size + 2, 2, size, size, 3)
    patches, grid = jqwen.qwen_patchify(jnp.asarray(x), 4, 2, 2)
    tp, tgrid = tqwen.qwen_patchify(torch.from_numpy(x), 4, 2, 2)
    assert tgrid == grid
    np.testing.assert_array_equal(tp.numpy(), np.asarray(patches))
    want = jax_apply(jm, {"params": params}, patches, grid_hw=grid, collect=[0, 1, 2, 3])
    pm = port_tower(tqwen.QwenVisionTower, params, **QWEN)
    assert_outputs(pm(tp, grid, collect=[0, 1, 2, 3]), want)


def test_siglip_pooled_output_matches_jax():
    """SigLIP's MAP head (the pooled output the facade returns on request),
    with the tower's tables: the same converter as the other families."""
    geo = dict(VIT, mlp_dim=64)
    jm = jvit.SigLIPVisionTower(**geo)
    params, _ = jax_tower(jm, (jnp.zeros((1, 16, 16, 3)),), seed=5)
    x = randn(6, 2, 16, 16, 3)
    want = jax_apply(jm, {"params": params}, jnp.asarray(x), collect=[0, 2])
    pm = port_tower(tvit.SigLIPVisionTower, params, **geo)
    assert_outputs(pm(torch.from_numpy(x), collect=[0, 2], need_pooled=True), want)


def test_tower_tables_match_jax():
    """The numpy constants: EVA's rope at three grids and a reference grid,
    Qwen's window layout and rope, MAE's sin-cos table."""
    for args in ((4, 4, 8), (3, 5, 8, 10000.0, 4), (6, 6, 16, 500.0)):
        for a, b in zip(teva.eva_rope_table(*args), jeva.eva_rope_table(*args)):
            np.testing.assert_array_equal(a, b)
    for g in ((4, 4), (6, 6), (6, 10)):
        for a, b in zip(tqwen.qwen_window_layout(*g, 4, 2, 16),
                        jqwen.qwen_window_layout(*g, 4, 2, 16)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tqwen.qwen_rope_table(*g, 2, 8),
                                      jqwen.qwen_rope_table(*g, 2, 8))
    np.testing.assert_array_equal(tvit._sincos_pos_embed_2d(32, 4),
                                  jvit._sincos_pos_embed_2d(32, 4))


# ------------------------------------------------- the checkpoint layouts


def convert_back(family, sd):
    """The port's tower state_dict through the JAX package's importer."""
    if family == "dinov2":
        return jconvert.convert_dinov2(sd), {}
    if family == "mae":
        return jconvert.convert_mae(sd)
    if family == "eva":
        return jeva.convert_eva_timm(sd), {}
    from tests.test_qwen import convert_qwen

    return convert_qwen(sd), {}


@pytest.mark.parametrize("family", ["dinov2", "mae", "eva", "qwen"])
def test_state_dict_round_trips_through_the_jax_importers(family, request):
    """state_dict_from_jax, then the importer of the checkpoint layout the
    port's names follow: the JAX tree again, bit for bit."""
    jm, params, buffers = request.getfixturevalue(family)
    cls = {"dinov2": tvit.Dinov2Tower, "mae": tvit.MAETower, "eva": teva.EVATower,
           "qwen": tqwen.QwenVisionTower}[family]
    geo = {"eva": EVA, "qwen": QWEN}.get(family, VIT)
    pm = port_tower(cls, params, buffers, **geo)
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    p2, b2 = convert_back(family, sd)
    for want, got in ((params, p2), (buffers, b2)):
        fw, fg = tu.flatten_dict(want, sep="/"), tu.flatten_dict(got, sep="/")
        assert sorted(fw) == sorted(fg)
        for k in fw:
            assert fg[k].shape == fw[k].shape and np.array_equal(fg[k], fw[k]), k


def hf_tower(family):
    """A tiny HF model of the family's checkpoint layout (eval mode)."""
    torch.manual_seed(0)
    if family == "dinov2":
        from transformers import Dinov2Config, Dinov2Model

        return Dinov2Model(Dinov2Config(hidden_size=32, num_hidden_layers=2,
                                        num_attention_heads=4, mlp_ratio=44 / 32, image_size=16,
                                        patch_size=4, attn_implementation="eager")).eval()
    if family == "mae":
        from transformers import ViTMAEConfig, ViTMAEModel

        return ViTMAEModel(ViTMAEConfig(hidden_size=32, num_hidden_layers=2,
                                        num_attention_heads=4, intermediate_size=44,
                                        image_size=16, patch_size=4, mask_ratio=0.0,
                                        attn_implementation="eager")).eval()
    from transformers.models.qwen2_5_vl import Qwen2_5_VLConfig
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import (
        Qwen2_5_VisionTransformerPretrainedModel)

    cfg = Qwen2_5_VLConfig(vision_config=dict(
        depth=3, hidden_size=32, num_heads=4, intermediate_size=45, out_hidden_size=24,
        patch_size=4, temporal_patch_size=2, spatial_merge_size=2, window_size=16,
        fullatt_block_indexes=[1], in_channels=3, hidden_act="silu")).vision_config
    cfg._attn_implementation = "eager"
    return Qwen2_5_VisionTransformerPretrainedModel(cfg).eval()


@pytest.mark.parametrize("family", ["dinov2", "mae", "qwen"])
def test_hf_checkpoints_load_directly(family):
    """An HF model's state_dict loads into the port's tower as it is (the
    same keys and shapes), and the port then gives the HF model's last
    sequence at the native grid."""
    hf = hf_tower(family)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    x = randn(11, 2, 16, 16, 3)
    if family == "qwen":
        pm = tqwen.QwenVisionTower(**QWEN)
        convert.load_state_dict_numpy(pm, sd)
        patches, grid = tqwen.qwen_patchify(torch.from_numpy(x), 4, 2, 2)
        with torch.no_grad():
            want = hf(patches.reshape(-1, patches.shape[-1]),
                      grid_thw=torch.tensor([[1, *grid]] * 2)).reshape(2, -1, 24)
        got = pm(patches, grid)[1]
    else:
        cls = tvit.Dinov2Tower if family == "dinov2" else tvit.MAETower
        pm = cls(**VIT, eps=hf.config.layer_norm_eps)
        convert.load_state_dict_numpy(pm, sd)
        kw = {} if family == "dinov2" else dict(noise=torch.arange(16.0).expand(2, 16))
        with torch.no_grad():  # MAE: noise in increasing order keeps the patches in place
            want = hf(torch.from_numpy(x.transpose(0, 3, 1, 2)), **kw).last_hidden_state
        got = pm(torch.from_numpy(x))[1]
    assert sorted(pm.state_dict()) == sorted(sd)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=TOL, atol=TOL)


# ------------------------------------------------------------- the facade


def write_config(d, **cfg) -> str:
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    return str(d)


@pytest.fixture(scope="module")
def vfm_dirs(tmp_path_factory):
    """Local config.json directories (DINOv2's with mlp_ratio, as its HF
    configs give it) for the families the name substring picks."""
    root = tmp_path_factory.mktemp("towers")
    common = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, patch_size=4,
                  image_size=16)
    return {"dinov2": write_config(root / "dinov2-tiny", mlp_ratio=44 / 32, **common),
            "dinov2_p7": write_config(root / "dinov2-tiny-p7", mlp_ratio=44 / 32,
                                      **dict(common, patch_size=7, image_size=28)),
            "mae": write_config(root / "vit-mae-tiny", intermediate_size=44, **common),
            "eva": write_config(root / "eva02-tiny", intermediate_size=45, **common),
            "qwen": "qwen-tiny"}


@pytest.fixture
def qwen_preset(monkeypatch):
    monkeypatch.setitem(jvfm.VFM_PRESETS, "qwen-tiny", QWEN_PRESET)
    monkeypatch.setitem(tvfm.VFM_PRESETS, "qwen-tiny", QWEN_PRESET)


FACADE = {  # layers, input px, eq (scale, prior)
    "dinov2": ([0, -2, -1], 16, (1.0, False)),
    "mae": ([0, 1, -1], 16, (1.0, False)),
    "eva": ([1, -1], 16, (0.75, True)),
    "qwen": ([0, -2, -1], 24, (1.0, False)),
}


@pytest.mark.parametrize("family", ["dinov2", "mae", "eva", "qwen"])
def test_facade_matches_jax(family, vfm_dirs, qwen_preset):
    """VFMEncoder.encode_image per family: preprocessing (mean, std, EVA's
    EQ-prior bicubic down-scale), negative layer indices, the CLS token
    stripped, Qwen's patchify and merger layer, and the pooled output."""
    name = vfm_dirs[family]
    layers_, px, (eq, prior) = FACADE[family]
    assert tvfm.vfm_preset(name)["mlp_dim"] == jvfm.vfm_preset(name)["mlp_dim"]
    img = np.random.default_rng(12).random((2, px, px, 3)).astype(np.float32)
    je = jvfm.VFMEncoder(model_name=name, scale_factor=1.0, patch_from_layers=layers_)
    shapes = jax.eval_shape(lambda: je.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(img),
                                            method=je.encode_image))
    params = draw_params(shapes["params"], 13)
    buffers = ({"tower": {"position_embeddings": jvit._sincos_pos_embed_2d(32, 4)}}
               if family == "mae" else {})
    feats, pooled = jax_apply(je, {"params": params, "buffers": buffers}, jnp.asarray(img),
                              eq_scale_factor=eq, is_eq_prior=prior, method=je.encode_image)
    pe = tvfm.VFMEncoder(name, 1.0, layers_)
    assert pe.family == family and pe.has_cls_prefix == (family != "qwen")
    convert.load_state_dict_numpy(pe.encoder, convert.tower_state_dict_from_jax(
        params["tower"], buffers.get("tower")))
    got, got_pooled = pe.encode_image(torch.from_numpy(img), eq, prior, return_pooled=True)
    assert len(got) == len(feats)
    for g, w in zip(got, feats):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_pooled.numpy(), pooled, rtol=TOL, atol=TOL)
    assert all(torch.equal(a, b) for a, b in zip(pe.encode_image(torch.from_numpy(img), eq,
                                                                 prior), got))


def test_facade_tables_match_jax():
    """The presets, normalizations, family and patch-size lookups of both packages."""
    assert tvfm.VFM_PRESETS == jvfm.VFM_PRESETS
    assert tvfm.VFM_NORMALIZATION == jvfm.VFM_NORMALIZATION
    for name in list(jvfm.VFM_PRESETS) + ["/ckpt/dinov2-tiny", "facebook/vit-mae-base"]:
        assert tvfm.vfm_family(name) == jvfm.vfm_family(name)
        assert tvfm.infer_patch_size(name) == jvfm.infer_patch_size(name)
        assert tvfm.interpolation(name) == ("bicubic" if tvfm.vfm_family(name) in
                                            ("dinov2", "eva", "qwen") else "bilinear")
    with pytest.raises(ValueError):
        tvfm.vfm_family("clip-vit-large")


def test_dinov2_resizes_bicubic_as_the_reference(vfm_dirs):
    """The reference resizes DINOv2's input bicubically (VFM2INTERPOLATION's
    "dino"); the JAX facade looks the table up by family name and resizes it
    bilinearly. The port follows the reference; EVA, both bicubic, agree."""
    from vfm_vae_tpu.ops.resize import resize_bicubic, resize_bilinear

    img = np.random.default_rng(14).random((1, 16, 16, 3)).astype(np.float32)
    mean, std = (np.asarray(v, np.float32) for v in jvfm.VFM_NORMALIZATION["dinov2"])
    port = tvfm.VFMEncoder(vfm_dirs["dinov2"], 1.75, [-1]).preprocess(torch.from_numpy(img))
    bicubic = (np.asarray(resize_bicubic(jnp.asarray(img), scale_factor=1.75)) - mean) / std
    np.testing.assert_allclose(port.numpy(), bicubic, rtol=1e-5, atol=1e-5)
    je = jvfm.VFMEncoder(model_name=vfm_dirs["dinov2"], scale_factor=1.75, patch_from_layers=[-1])
    jax_pre = np.asarray(je.apply({}, jnp.asarray(img), method=je.preprocess))
    bilinear = (np.asarray(resize_bilinear(jnp.asarray(img), scale_factor=1.75)) - mean) / std
    np.testing.assert_allclose(jax_pre, bilinear, rtol=1e-6, atol=1e-6)
    assert np.abs(jax_pre - bicubic).max() > 1e-2
    pe = tvfm.VFMEncoder(vfm_dirs["eva"], 1.75, [-1]).preprocess(torch.from_numpy(img))
    je = jvfm.VFMEncoder(model_name=vfm_dirs["eva"], scale_factor=1.75, patch_from_layers=[-1])
    np.testing.assert_allclose(pe.numpy(), np.asarray(je.apply({}, jnp.asarray(img),
                                                               method=je.preprocess)),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- the int8 scope


INT8 = {  # port class, geometry
    "dinov2": (tvit.Dinov2Tower, VIT), "mae": (tvit.MAETower, VIT),
    "eva": (teva.EVATower, EVA), "qwen": (tqwen.QwenVisionTower, QWEN),
}


@pytest.mark.parametrize("family", ["dinov2", "mae", "eva", "qwen"])
def test_int8_tower_matches_jax(family, request):
    """Each tower under the int8 scope, dynamic (JAX's mirror carried across
    and the port's own mirror bit for bit the same) and static (JAX's
    calibrated scales, and the port's own calibration within 1e-5): the last
    sequence and pooled output within TOL of JAX's int8 tower and at least
    10x closer to it than to the float tower. The MLP widths 44 and 45 are
    off K6's multiples of 8 and 32."""
    jm, params, buffers = request.getfixturevalue(family)
    cls, geo = INT8[family]
    x = randn(15, 2, 16, 16, 3)
    if family == "qwen":
        patches, grid = jqwen.qwen_patchify(jnp.asarray(x), 4, 2, 2)
        jx, jkw, targs = patches, dict(grid_hw=grid), (torch.from_numpy(np.array(patches)), grid)
    else:
        jx, jkw, targs = jnp.asarray(x), {}, (torch.from_numpy(x),)
    v = {"params": params, "buffers": buffers}
    v8 = dict(v, int8=jq.prequantize_linears(params))
    v8 = jq.calibrate_int8_act_scales(
        jax.jit(lambda vv, a: jm.apply(vv, a, mutable=["act_stats"], **jkw)), v8, jx)
    dyn = tu.unflatten_dict({k: a for k, a in tu.flatten_dict(v8["int8"]).items()
                             if k[-1] != "as"})
    float_out = jax_apply(jm, v, jx, **jkw)
    for int8, label in ((dyn, "dynamic"), (v8["int8"], "static")):
        with j_int8_scope(True):
            want = jax_apply(jm, dict(v, int8=int8), jx, **jkw)
        int8 = jax.tree_util.tree_map(np.asarray, int8)
        pm = port_tower(cls, params, buffers, int8=int8, **geo)
        with layers.int8_linear_scope(True):
            got = pm(*targs)
        for g, w, f in zip(got[1:], want[1:], float_out[1:]):
            np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL, err_msg=label)
            assert np.abs(g.numpy() - f).mean() > 10 * np.abs(g.numpy() - w).mean(), label
    # The port's own mirror and calibration against JAX's.
    pm = port_tower(cls, params, buffers, **geo)
    n = quantized.prequantize_linears(pm)
    n_cal = quantized.calibrate_int8_act_scales(pm, *targs)
    want = convert.tower_state_dict_from_jax(params, buffers, int8=jax.tree_util.tree_map(
        np.asarray, v8["int8"]))
    got = pm.state_dict()
    keys = [k for k in want if k.endswith((".wq", ".ws", ".as"))]
    assert len(keys) == 3 * n == 3 * n_cal
    for k in keys:
        if k.endswith(".as"):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("M,K,N", [(33, 45, 17), (7, 2730, 24), (5, 100, 3420), (3, 31, 1)])
def test_k6_tails_give_the_twin_at_the_unpadded_shape(M, K, N, mode):
    """K6's route for a K off 32, emulated: the pre-pass quantizes x as the
    twin does and writes it with zeros out to padded_k(K) columns, the GEMM
    sums it against pad_weight's weight (zeros past K), the epilogue rescales
    by the pre-pass's scale: the twin's result at (K, N), bit for bit. So is
    the twin on x and the weight padded with zeros (the absmax is unmoved).
    The padded weight is made once per weight, and again after the weight
    changes in place. (An N off 8 changes only where the rows are stored.)"""
    r = np.random.default_rng(K + N)
    x = torch.from_numpy(r.standard_normal((M, K)).astype(np.float32) * 3)
    wq = torch.from_numpy(r.integers(-127, 128, (N, K)).astype(np.int8))
    ws = torch.from_numpy((np.abs(r.standard_normal(N)) * 0.01 + 1e-4).astype(np.float32))
    b = torch.from_numpy(r.standard_normal(N).astype(np.float32))
    a_s = None if mode == "dynamic" else x.abs().amax() / 127 * 0.5
    wp = k6.pad_weight(wq)
    Kp = k6.padded_k(K)
    assert wp.shape == (N, Kp) and Kp % 32 == 0 and Kp - K < 32
    assert torch.equal(wp[:, :K], wq) and not wp[:, K:].any()
    want = k6.int8_matmul_reference(x, wq, ws, b, mode, a_s)
    xq, s = k6.quantize_activations(x, mode, a_s)  # the pre-pass
    xq = torch.nn.functional.pad(xq, (0, Kp - K)).to(torch.int8)
    acc = (xq.double() @ wp.double().t()).float()
    y = acc * s * ws if mode == "dynamic" else acc * (s * ws)
    assert torch.equal((y + b).to(x.dtype), want)
    xp = torch.nn.functional.pad(x, (0, Kp - K))
    assert torch.equal(k6.int8_matmul_reference(xp, wp, ws, b, mode, a_s), want)
    assert k6.pad_weight(wq) is wp
    wq[0, 0] = -wq[0, 0] if wq[0, 0] else 1
    assert k6.pad_weight(wq) is not wp and torch.equal(k6.pad_weight(wq)[:, :K], wq)


# ------------------------------------------------------ the tiny tokenizer


@pytest.fixture(scope="module")
def dinov2_pair(vfm_dirs):
    """JAX and port tiny Generators on a DINOv2/7 tower (32 px x 1.75 -> 56 px,
    an 8 x 8 grid: the position table interpolated from 4 x 4) on the same
    weights, JAX's table lookup aligned with the reference's (bicubic)."""
    kw = dict(_tiny_g_kwargs(vfm_dirs["dinov2_p7"]), scale_factor=1.75,
              patch_in_dimensions=[32, 32, 32])
    jg = JaxGenerator(**kw)
    img0, z0 = jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 4, 4, 8))

    def both(m, img, z):
        return m.encode(img), m.decode(z)

    shapes = jax.eval_shape(lambda: jg.init({"params": jax.random.PRNGKey(0)}, img0, z0,
                                            method=both))
    # Adapter, mapping and decoder from a seeded port Generator through the
    # JAX importer (as tests/test_torch_generator.py does); the tower drawn.
    pg0 = Generator(**kw, generator=torch.Generator().manual_seed(0))
    params, buffers = jconvert.convert_generator(
        {k: v.numpy() for k, v in pg0.state_dict().items()}, how_to_compress="attnproj",
        how_to_decompress="attnproj", compression_mode="continuous", use_vf_loss=True,
        **{k: v for k, v in convert.geometry_from_kwargs(kw).items()})
    params["vfm_encoder"] = {"tower": draw_params(shapes["params"]["vfm_encoder"]["tower"], 16)}
    pg = Generator(**kw)
    convert.load_jax_variables(pg, params, buffers, geometry=convert.geometry_from_kwargs(kw))
    return dict(kw=kw, jg=jg, params=params, buffers=buffers, pg=pg)


def test_tiny_dinov2_generator_matches_jax(dinov2_pair, monkeypatch):
    """Encode moments within 5e-4 and decoded pixels within 2e-3 of JAX's."""
    monkeypatch.setitem(jvfm.VFM2INTERPOLATION, "dinov2", "bicubic")
    s = dinov2_pair
    jg, v = s["jg"], {"params": s["params"], "buffers": s["buffers"]}
    img = np.random.default_rng(17).random((2, 32, 32, 3)).astype(np.float32)
    z = np.random.default_rng(18).standard_normal((2, 4, 4, 8)).astype(np.float32)
    moments, pixels = jax.jit(lambda vv, x, zz: (
        jg.apply(vv, x, return_z_before_quantize=True, method=jg.encode),
        jg.apply(vv, zz, method=jg.decode)))(v, jnp.asarray(img), jnp.asarray(z))
    pg = s["pg"]
    assert pg.vfm_encoder.family == "dinov2"
    np.testing.assert_allclose(pg.encode(torch.from_numpy(img), return_z_before_quantize=True)
                               .numpy(), np.asarray(moments), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(pg.decode(torch.from_numpy(z)).numpy(), np.asarray(pixels),
                               rtol=2e-3, atol=2e-3)
    # The training forward takes an EQ-prior bucket (the tower's grid shrinks).
    out = pg(torch.from_numpy(img), eq=(0.5, 0, True))
    assert out.gen_img.shape == (2, 16, 16, 3) and torch.isfinite(out.gen_img).all()


def test_generators_refuse_what_jax_refuses(vfm_dirs, qwen_preset):
    """MAE under the EQ prior (no dynamic resolution) and Qwen's layer -1
    (the merger output, at half the grid) beside block layers: JAX fails,
    and so does the port. Qwen's layer -1 alone builds in JAX with a z at
    half the configured resolution; the port refuses it too."""
    img = jnp.zeros((1, 32, 32, 3))
    kw = dict(_tiny_g_kwargs(vfm_dirs["mae"]), scale_factor=0.5, patch_in_dimensions=[32] * 3)
    jg = JaxGenerator(**kw)
    with pytest.raises(AssertionError, match="dynamic-resolution"):
        jax.eval_shape(lambda: jg.init({"params": jax.random.PRNGKey(0)}, img, eq=(0.5, 0, True)))
    jax.eval_shape(lambda: jg.init({"params": jax.random.PRNGKey(0)}, img))
    pg = Generator(**kw)
    with pytest.raises(ValueError, match="no dynamic resolution"):
        pg(torch.zeros(1, 32, 32, 3), eq=(0.5, 0, True))
    assert torch.isfinite(pg(torch.zeros(1, 32, 32, 3)).gen_img).all()

    kw = dict(_tiny_g_kwargs("qwen-tiny"), patch_from_layers=[0, 2, -1],
              patch_in_dimensions=[32, 32, 24], patch_out_dimensions=[8, 8, 8])
    with pytest.raises(TypeError, match="concatenate"):
        jax.eval_shape(lambda: JaxGenerator(**kw).init({"params": jax.random.PRNGKey(0)}, img))
    with pytest.raises(ValueError, match="merger output"):
        Generator(**kw)
    kw.update(patch_from_layers=[-1], patch_in_dimensions=[24], patch_out_dimensions=[8])
    jg = JaxGenerator(**kw)
    z = jax.eval_shape(lambda: jg.apply(jg.init({"params": jax.random.PRNGKey(0)}, img), img,
                                        method=jg.encode))
    assert z.shape == (1, 2, 2, 8)  # configured: 4 x 4
    with pytest.raises(ValueError, match="merger output"):
        Generator(**kw)


def test_alignment_extract_vfm_mode_matches_jax(vfm_dirs, tmp_path):
    """The extractor's vfm mode on a tiny DINOv2 (seeded random weights):
    the mean over the layer's patch tokens, as JAX's extractor computes it
    on the same weights."""
    import PIL.Image

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    r = np.random.default_rng(19)
    for i in range(3):
        PIL.Image.fromarray(r.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(
            imgs / f"img_{i}.png")
    out = alignment_extract.main(["vfm", "--model", vfm_dirs["dinov2"], "--layer", "1",
                                  "--images", str(imgs), "--out", str(tmp_path / "f.npz"),
                                  "--resolution", "16", "--device", "cpu"])
    got = np.load(out["features"])
    assert list(got["names"]) == [f"img_{i}.png" for i in range(3)]
    from vfm_vae_tpu_torch.tools._dit import init_model

    pe = init_model(tvfm.VFMEncoder(vfm_dirs["dinov2"], 1.0, [1]), 0, "cpu")
    sd = {k: v.numpy() for k, v in pe.encoder.state_dict().items()}
    je = jvfm.VFMEncoder(model_name=vfm_dirs["dinov2"], scale_factor=1.0, patch_from_layers=[1])
    x = np.stack([np.asarray(PIL.Image.open(imgs / f"img_{i}.png"), np.float32) / 255
                  for i in range(3)])
    feats, _ = jax_apply(je, {"params": {"tower": jconvert.convert_dinov2(sd)}}, jnp.asarray(x),
                         method=je.encode_image)
    assert got["features"].shape == (3, 32)
    np.testing.assert_allclose(got["features"], feats[0].mean(1), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("family", ["dinov2", "qwen"])
def test_kernel_sites_count_the_towers_int8_calls(family, dinov2_pair, qwen_preset, monkeypatch):
    """entry.kernel_sites' K6 sites of one encode, rows per image times the
    batch, against the int8 products an encode makes under the scope: the
    CLS row of DINOv2's tokens, a quarter of the rows at Qwen's merger."""
    from vfm_vae_tpu_torch.entry import kernel_sites

    if family == "dinov2":
        pg = dinov2_pair["pg"]
    else:
        pg = Generator(**dict(_tiny_g_kwargs("qwen-tiny"), patch_from_layers=[0, 2],
                              patch_in_dimensions=[32, 32], use_vf_loss=False))
    calls = []
    real = quantized.int8_matmul

    def record(x, wq, *args, **kw):
        calls.append((x.reshape(-1, x.shape[-1]).shape[0], x.shape[-1], wq.shape[0]))
        return real(x, wq, *args, **kw)

    monkeypatch.setattr(quantized, "int8_matmul", record)
    quantized.prequantize_linears(pg.vfm_encoder)
    with layers.int8_linear_scope(True):
        sites = kernel_sites(pg, 32)["int8_matmul"]
        pg.vfm_encoder.encode_image(torch.rand(2, 32, 32, 3))  # (the adapter's run int8 too)
    want = sorted((2 * s["M"], s["K"], s["N"]) for s in sites for _ in range(s["count"]))
    assert sorted(calls) == want and len(want) == len(list(
        m for m in pg.vfm_encoder.modules() if isinstance(m, layers.Linear)))
    assert {s["M"] for s in sites} == ({8 * 8 + 1} if family == "dinov2" else {64, 16})

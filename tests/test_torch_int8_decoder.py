"""The decoder's static-int8 ConvNeXt MLP (vfm_vae_tpu/models/convnext.py:
_int8_mlp, ops/quantized.py: prequantize_decoder_mlps, the calibration of
as_u and as_h) in the port against the JAX package on the CPU, where it
runs through K6's plain twins (the gelu mode's pre-pass and epilogue, then
the residual mode: K6 static with the layer scale and the residual in its
epilogue); K6's plan and per-image row grouping in the gelu mode, pure
torch. The kernel itself is checked on the card (tests/test_torch_gpu.py,
chip_smoke.py).

Tolerances: the mirrors bit for bit, the scales to 1e-6 relative (a
layer's; 1e-5 through a whole Generator's calibration); on identical
mirrors and scales the quantized codes identical in >= 99.9% of entries and
never more than one apart (the port forms u = x * A from its own GroupNorm
fold), the layer's output within a mean relative L1 of 1e-3 of JAX's, both
within 0.05 of the fp32 layer (tests/test_int8_serving.py:130); a tiny
Generator's int8 decode on identical int8 state within a mean relative L1
of 1e-3 of JAX's int8 decode (5e-3 asked; 2.6e-5 read), every layer's
codes as the single layer's."""

import importlib

import numpy as np
import pytest

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import torch

from __graft_entry__ import _tiny_g_kwargs
from tests.test_torch_generator import jax_variables_from_port, randomize_zero_init
from tests.test_torch_generator import write_tiny_siglip
from tests.test_torch_legacy import apply_jax, init_jax
from tests.test_torch_modules import load
from vfm_vae_tpu.models import convnext as jcx
from vfm_vae_tpu.models.generator import Generator as JaxGenerator
from vfm_vae_tpu.ops import quantized as jq
from vfm_vae_tpu_torch.entry import kernel_sites
from vfm_vae_tpu_torch.models import convert
from vfm_vae_tpu_torch.models import convnext as tcx
from vfm_vae_tpu_torch.models.generator import Generator
from vfm_vae_tpu_torch.ops import kernels
from vfm_vae_tpu_torch.ops import quantized as tq
from tests.torch_threads import one_torch_thread  # noqa: F401

C, W_DIM = 32, 16
k6 = importlib.import_module("vfm_vae_tpu_torch.ops.kernels.int8_matmul")


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def rel_l1(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-12))


def flat(tree):
    return tu.flatten_dict(jax.tree_util.tree_map(np.asarray, tree), sep="/")


# ------------------------------------------------------------------ one layer


@pytest.fixture(scope="module")
def layer_pair():
    """A ConvNeXt layer in both packages on the same weights (layer scale
    drawn), the JAX mirrors and its calibrated scales."""
    jm = jcx.ConvNeXtSynthesisLayer(channels=C, w_dim=W_DIM, kernel_size=7)
    x, w = randn(1, 2, 8, 8, C), randn(2, 2, W_DIM)
    params, _ = init_jax(jm, jnp.asarray(x), jnp.asarray(w))
    params = randomize_zero_init(params)
    v = {"params": params}
    v8 = dict(v, int8=jq.prequantize_decoder_mlps(params))
    v8 = jq.calibrate_int8_act_scales(
        lambda vv, xx, ww: jm.apply(vv, xx, ww, mutable=["act_stats"]), v8, jnp.asarray(x),
        jnp.asarray(w))
    pm = load(tcx.ConvNeXtSynthesisLayer(C, W_DIM, 7),
              lambda sd, p: convert._convnext_layer(sd, p, {}, "", False), params)
    return dict(jm=jm, v=v, v8=v8, x=x, w=w, pm=pm)


def port_int8(pm, int8):
    """The JAX layer's int8 collection on the port layer (w1q, w2q transposed)."""
    for name, val in int8.items():
        val = np.asarray(val)
        setattr(pm, name, torch.from_numpy(val.T.copy() if name in ("w1q", "w2q") else val.copy()))


def test_decoder_mirrors_match_jax_bit_for_bit(layer_pair):
    pm, want = layer_pair["pm"], flat(layer_pair["v8"]["int8"])
    assert tq.prequantize_decoder_mlps(pm) == 1
    for name in ("w1q", "ws1", "w2q", "ws2"):
        got = getattr(pm, name).numpy()
        ref = want[name].T if name in ("w1q", "w2q") else want[name]
        assert got.dtype == ref.dtype and np.array_equal(got, ref), name


def test_calibrated_scales_match_jax(layer_pair):
    pm, want = layer_pair["pm"], flat(layer_pair["v8"]["int8"])
    tq.prequantize_decoder_mlps(pm)
    n = tq.calibrate_int8_act_scales(pm, torch.from_numpy(layer_pair["x"]),
                                     torch.from_numpy(layer_pair["w"]))
    assert n == 2
    for name in ("as_u", "as_h"):
        got, ref = float(getattr(pm, name)), float(want[name])
        assert abs(got - ref) <= 1e-6 * abs(ref), (name, got, ref)


def test_int8_layer_matches_jax_int8_mlp(layer_pair, monkeypatch):
    s = layer_pair
    x, w = jnp.asarray(s["x"]), jnp.asarray(s["w"])
    # JAX's codes: the int8 operand of the first product, caught at the
    # dot_general that _int8_mlp calls (an eager apply).
    dots = []
    dot_general = jax.lax.dot_general

    def spy(lhs, rhs, *a, **k):
        if lhs.dtype == jnp.int8:
            dots.append(np.asarray(lhs))
        return dot_general(lhs, rhs, *a, **k)

    monkeypatch.setattr(jax.lax, "dot_general", spy)
    y_ref = np.asarray(s["jm"].apply(s["v8"], x, w))
    monkeypatch.setattr(jax.lax, "dot_general", dot_general)
    y32 = np.asarray(s["jm"].apply(s["v"], x, w))
    codes = []
    gelu = tcx.int8_matmul_gelu

    def keep_codes(*a, **k):
        h, uq = gelu(*a, return_codes=True, **k)
        codes.append(uq)
        return h

    monkeypatch.setattr(tcx, "int8_matmul_gelu", keep_codes)
    pm = s["pm"]
    port_int8(pm, flat(s["v8"]["int8"]))
    with torch.no_grad():
        y = pm(torch.from_numpy(s["x"]), torch.from_numpy(s["w"])).numpy()
    ref_codes, got_codes = dots[0].astype(np.int32), codes[0].numpy().astype(np.int32)
    assert got_codes.shape == ref_codes.shape == (2, 8, 8, C)
    diff = np.abs(got_codes - ref_codes)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (diff.max(), (diff == 0).mean())
    assert rel_l1(y, y_ref) <= 1e-3
    # Both within quantization noise of the fp32 layer.
    assert 0.0 < rel_l1(y_ref, y32) < 0.05 and 0.0 < rel_l1(y, y32) < 0.05


@pytest.mark.parametrize("hw,int8", [(64, True), (128, False)])
def test_64_squared_gate_routes_as_jax(layer_pair, hw, int8):
    """Maps of at most 64 x 64 run the int8 MLP, larger ones the bf16/fp32
    path (K1's twin in the port), in both packages."""
    s = layer_pair
    Cg = 16
    jm = jcx.ConvNeXtSynthesisLayer(channels=Cg, w_dim=W_DIM, kernel_size=7)
    x, w = randn(3, 1, hw, hw, Cg), randn(4, 1, W_DIM)
    params, _ = init_jax(jm, jnp.asarray(x), jnp.asarray(w))
    params = randomize_zero_init(params)
    int8_tree = dict(jq.prequantize_decoder_mlps(params), as_u=jnp.float32(0.05),
                     as_h=jnp.float32(0.02))
    y_plain = apply_jax(jm, {"params": params}, jnp.asarray(x), jnp.asarray(w))
    y_int8 = apply_jax(jm, {"params": params, "int8": int8_tree}, jnp.asarray(x), jnp.asarray(w))
    assert np.array_equal(y_plain, y_int8) != int8
    pm = load(tcx.ConvNeXtSynthesisLayer(Cg, W_DIM, 7),
              lambda sd, p: convert._convnext_layer(sd, p, {}, "", False), params)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    with torch.no_grad():
        p_plain = pm(xt, wt).numpy()
        port_int8(pm, flat(int8_tree))
        assert pm.int8_route(xt) == int8
        p_int8 = pm(xt, wt).numpy()
    assert np.array_equal(p_plain, p_int8) != int8
    np.testing.assert_allclose(p_plain, y_plain, rtol=1e-4, atol=1e-4)
    if int8:
        assert rel_l1(p_int8, y_int8) <= 1e-3


# ------------------------------------------------------------------ the Generator


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    kw = _tiny_g_kwargs(write_tiny_siglip(tmp_path_factory.mktemp("vfm")
                                          / "siglip2-tiny-patch8-32"))
    params, buffers = jax_variables_from_port(kw)
    params = randomize_zero_init(params)
    return kw, params, buffers


def test_prequantize_decoder_mlps_names_and_values_match_jax(tiny):
    kw, params, buffers = tiny
    pg = Generator(**kw)
    geometry = convert.geometry_from_kwargs(kw)
    convert.load_jax_variables(pg, params, buffers, geometry=geometry)
    n = sum(isinstance(m, tcx.ConvNeXtSynthesisLayer) for m in pg.synthesis.modules())
    assert tq.prequantize_decoder_mlps(pg.synthesis) == n == 16
    want = flat(jq.prequantize_decoder_mlps(params["synthesis"]))
    got = flat(convert.int8_collection_from_state_dict(
        {k: v.numpy() for k, v in pg.state_dict().items()})["synthesis"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    # ... and the JAX collection carried into a fresh port G loads the same buffers.
    pg2 = Generator(**kw)
    convert.load_jax_variables(pg2, params, buffers, geometry=geometry,
                               int8={"synthesis": jq.prequantize_decoder_mlps(params["synthesis"])})
    sd, sd2 = pg.state_dict(), pg2.state_dict()
    assert sorted(sd) == sorted(sd2) and all(torch.equal(sd[k], sd2[k]) for k in sd)


def jax_int8_decoder(jg, variables, calib):
    """The JAX package's counterpart of enable_int8_decoder: its
    enable_int8_tower, then the decoder mirrors, whose scales record through
    a decode of the serving encode with the Linears outside the int8 scope
    (the adapter fp32, as it serves). Default XLA compiles: at
    FAST_COMPILE's optimization level 0 XLA rounds the decode otherwise,
    and the int8 decode moves by 3.6e-3."""
    from vfm_vae_tpu.models import layers as jlayers

    v8 = jq.enable_int8_tower(jg, variables, calib)
    v8 = dict(v8, int8=dict(v8["int8"],
                            synthesis=jq.prequantize_decoder_mlps(variables["params"]["synthesis"])))
    z = jax.jit(lambda v, x: jg.apply(v, x, method=jg.encode))(v8, calib)

    def decode_mut(v, zz):
        prev, jlayers._INT8_SCOPE[0] = jlayers._INT8_SCOPE[0], False
        try:
            return jg.apply(v, zz, method=jg.decode, mutable=["act_stats"])
        finally:
            jlayers._INT8_SCOPE[0] = prev

    return jq.calibrate_int8_act_scales(jax.jit(decode_mut), v8, z)


def jax_decode_codes(jg, variables, z):
    """JAX's int8 decode and the int8 operand of every dot_general in it
    (a layer's codes of u, then of h), from one jitted call."""
    dot_general = jax.lax.dot_general

    def run(v, zz):
        dots = []

        def spy(lhs, rhs, *a, **k):
            if lhs.dtype == jnp.int8:
                dots.append(lhs)
            return dot_general(lhs, rhs, *a, **k)

        jax.lax.dot_general = spy
        try:
            return jg.apply(v, zz, method=jg.decode), dots
        finally:
            jax.lax.dot_general = dot_general

    out, dots = jax.jit(run)(variables, z)
    return np.asarray(out), [np.asarray(d).astype(np.int32) for d in dots]


def test_int8_decode_matches_jax(tiny, monkeypatch):
    """enable_int8_decoder (the tower as enable_int8_tower sets it up, then
    the decoder MLPs mirrored and calibrated through a decode of the
    serving encode) against the same recipe in the JAX package: the same
    mirrors, the scales to 1e-5 relative. On identical int8 state, carried
    by state_dict_from_jax, every layer's codes of u agree with JAX's in >=
    99.9% of entries and never more than one apart, and the decode reads
    within 1e-3 of JAX's (5e-3 asked; 2.6e-5 read). Each package on its own
    scales stays within 0.05 of the fp32 decode, and the two within 5e-3 of
    each other (3.6e-3 read): the chain of 16 quantized layers amplifies any
    change (JAX's own int8 decode moves 2.9e-3 when z moves by 1e-6
    relative)."""
    kw, params, buffers = tiny
    monkeypatch.setenv("VFM_VAE_INT8_VFM", "1")
    calib = np.random.default_rng(5).random((4, 32, 32, 3)).astype(np.float32)
    z = randn(6, 2, 4, 4, 8)
    jg = JaxGenerator(**kw)
    v8 = jax_int8_decoder(jg, {"params": params, "buffers": buffers}, jnp.asarray(calib))
    ref, dots = jax_decode_codes(jg, v8, jnp.asarray(z))
    geometry = convert.geometry_from_kwargs(kw)

    pg = Generator(**kw)
    convert.load_jax_variables(pg, params, buffers, geometry=geometry)
    with torch.no_grad():
        img32 = pg.decode(torch.from_numpy(z)).numpy()  # fp32 (4.5e-7 from JAX's)
    n = tq.enable_int8_decoder(pg, torch.from_numpy(calib))
    want = flat(v8["int8"])
    got = flat(convert.int8_collection_from_state_dict(
        {k: v.numpy() for k, v in pg.state_dict().items()}))
    assert n == sum(k.split("/")[-1].startswith("as") for k in got)
    # JAX's encode also runs (and calibrates) SigLIP's MAP head, which the
    # port's encode does not run; every other mirror and scale is in both.
    assert {k for k in want if not ("/head/" in k and k.endswith("/as"))} == set(got)
    for k in got:
        if k.split("/")[-1].startswith("as"):
            assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(float(want[k])), k
        else:
            assert np.array_equal(got[k], want[k]), k
    kernels.reset_launch_counts()
    with torch.no_grad():
        own = pg.decode(torch.from_numpy(z)).numpy()
    assert kernels.launch_counts()["int8_matmul_gelu"] == 0  # the CPU runs the twins
    assert 0.0 < rel_l1(own, img32) < 0.05 and 0.0 < rel_l1(ref, img32) < 0.05
    assert rel_l1(own, ref) <= 5e-3  # each package on its own scales
    # Every ConvNeXt layer of the tiny decoder (4 to 32 px) takes the int8 MLP.
    sites = {k: sum(s["count"] for s in v) for k, v in kernel_sites(pg, 32).items()}
    assert sites["int8_matmul_gelu"] == sites["int8_matmul_residual"] == 16
    assert sites["fused_convnext_mlp"] == 0

    codes, gelu = [], tcx.int8_matmul_gelu

    def keep_codes(*a, **k):
        h, uq = gelu(*a, return_codes=True, **k)
        codes.append(uq.numpy().astype(np.int32))
        return h

    monkeypatch.setattr(tcx, "int8_matmul_gelu", keep_codes)
    same = Generator(**kw)
    convert.load_jax_variables(same, params, buffers, geometry=geometry,
                               int8={"synthesis": v8["int8"]["synthesis"]})
    with torch.no_grad():
        img = same.decode(torch.from_numpy(z)).numpy()
    assert len(codes) == 16 and len(dots) == 32
    for i, c in enumerate(codes):
        diff = np.abs(c - dots[2 * i])
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (i, diff.max(), (diff == 0).mean())
    assert rel_l1(img, ref) <= 1e-3


def test_int8_serving_generator_takes_the_decoder_mlp(tiny, monkeypatch):
    """entry.int8_serving_generator(..., decoder_mlp=True) on the tiny
    geometry (overrides of the flagship's keywords): the tower and every
    decoder MLP mirrored and calibrated; off by default."""
    from vfm_vae_tpu_torch.entry import int8_serving_generator

    kw, _, _ = tiny
    monkeypatch.setenv("VFM_VAE_INT8_VFM", "0")
    calib = torch.from_numpy(np.random.default_rng(7).random((2, 32, 32, 3)).astype(np.float32))
    layers = lambda G: [m for m in G.modules() if isinstance(m, tcx.ConvNeXtSynthesisLayer)]  # noqa
    G8 = int8_serving_generator("cpu", calib, torch.float32, decoder_mlp=True, **kw)
    assert all(m.as_u is not None and m.w1q is not None for m in layers(G8))
    G = int8_serving_generator("cpu", calib, torch.float32, **kw)
    assert all(m.w1q is None for m in layers(G))
    assert all(lin.wq is not None for lin in G.vfm_encoder.modules() if hasattr(lin, "wq"))


# ------------------------------------------------------------------ K6's gelu mode


@pytest.mark.parametrize("M,K,N", [(32 * 64, 512, 2048), (32 * 256, 512, 2048),
                                   (32 * 1024, 512, 2048), (32 * 4096, 512, 2048),
                                   (4 * 64, 512, 2048), (2 * 16, 64, 256), (3 * 64, 40, 160)])
def test_gelu_plan(M, K, N):
    """The gelu mode always runs the quantize pre-pass and reads int8
    stages (of padded_k(K) columns); the tiles and ring as the other modes'."""
    p = k6.plan(M, N, K, "gelu", 132)
    assert p["pad"] and p["prepass"] and not p["direct_store"]
    stage = p["tile_m"] * p["stage_k"] + p["tile_n"] * p["stage_k"]
    assert p["smem_bytes"] == p["stages"] * (stage + 16) + k6.EPILOGUE_BYTES + k6.SLACK
    assert p["smem_bytes"] <= k6.SMEM_MAX < p["smem_bytes"] + stage + 16
    tiles = -(-M // 128) * -(-N // p["tile_n"])
    assert p["tiles"] == tiles and p["ctas"] == min(tiles, 132)
    assert p["tile_n"] == (256 if 2 * -(-M // 128) * -(-N // 256) >= 132 else 128)
    assert k6.plan(M, N, K, "static", 132)["stages"] <= p["stages"]  # int8 stages are smaller


@pytest.mark.parametrize("B,H,K,N", [(3, 8, 64, 256), (2, 4, 40, 160), (1, 16, 32, 64)])
def test_gelu_twin_groups_rows_by_image(B, H, K, N):
    """The twin's per-image scale and bias, against the kernel's indexing:
    row m of a 128-row tile reads image min(m, M - 1) // (H W) (an 8 x 8
    image is 64 rows, half a tile), quantized from the fp32 product x * A."""
    g = torch.Generator().manual_seed(B * 100 + H)
    x = torch.randn(B, H, H, K, generator=g).to(torch.bfloat16)
    A = torch.rand(B, K, generator=g) + 0.5
    wq = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
    e = torch.rand(B, N, generator=g) * 1e-3
    b = torch.randn(B, N, generator=g)
    s = torch.tensor(0.02)
    h, uq = kernels.int8_matmul_gelu(x, A, wq, e, b, s, return_codes=True)
    assert h.dtype == torch.bfloat16 and uq.dtype == torch.int8
    M, hw = B * H * H, H * H
    rows = x.reshape(M, K).float()
    want_codes = torch.empty(M, K)
    want = torch.empty(M, N)
    for m0 in range(0, M, 128):  # tile by tile, row by row
        for m in range(m0, min(m0 + 128, M)):
            img = min(m, M - 1) // hw
            u = rows[m] * A[img]
            want_codes[m] = torch.clamp(torch.round(u * (1 / s)), -127, 127)
            acc = (want_codes[m].double() @ wq.double().t()).float()
            want[m] = k6.gelu_erf(acc * e[img] + b[img])
    assert torch.equal(uq.reshape(M, K).float(), want_codes)
    assert torch.equal(h.reshape(M, N), want.to(torch.bfloat16))
    # The exact GELU, not K1's tanh form.
    v = torch.linspace(-4, 4, 101)
    torch.testing.assert_close(k6.gelu_erf(v), torch.nn.functional.gelu(v), rtol=0, atol=1e-6)


def test_gelu_wrapper_refuses_grad_and_takes_plain():
    x = torch.randn(1, 2, 2, 32).to(torch.bfloat16)
    args = (torch.ones(1, 32), torch.ones(8, 32, dtype=torch.int8), torch.ones(1, 8),
            torch.zeros(1, 8), torch.tensor(0.1))
    assert torch.equal(kernels.int8_matmul_gelu(x, *args),
                       kernels.int8_matmul_gelu(x, *args, plain=True))
    assert kernels.int8_matmul_gelu in kernels.ALL_WRAPPERS

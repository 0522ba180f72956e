"""The port's W8A8 int8 tower serving path (vfm_vae_tpu_torch.ops.quantized,
the int8 Linear, K6/K10's twins, K4's twin and the flash routing) against
the JAX package on the CPU.

K6's plain twin (dynamic and static scale) is held against
ops/quantized.int8_linear_prequant(_static) and against the Pallas kernel
_int8_matmul_2d in interpret mode, as tests/test_ops.py runs it; K10's twin
against the int32 `(xq @ wq) >> 8`. At the tiny geometry of
__graft_entry__._tiny_g_kwargs the weight mirror, the calibrated activation
scales and the int8 encode are held against JAX's, with JAX's int8
collection carried across so both packages run the same quantized weights
and scales. The CUDA kernels run only on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import numpy as np
import pytest

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import torch

from __graft_entry__ import _tiny_g_kwargs
from tests.test_torch_generator import jax_variables_from_port, write_tiny_siglip
from vfm_vae_tpu.models.generator import Generator as JaxGenerator
from vfm_vae_tpu.ops import quantized as jq
from vfm_vae_tpu.ops.attention import dot_product_attention as j_attention
from vfm_vae_tpu_torch.entry import FLAGSHIP_KWARGS, int8_serving_generator, kernel_sites
from vfm_vae_tpu_torch.models import convert, layers
from vfm_vae_tpu_torch.models.adapter import PlainAttention
from vfm_vae_tpu_torch.models.generator import Generator
from vfm_vae_tpu_torch.ops import kernels, quantized
from vfm_vae_tpu_torch.ops.attention import dot_product_attention
from vfm_vae_tpu_torch.ops.kernels.int8_matmul import quantize_activations
from tests.torch_threads import one_torch_thread  # noqa: F401


def matmul_inputs(M=64, K=256, N=128, seed=0, ties=True):
    """x (M, K) fp32 with, when `ties`, rows whose absmax is 127 (scale 1)
    and whose other entries sit on .5: x / s is then exactly a half."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((M, K)).astype(np.float32) * 3
    if ties:
        x[:4] = r.integers(-126, 126, (4, K)) + 0.5
        x[:4, 0] = 127.0
        x[4] = np.linspace(-3.5, 3.5, K)  # scale 3.5/127: a few exact halves as well
    wq = r.integers(-127, 128, (N, K)).astype(np.int8)
    ws = (np.abs(r.standard_normal(N)) * 0.01 + 1e-4).astype(np.float32)
    b = r.standard_normal(N).astype(np.float32)
    return x, wq, ws, b


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_matmul_twin_matches_jax(mode):
    x, wq, ws, b = matmul_inputs()
    a_s = np.float32(80.0 / 127.0)  # clips the tie rows' +-127 and +-126.5 entries
    tx, twq, tws, tb = (torch.from_numpy(a) for a in (x, wq, ws, b))
    jx, jwq, jws, jb = jnp.asarray(x), jnp.asarray(wq.T), jnp.asarray(ws), jnp.asarray(b)
    if mode == "dynamic":
        want = jq.int8_linear_prequant(jx, jwq, jws, jb)
        got = kernels.int8_matmul(tx, twq, tws, tb)
    else:
        want = jq.int8_linear_prequant_static(jx, jwq, jws, jnp.asarray(a_s), jb)
        got = kernels.int8_matmul(tx, twq, tws, tb, torch.tensor(a_s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    # The quantized activations, bit for bit: an identity weight with unit
    # scales and no bias gives y = xq * s in both packages.
    eye = np.eye(x.shape[1], dtype=np.int8)
    ones = np.ones(x.shape[1], np.float32)
    a_arg = () if mode == "dynamic" else (jnp.asarray(a_s),)
    fn = jq.int8_linear_prequant if mode == "dynamic" else jq.int8_linear_prequant_static
    y = np.asarray(fn(jx, jnp.asarray(eye), jnp.asarray(ones), *a_arg))
    xq, s = quantize_activations(tx, mode, None if mode == "dynamic" else torch.tensor(a_s))
    np.testing.assert_array_equal(np.round(y / s.numpy()), xq.numpy())
    if mode == "dynamic":  # the tie rows: s == 1 exactly, y == xq, halves went to even
        np.testing.assert_array_equal(y[:4], np.round(x[:4]))
        assert np.any(np.round(x[:4]) != np.trunc(x[:4] + np.sign(x[:4]) * 0.5))


def test_int8_matmul_twin_matches_the_pallas_kernel():
    """The dynamic twin against _int8_matmul_2d in interpret mode (a 2 x 2
    grid that reuses the quantized row tile), tie rows included."""
    from jax.experimental.pallas import tpu as pltpu

    from vfm_vae_tpu.ops.pallas.int8_matmul import _int8_matmul_2d

    x, wq, ws, b = matmul_inputs(M=256, K=256, N=256, seed=3)
    with pltpu.force_tpu_interpret_mode():
        want = _int8_matmul_2d(jnp.asarray(x), jnp.asarray(wq.T), jnp.asarray(ws).reshape(1, -1),
                               jnp.asarray(b).reshape(1, -1), 128, 128)
    got = kernels.int8_matmul(*(torch.from_numpy(a) for a in (x, wq, ws, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_int8_matmul_raw_twin_is_exact():
    """K10's twin: int8(int32 (xq @ wq) >> 8), two's-complement wrap."""
    r = np.random.default_rng(4)
    xq = r.integers(-127, 128, (96, 256)).astype(np.int8)
    wq = r.integers(-127, 128, (64, 256)).astype(np.int8)
    acc = jax.lax.dot_general(jnp.asarray(xq), jnp.asarray(wq.T), (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    want = np.asarray((acc >> 8).astype(jnp.int8))
    got = kernels.int8_matmul_raw(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(np.asarray(acc) >> 8).max() > 127  # the narrowing wraps


def test_int8_matmul_bf16_twin_rounds_once():
    """bf16 input and output: the twin's fp32 epilogue rounded once to bf16."""
    x, wq, ws, b = matmul_inputs(ties=False)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = kernels.int8_matmul(xb, torch.from_numpy(wq), torch.from_numpy(ws), torch.from_numpy(b))
    want = jq.int8_linear_prequant(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                                   jnp.asarray(wq.T), jnp.asarray(ws), jnp.asarray(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# ------------------------------------------------------------ the tiny tower


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """JAX and port tiny Generators on the same weights; JAX's int8 mirror,
    its calibrated scales and its encode moments with and without int8."""
    vfm_dir = tmp_path_factory.mktemp("vfm") / "siglip2-tiny-patch8-32"
    kw = _tiny_g_kwargs(write_tiny_siglip(vfm_dir))
    gp, gb = jax_variables_from_port(kw)
    jg = JaxGenerator(**kw)
    img = np.random.default_rng(1).random((2, 32, 32, 3)).astype(np.float32)
    calib = np.random.default_rng(2).random((4, 32, 32, 3)).astype(np.float32)
    v = {"params": gp, "buffers": gb}
    v8 = jq.add_int8_collection(v)
    v8 = jq.calibrate_int8_act_scales(jax.jit(lambda vv, x: jg.apply(
        vv, x, rng=None, method=jg.encode, mutable=["act_stats"])), v8, jnp.asarray(calib))
    enc = jax.jit(lambda vv, x: jg.apply(vv, x, return_z_before_quantize=True, method=jg.encode))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VFM_VAE_INT8_VFM", "1")
        m_int8 = np.asarray(enc(v8, jnp.asarray(img)))
    m_float = np.asarray(jax.jit(lambda vv, x: jg.apply(
        vv, x, return_z_before_quantize=True, method=jg.encode))(v, jnp.asarray(img)))
    int8 = tu.unflatten_dict({k: np.asarray(a) for k, a in tu.flatten_dict(v8["int8"]).items()})
    return dict(kw=kw, gp=gp, gb=gb, img=img, calib=calib, int8=int8, m_int8=m_int8,
                m_float=m_float, geometry=convert.geometry_from_kwargs(kw))


def port_g(rig, int8=None):
    pg = Generator(**rig["kw"])
    convert.load_jax_variables(pg, rig["gp"], rig["gb"], geometry=rig["geometry"], int8=int8)
    return pg


def test_prequantize_linears_matches_jax_bit_for_bit(rig):
    pg = port_g(rig)
    n = quantized.prequantize_linears(pg.vfm_encoder)
    want = convert.state_dict_from_jax(rig["gp"], rig["gb"], geometry=rig["geometry"],
                                       int8={"vfm_encoder": jq.prequantize_linears(
                                           rig["gp"]["vfm_encoder"])})
    got = pg.state_dict()
    keys = [k for k in want if k.endswith((".wq", ".ws"))]
    assert len(keys) == 2 * n and n == 2 * 6 + 3  # two blocks and the MAP head
    for k in keys:
        assert got[k].dtype == (torch.int8 if k.endswith(".wq") else torch.float32), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_calibrated_scales_match_jax(rig, monkeypatch):
    monkeypatch.setenv("VFM_VAE_INT8_VFM", "0")  # restored after enable_int8_tower sets "1"
    pg = port_g(rig)
    n = quantized.enable_int8_tower(pg, torch.from_numpy(rig["calib"]))
    assert quantized.int8_vfm_enabled()
    assert n == 2 * 6  # every Linear of the blocks; the MAP head is never computed
    want = convert.state_dict_from_jax(rig["gp"], rig["gb"], geometry=rig["geometry"],
                                       int8=rig["int8"])
    got = pg.state_dict()
    a_keys = [k for k in got if k.endswith(".as")]
    assert len(a_keys) == n
    for k in a_keys:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=0, err_msg=k)


def test_int8_collection_round_trip_is_bit_exact(rig):
    sd = convert.state_dict_from_jax(rig["gp"], rig["gb"], geometry=rig["geometry"],
                                     int8=rig["int8"])
    back = convert.int8_collection_from_state_dict(sd)
    want, got = tu.flatten_dict(rig["int8"]), tu.flatten_dict(back)
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k


def test_int8_encode_matches_jax(rig, monkeypatch):
    """JAX's int8 collection on the port: the int8 encode's moments at the
    bf16 slice's tolerance, and at least 10x closer to JAX's int8 moments
    than to its non-int8 moments (the int8 path ran)."""
    pg = port_g(rig, int8=rig["int8"])
    img = torch.from_numpy(rig["img"])
    monkeypatch.setenv("VFM_VAE_INT8_VFM", "1")
    got = pg.encode(img, return_z_before_quantize=True).numpy()
    np.testing.assert_allclose(got, rig["m_int8"], rtol=5e-4, atol=5e-4)
    d_int8 = np.abs(got - rig["m_int8"]).mean()
    d_float = np.abs(got - rig["m_float"]).mean()
    assert d_float > 10 * d_int8, (d_int8, d_float)
    monkeypatch.delenv("VFM_VAE_INT8_VFM")
    np.testing.assert_allclose(pg.encode(img, return_z_before_quantize=True).numpy(),
                               rig["m_float"], rtol=5e-4, atol=5e-4)


def _tower_out(pg, img):
    return torch.cat([f.flatten() for f in pg.vfm_encoder.encode_image(img)])


def test_outer_scope_reaches_the_tower(rig, monkeypatch):
    """A caller's int8 scope quantizes the tower although VFM_VAE_INT8_VFM is
    unset (the JAX round-2 bug made this a silent no-op); same function up
    to quantization noise."""
    monkeypatch.delenv("VFM_VAE_INT8_VFM", raising=False)
    pg = port_g(rig)
    quantized.add_int8_collection(pg)
    img = torch.from_numpy(rig["img"])
    y = _tower_out(pg, img)
    with layers.int8_linear_scope(True):
        y8 = _tower_out(pg, img)
    diff = float((y - y8).abs().mean())
    assert 0.0 < diff < 0.05 * float(y.abs().mean())


def test_env_opt_in_reaches_the_tower(rig, monkeypatch):
    pg = port_g(rig)
    quantized.add_int8_collection(pg)
    img = torch.from_numpy(rig["img"])
    monkeypatch.delenv("VFM_VAE_INT8_VFM", raising=False)
    y = _tower_out(pg, img)
    monkeypatch.setenv("VFM_VAE_INT8_VFM", "true")  # only the literal "1" opts in
    torch.testing.assert_close(_tower_out(pg, img), y, rtol=0, atol=0)
    monkeypatch.setenv("VFM_VAE_INT8_VFM", "1")
    assert float((_tower_out(pg, img) - y).abs().mean()) > 0.0


def test_calibration_runs_the_dynamic_path(rig):
    """Under the calibration scope a mirrored Linear records its input absmax
    and returns the dynamic int8 output; with `as` set it runs static."""
    lin = port_g(rig).vfm_encoder.tower.encoder.layers[0].mlp.fc1
    quantized.prequantize_linears(lin)
    x = torch.from_numpy(matmul_inputs(M=8, K=64, ties=False)[0][:, :64])
    with layers.int8_calibration_scope() as amax:
        y = lin(x)
        lin(2 * x)
    assert float(amax[lin]) == float(2 * x.abs().max())
    torch.testing.assert_close(y, quantized.int8_linear_prequant(x, lin.wq, lin.ws, lin.bias),
                               rtol=0, atol=0)
    setattr(lin, "as", amax[lin] / 127)
    with layers.int8_linear_scope():
        torch.testing.assert_close(lin(x), quantized.int8_linear_prequant_static(
            x, lin.wq, lin.ws, getattr(lin, "as"), lin.bias), rtol=0, atol=0)


def test_int8_serving_generator_and_encode_sites(rig, monkeypatch):
    """entry.int8_serving_generator at the tiny geometry: every tower Linear
    of the blocks calibrated; the encode's int8 calls are what kernel_sites
    lists."""
    monkeypatch.setenv("VFM_VAE_INT8_VFM", "0")  # restored after enable_int8_tower sets "1"
    calib = torch.from_numpy(rig["calib"])
    G = int8_serving_generator("cpu", calib, torch.float32, **rig["kw"])
    calls = []
    real = quantized.int8_matmul
    monkeypatch.setattr(quantized, "int8_matmul", lambda x, wq, *a, **k: calls.append(
        (x.shape[-2], wq.shape[1], wq.shape[0], len(a) > 2 and a[2] is not None)) or real(
        x, wq, *a, **k))
    z = G.encode(torch.from_numpy(rig["img"]))
    assert z.shape == (2, 4, 4, 8) and torch.isfinite(z).all()
    sites = kernel_sites(G, 32)["int8_matmul"]
    want = sorted((s["M"], s["K"], s["N"], s["static"]) for s in sites for _ in range(s["count"]))
    assert sorted(calls) == want and len(want) == 12 and all(s["static"] for s in sites)


def test_flagship_encode_sites():
    """kernel_sites at the flagship geometry (built on the meta device): 144
    K6 sites per encode (24 blocks x q, k, v, out, fc1, fc2, M = 1024 tokens),
    24 tower K4 sites under VFM_VAE_USE_PALLAS_FLASH=1 and the adapter's four
    eligible AttnProjections under 3mm-flash (the three patch_quants, 16
    heads of 64 at T=1024, and final_quant, 12 heads of 64 at T=256;
    post_quant's 32-wide heads stay on SDPA)."""
    with torch.device("meta"):
        G = Generator(**FLAGSHIP_KWARGS, dtype=torch.bfloat16, device="meta",
                      generator=torch.Generator())
    with pytest.MonkeyPatch.context() as mp:
        for k in ("VFM_VAE_INT8_VFM", "VFM_VAE_USE_PALLAS_FLASH", "VFM_VAE_ADAPTER_ATTN",
                  "VFM_VAE_NO_PALLAS_FLASH"):
            mp.delenv(k, raising=False)
        off = kernel_sites(G, 256)
        assert off["int8_matmul"] == [] and off["flash_attention_nonull"] == []
        mp.setenv("VFM_VAE_INT8_VFM", "1")
        mp.setenv("VFM_VAE_USE_PALLAS_FLASH", "1")
        mp.setenv("VFM_VAE_ADAPTER_ATTN", "3mm-flash")
        on = kernel_sites(G, 256)
        mp.setenv("VFM_VAE_NO_PALLAS_FLASH", "1")
        assert kernel_sites(G, 256)["flash_attention_nonull"] == []
    k6 = {(s["M"], s["K"], s["N"]): s["count"] for s in on["int8_matmul"]}
    assert k6 == {(1024, 1024, 1024): 96, (1024, 1024, 4096): 24, (1024, 4096, 1024): 24}
    k4 = sorted((s["at"], s["T"], s["N"], s["D"], s["count"]) for s in on["flash_attention_nonull"])
    assert k4 == [("adapter", 256, 12, 64, 1), ("adapter", 1024, 16, 64, 3),
                  ("tower", 1024, 16, 64, 24)]


# --------------------------------------------------------------- K4 routing


def attn_inputs(B=1, T=256, N=2, D=64, seed=5):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, T, N, D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_attention_twin_matches_jax(dtype, monkeypatch):
    """K4's twin, reached through the port's dot_product_attention when the
    rule admits the shape, against the JAX package's dot_product_attention."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    q, k, v = attn_inputs()
    ref = np.asarray(j_attention(*(jnp.asarray(a, jdt) for a in (q, k, v))).astype(jnp.float32))
    monkeypatch.setenv("VFM_VAE_USE_PALLAS_FLASH", "1")
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = dot_product_attention(tq, tk, tv)
    twin = kernels.flash_attention_nonull_reference(tq, tk, tv)
    torch.testing.assert_close(got, twin, rtol=0, atol=0)
    if dtype == "fp32":  # fp32 logits and softmax; summation order differs
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:  # probabilities and output rounded to bf16: one output ulp
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=2.0 ** -8 * float(np.abs(ref).max()))


def test_flash_rule_matches_jax(monkeypatch):
    """The eligibility rule, case by case, against the JAX rule with its
    TPU-backend test passed."""
    from vfm_vae_tpu.ops.pallas import flash_attention as jfa
    from vfm_vae_tpu_torch.ops.attention import flash_eligible_shape

    monkeypatch.setattr(jfa.jax, "default_backend", lambda: "tpu")
    cases = [(T, Tk, d, m, p) for T in (128, 256, 384, 1024) for Tk in (256, 300)
             for d in (32, 64, 128) for m in (False, True) for p in (False, True)]
    for env in ({}, {"VFM_VAE_USE_PALLAS_FLASH": "1"},
                {"VFM_VAE_USE_PALLAS_FLASH": "1", "VFM_VAE_NO_PALLAS_FLASH": "1"}):
        for k in ("VFM_VAE_USE_PALLAS_FLASH", "VFM_VAE_NO_PALLAS_FLASH"):
            monkeypatch.delenv(k, raising=False)
        for k, val in env.items():
            monkeypatch.setenv(k, val)
        for T, Tk, d, m, p in cases:
            q, k = jnp.zeros((1, T, 1, d)), jnp.zeros((1, Tk, 1, d))
            want = jfa.flash_eligible(q, k, jnp.ones(()) if m else None, prefer=p)
            assert flash_eligible_shape(T, Tk, d, m, p) == want, (env, T, Tk, d, m, p)


def test_flash_attention_refuses_grad():
    """K4's raw launch refuses inputs that require grad (its output would have
    no grad_fn); the wrapper no longer refuses them: it runs
    FlashAttentionNoNull, whose backward is K4's (tests/test_torch_stats.py)."""
    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v = (torch.from_numpy(a).requires_grad_() for a in attn_inputs(T=8))
    with pytest.raises(RuntimeError, match="autograd.Function"):
        fa._launch_nonull(q, k, v, 0.125, True)
    out = kernels.flash_attention_nonull(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionNoNullBackward"


def _port_plain_attention(params):
    pm = PlainAttention(128, 64, 2)
    sd = {"qkv.weight": params["qkv"].T, "q_bias": params["q_bias"],
          "v_bias": params["v_bias"], "proj.weight": params["proj"]["weight"].T,
          "proj.bias": params["proj"]["bias"]}
    convert.load_state_dict_numpy(pm, sd)
    return pm


@pytest.mark.parametrize("flash", [None, "1"])
def test_training_adapter_attention_under_the_flash_switch(flash, monkeypatch):
    """A trainable adapter attention at an eligible shape (T=256, heads of
    64) under the default 3mm-xla form trains with and without
    VFM_VAE_USE_PALLAS_FLASH: without it through SDPA, with it through K4's
    Function (forward and backward), and its gradients agree with the JAX
    package's (which runs its plain attention on the CPU)."""
    import jax
    from vfm_vae_tpu.models.adapter import PlainAttention as JaxPlainAttention
    from vfm_vae_tpu_torch.ops import attention

    monkeypatch.delenv("VFM_VAE_ADAPTER_ATTN", raising=False)
    monkeypatch.delenv("VFM_VAE_NO_PALLAS_FLASH", raising=False)
    if flash is None:
        monkeypatch.delenv("VFM_VAE_USE_PALLAS_FLASH", raising=False)
    else:
        monkeypatch.setenv("VFM_VAE_USE_PALLAS_FLASH", flash)
    r = np.random.default_rng(7)
    x = r.standard_normal((1, 256, 128)).astype(np.float32)
    jm = JaxPlainAttention(in_dim=128, out_dim=64, num_heads=2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * r.standard_normal(a.shape).astype(np.float32),
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = jax.grad(lambda p, xx: jnp.sum(jnp.square(jm.apply({"params": p}, xx))),
                    argnums=(0, 1))(params, jnp.asarray(x))
    pm = _port_plain_attention(params)
    calls = []
    real = attention.flash_attention_nonull

    def spy(*a, **kw):
        calls.append(torch.is_grad_enabled() and a[0].requires_grad)
        return real(*a, **kw)

    monkeypatch.setattr(attention, "flash_attention_nonull", spy)
    tx = torch.from_numpy(x).requires_grad_()
    pm(tx).square().sum().backward()
    assert calls == ([] if flash is None else [True])
    jp, jx = want
    # fp32 in both packages; the attention's sums run in another order.
    for got, ref in ((pm.qkv.weight.grad.numpy().T, jp["qkv"]), (pm.q_bias.grad, jp["q_bias"]),
                     (pm.v_bias.grad, jp["v_bias"]), (pm.proj.weight.grad.numpy().T,
                                                      jp["proj"]["weight"]),
                     (tx.grad.numpy(), jx)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("variant", ["3mm-flash", "packed"])
def test_adapter_attention_variants_match_3mm_xla(variant, monkeypatch):
    """PlainAttention's three forms agree with each other, in both packages,
    at an eligible adapter shape (T=256, 2 heads of 64, fp32)."""
    from vfm_vae_tpu.models.adapter import PlainAttention as JaxPlainAttention

    r = np.random.default_rng(6)
    x = r.standard_normal((1, 256, 128)).astype(np.float32)
    jm = JaxPlainAttention(in_dim=128, out_dim=64, num_heads=2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * r.standard_normal(a.shape).astype(np.float32),
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    pm = PlainAttention(128, 64, 2)
    sd = {"qkv.weight": params["qkv"].T, "q_bias": params["q_bias"],
          "v_bias": params["v_bias"], "proj.weight": params["proj"]["weight"].T,
          "proj.bias": params["proj"]["bias"]}
    convert.load_state_dict_numpy(pm, sd)

    def both(v):
        monkeypatch.setenv("VFM_VAE_ADAPTER_ATTN", v)
        j = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
        with torch.no_grad():
            return j, pm(torch.from_numpy(x)).numpy()

    j_ref, p_ref = both("3mm-xla")
    j_got, p_got = both(variant)
    np.testing.assert_allclose(p_got, p_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(j_got, j_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p_got, j_got, rtol=1e-5, atol=1e-5)

"""The port's kernel wrappers (vfm_vae_tpu_torch.ops.kernels).

On the CPU each wrapper runs its plain twin; the twins are held against the
JAX package's twins as its own tests run them on the CPU (fused_mlp and
fused_upsample with interpret=True, which selects `_forward_jnp`; the null-KV
attention's concat path), in fp32 and in bf16. The CUDA kernels themselves
run only on the card: tests/test_torch_gpu.py (marker `gpu`) and
chip_smoke.py.
"""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vfm_vae_tpu.ops.attention import dot_product_attention_nullkv as j_nullkv
from vfm_vae_tpu.ops.pallas.fused_mlp import fused_convnext_mlp as j_mlp
from vfm_vae_tpu.ops.pallas.fused_upsample import fused_upsample_blur as j_upsample
from vfm_vae_tpu_torch.ops import kernels
from vfm_vae_tpu_torch.ops.kernels import _build

TAPS = {3: [0.25, 0.5, 0.25], 5: [1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16]}


def ulp_tol(ref: np.ndarray, ulps: float = 1.0) -> float:
    """`ulps` bf16 ulps (2^-8 relative) of the output scale max|ref|."""
    return ulps * 2.0 ** -8 * float(np.abs(ref).max())


def mlp_inputs(B=2, H=4, W=3, C=16, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (r.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return dict(
        x=f(B, H, W, C), x_in=f(B, H, W, C), A=r.uniform(0.5, 1.5, (B, C)).astype(np.float32),
        d=r.uniform(0.5, 1.5, (B, 4 * C)).astype(np.float32),
        w1=f(C, 4 * C, scale=C ** -0.5), b1=f(B, 4 * C, scale=0.5),
        w2=f(4 * C, C, scale=(4 * C) ** -0.5), b2=f(C, scale=0.1), gamma=f(C),
    )


def upsample_inputs(B=2, H=4, W=5, Ci=16, Co=8, seed=1):
    r = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (r.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return dict(x=f(B, H, W, Ci), a=r.uniform(0.5, 1.5, (B, Ci)).astype(np.float32),
                c=f(B, Ci, scale=0.5), dw=f(3, 3, Ci, scale=1 / 3), pw=f(Ci, 4 * Co, scale=Ci ** -0.5))


def attention_inputs(B=2, T=10, N=2, D=16, seed=2):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f(B, T, N, D), k=f(B, T, N, D), v=f(B, T, N, D), null_k=f(B, 1, N, D),
                null_v=f(B, 1, N, D))


def port_mlp_args(i, dt):
    """JAX layout -> port layout: w1 (C, 4C) -> (4C, C), w2 (4C, C) -> (C, 4C)."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in i.items()}
    t["w1"], t["w2"] = t["w1"].t().contiguous(), t["w2"].t().contiguous()
    t["x"], t["x_in"] = t["x"].to(dt), t["x_in"].to(dt)
    return t


def port_upsample_args(i, dt):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in i.items()}
    t["dw"] = t["dw"].permute(2, 0, 1).contiguous()
    t["pw"] = t["pw"].t().contiguous()
    t["x"] = t["x"].to(dt)
    return t


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fused_convnext_mlp_twin_matches_jax(dtype):
    i = mlp_inputs()
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    ref = j_mlp(jnp.asarray(i["x"], jdt), jnp.asarray(i["x_in"], jdt), jnp.asarray(i["A"]),
                jnp.asarray(i["d"]), jnp.asarray(i["w1"]), jnp.asarray(i["b1"]),
                jnp.asarray(i["w2"]), jnp.asarray(i["b2"]), jnp.asarray(i["gamma"]),
                interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    got = kernels.fused_convnext_mlp_reference(**port_mlp_args(i, tdt))
    assert got.dtype == tdt
    if dtype == "fp32":
        # Same fp32 algorithm; summation order differs.
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        # bf16 roundings of x*A, the GELU output and the output: one output ulp.
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=ulp_tol(ref))


@pytest.mark.parametrize("dtype,kb", [("fp32", 3), ("fp32", 5), ("bf16", 3), ("bf16", 5)])
def test_fused_upsample_blur_twin_matches_jax(dtype, kb, monkeypatch):
    # XLA's CPU backend has no bf16 x bf16 -> f32 dot, which the Toeplitz
    # form of the JAX vertical leg (_vblur) uses; the JAX package's own
    # switch selects its edge-pad + depthwise-conv form of the same blur.
    monkeypatch.setenv("VFM_VAE_NO_VBLUR_MM", "1")
    i = upsample_inputs()
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    ref = j_upsample(jnp.asarray(i["x"], jdt), jnp.asarray(i["a"]), jnp.asarray(i["c"]),
                     jnp.asarray(i["dw"]), jnp.asarray(i["pw"]), TAPS[kb], interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    got = kernels.fused_upsample_blur_reference(**port_upsample_args(i, tdt), taps=TAPS[kb])
    assert got.shape == (2, 8, 10, 8) and got.dtype == tdt
    if dtype == "fp32":
        # Same fp32 algorithm; summation order differs.
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        # bf16 roundings of the affine, depthwise, pointwise, both blur legs: one output ulp.
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=ulp_tol(ref))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_attention_nullkv_twin_matches_jax(dtype):
    i = attention_inputs()
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    ref = j_nullkv(*(jnp.asarray(i[k], jdt) for k in ("q", "k", "v", "null_k", "null_v")))
    ref = np.asarray(ref.astype(jnp.float32))
    got = kernels.flash_attention_nullkv_reference(
        *(torch.from_numpy(i[k]).to(tdt) for k in ("q", "k", "v", "null_k", "null_v")))
    if dtype == "fp32":
        # fp32 logits and softmax; summation order differs.
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        # probabilities and output rounded to bf16: one output ulp.
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=ulp_tol(ref))


def _cpu_calls(dt=torch.bfloat16):
    m = port_mlp_args(mlp_inputs(), dt)
    u = port_upsample_args(upsample_inputs(), dt)
    a = {k: torch.from_numpy(v).to(dt) for k, v in attention_inputs().items()}
    f = {k: a[k][:, :, :, :8].repeat(1, 1, 1, 8).contiguous() for k in ("q", "k", "v")}  # D=64
    r = np.random.default_rng(7)
    i8 = dict(x=torch.from_numpy(r.standard_normal((6, 64)).astype(np.float32)).to(dt),
              wq=torch.from_numpy(r.integers(-127, 128, (16, 64)).astype(np.int8)),
              ws=torch.rand(16), b=torch.randn(16))
    raw = dict(xq=i8["wq"][:6].clone(), wq=i8["wq"])
    gs = dict(x=torch.from_numpy(r.standard_normal((2, 4, 5, 128)).astype(np.float32)).to(dt))
    dw = dict(x=gs["x"], w=torch.randn(5, 5, 128), b=torch.randn(128), noise=torch.randn(4, 5))
    dw8 = dict(x=gs["x"], w=torch.randn(3, 3, 1, 128), b=torch.randn(128))
    return [
        (kernels.channel_moments, kernels.channel_moments_reference, gs, {}),
        (kernels.dwconv_noise_stats, kernels.dwconv_noise_stats_reference, dw, {}),
        (kernels.depthwise_conv2d_same, kernels.depthwise_conv2d_same_reference, dw8, {}),
        (kernels.fused_convnext_mlp_pipelined, kernels.fused_convnext_mlp_reference, m, {}),
        (kernels.fused_convnext_mlp, kernels.fused_convnext_mlp_reference, m, {}),
        (kernels.fused_upsample_blur, kernels.fused_upsample_blur_reference, u,
         {"taps": TAPS[3]}),
        (kernels.flash_attention_nullkv, kernels.flash_attention_nullkv_reference, a, {}),
        (kernels.flash_attention_nonull, kernels.flash_attention_nonull_reference, f, {}),
        (kernels.int8_matmul, lambda **k: kernels.int8_matmul_reference(mode="dynamic", **k),
         i8, {}),
        (kernels.int8_matmul,
         lambda a_s, **k: kernels.int8_matmul_reference(mode="static", a_s=a_s, **k), i8,
         {"a_s": torch.tensor(0.02)}),
        (kernels.int8_matmul_raw,
         lambda xq, wq: kernels.int8_matmul_reference(xq, wq, None, None, "raw"), raw, {}),
    ]


def test_wrappers_take_the_twin_on_cpu_and_count_nothing():
    kernels.reset_launch_counts()
    for wrapper, twin, args, extra in _cpu_calls():
        torch.testing.assert_close(wrapper(**args, **extra), twin(**args, **extra), rtol=0, atol=0)
    a = {k: torch.from_numpy(v).to(torch.bfloat16)[:, :, :, :8].repeat(1, 1, 1, 8).contiguous()
         for k, v in attention_inputs().items() if k in ("q", "k", "v")}
    out, lse = kernels.flash_attention_nonull_reference(**a, return_lse=True)
    dk, dv, delta = kernels.flash_attention_nonull_bwd_dkv(**a, out=out, dout=out, lse=lse)
    dq = kernels.flash_attention_nonull_bwd_dq(**a, dout=out, lse=lse, delta=delta)
    twin = kernels.flash_attention_nonull_bwd_reference(**a, out=out, lse=lse, dout=out)
    for got, want in zip((dq, dk, dv, delta), twin):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert kernels.launch_counts() == {fn.__name__: 0 for fn in kernels.ALL_WRAPPERS}


def test_wrappers_raise_off_cpu_without_a_kernel():
    """A tensor that is neither on the CPU nor on a CUDA device takes the
    kernel path, which refuses it: no silent fallback to the twin."""
    kernels.reset_launch_counts()
    for wrapper, _, args, extra in _cpu_calls():
        meta = {k: v.to("meta") for k, v in args.items()}
        with pytest.raises(ValueError):
            wrapper(**meta, **extra)
    q = torch.empty((1, 256, 2, 64), device="meta")
    lse = torch.empty((1, 2, 256), device="meta")
    with pytest.raises(ValueError):
        kernels.flash_attention_nonull_bwd_dkv(q, q, q, q, q, lse)
    with pytest.raises(ValueError):
        kernels.flash_attention_nonull_bwd_dq(q, q, q, q, lse, lse)
    assert kernels.launch_counts() == {fn.__name__: 0 for fn in kernels.ALL_WRAPPERS}


def test_c_interface_matches_ctypes_signatures():
    """Each extern "C" entry point exists and takes as many arguments as its
    ctypes argtypes declare (a mismatch would corrupt arguments on the card)."""
    src = "".join((_build.CSRC / s).read_text() for s in _build.SOURCES)
    for name, argtypes in _build._SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name
    assert 'extern "C" const char* vfm_error_string(int' in src
    # The backward is one call per mode (pre-pass, dK/dV and dQ) plus its plan.
    assert {"vfm_flash_attention_nullkv_bwd", "vfm_flash_attention_bwd",
            "vfm_flash_bwd_plan"} <= set(_build._SIGNATURES)
    for gone in ("vfm_flash_attention_nullkv_bwd_dkv", "vfm_flash_attention_nullkv_bwd_dq",
                 "vfm_flash_attention_bwd_dkv", "vfm_flash_attention_bwd_dq"):
        assert gone not in src and gone not in _build._SIGNATURES, gone
    assert "flash.cuh" in _build.HEADERS


# ------------------------------------------------------------------ backward


def _grads_close(got, want, frac, names):
    """Each gradient within `frac` of its own scale max|want|."""
    for n, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, n
        np.testing.assert_allclose(g, w, rtol=0, atol=frac * float(np.abs(w).max()), err_msg=n)


MLP_NAMES = ("x", "x_in", "A", "d", "w1", "b1", "w2", "b2", "gamma")


@pytest.mark.parametrize("dtype,bwd_bf16", [("fp32", None), ("bf16", None), ("bf16", "0")])
def test_fused_convnext_mlp_backward_matches_jax(dtype, bwd_bf16, monkeypatch):
    """The port's Function (twin forward + the port of _fused_bwd) against
    jax.vjp of fused_convnext_mlp(interpret=True), whose custom VJP runs
    _fused_bwd; bf16 with the hidden chain stored in bf16 (the default) and
    in fp32 (VFM_VAE_MLP_BWD_BF16=0)."""
    import jax

    if bwd_bf16 is None:
        monkeypatch.delenv("VFM_VAE_MLP_BWD_BF16", raising=False)
    else:
        monkeypatch.setenv("VFM_VAE_MLP_BWD_BF16", bwd_bf16)
    i = mlp_inputs(H=5, W=3)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    gout = np.random.default_rng(9).standard_normal(i["x"].shape).astype(np.float32)
    jargs = [jnp.asarray(i[n], jdt if n in ("x", "x_in") else jnp.float32) for n in MLP_NAMES]
    _, vjp = jax.vjp(lambda *a: j_mlp(*a, interpret=True), *jargs)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(gout, jdt))]
    want[4], want[6] = want[4].T, want[6].T  # w1, w2 gradients in the torch layout
    t = port_mlp_args(i, tdt)
    leaves = [t[n].requires_grad_() for n in MLP_NAMES]
    out = kernels.fused_convnext_mlp(*leaves)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("FusedConvNeXtMLP")
    got = torch.autograd.grad(out, leaves, torch.from_numpy(gout).to(tdt))
    got = [g.float().numpy() for g in got]
    # fp32: the same algorithm summed in another order. bf16: the same
    # rounding points; a value on a rounding boundary may land one bf16 ulp
    # apart, which a reduction over tokens spreads to a few ulps of the scale.
    _grads_close(got, want, 1e-5 if dtype == "fp32" else 4 * 2.0 ** -8, MLP_NAMES)


UPS_NAMES = ("x", "a", "c", "dw", "pw")


@pytest.mark.parametrize("kb", [3, 5])
def test_fused_upsample_blur_backward_matches_jax(kb):
    """FusedUpsampleBlur (twin forward, VJP of the recomputed twin) against
    jax.vjp of fused_upsample_blur(interpret=True): the custom VJP of the
    fused leg plus XLA autodiff of the vertical leg, in fp32."""
    import jax

    i = upsample_inputs(H=3, W=5)
    gout = np.random.default_rng(kb).standard_normal((2, 6, 10, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: j_upsample(*a, TAPS[kb], interpret=True),
                     *(jnp.asarray(i[n]) for n in UPS_NAMES))
    want = [np.asarray(g) for g in vjp(jnp.asarray(gout))]
    want[3], want[4] = want[3].transpose(2, 0, 1), want[4].T  # dw, pw in the torch layout
    t = port_upsample_args(i, torch.float32)
    leaves = [t[n].requires_grad_() for n in UPS_NAMES]
    out = kernels.fused_upsample_blur(*leaves, taps=TAPS[kb])
    assert type(out.grad_fn).__name__.startswith("FusedUpsampleBlur")
    got = [g.numpy() for g in torch.autograd.grad(out, leaves, torch.from_numpy(gout))]
    # Same fp32 function, summed in another order.
    _grads_close(got, want, 1e-5, UPS_NAMES)


ATT_NAMES = ("q", "k", "v", "null_k", "null_v")


@pytest.mark.parametrize("T", [1, 4, 10])
def test_flash_attention_nullkv_backward_matches_jax(T):
    """The backward twin (P from the saved log-sum-exp, D = rowsum(dO O)) and
    the Function built on it, against jax.vjp of dot_product_attention_nullkv,
    in fp32; the backward wrappers take the twin on the CPU and count nothing."""
    import jax

    i = attention_inputs(T=T)
    gout = np.random.default_rng(T).standard_normal(i["q"].shape).astype(np.float32)
    _, vjp = jax.vjp(j_nullkv, *(jnp.asarray(i[n]) for n in ATT_NAMES))
    want = [np.asarray(g) for g in vjp(jnp.asarray(gout))]
    t = [torch.from_numpy(i[n]) for n in ATT_NAMES]
    dout = torch.from_numpy(gout)
    out, lse = kernels.flash_attention_nullkv_reference(*t, return_lse=True)
    assert lse.shape == (2, 2, T) and lse.dtype == torch.float32
    twin = kernels.flash_attention_nullkv_bwd_reference(*t, out, lse, dout)
    # fp32 logits, softmax and products; summation order differs.
    _grads_close(twin[:5], want, 1e-5, ATT_NAMES)
    kernels.reset_launch_counts()
    dk, dv, dnk, dnv, delta = kernels.flash_attention_nullkv_bwd_dkv(*t, out, dout, lse)
    dq = kernels.flash_attention_nullkv_bwd_dq(*t, dout, lse, delta)
    for a, b in zip((dq, dk, dv, dnk, dnv, delta), twin):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert sum(kernels.launch_counts().values()) == 0
    leaves = [x.clone().requires_grad_() for x in t]
    got = torch.autograd.grad(kernels.flash_attention_nullkv(*leaves), leaves, dout)
    _grads_close([g.numpy() for g in got], want, 1e-5, ATT_NAMES)


def test_raw_launches_refuse_tensors_that_require_grad():
    """A kernel's raw launch has no grad_fn: called on inputs that require
    grad outside its autograd.Function it raises, before any device check."""
    from vfm_vae_tpu_torch.ops.kernels import flash_attention, fused_mlp, fused_upsample

    m = port_mlp_args(mlp_inputs(), torch.bfloat16)
    u = port_upsample_args(upsample_inputs(), torch.bfloat16)
    a = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in attention_inputs().items()}
    m["w1"].requires_grad_()
    u["pw"].requires_grad_()
    a["null_k"].requires_grad_()
    with pytest.raises(RuntimeError, match="autograd.Function"):
        fused_mlp._launch(*m.values())
    with pytest.raises(RuntimeError, match="autograd.Function"):
        fused_upsample._launch(*u.values(), TAPS[3])
    with pytest.raises(RuntimeError, match="autograd.Function"):
        flash_attention._launch_forward(*a.values(), 0.25, True)
    with torch.no_grad():  # no graph is recorded: the launch path is taken (and refuses the CPU)
        with pytest.raises(ValueError):
            fused_mlp._launch(*m.values())

"""The port's last kernels on the CPU: K5 (GroupNorm moments), K7/K8
(depthwise conv + statistics, and without), K9's dispatch (K1 pipelined)
and K4's backward, held against the JAX package; and the tokenizer slice
with every opt-in kernel switch of the JAX package set.

On the CPU each wrapper runs its plain twin. K5's twin is held against the
Pallas body in interpret mode (`channel_moments_interpret`, as
tests/test_ops.py runs it) and `channel_moments_reference`; K7's against
`_forward_jnp` (the chain the Pallas kernel is held to), K8's against
lax.conv_general_dilated + bias, the K9 dispatch against `_fused_pipelined`
in interpret mode, K4's backward against jax.vjp of the JAX attention. The
CUDA kernels run only on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from __graft_entry__ import _tiny_g_kwargs
from tests.test_torch_generator import jax_variables_from_port, write_tiny_siglip
from vfm_vae_tpu.models.generator import Generator as JaxGenerator
from vfm_vae_tpu.ops import groupnorm as jgn
from vfm_vae_tpu.ops.attention import dot_product_attention as j_attention
from vfm_vae_tpu.ops.pallas import dwconv_stats as jdw
from vfm_vae_tpu.ops.pallas import group_stats as jgs
from vfm_vae_tpu_torch.entry import kernel_sites
from vfm_vae_tpu_torch.models import convert
from vfm_vae_tpu_torch.models.generator import Generator
from vfm_vae_tpu_torch.ops import groupnorm, kernels
from tests.torch_threads import one_torch_thread  # noqa: F401

SWITCHES = {"VFM_VAE_PALLAS_STATS": "1", "VFM_VAE_MLP_PIPELINE": "1",
            "VFM_VAE_USE_PALLAS_FLASH": "1", "VFM_VAE_ADAPTER_ATTN": "3mm-flash"}


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + shift).astype(np.float32)


# ------------------------------------------------------------------ K5


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_channel_moments_twin_matches_jax(dtype):
    """K5's twin against the Pallas body in interpret mode and the plain
    reference, at tests/test_ops.py's shape; the wrapper takes the twin on
    the CPU and counts nothing."""
    x = _rand((2, 12, 8, 128), 0, 2.0, 0.3)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    kernels.reset_launch_counts()
    s1, s2 = kernels.channel_moments(tx)
    assert kernels.channel_moments.launches == 0
    assert s1.dtype == s2.dtype == torch.float32 and s1.shape == (2, 128)
    for want in (jgs.channel_moments_interpret(jx), jgs.channel_moments_reference(jx)):
        # fp32 sums of the same values in another order (tests/test_ops.py's bounds).
        np.testing.assert_allclose(s1.numpy(), np.asarray(want[0]), atol=2e-3, rtol=2e-5)
        np.testing.assert_allclose(s2.numpy(), np.asarray(want[1]), atol=4e-3, rtol=2e-5)


def test_channel_moments_backward_matches_jax():
    """ChannelMoments' backward (dx = g1 + 2 x g2, fp32, cast to x's dtype)
    against the JAX custom VJP's `_bwd`, in fp32 and bf16."""
    x, g1, g2 = _rand((2, 6, 4, 8), 1), _rand((2, 8), 2), _rand((2, 8), 3)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jx = jnp.asarray(x).astype(jdt)
        (want,) = jgs._bwd(jx, (jnp.asarray(g1), jnp.asarray(g2)))
        tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt).requires_grad_()
        s1, s2 = kernels.channel_moments(tx)
        (got,) = torch.autograd.grad((s1 * torch.from_numpy(g1)).sum()
                                     + (s2 * torch.from_numpy(g2)).sum(), tx)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=1e-6, atol=1e-6)


def test_group_stats_routes_through_k5(monkeypatch):
    """Under VFM_VAE_PALLAS_STATS=1 the port's group_stats takes its sums
    from K5 at an eligible map and agrees with the JAX group_stats; an
    ineligible map (C % 128 != 0) and the unset switch keep the plain sums."""
    calls = []
    real = groupnorm.channel_moments

    def spy(x, *, plain=False):
        calls.append(tuple(x.shape))
        return real(x, plain=plain)

    monkeypatch.setattr(groupnorm, "channel_moments", spy)
    x = jnp.asarray(_rand((2, 32, 32, 128), 4, 1.5, 0.2)).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("VFM_VAE_PALLAS_STATS", raising=False)
        else:
            monkeypatch.setenv("VFM_VAE_PALLAS_STATS", env)
        mean, rstd = groupnorm.group_stats(tx, 32)
        jm, jr = jgn.group_stats(x, 32)
        np.testing.assert_allclose(mean.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rstd.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6)
    assert calls == [(2, 32, 32, 128)]
    groupnorm.group_stats(tx[..., :64], 16)
    groupnorm.group_stats(tx[:, :16, :16], 32)
    assert len(calls) == 1


# ------------------------------------------------------------------ K7, K8


@pytest.mark.parametrize("H,W,k,noise", [(17, 16, 7, True), (17, 16, 7, False),
                                         (8, 8, 5, True), (8, 8, 5, False)])
def test_dwconv_noise_stats_twin_matches_jax(H, W, k, noise):
    """K7's twin against `_forward_jnp` (a ragged 17-row map as
    tests/test_ops.py:279), noise on and off, forward and backward (jax.vjp
    of `_forward_jnp`, the JAX custom VJP's backward)."""
    x, b = _rand((2, H, W, 128), 5), _rand((128,), 6)
    w = _rand((k, k, 128), 7, 0.05)
    nz = _rand((H, W), 8, 0.05)
    jargs = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(nz[None]))
    want, vjp = jax.vjp(lambda *a: jdw._forward_jnp(*a, k, noise), *jargs)
    gt, g1, g2 = _rand((2, H, W, 128), 9), _rand((2, 128), 10), _rand((2, 128), 11)
    wgrads = vjp((jnp.asarray(gt), jnp.asarray(g1), jnp.asarray(g2)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b, nz)]
    got = kernels.dwconv_noise_stats(*leaves[:3], leaves[3] if noise else None)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(e), rtol=1e-5, atol=1e-4)
    grads = torch.autograd.grad(got, leaves if noise else leaves[:3],
                                [torch.from_numpy(g) for g in (gt, g1, g2)])
    for a, e in zip(grads, wgrads):
        e = np.asarray(e).reshape(a.shape)
        np.testing.assert_allclose(a.numpy(), e, rtol=1e-4, atol=1e-4 * float(np.abs(e).max()))


def test_dwconv_noise_stats_bf16_rounds_as_jax():
    """In bf16 the twin rounds where `_forward_jnp` does: the conv once, then
    the bias and the noise each in bf16; the statistics of the rounded t."""
    x = jnp.asarray(_rand((2, 9, 12, 128), 12)).astype(jnp.bfloat16)
    w, b, nz = _rand((5, 5, 128), 13, 0.1), _rand((128,), 14), _rand((9, 12), 15, 0.1)
    jt, j1, j2 = jdw._forward_jnp(x, jnp.asarray(w), jnp.asarray(b), jnp.asarray(nz[None]), 5,
                                  True)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    t, s1, s2 = kernels.dwconv_noise_stats(tx, torch.from_numpy(w), torch.from_numpy(b),
                                           torch.from_numpy(nz))
    assert t.dtype == torch.bfloat16
    ref = np.asarray(jt.astype(jnp.float32))
    # The conv's fp32 sums in another order may land one bf16 ulp apart.
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert float((np.abs(t.float().numpy() - ref) / ulp).max()) <= 1.0
    np.testing.assert_allclose(s1.numpy(), np.asarray(j1), rtol=1e-3, atol=0.5)
    np.testing.assert_allclose(s2.numpy(), np.asarray(j2), rtol=1e-3, atol=0.5)


@pytest.mark.parametrize("k,bias", [(5, True), (7, False)])
def test_depthwise_conv2d_same_twin_matches_jax(k, bias):
    """K8's twin against lax.conv_general_dilated (+ bias), as
    tests/test_ops.py:260 holds the Pallas kernel."""
    x, w, b = _rand((2, 16, 16, 128), 16), _rand((k, k, 1, 128), 17), _rand((128,), 18)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), [(k // 2, k // 2)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=128)
    if bias:
        ref = ref + jnp.asarray(b)
    got = kernels.depthwise_conv2d_same(torch.from_numpy(x), torch.from_numpy(w),
                                        torch.from_numpy(b) if bias else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_dwconv_rules_match_jax(monkeypatch):
    """The eligibility rules, case by case, against JAX's with its TPU test
    passed."""
    from vfm_vae_tpu.ops.pallas import dwconv as jdc
    from vfm_vae_tpu_torch.ops.kernels import dwconv_stats as pdw

    monkeypatch.setattr(jdw.jax, "default_backend", lambda: "tpu")
    for H, C, k in ((2, 128, 5), (1, 128, 5), (8, 64, 7), (8, 256, 7), (16, 128, 3)):
        x = np.zeros((1, H, H, C), np.float32)
        assert pdw.dwconv_stats_eligible(torch.from_numpy(x), k) == \
            jdw.dwconv_stats_eligible(jnp.asarray(x), k)
        for pad, groups in ((k // 2, C), (0, C), (k // 2, 1)):
            assert pdw.pallas_dw_eligible(torch.from_numpy(x), k, 1, pad, groups, C, C) == \
                jdc.pallas_dw_eligible(jnp.asarray(x), k, 1, pad, groups, C, C)


# ------------------------------------------------------------------ K9


def test_pipelined_dispatch_matches_jax_pipelined(monkeypatch):
    """Under VFM_VAE_MLP_PIPELINE=1 the port's fused_convnext_mlp (the twin on
    the CPU) against `_fused_pipelined` in interpret mode at
    tests/test_ops.py:453's tiny shape (a 1 KB tile budget: several row
    tiles per image, the one-step lag, the batch crossing)."""
    from vfm_vae_tpu.models.modulated import demod_coefs
    from vfm_vae_tpu.ops.pallas.fused_mlp import _fused_pipelined

    monkeypatch.setenv("VFM_VAE_MLP_TILE_KB", "1")
    monkeypatch.setenv("VFM_VAE_MLP_PIPELINE", "1")
    B, H, W, C = 3, 4, 4, 8
    x, xi = _rand((B, H, W, C), 19), _rand((B, H, W, C), 20)
    s = 1.0 + 0.1 * _rand((B, C), 21)
    w1, w2 = 0.1 * _rand((C, 4 * C), 22), 0.1 * _rand((4 * C, C), 23)
    b1 = np.broadcast_to(0.1 * _rand((4 * C,), 24), (B, 4 * C)).copy()
    b2, g = 0.1 * _rand((C,), 25), 0.5 + 0.1 * _rand((C,), 26)
    d = np.asarray(demod_coefs(jnp.asarray(w1)[None, None], jnp.asarray(s)))
    want = _fused_pipelined(*(jnp.asarray(a) for a in (x, xi, s, d, w1, b1, w2, b2, g)),
                            interpret=True)
    t = [torch.from_numpy(np.array(a)) for a in (x, xi, s, d, w1.T, b1, w2.T, b2, g)]
    kernels.reset_launch_counts()
    got = kernels.fused_convnext_mlp(*t)
    torch.testing.assert_close(got, kernels.fused_convnext_mlp_pipelined(*t), rtol=0, atol=0)
    assert sum(kernels.launch_counts().values()) == 0
    # The TPU body's tanh-polynomial GELU (|err| <= 7e-6) vs the twin's erf.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


# ------------------------------------------------------------------ K4 backward


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_attention_nonull_backward_matches_jax(dtype):
    """K4's backward twin (P from the forward's log-sum-exp, D = rowsum(dO O))
    and FlashAttentionNoNull against jax.vjp of the JAX attention, Tq != Tk;
    the backward wrappers take the twin on the CPU and count nothing."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    q, k, v = _rand((2, 12, 2, 64), 27), _rand((2, 20, 2, 64), 28), _rand((2, 20, 2, 64), 29)
    gout = _rand((2, 12, 2, 64), 30)
    jin = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    jout, vjp = jax.vjp(j_attention, *jin)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(gout).astype(jdt))]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in jin]
    dout = torch.from_numpy(gout).to(tdt)
    out, lse = kernels.flash_attention_nonull_reference(*t, return_lse=True)
    assert lse.shape == (2, 2, 12) and lse.dtype == torch.float32
    twin = kernels.flash_attention_nonull_bwd_reference(*t, out, lse, dout)
    kernels.reset_launch_counts()
    dk, dv, delta = kernels.flash_attention_nonull_bwd_dkv(*t, out, dout, lse)
    dq = kernels.flash_attention_nonull_bwd_dq(*t, dout, lse, delta)
    for a, b in zip((dq, dk, dv, delta), twin):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    leaves = [x.clone().requires_grad_() for x in t]
    got = torch.autograd.grad(kernels.flash_attention_nonull(*leaves), leaves, dout)
    assert sum(kernels.launch_counts().values()) == 0
    for a, b in zip(got, twin[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # fp32: summation order only. bf16: both packages round the probabilities
    # and the gradients of the logits, at other points: a few bf16 ulps.
    frac = 1e-5 if dtype == "fp32" else 4 * 2.0 ** -8
    for n, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.float().numpy(), w, rtol=0,
                                   atol=frac * float(np.abs(w).max()), err_msg=n)


# ------------------------------------------------------------------ slice


def _stats_kwargs(vfm_dir):
    """__graft_entry__'s tiny geometry with 128-channel synthesis blocks, so
    that the top block's 32 x 32 maps pass K5's rule (C % 128 == 0,
    H * W >= 1024)."""
    kw = _tiny_g_kwargs(vfm_dir)
    kw["synthesis_kwargs"] = dict(kw["synthesis_kwargs"], channel_base=32768, channel_max=128)
    kw["concat_z_mapped_dims"] = [32, 32]  # 128 + 32 channels split into 32 groups
    return kw


def test_slice_with_every_switch_matches_jax(tmp_path, monkeypatch):
    """Encode and decode of a tiny generator with every opt-in kernel switch
    of the JAX package set, against the JAX package under the same switches
    (its kernels do not run on the CPU, so it takes its plain paths):
    moments at 5e-4 and pixels at 2e-3 (tests/test_generator_parity.py).
    K5's dispatch is reached at every statistic kernel_sites predicts (a spy
    counts the calls: on the CPU the wrapper runs its twin and its launch
    counter, by contract, does not move)."""
    for name, val in SWITCHES.items():
        monkeypatch.setenv(name, val)
    kw = _stats_kwargs(write_tiny_siglip(tmp_path / "siglip2-tiny-patch8-32"))
    params, buffers = jax_variables_from_port(kw, seed=3)
    from tests.test_torch_generator import randomize_zero_init

    params = randomize_zero_init(params, seed=4)
    pg = Generator(**kw)
    convert.load_jax_variables(pg, params, buffers, geometry=convert.geometry_from_kwargs(kw))
    jg = JaxGenerator(**kw)
    jv = {"params": params, "buffers": buffers}
    img = np.random.default_rng(31).random((2, 32, 32, 3)).astype(np.float32)
    z = np.random.default_rng(32).standard_normal((2, 4, 4, 8)).astype(np.float32)
    moments = np.asarray(jax.jit(lambda v, x: jg.apply(
        v, x, return_z_before_quantize=True, method=jg.encode))(jv, jnp.asarray(img)))
    pix = np.asarray(jax.jit(lambda v, x: jg.apply(v, x, method=jg.decode))(jv, jnp.asarray(z)))

    calls = []
    real = groupnorm.channel_moments

    def spy(x, *, plain=False):
        calls.append(tuple(x.shape[1:]))
        return real(x, plain=plain)

    monkeypatch.setattr(groupnorm, "channel_moments", spy)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got_m = pg.encode(torch.from_numpy(img), return_z_before_quantize=True)
        got_x = pg.decode(torch.from_numpy(z))
    assert kernels.launch_counts() == {fn.__name__: 0 for fn in kernels.ALL_WRAPPERS}
    np.testing.assert_allclose(got_m.numpy(), moments, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got_x.numpy(), pix, rtol=2e-3, atol=2e-3)
    sites = kernel_sites(pg, 32)
    want = sorted((s["H"], s["H"], s["C"]) for s in sites["channel_moments"]
                  for _ in range(s["count"]))
    assert sorted(calls) == want and len(want) == 4
    assert sites["fused_convnext_mlp"] == [] and len(sites["fused_convnext_mlp_pipelined"]) > 0

"""The port's tensor ops (vfm_vae_tpu_torch.ops) against the JAX package's,
on the CPU, with the same numpy inputs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vfm_vae_tpu.ops import attention as jattn
from vfm_vae_tpu.ops.bias_act import activation_funcs as j_activation_funcs
from vfm_vae_tpu.ops.bias_act import apply_activation as j_apply_activation
from vfm_vae_tpu.ops import groupnorm as jgn
from vfm_vae_tpu.ops import pixelshuffle as jps
from vfm_vae_tpu.ops import resize as jrs
from vfm_vae_tpu_torch.ops import attention as tattn
from vfm_vae_tpu_torch.ops import bias_act as tbias
from vfm_vae_tpu_torch.ops import groupnorm as tgn
from vfm_vae_tpu_torch.ops import pixelshuffle as tps
from vfm_vae_tpu_torch.ops import resize as trs
from tests.torch_threads import one_torch_thread  # noqa: F401


def rng(seed=0):
    return np.random.default_rng(seed)


def as_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def ulp_tol(ref: np.ndarray, ulps: float = 1.0) -> float:
    """`ulps` bf16 ulps (2^-8 relative) of the output scale max|ref|."""
    return ulps * 2.0 ** -8 * float(np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_group_norm_matches_jax(dtype):
    x = rng(1).standard_normal((2, 5, 6, 32)).astype(np.float32) * 3 + 1
    w = rng(2).standard_normal(32).astype(np.float32)
    b = rng(3).standard_normal(32).astype(np.float32)
    if dtype == "fp32":
        ref = jgn.group_norm(jnp.asarray(x), 8, jnp.asarray(w), jnp.asarray(b))
        got = tgn.group_norm(torch.from_numpy(x), 8, torch.from_numpy(w), torch.from_numpy(b))
        # Same two-pass fp32 algorithm; only the summation order differs.
        np.testing.assert_allclose(as_np(got), as_np(ref), rtol=1e-5, atol=1e-5)
    else:
        ref = jgn.group_norm(jnp.asarray(x, jnp.bfloat16), 8, jnp.asarray(w), jnp.asarray(b))
        got = tgn.group_norm(torch.from_numpy(x).bfloat16(), 8, torch.from_numpy(w),
                             torch.from_numpy(b))
        assert got.dtype == torch.bfloat16
        # bf16 elementwise apply: a one-ulp flip of the output is allowed.
        np.testing.assert_allclose(as_np(got), as_np(ref), rtol=0, atol=ulp_tol(as_np(ref)))


def test_group_stats_matches_jax():
    x = rng(4).standard_normal((3, 4, 4, 64)).astype(np.float32)
    m_ref, r_ref = jgn.group_stats(jnp.asarray(x), 16)
    m, r = tgn.group_stats(torch.from_numpy(x), 16)
    # One-pass fp32 moments; summation order differs.
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layer_norm_matches_jax(dtype):
    x = rng(5).standard_normal((2, 7, 48)).astype(np.float32) * 2
    w = rng(6).standard_normal(48).astype(np.float32)
    b = rng(7).standard_normal(48).astype(np.float32)
    jx = jnp.asarray(x) if dtype == "fp32" else jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x) if dtype == "fp32" else torch.from_numpy(x).bfloat16()
    ref = as_np(jgn.layer_norm(jx, jnp.asarray(w), jnp.asarray(b), eps=1e-6))
    got = as_np(tgn.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b), eps=1e-6))
    if dtype == "fp32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)  # fp32 summation order
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=ulp_tol(ref))  # one bf16 ulp


@pytest.mark.parametrize("r", [2, 4])
def test_pixel_shuffle_and_unshuffle_match_jax(r):
    x = rng(8).standard_normal((2, 8, 8, 3 * r * r)).astype(np.float32)
    np.testing.assert_array_equal(tps.pixel_shuffle(torch.from_numpy(x), r).numpy(),
                                  np.asarray(jps.pixel_shuffle(jnp.asarray(x), r)))
    y = rng(9).standard_normal((2, 4 * r, 4 * r, 5)).astype(np.float32)
    np.testing.assert_array_equal(tps.pixel_unshuffle(torch.from_numpy(y), r).numpy(),
                                  np.asarray(jps.pixel_unshuffle(jnp.asarray(y), r)))


@pytest.mark.parametrize("kind,antialias", [("linear", False), ("linear", True),
                                            ("cubic", False), ("cubic", True)])
def test_resize_matrix_identical(kind, antialias):
    for n_in, n_out in ((16, 32), (32, 16), (7, 12)):
        np.testing.assert_array_equal(trs.resize_matrix(n_in, n_out, kind, antialias),
                                      jrs.resize_matrix(n_in, n_out, kind, antialias))


@pytest.mark.parametrize("kwargs", [dict(scale_factor=2.0), dict(size=(6, 10)),
                                    dict(scale_factor=0.5, antialias=True)])
def test_resize_bilinear_matches_jax(kwargs):
    x = rng(10).random((2, 8, 8, 3)).astype(np.float32)
    ref = np.asarray(jrs.resize_bilinear(jnp.asarray(x), **kwargs))
    got = trs.resize_bilinear(torch.from_numpy(x), **kwargs).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)  # fp32 matrix products


@pytest.mark.parametrize("out", [1, (3, 2)])
def test_adaptive_avg_pool2d_matches_jax(out):
    x = rng(11).standard_normal((2, 7, 6, 4)).astype(np.float32)
    ref = np.asarray(jrs.adaptive_avg_pool2d(jnp.asarray(x), out))
    got = trs.adaptive_avg_pool2d(torch.from_numpy(x), out).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)  # fp32 matrix products


@pytest.mark.parametrize("act", ["linear", "lrelu", "gelu", "gelu_tanh"])
def test_apply_activation_matches_jax(act):
    x = rng(12).standard_normal((64,)).astype(np.float32) * 3
    ref = np.asarray(j_apply_activation(jnp.asarray(x), act))
    got = tbias.apply_activation(torch.from_numpy(x), act).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)  # fp32 transcendental impls
    assert tbias.activation_funcs[act].def_gain == j_activation_funcs[act].def_gain


def test_dot_product_attention_matches_jax():
    r = rng(13)
    q, k, v = (r.standard_normal((2, 9, 4, 16)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)  # fp32 softmax attention


def test_dot_product_attention_nullkv_matches_jax():
    r = rng(14)
    q, k, v = (r.standard_normal((2, 12, 4, 16)).astype(np.float32) for _ in range(3))
    nk, nv = (r.standard_normal((2, 1, 4, 16)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jattn.dot_product_attention_nullkv(*map(jnp.asarray, (q, k, v, nk, nv))))
    got = tattn.dot_product_attention_nullkv(*map(torch.from_numpy, (q, k, v, nk, nv))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)  # fp32 softmax attention

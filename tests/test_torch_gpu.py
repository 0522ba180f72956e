"""The port's CUDA kernels on the card (marker `gpu`; they skip without a
CUDA device). This file imports neither jax nor the JAX package, so it also
runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import pytest
import torch

from vfm_vae_tpu_torch.ops import kernels

TAPS5 = [1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _cases(dev, H=8, W=8, T=64):
    """One call per kernel; H, W, T off the flagship grid exercise the
    kernels' ragged-edge masking (token tiles, column bands, key tiles)."""
    g = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*s, dt=bf, scale=1.0):
        return (torch.randn(s, generator=g, device=dev) * scale).to(dt)

    C, Ci, Co = 128, 256, 128
    return [
        (kernels.fused_convnext_mlp, dict(
            x=rn(2, H, W, C), x_in=rn(2, H, W, C), A=rn(2, C, dt=f32).abs() + 0.5,
            d=rn(2, 4 * C, dt=f32).abs() + 0.5, w1=rn(4 * C, C, scale=C ** -0.5),
            b1=rn(2, 4 * C, dt=f32), w2=rn(C, 4 * C, scale=(4 * C) ** -0.5),
            b2=rn(C, dt=f32), gamma=rn(C, dt=f32))),
        (kernels.fused_upsample_blur, dict(
            x=rn(2, H, W, Ci), a=rn(2, Ci, dt=f32).abs() + 0.5, c=rn(2, Ci, dt=f32),
            dw=rn(Ci, 3, 3, dt=f32, scale=1 / 3), pw=rn(4 * Co, Ci, scale=Ci ** -0.5),
            taps=TAPS5)),
        (kernels.flash_attention_nullkv, dict(
            q=rn(2, T, 8, 64), k=rn(2, T, 8, 64), v=rn(2, T, 8, 64),
            null_k=rn(2, 1, 8, 64), null_v=rn(2, 1, 8, 64))),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,T", [(8, 8, 64), (5, 70, 100), (1, 3, 1)])
def test_kernels_match_twins_on_gpu(cuda, H, W, T):
    for fn, args in _cases(cuda, H, W, T):
        before = fn.launches
        got, ref = fn(**args), fn(**args, plain=True)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, fn.__name__
        scale = float(ref.float().abs().max())
        # Same bf16 rounding points summed in another order: a few output ulps.
        assert float((got.float() - ref.float()).abs().max()) <= 4 * 2.0 ** -8 * scale, fn.__name__
        if fn is kernels.fused_upsample_blur:  # no float atomics: the same bits again
            assert torch.equal(fn(**args), got)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    """On a CUDA tensor a wrapper launches its kernel or raises: fp32
    activations and non-contiguous inputs are refused, never sent to the twin."""
    for fn, args in _cases(cuda):
        before = fn.launches
        first = next(iter(args))
        with pytest.raises(ValueError):
            fn(**dict(args, **{first: args[first].float()}))
        with pytest.raises(ValueError):
            fn(**dict(args, **{first: args[first].transpose(1, 2).contiguous().transpose(1, 2)}))
        assert fn.launches == before, fn.__name__


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 36, 100, 577])
def test_k3_backward_matches_twin_on_gpu(cuda, T):
    """dQ, dK, dV and the per-sample null-token gradients of the backward
    kernels against their plain twin, from the training forward's output
    and log-sum-exp; T off the 64-row tiles exercises the masked edges."""
    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(T)
    q, k, v, dout = (torch.randn(2, T, 8, 64, generator=g, device=cuda).to(torch.bfloat16)
                     for _ in range(4))
    nk, nv = (torch.randn(2, 1, 8, 64, generator=g, device=cuda).to(torch.bfloat16)
              for _ in range(2))
    out, lse = fa._launch_forward(q, k, v, nk, nv, 0.125, True)
    ref_out, ref_lse = kernels.flash_attention_nullkv_reference(q, k, v, nk, nv, return_lse=True)
    before = [fn.launches for fn in kernels.BACKWARD_WRAPPERS]
    dk, dv, dnk, dnv, delta = kernels.flash_attention_nullkv_bwd_dkv(q, k, v, nk, nv, out, dout,
                                                                      lse)
    dq = kernels.flash_attention_nullkv_bwd_dq(q, k, v, nk, nv, dout, lse, delta)
    twin = kernels.flash_attention_nullkv_bwd_reference(q, k, v, nk, nv, out, lse, dout)
    torch.cuda.synchronize()
    assert [fn.launches for fn in kernels.BACKWARD_WRAPPERS] == [b + 1 for b in before]
    # fp32 log-sum-exp of the same logits, summed in another order.
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * float(ref_lse.abs().max()) + 1e-5
    for got, ref in zip((dq, dk, dv, dnk, dnv, delta), twin):
        scale = float(ref.float().abs().max())
        # P and dS rounded to bf16 at the same points, summed in another order.
        assert float((got.float() - ref.float()).abs().max()) <= 4 * 2.0 ** -8 * scale


@pytest.mark.gpu
def test_functions_differentiate_through_the_kernels_on_gpu(cuda):
    """With inputs that require grad, each wrapper runs its autograd
    Function: the kernel forward (one launch) and a backward whose gradients
    match the plain Function's; the raw launch refuses such inputs."""
    from vfm_vae_tpu_torch.ops.kernels import fused_mlp

    for fn, args in _cases(cuda, 5, 7, 37):
        tensors = {k: v for k, v in args.items() if torch.is_tensor(v)}
        extra = {k: v for k, v in args.items() if not torch.is_tensor(v)}
        grads = []
        for plain in (False, True):
            leaves = {k: v.detach().requires_grad_() for k, v in tensors.items()}
            before = fn.launches
            out = fn(**leaves, **extra, plain=plain)
            assert out.grad_fn is not None, fn.__name__
            gout = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(1),
                               device=cuda).to(out.dtype)
            grads.append(torch.autograd.grad(out, list(leaves.values()), gout))
            assert fn.launches == before + (0 if plain else 1), fn.__name__
        for name, a, b in zip(tensors, *grads):
            scale = float(b.float().abs().max())
            assert float((a.float() - b.float()).abs().max()) <= 4 * 2.0 ** -8 * scale, (
                fn.__name__, name)
    args = _cases(cuda)[0][1]
    with pytest.raises(RuntimeError, match="autograd.Function"):
        fused_mlp._launch(*(v.detach().requires_grad_() for v in args.values()))


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(2048, 1024, 1024), (77, 4096, 1024), (300, 96, 136)])
def test_int8_matmul_matches_twin_on_gpu(cuda, M, K, N):
    """K6 (dynamic and static) and K10 against their twins, bit for bit: the
    same quantize, exact int32 sums and the same epilogue order. Shapes off
    the tiles exercise the ragged rows, columns and K stages."""
    g = torch.Generator(device=cuda).manual_seed(M)
    x = (torch.randn(M, K, generator=g, device=cuda) * 2).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (N, K), generator=g, device=cuda, dtype=torch.int8)
    ws = torch.rand(N, generator=g, device=cuda) * 1e-2 + 1e-4
    b = torch.randn(N, generator=g, device=cuda)
    a_s = x.float().abs().amax() / 127 * 0.5  # clips the top half of the range
    before = kernels.int8_matmul.launches
    for args in ((x, wq, ws, b), (x, wq, ws, None), (x, wq, ws, b, a_s)):
        got, ref = kernels.int8_matmul(*args), kernels.int8_matmul(*args, plain=True)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), len(args)
    assert kernels.int8_matmul.launches == before + 3
    xq = torch.randint(-127, 128, (M, K), generator=g, device=cuda, dtype=torch.int8)
    assert torch.equal(kernels.int8_matmul_raw(xq, wq), kernels.int8_matmul_raw(xq, wq, plain=True))


def _int8_inputs(dev, M, K, N, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(M, K, generator=g, device=dev) * 2).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (N, K), generator=g, device=dev, dtype=torch.int8)
    ws = torch.rand(N, generator=g, device=dev) * 1e-2 + 1e-4
    b = torch.randn(N, generator=g, device=dev)
    a_s = x.float().abs().amax() / 127 * 0.5  # clips the top half of the range
    xq = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
    return x, wq, ws, b, a_s, xq


@pytest.mark.gpu
@pytest.mark.parametrize("B", [4, 32])
@pytest.mark.parametrize("K,N", [(1024, 1024), (1024, 4096), (4096, 1024)])
def test_int8_matmul_is_bit_exact_at_served_shapes_on_gpu(cuda, B, K, N):
    """K6 (dynamic, static) and K10 at the tower's Linear shapes of a
    serving request (B=4, 128 x 128 tiles) and of the prefetch batch (B=32,
    128 x 256 tiles): bit for bit against their twins, and again on repeat."""
    x, wq, ws, b, a_s, xq = _int8_inputs(cuda, 1024 * B, K, N, K + N + B)
    for args in ((x, wq, ws, b), (x, wq, ws, b, a_s)):
        got = kernels.int8_matmul(*args)
        again = kernels.int8_matmul(*args)
        ref = kernels.int8_matmul(*args, plain=True)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), len(args)
        assert torch.equal(got, again), len(args)
    got, again = kernels.int8_matmul_raw(xq, wq), kernels.int8_matmul_raw(xq, wq)
    assert torch.equal(got, kernels.int8_matmul_raw(xq, wq, plain=True))
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(2048, 1024, 1024), (4096, 1024, 1024), (32768, 1024, 1024),
                                   (32768, 4096, 1024), (2048, 1024, 4096), (77, 4096, 1024),
                                   (300, 96, 136)])
def test_int8_plan_mirror_matches_the_c_export_on_gpu(cuda, M, K, N):
    """ops/kernels/int8_matmul.plan against vfm_int8_matmul_plan, for the
    card's SM count and for 132, in every mode."""
    import ctypes
    import importlib

    from vfm_vae_tpu_torch.ops.kernels._build import library

    mod = importlib.import_module("vfm_vae_tpu_torch.ops.kernels.int8_matmul")
    lib = library().lib
    for sms in (torch.cuda.get_device_properties(cuda).multi_processor_count, 132):
        for mode, code in mod.MODES.items():
            buf = (ctypes.c_int * len(mod.PLAN_KEYS))()
            assert lib.vfm_int8_matmul_plan(M, N, K, code, sms, buf) == 0
            want = mod.plan(M, N, K, mode, sms)
            assert list(buf) == [int(want[k]) for k in mod.PLAN_KEYS], (mode, sms)


@pytest.mark.gpu
def test_int8_matmul_refuses_what_it_does_not_take_on_gpu(cuda):
    """K % 32 != 0 and N % 8 != 0 raise before any launch, through the
    wrappers and at the C entry point."""
    from vfm_vae_tpu_torch.ops.kernels._build import library

    x, wq, ws, b, _, xq = _int8_inputs(cuda, 64, 96, 64, 3)
    before = (kernels.int8_matmul.launches, kernels.int8_matmul_raw.launches)
    with pytest.raises(ValueError):
        kernels.int8_matmul(x[:, :80].contiguous(), wq[:, :80].contiguous(), ws, b)
    with pytest.raises(ValueError):
        kernels.int8_matmul(x, wq[:60].contiguous(), ws[:60].contiguous(), b[:60].contiguous())
    with pytest.raises(ValueError):
        kernels.int8_matmul_raw(xq[:, :80].contiguous(), wq[:, :80].contiguous())
    with pytest.raises(ValueError):
        kernels.int8_matmul_raw(xq, wq[:60].contiguous())
    assert (kernels.int8_matmul.launches, kernels.int8_matmul_raw.launches) == before
    lib = library()
    out = torch.empty(64, 64, dtype=torch.int8, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for M, N, K in ((64, 64, 80), (64, 60, 96)):
        err = lib.lib.vfm_int8_matmul(xq.data_ptr(), wq.data_ptr(), None, None, None,
                                      out.data_ptr(), M, N, K, 2, stream)
        assert err != 0
        with pytest.raises(RuntimeError):
            lib.check(err, "int8_matmul")


@pytest.mark.gpu
def test_int8_matmul_rounds_ties_to_even_on_gpu(cuda):
    """Rows with absmax 127 (scale 1) and entries on .5: with an identity
    weight and unit scales the output is the quantized row, half to even."""
    K = 256
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randint(-126, 126, (64, K), generator=g, device=cuda).float() + 0.5
    x[:, 0] = 127.0
    eye = torch.eye(K, device=cuda).to(torch.int8)
    ones = torch.ones(K, device=cuda)
    got = kernels.int8_matmul(x.to(torch.bfloat16), eye, ones)
    torch.cuda.synchronize()
    assert torch.equal(got.float(), torch.round(x))  # torch.round: half to even


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D,Tq,Tk", [("bf16", 64, 1024, 1024), ("bf16", 128, 256, 384),
                                           ("fp32", 64, 256, 256), ("bf16", 64, 100, 37)])
def test_flash_attention_nonull_matches_twin_on_gpu(cuda, dtype, D, Tq, Tk):
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    g = torch.Generator(device=cuda).manual_seed(D + Tq)
    q = torch.randn(2, Tq, 4, D, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(2, Tk, 4, D, generator=g, device=cuda).to(dt) for _ in range(2))
    before = kernels.flash_attention_nonull.launches
    got = kernels.flash_attention_nonull(q, k, v)
    ref = kernels.flash_attention_nonull(q, k, v, plain=True)
    torch.cuda.synchronize()
    assert kernels.flash_attention_nonull.launches == before + 1
    scale = float(ref.float().abs().max())
    # bf16: probabilities rounded at other points (K3's bound); fp32: summation order.
    tol = 4 * 2.0 ** -8 * scale if dt == torch.bfloat16 else 1e-5 * scale
    assert float((got.float() - ref.float()).abs().max()) <= tol


def _bf16_ulps(got, ref) -> float:
    """max |got - ref| in bf16 ulps of the twin's value."""
    r = ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r)[1] - 8)
    return float(((got.float() - ref.float()).abs() / ulp).max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [((2, 33, 31, 128), "bf16"), ((3, 64, 64, 256), "fp32"),
                                         ((1, 5, 7, 8), "bf16")])
def test_channel_moments_match_fp64_and_repeat_on_gpu(cuda, shape, dtype):
    """K5 against fp64 sums (s2 within 1e-5 relative, s1 within 1e-5 of
    sum |x|) and its twin; two launches on one input agree bit for bit; a
    call is one kernel on the card (the profiler's count), once the
    stream's workspace exists."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    g = torch.Generator(device=cuda).manual_seed(shape[1])
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dt)
    kernels.channel_moments(x)
    torch.cuda.synchronize()
    before = kernels.channel_moments.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s1, s2 = kernels.channel_moments(x)
        r1, r2 = kernels.channel_moments(x)
        torch.cuda.synchronize()
    assert kernels.channel_moments.launches == before + 2
    ran = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and e.self_device_time_total}
    assert sum(ran.values()) == 2 and all("channel_moments_kernel" in k for k in ran), ran
    assert torch.equal(s1, r1) and torch.equal(s2, r2)
    xd = x.double()
    e1, e2, a1 = xd.sum((1, 2)), xd.square().sum((1, 2)), xd.abs().sum((1, 2))
    assert float(((s1.double() - e1).abs() / a1).max()) <= 1e-5
    assert float(((s2.double() - e2).abs() / e2).max()) <= 1e-5
    t1, t2 = kernels.channel_moments(x, plain=True)
    assert float(((t2.double() - e2).abs() / e2).max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,C,k", [(17, 16, 128, 7), (8, 8, 512, 5), (2, 2, 512, 5),
                                     (33, 40, 256, 7)])
def test_dwconv_kernels_match_twins_on_gpu(cuda, H, W, C, k):
    """K7 (noise on and off) and K8 against their twins: t within one bf16
    ulp (the taps summed in another order, the same rounding points); K7's
    statistics against fp64 sums of its own t, at K5's bounds."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the twins' fp32 conv in full fp32
    try:
        g = torch.Generator(device=cuda).manual_seed(H * W + k)
        x = torch.randn(2, H, W, C, generator=g, device=cuda).to(torch.bfloat16)
        w = torch.randn(k, k, C, generator=g, device=cuda) / k
        b = torch.randn(C, generator=g, device=cuda)
        noise = torch.randn(H, W, generator=g, device=cuda) * 0.3
        for nz in (noise, None):
            before = kernels.dwconv_noise_stats.launches
            t, s1, s2 = kernels.dwconv_noise_stats(x, w, b, nz)
            rt, _, _ = kernels.dwconv_noise_stats(x, w, b, nz, plain=True)
            torch.cuda.synchronize()
            assert kernels.dwconv_noise_stats.launches == before + 1
            assert _bf16_ulps(t, rt) <= 1.0
            td = t.double()
            e1, e2 = td.sum((1, 2)), td.square().sum((1, 2))
            assert float(((s1.double() - e1).abs() / td.abs().sum((1, 2))).max()) <= 1e-5
            assert float(((s2.double() - e2).abs() / e2).max()) <= 1e-5
        w8 = w[:, :, None, :].contiguous()
        for bias in (b, None):
            got = kernels.depthwise_conv2d_same(x, w8, bias)
            ref = kernels.depthwise_conv2d_same(x, w8, bias, plain=True)
            torch.cuda.synchronize()
            assert _bf16_ulps(got, ref) <= 1.0
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _mlp_args(dev, C, H, W, B=2):
    g = torch.Generator(device=dev).manual_seed(C + H)
    bf, f32 = torch.bfloat16, torch.float32
    rn = lambda *s, dt=bf, scale=1.0: (torch.randn(s, generator=g, device=dev)  # noqa: E731
                                       * scale).to(dt)
    return dict(x=rn(B, H, W, C), x_in=rn(B, H, W, C), A=rn(B, C, dt=f32).abs() + 0.5,
                d=rn(B, 4 * C, dt=f32).abs() + 0.5, w1=rn(4 * C, C, scale=C ** -0.5),
                b1=rn(B, 4 * C, dt=f32), w2=rn(C, 4 * C, scale=(4 * C) ** -0.5),
                b2=rn(C, dt=f32), gamma=rn(C, dt=f32))


@pytest.mark.gpu
@pytest.mark.parametrize("C,H,W", [(128, 5, 70), (256, 9, 9), (512, 8, 8), (512, 3, 2),
                                   (256, 16, 16)])
def test_pipelined_mlp_is_bit_exact_with_k1_on_gpu(cuda, C, H, W):
    """K9 against K1 on the same inputs: 0 ulps (the same plan and the same
    products into every accumulator); off-grid H x W exercises the ragged
    token tile, and every shape here splits the hidden across a cluster."""
    args = dict(_cases(cuda, H, W)[0][1]) if C == 128 else _mlp_args(cuda, C, H, W)
    before = kernels.fused_convnext_mlp_pipelined.launches
    got = kernels.fused_convnext_mlp_pipelined(**args)
    ref = kernels.fused_convnext_mlp(**args)
    torch.cuda.synchronize()
    assert kernels.fused_convnext_mlp_pipelined.launches == before + 1
    assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("C,H,W", [(512, 8, 8), (512, 64, 64), (128, 5, 70), (256, 128, 128)])
def test_mlp_is_bit_identical_on_repeat_on_gpu(cuda, C, H, W):
    """K1 and K9 twice on the same inputs give the same bits: the split
    shapes (C=512 at 8 x 8, C=128 at 5 x 70) sum their cluster's partials in
    rank order, the unsplit ones (64 x 64, 128 x 128) do not split."""
    from vfm_vae_tpu_torch.ops.kernels import fused_mlp

    args = _mlp_args(cuda, C, H, W)
    split = fused_mlp.plan(2, H * W, C, sms=torch.cuda.get_device_properties(cuda)
                           .multi_processor_count)["split"]
    assert (split > 1) == (H * W <= 350), split
    for fn in (kernels.fused_convnext_mlp, kernels.fused_convnext_mlp_pipelined):
        first, second = fn(**args), fn(**args)
        torch.cuda.synchronize()
        assert torch.equal(first, second), fn.__name__


@pytest.mark.gpu
@pytest.mark.parametrize("B,HW,C", [(2, 64, 512), (2, 256, 512), (2, 1024, 512), (2, 4096, 512),
                                    (2, 16384, 256), (2, 65536, 128), (32, 64, 512),
                                    (32, 65536, 128), (2, 350, 128), (2, 6, 512), (1, 3, 128)])
def test_mlp_plan_mirror_matches_the_c_export_on_gpu(cuda, B, HW, C):
    """ops/kernels/fused_mlp.plan against vfm_fused_mlp_plan, for the card's
    SM count and for 132, K1 and K9."""
    import ctypes

    from vfm_vae_tpu_torch.ops.kernels import fused_mlp
    from vfm_vae_tpu_torch.ops.kernels._build import library

    lib = library().lib
    for sms in (torch.cuda.get_device_properties(cuda).multi_processor_count, 132):
        for pipelined in (0, 1):
            buf = (ctypes.c_int * len(fused_mlp.PLAN_KEYS))()
            assert lib.vfm_fused_mlp_plan(B, HW, C, pipelined, sms, buf) == 0
            want = fused_mlp.plan(B, HW, C, bool(pipelined), sms)
            assert list(buf) == [int(want[k]) for k in fused_mlp.PLAN_KEYS], (sms, pipelined)
    buf = (ctypes.c_int * len(fused_mlp.PLAN_KEYS))()
    assert lib.vfm_fused_mlp_plan(B, HW, 384, 0, 132, buf) != 0


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,Ci,Co,kb", [(1, 5, 7, 1088, 32, 3), (1, 9, 9, 1024, 64, 1),
                                           (2, 3, 40, 544, 32, 3), (1, 7, 5, 96, 96, 5),
                                           (2, 20, 19, 32, 32, 3), (3, 2, 2, 512, 512, 3)])
def test_upsample_matches_twin_off_the_flagship_on_gpu(cuda, B, H, W, Ci, Co, kb):
    """K2 against its twin where the plan takes its other routes: A in
    chunks of 1024 channels recomputed per N tile (Ci > 1024), 64 GEMM rows
    (Ci > 512), half a 64-channel k block (Ci % 64 == 32), several tiles
    with ragged edges, an N walk split over many CTAs; one launch a call,
    the same bits on repeat."""
    g = torch.Generator(device=cuda).manual_seed(H * W)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*s, dt=bf, scale=1.0):
        return (torch.randn(s, generator=g, device=cuda) * scale).to(dt)

    taps = {1: [1.0], 3: [0.25, 0.5, 0.25], 5: TAPS5}[kb]
    args = dict(x=rn(B, H, W, Ci), a=rn(B, Ci, dt=f32).abs() + 0.5, c=rn(B, Ci, dt=f32),
                dw=rn(Ci, 3, 3, dt=f32, scale=1 / 3), pw=rn(4 * Co, Ci, scale=Ci ** -0.5),
                taps=taps)
    fn = kernels.fused_upsample_blur
    before = fn.launches
    got, again = fn(**args), fn(**args)
    ref = fn(**args, plain=True)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(got, again)
    scale = float(ref.float().abs().max())
    assert float((got.float() - ref.float()).abs().max()) <= 4 * 2.0 ** -8 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,Ci,Co,kb", [
    (2, 8, 8, 768, 512, 3), (32, 32, 32, 640, 512, 5), (1, 5, 7, 1088, 32, 3),
    (2, 8, 8, 512, 512, 3), (32, 16, 16, 512, 512, 3), (2, 32, 32, 512, 512, 5),
    (32, 64, 64, 512, 256, 5), (2, 128, 128, 256, 128, 5), (4, 2, 2, 512, 512, 3),
    (4, 6, 6, 512, 512, 3), (4, 24, 24, 512, 512, 5), (4, 96, 96, 256, 128, 5),
    (2, 5, 70, 256, 128, 5), (2, 1, 3, 256, 128, 5), (1, 9, 9, 1024, 64, 1)])
def test_upsample_plan_mirror_matches_the_c_export_on_gpu(cuda, B, H, W, Ci, Co, kb):
    """ops/kernels/fused_upsample.plan against vfm_fused_upsample_plan at the
    flagship, EQ and ragged K2 sites (and A chunked over Ci > 1024), for the
    card's SM count and for 132."""
    import ctypes

    from vfm_vae_tpu_torch.ops.kernels import fused_upsample
    from vfm_vae_tpu_torch.ops.kernels._build import library

    lib = library().lib
    for sms in (torch.cuda.get_device_properties(cuda).multi_processor_count, 132):
        buf = (ctypes.c_int * len(fused_upsample.PLAN_KEYS))()
        assert lib.vfm_fused_upsample_plan(B, H, W, Ci, Co, kb, sms, buf) == 0
        want = fused_upsample.plan(B, H, W, Ci, Co, kb, sms)
        assert list(buf) == [int(want[k]) for k in fused_upsample.PLAN_KEYS], sms
    buf = (ctypes.c_int * len(fused_upsample.PLAN_KEYS))()
    assert lib.vfm_fused_upsample_plan(B, H, W, Ci, Co, 4, 132, buf) != 0
    assert lib.vfm_fused_upsample_plan(B, H, W, 48, Co, kb, 132, buf) != 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D,Tq,Tk", [("bf16", 64, 256, 256), ("bf16", 128, 100, 37),
                                           ("fp32", 64, 1024, 1024), ("fp32", 64, 77, 130),
                                           ("fp32", 128, 64, 64)])
def test_k4_backward_matches_twin_on_gpu(cuda, dtype, D, Tq, Tk):
    """K4's forward log-sum-exp and its dQ, dK, dV kernels against the twin
    (bf16: P and dS rounded at the same points, a few ulps of scale; fp32:
    summation order and exp2, 1e-5 of scale), and FlashAttentionNoNull
    launching all three kernels."""
    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa

    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    g = torch.Generator(device=cuda).manual_seed(D + Tq + Tk)
    q, dout = (torch.randn(2, Tq, 4, D, generator=g, device=cuda).to(dt) for _ in range(2))
    k, v = (torch.randn(2, Tk, 4, D, generator=g, device=cuda).to(dt) for _ in range(2))
    out, lse = fa._launch_nonull(q, k, v, D ** -0.5, True)
    _, ref_lse = kernels.flash_attention_nonull_reference(q, k, v, return_lse=True)
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * float(ref_lse.abs().max()) + 1e-5
    before = [fn.launches for fn in kernels.NONULL_BACKWARD_WRAPPERS]
    dk, dv, delta = kernels.flash_attention_nonull_bwd_dkv(q, k, v, out, dout, lse)
    dq = kernels.flash_attention_nonull_bwd_dq(q, k, v, dout, lse, delta)
    twin = kernels.flash_attention_nonull_bwd_reference(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert [fn.launches for fn in kernels.NONULL_BACKWARD_WRAPPERS] == [b + 1 for b in before]
    frac = 4 * 2.0 ** -8 if dt == torch.bfloat16 else 1e-5
    for got, ref in zip((dq, dk, dv, delta), twin):
        assert float((got.float() - ref.float()).abs().max()) <= frac * float(
            ref.float().abs().max())
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    n0 = kernels.flash_attention_nonull.launches
    grads = torch.autograd.grad(kernels.flash_attention_nonull(*leaves), leaves, dout)
    torch.cuda.synchronize()
    assert kernels.flash_attention_nonull.launches == n0 + 1
    assert [fn.launches for fn in kernels.NONULL_BACKWARD_WRAPPERS] == [b + 2 for b in before]
    for got, ref in zip(grads, (dq, dk, dv)):
        assert torch.equal(got, ref)


def _errors(got, ref):
    """(max |got - ref| / max |ref|, mean |got - ref| / mean |ref|)."""
    d = (got.float() - ref.float()).abs()
    return (float(d.max()) / float(ref.float().abs().max()),
            float(d.mean()) / float(ref.float().abs().mean()))


# (B, Tq, Tk, N, D, null): K3 at every flagship and EQ-bucket T; K4 with
# Tq != Tk, d = 64 and 128; grids below the SM count (B * N * tiles < 132);
# B = 1 and 3; and the B = 32 grids of the offline batch.
FORWARD_CASES = (
    [(2, T, T, 8, 64, True) for T in (4, 16, 36, 64, 144, 256, 576, 1024)]
    + [(2, 1024, 1024, 16, 64, False), (2, 300, 1000, 4, 64, False),
       (2, 1024, 77, 8, 128, False), (2, 129, 640, 8, 128, False),
       (1, 1024, 1024, 2, 64, True), (3, 200, 200, 8, 64, True),
       (1, 64, 64, 1, 128, False), (3, 1024, 1024, 16, 128, False),
       (32, 1024, 1024, 16, 64, False)])


@pytest.mark.gpu
@pytest.mark.parametrize("B,Tq,Tk,N,D,null", FORWARD_CASES)
def test_flash_forward_matches_twin_on_gpu(cuda, B, Tq, Tk, N, D, null):
    """The bf16 forward (K3 with the null token, K4 without) against its
    twin within K3's bounds (max 2e-2, mean 4e-3 of scale: P rounded to
    bf16 unnormalised in the kernel, normalised in the twin), against fp32
    within 1.5x the twin's error, and its log-sum-exp against the twin's
    logsumexp; one launch per call, with and without the log-sum-exp."""
    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(B * Tq + Tk + D)
    bf = torch.bfloat16
    q = torch.randn(B, Tq, N, D, generator=g, device=cuda).to(bf)
    k, v = (torch.randn(B, Tk, N, D, generator=g, device=cuda).to(bf) for _ in range(2))
    nk, nv = (torch.randn(B, 1, N, D, generator=g, device=cuda).to(bf) for _ in range(2))
    scale = D ** -0.5
    if null:
        wrapper = kernels.flash_attention_nullkv
        call = lambda lse: fa._launch_forward(q, k, v, nk, nv, scale, lse)  # noqa: E731
        ref, ref_lse = kernels.flash_attention_nullkv_reference(q, k, v, nk, nv, scale, True)
        truth = kernels.flash_attention_nullkv_reference(
            q.float(), k.float(), v.float(), nk.float(), nv.float(), scale)
    else:
        wrapper = kernels.flash_attention_nonull
        call = lambda lse: fa._launch_nonull(q, k, v, scale, lse)  # noqa: E731
        ref, ref_lse = kernels.flash_attention_nonull_reference(q, k, v, scale, True)
        truth = kernels.flash_attention_nonull_reference(q.float(), k.float(), v.float(), scale)
    before = wrapper.launches
    out, lse = call(True)
    out2, none = call(False)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2 and none is None
    assert torch.equal(out, out2)
    assert bool(torch.isfinite(out.float()).all())
    max_rel, mean_rel = _errors(out, ref)
    assert max_rel <= 2e-2 and mean_rel <= 4e-3, (max_rel, mean_rel)
    assert _errors(out, truth)[1] <= 1.5 * _errors(ref, truth)[1] + 1e-6
    # fp32 log-sum-exp of the same logits, summed in another order.
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * float(ref_lse.abs().max()) + 1e-5


@pytest.mark.gpu
def test_flash_forward_plan_matches_the_kernel_on_gpu(cuda):
    """forward_plan (Python) and vfm_flash_fwd_plan (the C launch) agree."""
    import ctypes

    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa
    from vfm_vae_tpu_torch.ops.kernels._build import library

    lib = library().lib
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for B, Tq, N, D in ((2, 64, 8, 64), (2, 1024, 16, 64), (2, 1024, 8, 128), (32, 1024, 8, 128),
                        (1, 5, 1, 64), (32, 1024, 16, 64)):
        got = (ctypes.c_int * 6)()
        assert lib.vfm_flash_fwd_plan(B, Tq, N, D, sms, got) == 0
        p = fa.forward_plan(B, Tq, N, D, sms)
        assert list(got) == [p["wgs"], p["query_tile"], p["key_tile"], p["stages"], p["threads"],
                             p["smem_bytes"]], (B, Tq, N, D)


# (B, Tq, Tk, N, D, null): K3 at every flagship and EQ-bucket T (B=2); K4 in
# bf16 with Tq != Tk at d = 64 and 128; B = 1, 3 and 32.
BACKWARD_CASES = (
    [(2, T, T, 8, 64, True) for T in (4, 16, 36, 64, 144, 256, 576, 1024)]
    + [(2, 300, 1000, 4, 64, False), (2, 1024, 77, 8, 128, False),
       (2, 129, 640, 8, 128, False), (1, 64, 64, 1, 128, False),
       (1, 1024, 1024, 2, 64, True), (3, 200, 200, 8, 64, True),
       (3, 1024, 1024, 16, 128, False), (32, 1024, 1024, 8, 64, True),
       (32, 1024, 1024, 16, 64, False)])


@pytest.mark.gpu
@pytest.mark.parametrize("B,Tq,Tk,N,D,null", BACKWARD_CASES)
def test_flash_backward_matches_twin_on_gpu(cuda, B, Tq, Tk, N, D, null):
    """The bf16 backward, one library call (pre-pass, dK/dV and dQ kernels),
    from the kernel forward's output and log-sum-exp: dq, dk, dv (and the
    null token's gradients) against the twin within K3's bounds (max 2e-2,
    mean 4e-3 of scale: P and dS rounded to bf16 at the same points, summed
    in another order), against fp32 autograd within 1.5x the twin's error,
    and bit-identical on a second call (no float atomics)."""
    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(B * Tq + Tk + D + 7)
    bf = torch.bfloat16
    q, dout = (torch.randn(B, Tq, N, D, generator=g, device=cuda).to(bf) for _ in range(2))
    k, v = (torch.randn(B, Tk, N, D, generator=g, device=cuda).to(bf) for _ in range(2))
    scale = D ** -0.5
    if null:
        nk, nv = (torch.randn(B, 1, N, D, generator=g, device=cuda).to(bf) for _ in range(2))
        out, lse = fa._launch_forward(q, k, v, nk, nv, scale, True)
        twin = kernels.flash_attention_nullkv_bwd_reference(q, k, v, nk, nv, out, lse, dout,
                                                            scale)[:5]
        leaves = [t.float().requires_grad_() for t in (q, k, v, nk, nv)]
        truth = torch.autograd.grad(kernels.flash_attention_nullkv_reference(*leaves, scale),
                                    leaves, dout.float())
        counters = kernels.BACKWARD_WRAPPERS
    else:
        nk = nv = None
        out, lse = fa._launch_nonull(q, k, v, scale, True)
        twin = kernels.flash_attention_nonull_bwd_reference(q, k, v, out, lse, dout, scale)[:3]
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        truth = torch.autograd.grad(kernels.flash_attention_nonull_reference(*leaves, scale),
                                    leaves, dout.float())
        counters = kernels.NONULL_BACKWARD_WRAPPERS
    before = [fn.launches for fn in counters]
    got = fa._launch_backward(q, k, v, nk, nv, out, dout, lse, scale)
    again = fa._launch_backward(q, k, v, nk, nv, out, dout, lse, scale)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [b + 2 for b in before]
    for name, a, a2, ref, tr in zip(("dq", "dk", "dv", "dnull_k", "dnull_v"), got, again, twin,
                                    truth):
        assert torch.equal(a, a2), name
        assert bool(torch.isfinite(a.float()).all()), name
        max_rel, mean_rel = _errors(a, ref)
        assert max_rel <= 2e-2 and mean_rel <= 4e-3, (name, max_rel, mean_rel)
        assert _errors(a, tr)[1] <= 1.5 * _errors(ref, tr)[1] + 1e-6, name


@pytest.mark.gpu
def test_flash_backward_plan_matches_the_kernel_on_gpu(cuda):
    """backward_plan (Python) and vfm_flash_bwd_plan (the C launch) agree."""
    import ctypes

    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa
    from vfm_vae_tpu_torch.ops.kernels._build import library

    lib = library().lib
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for B, Tq, Tk, N, D in ((2, 64, 64, 8, 64), (2, 1024, 1024, 8, 64), (2, 576, 576, 8, 64),
                            (2, 1024, 77, 8, 128), (32, 1024, 1024, 8, 128), (1, 5, 5, 1, 64),
                            (32, 1024, 1024, 16, 64), (2, 300, 1000, 4, 64)):
        got = (ctypes.c_int * 15)()
        assert lib.vfm_flash_bwd_plan(B, Tq, Tk, N, D, sms, got) == 0
        p = fa.backward_plan(B, Tq, Tk, N, D, sms)
        want = [p[n][key] for n in ("dkv", "dq") for key in
                ("wgs", "rows", "tile", "stages", "threads", "smem_bytes", "grid")]
        assert list(got) == want + [p["prepass_rows"]], (B, Tq, Tk, N, D)


# (B, Tq, Tk, N, D): the adapter's fp32 sites (T=1024 N=16 and T=256 N=12,
# d=64) at the stage-0 step's B=4 and at B=2 (two warps per CTA at T=256),
# ragged Tq != Tk at d = 64 and 128 (B=1 with 5 queries and 3 keys: one
# partial tile each), and d=128 at T=1024.
FP32_BACKWARD_CASES = [(4, 1024, 1024, 16, 64), (4, 256, 256, 12, 64), (2, 256, 256, 12, 64),
                       (2, 77, 130, 4, 64), (2, 300, 1000, 4, 64), (2, 129, 640, 8, 128),
                       (2, 1024, 77, 8, 128), (2, 1024, 1024, 8, 128), (1, 5, 3, 1, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Tq,Tk,N,D", FP32_BACKWARD_CASES)
def test_k4_fp32_backward_matches_twin_and_fp64_on_gpu(cuda, B, Tq, Tk, N, D):
    """K4's fp32 backward (3xTF32 dK/dV and dQ kernels) in one library call:
    dq, dk, dv against the fp32 twin within 1e-5 of scale (max and mean),
    against fp64 autograd within 1.5x the twin's mean error (+1e-6), and
    bit-identical on a second call (no float atomics)."""
    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa

    f32 = torch.float32
    g = torch.Generator(device=cuda).manual_seed(B * Tq + Tk + N + D)
    q, dout = (torch.randn(B, Tq, N, D, generator=g, device=cuda) for _ in range(2))
    k, v = (torch.randn(B, Tk, N, D, generator=g, device=cuda) for _ in range(2))
    scale = D ** -0.5
    out, lse = fa._launch_nonull(q, k, v, scale, True)
    twin = kernels.flash_attention_nonull_bwd_reference(q, k, v, out, lse, dout, scale)[:3]
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    s = torch.einsum("btnh,bsnh->bnts", leaves[0], leaves[1]) * scale
    o64 = torch.einsum("bnts,bsnh->btnh", torch.softmax(s, dim=-1), leaves[2])
    truth = torch.autograd.grad(o64, leaves, dout.double())
    before = [fn.launches for fn in kernels.NONULL_BACKWARD_WRAPPERS]
    got = fa._launch_backward(q, k, v, None, None, out, dout, lse, scale)
    again = fa._launch_backward(q, k, v, None, None, out, dout, lse, scale)
    torch.cuda.synchronize()
    assert [fn.launches for fn in kernels.NONULL_BACKWARD_WRAPPERS] == [b + 2 for b in before]
    for name, a, a2, ref, tr in zip(("dq", "dk", "dv"), got, again, twin, truth):
        assert a.dtype == f32 and torch.equal(a, a2), name
        assert bool(torch.isfinite(a).all()), name
        max_rel, mean_rel = _errors(a, ref)
        assert max_rel <= 1e-5 and mean_rel <= 1e-5, (name, max_rel, mean_rel)
        assert _errors(a, tr)[1] <= 1.5 * _errors(ref, tr)[1] + 1e-6, (
            name, _errors(a, tr)[1], _errors(ref, tr)[1])


@pytest.mark.gpu
def test_flash_backward_f32_plan_matches_the_kernel_on_gpu(cuda):
    """backward_plan_f32 (Python) and vfm_flash_bwd_f32_plan (the C launch) agree."""
    import ctypes

    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa
    from vfm_vae_tpu_torch.ops.kernels._build import library

    lib = library().lib
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for B, Tq, Tk, N, D in FP32_BACKWARD_CASES + [(2, 1024, 1024, 16, 64)]:
        got = (ctypes.c_int * 12)()
        assert lib.vfm_flash_bwd_f32_plan(B, Tq, Tk, N, D, sms, got) == 0
        p = fa.backward_plan_f32(B, Tq, Tk, N, D, sms)
        want = [p[n][key] for n in ("dkv", "dq") for key in
                ("warps", "rows", "tile", "stages", "smem_bytes", "ctas")]
        assert list(got) == want, (B, Tq, Tk, N, D)


# (B, Tq, Tk, N, D): the adapter's fp32 forward sites (T=1024 N=16 and T=256
# N=12, d=64) at B=2, 4 and the offline batch's 32 (two consumer warpgroups
# where the grid fills the card, one at T=256 B=2), ragged Tq != Tk at d =
# 64 and 128 (partial query blocks and key tiles; B=1 with 5 queries and 3
# keys, and a single query and key), and d=128 at T=1024.
FP32_FORWARD_CASES = [(2, 1024, 1024, 16, 64), (4, 1024, 1024, 16, 64), (32, 1024, 1024, 16, 64),
                      (2, 256, 256, 12, 64), (4, 256, 256, 12, 64), (32, 256, 256, 12, 64),
                      (2, 77, 130, 4, 64), (2, 300, 1000, 4, 64), (2, 129, 640, 8, 128),
                      (2, 1024, 77, 8, 128), (2, 1024, 1024, 8, 128), (1, 5, 3, 1, 64),
                      (1, 1, 1, 1, 128)]


def _fp64_attention(q, k, v, scale):
    s = torch.einsum("btnh,bsnh->bnts", q.double(), k.double()) * scale
    return torch.einsum("bnts,bsnh->btnh", torch.softmax(s, dim=-1), v.double())


@pytest.mark.gpu
@pytest.mark.parametrize("B,Tq,Tk,N,D", FP32_FORWARD_CASES)
def test_k4_fp32_forward_matches_twin_and_fp64_on_gpu(cuda, B, Tq, Tk, N, D):
    """K4's fp32 forward (3xTF32 on wgmma, K/V by TMA): the output against
    the fp32 twin within 1e-5 of scale (max and mean), against fp64 within
    1.5x the twin's mean error (+1e-7), its log-sum-exp against the twin's
    logsumexp, bit-identical on repeat, with and without the log-sum-exp,
    one launch a call."""
    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(B * Tq + Tk + N + D + 11)
    q = torch.randn(B, Tq, N, D, generator=g, device=cuda)
    k, v = (torch.randn(B, Tk, N, D, generator=g, device=cuda) for _ in range(2))
    scale = D ** -0.5
    before = kernels.flash_attention_nonull.launches
    out, lse = fa._launch_nonull(q, k, v, scale, True)
    out2, lse2 = fa._launch_nonull(q, k, v, scale, True)
    out3, none = fa._launch_nonull(q, k, v, scale, False)
    torch.cuda.synchronize()
    assert kernels.flash_attention_nonull.launches == before + 3 and none is None
    assert torch.equal(out, out2) and torch.equal(lse, lse2) and torch.equal(out, out3)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    ref, ref_lse = kernels.flash_attention_nonull_reference(q, k, v, scale, True)
    max_rel, mean_rel = _errors(out, ref)
    assert max_rel <= 1e-5 and mean_rel <= 1e-5, (max_rel, mean_rel)
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * float(ref_lse.abs().max()) + 1e-5
    del ref_lse
    truth = _fp64_attention(q, k, v, scale)
    k64, p64 = _errors(out, truth)[1], _errors(ref, truth)[1]
    assert k64 <= 1.5 * p64 + 1e-7, (k64, p64)


@pytest.mark.gpu
def test_flash_forward_f32_plan_matches_the_kernel_on_gpu(cuda):
    """forward_plan_f32 (Python) and vfm_flash_fwd_f32_plan (the C launch) agree."""
    import ctypes

    from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa
    from vfm_vae_tpu_torch.ops.kernels._build import library

    lib = library().lib
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for B, Tq, _, N, D in FP32_FORWARD_CASES:
        got = (ctypes.c_int * 7)()
        assert lib.vfm_flash_fwd_f32_plan(B, Tq, N, D, sms, got) == 0
        p = fa.forward_plan_f32(B, Tq, N, D, sms)
        assert list(got) == [p[key] for key in ("wgs", "query_tile", "key_tile", "stages",
                                                "threads", "smem_bytes", "ctas")], (B, Tq, N, D)

"""The arithmetic of K4's fp32 kernels, the backward
(csrc/flash_attention_nullkv_bwd.cu: dkv_f32_kernel, dq_f32_kernel) and the
forward (csrc/flash_attention_nullkv.cu: flash_fwd_f32_kernel), emulated in
plain torch on the CPU and held to the gates that chip_smoke.py holds the
kernels to on the card: within 1e-5 of scale of the fp32 twin, and within
1.5x the twin's mean error against fp64 (autograd for the backward).

The emulation repeats the kernels' rounding points: each operand split into
hi = tf32(x) (round to nearest) and lo = x - hi, which the tensor cores read
truncated to TF32; per k block of 8, the products a_lo b_hi + a_hi b_lo +
a_hi b_hi summed exactly and rounded towards zero into an fp32 accumulator
(the tensor cores' accumulation); a fresh accumulator per two k blocks (six
products), added to the running fp32 sum in round to nearest. The forward
walks the keys in the kernel's tiles (4096 / D keys) with an online softmax
in exp2, rescales O and adds each chain of the tile's O += P V to it. 1xTF32
(the hi products alone) and one accumulation chain over each whole reduction
are held to be what the gates catch. No JAX, no kernel.
"""

import numpy as np
import pytest
import torch

from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa
from tests.torch_threads import one_torch_thread  # noqa: F401

FLASH_FP32_MAX_REL = 1e-5  # chip_smoke.py: K4 fp32 against its twin
TRUTH_FACTOR = 1.5         # chip_smoke.py: against fp64, x the twin's error
LOG2E = 1.4426950408889634


def tf32_rna(x):
    """fp32 -> TF32 (10 mantissa bits), round to nearest, ties away (cvt.rna)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """What the tensor cores read of an fp32 operand: its top 19 bits."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x, terms: int):
    """(hi, lo) as the kernels split an operand; lo is None for 1xTF32."""
    hi = tf32_rna(x)
    return hi, (tf32_trunc(x - hi) if terms == 3 else None)


def to_fp32_toward_zero(x64):
    x = x64.float()
    over = x.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(x, torch.zeros_like(x)), x)


def tc_matmul(a, b, terms=3, chain=2, acc=None):
    """a (..., M, K) @ b (..., K, N) in fp32 as the kernels' tensor-core
    products compute it: k blocks of 8, `terms` TF32 products per block (3:
    3xTF32, 1: 1xTF32), `chain` k blocks per fresh accumulator, each added
    to the running fp32 sum `acc` (zeros if None; chain None: one
    accumulator over all of K, starting from `acc`). The backward kernels'
    tiles (32 queries, 64 keys) hold whole chains, so the walk does not
    change the sums."""
    K = a.shape[-1]
    total = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32) if acc is None else acc
    z = torch.zeros_like(total) if chain is not None else total
    blocks = list(range(0, K, 8))
    for i, k0 in enumerate(blocks):
        ah, al = split(a[..., k0:k0 + 8], terms)
        bh, bl = split(b[..., k0:k0 + 8, :], terms)
        pairs = ((al, bh), (ah, bl), (ah, bh)) if terms == 3 else ((ah, bh),)
        for x, y in pairs:
            z = to_fp32_toward_zero(z.double() + x.double() @ y.double())
        if chain is not None and (i % chain == chain - 1 or i == len(blocks) - 1):
            total, z = total + z, torch.zeros_like(z)
    return total if chain is not None else z


def emulated_backward(q, k, v, out, lse, dout, scale, **mm):
    """dq, dk, dv of the kernels' formula with tc_matmul products; (B, N, T,
    D) layouts inside, (B, T, N, D) in and out."""
    qh, kh, vh, oh = (t.permute(0, 2, 1, 3) for t in (q, k, v, dout))
    delta = (dout * out).sum(-1).permute(0, 2, 1)[..., None]
    s = tc_matmul(qh, kh.transpose(-1, -2), **mm)
    p = torch.exp2(s * (scale * LOG2E) - lse[..., None] * LOG2E)
    ds = p * (tc_matmul(oh, vh.transpose(-1, -2), **mm) - delta)
    dq = tc_matmul(ds, kh, **mm) * scale
    dk = tc_matmul(ds.transpose(-1, -2), qh, **mm) * scale
    dv = tc_matmul(p.transpose(-1, -2), oh, **mm)
    return tuple(t.permute(0, 2, 1, 3) for t in (dq, dk, dv))


def rel(got, ref):
    d = (got.double() - ref.double()).abs()
    return float(d.max() / ref.double().abs().max()), float(d.mean() / ref.double().abs().mean())


@pytest.fixture(scope="module", params=[(1, 128, 128, 2, 64), (1, 77, 130, 2, 64)],
                ids=["adapter-like", "ragged"])
def case(request):
    B, Tq, Tk, N, D = request.param
    rng = np.random.default_rng(Tq + Tk)
    q, dout = (torch.from_numpy(rng.standard_normal((B, Tq, N, D), dtype=np.float32))
               for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Tk, N, D), dtype=np.float32))
            for _ in range(2))
    scale = D ** -0.5
    out, lse = fa.flash_attention_nonull_reference(q, k, v, scale, return_lse=True)
    twin = fa.flash_attention_nonull_bwd_reference(q, k, v, out, lse, dout, scale)[:3]
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    s = torch.einsum("btnh,bsnh->bnts", leaves[0], leaves[1]) * scale
    o64 = torch.einsum("bnts,bsnh->btnh", torch.softmax(s, dim=-1), leaves[2])
    truth = torch.autograd.grad(o64, leaves, dout.double())
    return dict(args=(q, k, v, out, lse, dout, scale), twin=twin, truth=truth)


def test_3xtf32_backward_holds_the_chip_gates(case):
    """The kernels' 3xTF32 arithmetic (six products per fresh accumulator)
    is within 1e-5 of the fp32 twin and within 1.5x the twin's error against
    fp64, here without chip_smoke.py's 1e-6 slack (this model of the tensor
    cores' rounding puts it at 1.2x; the card measured 0.7x)."""
    got = emulated_backward(*case["args"])
    for name, a, b, t64 in zip(("dq", "dk", "dv"), got, case["twin"], case["truth"]):
        max_rel, mean_rel = rel(a, b)
        assert max_rel <= FLASH_FP32_MAX_REL and mean_rel <= FLASH_FP32_MAX_REL, (name, max_rel)
        k64, p64 = rel(a, t64)[1], rel(b, t64)[1]
        assert k64 <= TRUTH_FACTOR * p64, (name, k64, p64)


def test_1xtf32_fails_the_gates(case):
    """One TF32 product per fp32 product keeps TF32's 11 bits: hundreds of
    times the twin's error, far past both gates."""
    got = emulated_backward(*case["args"], terms=1)
    for name, a, b, t64 in zip(("dq", "dk", "dv"), got, case["twin"], case["truth"]):
        assert rel(a, b)[0] > 10 * FLASH_FP32_MAX_REL, name
        assert rel(a, t64)[1] > 100 * rel(b, t64)[1], name


def test_one_chain_per_reduction_loses_fp32_accuracy(case):
    """The tensor cores' accumulation rounds towards zero: chained over each
    whole reduction (every tile of the walk into one accumulator) the
    gradients end further from fp64 than the twin, where the kernels'
    chains of six products stay closer."""
    got = emulated_backward(*case["args"], chain=None)
    ratios = [rel(a, t64)[1] / rel(b, t64)[1]
              for a, b, t64 in zip(got, case["twin"], case["truth"])]
    assert min(ratios) > 2.0, ratios


# ------------------------------------------------------------------ forward


def emulated_forward(q, k, v, scale, terms=3, chain=2):
    """out (B, Tq, N, D) and lse (B, N, Tq) of the fp32 forward kernel's
    arithmetic: per tile of 4096 / D keys, S = Q K^T (tc_matmul), the online
    softmax in exp2 (log2 units), O *= alpha, O += P V with each chain added
    to O in order (chain None: one accumulator chain through the whole walk,
    O included)."""
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    B, N, Tq, D = qh.shape
    kt, sl2 = 4096 // D, scale * LOG2E
    m = torch.full((B, N, Tq, 1), -float("inf"))
    l, o = torch.zeros(B, N, Tq, 1), torch.zeros(B, N, Tq, D)
    for k0 in range(0, kh.shape[2], kt):
        s = tc_matmul(qh, kh[:, :, k0:k0 + kt].transpose(-1, -2), terms, chain)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
        alpha, m = torch.exp2(m - m_new), m_new
        p = torch.exp2(s * sl2 - m)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = tc_matmul(p, vh[:, :, k0:k0 + kt], terms, chain, acc=o * alpha)
    lse = (m + torch.log2(l))[..., 0] / LOG2E
    return (o / l).permute(0, 2, 1, 3), lse


@pytest.fixture(scope="module", params=[(1, 128, 128, 2, 64), (1, 77, 130, 2, 64),
                                        (1, 64, 100, 2, 128)],
                ids=["adapter-like", "ragged", "d128"])
def fwd_case(request):
    B, Tq, Tk, N, D = request.param
    rng = np.random.default_rng(Tq * Tk + D)
    q = torch.from_numpy(rng.standard_normal((B, Tq, N, D), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Tk, N, D), dtype=np.float32))
            for _ in range(2))
    scale = D ** -0.5
    twin, lse = fa.flash_attention_nonull_reference(q, k, v, scale, return_lse=True)
    s64 = torch.einsum("btnh,bsnh->bnts", q.double(), k.double()) * scale
    truth = torch.einsum("bnts,bsnh->btnh", torch.softmax(s64, dim=-1), v.double())
    return dict(args=(q, k, v, scale), twin=twin, lse=lse, truth=truth)


def test_3xtf32_forward_holds_the_chip_gates(fwd_case):
    """The forward's 3xTF32 arithmetic (six products per fresh accumulator,
    in S and in O += P V) is within 1e-5 of the fp32 twin, its log-sum-exp
    within 1e-5 of the twin's, and its error against fp64 within 1.5x the
    twin's, here without the card's 1e-7 slack."""
    got, lse = emulated_forward(*fwd_case["args"])
    max_rel, mean_rel = rel(got, fwd_case["twin"])
    assert max_rel <= FLASH_FP32_MAX_REL and mean_rel <= FLASH_FP32_MAX_REL, (max_rel, mean_rel)
    ref_lse = fwd_case["lse"]
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * float(ref_lse.abs().max()) + 1e-5
    k64, p64 = rel(got, fwd_case["truth"])[1], rel(fwd_case["twin"], fwd_case["truth"])[1]
    assert k64 <= TRUTH_FACTOR * p64, (k64, p64)


def test_1xtf32_forward_fails_the_gates(fwd_case):
    """One TF32 product per fp32 product: hundreds of times the twin's
    error, far past both gates."""
    got, _ = emulated_forward(*fwd_case["args"], terms=1)
    assert rel(got, fwd_case["twin"])[0] > 10 * FLASH_FP32_MAX_REL
    assert rel(got, fwd_case["truth"])[1] > 100 * rel(fwd_case["twin"], fwd_case["truth"])[1]


def test_one_chain_per_reduction_forward_fails_the_fp64_gate(fwd_case):
    """S chained over all of d and O += P V chained through the whole key
    walk, with no fresh accumulator: the tensor cores' rounding towards zero
    puts the output further from fp64 than TRUTH_FACTOR x the twin."""
    got, _ = emulated_forward(*fwd_case["args"], chain=None)
    k64, p64 = rel(got, fwd_case["truth"])[1], rel(fwd_case["twin"], fwd_case["truth"])[1]
    assert k64 > TRUTH_FACTOR * p64, (k64, p64)


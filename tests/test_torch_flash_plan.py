"""The flash kernels' launch plans (forward_plan, forward_plan_f32,
backward_plan and backward_plan_f32, the Python mirrors of
vfm_flash_fwd_plan, vfm_flash_fwd_f32_plan, vfm_flash_bwd_plan and
vfm_flash_bwd_f32_plan in csrc/flash_attention_nullkv{,_bwd}.cu) and the
wrappers' single validation pass, on the CPU: no kernel, no JAX."""

import pytest
import torch

from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa
from tests.torch_threads import one_torch_thread  # noqa: F401

SMEM_LIMIT = 232448  # bytes of shared memory one block can use on the H100
H100_SMS = 132

# (B, Tq, N, D): K3's decode sites (flagship and EQ buckets) at B=2 and
# B=32, the tower's and the d=128 shape, the adapter's T=256 site.
MODEL_SHAPES = ([(2, T, 8, 64) for T in (4, 16, 36, 64, 144, 256, 576, 1024)]
                + [(32, 1024, 8, 64), (2, 1024, 16, 64), (32, 1024, 16, 64),
                   (2, 1024, 8, 128), (32, 1024, 8, 128), (2, 256, 12, 64), (1, 1, 1, 64)])


@pytest.mark.parametrize("B,Tq,N,D", MODEL_SHAPES)
def test_forward_plan_covers_every_query_and_fits_a_block(B, Tq, N, D):
    p = fa.forward_plan(B, Tq, N, D, H100_SMS)
    assert p["query_tile"] == 64 * p["wgs"] and p["wgs"] in (1, 2)
    assert p["work_tiles"] == -(-Tq // p["query_tile"]) * N * B
    assert (p["work_tiles"] // (N * B)) * p["query_tile"] >= Tq > (
        p["work_tiles"] // (N * B) - 1) * p["query_tile"]
    assert p["smem_bytes"] <= SMEM_LIMIT
    assert p["threads"] == 128 * p["wgs"] + 128  # consumer warpgroups + the producer's
    boxes = D // 64  # the 128-byte swizzle spans 64 bf16 columns
    assert p["boxes_per_row"] == boxes
    assert p["q_box"] == (64, 1, p["query_tile"], 1) and p["kv_box"] == (64, 1, p["key_tile"], 1)
    tile = boxes * p["key_tile"] * 128
    assert p["smem_bytes"] >= boxes * p["query_tile"] * 128 + 2 * p["stages"] * tile


@pytest.mark.parametrize("B,Tq,N,wgs", [(2, 64, 8, 1), (2, 1024, 8, 1), (32, 1024, 8, 2),
                                        (2, 1024, 16, 2), (1, 4, 1, 1), (3, 1024, 16, 2)])
def test_forward_plan_takes_two_warpgroups_only_when_every_sm_gets_a_cta(B, Tq, N, wgs):
    """128-query CTAs where B * N * ceil(Tq / 128) >= the SM count, else 64:
    K3's B=2 sites (8 heads) would leave SMs idle with 128 queries."""
    for D in (64, 128):
        assert fa.forward_plan(B, Tq, N, D, H100_SMS)["wgs"] == wgs
    assert (B * N * -(-Tq // 128) >= H100_SMS) == (wgs == 2)


def test_forward_plan_refuses_other_head_dims():
    for D in (32, 96, 256):
        with pytest.raises(ValueError):
            fa.forward_plan(2, 1024, 8, D)


def test_forward_validation_refuses_what_the_kernel_does_not_take():
    """One pass over the operands: a CPU device, another dtype, another
    shape or a non-contiguous tensor raises ValueError before any launch."""
    q = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.check_all("k", torch.bfloat16, q.device, ((q, "q", q.shape),))
    meta = torch.device("meta")
    qm = q.to(meta)
    with pytest.raises(ValueError):
        fa.check_all("k", torch.bfloat16, meta, ((qm, "q", qm.shape),))
    before = (fa.flash_attention_nullkv.launches, fa.flash_attention_nonull.launches)
    with pytest.raises(ValueError):
        fa._launch_nonull(qm, qm.float(), qm, 0.125, False)
    with pytest.raises(ValueError):
        fa._launch_forward(qm, qm, qm, qm[:, :1], qm[:, :1].transpose(1, 2), 0.125, False)
    assert (fa.flash_attention_nullkv.launches, fa.flash_attention_nonull.launches) == before


# K3's EQ-bucket and flagship sequence lengths.
EQ_T = (4, 16, 36, 64, 144, 256, 576, 1024)
# (B, Tq, Tk, N, D): K3 at B=2 and B=32, the tower, d=128, K4 with Tq != Tk,
# B = 1 and 3.
BACKWARD_SHAPES = ([(2, T, T, 8, 64) for T in EQ_T]
                   + [(32, 1024, 1024, 8, 64), (2, 1024, 1024, 16, 64), (32, 1024, 1024, 16, 64),
                      (2, 1024, 1024, 8, 128), (32, 1024, 1024, 8, 128), (2, 300, 1000, 4, 64),
                      (2, 1024, 77, 8, 128), (2, 129, 640, 8, 128), (1, 1024, 1024, 2, 64),
                      (3, 200, 200, 8, 64), (1, 1, 1, 1, 64)])


@pytest.mark.parametrize("B,Tq,Tk,N,D", BACKWARD_SHAPES)
def test_backward_plan_covers_every_row_and_fits_a_block(B, Tq, Tk, N, D):
    """Each backward kernel's work tiles cover its rows (keys for dK/dV,
    queries for dQ) in blocks of 64 per consumer warpgroup, its streamed
    tiles cover the other side's rows, one persistent CTA per SM at most,
    and its shared memory fits one block."""
    p = fa.backward_plan(B, Tq, Tk, N, D, H100_SMS)
    assert p["box"] == (64, 1, 64, 1) and p["boxes_per_row"] == D // 64
    for name, T, T_walk in (("dkv", Tk, Tq), ("dq", Tq, Tk)):
        k = p[name]
        assert k["wgs"] in (1, 2) and k["rows"] == 64 * k["wgs"], name
        assert k["threads"] == 128 * k["wgs"] + 128, name  # + the producer warpgroup
        blocks = k["work_tiles"] // (N * B)
        assert k["work_tiles"] == blocks * N * B and blocks * k["rows"] >= T > (
            blocks - 1) * k["rows"], name
        assert k["walk_tiles"] * k["tile"] >= T_walk > (k["walk_tiles"] - 1) * k["tile"], name
        assert k["grid"] == min(k["work_tiles"], H100_SMS), name
        assert k["smem_bytes"] <= SMEM_LIMIT, (name, k["smem_bytes"])
        resident = 2 * (D // 64) * k["rows"] * 128  # K and V, or q and dO
        assert k["smem_bytes"] >= resident + 2 * k["stages"] * (D // 64) * k["tile"] * 128, name


@pytest.mark.parametrize("B,T,N,wgs", [(2, 1024, 8, 2), (2, 576, 8, 2), (2, 256, 8, 1),
                                       (2, 64, 8, 1), (32, 1024, 8, 2), (1, 1024, 2, 1),
                                       (3, 200, 8, 1), (2, 1024, 16, 2)])
def test_backward_plan_takes_one_warpgroup_only_when_64_row_blocks_fit_one_wave(B, T, N, wgs):
    """128-row work tiles unless B * N * ceil(T / 64) <= the SM count: then
    every 64-row block has an SM to itself."""
    for D in (64, 128):
        p = fa.backward_plan(B, T, T, N, D, H100_SMS)
        assert p["dkv"]["wgs"] == p["dq"]["wgs"] == wgs
    assert (B * N * -(-T // 64) > H100_SMS) == (wgs == 2)


@pytest.mark.parametrize("T", EQ_T)
def test_backward_plan_keeps_the_null_token_out_of_the_walk(T):
    """K3's key tiles start at row 0 of k: the walk covers T keys, not the
    T + 1 of [null; k] (so T = 64 is one key tile, not two), and the null
    token's gradients sum ceil(T / 64) pre-pass partials, one per 64 queries."""
    p = fa.backward_plan(2, T, T, 8, 64, H100_SMS)
    assert p["dq"]["walk_tiles"] == -(-T // 64)
    assert p["dkv"]["work_tiles"] == -(-T // p["dkv"]["rows"]) * 8 * 2
    assert p["null_chunks"] == -(-T // p["prepass_rows"]) and p["prepass_rows"] == 64
    assert p["dkv"]["walk_tiles"] == p["null_chunks"]  # one pre-pass chunk per query tile


def test_backward_plan_refuses_other_head_dims():
    for D in (32, 96, 256):
        with pytest.raises(ValueError):
            fa.backward_plan(2, 1024, 1024, 8, D)


def test_backward_validation_refuses_what_the_kernels_do_not_take():
    """One validation pass before the one library call: a CPU or meta
    device, K3 with Tq != Tk, or another head dim raise ValueError and count
    nothing."""
    meta = torch.device("meta")
    bf = torch.bfloat16
    q = torch.zeros(2, 16, 4, 64, dtype=bf, device=meta)
    nk = q[:, :1].contiguous()
    lse = torch.zeros(2, 4, 16, device=meta)
    counters = (fa.flash_attention_nullkv_bwd_dkv, fa.flash_attention_nullkv_bwd_dq,
                fa.flash_attention_nonull_bwd_dkv, fa.flash_attention_nonull_bwd_dq)
    before = [c.launches for c in counters]
    cpu = torch.zeros(2, 16, 4, 64, dtype=bf)
    with pytest.raises(ValueError, match="CUDA"):
        fa._launch_backward(cpu, cpu, cpu, cpu[:, :1], cpu[:, :1], cpu, cpu,
                            torch.zeros(2, 4, 16), 0.125)
    with pytest.raises(ValueError):
        fa._launch_backward(q, q, q, nk, nk, q, q, lse, 0.125)  # meta: not CUDA
    k8 = torch.zeros(2, 8, 4, 64, dtype=bf, device=meta)
    with pytest.raises(ValueError, match="Tq"):
        fa._launch_backward(q, k8, k8, nk, nk, q, q, lse, 0.125)
    q32 = torch.zeros(2, 16, 4, 32, dtype=bf, device=meta)
    with pytest.raises(ValueError):
        fa._launch_backward(q32, q32, q32, None, None, q32, q32, lse, 0.125)
    assert [c.launches for c in counters] == before


# (B, Tq, Tk, N, D) of the fp32 backward: the adapter's sites (T=1024 N=16,
# T=256 N=12) at B=2 and B=4, ragged Tq != Tk at d = 64 and 128, d=128.
F32_BACKWARD_SHAPES = [(2, 1024, 1024, 16, 64), (4, 1024, 1024, 16, 64), (2, 256, 256, 12, 64),
                       (4, 256, 256, 12, 64), (2, 77, 130, 4, 64), (2, 300, 1000, 4, 64),
                       (2, 129, 640, 8, 128), (2, 1024, 77, 8, 128), (2, 1024, 1024, 8, 128),
                       (1, 5, 3, 1, 64), (1, 1, 1, 1, 128)]


@pytest.mark.parametrize("B,Tq,Tk,N,D", F32_BACKWARD_SHAPES)
def test_f32_backward_plan_covers_every_row_and_fits_a_block(B, Tq, Tk, N, D):
    """Each fp32 kernel's CTAs cover its rows (keys for dK/dV, queries for
    dQ) in blocks of 16 per warp, its streamed tiles cover the other side's
    rows, and its shared memory (resident pair + two stages of the streamed
    pair, rows of D + 4 floats; dK/dV's stages hold q and dO as hi and lo
    planes and the tile's L and D) fits one block, two at d=64 with four
    warps."""
    p = fa.backward_plan_f32(B, Tq, Tk, N, D, H100_SMS)
    for name, T, T_walk in (("dkv", Tk, Tq), ("dq", Tq, Tk)):
        k = p[name]
        assert k["warps"] in (2, 4) and k["rows"] == 16 * k["warps"], name
        assert k["threads"] == 32 * k["warps"] and k["stages"] == 2, name
        blocks = k["ctas"] // (N * B)
        assert k["ctas"] == blocks * N * B and blocks * k["rows"] >= T > (
            blocks - 1) * k["rows"], name
        assert k["walk_tiles"] * k["tile"] >= T_walk > (k["walk_tiles"] - 1) * k["tile"], name
        planes = 4 if name == "dkv" else 2  # streamed tensors x (hi, lo) or as loaded
        rows_f = ((2 * k["rows"] + 2 * planes * k["tile"]) * (D + 4)
                  + (2 * 2 * k["tile"] if name == "dkv" else 0))
        assert k["smem_bytes"] == 4 * rows_f, name
        assert k["smem_bytes"] <= SMEM_LIMIT, (name, k["smem_bytes"])
        if D == 64 and k["warps"] == 4:
            assert 2 * (k["smem_bytes"] + 1024) <= 233472, name  # two CTAs per SM
    assert p["dkv"]["tile"] == 32 and p["dq"]["tile"] == 64


@pytest.mark.parametrize("B,T,N,warps", [(2, 1024, 16, 4), (4, 1024, 16, 4), (2, 256, 12, 2),
                                         (4, 256, 12, 4), (2, 77, 4, 2), (1, 64, 1, 2)])
def test_f32_backward_plan_takes_two_warps_only_when_four_leave_sms_idle(B, T, N, warps):
    """64-row CTAs where B * N * ceil(T / 64) >= the SM count, else 32-row
    CTAs: the adapter's T=256 site at B=2 (96 blocks of 64) gets 192 CTAs."""
    for D in (64, 128):
        p = fa.backward_plan_f32(B, T, T, N, D, H100_SMS)
        assert p["dkv"]["warps"] == p["dq"]["warps"] == warps
    assert (B * N * -(-T // 64) >= H100_SMS) == (warps == 4)


def test_f32_backward_plan_refuses_other_head_dims():
    for D in (32, 96, 256):
        with pytest.raises(ValueError):
            fa.backward_plan_f32(2, 1024, 1024, 8, D)


# (B, Tq, N, D) of the fp32 forward: the adapter's sites (T=1024 N=16,
# T=256 N=12) at B=2, 4 and 32, ragged Tq at d = 64 and 128, d=128 at
# T=1024, one and five queries.
F32_FORWARD_SHAPES = [(2, 1024, 16, 64), (4, 1024, 16, 64), (32, 1024, 16, 64), (2, 256, 12, 64),
                      (4, 256, 12, 64), (32, 256, 12, 64), (2, 77, 4, 64), (2, 129, 8, 128),
                      (2, 1024, 8, 128), (1, 5, 1, 64), (1, 1, 1, 128)]


@pytest.mark.parametrize("B,Tq,N,D", F32_FORWARD_SHAPES)
def test_f32_forward_plan_covers_every_query_and_fits_a_block(B, Tq, N, D):
    """The fp32 forward's CTAs cover every query row of every (sample,
    head) in blocks of 64 per consumer warpgroup; K/V tiles hold 16 KB of
    fp32 (4096 / D keys); its shared memory (Q's hi and lo planes, two
    stages of K, K lo, V, V^T hi and V^T lo, nine barriers, alignment
    slack) fits one block; TMA boxes are 32 fp32 columns (128 bytes, the
    swizzle's span)."""
    p = fa.forward_plan_f32(B, Tq, N, D, H100_SMS)
    rows, kt = p["query_tile"], p["key_tile"]
    assert p["wgs"] in (1, 2) and rows == 64 * p["wgs"]
    assert p["threads"] == 128 * p["wgs"] + 128  # consumer warpgroups + the producer's
    blocks = p["ctas"] // (N * B)
    assert p["ctas"] == blocks * N * B and blocks * rows >= Tq > (blocks - 1) * rows
    assert kt * D == 4096 and p["stages"] == 2
    plane, tile = rows * D * 4, kt * D * 4
    assert p["smem_bytes"] == 2 * plane + 2 * 5 * tile + 8 * (2 + 3 * 2) + 1024
    assert p["smem_bytes"] <= SMEM_LIMIT, p["smem_bytes"]
    assert p["boxes_per_row"] * 32 == D
    assert p["q_box"] == (32, 1, rows, 1) and p["kv_box"] == (32, 1, kt, 1)


@pytest.mark.parametrize("B,T,N,D,wgs", [(2, 1024, 16, 64, 2), (32, 1024, 16, 64, 2),
                                         (2, 256, 12, 64, 1), (4, 256, 12, 64, 1),
                                         (32, 256, 12, 64, 2), (2, 1024, 8, 128, 1),
                                         (32, 1024, 16, 128, 1)])
def test_f32_forward_plan_takes_two_warpgroups_only_where_they_fit_and_fill(B, T, N, D, wgs):
    """128-query CTAs at d=64 where B * N * ceil(T / 128) >= the SM count,
    else 64: the adapter's T=256 site at B=2 gets 96 CTAs, not 48; d=128
    always 64 (two warpgroups' Q planes would not fit)."""
    assert fa.forward_plan_f32(B, T, N, D, H100_SMS)["wgs"] == wgs


def test_f32_forward_plan_refuses_other_head_dims():
    for D in (32, 96, 256):
        with pytest.raises(ValueError):
            fa.forward_plan_f32(2, 1024, 8, D)


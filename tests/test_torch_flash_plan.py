"""The bf16 flash forward's launch plan (forward_plan, the Python mirror of
vfm_flash_fwd_plan in csrc/flash_attention_nullkv.cu) and the forward
wrappers' single validation pass, on the CPU: no kernel, no JAX."""

import pytest
import torch

from vfm_vae_tpu_torch.ops.kernels import flash_attention as fa

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
        fa._check_forward("k", torch.bfloat16, q.device, ((q, "q", q.shape),))
    meta = torch.device("meta")
    qm = q.to(meta)
    with pytest.raises(ValueError):
        fa._check_forward("k", torch.bfloat16, meta, ((qm, "q", qm.shape),))
    before = (fa.flash_attention_nullkv.launches, fa.flash_attention_nonull.launches)
    with pytest.raises(ValueError):
        fa._launch_nonull(qm, qm.float(), qm, 0.125, False)
    with pytest.raises(ValueError):
        fa._launch_forward(qm, qm, qm, qm[:, :1], qm[:, :1].transpose(1, 2), 0.125, False)
    assert (fa.flash_attention_nullkv.launches, fa.flash_attention_nonull.launches) == before

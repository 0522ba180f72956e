"""The int8 GEMM's launch plan (K6, K10) and its register-A quantize, on the
CPU: `ops/kernels/int8_matmul.plan` (the mirror of vfm_int8_matmul_plan,
held against the C export in tests/test_torch_gpu.py) at the tower's served
shapes and the card test's ragged ones, and an emulation of how a consumer
thread of csrc/int8_matmul.cu reads its A fragments out of a 128-byte
swizzled bf16 stage, quantizes them and packs four s8 a register, by the
index formulas stated in the kernel's comment. Pure torch, no JAX."""

import importlib
import re

import pytest
import torch

from vfm_vae_tpu_torch.ops.kernels._build import CSRC

mod = importlib.import_module("vfm_vae_tpu_torch.ops.kernels.int8_matmul")

SMS = 132
# (K, N) of the tower's Linears (q/k/v/out, fc1, fc2); M = 1024 B tokens.
SERVED = [(1024, 1024), (1024, 4096), (4096, 1024)]
RAGGED = [(77, 4096, 1024), (300, 96, 136)]
MODES = ("dynamic", "static", "raw")


def _check(p, M, K, N, mode):
    stage = p["tile_m"] * p["stage_k"] * (1 if mode == "raw" else 2) + p["tile_n"] * p["stage_k"]
    tiles = -(-M // p["tile_m"]) * -(-N // p["tile_n"])
    assert (p["tile_m"], p["stage_k"], p["consumers"], p["threads"]) == (128, 128, 2, 384)
    assert p["tile_n"] in (128, 256)
    assert p["tiles"] == tiles and p["ctas"] == min(tiles, SMS)
    assert p["stages"] >= 3
    assert p["smem_bytes"] == p["stages"] * (stage + 16) + mod.EPILOGUE_BYTES + mod.SLACK
    assert p["smem_bytes"] <= 232448
    # One more stage would not fit beside the epilogue buffers.
    assert p["smem_bytes"] + stage + 16 > 232448
    assert p["prepass"] == (mode == "dynamic")
    assert p["direct_store"] == (mode == "raw" and N % 16 != 0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B", [2, 4, 32])
@pytest.mark.parametrize("K,N", SERVED)
def test_plan_at_served_shapes(K, N, B, mode):
    M = 1024 * B
    p = mod.plan(M, N, K, mode, SMS)
    _check(p, M, K, N, mode)
    # 128 x 256 tiles unless they would fill fewer than half the SMs.
    assert p["tile_n"] == (256 if 2 * -(-M // 128) * -(-N // 256) >= SMS else 128)
    if B == 32:
        assert p["tile_n"] == 256 and p["ctas"] == SMS
    if B in (2, 4):  # a serving request's batch still fills the card
        assert p["ctas"] >= 0.95 * SMS, (M, K, N)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("M,K,N", RAGGED)
def test_plan_at_ragged_shapes(M, K, N, mode):
    p = mod.plan(M, N, K, mode, SMS)
    _check(p, M, K, N, mode)
    assert p["tile_n"] == 128 and p["ctas"] == p["tiles"]


def test_direct_store_only_for_raw_rows_off_16_bytes():
    """TMA stores need 16-byte row strides: K10's int8 rows of N bytes take
    the direct-store epilogue when N % 16 != 0; bf16 rows (2N bytes, N % 8
    == 0) always store by TMA."""
    assert mod.plan(300, 136, 96, "raw")["direct_store"]
    assert not mod.plan(300, 144, 96, "raw")["direct_store"]
    for mode in ("dynamic", "static"):
        assert not mod.plan(300, 136, 96, mode)["direct_store"]


def test_plan_refuses_shapes_the_kernel_does_not_take():
    for M, N, K in ((64, 64, 80), (64, 60, 96), (0, 64, 64)):
        with pytest.raises(ValueError):
            mod.plan(M, N, K, "static")
    with pytest.raises(ValueError):
        mod.plan(64, 64, 64, "int4")


def test_plan_constants_match_the_kernel_source():
    """The mirror's constants are the C file's (the card test compares the
    whole plan with the C export)."""
    src = (CSRC / "int8_matmul.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kBM") == mod.TILE_M and const("kBK") == mod.STAGE_K
    assert const("kConsumers") == mod.CONSUMERS and const("kSmemMax") == mod.SMEM_MAX
    assert const("kSlack") == mod.SLACK
    assert "p.bn = 2LL * m_tiles * cdiv(N, 256) >= sms ? 256 : 128;" in src
    assert "mma.sync" not in src  # wgmma only


# ------------------------------------------------------ register-A emulation

ROWS, COLS = 128, 128  # one stage: two warpgroups of 64 rows, 128 K values
BOX = 128 * 128        # bytes of one box of 64 bf16 columns x 128 rows


def _address(r, c):
    """Byte offset of bf16 column c of tile row r in the stage (the kernel's
    comment): (c / 64) 16384 + 128 r + (((b / 16) ^ (r % 8)) 16) + b % 16,
    b = 2 (c % 64)."""
    b = 2 * (c % 64)
    return (c // 64) * BOX + 128 * r + (((b // 16) ^ (r % 8)) * 16) + b % 16


def _stage(x: torch.Tensor) -> torch.Tensor:
    """The bytes that two TMA loads of (64 columns x 128 rows) boxes in the
    128-byte swizzle write for the bf16 tile x (128, 128)."""
    r = torch.arange(ROWS).view(-1, 1).expand(ROWS, COLS)
    c = torch.arange(COLS).view(1, -1).expand(ROWS, COLS)
    addr = _address(r, c).reshape(-1)
    raw = x.contiguous().view(torch.int16).reshape(-1).to(torch.int32)
    stage = torch.full((2 * BOX,), -1, dtype=torch.int32)
    stage[addr] = raw & 0xFF          # little-endian: low byte first
    stage[addr + 1] = (raw >> 8) & 0xFF
    assert (stage >= 0).all()         # the tile fills the stage exactly
    return stage.to(torch.uint8)


def _loads():
    """Every eight-byte load of every consumer thread in issue order, as
    (row, first column, lane, instruction, destination K step): load p of the
    pair of K steps (2 j, 2 j + 1) of lane (g, t) of warp w in warpgroup wg
    reads step kk = 2 j + (p ^ (g % 2)), row 64 wg + 16 w + g + 8 h, columns
    32 kk + 16 q + 4 t .. + 3, and its packed word lands in a[kk][2 q + h]."""
    idx = torch.cartesian_prod(torch.arange(2), torch.arange(4), torch.arange(32),
                               torch.arange(2), torch.arange(2), torch.arange(2),
                               torch.arange(2))
    wg, w, lane, j, q, h, p = idx.unbind(1)
    g, t = lane // 4, lane % 4
    kk = 2 * j + (p ^ (g % 2))
    instr = ((wg * 4 + w) * 8 + (j * 2 + q) * 2 + h) * 2 + p  # one warp-wide instruction
    return 64 * wg + 16 * w + g + 8 * h, 32 * kk + 16 * q + 4 * t, lane, instr, kk


def _bf16_values(bits: torch.Tensor) -> torch.Tensor:
    return (bits.to(torch.int32) << 16).view(torch.float32)


def _clamp_bound(inv: torch.Tensor) -> int:
    """The kernel's clamp_bound: the largest positive finite bf16 bit pattern
    whose rint(x * inv) is at most 127 (0x7F80, +inf, if every finite one is)."""
    def q(bits):
        return float(torch.round(_bf16_values(torch.tensor(bits)) * inv))

    if q(0x7F7F) <= 127:
        return 0x7F80
    lo, hi = 0, 0x7F7F
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if q(mid) <= 127 else (lo, mid)
    return lo


def _emulate(stage, mode, inv=None, s=None):
    """Each thread's 8-byte loads, quantize (static: rint(clamp(x) * inv)
    with the bf16 clamp to +-_clamp_bound; dynamic: rint(x / s) with the
    row's scale; rint as the low byte of the fp32 sum with 1.5 * 2^23) and
    pack (lowest column in the lowest byte), unpacked again into a (128,
    128) int8 tile with a coverage count."""
    r, c, _, _, _ = _loads()
    addr = _address(r, c)
    assert (addr % 8 == 0).all()  # eight-byte loads
    loaded = torch.stack([stage[addr + i] for i in range(8)], 1).to(torch.int32)
    halves = loaded[:, 0::2] | (loaded[:, 1::2] << 8)             # four bf16 bit patterns
    x = (halves << 16).view(torch.float32)                        # bf16 -> fp32, exact
    if mode == "static":
        bound = float(_bf16_values(torch.tensor(_clamp_bound(inv))))
        v = torch.clamp(x, -bound, bound) * inv
    else:
        v = x / s[r].view(-1, 1)
    low = (v + 12582912.0).view(torch.int32) & 0xFF               # rint, two's complement
    word = low[:, 0] | (low[:, 1] << 8) | (low[:, 2] << 16) | (low[:, 3] << 24)
    out = torch.zeros(ROWS, COLS, dtype=torch.int8)
    seen = torch.zeros(ROWS, COLS, dtype=torch.int32)
    for e in range(4):
        byte = ((word >> (8 * e)) & 0xFF).to(torch.uint8).view(torch.int8)
        out[r, c + e] = byte
        seen[r, c + e] += 1
    return out, seen, r, c


def _activations(seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(ROWS, COLS, generator=g) * 3
    x[:, 5] = torch.randint(-120, 120, (ROWS,), generator=g).float() + 0.5  # ties
    x[0, :4] = torch.tensor([40.0, -40.0, 1e-3, 0.0])                     # clipped by static
    return x.to(torch.bfloat16)


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_register_a_quantize_emulation_is_the_twin(mode):
    """The emulated fragments reproduce quantize_activations bit for bit,
    and every (row, k) of the stage, i.e. of each warpgroup's 64 x 32
    fragment of each K step, is covered exactly once."""
    x = _activations(3 if mode == "static" else 4)
    a_s = torch.tensor(0.1)  # x * 10 exceeds 127 somewhere: the clip is exercised
    xq, s = mod.quantize_activations(x, mode, a_s if mode == "static" else None)
    if mode == "static":
        assert (xq.abs() == 127).any()
        inv = torch.full((), 1.0) / torch.clamp_min(a_s, 1e-8)
        got, seen, r, c = _emulate(_stage(x), mode, inv=inv)
    else:
        got, seen, r, c = _emulate(_stage(x), mode, s=s.reshape(-1))
    assert (seen == 1).all()
    assert torch.equal(got, xq.to(torch.int8))
    # Each warpgroup, warp and K step owns a 16 x 32 block of rows and columns.
    for wg in range(2):
        for kk in range(4):
            sel = (r // 64 == wg) & (c // 32 == kk)
            assert sel.sum() == 64 * 32 // 4
            assert set(r[sel].tolist()) == set(range(64 * wg, 64 * wg + 64))


def test_register_a_loads_are_conflict_free():
    """Eight-byte shared loads are served a half-warp at a time: in every
    load instruction, each half-warp's 16 lanes read 128 distinct bytes that
    cover all 32 banks once (no two lanes in one bank at different words)."""
    r, c, lane, instr, _ = _loads()
    addr = _address(r, c)
    for i in range(int(instr.max()) + 1):
        for half in (lane < 16, lane >= 16):
            sel = (instr == i) & half
            a = addr[sel]
            assert len(a) == 16 and len(set(a.tolist())) == 16
            banks = torch.cat([a // 4, a // 4 + 1]) % 32
            assert sorted(banks.tolist()) == list(range(32))


@pytest.mark.parametrize("as_", [0.1, 1e-8, 3e-7, 0.0371, 1.0, 17.5, 2e4, 1e30])
def test_bf16_clamp_is_the_twins_clip_for_every_bf16(as_):
    """clip(rint(x * inv), -127, 127) == rint(clamp(x, -b, b) * inv) for
    every finite bf16 x and for +-inf, b = _clamp_bound(inv): the kernel's
    static quantize clamps in bf16 before the product."""
    a_s = torch.tensor(as_)
    inv = torch.full((), 1.0) / torch.clamp_min(a_s, 1e-8)
    bits = torch.arange(0x10000, dtype=torch.int32)
    x = _bf16_values(bits)
    x = x[~torch.isnan(x)]
    bound = float(_bf16_values(torch.tensor(_clamp_bound(inv))))
    want = torch.clamp(torch.round(x * inv), -127, 127)
    got = torch.round(torch.clamp(x, -bound, bound) * inv)
    assert torch.equal(got, want)
    assert torch.equal(mod.quantize_activations(x.to(torch.bfloat16), "static", a_s)[0], want)

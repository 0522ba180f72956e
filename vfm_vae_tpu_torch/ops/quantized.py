"""W8A8 int8 serving of the frozen tower, of any family, and of the
decoder's ConvNeXt MLPs (port of vfm_vae_tpu/ops/quantized.py).

Weights are quantized once per output channel (`prequantize_linears`,
stored on each tower Linear as the buffers `wq` int8 (out, in) and `ws` fp32
(out,)); activations are quantized per call, per row from their absmax
(dynamic, `int8_linear_prequant`) or with one calibrated per-tensor scale
`as` (static, `int8_linear_prequant_static`, after
`calibrate_int8_act_scales`). `enable_int8_tower` sets up the serving
configuration the JAX package documents: int8 tower, bf16 decode. The
decoder's static-int8 MLP mirrors each ConvNeXt layer's two pointwise
weights (`prequantize_decoder_mlps`: w1q, ws1, w2q, ws2 on the layer) and
calibrates the two activation scales as_u and as_h on the serving path's
own activations; it is off unless asked for
(`add_int8_collection(..., decoder_mlp_keys=("synthesis",))`, or
`enable_int8_decoder`), as in the JAX package. Every int8 product runs
through K6 (ops/kernels/int8_matmul.py) on the card and through its plain
twin on the CPU, with the JAX package's arithmetic order, so the quantized
activations are bit-identical to it.

Environment: VFM_VAE_INT8_VFM="1" turns the tower's int8 path on (the JAX
rule: that literal only). VFM_VAE_PALLAS_INT8, which picks the JAX package's
Pallas kernel over its XLA form, is not read: K6 serves every int8 Linear
on the card.
"""

from __future__ import annotations

import os
from typing import Callable, Tuple

import torch

from .kernels import int8_matmul
from .kernels.int8_matmul import _full


def int8_vfm_enabled() -> bool:
    return os.environ.get("VFM_VAE_INT8_VFM") == "1"


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (out, in) float -> (wq int8 (out, in), ws fp32 (out,)):
    ws = max(max_k |w| / 127, 1e-12), wq = round(w / ws) (quantized.py:64-66,
    203-210; true divisions and half-to-even rounding, as numpy does)."""
    wf = w.detach().float()
    amax = wf.abs().amax(dim=1)
    ws = torch.clamp_min(amax / _full(amax, 127.0), 1e-12)
    return torch.round(wf / ws[:, None]).to(torch.int8), ws


def int8_linear(x, w, b=None, *, plain: bool = False):
    """y = x @ w^T + b with the weight quantized in the call (quantized.py:
    int8_linear): what a Linear without an int8 mirror runs in the scope."""
    wq, ws = quantize_weight(w)
    return int8_matmul(x, wq, ws, None if b is None else b.float(), plain=plain)


def int8_linear_prequant(x, wq, ws, b=None, *, plain: bool = False):
    """Dynamic per-row activation scale over a pre-quantized weight (K6)."""
    return int8_matmul(x, wq, ws, None if b is None else b.float(), plain=plain)


def int8_linear_prequant_static(x, wq, ws, a_s, b=None, *, plain: bool = False):
    """Static calibrated activation scale `a_s` (amax / 127), values clipped
    at +-127 (K6's static mode)."""
    return int8_matmul(x, wq, ws, None if b is None else b.float(), a_s, plain=plain)


@torch.no_grad()
def prequantize_linears(module: torch.nn.Module) -> int:
    """Give every Linear under `module` its int8 mirror (the JAX function
    mirrors every 2-D 'weight' leaf of a params subtree: in the tower, the
    Linears). Returns how many."""
    from ..models.layers import Linear

    lins = [m for m in module.modules() if isinstance(m, Linear)]
    for lin in lins:
        lin.wq, lin.ws = quantize_weight(lin.weight)
    return len(lins)


@torch.no_grad()
def prequantize_decoder_mlps(module: torch.nn.Module) -> int:
    """Give every ConvNeXt layer under `module` the int8 mirrors of its MLP
    pair (quantized.py:222): w1q, ws1 from pwconv1's (4C, C) weight and
    w2q, ws2 from pwconv2's (C, 4C), per output channel as
    `quantize_weight` does. Only the MLP products are mirrored. Returns
    how many layers."""
    from ..models.convnext import ConvNeXtSynthesisLayer

    layers = [m for m in module.modules() if isinstance(m, ConvNeXtSynthesisLayer)]
    for m in layers:
        m.w1q, m.ws1 = quantize_weight(m.pwconv1.weight[:, :, 0, 0])
        m.w2q, m.ws2 = quantize_weight(m.pwconv2.weight[:, :, 0, 0])
    return len(layers)


def add_int8_collection(G, decoder_mlp_keys=()):
    """Mirror the frozen tower's Linears (the JAX function's default keys)
    and, for `decoder_mlp_keys` (such as ("synthesis",)), the ConvNeXt MLP
    pairs under those submodules to int8 (quantized.py:253); returns G."""
    prequantize_linears(G.vfm_encoder)
    for k in decoder_mlp_keys:
        prequantize_decoder_mlps(getattr(G, k))
    return G


@torch.no_grad()
def calibrate_int8_act_scales(fn: Callable, *args, linears: bool = True) -> int:
    """Run fn(*args) under the calibration scope: every mirrored
    Linear it reaches records the absmax of its input (the max over repeated
    calls) and then runs the dynamic int8 path, so later layers see serving
    numerics; every mirrored ConvNeXt layer at a map the int8 gate admits
    runs its fp32 MLP and records max |u| and max |h|. Each then gets its
    scales, amax / 127 in fp32: `as` on a Linear, `as_u` and `as_h` on a
    ConvNeXt layer (quantized.py:143-170). linears=False leaves the Linears
    out of the int8 scope (the ConvNeXt layers alone record). Returns how
    many scales were calibrated."""
    from ..models.layers import int8_calibration_scope

    with int8_calibration_scope(linears) as amax:
        fn(*args)
    for key, a in amax.items():
        module, name = key if isinstance(key, tuple) else (key, "as")
        setattr(module, name, a / _full(a, 127.0))
    return len(amax)


def enable_int8_tower(G, sample_imgs: torch.Tensor) -> int:
    """The serving configuration int8 tower + bf16 decode (quantized.py:202):
    sets VFM_VAE_INT8_VFM=1 for this process, mirrors the tower's Linears to
    int8 and calibrates their static activation scales on `sample_imgs`
    ((B, H, W, 3) in [0, 1]). The JAX function calibrates through G.encode,
    where the adapter's unmirrored Linears also run per-call int8 and record
    nothing; the scales depend on the tower alone, so this calibrates through
    the tower's encode_image and gives the same scales. Returns how many
    Linears were calibrated."""
    os.environ["VFM_VAE_INT8_VFM"] = "1"
    add_int8_collection(G)
    return calibrate_int8_act_scales(G.vfm_encoder.encode_image, sample_imgs)


def enable_int8_decoder(G, sample_imgs: torch.Tensor) -> int:
    """The full int8 serving configuration: the tower as enable_int8_tower
    sets it up, then the decoder's ConvNeXt MLPs mirrored to int8 and their
    scales calibrated through a decode of the serving encode of
    `sample_imgs` (the int8 tower on its static scales, the fp32 adapter
    outside the int8 scope, as it serves), so the scales see the serving
    numerics. The JAX package's tools/bench_int8.py calibrates both in one
    scope, where the adapter's Linears, which have no mirror, quantize per
    call; K6 takes bf16 activations, and the adapter is fp32. Returns how
    many scales were calibrated."""
    n = enable_int8_tower(G, sample_imgs)
    prequantize_decoder_mlps(G.synthesis)
    return n + calibrate_int8_act_scales(G.decode, G.encode(sample_imgs), linears=False)

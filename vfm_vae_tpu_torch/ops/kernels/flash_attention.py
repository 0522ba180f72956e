"""K3: flash attention over [null_k; k], [null_v; v] (GigaGAN's learned
null token), forward.

Replaces the TPU kernel vfm_vae_tpu/ops/pallas/flash_attention.py:
flash_attention_nullkv (jax's library Pallas flash kernel behind a
pad-to-128 and segment-id mask); the plain twin below is that file's CPU
path, concat + softmax attention (vfm_vae_tpu/ops/attention.py:68-70).

On the H100 the kernel (csrc/flash_attention_nullkv.cu) is bound by its two
tensor-core products per key tile (~T/2 flops per byte at d=64); the
(T, T+1) logits never reach device memory. The null key and value are read
as key 0 of the walk from their own pointer, so no concat, padding or mask
tensor exists, and every T (64, 256, 1024 in the decoder) runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import check_tensor, library


def flash_attention_nullkv_reference(q, k, v, null_k, null_v, scale: Optional[float] = None):
    """Concat the null token, fp32 logits and softmax, probabilities rounded
    to the input dtype, fp32-accumulated product (jax.nn.dot_product_attention)."""
    dt = q.dtype
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    k = torch.cat([null_k, k], dim=1)
    v = torch.cat([null_v, v], dim=1)
    logits = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(dt)
    return torch.einsum("bnts,bsnh->btnh", probs.float(), v.float()).to(dt)


def flash_attention_nullkv(q, k, v, null_k, null_v, scale: Optional[float] = None, *,
                           plain: bool = False):
    """q, k, v (B, T, N, 64); null_k, null_v (B, 1, N, 64) -> (B, T, N, 64).
    CPU tensors (or plain=True) run the twin; CUDA tensors launch the
    kernel: bf16, contiguous, head dim 64."""
    if plain or q.device.type == "cpu":
        return flash_attention_nullkv_reference(q, k, v, null_k, null_v, scale)
    B, T, N, D = q.shape
    if D != 64:
        raise ValueError(f"flash_attention_nullkv: head dim {D} != 64")
    dev, bf = q.device, torch.bfloat16
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        check_tensor(t, name, bf, (B, T, N, D), dev)
    check_tensor(null_k, "null_k", bf, (B, 1, N, D), dev)
    check_tensor(null_v, "null_v", bf, (B, 1, N, D), dev)
    scale = D ** -0.5 if scale is None else float(scale)
    lib = library()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lib.vfm_flash_attention_nullkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), null_k.data_ptr(), null_v.data_ptr(),
            out.data_ptr(), B, T, N, D, scale, stream,
        )
    lib.check(err, "flash_attention_nullkv")
    flash_attention_nullkv.launches += 1
    return out


flash_attention_nullkv.launches = 0

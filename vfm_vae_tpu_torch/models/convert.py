"""Weights across the two packages.

`state_dict_from_jax` turns the JAX Generator's (params, buffers) pytrees
into a flat reference-layout torch state_dict of numpy arrays: the inverse
of vfm_vae_tpu/models/convert.py:convert_generator for the port's modules
(the vision tower of any family, the adapter in either compression mode
and either form, with the VQ codebooks and usage EMAs, mapping, the
synthesis network: ConvNeXt or legacy StyleGAN-T layers, SynthesisInput's
weights and buffers). `tower_state_dict_from_jax` does it for a tower alone, by the
tables TOWER_MODULES and TOWER_LEAVES; the port's names there are each
tower's checkpoint layout, which the JAX package's importers read
(convert_dinov2, convert_mae, eva.convert_eva_timm, HF Qwen2.5-VL's
`visual`), so such a checkpoint loads into the port as it is.
Numpy only. Layout rules, inverted from that file:

  ours (in, out)              -> torch Linear (out, in)       : W.T
  ours HWIO (kh, kw, I, O)    -> torch Conv2d (O, I, kh, kw)  : transpose(3, 2, 0, 1)
  ours (in, out) 1x1 conv     -> torch (out, in, 1, 1)
  norms, biases, embeddings   -> unchanged

`d_state_dict_from_jax`, `lpips_state_dict_from_jax` and
`inception_state_dict_from_jax` do the same for the JAX
ProjectedDiscriminator (DINO, heads and the heads' spectral-norm u/v
buffers), LPIPS and the InceptionV3 detector, into the port's own key
layout (pytorch-fid's for InceptionV3).

`load_state_dict_numpy` puts such a dict on a port module; arrays whose
element count matches a parameter are reshaped to it, so reference
checkpoints that store vectors as (1, C, 1, 1) load as well.

The JAX package keeps the int8 tower mirror in a separate 'int8' collection
(ops/quantized.py: wq (K, N) int8, ws (N,), as () at each tower Linear's
path), and the decoder's static-int8 MLP mirrors beside it (w1q, ws1, w2q,
ws2, as_u, as_h at each ConvNeXt layer's path under 'synthesis');
`state_dict_from_jax(..., int8=)` carries both into the port's buffers (wq,
w1q and w2q transposed to (N, K)) for every family, `load_state_dict_numpy`
creates those buffers, and `int8_collection_from_state_dict` is the
inverse.

`dit_state_dict_from_jax` does it for the latent DiT (models/dit.py) and
the REG trainer's REPA projector: every Linear kernel is (in, out) in JAX
(layers.py:303) and is transposed; `blocks_{i}` becomes `blocks.{i}`.
"""

from __future__ import annotations

import functools
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .convnext import INT8_BUFFERS

SD = Dict[str, np.ndarray]


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _conv(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def _pw(w) -> np.ndarray:
    """(in, out) pointwise kernel -> torch (out, in, 1, 1)."""
    return _t(w)[:, :, None, None]


def _arr(w) -> np.ndarray:
    return np.array(w, copy=True)


def _linear(sd: SD, p: Mapping[str, Any], prefix: str) -> None:
    sd[prefix + "weight"] = _t(p["weight"])
    if "bias" in p:
        sd[prefix + "bias"] = _arr(p["bias"])


def _norm(sd: SD, p: Mapping[str, Any], prefix: str) -> None:
    sd[prefix + "weight"] = _arr(p["weight"])
    sd[prefix + "bias"] = _arr(p["bias"])


# Each tower's modules: JAX module path -> the port's module name under the
# tower, "{i}" a block index. A mapped module's leaves keep their names; a
# 2-D "weight" (a Linear kernel, (in, out) in JAX) is transposed. The port's
# names are each checkpoint's own: HF SiglipVisionTransformer, HF
# Dinov2Model and ViTMAEModel (vfm_vae_tpu/models/convert.py:329, :365),
# EVA-02 as vfm_vae_tpu/models/eva.py:convert_eva_timm reads it, HF
# Qwen2.5-VL's vision tower (tests/test_qwen.py:convert_qwen).
_HF_ATTN = (("layers_{i}/attn/q_proj", "encoder.layer.{i}.attention.attention.query"),
            ("layers_{i}/attn/k_proj", "encoder.layer.{i}.attention.attention.key"),
            ("layers_{i}/attn/v_proj", "encoder.layer.{i}.attention.attention.value"),
            ("layers_{i}/attn/out_proj", "encoder.layer.{i}.attention.output.dense"),
            ("layernorm", "layernorm"))
TOWER_MODULES = {
    "siglip": tuple((f"layers_{{i}}/{a}", f"encoder.layers.{{i}}.{b}") for a, b in (
        ("norm1", "layer_norm1"), ("norm2", "layer_norm2"), ("attn/q_proj", "self_attn.q_proj"),
        ("attn/k_proj", "self_attn.k_proj"), ("attn/v_proj", "self_attn.v_proj"),
        ("attn/out_proj", "self_attn.out_proj"), ("mlp/fc1", "mlp.fc1"), ("mlp/fc2", "mlp.fc2")))
    + (("post_layernorm", "post_layernorm"), ("head/out_proj", "head.attention.out_proj"),
       ("head/layernorm", "head.layernorm"), ("head/mlp/fc1", "head.mlp.fc1"),
       ("head/mlp/fc2", "head.mlp.fc2")),
    "dinov2": _HF_ATTN + (("layers_{i}/norm1", "encoder.layer.{i}.norm1"),
                          ("layers_{i}/norm2", "encoder.layer.{i}.norm2"),
                          ("layers_{i}/mlp/fc1", "encoder.layer.{i}.mlp.fc1"),
                          ("layers_{i}/mlp/fc2", "encoder.layer.{i}.mlp.fc2")),
    "mae": _HF_ATTN + (("layers_{i}/norm1", "encoder.layer.{i}.layernorm_before"),
                       ("layers_{i}/norm2", "encoder.layer.{i}.layernorm_after"),
                       ("layers_{i}/mlp/fc1", "encoder.layer.{i}.intermediate.dense"),
                       ("layers_{i}/mlp/fc2", "encoder.layer.{i}.output.dense")),
    "eva": tuple((f"blocks_{{i}}/{a}", f"blocks.{{i}}.{b}") for a, b in (
        ("norm1", "norm1"), ("norm2", "norm2"), ("attn/q_proj", "attn.q_proj"),
        ("attn/k_proj", "attn.k_proj"), ("attn/v_proj", "attn.v_proj"), ("attn/norm", "attn.norm"),
        ("attn/proj", "attn.proj"), ("mlp/w1", "mlp.w1"), ("mlp/w2", "mlp.w2"),
        ("mlp/norm", "mlp.ffn_ln"), ("mlp/w3", "mlp.w3"))),
    "qwen": tuple((f"blocks_{{i}}/{a}", f"blocks.{{i}}.{b}") for a, b in (
        ("norm1", "norm1"), ("norm2", "norm2"), ("qkv", "attn.qkv"), ("proj", "attn.proj"),
        ("gate_proj", "mlp.gate_proj"), ("up_proj", "mlp.up_proj"),
        ("down_proj", "mlp.down_proj")))
    + (("merger_ln_q", "merger.ln_q"), ("merger_fc1", "merger.mlp.0"),
       ("merger_fc2", "merger.mlp.2")),
}


def _leaves(tree: Mapping[str, Any], path: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _with_batch_axis(w) -> np.ndarray:
    return _arr(w)[None]


# Leaves whose name or layout differs between the packages.
_PATCH = ("patch_embedding_weight", "patch_embedding_bias")
TOWER_LEAVES = {
    "siglip": ((_PATCH[0], "embeddings.patch_embedding.weight", _conv),
               (_PATCH[1], "embeddings.patch_embedding.bias", _arr),
               ("position_embedding", "embeddings.position_embedding.weight", _arr),
               ("head/probe", "head.probe", _arr),
               ("head/in_proj_weight", "head.attention.in_proj_weight", _arr),
               ("head/in_proj_bias", "head.attention.in_proj_bias", _arr)),
    "dinov2": ((_PATCH[0], "embeddings.patch_embeddings.projection.weight", _conv),
               (_PATCH[1], "embeddings.patch_embeddings.projection.bias", _arr),
               ("cls_token", "embeddings.cls_token", _arr),
               ("position_embeddings", "embeddings.position_embeddings", _with_batch_axis),
               ("layers_{i}/ls1", "encoder.layer.{i}.layer_scale1.lambda1", _arr),
               ("layers_{i}/ls2", "encoder.layer.{i}.layer_scale2.lambda1", _arr)),
    "mae": ((_PATCH[0], "embeddings.patch_embeddings.projection.weight", _conv),
            (_PATCH[1], "embeddings.patch_embeddings.projection.bias", _arr),
            ("cls_token", "embeddings.cls_token", _arr),
            # A buffer in JAX (the fixed sin-cos table).
            ("position_embeddings", "embeddings.position_embeddings", _with_batch_axis)),
    "eva": ((_PATCH[0], "patch_embed.proj.weight", _conv),
            (_PATCH[1], "patch_embed.proj.bias", _arr),
            ("cls_token", "cls_token", _arr),
            ("pos_embed", "pos_embed", _with_batch_axis)),
    # (C tp p p, D) -> (D, C tp p p); loading reshapes it to the Conv3d weight.
    "qwen": (("patch_embed", "patch_embed.proj.weight", _t),),
}
_TOWER = "vfm_encoder.encoder.vision_model.vision_model."
_TOWERS = "vfm_encoder.encoder."
INT8_LEAVES = ("wq", "ws", "as")
# Keys only one tower's tree has, in JAX and in the port.
_FAMILY_MARKS = (("siglip", "post_layernorm/weight", "post_layernorm.weight"),
                 ("qwen", "merger_ln_q/weight", "merger.ln_q.weight"),
                 ("eva", "pos_embed", "pos_embed"),
                 ("dinov2", "layers_0/ls1", "encoder.layer.0.layer_scale1.lambda1"),
                 ("mae", "layers_0/norm1/weight", "encoder.layer.0.layernorm_before.weight"))


@functools.lru_cache(maxsize=None)
def _template(t: str) -> "re.Pattern":
    return re.compile(re.escape(t).replace(r"\{i\}", r"(\d+)") + "$")


def _rename(pairs, name: str, reverse: bool = False) -> Optional[str]:
    """`name` through the first (src, dst) template pair that matches it."""
    for src, dst in pairs:
        if reverse:
            src, dst = dst, src
        m = _template(src).match(name)
        if m:
            return dst.replace("{i}", m.group(1)) if m.groups() else dst
    return None


def tower_family(tree_or_keys) -> str:
    """The tower family of a JAX tower tree (its leaves' "/" paths) or of
    the port's tower keys."""
    keys = ({"/".join(p) for p, _ in _leaves(tree_or_keys)}
            if isinstance(tree_or_keys, Mapping) else set(tree_or_keys))
    for family, jax_key, port_key in _FAMILY_MARKS:
        if jax_key in keys or port_key in keys:
            return family
    raise ValueError("not a VFM tower's parameters")


def tower_state_dict_from_jax(params: Mapping[str, Any], buffers: Optional[Mapping[str, Any]]
                              = None, prefix: str = "",
                              int8: Optional[Mapping[str, Any]] = None) -> SD:
    """A JAX tower's (params, buffers) -> the port tower's state_dict
    (numpy), keys under `prefix`; `int8` (the tower's subtree of the JAX
    'int8' collection) becomes the Linears' wq (transposed), ws and as.
    DINOv2's mask token, which no JAX path reads, is zero."""
    family = tower_family(params)
    sd: SD = {}
    for path, v in list(_leaves(params)) + list(_leaves(buffers or {})):
        key = "/".join(path)
        for src, dst, fn in TOWER_LEAVES[family]:
            m = _template(src).match(key)
            if m:
                sd[prefix + (dst.replace("{i}", m.group(1)) if m.groups() else dst)] = fn(v)
                break
        else:
            name = _rename(TOWER_MODULES[family], "/".join(path[:-1]))
            if name is None:
                raise KeyError(f"{family} tower: no port name for {key}")
            leaf = path[-1]
            sd[prefix + name + "." + leaf] = _t(v) if leaf == "weight" and np.ndim(v) == 2 \
                else _arr(v)
    if family == "dinov2":
        sd[prefix + "embeddings.mask_token"] = np.zeros((1, sd[prefix + "layernorm.weight"].size),
                                                        np.float32)
    for path, v in _leaves(int8 or {}):
        name = _rename(TOWER_MODULES[family], "/".join(path[:-1]))
        sd[prefix + name + "." + path[-1]] = _t(v) if path[-1] == "wq" else _arr(v)
    return sd


def int8_collection_from_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's int8 buffers (wq, ws, as of the tower's Linears; the
    decoder MLP mirrors of the ConvNeXt layers) -> the JAX 'int8'
    collection {'vfm_encoder': {'tower': ...}, 'synthesis': ...}, numpy
    leaves."""
    out: Dict[str, Any] = {}
    synthesis: Dict[str, Any] = {}
    for key, val in sd.items():
        m = re.match(r"synthesis\.blocks\.(\d+)\.(conv0|convs1\.(\d+))\.(\w+)$", key)
        if m and m.group(4) in DECODER_INT8_LEAVES:
            layer = "conv0" if m.group(2) == "conv0" else f"convs1_{m.group(3)}"
            leaf = m.group(4)
            synthesis.setdefault(f"b{m.group(1)}", {}).setdefault(layer, {})[leaf] = (
                _t(val) if leaf in ("w1q", "w2q") else _arr(val))
    if synthesis:
        out["synthesis"] = synthesis
    prefix = _TOWER if any(k.startswith(_TOWER) for k in sd) else _TOWERS
    names = [k[len(prefix):] for k in sd if k.startswith(prefix)]
    if not names:
        return out
    family = tower_family(names)
    tower: Dict[str, Any] = {}
    for key, val in sd.items():
        name, _, leaf = key.rpartition(".")
        if not key.startswith(prefix) or leaf not in INT8_LEAVES:
            continue
        node = tower
        for k in _rename(TOWER_MODULES[family], name[len(prefix):], reverse=True).split("/"):
            node = node.setdefault(k, {})
        node[leaf] = _t(val) if leaf == "wq" else _arr(val)
    if tower:
        out["vfm_encoder"] = {"tower": tower}
    return out


def _attn_projection(sd: SD, p: Mapping[str, Any], prefix: str) -> None:
    j = 0
    while f"blocks_{j}" in p:
        bp, q = prefix + f"blocks.{j}.", p[f"blocks_{j}"]
        for n in ("norm1", "norm2", "norm3"):
            _norm(sd, q[n], bp + n + ".")
        sd[bp + "attn.qkv.weight"] = _t(q["attn"]["qkv"])
        sd[bp + "attn.q_bias"] = _arr(q["attn"]["q_bias"])
        sd[bp + "attn.v_bias"] = _arr(q["attn"]["v_bias"])
        _linear(sd, q["attn"]["proj"], bp + "attn.proj.")
        _linear(sd, q["proj"], bp + "proj.")
        _norm(sd, q["mlp"]["norm"], bp + "mlp.norm.")
        for w in ("w0", "w1", "w2"):
            _linear(sd, q["mlp"][w], bp + f"mlp.{w}.")
        j += 1


def _compress(sd: SD, p: Mapping[str, Any], prefix: str) -> None:
    """An attnproj stack, or a conv-mode Linear (a 1x1 convolution in the reference)."""
    if "weight" in p:
        sd[prefix + "weight"] = _pw(p["weight"])
        sd[prefix + "bias"] = _arr(p["bias"])
    else:
        _attn_projection(sd, p, prefix)


def _adapter(sd: SD, p: Mapping[str, Any], prefix: str,
             b: Optional[Mapping[str, Any]] = None) -> None:
    i = 0
    while f"patch_quant_{i}" in p:
        _compress(sd, p[f"patch_quant_{i}"], prefix + f"patch_quants.{i}.0.")
        i += 1
    _compress(sd, p["final_quant"], prefix + "final_quant.")
    _compress(sd, p["post_quant"], prefix + "post_quant.")
    if "linear_proj" in p:
        sd[prefix + "linear_proj.weight"] = _pw(p["linear_proj"]["weight"])
    # The discrete mode's codebooks and usage EMAs (convert.py:313-325); the
    # usage record counter is not in the reference layout.
    q, qb = p.get("quantizer", {}), (b or {}).get("quantizer", {})
    j = 0
    while f"codebook_{j}" in q:
        cp = prefix + f"quantizer.codebooks.{j}."
        sd[cp + "codebook.weight"] = _arr(q[f"codebook_{j}"]["codebook"])
        sd[cp + "vocab_usage"] = _arr(qb[f"codebook_{j}"]["vocab_usage"])
        j += 1


def _style_split(sd: SD, p: Mapping[str, Any], prefix: str) -> None:
    _linear(sd, p["proj"], prefix + "proj.")


def _convnext_layer(sd: SD, p: Mapping[str, Any], b: Mapping[str, Any], prefix: str,
                    legacy: bool) -> None:
    _style_split(sd, p["affine_pw1"], prefix + "affine_pw1.")
    sd[prefix + "dwconv.weight"] = _conv(p["dwconv"]["weight"])
    sd[prefix + "dwconv.bias"] = _arr(p["dwconv"]["bias"])
    _norm(sd, p["norm"], prefix + "norm.")
    sd[prefix + "pwconv1.weight"] = _pw(p["pwconv1"]["weight"])
    sd[prefix + "pwconv1.bias"] = _arr(p["pwconv1"]["bias"])
    sd[prefix + "pwconv2.weight"] = _conv(p["pwconv2"]["weight"])
    sd[prefix + "pwconv2.bias"] = _arr(p["pwconv2"]["bias"])
    sd[prefix + "gamma"] = _arr(p["gamma"])
    if legacy:
        sd[prefix + "noise_strength"] = _arr(p["noise_strength"])
        sd[prefix + "noise_const"] = _arr(b["noise_const"])


def _separable_upsample(sd: SD, p: Mapping[str, Any], prefix: str) -> None:
    _norm(sd, p["norm"], prefix + "norm.")
    sd[prefix + "depthwise.weight"] = _conv(p["depthwise"]["weight"])
    sd[prefix + "pointwise.weight"] = _conv(p["pointwise"]["weight"])


def _self_attention_block(sd: SD, p: Mapping[str, Any], prefix: str) -> None:
    a, f = p["attn"], p["ff"]
    sd[prefix + "attn.norm.gamma"] = _arr(a["norm"]["gamma"]).reshape(-1, 1, 1)
    for n in ("to_q", "to_k", "to_v", "to_out"):
        sd[prefix + f"attn.{n}.weight"] = _conv(a[n]["weight"])
    sd[prefix + "attn.null_kv"] = _arr(a["null_kv"])
    sd[prefix + "ff.0.gamma"] = _arr(f["norm"]["gamma"]).reshape(-1, 1, 1)
    for ours, theirs in (("proj1", "1"), ("proj2", "3")):
        sd[prefix + f"ff.{theirs}.weight"] = _conv(f[ours]["weight"])
        sd[prefix + f"ff.{theirs}.bias"] = _arr(f[ours]["bias"])


def _synthesis_layer(sd: SD, p: Mapping[str, Any], b: Mapping[str, Any], prefix: str) -> None:
    """A legacy StyleGAN-T SynthesisLayer (the reference's names, as
    tests/test_legacy_synthesis.py reads them)."""
    _style_split(sd, p["affine"], prefix + "affine.")
    sd[prefix + "weight"] = _conv(p["weight"])
    sd[prefix + "bias"] = _arr(p["bias"])
    if "noise_strength" in p:
        sd[prefix + "noise_strength"] = _arr(p["noise_strength"])
        sd[prefix + "noise_const"] = _arr(b["noise_const"])
    if "norm" in p:
        _norm(sd, p["norm"], prefix + "norm.")
        sd[prefix + "gamma"] = _arr(p["gamma"])


def _synthesis_input(sd: SD, p: Mapping[str, Any], b: Mapping[str, Any], prefix: str) -> None:
    """SynthesisInput (vfm_vae_tpu/models/convert.py:553 convert_synthesis_input)."""
    sd[prefix + "weight"] = _arr(p["weight"])
    _linear(sd, p["affine"], prefix + "affine.")
    for name in ("freqs", "phases", "transform"):
        sd[prefix + name] = _arr(b[name])


def _decoder_layer(sd: SD, p: Mapping[str, Any], b: Mapping[str, Any], prefix: str,
                   legacy: bool) -> None:
    if "dwconv" in p:
        _convnext_layer(sd, p, b, prefix, legacy)
    else:
        _synthesis_layer(sd, p, b, prefix)


def _synthesis_block(sd: SD, p: Mapping[str, Any], b: Mapping[str, Any], prefix: str,
                     legacy: bool) -> None:
    if "input" in p:
        _synthesis_input(sd, p["input"], b["input"], prefix + "input.")
    if "seperate_upsample_conv" in p:
        _separable_upsample(sd, p["seperate_upsample_conv"], prefix + "seperate_upsample_conv.")
    if "conv0" in p:
        _decoder_layer(sd, p["conv0"], b.get("conv0", {}), prefix + "conv0.", legacy)
    i = 0
    while f"convs1_{i}" in p:
        _decoder_layer(sd, p[f"convs1_{i}"], b.get(f"convs1_{i}", {}),
                       prefix + f"convs1.{i}.", legacy)
        i += 1
    if "torgb" in p:
        t = p["torgb"]
        sd[prefix + "torgb.weight"] = _conv(t["weight"])
        sd[prefix + "torgb.bias"] = _arr(t["bias"])
        _style_split(sd, t["affine"], prefix + "torgb.affine.")
    if "last_upsample_conv" in p:
        _separable_upsample(sd, p["last_upsample_conv"], prefix + "last_upsample_conv.")
    i = 0
    while f"self_attns_{i}" in p:
        _self_attention_block(sd, p[f"self_attns_{i}"], prefix + f"self_attns.{i}.")
        i += 1


def _zconv(sd: SD, p: Mapping[str, Any], prefix: str, kind: str) -> None:
    i3, i1 = {"down": (1, 2), "same": (0, 1), "up": (0, 2)}[kind]
    sd[prefix + f"{i3}.0.weight"] = _conv(p["conv0_dw"]["weight"])
    sd[prefix + f"{i3}.1.weight"] = _conv(p["conv0_pw"]["weight"])
    _norm(sd, p["conv0_gn"], prefix + f"{i3}.2.")
    sd[prefix + f"{i1}.0.weight"] = _conv(p["conv1_pw"]["weight"])
    _norm(sd, p["conv1_gn"], prefix + f"{i1}.1.")


def state_dict_from_jax(params: Mapping[str, Any], buffers: Mapping[str, Any], *,
                        geometry: Mapping[str, Any],
                        int8: Optional[Mapping[str, Any]] = None) -> SD:
    """JAX Generator variables -> reference-layout torch state_dict (numpy).

    geometry: z_resolution, block_resolutions, concat_z_block_indices and
    legacy, the arguments convert_generator takes for the same tree. int8:
    the JAX 'int8' collection, whose tower mirror becomes the Linears'
    wq / ws / as buffers."""
    legacy = bool(geometry.get("legacy", False))
    z_res = int(geometry["z_resolution"])
    concat = list(geometry.get("concat_z_block_indices", ()))
    buffers = buffers or {}
    sd: SD = {}
    if "vfm_encoder" in params:
        tower = params["vfm_encoder"]["tower"]
        sd.update(tower_state_dict_from_jax(
            tower, buffers.get("vfm_encoder", {}).get("tower"),
            _TOWER if tower_family(tower) == "siglip" else _TOWERS,
            (int8 or {}).get("vfm_encoder", {}).get("tower")))
    _adapter(sd, params["ldm_adapter"], "ldm_adapter.", buffers.get("ldm_adapter", {}))
    for fc, q in params["mapping"]["mlp"].items():
        _linear(sd, q, f"mapping.mlp.{fc}.")
    if "x_avg" in buffers.get("mapping", {}):
        sd["mapping.x_avg"] = _arr(buffers["mapping"]["x_avg"])
    syn_p, syn_b = params["synthesis"], buffers.get("synthesis", {})
    for idx, res in enumerate(geometry["block_resolutions"]):
        _synthesis_block(sd, syn_p[f"b{idx}"], syn_b.get(f"b{idx}", {}),
                         f"synthesis.blocks.{idx}.", legacy)
        if idx in concat:
            kind = "down" if res < 2 * z_res else ("same" if res == 2 * z_res else "up")
            _zconv(sd, syn_p[f"z_convs_{idx}"], f"synthesis.z_convs.{idx}.", kind)
    sd.update(decoder_int8_state_dict_from_jax((int8 or {}).get("synthesis", {})))
    return sd


# The decoder's static-int8 ConvNeXt MLP mirrors (vfm_vae_tpu/ops/quantized.py:
# prequantize_decoder_mlps, calibrate_int8_act_scales) at each layer's path:
# w1q (C, 4C) and w2q (4C, C) int8 in JAX, (4C, C) and (C, 4C) in the port.
DECODER_INT8_LEAVES = INT8_BUFFERS


def _synthesis_layer_name(path) -> str:
    """JAX synthesis module path (b{idx}, conv0 | convs1_{i}) -> the port's name."""
    blk, layer = path
    layer = "conv0" if layer == "conv0" else "convs1." + layer[len("convs1_"):]
    return f"synthesis.blocks.{blk[1:]}.{layer}"


def decoder_int8_state_dict_from_jax(tree: Mapping[str, Any]) -> SD:
    """The 'synthesis' subtree of the JAX 'int8' collection -> the port's
    ConvNeXt-layer buffers (w1q and w2q transposed to (N, K))."""
    sd: SD = {}
    for path, v in _leaves(tree):
        name = _synthesis_layer_name(path[:-1]) + "." + path[-1]
        sd[name] = _t(v) if path[-1] in ("w1q", "w2q") else _arr(v)
    return sd


def _vit_block(sd: SD, q: Mapping[str, Any], prefix: str) -> None:
    _norm(sd, q["norm1"], prefix + "layer_norm1.")
    _norm(sd, q["norm2"], prefix + "layer_norm2.")
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(sd, q["attn"][proj], prefix + f"self_attn.{proj}.")
    for fc in ("fc1", "fc2"):
        _linear(sd, q["mlp"][fc], prefix + f"mlp.{fc}.")


def d_state_dict_from_jax(params: Mapping[str, Any], buffers: Mapping[str, Any]) -> SD:
    """JAX ProjectedDiscriminator variables -> the port's state_dict (numpy):
    dino.*, heads.N.{main0,main1}.{conv,bn}.*, heads.N.cls.* and, with the
    PatchGAN branch, patchgan.scaleS.convN.* (HWIO -> OIHW) and
    patchgan.scaleS.bnN.*."""
    sd: SD = {}
    dino = params["dino"]
    sd["dino.patch_embed.weight"] = _conv(dino["patch_weight"])
    sd["dino.patch_embed.bias"] = _arr(dino["patch_bias"])
    sd["dino.cls_token"] = _arr(dino["cls_token"])
    sd["dino.pos_embed"] = _arr(dino["pos_embed"])
    i = 0
    while f"blocks_{i}" in dino:
        _vit_block(sd, dino[f"blocks_{i}"], f"dino.blocks.{i}.")
        i += 1
    i = 0
    while f"heads_{i}" in params:
        hp, hb = params[f"heads_{i}"], (buffers or {}).get(f"heads_{i}", {})
        for conv, path in ((hp["main0"]["conv"], ("main0", "conv")),
                           (hp["main1"]["conv"], ("main1", "conv")), (hp["cls"], ("cls",))):
            prefix = f"heads.{i}." + ".".join(path) + "."
            sd[prefix + "weight"] = _arr(conv["weight"])
            sd[prefix + "bias"] = _arr(conv["bias"])
            b = hb
            for k in path:
                b = b[k]
            sd[prefix + "u"], sd[prefix + "v"] = _arr(b["u"]), _arr(b["v"])
        for blk in ("main0", "main1"):
            _norm(sd, hp[blk]["bn"], f"heads.{i}.{blk}.bn.")
        i += 1
    if "patchgan" in params:
        sd.update(patchgan_state_dict_from_jax(params["patchgan"], "patchgan."))
    return sd


def patchgan_state_dict_from_jax(params: Mapping[str, Any], prefix: str = "") -> SD:
    """JAX MultiscaleDiscriminator params -> the port's state_dict (numpy):
    scaleS.convN.{weight (HWIO -> OIHW), bias}, scaleS.bnN.{weight, bias}."""
    sd: SD = {}
    for scale, sp in sorted(params.items()):
        for name, q in sorted(sp.items()):
            p = f"{prefix}{scale}.{name}."
            if name.startswith("conv"):
                sd[p + "weight"] = _conv(q["weight"])
                sd[p + "bias"] = _arr(q["bias"])
            else:
                _norm(sd, q, p)
    return sd


def lpips_state_dict_from_jax(params: Mapping[str, Any]) -> SD:
    """JAX LPIPS params -> the port's state_dict (numpy): net.conv{i}.*, lin{k}.weight."""
    sd: SD = {}
    net = params["net"]
    i = 0
    while f"conv{i}_weight" in net:
        sd[f"net.conv{i}.weight"] = _conv(net[f"conv{i}_weight"])
        sd[f"net.conv{i}.bias"] = _arr(net[f"conv{i}_bias"])
        i += 1
    k = 0
    while f"lin{k}_weight" in params:
        sd[f"lin{k}.weight"] = _t(params[f"lin{k}_weight"])[:, :, None, None]
        k += 1
    return sd


def inception_state_dict_from_jax(params: Mapping[str, Any], buffers: Mapping[str, Any]) -> SD:
    """JAX InceptionV3Features (params, buffers) -> the port's state_dict
    (numpy), which is pytorch-fid's layout: <path>.conv.weight (OIHW),
    <path>.bn.{weight,bias,running_mean,running_var}, fc.weight, fc.bias."""
    sd: SD = {}
    for path, w in _leaves(params):
        prefix = ".".join(path[:-1])
        if path[-1] == "conv":
            node = buffers
            for k in path[:-1]:
                node = node[k]
            sd[prefix + ".conv.weight"] = _conv(w)
            sd[prefix + ".bn.running_mean"] = _arr(node["bn_mean"])
            sd[prefix + ".bn.running_var"] = _arr(node["bn_var"])
        elif path[-1] in ("bn_weight", "bn_bias"):
            sd[prefix + ".bn." + path[-1][3:]] = _arr(w)
    if "fc_weight" in params:
        sd["fc.weight"] = _t(params["fc_weight"])
        sd["fc.bias"] = _arr(params["fc_bias"])
    return sd


def dit_state_dict_from_jax(params: Mapping[str, Any]) -> SD:
    """A JAX LightningDiT (or REPA projector) parameter tree -> the port's
    state_dict: a leaf `weight` of two axes is a Linear kernel and is
    transposed, and the tables (`pos_embed`, `y_embedding`) and norm
    weights are copied. A REPA trainer's {"dit", "proj"} tree maps to keys
    under "dit." and "proj."."""
    sd: SD = {}
    for path, v in _leaves(params):
        name = ".".join(k.replace("blocks_", "blocks.") for k in path)
        sd[name] = _t(v) if path[-1] == "weight" and np.ndim(v) == 2 else _arr(v)
    return sd


def geometry_from_kwargs(kwargs: Mapping[str, Any]) -> Dict[str, Any]:
    """The `geometry` of state_dict_from_jax for Generator keyword arguments."""
    from .synthesis import synthesis_channels

    sk = dict(kwargs.get("synthesis_kwargs") or {})
    img_res = kwargs.get("img_resolution", 256)
    return dict(
        legacy=kwargs.get("legacy", False),
        z_resolution=img_res // kwargs.get("resolution_compression_factor", 16),
        concat_z_block_indices=list(kwargs.get("concat_z_block_indices", ())),
        block_resolutions=synthesis_channels(img_res, kwargs.get("num_blocks", 6),
                                             sk.get("channel_base", 32768),
                                             sk.get("channel_max", 512))[0],
    )


@torch.no_grad()
def load_state_dict_numpy(module: torch.nn.Module, sd: Mapping[str, np.ndarray]) -> None:
    """Copy a numpy state_dict into `module` (strict on keys), onto each
    parameter's own device and dtype; equal-size arrays are reshaped. int8
    mirror entries (wq, ws, as of a Linear; w1q, ws1, w2q, ws2, as_u, as_h
    of a ConvNeXt layer) create their buffers on the module."""
    for key, src in sd.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf in INT8_LEAVES + DECODER_INT8_LEAVES:
            sub = module.get_submodule(prefix)
            if getattr(sub, leaf) is None:
                dtype = torch.int8 if leaf in ("wq", "w1q", "w2q") else torch.float32
                setattr(sub, leaf, torch.empty(np.shape(src), dtype=dtype,
                                               device=next(sub.parameters()).device))
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing {missing[:8]}, unexpected {unexpected[:8]}")
    for key, dst in own.items():
        src = np.asarray(sd[key])
        if src.size != dst.numel():
            raise ValueError(f"{key}: {src.shape} does not fit {tuple(dst.shape)}")
        dt = np.int8 if dst.dtype == torch.int8 else np.float32
        dst.copy_(torch.from_numpy(np.array(src, dtype=dt)).reshape(dst.shape))


def load_jax_variables(module: torch.nn.Module, params: Mapping[str, Any],
                       buffers: Mapping[str, Any], *, geometry: Mapping[str, Any],
                       int8: Optional[Mapping[str, Any]] = None) -> None:
    """Put JAX Generator variables (and its 'int8' collection) onto a port Generator."""
    load_state_dict_numpy(module, state_dict_from_jax(params, buffers, geometry=geometry,
                                                      int8=int8))


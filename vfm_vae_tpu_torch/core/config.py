"""Config objects and the YAML schema (port of vfm_vae_tpu/core/config.py;
reference dnnlib/util.py:39 EasyDict and train.py:45-114).

A YAML file loads into nested EasyDicts; `derive_config` back-fills the
cross-component flags the reference derives; `to_plain` turns the result
back into plain dicts for yaml.safe_dump.
"""

from __future__ import annotations

import copy
from typing import Any

import yaml


class EasyDict(dict):
    """dict with attribute access (reference: dnnlib/util.py:39)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]


def recursive_easydict(obj: Any) -> Any:
    """Recursively convert mappings to EasyDict (reference: train.py:45-52)."""
    if isinstance(obj, dict):
        return EasyDict({k: recursive_easydict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(recursive_easydict(v) for v in obj)
    return obj


def to_plain(obj: Any) -> Any:
    """Recursively convert EasyDicts back to plain dicts and tuples to lists
    (yaml.safe_dump represents neither dict subclasses nor tuples)."""
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_plain(v) for v in obj]
    return obj


def load_config(path: str) -> EasyDict:
    with open(path, "r") as f:
        cfg = yaml.safe_load(f)
    return recursive_easydict(cfg)


def derive_config(c: EasyDict) -> EasyDict:
    """Back-fill cross-component flags (reference train.py:66-114): G_kwargs
    inherits resolution and conditioning from the training set, the loss
    weights switch the generator's auxiliary losses, and the discriminator
    and the loss learn which VFM the generator uses."""
    c = copy.deepcopy(c)
    ts = c.get("training_set_kwargs", EasyDict())
    G = c.setdefault("G_kwargs", EasyDict())
    D = c.setdefault("D_kwargs", EasyDict())
    L = c.setdefault("loss_kwargs", EasyDict())

    if "resolution" in ts:
        G.setdefault("img_resolution", ts.resolution)
    if "conditional" in ts:
        G.setdefault("conditional", ts.conditional)
    if "label_type" in ts:
        G.setdefault("label_type", ts.label_type)
    G.setdefault("label_dim", ts.get("label_dim", 0))

    G.setdefault("use_kl_loss", float(L.get("kl_loss_weight", 0.0)) > 0)
    G.setdefault("use_vf_loss", float(L.get("vf_loss_weight", 0.0)) > 0)
    G.setdefault("use_adaptive_vf_loss", bool(L.get("use_adaptive_vf_loss", False)))
    G.setdefault(
        "use_equivariance_regularization",
        bool(L.get("use_equivariance_regularization", False)),
    )
    ms_weights = L.get("multiscale_pixel_loss_weights", [])
    G.setdefault("use_multiscale_output", len(ms_weights) > 0)

    if "vfm_name" in G:
        D.setdefault("vfm_name", G.vfm_name)
        L.setdefault("vfm_name", G.vfm_name)
    if "compression_mode" in G:
        L.setdefault("compression_mode", G.compression_mode)
    L.setdefault("resume_kimg", c.get("resume_kimg", 0))
    return c

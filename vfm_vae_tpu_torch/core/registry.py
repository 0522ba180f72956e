"""Class registry (port of vfm_vae_tpu/core/registry.py; reference
dnnlib/util.py:301 construct_class_by_name).

The reference YAMLs name torch classes (`networks.generator.Generator`);
each name maps onto the port's implementation, resolved lazily. A name
the port does not know raises: there is no dotted-path import fallback.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

_ALIASES: Dict[str, str] = {
    "networks.generator.Generator": "vfm_vae_tpu_torch.models.generator:Generator",
    "networks.discriminator.ProjectedDiscriminator":
        "vfm_vae_tpu_torch.models.discriminator:ProjectedDiscriminator",
    "training.loss.TotalLoss": "vfm_vae_tpu_torch.train.loss:TotalLoss",
    "training.data_wds.WdsWrapper": "vfm_vae_tpu_torch.data.wds:WdsWrapper",
    "torch.optim.Adam": "vfm_vae_tpu_torch.train.optim:adam",
}
# Known to the JAX package, not ported yet.
_UNPORTED = ("training.data_zip.ImageFolderDataset",)


def get_class_by_name(name: str) -> Any:
    if name in _UNPORTED:
        raise NotImplementedError(f"{name} is not ported")
    target = _ALIASES.get(name)
    if target is None:
        raise KeyError(f"unknown class name {name!r}; known: {sorted(_ALIASES)}")
    mod_name, attr = target.split(":")
    return getattr(importlib.import_module(mod_name), attr)


def construct_class_by_name(*args, class_name: str, **kwargs) -> Any:
    """Build an instance from a config's class_name."""
    return get_class_by_name(class_name)(*args, **kwargs)

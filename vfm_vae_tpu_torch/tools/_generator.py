"""What the model tools share (port of
tools/preprocess_for_lightningdit/prefetch.py:41 build_generator): the
device choice, the Generator from a YAML config with the evaluation
overrides and a snapshot's weights, and the account of where a tool's time
went."""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import torch

from ..core.profiling import PhaseTimer

# The reference's evaluation overrides (reconstruct.py:106-113): no
# auxiliary losses, so no VF projection and no EQ draws.
EVAL_OVERRIDES = dict(use_kl_loss=False, use_vf_loss=False, use_adaptive_vf_loss=False,
                      use_equivariance_regularization=False)


def resolve_device(name: str, tool: str) -> torch.device:
    """torch.device(name); a CUDA device that is not there fails by name."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device (--device cpu runs on the CPU)")
    return dev


def snapshot_state_dict(snapshot: str) -> dict:
    """The generator weights of `snapshot`: a port snapshot directory
    (train/checkpoint.py; G_ema.pt, else G.pt, as the JAX tools take
    ema_params, else g_params), or a reference-layout .pth holding
    {G, D, G_ema} state dicts (G_ema taken, else G) or one state dict."""
    if os.path.isdir(snapshot):
        name = next((n for n in ("G_ema.pt", "G.pt")
                     if os.path.isfile(os.path.join(snapshot, n))), None)
        if name is None:
            raise FileNotFoundError(f"{snapshot} holds neither G_ema.pt nor G.pt")
        return torch.load(os.path.join(snapshot, name), map_location="cpu", weights_only=True)
    obj = torch.load(snapshot, map_location="cpu", weights_only=True)
    for key in ("G_ema", "G"):
        if isinstance(obj.get(key), dict):
            return obj[key]
    return obj


def build_generator(config_path: str, snapshot: str, device: torch.device,
                    dtype: Optional[str] = None) -> Tuple[torch.nn.Module, dict]:
    """(G, derived config): the YAML's G_kwargs with EVAL_OVERRIDES, built
    through the registry in `dtype` (default: the config's compute_dtype,
    bfloat16 unless it says float32; the kernels run in bf16), weights from
    `snapshot` (every key the generator has must be there; keys it lacks,
    such as the training-only VF projection, are ignored). TF32 stays off."""
    from ..core.config import derive_config, load_config
    from ..core.registry import construct_class_by_name
    from ..entry import configure_precision
    from ..models.convert import load_state_dict_numpy

    configure_precision()
    c = derive_config(load_config(config_path))
    gk = {k: v for k, v in c["G_kwargs"].items() if k != "class_name"}
    gk.update(EVAL_OVERRIDES)
    dtype = dtype or c.get("compute_dtype", "bfloat16")
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"dtype {dtype!r}: bfloat16 or float32")
    G = construct_class_by_name(
        class_name=c["G_kwargs"].get("class_name", "networks.generator.Generator"),
        dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32, device=device,
        generator=torch.Generator(device=device).manual_seed(0), **gk)
    sd = snapshot_state_dict(snapshot)
    own = G.state_dict()
    load_state_dict_numpy(G, {k: (v.float() if v.is_floating_point() else v).numpy()
                              for k, v in sd.items() if k in own})
    return G.eval(), c


_END = object()


class ToolClock:
    """Where a tool's time goes: `setup` (building the networks and loading
    their weights, host clock), `model` spans (the networks' work: CUDA
    events on the card, the host clock on the CPU) and `host` spans (image
    and file work on the host clock: JPEG/PNG decode and encode, crops,
    safetensors I/O), beside the wall time from construction to `report`."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._model = PhaseTimer(device)
        self._host = PhaseTimer("cpu")
        self.t0 = time.perf_counter()

    def setup(self):
        return self._host.phase("setup")

    def model(self):
        return self._model.phase("model")

    def host(self):
        return self._host.phase("host")

    def timed(self, batches):
        """Yields the items of `batches`: producing each is host work, and
        what the consumer does before asking for the next is model work."""
        it = iter(batches)
        while True:
            with self.host():
                item = next(it, _END)
            if item is _END:
                return
            with self.model():
                yield item

    def report(self, tool: str, images: int) -> dict:
        """Prints and returns {images, seconds, setup_s, images_per_s (after
        setup), model_s, host_s, model_clock}."""
        if self.cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        setup = self._host.total("setup")
        run = wall - setup
        out = dict(images=images, seconds=wall, setup_s=setup,
                   images_per_s=images / run if run > 0 else 0.0,
                   model_s=self._model.total("model"), host_s=self._host.total("host"),
                   model_clock="cuda events" if self.cuda else "host clock")
        print(f"[{tool}] {images} images in {wall:.2f} s: setup {setup:.2f} s, then "
              f"{out['images_per_s']:.2f} img/s; model {out['model_s']:.3f} s "
              f"({out['model_clock']}), host image and file work {out['host_s']:.3f} s",
              flush=True)
        return out

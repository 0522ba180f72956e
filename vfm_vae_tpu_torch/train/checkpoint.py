"""Checkpoints and auto-resume (port of vfm_vae_tpu/train/checkpoint.py;
reference training_loop.py:781-801 snapshots, train.py:23-42 newest-snapshot
discovery, :230-264 key-report loading).

A snapshot is a directory `network-snapshot-{kimg:08d}` holding one
`torch.save` file per top-level entry of the state dict the loop gives
(G, D, G_ema, both Adam states keyed by parameter name, the loss state,
cur_nimg; G_counters, the VQ usage record counters that the reference
state_dict layout lacks, beside G's usage EMAs in G). It is written under a temporary name and renamed into place, so
a directory with the snapshot's name is always whole.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

SNAPSHOT_RE = re.compile(r"network-snapshot-(\d+)$")
TMP_SUFFIX = ".tmp"


def snapshot_name(kimg: int) -> str:
    return f"network-snapshot-{kimg:08d}"


def find_latest_snapshot(run_dir: str) -> Optional[Tuple[str, int]]:
    """Newest snapshot by kimg (reference: train.py:23-42)."""
    if not os.path.isdir(run_dir):
        return None
    best = None
    for name in os.listdir(run_dir):
        m = SNAPSHOT_RE.match(name)
        if m:
            kimg = int(m.group(1))
            if best is None or kimg > best[1]:
                best = (os.path.join(run_dir, name), kimg)
    return best


def _cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def save_snapshot(run_dir: str, kimg: int, state_dict: dict) -> str:
    """Write `state_dict` ({entry: nested dicts of tensors and numbers}) as
    the snapshot for `kimg`, one file per entry. A snapshot that already
    exists under this name is kept and not written again (names carry
    integer kimg, so a cadence finer than 1 kimg maps several ticks onto one
    name); a temporary directory left by a crashed save is removed first."""
    path = os.path.abspath(os.path.join(run_dir, snapshot_name(kimg)))
    if os.path.isdir(path):
        return path
    tmp = path + TMP_SUFFIX
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for key, value in state_dict.items():
        torch.save(_cpu(value), os.path.join(tmp, f"{key}.pt"))
    os.rename(tmp, path)
    return path


def load_snapshot(path: str, device="cpu") -> dict:
    """A snapshot directory back as {entry: value}, tensors on `device`."""
    out = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".pt"):
            out[name[:-3]] = torch.load(os.path.join(path, name), map_location=device,
                                        weights_only=True)
    return out


def snapshot_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))


def merge_loaded(template: dict, loaded) -> dict:
    """strict=False load: take loaded values where paths and shapes match,
    keep the template's elsewhere. Recursive over the template, so its
    structure (empty dicts included) survives (reference strict=False resume:
    training_loop.py:230-264)."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict):
            return template
        return {
            k: (merge_loaded(v, loaded[k]) if k in loaded else v)
            for k, v in template.items()
        }
    if loaded is not None and not isinstance(loaded, dict) \
            and np.shape(loaded) == np.shape(template):
        return loaded
    return template


def flat_keys(tree: Any, prefix: str = "") -> dict:
    """{'a/b/c': leaf} of a nested dict (the key report's view)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_keys(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def grouped_keys(keys, show: int = 8) -> str:
    """'G: 3 (a, b, c); g_opt: 40 (...)' for slash-separated keys, grouped by
    their first component; optimiser leaves counted once per parameter."""
    groups: dict = {}
    for k in keys:
        top, _, rest = k.partition("/")
        if top.endswith("_opt"):
            rest = rest.rsplit("/", 1)[0]
        groups.setdefault(top, {})[rest] = None
    parts = []
    for top, names in groups.items():
        names = list(names)
        more = f", ... {len(names) - show} more" if len(names) > show else ""
        parts.append(f"{top}: {len(names)} ({', '.join(names[:show])}{more})")
    return "; ".join(parts)


def report_key_diff(loaded: dict, template: dict) -> Tuple[list, list]:
    """Missing and unexpected keys (reference: training_loop.py:230-264),
    printed by entry and returned; a key whose shape differs counts as both."""
    got, want = flat_keys(loaded), flat_keys(template)
    differ = {k for k in set(got) & set(want) if np.shape(got[k]) != np.shape(want[k])}
    missing = sorted((set(want) - set(got)) | differ)
    unexpected = sorted((set(got) - set(want)) | differ)
    if missing:
        print(f"[resume] missing: {grouped_keys(missing)}")
    if unexpected:
        print(f"[resume] unexpected: {grouped_keys(unexpected)}")
    return missing, unexpected

"""Module summary table (port of vfm_vae_tpu/core/summary.py; reference
torch_utils/misc.py:234 print_module_summary): parameter and buffer counts
grouped by name prefix."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def module_summary(module: torch.nn.Module, name: str = "Model", depth: int = 1) -> str:
    """A parameter-count table of `module`, grouped by the first `depth`
    components of each parameter's or buffer's name."""
    groups: Dict[str, Tuple[int, int]] = {}
    totals = [0, 0]
    for col, named in ((0, module.named_parameters()), (1, module.named_buffers())):
        for k, v in named:
            g = ".".join(k.split(".")[:depth])
            counts = list(groups.get(g, (0, 0)))
            counts[col] += v.numel()
            totals[col] += v.numel()
            groups[g] = tuple(counts)

    rows: List[Tuple[str, str, str]] = [("Submodule", "Parameters", "Buffers")]
    for g in sorted(groups):
        p, b = groups[g]
        rows.append((g, f"{p:,}", f"{b:,}"))
    rows.append(("Total", f"{totals[0]:,}", f"{totals[1]:,}"))

    widths = [max(len(r[i]) for r in rows) for i in range(3)]
    lines = [f"=== {name} ==="]
    for i, r in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
        if i == 0:
            lines.append("-" * (sum(widths) + 4))
    return "\n".join(lines)

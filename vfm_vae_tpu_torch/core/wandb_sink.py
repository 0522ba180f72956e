"""Weights & Biases sink (port of vfm_vae_tpu/core/wandb_sink.py; reference
training/training_loop.py:656-670 init on rank 0, :843-848 per-tick
`wandb.log(..., step=kimg)`).

wandb is an optional dependency — when it is not installed (or the config
leaves `wandb_project_name`/`wandb_run_name` unset) every method is a
no-op, so the trainer never takes a hard dependency. `WANDB_MODE=offline`
is honored by wandb itself (reference README.md:287-293).
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class WandbSink:
    """Rank-0 wandb logger; inert unless project+name are set AND the wandb
    package imports."""

    def __init__(
        self,
        project: Optional[str],
        name: Optional[str],
        run_dir: str,
        config: Optional[Dict[str, Any]] = None,
        enabled: bool = True,
    ):
        self._run = None
        if not enabled or project is None or name is None:
            return
        try:
            import wandb
        except ImportError:
            from .logging import print0

            print0("[warn] wandb_project_name set but wandb is not installed; "
                   "logging to stats.jsonl only")
            return
        self._run = wandb.init(
            project=project,
            name=name,
            resume="allow",
            dir=run_dir,
            config=dict(config or {}),
        )

    @property
    def active(self) -> bool:
        return self._run is not None

    @staticmethod
    def _scalars(values: Dict[str, Any], prefix: str = "") -> Dict[str, float]:
        """Coerce to python floats (np.float32/bf16 scalars are not `float`
        subclasses; an isinstance filter would silently drop them)."""
        out = {}
        for k, v in values.items():
            try:
                out[prefix + k] = float(v)
            except (TypeError, ValueError):
                pass
        return out

    def log(self, values: Dict[str, Any], step: int) -> None:
        """Per-tick scalars; `step` is kimg (reference global_step :844)."""
        if self._run is not None:
            self._run.log(self._scalars(values), step=step)

    def log_metrics(self, results: Dict[str, Any], step: int) -> None:
        """Eval metrics under the Metrics/ namespace (reference :847-848)."""
        if self._run is not None:
            self._run.log(self._scalars(results, "Metrics/"), step=step)

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()
            self._run = None

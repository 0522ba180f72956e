"""Posterior-moment prefetch for REG training (port of
tools/preprocess_for_reg/prefetch.py): prefetch's CLI and shards, with
`latents` and `latents_flip` holding (mean || std) of the posterior of
the crop and of its flip (encode(return_z_before_quantize=True) ->
mean_logvar_to_mean_std), so that the diffusion trainer samples z itself.

    python -m vfm_vae_tpu_torch.tools.prefetch_reg --config <yaml> \\
        --snapshot <snapshot dir or .pth> --data <dir of .tar> --out <dir>
"""

from __future__ import annotations

from typing import Optional, Sequence

from .prefetch import main as _prefetch_main


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return _prefetch_main(argv, return_moments=True)


if __name__ == "__main__":
    main()

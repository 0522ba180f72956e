"""Sample a trained LightningDiT and decode through the VFM-VAE tokenizer
(port of tools/preprocess_for_lightningdit/sample.py; ODE Euler by default):

    python -m vfm_vae_tpu_torch.tools.lightningdit_sample --config <dit yaml> \\
        --dit-snapshot <dir> --vae-config <vae yaml> --vae-snapshot <dir> \\
        --out samples/ [--num 50000] [--batch 64] [--steps 50] [--cfg 1.0] \\
        [--mode ode|sde] [--device cuda|cpu]

The latents are brought back to the tokenizer's space as
z / latent_multiplier * std + mean (the JAX tool leaves the multiplier out;
the YAMLs' 1.0 makes the two agree). See _dit.sample_main.
"""

from __future__ import annotations

from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from ._dit import sample_main

    return sample_main(argv, "lightningdit_sample", reg=False, mode="ode")


if __name__ == "__main__":
    main()

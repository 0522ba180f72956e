"""REG sampling: the SDE sampler with CFG and the tokenizer's decode (port
of tools/preprocess_for_reg/sample.py):

    python -m vfm_vae_tpu_torch.tools.reg_sample --config <reg yaml> \\
        --dit-snapshot <dir> --vae-config <vae yaml> --vae-snapshot <dir> \\
        --out samples/ [--num 50000] [--steps 50] [--cfg 4.0] [--device cuda|cpu]

The SiT comes from the REG YAML as reg_train builds it, and takes the
"dit" part of a REPA snapshot's {"dit", "proj"} parameters (the JAX tool
hands the LightningDiT sampler the whole tree, which it cannot apply). The
REG trainer trains on raw posterior samples, so the latents are decoded as
they are (the JAX tool de-normalises them with the moments' stats).
"""

from __future__ import annotations

from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from ._dit import sample_main

    return sample_main(argv, "reg_sample", reg=True, mode="sde")


if __name__ == "__main__":
    main()

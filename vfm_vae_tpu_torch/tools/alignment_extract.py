"""Feature extraction for SE-CKNNA (port of
tools/evaluate_alignment/extract_features.py): mean-pooled features per
image or latent, saved as .npz {names, features}.

    # a frozen tower of any family (a preset name or a local config.json
    # directory: siglip2, dinov2, vit-mae, eva02, qwen2.5-vl; seeded random
    # weights; the mean over the layer's tokens, the CLS token stripped):
    python -m vfm_vae_tpu_torch.tools.alignment_extract vfm --model <name or dir> \\
        --images <dir> --out feats_vfm.npz [--layer -1]
    # the tokenizer's latents (G.encode's posterior mode, mean over H, W):
    python -m vfm_vae_tpu_torch.tools.alignment_extract vae --config <yaml> \\
        --snapshot <dir> --images <dir> --out feats_vae.npz
    # DiT block features at one noise level (one file a tap,
    # <out>_<tap>_t<timestep>.npz: embedder, block_i, final_layer):
    python -m vfm_vae_tpu_torch.tools.alignment_extract dit --config <dit yaml> \\
        --snapshot <dir> --latents <shard dir> --out feats_dit [--timestep 0.5]
    # the same for a REG SiT over posterior-moment shards; a REPA snapshot
    # also gives projector_0:
    python -m vfm_vae_tpu_torch.tools.alignment_extract reg --config <reg yaml> \\
        --snapshot <dir> --latents <moment shard dir> --out feats_reg

dit mode normalises the stored latents with the shard directory's
latents_stats.npz and latent_multiplier, as lightningdit_train feeds the
model; reg mode takes the posterior mean (or, with --sample-posterior, a
sample) unnormalised, as reg_train does. The latents are noised to
x_t = alpha z + sigma eps on the linear (alpha 1 - t, sigma t) or cosine
path; eps (and the posterior sample) come from a torch.Generator seeded
--seed. Names are image_{index:06d} in the shards' sorted order (dit, reg)
or the image files' names (vfm, vae). --device defaults to cuda.
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from typing import Optional, Sequence

import numpy as np


def iter_batches(image_dir: str, resolution: int, batch: int):
    """(names, uint8 (B, H, W, 3)) of the folder's .png then .jpg files,
    resized (LANCZOS) to resolution."""
    import PIL.Image

    files = sorted(glob(os.path.join(image_dir, "*.png"))) + sorted(
        glob(os.path.join(image_dir, "*.jpg")))
    for i in range(0, len(files), batch):
        chunk = files[i : i + batch]
        imgs = []
        for f in chunk:
            img = PIL.Image.open(f).convert("RGB")
            if img.size != (resolution, resolution):
                img = img.resize((resolution, resolution), PIL.Image.LANCZOS)
            imgs.append(np.array(img, np.uint8))
        yield [os.path.basename(f) for f in chunk], np.stack(imgs)


def path_coefficients(path_type: str, t: float):
    """(alpha, sigma) of x_t = alpha z + sigma eps."""
    if path_type == "linear":
        return 1.0 - t, t
    return float(np.cos(t * np.pi / 2)), float(np.sin(t * np.pi / 2))


def extract_dit_features(args, dev) -> dict:
    """Every tap's token mean over the first --num latents of the shards;
    returns {tap: path written}."""
    import torch

    from ..data.safetensors_io import load_file
    from ._dit import build_dit, build_reg, latent_stats, snapshot_params, tool_config
    from .lightningdit_train import shard_files

    cfg = tool_config(args.config)
    sd, proj_sd = snapshot_params(args.snapshot)
    projector = None
    if args.mode == "reg":
        model, projector, _, in_chans, _ = build_reg(cfg, with_projector=proj_sd is not None,
                                                     device=dev)
        if projector is not None:
            projector.load_state_dict(proj_sd)
        mean, std, mult = None, None, 1.0
    else:
        model, _, in_chans, _ = build_dit(cfg, dev)
        dcfg = dict(cfg.get("data", {}), data_path=args.latents)
        mean, std, mult = latent_stats(dcfg, in_chans, dev)
    model.load_state_dict(sd)
    alpha, sigma = path_coefficients(args.path_type, args.timestep)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    names, feats_all, done = [], {}, 0
    for f in shard_files(args.latents):
        if done >= args.num:
            break
        d = load_file(f)
        lat = d["latents"].transpose(0, 2, 3, 1)  # stored NCHW
        labels = d.get("labels", np.zeros((lat.shape[0],), np.int64))
        take = min(args.num - done, lat.shape[0])
        for i in range(0, take, args.batch):
            j = min(i + args.batch, take)
            z = torch.from_numpy(np.ascontiguousarray(lat[i:j], np.float32)).to(dev)
            y = torch.from_numpy(np.asarray(labels[i:j], np.int64)).to(dev)
            with torch.no_grad():
                if args.mode == "reg":
                    mu, sd_ = z.chunk(2, dim=-1)
                    z = mu
                    if args.sample_posterior:
                        z = mu + sd_ * torch.randn(mu.shape, generator=gen, device=dev)
                else:
                    z = (z - mean) / std * mult
                eps = torch.randn(z.shape, generator=gen, device=dev)
                t = torch.full((z.shape[0],), args.timestep, dtype=torch.float32, device=dev)
                _, feats = model(alpha * z + sigma * eps, t, y, collect_block_features=True)
                tap = feats.pop("repa_tokens", None)
                if tap is not None and projector is not None:
                    feats["projector_0"] = projector(tap).mean(1)
            for k, v in feats.items():
                feats_all.setdefault(k, []).append(v.float().cpu().numpy())
            names.extend(f"image_{done + i + n:06d}" for n in range(j - i))
        done += take
        print(f"{done}/{args.num} latents", flush=True)

    written = {}
    for k, chunks in feats_all.items():
        written[k] = f"{args.out}_{k}_t{args.timestep:.3f}.npz"
        np.savez(written[k], names=np.array(names), features=np.concatenate(chunks),
                 feature_name=k, timestep=args.timestep)
    print(f"wrote {len(written)} feature files ({args.out}_<tap>_t{args.timestep:.3f}.npz), "
          f"{len(names)} images each")
    return written


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns {tap: path} (dit, reg) or {"features": path} (vfm, vae)."""
    ap = argparse.ArgumentParser(description="Features for SE-CKNNA.")
    ap.add_argument("mode", choices=["vfm", "vae", "dit", "reg"])
    ap.add_argument("--model", default="siglip2-large-patch16-512")
    ap.add_argument("--config")
    ap.add_argument("--snapshot")
    ap.add_argument("--images")
    ap.add_argument("--latents", help="latent shard directory (dit, reg)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--layer", type=int, default=-1)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--timestep", type=float, default=0.5)
    ap.add_argument("--path-type", choices=["linear", "cosine"], default="linear")
    ap.add_argument("--sample-posterior", action="store_true",
                    help="reg mode: a posterior sample instead of the posterior mean")
    ap.add_argument("--num", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ._generator import resolve_device

    dev = resolve_device(args.device, "alignment_extract")
    if args.mode in ("dit", "reg"):
        return extract_dit_features(args, dev)
    if not args.images:
        raise SystemExit("alignment_extract: --images is required for the vfm and vae modes")

    if args.mode == "vfm":
        from ..entry import configure_precision
        from ..models.vfm import VFMEncoder
        from ._dit import init_model

        configure_precision()
        enc = init_model(VFMEncoder(args.model, scale_factor=1.0, patch_from_layers=[args.layer],
                                    device=dev), 0, dev)

        def extract(x):
            return enc.encode_image(x)[0].mean(1)  # mean over tokens
    else:
        from ._generator import build_generator

        G, _ = build_generator(args.config, args.snapshot, dev)

        def extract(x):
            return G.encode(x).float().mean((1, 2))  # mean over H, W

    names, feats = [], []
    for chunk, imgs in iter_batches(args.images, args.resolution, args.batch):
        x = torch.from_numpy(imgs).to(dev).float().div_(255.0)
        with torch.no_grad():
            feats.append(extract(x).float().cpu().numpy())
        names.extend(chunk)
        print(f"{len(names)} done", flush=True)
    arr = np.concatenate(feats)
    np.savez(args.out, names=np.array(names), features=arr)
    path = args.out if args.out.endswith(".npz") else args.out + ".npz"
    print(f"wrote {path}: {arr.shape}")
    return {"features": path}


if __name__ == "__main__":
    main()

"""The offline tools of the port, each a module with `main(argv)`:

    python -m vfm_vae_tpu_torch.tools.prefetch       # images -> latent shards (LightningDiT)
    python -m vfm_vae_tpu_torch.tools.prefetch_reg   # images -> posterior moments (REG)
    python -m vfm_vae_tpu_torch.tools.decode_latents_to_images
    python -m vfm_vae_tpu_torch.tools.decode_latents_to_labels
    python -m vfm_vae_tpu_torch.tools.save_images_as_npz
    python -m vfm_vae_tpu_torch.tools.extract        # tar shards -> image folder
    python -m vfm_vae_tpu_torch.tools.reconstruct    # image folder -> inputs/ + outputs/
    python -m vfm_vae_tpu_torch.tools.evaluate       # PSNR / SSIM / LPIPS of pairs
    python -m vfm_vae_tpu_torch.tools.fidelity       # rFID / IS of two folders
    python -m vfm_vae_tpu_torch.tools.evaluate_npz   # ADM FID / sFID / IS / P / R
    python -m vfm_vae_tpu_torch.tools.lightningdit_train   # latents -> LightningDiT snapshots
    python -m vfm_vae_tpu_torch.tools.lightningdit_sample  # DiT -> latents -> PNGs (ODE)
    python -m vfm_vae_tpu_torch.tools.reg_train      # moments -> REG SiT (+ REPA) snapshots
    python -m vfm_vae_tpu_torch.tools.reg_sample     # REG SiT -> PNGs (SDE)
    python -m vfm_vae_tpu_torch.tools.alignment_preprocess  # SE-CKNNA records, noisy sets
    python -m vfm_vae_tpu_torch.tools.alignment_extract     # vfm / vae / dit / reg features
    python -m vfm_vae_tpu_torch.tools.alignment_metrics     # CKNNA of two feature files

The tools that run a network take --device (default cuda; a tool fails by
name when the card is missing, and --device cpu runs on the CPU).
"""

"""Evaluation metrics of the port: FID/sFID/IS/precision-recall on the
InceptionV3 detector, PSNR/SSIM/LPIPS of reconstruction pairs, and the
metric registry."""

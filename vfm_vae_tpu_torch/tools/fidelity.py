"""Folder-level FID and Inception Score (port of
tools/reconstruct/fidelity.py; the role of `fidelity --fid --isc --input1
outputs --input2 inputs` in the reference's reconstruction recipe): both
folders stream through the InceptionV3 detector and one JSON line of
results is printed (rfid; is_mean and is_std).

    python -m vfm_vae_tpu_torch.tools.fidelity --input1 <generated dir> \\
        --input2 <real dir> --fid --isc [--inception-weights pt_inception.pth]

The figures need pytorch-fid's pt_inception-2015-12-05 weights, which the
repository does not hold; without --inception-weights the detector has
seeded random weights (a plumbing check) and a warning goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
from glob import glob
from typing import Optional, Sequence

import numpy as np


def folder_batches(d: str, batch: int, max_items: int):
    import PIL.Image

    files = sorted(glob(os.path.join(d, "*.png")) + glob(os.path.join(d, "*.jpg")))[:max_items]
    if not files:
        raise SystemExit(f"fidelity: no images in {d}")
    for i in range(0, len(files), batch):
        yield np.stack([np.array(PIL.Image.open(f).convert("RGB"), np.uint8)
                        for f in files[i : i + batch]])


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the time report (ToolClock.report) with `results`."""
    ap = argparse.ArgumentParser(description="FID and Inception Score of image folders.")
    ap.add_argument("--input1", required=True, help="generated or reconstructed images")
    ap.add_argument("--input2", help="real images (needed for --fid)")
    ap.add_argument("--fid", action="store_true")
    ap.add_argument("--isc", action="store_true")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--max", type=int, default=50000)
    ap.add_argument("--inception-weights", default=None,
                    help="pytorch-fid's pt_inception-2015-12-05 .pth; random init otherwise")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not (args.fid or args.isc):
        raise SystemExit("fidelity: nothing to do: pass --fid and/or --isc")
    if args.fid and not args.input2:
        raise SystemExit("fidelity: --fid needs --input2")

    import torch

    from ..entry import configure_precision
    from ..metrics import metric_main
    from ..metrics.inception import make_detector
    from ._generator import ToolClock, resolve_device

    dev = resolve_device(args.device, "fidelity")
    configure_precision()
    clock = ToolClock(dev)
    with clock.setup():
        _, detect = make_detector(args.inception_weights, dev, "fidelity")

    # IS is over input1 only; under --fid both folders stream through the
    # detector, so batches are tagged and probabilities kept for input1.
    probs_acc, state, seen = [], {"collect": False}, [0]

    def tagged(batches, collect: bool):
        for b in clock.timed(batches):
            state["collect"] = collect
            yield b

    def detector(images) -> np.ndarray:
        pool, logits, _ = detect(images)
        if args.isc and state["collect"]:
            probs_acc.append(torch.softmax(logits, dim=-1).cpu().numpy())
        seen[0] += len(images)
        return pool.cpu().numpy()

    results = {}
    if args.fid:
        res = metric_main.calc_metric(
            "rfid", detector_fn=detector,
            real_batches=tagged(folder_batches(args.input2, args.batch, args.max), False),
            gen_batches=tagged(folder_batches(args.input1, args.batch, args.max), True),
            max_items=args.max)
        results.update(res["results"])
    if args.isc:
        if not probs_acc:
            for b in tagged(folder_batches(args.input1, args.batch, args.max), True):
                detector(b)
        res = metric_main.calc_metric("inception_score", probs=np.concatenate(probs_acc))
        results.update(res["results"])
    results = {k: float(v) for k, v in results.items()}
    print(json.dumps(results))
    return dict(clock.report("fidelity", seen[0]), results=results)


if __name__ == "__main__":
    main()

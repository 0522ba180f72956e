"""Metric registry and runner (port of vfm_vae_tpu/metrics/metric_main.py;
reference metrics/metric_main.py:34-98).

`calc_metric(name, **opts)` dispatches into the @register_metric functions
and times them; `report_metric` appends one JSON line to
metric-<name>.jsonl in the run directory, the reference's file contract.
The functions take the detector (or the CLIP encoders) as callables, so
the registry holds no model; `device` places the precision-recall
distances and the recon suite's work."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict

_METRICS: Dict[str, Callable] = {}


def register_metric(fn: Callable) -> Callable:
    _METRICS[fn.__name__] = fn
    return fn


def is_valid_metric(name: str) -> bool:
    return name in _METRICS


def list_metrics():
    return list(_METRICS.keys())


def calc_metric(metric: str, **opts) -> Dict[str, Any]:
    assert is_valid_metric(metric), f"unknown metric {metric}; have {list_metrics()}"
    start = time.time()
    results = _METRICS[metric](**opts)
    return dict(
        results=results,
        metric=metric,
        total_time=time.time() - start,
        num_gpus=1,
    )


def report_metric(result_dict: Dict[str, Any], run_dir: str = None, snapshot_pkl: str = None) -> None:
    metric = result_dict["metric"]
    jsonl_line = json.dumps(
        dict(result_dict, snapshot_pkl=snapshot_pkl, timestamp=time.time())
    )
    print(jsonl_line)
    if run_dir is not None and os.path.isdir(run_dir):
        with open(os.path.join(run_dir, f"metric-{metric}.jsonl"), "a") as f:
            f.write(jsonl_line + "\n")


# ---------------------------------------------------------------- metrics


@register_metric
def rfid(real_batches=None, gen_batches=None, detector_fn=None, max_items=50000, **_):
    """Reconstruction FID over paired folders (README protocol)."""
    from .fid import compute_fid

    value = compute_fid(detector_fn, real_batches, gen_batches, max_items=max_items)
    return {"rfid": value}


@register_metric
def pr50k3(real_features=None, gen_features=None, device="cpu", **_):
    from .precision_recall import compute_pr

    p, r = compute_pr(real_features, gen_features, nhood_size=3, device=device)
    return {"precision": p, "recall": r}


@register_metric
def recon_suite(pairs=None, lpips_module=None, device="cpu", **_):
    from .recon import evaluate_pairs

    return evaluate_pairs(pairs, lpips_module, device=device)


@register_metric
def inception_score(probs=None, num_splits: int = 10, **_):
    """IS = exp(E KL(p(y|x) || p(y))) over splits; `probs` (N, classes) from
    the InceptionV3 logits head (rIS protocol, README tables)."""
    import numpy as np

    probs = np.asarray(probs)
    scores = []
    n = probs.shape[0]
    num_splits = max(1, min(num_splits, n))  # empty splits would yield nan
    for i in range(num_splits):
        part = probs[i * n // num_splits : (i + 1) * n // num_splits]
        kl = part * (np.log(part + 1e-10) - np.log(part.mean(axis=0, keepdims=True) + 1e-10))
        scores.append(float(np.exp(kl.sum(axis=1).mean())))
    return {"is_mean": float(np.mean(scores)), "is_std": float(np.std(scores))}


@register_metric
def clip_score(image_features=None, text_features=None, **_):
    """Mean cosine similarity of (already L2-normalized) CLIP features
    (reference: metrics/clip_score.py:20-47, cs10k)."""
    import numpy as np

    sim = np.sum(np.asarray(image_features) * np.asarray(text_features), axis=-1)
    return {"clip_score": float(sim.mean())}


# ------------------------------------------------- dataset-level metrics
# Name-parity entry points matching the reference registry
# (metrics/metric_main.py:118-185): fid50k_full / fid10k_full / cs10k /
# pr50k3_full + the zero-shot COCO variants. Real-side features come from an
# ImageFolderDataset (dir or zip) with md5-keyed stat caching mirroring
# metric_utils.py:208-240; generated-side features come from `gen_batches`
# (any iterable of NHWC image batches, e.g. decoded samples).


def get_coco_path(original_path: str) -> str:
    """COCO val set discovery (reference: metrics/metric_main.py:100-116):
    the dataset itself, a sibling coco_val256.zip, or $COCOPATH."""
    stem = os.path.splitext(os.path.basename(original_path))[0]
    if stem == "coco_val256":
        return original_path
    sibling = os.path.join(os.path.dirname(original_path), "coco_val256.zip")
    if os.path.exists(sibling):
        return sibling
    path = os.environ.get("COCOPATH", "")
    if os.path.splitext(os.path.basename(path))[0] == "coco_val256":
        return path
    raise ValueError(f"Did not find coco_val256. $COCOPATH: {path}")


def _dataset_batches(dataset_path, resolution=None, max_items=None, batch_size=64):
    from ..data.zipfolder import ImageFolderDataset

    ds = ImageFolderDataset(dataset_path, resolution=resolution, max_size=max_items)
    for imgs, _ in ds.batches(batch_size):
        yield imgs


def dataset_feature_stats(
    detector_fn,
    dataset_path,
    resolution=None,
    max_items=None,
    capture_all=False,
    cache_dir=None,
    detector_tag="inception_v3",
):
    """Real-side FeatureStats with on-disk caching keyed by the md5 of the
    spec tuple (reference: metric_utils.py:208-240 dataset-stat cache)."""
    import hashlib

    from .fid import accumulate_features

    cache_file = None
    if cache_dir is not None:
        spec = repr((os.path.abspath(dataset_path), resolution, max_items,
                     capture_all, detector_tag))
        key = hashlib.md5(spec.encode()).hexdigest()
        cache_file = os.path.join(cache_dir, f"dataset-stats-{key}.npz")
        if os.path.isfile(cache_file):
            from .feature_stats import FeatureStats

            return FeatureStats.load(cache_file)
    stats = accumulate_features(
        detector_fn,
        _dataset_batches(dataset_path, resolution=resolution, max_items=max_items),
        capture_all=capture_all,
        max_items=max_items,
    )
    if cache_file is not None:
        os.makedirs(cache_dir, exist_ok=True)
        stats.save(cache_file)
    return stats


def _fid_vs_dataset(detector_fn, dataset_path, gen_batches, num_gen,
                    resolution=None, max_real=None, cache_dir=None):
    from .fid import accumulate_features, compute_fid_from_stats

    real = dataset_feature_stats(
        detector_fn, dataset_path, resolution=resolution, max_items=max_real,
        cache_dir=cache_dir,
    )
    gen = accumulate_features(detector_fn, gen_batches, max_items=num_gen)
    return compute_fid_from_stats(real, gen)


@register_metric
def fid50k_full(detector_fn=None, dataset_path=None, gen_batches=None,
                cache_dir=None, **_):
    fid = _fid_vs_dataset(detector_fn, dataset_path, gen_batches,
                          num_gen=50000, cache_dir=cache_dir)
    return dict(fid50k_full=fid)


@register_metric
def fid10k_full(detector_fn=None, dataset_path=None, gen_batches=None,
                cache_dir=None, **_):
    fid = _fid_vs_dataset(detector_fn, dataset_path, gen_batches,
                          num_gen=10000, cache_dir=cache_dir)
    return dict(fid10k_full=fid)


@register_metric
def pr50k3_full(detector_fn=None, dataset_path=None, gen_batches=None,
                cache_dir=None, device="cpu", **_):
    """Kynkäänniemi P&R, max_real=200k / num_gen=50k / nhood 3
    (reference: metrics/metric_main.py:146-151)."""
    from .fid import accumulate_features
    from .precision_recall import compute_pr

    real = dataset_feature_stats(
        detector_fn, dataset_path, max_items=200000, capture_all=True,
        cache_dir=cache_dir, detector_tag="inception_v3_raw",
    )
    gen = accumulate_features(detector_fn, gen_batches, capture_all=True,
                              max_items=50000)
    precision, recall = compute_pr(real.get_all(), gen.get_all(), nhood_size=3,
                                   device=device)
    return dict(pr50k3_full_precision=precision, pr50k3_full_recall=recall)


def _clip_score_over_batches(clip_image_fn, clip_text_fn, gen_batches,
                             texts, num_gen):
    """cs = mean cosine of CLIP(image, text) over generated samples
    (reference: metrics/clip_score.py:20-47)."""
    import numpy as np

    import itertools

    sims, seen = [], 0
    text_iter = iter(texts)
    for imgs in gen_batches:
        if seen >= num_gen:
            break
        imgs = imgs[: num_gen - seen]
        batch_texts = list(itertools.islice(text_iter, len(imgs)))
        if len(batch_texts) < len(imgs):
            raise ValueError(
                f"clip_score: texts exhausted after {seen + len(batch_texts)} "
                f"images (need one caption per generated image, num_gen={num_gen})"
            )
        img_f = np.asarray(clip_image_fn(imgs))
        txt_f = np.asarray(clip_text_fn(batch_texts))
        img_f = img_f / np.linalg.norm(img_f, axis=-1, keepdims=True)
        txt_f = txt_f / np.linalg.norm(txt_f, axis=-1, keepdims=True)
        sims.append(np.sum(img_f * txt_f, axis=-1))
        seen += len(imgs)
    if not sims:
        raise ValueError("clip_score: gen_batches yielded no images")
    return float(np.concatenate(sims).mean())


@register_metric
def cs10k(clip_image_fn=None, clip_text_fn=None, gen_batches=None,
          texts=None, **_):
    cs = _clip_score_over_batches(clip_image_fn, clip_text_fn, gen_batches,
                                  texts, num_gen=10000)
    return dict(cs=cs)


@register_metric
def fid30k_coco64(detector_fn=None, dataset_path=None, gen_batches=None,
                  cache_dir=None, **_):
    coco = get_coco_path(dataset_path)
    fid = _fid_vs_dataset(detector_fn, coco, gen_batches, num_gen=30000,
                          resolution=64, cache_dir=cache_dir)
    return dict(fid30k_full_coco_val=fid)


@register_metric
def fid30k_coco256(detector_fn=None, dataset_path=None, gen_batches=None,
                   cache_dir=None, **_):
    coco = get_coco_path(dataset_path)
    fid = _fid_vs_dataset(detector_fn, coco, gen_batches, num_gen=30000,
                          resolution=256, cache_dir=cache_dir)
    return dict(fid30k_full_coco_val=fid)


@register_metric
def cs10k_coco(clip_image_fn=None, clip_text_fn=None, gen_batches=None,
               texts=None, dataset_path=None, **_):
    get_coco_path(dataset_path)  # same existence check as the reference
    cs = _clip_score_over_batches(clip_image_fn, clip_text_fn, gen_batches,
                                  texts, num_gen=30000)
    return dict(cs=cs)

"""Streaming feature statistics (port of vfm_vae_tpu/metrics/feature_stats.py;
reference metrics/metric_utils.py FeatureStats :126-206): raw-feature
capture and/or running mean and covariance in float64, with save and load
for the dataset-stat cache."""

from __future__ import annotations

from typing import Optional

import numpy as np


class FeatureStats:
    def __init__(self, capture_all: bool = False, capture_mean_cov: bool = False,
                 max_items: Optional[int] = None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.all_features = None
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features: int) -> None:
        if self.num_features is not None:
            assert num_features == self.num_features
            return
        self.num_features = num_features
        self.all_features = []
        self.raw_mean = np.zeros(num_features, np.float64)
        self.raw_cov = np.zeros((num_features, num_features), np.float64)

    def is_full(self) -> bool:
        return self.max_items is not None and self.num_items >= self.max_items

    def append(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        assert x.ndim == 2
        if self.max_items is not None:
            if self.num_items >= self.max_items:
                return
            x = x[: self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(axis=0)
            self.raw_cov += x64.T @ x64

    def get_all(self) -> np.ndarray:
        assert self.capture_all
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        assert self.capture_mean_cov
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov

    def save(self, path: str) -> None:
        np.savez(
            path,
            num_items=self.num_items,
            capture_all=self.capture_all,
            capture_mean_cov=self.capture_mean_cov,
            raw_mean=self.raw_mean if self.raw_mean is not None else np.zeros(0),
            raw_cov=self.raw_cov if self.raw_cov is not None else np.zeros((0, 0)),
            all_features=self.get_all() if self.capture_all and self.all_features else np.zeros((0, 0)),
        )

    @classmethod
    def load(cls, path: str) -> "FeatureStats":
        d = np.load(path, allow_pickle=False)
        obj = cls(
            capture_all=bool(d["capture_all"]), capture_mean_cov=bool(d["capture_mean_cov"])
        )
        obj.num_items = int(d["num_items"])
        if d["raw_mean"].size:
            obj.num_features = d["raw_mean"].shape[0]
            obj.raw_mean = d["raw_mean"]
            obj.raw_cov = d["raw_cov"]
        if d["all_features"].size:
            obj.all_features = [d["all_features"]]
            obj.num_features = d["all_features"].shape[1]
        return obj

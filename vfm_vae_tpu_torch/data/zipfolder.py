"""Folder/zip image dataset (port of vfm_vae_tpu/data/zipfolder.py;
reference training/data_zip.py, the StyleGAN Dataset/ImageFolderDataset of
validation and metric datasets): a directory tree or zip archive of
images, optional dataset.json labels, xflip doubling, a max_size cap and
raw_idx shuffling."""

from __future__ import annotations

import json
import os
import zipfile
from typing import List, Optional, Tuple

import numpy as np


class ImageFolderDataset:
    def __init__(
        self,
        path: str,
        resolution: Optional[int] = None,
        use_labels: bool = False,
        max_size: Optional[int] = None,
        xflip: bool = False,
        random_seed: int = 0,
        **kwargs,
    ):
        self._path = path
        self._zipfile = None
        self.resolution = resolution
        self.use_labels = use_labels
        self.xflip = xflip

        if self._is_zip():
            with self._open_zip() as z:
                names = z.namelist()
        else:
            names = [
                os.path.relpath(os.path.join(d, f), path)
                for d, _, files in os.walk(path)
                for f in files
            ]
        self._image_fnames = sorted(
            n for n in names if n.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        if not self._image_fnames:
            raise IOError(f"no images found in {path}")

        self._raw_labels = self._load_labels()

        n = len(self._image_fnames)
        self._raw_idx = np.arange(n, dtype=np.int64)
        if max_size is not None and n > max_size:
            rng = np.random.RandomState(random_seed)
            rng.shuffle(self._raw_idx)
            self._raw_idx = np.sort(self._raw_idx[:max_size])
        self._xflip_flags = np.zeros(self._raw_idx.size, dtype=np.uint8)
        if xflip:
            self._raw_idx = np.tile(self._raw_idx, 2)
            self._xflip_flags = np.concatenate(
                [self._xflip_flags, np.ones_like(self._xflip_flags)]
            )

    # ------------------------------------------------------------ file IO

    def _is_zip(self) -> bool:
        return os.path.isfile(self._path) and self._path.lower().endswith(".zip")

    def _open_zip(self):
        return zipfile.ZipFile(self._path)

    def _read_file(self, fname: str) -> bytes:
        if self._is_zip():
            if self._zipfile is None:
                self._zipfile = self._open_zip()
            with self._zipfile.open(fname) as f:
                return f.read()
        with open(os.path.join(self._path, fname), "rb") as f:
            return f.read()

    def _load_labels(self):
        if not self.use_labels:
            return None
        try:
            data = json.loads(self._read_file("dataset.json"))["labels"]
        except Exception:
            return None
        if data is None:
            return None
        mapping = dict(data)
        labels = np.array(
            [mapping[name.replace("\\", "/")] for name in self._image_fnames]
        )
        if labels.ndim == 1:  # class indices -> keep as int
            return labels.astype(np.int64)
        return labels.astype(np.float32)

    # ------------------------------------------------------------ access

    def __len__(self) -> int:
        return self._raw_idx.size

    @property
    def label_shape(self) -> List[int]:
        if self._raw_labels is None:
            return [0]
        if self._raw_labels.dtype == np.int64:
            return [int(self._raw_labels.max() + 1)]
        return list(self._raw_labels.shape[1:])

    @property
    def label_dim(self) -> int:
        return self.label_shape[0]

    @property
    def name(self) -> str:
        return os.path.splitext(os.path.basename(self._path))[0]

    def get_label(self, idx: int):
        if self._raw_labels is None:
            return np.zeros(0, np.float32)
        label = self._raw_labels[self._raw_idx[idx]]
        if self._raw_labels.dtype == np.int64:
            onehot = np.zeros(self.label_shape[0], np.float32)
            onehot[int(label)] = 1.0
            return onehot
        return label.copy()

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        import io

        import PIL.Image

        fname = self._image_fnames[self._raw_idx[idx]]
        img = PIL.Image.open(io.BytesIO(self._read_file(fname))).convert("RGB")
        if self.resolution is not None and img.size != (self.resolution, self.resolution):
            w, h = img.size
            scale = self.resolution / min(w, h)
            img = img.resize((round(w * scale), round(h * scale)), PIL.Image.LANCZOS)
            w, h = img.size
            left, top = (w - self.resolution) // 2, (h - self.resolution) // 2
            img = img.crop((left, top, left + self.resolution, top + self.resolution))
        arr = np.array(img, np.uint8)  # HWC
        if self._xflip_flags[idx]:
            arr = np.ascontiguousarray(arr[:, ::-1])
        return arr, self.get_label(idx)

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0):
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for i in range(0, len(order), batch_size):
            sel = order[i : i + batch_size]
            imgs = np.stack([self[j][0] for j in sel])
            labels = np.stack([self[j][1] for j in sel])
            yield imgs, labels

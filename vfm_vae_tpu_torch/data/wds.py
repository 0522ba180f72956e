"""WebDataset-style tar-shard streaming input pipeline (port of
vfm_vae_tpu/data/wds.py; reference training/data_wds.py).

Plain tarfile parsing and spawned worker PROCESSES feeding a bounded queue
(decode + augment is GIL-bound); thread workers for tiny datasets
(`worker_type='thread'`, or `workers=0`). The JAX package reads shards
through a native reader when it is built (data/ctar.py) and falls back to
the same tarfile reader, whose output is identical; the port has the
tarfile reader only.

Preserved contracts, draw for draw with the JAX loader for the same seed:
  * augmentation: random square crop ratio U(0.5, 1) -> LANCZOS resize ->
    hflip (data_wds.py:195-217); eval: center crop.
  * label types text / cls2text / cls2id (one-hot) (data_wds.py:316-343).
  * one-epoch exact resume via `processed_tars_rank{NN}.txt` shard logs,
    discarding the last `workers` lines as possibly incomplete
    (data_wds.py:70-144, 270-298).
  * per-worker seeding ladder base_seed + rank*1000 + worker_id
    (data_wds.py:50-62), and the shuffle buffer's draws.
  * corrupt samples are logged and skipped (log_and_continue).
  * a `filter_keys_path` that is not a file skips the key filter, as the
    reference does; the port says so in the log.

Batches are NHWC uint8 (images) and label lists or one-hot arrays; the
training step normalises the images on the device.
"""

from __future__ import annotations

import io
import json
import logging
import os
import pickle
import queue
import random
import tarfile
import threading
from glob import glob
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

try:
    import PIL.Image
except ImportError:  # pragma: no cover
    PIL = None

DEFAULT_SEED = 42
IMG_EXTENSIONS = ("jpg", "jpeg", "png")


def _safe_rank() -> int:
    from ..core.logging import process_index

    return process_index()


# ------------------------------------------------------------------ tracker


class ShardTracker:
    """Records fully-consumed shards per rank (data_wds.py:70-118)."""

    def __init__(self, log_dir: str, rank: Optional[int] = None):
        self.rank = _safe_rank() if rank is None else rank
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.log_path = os.path.join(log_dir, f"processed_tars_rank{self.rank:02d}.txt")
        self.processed_set = set()
        self._lock = threading.Lock()
        if os.path.isfile(self.log_path):
            with open(self.log_path) as f:
                self.processed_set = {l.strip() for l in f if l.strip()}

    def record(self, url: str) -> None:
        with self._lock:
            if url in self.processed_set:
                return
            with open(self.log_path, "a") as f:
                f.write(url + "\n")
            self.processed_set.add(url)


def get_tail(p: str) -> str:
    return os.path.join(os.path.basename(os.path.dirname(p)), os.path.basename(p))


def get_all_processed_tars(processed_tar_read_dir: str, workers: int) -> List[str]:
    """(data_wds.py:121-144): drop the last `workers` lines per file."""
    processed = set()
    if processed_tar_read_dir and os.path.isdir(processed_tar_read_dir):
        for txt_file in glob(os.path.join(processed_tar_read_dir, "processed_tars_*.txt")):
            with open(txt_file) as f:
                lines = f.readlines()[: -workers if workers > 0 else None]
            for line in lines:
                line = line.strip()
                if line:
                    processed.add(get_tail(line))
    return sorted(processed)


# ------------------------------------------------------------------ augment


def transform_image(img, resolution: int, augment: bool, rng: random.Random) -> np.ndarray:
    """Random-crop-ratio + LANCZOS + hflip (data_wds.py:195-217); HWC uint8."""
    arr = np.array(img)
    if arr.ndim == 2:
        arr = arr[:, :, np.newaxis]
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    h, w = arr.shape[:2]
    crop_ratio = rng.uniform(0.5, 1.0) if augment else 1.0
    crop_size = max(1, int(min(h, w) * crop_ratio))
    top = rng.randint(0, h - crop_size) if augment and h > crop_size else max((h - crop_size) // 2, 0)
    left = rng.randint(0, w - crop_size) if augment and w > crop_size else max((w - crop_size) // 2, 0)
    arr = arr[top : top + crop_size, left : left + crop_size]
    out = PIL.Image.fromarray(arr, "RGB").resize((resolution, resolution), PIL.Image.LANCZOS)
    arr = np.array(out)
    if augment and rng.random() < 0.5:
        arr = np.ascontiguousarray(np.flip(arr, axis=1))
    return arr.astype(np.uint8)


def to_one_hot(label: int, num_classes: int) -> np.ndarray:
    one_hot = np.zeros(num_classes, dtype=np.float32)
    one_hot[int(label)] = 1.0
    return one_hot


# ------------------------------------------------------------------ tar IO


def iter_tar_samples(url: str) -> Iterator[Dict[str, bytes]]:
    """Group tar members by sample key (basename before the first dot)."""
    with tarfile.open(url, "r|*") as tf:
        current_key = None
        sample: Dict[str, bytes] = {}
        for member in tf:
            if not member.isfile():
                continue
            name = os.path.basename(member.name)
            if "." not in name:
                continue
            key, ext = name.split(".", 1)
            ext = ext.lower()
            if current_key is not None and key != current_key and sample:
                sample["__key__"] = current_key.encode()
                sample["__url__"] = url.encode()
                yield sample
                sample = {}
            current_key = key
            f = tf.extractfile(member)
            if f is not None:
                sample[ext] = f.read()
        if sample and current_key is not None:
            sample["__key__"] = current_key.encode()
            sample["__url__"] = url.encode()
            yield sample


def _decode_sample(
    raw: Dict[str, bytes],
    label_type: str,
    resolution: int,
    augment: bool,
    cls2text: Optional[dict],
    num_classes: int,
    keep_set: Optional[set],
    rng: random.Random,
):
    key = raw["__key__"].decode()
    if label_type in ("cls2text", "cls2id") and keep_set is not None and key not in keep_set:
        return None
    img_bytes = None
    for ext in IMG_EXTENSIONS:
        if ext in raw:
            img_bytes = raw[ext]
            break
    if img_bytes is None:
        return None
    img = PIL.Image.open(io.BytesIO(img_bytes)).convert("RGB")
    image = transform_image(img, resolution, augment, rng)

    if label_type == "text":
        text = raw.get("txt", b"").decode("utf-8", errors="ignore").strip()
        if not text:
            return None
        return image, text
    if "cls" not in raw:
        return None
    label = int(raw["cls"].decode().strip())
    if label_type == "cls2text":
        return image, (cls2text[str(label)] if cls2text else str(label))
    return image, to_one_hot(label, num_classes)


# ------------------------------------------------------------------ loader


# Write ends of worker watchdog pipes (one per loader). Held for the life
# of the parent process ON PURPOSE: a GC'd write end would EOF the pipe and
# falsely kill the workers. Closed implicitly at parent death — which is
# the signal.
_LOADER_WATCHDOG_KEEPALIVE: list = []


def _parent_watchdog(conn):
    """Blocks until the parent process dies (the write end of `conn`'s pipe
    EOFs — covering SIGKILL/SIGABRT paths where neither the daemon-process
    machinery nor atexit runs), then hard-exits the worker. Without this,
    orphaned workers keep the parent's inherited stdout/stderr pipes open
    and any `subprocess.run(capture_output=True)` driving the trainer
    blocks on EOF forever (observed with an aborted flagship run)."""
    try:
        conn.recv()
    except Exception:
        pass
    os._exit(0)


def _process_worker_main(shards, out_q, decode_kwargs, tracker_dir, tracker_rank,
                         seed, resample, parent_conn=None):
    """Worker-process body (the reference uses DataLoader worker PROCESSES,
    data_wds.py:345-350 — threads serialize on the GIL for decode+augment:
    measured flat ~190 img/s regardless of thread count)."""
    if parent_conn is not None:
        threading.Thread(
            target=_parent_watchdog, args=(parent_conn,), daemon=True
        ).start()
    tracker = ShardTracker(tracker_dir, rank=tracker_rank) if tracker_dir else None
    rng = random.Random(seed)
    try:
        while True:
            order = list(shards)
            rng.shuffle(order)
            for url in order:
                try:
                    for raw in iter_tar_samples(url):
                        try:
                            item = _decode_sample(raw, rng=rng, **decode_kwargs)
                        except Exception as exn:
                            logging.warning(f"wds decode error ({exn!r}). Ignoring.")
                            continue
                        if item is not None:
                            out_q.put(item)
                    if tracker is not None:
                        tracker.record(url)
                except Exception as exn:
                    logging.warning(f"wds shard error ({exn!r}) for {url}. Ignoring.")
            if not resample:
                break
    finally:
        out_q.put(None)


class _ShardWorker(threading.Thread):
    def __init__(self, shards, out_q, stop_event, decode_kwargs, tracker, seed, resample):
        super().__init__(daemon=True)
        self.shards = shards
        self.out_q = out_q
        self.stop_event = stop_event
        self.decode_kwargs = decode_kwargs
        self.tracker = tracker
        self.rng = random.Random(seed)
        self.resample = resample

    def run(self):
        try:
            while True:
                order = list(self.shards)
                self.rng.shuffle(order)
                for url in order:
                    if self.stop_event.is_set():
                        return
                    try:
                        for raw in iter_tar_samples(url):
                            if self.stop_event.is_set():
                                return
                            try:
                                item = _decode_sample(raw, rng=self.rng, **self.decode_kwargs)
                            except Exception as exn:  # log_and_continue
                                logging.warning(f"wds decode error ({exn!r}). Ignoring.")
                                continue
                            if item is not None:
                                self.out_q.put(item)
                        if self.tracker is not None:
                            self.tracker.record(url)
                    except Exception as exn:
                        logging.warning(f"wds shard error ({exn!r}) for {url}. Ignoring.")
                if not self.resample:
                    break
        finally:
            self.out_q.put(None)  # worker-done sentinel


def wds_dataloader(
    train_data: Sequence[str],
    *,
    batch_size: int,
    resolution: int,
    workers: int = 3,
    sample_shuffle_size: int = 50_000,
    label_type: str = "text",
    filter_keys_path: Optional[str] = None,
    cls_to_text_path: Optional[str] = None,
    data_augmentation: bool = False,
    one_epoch: bool = False,
    processed_tar_read_dir: Optional[str] = None,
    processed_tar_write_dir: Optional[str] = None,
    base_seed: Optional[int] = None,
    num_processes: int = 1,
    process_index: Optional[int] = None,
    queue_size: int = 4096,
    worker_type: str = "process",  # 'process' (GIL-free) | 'thread'
) -> Iterator[Tuple[np.ndarray, list]]:
    """Yields (images (B,H,W,3) uint8, labels list/array) batches forever
    (resampled mode) or until shards are exhausted (one-epoch mode)."""
    assert base_seed is not None, "base_seed must be provided for reproducibility."
    rank = _safe_rank() if process_index is None else process_index
    rng = random.Random(base_seed)

    keep_set = None
    if filter_keys_path and os.path.isfile(filter_keys_path):
        keep_set = set(pickle.load(open(filter_keys_path, "rb")))
    elif filter_keys_path:
        from ..core.logging import print0

        print0(f"[data] filter_keys_path {filter_keys_path} is not a file: the key filter "
               "is skipped, as the reference does (data_wds.py)")
    cls2text = None
    if cls_to_text_path and os.path.isfile(cls_to_text_path):
        cls2text = json.load(open(cls_to_text_path, encoding="utf-8"))
    num_classes = len(cls2text) if cls2text else 0

    train_data = list(train_data)
    tracker = None
    if one_epoch:
        if processed_tar_read_dir:
            skipped_tail = set(get_all_processed_tars(processed_tar_read_dir, workers))
            skipped_full = [u for u in train_data if get_tail(u) in skipped_tail]
            train_data = [u for u in train_data if get_tail(u) not in skipped_tail]
            if processed_tar_write_dir:
                os.makedirs(processed_tar_write_dir, exist_ok=True)
                log_path = os.path.join(
                    processed_tar_write_dir, f"processed_tars_rank{rank:02d}.txt"
                )
                with open(log_path, "a") as f:
                    for u in skipped_full:
                        f.write(u.strip() + "\n")
        if processed_tar_write_dir:
            tracker = ShardTracker(processed_tar_write_dir, rank=rank)
        rng.shuffle(train_data)

    # split_by_node then split_by_worker (data_wds.py:303-305).
    node_shards = train_data[rank::num_processes]
    n_workers = max(1, workers)
    decode_kwargs = dict(
        label_type=label_type,
        resolution=resolution,
        augment=data_augmentation,
        cls2text=cls2text,
        num_classes=num_classes,
        keep_set=keep_set,
    )

    use_processes = worker_type == "process" and workers > 0
    if use_processes:
        import multiprocessing as mp

        # spawn, not fork: forking a process that already initialised CUDA
        # or holds threads risks deadlocks on inherited mutexes; workers
        # import numpy and PIL only.
        ctx = mp.get_context("spawn")
        out_q = ctx.Queue(maxsize=queue_size)
        stop = threading.Event()  # only used by the consumer teardown
        # Parent-death watchdog channel: the parent holds the write end and
        # never sends; when the parent dies BY ANY MEANS the OS closes it
        # and every worker's recv() EOFs -> os._exit (see _parent_watchdog).
        watch_r, watch_w = ctx.Pipe(duplex=False)
        procs = []
        _LOADER_WATCHDOG_KEEPALIVE.append(watch_w)
        for w in range(n_workers):
            p = ctx.Process(
                target=_process_worker_main,
                args=(
                    node_shards[w::n_workers], out_q, decode_kwargs,
                    processed_tar_write_dir if one_epoch else None, rank,
                    base_seed + rank * 1000 + w, not one_epoch, watch_r,
                ),
                daemon=True,
            )
            p.start()
            procs.append(p)
        # Children hold their own dup of the read end after start(); the
        # parent's copy only keeps the fd table fat. Close it now — the
        # watchdog EOF fires when the last WRITE end (watch_w) dies.
        watch_r.close()
    else:
        out_q = queue.Queue(maxsize=queue_size)
        stop = threading.Event()
        threads = []
        for w in range(n_workers):
            t = _ShardWorker(
                node_shards[w::n_workers], out_q, stop, decode_kwargs, tracker,
                seed=base_seed + rank * 1000 + w, resample=not one_epoch,
            )
            t.start()
            threads.append(t)

    def batches():
        buf: list = []
        done_workers = 0
        shuffle_rng = random.Random(base_seed + rank * 1000 + 999)
        shuffle_buf: list = []
        target = min(sample_shuffle_size, queue_size)
        try:
            while done_workers < n_workers:
                item = out_q.get()
                if item is None:
                    done_workers += 1
                    continue
                shuffle_buf.append(item)
                if len(shuffle_buf) >= target:
                    idx = shuffle_rng.randrange(len(shuffle_buf))
                    shuffle_buf[idx], shuffle_buf[-1] = shuffle_buf[-1], shuffle_buf[idx]
                    buf.append(shuffle_buf.pop())
                if len(buf) == batch_size:
                    images = np.stack([b[0] for b in buf])
                    labels = [b[1] for b in buf]
                    if isinstance(labels[0], np.ndarray):
                        labels = np.stack(labels)
                    yield images, labels
                    buf = []
            # Drain remaining (one-epoch tail).
            shuffle_rng.shuffle(shuffle_buf)
            leftovers = buf + shuffle_buf
            for i in range(0, len(leftovers) - batch_size + 1, batch_size):
                chunk = leftovers[i : i + batch_size]
                images = np.stack([b[0] for b in chunk])
                labels = [b[1] for b in chunk]
                if isinstance(labels[0], np.ndarray):
                    labels = np.stack(labels)
                yield images, labels
        finally:
            stop.set()
            if use_processes:
                # Never read the queue after terminating its producers: a
                # worker killed mid-put leaves a truncated pickle in the
                # pipe, and mp.Queue.get_nowait() blocks forever reading
                # payload bytes that will never arrive (observed hang at
                # process exit). Reap and drop the fds instead.
                for p in procs:
                    p.terminate()
                for p in procs:
                    p.join(timeout=5)
                out_q.cancel_join_thread()
                out_q.close()
                # Workers are gone: parent-death coverage is no longer
                # needed, and keeping watch_w in the module keepalive would
                # leak one fd per loader for process lifetime (long suites
                # creep toward the fd limit). Close + drop it.
                try:
                    _LOADER_WATCHDOG_KEEPALIVE.remove(watch_w)
                except ValueError:
                    pass
                watch_w.close()
            else:
                # Thread workers block in put() on the bounded queue; drain
                # so they observe stop_event. queue.Queue.get_nowait never
                # blocks, so this is safe here (and only here).
                try:
                    while True:
                        out_q.get_nowait()
                except queue.Empty:
                    pass

    return batches()


# ------------------------------------------------------------------ facade


class WdsWrapper:
    """Dataset metadata facade (data_wds.py:356-472) with the training loop's `loader`."""

    def __init__(
        self,
        path: str,
        resolution: int,
        label_type: str = "text",
        conditional: bool = False,
        filter_keys_path: Optional[str] = None,
        cls_to_text_path: Optional[str] = None,
        data_augmentation: bool = False,
        one_epoch: bool = False,
        processed_tar_read_dir: Optional[str] = None,
        processed_tar_write_dir: Optional[str] = None,
        sample_shuffle_size: int = 50_000,
        **kwargs,
    ):
        self._root = Path(path)
        # The shuffle buffer fills to min(sample_shuffle_size, 4096) samples
        # before the first batch; small rigs set it lower.
        self.sample_shuffle_size = sample_shuffle_size
        self.resolution = resolution
        self.label_type = label_type
        self.conditional = conditional
        self.filter_keys_path = filter_keys_path
        self.cls_to_text_path = cls_to_text_path
        self.data_augmentation = data_augmentation
        self.one_epoch = one_epoch
        self.processed_tar_read_dir = processed_tar_read_dir
        self.processed_tar_write_dir = processed_tar_write_dir

        if cls_to_text_path and os.path.isfile(cls_to_text_path):
            self._cls2text = json.load(open(cls_to_text_path, encoding="utf-8"))
            self.num_classes = len(self._cls2text)
        else:
            self._cls2text = None
            self.num_classes = 0

        self.urls = self._get_urls(path)

    def _get_urls(self, path: str) -> List[str]:
        if self.label_type in ("cls2text", "cls2id"):
            return sorted(glob(f"{path}/**/*.tar", recursive=True))
        if self.label_type == "text":
            jsons = glob(f"{path}/**/*.json", recursive=True)
            return [p.replace("_stats.json", ".tar") for p in jsons]
        raise ValueError(self.label_type)

    def loader(self, batch_size: int, workers: int = 3, base_seed: int = DEFAULT_SEED,
               num_processes: int = 1, process_index: Optional[int] = None,
               worker_type: str = "process"):
        return wds_dataloader(
            self.urls,
            batch_size=batch_size,
            resolution=self.resolution,
            workers=workers,
            sample_shuffle_size=self.sample_shuffle_size,
            label_type=self.label_type,
            filter_keys_path=self.filter_keys_path,
            cls_to_text_path=self.cls_to_text_path,
            data_augmentation=self.data_augmentation,
            one_epoch=self.one_epoch,
            processed_tar_read_dir=self.processed_tar_read_dir,
            processed_tar_write_dir=self.processed_tar_write_dir,
            base_seed=base_seed,
            num_processes=num_processes,
            process_index=process_index,
            worker_type=worker_type,
        )

    def __len__(self) -> int:
        if self.label_type in ("cls2text", "cls2id"):
            if self.filter_keys_path and os.path.isfile(self.filter_keys_path):
                return len(set(pickle.load(open(self.filter_keys_path, "rb"))))
            return 1281167  # ImageNet-1k
        return len(self.urls) * 10000

    @property
    def image_shape(self) -> List[int]:
        return [self.resolution, self.resolution, 3]  # NHWC

    @property
    def label_shape(self) -> List[int]:
        return [self.num_classes] if self.label_type in ("cls2text", "cls2id") else [1]

    @property
    def label_dim(self) -> int:
        return self.label_shape[0]

    @property
    def name(self) -> str:
        return self._root.name

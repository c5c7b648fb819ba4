"""Dataset listing + threaded prefetching batch loader.

The port's own copy of ``tramba_tpu/data/pipeline.py`` (numpy and PIL only),
with its frequency-feature samples (``freq_stats``, ``data/freq.py``).
Reference semantics: ``data/dataloader.py`` (RGB_Dataset: {root}/{set}/image +
/mask pairs, natural sort, size-mismatch filtering; samples carry name and
original shape).  The torch DataLoader worker-process model is replaced with
a thread pool + prefetch queue feeding the device — decode/augment is
PIL/numpy (GIL released), so threads saturate the host while the card runs.
One difference from the JAX package's copy: a sharded loader
(``shard_count`` > 1, data parallelism) keys each sample's augmentation draws
by its position in the global batch, not in its shard, so N processes load
the very batches one process would.
"""

from __future__ import annotations

import os
import queue
import re
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
from PIL import Image

from tramba_tpu_torch.data.freq import FreqStats, block_dct_features, freq_decompose
from tramba_tpu_torch.data.transforms import (IMAGENET_MEAN, IMAGENET_STD, eval_transform,
                                              train_transform)

Image.MAX_IMAGE_PIXELS = None

__all__ = ["natural_sort", "SODDataset", "BatchLoader"]


def natural_sort(paths: Sequence[str]) -> List[str]:
    """Alphanumeric sort (dataloader.py:128-131)."""

    def key(p):
        return [int(c) if c.isdigit() else c.lower() for c in re.split(r"([0-9]+)", p)]

    return sorted(paths, key=key)


def _list_images(d: str) -> List[str]:
    return natural_sort(
        [os.path.join(d, f) for f in os.listdir(d) if f.lower().endswith((".jpg", ".png"))]
    )


class SODDataset:
    """Image/mask pair dataset: {root}/{set}/image + {root}/{set}/mask.

    With ``freq_stats`` set (a FreqStats or a path to a stats pickle), each
    sample also carries 'high'/'low' 96-channel JPEG-style frequency features
    at 1/8 resolution (the reference's alternative freq_dataloader path,
    data/freq_dataloader.py:85-106).
    """

    def __init__(self, root: str, sets: Sequence[str], img_size: int, mode: str = "train",
                 check_sizes: bool = True, freq_stats=None):
        self.img_size = img_size
        self.mode = mode
        if isinstance(freq_stats, str):
            freq_stats = FreqStats.load(freq_stats)
        self.freq_stats = freq_stats
        self.images: List[str] = []
        self.gts: List[str] = []
        for s in sets:
            self.images.extend(_list_images(os.path.join(root, s, "image")))
            self.gts.extend(_list_images(os.path.join(root, s, "mask")))
        assert len(self.images) == len(self.gts), (len(self.images), len(self.gts))
        if check_sizes:
            self._filter_files()

    def _filter_files(self):
        images, gts = [], []
        for ip, gp in zip(self.images, self.gts):
            assert os.path.splitext(os.path.basename(ip))[0] == os.path.splitext(os.path.basename(gp))[0]
            with Image.open(ip) as im, Image.open(gp) as gt:
                if im.size == gt.size:
                    images.append(ip)
                    gts.append(gp)
        self.images, self.gts = images, gts

    def __len__(self) -> int:
        return len(self.images)

    def get(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict:
        image = Image.open(self.images[index]).convert("RGB")
        gt = Image.open(self.gts[index]).convert("L")
        sample = {
            "image": image,
            "gt": gt,
            "name": os.path.splitext(os.path.basename(self.images[index]))[0],
            "shape": gt.size,  # (W, H), PIL convention — matches reference
        }
        if self.mode == "train":
            sample = train_transform(sample, self.img_size, rng or np.random.default_rng())
        else:
            sample = eval_transform(sample, self.img_size)
        if self.freq_stats is not None:
            raw = (sample["image"] * IMAGENET_STD + IMAGENET_MEAN) * 255.0
            high, low = freq_decompose(block_dct_features(raw))
            sample["high"], sample["low"] = self.freq_stats.normalize(high, low)
        return sample


class BatchLoader:
    """Threaded prefetching batch iterator over a SODDataset.

    Yields dicts with stacked 'image' (B,H,W,3) / 'gt' (B,H,W,1) float32
    arrays (and 'high' / 'low' where the dataset has frequency features)
    plus per-sample 'name' and 'shape' lists.
    """

    def __init__(self, dataset: SODDataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, num_threads: int = 8, drop_last: bool = False,
                 prefetch: int = 4, shard_rank: int = 0, shard_count: int = 1):
        """``batch_size`` is the GLOBAL batch; with ``shard_count`` > 1 each
        host deterministically loads only its contiguous slice of every
        global batch (multi-host DCN data parallelism — every host computes
        the identical global permutation from the shared seed)."""
        if shard_count > 1:
            assert batch_size % shard_count == 0, (batch_size, shard_count)
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.shard_rank = shard_rank
        self.shard_count = shard_count
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> List[List[int]]:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        out = [list(idx[i : i + self.batch_size]) for i in range(0, len(idx), self.batch_size)]
        if (self.drop_last or self.shard_count > 1) and out and len(out[-1]) < self.batch_size:
            # multi-host: a ragged global batch cannot split evenly -> drop it
            out.pop()
        if self.shard_count > 1:
            per = self.batch_size // self.shard_count
            lo = self.shard_rank * per
            out = [b[lo : lo + per] for b in out]
        return out

    def __iter__(self) -> Iterator[Dict]:
        batches = self._batches()
        epoch = self._epoch
        self._epoch += 1
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        # this shard's first position in each global batch: the augmentation
        # draws are keyed by the global position, as one process draws them
        offset = self.shard_rank * (self.batch_size // self.shard_count)

        def load_batch(bi, batch):
            samples = []
            for j, i in enumerate(batch):
                rng = np.random.default_rng((self.seed, epoch, bi, offset + j))
                samples.append(self.ds.get(int(i), rng))
            out = {
                "image": np.stack([s["image"] for s in samples]),
                "gt": np.stack([s["gt"] for s in samples]),
                "name": [s["name"] for s in samples],
                "shape": [s["shape"] for s in samples],
            }
            for key in ("high", "low"):
                if key in samples[0]:
                    out[key] = np.stack([s[key] for s in samples])
            return out

        def producer():
            # Rolling submission window: at most prefetch + num_threads batches
            # are decoded-but-undelivered at any time, and each Future reference
            # is dropped after hand-off so completed batches are collectable.
            # Abandoning the iterator (stop set) halts further submissions.
            window = self.prefetch + self.num_threads

            def put_interruptible(item):
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return
                    except queue.Full:
                        continue

            pending = deque()
            try:
                with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                    it = enumerate(batches)
                    exhausted = False
                    while not stop.is_set():
                        while not exhausted and len(pending) < window:
                            nxt = next(it, None)
                            if nxt is None:
                                exhausted = True
                                break
                            pending.append(pool.submit(load_batch, nxt[0], nxt[1]))
                        if not pending:
                            break
                        put_interruptible(pending.popleft().result())
                    for f in pending:
                        f.cancel()
                put_interruptible(None)
            except BaseException as e:  # surface decode errors to the consumer
                put_interruptible(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

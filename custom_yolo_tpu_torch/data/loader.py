"""Host-side batched data loader with threaded decode and prefetch (the
port's own copy of ``custom_yolo_tpu/data/loader.py``).

* JPEG decode and resize in a thread pool (PIL releases the interpreter
  lock while it decodes), or in the native decoder
  (:mod:`custom_yolo_tpu_torch.runtime`) when it builds;
* batches are stacked numpy: uint8 images and fixed-shape padded ground
  truth, under the keys of :func:`_stack`;
* a bounded queue of ``prefetch_factor`` batches keeps decode ahead of the
  device;
* the order is reshuffled per epoch from ``seed + epoch``, and each process
  takes every ``process_count``-th sample.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from custom_yolo_tpu_torch.data.dataset import DetectionDataset


def _stack(samples, pad_to: int = 1) -> Dict[str, np.ndarray]:
    n = len(samples)
    pad = (-n) % pad_to
    out = {}
    for key in samples[0]:
        arr = np.stack([s[key] for s in samples])
        if pad:
            rep = arr[np.arange(pad) % n]  # cycle when pad > n
            arr = np.concatenate([arr, rep], axis=0)
        out[key] = arr
    sample_pad = np.zeros(n + pad, bool)
    sample_pad[n:] = True
    out["sample_pad"] = sample_pad
    return out


class DataLoader:
    def __init__(self, dataset: DetectionDataset, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 num_workers: int = 8, prefetch_factor: int = 2,
                 seed: int = 42, process_index: int = 0,
                 process_count: int = 1, use_native: Optional[bool] = None,
                 pad_to_multiple: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        # pad ragged final batches (drop_last=False) up to a multiple of
        # this by repeating leading samples; repeats are flagged in the
        # batch's "sample_pad" array so evaluation skips them (a batch
        # split over devices must divide evenly)
        self.pad_to_multiple = max(1, pad_to_multiple)
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch_factor)
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

        self._native = None
        if use_native is not False:
            from custom_yolo_tpu_torch.runtime import (NativeDecoder,
                                                       native_available)
            if native_available():
                self._native = NativeDecoder(self.num_workers)
            # the native decoder squash-resizes; letterbox geometry needs
            # the PIL path (pad-aware decode)
            if getattr(dataset, "letterbox", False) and self._native:
                if use_native is True:
                    raise RuntimeError(
                        "native decoder does not support letterbox=True")
                self._native = None
            if use_native is True and self._native is None:
                raise RuntimeError("native decoder requested but unavailable")

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle deterministically per epoch."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        # this process's share: every process_count-th index
        idx = idx[self.process_index::self.process_count]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._indices()
        nb = len(self)
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def make_batch_native(batch_idx):
            paths = [self.dataset.image_path(i) for i in batch_idx]
            h, w = self.dataset.input_size
            images, sizes, _ = self._native.decode_batch(paths, h, w)
            samples = [self.dataset.annotations(i, int(sizes[j, 0]),
                                                int(sizes[j, 1]))
                       for j, i in enumerate(batch_idx)]
            batch = _stack(samples, self.pad_to_multiple)
            n = len(batch_idx)
            pad = (-n) % self.pad_to_multiple
            if pad:
                images = np.concatenate(
                    [images, images[np.arange(pad) % n]], axis=0)
            batch["image"] = images
            return batch

        def produce():
            if self._native is not None:
                for batch_idx in batches:
                    if stop.is_set():
                        return
                    q.put(make_batch_native(batch_idx))
                q.put(None)
                return
            with ThreadPoolExecutor(self.num_workers) as pool:
                for batch_idx in batches:
                    if stop.is_set():
                        return
                    samples = list(pool.map(self.dataset.__getitem__,
                                            batch_idx))
                    q.put(_stack(samples, self.pad_to_multiple))
            q.put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()


def get_data_loaders(config, process_index: int = 0, process_count: int = 1,
                     percent: float = 1.0, pad_val_to_multiple: int = 1
                     ) -> Tuple[DataLoader, DataLoader]:
    """(train, val) loaders from a Config. ``percent`` subsamples both
    splits; ``pad_val_to_multiple`` pads ragged validation batches."""
    d = config.data
    t = config.training
    letterbox = getattr(d, "letterbox", False)
    kw = dict(input_size=tuple(config.model.input_size), is_test=t.is_test,
              max_gt=d.max_gt_boxes, seed=config.project.seed,
              percent=percent, letterbox=letterbox)
    train_ds = DetectionDataset(
        os.path.join(d.processed_dir, d.train_parquet), d.train_images, **kw)
    val_ds = DetectionDataset(
        os.path.join(d.processed_dir, d.val_parquet), d.val_images, **kw)
    train = DataLoader(train_ds, t.batch_size, shuffle=True, drop_last=True,
                       num_workers=d.num_workers,
                       prefetch_factor=d.prefetch_factor,
                       seed=config.project.seed,
                       process_index=process_index,
                       process_count=process_count)
    val = DataLoader(val_ds, t.batch_size, shuffle=False, drop_last=False,
                     num_workers=d.num_workers,
                     prefetch_factor=d.prefetch_factor,
                     seed=config.project.seed,
                     process_index=process_index,
                     process_count=process_count,
                     pad_to_multiple=pad_val_to_multiple)
    return train, val

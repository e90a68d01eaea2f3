"""Fixed-shape batch loader with background prefetch.

Port of navc_tpu/data/loader.py (reference misc/run.py:89-96): items are
collated into fixed-shape NumPy batches, the final partial batch padded and
flagged by ``valid_mask``, and an optional background thread keeps a
prefetch queue full so the step never waits on feature reads. The
host-to-device copy is the train step's (pinned, non-blocking:
``runtime.train_step.to_device``); navc_tpu's multi-host sharding is not
ported.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from .dataset import VideoDataset

ARRAY_KEYS = (
    "tokens", "labels", "tokens_1", "labels_1", "taggings",
    "length_target", "category",
)


def collate(items: List[Dict[str, Any]], batch_size: int) -> Dict[str, Any]:
    """Stack items into one fixed-shape batch, padding to ``batch_size``."""
    n = len(items)
    assert 0 < n <= batch_size
    batch: Dict[str, Any] = {}
    keys = items[0].keys()
    for k in keys:
        v0 = items[0][k]
        if isinstance(v0, np.ndarray) or k in ARRAY_KEYS:
            arr = np.stack([np.asarray(it[k]) for it in items])
            if n < batch_size:
                pad = np.zeros((batch_size - n,) + arr.shape[1:], arr.dtype)
                arr = np.concatenate([arr, pad], axis=0)
            batch[k] = arr
        else:  # metadata (video ids, caption ids)
            batch[k] = [it[k] for it in items] + [None] * (batch_size - n)
    batch["valid_mask"] = (np.arange(batch_size) < n).astype(np.float32)
    batch["num_valid"] = n
    return batch


class BatchLoader:
    """Iterate a VideoDataset in fixed-shape batches; train mode shuffles
    the item order each epoch with the dataset's seeded RNG (the reference
    relies on torch DataLoader shuffle, misc/run.py:95)."""

    def __init__(self, dataset: VideoDataset, batch_size: int,
                 shuffle: bool = False, prefetch: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.prefetch = prefetch

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _iter_batches(self) -> Iterator[Dict[str, Any]]:
        n = len(self.dataset)
        order = self.dataset.random.permutation(n) if self.shuffle else np.arange(n)
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            items = [self.dataset[int(i)] for i in idx]
            yield collate(items, self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.prefetch <= 0:
            yield from self._iter_batches()
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: List[BaseException] = []

        stop = threading.Event()

        def _put(item) -> bool:
            # blocking put that aborts when the consumer abandoned the
            # epoch (break / exception in the train step) — a plain
            # q.put() would pin this thread in a full queue forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in self._iter_batches():
                    if not _put(b):
                        return
            except BaseException as e:  # surfaced in the consumer
                error.append(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is sentinel:
                    break
                yield b
        finally:
            stop.set()
            try:  # unblock a producer waiting on a full queue, then reap it
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5)
        if error:
            raise error[0]


def get_loader(cfg, mode: str, info_corpus=None, in_memory_feats=None,
               prefetch: Optional[int] = None) -> BatchLoader:
    """Reference misc/run.py:89-96 ``get_loader``."""
    ds = VideoDataset(cfg, mode, info_corpus=info_corpus,
                      in_memory_feats=in_memory_feats)
    return BatchLoader(
        ds,
        batch_size=cfg.batch_size,
        shuffle=(mode == "train"),
        prefetch=cfg.prefetch_depth if prefetch is None else prefetch,
    )

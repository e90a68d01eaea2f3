"""Fixed-shape batch loader with background prefetch.

Port of navc_tpu/data/loader.py (reference misc/run.py:89-96): items are
collated into fixed-shape NumPy batches, the final partial batch padded and
flagged by ``valid_mask``, and an optional background thread keeps a
prefetch queue full so the step never waits on feature reads. The
host-to-device copy is the train step's (through page-locked slots,
non-blocking: ``runtime.graphs.PinnedSlots``). Sharded over ranks, each
iterates a disjoint strided slice of one epoch order, wrap-padded so every
shard has the same number of batches and the ranks' steps stay in lockstep.
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
    relies on torch DataLoader shuffle, misc/run.py:95).

    With ``num_shards`` / ``shard_id`` every shard iterates a disjoint
    strided slice of the same epoch permutation (drawn from the dataset's
    ``structure_random``, alike on every rank), padded by wrapping so every
    shard has exactly the same number of batches (torch DistributedSampler
    semantics, navc_tpu loader.py:53-99).
    """

    def __init__(self, dataset: VideoDataset, batch_size: int,
                 shuffle: bool = False, prefetch: int = 0,
                 num_shards: int = 1, shard_id: int = 0):
        assert 0 <= shard_id < num_shards
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.num_shards = num_shards
        self.shard_id = shard_id

    def __len__(self) -> int:
        per_shard = -(-len(self.dataset) // self.num_shards)
        return -(-per_shard // self.batch_size)

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            # per-item draws advance dataset.random differently on every
            # shard: the permutation comes from the lockstep stream
            rng = (self.dataset.structure_random if self.num_shards > 1
                   else self.dataset.random)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self.num_shards > 1:
            total = -(-n // self.num_shards) * self.num_shards
            # np.resize tiles the order as often as needed: with fewer
            # items than shards a single wrap would leave shards unequal
            order = np.resize(order, total)[self.shard_id::self.num_shards]
        return order

    def _iter_batches(self) -> Iterator[Dict[str, Any]]:
        order = self._order()
        for start in range(0, len(order), self.batch_size):
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
               batch_size: Optional[int] = None, specific: int = -1,
               prefetch: Optional[int] = None, host_shard: bool = False,
               mesh=None) -> BatchLoader:
    """Reference misc/run.py:89-96 ``get_loader``; ``batch_size`` overrides
    the config's, ``specific`` >= 0 keeps one category's videos.

    ``host_shard=True``: shard the epoch over the 'data' coordinate of
    ``mesh`` (a ``parallel.Mesh``; default every rank a shard of its own),
    so the ranks of one 'model' group load the same rows; ``batch_size`` is
    then the per-rank batch."""
    ds = VideoDataset(cfg, mode, info_corpus=info_corpus,
                      in_memory_feats=in_memory_feats, specific=specific)
    num_shards, shard_id = 1, 0
    if host_shard:
        from ..parallel import distributed

        num_shards, shard_id = ((mesh.data, mesh.data_index) if mesh is not None else
                                (distributed.process_count(), distributed.process_index()))
        ds.host_lockstep = True
    return BatchLoader(
        ds,
        batch_size=batch_size or cfg.batch_size,
        shuffle=(mode == "train"),
        prefetch=cfg.prefetch_depth if prefetch is None else prefetch,
        num_shards=num_shards, shard_id=shard_id,
    )

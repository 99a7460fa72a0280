"""Deterministic splits and a sharded, prefetching batch loader
(``rangeclip_tpu/data/loader.py``), worker threads.

The 60/20/20 split is the reference's (python's ``random.Random(42)``
shuffle); the per-epoch order is a numpy permutation of (0 + epoch); each
sample draws from ``np.random.default_rng((0, epoch, shard, position))``
(seed, epoch, shard, position: the JAX loader's key), so thread count and
completion order never change the data, and batches equal the JAX loader's
on the same files.  ``num_shards > 1`` gives each rank of a distributed run
its shard as torch's DistributedSampler does (the order padded to a
multiple of the shard count by wrapping, then every ``num_shards``-th
index from ``shard_id``), so every rank takes the same number of batches.
Batches are fixed-shape: a final ragged batch repeats its first sample with
``sample_valid = 0``.
"""

from __future__ import annotations

import inspect
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

_SEED = 0  # with the epoch, keys the order and the per-sample draws
_PREFETCH = 2  # batches built ahead of the consumer
# the dtypes the train and val steps take each batch key in
BATCH_DTYPES = {"depth": np.float32, "segmentation": np.int32,
                "object_label": np.int32, "sample_valid": np.float32,
                "image": np.float32, "object_bbox": np.int32}


def deterministic_split(n: int) -> Tuple[List[int], List[int], List[int]]:
    """60/20/20 split identical to the reference (dataloader.py:95-109)."""
    indices = list(range(n))
    random.Random(42).shuffle(indices)
    split1, split2 = int(0.6 * n), int(0.8 * n)
    return indices[:split1], indices[split1:split2], indices[split2:]


def _order(indices: Sequence[int], epoch: int, shuffle: bool,
           shard_id: int = 0, num_shards: int = 1) -> List[int]:
    """This shard's indices in the epoch's order (``_shard_indices``)."""
    idx = list(indices)
    if shuffle:
        g = np.random.default_rng(_SEED + epoch)
        idx = [idx[i] for i in g.permutation(len(idx))]
    if num_shards > 1 and idx:
        total = -(-len(idx) // num_shards) * num_shards
        idx = [idx[i % len(idx)] for i in range(total)][shard_id::num_shards]
    return idx


class ShardedBatchLoader:
    """Iterates fixed-shape batches of a dataset subset, built by a pool of
    threads ahead of the consumer.  Yields dicts of stacked numpy arrays
    with an extra ``sample_valid`` [B] float32 mask."""

    def __init__(self, dataset, indices: Sequence[int], batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 4, shard_id: int = 0,
                 num_shards: int = 1):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard {shard_id} of {num_shards}")
        self.dataset = dataset
        self.indices = list(indices)
        self.batch_size = batch_size
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.epoch = 0
        try:
            self._takes_rng = "rng" in inspect.signature(
                dataset.__getitem__).parameters
        except (TypeError, ValueError):
            self._takes_rng = False

    def set_epoch(self, epoch: int) -> None:
        """Per-epoch reshuffle hook (train_util.py:273)."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(_order(self.indices, 0, False, self.shard_id,
                       self.num_shards))
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _fetch(self, args) -> Dict[str, np.ndarray]:
        i, position = args
        if self._takes_rng:
            rng = np.random.default_rng((_SEED, self.epoch, self.shard_id,
                                         position))
            return self.dataset.__getitem__(i, rng=rng)
        return self.dataset[i]

    def _make_batch(self, pool, batch_indices: List[int],
                    start: int) -> Dict[str, np.ndarray]:
        n_real = len(batch_indices)
        padded = batch_indices + [batch_indices[0]] * (self.batch_size
                                                       - n_real)
        samples = list(pool.map(self._fetch, zip(
            padded, range(start, start + self.batch_size))))
        batch = {k: np.stack([s[k] for s in samples], axis=0)
                 for k in samples[0]}
        valid = np.zeros((self.batch_size,), np.float32)
        valid[:n_real] = 1.0
        batch["sample_valid"] = valid
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = _order(self.indices, self.epoch, self.shuffle, self.shard_id,
                     self.num_shards)
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH)
        done = object()
        stop = threading.Event()
        error: List[BaseException] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for bi, b in enumerate(batches):
                        if stop.is_set() or not put(self._make_batch(
                                pool, b, bi * self.batch_size)):
                            return
            except BaseException as e:  # re-raised by the consumer
                error.append(e)
            finally:
                put(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                yield item
            thread.join()
            if error:
                raise RuntimeError("the loader failed while building a "
                                   "batch") from error[0]
        finally:
            stop.set()


def setup_dataloaders(metadata_file: str, labels_file: str,
                      resize_shape: Tuple[int, int], batch_size: int,
                      n_epoch: int, shard_id: int = 0, num_shards: int = 1):
    """Train/val/test loaders and labels (dataloader.py:11-140): returns
    (train_loader, val_loader, test_loader, n_train_steps, labels).  Each
    loader yields shard ``shard_id`` of ``num_shards`` (JAX's
    ``setup_dataloaders``): a distributed run validates over every rank's
    shard."""
    from rangeclip_tpu_torch.data.dataset import ImageDepthTextDataset

    dataset = ImageDepthTextDataset(metadata_file, labels_file, resize_shape)
    train_idx, val_idx, test_idx = deterministic_split(len(dataset))
    train = ShardedBatchLoader(dataset, train_idx, batch_size, shuffle=True,
                               drop_last=True, shard_id=shard_id,
                               num_shards=num_shards)
    val = ShardedBatchLoader(dataset, val_idx, batch_size,
                             shard_id=shard_id, num_shards=num_shards)
    test = ShardedBatchLoader(dataset, test_idx, batch_size,
                              shard_id=shard_id, num_shards=num_shards)
    n_train_steps = -(-len(train_idx) // batch_size) * n_epoch
    return train, val, test, n_train_steps, dataset.labels

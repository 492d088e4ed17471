"""Background-prefetching batch loader (twin of `anystereo_tpu/data/loader.py`).

A thread pool decodes and augments samples (numpy releases the interpreter
lock in its large operations) and a bounded queue overlaps host data work
with device steps.  Shapes are static by construction (fixed crop, fixed
sample_q).  `to_device`, `device_prefetch` and `CheckpointablePrefetch`
move batches to the card from pinned host memory, one batch ahead.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from anystereo_tpu_torch.utils.device import process_topology, resolve_device


def collate_batch(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}


def to_device(batch: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """Copy one numpy batch to `device` (default: the CUDA card; the CPU only
    when asked for by name): each array into its own pinned host tensor, then
    `non_blocking` onto the card.  Every batch gets fresh pinned buffers, so
    no copy still in flight can see its buffer reused."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":  # page-locked, so that the copy runs asynchronously
            t = t.pin_memory()
        out[k] = t.to(dev, non_blocking=True)
    return out


def device_prefetch(iterator: Iterator[Dict[str, np.ndarray]], size: int = 2, device=None):
    """Wrap a host-batch iterator so that the copy of batch N+1 to the card is
    queued while the step runs on batch N: yields device-resident batches,
    `size - 1` ahead."""
    import collections

    buf = collections.deque()
    for batch in iterator:
        buf.append(to_device(batch, device))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


class CheckpointablePrefetch:
    """One-batch device prefetch over a checkpointable (get_state/set_state)
    iterator: the copy of batch N+1 overlaps the step running on batch N
    — without breaking the trainer's exactly-once checkpoint contract,
    because the serialized iterator state is snapshotted around every
    fetch and exposed paired with the batch actually handed out.

    After next() returns batch N:
      * state_of_current    — state whose next fetch is batch N (the
        emergency-checkpoint sidecar: the failed step's batch replays);
      * state_after_current — state whose next fetch is batch N+1 (the
        normal post-step checkpoint sidecar).
    """

    def __init__(self, it, place=None):
        self._it = it
        self._place = to_device if place is None else place
        self._buf_state = it.get_state()  # points at the buffered batch
        self._buf = self._place(next(it))
        self._next_state = it.get_state()  # points at the batch after it
        self.state_of_current = None
        self.state_after_current = None

    def __iter__(self):
        return self

    def __next__(self):
        batch = self._buf
        self.state_of_current = self._buf_state
        self.state_after_current = self._next_state
        self._buf_state = self._next_state
        self._buf = self._place(next(self._it))
        self._next_state = self._it.get_state()
        return batch


class _Failed:
    """What the producer thread hands the consumer when making a batch
    raised: the consumer re-raises it instead of waiting for a batch that
    never comes."""

    def __init__(self, error: BaseException):
        self.error = error


class PrefetchLoader:
    """Iterate shuffled batches forever (drop_last semantics).  An error
    raised while making a batch (a file that does not decode, say) is raised
    by the iterator.

    Each epoch reshuffles with a per-epoch seed derived from `seed`; each
    sample gets its own RandomState so augmentation is reproducible and
    thread-order independent (the per-worker reseed of
    stereo_datasets.py:90-96 made deterministic).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        num_workers: int = 8,
        seed: int = 0,
        prefetch: int = 4,
        shuffle: bool = True,
        host_index: Optional[int] = None,
        host_count: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.prefetch = prefetch
        self.shuffle = shuffle
        # multi-host data sharding: every host shuffles with the same seed
        # (so the global permutation agrees) then takes its strided slice —
        # batch_size is the PER-HOST batch.  Defaults to the rank and world
        # size of an initialised torch.distributed group, else 0 and 1.
        rank, world = process_topology()
        host_index = rank if host_index is None else host_index
        host_count = world if host_count is None else host_count
        if not 0 <= host_index < host_count:
            raise ValueError(f"host_index {host_index} not in [0, {host_count})")
        self.host_index = host_index
        self.host_count = host_count

    def __len__(self) -> int:
        return len(self.dataset) // self.host_count // self.batch_size

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        idx = idx[self.host_index :: self.host_count]
        # truncate to the COMMON per-host length: with len(dataset) not
        # divisible by host_count, earlier hosts would otherwise see one
        # more sample per epoch, de-phasing the hosts' epoch counters and
        # breaking the disjoint-slices-of-one-shuffle guarantee over time
        idx = idx[: len(self.dataset) // self.host_count]
        n = (len(idx) // self.batch_size) * self.batch_size
        return idx[:n]

    def _sample(self, index: int, sample_seed: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(sample_seed)
        return self.dataset.__getitem__(int(index), rng=rng)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                produce()
            except BaseException as e:  # noqa: BLE001 - handed to the consumer, which re-raises
                if not stop.is_set():
                    out_q.put(_Failed(e))

        def produce():
            epoch = 0
            with ThreadPoolExecutor(self.num_workers) as pool:
                while not stop.is_set():
                    idx = self._epoch_indices(epoch)
                    for b0 in range(0, len(idx), self.batch_size):
                        if stop.is_set():
                            return
                        chunk = idx[b0 : b0 + self.batch_size]
                        seeds = [
                            self.seed * 1_000_003 + epoch * 10_007 + int(i)
                            for i in chunk
                        ]
                        samples = list(pool.map(self._sample, chunk, seeds))
                        out_q.put(collate_batch(samples))
                    epoch += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if isinstance(item, _Failed):
                    raise item.error
                yield item
        finally:
            stop.set()
            # drain so the producer can exit a blocking put
            try:
                while True:
                    out_q.get_nowait()
            except Exception:
                # includes queue.Empty, and the TypeError the stdlib queue
                # itself raises at interpreter teardown when its module
                # globals (queue.Empty) have been cleared to None
                pass

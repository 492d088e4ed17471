"""Deterministic, checkpointable input pipeline (twin of
`anystereo_tpu/data/grain_loader.py`), without grain.

What the thread-pool `PrefetchLoader` cannot give: the iterator's state
serialises beside the model checkpoint, so a preempted run resumes mid-epoch
with no sample repeated and none skipped, in the JAX package's exact order.
Order, per-sample RNG and batch composition are grain's:

* the order is grain's `IndexSampler`: the host takes the contiguous shard
  `[L * host_index, L * (host_index + 1))` of the records, L = len(dataset)
  // host_count (the remainder dropped), and epoch e of the shard is permuted
  by `index_shuffle(i, L - 1, (seed + e) % 2**32)` (`data/index_shuffle.py`);
  the host's j-th record is `L * host_index + perm_{j // L}[j % L]` and its
  sampler index is `host_index + j * host_count`;
* the record with sampler index g is made with `dataset.__getitem__(key,
  rng=RandomState(uint32(Generator(Philox(key=seed + g)).integers(0, 2**31))))`;
* grain's workers: worker w of W reads the host's records w, w + W, ...,
  batches them itself, and the batches come out from worker 0, 1, ..., W-1
  in turn; so batch t holds records w + (b * batch_size + r) * W, r <
  batch_size, for w = t % W and b = t // W (W = 1 without workers).  The
  batches depend on `num_workers`, as in grain.

The records are made by a `torch.utils.data.DataLoader` over a batch sampler
that yields those batches in that order; its worker processes keep the
order, so `num_workers` there only runs the samples in parallel.  The state
(`get_state`, JSON) holds grain's three fields: `last_seen_indices`, the
sampler index of each worker's last record, `last_worker_index` and
`worker_count`; `set_state` accepts the state of the JAX package's loader
too.

Usage:
    loader = GrainLoader(dataset, batch_size=2, seed=0, num_workers=4)
    it = iter(loader)
    batch = next(it)           # dict of stacked numpy arrays
    state = it.get_state()     # bytes: save with the model checkpoint
    it.set_state(state)        # resume exactly here
"""

from __future__ import annotations

import json
import multiprocessing
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch.utils.data

from anystereo_tpu_torch.data.index_shuffle import epoch_permutation
from anystereo_tpu_torch.data.loader import collate_batch
from anystereo_tpu_torch.utils.device import process_topology


def _record_rng(seed: int, index: int) -> np.random.RandomState:
    """The RandomState that record `index` of the sampler is augmented with."""
    g = np.random.Generator(np.random.Philox(key=seed + index))
    return np.random.RandomState(np.uint32(g.integers(0, 2**31)))


def _worker_context():
    """The workers' start method: forks of multiprocessing's fork server, a
    fresh single-threaded interpreter (a fork of this process would copy
    its threads' locks and its CUDA state) that has imported torch, the
    port's data modules and the host C's build helper (with the `ops`
    package around it) once, so a restart (as `set_state` makes) costs a
    fork, not an interpreter's start."""
    ctx = multiprocessing.get_context("forkserver")
    # read when the server starts, the first time any caller uses it
    ctx.set_forkserver_preload(["__main__", "anystereo_tpu_torch.data.datasets",
                                "anystereo_tpu_torch.ops.kernels.build", __name__])
    return ctx


class _Records(torch.utils.data.Dataset):
    """(record key, sampler index) -> the dataset's sample for that key, made
    with the sampler index's RNG."""

    def __init__(self, dataset, seed: int):
        self.dataset = dataset
        self.seed = seed

    def __getitem__(self, item: Tuple[int, int]) -> Dict[str, np.ndarray]:
        key, index = item
        return self.dataset.__getitem__(key, rng=_record_rng(self.seed, index))


class _Batches(torch.utils.data.Sampler):
    """The loader's batches from batch `start` on, forever."""

    def __init__(self, loader: "GrainLoader", start: int):
        self.loader = loader
        self.start = start

    def __iter__(self):
        t = self.start
        while True:
            yield self.loader._batch_records(t)
            t += 1


class GrainLoader:
    """Deterministic, checkpointable batch loader over a stereo dataset.

    `batch_size` is per host (as for `PrefetchLoader`); the host defaults to
    the rank and world size of an initialised torch.distributed group, else
    0 of 1.  Iterates forever with a fresh shuffle each epoch; every batch
    is full."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        num_workers: int = 0,
        seed: int = 0,
        shuffle: bool = True,
        host_index: Optional[int] = None,
        host_count: Optional[int] = None,
    ):
        rank, world = process_topology()
        host_index = rank if host_index is None else host_index
        host_count = world if host_count is None else host_count
        if not 0 <= host_index < host_count:
            raise ValueError(f"host_index {host_index} not in [0, {host_count})")
        if not 0 <= seed < 2**32:
            raise ValueError(f"seed {seed} not in [0, 2**32)")
        if num_workers < 0:
            raise ValueError(f"num_workers {num_workers} must be >= 0")
        self.host_index, self.host_count = host_index, host_count
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed
        self.shuffle = shuffle
        self.shard_len = len(dataset) // host_count
        if self.shard_len <= 0:
            raise ValueError(f"{len(dataset)} records leave none for each of {host_count} hosts")
        self._perms: Dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.dataset) // self.host_count // self.batch_size

    def _epoch(self, e: int) -> np.ndarray:
        # two epochs kept: with workers, one batch's records can straddle two
        if e not in self._perms:
            if len(self._perms) >= 2:
                self._perms.pop(min(self._perms))
            n = self.shard_len
            self._perms[e] = (epoch_permutation(n, (self.seed + e) % 2**32) if self.shuffle
                              else np.arange(n, dtype=np.int64))
        return self._perms[e]

    def _record(self, j: int) -> Tuple[int, int]:
        """(record key, sampler index) of the host's j-th record."""
        e, i = divmod(j, self.shard_len)
        key = self.shard_len * self.host_index + int(self._epoch(e)[i])
        return key, self.host_index + j * self.host_count

    def _batch_records(self, t: int) -> List[Tuple[int, int]]:
        """The records of batch t, in order."""
        w_count = max(self.num_workers, 1)
        w, b = t % w_count, t // w_count
        return [self._record(w + (b * self.batch_size + r) * w_count) for r in range(self.batch_size)]

    def _state(self, t: int) -> Dict:
        """Grain's state after t batches."""
        w_count, s_count = max(self.num_workers, 1), self.host_count
        seen = {}
        for w in range(w_count):
            records = (t - w + w_count - 1) // w_count * self.batch_size  # worker w's, so far
            # the sampler index of the worker's last record (before the first: one stride back)
            seen[str(w)] = self.host_index + (w + (records - 1) * w_count) * s_count
        last = (t - 1) % w_count if self.num_workers and t else -1
        return {"last_seen_indices": seen, "last_worker_index": last, "worker_count": self.num_workers}

    def _batches_done(self, state: Dict) -> int:
        """The t of `_state(t)`; ValueError for a state of another loader."""
        if state.get("worker_count") != self.num_workers:
            raise ValueError(f"loader state of {state.get('worker_count')} workers, "
                             f"this loader has {self.num_workers}")
        w_count, s_count = max(self.num_workers, 1), self.host_count
        stride = w_count * s_count
        t = 0
        for w in range(w_count):
            # the records worker w has made: one stride past its last, over the stride
            made = (int(state["last_seen_indices"][str(w)]) + stride - self.host_index - w * s_count) // stride
            t += made // self.batch_size
        if self._state(t) != {k: state.get(k) for k in ("last_seen_indices", "last_worker_index", "worker_count")}:
            raise ValueError(f"loader state {state} is not one of this loader's")
        return t

    def __iter__(self) -> "GrainIterator":
        return GrainIterator(self)


class GrainIterator:
    """The loader's iterator: batches from `DataLoader` worker processes
    (none without workers; forked from a fresh server process, so the
    dataset must pickle), with `get_state` / `set_state`.  A sample that
    raises raises here."""

    def __init__(self, loader: GrainLoader):
        self.loader = loader
        self.next_batch = 0
        self._it = None

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._it is None:
            ld = self.loader
            self._it = iter(torch.utils.data.DataLoader(
                _Records(ld.dataset, ld.seed),
                batch_sampler=_Batches(ld, self.next_batch),
                num_workers=ld.num_workers,
                collate_fn=collate_batch,
                multiprocessing_context=_worker_context() if ld.num_workers else None,
            ))
        batch = next(self._it)
        self.next_batch += 1
        return batch

    def get_state(self) -> bytes:
        return json.dumps(self.loader._state(self.next_batch), indent=4).encode()

    def set_state(self, state) -> None:
        """Resume at `state`: the batches made ahead for the old position are
        dropped and the workers restart at the new one."""
        t = self.loader._batches_done(json.loads(state))
        self.close()
        self.next_batch = t

    def close(self) -> None:
        """Stop the worker processes (the next `next` starts them again)."""
        it, self._it = self._it, None
        # torch's worker iterator has no public close; without workers there is nothing to stop
        shutdown = getattr(it, "_shutdown_workers", None)
        if shutdown is not None:
            shutdown()

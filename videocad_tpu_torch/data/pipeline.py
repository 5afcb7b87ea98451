"""Host input pipeline: sharded sampling, background assembly, device feed.

Port of ``videocad_tpu/data/pipeline.py``:

  * deterministic per-epoch shuffling with a contiguous per-host shard
    (each process reads only its slice), or, for the data ranks of a mesh
    (``rows``), the single process's order with each rank assembling only
    its rows ``[r * B / dp, (r + 1) * B / dp)`` of every global batch, so
    that a data-parallel step sees the batch one process would;
  * a bounded pool of threads assembles padded uint8 batches ahead of the
    consumer and emits them in batch order (bytes stay small: channels stay
    uint8 until the device);
  * :func:`device_prefetch` keeps ``size`` batches in flight on the card:
    each batch goes into pinned host memory and is copied with
    ``non_blocking`` on a side CUDA stream, so step N+1's transfer overlaps
    step N's compute; the grayscale and normalize preprocessing happens on
    the device inside the step (``ops/preprocess.py``).
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from videocad_tpu_torch.data.collate import (DEFAULT_BUCKETS, check_rows,
                                             collate)
from videocad_tpu_torch.data.dataset import VideoCADDataset
from videocad_tpu_torch.utils.trace import span


class ShardedSampler:
    """Deterministic epoch shuffling, a contiguous per-host shard, and
    drop_last; with ``rows`` = (data rank r, data ranks dp), the rows
    ``[r * B / dp, (r + 1) * B / dp)`` of each global batch of size B."""

    def __init__(self, num_items: int, batch_size: int, shuffle: bool = True,
                 seed: int = 42, host_id: int = 0, num_hosts: int = 1,
                 rows: Optional[Tuple[int, int]] = None):
        self.num_items = num_items
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.rows = check_rows(batch_size, rows)

    def epoch_batches(self, epoch: int):
        order = np.arange(self.num_items)
        if self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(order)
        per_host = self.num_items // self.num_hosts
        shard = order[self.host_id * per_host:(self.host_id + 1) * per_host]
        n_batches = len(shard) // self.batch_size  # drop_last=True
        for b in range(n_batches):
            batch = shard[b * self.batch_size:(b + 1) * self.batch_size]
            if self.rows is not None:
                rank, count = self.rows
                per = self.batch_size // count
                batch = batch[rank * per:(rank + 1) * per]
            yield batch

    def num_batches(self) -> int:
        return (self.num_items // self.num_hosts) // self.batch_size


class DataPipeline:
    """Iterable over padded numpy batches, assembled in the background."""

    def __init__(self, dataset: VideoCADDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 42,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 fixed_length: Optional[int] = None,
                 prefetch: int = 2, num_workers: int = 2,
                 host_id: int = 0, num_hosts: int = 1,
                 rows: Optional[Tuple[int, int]] = None):
        """``num_workers``: concurrent batch-assembly threads. Assembly is
        bound by unpickling, PNG decode and resize, which release the GIL
        inside numpy and PIL. Emission order is batch order whatever the
        worker count. ``rows`` = (data rank, data ranks): this rank's rows
        of each global batch of ``batch_size`` (:class:`ShardedSampler`).
        A rank's rows are padded to the bucket of their own longest
        sequence, which may be shorter than the global batch's: a padded
        step has target -1 and follows every real step under the causal
        and banded masks, so it changes no loss, counter or gradient."""
        self.dataset = dataset
        self.sampler = ShardedSampler(len(dataset), batch_size, shuffle,
                                      seed, host_id, num_hosts, rows)
        self.buckets = buckets
        self.fixed_length = fixed_length
        self.prefetch = prefetch
        self.num_workers = max(1, num_workers)

    def __len__(self) -> int:
        return self.sampler.num_batches()

    def _assemble(self, indices, ordinal: int) -> Dict[str, np.ndarray]:
        with span("data.assemble", ordinal):
            return collate([self.dataset[int(i)] for i in indices],
                           self.buckets, self.fixed_length)

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Yield this epoch's batches, assembled ahead by a worker pool.

        Batches are submitted in sampler order and consumed in submission
        order (a bounded pending deque), so multi-worker assembly gives the
        very batches single-worker assembly gives. A consumer that stops
        early cancels queued work; batches in flight finish and are
        dropped.
        """
        in_flight = self.num_workers + self.prefetch
        ex = ThreadPoolExecutor(max_workers=self.num_workers,
                                thread_name_prefix="vc-assemble")
        pending: deque = deque()
        taken = 0

        def take():
            nonlocal taken
            with span("data.wait", taken):
                batch = pending.popleft().result()
            taken += 1
            return batch

        try:
            for ordinal, indices in enumerate(
                    self.sampler.epoch_batches(epoch)):
                pending.append(ex.submit(self._assemble, indices, ordinal))
                if len(pending) >= in_flight:
                    yield take()
            while pending:
                yield take()
        finally:
            for fut in pending:
                fut.cancel()
            ex.shutdown(wait=False, cancel_futures=True)


def device_prefetch(batches: Iterable[Dict], device="cpu",
                    size: int = 2) -> Iterator[Dict]:
    """Turn numpy batches into batches of tensors on ``device``, keeping
    ``size`` of them in flight. Strings (``ids``) stay on the host.

    On a CUDA device each array is copied into a pinned host tensor of its
    own (never a reused buffer: a pinned buffer rewritten before its copy
    has finished would corrupt a batch silently; PyTorch's pinned-memory
    allocator recycles a block only after the copy that reads it), then to
    the card with ``non_blocking=True`` on a side stream. An event recorded
    after the batch's copies is what the consumer's stream waits on when
    the batch is handed over, so the host never blocks on a transfer. On a
    CPU device it is a plain loop.
    """
    device = torch.device(device)
    if device.type != "cuda":
        for ordinal, batch in enumerate(batches):
            with span("data.copy", ordinal):
                out = {k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                       else v for k, v in batch.items()}
            yield out
        return

    copy_stream = torch.cuda.Stream(device)

    def put(batch, ordinal):
        out = {}
        with span("data.copy", ordinal), torch.cuda.stream(copy_stream):
            for k, v in batch.items():
                if isinstance(v, np.ndarray):
                    out[k] = torch.from_numpy(v).pin_memory().to(
                        device, non_blocking=True)
                else:
                    out[k] = v
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def hand_over(entry):
        out, done = entry
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for v in out.values():
            if isinstance(v, torch.Tensor):
                # Allocated on the copy stream, used on the consumer's: tell
                # the allocator, or it may reuse the memory too early.
                v.record_stream(consumer)
        return out

    in_flight: deque = deque()
    for ordinal, batch in enumerate(batches):
        in_flight.append(put(batch, ordinal))
        if len(in_flight) >= size:
            yield hand_over(in_flight.popleft())
    while in_flight:
        yield hand_over(in_flight.popleft())

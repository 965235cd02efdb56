"""Batch loaders: infinite sharded training stream + sequential eval stream.

Capability parity with the reference DataLoader wiring
(PL_DataModules/coco.py:85-116: 6 workers, pin_memory, YoloBatchSampler) and
the rank/world-size-aware InfiniteSampler (models/data/samplers.py:42-86,
unused there, first-class here), re-designed for the TPU input path:

  * The train stream is an infinite, epoch-seeded, per-host-sharded index
    sequence. Each host loads only its shard (multi-host DCN data
    parallelism, SURVEY.md §2.6 item 2).
  * Batches are plain numpy (uint8 images + padded labels); ALL augmentation
    beyond letterboxing runs on device (pl_yolo_tpu/data/augment.py), so the
    host loop is decode+resize only.
  * `num_workers=0`: a background thread keeps a small prefetch queue so
    host decode overlaps device compute. `num_workers>=1`: the reference's
    DataLoader worker parallelism (coco.py:85-86) — N forked processes pull
    batch-index lists from a shared queue and return collated batches; a
    sequence-numbered reorder buffer makes the batch stream IDENTICAL to the
    single-worker stream regardless of worker count (host_augment, which
    carries worker-local RNG, is the one documented exception).
  * `device_prefetch` wraps the stream to issue host->device transfers
    `depth` batches ahead, so the DMA rides under the previous train step.
"""

from __future__ import annotations

import collections
import multiprocessing as mp
import queue
import threading
from typing import Iterator

import numpy as np


class InfiniteSampler:
    """Infinite shuffled index stream, sharded across hosts
    (reference samplers.py:42-86 semantics)."""

    def __init__(self, size: int, shard_id: int = 0, num_shards: int = 1,
                 seed: int = 96, shuffle: bool = True):
        assert size > 0
        self.size = size
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        self.shuffle = shuffle

    def __iter__(self) -> Iterator[int]:
        epoch = 0
        while True:
            rng = np.random.default_rng(self.seed + epoch)
            order = rng.permutation(self.size) if self.shuffle else np.arange(self.size)
            yield from order[self.shard_id::self.num_shards].tolist()
            epoch += 1


def _collate(samples):
    imgs = np.stack([s[0] for s in samples])
    labels = np.stack([s[1] for s in samples])
    hs = np.asarray([s[2][0] for s in samples], np.int32)
    ws = np.asarray([s[2][1] for s in samples], np.int32)
    ids = np.asarray([s[3] for s in samples], np.int64)
    return {"images": imgs, "labels": labels, "img_h": hs, "img_w": ws,
            "img_id": ids}


def _load_batch(dataset, idxs, host_augment):
    if host_augment is None:
        fast = getattr(dataset, "load_batch", None)
        if fast is not None:
            batch = fast(idxs)
            if batch is not None:  # disk cache attached: vectorized gather
                return batch
    samples = []
    for idx in idxs:
        sample = dataset[idx]
        if host_augment is not None:
            img, labels = host_augment(sample[0], sample[1])
            sample = (img, labels, *sample[2:])
        samples.append(sample)
    return _collate(samples)


def _worker_loop(dataset, host_augment, index_q, result_q, stop):
    """Forked worker body: decode/collate index lists into batches. Runs only
    numpy/PIL code — never touches jax (fork-safety with a live backend)."""
    # forked children inherit the parent's signal handlers — the Trainer's
    # SIGTERM preemption handler would swallow Process.terminate() and leave
    # the worker alive forever (interpreter exit then hangs joining it)
    import signal
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    while not stop.is_set():
        try:
            item = index_q.get(timeout=0.5)
        except queue.Empty:
            continue
        if item is None:
            return
        seq, idxs = item
        result_q.put((seq, _load_batch(dataset, idxs, host_augment)))


class TrainLoader:
    """Infinite prefetching batch iterator over a DetectionDataset."""

    def __init__(self, dataset, batch_size: int, shard_id: int = 0,
                 num_shards: int = 1, seed: int = 96, prefetch: int = 2,
                 host_augment=None, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.host_augment = host_augment  # optional (img, labels) -> same
        self.num_workers = num_workers
        self.sampler = InfiniteSampler(len(dataset), shard_id, num_shards, seed)
        self.steps_per_epoch = max(
            len(dataset) // (batch_size * num_shards), 1)
        self._stop = threading.Event()
        self._procs: list = []
        if num_workers > 0:
            self._start_workers(prefetch)
        else:
            self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # ------------------------------------------------- single-thread path

    def _worker(self):
        batch_idxs = []
        for idx in self.sampler:
            if self._stop.is_set():
                return
            batch_idxs.append(idx)
            if len(batch_idxs) == self.batch_size:
                out = _load_batch(self.dataset, batch_idxs, self.host_augment)
                batch_idxs = []
                while not self._stop.is_set():
                    try:
                        self._queue.put(out, timeout=0.5)
                        break
                    except queue.Full:
                        continue

    # ------------------------------------------------- multi-process path

    def _start_workers(self, prefetch: int):
        # fork: workers inherit the dataset (incl. memmap disk cache) and the
        # host_augment closure without pickling; they run pure numpy
        ctx = mp.get_context("fork")
        self._mp_stop = ctx.Event()
        self._index_q = ctx.Queue(maxsize=2 * self.num_workers)
        self._result_q = ctx.Queue(maxsize=max(prefetch, self.num_workers))
        # never let these queues' feeder threads block interpreter exit —
        # the stream is infinite, losing buffered items at shutdown is fine
        self._index_q.cancel_join_thread()
        self._result_q.cancel_join_thread()
        for _ in range(self.num_workers):
            p = ctx.Process(
                target=_worker_loop,
                args=(self.dataset, self.host_augment, self._index_q,
                      self._result_q, self._mp_stop),
                daemon=True)
            p.start()
            self._procs.append(p)
        self._reorder: dict[int, dict] = {}
        self._next_seq = 0
        self._feeder = threading.Thread(target=self._feed, daemon=True)
        self._feeder.start()

    def _feed(self):
        seq = 0
        batch_idxs = []
        for idx in self.sampler:
            if self._stop.is_set():
                return
            batch_idxs.append(idx)
            if len(batch_idxs) == self.batch_size:
                item = (seq, batch_idxs)
                seq += 1
                batch_idxs = []
                while not self._stop.is_set():
                    try:
                        self._index_q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue

    def _next_mp(self):
        while self._next_seq not in self._reorder:
            seq, batch = self._result_q.get()
            self._reorder[seq] = batch
        out = self._reorder.pop(self._next_seq)
        self._next_seq += 1
        return out

    # ---------------------------------------------------------- interface

    def __iter__(self):
        return self

    def __next__(self):
        if self.num_workers > 0:
            return self._next_mp()
        return self._queue.get()

    def close(self):
        self._stop.set()
        if self.num_workers > 0:
            self._mp_stop.set()
            # unblock workers stuck in a blocking result_q.put (full queue,
            # consumer gone) so they can observe the stop event
            for _ in range(2 * len(self._procs)):
                try:
                    self._result_q.get_nowait()
                except queue.Empty:
                    break
            for p in self._procs:
                p.join(timeout=2.0)
            for p in self._procs:
                if p.is_alive():
                    p.terminate()
            # the parent's Queue feeder thread can be blocked writing into
            # _index_q's pipe (readers gone); without cancel_join_thread the
            # interpreter's atexit Queue join waits on it FOREVER (observed:
            # train.py hung after fit() completed)
            self._index_q.cancel_join_thread()
            self._result_q.cancel_join_thread()
            self._index_q.close()
            self._result_q.close()


def device_prefetch(batches, device, depth: int = 2,
                    threaded: bool = False):
    """Move each batch's "images" and "labels" to `device`, `depth`
    batches ahead of consumption: the pinned host copy of batch N+1 and its
    non-blocking host->device copy ride under the device execution of batch
    N (the reference's pin_memory + workers overlap,
    PL_DataModules/coco.py:85-87). Arrays keep their dtype (the uint8
    images go over as uint8). Yields {"images": tensor, "labels": tensor}.

    A non-blocking copy out of pinned memory is safe only while the pinned
    tensor lives: each queued entry holds its pinned host tensors until the
    consumer has taken the entry, and with it enqueued the step that reads
    the device tensors, which the device runs after the copy. On the CPU
    the arrays are wrapped without a copy.

    threaded=True moves the pinning and the copies to a dedicated thread
    and CUDA stream, so the main thread only dispatches steps; the
    consumer's stream waits on each batch's copy. Closing the generator
    stops and joins the thread.
    """
    import torch

    device = torch.device(device)
    pin = device.type == "cuda"

    def put(batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(batch[k]))
                for k in ("images", "labels")}
        if pin:
            host = {k: v.pin_memory() for k, v in host.items()}
        return host, {k: v.to(device, non_blocking=pin)
                      for k, v in host.items()}

    it = iter(batches)
    if not threaded:
        buf = collections.deque()
        for _ in range(depth):
            buf.append(put(next(it)))
        while True:
            host, out = buf.popleft()
            buf.append(put(next(it)))
            yield out
            del host

    outq: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def send():
        try:
            # the copies run on a side stream of their own; the consumer's
            # stream waits on each entry's event before it uses the tensors
            stream = torch.cuda.Stream(device) if pin else None
            for batch in it:
                if stream is None:
                    item = (*put(batch), None)
                else:
                    with torch.cuda.stream(stream):
                        host, dev = put(batch)
                        done = torch.cuda.Event()
                        done.record(stream)
                    item = (host, dev, done)
                while not stop.is_set():
                    try:
                        outq.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except Exception as e:  # surface in the consumer, not a dead thread
            outq.put(e)

    th = threading.Thread(target=send, daemon=True)
    th.start()
    try:
        while True:
            out = outq.get()
            if isinstance(out, Exception):
                raise out
            host, dev, done = out
            if done is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(done)
                for v in dev.values():
                    v.record_stream(consumer)
            yield dev
            del host
    finally:
        stop.set()
        th.join(timeout=2.0)


def eval_batches(dataset, batch_size: int, shard_id: int = 0,
                 num_shards: int = 1):
    """Sequential eval iterator; the last batch is padded by repeating the
    final sample (fixed shapes for jit) with a `count` marking real rows.
    With num_shards > 1 each host walks a strided subset (detections are
    gathered for evaluation, parallel/distributed.py)."""
    all_idxs = list(range(shard_id, len(dataset), num_shards))
    n = len(all_idxs)
    for start in range(0, n, batch_size):
        idxs = all_idxs[start:start + batch_size]
        count = len(idxs)
        idxs = list(idxs)
        while len(idxs) < batch_size:
            idxs.append(idxs[-1])
        batch = _collate([dataset[i] for i in idxs])
        batch["count"] = count
        yield batch

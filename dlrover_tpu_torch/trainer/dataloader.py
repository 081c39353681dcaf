"""Elastic data pipeline: the port of ``dlrover_tpu/trainer/dataloader.py``.

- :class:`ElasticDistributedSampler`: rank-strided sampling with exact
  resume state, giving the same indices as the JAX package's sampler for
  the same arguments (the permutation is numpy's ``default_rng(seed +
  epoch)`` in both).
- :class:`PrefetchIterator`: one batch in flight on a background thread,
  whose ``stage_fn`` (e.g. :func:`to_device`) does the host-to-device copy
  on that thread with the device set explicitly.

``ElasticShardLoader`` (master-assigned shards) waits for the agent slice;
``make_global_array`` for the multi-GPU slice.
"""

import math
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..common.log import logger


class ElasticDistributedSampler:
    """Rank-strided sampler with exact-resume state.

    ``state_dict()`` records the epoch and the samples already consumed
    globally; ``load_state_dict`` replays into any (num_replicas, rank)
    layout, rounding the consumed count down to a whole stride of the new
    replica count, so at most ``num_replicas - 1`` samples are seen twice
    after a re-mesh and none are skipped.
    """

    def __init__(self, dataset_size: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        if rank >= num_replicas or rank < 0:
            raise ValueError(f"rank {rank} out of range for {num_replicas}")
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.consumed_samples = 0  # global, across replicas
        if drop_last:
            self.num_samples = dataset_size // num_replicas
        else:
            self.num_samples = math.ceil(dataset_size / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.consumed_samples = 0

    def _global_indices(self) -> np.ndarray:
        if self.shuffle:
            indices = np.random.default_rng(self.seed + self.epoch).permutation(self.dataset_size)
        else:
            indices = np.arange(self.dataset_size)
        if not self.drop_last and len(indices) < self.total_size:
            indices = np.concatenate([indices, indices[: self.total_size - len(indices)]])
        return indices[: self.total_size]

    def __iter__(self) -> Iterator[int]:
        indices = self._global_indices()
        for i in range(self.consumed_samples + self.rank, self.total_size, self.num_replicas):
            self.consumed_samples += self.num_replicas
            yield int(indices[i])

    def __len__(self) -> int:
        return max(0, (self.total_size - self.consumed_samples) // self.num_replicas)

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "completed_num": self.consumed_samples}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.epoch = int(state.get("epoch", 0))
        completed = int(state.get("completed_num", 0))
        self.consumed_samples = (completed // self.num_replicas) * self.num_replicas


def to_device(device) -> Callable[[Any], Any]:
    """A ``stage_fn`` copying every tensor of a batch tuple to ``device``
    (from pinned memory, so the copy does not hold the host)."""
    device = torch.device(device)

    def stage(batch):
        if device.type != "cuda":
            return tuple(x.to(device) for x in batch)
        return tuple(x.pin_memory().to(device, non_blocking=True) for x in batch)

    return stage


class PrefetchIterator:
    """Double-buffered input: a background thread pulls the next element
    (through ``stage_fn``) while the trainer consumes the previous one.

    - order and values are those of the source;
    - the thread starts on the first ``__next__``, so a loop that stops
      before drawing consumes nothing;
    - an exception of the source or of ``stage_fn`` re-raises on the
      consumer's next draw;
    - ``device`` (a CUDA device) is made current on the thread before
      ``stage_fn`` runs, so its copies land on that device;
    - a draw waits at most ``timeout`` seconds for the producer.
    """

    def __init__(self, source, stage_fn: Optional[Callable[[Any], Any]] = None, depth: int = 1,
                 device=None, timeout: float = 600.0):
        self._source = iter(source)
        self._stage = stage_fn
        self._device = torch.device(device) if device is not None else None
        if self._device is not None and self._device.type == "cuda" and self._device.index is None:
            # "cuda" means the constructing thread's current device; the
            # producer thread must be told which one that is
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._timeout = timeout
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    def __iter__(self) -> "PrefetchIterator":
        return self

    def _put(self, kind: str, payload: Any) -> bool:
        while not self._stopped.is_set():
            try:
                self._q.put((kind, payload), timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            if self._device is not None and self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            for item in self._source:
                if self._stage is not None:
                    item = self._stage(item)
                if not self._put("item", item):
                    return
            self._put("stop", None)
        except Exception as e:  # noqa: BLE001 — re-raised on the consumer
            if not self._put("error", e):
                logger.warning("prefetch error after close (dropped): %r", e)

    def __next__(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._produce, name="input-prefetch", daemon=True)
            self._thread.start()
        if self._stopped.is_set():
            raise StopIteration
        deadline = time.monotonic() + self._timeout
        while True:
            try:
                kind, payload = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    self._stopped.set()
                    raise RuntimeError("input producer exited without a result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no input batch within {self._timeout} s") from None
        if kind == "item":
            return payload
        self._stopped.set()
        if kind == "error":
            raise payload
        raise StopIteration

    def close(self) -> None:
        """Stop the producer (idempotent). Elements already staged are
        dropped: callers resume by step (``data_factory``), never by
        iterator position."""
        self._stopped.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)

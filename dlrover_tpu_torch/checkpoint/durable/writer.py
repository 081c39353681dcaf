"""Background durable writer, a flash-committed image to the durable tier:
the port of ``dlrover_tpu/checkpoint/durable/writer.py``.

The durable tier must not add to the trainer's blocking cost, so the
writer never runs on the trainer's path or the persist's: the saver
*submits* a step after its flash commit (latest wins: a newer submit
supersedes an older one not drained yet) and a thread of this writer
drains it, streaming the image to the lineage with its crc32, then
signals the commit barrier; rank 0's writer also runs phase 2
(:func:`.commit.commit_generation`, which gives a generation up for the
step waiting behind it once every other host has written that one) and
the GC.

Where the image comes from differs from the JAX ``_snapshot``, which
copies meta and payload out of shm under the shard lock into a new
buffer on every drain. Here the saver's persist has just copied the same
step out of shm into a private buffer of its own; it lends that buffer
with the submit (``image``), and the writer reads from it and hands it
back when the shard is written, so a drain takes no shard lock and no
further host copy of the image (about 1.5 GB for GPT-2 small). Only a
submit without an image (a caller with no buffer of the step) copies out
of shm under the lock, into one buffer this writer keeps. The JAX
module's fault-injection point is left out (the chaos harness is not
ported).
"""

import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, Optional, Tuple

import numpy as np

from ...common.log import logger
from ..meta import CheckpointMeta
from ..shm_handler import SharedMemoryHandler
from .commit import commit_generation, make_barrier
from .gc import collect_generations
from .layout import CHUNK, DurableLayout

DRAIN_RETRIES = 3
DRAIN_RETRY_DELAY_S = 0.2
# the longest a drain waits for the shard lock before it gives the step up
SNAPSHOT_LOCK_S = 60.0

# (meta, a buffer holding the step's payload, the callback that hands the
# buffer back)
Image = Tuple[CheckpointMeta, np.ndarray, Callable[[], None]]


class DurableWriter:
    """One per host. :meth:`submit` is the asynchronous entry (the saver's
    hook), :meth:`drain` the synchronous core that the thread and the tests
    share."""

    def __init__(self, root: str, lineage: str, host_rank: int, num_hosts: int,
                 shm: SharedMemoryHandler, shard_lock=None, master_client=None, keep: int = 3,
                 commit_timeout_s: float = 120.0):
        self.layout = DurableLayout(root, lineage)
        self.host_rank = host_rank
        self.num_hosts = num_hosts
        self.shm = shm
        # the trainer's stages are excluded by the cross-process lock; a
        # standalone test may run without it
        self.shard_lock = shard_lock
        self._local_lock = threading.Lock()
        self.barrier = make_barrier(self.layout, num_hosts, master_client)
        self.keep = keep
        self.commit_timeout_s = commit_timeout_s
        self._cond = threading.Condition()
        self._pending: Optional[Tuple[int, Optional[Image]]] = None  # latest wins
        self._running = True
        self._thread: Optional[threading.Thread] = None
        self._busy = False
        self._buf: Optional[np.ndarray] = None
        self.drained_steps = 0
        self.failed_steps = 0
        # per drain: step, where the image came from, shard-lock hold,
        # write seconds, bytes, committed (rank 0)
        self.stats: Deque[Dict] = deque(maxlen=1000)

    # -- async path ---------------------------------------------------------

    def submit(self, step: int, image: Optional[Image] = None) -> None:
        """Queue a flash-committed step. Latest wins: an older step not
        drained yet is superseded (its lent buffer handed back), and an
        older submit than the pending one is refused at once."""
        superseded = None
        with self._cond:
            if not self._running:
                superseded = image
            elif self._pending is None or step > self._pending[0]:
                superseded = self._pending[1] if self._pending is not None else None
                self._pending = (step, image)
                if self._thread is None:
                    # started at the first submit: a job without the tier
                    # pays for no thread
                    self._thread = threading.Thread(target=self._worker,
                                                    name=f"durable-writer-{self.host_rank}",
                                                    daemon=True)
                    self._thread.start()
                self._cond.notify_all()
            else:
                superseded = image
        if superseded is not None:
            superseded[2]()

    def _worker(self) -> None:
        while True:
            with self._cond:
                while self._running and self._pending is None:
                    self._cond.wait(timeout=1.0)
                if self._pending is None:
                    return
                (step, image), self._pending = self._pending, None
                self._busy = True
            try:
                self.drain(step, image)
            except Exception as e:  # noqa: BLE001 — best-effort tier; the flash tier is unaffected
                self.failed_steps += 1
                logger.error("durable drain of step %s failed for good: %s", step, e)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def stop(self, timeout: float = 10.0) -> None:
        """Drain the step in progress (at most ``timeout``), drop one not
        started (its lent buffer handed back)."""
        with self._cond:
            self._running = False
            pending, self._pending = self._pending, None
            self._cond.notify_all()
        if pending is not None and pending[1] is not None:
            pending[1][2]()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                logger.warning("durable writer still draining after %.0f s", timeout)
            self._thread = None

    def wait_idle(self, timeout: float = 60.0) -> bool:
        """Until no step is pending or draining; False at the deadline."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._pending is not None or self._busy:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
        return True

    # -- synchronous core ---------------------------------------------------

    def drain(self, step: int, image: Optional[Image] = None) -> bool:
        """Write ``step``'s shard (from ``image``, else from shm), signal the
        barrier and, on rank 0, commit. Retries a failed shard write; raises
        when the retries run out. False when shm no longer holds the step
        (superseded) or rank 0's commit did not happen. A lent buffer is
        handed back once the shard is written, before the barrier."""
        lent = [image is not None]

        def give_back() -> None:
            if lent[0]:
                lent[0] = False
                image[2]()

        try:
            return self._drain(step, image, give_back)
        finally:
            give_back()

    def _drain(self, step: int, image: Optional[Image], give_back: Callable[[], None]) -> bool:
        last_err: Optional[Exception] = None
        stat = {"step": step, "source": "saver buffer" if image is not None else "shm",
                "hold_s": 0.0}
        for attempt in range(DRAIN_RETRIES):
            try:
                if image is not None:
                    meta, buf = image[0], image[1]
                else:
                    meta, buf, stat["hold_s"] = self._snapshot(step)
                    if meta is None:
                        logger.warning("durable drain: shm no longer holds step %s (superseded); "
                                       "skipping", step)
                        return False
                t0 = time.monotonic()
                self._write_shard(meta, buf)
                stat.update(write_s=time.monotonic() - t0, bytes=meta.total_bytes)
                break
            except Exception as e:  # noqa: BLE001 — retried, raised when the retries run out
                last_err = e
                logger.warning("durable shard write for step %s failed (attempt %s/%s): %s", step,
                               attempt + 1, DRAIN_RETRIES, e)
                time.sleep(DRAIN_RETRY_DELAY_S)
        else:
            raise RuntimeError(f"durable shard write for step {step} failed after "
                               f"{DRAIN_RETRIES} attempts") from last_err
        give_back()
        self.barrier.signal(step, self.host_rank)
        self.drained_steps += 1
        logger.info("durable shard of step %s written from the %s: %s bytes in %.3f s "
                    "(shard lock held %.4f s)", step, stat["source"], stat["bytes"],
                    stat["write_s"], stat["hold_s"])
        committed = True
        if self.host_rank == 0:
            committed = commit_generation(self.layout, step, self.num_hosts, barrier=self.barrier,
                                          timeout_s=self.commit_timeout_s, newer=self._pending_step)
            if committed and self.keep > 0:
                collect_generations(self.layout, keep=self.keep)
        stat["committed"] = committed
        self.stats.append(stat)
        return committed

    def _pending_step(self) -> Optional[int]:
        with self._cond:
            return None if self._pending is None else self._pending[0]

    def _snapshot(self, step: int):
        """(meta, buffer, lock hold): the payload copied out of shm under the
        shard lock, in chunks, into this writer's buffer; no durable I/O
        under the lock. (None, None, 0) when shm holds another step."""
        if self.shard_lock is None:
            lock = self._local_lock
            acquired = lock.acquire(timeout=SNAPSHOT_LOCK_S)
        else:
            lock = self.shard_lock
            acquired = lock.acquire(timeout=SNAPSHOT_LOCK_S)
        if not acquired:
            raise TimeoutError(f"shard lock not free within {SNAPSHOT_LOCK_S} s")
        try:
            t0 = time.monotonic()
            meta = self.shm.read_meta()
            if meta is None or meta.step != step:
                return None, None, 0.0
            reader = self.shm.payload_reader(copy=False)
            if reader is None:
                return None, None, 0.0
            if self._buf is None or self._buf.nbytes < meta.total_bytes:
                self._buf = None
                self._buf = np.empty(meta.total_bytes, dtype=np.uint8)
            with memoryview(self._buf) as view:
                for offset in range(0, meta.total_bytes, CHUNK):
                    n = min(CHUNK, meta.total_bytes - offset)
                    chunk = reader(offset, n)
                    try:
                        view[offset : offset + n] = chunk
                    finally:
                        chunk.release()
            return meta, self._buf, time.monotonic() - t0
        finally:
            lock.release()

    def _write_shard(self, meta: CheckpointMeta, buf: np.ndarray) -> None:
        with memoryview(buf) as view:
            self.layout.write_shard(meta, lambda offset, n: view[offset : offset + n])

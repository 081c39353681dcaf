"""Agent-side asynchronous checkpoint saver: the port of
``dlrover_tpu/checkpoint/saver.py``.

One saver per agent process drains save events from the trainer and
persists the shm-staged image to storage, so the trainer blocks only for
its copy into shared memory. Kept from the JAX module:

- the factory handshake: the trainer tells the agent which saver to build
  (storage root, shard topology) through a queue;
- the per-shard lock serialising shm access between trainer and persister;
- the done-file protocol, commit and ``dlrover_latest.txt`` tracker,
  persist-error markers and retention;
- ``save_shm_to_storage``, the breakpoint save, also run on SIGTERM.

The persist holds the shard lock only to copy the image out of shm, as the
durable writer's ``_snapshot`` does (``dlrover_tpu/checkpoint/durable/
writer.py``); the JAX saver streams the whole image to disk under the lock,
and every stage of the trainer is skipped meanwhile. Here the event loop
copies the newest queued step into a private host buffer (SAVE events that
queued up behind a persist collapse into the newest, latest wins, as in the
writer's ``submit``), and a writer thread writes that buffer to storage.
There are two such buffers, allocated at first use and reused: one is
written while the next storage step is copied into the other, so a storage
step leaves shm before the trainer stages the step after it. An in-process
lock covers each whole write, so the breakpoint save and the writer never
write one step twice. The storage bytes are the JAX layout.

Every wait is bounded: the runner and event loops poll their queues and
check a stop flag, the snapshot waits for the shard lock at most
``SNAPSHOT_LOCK_S``, and :meth:`AsyncCheckpointSaver.shutdown` gives each
hand-off and join a deadline. Peer replication and the durable tier are
not ported yet and raise when asked for.
"""

import os
import queue as _queue
import signal
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..common.config import get_context
from ..common.log import logger
from ..common.multi_process import LocalSocketClient, SharedLock, SharedQueue, _ipc_namespace
from ..common.platform import not_ported
from .meta import CheckpointMeta
from .shm_handler import SharedMemoryHandler
from .storage import PosixCheckpointStorage

FACTORY_QUEUE = "ckpt_factory"
EVENT_QUEUE = "ckpt_events"
# how often the runner, event and writer loops wake to check for a stop
_POLL_S = 1.0
# the copy out of shm goes in chunks of this size
SNAPSHOT_CHUNK = 64 << 20
# the longest a snapshot waits for the shard lock (a stage in flight holds
# it for its copy into shm)
SNAPSHOT_LOCK_S = 60.0


def lock_name(host_rank: int) -> str:
    return f"ckpt_shard_{host_rank}"


class CheckpointEvent:
    SAVE = "save"
    EXIT = "exit"


class AsyncCheckpointSaver:
    """Singleton per agent process; one checkpoint shard per host."""

    _instance: Optional["AsyncCheckpointSaver"] = None
    _cls_lock = threading.Lock()
    _factory_q: Optional[SharedQueue] = None
    _event_q: Optional[SharedQueue] = None
    _runner_thread: Optional[threading.Thread] = None
    _runner_stop: Optional[threading.Event] = None
    _runner_namespace: Optional[str] = None
    _start_lock = threading.Lock()
    _signals_installed = False

    def __init__(self, storage_root: str, host_rank: int = 0, num_hosts: int = 1,
                 replicate: bool = False, durable_dir: str = ""):
        if replicate and num_hosts > 1:
            raise not_ported("peer-replica checkpointing")
        if durable_dir:
            raise not_ported("the durable checkpoint tier")
        self.storage = PosixCheckpointStorage(storage_root)
        self.host_rank = host_rank
        self.num_hosts = num_hosts
        self.shm = SharedMemoryHandler(host_rank)
        # the saver owns the lock's server side; trainers connect as clients
        self._shard_lock = SharedLock(lock_name(host_rank), create=True)
        self._running = True
        self._persisted_steps: Dict[int, bool] = {}
        # the private copies of the image (see the module docstring), the
        # snapshot waiting to be written (latest wins) and the buffer being
        # written
        self._bufs: List[Optional[np.ndarray]] = [None, None]
        self._slot = threading.Condition()
        self._pending: Optional[Tuple[CheckpointMeta, int, float]] = None
        self._writing: Optional[int] = None
        self._snap_lock = threading.Lock()  # one copy out of shm at a time
        self._persist_lock = threading.Lock()  # one write at a time
        self._writer: Optional[threading.Thread] = None
        # per persist: step, shard-lock hold of its snapshot, write seconds
        self.persist_stats: Deque[Dict[str, float]] = deque(maxlen=1000)

    # -- factory / lifecycle ----------------------------------------------

    @classmethod
    def start_async_saving_ckpt(cls) -> threading.Thread:
        """Agent entry: create the IPC servers and wait for a trainer's
        factory message, then run the event loop. Call it from the agent's
        main thread, where the SIGTERM breakpoint save can be installed."""
        namespace = _ipc_namespace()
        with cls._start_lock:
            with cls._cls_lock:
                alive = cls._runner_thread is not None and cls._runner_thread.is_alive()
                # the same namespace is not enough: the socket directory may
                # have moved, leaving a runner that listens where no client
                # looks; probe with a fresh client
                if alive and cls._runner_namespace == namespace and LocalSocketClient(
                    "queue_" + FACTORY_QUEUE
                ).available():
                    return cls._runner_thread
            if alive:
                logger.info("saver endpoints stale (namespace %s -> %s); restarting",
                            cls._runner_namespace, namespace)
                cls.shutdown()
            with cls._cls_lock:
                cls._factory_q = SharedQueue(FACTORY_QUEUE, create=True)
                cls._event_q = SharedQueue(EVENT_QUEUE, create=True)
                cls._runner_namespace = namespace
                cls._runner_stop = stop = threading.Event()
            cls._install_signal_handlers()
            factory_q, event_q = cls._factory_q, cls._event_q

            def runner():
                while not stop.is_set():
                    try:
                        msg = factory_q.get(timeout=_POLL_S)
                    except _queue.Empty:
                        continue
                    except (OSError, RuntimeError) as e:  # server stopped under us
                        logger.debug("saver factory queue gone: %r", e)
                        return
                    if msg is None or msg.get("type") == "exit":
                        return
                    try:
                        saver = cls.get_or_create(
                            storage_root=msg["storage_root"],
                            host_rank=msg.get("host_rank", 0),
                            num_hosts=msg.get("num_hosts", 1),
                            replicate=msg.get("replicate", False),
                            durable_dir=msg.get("durable_dir", ""),
                        )
                        saver._event_loop(event_q, stop)
                    except Exception:  # noqa: BLE001 — the agent's saver must outlive a bad message
                        logger.exception("checkpoint saver crashed; waiting again")

            thread = threading.Thread(target=runner, name="ckpt-saver", daemon=True)
            thread.start()
            cls._runner_thread = thread
            return thread

    @classmethod
    def get_or_create(cls, storage_root: str, host_rank: int = 0, num_hosts: int = 1,
                      replicate: bool = False, durable_dir: str = "") -> "AsyncCheckpointSaver":
        with cls._cls_lock:
            inst = cls._instance
            if inst is None:
                cls._instance = cls(storage_root, host_rank, num_hosts,
                                    replicate=replicate, durable_dir=durable_dir)
                return cls._instance
            if replicate and num_hosts > 1:
                raise not_ported("peer-replica checkpointing")
            if durable_dir:
                raise not_ported("the durable checkpoint tier")
            inst.storage = PosixCheckpointStorage(storage_root)
            if host_rank != inst.host_rank or num_hosts != inst.num_hosts:
                # the old shm/lock/step bookkeeping belongs to the old world
                logger.info("saver topology change: rank %s/%s -> %s/%s",
                            inst.host_rank, inst.num_hosts, host_rank, num_hosts)
                if host_rank != inst.host_rank:
                    inst._shard_lock.close()
                    inst._shard_lock = SharedLock(lock_name(host_rank), create=True)
                    inst.shm.close()
                    inst.shm = SharedMemoryHandler(host_rank)
                inst.host_rank, inst.num_hosts = host_rank, num_hosts
                inst._persisted_steps.clear()
            return inst

    @classmethod
    def reset(cls) -> None:
        with cls._cls_lock:
            cls._instance = None

    @classmethod
    def shutdown(cls, timeout: float = 10.0) -> None:
        """Stop the runner thread, the IPC servers and the instance's
        shm/lock. Safe to call repeatedly; returns within about
        ``timeout`` plus the queue hand-offs' own deadlines."""
        with cls._cls_lock:
            factory_q, event_q = cls._factory_q, cls._event_q
            thread, inst, stop = cls._runner_thread, cls._instance, cls._runner_stop
            cls._factory_q = cls._event_q = None
            cls._runner_thread = cls._runner_stop = None
            cls._instance = None
        if inst is not None:
            inst.stop()
        if stop is not None:
            stop.set()  # the loops see it within one poll
        if thread is not None and thread.is_alive():
            # wake the loops now rather than at their next poll
            for q, msg in ((event_q, {"type": CheckpointEvent.EXIT}), (factory_q, {"type": "exit"})):
                try:
                    q.put(msg, timeout=2.0)
                except (OSError, RuntimeError) as e:  # the server is gone already
                    logger.debug("saver exit message not delivered: %r", e)
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                logger.warning("checkpoint saver thread still running after %.0f s", timeout)
        for q in (factory_q, event_q):
            if q is not None:
                q.close()
        if inst is not None:
            inst.shm.close()
            inst._shard_lock.close()

    @classmethod
    def _install_signal_handlers(cls) -> None:
        """Breakpoint save on SIGTERM (pod eviction, preemption): persist
        the staged step, then terminate as before."""
        if cls._signals_installed:
            return
        if threading.current_thread() is not threading.main_thread():
            logger.warning("saver started off the main thread; SIGTERM breakpoint save disabled")
            return
        orig_term = signal.getsignal(signal.SIGTERM)

        def on_term(signum, frame):
            inst = cls._instance
            if inst is not None and get_context().save_at_breakpoint:
                logger.info("SIGTERM: breakpoint checkpoint persist")
                try:
                    inst.save_shm_to_storage()
                except Exception:  # noqa: BLE001 — the process terminates either way
                    logger.exception("breakpoint save on SIGTERM failed")
            if callable(orig_term):
                orig_term(signum, frame)
            else:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, on_term)
        cls._signals_installed = True

    # -- event loop --------------------------------------------------------

    def _event_loop(self, event_q: SharedQueue, stop: threading.Event) -> None:
        logger.info("checkpoint saver running (host_rank=%s root=%s)", self.host_rank, self.storage.root)
        while self._running and not stop.is_set():
            try:
                event = event_q.get(timeout=_POLL_S)
            except _queue.Empty:
                continue
            except (OSError, RuntimeError) as e:  # server stopped under us
                logger.debug("saver event queue gone: %r", e)
                return
            etype = (event or {}).get("type")
            if etype == CheckpointEvent.EXIT:
                return
            if etype != CheckpointEvent.SAVE:
                continue
            step, exiting = event.get("step", -1), False
            # latest wins: the SAVE events already queued behind this one
            # supersede it, and only the newest step is copied out
            while not exiting:
                try:
                    event = event_q.get(block=False)
                except (_queue.Empty, OSError, RuntimeError):
                    break
                etype = (event or {}).get("type")
                exiting = etype == CheckpointEvent.EXIT
                if etype == CheckpointEvent.SAVE:
                    step = max(step, event.get("step", -1))
            self._snapshot_or_record(step)
            if exiting:
                return

    def _snapshot_or_record(self, step: int) -> bool:
        """:meth:`_snapshot`, with a failure left in the persist-error
        marker so that the trainer's ``wait_saving`` fails fast."""
        try:
            return self._snapshot(step)
        except Exception as e:  # noqa: BLE001 — reported through the marker
            logger.exception("snapshot for the persist of step %s failed", step)
            self._record_error(step, e)
            return False

    def _buffer(self, idx: int, nbytes: int) -> np.ndarray:
        """Buffer ``idx``, grown to ``nbytes``. A new buffer's pages are
        touched here, so that the copy out of shm does not pay their faults
        under the shard lock."""
        buf = self._bufs[idx]
        if buf is None or buf.nbytes < nbytes:
            self._bufs[idx] = None  # drop the old one before the new one
            buf = np.empty(nbytes, dtype=np.uint8)
            buf.fill(0)
            self._bufs[idx] = buf
        return buf

    def _free_buffer(self) -> int:
        """The buffer a snapshot fills: the pending snapshot's (latest wins),
        else the one the writer is not reading."""
        with self._slot:
            if self._pending is not None:
                return self._pending[1]
            return 1 if self._writing == 0 else 0

    def _snapshot(self, step: int) -> bool:
        """Copy the staged image out of shm into a private buffer, under the
        shard lock and for no longer than the copy, and leave it for the
        writer, replacing a snapshot it has not taken yet (latest wins).
        False when there is nothing new to write. A buffer too small for
        the image is grown with the lock released, and the copy retried;
        the segment's pages are faulted into this process before the lock
        is taken (``fault_in``), so the hold is the copy alone."""
        with self._snap_lock:
            self._fault_in()
            got = self._copy_out(step)
            for _ in range(2):
                if not isinstance(got, int):
                    break
                self._buffer(self._free_buffer(), got)
                self._fault_in()  # the segment may be new since the last call
                got = self._copy_out(step)
            if isinstance(got, int):
                raise RuntimeError(f"the staged image kept outgrowing the buffer ({got} bytes)")
            if got is None:
                return False
        with self._slot:
            self._pending = got
            if self._writer is None or not self._writer.is_alive():
                self._writer = threading.Thread(target=self._writer_loop, name="ckpt-writer",
                                                daemon=True)
                self._writer.start()
            self._slot.notify_all()
        return True

    def _fault_in(self) -> None:
        t0 = time.monotonic()
        pages = self.shm.fault_in()
        if pages:
            logger.info("read %s pages of the shm segment into the saver in %.3f s", pages,
                        time.monotonic() - t0)

    def _copy_out(self, step: int):
        """Under the shard lock: (meta, buffer index, lock hold) of the
        staged image copied out; None when there is nothing to copy; or the
        bytes a buffer must hold when the free one is too small (it is grown
        outside the lock, to keep its page faults out of the hold)."""
        if not self._shard_lock.acquire(timeout=SNAPSHOT_LOCK_S):
            raise TimeoutError(f"shard lock not free within {SNAPSHOT_LOCK_S} s")
        try:
            t0 = time.monotonic()
            meta = self.shm.read_meta()
            if meta is None:
                logger.warning("save event for step %s but shm is empty", step)
                return None
            if self._persisted_steps.get(meta.step):
                return None  # written already (a breakpoint save)
            with self._slot:
                # the writer takes a pending snapshot only under this
                # condition, so the buffer picked here is nobody else's
                idx = self._free_buffer()
                buf = self._bufs[idx]
                self._pending = None  # refilled below, or regrown: latest wins
                if buf is None or buf.nbytes < meta.total_bytes:
                    return meta.total_bytes
            if step >= 0 and meta.step != step:
                logger.warning("shm holds step %s, save event wanted %s; persisting shm step",
                               meta.step, step)
            reader = self.shm.payload_reader(copy=False)
            with memoryview(buf) as view:
                for offset in range(0, meta.total_bytes, SNAPSHOT_CHUNK):
                    n = min(SNAPSHOT_CHUNK, meta.total_bytes - offset)
                    with reader(offset, n) as chunk:
                        view[offset : offset + n] = chunk
            return meta, idx, time.monotonic() - t0
        finally:
            self._shard_lock.release()

    def _writer_loop(self) -> None:
        while self._running:
            with self._slot:
                if self._pending is None:
                    self._slot.wait(_POLL_S)
                    continue
            with self._persist_lock:
                self._write_pending()

    def _write_pending(self) -> None:
        """Write the pending snapshot to storage and commit it. The caller
        holds ``_persist_lock``, under which a step is marked written, so
        no step is written twice. A failure lands in a persist-error
        marker, so the trainer's ``wait_saving`` fails fast."""
        with self._slot:
            if self._pending is None:
                return
            (meta, idx, hold), self._pending = self._pending, None
            self._writing = idx
        try:
            if self._persisted_steps.get(meta.step):
                return
            t0 = time.monotonic()
            with memoryview(self._bufs[idx]) as view:
                self.storage.write_shard(meta, lambda offset, n: view[offset : offset + n])
            self._persisted_steps[meta.step] = True
            committed = self.storage.commit(meta.step, self.num_hosts)
            # Clear the fail-fast marker only when this persist covers its
            # step: an older image in shm means the marked stage never
            # landed, and wait_saving must keep failing fast on it.
            marker = self.storage.persist_error(self.host_rank)
            if marker is not None and marker[0] <= meta.step:
                self.storage.clear_persist_error(self.host_rank)
            keep = get_context().ckpt_keep_latest
            if committed and keep > 0:
                self.storage.keep_latest(keep)
            write_s = time.monotonic() - t0
            self.persist_stats.append({"step": meta.step, "hold_s": hold, "write_s": write_s})
            logger.info("persisted step %s: shard lock held %.4f s (snapshot), write %.4f s",
                        meta.step, hold, write_s)
        except Exception as e:  # noqa: BLE001 — reported through the marker
            logger.exception("persist failed for step %s", meta.step)
            self._record_error(meta.step, e)
        finally:
            with self._slot:
                self._writing = None

    def _record_error(self, step: int, e: BaseException) -> None:
        try:
            self.storage.record_persist_error(self.host_rank, step, repr(e))
        except OSError:
            logger.exception("could not record persist error marker")

    def _persist_step(self, step: int) -> None:
        """Snapshot and write now, on the caller's thread (the breakpoint
        save). Under ``_persist_lock`` it waits for a write in progress; a
        step that write covered is not written again."""
        with self._persist_lock:
            self._snapshot_or_record(step)
            self._write_pending()

    def save_shm_to_storage(self) -> bool:
        """Breakpoint save: persist whatever step is staged in shm."""
        meta = self.shm.read_meta()
        if meta is None:
            return False
        if self._persisted_steps.get(meta.step):
            return True
        logger.info("breakpoint-saving step %s from shm", meta.step)
        self._persist_step(meta.step)
        return True

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the writer after the write in progress, at most ``timeout``;
        a snapshot not written yet is dropped (the breakpoint save writes
        the staged step before an agent stops)."""
        self._running = False
        with self._slot:
            self._slot.notify_all()
        writer = self._writer
        if writer is not None and writer is not threading.current_thread():
            writer.join(timeout)
            if writer.is_alive():
                logger.warning("checkpoint writer still running after %.0f s", timeout)

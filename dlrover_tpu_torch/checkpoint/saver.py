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

Every wait is bounded: the runner and event loops poll their queues and
check a stop flag, and :meth:`AsyncCheckpointSaver.shutdown` gives each
hand-off and join a deadline. Peer replication and the durable tier are
not ported yet and raise when asked for.
"""

import os
import queue as _queue
import signal
import threading
from typing import Dict, Optional

from ..common.config import get_context
from ..common.log import logger
from ..common.multi_process import LocalSocketClient, SharedLock, SharedQueue, _ipc_namespace
from ..common.platform import not_ported
from .shm_handler import SharedMemoryHandler
from .storage import PosixCheckpointStorage

FACTORY_QUEUE = "ckpt_factory"
EVENT_QUEUE = "ckpt_events"
# how often the runner and event loops wake to check for a stop
_POLL_S = 1.0


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
            if etype == CheckpointEvent.SAVE:
                self._persist_step(event.get("step", -1))

    def _persist_step(self, step: int) -> None:
        """Drain shm to storage under the shard lock. The write streams
        from the mapped segment in chunks, with no copy of the payload in
        the agent's memory. The trainer's non-blocking acquire skips its
        save while this holds the lock. A failure lands in a persist-error
        marker, so the trainer's ``wait_saving`` fails fast."""
        try:
            with self._shard_lock:
                meta = self.shm.read_meta()
                if meta is None:
                    logger.warning("save event for step %s but shm is empty", step)
                    return
                if step >= 0 and meta.step != step:
                    logger.warning("shm holds step %s, save event wanted %s; persisting shm step",
                                   meta.step, step)
                self.storage.write_shard(meta, self.shm.payload_reader(copy=False))
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
        except Exception as e:  # noqa: BLE001 — reported through the marker
            logger.exception("persist failed for step %s", step)
            try:
                self.storage.record_persist_error(self.host_rank, step, repr(e))
            except OSError:
                logger.exception("could not record persist error marker")

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

    def stop(self) -> None:
        self._running = False
